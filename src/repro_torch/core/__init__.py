"""The paper's contribution, UGA (§3.1) + FedMeta (§3.2), as composable
strategies over PyTorch models (port of ``repro/core/__init__.py``),
exposed through three plugin registries and a facade:

  * :mod:`repro_torch.core.algorithms` — ClientAlgorithm registry (what a
    client computes): uga / fedavg / fedprox / fednova / your own;
  * :mod:`repro_torch.core.executors` — CohortExecutor registry (how the
    cohort runs): vmap / scan / chunked / sharded, yielding uniform
    aggregate handles;
  * :mod:`repro_torch.core.engines` — ServerEngine registry (what the
    server does with the aggregate): legacy_tree / fused_flat /
    buffered_async, with declared FedMeta capabilities;
  * :class:`repro_torch.core.trainer.FederatedTrainer` — the driver loop
    (round functions per chunk size, chunked sampling,
    checkpoint/resume, history).
"""
# name -> the module of this package that defines it.  The facade loads
# them at first use (PEP 562), not at import: the package's modules import
# one another's siblings (``repro_torch.core.flat``, ``rngtags``) from
# layers below the round, and an eager facade would close those cycles.
_EXPORTS = {
    **dict.fromkeys(("cohort_gradient", "scan_cohort_deltas_flat",
                     "scan_cohort_gradient_flat", "weighted_mean"),
                    "aggregate"),
    **dict.fromkeys(("init_async_state", "make_async_tick",
                     "resolve_async_shape", "staleness_discount"),
                    "async_round"),
    **dict.fromkeys(("available_algorithms", "get_algorithm",
                     "register_algorithm"), "algorithms"),
    **dict.fromkeys(("fedavg_update", "make_client_update", "uga_update"),
                    "client"),
    **dict.fromkeys(("available_engines", "get_engine", "register_engine",
                     "resolve_engine"), "engines"),
    **dict.fromkeys(("available_executors", "get_executor",
                     "register_executor", "resolve_executor"), "executors"),
    **dict.fromkeys(("meta_update", "meta_update_through_aggregation",
                     "meta_update_through_aggregation_scan",
                     "meta_update_through_cohort"), "meta"),
    **dict.fromkeys(("RoundFnCache", "grad_global_norm", "init_server_state",
                     "make_federated_round", "participation_mask",
                     "resolve_server_lr", "stack_round_inputs"), "round"),
    "FederatedTrainer": "trainer",
    "server_opt": None,               # the module itself
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = _EXPORTS[name]
    value = (importlib.import_module(f"{__name__}.{name}") if mod is None
             else getattr(importlib.import_module(f"{__name__}.{mod}"),
                          name))
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = ["cohort_gradient", "scan_cohort_deltas_flat",
           "scan_cohort_gradient_flat", "weighted_mean",
           "init_async_state", "make_async_tick", "resolve_async_shape",
           "staleness_discount",
           "fedavg_update", "uga_update",
           "make_client_update", "meta_update",
           "meta_update_through_aggregation",
           "meta_update_through_aggregation_scan",
           "meta_update_through_cohort", "init_server_state",
           "make_federated_round", "grad_global_norm", "participation_mask",
           "resolve_server_lr", "server_opt", "RoundFnCache",
           "stack_round_inputs",
           "register_algorithm", "get_algorithm", "available_algorithms",
           "register_executor", "get_executor", "available_executors",
           "resolve_executor",
           "register_engine", "get_engine", "available_engines",
           "resolve_engine",
           "FederatedTrainer"]
