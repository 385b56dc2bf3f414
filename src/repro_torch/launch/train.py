"""End-to-end federated training driver of the PyTorch port (mirrors
``repro/launch/train.py``, with the flags the port implements).

Runs real federated rounds — host data pipeline, UGA/FedAvg clients,
the server update (the fused flat sweep on the CUDA kernels, or the
legacy tree-map engine), FedMeta step — on one CUDA device (``--device
cpu`` runs the kernels' plain versions on the CPU).

  python -m repro_torch.launch.train --arch smollm-360m [--fused] \\
      --algorithm uga --meta --rounds 3 --cohort 4 --client-batch 8 \\
      --seq 128 [--rounds-per-call K] [--strategy scan | --cohort-chunk C] \\
      [--executor chunked|sharded|vmap|scan [--mesh-model 1]] \\
      [--server-opt adam] [--meta-mode through_aggregation] \\
      [--codec int8|sign1bit|topk [--error-feedback] [--topk-ratio R]] \\
      [--participation P] [--fault-profile flaky|stragglers] \\
      [--fault-drop|--fault-crash|--fault-delay R] [--round-deadline D] \\
      [--retry-backoff B] \\
      [--engine buffered_async [--async-buffer K] [--async-capacity C] \\
       [--async-max-staleness S] [--staleness-mode none|inv|invsqrt]] \\
      [--ckpt PATH] [--resume PATH|auto] [--run-dir DIR \\
       [--ckpt-every N] [--keep-last N] [--keep-every N]] \\
      [--tracker jsonl,csv,console] [--profile N [--profile-start R] \\
       [--trace-summary [--trace-top-k N]]] [--sanitize] \\
      [--plugin MODULE ...]

Without ``--fused`` the server step is the ``legacy_tree`` engine (the
tree-map stages, no kernel), as in the JAX launcher; ``--fused`` selects
``fused_flat``, and ``--engine NAME`` any registered engine.
``--rounds-per-call K`` runs K rounds a call, sampled on the host up
front and read back once (a K that does not divide ``--rounds`` leaves a
shorter last call).  ``--plugin MODULE`` imports a module before the
other flags are parsed, so the algorithms, executors and engines it
registers are valid choices (``--plugin examples.plugins.fedagg_torch
--algorithm fedagg``, with the repository root on ``PYTHONPATH``).

``--cohort-chunk C`` streams the cohort through the chunked executor, C
clients vmapped at a time; ``--executor sharded`` splits the cohort over
the processes of a ``torch.distributed`` job (``torchrun --nproc-per-node
N -m repro_torch.launch.train --executor sharded ...``; without torchrun
a world of one) and sums their partial aggregates; only rank 0 prints
and writes.  ``--mesh-model M`` above 1 makes the mesh (N / M, M): the
M processes of a model group run each client tensor-parallel over their
parameter shards and the server step over their rows of the flat
buffers (``python -m torch.distributed.run --nproc-per-node 2 -m
repro_torch.launch.train --arch smollm-360m --fused --executor sharded
--mesh-model 2``; on one card the two ranks share it over gloo, by the
mesh's backend rule).  Every architecture runs so, under
``meta_mode='post'``, no codec, the fused engine; the rest raises naming
ROADMAP Queue 1 item 7c.

Every ``--arch`` trains, ``mamba2-780m`` and the ``-smoke`` SSM and hybrid
configs included, the encoder configs on seeded ``enc_embeds``.  ``--engine buffered_async`` runs the buffered-async
runtime (``core/async_round.py``): one tick a round, the server stepping
every K arrived deltas; ``--fault-garble`` reaches it.  ``--ckpt`` saves
the server state at the end, ``--resume`` restores one (``auto``: the
newest blob of ``--run-dir``'s managed store, which ``--run-dir`` keeps
under ``DIR/checkpoints``); the blobs are the JAX package's format.

Observability (``repro_torch.obs``): ``--tracker`` writes the round
records and the trainer's events (``metrics.jsonl``, ``metrics.csv``,
...) under ``--run-dir``; ``--profile N`` captures a ``torch.profiler``
trace of N rounds from ``--profile-start`` into ``<run-dir>/profile``,
and ``--trace-summary`` parses it into a ``profile_summary`` event;
``python -m repro_torch.obs report <run-dir>`` summarizes a run.
``--sanitize`` probes the flat buffers for NaN/Inf each round and trains
under autograd's anomaly mode (``repro_torch.core.sanitize``).
``--roofline`` traces each distinct round function once on fake tensors
(``repro_torch.roofline``) and emits a ``roofline`` event, the cost
model's per-round prediction beside the measured rounds/s;
``python -m repro_torch.roofline.report <run-dir>`` prints it.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm import resolve_codec
from repro_torch.comm.codecs import available_codecs
from repro_torch.configs import FedConfig, get_arch, with_depth
from repro_torch.configs.base import SERVER_OPTS
from repro_torch.core.algorithms import available_algorithms
from repro_torch.core.engines import available_engines, resolve_engine
from repro_torch.core.executors import available_executors
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.partition import partition_iid
from repro_torch.data.pipeline import FederatedData
from repro_torch.data.synthetic import SeededFrames, synthetic_tokens
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.models.model import build_model
from repro_torch.sharding.tensor_parallel import check_supported
from repro_torch.sim.faults import FAULT_PROFILES


def build_synthetic_fed_data(cfg, *, num_clients: int, examples: int,
                             seq: int, iid: bool, seed: int = 0,
                             meta_fraction: float = 0.01) -> FederatedData:
    """Byte-identical to the JAX package's synthetic federated data for
    the same arguments; a config with an encoder also gets seeded
    ``enc_embeds`` (:class:`repro_torch.data.synthetic.SeededFrames`, the
    port's own: JAX's launcher makes none and trains no encoder config),
    drawn apart from the tokens' generator."""
    rng = np.random.default_rng(seed)
    ds = synthetic_tokens(rng, n=examples, seq_len=seq + 1,
                          vocab=cfg.vocab_size, num_clients=num_clients)
    arrays = {"tokens": ds.tokens}
    if getattr(cfg, "encoder", None) is not None:
        e = cfg.encoder
        arrays["enc_embeds"] = SeededFrames(examples, e.enc_len, e.enc_dim,
                                            seed)
    if iid:
        parts = partition_iid(rng, examples, num_clients)
    else:
        parts = [np.where(ds.role == c)[0] for c in range(num_clients)]
        parts = [p if p.size else np.array([0]) for p in parts]
    n_meta = max(int(examples * meta_fraction), 8)
    meta_idx = rng.choice(examples, n_meta, replace=False)
    shared_idx = rng.choice(examples, n_meta, replace=False)
    return FederatedData(arrays=arrays, client_indices=parts,
                         meta_indices=meta_idx, shared_indices=shared_idx,
                         seed=seed)


def run_training(arch: str, *, rounds: int, cohort: int, client_batch: int,
                 seq: int, algorithm: str = "uga", meta: bool = True,
                 share: bool = False, local_steps: int = 2,
                 local_epochs: int = 1, client_lr: float = 0.01,
                 server_lr: Optional[float] = None,
                 meta_lr: Optional[float] = None, server_opt: str = "sgd",
                 num_clients: int = 32, examples: int = 2048,
                 iid: bool = False, seed: int = 0, log_every: int = 10,
                 strategy: str = "vmap", cohort_chunk: Optional[int] = None,
                 executor: Optional[str] = None, mesh_model: int = 1,
                 fused: bool = False, rounds_per_call: int = 1,
                 meta_mode: str = "post", ctrl_lr: float = 0.01,
                 codec: str = "none", error_feedback: bool = False,
                 topk_ratio: float = 0.01, participation: float = 1.0,
                 fault_profile: str = "none", fault_drop: float = -1.0,
                 fault_crash: float = -1.0, fault_delay: float = -1.0,
                 fault_max_delay: int = -1, fault_garble: float = -1.0,
                 fault_garble_scale: float = -1.0,
                 fault_speed_tail: float = -1.0, round_deadline: float = 0.0,
                 retry_backoff: int = 0, engine: Optional[str] = None,
                 async_buffer: int = 0, async_capacity: int = 0,
                 async_max_staleness: int = 0,
                 staleness_mode: str = "invsqrt",
                 ckpt_path: Optional[str] = None,
                 resume: Optional[str] = None, run_dir: Optional[str] = None,
                 ckpt_every: int = 0, keep_last: int = 3, keep_every: int = 0,
                 sanitize: bool = False, tracker=None, profile: int = 0,
                 profile_start: int = 0, trace_summary: bool = False,
                 trace_top_k: int = 15, roofline: bool = False,
                 device=None, params=None, layers: int = 0,
                 on_records: Optional[Callable] = None):
    """Assemble (model, FedConfig, FederatedData) and train.  ``params``
    starts from given parameters instead of a seeded init; ``on_records``
    is the trainer's per-round hook.  The participation, ``fault_*``,
    ``engine`` / ``async_*`` and checkpoint knobs are those of the JAX
    package's ``launch/train.py``: ``resume`` is a blob ``ckpt_path``
    wrote, or ``"auto"``, the newest blob of ``run_dir``'s managed store,
    which saves every ``ckpt_every`` rounds (0: at run end) with
    ``keep_last`` / ``keep_every`` retention.  ``cohort_chunk``,
    ``executor`` and ``mesh_model`` are those of the JAX package's too:
    ``executor='sharded'`` builds a (data, model) mesh over every process
    of the job (:func:`repro_torch.launch.mesh.make_auto_mesh`).
    ``fused=False`` with no ``engine`` runs ``legacy_tree``;
    ``rounds_per_call`` is the trainer's K.  ``sanitize``, ``tracker``,
    ``profile``, ``profile_start`` and ``trace_summary`` are the JAX
    launcher's observability knobs (the trainer's, writing under
    ``run_dir``; ``trace_top_k``: the summary's table length);
    ``roofline`` emits the trainer's ``roofline`` event; ``layers`` cuts
    the config's depth (:func:`repro_torch.configs.with_depth`; 0 keeps
    it).  (The CLI's
    ``--sanitize`` also runs this under ``torch.autograd.detect_anomaly``;
    ``sanitize`` here plants the probes only: see
    :mod:`repro_torch.core.sanitize`.)  Returns (state, history)."""
    if mesh_model != 1 and executor != "sharded":
        raise ValueError(
            f"--mesh-model {mesh_model} sets the model axis of the "
            "--executor sharded mesh; add --executor sharded")
    dev = resolve_device(device)
    strict_fp32()
    cfg = with_depth(get_arch(arch), layers)
    model = build_model(cfg, dtype=torch.float32, loss_chunk=256)
    fed = FedConfig(
        algorithm=algorithm, meta=meta, share=share, cohort=cohort,
        local_steps=local_steps, local_epochs=local_epochs,
        client_lr=client_lr,
        server_lr=server_lr if server_lr is not None else client_lr,
        meta_lr=meta_lr if meta_lr is not None else client_lr,
        server_opt=server_opt, meta_mode=meta_mode, ctrl_lr=ctrl_lr,
        codec=codec, error_feedback=error_feedback, topk_ratio=topk_ratio,
        cohort_strategy=strategy, cohort_chunk=cohort_chunk,
        lr_decay=0.992, fused_update=fused,
        participation=participation, fault_profile=fault_profile,
        fault_drop=fault_drop, fault_crash=fault_crash,
        fault_delay=fault_delay, fault_max_delay=fault_max_delay,
        fault_garble=fault_garble, fault_garble_scale=fault_garble_scale,
        fault_speed_tail=fault_speed_tail, round_deadline=round_deadline,
        retry_backoff=retry_backoff, engine=engine,
        async_buffer=async_buffer, async_capacity=async_capacity,
        async_max_staleness=async_max_staleness,
        staleness_mode=staleness_mode)
    data = build_synthetic_fed_data(cfg, num_clients=num_clients,
                                    examples=examples, seq=seq, iid=iid,
                                    seed=seed)
    mesh = None
    if mesh_model > 1:              # before any process group starts
        check_supported(model, fed, engine=resolve_engine(fed),
                        codec=resolve_codec(fed))
    if executor == "sharded":
        # two-tier aggregation over every process of the job: the cohort
        # splits across the mesh's data axis, each process streams its
        # clients through the chunked core, one all_reduce sums the
        # partials
        from repro_torch.launch.mesh import make_auto_mesh
        mesh = make_auto_mesh(mesh_model, device=dev)
        if mesh.rank == 0:
            print(f"[train] sharded executor on mesh {dict(mesh.shape)}")
    trainer = FederatedTrainer(
        model, fed, rounds_per_call=rounds_per_call, seed=seed, device=dev,
        params=params, run_dir=run_dir,
        checkpoint_every=ckpt_every if run_dir is not None else None,
        keep_last=keep_last, keep_every=keep_every,
        executor=None if mesh is not None else executor, mesh=mesh,
        sanitize=sanitize, tracker=tracker, profile=profile,
        profile_start=profile_start, trace_summary=trace_summary,
        trace_top_k=trace_top_k, roofline=roofline)
    if resume == "auto":
        if run_dir is None:
            raise ValueError(
                "--resume auto reads the managed checkpoint store and "
                "needs --run-dir; pass an explicit checkpoint path "
                "otherwise")
        step = trainer.resume_latest()
        if trainer.is_main:
            print("[train] resume auto: "
                  + (f"round {step} from {run_dir}/checkpoints" if step
                     is not None else "empty store, starting fresh"))
    elif resume:
        extra = trainer.restore(resume)
        if trainer.is_main:
            print(f"[train] resumed {resume} at round {trainer.round} "
                  f"(saved by arch={extra.get('arch')})")
    meta_bs = min(client_batch * 2, 32)
    history = trainer.run(data, rounds=rounds, cohort=cohort,
                          batch=client_batch, meta_batch=meta_bs,
                          share=share, log_every=log_every,
                          on_records=on_records)
    if ckpt_path:
        trainer.save(ckpt_path, extra={"arch": arch, "rounds": rounds,
                                       "algorithm": algorithm})
        if trainer.is_main:
            print(f"[train] saved server state to {ckpt_path}")
    trainer.finish()
    return trainer.state, history


def main(argv=None):
    # --plugin modules import (and register) before the main parser reads
    # the registries for --algorithm's and --engine's choices
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--plugin", action="append", default=[],
                     help="module to import before parsing the remaining "
                          "flags — its register_algorithm/executor/engine "
                          "calls make the names selectable (repeatable)")
    plug_args, _ = pre.parse_known_args(argv)
    for mod in plug_args.plugin:
        importlib.import_module(mod)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 parents=[pre])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--client-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--algorithm", default="uga",
                    choices=list(available_algorithms()),
                    help="any registered client algorithm "
                         "(repro_torch.core.algorithms)")
    ap.add_argument("--meta", action="store_true")
    ap.add_argument("--no-meta", dest="meta", action="store_false")
    ap.set_defaults(meta=True)
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--client-lr", type=float, default=0.01)
    ap.add_argument("--server-lr", type=float, default=None,
                    help="eta_g (default: --client-lr)")
    ap.add_argument("--meta-lr", type=float, default=None,
                    help="eta_meta (default: --client-lr)")
    ap.add_argument("--server-opt", default="sgd", choices=SERVER_OPTS)
    ap.add_argument("--strategy", default="vmap",
                    help="cohort executor: client-parallel stack (vmap), "
                         "client-sequential streaming (scan), or any "
                         "registered executor name")
    ap.add_argument("--cohort-chunk", type=int, default=None,
                    help="stream the cohort through the chunked executor "
                         "in slices of this many clients (vmapped) — peak "
                         "gradient memory is one chunk, and the "
                         "accumulation order is the same for every chunk "
                         "size")
    ap.add_argument("--executor", default=None,
                    choices=[n for n in available_executors()
                             if n != "buffered_async"],
                    help="cohort-executor registry name; 'sharded' builds "
                         "a (data, model) mesh over every process of the "
                         "job (torchrun; a world of one without it) and "
                         "runs the two-tier aggregation")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-axis size of the --executor sharded mesh "
                         "(the data axis takes the remaining processes): "
                         "tensor-parallel client compute, post mode, no "
                         "codec, --fused; the rest is ROADMAP Queue 1 "
                         "item 7c")
    ap.add_argument("--fused", action="store_true",
                    help="fused flat-buffer CUDA server engine (default: "
                         "the legacy_tree engine)")
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="run K rounds a call, sampled up front and read "
                         "back once")
    ap.add_argument("--meta-mode", default="post",
                    choices=["post", "through_aggregation"],
                    help="FedMeta step: post-aggregation parameter step, or "
                         "hypergradients through the aggregation (needs an "
                         "engine with the capability, i.e. --fused)")
    ap.add_argument("--ctrl-lr", type=float, default=0.01,
                    help="controllable-weights step size "
                         "(--meta-mode through_aggregation)")
    ap.add_argument("--codec", default="none",
                    choices=list(available_codecs()),
                    help="client->server uplink gradient codec "
                         "(repro_torch.comm); lossy codecs need --fused")
    ap.add_argument("--error-feedback", action="store_true",
                    help="keep per-client compression residuals "
                         "(state['comm']) and re-add them before each "
                         "round's encode (needs a lossy --codec)")
    ap.add_argument("--topk-ratio", type=float, default=0.01,
                    help="fraction of elements the 'topk' codec ships")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="<1: straggler dropout — per-round probability a "
                         "sampled client reports; dropped clients' weights "
                         "are zeroed inside the aggregation")
    ap.add_argument("--fault-profile", default="none",
                    choices=sorted(FAULT_PROFILES),
                    help="named client-fault profile (repro_torch.sim."
                         "faults); --fault-* flags override individual "
                         "rates")
    ap.add_argument("--fault-drop", type=float, default=-1.0,
                    help="P(uplink report lost); <0 uses the profile")
    ap.add_argument("--fault-crash", type=float, default=-1.0,
                    help="P(client dies mid-round); <0 uses the profile")
    ap.add_argument("--fault-delay", type=float, default=-1.0,
                    help="P(report arrives rounds late); <0 uses the "
                         "profile")
    ap.add_argument("--fault-max-delay", type=int, default=-1,
                    help="late reports land 1..N rounds late; <0 uses the "
                         "profile")
    ap.add_argument("--fault-garble", type=float, default=-1.0,
                    help="P(payload corrupted) — buffered_async only; <0 "
                         "uses the profile")
    ap.add_argument("--fault-garble-scale", type=float, default=-1.0,
                    help="corrupted payloads scale by U(-s, s); <0 uses "
                         "the profile")
    ap.add_argument("--fault-speed-tail", type=float, default=-1.0,
                    help="lognormal sigma of client compute time (the "
                         "deadline's latency model); <0 uses the profile")
    ap.add_argument("--round-deadline", type=float, default=0.0,
                    help="sync barrier timeout in simulated round-units "
                         "(0: wait forever)")
    ap.add_argument("--retry-backoff", type=int, default=0,
                    help=">0: re-enqueue failed clients after "
                         "backoff * 2^attempt rounds")
    ap.add_argument("--engine", default=None,
                    choices=list(available_engines()),
                    help="server-engine registry name (default derives "
                         "legacy_tree/fused_flat from --fused); "
                         "'buffered_async' selects the buffered "
                         "asynchronous runtime")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="buffered_async: server steps every K arrived "
                         "deltas (0: cohort)")
    ap.add_argument("--async-capacity", type=int, default=0,
                    help="buffered_async: delta-pool slots (0: 2*cohort)")
    ap.add_argument("--async-max-staleness", type=int, default=0,
                    help="buffered_async: evict deltas staler than this "
                         "many server versions (0: unbounded)")
    ap.add_argument("--staleness-mode", default="invsqrt",
                    choices=["none", "inv", "invsqrt"],
                    help="flush-weight discount of stale deltas")
    ap.add_argument("--ckpt", default=None,
                    help="save the server state here at the end")
    ap.add_argument("--resume", default=None,
                    help="checkpoint written by --ckpt to continue from, "
                         "or 'auto': the newest blob in --run-dir's "
                         "managed store")
    ap.add_argument("--run-dir", default=None,
                    help="run directory for tracker files, profiler "
                         "traces, and the managed checkpoint store")
    from repro_torch.obs import available_trackers

    def tracker_spec(value: str) -> str:
        # a comma list of registered names (--plugin's included)
        bad = [n for n in (p.strip() for p in value.split(","))
               if n and n not in available_trackers()]
        if bad:
            raise argparse.ArgumentTypeError(
                f"unknown metrics tracker(s) {bad}; choose from "
                f"{', '.join(available_trackers())}")
        return value

    ap.add_argument("--tracker", default=None, type=tracker_spec,
                    help="metrics-tracker registry name or comma list "
                         f"(repro_torch.obs): "
                         f"{', '.join(available_trackers())}; file "
                         "trackers write under --run-dir (default: noop)")
    ap.add_argument("--profile", type=int, default=0,
                    help="capture a torch.profiler trace for N rounds into "
                         "<run-dir>/profile (0: off)")
    ap.add_argument("--profile-start", type=int, default=0,
                    help="first round of the --profile capture window")
    ap.add_argument("--trace-summary", action="store_true",
                    help="when the --profile window closes, parse the "
                         "trace into a profile_summary tracker event "
                         "(top ops by self time, busy/gap, per-phase "
                         "attribution); needs --profile N")
    ap.add_argument("--trace-top-k", type=int, default=15,
                    help="rows of the profile_summary's top-ops table "
                         "(the trainer's trace_top_k)")
    ap.add_argument("--roofline", action="store_true",
                    help="trace each distinct round function once on fake "
                         "tensors and emit a roofline tracker event "
                         "(predicted compute/memory/collective seconds and "
                         "rounds/s on the H100 hardware model beside the "
                         "measured rounds/s); python -m "
                         "repro_torch.roofline.report <run-dir> prints it")
    ap.add_argument("--sanitize", action="store_true",
                    help="debug mode: torch.autograd.detect_anomaly("
                         "check_nan=True) + NaN/Inf probes on the flat "
                         "buffers of every round, read back once a call "
                         "(repro_torch.core.sanitize)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="managed-store save period in rounds (needs "
                         "--run-dir; 0: one save at run end)")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="managed store: newest saves retained")
    ap.add_argument("--keep-every", type=int, default=0,
                    help="managed store: steps divisible by N are kept "
                         "for good (0: off)")
    ap.add_argument("--num-clients", type=int, default=32)
    ap.add_argument("--examples", type=int, default=2048)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--history-out", default=None)
    args = ap.parse_args(argv)
    # --sanitize's counterpart of jax_debug_nans: autograd's anomaly mode
    # names the backward function that first returns a NaN
    with (torch.autograd.detect_anomaly(check_nan=True) if args.sanitize
          else contextlib.nullcontext()):
        _, history = run_training(
            args.arch, rounds=args.rounds, cohort=args.cohort,
            client_batch=args.client_batch, seq=args.seq,
            algorithm=args.algorithm, meta=args.meta, share=args.share,
            local_steps=args.local_steps, local_epochs=args.local_epochs,
            client_lr=args.client_lr, server_lr=args.server_lr,
            meta_lr=args.meta_lr, server_opt=args.server_opt,
            num_clients=args.num_clients, examples=args.examples,
            iid=args.iid, seed=args.seed, log_every=args.log_every,
            strategy=args.strategy,
            cohort_chunk=args.cohort_chunk, executor=args.executor,
            mesh_model=args.mesh_model, fused=args.fused,
            rounds_per_call=args.rounds_per_call, meta_mode=args.meta_mode,
            ctrl_lr=args.ctrl_lr,
            codec=args.codec, error_feedback=args.error_feedback,
            topk_ratio=args.topk_ratio, participation=args.participation,
            fault_profile=args.fault_profile, fault_drop=args.fault_drop,
            fault_crash=args.fault_crash, fault_delay=args.fault_delay,
            fault_max_delay=args.fault_max_delay,
            fault_garble=args.fault_garble,
            fault_garble_scale=args.fault_garble_scale,
            fault_speed_tail=args.fault_speed_tail,
            round_deadline=args.round_deadline,
            retry_backoff=args.retry_backoff, engine=args.engine,
            async_buffer=args.async_buffer,
            async_capacity=args.async_capacity,
            async_max_staleness=args.async_max_staleness,
            staleness_mode=args.staleness_mode, ckpt_path=args.ckpt,
            resume=args.resume, run_dir=args.run_dir,
            ckpt_every=args.ckpt_every,
            keep_last=args.keep_last, keep_every=args.keep_every,
            sanitize=args.sanitize, tracker=args.tracker,
            profile=args.profile,
            profile_start=args.profile_start,
            trace_summary=args.trace_summary,
            trace_top_k=args.trace_top_k, roofline=args.roofline,
            device=args.device)
    main_rank = (not torch.distributed.is_initialized()
                 or torch.distributed.get_rank() == 0)
    if args.history_out and main_rank:
        os.makedirs(os.path.dirname(os.path.abspath(args.history_out)),
                    exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)



if __name__ == "__main__":
    main()
