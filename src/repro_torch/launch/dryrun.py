"""The dry run: the cost of every (architecture x input shape) pair on
H100 cards, without data and without a card (PyTorch port of
``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh 2x1] [--out artifacts/dryrun_torch]

:func:`run_one` builds the model at full width on fake ``cuda`` tensors in
the config's dtype (``cfg.dtype``, bfloat16 for every config), as JAX's
dry run builds it: each parameter in the dtype the model's init gives it
(the norms, the router and the mamba block's ``A_log`` / ``D`` /
``dt_bias`` stay fp32), the encoder inputs and the decode cache in the
config's dtype, the round's client weights fp32; the server's flat
buffers are fp32 per dtype group (``core/flat.py``).  It then traces one call with the cost counter
(:func:`repro_torch.roofline.cost.trace_cost`): the federated round for a
``train`` shape, ``model.prefill`` for ``prefill`` and ``model.decode``
over a cache of ``seq_len`` for ``decode``.  Each hand-written kernel
charges its declared cost, so the record is the card's program even on a
host without a card; nothing is allocated.  A form a kernel refuses (a
flash head-dim form outside ``kernels/flash_attention/kernel.py::FORMS``,
an SSD state too wide) fails the pair and names it.

Meshes: ``--mesh 1x1`` (one H100) is the default.  ``--mesh DxM`` traces
rank 0 of a (data, model) mesh under torch's ``fake`` process-group
backend (``launch/mesh.py::fake_mesh``: every collective dispatches, none
communicates, each counted at its result bytes), and ``--multi-pod`` /
``--both-meshes`` take the JAX package's meaning: rank 0 of
``make_production_mesh``'s (16, 16), and of its (2, 16, 16), tagged as
JAX tags them (``__16x16``, ``__2x16x16``).  On a mesh a ``train`` pair
runs the round through the ``sharded`` executor, the cohort over the
batch axes and each client tensor-parallel over the model axis; a
``prefill`` or ``decode`` pair runs on rank 0's parameter shards, its
rows of the batch (``simple_batch_shardings``) and its part of the cache
(``cache_shardings``).  The per-device memory is the port's placement,
which the record states under ``placement``: parameters split over
``model`` and kept whole over the batch axes (``param_spec``'s FSDP
entries are ROADMAP Queue 1 item 7d), each client's residual stream
split over ``model`` by its batch rows between sublayers (``--act-spec
on``, the default, JAX's ``set_activation_spec``: a local step's rows in
``ceil(b / M)`` a process, zero rows padding the last; ``off`` keeps it
replicated; the record's ``placement["activations"]`` states the rows),
the experts over ``model`` (``--expert-axis model``, the one axis the
port splits them over; another raises).  ``fits`` says
whether that placement fits one card; no pair is skipped for not
fitting.

The record has the JAX dry run's keys where they mean something —
``arch``, ``shape``, ``mesh``, ``chips``, ``algorithm``,
``cohort_strategy``, ``cohort``, ``decode_window``, ``memory``, ``cost``,
``collectives``, ``roofline_raw``, ``roofline`` and ``hlo_cost`` — and
adds ``trace_s`` (in place of ``lower_s`` / ``compile_s``), ``launches``
(per kernel) and ``fits`` (the per-device arguments plus temp under 80
GiB).  ``roofline_raw`` and ``roofline`` are equal: JAX's raw one reads
XLA's ``cost_analysis``, which counts a loop body once, and its other one
the trip-count-aware walk; an eager trace dispatches every iteration, so
the port has one count.  As in the JAX package a failing pair is
recorded, the sweep goes on, and the run exits 1.

The scan cohort's shortcut.  A train pair on the ``scan`` strategy (the
configs past 20 B parameters: a cohort of 16 clients run one after
another) is traced at cohorts 1 and 2 with the per-client batch of the
full cohort, and every counted quantity at cohort C is taken as ``c1 +
(C - 1) (c2 - c1)``: FLOPs, bytes read and written, collective bytes and
counts, each kernel's launches, the aten op count and the four memory
sizes.  The scan loop runs the same ops for every client (the same
shapes, one accumulate pass each), so each count is linear in the cohort;
the temp peak is one client's working set plus what grows a client at a
time, linear too.  ``tools/roofline_check.py --shortcut-check`` holds
this to a full trace of a scan pair on the card's host.  The record says
so under ``extrapolated`` (the cohorts traced and the rule; False for a
pair traced whole).  ``--no-extrapolate`` traces the whole cohort, and a
mesh always does.  It is what makes jamba-1.5-large-398b x
train_4k affordable: 16 clients through 63 mamba layers' chunk loops
trace past 3000 s, cohorts 1 and 2 in about a fifth of that.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import (ARCHS, SHAPES, SKIPS, FedConfig, get_arch,
                                 get_shape)
from repro_torch.roofline.analysis import (model_flops_per_round,
                                           roofline_terms)
from repro_torch.roofline.cost import Cost, trace_cost, trace_device

# archs whose parameter count forces the client-sequential cohort strategy
SCAN_THRESHOLD = 20e9
CARD_BYTES = 80 * 2**30        # one H100's device memory
ITEM_7D = "ROADMAP Queue 1 item 7d"
# what a process of a mesh holds (the record's "placement")
PLACEMENT = {
    "params": "param_spec's model-axis part on each process; the FSDP "
              f"entries kept whole over the batch axes ({ITEM_7D})",
    "batch": "rank 0's rows: the cohort over the batch axes (train), "
             "simple_batch_shardings (prefill, decode)",
    "cache": "rank 0's part, as cache_shardings places it",
    "experts": "split over model (models/moe.py::_experts)",
}
META_BATCH = 64                # the JAX dry run's D_meta sequences
SHORTCUT_COHORTS = (1, 2)      # the scan cohorts the shortcut traces


def pick_strategy(arch_cfg) -> str:
    return "scan" if arch_cfg.param_count() > SCAN_THRESHOLD else "vmap"


def fed_for(arch_cfg, data: int, *, algorithm="uga", meta=True,
            strategy: Optional[str] = None, local_steps=2,
            agg_dtype="float32") -> FedConfig:
    """JAX's rule: a vmap cohort is one client per device of the batch
    axes (``data``: their size), a scan cohort 16."""
    strategy = strategy or pick_strategy(arch_cfg)
    cohort = data if strategy == "vmap" else 16
    return FedConfig(algorithm=algorithm, meta=meta, cohort=cohort,
                     local_steps=local_steps, cohort_strategy=strategy,
                     grad_agg_dtype=agg_dtype, fused_update=True)


def decode_window_for(arch_cfg, shape) -> int:
    """long_500k uses the sliding-window variant for dense/VLM/moe attention
    archs; jamba/mamba2 use their native constant-state / full-cache path."""
    if shape.name == "long_500k" and arch_cfg.family not in ("ssm", "hybrid"):
        return arch_cfg.sliding_window
    return 0


def parse_mesh(mesh: str) -> Tuple[int, ...]:
    """``DATAxMODEL`` (e.g. 1x1, 16x16) or ``PODxDATAxMODEL`` (2x16x16)
    -> the axis sizes."""
    try:
        sizes = tuple(int(x) for x in mesh.lower().split("x"))
    except ValueError:
        sizes = ()
    if len(sizes) not in (2, 3):
        raise ValueError(f"--mesh {mesh!r}: expected DATAxMODEL or "
                         "PODxDATAxMODEL, e.g. 1x1, 16x16, 2x16x16")
    if min(sizes) < 1:
        raise ValueError(f"--mesh {mesh!r}: axes must be >= 1")
    return sizes


def check_hints(expert_axis: Optional[str], act_spec: str) -> None:
    """JAX's two placement hints: the experts' axis is the model axis
    (the placement the port runs), and the activation spec
    on or off (:func:`repro_torch.sharding.tensor_parallel.
    set_activation_spec`)."""
    if expert_axis not in (None, "model"):
        raise ValueError(
            f"--expert-axis {expert_axis}: the port splits the experts "
            "over the model axis only (models/moe.py::_experts); the batch "
            "axes' processes serve other rows and train other clients, so "
            "experts split over them would need an all-to-all of tokens "
            f"the port does not run ({ITEM_7D})")
    if act_spec not in ("on", "off"):
        raise ValueError(f"--act-spec {act_spec!r}: on or off")


def activations_placement(shape, fed, model: int, act_spec: str) -> str:
    """The record's ``placement["activations"]``: where a client's
    residual stream lives on a mesh whose model axis is ``model``."""
    if shape.kind != "train":
        return "replicated over model (serving runs the stream whole)"
    if act_spec == "off" or model == 1:
        return "replicated over model (--act-spec off)"

    def split(b):
        r = -(-b // model)
        return (f"{b} rows as {r} a process ({r * model - b} zero rows "
                "padding)")
    step = shape.global_batch // fed.cohort // fed.local_steps
    return (f"split over model by batch rows between sublayers "
            f"(--act-spec on): a local step's {split(step)}, the meta "
            f"batch's {split(META_BATCH)}; each sublayer's input gathered "
            "whole, its output reduce-scattered to the rows")


def model_dtype(cfg) -> torch.dtype:
    """The config's dtype (``cfg.dtype``) as a torch dtype."""
    return getattr(torch, cfg.dtype)


def param_dtypes(cfg) -> Dict[str, torch.dtype]:
    """Each parameter's dtype in a model built at ``cfg.dtype``: what
    ``init_transformer`` gives it, read off an init on fake tensors (no
    value is drawn, nothing is allocated)."""
    from repro_torch.models.transformer import init_transformer
    with FakeTensorMode():
        params = init_transformer(cfg, torch.Generator(), model_dtype(cfg))
    return {k: v.dtype for k, v in params.items()}


def _param_stand_ins(cfg, dev, shapes=None):
    """Every parameter leaf (or its part ``shapes[name]``) as an empty
    tensor in its dtype (fake inside the caller's fake mode), shapes from
    the module on the meta device."""
    from repro_torch.models.transformer import Transformer
    dts = param_dtypes(cfg)
    if shapes is None:
        shapes = {k: tuple(v.shape)
                  for k, v in Transformer(cfg).named_parameters()}
    return {k: torch.empty(s, dtype=dts[k], device=dev)
            for k, s in shapes.items()}


def _enc(cfg, lead, dev):
    e = cfg.encoder
    return torch.empty(tuple(lead) + (e.enc_len, e.enc_dim),
                       dtype=model_dtype(cfg), device=dev)


def _serve_args(cfg, dev, mesh, batch: int, cache_len: int):
    """(the serving axis of rank 0 of ``mesh``, its parameter shards as
    stand-ins, its rows of the batch)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.sharding.tensor_parallel import serve_axis
    shapes = dict(Transformer(cfg).named_parameters())
    tp = serve_axis(mesh, shapes, batch=batch, cache_len=cache_len)
    params = _param_stand_ins(cfg, dev, {
        k: tuple(s.stop - s.start for s in tp.slices(k, v.shape))
        for k, v in shapes.items()})
    rows = tp.serving.batch_rows()
    return tp, params, rows.stop - rows.start


def _train_call(cfg, shape, fed, mesh, dev, loss_chunk, per_client=None):
    """The round and its stand-in inputs; ``per_client`` (default: the
    shape's global batch over the cohort) fixes each client's batch when
    the shortcut traces a smaller cohort."""
    from repro_torch.core.round import (init_server_state,
                                        make_federated_round)
    from repro_torch.models.model import build_model
    model = build_model(cfg, dtype=model_dtype(cfg), loss_chunk=loss_chunk)
    cohort, seq = fed.cohort, shape.seq_len
    if per_client is None:
        per_client = shape.global_batch // cohort
    if per_client < fed.local_steps:
        raise ValueError(f"{cfg.name}/{shape.name}: per-client batch "
                         f"{per_client} < local_steps {fed.local_steps}")
    state = init_server_state(model, fed, params=_param_stand_ins(cfg, dev))
    cohort_batch = {"tokens": torch.empty((cohort, per_client, seq + 1),
                                          dtype=torch.int64, device=dev)}
    meta_batch = {"tokens": torch.empty((META_BATCH, seq + 1),
                                        dtype=torch.int64, device=dev)}
    if cfg.encoder is not None:
        cohort_batch["enc_embeds"] = _enc(cfg, (cohort, per_client), dev)
        meta_batch["enc_embeds"] = _enc(cfg, (META_BATCH,), dev)
    weights = torch.empty((cohort,), dtype=torch.float32, device=dev)
    fn = make_federated_round(model, fed, mesh=mesh)
    return fn, (state, cohort_batch, meta_batch, weights)


def train_cost(cfg, shape, fed, *, per_client=None, loss_chunk=2048,
               device="cuda") -> Cost:
    """One trace of the round of ``fed`` on full-width stand-ins, in a
    fake mode of its own."""
    device = torch.device(device)
    fmode = FakeTensorMode(allow_non_fake_inputs=False)
    with fmode:
        fn, args = _train_call(cfg, shape, fed, None, trace_device(device),
                               loss_chunk, per_client)
    return trace_cost(fn, args, device=device, mode=fmode)[0]


def _line(c1: float, c2: float, cohort: int):
    return c1 + (cohort - 1) * (c2 - c1)


def extrapolate_cost(c1: Cost, c2: Cost, cohort: int) -> Cost:
    """The cost at ``cohort`` from the traces at cohorts 1 and 2: each
    count ``c1 + (cohort - 1) (c2 - c1)``, integers kept integers (the
    module docstring says why it is exact)."""
    def line_dict(a, b):
        return {k: _line(a.get(k, 0), b.get(k, 0), cohort)
                for k in sorted(set(a) | set(b))}
    return Cost(
        flops=_line(c1.flops, c2.flops, cohort),
        tc_flops=_line(c1.tc_flops, c2.tc_flops, cohort),
        bf16_flops=_line(c1.bf16_flops, c2.bf16_flops, cohort),
        bytes_read=_line(c1.bytes_read, c2.bytes_read, cohort),
        bytes_written=_line(c1.bytes_written, c2.bytes_written, cohort),
        collective_bytes=_line(c1.collective_bytes, c2.collective_bytes,
                               cohort),
        per_collective=line_dict(c1.per_collective, c2.per_collective),
        collective_counts=line_dict(c1.collective_counts,
                                    c2.collective_counts),
        launches={k: v for k, v in line_dict(c1.launches,
                                             c2.launches).items() if v},
        n_ops=_line(c1.n_ops, c2.n_ops, cohort),
        memory=line_dict(c1.memory, c2.memory),
        trace_s=c1.trace_s + c2.trace_s)


def _prefill_call(cfg, shape, dev, mesh=None):
    """``model.prefill`` and its stand-ins: rank 0's on ``mesh``."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, dtype=model_dtype(cfg))
    B = shape.global_batch
    if mesh is None:
        fn, params = model.prefill, _param_stand_ins(cfg, dev)
    else:
        tp, params, B = _serve_args(cfg, dev, mesh, B, shape.seq_len)
        fn = partial(model.prefill, tp=tp)
    batch = {"tokens": torch.empty((B, shape.seq_len), dtype=torch.int64,
                                   device=dev)}
    if cfg.encoder is not None:
        batch["enc_embeds"] = _enc(cfg, (B,), dev)
    return fn, (params, batch)


def _decode_call(cfg, shape, dev, window, mesh=None):
    """``model.decode`` and its stand-ins over a cache of the shape's
    length: rank 0's on ``mesh``."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, dtype=model_dtype(cfg), decode_window=window)
    B = shape.global_batch
    cache = model.make_cache(B, shape.seq_len, device=dev, mesh=mesh)
    if mesh is None:
        fn, params = model.decode, _param_stand_ins(cfg, dev)
    else:
        tp, params, B = _serve_args(cfg, dev, mesh, B,
                                    window or shape.seq_len)
        fn = partial(model.decode, tp=tp)
    toks = torch.empty((B,), dtype=torch.int64, device=dev)
    return fn, (params, toks, cache)


def run_one(arch_name: str, shape_name: str, *, mesh: str = "1x1",
            algorithm: str = "uga", strategy: Optional[str] = None,
            local_steps: int = 2, agg_dtype: str = "float32",
            loss_chunk: int = 2048, moe_impl: str = "einsum",
            expert_axis: Optional[str] = None, act_spec: str = "on",
            extrapolate: bool = True, verbose: bool = True
            ) -> Dict[str, Any]:
    """One pair's record (module docstring); ``extrapolate`` takes a scan
    cohort's train pair by the shortcut."""
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding import tensor_parallel as TP
    check_hints(expert_axis, act_spec)
    arch_cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    sizes = parse_mesh(mesh)
    chips = math.prod(sizes)
    data = chips // sizes[-1]          # the batch axes' size
    device = torch.device("cuda")
    rec: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                           "mesh": "x".join(map(str, sizes)),
                           "chips": chips, "algorithm": algorithm,
                           "dtype": arch_cfg.dtype}
    if chips > 1:
        rec["placement"] = dict(PLACEMENT)
        rec["expert_axis"] = expert_axis
        rec["act_spec"] = act_spec
    fed = None
    prev_impl, prev_rows = moe_lib.MOE_IMPL, TP.ACT_ROWS
    moe_lib.set_moe_impl(moe_impl)
    TP.set_activation_spec(act_spec == "on")
    fmode = FakeTensorMode(allow_non_fake_inputs=False)
    dev = trace_device(device)
    mesh_obj = None
    rec["extrapolated"] = False
    shortcut = None
    try:
        with fmode:
            if chips > 1:
                mesh_obj = fake_mesh(sizes, dev)
            if shape.kind == "train":
                fed = fed_for(arch_cfg, data, algorithm=algorithm,
                              strategy=strategy, local_steps=local_steps,
                              agg_dtype=agg_dtype)
                rec["cohort_strategy"] = fed.cohort_strategy
                rec["cohort"] = fed.cohort
                if (extrapolate and chips == 1 and fed.cohort_strategy ==
                        "scan" and fed.cohort > max(SHORTCUT_COHORTS)):
                    shortcut = shape.global_batch // fed.cohort
                else:
                    fn, args = _train_call(arch_cfg, shape, fed, mesh_obj,
                                           dev, loss_chunk)
            elif shape.kind == "prefill":
                fn, args = _prefill_call(arch_cfg, shape, dev, mesh_obj)
            else:
                window = decode_window_for(arch_cfg, shape)
                rec["decode_window"] = window
                fn, args = _decode_call(arch_cfg, shape, dev, window,
                                        mesh_obj)
        if shortcut is None:
            # the model axis's client update traces without the fake
            # dispatch cache (roofline/cost.py::trace_cost says why)
            cost, _ = trace_cost(fn, args, device=device, mode=fmode,
                                 fake_cache=not (shape.kind == "train"
                                                 and sizes[-1] > 1))
        else:
            c1, c2 = (train_cost(arch_cfg, shape,
                                 dataclasses.replace(fed, cohort=c),
                                 per_client=shortcut, loss_chunk=loss_chunk,
                                 device=device) for c in SHORTCUT_COHORTS)
            cost = extrapolate_cost(c1, c2, fed.cohort)
            rec["extrapolated"] = {"from_cohorts": list(SHORTCUT_COHORTS),
                                   "rule": "c1 + (cohort - 1) * (c2 - c1)"}
    finally:
        moe_lib.set_moe_impl(prev_impl)
        TP.set_activation_spec(prev_rows)
        if mesh_obj is not None:
            torch.distributed.destroy_process_group()
    if chips > 1:
        rec["placement"]["activations"] = activations_placement(
            shape, fed, sizes[-1], act_spec)
    rec["trace_s"] = round(cost.trace_s, 2)
    rec["memory"] = dict(cost.memory)
    rec["cost"] = {"flops": cost.flops, "tc_flops": cost.tc_flops,
                   "bf16_flops": cost.bf16_flops,
                   "bytes accessed": cost.bytes,
                   "bytes read": cost.bytes_read,
                   "bytes written": cost.bytes_written,
                   "aten ops": float(cost.n_ops)}
    rec["collectives"] = {**cost.per_collective,
                          "_counts": dict(cost.collective_counts)}
    mf = model_flops_per_round(arch_cfg, shape, fed)
    rl = roofline_terms(cost.flops, cost.bytes, cost.collective_bytes,
                        model_flops_global=mf, chips=chips,
                        tc_flops_per_chip=cost.tc_flops,
                        bf16_flops_per_chip=cost.bf16_flops)
    rec["roofline_raw"] = rl.to_dict()
    rec["roofline"] = rl.to_dict()
    rec["hlo_cost"] = {"flops": cost.flops,
                       "bytes_written": cost.bytes_written,
                       "collective_bytes": cost.collective_bytes,
                       "per_collective": dict(cost.per_collective),
                       "loop_ratio": 1.0}
    rec["launches"] = dict(cost.launches)
    need = (cost.memory["argument_size_in_bytes"]
            + cost.memory["temp_size_in_bytes"])
    rec["fits"] = bool(need < CARD_BYTES)
    if verbose:
        print(f"[dryrun] {arch_name} x {shape_name} mesh={rec['mesh']} "
              f"trace={rec['trace_s']}s flops/dev={cost.flops:.3e} "
              f"bytes/dev={cost.bytes:.3e} "
              f"coll/dev={cost.collective_bytes:.3e} "
              f"peak={need / 2**30:.2f}GiB fits={rec['fits']} "
              f"bottleneck={rl.bottleneck} launches={rec['launches']}"
              + (" extrapolated from cohorts 1, 2" if rec["extrapolated"]
                 else ""), flush=True)
    return rec


def _pair(a: str, s: str, path: str, kw: Dict[str, Any]) -> Optional[str]:
    """Trace one pair and write its record; the failure's cause, or
    None."""
    try:
        rec = run_one(a, s, **kw)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return None
    except Exception as e:  # noqa: BLE001 — record and continue
        print(f"[dryrun] FAIL {os.path.basename(path)[:-5]}: "
              f"{type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        return f"{type(e).__name__}: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL (or PODxDATAxMODEL): one H100 (1x1) "
                         "or rank 0 of that mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of the (2, 16, 16) production mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the (16, 16) and the (2, 16, 16) production "
                         "meshes")
    ap.add_argument("--expert-axis", default=None,
                    help="the experts' axis: model (the port's placement) "
                         "or none")
    ap.add_argument("--act-spec", default="on", choices=["on", "off"],
                    help="JAX's activation-sharding hint: on splits each "
                         "client's residual stream over model by its "
                         "batch rows; off keeps it replicated")
    ap.add_argument("--algorithm", default="uga",
                    choices=["uga", "fedavg", "fedprox"])
    ap.add_argument("--strategy", default=None, choices=[None, "vmap", "scan"])
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--agg-dtype", default="float32")
    ap.add_argument("--loss-chunk", type=int, default=2048)
    ap.add_argument("--moe-impl", default="einsum",
                    choices=["gather", "einsum"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs traced at once, each in a process of its "
                         "own (a trace is host work)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="trace a scan cohort whole, not by the cohort 1 "
                         "and 2 shortcut")
    args = ap.parse_args(argv)
    if args.both_meshes or args.multi_pod:
        if args.mesh != "1x1":
            ap.error("--multi-pod and --both-meshes set the mesh; drop "
                     "--mesh")
        meshes = (["16x16", "2x16x16"] if args.both_meshes
                  else ["2x16x16"])
    else:
        meshes = [args.mesh]
    for m in meshes:
        parse_mesh(m)
    check_hints(args.expert_axis, args.act_spec)
    if args.all:
        pairs = [(a, s) for a in ARCHS for s in SHAPES if (a, s) not in SKIPS]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]
    kw = dict(algorithm=args.algorithm,
              strategy=args.strategy, local_steps=args.local_steps,
              agg_dtype=args.agg_dtype, loss_chunk=args.loss_chunk,
              moe_impl=args.moe_impl, expert_axis=args.expert_axis,
              act_spec=args.act_spec, extrapolate=not args.no_extrapolate)

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for m in meshes:
        for a, s in pairs:
            tag = f"{a}__{s}__{m}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] skip existing {tag}")
                continue
            todo.append((tag, a, s, path, {**kw, "mesh": m}))
    if args.jobs > 1:
        # the train pairs' traces are the long ones: they start first
        todo.sort(key=lambda t: t[2] != "train_4k")
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            futs = [(tag, pool.submit(_pair, a, s, path, k))
                    for tag, a, s, path, k in todo]
            causes = [(tag, f.result()) for tag, f in futs]
    else:
        causes = [(tag, _pair(a, s, path, k))
                  for tag, a, s, path, k in todo]
    failures = [(tag, e) for tag, e in causes if e is not None]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        return 1
    print("\nall dry-runs passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
