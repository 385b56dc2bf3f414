"""Roofline terms under the H100 SXM hardware model (PyTorch port of
``repro/roofline/analysis.py``, whose model is TPU v5e's).

The cost of a round comes from a trace of the program one card runs
(:mod:`repro_torch.roofline.cost`), so its quantities are per device:

    compute term    = fp32_flops / FP32_FLOPS + tc_flops / TF32_FLOPS
                      + bf16_flops / BF16_FLOPS
    memory term     = bytes / HBM_BW
    collective term = collective_bytes / LINK_BW

The compute term adds two kinds of operation, as ``chip_smoke.py``'s
bounds do: the port's products are fp32 outside the tensor cores
(:func:`repro_torch.device.strict_fp32` turns TF32 off), while the
hand-written flash-attention and SSD-scan kernels compute theirs as three
TF32 tensor-core products each (3xTF32), which they declare as tensor-core
operations.  A product of bf16 operands (a model built at bf16: the
library's products on the tensor cores, the flash kernel's bf16 form)
counts at the bf16 tensor-core rate.  Constants from the H100 SXM data
sheet: 67 TFLOP/s fp32, 495 TFLOP/s dense TF32, 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, 450 GB/s NVLink a direction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FP32_FLOPS = 67e12           # fp32 FLOP/s outside the tensor cores
TF32_FLOPS = 495e12          # TF32 tensor-core FLOP/s, dense
BF16_FLOPS = 989e12          # bf16 tensor-core FLOP/s, dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink, one direction

# the c10d ops a trace counts as collectives, at their result bytes (the
# JAX package's convention: an all-gather's result is the gathered tensor)
COLLECTIVE_OPS = ("allreduce_", "allreduce_coalesced_", "allgather_",
                  "_allgather_base_", "allgather_coalesced_",
                  "allgather_into_tensor_coalesced_", "reduce_scatter_",
                  "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
                  "alltoall_", "alltoall_base_", "broadcast_", "reduce_",
                  "gather_", "scatter_", "send", "recv_")


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    bottleneck: str
    model_flops: Optional[float] = None
    flops_ratio: Optional[float] = None   # MODEL_FLOPS / (flops * chips)
    tc_flops_per_chip: float = 0.0        # of flops_per_chip, on the TCs
    bf16_flops_per_chip: float = 0.0      # of flops_per_chip, bf16 TCs

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float,
                   model_flops_global: Optional[float] = None,
                   chips: int = 1, tc_flops_per_chip: float = 0.0,
                   bf16_flops_per_chip: float = 0.0) -> Roofline:
    """``flops_per_chip`` is every operation, ``tc_flops_per_chip`` the
    part of them done on the tensor cores as TF32 (3xTF32) and
    ``bf16_flops_per_chip`` the part done on them at bf16."""
    fp32 = flops_per_chip - tc_flops_per_chip - bf16_flops_per_chip
    c = (fp32 / FP32_FLOPS + tc_flops_per_chip / TF32_FLOPS
         + bf16_flops_per_chip / BF16_FLOPS)
    m = bytes_per_chip / HBM_BW
    n = coll_bytes_per_chip / LINK_BW
    terms = {"compute": c, "memory": m, "collective": n}
    bottleneck = max(terms, key=terms.get)
    ratio = None
    if model_flops_global is not None and flops_per_chip > 0:
        ratio = model_flops_global / (flops_per_chip * chips)
    return Roofline(compute_s=c, memory_s=m, collective_s=n,
                    flops_per_chip=flops_per_chip,
                    bytes_per_chip=bytes_per_chip,
                    coll_bytes_per_chip=coll_bytes_per_chip,
                    bottleneck=bottleneck, model_flops=model_flops_global,
                    flops_ratio=ratio, tc_flops_per_chip=tc_flops_per_chip,
                    bf16_flops_per_chip=bf16_flops_per_chip)


def bound_s(nbytes: float, flops: float, tc_flops: float = 0.0,
            bf16_flops: float = 0.0) -> tuple:
    """One kernel's bound: the larger of its bytes over the memory rate
    and its operations over their rates (``flops`` at fp32's,
    ``tc_flops`` at the TF32 tensor cores', ``bf16_flops`` at their bf16
    rate; the kinds are all done, so their times add).  Returns (seconds,
    "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BW
    t_ops = (flops / FP32_FLOPS + tc_flops / TF32_FLOPS
             + bf16_flops / BF16_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def model_flops_per_round(arch, shape, fed=None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) per token pass,
    D = tokens processed: hardware-free, the JAX package's count.  A
    federated train step counts ``local_steps`` fwd+bwd passes over the
    global batch plus one meta pass over 64 sequences; prefill 2*N per
    token; decode 2*N per sequence."""
    n_active = arch.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        passes = (fed.local_steps if fed is not None else 2)
        meta = 1 if (fed is None or fed.meta) else 0
        meta_tokens = 64 * shape.seq_len * meta
        return 6.0 * n_active * (tokens * passes + meta_tokens)
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
