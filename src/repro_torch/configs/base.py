"""Architecture and federated configuration dataclasses (PyTorch port).

Same fields and defaults as the JAX package's ``repro/configs/base.py``, so
one set of keyword arguments configures both.  The JAX ``FedConfig``
validates against its plugin registries; this one validates the values
the port runs and raises ``NotImplementedError`` naming the ROADMAP item
for every feature the port does not run yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds
# ---------------------------------------------------------------------------
ATTN = "attn"            # GQA self-attention
MAMBA = "mamba"          # Mamba2 SSD block
CROSS = "cross"          # cross-attention (VLM image layers / enc-dec)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_expert: Optional[int] = None
    every: int = 1
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25
    group_size: int = 4096


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_head: int = 64
    expand: int = 2
    chunk: int = 256
    d_conv: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    enc_layers: int
    enc_len: int
    enc_dim: int
    enc_heads: int = 16
    enc_ff: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                         # dense | moe | ssm | hybrid | ...
    num_layers: int
    d_model: int
    num_heads: int                      # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    attn_period: int = 1                # 1 => every layer is attention
    cross_every: int = 0                # >0: every k-th layer is cross-attn
    sliding_window: int = 0             # >0: sliding-window decode variant
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.num_layers):
            if self.cross_every and (i % self.cross_every
                                     == self.cross_every - 1):
                kinds.append(CROSS)
            elif self.attn_period > 1:
                kinds.append(ATTN if i % self.attn_period
                             == self.attn_period // 2 else MAMBA)
            elif self.family == "ssm":
                kinds.append(MAMBA)
            else:
                kinds.append(ATTN)
        return tuple(kinds)


# ---------------------------------------------------------------------------
# Federated configuration (the paper's knobs)
# ---------------------------------------------------------------------------
ALGORITHMS = ("fedavg", "fednova", "fedprox", "uga")
SERVER_OPTS = ("sgd", "sgdm", "adam", "yogi")
STRATEGIES = ("vmap", "scan")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Paper notation: B local batch, E local epochs, C client fraction.
    See ``repro/configs/base.py`` for what each field means."""
    algorithm: str = "uga"
    meta: bool = True
    share: bool = False
    cohort: int = 16
    local_steps: int = 2
    local_epochs: int = 1
    client_lr: float = 0.002
    server_lr: float = 0.002
    meta_lr: float = 0.002
    prox_mu: float = 2e-4
    server_opt: str = "sgd"
    server_momentum: float = 0.0
    cohort_strategy: str = "vmap"
    cohort_chunk: Optional[int] = None
    remat_local_steps: bool = True
    lr_decay: float = 1.0
    grad_agg_dtype: str = "float32"
    clip_norm: float = 0.0
    fused_update: bool = False
    meta_mode: str = "post"
    ctrl_lr: float = 0.01
    participation: float = 1.0
    engine: Optional[str] = None
    codec: str = "none"
    error_feedback: bool = False
    topk_ratio: float = 0.01
    async_buffer: int = 0
    async_capacity: int = 0
    async_max_staleness: int = 0
    staleness_mode: str = "invsqrt"
    fault_profile: str = "none"
    fault_drop: float = -1.0
    fault_crash: float = -1.0
    fault_delay: float = -1.0
    fault_max_delay: int = -1
    fault_garble: float = -1.0
    fault_garble_scale: float = -1.0
    fault_speed_tail: float = -1.0
    round_deadline: float = 0.0
    retry_backoff: int = 0
    retry_max: int = 3

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown client algorithm {self.algorithm!r}; "
                             f"registered: {ALGORITHMS}")
        if self.server_opt not in SERVER_OPTS:
            raise ValueError(f"unknown server_opt {self.server_opt!r}; "
                             f"expected one of {SERVER_OPTS}")
        if self.meta_mode not in ("post", "through_aggregation"):
            raise ValueError(f"unknown meta_mode {self.meta_mode!r}; "
                             "expected 'post' or 'through_aggregation'")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation={self.participation} must be "
                             "in (0, 1]")
        if self.local_steps < 1 or self.local_epochs < 1:
            raise ValueError(f"local_steps={self.local_steps} and "
                             f"local_epochs={self.local_epochs} must be >= 1")
        # What the port does not run yet: each names its ROADMAP item.
        unported = []
        if self.cohort_chunk is not None or self.cohort_strategy == "chunked":
            unported.append("cohort_chunk / the chunked executor "
                            "(ROADMAP Queue 1 item 1)")
        elif self.cohort_strategy not in STRATEGIES:
            raise ValueError(f"unknown cohort_strategy "
                             f"{self.cohort_strategy!r}; the port runs "
                             f"{STRATEGIES}")
        if self.engine == "legacy_tree" or (self.engine is None
                                            and not self.fused_update):
            unported.append("the legacy_tree engine; set fused_update=True "
                            "(ROADMAP Queue 1 item 1)")
        elif self.engine not in (None, "fused_flat", "buffered_async"):
            raise ValueError(f"unknown server engine {self.engine!r}")
        if self.meta and self.meta_mode == "through_aggregation":
            unported.append("meta_mode='through_aggregation' "
                            "(ROADMAP Queue 1 item 1)")
        if self.codec != "none" or self.error_feedback:
            unported.append(f"codec={self.codec!r} / error_feedback "
                            "(ROADMAP Queue 1 item 2)")
        if self.participation < 1.0:
            unported.append("participation < 1 (ROADMAP Queue 1 item 3)")
        faults = (self.fault_profile != "none" or self.round_deadline > 0
                  or self.retry_backoff > 0
                  or max(self.fault_drop, self.fault_crash, self.fault_delay,
                         self.fault_garble, self.fault_garble_scale,
                         self.fault_speed_tail, self.fault_max_delay) >= 0)
        if faults:
            unported.append("client fault injection and retries "
                            "(ROADMAP Queue 1 item 3)")
        if (self.engine == "buffered_async" or self.async_buffer
                or self.async_capacity or self.async_max_staleness):
            unported.append("the buffered_async runtime "
                            "(ROADMAP Queue 1 item 3)")
        if unported:
            raise NotImplementedError(
                "not yet ported to repro_torch: " + "; ".join(unported))
