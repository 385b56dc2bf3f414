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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer blocks; the
        final norm's ``d_model`` scales are not counted, as in JAX)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d                                    # token embedding
        if not self.tie_embeddings:
            total += v * d                               # lm head
        for i, kind in enumerate(self.layer_kinds()):
            total += 2 * d                               # 2 RMSNorm scales
            if kind == MAMBA:
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                heads = d_in // s.d_head
                # in_proj -> [z, x, B, C, dt]; B/C are per-group
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + heads)
                total += (d_in + 2 * s.n_groups * s.d_state) * s.d_conv
                total += 2 * heads                       # A, D per head
                total += d_in * d                        # out_proj
            elif kind in (ATTN, CROSS):
                if self.mla is not None:
                    m = self.mla
                    q_dim = self.num_heads * (hd + m.rope_head_dim)
                    total += d * (m.kv_lora_rank + m.rope_head_dim)  # kv down
                    total += m.kv_lora_rank * self.num_heads * 2 * hd  # kv up
                    total += d * q_dim                               # q proj
                    total += self.num_heads * hd * d                 # o proj
                else:
                    total += d * self.num_heads * hd                 # q
                    total += 2 * d * self.num_kv_heads * hd          # k, v
                    total += self.num_heads * hd * d                 # o
            total += self._mlp_params(i)
        if self.encoder is not None:
            e = self.encoder
            eff = e.enc_ff or 4 * e.enc_dim
            per = (4 * e.enc_dim * e.enc_dim + 3 * e.enc_dim * eff
                   + 2 * e.enc_dim)
            total += e.enc_layers * per
        return total

    def _mlp_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.moe is not None and (layer_idx % self.moe.every
                                     == self.moe.every - 1):
            m = self.moe
            de = m.d_expert or self.d_ff
            routed = m.num_experts * 3 * d * de          # swiglu experts
            shared = m.num_shared * 3 * d * de
            router = d * m.num_experts
            return routed + shared + router
        if self.d_ff == 0:
            return 0                                     # attn-free pure SSM
        return 3 * d * self.d_ff                         # swiglu dense

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        de = m.d_expert or self.d_ff
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if i % m.every == m.every - 1)
        inactive = (n_moe_layers * (m.num_experts - m.top_k) * 3
                    * self.d_model * de)
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Federated configuration (the paper's knobs)
# ---------------------------------------------------------------------------
ALGORITHMS = ("fedavg", "fednova", "fedprox", "uga")
SERVER_OPTS = ("sgd", "sgdm", "adam", "yogi")
STRATEGIES = ("vmap", "scan", "chunked")


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
        if self.cohort_strategy not in STRATEGIES:
            raise ValueError(
                f"unknown cohort_strategy {self.cohort_strategy!r}; "
                f"registered base cohort executors: {STRATEGIES} (the "
                "'sharded' executor is selected by passing a mesh to "
                "make_federated_round, not here)")
        if self.cohort_chunk is not None:
            if self.cohort_chunk < 1:
                raise ValueError(
                    f"cohort_chunk={self.cohort_chunk} must be >= 1: it is "
                    "the number of clients the chunked executor vmaps per "
                    "streaming slice (a ragged final chunk is padded with "
                    "zero-weight clients, never truncated)")
            if self.cohort_strategy == "scan":
                raise ValueError(
                    f"cohort_chunk={self.cohort_chunk} together with "
                    "cohort_strategy='scan' is ambiguous: scan IS the "
                    "chunked streaming core pinned at chunk=1 (one client "
                    "alive at a time). Drop cohort_chunk to keep scan, or "
                    "drop cohort_strategy='scan' (keep the default 'vmap' "
                    "or set 'chunked') so cohort_chunk selects the slice "
                    "size.")
        elif self.cohort_strategy == "chunked":
            raise ValueError(
                "cohort_strategy='chunked' needs cohort_chunk set: the "
                "chunked executor streams the cohort in cohort_chunk-client "
                "slices. Set e.g. cohort_chunk=8, or use cohort_strategy="
                "'vmap' / 'scan'.")
        # What the port does not run yet: each names its ROADMAP item.
        unported = []
        if self.engine == "legacy_tree" or (self.engine is None
                                            and not self.fused_update):
            unported.append("the legacy_tree engine; set fused_update=True "
                            "(ROADMAP Queue 1 item 9)")
        elif self.engine not in (None, "fused_flat", "buffered_async"):
            raise ValueError(f"unknown server engine {self.engine!r}")
        # the fault-injection knobs: resolve_faults validates the rates
        # and shapes (raises naming the bad field), as in the JAX package
        from repro_torch.sim.faults import resolve_faults
        resolve_faults(self)
        if self.staleness_mode not in ("none", "inv", "invsqrt"):
            raise ValueError(
                f"unknown staleness_mode {self.staleness_mode!r}; expected "
                "'none', 'inv' or 'invsqrt'")
        if (self.async_buffer < 0 or self.async_capacity < 0
                or self.async_max_staleness < 0):
            raise ValueError(
                f"async_buffer={self.async_buffer} / async_capacity="
                f"{self.async_capacity} / async_max_staleness="
                f"{self.async_max_staleness} must be >= 0")
        if self.retry_backoff < 0 or self.retry_max < 0:
            raise ValueError(
                f"retry_backoff={self.retry_backoff} / retry_max="
                f"{self.retry_max} must be >= 0")
        if self.engine == "buffered_async":
            k = self.async_buffer or self.cohort
            cap = self.async_capacity or 2 * self.cohort
            if k > cap:
                raise ValueError(
                    f"async_buffer={k} exceeds async_capacity={cap}: the "
                    "pool can never hold K deltas, so the server would "
                    "never step (deadlock). Raise async_capacity or lower "
                    "async_buffer.")
            if self.round_deadline > 0:
                raise ValueError(
                    "round_deadline is a synchronous-barrier timeout; the "
                    "buffered_async runtime has no barrier to time out — "
                    "bound lateness with async_max_staleness instead")
        if unported:
            raise NotImplementedError(
                "not yet ported to repro_torch: " + "; ".join(unported))
        if self.meta_mode == "through_aggregation":
            # The mode is a capability the server engine declares; the
            # round re-checks it against the resolved engine.
            from repro_torch.core.engines import get_engine
            eng = get_engine(self.engine or "fused_flat")
            if "through_aggregation" not in eng.meta_capabilities:
                raise ValueError(
                    f"meta_mode='through_aggregation' needs a server engine "
                    f"declaring the capability, but {eng.name!r} declares "
                    f"{sorted(eng.meta_capabilities)}; set "
                    "fused_update=True (the fused_flat engine) or use "
                    "meta_mode='post'")
            if not self.server_lr > 0:
                raise ValueError(
                    "meta_mode='through_aggregation' seeds the controllable "
                    "step size as exp(log_lr) = server_lr; server_lr must "
                    "be > 0")
        # the communication-compression knobs (repro_torch.comm), checked
        # against the codec registry as the JAX package checks them
        from repro_torch.comm.codecs import get_codec
        if not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(
                f"topk_ratio={self.topk_ratio} must be in (0, 1]: it is "
                "the fraction of elements the 'topk' codec transmits")
        codec = get_codec(self.codec)(self)    # raises naming the registry
        if self.error_feedback and not codec.lossy:
            raise ValueError(
                f"error_feedback=True with codec={self.codec!r} has no "
                "compression residual to feed back; pick a lossy codec "
                "(e.g. 'int8', 'sign1bit', 'topk') or drop error_feedback")
        if codec.lossy:
            if self.meta and self.meta_mode == "through_aggregation":
                raise ValueError(
                    f"codec={self.codec!r} cannot combine with meta_mode="
                    "'through_aggregation': the hypergradient would "
                    "differentiate through a non-differentiable quantizer. "
                    "Lossy codecs are meta_mode='post' only.")
            from repro_torch.core.engines import get_engine
            eng = get_engine(self.engine or "fused_flat")
            if "lossy" not in eng.codec_capabilities:
                raise ValueError(
                    f"codec={self.codec!r} needs a server engine declaring "
                    f"the 'lossy' codec capability, but {eng.name!r} "
                    f"declares {sorted(eng.codec_capabilities)}: lossy "
                    "codecs decode into flat dtype-group buffers. Set "
                    "fused_update=True (the fused_flat engine) or use "
                    "codec='none'.")
