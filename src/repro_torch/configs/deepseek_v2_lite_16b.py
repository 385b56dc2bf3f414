"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.
[arXiv:2405.04434]

Assignment line: "MoE 64e top-6 — MLA kv_lora=512, 2 shared+160 routed
top-6".  The "160 routed" clause matches full DeepSeek-V2, not -lite; we
follow the primary numbers given for this assignment: 64 routed experts,
top-6, 2 shared, per-expert FFN width 1408 (=d_ff).  First layer is dense
in the real model; for uniformity of the scanned stack we apply MoE on
every layer (noted deviation).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,         # MLA: kv heads == q heads post up-projection
    d_ff=1408,               # per-expert width
    vocab_size=102400,
    head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None, rope_head_dim=64),
    source="arXiv:2405.04434",
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=64,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_expert=128),
    mla=MLAConfig(kv_lora_rank=64, rope_head_dim=32),
    source="reduced variant of arXiv:2405.04434",
)
