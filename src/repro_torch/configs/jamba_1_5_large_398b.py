"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE.
[arXiv:2403.19887]

72 layers in 9 groups of 8 (1 attention : 7 mamba); MoE (16 experts, top-2)
replaces the dense MLP every other layer (Jamba e/2 spacing).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_period=8,           # 1 attn per 8 layers, rest mamba
    moe=MoEConfig(num_experts=16, top_k=2, every=2),
    ssm=SSMConfig(d_state=128, d_head=128, expand=2, chunk=256),
    source="arXiv:2403.19887",
)

SMOKE = ArchConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    num_layers=2,            # 1 mamba + 1 attn (attn_period=2)
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    attn_period=2,
    moe=MoEConfig(num_experts=4, top_k=2, every=2),
    ssm=SSMConfig(d_state=16, d_head=64, expand=2, chunk=32),
    source="reduced variant of arXiv:2403.19887",
)
