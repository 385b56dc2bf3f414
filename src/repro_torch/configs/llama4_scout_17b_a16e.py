"""llama4-scout-17b-a16e [moe] — 16-expert top-1 MoE with shared expert,
early-fusion multimodal (text path only here; fusion embeds are data).
Scout natively uses chunked attention (iRoPE), so the sliding-window
long-context variant is faithful. [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, num_shared=1, every=1),
    sliding_window=8192,     # native chunked-attention analogue
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ArchConfig(
    name="llama4-scout-17b-a16e-smoke",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=1, num_shared=1),
    sliding_window=64,
    source="reduced variant of hf:meta-llama/Llama-4-Scout-17B-16E",
)
