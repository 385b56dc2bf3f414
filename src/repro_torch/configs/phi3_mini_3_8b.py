"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    # long_500k runs via an explicitly-configured sliding-window VARIANT
    # (window 8192); the base model is full-attention (see DESIGN.md §5).
    sliding_window=8192,
    source="arXiv:2404.14219",
)

SMOKE = ArchConfig(
    name="phi3-mini-3.8b-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    sliding_window=64,
    source="reduced variant of arXiv:2404.14219",
)
