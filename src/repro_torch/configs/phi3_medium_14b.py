"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    sliding_window=8192,   # long_500k variant only (DESIGN.md §5)
    source="arXiv:2404.14219",
)

SMOKE = ArchConfig(
    name="phi3-medium-14b-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    sliding_window=64,
    source="reduced variant of arXiv:2404.14219",
)
