"""minicpm-2b [dense] — llama-like arch trained with the WSD
(warmup-stable-decay) schedule. [arXiv:2404.06395]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,     # MiniCPM ties embeddings
    sliding_window=8192,     # long_500k variant only (DESIGN.md §5)
    source="arXiv:2404.06395",
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke",
    family="dense",
    num_layers=2,
    d_model=144,
    num_heads=4,
    num_kv_heads=4,
    d_ff=288,
    vocab_size=512,
    tie_embeddings=True,
    sliding_window=64,
    source="reduced variant of arXiv:2404.06395",
)
