"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    sliding_window=8192,   # long_500k decode variant only; training is causal
    source="hf:HuggingFaceTB/SmolLM-135M (360M variant)",
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke",
    family="dense",
    num_layers=2,
    d_model=192,
    num_heads=3,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    sliding_window=64,
    source="reduced variant of hf:HuggingFaceTB/SmolLM-135M",
)
