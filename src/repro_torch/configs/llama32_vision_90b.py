"""llama-3.2-vision-90b [vlm] — cross-attn image layers; ViT vision encoder
+ projector is a STUB (the caller supplies patch embeddings, ``enc_embeds``).
[hf:meta-llama/Llama-3.2-11B-Vision, scaled to the 90B assignment numbers]
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_every=10,          # every 10th layer cross-attends to image tokens
    # Stub vision tower output: 1601 patch embeddings (1 tile) of width
    # d_model; enc_layers=0 => projector-only stub.
    encoder=EncoderConfig(enc_layers=0, enc_len=1601, enc_dim=8192),
    sliding_window=8192,     # long_500k variant only: self-attn layers
                             # windowed, cross-attn layers are constant-size
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B assignment numbers)",
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-90b-smoke",
    family="vlm",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    cross_every=2,
    encoder=EncoderConfig(enc_layers=0, enc_len=32, enc_dim=256),
    sliding_window=64,
    source="reduced variant of hf:meta-llama/Llama-3.2-11B-Vision",
)
