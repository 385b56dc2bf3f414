"""whisper-large-v3 [audio] — encoder-decoder transformer backbone; the
mel-spectrogram + conv feature extractor frontend is a STUB (the caller
provides precomputed frame embeddings, ``enc_embeds``). [arXiv:2212.04356]

The assignment specifies the decoder backbone: 32L d_model=1280 20H
(kv=20) d_ff=5120 vocab=51866.  Whisper-large has a matching 32-layer
encoder over 1500 frames.
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    rope_theta=0.0,          # whisper uses learned absolute positions
    cross_every=2,           # decoder: cross-attention every other layer
    encoder=EncoderConfig(enc_layers=32, enc_len=1500, enc_dim=1280,
                          enc_heads=20, enc_ff=5120),
    source="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    name="whisper-large-v3-smoke",
    family="audio",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    rope_theta=0.0,
    cross_every=2,
    encoder=EncoderConfig(enc_layers=2, enc_len=64, enc_dim=256,
                          enc_heads=4, enc_ff=512),
    source="reduced variant of arXiv:2212.04356",
)
