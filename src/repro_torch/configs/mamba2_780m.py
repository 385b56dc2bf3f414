"""mamba2-780m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,                  # mamba block replaces the MLP entirely
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_head=64, expand=2, chunk=256),
    source="arXiv:2405.21060",
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    num_layers=2,
    d_model=256,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=16, d_head=64, expand=2, chunk=32),
    source="reduced variant of arXiv:2405.21060",
)
