"""Checkpoints (PyTorch port of ``repro/checkpoint``): crash-safe blobs in
the JAX package's msgpack format, and the managed store."""
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save", "restore", "CheckpointManager"]
