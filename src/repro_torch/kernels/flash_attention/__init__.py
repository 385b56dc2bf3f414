"""CUDA flash-attention forward kernel of the serving prefill (causal or
windowed GQA online-softmax attention, and non-causal attention over an
encoder's keys), with its plain PyTorch version (``ref.py``); the
counterpart of ``repro/kernels/flash_attention``."""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
