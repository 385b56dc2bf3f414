"""CUDA kernel of the Mamba2 SSD chunked scan (the serving prefill of the
SSM family and of jamba's mamba layers), with its plain PyTorch versions (``ref.py``); the
counterpart of ``repro/kernels/ssd_scan``.  The kernel's wrapper takes the
model's (B, S, H, P) layout and B, C by group, so it is the entry point
itself: there is no ``ops`` layer to fold heads."""
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd

__all__ = ["ssd_scan_fwd"]
