"""PyTorch port of the federated UGA + FedMeta trainer, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; module paths here mirror its
paths one to one.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`."""
