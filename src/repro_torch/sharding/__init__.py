"""Process meshes over ``torch.distributed`` and what the port splits over
them (PyTorch port of the parts of ``repro/sharding/`` with a torch
meaning)."""
from repro_torch.sharding.specs import (Mesh, axis_size, batch_axes,
                                        cohort_split, flat_group_pspecs)

__all__ = ["Mesh", "axis_size", "batch_axes", "cohort_split",
           "flat_group_pspecs"]
