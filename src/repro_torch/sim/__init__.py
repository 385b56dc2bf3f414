"""Client-behavior simulation (PyTorch port of ``repro/sim``): the seeded
fault streams and the heavy-tail latency model of the participation and
fault policy, synchronous and buffered-async."""
from repro_torch.sim.faults import (FAULT_PROFILES, FaultConfig,
                                    FaultStreams, client_failed_mask,
                                    fault_streams, heavy_tail_speeds,
                                    resolve_faults)

__all__ = ["FAULT_PROFILES", "FaultConfig", "FaultStreams",
           "client_failed_mask", "fault_streams", "heavy_tail_speeds",
           "resolve_faults"]
