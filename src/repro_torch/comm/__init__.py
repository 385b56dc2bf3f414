"""Communication-compression subsystem (PyTorch port of ``repro/comm``):
the GradientCodec registry (``none`` / ``int8`` / ``sign1bit`` / ``topk``
+ ``register_codec``), the per-client error-feedback state and the uplink
byte accounting, and the buffered-async runtime's per-client decode
(``coded_decode_stacked``)."""
from repro_torch.comm.codecs import (GradientCodec, available_codecs,
                                     get_codec, register_codec,
                                     resolve_codec)
from repro_torch.comm.transport import (client_coded_accumulate,
                                        client_coded_decode,
                                        coded_aggregate_stacked,
                                        coded_decode_stacked,
                                        comm_bytes_per_client,
                                        init_comm_state)

__all__ = ["GradientCodec", "register_codec", "get_codec",
           "available_codecs", "resolve_codec", "init_comm_state",
           "comm_bytes_per_client", "client_coded_accumulate",
           "coded_aggregate_stacked", "client_coded_decode",
           "coded_decode_stacked"]
