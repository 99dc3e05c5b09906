"""NNStreamer-Edge analogue of the port: numpy-only clients that speak the
NNSE wire format and the port's broker protocol."""
from .edge import (ChecksumError, EdgeOutput, EdgeQueryClient, EdgeSensor,
                   pack_buffer, unpack_buffer)

__all__ = ["ChecksumError", "EdgeOutput", "EdgeQueryClient", "EdgeSensor",
           "pack_buffer", "unpack_buffer"]
