"""Multi-chip parallelism: device meshes, carrier sharding, and halo
exchange for the sharded sample stream (SURVEY §2.6/§5.7 mappings).

The reference scales with threads/processes + sockets (ZMQ per-carrier
I/Q, sf_worker pipelines); here the same axes become `jax.sharding` mesh
axes with XLA collectives between devices:

  carriers axis   <- one cc_worker thread per carrier
  samples axis    <- the ue_sync streaming loop's overlap-save state
                     (ppermute halo exchange replaces carried buffers)
"""

from .mesh import carrier_mesh, shard_carriers
from .halo import sharded_fir, sharded_resample_fft, stream_halo_exchange

__all__ = [
    "carrier_mesh",
    "shard_carriers",
    "sharded_fir",
    "sharded_resample_fft",
    "stream_halo_exchange",
]
