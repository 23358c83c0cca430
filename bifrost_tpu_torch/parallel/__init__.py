"""Scale-out over a device mesh (the port of ``bifrost_tpu/parallel``).

The reference scales out with per-block `gpu=N` device placement plus
UDP/RDMA point-to-point streams between nodes (reference: SURVEY.md
§2.9; src/rdma.cpp).  Here the heavy ops of a block are sharded over a
mesh of ranks with collectives between them, so one logical block spans
several ranks, on one card or on several.  This package provides:

- mesh construction + scope integration (``BlockScope(mesh=...)``)
- sharded versions of the hot ops (spectrometer, beamform, correlate,
  FIR with halo exchange, FDMT with halo exchange)
- the correlator's corner turn (all_to_all, or D-1 ring hops of K9)

Left out until a later slice: ``parallel/fft.py`` (``sharded_fft``,
``distributed_fft_local``, ``freq_sharded_dft``), the GSPMD plans and
sharding descriptors of ``scope.py``.
"""

from .mesh import Mesh, create_mesh, mesh_axes, local_mesh
from .ops import (sharded_spectrometer, sharded_beamform,
                  sharded_correlate, sharded_fdmt, sharded_fir,
                  spectrometer_step, PartitionSpec, shard, unshard,
                  shard_map, psum, ppermute, all_gather, all_to_all,
                  axis_index, collectives)
from .corner_turn import corner_turn, corner_turn_local
from .scope import (time_axis_name, station_axis_name, time_axis_size,
                    shardable_nframe, shard_gulp, gather_local)

__all__ = ['Mesh', 'create_mesh', 'mesh_axes', 'local_mesh',
           'sharded_spectrometer', 'sharded_beamform', 'sharded_correlate',
           'sharded_fdmt', 'sharded_fir', 'spectrometer_step',
           'PartitionSpec', 'shard', 'unshard', 'shard_map', 'psum',
           'ppermute', 'all_gather', 'all_to_all', 'axis_index',
           'collectives', 'corner_turn', 'corner_turn_local',
           'time_axis_name', 'station_axis_name', 'time_axis_size',
           'shardable_nframe', 'shard_gulp', 'gather_local']
