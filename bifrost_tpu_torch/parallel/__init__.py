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
- the distributed FFT and the frequency-sharded channelizer
- frame-local mesh plans and the ring-resident layouts
  (:class:`~.scope.ShardedTensor`) that chained mesh blocks and the
  sharded H2D exchange
"""

from .mesh import Mesh, create_mesh, mesh_axes, local_mesh
from .ops import (sharded_spectrometer, sharded_beamform,
                  sharded_correlate, sharded_fdmt, sharded_fir,
                  spectrometer_step, PartitionSpec, shard, unshard,
                  shard_map, psum, ppermute, all_gather, all_to_all,
                  axis_index, collectives)
from .fft import (sharded_fft, distributed_fft_local,
                  freq_sharded_dft, freq_chunk_dft_local)
from .corner_turn import corner_turn, corner_turn_local
from .scope import (time_axis_name, station_axis_name, time_axis_size,
                    time_sharding, replicated_sharding, shardable_nframe,
                    shard_gulp, sharding_descriptor, descriptor_matches,
                    frame_local_plan, mesh_h2d_enabled,
                    hlo_stats_enabled, collective_counts, gather_local,
                    NamedSharding, ShardedTensor)

__all__ = ['Mesh', 'create_mesh', 'mesh_axes', 'local_mesh',
           'sharded_spectrometer', 'sharded_beamform', 'sharded_correlate',
           'sharded_fdmt', 'sharded_fir', 'spectrometer_step',
           'PartitionSpec', 'shard', 'unshard', 'shard_map', 'psum',
           'ppermute', 'all_gather', 'all_to_all', 'axis_index',
           'collectives', 'sharded_fft', 'distributed_fft_local',
           'freq_sharded_dft', 'freq_chunk_dft_local', 'corner_turn',
           'corner_turn_local', 'time_axis_name', 'station_axis_name',
           'time_axis_size', 'time_sharding', 'replicated_sharding',
           'shardable_nframe', 'shard_gulp', 'sharding_descriptor',
           'descriptor_matches', 'frame_local_plan', 'mesh_h2d_enabled',
           'hlo_stats_enabled', 'collective_counts', 'gather_local',
           'NamedSharding', 'ShardedTensor']
