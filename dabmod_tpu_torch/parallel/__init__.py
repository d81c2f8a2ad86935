"""Multi-process modulation: the TF axis sharded over torch.distributed
ranks (parallel/sharding.py) and a launcher of ranks (parallel/launch.py)."""
from .sharding import (EXCHANGES, ShardedModulator, TfMesh, captures,
                       exchange_tails, init_distributed, make_host_chip_mesh,
                       make_mesh, make_sharded_time_interleave,
                       shard_resampler_backend)

__all__ = ["EXCHANGES", "ShardedModulator", "TfMesh", "captures",
           "exchange_tails", "init_distributed", "make_host_chip_mesh",
           "make_mesh", "make_sharded_time_interleave",
           "shard_resampler_backend"]
