"""Multi-device splitting: batch splitting (sharding.py) and row-band
strips of one stereo batch (spatial.py), the ports of the JAX package's
parallel/."""

from .sharding import make_mesh, shard_batch, ShardedPipeline
from .spatial import SpatialFsrPipeline, split_bands

__all__ = ["make_mesh", "shard_batch", "ShardedPipeline",
           "SpatialFsrPipeline", "split_bands"]
