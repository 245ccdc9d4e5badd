"""Distribution layer: logical-axis sharding on ``torch.distributed`` device
meshes, and the gradient compression wire format."""
from repro_torch.parallel.compress import dequantize_int8, quantize_int8
from repro_torch.parallel.sharding import (NamedSharding, ShardCtx,
                                           batch_sharding, place_tree,
                                           sanitize_sharding, sanitize_tree,
                                           shard, tree_shardings)

__all__ = ["dequantize_int8", "quantize_int8", "NamedSharding", "ShardCtx",
           "batch_sharding", "place_tree", "sanitize_sharding",
           "sanitize_tree", "shard", "tree_shardings"]
