"""Scale-out over ``torch.distributed``: process groups, data parallelism,
sequence-parallel attention and H-sharded (spatial) serving with explicit
halo exchanges.  Counterpart of ``vst_tpu/parallel``;
``shard_batch_spatial`` (data × space training) comes with slice 7c."""

from vst_tpu_torch.parallel.mesh import (make_mesh, replicate, shard_batch,
                                         shard_spatial)
from vst_tpu_torch.parallel.attention import (
    sharded_cosine_attention_moments,
    sharded_softmax_attention_moments,
)
from vst_tpu_torch.parallel.spatial import (SpatialContext, exchange_rows,
                                            gather_rows, sharded_in_stats)

__all__ = ["SpatialContext", "exchange_rows", "gather_rows", "make_mesh",
           "replicate", "shard_batch", "shard_spatial",
           "sharded_cosine_attention_moments",
           "sharded_in_stats", "sharded_softmax_attention_moments"]
