"""Scale-out over ``torch.distributed``: process groups, data parallelism,
sequence-parallel attention (serving only), and H-sharded (spatial)
serving and data × space training with explicit halo exchanges and their
backward passes.  Counterpart of ``vst_tpu/parallel``."""

from vst_tpu_torch.parallel.mesh import (make_mesh, replicate, shard_batch,
                                         shard_batch_spatial, shard_spatial)
from vst_tpu_torch.parallel.attention import (
    sharded_cosine_attention_moments,
    sharded_softmax_attention_moments,
)
from vst_tpu_torch.parallel.spatial import (SpatialContext, exchange_rows,
                                            gather_rows, sharded_in_stats)

__all__ = ["SpatialContext", "exchange_rows", "gather_rows", "make_mesh",
           "replicate", "shard_batch", "shard_batch_spatial",
           "shard_spatial",
           "sharded_cosine_attention_moments",
           "sharded_in_stats", "sharded_softmax_attention_moments"]
