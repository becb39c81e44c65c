"""Scale-out over ``torch.distributed``: process groups, data parallelism
and sequence-parallel attention.  Counterpart of ``vst_tpu/parallel``;
the spatial placements (``shard_spatial``, ``shard_batch_spatial``) come
with the spatial slice."""

from vst_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from vst_tpu_torch.parallel.attention import (
    sharded_cosine_attention_moments,
    sharded_softmax_attention_moments,
)

__all__ = ["make_mesh", "replicate", "shard_batch",
           "sharded_cosine_attention_moments",
           "sharded_softmax_attention_moments"]
