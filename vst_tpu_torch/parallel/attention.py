"""Sequence-parallel AdaAttN attention (cosine and softmax).

Counterpart of ``vst_tpu/parallel/attention.py``.  q, k and v arrive as
this rank's token shards (dim 1) of the mesh axis, and M1 = A·V and
M2 = A·V² go back token-sharded like q.

Cosine: the closed linear form of cos+1 row-normalized attention
(``models/adaattn.py``) depends on the keys and values only through the
moments Σk̂, K̂ᵀV, K̂ᵀV², ΣV, ΣV² and the key count m, so one all-reduce of
those (d·c-sized) moments, flattened into one bucket, replaces JAX's
psums; the queries never move.

Softmax runs as ring attention: each rank keeps its query shard and folds
one K/V block at a time into the result, then passes the block to the next
rank of the axis (``dist.batch_isend_irecv``), D − 1 times.  Each block
goes through K3 as it stands (``kernels/adaattn_attention.py::
softmax_attention_moments``, the plain version on the CPU), which returns
the block's normalized moments and its row logsumexp L; ``fold_block``
merges them by L in float32, the online softmax of JAX's loop.  The
(n, m) score matrix never exists beyond one block.

Both serve only: a call that needs a gradient raises (the ring's and the
all-reduce's backward are still to port).
"""

import torch
import torch.distributed as dist

from vst_tpu_torch.kernels import adaattn_attention
from vst_tpu_torch.models.adaattn import _cosine_moments, _unit_rows


def _no_grad_needed(what, *ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what} serves only: its backward is not ported (ROADMAP "
            "item 20.2)")


def sharded_cosine_attention_moments(mesh, q, k, v, axis: str = "data"):
    """q (b, n/D, d), k (b, m/D, d), v (b, m/D, c): this rank's token
    shards over ``axis``.  Returns (M1, M2) (b, n/D, c) float32, this
    rank's rows of the single-device linear form."""
    _no_grad_needed("sharded_cosine_attention_moments", q, k, v)
    kn = _unit_rows(k)
    vv = v * v
    moments = [kn.sum(dim=1).float(),
               torch.einsum("bmd,bmc->bdc", kn.float(), v.float()),
               torch.einsum("bmd,bmc->bdc", kn.float(), vv.float()),
               v.sum(dim=1).float(), vv.sum(dim=1).float()]
    flat = torch.cat([t.reshape(-1) for t in moments])
    dist.all_reduce(flat, group=mesh.groups[axis])
    ksum, kv, kv2, vsum, v2sum = (
        part.view_as(t) for part, t in
        zip(flat.split([t.numel() for t in moments]), moments))
    m = k.shape[1] * mesh.shape[axis]
    return _cosine_moments(q, ksum, kv, kv2, vsum, v2sum, m)


def fold_block(acc, m1_b, m2_b, lse_b):
    """Merge one key block's softmax moments into the running result.

    ``acc``: (M1, M2, L) in float32 of the blocks folded so far, or None;
    ``m1_b``, ``m2_b``: the block's moments normalized over its own keys
    (K3's M1, M2), ``lse_b``: its row logsumexp (b, n, 1).  With
    L' = logaddexp(L, L_b), M' = M·exp(L − L') + M_b·exp(L_b − L').
    Returns the new (M1, M2, L)."""
    m1_b, m2_b, lse_b = m1_b.float(), m2_b.float(), lse_b.float()
    if acc is None:
        return m1_b, m2_b, lse_b
    m1, m2, lse = acc
    new = torch.logaddexp(lse, lse_b)
    a, b = torch.exp(lse - new), torch.exp(lse_b - new)
    return m1 * a + m1_b * b, m2 * a + m2_b * b, new


def sharded_softmax_attention_moments(mesh, q, k, v, axis: str = "data"):
    """Ring attention: M1 = softmax(QKᵀ)V, M2 = softmax(QKᵀ)V².

    q (b, n/D, d), k (b, m/D, d), v (b, m/D, c): this rank's token shards
    over ``axis``.  Returns (M1, M2) (b, n/D, c) in q.dtype, accumulated
    in float32.  Softmax is permutation-invariant over keys, so the order
    in which the blocks arrive does not matter."""
    _no_grad_needed("sharded_softmax_attention_moments", q, k, v)
    n_dev = mesh.shape[axis]
    ranks, i = mesh.ranks[axis], mesh.index[axis]
    nxt, prv = ranks[(i + 1) % n_dev], ranks[(i - 1) % n_dev]
    group = mesh.groups[axis]
    kb, vb = k.contiguous(), v.contiguous()
    acc = None
    for hop in range(n_dev):
        if hop != n_dev - 1:
            k_in, v_in = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, nxt, group),
                dist.P2POp(dist.isend, vb, nxt, group),
                dist.P2POp(dist.irecv, k_in, prv, group),
                dist.P2POp(dist.irecv, v_in, prv, group)])
        acc = fold_block(
            acc, *adaattn_attention.softmax_attention_moments(q, kb, vb))
        if hop != n_dev - 1:
            for r in reqs:
                r.wait()
            kb, vb = k_in, v_in
    m1, m2, _ = acc
    return m1.to(q.dtype), m2.to(q.dtype)
