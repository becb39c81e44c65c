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

Gradients.  Both functions differentiate, as ``jax.grad`` of JAX's
``shard_map`` does.  Each rank's cotangent is that of its own output rows,
and its gradients are its rows of the gradient of Σ over ranks
⟨M_r, dM_r⟩ (the convention of ``parallel/spatial.py::all_reduce_sum``):
- cosine: the all-reduce of the moment bucket is an autograd Function
  whose backward all-reduces the moments' gradients over the axis; the
  rest is plain torch ops;
- softmax: the ring's backward runs the ring again.  With the global L of
  the forward's last fold and the row term D = Σ_c(dM1∘M1 + dM2∘M2) of the
  final moments (``row_term``), A = exp(S − L) makes each key block's
  share of dQ, and each query shard's share of dK and dV, add up exactly
  (the algebra of ``_bwd_plain`` split over blocks and shards):
  ``block_grads`` runs K4 (dQ) and K5 (dK, dV) on one (query shard, key
  block) pair.  At each hop a rank adds the visiting block's dQ share
  into its float32 dQ and the block's dK and dV shares into float32
  accumulators that travel with the block: (k, v, dk, dv) move one rank
  on per hop, and after the D-th hop one more send of (dk, dv) brings each
  block's gradient home to its owner (D sends of the accumulators, D − 1
  of k and v).  The forward saves this rank's q, its own k and v, M1 and
  M2 (in q's dtype) and the float32 L, not the visiting blocks: k and v
  are sent round again, so the saved state stays 1/D of the unsharded
  one.  dQ and dK come back in q's dtype, dV in v's.  At world 1 both are
  bit for bit the single-device route's gradients.

``scatter_tokens`` and ``gather_tokens`` are the adjoint pair that
``models/adaattn.py::attention_moments(mesh=)`` puts around them for full,
replicated q, k, v: this rank's rows (backward: the shards' gradients
all-gathered) and the all-gather of M1, M2 (backward: this rank's rows of
the replicated cotangent).  Every rank computes the same loss from the
gathered moments, so every rank gets the single-device gradient.
"""

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from vst_tpu_torch.kernels import adaattn_attention
from vst_tpu_torch.models.adaattn import (_cosine_key_moments,
                                          _cosine_moments, wide_dtype)


def _all_reduce_flat(group, ts):
    """``ts`` summed over ``group`` in one flattened all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    return tuple(part.view_as(t) for part, t in
                 zip(flat.split([t.numel() for t in ts]), ts))


class _AllReduceMoments(torch.autograd.Function):
    """The key moments summed over the axis; the backward all-reduces
    their gradients (every rank's share of the loss reads the sums)."""

    @staticmethod
    def forward(ctx, group, *moments):
        ctx.group = group
        return _all_reduce_flat(group, moments)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, *_all_reduce_flat(ctx.group, grads))


def sharded_cosine_attention_moments(mesh, q, k, v, axis: str = "data"):
    """q (b, n/D, d), k (b, m/D, d), v (b, m/D, c): this rank's token
    shards over ``axis``.  Returns (M1, M2) (b, n/D, c) float32, this
    rank's rows of the single-device linear form; differentiable (module
    docstring)."""
    moments = _AllReduceMoments.apply(mesh.groups[axis],
                                      *_cosine_key_moments(k, v))
    m = k.shape[1] * mesh.shape[axis]
    return _cosine_moments(q, *moments, m)


def fold_block(acc, m1_b, m2_b, lse_b):
    """Merge one key block's softmax moments into the running result.

    ``acc``: (M1, M2, L) in float32 of the blocks folded so far, or None;
    ``m1_b``, ``m2_b``: the block's moments normalized over its own keys
    (K3's M1, M2), ``lse_b``: its row logsumexp (b, n, 1).  With
    L' = logaddexp(L, L_b), M' = M·exp(L − L') + M_b·exp(L_b − L').
    Returns the new (M1, M2, L), in float64 for float64 moments."""
    acc_t = wide_dtype(m1_b.dtype)
    m1_b, m2_b, lse_b = m1_b.to(acc_t), m2_b.to(acc_t), lse_b.to(acc_t)
    if acc is None:
        return m1_b, m2_b, lse_b
    m1, m2, lse = acc
    new = torch.logaddexp(lse, lse_b)
    a, b = torch.exp(lse - new), torch.exp(lse_b - new)
    return m1 * a + m1_b * b, m2 * a + m2_b * b, new


def block_grads(q, kb, vb, lse, dd, dm1, dm2):
    """The backward of one (query shard, key block) pair, the counterpart
    of ``fold_block``: K4's dQ share (``softmax_attention_dq``) and K5's
    dK, dV shares (``softmax_attention_dkv``).  ``lse`` is the global row logsumexp (b, n, 1) float32 of the queries
    over all keys, ``dd`` the row term D of the final moments, ``dm1``,
    ``dm2`` the cotangents in q's dtype, all contiguous.  Summed over the
    key blocks the dQ shares are dQ; summed over the query shards the dK,
    dV shares are dK, dV.  CUDA tensors launch the kernels (or raise), CPU
    tensors take their plain versions."""
    dq = adaattn_attention.softmax_attention_dq(q, kb, vb, lse, dd, dm1, dm2)
    dk, dv = adaattn_attention.softmax_attention_dkv(q, kb, vb, lse, dd, dm1,
                                                     dm2)
    return dq, dk, dv


class _Ring:
    """This rank's neighbours on ``axis``: blocks go to the next rank and
    come from the previous one."""

    def __init__(self, mesh, axis):
        self.size = mesh.shape[axis]
        ranks, i = mesh.ranks[axis], mesh.index[axis]
        self.nxt, self.prv = ranks[(i + 1) % self.size], ranks[(i - 1)
                                                                % self.size]
        self.group = mesh.groups[axis]

    def shift(self, ts):
        """Start sending ``ts`` to the next rank and receiving their likes
        from the previous one; returns (the receive buffers, requests)."""
        out = [torch.empty_like(t) for t in ts]
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, self.nxt, self.group) for t in ts]
            + [dist.P2POp(dist.irecv, o, self.prv, self.group) for o in out])
        return out, reqs


def _wait(reqs):
    for r in reqs:
        r.wait()


def _ring_forward(ring, q, k, v):
    """(M1, M2, L) in float32 of q against every rank's k, v."""
    kb, vb = k.contiguous(), v.contiguous()
    acc = None
    for hop in range(ring.size):
        if hop != ring.size - 1:
            (k_in, v_in), reqs = ring.shift((kb, vb))
        acc = fold_block(
            acc, *adaattn_attention.softmax_attention_moments(q, kb, vb))
        if hop != ring.size - 1:
            _wait(reqs)
            kb, vb = k_in, v_in
    return acc


def _ring_backward(ring, q, k, v, lse, dd, dm1, dm2):
    """(dQ, dK, dV) in float32, float64 for float64 q: the ring run
    again, the blocks' dK, dV accumulators travelling with them and sent
    home after the last hop (module docstring)."""
    kb, vb = k.contiguous(), v.contiguous()
    acc = wide_dtype(q.dtype)
    dq = dk = dv = None
    for hop in range(ring.size):
        if hop != ring.size - 1:
            (k_in, v_in), reqs = ring.shift((kb, vb))
        pq, pk, pv = block_grads(q, kb, vb, lse, dd, dm1, dm2)
        dq = pq.to(acc) if dq is None else dq + pq.to(acc)
        dk = pk.to(acc) if dk is None else dk + pk.to(acc)
        dv = pv.to(acc) if dv is None else dv + pv.to(acc)
        if ring.size > 1:
            (dk, dv), acc_reqs = ring.shift((dk, dv))
            _wait(acc_reqs)
        if hop != ring.size - 1:
            _wait(reqs)
            kb, vb = k_in, v_in
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring's forward (K3 at every hop) and backward (K4 and K5 at
    every hop); saves q, this rank's k and v, M1, M2 and L."""

    @staticmethod
    def forward(ctx, mesh, axis, q, k, v):
        ctx.ring = _Ring(mesh, axis)
        m1, m2, lse = _ring_forward(ctx.ring, q, k, v)
        m1, m2 = m1.to(q.dtype), m2.to(q.dtype)
        ctx.save_for_backward(q, k, v, m1, m2, lse)
        return m1, m2

    @staticmethod
    @once_differentiable
    def backward(ctx, dm1, dm2):
        q, k, v, m1, m2, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[2:]
        dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
        dq, dk, dv = _ring_backward(
            ctx.ring, q, k, v, lse, dd, dm1.to(q.dtype).contiguous(),
            dm2.to(q.dtype).contiguous())
        return (None, None, dq.to(q.dtype) if need_q else None,
                dk.to(q.dtype) if need_k else None,
                dv.to(v.dtype) if need_v else None)


def sharded_softmax_attention_moments(mesh, q, k, v, axis: str = "data"):
    """Ring attention: M1 = softmax(QKᵀ)V, M2 = softmax(QKᵀ)V².

    q (b, n/D, d), k (b, m/D, d), v (b, m/D, c): this rank's token shards
    over ``axis``.  Returns (M1, M2) (b, n/D, c) in q.dtype, accumulated
    in float32; differentiable in q, k and v (module docstring).  Softmax
    is permutation-invariant over keys, so the order in which the blocks
    arrive does not matter."""
    return _RingAttention.apply(mesh, axis, q, k, v)


# ------------------------------------------------- full, replicated tensors

def _token_rows(mesh, axis, x):
    s = x.shape[1] // mesh.shape[axis]
    i = mesh.index[axis]
    return x[:, i * s:(i + 1) * s]


def _all_gather_tokens(mesh, axis, x):
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts, dim=1)


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return _token_rows(mesh, axis, x).contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, None, _all_gather_tokens(ctx.mesh, ctx.axis, g)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, x):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_gather_tokens(mesh, axis, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return None, None, _token_rows(ctx.mesh, ctx.axis, g)


def scatter_tokens(mesh, axis, x):
    """This rank's token shard (dim 1, contiguous) of a replicated ``x``;
    its backward all-gathers the shards' gradients into the full one."""
    return _ScatterTokens.apply(mesh, axis, x)


def gather_tokens(mesh, axis, x):
    """The token shards of every rank all-gathered along dim 1; its
    backward takes this rank's rows of the (replicated) cotangent."""
    return _GatherTokens.apply(mesh, axis, x)
