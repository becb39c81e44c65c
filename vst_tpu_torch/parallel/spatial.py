"""Spatial (H-sharded) serving and training: the halo exchanges that
XLA's SPMD partitioner inserts for the JAX package, written out over
``torch.distributed``, with their backward passes.

Every rank holds a contiguous block of R rows (dim 1) of each NHWC
activation, rank i of the axis the rows i·R … (i+1)·R − 1
(``mesh.shard_spatial``, ``mesh.shard_batch_spatial``).  A layer that
reads rows beyond its block gets them from its neighbours on the axis
(``exchange_rows``: one ``dist.batch_isend_irecv`` of the edge rows, the
P2P pattern of ``parallel/attention.py``'s ring); at a global edge the
rows are made locally as the unsharded layer pads (reflect, zero or
clamp).  K1's instance norms all-reduce their per-image Σy and Σy² and
divide by the global H·W (``sharded_in_stats``, K1's one-pass
arithmetic); the others (``ops/norm.py``) all-reduce Σx, then
Σ(x − mean)², the two passes of the unsharded norm.  What each layer kind
needs is in ``ops/conv.py``, ``ops/norm.py``, ``ops/resize.py`` and
``ops/features.py``, which take a ``SpatialContext`` as ``spatial=``;
with ``spatial=None`` they run the unsharded code.

Gradients.  Each rank differentiates its share of the loss, the shares
summing to the loss over the axis, and every collective here carries its
adjoint: ``exchange_rows``'s backward sends the halo rows' gradients back
to the rank they came from (one ``batch_isend_irecv``, the forward's
pattern reversed) and folds the rows and columns made at an edge back
into their sources (reflected and clamped ones added, zero ones dropped);
``all_reduce_sum``'s backward all-reduces the incoming gradient (so
``sharded_in_stats`` and the two-pass norms differentiate through it);
``gather_rows``'s backward reduce-scatters it.  The sequence-parallel
attention (``parallel/attention.py``) still serves only.

``exchange_rows`` runs inside the profiler range "vst::exchange_rows", and
its backward inside "vst::exchange_rows_bwd", as ``ops/pad.py``'s
reflection pad does in "vst::reflection_pad2d", so a trace gives the
padded copies' device time (``chip_smoke.py``'s spatial part reads it).
"""

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable
from torch.profiler import record_function

EDGES = ("reflect", "zero", "clamp")


class SpatialContext:
    """This rank's place on the mesh axis that shards H: ``mesh``,
    ``axis``, ``index`` (its block's position), ``size`` (the number of
    blocks), and the axis's process group and global ranks."""

    def __init__(self, mesh, axis: str = "space"):
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
        self.mesh = mesh
        self.axis = axis
        self.index = mesh.index[axis]
        self.size = mesh.shape[axis]
        self.group = mesh.groups[axis]
        self.ranks = mesh.ranks[axis]

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def __repr__(self):
        return (f"SpatialContext(axis={self.axis!r}, index={self.index}, "
                f"size={self.size})")


def check_rows(ctx: SpatialContext, rows: int, multiple: int, what: str):
    """Raise ``ValueError`` unless this block's ``rows`` divide by
    ``multiple``: H must divide by ``multiple`` times the axis size."""
    if rows % multiple:
        raise ValueError(
            f"{what}: a block of {rows} rows does not divide by {multiple}; "
            f"H must be a multiple of {multiple}·{ctx.size} = "
            f"{multiple * ctx.size} when split over the {ctx.size}-way "
            f"{ctx.axis!r} axis")


def _edge_rows(x, n, top, edge):
    """The ``n`` rows that pad ``x`` at its top (``top``) or bottom global
    edge: reflected (edge row not repeated), zeros, or the edge row
    repeated."""
    if edge == "zero":
        return x.new_zeros((x.shape[0], n, *x.shape[2:]))
    if edge == "clamp":
        row = x[:, :1] if top else x[:, -1:]
        return row.expand(-1, n, *x.shape[2:])
    return (x[:, 1:n + 1] if top else x[:, -n - 1:-1]).flip(1)


def _edge_rows_adjoint(gx, g, top, edge):
    """Add into ``gx`` (the block's gradient, in place) the gradient ``g``
    of the rows ``_edge_rows`` made at the top (``top``) or bottom global
    edge: a reflected row's back onto its source row, a clamped row's
    onto the edge row, a zero row's nowhere."""
    n = g.shape[1]
    if edge == "clamp":
        row = gx[:, :1] if top else gx[:, -1:]
        row += g.sum(dim=1, keepdim=True)
    elif edge == "reflect":
        if top:
            gx[:, 1:n + 1] += g.flip(1)
        else:
            gx[:, -n - 1:-1] += g.flip(1)


def _swap(ctx, to_up, to_down, from_up, from_down, like):
    """One ``batch_isend_irecv`` with the axis neighbours: ``to_up`` sent
    to the previous rank and ``to_down`` to the next (None, or no such
    rank: nothing), ``from_up`` rows received from the previous rank and
    ``from_down`` from the next, shaped as ``like`` but for dim 1.
    Returns (from the previous, from the next), None where nothing came."""
    up = None if ctx.first else ctx.ranks[ctx.index - 1]
    down = None if ctx.last else ctx.ranks[ctx.index + 1]
    ops, got = [], [None, None]
    for t, peer in ((to_down, down), (to_up, up)):
        if t is not None and peer is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer,
                                  ctx.group))
    for i, (n, peer) in enumerate(((from_up, up), (from_down, down))):
        if n and peer is not None:
            got[i] = like.new_empty((like.shape[0], n, *like.shape[2:]))
            ops.append(dist.P2POp(dist.irecv, got[i], peer, ctx.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def _check_exchange(ctx, x, above, below, edge, wpad, wedge):
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    r, w = x.shape[1], x.shape[2]
    need = max(above, below) + (edge == "reflect")
    if r < need:
        raise ValueError(
            f"exchange_rows: a block of {r} rows cannot give {above} rows "
            f"above and {below} below (a {edge} edge needs {need}); use "
            f"fewer ranks on the {ctx.axis!r} axis or a larger H")
    if wedge == "reflect" and wpad >= w:
        raise ValueError(f"exchange_rows: W {w} cannot reflect {wpad} "
                         f"columns")


def _exchange(ctx, x, above, below, edge, wpad, wedge):
    """The forward of ``exchange_rows``."""
    n, r, w, c = x.shape
    # my last `above` rows are the next rank's rows above; my first
    # `below` rows the previous rank's rows below
    top, bottom = _swap(ctx, x[:, :below] if below else None,
                        x[:, r - above:] if above else None, above, below, x)
    if above and top is None:
        top = _edge_rows(x, above, True, edge)
    if below and bottom is None:
        bottom = _edge_rows(x, below, False, edge)
    out = x.new_empty((n, above + r + below, w + 2 * wpad, c))
    out[:, above:above + r, wpad:wpad + w] = x
    if top is not None:
        out[:, :above, wpad:wpad + w] = top
    if bottom is not None:
        out[:, above + r:, wpad:wpad + w] = bottom
    if wpad and wedge == "zero":
        out[:, :, :wpad] = 0
        out[:, :, wpad + w:] = 0
    elif wpad:
        out[:, :, :wpad] = out[:, :, wpad + 1:2 * wpad + 1].flip(2)
        out[:, :, wpad + w:] = out[:, :, w - 1:w - 1 + wpad].flip(2)
    return out


def _exchange_adjoint(ctx, g, above, below, edge, wpad, wedge):
    """The backward of ``exchange_rows``: g (N, above + R + below,
    W + 2·wpad, C) → the block's gradient (N, R, W, C).  The W border
    folds back into its source columns (reflect; zero columns are
    dropped), over every row; then the halo rows' gradients go back to
    the ranks they came from, in one ``batch_isend_irecv``, and are added
    into their edge rows, while the rows made at a global edge fold back
    locally (``_edge_rows_adjoint``)."""
    r, w = g.shape[1] - above - below, g.shape[2] - 2 * wpad
    gw = g[:, :, wpad:wpad + w]
    if wpad and wedge == "reflect":
        gw = gw.clone()
        gw[:, :, 1:wpad + 1] += g[:, :, :wpad].flip(2)
        gw[:, :, w - 1 - wpad:w - 1] += g[:, :, wpad + w:].flip(2)
    top = gw[:, :above] if above else None
    bottom = gw[:, above + r:] if below else None
    gx = gw[:, above:above + r].clone(memory_format=torch.contiguous_format)
    from_up, from_down = _swap(ctx, top, bottom, below, above, gx)
    if top is not None and ctx.first:
        _edge_rows_adjoint(gx, top, True, edge)
    if bottom is not None and ctx.last:
        _edge_rows_adjoint(gx, bottom, False, edge)
    if from_up is not None:
        gx[:, :below] += from_up
    if from_down is not None:
        gx[:, r - above:] += from_down
    return gx


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, ctx, x, above, below, edge, wpad, wedge):
        fn_ctx.args = (ctx, above, below, edge, wpad, wedge)
        with record_function("vst::exchange_rows"):
            return _exchange(ctx, x, above, below, edge, wpad, wedge)

    @staticmethod
    @once_differentiable
    def backward(fn_ctx, g):
        with record_function("vst::exchange_rows_bwd"):
            gx = _exchange_adjoint(fn_ctx.args[0], g, *fn_ctx.args[1:])
        return None, gx, None, None, None, None, None


def exchange_rows(ctx: SpatialContext, x: torch.Tensor, above: int,
                  below: int, edge: str, wpad: int = 0,
                  wedge: str = "reflect") -> torch.Tensor:
    """x (N, R, W, C), this rank's rows → (N, above + R + below,
    W + 2·wpad, C): the ``above`` rows that precede the block and the
    ``below`` rows that follow it, from the neighbouring ranks of the axis
    (one ``batch_isend_irecv``), or made by ``edge`` ("reflect", "zero",
    "clamp") at a global edge; and a W border of ``wpad`` columns a side
    ("reflect" or "zero").  All written once into one contiguous NHWC
    tensor: the layout the unsharded layers' padded copy has, so the conv
    that reads it runs as theirs.  Differentiable: the backward is the
    exchange's adjoint (``_exchange_adjoint``), in the profiler range
    "vst::exchange_rows_bwd"."""
    _check_exchange(ctx, x, above, below, edge, wpad, wedge)
    return _ExchangeRows.apply(ctx, x, above, below, edge, wpad, wedge)


def _all_reduce(ctx, t):
    total = t.contiguous().clone()
    if ctx.size > 1:
        dist.all_reduce(total, group=ctx.group)
    return total


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, ctx, t):
        fn_ctx.ctx = ctx
        return _all_reduce(ctx, t)

    @staticmethod
    @once_differentiable
    def backward(fn_ctx, g):
        return None, _all_reduce(fn_ctx.ctx, g)


def all_reduce_sum(ctx: SpatialContext, t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over the axis (one all-reduce; none at
    world 1).  Its backward all-reduces the incoming gradient: every
    rank's share of the loss reads the sum."""
    return _AllReduceSum.apply(ctx, t)


def sharded_in_stats(ctx: SpatialContext, sums: torch.Tensor,
                     count: int) -> torch.Tensor:
    """Per-image instance-norm statistics of the whole frame from each
    rank's sums: ``sums`` (N, 2, C), this block's Σy and Σy² (float32, or
    float64 for the exact evaluation), one flat all-reduce over the axis,
    then mean = Σy / count and the biased var = Σy² / count − mean²
    (K1's arithmetic), ``count`` the global H·W.  Returns (N, 2, C);
    differentiable through ``all_reduce_sum``."""
    total = all_reduce_sum(ctx, sums)
    mean = total[:, 0] / count
    var = total[:, 1] / count - mean * mean
    return torch.stack([mean, var], dim=1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, ctx, y):
        fn_ctx.ctx = ctx
        parts = [torch.empty_like(y) for _ in range(ctx.size)]
        dist.all_gather(parts, y.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    @once_differentiable
    def backward(fn_ctx, g):
        ctx = fn_ctx.ctx
        parts = [p.contiguous() for p in g.chunk(ctx.size, dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return None, out


def gather_rows(ctx: SpatialContext, y: torch.Tensor) -> torch.Tensor:
    """The whole frame from every rank's rows (all-gather along the axis,
    concatenated on dim 1): what ``np.asarray`` of JAX's H-sharded result
    gives, and the source a sharded warp samples.  Its backward
    reduce-scatters the incoming gradient (summed over the ranks) into
    each rank's rows."""
    if ctx.size == 1:
        return y
    return _GatherRows.apply(ctx, y)
