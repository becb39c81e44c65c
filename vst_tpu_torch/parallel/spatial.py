"""Spatial (H-sharded) serving and training: the halo exchanges that
XLA's SPMD partitioner inserts for the JAX package, written out over
``torch.distributed``, with their backward passes.

Every rank holds a contiguous block of rows (dim 1) of each NHWC
activation.  The entry points take the frame as JAX places it (rank i of
the axis the rows i·H/D … (i+1)·H/D − 1: ``mesh.shard_spatial``,
``mesh.shard_batch_spatial``) and run the layers on a layout of their own
(``row_layout``): whole units of m rows, the entry's multiple (2 to the
number of its stride-2 layers and pools), spread as evenly as they go,
with any remainder on the last block.  Every block then starts on a
multiple of m, so each stride-2 conv and pool lines up inside it at every
level, and only the bottom block can end on a partial unit, at the
frame's edge.  Where m·D divides H the layout is the placement itself
and nothing moves; otherwise ``relayout_rows`` moves the rows whose owner
differs (one ``batch_isend_irecv``).  The ``SpatialContext`` carries the
layout (``bounds``); where it is uneven, the frame's counts at a level
come from the blocks' own (an instance norm's count rides on its sums'
all-reduce, a loss's is one small all-reduce, a gather's sizes one small
all-gather), so every level's global H is the unsharded model's.

A layer that reads rows beyond its block gets them from its neighbours on
the axis (``exchange_rows``: one ``dist.batch_isend_irecv`` of the edge
rows, the P2P pattern of ``parallel/attention.py``'s ring); at a global
edge the rows are made locally as the unsharded layer pads (reflect, zero
or clamp).  K1's instance norms all-reduce their per-image Σy and Σy² and
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
``gather_rows``'s backward reduce-scatters it; ``relayout_rows``'s moves
the rows back.  The sequence-parallel attention
(``parallel/attention.py``) carries its own backward (the cosine
all-reduce's and the ring's).

``exchange_rows`` runs inside the span "vst::exchange_rows", and its
backward inside "vst::exchange_rows_bwd", as ``ops/pad.py``'s reflection
pad does in "vst::reflection_pad2d", and ``relayout_rows`` inside
"vst::relayout_rows" ("vst::relayout_rows_bwd"), each a profiler range
while a profiler records (``utils/profiling.py::span``), so a trace gives
their device time (``chip_smoke.py``'s spatial part reads it).
"""

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from vst_tpu_torch.utils.profiling import span

EDGES = ("reflect", "zero", "clamp")
# the fewest rows a block may hold at level 0: the 9×9 stem's reflect
# needs a block of more than f = 4 rows, and blocks come in whole units
MIN_ROWS = 8


def row_layout(h: int, d: int, m: int) -> tuple:
    """Every block's [start, end) of ``h`` rows over ``d`` ranks in whole
    units of ``m`` rows: ⌊h/m⌋ units spread as evenly as they go (the
    first blocks take one more), the h mod m rows left on the last block.
    Computed from shapes alone, the same on every rank; the even split
    h/d wherever m·d divides h."""
    units, rem = divmod(h, m)
    q, extra = divmod(units, d)
    bounds, start = [], 0
    for i in range(d):
        rows = (q + (i < extra)) * m + (rem if i == d - 1 else 0)
        bounds.append((start, start + rows))
        start += rows
    return tuple(bounds)


def placement(h: int, d: int) -> tuple:
    """JAX's placement of ``h`` rows over ``d`` ranks, every block's
    [start, end): ⌈h/d⌉ rows a rank, the last ones shorter where d does
    not divide h."""
    c = -(-h // d)
    return tuple((min(i * c, h), min((i + 1) * c, h)) for i in range(d))


def least_height(d: int, m: int) -> int:
    """The least H (a multiple of ``d``) whose ``row_layout`` over ``d``
    ranks gives every block at least max(m, MIN_ROWS) rows."""
    return d * m * -(-max(m, MIN_ROWS) // m)


class SpatialContext:
    """This rank's place on the mesh axis that shards H: ``mesh``,
    ``axis``, ``index`` (its block's position), ``size`` (the number of
    blocks), the axis's process group and global ranks, and ``bounds``,
    every block's [start, end) at level 0 (``row_layout``; None: blocks
    of equal rows, the placement)."""

    def __init__(self, mesh, axis: str = "space", bounds=None):
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.shape}")
        self.mesh = mesh
        self.axis = axis
        self.index = mesh.index[axis]
        self.size = mesh.shape[axis]
        self.group = mesh.groups[axis]
        self.ranks = mesh.ranks[axis]
        self.bounds = None if bounds is None else tuple(bounds)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    @property
    def even(self) -> bool:
        """Every block holds the same rows at every level: no layout, or
        an even one (then every level's counts are this block's times the
        axis size, with no collective)."""
        return (self.bounds is None
                or len({e - s for s, e in self.bounds}) == 1)

    def __repr__(self):
        return (f"SpatialContext(axis={self.axis!r}, index={self.index}, "
                f"size={self.size}, bounds={self.bounds})")


def layout_for(ctx: SpatialContext, h: int, m: int, what: str) -> tuple:
    """``row_layout(h, ctx.size, m)`` for a frame of ``h`` rows, after
    JAX's own rule (the axis size divides H) and the least block
    (``MIN_ROWS``, and one whole unit) are checked: ``ValueError``
    otherwise, naming the least H that works for this axis size."""
    d = ctx.size
    if h % d:
        raise ValueError(f"{what}: H {h} must divide by the {d}-way "
                         f"{ctx.axis!r} axis")
    bounds = row_layout(h, d, m)
    least = least_height(d, m)
    if h < least:
        rows = min(e - s for s, e in bounds)
        raise ValueError(
            f"{what}: H {h} over the {d}-way {ctx.axis!r} axis leaves a "
            f"block of {rows} rows; a block holds whole units of {m} rows "
            f"and at least {max(m, MIN_ROWS)}, so H must be at least "
            f"{least} for {d} ranks")
    return bounds


def check_rows(ctx: SpatialContext, rows: int, multiple: int, what: str):
    """Raise ``ValueError`` unless this block of ``rows`` rows lines up
    with units of ``multiple`` rows: it starts on a multiple of
    ``multiple`` and, unless it is the last block, ends on one.  The
    block's start is the layout's (``ctx.bounds``) where its rows are the
    layout's; otherwise the blocks are taken to be equal."""
    start, end = ((ctx.index * rows, (ctx.index + 1) * rows)
                  if ctx.bounds is None
                  or ctx.bounds[ctx.index][1] - ctx.bounds[ctx.index][0]
                  != rows else ctx.bounds[ctx.index])
    if start % multiple or (not ctx.last and end % multiple):
        raise ValueError(
            f"{what}: a block of rows {start} … {end - 1} does not line up "
            f"with units of {multiple} rows on the {ctx.size}-way "
            f"{ctx.axis!r} axis; lay the frame out with row_layout "
            f"(stylize_spatial_sharded and the train steps do)")


def level_rows(ctx: SpatialContext, *rows: int) -> list:
    """Every rank's ``rows`` (one or more ints about its block at some
    level), in axis order, as tuples: this rank's repeated where the
    layout is even, else one small all-gather read on the host."""
    if ctx.even:
        return [rows] * ctx.size
    t = torch.tensor(rows, dtype=torch.int64, device=ctx.mesh.device)
    parts = [torch.empty_like(t) for _ in range(ctx.size)]
    dist.all_gather(parts, t, group=ctx.group)
    return [tuple(int(v) for v in p.tolist()) for p in parts]


def frame_count(ctx: SpatialContext, count: int, like: torch.Tensor):
    """The frame's count of what this block holds ``count`` of (pixels,
    elements): ``count`` times the axis size where the layout is even (an
    int, no collective), else summed over the axis (one small all-reduce
    in float64, exact whatever ``like``'s dtype) and returned as a 0-dim
    tensor of ``like``'s accumulation dtype (float64 for float64, else
    float32: the rounding the even path's int takes in the division)."""
    if ctx.even:
        return count * ctx.size
    acc = torch.float64 if like.dtype == torch.float64 else torch.float32
    total = _all_reduce(ctx, torch.full((1,), float(count),
                                        dtype=torch.float64,
                                        device=like.device))
    return total[0].to(acc)


def all_reduce_sum_count(ctx: SpatialContext, t: torch.Tensor, count: int):
    """(``all_reduce_sum(ctx, t)``, ``frame_count(ctx, count, t)``) with
    one all-reduce: where the layout is uneven the count rides on the sums
    as one more element (``t`` float32 or float64: the count is exact to
    2²⁴, a 4K frame's H·W is 2²³)."""
    if ctx.even:
        return all_reduce_sum(ctx, t), count * ctx.size
    flat = all_reduce_sum(ctx, torch.cat([t.reshape(-1),
                                          t.new_full((1,), float(count))]))
    return flat[:-1].reshape(t.shape), flat[-1]


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


def _per_rank(ctx, n):
    """Row counts, one per rank of the axis: ``n`` itself (a sequence) or
    ``n`` for every rank (an int)."""
    n = tuple(n) if isinstance(n, (tuple, list)) else (n,) * ctx.size
    if len(n) != ctx.size:
        raise ValueError(f"exchange_rows: {len(n)} row counts for a "
                         f"{ctx.size}-way axis")
    return n


def _flows(ctx, above, below):
    """This rank's (rows above, rows below, rows it sends up, rows it
    sends down): its own counts, the previous rank's rows below and the
    next rank's rows above."""
    i = ctx.index
    return (above[i], below[i], 0 if ctx.first else below[i - 1],
            0 if ctx.last else above[i + 1])


def _check_exchange(ctx, x, above, below, edge, wpad, wedge):
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    r, w = x.shape[1], x.shape[2]
    a, b, up, down = _flows(ctx, above, below)
    refl = edge == "reflect"
    need = max(up, down, a + refl if ctx.first and a else 0,
               b + refl if ctx.last and b else 0)
    if r < need:
        raise ValueError(
            f"exchange_rows: a block of {r} rows cannot give {up} rows "
            f"up and {down} down, or make {a} above and {b} below at a "
            f"{edge} edge (it needs {need}); use fewer ranks on the "
            f"{ctx.axis!r} axis or a larger H")
    if wedge == "reflect" and wpad >= w:
        raise ValueError(f"exchange_rows: W {w} cannot reflect {wpad} "
                         f"columns")


def _exchange(ctx, x, above, below, edge, wpad, wedge):
    """The forward of ``exchange_rows``."""
    n, r, w, c = x.shape
    a, b, up, down = _flows(ctx, above, below)
    # my first rows are the previous rank's rows below, my last rows the
    # next rank's rows above
    top, bottom = _swap(ctx, x[:, :up] if up else None,
                        x[:, r - down:] if down else None, a, b, x)
    if a and top is None:
        top = _edge_rows(x, a, True, edge)
    if b and bottom is None:
        bottom = _edge_rows(x, b, False, edge)
    out = x.new_empty((n, a + r + b, w + 2 * wpad, c))
    out[:, a:a + r, wpad:wpad + w] = x
    if top is not None:
        out[:, :a, wpad:wpad + w] = top
    if bottom is not None:
        out[:, a + r:, wpad:wpad + w] = bottom
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
    a, b, up, down = _flows(ctx, above, below)
    r, w = g.shape[1] - a - b, g.shape[2] - 2 * wpad
    gw = g[:, :, wpad:wpad + w]
    if wpad and wedge == "reflect":
        gw = gw.clone()
        gw[:, :, 1:wpad + 1] += g[:, :, :wpad].flip(2)
        gw[:, :, w - 1 - wpad:w - 1] += g[:, :, wpad + w:].flip(2)
    top = gw[:, :a] if a else None
    bottom = gw[:, a + r:] if b else None
    gx = gw[:, a:a + r].clone(memory_format=torch.contiguous_format)
    from_up, from_down = _swap(ctx, top, bottom, up, down, gx)
    if top is not None and ctx.first:
        _edge_rows_adjoint(gx, top, True, edge)
    if bottom is not None and ctx.last:
        _edge_rows_adjoint(gx, bottom, False, edge)
    if from_up is not None:
        gx[:, :up] += from_up
    if from_down is not None:
        gx[:, r - down:] += from_down
    return gx


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, ctx, x, above, below, edge, wpad, wedge):
        fn_ctx.args = (ctx, above, below, edge, wpad, wedge)
        with span("vst::exchange_rows"):
            return _exchange(ctx, x, above, below, edge, wpad, wedge)

    @staticmethod
    @once_differentiable
    def backward(fn_ctx, g):
        with span("vst::exchange_rows_bwd"):
            gx = _exchange_adjoint(fn_ctx.args[0], g, *fn_ctx.args[1:])
        return None, gx, None, None, None, None, None


def exchange_rows(ctx: SpatialContext, x: torch.Tensor, above, below,
                  edge: str, wpad: int = 0,
                  wedge: str = "reflect") -> torch.Tensor:
    """x (N, R, W, C), this rank's rows → (N, above + R + below,
    W + 2·wpad, C): the ``above`` rows that precede the block and the
    ``below`` rows that follow it, from the neighbouring ranks of the axis
    (one ``batch_isend_irecv``), or made by ``edge`` ("reflect", "zero",
    "clamp") at a global edge; and a W border of ``wpad`` columns a side
    ("reflect" or "zero").  All written once into one contiguous NHWC
    tensor: the layout the unsharded layers' padded copy has, so the conv
    that reads it runs as theirs.  ``above`` and ``below`` are ints, the
    same on every rank, or one count per rank of the axis (blocks of
    different rows; a rank reads its own and its neighbours' only, so the
    last rank's rows below and the first's above, made at the edge, need
    be right only there).  Differentiable: the backward is the exchange's
    adjoint (``_exchange_adjoint``), in the span
    "vst::exchange_rows_bwd"."""
    above, below = _per_rank(ctx, above), _per_rank(ctx, below)
    _check_exchange(ctx, x, above, below, edge, wpad, wedge)
    return _ExchangeRows.apply(ctx, x, above, below, edge, wpad, wedge)


def _relayout(ctx, xs, src, dst):
    """The rows of each tensor of ``xs``, this rank's block ``src[index]``
    of its frame, re-cut to its block ``dst[index]``: what it keeps is
    copied, what another rank holds or needs crosses, for all of ``xs``
    in one ``batch_isend_irecv``."""
    i = ctx.index
    (s0, s1), (d0, d1) = src[i], dst[i]
    outs = [x.new_empty((x.shape[0], d1 - d0, *x.shape[2:])) for x in xs]
    ops, got = [], []
    for j, peer in enumerate(ctx.ranks):
        for x, out in zip(xs, outs):
            a, b = max(s0, dst[j][0]), min(s1, dst[j][1])
            if a < b and j == i:
                out[:, a - d0:b - d0] = x[:, a - s0:b - s0]
            elif a < b:
                ops.append(dist.P2POp(dist.isend,
                                      x[:, a - s0:b - s0].contiguous(),
                                      peer, ctx.group))
            a, b = max(d0, src[j][0]), min(d1, src[j][1])
            if a < b and j != i:
                got.append((out, a - d0, x.new_empty((x.shape[0], b - a,
                                                      *x.shape[2:]))))
                ops.append(dist.P2POp(dist.irecv, got[-1][2], peer,
                                      ctx.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for out, a, t in got:
        out[:, a:a + t.shape[1]] = t
    return tuple(outs)


class _RelayoutRows(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, ctx, src, dst, *xs):
        fn_ctx.args = (ctx, src, dst)
        with span("vst::relayout_rows"):
            return _relayout(ctx, xs, src, dst)

    @staticmethod
    @once_differentiable
    def backward(fn_ctx, *gs):
        ctx, src, dst = fn_ctx.args
        with span("vst::relayout_rows_bwd"):
            gx = _relayout(ctx, [g.contiguous() for g in gs], dst, src)
        return (None, None, None, *gx)


def relayout_rows(ctx: SpatialContext, x, src, dst):
    """x (N, R, …), this rank's block of rows ``src[index]`` ([start,
    end) of the frame's rows; ``src`` and ``dst`` each cover the frame's
    rows once, in axis order) → its block ``dst[index]``: the rows whose
    owner differs move point to point (one ``batch_isend_irecv``, with any
    rank, not only the neighbours).  ``x`` may be a list of such tensors
    (a step's frames, flow and mask), every one of them moved in the same
    ``batch_isend_irecv``; a list comes back.  Where the layouts are equal
    it is x itself and issues no collective.  Its backward is the same
    move reversed, in the span "vst::relayout_rows_bwd"."""
    src, dst = tuple(map(tuple, src)), tuple(map(tuple, dst))
    if src == dst:
        return x
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    rows = src[ctx.index][1] - src[ctx.index][0]
    for t in xs:
        if t.shape[1] != rows:
            raise ValueError(f"relayout_rows: a block of {t.shape[1]} rows "
                             f"is not rows {src[ctx.index]}")
    out = _RelayoutRows.apply(ctx, src, dst, *xs)
    return list(out) if isinstance(x, (list, tuple)) else out[0]


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
    then mean = Σy / n and the biased var = Σy² / n − mean² (K1's
    arithmetic), n the global H·W: ``count`` (this block's H·W) times the
    axis size, or, where the layout is uneven, the blocks' counts summed
    in the same all-reduce (``all_reduce_sum_count``).  Returns (N, 2, C);
    differentiable through ``all_reduce_sum``."""
    total, n = all_reduce_sum_count(ctx, sums, count)
    mean = total[:, 0] / n
    var = total[:, 1] / n - mean * mean
    return torch.stack([mean, var], dim=1)


def _pad_rows(t, rows):
    """``t`` with zero rows below, to ``rows`` rows (dim 1)."""
    if t.shape[1] == rows:
        return t.contiguous()
    out = t.new_zeros((t.shape[0], rows, *t.shape[2:]))
    out[:, :t.shape[1]] = t
    return out


class _GatherRows(torch.autograd.Function):
    """Every block padded below to the largest (``sizes``), all-gathered
    and trimmed (the collectives take equal sizes; blocks of equal rows
    are neither padded nor trimmed); the backward pads every rank's part
    of the gradient, reduce-scatters, and trims."""

    @staticmethod
    def forward(fn_ctx, ctx, y, sizes):
        fn_ctx.args = (ctx, sizes)
        padded = _pad_rows(y, max(sizes))
        parts = [torch.empty_like(padded) for _ in range(ctx.size)]
        dist.all_gather(parts, padded, group=ctx.group)
        return torch.cat([p[:, :r] for p, r in zip(parts, sizes)], dim=1)

    @staticmethod
    @once_differentiable
    def backward(fn_ctx, g):
        ctx, sizes = fn_ctx.args
        top = max(sizes)
        parts = [_pad_rows(p, top) for p in g.split(list(sizes), dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return None, out[:, :sizes[ctx.index]], None


def gather_rows(ctx: SpatialContext, y: torch.Tensor,
                sizes=None) -> torch.Tensor:
    """The whole frame from every rank's rows (all-gather along the axis,
    concatenated on dim 1): what ``np.asarray`` of JAX's H-sharded result
    gives, and the source a sharded warp samples.  ``sizes``: every
    rank's rows (``level_rows``, which it defaults to); blocks of
    different rows are padded to the largest for the all-gather and
    trimmed.  Its backward reduce-scatters the incoming gradient (summed
    over the ranks) into each rank's rows."""
    if ctx.size == 1:
        return y
    if sizes is None:
        sizes = [r for r, in level_rows(ctx, y.shape[1])]
    return _GatherRows.apply(ctx, y, tuple(sizes))
