"""Spatial (H-sharded) serving: the halo exchanges that XLA's SPMD
partitioner inserts for the JAX package, written out over
``torch.distributed``.

Every rank holds a contiguous block of R rows (dim 1) of each NHWC
activation, rank i of the axis the rows i·R … (i+1)·R − 1
(``mesh.shard_spatial``).  A layer that reads rows beyond its block gets
them from its neighbours on the axis (``exchange_rows``: one
``dist.batch_isend_irecv`` of the edge rows, the P2P pattern of
``parallel/attention.py``'s ring); at a global edge the rows are made
locally as the unsharded layer pads (reflect, zero or clamp).  K1's
instance norms all-reduce their per-image Σy and Σy² and divide by the
global H·W (``sharded_in_stats``, K1's one-pass arithmetic); the others
(``ops/norm.py``) all-reduce Σx, then Σ(x − mean)², the two passes of the
unsharded norm.  What each layer kind needs is in
``ops/conv.py``, ``ops/norm.py``, ``ops/resize.py`` and
``ops/features.py``, which take a ``SpatialContext`` as ``spatial=``;
with ``spatial=None`` they run the unsharded code.

Serving only: every sharded op raises when a gradient is needed (the
exchange's backward is still to port).

``exchange_rows`` runs inside the profiler range "vst::exchange_rows", as
``ops/pad.py``'s reflection pad does in "vst::reflection_pad2d", so a
trace gives the padded copies' device time (``chip_smoke.py``'s spatial
part reads it).
"""

import torch
import torch.distributed as dist
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


def no_grad_needed(what, *ts):
    """Raise when autograd would need the backward of a sharded op."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what} with a spatial context serves only: the halo "
            "exchange's backward is not ported (slice 7c)")


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


def _halo(ctx, x, above, below, edge):
    """The ``above`` rows before x's block and the ``below`` rows after it
    (None where 0): from the neighbours in one ``batch_isend_irecv``, or
    made by ``edge`` at a global edge."""
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    no_grad_needed("exchange_rows", x)
    r = x.shape[1]
    need = max(above, below) + (edge == "reflect")
    if r < need:
        raise ValueError(
            f"exchange_rows: a block of {r} rows cannot give {above} rows "
            f"above and {below} below (a {edge} edge needs {need}); use "
            f"fewer ranks on the {ctx.axis!r} axis or a larger H")
    ops, got = [], {}
    up = None if ctx.first else ctx.ranks[ctx.index - 1]
    down = None if ctx.last else ctx.ranks[ctx.index + 1]
    # my last `above` rows are the next rank's rows above; my first
    # `below` rows the previous rank's rows below
    if above and down is not None:
        ops.append(dist.P2POp(dist.isend, x[:, r - above:].contiguous(),
                              down, ctx.group))
    if below and up is not None:
        ops.append(dist.P2POp(dist.isend, x[:, :below].contiguous(), up,
                              ctx.group))
    for side, n, peer in (("above", above, up), ("below", below, down)):
        if n and peer is not None:
            got[side] = x.new_empty((x.shape[0], n, *x.shape[2:]))
            ops.append(dist.P2POp(dist.irecv, got[side], peer, ctx.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    top = bottom = None
    if above:
        top = got["above"] if up is not None else _edge_rows(x, above, True,
                                                             edge)
    if below:
        bottom = (got["below"] if down is not None
                  else _edge_rows(x, below, False, edge))
    return top, bottom


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
    that reads it runs as theirs."""
    with record_function("vst::exchange_rows"):
        top, bottom = _halo(ctx, x, above, below, edge)
        n, r, w, c = x.shape
        if wedge == "reflect" and wpad >= w:
            raise ValueError(f"exchange_rows: W {w} cannot reflect {wpad} "
                             f"columns")
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


def all_reduce_sum(ctx: SpatialContext, t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over the axis (one all-reduce; none at
    world 1)."""
    total = t.contiguous().clone()
    if ctx.size > 1:
        dist.all_reduce(total, group=ctx.group)
    return total


def sharded_in_stats(ctx: SpatialContext, sums: torch.Tensor,
                     count: int) -> torch.Tensor:
    """Per-image instance-norm statistics of the whole frame from each
    rank's sums: ``sums`` (N, 2, C), this block's Σy and Σy² (float32, or
    float64 for the exact evaluation), one flat all-reduce over the axis,
    then mean = Σy / count and the biased var = Σy² / count − mean²
    (K1's arithmetic), ``count`` the global H·W.  Returns (N, 2, C)."""
    total = all_reduce_sum(ctx, sums)
    mean = total[:, 0] / count
    var = total[:, 1] / count - mean * mean
    return torch.stack([mean, var], dim=1)


def gather_rows(ctx: SpatialContext, y: torch.Tensor) -> torch.Tensor:
    """The whole frame from every rank's rows (all-gather along the axis,
    concatenated on dim 1): what ``np.asarray`` of JAX's H-sharded result
    gives, for tests and checks."""
    if ctx.size == 1:
        return y
    parts = [torch.empty_like(y) for _ in range(ctx.size)]
    dist.all_gather(parts, y.contiguous(), group=ctx.group)
    return torch.cat(parts, dim=1)
