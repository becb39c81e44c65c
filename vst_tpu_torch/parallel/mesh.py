"""Device mesh and data-parallel placement over ``torch.distributed``.

Counterpart of ``vst_tpu/parallel/mesh.py``.  JAX places arrays on a
device mesh and lets XLA insert the collectives; here every rank is one
process holding one device, a ``Mesh`` holds this rank's process group on
each axis, and the collectives are explicit:

- data parallelism: each rank takes its contiguous dim-0 slice of every
  global batch (``shard_batch``, or the loader's per-process slice), the
  parameters are broadcast from rank 0 (``replicate``) and the train step
  averages the gradients and metrics over the "data" axis with one
  flattened all-reduce each (``all_reduce_mean``);
- a loss that is not a mean over the batch (a raw sum, or a ratio whose
  denominator counts the batch's mask) is rescaled on each rank so that
  the mean over ranks is the global batch's loss (``batch_shards``,
  ``batch_total``): the JAX step computes the loss of the global batch.

The device follows the process group's backend: NCCL on the rank's card
(``cuda:<local rank>``, set by ``multihost.initialize``), gloo on the CPU,
which a caller gets only by asking for the CPU.

Spatial parallelism: ``shard_spatial`` gives each rank its contiguous H
rows (dim 1) of every NHWC leaf, rank i the rows i·H/D … (i+1)·H/D − 1
(JAX's placement; H must divide by D); the layers then exchange their
halo rows themselves (``parallel/spatial.py``), on a layout of whole row
units that the entry points move the rows into where it differs
(``row_layout``, ``relayout_rows``).  ``shard_batch_spatial`` shards a
batch on both axes of a ("data", "space") mesh for training: every
train step then sums its gradients and metrics over "space" and averages
them over "data" (``all_reduce_sum``, ``all_reduce_mean``), and its mask
counts are totals over both axes (``batch_total``).
"""

import math

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """This rank's view of a device mesh.

    ``axis_names``; ``shape``: axis → size, as ``jax.sharding.Mesh.shape``;
    ``groups``: axis → this rank's process group along that axis;
    ``ranks``: axis → the global ranks of that group in axis order;
    ``index``: axis → this rank's position on it; ``device``: its device.
    Ranks are laid out row-major over ``shape``, as JAX reshapes its
    device list."""

    def __init__(self, axis_names, shape, groups, ranks, index, device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.groups = groups
        self.ranks = ranks
        self.index = index
        self.device = device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return (f"Mesh({self.shape}, index={self.index}, "
                f"device={self.device})")


def _mesh_shape(n_devices, axis_names, shape):
    """JAX's rules: 1-D by default, the most balanced data-major divisor
    pair for two axes, ``shape`` required for more."""
    if shape is None:
        if len(axis_names) == 1:
            shape = (n_devices,)
        elif len(axis_names) == 2:
            s = int(math.isqrt(n_devices))
            while n_devices % s:
                s -= 1
            shape = (n_devices // s, s)
        else:
            raise ValueError(
                f"pass shape= for a {len(axis_names)}-axis mesh")
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"shape {shape} != {n_devices} devices")
    return tuple(shape)


def _rank_device() -> torch.device:
    """The device of this rank: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, axis_names=("data",),
              shape=None) -> Mesh:
    """Mesh over the initialized process group's ranks, one device each.

    1-D by default.  For two axes pass ``shape`` or let it factor
    ``n_devices`` into the most balanced (data-major) divisor pair; more
    axes need ``shape``.  ``n_devices`` (default: the world size) must be
    the world size: a rank outside the mesh would have no part in its
    collectives.  Every rank calls this, in the same order as its other
    group creations (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "vst_tpu_torch.parallel.multihost.initialize first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    shape = _mesh_shape(n_devices, axis_names, shape)
    if n_devices != world:
        raise ValueError(f"a {n_devices}-device mesh needs a world of "
                         f"{n_devices} ranks (one device each); this one "
                         f"has {world}")
    rank = dist.get_rank()
    coords = np.arange(world).reshape(shape)
    mine = np.unravel_index(rank, shape)
    groups, ranks, index = {}, {}, {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(coords, a, -1).reshape(-1, shape[a])
        for line in lines:
            members = [int(r) for r in line]
            group = dist.new_group(members)
            if rank in members:
                groups[name], ranks[name] = group, members
        index[name] = int(mine[a])
    return Mesh(axis_names, shape, groups, ranks, index, _rank_device())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """This rank's contiguous dim-0 slice of every leaf (tensor or array)
    of ``tree``, on the rank's device: the batch sharded over ``axis``."""
    n, i = mesh.shape[axis], mesh.index[axis]

    def take(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} must divide by the "
                             f"{n}-way '{axis}' axis")
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows].to(mesh.device)

    return _tree_map(take, tree)


def shard_spatial(mesh: Mesh, tree, axis: str = "space"):
    """This rank's contiguous H slice (dim 1) of every NHWC leaf (tensor
    or array) of ``tree``, on the rank's device: the frame sharded over
    ``axis``, rank i the rows i·H/D … (i+1)·H/D − 1 (JAX's placement;
    ``ValueError`` where D does not divide H).  Only those rows are copied
    to the device."""
    n, i = mesh.shape[axis], mesh.index[axis]

    def take(x):
        x = torch.as_tensor(x)
        if x.dim() < 2 or x.shape[1] % n:
            raise ValueError(f"H {tuple(x.shape)[1:2]} must divide by the "
                             f"{n}-way '{axis}' axis")
        rows = x.shape[1] // n
        return x[:, i * rows:(i + 1) * rows].to(mesh.device)

    return _tree_map(take, tree)


def shard_batch_spatial(mesh: Mesh, tree, batch_axis: str = "data",
                        space_axis: str = "space"):
    """This rank's contiguous dim-0 slice over ``batch_axis`` and, of
    that, its contiguous dim-1 rows over ``space_axis``, of every leaf
    with ndim >= 2 (the NHWC frames, the (N, H, W, 2) flow, the (N, H, W)
    mask), on the rank's device: JAX's placement P(batch_axis,
    space_axis).  Only those rows are copied to the device.  A mesh
    without ``batch_axis`` (a "space" axis alone) leaves dim 0 whole.
    Raises ``ValueError`` when a dimension does not divide."""
    nb, ib = mesh.shape.get(batch_axis, 1), mesh.index.get(batch_axis, 0)
    ns, js = mesh.shape[space_axis], mesh.index[space_axis]

    def take(x):
        x = torch.as_tensor(x)
        if x.dim() < 2 or x.shape[0] % nb or x.shape[1] % ns:
            raise ValueError(
                f"shape {tuple(x.shape)}: dim 0 must divide by the {nb}-way "
                f"{batch_axis!r} axis and dim 1 (H) by the {ns}-way "
                f"{space_axis!r} axis")
        b, r = x.shape[0] // nb, x.shape[1] // ns
        return x[ib * b:(ib + 1) * b, js * r:(js + 1) * r].to(mesh.device)

    return _tree_map(take, tree)


def _buckets(tensors):
    """The tensors grouped by (dtype, device), in order."""
    out = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return list(out.values())


def _flat_collective(mesh: Mesh, tensors, collective):
    """Run ``collective(flat)`` on one flat copy of the tensors per dtype
    and device, on the rank's device, then write the result back into each
    tensor (one multi-tensor copy: a copy per tensor is a launch each).
    Gradients and parameters are on the rank's device already (``.to`` is
    then no copy); torch's Adam keeps its per-parameter step counts on the
    CPU beside parameters on the card, and ``replicate`` of a resumed
    ``TrainState`` broadcasts those through the card under NCCL."""
    for group in _buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        on_dev = flat.to(mesh.device)
        collective(on_dev)
        parts = on_dev.to(flat.device).split([t.numel() for t in group])
        torch._foreach_copy_([t.detach() for t in group],
                             [p.view_as(t) for p, t in zip(parts, group)])
    return tensors


def all_reduce_mean(mesh: Mesh, tensors, axis: str = "data"):
    """Average ``tensors`` (a list) in place over ``axis``: one flattened
    SUM all-reduce per dtype, then a division by the axis size (gloo has
    no AVG).  Returns the list."""
    n = mesh.shape[axis]

    def reduce(flat):
        dist.all_reduce(flat, group=mesh.groups[axis])
        flat.div_(n)

    return _flat_collective(mesh, tensors, reduce)


def all_reduce_sum(mesh: Mesh, tensors, axis: str = "space"):
    """Sum ``tensors`` (a list) in place over ``axis``: one flattened SUM
    all-reduce per dtype (the ranks' shares of an H-sharded loss's
    gradients and metrics).  Returns the list."""
    return _flat_collective(
        mesh, tensors, lambda flat: dist.all_reduce(
            flat, group=mesh.groups[axis]))


def _state_tensors(obj):
    """The tensors ``replicate`` broadcasts from a module, a TrainState or
    a pytree of tensors."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if hasattr(obj, "model") and hasattr(obj, "optimizer"):
        opt = [v for s in obj.optimizer.state.values() for v in s.values()
               if isinstance(v, torch.Tensor)]
        return _state_tensors(obj.model) + opt
    out = []
    _tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor)
              else None, obj)
    return out


def replicate(mesh: Mesh, tree):
    """Broadcast ``tree`` from rank 0 to every rank of the mesh, in place:
    a pytree of tensors (already on the rank's device), an ``nn.Module``
    (parameters and buffers) or a ``TrainState`` (the model, the
    optimizer's state tensors and the step count).  Returns ``tree``.

    Every rank must hold the same structure: the same modules, and an
    optimizer state of the same keys (a resumed rank 0 beside a fresh
    rank 1 is what ``cli.train``'s resume agreement rules out first)."""
    group = dist.group.WORLD

    def bcast(flat):
        dist.broadcast(flat, src=0, group=group)

    _flat_collective(mesh, _state_tensors(tree), bcast)
    if hasattr(tree, "step") and hasattr(tree, "optimizer"):
        step = torch.tensor([tree.step], dtype=torch.int64,
                            device=mesh.device)
        dist.broadcast(step, src=0, group=group)
        tree.step = int(step.item())
    return tree


# ------------------------------------------- losses over a sharded batch

def batch_shards(mesh: Mesh | None, axis: str = "data") -> int:
    """How many ranks share the batch: a loss that sums over the batch is
    multiplied by this on each rank, so that the mean over ranks (the
    step's all-reduce) is the global batch's sum.  The "space" axis splits
    a loss into shares that sum to it and takes no factor."""
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def batch_total(mesh: Mesh | None, x: torch.Tensor,
                axes=("data", "space")) -> torch.Tensor:
    """The sum over the mesh's ``axes`` (those it has) of a tensor that
    depends on the data only (a mask count): the global batch's
    denominator of a ratio loss, every frame's rows counted once.
    Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    out = x.detach().clone()
    for axis in axes:
        if axis in mesh.shape:
            dist.all_reduce(out, group=mesh.groups[axis])
    return out
