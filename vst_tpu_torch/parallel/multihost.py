"""Multi-process runs: one process per device, one process group.

Counterpart of ``vst_tpu/parallel/multihost.py``.  In JAX the multi-host
layer stitches each host's devices into one global mesh; in torch a
data-parallel rank is already a process, so one ``init_process_group``
serves both ``cli.train --data-parallel`` (ranks spawned on one host) and
``--multihost`` (one command per rank, on any number of hosts):

- :func:`initialize` — join the process group: NCCL on the card, gloo
  when the caller asked for the CPU;
- :func:`put_global_batch` — this rank's slice of the global batch onto
  its device.  The data pipeline stays embarrassingly parallel: every
  process loads only its ``1/world`` slice of each global batch
  (``BatchLoader(process_id=, num_processes=)``);
- :func:`is_primary` — exactly one process owns checkpoint writes, metric
  sinks and loss plots (``train/loop.py`` gates on it);
- :func:`run_local_ranks` — a CLI's ``--data-parallel N`` on one host: N
  spawned ranks joined through a ``file://`` rendezvous.

JAX's TPU pod auto-detection has no counterpart: every process names the
coordinator, the process count and its own rank.
"""

import os
import tempfile

import torch
import torch.distributed as dist

from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.parallel.mesh import replicate


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               init_method: str | None = None) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``.

    ``coordinator``: ``host:port`` every process reaches rank 0 at
    (``tcp://`` init); or ``init_method`` given whole (``file://``, as the
    CLI's local spawns use).  ``device`` "cuda" runs NCCL with this rank on
    ``cuda:<local rank>`` (``LOCAL_RANK`` when set, else the rank modulo
    the host's card count); "cpu" runs gloo.  No fallback from one to the
    other."""
    if num_processes is None or process_id is None or (
            coordinator is None and init_method is None):
        raise ValueError("initialize needs the coordinator (host:port), "
                         "num_processes and process_id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if one is initialized."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """Rank 0, or True when no process group is initialized."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def put_global_batch(mesh, x):
    """This rank's slice of the global batch (``x``: the process-local
    rows, as the loader yields them) on the rank's device."""
    return torch.as_tensor(x).to(mesh.device)


def replicate_global(mesh, tree):
    """Identical values on every rank: ``mesh.replicate`` (a broadcast from
    rank 0)."""
    return replicate(mesh, tree)


def _local_rank(rank, entry, argv, world, init_method, device):
    initialize(num_processes=world, process_id=rank, device=device,
               init_method=init_method)
    try:
        entry(argv)
    finally:
        shutdown()


def local_rank_count(n: int, device="cuda") -> int:
    """The ranks ``--data-parallel N`` runs on this host: ``n`` when it is
    positive, else one per card (the port's no-card error without one), or
    one on the CPU."""
    if n > 0:
        return n
    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def run_local_ranks(entry, argv, n: int, device="cuda") -> None:
    """Run ``entry(argv)`` as each of ``n`` ranks of a new process group on
    this host, one device each, joined through a ``file://`` rendezvous in
    a temporary directory.  ``n`` = 1 runs in this process (a world-1
    group: the collectives still run); more ranks are spawned processes,
    and one that fails ends the run with its rank in the message.
    ``entry`` must be importable by name (the spawn pickles it)."""
    with tempfile.TemporaryDirectory(prefix="vst_dp_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        if n == 1:
            _local_rank(0, entry, argv, 1, init, device)
            return
        import torch.multiprocessing as mp

        try:
            mp.start_processes(_local_rank,
                               args=(entry, argv, n, init, device),
                               nprocs=n, start_method="spawn")
        except mp.ProcessException as e:
            raise SystemExit(f"error: data-parallel rank {e.error_index} "
                             f"failed (see its output above)") from None
