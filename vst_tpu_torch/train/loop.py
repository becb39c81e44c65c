"""The training loop.  Counterpart of ``vst_tpu/train/loop.py``, with the
same semantics and log lines: shuffled threaded batch loading, prefetch
onto the card, per-epoch checkpoints (parameters ``.npz`` in the JAX
layout, the resumable full state, the reference-named ``.pth``),
mid-epoch saves, non-finite rollback, preemption, and metric logging.

The port's state is updated in place by the step, where JAX's is a new
value: a rollback snapshot is a host copy of the model's and the
optimizer's state (``checkpoint.snapshot``), and a rollback loads it back
into the live model and optimizer, keeping the step counter.

In a multi-process run (``parallel/multihost.py``) every rank runs the
loop on its slice of each global batch; rank 0 alone writes checkpoints,
metrics and loss plots, and every rank touches the heartbeat.  Snapshots
and rollbacks stay per rank (the replicas are identical); the one
decision that reads the host clock, when to refresh the snapshot, is
agreed across ranks.
"""

import json
import math
import os
import signal
import time

import torch
import torch.distributed as dist

from vst_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vst_tpu_torch.parallel import multihost
from vst_tpu_torch.train import checkpoint as ckpt
from vst_tpu_torch.train.state import TrainState


def _save_loss_plot(history, out_dir, name, epoch, batch_size):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    plt.figure()
    for key, vals in history.items():
        if key != "loss":
            plt.plot(range(1, len(vals) + 1), vals, label=key)
    plt.xlabel("Logged step")
    plt.ylabel("Loss")
    plt.title(f"Losses for Epoch {epoch}")
    plt.legend()
    plt.savefig(os.path.join(
        out_dir, f"{name}_epoch_{epoch}_batchSize_{batch_size}_loss.png"))
    plt.close()


def _primary():
    """True on the process that owns checkpoints and metrics: rank 0, or
    the only process (a seam tests can monkeypatch)."""
    return multihost.is_primary()


def _any_rank(flag: bool, device) -> bool:
    """``flag`` on any rank: one all-reduce in a multi-process run, so that
    a per-rank decision (one that reads the host clock) is the same on
    every rank."""
    if multihost.process_count() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _fetch(metrics: dict) -> dict:
    """The step's metrics (device scalars) as floats, in one transfer, in
    key order (the order JAX's jitted steps return them in)."""
    keys = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                        .reshape(()) for k in keys]).tolist()
    return dict(zip(keys, vals))


def _params_finite(state: TrainState) -> bool:
    """Every parameter finite, in one transfer."""
    return bool(torch.stack([torch.isfinite(p).all()
                             for p in state.model.parameters()]).all())


class TrainingPreempted(RuntimeError):
    """Raised by ``run_training`` after a clean preemption checkpoint.

    Carries the last ``TrainState`` as ``.state``; the resumable
    ``*_last_state`` checkpoint has already been written when this is
    raised, so a supervisor can simply restart with ``--resume auto``.
    """

    def __init__(self, msg, state):
        super().__init__(msg)
        self.state = state


def run_training(
    step_fn,
    state: TrainState,
    dataset,
    *,
    batch_size: int,
    epochs: int,
    epoch_start: int = 1,
    out_dir: str = "./models",
    model_name: str = "model",
    export_pth: bool = True,
    log_every: int = 50,
    seed: int = 0,
    num_workers: int = 4,
    prefetch: int = 2,
    log_fn=print,
    loss_plots_dir: str | None = None,
    save_every_steps: int = 0,
    recover_nonfinite: bool = True,
    max_recoveries: int = 3,
    handle_preemption: bool = True,
    start_batch: int = 0,
    metrics_jsonl: str | None = None,
    snapshot_every_s: float = 60.0,
    heartbeat_file: str | None = None,
) -> TrainState:
    """Run ``epochs`` epochs of ``step_fn(state, batch) -> (state,
    metrics)`` over ``dataset``, on the device of the model's parameters.

    Checkpoints per epoch using the reference's naming convention
    (``{name}_epoch_{e}_batchSize_{b}``), plus the resumable full state
    ``{name}_last_state``.  ``loss_plots_dir`` writes per-epoch loss-curve
    PNGs (RTNSTV/train.py:162-175).

    Non-finite recovery (``recover_nonfinite``): a step whose loss is
    non-finite rolls the state back to the last snapshot (epoch start,
    periodic save, or a log point at most every ``snapshot_every_s``
    seconds), skips the batch and continues — up to ``max_recoveries``
    times per run, then raises.  The loss is checked at the ``log_every``
    cadence and at every persist point (periodic saves and each epoch's
    last batch), and the parameters too at persist points, so a
    non-finite state is never checkpointed.  A rollback never rewinds
    ``state.step``: it counts batches consumed, the resume position.

    Preemption (``handle_preemption``): on SIGTERM/SIGUSR1 the loop
    finishes the in-flight step, writes ``*_last_state`` (rolling back
    first if that state is non-finite) and raises
    :class:`TrainingPreempted`.  Handlers are installed only in the main
    thread and restored on exit.

    ``start_batch``: resume the first epoch of this run mid-epoch,
    skipping that many batches of its seed-derived shuffle at the index
    level; ``cli.train --resume auto`` derives it from ``state.step``.

    ``metrics_jsonl``: append one JSON object per logged step (epoch,
    batch, step, samples/s, every loss term; non-finite values as null).
    ``heartbeat_file``: touch this path at every batch, the liveness signal
    of ``cli.supervise --hang-timeout``.
    """
    stop = {"sig": None}
    prev_handlers = {}
    if handle_preemption:
        def _on_signal(signum, frame):
            stop["sig"] = signum

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):
                pass  # not the main thread — run without the handler

    def persist_point(epoch, i, state, metrics, snap):
        """On a pending preemption signal: checkpoint and bail out."""
        if stop["sig"] is None:
            return
        try:
            sig_name = signal.Signals(stop["sig"]).name
        except ValueError:  # pragma: no cover
            sig_name = f"signal {stop['sig']}"
        if recover_nonfinite and not (
                math.isfinite(_fetch(metrics)["loss"])
                and _params_finite(state)):
            # never persist a non-finite state; the step counter stays
            ckpt.restore(state, snap)
        if _primary():
            ckpt.save_state(state, os.path.join(out_dir,
                                                model_name + "_last_state"))
        raise TrainingPreempted(
            f"{sig_name} at epoch {epoch} batch {i + 1}: resumable state "
            f"saved to {model_name}_last_state", state)

    os.makedirs(out_dir, exist_ok=True)
    if metrics_jsonl and os.path.dirname(metrics_jsonl):
        os.makedirs(os.path.dirname(metrics_jsonl), exist_ok=True)
    if heartbeat_file:
        if os.path.dirname(heartbeat_file):
            os.makedirs(os.path.dirname(heartbeat_file), exist_ok=True)
        open(heartbeat_file, "a").close()
    try:
        state = _epoch_loop(
            step_fn, state, dataset, batch_size, epochs, epoch_start,
            out_dir, model_name, export_pth, log_every, seed, num_workers,
            prefetch, log_fn, loss_plots_dir, save_every_steps,
            recover_nonfinite, max_recoveries, persist_point, start_batch,
            metrics_jsonl, snapshot_every_s, heartbeat_file)
    finally:
        for sig, handler in prev_handlers.items():
            # signal.signal returns None for handlers installed outside
            # Python, which is not a valid handler to restore
            signal.signal(sig, signal.SIG_DFL if handler is None
                          else handler)
    return state


def _epoch_loop(step_fn, state, dataset, batch_size, epochs, epoch_start,
                out_dir, model_name, export_pth, log_every, seed,
                num_workers, prefetch, log_fn, loss_plots_dir,
                save_every_steps, recover_nonfinite, max_recoveries,
                persist_point, start_batch, metrics_jsonl, snapshot_every_s,
                heartbeat_file):
    recoveries = 0
    primary = _primary()
    device = next(state.model.parameters()).device
    last_state = os.path.join(out_dir, model_name + "_last_state")
    for epoch in range(epoch_start, epochs + 1):
        sb = start_batch if epoch == epoch_start else 0
        # each process decodes only its slice of every global batch (the
        # seed-derived shuffle keeps the processes in agreement on the
        # global order without communication)
        loader = BatchLoader(dataset, batch_size, shuffle=True,
                             seed=seed + epoch, num_workers=num_workers,
                             epoch=epoch, start_batch=sb,
                             process_id=multihost.process_index(),
                             num_processes=multihost.process_count())
        n_batches = len(loader)
        t0 = time.time()
        history: dict[str, list] = {}
        snap = ckpt.snapshot(state) if recover_nonfinite else None
        snap_t = time.time()
        for i, batch in enumerate(device_prefetch(iter(loader), prefetch,
                                                  device), start=sb):
            state, metrics = step_fn(state, batch)
            if heartbeat_file:
                os.utime(heartbeat_file, None)
            persist_point(epoch, i, state, metrics, snap)
            vals = None   # the metrics on the host, fetched at most once
            is_save = bool(save_every_steps
                           and (i + 1) % save_every_steps == 0)
            # check before every persist point (periodic saves and the
            # epoch's last batch, whose state the epoch-end save writes),
            # plus the logging cadence for earlier detection
            at_persist = is_save or i == n_batches - 1
            if recover_nonfinite and (
                    at_persist or (log_every and i % log_every == 0)):
                vals = _fetch(metrics)
                bad = not math.isfinite(vals["loss"])
                if not bad and at_persist:
                    # a finite loss does not imply finite parameters: a
                    # backward overflow NaNs the weights one step before
                    # any loss shows it
                    bad = not _params_finite(state)
                if bad:
                    recoveries += 1
                    if recoveries > max_recoveries:
                        raise RuntimeError(
                            f"non-finite loss at epoch {epoch} batch "
                            f"{i + 1}: {max_recoveries} recoveries "
                            f"exhausted")
                    log_fn(f"epoch {epoch} batch {i + 1}: non-finite loss; "
                           f"rolled back to last snapshot (recovery "
                           f"{recoveries}/{max_recoveries})")
                    # parameters and optimizer roll back, the step counter
                    # does not: --resume auto derives the data position
                    # from it
                    ckpt.restore(state, snap)
                    continue
                if (not is_save and not save_every_steps and _any_rank(
                        time.time() - snap_t >= snapshot_every_s, device)):
                    # the check passed at a log point and no periodic saves
                    # refresh the snapshot: advance it here, at most once
                    # per snapshot_every_s (it copies the whole state to
                    # the host), adopting only a fully finite state
                    if _params_finite(state):
                        snap = ckpt.snapshot(state)
                        snap_t = time.time()
            if is_save:
                if recover_nonfinite:
                    # one host copy serves both the rollback snapshot and
                    # the save
                    snap = ckpt.snapshot(state)
                    snap_t = time.time()
                    if primary:
                        ckpt.save_state(snap, last_state)
                elif primary:
                    ckpt.save_state(state, last_state)
            if primary and log_every and (i % log_every == 0
                                          or i == n_batches - 1):
                if vals is None:
                    vals = _fetch(metrics)
                for k, v in vals.items():
                    history.setdefault(k, []).append(v)
                rate = (i + 1 - sb) * batch_size / (time.time() - t0)
                msg = " ".join(f"{k}={v:.4g}" for k, v in vals.items())
                log_fn(f"epoch {epoch}/{epochs} batch {i + 1}/{n_batches} "
                       f"({rate:.3g} samples/s) {msg}")
                if metrics_jsonl:
                    # strict JSON has no NaN/Infinity: non-finite as null
                    safe = {k: (v if math.isfinite(v) else None)
                            for k, v in vals.items()}
                    with open(metrics_jsonl, "a") as f:
                        f.write(json.dumps(
                            {"epoch": epoch, "batch": i + 1,
                             "step": int(state.step),
                             "samples_per_s": round(rate, 4), **safe}) + "\n")
        if primary and loss_plots_dir:
            _save_loss_plot(history, loss_plots_dir, model_name, epoch,
                            batch_size)

        if primary:
            name = ckpt.epoch_checkpoint_name(model_name, epoch, batch_size)
            snap = ckpt.snapshot(state)
            ckpt.save_params(snap["model"],
                             os.path.join(out_dir, name + ".npz"))
            ckpt.save_state(snap, last_state)
            if export_pth:
                ckpt.export_pth(snap["model"],
                                os.path.join(out_dir, name + ".pth"))
    return state
