"""Driver ``train``: a trainer's step fed as ``train/loop.py::run_training``
feeds it: ``data/pipeline.py::BatchLoader`` (shuffled, threaded, one
loader an epoch) and ``device_prefetch``, the loss read back at the loop's
log interval, no checkpoint written.

Set-up builds one train state (the seeded model and Adam) and one step
and drives them through their first three steps, over the window's own
feed; the window then goes on with the same objects.  ``samples_per_s``
counts the samples of the steps completed in the window, which ends with
``torch.cuda.synchronize()``.  Afterwards the plain reference follows the
first three steps from the same weights and batches: each step's loss,
the first gradient's norm by leaf (from Adam's first moment after one
step), and the norm of each leaf's change after three steps."""

import itertools

import torch

from portbench.core import launches
from portbench.core.record import gap_by_leaf
from portbench.core.seeds import sub_seed
from portbench.core.stats import median
from portbench.core.trace import Tracer, span
from portbench.drivers.common import (Phases, now, read_peak, reference,
                                      release, reset_peak, sync)
from portbench.reference import adam as ref_adam
from portbench.reference import common as ref_common

HOOK = "step"   # what ``run_cell``'s hook may stand in for
# what it calls of ``entry/<config>.py``
ENTRY = ("train_objects", "frozen_inputs", "dataset", "reference_loss")
FIRST = 3   # steps the reference follows
BETA1 = 0.9


def feed(ds, batch, seed, workers, prefetch, device, recorded):
    """Batches on the device, epoch after epoch, each epoch's loader and
    prefetch made as ``run_training`` makes them; the first ``FIRST`` host
    batches are kept in ``recorded``."""
    from vst_tpu_torch.data.pipeline import BatchLoader, device_prefetch

    def keep(it):
        for b in it:
            if len(recorded) < FIRST:
                recorded.append(b)
            yield b

    for epoch in itertools.count(1):
        loader = BatchLoader(ds, batch, shuffle=True, seed=seed + epoch,
                             num_workers=workers, epoch=epoch)
        yield from device_prefetch(keep(iter(loader)), prefetch, device)


def _read_loss(metrics):
    """The loop's read of a step's metrics: one transfer."""
    keys = sorted(metrics)
    return torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys]).tolist()


def run(run, entry, traffic, trace, t0, hook):
    phases = Phases(t0)
    dev, cfg, seed = run.device, run.config, run.seed
    ref = reference(run)
    t = cfg["train"]
    b = t["batch_size"]
    phases.mark("imports")
    reset_peak(dev)
    weights = ref.stylizer_weights(cfg, sub_seed(seed, "weights"), dev)
    start_w = {k: v.clone() for k, v in weights.items()}
    state, step = entry.train_objects(cfg, weights, entry.frozen_inputs(
        cfg, seed, dev), dev)
    del weights
    phases.mark("state and step")
    if hook:
        step = hook(HOOK, step, {"run": run})
    ds = entry.dataset(cfg, sub_seed(seed, "traffic"), traffic["items"])
    host_batches = []
    batches = feed(ds, b, sub_seed(seed, "loader") % (1 << 31),
                   traffic["num_workers"], traffic["prefetch"], dev,
                   host_batches)

    names = dict(state.model.named_parameters())
    losses = []
    phases.mark("feed")
    for i in range(FIRST):
        state, m = step(state, next(batches))
        losses.append(m["loss"].detach().reshape(()))
        if i == 0:
            opt = state.optimizer.state
            grads = {k: (opt[p]["exp_avg"] / (1 - BETA1)).norm()
                     if p in opt and "exp_avg" in opt[p] else
                     torch.zeros((), device=p.device)
                     for k, p in names.items()}
    change = {k: (p.detach() - start_w[k]).norm() for k, p in names.items()}
    program = {"loss": torch.stack(losses).tolist(),
               "grad": {k: float(v) for k, v in grads.items()},
               "change": {k: float(v) for k, v in change.items()}}
    del start_w, grads, change
    sync(dev)
    phases.mark(f"first {FIRST} steps")
    tracer = Tracer(trace)
    tracer.warm()
    phases.mark("profiler")
    run.notes.append(phases.note())
    log_every = traffic["log_every"]
    done = FIRST
    launches.reset()
    start = now()
    run.setup_s = start - t0
    end = start + run.seconds
    t_trace = end - min(traffic["trace_seconds"], run.seconds / 2)
    while now() < end:
        if trace and now() >= t_trace:
            tracer.start()
        with span("data_wait"):
            a = now()
            batch = next(batches)
            run.data_wait_s.append(now() - a)
        with span("step"):
            a = now()
            state, m = step(state, batch)
            run.step_dispatch_s.append(now() - a)
        done += 1
        run.steps += 1
        if done % log_every == 0:
            with span("log_read"):
                _read_loss(m)
    sync(dev)
    run.window_s = now() - start
    tracer.stop()
    run.launches = launches.read()
    run.launch_units = ("step", run.steps)
    run.samples = run.steps * b
    run.attempted = run.samples
    run.peak_bytes = read_peak(dev)
    run.trace = tracer.trace
    run.work = {"dtype": t["dtype"]}
    batches.close()
    del state, step, m, batch, batches, names
    release(dev)
    check(run, entry, ref, traffic, host_batches, program)


def check(run, entry, ref, traffic, host_batches, program):
    """The first three steps against the plain float32 reference: the
    widest relative gap of a step's loss, of a leaf's first-gradient norm
    (every leaf) and of a leaf's change norm, leaves measured against their
    own norm or the median leaf's, whichever is larger.  The change leaves
    out the leaves whose reference gradient is under a thousandth of the
    median leaf's: Adam moves a leaf whose gradient is nought to rounding
    (a bias before an instance norm) by its round-off alone.  Their names
    and readings go into the run's notes."""
    dev, cfg, seed = run.device, run.config, run.seed
    ref_common.full_float32()
    params0 = ref.stylizer_weights(cfg, sub_seed(seed, "weights"), dev)
    loss_fn = entry.reference_loss(cfg, entry.frozen_inputs(cfg, seed, dev))
    batches = [tuple(torch.from_numpy(x).to(dev) for x in hb)
               for hb in host_batches]
    losses, grads, change = ref_adam.steps(loss_fn, params0, batches,
                                           cfg["train"]["lr"])
    med_g = median(list(grads.values()))
    held = [k for k, g in grads.items() if g >= 1e-3 * med_g]
    med_c = median([change[k] for k in held])
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(program["loss"], losses))
    limits = traffic["limits"]
    run.check("loss_gap", loss_gap, limits["loss_gap"])
    run.check("grad_gap", gap_by_leaf(program["grad"], grads, list(grads),
                                      med_g), limits["grad_gap"])
    run.check("change_gap", gap_by_leaf(program["change"], change, held,
                                        med_c), limits["change_gap"])
    out = [k for k in grads if k not in held]
    run.notes.append(
        f"change_gap holds {len(held)} of {len(grads)} leaves; left out "
        "(reference gradient / median, gradient gap, change gap): " +
        "; ".join(f"{k} {grads[k] / med_g:.3g} "
                  f"{gap_by_leaf(program['grad'], grads, [k], med_g):.3g} "
                  f"{gap_by_leaf(program['change'], change, [k], med_c):.3g}"
                  for k in out))
    run.notes.append(f"losses program {program['loss']} reference {losses}")
