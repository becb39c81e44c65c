"""What the harness puts in the program's place to show that its checks
fail: the control (the reference, computed a step below the configured
precision) and the planted faults.  Used by ``tools/control.py`` on the
card and by ``tests/``; the benchmark's own runs never load it.

- ``control``: serving, the float32 reference with every product's
  operands rounded to float8 e4m3 (the step below bfloat16); training,
  the plain float32 reference trainer with TF32 on.
- ``unchanged``: the step returns its state as it came (parameters and
  Adam's moments put back).
- ``half``: the step sees the first half of each batch only (the mean
  taken over it).
- ``answer``: each served frame has an 8 × 8 block inverted where it is
  produced.
- ``slot``: the last frame of each served batch is inverted whole, the
  others left sound (a fault of one batch slot)."""

import copy

import numpy as np
import torch

from portbench.reference import common as ref_common


def _serve_control(fn, ctx):
    control = ctx["reference"](ref_common.FP8())

    def in_place(*args):
        with torch.no_grad():
            ref_common.full_float32()
            return control(*args)
    return in_place


def _train_control(step, ctx):
    import importlib

    run = ctx["run"]
    entry = importlib.import_module(f"portbench.entry.{run.cell['config']}")
    loss_fn = entry.reference_loss(run.config, entry.frozen_inputs(
        run.config, run.seed, run.device))

    def control(state, batch):
        ref_common.tf32()
        params = dict(state.model.named_parameters())
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}
    return control


def _unchanged(step, ctx):
    def unchanged(state, batch):
        params = [p.detach().clone() for p in state.model.parameters()]
        opt = copy.deepcopy(state.optimizer.state_dict())
        state, metrics = step(state, batch)
        with torch.no_grad():
            for p, old in zip(state.model.parameters(), params):
                p.copy_(old)
        state.optimizer.load_state_dict(opt)
        return state, metrics
    return unchanged


def _half(step, ctx):
    def half(state, batch):
        return step(state, tuple(x[:x.shape[0] // 2] for x in batch))
    return half


def _answer(fn, ctx):
    def altered(*args):
        out = fn(*args)
        out = out.clone() if isinstance(out, torch.Tensor) else \
            np.array(out)
        out[:, :8, :8] = 255 - out[:, :8, :8]
        return out
    return altered


def _slot(fn, ctx):
    def altered(*args):
        out = fn(*args)
        out = out.clone() if isinstance(out, torch.Tensor) else \
            np.array(out)
        out[-1] = 255 - out[-1]
        return out
    return altered


PLANTS = {("serve", "control"): _serve_control,
          ("step", "control"): _train_control,
          ("step", "unchanged"): _unchanged,
          ("step", "half"): _half,
          ("serve", "answer"): _answer,
          ("serve", "slot"): _slot}

# the faults of each kind of timed path a driver hooks (``HOOK``); no
# cell spans chips, so none leaves out an exchange
FAULTS = {"serve": ("answer", "slot"), "step": ("unchanged", "half")}


def hook(kind):
    """A ``run_cell`` hook that plants ``kind`` in the program's place."""
    def plant(what, obj, ctx):
        return PLANTS[(what, kind)](obj, ctx)
    return plant
