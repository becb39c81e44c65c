"""The port's training loop (``vst_tpu_torch/train/loop.py``): the cases of
tests/test_train_loop.py with a toy step that updates a torch state in
place, plus a mid-epoch resume held bitwise (parameters, Adam state and
data order) against an uninterrupted run with a real Adam.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from vst_tpu_torch.train.checkpoint import load_state
from vst_tpu_torch.train.loop import TrainingPreempted, run_training
from vst_tpu_torch.train.state import TrainState


class _Dataset:
    def __init__(self, n=8):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2), float(i), np.float32)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))


def _state():
    model = _Toy()
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))


def _w(state):
    return state.model.w.detach().numpy().copy()


def _load(path):
    return load_state(str(path), like=_state())


def _toy_step(poison_steps=(), signal_at=None, log=None, loss_from=None):
    """Adds 1 to w per step in place; NaN (loss and parameters, as a real
    divergence) on the poisoned global steps; SIGUSR1 to this process on
    global step ``signal_at`` (a preemption notice arriving while the step
    is in flight); records each batch's first column in ``log``.
    ``loss_from="batch"`` reports a loss of 1 whatever the parameters."""

    def step(state, batch):
        k = state.step
        if k == signal_at:
            os.kill(os.getpid(), signal.SIGUSR1)
        if log is not None:
            log.append(tuple(batch[:, 0, 0].tolist()))
        with torch.no_grad():
            state.model.w += 1.0 + (float("nan") if k in poison_steps
                                    else 0.0)
        state.step += 1
        loss = (torch.tensor(1.0) if loss_from == "batch"
                else state.model.w.detach().sum())
        return state, {"loss": loss}

    return step


def _run(step, state=None, n=8, **kw):
    kw = {"batch_size": 2, "epochs": 1, "export_pth": False, "log_every": 0,
          "num_workers": 0, "model_name": "toy", **kw}
    return run_training(step, state or _state(), _Dataset(n), **kw)


def test_recovers_from_nonfinite_loss(tmp_path, capsys):
    final = _run(_toy_step({2}), out_dir=str(tmp_path), log_every=1)
    out = capsys.readouterr().out
    assert "non-finite loss" in out and "rolled back" in out
    # 4 batches; the poisoned one rolled back to the epoch-start snapshot
    # and was skipped, the 4th ran on finite parameters
    assert np.all(np.isfinite(_w(final)))


def test_gives_up_after_max_recoveries(tmp_path):
    with pytest.raises(RuntimeError, match="recoveries exhausted"):
        _run(_toy_step(set(range(100))), n=16, out_dir=str(tmp_path),
             log_every=1, max_recoveries=2)


@pytest.mark.parametrize("case", ["last_batch", "periodic_save",
                                  "finite_loss_nan_params"])
def test_nonfinite_never_persisted(tmp_path, capsys, case):
    """last_batch: log_every=0 and no periodic saves, the guard still
    checks the epoch's last batch; periodic_save: save_every_steps
    snapshots feed both the rollback and the save; finite_loss_nan_params:
    a backward overflow can NaN the parameters a step before any loss
    shows it, so persist points check the parameters too."""
    step, kw = {
        "last_batch": (_toy_step({3}), {}),
        "periodic_save": (_toy_step({2}), {"save_every_steps": 1}),
        "finite_loss_nan_params": (_toy_step({3}, loss_from="batch"), {}),
    }[case]
    final = _run(step, out_dir=str(tmp_path), **kw)
    assert "rolled back" in capsys.readouterr().out
    assert np.all(np.isfinite(_w(final)))
    assert np.all(np.isfinite(_w(_load(tmp_path / "toy_last_state"))))


def test_preemption_checkpoints_and_raises(tmp_path):
    """SIGUSR1 mid-run: finish the in-flight step, write the resumable
    last_state, raise TrainingPreempted."""
    with pytest.raises(TrainingPreempted) as exc:
        _run(_toy_step(signal_at=1), out_dir=str(tmp_path))
    saved = _load(tmp_path / "toy_last_state")
    # the in-flight step (global step 1 → step counter 2) completed and
    # was persisted: resume loses nothing
    assert saved.step == 2
    np.testing.assert_array_equal(_w(saved), [2.0, 2.0])
    assert exc.value.state.step == 2


def test_preemption_never_persists_nonfinite(tmp_path):
    with pytest.raises(TrainingPreempted):
        _run(_toy_step({2}, signal_at=2), out_dir=str(tmp_path))
    saved = _load(tmp_path / "toy_last_state")
    assert np.all(np.isfinite(_w(saved)))
    assert saved.step == 3    # the rollback keeps the step counter


def test_signal_handlers_restored_after_run(tmp_path):
    before_term = signal.getsignal(signal.SIGTERM)
    before_usr1 = signal.getsignal(signal.SIGUSR1)
    _run(_toy_step(), n=4, out_dir=str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is before_term
    assert signal.getsignal(signal.SIGUSR1) is before_usr1


def test_preemption_handler_can_be_disabled(tmp_path):
    """handle_preemption=False leaves signals to their previous
    disposition (here a recording handler installed by the test)."""
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        final = _run(_toy_step(signal_at=1), out_dir=str(tmp_path),
                     handle_preemption=False)
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert hits == [signal.SIGUSR1]
    assert final.step == 4  # ran to completion


def test_rollback_does_not_rewind_data_position(tmp_path):
    """A rollback restores the parameters but not the step counter, which
    counts batches consumed (the position --resume auto derives)."""
    final = _run(_toy_step({1}), out_dir=str(tmp_path), log_every=1)
    assert final.step == 4
    assert np.all(np.isfinite(_w(final)))
    assert _load(tmp_path / "toy_last_state").step == 4


def test_resume_after_rollback_and_preempt_keeps_data_order(tmp_path):
    """Rollback + preemption: the interrupted run skips the poisoned
    batch's update but still consumes it, so the resumed run continues at
    the true data position."""
    full, log1, log2 = [], [], []
    _run(_toy_step(log=full), out_dir=str(tmp_path / "a"), seed=9)
    with pytest.raises(TrainingPreempted):
        _run(_toy_step({1}, signal_at=2, log=log1),
             out_dir=str(tmp_path / "b"), log_every=1, seed=9)
    saved = _load(tmp_path / "b" / "toy_last_state")
    assert saved.step == 3  # 3 batches consumed, the skipped one included
    _run(_toy_step(log=log2), saved, epoch_start=saved.step // 4 + 1,
         out_dir=str(tmp_path / "b"), seed=9, start_batch=saved.step % 4)
    assert log1 + log2 == full


@pytest.mark.parametrize("every_s,expect_w", [(0.0, 3.0), (60.0, 0.0)])
def test_snapshot_refresh_at_log_points(tmp_path, capsys, every_s, expect_w):
    """Without periodic saves a passing log check advances the rollback
    snapshot, at most once per snapshot_every_s: at 0 a late NaN rolls back
    to the last log point (w = 3 after steps 0-2), at the default 60 s the
    toy's microsecond steps never reach the floor and it rolls back to the
    epoch start (w = 0)."""
    final = _run(_toy_step({3}), out_dir=str(tmp_path), log_every=1,
                 snapshot_every_s=every_s)
    assert "rolled back" in capsys.readouterr().out
    assert float(_w(final)[0]) == expect_w


def test_metrics_jsonl_sink(tmp_path):
    """One record per logged step, appended across runs."""
    path = str(tmp_path / "metrics.jsonl")
    _run(_toy_step(), out_dir=str(tmp_path), epochs=2, log_every=1,
         metrics_jsonl=path)
    records = [json.loads(line) for line in open(path)]
    assert len(records) == 8  # 4 batches x 2 epochs, log_every=1
    assert records[0]["epoch"] == 1 and records[0]["batch"] == 1
    assert records[-1]["epoch"] == 2 and records[-1]["batch"] == 4
    assert [r["step"] for r in records] == list(range(1, 9))
    assert all("loss" in r and "samples_per_s" in r for r in records)
    _run(_toy_step(), out_dir=str(tmp_path), log_every=1, metrics_jsonl=path)
    assert len(open(path).readlines()) == 12


def test_metrics_jsonl_nonfinite_encoded_as_null(tmp_path):
    """Non-finite metric values serialize as strict-JSON null."""

    def step(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(1.0),
                       "SDL": torch.tensor(float("nan"))}

    path = str(tmp_path / "metrics.jsonl")
    _run(step, n=4, out_dir=str(tmp_path), log_every=1, metrics_jsonl=path,
         recover_nonfinite=False)
    lines = open(path).read().splitlines()
    assert lines
    for line in lines:  # strict parse — raises on a bare NaN literal
        rec = json.loads(line, parse_constant=lambda c: pytest.fail(
            f"non-strict JSON constant {c!r} in metrics line"))
        assert rec["SDL"] is None and rec["loss"] == 1.0


def test_metrics_jsonl_creates_parent_dir(tmp_path):
    path = str(tmp_path / "logs" / "deeper" / "metrics.jsonl")
    _run(_toy_step(), n=4, out_dir=str(tmp_path), log_every=1,
         metrics_jsonl=path)
    assert os.path.exists(path)


def test_resume_mid_epoch_continues_exact_data_order(tmp_path):
    """Preempt mid-epoch, resume with start_batch (as cli.train --resume
    auto derives it): the combined run sees exactly the uninterrupted
    epoch's batches."""
    full, part1, part2 = [], [], []
    _run(_toy_step(log=full), out_dir=str(tmp_path / "a"), seed=5)
    assert len(full) == 4
    with pytest.raises(TrainingPreempted):
        _run(_toy_step(signal_at=1, log=part1), out_dir=str(tmp_path / "b"),
             seed=5)
    saved = _load(tmp_path / "b" / "toy_last_state")
    _run(_toy_step(log=part2), saved, epoch_start=saved.step // 4 + 1,
         out_dir=str(tmp_path / "b"), seed=5, start_batch=saved.step % 4)
    assert part1 + part2 == full


def test_guard_disabled_passes_nan_through(tmp_path):
    final = _run(_toy_step({1}), n=4, out_dir=str(tmp_path), log_every=1,
                 recover_nonfinite=False)
    assert not np.all(np.isfinite(_w(final)))


def test_epoch_checkpoints_written(tmp_path):
    """Each epoch writes the reference-named .npz (JAX layout) and .pth
    and the resumable state; the loss plot when asked."""
    pytest.importorskip("matplotlib")
    _run(_toy_step(), out_dir=str(tmp_path), epochs=2, log_every=1,
         export_pth=True, loss_plots_dir=str(tmp_path / "plots"))
    for e in (1, 2):
        name = f"toy_epoch_{e}_batchSize_2"
        with np.load(tmp_path / f"{name}.npz") as z:
            np.testing.assert_array_equal(z["w"], [4.0 * e] * 2)
        assert torch.load(tmp_path / f"{name}.pth")["w"].tolist() == [4.0 * e] * 2
        assert (tmp_path / "plots" / f"{name}_loss.png").exists()
    assert _load(tmp_path / "toy_last_state").step == 8


# ----------------------------------------- bitwise resume with a real Adam

class _Pairs:
    """(x, y) float32 samples from a per-item generator, with set_epoch, as
    the AdaAttN datasets draw them."""

    def __init__(self, n=12):
        self.n, self._epoch = n, 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng((3, self._epoch, idx))
        return (rng.standard_normal(4).astype(np.float32),
                rng.standard_normal(2).astype(np.float32))


def _adam_state():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-2))


def _adam_step(log, signal_at=None):
    def step(state, batch):
        if state.step == signal_at:
            os.kill(os.getpid(), signal.SIGUSR1)
        x, y = batch
        log.append(x.numpy().tobytes())
        state.optimizer.zero_grad()
        loss = ((state.model(x) - y) ** 2).mean()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}
    return step


@pytest.mark.parametrize("signal_at", [1, 4])
def test_resume_mid_epoch_is_bitwise(tmp_path, signal_at):
    """A run preempted mid-epoch (step 1: epoch 1 batch 2; step 4: epoch 2
    batch 1, just after an epoch boundary) and resumed from its saved
    state consumes the same batches in the same order and ends with the
    parameters and Adam state (moments and per-parameter step) of the
    uninterrupted run, bit for bit."""
    kw = {"batch_size": 3, "epochs": 3, "export_pth": False, "log_every": 1,
          "num_workers": 2, "model_name": "lin", "seed": 4}
    full_log, part = [], []
    full = run_training(_adam_step(full_log), _adam_state(), _Pairs(),
                        out_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(TrainingPreempted):
        run_training(_adam_step(part, signal_at), _adam_state(), _Pairs(),
                     out_dir=str(tmp_path / "b"), **kw)
    resumed = load_state(str(tmp_path / "b" / "lin_last_state"),
                         like=_adam_state())
    assert resumed.step == signal_at + 1
    resumed = run_training(_adam_step(part), resumed, _Pairs(),
                           out_dir=str(tmp_path / "b"),
                           epoch_start=resumed.step // 4 + 1,
                           start_batch=resumed.step % 4, **kw)
    assert part == full_log and len(full_log) == 12
    assert resumed.step == full.step == 12
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], sb["state"][i][key]), (i, key)
