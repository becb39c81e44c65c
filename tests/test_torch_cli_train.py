"""The port's training CLI (``vst_tpu_torch/cli/train.py``) on the CPU at a
small size: the AdaAttN image trainer at 32×32 crops and the video
trainer at 32×64 frames, batch 2, two steps an epoch, from synthetic PNG
folders.  A preempted run resumed with ``--resume auto`` equals an
uninterrupted one bit for bit; the port's per-step losses match the JAX
CLI's on the same folders and seed, and a JAX mid-run state carried
across with ``compat.train_state_from_jax`` continues to JAX's losses.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from vst_tpu_torch.cli import train as cli
from vst_tpu_torch.train import steps

SEED = 3


def _write(path, rng, size_wh):
    arr = rng.integers(0, 256, (size_wh[1], size_wh[0], 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """coco/ and wiki/ (4 and 3 images), and a Videvo tree of two clips of
    three 64×32 frames (4 frame pairs)."""
    root = tmp_path_factory.mktemp("folders")
    rng = np.random.default_rng(0)
    for name, n in (("coco", 4), ("wiki", 3)):
        (root / name).mkdir()
        for i in range(n):
            _write(str(root / name / f"{i}.png"), rng, (48, 40))
    for clip in range(2):
        d = root / "videvo" / "frames" / f"{clip:05d}"
        d.mkdir(parents=True)
        for i in range(3):
            _write(str(d / f"{i:05d}.png"), rng, (64, 32))
    return root


def _args(folders, kind, out_dir, epochs=2):
    data = ("coco,wiki" if kind == "image" else "videvo,wiki").split(",")
    return ["--trainer", f"adaattn-{kind}", "--device", "cpu",
            "--data", ",".join(str(folders / d) for d in data),
            "--out-dir", str(out_dir), "--epochs", str(epochs),
            "--batch-size", "2", "--seed", str(SEED), "--log-every", "1",
            "--img-size", *(("32", "32") if kind == "image" else ("32", "64")),
            "--metrics-jsonl", str(out_dir / "metrics.jsonl")]


def _recording(monkeypatch, kind, seen, preempt_at=None):
    """Wrap the step builder: each step records its batch's sums (exact:
    the pixels are integers) and, at global step ``preempt_at[0]``, sends
    SIGUSR1 to this process while the step is in flight."""
    name = f"make_adaattn_{kind}_step"
    build = getattr(steps, name)

    def wrapped_build(cfg, vgg):
        step = build(cfg, vgg)

        def wrapped(state, batch):
            if preempt_at and state.step == preempt_at[0]:
                os.kill(os.getpid(), signal.SIGUSR1)
            seen.append(tuple(float(x.double().sum()) for x in batch))
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(steps, name, wrapped_build)


def _records(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _state_tensors(path):
    obj = torch.load(path, weights_only=True)
    out = dict(obj["model"])
    for i, st in obj["optimizer"]["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return obj["step"], out


@pytest.fixture(scope="module")
def uninterrupted(folders, tmp_path_factory):
    """``get(kind)``: the uninterrupted 2-epoch run of a trainer, run once
    for the module: (out dir, the batches' sums in step order)."""
    runs = {}

    def get(kind):
        if kind not in runs:
            out = tmp_path_factory.mktemp(f"full_{kind}")
            seen = []
            with pytest.MonkeyPatch.context() as mp:
                _recording(mp, kind, seen)
                cli.main(_args(folders, kind, out))
            runs[kind] = out, seen
        return runs[kind]

    return get


KINDS = ["image", "video"]


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_load_in_jax(uninterrupted, kind):
    """Each epoch's .npz (JAX layout) loads with the JAX package's
    load_params and equals the epoch's .pth; the last state is at step
    4."""
    from vst_tpu.train.checkpoint import load_params

    out, _ = uninterrupted(kind)
    for epoch in (1, 2):
        name = f"adaattn-{kind}_epoch_{epoch}_batchSize_2"
        jparams = load_params(str(out / f"{name}.npz"))
        pth = torch.load(out / f"{name}.pth", weights_only=True)
        assert set(jparams) == set(pth)
        for k, v in pth.items():
            ref = v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v
            np.testing.assert_array_equal(np.asarray(jparams[k]), ref)
    step, _ = _state_tensors(out / f"adaattn-{kind}_last_state")
    assert step == 4
    records = _records(out)
    assert sorted(records) == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in records.values())


@pytest.mark.parametrize("kind", KINDS)
def test_preempted_run_resumes_bitwise(uninterrupted, folders, tmp_path,
                                       monkeypatch, capsys, kind):
    """SIGUSR1 during step 1 (image: the epoch's last batch) or step 2
    (video: mid-epoch 2) exits 0 with the state saved; ``--resume auto``
    then continues at the saved step's position and ends where the
    uninterrupted run ends: the same batches in the same order, the same
    logged losses, the same model and Adam state, bit for bit."""
    full_out, full_seen = uninterrupted(kind)
    at = 1 if kind == "image" else 2
    seen, preempt_at = [], [at]
    _recording(monkeypatch, kind, seen, preempt_at)
    args = _args(folders, kind, tmp_path) + ["--resume", "auto"]
    with pytest.raises(SystemExit) as exc:
        cli.main(args)
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "starting fresh" in out and "preempted: SIGUSR1" in out
    preempt_at.clear()
    cli.main(args)
    line = ("auto-resume: step 2 → epoch 2" if kind == "image"
            else "auto-resume: step 3 → epoch 2 batch 2")
    assert line in capsys.readouterr().out.splitlines()
    assert seen == full_seen and len(seen) == 4
    full, ours = _records(full_out), _records(tmp_path)
    assert set(ours) == set(full) - {at + 1}   # the preempted step: no log
    for s, rec in ours.items():
        assert {k: v for k, v in rec.items() if k != "samples_per_s"} == \
            {k: v for k, v in full[s].items() if k != "samples_per_s"}
    step_a, a = _state_tensors(full_out / f"adaattn-{kind}_last_state")
    step_b, b = _state_tensors(tmp_path / f"adaattn-{kind}_last_state")
    assert step_a == step_b == 4 and a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("argv,match", [
    (["--trainer", "reconet-candy"], "--style is required"),
    (["--trainer", "reconet-sd1", "--style", "s.png"],
     "--teacher-weights is required"),
    # RTNSTV trains since its slice: a step on a two-frame Videvo tree
    (["--trainer", "rtnstv", "--data-format", "videvo"], None),
    (["--trainer", "adaattn-image", "--data-parallel", "2"], "item 20"),
    (["--trainer", "adaattn-video", "--multihost"], "item 20"),
])
def test_unported_options_exit_cleanly(argv, match, tmp_path):
    if match is None:
        rng = np.random.default_rng(0)
        frames = tmp_path / "videvo" / "frames" / "00000"
        frames.mkdir(parents=True)
        for i in range(2):
            _write(str(frames / f"{i:05d}.png"), rng, (32, 24))
        for sub, name in (("front", "00000_01"), ("back", "00001_10")):
            (tmp_path / "videvo" / "flow" / "00000" / sub).mkdir(parents=True)
            np.save(tmp_path / "videvo" / "flow" / "00000" / sub / name,
                    rng.standard_normal((24, 32, 2)).astype(np.float32))
        _write(str(tmp_path / "style.png"), rng, (32, 24))
        cli.main(argv + ["--data", str(tmp_path / "videvo"), "--style",
                         str(tmp_path / "style.png"), "--out-dir",
                         str(tmp_path / "out"), "--epochs", "1",
                         "--batch-size", "1", "--device", "cpu"])
        assert (tmp_path / "out" / "rtnstv_epoch_1_batchSize_1.npz").exists()
        return
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["--data", "x,y", "--device", "cpu"])


def test_defaults_to_the_card(folders, tmp_path):
    """Without --device the CLI runs on CUDA, and raises where there is
    none (never a silent CPU run)."""
    if torch.cuda.is_available():
        assert cli.build_parser().parse_args(
            ["--trainer", "adaattn-image", "--data", "a,b"]).device == "cuda"
        return
    args = [a for a in _args(folders, "image", tmp_path)]
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


# ------------------------------------------------ against the JAX CLI


@pytest.fixture(scope="module")
def jax_runs(folders, tmp_path_factory):
    """The JAX CLI on the same folders and seed: epoch 1, then epoch 2
    resumed from its state (``--resume auto``)."""
    from vst_tpu.cli import train as jcli

    out = tmp_path_factory.mktemp("jax")
    args = _args(folders, "image", out, epochs=1)
    args[args.index("--device"):args.index("--device") + 2] = [
        "--platform", "cpu"]
    jcli.main(args)
    state_dir = out / "epoch1_state"
    import shutil

    shutil.copytree(out / "adaattn-image_last_state", state_dir)
    jcli.main(args[:args.index("--epochs")] + ["--epochs", "2"]
              + args[args.index("--epochs") + 2:] + ["--resume", "auto"])
    return _records(out), state_dir


LOSSES = ("loss", "loss_gs", "loss_lf")


def test_cli_losses_match_jax(uninterrupted, jax_runs):
    """The image trainer: every logged step's loss terms within rtol 2e-3
    (the tolerance of
    tests/test_torch_adaattn_train.py::test_step_metrics_match_jax).  The
    JAX video CLI crops the style at 256×512 whatever the frame size, so
    it runs only at full size; the video step is held against JAX's in
    test_torch_adaattn_train.py."""
    ours, ref = _records(uninterrupted("image")[0]), jax_runs[0]
    assert sorted(ours) == sorted(ref) == [1, 2, 3, 4]
    for s in ref:
        for k in LOSSES:
            np.testing.assert_allclose(ours[s][k], ref[s][k], rtol=2e-3,
                                       err_msg=f"step {s} {k}")


def test_jax_state_carried_across_continues_as_jax(jax_runs, folders,
                                                   tmp_path, capsys):
    """JAX's state after epoch 1 (orbax) → ``train_state_from_jax`` →
    the port's ``save_state``; ``--resume auto`` continues epoch 2 to
    JAX's own continuation's losses within rtol 2e-3."""
    from vst_tpu.models import adaattn as ja
    from vst_tpu.train.checkpoint import load_state
    from vst_tpu.train.state import create, make_optimizer
    from vst_tpu_torch.compat import train_state_from_jax
    from vst_tpu_torch.train.checkpoint import save_state

    records, state_dir = jax_runs
    like = create(ja.init_stylizing_network(SEED), make_optimizer(1e-4))
    jstate = load_state(str(state_dir), like=like)
    adam = jstate.opt_state[0]
    to_np = lambda d: {k: np.array(v) for k, v in d.items()}
    state = train_state_from_jax(to_np(jstate.params), to_np(adam.mu),
                                 to_np(adam.nu), np.array(adam.count), 1e-4,
                                 device="cpu")
    assert state.step == int(jstate.step) == 2
    save_state(state, str(tmp_path / "adaattn-image_last_state"))
    cli.main(_args(folders, "image", tmp_path) + ["--resume", "auto"])
    assert "auto-resume: step 2 → epoch 2" in capsys.readouterr().out
    ours = _records(tmp_path)
    assert sorted(ours) == [3, 4]
    for s in ours:
        for k in LOSSES:
            np.testing.assert_allclose(ours[s][k], records[s][k], rtol=2e-3,
                                       err_msg=f"step {s} {k}")
