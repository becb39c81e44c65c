"""RTNSTV through the port's CLIs on the CPU at a small size:
``cli.train --trainer rtnstv`` for an epoch at 24×32 on a synthetic
SceneFlow tree and on a Videvo tree (``--data-format videvo``), its
checkpoints loaded by the JAX package, a preempted run; and
``cli.infer_image`` / ``cli.infer_video --model rtnstv`` (with
``--weights2 --model2 rtnstv`` side by side) on seeded weights."""

import os
import signal

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from vst_tpu_torch.cli import train as cli
from vst_tpu_torch.train import steps
from tests.test_torch_cli_train import _records, _write


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A SceneFlow root (Monkaa and FlyingThings3D scenes of 5 frames at
    32×24: 8 samples), a Videvo root (6 frames with .npy flows: 5
    samples), a style image and a JAX ``.npz`` of a seeded RTNSTV."""
    from tests import test_data
    from vst_tpu.models.rtnstv import init_stylizing_network
    from vst_tpu.train.checkpoint import save_params

    root = tmp_path_factory.mktemp("rtnstv_data")
    rng = np.random.default_rng(1)
    test_data._make_sceneflow_scene(str(root / "sceneflow" / "monkaa"), rng,
                                    5, "monkaa")
    test_data._make_sceneflow_scene(
        str(root / "sceneflow" / "flyingthings3d"), rng, 5, "ft3d")
    test_data.TestVideoDatasets()._make_videvo(str(root / "videvo"), rng)
    _write(str(root / "style.png"), rng, (50, 40))
    save_params(init_stylizing_network(2), str(root / "rtnstv.npz"))
    return root


def _args(data, out_dir, fmt="sceneflow", epochs=1):
    return ["--trainer", "rtnstv", "--device", "cpu",
            "--data", str(data / fmt), "--data-format", fmt,
            "--style", str(data / "style.png"), "--out-dir", str(out_dir),
            "--epochs", str(epochs), "--batch-size", "2", "--seed", "4",
            "--img-size", "24", "32", "--log-every", "1",
            "--metrics-jsonl", str(out_dir / "metrics.jsonl")]


@pytest.mark.parametrize("fmt,n_steps", [("sceneflow", 4), ("videvo", 2)])
def test_trainer_writes_checkpoints_jax_loads(data, tmp_path, fmt, n_steps):
    """An epoch: finite CL/SL/RL/TL/loss at every step, the epoch's .npz
    (JAX layout), .pth (reference layout) and ``_last_state``.  The JAX
    package reads both files to the same parameters (the decoders'
    weights flipped on the .npz side), and JAX's forward on them matches
    the port's on the .pth within 1e-3."""
    from vst_tpu.compat import load_pth as j_load_pth
    from vst_tpu.models.rtnstv import stylizing_network
    from vst_tpu.train.checkpoint import load_params
    from vst_tpu_torch.compat import load_weights
    from vst_tpu_torch.models import rtnstv

    cli.main(_args(data, tmp_path, fmt))
    records = _records(tmp_path)
    assert sorted(records) == list(range(1, n_steps + 1))
    for rec in records.values():
        assert {"CL", "SL", "RL", "TL", "loss"} <= set(rec)
        assert all(v is not None and np.isfinite(v) for v in rec.values())
    name = "rtnstv_epoch_1_batchSize_2"
    assert (tmp_path / "rtnstv_last_state").exists()
    jparams = load_params(str(tmp_path / f"{name}.npz"))
    from_pth = j_load_pth(str(tmp_path / f"{name}.pth"))
    assert set(jparams) == set(from_pth)
    for k, v in from_pth.items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), v, err_msg=k)
    x = (np.random.default_rng(0).random((1, 24, 32, 3)) * 255).astype(
        np.float32)
    ref = np.asarray(stylizing_network(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(x)))
    model = rtnstv.build(load_weights(str(tmp_path / f"{name}.pth")),
                         device="cpu")
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


def test_preempted_run_exits_zero_and_resumes(data, tmp_path, monkeypatch,
                                             capsys):
    """SIGUSR1 during step 2 exits 0 once the step is done, with the
    state saved at step 2; ``--resume auto`` continues from it to the end
    of the epoch (the preempted step logs nothing)."""
    build = steps.make_rtnstv_step

    def wrapped_build(cfg, vgg, grams):
        step = build(cfg, vgg, grams)

        def wrapped(state, batch):
            if preempt and state.step == 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(steps, "make_rtnstv_step", wrapped_build)
    preempt = True
    args = _args(data, tmp_path) + ["--resume", "auto"]
    with pytest.raises(SystemExit) as exc:
        cli.main(args)
    assert exc.value.code == 0
    assert "preempted: SIGUSR1" in capsys.readouterr().out
    assert (tmp_path / "rtnstv_last_state").exists()
    preempt = False
    cli.main(args)
    assert "auto-resume: step 2 → epoch 1 batch 3" in capsys.readouterr().out
    assert sorted(_records(tmp_path)) == [1, 3, 4]   # step 2: no log
    assert (tmp_path / "rtnstv_epoch_1_batchSize_2.npz").exists()


def test_infer_image(data, tmp_path):
    """``infer_image --model rtnstv`` on a .npz: the png equals
    ``stylize_rtnstv`` of the loaded content, and JAX's within one step
    (the truncating cast)."""
    from vst_tpu.infer.image import stylize_rtnstv as j_stylize
    from vst_tpu.models.rtnstv import init_stylizing_network
    from vst_tpu_torch.cli import infer_image
    from vst_tpu_torch.cli.common import load_image_255

    content = str(data / "style.png")
    infer_image.main(["--model", "rtnstv", "--weights",
                      str(data / "rtnstv.npz"), "--content", content,
                      "--size", "24", "32", "--out", str(tmp_path),
                      "--device", "cpu"])
    got = np.asarray(Image.open(tmp_path / "stylized.png"))
    x = load_image_255(content, (32, 24))[None]
    ref = np.asarray(j_stylize(init_stylizing_network(2), jnp.asarray(x)))
    assert got.shape == (24, 32, 3)
    assert np.abs(got.astype(int) - ref[0].astype(np.uint8)).max() <= 1


def _mjpg(path, n=4, w=32, h=24):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (w, h))
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    vw.release()
    return str(path)


@pytest.mark.parametrize("extra,width", [
    ([], 32), (["--wire", "i420"], 32),
    (["--weights2", "{w}", "--model2", "rtnstv"], 64)])
def test_infer_video(data, tmp_path, capsys, extra, width):
    """``infer_video --model rtnstv``: png frames within one step of
    ``stylize_rtnstv`` on the decoded frames (rgb), the I420 wire's
    frames (those through cv2's 4:2:0 round trip), and the side-by-side
    comparison with a second RTNSTV checkpoint (each half its model's
    frames)."""
    from vst_tpu_torch.cli import infer_video
    from vst_tpu_torch.infer.image import stylize_rtnstv
    from vst_tpu_torch.infer.video import frames_from_source

    video = _mjpg(tmp_path / "in.avi")
    weights = str(data / "rtnstv.npz")
    out_dir = tmp_path / "frames"
    infer_video.main(["--model", "rtnstv", "--weights", weights, "--video",
                      video, "--size", "32", "24", "--batch-size", "2",
                      "--frames-dir", str(out_dir), "--frames-ext", "png",
                      "--device", "cpu",
                      *[e.format(w=weights) for e in extra]])
    assert "4 frames" in capsys.readouterr().out
    dumped = sorted(out_dir.iterdir())
    assert [f.name for f in dumped] == [f"{i:05d}.png" for i in range(4)]
    model = infer_video._load_model("rtnstv", weights, 1, torch.device("cpu"))
    frames = list(frames_from_source(video, (32, 24), "linear"))
    for f, frame in zip(dumped, frames):
        got = np.asarray(Image.open(f))
        assert got.shape == (24, width, 3)
        ref = stylize_rtnstv(model, np.asarray(frame)[None],
                             uint8_out=True)[0].numpy()
        # the CLI's batches of two may sum in another order than the
        # reference's batch of one: the truncating cast moves one step
        if extra[:1] == ["--wire"]:   # the frame through cv2's I420
            import cv2

            ref = cv2.cvtColor(cv2.cvtColor(ref, cv2.COLOR_RGB2YUV_I420),
                               cv2.COLOR_YUV2RGB_I420)
            assert np.abs(got.astype(int) - ref).max() <= 2
        else:
            assert np.abs(got[:, :32].astype(int) - ref).max() <= 1
            assert np.abs(got[:, 32:].astype(int)
                          - ref[:, :width - 32]).max(initial=0) <= 1
