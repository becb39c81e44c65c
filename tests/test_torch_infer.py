"""The port's streaming loop, CLI, device rules and import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vst_tpu.infer.video import StreamingStylizer as JStreamingStylizer
from vst_tpu_torch.infer.video import StreamingStylizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames(n, h=4, w=6):
    return [np.full((h, w, 3), i, np.uint8) + np.arange(w, dtype=np.uint8)[:, None]
            for i in range(n)]


def newest(batch):
    return np.asarray(batch)[..., -3:].copy()


@pytest.mark.parametrize("n,ifn,bs,first,depth", [
    (11, 1, 4, None, 3),     # ragged tail (11 = 4 + 4 + 3)
    (9, 3, 2, None, 2),      # three-frame window
    (10, 2, 3, 5, 1),        # first_frame skip
    (2, 3, 2, None, 3),      # fewer frames than the window
])
def test_matches_jax_stylizer(n, ifn, bs, first, depth):
    src = frames(n)
    seen = []

    def model_fn(batch):
        seen.append(tuple(batch.shape))
        return newest(batch)

    ours = list(StreamingStylizer(model_fn, iter(src), ifn, bs, first,
                                  pipeline_depth=depth, device="cpu"))
    ref = list(JStreamingStylizer(newest, iter(src), ifn, bs, first,
                                  pipeline_depth=depth))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(set(seen)) <= 1   # the tail is padded to one shape


def test_i420_wire_matches_jax(rng):
    cv2 = pytest.importorskip("cv2")
    from vst_tpu_torch.ops.yuv import rgb_to_i420

    clip = [rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
            for _ in range(7)]

    def model_i420(batch):
        return rgb_to_i420(torch.as_tensor(np.asarray(batch)))

    ours = list(StreamingStylizer(model_i420, iter(clip), 1, 3, wire="i420",
                                  device="cpu"))
    assert len(ours) == len(clip)
    for a, b in zip(ours, clip):
        ref = cv2.cvtColor(cv2.cvtColor(b, cv2.COLOR_RGB2YUV_I420),
                           cv2.COLOR_YUV2RGB_I420)
        np.testing.assert_array_equal(a, ref)


class TestNoCard:
    """Entry points default to CUDA and raise without it; nothing runs on
    the CPU unless the caller asks."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_init_raises(self):
        from vst_tpu_torch.models import reconet

        with pytest.raises(RuntimeError, match="no CUDA device"):
            reconet.init_reconet(0)

    def test_streaming_raises_before_reading(self):
        def never(batch):
            raise AssertionError("ran on the CPU")

        src = iter(frames(3))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingStylizer(never, src, 1, 2)
        assert len(list(src)) == 3

    def test_cli_raises(self, tmp_path):
        from vst_tpu_torch.cli import infer_video

        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer_video.main(["--model", "reconet", "--weights",
                              str(tmp_path / "missing.pth"),
                              "--video", str(tmp_path / "missing.avi")])


def test_cli_rejects_unported(tmp_path, capsys):
    """--data-parallel is refused; --model rtnstv runs since RTNSTV's
    slice and writes its frames."""
    from vst_tpu_torch.cli import infer_video

    with pytest.raises(SystemExit, match="not ported"):
        infer_video.main(["--model", "reconet", "--data-parallel", "2",
                          "--weights", "w.pth", "--video", "v.avi",
                          "--device", "cpu"])
    from vst_tpu.models.rtnstv import init_stylizing_network
    from vst_tpu.train.checkpoint import save_params

    weights = str(tmp_path / "rtnstv.npz")
    save_params(init_stylizing_network(0), weights)
    infer_video.main(["--model", "rtnstv", "--weights", weights, "--video",
                      _mjpg(tmp_path / "in.avi", n=2), "--size", "32", "24",
                      "--frames-dir", str(tmp_path / "frames"),
                      "--device", "cpu"])
    assert "2 frames" in capsys.readouterr().out
    assert len(list((tmp_path / "frames").glob("*.jpg"))) == 2


def _mjpg(path, n=5, w=32, h=24):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    vw.release()
    return str(path)


@pytest.mark.parametrize("extra,width", [
    (["--wire", "i420"], 32),
    (["--weights2", "{w}", "--model2", "sd2"], 64),   # side by side
])
def test_cli_end_to_end_cpu(tmp_path, capsys, extra, width):
    from PIL import Image
    from vst_tpu.models.reconet import init_reconet_sd2
    from vst_tpu.train.checkpoint import save_params
    from vst_tpu_torch.cli import infer_video

    video = _mjpg(tmp_path / "in.avi")
    weights = str(tmp_path / "sd2.npz")
    save_params(init_reconet_sd2(0), weights)
    out_dir = tmp_path / "frames"
    infer_video.main(["--model", "sd2", "--weights", weights, "--video", video,
                      "--size", "32", "24", "--batch-size", "2",
                      "--frames-dir", str(out_dir), "--device", "cpu",
                      *[e.format(w=weights) for e in extra]])
    assert "5 frames" in capsys.readouterr().out
    dumped = sorted(out_dir.glob("*.jpg"))
    assert len(dumped) == 5
    assert Image.open(dumped[0]).size == (width, 24)


def test_cli_frames_ext_png_is_lossless(tmp_path):
    """--frames-ext png dumps exactly the frames stylize_reconet gives for
    the decoded, resized input (one frame a batch, from a written .npz of
    seeded weights); without the flag the dump stays .jpg, as in JAX."""
    from PIL import Image
    from vst_tpu.models.reconet import init_reconet
    from vst_tpu.train.checkpoint import save_params
    from vst_tpu_torch.cli import infer_video
    from vst_tpu_torch.infer.image import stylize_reconet
    from vst_tpu_torch.infer.video import frames_from_source

    video = _mjpg(tmp_path / "in.avi", n=3)
    weights = str(tmp_path / "reconet.npz")
    save_params(init_reconet(0), weights)
    common = ["--model", "reconet", "--weights", weights, "--video", video,
              "--size", "32", "24", "--batch-size", "1", "--device", "cpu"]
    infer_video.main(common + ["--frames-dir", str(tmp_path / "png"),
                               "--frames-ext", "png"])
    dumped = sorted((tmp_path / "png").iterdir())
    assert [f.name for f in dumped] == ["00000.png", "00001.png", "00002.png"]
    model = infer_video._load_model("reconet", weights, 1, torch.device("cpu"))
    frames = list(frames_from_source(video, (32, 24), "linear"))
    assert len(frames) == 3
    for f, frame in zip(dumped, frames):
        ref = stylize_reconet(model, np.asarray(frame)[None], uint8_out=True)
        np.testing.assert_array_equal(np.asarray(Image.open(f)),
                                      ref[0].numpy())
    infer_video.main(common + ["--frames-dir", str(tmp_path / "jpg")])
    assert sorted(f.name for f in (tmp_path / "jpg").iterdir()) == [
        "00000.jpg", "00001.jpg", "00002.jpg"]


def test_native_decoder_matches_jax_binding(tmp_path):
    """The port's own ctypes binding decodes what vst_tpu's does (both are
    None when native/libvstvideo.so is not built)."""
    from vst_tpu.data import video_native as jnative
    from vst_tpu_torch.data import video_native as pnative

    video = _mjpg(tmp_path / "in.avi", n=3)
    ref = jnative.open_video(video, 2)   # builds the library when it can
    ours = pnative.open_video(video, 2)
    if ref is None or ours is None:
        assert pnative.available() == (ours is not None)
        pytest.skip("native/libvstvideo.so not built (make -C native)")
    with ours, ref:
        a, b = list(ours.frames(2)), list(ref.frames(2))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_imports_stay_off_jax():
    """Every module of the port and chip_smoke.py's imports load without
    JAX or any vst_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vst_tpu_torch\n"
        "for m in pkgutil.walk_packages(vst_tpu_torch.__path__, 'vst_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'vst_tpu.'))"
        " or m == 'vst_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
