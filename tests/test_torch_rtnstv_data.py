"""RTNSTV's data in the port (``vst_tpu_torch/data/datasets.py``:
``VidevoFlow``, ``get_frames``, ``calculate_optical_flow``; and
``vst_tpu_torch/cli/preprocess.py``) against the JAX package's on the
same synthetic files: samples, frames and flows bit for bit."""

import os

import numpy as np
import pytest

from vst_tpu.data import datasets as jd
from vst_tpu_torch.data import datasets as pd
from tests import test_data


@pytest.mark.parametrize("frame_num", [1, 2])
def test_videvo_flow_bitwise(tmp_path, frame_num):
    """Every sample of the synthetic Videvo tree of tests/test_data.py
    (one clip of 6 frames, .npy flows) bit for bit: the frame windows,
    the backward flow and the forward-backward consistency mask."""
    test_data.TestVideoDatasets()._make_videvo(str(tmp_path),
                                               np.random.default_rng(4))
    ref = jd.VidevoFlow(str(tmp_path), frame_num=frame_num)
    ours = pd.VidevoFlow(str(tmp_path), frame_num=frame_num)
    assert len(ours) == len(ref) == 6 - frame_num
    assert ours.frames == ref.frames and ours.flow == ref.flow
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    img1, img2, flow, mask = ours[0]
    assert img1.shape == img2.shape == (24, 32, 3 * frame_num)
    assert flow.shape == (24, 32, 2) and mask.shape == (24, 32)


@pytest.fixture
def videos(tmp_path):
    """A directory with one MJPG clip of 5 frames (64×48), a texture that
    moves 3 pixels a frame."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    vdir = tmp_path / "videos"
    vdir.mkdir()
    w, h = 64, 48
    vw = cv2.VideoWriter(str(vdir / "clip.avi"),
                         cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    for i in range(5):
        vw.write(np.roll(base, i * 3, axis=1))
    vw.release()
    return vdir


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_frames_and_flow_bitwise(tmp_path, videos):
    """``get_frames`` (INTER_AREA to 32×24) and ``calculate_optical_flow``
    (Farneback: this cv2 has no contrib's DeepFlow) write the same files
    as JAX's, byte for byte, and ``VidevoFlow`` reads them back."""
    outs = {}
    for name, mod in (("jax", jd), ("port", pd)):
        out = str(tmp_path / name)
        mod.get_frames(str(videos), out, img_size_wh=(32, 24))
        mod.calculate_optical_flow(os.path.join(out, "frames"),
                                   os.path.join(out, "flow"), "farneback")
        outs[name] = out
    files = _files(outs["jax"])
    assert files == _files(outs["port"])
    assert len([f for f in files if f.startswith("frames")]) == 5
    assert len([f for f in files if f.startswith("flow")]) == 8
    for f in files:
        with open(os.path.join(outs["jax"], f), "rb") as a, \
                open(os.path.join(outs["port"], f), "rb") as b:
            assert a.read() == b.read(), f
    ds = pd.VidevoFlow(outs["port"])
    assert len(ds) == 4
    img1, img2, flow, mask = ds[1]
    assert img1.shape == (24, 32, 3) and flow.shape == (24, 32, 2)
    assert np.isfinite(flow).all() and set(np.unique(mask)) <= {0.0, 1.0}


def test_preprocess_cli(tmp_path, videos, capsys):
    """``cli.preprocess frames`` then ``flow``: the tree the two functions
    write, at the CLI's sizes and extension."""
    from vst_tpu_torch.cli import preprocess

    out = tmp_path / "videvo"
    preprocess.main(["frames", "--videos", str(videos), "--out", str(out),
                     "--size", "32", "24", "--ext", "png"])
    preprocess.main(["flow", "--frames", str(out / "frames"), "--out",
                     str(out / "flow"), "--engine", "farneback"])
    printed = capsys.readouterr().out
    assert "frames written" in printed and "flow written" in printed
    assert sorted(os.listdir(out / "frames" / "00000")) == [
        f"{i:05d}.png" for i in range(5)]
    assert sorted(os.listdir(out / "flow" / "00000" / "back")) == [
        f"{i:05d}_10.npy" for i in range(1, 5)]
    flow = np.load(out / "flow" / "00000" / "front" / "00000_01.npy")
    assert flow.shape == (24, 32, 2) and flow.dtype == np.float32
    assert len(pd.VidevoFlow(str(out))) == 4
