"""``vst_tpu_torch.cli.experiments`` against the JAX package's on the same
files (``--device cpu`` / ``--platform cpu``): ``image`` (the CSV),
``sintel-et``, ``sintel-ada`` with GT flow, Farneback and RAFT, ``mse``
and ``video``, the printed numbers and CSV values at 1e-4 relative.  The
synthetic trees mirror tests/test_cli.py's experiment cases."""

import csv
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from vst_tpu.cli import experiments as jexp
from vst_tpu_torch.cli import experiments as pexp
from tests import test_cli

_NUM = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")


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
    """Content and style folders (2 + 2 images at 64²), a Sintel tree of
    4 frames at 64² (scene alley_1) and of 3 frames at 32×64 (ambush_4),
    seeded AdaAttN, RTNSTV, ReCoNet, VGG19 and RAFT ``.npz`` files."""
    from vst_tpu.models import adaattn, reconet, rtnstv, vgg
    from vst_tpu.models.raft import init_raft
    from vst_tpu.train.checkpoint import save_params

    root = tmp_path_factory.mktemp("experiments")
    rng = np.random.default_rng(0)
    for d in ("contents", "styles"):
        os.makedirs(root / d)
        for i in range(2):
            Image.fromarray((rng.random((64, 64, 3)) * 255).astype(
                np.uint8)).save(root / d / f"{d[0]}{i}.png")
    sintel = test_cli.TestExperimentsCLI()
    sintel._make_sintel(str(root / "sintel"), rng, n=4, hw=(64, 64))
    sintel._make_sintel(str(root / "sintel"), rng, "ambush_4", n=3,
                        hw=(32, 64))
    for name, params in (("ada", adaattn.init_stylizing_network(0)),
                         ("rtnstv", rtnstv.init_stylizing_network(0)),
                         ("reconet", reconet.init_reconet(0)),
                         ("vgg19", vgg.init_vgg19_adaattn(0)),
                         ("raft", init_raft(0))):
        save_params(params, str(root / f"{name}.npz"))
    return root


def _video(path, rng, n=7, w=64, h=48):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         (w, h))
    base = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    for i in range(n):
        vw.write(np.roll(base, 2 * i, axis=1))
    vw.release()
    return str(path)


def _run(capsys, argv, csv_path=None):
    """Both CLIs on ``argv``: their printed numbers (and CSV rows)."""
    out = []
    for cli, dev, tag in ((jexp, "--platform", "j"), (pexp, "--device", "p")):
        args = list(argv) + [dev, "cpu"]
        if csv_path:
            args += ["--out", f"{csv_path}.{tag}.csv"]
        cli.main(args)
        text = capsys.readouterr().out
        rows = None
        if csv_path:
            with open(f"{csv_path}.{tag}.csv") as f:
                rows = list(csv.DictReader(f))
            text = text.replace(f"{csv_path}.{tag}.csv", "")
        out.append(([float(t) for t in _NUM.findall(text)], rows))
    return out


def _same_rows(ours, ref, rel):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert list(o) == list(r)
        for k in r:
            try:
                rv = float(r[k])
            except ValueError:
                assert o[k] == r[k]
                continue
            assert float(o[k]) == pytest.approx(rv, rel=rel, abs=1e-7), k


@pytest.mark.parametrize("vgg", [False, True], ids=["no-vgg", "vgg"])
def test_image(data, tmp_path, capsys, vgg):
    """The 2×2 content×style sweep at 64² (AdaAttN softmax): every metric
    column of every row and the average row; with ``--vgg-weights`` the
    gram columns too."""
    argv = ["image", "--contents", str(data / "contents"), "--styles",
            str(data / "styles"), "--weights", str(data / "ada.npz"),
            "--size", "64", "64"]
    if vgg:
        argv += ["--vgg-weights", str(data / "vgg19.npz")]
    (jn, jrows), (pn, prows) = _run(capsys, argv, str(tmp_path / "r"))
    assert len(prows) == 5 and prows[-1]["content"] == "average"
    assert any(k.endswith("gram") for k in prows[0]) == vgg
    _same_rows(prows, jrows, 1e-4)
    np.testing.assert_allclose(pn, jn, rtol=1e-4)


def test_sintel_et(data, tmp_path, capsys):
    """RTNSTV's Et per scene (frames at 640×360; the ragged last batch
    of map_batched on 4 and 3 frames)."""
    argv = ["sintel-et", "--weights", str(data / "rtnstv.npz"), "--sintel",
            str(data / "sintel"), "--scenes", "alley_1", "ambush_4"]
    (jn, jrows), (pn, prows) = _run(capsys, argv, str(tmp_path / "et"))
    _same_rows(prows, jrows, 1e-4)
    assert len(pn) == len(jn) == 2
    np.testing.assert_allclose(pn, jn, rtol=1e-4)


@pytest.mark.parametrize("engine", ["gt", "farneback", "raft"])
def test_sintel_ada(data, tmp_path, capsys, engine):
    """AdaAttN's Sintel loss per scene at 64² with each flow engine (MAE;
    the GT case also MSE and softmax)."""
    if engine == "farneback":
        pytest.importorskip("cv2")
    argv = ["sintel-ada", "--weights", str(data / "ada.npz"), "--style",
            str(data / "styles" / "s0.png"), "--sintel", str(data / "sintel"),
            "--scenes", "alley_1", "--size", "64", "64", "--flow-engine",
            engine]
    if engine == "raft":
        argv += ["--raft-weights", str(data / "raft.npz")]
    runs = [argv]
    if engine == "gt":
        runs.append(argv + ["--metric", "mse", "--activation", "softmax"])
    for run in runs:
        (jn, jrows), (pn, prows) = _run(capsys, run, str(tmp_path / "ada"))
        _same_rows(prows, jrows, 1e-4)
        np.testing.assert_allclose(pn, jn, rtol=1e-4)


def test_sintel_ada_raft_needs_weights(data):
    with pytest.raises(SystemExit, match="--raft-weights"):
        pexp.main(["sintel-ada", "--weights", str(data / "ada.npz"),
                   "--style", str(data / "styles" / "s0.png"), "--sintel",
                   str(data / "sintel"), "--flow-engine", "raft",
                   "--device", "cpu"])


def test_mse(data, tmp_path, capsys):
    """ReCoNet's temporal MSE over a 4-frame clip (frames at 640×360)."""
    video = _video(tmp_path / "in.avi", np.random.default_rng(1), n=4)
    (jn, _), (pn, _) = _run(capsys, ["mse", "--weights",
                                     str(data / "reconet.npz"), "--video",
                                     video])
    assert len(pn) == len(jn) == 1
    np.testing.assert_allclose(pn, jn, rtol=1e-4)


def test_video(data, tmp_path, capsys):
    """Warping error and flow MSE (Farneback) over a 10-frame clip at
    64×48 in chunks of 8: a carry across chunks and a ragged tail.  The
    port's ``--flow-engine raft`` runs RAFT (the JAX package's flag is
    read by neither engine) and gives finite numbers."""
    video = _video(tmp_path / "in.avi", np.random.default_rng(2), n=10)
    argv = ["video", "--model", "reconet", "--weights",
            str(data / "reconet.npz"), "--video", video, "--size", "64", "48"]
    (jn, _), (pn, _) = _run(capsys, argv)
    assert len(pn) == len(jn) == 2
    np.testing.assert_allclose(pn, jn, rtol=1e-4)
    pexp.main(argv + ["--flow-engine", "raft", "--raft-weights",
                      str(data / "raft.npz"), "--device", "cpu"])
    out = capsys.readouterr().out
    vals = [float(t) for t in _NUM.findall(out)]
    assert "Warping Error:" in out and len(vals) == 2
    assert np.isfinite(vals).all() and vals != pn
