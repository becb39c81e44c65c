"""``vst_tpu_torch.cli.evaluate`` in all nine modes and its error exits,
and ``cli.infer_image --sample-from``, against the JAX package's CLIs on
the same files (``--device cpu`` / ``--platform cpu``): the printed
numbers agree at 1e-4 relative (1e-3 for SIFID), the images at the
model tolerance."""

import importlib
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from vst_tpu.cli import evaluate as jeval_cli
from vst_tpu_torch.cli import evaluate as peval_cli

_NUM = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|nan")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Image pairs (32² and, for SIFID, 96² and 128×112 — the last has
    2×2 positions at Inception's 2048-channel block), a pair of other
    sizes, and seeded LPIPS/VGG19 weight files."""
    from vst_tpu.eval.lpips import random_lpips_params
    from vst_tpu.models import vgg
    from vst_tpu.train.checkpoint import save_params

    root = tmp_path_factory.mktemp("eval_cli")
    rng = np.random.default_rng(0)
    out = {}
    for tag, (h, w) in (("", (32, 32)), ("96", (96, 96)),
                        ("128", (128, 112)), ("odd", (32, 40))):
        a = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        b = (rng.random((h, w, 3)) ** 3 * 255).astype(np.uint8)
        out[f"a{tag}"] = _png(root / f"a{tag}.png", a)
        out[f"b{tag}"] = _png(root / f"b{tag}.png", b)
    lp = random_lpips_params(5)
    save_params({k: v for k, v in lp.items() if not k.startswith("lin")},
                str(root / "vgg16.npz"))
    torch.save({f"lin{k}.model.1.weight": torch.from_numpy(
        np.ascontiguousarray(lp[f"lin{k}.weight"].transpose(3, 2, 0, 1)))
        for k in range(5)}, str(root / "heads.pth"))
    save_params(vgg.init_vgg19_adaattn(3), str(root / "vgg19.npz"))
    out["vgg16"], out["heads"] = str(root / "vgg16.npz"), str(root / "heads.pth")
    out["vgg19"] = str(root / "vgg19.npz")
    return out


def _numbers(text):
    return [float(t) for t in _NUM.findall(text)]


def _both(capsys, argv):
    """The JAX CLI's and the port's printed numbers on ``argv``."""
    jeval_cli.main(argv + ["--platform", "cpu"])
    ref = capsys.readouterr()
    peval_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr()
    assert [line.split(":")[0] for line in ours.out.splitlines()] == \
        [line.split(":")[0] for line in ref.out.splitlines()]
    assert ours.err.count("warning") == ref.err.count("warning")
    return _numbers(ours.out), _numbers(ref.out)


@pytest.mark.parametrize("mode,pair,extra", [
    ("ssim", "", []),
    ("kl", "", []),
    ("moment", "", []),
    ("uni", "", []),
    ("entropy", "", []),
    ("lpips", "", []),
    ("lpips", "", ["weights"]),
    ("gram", "odd", []),
    ("gram", "", ["--vgg19-weights"]),
    ("sifid", "96", ["--dims", "64"]),
    ("sifid", "96", ["--dims", "192"]),
    ("debug_sifid", "128", []),
], ids=["ssim", "kl", "moment", "uni", "entropy", "lpips", "lpips-weights",
        "gram-sizes", "gram-weights", "sifid-64", "sifid-192", "debug_sifid"])
def test_modes_against_jax(files, capsys, monkeypatch, mode, pair, extra):
    if mode == "debug_sifid":
        seen = _no_sqrtm_at_2048(monkeypatch)
    if extra == ["weights"]:
        extra = ["--vgg16-weights", files["vgg16"], "--lpips-weights",
                 files["heads"]]
    elif extra == ["--vgg19-weights"]:
        extra = ["--vgg19-weights", files["vgg19"]]
    ours, ref = _both(capsys, ["-m", mode, "-p0", files[f"a{pair}"], "-p1",
                               files[f"b{pair}"]] + extra)
    assert len(ours) == len(ref) >= 1
    rel = 1e-3 if "sifid" in mode else 1e-4
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=1e-6)
    if mode == "debug_sifid":
        for x, y in zip(seen["port"], seen["jax"]):
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-4 * np.abs(y).max())


def _no_sqrtm_at_2048(monkeypatch):
    """debug_sifid's 2048-dims line without its 2048² sqrtm (tens of
    seconds on the CPU for each side): in both CLIs, frechet_distance at
    2048 dims records its inputs and returns the distance without the
    cross term, |m1 − m2|² + tr s1 + tr s2, from them; the caller holds
    the inputs to JAX's at 1e-4 of their scale.  The port's
    frechet_distance itself is held against JAX's at 64/192/768 here and
    on the jitter branch in test_torch_sifid.py.  Returns the inputs."""
    # the packages export a function ``sifid`` that shadows the module
    jsifid = importlib.import_module("vst_tpu.eval.sifid")
    psifid = importlib.import_module("vst_tpu_torch.eval.sifid")
    seen = {}

    def stub(side, real):
        def frechet(m1, s1, m2, s2, *a, **k):
            if s1.shape[0] < 2048:
                return real(m1, s1, m2, s2, *a, **k)
            seen[side] = (m1, s1, m2, s2)
            return float((m1 - m2) @ (m1 - m2) + np.trace(s1)
                         + np.trace(s2))
        return frechet

    monkeypatch.setattr(jsifid, "frechet_distance",
                        stub("jax", jsifid.frechet_distance))
    monkeypatch.setattr(psifid, "frechet_distance",
                        stub("port", psifid.frechet_distance))
    return seen


@pytest.mark.parametrize("mode", ["moment", "ssim"])
def test_missing_image_exits(files, mode):
    missing = os.path.join(os.path.dirname(files["a"]), "missing.png")
    for cli, dev in ((jeval_cli, "--platform"), (peval_cli, "--device")):
        with pytest.raises(SystemExit, match="image not found"):
            cli.main(["-m", mode, "-p0", missing, "-p1", files["b"], dev,
                      "cpu"])


@pytest.mark.parametrize("mode", ["ssim", "lpips"])
def test_size_mismatch_exits(files, mode):
    for cli, dev in ((jeval_cli, "--platform"), (peval_cli, "--device")):
        with pytest.raises(SystemExit, match="image sizes differ"):
            cli.main(["-m", mode, "-p0", files["a"], "-p1", files["aodd"],
                      dev, "cpu"])


def test_infer_image_sample_from(tmp_path):
    """``--sample-from`` with ``--sample-idx 1`` on a COCO/WikiArt tree:
    the sampled content and style equal JAX's bit for bit, the stylized
    image within one uint8 step at 99.9% of its bytes."""
    from vst_tpu.cli import infer_image as jinfer
    from vst_tpu.models import adaattn
    from vst_tpu.train.checkpoint import save_params
    from vst_tpu_torch.cli import infer_image as pinfer

    rng = np.random.default_rng(1)
    for d in ("coco", "wiki"):
        os.makedirs(tmp_path / d / "cls")
        for i in range(3):
            _png(tmp_path / d / "cls" / f"{i}.png",
                 (rng.random((40 + 8 * i, 56, 3)) * 255).astype(np.uint8))
    weights = str(tmp_path / "ada.npz")
    save_params(adaattn.init_stylizing_network(0), weights)
    argv = ["--model", "adaattn", "--weights", weights, "--sample-from",
            f"{tmp_path / 'coco'},{tmp_path / 'wiki'}", "--sample-idx", "1",
            "--activation", "cosine"]
    jinfer.main(argv + ["--out", str(tmp_path / "j"), "--platform", "cpu"])
    pinfer.main(argv + ["--out", str(tmp_path / "p"), "--device", "cpu"])
    for name in ("content", "style", "stylized"):
        ours = np.asarray(Image.open(tmp_path / "p" / f"{name}.png"), int)
        ref = np.asarray(Image.open(tmp_path / "j" / f"{name}.png"), int)
        assert ours.shape == ref.shape == (256, 256, 3)
        if name != "stylized":
            np.testing.assert_array_equal(ours, ref)
        else:
            diff = np.abs(ours - ref)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
