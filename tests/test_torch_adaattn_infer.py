"""The port's AdaAttN serving entry points against the JAX package:
``stylize_adaattn``, ``adaattn_style_state`` + ``stylize_adaattn_cached``,
``AdaAttNVideoStylizer``, and the image and video CLIs on the CPU."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.infer import image as jimage
from vst_tpu.infer.video import AdaAttNVideoStylizer as JVideoStylizer
from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu_torch.infer import image as pimage
from vst_tpu_torch.infer.video import AdaAttNVideoStylizer
from vst_tpu_torch.models import adaattn as pa
from vst_tpu_torch.models import vgg as pv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTENT = os.path.join(ROOT, "assets", "contents", "scene_00.png")
STYLE = os.path.join(ROOT, "assets", "styles", "candy.png")


@pytest.fixture(scope="module")
def both():
    return ((jv.init_vgg19_adaattn(0), ja.init_stylizing_network(1)),
            (pv.init_vgg19_adaattn(0, device="cpu"),
             pa.init_stylizing_network(1, device="cpu")))


def _u8(rng, n, h=32, w=48):
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


def _close(ours, ref, rel=2e-3):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rel * np.abs(ref).max()


def test_stylize_adaattn(rng, both):
    (jvp, jap), (vgg, net) = both
    c, s = _u8(rng, 2), _u8(rng, 2)
    ref = jimage.stylize_adaattn(jvp, jap, jnp.asarray(c, jnp.float32),
                                 jnp.asarray(s, jnp.float32))
    ours = pimage.stylize_adaattn(vgg, net, c, s)   # uint8 in, cast on device
    assert ours.dtype == torch.float32
    _close(ours.numpy(), ref)


@pytest.mark.parametrize("activation", ["softmax", "cosine"])
def test_stylize_adaattn_cached(rng, both, activation):
    (jvp, jap), (vgg, net) = both
    c, s = _u8(rng, 2), _u8(rng, 1)
    jstate = jimage.adaattn_style_state(jvp, jap, jnp.asarray(s, jnp.float32),
                                        activation)
    ref = jimage.stylize_adaattn_cached(jvp, jap, jnp.asarray(c, jnp.float32),
                                        jstate, activation)
    state = pimage.adaattn_style_state(vgg, net, s, activation)
    ours = pimage.stylize_adaattn_cached(vgg, net, torch.from_numpy(c), state,
                                         activation)
    _close(ours.numpy(), ref)


def test_video_stylizer(rng, both):
    """Five frames at batch 2 (a padded tail), uint8 frames against the JAX
    stylizer's; the truncating cast may move a value by one."""
    (jvp, jap), (vgg, net) = both
    style = _u8(rng, 1).astype(np.float32)
    clip = list(_u8(rng, 5))
    ref = list(JVideoStylizer(jvp, jap, jnp.asarray(style), "cosine",
                              batch_size=2).stylize_frames(iter(clip)))
    ours = list(AdaAttNVideoStylizer(vgg, net, style, "cosine",
                                     batch_size=2).stylize_frames(iter(clip)))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.dtype == np.uint8 and a.shape == (32, 48, 3)
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1


def test_video_stylizer_i420_and_guards(rng, both):
    pytest.importorskip("cv2")
    _, (vgg, net) = both
    style = _u8(rng, 1)
    clip = list(_u8(rng, 3))
    rgb = list(AdaAttNVideoStylizer(vgg, net, style, batch_size=2)
               .stylize_frames(iter(clip)))
    yuv = list(AdaAttNVideoStylizer(vgg, net, style, batch_size=2,
                                    wire="i420").stylize_frames(iter(clip)))
    assert len(yuv) == 3 and yuv[0].shape == (32, 48, 3)
    # I420 subsamples chroma: close to the RGB frames, not equal
    assert np.abs(yuv[0].astype(int) - rgb[0].astype(int)).mean() < 8
    from tests.torch_dist import mesh_of

    with pytest.raises(ValueError, match="divisible by the 3-device mesh"):
        AdaAttNVideoStylizer(vgg, net, style, batch_size=2, mesh=mesh_of(3))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from vst_tpu.train.checkpoint import save_params

    path = str(tmp_path_factory.mktemp("w") / "adaattn.npz")
    save_params(ja.init_stylizing_network(1), path)
    return path


def test_cli_image(tmp_path, capsys, weights, both):
    from vst_tpu_torch.cli import infer_image
    from vst_tpu_torch.cli.common import load_image_255

    infer_image.main(["--model", "adaattn", "--weights", weights,
                      "--content", CONTENT, "--style", STYLE, "--size", "32",
                      "48", "--out", str(tmp_path), "--device", "cpu"])
    dst = tmp_path / "stylized.png"
    assert capsys.readouterr().out.strip() == str(dst)
    from PIL import Image

    got = np.asarray(Image.open(dst))
    _, (vgg, net) = both
    c = load_image_255(CONTENT, (48, 32))[None]
    s = load_image_255(STYLE, (48, 32))[None]
    ref = pimage.stylize_adaattn(vgg, net, c, s)[0].numpy().astype(np.uint8)
    np.testing.assert_array_equal(got, ref)


def test_cli_all_pairs(tmp_path, weights):
    import shutil

    from vst_tpu_torch.cli import infer_image

    cdir, sdir = tmp_path / "c", tmp_path / "s"
    cdir.mkdir()
    sdir.mkdir()
    for name in ("scene_00.png", "scene_01.png"):
        shutil.copy(os.path.join(ROOT, "assets", "contents", name), cdir)
    for name in ("candy.png", "wave.png"):
        shutil.copy(os.path.join(ROOT, "assets", "styles", name), sdir)
    infer_image.main(["--model", "adaattn", "--weights", weights,
                      "--content", str(cdir), "--style", str(sdir),
                      "--all-pairs", "--size", "32", "32", "--activation",
                      "cosine", "--out", str(tmp_path / "o"),
                      "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "o")) == [
        f"{c}__{s}.png" for c in ("scene_00", "scene_01")
        for s in ("candy", "wave")]


@pytest.mark.parametrize("argv,match", [
    # RTNSTV runs since its slice: an RTNSTV checkpoint styles the content;
    # --sample-from runs since the evaluation slice: it writes the sampled
    # content and style and the stylized image
    (["--model", "rtnstv", "--content", CONTENT], None),
    (["--model", "adaattn", "--sample-from"], None),
    (["--model", "adaattn", "--content", CONTENT], "--style"),
    (["--model", "reconet"], "does not look like"),
])
def test_cli_image_rejects(tmp_path, weights, argv, match):
    from vst_tpu_torch.cli import infer_image

    if match is None and "--sample-from" in argv:
        from PIL import Image

        for d in ("coco", "wiki"):
            os.makedirs(tmp_path / d / "cls")
            Image.fromarray(np.full((40, 48, 3), 90, np.uint8)).save(
                tmp_path / d / "cls" / "0.png")
        infer_image.main(argv + [f"{tmp_path / 'coco'},{tmp_path / 'wiki'}",
                                 "--weights", weights, "--device", "cpu",
                                 "--out", str(tmp_path / "o")])
        for name in ("content", "style", "stylized"):
            out = np.asarray(Image.open(tmp_path / "o" / f"{name}.png"))
            assert out.shape == (256, 256, 3)
        return
    if match is None:
        from PIL import Image
        from vst_tpu.models.rtnstv import init_stylizing_network
        from vst_tpu.train.checkpoint import save_params

        rtnstv = str(tmp_path / "rtnstv.npz")
        save_params(init_stylizing_network(0), rtnstv)
        infer_image.main(argv + ["--weights", rtnstv, "--size", "32", "48",
                                 "--device", "cpu", "--out", str(tmp_path)])
        out = np.asarray(Image.open(tmp_path / "stylized.png"))
        assert out.shape == (32, 48, 3)
        return
    with pytest.raises(SystemExit, match=match):
        infer_image.main(argv + ["--weights", weights, "--device", "cpu",
                                 "--out", str(tmp_path)])


def test_cli_video_adaattn(tmp_path, capsys, weights):
    cv2 = pytest.importorskip("cv2")
    from vst_tpu_torch.cli import infer_video

    video = str(tmp_path / "in.avi")
    rng = np.random.default_rng(0)
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 32))
    for _ in range(3):
        vw.write(rng.integers(0, 256, (32, 48, 3)).astype(np.uint8))
    vw.release()
    out_dir = tmp_path / "frames"
    infer_video.main(["--model", "adaattn", "--weights", weights, "--style",
                      STYLE, "--video", video, "--size", "48", "32",
                      "--batch-size", "2", "--frames-dir", str(out_dir),
                      "--device", "cpu"])
    assert "3 frames" in capsys.readouterr().out
    assert len(list(out_dir.glob("*.jpg"))) == 3
    with pytest.raises(SystemExit, match="--style"):
        infer_video.main(["--model", "adaattn", "--weights", weights,
                          "--video", video, "--device", "cpu"])


def test_cli_video_adaattn_ignores_weights2(tmp_path, capsys, weights):
    """``--weights2`` with ``--model adaattn`` serves the video, as JAX's
    AdaAttN branch (which never reads the flag) does, with a warning on
    stderr."""
    cv2 = pytest.importorskip("cv2")
    from vst_tpu_torch.cli import infer_video

    video = str(tmp_path / "in.avi")
    rng = np.random.default_rng(1)
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 32))
    for _ in range(3):
        vw.write(rng.integers(0, 256, (32, 48, 3)).astype(np.uint8))
    vw.release()
    out_dir = tmp_path / "frames"
    infer_video.main(["--model", "adaattn", "--weights", weights, "--style",
                      STYLE, "--video", video, "--size", "48", "32",
                      "--batch-size", "2", "--frames-dir", str(out_dir),
                      "--weights2", weights, "--device", "cpu"])
    out, err = capsys.readouterr()
    assert "3 frames" in out
    assert "--weights2 is ignored" in err
    assert len(list(out_dir.glob("*.jpg"))) == 3


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pa.init_stylizing_network(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pv.init_vgg19_adaattn(0)
