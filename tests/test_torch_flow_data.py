"""The port's flow readers, host flow math and ReCoNet datasets
(``vst_tpu_torch/data/{flowio,flow_np,native,datasets}.py``) against the
JAX package's, bit for bit, on synthetic files and on synthetic SceneFlow
and COCO trees (tests/test_data.py::_make_sceneflow_scene)."""

import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from vst_tpu.data import datasets as jd
from vst_tpu.data import flow_np as jf
from vst_tpu.data import flowio as jio
from vst_tpu.ops.resize import _linear_matrix as j_linear_matrix
from vst_tpu_torch.data import datasets as pd
from vst_tpu_torch.data import flow_np as pf
from vst_tpu_torch.data import flowio as pio
from vst_tpu_torch.data import native as pn
from tests.test_data import _make_sceneflow_scene

NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "vstio.cc")


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ flowio

@pytest.mark.parametrize("shape", [(9, 13, 3), (6, 8)])
def test_pfm_round_trip(tmp_path, rng, shape):
    """Written by either package, read by both: the same bits, colour and
    grey, and the same scale."""
    img = rng.standard_normal(shape).astype(np.float32)
    for write, name in ((pio.write_pfm, "p.pfm"), (jio.write_pfm, "j.pfm")):
        path = str(tmp_path / name)
        write(path, img)
        ours, ref = pio.read_pfm(path), jio.read_pfm(path)
        _equal(ours[0], ref[0])
        _equal(ours[0], img)
        assert ours[1] == ref[1] == 1.0
    assert (tmp_path / "p.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()


def test_flo_and_dispatch(tmp_path, rng):
    """.flo written and read by both, read() and write() dispatching on the
    extension, a .pfm read as flow keeping two channels."""
    flow = rng.standard_normal((12, 17, 2)).astype(np.float32)
    pio.write(str(tmp_path / "p.flo"), flow)
    jio.write(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "p.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    _equal(pio.read(str(tmp_path / "p.flo")), jio.read(str(tmp_path / "p.flo")))
    pfm = rng.standard_normal((5, 6, 3)).astype(np.float32)
    jio.write_pfm(str(tmp_path / "f.pfm"), pfm)
    _equal(pio.read_flo(str(tmp_path / "f.pfm")),
           jio.read_flo(str(tmp_path / "f.pfm")))
    with pytest.raises(ValueError):
        pio.read(str(tmp_path / "x.bin"))


def test_sintel_and_float3(tmp_path, rng):
    """The Sintel tag check and the Freiburg float3 blob."""
    flow = rng.standard_normal((4, 5, 2)).astype(np.float32)
    path = str(tmp_path / "s.flo")
    with open(path, "wb") as f:
        np.array([202021.25], np.float32).tofile(f)
        np.array([5, 4], np.int32).tofile(f)
        flow.tofile(f)
    _equal(pio.read_sintel_flo(path), jio.read_sintel_flo(path))
    bad = str(tmp_path / "bad.flo")
    with open(bad, "wb") as f:
        np.array([1.0], np.float32).tofile(f)
        np.array([5, 4], np.int32).tofile(f)
        flow.tofile(f)
    with pytest.raises(ValueError, match="Sintel tag"):
        pio.read_sintel_flo(bad)
    data = rng.standard_normal((3, 4, 2)).astype(np.float32)
    path = str(tmp_path / "d.float3")
    with open(path, "wb") as f:
        f.write(b"float\n3\n2\n4\n3\n")
        data.transpose(2, 1, 0).copy().tofile(f)
    _equal(pio.read_float3(path), jio.read_float3(path))


# ----------------------------------------------------------------- flow_np

def test_linear_matrix_copy():
    for a, b in ((24, 32), (32, 24), (540, 360), (7, 7)):
        _equal(pf._linear_matrix(a, b), j_linear_matrix(a, b))


def test_flow_np_matches_jax(rng):
    """resize (HWC and HW), the flow resize with its per-axis rescale, the
    warp and the consistency mask, bit for bit."""
    flow = (rng.standard_normal((24, 32, 2)) * 3).astype(np.float32)
    back = (-flow + rng.standard_normal((24, 32, 2))).astype(np.float32)
    img = rng.standard_normal((24, 32, 3)).astype(np.float32)
    for size in ((16, 20), (24, 32), (36, 50)):
        _equal(pf.resize_bilinear_np(img, size),
               jf.resize_bilinear_np(img, size))
        _equal(pf.resize_bilinear_np(img[..., 0], size),
               jf.resize_bilinear_np(img[..., 0], size))
        _equal(pf.resize_flow_np(flow, size), jf.resize_flow_np(flow, size))
    _equal(pf.warp_np(img, flow), jf.warp_np(img, flow))
    _equal(pf.flow_warp_mask_np(flow, back), jf.flow_warp_mask_np(flow, back))
    _equal(pf.flow_warp_mask_np(flow, back, 0.5),
           jf.flow_warp_mask_np(flow, back, 0.5))


# ------------------------------------------------------------------ native

@pytest.fixture(params=["numpy", "libvstio"])
def reader(request, tmp_path, monkeypatch):
    """The port's native module reading through its numpy fallback (the
    library absent), or through a libvstio.so built here from
    native/vstio.cc (skipped where there is no C++ compiler)."""
    if request.param == "numpy":
        monkeypatch.setattr(pn, "_LIB_PATH", str(tmp_path / "absent.so"))
        assert not pn.available()
        return pn
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no C++ compiler to build native/vstio.cc")
    lib = str(tmp_path / "libvstio.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-o", lib,
                    NATIVE_SRC, "-lpthread"], check=True, timeout=120)
    monkeypatch.setattr(pn, "_LIB_PATH", lib)
    assert pn.available()
    return pn


def test_native_reads_bitwise(reader, tmp_path, rng):
    """read_pfm (colour, grey), read_flo and read_flow_batch of both kinds
    against the JAX package's numpy readers."""
    color = rng.standard_normal((9, 13, 3)).astype(np.float32)
    gray = rng.standard_normal((6, 8)).astype(np.float32)
    jio.write_pfm(str(tmp_path / "c.pfm"), color)
    jio.write_pfm(str(tmp_path / "g.pfm"), gray)
    _equal(reader.read_pfm(str(tmp_path / "c.pfm")),
           jio.read_pfm(str(tmp_path / "c.pfm"))[0].astype(np.float32))
    _equal(reader.read_pfm(str(tmp_path / "g.pfm")),
           jio.read_pfm(str(tmp_path / "g.pfm"))[0].astype(np.float32))
    flos, pfms = [], []
    for i in range(5):
        flow = rng.standard_normal((4, 7, 2)).astype(np.float32)
        jio.write_flo(str(tmp_path / f"{i}.flo"), flow)
        flos.append(str(tmp_path / f"{i}.flo"))
        jio.write_pfm(str(tmp_path / f"{i}.pfm"),
                      rng.standard_normal((4, 7, 3)).astype(np.float32))
        pfms.append(str(tmp_path / f"{i}.pfm"))
    _equal(reader.read_flo(flos[0]), jio.read_flo(flos[0]))
    _equal(reader.read_flow_batch(flos, (4, 7, 2), num_threads=3),
           np.stack([jio.read_flo(p) for p in flos]))
    _equal(reader.read_flow_batch(pfms, (4, 7, 3), num_threads=3),
           np.stack([jio.read_pfm(p)[0] for p in pfms]))


def test_stale_library_is_not_used(tmp_path, monkeypatch):
    """A library older than its source reads through numpy, as the port's
    video decoder binding does."""
    lib = tmp_path / "libvstio.so"
    lib.write_bytes(b"")
    os.utime(lib, (0, 0))
    monkeypatch.setattr(pn, "_LIB_PATH", str(lib))
    assert not pn.available()


# ---------------------------------------------------------------- datasets

def _write_img(path, rng, size=(32, 24)):
    arr = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _equal_samples(ours, ref):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        a, b = (a, b) if isinstance(b, tuple) else ((a,), (b,))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)


@pytest.mark.parametrize("frame_num", [1, 3])
@pytest.mark.parametrize("img_size", [(24, 32), (16, 20)])
def test_monkaa_bitwise(tmp_path, rng, frame_num, img_size):
    """Every sample (frame windows, the resized backward flow with the
    reference's channel-swapped rescale, the mask with inverted motion
    boundaries), at the flows' size and resized."""
    _make_sceneflow_scene(str(tmp_path), rng, 7, "monkaa")
    ours = pd.Monkaa(str(tmp_path), img_size, frame_num)
    ref = jd.Monkaa(str(tmp_path), img_size, frame_num)
    assert (ours.frame, ours.flow, ours.motion) == (ref.frame, ref.flow,
                                                    ref.motion)
    _equal_samples(ours, ref)


def test_flyingthings_and_combined_bitwise(tmp_path, rng):
    mpath, fpath = str(tmp_path / "monkaa"), str(tmp_path / "flyingthings3d")
    _make_sceneflow_scene(mpath, rng, 5, "monkaa")
    _make_sceneflow_scene(fpath, rng, 6, "ft3d")
    _equal_samples(pd.FlyingThings3D(fpath, (24, 32)),
                   jd.FlyingThings3D(fpath, (24, 32)))
    for path in (str(tmp_path), (mpath, fpath)):
        ours = pd.SceneFlowCombined(path, (20, 28))
        assert len(ours) == 4 + 5
        _equal_samples(ours, jd.SceneFlowCombined(path, (20, 28)))


def test_coco2014_bitwise(tmp_path, rng):
    (tmp_path / "train2014").mkdir()
    for i in range(3):
        _write_img(str(tmp_path / "train2014" / f"{i}.jpg"), rng, (40 + i, 30))
    _equal_samples(pd.Coco2014(str(tmp_path), (24, 32)),
                   jd.Coco2014(str(tmp_path), (24, 32)))


def test_flow_file_formats(tmp_path, rng):
    """_load_flow_file reads .flo, .pfm, .npy and a (2, H, W) .pt as the
    JAX package does."""
    import torch

    flow = rng.standard_normal((5, 6, 2)).astype(np.float32)
    jio.write_flo(str(tmp_path / "a.flo"), flow)
    jio.write_pfm(str(tmp_path / "a.pfm"),
                  np.concatenate([flow, flow[..., :1]], -1))
    np.save(str(tmp_path / "a.npy"), flow)
    torch.save(torch.from_numpy(flow.transpose(2, 0, 1).copy()),
               str(tmp_path / "a.pt"))
    for ext in ("flo", "pfm", "npy", "pt"):
        path = str(tmp_path / f"a.{ext}")
        _equal(pd._load_flow_file(path), jd._load_flow_file(path))
