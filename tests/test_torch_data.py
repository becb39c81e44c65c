"""The port's AdaAttN datasets and batch pipeline
(``vst_tpu_torch/data/datasets.py``, ``data/pipeline.py``) against the JAX
package's on the same synthetic image folders and seeds: samples bit for
bit at several (epoch, index), batches under 0 and 4 loader threads, the
seed-derived order and the ``start_batch`` tail; ``device_prefetch`` on
the CPU."""

import numpy as np
import pytest
import torch
from PIL import Image

from vst_tpu.data import datasets as jd
from vst_tpu.data import pipeline as jp
from vst_tpu_torch.data import datasets as pd
from vst_tpu_torch.data import pipeline as pp


def _write(path, rng, size_wh):
    arr = rng.integers(0, 256, (size_wh[1], size_wh[0], 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """coco/ (nested, mixed sizes and extensions), wiki/, and a Videvo
    frames tree of two clips."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for i in range(5):
        sub = root / "coco" / ("a" if i % 2 else "b")
        sub.mkdir(parents=True, exist_ok=True)
        _write(str(sub / f"{i}.{'png' if i % 3 else 'jpg'}"), rng,
               (40 + 4 * i, 36))
    (root / "wiki").mkdir()
    for i in range(3):
        _write(str(root / "wiki" / f"{i}.png"), rng, (48, 40))
    (root / "wiki" / "notes.txt").write_text("not an image")
    for clip in range(2):
        d = root / "videvo" / "frames" / f"{clip:05d}"
        d.mkdir(parents=True)
        for i in range(3 + clip):
            _write(str(d / f"{i:05d}.png"), rng, (24, 16))
    return root


def _pair(kind, root):
    """(JAX dataset, port dataset) at small sizes."""
    if kind == "image_folder_crop":
        args = (str(root / "coco"),)
        kw = {"size_resize": (24, 28), "size_crop": (16, 12), "seed": 3}
        return jd.ImageFolderCrop(*args, **kw), pd.ImageFolderCrop(*args, **kw)
    if kind == "videvo_frames":
        return (jd.VidevoFrames(str(root / "videvo")),
                pd.VidevoFrames(str(root / "videvo")))
    if kind == "coco_wikiart":
        pair = (jd.CocoWikiArt(str(root / "coco"), str(root / "wiki"),
                               size_crop=(16, 16), seed=7),
                pd.CocoWikiArt(str(root / "coco"), str(root / "wiki"),
                               size_crop=(16, 16), seed=7))
        for ds in pair:   # shrink AdaAttN's 512² resize for speed
            ds.coco.size_resize = ds.wikiart.size_resize = (32, 32)
        return pair
    pair = (jd.VidevoWikiArt(str(root / "videvo"), str(root / "wiki"), 5),
            pd.VidevoWikiArt(str(root / "videvo"), str(root / "wiki"), 5))
    for ds in pair:   # and the 256×512 style crop
        ds.wikiart.size_resize, ds.wikiart.size_crop = (40, 48), (16, 24)
    return pair


def _samples(ds, epoch, idx):
    if hasattr(ds, "set_epoch"):
        ds.set_epoch(epoch)
    out = ds[idx]
    return out if isinstance(out, tuple) else (out,)


KINDS = ["image_folder_crop", "videvo_frames", "coco_wikiart",
         "videvo_wikiart"]


@pytest.mark.parametrize("kind", KINDS)
def test_samples_equal_jax(folders, kind):
    jds, pds = _pair(kind, folders)
    assert len(jds) == len(pds) > 0
    for epoch in (0, 1, 3):
        for idx in range(len(pds)):
            ours, ref = _samples(pds, epoch, idx), _samples(jds, epoch, idx)
            assert len(ours) == len(ref)
            for a, b in zip(ours, ref):
                assert a.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_full_size_video_style_crop(folders):
    """VidevoWikiArt's style crop defaults to the reference's 256×512,
    as JAX's."""
    jds = jd.VidevoWikiArt(str(folders / "videvo"), str(folders / "wiki"))
    pds = pd.VidevoWikiArt(str(folders / "videvo"), str(folders / "wiki"))
    (_, _, s), (_, _, sj) = pds[1], jds[1]
    assert s.shape == (256, 512, 3)
    np.testing.assert_array_equal(s, sj)


def test_list_helpers_equal_jax(folders):
    assert pd.list_files(str(folders / "wiki")) == \
        jd.list_files(str(folders / "wiki"))
    assert pd.list_folders(str(folders / "videvo" / "frames")) == \
        jd.list_folders(str(folders / "videvo" / "frames"))
    path = pd.list_files(str(folders / "wiki"))[0]
    for size in (None, (20, 10)):
        np.testing.assert_array_equal(pd.load_image(path, size),
                                      jd.load_image(path, size))


@pytest.mark.parametrize("kind", ["coco_wikiart", "videvo_wikiart"])
@pytest.mark.parametrize("num_workers", [0, 4])
def test_batches_equal_jax(folders, kind, num_workers):
    """Two epochs of shuffled batches, the port with ``num_workers``
    threads, JAX's serially: the same batches in the same order."""
    jds, pds = _pair(kind, folders)
    ours = pp.BatchLoader(pds, batch_size=2, seed=3, num_workers=num_workers)
    ref = jp.BatchLoader(jds, batch_size=2, seed=3, num_workers=0)
    n = 0
    for _ in range(2):
        for a, b in zip(ours, ref, strict=True):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x, y)
            n += 1
    assert n == 2 * (len(pds) // 2)


class _Toy:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return (np.full((4, 4, 3), i, np.float32),
                np.full((4, 4), i, np.float32))


class _Counting(_Toy):
    def __init__(self):
        self.calls = 0

    def __getitem__(self, i):
        self.calls += 1
        return super().__getitem__(i)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True),
                                               (True, False)])
def test_batch_loader_order_equals_jax(shuffle, drop_last):
    ours = list(pp.BatchLoader(_Toy(), 4, shuffle=shuffle, seed=1,
                               drop_last=drop_last))
    ref = list(jp.BatchLoader(_Toy(), 4, shuffle=shuffle, seed=1,
                              drop_last=drop_last))
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for (a1, b1), (a2, b2) in zip(ours, ref):
        assert a1.shape[1:] == (4, 4, 3) and b1.shape[1:] == (4, 4)
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


def test_batch_loader_start_batch_is_exact_tail():
    """start_batch skips at the index level: the tail equals the
    uninterrupted epoch's (and JAX's), the skipped batches are not
    decoded, and the skip is one-shot."""
    full = list(pp.BatchLoader(_Toy(), 2, seed=7, num_workers=0))
    counting = _Counting()
    loader = pp.BatchLoader(counting, 2, seed=7, num_workers=0,
                            start_batch=3)
    tail = list(loader)
    ref = list(jp.BatchLoader(_Toy(), 2, seed=7, num_workers=0,
                              start_batch=3))
    assert len(tail) == len(ref) == len(full) - 3
    assert counting.calls == 2 * len(tail)
    for (a1, b1), (a2, b2), (a3, b3) in zip(full[3:], tail, ref):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(a2, a3)
        np.testing.assert_array_equal(b2, b3)
    assert len(list(loader)) == len(full)


def test_batch_loader_processes():
    """process_id/num_processes (kept for multi-process training): at one
    process the full batch, at two each process its half of the same
    global batch; a batch that does not divide is refused."""
    one = list(pp.BatchLoader(_Toy(), 4, seed=2, num_workers=0))
    halves = [list(pp.BatchLoader(_Toy(), 4, seed=2, num_workers=0,
                                  process_id=p, num_processes=2))
              for p in (0, 1)]
    for b, h0, h1 in zip(one, *halves):
        np.testing.assert_array_equal(b[0], np.concatenate([h0[0], h1[0]]))
    with pytest.raises(ValueError, match="divide"):
        pp.BatchLoader(_Toy(), 3, num_processes=2)
    with pytest.raises(ValueError, match="drop_last"):
        pp.BatchLoader(_Toy(), 4, num_processes=2, drop_last=False)


def test_device_prefetch_on_cpu():
    """On the CPU the prefetch only turns arrays into tensors, in order,
    sharing nothing it should not (tuples and single arrays)."""
    loader = pp.BatchLoader(_Toy(), 2, shuffle=False, num_workers=0)
    seen = list(pp.device_prefetch(iter(loader), size=2, device="cpu"))
    assert len(seen) == 5
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in seen for t in b)
    np.testing.assert_array_equal(seen[0][0][:, 0, 0, 0].numpy(), [0.0, 1.0])
    assert float(seen[1][0].mean()) == 2.5
    single = list(pp.device_prefetch(iter([np.ones(3, np.float32)]),
                                     device="cpu"))
    assert len(single) == 1 and torch.equal(single[0], torch.ones(3))
