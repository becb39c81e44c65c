"""The seeded generators repeat per seed and differ between seeds."""

import numpy as np
import torch

from portbench.core.seeds import sub_seed
from portbench.reference import adaattn, reconet
from portbench.core import load
from portbench.synth.flow_pairs import SyntheticFlowPairs
from portbench.synth.frames import clip
from portbench.synth.pairs import SyntheticPairs

BIG = 3_000_000_017   # past 32 bits, as the driver's seeds are


def test_frames_repeat_per_seed():
    a, b, c = clip(BIG, 3, (8, 12)), clip(BIG, 3, (8, 12)), clip(5, 3, (8, 12))
    assert a.dtype == np.uint8 and a.shape == (3, 8, 12, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_pairs_repeat_per_seed_and_differ_per_epoch():
    ds, again = SyntheticPairs(4, (8, 8), BIG), SyntheticPairs(4, (8, 8), BIG)
    x = ds[2]
    assert all(np.array_equal(u, v) for u, v in zip(x, again[2]))
    ds.set_epoch(1)
    assert not np.array_equal(ds[2][0], x[0])
    assert x[0].dtype == np.float32 and x[0].max() <= 255


def test_flow_pairs_repeat_per_seed():
    a, b = SyntheticFlowPairs(3, (8, 12), BIG), SyntheticFlowPairs(3, (8, 12),
                                                                   BIG)
    img1, img2, flow, mask = a[1]
    assert flow.shape == (8, 12, 2) and mask.shape == (8, 12)
    assert all(np.array_equal(u, v) for u, v in zip(a[1], b[1]))
    assert not np.array_equal(a[0][0], a[1][0])


def test_sub_seeds_differ_by_stream_and_take_any_whole_number():
    seeds = {sub_seed(BIG, s) for s in ("weights", "vgg", "traffic")}
    assert len(seeds) == 3
    assert sub_seed(-1, "weights") != sub_seed(2**64 + 5, "weights")
    assert all(0 <= s < 2**63 for s in seeds)


def test_weights_repeat_per_seed():
    cfg = load.config("reconet")
    a = reconet.stylizer_weights(cfg, 7, "cpu")
    b = reconet.stylizer_weights(cfg, 7, "cpu")
    c = reconet.stylizer_weights(cfg, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.conv2d.weight"], c["conv1.conv2d.weight"])
    ada = adaattn.stylizer_weights(load.config("adaattn"), 7, "cpu")
    assert ada["decoder.conv8.conv.bias"].mean() == 127.5
