"""The FLOP and byte counts the roofline and mfu metrics read."""

import pytest

from portbench.core import load
from portbench.core.peaks import bound_seconds
from portbench.counts import adaattn, reconet


def test_reconet_forward_is_the_hand_count_of_bench_md():
    # BENCH.md's roofline table: 175 conv GFLOP per 512² frame
    cfg = load.config("reconet")
    assert reconet.forward_flops(cfg, 512, 512) / 1e9 == pytest.approx(
        175.3, abs=0.05)
    rows = {n: 2 * h * w * ci * co * k * k / 1e9
            for n, h, w, ci, co, k in reconet.layers(cfg, 512, 512)}
    assert rows["stem"] == pytest.approx(6.1, abs=0.05)
    assert sum(v for n, v in rows.items() if n.startswith("res")) == \
        pytest.approx(108.7, abs=0.05)
    assert rows["deconv1"] == pytest.approx(21.7, abs=0.05)


def test_reconet_kernel_calls_are_the_residual_convs_stem_and_head():
    cfg = load.config("reconet")
    calls = reconet.kernel_calls(cfg, 8, 360, 640, "bfloat16")
    assert len(calls) == 12
    res = calls[1]
    assert res[0] == 8 * 2 * 90 * 160 * 192 * 192 * 9
    assert res[1] == 2 * (8 * 90 * 160 * 384 + 9 * 192 * 192) + 4 * 2 * 8 * 192
    f32 = reconet.kernel_calls(cfg, 8, 360, 640, "float32")
    assert f32[1][1] > res[1]


def test_adaattn_levels_and_attention_work():
    cfg = load.config("adaattn")
    assert adaattn.levels(cfg, 256, 256) == [(4096, 448, 256),
                                             (1024, 960, 512),
                                             (256, 1472, 512)]
    (f, b), *_ = adaattn.k3_calls(cfg, 8, 256, 256, "float32")
    assert f == 8 * 2 * 4096 * 4096 * (448 + 512)
    assert b == 8 * (4 * (2 * 4096 * 448 + 4096 * 256)
                     + 4 * (2 * 4096 * 256 + 4096))


def test_adaattn_step_kernels_k3_twice_k4_k5_once_a_level():
    cfg = load.config("adaattn")
    calls = adaattn.step_kernel_calls(cfg)
    assert len(calls) == 12
    fwd = sum(f for f, _ in calls[:3])
    assert sum(f for f, _ in calls) == 4 * fwd   # 2 K3, K4 + K5 = 2 K3


def test_step_counts_exceed_three_forwards_of_the_trained_network():
    r, a = load.config("reconet"), load.config("adaattn")
    h, w = r["train"]["img_size"]
    assert reconet.step_flops(r) > 4 * 3 * reconet.forward_flops(r, h, w) * 0.9
    assert adaattn.step_flops(a) > 8 * adaattn.stylizer_flops(a, 256, 256)


def test_bound_is_the_larger_of_compute_and_bytes():
    assert bound_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert bound_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert bound_seconds(495e12, 1, "float32") == pytest.approx(1.0)
