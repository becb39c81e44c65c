"""The trace reduction and the window statistics."""

import statistics

import numpy as np
import pytest

from portbench.core import load, stats
from portbench.core.record import Run
from portbench.core.trace import Trace, gaps, short_name, union_seconds


def test_union_counts_overlapping_kernels_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.7), (5.0, 6.0)]
    assert union_seconds(iv) == pytest.approx(4.0)
    # the sum of durations, the old "busy", counts the overlap twice
    assert sum(b - a for a, b in iv) == pytest.approx(5.2)


def test_union_of_nested_and_touching_intervals():
    assert union_seconds([(0, 10), (1, 2), (3, 4), (10, 11)]) == 11
    assert union_seconds([]) == 0


def test_idle_share_from_the_union_of_intervals():
    dev = [("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("k3", 6.0, 7.0),
           ("k4", 9.5, 12.0)]
    tr = Trace(dev, [], 0.0, 10.0)
    assert tr.busy_s == pytest.approx(3.0 + 1.0 + 0.5)
    assert tr.window_s == 10.0
    assert gaps(tr.clipped(), 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                             (7.0, 9.5)]


def test_breakdown_names_ops_and_gaps_by_the_harness_span():
    dev = [("void conv3x3_wgmma<true, 2>(ConvArgs, CUtensorMap, int)",
            1.0, 2.0), ("void conv3x3_wgmma<true, 2>(ConvArgs)", 3.0, 3.5),
           ("elementwise", 5.0, 9.0)]
    host = [("portbench.dispatch", 2.0, 2.9), ("portbench.read", 0.0, 9.0),
            ("aten::conv2d", 3.5, 5.0)]
    b = Trace(dev, host, 0.0, 10.0).breakdown()
    assert b["device_ops"][0] == ["elementwise", 4.0]
    assert b["device_ops"][1] == ["conv3x3_wgmma<true, 2>", 1.5]
    assert b["idle_gaps"][0] == ["read", 1.5]      # 3.5 .. 5.0
    assert b["idle_gaps"][-1] == ["host", 1.0]      # 9.0 .. 10.0, after read
    assert ["dispatch", 1.0] in b["idle_gaps"]       # 2.0 .. 3.0


def test_kernel_time_and_count_by_pattern():
    tr = Trace([("attn_fwd_tf32", 0, 1), ("attn_dq_tf32", 1, 3),
                ("split_tf32", 3, 3.5), ("cudnn", 4, 9)], [], 0, 10)
    assert tr.kernel_seconds(("attn_", "split_tf32")) == 3.5
    assert tr.kernel_count(("attn_fwd",)) == 1


def test_short_name():
    assert short_name("void finalize_stats<true>(float const*, int)") == \
        "finalize_stats<true>"
    assert short_name("void at::native::(anonymous namespace)::"
                      "reflection_pad2d_out_kernel<float>(float const*)") == \
        "at::native::reflection_pad2d_out_kernel<float>"


def test_percentile_is_numpys_and_takes_every_sample():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=1001))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.median(xs) == pytest.approx(np.median(xs))


def _read(metric, **fields):
    run = Run(cell={}, config={}, seed=0, seconds=2.0, **fields)
    return load.module("metrics", metric).read(run)


def test_a_stall_in_the_window_moves_the_tail_and_the_rate():
    # 400 frames at 5 ms; then the same frames with a stall of 1 s that
    # holds the last 30 of them
    lat = [0.005] * 400
    stalled = lat[:370] + [1.0] * 30
    steady = _read("frame_latency_p95_ms", latencies_s=lat)
    assert _read("frame_latency_p95_ms", latencies_s=stalled) > 100 * steady
    # a rate over the whole window: the stall's second is in it
    assert _read("frames_per_s", frames=400, window_s=3.0) < _read(
        "frames_per_s", frames=400, window_s=2.0)
    assert _read("samples_per_s", samples=400, window_s=3.0) == \
        pytest.approx(400 / 3.0)
    # a median of chunks would not see it: 9 of 10 chunks are unchanged
    chunks = [0.005] * 9 + [1.0]
    assert stats.median(chunks) == 0.005


def test_quartile_spread_is_statistics_quantiles():
    xs = [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.quartile_spread(xs) == pytest.approx((q3 - q1) / q2)
