"""The benchmark's ``rtnstv`` configuration on the CPU: its plain reference
(``portbench/reference/rtnstv.py``) against the port's RTNSTV in float32
and on the served bfloat16 path, its FLOP count against torch's counter,
the reference's imports, and the ``launches_per_frame.serve`` reader on a
hand-built trace."""

import ast

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.core import load
from portbench.core.record import Run
from portbench.core.trace import Trace
from portbench.counts import rtnstv as counts
from portbench.reference import common as ref_common
from portbench.reference import rtnstv as ref
from vst_tpu_torch.infer.image import stylize_rtnstv
from vst_tpu_torch.models import rtnstv as pr

CFG = load.config("rtnstv")
CELL = load.cell("rtnstv-serve")
SEEDS = [1, 2**31 + 12345]


def _frames(seed, n=2, h=32, w=48):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_forward_matches_the_port_in_float32(seed):
    """The port (K1's plain version on the CPU) against the reference on the
    same seeded weights.  Tolerance 1e-2 of the 0-255 output: float32
    rounding through 16 convs and 11 instance norms, in another order,
    gives about 1e-3; bfloat16 anywhere would give whole steps."""
    torch.set_num_threads(4)
    w = ref.stylizer_weights(CFG, seed, "cpu")
    x = _frames(seed)
    with torch.no_grad():
        want = ref.forward(w, x.permute(0, 3, 1, 2).float())
        got = pr.build(w, "cpu", torch.float32)(x.float())
    assert got.shape == (2, 32, 48, 3)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=0,
                               atol=1e-2)
    # the seeded output spans most of 0-255 (no head gain needed)
    assert want.min() < 25 and want.max() > 230


def _gaps(got, want):
    d = (got.int() - want.int()).abs()
    return int(d.max()), float(d.float().mean())


@pytest.mark.parametrize("seed", SEEDS)
def test_served_bf16_is_within_the_cells_limits_and_the_control_is_not(seed):
    """``stylize_rtnstv(..., uint8_out=True)`` on bf16 weights against
    ``reference.serve`` from the same (bf16-rounded) weights in float32,
    within ``rtnstv-serve``'s limits; the float8 control exceeds one."""
    torch.set_num_threads(4)
    limits = CELL["check"]["limits"]
    w = {k: v.to(torch.bfloat16) for k, v in
         ref.stylizer_weights(CFG, seed, "cpu").items()}
    wf = {k: v.float() for k, v in w.items()}
    x = _frames(seed)
    with torch.no_grad():
        want = ref.serve(wf, x)
        control = ref.serve(wf, x, ref_common.FP8())
    got = stylize_rtnstv(pr.build(w, "cpu", torch.bfloat16), x,
                         uint8_out=True)
    assert got.dtype == torch.uint8 and got.shape == x.shape
    worst, mean = _gaps(got, want)
    assert worst <= limits["max_abs_u8"] and mean <= limits["mean_abs_u8"]
    worst, mean = _gaps(control, want)
    assert worst > limits["max_abs_u8"] or mean > limits["mean_abs_u8"]


@pytest.mark.parametrize("hw", [(32, 48), (64, 96)])
def test_forward_flops_are_torchs_count_of_the_reference(hw):
    h, w = hw
    weights = ref.stylizer_weights(CFG, 3, "cpu")
    x = torch.rand(1, 3, h, w) * 255
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(weights, x)
    assert counts.forward_flops(CFG, h, w) == fc.get_total_flops()


def test_the_640x360_frame_and_k1_calls():
    assert counts.forward_flops(CFG, 360, 640) / 1e9 == pytest.approx(
        8.228, abs=5e-4)
    calls = counts.kernel_calls(CFG, 8, 360, 640, "bfloat16")
    assert len(calls) == 10
    f, b = calls[0]
    assert f == 8 * 2 * 90 * 160 * 48 * 48 * 9
    assert b == 2 * (8 * 90 * 160 * 96 + 9 * 48 * 48) + 4 * 2 * 8 * 48


def test_the_reference_imports_nothing_of_either_package():
    tree = ast.parse(open(ref.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"vst_tpu", "vst_tpu_torch", "jax"}, tops


def test_launches_per_frame_reader():
    read = load.module("metrics", "launches_per_frame.serve").read
    device = [("k", 0.5, 0.6), ("Memcpy HtoD", 1.0, 1.1), ("k", 4.0, 5.0),
              ("Memset", 9.0, 9.5), ("k", 10.5, 11.0)]   # the last outside
    host = [("vst::stream.call", 0.2, 0.4), ("vst::stream.call", 5.0, 5.5),
            ("vst::stream.call", 10.2, 10.4)]              # the last outside
    run = Run(cell={}, config={}, seed=0, seconds=1.0, device="cpu",
              work={"batch": 8})
    assert read(run) is None
    run.trace = Trace(device, host, 0.0, 10.0)
    assert read(run) == 4 / 16
    run.trace = Trace(device, [], 0.0, 10.0)   # a program without the span
    assert read(run) is None
