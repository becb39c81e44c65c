"""The port's ReCoNet family (vst_tpu_torch/models) against the JAX package:
seeded init bit for bit, forwards with all taps, the goldens, weights
carried across, and image stylization."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.compat import save_pth as jax_save_pth
from vst_tpu.infer.image import stylize_reconet as j_stylize_reconet
from vst_tpu.models import reconet as jr
from vst_tpu.train.checkpoint import save_params
from vst_tpu_torch.compat import load_weights, params_from_jax, save_pth
from vst_tpu_torch.infer.image import stylize_reconet
from vst_tpu_torch.models import reconet as pr

JAX = {"reconet": (jr.init_reconet, jr.reconet),
       "sd1": (jr.init_reconet_sd1, jr.reconet_sd1),
       "sd2": (jr.init_reconet_sd2, jr.reconet_sd2)}
PORT_INIT = {"reconet": pr.init_reconet, "sd1": pr.init_reconet_sd1,
             "sd2": pr.init_reconet_sd2}
FAMILIES = list(JAX)


def image(rng, n, h, w, c=3):
    return (rng.random((n, h, w, c)) * 255).astype(np.float32)


def forward_both(family, x, seed=0, input_frame_num=1):
    jinit, jfwd = JAX[family]
    ref = jfwd(jinit(seed, input_frame_num), jnp.asarray(x))
    model = PORT_INIT[family](seed, input_frame_num, device="cpu")
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    return ref, ours


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("input_frame_num", [1, 2])
def test_init_bit_exact(family, input_frame_num):
    ref = JAX[family][0](3, input_frame_num)
    ours = pr.init_params(family, 3, input_frame_num)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    state = PORT_INIT[family](3, input_frame_num, device="cpu").state_dict()
    expect = params_from_jax(ref)
    assert set(state) == set(expect)
    for k, v in expect.items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_all_taps_32(rng, family):
    ref, ours = forward_both(family, image(rng, 1, 32, 32))
    assert len(ours) == len(ref) == len(pr.FAMILIES[family].TAPS) + 1
    for i, (r, o) in enumerate(zip(ref, ours)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3, err_msg=f"tap {i}")


@pytest.fixture(scope="module")
def goldens():
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "reference_numerics.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("family,key", [("reconet", "reconet_styled"),
                                        ("sd1", "sd1_styled"),
                                        ("sd2", "sd2_styled")])
def test_goldens(goldens, family, key):
    """The reference's numerics (functional-torch oracles, init_*(7)),
    reproduced without JAX."""
    model = PORT_INIT[family](7, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(goldens["input_x"]))[-1]
    np.testing.assert_allclose(out.numpy(), goldens[key], rtol=2e-3, atol=2e-3)


def test_stylize_reconet_uint8(rng):
    x = (rng.random((2, 32, 48, 3)) * 255).astype(np.uint8)
    ref = np.asarray(j_stylize_reconet(jr.init_reconet(1), jnp.asarray(x),
                                       uint8_out=True))
    ours = stylize_reconet(pr.init_reconet(1, device="cpu"), x, uint8_out=True)
    assert ours.dtype == torch.uint8 and ours.shape == ref.shape
    # the truncating cast can flip where a value sits on an integer
    assert np.abs(ours.numpy().astype(int) - ref.astype(int)).max() <= 1


def test_stylize_reconet_i420(rng):
    model = pr.init_reconet(1, device="cpu")
    x = (rng.random((2, 32, 48, 3)) * 255).astype(np.uint8)
    rgb = stylize_reconet(model, x, uint8_out=True)
    i420 = stylize_reconet(model, torch.from_numpy(x), wire="i420")
    from vst_tpu_torch.ops.yuv import rgb_to_i420

    assert i420.shape == (2, 48, 48) and i420.dtype == torch.uint8
    assert torch.equal(i420, rgb_to_i420(rgb))


class TestWeights:
    def test_reference_pth_loads_strict(self, tmp_path):
        """A reference-layout .pth written by the JAX package loads into the
        port's module with strict=True and equals the JAX parameters."""
        params = jr.init_reconet_sd1(5)
        path = str(tmp_path / "sd1.pth")
        jax_save_pth(params, path)
        state = load_weights(path)
        model = pr.build("sd1", state, device="cpu")
        for k, v in params_from_jax(params).items():
            assert torch.equal(model.state_dict()[k], v), k

    def test_npz_and_roundtrip(self, tmp_path):
        params = jr.init_reconet(4)
        npz = str(tmp_path / "r.npz")
        save_params(params, npz)
        state = load_weights(npz)
        model = pr.build("reconet", state, device="cpu")
        out = str(tmp_path / "r.pth")
        save_pth(model, out)
        again = load_weights(out)
        assert set(again) == set(state)
        assert all(torch.equal(again[k], state[k]) for k in state)

    def test_wrong_family_rejected(self, tmp_path):
        from vst_tpu_torch.cli.common import check_weights_match

        state = params_from_jax(jr.init_reconet_sd2(0))
        with pytest.raises(SystemExit, match="does not look like"):
            check_weights_match(state, "reconet", "x.pth")
        check_weights_match(state, "sd2", "x.pth")
