"""The port's RTNSTV (vst_tpu_torch/models/rtnstv.py) against the JAX
package: seeded init bit for bit, the transposed-conv weights carried
across both ways, a reference ``.pth`` loaded strictly, the transposed
conv, the forward in float32 and bfloat16, the golden, grad mode, and
``stylize_rtnstv`` on its three wires."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.compat import jax_to_torch_arrays
from vst_tpu.compat import save_pth as jax_save_pth
from vst_tpu.infer.image import stylize_rtnstv as j_stylize_rtnstv
from vst_tpu.models import rtnstv as jr
from vst_tpu.ops import conv_transpose2d as j_conv_transpose2d
from vst_tpu_torch.compat import load_weights, params_from_jax, params_to_jax
from vst_tpu_torch.infer.image import stylize_rtnstv
from vst_tpu_torch.models import rtnstv as pr
from vst_tpu_torch.ops.conv import conv_transpose2d
from tests import torch_refs as tr


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def image(rng, n, h, w):
    return (rng.random((n, h, w, 3)) * 255).astype(np.float32)


def both(seed, x, dtype=torch.float32):
    """JAX's and the port's forward of ``init_stylizing_network(seed)`` on
    ``x`` (numpy, float32), the JAX side at the matching dtype."""
    params = jr.init_stylizing_network(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jr.stylizing_network({k: jnp.asarray(v, jdt)
                                for k, v in params.items()},
                               jnp.asarray(x, jdt))
    model = pr.init_stylizing_network(seed, device="cpu", dtype=dtype)
    with torch.no_grad():
        ours = model(torch.from_numpy(x).to(dtype))
    return np.asarray(ref.astype(jnp.float32)), ours.float().numpy()


def test_init_bit_exact():
    ref = jr.init_stylizing_network(3)
    ours = pr.init_params(3)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    state = pr.init_stylizing_network(3, device="cpu").state_dict()
    expect = params_from_jax(ref)
    assert set(state) == set(expect)
    for k, v in expect.items():
        assert torch.equal(state[k], v), k


def test_deconv_weights_both_ways():
    """``params_from_jax`` gives the JAX package's torch layout (the
    ``.deconv.`` weights unflipped to (I, O, kh, kw)) and
    ``params_to_jax`` inverts it, bit for bit."""
    params = jr.init_stylizing_network(4)
    torch_layout = params_from_jax(params)
    ref = jax_to_torch_arrays(params)
    assert tuple(torch_layout["deconv1.deconv.weight"].shape) == (48, 32, 3, 3)
    for k, v in ref.items():
        np.testing.assert_array_equal(torch_layout[k].numpy(), v, err_msg=k)
    back = params_to_jax(torch_layout)
    assert list(back) == list(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reference_pth_loads_strict(tmp_path):
    """A reference-layout .pth written by the JAX package loads into the
    port's module with strict=True and equals the JAX parameters."""
    params = jr.init_stylizing_network(5)
    path = str(tmp_path / "rtnstv.pth")
    jax_save_pth(params, path)
    model = pr.build(load_weights(path), device="cpu")
    for k, v in params_from_jax(params).items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("h,w,cin,cout", [(8, 12, 48, 32), (7, 9, 32, 16)])
def test_conv_transpose2d(rng, h, w, cin, cout):
    """ConvTranspose2d(k 3, s 2, p 1, op 1) at even and odd sizes against
    JAX's input-dilated form on the flipped HWIO weights."""
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wj = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ref = np.asarray(j_conv_transpose2d(jnp.asarray(x), jnp.asarray(wj),
                                        jnp.asarray(b)))
    wt = params_from_jax({"d.deconv.weight": wj})["d.deconv.weight"]
    ours = conv_transpose2d(torch.from_numpy(x), wt, torch.from_numpy(b))
    assert ours.shape == ref.shape == (2, 2 * h, 2 * w, cout)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_forward_f32(rng):
    """Against ``stylizing_network`` (1e-3) and the functional torch
    oracle ``tests/torch_refs.py::t_rtnstv`` (2e-3, as
    tests/test_models_parity.py holds JAX to it), batch 2 at 48×64."""
    x = image(rng, 2, 48, 64)
    ref, ours = both(11, x)
    assert ours.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)
    state = {k: torch.from_numpy(v) for k, v in
             jax_to_torch_arrays(jr.init_stylizing_network(11)).items()}
    oracle = tr.t_rtnstv(state, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours, oracle.permute(0, 2, 3, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_forward_odd_size(rng):
    """An odd frame: the stride-2 encoder rounds each side up (17 → 9 →
    5), so the 2× decoders give 20×24, as the reference's do."""
    ref, ours = both(2, image(rng, 1, 17, 23))
    assert ours.shape == ref.shape == (1, 20, 24, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)


def test_res_block_widening_skip(rng):
    """A block whose output is wider than its input zero-pads the skip
    (RTNSTV/network.py:40-43), through K1's plain version here."""
    params = {}
    for name, cin, cout in (("r.conv1", 32, 48), ("r.conv2", 48, 48)):
        params.update(pr._conv_params(np.random.default_rng(3), name, cin,
                                      cout))
    x = rng.standard_normal((2, 10, 12, 32)).astype(np.float32)
    ref = np.asarray(jr.res_block({k: jnp.asarray(v) for k, v in
                                   params.items()}, "r", jnp.asarray(x)))
    block = pr.ResBlock(32, 48)
    block.load_state_dict({k[2:]: v for k, v in
                           params_from_jax(params).items()})
    with torch.no_grad():
        ours = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def goldens():
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "reference_numerics.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_golden(goldens):
    """The reference's numerics (init_stylizing_network(7)), as
    tests/test_goldens.py holds JAX to them."""
    model = pr.init_stylizing_network(7, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(goldens["input_x"]))
    np.testing.assert_allclose(out.numpy(), goldens["rtnstv_styled"],
                               rtol=2e-3, atol=2e-3)


def test_res_block_bf16(rng):
    """One 48-channel block in bf16 against JAX's ``res_block`` in bf16,
    within 0.02 of the output's scale: the bf16 tolerance of the ReCoNet
    parity tests (tests/test_torch_kernels.py::test_residual_block_bf16).
    JAX rounds each conv output, instance norm and the residual sum to
    bf16; the port's K1 route rounds the convs' outputs and keeps the
    block's tail in float32."""
    params = jr.init_stylizing_network(6)
    block = {k[len("res1."):]: v for k, v in params.items()
             if k.startswith("res1.")}
    xb = jnp.asarray(rng.standard_normal((2, 24, 32, 48)) * 3, jnp.bfloat16)
    ref = np.asarray(jr.res_block(
        {f"r.{k}": jnp.asarray(v, jnp.bfloat16) for k, v in block.items()},
        "r", xb).astype(jnp.float32))
    ours = pr.ResBlock(48, 48)
    ours.load_state_dict(params_from_jax(block))
    x = torch.from_numpy(np.array(xb.astype(jnp.float32)))
    with torch.no_grad():
        out = ours.to(torch.bfloat16)(x.to(torch.bfloat16)).float().numpy()
    assert np.abs(out - ref).max() <= 0.02 * np.abs(ref).max()


def test_forward_bf16(rng):
    """The whole bf16 forward, calibrated by the float32 one: through ten
    instance norms bf16 alone moves JAX's output whole steps of the 0–255
    scale from its float32 output, so the port's bf16 output must lie no
    farther from the float32 forward than JAX's bf16 output does (× 1.25,
    max and mean absolute error), and JAX's and the port's bf16 outputs
    agree on average within that noise."""
    x = np.round(image(rng, 2, 32, 48))   # exact in bf16
    ref16, ours16 = both(6, x, torch.bfloat16)
    ref32, _ = both(6, x)
    assert np.isfinite(ours16).all()
    for reduce in (np.max, np.mean):
        jax_noise = reduce(np.abs(ref16 - ref32))
        assert reduce(np.abs(ours16 - ref32)) <= 1.25 * jax_noise, reduce
    assert np.abs(ours16 - ref16).mean() <= 1.25 * np.abs(ref16 - ref32).mean()


def test_grad_mode_forward_is_the_inference_forward(rng):
    """With grad mode on (K1 as its autograd Function) the forward gives
    the inference-mode output bit for bit."""
    model = pr.init_stylizing_network(1, device="cpu")
    x = torch.from_numpy(image(rng, 1, 24, 32))
    with torch.inference_mode():
        ref = model(x)
    out = model(x)
    assert out.requires_grad
    assert torch.equal(out.detach(), ref)


@pytest.mark.parametrize("wire,uint8_out", [("rgb", False), ("rgb", True),
                                            ("i420", False)])
def test_stylize_rtnstv_matches_jax(rng, wire, uint8_out):
    """uint8 frames in; the clamped float frames within 1e-3 of JAX's, the
    truncating uint8 cast and the I420 packing within one step."""
    x = (rng.random((2, 32, 48, 3)) * 255).astype(np.uint8)
    ref = np.asarray(j_stylize_rtnstv(jr.init_stylizing_network(1),
                                      jnp.asarray(x), uint8_out=uint8_out,
                                      wire=wire))
    ours = stylize_rtnstv(pr.init_stylizing_network(1, device="cpu"), x,
                          uint8_out=uint8_out, wire=wire).numpy()
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if ours.dtype == np.uint8:
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)
