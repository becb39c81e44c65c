"""RTNSTV's stylizing network as ``nn.Module``s.

Counterpart of ``vst_tpu/models/rtnstv.py`` (parity target
RTNSTV/network.py:10-91).  ``state_dict`` keys equal the reference's
(``conv1.conv.weight``, ``res1.conv2.norm.bias``,
``deconv1.deconv.weight``, …) with OIHW conv weights and (I, O, kh, kw)
transposed-conv weights, so a reference ``.pth`` loads with
``strict=True``.  The forward takes NHWC 0–255 RGB and returns the styled
frames, (tanh + 1) / 2 · 255: one tensor, not a tap tuple.

Network: 3→16→32→48 encoder (3×3 convs, the last two of stride 2), five
48-channel residual blocks, two stride-2 transposed-conv decoders (48→32
→16), and a 16→3 conv + tanh head; every conv reflect-pads and is
followed by an affine instance norm.

Routing: every residual block runs as two K1 launches and a float32 tail
(``kernels/res_block.py::residual_block_fused``), on the card always; on
CPU tensors K1's plain version runs.  The other convs are ``F.conv2d``
and the decoders ``F.conv_transpose2d``, as the JAX package leaves them
to XLA.

``forward(x, spatial=ctx)`` (``parallel/spatial.py``) runs the network
over this rank's row block of an H-sharded frame, every layer exchanging
its halo rows and the residual blocks on K1's halo-rows mode; the block
starts on a multiple of 4 rows and, but for the frame's last block, holds
whole 4-row units (``parallel/spatial.py::row_layout``).  It serves, and every layer carries its gradient: ``train/steps.py``'s
``make_rtnstv_step`` trains on it over a data × space mesh.
"""

import torch
import torch.nn as nn

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.kernels.res_block import residual_block_fused
from vst_tpu_torch.models.init import (as_rng, conv_init, conv_transpose_init,
                                       instance_norm_init)
from vst_tpu_torch.models.reconet import _hwio
from vst_tpu_torch.ops.conv import conv2d_reflect, conv_transpose2d
from vst_tpu_torch.ops.norm import instance_norm
from vst_tpu_torch.parallel.spatial import check_rows
from vst_tpu_torch.utils.profiling import span

# (name, in, out, stride, activation) of the encoder, the head last
ENCODER = [("conv1", 3, 16, 1, "relu"), ("conv2", 16, 32, 2, "relu"),
           ("conv3", 32, 48, 2, "relu")]
HEAD = ("conv4", 16, 3, 1, "tanh")
RES_BLOCKS = [f"res{i}" for i in range(1, 6)]
WIDTH = 48
DECODER = [("deconv1", 48, 32), ("deconv2", 32, 16)]
_ACT = {"relu": torch.relu, "tanh": torch.tanh, None: None}


class ConvBlock(nn.Module):
    """Reflect-pad k//2 + conv + InstanceNorm(affine) + an optional
    activation (RTNSTV/network.py:10-26)."""

    def __init__(self, cin, cout, k=3, stride=1, activation=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride)
        self.norm = nn.InstanceNorm2d(cout, affine=True)
        self.activation = activation

    def forward(self, x, spatial=None):
        c = self.conv
        x = instance_norm(conv2d_reflect(x, c.weight, c.bias, c.stride[0],
                                         spatial=spatial),
                          self.norm.weight, self.norm.bias, spatial=spatial)
        act = _ACT[self.activation]
        return act(x) if act is not None else x


class ResBlock(nn.Module):
    """ConvBlock(relu) + ConvBlock(None) + the input, zero-padded to the
    output's channels where they differ (RTNSTV/network.py:29-45): two K1
    launches and a float32 tail."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ConvBlock(cin, cout, 3, 1, "relu")
        self.conv2 = ConvBlock(cout, cout, 3, 1)

    def forward(self, x, spatial=None):
        c1, c2 = self.conv1, self.conv2
        return residual_block_fused(
            x, _hwio(c1.conv.weight), c1.conv.bias, c1.norm.weight,
            c1.norm.bias, _hwio(c2.conv.weight), c2.conv.bias,
            c2.norm.weight, c2.norm.bias, spatial=spatial)


class DeconvBlock(nn.Module):
    """ConvTranspose2d(k 3, s 2, p 1, op 1) + InstanceNorm(affine) + relu
    (RTNSTV/network.py:48-60)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(cin, cout, 3, 2, padding=1,
                                         output_padding=1)
        self.norm = nn.InstanceNorm2d(cout, affine=True)

    def forward(self, x, spatial=None):
        x = conv_transpose2d(x, self.deconv.weight, self.deconv.bias,
                             spatial=spatial)
        return torch.relu(instance_norm(x, self.norm.weight, self.norm.bias,
                                        spatial=spatial))


class StylizingNetwork(nn.Module):
    """RTNSTV's stylizer (RTNSTV/network.py:63-91)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, stride, act in ENCODER:
            self.add_module(name, ConvBlock(cin, cout, 3, stride, act))
        for name in RES_BLOCKS:
            self.add_module(name, ResBlock(WIDTH, WIDTH))
        for name, cin, cout in DECODER:
            self.add_module(name, DeconvBlock(cin, cout))
        name, cin, cout, stride, act = HEAD
        self.add_module(name, ConvBlock(cin, cout, 3, stride, act))

    def forward(self, x, spatial=None):
        """x: (N, H, W, 3) 0–255 in the parameters' dtype → the styled
        frames, 0–255; with ``spatial``, this rank's rows of both.  Each
        layer runs in the span "vst::RTNSTV.<layer>"."""
        apply_precision(x.dtype)
        if spatial is not None:
            check_rows(spatial, x.shape[1], 4, "RTNSTV")
        for name, layer in self.named_children():
            with span(f"vst::RTNSTV.{name}"):
                x = layer(x, spatial)
        return (x + 1.0) / 2.0 * 255.0


def _conv_params(rng, name, cin, cout, k=3, init=conv_init, kind="conv"):
    w, b = init(rng, k, cin, cout)
    s, sb = instance_norm_init(cout)
    return {f"{name}.{kind}.weight": w, f"{name}.{kind}.bias": b,
            f"{name}.norm.weight": s, f"{name}.norm.bias": sb}


def init_params(seed) -> dict:
    """numpy JAX-layout parameters drawn exactly as the JAX package's
    ``init_stylizing_network`` draws them (same order, same keys)."""
    rng = as_rng(seed)
    params = {}
    for name, cin, cout, _, _ in ENCODER:
        params.update(_conv_params(rng, name, cin, cout))
    for name in RES_BLOCKS:
        params.update(_conv_params(rng, f"{name}.conv1", WIDTH, WIDTH))
        params.update(_conv_params(rng, f"{name}.conv2", WIDTH, WIDTH))
    for name, cin, cout in DECODER:
        params.update(_conv_params(rng, name, cin, cout,
                                   init=conv_transpose_init, kind="deconv"))
    name, cin, cout, _, _ = HEAD
    params.update(_conv_params(rng, name, cin, cout))
    return params


def build(state: dict, device="cuda",
          dtype: torch.dtype = torch.float32) -> StylizingNetwork:
    """A StylizingNetwork holding ``state`` (reference ``state_dict``
    layout, loaded strictly), on ``device`` at ``dtype``."""
    dev = resolve_device(device)
    model = StylizingNetwork()
    model.load_state_dict(state, strict=True)
    return model.to(device=dev, dtype=dtype).eval()


def init_stylizing_network(seed, device="cuda",
                           dtype: torch.dtype = torch.float32
                           ) -> StylizingNetwork:
    """A StylizingNetwork holding the JAX package's
    ``init_stylizing_network(seed)``."""
    dev = resolve_device(device)
    return build(params_from_jax(init_params(seed)), dev, dtype)
