"""AdaAttN arbitrary-style model.

Counterpart of ``vst_tpu/models/adaattn.py`` (parity target
AdaAttN/network.py:11-251).  ``StylizingNetwork``'s ``state_dict`` keys
equal the JAX parameter keys, which are the reference's names: 1×1
attention convs ``adaattn.<i>.{f,g,h}.*``, decoder convs
``decoder.conv<k>[.<j>].conv[.conv].*`` (OIHW).

Attention (AdaAttN/network.py:191-220): with Q from the instance-normed
multi-scale content pyramid, K from the style pyramid and V from style
features, A = act(QKᵀ), M = A·V, S = sqrt(A·V² − M²), out = S·IN(c) + M.

Routing of ``attention_moments``:
- softmax, modes ``"auto"``, ``"pallas"``, ``"chunked"``, ``"train"``:
  ``kernels/adaattn_attention.py::softmax_attention_moments`` at every
  level and every size, with or without a gradient: on the card kernel K3
  forward and, where the inputs need a gradient, K4 (dQ) and K5 (dK, dV)
  backward; on CPU tensors their query-chunked plain versions.
- softmax ``"exact"``: the materialized oracle (autograd through it), on
  any device.
- cosine: the closed linear form (``"exact"``: the materialized oracle),
  plain torch matmuls, no kernel.
``stylizing_network(remat=True)`` checkpoints each attention module and
the decoder (``torch.utils.checkpoint``).

With a ``mesh`` (``parallel/mesh.py``) the attention runs
sequence-parallel over ``mesh_axis`` (``parallel/attention.py``): cosine
as one all-reduce of the key moments, softmax as ring attention through
K3.  Every rank passes the full q, k and v and gets the full M1 and M2
back (its token shard computed, the others all-gathered), as JAX's
global arrays; the token counts must divide by the axis size.  It
differentiates as ``jax.grad`` of JAX's does: the scatter of q, k, v into
token shards and the gather of M1, M2 are an adjoint pair of autograd
Functions (``parallel/attention.py::scatter_tokens``, ``gather_tokens``),
and the sharded functions carry their own backward (the cosine
all-reduce's, the ring's through K4 and K5 at every hop), so every rank,
computing the same loss from the gathered moments, gets the
single-device gradients of q, k, v and of every parameter upstream.
Under ``remat=True`` the ring's forward and its collectives run again
inside the backward.

With ``spatial`` (``parallel/spatial.py``) the content taps are this
rank's row blocks of an H-sharded frame and the style taps whole (every
rank encodes the style, as JAX replicates it): each block's queries are a
contiguous range of the row-major tokens, so one ``attention_moments``
call of the local queries against the whole style's K/V (one K3 launch a
level for softmax, the linear form for cosine) needs no collective; the
content instance norms all-reduce their sums, ``_up2`` takes one row a
side (repeated at the frame's edges) and the decoder's reflect convs
theirs.  It serves and trains (``train/steps.py``'s AdaAttN steps over a
data × space mesh: K3 forward, K4/K5 backward on the block's queries);
H must divide by 16 times the axis size.

Each level's attention module runs in the span "vst::adaattn.attention"
and the decoder in "vst::adaattn.decoder" (``utils/profiling.py::span``).
"""

import torch
import torch.nn as nn

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.kernels import adaattn_attention
from vst_tpu_torch.models.init import as_rng, conv_init
from vst_tpu_torch.models.remat import segment
from vst_tpu_torch.ops.conv import conv2d, conv2d_reflect
from vst_tpu_torch.ops.features import feature_down_sample, pyramid_rows
from vst_tpu_torch.ops.norm import instance_norm
from vst_tpu_torch.ops.resize import upsample_bilinear2
from vst_tpu_torch.utils.profiling import span

V_DIMS = (256, 512, 512)
QK_DIMS = (64 + 128 + 256, 64 + 128 + 256 + 512, 64 + 128 + 256 + 512 + 512)
DECODER = [("decoder.conv1.conv.conv", 512, 512),
           ("decoder.conv2.conv.conv", 512, 256),
           ("decoder.conv3.0.conv.conv", 512, 256),
           ("decoder.conv3.1.conv.conv", 256, 256),
           ("decoder.conv3.2.conv.conv", 256, 256),
           ("decoder.conv4.conv.conv", 256, 128),
           ("decoder.conv5.conv.conv", 128, 128),
           ("decoder.conv6.conv.conv", 128, 64),
           ("decoder.conv7.conv.conv", 64, 64),
           ("decoder.conv8.conv", 64, 3)]


# ------------------------------------------------------------- modules

class Conv(nn.Module):
    """AdaAttN ``Conv``: reflection pad k//2 + conv (network.py:11-21)."""

    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k)

    def forward(self, x, spatial=None):
        return conv2d_reflect(x, self.conv.weight, self.conv.bias,
                              spatial=spatial)


class ConvReLU(nn.Module):
    """``ConvReLU`` (network.py:24-33); the inner Conv adds a ``.conv``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout)

    def forward(self, x, spatial=None):
        return torch.relu(self.conv(x, spatial))


class AttentionConvs(nn.Module):
    """The 1×1 f (query), g (key) and h (value) convs of one module."""

    def __init__(self, qk, v):
        super().__init__()
        self.f = nn.Conv2d(qk, qk, 1)
        self.g = nn.Conv2d(qk, qk, 1)
        self.h = nn.Conv2d(v, v, 1)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvReLU(512, 512)
        self.conv2 = ConvReLU(512, 256)
        self.conv3 = nn.Sequential(ConvReLU(512, 256), ConvReLU(256, 256),
                                   ConvReLU(256, 256))
        self.conv4 = ConvReLU(256, 128)
        self.conv5 = ConvReLU(128, 128)
        self.conv6 = ConvReLU(128, 64)
        self.conv7 = ConvReLU(64, 64)
        self.conv8 = Conv(64, 3)


class StylizingNetwork(nn.Module):
    """Three attention modules (relu3_1, relu4_1, relu5_1) and the decoder;
    ``forward`` is ``stylizing_network``."""

    def __init__(self):
        super().__init__()
        self.adaattn = nn.ModuleList(
            AttentionConvs(QK_DIMS[i], V_DIMS[i]) for i in range(3))
        self.decoder = Decoder()

    def forward(self, fc, fs, activation="softmax", mode="auto"):
        return stylizing_network(self, fc, fs, activation, mode)


# ------------------------------------------------------------ attention

def _attention_moments_softmax_exact(q, k, v):
    """A = softmax(QKᵀ) in float32; returns (A·V, A·V²) in float32.
    q (b,n,d), k (b,m,d), v (b,m,c)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    a = torch.softmax(s, dim=-1)
    return torch.matmul(a, v.float()), torch.matmul(a, (v * v).float())


def wide_dtype(dtype):
    """Where the attention accumulates: float32, float64 for float64
    input (the exact evaluation the tests compare with)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _unit_rows(x):
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True))


def _attention_moments_cosine_linear(q, k, v):
    """Closed-form cos+1 row-normalized attention moments (no n×m map):
    a_ij = (q̂_i·k̂_j + 1) / (q̂_i·Σk̂ + m) (AdaAttN/network.py:111-125, the
    sums re-associated)."""
    return _cosine_moments(q, *_cosine_key_moments(k, v), k.shape[1])


def _cosine_key_moments(k, v):
    """The key half of the linear form in float32 (float64 for float64
    input): (Σk̂, K̂ᵀV, K̂ᵀV², ΣV, ΣV²), (b, ·) and (b, d, c); the
    sequence-parallel form sums them over the ranks
    (``parallel/attention.py``)."""
    acc = wide_dtype(k.dtype)
    kn = _unit_rows(k)
    vv = v * v
    kv = torch.einsum("bmd,bmc->bdc", kn.to(acc), v.to(acc))
    kv2 = torch.einsum("bmd,bmc->bdc", kn.to(acc), vv.to(acc))
    return (kn.sum(dim=1).to(acc), kv, kv2, v.sum(dim=1).to(acc),
            vv.sum(dim=1).to(acc))


def _cosine_moments(q, ksum, kv, kv2, vsum, v2sum, m):
    """The per-query half of the linear form (q is normalized here), in
    float32 (float64 for float64 q): ksum/vsum/v2sum (b, ·) or unbatched,
    kv/kv2 (b, d, c) or (d, c)."""
    acc = wide_dtype(q.dtype)
    qf = _unit_rows(q).to(acc)
    row = torch.matmul(qf, ksum.to(acc).unsqueeze(-1)).squeeze(-1) + m
    inv = (1.0 / row)[..., None]
    m1 = (torch.matmul(qf, kv.to(acc)) + vsum.to(acc).unsqueeze(-2)) * inv
    m2 = (torch.matmul(qf, kv2.to(acc)) + v2sum.to(acc).unsqueeze(-2)) * inv
    return m1, m2


def _attention_moments_cosine_exact(q, k, v):
    """Materialized cos+1 attention: the oracle of the linear form."""
    qf, kf, vf = q.float(), k.float(), v.float()
    qnorm = qf.square().sum(dim=-1, keepdim=True).sqrt()
    knorm = kf.square().sum(dim=-1, keepdim=True).sqrt()
    s = torch.matmul(qf, kf.transpose(1, 2))
    s = s / (qnorm * knorm.transpose(1, 2)) + 1.0
    a = s / s.sum(dim=-1, keepdim=True)
    return torch.matmul(a, vf), torch.matmul(a, (v * v).float())


def _sharded_moments(q, k, v, activation, mesh, axis):
    """The sequence-parallel moments on full q, k, v: this rank's token
    shard of each (``scatter_tokens``) through ``parallel/attention.py``,
    then M1 and M2 all-gathered along ``axis`` into the full (b, n, c)
    (``gather_tokens``).  The pair is adjoint, so every rank gets the
    single-device gradients of q, k and v."""
    from vst_tpu_torch.parallel import attention as sp

    n_dev = mesh.shape[axis]
    n, m = q.shape[1], k.shape[1]
    if n % n_dev or m % n_dev:
        raise ValueError(f"sequence-parallel attention: {n} query and {m} "
                         f"key tokens must divide by the {n_dev}-way "
                         f"'{axis}' axis")
    fn = {"cosine": sp.sharded_cosine_attention_moments,
          "softmax": sp.sharded_softmax_attention_moments}[activation]
    m1, m2 = fn(mesh, *(sp.scatter_tokens(mesh, axis, t) for t in (q, k, v)),
                axis)
    return sp.gather_tokens(mesh, axis, m1), sp.gather_tokens(mesh, axis, m2)


def attention_moments(q, k, v, activation: str, mode: str = "auto",
                      mesh=None, mesh_axis: str = "data"):
    """(A·V, A·V²) for q (b,n,d), k (b,m,d), v (b,m,c); routing in the
    module docstring.  K and V may be broadcast over the batch."""
    if activation not in ("cosine", "softmax"):
        raise ValueError(f"Unknown activation: {activation}")
    if mesh is not None:
        return _sharded_moments(q, k, v, activation, mesh, mesh_axis)
    if activation == "cosine":
        if mode == "exact":
            return _attention_moments_cosine_exact(q, k, v)
        return _attention_moments_cosine_linear(q, k, v)
    if mode == "exact":
        return _attention_moments_softmax_exact(q, k, v)
    if mode not in ("auto", "pallas", "chunked", "train"):
        raise ValueError(f"Unknown attention mode: {mode}")
    m1, m2, _ = adaattn_attention.softmax_attention_moments(q, k, v)
    return m1, m2


def _flatten_hw(x):
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def _apply_moments(c_x, m1, m2, spatial=None):
    """out = sqrt(max(M2 − M1², 1e-6))·IN(c) + M1 (network.py:214-220), in
    float32 (the variance cancels too much to take it in bf16), returned
    in c_x's dtype."""
    b, h, w, _ = c_x.shape
    m1, m2 = m1.float(), m2.float()
    s = torch.sqrt(torch.clamp(m2 - m1 * m1, min=1e-6))
    out = (s.reshape(b, h, w, -1)
           * instance_norm(c_x, spatial=spatial).float()
           + m1.reshape(b, h, w, -1))
    return out.to(c_x.dtype)


def _qkv_conv(layer, x):
    return conv2d(x, layer.weight, layer.bias)


def adaattn_module(params, name, c_x, s_x, c_1x, s_1x, activation,
                   mode="auto", mesh=None, mesh_axis="data", spatial=None):
    """One attention module (AdaAttN/network.py:174-220), NHWC.  ``name``
    e.g. ``"adaattn.0"``, a submodule of ``params``; ``name=None`` is the
    conv-free ``AdaAttnNoConv`` (network.py:128-171).  ``spatial``: c_x
    and c_1x are row blocks, s_x and s_1x whole (module docstring)."""
    qn = instance_norm(c_1x, spatial=spatial)
    kn = instance_norm(s_1x)
    if name is not None:
        convs = params.get_submodule(name)
        q = _qkv_conv(convs.f, qn)
        k = _qkv_conv(convs.g, kn)
        v = _qkv_conv(convs.h, s_x)
    else:
        q, k, v = qn, kn, s_x
    m1, m2 = attention_moments(_flatten_hw(q), _flatten_hw(k),
                               _flatten_hw(v), activation, mode, mesh=mesh,
                               mesh_axis=mesh_axis)
    return _apply_moments(c_x, m1, m2, spatial)


def adaattn_no_conv(c_x, s_x, c_1x, s_1x, activation, mode="auto",
                    spatial=None):
    return adaattn_module(None, None, c_x, s_x, c_1x, s_1x, activation, mode,
                          spatial=spatial)


# ------------------------------------------------- cached-style serving path

def style_state(params, fs, activation="cosine", mode="auto"):
    """The style-only half of every attention module, computed once for
    one style (tap dict with batch 1): the downsample pyramid, instance
    norm and g/h convs, and for the linear cosine form the key moments
    (ksum, vsum, v2sum, K̂ᵀV, K̂ᵀV²).  For ``stylizing_network_cached``."""
    fsl = list(fs.values())
    if fsl[0].shape[0] != 1:
        raise ValueError("style state is computed for one style (batch 1)")
    states = []
    for i in range(3):
        idx = i + 2
        convs = params.adaattn[i]
        k = _qkv_conv(convs.g, instance_norm(feature_down_sample(fsl, idx)))
        v = _qkv_conv(convs.h, fsl[idx])
        k2, v2 = _flatten_hw(k), _flatten_hw(v)
        if activation == "cosine" and mode != "exact":
            kn = _unit_rows(k2)
            vv = v2 * v2
            states.append({
                "m": float(k2.shape[1]),
                "ksum": kn.sum(dim=1)[0],
                "vsum": v2.sum(dim=1)[0].float(),
                "v2sum": vv.sum(dim=1)[0].float(),
                "kv": torch.einsum("bmd,bmc->bdc", kn.float(), v2.float())[0],
                "kv2": torch.einsum("bmd,bmc->bdc", kn.float(), vv.float())[0],
            })
        else:
            states.append({"k": k2[0], "v": v2[0]})
    return states


def stylizing_network_cached(params, fc, states, activation="cosine",
                             mode="auto"):
    """``stylizing_network`` against a precomputed ``style_state``: the
    same output, none of the per-frame style-side work.  A softmax state's
    K and V are broadcast over the content batch without a copy (batch
    stride 0, which K3 reads in place)."""
    apply_precision(next(iter(fc.values())).dtype)
    fcl = list(fc.values())
    outs = []
    for i in range(3):
        idx = i + 2
        st = states[i]
        with span("vst::adaattn.attention"):
            q = _qkv_conv(params.adaattn[i].f,
                          instance_norm(feature_down_sample(fcl, idx)))
            q2 = _flatten_hw(q)
            if "ksum" in st:
                m1, m2 = _cosine_moments(q2, st["ksum"], st["kv"], st["kv2"],
                                         st["vsum"], st["v2sum"], st["m"])
            else:
                b = q2.shape[0]
                k = st["k"].expand(b, *st["k"].shape)
                v = st["v"].expand(b, *st["v"].shape)
                m1, m2 = attention_moments(q2, k, v, activation, mode)
            outs.append(_apply_moments(fcl[idx], m1, m2))
    return decoder(params, outs[2], outs[1], outs[0])


# ----------------------------------------------------------------- decoder

def _up2(x, spatial=None):
    return upsample_bilinear2(x, spatial)


def decoder(params, x5, x4, x3, spatial=None):
    """AdaAttN Decoder (network.py:63-99) on the three attention outputs
    at the relu5_1/4_1/3_1 scales (NHWC; row blocks with ``spatial``), in
    the span "vst::adaattn.decoder"."""
    d = params.decoder
    with span("vst::adaattn.decoder"):
        x = d.conv2(d.conv1(_up2(x5, spatial) + x4, spatial), spatial)
        x = torch.cat([_up2(x, spatial), x3], dim=-1)
        for layer in d.conv3:
            x = layer(x, spatial)
        x = d.conv6(d.conv5(_up2(d.conv4(x, spatial), spatial), spatial),
                    spatial)
        return d.conv8(d.conv7(_up2(x, spatial), spatial), spatial)


# ------------------------------------------------------------- full model

def stylizing_network(params, fc: dict, fs: dict, activation="softmax",
                      mode="auto", mesh=None, mesh_axis="data",
                      remat=False, spatial=None):
    """Full AdaAttN stylizer (network.py:223-251) on ordered VGG19 tap
    dicts (``models/vgg.py::vgg19_adaattn_features``).

    ``remat=True`` checkpoints each attention module and the decoder
    separately (the JAX package's segments): backward holds one segment's
    internals at a time and recomputes them, K3 included.  ``mesh``:
    sequence-parallel attention over ``mesh_axis``; ``spatial``: fc holds
    this rank's row blocks of an H-sharded content (module docstring)."""
    if mesh is not None and spatial is not None:
        raise ValueError("stylizing_network: pass mesh= (a token-sharded "
                         "attention) or spatial= (an H-sharded content), "
                         "not both")
    apply_precision(next(iter(fc.values())).dtype)
    fcl = list(fc.values())
    fsl = list(fs.values())

    run_module = segment(
        lambda i, c_x, s_x, c_1x, s_1x: adaattn_module(
            params, f"adaattn.{i}", c_x, s_x, c_1x, s_1x, activation, mode,
            mesh, mesh_axis, spatial),
        remat)
    run_decoder = segment(
        lambda x5, x4, x3: decoder(params, x5, x4, x3, spatial), remat)
    rows = pyramid_rows(fcl, spatial)
    outs = []
    for i in range(3):
        idx = i + 2
        with span("vst::adaattn.attention"):
            outs.append(run_module(
                i, fcl[idx], fsl[idx],
                feature_down_sample(fcl, idx, spatial, rows),
                feature_down_sample(fsl, idx)))
    return run_decoder(outs[2], outs[1], outs[0])


# ---------------------------------------------------------------- init

def init_params(seed) -> dict:
    """numpy HWIO parameters drawn exactly as the JAX package's
    ``init_stylizing_network`` draws them (same order, same keys)."""
    rng = as_rng(seed)
    params = {}
    for i in range(3):
        for tag, ch in (("f", QK_DIMS[i]), ("g", QK_DIMS[i]),
                        ("h", V_DIMS[i])):
            w, b = conv_init(rng, 1, ch, ch)
            params[f"adaattn.{i}.{tag}.weight"] = w
            params[f"adaattn.{i}.{tag}.bias"] = b
    for name, cin, cout in DECODER:
        w, b = conv_init(rng, 3, cin, cout)
        params[f"{name}.weight"] = w
        params[f"{name}.bias"] = b
    return params


def build(state: dict, device="cuda",
          dtype: torch.dtype = torch.float32) -> StylizingNetwork:
    """A StylizingNetwork holding ``state`` (reference ``state_dict``
    layout, loaded strictly), on ``device`` at ``dtype``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = StylizingNetwork()
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device=dev, dtype=dtype).eval()


def init_stylizing_network(seed, device="cuda",
                           dtype: torch.dtype = torch.float32
                           ) -> StylizingNetwork:
    """A StylizingNetwork holding the JAX package's
    ``init_stylizing_network(seed)``."""
    dev = resolve_device(device)
    return build(params_from_jax(init_params(seed)), dev, dtype)

