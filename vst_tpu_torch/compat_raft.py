"""torchvision ``raft_large`` state_dict ↔ the port's RAFT parameters.

Counterpart of ``vst_tpu/compat/raft_torchvision.py``.  The reference runs
torchvision's pretrained ``raft_large`` to generate optical flow
(AdaAttN/datasets.py:73-96, AdaAttN/exps_video.py:42);
``vst_tpu_torch/models/raft.py`` keys its parameters as the JAX package
does, and this key table carries a ``Raft_Large_Weights.C_T_SKHT_V2`` (or
any) torchvision checkpoint across without torchvision.

Key table (torchvision module path → the port's param base).  Convs followed
by a norm layer carry no bias in torchvision (Conv2dNormActivation sets
``bias = norm_layer is None``); the JAX layout always has a ``.bias``
entry, which the converter fills with zeros — numerically identical.

Encoders (``fnet`` ← ``feature_encoder`` with InstanceNorm [no params],
``cnet`` ← ``context_encoder`` with BatchNorm [eval statistics]):

    {tv}.convnormrelu.0            → {ours}.conv1          (7×7/2, no bias)
    {tv}.convnormrelu.1            → {ours}.norm1          (BN only)
    {tv}.layer{L}.{B}.convnormrelu1.0 → {ours}.layer{L}.{B}.conv1
    {tv}.layer{L}.{B}.convnormrelu1.1 → {ours}.layer{L}.{B}.norm1
    {tv}.layer{L}.{B}.convnormrelu2.0 → {ours}.layer{L}.{B}.conv2
    {tv}.layer{L}.{B}.convnormrelu2.1 → {ours}.layer{L}.{B}.norm2
    {tv}.layer{L}.0.downsample.0   → {ours}.layer{L}.0.downsample   (L=2,3)
    {tv}.layer{L}.0.downsample.1   → {ours}.layer{L}.0.downsample_norm
    {tv}.conv                      → {ours}.conv2          (1×1, has bias)

Update block:

    update_block.motion_encoder.convcorr1.0 → update.enc.convc1
    update_block.motion_encoder.convcorr2.0 → update.enc.convc2
    update_block.motion_encoder.convflow1.0 → update.enc.convf1
    update_block.motion_encoder.convflow2.0 → update.enc.convf2
    update_block.motion_encoder.conv.0      → update.enc.conv
    update_block.recurrent_block.convgru1.conv{z,r,q} → update.gru.conv{z,r,q}h
    update_block.recurrent_block.convgru2.conv{z,r,q} → update.gru.conv{z,r,q}v
    update_block.flow_head.conv{1,2}        → update.flow.conv{1,2}
    mask_predictor.convrelu.0               → update.mask.conv1
    mask_predictor.conv                     → update.mask.conv2

Both sides are torch layout (OIHW), so only the keys change; norm vectors
are unchanged and ``num_batches_tracked`` is dropped.
"""

import torch

# (ours_base, tv_conv_base, tv_has_bias)
_CONV_TABLE = []
# (ours_norm_base, tv_norm_base) — only materialized for the BN encoder
_NORM_TABLE = []


def _add_encoder(ours, tv, batch_norm):
    _CONV_TABLE.append((f"{ours}.conv1", f"{tv}.convnormrelu.0", False))
    if batch_norm:
        _NORM_TABLE.append((f"{ours}.norm1", f"{tv}.convnormrelu.1"))
    for layer, blocks in ((1, 2), (2, 2), (3, 2)):
        for b in range(blocks):
            o = f"{ours}.layer{layer}.{b}"
            t = f"{tv}.layer{layer}.{b}"
            _CONV_TABLE.append((f"{o}.conv1", f"{t}.convnormrelu1.0", False))
            _CONV_TABLE.append((f"{o}.conv2", f"{t}.convnormrelu2.0", False))
            if batch_norm:
                _NORM_TABLE.append((f"{o}.norm1", f"{t}.convnormrelu1.1"))
                _NORM_TABLE.append((f"{o}.norm2", f"{t}.convnormrelu2.1"))
            if layer > 1 and b == 0:
                _CONV_TABLE.append(
                    (f"{o}.downsample", f"{t}.downsample.0", False))
                if batch_norm:
                    _NORM_TABLE.append(
                        (f"{o}.downsample_norm", f"{t}.downsample.1"))
    _CONV_TABLE.append((f"{ours}.conv2", f"{tv}.conv", True))


_add_encoder("fnet", "feature_encoder", batch_norm=False)
_add_encoder("cnet", "context_encoder", batch_norm=True)

_ME = "update_block.motion_encoder"
_RB = "update_block.recurrent_block"
_CONV_TABLE += [
    ("update.enc.convc1", f"{_ME}.convcorr1.0", True),
    ("update.enc.convc2", f"{_ME}.convcorr2.0", True),
    ("update.enc.convf1", f"{_ME}.convflow1.0", True),
    ("update.enc.convf2", f"{_ME}.convflow2.0", True),
    ("update.enc.conv", f"{_ME}.conv.0", True),
    ("update.flow.conv1", "update_block.flow_head.conv1", True),
    ("update.flow.conv2", "update_block.flow_head.conv2", True),
    ("update.mask.conv1", "mask_predictor.convrelu.0", True),
    ("update.mask.conv2", "mask_predictor.conv", True),
]
for _gate in ("z", "r", "q"):
    _CONV_TABLE.append(
        (f"update.gru.conv{_gate}h", f"{_RB}.convgru1.conv{_gate}", True))
    _CONV_TABLE.append(
        (f"update.gru.conv{_gate}v", f"{_RB}.convgru2.conv{_gate}", True))

_NORM_SUFFIXES = ("weight", "bias", "running_mean", "running_var")


def _tensor(v):
    return torch.as_tensor(v).detach().cpu()


def convert_raft_state_dict(state: dict) -> dict:
    """torchvision ``raft_large`` state_dict → the port's RAFT parameters
    (CPU tensors, OIHW)."""
    out = {}
    for ours, tv, has_bias in _CONV_TABLE:
        w = _tensor(state[f"{tv}.weight"]).float()
        out[f"{ours}.weight"] = w.contiguous()
        out[f"{ours}.bias"] = (_tensor(state[f"{tv}.bias"]).float()
                               if has_bias else torch.zeros(w.shape[0]))
    for ours, tv in _NORM_TABLE:
        for s in _NORM_SUFFIXES:
            out[f"{ours}.{s}"] = _tensor(state[f"{tv}.{s}"]).float()
    return out


def raft_params_to_torchvision(params: dict) -> dict:
    """Inverse mapping (CPU tensors, torchvision key names).

    Biases that torchvision's layout lacks are dropped (they are zeros in
    any converted checkpoint; anything non-zero there cannot round-trip).
    """
    out = {}
    for ours, tv, has_bias in _CONV_TABLE:
        out[f"{tv}.weight"] = _tensor(params[f"{ours}.weight"]).clone()
        if has_bias:
            out[f"{tv}.bias"] = _tensor(params[f"{ours}.bias"]).clone()
    for ours, tv in _NORM_TABLE:
        for s in _NORM_SUFFIXES:
            out[f"{tv}.{s}"] = _tensor(params[f"{ours}.{s}"]).clone()
    return out


def raft_params(state: dict) -> dict:
    """A RAFT state as the port's parameters: a torchvision ``raft_large``
    state_dict (bare, or under a checkpoint's ``"model"`` key) through the
    key table, one keyed as the JAX package keys it as it is."""
    if isinstance(state.get("model"), dict):
        state = state["model"]
    if "feature_encoder.convnormrelu.0.weight" in state:
        return convert_raft_state_dict(state)
    return state


def load_raft_pth(path: str) -> dict:
    """A torchvision raft_large ``.pth`` checkpoint as the port's RAFT
    parameters."""
    return raft_params(torch.load(path, map_location="cpu",
                                  weights_only=True))
