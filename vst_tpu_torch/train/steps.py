"""AdaAttN train steps.  Counterpart of the AdaAttN part of
``vst_tpu/train/steps.py`` (``_cast_tree``, ``_maybe_remat``,
``_adaattn_fwds``, ``_adaattn_gs_lf``, ``make_adaattn_image_step``,
``make_adaattn_video_step``; parity: AdaAttN/train_image.py:25-125,
train_video.py:26-138).

Each ``make_*_step`` closes over the frozen VGG19 (converted once to
``cfg.dtype``) and the config, and returns ``step(state, batch) ->
(state, metrics)``: the metrics are the JAX step's keys as device tensors
(no synchronization inside the step), and the state is updated in place.
Batches are 0–255 NHWC RGB tensors (or arrays), moved to the model's
device.

Mixed precision as in JAX: with ``cfg.dtype`` bfloat16 the float32 master
parameters are cast inside the loss (gradients flow through the cast back
to the masters) and so is the batch.  On the card the softmax attention
trains through K3 forward and K4/K5 backward (``models/adaattn.py``).
"""

import torch

from vst_tpu_torch import losses
from vst_tpu_torch.models import adaattn as adaattn_m
from vst_tpu_torch.models import vgg as vgg_m
from vst_tpu_torch.models.remat import segment
from vst_tpu_torch.ops.features import feature_down_sample
from vst_tpu_torch.train.state import TrainState, apply_gradients

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cast_tree(x, dtype: torch.dtype):
    """Mixed precision: a floating tensor (or array) at ``dtype``."""
    x = torch.as_tensor(x)
    return x.to(dtype) if x.is_floating_point() else x


class _CastModel:
    """The master model's parameters cast to ``dtype`` inside the loss.

    Float32 is the master itself.  Otherwise a parameter-free copy of the
    model's structure holds the cast tensors as plain attributes, set anew
    every step: the model's functions read them as they read parameters,
    autograd carries their gradients back through the cast to the masters,
    and a checkpointed segment that recomputes during the backward finds
    the same tensors."""

    def __init__(self, model: torch.nn.Module, dtype: torch.dtype):
        self.dtype = dtype
        self.shadow = None
        if dtype != torch.float32:
            with torch.device("meta"):
                self.shadow = type(model)()
            for mod in self.shadow.modules():
                for name in list(mod._parameters):
                    del mod._parameters[name]

    def __call__(self, model: torch.nn.Module) -> torch.nn.Module:
        if self.shadow is None:
            return model
        for name, p in model.named_parameters():
            mod, _, attr = name.rpartition(".")
            setattr(self.shadow.get_submodule(mod), attr, p.to(self.dtype))
        return self.shadow


def _frozen_vgg(vgg: vgg_m.VGG19AdaAttN, dtype: torch.dtype):
    """The VGG19 encoder converted once to ``dtype``, without gradients."""
    state = {k: v.detach() for k, v in vgg.state_dict().items()}
    frozen = vgg_m.build_vgg19_adaattn(state, next(vgg.parameters()).device,
                                       dtype)
    return frozen.requires_grad_(False)


def _adaattn_fwds(cfg):
    """The step's memory-heavy forwards, optionally rematerialized
    (``cfg.remat``), segmented as in JAX: the VGG19 encoder per inter-tap
    slice, the stylizer per attention module and decoder, and the conv-free
    attention target."""
    remat, mode = cfg.remat, cfg.attention_mode

    def vgg_feats(vgg, x):
        return vgg_m.vgg19_adaattn_features(vgg, x, remat=remat)

    def stylize(net, fc, fs):
        return adaattn_m.stylizing_network(net, fc, fs, cfg.activation,
                                           mode=mode, remat=remat)

    no_conv_target = segment(
        lambda c_x, s_x, c_1x, s_1x: adaattn_m.adaattn_no_conv(
            c_x, s_x, c_1x, s_1x, cfg.activation, mode=mode), remat)
    return vgg_feats, stylize, no_conv_target


def _adaattn_gs_lf(cfg, vgg, fc, fs, cs, vgg_feats, no_conv_target,
                   fcs=None):
    """Global-stylized + local-feature losses (train_image.py:84-106).
    ``fcs``: the VGG taps of ``cs`` if already computed (the video step
    encodes both stylized frames in one pass)."""
    if fcs is None:
        fcs = vgg_feats(vgg, cs)
    loss_gs = 0.0
    for tap in ("relu2_1", "relu3_1", "relu4_1", "relu5_1"):
        loss_gs = loss_gs + losses.global_stylized_loss(fcs[tap], fs[tap])
    loss_gs = loss_gs * cfg.lambda_g

    fcl = list(fc.values())
    fsl = list(fs.values())
    loss_lf = 0.0
    for i in range(3):
        idx = i + 2
        target = no_conv_target(fcl[idx], fsl[idx],
                                feature_down_sample(fcl, idx),
                                feature_down_sample(fsl, idx))
        loss_lf = loss_lf + losses.local_feature_loss(fcs[f"relu{i + 3}_1"],
                                                      target)
    loss_lf = loss_lf * cfg.lambda_l
    return fcs, loss_gs, loss_lf


def _split(f, *bounds):
    return [{k: v[a:b] for k, v in f.items()} for a, b in bounds]


def _make_step(cfg, vgg, loss_fn):
    dtype = DTYPES[cfg.dtype]
    frozen = _frozen_vgg(vgg, dtype)
    cast = None

    def step(state: TrainState, batch):
        nonlocal cast
        if cast is None:
            cast = _CastModel(state.model, dtype)
        dev = next(state.model.parameters()).device
        batch = [_cast_tree(x, dtype).to(dev) for x in batch]
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(cast(state.model), frozen, *batch)
        total.backward()
        return apply_gradients(state), {k: v.detach()
                                        for k, v in metrics.items()}

    return step


def make_adaattn_image_step(cfg, vgg: vgg_m.VGG19AdaAttN):
    """AdaAttN image-mode trainer (AdaAttN/train_image.py:25-125); batch
    (content, style)."""
    vgg_feats, stylize, no_conv_target = _adaattn_fwds(cfg)

    def loss_fn(net, vgg, content, style):
        # one batched VGG pass over [content, style] (same crop size)
        n = content.shape[0]
        fc, fs = _split(vgg_feats(vgg, torch.cat([content, style])),
                        (0, n), (n, None))
        cs = stylize(net, fc, fs)
        _, loss_gs, loss_lf = _adaattn_gs_lf(cfg, vgg, fc, fs, cs, vgg_feats,
                                             no_conv_target)
        total = loss_gs + loss_lf
        return total, {"loss_gs": loss_gs, "loss_lf": loss_lf, "loss": total}

    return _make_step(cfg, vgg, loss_fn)


def make_adaattn_video_step(cfg, vgg: vgg_m.VGG19AdaAttN):
    """AdaAttN video-mode trainer (AdaAttN/train_video.py:26-138); batch
    (content1, content2, style).  Global and local losses on frame 1 only;
    the image-similarity loss across the frame pair on relu2_1/3_1/4_1
    (:110-115)."""
    vgg_feats, stylize, no_conv_target = _adaattn_fwds(cfg)

    def loss_fn(net, vgg, content1, content2, style):
        # one batched VGG pass over [content1, content2, style]
        n = content1.shape[0]
        fc1, fc2, fs = _split(
            vgg_feats(vgg, torch.cat([content1, content2, style])),
            (0, n), (n, 2 * n), (2 * n, None))
        # one stylizer pass over the frame pair (the style taps tiled;
        # attention, instance norm and decoder are per sample) and one VGG
        # pass over both stylized frames
        cs = stylize(net, {k: torch.cat([fc1[k], fc2[k]]) for k in fc1},
                     {k: torch.cat([v, v]) for k, v in fs.items()})
        fcs1, fcs2 = _split(vgg_feats(vgg, cs), (0, n), (n, None))
        _, loss_gs, loss_lf = _adaattn_gs_lf(cfg, vgg, fc1, fs, cs[:n],
                                             vgg_feats, no_conv_target,
                                             fcs=fcs1)
        loss_is = 0.0
        for tap in ("relu2_1", "relu3_1", "relu4_1"):
            loss_is = loss_is + losses.image_similarity_loss(
                fc1[tap], fc2[tap], fcs1[tap], fcs2[tap])
        loss_is = loss_is * cfg.lambda_is
        total = loss_gs + loss_lf + loss_is
        return total, {"loss_gs": loss_gs, "loss_lf": loss_lf,
                       "loss_is": loss_is, "loss": total}

    return _make_step(cfg, vgg, loss_fn)
