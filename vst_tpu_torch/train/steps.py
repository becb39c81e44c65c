"""ReCoNet, RTNSTV and AdaAttN train steps.  Counterpart of
``vst_tpu/train/steps.py`` (``_cast_tree``, ``_maybe_remat``,
``reconet_style_grams``, ``rtnstv_style_grams``, ``_reconet_losses``,
``make_reconet_flow_step``, ``make_reconet_coco_step``,
``make_reconet_distill_step``, ``make_rtnstv_step``, ``_adaattn_fwds``,
``_adaattn_gs_lf``, ``make_adaattn_image_step``,
``make_adaattn_video_step``; parity: ReCoNet/train_single/
train_candy.py:32-170, train_coco2014.py:28-105, train_Flow_SD1.py:33-185,
RTNSTV/train.py:63-158, AdaAttN/train_image.py:25-125,
train_video.py:26-138).

Each ``make_*_step`` closes over the frozen VGG (converted once to
``cfg.dtype``), the config and what else is frozen (style grams, the
teacher), and returns ``step(state, batch) -> (state, metrics)``: the
metrics are the JAX step's keys as device tensors (no synchronization
inside the step), and the state is updated in place.  Batches are 0–255
NHWC RGB tensors (or arrays), moved to the model's device; a ReCoNet or
RTNSTV flow batch also holds the flow (N, H, W, 2) and the occlusion mask
(N, H, W).

Mixed precision as in JAX: with ``cfg.dtype`` bfloat16 the float32 master
parameters are cast inside the loss (gradients flow through the cast back
to the masters) and so are the images (flow and mask stay float32).  On
the card every ReCoNet forward, the teacher's too, runs its residual
blocks through K1 and its 9×9 layers through K2, and every RTNSTV forward
its residual blocks through K1; their backward is the library's conv
gradients (``kernels/res_block.py``,
``kernels/head_conv.py``); the softmax attention trains through K3 forward
and K4/K5 backward (``models/adaattn.py``).
"""

import copy

import torch

from vst_tpu_torch import losses
from vst_tpu_torch.models import adaattn as adaattn_m
from vst_tpu_torch.models import reconet as reconet_m
from vst_tpu_torch.models import vgg as vgg_m
from vst_tpu_torch.models.remat import segment
from vst_tpu_torch.ops.features import feature_down_sample
from vst_tpu_torch.ops.image import gram_matrix, gram_matrix_hw, vgg_normalize
from vst_tpu_torch.train.state import TrainState, apply_gradients

# family name → model class (in JAX: → forward function)
RECONET_FORWARD = reconet_m.FAMILIES

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
            # a copy, so that the structure follows the model's own
            # constructor arguments (a 4-frame ReCoNet's stem, an SD
            # student's widths)
            self.shadow = copy.deepcopy(model).to("meta")
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


def _frozen(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """A copy of ``model`` (the VGG, a distillation teacher) converted once
    to ``dtype``, without gradients."""
    return copy.deepcopy(model).to(dtype).requires_grad_(False).eval()


# ------------------------------------------------------------ ReCoNet

@torch.no_grad()
def reconet_style_grams(vgg: vgg_m.VGG16ReCoNet, style_255) -> list:
    """Per-tap (1, C, C) Gram matrices of the style image (1, H, W, 3),
    / (C·H·W) (ReCoNet/train_single/train_candy.py:55-56), in float32 on
    the VGG's device."""
    p = next(vgg.parameters())
    style = torch.as_tensor(style_255).to(device=p.device, dtype=p.dtype)
    feats = vgg_m.vgg16_features(vgg, vgg_normalize(style))
    return [gram_matrix(f).float() for f in feats.values()]


def _reconet_losses(cfg, vgg, style_grams, outs1, outs2, img1, img2, flow,
                    mask):
    """The candy-style loss block (train_candy.py:77-148).  outs1/outs2:
    the stylizer's (feature map, styled) per frame; img1/img2: the 0–255
    inputs (the whole multi-frame channel stack)."""
    fmap1, styled1 = outs1
    fmap2, styled2 = outs2
    idx = (cfg.input_frame_num - 1) * 3   # the last frame's RGB (:59-61)
    s1n, s2n = vgg_normalize(styled1), vgg_normalize(styled2)
    i1n = vgg_normalize(img1[..., idx:idx + 3])
    i2n = vgg_normalize(img2[..., idx:idx + 3])
    # one batched VGG pass over [s1, s2, i1, i2] (VGG has no cross-batch op)
    n = s1n.shape[0]
    feats = vgg_m.vgg16_features(vgg, torch.cat([s1n, s2n, i1n, i2n]),
                                 remat=cfg.remat).values()
    sf1, sf2, cf1, cf2 = ([f[i * n:(i + 1) * n] for f in feats]
                          for i in range(4))
    metrics = {}
    total = 0.0
    if getattr(cfg, "use_ftl", True):
        ftl = losses.reconet_feature_temporal_loss(fmap1, fmap2, flow,
                                                   mask) * cfg.lambda_f
        total = total + ftl
        metrics["FTL"] = ftl
    otl = losses.reconet_output_temporal_loss(i1n, i2n, s1n, s2n, flow,
                                              mask) * cfg.lambda_o
    content = (losses.reconet_content_loss(sf1, cf1)
               + losses.reconet_content_loss(sf2, cf2)) * cfg.alpha
    style = (losses.reconet_style_loss(sf1, style_grams)
             + losses.reconet_style_loss(sf2, style_grams)) * cfg.beta
    # TV on the vgg-NORMALIZED styled images, as the reference computes it
    # (styled_img is reassigned at train_candy.py:82 before :140-145)
    reg = (losses.reconet_reg_loss(s1n)
           + losses.reconet_reg_loss(s2n)) * cfg.gamma
    total = total + otl + content + style + reg
    metrics.update(OTL=otl, CL=content, SL=style, RL=reg, loss=total)
    return total, metrics


def _grams_on(style_grams, vgg):
    dev = next(vgg.parameters()).device
    return [torch.as_tensor(g).to(dev) for g in style_grams]


def _stylizer(cfg):
    """The stylizer's forward, checkpointed whole under ``cfg.remat`` (the
    JAX step's ``jax.checkpoint`` of the forward)."""
    return segment(lambda net, x: net(x), cfg.remat)


def make_reconet_flow_step(cfg, vgg: vgg_m.VGG16ReCoNet, style_grams):
    """ReCoNet single- and multi-frame flow trainer (train_candy.py:32-170);
    batch (img1, img2, flow, mask)."""
    grams = _grams_on(style_grams, vgg)
    fwd = _stylizer(cfg)

    def loss_fn(net, vgg, img1, img2, flow, mask):
        # one stylizer pass over both frames (instance norm is per sample)
        n = img1.shape[0]
        _, fmap, styled = fwd(net, torch.cat([img1, img2]))
        return _reconet_losses(cfg, vgg, grams, (fmap[:n], styled[:n]),
                               (fmap[n:], styled[n:]), img1, img2, flow,
                               mask)

    return _make_step(cfg, vgg, loss_fn, n_images=2)


def make_reconet_coco_step(cfg, vgg: vgg_m.VGG16ReCoNet, style_grams):
    """Image-only content + style trainer (train_coco2014.py:28-105);
    batch: the images."""
    grams = _grams_on(style_grams, vgg)
    fwd = _stylizer(cfg)

    def loss_fn(net, vgg, img):
        styled = fwd(net, img)[-1]
        sn, inorm = vgg_normalize(styled), vgg_normalize(img)
        # one batched VGG pass over [styled, content]
        n = sn.shape[0]
        feats = vgg_m.vgg16_features(vgg, torch.cat([sn, inorm]),
                                     remat=cfg.remat).values()
        sf = [f[:n] for f in feats]
        cf = [f[n:] for f in feats]
        content = losses.reconet_content_loss(sf, cf) * cfg.alpha
        style = losses.reconet_style_loss(sf, grams) * cfg.beta
        total = content + style
        return total, {"CL": content, "SL": style, "loss": total}

    return _make_step(cfg, vgg, loss_fn)


def make_reconet_distill_step(cfg, vgg: vgg_m.VGG16ReCoNet, style_grams,
                              teacher: torch.nn.Module):
    """SD1/SD2 distillation trainer (train_Flow_SD1.py:33-185); batch
    (img1, img2, flow, mask).

    The teacher (converted once to ``cfg.dtype``) runs without gradients.
    The symmetric distillation loss, scaled by sd_weight_scale·beta, is
    logged as ``SDL`` and left out of the total unless
    ``cfg.include_sd_in_total``; where the taps' shapes differ (the SD1
    stage) it is NaN."""
    grams = _grams_on(style_grams, vgg)
    frozen_teacher = _frozen(teacher, DTYPES[cfg.dtype])
    fwd = _stylizer(cfg)

    def loss_fn(net, vgg, img1, img2, flow, mask):
        # frame-pair forwards in one batch (instance norm is per sample)
        n = img1.shape[0]
        pair = torch.cat([img1, img2])
        with torch.no_grad():
            t = frozen_teacher(pair)[cfg.teacher_tap]
        s = fwd(net, pair)
        total, metrics = _reconet_losses(
            cfg, vgg, grams, (s[-2][:n], s[-1][:n]), (s[-2][n:], s[-1][n:]),
            img1, img2, flow, mask)
        feat_s = s[cfg.student_tap]
        if t.shape == feat_s.shape:
            sd = (losses.mse(t[:n], feat_s[:n]) + losses.mse(t[n:], feat_s[n:]))
            sd = sd * (cfg.sd_weight_scale * cfg.beta)
            if cfg.include_sd_in_total:
                total = total + sd
                metrics["loss"] = total
        else:
            sd = torch.full((), float("nan"), device=pair.device)
        metrics["SDL"] = sd
        return total, metrics

    return _make_step(cfg, vgg, loss_fn, n_images=2)


# ------------------------------------------------------------ RTNSTV

@torch.no_grad()
def rtnstv_style_grams(vgg: vgg_m.VGG19RTNSTV, style_255) -> list:
    """Per-tap (1, C, C) Gram matrices of the style image (1, H, W, 3),
    / (H·W) (RTNSTV/train.py:91-93), in float32 on the VGG's device."""
    p = next(vgg.parameters())
    style = torch.as_tensor(style_255).to(device=p.device, dtype=p.dtype)
    feats = vgg_m.vgg19_rtnstv_features(vgg, style)
    return [gram_matrix_hw(f).float() for f in feats.values()]


def make_rtnstv_step(cfg, vgg: vgg_m.VGG19RTNSTV, style_grams):
    """RTNSTV trainer (RTNSTV/train.py:63-158); batch (img1, img2, flow,
    mask).  One stylizer pass over both frames and one VGG19 pass over
    [img1, img2, styled1, styled2] (instance norm is per sample, VGG has
    no cross-batch op); each frame's spatial loss, the temporal loss on
    the 0–255 styled pair."""
    grams = _grams_on(style_grams, vgg)
    fwd = _stylizer(cfg)

    def loss_fn(net, vgg, img1, img2, flow, mask):
        n = img1.shape[0]
        styled = fwd(net, torch.cat([img1, img2]))
        styled1, styled2 = styled[:n], styled[n:]
        feats = vgg_m.vgg19_rtnstv_features(
            vgg, torch.cat([img1, img2, styled1, styled2]), remat=cfg.remat)
        cf1, cf2, sf1, sf2 = _split(feats, *((i * n, (i + 1) * n)
                                             for i in range(4)))
        cl1, sl1, rl1 = losses.rtnstv_spatial_loss(
            cf1, sf1, grams, styled1, cfg.alpha, cfg.beta, cfg.gamma)
        cl2, sl2, rl2 = losses.rtnstv_spatial_loss(
            cf2, sf2, grams, styled2, cfg.alpha, cfg.beta, cfg.gamma)
        tl = losses.rtnstv_temporal_loss(styled1, styled2, flow,
                                         mask) * cfg.lam
        content, style, reg = cl1 + cl2, sl1 + sl2, rl1 + rl2
        total = content + style + reg + tl
        return total, {"CL": content, "SL": style, "RL": reg, "TL": tl,
                       "loss": total}

    return _make_step(cfg, vgg, loss_fn, n_images=2)


# ------------------------------------------------------------ AdaAttN

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


def _make_step(cfg, vgg, loss_fn, n_images=None):
    """``step(state, batch)`` around ``loss_fn(net, vgg, *batch)``; the
    first ``n_images`` batch entries (all by default) are cast to
    ``cfg.dtype``, the others only moved to the device.  A batch that is
    one array is a batch of one entry."""
    dtype = DTYPES[cfg.dtype]
    frozen = _frozen(vgg, dtype)
    cast = None

    def step(state: TrainState, batch):
        nonlocal cast
        if cast is None:
            cast = _CastModel(state.model, dtype)
        dev = next(state.model.parameters()).device
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        k = len(batch) if n_images is None else n_images
        batch = ([_cast_tree(x, dtype).to(dev) for x in batch[:k]]
                 + [torch.as_tensor(x).to(dev) for x in batch[k:]])
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
