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

Data × space training: every builder given a mesh with a "space" axis
(a ("data", "space") mesh, or "space" alone; the batch placed by
``parallel.shard_batch_spatial``) runs the stylizer, the VGG and the
losses on this rank's row blocks (``spatial=``, ``parallel/spatial.py``):
each rank's loss is its share of its data shard's loss, the gradients and
metrics are summed over "space" and averaged over "data", and the step is
the single-device step on the global batch.  A share: a sum over pixels
enters as the block's sum over the frame's count; a term of all-reduced
or whole quantities (Grams, the frame's mean and std, the cosine-distance
matrices, the style's features) divided by the space axis's size.  The
AdaAttN steps gather the style's rows back (``gather_rows``) and encode
it whole on every rank, as JAX replicates it; each attention level runs
the block's queries against the whole style (K3, K4, K5).  H must divide
by the space axis's size D, JAX's own rule.  At entry the step moves the
placed frames (and flow and mask) into its row layout
(``parallel/spatial.py::row_layout``), blocks of whole units of m rows
with any remainder on the last, m = 8 for ReCoNet and RTNSTV (the
stylizer's two stride-2 layers and the VGG's three pools before relu4_3
or relu4_2), 16 for AdaAttN (VGG19's four pools before relu5_1): one
``relayout_rows``, which moves nothing where m·D divides H.  A block
needs at least max(m, 8) rows; below that a builder raises
``ValueError`` naming the least H for D (m·D, and 8·D where m = 4).
"""

import copy
import math

import torch

from vst_tpu_torch import losses
from vst_tpu_torch.models import adaattn as adaattn_m
from vst_tpu_torch.models import reconet as reconet_m
from vst_tpu_torch.models import vgg as vgg_m
from vst_tpu_torch.models.remat import segment
from vst_tpu_torch.ops.features import feature_down_sample, pyramid_rows
from vst_tpu_torch.ops.image import gram_matrix, gram_matrix_hw, vgg_normalize
from vst_tpu_torch.parallel.mesh import all_reduce_mean, all_reduce_sum
from vst_tpu_torch.parallel.spatial import (SpatialContext, gather_rows,
                                            layout_for, placement,
                                            relayout_rows)
from vst_tpu_torch.train.state import TrainState, apply_gradients
from vst_tpu_torch.utils.profiling import span

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


def _space(mesh):
    """The ``SpatialContext`` of ``mesh``'s "space" axis, or None (no mesh,
    or a mesh without one)."""
    if mesh is None or "space" not in mesh.shape:
        return None
    return SpatialContext(mesh)


def _unit(vgg, stylizer=4):
    """A step's row unit: 2 to the stylizer's stride-2 layers (ReCoNet's
    and RTNSTV's two; AdaAttN's content meets none: ``stylizer=1``) and
    to the VGG's pools before its last tap, whichever needs more."""
    return math.lcm(stylizer, vgg.row_multiple())


def _place(spatial, batch, unit, what, n):
    """The frame's row layout over ``spatial`` (``row_layout`` of H, the
    placed block's rows times the axis size, in units of ``unit`` rows;
    ``ValueError`` below its least H), set on it for the step, and the
    first ``n`` batch entries moved into it from JAX's placement, all in
    one ``relayout_rows`` (nothing moves where unit·D divides H)."""
    h = batch[0].shape[1] * spatial.size
    spatial.bounds = layout_for(spatial, h, unit, what)
    moved = relayout_rows(spatial, list(batch[:n]),
                          placement(h, spatial.size), spatial.bounds)
    return [*moved, *batch[n:]]


def _reconet_losses(cfg, vgg, style_grams, outs1, outs2, img1, img2, flow,
                    mask, mesh=None, spatial=None):
    """The candy-style loss block (train_candy.py:77-148).  outs1/outs2:
    the stylizer's (feature map, styled) per frame; img1/img2: the 0–255
    inputs (the whole multi-frame channel stack).  ``spatial``: every
    input is this rank's row block and the losses its shares."""
    fmap1, styled1 = outs1
    fmap2, styled2 = outs2
    idx = (cfg.input_frame_num - 1) * 3   # the last frame's RGB (:59-61)
    s1n, s2n = vgg_normalize(styled1), vgg_normalize(styled2)
    i1n = vgg_normalize(img1[..., idx:idx + 3])
    i2n = vgg_normalize(img2[..., idx:idx + 3])
    # one batched VGG pass over [s1, s2, i1, i2] (VGG has no cross-batch op)
    n = s1n.shape[0]
    feats = vgg_m.vgg16_features(vgg, torch.cat([s1n, s2n, i1n, i2n]),
                                 remat=cfg.remat, spatial=spatial).values()
    sf1, sf2, cf1, cf2 = ([f[i * n:(i + 1) * n] for f in feats]
                          for i in range(4))
    metrics = {}
    total = 0.0
    if getattr(cfg, "use_ftl", True):
        ftl = losses.reconet_feature_temporal_loss(
            fmap1, fmap2, flow, mask, mesh, spatial) * cfg.lambda_f
        total = total + ftl
        metrics["FTL"] = ftl
    otl = losses.reconet_output_temporal_loss(
        i1n, i2n, s1n, s2n, flow, mask, mesh, spatial) * cfg.lambda_o
    content = (losses.reconet_content_loss(sf1, cf1, spatial=spatial)
               + losses.reconet_content_loss(sf2, cf2, spatial=spatial)
               ) * cfg.alpha
    style = (losses.reconet_style_loss(sf1, style_grams, spatial)
             + losses.reconet_style_loss(sf2, style_grams, spatial)
             ) * cfg.beta
    # TV on the vgg-NORMALIZED styled images, as the reference computes it
    # (styled_img is reassigned at train_candy.py:82 before :140-145)
    reg = (losses.reconet_reg_loss(s1n, mesh, spatial)
           + losses.reconet_reg_loss(s2n, mesh, spatial)) * cfg.gamma
    total = total + otl + content + style + reg
    metrics.update(OTL=otl, CL=content, SL=style, RL=reg, loss=total)
    return total, metrics


def _grams_on(style_grams, vgg):
    dev = next(vgg.parameters()).device
    return [torch.as_tensor(g).to(dev) for g in style_grams]


def _stylizer(cfg, spatial=None):
    """The stylizer's forward, checkpointed whole under ``cfg.remat`` (the
    JAX step's ``jax.checkpoint`` of the forward); with ``spatial``, over
    this rank's row block."""
    return segment(lambda net, x: net(x, spatial=spatial), cfg.remat)


def make_reconet_flow_step(cfg, vgg: vgg_m.VGG16ReCoNet, style_grams,
                           mesh=None):
    """ReCoNet single- and multi-frame flow trainer (train_candy.py:32-170);
    batch (img1, img2, flow, mask).  A ``mesh`` with a "space" axis trains
    data × space (module docstring): the batch is this rank's
    ``shard_batch_spatial`` block, moved into 8-row units at entry."""
    grams = _grams_on(style_grams, vgg)
    spatial = _space(mesh)
    fwd = _stylizer(cfg, spatial)

    def loss_fn(net, vgg, img1, img2, flow, mask):
        # one stylizer pass over both frames (instance norm is per sample)
        n = img1.shape[0]
        _, fmap, styled = fwd(net, torch.cat([img1, img2]))
        return _reconet_losses(cfg, vgg, grams, (fmap[:n], styled[:n]),
                               (fmap[n:], styled[n:]), img1, img2, flow,
                               mask, mesh, spatial)

    return _make_step(cfg, vgg, loss_fn, n_images=2, mesh=mesh,
                      spatial=spatial,
                      place=(_unit(vgg), "make_reconet_flow_step", 4))


def make_reconet_coco_step(cfg, vgg: vgg_m.VGG16ReCoNet, style_grams,
                           mesh=None):
    """Image-only content + style trainer (train_coco2014.py:28-105);
    batch: the images.  A ``mesh`` with a "space" axis trains data × space
    (module docstring; 8-row units)."""
    grams = _grams_on(style_grams, vgg)
    spatial = _space(mesh)
    fwd = _stylizer(cfg, spatial)

    def loss_fn(net, vgg, img):
        styled = fwd(net, img)[-1]
        sn, inorm = vgg_normalize(styled), vgg_normalize(img)
        # one batched VGG pass over [styled, content]
        n = sn.shape[0]
        feats = vgg_m.vgg16_features(vgg, torch.cat([sn, inorm]),
                                     remat=cfg.remat,
                                     spatial=spatial).values()
        sf = [f[:n] for f in feats]
        cf = [f[n:] for f in feats]
        content = losses.reconet_content_loss(sf, cf,
                                              spatial=spatial) * cfg.alpha
        style = losses.reconet_style_loss(sf, grams, spatial) * cfg.beta
        total = content + style
        return total, {"CL": content, "SL": style, "loss": total}

    return _make_step(cfg, vgg, loss_fn, mesh=mesh,
                      spatial=spatial,
                      place=(_unit(vgg), "make_reconet_coco_step", 1))


def make_reconet_distill_step(cfg, vgg: vgg_m.VGG16ReCoNet, style_grams,
                              teacher: torch.nn.Module, mesh=None):
    """SD1/SD2 distillation trainer (train_Flow_SD1.py:33-185); batch
    (img1, img2, flow, mask).

    The teacher (converted once to ``cfg.dtype``) runs without gradients.
    The symmetric distillation loss, scaled by sd_weight_scale·beta, is
    logged as ``SDL`` and left out of the total unless
    ``cfg.include_sd_in_total``; where the taps' shapes differ (the SD1
    stage) it is NaN.  A ``mesh`` with a "space" axis trains data × space
    (module docstring; 8-row units), the teacher on the same row blocks;
    the SD loss is then each rank's share."""
    grams = _grams_on(style_grams, vgg)
    frozen_teacher = _frozen(teacher, DTYPES[cfg.dtype])
    spatial = _space(mesh)
    fwd = _stylizer(cfg, spatial)

    def loss_fn(net, vgg, img1, img2, flow, mask):
        # frame-pair forwards in one batch (instance norm is per sample)
        n = img1.shape[0]
        pair = torch.cat([img1, img2])
        with torch.no_grad():
            t = frozen_teacher(pair, spatial=spatial)[cfg.teacher_tap]
        s = fwd(net, pair)
        total, metrics = _reconet_losses(
            cfg, vgg, grams, (s[-2][:n], s[-1][:n]), (s[-2][n:], s[-1][n:]),
            img1, img2, flow, mask, mesh, spatial)
        feat_s = s[cfg.student_tap]
        if t.shape == feat_s.shape:
            sd = (losses.mse(t[:n], feat_s[:n], spatial)
                  + losses.mse(t[n:], feat_s[n:], spatial))
            sd = sd * (cfg.sd_weight_scale * cfg.beta)
            if cfg.include_sd_in_total:
                total = total + sd
                metrics["loss"] = total
        else:
            sd = torch.full((), float("nan"), device=pair.device)
        metrics["SDL"] = sd
        return total, metrics

    return _make_step(cfg, vgg, loss_fn, n_images=2, mesh=mesh,
                      spatial=spatial,
                      place=(_unit(vgg), "make_reconet_distill_step", 4))


# ------------------------------------------------------------ RTNSTV

@torch.no_grad()
def rtnstv_style_grams(vgg: vgg_m.VGG19RTNSTV, style_255) -> list:
    """Per-tap (1, C, C) Gram matrices of the style image (1, H, W, 3),
    / (H·W) (RTNSTV/train.py:91-93), in float32 on the VGG's device."""
    p = next(vgg.parameters())
    style = torch.as_tensor(style_255).to(device=p.device, dtype=p.dtype)
    feats = vgg_m.vgg19_rtnstv_features(vgg, style)
    return [gram_matrix_hw(f).float() for f in feats.values()]


def make_rtnstv_step(cfg, vgg: vgg_m.VGG19RTNSTV, style_grams, mesh=None):
    """RTNSTV trainer (RTNSTV/train.py:63-158); batch (img1, img2, flow,
    mask).  One stylizer pass over both frames and one VGG19 pass over
    [img1, img2, styled1, styled2] (instance norm is per sample, VGG has
    no cross-batch op); each frame's spatial loss, the temporal loss on
    the 0–255 styled pair.  A ``mesh`` with a "space" axis trains data ×
    space (module docstring; 8-row units, which cover RTNSTV's own 4)."""
    grams = _grams_on(style_grams, vgg)
    spatial = _space(mesh)
    fwd = _stylizer(cfg, spatial)

    def loss_fn(net, vgg, img1, img2, flow, mask):
        n = img1.shape[0]
        styled = fwd(net, torch.cat([img1, img2]))
        styled1, styled2 = styled[:n], styled[n:]
        feats = vgg_m.vgg19_rtnstv_features(
            vgg, torch.cat([img1, img2, styled1, styled2]), remat=cfg.remat,
            spatial=spatial)
        cf1, cf2, sf1, sf2 = _split(feats, *((i * n, (i + 1) * n)
                                             for i in range(4)))
        cl1, sl1, rl1 = losses.rtnstv_spatial_loss(
            cf1, sf1, grams, styled1, cfg.alpha, cfg.beta, cfg.gamma,
            spatial)
        cl2, sl2, rl2 = losses.rtnstv_spatial_loss(
            cf2, sf2, grams, styled2, cfg.alpha, cfg.beta, cfg.gamma,
            spatial)
        tl = losses.rtnstv_temporal_loss(styled1, styled2, flow, mask,
                                         mesh, spatial) * cfg.lam
        content, style, reg = cl1 + cl2, sl1 + sl2, rl1 + rl2
        total = content + style + reg + tl
        return total, {"CL": content, "SL": style, "RL": reg, "TL": tl,
                       "loss": total}

    return _make_step(cfg, vgg, loss_fn, n_images=2, mesh=mesh,
                      spatial=spatial,
                      place=(_unit(vgg), "make_rtnstv_step", 4))


# ------------------------------------------------------------ AdaAttN

def _adaattn_fwds(cfg, spatial=None):
    """The step's memory-heavy forwards, optionally rematerialized
    (``cfg.remat``), segmented as in JAX: the VGG19 encoder per inter-tap
    slice, the stylizer per attention module and decoder, and the conv-free
    attention target.  ``spatial``: the content side is this rank's row
    blocks (``vgg_feats(vgg, x, spatial)`` encodes a block), the style
    whole."""
    remat, mode = cfg.remat, cfg.attention_mode

    def vgg_feats(vgg, x, spatial=None):
        return vgg_m.vgg19_adaattn_features(vgg, x, remat=remat,
                                            spatial=spatial)

    def stylize(net, fc, fs):
        return adaattn_m.stylizing_network(net, fc, fs, cfg.activation,
                                           mode=mode, remat=remat,
                                           spatial=spatial)

    no_conv_target = segment(
        lambda c_x, s_x, c_1x, s_1x: adaattn_m.adaattn_no_conv(
            c_x, s_x, c_1x, s_1x, cfg.activation, mode=mode,
            spatial=spatial), remat)
    return vgg_feats, stylize, no_conv_target


def _adaattn_gs_lf(cfg, vgg, fc, fs, cs, vgg_feats, no_conv_target,
                   fcs=None, spatial=None):
    """Global-stylized + local-feature losses (train_image.py:84-106).
    ``fcs``: the VGG taps of ``cs`` if already computed (the video step
    encodes both stylized frames in one pass); ``spatial``: fc, cs and
    fcs are row blocks, fs whole, and the losses this rank's shares."""
    if fcs is None:
        fcs = vgg_feats(vgg, cs, spatial)
    loss_gs = 0.0
    for tap in ("relu2_1", "relu3_1", "relu4_1", "relu5_1"):
        loss_gs = loss_gs + losses.global_stylized_loss(fcs[tap], fs[tap],
                                                        spatial)
    loss_gs = loss_gs * cfg.lambda_g

    fcl = list(fc.values())
    fsl = list(fs.values())
    rows = pyramid_rows(fcl, spatial)
    loss_lf = 0.0
    for i in range(3):
        idx = i + 2
        target = no_conv_target(fcl[idx], fsl[idx],
                                feature_down_sample(fcl, idx, spatial, rows),
                                feature_down_sample(fsl, idx))
        loss_lf = loss_lf + losses.local_feature_loss(fcs[f"relu{i + 3}_1"],
                                                      target, spatial)
    loss_lf = loss_lf * cfg.lambda_l
    return fcs, loss_gs, loss_lf


def _gather_style(spatial, style):
    """The whole style from its blocks in JAX's placement, H/D rows each
    (``gather_rows`` with those sizes: no collective to learn them)."""
    return gather_rows(spatial, style, [style.shape[1]] * spatial.size)


def _split(f, *bounds):
    return [{k: v[a:b] for k, v in f.items()} for a, b in bounds]


def _reduce(mesh, tensors):
    """Sum ``tensors`` over the mesh's "space" axis, if it has one, then
    average them over "data" (a mesh of only "space" has no data axis to
    average over).  In place; returns the list."""
    if "space" in mesh.shape:
        all_reduce_sum(mesh, tensors, "space")
    if "data" in mesh.shape:
        all_reduce_mean(mesh, tensors)
    return tensors


def _make_step(cfg, vgg, loss_fn, n_images=None, mesh=None, spatial=None,
               place=None):
    """``step(state, batch)`` around ``loss_fn(net, vgg, *batch)``; the
    first ``n_images`` batch entries (all by default) are cast to
    ``cfg.dtype``, the others only moved to the device.  A batch that is
    one array is a batch of one entry.  ``spatial``, the loss's context
    over the mesh's "space" axis, and ``place`` = (unit, name, n): the
    first n entries move into the step's row layout first (``_place``).

    With a ``mesh`` (data parallelism, ``parallel/mesh.py``) the batch is
    this rank's shard of the global batch.  After the backward the float32
    master gradients are averaged over the "data" axis with one flattened
    all-reduce, the JAX step's gradient psum, and so are the metrics: every
    rank logs the global batch's losses and takes the same update, and the
    loop's non-finite rollback decides the same on every rank.  The
    losses that are not batch means are rescaled on each rank for this
    (``batch_shards``, ``batch_total``).  Over a "space" axis each rank's
    loss is a share of its data shard's: the gradients and metrics are
    first summed over "space" (one flattened all-reduce each).

    Spans (``utils/profiling.py::span``): "vst::step.inputs" (the batch
    cast and moved, ``_place``, the gradients reset), ".forward" (the
    loss), ".backward", ".reduce" (with a mesh) and, in
    ``apply_gradients``, ".optimizer"."""
    dtype = DTYPES[cfg.dtype]
    frozen = _frozen(vgg, dtype)
    cast = None

    def step(state: TrainState, batch):
        nonlocal cast
        if cast is None:
            cast = _CastModel(state.model, dtype)
        with span("vst::step.inputs"):
            dev = next(state.model.parameters()).device
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            k = len(batch) if n_images is None else n_images
            batch = ([_cast_tree(x, dtype).to(dev) for x in batch[:k]]
                     + [torch.as_tensor(x).to(dev) for x in batch[k:]])
            if spatial is not None:
                batch = _place(spatial, batch, *place)
            state.optimizer.zero_grad(set_to_none=True)
        with span("vst::step.forward"):
            total, metrics = loss_fn(cast(state.model), frozen, *batch)
        with span("vst::step.backward"):
            total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            with span("vst::step.reduce"):
                _reduce(mesh, [p.grad for p in state.model.parameters()
                               if p.grad is not None])
                keys = list(metrics)
                flat = _reduce(mesh, [torch.stack(
                    [metrics[k].double().reshape(()) for k in keys])])[0]
                metrics = {k: flat[j].to(metrics[k].dtype)
                           for j, k in enumerate(keys)}
        return apply_gradients(state), metrics

    return step


def make_adaattn_image_step(cfg, vgg: vgg_m.VGG19AdaAttN, mesh=None):
    """AdaAttN image-mode trainer (AdaAttN/train_image.py:25-125); batch
    (content, style).  A ``mesh`` with a "space" axis trains data × space
    (module docstring; 16-row units)."""
    spatial = _space(mesh)
    vgg_feats, stylize, no_conv_target = _adaattn_fwds(cfg, spatial)

    def loss_fn(net, vgg, content, style):
        if spatial is None:
            # one batched VGG pass over [content, style] (same crop size)
            n = content.shape[0]
            fc, fs = _split(vgg_feats(vgg, torch.cat([content, style])),
                            (0, n), (n, None))
        else:
            fc = vgg_feats(vgg, content, spatial)
            fs = vgg_feats(vgg, _gather_style(spatial, style))
        cs = stylize(net, fc, fs)
        _, loss_gs, loss_lf = _adaattn_gs_lf(cfg, vgg, fc, fs, cs, vgg_feats,
                                             no_conv_target, spatial=spatial)
        total = loss_gs + loss_lf
        return total, {"loss_gs": loss_gs, "loss_lf": loss_lf, "loss": total}

    return _make_step(cfg, vgg, loss_fn, mesh=mesh, spatial=spatial,
                      place=(_unit(vgg, 1), "make_adaattn_image_step", 1))


def make_adaattn_video_step(cfg, vgg: vgg_m.VGG19AdaAttN, mesh=None):
    """AdaAttN video-mode trainer (AdaAttN/train_video.py:26-138); batch
    (content1, content2, style).  Global and local losses on frame 1 only;
    the image-similarity loss across the frame pair on relu2_1/3_1/4_1
    (:110-115).  A ``mesh`` with a "space" axis trains data × space
    (module docstring; 16-row units)."""
    spatial = _space(mesh)
    vgg_feats, stylize, no_conv_target = _adaattn_fwds(cfg, spatial)

    def loss_fn(net, vgg, content1, content2, style):
        n = content1.shape[0]
        if spatial is None:
            # one batched VGG pass over [content1, content2, style]
            fc1, fc2, fs = _split(
                vgg_feats(vgg, torch.cat([content1, content2, style])),
                (0, n), (n, 2 * n), (2 * n, None))
        else:
            fc1, fc2 = _split(vgg_feats(vgg, torch.cat([content1, content2]),
                                        spatial), (0, n), (n, None))
            fs = vgg_feats(vgg, _gather_style(spatial, style))
        # one stylizer pass over the frame pair (the style taps tiled;
        # attention, instance norm and decoder are per sample) and one VGG
        # pass over both stylized frames
        cs = stylize(net, {k: torch.cat([fc1[k], fc2[k]]) for k in fc1},
                     {k: torch.cat([v, v]) for k, v in fs.items()})
        fcs1, fcs2 = _split(vgg_feats(vgg, cs, spatial), (0, n), (n, None))
        _, loss_gs, loss_lf = _adaattn_gs_lf(cfg, vgg, fc1, fs, cs[:n],
                                             vgg_feats, no_conv_target,
                                             fcs=fcs1, spatial=spatial)
        loss_is = 0.0
        for tap in ("relu2_1", "relu3_1", "relu4_1"):
            loss_is = loss_is + losses.image_similarity_loss(
                fc1[tap], fc2[tap], fcs1[tap], fcs2[tap], mesh, spatial)
        loss_is = loss_is * cfg.lambda_is
        total = loss_gs + loss_lf + loss_is
        return total, {"loss_gs": loss_gs, "loss_lf": loss_lf,
                       "loss_is": loss_is, "loss": total}

    return _make_step(cfg, vgg, loss_fn, mesh=mesh, spatial=spatial,
                      place=(_unit(vgg, 1), "make_adaattn_video_step", 2))
