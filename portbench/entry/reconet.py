"""The port's entry points for ``reconet``: ``models/reconet.py::build``,
``infer/image.py::stylize_reconet``, ``models/vgg.py::
build_vgg16_reconet``, ``train/steps.py::
make_reconet_flow_step`` with ``reconet_style_grams``, ``train/state.py::
create``; the plain side from ``reference/reconet.py``."""

import dataclasses

import torch

from portbench.core.seeds import sub_seed
from portbench.reference import reconet as ref
from portbench.synth.flow_pairs import SyntheticFlowPairs


def serve_model(cfg, weights, device, dtype):
    from vst_tpu_torch.models import reconet as m

    return m.build("reconet", weights, cfg["input_frame_num"], device, dtype)


def stream_batch(model, batch, wire):
    """One batch of the stream's windows to its styled uint8 frames, as
    ``cli/infer_video.py`` calls it."""
    from vst_tpu_torch.infer.image import stylize_reconet

    return stylize_reconet(model, batch, uint8_out=True, wire=wire)


def frozen_inputs(cfg, seed, device):
    """What the step closes over, made from the seed: the VGG16's weights
    and the style image."""
    h, w = cfg["train"]["img_size"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "style"))
    style = torch.randint(0, 256, (1, h, w, 3), generator=g, device=device,
                          dtype=torch.uint8)
    return {"vgg": ref.vgg_weights(sub_seed(seed, "vgg"), device),
            "style": style}


def train_objects(cfg, weights, frozen, device):
    """(state, step) of the flow trainer at the configuration's settings."""
    from vst_tpu_torch.models import reconet as m
    from vst_tpu_torch.models import vgg as vgg_m
    from vst_tpu_torch.train import config as config_m
    from vst_tpu_torch.train import state as state_m
    from vst_tpu_torch.train import steps as steps_m

    t = dict(cfg["train"], img_size=tuple(cfg["train"]["img_size"]))
    tcfg = dataclasses.replace(config_m.ReCoNetFlowConfig(), **t)
    vgg = vgg_m.build_vgg16_reconet(frozen["vgg"], device)
    grams = steps_m.reconet_style_grams(vgg, frozen["style"].float())
    step = steps_m.make_reconet_flow_step(tcfg, vgg, grams)
    model = m.build("reconet", weights, tcfg.input_frame_num, device,
                    torch.float32)
    return state_m.create(model, tcfg.lr), step


def dataset(cfg, seed, items):
    return SyntheticFlowPairs(items, cfg["train"]["img_size"], seed)


def reference_loss(cfg, frozen):
    """The plain loss over (params, batch), the Grams worked out again."""
    held = {"vgg": frozen["vgg"],
            "grams": ref.style_grams(frozen["vgg"], frozen["style"])}
    return lambda params, batch: ref.flow_loss(cfg["train"], params, held,
                                               batch)
