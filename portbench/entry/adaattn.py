"""The port's entry points for ``adaattn``: ``models/adaattn.py::build``,
``models/vgg.py::build_vgg19_adaattn``, ``infer/image.py::
stylize_adaattn``, ``train/steps.py::make_adaattn_image_step``,
``train/state.py::create``; the plain side from ``reference/adaattn.py``."""

import dataclasses

from portbench.core.seeds import sub_seed
from portbench.reference import adaattn as ref
from portbench.synth.pairs import SyntheticPairs


def serve_models(cfg, weights, vgg_weights, device, dtype):
    from vst_tpu_torch.models import adaattn as m
    from vst_tpu_torch.models import vgg as vgg_m

    return (vgg_m.build_vgg19_adaattn(vgg_weights, device, dtype),
            m.build(weights, device, dtype))


def pair_batch(cfg, models, content, style):
    """One batch of (content, style) pairs to styled images, as
    ``cli/infer_image.py`` calls it."""
    from vst_tpu_torch.infer.image import stylize_adaattn

    vgg, net = models
    return stylize_adaattn(vgg, net, content, style, cfg["activation"])


def frozen_inputs(cfg, seed, device):
    return {"vgg": ref.vgg_weights(sub_seed(seed, "vgg"), device)}


def train_objects(cfg, weights, frozen, device):
    from vst_tpu_torch.models import adaattn as m
    from vst_tpu_torch.models import vgg as vgg_m
    from vst_tpu_torch.train import config as config_m
    from vst_tpu_torch.train import state as state_m
    from vst_tpu_torch.train import steps as steps_m

    t = dict(cfg["train"], crop_size=tuple(cfg["train"]["crop_size"]))
    tcfg = dataclasses.replace(config_m.AdaAttNImageConfig(), **t)
    vgg = vgg_m.build_vgg19_adaattn(frozen["vgg"], device)
    step = steps_m.make_adaattn_image_step(tcfg, vgg)
    return state_m.create(m.build(weights, device), tcfg.lr), step


def dataset(cfg, seed, items):
    return SyntheticPairs(items, cfg["train"]["crop_size"], seed)


def reference_loss(cfg, frozen):
    held = {"vgg": frozen["vgg"]}
    return lambda params, batch: ref.image_loss(cfg["train"], params, held,
                                                batch)
