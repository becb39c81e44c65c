"""Training CLI on the card: the seven ReCoNet trainers, RTNSTV's and the
AdaAttN image and video trainers.

Counterpart of ``vst_tpu/cli/train.py`` (ReCoNet/train_single/train_
{candy,starry-night,Flow_noFTL,coco2014,Flow_SD1,Flow_SD2}.py,
train_multiple/train_Flow.py, RTNSTV/train.py, AdaAttN/train_image.py,
train_video.py), with the same trainer names and flags; ``--device``
takes the place of ``--platform``.

    python -m vst_tpu_torch.cli.train --trainer reconet-candy \\
        --data sceneflow --style candy.jpg --out-dir models --resume auto
    python -m vst_tpu_torch.cli.train --trainer rtnstv --data videvo \\
        --data-format videvo --style candy.jpg --out-dir models
    python -m vst_tpu_torch.cli.train --trainer adaattn-image \\
        --data coco/train2014,wikiart --out-dir models --resume auto
"""

import argparse
import dataclasses
import os

from vst_tpu_torch.cli.common import (load_image_255, load_vgg_weights,
                                      load_weights)
from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.models import adaattn, reconet, rtnstv
from vst_tpu_torch.train import config as C
from vst_tpu_torch.train import steps
from vst_tpu_torch.train.checkpoint import load_state, partial_init_from
from vst_tpu_torch.train.loop import TrainingPreempted, run_training
from vst_tpu_torch.train.state import create

TRAINERS = (
    "reconet-candy", "reconet-starry-night", "reconet-noftl",
    "reconet-multiframe", "reconet-coco", "reconet-sd1", "reconet-sd2",
    "rtnstv", "adaattn-image", "adaattn-video",
)
PER_STYLE = tuple(t for t in TRAINERS if not t.startswith("adaattn"))
RECONET_FLOW = {
    "reconet-candy": C.RECONET_CANDY,
    "reconet-starry-night": C.RECONET_STARRY_NIGHT,
    "reconet-noftl": C.RECONET_NOFTL,
    "reconet-multiframe": C.RECONET_MULTIFRAME,
    "reconet-sd1": C.DISTILL_SD1,
    "reconet-sd2": C.DISTILL_SD2,
}


def build_parser():
    p = argparse.ArgumentParser(prog="vst_tpu_torch.cli.train")
    p.add_argument("--trainer", choices=TRAINERS, required=True)
    p.add_argument("--data", required=True,
                   help="dataset root: SceneFlow (holding monkaa and "
                        "flyingthings3d) for the ReCoNet flow and SD "
                        "trainers and rtnstv, or for rtnstv with "
                        "--data-format videvo a Videvo root (frames/ and "
                        "flow/ of cli.preprocess), COCO (holding "
                        "train2014) for "
                        "reconet-coco, 'content_dir,style_dir' (COCO and "
                        "WikiArt) for adaattn-image, 'videvo_dir,style_dir' "
                        "for adaattn-video")
    p.add_argument("--style", help="style image path (per-style trainers)")
    p.add_argument("--vgg-weights", help=".npz/.pth VGG weights "
                                         "(seeded init if omitted)")
    p.add_argument("--teacher-weights", help="teacher ckpt for sd1/sd2 "
                                             "(.pth/.npz; required there)")
    p.add_argument("--init-weights", help="student init ckpt (strict=False)")
    p.add_argument("--out-dir", default="./models")
    p.add_argument("--name", help="checkpoint base name (default: trainer)")
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--img-size", type=int, nargs=2, metavar=("H", "W"))
    p.add_argument("--epoch-start", type=int, default=1)
    p.add_argument("--resume", metavar="STATE",
                   help="resume from a *_last_state checkpoint holding the "
                        "model, the Adam state and the step; combine with "
                        "--epoch-start. 'auto' = resume from "
                        "<out-dir>/<name>_last_state when it exists (epoch "
                        "and batch derived from the saved step), start "
                        "fresh otherwise — an idempotent restart-after-"
                        "crash entry point")
    p.add_argument("--dtype", choices=list(steps.DTYPES),
                   help="compute dtype inside the loss (default: the "
                        "trainer's config, float32); the master parameters "
                        "stay float32")
    p.add_argument("--remat", action="store_true",
                   help="recompute the stylizer and VGG forwards in the "
                        "backward (torch.utils.checkpoint): trades FLOPs "
                        "for activation memory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--loss-plots-dir",
                   help="write per-epoch loss-curve PNGs (RTNSTV/train.py)")
    p.add_argument("--metrics-jsonl", metavar="PATH",
                   help="append one JSON object per logged step (epoch, "
                        "batch, step, samples/s, every loss term)")
    p.add_argument("--heartbeat-file", metavar="PATH",
                   help="touch this file at every batch — the liveness "
                        "signal for cli.supervise --hang-timeout")
    p.add_argument("--data-format", default="sceneflow",
                   choices=["sceneflow", "videvo"],
                   help="rtnstv: SceneFlow GT flow or Videvo precomputed "
                        "flow")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="not ported yet (0 = off)")
    p.add_argument("--multihost", nargs="?", const="auto",
                   metavar="COORD:PORT", help="not ported yet")
    p.add_argument("--num-processes", type=int, help="see --multihost")
    p.add_argument("--process-id", type=int, help="see --multihost")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--save-every-steps", type=int, default=0, metavar="K",
                   help="also save the resumable full state every K batches "
                        "(0 = per-epoch only, the reference's cadence)")
    p.add_argument("--no-nan-recovery", action="store_true",
                   help="disable the non-finite-loss rollback (by default a "
                        "NaN/Inf loss rolls back to the last snapshot and "
                        "skips the batch, up to 3 times per run)")
    return p


def _override(cfg, args):
    kw = {}
    if args.epochs is not None:
        kw["epochs"] = args.epochs
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.lr is not None:
        kw["lr"] = args.lr
    if args.img_size is not None:
        field = ("img_size" if hasattr(cfg, "img_size") else
                 "crop_size" if hasattr(cfg, "crop_size") else "frame_size")
        kw[field] = tuple(args.img_size)
    if args.dtype is not None:
        kw["dtype"] = args.dtype
    if args.remat:
        kw["remat"] = True
    return dataclasses.replace(cfg, **kw) if kw else cfg


def resume_position(state, resume: str, out_dir: str, name: str,
                    epoch_start: int, n_batches: int, log=print):
    """Load ``resume`` (a state path, or ``"auto"``: ``<out_dir>/<name>
    _last_state`` when it exists) into ``state`` and return the
    ``(epoch_start, start_batch)`` the run continues from.

    Under ``"auto"`` with ``epoch_start`` 1 the position comes from the
    saved step, which counts batches consumed: epoch ``step // n_batches
    + 1``, batch ``step % n_batches``.  The shuffle is seed-derived, so
    skipping the already-seen batches at the index level reproduces the
    uninterrupted run's data order."""
    path = resume
    if path == "auto":
        path = os.path.join(out_dir, name + "_last_state")
        if not os.path.isfile(path):
            log(f"auto-resume: no {path}, starting fresh")
            return epoch_start, 0
    load_state(path, like=state)
    start_batch = 0
    if resume == "auto" and epoch_start == 1:
        epoch_start = state.step // n_batches + 1
        start_batch = state.step % n_batches
        log(f"auto-resume: step {state.step} → epoch {epoch_start}"
            + (f" batch {start_batch + 1}" if start_batch else ""))
    return epoch_start, start_batch


def _style_tensor(args, size_hw=None):
    """The style image as a (1, H, W, 3) 0–255 array, resized to
    ``size_hw`` when given."""
    size_wh = (size_hw[1], size_hw[0]) if size_hw else None
    return load_image_255(args.style, size_wh)[None]


def _seeded_model(family, seed, input_frame_num, device, donor=None):
    """A ReCoNet-family model seeded as the JAX package seeds it, with the
    name- and shape-matching entries of ``donor`` (a state_dict) copied
    in (torch's ``strict=False``)."""
    state = params_from_jax(reconet.init_params(family, seed,
                                                input_frame_num))
    if donor is not None:
        state = partial_init_from(state, donor)
    return reconet.build(family, state, input_frame_num, device)


def _build_reconet(args, device):
    """(config, dataset, state, step) of a ReCoNet trainer, seeded as JAX
    seeds it: ``init_reconet(seed, input_frame_num)`` (or the student's
    init with the teacher's matching weights copied in) and the VGG16 of
    ``load_vgg_weights(path, "vgg16", seed)``."""
    from vst_tpu_torch.data.datasets import Coco2014, SceneFlowCombined

    t = args.trainer
    coco = t == "reconet-coco"
    cfg = _override(C.ReCoNetCocoConfig() if coco else RECONET_FLOW[t], args)
    vgg = load_vgg_weights(args.vgg_weights, device, seed=args.seed,
                           flavor="vgg16")
    # candy and starry-night resize the style image to img_size; the
    # others take it as it is
    style = _style_tensor(args, cfg.img_size if "candy" in t or "starry" in t
                          else None)
    grams = steps.reconet_style_grams(vgg, style)
    if coco:
        dataset = Coco2014(args.data, cfg.img_size)
        model = _seeded_model("reconet", args.seed, 1, device)
        step = steps.make_reconet_coco_step(cfg, vgg, grams)
    elif t in ("reconet-sd1", "reconet-sd2"):
        dataset = SceneFlowCombined(args.data, cfg.img_size,
                                    cfg.input_frame_num)
        donor = load_weights(args.teacher_weights)
        teacher = reconet.build(cfg.teacher, donor, cfg.input_frame_num,
                                device)
        model = _seeded_model(cfg.student, args.seed, cfg.input_frame_num,
                              device, donor)
        step = steps.make_reconet_distill_step(cfg, vgg, grams, teacher)
    else:
        dataset = SceneFlowCombined(args.data, cfg.img_size,
                                    cfg.input_frame_num)
        donor = load_weights(args.init_weights) if args.init_weights else None
        model = _seeded_model("reconet", args.seed, cfg.input_frame_num,
                              device, donor)
        step = steps.make_reconet_flow_step(cfg, vgg, grams)
    return cfg, dataset, create(model, cfg.lr), step


def _build_rtnstv(args, device):
    """(config, dataset, state, step) of the RTNSTV trainer, seeded as JAX
    seeds it: ``rtnstv.init_stylizing_network(seed)`` and the VGG19 of
    ``load_vgg_weights(path, "vgg19_rtnstv", seed)``; the style image as
    it is, SceneFlow at ``img_size`` or Videvo frames at their own size."""
    from vst_tpu_torch.data.datasets import SceneFlowCombined, VidevoFlow

    cfg = _override(C.RTNSTVConfig(), args)
    vgg = load_vgg_weights(args.vgg_weights, device, seed=args.seed,
                           flavor="vgg19_rtnstv")
    grams = steps.rtnstv_style_grams(vgg, _style_tensor(args))
    dataset = (VidevoFlow(args.data) if args.data_format == "videvo"
               else SceneFlowCombined(args.data, cfg.img_size))
    state = create(rtnstv.init_stylizing_network(args.seed, device), cfg.lr)
    return cfg, dataset, state, steps.make_rtnstv_step(cfg, vgg, grams)


def build_trainer(args, device):
    """(config, dataset, state, step) of a trainer.  An AdaAttN trainer is
    seeded as JAX seeds it: ``init_stylizing_network(seed)`` and the VGG19
    of ``load_vgg_weights(path, seed=seed)``."""
    if args.trainer.startswith("reconet"):
        return _build_reconet(args, device)
    if args.trainer == "rtnstv":
        return _build_rtnstv(args, device)
    from vst_tpu_torch.data.datasets import CocoWikiArt, VidevoWikiArt

    image = args.trainer == "adaattn-image"
    cfg = _override(C.AdaAttNImageConfig() if image
                    else C.AdaAttNVideoConfig(), args)
    vgg = load_vgg_weights(args.vgg_weights, device, seed=args.seed)
    content_path, wikiart_path = args.data.split(",")
    if image:
        dataset = CocoWikiArt(content_path, wikiart_path, cfg.crop_size,
                              args.seed)
        step = steps.make_adaattn_image_step(cfg, vgg)
    else:
        dataset = VidevoWikiArt(content_path, wikiart_path, args.seed,
                                size_crop=cfg.frame_size)
        step = steps.make_adaattn_video_step(cfg, vgg)
    state = create(adaattn.init_stylizing_network(args.seed, device), cfg.lr)
    return cfg, dataset, state, step


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trainer in PER_STYLE and not args.style:
        raise SystemExit(f"error: --style is required for trainer "
                         f"'{args.trainer}'")
    if args.trainer in ("reconet-sd1", "reconet-sd2") and (
            not args.teacher_weights):
        raise SystemExit(f"error: --teacher-weights is required for "
                         f"trainer '{args.trainer}'")
    if args.data_parallel or args.multihost:
        raise SystemExit("error: --data-parallel and --multihost are not "
                         "ported to vst_tpu_torch yet (ROADMAP item 20)")
    device = resolve_device(args.device)
    name = args.name or args.trainer
    cfg, dataset, state, step = build_trainer(args, device)
    start_batch = 0
    if args.resume:
        n_batches = max(len(dataset) // cfg.batch_size, 1)
        args.epoch_start, start_batch = resume_position(
            state, args.resume, args.out_dir, name, args.epoch_start,
            n_batches)
    try:
        run_training(
            step, state, dataset,
            batch_size=cfg.batch_size, epochs=cfg.epochs,
            epoch_start=args.epoch_start, out_dir=args.out_dir,
            model_name=name, seed=args.seed, log_every=args.log_every,
            loss_plots_dir=args.loss_plots_dir,
            save_every_steps=args.save_every_steps,
            recover_nonfinite=not args.no_nan_recovery,
            start_batch=start_batch, metrics_jsonl=args.metrics_jsonl,
            heartbeat_file=args.heartbeat_file)
    except TrainingPreempted as e:
        # clean exit: the resumable checkpoint is on disk; a supervisor
        # restarts this same command with --resume auto
        print(f"preempted: {e}")
        raise SystemExit(0)


if __name__ == "__main__":
    main()
