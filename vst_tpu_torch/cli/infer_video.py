"""Streaming video inference CLI on the card: the ReCoNet family, RTNSTV
and AdaAttN.

Counterpart of ``vst_tpu/cli/infer_video.py`` (mirrors
ReCoNet/inference/infer.py, ReCoNet/inference_two_model/infer.py,
RTNSTV/infer.py and AdaAttN/infer_video.py): decode, stylize in batches
with several in flight, and encode an output video, dump frames or show
a live window.

    python -m vst_tpu_torch.cli.infer_video --model reconet \\
        --weights reconet.pth --video in.avi --out styled.mp4
    python -m vst_tpu_torch.cli.infer_video --model adaattn \\
        --weights adaattn.pth --style style.png --video in.avi --out s.mp4

``--data-parallel N`` serves on N ranks of this host, one card each
(NCCL; gloo under ``--device cpu``), spawned and joined through a
``file://`` rendezvous in a temporary directory (N = 1: one rank in this
process, through a world-1 group; no N: every card).  Rank 0 decodes and
scatters each batch, every rank stylizes its slice, rank 0 gathers and
writes; ``--batch-size`` must divide by N.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from vst_tpu_torch.cli.common import (check_weights_match, load_image_255,
                                      load_vgg_weights, load_weights,
                                      save_image_255)
from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.infer.image import stylize_reconet, stylize_rtnstv
from vst_tpu_torch.infer.video import (AdaAttNVideoStylizer,
                                       ShardedBatches, StreamingStylizer,
                                       StreamingVideoWriter,
                                       frames_from_source, video_fps)
from vst_tpu_torch.models import adaattn, rtnstv
from vst_tpu_torch.models.reconet import build
from vst_tpu_torch.parallel import make_mesh, multihost, replicate


def _validated_wire(wire, size, weights2=None):
    """Fall back from --wire i420 to rgb (with a warning) for odd output
    dimensions or the side-by-side --weights2 comparison."""
    if wire == "i420" and (size[0] % 2 or size[1] % 2):
        print(f"warning: --wire i420 needs even dimensions, got "
              f"{size[0]}x{size[1]}; using rgb", file=sys.stderr)
        wire = "rgb"
    if wire == "i420" and weights2:
        print("warning: --wire i420 is unsupported with --weights2 "
              "(side-by-side concatenation); using rgb", file=sys.stderr)
        wire = "rgb"
    return wire


def build_parser():
    p = argparse.ArgumentParser(prog="vst_tpu_torch.cli.infer_video")
    p.add_argument("--model", required=True,
                   choices=["reconet", "sd1", "sd2", "rtnstv", "adaattn"])
    p.add_argument("--weights", required=True, help=".pth or JAX .npz")
    p.add_argument("--weights2",
                   help="second checkpoint: side-by-side comparison output "
                        "(ReCoNet/inference_two_model/infer.py)")
    p.add_argument("--model2", choices=["reconet", "sd1", "sd2", "rtnstv"],
                   help="model family for --weights2 (default: --model)")
    p.add_argument("--style", help="style image (adaattn)")
    p.add_argument("--vgg-weights",
                   help="adaattn: VGG19 .pth/.npz (default: seeded init)")
    p.add_argument("--activation", default="cosine",
                   choices=["softmax", "cosine"], help="adaattn attention")
    p.add_argument("--video", required=True)
    p.add_argument("--input-frame-num", type=int, default=1)
    p.add_argument("--first-frame", type=int)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--pipeline-depth", type=int, default=3,
                   help="batches kept in flight on the card")
    p.add_argument("--size", type=int, nargs=2, metavar=("W", "H"),
                   help="frame size (reconet default 640 360; adaattn "
                        "512 256)")
    p.add_argument("--out", help="output video path (.mp4); omit to only "
                                 "report fps")
    p.add_argument("--frames-dir", help="also dump frames here")
    p.add_argument("--frames-ext", default="jpg", choices=["jpg", "png"],
                   help="frame dump format (jpg as the reference's "
                        "AdaAttN/infer_video.py; png is lossless)")
    p.add_argument("--show", action="store_true",
                   help="live cv2 playback window, 'q' quits")
    p.add_argument("--wire", default="rgb", choices=["rgb", "i420"],
                   help="device→host frame format: i420 packs YUV 4:2:0 on "
                        "the card (half the bytes; bit-exact cv2)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--data-parallel", type=int, metavar="N", nargs="?",
                   const=0, help="serve on N ranks of this host, one "
                                 "device each (no N: every card)")
    return p


def _load_model(family, path, input_frame_num, device, mesh=None):
    state = load_weights(path)
    check_weights_match(state, family, path, input_frame_num)
    dtype = next(iter(state.values())).dtype
    if family == "rtnstv":
        model = rtnstv.build(state, device, dtype)
    else:
        model = build(family, state, input_frame_num, device, dtype)
    return model if mesh is None else replicate(mesh, model)


def _stylizer(family, path, input_frame_num, device, mesh=None):
    """``(batch, wire) -> styled uint8 frames`` of the ``family``
    checkpoint at ``path`` (broadcast from rank 0 with a ``mesh``)."""
    model = _load_model(family, path, input_frame_num, device, mesh)
    stylize = stylize_rtnstv if family == "rtnstv" else stylize_reconet
    return lambda batch, wire="rgb": stylize(model, batch, uint8_out=True,
                                             wire=wire)


def _adaattn_frames(args, device, mesh=None):
    """AdaAttN: the style encoded once, frames area-resized (as
    vst_tpu.cli.infer_video); with a ``mesh`` only rank 0 decodes."""
    if not args.style:
        raise SystemExit("error: --style is required for adaattn")
    if args.weights2:   # JAX's AdaAttN branch never reads it either
        print("warning: --weights2 is ignored for --model adaattn",
              file=sys.stderr)
    state = load_weights(args.weights)
    check_weights_match(state, "adaattn", args.weights)
    dtype = next(iter(state.values())).dtype
    model = adaattn.build(state, device, dtype)
    vgg = load_vgg_weights(args.vgg_weights, device=device, dtype=dtype)
    if mesh is not None:
        replicate(mesh, model)
        replicate(mesh, vgg)
    size = tuple(args.size or (512, 256))
    wire = _validated_wire(args.wire, size)
    stylizer = AdaAttNVideoStylizer(
        vgg, model, load_image_255(args.style, size)[None], args.activation,
        args.batch_size, pipeline_depth=args.pipeline_depth, wire=wire,
        mesh=mesh)
    frames = (frames_from_source(args.video, size, "area", dtype="uint8")
              if multihost.is_primary() else None)
    return stylizer.stylize_frames(frames)


def _feed_forward_frames(args, device, mesh=None):
    """The ReCoNet family and RTNSTV: frames resized linearly, optionally
    beside a second checkpoint's (``--weights2``); with a ``mesh`` each
    batch is split over its ranks and only rank 0 decodes."""
    stylize = _stylizer(args.model, args.weights, args.input_frame_num,
                        device, mesh)
    size = tuple(args.size or (640, 360))
    wire = _validated_wire(args.wire, size, args.weights2)

    def model_fn(batch):
        return stylize(batch, wire)

    if args.weights2:
        stylize2 = _stylizer(args.model2 or args.model, args.weights2,
                             args.input_frame_num, device, mesh)

        def model_fn(batch):  # noqa: F811 — side-by-side comparison
            return torch.cat([stylize(batch), stylize2(batch)], dim=2)

    def stream(fn):
        frames = frames_from_source(args.video, size, "linear",
                                    dtype="uint8")
        return StreamingStylizer(
            fn, frames, args.input_frame_num, args.batch_size,
            args.first_frame, pipeline_depth=args.pipeline_depth, wire=wire,
            device=device)

    if mesh is None:
        return iter(stream(model_fn))
    return ShardedBatches(mesh, model_fn).stream(stream)


def serve(args):
    """Stylize the video and write what was asked for: on one device, or
    as this rank of the initialized process group (data parallel; rank 0
    decodes and writes)."""
    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel is not None:
        mesh = make_mesh(None, ("data",))
        if multihost.is_primary():
            print(f"data-parallel serving over {mesh.size} devices "
                  f"({args.batch_size // mesh.size} frames/device)")
    if args.model == "adaattn":
        out_iter = _adaattn_frames(args, device, mesh)
    else:
        out_iter = _feed_forward_frames(args, device, mesh)
    if not multihost.is_primary():
        for _ in out_iter:   # serve rank 0's batches; nothing comes out
            pass
        return

    show = args.show
    if show:
        try:
            import cv2
        except ImportError:
            print("warning: --show needs cv2; disabled", file=sys.stderr)
            show = False
    writer = (StreamingVideoWriter(args.out, video_fps(args.video) or 30.0)
              if args.out else None)
    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)

    t0 = time.time()
    count = 0
    for frame in out_iter:
        count += 1
        if writer is not None:
            writer.put(np.asarray(frame))
        if args.frames_dir:
            save_image_255(frame, os.path.join(
                args.frames_dir, f"{count - 1:05d}.{args.frames_ext}"))
        if show:
            cv2.imshow("stylized", np.asarray(frame)[..., ::-1])  # RGB→BGR
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
    out_iter.close()   # with a mesh: tells the other ranks to stop
    if show:
        cv2.destroyAllWindows()
    if writer is not None:
        writer.close()
    dt = time.time() - t0
    print(f"{count} frames in {dt:.2f}s → {count / dt:.1f} fps")
    if args.out:
        print(args.out)


def _serve_argv(argv):
    serve(build_parser().parse_args(argv))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.data_parallel is None:
        serve(args)
        return
    n = multihost.local_rank_count(args.data_parallel, args.device)
    if args.batch_size % n:
        raise SystemExit(f"--batch-size {args.batch_size} must be "
                         f"divisible by the {n}-device data mesh")
    multihost.run_local_ranks(_serve_argv, argv, n, args.device)


if __name__ == "__main__":
    main()
