"""Streaming video inference CLI on the card: the ReCoNet family and
AdaAttN.

Counterpart of ``vst_tpu/cli/infer_video.py`` (mirrors
ReCoNet/inference/infer.py, ReCoNet/inference_two_model/infer.py and
AdaAttN/infer_video.py): decode, stylize in batches with several in
flight, and encode an output video, dump frames or show a live window.

    python -m vst_tpu_torch.cli.infer_video --model reconet \\
        --weights reconet.pth --video in.avi --out styled.mp4
    python -m vst_tpu_torch.cli.infer_video --model adaattn \\
        --weights adaattn.pth --style style.png --video in.avi --out s.mp4
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
from vst_tpu_torch.infer.image import stylize_reconet
from vst_tpu_torch.infer.video import (AdaAttNVideoStylizer,
                                       StreamingStylizer,
                                       StreamingVideoWriter,
                                       frames_from_source, video_fps)
from vst_tpu_torch.models import adaattn
from vst_tpu_torch.models.reconet import build

_NOT_PORTED = ("rtnstv",)


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
                   choices=["reconet", "sd1", "sd2", "adaattn", *_NOT_PORTED])
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
                   const=0, help="not ported yet")
    return p


def _load_model(family, path, input_frame_num, device):
    state = load_weights(path)
    check_weights_match(state, family, path, input_frame_num)
    return build(family, state, input_frame_num, device,
                 next(iter(state.values())).dtype)


def _adaattn_frames(args, device):
    """AdaAttN: the style encoded once, frames area-resized (as
    vst_tpu.cli.infer_video)."""
    if not args.style:
        raise SystemExit("error: --style is required for adaattn")
    if args.weights2:
        raise SystemExit("error: --weights2 compares ReCoNet-family models")
    state = load_weights(args.weights)
    check_weights_match(state, "adaattn", args.weights)
    dtype = next(iter(state.values())).dtype
    model = adaattn.build(state, device, dtype)
    vgg = load_vgg_weights(args.vgg_weights, device=device, dtype=dtype)
    size = tuple(args.size or (512, 256))
    wire = _validated_wire(args.wire, size)
    stylizer = AdaAttNVideoStylizer(
        vgg, model, load_image_255(args.style, size)[None], args.activation,
        args.batch_size, pipeline_depth=args.pipeline_depth, wire=wire)
    return stylizer.stylize_frames(
        frames_from_source(args.video, size, "area", dtype="uint8"))


def _reconet_frames(args, device):
    model = _load_model(args.model, args.weights, args.input_frame_num,
                        device)
    size = tuple(args.size or (640, 360))
    wire = _validated_wire(args.wire, size, args.weights2)

    def model_fn(batch):
        return stylize_reconet(model, batch, uint8_out=True, wire=wire)

    if args.weights2:
        model2 = _load_model(args.model2 or args.model, args.weights2,
                             args.input_frame_num, device)
        base_fn = model_fn

        def model_fn(batch):  # noqa: F811 — side-by-side comparison
            b = stylize_reconet(model2, batch, uint8_out=True)
            return torch.cat([base_fn(batch), b], dim=2)

    frames = frames_from_source(args.video, size, "linear", dtype="uint8")
    return iter(StreamingStylizer(
        model_fn, frames, args.input_frame_num, args.batch_size,
        args.first_frame, pipeline_depth=args.pipeline_depth, wire=wire,
        device=device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    for fam in (args.model, args.model2):
        if fam in _NOT_PORTED:
            raise SystemExit(
                f"error: --model {fam} is not ported to vst_tpu_torch yet; "
                "use python -m vst_tpu.cli.infer_video")
    if args.data_parallel is not None:
        raise SystemExit("error: --data-parallel is not ported to "
                         "vst_tpu_torch yet")
    device = resolve_device(args.device)
    if args.model == "adaattn":
        out_iter = _adaattn_frames(args, device)
    else:
        out_iter = _reconet_frames(args, device)

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
    if show:
        cv2.destroyAllWindows()
    if writer is not None:
        writer.close()
    dt = time.time() - t0
    print(f"{count} frames in {dt:.2f}s → {count / dt:.1f} fps")
    if args.out:
        print(args.out)


if __name__ == "__main__":
    main()
