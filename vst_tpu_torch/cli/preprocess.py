"""Offline dataset preprocessing CLI, on the host.

Counterpart of ``vst_tpu/cli/preprocess.py``.  The reference runs these
as script bodies inside its dataset modules: frame extraction
(RTNSTV/datasets.py:16-50 at 640×360; AdaAttN/datasets.py:104-133 at
512×256) and per-pair optical flow (RTNSTV/datasets.py:53-85).  They
write the tree ``data/datasets.py::VidevoFlow`` reads, and need cv2.

    python -m vst_tpu_torch.cli.preprocess frames --videos DIR --out DIR \\
        [--size W H] [--ext jpg|png]
    python -m vst_tpu_torch.cli.preprocess flow --frames DIR --out DIR \\
        [--engine auto|deepflow|farneback]
"""

import argparse

from vst_tpu_torch.data.datasets import calculate_optical_flow, get_frames


def build_parser():
    p = argparse.ArgumentParser(prog="vst_tpu_torch.cli.preprocess")
    sub = p.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("frames", help="extract resized frames from videos")
    pf.add_argument("--videos", required=True, help="directory of videos")
    pf.add_argument("--out", required=True,
                    help="output root (frames land in <out>/frames/NNNNN/)")
    pf.add_argument("--size", type=int, nargs=2, default=(640, 360),
                    metavar=("W", "H"),
                    help="frame size (reference: 640 360 for RTNSTV, "
                         "512 256 for AdaAttN)")
    pf.add_argument("--ext", default="jpg", choices=["jpg", "png"])

    po = sub.add_parser("flow", help="forward/backward optical flow per "
                                     "adjacent frame pair")
    po.add_argument("--frames", required=True,
                    help="frames root (the <out>/frames of 'frames')")
    po.add_argument("--out", required=True, help="flow output root")
    po.add_argument("--engine", default="auto",
                    choices=["auto", "deepflow", "farneback"],
                    help="deepflow is the reference's (cv2.optflow, "
                         "RTNSTV/datasets.py:68); farneback needs no "
                         "opencv-contrib")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "frames":
        get_frames(args.videos, args.out, tuple(args.size), "." + args.ext)
        print(f"frames written under {args.out}/frames")
    else:
        calculate_optical_flow(args.frames, args.out, args.engine)
        print(f"flow written under {args.out}")


if __name__ == "__main__":
    main()
