"""Metric CLI (mirrors AdaAttN/eval.py:311-339).

Counterpart of ``vst_tpu/cli/evaluate.py``, with ``--device`` in place of
``--platform``:

    python -m vst_tpu_torch.cli.evaluate -m ssim -p0 a.png -p1 b.png

Modes: lpips / ssim / kl / gram / moment / uni / entropy / sifid /
debug_sifid (per-dims SIFID diagnostic, AdaAttN/eval.py:278-308).  The
network metrics run on the card (float32, TF32 off) unless ``--device
cpu``; the histogram metrics run on the host.
"""

import argparse

import numpy as np
import torch

from vst_tpu_torch.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(
        prog="vst_tpu_torch.cli.evaluate",
        usage="evaluate [-h] [-m MODE] [-p0 PATH0] [-p1 PATH1]")
    p.add_argument("-m", "--mode", default="lpips",
                   choices=["lpips", "ssim", "kl", "gram", "moment", "uni",
                            "entropy", "sifid", "debug_sifid"])
    p.add_argument("-p0", "--path0", default="./results/stylized.png")
    p.add_argument("-p1", "--path1", default="./results/style.png")
    p.add_argument("--vgg19-weights", help="for gram")
    p.add_argument("--lpips-weights",
                   help="LPIPS checkpoint: vendored linear heads (.pth)")
    p.add_argument("--vgg16-weights", help="LPIPS trunk weights")
    p.add_argument("--inception-weights", help="for sifid")
    p.add_argument("--dims", type=int, default=2048,
                   help="sifid feature dims (64/192/768/2048)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _load_uint8(path):
    from PIL import Image

    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except FileNotFoundError:
        # the defaults mirror the reference's ./results/* paths
        # (AdaAttN/eval.py:312-320); missing files should read as "pass
        # -p0/-p1", not as a traceback
        raise SystemExit(f"error: image not found: {path} "
                         f"(pass -p0/-p1 explicitly)")


def _batch(img, device):
    """HWC uint8 → a (1, H, W, 3) float32 0–255 tensor on ``device``."""
    return torch.from_numpy(img.astype(np.float32))[None].to(device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    img0 = _load_uint8(args.path0)
    # single-image modes never touch path1 (matching AdaAttN/eval.py, whose
    # moment/uni/entropy read only path0)
    img1 = (None if args.mode in ("moment", "uni", "entropy")
            else _load_uint8(args.path1))
    if (img1 is not None and img0.shape != img1.shape
            and args.mode in ("ssim", "lpips")):
        # these two compare pixel-aligned maps, so the reference crashes on
        # mismatched shapes too (raw cv2.imread pairs, AdaAttN/eval.py:
        # 226-239); fail readably.  kl/gram/sifid reduce to histograms /
        # C×C grams / per-image stats and accept differing sizes.
        raise SystemExit(
            f"error: image sizes differ ({img0.shape[:2]} vs "
            f"{img1.shape[:2]}); resize to a common size for '{args.mode}'")

    if args.mode == "lpips":
        from vst_tpu_torch.cli.common import load_lpips_weights
        from vst_tpu_torch.eval.lpips import image_to_lpips_input, lpips_vgg

        params = load_lpips_weights(args.vgg16_weights, args.lpips_weights,
                                    device)
        val = float(lpips_vgg(params, image_to_lpips_input(img0),
                              image_to_lpips_input(img1))[0])
        print("Distance: %f" % val)
    elif args.mode == "ssim":
        from vst_tpu_torch.eval import ssim

        val = float(ssim(_batch(img0, device), _batch(img1, device)))
        print("SSIM: %f" % val)
    elif args.mode == "kl":
        from vst_tpu_torch.eval import kl_divergence_rgb

        # reference reads with cv2 (BGR); channel-mean KL is order-invariant
        print("KL: %f" % kl_divergence_rgb(img0, img1))
    elif args.mode == "gram":
        import sys

        from vst_tpu_torch.cli.common import load_vgg_weights
        from vst_tpu_torch.eval import gram_loss_5tap

        if not args.vgg19_weights:
            print("warning: no --vgg19-weights; Gram distance uses RANDOM "
                  "VGG features", file=sys.stderr)
        vgg = load_vgg_weights(args.vgg19_weights, device=device)
        val = float(gram_loss_5tap(vgg, _batch(img0, device),
                                   _batch(img1, device)))
        print("Gram Loss: %f" % val)
    elif args.mode in ("moment", "uni", "entropy"):
        from vst_tpu_torch.eval import (average_entropy, nth_order_moment,
                                        uniformity)

        gray = np.asarray(
            0.299 * img0[..., 0] + 0.587 * img0[..., 1] + 0.114 * img0[..., 2]
        ).astype(np.uint8)
        if args.mode == "moment":
            print("Nth Order Moment: %f" % nth_order_moment(gray))
        elif args.mode == "uni":
            print("Uniformity: %f" % uniformity(gray))
        else:
            print("Average Entropy: %f" % average_entropy(gray))
    elif args.mode in ("sifid", "debug_sifid"):
        from vst_tpu_torch.cli.common import load_inception_weights
        from vst_tpu_torch.eval.sifid import (activation_statistics,
                                              frechet_distance, sifid)

        params = load_inception_weights(args.inception_weights, device)
        if args.mode == "sifid":
            print("SIFID: %f" % sifid(params, img0.astype(np.float32),
                                      img1.astype(np.float32), args.dims))
        else:
            # per-dims diagnostic sweep (AdaAttN/eval.py:278-308)
            print(f"Comparing: {args.path0} vs {args.path1}")
            a = img0.astype(np.float32)[None] / 255.0
            b = img1.astype(np.float32)[None] / 255.0
            for dims in (64, 192, 768, 2048):
                print(f"\n=== Testing with {dims} dimensions ===")
                m1, s1 = activation_statistics(params, a, dims)
                m2, s2 = activation_statistics(params, b, dims)
                print("Mean difference norm: %.6f" % np.linalg.norm(m1 - m2))
                print("Covariance trace 1: %.6f" % np.trace(s1))
                print("Covariance trace 2: %.6f" % np.trace(s2))
                print("SIFID with %dD: %.6f"
                      % (dims, frechet_distance(m1, s1, m2, s2)))


if __name__ == "__main__":
    main()
