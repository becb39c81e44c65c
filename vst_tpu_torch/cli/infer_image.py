"""Image inference CLI on the card: the ReCoNet family and AdaAttN.

Counterpart of ``vst_tpu/cli/infer_image.py`` (mirrors
AdaAttN/infer_image.py and AdaAttN/infer_image_all.py):

    python -m vst_tpu_torch.cli.infer_image --model adaattn \\
        --weights adaattn.pth --content c.png --style s.png --out results/

``--all-pairs`` styles every content in ``--content`` (a directory) with
every style in ``--style``, style-major: each style is encoded once.
"""

import argparse
import os

from vst_tpu_torch.cli.common import (check_weights_match, list_files,
                                      load_image_255, load_vgg_weights,
                                      load_weights, save_image_255)
from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.infer.image import (adaattn_style_state, stylize_adaattn,
                                       stylize_adaattn_cached,
                                       stylize_reconet)
from vst_tpu_torch.models import adaattn
from vst_tpu_torch.models.reconet import build


def build_parser():
    p = argparse.ArgumentParser(prog="vst_tpu_torch.cli.infer_image")
    p.add_argument("--model", required=True,
                   choices=["reconet", "sd1", "sd2", "rtnstv", "adaattn"])
    p.add_argument("--weights", required=True, help=".pth or JAX .npz")
    p.add_argument("--content",
                   help="image path, or directory with --all-pairs")
    p.add_argument("--style", help="style image (adaattn) or directory")
    p.add_argument("--sample-from", metavar="COCO_DIR,WIKIART_DIR",
                   help="not ported yet")
    p.add_argument("--vgg-weights",
                   help="VGG19 .pth/.npz (default: seeded random init)")
    p.add_argument("--activation", default="softmax",
                   choices=["softmax", "cosine"])
    p.add_argument("--size", type=int, nargs=2, metavar=("H", "W"),
                   help="resize inputs (--all-pairs defaults to 512 512)")
    p.add_argument("--out", default="./results")
    p.add_argument("--all-pairs", action="store_true",
                   help="every content × style combination "
                        "(AdaAttN/infer_image_all.py)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _load(path, size):
    wh = (size[1], size[0]) if size else None
    return load_image_255(path, wh)[None]


def _save(out, dst):
    save_image_255(out[0].float().cpu().numpy(), dst)
    print(dst)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model == "rtnstv":
        raise SystemExit("error: --model rtnstv is not ported to "
                         "vst_tpu_torch yet; use python -m "
                         "vst_tpu.cli.infer_image")
    if args.sample_from:
        raise SystemExit("error: --sample-from is not ported to "
                         "vst_tpu_torch yet; pass --content and --style")
    device = resolve_device(args.device)
    state = load_weights(args.weights)
    check_weights_match(state, args.model, args.weights)
    dtype = next(iter(state.values())).dtype
    os.makedirs(args.out, exist_ok=True)

    if args.model != "adaattn":
        if not args.content:
            raise SystemExit("error: --content is required")
        model = build(args.model, state, device=device, dtype=dtype)
        _save(stylize_reconet(model, _load(args.content, args.size)),
              os.path.join(args.out, "stylized.png"))
        return

    if not args.content or not args.style:
        raise SystemExit("error: --content and --style are required for "
                         "adaattn")
    model = adaattn.build(state, device, dtype)
    vgg = load_vgg_weights(args.vgg_weights, device=device, dtype=dtype)
    if not args.all_pairs:
        out = stylize_adaattn(vgg, model, _load(args.content, args.size),
                              _load(args.style, args.size), args.activation)
        _save(out, os.path.join(args.out, "stylized.png"))
        return
    size = args.size or (512, 512)
    contents = [(os.path.splitext(os.path.basename(p))[0], _load(p, size))
                for p in list_files(args.content)]
    for spath in list_files(args.style):
        state_s = adaattn_style_state(vgg, model, _load(spath, size),
                                      args.activation)
        sname = os.path.splitext(os.path.basename(spath))[0]
        for cname, c in contents:
            out = stylize_adaattn_cached(vgg, model, c, state_s,
                                         args.activation)
            _save(out, os.path.join(args.out, f"{cname}__{sname}.png"))


if __name__ == "__main__":
    main()
