"""Image inference CLI on the card: the ReCoNet family, RTNSTV and
AdaAttN.

Counterpart of ``vst_tpu/cli/infer_image.py`` (mirrors
AdaAttN/infer_image.py and AdaAttN/infer_image_all.py):

    python -m vst_tpu_torch.cli.infer_image --model adaattn \\
        --weights adaattn.pth --content c.png --style s.png --out results/

``--all-pairs`` styles every content in ``--content`` (a directory) with
every style in ``--style``, style-major: each style is encoded once.
``--sample-from COCO_DIR,WIKIART_DIR`` (adaattn) takes item
``--sample-idx`` of a ``CocoWikiArt`` pairing as the content and style
(AdaAttN/infer_image.py:38-53) and writes all three images.
"""

import argparse
import os

import torch

from vst_tpu_torch.cli.common import (check_weights_match, list_files,
                                      load_image_255, load_vgg_weights,
                                      load_weights, save_image_255)
from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.infer.image import (adaattn_style_state, stylize_adaattn,
                                       stylize_adaattn_cached,
                                       stylize_reconet, stylize_rtnstv)
from vst_tpu_torch.models import adaattn, rtnstv
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
                   help="adaattn only: sample content/style from a "
                        "CocoWikiArt pairing instead of explicit paths "
                        "(AdaAttN/infer_image.py:38-53)")
    p.add_argument("--sample-idx", type=int, default=0)
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
    device = resolve_device(args.device)
    state = load_weights(args.weights)
    check_weights_match(state, args.model, args.weights)
    dtype = next(iter(state.values())).dtype
    os.makedirs(args.out, exist_ok=True)

    if args.model != "adaattn":
        if not args.content:
            raise SystemExit("error: --content is required")
        content = _load(args.content, args.size)
        if args.model == "rtnstv":
            out = stylize_rtnstv(rtnstv.build(state, device, dtype), content)
        else:
            out = stylize_reconet(build(args.model, state, device=device,
                                        dtype=dtype), content)
        _save(out, os.path.join(args.out, "stylized.png"))
        return

    model = adaattn.build(state, device, dtype)
    vgg = load_vgg_weights(args.vgg_weights, device=device, dtype=dtype)
    if args.sample_from:
        from vst_tpu_torch.data.datasets import CocoWikiArt

        coco_dir, wikiart_dir = args.sample_from.split(",")
        c, s = (x[None] for x in
                CocoWikiArt(coco_dir, wikiart_dir)[args.sample_idx])
        out = stylize_adaattn(vgg, model, c, s, args.activation)
        for name, img in (("content", c), ("style", s), ("stylized", out)):
            _save(torch.as_tensor(img), os.path.join(args.out, f"{name}.png"))
        return
    if not args.content or not args.style:
        raise SystemExit("error: --content and --style (or --sample-from) "
                         "are required for adaattn")
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
