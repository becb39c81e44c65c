"""Experiment runners with CSV output.

Counterpart of ``vst_tpu/cli/experiments.py``, with ``--device`` in place
of ``--platform``.  Mirrors: AdaAttN/exps_image.py, exps_image_all.py
(content×style metric sweeps), exps_video.py (warping error + flow MSE),
exps_sintel.py (per-scene masked warped error), RTNSTV/experiment_Et.py,
ReCoNet/experiment/experiment_mse.py:

    python -m vst_tpu_torch.cli.experiments image --contents C/ \\
        --styles S/ --weights adaattn.pth --out results/results.csv

Each subcommand reads its files, then runs a loop on arrays
(``image_rows``, ``video_errors``, ``temporal_error_sintel``,
``sintel_ada_loss``, ``temporal_mse``), which ``chip_smoke.py`` drives on
synthetic data.  The stylizers run on the card in the loaded weights'
dtype (launching K1/K2 for ReCoNet, K1 for RTNSTV, K3 for AdaAttN
softmax), the metrics and RAFT in float32 with TF32 off.

``video --flow-engine raft`` runs RAFT (as ``sintel-ada`` does); the JAX
package accepts the flag there but always runs Farneback.
"""

import argparse
import csv
import functools
import os

import numpy as np
import torch

from vst_tpu_torch.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(prog="vst_tpu_torch.cli.experiments")
    sub = p.add_subparsers(dest="cmd", required=True)

    # shared flags every subcommand accepts after/among its own flags,
    # matching the sibling CLIs (train/infer/evaluate)
    shared = argparse.ArgumentParser(add_help=False)
    shared.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    pi = sub.add_parser("image", parents=[shared],
                        help="content×style stylize + metric sweep")
    pi.add_argument("--contents", required=True)
    pi.add_argument("--styles", required=True)
    pi.add_argument("--weights", required=True)
    pi.add_argument("--vgg-weights")
    pi.add_argument("--activation", default="softmax")
    pi.add_argument("--size", type=int, nargs=2, default=[512, 512],
                    metavar=("H", "W"))
    pi.add_argument("--lpips-weights", help="vendored LPIPS linear heads")
    pi.add_argument("--vgg16-weights", help="LPIPS trunk")
    pi.add_argument("--inception-weights", help="enables SIFID columns")
    pi.add_argument("--out", default="./results/results.csv")

    pv = sub.add_parser("video", parents=[shared],
                        help="warping error + flow MSE over a video")
    pv.add_argument("--model", required=True,
                    choices=["reconet", "sd1", "sd2", "rtnstv"])
    pv.add_argument("--weights", required=True)
    pv.add_argument("--video", required=True)
    pv.add_argument("--size", type=int, nargs=2, default=[640, 360],
                    metavar=("W", "H"))
    pv.add_argument("--flow-engine", default="farneback",
                    choices=["farneback", "raft"])
    pv.add_argument("--raft-weights")

    pe = sub.add_parser("sintel-et", parents=[shared],
                        help="RTNSTV Et over Sintel scenes")
    pe.add_argument("--weights", required=True)
    pe.add_argument("--sintel", required=True,
                    help="MPI-Sintel-complete root")
    pe.add_argument("--scenes", nargs="*", default=["alley_1"])
    pe.add_argument("--out", default="./results/sintel_et.csv")

    pa = sub.add_parser("sintel-ada", parents=[shared],
                        help="AdaAttN Sintel masked warped error "
                             "(exps_sintel.py)")
    pa.add_argument("--weights", required=True)
    pa.add_argument("--style", required=True)
    pa.add_argument("--vgg-weights")
    pa.add_argument("--sintel", required=True)
    pa.add_argument("--scenes", nargs="*",
                    default=["alley_1", "ambush_4", "bandage_1",
                             "market_2", "temple_2"])
    pa.add_argument("--activation", default="cosine")
    pa.add_argument("--flow-engine", default="gt",
                    choices=["gt", "farneback", "raft"],
                    help="gt = Sintel GT .flo + occlusion masks; raft needs "
                         "--raft-weights (reference used RAFT)")
    pa.add_argument("--raft-weights")
    pa.add_argument("--metric", default="mae", choices=["mae", "mse"])
    pa.add_argument("--size", type=int, nargs=2, default=[256, 512],
                    metavar=("H", "W"))
    pa.add_argument("--out", default="./results/sintel_results.csv")

    pm = sub.add_parser("mse", parents=[shared],
                        help="ReCoNet video temporal MSE")
    pm.add_argument("--model", default="reconet",
                    choices=["reconet", "sd1", "sd2"])
    pm.add_argument("--weights", required=True)
    pm.add_argument("--video", required=True)
    pm.add_argument("--input-frame-num", type=int, default=1)
    return p


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _stylizer(model: str, path: str, device, input_frame_num: int = 1):
    """``model_fn`` for a feed-forward family: a host batch → clamped
    styled frames on the card, in the checkpoint's dtype."""
    from vst_tpu_torch.cli.common import load_weights
    from vst_tpu_torch.infer.image import stylize_reconet, stylize_rtnstv
    from vst_tpu_torch.models import rtnstv
    from vst_tpu_torch.models.reconet import build

    state = load_weights(path)
    dtype = next(iter(state.values())).dtype
    if model == "rtnstv":
        return functools.partial(stylize_rtnstv,
                                 rtnstv.build(state, device, dtype))
    return functools.partial(stylize_reconet,
                             build(model, state, input_frame_num, device,
                                   dtype))


# ------------------------------------------------------------------ image

def metric_row(img0, img1, vgg) -> dict:
    """The metric battery of exps_image.py on two HWC 0–255 images (host
    arrays or tensors), SSIM and Gram on ``vgg``'s device.  ``vgg=None``
    omits the VGG-dependent gram column — a random-backbone Gram distance
    is a meaningless number, not a metric."""
    from vst_tpu_torch.eval import (average_entropy, gram_loss_5tap,
                                    kl_divergence_rgb, nth_order_moment, ssim,
                                    uniformity)

    a = torch.as_tensor(img0).float()
    b = torch.as_tensor(img1).float().to(a.device)
    a8 = np.clip(_host(a), 0, 255).astype(np.uint8)
    b8 = np.clip(_host(b), 0, 255).astype(np.uint8)
    gray = np.asarray(0.299 * a8[..., 0] + 0.587 * a8[..., 1]
                      + 0.114 * a8[..., 2]).astype(np.uint8)
    row = {
        "ssim": float(ssim(a[None], b[None])),
        "kl": kl_divergence_rgb(a8, b8),
        "moment": nth_order_moment(gray),
        "uniformity": uniformity(gray),
        "entropy": average_entropy(gray),
    }
    if vgg is not None:
        row["gram"] = float(gram_loss_5tap(vgg, a[None], b[None]))
    return row


def lpips_metric(params):
    """(a, b) → the LPIPS-vgg distance of two HWC 0–255 images."""
    from vst_tpu_torch.eval.lpips import lpips_vgg

    def lpips_fn(a, b):
        dev = next(iter(params.values())).device
        x = [torch.as_tensor(v).to(dev, torch.float32)[None] / (255.0 / 2.0)
             - 1.0 for v in (a, b)]
        return float(lpips_vgg(params, *x)[0])
    return lpips_fn


def image_rows(stylize, contents, styles, metric_vgg=None, lpips_fn=None,
               sifid_fn=None) -> list:
    """The content×style sweep: ``stylize(c, s)`` on (1, H, W, 3) 0–255
    batches → styled frames; ``contents``/``styles``: lists of (file name,
    HWC 0–255 array).  Returns the CSV rows, the column averages last."""
    rows = []
    for cname, c in contents:
        for sname, s in styles:
            cs = stylize(c[None], s[None])[0].float()
            row = {"content": cname, "style": sname}
            row.update({f"style_{k}": v for k, v in
                        metric_row(cs, s, metric_vgg).items()})
            row.update({f"content_{k}": v for k, v in
                        metric_row(cs, c, metric_vgg).items()})
            if lpips_fn:
                row["lpips_content"] = lpips_fn(cs, c)
                row["lpips_style"] = lpips_fn(cs, s)
            if sifid_fn:
                row["sifid_style"] = sifid_fn(_host(cs), s)
            rows.append(row)
            print(row["content"], row["style"], f"ssim={row['style_ssim']:.4f}")
    if rows:
        avg = {"content": "average", "style": ""}
        for k in rows[0]:
            if k not in ("content", "style"):
                avg[k] = float(np.mean([r[k] for r in rows]))
        rows.append(avg)
    return rows


def run_image(args):
    import sys

    from vst_tpu_torch.cli.common import (list_files, load_image_255,
                                          load_inception_weights,
                                          load_lpips_weights, load_vgg_weights,
                                          load_weights)
    from vst_tpu_torch.eval.sifid import sifid as sifid_metric
    from vst_tpu_torch.infer.image import stylize_adaattn
    from vst_tpu_torch.models import adaattn

    device = resolve_device(args.device)
    state = load_weights(args.weights)
    dtype = next(iter(state.values())).dtype
    model = adaattn.build(state, device, dtype)
    vgg = load_vgg_weights(args.vgg_weights, device=device, dtype=dtype)
    # the metric's VGG19 runs in float32 whatever the stylizer's dtype
    metric_vgg = (load_vgg_weights(args.vgg_weights, device=device)
                  if args.vgg_weights else None)
    if metric_vgg is None:
        print("warning: no --vgg-weights; gram columns omitted from the CSV "
              "(random-backbone Gram distance is meaningless)",
              file=sys.stderr)
    lpips_fn = sifid_fn = None
    if args.vgg16_weights and args.lpips_weights:
        lpips_fn = lpips_metric(load_lpips_weights(
            args.vgg16_weights, args.lpips_weights, device))
    if args.inception_weights:
        ip = load_inception_weights(args.inception_weights, device)
        sifid_fn = functools.partial(sifid_metric, ip)

    h, w = args.size
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def load(d):
        return [(os.path.basename(p), load_image_255(p, (w, h)))
                for p in list_files(d)]

    rows = image_rows(
        lambda c, s: stylize_adaattn(vgg, model, c, s, args.activation),
        load(args.contents), load(args.styles), metric_vgg, lpips_fn,
        sifid_fn)
    if rows:
        with open(args.out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    print(args.out)


# ------------------------------------------------------------------ video

def farneback_flow(a, b):
    """cv2 Farneback flow a→b of two HWC RGB 0–255 frames (needs cv2)."""
    import cv2

    ga = cv2.cvtColor(a.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    gb = cv2.cvtColor(b.astype(np.uint8), cv2.COLOR_RGB2GRAY)
    return cv2.calcOpticalFlowFarneback(ga, gb, None, 0.5, 5, 15, 3, 5, 1.2,
                                        0)


def raft_flow_fn(params, iters: int = 12):
    """(a, b) → RAFT flow a→b (H, W, 2) on the host, of two HWC RGB 0–255
    frames (the reference's raftTransforms: /127.5 − 1)."""
    from vst_tpu_torch.models.raft import raft_flow

    def flow(a, b):
        x = [np.asarray(v, np.float32)[None] / 127.5 - 1.0 for v in (a, b)]
        return raft_flow(params, *x, iters=iters)[0].cpu().numpy()
    return flow


def video_errors(model_fn, frames, flow, batch: int = 8):
    """Warping error and flow MSE over a frame stream (exps_video.py).

    Streams in fixed-size chunks: each chunk is stylized in ONE call and
    its pair terms evaluated in ONE batched call (bounded host memory; the
    reference loops batch-1 per frame, exps_video.py:54-117).  ``flow(a,
    b)`` → (H, W, 2) host flow of two HWC 0–255 frames."""
    from vst_tpu_torch.data.flow_np import flow_warp_mask_np
    from vst_tpu_torch.eval.temporal import (flow_mse, map_batched,
                                             warping_error_terms)

    total, count, fmse = 0.0, 0, 0.0
    carry = None  # (last content frame, last styled frame) across chunks

    def process(chunk, carry):
        nonlocal total, count, fmse
        styled = map_batched(model_fn, np.stack(chunk).astype(np.float32),
                             batch).float()
        contents = list(chunk)
        styled = list(styled)
        if carry is not None:
            contents.insert(0, carry[0])
            styled.insert(0, carry[1])
        host = [_host(s) for s in styled]
        f10s, masks = [], []
        for c1, c2, cs1, cs2 in zip(contents[:-1], contents[1:], host[:-1],
                                    host[1:]):
            f01, f10 = flow(c1, c2), flow(c2, c1)
            f10s.append(f10)
            masks.append(flow_warp_mask_np(f01, f10))
            fmse += flow_mse(f10, flow(cs2, cs1))
        if f10s:
            terms = map_batched(
                warping_error_terms,
                (torch.stack(styled[:-1]), torch.stack(styled[1:]),
                 np.stack(f10s).astype(np.float32),
                 np.stack(masks).astype(np.float32)), batch)
            total += float(terms.sum())
            count += len(f10s)
        return (contents[-1], styled[-1])

    chunk = []
    for frame in frames:
        chunk.append(frame)
        if len(chunk) == batch:
            carry = process(chunk, carry)
            chunk = []
    if chunk:
        carry = process(chunk, carry)
    return float(np.sqrt(total / count)), fmse / count


def run_video(args):
    from vst_tpu_torch.infer.video import frames_from_video

    device = resolve_device(args.device)
    model_fn = _stylizer(args.model, args.weights, device)
    if args.flow_engine == "raft":
        flow = raft_flow_fn(_raft_params(args, device))
    else:
        flow = farneback_flow
    warping_error, fmse = video_errors(
        model_fn, frames_from_video(args.video, tuple(args.size), "linear"),
        flow)
    print(f"Warping Error: {warping_error}")
    print(f"Flow MSE: {fmse}")


def _raft_params(args, device):
    from vst_tpu_torch.cli.common import load_raft_weights

    if not args.raft_weights:
        raise SystemExit("error: --flow-engine raft needs --raft-weights")
    return load_raft_weights(args.raft_weights, device)


# ------------------------------------------------------------- sintel-et

def run_sintel_et(args):
    from vst_tpu_torch.cli.common import list_files
    from vst_tpu_torch.data.datasets import load_image
    from vst_tpu_torch.data.flow_np import resize_flow_np
    from vst_tpu_torch.data.flowio import read_sintel_flo
    from vst_tpu_torch.eval.temporal import temporal_error_sintel

    device = resolve_device(args.device)
    model_fn = _stylizer("rtnstv", args.weights, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    for scene in args.scenes:
        frames = [load_image(p, (640, 360))
                  for p in list_files(
                      os.path.join(args.sintel, "training/final", scene))]
        flow_files = list_files(
            os.path.join(args.sintel, "training/flow", scene))
        mask_files = list_files(
            os.path.join(args.sintel, "training/occlusions", scene))
        flows = [resize_flow_np(read_sintel_flo(p), (360, 640))
                 for p in flow_files]
        masks = [(load_image(p, (640, 360), mode="L")[..., 0] == 0)
                 .astype(np.float32) for p in mask_files]
        et = temporal_error_sintel(model_fn, frames, flows, masks)
        rows.append({"scene": scene, "Et": et})
        print(scene, et)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["scene", "Et"])
        writer.writeheader()
        writer.writerows(rows)
    print(args.out)


# ------------------------------------------------------------ sintel-ada

def sintel_ada_stylizer(vgg, model, style, activation):
    """A content batch (B, H, W, 3) 0–255 → styled frames scaled to 0–1
    (float32, on the card).  The style is encoded ONCE into its attention
    state and broadcast over each batch (the reference stylizes batch-1
    per frame, exps_sintel.py:75-80)."""
    from vst_tpu_torch.infer.image import (adaattn_style_state,
                                           stylize_adaattn_cached)

    state = adaattn_style_state(vgg, model, style, activation)

    def stylize_batch(content):
        cs = stylize_adaattn_cached(vgg, model, content, state, activation)
        return cs.float() / 255.0
    return stylize_batch


def estimated_pairs(flow):
    """``pair(idx, frames)`` → (False, backward flow, mask) from a flow
    estimator ``flow(a, b)``: the reference warps cs1 toward frame 2 with
    the estimated backward flow (exps_sintel.py:92)."""
    from vst_tpu_torch.data.flow_np import flow_warp_mask_np

    def pair(idx, frames):
        f01 = flow(frames[idx], frames[idx + 1])
        f10 = flow(frames[idx + 1], frames[idx])
        return False, f10, flow_warp_mask_np(f01, f10)
    return pair


def _gt_pairs(args, scene, size_hw):
    """``pair(idx, frames)`` → (True, forward flow, mask) from the Sintel
    GT flow and occlusion files: with GT forward flow the roles swap —
    warp(cs2, flow_fwd) reconstructs frame 1 (as RTNSTV's Et does,
    RTNSTV/utilities.py:232-236)."""
    from vst_tpu_torch.cli.common import list_files
    from vst_tpu_torch.data.datasets import load_image
    from vst_tpu_torch.data.flow_np import resize_flow_np
    from vst_tpu_torch.data.flowio import read_sintel_flo

    h, w = size_hw
    flo = list_files(os.path.join(args.sintel, "training/flow", scene))
    occ = list_files(os.path.join(args.sintel, "training/occlusions", scene))

    def pair(idx, frames):
        flow01 = resize_flow_np(read_sintel_flo(flo[idx]), (h, w))
        mask = load_image(occ[idx], (w, h), mode="L")[..., 0] == 0
        return True, flow01, mask.astype(np.float32)
    return pair


def sintel_ada_loss(stylize_batch, frames, pair, use_mae=True,
                    batch: int = 8) -> float:
    """One scene's optical-flow loss (exps_sintel.py:75-110): all frames
    stylized in ``batch``-size chunks, every pair term in batched calls,
    sqrt(Σ terms) / pairs."""
    from vst_tpu_torch.eval.temporal import (map_batched,
                                             sintel_optical_loss_terms)

    count = len(frames) - 1
    styled = map_batched(stylize_batch, np.stack(frames).astype(np.float32),
                         batch)
    pair_data = [pair(i, frames) for i in range(count)]
    flows = np.stack([p[1] for p in pair_data]).astype(np.float32)
    masks = np.stack([p[2] for p in pair_data]).astype(np.float32)
    # the engine is uniform per run, so the whole scene batches one way
    src, dst = ((styled[1:], styled[:-1]) if pair_data[0][0]
                else (styled[:-1], styled[1:]))
    per_pair = map_batched(
        functools.partial(sintel_optical_loss_terms, use_mae=use_mae),
        (src, dst, flows, masks), batch)
    return float(np.sqrt(float(per_pair.sum())) / count)


def run_sintel_ada(args):
    from vst_tpu_torch.cli.common import (list_files, load_image_255,
                                          load_vgg_weights, load_weights)
    from vst_tpu_torch.data.datasets import load_image
    from vst_tpu_torch.models import adaattn

    device = resolve_device(args.device)
    h, w = args.size
    state = load_weights(args.weights)
    dtype = next(iter(state.values())).dtype
    model = adaattn.build(state, device, dtype)
    vgg = load_vgg_weights(args.vgg_weights, device=device, dtype=dtype)
    style = load_image_255(args.style, (w, h))[None]
    stylize_batch = sintel_ada_stylizer(vgg, model, style, args.activation)
    if args.flow_engine == "raft":
        estimated = estimated_pairs(raft_flow_fn(_raft_params(args, device)))
    elif args.flow_engine == "farneback":
        estimated = estimated_pairs(farneback_flow)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    for scene in args.scenes:
        frame_files = list_files(
            os.path.join(args.sintel, "training/final", scene))
        frames = [load_image(p, (w, h)) for p in frame_files]
        pair = (_gt_pairs(args, scene, (h, w)) if args.flow_engine == "gt"
                else estimated)
        loss = sintel_ada_loss(stylize_batch, frames, pair,
                               args.metric == "mae")
        rows.append({"Scene": scene, "Optical Flow Loss": loss})
        print(scene, loss)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["Scene", "Optical Flow Loss"])
        writer.writeheader()
        writer.writerows(rows)
    print(args.out)


# ------------------------------------------------------------------- mse

def run_mse(args):
    from vst_tpu_torch.eval.temporal import temporal_mse
    from vst_tpu_torch.infer.video import frames_from_video

    device = resolve_device(args.device)
    model_fn = _stylizer(args.model, args.weights, device,
                         args.input_frame_num)
    frames = frames_from_video(args.video, (640, 360), "linear")
    print(temporal_mse(model_fn, frames, args.input_frame_num))


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"image": run_image, "video": run_video, "sintel-et": run_sintel_et,
     "sintel-ada": run_sintel_ada, "mse": run_mse}[args.cmd](args)


if __name__ == "__main__":
    main()
