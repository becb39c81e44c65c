"""LPIPS calibration trainer — the vendored package's training harness.

Counterpart of ``vst_tpu/eval/lpips_trainer.py`` (parity:
AdaAttN/lpips/trainer.py:14-280 + lpips/lpips.py:199-238):

- ``Dist2LogitLayer``: (d0, d1) → 1×1-conv MLP [5→32→32→1, LeakyReLU(0.2),
  sigmoid] over the channel-stack (d0, d1, d0−d1, d0/(d1+eps), d1/(d0+eps));
- ``BCERankingLoss``: BCE(logit, (judge+1)/2) on 2AFC human judgments;
- Adam(lr, betas=(beta1, 0.999), eps 1e-8) over the linear heads + rank
  net (trainer.py:70-76), with the 1×1 head weights clamped ≥ 0 after
  every step (``clamp_weights``, trainer.py:104-107);
- ``compute_accuracy`` (trainer.py:139-143) and ``score_2afc_dataset``
  (trainer.py:208-240), ``score_jnd_dataset`` (:243-280), on the host.

The trunk is frozen (the reference's default ``pnet_tune=False``): only
the "lin*" heads and the rank net take gradients.  Parameters are dicts
of tensors in torch layout (``compat.params_from_jax`` of the JAX
package's); the step updates its ``RankingState`` in place.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.eval.lpips import _lpips
from vst_tpu_torch.ops.conv import conv2d


def init_dist2logit(seed: int = 0, chn_mid: int = 32) -> dict:
    """Random init of the Dist2LogitLayer convs (lpips/lpips.py:199-222):
    numpy HWIO, the JAX package's draws."""
    rng = np.random.default_rng(seed)

    def conv(ci, co):
        w = (rng.standard_normal((1, 1, ci, co)) / np.sqrt(ci)).astype(
            np.float32)
        return w, np.zeros(co, np.float32)

    params = {}
    for i, (ci, co) in enumerate([(5, chn_mid), (chn_mid, chn_mid),
                                  (chn_mid, 1)]):
        params[f"conv{i}.weight"], params[f"conv{i}.bias"] = conv(ci, co)
    return params


def dist2logit(params, d0, d1, eps: float = 0.1):
    """(N,) distances → (N,) sigmoid probability that d1 < d0
    (lpips/lpips.py:223-225 forward)."""
    d0 = d0.reshape(-1, 1, 1, 1)
    d1 = d1.reshape(-1, 1, 1, 1)
    x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)],
                  dim=-1)
    x = F.leaky_relu(
        conv2d(x, params["conv0.weight"], params["conv0.bias"]), 0.2)
    x = F.leaky_relu(
        conv2d(x, params["conv1.weight"], params["conv1.bias"]), 0.2)
    x = torch.sigmoid(
        conv2d(x, params["conv2.weight"], params["conv2.bias"]))
    return x.reshape(-1)


def bce_ranking_loss(rank_params, d0, d1, judge):
    """BCERankingLoss (lpips/lpips.py:227-238): judge ∈ [-1, 1] →
    per = (judge+1)/2; BCE(dist2logit(d0, d1), per)."""
    per = (judge.reshape(-1) + 1.0) / 2.0
    p = torch.clamp(dist2logit(rank_params, d0, d1), 1e-7, 1 - 1e-7)
    return -torch.mean(per * torch.log(p) + (1 - per) * torch.log(1 - p))


def compute_accuracy(d0, d1, judge):
    """trainer.py:139-143: fraction of judgments the distance order agrees
    with (judge ∈ [0, 1] here, as fed from the 2AFC dataset)."""
    d1_lt_d0 = (_np(d1) < _np(d0)).astype(np.float64)
    judge = _np(judge).astype(np.float64).reshape(-1)
    return float(np.mean(d1_lt_d0 * judge + (1 - d1_lt_d0) * (1 - judge)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass
class RankingState:
    """The calibration state: the LPIPS parameters (trunk frozen, heads
    trained), the rank net and the Adam optimizer over heads + rank net."""
    lpips: dict
    rank: dict
    optimizer: torch.optim.Optimizer


def make_lpips_ranking_step(net: str = "vgg", lr: float = 1e-4,
                            beta1: float = 0.5):
    """Build (init_state, step) for LPIPS linear-head calibration.

    ``init_state(lpips_params, rank_params)`` takes dicts of tensors (on
    the device the step runs on) and copies them.  ``step(state, ref, p0,
    p1, judge)`` → (state, metrics); batches are (N, H, W, 3) in [-1, 1]
    with judge (N,) ∈ [-1, 1].  Trains the "lin*" heads + rank net only
    (trunk frozen), Adam(beta1, 0.999, eps 1e-8, as optax's adam), heads
    clamped ≥ 0 after each step; the state is updated in place.
    """
    def init_state(lpips_params, rank_params):
        lp = {k: v.detach().clone().float().requires_grad_(
            k.startswith("lin")) for k, v in lpips_params.items()}
        rank = {k: v.detach().clone().float().requires_grad_(True)
                for k, v in rank_params.items()}
        trained = [v for k, v in lp.items() if k.startswith("lin")]
        trained += list(rank.values())
        opt = torch.optim.Adam(trained, lr=lr, betas=(beta1, 0.999),
                               eps=1e-8)
        return RankingState(lp, rank, opt)

    def step(state, ref, p0, p1, judge):
        dev = next(iter(state.lpips.values())).device
        judge = torch.as_tensor(judge).to(dev, torch.float32)
        with torch.enable_grad():
            d0 = _lpips(state.lpips, ref, p0, net)
            d1 = _lpips(state.lpips, ref, p1, net)
            loss = bce_ranking_loss(state.rank, d0, d1, judge)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        # clamp_weights (trainer.py:104-107): 1×1 head weights ≥ 0
        with torch.no_grad():
            for k, v in state.lpips.items():
                if k.startswith("lin"):
                    v.clamp_(min=0.0)
        return state, {"loss_total": loss.detach(), "d0": d0.detach(),
                       "d1": d1.detach()}

    return init_state, step


def score_2afc(d0s, d1s, judges):
    """score_2afc_dataset core (trainer.py:208-240): mean human-agreement
    score over a 2AFC set, judges ∈ [0, 1]."""
    d0s = np.asarray(d0s, np.float64).reshape(-1)
    d1s = np.asarray(d1s, np.float64).reshape(-1)
    gts = np.asarray(judges, np.float64).reshape(-1)
    scores = (d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts \
        + (d1s == d0s) * 0.5
    return float(np.mean(scores))


def voc_ap(rec, prec):
    """VOC AP: area under the precision-recall envelope
    (lpips/__init__.py:96-126, use_07_metric=False branch)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def score_jnd(ds, sames):
    """score_jnd_dataset core (trainer.py:243-280): mAP of
    distance-thresholded same/different classification."""
    ds = np.asarray(ds, np.float64).reshape(-1)
    sames = np.asarray(sames, np.float64).reshape(-1)
    order = np.argsort(ds)
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = np.sum(sames_sorted) - tps
    precs = tps / (tps + fps)
    recs = tps / (tps + fns)
    return voc_ap(recs, precs)
