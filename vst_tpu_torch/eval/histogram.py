"""Histogram-based metrics (parity: AdaAttN/eval.py:38-164).

Counterpart of ``vst_tpu/eval/histogram.py``, a numpy copy: all operate
on uint8 images (HWC RGB or HW grayscale) on the host — cheap
statistics that never touch the card.
"""

import numpy as np


def compute_histogram(img: np.ndarray, channel: int | None = None) -> np.ndarray:
    """256-bin count histogram + 1 (Laplace smoothing), eval.py:38-46."""
    data = img.flatten() if channel is None else img[:, :, channel].flatten()
    return np.bincount(data, minlength=256) + 1


def _entropy(p: np.ndarray, q: np.ndarray) -> float:
    """scipy.stats.entropy semantics: normalize, sum p·log(p/q)."""
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum(p * np.log(p / q)))


def kl_divergence_rgb(img: np.ndarray, style: np.ndarray) -> float:
    """Mean per-channel KL divergence of 256-bin histograms
    (eval.py:49-67)."""
    kl = 0.0
    for ch in range(3):
        kl += _entropy(compute_histogram(img, ch), compute_histogram(style, ch))
    return kl / 3.0


def _gray_hist_stats(img_gray: np.ndarray):
    hist = compute_histogram(img_gray)
    return hist, hist / np.sum(hist)


def nth_order_moment(img_gray: np.ndarray) -> float:
    """2nd-order moment of the normalized histogram (eval.py:111-128).

    Reproduces the reference's exact (unusual) recipe: histogram values /255,
    second moment weighted by the probability mass.
    """
    hist, hist_p = _gray_hist_stats(img_gray)
    h = hist / 255.0
    mean = np.mean(h)
    return float(np.sum(((h - mean) ** 2) * hist_p))


def uniformity(img_gray: np.ndarray) -> float:
    """Σ p², eval.py:131-145."""
    _, hist_p = _gray_hist_stats(img_gray)
    return float(np.sum(hist_p ** 2))


def average_entropy(img_gray: np.ndarray) -> float:
    """−Σ p·log2(p), eval.py:148-164."""
    _, hist_p = _gray_hist_stats(img_gray)
    p = hist_p[hist_p > 0]
    return float(-np.sum(p * np.log2(p)))
