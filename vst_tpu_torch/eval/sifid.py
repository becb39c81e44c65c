"""SIFID — Single-Image Fréchet Inception Distance.

Counterpart of ``vst_tpu/eval/sifid.py`` (parity:
AdaAttN/SIFID/sifid_score.py:54-182):
- per-SPATIAL-POSITION activation statistics: an (H·W, C) sample matrix per
  image, mean + covariance over positions (get_activations reshape at
  sifid_score.py:119).  The activations come off the card; the host takes
  the mean and covariance in float64;
- Fréchet distance with matrix sqrt (scipy.linalg.sqrtm), eps jitter on
  singular covariances (:128-182), on the SciPy versions with and
  without sqrtm's ``disp`` argument.

On small images (H·W positions < C channels) the sample covariance is
rank-deficient, scipy emits ``LinAlgWarning: Matrix is singular`` inside
``sqrtm`` and the eps-jitter branch below may run — as the reference does
on the same inputs (sifid_score.py:152-156).
"""

import numpy as np

from vst_tpu_torch.eval.inception import BLOCK_INDEX_BY_DIM, inception_blocks


def activation_statistics(params, img01, dims: int = 2048):
    """img01: (1, H, W, 3) RGB in [0, 1] → (mu (C,), sigma (C, C)) over
    spatial positions."""
    block = BLOCK_INDEX_BY_DIM[dims]
    act = inception_blocks(params, img01, block)[block].cpu().numpy()
    n, h, w, c = act.shape
    samples = act.reshape(n * h * w, c).astype(np.float64)
    mu = samples.mean(axis=0)
    sigma = np.cov(samples, rowvar=False)
    return mu, sigma


def _sqrtm(a):
    """scipy's matrix square root without its printed accuracy message:
    ``disp=False`` where scipy still has the argument (it returns the root
    and an error estimate then); SciPy 1.18 dropped it, and its sqrtm
    prints nothing."""
    import inspect

    from scipy import linalg

    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(a, disp=False)[0]
    return linalg.sqrtm(a)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Numpy Fréchet distance (sifid_score.py:128-182)."""
    return frechet_distance_branch(mu1, sigma1, mu2, sigma2, eps)[0]


def frechet_distance_branch(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """``frechet_distance`` and whether it took the eps-jitter branch (the
    first root not finite)."""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = _sqrtm(sigma1.dot(sigma2))
    jitter = not np.isfinite(covmean).all()
    if jitter:
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean)), jitter


def sifid(params, img0_255: np.ndarray, img1_255: np.ndarray,
          dims: int = 2048) -> float:
    """SIFID between two HWC RGB 0–255 images (eval.py:246-276 wrapper uses
    dims=2048)."""
    a = np.asarray(img0_255, np.float32)[None] / 255.0
    b = np.asarray(img1_255, np.float32)[None] / 255.0
    m1, s1 = activation_statistics(params, a, dims)
    m2, s2 = activation_statistics(params, b, dims)
    return frechet_distance(m1, s1, m2, s2)
