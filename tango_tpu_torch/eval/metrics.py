"""Objective audio-generation metrics in numpy and scipy: port of
tango_tpu/eval/metrics.py, the same numbers from the same seeds.

Numerics match the reference audioldm_eval metric functions:
  * FD / FAD (Frechet distance) — metrics/fid.py:6-69, fad.py:130-170
  * paired KL on logits (softmax + sigmoid variants) — metrics/kl.py:35-151
  * Inception Score (10 splits) — metrics/isc.py:5-32
  * KID (polynomial-kernel MMD) — metrics/kid.py:1-104
  * PSNR / SSIM on paired mels (skimage semantics) — eval.py:235-249

Feature dictionaries are {"2048": (N,2048), "logits": (N,527), "file_path_":
[paths]} exactly as the reference extractors emit (eval.py:327-367).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.linalg


# ------------------------------------------------------------------- frechet

def frechet_distance(feats_1: np.ndarray, feats_2: np.ndarray, eps: float = 1e-6) -> float:
    mu1, mu2 = feats_1.mean(0), feats_2.mean(0)
    sigma1 = np.cov(feats_1, rowvar=False)
    sigma2 = np.cov(feats_2, rowvar=False)
    diff = mu1 - mu2
    try:
        covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    except Exception:
        covmean = np.full_like(sigma1, np.nan)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def calculate_fid(featuresdict_1, featuresdict_2, feat_layer_name: str = "2048") -> dict:
    return {
        "frechet_distance": frechet_distance(
            np.asarray(featuresdict_1[feat_layer_name]),
            np.asarray(featuresdict_2[feat_layer_name]),
        )
    }


# ------------------------------------------------------------------------ KL

def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def calculate_kl(featuresdict_1, featuresdict_2, feat_layer_name: str = "logits", same_name: bool = True):
    """Paired KL(target || prediction) matched by basename (kl.py:35-118)."""
    if not same_name:
        return (
            {
                "kullback_leibler_divergence_sigmoid": -1.0,
                "kullback_leibler_divergence_softmax": -1.0,
            },
            None,
            None,
        )
    eps = 1e-6
    f1 = np.asarray(featuresdict_1[feat_layer_name], np.float64)
    f2 = np.asarray(featuresdict_2[feat_layer_name], np.float64)
    paths_1 = [os.path.basename(x) for x in featuresdict_1["file_path_"]]
    paths_2 = [os.path.basename(x) for x in featuresdict_2["file_path_"]]
    by_name_1 = {p: f for p, f in zip(paths_1, f1)}
    feats_1, feats_2 = [], []
    for p, feat2 in zip(paths_2, f2):
        if p not in by_name_1:
            continue
        feats_1.append(by_name_1[p])
        feats_2.append(feat2)
    a = np.stack(feats_1)
    b = np.stack(feats_2)

    # torch kl_div(log_input, target) = sum target * (log target - log_input)
    def kl_div_sum(log_input, target):
        t = np.where(target > 0, target, 1.0)
        return float(np.sum(target * (np.log(t) - log_input)))

    kl_softmax = kl_div_sum(np.log(_softmax(a, 1) + eps), _softmax(b, 1)) / len(a)
    kl_sigmoid = kl_div_sum(np.log(_sigmoid(a) + eps), _sigmoid(b)) / len(a)
    return (
        {
            "kullback_leibler_divergence_sigmoid": float(kl_sigmoid),
            "kullback_leibler_divergence_softmax": float(kl_softmax),
        },
        None,
        paths_1,
    )


# ------------------------------------------------------------------------ IS

def calculate_isc(featuresdict, feat_layer_name: str = "logits", rng_seed: int = 2020,
                  samples_shuffle: bool = True, splits: int = 10) -> dict:
    features = np.asarray(featuresdict[feat_layer_name], np.float64)
    n = features.shape[0]
    if samples_shuffle:
        rng = np.random.RandomState(rng_seed)
        features = features[rng.permutation(n), :]
    p = _softmax(features, 1)
    log_p = features - features.max(1, keepdims=True)
    log_p = log_p - np.log(np.exp(log_p).sum(1, keepdims=True))
    scores = []
    for i in range(splits):
        pc = p[i * n // splits : (i + 1) * n // splits]
        lpc = log_p[i * n // splits : (i + 1) * n // splits]
        q = pc.mean(0, keepdims=True)
        kl = (pc * (lpc - np.log(q))).sum(1).mean()
        scores.append(np.exp(kl))
    return {
        "inception_score_mean": float(np.mean(scores)),
        "inception_score_std": float(np.std(scores)),
    }


# ----------------------------------------------------------------------- KID

def _polynomial_mmd(f1, f2, degree=3, gamma=None, coef0=1):
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    k_xx = (gamma * f1.dot(f1.T) + coef0) ** degree
    k_yy = (gamma * f2.dot(f2.T) + coef0) ** degree
    k_xy = (gamma * f1.dot(f2.T) + coef0) ** degree
    m = f1.shape[0]
    n = f2.shape[0]
    # unbiased MMD^2 (diagonal terms removed)
    sum_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    sum_xy = k_xy.mean()
    return sum_xx + sum_yy - 2 * sum_xy


def calculate_kid(featuresdict_1, featuresdict_2, feat_layer_name: str = "2048",
                  subsets: int = 100, subset_size: int = 1000, degree: int = 3,
                  gamma=None, coef0: int = 1, rng_seed: int = 2020) -> dict:
    f1 = np.asarray(featuresdict_1[feat_layer_name], np.float64)
    f2 = np.asarray(featuresdict_2[feat_layer_name], np.float64)
    subset_size = min(subset_size, len(f1), len(f2))
    rng = np.random.RandomState(rng_seed)
    mmds = np.zeros(subsets)
    for i in range(subsets):
        a = f1[rng.choice(len(f1), subset_size, replace=False)]
        b = f2[rng.choice(len(f2), subset_size, replace=False)]
        mmds[i] = _polynomial_mmd(a, b, degree, gamma, coef0)
    return {
        "kernel_inception_distance_mean": float(np.mean(mmds)),
        "kernel_inception_distance_std": float(np.std(mmds)),
    }


# ------------------------------------------------------------ paired PSNR/SSIM

def psnr(a: np.ndarray, b: np.ndarray, data_range: Optional[float] = None) -> float:
    """skimage.metrics.peak_signal_noise_ratio(image_true=a, image_test=b).

    For float inputs skimage derives data_range from the DTYPE range (-1, 1):
    1.0 when a.min() >= 0 else 2.0 — never from the observed min/max. The
    evaluator passes data_range=1.0 explicitly for its [0, 1] paired mels."""
    if data_range is None:
        data_range = 1.0 if a.min() >= 0 else 2.0
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: Optional[float] = None) -> float:
    """Global-window-less SSIM (skimage default: 7x7 uniform windows)."""
    from scipy.ndimage import uniform_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if data_range is None:
        data_range = b.max() - b.min()
    k1, k2, win = 0.01, 0.03, 7
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    mu_a = uniform_filter(a, win)
    mu_b = uniform_filter(b, win)
    # sample (unbiased) covariance normalization as skimage uses
    np_ = win**2
    cov_norm = np_ / (np_ - 1)
    var_a = cov_norm * (uniform_filter(a * a, win) - mu_a**2)
    var_b = cov_norm * (uniform_filter(b * b, win) - mu_b**2)
    cov = cov_norm * (uniform_filter(a * b, win) - mu_a * mu_b)
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def log_spectral_distance(audio1: np.ndarray, audio2: np.ndarray, n_fft: int = 2048,
                          hop: int = 512) -> dict:
    """LSD + STFT-SSIM on a wav pair (ssr_eval.AudioMetrics semantics:
    spectra as |STFT|^2, lsd = mean_t sqrt(mean_f (log10(s1/s2))^2))."""
    from tango_tpu_torch.audio.stft import hann_window_periodic

    def spec(x):
        n_frames = 1 + (len(x) - n_fft) // hop
        if n_frames < 1:
            return None
        idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        w = hann_window_periodic(n_fft)
        return np.abs(np.fft.rfft(x[idx] * w, axis=-1)) ** 2

    s1, s2 = spec(audio1), spec(audio2)
    if s1 is None or s2 is None:
        return {"lsd": float("nan"), "ssim": float("nan")}
    n = min(len(s1), len(s2))
    s1, s2 = np.clip(s1[:n], 1e-8, None), np.clip(s2[:n], 1e-8, None)
    lsd = np.mean(np.sqrt(np.mean((np.log10(s1 / s2)) ** 2, axis=-1)))
    lg1, lg2 = np.log10(s1), np.log10(s2)
    return {"lsd": float(lsd), "ssim": ssim(lg1, lg2)}


# ------------------------------------------------------------------- k-means

def _nearest(x: np.ndarray, centers: np.ndarray):
    """(label of the nearest center, squared distance to it) of each row."""
    d = ((x * x).sum(1)[:, None] - 2.0 * x @ centers.T + (centers * centers).sum(1)[None, :])
    d = np.maximum(d, 0.0)
    labels = d.argmin(1)
    return labels, d[np.arange(len(x)), labels]


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ seeding: each new center is the best, by the
    potential it leaves, of 2 + log(k) candidates drawn in proportion to
    the squared distance to the centers so far."""
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]))
    centers[0] = x[rng.randint(n)]
    closest = ((x - centers[0]) ** 2).sum(1)
    potential = closest.sum()
    for c in range(1, k):
        draws = rng.uniform(size=trials) * potential
        cand = np.minimum(np.searchsorted(np.cumsum(closest), draws), n - 1)
        dist = np.minimum(closest[None, :], ((x[None, :, :] - x[cand][:, None, :]) ** 2).sum(-1))
        best = int(dist.sum(1).argmin())
        closest, potential = dist[best], dist[best].sum()
        centers[c] = x[cand[best]]
    return centers


def kmeans(x: np.ndarray, k: int, rng_seed: int = 0, n_init: int = 3, max_iter: int = 300,
           tol: float = 1e-4) -> np.ndarray:
    """Lloyd's k-means from `n_init` k-means++ seedings drawn from
    RandomState(rng_seed); the (k, D) centers of the run with the lowest
    inertia. A run stops when no label changes or the centers move less, in
    squared norm, than tol times the mean variance of the features; an empty
    cluster keeps its center."""
    x = np.asarray(x, np.float64)
    rng = np.random.RandomState(rng_seed)
    limit = tol * x.var(0).mean()
    best, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = _kmeans_pp(x, k, rng)
        labels = None
        for _ in range(max_iter):
            new_labels, _ = _nearest(x, centers)
            moved = centers.copy()
            for c in range(k):
                members = x[new_labels == c]
                if len(members):
                    moved[c] = members.mean(0)
            shift = ((moved - centers) ** 2).sum()
            same = labels is not None and np.array_equal(labels, new_labels)
            centers, labels = moved, new_labels
            if same or shift <= limit:
                break
        inertia = _nearest(x, centers)[1].sum()
        if inertia < best_inertia:
            best, best_inertia = centers, inertia
    return best


# ----------------------------------------------------------------------- NDB

def calculate_ndb(
    train_features: np.ndarray,
    test_features: np.ndarray,
    number_of_bins: int = 50,
    significance_level: float = 0.05,
    rng_seed: int = 0,
) -> dict:
    """Number of Statistically-Different Bins (reference metrics/ndb.py).

    K-means bins on the reference set (`kmeans` here: sklearn's KMeans with
    n_init=3 in JAX's package, which the port does not use); per-bin two-proportion z-test between
    reference and generated bin frequencies; NDB = #bins where the proportions
    differ significantly. Returns NDB and the JS divergence of bin histograms.
    """
    from scipy.stats import norm

    centers = kmeans(train_features, number_of_bins, rng_seed, n_init=3)
    train_labels = _nearest(train_features, centers)[0]
    test_labels = _nearest(test_features, centers)[0]

    n1, n2 = len(train_labels), len(test_labels)
    p1 = np.bincount(train_labels, minlength=number_of_bins) / n1
    p2 = np.bincount(test_labels, minlength=number_of_bins) / n2

    p_pool = (p1 * n1 + p2 * n2) / (n1 + n2)
    se = np.sqrt(p_pool * (1 - p_pool) * (1 / n1 + 1 / n2))
    z = np.zeros(number_of_bins)
    nz = se > 0
    z[nz] = (p1[nz] - p2[nz]) / se[nz]
    threshold = norm.ppf(1 - significance_level / 2)
    ndb = int(np.sum(np.abs(z) > threshold))

    def _kl(a, b):
        m = a > 0
        return float(np.sum(a[m] * np.log(a[m] / np.maximum(b[m], 1e-12))))

    mix = 0.5 * (p1 + p2)
    js = 0.5 * _kl(p1, mix) + 0.5 * _kl(p2, mix)
    return {
        "ndb": ndb,
        "ndb_over_bins": ndb / number_of_bins,
        "js_divergence": float(js),
        # sorted so they compare across implementations regardless of the
        # k-means bin labeling order (tests/golden/ndb.npz)
        "train_props_sorted": np.sort(p1),
        "query_props_sorted": np.sort(p2),
    }
