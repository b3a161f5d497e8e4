"""Synthetic SVM dataset family (numpy only; a copy of repro.data.synthetic).

Analogues of the paper's Table 1 regimes, with controllable size/geometry:
  blobs        — separable Gaussian clusters (a8a/a9a-like difficulty knob)
  circles      — concentric spheres (nonlinear boundary; small-h kernels,
                 the regime where low-rank Nyström fails and HSS wins)
  checkerboard — alternating grid (hard, many support vectors, ijcnn1-like)
  susy_like    — low-dim physics-ish mixture (8-18 features, millions of
                 rows possible — the paper's largest regime)
"""
from __future__ import annotations

import numpy as np


def blobs(n: int, n_features: int = 8, sep: float = 2.0, seed: int = 0):
    r = np.random.default_rng(seed)
    half = n // 2
    mu = np.zeros(n_features)
    mu[0] = sep
    xa = r.normal(size=(half, n_features)) + mu
    xb = r.normal(size=(n - half, n_features)) - mu
    x = np.concatenate([xa, xb]).astype(np.float32)
    y = np.concatenate([np.ones(half), -np.ones(n - half)]).astype(np.float32)
    p = r.permutation(n)
    return x[p], y[p]


def circles(n: int, n_features: int = 4, gap: float = 1.0, noise: float = 0.15,
            seed: int = 0):
    r = np.random.default_rng(seed)
    half = n // 2
    u = r.normal(size=(n, n_features))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radii = np.concatenate([np.ones(half), np.full(n - half, 1.0 + gap)])
    x = (u * radii[:, None] + noise * r.normal(size=u.shape)).astype(np.float32)
    y = np.concatenate([np.ones(half), -np.ones(n - half)]).astype(np.float32)
    p = r.permutation(n)
    return x[p], y[p]


def checkerboard(n: int, cells: int = 4, n_features: int = 2, seed: int = 0):
    r = np.random.default_rng(seed)
    x = r.uniform(0, cells, size=(n, n_features)).astype(np.float32)
    parity = np.sum(np.floor(x[:, :2]), axis=1) % 2
    y = (parity * 2 - 1).astype(np.float32)
    return x, y


def susy_like(n: int, n_features: int = 18, seed: int = 0):
    """Low-dimensional mixture with partially overlapping classes."""
    r = np.random.default_rng(seed)
    half = n // 2
    # signal: correlated features; background: broader, shifted
    cov = 0.6 * np.eye(n_features) + 0.4
    la = np.linalg.cholesky(cov)
    xa = r.normal(size=(half, n_features)) @ la.T
    xb = 1.4 * r.normal(size=(n - half, n_features)) + 0.8
    x = np.concatenate([xa, xb]).astype(np.float32)
    y = np.concatenate([np.ones(half), -np.ones(n - half)]).astype(np.float32)
    p = r.permutation(n)
    return x[p], y[p]


def multiclass_blobs(n: int, n_classes: int = 4, n_features: int = 8,
                     sep: float = 3.0, seed: int = 0):
    """k Gaussian clusters on a simplex-ish layout; labels are 0..k-1 ints.

    The one-vs-rest workhorse: every class is compact, so each binary
    subproblem is blobs-vs-rest difficulty (controlled by ``sep``).
    """
    r = np.random.default_rng(seed)
    centers = r.normal(size=(n_classes, n_features))
    centers *= sep / np.maximum(
        np.linalg.norm(centers, axis=1, keepdims=True), 1e-9)
    counts = np.full(n_classes, n // n_classes)
    counts[: n - counts.sum()] += 1
    xs, ys = [], []
    for c in range(n_classes):
        xs.append(r.normal(size=(counts[c], n_features)) + centers[c])
        ys.append(np.full(counts[c], c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    p = r.permutation(n)
    return x[p], y[p]


def spirals(n: int, n_classes: int = 3, n_features: int = 2,
            turns: float = 1.25, noise: float = 0.08, seed: int = 0):
    """k interleaved 2-D spiral arms (embedded in n_features dims).

    Strongly nonlinear boundaries between EVERY pair of classes — the regime
    where a global low-rank kernel approximation fails but HSS keeps the
    near-field exact.  Labels are 0..k-1 ints.
    """
    r = np.random.default_rng(seed)
    counts = np.full(n_classes, n // n_classes)
    counts[: n - counts.sum()] += 1
    xs, ys = [], []
    for c in range(n_classes):
        t = np.sqrt(r.uniform(0.05, 1.0, size=counts[c]))
        ang = 2 * np.pi * (turns * t + c / n_classes)
        arm = np.stack([t * np.cos(ang), t * np.sin(ang)], axis=1)
        arm += noise * r.normal(size=arm.shape)
        if n_features > 2:
            extra = 0.05 * r.normal(size=(counts[c], n_features - 2))
            arm = np.concatenate([arm, extra], axis=1)
        xs.append(arm)
        ys.append(np.full(counts[c], c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    p = r.permutation(n)
    return x[p], y[p]


def noisy_sine(n: int, n_features: int = 2, freq: float = 1.5,
               noise: float = 0.1, seed: int = 0):
    """Regression targets y = sin(freq·x₀) + ½·cos(freq·x₁) + noise.

    The ε-SVR workhorse: a smooth low-dimensional response over uniformly
    scattered points — the regime where the Gaussian-kernel HSS compression
    is near-exact and the ε tube directly controls the SV count.
    """
    r = np.random.default_rng(seed)
    x = r.uniform(-np.pi, np.pi, size=(n, n_features)).astype(np.float32)
    y = np.sin(freq * x[:, 0])
    if n_features > 1:
        y = y + 0.5 * np.cos(freq * x[:, 1])
    y = (y + noise * r.normal(size=n)).astype(np.float32)
    return x, y


def noisy_step(n: int, n_features: int = 2, levels: int = 4,
               noise: float = 0.05, seed: int = 0):
    """Regression targets: a staircase of ``levels`` flat plateaus + noise.

    Discontinuous response — hard for a smooth kernel, so it exercises the
    bias fallbacks and the ε/RMSE trade-off away from the easy-sine regime.
    """
    r = np.random.default_rng(seed)
    x = r.uniform(0.0, 1.0, size=(n, n_features)).astype(np.float32)
    y = np.floor(x[:, 0] * levels) / max(levels - 1, 1)
    y = (y + noise * r.normal(size=n)).astype(np.float32)
    return x, y


def blobs_with_outliers(n: int, n_features: int = 4, outlier_frac: float = 0.1,
                        spread: float = 6.0, seed: int = 0):
    """One-class novelty-detection set: a Gaussian inlier blob (y = +1) plus
    a uniform shell of far-away outliers (y = −1, fraction ``outlier_frac``).

    Training a one-class SVM uses x only; y is the held-out ground truth for
    precision/recall scoring.
    """
    r = np.random.default_rng(seed)
    n_out = max(int(n * outlier_frac), 1)
    n_in = n - n_out
    x_in = r.normal(size=(n_in, n_features))
    u = r.normal(size=(n_out, n_features))
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-9)
    radii = r.uniform(0.6 * spread, spread, size=(n_out, 1))
    x_out = u * radii + 0.3 * r.normal(size=(n_out, n_features))
    x = np.concatenate([x_in, x_out]).astype(np.float32)
    y = np.concatenate([np.ones(n_in), -np.ones(n_out)]).astype(np.float32)
    p = r.permutation(n)
    return x[p], y[p]


DATASETS = {
    "blobs": blobs,
    "circles": circles,
    "checkerboard": checkerboard,
    "susy_like": susy_like,
}

MULTICLASS_DATASETS = {
    "multiclass_blobs": multiclass_blobs,
    "spirals": spirals,
}

REGRESSION_DATASETS = {
    "noisy_sine": noisy_sine,
    "noisy_step": noisy_step,
}

ONECLASS_DATASETS = {
    "blobs_with_outliers": blobs_with_outliers,
}


def train_test(name: str, n_train: int, n_test: int, seed: int = 0, **kw):
    gen = (DATASETS.get(name) or MULTICLASS_DATASETS.get(name)
           or REGRESSION_DATASETS.get(name) or ONECLASS_DATASETS[name])
    x, y = gen(n_train + n_test, seed=seed, **kw)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]
