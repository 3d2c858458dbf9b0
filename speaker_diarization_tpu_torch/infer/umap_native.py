"""Dependency-free UMAP (Uniform Manifold Approximation and Projection).

The port's own copy of speaker_diarization_tpu/infer/umap_native.py (NumPy only),
unchanged below this paragraph; tests/test_torch_clustering.py holds the
two copies to the same output.

The reference's density pipeline (`egs/alimeeting/umap_cluster/umap_clusterer.py:39-180`)
reduces speaker embeddings with `umap.UMAP(metric="cosine")` before HDBSCAN.
The external package is optional in this framework; this module implements the
UMAP *algorithm itself* (McInnes et al. 2018) so the reference reduction runs
even without it:

  1. exact k-NN graph under the chosen metric (n is a few thousand subsegments
     at most — 1.5 s windows over a meeting — so brute force is fine and
     deterministic);
  2. smooth-kNN calibration: per-point bandwidth sigma_i solved by binary
     search so that sum_j exp(-max(d_ij - rho_i, 0)/sigma_i) = log2(k),
     rho_i = distance to the nearest neighbor (local connectivity 1);
  3. fuzzy simplicial set: symmetrization by the probabilistic t-conorm
     P = P + P^T - P ∘ P^T;
  4. spectral initialization from the symmetric normalized Laplacian of P;
  5. SGD on the fuzzy cross-entropy with negative sampling, using the standard
     low-dimensional similarity 1/(1 + a·d^(2b)) with (a, b) fit from
     min_dist/spread the same way as the reference implementation.

NumPy only; deterministic for a fixed seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["umap_embed", "fit_ab", "smooth_knn", "fuzzy_simplicial_set"]


def _pairwise_dist(X: np.ndarray, metric: str) -> np.ndarray:
    if metric == "cosine":
        Xn = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
        return np.clip(1.0 - Xn @ Xn.T, 0.0, 2.0)
    if metric == "euclidean":
        sq = np.sum(X * X, axis=1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
        return np.sqrt(d2)
    raise ValueError(f"metric {metric!r}")


def fit_ab(min_dist: float = 0.1, spread: float = 1.0) -> tuple[float, float]:
    """Least-squares fit of 1/(1+a·x^(2b)) to the piecewise target curve
    (exactly umap-learn's find_ab_params, with a tiny Gauss-Newton solver
    instead of scipy.optimize.curve_fit)."""
    x = np.linspace(0.0, 3.0 * spread, 300)
    y = np.where(x < min_dist, 1.0, np.exp(-(x - min_dist) / spread))
    a, b = 1.0, 1.0
    for _ in range(200):
        xa = np.maximum(x, 1e-12)
        p = x ** (2.0 * b)
        f = 1.0 / (1.0 + a * p)
        r = y - f
        # partials of f wrt a, b
        da = -p / (1.0 + a * p) ** 2
        db = -2.0 * a * p * np.log(xa) / (1.0 + a * p) ** 2
        J = np.stack([da, db], axis=1)
        g = J.T @ r
        H = J.T @ J + 1e-6 * np.eye(2)
        step = np.linalg.solve(H, g)
        a = float(np.clip(a + step[0], 1e-3, 1e3))
        b = float(np.clip(b + step[1], 1e-3, 1e3))
        if np.linalg.norm(step) < 1e-10:
            break
    return a, b


def smooth_knn(knn_d: np.ndarray, local_connectivity: float = 1.0, n_iter: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (rho, sigma): rho = distance to nearest nonzero neighbor;
    sigma solved so sum_j exp(-(d - rho)+ / sigma) = log2(k)."""
    n, k = knn_d.shape
    target = np.log2(k)
    rho = np.zeros(n)
    sigma = np.ones(n)
    for i in range(n):
        nonzero = knn_d[i][knn_d[i] > 0.0]
        rho[i] = nonzero[min(int(local_connectivity) - 1, len(nonzero) - 1)] if len(nonzero) else 0.0
        lo, hi, mid = 0.0, np.inf, 1.0
        for _ in range(n_iter):
            val = np.exp(-np.maximum(knn_d[i] - rho[i], 0.0) / mid).sum()
            if abs(val - target) < 1e-5:
                break
            if val > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi == np.inf else (lo + hi) / 2.0
        # umap-learn lower-bounds sigma by a fraction of the mean distance
        mean_d = knn_d[i].mean()
        sigma[i] = max(mid, 1e-3 * mean_d) if rho[i] > 0.0 else max(mid, 1e-3 * knn_d.mean())
    return rho, sigma


def fuzzy_simplicial_set(X: np.ndarray, n_neighbors: int, metric: str = "cosine") -> np.ndarray:
    """Symmetric fuzzy graph P (n×n dense; n is small in this pipeline)."""
    n = len(X)
    D = _pairwise_dist(X, metric)
    k = min(n_neighbors, n - 1)
    idx = np.argsort(D, axis=1)[:, 1 : k + 1]  # exclude self
    knn_d = np.take_along_axis(D, idx, axis=1)
    rho, sigma = smooth_knn(knn_d)
    P = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    cols = idx.ravel()
    vals = np.exp(-np.maximum(knn_d - rho[:, None], 0.0) / sigma[:, None]).ravel()
    P[rows, cols] = vals
    return P + P.T - P * P.T  # probabilistic t-conorm


def _spectral_init(P: np.ndarray, n_components: int, seed: int) -> np.ndarray:
    d = np.maximum(P.sum(axis=1), 1e-12)
    Dm = 1.0 / np.sqrt(d)
    L = np.eye(len(P)) - Dm[:, None] * P * Dm[None, :]
    w, v = np.linalg.eigh(L)
    emb = v[:, 1 : n_components + 1]
    # umap-learn scales the init to a max-extent of ~10 and adds tiny noise
    emb = 10.0 * emb / np.maximum(np.abs(emb).max(), 1e-12)
    rng = np.random.default_rng(seed)
    return emb + rng.normal(scale=1e-4, size=emb.shape)


def umap_embed(
    X: np.ndarray,
    n_components: int = 8,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    metric: str = "cosine",
    n_epochs: int = 300,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """UMAP embedding of X (n, D) → (n, n_components)."""
    X = np.asarray(X, np.float64)
    n = len(X)
    if n <= n_components + 1:
        return _pairwise_dist(X, metric)[:, : max(n_components, 1)].copy()
    P = fuzzy_simplicial_set(X, n_neighbors, metric)
    emb = _spectral_init(P, n_components, seed).astype(np.float64)
    a, b = fit_ab(min_dist)
    rng = np.random.default_rng(seed)

    # edge list with epochs-per-sample weighting (umap-learn's schedule:
    # stronger edges are updated more often)
    r, c = np.nonzero(np.triu(P, 1))
    w = P[r, c]
    keep = w > w.max() / float(n_epochs)
    r, c, w = r[keep], c[keep], w[keep]
    epochs_per_sample = w.max() / w
    next_epoch = epochs_per_sample.copy()

    clip = 4.0
    for epoch in range(1, n_epochs + 1):
        alpha = learning_rate * (1.0 - epoch / float(n_epochs))
        active = np.nonzero(next_epoch <= epoch)[0]
        if len(active) == 0:
            continue
        for e in active:
            i, j = int(r[e]), int(c[e])
            diff = emb[i] - emb[j]
            d2 = float(diff @ diff)
            if d2 > 0.0:
                grad_coeff = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2**b)
                g = np.clip(grad_coeff * diff, -clip, clip)
                emb[i] += alpha * g
                emb[j] -= alpha * g
            # negative samples repel i
            for t in rng.integers(0, n, negative_sample_rate):
                t = int(t)
                if t == i:
                    continue
                diff = emb[i] - emb[t]
                d2 = float(diff @ diff)
                grad_coeff = (2.0 * b) / ((0.001 + d2) * (1.0 + a * d2**b))
                g = np.clip(grad_coeff * diff, -clip, clip)
                emb[i] += alpha * g
            next_epoch[e] += epochs_per_sample[e]
    return emb
