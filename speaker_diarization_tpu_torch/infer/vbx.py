"""VBx: Bayesian HMM resegmentation of embedding sequences.

The port's own copy of speaker_diarization_tpu/infer/vbx.py (NumPy and SciPy only),
unchanged below this paragraph; tests/test_torch_clustering.py holds the
two copies to the same output.

Reference: the VBx clustering stage vendored in the reference's DiariZen
pipelines (`egs/mlc_slm/dicow/diarizen/clustering/VBx.py`, used by
`diarizen/pipelines/inference.py` as the default clustering method), after
Diez/Landini/Burget: "Bayesian HMM clustering of x-vector sequences".

Model: x_t = V·z_{s_t} + ε with ε ~ N(0, I) (within-class identity) and
z ~ N(0, I), V = diag(√φ) — i.e. zero-mean PLDA with diagonal
between-class covariance φ in a space where the within-class covariance is
identity. Speaker sequence s_t follows an HMM with self-loop probability
`loop_prob` and speaker priors π. Variational inference alternates speaker
posterior moments with per-frame responsibilities from a forward-backward
pass; redundant speakers collapse as their priors go to zero.

`estimate_plda` learns the whitening + diagonalizing transform from any
labeled embedding set (the reference ships pretrained PLDA npz files;
zero egress here, so the transform is estimated from data instead —
the same two-covariance model).

Host-side numpy: T is a few hundred subsegments per recording; the
embedding extraction upstream is the TPU-heavy part.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _logsumexp(a, axis=None, keepdims=False):
    m = np.max(a, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True)) + m
    return out if keepdims else np.squeeze(out, axis=axis)


def forward_backward_log(log_p: np.ndarray, log_tr: np.ndarray, log_pi: np.ndarray):
    """HMM smoothing in the log domain.

    log_p: (T, S) frame log-likelihoods; log_tr: (S, S) transition
    log-probs (row → col); log_pi: (S,) initial log-priors.
    Returns (gamma (T,S), total log-likelihood, log_alpha, log_beta).
    """
    T, S = log_p.shape
    la = np.empty((T, S))
    lb = np.empty((T, S))
    la[0] = log_pi + log_p[0]
    for t in range(1, T):
        la[t] = log_p[t] + _logsumexp(la[t - 1][:, None] + log_tr, axis=0)
    lb[-1] = 0.0
    for t in range(T - 2, -1, -1):
        lb[t] = _logsumexp(log_tr + (log_p[t + 1] + lb[t + 1])[None, :], axis=1)
    ll = _logsumexp(la[-1], axis=0)
    gamma = np.exp(la + lb - ll)
    return gamma, float(ll), la, lb


@dataclass
class VbxResult:
    gamma: np.ndarray  # (T, S) responsibilities
    pi: np.ndarray  # (S,) speaker priors
    elbos: list
    labels: np.ndarray  # (T,) argmax speaker per frame


def vbx(
    X: np.ndarray,
    phi: np.ndarray,
    loop_prob: float = 0.9,
    fa: float = 1.0,
    fb: float = 1.0,
    max_speakers: int = 10,
    gamma_init: Optional[np.ndarray] = None,
    max_iters: int = 10,
    epsilon: float = 1e-4,
    seed: int = 0,
) -> VbxResult:
    """VB inference for the Bayesian HMM over precomputed embeddings.

    X: (T, D) embeddings already mapped to the PLDA-whitened space;
    phi: (D,) between-class variances in that space.
    """
    T, D = X.shape
    pi = np.ones(max_speakers) / max_speakers
    if gamma_init is None:
        rng = np.random.default_rng(seed)
        g = rng.gamma(1.0, size=(T, max_speakers))
        gamma = g / g.sum(1, keepdims=True)
    else:
        gamma = np.asarray(gamma_init, float)
        assert gamma.shape == (T, max_speakers)

    const = -0.5 * (np.sum(X**2, axis=1, keepdims=True) + D * np.log(2 * np.pi))
    rho = X * np.sqrt(phi)[None, :]
    elbos: list = []
    for it in range(max_iters):
        # speaker posterior moments: q(z_s) = N(a_s, diag(l_s))
        n_s = gamma.sum(axis=0)[:, None]  # (S, 1) soft counts
        l_s = 1.0 / (1.0 + (fa / fb) * n_s * phi[None, :])  # (S, D)
        a_s = (fa / fb) * l_s * (gamma.T @ rho)  # (S, D)
        # expected frame log-likelihoods per speaker
        log_p = fa * (rho @ a_s.T - 0.5 * ((l_s + a_s**2) @ phi) + const)  # (T, S)

        tr = np.eye(max_speakers) * loop_prob + (1.0 - loop_prob) * pi[None, :]
        with np.errstate(divide="ignore"):
            gamma, ll, la, lb = forward_backward_log(log_p, np.log(tr + 1e-30), np.log(pi + 1e-30))
        # prior update from expected initial + switch counts
        switch = np.exp(
            _logsumexp(la[:-1], axis=1, keepdims=True) + log_p[1:] + lb[1:] - ll
        )  # (T-1, S): marginal of being in s at t arriving via a switch, up to (1-loop)·pi factor
        pi = gamma[0] + (1.0 - loop_prob) * pi * switch.sum(axis=0)
        pi = pi / pi.sum()

        elbo = ll + fb * 0.5 * np.sum(np.log(l_s) - l_s - a_s**2 + 1.0)
        elbos.append(elbo)
        if it > 0 and elbo - elbos[-2] < epsilon:
            break
    return VbxResult(gamma=gamma, pi=pi, elbos=elbos, labels=gamma.argmax(axis=1))


@dataclass
class Plda:
    mu: np.ndarray  # (D,) global mean
    tr: np.ndarray  # (D', D) transform to the whitened/diagonalized space
    psi: np.ndarray  # (D',) between-class variances, descending

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mu) @ self.tr.T


def estimate_plda(embs: np.ndarray, labels: np.ndarray, dim: Optional[int] = None) -> Plda:
    """Two-covariance PLDA from labeled embeddings: solve the generalized
    eigenproblem B v = λ W v so the transformed space has identity
    within-class and diagonal (ψ) between-class covariance."""
    from scipy.linalg import eigh

    embs = np.asarray(embs, float)
    labels = np.asarray(labels)
    mu = embs.mean(axis=0)
    Xc = embs - mu
    classes = np.unique(labels)
    D = embs.shape[1]
    W = np.zeros((D, D))
    B = np.zeros((D, D))
    for c in classes:
        xc = Xc[labels == c]
        m = xc.mean(axis=0)
        W += (xc - m).T @ (xc - m)
        B += len(xc) * np.outer(m, m)
    W /= len(embs)
    B /= len(embs)
    W += 1e-6 * np.eye(D)
    psi, V = eigh(B, W)  # ascending; V normalized s.t. Vᵀ W V = I
    order = np.argsort(psi)[::-1]
    psi = np.maximum(psi[order], 1e-8)
    tr = V[:, order].T  # rows are eigvecs; x' = tr @ (x - mu)
    if dim is not None:
        tr, psi = tr[:dim], psi[:dim]
    return Plda(mu=mu, tr=tr, psi=psi)


def vbx_resegment(
    embs: np.ndarray,
    init_labels: np.ndarray,
    plda: Plda,
    loop_prob: float = 0.9,
    fa: float = 0.4,
    fb: float = 17.0,
    max_iters: int = 20,
    init_smoothing: float = 7.0,
) -> Tuple[np.ndarray, VbxResult]:
    """Refine an initial clustering (e.g. AHC) with VBx
    (diarizen cluster_vbx semantics: one-hot init softened by
    `init_smoothing` softmax). Returns (labels, full result)."""
    init_labels = np.asarray(init_labels, int)
    S = int(init_labels.max()) + 1
    onehot = np.zeros((len(init_labels), S))
    onehot[np.arange(len(init_labels)), init_labels] = 1.0
    if init_smoothing >= 0:
        z = onehot * init_smoothing
        gamma0 = np.exp(z - _logsumexp(z, axis=1, keepdims=True))
    else:
        gamma0 = onehot
    X = plda.transform(embs)
    res = vbx(
        X, plda.psi, loop_prob=loop_prob, fa=fa, fb=fb,
        max_speakers=S, gamma_init=gamma0, max_iters=max_iters,
    )
    return res.labels, res


def save_plda(path: str, plda: Plda) -> None:
    """Persist a PLDA transform (mu/tr/psi) as npz."""
    import os

    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, mu=plda.mu, tr=plda.tr, psi=plda.psi)


def load_plda(path: str) -> Plda:
    z = np.load(path)
    return Plda(mu=z["mu"], tr=z["tr"], psi=z["psi"])
