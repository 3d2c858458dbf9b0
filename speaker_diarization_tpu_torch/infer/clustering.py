"""Clustering-based diarization pipelines (spectral, UMAP + HDBSCAN, VBx).

Counterpart of speaker_diarization_tpu/infer/clustering.py (reference
`egs/alimeeting/spectral_cluster/`: SAD segments → 1.5 s / 0.75 s
subsegment embeddings → cosine similarity → p-prune → unnormalized
Laplacian → eigengap speaker-count estimate → k-means on the first-k
eigenvectors, spectral_clusterer.py:35-90; and `egs/alimeeting/umap_cluster/`:
UMAP + HDBSCAN + agglomerative merge). NumPy and SciPy on the host; the
embeddings upstream come from the card. The functions are the JAX module's,
line for line, except two:

- `kmeans` replaces `sklearn.cluster.k_means(feats, k, n_init=10,
  random_state=0)`: the GPU hosts have no scikit-learn. It follows
  scikit-learn's algorithm: greedy k-means++ seeding with 2 + ⌊ln k⌋ local
  trials, Lloyd iterations (empty clusters take the points farthest from
  their centres) up to 300, stopping when the labels repeat or the squared
  centre shift is within 1e-4 × the mean per-feature variance, 10 seeded
  inits from RandomState(0) keeping the least inertia;
- `density_cluster` calls the port's UMAP and HDBSCAN* (`umap_native`,
  `hdbscan_native`), which is what the JAX module runs when the optional
  `umap` and `hdbscan` packages are absent, as they are on the GPU hosts.

`spectral_cluster` has no counterpart of the JAX module's `use_jax` flag
(an eigendecomposition on the accelerator): nothing in either package sets
it, so the port keeps only the SciPy path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..data.rttm import Turn

# ---------------------------------------------------------------------------
# Spectral clustering core (reference-parity)
# ---------------------------------------------------------------------------


def cosine_similarity_matrix(M: np.ndarray) -> np.ndarray:
    M = M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-12)
    return 0.5 * (1.0 + M @ M.T)


def prune_similarity(M: np.ndarray, p: float = 0.01) -> np.ndarray:
    """Per-row binarization: top (p·m or 10) neighbors → 1, rest → 0, then
    symmetrize (reference prune(), including the m<1000 special case)."""
    M = M.copy()
    m = M.shape[0]
    n = max(m - 10, 2) if m < 1000 else int((1.0 - p) * m)
    order = np.argsort(M, axis=1)
    rows = np.arange(m)[:, None]
    M[rows, order[:, :n]] = 0.0
    M[rows, order[:, n:]] = 1.0
    return 0.5 * (M + M.T)


def unnormalized_laplacian(M: np.ndarray) -> np.ndarray:
    M = M.copy()
    np.fill_diagonal(M, 0.0)
    return np.diag(np.sum(np.abs(M), axis=1)) - M


def eigengap_num_speakers(eig_values: np.ndarray, max_num_spks: int) -> int:
    return int(np.argmax(np.diff(eig_values[: max_num_spks + 1]))) + 1


def _sq_dists(A: np.ndarray, X: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """Squared euclidean distances (len(A), len(X)), clipped at 0."""
    d = -2.0 * (A @ X.T) + (A * A).sum(1)[:, None] + x_sq[None, :]
    return np.maximum(d, 0.0)


def _kmeans_plusplus(X: np.ndarray, k: int, x_sq: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ seeding: each new centre is the best of
    2 + ⌊ln k⌋ candidates drawn in proportion to the squared distance."""
    n = len(X)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]), X.dtype)
    centers[0] = X[rs.choice(n, p=np.full(n, 1.0 / n))]
    closest = _sq_dists(centers[:1], X, x_sq)
    pot = closest.sum()
    for c in range(1, k):
        cand = np.searchsorted(np.cumsum(closest), rs.uniform(size=trials) * pot)
        np.clip(cand, None, n - 1, out=cand)
        d = np.minimum(closest, _sq_dists(X[cand], X, x_sq))
        pots = d.sum(1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], d[best : best + 1]
        centers[c] = X[cand[best]]
    return centers


def _lloyd_step(X: np.ndarray, centers: np.ndarray, x_sq: np.ndarray):
    """One E and M step → (labels, new centres); an empty cluster takes the
    point farthest from its centre, which leaves its old cluster."""
    k = len(centers)
    labels = np.argmin(-2.0 * (X @ centers.T) + (centers * centers).sum(1)[None, :], axis=1)
    onehot = np.eye(k, dtype=X.dtype)[labels]
    sums = onehot.T @ X
    counts = onehot.sum(0)
    empty = np.nonzero(counts == 0)[0]
    if len(empty):
        far = np.argsort(-((X - centers[labels]) ** 2).sum(1), kind="stable")[: len(empty)]
        for e, i in zip(empty, far):
            sums[labels[i]] -= X[i]
            counts[labels[i]] -= 1.0
            sums[e], counts[e] = X[i], 1.0
    new = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None], 0.0)
    return labels, new


def _same_partition(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    mapping = np.full(k, -1)
    for x, y in zip(a, b):
        if mapping[x] == -1:
            mapping[x] = y
        elif mapping[x] != y:
            return False
    return True


def kmeans(X: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """(n, d) features → (centres (k, d), labels (n,) int32, inertia):
    scikit-learn's `k_means(X, k, n_init=10, random_state=0)` (max_iter
    300, tol 1e-4; module docstring) in NumPy."""
    X = np.asarray(X, np.float64)
    rs = np.random.RandomState(0)
    tol = float(np.mean(np.var(X, axis=0))) * 1e-4
    mean = X.mean(axis=0)
    Xc = X - mean
    x_sq = (Xc * Xc).sum(1)
    best = None
    for _ in range(10):
        centers = _kmeans_plusplus(Xc, k, x_sq, rs)
        labels_old = np.full(len(Xc), -1)
        converged = False
        for _ in range(300):
            labels, new = _lloyd_step(Xc, centers, x_sq)
            shift = ((new - centers) ** 2).sum()
            centers = new
            if np.array_equal(labels, labels_old):
                converged = True
                break
            if shift <= tol:
                break
            labels_old = labels
        if not converged:  # labels that match the final centres
            labels = np.argmin(-2.0 * (Xc @ centers.T) + (centers * centers).sum(1)[None, :], axis=1)
        inertia = float(((Xc - centers[labels]) ** 2).sum())
        if best is None or (inertia < best[2] and not _same_partition(labels, best[1], k)):
            best = (centers, labels, inertia)
    return best[0] + mean, best[1].astype(np.int32), best[2]


def spectral_cluster(
    embeddings: np.ndarray,
    p: float = 0.01,
    num_spks: Optional[int] = None,
    min_num_spks: int = 1,
    max_num_spks: int = 20,
) -> np.ndarray:
    """Subsegment embeddings (n, D) → integer cluster labels (n,)."""
    n = len(embeddings)
    if n <= 2:
        return np.zeros(n, dtype=np.int32)
    S = cosine_similarity_matrix(np.asarray(embeddings, np.float64))
    S = prune_similarity(S, p)
    L = unnormalized_laplacian(S)
    import scipy.linalg

    w, v = scipy.linalg.eigh(L)
    k = num_spks if num_spks is not None else eigengap_num_speakers(w, max_num_spks)
    k = max(k, min_num_spks)
    _, labels, _ = kmeans(v[:, :k], k)
    return labels


# ---------------------------------------------------------------------------
# Density clustering (UMAP + HDBSCAN*)
# ---------------------------------------------------------------------------


def pahc_merge(
    embeddings: np.ndarray,
    labels: np.ndarray,
    merge_threshold: float = 0.6,
    min_cluster_frac: float = 0.1,
) -> np.ndarray:
    """Post-AHC cluster refinement (reference umap_clusterer.py PAHC):
    merge clusters whose centroid cosine similarity exceeds the threshold,
    then absorb clusters smaller than min_cluster_frac of the largest into
    their nearest surviving cluster."""
    labels = np.asarray(labels, np.int32).copy()
    X = np.asarray(embeddings, np.float64)
    Xn = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)

    def centroids():
        out = {}
        for c in np.unique(labels):
            v = Xn[labels == c].mean(axis=0)
            out[c] = v / max(np.linalg.norm(v), 1e-12)
        return out

    # merge phase
    changed = True
    while changed:
        changed = False
        cents = centroids()
        keys = sorted(cents)
        best = None
        for i in range(len(keys)):
            for j in range(i + 1, len(keys)):
                sim = float(cents[keys[i]] @ cents[keys[j]])
                if sim > merge_threshold and (best is None or sim > best[0]):
                    best = (sim, keys[i], keys[j])
        if best is not None:
            labels[labels == best[2]] = best[1]
            changed = True
    # absorb phase
    cents = centroids()
    sizes = {c: int((labels == c).sum()) for c in cents}
    if sizes:
        largest = max(sizes.values())
        small = [c for c, n in sizes.items() if n < min_cluster_frac * largest]
        big = [c for c in cents if c not in small]
        if big:
            for c in small:
                tgt = max(big, key=lambda b: float(cents[c] @ cents[b]))
                labels[labels == c] = tgt
    # relabel densely
    remap = {c: i for i, c in enumerate(sorted(np.unique(labels)))}
    return np.asarray([remap[c] for c in labels], np.int32)


def density_cluster(
    embeddings: np.ndarray,
    n_components: int = 8,
    min_cluster_size: int = 4,
    seed: int = 0,
) -> np.ndarray:
    """UMAP → HDBSCAN* (reference umap_clusterer.py:39-180); outliers (-1)
    are reassigned to the nearest cluster centroid."""
    from .hdbscan_native import hdbscan_cluster
    from .umap_native import umap_embed

    X = np.asarray(embeddings, np.float64)
    n = len(X)
    if n <= 2:
        return np.zeros(n, dtype=np.int32)
    Z = umap_embed(X, n_components=min(n_components, n - 2), metric="cosine", seed=seed)
    labels = np.asarray(hdbscan_cluster(Z, min_cluster_size=min_cluster_size), np.int32)
    if (labels >= 0).any():
        cents = {c: Z[labels == c].mean(0) for c in np.unique(labels[labels >= 0])}
        for i in np.nonzero(labels < 0)[0]:
            labels[i] = min(cents, key=lambda c: np.linalg.norm(Z[i] - cents[c]))
    else:
        labels[:] = 0
    return labels


# ---------------------------------------------------------------------------
# SAD (speech activity detection)
# ---------------------------------------------------------------------------


def oracle_sad(turns: Sequence[Turn]) -> List[Tuple[float, float]]:
    """Union of reference speech regions (make_oracle_sad semantics)."""
    ivs = sorted((t.start, t.end) for t in turns if t.dur > 0)
    if not ivs:
        return []
    out = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= out[-1][1] + 1e-9:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def energy_vad(
    audio: np.ndarray,
    rate: int,
    frame_ms: float = 25.0,
    hop_ms: float = 10.0,
    threshold_db: float = -40.0,
    min_speech_s: float = 0.3,
    min_silence_s: float = 0.3,
) -> List[Tuple[float, float]]:
    """Simple energy-based system SAD (stands in for silero-vad; the
    reference runs silero ONNX on host, make_system_sad.py:32-57)."""
    from ..postproc.rttm_gen import hysteresis_smooth

    win = int(rate * frame_ms / 1000)
    hop = int(rate * hop_ms / 1000)
    if len(audio) < win:
        return []
    n = 1 + (len(audio) - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(n)[:, None]
    frames = audio[idx]
    db = 10 * np.log10(np.mean(frames**2, axis=1) + 1e-12)
    ref = np.percentile(db, 95)
    active = db > max(ref + threshold_db, -60.0)
    # hysteresis in frames
    min_sp = int(min_speech_s * 1000 / hop_ms)
    min_si = int(min_silence_s * 1000 / hop_ms)
    sm = hysteresis_smooth(active.astype(np.int8), fill_gap=min_si, min_dur=min_sp)
    out = []
    d = np.diff(sm, prepend=0, append=0)
    for s, e in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
        out.append((s * hop_ms / 1000, (e * hop_ms / 1000) + (frame_ms - hop_ms) / 1000))
    return out


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SubSegment:
    start: float
    end: float


def make_subsegments(
    sad: Sequence[Tuple[float, float]],
    window_s: float = 1.5,
    hop_s: float = 0.75,
    min_dur_s: float = 0.2,
) -> List[SubSegment]:
    """SAD regions → sliding subsegments (reference 1.5 s / 0.75 s)."""
    out = []
    for s, e in sad:
        if e - s < min_dur_s:
            continue
        if e - s <= window_s:
            out.append(SubSegment(s, e))
            continue
        t = s
        while t + window_s <= e + 1e-9:
            out.append(SubSegment(t, t + window_s))
            t += hop_s
        if out[-1].end < e - 1e-6:
            out.append(SubSegment(e - window_s, e))
    return out


def cluster_recording(
    audio: np.ndarray,
    rate: int,
    embed_fn: Callable[[np.ndarray], np.ndarray],
    rec: str,
    sad: Optional[Sequence[Tuple[float, float]]] = None,
    method: str = "spectral",
    num_spks: Optional[int] = None,
    max_num_spks: int = 20,
    window_s: float = 1.5,
    hop_s: float = 0.75,
    batch_size: int = 64,
    plda=None,
    vbx_loop_prob: float = 0.9,
    vbx_fa: float = 0.4,
    vbx_fb: float = 17.0,
) -> List[Turn]:
    """One recording → clustered speaker turns.

    embed_fn: (B, window_samples) float32 → (B, D). SAD defaults to energy
    VAD. Adjacent same-label subsegments are merged into turns.

    method="vbx": spectral initialization refined by Bayesian-HMM VBx
    resegmentation over the PLDA-transformed embedding sequence (diarizen's
    default clustering, egs/magicdata-ramc/eend_vc/clustering/VBx.py);
    requires `plda` (infer.vbx.Plda, see `estimate-plda`).
    """
    if sad is None:
        sad = energy_vad(audio, rate)
    subs = make_subsegments(sad, window_s, hop_s)
    if not subs:
        return []
    win = int(window_s * rate)
    wavs = []
    for ss in subs:
        seg = audio[int(ss.start * rate) : int(ss.end * rate)]
        if len(seg) < win:
            seg = np.pad(seg, (0, win - len(seg)))
        wavs.append(seg[:win])
    embs = []
    for i in range(0, len(wavs), batch_size):
        b = np.stack(wavs[i : i + batch_size]).astype(np.float32)
        embs.append(np.asarray(embed_fn(b)))
    embs = np.concatenate(embs, axis=0)

    if method == "spectral":
        labels = spectral_cluster(embs, num_spks=num_spks, max_num_spks=max_num_spks)
    elif method == "umap":
        labels = pahc_merge(embs, density_cluster(embs))
    elif method == "vbx":
        if plda is None:
            raise ValueError("method='vbx' requires a PLDA (run estimate-plda)")
        from .vbx import vbx_resegment

        init = spectral_cluster(embs, num_spks=num_spks, max_num_spks=max_num_spks)
        labels, _res = vbx_resegment(embs, init, plda, loop_prob=vbx_loop_prob, fa=vbx_fa, fb=vbx_fb)
    else:
        raise ValueError(method)

    # merge adjacent same-label subsegments (reference make_rttm.py)
    turns: List[Turn] = []
    cur_label, cur_start, cur_end = None, 0.0, 0.0
    for ss, lb in zip(subs, labels):
        if cur_label is not None and lb == cur_label and ss.start <= cur_end + 1e-6:
            cur_end = max(cur_end, ss.end)
        else:
            if cur_label is not None:
                turns.append(Turn(rec, cur_start, cur_end - cur_start, f"spk{cur_label:02d}"))
            cur_label, cur_start, cur_end = lb, ss.start, ss.end
    if cur_label is not None:
        turns.append(Turn(rec, cur_start, cur_end - cur_start, f"spk{cur_label:02d}"))
    return turns
