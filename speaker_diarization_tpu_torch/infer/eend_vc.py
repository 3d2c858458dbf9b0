"""EEND-VC inference: chunk posteriors + speaker vectors → constrained AHC →
stitched whole-recording diarization.

A copy of speaker_diarization_tpu/infer/eend_vc.py (NumPy and SciPy only),
except `constrained_ahc`, which is written on scipy.cluster.hierarchy: the
JAX module uses scikit-learn's AgglomerativeClustering, and the GPU hosts
this package runs on have no scikit-learn. Reference
`eend_vector_cluster/infer_vector_cluster.py:29-189` —
1. per chunk, channels with mean activity ≤ sil_spk_th are "silent";
2. cannot-link pairs between co-active channels of the same chunk;
3. AHC (average linkage, euclidean, precomputed distances with cannot-link
   pairs forced to a large distance) over all non-silent chunk vectors —
   either to an oracle cluster count or a distance threshold;
4. same-label channels within a chunk are merged (max activity);
5. chunk activities are stitched into global per-cluster tracks.
`make_eend_vc_predict` wraps a model as the per-chunk predictor.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def constrained_ahc(
    vectors: np.ndarray,
    cannot_links: List[Tuple[int, int]],
    n_clusters: Optional[int] = None,
    dist_threshold: float = 1.0,
    clink_dist: float = 1e4,
) -> np.ndarray:
    """Average-linkage AHC on euclidean distances with cannot-link pairs →
    labels from 0.

    The same partitions as sklearn's AgglomerativeClustering(metric=
    "precomputed", linkage="average") that the JAX module calls; only the
    label numbers differ. With `n_clusters` the merges stop at that many
    clusters (at most n); else at 1 + the number of merge heights ≥
    dist_threshold, which is how sklearn turns `distance_threshold` into a
    cluster count (it merges only below the threshold). `cut_tree` undoes
    the last merges one by one, so tied heights (cannot-link pairs all at
    clink_dist) still give exactly that count, as sklearn does.
    """
    n = len(vectors)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    from scipy.cluster.hierarchy import cut_tree, linkage
    from scipy.spatial import distance

    D = distance.cdist(vectors, vectors, metric="euclidean")
    for a, b in cannot_links:
        D[a, b] = D[b, a] = clink_dist
    Z = linkage(distance.squareform(D, checks=False), method="average")
    k = min(n_clusters, n) if n_clusters is not None else 1 + int(np.sum(Z[:, 2] >= dist_threshold))
    return cut_tree(Z, n_clusters=k)[:, 0].astype(np.int32)


def cluster_chunk_vectors(
    actis: List[np.ndarray],
    svecs: List[np.ndarray],
    n_clusters: Optional[int] = None,
    sil_spk_th: float = 0.05,
    dist_threshold: float = 1.0,
) -> Tuple[np.ndarray, int]:
    """(per-chunk activities (T,S), vectors (S,D)) → per-chunk channel labels.

    Returns (labels (n_chunks, S) with value n_clusters meaning silence,
    n_clusters).
    """
    n_chunks = len(actis)
    S = actis[0].shape[1] if n_chunks else 0
    flat_idx = []  # (chunk, channel) of non-silent entries
    vecs = []
    mean_acti = np.array([a.mean(axis=0) for a in actis])  # (n_chunks, S)
    for c in range(n_chunks):
        for s in range(S):
            if mean_acti[c, s] > sil_spk_th:
                flat_idx.append((c, s))
                vecs.append(svecs[c][s])
    if not vecs:
        return np.full((n_chunks, S), 0, np.int32), 0

    # cannot-link all co-active channel pairs within a chunk
    pos = {cs: i for i, cs in enumerate(flat_idx)}
    cls_links = []
    for c in range(n_chunks):
        act = [s for s in range(S) if (c, s) in pos]
        for i in range(len(act)):
            for j in range(i + 1, len(act)):
                cls_links.append((pos[(c, act[i])], pos[(c, act[j])]))

    labels_flat = constrained_ahc(np.stack(vecs), cls_links, n_clusters, dist_threshold)
    k = int(labels_flat.max()) + 1
    labels = np.full((n_chunks, S), k, np.int32)  # k = silence label
    for (c, s), l in zip(flat_idx, labels_flat):
        labels[c, s] = l
    # merge same-label channels within a chunk (keep max activity)
    for c in range(n_chunks):
        seen: Dict[int, int] = {}
        for s in range(S):
            l = labels[c, s]
            if l == k:
                continue
            if l in seen:
                actis[c][:, seen[l]] = np.maximum(actis[c][:, seen[l]], actis[c][:, s])
                actis[c][:, s] = 0.0
                labels[c, s] = k
            else:
                seen[l] = s
    return labels, k


def stitch(
    actis: List[np.ndarray],
    labels: np.ndarray,
    n_clusters: int,
    chunk_starts: List[int],
    total_frames: int,
) -> np.ndarray:
    """Chunk activities + global labels → (total_frames, n_clusters) probs."""
    out = np.zeros((total_frames, max(n_clusters, 1)), np.float32)
    cnt = np.zeros((total_frames, 1), np.float32)
    for ci, (a, st) in enumerate(zip(actis, chunk_starts)):
        en = min(st + a.shape[0], total_frames)
        for s in range(a.shape[1]):
            l = labels[ci, s]
            if l < n_clusters:
                out[st:en, l] = np.maximum(out[st:en, l], a[: en - st, s])
    return out


def eend_vc_infer_recording(
    predict_fn: Callable[[np.ndarray, np.ndarray], tuple],
    audio: np.ndarray,
    frontend,
    chunk_frames: int = 500,
    n_clusters: Optional[int] = None,
    sil_spk_th: float = 0.05,
    dist_threshold: float = 1.0,
) -> np.ndarray:
    """Whole-recording EEND-VC: chunk → (acti, svec) → cluster → stitch.

    predict_fn: (audio (1, chunk_samples), frame_mask (1, T)) →
    (probs (1, T, S), svec (1, S, D)).
    """
    ss, shift = frontend.subsampling, frontend.frame_shift
    chunk_samples = frontend.chunk_samples(chunk_frames)
    n_sub = max(len(audio) // (ss * shift), 1)
    n_chunks = (n_sub + chunk_frames - 1) // chunk_frames
    need = n_chunks * chunk_samples
    audio_p = np.pad(audio.astype(np.float32), (0, max(0, need - len(audio))))

    actis, svecs, starts = [], [], []
    for ci in range(n_chunks):
        s = ci * chunk_samples
        a = audio_p[s : s + chunk_samples][None]
        valid = min(chunk_frames, n_sub - ci * chunk_frames)
        m = np.zeros((1, chunk_frames), np.float32)
        m[0, :valid] = 1.0
        probs, svec = predict_fn(a, m)
        actis.append(np.asarray(probs)[0, :valid])
        svecs.append(np.asarray(svec)[0])
        starts.append(ci * chunk_frames)
    labels, k = cluster_chunk_vectors(actis, svecs, n_clusters, sil_spk_th, dist_threshold)
    return stitch(actis, labels, max(k, 1), starts, n_sub)


def make_eend_vc_predict(model) -> Callable[[np.ndarray, np.ndarray], tuple]:
    """(audio (1, chunk_samples), frame_mask (1, T)) numpy → (masked sigmoid
    probabilities (1, T, S), chunk vectors (1, S, D)) numpy, on the model's
    device."""
    dev = model.device

    @torch.no_grad()
    def predict(audio: np.ndarray, mask: np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(dev)
        logits, vecs = model(a, m)
        return (torch.sigmoid(logits) * m[..., None]).cpu().numpy(), vecs.float().cpu().numpy()

    return predict
