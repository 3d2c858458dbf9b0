"""Minimal dependency-free HDBSCAN* (the reference algorithm path of

The port's own copy of speaker_diarization_tpu/infer/hdbscan_native.py (NumPy only),
unchanged below this paragraph; tests/test_torch_clustering.py holds the
two copies to the same output.
`egs/alimeeting/umap_cluster/umap_clusterer.py`, which calls the external
`hdbscan` package — unavailable in this environment, so the algorithm is
implemented here from its definition).

Campello/Moulavi/Sander HDBSCAN*:
  1. core distance  = distance to the min_samples-th nearest neighbour;
  2. mutual reachability d_mr(a,b) = max(core(a), core(b), d(a,b));
  3. minimum spanning tree of the mutual-reachability graph (Prim, O(n²) —
     subsegment counts are hundreds to a few thousand, host-side);
  4. single-linkage hierarchy from sorted MST edges;
  5. condensed tree with min_cluster_size (points fall out of a cluster at
     the lambda = 1/distance where their subtree shrinks below the size);
  6. cluster selection by Excess of Mass (EOM) on the stability scores.

Unlike flat DBSCAN (one global eps), variable-density clusters are found
correctly — the property the reference pipeline relies on.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _mutual_reachability(X: np.ndarray, min_samples: int) -> np.ndarray:
    d = np.sqrt(np.maximum(((X[:, None] - X[None]) ** 2).sum(-1), 0.0))
    k = min(min_samples, len(X) - 1)
    core = np.sort(d, axis=1)[:, k]  # k-th NN (row 0 is self)
    mr = np.maximum(d, np.maximum(core[:, None], core[None, :]))
    np.fill_diagonal(mr, 0.0)
    return mr


def _mst_edges(mr: np.ndarray) -> np.ndarray:
    """Prim's MST over the dense mutual-reachability matrix.
    Returns (n-1, 3) rows [u, v, weight] sorted by weight."""
    n = len(mr)
    in_tree = np.zeros(n, bool)
    in_tree[0] = True
    best = mr[0].copy()
    best_from = np.zeros(n, np.int64)
    edges = []
    for _ in range(n - 1):
        cand = np.where(in_tree, np.inf, best)
        v = int(np.argmin(cand))
        edges.append((int(best_from[v]), v, float(best[v])))
        in_tree[v] = True
        upd = mr[v] < best
        best = np.where(upd, mr[v], best)
        best_from = np.where(upd, v, best_from)
    e = np.array(edges, np.float64)
    return e[np.argsort(e[:, 2])]


def _single_linkage(edges: np.ndarray, n: int) -> np.ndarray:
    """scipy-style linkage from sorted MST edges: rows
    [left_node, right_node, distance, size]; node ids ≥ n are merges."""
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1, np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    L = np.zeros((n - 1, 4))
    nxt = n
    for i, (u, v, w) in enumerate(edges):
        ru, rv = find(int(u)), find(int(v))
        L[i] = (ru, rv, w, size[ru] + size[rv])
        parent[ru] = parent[rv] = nxt
        size[nxt] = size[ru] + size[rv]
        nxt += 1
    return L


def _condense(L: np.ndarray, n: int, min_cluster_size: int):
    """Condensed tree: list of (parent_cluster, child_id, lambda, size)
    where child_id < n is a point, else a sub-cluster id."""
    root = 2 * n - 2
    # children of each linkage node
    left = {int(n + i): int(L[i, 0]) for i in range(n - 1)}
    right = {int(n + i): int(L[i, 1]) for i in range(n - 1)}
    dist = {int(n + i): float(L[i, 2]) for i in range(n - 1)}
    sz = {i: 1 for i in range(n)}
    sz.update({int(n + i): int(L[i, 3]) for i in range(n - 1)})

    rows = []  # (parent, child, lam, size)
    next_cluster = [n]  # condensed cluster ids start at n (root = n)
    relabel = {root: n}
    next_cluster[0] = n + 1

    # iterative DFS: (node, cluster_it_belongs_to)
    stack = [root]
    while stack:
        node = stack.pop()
        if node < n:
            continue
        cluster = relabel[node]
        lam = 1.0 / max(dist[node], 1e-12)
        l, r = left[node], right[node]
        big_l = sz[l] >= min_cluster_size
        big_r = sz[r] >= min_cluster_size

        def shed(sub):
            """all points of `sub` leave `cluster` at lam"""
            s2 = [sub]
            while s2:
                m = s2.pop()
                if m < n:
                    rows.append((cluster, m, lam, 1))
                else:
                    s2.extend((left[m], right[m]))

        if big_l and big_r:
            for child in (l, r):
                cid = next_cluster[0]
                next_cluster[0] += 1
                relabel[child] = cid
                rows.append((cluster, cid, lam, sz[child]))
                if child >= n:
                    stack.append(child)
                else:  # degenerate: can't happen (size 1 < min_cluster_size ≥ 2)
                    rows.append((cid, child, lam, 1))
        else:
            for child, big in ((l, big_l), (r, big_r)):
                if big:
                    relabel[child] = cluster
                    if child >= n:
                        stack.append(child)
                    else:
                        rows.append((cluster, child, lam, 1))
                else:
                    shed(child)
    return rows


def hdbscan_cluster(
    X: np.ndarray,
    min_cluster_size: int = 4,
    min_samples: int | None = None,
) -> np.ndarray:
    """HDBSCAN* flat labels; noise points get -1."""
    X = np.asarray(X, np.float64)
    n = len(X)
    if n == 0:
        return np.zeros(0, np.int32)
    if n <= min_cluster_size:
        return np.zeros(n, np.int32)
    ms = min_samples if min_samples is not None else min_cluster_size
    mr = _mutual_reachability(X, ms)
    L = _single_linkage(_mst_edges(mr), n)
    rows = _condense(L, n, max(min_cluster_size, 2))

    # stability per condensed cluster: sum_children (lam_child - lam_birth)·size
    birth: Dict[int, float] = {n: 0.0}
    for parent, child, lam, size in rows:
        if child >= n:
            birth[child] = lam
    stability: Dict[int, float] = {c: 0.0 for c in birth}
    children: Dict[int, List[int]] = {c: [] for c in birth}
    for parent, child, lam, size in rows:
        stability[parent] += (lam - birth[parent]) * size
        if child >= n:
            children[parent].append(child)

    # EOM selection, bottom-up (clusters created in increasing id order,
    # children always have larger ids than their parent)
    selected: Dict[int, bool] = {}
    subtree_val: Dict[int, float] = {}
    for c in sorted(birth, reverse=True):
        kid_val = sum(subtree_val[k] for k in children[c])
        if children[c] and kid_val > stability[c]:
            selected[c] = False
            subtree_val[c] = kid_val
        else:
            selected[c] = True
            subtree_val[c] = stability[c]
    # the root is never a cluster (it is "everything")
    selected[n] = False

    # resolve: a cluster is chosen if selected and no ancestor is selected
    parent_of: Dict[int, int] = {}
    for parent, child, lam, size in rows:
        if child >= n:
            parent_of[child] = parent

    def chosen(c: int) -> bool:
        if not selected.get(c, False):
            return False
        a = parent_of.get(c)
        while a is not None:
            if selected.get(a, False):
                return False
            a = parent_of.get(a)
        return True

    final = sorted(c for c in birth if chosen(c))
    label_of = {c: i for i, c in enumerate(final)}

    labels = np.full(n, -1, np.int32)
    # point memberships: deepest chosen ancestor of the cluster it fell from
    for parent, child, lam, size in rows:
        if child < n:
            c = parent
            while c is not None and c not in label_of:
                c = parent_of.get(c)
            if c is not None:
                labels[child] = label_of[c]
    return labels
