"""Parallel item fetch for map-style chunk datasets.

A copy of speaker_diarization_tpu/data/parallel_fetch.py.

The reference hides host-side data work behind 8-16 torch DataLoader worker
processes (ts_vad_dataset num_workers); here the host work is wav IO +
numpy slicing/augmentation, which releases the GIL for its expensive parts,
so a shared thread pool recovers the overlap without process spawn costs.
Determinism is preserved because datasets draw per-item RNG from
(seed, epoch, index), never from shared mutable state (see
TSVADChunkDataset.set_epoch).

`SDT_DATA_WORKERS` overrides the pool size (0 disables threading — items
are fetched inline, the round-3 behavior).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

_pool: ThreadPoolExecutor | None = None
_pool_size: int | None = None


def pool_size() -> int:
    global _pool_size
    if _pool_size is None:
        env = os.environ.get("SDT_DATA_WORKERS")
        if env is not None:
            _pool_size = max(0, int(env))
        else:
            _pool_size = min(8, (os.cpu_count() or 2) * 2)
    return _pool_size


def _get_pool() -> ThreadPoolExecutor | None:
    global _pool
    n = pool_size()
    if n <= 0:
        return None
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="sdt-data")
    return _pool


def fetch_items(dataset, idxs: Sequence[int]) -> List[dict]:
    """dataset[j] for j in idxs, fetched concurrently, returned in order."""
    pool = _get_pool()
    if pool is None or len(idxs) <= 1:
        return [dataset[int(j)] for j in idxs]
    return list(pool.map(dataset.__getitem__, [int(j) for j in idxs]))
