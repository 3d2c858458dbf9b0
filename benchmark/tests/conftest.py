"""CPU tests of the benchmark at tiny sizes: `python -m pytest benchmark/tests -q` from the repo root."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# CAM++ (1, 1, 1) at the published widths; four windows, each of its own meeting
TINY = {"tsvad": {"encoder_block_layers": [1, 1, 1]}, "traffic": {"batch": 4, "ring": 4, "meeting_s": 4.0}}
TINY_TRAIN = {"tsvad": {"encoder_block_layers": [1, 1, 1]},
              "traffic": {"batch": 2, "ring": 4, "window_s": 4.0, "shift_s": 4.0, "meeting_s": 4.0}}


def tiny(workload: str, **extra) -> dict:
    over = copy.deepcopy(TINY_TRAIN if "train" in workload else TINY)
    for k, v in extra.items():
        over.setdefault(k, {}).update(v)
    return over


@pytest.fixture
def tiny_overrides():
    return tiny
