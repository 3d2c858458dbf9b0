"""Models: CAM++ and TS-VAD (transformer backends)."""

from .campplus import CAMPPlus  # noqa: F401
from .tsvad import TSVADConfig, TSVADModel  # noqa: F401
