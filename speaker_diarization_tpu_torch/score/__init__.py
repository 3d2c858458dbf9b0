"""DER scoring with md-eval semantics."""

from .der import DerResult, score_der  # noqa: F401
