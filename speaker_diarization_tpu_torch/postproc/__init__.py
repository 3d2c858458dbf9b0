"""Probability → RTTM post-processing."""

from .rttm_gen import hysteresis_smooth, median_filter, probs_to_turns  # noqa: F401
