"""Inference: overlap-voted TS-VAD inference, embedding stores."""
