"""The benchmark of speaker_diarization_tpu_torch on one NVIDIA H100 (see README.md)."""
