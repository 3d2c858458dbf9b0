"""Front-end operations (kaldi fbank)."""
