"""Hand-written CUDA kernels for sm_90a and their plain PyTorch twins.

K1 fbank.py (csrc/fbank.cu) and K2 cam_block.py (csrc/cam_block.cu); the
libraries are built by _build.py at first use, never at import.
"""
