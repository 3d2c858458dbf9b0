"""PyTorch/CUDA port of speaker_diarization_tpu for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout (ops/, kernels/, models/,
data/, infer/, postproc/, score/, utils/, cli/) and is held to it, module by
module, by tests/test_torch_*.py. It imports torch, numpy and scipy only:
never jax, flax, orbax or the JAX package.

Ported so far: TS-VAD inference with the CAM++ speech encoder and
transformer backends, end to end (audio -> kaldi fbank -> CAM++ -> TS-VAD
logits -> overlap-voted probabilities -> RTTM -> DER). Two hand-written CUDA
kernels for sm_90a carry its hot path (csrc/fbank.cu, csrc/cam_block.cu);
each has a plain PyTorch twin that the wrapper uses for CPU tensors.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no such request they raise.
"""

__version__ = "0.1.0"
