"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level names; the reference imports nothing of the measured package."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.run import FORBIDDEN, forbidden_modules


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(harness.BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_whole_top_level_names():
    assert forbidden_modules(["speaker_diarization_tpu_torch", "speaker_diarization_tpu_torch.models.tsvad",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["speaker_diarization_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "speaker_diarization_tpu"]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_no_jax_in_the_benchmark(path):
    assert not {m.split(".")[0] for m in _imports(path)} & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert all(m.split(".")[0] != "speaker_diarization_tpu_torch" for m in _imports(path))


def test_a_run_without_cuda_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tsvad_tf.infer_windows", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
