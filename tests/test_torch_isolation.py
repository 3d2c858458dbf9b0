"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from speaker_diarization_tpu_torch.kernels import _build
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "speaker_diarization_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "speaker_diarization_tpu"}
TINY = dict(
    encoder_block_layers=(1, 1), transformer_embed_dim=32, transformer_ffn_embed_dim=64,
    num_attention_head=2, speaker_embed_dim=16, num_transformer_layer=1,
)


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _modules():
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        if rel == "chip_smoke.py" or rel.endswith("__main__.py"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_no_source_imports_jax_or_the_jax_package():
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_every_module_imports_and_runs_with_jax_blocked():
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, numpy as np, torch
torch.set_num_threads(1)
for mod in {sorted(_modules())!r}:
    importlib.import_module(mod)
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
m = TSVADModel(TSVADConfig(**{TINY!r}), device="cpu", seed=1)
rng = np.random.default_rng(0)
with torch.no_grad():
    out = m(torch.from_numpy((0.1 * rng.standard_normal((2, 16000))).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32)))
assert out.shape == (2, 25, 4) and torch.isfinite(out).all(), out.shape
assert not any(k.split(".")[0] in {sorted(FORBIDDEN)!r} and sys.modules[k] is not None for k in sys.modules)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSVADModel(TSVADConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSVADModel(TSVADConfig(**TINY), device="cuda")
    from speaker_diarization_tpu_torch.cli.main import main as port_cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["infer", "--data-dir", str(tmp_path), "--emb-store", "x.npz", "--params", "p.npz", "--out", "o"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_modules_import_and_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    code = (
        "import speaker_diarization_tpu_torch.kernels.fbank, speaker_diarization_tpu_torch.kernels.cam_block, "
        "speaker_diarization_tpu_torch.kernels.cam_block_fused, speaker_diarization_tpu_torch.kernels.selective_scan, "
        "speaker_diarization_tpu_torch.kernels._build; print('ok')"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert set(_build.sources()) == {"fbank", "cam_block", "selective_scan"}


def test_wrappers_run_their_twins_for_cpu_tensors():
    from speaker_diarization_tpu_torch.kernels import fbank

    launches = fbank.fbank_cuda.launches
    assert fbank.fbank_cuda(torch.zeros(1, 800)).shape == (1, 3, 80)
    assert fbank.fbank_cuda.launches == launches
