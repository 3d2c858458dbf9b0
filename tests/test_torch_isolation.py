"""The port stands alone: no JAX, no JAX package, no scikit-learn, umap,
hdbscan or msgpack, no orbax, tensorstore, zarr or zstandard (the GPU hosts
have none), no silent CPU fallback and no gloo on a GPU. Every module of
the port is imported, and the TS-VAD speech-encoder zoo, the flax msgpack
decoder, the Orbax reader and the reference-checkpoint loaders, DiCoW and
the Whisper decoder, and ring attention on a one-rank gloo group run, with
those packages blocked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from speaker_diarization_tpu_torch.kernels import _build
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "speaker_diarization_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "speaker_diarization_tpu", "sklearn", "umap", "hdbscan",
             "msgpack", "zstandard", "tensorstore", "zarr"}
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
import os, sys
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
zoo = (("wavlm_weight_sum", dict(wavlm_layers=1, wavlm_embed_dim=64)),
       ("whisper", dict(whisper_d_model=64, whisper_n_layers=2, whisper_n_heads=1, whisper_layer_st=0,
                        whisper_layer_ed=1)),
       ("w2vbert", dict(w2vbert_layers=1, w2vbert_dim=64)), ("eres2netv2", dict(eres2net_base_width=4)),
       ("redimnet_b0", dict(feat_dim=60)))
a16 = torch.from_numpy((0.1 * rng.standard_normal((2, 16000))).astype(np.float32))
e16 = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
for enc, kw in zoo:
    zm = TSVADModel(TSVADConfig(**{TINY!r}, speech_encoder_type=enc, **kw), device="cpu", seed=1)
    with torch.no_grad():
        out = zm(a16, e16)
    assert out.shape == (2, 25, 4) and torch.isfinite(out).all(), (enc, out.shape)
from speaker_diarization_tpu_torch.utils.msgpack import from_bytes
assert from_bytes(b"\\x81\\xa1a\\x01") == {{"a": 1}}
from speaker_diarization_tpu_torch.utils import orbax, torch_convert
from speaker_diarization_tpu_torch.models.campplus import CAMPPlus
fixture = os.path.join({REPO!r}, "tests", "fixtures", "torch_orbax_tsvad", "step_0000000001")
state = orbax.restore(fixture, select=("step", "params", "mutable"))
assert int(state["step"]) == 1 and "opt_state" not in state and state["params"]["fc"]["kernel"].shape == (384, 4)
camp = CAMPPlus(block_layers=(1, 1, 1))
assert torch_convert.campplus_from_torch(camp.state_dict()).keys() >= {{"head.conv1.weight", "xvector.tdnn.linear.weight"}}
from speaker_diarization_tpu_torch.models.eda import EendEdaModel
e = EendEdaModel(d_model=16, n_layers=1, n_heads=2, d_ff=32, max_attractors=3, device="cpu", seed=1)
with torch.no_grad():
    lo, ex = e.infer(torch.from_numpy((0.1 * rng.standard_normal((2, 8000))).astype(np.float32)))
assert lo.shape == (2, 10, 3) and ex.shape == (2, 3) and torch.isfinite(lo).all(), lo.shape
from speaker_diarization_tpu_torch.models.eend_m2f import EENDM2FModel, M2FConfig
from speaker_diarization_tpu_torch.models.fs_eend import FSEENDModel
from speaker_diarization_tpu_torch.models.ots_vad import OTSVADConfig, OTSVADModel
from speaker_diarization_tpu_torch.models.ssnd import SSNDConfig, SSNDModel
a8 = torch.from_numpy((0.1 * rng.standard_normal((2, 8000))).astype(np.float32))
with torch.no_grad():
    s = SSNDModel(SSNDConfig(feat_dim=24, emb_dim=16, d_model=16, n_heads=2, d_ff=16, num_layers=1, vad_out_len=25,
                             pos_emb_dim=8, max_seq_len=60, n_all_speakers=5, sample_rate=8000, extractor_blocks=(1, 1)),
                  device="cpu")
    vad, emb = s(a8, torch.zeros(2, 4, 16))
    assert vad.shape == (2, 4, 25) and emb.shape == (2, 4, 16) and torch.isfinite(vad).all()
    out = EENDM2FModel(M2FConfig(num_queries=4, d_model=16, d_ff=16, enc_layers=1, dec_layers=1, conv_kernel=5),
                       device="cpu")(a8)
    assert out["mask_logits"].shape == (2, 4, 100) and torch.isfinite(out["mask_logits"]).all()
    lo, _ = FSEENDModel(d_model=16, enc_layers=1, dec_layers=1, n_heads=2, d_ff=16, dec_d_ff=16, device="cpu")(a8)
    assert lo.shape == (2, 10, 4) and torch.isfinite(lo).all()
    o = OTSVADModel(OTSVADConfig(d_model=16, conformer_layers=1, n_heads=2, d_ff=16, lstm_hidden=8, feat_dim=24,
                                 sample_rate=8000, encoder_m_channels=4, encoder_blocks=(1, 1, 1, 1)), device="cpu")
    lo = o(a8, a8, torch.ones(2, 4, 13))
    assert lo.shape == (2, 4, 13) and torch.isfinite(lo).all()
    from speaker_diarization_tpu_torch.infer.clustering import spectral_cluster
    from speaker_diarization_tpu_torch.models.enhancer import EnhancerConfig, MaskDenoiser
    from speaker_diarization_tpu_torch.models.vad import NeuralVAD, NeuralVADConfig
    lo = NeuralVAD(NeuralVADConfig(sample_rate=8000, frame_size=200, frame_shift=80, n_mels=16, conv_channels=(4,),
                                   lstm_hidden=4), device="cpu")(a8)
    assert lo.shape == (2, 100) and torch.isfinite(lo).all()
    y = MaskDenoiser(EnhancerConfig(n_fft=64, hop=16, hidden=4, conv_channels=4, n_convs=1), device="cpu")(a8)
    assert y.shape == (2, 8000) and torch.isfinite(y).all()
    lab = spectral_cluster(np.concatenate([rng.standard_normal(8) + 5 * np.eye(8)[i % 2] for i in range(12)]).reshape(12, 8))
    assert len(set(lab.tolist())) >= 1
from speaker_diarization_tpu_torch.models.dicow import DiCoWConfig, DiCoWEncoder, ctc_loss
from speaker_diarization_tpu_torch.models.whisper_decoder import WhisperDecoder, WhisperDecoderConfig, greedy_decode
from speaker_diarization_tpu_torch.models.whisper_encoder import WhisperEncoderConfig
d = DiCoWEncoder(DiCoWConfig(whisper=WhisperEncoderConfig(n_mels=16, n_ctx=64, d_model=16, n_heads=2, n_layers=1,
                                                          d_ff=16), vocab_size=6), device="cpu")
stno = torch.zeros(2, 4, 50)
stno[:, 1] = 1
lo, h = d(a16, stno)
assert lo.shape == (2, 50, 6) and torch.isfinite(ctc_loss(lo, torch.zeros(2, 50), torch.ones(2, 3).long(),
                                                          torch.zeros(2, 3)))
dec = WhisperDecoder(WhisperDecoderConfig(vocab_size=8, d_model=16, n_heads=2, n_layers=1, d_ff=16, max_positions=8),
                     device="cpu")
assert greedy_decode(dec, h.detach(), np.ones((2, 1), np.int32), 3, eos_id=2).shape[0] == 2
import socket
import torch.distributed as dist
from speaker_diarization_tpu_torch.parallel.mesh import init_distributed, make_mesh
from speaker_diarization_tpu_torch.parallel.ring_attention import ring_self_attention
from speaker_diarization_tpu_torch.utils import profiling
with socket.socket() as sk:
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
init_distributed("cpu", init_method=f"tcp://127.0.0.1:{{port}}")
q = torch.randn(1, 8, 2, 4)
assert ring_self_attention(q, q, q, make_mesh()).shape == q.shape
dist.destroy_process_group()
with profiling.tracing(), profiling.span("x"):
    profiling.count("n")
assert profiling.snapshot()["spans"][0]["counts"] == {{"n": 1}}
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


def test_asr_and_parallel_entry_points_raise_without_cuda(monkeypatch):
    """DiCoW, the Whisper decoder and the process group default to the GPU:
    without one they raise, and `init_distributed` never falls back to gloo."""
    from speaker_diarization_tpu_torch.models.dicow import DiCoWConfig, DiCoWEncoder
    from speaker_diarization_tpu_torch.models.whisper_decoder import WhisperDecoder, WhisperDecoderConfig
    from speaker_diarization_tpu_torch.models.whisper_encoder import WhisperEncoderConfig
    from speaker_diarization_tpu_torch.parallel.mesh import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = WhisperEncoderConfig(n_mels=8, n_ctx=8, d_model=8, n_heads=2, n_layers=1, d_ff=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiCoWEncoder(DiCoWConfig(whisper=tiny))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperDecoder(WhisperDecoderConfig(vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=8))
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            init_distributed(dev)
    assert not torch.distributed.is_initialized()


def test_kernel_modules_import_and_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    code = (
        "import speaker_diarization_tpu_torch.kernels.fbank, speaker_diarization_tpu_torch.kernels.cam_block, "
        "speaker_diarization_tpu_torch.kernels.cam_block_fused, speaker_diarization_tpu_torch.kernels.selective_scan, "
        "speaker_diarization_tpu_torch.kernels.fcm, speaker_diarization_tpu_torch.kernels._build; print('ok')"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert set(_build.sources()) == {"fbank", "cam_block", "selective_scan", "fcm"}


def test_wrappers_run_their_twins_for_cpu_tensors():
    from speaker_diarization_tpu_torch.kernels import fbank

    launches = fbank.fbank_cuda.launches
    assert fbank.fbank_cuda(torch.zeros(1, 800)).shape == (1, 3, 80)
    assert fbank.fbank_cuda.launches == launches


def test_eend_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from speaker_diarization_tpu_torch.cli.main import main as port_cli
    from speaker_diarization_tpu_torch.models.eda import EendEdaModel
    from speaker_diarization_tpu_torch.models.eend import EENDModel

    tiny = dict(d_model=16, n_layers=1, n_heads=2, d_ff=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (EENDModel, EendEdaModel):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(**tiny)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(**tiny, device="cuda")
        assert cls(**tiny, device="cpu").device == torch.device("cpu")
    for fam in ("eend", "eend_eda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(["infer", "--family", fam, "--data-dir", str(tmp_path), "--exp-dir", str(tmp_path), "--out", "o"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(["train", "--family", fam, "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])


def test_logmel_wrapper_runs_its_twin_for_cpu_tensors():
    from speaker_diarization_tpu_torch.kernels import fbank
    from speaker_diarization_tpu_torch.ops import features as F

    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((2, 8123))).astype(np.float32))
    launches = fbank.logmel_cuda.launches
    T = F.count_frames(8123, 80)
    got = fbank.logmel_cuda(x, T)
    torch.testing.assert_close(got, F.logmel_frames_torch(x, T, 200, 80, 8000, 23, mean_norm=False), rtol=0, atol=0)
    assert got.shape == (2, 102, 23) and fbank.logmel_cuda.launches == launches


def test_fcm_wrapper_runs_its_twin_for_cpu_tensors():
    from speaker_diarization_tpu_torch.kernels import fcm
    from speaker_diarization_tpu_torch.models.campplus import FCM
    from speaker_diarization_tpu_torch.models.layers import init_weights_

    head = FCM().eval()
    init_weights_(head, torch.Generator().manual_seed(0))
    flat = fcm.prepare_fcm_params(head, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 30, 80)).astype(np.float32))
    launches = fcm.fcm_cuda.launches
    got = fcm.fcm_cuda(x, flat)
    torch.testing.assert_close(got, fcm.fcm_folded_torch(x, flat, torch.float32), rtol=0, atol=0)
    assert got.shape == (2, 30, 320) and fcm.fcm_cuda.launches == launches


def test_slice8_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """SSND, EEND-M2F, FS-EEND and OTS-VAD run on the card unless the caller
    asks for the CPU: models and CLI verbs raise without CUDA."""
    from speaker_diarization_tpu_torch.cli.main import main as port_cli
    from speaker_diarization_tpu_torch.models.eend_m2f import EENDM2FModel, M2FConfig
    from speaker_diarization_tpu_torch.models.fs_eend import FSEENDModel
    from speaker_diarization_tpu_torch.models.ots_vad import OTSVADConfig, OTSVADModel
    from speaker_diarization_tpu_torch.models.ssnd import SSNDConfig, SSNDModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: SSNDModel(SSNDConfig(d_model=16, n_heads=2, num_layers=1, extractor_blocks=(1, 1)), **kw),
                 lambda **kw: EENDM2FModel(M2FConfig(d_model=16, enc_layers=1, dec_layers=1), **kw),
                 lambda **kw: FSEENDModel(d_model=16, enc_layers=1, dec_layers=1, **kw),
                 lambda **kw: OTSVADModel(OTSVADConfig(d_model=16, conformer_layers=1, encoder_blocks=(1, 1, 1, 1)),
                                          **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(device="cuda")
        assert make(device="cpu").device == torch.device("cpu")
    for fam in ("ssnd", "eend_m2f", "fs_eend", "ots_vad"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(["train", "--family", fam, "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])


def test_spk_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from speaker_diarization_tpu_torch.cli.main import main as port_cli
    from speaker_diarization_tpu_torch.models.spk_embed import SpeakerClassifier, SpkEmbedConfig

    cfg = SpkEmbedConfig(n_classes=3, encoder_blocks=(1, 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeakerClassifier(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeakerClassifier(cfg, device="cuda")
    assert SpeakerClassifier(cfg, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["train", "--family", "spk", "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["extract-embeddings", "--data-dir", str(tmp_path), "--out", str(tmp_path / "e.npz")])
