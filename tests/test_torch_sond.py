"""Port parity of the SOND slice: the powerset functions, SONDModel (SANM and
vanilla CD scorers, eval and train mode with the BatchNorm statistics), the
SOND loss from raw audio and its gradients, the encoder's frame count, the
weight converters both ways, and a port-only `train` → `infer
--threshold-sweep` → `score` chain, against the JAX package.

Tolerances: outputs 1e-4·max(1, max|ref|) in fp32; losses 1e-5 relative;
gradients 1e-4·max|ref grad| of each tensor; class indices exact. From raw
audio the port's fbank twin and JAX's kaldi_fbank_auto differ by ~1.2e-5 (of
|fbank| ≤ 3), which can flip an isolated ReLU of the ResNet34 trunk and move
the trunk's first gradients by a few percent, though the loss agrees within
1e-5. So the loss from raw audio is held to JAX's from raw audio, and its
gradients to jax.value_and_grad of JAX's SOND loss on the port's fbank, built
the same way (padded to 8·T_labels, labels every other frame)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models import sond as JS
from speaker_diarization_tpu.models.speaker_encoders import ResNet34 as JResNet34
from speaker_diarization_tpu.ops import features as JF
from speaker_diarization_tpu.ops import powerset as JP
from speaker_diarization_tpu.train import tasks as JT
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models import sond as S
from speaker_diarization_tpu_torch.ops import features as TF
from speaker_diarization_tpu_torch.ops import powerset as P
from speaker_diarization_tpu_torch.train.tasks import make_sond_loss_from_audio
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

TINY = dict(max_speakers=4, max_set_size=2, feat_dim=24, spk_emb_dim=16, d_model=32, n_heads=2, cd_layers=1,
            fsmn_layers=2, fsmn_lorder=3, fsmn_rorder=2, dropout=0.0, encoder_m_channels=8,
            encoder_blocks=(1, 1, 1, 1), sanm_kernel=4)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(x) for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _perturb(variables, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape).astype(np.float32), variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])  # positive variances
    return v


def _fp32_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _grads_close(got: dict, want: dict):
    """1e-4·max|ref grad| per tensor; a tensor whose exact gradient is zero
    (rounding noise on both sides) stays below 1e-6 of the largest one."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = np.abs(want[k]).max()
        if scale < 1e-6 * top:
            assert np.abs(got[k]).max() < 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# powerset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,m", [(16, 4), (4, 2), (3, 3), (5, 1)])
def test_powerset_mapping_matches_jax(K, m):
    np.testing.assert_array_equal(P.powerset_mapping(K, m), JP.powerset_mapping(K, m))
    assert P.n_powerset_classes(K, m) == JP.n_powerset_classes(K, m)
    assert P.n_powerset_classes(16, 4) == 2517


@pytest.mark.parametrize("K,m", [(16, 4), (4, 2)])
def test_powerset_encode_decode_match_jax(K, m):
    """Every row, including rows with more active speakers than m (the
    nearest class, ties to the first index as jnp.argmax)."""
    rng = np.random.default_rng(K + m)
    labels = (rng.random((3, 40, K)) < 0.35).astype(np.float32)
    labels[0, :4] = 1.0  # all active
    labels[1, :4] = 0.0
    labels[2, 0, : m + 1] = 1.0  # m + 1 active
    got = P.multilabel_to_powerset(torch.from_numpy(labels), K, m).numpy()
    want = np.asarray(JP.multilabel_to_powerset(jnp.asarray(labels), K, m))
    assert (labels.sum(-1) > m).any()
    np.testing.assert_array_equal(got, want)
    idx = rng.integers(0, P.n_powerset_classes(K, m), (3, 40))
    np.testing.assert_array_equal(P.powerset_to_multilabel(torch.from_numpy(idx), K, m).numpy(),
                                  np.asarray(JP.powerset_to_multilabel(jnp.asarray(idx), K, m)))


@pytest.mark.parametrize("pit", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_powerset_ce_matches_jax(pit, smoothing, masked):
    K, m = 4, 2
    rng = np.random.default_rng(int(pit) + 2 * int(masked))
    C = P.n_powerset_classes(K, m)
    logits = rng.standard_normal((3, 30, C)).astype(np.float32)
    labels = (rng.random((3, 30, K)) < 0.3).astype(np.float32)
    mask = (np.arange(30)[None] < np.array([[30], [21], [9]])).astype(np.float32) if masked else None
    got, gidx = P.powerset_pit_ce(torch.from_numpy(logits), torch.from_numpy(labels), K, m,
                                  None if mask is None else torch.from_numpy(mask), smoothing, pit)
    want, widx = JP.powerset_pit_ce(jnp.asarray(logits), jnp.asarray(labels), K, m,
                                    None if mask is None else jnp.asarray(mask), smoothing, pit)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))


# ---------------------------------------------------------------------------
# SONDModel
# ---------------------------------------------------------------------------


def _pair(cd_attention):
    cfg = dict(TINY, cd_attention=cd_attention)
    jm = JS.SONDModel(cfg=JS.SONDConfig(**cfg))
    rng = np.random.default_rng(0)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(rng.standard_normal((1, 40, 24)), jnp.float32),
                         jnp.asarray(rng.standard_normal((1, 4, 16)), jnp.float32))
    v = _perturb(v, 1)
    m = S.SONDModel(S.SONDConfig(**cfg), device="cpu")
    m.load_state_dict(convert.sond_from_flax(v))
    return jm, v, m


@pytest.fixture(scope="module", params=["sanm", "vanilla"])
def pair(request):
    return (request.param,) + _pair(request.param)


def _inputs(B=2, T=61, seed=3):
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((B, T, 24)).astype(np.float32)
    spk = rng.standard_normal((B, 4, 16)).astype(np.float32)
    spk[1, 3] = 0.0  # an absent profile
    return fb, spk


def test_sond_eval_logits_match_jax(pair):
    _, jm, v, m = pair
    fb, spk = _inputs()
    ref = jax.jit(jm.apply, static_argnums=3)(v, jnp.asarray(fb), jnp.asarray(spk), False)
    with torch.no_grad():
        got = m(torch.from_numpy(fb), torch.from_numpy(spk))
    assert got.shape == ref.shape == (2, 8, 11)
    _fp32_close(got, ref)


def test_sond_train_mode_logits_and_statistics_match_jax(pair):
    name, jm, v, m = pair
    fb, spk = _inputs(seed=4)
    ref, new = jm.apply(v, jnp.asarray(fb), jnp.asarray(spk), True, mutable=["batch_stats"])
    m2 = S.SONDModel(m.cfg, device="cpu")
    m2.load_state_dict(m.state_dict())
    m2.train()
    got = m2(torch.from_numpy(fb), torch.from_numpy(spk))
    _fp32_close(got.detach(), ref)
    want = convert.sond_from_flax({"params": v["params"], "batch_stats": jax.device_get(new["batch_stats"])})
    sd = m2.state_dict()
    for k, t in want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_sond_weights_round_trip(pair):
    _, _, v, m = pair
    back = convert.sond_to_flax(m.state_dict(), num_heads=2)
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m2 = S.SONDModel(m.cfg, device="cpu", seed=5)
    m2.load_state_dict(convert.sond_from_flax(back))
    for k, t in m.state_dict().items():
        assert torch.equal(t, m2.state_dict()[k]), k


def test_speaker_conv_encoder_keeps_absent_profiles_zero(pair):
    _, _, _, m = pair
    _, spk = _inputs()
    with torch.no_grad():
        h = m.speaker_encoder(torch.from_numpy(spk), torch.float32)
    assert (h[1, 3] == 0).all() and (h[0].abs().sum(-1) > 0).all()


_MODEL = S.SONDModel(S.SONDConfig(**TINY), device="cpu")


@pytest.mark.parametrize("T", [57, 64, 83, 400])
def test_n_out_frames_is_resnet34_length(T):
    jm = JResNet34(feat_dim=24, m_channels=8, num_blocks=(1, 1, 1, 1))
    x = jnp.zeros((1, T, 24))
    v = jm.init(jax.random.PRNGKey(0), x, False, "frames")
    n = jm.apply(v, x, False, "frames").shape[1]
    assert _MODEL.n_out_frames(T) == n == JS.SONDModel(cfg=JS.SONDConfig(**TINY)).n_out_frames(T)
    with torch.no_grad():
        assert _MODEL.speech_encoder(torch.zeros(1, T, 24), mode="frames").shape[1] == n


@pytest.mark.parametrize("train", [False, True])
def test_sond_loss_from_audio_and_gradients_match_jax(pair, train):
    """The loss from raw 8 kHz audio (3 s = 298 fbank frames, not a multiple
    of 8: padded to 8·T_labels) against JAX's make_sond_loss_from_audio,
    and its autograd gradients against jax.value_and_grad on the port's
    fbank (see the module docstring)."""
    name, jm, v, m = pair
    rng = np.random.default_rng(7)
    rate, secs = 8000, 3.0
    batch = dict(audio=(0.1 * rng.standard_normal((2, int(rate * secs)))).astype(np.float32),
                 target_embs=rng.standard_normal((2, 4, 16)).astype(np.float32),
                 labels=(rng.random((2, int(secs * 25), 4)) < 0.3).astype(np.float32))
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    mut = {"batch_stats": v["batch_stats"]}
    jloss, (jaux, _) = jax.jit(JT.make_sond_loss_from_audio(jm, sample_rate=rate), static_argnums=4)(
        v["params"], mut, jb, jax.random.PRNGKey(0), train)
    fb = TF.kaldi_fbank_auto(torch.from_numpy(batch["audio"]), sample_rate=rate, num_mel_bins=24)
    _fp32_close(fb, JF.kaldi_fbank_auto(jb["audio"], sample_rate=rate, num_mel_bins=24))
    labels = batch["labels"][:, ::2]
    fb8 = jnp.asarray(np.pad(fb.numpy(), ((0, 0), (0, 8 * labels.shape[1] - fb.shape[1]), (0, 0))))
    base = JS.make_sond_loss(jm)
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: base(p, mut, dict(fbank=fb8, spk_embs=jb["target_embs"], labels=jnp.asarray(labels)),
                       jax.random.PRNGKey(0), train), has_aux=True))(v["params"])
    m2 = S.SONDModel(m.cfg, device="cpu")
    m2.load_state_dict(m.state_dict())
    m2.train(train)
    loss, aux = make_sond_loss_from_audio(sample_rate=rate)(m2, {k: torch.from_numpy(a) for k, a in batch.items()},
                                                            None, train)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["frame_der"].item(), float(jaux["frame_der"]), rtol=1e-6)
    grads = {n: p.grad for n, p in m2.named_parameters()}
    _grads_close(_flat(convert.sond_to_flax(grads, num_heads=2)["params"]), _flat(jgrads))


def test_sond_loss_rejects_misaligned_labels():
    fb = torch.zeros(1, 83, 24)  # ceil(83 / 8) = 11 frames
    with pytest.raises(ValueError, match="mismatch"):
        S.sond_loss(_MODEL, fb, torch.ones(1, 4, 16), torch.zeros(1, 10, 4))


# ---------------------------------------------------------------------------
# CLI: train → infer --threshold-sweep → score (port only)
# ---------------------------------------------------------------------------


def test_cli_train_infer_score(tmp_path, capsys):
    tr = write_synthetic_corpus(str(tmp_path / "train"), n_recs=2, seconds=10.0, rate=8000, n_speakers=3, seed=1,
                                prefix="tr")
    va = write_synthetic_corpus(str(tmp_path / "valid"), n_recs=1, seconds=10.0, rate=8000, n_speakers=3, seed=2,
                                prefix="va")
    exp, hyp = str(tmp_path / "exp"), str(tmp_path / "hyp.rttm")
    sets = ["sample_rate=8000", "n_mels=24", "n_speakers=4", "rs_len=2.0", "segment_shift=1.0", "d_model=32",
            "n_heads=2", "encoder_blocks=1,1,1,1", "batch_size=4", "num_steps=2", "log_every=1", "valid_every=2",
            "schedule=poly", "learning_rate=1e-3", "warmup_steps=1"]
    argv = ["train", "--family", "sond", "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"], "--exp-dir",
            exp, "--emb-store", f"{tr['emb_store']},{va['emb_store']}", "--device", "cpu"]
    assert port_cli(argv + [a for kv in sets for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and any(r["kind"] == "valid" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", va["data_dir"], "--exp-dir", exp, "--emb-store", va["emb_store"],
                     "--out", hyp, "--device", "cpu", "--threshold-sweep", "--ref", va["rttm"]]) == 0
    out = capsys.readouterr().out
    assert sum(ln.startswith("threshold ") for ln in out.splitlines()) == 18 and "best threshold" in out
    assert port_cli(["score", "--ref", va["rttm"], "--sys", f"{hyp}_0.50"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line.split("/")) == 4


def test_new_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """SOND, TS-VAD3 and EEND-VC run on the card unless the caller asks for
    the CPU: their models and CLI verbs raise without CUDA."""
    from speaker_diarization_tpu_torch.models.eend_vc import EENDVCModel
    from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig
    from speaker_diarization_tpu_torch.models.tsvad3 import TSVAD3Config, TSVAD3Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny3 = TSVAD3Config(base=TSVADConfig(encoder_block_layers=(1, 1), speaker_embed_dim=16, transformer_embed_dim=32),
                         speaker_encoder_layers=(1, 1))
    for make in (lambda **kw: S.SONDModel(S.SONDConfig(**TINY), **kw), lambda **kw: TSVAD3Model(tiny3, **kw),
                 lambda **kw: EENDVCModel(d_model=16, n_layers=1, n_heads=2, d_ff=32, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device == torch.device("cpu")
    for fam in ("sond", "tsvad3", "eend_vc"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(["train", "--family", fam, "--train-dir", str(tmp_path), "--exp-dir", str(tmp_path)])
