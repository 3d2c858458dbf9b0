"""The CLI chain with a speech encoder of the zoo, on the CPU at its real
size: `train --family tsvad --set speech_encoder_type=redimnet_b0 --set
n_mels=60` (two steps, the smallest ReDimNet at full width), `infer
--exp-dir --threshold-sweep` → `score`, `infer --params` of the flax npz
that `train` writes, and that npz read by the JAX package's TSVADModel:
the same logits as the port's, on the same fbank."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_zoo_common import fp32_close, jax_fbank

from speaker_diarization_tpu.models.tsvad import TSVADConfig as JConfig
from speaker_diarization_tpu.models.tsvad import TSVADModel as JModel
from speaker_diarization_tpu_torch.cli.main import FLAX_CONFIG, FLAX_PARAMS
from speaker_diarization_tpu_torch.cli.main import main as port_cli
from speaker_diarization_tpu_torch.data.synth import write_synthetic_corpus
from speaker_diarization_tpu_torch.models.tsvad import TSVADConfig, TSVADModel
from speaker_diarization_tpu_torch.utils import convert
from speaker_diarization_tpu_torch.utils.config import load_json

torch.set_num_threads(1)

SETS = ["speech_encoder_type=redimnet_b0", "n_mels=60", "sample_rate=16000", "n_layers=1", "d_ff=32",
        "batch_size=2", "log_every=1", "valid_every=2", "schedule=poly", "learning_rate=1e-3", "warmup_steps=1",
        "rs_len=2.0", "segment_shift=2.0", "num_steps=2"]


def test_redimnet_b0_train_infer_score_and_the_npz_in_jax(tmp_path, capsys):
    root = str(tmp_path)
    tr = write_synthetic_corpus(os.path.join(root, "tr"), n_recs=1, seconds=6.0, rate=16000, n_speakers=2,
                                emb_dim=192, seed=1, prefix="tr")
    va = write_synthetic_corpus(os.path.join(root, "va"), n_recs=1, seconds=4.0, rate=16000, n_speakers=2,
                                emb_dim=192, seed=2, prefix="va")
    exp = os.path.join(root, "exp")
    argv = ["train", "--family", "tsvad", "--train-dir", tr["data_dir"], "--valid-dir", va["data_dir"],
            "--emb-store", f"{tr['emb_store']},{va['emb_store']}", "--exp-dir", exp, "--device", "cpu"]
    assert port_cli(argv + [a for kv in SETS for a in ("--set", kv)]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2] and all(np.isfinite(r["loss"]) for r in recs)
    out = os.path.join(root, "hyp")
    capsys.readouterr()
    assert port_cli(["infer", "--data-dir", va["data_dir"], "--emb-store", va["emb_store"], "--exp-dir", exp,
                     "--out", out, "--device", "cpu", "--threshold-sweep", "--ref", va["rttm"]]) == 0
    best = re.search(r"best threshold ([0-9.]+)", capsys.readouterr().out)
    assert best and len([f for f in os.listdir(root) if f.startswith("hyp_")]) == 18
    assert port_cli(["score", "--ref", va["rttm"], "--sys", f"{out}_{float(best.group(1)):.2f}"]) == 0
    # the flax npz `train` wrote: the port's infer --params reads it ...
    npz, cfg_json = os.path.join(exp, FLAX_PARAMS), os.path.join(exp, FLAX_CONFIG)
    cfg = load_json(TSVADConfig, cfg_json)
    assert cfg.speech_encoder_type == "redimnet_b0" and cfg.feat_dim == 60
    assert port_cli(["infer", "--data-dir", va["data_dir"], "--emb-store", va["emb_store"], "--params", npz,
                     "--config", cfg_json, "--rs-len", "2.0", "--out", os.path.join(root, "p.rttm"),
                     "--device", "cpu"]) == 0
    # ... and so does the JAX package: nested dicts of numpy arrays from np.load
    variables = {}
    with np.load(npz) as z:
        for key in z.files:
            node = variables
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    model = TSVADModel(cfg, device="cpu")
    model.load_state_dict(convert.tsvad_from_flax(variables))
    audio = (0.1 * np.random.default_rng(3).standard_normal((2, 32000))).astype(np.float32)
    fb = jax_fbank(audio, 16000, 60)
    embs = np.random.default_rng(4).standard_normal((2, 4, 192)).astype(np.float32)
    jm = JModel(cfg=JConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.__dict__.items()}))
    ref = jax.jit(jm.apply, static_argnums=3)(variables, jnp.asarray(fb), jnp.asarray(embs), 50)
    with torch.no_grad():
        got = model(torch.from_numpy(fb), torch.from_numpy(embs), 50)
    assert got.shape == (2, 50, 4)
    fp32_close(got, ref)
