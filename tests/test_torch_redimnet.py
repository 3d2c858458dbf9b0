"""Port parity of ReDimNet (models/redimnet.py) against the JAX ReDimNet on
carried-over weights: each 2-D block type (basic_resnet, convnext_like,
basic_resnet_fwse) with a 1-D block type (conv+att, gru, att) at a tiny C,
grouped, with channel expansion, stride-3 pooling and once the MFA conv, in eval ('frames' and
the ASTP embedding) and train mode with the BatchNorm statistics; the `fc`
and `gru` time-context blocks alone; the ungrouped residual block with its
downsample; the weights both ways; and TS-VAD with a redimnet_<size>
encoder (C·F frames at 100 Hz, a stride-4 conv): logits, the train-mode
loss and statistics, and the eval-mode loss's gradients
(torch_zoo_common.check_tsvad says why). The factory sizes b0-b6 are
counted in tests/test_torch_redimnet_sizes.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_common import TINY_BACKEND, check_tsvad, flat, fp32_close, init_variables, stats_close, tsvad_pair

from speaker_diarization_tpu.models import redimnet as JR
from speaker_diarization_tpu_torch.models import redimnet as R
from speaker_diarization_tpu_torch.utils import convert

torch.set_num_threads(1)

F_TINY = 12
# (block_2d_type, block_1d_type, group_divisor, out_channels): every 2-D
# type, the MFA conv once; the 1-D type `fc` alone below
TINY = {
    "basic_resnet/conv+att": ("basic_resnet", "conv+att", 2, None),
    "convnext_like/gru/mfa": ("convnext_like", "gru", 1, 8),
    "basic_resnet_fwse/att": ("basic_resnet_fwse", "att", 4, None),
}
# stage 0 expands its channels (conv_exp 2), stage 1 pools frequency by 3;
# C·F 48 over 4 or 6 gives widths 4 heads divide
STAGES = ((1, 1, 2, None, 4), (3, 1, 1, None, 6))


@pytest.fixture(scope="module", params=sorted(TINY))
def tiny(request):
    """The port's ReDimNet with the JAX weights, and the JAX frames and
    embedding in eval mode and the embedding and statistics of train mode."""
    b2d, b1d, gd, out = TINY[request.param]
    kw = dict(size=None, feat_dim=F_TINY, C=4, stages_setup=STAGES, block_1d_type=b1d, block_2d_type=b2d,
              group_divisor=gd, out_channels=out, embed_dim=8)
    jm = JR.ReDimNet(**kw)
    v = init_variables(jm, jnp.zeros((1, 20, F_TINY)), False, "embedding")
    m = R.ReDimNet(**kw)
    m.load_state_dict(convert.redimnet_from_flax(v["params"], v["batch_stats"]))
    rng = np.random.default_rng(1)
    x_eval = rng.standard_normal((2, 23, F_TINY)).astype(np.float32)
    x_train = rng.standard_normal((3, 20, F_TINY)).astype(np.float32)
    refs = jax.jit(lambda a, b: (jm.apply(v, a, False, "frames"), jm.apply(v, a, False, "embedding"),
                                 jm.apply(v, b, True, "embedding", mutable=["batch_stats"])))(x_eval, x_train)
    return kw, v, m.eval(), x_eval, x_train, refs


def test_tiny_eval_matches_jax(tiny):
    kw, v, m, fb, _, (frames, emb, _) = tiny
    with torch.no_grad():
        got = m(torch.from_numpy(fb), mode="frames")
        fp32_close(m(torch.from_numpy(fb), mode="embedding"), emb)
    assert got.shape == (2, 23, kw["out_channels"] or 4 * F_TINY)  # C·F (or the MFA's) at the fbank rate
    fp32_close(got, frames)


def test_tiny_train_mode_and_statistics_match_jax(tiny):
    kw, v, m, _, fb, (_, _, (ref, new)) = tiny
    m2 = R.ReDimNet(**kw)
    m2.load_state_dict(m.state_dict())
    fp32_close(m2.train()(torch.from_numpy(fb), mode="embedding"), ref)
    assert stats_close(m2.state_dict(), convert.redimnet_from_flax(v["params"], jax.device_get(new["batch_stats"]))) > 0


def test_tiny_weights_both_ways(tiny):
    kw, v, m, *_ = tiny
    back, want = flat(convert.redimnet_to_flax(m.state_dict())), flat(v)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    if kw["block_1d_type"] == "gru":  # the flax GRUCells under nn.RNN, as the enhancer's GRU
        assert "backbone.stage0.tcb.gru_bwd.hidden_n.bias" in m.state_dict()


@pytest.mark.parametrize("block_type", ["fc", "gru"])
def test_time_context_block_matches_jax(block_type):
    x = np.random.default_rng(7).standard_normal((2, 9, 16)).astype(np.float32)
    jm = JR.TimeContextBlock1d(16, 8, block_type=block_type)
    v = init_variables(jm, jnp.asarray(x))
    m = R.TimeContextBlock1d(16, 8, block_type=block_type)
    m.load_state_dict(convert.redimnet_from_flax(v["params"], {}))
    with torch.no_grad():
        fp32_close(m(torch.from_numpy(x)), jax.jit(jm.apply)(v, jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True])
def test_ungrouped_res_block_with_downsample_matches_jax(train):
    """group_divisor None (plain 3×3 convs, no pointwise ones; ReDimNet's
    factory configs cannot say None, in JAX as here), fwSE, and the 1×1
    downsample when the widths differ."""
    x = np.random.default_rng(6).standard_normal((2, 5, 9, 6)).astype(np.float32)  # JAX (B, F, T, C)
    jm = JR.ResBasicBlock(6, 8, 5, se_channels=4, group_divisor=None, use_fwse=True)
    v = init_variables(jm, jnp.asarray(x))
    m = R.ResBasicBlock(6, 8, 5, se_channels=4, group_divisor=None, use_fwse=True)
    m.load_state_dict(convert.redimnet_from_flax(v["params"], v["batch_stats"]))
    assert "conv1pw.weight" not in m.state_dict() and m.conv1.groups == 1
    ref, new = jax.jit(lambda a: jm.apply(v, a, train, mutable=["batch_stats"]))(jnp.asarray(x))
    got = m.train(train)(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    fp32_close(got.permute(0, 2, 3, 1), ref)
    if train:
        assert stats_close(m.state_dict(), convert.redimnet_from_flax(v["params"], jax.device_get(new["batch_stats"])))


def test_tsvad_redimnet_matches_jax(monkeypatch):
    """TS-VAD parses the size from `redimnet_<size>` (a tiny one here,
    registered in both packages' REDIMNET_SIZES; b0-b6 are counted in
    tests/test_torch_redimnet_sizes.py
    and b0 runs the CLI chain of tests/test_torch_zoo_cli.py) and reads its
    C·F frames at 100 Hz through a stride-4 conv."""
    size = dict(feat_dim=F_TINY, C=4, block_1d_type="fc", block_2d_type="basic_resnet",
                stages_setup=STAGES, group_divisor=1)
    monkeypatch.setitem(JR.REDIMNET_SIZES, "bt", size)
    monkeypatch.setitem(R.REDIMNET_SIZES, "bt", size)
    cfg = dict(TINY_BACKEND, speech_encoder_type="redimnet_bt", feat_dim=F_TINY, sample_rate=16000)
    x = np.random.default_rng(4).standard_normal((2, 48, F_TINY)).astype(np.float32)
    embs = np.random.default_rng(5).standard_normal((2, 4, 16)).astype(np.float32)
    jm, v, model = tsvad_pair(cfg, x, embs, 12)
    assert model.speech_down.conv.stride == (4,) and model.speech_encoder.out_channels == 4 * F_TINY
    got = check_tsvad(jm, v, model, x, embs, 12, train_grads=False)
    assert got.shape == (2, 12, 4)
