"""ReDimNet's factory sizes in the port (models/redimnet.py) against the JAX
package's: the size table, the 1-D ↔ 2-D reshapes, and the parameter and
BatchNorm-statistic counts of b0-b6 (jax.eval_shape against the meta
device: nothing is computed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models import redimnet as JR
from speaker_diarization_tpu_torch.models import redimnet as R
from speaker_diarization_tpu_torch.models.speaker_encoders import build_speaker_encoder

torch.set_num_threads(1)


def test_sizes_and_reshapes_are_the_jax_ones():
    assert R.REDIMNET_SIZES == JR.REDIMNET_SIZES
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)  # JAX (B, F, T, C)
    flat1 = np.asarray(JR.to1d(jnp.asarray(x)))
    got = R.to1d(torch.from_numpy(x.transpose(0, 3, 1, 2)))  # the port's (B, C, F, T)
    np.testing.assert_array_equal(got.numpy(), flat1)
    np.testing.assert_array_equal(R.to2d(got, 3, 5).numpy(), x.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(np.asarray(JR.to2d(jnp.asarray(flat1), 3, 5)), x)


@pytest.mark.parametrize("size", sorted(JR.REDIMNET_SIZES))
def test_parameter_count_matches_jax(size):
    feat = JR.REDIMNET_SIZES[size]["feat_dim"]
    jm = JR.ReDimNet(size=size)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, feat)), False, "embedding"))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(v["params"]))
    with torch.device("meta"):
        m = build_speaker_encoder("redimnet", size=size)
    assert sum(p.numel() for p in m.parameters()) == want
    stats = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(v["batch_stats"]))
    assert sum(b.numel() for n, b in m.named_buffers() if "running_" in n) == stats
