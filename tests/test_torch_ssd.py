"""Port parity: the Mamba-2 SSD scan (ops/ssd.py) against the JAX package's
`ssd_chunked` and `ssd_sequential`, values and gradients, at JAX's own bars
(tests/test_ssd.py): 1e-4 for values, rtol 2e-3 / atol 2e-4 for gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.ops import ssd as J
from speaker_diarization_tpu_torch.ops import ssd as P

torch.set_num_threads(1)

NAMES = ("x", "dt", "A", "B", "C", "D")


def _inputs(B=2, T=97, H=4, Pd=8, G=2, N=16, seed=0):
    """tests/test_ssd.py's ranges: dt in [0.001, 0.5], A in [-4, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, Pd)).astype(np.float32),
            rng.uniform(0.001, 0.5, (B, T, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (H,)).astype(np.float32),
            rng.standard_normal((B, T, G, N)).astype(np.float32),
            rng.standard_normal((B, T, G, N)).astype(np.float32),
            rng.standard_normal((H,)).astype(np.float32))


def _t(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("chunk", [16, 64, 128])  # T = 97: non-dividing, typical, longer than T
@pytest.mark.parametrize("G", [1, 2, 4])  # ngroups < H repeats B/C over heads; G = H does not
def test_chunked_matches_jax_and_sequential(chunk, G):
    args = _inputs(G=G, seed=G)
    want = np.asarray(J.ssd_chunked(*map(jnp.asarray, args), chunk=chunk))
    want_seq = np.asarray(J.ssd_sequential(*map(jnp.asarray, args)))
    got = P.ssd_chunked(*_t(args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_seq, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(P.ssd_sequential(*_t(args)).numpy(), want_seq, rtol=1e-4, atol=1e-4)


def test_without_skip_term():
    args = _inputs(T=40, seed=5)
    want = np.asarray(J.ssd_chunked(*map(jnp.asarray, args[:5]), None, chunk=16))
    np.testing.assert_allclose(P.ssd_chunked(*_t(args[:5]), None, chunk=16).numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_grads_match_jax(chunk):
    """torch autograd of sum(tanh(y)) through every input (the masked decay
    included: no NaN from the entries above the diagonal) against jax.grad
    of the JAX chunked scan and of the per-step recurrence."""
    args = _inputs(T=40, seed=1)
    t = [a.requires_grad_() for a in _t(args)]
    torch.tanh(P.ssd_chunked(*t, chunk=chunk)).sum().backward()
    for ref in (lambda *a: J.ssd_chunked(*a, chunk=chunk), J.ssd_sequential):
        want = jax.grad(lambda *a: jnp.sum(jnp.tanh(ref(*a))), argnums=tuple(range(6)))(*map(jnp.asarray, args))
        for name, a, w in zip(NAMES, t, want):
            assert torch.isfinite(a.grad).all(), name
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-4, err_msg=name)


def test_causality():
    x, dt, A, Bm, Cm, D = _t(_inputs(B=1, T=50, seed=2))
    y1 = P.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=16)
    x2 = x.clone()
    x2[:, 30:] = 123.0  # perturb the future
    y2 = P.ssd_chunked(x2, dt, A, Bm, Cm, D, chunk=16)
    torch.testing.assert_close(y1[:, :30], y2[:, :30], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(y1[:, 30:], y2[:, 30:])
