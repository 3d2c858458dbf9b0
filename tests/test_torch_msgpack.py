"""The port's decoder of flax's to_bytes format (utils/msgpack.py, no
msgpack package) against flax.serialization: every msgpack type flax or a
tree of its leaves can write, the ndarray (type 1), complex (type 2) and
numpy-scalar (type 3) extensions, chunked array leaves, errors on bytes
that are not msgpack; then the VAD and the enhancer files the JAX package
writes, read by `load_vad_params`, `load_enhancer` and the datasets'
`neural:<npz>` hook, whose forwards are bit for bit those of the models
built from `vad_from_flax` / `enhancer_from_flax` of the same variables."""

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.models import enhancer as JEnh
from speaker_diarization_tpu.models import vad as JV
from speaker_diarization_tpu_torch.data.enhance import get_enhancer
from speaker_diarization_tpu_torch.models import enhancer as Enh
from speaker_diarization_tpu_torch.models import vad as V
from speaker_diarization_tpu_torch.utils import convert
from speaker_diarization_tpu_torch.utils.msgpack import describe, from_bytes

torch.set_num_threads(1)


def _same(a, b):
    """Equal trees: same keys, same values, arrays of the same dtype and bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and np.array_equal(a, b), (a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_every_type_flax_writes():
    rng = np.random.default_rng(0)
    tree = {
        "arrays": {dt: rng.standard_normal((2, 3)).astype(dt) for dt in ("float32", "float64", "float16")},
        "ints": {dt: np.arange(-3, 3, dtype=dt) for dt in ("int8", "int16", "int32", "int64")},
        "bool": np.array([True, False]), "empty": np.zeros((0, 4), np.float32), "uint8": np.arange(5, dtype=np.uint8),
        "scalars": {"f": np.float32(1.5), "i": np.int64(-7), "b": np.bool_(True)},  # extension type 3
        "complex": 2.5 - 1j,  # extension type 2
        "py": {"neg_fix": -5, "neg8": -100, "neg16": -1000, "neg32": -70000, "neg64": -2**40, "u8": 200,
               "u16": 60000, "u32": 2**31, "u64": 2**63, "pos_fix": 7, "f64": 0.1, "none": None, "t": True,
               "f": False, "s": "x" * 31, "s8": "y" * 200, "s16": "z" * 70000, "bin": b"\x00\x01" * 200,
               "list": list(range(20)), "nested": [{"a": 1}, [2, 3]]},
        "many": {f"k{i}": i for i in range(20)},  # map16
    }
    _same(from_bytes(fs.msgpack_serialize(tree)), fs.msgpack_restore(fs.msgpack_serialize(tree)))
    packed = msgpack.packb({"f32": 1.25}, use_single_float=True)  # float32 on the wire
    assert from_bytes(packed) == {"f32": 1.25}


def test_bfloat16_arrays_come_back_as_float32():
    x = jnp.asarray([[1.0, -2.5, 3.1415927]], jnp.bfloat16)
    got = from_bytes(fs.to_bytes({"w": x}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_chunked_array_leaves_are_joined(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)  # 16 float32 a chunk
    tree = {"params": {"big": np.arange(70, dtype=np.float32).reshape(7, 10), "small": np.ones(3, np.float32)}}
    data = fs.to_bytes(tree)
    raw = msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert raw["params"]["big"]["__msgpack_chunked_array__"] and len(raw["params"]["big"]["chunks"]) == 5
    got = from_bytes(data)
    _same(got, fs.msgpack_restore(data))
    np.testing.assert_array_equal(got["params"]["big"], tree["params"]["big"])


@pytest.mark.parametrize("data", [b"", b"\xc1", b"\x81\xa1a", b"\x81\xa1a\x01extra", b"\xc7\x02\x09ab"])
def test_bad_bytes_raise(data):
    with pytest.raises(ValueError):
        from_bytes(data)
    assert describe(data).startswith(f"{len(data)} bytes")


VAD = dict(sample_rate=8000, frame_size=200, frame_shift=80, n_mels=16, conv_channels=(8,), conv_kernel=5,
           lstm_hidden=12)
ENH = dict(n_fft=64, hop=16, hidden=8, conv_channels=8, n_convs=1)


def _audio(N, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((2, N))).astype(np.float32)


def test_jax_vad_file_reads_bit_for_bit(tmp_path):
    jm = JV.NeuralVAD(cfg=JV.NeuralVADConfig(**VAD))
    audio = _audio(8000, 1)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(audio)))
    path = str(tmp_path / "vad.msgpack")
    JV.save_vad_params(path, v)
    got = V.load_vad_params(path, V.NeuralVAD(V.NeuralVADConfig(**VAD), device="cpu", seed=5))
    want = V.NeuralVAD(V.NeuralVADConfig(**VAD), device="cpu", seed=6)
    want.load_state_dict(convert.vad_from_flax(v))
    with torch.no_grad():
        assert torch.equal(got(torch.from_numpy(audio)), want(torch.from_numpy(audio)))


def test_jax_enhancer_file_reads_bit_for_bit(tmp_path):
    jm = JEnh.MaskDenoiser(cfg=JEnh.EnhancerConfig(**ENH))
    audio = _audio(3000, 3)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(audio)))
    path = str(tmp_path / "enh.npz")
    JEnh.save_enhancer(path, v, JEnh.EnhancerConfig(**ENH))
    got = Enh.load_enhancer(path, "cpu")
    assert got.cfg == Enh.EnhancerConfig(**ENH)
    want = Enh.MaskDenoiser(Enh.EnhancerConfig(**ENH), device="cpu", seed=6)
    want.load_state_dict(convert.enhancer_from_flax(v))
    with torch.no_grad():
        out = want(torch.from_numpy(audio))
        assert torch.equal(got(torch.from_numpy(audio)), out)
        one = want(torch.from_numpy(audio[:1]))[0].numpy()  # the hook runs one chunk a forward
    hook = get_enhancer(f"neural:{path}", "cpu")  # the TS-VAD datasets' enhancer
    assert np.array_equal(hook(audio[0], 8000), one)
