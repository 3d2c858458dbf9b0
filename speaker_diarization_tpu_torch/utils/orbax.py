"""A reader of the JAX trainer's Orbax checkpoints, without orbax, tensorstore or zarr.

The JAX package saves its TrainState with `ocp.StandardCheckpointer`
(speaker_diarization_tpu/train/checkpoints.py), one `step_<10 digits>/`
directory a step. With the default `use_ocdbt`, tensorstore writes every
array of the tree as a zarr v2 array into one OCDBT key-value store:

  _METADATA             JSON: `tree_metadata` names each leaf by its key path
                        (('params', 'fc', 'kernel') → zarr array
                        "params.fc.kernel") and its value type
  manifest.ocdbt        the store's manifest: its config and version list
  d/<hash>, ocdbt.process_0/d/<hash>
                        data files: B-tree nodes and out-of-line values

Each zarr array is a key `<name>/.zarray` (JSON: shape, chunks, dtype,
compressor, fill_value, order, dimension_separator) and one key per chunk
(`<name>/0.0`, or `<name>/0` for a scalar), zstd-compressed.

The OCDBT layout (tensorstore's "OCDBT storage format"): a manifest or
B-tree node is a header (a big-endian magic, 0x0cdb3a2a or 0x0cdb20de; its
length as uint64le; varints for the format version and the compression, 1
= one zstd frame), a body, and a CRC-32C (uint32le) of everything before
it. The bodies store their fields column by column as varints:

  data file table   n; path prefix lengths shared with the previous path
                    (n - 1); suffix lengths (n); base-path lengths (n); the
                    suffixes. A path is relative to the base path of the
                    node that holds the table.
  manifest          uuid[16]; kind (0 = single); max inline value bytes;
                    max decoded node bytes; version-tree arity (1 byte);
                    compression (1 = zstd, then a uint32le level); then the
                    versions: a data file table; n; generation (n); root
                    height (n bytes); root file, offset, length (n each);
                    key, tree-byte and value-byte counts (n each); commit
                    time (n uint64le)
  B-tree node       height (1 byte); a data file table; n entries; key
                    prefix lengths (n - 1) and suffix lengths (n)
    leaf (height 0) the key suffixes; value lengths (n); value kinds (n
                    bytes, 0 inline, 1 in a data file); for the out-of-line
                    values their file (k) and offset (k); the inline values
    interior        the subtree common-prefix lengths (n); the key
                    suffixes; each child's file, offset and length (n each);
                    its key, tree-byte and value-byte counts (n each). A
                    child's keys omit its common prefix.

Only the zstd C library is needed (`libzstd.so.1`, bound through ctypes);
without it the reader raises an error that names it. The key index is built
from the B-tree nodes, and a value is read from its data file only when its
array is asked for, so `restore(path, select=("params",))` decodes no
`opt_state`. A bfloat16 array comes back as float32 (exactly), as
utils/msgpack does; leaves that are no arrays (a string, a typed PRNG key)
are left out of the tree and named in `OrbaxCheckpoint.skipped`.

    from speaker_diarization_tpu_torch.utils.orbax import restore
    state = restore("exp/step_0000004000", select=("step", "params", "mutable"))
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import math
import os
import struct
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
EMPTY_VALUES = {"None": None, "Dict": dict, "List": list, "Tuple": list, "NamedTuple": list}


class OrbaxFormatError(ValueError):
    """A checkpoint file that does not hold what its format says."""


# ---------------------------------------------------------------- zstd


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_LIBZSTD = None


def libzstd() -> ctypes.CDLL:
    """The zstd C library through ctypes (loaded once)."""
    global _LIBZSTD
    if _LIBZSTD is None:
        lib = None
        for name in (ctypes.util.find_library("zstd"), "libzstd.so.1", "libzstd.so", "libzstd.dylib"):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        if lib is None:
            raise OSError("reading an Orbax checkpoint needs the zstd C library (libzstd.so.1), which was not found")
        lib.ZSTD_createDStream.argtypes = []
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_freeDStream.restype = ctypes.c_size_t
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        _LIBZSTD = lib
    return _LIBZSTD


def zstd_decompress(data: bytes, size: Optional[int] = None, what: str = "zstd data") -> bytes:
    """The concatenated content of the zstd frames in `data`. With `size`,
    the content must be exactly that many bytes."""
    lib = libzstd()
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream failed")
    src = ctypes.create_string_buffer(bytes(data), len(data))
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    cap = max(size if size is not None else 4 * len(data), 1 << 16 if size is None else 1)
    pieces, out = [], ctypes.create_string_buffer(cap)
    outb = _OutBuffer(ctypes.cast(out, ctypes.c_void_p), cap, 0)
    try:
        lib.ZSTD_initDStream(ds)
        while True:
            before = (inb.pos, outb.pos)
            r = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(r):
                raise OrbaxFormatError(f"{what}: zstd error {lib.ZSTD_getErrorName(r).decode()}")
            if r == 0 and inb.pos == inb.size:
                break
            if outb.pos == outb.size and size is None:  # a full buffer: keep it, decode into a new one
                pieces.append(out.raw)
                out = ctypes.create_string_buffer(cap)
                outb = _OutBuffer(ctypes.cast(out, ctypes.c_void_p), cap, 0)
            elif (inb.pos, outb.pos) == before:
                raise OrbaxFormatError(f"{what}: " + ("the zstd frame is truncated" if inb.pos == inb.size
                                                      else f"decodes to more than the {size} bytes expected"))
        pieces.append(out.raw[: outb.pos])
    finally:
        lib.ZSTD_freeDStream(ds)
    content = b"".join(pieces)
    if size is not None and len(content) != size:
        raise OrbaxFormatError(f"{what}: decodes to {len(content)} bytes, not the {size} expected")
    return content


# ---------------------------------------------------------------- OCDBT


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what}: ends at byte {len(self.data)}, {n} bytes wanted at {self.pos}")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint longer than 64 bits at byte {self.pos}")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _envelope(blob: bytes, magic: int, what: str) -> _Reader:
    """Check a manifest's or node's header and checksum → a reader of its body."""
    if len(blob) < 18:
        raise OrbaxFormatError(f"{what}: {len(blob)} bytes is too short")
    got = struct.unpack(">I", blob[:4])[0]
    if got != magic:
        raise OrbaxFormatError(f"{what}: magic {got:#010x}, not {magic:#010x}")
    length = struct.unpack("<Q", blob[4:12])[0]
    if length != len(blob):
        raise OrbaxFormatError(f"{what}: the header says {length} bytes, the file holds {len(blob)}")
    if crc32c(blob[:-4]) != struct.unpack("<I", blob[-4:])[0]:
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    head = _Reader(blob[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version} is not read")
    body = blob[head.pos : -4]
    if compression == 1:
        body = zstd_decompress(body, what=what)
    elif compression != 0:
        raise OrbaxFormatError(f"{what}: compression {compression} is not read")
    return _Reader(body, what)


def _data_file_table(r: _Reader, base: str) -> list:
    """→ [(base path, relative path)], each base under the holder's `base`."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base_len = r.varints(n), r.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[: prefix[i]] + r.take(suffix[i])
        prev = path
        p = path.decode()
        files.append((base + p[: base_len[i]], p[base_len[i] :]))
    return files


class OcdbtStore:
    """The keys of one OCDBT database and lazy reads of their values."""

    def __init__(self, root: str):
        self.root = root
        # key → bytes (inline) or (file, offset, length)
        self.index: Dict[bytes, Union[bytes, Tuple[Tuple[str, str], int, int]]] = {}
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _envelope(f.read(), MANIFEST_MAGIC, path)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{path}: manifest kind {kind} (numbered manifests) is not read")
        r.varint(), r.varint(), r.byte()  # max inline value bytes, max decoded node bytes, version-tree arity
        if r.varint() == 1:  # zstd, and its level
            r.take(4)
        files = _data_file_table(r, "")
        n = r.varint()
        gen, height = r.varints(n), [r.byte() for _ in range(n)]
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # key, tree-byte and indirect-value-byte counts
        r.take(8 * n)  # commit times
        last = int(np.argmax(gen)) if n else None
        if last is not None and length[last]:  # the newest version; an empty tree has no root node
            self._walk((files[fid[last]], off[last], length[last]), height[last], b"")

    def _read(self, ref) -> bytes:
        (base, rel), offset, length = ref
        path = os.path.join(self.root, base + rel)
        if not os.path.exists(path):
            raise FileNotFoundError(f"OCDBT data file {path} is missing")
        with open(path, "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise OrbaxFormatError(f"{path}: {length} bytes wanted at {offset}, {len(out)} read")
        return out

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        what = f"B-tree node {ref[0][0] + ref[0][1]}@{ref[1]}"
        r = _envelope(self._read(ref), NODE_MAGIC, what)
        if r.byte() != height:
            raise OrbaxFormatError(f"{what}: its height is not the {height} its parent gives")
        files = _data_file_table(r, ref[0][0])
        n = r.varint()
        pre, suf = [0] + r.varints(n - 1), r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            prev = prev[: pre[i]] + r.take(suf[i])
            keys.append(prev)
        if height == 0:
            vlen = r.varints(n)
            kinds = [r.byte() for _ in range(n)]
            k = sum(1 for x in kinds if x == 1)
            fid, off = r.varints(k), r.varints(k)
            j = 0
            for i in range(n):
                if kinds[i] == 1:
                    self.index[prefix + keys[i]] = (files[fid[j]], off[j], vlen[i])
                    j += 1
                elif kinds[i] == 0:
                    self.index[prefix + keys[i]] = r.take(vlen[i])
                else:
                    raise OrbaxFormatError(f"{what}: value kind {kinds[i]} is not read")
            return
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # the subtrees' key, tree-byte and indirect-value-byte counts
        for i in range(n):
            self._walk((files[fid[i]], off[i], length[i]), height - 1, prefix + keys[i][: common[i]])

    def get(self, key: str) -> Optional[bytes]:
        v = self.index.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return self._read(v)


# ---------------------------------------------------------------- zarr v2


def _zarr_dtype(s: str, what: str) -> np.dtype:
    if s == "bfloat16":
        return np.dtype("<u2")
    try:
        return np.dtype(s)
    except TypeError:
        raise OrbaxFormatError(f"{what}: zarr dtype {s!r} is not read") from None


def _fill(value, dtype: np.dtype):
    if value is None:
        return None
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    return np.array(value).astype(dtype)


def read_zarr(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`: every chunk decompressed and
    placed; an absent chunk is the array's fill value, or an error if it
    has none."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise FileNotFoundError(f"zarr array {name!r}: no .zarray")
    meta = json.loads(raw)
    what = f"zarr array {name!r}"
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise OrbaxFormatError(f"{what}: only zarr v2 without filters is read")
    comp = (meta.get("compressor") or {}).get("id")
    if comp not in (None, "zstd"):
        raise OrbaxFormatError(f"{what}: compressor {comp!r} is not read")
    is_bf16 = meta["dtype"] == "bfloat16"
    dtype = _zarr_dtype(meta["dtype"], what)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep, order = meta.get("dimension_separator", "."), meta.get("order", "C")
    fill = _fill(meta.get("fill_value"), dtype)
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        blob = store.get(key)
        if blob is None:
            if fill is None:
                raise OrbaxFormatError(f"{what}: chunk {key!r} is missing and the array has no fill value")
            out[where] = fill
            continue
        data = zstd_decompress(blob, nbytes, f"chunk {key!r}") if comp else blob
        if len(data) != nbytes:
            raise OrbaxFormatError(f"chunk {key!r}: {len(data)} bytes, not the {nbytes} of a {chunks} chunk")
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    if is_bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out.astype(dtype.newbyteorder("="), copy=False)


# ---------------------------------------------------------------- the tree


class OrbaxCheckpoint:
    """One `step_*` directory of `ocp.StandardCheckpointer`."""

    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, "_METADATA")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"{path} is not an Orbax checkpoint: it has no _METADATA")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
            raise OrbaxFormatError(f"{meta_path}: only OCDBT checkpoints of zarr v2 arrays are read (orbax's default)")
        self.tree_metadata = meta["tree_metadata"]
        self.store = OcdbtStore(path)
        self.skipped: Dict[Tuple[str, ...], str] = {}

    def leaves(self):
        """(key path as (key, key_type) pairs, value metadata) of every leaf."""
        for entry in self.tree_metadata.values():
            yield [(k["key"], k["key_type"]) for k in entry["key_metadata"]], entry["value_metadata"]

    def array(self, keys: Iterable[str]) -> np.ndarray:
        return read_zarr(self.store, ".".join(keys))

    def tree(self, select: Optional[Iterable[str]] = None):
        """The saved tree (dicts; lists where the saved tree had sequences),
        only its top-level keys in `select` if given."""
        select = None if select is None else set(select)
        root: dict = {}
        for path, value in self.leaves():
            keys = tuple(k for k, _ in path)
            if select is not None and keys[0] not in select:
                continue
            vtype = value.get("value_type")
            if vtype in ARRAY_TYPES:
                leaf = self.array(keys)
                if vtype == "scalar":
                    leaf = leaf.item()
            elif vtype in EMPTY_VALUES:
                leaf = EMPTY_VALUES[vtype]() if EMPTY_VALUES[vtype] else None
            else:
                self.skipped[keys] = f"value type {vtype!r} is not an array"
                continue
            node = root
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return _containers(root)


def _containers(node):
    """{(key, key_type): ...} → dicts, and lists for key_type 1 (a sequence)."""
    if not isinstance(node, dict) or not node or not all(isinstance(k, tuple) for k in node):
        return node
    if all(kt == 1 for _, kt in node):
        return [_containers(node[k]) for k in sorted(node, key=lambda k: int(k[0]))]
    return {k: _containers(v) for (k, _), v in node.items()}


def is_orbax_step(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "_METADATA"))


def restore(path: str, select: Optional[Iterable[str]] = None):
    """The tree saved in the Orbax step directory `path` as nested dicts of
    numpy arrays (only the top-level keys in `select` if given)."""
    return OrbaxCheckpoint(path).tree(select)
