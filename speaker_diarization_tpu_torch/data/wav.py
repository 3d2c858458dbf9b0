"""WAV I/O with zero external dependencies (no soundfile/librosa).

Supports PCM 8/16/24/32-bit and IEEE float32/64 WAV, mono or multichannel,
partial reads (start/stop in samples), and Kaldi-style piped commands
('cmd ... |', reference kaldi_data.py:59-83). Returns float32 in [-1, 1]
or int16 raw, like soundfile.
"""

from __future__ import annotations

import io
import struct
import subprocess
from typing import Optional, Tuple

import numpy as np


def _parse_wav_header(f) -> dict:
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            data = f.read(csize)
            (audio_format, n_channels, sample_rate, _br, block_align, bits) = struct.unpack("<HHIIHH", data[:16])
            if audio_format == 0xFFFE and csize >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack("<H", data[24:26])[0]
            fmt = dict(
                format=audio_format,
                channels=n_channels,
                rate=sample_rate,
                block_align=block_align,
                bits=bits,
            )
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            fmt["data_offset"] = f.tell()
            fmt["data_size"] = csize
            return fmt
        else:
            f.seek(csize + (csize & 1), io.SEEK_CUR)


def _decode(raw: bytes, fmt: dict, dtype: str) -> np.ndarray:
    bits, afmt, ch = fmt["bits"], fmt["format"], fmt["channels"]
    if afmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2")
            scale = 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4")
            scale = 2147483648.0
        elif bits == 8:
            x = np.frombuffer(raw, dtype="u1").astype(np.int16) - 128
            scale = 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x << 8) >> 8  # sign-extend
            scale = 8388608.0
        else:
            raise ValueError(f"unsupported PCM bits: {bits}")
    elif afmt == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        scale = 1.0
    else:
        raise ValueError(f"unsupported WAV format code: {afmt}")

    if ch > 1:
        x = x.reshape(-1, ch)
    if dtype == "int16":
        if afmt == 3:
            return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
        if bits == 16:
            return x.astype(np.int16)
        return np.clip(x / scale * 32768.0, -32768, 32767).astype(np.int16)
    return (x / scale).astype(np.float32) if afmt == 1 else x.astype(np.float32)


def read_wav(
    path_or_bytes,
    start: int = 0,
    stop: Optional[int] = None,
    dtype: str = "float32",
) -> Tuple[np.ndarray, int]:
    """Read a WAV file (or raw bytes). Returns (samples, rate).

    start/stop are frame (per-channel sample) indices. Multichannel audio is
    returned as (n, channels).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(bytes(path_or_bytes))
        return _read_from(f, start, stop, dtype)
    with open(path_or_bytes, "rb") as f:
        return _read_from(f, start, stop, dtype)


def _read_from(f, start, stop, dtype):
    fmt = _parse_wav_header(f)
    ba = fmt["block_align"]
    n_total = fmt["data_size"] // ba
    start = max(0, min(start, n_total))
    stop = n_total if stop is None else max(start, min(stop, n_total))
    f.seek(fmt["data_offset"] + start * ba)
    raw = f.read((stop - start) * ba)
    return _decode(raw, fmt, dtype), fmt["rate"]


def wav_info(path) -> dict:
    """Header-only probe: rate, channels, frames, duration."""
    with open(path, "rb") as f:
        fmt = _parse_wav_header(f)
    frames = fmt["data_size"] // fmt["block_align"]
    return dict(rate=fmt["rate"], channels=fmt["channels"], frames=frames, duration=frames / fmt["rate"])


def write_wav(path, data: np.ndarray, rate: int, subtype: str = "PCM_16") -> None:
    """Write mono/multichannel WAV. data: float32 [-1,1] or int16."""
    data = np.asarray(data)
    ch = 1 if data.ndim == 1 else data.shape[1]
    if subtype == "PCM_16":
        if data.dtype != np.int16:
            data = np.clip(np.round(data * 32768.0), -32768, 32767).astype(np.int16)
        raw = data.astype("<i2").tobytes()
        bits, afmt = 16, 1
    elif subtype == "FLOAT":
        raw = data.astype("<f4").tobytes()
        bits, afmt = 32, 3
    else:
        raise ValueError(f"unsupported subtype: {subtype}")
    ba = ch * bits // 8
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(raw), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", afmt, ch, rate, rate * ba, ba, bits))
        f.write(struct.pack("<4sI", b"data", len(raw)))
        f.write(raw)


def load_wav_maybe_piped(
    wav_rxfilename: str, start: int = 0, stop: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """Kaldi-style extended filename read (reference kaldi_data.py:59-83).

    'cmd arg ... |' runs the command and reads WAV from stdout; '-' reads
    stdin; otherwise a plain path (partial read without full decode).
    """
    if wav_rxfilename.endswith("|"):
        p = subprocess.Popen(wav_rxfilename[:-1], shell=True, stdout=subprocess.PIPE)
        data, rate = read_wav(p.stdout.read())
        p.wait()
        if stop is not None or start:
            data = data[start:stop]
        return data, rate
    if wav_rxfilename == "-":
        import sys

        data, rate = read_wav(sys.stdin.buffer.read())
        if stop is not None or start:
            data = data[start:stop]
        return data, rate
    return read_wav(wav_rxfilename, start=start, stop=stop)
