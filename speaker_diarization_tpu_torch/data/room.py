"""Image-source room acoustics + spherically isotropic noise.

A copy of speaker_diarization_tpu/data/room.py.

Reference: `source_md/libaueffect/room_simulators/genrir.py`
(RandomRirGenerator → pyrirgen image-source RIRs: sampled room geometry,
Sabine-validated T60, center/corner mic placement, speakers on an ellipse
with a minimum angular separation) and
`source_md/libaueffect/noise_generators/gensphnoise*.py` (spherical noise
fields for the mic array). The reference shells out to gpuRIR/pyrirgen;
here the Allen–Berkley image method is a vectorized NumPy routine — host
side, data-pipeline only, no device involvement.

Validation (tests/test_room.py): the Schroeder backward-integrated decay of
a generated RIR reproduces the requested T60 (Sabine), and the spherical
noise field's inter-mic coherence follows the theoretical
sinc(2·pi·f·d/c) curve of an isotropic field.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

SOUND_VELOCITY = 340.0
SABINE_K = 24.0 * math.log(10.0)  # 0.161·c when divided by c


def sabine_alpha(room: Sequence[float], t60: float, c: float = SOUND_VELOCITY) -> float:
    """Average wall absorption for a target T60 (Sabine's formula; the same
    validity expression genrir.py:109 checks before accepting a room)."""
    L = np.asarray(room, float)
    V = float(np.prod(L))
    S = 2.0 * float(L[0] * L[1] + L[0] * L[2] + L[1] * L[2])
    return SABINE_K * V / (c * S * t60)


def image_source_rir(
    room: Sequence[float],
    src: Sequence[float],
    mic: Sequence[float],
    t60: float,
    fs: int,
    c: float = SOUND_VELOCITY,
    rir_len: Optional[int] = None,
) -> np.ndarray:
    """Allen–Berkley image-method RIR for a shoebox room (mono mic).

    All six walls share the reflection coefficient beta = sqrt(1 - alpha)
    with alpha from Sabine — the same uniform-beta convention pyrirgen uses
    when called with reverbTime only (genrir.py:191).
    """
    L = np.asarray(room, float)
    s = np.asarray(src, float)
    r = np.asarray(mic, float)
    if np.any(s <= 0) or np.any(s >= L) or np.any(r <= 0) or np.any(r >= L):
        raise ValueError("source/mic must lie strictly inside the room")
    alpha = sabine_alpha(room, t60, c)
    if alpha >= 1.0:
        raise ValueError(f"T60 {t60}s unreachable in this room (Sabine alpha {alpha:.2f} >= 1)")
    beta = math.sqrt(1.0 - alpha)
    n = rir_len if rir_len is not None else int(t60 * fs)
    max_dist = c * n / fs

    # image lattice bounds per dimension
    order = [int(np.ceil(max_dist / (2 * L[d]))) + 1 for d in range(3)]
    axes_pos = []  # image coordinate per (dim, images)
    axes_ref = []  # reflection count per (dim, images)
    for d in range(3):
        ns = np.arange(-order[d], order[d] + 1)
        # Allen–Berkley images: x = (-1)^p s + 2nL, hitting the two walls
        # of this dimension |n - p| + |n| times in total
        pos, ref = [], []
        for p in (0, 1):
            coord = ((-1) ** p) * s[d] + 2 * ns * L[d]
            refl = np.abs(ns - p) + np.abs(ns)
            pos.append(coord)
            ref.append(refl)
        axes_pos.append(np.concatenate(pos))
        axes_ref.append(np.concatenate(ref))

    X, Y, Z = np.meshgrid(axes_pos[0], axes_pos[1], axes_pos[2], indexing="ij")
    RX, RY, RZ = np.meshgrid(axes_ref[0], axes_ref[1], axes_ref[2], indexing="ij")
    d = np.sqrt((X - r[0]) ** 2 + (Y - r[1]) ** 2 + (Z - r[2]) ** 2).ravel()
    refl = (RX + RY + RZ).ravel()

    keep = d < max_dist
    d, refl = d[keep], refl[keep]
    amp = beta ** refl / (4.0 * np.pi * np.maximum(d, 1e-3))
    # linear-interpolated fractional delay
    t = d / c * fs
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    h = np.zeros(n + 1, np.float64)
    valid = i0 < n
    np.add.at(h, i0[valid], amp[valid] * (1 - frac[valid]))
    np.add.at(h, i0[valid] + 1, amp[valid] * frac[valid])
    h = h[:n]
    peak = np.abs(h).max()
    return (h / peak if peak > 0 else h).astype(np.float32)


def measure_t60(h: np.ndarray, fs: int) -> float:
    """T60 from the Schroeder backward-integrated energy decay, fitted on
    the -5..-25 dB segment and extrapolated to -60 dB."""
    e = np.cumsum((h.astype(np.float64) ** 2)[::-1])[::-1]
    e = e / max(e[0], 1e-30)
    edc = 10.0 * np.log10(np.maximum(e, 1e-30))
    idx5 = np.argmax(edc <= -5.0)
    idx25 = np.argmax(edc <= -25.0)
    if idx25 <= idx5:
        return float(len(h) / fs)
    slope = (edc[idx25] - edc[idx5]) / ((idx25 - idx5) / fs)  # dB/s
    return float(-60.0 / slope)


@dataclass
class RoomSpec:
    room: Tuple[float, float, float]
    mic: Tuple[float, float, float]
    t60: float
    speakers: list  # (x, y, z) per speaker


class RandomRoomSimulator:
    """genrir.py RandomRirGenerator semantics: sample a shoebox room and T60
    (rejecting Sabine-invalid combos), place the mic near the room center,
    place speakers on a random ellipse around the mic with a minimum angular
    separation, and return one image-source RIR per speaker."""

    def __init__(
        self,
        fs: int,
        roomdim_range_x=(5.0, 10.0),
        roomdim_range_y=(5.0, 10.0),
        roomdim_range_z=(2.5, 4.5),
        roomcenter_mic_dist_max=0.5,
        micpos_range_z=(0.6, 0.9),
        spkr_mic_dist_range_x=(0.5, 4.0),
        spkr_mic_dist_range_y=(0.5, 4.0),
        spkr_height_range=(0.1, 0.5),
        t60_range=(0.1, 0.4),
        min_angle_diff=30.0,
        seed: int = 0,
    ):
        self.fs = fs
        self.rng = np.random.default_rng(seed)
        self.rx, self.ry, self.rz = roomdim_range_x, roomdim_range_y, roomdim_range_z
        self.mic_jitter = roomcenter_mic_dist_max
        self.mic_z = micpos_range_z
        self.sx, self.sy = spkr_mic_dist_range_x, spkr_mic_dist_range_y
        self.sz = spkr_height_range
        self.t60_range = t60_range
        self.min_angle = math.radians(min_angle_diff)

    def sample_room(self, n_speakers: int) -> RoomSpec:
        rng = self.rng
        while True:
            L = np.array([rng.uniform(*self.rx), rng.uniform(*self.ry), rng.uniform(*self.rz)])
            t60 = rng.uniform(*self.t60_range)
            if sabine_alpha(L, t60) < 1.0:
                break
        center = L / 2
        mic = np.array([
            center[0] + rng.uniform(-self.mic_jitter, self.mic_jitter),
            center[1] + rng.uniform(-self.mic_jitter, self.mic_jitter),
            rng.uniform(*self.mic_z),
        ])
        mic = np.clip(mic, 0.1, L - 0.1)
        ax = rng.uniform(*self.sx)
        ay = rng.uniform(*self.sy)
        base_h = rng.uniform(*self.sz)
        angles: list = []
        speakers = []
        for _ in range(n_speakers):
            for _trial in range(1000):
                theta = rng.uniform(0, 2 * np.pi)
                if any(
                    min(abs(theta - a), 2 * np.pi - abs(theta - a)) < self.min_angle
                    for a in angles
                ):
                    continue
                pos = mic + np.array([
                    ax * np.cos(theta), ay * np.sin(theta),
                    base_h + rng.uniform(-0.1, 0.1),
                ])
                if np.all(pos > 0.1) and np.all(pos < L - 0.1):
                    angles.append(theta)
                    speakers.append(tuple(pos))
                    break
            else:
                # crowded geometry: fall back to a nearby legal position
                speakers.append(tuple(np.clip(mic + np.array([0.5, 0.5, base_h]), 0.1, L - 0.1)))
        return RoomSpec(room=tuple(L), mic=tuple(mic), t60=t60, speakers=speakers)

    def rirs(self, n_speakers: int) -> list:
        spec = self.sample_room(n_speakers)
        return [
            image_source_rir(spec.room, s, spec.mic, spec.t60, self.fs)
            for s in spec.speakers
        ]


def spherical_noise(
    mic_positions: np.ndarray,
    n_samples: int,
    fs: int,
    n_directions: int = 64,
    c: float = SOUND_VELOCITY,
    seed: int = 0,
) -> np.ndarray:
    """Spherically isotropic noise field (gensphnoise semantics): a sum of
    independent white plane waves from uniformly distributed directions,
    delayed per microphone. (M, 3) mic coordinates → (M, n_samples); the
    inter-mic coherence approaches sinc(2 pi f d / c). Mono arrays reduce to
    plain white noise."""
    rng = np.random.default_rng(seed)
    M = mic_positions.shape[0]
    out = np.zeros((M, n_samples), np.float64)
    # Fibonacci sphere for uniform direction coverage
    i = np.arange(n_directions)
    phi = np.arccos(1 - 2 * (i + 0.5) / n_directions)
    theta = np.pi * (1 + 5**0.5) * i
    dirs = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1)
    pad = 64
    for k in range(n_directions):
        src = rng.standard_normal(n_samples + 2 * pad)
        delays = mic_positions @ dirs[k] / c * fs  # samples, can be negative
        for m in range(M):
            t = np.arange(n_samples) + pad + delays[m]
            i0 = np.floor(t).astype(np.int64)
            frac = t - i0
            out[m] += src[i0] * (1 - frac) + src[i0 + 1] * frac
    out /= np.sqrt(n_directions)
    return out.astype(np.float32)
