"""The frozen kernel counts reproduce the bounds the port's kernel table gives
at the main path's 64 × 4 s (K2 0.1191 ms, K3c 1.5045 ms)."""

import pytest

from benchmark.costs import kernels


def test_k2_bound_at_64_by_4s():
    # 64 windows of 4 s: 398 fbank frames, 199 CAM++ frames
    assert kernels.k2_bound_s(64, 199) * 1e3 == pytest.approx(0.1191, rel=1e-3)


def test_k3c_bound_at_64_by_4s():
    # 8 launches: 2 layers × 2 directions over 256 rows (single) and 64 rows (multi), 100 frames
    assert kernels.k3c_bound_s(256, 64, 100, 768, 64, 2) * 1e3 == pytest.approx(1.5045, rel=1e-3)


def test_bounds_scale_with_rows():
    assert kernels.k2_bound_s(512, 199) == pytest.approx(8 * kernels.k2_bound_s(64, 199), rel=1e-2)
    k3 = kernels.k3c_bound_s(512, 128, 200, 768, 64, 2)
    assert k3 == pytest.approx(4 * kernels.k3c_bound_s(256, 64, 100, 768, 64, 2), rel=1e-3)
