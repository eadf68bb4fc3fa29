"""The frozen counts at the main path's shapes, against the bounds the
port's kernel table states (K1 3.031 us at 240x320, expf-bound; K3
1.38 us at N = 76800, bytes-bound)."""

import pytest

from sfbench import roofline


def test_k1_at_qvga():
    taps = roofline.bilateral_taps(240, 320)
    t, by = roofline.least_seconds(3 * 240 * 320 * 4, 8 * taps, taps)
    assert by == "operations"
    assert roofline.k1_seconds(240, 320) == t
    assert t * 1e6 == pytest.approx(3.031, abs=5e-4)


def test_k1_taps_cut_at_the_border():
    assert roofline.bilateral_taps(1, 1) == 1
    assert roofline.bilateral_taps(13, 13) == sum(
        min(x + 6, 12) - max(x - 6, 0) + 1 for x in range(13)) ** 2


@pytest.mark.parametrize("iterations", [1, 2, 6])
def test_k3_at_level_zero_is_bytes_bound(iterations):
    t, by = roofline.least_seconds(
        roofline.k3_bytes(76800),
        76800 * (2 + iterations * roofline.K3_FLOP_PER_PIXEL_ITER))
    assert by == "bytes"
    assert roofline.k3_seconds(76800, iterations) * 1e6 == pytest.approx(
        1.38, abs=5e-3)


def test_k3_is_bytes_bound_at_every_level():
    # 60 bytes a pixel against 192 flop an iteration: up to the solver's
    # 6 iterations the bytes bound every level's solve.
    for n in (76800, 19200, 4800, 1200, 300, 307200):
        assert roofline.k3_seconds(n, 6) == roofline.k3_seconds(n, 1)
