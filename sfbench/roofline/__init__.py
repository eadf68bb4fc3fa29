"""The least time of a kernel's work on one NVIDIA H100: frozen counts of
bytes and operations from a launch's shapes, against the card's published
peaks.  The counts describe the work a launch does, whatever implements
it, so a kernel's share of its roofline reads the same work before and
after a change to the kernel.

Peaks: NVIDIA's H100 SXM data sheet at the full 700 W: HBM3 at 3.35 TB/s
and float32 at 67 TFLOP/s outside the tensor cores; the special-function
units (MUFU: exp2, rcp, ...) at 16 results per clock per SM (CUDA C++
Programming Guide, throughput table, compute capability 9.0) x 132 SMs x
the 1.98 GHz boost clock of the data sheet's peaks.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# K1 (the depth preprocessing kernel), flop per in-image tap of its 13x13
# bilateral stencil: difference, square, the exponent's FMA, expf counted
# as one, the two weighted sums (an FMA is 2).  Each tap's expf is also
# one special-function operation.
K1_RADIUS = 6
K1_FLOP_PER_TAP = 8
# K3 (the coupled IRLS solve), flop per pixel and iteration: pass 0
# (residuals 24 + 4, weights 10, weighted rows 14, normal equations 108)
# and pass 1 (residuals 26, sums 6); once per solve, the prologue's two
# sums.
K3_FLOP_PER_PIXEL_ITER = 160 + 32
K3_FLOP_PER_PIXEL_ONCE = 2
K3_CLUSTERS = 24


def least_seconds(nbytes: float, flop: float, sfu_ops: float = 0.0) -> tuple:
    """(seconds, bound_by): the larger of the bytes at the HBM peak and
    the operations at the float32 or special-function peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flop / FP32_FLOP_PER_S, sfu_ops / SFU_OPS_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bilateral_taps(rows: int, cols: int, r: int = K1_RADIUS) -> int:
    """In-image taps of a (2r+1)^2 stencil over a rows x cols image."""
    def per_axis(m):
        return sum(min(x + r, m - 1) - max(x - r, 0) + 1 for x in range(m))
    return per_axis(rows) * per_axis(cols)


def k1_seconds(rows: int, cols: int) -> float:
    """K1 over one rows x cols frame: reads the millimetre image once,
    writes the raw and the filtered metres."""
    taps = bilateral_taps(rows, cols)
    return least_seconds(3 * rows * cols * 4, K1_FLOP_PER_TAP * taps,
                         sfu_ops=taps)[0]


def k3_bytes(n: int) -> int:
    """Each input of one solve over n pixels read once (the two Jacobian
    rows of 6, B_c, B_d and the label per pixel; the per-cluster inputs
    and the regulariser; the two filter inputs) and its flat output of 75
    floats written once."""
    k = K3_CLUSTERS
    return 4 * (15 * n + 4 * k + k * k + 2 + 12 + 75)


def k3_seconds(n: int, iterations: int) -> float:
    """K3's least time for one solve over n pixels that ran `iterations`
    IRLS iterations."""
    flop = n * (K3_FLOP_PER_PIXEL_ONCE + iterations * K3_FLOP_PER_PIXEL_ITER)
    return least_seconds(k3_bytes(n), flop)[0]
