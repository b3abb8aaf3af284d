"""The kernels' counts reproduce hand-worked shapes."""
import pytest

from ldpc_bench.counts import bp_decode, pdhg_chunk
from ldpc_bench.counts.peaks import PEAKS, bound_s, peaks

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_pdhg_hand_worked_shape():
    """256 lanes x 64 steps x 256 x 280 at 4 operations an entry: 4.70
    GFLOP, 0.070 ms at 67 TFLOP/s (PERF.md's table of kernels)."""
    f = pdhg_chunk.flops(256, 64, 256, 280)
    assert f == pytest.approx(4.6976e9, rel=1e-4)
    t, what = bound_s(f, pdhg_chunk.bytes_moved(256, 256, 256, 280), H100)
    assert what == "operations"
    assert t * 1e3 == pytest.approx(0.0701, rel=1e-3)


def test_pdhg_counts_only_active_lanes():
    assert pdhg_chunk.flops(0, 64, 384, 280) == 0.0
    assert pdhg_chunk.flops(10, 64, 384, 280) == 10 * pdhg_chunk.flops(
        1, 64, 384, 280)
    # an inactive lane moves only its x and y
    assert pdhg_chunk.bytes_moved(0, 1, 128, 280) == 4 * 2 * (280 + 128)


def test_bp_counts_iterations_run():
    # 8192 lanes x 55 iterations x 900 edges x 12 operations
    assert bp_decode.flops(8192 * 55, 900) == 12 * 8192 * 55 * 900
    b = bp_decode.bytes_moved(8192, 280, 160, 6, 4)
    assert b == 8192 * (280 * 5 + 5) + (160 * 6 + 280 * 4) * 4
    t, what = bound_s(bp_decode.flops(8192 * 55, 900), b, H100)
    assert what == "operations" and t == pytest.approx(
        12 * 8192 * 55 * 900 / 67e12)


def test_bound_takes_the_larger_time():
    assert bound_s(0.0, 3.35e12, H100) == (1.0, "bytes")
    assert bound_s(67e12, 0.0, H100) == (1.0, "operations")


def test_peaks_by_device_name():
    assert peaks("NVIDIA H100 80GB HBM3") == H100
    assert peaks("cpu") is None
