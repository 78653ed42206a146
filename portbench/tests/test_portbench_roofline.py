"""The work counts pinned to the closed forms of the port's kernel table
(PERF.md): K1 at config 2's shape, K4 and K5 at BA's main-path shape."""

import pytest

from portbench import roofline


def bound_ms(n_bytes, ops=0.0, peak=roofline.PEAK_FP32_FLOPS):
    return roofline.bound_s(n_bytes, ops, peak)[0] * 1e3


@pytest.mark.parametrize("fast, expect_ms", [(False, 0.5502), (True, 0.0373)])
def test_k1_bound_at_config2(fast, expect_ms):
    ops, n_bytes, peak = roofline.match_work([1500] * 64, [1500] * 64, 2048, 2048, 128, fast)
    assert ops == 64 * 1500**2 * 128 * 2
    t, by = roofline.bound_s(n_bytes, ops, peak)
    assert by == "operations"
    assert round(t * 1e3, 4) == expect_ms


def test_k4_bytes_at_ba_shape():
    # 17,788 x 9 rows into 8,192 segments.
    assert round(bound_ms(roofline.segsum_bytes(17788, 9, 8192)), 5) == 0.00029


def test_k5_bytes_at_ba_shape():
    # 17,788 sorted keys into an 8,192 x 3 table of which 5,025 rows are read.
    assert round(bound_ms(roofline.gather_bytes(17788, 3, 5025)), 5) == 0.00010


def test_bound_picks_the_larger():
    assert roofline.bound_s(3.35e12, 1.0)[1] == "bytes"
    assert roofline.bound_s(1.0, 67e12)[1] == "operations"


def test_match_work_needs_one_count_a_pair():
    with pytest.raises(ValueError):
        roofline.match_work([1], [1, 2], 8, 8, 128, False)
