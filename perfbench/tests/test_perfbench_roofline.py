"""The frozen roofline arithmetic, pinned on the headline's shape."""

from harness import roofline


def test_bytes_of_the_headline_entries():
    # 399,682 packed entries, S = 6 states padded to 8: inv, ret, sufmin
    # and a transition row of 8, 4 bytes each, read once
    assert roofline.wgl_search_bytes(399_682, 8, 0, 0) == 17_586_008


def test_bytes_of_one_launch():
    # a launch of 64 rows over segments of 8,192 entries' padding
    # (max_iters = M + 4): rows' inputs and outputs, level series
    assert roofline.wgl_search_bytes(50_000, 8, 64, 8196) == (
        50_000 * 44 + 64 * 14 + 12 * 8196)


def test_least_time_at_the_published_peak():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert abs(roofline.least_seconds(17_586_008) - 5.2496e-6) < 1e-9
