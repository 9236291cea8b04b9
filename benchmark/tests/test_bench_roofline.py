"""The roofline's counts for the cells' shapes, from the shapes alone."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_image_batch_is_bound_by_the_f64_transform():
    b = roofline.image_encode(16, 912, 4096, stream_bytes=19.2e6)
    assert 16 * 233_472 * 544 == 2_032_140_288
    assert b["f64"] == pytest.approx(2_032_140_288 / 34e12)
    assert b["least_s"] == pytest.approx(59.77e-6, rel=1e-3)
    assert b["by"] == "f64"
    assert b["hbm"] == pytest.approx((59_768_832 + 19.2e6) / 3.35e12)


def test_video_encode_counts_the_search():
    b = roofline.video_encode(250, 720, 1280, 4, 16, stream_bytes=46e6)
    assert roofline.p_frames(250, 4) == 187
    assert roofline.search_levels(16) == 4
    sads = 187 * 3600 * 4 * 9 * 256
    assert b["int"] == pytest.approx((sads / 4 + 187 * 921_600) / 17e12)
    assert b["f64"] == pytest.approx(250 * 57_600 * 544 / 34e12)
    assert b["least_s"] == pytest.approx(230.4e-6, rel=1e-3)
    assert b["by"] == "f64"


def test_video_decode_adds_the_prediction():
    b = roofline.video_decode(250, 720, 1280, 4, stream_bytes=46e6)
    ops = 250 * 57_600 * 544 + 187 * 57_600 * 16
    assert b["f64"] == pytest.approx(ops / 34e12)
    assert b["least_s"] == pytest.approx(235.5e-6, rel=1e-3)
    assert b["hbm"] == pytest.approx((46e6 + 230_400_000) / 3.35e12)


def test_bound_is_the_largest_time():
    b = roofline.bound(3.35e12, 0, 0)
    assert b["least_s"] == pytest.approx(1.0) and b["by"] == "hbm"
