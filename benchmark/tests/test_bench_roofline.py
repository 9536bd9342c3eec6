"""The kernels' byte and operation counts at tiny shapes, against counts
done by hand, and the bound they give."""

import pytest

from benchmark import roofline


def test_b1_bytes_by_hand():
    # S 27 offsets, br 3, nrb 10 block rows, t 12, f32: blocks 27·9·10 values,
    # x and y 12·3·10 values each
    assert roofline.stencil_bytes(27, 3, 10, 12) == 4 * (2430 + 360 + 360)
    assert roofline.stencil_flops(27, 3, 10, 12) == 2 * 2430 * 12


def test_b2a_bytes_by_hand():
    # the lane-major product of the LORASC path at t 1, f32 blocks and panel
    assert roofline.stencil_bytes(27, 3, 4, 1) == 4 * (27 * 9 * 4 + 2 * 3 * 4)
    # f64 blocks and panel: every value 8 bytes
    assert roofline.stencil_bytes(2, 3, 5, 2, 8, 8) == 8 * (2 * 9 * 5 + 2 * 2 * 3 * 5)


def test_ell_bytes_by_hand():
    # 6 rows of width 4 (values f32, int32 columns), panel t 2
    assert roofline.ell_bytes(6, 4, 2) == 6 * 4 * 8 + 2 * 6 * 2 * 4
    assert roofline.ell_flops(20, 2) == 80


def test_bound_takes_the_binding_side():
    op = {"s": 27, "br": 3, "nrb": 270400, "block_bytes": 4, "panel_bytes": 4}
    nbytes = roofline.stencil_bytes(27, 3, 270400, 12)
    # the stencil product is bound by its bytes at every width up to 256
    assert roofline.stencil_bound_s(op, 12) == pytest.approx(nbytes / 3.35e12)
    # operations bind a product with far more work than bytes
    assert roofline.bound_s(1, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(1, 34e12, value_bytes=8) == pytest.approx(1.0)
