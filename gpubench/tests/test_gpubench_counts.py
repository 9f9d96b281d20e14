"""The operation and byte counts against counts made by hand."""

import pytest

from gpubench import counts
from gpubench.harness import Catalog

CAT = Catalog()


def hand_conv(ci, co, ext, k=27):
    return 2.0 * k * ci * co * ext**3


def test_baseline_forward_at_1024():
    cfg = CAT.config("baseline")
    # layers at the extents of one valid forward whose output is 1024^3:
    # dilations 1, 1, 2, 2 lose 2, 2, 4, 4 voxels a layer
    want = (hand_conv(1, 24, 1034) + hand_conv(24, 32, 1032)
            + hand_conv(32, 48, 1028) + hand_conv(48, 64, 1024)
            + hand_conv(64, 96, 1024, k=1) + hand_conv(96, 1, 1024, k=1))
    got = counts.forward_flops(cfg, 1024)
    assert got == pytest.approx(want, rel=1e-12)
    assert got / 1024**3 == pytest.approx(0.306e6, rel=2e-3)  # 0.306 MFLOP
    t, what = counts.forward_bound_s(cfg, 1024)
    assert what == "operations" and t == pytest.approx(want / 989e12)


def test_baseline_train_step():
    cfg = CAT.config("baseline")
    # patch 33 -> output 21; each layer 3x its forward, less layer 0's
    # input gradient
    fwd = [hand_conv(1, 24, 31), hand_conv(24, 32, 29), hand_conv(32, 48, 25),
           hand_conv(48, 64, 21), hand_conv(64, 96, 21, k=1),
           hand_conv(96, 1, 21, k=1)]
    want = 3 * sum(fwd) - fwd[0]
    assert counts.train_flops(cfg, 33) == pytest.approx(want, rel=1e-12)
    assert 32 * want == pytest.approx(0.382e12, rel=2e-3)


def test_forward_bytes():
    cfg = CAT.config("baseline")
    weights = 4 * sum(27 * ci * co + co for ci, co in
                      ((1, 24), (24, 32), (32, 48), (48, 64)))
    weights += 4 * (64 * 96 + 96 + 96 + 1)
    want = 1036**3 + 4 * 1024**3 + weights
    assert counts.forward_bytes(cfg, 1024) == pytest.approx(want, rel=1e-12)
