"""The operation counts of the reference at the cells' shapes."""
import pytest

from perfbench import flops

FULL = (1, 1, 128, 224, 288)


@pytest.mark.parametrize("arch", ["med3ddramtiny", "med3ddram",
                                  "med3ddram50"])
def test_analytic_sum_equals_the_flop_counter(arch):
    for train in (False, True):
        counted = flops.model_flops(arch, FULL, train)
        analytic = sum(op["flops"] for op in flops.conv_ops(arch, FULL,
                                                            train))
        assert analytic == pytest.approx(counted, rel=1e-12)


@pytest.mark.parametrize("arch,train,gflop", [
    ("med3ddram", False, 3341.6), ("med3ddram50", False, 3442.0),
    ("med3ddram50", True, 10237.9)])
def test_against_the_ports_complexity_tool(arch, train, gflop):
    # the port's tool also counts the decoder's linear resizes, which it
    # runs as matrix products (0.6-1.3% of the total); the reference's
    # resizes are interpolations and not counted
    counted = flops.model_flops(arch, FULL, train) / 1e9
    assert counted < gflop
    assert counted == pytest.approx(gflop, rel=0.015)


def test_conv_bytes_and_roofline():
    ops = flops.conv_ops("med3ddram", (2, 1, 128, 224, 288), False)
    stem = ops[0]
    assert stem["name"] == "conv1"
    assert stem["flops"] == 2.0 * 2 * 64 * 112 * 144 * 64 * 343
    assert stem["bytes"] == 2 * (2 * 128 * 224 * 288 + 64 * 343
                                 + 2 * 64 * 112 * 144 * 64)
    least, share = flops.roofline_seconds(ops, 989e12, 3.35e12)
    assert least >= sum(o["flops"] for o in ops) / 989e12
    assert 0.0 < share <= 1.0
    train = flops.conv_ops("med3ddram", (2, 1, 128, 224, 288), True)
    assert len(train) == 3 * len(ops) - 1     # no input gradient of conv1
