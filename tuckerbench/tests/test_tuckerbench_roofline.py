"""The yardstick's counts: one operation counts the same whatever layout
carries it, the bound is the larger of bytes and operations, and the sweep
structure is the program's."""

import pytest

from _tiny import ROOT  # noqa: F401  (puts the repository on the path)

from tuckerbench import roofline


def test_the_bound_is_the_larger_one():
    # nell-2's Z-build reads more bytes than its products take time
    f, b = roofline.zbuild_counts(76_879_419, 3, 10, 10, 28_818,
                                  (12_092 + 9_184) * 10)
    assert roofline.least_ms(f, b)[1] == "bytes"
    # enron's, at K-hat = 1000, is bound by its operations
    f, b = roofline.zbuild_counts(54_202_099, 4, 100, 10, 244_268,
                                  (6_066 + 5_699 + 1_176) * 10)
    assert roofline.least_ms(f, b)[1] == "operations"
    assert roofline.least_ms(f, b)[0] == pytest.approx(
        1e3 * f / roofline.F32_FLOPS)


def test_a_product_counts_the_same_over_stacked_ranks():
    """One Z @ X over P ranks' stacked rows reads the same Z as over the
    unstacked rows; only the panel is read once per call either way."""
    whole = roofline.oracle_counts(4 * 3_000, 100, 8)
    assert whole == roofline.oracle_counts(12_000, 100, 8)
    f1, b1 = roofline.oracle_counts(1, 100, 8)
    assert f1 == 2 * 100 * 8 and b1 == 4 * (100 + 100 * 8 + 8)


def test_the_fused_build_adds_its_panel_product_only():
    plain = roofline.zbuild_counts(1_000, 3, 10, 10, 50, 700)
    fused = roofline.zbuild_counts(1_000, 3, 10, 10, 50, 700, s=8,
                                   rows_with_elements=40)
    assert fused[0] - plain[0] == 2 * 40 * 100 * 8
    assert fused[1] - plain[1] == 4 * (100 * 8 + 50 * 8)


def test_padding_counts_nothing():
    """Counts follow the real elements and rows: the same tensor in a
    padded plan counts what it counts unpadded."""
    builds = roofline.sweep_zbuilds((200, 150, 300), (10, 10, 10), 20_000,
                                    8, True, [210, 160, 310], [200, 150, 300])
    assert [b["E"] for b in builds] == [20_000] * 4
    assert builds[-1]["kind"] == "core" and builds[-1]["s"] == 0


@pytest.mark.parametrize("block,fused", [(1, False), (8, True), (4, False)])
def test_the_lanczos_structure_is_the_programs(block, fused):
    from repro_torch.core.lanczos import effective_block_size, lanczos_niter

    for k, L, K in [(10, 28_818, 100), (10, 6_066, 1000), (10, 12, 100)]:
        s, niter, blockish = roofline.lanczos_shape(k, L, K, block, fused)
        assert s == effective_block_size(k, L, K, block)
        assert niter == lanczos_niter(k, L, K, s if blockish else 1)
    calls = roofline.sweep_oracle_calls((28_818, 9_184, 12_092), (10,) * 3,
                                        block, fused, [1, 1, 1])
    per_mode = {(1, False): 40, (8, True): 5, (4, False): 10}[(block, fused)]
    assert [c["calls"] for c in calls] == [per_mode] * 3
