"""The work counts against values worked by hand at one tiny shape:
n 4, degree 2, W 2, B 4, Z0 1, one burst."""
import pytest

from simbench import counts

SHAPE = dict(n=4, degree=2, max_walks=2, rt_bins=4, z0=1, bursts=1)


def test_peaks_and_block_cost():
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert counts.INT32_OPS_PER_S == pytest.approx(1.67270e13, rel=1e-5)
    assert counts.OPS_PER_BLOCK == 72 and counts.OPS_PER_WORD == 73


@pytest.mark.parametrize("alg,blocks,words", [("decafork", 19, 35), ("decafork+", 19, 35),
                                              ("missingperson", 17, 35)])
def test_words_drawn(alg, blocks, words):
    # keys 12 + burst fold 1 + topology split 4 (+ decision split 2); words:
    # hop 2, pfail 2, burst 2, Byzantine 1, nodes 8, edges 16, decision 4
    assert counts.words_drawn(SHAPE, alg) == (blocks, words)


def test_round_work():
    # walks 2*2*9 = 36, rows 1*(8+8+4) + 2*10 = 40, masks 2*(4+8) = 24,
    # outputs 20 + 2*5 = 30: 130 bytes; 19*72 + 35*73 = 3923 operations
    assert counts.round_work(SHAPE, "decafork", 1) == (130, 3923)
    assert counts.round_work(SHAPE, "missingperson", 3) == (390, 3 * (17 * 72 + 35 * 73))


def test_whole_round_work():
    # masks 8*10 + 4*11 = 124, walks 2*(9+16+4+12+8+4) = 106, rows 20
    assert counts.whole_round_work(SHAPE, 2) == (500, 48)


def test_least_seconds_takes_the_binding_peak():
    assert counts.least_seconds((3.35e12, 0)) == 1.0
    assert counts.least_seconds((0, counts.INT32_OPS_PER_S)) == 1.0
    assert counts.least_seconds((3.35e12, 2 * counts.INT32_OPS_PER_S)) == 2.0
