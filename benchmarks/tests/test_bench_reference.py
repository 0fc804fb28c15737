"""The plain reference's pieces against hand-worked cases: the merge of a
template into the query's columns, the ``.hhr`` parser, the bfloat16
rounding of the control, the single-sequence profile and the Viterbi of
a sequence against itself."""

import numpy as np
import pytest

import tiny  # noqa: F401  (puts benchmarks/ on the path)
from reference import check as C
from reference import plain


def test_merge_row_by_hand():
    # a path, end to start; the query has 6 columns
    path = [(5, 5), (4, 4), (3, 4), (2, 3), (2, 2), (1, 1)]
    # template column 2 meets query 2, column 3 stays in row 2 (an
    # insert), column 4 meets row 3 first, column 5 row 5 (row 4 a gap)
    assert plain.merge_row(path, "ABCDE", 6) == "ABcD-E-"


def test_merge_row_skipped_columns_are_gaps():
    path = [(6, 3), (3, 2), (2, 1)]
    assert plain.merge_row(path, "XYZ", 7) == "-XY--Z-"


HHR = """Query         q1
No Hit                             Prob E-value P-value  Score    SS Cols

No 1
>t1 fam tier0
Probab=99.50  E-value=1.2e-05  Score=42.37  Aligned_cols=4  Identities=50%
Q ss_pred             CCHH
Q q1              2 AC-DE    5 (9)
Q Consensus       2 ac~de    5 (9)
                    |  ||
T Consensus       7 aWkde   11 (20)
T t1              7 AWKDE   11 (20)
T ss_pred           CCHHH

No 2
>t2 fam tier3
Probab=20.00  E-value=3  Score=10.00  Aligned_cols=1  Identities=0%
Q q1              1 M    1 (9)
T t2              4 K    4 (8)
"""


def test_parse_hhr_by_hand():
    blocks = C.parse_hhr(HHR, "q1")
    assert set(blocks) == {1, 2}
    b = blocks[1]
    assert b["name"] == "t1"
    assert b["evalue"] == 1.2e-05 and b["score"] == 42.37
    # Q 2..5 "AC-DE", T 7..11 "AWKDE": A-A, C-W, D-D, E-E
    assert b["pairs"] == {(2, 7), (3, 8), (4, 10), (5, 11)}
    assert blocks[2]["pairs"] == {(1, 4)}


def test_bf16_by_hand():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -np.inf, 3.0e38])
    got = C.bf16(x)
    # 1 + 2^-8 is halfway: ties to even (1.0); 1 + 3 * 2^-8 rounds up
    assert got[0] == 1.0 and got[1] == 1.0
    assert got[2] == 1.0 + 2 ** -6
    assert got[3] == -np.inf and np.isfinite(got[4])


def test_single_sequence_profile():
    tab = plain.tables()
    e = plain.Entry("s", "s test", "ACDW", "CHHE", "9871")
    p = plain.profile(e, tab)
    assert p.L == 4 and p.neff == 1.0
    np.testing.assert_allclose(p.p.sum(axis=1), 1.0, rtol=1e-12)
    # one sequence: tau = 1 / (1 + 1 / 1.5) = 0.6 of substitution-matrix
    # pseudocounts, 0.4 of the residue itself
    a = plain.AA.index("W")
    assert p.p[4, a] == pytest.approx(0.4 + 0.6 * tab.R[a, a])
    # match to match is the likeliest transition of every inner column
    assert np.all(p.tr[1:4, plain.M2M] > p.tr[1:4, plain.M2I])
    assert list(p.ss_pred[1:5]) == [3, 1, 1, 2]
    assert list(p.ss_conf[1:5]) == [10, 9, 8, 2]


def test_viterbi_of_a_sequence_against_itself():
    tab = plain.tables()
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list(plain.AA), 60))
    e = plain.Entry("s", "s", seq)
    p = plain.profile(e, tab)
    h, = plain.viterbi(p, [p], tab)
    mm = h.states == plain.MM
    # the diagonal, end to end, every step a match
    assert mm.all() and (h.i == h.j).all()
    assert (h.i1, h.j1, h.i2, h.j2) == (1, 1, 60, 60)
    plain.calibrate([h], p, {"s": 1.0}, 100)
    assert h.score > 100 and h.evalue < 1e-20 and h.rank_key < -40
    (pairs, path), = plain.realign(p, [p], [h], tab)
    assert pairs == {(i, i) for i in range(1, 61)}
