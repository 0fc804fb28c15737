"""``hhalign`` through the port on the CPU: ``python -m hhsuite_tpu_torch
hhalign -i query.a3m -t query.a3m`` against the reference's goldens, to
the tolerances of tests/test_hhalign_golden.py (the summary's Score
column within 0.2, alignment lines > 85% exact and the rest > 90% by
character, Sum_probs free) and the merged -oa3m byte for byte.  One hit,
so the realign runs on the host decoder on either device.
"""

import os
import re

import pytest

from hhsuite_tpu_torch.cli import main
from hhsuite_tpu_torch.device import DEVICE_ENV

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def hhalign_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hhalign")
    hhr, a3m = tmp / "out.hhr", tmp / "out.a3m"
    q = os.path.join(FIX, "query.a3m")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(DEVICE_ENV, "cpu")
        rc = main(["hhalign", "-i", q, "-t", q, "-nocontxt", "-o", str(hhr),
                   "-oa3m", str(a3m)])
    assert rc == 0
    return hhr.read_text(), a3m.read_text()


def _golden():
    with open(f"{FIX}/golden_hhalign_self.hhr") as f:
        return f.read()


def test_hhalign_summary(hhalign_outputs):
    got, _a3m = hhalign_outputs
    rows = [[ln for ln in text.splitlines() if re.match(r"\s*\d+ sp\|", ln)]
            for text in (got[: got.index("No 1")], _golden())]
    got_rows, want_rows = rows
    assert len(got_rows) == len(want_rows) == 1
    for g, w in zip(got_rows, want_rows):
        gt, wt = g.split(), w.split()
        assert len(gt) == len(wt)
        for a, b in zip(gt, wt):
            assert a == b or abs(float(a) - float(b)) < 0.2, (g, w)


def test_hhalign_blocks(hhalign_outputs):
    got, _a3m = hhalign_outputs
    want = _golden()
    got_l = got[got.index("No 1"):].splitlines()
    want_l = want[want.index("No 1"):].splitlines()
    assert len(got_l) == len(want_l)
    exact = 0
    for g, w in zip(got_l, want_l):
        if g == w:
            exact += 1
            continue
        if g.startswith("Probab="):
            assert (re.sub(r"Sum_probs=\S+", "", g)
                    == re.sub(r"Sum_probs=\S+", "", w)), (g, w)
            continue
        agree = sum(1 for a, b in zip(g, w) if a == b) / max(len(w), 1)
        assert agree > 0.9, (g, w)
    assert exact / len(want_l) > 0.85


def test_hhalign_oa3m_merge(hhalign_outputs):
    _hhr, got = hhalign_outputs
    with open(f"{FIX}/golden_hhalign_merge.a3m") as f:
        assert got == f.read()
