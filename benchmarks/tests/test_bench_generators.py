"""The generators are deterministic per seed and per db_seed, and every
seed gets the same sizes in another order."""

import os
from collections import Counter

import numpy as np
import pytest

import tiny  # noqa: F401  (puts benchmarks/ on the path)
from harness import dbgen
from harness.traffic import Stream

DB = {"families": 3, "members_per_family": 8, "L0": 60, "ss": True,
      "db_seed": 11}
DESC = {"query": "descendant", "sub_rate": 0.25, "indel_rate": 0.04,
        "ss": True, "clients": 2}
RAND = {"query": "random", "length_mix": [0.5, 1.0, 1.5], "ss": False,
        "clients": 2}


@pytest.mark.parametrize("traffic", [DESC, RAND], ids=["descendant",
                                                        "random"])
def test_stream_is_deterministic(traffic):
    a, b = Stream(traffic, DB, 2**31 + 11), Stream(traffic, DB, 2**31 + 11)
    for k in range(7):
        assert a.query(k) == b.query(k)
    assert [q.text for q in a.warmup(3)] == [q.text for q in b.warmup(3)]
    c = Stream(traffic, DB, 5)
    assert [a.query(k).text for k in range(6)] != \
        [c.query(k).text for k in range(6)]


def test_every_seed_gets_the_same_slots():
    for seed in (0, 1, 2**33 + 5):
        s = Stream(RAND, DB, seed)
        lens = Counter(s.query(k).length for k in range(6))
        assert lens == Counter({30: 2, 60: 2, 90: 2})


def test_warmup_apart_from_timed_stream():
    s = Stream(DESC, DB, 7)
    timed = {s.query(k).text for k in range(6)}
    assert not timed & {q.text for q in s.warmup(3)}


def test_queries_carry_ss_rows_when_asked():
    assert Stream(DESC, DB, 1).query(0).text.startswith(">ss_pred")
    assert Stream(RAND, DB, 1).query(0).text.startswith(">q000000")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_database_is_deterministic(tmp_path):
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    n1 = dbgen.build(DB, str(tmp_path / "a" / "db"))
    n2 = dbgen.build(DB, str(tmp_path / "b" / "db"))
    assert n1 == n2 == DB["families"] * DB["members_per_family"]
    for part in ("a3m", "cs219"):
        for ext in (".ffdata", ".ffindex"):
            assert _read(tmp_path / "a" / f"db_{part}{ext}") == \
                _read(tmp_path / "b" / f"db_{part}{ext}")
    # a second build finds the first
    assert dbgen.build(DB, str(tmp_path / "a" / "db")) == n1
    # one state a residue in the _cs219 records
    index = open(tmp_path / "a" / "db_cs219.ffindex").read().split()
    lens = {n: int(s) - 1 for n, _o, s in zip(index[::3], index[1::3],
                                             index[2::3])}
    assert lens == {n: len(s) for n, s, _d in dbgen.members(DB)}


def test_members_have_ss_rows_and_tiers():
    mem = dbgen.members(DB)
    assert len(mem) == 24
    assert Counter(d.split()[1] for _n, _s, d in mem)["tier7"] == 3
    text = dbgen.a3m_entry(*mem[0], True)
    pred, conf = dbgen.predict_ss(mem[0][1])
    assert f"\n{pred}\n" in text and f"\n{conf}\n" in text
    assert set(pred) <= set("HEC") and len(pred) == len(mem[0][1])
    assert np.all([c.isdigit() for c in conf])
