"""``hhblits`` end to end through the port on the CPU (plain versions of
the K1-K5 kernels, host realign, merge, writers).

* the golden single-entry database: ``-n 1`` blasttab byte-identical to
  the reference output; ``-n 2`` merged a3m and blasttab identical;
* the 26-entry database (``multi_*`` fixtures): the ``-n 2`` and
  ``-realign_old_hits`` goldens under the same comparison as
  tests/test_multidb_golden.py;
* a 16-template benchmark database: the same hit table as the JAX
  package's ``run_hhblits`` (correlation term off, see
  tests/test_torch_hhsearch.py), and split in two ``-d`` databases that
  find what the whole one finds;
* the CLI entry with ``HHSUITE_TPU_TORCH_DEVICE=cpu``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from hhsuite_tpu_torch.apps import write_alignment_a3m
from hhsuite_tpu_torch.constants import Parameters
from hhsuite_tpu_torch.io.ffindex import FFindexDatabase, FFindexWriter
from hhsuite_tpu_torch.io.results import print_hit_list, print_m8
from hhsuite_tpu_torch.search.engine import HHDatabase, open_databases
from hhsuite_tpu_torch.search.hhblits import run_hhblits
from test_multidb_golden import _m8_match, _summary_match

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions loop over small tensors and gain nothing from
    intra-op threads; one thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _query():
    with open(f"{FIX}/query.a3m") as f:
        return f.read()


def _golden(name):
    with open(f"{FIX}/{name}") as f:
        return f.read()


def _single_db(tmp):
    for src, dst in [("single_a3m", "single_a3m"),
                     ("single_hhm", "single_hhm"),
                     ("golden_single_cs219", "single_cs219")]:
        for ext in (".ffdata", ".ffindex"):
            shutil.copy(f"{FIX}/{src}{ext}", tmp / f"{dst}{ext}")
    return str(tmp / "single")


def _multi_db(tmp):
    for suffix in ("a3m", "hhm", "cs219"):
        for ext in ("ffdata", "ffindex"):
            shutil.copy(f"{FIX}/multi_{suffix}.{ext}",
                        tmp / f"multi_{suffix}.{ext}")
    return str(tmp / "multi")


def _blits(db, rounds, **kw):
    par = Parameters.hhblits_defaults()
    par.nocontxt = True
    par.num_rounds = rounds
    for k, v in kw.items():
        setattr(par, k, v)
    rounds_seen = []
    q, hitlist, qali = run_hhblits(par, _query(), db, "query.a3m",
                                   device="cpu", on_round=rounds_seen.append)
    return par, q, hitlist, qali, rounds_seen


@pytest.fixture(scope="module")
def single_base(tmp_path_factory):
    return _single_db(tmp_path_factory.mktemp("single"))


@pytest.fixture(scope="module")
def multi_base(tmp_path_factory):
    return _multi_db(tmp_path_factory.mktemp("multi"))


@pytest.fixture(scope="module")
def single_n1(single_base):
    return _blits(HHDatabase(single_base), 1)


def test_golden_n1_blasttab_byte_identical(single_n1):
    par, q, hitlist, _qali, rounds = single_n1
    got = print_m8(q, hitlist, nhits_min_b=par.b, p=par.p, E=par.E)
    assert got == _golden("golden_hhblits_n1.blasttab")
    assert rounds == [{"round": 1, "stage1": 1, "stage2": 1, "new": 1,
                       "old": 0, "searched": 1, "hits": 2}]


def test_golden_n1_consistent_with_hhsearch(single_n1):
    """data/test.sh:52: hhblits -n 1 and hhsearch agree on all blasttab
    columns except the E-value."""
    par, q, hitlist, _qali, _rounds = single_n1
    got = print_m8(q, hitlist, nhits_min_b=par.b, p=par.p, E=par.E)

    def strip_eval(text):
        return ["\t".join(ln.split("\t")[:10] + ln.split("\t")[11:])
                for ln in text.splitlines()]

    assert strip_eval(got) == strip_eval(_golden("golden_hhsearch.blasttab"))


def test_golden_n2_merged_msa(single_base):
    par, q, hitlist, qali, _rounds = _blits(HHDatabase(single_base), 2,
                                            alnfile="x")
    assert write_alignment_a3m(qali) == _golden("blits_n2.a3m")
    assert print_m8(q, hitlist, par.nseqdis, par.p, par.E) == \
        _golden("blits_n2.m8")


@pytest.fixture(scope="module")
def multi_n2(multi_base):
    """-n 2 with -norealign -premerge 0, the configuration of the
    reference goldens (tests/test_multidb_golden.py explains why)."""
    return _blits(HHDatabase(multi_base), 2, alnfile="x", realign=False,
                  premerge=0)


def test_multi_n2_m8_matches_golden(multi_n2):
    par, q, hitlist, _qali, rounds = multi_n2
    _m8_match(print_m8(q, hitlist, nhits_min_b=par.b, p=par.p, E=par.E),
              _golden("golden_multi_n2.m8"))
    assert [r["round"] for r in rounds] == [1, 2]
    assert rounds[1]["old"] > 0


def test_multi_n2_merged_msa(multi_n2):
    _par, _q, _hitlist, qali, _rounds = multi_n2
    assert write_alignment_a3m(qali) == _golden("golden_multi_n2.a3m")


def test_multi_n2_hhr_summary(multi_n2):
    par, q, hitlist, _qali, _rounds = multi_n2
    got = print_hit_list(q, hitlist, z=par.z, Z=par.Z, p=par.p, E=par.E,
                         datestr="X")
    want = _golden("golden_multi_n2.hhr").split("\nNo 1\n")[0] + "\n"
    _summary_match(got, want)


def test_multi_n2_realign_old_hits(multi_base):
    par, q, hitlist, _qali, _rounds = _blits(
        HHDatabase(multi_base), 2, realign_old_hits=True, realign=False,
        premerge=0)
    _m8_match(print_m8(q, hitlist, nhits_min_b=par.b, p=par.p, E=par.E),
              _golden("golden_multi_n2_rola.m8"))


@pytest.fixture(scope="module")
def bench16(tmp_path_factory):
    from hhsuite_tpu_torch.tools.benchdb import build_bench_db

    base = str(tmp_path_factory.mktemp("bench") / "b16")
    query = build_bench_db(base, n_templates=16, L0=120)
    return base, query


def test_two_databases_equal_one(tmp_path, bench16):
    """-d A -d B (a MultiHHDatabase, its cs219 pack cached on it) finds
    what the whole database finds."""
    base, query = bench16
    full = {}
    for suffix in ("a3m", "hhm", "cs219"):
        db = FFindexDatabase(f"{base}_{suffix}.ffdata",
                             f"{base}_{suffix}.ffindex")
        full[suffix] = [(e.name, db.read_bytes(e)) for e in db.entries]
    for tag, part in (("dbA", 0), ("dbB", 1)):
        for suffix in ("a3m", "hhm", "cs219"):
            with FFindexWriter(str(tmp_path / f"{tag}_{suffix}.ffdata"),
                               str(tmp_path / f"{tag}_{suffix}.ffindex")
                               ) as w:
                for k, (n, payload) in enumerate(full[suffix]):
                    if k % 2 == part:
                        w.add(n, payload)
    m8 = []
    for db in (open_databases([str(tmp_path / "dbA"), str(tmp_path / "dbB")]),
               HHDatabase(base)):
        par = Parameters.hhblits_defaults()
        q, hitlist, _qali = run_hhblits(par, query, db, "q", device="cpu")
        m8.append(print_m8(q, hitlist, nhits_min_b=par.b, p=par.p, E=par.E))
    assert sorted(m8[0].splitlines()) == sorted(m8[1].splitlines())
    assert len(m8[0].splitlines()) > 8
    assert "cpu" in db.__dict__["_cs219"]


def _table(hitlist):
    return [(str(h.entry), h.irep, h.i1, h.i2, h.j1, h.j2, h.score, h.Eval)
            for h in hitlist.hits]


def test_bench16_matches_jax(bench16):
    """Same hit table and merged MSA as the JAX package's run_hhblits
    (-n 2, context pseudocounts on), scores and E-values compared with
    the correlation term off (the profile dot's summation order can flip
    a tie between equal-scoring Viterbi paths, see
    tests/test_torch_hhsearch.py)."""
    from hhsuite_tpu.apps import write_alignment_a3m as jwrite
    from hhsuite_tpu.constants import Parameters as JParameters
    from hhsuite_tpu.search.engine import HHDatabase as JHHDatabase
    from hhsuite_tpu.search.hhblits import run_hhblits as jax_run_hhblits

    base, query = bench16
    par, jpar = Parameters.hhblits_defaults(), JParameters.hhblits_defaults()
    for p in (par, jpar):
        p.corr = 0.0
        p.alnfile = "x"
    _q, got, qali = run_hhblits(par, query, HHDatabase(base), "q",
                                device="cpu")
    _jq, want, jqali = jax_run_hhblits(jpar, query, JHHDatabase(base), "q")
    g, w = _table(got), _table(want)
    assert len(g) == len(w) > 8
    assert [x[:6] for x in g] == [x[:6] for x in w]
    np.testing.assert_allclose([x[6] for x in g], [x[6] for x in w],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose([x[7] for x in g], [x[7] for x in w],
                               rtol=1e-4)
    assert write_alignment_a3m(qali) == jwrite(jqali)


@pytest.mark.parametrize("rounds,flag,golden", [
    ("1", "-blasttab", "golden_hhblits_n1.blasttab"),
    ("2", "-oa3m", "blits_n2.a3m"),
])
def test_cli_entry_on_cpu(single_base, tmp_path, monkeypatch, rounds, flag,
                          golden):
    from hhsuite_tpu_torch.cli import main

    monkeypatch.setenv("HHSUITE_TPU_TORCH_DEVICE", "cpu")
    out = tmp_path / "out"
    rc = main(["hhblits", "-i", f"{FIX}/query.a3m", "-d", single_base,
               "-nocontxt", "-n", rounds, flag, str(out),
               "-o", str(tmp_path / "o.hhr")])
    assert rc == 0
    assert out.read_text() == _golden(golden)
    assert (tmp_path / "o.hhr").read_text().startswith("Query")


def test_run_hhblits_without_card_raises(monkeypatch, single_base):
    from hhsuite_tpu_torch.device import DEVICE_ENV

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_hhblits(Parameters.hhblits_defaults(), _query(),
                    HHDatabase(single_base))
