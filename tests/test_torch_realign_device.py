"""The batched realign path (``PosteriorDecoder.realign_batch_device``,
ops/posterior_batch.py) through the port's ``run_hhsearch`` on the CPU,
forced by patching ``engine._use_device_realign`` (on the card it is
taken by the JAX package's rule), with the plain versions of R1-R4:

* the six-copy database (as tests/test_realign_device.py): the same MAC
  alignments as the port's host decoder, posteriors within f32
  tolerance, the restored search scores untouched;
* the 26-entry ``multi_*`` database (as
  tests/test_realign_device_output.py): the printed .hhr and m8 equal
  the host path's byte for byte, and equal the JAX package's forced
  device path's (the corridor through ``RealignMaskSpec`` and the
  interval mask builder, the walk through the packed payload);
* global mode (-glob) on both databases: the same alignments and printed
  output as the host decoder, every template padded to its chunk's
  width exiting through its own last column;
* secondary structure in the DP and the realign (``-ssm 2``) on a
  16-template ``build_ss_db`` database, local and -glob: the host
  decoder's alignments and printed .hhr and m8 (Sum_probs through the
  sums, within f32 tolerance);
* the routing rule itself: card, no -omat, at least 4 hits.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import hhsuite_tpu_torch.search.engine as eng
from hhsuite_tpu_torch.constants import Parameters
from hhsuite_tpu_torch.io.alignments import print_alignments
from hhsuite_tpu_torch.io.results import print_hit_list, print_m8
from hhsuite_tpu_torch.matrices import get_substitution_matrix

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def six_db(tmp_path_factory):
    """Six-copy database from the single-entry fixtures."""
    from hhsuite_tpu_torch.io.ffindex import FFindexDatabase, build_ffindex

    tmp = tmp_path_factory.mktemp("sixdb")
    for comp, src in [("a3m", "single_a3m"), ("hhm", "single_hhm"),
                      ("cs219", "golden_single_cs219")]:
        db = FFindexDatabase(os.path.join(FIX, src + ".ffdata"),
                             os.path.join(FIX, src + ".ffindex"))
        data = db.read_bytes(db.entries[0])
        build_ffindex(str(tmp / f"six_{comp}.ffdata"),
                      str(tmp / f"six_{comp}.ffindex"),
                      [(f"t{i}", data) for i in range(6)])
    return str(tmp / "six")


@pytest.fixture(scope="module")
def multi_db_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mdb_dev")
    for suffix in ("a3m", "hhm", "cs219"):
        for ext in ("ffdata", "ffindex"):
            shutil.copy(f"{FIX}/multi_{suffix}.{ext}",
                        tmp / f"multi_{suffix}.{ext}")
    return tmp


def _force(monkeypatch, device_path):
    monkeypatch.setattr(eng, "_use_device_realign",
                        lambda _par, _sel, _dev: device_path)


def _six(six_db, device_path, monkeypatch, loc=True):
    _force(monkeypatch, device_path)
    par = Parameters()
    par.nocontxt = True
    par.loc = loc
    with open(os.path.join(FIX, "query.a3m")) as f:
        query = f.read()
    q, hitlist = eng.run_hhsearch(par, query, eng.HHDatabase(six_db),
                                  "query.a3m", device="cpu")
    return list(hitlist)


def test_device_realign_matches_host(six_db, monkeypatch):
    _same_hits(_six(six_db, False, monkeypatch),
               _six(six_db, True, monkeypatch))


def test_device_realign_matches_host_global(six_db, monkeypatch):
    """-glob on the six copies (each shorter than its chunk's padded
    width): the same alignments as the host decoder, finite posteriors."""
    host = _six(six_db, False, monkeypatch, loc=False)
    _same_hits(host, _six(six_db, True, monkeypatch, loc=False))
    realigned = [h for h in host if h.P_posterior is not None]
    assert len(realigned) >= 6
    assert all(np.isfinite(np.asarray(h.P_posterior, np.float64)).all()
               and h.sum_of_probs > 1 for h in realigned)


def _same_hits(host, dev):
    assert len(host) == len(dev) and len(host) >= 6
    for hh, hd in zip(host, dev):
        assert str(hh.entry) == str(hd.entry) and hh.irep == hd.irep
        np.testing.assert_array_equal(hh.i, hd.i)
        np.testing.assert_array_equal(hh.j, hd.j)
        np.testing.assert_array_equal(hh.states, hd.states)
        assert hh.matched_cols == hd.matched_cols
        assert (hh.i1, hh.j1, hh.i2, hh.j2) == (hd.i1, hd.j1, hd.i2, hd.j2)
        if hh.P_posterior is None:
            assert hd.P_posterior is None
        else:
            assert hd.sum_of_probs == pytest.approx(hh.sum_of_probs,
                                                    rel=1e-3, abs=1e-2)
            np.testing.assert_allclose(hd.P_posterior, hh.P_posterior,
                                       rtol=5e-3, atol=1e-4)
        assert hd.score == pytest.approx(hh.score, rel=1e-6)
        assert hd.Probab == pytest.approx(hh.Probab, rel=1e-6)


def _render(par, q, hitlist, print_hit_list, print_alignments, print_m8,
            S):
    text = (print_hit_list(q, hitlist, par.maxdbstrlen, par.z, par.Z,
                           par.p, par.E, ["test"])
            + print_alignments(q, hitlist, par, S)
            + print_m8(q, hitlist, par.nseqdis, par.p, par.E))
    return re.sub(r"(?m)^(Date|Command).*$", "", text)


def _multi(tmp, device_path, monkeypatch, loc=True):
    _force(monkeypatch, device_path)
    par = Parameters()
    par.nocontxt = True
    par.loc = loc
    par.prefilter = False
    par.num_rounds = 1
    with open(f"{FIX}/query.a3m") as f:
        query = f.read()
    q, hitlist = eng.run_hhsearch(par, query,
                                  eng.HHDatabase(str(tmp / "multi")),
                                  "query.a3m", device="cpu")
    return _render(par, q, hitlist, print_hit_list, print_alignments,
                   print_m8, get_substitution_matrix(par.matrix).S)


def _host_and_device(multi_db_dir, loc):
    """The 26-entry search's printed output on the host decoder and on
    the forced batched path (which must have been taken)."""
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        batch = eng.PosteriorDecoder.realign_batch_device

        def counted(self, *a, **kw):
            calls.append(len(a[1]))
            return batch(self, *a, **kw)

        mp.setattr(eng.PosteriorDecoder, "realign_batch_device", counted)
        host = _multi(multi_db_dir, False, mp, loc)
        assert not calls
        dev = _multi(multi_db_dir, True, mp, loc)
        assert calls and sum(calls) >= 4
    return host, dev


@pytest.fixture(scope="module")
def multi_outputs(multi_db_dir):
    return _host_and_device(multi_db_dir, True)


def test_device_realign_printed_output_parity(multi_outputs):
    host, dev = multi_outputs
    assert "No 1" in host
    assert host == dev


def test_device_realign_printed_output_parity_global(multi_db_dir):
    host, dev = _host_and_device(multi_db_dir, False)
    assert "No 1" in host
    assert host == dev


@pytest.fixture(scope="module")
def ss_db(tmp_path_factory):
    """A 16-template family database with predicted SS rows
    (tools/benchdb.py:build_ss_db) and its SS-annotated query."""
    from hhsuite_tpu_torch.tools.benchdb import build_bench_db, build_ss_db

    tmp = tmp_path_factory.mktemp("ssdb_dev")
    fam = str(tmp / "fam")
    query = build_bench_db(fam, n_templates=16, L0=120, with_hhm=False)
    return str(tmp / "ss"), build_ss_db(str(tmp / "ss"), fam, query)


@pytest.mark.parametrize("loc", [True, False], ids=["local", "glob"])
def test_device_realign_printed_output_parity_ss(ss_db, loc):
    """-ssm 2: the forced batched path (SS factors in R1/R2) gives the
    host decoder's alignments and prints its .hhr and m8.  The printed
    Sum_probs are compared through the hits' sums, within
    :func:`_same_hits`' tolerance: the batched path sums the posteriors
    in f32, so a sum that lies on a rounding edge of its one decimal can
    print one digit apart (on this database 112.9 against 112.8 for a
    difference of 7e-5 in local mode)."""
    base, query = ss_db
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        batch = eng.PosteriorDecoder.realign_batch_device

        def counted(self, *a, **kw):
            calls.append(len(a[1]))
            return batch(self, *a, **kw)

        mp.setattr(eng.PosteriorDecoder, "realign_batch_device", counted)
        for device_path in (False, True):
            _force(mp, device_path)
            par = Parameters()
            par.nocontxt = True
            par.loc = loc
            par.prefilter = False
            par.num_rounds = 1
            q, hitlist = eng.run_hhsearch(par, query, eng.HHDatabase(base),
                                          "query.a3m", device="cpu")
            assert q.nss_pred >= 0 and par.ssm == 2
            text = _render(par, q, hitlist, print_hit_list,
                           print_alignments, print_m8,
                           get_substitution_matrix(par.matrix).S)
            runs.append((list(hitlist),
                         re.sub(r"Sum_probs=\S+", "Sum_probs=", text)))
            assert bool(calls) == device_path
        assert sum(calls) >= 4
    (host_hits, host), (dev_hits, dev) = runs
    _same_hits(host_hits, dev_hits)
    assert "No 1" in host and "Sum_probs=" in host
    assert host == dev


def test_device_realign_output_matches_jax(multi_db_dir, multi_outputs):
    """The JAX package's own forced device path prints the same text."""
    import hhsuite_tpu.search.engine as jeng
    from hhsuite_tpu.constants import Parameters as JParameters
    from hhsuite_tpu.io.alignments import print_alignments as j_ali
    from hhsuite_tpu.io.results import print_hit_list as j_list
    from hhsuite_tpu.io.results import print_m8 as j_m8
    from hhsuite_tpu.matrices import get_substitution_matrix as j_mats

    _host, dev = multi_outputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "_use_device_realign", lambda _par, _sel: True)
        par = JParameters()
        par.nocontxt = True
        par.prefilter = False
        par.num_rounds = 1
        with open(f"{FIX}/query.a3m") as f:
            query = f.read()
        q, hitlist = jeng.run_hhsearch(
            par, query, jeng.HHDatabase(str(multi_db_dir / "multi")),
            "query.a3m")
        want = _render(par, q, hitlist, j_list, j_ali, j_m8,
                       j_mats(par.matrix).S)
    assert dev == want


@pytest.mark.parametrize("dev,omat,n,want", [
    ("cuda", "", 4, True), ("cuda", "", 3, False), ("cuda", "m.bin", 9,
                                                    False),
    ("cpu", "", 9, False), (None, "", 9, False)])
def test_device_realign_rule(dev, omat, n, want):
    par = Parameters()
    par.matrices_output_file = omat
    device = torch.device(dev) if dev else None
    assert eng._use_device_realign(par, [object()] * n, device) is want
