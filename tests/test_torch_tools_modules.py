"""The port's host tool modules against the JAX package's, function by
function, on the fixture inputs the JAX package's own tests use
(tests/test_reformat.py, test_hhmakemodel.py, test_pdbtools.py,
test_scripts.py, test_hhsuitedb_repair.py).  Every comparison is exact:
the same values, the same bytes."""

import dataclasses
import os
import time

import pytest

from test_hhmakemodel import CIF
from test_pdbtools import MINI_CIF
from test_reformat import A3M

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _text(name):
    with open(os.path.join(FIX, name)) as f:
        return f.read()


# ------------------------------------------------------------ reformat

FORMATS = ("fas", "a2m", "a3m", "sto", "psi", "clu", "ufas")


def _input_in(fmt, src):
    """``src`` (a3m text) written in ``fmt`` by the JAX package's own
    writer, so both sides read the same bytes."""
    from hhsuite_tpu.tools.reformat import reformat

    return src if fmt == "a3m" else reformat(src, "a3m", fmt)


@pytest.mark.parametrize("pair", [(a, b) for a in FORMATS for b in FORMATS
                                  if a != "ufas"])
def test_reformat_format_pair(pair):
    """reformat in every pair of formats (ufas, unaligned, is an output
    only), on tests/test_reformat.py's MSA and on the query fixture."""
    from hhsuite_tpu.tools import reformat as J

    from hhsuite_tpu_torch.tools import reformat as P

    informat, outformat = pair
    for src in (A3M, _text("query.a3m")):
        text = _input_in(informat, src)
        want = J.reformat(text, informat, outformat)
        assert P.reformat(text, informat, outformat) == want
        assert P.read_msa(text, informat) == J.read_msa(text, informat)


@pytest.mark.parametrize("opts", [
    dict(remove_inserts=True, M="a3m"), dict(remove_gapped=30, M="a3m"),
    dict(gap="-"), dict(gap=""), dict(number=True), dict(case="uc"),
    dict(case="lc"), dict(desclen=4), dict(M="50"), dict(lname=10),
    dict(keep_sa=True), dict(noss=True)], ids=lambda o: "-".join(
        f"{k}={v}" for k, v in o.items()))
def test_reformat_options(opts):
    from hhsuite_tpu.tools.reformat import reformat as jax_reformat

    from hhsuite_tpu_torch.tools.reformat import reformat

    ss = ">ss_pred\nCCCHHH--\n>sa_dssp\nAABB-CC-\n>s1\nMKVQLA-G\n"
    for text, fmt, out in ((A3M, "a3m", "fas"), (A3M, "a3m", "sto"),
                           (ss, "fas", "fas")):
        assert reformat(text, fmt, out, **opts) == \
            jax_reformat(text, fmt, out, **opts)


# ------------------------------------------- hhr, hhmakemodel, hhpred

def _as_tuples(results):
    return [tuple(r) for r in results]


def test_read_result_golden_hhr():
    from hhsuite_tpu.io.hhr import read_result as jax_read

    from hhsuite_tpu_torch.io.hhr import parse_result, read_result

    path = os.path.join(FIX, "golden_hhsearch.hhr")
    got = read_result(path)
    assert len(got) > 1
    assert _as_tuples(got) == _as_tuples(jax_read(path))
    assert _as_tuples(parse_result(_text("golden_hhsearch.hhr")
                                   .splitlines())) == _as_tuples(got)


def _grid(mod, results, **kw):
    columns, qrow, rows = mod.build_grid(results, **kw)
    rendered = [mod.render_row(columns, r) for r in rows]
    trimmed = mod._trim_common_gaps(qrow, rendered)
    return (columns, qrow, [(tuple(r.hit), sorted(r.cells.items()),
                             r.pdb_code, r.chain) for r in rows],
            rendered, trimmed)


@pytest.mark.parametrize("kw", [{}, {"pick": [1, 3]}, {"e_thresh": 1e-3},
                                {"res_ratio": 0.5}],
                         ids=["all", "pick", "evalue", "ratio"])
def test_hhmakemodel_grid_and_pir(kw, tmp_path):
    from hhsuite_tpu.io.hhr import read_result as jax_read
    from hhsuite_tpu.tools import hhmakemodel as J

    from hhsuite_tpu_torch.io.hhr import read_result
    from hhsuite_tpu_torch.tools import hhmakemodel as P

    path = os.path.join(FIX, "golden_hhsearch.hhr")
    rj, rp = jax_read(path), read_result(path)
    want, got = _grid(J, rj, **kw), _grid(P, rp, **kw)
    assert got == want
    qrow, rendered = got[4]
    outs = {}
    for tag, mod, res in (("jax", J, rj), ("port", P, rp)):
        _c, _q, rows = mod.build_grid(res, **kw)
        pir = str(tmp_path / f"{tag}.pir")
        fas = str(tmp_path / f"{tag}.fas")
        mod.write_pir(pir, res[0].query_id, qrow, rows, rendered)
        mod.write_fasta(fas, res[0].query_id, qrow, rows, rendered)
        outs[tag] = (open(pir).read(), open(fas).read())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].startswith(">P1;")


@pytest.mark.parametrize("single", [False, True], ids=["multi", "single"])
def test_select_templates_from_atab(single):
    """hhpred's template selection (the scoring heuristic, or the single
    template pass) on golden_hhsearch.{hhr,atab}."""
    from hhsuite_tpu.io.hhr import read_result as jax_read
    from hhsuite_tpu.tools import hhpred as J

    from hhsuite_tpu_torch.io.hhr import read_result
    from hhsuite_tpu_torch.tools import hhpred as P

    path = os.path.join(FIX, "golden_hhsearch.hhr")
    atab = _text("golden_hhsearch.atab")
    rj, rp = jax_read(path), read_result(path)
    L = rj[0].query_length
    pj = J.parse_atab_posteriors(atab, L)
    pp = P.parse_atab_posteriors(atab, L)
    assert pp == pj and len(pp) >= len(rp)
    pj, pp = pj[:len(rj)], pp[:len(rp)]
    want = J._select_templates(rj, 4, 50.0, posteriors=pj, query_length=L,
                               single=single)
    got = P._select_templates(rp, 4, 50.0, posteriors=pp, query_length=L,
                              single=single)
    assert _as_tuples(got) == _as_tuples(want) and got
    assert P.choose_templates_scoring_heuristic(rp, pp, L, preselect=2) \
        == J.choose_templates_scoring_heuristic(rj, pj, L, preselect=2)
    # no posteriors: top-N by probability
    assert _as_tuples(P._select_templates(rp, 3, 50.0)) == \
        _as_tuples(J._select_templates(rj, 3, 50.0))


# ------------------------------------------------------- cif, pdbtools

@pytest.mark.parametrize("which", ["hhmakemodel", "pdbtools"])
def test_parse_cif_and_atoms(which):
    from hhsuite_tpu.io import cif as J

    from hhsuite_tpu_torch.io import cif as P

    text = CIF if which == "hhmakemodel" else MINI_CIF
    bj, bp = J.parse_cif(text), P.parse_cif(text)
    assert dataclasses.asdict(bp) == dataclasses.asdict(bj)
    recs = P.atom_records(bp)
    assert recs == J.atom_records(bj) and recs
    assert P.chain_sequence(recs, "A") == J.chain_sequence(recs, "A")
    assert P.write_atom_block("1abc_A", recs) == \
        J.write_atom_block("1abc_A", recs)
    assert P.THREE_TO_ONE == J.THREE_TO_ONE


def _run_both(name, argv_of, setup, tmp_path):
    """Run the JAX and the port function ``name`` of ``tools/<mod>`` on
    the same inputs in two directories; returns both trees."""
    import importlib

    mod, fn = name.split(".")
    trees = {}
    for side, pkg in (("jax", "hhsuite_tpu"), ("port", "hhsuite_tpu_torch")):
        d = tmp_path / side
        d.mkdir()
        setup(d)
        f = getattr(importlib.import_module(f"{pkg}.tools.{mod}"), fn)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            assert f(argv_of(d)) == 0
        finally:
            os.chdir(cwd)
        trees[side] = {os.path.relpath(os.path.join(r, x), d):
                       open(os.path.join(r, x), "rb").read()
                       for r, _ds, fs in os.walk(d) for x in fs}
    return trees


def _pdbtools_setup(d):
    (d / "cifs").mkdir()
    (d / "cifs" / "1abc.cif").write_text(MINI_CIF)
    (d / "in.fas").write_text(">X_A hdr\nACDE\n>Y_A hdr\nACDF\n"
                              ">Z_A hdr\nACDG\n")
    (d / "clu.tsv").write_text("X_A\tX_A\nX_A\tY_A\nX_A\tZ_A\n")
    (d / "anno.tsv").write_text("#h\nX_A\t2.5\t0.3\t0.90\tXRAY\n"
                                "Y_A\t1.2\t0.2\t0.80\tXRAY\n"
                                "Z_A\tN/A\tN/A\t0.99\tNMR\n")


@pytest.mark.parametrize("name,argv", [
    ("pdbtools.cif2fasta", ["-i", "cifs", "-o", "pdb.fas", "-p", "a.tsv"]),
    ("pdbtools.pdbfilter", ["in.fas", "clu.tsv", "anno.tsv", "f.fas"]),
], ids=["cif2fasta", "pdbfilter"])
def test_pdbtools_functions(name, argv, tmp_path):
    trees = _run_both(name, lambda d: list(argv), _pdbtools_setup, tmp_path)
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]) > 4


# ------------------------------------ addss, mergeali, A3MContainer, NW

def test_addss_horiz_and_insert_ss(tmp_path):
    from hhsuite_tpu.tools import addss as J

    from hhsuite_tpu_torch.tools import addss as P

    horiz = "Conf: 987654\nPred: CCHHEE\n  AA: ACDEFG\n"
    assert P.parse_horiz(horiz) == J.parse_horiz(horiz)

    def setup(d):
        (d / "q.a3m").write_text("#My MSA\n>s1 first\nACDEFG\n"
                                 ">s2\nAC-EFg-\n")
        (d / "q.horiz").write_text(horiz)

    trees = _run_both("addss.addss", lambda d: [
        "-i", "q.a3m", "-o", "out.a3m", "-horiz", "q.horiz"], setup,
        tmp_path)
    assert trees["port"] == trees["jax"]
    assert b">ss_pred" in trees["port"]["out.a3m"]
    q = _text("query.a3m")
    assert P.insert_ss(q, "H" * 431, "9" * 431) == \
        J.insert_ss(q, "H" * 431, "9" * 431)
    assert P.make_mtx(q) == J.make_mtx(q)


def test_mergeali(tmp_path):
    def setup(d):
        (d / "master.fas").write_text(">seedA\nACDEFG--\n>seedB\n--DEFGHI\n")
        (d / "seedA.a3m").write_text(
            ">seedA\nACDEFG\n>memberA1\nACDEFG\n>memberA2\nAC-EFG\n")
        (d / "seedB.a3m").write_text(">seedB\nDEFGHI\n>memberB1\nDEFaGHI\n")

    trees = _run_both("mergeali.mergeali", lambda d: [
        "-i", "master.fas", "-o", "merged.a3m", "-d", ".", "-name",
        "merged"], setup, tmp_path)
    assert trees["port"] == trees["jax"]
    assert trees["port"]["merged.a3m"].startswith(b"#merged\n")


@pytest.mark.parametrize("lines", [
    None,                                    # the query fixture
    ["#MyMSA", ">x_consensus", "ACDE", ">ss_pred", "CCHE", ">ss_conf",
     "9999", ">s1", "ACDE"],
    [">a", "ACDE", ">b", "ACD"],             # diverging match states
    [">ss_pred", "CCHE", ">ss_pred", "CCHE", ">s1", "ACDE"],
], ids=["query", "annotations", "diverging", "duplicate_ss"])
def test_a3m_container(lines):
    from hhsuite_tpu.tools import a3m_container as J

    from hhsuite_tpu_torch.tools import a3m_container as P

    lines = lines or _text("query.a3m").splitlines()
    out = {}
    for tag, mod in (("jax", J), ("port", P)):
        c = mod.A3MContainer()
        try:
            c.read_a3m_from_lines(list(lines))
            out[tag] = ("ok", c.number_sequences, c.nr_match_states,
                        c.annotations, c.consensus, str(c))
        except mod.A3MFormatError as e:
            out[tag] = ("error", str(e))
    assert out["port"] == out["jax"]


def test_align_identity():
    import numpy as np

    from hhsuite_tpu.tools.align_util import align_identity as J

    from hhsuite_tpu_torch.tools.align_util import align_identity as P

    rng = np.random.default_rng(17)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    for _ in range(8):
        x = "".join(rng.choice(aa, int(rng.integers(5, 40))))
        y = "".join(c for c in x if rng.random() > 0.2) + "".join(
            rng.choice(aa, 3))
        a, b = P(x, y), J(x, y)
        assert [list(v) if hasattr(v, "__len__") else v for v in a] == \
            [list(v) if hasattr(v, "__len__") else v for v in b]


# -------------------------------------------------------------- hhsuitedb

def _sub_msas(d):
    lines = _text("query.a3m").splitlines(keepends=True)
    hdr = [i for i, ln in enumerate(lines) if ln.startswith(">")]
    paths = []
    for k, (a, b) in enumerate([(0, 6), (6, 12), (12, 18)]):
        p = os.path.join(d, f"e{k}.a3m")
        with open(p, "w") as f:
            f.write("".join(lines[hdr[a]:hdr[b]]))
        paths.append(p)
    return paths


def _db_files(base):
    out = {}
    for s in ("a3m", "hhm", "cs219"):
        for e in ("ffdata", "ffindex"):
            p = f"{base}_{s}.{e}"
            if os.path.exists(p):
                out[f"{s}.{e}"] = open(p, "rb").read()
    return out


def _damage(base, case):
    """tests/test_hhsuitedb_repair.py's five cases, applied through the
    port's ffindex module (the bytes are the JAX module's: same files)."""
    from hhsuite_tpu_torch.io.ffindex import FFindexDatabase, FFindexWriter

    def entries(suffix):
        db = FFindexDatabase(f"{base}_{suffix}.ffdata",
                             f"{base}_{suffix}.ffindex")
        return {e.name: db.read_bytes(e) for e in db.entries}

    def rewrite(suffix, ents):
        with FFindexWriter(f"{base}_{suffix}.ffdata",
                           f"{base}_{suffix}.ffindex") as w:
            for name in sorted(ents):
                w.add(name, ents[name])

    if case == "unsorted":
        idx = f"{base}_cs219.ffindex"
        lines = open(idx).readlines()
        open(idx, "w").writelines(lines[::-1])
    elif case == "missing":
        ents = entries("cs219")
        del ents[sorted(ents)[1]]
        rewrite("cs219", ents)
    elif case == "overhead":
        ents = entries("cs219")
        ents["zzz_not_in_a3m"] = b"\x01\x02"
        rewrite("cs219", ents)
    elif case == "corrupted":
        ents = entries("a3m")
        ents[sorted(ents)[0]] = b">broken\nAC-D\n>other\nACD-EFG\n"
        rewrite("a3m", ents)


@pytest.mark.parametrize("case", ["clean", "unsorted", "missing",
                                  "overhead", "corrupted"])
def test_check_database_repair(case, tmp_path, monkeypatch):
    """check_database without and with --force on a damaged database:
    the same verdicts, log lines and repaired files in both packages."""
    from hhsuite_tpu.tools import hhsuitedb as J

    from hhsuite_tpu_torch.tools import hhsuitedb as P

    monkeypatch.setattr(time, "ctime", lambda *a: "Sun Oct 18 00:00:00 2026")
    msas = _sub_msas(str(tmp_path))
    result = {}
    for tag, mod in (("jax", J), ("port", P)):
        base = str(tmp_path / tag / "db")
        os.makedirs(os.path.dirname(base))
        logs = []
        mod.build_hhsuite_db(base, msas, threads=1, log=logs.append)
        built = _db_files(base)
        _damage(base, case)
        ok = mod.check_database(base, force=False, log=logs.append)
        fixed = mod.check_database(base, force=True, log=logs.append)
        again = mod.check_database(base, force=False, log=logs.append)
        logs = [ln.replace(str(tmp_path / tag), "<dir>") for ln in logs]
        result[tag] = (built, ok, fixed, again, logs, _db_files(base))
    assert result["port"] == result["jax"]
    assert result["port"][1] == (case == "clean")
    assert result["port"][3]


def test_hhsuitedb_pool_matches_serial(tmp_path, monkeypatch):
    """The port's spawn pool (two workers) builds the serial build's
    bytes, which are the JAX package's serial build's."""
    from hhsuite_tpu.tools.hhsuitedb import build_hhsuite_db as jax_build

    from hhsuite_tpu_torch.tools.hhsuitedb import build_hhsuite_db

    # the pool's workers are spawned: they see the real clock, so the
    # HHM DATE line is compared apart
    import re

    monkeypatch.setattr(time, "ctime", lambda *a: "Sun Oct 18 00:00:00 2026")
    msas = _sub_msas(str(tmp_path))
    for tag, fn, threads in (("jax", jax_build, 1), ("serial",
                             build_hhsuite_db, 1), ("pool",
                             build_hhsuite_db, 2)):
        fn(str(tmp_path / tag), msas, threads=threads, log=lambda *a: None)
    want = _db_files(str(tmp_path / "jax"))
    assert _db_files(str(tmp_path / "serial")) == want
    pool = _db_files(str(tmp_path / "pool"))
    date = re.compile(rb"\nDATE  [^\n]*\n")
    assert len(date.findall(pool["hhm.ffdata"])) == 1
    for files in (pool, want):
        files["hhm.ffdata"] = date.sub(b"\nDATE\n", files["hhm.ffdata"])
    assert pool == want
    assert set(want) == {f"{s}.{e}" for s in ("a3m", "hhm", "cs219")
                         for e in ("ffdata", "ffindex")}
