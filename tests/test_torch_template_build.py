"""The port's template build (a3m -> prepared template HMM:
``template_hmm_from_text`` then ``template_pc_stage``) against the JAX
package's, byte for byte, on single-sequence entries with predicted SS
like a PDB70 profile's, on the multi-sequence fixtures (the filter's
greedy selection and window scan), on entries short enough for the
first-sequence match states, and on an aligned FASTA whose match states
come from the gap share."""

import importlib
import os

import numpy as np
import pytest

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
AA = "ACDEFGHIKLMNPQRSTVWY"
ARRAYS = ("f", "g", "p", "tr", "Neff_M", "Neff_I", "Neff_D", "pav",
          "ss_pred", "ss_conf", "ss_dssp", "sa_dssp")
FIELDS = ("seq", "sname", "n_display", "nfirst", "ncons", "L")


def _ss_rows(rng, n):
    """Runs of H, E and C over n columns, and confidence digits."""
    ss = []
    while len(ss) < n:
        ss += rng.choice(list("HEC")) * int(rng.integers(2, 12))
    conf = "".join(rng.choice(list("0123456789"), n))
    return "".join(ss[:n]), conf


def _wrap(s, width):
    return "\n".join(s[i:i + width] for i in range(0, len(s), width))


def _single_entry(seed):
    """One PDB70-like entry: a sequence of 40-450 residues (a fragment
    or a duplication every few entries, with X, gaps and inserts in
    some), its >ss_pred and >ss_conf rows; a '#' name line and wrapped
    lines in some."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 451))
    seq = "".join(rng.choice(list(AA), n))
    if seed % 4 == 1:
        a = int(rng.integers(0, n // 2))
        seq = seq[a:a + max(40, n // 2)]
    elif seed % 4 == 2:
        seq = seq + seq[: len(seq) // 2]
    seq = list(seq)
    if seed % 3 == 0:
        for i in rng.choice(len(seq), 6, replace=False):
            seq[i] = rng.choice(list("X-"))
    match = "".join(seq)
    if seed % 5 == 0:          # a3m inserts: lowercase, not match states
        for i in sorted(rng.choice(len(seq), 4, replace=False))[::-1]:
            seq.insert(int(i), "".join(rng.choice(list(AA.lower()), 3)))
    ss, conf = _ss_rows(rng, len(match))
    width = 60 if seed % 2 else 100000
    name = f"t{seed:03d}_A"
    head = f"#{name} template {seed}\n" if seed % 6 == 0 else ""
    return (f"{head}>ss_pred PSIPRED predicted secondary structure\n"
            f"{_wrap(ss, width)}\n>ss_conf PSIPRED confidence values\n"
            f"{_wrap(conf, width)}\n>{name} family{seed % 7} tier{seed % 8}"
            f"\n{_wrap(''.join(seq), width)}\n")


def _short_entries():
    """Under 6 match states and one sequence: the first sequence's
    residues become the match states (hhalignment.cpp:838-850)."""
    return {"short_ss": ">ss_pred\nHHEC\n>ss_conf\n9876\n>s1 short\nMKVL\n",
            "short": ">s2 short\nMKV\n"}


def _aligned_fasta():
    """An aligned FASTA of 12 sequences whose gappy columns are no match
    states under -M 50 (lowercase letters and '.' in some rows)."""
    rng = np.random.default_rng(7)
    L = 90
    base = rng.choice(list(AA), L)
    gappy = rng.random(L) < 0.2
    rows = []
    for k in range(12):
        r = np.where(rng.random(L) < 0.15, rng.choice(list(AA), L), base)
        r = np.where(gappy & (rng.random(L) < 0.7), "-", r)
        r = np.where(rng.random(L) < 0.1, np.char.lower(r), r)
        r = np.where(gappy & (r == "-") & (rng.random(L) < 0.3), ".", r)
        if k:
            r[: int(rng.integers(0, 10))] = "-"
        rows.append(f">f{k} aligned\n" + "".join(r))
    return "\n".join(rows) + "\n"


def fragments_msa(seed, n=40, L=200):
    """An a3m of n fragments of a master of L residues at identities
    from 95% down to 30%, X in some, a few lowercase inserts: the
    filter's coverage windows, greedy order and windowed maxima all
    matter here."""
    rng = np.random.default_rng(seed)
    master = rng.choice(list(AA), L)
    # gaps in the master around columns where half the fragments have X:
    # an X is no column for the score per column's gap runs
    master[[50, 52, 90, 91, 93]] = "-"
    rows = [">master fragments\n" + "".join(master)]
    for k in range(n):
        a = int(rng.integers(0, L - 30))
        b = int(rng.integers(a + 30, L + 1))
        r = np.where(rng.random(L) < rng.uniform(0.05, 0.7),
                     rng.choice(list(AA), L), master)
        r = np.where(rng.random(L) < 0.03, "X", r)
        if k % 2:
            r[[51, 92]] = "X"
        r[:a] = "-"
        r[b:] = "-"
        r = list(r)
        if k % 4 == 0:
            i = int(rng.integers(a + 1, b))
            r[i] = r[i] + "".join(rng.choice(list(AA.lower()), 2))
        rows.append(f">frag{k} cover {a}-{b}\n" + "".join(r))
    return "\n".join(rows) + "\n"


def _odd_rows_entry():
    """The special rows with every character their tables know and some
    they drop: ss2ss's ~, I, i, X, x and '.', DSSP's S T G B, lowercase
    SS letters, a latin-1 digit (str.isdigit) in the confidences, blanks,
    a free-form >ss_ annotation (digits, '-', '.', A, B kept, non-ASCII
    digits among them), a skipped >aa_ row, and characters past 0xFF
    whose low byte the tables read (an SS letter, which ss2ss makes '-';
    a digit, dropped from the sequence)."""
    return (">ss_dssp DSSP\nHHH~IiSTGB..-XxCCEEhheeGGCCCCHHH\n"
            ">sa_dssp\nAABBCCDDEEFFaabb--..ccddeABCDEFABCDE\n"
            ">ss_pred\nHH~I iXx.-CCEEhhee cc EECCHHHHHH\u0148EEE\n"
            ">ss_conf\n12 345\u00b2678-.9012 34567890123\n"
            ">ss_custom free\nAB12-.zz\u0663AB\U0001d7d8AB9%AB\n"
            ">aa_skip\nACDEF\n"
            ">odd1 odd rows\nMKVLAAGHIK\u0130LMNPQRSTVWYACDE\n")


def _entries():
    out = {f"single{s:02d}": _single_entry(s) for s in range(24)}
    for f in ("query.a3m", "query_ss.a3m", "golden_neff3.a3m",
              "golden_hhalign_merge.a3m"):
        with open(os.path.join(FIX, f)) as fh:
            out[f] = fh.read()
    out.update(_short_entries())
    out["aligned_M2"] = _aligned_fasta()
    out["fragments"] = fragments_msa(3)
    out["odd_rows"] = _odd_rows_entry()
    return out


ENTRIES = _entries()
FLAGS = [(wg, sc, c) for wg in (0, 1) for sc in (0, 1) for c in (0, 1)]
CASES = [pytest.param(name, wg, sc, c, {},
                      id=f"{name}-wg{wg}-showcons{sc}-cons{c}")
         for name in ENTRIES for wg, sc, c in FLAGS]
# -id, -diff, -cov, -qid, -qsc away from their defaults
CASES += [pytest.param(
    name, 0, 1, 0,
    {"max_seqid": 60, "Ndiff": 5, "coverage": 30, "qid": 15, "qsc": 0.2},
    id=f"{name}-filters") for name in ("query_ss.a3m", "fragments")]


def _build(pkg, text, name, wg, showcons, cons, knobs):
    constants = importlib.import_module(pkg + ".constants")
    engine = importlib.import_module(pkg + ".search.engine")
    matrices = importlib.import_module(pkg + ".matrices")
    query = importlib.import_module(pkg + ".search.query")
    par = constants.Parameters.hhsearch_defaults()
    par.showcons, par.cons = showcons, cons
    if name == "aligned_M2":
        par.M_template = 2
    for k, v in knobs.items():
        setattr(par, k, v)
    mats = matrices.get_substitution_matrix(par.matrix)
    t, fmt = engine.template_hmm_from_text(text, name, par, mats, wg)
    query.template_pc_stage(par, t, mats, fmt)
    return t


@pytest.mark.parametrize("name,wg,showcons,cons,knobs", CASES)
def test_template_build_matches_jax(name, wg, showcons, cons, knobs):
    text = ENTRIES[name]
    got = _build("hhsuite_tpu_torch", text, name, wg, showcons, cons, knobs)
    want = _build("hhsuite_tpu", text, name, wg, showcons, cons, knobs)
    for a in ARRAYS:
        x, y = getattr(got, a), getattr(want, a)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), a
        assert x.tobytes() == y.tobytes(), a
    assert got.Neff_HMM == want.Neff_HMM
    assert type(got.Neff_HMM) is type(want.Neff_HMM)
    for a in FIELDS:
        assert getattr(got, a) == getattr(want, a), a


def _filtered(pkg, text, Ndiff, qsc):
    """The filter's keep flags, the display filter's flags and each
    sequence's score per column with the master (``_qsc_sum``)."""
    alignment = importlib.import_module(pkg + ".core.alignment")
    matrices = importlib.import_module(pkg + ".matrices")
    S = matrices.get_substitution_matrix(0).S
    ali = alignment.Alignment.from_a3m_text(text, infile="frag")
    ali.compress(M=1)
    ali.filter_for_display(90, 0, S, 0, 0, -20.0, 3)
    ali.filter(90, S, 20, 0, qsc, Ndiff)
    qsc_sums = [ali._qsc_sum(k, S) for k in range(ali.N_in)]
    return ali.keep.tolist(), ali.display.tolist(), qsc_sums


@pytest.mark.parametrize("Ndiff", [2, 5, 100])
@pytest.mark.parametrize("seed", range(4))
def test_filter_matches_jax(seed, Ndiff):
    """filter2's windowed maxima, greedy selection and score per column
    against the JAX package's on fragment MSAs, with -qsc off and on."""
    text = fragments_msa(100 + seed, n=30, L=120)
    for qsc in (-20.0, 0.5):
        assert (_filtered("hhsuite_tpu_torch", text, Ndiff, qsc)
                == _filtered("hhsuite_tpu", text, Ndiff, qsc))


@pytest.mark.parametrize("L", [1, 2, 7, 31, 32, 33, 49, 50, 51, 52, 77, 300])
def test_window_max(L):
    """Each column's window max equals the reference's loop over its
    clamped window (hhalignment.cpp:1816-1831), on random counts."""
    from hhsuite_tpu_torch.core.alignment import filter_windows, window_max

    W = 25
    npos = np.random.default_rng(L).integers(0, 9, L + 2).astype(np.int32)
    want = []
    for i in range(1, L + 1):
        j0 = max(1, min(L - 2 * W + 1, i - W))
        j1 = min(L, max(2 * W, i + W))
        want.append(int(npos[j0: j1 + 1].max()) if j1 >= j0 else 0)
    got = window_max(npos[1: L + 1], *filter_windows(L, W))
    assert got.tolist() == want


def test_build_timing_tool(tmp_path, capsys):
    """The build timer runs over a database's a3m entries and prints its
    JSON line."""
    import json
    import shutil

    from hhsuite_tpu_torch.tools import build_timing

    for ext in (".ffdata", ".ffindex"):
        shutil.copy(os.path.join(FIX, "multi_a3m" + ext),
                    tmp_path / ("db_a3m" + ext))
    out = build_timing.main(["-d", str(tmp_path / "db"), "-n", "4",
                             "-passes", "2", "-wg", "0"])
    assert json.loads(capsys.readouterr().out) == out
    assert (out["n"], out["wg"], len(out["passes"])) == (4, 0, 2)
    assert out["ms_a_build"] == min(out["passes"]) > 0
