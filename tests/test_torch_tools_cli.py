"""The port's tool commands against the JAX package's, on the CPU.

Each of the 35 commands that are not searches runs once through
``hhsuite_tpu.cli.main.main`` and once through ``hhsuite_tpu_torch.cli.
main``, each in a directory of its own that holds the same inputs and the
same relative argv: every file either run leaves behind, and its stdout,
must be byte-identical (``time.ctime`` is pinned, so the HHM ``DATE`` and
the ``.hhr`` ``Date`` lines agree too).  A second test holds the port's
commands to the reference binaries' goldens in ``tests/fixtures``, each
made by the command that made the golden.
"""

import os
import shutil
import time

import pytest

from test_hhmakemodel import CIF, HHR
from test_pdbtools import MINI_CIF, _pdb_line
from test_torch_tools_modules import _sub_msas

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _copy(d, *names, rename=None):
    for n in names:
        shutil.copy(os.path.join(FIX, n), os.path.join(d, n))
    for src, dst in (rename or {}).items():
        shutil.copy(os.path.join(FIX, src), os.path.join(d, dst))


def _copy_db(d, *bases, rename=None):
    for b in bases:
        _copy(d, b + ".ffdata", b + ".ffindex")
    for src, dst in (rename or {}).items():
        for ext in (".ffdata", ".ffindex"):
            shutil.copy(os.path.join(FIX, src + ext),
                        os.path.join(d, dst + ext))


def _write(d, name, text):
    path = os.path.join(d, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _small_ffindex(d, base="d"):
    from hhsuite_tpu_torch.io.ffindex import FFindexWriter

    with FFindexWriter(os.path.join(d, base + ".ffdata"),
                       os.path.join(d, base + ".ffindex")) as w:
        for name, text in (("alpha", "hello\n"), ("beta", "world\n"),
                           ("gamma", "third entry\n")):
            w.add(name, text.encode())


def _horiz(d, name, seq):
    """A PSIPRED .horiz file of ``seq`` (PSIPRED is not installed here):
    chip_smoke.py's, from the port's deterministic predictor."""
    from chip_smoke import _write_horiz

    _write_horiz(seq, os.path.join(d, name))


def _query_seq():
    with open(os.path.join(FIX, "query.a3m")) as f:
        lines = [ln for ln in f.read().splitlines()
                 if not ln.startswith("#")]
    return lines[1].replace("-", "").replace(".", "").upper()


def _setup_hhpred(d):
    _copy(d, "query.a3m")
    _copy_db(d, rename={"single_a3m": "db_a3m", "single_hhm": "db_hhm",
                        "golden_single_cs219": "db_cs219"})
    _horiz(d, "q.horiz", _query_seq())
    return ["hhpred", "-i", "query.a3m", "-o", "q", "-d", "db",
            "-horiz", "q.horiz", "-mult", "2"]


def _setup_renumberpdb(d):
    seq3 = ["ALA", "CYS", "ASP", "GLU", "PHE"]
    _write(d, "pdb/1tst.pdb", "\n".join(
        _pdb_line(k + 1, "CA", r3, "A", 101 + k, x=float(k))
        for k, r3 in enumerate(seq3)) + "\n")
    _write(d, "q.a3m", ">1tst_A test domain\nWACDEFY\n")
    return ["renumberpdb", "-o", "renum.pdb", "-pdb", "pdb", "q.a3m"]


def _setup_pdb2fasta(d):
    res3 = ("ALA CYS ASP GLU PHE GLY HIS ILE LYS LEU MET ASN PRO GLN "
            "ARG SER THR VAL TRP TYR").split()
    _write(d, "1xyz.pdb", "\n".join([
        "HEADER    TEST PROTEIN                            "
        "01-JAN-20   1XYZ",
        "SEQRES   1 A   20  " + " ".join(res3[:13]),
        "SEQRES   2 A   20  " + " ".join(res3[13:])]) + "\n")
    return ["pdb2fasta", "*.pdb", "out.fas"]


def _setup_pdbfilter(d):
    _write(d, "in.fas", ">X_A hdr\nACDE\n>Y_A hdr\nACDF\n>Z_A hdr\nACDG\n")
    _write(d, "clu.tsv", "X_A\tX_A\nX_A\tY_A\nX_A\tZ_A\n")
    _write(d, "anno.tsv", "#h\nX_A\t2.5\t0.3\t0.90\tXRAY\n"
           "Y_A\t1.2\t0.2\t0.80\tXRAY\nZ_A\tN/A\tN/A\t0.99\tNMR\n")
    return ["pdbfilter", "in.fas", "clu.tsv", "anno.tsv", "filtered.fas"]


def _setup_mergeali(d):
    _write(d, "master.fas", ">seedA\nACDEFG--\n>seedB\n--DEFGHI\n")
    _write(d, "seedA.a3m",
           ">seedA\nACDEFG\n>memberA1\nACDEFG\n>memberA2\nAC-EFG\n")
    _write(d, "seedB.a3m", ">seedB\nDEFGHI\n>memberB1\nDEFaGHI\n")
    return ["mergeali", "-i", "master.fas", "-o", "merged.a3m", "-d", ".",
            "-name", "merged"]


def _setup_hhmakemodel(d):
    _write(d, "r.hhr", HHR)
    _write(d, "cifs/1abc.cif", CIF)
    return ["hhmakemodel", "-i", "r.hhr", "-pir", "out.pir", "-fas",
            "out.fas", "-a3m", "out.a3m", "-cifs", "cifs", "-ocifs",
            "ocifs"]


def _setup_multithread(d):
    for k in range(3):
        _write(d, f"f{k}.txt", f"data{k}\n")
    return ["multithread", "*.txt", "cp $file $file.bak", "-cpu", "2"]


def _setup_a3m_database_extract(d):
    _copy_db(d, "golden_single_ca3m", "ca3m_seq", "ca3m_hdr")
    return ["a3m_database_extract", "-i", "golden_single_ca3m", "-o", "x",
            "-d", "ca3m_seq", "-q", "ca3m_hdr"]


# command -> setup(dir) that writes the inputs and returns the argv
CASES = {
    "hhmake": lambda d: (_copy(d, "query.a3m"),
                         ["hhmake", "-i", "query.a3m", "-o", "q.hhm"])[1],
    "hhfilter": lambda d: (_copy(d, "query.a3m"),
                           ["hhfilter", "-i", "query.a3m", "-o", "f.a3m",
                            "-id", "50", "-diff", "10"])[1],
    "hhconsensus": lambda d: (_copy(d, "query.a3m"),
                              ["hhconsensus", "-i", "query.a3m", "-s",
                               "cons.seq", "-oa3m", "cons.a3m"])[1],
    "cstranslate": lambda d: (_copy_db(d, "multi_a3m"),
                              ["cstranslate", "-f", "-i", "multi_a3m", "-o",
                               "cs", "-x", "0.3", "-c", "4", "-cpu",
                               "1"])[1],
    "ffindex_build": lambda d: (_write(d, "b.txt", "bee\n"),
                                _write(d, "a.txt", "ay\n"),
                                ["ffindex_build", "-s", "o.ffdata",
                                 "o.ffindex", "b.txt", "a.txt"])[2],
    "ffindex_get": lambda d: (_small_ffindex(d),
                              ["ffindex_get", "d.ffdata", "d.ffindex",
                               "gamma", "alpha"])[1],
    "ffindex_from_fasta": lambda d: (
        _write(d, "in.fasta", ">s1 first\nACDE\nFG\n>s2\nKLMN\n"),
        ["ffindex_from_fasta", "o.ffdata", "o.ffindex", "in.fasta"])[1],
    "a3m_database_reduce": lambda d: (
        _copy_db(d, "single_a3m", "ca3m_seq"),
        ["a3m_database_reduce", "-i", "single_a3m", "-o", "c", "-d",
         "ca3m_seq"])[1],
    "a3m_database_extract": _setup_a3m_database_extract,
    "a3m_database_filter": lambda d: (
        _copy_db(d, "multi_a3m"),
        _write(d, "keep.txt", "d03.a3m\nd01.a3m\nnot_there\n"),
        ["a3m_database_filter", "-i", "multi_a3m", "-o", "f", "-s",
         "keep.txt"])[2],
    "a3m_reduce": lambda d: (
        _copy(d, "query.a3m"), _copy_db(d, "ca3m_seq"),
        ["a3m_reduce", "-i", "query.a3m", "-o", "q.ca3m", "-d",
         "ca3m_seq"])[2],
    "a3m_extract": lambda d: (
        _copy_db(d, "ca3m_seq", "ca3m_hdr"),
        _copy(d, rename={"golden_single_ca3m.ffdata": "q.ca3m"}),
        ["a3m_extract", "-i", "q.ca3m", "-o", "q.a3m", "-d", "ca3m_seq",
         "-q", "ca3m_hdr"])[2],
    "hhsuitedb": lambda d: (_sub_msas(d),
                            ["hhsuitedb", "-o", "db", "--ia3m", "e*.a3m",
                             "--cpu", "1"])[1],
    "ffindex_reduce": lambda d: (
        _small_ffindex(d),
        ["ffindex_reduce", "d.ffdata", "d.ffindex", "sh", "-c",
         "cat >> sink.txt"])[1],
    "ffindex_from_fasta_with_split": lambda d: (
        _write(d, "in.fasta", ">sp|P12345|FIRST test protein\nACDEFG\n"
               "HIKLMN\n>plainname other\nPQRSTV\n"),
        ["ffindex_from_fasta_with_split", "-s", "h.ffdata", "h.ffindex",
         "s.ffdata", "s.ffindex", "in.fasta"])[1],
    "splitfasta": lambda d: (_write(d, "in.fas",
                                    ">s1 first\nACDE\nFGH\n>s2 x\nKLMN\n"),
                             ["splitfasta", "in.fas"])[1],
    "check_a3m": lambda d: (_copy(d, "query.a3m"),
                            ["check_a3m", "query.a3m"])[1],
    "get_a3m_size": lambda d: (_copy(d, "query.a3m"),
                               ["get_a3m_size", "query.a3m"])[1],
    "multithread": _setup_multithread,
    "create_profile_from_hhm": lambda d: (
        _copy(d, rename={"golden_hhmake_nocontxt.hhm": "q.hhm"}),
        ["create_profile_from_hhm", "-i", "q.hhm", "-o", "q.prf"])[1],
    "create_profile_from_hmmer": lambda d: (
        _copy(d, "hmmer3_model.hmm"),
        ["create_profile_from_hmmer", "-i", "hmmer3_model.hmm", "-o",
         "m.prf"])[1],
    "hh_reader": lambda d: (_copy(d, "golden_hhsearch.hhr"),
                            ["hh_reader", "golden_hhsearch.hhr"])[1],
    "cif2fasta": lambda d: (_write(d, "cifs/1abc.cif", MINI_CIF),
                            ["cif2fasta", "-i", "cifs", "-o", "pdb.fas",
                             "-p", "anno.tsv"])[1],
    "pdbfilter": _setup_pdbfilter,
    "pdb2fasta": _setup_pdb2fasta,
    "renumberpdb": _setup_renumberpdb,
    "mergeali": _setup_mergeali,
    "addss": lambda d: (_copy(d, "query.a3m"),
                        _horiz(d, "q.horiz", _query_seq()),
                        ["addss", "-i", "query.a3m", "-o", "ss.a3m",
                         "-horiz", "q.horiz"])[2],
    "hhpred": _setup_hhpred,
    "reformat": lambda d: (_copy(d, "query.a3m"),
                           ["reformat", "a3m", "clu", "-i", "query.a3m",
                            "-o", "q.clu"])[1],
    "ffindex_apply": lambda d: (
        _small_ffindex(d),
        ["ffindex_apply", "d.ffdata", "d.ffindex", "-d", "o.ffdata", "-i",
         "o.ffindex", "--", "tr", "a-z", "A-Z"])[1],
    "ffindex_modify": lambda d: (
        _small_ffindex(d), _write(d, "names.txt", "beta\n"),
        ["ffindex_modify", "-s", "-u", "-f", "names.txt", "d.ffindex"])[2],
    "ffindex_order": lambda d: (
        _small_ffindex(d), _write(d, "order.txt", "gamma\nalpha\nbeta\n"),
        ["ffindex_order", "order.txt", "d.ffdata", "d.ffindex",
         "o.ffdata", "o.ffindex"])[2],
    "ffindex_unpack": lambda d: (
        _small_ffindex(d),
        ["ffindex_unpack", "d.ffdata", "d.ffindex", "unpacked"])[1],
    "hhmakemodel": _setup_hhmakemodel,
}

# the searches the port had before (tests/test_torch_hh*.py, _batch.py)
SEARCHES = ("hhblits", "hhsearch", "hhalign", "hhblits_batch",
            "hhblits_ca3m")


def _tree(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


@pytest.fixture
def cpu_port(monkeypatch):
    """The port on the CPU, on one torch thread (the test workers share
    the host's cores), no profiler, ``time.ctime`` pinned."""
    import torch

    from hhsuite_tpu_torch.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("HHSUITE_TPU_PROFILE", raising=False)
    monkeypatch.delenv("HHSUITE_TPU_TORCH_PROFILE", raising=False)
    monkeypatch.setattr(time, "ctime", lambda *a: "Sun Oct 18 00:00:00 2026")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv, d, monkeypatch, capsys):
    monkeypatch.chdir(d)
    capsys.readouterr()
    rc = main(list(argv))
    return rc, capsys.readouterr().out


def test_commands_cover_the_reference():
    """The port's COMMANDS holds all 40 of the JAX package's, in its
    order; CASES covers every one that is not a search."""
    from hhsuite_tpu.cli.main import COMMANDS as JAX_COMMANDS

    from hhsuite_tpu_torch.cli import COMMANDS

    assert list(COMMANDS) == list(JAX_COMMANDS)
    assert sorted(CASES) == sorted(set(COMMANDS) - set(SEARCHES))
    assert len(CASES) == 35


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_command_matches_jax(cmd, tmp_path, monkeypatch, capsys, cpu_port):
    from hhsuite_tpu.cli.main import main as jax_main

    from hhsuite_tpu_torch.cli import main as port_main

    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        argv = CASES[cmd](str(d))
        dirs[side] = (str(d), argv)
    assert dirs["jax"][1] == dirs["port"][1]
    inputs = _tree(dirs["port"][0])
    rc_j, out_j = _run(jax_main, dirs["jax"][1], dirs["jax"][0],
                       monkeypatch, capsys)
    rc_p, out_p = _run(port_main, dirs["port"][1], dirs["port"][0],
                       monkeypatch, capsys)
    assert rc_p == rc_j == 0
    assert out_p == out_j
    got, want = _tree(dirs["port"][0]), _tree(dirs["jax"][0])
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        assert got[name] == want[name], name
    # every command but check_a3m (whose answer is its exit code) leaves
    # an output, a file or stdout, besides its inputs
    assert out_p or got != inputs or cmd == "check_a3m"


def test_cstranslate_pool_matches_serial(tmp_path, monkeypatch, capsys,
                                        cpu_port):
    """``cstranslate -f -cpu 3``: the port's spawn pool puts the entries
    back by position and writes the serial run's bytes (the JAX package's
    serial output is the CLI case above)."""
    from hhsuite_tpu_torch.cli import main as port_main

    _copy_db(str(tmp_path), "multi_a3m")
    outs = {}
    for cpu in ("1", "3"):
        argv = ["cstranslate", "-f", "-i", "multi_a3m", "-o", f"cs{cpu}",
                "-x", "0.3", "-c", "4", "-cpu", cpu]
        assert _run(port_main, argv, str(tmp_path), monkeypatch,
                    capsys)[0] == 0
        outs[cpu] = (_read(str(tmp_path / f"cs{cpu}.ffdata")),
                     _read(str(tmp_path / f"cs{cpu}.ffindex")))
    assert outs["3"] == outs["1"]
    assert outs["1"][1].count(b"\n") == 26


def _db_entries(base):
    from hhsuite_tpu_torch.io.ffindex import FFindexDatabase

    db = FFindexDatabase(base + ".ffdata", base + ".ffindex")
    return [(e.name, db.read_bytes(e)) for e in db.entries]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


CST = ["-A", "internal", "-D", "internal", "-x", "0.3", "-c", "4"]

# golden -> (setup(dir) writing the inputs and returning the argv, the
# output to hold, how: "file", "entries" (the ffindex entries' payloads),
# "entry" (the file against the golden ffindex's one entry),
# "prf" (tests/test_tools_pipeline.py's NAME normalisation) or "hhm"
# (tests/test_hhmake.py's tolerance: every value within one unit of
# 0.001 log2, more than 95% of lines identical, COM/DATE aside))
GOLDENS = {
    "cstranslate_crf.golden": (lambda d: (
        _copy(d, "cst_in.a3m", "crossval_syn.crf"),
        ["cstranslate", "-i", "cst_in.a3m", "-o", "out.as", "-A",
         "internal", "-D", "crossval_syn.crf", "-x", "0.3", "-c", "4", "-I",
         "a3m"])[1], "out.as", "file"),
    "cstranslate_fas_query.golden": (lambda d: (
        _copy(d, "cst_flat.fas"),
        ["cstranslate", "-i", "cst_flat.fas", "-o", "out.as", "-I",
         "fas"] + CST)[1], "out.as", "file"),
    "cstranslate_m20.golden": (lambda d: (
        _copy(d, "cst_flat.fas"),
        ["cstranslate", "-i", "cst_flat.fas", "-o", "out.as", "-M", "20",
         "-I", "fas"] + CST)[1], "out.as", "file"),
    "cstranslate_prf.golden": (lambda d: (
        _copy(d, "cst_in.a3m"),
        ["cstranslate", "-i", "cst_in.a3m", "-o", "out.as", "-O", "prf",
         "-I", "a3m"] + CST)[1], "out.as", "prf"),
    "golden_single_cs219": (lambda d: (
        _copy(d, "query.a3m"),
        ["cstranslate", "-i", "query.a3m", "-o", "q.cs219", "-x", "0.3",
         "-c", "4"])[1], "q.cs219", "entry"),
    "golden_single_cs219_nopc": (lambda d: (
        _copy(d, "query.a3m"),
        ["cstranslate", "-i", "query.a3m", "-o", "q.cs219", "-x",
         "0"])[1], "q.cs219", "entry"),
    "golden_hhmake_nocontxt.hhm": (lambda d: (
        _copy(d, "query.a3m"),
        ["hhmake", "-i", "query.a3m", "-o", "q.hhm", "-nocontxt"])[1],
        "q.hhm", "hhm"),
    "golden_neff3.a3m": (lambda d: (
        _copy(d, "query.a3m"),
        ["hhfilter", "-i", "query.a3m", "-o", "f.a3m", "-neff", "3"])[1],
        "f.a3m", "file"),
    "golden_ca3m_extract": (_setup_a3m_database_extract, "x", "entries"),
    "golden_single_ca3m": (lambda d: (
        _copy_db(d, "single_a3m", "ca3m_seq"),
        ["a3m_database_reduce", "-i", "single_a3m", "-o", "c", "-d",
         "ca3m_seq"])[1], "c", "entries"),
}


def _hhm_close(got: str, want: str):
    drop = ("COM", "DATE")
    g = [ln for ln in got.splitlines() if not ln.startswith(drop)]
    w = [ln for ln in want.splitlines() if not ln.startswith(drop)]
    assert len(g) == len(w)
    exact = 0
    for a, b in zip(g, w):
        if a == b:
            exact += 1
            continue
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), (a, b)
        for x, y in zip(ta, tb):
            if x != y:
                assert "*" not in (x, y), (a, b)
                assert abs(int(x) - int(y)) <= 1, (a, b)
    assert exact / len(w) > 0.95


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_command_matches_reference_golden(golden, tmp_path, monkeypatch,
                                          capsys, cpu_port):
    from hhsuite_tpu_torch.cli import main as port_main

    setup, out, how = GOLDENS[golden]
    argv = setup(str(tmp_path))
    rc, _ = _run(port_main, argv, str(tmp_path), monkeypatch, capsys)
    assert rc == 0
    got_path = os.path.join(str(tmp_path), out)
    want_path = os.path.join(FIX, golden)
    if how == "entry":
        assert [_read(got_path)] == [p for _n, p in _db_entries(want_path)]
    elif how == "entries":
        got = [p for _n, p in _db_entries(got_path)]
        want = [p for _n, p in _db_entries(want_path)]
        assert got == want
    elif how == "hhm":
        _hhm_close(_read(got_path).decode(), _read(want_path).decode())
    else:
        got, want = _read(got_path), _read(want_path)
        if how == "prf":
            # the golden's NAME line carries the reference's basename
            got = got.replace(b"NAME\tcst_i\n", b"")
            want = want.replace(b"NAME\tcst_i\n", b"")
        assert got == want


@pytest.mark.parametrize("traced", [False, True])
def test_profile_variable_writes_a_trace(traced, tmp_path, monkeypatch,
                                         capsys, cpu_port):
    """``HHSUITE_TPU_TORCH_PROFILE=<dir>``: the command's run leaves a
    torch.profiler Chrome trace there; without the variable, none."""
    from hhsuite_tpu_torch import profiling
    from hhsuite_tpu_torch.cli import main as port_main

    prof = tmp_path / "prof"
    if traced:
        monkeypatch.setenv(profiling.PROFILE_ENV, str(prof))
    work = tmp_path / "w"
    work.mkdir()
    argv = CASES["hhfilter"](str(work))
    rc, _ = _run(port_main, argv, str(work), monkeypatch, capsys)
    assert rc == 0
    assert (profiling.profile_dir() is not None) == traced
    files = sorted(os.listdir(prof)) if prof.exists() else []
    if traced:
        assert len(files) == 1 and files[0].startswith("trace-")
        assert _read(str(prof / files[0])).lstrip().startswith(b"{")
    else:
        assert files == []
