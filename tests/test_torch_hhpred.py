"""The port's ``hhpred`` (tools/hhpred.py) on the CPU, held to its own
stages and to the JAX package's selection and PIR writer.

From ``query.a3m`` (an MSA: the hhblits stage is skipped) against the
26-entry ``multi_*`` database: the ``.hhr`` equals the port's
``cmd_hhsearch`` run with hhpred's flags (``-mact 0.05 -atab``), and the
``.pir`` equals what the JAX package's template selection and
``hhmakemodel`` make of the port's ``.hhr`` and ``.atab``.  From the
query's first sequence (FASTA), against the golden single-entry
database, the hhblits stage runs first and ``-horiz`` gives addss its
prediction.
"""

import os
import shutil
import time

import pytest

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture
def cpu(monkeypatch):
    """The port on the CPU, on one torch thread: its plain versions gain
    nothing from more, and the test workers share the host's cores."""
    import torch

    from hhsuite_tpu_torch.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setattr(time, "ctime", lambda *a: "Sun Oct 18 00:00:00 2026")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _db(tmp_path, files):
    for src, dst in files.items():
        for e in ("ffdata", "ffindex"):
            shutil.copy(f"{FIX}/{src}.{e}", tmp_path / f"db_{dst}.{e}")
    return str(tmp_path / "db")


def _read(path):
    with open(path) as f:
        return f.read()


def _no_command(text):
    return [ln for ln in text.splitlines() if not ln.startswith("Command")]


def _jax_pir(hhr, atab, out, mult):
    """hhpred.pl's steps 4-5 by the JAX package: selection on the .hhr and
    .atab, then hhmakemodel -pir with the chosen ranks."""
    from hhsuite_tpu.io.hhr import read_result
    from hhsuite_tpu.tools.hhmakemodel import main as hhmakemodel_main
    from hhsuite_tpu.tools.hhpred import (_select_templates,
                                          parse_atab_posteriors)

    results = read_result(hhr)
    L = results[0].query_length
    posts = parse_atab_posteriors(_read(atab), L)[:len(results)]
    chosen = _select_templates(results, mult, 50.0, posteriors=posts,
                               query_length=L, single=(mult == 1))
    ranks = [results.index(c) + 1 for c in chosen]
    assert hhmakemodel_main(["-i", hhr, "-pir", out, "-m"]
                            + [str(r) for r in ranks]) == 0
    return _read(out)


def test_hhpred_a3m_to_pir(cpu, tmp_path):
    from hhsuite_tpu_torch.cli import cmd_hhsearch, main

    db = _db(tmp_path, {f"multi_{s}": s for s in ("a3m", "hhm", "cs219")})
    out = str(tmp_path / "out")
    assert main(["hhpred", "-i", f"{FIX}/query.a3m", "-o", out, "-d", db,
                 "-mult", "2"]) == 0
    # the hhsearch stage is the CLI's own hhsearch with hhpred's flags
    ref = str(tmp_path / "ref")
    assert cmd_hhsearch(["-i", out + ".a3m", "-d", db, "-o", ref + ".hhr",
                         "-atab", ref + ".atab", "-mact", "0.05"]) == 0
    # (the Command line names the output files)
    assert _no_command(_read(out + ".hhr")) == _no_command(
        _read(ref + ".hhr"))
    assert _read(out + ".atab") == _read(ref + ".atab")
    assert _read(out + ".a3m") == _read(f"{FIX}/query.a3m")
    pir = _read(out + ".pir")
    assert pir == _jax_pir(out + ".hhr", out + ".atab",
                           str(tmp_path / "jax.pir"), 2)
    # tests/test_hhpred_pipeline.py's structure checks
    assert pir.startswith(">P1;") and "sequence:" in pir
    assert pir.count("structureX:") >= 1 and pir.count("*") >= 2
    blocks = [b for b in pir.split(">P1;") if b.strip()]
    assert len({len("".join(b.splitlines()[2:])) for b in blocks}) == 1


def test_hhpred_sequence_to_pir(cpu, tmp_path):
    """A single sequence: hhblits (-n 1) builds the MSA, addss inserts
    the -horiz prediction, hhsearch scores with it (-ssm 2), one
    template is chosen.  The golden single-entry database (the query's
    own family) keeps the CPU run short."""
    from chip_smoke import _write_horiz
    from hhsuite_tpu_torch.cli import main
    from hhsuite_tpu_torch.tools.benchdb import predict_ss

    db = _db(tmp_path, {"single_a3m": "a3m", "single_hhm": "hhm",
                        "golden_single_cs219": "cs219"})
    lines = [ln for ln in _read(f"{FIX}/query.a3m").splitlines()
             if not ln.startswith("#")]
    seq = lines[1].replace("-", "").replace(".", "").upper()
    (tmp_path / "q.fas").write_text(f"{lines[0]}\n{seq}\n")
    _write_horiz(seq, str(tmp_path / "q.horiz"))
    pred = predict_ss(seq)[0]
    out = str(tmp_path / "sp")
    assert main(["hhpred", "-i", str(tmp_path / "q.fas"), "-o", out, "-d",
                 db, "-n", "1", "-mult", "1", "-horiz",
                 str(tmp_path / "q.horiz")]) == 0
    a3m = _read(out + ".a3m")
    assert a3m.startswith(">ss_pred")
    assert a3m.count(">") > 3              # the hhblits stage's MSA
    assert f"\n{pred[:100]}\n" in a3m    # addss wraps at 100
    hhr = _read(out + ".hhr")
    assert hhr.startswith(f"Query         {lines[0][1:]}"[:30])
    pir = _read(out + ".pir")
    assert pir.count("structureX:") == 1
    assert pir == _jax_pir(out + ".hhr", out + ".atab",
                           str(tmp_path / "jax.pir"), 1)
