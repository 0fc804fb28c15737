"""The oracle: two golden searches on the card, held against the CPU
and against the reference binaries' outputs.

The port's counterpart of the JAX package's ``tools/tpu_check.py``.  It
runs the two oracle searches on the 26-entry multi-template database
(tests/fixtures/multi_*, built by make_multidb_fixtures.py with the
reference binaries) on the current device — the card by default — and
holds their outputs two ways:

* **exact_structural_vs_cpu** — the same searches in a subprocess on
  the CPU (the plain PyTorch version of every kernel, ``device="cpu"``)
  must give byte-identical outputs: hit tables, m8 rows, alignment
  blocks and the merged MSA, Date/Command lines aside.  The card has no
  reduced-precision product (TF32 is off, the kernels are built without
  FMA contraction), so no drift is tolerated;
* **reference goldens** — ``golden_multi_search.{blasttab,hhr}`` and
  ``golden_multi_n2.{m8,hhr}``: hit rows in order, structural columns
  byte-equal, statistics within a few units of their last printed digit,
  with the bounded near-tie exceptions of the comparators below (the
  reference binary and this code sum in different orders in places).

Oracle inputs: ``hhsearch`` with the prefilter off, and the full
iterative 2-round ``hhblits`` (prefilter, merge, old-hit rescoring;
``-norealign -premerge 0``, the reference-clean configuration of
tests/test_multidb_golden.py's n2 fixture).

    python -m hhsuite_tpu_torch.tools.gpu_check [-o verdict.json]

exits 0 when both tiers pass; :func:`run_check` returns the verdict.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile


def _fixture_dir():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "tests", "fixtures")


_MAX_PLATEAU_ROWS = 4     # tolerated plateau rows a table, at most


def _m8_rows_plateau(gt, wt):
    """True when two m8 rows describe the SAME hit up to a
    traceback-plateau flip: identical names, identity within 0.012,
    every count/coordinate column (length, mismatches, gapopens,
    q/t start/end) within 2 cells, stats within the drift window.
    The tolerance applies ONLY to these columns."""
    if len(gt) != 12 or len(wt) != 12 or gt[:2] != wt[:2]:
        return False
    try:
        if abs(float(gt[2]) - float(wt[2])) > 0.012:
            return False
        for a, b in zip(gt[3:10], wt[3:10]):
            if abs(int(a) - int(b)) > 2:
                return False
    except ValueError:
        return False
    return (_stat_close(gt[10], wt[10], exp_stat=True)[0]
            and _stat_close(gt[11], wt[11])[0])


def _m8_compare(got: str, want: str):
    """Ordered structural + stat comparison.  Row k must match row k
    byte-for-byte in the structural columns, with two bounded
    exceptions (float near-ties between the reference binary and this
    code, which sum in different orders in places, flip DP tie
    decisions on near-random decoy alignments, never on real homologs):

    * a single-cell..2-cell coordinate/count drift on the SAME hit
      (``_m8_rows_plateau``), or
    * an adjacent-row swap of near-tied hits (both rows match
      crosswise).

    At most ``_MAX_PLATEAU_ROWS`` rows may use either exception; more
    indicates a systematic regression, not float ties.  Returns a list
    of problems (empty = pass)."""
    problems = []
    plateau_rows = 0
    gl = [ln for ln in got.splitlines() if ln.strip()]
    wl = [ln for ln in want.splitlines() if ln.strip()]
    if len(gl) != len(wl):
        problems.append(f"row count {len(gl)} != {len(wl)}")
        return problems
    k = 0
    while k < len(gl):
        g, w = gl[k], wl[k]
        if g == w:
            k += 1
            continue
        gt, wt = g.split("\t"), w.split("\t")
        # stat-only drift (structural columns byte-equal): not counted
        # against the plateau cap
        if len(gt) == 12 and len(wt) == 12 and gt[:10] == wt[:10]:
            if not _stat_close(gt[10], wt[10], exp_stat=True)[0]:
                problems.append(
                    f"E-value drift {gt[10]} vs {wt[10]} at row {k}")
            if not _stat_close(gt[11], wt[11])[0]:
                problems.append(
                    f"bit score drift {gt[11]} vs {wt[11]} at row {k}")
            k += 1
            continue
        # adjacent near-tie swap: rows k,k+1 match crosswise
        if k + 1 < len(gl) and gl[k + 1] != wl[k + 1]:
            gt2 = gl[k + 1].split("\t")
            wt2 = wl[k + 1].split("\t")
            if (_m8_rows_plateau(gt, wt2)
                    and _m8_rows_plateau(gt2, wt)):
                plateau_rows += 2
                k += 2
                continue
        if _m8_rows_plateau(gt, wt):
            plateau_rows += 1
            k += 1
            continue
        problems.append(f"structural drift at row {k}: "
                        f"{g!r} vs {w!r}")
        k += 1
    if plateau_rows > _MAX_PLATEAU_ROWS:
        problems.append(f"{plateau_rows} plateau-drifted rows "
                        f"(max {_MAX_PLATEAU_ROWS}) — systematic "
                        f"drift, not float ties")
    return problems


# summary-row stat fields after the 37-char "No + Hit name" prefix:
# Prob E-value P-value Score SS Cols Query-range Template-range (L)
_STAT_FIELDS = 5      # Prob, E, P, Score, SS compared numerically


def _rng_plateau(a: str, b: str, tol: int = 2) -> bool:
    """Coordinate-range fields ("209-223", "(431)"): every embedded
    integer within ``tol``.  Applies ONLY to the known coordinate
    columns, not to arbitrary numeric fields."""
    pa = re.findall(r"-?\d+", a)
    pb = re.findall(r"-?\d+", b)
    return (len(pa) == len(pb) and bool(pa)
            and all(abs(int(x) - int(y)) <= tol
                    for x, y in zip(pa, pb)))


def _hhr_rows_plateau(g: str, w: str) -> bool:
    """Summary rows describe the same hit up to a plateau flip: name
    part byte-equal, stats within the drift window, Cols/ranges within
    2 cells."""
    if g[4:37] != w[4:37]:
        return False
    gt, wt = g[37:].split(), w[37:].split()
    if len(gt) != len(wt) or len(gt) < _STAT_FIELDS + 4:
        return False
    for fi, (a, b) in enumerate(zip(gt[:_STAT_FIELDS],
                                    wt[:_STAT_FIELDS])):
        if not _stat_close(a, b, exp_stat=fi in (1, 2))[0]:
            return False
    for a, b in zip(gt[_STAT_FIELDS:], wt[_STAT_FIELDS:]):
        if a != b and not _rng_plateau(a, b):
            return False
    return True


def _hhr_summary_compare(got: str, want: str):
    """Header fields exact (except Date/Command; Neff within 1e-3 —
    our weights pipeline rounds the last digit differently than the
    reference); summary rows IN ORDER with the rank+name prefix
    byte-equal and Prob/E/P/Score/SS compared numerically.  The same
    bounded plateau rules as ``_m8_compare`` apply: <=2-cell drift in
    the COORDINATE fields only, adjacent near-tie swaps, at most
    ``_MAX_PLATEAU_ROWS`` such rows."""
    problems = []

    def split(text):
        head, rows = [], []
        for ln in text.splitlines():
            if ln.startswith(("Date", "Command")) or not ln.strip():
                continue
            parts = ln.split()
            if parts and parts[0].isdigit() and len(parts) >= 8:
                rows.append(ln)
            else:
                head.append(ln)
        return head, rows

    gh, gr = split(got)
    wh, wr = split(want)
    if len(gh) != len(wh):
        problems.append(f"header line count {len(gh)} != {len(wh)}")
    for g, w in zip(gh, wh):
        if g == w:
            continue
        if g.startswith("Neff"):
            try:
                if abs(float(g.split()[1]) - float(w.split()[1])) \
                        >= 1e-3:
                    problems.append(f"Neff drift: {g!r} vs {w!r}")
            except (ValueError, IndexError):
                problems.append(f"Neff unparseable: {g!r}")
        else:
            problems.append(f"header mismatch: {g!r} vs {w!r}")
    if len(gr) != len(wr):
        problems.append(f"summary row count {len(gr)} != {len(wr)}")
        return problems
    plateau_rows = 0
    k = 0
    while k < len(gr):
        g, w = gr[k], wr[k]
        if g == w:
            k += 1
            continue
        # adjacent near-tie swap (rank is positional and excluded from
        # _hhr_rows_plateau's name window, so compare crosswise)
        if k + 1 < len(gr) and gr[k + 1] != wr[k + 1] \
                and _hhr_rows_plateau(g, wr[k + 1]) \
                and _hhr_rows_plateau(gr[k + 1], w):
            plateau_rows += 2
            k += 2
            continue
        if g[:37] != w[:37]:
            problems.append(f"rank/name drift at row {k}: "
                            f"{g[:37]!r} vs {w[:37]!r}")
            k += 1
            continue
        gt, wt = g[37:].split(), w[37:].split()
        if len(gt) != len(wt):
            problems.append(f"field count differs at row {k}")
            k += 1
            continue
        used_plateau = False
        for fi, (a, b) in enumerate(zip(gt, wt)):
            if a == b:
                continue
            if fi >= _STAT_FIELDS:
                if _rng_plateau(a, b):
                    used_plateau = True
                else:
                    problems.append(
                        f"structural drift at row {k}: {a} vs {b}")
                continue
            if not _stat_close(a, b, exp_stat=fi in (1, 2))[0]:
                problems.append(f"stat drift at row {k}: {a} vs {b}")
        plateau_rows += 1 if used_plateau else 0
        k += 1
    if plateau_rows > _MAX_PLATEAU_ROWS:
        problems.append(f"{plateau_rows} plateau-drifted rows "
                        f"(max {_MAX_PLATEAU_ROWS})")
    return problems


_DATE_RE = re.compile(r"(?m)^(Date|Command).*$")

# score-derived stat fields allowed to drift against the reference
# goldens: summary-row Prob/E/P/Score/SS, field by field
# |log-ratio| window for exp-amplified stats (E/P): a 2e-4-relative
# score drift on a 1000-bit hit moves E by up to ~exp(0.14)
_LOG_TOL = 0.2


def _print_unit(s: str) -> float:
    """One unit in the last printed digit of ``s`` ("961.0" -> 0.1,
    "4E-143" -> 1e-143, "1.3E-79" -> 1e-80)."""
    m = re.match(r"^-?(\d+)(?:\.(\d+))?(?:[eE]([+-]?\d+))?$", s)
    if not m:
        return 0.0
    dec = len(m.group(2) or "")
    exp = int(m.group(3) or 0)
    return 10.0 ** (exp - dec)


def _stat_close(a: str, b: str, exp_stat: bool = False,
                log_tol: float = _LOG_TOL):
    """Numeric equality up to float drift: a few units in the last
    PRINTED digit (single-digit E-value mantissas flip whole units on
    sub-percent drift); ``exp_stat`` stats (E/P-values, which amplify
    score drift through exp()) additionally get a log-ratio window.
    Returns (close, rel_drift)."""
    import math

    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return a == b, 0.0
    if fa == fb:
        return True, 0.0
    rel = abs(fa - fb) / max(abs(fb), 1e-300)
    unit = max(_print_unit(a), _print_unit(b))
    if abs(fa - fb) <= 4.000001 * unit:
        return True, rel
    if rel <= 1.2e-3:
        # high-precision prints (block-header Score=985.02) expose the
        # raw score drift itself
        return True, rel
    if exp_stat and fa > 0 and fb > 0 \
            and abs(math.log(fa / fb)) <= log_tol:
        return True, rel
    return False, rel


ORACLE_SEARCHES = ("hhsearch", "hhblits")


def oracle_outputs(fixtures: str | None = None, device=None,
                   searches=ORACLE_SEARCHES) -> dict:
    """Run the oracle searches (``searches``: both by default) on
    ``device`` (default: the card); return their rendered outputs:
    ``m8``, ``hhr`` (the hit table, Date pinned), ``blocks`` (the
    alignments) and ``n_hits`` of the ``hhsearch``; the same with
    ``_n2`` (``n_hits_blits_n2``) of the 2-round ``hhblits``, and its
    merged MSA ``a3m_n2``."""
    from ..apps import write_alignment_a3m
    from ..constants import Parameters
    from ..io.alignments import print_alignments
    from ..io.results import print_hit_list, print_m8
    from ..matrices import get_substitution_matrix
    from ..search.engine import HHDatabase, run_hhsearch
    from ..search.hhblits import run_hhblits

    fix = fixtures or _fixture_dir()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for suffix in ("a3m", "hhm", "cs219"):
            for ext in ("ffdata", "ffindex"):
                shutil.copy(f"{fix}/multi_{suffix}.{ext}",
                            f"{tmp}/multi_{suffix}.{ext}")
        with open(f"{fix}/query.a3m") as f:
            query = f.read()
        db = HHDatabase(f"{tmp}/multi")
        if "hhsearch" in searches:
            par = Parameters()
            par.nocontxt = True
            par.prefilter = False
            par.num_rounds = 1
            q, hitlist = run_hhsearch(par, query, db, "query.a3m",
                                      device=device)
            S = get_substitution_matrix(par.matrix).S
            out.update(
                m8=print_m8(q, hitlist, nhits_min_b=par.b, p=par.p,
                            E=par.E),
                hhr=print_hit_list(q, hitlist, z=par.z, Z=par.Z, p=par.p,
                                   E=par.E, datestr="X"),
                blocks=print_alignments(q, hitlist, par, S),
                n_hits=len(hitlist))
        if "hhblits" in searches:
            # the second oracle: the whole iterative pipeline —
            # prefilter funnel, 2 rounds, MSA merge, old-hit rescoring
            par2 = Parameters.hhblits_defaults()
            par2.nocontxt = True
            par2.num_rounds = 2
            par2.alnfile = "x"
            par2.realign = False
            par2.premerge = 0
            q2, hitlist2, qali2 = run_hhblits(par2, query, db, "query.a3m",
                                              device=device)
            S = get_substitution_matrix(par2.matrix).S
            out.update(
                m8_n2=print_m8(q2, hitlist2, nhits_min_b=par2.b, p=par2.p,
                               E=par2.E),
                hhr_n2=print_hit_list(q2, hitlist2, z=par2.z, Z=par2.Z,
                                      p=par2.p, E=par2.E, datestr="X"),
                blocks_n2=print_alignments(q2, hitlist2, par2, S),
                a3m_n2=write_alignment_a3m(qali2),
                n_hits_blits_n2=len(hitlist2))
    return out


_CPU_ORACLE = ("import json, sys; sys.path.insert(0, {repo!r});"
               "from hhsuite_tpu_torch.tools.gpu_check import oracle_outputs;"
               "print('ORACLE' + json.dumps(oracle_outputs(device='cpu')))")


def start_cpu_oracle() -> subprocess.Popen:
    """Start :func:`oracle_outputs` on the CPU in a fresh interpreter
    (one torch thread: the plain versions' small tensor ops run slower on
    more), so that it can run beside work on the card; :func:`run_check`
    takes the process."""
    from ..device import DEVICE_ENV

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, **{DEVICE_ENV: "cpu", "OMP_NUM_THREADS": "1"})
    return subprocess.Popen(
        [sys.executable, "-c", _CPU_ORACLE.format(repo=here)], cwd=here,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cpu_oracle_outputs(timeout: float = 1200, proc=None) -> dict | None:
    """The oracle outputs of the CPU run (``proc`` from
    :func:`start_cpu_oracle`, else started here); None when the
    subprocess fails."""
    proc = proc or start_cpu_oracle()
    try:
        out, _err = proc.communicate(timeout=timeout)
        line = [ln for ln in out.splitlines()
                if ln.startswith("ORACLE")][-1]
        return json.loads(line[len("ORACLE"):])
    except Exception:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        return None


def _first_difference(got: str, want: str) -> str | None:
    """None when the texts are byte-identical apart from Date/Command
    lines, else where they first differ."""
    gl = _DATE_RE.sub("", got).splitlines()
    wl = _DATE_RE.sub("", want).splitlines()
    for k, (g, w) in enumerate(zip(gl, wl)):
        if g != w:
            return f"line {k}: {g!r} vs {w!r}"
    if len(gl) != len(wl):
        return f"{len(gl)} lines vs {len(wl)}"
    return None


EXACT_KEYS = ("m8", "hhr", "blocks", "m8_n2", "hhr_n2", "blocks_n2",
              "a3m_n2")


def golden_problems(outs: dict, fixtures: str | None = None) -> dict:
    """The golden tier: the oracle outputs ``outs`` against the
    reference binaries' outputs; {"m8": [...], "hhr": [...],
    "blits_n2": [...]} lists of problems (empty lists: pass)."""
    fix = fixtures or _fixture_dir()

    def summary(text):
        return text.split("\nNo 1\n")[0] + "\n"

    with open(f"{fix}/golden_multi_search.blasttab") as f:
        m8_problems = _m8_compare(outs["m8"], f.read())
    with open(f"{fix}/golden_multi_search.hhr") as f:
        hhr_problems = _hhr_summary_compare(summary(outs["hhr"]),
                                            summary(f.read()))
    with open(f"{fix}/golden_multi_n2.m8") as f:
        n2_problems = _m8_compare(outs["m8_n2"], f.read())
    with open(f"{fix}/golden_multi_n2.hhr") as f:
        n2_problems += _hhr_summary_compare(summary(outs["hhr_n2"]),
                                            summary(f.read()))
    return {"m8": m8_problems, "hhr": hhr_problems,
            "blits_n2": n2_problems}


def run_check(fixtures: str | None = None, device=None,
              cpu_proc=None) -> dict:
    """Run the golden searches on ``device`` (default: the card) and
    return the verdict: device, devices, pass (bool), exact_vs_cpu
    (bool, None on the CPU), the golden tier's problems, the hit counts.
    ``cpu_proc``: a :func:`start_cpu_oracle` process already running.
    Raises nothing: a crash is folded into the verdict."""
    import torch

    from ..device import resolve_device

    info = {"oracle": ("multi_* 26-entry database: hhsearch + 2-round "
                       "hhblits; reference goldens (structural rows "
                       "exact) + byte identity with the CPU run")}
    try:
        dev = resolve_device(device)
        info.update(device=str(dev), devices=(
            [torch.cuda.get_device_name(k)
             for k in range(torch.cuda.device_count())]
            if dev.type == "cuda" else ["cpu"]))
        fix = fixtures or _fixture_dir()
        outs = oracle_outputs(fix, device=dev)
        golden = golden_problems(outs, fix)
        exact = None
        exact_problems: list = []
        if dev.type != "cpu":
            cpu = _cpu_oracle_outputs(proc=cpu_proc)
            if cpu is None:
                exact = False
                exact_problems.append("cpu subprocess failed")
            else:
                for key in EXACT_KEYS:
                    where = _first_difference(outs[key], cpu[key])
                    if where is not None:
                        exact_problems.append(f"{key}: {where}")
                for key in ("n_hits", "n_hits_blits_n2"):
                    if outs[key] != cpu[key]:
                        exact_problems.append(
                            f"{key}: {outs[key]} vs {cpu[key]}")
                exact = not exact_problems
        elif cpu_proc is not None and cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
        info.update({
            "n_hits": outs["n_hits"],
            "n_hits_blits_n2": outs["n_hits_blits_n2"],
            "m8_problems": golden["m8"][:20],
            "hhr_problems": golden["hhr"][:20],
            "blits_n2_problems": golden["blits_n2"][:20],
            "exact_structural_vs_cpu": exact,
            "exact_problems": exact_problems[:12],
            "pass": (not any(golden.values()) and exact is not False),
        })
    except Exception as e:        # a crash is a failure, never a raise
        import traceback

        info.update({"pass": False,
                     "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-2000:]})
    return info


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "-o" in argv:
        out = argv[argv.index("-o") + 1]
    verdict = run_check()
    text = json.dumps(verdict, indent=1)
    print(text)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    return 0 if verdict.get("pass") else 1


if __name__ == "__main__":
    raise SystemExit(main())
