"""hhsuitedb: build an hh-suite database (<base>_{a3m,hhm,cs219}) from
MSA files or an existing a3m ffindex.

Equivalent of scripts/hhsuitedb.py (463 lines): a3m ffindex assembly,
HHM profiles for alignments with more than 50 sequences (or the first
entry if none qualify, scripts/hhsuitedb.py:75-96), cs219 column-state
sequences for the prefilter, sorted indexes, and the self-check/repair
passes (duplicates, unsorted index, missing entries, overhead entries;
scripts/hhsuitedb.py:204-430).

Differences from the reference pipeline: per-entry work is fanned out
with a local process pool instead of MPI (ffindex_apply_mpi); the pool
starts its workers with ``spawn``, so a caller that holds a CUDA context
can run it.  cs219
translation applies context pseudocounts ``-x 0.3 -c 4`` exactly like
scripts/hhsuitedb.py:113 / data/test.sh:30-33; the internal pseudocount
model is the cs219 library (matching the reference build, whose embedded
context_data.lib resource carries the cs219.lib content).
"""

from __future__ import annotations

import glob as globmod
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

_WORKER_STATE: Dict[str, object] = {}


def _worker_init(threads: int = 0):
    """Build the worker's context library and pseudocount engine once;
    a pool process also takes its share of the host's cores for torch
    (``threads``; 0 leaves torch's default)."""
    if threads:
        import torch

        torch.set_num_threads(max(1, threads))
    from ..cs.context_lib import ContextLibrary, default_pc_engine

    _WORKER_STATE["lib"] = ContextLibrary.default_cs219()
    _WORKER_STATE["pc"] = default_pc_engine()


def _entry_jobs(name_text: Tuple[str, str, bool]):
    """Compute (name, cs219_bytes, hhm_text_or_None) for one a3m."""
    name, text, want_hhm = name_text
    from ..cs.context_lib import cstranslate_a3m

    lib = _WORKER_STATE.get("lib")
    if lib is None:
        _worker_init()
        lib = _WORKER_STATE["lib"]
    # cstranslate -x 0.3 -c 4 (scripts/hhsuitedb.py:113)
    cs = cstranslate_a3m(text, lib, pc_engine=_WORKER_STATE["pc"],
                         pc_admix=0.3, pc_ali=4.0)
    hhm = None
    if want_hhm:
        from ..apps import hhmake

        hhm = hhmake(text, name, None, argv=["hhmake", "-i", name])
    return name, cs, hhm


def _count_sequences(text: str) -> int:
    return sum(1 for line in text.splitlines()
               if line.startswith(">") and not line.startswith(">ss_")
               and not line.startswith(">sa_"))


def build_hhsuite_db(out_base: str, a3m_files: Optional[List[str]] = None,
                     a3m_db_base: Optional[str] = None,
                     threads: int = 0, force: bool = False,
                     queue_dir: Optional[str] = None,
                     log=print) -> None:
    """Create <out_base>_{a3m,hhm,cs219}.ff{data,index}.

    With ``queue_dir`` (a shared-filesystem directory), any number of
    cooperating ``hhsuitedb -queue <dir>`` processes — across hosts —
    split the per-entry cs219/HHM work via the atomic claim queue and
    produce byte-identical output to a single-process build (the
    multi-host lane the reference covers with ffindex_apply_mpi +
    cstranslate_mpi, lib/ffindex/src/ffindex_apply_mpi.c:552)."""
    from ..io.ffindex import FFindexDatabase, FFindexWriter

    # ---- 1. input alignments (deterministic canonical order) ----
    a3m_base = out_base + "_a3m"
    if a3m_db_base:
        src = FFindexDatabase(a3m_db_base + ".ffdata",
                              a3m_db_base + ".ffindex")
        entries = [(e.name, src.read_text(e)) for e in src.entries]
    else:
        entries = []
        for path in sorted(a3m_files or []):
            with open(path) as f:
                entries.append((os.path.basename(path), f.read()))
    if not entries:
        raise ValueError("no input alignments")

    # duplicate check (handle_duplicates)
    seen = set()
    deduped = []
    for name, text in entries:
        if name in seen:
            log(f"WARNING: duplicate entry {name} (keeping first)")
            continue
        seen.add(name)
        deduped.append((name, text))
    entries = deduped

    # ---- 2. which entries get HHM profiles ----
    nseqs = {name: _count_sequences(text) for name, text in entries}
    large = {name for name, n in nseqs.items() if n > 50}
    if entries and not large:
        large.add(entries[0][0])

    cs_base = out_base + "_cs219"
    hhm_base = out_base + "_hhm"

    if queue_dir:
        # ---- 3q. cross-host fan-out: claim entries, payload files,
        # single-winner merge (byte-identical to the serial build) ----
        from .batch import queue_fanout

        texts = dict(entries)

        def compute(name):
            _n, cs, hhm = _entry_jobs((name, texts[name],
                                       name in large))
            out = {"cs219": cs}
            if hhm is not None:
                out["hhm"] = hhm.encode()
            return out

        def merge(pdir):
            def _read(name, kind):
                p = os.path.join(pdir,
                                 name.replace("/", "_") + "." + kind)
                with open(p, "rb") as f:
                    return f.read()

            with FFindexWriter(a3m_base + ".ffdata",
                               a3m_base + ".ffindex") as w:
                for name, text in entries:
                    w.add(name, text.encode())
            with FFindexWriter(cs_base + ".ffdata",
                               cs_base + ".ffindex") as w:
                for name, _t in entries:
                    w.add(name, _read(name, "cs219"))
            with FFindexWriter(hhm_base + ".ffdata",
                               hhm_base + ".ffindex") as w:
                for name, _t in entries:
                    if name in large:
                        w.add(name, _read(name, "hhm"))

        merged_here = queue_fanout(queue_dir,
                                   [n for n, _t in entries],
                                   compute, merge, log=log)
        cs = FFindexDatabase(cs_base + ".ffdata", cs_base + ".ffindex")
        log(f"Built {out_base} (queue{' merge' if merged_here else ''}):"
            f" {len(entries)} alignments, {len(large)} HHMs, "
            f"{len(cs.names())} cs219 sequences")
        return

    with FFindexWriter(a3m_base + ".ffdata", a3m_base + ".ffindex") as w:
        for name, text in entries:
            w.add(name, text.encode())

    # ---- 3. per-entry cs219 + hhm (process pool) ----
    jobs = [(name, text, name in large) for name, text in entries]
    nproc = threads or min(os.cpu_count() or 1, 8)
    results = []
    if nproc > 1 and len(jobs) > 1:
        # spawn: a fork of a process whose torch thread pools (or CUDA
        # context) have started is not safe
        import multiprocessing

        nproc = min(nproc, len(jobs))
        with ProcessPoolExecutor(
                max_workers=nproc,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=((os.cpu_count() or 1) // nproc,)) as ex:
            results = list(ex.map(_entry_jobs, jobs))
    else:
        results = [_entry_jobs(j) for j in jobs]

    with FFindexWriter(cs_base + ".ffdata", cs_base + ".ffindex") as w:
        for name, cs, _h in results:
            w.add(name, cs)
    n_hhm = 0
    with FFindexWriter(hhm_base + ".ffdata", hhm_base + ".ffindex") as w:
        for name, _cs, hhm in results:
            if hhm is not None:
                w.add(name, hhm.encode())
                n_hhm += 1

    # ---- 4. consistency checks (scripts/hhsuitedb.py:204-430) ----
    a3m_names = {name for name, _t in entries}
    for suffix in ("_cs219", "_hhm"):
        db = FFindexDatabase(out_base + suffix + ".ffdata",
                             out_base + suffix + ".ffindex")
        overhead = [e.name for e in db.entries if e.name not in a3m_names]
        if overhead:
            log(f"WARNING: {len(overhead)} overhead entries in "
                f"{out_base}{suffix}")
    cs = FFindexDatabase(cs_base + ".ffdata", cs_base + ".ffindex")
    missing = a3m_names - set(cs.names())
    if missing:
        log(f"WARNING: {len(missing)} a3m entries missing from cs219")
    log(f"Built {out_base}: {len(entries)} alignments, {n_hhm} HHMs, "
        f"{len(cs.names())} cs219 sequences")


def _read_entries(base: str):
    from ..io.ffindex import FFindexDatabase

    return FFindexDatabase(base + ".ffdata", base + ".ffindex")


def _rewrite_db(base: str, keep, replacements=None, log=print):
    """Rewrite a DB keeping only ``keep`` names (sorted + compacted —
    the reference's sort_database + optimize_database combined), with
    optional per-name payload replacements."""
    from ..io.ffindex import FFindexDatabase, FFindexWriter

    db = FFindexDatabase(base + ".ffdata", base + ".ffindex")
    replacements = replacements or {}
    items = []
    seen = set()
    for e in db.entries:
        if e.name not in keep or e.name in seen:
            continue
        seen.add(e.name)
        items.append((e.name, replacements.get(e.name,
                                               db.read_bytes(e))))
    for name, payload in replacements.items():
        if name not in seen and name in keep:
            items.append((name, payload))
    items.sort(key=lambda kv: kv[0])
    with FFindexWriter(base + ".ffdata", base + ".ffindex") as w:
        for name, payload in items:
            w.add(name, payload)


def _calc_payloads(names, a3m_db, kind: str):
    """Recompute cs219 or hhm payloads from the a3m database."""
    out = {}
    if not names:
        return out
    _worker_init()
    for name in names:
        text = a3m_db.read_text(name)
        n, cs, hhm = _entry_jobs((name, text, kind == "hhm"))
        out[name] = cs if kind == "cs219" else (hhm or "").encode()
    return out


def check_database(out_base: str, threads: int = 0, force: bool = False,
                   log=print) -> bool:
    """Self-check + repair passes (scripts/hhsuitedb.py:204-430).

    Detects and (with ``force``) repairs: corrupted a3m entries
    (removed from all three DBs), duplicate index entries (a3m
    duplicates are a hard error; cs219/hhm duplicates recalculated
    from the a3m), unsorted indexes (re-sorted), entries missing from
    cs219/hhm (recalculated), and overhead entries without an a3m
    (removed).  Returns True when the database is consistent.
    """
    from ..io.ffindex import FFindexDatabase
    from ..tools.a3m_container import A3MContainer

    if not (os.path.exists(out_base + "_a3m.ffdata")
            and os.path.exists(out_base + "_a3m.ffindex")):
        raise FileNotFoundError(f"no a3m database at {out_base}_a3m")
    a3m_db = _read_entries(out_base + "_a3m")
    a3m_names = [e.name for e in a3m_db.entries]

    # a3m duplicates are unrepairable (handle_duplicates a3m branch)
    dup_a3m = {n for n in a3m_names if a3m_names.count(n) > 1}
    if dup_a3m:
        raise ValueError(
            f"{out_base}_a3m.ffindex contains duplicates — database "
            f"is broken: {sorted(dup_a3m)[:5]}")

    ok = True

    # corrupted alignments (check_a3m_format)
    corrupted = set()
    for e in a3m_db.entries:
        try:
            A3MContainer().read_a3m_from_lines(
                a3m_db.read_text(e).splitlines())
        except Exception:
            corrupted.add(e.name)
            log(f"WARNING: A3M {e.name} is corrupted!")
    if corrupted:
        ok = False
        if force:
            log("WARNING: removing corrupted a3m entries!")
            keep = set(a3m_names) - corrupted
            for suffix in ("_a3m", "_cs219", "_hhm"):
                if os.path.exists(out_base + suffix + ".ffindex"):
                    _rewrite_db(out_base + suffix, keep, log=log)
            a3m_db = _read_entries(out_base + "_a3m")
            a3m_names = [e.name for e in a3m_db.entries]

    a3m_set = set(a3m_names)
    for suffix, kind in (("_cs219", "cs219"), ("_hhm", "hhm")):
        base = out_base + suffix
        if not os.path.exists(base + ".ffindex"):
            continue
        db = _read_entries(base)
        names = [e.name for e in db.entries]
        nameset = set(names)

        dups = sorted({n for n in names if names.count(n) > 1})
        for d in dups:
            log(f"WARNING: {base}.ffindex contains duplicate {d}!")
        unsorted = names != sorted(names)
        if unsorted:
            log(f"WARNING: index {base}.ffindex is unsorted!")
        missing = sorted(a3m_set - nameset) if kind == "cs219" else []
        for m in missing:
            log(f"WARNING: missing entry {m} in {base}.ff(data,index)!")
        overhead = sorted(nameset - a3m_set)
        for o in overhead:
            log(f"WARNING: entry {o} in {base} has no a3m entry!")

        if dups or unsorted or missing or overhead:
            ok = False
            if force:
                log(f"WARNING: repairing {base} "
                    f"(recalculate/sort/compact)!")
                recalc = _calc_payloads(set(dups) | set(missing),
                                        a3m_db, kind)
                _rewrite_db(base, a3m_set, replacements=recalc, log=log)
            else:
                log("You may try to use the option --force to fix "
                    "the database!")
    return ok


def main(argv: List[str]) -> int:
    out = None
    ia3m: List[str] = []
    a3m_db = None
    threads = 0
    force = False
    queue_dir = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-o":
            i += 1
            out = argv[i]
        elif a == "--ia3m":
            i += 1
            ia3m.extend(globmod.glob(argv[i]))
        elif a == "--ia3m_db":
            i += 1
            a3m_db = argv[i]
        elif a == "--cpu":
            i += 1
            threads = int(argv[i])
        elif a in ("-queue", "--queue"):
            i += 1
            queue_dir = argv[i]
        elif a == "--force":
            force = True
        i += 1
    if not out:
        print("hhsuitedb -o <db_base> [--ia3m '<glob>' | --ia3m_db <base>] "
              "[--cpu N] [-queue <shared dir>] [--force]",
              file=sys.stderr)
        return 4
    if not ia3m and not a3m_db:
        # check/repair an existing database (scripts/hhsuitedb.py flow
        # when invoked without new input alignments)
        ok = check_database(out, threads, force)
        return 0 if ok or force else 1
    build_hhsuite_db(out, ia3m or None, a3m_db, threads, force,
                     queue_dir=queue_dir)
    check_database(out, threads, force)
    return 0
