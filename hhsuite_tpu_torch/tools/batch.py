"""Batch search: many queries from an input ffindex.

The counterpart of the JAX package's ``tools/batch.py`` and of the
reference's hhblits_omp (src/hhblits_omp.cpp:122-164): every entry of
the input ffindex is searched independently and the requested outputs
are collected into shared output ffindex databases keyed by entry name,
in input order.

On a card the queries run on a small pool of threads (2 by default):
one query's host stages (template preparation, the prefilter's cuts,
rescoring, the MSA merge, the writers) overlap another's kernels, and
the threads share one :func:`search.engine.get_database` instance, whose
template and cs219 packs stay resident across queries.  Under a device
mesh each thread gets its own sub-mesh (:func:`parallel.mesh.split_mesh`),
so concurrent queries run on disjoint devices while each shards its
template batches over its own.  On the CPU the queries fan out over a
process pool.  hhblits_mpi's multi-host lanes are ``-queue`` (a claim
queue on a shared filesystem), ``-shard k/N`` with ``-merge``, and
``-rank/-size/-addr`` (:mod:`parallel.multihost`).

    python -m hhsuite_tpu_torch hhblits_batch -i <queries> -d <db> -o <out>
        [-n rounds] [-hhsearch | -hhalign -t t.a3m] [-cpu N] [-mesh N]
        [-in_ca3m] [-Oca3m] [-queue dir | -shard k/N]
        [-rank R -size N -addr host:port [-jax_coordinator host:port]]
        [-merge shard1,shard2,.. -o out [-i in]]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional


def _claim_path(queue_dir: str, name: str) -> str:
    return os.path.join(queue_dir, name.replace("/", "_") + ".claim")


def _claim(queue_dir: str, name: str,
           stale_sec: Optional[float] = None) -> bool:
    """Atomically claim one work item on a shared filesystem.

    The MPQ master/worker queue (lib/ffindex/src/mpq/mpq.h:25-60) deals
    [start,end) ranges over MPI; here each worker — any number of
    processes on any number of hosts sharing the queue directory —
    self-deals single entries with an O_CREAT|O_EXCL create, which is
    atomic on POSIX filesystems including NFS.  Exactly one worker wins
    each entry, and the load balances because claims happen at execution
    time, not at partition time.

    Dead-worker recovery (MPQ has none: a crashed rank loses its range):
    workers write a ``.claim.done`` marker after the entry's outputs are
    written.  A claim with no done marker whose mtime is older than
    ``stale_sec`` (default $HHSUITE_TPU_QUEUE_STALE_SEC, 900 s) is
    presumed dead and stolen by an atomic rename — one stealer wins the
    rename, then claims again."""
    import errno
    import time

    path = _claim_path(queue_dir, name)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise
        if os.path.exists(path + ".done"):
            return False
        if stale_sec is None:
            stale_sec = float(os.environ.get(
                "HHSUITE_TPU_QUEUE_STALE_SEC", "900"))
        try:
            age = time.time() - os.path.getmtime(path)
        except OSError:
            return False         # a racing claimer just released it
        if age < stale_sec:
            return False         # a live claim elsewhere
        try:
            os.rename(path, f"{path}.stale.{os.getpid()}"
                            f".{time.time_ns()}")
        except OSError:
            return False         # another stealer won the rename
        return _claim(queue_dir, name, stale_sec)
    os.close(fd)
    return True


def _claim_done(queue_dir: str, name: str) -> None:
    """Completion marker: this entry's outputs exist in some shard."""
    with open(_claim_path(queue_dir, name) + ".done", "w"):
        pass


def queue_fanout(queue_dir: str, names: List[str], compute,
                 merge, poll: float = 0.25, log=print) -> bool:
    """Cross-host map/merge over a shared-filesystem claim queue (the
    reference's MPI database-build fan-outs,
    lib/ffindex/src/ffindex_apply_mpi.c:552): any number of processes
    sharing ``queue_dir`` call this with the same ``names`` and a
    deterministic ``compute(name) -> {kind: bytes}``; entries are dealt
    by claims at execution time, each winner writes the entry's payloads
    to ``<queue_dir>/payload/<safe>.<kind>`` (tmp + rename), and exactly
    one process — the winner of the ``__merge__`` claim, taken after
    every entry is done — runs ``merge(payload_dir)``.  The call is a
    barrier: every process returns after the merge, whose output is the
    single-process run's whatever the fleet's size.  Dead workers and a
    dead merge winner are recovered by the stale-claim steal (``merge``
    must therefore rewrite its outputs whole).  Returns True if this
    process ran the merge."""
    import time

    pdir = os.path.join(queue_dir, "payload")
    os.makedirs(pdir, exist_ok=True)

    def _safe(name: str) -> str:
        return name.replace("/", "_")

    pending = list(names)
    while pending:
        progressed = False
        still = []
        for name in pending:
            if os.path.exists(_claim_path(queue_dir, name) + ".done"):
                continue
            if _claim(queue_dir, name):
                payloads = compute(name)
                for kind, data in payloads.items():
                    dst = os.path.join(pdir, f"{_safe(name)}.{kind}")
                    tmp = f"{dst}.tmp.{os.getpid()}"
                    with open(tmp, "wb") as f:
                        f.write(data)
                    os.replace(tmp, dst)
                _claim_done(queue_dir, name)
                progressed = True
            else:
                still.append(name)
        pending = still
        if pending and not progressed:
            time.sleep(poll)   # other workers hold live claims

    # ---- merge barrier: exactly one process assembles the output ----
    merged_here = False
    while not os.path.exists(_claim_path(queue_dir, "__merge__")
                             + ".done"):
        if _claim(queue_dir, "__merge__"):
            merge(pdir)
            _claim_done(queue_dir, "__merge__")
            merged_here = True
        else:
            time.sleep(poll)   # a merge in progress elsewhere
    return merged_here


def _run_one(job, device=None):
    """Search one query: ``job`` = (name, text, db_base, par_overrides,
    mode) on ``device`` (:func:`device.resolve_device`'s rule); returns
    (name, {kind: bytes}), or None when a ``-queue`` claim was lost."""
    (name, text, db_base, par_dict, mode) = job
    # jobs share one dict on the thread-pool and serial paths: the pops
    # below must not leak across queries
    par_dict = dict(par_dict)
    queue_dir = par_dict.pop("__queue_dir", None)
    if queue_dir is not None and not _claim(queue_dir, name):
        return None
    ca3m_out = par_dict.pop("__ca3m_out", False)
    from ..apps import write_alignment_a3m
    from ..constants import Parameters
    from ..device import resolve_device
    from ..io.alignments import print_alignments
    from ..io.results import print_hit_list, print_m8
    from ..matrices import get_substitution_matrix
    from ..search.engine import get_database, run_hhalign, run_hhsearch
    from ..search.hhblits import run_hhblits

    dev = resolve_device(device)
    par = {"hhblits": Parameters.hhblits_defaults,
           "hhsearch": Parameters.hhsearch_defaults,
           "hhalign": Parameters.hhalign_defaults}[mode]()
    template_files = par_dict.pop("__template_files", None)
    for k, v in par_dict.items():
        setattr(par, k, v)
    mats = get_substitution_matrix(par.matrix)
    qali = None
    if mode == "hhalign":
        # hhalign_mpi (hhblits_mpi.cpp built with -DHHALIGN=1): every
        # input entry is aligned against the same -t template files
        template_texts = []
        for t in template_files or []:
            with open(t) as f:
                template_texts.append((os.path.basename(t), f.read()))
        q, hitlist, qali = run_hhalign(par, text, template_texts, name,
                                       device=dev)
    elif mode == "hhblits":
        q, hitlist, qali = run_hhblits(par, text, get_database(db_base),
                                       name, device=dev)
    else:
        q, hitlist = run_hhsearch(par, text, get_database(db_base), name,
                                  device=dev)
    outputs: Dict[str, bytes] = {}
    hhr = (print_hit_list(q, hitlist, par.maxdbstrlen, par.z, par.Z,
                          par.p, par.E, ["hhblits_batch"])
           + print_alignments(q, hitlist, par, mats.S))
    outputs["hhr"] = hhr.encode()
    outputs["m8"] = print_m8(q, hitlist, par.nseqdis, par.p,
                             par.E).encode()
    if qali is not None:
        a3m_text = write_alignment_a3m(qali)
        if ca3m_out:
            # the result MSA compressed against the search database's
            # _sequence ffindex (src/hhblits_ca3m.cpp:80+); where that
            # fails the reference warns and skips, here the plain a3m is
            # stored so that no result is lost
            from ..io.ca3m import compress_a3m
            from ..io.ffindex import FFindexDatabase

            seq_db = FFindexDatabase(db_base + "_sequence.ffdata",
                                     db_base + "_sequence.ffindex")
            payload = compress_a3m(a3m_text, seq_db)
            if payload is None:
                print(f"WARNING: could not compress result MSA for "
                      f"{name}; storing plain a3m", file=sys.stderr)
                payload = a3m_text.encode()
            outputs["ca3m"] = payload
        else:
            outputs["a3m"] = a3m_text.encode()
    return name, outputs


def _pool_init(threads: int) -> None:
    """A pool process's torch threads: its share of the host's cores."""
    import torch

    torch.set_num_threads(max(1, threads))


def run_batch(in_base: str, db_base: str, out_base: str,
              mode: str = "hhblits", par_overrides: Optional[dict] = None,
              threads: int = 0, log=print, ca3m: bool = False,
              in_ca3m: bool = False, shard: Optional[str] = None,
              queue_dir: Optional[str] = None, device=None) -> None:
    """Search every entry of <in_base>.ff{data,index} against db_base on
    ``device`` (default: the card) and write
    <out_base>_{hhr,m8[,a3m|ca3m]}.ff{data,index}, entries in input
    order.

    On a card, or under a device mesh, the queries run on ``threads``
    threads (default 2; each thread its own sub-mesh of the mesh, a
    sub-mesh of one device passed as the thread's ``device``); on the
    CPU on a pool of ``threads`` processes (default: the cores, at most
    8).  in_ca3m=True is the hhblits_ca3m program
    (src/hhblits_ca3m.cpp:120-240): the queries come from the compressed
    <in_base>_ca3m database, each expanded to a3m through the companion
    <in_base>_{sequence,header} ffindexes.  ca3m=True compresses the
    result MSAs against the search database's _sequence ffindex."""
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from ..device import resolve_device
    from ..io.ffindex import FFindexDatabase, FFindexWriter
    from ..parallel.mesh import get_mesh, split_mesh, use_mesh

    dev = resolve_device(device)
    par_dict = dict(par_overrides or {})
    if ca3m:
        par_dict["__ca3m_out"] = True
    if queue_dir:
        # multi-host dynamic dealing (the MPQ equivalent): every host
        # runs this command with the same -queue dir on a shared
        # filesystem and its own -o shard; workers claim entries at
        # execution time.  Merge the shards afterwards with -merge.
        os.makedirs(queue_dir, exist_ok=True)
        par_dict["__queue_dir"] = queue_dir
    if in_ca3m:
        from ..io.ca3m import extract_a3m

        src = FFindexDatabase(in_base + "_ca3m.ffdata",
                              in_base + "_ca3m.ffindex")
        seq_db = FFindexDatabase(in_base + "_sequence.ffdata",
                                 in_base + "_sequence.ffindex")
        hdr_db = FFindexDatabase(in_base + "_header.ffdata",
                                 in_base + "_header.ffindex")
        jobs = [(e.name, extract_a3m(src.read_bytes(e), seq_db, hdr_db),
                 db_base, par_dict, mode) for e in src.entries]
    else:
        src = FFindexDatabase(in_base + ".ffdata", in_base + ".ffindex")
        jobs = [(e.name, src.read_text(e), db_base, par_dict, mode)
                for e in src.entries]

    if shard:
        # static sharding "-shard k/N": this host takes every Nth entry
        # (the manual alternative when no shared filesystem exists)
        k, n = (int(x) for x in shard.split("/"))
        jobs = jobs[k % n::n]

    mesh = get_mesh()
    if dev.type == "cuda" or mesh is not None:
        # the card's kernels are queued from any thread; host stages
        # (numpy, torch, the native library) release the GIL in their
        # heavy parts, so a second thread keeps the card fed while one
        # query's host work runs — the hhblits_omp shape with the card
        # standing in for the shared memory bus
        nthreads = threads or 2
        if mesh is not None and nthreads > 1 and len(jobs) > 1:
            # query parallelism over the mesh: one sub-mesh per worker
            # thread, held exclusively while a job runs
            import queue as _queue

            subs = split_mesh(mesh, nthreads)
            free: "_queue.Queue" = _queue.Queue()
            for s in subs:
                free.put(s)

            def _worker(job):
                sub = free.get()
                try:
                    # the sub-mesh's first device runs the query's
                    # unsharded work (a one-device sub-mesh: all of it)
                    with use_mesh(sub):
                        return _run_one(job, sub.devices[0])
                finally:
                    free.put(sub)

            with ThreadPoolExecutor(max_workers=len(subs)) as ex:
                results = list(ex.map(_worker, jobs))
        elif nthreads > 1 and len(jobs) > 1:
            with ThreadPoolExecutor(max_workers=nthreads) as ex:
                results = list(ex.map(lambda j: _run_one(j, dev), jobs))
        else:
            results = [_run_one(j, dev) for j in jobs]
    else:
        nproc = threads or min(os.cpu_count() or 1, 8)
        if nproc > 1 and len(jobs) > 1:
            # spawn: a fork of a process whose torch thread pools have
            # started is not safe
            import multiprocessing

            nproc = min(nproc, len(jobs))
            with ProcessPoolExecutor(
                    max_workers=nproc,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_pool_init,
                    initargs=((os.cpu_count() or 1) // nproc,)) as ex:
                results = list(ex.map(_run_one, jobs,
                                      [str(dev)] * len(jobs)))
        else:
            results = [_run_one(j, dev) for j in jobs]

    results = [r for r in results if r is not None]   # lost claim races
    writers: Dict[str, FFindexWriter] = {}
    try:
        for name, outputs in results:
            for kind, payload in outputs.items():
                if kind not in writers:
                    writers[kind] = FFindexWriter(
                        f"{out_base}_{kind}.ffdata",
                        f"{out_base}_{kind}.ffindex")
                writers[kind].add(name, payload)
    finally:
        for w in writers.values():
            w.close()
    if queue_dir:
        # completion markers after the shard files are written: a claim
        # without one is a dead worker's and is re-dealt (the stale
        # steal in _claim)
        for name, _outputs in results:
            _claim_done(queue_dir, name)
    log(f"Batch {mode}: {len(results)} queries -> {out_base}_*")


def merge_shards(out_base: str, shard_bases: List[str],
                 kinds=("hhr", "m8", "a3m"),
                 expected: Optional[List[str]] = None,
                 log=print) -> List[str]:
    """ffmerge_splits semantics (src/hhblits_mpi.cpp:83-93): concatenate
    per-rank output shards into one database per kind.

    With ``expected`` (the input entry names), audits the merged set:
    entries of the input missing from every shard — a worker died
    mid-entry — are reported and returned, so the caller can re-run the
    batch over the same queue dir (the stale claim is re-dealt).  The
    reference's MPQ merge is blind to lost ranges."""
    from ..io.ffindex import FFindexDatabase, FFindexWriter

    seen: set = set()
    for kind in kinds:
        shards = []
        for base in shard_bases:
            data = f"{base}_{kind}.ffdata"
            index = f"{base}_{kind}.ffindex"
            if os.path.exists(data) and os.path.exists(index):
                shards.append(FFindexDatabase(data, index))
        if not shards:
            continue
        with FFindexWriter(f"{out_base}_{kind}.ffdata",
                           f"{out_base}_{kind}.ffindex") as w:
            for db in shards:
                for name, payload in db.items():
                    w.add(name, payload)
                    seen.add(name)
    missing: List[str] = []
    if expected is not None:
        missing = [n for n in expected if n not in seen]
        if missing:
            head = ", ".join(missing[:5])
            log(f"WARNING: merge is missing {len(missing)} input "
                f"entries (e.g. {head}): a worker likely died; re-run "
                f"the batch with the same -queue dir to re-deal them, "
                f"then merge again")
    return missing


_USAGE = ("hhblits_batch -i <query ffindex base> -d <db base> -o <out base> "
          "[-n rounds] [-cpu N] [-mesh N] [-hhsearch | -hhalign -t t.a3m] "
          "[-in_ca3m] [-Oca3m] [-shard k/N] [-queue <shared dir>] "
          "[-rank R -size N -addr host:port [-jax_coordinator host:port]] "
          "[-merge shard1,shard2,.. -o out [-i in]]")


def main(argv: List[str]) -> int:
    in_base = db_base = out_base = None
    mode = "hhblits"
    threads = 0
    in_ca3m = False
    shard = queue_dir = None
    merge_bases: Optional[List[str]] = None
    par_overrides: dict = {"nocontxt": True}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            in_base = argv[i]
        elif a == "-d":
            i += 1
            db_base = argv[i]
        elif a == "-o":
            i += 1
            out_base = argv[i]
        elif a == "-n":
            i += 1
            par_overrides["num_rounds"] = int(argv[i])
        elif a == "-cpu":
            i += 1
            threads = int(argv[i])
        elif a == "-hhsearch":
            mode = "hhsearch"
        elif a == "-hhalign":
            mode = "hhalign"
        elif a == "-t":
            i += 1
            par_overrides.setdefault("__template_files", []).append(argv[i])
        elif a == "-in_ca3m":
            in_ca3m = True
        elif a == "-Oca3m":
            par_overrides["__ca3m_out"] = True
        elif a == "-shard":
            i += 1
            shard = argv[i]
        elif a == "-mesh":
            i += 1
            from ..parallel.mesh import make_mesh, set_mesh

            set_mesh(make_mesh(int(argv[i])))
        elif a == "-queue":
            i += 1
            queue_dir = argv[i]
        elif a == "-rank":
            i += 1
            par_overrides["__mh_rank"] = int(argv[i])
        elif a == "-size":
            i += 1
            par_overrides["__mh_size"] = int(argv[i])
        elif a == "-addr":
            i += 1
            par_overrides["__mh_addr"] = argv[i]
        elif a == "-jax_coordinator":
            i += 1
            par_overrides["__mh_coord"] = argv[i]
        elif a == "-merge":
            i += 1
            merge_bases = argv[i].split(",")
        i += 1
    if merge_bases is not None:
        # the last step of a multi-host run (ffmerge_splits,
        # src/hhblits_mpi.cpp:83-93,210-219); with -i, audit the merged
        # entries against the input index
        if not out_base:
            print("hhblits_batch -merge <shard1,shard2,..> -o <out base>",
                  file=sys.stderr)
            return 4
        expected = None
        if in_base:
            from ..io.ffindex import FFindexDatabase

            suffix = "_ca3m" if in_ca3m else ""
            expected = [e.name for e in FFindexDatabase(
                f"{in_base}{suffix}.ffdata",
                f"{in_base}{suffix}.ffindex").entries]
        missing = merge_shards(out_base, merge_bases, expected=expected)
        return 1 if missing else 0
    if "__mh_rank" in par_overrides:
        # the TCP process-group lane (hhblits_mpi semantics: MPQ over
        # sockets, merged in band): every rank runs this command with
        # its own -rank; see parallel/multihost.py
        from ..parallel.multihost import run_multihost

        rank = par_overrides.pop("__mh_rank")
        mh_size = par_overrides.pop("__mh_size", 2)
        mh_addr = par_overrides.pop("__mh_addr", "127.0.0.1:45917")
        coord = par_overrides.pop("__mh_coord", None)
        if not in_base or not db_base or not out_base:
            print("hhblits_batch -rank R -size N -addr host:port -i "
                  "<queries> -d <db> -o <out>", file=sys.stderr)
            return 4
        try:
            run_multihost(in_base, db_base, out_base, rank, mh_size,
                          mh_addr, mode, par_overrides,
                          jax_coordinator=coord)
        except RuntimeError as e:
            # partial output was written; exit nonzero so that it is not
            # taken for a success
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        return 0
    if mode == "hhalign" and in_base and out_base:
        db_base = db_base or "-"          # hhalign needs no database
    if not in_base or not db_base or not out_base:
        print(_USAGE, file=sys.stderr)
        return 4
    run_batch(in_base, db_base, out_base, mode, par_overrides, threads,
              in_ca3m=in_ca3m, shard=shard, queue_dir=queue_dir)
    return 0
