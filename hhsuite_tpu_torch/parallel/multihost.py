"""Multi-host runtime: MPQ master/worker semantics over TCP instead of MPI.

The counterpart of the JAX package's ``parallel/multihost.py``, the
replacement of hhblits_mpi (src/hhblits_mpi.cpp:135-230 +
lib/ffindex/src/mpq/mpq.h:25-60): rank 0 runs the master, dealing query
indices to workers on request (load balancing at execution time, like
MPQ_Master's deal loop); workers send each finished entry's outputs back
over their connection, and rank 0 writes the one merged output database
itself — the ffmerge_splits merge after the barrier
(src/hhblits_mpi.cpp:83-93,210-219) becomes the collection loop, so
there are no per-rank shard files and no shared filesystem (the claim
queue of tools/batch.py remains for NFS-style clusters).

Devices: each rank runs its queries on its own card(s) (a device mesh
inside a rank shards template batches, parallel/mesh.py).  With
``jax_coordinator`` (the CLI's ``-jax_coordinator host:port``, spelled
as in the JAX package) the ranks also join one ``torch.distributed``
process group — Gloo on the CPU, NCCL on cards — for collectives such as
:func:`parallel.mesh.global_topk_scores`; the search itself needs only
the local devices, so a rank carries on without it.

Wire protocol: length-prefixed pickles over one TCP connection per
worker.  Messages:
  worker -> master: ("next", rank) | ("result", name, {kind: bytes})
                    | ("error", name, message)
  master -> worker: ("work", [entry_indices]) | ("done",)

An ("error", ...) reports a failed entry (the worker catches per entry
instead of dying).  The master re-deals a failed entry once, to another
worker when one is connected, so a transient failure (device memory, a
flaky read) gets a second chance on a healthy rank; a second failure
poisons it — done with no output, never dealt again — because a
deterministic crash would otherwise cycle through the fleet.  Rank 0
still writes every entry that succeeded, then raises: a batch with
missing entries must not exit 0.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Dict, List, Optional


def _send(conn: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(struct.pack(">Q", len(payload)) + payload)


def _recv(conn: socket.socket):
    hdr = b""
    while len(hdr) < 8:
        part = conn.recv(8 - len(hdr))
        if not part:
            raise ConnectionError("peer closed")
        hdr += part
    n = struct.unpack(">Q", hdr)[0]
    buf = bytearray()
    while len(buf) < n:
        part = conn.recv(min(1 << 20, n - len(buf)))
        if not part:
            raise ConnectionError("peer closed")
        buf += part
    return pickle.loads(bytes(buf))


def _default_grace() -> float:
    """Worker-less retirement window, seconds: 150 by default; fleets
    that start slowly raise it with $HHSUITE_TPU_MH_GRACE."""
    try:
        return float(os.environ.get("HHSUITE_TPU_MH_GRACE", "150"))
    except ValueError:
        return 150.0


def _master(addr: str, size: int, n_entries: int, chunk: int,
            results: Dict[str, Dict[str, bytes]],
            order: Dict[str, int], grace: Optional[float] = None,
            max_attempts: int = 2) -> None:
    """MPQ_Master with failure recovery: deal index ranges on request and
    collect per-entry results until every entry is done.  Unlike the
    reference's MPQ (whose deal loop loses a crashed rank's range), work
    dealt to a connection that drops before reporting is returned to the
    pool and re-dealt to the surviving workers; a worker that asks for
    work while others still hold outstanding entries waits until that
    work completes or is re-dealt.

    An entry a worker reports as failed is tried at most
    ``max_attempts`` times, a retry dealt to another worker whenever one
    is connected; then it is poisoned (done, no output).

    The accept loop is dynamic: the master never waits for a fixed
    number of workers, so a rank that dies (or never starts) before
    connecting cannot hang the group; dealing starts with the first
    worker.  If no worker is connected and none (re)appears within
    ``grace`` seconds while entries are outstanding, the master retires
    with partial results (run_multihost then writes what succeeded and
    raises)."""
    import time as _time

    if grace is None:
        grace = _default_grace()
    host, port = addr.rsplit(":", 1)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, int(port)))
    srv.listen(max(size, 8))
    srv.settimeout(0.5)

    cv = threading.Condition()
    next_idx = 0            # fresh-work pointer
    active = 0              # connected workers
    redeal: List[int] = []  # dead workers' indices + retryable failures
    done: set = set()       # indices with a result (or poisoned)
    attempts: Dict[int, int] = {}   # reported failures per entry
    failed_by: Dict[int, set] = {}  # workers that failed the entry
    wid_seq = [0]

    def serve(conn, wid):
        nonlocal next_idx, active
        mine: set = set()
        try:
            while True:
                msg = _recv(conn)
                if msg[0] == "next":
                    with cv:
                        batch: List[int] = []
                        while True:
                            # a retry prefers another worker: skip the
                            # entries this worker failed while others
                            # are connected to take them
                            k = 0
                            while k < len(redeal) and len(batch) < chunk:
                                if (active > 1
                                        and wid in failed_by.get(
                                            redeal[k], ())):
                                    k += 1
                                    continue
                                batch.append(redeal.pop(k))
                            while (next_idx < n_entries
                                   and len(batch) < chunk):
                                batch.append(next_idx)
                                next_idx += 1
                            if batch:
                                break
                            if len(done) >= n_entries:
                                # every entry has a result: retire (a
                                # worker waits while entries are merely
                                # outstanding, so that a holder's death
                                # can still be re-dealt to it)
                                _send(conn, ("done",))
                                return
                            # wait for a death (re-deal) or completion
                            cv.wait(timeout=0.25)
                        mine.update(batch)
                    _send(conn, ("work", batch))
                elif msg[0] == "result":
                    name, outputs = msg[1], msg[2]
                    with cv:
                        results[name] = outputs
                        idx = order.get(name)
                        if idx is not None:
                            mine.discard(idx)
                            done.add(idx)
                        cv.notify_all()
                elif msg[0] == "error":
                    # a reported failure: retry (on another worker when
                    # possible) up to max_attempts, then poison — done
                    # with no output (rank 0 raises at the end)
                    name = msg[1]
                    with cv:
                        idx = order.get(name)
                        if idx is not None:
                            mine.discard(idx)
                            n_att = attempts.get(idx, 0) + 1
                            attempts[idx] = n_att
                            failed_by.setdefault(idx, set()).add(wid)
                            if n_att < max_attempts:
                                redeal.append(idx)
                            else:
                                done.add(idx)
                        cv.notify_all()
        except (ConnectionError, OSError):
            pass   # the worker died; its outstanding work is re-dealt
        finally:
            with cv:
                active -= 1
                if mine:
                    redeal.extend(sorted(mine))
                cv.notify_all()
            conn.close()

    threads: List[threading.Thread] = []
    last_worker_evt = _time.monotonic()
    while True:
        with cv:
            if len(done) >= n_entries and active == 0:
                break
            workerless = active == 0
        if workerless and _time.monotonic() - last_worker_evt > grace:
            break              # every worker gone: write what we have
        try:
            conn, _peer = srv.accept()
        except socket.timeout:
            with cv:
                if active > 0:
                    # workers alive: the grace window measures time
                    # without workers, not time since the last connect
                    last_worker_evt = _time.monotonic()
            continue
        except OSError:
            break
        with cv:
            active += 1
            wid_seq[0] += 1
        last_worker_evt = _time.monotonic()
        t = threading.Thread(target=serve, args=(conn, wid_seq[0]),
                             daemon=True)
        t.start()
        threads.append(t)
    srv.close()
    for t in threads:
        t.join(timeout=grace)


def _join_process_group(coordinator: str, rank: int, size: int, log):
    """Join the ranks' ``torch.distributed`` group at ``coordinator``
    (host:port): Gloo on the CPU, NCCL on cards.  Returns True when
    joined; a rank that cannot join runs on its local devices alone."""
    try:
        import torch
        import torch.distributed as dist

        from ..device import resolve_device

        backend = ("nccl" if resolve_device().type == "cuda"
                   and torch.cuda.is_available() else "gloo")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=size, rank=rank)
        return True
    except Exception as e:   # best effort, as in the JAX package
        log(f"torch.distributed unavailable ({e}); ranks run with local "
            f"devices only")
        return False


def run_multihost(in_base: str, db_base: str, out_base: str, rank: int,
                  size: int, addr: str, mode: str = "hhblits",
                  par_overrides: Optional[dict] = None, chunk: int = 1,
                  jax_coordinator: Optional[str] = None, log=print,
                  device=None) -> None:
    """One rank of a multi-host batch search.

    Rank 0 is the master and the merged-output writer; ranks 1..size-1
    are workers, each searching on ``device`` (default: its card).  All
    ranks must see the input and database paths; only rank 0 writes
    <out_base>_{hhr,m8[,a3m]}.ff{data,index} (merged, input order)."""
    assert size >= 2, "multi-host needs a master and >=1 worker"
    joined = (jax_coordinator is not None
              and _join_process_group(jax_coordinator, rank, size, log))
    try:
        _run_rank(in_base, db_base, out_base, rank, size, addr, mode,
                  par_overrides, chunk, log, device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_rank(in_base, db_base, out_base, rank, size, addr, mode,
              par_overrides, chunk, log, device) -> None:
    from ..io.ffindex import FFindexDatabase, FFindexWriter

    src = FFindexDatabase(in_base + ".ffdata", in_base + ".ffindex")
    names = [e.name for e in src.entries]

    if rank == 0:
        results: Dict[str, Dict[str, bytes]] = {}
        order = {n: i for i, n in enumerate(names)}
        _master(addr, size, len(names), chunk, results, order)
        writers: Dict[str, FFindexWriter] = {}
        missing: List[str] = []
        try:
            for name in names:          # input order, like the merge
                outputs = results.get(name)
                if outputs is None:
                    log(f"WARNING: no result for entry {name} "
                        f"(failed twice or every worker died)")
                    missing.append(name)
                    continue
                for kind, payload in outputs.items():
                    if kind not in writers:
                        writers[kind] = FFindexWriter(
                            f"{out_base}_{kind}.ffdata",
                            f"{out_base}_{kind}.ffindex")
                    writers[kind].add(name, payload)
        finally:
            for w in writers.values():
                w.close()
        log(f"multihost {mode}: {len(results)}/{len(names)} entries "
            f"-> {out_base}_*")
        if missing:
            # the partial output is written (salvage), but the batch
            # must not look like a success: the reference's MPI run dies
            # loudly on a failed rank, this one on failed entries
            raise RuntimeError(
                f"multihost {mode}: {len(missing)}/{len(names)} "
                f"entries missing from {out_base}_* "
                f"(first: {missing[:5]})")
        return

    # ---- worker rank ----
    import time

    from ..tools.batch import _run_one

    host, port = addr.rsplit(":", 1)
    conn = None
    # ranks start near-simultaneously and the master may bind late; the
    # window matches the master's worker-less grace, so a slow fleet
    # raises both with one variable ($HHSUITE_TPU_MH_GRACE)
    deadline = max(120.0, _default_grace())
    t0 = time.monotonic()
    while conn is None:
        try:
            conn = socket.create_connection((host, int(port)), timeout=600)
        except OSError:
            if time.monotonic() - t0 > deadline:
                raise
            time.sleep(0.2)
    par_dict = dict(par_overrides or {})
    try:
        while True:
            _send(conn, ("next", rank))
            msg = _recv(conn)
            if msg[0] == "done":
                break
            for idx in msg[1]:
                name = names[idx]
                try:
                    text = src.read_text(name)
                    out = _run_one((name, text, db_base, par_dict, mode),
                                   device)
                except Exception as e:   # report the entry, go on
                    log(f"rank {rank}: entry {name} failed: "
                        f"{type(e).__name__}: {e}")
                    _send(conn, ("error", name, f"{e}"))
                    continue
                if out is not None:
                    _send(conn, ("result", out[0], out[1]))
    finally:
        conn.close()
