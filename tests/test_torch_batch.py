"""Many queries: the port's batch search (``tools/batch.py``), the
multi-host master (``parallel/multihost.py``), the distributed top-k and
``profiling.gc_paused`` across threads, on the CPU.

* ``run_batch`` over an 8-template benchmark database, its queries the
  database's own first entries: serially, on two threads over a mesh of
  four CPU devices (the branch a card takes: each thread its sub-mesh
  of two, so both the query axis and the template axis are split), and
  on a pool of two processes — every ``_hhr`` (Date aside), ``_m8`` and
  ``_a3m`` entry byte-identical to the query's own ``run_hhsearch`` /
  ``run_hhblits``, in input order;
* ``hhblits_ca3m``: queries from a compressed ffindex (companion
  ``_sequence``/``_header`` ffindexes written with ``FFindexWriter``),
  the same outputs as the expanded queries' own searches;
* ``-hhalign -t``: every query aligned against one template file;
* the ``-queue`` claim queue (a dead worker's claim honoured until
  stale, then re-dealt) and ``-shard k/N`` with ``-merge``, whose audit
  reports missing entries;
* ``multihost._master`` driven over sockets by scripted fake workers
  (dead worker, twice-failed entry, transient failure, a rank that never
  connects): the JAX package's master and the port's, given the same
  script, end with equal results; ``run_multihost`` writes what
  succeeded and raises on missing entries; a master and a real worker
  (threads of this process) write the serial batch's outputs;
* ``global_topk_scores``: the JAX function and the port's on the same
  seeded shard; two Gloo processes against a numpy merge;
* ``gc_paused``: the collector stays off while another thread's pause
  is open.

Every thread join, socket and child process carries its own timeout.
"""

import gc
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hhsuite_tpu_torch.constants import Parameters
from hhsuite_tpu_torch.device import DEVICE_ENV
from hhsuite_tpu_torch.io.ffindex import FFindexDatabase, FFindexWriter
from hhsuite_tpu_torch.parallel import multihost as MH
from hhsuite_tpu_torch.parallel.mesh import make_mesh, use_mesh
from hhsuite_tpu_torch.tools import batch as BT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_QUERIES = 3
QUIET = dict(log=lambda *a: None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """An 8-template benchmark database and a query ffindex of its
    first entries; returns (db base, query base, [(name, text)])."""
    from hhsuite_tpu_torch.tools.benchdb import build_bench_db

    tmp = tmp_path_factory.mktemp("batch")
    base = str(tmp / "b")
    build_bench_db(base, n_templates=8, L0=40)
    a3m = FFindexDatabase(base + "_a3m.ffdata", base + "_a3m.ffindex")
    queries = [(f"q{k}", a3m.read_text(e))
               for k, e in enumerate(a3m.entries[:N_QUERIES])]
    qbase = str(tmp / "queries")
    with FFindexWriter(qbase + ".ffdata", qbase + ".ffindex") as w:
        for name, text in queries:
            w.add(name, text.encode())
    return base, qbase, queries


def _strip_date(text: str) -> str:
    return re.sub(r"(?m)^Date.*$", "", text)


def _entries(out_base, kind):
    db = FFindexDatabase(f"{out_base}_{kind}.ffdata",
                         f"{out_base}_{kind}.ffindex")
    return {e.name: (_strip_date(db.read_text(e)) if kind == "hhr"
                     else db.read_text(e)) for e in db.entries}


MODES = {"hhsearch": {"nocontxt": True},
         "hhblits": {"nocontxt": True, "num_rounds": 1}}
# the thread branch's mesh: for hhsearch four CPU devices (two
# sub-meshes of two: the query axis and the template axis split), for
# hhblits two (one device a thread: the query axis)
THREAD_MESH = {"hhsearch": 4, "hhblits": 2}


@pytest.fixture(scope="module")
def entry_outputs(bench):
    """Each query through the normal entry (run_hhsearch / run_hhblits
    on one HHDatabase), rendered as the batch renders it."""
    from hhsuite_tpu_torch.apps import write_alignment_a3m
    from hhsuite_tpu_torch.io.alignments import print_alignments
    from hhsuite_tpu_torch.io.results import print_hit_list, print_m8
    from hhsuite_tpu_torch.matrices import get_substitution_matrix
    from hhsuite_tpu_torch.search.engine import HHDatabase, run_hhsearch
    from hhsuite_tpu_torch.search.hhblits import run_hhblits

    base, _qbase, queries = bench
    db = HHDatabase(base)
    out = {}
    for mode, over in MODES.items():
        got = {"hhr": {}, "m8": {}, "a3m": {}}
        for name, text in queries:
            par = getattr(Parameters, f"{mode}_defaults")()
            for k, v in over.items():
                setattr(par, k, v)
            if mode == "hhblits":
                q, hl, qali = run_hhblits(par, text, db, name, device="cpu")
                got["a3m"][name] = write_alignment_a3m(qali)
            else:
                q, hl = run_hhsearch(par, text, db, name, device="cpu")
            S = get_substitution_matrix(par.matrix).S
            got["hhr"][name] = _strip_date(
                print_hit_list(q, hl, par.maxdbstrlen, par.z, par.Z, par.p,
                               par.E, ["hhblits_batch"])
                + print_alignments(q, hl, par, S))
            got["m8"][name] = print_m8(q, hl, par.nseqdis, par.p, par.E)
        out[mode] = got
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("branch", ["serial", "threads on a CPU mesh",
                                    "process pool"])
def test_run_batch_matches_entry(bench, entry_outputs, tmp_path, mode,
                                 branch, monkeypatch):
    from hhsuite_tpu_torch.parallel import mesh as M

    base, qbase, queries = bench
    out = str(tmp_path / "res")
    threads = 1 if branch == "serial" else 2
    runs = []
    real = BT._run_one

    def spy(job, device=None):
        runs.append((threading.get_ident(), M.get_mesh(), device))
        return real(job, device)

    if branch == "process pool":
        BT.run_batch(qbase, base, out, mode, MODES[mode], threads,
                     device="cpu", **QUIET)
    else:
        monkeypatch.setattr(BT, "_run_one", spy)
    if branch == "threads on a CPU mesh":
        nd = THREAD_MESH[mode]
        with use_mesh(make_mesh(["cpu"] * nd)):
            BT.run_batch(qbase, base, out, mode, MODES[mode], threads,
                         device="cpu", **QUIET)
        # worker threads, each with its own sub-mesh of nd / 2 devices
        # (get_mesh() None on a one-device sub-mesh) and its device
        assert len(runs) == N_QUERIES
        assert all((m.size if m else 1) == nd // 2 and d == torch.device(
            "cpu") for _t, m, d in runs)
        assert threading.get_ident() not in {t for t, _m, _d in runs}
    elif branch == "serial":
        BT.run_batch(qbase, base, out, mode, MODES[mode], threads,
                     device="cpu", **QUIET)
        assert len(runs) == N_QUERIES
    kinds = ("hhr", "m8", "a3m") if mode == "hhblits" else ("hhr", "m8")
    for kind in kinds:
        db = FFindexDatabase(f"{out}_{kind}.ffdata", f"{out}_{kind}.ffindex")
        # entries written in input order (the index sorts by name)
        assert [e.offset for e in db.entries] == sorted(
            e.offset for e in db.entries)
        assert _entries(out, kind) == entry_outputs[mode][kind], kind
    assert not os.path.exists(f"{out}_a3m.ffdata") or mode == "hhblits"


def test_hhblits_ca3m(bench, tmp_path, monkeypatch):
    """hhblits_ca3m (src/hhblits_ca3m.cpp:120-240): the queries come
    from a compressed ffindex and are expanded through its companion
    _sequence/_header ffindexes before the normal search."""
    from hhsuite_tpu_torch.cli import main
    from hhsuite_tpu_torch.io.ca3m import compress_a3m, extract_a3m

    base, _qbase, queries = bench
    qdb = str(tmp_path / "qdb")
    members = []
    for _name, text in queries[:2]:
        lines = text.strip().splitlines()
        members.append((lines[0], "".join(lines[1:])))
    with FFindexWriter(qdb + "_sequence.ffdata",
                       qdb + "_sequence.ffindex") as ws, \
            FFindexWriter(qdb + "_header.ffdata",
                          qdb + "_header.ffindex") as wh:
        for header, seq in members:
            sid = header[1:].split()[0]
            ws.add(sid, seq.replace("-", "").upper().encode())
            wh.add(sid, header.encode())
    seq_db = FFindexDatabase(qdb + "_sequence.ffdata",
                             qdb + "_sequence.ffindex")
    with FFindexWriter(qdb + "_ca3m.ffdata", qdb + "_ca3m.ffindex") as w:
        for k, (header, seq) in enumerate(members):
            body = compress_a3m(f">c{k}_consensus\n{seq}\n{header}\n{seq}\n",
                                seq_db)
            assert body is not None
            w.add(f"c{k}", body)

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    out = str(tmp_path / "res")
    assert main(["hhblits_ca3m", "-i", qdb, "-d", base, "-o", out, "-n", "1",
                 "-cpu", "1"]) == 0
    # the same queries expanded by hand, through the plain a3m batch
    hdr_db = FFindexDatabase(qdb + "_header.ffdata",
                             qdb + "_header.ffindex")
    src = FFindexDatabase(qdb + "_ca3m.ffdata", qdb + "_ca3m.ffindex")
    plain = str(tmp_path / "plain")
    with FFindexWriter(plain + ".ffdata", plain + ".ffindex") as w:
        for e in src.entries:
            text = extract_a3m(src.read_bytes(e), seq_db, hdr_db)
            assert members[int(e.name[1:])][1] in text
            w.add(e.name, text.encode())
    BT.run_batch(plain, base, str(tmp_path / "want"), "hhblits",
                 {"nocontxt": True, "num_rounds": 1}, 1, device="cpu",
                 **QUIET)
    for kind in ("hhr", "m8", "a3m"):
        got = _entries(out, kind)
        assert sorted(got) == ["c0", "c1"]
        assert got == _entries(str(tmp_path / "want"), kind), kind


def test_batch_hhalign_mode(bench, tmp_path, monkeypatch):
    """hhalign_mpi's counterpart (``-hhalign -t``): every query aligned
    against the same template files, no database; the same outputs as
    the query's own run_hhalign."""
    from hhsuite_tpu_torch.cli import main
    from hhsuite_tpu_torch.io.alignments import print_alignments
    from hhsuite_tpu_torch.io.results import print_hit_list
    from hhsuite_tpu_torch.matrices import get_substitution_matrix
    from hhsuite_tpu_torch.search.engine import run_hhalign

    _base, qbase, queries = bench
    tfile = tmp_path / "t.a3m"
    tfile.write_text(queries[-1][1])
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    out = str(tmp_path / "ali")
    assert main(["hhblits_batch", "-hhalign", "-t", str(tfile), "-i", qbase,
                 "-o", out, "-cpu", "1"]) == 0
    got = _entries(out, "hhr")
    assert sorted(got) == [n for n, _t in queries]
    for name, text in queries:
        par = Parameters.hhalign_defaults()
        par.nocontxt = True
        q, hl, _qali = run_hhalign(par, text, [("t.a3m", tfile.read_text())],
                                   name, device="cpu")
        S = get_substitution_matrix(par.matrix).S
        assert got[name] == _strip_date(
            print_hit_list(q, hl, par.maxdbstrlen, par.z, par.Z, par.p,
                           par.E, ["hhblits_batch"])
            + print_alignments(q, hl, par, S))
    assert "Probab=100.00" in got[queries[-1][0]]


def test_queue_dead_worker_and_shards(bench, tmp_path, monkeypatch):
    """The MPQ analogue on a shared directory: a claim with no done
    marker (a worker that died mid-entry) is honoured until it is stale,
    then re-dealt; -shard k/N splits the entries, and -merge audits the
    merged set against the input."""
    from hhsuite_tpu_torch.cli import main

    base, qbase, queries = bench
    names = [n for n, _t in queries]
    common = dict(mode="hhsearch", par_overrides=MODES["hhsearch"],
                  threads=1, device="cpu", **QUIET)
    qdir = str(tmp_path / "queue")
    os.makedirs(qdir)
    open(BT._claim_path(qdir, "q1"), "w").close()     # the dead claim
    BT.run_batch(qbase, base, str(tmp_path / "h0"), queue_dir=qdir,
                 **common)
    missing = BT.merge_shards(str(tmp_path / "m1"), [str(tmp_path / "h0")],
                              kinds=("hhr", "m8"), expected=names, **QUIET)
    assert missing == ["q1"]
    monkeypatch.setenv("HHSUITE_TPU_QUEUE_STALE_SEC", "0")
    BT.run_batch(qbase, base, str(tmp_path / "h1"), queue_dir=qdir,
                 **common)
    assert sorted(_entries(str(tmp_path / "h1"), "m8")) == ["q1"]
    assert BT.merge_shards(str(tmp_path / "m2"), [str(tmp_path / "h0"),
                                                  str(tmp_path / "h1")],
                           kinds=("hhr", "m8"), expected=names,
                           **QUIET) == []
    merged = _entries(str(tmp_path / "m2"), "hhr")
    dones = [f for f in os.listdir(qdir) if f.endswith(".done")]
    assert sorted(merged) == names and len(dones) == len(names)
    # a third host finds nothing left to claim
    BT.run_batch(qbase, base, str(tmp_path / "h2"), queue_dir=qdir,
                 **common)
    assert not os.path.exists(str(tmp_path / "h2_hhr.ffdata"))

    # the CLI: -shard 0/2 and 1/2, then -merge with the input's audit
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    for k in (0, 1):
        assert main(["hhblits_batch", "-hhsearch", "-i", qbase, "-d", base,
                     "-o", str(tmp_path / f"s{k}"), "-shard", f"{k}/2",
                     "-cpu", "1"]) == 0
        assert sorted(_entries(str(tmp_path / f"s{k}"), "m8")) == \
            names[k::2]
    shards = f"{tmp_path / 's0'},{tmp_path / 's1'}"
    assert main(["hhblits_batch", "-merge", shards, "-o",
                 str(tmp_path / "all"), "-i", qbase]) == 0
    assert _entries(str(tmp_path / "all"), "hhr") == merged
    assert main(["hhblits_batch", "-merge", str(tmp_path / "s0"), "-o",
                 str(tmp_path / "half"), "-i", qbase]) == 1


# ------------------------------------------------------- multi-host ----

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port):
    for _ in range(200):             # the master may not have bound yet
        try:
            return socket.create_connection(("127.0.0.1", port),
                                            timeout=30)
        except OSError:
            time.sleep(0.05)
    raise ConnectionError("master never bound")


def _drain(mh, conn, rank, names, seen, fail=()):
    """A fake worker: ask for work until done, answering each entry with
    a result, or an error for the entries in ``fail``."""
    while True:
        mh._send(conn, ("next", rank))
        msg = mh._recv(conn)
        if msg[0] == "done":
            return
        for idx in msg[1]:
            seen.append((rank, idx))
            if idx in fail:
                mh._send(conn, ("error", names[idx], "boom"))
            else:
                mh._send(conn, ("result", names[idx],
                                {"hhr": f"payload-{idx}".encode()}))


def _dead_worker(mh, port, names, seen):
    a, b = _connect(port), _connect(port)
    mh._send(a, ("next", 1))
    msg = mh._recv(a)
    seen.append((1, tuple(msg[1])))
    a.close()                          # dies holding entry 0
    _drain(mh, b, 2, names, seen)
    b.close()


def _poisoned(mh, port, names, seen):
    conn = _connect(port)
    _drain(mh, conn, 1, names, seen, fail=(1,))
    conn.close()


def _transient(mh, port, names, seen):
    a, b = _connect(port), _connect(port)
    mh._send(a, ("next", 1))
    msg = mh._recv(a)
    seen.append((1, tuple(msg[1])))
    mh._send(a, ("error", names[msg[1][0]], "transient"))
    _drain(mh, b, 2, names, seen)      # the retry must land on b
    mh._send(a, ("next", 1))
    seen.append((1, mh._recv(a)[0]))
    a.close()
    b.close()


def _never_connects(mh, port, names, seen):
    conn = _connect(port)              # of 3 ranks, one worker appears
    _drain(mh, conn, 1, names, seen)
    conn.close()


SCRIPTS = {"dead worker": (_dead_worker, 3, 5),
           "failed twice": (_poisoned, 2, 3),
           "transient failure": (_transient, 3, 3),
           "rank never connects": (_never_connects, 3, 4)}


def _run_master(mh, script, size, n):
    names = [f"q{k}" for k in range(n)]
    port = _free_port()
    results, order = {}, {nm: i for i, nm in enumerate(names)}
    master = threading.Thread(
        target=mh._master, args=(f"127.0.0.1:{port}", size, n, 1, results,
                                 order), kwargs=dict(grace=30), daemon=True)
    master.start()
    seen = []
    script(mh, port, names, seen)
    master.join(timeout=60)
    assert not master.is_alive()
    return results, seen


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_master_matches_jax(case):
    from hhsuite_tpu.parallel import multihost as JMH

    script, size, n = SCRIPTS[case]
    got = _run_master(MH, script, size, n)
    want = _run_master(JMH, script, size, n)
    # the results, and what each worker was dealt; the order in which a
    # re-dealt entry and a fresh one reach a worker depends on when the
    # master's connection thread sees the other worker's death or error
    assert got[0] == want[0]
    assert sorted(got[1], key=repr) == sorted(want[1], key=repr)
    results, seen = got
    names = {f"q{k}" for k in range(n)}
    if case == "failed twice":
        assert sorted(i for _r, i in seen) == [0, 1, 1, 2]
        assert set(results) == names - {"q1"}
    else:
        assert set(results) == names
    if case == "transient failure":
        assert (2, 0) in seen and seen[-1] == (1, "done")


def test_run_multihost_raises_on_missing_entries(tmp_path):
    names = [f"q{k}" for k in range(3)]
    with FFindexWriter(f"{tmp_path}/in.ffdata", f"{tmp_path}/in.ffindex") as w:
        for nm in names:
            w.add(nm, f">{nm}\nACDEF\n".encode())
    port = _free_port()
    err = []

    def rank0():
        try:
            MH.run_multihost(f"{tmp_path}/in", "-", f"{tmp_path}/out", 0, 2,
                             f"127.0.0.1:{port}", **QUIET)
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=rank0, daemon=True)
    t.start()
    conn = _connect(port)
    _drain(MH, conn, 1, names, [], fail=(1,))
    conn.close()
    t.join(timeout=60)
    assert not t.is_alive()
    assert err and "1/3 entries missing" in str(err[0])
    out = FFindexDatabase(f"{tmp_path}/out_hhr.ffdata",
                          f"{tmp_path}/out_hhr.ffindex")
    assert [e.name for e in out.entries] == ["q0", "q2"]


def test_multihost_ranks_write_the_batch(bench, tmp_path):
    """Rank 0 (the master and writer) and a worker rank that really
    searches, as two threads of this process: the merged output is the
    serial batch's."""
    base, qbase, _queries = bench
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    errors = []

    def rank(r):
        try:
            MH.run_multihost(qbase, base, str(tmp_path / "mh"), r, 2, addr,
                             "hhsearch", MODES["hhsearch"], device="cpu",
                             **QUIET)
        except Exception as e:     # reported below
            errors.append((r, e))

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    BT.run_batch(qbase, base, str(tmp_path / "serial"), "hhsearch",
                 MODES["hhsearch"], 1, device="cpu", **QUIET)
    for kind in ("hhr", "m8"):
        assert _entries(str(tmp_path / "mh"), kind) == \
            _entries(str(tmp_path / "serial"), kind)


# ------------------------------------------------------ global top-k ----

def test_topk_single_process_matches_jax():
    from hhsuite_tpu.parallel.mesh import global_topk_scores as jax_topk

    from hhsuite_tpu_torch.parallel.mesh import global_topk_scores

    rng = np.random.default_rng(42)
    x = rng.normal(size=50).astype(np.float32)
    x[[3, 17, 30]] = x[8]                  # ties keep index order
    for k in (1, 7, 50, 60):
        got = global_topk_scores(x, k)
        want = jax_topk(x, k)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))


_RANK_PROG = r"""
import datetime, json, sys
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch.distributed as dist
from hhsuite_tpu_torch.parallel.mesh import global_topk_scores
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://" + sys.argv[2],
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
rng = np.random.default_rng(42)
full = rng.normal(size=23).astype(np.float32)
full[20] = full[2]                     # a tie across the two ranks
shard = full[:13] if rank == 0 else full[13:]
s, p, i = global_topk_scores(shard, k=6)
dist.destroy_process_group()
print("RESULT" + json.dumps({"s": s.tolist(), "p": p.tolist(),
                             "i": i.tolist()}))
"""


def test_topk_two_gloo_processes_match_numpy():
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROG, str(r), coord, REPO],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for r, pr in enumerate(procs):
            out, err = pr.communicate(timeout=120)
            assert pr.returncode == 0, f"rank {r}: {err[-2000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT")][-1]
            outs.append(json.loads(line[len("RESULT"):]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    assert outs[0] == outs[1]
    rng = np.random.default_rng(42)
    full = rng.normal(size=23).astype(np.float32)
    full[20] = full[2]
    ref = np.argsort(-full, kind="stable")[:6]
    np.testing.assert_array_equal(np.float32(outs[0]["s"]), full[ref])
    assert [i + 13 * p for p, i in zip(outs[0]["p"], outs[0]["i"])] == \
        ref.tolist()


# ----------------------------------------------------------- gc_paused ----

def test_gc_paused_across_threads():
    """Thread A pauses, thread B pauses, A leaves: the collector must
    stay off until B leaves too, then come back on."""
    from hhsuite_tpu_torch.profiling import gc_paused

    assert gc.isenabled()
    a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with gc_paused():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with gc_paused():
            b_in.set()
            a_out.wait(10)
            seen["after A left"] = gc.isenabled()
            b_go.wait(10)

    ta = threading.Thread(target=thread_a, daemon=True)
    tb = threading.Thread(target=thread_b, daemon=True)
    ta.start()
    tb.start()
    ta.join(10)
    deadline = time.monotonic() + 10
    while "after A left" not in seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert seen.get("after A left") is False
    assert not gc.isenabled()
    b_go.set()
    tb.join(10)
    assert not ta.is_alive() and not tb.is_alive()
    assert gc.isenabled()
    # a caller that disabled the collector itself keeps it disabled
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
