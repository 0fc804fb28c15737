"""The port's device mesh (``hhsuite_tpu_torch/parallel/mesh.py``) on the
CPU, where a mesh may name the CPU several times.

* ``make_mesh`` / ``split_mesh`` / ``use_mesh`` / ``auto_mesh`` and the
  CLI's ``-mesh`` / ``-nomesh``;
* each sharded call against the unsharded one on the same seeded inputs
  (the plain versions of the kernels), at a batch that does not divide
  by the device count: the sweep (K1 fast and exact, K6 without and
  with the SS table) and the backtrace pass (K2, K3 with altali masks,
  with the SS table and global, each walked by W1) bit- and
  byte-identical, the prefilter stages (K4, K5 over the resident cs219
  pack, whole and a subset) int-identical;
* ``hhsearch`` through the CLI with ``-mesh 3`` against no mesh, and
  ``hhblits -n 2`` under a 4-CPU mesh against no mesh, on a 12-template
  benchmark database: the same ``.hhr`` and ``-oa3m`` bytes.

The 26-entry ``multi_*`` fixtures' ``hhsearch`` and ``hhblits -n 2``
under ``["cpu"] * 4`` against no mesh are the oracle's searches and are
held in tests/test_torch_gpu_check.py, which computes the unsharded run
once for both of its tiers.
"""

import numpy as np
import pytest
import torch

import chip_smoke as C
from hhsuite_tpu_torch.parallel import mesh as M
from hhsuite_tpu_torch.search import viterbi_search as VS

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_process_mesh():
    """Every test starts and ends with no process-wide mesh."""
    M.set_mesh(None)
    yield
    M.set_mesh(None)


def test_make_split_use_mesh():
    mesh = M.make_mesh(CPU4)
    assert mesh.size == 4 and mesh.devices == [torch.device("cpu")] * 4
    assert M.make_mesh(3, "cpu").devices == [torch.device("cpu")] * 3
    assert M.get_mesh() is None
    with M.use_mesh(mesh):
        assert M.get_mesh() is mesh
        with M.use_mesh(M.make_mesh(["cpu"])):
            assert M.get_mesh() is None         # one device: no mesh
        assert M.get_mesh() is mesh
    assert M.get_mesh() is None
    subs = M.split_mesh(M.make_mesh(["cpu"] * 5), 2)
    assert [s.size for s in subs] == [2, 3]
    singles = M.split_mesh(mesh, 8)
    assert len(singles) == 4
    assert all(isinstance(s, M._SingleDeviceMesh) and s.size == 1
               and s.devices == [torch.device("cpu")] for s in singles)
    # a thread's one-device sub-mesh shadows the process mesh
    M.set_mesh(mesh)
    assert M.get_mesh() is mesh
    with M.use_mesh(singles[0]):
        assert M.get_mesh() is None
    assert M.auto_mesh("cpu") is None


def test_cli_activates_mesh(monkeypatch):
    from hhsuite_tpu_torch.args import activate_mesh, parse_args
    from hhsuite_tpu_torch.constants import Parameters
    from hhsuite_tpu_torch.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    par = parse_args(["-mesh", "3"], Parameters.hhsearch_defaults())
    assert par.mesh_devices == 3
    activate_mesh(par)
    assert M.get_mesh().devices == [torch.device("cpu")] * 3
    activate_mesh(parse_args(["-nomesh"], Parameters.hhsearch_defaults()))
    assert M.get_mesh() is None
    M.set_mesh(M.make_mesh(CPU4))
    activate_mesh(Parameters.hhsearch_defaults())   # default: auto
    assert M.get_mesh() is None                     # (no card here)


LQ, LT, B = 24, 40, 7


def _inputs(seed, pad_last=True):
    return C.synth_inputs(LQ, LT, B, seed, "cpu", pad_last=pad_last)


@pytest.mark.parametrize("impl,ss", [("fused", False), ("exact", False),
                                     ("split", False), ("split", True)])
def test_sharded_sweep_bit_identical(impl, ss):
    qp, qtr, tp, ttr, tl = _inputs(1)
    kw = {}
    if ss:
        lut, qidx, tidx = C.ss_lut_inputs(LQ, LT, B, 2, "cpu")
        kw = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
    want = VS.sweep_batch(qp, qtr, tp, ttr, tl, np.float32(-0.03), impl, kw)
    with M.use_mesh(M.make_mesh(["cpu"] * 3)):
        got = M.sharded_lanes_scores(qp, qtr, tp, ttr, tl,
                                     np.float32(-0.03), impl, kw)
    assert got.shape == (B,)
    assert C.bits_equal(got, want)


@pytest.mark.parametrize("case", ["K2", "K3 altali", "K3 SS", "K3 global"])
def test_sharded_backtrace_byte_identical(case):
    qp, qtr, tp, ttr, tl = _inputs(3)
    kmax = LQ + LT + 1
    kw = dict(Lq_true=LQ)
    hot = case == "K2"
    if case == "K3 altali":
        kw["cell_off"] = C.exclusion_masks(LQ, LT, tl, 2, 4, "cpu")
    elif case == "K3 SS":
        lut, qidx, tidx = C.ss_lut_inputs(LQ, LT, B, 5, "cpu")
        kw["ss_kw"] = dict(ss_lut=lut, ss_qidx=qidx, ss_tidx=tidx)
    elif case == "K3 global":
        kw["local"] = False
    shift = np.float32(-0.03)
    want = VS.backtrace_batch(qp, qtr, tp, ttr, tl, shift, kmax, hot, **kw)
    with M.use_mesh(M.make_mesh(CPU4)):
        got = M.sharded_viterbi_backtrace(qp, qtr, tp, ttr, tl, shift,
                                          kmax, hot, **kw)
    assert got.dtype == torch.int8 and got.shape == (B, 12 + kmax)
    assert torch.equal(got, want)


def test_sharded_prefilter_int_identical():
    from hhsuite_tpu_torch.ops import prefilter as P
    from hhsuite_tpu_torch.search.prefilter import ResidentCs219Pack

    rng = np.random.default_rng(7)
    lens = C.long_tail_lengths(rng, 11, L0=30)
    seqs = [rng.integers(0, 219, n).astype(np.uint8).tobytes()
            for n in lens]
    pack = ResidentCs219Pack(seqs, "cpu")
    qc = torch.from_numpy(C.prefilter_table(rng, 20))
    subset = np.array([9, 2, 5, 0], np.int64)
    runs = [(P.ungapped_scores_packed, (50,)),
            (P.gapped_scores_packed, C.K5_GAPS)]
    want = [pack.scores(k, qc, sub, *a) for k, a in runs
            for sub in (None, subset)]
    with M.use_mesh(M.make_mesh(CPU4)):
        got = [pack.scores(k, qc, sub, *a) for k, a in runs
               for sub in (None, subset)]
        # one row over four devices: three shards of padding only
        one = M.sharded_prefilter_scores(
            P.ungapped_scores_packed, qc, pack, pack.offsets[:1],
            pack.row_lengths[:1], 50)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert pack.states_on("cpu") is pack.states
    assert one.tolist() == [int(want[0][pack.order[0]])]


@pytest.fixture(scope="module")
def bench12(tmp_path_factory):
    from hhsuite_tpu_torch.tools.benchdb import build_bench_db

    base = str(tmp_path_factory.mktemp("bench12") / "b")
    query = build_bench_db(base, n_templates=12, L0=50)
    qfile = base + ".query.a3m"
    with open(qfile, "w") as f:
        f.write(query)
    return base, qfile


def _body(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(("Date", "Command"))]


def _count_calls(monkeypatch, module, names):
    """Wrap ``module``'s functions ``names`` to count their calls."""
    calls = dict.fromkeys(names, 0)

    for name in names:
        def wrap(fn, name=name):
            def counted(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return counted
        monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    return calls


def test_cli_hhsearch_mesh_identical(bench12, tmp_path, monkeypatch):
    """The funnel forced on the CPU (as on the card) with display caps
    small enough (-Z/-B/-realign_max 3, -z/-b 1) for it to run: the
    sweep and the backtrace pass both go sharded."""
    from hhsuite_tpu_torch.cli import main
    from hhsuite_tpu_torch.device import DEVICE_ENV

    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setattr(VS, "_funnel_ok", lambda device: True)
    calls = _count_calls(monkeypatch, VS, ("sharded_lanes_scores",
                                           "sharded_viterbi_backtrace"))
    base, qfile = bench12
    caps = ["-Z", "3", "-B", "3", "-realign_max", "3", "-z", "1", "-b", "1"]
    outs = {}
    for tag, extra in (("one", []), ("mesh", ["-mesh", "3"])):
        out = str(tmp_path / f"{tag}.hhr")
        m8 = str(tmp_path / f"{tag}.m8")
        assert main(["hhsearch", "-i", qfile, "-d", base, "-o", out,
                     "-blasttab", m8] + caps + extra) == 0
        with open(m8) as f:
            outs[tag] = (_body(out), f.read())
        if tag == "one":
            assert calls == dict.fromkeys(calls, 0)
    assert M.get_mesh() is not None        # -mesh 3 left it installed
    assert all(n > 0 for n in calls.values()), calls
    assert outs["mesh"] == outs["one"]
    assert len(outs["one"][0]) > 10


def test_hhblits_n2_mesh_identical(bench12):
    from hhsuite_tpu_torch.apps import write_alignment_a3m
    from hhsuite_tpu_torch.constants import Parameters
    from hhsuite_tpu_torch.search.engine import HHDatabase
    from hhsuite_tpu_torch.search.hhblits import run_hhblits

    base, qfile = bench12
    with open(qfile) as f:
        query = f.read()

    def run():
        par = Parameters.hhblits_defaults()
        par.num_rounds = 2
        par.alnfile = "x"
        q, hitlist, qali = run_hhblits(par, query, HHDatabase(base), "q",
                                       device="cpu")
        return C._hhr_lines(par, q, hitlist), write_alignment_a3m(qali)

    want = run()
    with M.use_mesh(M.make_mesh(CPU4)):
        got = run()
    assert got == want
    assert want[1].count(">") > 1          # round 2 merged hits
