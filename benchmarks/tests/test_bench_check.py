"""The harness end to end at a test size on the CPU (its look for a card
skipped): the result line's keys, a sound run judged correct, and each
fault a cell can have, planted where the answer is produced, judged not
correct; the control (the reference one precision lower) fails too."""

import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from harness import runner

SEED = 2**31 + 7
CELL = "pdb70.hhpred"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def run(root, fault=None, trace=0, seconds=12):
    buf = io.StringIO()
    rc = runner.main(["--workload", CELL, "--seed", str(SEED),
                      "--seconds", str(seconds), "--trace", str(trace)],
                     device="cpu", fault=fault, out=buf,
                     manifest=tiny.manifest(root))
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run(root, trace):
    res = run(root, trace=trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checked"
    assert ("breakdown" in res) == bool(trace)
    assert res["correct"] is True, res["checked"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    man = tiny.manifest(root)
    want = {m["name"] for m in man.metrics(CELL, bool(trace))}
    cpu_absent = {"sweep_roofline_share"}
    assert want - cpu_absent <= set(res["metrics"]) <= want
    for t in res["checked"].values():
        assert t["limit"] is not None and t["value"] <= t["limit"]


def _full(out):
    return [h for h in out.hitlist if not h.light]


def _score(k, out):
    _full(out)[0].score += 5.0


def _path(k, out):
    h = next(h for h in out.hitlist if h.alt_i is not None)
    h.j = np.asarray(h.j) + 1


def _half(k, out):
    out.hitlist.hits = out.hitlist.hits[::2]


def _hhr_score(k, out):
    out.hhr = re.sub(r"Score=(\S+)",
                     lambda m: f"Score={float(m.group(1)) + 5:.2f}",
                     out.hhr, count=1)


def _hhr_block(k, out):
    out.hhr = out.hhr[: out.hhr.index("\nNo 2\n") + 1]


@pytest.mark.parametrize("fault", [_score, _path, _half, _hhr_score,
                                   _hhr_block],
                         ids=["score", "realigned-path", "half-the-list",
                              "hhr-score", "hhr-blocks"])
def test_fault_is_not_correct(root, fault):
    res = run(root, fault=fault)
    assert res["correct"] is False
    assert any(t["value"] > t["limit"] for t in res["checked"].values())


def test_control_is_not_correct(root):
    """The reference one precision lower in the program's place."""
    from harness import dbgen
    from harness import system as S
    from harness.traffic import Stream
    from reference import check as C

    man = tiny.manifest(root)
    wl = man.workload(CELL)
    cfg = man.config(wl["config"])
    paths = dbgen.db_paths(man.bench_dir, cfg["name"])
    dbgen.build(cfg["db"], paths["base"])
    system = S.System(cfg, paths["base"], "cpu")
    ref = C.Reference(paths["base"])
    ctl = C.Reference(paths["base"], low=C.bf16)
    stream = Stream(man.traffic(wl["traffic"]), cfg["db"], SEED)
    failed = 0
    for k in range(2):
        q = stream.query(k)
        prog = S.answer(system.run(q.name, q.text))
        truth = ref.run(q.text, prog, np.random.default_rng(k))
        low = ctl.run(q.text, prog, np.random.default_rng(k))
        nums, _seen = C.compare(C.control_answer(low), truth, q.name)
        ok, _table = C.judge(nums, cfg["limits"])
        failed += not ok
    assert failed == 2


def test_no_card_no_result(tmp_path):
    """Outside a checkout's program, or without a card, a run prints no
    result and exits with another code than 0."""
    os.makedirs(tmp_path / "benchmarks")
    for d in ("harness", "reference", "configs", "traffic", "metrics",
              "rooflines"):
        subprocess.run(["cp", "-r", os.path.join(tiny.BENCH, d),
                        str(tmp_path / "benchmarks")], check=True)
    subprocess.run(["cp", os.path.join(tiny.BENCH, "run.py"),
                    str(tmp_path / "benchmarks")], check=True)
    subprocess.run(["cp", os.path.join(tiny.ROOT, "BENCHMARK.json"),
                    str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_module_refuses(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setattr(runner, "run_cell",
                        lambda *a: ({"correct": True}, {}))
    buf = io.StringIO()
    rc = runner.main(["--workload", "x", "--seed", "1", "--seconds", "1",
                      "--trace", "0"], device="cpu", out=buf)
    assert rc != 0 and buf.getvalue() == ""
    assert "jax.numpy" in capsys.readouterr().err
    assert "hhsuite_tpu_torch" not in runner.forbidden_modules()
