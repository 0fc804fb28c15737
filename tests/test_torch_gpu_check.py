"""The oracle (``hhsuite_tpu_torch/tools/gpu_check.py``) on the CPU.

* its comparators accept the reference goldens and reject what lies
  beyond their bounded near-tie exceptions, as the JAX package's
  tests/test_tpu_golden.py holds ``tpu_check``'s;
* ``oracle_outputs(device="cpu")`` — ``hhsearch`` and the 2-round
  ``hhblits`` on the 26-entry ``multi_*`` fixtures — passes the golden
  tier (``golden_multi_search.{blasttab,hhr}``,
  ``golden_multi_n2.{m8,hhr}``);
* the same ``hhsearch`` under a mesh of four CPU devices gives the
  unsharded run's m8, hit table and alignments byte for byte (the
  counterpart of tests/test_mesh_consistency.py; ``hhblits -n 2`` under
  the mesh is held in tests/test_torch_mesh.py, on a smaller database);
* ``run_check``'s verdict: the byte-identity tier against a CPU run and
  the golden tier, each failing on its own; ``main`` writes the verdict
  and exits by it.
"""

import copy
import json
import os

import pytest
import torch

from hhsuite_tpu_torch.parallel.mesh import make_mesh, use_mesh
from hhsuite_tpu_torch.tools import gpu_check as G

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def cpu_oracle():
    """The two oracle searches on the CPU, unsharded (one torch thread:
    the plain versions gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield G.oracle_outputs(device="cpu")
    finally:
        torch.set_num_threads(n)


def test_comparators_accept_reference_goldens():
    with open(f"{FIX}/golden_multi_search.blasttab") as f:
        m8 = f.read()
    assert G._m8_compare(m8, m8) == []
    # a 1-2 cell plateau flip is tolerated; more than 2 cells is not
    assert G._m8_compare(m8.replace("\t1\t431\t", "\t2\t431\t", 1), m8) == []
    assert G._m8_compare(m8.replace("\t1\t431\t", "\t9\t431\t", 1), m8) != []
    # the plateau exception is capped: a coordinate moved on more rows
    # than the cap fails as systematic drift
    lines = m8.splitlines()
    many, flipped = m8, 0
    for ln in lines:
        t = ln.split("\t")
        if len(t) == 12 and flipped <= G._MAX_PLATEAU_ROWS:
            t[6] = str(int(t[6]) + 1)
            flipped += 1
        many = many.replace(ln, "\t".join(t), 1)
    assert G._m8_compare(many, m8) != []
    # stat columns keep a printed-precision window; big jumps fail
    t = lines[0].split("\t")
    t[11] = str(float(t[11]) + 0.1)
    assert G._m8_compare("\n".join(["\t".join(t)] + lines[1:]) + "\n",
                         m8) == []
    t[11] = str(float(t[11]) + 50.0)
    assert G._m8_compare("\n".join(["\t".join(t)] + lines[1:]) + "\n",
                         m8) != []

    with open(f"{FIX}/golden_multi_search.hhr") as f:
        hhr = f.read().split("\nNo 1\n")[0] + "\n"
    assert G._hhr_summary_compare(hhr, hhr) == []
    drift = hhr.replace("1-431     1-431", "1-431     2-431", 1)
    assert G._hhr_summary_compare(drift, hhr) == []
    big = hhr.replace("1-431     1-431", "1-431     9-431", 1)
    assert G._hhr_summary_compare(big, hhr) != []


def test_oracle_cpu_passes_golden_tier(cpu_oracle):
    assert G.golden_problems(cpu_oracle) == {"m8": [], "hhr": [],
                                             "blits_n2": []}
    assert cpu_oracle["n_hits"] > 0 and cpu_oracle["n_hits_blits_n2"] > 0
    assert set(G.EXACT_KEYS) <= set(cpu_oracle)
    assert cpu_oracle["a3m_n2"].count(">") > 1


def test_oracle_hhsearch_mesh_identical(cpu_oracle):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with use_mesh(make_mesh(["cpu"] * 4)):
            got = G.oracle_outputs(device="cpu", searches=("hhsearch",))
    finally:
        torch.set_num_threads(n)
    assert set(got) == {"m8", "hhr", "blocks", "n_hits"}
    for key in got:
        assert got[key] == cpu_oracle[key], key


def test_run_check_tiers(cpu_oracle, monkeypatch):
    """The verdict's two tiers on recorded outputs: the card's side is
    stood in for by a device whose type is not the CPU's."""
    from hhsuite_tpu_torch import device as D

    monkeypatch.setattr(D, "resolve_device",
                        lambda device=None: torch.device("meta"))
    card = copy.deepcopy(cpu_oracle)
    monkeypatch.setattr(G, "oracle_outputs",
                        lambda fixtures=None, device=None: card)
    cpu = copy.deepcopy(cpu_oracle)
    monkeypatch.setattr(G, "_cpu_oracle_outputs",
                        lambda timeout=1200, proc=None: cpu)
    v = G.run_check()
    assert v["pass"] and v["exact_structural_vs_cpu"] is True, v
    assert v["exact_problems"] == [] and v["m8_problems"] == []

    # one alignment-block byte differs: the exact tier fails alone
    lines = cpu["blocks"].splitlines()
    k = next(i for i, ln in enumerate(lines) if ln.startswith("Q "))
    lines[k] = lines[k][:-1] + ("A" if lines[k][-1] != "A" else "C")
    cpu["blocks"] = "\n".join(lines) + "\n"
    v = G.run_check()
    assert not v["pass"] and v["exact_structural_vs_cpu"] is False
    assert v["exact_problems"][0].startswith(f"blocks: line {k}:")
    assert v["m8_problems"] == [] and v["hhr_problems"] == []

    # the card's m8 loses its last row: both tiers fail
    card["m8"] = "".join(card["m8"].splitlines(True)[:-1])
    v = G.run_check()
    assert not v["pass"] and v["m8_problems"]
    assert any(p.startswith("m8: ") for p in v["exact_problems"])

    # a CPU run that failed fails the check
    monkeypatch.setattr(G, "_cpu_oracle_outputs",
                        lambda timeout=1200, proc=None: None)
    card["m8"] = cpu_oracle["m8"]
    v = G.run_check()
    assert not v["pass"] and v["exact_problems"] == ["cpu subprocess failed"]


def test_main_writes_verdict(tmp_path, monkeypatch):
    out = tmp_path / "verdict.json"
    for ok, rc in ((True, 0), (False, 1)):
        monkeypatch.setattr(G, "run_check", lambda: {"pass": ok})
        assert G.main(["-o", str(out)]) == rc
        assert json.loads(out.read_text()) == {"pass": ok}
