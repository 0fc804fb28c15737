"""Every entry of BENCHMARK.json resolves to its files by name, the
manifest keeps the contract's shape, and a cell, a configuration and a
metric added as files alone are found."""

import json
import os
import re

import pytest

import tiny
from harness.runner import load_module

with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_manifest_shape():
    _shape(BENCH)


def _shape(BENCH):
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reports = [m["name"] for m in BENCH["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline_share") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.fixture(scope="module")
def test_root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("manifest")))


@pytest.mark.parametrize("cfg", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_configs_resolve(cfg):
    with open(os.path.join(tiny.ROOT, cfg["file"])) as f:
        data = json.load(f)
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    for key in cfg["reduced"]:
        assert key in data and key in data["reduced"]
    assert data["tool"] == "hhsearch"
    assert set(data["limits"]) == set(
        __import__("reference.check", fromlist=["NUMBERS"]).NUMBERS)


@pytest.mark.parametrize("w", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_workloads_resolve(w, test_root):
    man = tiny.manifest(test_root)
    man.config(w["config"])
    assert man.traffic(w["traffic"])["clients"] >= 1
    for trace in (False, True):
        for m in man.metrics(w["name"], trace):
            assert callable(man.reader(m["name"]))


def test_rooflines_resolve():
    for name in os.listdir(os.path.join(tiny.BENCH, "metrics")):
        text = open(os.path.join(tiny.BENCH, "metrics", name)).read()
        for count in re.findall(r'readings\.roofline\(ctx, "([^"]+)"\)',
                                text):
            mod = load_module(os.path.join(tiny.BENCH, "rooflines",
                                           count + ".py"))
            assert mod.KERNEL and mod.PEAK


def test_new_files_are_found(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench = os.path.join(root, "benchmarks")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        data = json.load(f)
    cfg = json.load(open(os.path.join(bench, "configs", "pdb70.json")))
    cfg.update(name="pdb70big")
    cfg["db"]["families"] = 3
    json.dump(cfg, open(os.path.join(bench, "configs", "pdb70big.json"),
                        "w"))
    json.dump({"query": "random", "length_mix": [1.0], "ss": False,
               "clients": 1},
              open(os.path.join(bench, "traffic", "plain.json"), "w"))
    with open(os.path.join(bench, "metrics", "half_setup_s.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['setup_s'] / 2\n")
    data["configs"].append({"name": "pdb70big", "source": cfg["source"],
                            "file": "benchmarks/configs/pdb70big.json",
                            "reduced": ["entries"], "why": "test"})
    data["workloads"].append({"name": "pdb70big.plain", "config":
                              "pdb70big", "traffic": "plain", "chips": 1,
                              "why": "test"})
    data["per_layer"].append({"name": "half_setup_s", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "clients", "moves": "setup_s"})
    json.dump(data, open(os.path.join(root, "BENCHMARK.json"), "w"))
    man = tiny.manifest(root)
    assert man.config("pdb70big")["db"]["families"] == 3
    assert man.traffic("plain")["length_mix"] == [1.0]
    names = [m["name"] for m in man.metrics("pdb70big.plain", True)]
    assert "half_setup_s" in names
    assert man.reader("half_setup_s")({"setup_s": 4.0}) == 2.0
