"""One run of one cell: set-up, a closed loop of client threads over the
window, the per-layer readings, the comparison with the reference, and
the result line.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# modules that may not be loaded in the process that prints the result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "hhsuite_tpu")


class RunError(Exception):
    """A run that prints no result."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module of the benchmark's data (a metric's reader, a kernel's
    work count) by its file path; names may hold dots."""
    name = "bench_" + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """BENCHMARK.json and the files its names resolve to: a cell's
    configuration (its ``file``), its traffic mix
    (``traffic/<traffic>.json``) and each metric's reader
    (``metrics/<name>.py``)."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.bench_dir = bench_dir
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))
        self.root = root

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise RunError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise RunError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      name + ".json"))

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The metrics a cell reports: its end-to-end metrics untraced,
        its per-layer metrics traced."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        metric + ".py")).read


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return ap.parse_args(argv)


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} present")


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def db_stats(base: str) -> dict:
    """Entries and residues of a database (its cs219 index: one state a
    residue, one NUL an entry)."""
    n = res = 0
    with open(base + "_cs219.ffindex") as f:
        for line in f:
            n += 1
            res += int(line.split("\t")[2]) - 1
    return {"entries": n, "residues": res}


class Loop:
    """C client threads, each taking the stream's next query when its
    last one is done, until the window closes; queries under way at the
    close run to their end (the drain) and count for no rate."""

    def __init__(self, system, stream, clients: int, fault=None):
        self.system = system
        self.stream = stream
        self.clients = clients
        self.fault = fault
        self.records: List[dict] = []
        self._lock = threading.Lock()
        self._next = 0

    def _client(self, deadline: float) -> None:
        while True:
            with self._lock:
                if time.perf_counter() >= deadline:
                    return
                k = self._next
                self._next += 1
            q = self.stream.query(k)
            rec = {"k": k, "name": q.name, "text": q.text,
                   "length": q.length, "ts": time.perf_counter()}
            try:
                out = self.system.run(q.name, q.text)
                if self.fault is not None:
                    self.fault(k, out)
                rec["out"] = out
            except Exception:      # a failed query is counted, not fatal
                rec["error"] = traceback.format_exc()
            rec["te"] = time.perf_counter()
            with self._lock:
                self.records.append(rec)

    def run(self, seconds: float) -> float:
        """Runs the window; returns its start (perf_counter).  Client 0
        runs on the calling thread, where the profiler records the
        program's host spans."""
        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._client,
                                    args=(t0 + seconds,), daemon=True)
                   for _ in range(self.clients - 1)]
        for t in threads:
            t.start()
        self._client(t0 + seconds)
        for t in threads:
            t.join()
        return t0


def warm_up(system, stream, clients: int) -> None:
    """One query alone (it opens the database cold and builds the
    kernels), then one on each client at once."""
    first, *rest = stream.warmup(1 + clients)
    system.run(first.name, first.text)
    errors: List[str] = []

    def one(q):
        try:
            system.run(q.name, q.text)
        except Exception:
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=one, args=(q,)) for q in rest]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RunError("a warm-up query failed:\n" + errors[0])


def main(argv=None, device: Optional[str] = None, fault=None,
         t_start: Optional[float] = None, out=None,
         manifest: Optional[Manifest] = None) -> int:
    """Runs one cell and prints its result line; returns the exit code.

    ``device`` (tests only) runs on that device and skips the look for
    a card; ``fault(k, output)`` alters query k's output where it is
    produced; ``manifest`` reads another root's BENCHMARK.json."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    args = parse(argv)
    try:
        result, table = run_cell(args, device, fault, t_start,
                                 manifest or Manifest())
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print("benchmark: modules of the JAX package or JAX are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for k, t in table.items():
        print(f"check {k}: {t['value']!r} (limit {t['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def run_cell(args, device, fault, t_start, man: Manifest):
    import torch

    wl = man.workload(args.workload)
    cfg = man.config(wl["config"])
    traffic = man.traffic(wl["traffic"])
    cache = os.path.join(man.bench_dir, "cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    if device is None:
        check_card(wl["chips"])
        device = "cuda"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from . import dbgen, system as S
    from .trace import Tracer
    from .traffic import Stream

    paths = dbgen.db_paths(man.bench_dir, cfg["name"])
    # the database is built once a checkout, as a deployment builds its
    # database once: set-up does not count the build
    t_db = time.perf_counter()
    dbgen.build(cfg["db"], paths["base"])
    db_build_s = time.perf_counter() - t_db
    print(f"database: {db_build_s:.3f} s to build or find", file=sys.stderr)
    setup_timers = S.stage_timers_on()
    system = S.System(cfg, paths["base"], device)
    stream = Stream(traffic, cfg["db"], args.seed)
    clients = int(traffic["clients"])
    warm_up(system, stream, clients)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_timers = dict(setup_timers)
    setup_s = time.perf_counter() - t_start - db_build_s

    timers = S.stage_timers_on()
    tracer = Tracer(bool(args.trace))
    loop = Loop(system, stream, clients, fault)
    tracer.start()
    t0 = loop.run(args.seconds)
    tracer.stop()
    timers = dict(timers)
    S.stage_timers_off()
    deadline = t0 + args.seconds
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": int(wl["chips"]), "memory_peak_bytes": peak}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}

    recs = sorted(loop.records, key=lambda r: r["k"])
    failed = [r for r in recs if "error" in r]
    for r in failed:
        print(f"query {r['name']} failed:\n{r['error']}", file=sys.stderr)
    done = [r for r in recs if "error" not in r and r["te"] <= deadline]
    for r in recs:
        hl = r["out"].hitlist if "out" in r else None
        print(f"query {r['name']}: {r['length']} residues, "
              f"{r['te'] - r['ts']:.3f} s, "
              f"{'in the window' if r['te'] <= deadline else 'drain'}, "
              f"{hl.N_searched if hl is not None else '-'} templates "
              f"searched", file=sys.stderr)
    trace = tracer.reduce() if args.trace else None
    ctx = {
        "setup_s": setup_s,
        "window_start": t0,
        "done": done,
        "all": recs,
        "timers": timers,
        "setup_timers": setup_timers,
        "trace": trace,
        "db": db_stats(paths["base"]),
        "config": cfg,
        "traffic": traffic,
        "bench_dir": man.bench_dir,
        "load_module": load_module,
    }
    metrics = {}
    for m in man.metrics(args.workload, bool(args.trace)):
        v = man.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace is not None:
        dev_info["busy_s"] = trace["busy_s"]
        dev_info["window_s"] = trace["window_s"]

    ok, table = check(cfg, paths["base"], done, args.seed, device, system)
    result = {"correct": bool(ok and not failed and done),
              "attempted": len(recs), "failed": len(failed),
              "metrics": metrics, "device": dev_info}
    if trace is not None:
        result["breakdown"] = trace["breakdown"]
    result["checked"] = table
    return result, table


def check(cfg: dict, base: str, done: List[dict], seed: int, device,
          system):
    """The comparison with the reference, once the window has closed:
    the program's database is released first."""
    import gc

    from reference import check as C

    from . import system as S

    rng = np.random.default_rng((seed, 3))
    sample = C.sample_queries(done, rng, C.N_QUERIES)
    answers = {r["k"]: S.answer(r.pop("out")) for r in sample}
    for r in done:
        r.pop("out", None)
    S.release(system)
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    ref = C.Reference(base)
    per_query, seen = [], {}
    t0 = time.perf_counter()
    for r in sample:
        prog = answers[r["k"]]
        mine = ref.run(r["text"], prog, rng)
        numbers, counts = C.compare(prog, mine, r["name"],
                                    len(ref.db.index))
        per_query.append(numbers)
        C.add_counts(seen, counts)
    print(f"reference: {len(sample)} queries "
          f"({', '.join(r['name'] for r in sample)}), compared "
          + ", ".join(f"{v} {k}" for k, v in seen.items())
          + f", {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    numbers = C.merge_numbers(per_query) if per_query else {}
    return C.judge(numbers, cfg["limits"])
