"""The readings that the limits of ``correct`` are set from.

Set-up runs once.  Then for each seed a short window of the cell's
closed loop runs, and the queries that a run of that seed would compare
are compared, as ``benchmarks/run.py`` compares them: the program's
hits and ``.hhr`` against the reference (the lower readings), and the
control, the reference one precision lower (the Viterbi recurrence and
the MAC step in bfloat16, forward and backward in float32), in the
program's place (the upper readings).  The benchmark's own runs do not
run this.

    python benchmarks/control.py --workload <cell> --seeds 1,2,3
        [--seconds 8] [--control-seeds 1,2,3] [--out readings.json]
"""

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None, manifest=None):
    import numpy as np

    from harness import dbgen
    from harness import system as S
    from harness.runner import ROOT, Loop, Manifest, check_card, warm_up
    from harness.traffic import Stream
    from reference import check as C

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    man = manifest or Manifest()
    wl = man.workload(args.workload)
    cfg = man.config(wl["config"])
    traffic = man.traffic(wl["traffic"])
    if device is None:
        check_card(wl["chips"])
        device = "cuda"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    paths = dbgen.db_paths(man.bench_dir, cfg["name"])
    dbgen.build(cfg["db"], paths["base"])
    system = S.System(cfg, paths["base"], device)
    ref = C.Reference(paths["base"])
    ctl = C.Reference(paths["base"], low=C.bf16)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    warmed = False
    for seed in [int(s) for s in args.seeds.split(",")]:
        stream = Stream(traffic, cfg["db"], seed)
        if not warmed:
            warm_up(system, stream, int(traffic["clients"]))
            warmed = True
        loop = Loop(system, stream, int(traffic["clients"]))
        t0 = loop.run(args.seconds)
        done = [r for r in sorted(loop.records, key=lambda r: r["k"])
                if "error" not in r and r["te"] <= t0 + args.seconds]
        rng = np.random.default_rng((seed, 3))
        for r in C.sample_queries(done, rng, C.N_QUERIES):
            prog = S.answer(r["out"])
            rng_c = copy.deepcopy(rng)
            t1 = time.perf_counter()
            mine = ref.run(r["text"], prog, rng)
            t_ref = time.perf_counter() - t1
            row = {"seed": seed, "query": r["name"], "length": r["length"],
                   "reference_s": t_ref,
                   "program": C.compare(prog, mine, r["name"],
                                        len(ref.db.index))[0]}
            if seed in control_seeds:
                low = ctl.run(r["text"], prog, rng_c)
                row["control"] = C.compare(C.control_answer(low), mine,
                                           r["name"])[0]
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for k in C.NUMBERS:
        ctl_v = [r["control"][k] for r in rows if "control" in r]
        summary[k] = {"program_max": max(r["program"][k] for r in rows),
                      "control_min": min(ctl_v) if ctl_v else None,
                      "limit": cfg["limits"].get(k)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")
    sys.exit(main())
