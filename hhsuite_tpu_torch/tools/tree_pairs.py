"""Time two source trees of the port against each other on one card.

    python -m hhsuite_tpu_torch.tools.tree_pairs \\
        --tree parent=<dir of the parent commit> --tree change=. \\
        --order parent,change,change,parent [--parts walk,realign,4,5,6] \\
        [--log-dir DIR]

Each tree is a checkout of the repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists).  For each group of
parts, the trees run one after another in ``--order``, each in a child
process of its own that imports that tree's ``chip_smoke.py`` and
``hhsuite_tpu_torch`` (the tree's kernels built into its own
``hhsuite_tpu_torch/build/`` by its ``phase0_builds``) and calls that
tree's own phases:

* ``walk``: its ``phase1_walk`` on K2's outputs at phase 1's shape
  (B = 4096, Lq = 320, Lt = 384, kmax = 705; the storage view and
  contiguous bytes);
* ``realign``: its ``phase1_realign`` (R1-R4 at phase 1's chunk, B =
  256, Lq = 300, Lt_pad = 384, the other forms it times, and its edges);
* ``4``, ``5``, ``6``: its ``phase4_full``, ``phase5_hhblits`` and
  ``phase6_ss`` on the benchmark databases, which this script builds
  first with the current tree's ``chip_smoke.DB_BUILD`` under
  ``chip_smoke_cache/`` (as ``chip_smoke.py`` does).

Every child's output goes to ``<log-dir>/tree_pairs-<k>-<tree>.log``
(``chip_smoke_cache/tree_pairs/`` by default); the lines that carry the
comparison (the phases' kernel times as JSON, walls, device times from
CUDA events, the host decoder's .hhr count) are printed, prefixed by the
tree's name.  Needs a card; exits non-zero when any child fails.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHILD = r'''
import json, sys, time
sys.path.insert(0, {tree!r})
import torch
import chip_smoke as c

dev = torch.device("cuda")
parts = {parts!r}
c.log("card: " + c.card_line())
t0 = time.perf_counter()
usage = c.phase0_builds()
c.log(f"builds {{time.perf_counter() - t0:.1f}} s")


def times(rec):
    return {{k: rec[k] for k in ("ms", "contiguous_ms", "other_ms",
                                 "plain_ms", "ptxas") if k in rec}}


if "walk" in parts:
    from hhsuite_tpu_torch.ops.viterbi_lanes import viterbi_backtrace_lanes
    x = c.synth_inputs(c.LQ, c.LT, c.B_K2, c.SEED + 1, dev)
    out_k = viterbi_backtrace_lanes(*x, -0.03, Lq_true=c.LQ)
    out_p = tuple(t.contiguous() for t in out_k)
    c.log("PAIR W1 " + json.dumps(times(c.phase1_walk(out_k, out_p,
                                                       usage))))
    del x, out_k, out_p
if "realign" in parts:
    recs = c.phase1_realign(dev, usage)
    for key in sorted(recs):
        c.log(f"PAIR {{key}} " + json.dumps(times(recs[key])))
bases = {bases!r}
counters = c.kernel_counters()
if "4" in parts:
    with open(bases["8k"] + ".query.a3m") as f:
        c.phase4_full(bases["8k"], f.read(), counters)
if "5" in parts:
    with open(bases["8k"] + ".query.a3m") as f:
        c.phase5_hhblits(bases["big"], f.read(), counters, dev)
if "6" in parts:
    with open(bases["ss8k"] + ".query.a3m") as f:
        c.phase6_ss(bases["ss8k"], f.read(), counters)
c.log(f"child done {{time.perf_counter() - t0:.1f}} s")
'''

# the lines of a child's output that carry the comparison
KEEP = re.compile(r"^(card:|builds|PAIR|child done|phase[456] (cold|warm)[: ]"
                  r"|phase[456] .*(device time|realign on the card|"
                  r"profiled:|round)|phase0 (R3|W1)|phase1 (W1|R))")


def databases(cache):
    """The benchmark databases' base paths under ``cache``, and the
    process that builds them with the current tree's ``chip_smoke``."""
    sys.path.insert(0, REPO)
    import chip_smoke as c

    names = dict(
        fam512="bench512", fam8k="bench8192mix",
        fam_small=f"bench{c.N_FAMILY_SMALL}",
        dec_small=f"bench{c.N_FAMILY_SMALL}_decoys{c.N_DECOYS_SMALL}",
        big=f"bench8192mix_decoys_{c.N_ENTRIES_BIG}",
        ss_small=f"bench{c.N_FAMILY_SMALL}_ss", ss8k="bench8192mix_ss")
    paths = {k: os.path.join(cache, v) for k, v in names.items()}
    proc = subprocess.Popen(
        [sys.executable, "-c", c.DB_BUILD.format(
            repo=REPO, nfam=c.N_FAMILY_SMALL, ndec=c.N_DECOYS_SMALL,
            nbig=c.N_ENTRIES_BIG)] + list(paths.values()),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"8k": paths["fam8k"], "big": paths["big"],
            "ss8k": paths["ss8k"]}, proc


def run_child(k, name, tree, parts, bases, log_dir):
    """One tree's parts in a child process; returns its exit code."""
    log = os.path.join(log_dir, f"tree_pairs-{k}-{name}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(
            [sys.executable, "-c", CHILD.format(tree=tree, parts=parts,
                                                bases=bases)],
            cwd=tree, stdout=f, stderr=subprocess.STDOUT).returncode
    with open(log) as f:
        for ln in f:
            if KEEP.search(ln) or rc:
                print(f"[{name}] {ln.rstrip()}", flush=True)
    print(f"[{name}] parts {','.join(parts)}: exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout of the repository")
    ap.add_argument("--order", required=True,
                    help="tree names in turn, e.g. parent,change,change,"
                    "parent")
    ap.add_argument("--parts", default="walk,realign,4,5,6")
    ap.add_argument("--log-dir", default=os.path.join(
        REPO, "chip_smoke_cache", "tree_pairs"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tree_pairs: no CUDA device available", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    trees = {k: os.path.abspath(v) for k, v in trees.items()}
    order = args.order.split(",")
    parts = args.parts.split(",")
    os.makedirs(args.log_dir, exist_ok=True)
    groups = [p for p in (["walk", "realign"], ["4", "5", "6"])
              if any(x in parts for x in p)]
    bases, proc = {}, None
    if any(x in parts for x in ("4", "5", "6")):
        cache = os.path.join(REPO, "chip_smoke_cache")
        os.makedirs(cache, exist_ok=True)
        bases, proc = databases(cache)
    rc, k = 0, 0
    try:
        for group in groups:
            sel = [x for x in group if x in parts]
            if proc is not None and group[0] == "4":
                out, _ = proc.communicate(timeout=1200)
                print(out.rstrip(), flush=True)
                if proc.returncode:
                    return 1
                proc = None
            for name in order:
                k += 1
                rc |= run_child(k, name, trees[name], sel, bases,
                                args.log_dir)
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
