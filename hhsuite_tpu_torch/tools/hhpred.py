"""hhpred: end-to-end structure-prediction pipeline wrapper
(equivalent of scripts/hhpred/hhpred.pl).

Stages (hhpred.pl:100-200): query FASTA/A3M -> hhblits query MSA ->
addss secondary-structure annotation -> hhsearch against a template
database -> template selection -> hhmakemodel alignment (PIR) ->
MODELLER.  The first four stages run natively in this package; MODELLER
is an external licensed program and is invoked only when found on
$PATH (otherwise the pipeline stops after writing the PIR alignment and
prints the MODELLER command to run).

Template selection is selectTemplatesHeuristic.pm's: its scoring
heuristic over the -atab posteriors (SingleTemplateSelection for one
template), top-N by probability when the posteriors are missing.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import List, Optional


def parse_atab_posteriors(text: str, query_length: int):
    """Per-hit posterior arrays over query positions from -atab output
    (presetAccPosteriors, selectTemplatesHeuristic.pm:79-180: posterior
    column per aligned query position, zeroed where dssp is '-')."""
    posts = []
    cur = None
    for line in text.splitlines():
        if line.startswith(">"):
            cur = [0.0] * query_length
            posts.append(cur)
        elif cur is not None:
            parts = line.split()
            if len(parts) >= 5 and parts[0].isdigit():
                try:
                    p = float(parts[4])
                except ValueError:
                    continue
                i = int(parts[0]) - 1
                dssp = parts[5] if len(parts) >= 6 else None
                if 0 <= i < query_length:
                    cur[i] = 0.0 if dssp == "-" else p
    return posts


def preselect_templates(n: int, order_pool):
    """preselectTemplates (selectTemplatesHeuristic.pm:24-64): union of
    the best n by similarity, by SumProbs/Cols, and by probability (in
    that order, duplicates skipped).  ``order_pool`` is a list of
    (idx, sim, sumprob_l, prob); returns chosen idx list."""
    chosen = []

    def add(key):
        for idx, *_rest in sorted(order_pool, key=key)[:n]:
            if idx not in chosen:
                chosen.append(idx)

    add(lambda t: -t[1])
    add(lambda t: -t[2])
    add(lambda t: -t[3])
    return chosen


def choose_templates_scoring_heuristic(results, posteriors,
                                       query_length: int,
                                       max_num: int = 100,
                                       preselect: int = 1):
    """ChooseTemplatesScoringHeuristic (selectTemplatesHeuristic.pm:
    216-492), faithful port.

    Scores every unaccepted template t as
        S(t) = sum_{i in A_t, P_t(i)>0} exp(alpha*(Prob_t*P_t(i)
                                             - maxProb(i))) - yshift
    with alpha=1, yshift=0.95, accepts the argmax (same-name hits must
    not overlap an accepted copy by more than 50% in template
    coordinates), and updates maxProb(i) with the winner's
    Prob_t*P_t(i).  preselect=1 first seeds the chosen set with the
    best-3-by-{sim, SumProbs/Cols, prob} union; preselect=2 seeds the
    first hit and stops once a round's best score is <= 0.

    Returns indices into ``results`` in acceptance order.
    """
    n = len(results)
    prob = [(r.probability or 0.0) / 100.0 for r in results]
    sim = [r.similarity or 0.0 for r in results]
    spl = [(r.sum_probs or 0.0) / max(r.aligned_cols or 1, 1)
           for r in results]
    tstart = [r.start[1] for r in results]
    tend = [r.end[1] for r in results]
    name = [r.template_id for r in results]

    chosen: List[int] = []
    accepted_by_name: dict = {}
    accepted_set = set()
    max_prob = [0.0] * query_length

    def update_max_prob(idx):
        ph = prob[idx]
        for i in range(query_length):
            v = ph * posteriors[idx][i]
            if v > max_prob[i]:
                max_prob[i] = v

    if preselect == 1:
        pool = [(k, sim[k], spl[k], prob[k] * 100.0) for k in range(n)]
        for idx in preselect_templates(3, pool):
            chosen.append(idx)
            accepted_set.add(idx)
            accepted_by_name.setdefault(name[idx], []).append(idx)
            update_max_prob(idx)
    elif preselect == 2 and n:
        chosen.append(0)
        accepted_set.add(0)
        accepted_by_name.setdefault(name[0], []).append(0)
        update_max_prob(0)

    import math

    alpha, yshift, overlap_thr = 1.0, 0.95, 0.5
    candidate = None
    while True:
        if candidate is not None:
            idx = candidate
            ok = True
            for prev in accepted_by_name.get(name[idx], []):
                min_last = min(tend[prev], tend[idx])
                max_first = max(tstart[prev], tstart[idx])
                max_last = max(tend[prev], tend[idx])
                min_first = min(tstart[prev], tstart[idx])
                denom = max_last - min_first
                if denom and (min_last - max_first) / denom > overlap_thr:
                    ok = False
                    break
            if ok:
                accepted_by_name.setdefault(name[idx], []).append(idx)
                chosen.append(idx)
                update_max_prob(idx)
        candidate = None
        best_score = -999999.0
        best_idx = -1
        for k in range(n):
            if k in accepted_set:
                continue
            ts = 0.0
            pk = posteriors[k]
            ph = prob[k]
            for i in range(query_length):
                if pk[i] == 0.0:
                    continue
                ts += math.exp(alpha * (ph * pk[i] - max_prob[i])) \
                    - yshift
            ts = float(f"{ts:.3f}")      # the Perl sprintf rounding
            if ts > best_score:
                best_score = ts
                best_idx = k
        if best_idx == -1:
            break
        if preselect == 2 and best_score <= 0:
            break
        if len(chosen) >= max_num:
            break
        candidate = best_idx
        accepted_set.add(best_idx)
    return chosen


def single_template_selection(results, query_length: int):
    """SingleTemplateSelection (selectTemplatesHeuristic.pm:494-528):
    accept down the hit list any template whose query range overlaps
    accepted coverage by < 20 columns and adds > 40 new ones (keeps
    the reference's exclusive-end coverage update)."""
    max_overlap, min_new = 20, 40
    coverage = [0] * query_length
    chosen = []
    for k, r in enumerate(results):
        q0 = r.start[0] - 1
        q1 = min(r.end[0] - 1, query_length - 1)
        aligned = sum(1 for i in range(q0, q1 + 1) if coverage[i])
        unaligned = (q1 - q0 + 1) - aligned
        if aligned < max_overlap and unaligned > min_new:
            for j in range(q0, q1):      # reference leaves qEnd open
                coverage[j] = 1
            chosen.append(k)
    return chosen


def _select_templates(results, max_templates: int, min_prob: float,
                      posteriors=None, query_length: int = 0,
                      single: bool = False):
    """Template selection (hhpred.pl:195-240): the scoring heuristic
    with preselect=1 (multi-template mode) or SingleTemplateSelection;
    falls back to top-N by probability when no posteriors are
    available (atab missing)."""
    if posteriors is not None and query_length > 0:
        if single:
            idxs = single_template_selection(results, query_length)
        else:
            idxs = choose_templates_scoring_heuristic(
                results, posteriors, query_length)
        idxs = idxs[:max_templates]
        return [results[k] for k in idxs]
    ranked = sorted(results, key=lambda r: -(r.probability or 0.0))
    return ranked[:max_templates]


def hhpred(argv: List[str]) -> int:
    infile = outbase = None
    db = None
    pdbdir = None
    rounds = 3
    max_templates = 4
    min_prob = 50.0
    horiz = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            infile = argv[i]
        elif a == "-o":
            i += 1
            outbase = argv[i]
        elif a == "-d":
            i += 1
            db = argv[i]
        elif a == "-pdbdir":
            i += 1
            pdbdir = argv[i]
        elif a == "-n":
            i += 1
            rounds = int(argv[i])
        elif a == "-mult":
            i += 1
            max_templates = int(argv[i])
        elif a == "-horiz":
            i += 1
            horiz = argv[i]
        i += 1
    if not infile or not outbase or not db:
        print("hhpred -i <query.fasta|a3m> -o <outbase> -d <template db "
              "base> [-pdbdir <dir with template cif/pdb>] [-n rounds] "
              "[-mult N] [-horiz psipred.horiz]", file=sys.stderr)
        return 4

    from ..cli import cmd_hhblits, cmd_hhsearch
    from .addss import addss
    from .hhmakemodel import main as hhmakemodel_main

    a3m = outbase + ".a3m"
    with open(infile) as f:
        text = f.read()
    is_a3m = infile.endswith(".a3m") or text.count(">") > 1

    # 1. query MSA (hhblits; skipped when an a3m is already given)
    if is_a3m:
        shutil.copyfile(infile, a3m)
    else:
        rc = cmd_hhblits(["-i", infile, "-d", db, "-oa3m", a3m,
                          "-n", str(rounds), "-mact", "0.35"])
        if rc != 0:
            print("ERROR: hhblits stage failed", file=sys.stderr)
            return rc

    # 2. secondary structure (gated on PSIPRED availability)
    args = ["-i", a3m]
    if horiz:
        args += ["-horiz", horiz]
    rc = addss(args)
    if rc != 0:
        print("WARNING: addss skipped (PSIPRED unavailable); continuing "
              "without ss_pred scoring", file=sys.stderr)

    # 3. search the template database (atab carries the per-position
    # posteriors the selection heuristic scores with)
    hhr = outbase + ".hhr"
    atab = outbase + ".atab"
    rc = cmd_hhsearch(["-i", a3m, "-d", db, "-o", hhr,
                       "-atab", atab, "-mact", "0.05"])
    if rc != 0:
        print("ERROR: hhsearch stage failed", file=sys.stderr)
        return rc

    # 4. template selection (selectTemplatesHeuristic.pm port)
    from ..io.hhr import read_result

    results = read_result(hhr)
    if not results:
        print("ERROR: no templates found", file=sys.stderr)
        return 1
    query_length = 0
    with open(hhr) as f:
        for line in f:
            if line.startswith("Match_columns"):
                query_length = int(line.split()[1])
                break
    posteriors = None
    if os.path.exists(atab) and query_length:
        posts = parse_atab_posteriors(open(atab).read(), query_length)
        if len(posts) >= len(results):
            posteriors = posts[: len(results)]
    chosen = _select_templates(results, max_templates, min_prob,
                               posteriors=posteriors,
                               query_length=query_length,
                               single=(max_templates == 1))
    ranks = [results.index(c) + 1 for c in chosen]
    print(f"Selected templates: "
          + ", ".join(c.template_id for c in chosen), file=sys.stderr)

    # 5. PIR alignment for MODELLER
    pir = outbase + ".pir"
    args = ["-i", hhr, "-pir", pir]
    if ranks:
        args += ["-m"] + [str(r) for r in ranks]
    if pdbdir:
        args += ["-cifs", pdbdir, "-ocifs", os.path.dirname(outbase)
                 or "."]
    rc = hhmakemodel_main(args)
    if rc != 0:
        print("ERROR: hhmakemodel stage failed", file=sys.stderr)
        return rc

    # 6. MODELLER (external, licensed)
    mod = None
    for cand in ("mod10.4", "mod10.3", "mod10.2", "mod10.1", "mod9.25",
                 "modeller"):
        if shutil.which(cand):
            mod = cand
            break
    if mod is None:
        print(f"PIR alignment written to {pir}.\n"
              f"MODELLER not found on $PATH — to build the model, "
              f"install MODELLER and run its automodel on {pir}.",
              file=sys.stderr)
        return 0
    script = outbase + "_modeller.py"
    knowns = ", ".join(f"'{c.template_id}'" for c in chosen)
    with open(script, "w") as f:
        f.write(
            "from modeller import *\n"
            "from modeller.automodel import *\n"
            "env = environ()\n"
            f"env.io.atom_files_directory = ['.', '{pdbdir or '.'}']\n"
            f"a = automodel(env, alnfile='{pir}',\n"
            f"              knowns=[{knowns}],\n"
            f"              sequence='{results[0].query_id}')\n"
            "a.starting_model = a.ending_model = 1\n"
            "a.make()\n")
    rc = subprocess.call([mod, script])
    return rc
