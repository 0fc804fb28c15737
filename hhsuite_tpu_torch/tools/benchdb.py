"""Deterministic synthetic benchmark database.

Generates a protein-family-like database (one ancestor sequence, each
template a mutated/indel'd descendant, single-sequence a3m entries) and
builds the full <base>_{a3m,hhm,cs219} triplet with this package's own
tools — the same interchange formats the reference binaries read, so the
identical database can be timed under both engines.

Sizes default to a PDB70-like operating point scaled down for bench
runtime: ~L 250-350 templates, query L ~300.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype="S1").astype("U1")


def _mutate(rng, seq: List[str], sub_rate: float, indel_rate: float
            ) -> List[str]:
    out = []
    for c in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue                      # deletion
        if r < indel_rate:
            out.append(str(rng.choice(AA)))   # insertion
        if rng.random() < sub_rate:
            out.append(str(rng.choice(AA)))
        else:
            out.append(c)
    return out


def generate_family(n_templates: int = 512, L0: int = 300,
                    seed: int = 20260820, length_mix: bool = False
                    ) -> Tuple[str, List[Tuple[str, str]]]:
    """Returns (query_a3m_text, [(entry_name, a3m_text), ...]).

    ``length_mix=False`` keeps the original deterministic stream (the
    512-template operating point the reference binary was timed on).
    ``length_mix=True`` adds a PDB70-like long-tail length
    distribution: ~20% single-domain fragments (half length), ~10%
    two-domain duplications (1.5x), drawn from a per-entry generator so
    the base stream is untouched."""
    rng = np.random.default_rng(seed)
    ancestor = [str(c) for c in rng.choice(AA, size=L0)]
    query = "".join(_mutate(rng, ancestor, 0.25, 0.04))
    query_a3m = f">bench_query synthetic family root\n{query}\n"
    entries = []
    for k in range(n_templates):
        # mix of close homologs, remote homologs and decoys
        tier = k % 8
        if tier < 4:
            sub, ind = 0.30, 0.05
        elif tier < 7:
            sub, ind = 0.55, 0.08
        else:
            sub, ind = 1.00, 0.10      # effectively random
        anc_k = ancestor
        rk = rng
        if length_mix:
            rk = np.random.default_rng((seed, k))
            u = rk.random()
            if u < 0.20:          # fragment
                half = len(ancestor) // 2
                start = int(rk.integers(0, len(ancestor) - half))
                anc_k = ancestor[start: start + half]
            elif u > 0.90:        # tandem duplication
                anc_k = ancestor + ancestor[: len(ancestor) // 2]
        t = "".join(_mutate(rk, anc_k, sub, ind))
        entries.append((f"b{k:04d}.a3m", f">b{k:04d} tier{tier}\n{t}\n"))
    return query_a3m, entries


_POOL_STATE: dict = {}


def _build_one(args):
    from ..apps import hhmake
    from ..cs.context_lib import (ContextLibrary, cstranslate_a3m,
                                  default_pc_engine)

    if not _POOL_STATE:     # per-worker singletons
        _POOL_STATE["lib"] = ContextLibrary.default_cs219()
        _POOL_STATE["pc"] = default_pc_engine()
    name, text = args
    cs = cstranslate_a3m(text, _POOL_STATE["lib"],
                         pc_engine=_POOL_STATE["pc"], pc_admix=0.3,
                         pc_ali=4.0)
    return (name, cs, hhmake(text, name, None,
                             argv=["hhmake", "-i", name]))


def build_bench_db(base: str, n_templates: int = 512, L0: int = 300,
                   seed: int = 20260820, with_hhm: bool = True,
                   length_mix: bool = False) -> str:
    """Build <base>_{a3m,hhm,cs219}.ff{data,index}; returns query a3m."""
    from ..apps import hhmake
    from ..cs.context_lib import (ContextLibrary, cstranslate_a3m,
                                  default_pc_engine)
    from ..io.ffindex import FFindexWriter

    query_a3m, entries = generate_family(n_templates, L0, seed,
                                         length_mix=length_mix)
    done_marker = base + ".done"
    if os.path.exists(done_marker):
        return query_a3m

    with FFindexWriter(base + "_a3m.ffdata", base + "_a3m.ffindex") as w:
        for name, text in entries:
            w.add(name, text.encode())
    if n_templates >= 2048:
        # big build points fan the per-entry cstranslate+hhmake work
        # over a process pool (hhsuitedb-style, scripts/hhsuitedb.py)
        import multiprocessing as mp

        with mp.Pool(max(2, os.cpu_count() or 2)) as pool:
            results = pool.map(_build_one, entries, chunksize=64)
        with FFindexWriter(base + "_cs219.ffdata",
                           base + "_cs219.ffindex") as w:
            for name, cs, _hhm in results:
                w.add(name, cs)
        if with_hhm:
            with FFindexWriter(base + "_hhm.ffdata",
                               base + "_hhm.ffindex") as w:
                for name, _cs, hhm in results:
                    w.add(name, hhm)
    else:
        lib = ContextLibrary.default_cs219()
        pc = default_pc_engine()
        with FFindexWriter(base + "_cs219.ffdata",
                           base + "_cs219.ffindex") as w:
            for name, text in entries:
                w.add(name, cstranslate_a3m(text, lib, pc_engine=pc,
                                            pc_admix=0.3, pc_ali=4.0))
        if with_hhm:
            with FFindexWriter(base + "_hhm.ffdata",
                               base + "_hhm.ffindex") as w:
                for name, text in entries:
                    w.add(name, hhmake(text, name, None,
                                       argv=["hhmake", "-i", name]))
    with open(done_marker, "w") as f:
        f.write("ok\n")
    return query_a3m
