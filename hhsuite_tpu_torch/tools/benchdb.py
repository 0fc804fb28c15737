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


def _ragged_copy(out: np.ndarray, dst: np.ndarray, src: np.ndarray,
                 src_start: np.ndarray, lens: np.ndarray,
                 chunk: int = 1 << 16) -> None:
    """out[dst[k] : dst[k] + lens[k]] = src[src_start[k] : ... + lens[k]]
    for every k, vectorized ``chunk`` rows at a time."""
    for s in range(0, len(lens), chunk):
        ln = lens[s: s + chunk]
        rowid = np.repeat(np.arange(len(ln)), ln)
        first = np.zeros(len(ln), np.int64)
        np.cumsum(ln[:-1], out=first[1:])
        within = np.arange(int(ln.sum()), dtype=np.int64) - first[rowid]
        out[dst[s: s + chunk][rowid] + within] = \
            src[src_start[s: s + chunk][rowid] + within]


def build_decoy_db(base: str, family_base: str, n_decoys: int,
                   seed: int = 20261016) -> int:
    """Build <base>_{a3m,hhm,cs219}.ff{data,index}: every entry of the
    benchmark database ``family_base`` plus ``n_decoys`` decoys; returns
    the number of entries.

    Decoys are windows of the family's random tier-7 entries: their
    sequences, and their cs219 state strings, are concatenated and cut
    at the same positions, so a decoy's cs219 is a real translation of a
    random protein (up to the context at the window's edges) and its a3m
    holds the same residues.  Window lengths are drawn from the family's
    own length mix; a residue of the tier-7 pool is reused by about
    n_decoys * mean_length / pool_size decoys.  Decoys have no hhm entry
    (the search builds their HMMs from the a3m).  Built in bulk with
    numpy: one data and one index write per file, in seconds.
    """
    import shutil

    from ..io.ffindex import FFindexDatabase

    done_marker = base + ".done"
    if os.path.exists(done_marker):
        return int(open(done_marker).read())
    fam = {s: FFindexDatabase(f"{family_base}_{s}.ffdata",
                              f"{family_base}_{s}.ffindex")
           for s in ("a3m", "cs219")}
    aa_parts, cs_parts = [], []
    for e in fam["a3m"].entries:
        header, *rows = fam["a3m"].read_text(e).split("\n")
        if not header.endswith(" tier7"):
            continue
        seq = "".join(rows).encode()
        cs = fam["cs219"].read_bytes(e.name)
        if len(cs) != len(seq):
            raise ValueError(f"{e.name}: {len(cs)} cs219 states for "
                             f"{len(seq)} residues")
        aa_parts.append(seq)
        cs_parts.append(cs)
    aa = np.frombuffer(b"".join(aa_parts), np.uint8)
    cs = np.frombuffer(b"".join(cs_parts), np.uint8)
    fam_lens = np.array([e.length - 1 for e in fam["cs219"].entries])
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.choice(fam_lens, n_decoys), aa.size).astype(np.int64)
    starts = rng.integers(0, aa.size - lens + 1).astype(np.int64)

    names = [f"d{k:07d}.a3m" for k in range(n_decoys)]
    hdr = np.frombuffer("".join(f">d{k:07d} decoy\n" for k in range(n_decoys)
                                ).encode(), np.uint8)
    H = hdr.size // max(n_decoys, 1)
    for suffix, sizes in (("a3m", H + lens + 2), ("cs219", lens + 1)):
        with open(f"{family_base}_{suffix}.ffdata", "rb") as f:
            fam_data = f.read()
        with open(f"{family_base}_{suffix}.ffindex") as f:
            fam_index = f.read()
        off = np.zeros(n_decoys, np.int64)
        np.cumsum(sizes[:-1], out=off[1:])
        out = np.zeros(int(sizes.sum()), np.uint8)
        if suffix == "a3m":
            out[(off[:, None] + np.arange(H)).reshape(-1)] = hdr
            _ragged_copy(out, off + H, aa, starts, lens)
            out[off + H + lens] = ord("\n")
        else:
            _ragged_copy(out, off, cs, starts, lens)
        index = "".join(f"{n}\t{o}\t{s}\n" for n, o, s in
                        zip(names, (off + len(fam_data)).tolist(),
                            sizes.tolist()))
        with open(f"{base}_{suffix}.ffdata", "wb") as f:
            f.write(fam_data)
            f.write(out.tobytes())
        with open(f"{base}_{suffix}.ffindex", "w") as f:
            f.write(fam_index + index)
    for ext in (".ffdata", ".ffindex"):
        shutil.copyfile(f"{family_base}_hhm{ext}", f"{base}_hhm{ext}")
    n = len(fam["cs219"]) + n_decoys
    with open(done_marker, "w") as f:
        f.write(f"{n}\n")
    return n
