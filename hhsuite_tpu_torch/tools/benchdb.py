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


# Chou & Fasman (1978) conformational parameters x 100: helix P(a),
# strand P(b) per residue, in the order of AA
_CF_HELIX = np.array([142, 70, 101, 151, 113, 57, 100, 108, 114, 121, 145,
                      67, 57, 111, 98, 77, 83, 106, 108, 69], np.float64)
_CF_STRAND = np.array([83, 119, 54, 37, 138, 75, 87, 160, 74, 130, 105, 89,
                       55, 110, 93, 75, 119, 170, 137, 147], np.float64)
_SS_CODE = np.frombuffer(b"CHE", np.uint8)


def _window_mean(x: np.ndarray, w: int) -> np.ndarray:
    """Centered moving average over ``w`` residues, shrunk at the ends."""
    k = np.ones(w)
    return np.convolve(x, k, "same") / np.convolve(np.ones_like(x), k, "same")


def _drop_short_runs(ss: np.ndarray, state: int, min_len: int) -> None:
    """Turn runs of ``state`` shorter than ``min_len`` into coil (0)."""
    is_s = np.concatenate([[False], ss == state, [False]])
    edges = np.flatnonzero(np.diff(is_s.astype(np.int8)))
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < min_len:
            ss[a:b] = 0


# predict_ss thresholds: window-mean helix propensity, strand propensity,
# and the strand mean's handicap against the helix mean (set so that
# sequences of uniform residue composition come out ~37% H, ~21% E,
# ~42% C, near PSIPRED's composition on globular proteins)
_SS_HELIX_MIN, _SS_STRAND_MIN, _SS_STRAND_HANDICAP = 97.0, 112.0, 10.0


def predict_ss(seq: str) -> Tuple[str, str]:
    """A deterministic Chou-Fasman-style secondary-structure prediction
    of one sequence: (ss_pred over {H, E, C}, ss_conf digits 0-9).

    Helix and strand propensities (Chou & Fasman 1974/1978) are averaged
    over windows of 6 and 5 residues (their nucleation windows).  A
    residue is H where the helix mean is at least 97 and above the
    strand mean less 10, E where the strand mean is at least 112 and
    above the helix mean plus 10, else C; helices shorter than 4 and
    strands shorter than 3 residues become coil.  The confidence digit
    grows with the winning state's smallest margin over its rules (for
    coil: how far both means are below their thresholds).  No random
    generator is used, so homologues share SS where their residues
    agree."""
    idx = np.frombuffer(seq.encode(), np.uint8)
    aa = np.frombuffer("".join(AA).encode(), np.uint8)
    lut = np.full(256, -1, np.int64)
    lut[aa] = np.arange(20)
    k = lut[idx]
    known = k >= 0
    pa = np.where(known, _CF_HELIX[np.maximum(k, 0)], 100.0)
    pb = np.where(known, _CF_STRAND[np.maximum(k, 0)], 100.0)
    ha = _window_mean(pa, 6)
    hb = _window_mean(pb, 5) - _SS_STRAND_HANDICAP
    hb_min = _SS_STRAND_MIN - _SS_STRAND_HANDICAP
    ss = np.zeros(len(idx), np.int8)                 # 0 C, 1 H, 2 E
    ss[(ha >= _SS_HELIX_MIN) & (ha > hb)] = 1
    ss[(hb >= hb_min) & (hb > ha)] = 2
    _drop_short_runs(ss, 1, 4)
    _drop_short_runs(ss, 2, 3)
    margin = np.where(
        ss == 1, np.minimum(ha - _SS_HELIX_MIN, ha - hb),
        np.where(ss == 2, np.minimum(hb - hb_min, hb - ha),
                 np.minimum(_SS_HELIX_MIN - ha, hb_min - hb)))
    conf = np.clip(np.round(np.maximum(margin, 0.0) / 2.5) + 1, 0, 9)
    return (_SS_CODE[ss].tobytes().decode(),
            (conf.astype(np.uint8) + ord("0")).tobytes().decode())


def _with_ss(a3m: str) -> str:
    """Prefix a single-sequence a3m entry with its predicted SS rows."""
    header, seq = a3m.split("\n")[:2]
    pred, conf = predict_ss(seq)
    return (f">ss_pred Chou-Fasman predicted secondary structure\n{pred}\n"
            f">ss_conf Chou-Fasman confidence values\n{conf}\n"
            f"{header}\n{seq}\n")


def build_ss_db(base: str, family_base: str, query_a3m: str) -> str:
    """Build <base>_{a3m,cs219}.ff{data,index} from the benchmark
    database ``family_base`` with every entry annotated with
    ``>ss_pred``/``>ss_conf`` rows (:func:`predict_ss`) before its
    sequence; returns ``query_a3m`` (the family's query) annotated the
    same way.  The cs219 file is the family's, byte for byte (the
    sequences are the same).  There is no hhm file: the search builds
    each HMM from its a3m, SS rows included."""
    import shutil

    from ..io.ffindex import FFindexDatabase, FFindexWriter

    query = _with_ss(query_a3m)
    done_marker = base + ".done"
    if os.path.exists(done_marker):
        return query
    fam = FFindexDatabase(f"{family_base}_a3m.ffdata",
                          f"{family_base}_a3m.ffindex")
    with FFindexWriter(base + "_a3m.ffdata", base + "_a3m.ffindex") as w:
        for e in fam.entries:
            w.add(e.name, _with_ss(fam.read_text(e)).encode())
    for ext in (".ffdata", ".ffindex"):
        shutil.copyfile(f"{family_base}_cs219{ext}", f"{base}_cs219{ext}")
    with open(done_marker, "w") as f:
        f.write("ok\n")
    return query


def ss_composition(base: str) -> dict:
    """Fractions of H, E and C over every ``ss_pred`` row of <base>_a3m."""
    from ..io.ffindex import FFindexDatabase

    db = FFindexDatabase(f"{base}_a3m.ffdata", f"{base}_a3m.ffindex")
    counts = np.zeros(256, np.int64)
    for e in db.entries:
        pred = db.read_text(e).split("\n")[1]    # the row after >ss_pred
        counts += np.bincount(np.frombuffer(pred.encode(), np.uint8),
                              minlength=256)
    n = max(int(counts.sum()), 1)
    return {c: float(counts[ord(c)]) / n for c in "HEC"}
