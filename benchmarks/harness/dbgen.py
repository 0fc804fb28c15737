"""The benchmark's databases and queries, made from seeds.

Frozen copies of the synthetic family generator (one ancestor a family,
members mutated in 8 divergence tiers, a PDB70-like length mix) and the
Chou-Fasman-style secondary structure prediction.  Nothing here calls
the program.

A database belongs to a configuration: it is made from the
configuration's ``db`` block alone and built once per checkout into
``benchmarks/cache/<config>/``; ``--seed`` only makes the traffic.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype="S1").astype("U1")

# (substitution rate, indel rate) of the 8 tiers: 0-3 close, 4-6 remote
# homologues, 7 unrelated
TIERS = [(0.30, 0.05)] * 4 + [(0.55, 0.08)] * 3 + [(1.00, 0.10)]


def mutate(rng, seq: List[str], sub_rate: float, indel_rate: float
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


def ancestor(db: dict, family: int) -> List[str]:
    rng = np.random.default_rng((db["db_seed"], family))
    return [str(c) for c in rng.choice(AA, size=db["L0"])]


def family_members(db: dict, family: int, prefix: str
                   ) -> List[Tuple[str, str]]:
    """[(name, sequence)] of one family: member k in tier k % 8, 20% of
    them half-length fragments and 10% 1.5x duplications."""
    anc = ancestor(db, family)
    out = []
    for k in range(db["members_per_family"]):
        sub, ind = TIERS[k % 8]
        rk = np.random.default_rng((db["db_seed"], family, k))
        anc_k = anc
        u = rk.random()
        if u < 0.20:
            half = len(anc) // 2
            start = int(rk.integers(0, len(anc) - half))
            anc_k = anc[start: start + half]
        elif u > 0.90:
            anc_k = anc + anc[: len(anc) // 2]
        out.append((f"{prefix}{k:05d}", "".join(mutate(rk, anc_k, sub, ind))))
    return out


# Chou & Fasman (1978) conformational parameters x 100: helix P(a),
# strand P(b) per residue, in the order of AA
_CF_HELIX = np.array([142, 70, 101, 151, 113, 57, 100, 108, 114, 121, 145,
                      67, 57, 111, 98, 77, 83, 106, 108, 69], np.float64)
_CF_STRAND = np.array([83, 119, 54, 37, 138, 75, 87, 160, 74, 130, 105, 89,
                       55, 110, 93, 75, 119, 170, 137, 147], np.float64)
_SS_CODE = np.frombuffer(b"CHE", np.uint8)
_SS_HELIX_MIN, _SS_STRAND_MIN, _SS_STRAND_HANDICAP = 97.0, 112.0, 10.0


def _window_mean(x: np.ndarray, w: int) -> np.ndarray:
    k = np.ones(w)
    return np.convolve(x, k, "same") / np.convolve(np.ones_like(x), k, "same")


def _drop_short_runs(ss: np.ndarray, state: int, min_len: int) -> None:
    is_s = np.concatenate([[False], ss == state, [False]])
    edges = np.flatnonzero(np.diff(is_s.astype(np.int8)))
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < min_len:
            ss[a:b] = 0


def predict_ss(seq: str) -> Tuple[str, str]:
    """(ss_pred over {H, E, C}, ss_conf digits) of one sequence: window
    means of the Chou-Fasman propensities, short runs turned to coil,
    the confidence from the winning state's margin."""
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
    ss = np.zeros(len(idx), np.int8)
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


def a3m_entry(name: str, seq: str, desc: str, ss: bool) -> str:
    """A single-sequence a3m, with ``>ss_pred``/``>ss_conf`` rows first
    when ``ss``."""
    text = f">{name} {desc}\n{seq}\n"
    if ss:
        pred, conf = predict_ss(seq)
        text = (f">ss_pred Chou-Fasman predicted secondary structure\n"
                f"{pred}\n>ss_conf Chou-Fasman confidence values\n{conf}\n"
                + text)
    return text


def states(seq: str) -> bytes:
    """The ``_cs219`` record of an entry: one state a residue (its
    amino-acid index).  hhsearch reads only the index of that file (each
    entry's name and length); no prefilter runs on these databases."""
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer("".join(AA).encode(), np.uint8)] = np.arange(20)
    return lut[np.frombuffer(seq.encode(), np.uint8)].tobytes()


def _write_ffindex(path: str, names: List[str], payloads: List[bytes]
                   ) -> None:
    """<path>.ffdata/.ffindex, entries NUL-terminated, the index sorted
    by name (ffindex_build -s)."""
    sizes = np.array([len(p) + 1 for p in payloads], np.int64)
    off = np.zeros(len(payloads), np.int64)
    np.cumsum(sizes[:-1], out=off[1:])
    with open(path + ".ffdata", "wb") as f:
        f.write(b"".join(p + b"\0" for p in payloads))
    order = sorted(range(len(names)), key=names.__getitem__)
    with open(path + ".ffindex", "w") as f:
        f.write("".join(f"{names[k]}\t{off[k]}\t{sizes[k]}\n"
                        for k in order))


def members(db: dict) -> List[Tuple[str, str, str]]:
    """[(name, sequence, description)] of every family member."""
    out = []
    for fam in range(db["families"]):
        prefix = f"f{fam:03d}_" if db["families"] > 1 else "m"
        for k, (name, seq) in enumerate(family_members(db, fam, prefix)):
            out.append((name, seq, f"family{fam} tier{k % 8}"))
    return out


def build(db: dict, base: str) -> int:
    """Build <base>_{a3m,cs219}.ff{data,index} (no hhm: the program
    builds each HMM from its a3m) once; returns the number of entries."""
    done = base + ".done"
    if os.path.exists(done):
        return int(open(done).read())
    tmp = base + ".building"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    mem = members(db)
    names = [n for n, _s, _d in mem]
    a3m = [a3m_entry(n, s, d, db["ss"]).encode() for n, s, d in mem]
    part = os.path.join(tmp, "db")
    _write_ffindex(part + "_a3m", names, a3m)
    _write_ffindex(part + "_cs219", names, [states(s) for _n, s, _d in mem])
    for s in ("a3m", "cs219"):
        for ext in (".ffdata", ".ffindex"):
            os.replace(f"{part}_{s}{ext}", f"{base}_{s}{ext}")
    shutil.rmtree(tmp)
    with open(done, "w") as f:
        f.write(f"{len(names)}\n")
    return len(names)


def entry_sequence(text: str) -> str:
    """The sequence of a single-sequence a3m entry (its last record)."""
    rec = text.strip().split(">")[-1].split("\n", 1)[1]
    return rec.replace("\n", "")


def db_paths(bench_dir: str, config: str) -> Dict[str, str]:
    d = os.path.join(bench_dir, "cache", config)
    os.makedirs(d, exist_ok=True)
    return {"dir": d, "base": os.path.join(d, "db")}
