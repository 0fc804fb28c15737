"""The comparison that decides ``correct``.

For each sampled query the reference (``plain.py``, plain NumPy that
imports nothing of the program) works the query out again from its a3m
text and the database's a3m entries: the profiles, the Viterbi hits of
a sample of templates with their scores and E-values,
and the MAC realignment of those hits.  It then reads what the program
produced for the query, its hit objects and the ``.hhr`` it wrote, and
gives these numbers:

* ``score_gap_bits``: the widest gap of a sampled hit's score, in the
  hit object and in its ``.hhr`` block;
* ``log_evalue_gap``: the same of its natural-log E-value;
* ``hits_unmatched``: sampled templates that the reference scores at
  or under ``-e`` and that the program lists without an alignment or not
  at all;
* ``templates_unlisted``: database entries that the program's list
  leaves out (hhsearch lists every template it searched);
* ``realign_pairs_differ``: of a realigned hit's aligned pairs, the
  widest share on one side only, in the hit object and in the pairs that
  its ``.hhr`` block prints;
* ``hhr_blocks_missing``: sampled hits that the ``.hhr`` should show by
  HH-suite's display rule and does not, or under another name.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

import numpy as np

from . import plain

NUMBERS = ("score_gap_bits", "log_evalue_gap", "hits_unmatched",
           "templates_unlisted", "realign_pairs_differ",
           "hhr_blocks_missing")

# queries a run compares (the longest and others drawn from the seed), and
# templates sampled a query: the program's first hits, hits drawn from its
# list, and entries drawn from the whole database
N_QUERIES = 2
N_TOP, N_LISTED, N_ANY = 5, 10, 5

# hhsearch's display limits (-b, -B, -p, -E)
SHOW_MIN, SHOW_MAX, SHOW_P, SHOW_E = 10, 500, 20.0, 1e6


class Database:
    """The a3m entries of an ffindex database, read from its files."""

    def __init__(self, base: str):
        self.index: Dict[str, tuple] = {}
        with open(base + "_a3m.ffindex") as f:
            for line in f:
                name, off, size = line.split("\t")
                self.index[name] = (int(off), int(size))
        self.data = base + "_a3m.ffdata"

    def names(self) -> List[str]:
        return sorted(self.index)

    def text(self, name: str) -> str:
        off, size = self.index[name]
        with open(self.data, "rb") as f:
            f.seek(off)
            return f.read(size - 1).decode()


def bf16(x: np.ndarray) -> np.ndarray:
    """Rounds to bfloat16 (to nearest, ties to even), kept as float64."""
    b = np.asarray(x, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    out = r.view(np.float32).astype(np.float64)
    return np.where(np.isnan(x), x, out)


class Reference:
    """The reference's answers for one database.  ``low`` (the control)
    is a rounding to bfloat16: the Viterbi recurrence and the MAC step run
    through it, forward and backward in float32."""

    def __init__(self, base: str, low=None):
        self.db = Database(base)
        self.tab = plain.tables()
        self.low = low
        self._entries: Dict[str, tuple] = {}

    def template(self, name: str):
        got = self._entries.get(name)
        if got is None:
            e = plain.read_a3m(self.db.text(name))
            got = self._entries[name] = (e, plain.profile(e, self.tab))
        return got

    def run(self, text: str, prog: dict, rng) -> Dict[str, plain.Hit]:
        """The first hit of each sampled template (by name), with its MAC
        realignment where the program realigned it."""
        entry = plain.read_a3m(text)
        q = plain.profile(entry, self.tab)
        names = sample(prog["hits"], self.db.names(), rng)
        got = [self.template(n) for n in names]
        temps = [t for _e, t in got]
        hits = plain.viterbi(q, temps, self.tab, rnd=self.low)
        plain.calibrate(hits, q, {t.name: t.neff for t in temps},
                        len(self.db.index))
        realigned = {h["name"] for h in prog["hits"]
                     if h["irep"] == 1 and h["pairs"] is not None}
        todo = [k for k, n in enumerate(names) if n in realigned]
        if todo:
            ranked = sorted(range(len(hits)),
                            key=lambda k: (hits[k].rank_key, names[k]))
            q_re = plain.premerge(
                q, entry, [(hits[k], temps[k], got[k][0].seq)
                           for k in ranked], self.tab, low=self.low)
            out = plain.realign(q_re, [temps[k] for k in todo],
                                [hits[k] for k in todo], self.tab,
                                low=self.low)
            for k, (pairs, _path) in zip(todo, out):
                hits[k].pairs = pairs
        return {h.name: h for h in hits}


def sample(prog_hits: List[dict], universe: List[str], rng) -> List[str]:
    """The program's first N_TOP templates with an alignment, N_LISTED
    more drawn from its list, N_ANY drawn from the rest."""
    full = [h["name"] for h in prog_hits if not h["light"]]
    top: List[str] = []
    for n in full:
        if n not in top:
            top.append(n)
        if len(top) == N_TOP:
            break
    listed = sorted(set(full) - set(top))
    pick = list(rng.choice(listed, min(N_LISTED, len(listed)),
                           replace=False)) if listed else []
    rest = sorted(set(universe) - set(top) - set(pick))
    extra = list(rng.choice(rest, min(N_ANY, len(rest)),
                            replace=False)) if rest else []
    return top + [str(x) for x in pick] + [str(x) for x in extra]


# ------------------------------------------------------------ the .hhr ----

_BLOCK = re.compile(r"^No (\d+)$", re.M)
_FIELD = re.compile(r"(\S+)=(\S+)")


def parse_hhr(text: str, qname: str) -> Dict[int, dict]:
    """The alignment blocks of an ``.hhr``: for block N its template's
    name, E-value, score and printed aligned pairs."""
    out: Dict[int, dict] = {}
    marks = list(_BLOCK.finditer(text))
    for k, m in enumerate(marks):
        end = marks[k + 1].start() if k + 1 < len(marks) else len(text)
        lines = text[m.end(): end].strip("\n").split("\n")
        name = lines[0][1:].split()[0]
        fields = dict(_FIELD.findall(lines[1]))
        pairs = set()
        qrow = trow = None
        for line in lines[2:]:
            tok = line.split()
            if len(tok) < 4 or tok[0] not in ("Q", "T"):
                continue
            if tok[0] == "Q" and tok[1] == qname[:14]:
                qrow = (int(tok[2]), tok[3])
            elif tok[0] == "T" and tok[1] == name[:14]:
                trow = (int(tok[2]), tok[3])
                if qrow is not None:
                    pairs |= _pairs(qrow, trow)
                qrow = None
        out[int(m.group(1))] = {
            "name": name, "evalue": float(fields["E-value"]),
            "score": float(fields["Score"]), "pairs": frozenset(pairs)}
    return out


def _pairs(qrow, trow) -> set:
    (i, qs), (j, ts) = qrow, trow
    out = set()
    for a, b in zip(qs, ts):
        qa, ta = a.isalpha(), b.isalpha()
        if qa and ta:
            out.add((i, j))
        i += qa
        j += ta
    return out


def block_numbers(prog_hits: List[dict]) -> Dict[tuple, int]:
    """The block each of the program's hits gets by HH-suite's display
    rule, keyed by (name, irep)."""
    out = {}
    n = 0
    for h in prog_hits:
        if n >= SHOW_MAX:
            break
        if n >= SHOW_MIN and h["prob"] < SHOW_P:
            break
        if n >= SHOW_MIN and h["evalue"] > SHOW_E:
            continue
        if h["light"]:
            continue
        n += 1
        out[(h["name"], h["irep"])] = n
    return out


# ---------------------------------------------------------- comparison ----

def _share(a: frozenset, b: frozenset) -> float:
    return len(a ^ b) / max(1, len(a | b))


def compare(prog: dict, ref: Dict[str, plain.Hit], qname: str,
            n_entries: Optional[int] = None,
            evalue: float = plain.DEFAULTS["e"]):
    """The numbers of one query (see the module's docstring), 0 where
    both sides agree, and how many hits, realignments and blocks they
    compared.  Without an ``.hhr`` (``prog["hhr"]`` None: the control)
    the hit objects alone are compared; without ``n_entries`` (the
    control, which lists only its sample) the list is not counted."""
    first = {h["name"]: h for h in prog["hits"] if h["irep"] == 1}
    has_hhr = prog["hhr"] is not None
    blocks = parse_hhr(prog["hhr"], qname) if has_hhr else {}
    numbers_of = block_numbers(prog["hits"]) if has_hhr else {}
    out = dict.fromkeys(NUMBERS, 0.0)
    if n_entries is not None:
        out["templates_unlisted"] = float(
            n_entries - len({h["name"] for h in prog["hits"]}))
    seen = {"hits": 0, "realigned": 0, "blocks": 0}
    for name, r in ref.items():
        p = first.get(name)
        if p is None or p["light"]:
            if r.evalue <= evalue:
                out["hits_unmatched"] += 1
            continue
        seen["hits"] += 1
        views = [(p["score"], p["log_evalue"], p["pairs"])]
        no = numbers_of.get((name, 1))
        if no is not None:
            blk = blocks.get(no)
            if blk is None or blk["name"] != name:
                out["hhr_blocks_missing"] += 1
            else:
                seen["blocks"] += 1
                views.append((blk["score"],
                              math.log(max(blk["evalue"], 1e-300)),
                              blk["pairs"] if p["pairs"] is not None
                              else None))
        for score, log_e, pairs in views:
            out["score_gap_bits"] = max(out["score_gap_bits"],
                                        abs(score - r.score))
            out["log_evalue_gap"] = max(out["log_evalue_gap"],
                                        abs(log_e - r.log_evalue))
            if pairs is not None:
                out["realign_pairs_differ"] = max(
                    out["realign_pairs_differ"], _share(pairs, r.pairs))
        if p["pairs"] is not None:
            seen["realigned"] += 1
    return out, seen


def merge_numbers(per_query: List[Dict[str, float]]) -> Dict[str, float]:
    """Over the sampled queries: the widest reading of each number."""
    out: Dict[str, float] = {}
    for d in per_query:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def add_counts(total: Dict[str, int], seen: Dict[str, int]) -> None:
    for k, v in seen.items():
        total[k] = total.get(k, 0) + v


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """Every number at or under its limit; a number without a limit
    fails."""
    table = {k: {"value": v, "limit": limits.get(k)}
             for k, v in numbers.items()}
    ok = all(t["limit"] is not None and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table


def sample_queries(done: List[dict], rng, n: int) -> List[dict]:
    """``n`` finished queries drawn by ``rng``, the longest among them."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r["length"], r["k"]))
    rest = [r for r in done if r is not longest]
    pick = [rest[i] for i in rng.choice(len(rest), min(n - 1, len(rest)),
                                        replace=False)] if rest else []
    return [longest] + pick


def control_answer(ctrl: Dict[str, plain.Hit]) -> dict:
    """The control's hits in the program's place, read as the program's
    hit objects are."""
    hits = [{"name": n, "irep": 1, "light": False, "score": h.score,
             "log_evalue": h.log_evalue, "evalue": h.evalue,
             "pairs": h.pairs} for n, h in ctrl.items()]
    hits.sort(key=lambda h: -h["score"])
    return {"hits": hits, "hhr": None}
