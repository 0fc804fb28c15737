"""The one traffic generator: a query stream from a traffic mix's
parameters, the configuration's database and ``--seed``.

A stream is a cycle over a fixed set of slots (the database's families
for ``descendant`` queries, the mix's lengths for ``random`` ones), each
cycle in an order drawn from the seed, so every seed gets the same sizes
in another order.  Query k's residues come from its own generator,
seeded by (seed, k).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import dbgen

# stream ids inside the seed: timed queries and warm-up queries
_TIMED, _WARM = 0, 1


@dataclass
class Query:
    name: str
    text: str      # a3m
    length: int    # residues = the query HMM's match columns


class Stream:
    def __init__(self, traffic: dict, db: dict, seed: int):
        self.traffic = traffic
        self.db = db
        self.seed = int(seed)
        if self.seed < 0:
            raise ValueError("--seed must be a whole number >= 0")
        kind = traffic["query"]
        if kind == "descendant":
            self.slots = db["families"]
            self._anc = {}
        elif kind == "random":
            self.slots = len(traffic["length_mix"])
        else:
            raise ValueError(f"unknown query kind {kind!r}")

    def _slot(self, stream: int, k: int) -> int:
        cycle, pos = divmod(k, self.slots)
        perm = np.random.default_rng(
            (self.seed, stream, 1, cycle)).permutation(self.slots)
        return int(perm[pos])

    def _make(self, stream: int, k: int, name: str) -> Query:
        t = self.traffic
        slot = self._slot(stream, k)
        rng = np.random.default_rng((self.seed, stream, 2, k))
        if t["query"] == "descendant":
            anc = self._anc.get(slot)
            if anc is None:
                anc = self._anc[slot] = dbgen.ancestor(self.db, slot)
            seq = "".join(dbgen.mutate(rng, anc, t["sub_rate"],
                                       t["indel_rate"]))
        else:
            n = int(round(self.db["L0"] * t["length_mix"][slot]))
            seq = "".join(rng.choice(dbgen.AA, size=n))
        return Query(name, dbgen.a3m_entry(name, seq, "benchmark query",
                                           bool(t["ss"])), len(seq))

    def query(self, k: int) -> Query:
        """The k-th timed query."""
        return self._make(_TIMED, k, f"q{k:06d}")

    def warmup(self, n: int) -> List[Query]:
        """``n`` warm-up queries, drawn apart from the timed stream."""
        return [self._make(_WARM, k, f"w{k:06d}") for k in range(n)]
