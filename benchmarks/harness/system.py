"""The system under test: the port's search entry, driven as the batch
search drives it on a card (``tools/batch.py:_run_one``): one shared
database instance, then per query the search and the ``.hhr`` (hit list
and alignments).

This is the one module of the harness that imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

MM = 2        # a matched pair's state in an alignment's steps


@dataclass
class Output:
    """What one query produced on the timed path."""
    hhr: str
    hitlist: object


class System:
    def __init__(self, config: dict, base: str, device):
        from hhsuite_tpu_torch.search.engine import get_database

        self.config = config
        self.device = device
        self.db = get_database(base)

    def params(self):
        from hhsuite_tpu_torch.constants import Parameters

        par = Parameters.hhsearch_defaults()
        for k, v in self.config["params"].items():
            setattr(par, k, v)
        return par

    def run(self, name: str, text: str) -> Output:
        from hhsuite_tpu_torch.io.alignments import print_alignments
        from hhsuite_tpu_torch.io.results import print_hit_list
        from hhsuite_tpu_torch.matrices import get_substitution_matrix
        from hhsuite_tpu_torch.search.engine import run_hhsearch

        par = self.params()
        q, hitlist = run_hhsearch(par, text, self.db, name,
                                  device=self.device)
        mats = get_substitution_matrix(par.matrix)
        hhr = (print_hit_list(q, hitlist, par.maxdbstrlen, par.z, par.Z,
                              par.p, par.E, ["benchmark"])
               + print_alignments(q, hitlist, par, mats.S))
        return Output(hhr, hitlist)


def answer(out: Output) -> dict:
    """What the check reads of one query's output: each hit in the
    list's order (its template, rank among the template's alignments,
    score, E-value, probability and, where it was realigned, its aligned
    pairs) and the ``.hhr``."""
    import numpy as np

    hits = []
    for h in out.hitlist:
        pairs = None
        if h.alt_i is not None and h.states is not None:
            st = np.asarray(h.states)
            on = st == MM
            pairs = frozenset(zip(np.asarray(h.i)[on].tolist(),
                                  np.asarray(h.j)[on].tolist()))
        hits.append({"name": str(h.entry), "irep": int(h.irep),
                     "light": bool(h.light), "score": float(h.score),
                     "log_evalue": float(h.logEval),
                     "evalue": float(h.Eval), "prob": float(h.Probab),
                     "pairs": pairs})
    return {"hits": hits, "hhr": out.hhr}


def stage_timers_on() -> dict:
    """Start the program's stage timers afresh; returns the live dict."""
    from hhsuite_tpu_torch.profiling import enable_stage_timers

    return enable_stage_timers()


def stage_timers_off() -> None:
    from hhsuite_tpu_torch.profiling import disable_stage_timers

    disable_stage_timers()


def release(system: "System") -> None:
    """Drop the program's cached database (resident packs, parsed
    templates) before the reference runs."""
    from hhsuite_tpu_torch.search import engine

    with engine._DB_CACHE_LOCK:
        engine._DB_CACHE.clear()
    system.db = None
