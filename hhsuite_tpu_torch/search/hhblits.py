"""HHblits: iterative profile search with cs219 prefiltering.

Orchestration parity: HHblits::run (src/hhblits.cpp:1065-1414): per round
-> prefilter (stage-1/2 funnels, K4/K5) -> Viterbi scoring of new
entries (K1-K3) -> P-values + composite E-values -> MAC realign (host
decoder) -> MSA merge -> next-round profile.  The prefilter and Viterbi
stages run as batched device kernels; the iterative control loop is
host-side.  ``run_hhblits(..., device=...)`` runs on the CUDA card by
default and raises when it is absent; ``device="cpu"`` runs every
kernel's plain PyTorch version.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Set

from ..constants import MINCOLS_REALIGN, Parameters
from ..core.hit import Hit, HitList
from ..core.hmm import HMM
from ..cs.context_lib import ContextLibrary
from ..device import resolve_device
from ..matrices import get_ss_matrices, get_substitution_matrix
from ..profiling import annotate, gc_paused_fn
from .engine import (HHDatabase, get_resident_pack, neutralize_tags,
                     perform_realign, premerge_hits)
from .prefilter import database_cs219, prefilter_db
from .query import finish_template_hmm, prepare_query_hmm, read_query_text
from .viterbi_search import promote_light_hits, viterbi_search


def _search_templates(db, names: List[str], par: Parameters, mats, q: HMM):
    return [(name, db.get_template_hmm_search(name, par, mats, q,
                                              use_global_weights=1)[0])
            for name in names]


def _rescore_stats(hitlist: HitList, q: HMM, par: Parameters):
    hitlist.sort()
    hitlist.calculate_pvalues(q, par.loc, par.ssm, par.ssw)
    if par.prefilter:
        hitlist.calculate_hhblits_evalues(
            q, par.dbsize, par.alphaa, par.alphab, par.alphac,
            par.prefilter_evalue_thresh)


def rescore_previous_hits(par: Parameters, q: HMM, db: HHDatabase,
                          mats, ss, previous_hits: Dict[str, Hit],
                          hitlist: HitList, device=None):
    """HHblits::RescoreWithViterbiKeepAlignment (hhblits.cpp:911-968).

    Runs a full Viterbi pass on the templates of all previously found
    irep-1 hits against the current query profile, then pushes the OLD
    hit objects (alignments preserved) with the NEW scores into the
    hitlist; the hash entry is replaced by the fresh hit.  P-values and
    composite E-values are then recomputed for the whole list.
    """
    entry_names: List[str] = []
    seen = set()
    for hit in previous_hits.values():
        if hit.irep == 1 and hit.entry not in seen:
            seen.add(hit.entry)
            entry_names.append(str(hit.entry))
    if not entry_names:
        return

    templates = _search_templates(db, entry_names, par, mats, q)
    # allow_funnel=False: these hits replace PRESERVED alignments'
    # scores (RescoreWithViterbiKeepAlignment, hhblits.cpp:911-968), so
    # every one needs its real backtraced score incl. SS/correlation
    # terms — a funnel light hit here would copy a truncated score onto
    # a displayed hit
    hits_to_add = viterbi_search(
        par, q, templates, ss_matrices=ss, allow_funnel=False,
        resident_pack=get_resident_pack(db, entry_names, par, mats, device),
        device=device)
    for h in hits_to_add:
        key = f"{h.file}__{h.irep}"
        hit_cur = previous_hits.get(key)
        if hit_cur is None:
            continue
        previous_hits[key] = h
        hit_cur.score = h.score
        hit_cur.score_aass = h.score_aass
        hit_cur.score_ss = h.score_ss
        hit_cur.Pval = h.Pval
        hit_cur.Pvalt = h.Pvalt
        hit_cur.logPval = h.logPval
        hit_cur.logPvalt = h.logPvalt
        hit_cur.Eval = h.Eval
        hit_cur.logEval = h.logEval
        hit_cur.Probab = h.Probab
        hitlist.hits.append(hit_cur)
    _rescore_stats(hitlist, q, par)


def prefilter_pseudocounts(par: Parameters, q_tmp: HMM, mats) -> None:
    """The round-start query copy as the prefilter scores it: context
    (or substitution-matrix) pseudocounts with the prefilter's
    parameters and the amino-acid background, as HHblits::run prepares
    its q_tmp before Prefilter::prefilter_db."""
    from ..cs.pseudocounts import get_context_engine

    ctx = get_context_engine(par)
    if ctx is not None:
        ctx.add_context_pseudocounts_prefilter(q_tmp)
    else:
        q_tmp.prepare_pseudocounts(mats.R)
        q_tmp.add_amino_acid_pseudocounts(
            par.pc_prefilter_nocontext_mode, par.pc_prefilter_nocontext_a,
            par.pc_prefilter_nocontext_b, par.pc_prefilter_nocontext_c)
    q_tmp.calculate_aa_background(mats.pb)


@gc_paused_fn
def run_hhblits(par: Parameters, query_text: str, db: HHDatabase,
                query_name: str = "query",
                lib: Optional[ContextLibrary] = None, device=None,
                on_round: Optional[Callable[[dict], None]] = None):
    """Returns (q, hitlist, qali) after par.num_rounds iterations, on
    ``device`` (default: the CUDA card).  ``on_round``, when given, is
    called at the end of each round with that round's counts: round,
    prefilter survivors (stage1, stage2), new and old entries, templates
    searched and hits."""
    from ..core.profile import frequencies_and_transitions
    from .. import log as hhlog
    from .hhblits_merge import merge_hits_to_query

    dev = resolve_device(device)
    mats = get_substitution_matrix(par.matrix)
    ss = get_ss_matrices(par.ssa)
    if lib is None:
        lib = ContextLibrary.default_cs219()
    par.dbsize = db.size()

    with annotate("host_query_prep"):
        q, qali, input_format = read_query_text(par, query_text,
                                                query_name, mats)
        if par.notags:
            neutralize_tags(q, mats.pb)

    # previous_hits maps "file__irep" -> the Hit found in an earlier
    # round (the reference's Hash<Hit>* previous_hits, hhblits.cpp:1071)
    previous_hits: Dict[str, Hit] = {}
    premerged_hits: Set[str] = set()
    # -all/-nodiff: unfiltered copy of the growing alignment
    # (hhblits.cpp:860-862, writers :1846-1860)
    qali_allseqs = copy.deepcopy(qali) if par.allseqs else None
    hitlist = HitList()
    search_counter: Set[str] = set()
    alis: Dict[int, object] = {}     # per-round MSAs for -oalis

    for round_no in range(1, par.num_rounds + 1):
        hhlog.info(f"Iteration {round_no}")
        info = {"round": round_no}
        # premerge budget shrinks once enough hits are merged
        # (hhblits.cpp:1120-1126; mutates par.premerge persistently)
        if par.premerge > 0 and round_no > 1 \
                and len(previous_hits) >= par.premerge:
            par.premerge = 0
        else:
            par.premerge -= len(previous_hits)
        with annotate("host_query_prep"):
            q_tmp = copy.deepcopy(q)
            prepare_query_hmm(par, q, mats, input_format)

        if par.prefilter:
            with annotate("prefilter"):
                prefilter_pseudocounts(par, q_tmp, mats)
                cs_names, cs_seqs, pack = database_cs219(db, dev)
                new_pairs, old_pairs = prefilter_db(
                    par, q_tmp, lib, cs_names, cs_seqs, previous_hits,
                    pack=pack, counts=info)
            entry_names = [name for (_l, name) in new_pairs]
            old_entry_names = [name for (_l, name) in old_pairs]
        else:
            entry_names = [e.name for e in db.cs219.entries]
            old_entry_names = []
        info.update(new=len(entry_names), old=len(old_entry_names))

        search_counter.update(entry_names)
        hitlist.N_searched = len(search_counter)
        if not entry_names:
            break

        with annotate("host_template_prep"):
            templates = _search_templates(db, entry_names, par, mats, q)
            rpack = get_resident_pack(db, entry_names, par, mats, dev)
        with annotate("viterbi_search"):
            hits = viterbi_search(par, q, templates, ss_matrices=ss,
                                  resident_pack=rpack, device=dev)
            hitlist.extend(hits)
            _rescore_stats(hitlist, q, par)
            if promote_light_hits(par, q, hitlist, templates, ss,
                                  device=dev):
                _rescore_stats(hitlist, q, par)

        new_hits = sum(1 for h in hitlist if h.Eval <= par.e)

        # old-hit handling on the final round (hhblits.cpp:1236-1263):
        # either fully re-search the previously found templates that
        # re-passed the prefilter (-realign_old_hits), or rescore all
        # previous hits keeping their alignments
        if new_hits == 0 or round_no == par.num_rounds:
            if old_entry_names and par.realign_old_hits:
                hhlog.info("Rescoring previously found HMMs with "
                           "Viterbi algorithm")
                with annotate("viterbi_search"):
                    old_templates = _search_templates(db, old_entry_names,
                                                      par, mats, q)
                    # allow_funnel=False: realign_old_hits hits go
                    # straight into display/merge range and must carry
                    # full paths
                    hitlist.extend(viterbi_search(
                        par, q, old_templates, ss_matrices=ss,
                        allow_funnel=False,
                        resident_pack=get_resident_pack(
                            db, old_entry_names, par, mats, dev),
                        device=dev))
                    _rescore_stats(hitlist, q, par)
            elif not par.realign_old_hits and previous_hits:
                hhlog.info("Rescoring previously found HMMs with "
                           "Viterbi algorithm")
                with annotate("viterbi_search"):
                    rescore_previous_hits(par, q, db, mats, ss,
                                          previous_hits, hitlist, dev)

        q_re = copy.deepcopy(q)

        def get_template(entry):
            t, fmt = db.get_template_hmm_prepared(str(entry), par, mats,
                                                  use_global_weights=par.wg)
            finish_template_hmm(par, q_re, t, mats)
            return t, fmt

        # premerge runs even with -norealign (hhblits.cpp:1262-1264)
        if par.premerge and db.a3m is not None:
            with annotate("host_premerge"):
                premerge_hits(par, q_re, qali, hitlist, get_template, db,
                              mats, ss, previous_hits, premerged_hits,
                              MINCOLS_REALIGN, qali_allseqs=qali_allseqs)
        if par.realign:
            with annotate("host_realign"):
                perform_realign(par, q_re, hitlist, get_template, mats, ss,
                                MINCOLS_REALIGN, device=dev)
        q.realign_q = q_re

        # q for the hhr writer is the round-start HMM (writeHHRFile uses
        # q_tmp, hhblits.cpp:1816-1822); the merged rebuild below feeds
        # the next round and -oa3m/-opsi/-ohhm outputs
        merge_cond = (round_no < par.num_rounds or par.alnfile
                      or par.psifile or par.hhmfile or par.alisbasename)
        with annotate("host_merge"):
            if merge_cond:
                if new_hits > 0:
                    merge_hits_to_query(par, qali, hitlist, previous_hits,
                                        db, mats, MINCOLS_REALIGN,
                                        premerged_hits,
                                        qali_allseqs=qali_allseqs)
                qnew = HMM()
                frequencies_and_transitions(qali, qnew, par.wg, par.mark,
                                            par.cons, par.showcons, mats.pb,
                                            mats.Sim)
                if par.notags:
                    neutralize_tags(qnew, mats.pb)
                if par.alisbasename:
                    alis[round_no] = copy.deepcopy(
                        qali_allseqs if par.allseqs else qali)
            else:
                qnew = q
        info.update(searched=len(templates), hits=len(hitlist.hits))
        if on_round is not None:
            on_round(info)

        last_round = (new_hits == 0 or round_no == par.num_rounds
                      or qnew.Neff_HMM > par.neffmax
                      or qali.N_in >= par.maxseq)
        if last_round:
            break
        q = qnew

        # record good hits as seen (hhblits.cpp:1375-1390): store the
        # whole Hit so the final round can rescore it keeping alignments
        for h in hitlist:
            key = f"{h.file}__{h.irep}"
            if par.already_seen_filter and h.Eval <= par.e \
                    and key not in previous_hits:
                previous_hits[key] = h
        hitlist = HitList()

    q.alis = alis
    # -all: the a3m/psi writers see the unfiltered alignment
    # (hhblits.cpp:1846-1874)
    return q, hitlist, (qali_allseqs if par.allseqs else qali)
