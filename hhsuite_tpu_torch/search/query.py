"""Query/template HMM preparation pipeline.

Mirrors ReadQueryFile / PrepareQueryHMM / PrepareTemplateHMM
(src/hhfunc.cpp:11-198): read MSA or HHM, filter, build profile, add
transition + amino-acid pseudocounts, compute background.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..constants import Parameters
from ..core.alignment import Alignment
from ..core.hmm import HMM
from ..core.profile import frequencies_and_transitions
from ..io.hhm import read_hhm
from ..matrices import SubstitutionMatrix


def read_query_text(par: Parameters, text: str, infile: str,
                    mats: SubstitutionMatrix,
                    use_global_weights: Optional[int] = None,
                    maxseqdis: int = 10238
                    ) -> Tuple[HMM, Alignment, int]:
    """Sniff format and build the query HMM (hhfunc.cpp:11-95).

    Returns (q, qali, input_format); input_format 0 = HHM/MSA.
    """
    if use_global_weights is None:
        use_global_weights = par.wg
    stripped = text.lstrip()
    if stripped.startswith("HMMER3"):
        from ..io.hmmer import read_hmmer3

        q = read_hmmer3(text, showcons=par.showcons, pb=mats.pb,
                        filestr=infile, maxres=par.maxres)
        qali = _alignment_from_hmm(q, par)
        return q, qali, 1
    if stripped.startswith("HMMER"):
        from ..io.hmmer import read_hmmer2

        q = read_hmmer2(text, showcons=par.showcons, pb=mats.pb,
                        filestr=infile, maxres=par.maxres)
        qali = _alignment_from_hmm(q, par)
        return q, qali, 1
    if stripped.startswith("NAME") or stripped.startswith("HH"):
        q = read_hhm(text, nseqdis=par.nseqdis, maxres=par.maxres)
        qali = _alignment_from_hmm(q, par)
        return q, qali, 0
    if stripped.startswith("#") or stripped.startswith(">"):
        ali = Alignment.from_a3m_text(text, infile=infile, mark=par.mark,
                                      maxseq=par.maxseq, nseqdis=par.nseqdis)
        ali.compress(M=par.M, Mgaps=par.Mgaps, maxres=par.maxres,
                     infile=infile)
        ali.filter_for_display(par.max_seqid, par.mark, mats.S, par.coverage,
                               par.qid, par.qsc, par.nseqdis)
        ali.N_filtered = ali.filter(par.max_seqid, mats.S, par.coverage,
                                    par.qid, par.qsc, par.Ndiff)
        if par.Neff >= 0.999:
            ali.filter_neff(use_global_weights, par.mark, par.cons,
                            par.showcons, par.max_seqid, par.coverage,
                            par.Neff, mats.pb, mats.S, mats.Sim)
        q = HMM(maxseqdis=maxseqdis)
        frequencies_and_transitions(ali, q, use_global_weights, par.mark,
                                    par.cons, par.showcons, mats.pb, mats.Sim)
        return q, ali, 0
    raise ValueError(f"unrecognized input file format in {infile}")


def _alignment_from_hmm(q: HMM, par: Parameters) -> Alignment:
    """GetSeqsFromHMM + Compress (hhfunc.cpp:47-51)."""
    ali = Alignment()
    names, seqs = [], []
    for k in range(q.n_display):
        if k in (q.nss_dssp, q.nsa_dssp, q.nss_pred, q.nss_conf, q.ncons):
            continue
        names.append(q.sname[k])
        seqs.append(q.seq[k])
    ali.names = names
    ali.seqs = seqs
    ali.N_in = len(names)
    ali.keep = np.ones(len(names), dtype=np.int8)
    ali.display = np.ones(len(names), dtype=np.int8)
    ali.kfirst = 0
    ali.n_display = len(names)
    if names:
        ali.compress(M=par.M, Mgaps=par.Mgaps, maxres=par.maxres)
    ali.name = q.name
    ali.longname = q.longname
    ali.fam = q.fam
    return ali


def prepare_query_hmm(par: Parameters, q: HMM, mats: SubstitutionMatrix,
                      input_format: int = 0, context_engine=None):
    """PrepareQueryHMM (hhfunc.cpp:118-160)."""
    if context_engine is None:
        from ..cs.pseudocounts import get_context_engine
        context_engine = get_context_engine(par)
    if input_format == 0:
        q.add_transition_pseudocounts(par.gapd, par.gape, par.gapf, par.gapg,
                                      par.gaph, par.gapi, par.gapb)
        if par.nocontxt or context_engine is None:
            q.prepare_pseudocounts(mats.R)
            q.add_amino_acid_pseudocounts(par.pc_hhm_nocontext_mode,
                                          par.pc_hhm_nocontext_a,
                                          par.pc_hhm_nocontext_b,
                                          par.pc_hhm_nocontext_c)
        else:
            context_engine.add_context_pseudocounts_hhm(q)
    else:
        q.add_amino_acid_pseudocounts(0, par.pc_hhm_nocontext_a,
                                      par.pc_hhm_nocontext_b,
                                      par.pc_hhm_nocontext_c)
    q.calculate_aa_background(getattr(q, "pb_hmmer", None)
                              if getattr(q, "pb_hmmer", None) is not None
                              else mats.pb)
    return q


def template_pc_stage(par: Parameters, t: HMM, mats: SubstitutionMatrix,
                      input_format: int = 0):
    """The query-independent prefix of PrepareTemplateHMM
    (hhfunc.cpp:163-190): transition + amino-acid pseudocounts and the
    aa background.  HHDatabase caches templates at this stage so
    iterative rounds and batch queries re-run only the (cheap,
    query-dependent) null-model division."""
    if input_format == 0:
        t.add_transition_pseudocounts(par.gapd, par.gape, par.gapf, par.gapg,
                                      par.gaph, par.gapi, par.gapb)
        t.prepare_pseudocounts(mats.R)
        t.add_amino_acid_pseudocounts(par.pc_hhm_nocontext_mode,
                                      par.pc_hhm_nocontext_a,
                                      par.pc_hhm_nocontext_b,
                                      par.pc_hhm_nocontext_c)
    else:
        t.add_amino_acid_pseudocounts(0, par.pc_hhm_nocontext_a,
                                      par.pc_hhm_nocontext_b,
                                      par.pc_hhm_nocontext_c)
    pb_t = getattr(t, "pb_hmmer", None)
    t.calculate_aa_background(pb_t if pb_t is not None else mats.pb)
    return t


def finish_template_hmm(par: Parameters, q: HMM, t: HMM,
                        mats: SubstitutionMatrix,
                        linear_transition_probs: bool = False):
    """The query-dependent tail of PrepareTemplateHMM
    (hhfunc.cpp:191-198): null model (uses q.pav for columnscore 1/3)."""
    pb_t = getattr(t, "pb_hmmer", None)
    if linear_transition_probs:
        t.log2lin_transitions()
    t.include_null_model(q, par.columnscore,
                         pb_t if pb_t is not None else mats.pb)
    return t


def prepare_template_hmm(par: Parameters, q: HMM, t: HMM,
                         mats: SubstitutionMatrix, input_format: int = 0,
                         linear_transition_probs: bool = False):
    """PrepareTemplateHMM (hhfunc.cpp:163-198)."""
    template_pc_stage(par, t, mats, input_format)
    return finish_template_hmm(par, q, t, mats, linear_transition_probs)
