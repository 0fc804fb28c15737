"""Library-level implementations of the MSA/HMM tool suite.

Parity targets: hhmake (src/hhmake.cpp:308-394), hhfilter
(src/hhfilter.cpp:144-210), hhconsensus (src/hhconsensus.cpp:275-430),
Alignment::WriteToFile a3m/psi writers (src/hhalignment.cpp:3424-3486).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .constants import Parameters
from .core.alignment import Alignment
from .core.hmm import HMM
from .core.profile import frequencies_and_transitions
from .io.hhm import write_hhm
from .matrices import get_substitution_matrix
from .search.query import prepare_query_hmm, read_query_text


def write_alignment_a3m(ali: Alignment) -> str:
    """Alignment::WriteToFile a3m format (hhalignment.cpp:3447-3461)."""
    out = []
    if ali.longname != ali.names[ali.kfirst] or ali.readCommentLine:
        out.append("#" + ali.longname)
    specials = (ali.kss_pred, ali.kss_conf, ali.kss_dssp, ali.ksa_dssp)
    for k in range(ali.N_in):
        if k in specials and k >= 0:
            out.append(">" + ali.names[k])
            out.append(ali.seqs[k][1:])
    for k in range(ali.N_in):
        if k in specials:
            continue
        if ali.keep[k] or ali.display[k] == 2:
            out.append(">" + ali.names[k])
            out.append(ali.seqs[k][1:])
    return "\n".join(out) + "\n"


def write_alignment_psi(ali: Alignment) -> str:
    """PSI-BLAST format (hhalignment.cpp:3462-3480)."""
    out = []
    specials = (ali.kss_pred, ali.kss_conf, ali.kss_dssp, ali.ksa_dssp)
    for k in range(ali.N_in):
        if k in specials:
            continue
        if ali.keep[k] or ali.display[k] == 2:
            name = (ali.names[k].split() or [""])[0]
            row = "".join(c for c in ali.seqs[k][1:]
                          if c == "-" or ("A" <= c <= "Z"))
            out.append("%-20.20s %s" % (name, row))
    return "\n".join(out) + "\n"


def hhfilter(text: str, infile: str = "stdin",
             par: Optional[Parameters] = None, **kw) -> str:
    """hhfilter main flow (hhfilter.cpp:144-210)."""
    if par is None:
        par = Parameters()
        par.nseqdis = par.maxseq - 1
        par.Ndiff = 0
        for k, v in kw.items():
            setattr(par, k, v)
    mats = get_substitution_matrix(par.matrix)
    ali = Alignment.from_a3m_text(text, infile=infile, mark=par.mark,
                                  maxseq=par.maxseq, nseqdis=par.nseqdis)
    ali.compress(M=par.M, Mgaps=par.Mgaps, maxres=par.maxres,
                 infile=infile)
    ali.N_filtered = ali.filter(par.max_seqid, mats.S, par.coverage,
                                par.qid, par.qsc, par.Ndiff)
    if par.Neff >= 0.999:
        ali.filter_neff(par.wg, par.mark, par.cons, par.showcons,
                        par.max_seqid, par.coverage, par.Neff, mats.pb,
                        mats.S, mats.Sim)
    return write_alignment_a3m(ali)


def hhmake(text: str, infile: str = "stdin",
           par: Optional[Parameters] = None, argv=None,
           datestr: Optional[str] = None, **kw) -> str:
    """hhmake main flow (hhmake.cpp:308-394)."""
    if par is None:
        par = Parameters()
        par.nseqdis = 10
        par.gapb = 0.0            # no transition pseudocounts
        par.nocontxt = kw.pop("nocontxt", True)
        for k, v in kw.items():
            setattr(par, k, v)
    mats = get_substitution_matrix(par.matrix)
    q, ali, fmt = read_query_text(par, text, infile, mats,
                                  maxseqdis=par.nseqdis)
    prepare_query_hmm(par, q, mats, fmt)
    return write_hhm(q, mats.pb, max_seqid=par.max_seqid,
                     coverage=par.coverage, qid=par.qid, Ndiff=par.Ndiff,
                     qsc=par.qsc, argv=argv or ["hhmake"],
                     datestr=datestr)


def hhconsensus(text: str, infile: str = "stdin",
                par: Optional[Parameters] = None, **kw
                ) -> Tuple[str, str]:
    """hhconsensus main flow (hhconsensus.cpp:275-430).

    Returns (consensus_fasta, a3m_with_consensus_first).
    """
    if par is None:
        par = Parameters()
        par.nseqdis = par.maxseq - 1
        par.showcons = 0
        par.cons = 1
        par.Ndiff = 0
        par.max_seqid = 100
        par.coverage = 0
        par.pc_hhm_nocontext_a = 0.0   # no aa pseudocounts
        par.gapb = 0.0                 # no transition pseudocounts
        par.nocontxt = kw.pop("nocontxt", True)
        for k, v in kw.items():
            setattr(par, k, v)
    mats = get_substitution_matrix(par.matrix)
    ali = Alignment.from_a3m_text(text, infile=infile, mark=par.mark,
                                  maxseq=par.maxseq, nseqdis=par.nseqdis)
    ali.compress(M=par.M, Mgaps=par.Mgaps, maxres=par.maxres,
                 infile=infile)
    ali.filter_for_display(par.max_seqid, par.mark, mats.S, par.coverage,
                           par.qid, par.qsc, par.nseqdis)
    ali.N_filtered = ali.filter(par.max_seqid, mats.S, par.coverage,
                                par.qid, par.qsc, par.Ndiff)
    q = HMM()
    frequencies_and_transitions(ali, q, par.wg, par.mark, par.cons,
                                par.showcons, mats.pb, mats.Sim)
    prepare_query_hmm(par, q, mats, 0)

    cons_fasta = f">{q.longname}\n{q.seq[q.nfirst][1:]}\n"

    # A3M output (HalfAlignment::BuildA3M == display sequences verbatim,
    # consensus first after SS annotations).  The reference always prints
    # the '#'-comment line here: hhconsensus.cpp:419 tests the char '0'/'1'
    # flag for truthiness, and both are truthy.
    out = ["#" + ali.longname]
    for k in range(q.n_display):
        if k in (q.nss_pred, q.nss_conf, q.nss_dssp, q.nsa_dssp):
            out.append(">" + q.sname[k])
            out.append(q.seq[k][1:])
    for k in range(q.n_display):
        if k in (q.nss_pred, q.nss_conf, q.nss_dssp, q.nsa_dssp):
            continue
        out.append(">" + q.sname[k])
        out.append(q.seq[k][1:])
    return cons_fasta, "\n".join(out) + "\n"
