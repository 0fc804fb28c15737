"""MSA merging for iterative search (host-side text work).

Parity targets: Alignment::MergeMasterSlave (src/hhalignment.cpp:3487-3714)
and HHblits::mergeHitsToQuery (src/hhblits.cpp:820-888).
"""

from __future__ import annotations

from typing import Optional, Set

import numpy as np

from ..constants import MINCOLS_REALIGN, Parameters
from ..core.alignment import Alignment
from ..core.hit import Hit, HitList

STOP, MM, GD, IM, DG, MI = 0, 2, 3, 4, 5, 6


def merge_master_slave(qali: Alignment, hit: Hit, tali: Alignment,
                       maxcol: int = 32765, maxseq: int = 65535):
    """Append Tali's kept sequences to qali, aligned through the hit path
    (hhalignment.cpp:3487-3714)."""
    # imatch[j] = query match state aligned to template match state j
    imatch = {}
    step = hit.nsteps
    for j in range(hit.j1, hit.j2 + 1):
        while hit.j[step] < j:
            step -= 1
        imatch[j] = int(hit.i[step])

    # number of match states of qali from its first sequence
    qfirst = qali.seqs[qali.kfirst]
    L = sum(1 for c in qfirst[1:] if c.isupper() or c == "-")

    for k in range(tali.N_in):
        if not tali.keep[k]:
            continue
        if qali.N_in >= maxseq:
            break
        ts = tali.seqs[k]    # '-' + sequence text
        out = ["-"] * (hit.i1 - 1)

        # positions of match-state chars (uppercase or '-'), skipping
        # the index-0 placeholder: replaces the reference's char-by-
        # char advance loops with O(1) lookups
        codes = np.frombuffer(ts.encode("latin-1"), dtype=np.uint8)
        mpos = np.nonzero(((codes >= 65) & (codes <= 90))
                          | (codes == 45))[0]
        mpos = mpos[mpos >= 1]
        if len(mpos) < hit.j2:
            raise ValueError(
                f"did not find {hit.j1} match states in sequence {k}")
        l = int(mpos[hit.j1 - 1])

        iprev = hit.i1
        lprev = l
        out.append(ts[l])

        for j in range(hit.j1 + 1, hit.j2 + 1):
            i = imatch[j]
            l = int(mpos[j - 1])
            di = i - iprev
            dl = l - lprev
            if di == 1:
                for ll in range(lprev + 1, l):
                    if ts[ll] not in "-.":
                        out.append(ts[ll].lower())
                out.append(ts[l])
            elif di == 0:
                for ll in range(lprev + 1, l + 1):
                    if ts[ll] not in "-.":
                        out.append(ts[ll].lower())
            elif di >= dl:
                for ll in range(lprev + 1, lprev + dl // 2 + 1):
                    out.append(ts[ll].upper())
                out.extend("-" * (di - dl))
                for ll in range(lprev + dl // 2 + 1, l + 1):
                    out.append(ts[ll].upper())
            else:  # di < dl
                ll = lprev + 1
                for _ in range(di // 2):
                    out.append(ts[ll].upper())
                    ll += 1
                for _ in range(dl - di):
                    if ts[ll] not in "-.":
                        out.append(ts[ll].lower())
                    ll += 1
                while ll <= l:
                    out.append(ts[ll].upper())
                    ll += 1
            iprev = i
            lprev = l

        out.extend("-" * (L - hit.i2))

        qali.seqs.append("-" + "".join(out))
        qali.names.append(tali.names[k])
        qali.keep = np.append(qali.keep, np.int8(1))
        qali.display = np.append(qali.display, np.int8(1))
        qali.N_in += 1

    qali.ksort = None
    qali.first = None
    qali.last = None
    qali.nres = None


def merge_hits_to_query(par: Parameters, qali: Alignment, hitlist: HitList,
                        previous_hits: Set[str], db, mats,
                        min_col_realign: int = MINCOLS_REALIGN,
                        premerged_hits: Optional[Set[str]] = None,
                        qali_allseqs: Optional[Alignment] = None):
    """HHblits::mergeHitsToQuery (hhblits.cpp:820-888).

    With ``qali_allseqs`` (-all/-nodiff), every hit's template MSA is
    additionally merged UNFILTERED into that copy before the per-template
    filter runs (hhblits.cpp:860-862), so the output MSA keeps all
    sequences while the profile is still built from the filtered Qali.
    """
    from .engine import template_hmm_from_text

    COV_ABS = 25
    cov_tot = max(min(int(COV_ABS / qali.L * 100 + 0.5), 70),
                  par.coverage)

    for hit in hitlist:
        if hit.Eval > 100.0 * par.e:
            break
        if hit.Eval > par.e:
            continue
        if hit.matched_cols < min_col_realign:
            continue
        key = f"{hit.file}__{hit.irep}"
        if key in previous_hits:
            continue
        # hits merged during premerging are skipped (hhblits.cpp:850-852)
        if premerged_hits is not None and key in premerged_hits:
            continue

        if hasattr(db, "get_template_alignment"):
            tali = db.get_template_alignment(str(hit.entry), par)
        else:
            text = db.get_template_a3m_text(str(hit.entry))
            tali = Alignment.from_a3m_text(text, infile=str(hit.entry),
                                           mark=par.mark,
                                           maxseq=par.maxseq,
                                           nseqdis=par.nseqdis)
        tali.compress(M=par.M_template, Mgaps=par.Mgaps,
                      maxres=par.maxres)
        if qali_allseqs is not None:
            merge_master_slave(qali_allseqs, hit, tali, par.maxcol,
                               par.maxseq)
        tali.N_filtered = tali.filter(par.max_seqid_db, mats.S,
                                      par.coverage_db, par.qid_db,
                                      par.qsc_db, par.Ndiff_db)

        if par.interim_filter and \
                tali.N_filtered + qali.N_in >= par.maxseq:
            # reference quirk (hhblits.cpp:865-868): Filter runs on X,
            # and rows merged since the last Compress still carry the
            # all-GAP X that MergeMasterSlave allocates (initX,
            # hhalignment.cpp:70-76) - they score nres == 0, get
            # keep[k] = 0 and are dropped by the Shrink
            _pad_X_for_merged(qali)
            qali.N_filtered = qali.filter(par.max_seqid, mats.S, cov_tot,
                                          par.qid, par.qsc, par.Ndiff)
            _shrink(qali)

        merge_master_slave(qali, hit, tali, par.maxcol, par.maxseq)
        if qali.N_in >= par.maxseq:
            break

    qali.compress(M=1, Mgaps=par.Mgaps, maxres=par.maxres,
                  infile="merged A3M file")
    qali.filter_for_display(par.max_seqid, par.mark, mats.S, par.coverage,
                            par.qid, par.qsc, par.nseqdis)
    qali.N_filtered = qali.filter(par.max_seqid, mats.S, cov_tot, par.qid,
                                  par.qsc, par.Ndiff)


def _pad_X_for_merged(qali: Alignment):
    """Extend X/I with all-GAP rows for sequences appended since the
    last compress (the reference's initX fill, hhalignment.cpp:70-76),
    so a filter over X sees them as residue-free."""
    import numpy as np

    from ..constants import GAP

    rows = qali.X.shape[0]
    if rows < qali.N_in:
        pad = qali.N_in - rows
        qali.X = np.concatenate(
            [qali.X, np.full((pad, qali.X.shape[1]), GAP,
                             dtype=qali.X.dtype)], axis=0)
        qali.I = np.concatenate(
            [qali.I, np.zeros((pad, qali.I.shape[1]),
                              dtype=qali.I.dtype)], axis=0)


def _shrink(qali: Alignment):
    """Alignment::Shrink (hhalignment.cpp:1475-1573): drop filtered-out
    sequences except specials/kfirst."""
    keep_idx = []
    for k in range(qali.N_in):
        if qali.keep[k] == 0 and k not in (qali.kss_dssp, qali.ksa_dssp,
                                           qali.kss_pred, qali.kss_conf,
                                           qali.kfirst):
            continue
        keep_idx.append(k)
    remap = {old: new for new, old in enumerate(keep_idx)}
    qali.names = [qali.names[k] for k in keep_idx]
    qali.seqs = [qali.seqs[k] for k in keep_idx]
    qali.keep = qali.keep[keep_idx]
    qali.display = qali.display[keep_idx]
    if qali.X.shape[0] >= qali.N_in:
        # keep X/I usable for a later interim filter, like the
        # reference's Shrink which reindexes the X rows
        qali.X = qali.X[keep_idx]
        qali.I = qali.I[keep_idx]
    for attr in ("kss_dssp", "ksa_dssp", "kss_pred", "kss_conf", "kfirst"):
        old = getattr(qali, attr)
        setattr(qali, attr, remap.get(old, -1))
    qali.N_in = len(keep_idx)
    qali.ksort = None
    qali.first = None
    qali.last = None
    qali.nres = None
