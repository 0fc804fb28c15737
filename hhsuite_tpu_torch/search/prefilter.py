"""Two-stage cs219 prefilter: host orchestration around K4 and K5.

Parity target: Prefilter (src/hhprefilter.cpp:28-606): the AS219 query
score table (stripe_query_profile, :356-424 — destriped to a logical
(220, Lq) table), stage-1 ungapped funnel with the min-hit floor, stage-2
gapped SW with E-value thresholds, and the exact sort/tie orders of the
reference's funnel cuts.

The database's cs219 states live on the device in a
:class:`ResidentCs219Pack`, built once per database and device and
reused across rounds and queries.  Stage 1 scores every row of it (K4);
stage 2 scores the stage-1 survivors only (K5), selected on the device
by their row descriptors.  On CPU tensors both stages run the plain
PyTorch versions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import fastmath as fm
from ..constants import Parameters
from ..core.hmm import HMM
from ..cs.context_lib import AS219_SIZE, ContextLibrary
from ..device import resolve_device
from ..ops.prefilter import gapped_scores_packed, ungapped_scores_packed
from ..profiling import annotate


def build_query_profile(q_tmp: HMM, lib: ContextLibrary,
                        score_offset: int = 50,
                        bit_factor: int = 4) -> np.ndarray:
    """(220, Lq) uint8 query score table (hhprefilter.cpp:356-424).

    Row k < 219: clamp(flog2(sum_a p[i][a] lib_k[a] / pav[a]) * bit_factor
    + offset + 0.5); row 219 (ANY): offset - 1.

    Note the reference's off-by-one: it reads q_tmp->p[i] for i in 0..L-1
    (row 0 is the background-filled begin state) rather than 1..L; we
    reproduce that exactly.
    """
    LQ = q_tmp.L
    # S[i,k] = sum_a p[i][a] * lib[k][a] / pav[a],  i = 0..LQ-1 (sic)
    p = q_tmp.p[0:LQ].astype(np.float32)
    ratios = (lib.probs[:, 0, :].astype(np.float32)
              / q_tmp.pav[None, :].astype(np.float32))
    S = p @ ratios.T                                    # (LQ, 219) f32
    vals = fm.flog2(S.astype(np.float32)) * np.float32(bit_factor) \
        + np.float32(score_offset) + np.float32(0.5)
    qc = np.empty((AS219_SIZE + 1, LQ), dtype=np.uint8)
    # (unsigned char) cast truncates; clamp range first (:392-399)
    q8 = np.where(vals > 255.0, 255,
                  np.where(vals < 0, 0,
                           vals.astype(np.int32)))
    qc[:AS219_SIZE] = q8.T.astype(np.uint8)
    qc[AS219_SIZE] = score_offset - 1
    return qc


def pack_db(seqs: List[bytes], Ld_max: int) -> Tuple[np.ndarray, np.ndarray]:
    B = len(seqs)
    db = np.full((B, Ld_max), AS219_SIZE, dtype=np.int32)
    ln = np.zeros(B, dtype=np.int32)
    for b, s in enumerate(seqs):
        arr = np.frombuffer(s, dtype=np.uint8)
        db[b, : len(arr)] = arr
        ln[b] = len(arr)
    return db, ln


class ResidentCs219Pack:
    """A database's cs219 state sequences on ``device`` (the reference
    mmaps the whole cs219 file once, hhprefilter.cpp:314-335).

    Rows are in ascending length order (stable: ties keep database
    order), so the sequences of one warp have similar lengths; the states
    are one flat uint8 array with no padding, a row is its int64 offset
    and int32 length.  ``order[k]`` is the database index of row k and
    ``lengths`` the lengths in database order (host)."""

    def __init__(self, seqs: List[bytes], device):
        self.device = torch.device(device)
        n = len(seqs)
        self.lengths = np.fromiter(map(len, seqs), np.int64, n)
        self.order = np.argsort(self.lengths, kind="stable")
        self.row_of = np.empty(n, np.int64)
        self.row_of[self.order] = np.arange(n)
        flat = np.frombuffer(b"".join([seqs[i] for i in self.order]),
                             np.uint8)
        if flat.size and int(flat.max()) >= AS219_SIZE + 1:
            raise ValueError("cs219 sequences hold a byte outside the "
                             f"{AS219_SIZE + 1} states")
        ln = self.lengths[self.order]
        offsets = np.zeros(n, np.int64)
        np.cumsum(ln[:-1], out=offsets[1:])
        self.states = torch.from_numpy(flat.copy()).to(self.device)
        self.offsets = torch.from_numpy(offsets).to(self.device)
        self.row_lengths = torch.from_numpy(ln.astype(np.int32)
                                            ).to(self.device)
        self.nbytes = sum(t.numel() * t.element_size() for t in
                          (self.states, self.offsets, self.row_lengths))

    def __len__(self) -> int:
        return len(self.order)

    def scores(self, kernel, qc: torch.Tensor, subset: Optional[np.ndarray],
               *args) -> np.ndarray:
        """``kernel`` (K4/K5 resident entry) over every row, or over the
        database indices ``subset``; (N,) int32 in database order, or in
        ``subset`` order."""
        if subset is None:
            out = kernel(qc, self.states, self.offsets, self.row_lengths,
                         *args).cpu().numpy()
            res = np.empty_like(out)
            res[self.order] = out
            return res
        rows = np.sort(self.row_of[np.asarray(subset, np.int64)])
        rows_d = torch.from_numpy(rows).to(self.device)
        out = kernel(qc, self.states, self.offsets[rows_d],
                     self.row_lengths[rows_d], *args).cpu().numpy()
        return out[np.searchsorted(rows, self.row_of[subset])]


def to_device_cs219(seqs: List[bytes], device) -> ResidentCs219Pack:
    """The resident cs219 pack of ``seqs`` (the bytes that
    :func:`pack_db` pads into a matrix) on ``device``."""
    return ResidentCs219Pack(seqs, resolve_device(device))


def database_cs219(db, device):
    """(names, seqs, pack) of ``db``'s cs219 entries, read once and
    uploaded once per device, cached on the database object — an
    HHDatabase or a MultiHHDatabase alike."""
    dev = resolve_device(device)
    cache = db.__dict__.setdefault("_cs219", {})
    if "seqs" not in cache:
        cache["names"] = [e.name for e in db.cs219.entries]
        cache["seqs"] = [db.cs219.read_bytes(e) for e in db.cs219.entries]
    pack = cache.get(str(dev))
    if pack is None:
        with annotate("cs219_pack_upload"):
            pack = cache[str(dev)] = ResidentCs219Pack(cache["seqs"], dev)
    return cache["names"], cache["seqs"], pack


def prefilter_db(par: Parameters, q_tmp: HMM, lib: ContextLibrary,
                 names: List[str], seqs: List[bytes],
                 previous_hit_names: Optional[set] = None,
                 pack: Optional[ResidentCs219Pack] = None, device=None,
                 counts: Optional[dict] = None
                 ) -> Tuple[List[Tuple[int, str]], List[Tuple[int, str]]]:
    """Prefilter::prefilter_db (hhprefilter.cpp:430-606).

    Returns (new_hits, old_hits) as (length, name) pairs in funnel
    order.  ``pack`` is the resident pack of ``seqs`` (built here on
    ``device`` when not given); ``counts``, when given, receives the
    survivor counts of both stages (``stage1``, ``stage2``).
    """
    from .. import log as hhlog

    previous_hit_names = previous_hit_names or set()
    if pack is None:
        pack = to_device_cs219(seqs, device)
    if len(pack) != len(seqs):
        raise ValueError(f"cs219 pack has {len(pack)} rows for "
                         f"{len(seqs)} sequences")
    qc_np = build_query_profile(q_tmp, lib, par.prefilter_score_offset,
                                par.prefilter_bit_factor)
    qc = torch.from_numpy(qc_np).to(pack.device)
    LQ = q_tmp.L
    num_dbs = len(seqs)
    log_qlen = float(fm.flog2(np.float32(LQ)))
    factor = float(num_dbs) * LQ

    with annotate("prefilter_stage1_ungapped"):
        raw1 = pack.scores(ungapped_scores_packed, qc, None,
                           par.prefilter_score_offset)
    lens = pack.lengths
    corr = (par.prefilter_bit_factor
            * (log_qlen + fm.flog2(lens.astype(np.float32)))).astype(int)
    score1 = raw1 - corr
    # sort desc by (score, index) — reference sorts pairs ascending then
    # reverses (hhprefilter.cpp:487-489): ties broken by larger index
    order = np.lexsort((np.arange(num_dbs), score1))[::-1]
    # cut: first rank >= min_hits whose score drops below the threshold
    osc = score1[order]
    drop = np.nonzero((np.arange(num_dbs) >= par.min_prefilter_hits)
                      & (osc <= par.preprefilter_smax_thresh))[0]
    cut = int(drop[0]) if drop.size else num_dbs
    survivors = [int(n) for n in order[:cut]]

    hhlog.info(f"HMMs passed 1st prefilter (gapless profile-profile "
               f"alignment)  : {len(survivors)}")

    gap_init = par.prefilter_gap_open + par.prefilter_gap_extend
    with annotate("prefilter_stage2_gapped"):
        raw2 = pack.scores(gapped_scores_packed, qc,
                           np.asarray(survivors, np.int64), gap_init,
                           par.prefilter_gap_extend,
                           par.prefilter_score_offset)
    # vectorized E-values, same f32 quantization + f64 product order as
    # the scalar form: (factor * lens[n]) * float(fpow2(f32(-raw2/bf)))
    surv = np.asarray(survivors, dtype=np.int64)
    fp = fm.fpow2(((-np.asarray(raw2))
                   / par.prefilter_bit_factor).astype(np.float32))
    ev_all = ((factor * lens[surv].astype(np.float64))
              * np.asarray(fp, np.float64))
    keep_m = ev_all < par.prefilter_evalue_coarse_thresh
    sel = np.nonzero(keep_m)[0]
    # ascending (E-value, index) — matches sort(key=(ev, n))
    sel = sel[np.lexsort((surv[sel], ev_all[sel]))]
    ev_sorted = ev_all[sel]
    n_sorted = surv[sel]
    drop = np.nonzero((np.arange(sel.size) >= par.min_prefilter_hits)
                      & (ev_sorted > par.prefilter_evalue_thresh))[0]
    cut2 = int(drop[0]) if drop.size else sel.size
    kept = [int(n) for n in n_sorted[:cut2]]
    hhlog.info(f"HMMs passed 2nd prefilter (gapped profile-profile "
               f"alignment)   : {len(kept)}")
    if counts is not None:
        counts.update(stage1=len(survivors), stage2=len(kept))

    new_hits, old_hits = [], []
    seen = set()
    count = 0
    for n in kept:
        name = names[n]
        if name in seen:
            continue
        seen.add(name)
        count += 1
        base = name.rsplit(".", 1)[0] if "." in name else name
        pair = (int(lens[n]), name)
        if f"{base}__1" in previous_hit_names:
            old_hits.append(pair)
        else:
            new_hits.append(pair)
        if count >= par.maxnumdb:
            break
    return new_hits, old_hits
