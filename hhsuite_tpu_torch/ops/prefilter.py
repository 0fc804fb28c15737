"""Prefilter kernels: K4 (stage-1 ungapped) and K5 (stage-2 gapped
Smith-Waterman) over cs219 states, CUDA C++ in ``csrc/prefilter.cu``.

The reference streams uint8-saturated SIMD over one database sequence at
a time (src/hhprefilter.cpp:70-275).  Both stages score a batch of
database sequences of cs219 states against the (220, Lq) query table
(row x = state x, row 219 = ANY, values in [0, 255]) with the uint8
saturation emulated exactly in int32:

* stage 1 (:func:`ungapped_scores`, K4): the best ungapped diagonal,
  ``S(i,j) = max(min(S(i-1,j-1) + qc[x_j][i], 255) - offset, 0)``;
* stage 2 (:func:`gapped_scores`, K5): Smith-Waterman with gap_init /
  gap_extend in saturated arithmetic and the exact intra-column F
  fixpoint (an exclusive prefix max along the query).

K4 replaces hhsuite_tpu/ops/prefilter_pallas.py:ungapped_scores_pallas
and K5 hhsuite_tpu/ops/prefilter_pallas2.py:gapped_scores_pallas; both
must equal the JAX scan versions (hhsuite_tpu/ops/prefilter.py) as
integers.  The public wrappers keep the JAX signatures: ``qc`` (220, Lq)
int in [0, 255], ``db`` (B, Ld) int padded with 219, ``db_len`` (B,),
int scalars; they return (B,) int32.  :func:`ungapped_scores_packed` and
:func:`gapped_scores_packed` take the resident layout of
:class:`search.prefilter.ResidentCs219Pack` instead: one flat uint8
state array with per-row int64 offsets and int32 lengths.

On CPU tensors the wrappers run the plain PyTorch versions (a loop over
database positions on (B, Lq) int32 tensors, as the JAX scans); on CUDA
tensors they launch the kernel or raise.  ``ungapped_scores.launches``
and ``gapped_scores.launches`` count kernel launches of both entry
points.
"""

from __future__ import annotations

import ctypes

import torch

NS = 220          # AS219 states + ANY (the padding state)
NEG = -(10 ** 9)

_BOUND = {}


def cuda_lib():
    """The built ``csrc/prefilter.cu`` library with its C signatures."""
    from ..device import cuda_library

    lib, _info = cuda_library("prefilter")
    if not _BOUND.get(id(lib)):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hh_pf_ungapped.argtypes = [P, I, P, P, P, I, I, P, P]
        lib.hh_pf_ungapped.restype = I
        lib.hh_pf_gapped_slots.argtypes = [I, I]
        lib.hh_pf_gapped_slots.restype = I
        lib.hh_pf_gapped.argtypes = [P, I, P, P, P, I, I, I, I, P, I, P, P]
        lib.hh_pf_gapped.restype = I
        lib.hh_pf_error_string.argtypes = [I]
        lib.hh_pf_error_string.restype = ctypes.c_char_p
        _BOUND[id(lib)] = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{lib.hh_pf_error_string(abs(rc)).decode()}")


# ---------------------------------------------------------- plain ----

def _steps(qc, db, db_len):
    """Common set-up of the plain versions: the int32 table on the
    database's device, the state columns and the validity masks."""
    dev = db.device
    qc = torch.as_tensor(qc).to(dev, torch.int32)
    db = db.to(torch.long)
    ln = torch.as_tensor(db_len).to(dev, torch.int32)
    # positions past every row's length change nothing (S, H, E are 0)
    Ld = min(db.shape[1], int(ln.max()) if ln.numel() else 0)
    return qc, db, ln, max(Ld, 0)


def ungapped_scores_plain(qc, db, db_len, offset):
    """Plain PyTorch version of K4 (any device): the JAX scan
    (hhsuite_tpu/ops/prefilter.py:ungapped_scores), one step per database
    position on (B, Lq) int32 tensors."""
    qc, db, ln, Ld = _steps(qc, db, db_len)
    B, Lq = db.shape[0], qc.shape[1]
    off = int(offset)
    S = torch.zeros((B, Lq), dtype=torch.int32, device=db.device)
    best = torch.zeros_like(S)
    for j in range(Ld):
        shifted = torch.nn.functional.pad(S[:, :-1], (1, 0))
        S = ((shifted + qc[db[:, j]]).clamp_max(255) - off).clamp_min(0)
        S = torch.where((j < ln)[:, None], S, 0)
        best = torch.maximum(best, S)
    return best.amax(dim=1)


def gapped_scores_plain(qc, db, db_len, gap_init, gap_extend, offset):
    """Plain PyTorch version of K5 (any device): the JAX scan
    (hhsuite_tpu/ops/prefilter.py:gapped_scores), with the intra-column
    F fixpoint as an exclusive prefix max of ``H0[k] - gi + ge*k``."""
    qc, db, ln, Ld = _steps(qc, db, db_len)
    B, Lq = db.shape[0], qc.shape[1]
    gi, ge, off = int(gap_init), int(gap_extend), int(offset)
    dev = db.device
    H = torch.zeros((B, Lq), dtype=torch.int32, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros_like(H)
    k = torch.arange(Lq, dtype=torch.int32, device=dev)[None]
    neg = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    for j in range(Ld):
        valid = (j < ln)[:, None]
        shifted = torch.nn.functional.pad(H[:, :-1], (1, 0))
        vH = ((shifted + qc[db[:, j]]).clamp_max(255) - off).clamp_min(0)
        H0 = torch.maximum(vH, E)
        run = torch.cummax(H0 - gi + ge * k, dim=1).values
        pref = torch.cat([neg, run[:, :-1]], dim=1)
        F = (pref - ge * (k - 1)).clamp_min(0)
        H = torch.where(valid, torch.maximum(H0, F), 0)
        E = torch.maximum((E - ge).clamp_min(0), (H - gi).clamp_min(0))
        E = torch.where(valid, E, 0)
        best = torch.maximum(best, H)
    return best.amax(dim=1)


def packed_rows(states, offsets, lengths, rows):
    """Pack rows ``rows`` of the resident layout as a (len(rows), Ld)
    int64 state matrix padded with 219 (Ld = their longest length) and
    their lengths: the plain versions' input."""
    ln = lengths[rows]
    Ld = max(int(ln.max()) if ln.numel() else 0, 1)
    pos = torch.arange(Ld, device=states.device)[None]
    inside = pos < ln[:, None].to(torch.long)
    idx = torch.where(inside, offsets[rows][:, None] + pos, 0)
    db = torch.where(inside, states[idx].to(torch.long), NS - 1)
    return db, ln


def packed_plain(fn, qc, states, offsets, lengths, *args, chunk=4096):
    """A plain version over the resident layout, ``chunk`` rows at a
    time (rows sorted by length keep each chunk's padding small)."""
    B = int(lengths.shape[0])
    out = torch.zeros(B, dtype=torch.int32, device=states.device)
    for s in range(0, B, chunk):
        rows = torch.arange(s, min(B, s + chunk), device=states.device)
        db, ln = packed_rows(states, offsets, lengths, rows)
        out[s: s + len(rows)] = fn(qc, db, ln, *args)
    return out


# ---------------------------------------------------------- kernels ----

def _table(qc, dev) -> torch.Tensor:
    """(220, Lq) table as uint8 bytes on ``dev``, zero-padded to a
    multiple of 16 bytes (the kernels copy it in 16-byte words)."""
    qc = torch.as_tensor(qc)
    if qc.dim() != 2 or qc.shape[0] != NS or qc.shape[1] < 1:
        raise ValueError(f"query table must be ({NS}, Lq >= 1), "
                         f"not {tuple(qc.shape)}")
    n = qc.numel()
    buf = torch.zeros(-(-n // 16) * 16, dtype=torch.uint8, device=dev)
    buf[:n] = qc.to(dev).reshape(-1).to(torch.uint8)
    return buf


def _packed_args(states, offsets, lengths):
    dev = states.device
    if dev.type != "cuda":
        raise ValueError(f"prefilter kernels take CPU or CUDA tensors, "
                         f"not {dev}")
    if states.dtype != torch.uint8 or offsets.dtype != torch.int64 \
            or lengths.dtype != torch.int32:
        raise ValueError("resident layout: states uint8, offsets int64, "
                         "lengths int32")
    if offsets.shape != lengths.shape or offsets.dim() != 1:
        raise ValueError("resident layout: offsets and lengths must be "
                         "(B,)")
    for t in (offsets, lengths):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
    return states.contiguous(), offsets.contiguous(), lengths.contiguous()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_ungapped(qc, states, offsets, lengths, offset):
    states, offsets, lengths = _packed_args(states, offsets, lengths)
    dev = states.device
    lib = cuda_lib()
    table = _table(qc, dev)
    Lq = int(torch.as_tensor(qc).shape[1])
    B = int(lengths.shape[0])
    out = torch.empty(B, dtype=torch.int32, device=dev)
    rc = lib.hh_pf_ungapped(table.data_ptr(), Lq, states.data_ptr(),
                            offsets.data_ptr(), lengths.data_ptr(), B,
                            int(offset), out.data_ptr(), _stream(dev))
    _check(lib, rc, "K4 ungapped_scores")
    ungapped_scores.launches += 1
    return out


def _launch_gapped(qc, states, offsets, lengths, gap_init, gap_extend,
                   offset):
    gi, ge, off = int(gap_init), int(gap_extend), int(offset)
    if gi < 0 or ge < 0 or off < 0:
        raise ValueError("K5 takes gap_init, gap_extend, offset >= 0 "
                         f"(got {gi}, {ge}, {off})")
    states, offsets, lengths = _packed_args(states, offsets, lengths)
    dev = states.device
    lib = cuda_lib()
    table = _table(qc, dev)
    Lq = int(torch.as_tensor(qc).shape[1])
    B = int(lengths.shape[0])
    out = torch.empty(B, dtype=torch.int32, device=dev)
    slots = lib.hh_pf_gapped_slots(Lq, B)
    _check(lib, min(slots, 0), "K5 gapped_scores (occupancy)")
    scratch = torch.empty(max(slots, 1) * Lq, dtype=torch.int16, device=dev)
    rc = lib.hh_pf_gapped(table.data_ptr(), Lq, states.data_ptr(),
                          offsets.data_ptr(), lengths.data_ptr(), B, gi, ge,
                          off, scratch.data_ptr(), slots, out.data_ptr(),
                          _stream(dev))
    _check(lib, rc, "K5 gapped_scores")
    gapped_scores.launches += 1
    return out


def _as_packed(db, db_len):
    """(B, Ld) int states + lengths -> the resident layout (a row stops
    at min(db_len, Ld), as the JAX scan masks positions past db_len)."""
    B, Ld = db.shape
    states = db.to(torch.uint8).reshape(-1)
    offsets = torch.arange(B, dtype=torch.int64, device=db.device) * Ld
    lengths = torch.as_tensor(db_len).to(db.device, torch.int64)
    return states, offsets, lengths.clamp(0, Ld).to(torch.int32)


# ---------------------------------------------------------- public ----

def ungapped_scores(qc, db, db_len, offset):
    """K4: (B,) int32 best ungapped diagonal scores (JAX signature)."""
    if db.device.type == "cpu":
        return ungapped_scores_plain(qc, db, db_len, offset)
    return _launch_ungapped(qc, *_as_packed(db, db_len), offset)


ungapped_scores.launches = 0


def gapped_scores(qc, db, db_len, gap_init, gap_extend, offset):
    """K5: (B,) int32 best Smith-Waterman scores (JAX signature)."""
    if db.device.type == "cpu":
        return gapped_scores_plain(qc, db, db_len, gap_init, gap_extend,
                                   offset)
    return _launch_gapped(qc, *_as_packed(db, db_len), gap_init, gap_extend,
                          offset)


gapped_scores.launches = 0


def ungapped_scores_packed(qc, states, offsets, lengths, offset):
    """K4 over the resident layout: (B,) int32 per row."""
    if states.device.type == "cpu":
        return packed_plain(ungapped_scores_plain, qc, states, offsets,
                            lengths, offset)
    return _launch_ungapped(qc, states, offsets, lengths, offset)


def gapped_scores_packed(qc, states, offsets, lengths, gap_init, gap_extend,
                         offset):
    """K5 over the resident layout: (B,) int32 per row."""
    if states.device.type == "cpu":
        return packed_plain(gapped_scores_plain, qc, states, offsets,
                            lengths, gap_init, gap_extend, offset)
    return _launch_gapped(qc, states, offsets, lengths, gap_init, gap_extend,
                          offset)
