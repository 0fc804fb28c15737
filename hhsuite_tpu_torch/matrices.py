"""Substitution matrices and derived tables.

Reproduces `src/hhmatrices.cpp:20-188` of the reference: joint probability
matrix P, background frequencies pb, conditional matrix R=P(a|b), log-odds
S, similarity matrix Sim, and the secondary-structure scoring matrices
S73/S37/S33.  The raw tables (Gonnet in 1e-6 units, BLOSUM triangles, the
DSSP×PSIPRED confusion table Ppred and DSSP background Pobs) are shipped as
a data asset in ``data/tables.npz``.

Float32 accumulation order matches the reference so derived values agree
bit-for-bit.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from .constants import MAXCF, NDSSP, NSSPRED

_DATA = os.path.join(os.path.dirname(__file__), "data", "tables.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    return dict(np.load(_DATA))


@dataclass
class SubstitutionMatrix:
    """P joint, pb background, R conditional, S log-odds, Sim similarity."""

    P: np.ndarray    # (20,20) float32 joint probabilities (internal aa order)
    pb: np.ndarray   # (20,)   float32 background frequencies
    R: np.ndarray    # (20,20) float32 R[a,b] = P(a|b)
    S: np.ndarray    # (20,20) float32 log2-odds
    Sim: np.ndarray  # (20,20) float32 similarity for consensus


def _seq_sum_f32(values):
    """Strict left-to-right float32 accumulation (matches C loops)."""
    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return acc


@functools.lru_cache(maxsize=8)
def get_substitution_matrix(matrix: int = 0) -> SubstitutionMatrix:
    """Build the matrix set for ``-M`` option (0=Gonnet, 30..80=BLOSUMxx).

    Mirrors SetSubstitutionMatrix (hhmatrices.cpp:20-142).
    """
    t = _tables()
    P = np.zeros((20, 20), dtype=np.float32)
    if matrix == 0:
        g = t["gonnet"].astype(np.float32)
        P[:] = (np.float32(0.000001) * g).reshape(20, 20)
    else:
        tri = t[f"blosum{matrix}"].astype(np.float32)
        n = 0
        for a in range(20):
            for b in range(a + 1):
                P[a, b] = tri[n]
                n += 1
        for a in range(19):
            for b in range(a + 1, 20):
                P[a, b] = P[b, a]

    # renormalize P in reference accumulation order (row-major)
    sumab = _seq_sum_f32(P.reshape(-1))
    P = (P / sumab).astype(np.float32)
    pb = np.zeros(20, dtype=np.float32)
    for a in range(20):
        pb[a] = _seq_sum_f32(P[a])

    Sim = (P * P / np.diag(P)[:, None] / np.diag(P)[None, :]).astype(np.float32)
    R = (P / pb[None, :]).astype(np.float32)
    # S computed with libm double log2, stored float (hhmatrices.cpp:74)
    S = np.log2((R / pb[:, None]).astype(np.float32).astype(np.float64))
    S = S.astype(np.float32)
    return SubstitutionMatrix(P=P, pb=pb, R=R, S=S, Sim=Sim)


@dataclass
class SecStrucMatrices:
    S73: np.ndarray  # (NDSSP, NSSPRED, MAXCF) float32
    S37: np.ndarray  # (NSSPRED, MAXCF, NDSSP) float32
    S33: np.ndarray  # (NSSPRED, MAXCF, NSSPRED, MAXCF) float32


@functools.lru_cache(maxsize=4)
def get_ss_matrices(ssa: float = 1.0) -> SecStrucMatrices:
    """SS substitution matrices (hhmatrices.cpp:148-188)."""
    t = _tables()
    ppred = t["ss_ppred"].astype(np.float32).reshape(MAXCF, NSSPRED, NDSSP)
    pobs = t["ss_pobs"].astype(np.float32)

    ssa32 = np.float32(ssa)
    # P73[A][B][cf] = 1-ssa + ssa*Ppred[cf][B][A]
    P73 = np.float32(1.0) - ssa32 + ssa32 * ppred.transpose(2, 1, 0)
    S73 = np.log2(P73.astype(np.float64)).astype(np.float32)
    S37 = S73.transpose(1, 2, 0).copy()

    S33 = np.zeros((NSSPRED, MAXCF, NSSPRED, MAXCF), dtype=np.float32)
    for B in range(NSSPRED):
        for cf in range(MAXCF):
            for BB in range(NSSPRED):
                for ccf in range(MAXCF):
                    s = _seq_sum_f32(P73[1:, B, cf] * P73[1:, BB, ccf]
                                     * pobs[1:])
                    S33[B, cf, BB, ccf] = np.float32(
                        np.log2(np.float64(s)))
    return SecStrucMatrices(S73=S73, S37=S37, S33=S33)
