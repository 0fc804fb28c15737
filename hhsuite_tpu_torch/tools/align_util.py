"""Pairwise sequence alignment helper (equivalent of scripts/Align.pm).

Smith-Waterman / Needleman-Wunsch over plain residue identity (the
'identity' matrix mode of Align.pm, its default for renumberpdb.pl),
with affine gaps: open d, extend e, end-gap g.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -1e9


def align_identity(x: str, y: str, d: float = 3.0, e: float = 0.1,
                   g: float = 0.09, local: bool = False
                   ) -> Tuple[float, list, list]:
    """Align x and y; returns (score, xpos, ypos) where xpos/ypos are
    1-based aligned index pairs (gaps omitted).  Match +2, mismatch -1
    (Align.pm identity scoring)."""
    n, m = len(x), len(y)
    xi = np.frombuffer(x.upper().encode("ascii", "replace"), np.uint8)
    yi = np.frombuffer(y.upper().encode("ascii", "replace"), np.uint8)
    sub = np.where(xi[:, None] == yi[None, :], 2.0, -1.0)

    M = np.full((n + 1, m + 1), NEG)
    Ix = np.full((n + 1, m + 1), NEG)   # gap in y (x advances)
    Iy = np.full((n + 1, m + 1), NEG)
    btM = np.zeros((n + 1, m + 1), np.int8)
    btX = np.zeros((n + 1, m + 1), np.int8)
    btY = np.zeros((n + 1, m + 1), np.int8)

    M[0, 0] = 0.0
    for i in range(1, n + 1):
        Ix[i, 0] = -g * i if not local else 0.0
    for j in range(1, m + 1):
        Iy[0, j] = -g * j if not local else 0.0

    for i in range(1, n + 1):
        srow = sub[i - 1]
        for j in range(1, m + 1):
            # match state
            cands = (M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
            k = int(np.argmax(cands))
            best = cands[k] + srow[j - 1]
            if local and best < 0:
                best, k = 0.0, 3
            M[i, j] = best
            btM[i, j] = k
            # gap states
            openx = M[i - 1, j] - d
            extx = Ix[i - 1, j] - e
            if openx >= extx:
                Ix[i, j], btX[i, j] = openx, 0
            else:
                Ix[i, j], btX[i, j] = extx, 1
            openy = M[i, j - 1] - d
            exty = Iy[i, j - 1] - e
            if openy >= exty:
                Iy[i, j], btY[i, j] = openy, 0
            else:
                Iy[i, j], btY[i, j] = exty, 1

    if local:
        flat = int(np.argmax(M))
        i, j = divmod(flat, m + 1)
        score = M[i, j]
        state = 0
    else:
        ends = (M[n, m], Ix[n, m], Iy[n, m])
        state = int(np.argmax(ends))
        score = ends[state]
        i, j = n, m

    xpos, ypos = [], []
    while i > 0 or j > 0:
        if local and state == 0 and M[i, j] <= 0:
            break
        if state == 0:
            if i == 0 or j == 0:
                break
            k = btM[i, j]
            xpos.append(i)
            ypos.append(j)
            i -= 1
            j -= 1
            if k == 3:
                break
            state = k
        elif state == 1:
            if i == 0:
                break
            k = btX[i, j]
            i -= 1
            state = 0 if k == 0 else 1
        else:
            if j == 0:
                break
            k = btY[i, j]
            j -= 1
            state = 0 if k == 0 else 2
        if local and state == 0 and (i == 0 or j == 0):
            break
    xpos.reverse()
    ypos.reverse()
    return float(score), xpos, ypos
