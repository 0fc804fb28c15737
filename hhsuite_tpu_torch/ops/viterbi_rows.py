"""K3: the general backtrace Viterbi kernel, CUDA C++ in
``csrc/viterbi.cu``.

Replaces hhsuite_tpu/ops/viterbi_rows.py:viterbi_batch_rows, the Pallas
row-sweep kernel: a 5-state Viterbi with a cell-off mask, an optional
secondary-structure score, local or global mode, and the backtrace
bytes.  It serves the altali passes 2..4 (exclusion masks built on the
device by :func:`ops.viterbi.exclusion_mask_device`), SS-in-DP batches,
global mode and queries longer than K2 takes.

The TPU kernel solves the same-row GD/IM chains with Kogge-Stone scans
that drift by ~1 ulp on long gap runs; here each template is one thread
walking its columns in order, so the kernel holds the stronger contract:
score, end cell and every backtrace byte are bit-identical to
:func:`ops.viterbi.viterbi_batch`, its plain version.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``viterbi_batch_rows.launches`` counts
kernel launches.
"""

from __future__ import annotations

from .viterbi import viterbi_batch
from .viterbi_lanes import launch_bt


def viterbi_batch_rows(qp, qtr, tp, ttr, cell_off, t_L, shift,
                       ss_score=None, local=True, Lq_true=None,
                       penalty_gap_query=0.0, penalty_gap_template=0.0):
    """Contract of ops.viterbi.viterbi_batch (the end-gap penalties
    default to the search's egq = egt = 0).

    ``cell_off`` (B, Lq+1, Lt+1) bool or None, ``ss_score``
    (B, Lq+1, Lt+1) f32 or None; lanes-last views are read in place.
    Returns (score, i2, j2, bt (B, Lq+1, Lt+1) u8)."""
    if tp.device.type == "cpu":
        return viterbi_batch(qp, qtr, tp, ttr, cell_off, t_L, shift, 0.0,
                             penalty_gap_query, penalty_gap_template,
                             ss_score=ss_score, local=local,
                             Lq_true=Lq_true)
    out = launch_bt(qp, qtr, tp, ttr, t_L, cell_off, ss_score, shift, local,
                    Lq_true, penalty_gap_query, penalty_gap_template)
    viterbi_batch_rows.launches += 1
    return out


viterbi_batch_rows.launches = 0
