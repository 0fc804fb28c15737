"""K3: the general backtrace Viterbi kernel, CUDA C++ in
``csrc/viterbi.cu``.

Replaces hhsuite_tpu/ops/viterbi_rows.py:viterbi_batch_rows, the Pallas
row-sweep kernel: a 5-state Viterbi with a cell-off mask, an optional
secondary-structure score, local or global mode, and the backtrace
bytes.  It serves the altali passes 2..4 (exclusion masks built on the
device by :func:`ops.viterbi.exclusion_mask_device`), SS-in-DP batches,
global mode and queries longer than K2 takes.

K3 is K2's kernel (``ops/viterbi_lanes.py:launch_bt``): a group of lanes
per template sweeping an anti-diagonal wavefront, each lane holding 8
query rows in registers, with the cell-off mask read 8 bytes a lane and
column from the kernel's own storage, and the SS term from the table
form (``ss_lut``/``ss_qidx``/``ss_tidx``, as
search/viterbi_search.py:build_ss_lut gives it) in shared memory.

The TPU kernel solves the same-row GD/IM chains with Kogge-Stone scans
that drift by ~1 ulp on long gap runs; here every row of a template is
walked column by column in order, so the kernel holds the stronger
contract: score, end cell and every backtrace byte are bit-identical to
:func:`ops.viterbi.viterbi_batch`, its plain version.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``viterbi_batch_rows.launches`` counts
kernel launches.
"""

from __future__ import annotations

from .viterbi import viterbi_batch
from .viterbi_lanes import launch_bt, ss_table_args


def viterbi_batch_rows(qp, qtr, tp, ttr, cell_off, t_L, shift,
                       ss_score=None, local=True, Lq_true=None,
                       penalty_gap_query=0.0, penalty_gap_template=0.0,
                       ss_lut=None, ss_qidx=None, ss_tidx=None):
    """Contract of ops.viterbi.viterbi_batch (the end-gap penalties
    default to the search's egq = egt = 0).

    ``cell_off`` (B, Lq+1, Lt+1) bool or None (a view of the kernel's
    storage is read in place).  The SS term: ``ss_lut`` (n,) f32 with
    ``ss_qidx`` (Lq,) and ``ss_tidx`` (B, Lt) int offsets into it,
    0 <= qidx + tidx < n as ``build_ss_lut`` makes them (added for
    columns 1..t_L[b], 0 elsewhere); or, on the CPU only, the dense
    ``ss_score`` (B, Lq+1, Lt+1) f32 of the JAX signature.  Returns
    (score, i2, j2, bt (B, Lq+1, Lt+1) u8)."""
    if ss_lut is not None and (ss_qidx is None or ss_tidx is None):
        raise ValueError("K3: ss_lut needs ss_qidx and ss_tidx")
    if tp.device.type == "cpu":
        return viterbi_batch(qp, qtr, tp, ttr, cell_off, t_L, shift, 0.0,
                             penalty_gap_query, penalty_gap_template,
                             ss_score=ss_score, local=local,
                             Lq_true=Lq_true, ss_lut=ss_lut,
                             ss_qidx=ss_qidx, ss_tidx=ss_tidx)
    if ss_score is not None:
        raise ValueError("K3 on the card takes the SS term as a table "
                         "(ss_lut, ss_qidx, ss_tidx from build_ss_lut), "
                         "not a dense ss_score")
    kw = {}
    if ss_lut is not None:
        kw = ss_table_args(ss_lut, ss_qidx, ss_tidx, qp.shape[0] - 2,
                           tp.shape[0], tp.shape[1] - 2, tp.device, "K3")
    out = launch_bt(qp, qtr, tp, ttr, t_L, cell_off, shift, local, Lq_true,
                    penalty_gap_query, penalty_gap_template, **kw)
    viterbi_batch_rows.launches += 1
    return out


viterbi_batch_rows.launches = 0
