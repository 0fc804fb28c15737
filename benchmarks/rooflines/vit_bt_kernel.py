"""Work of the backtrace pass's kernel (K2; K3 with exclusions, SS in
the DP or global mode): the local HMM-HMM Viterbi recurrence over the
real cells of every lane the program launched, the backtrace byte of
each cell written.  The program counts the cells at each launch
(``n:bt_cells.<variant>`` in its stage timers: the sum over real lanes of
query length x template length; variants ``k2``, ``k3``, ``k3_co``,
``k3_ss``, ``k3_co_ss``)."""

KERNEL = r"vit_bt_kernel"
PEAK = "f32_flops_per_s"

# float32 operations of one cell, from the recurrence, counted as
# vit_score_kernel.py counts the sweep's (an FMA is 2): the profile dot
# 39, its log2 1, the shift 1; MM: 5 predecessors of 2 sums each 10,
# their 4 maxima and the local floor 5, the match score 1; GD 2 sums + 1
# max, IM 4 + 1, DG 2 + 1, MI 4 + 1; the best cell 1.  The predecessor
# codes the backtrace byte keeps come from the same comparisons.
FLOPS_PER_CELL = 39 + 1 + 1 + 10 + 5 + 1 + 3 + 5 + 3 + 5 + 1
FLOPS_SS = 1          # the SS table's term, added to the match score
# bytes of one cell: the backtrace byte written, and with exclusions
# (``_co``) the cell-off byte read; the profile columns (about a third
# of that at a query of 300 residues) are left out, so the byte bound
# is a lower bound
BYTES_BT = 1
BYTES_CO = 1
COUNTER = "n:bt_cells."


def work(timers: dict):
    """(operations, bytes) of the counted cells, or None where the
    program counted none."""
    ops = nbytes = 0.0
    found = False
    for key, cells in timers.items():
        if not key.startswith(COUNTER):
            continue
        found = True
        variant = key[len(COUNTER):]
        ops += cells * (FLOPS_PER_CELL
                        + (FLOPS_SS if variant.endswith("_ss") else 0))
        nbytes += cells * (BYTES_BT + (BYTES_CO if "_co" in variant
                                       else 0))
    return (ops, nbytes) if found else None
