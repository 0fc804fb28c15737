"""Work of the funnel's score sweep (K1; K6 when SS enters the DP):
every template scored once against the query, Lq x (sum of template
lengths) cells of the local HMM-HMM Viterbi recurrence."""

KERNEL = r"vit_score_kernel"
PEAK = "f32_flops_per_s"

# float32 operations of one cell, from the recurrence (an FMA is 2):
# the profile dot (20 products, 19 sums) 39, its log2 1, the shift 1;
# MM: 5 predecessors of 2 sums each 10, their 4 maxima and the local
# floor 5, the match score 1; GD 2 sums + 1 max, IM 4 + 1, DG 2 + 1,
# MI 4 + 1; the best cell 1
FLOPS_PER_CELL = 39 + 1 + 1 + 10 + 5 + 1 + 3 + 5 + 3 + 5 + 1
FLOPS_SS = 1          # the SS table's term, added to the match score
BYTES_PER_COLUMN = (20 + 7) * 4   # odds profile and transitions, f32


def work(lq: int, db: dict, config: dict, traffic: dict):
    """(operations, bytes) of one query's sweep over the database."""
    ss = bool(traffic.get("ss")) and bool(config["db"].get("ss"))
    cells = lq * db["residues"]
    flops = cells * (FLOPS_PER_CELL + (FLOPS_SS if ss else 0))
    cols = db["residues"] + 2 * db["entries"] + lq + 2
    nbytes = cols * BYTES_PER_COLUMN + 4 * db["entries"]
    if ss:
        nbytes += db["residues"] + lq      # one table index a column
    return float(flops), float(nbytes)
