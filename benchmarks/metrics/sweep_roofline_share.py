"""The funnel's score sweep (vit_score_kernel: K1, or K6 with SS) against
its roofline."""

from harness import readings


def read(ctx):
    return readings.roofline(ctx, "vit_score_kernel")
