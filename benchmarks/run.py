"""Run one cell of the benchmark once and print its result line.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
BENCHMARK.json at the root of the checkout; see benchmarks/harness/.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one host thread a math library: the 2 client threads are the load,
# and pools of 8 threads each on the 8 cores made runs spread widely
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
