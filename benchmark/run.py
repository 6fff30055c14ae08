"""The benchmark of nv_wavenet_tpu_torch on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line last on standard output (see `harness.py`).
"""

import os
import sys
import time

if __name__ == "__main__":
    T_START = time.perf_counter()
    # one process a card with few host threads: the host's share of a run
    # steadier from run to run
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "2"
    HERE = os.path.dirname(os.path.abspath(__file__))
    # the package `benchmark` and the program are imported from the root;
    # this directory itself stays off the path
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != HERE]
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark import harness
    sys.exit(harness.main(t_start=T_START))
