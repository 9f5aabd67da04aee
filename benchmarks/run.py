"""Run one cell of the benchmark of pctpu_torch once and print its result
line (see ``benchmarks/README.md``):

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # the checkout: pctpu_torch
sys.path.insert(0, HERE)  # harness, reference

if __name__ == "__main__":
    from harness.main import main

    sys.exit(main(sys.argv[1:], T_START))
