"""python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once on the card and prints its result as
the last line of standard output (benchmark/harness.py says how).
"""

import os
import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    # the repository root, not this directory, is where imports start
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T0))
