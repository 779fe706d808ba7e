"""Run one cell of the benchmark once and print its result as the last line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes, checks and metrics are
named in BENCHMARK.json at the checkout's root (see ``rtbench.harness``).
It needs a CUDA card: without one it exits with code 2 and prints no
result.  Build outputs stay inside the checkout (``build/``).
"""

import os
import sys

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    # Import the benchmark as a package from the checkout's root, and not
    # its files as top-level modules.
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))
    from rtbench.harness import main

    sys.exit(main())
