"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are listed in
``BENCHMARK.json`` at the root of the checkout; ``portbench/harness.py``
says where each one's files live.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
