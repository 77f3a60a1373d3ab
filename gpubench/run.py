"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The set-up clock starts here, before any
import of torch or the program; this module imports nothing else at its top,
because the worker processes of the reference import it again.
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from gpubench.harness import main
    sys.exit(main(T0))
