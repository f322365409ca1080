"""Run one cell of the benchmark once:

    python3 -m vobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; the checks of ``correct`` are the last lines of standard
error.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

if __name__ == "__main__":
    import sys

    from vobench.harness import main

    sys.exit(main(t0=T0))
