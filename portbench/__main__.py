"""``python3 -m portbench``: one run of one cell (harness.main)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
