"""Prefix each line of standard input with the seconds since it started.

    python3 -u chip_smoke.py 2>&1 | python3 stamp_lines.py > run.log

The gap before a line is the time the step that printed it took, so a
stamped log shows where a run's time goes. Each line becomes
``[ elapsed] line``, the elapsed seconds to one decimal in 8 columns.
"""

import sys
import time


def main() -> int:
    t0 = time.perf_counter()
    for line in sys.stdin:
        sys.stdout.write("[%8.1f] %s" % (time.perf_counter() - t0, line))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
