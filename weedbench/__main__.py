"""`python -m weedbench`: see weedbench/run.py."""

import time

if __name__ == "__main__":
    _t0 = time.monotonic()
    import sys

    from weedbench.run import main
    sys.exit(main(t0=_t0))
