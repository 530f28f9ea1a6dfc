"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the run's result as the last line of
standard output, and the numbers compared with the reference, each beside
its limit, as the last lines of standard error.  Exits non-zero, with no
result, where the cell's cards are missing or the run loaded JAX or the
JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache a library may keep, at fixed places inside the checkout
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
