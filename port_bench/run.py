"""Run one cell of the port's benchmark and print its result line.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 also
breakdown; the compared numbers and their limits last, under "checks").
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 1.  ``--control 1`` puts the control (the reference in
float32 with TF32 products) in the chain's place: its numbers are the
"checks" and decide "correct" by the same limits, the chain's go under
"chain_checks"; the benchmark's own runs do not ask for it.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace), bool(a.control))
    if result is None:
        return 1
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
