"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the traced
stretch's ``busy_s``/``window_s`` and the ``breakdown``; both end in
``check``, each compared number beside its limit, which the last lines of
standard error repeat.  ``--control 1`` puts the control (the reference
in fp8) in the program's place: the check judges the tokens it puts
first, and ``correct`` has to come out false; it serves to set limits,
and the benchmark's runs leave it off.

It exits with a code other than 0, and prints no result, without the
cards the cell asks for, when the program is missing, or when the process
holds JAX or the JAX package once the window has closed.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402

# one host thread for CPU tensor work: the program runs on the card, and an
# idle OpenMP pool only takes cores from the scheduler's thread
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0, control=bool(args.control))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}: the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
