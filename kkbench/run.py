"""Runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output:

    python3 kkbench/run.py --workload hpcg104.symgs_pcg --seed 7 --seconds 10 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics with the device's busy seconds and the breakdown.  The
numbers that decide ``correct`` are the last lines of standard error and
the result's last key.  A run without enough CUDA devices, whose process
or any of whose rank processes holds JAX or ``tpukk`` once the window has
closed, or one of whose ranks fails, exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, reg=None, device=None) -> int:
    """Tests pass a registry of their own cells (``reg``; None:
    BENCHMARK.json's) and the CPU (``device``; None: the cards)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "kkbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "kkbench" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from kkbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), reg=reg,
                             device=device)
    except harness.NoDevice as e:
        print(e, file=sys.stderr)
        return 2
    except harness.Forbidden as e:
        print(e, file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print(f"kkbench: the run's process holds {bad}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
