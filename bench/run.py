"""Run one cell of the benchmark and print its result line.

    python bench/run.py --workload rfold-4096-c4.sweep --seed 7 \\
        --seconds 30 --trace 0

Set-up (imports, the CUDA context, the kernels' build, a warm-up),
then a window of ``--seconds``, then the comparison with the plain
reference. The process keeps to one core (``harness.pin_to_core``).
The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; ``checks`` comes last, each
number compared beside its limit. Exits non-zero, printing no result,
without a card, when a file of the cell is missing, or when JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    harness.quiet_threads()
    harness.pin_to_core()
    try:
        spec = harness.benchmark_spec()
        cell = harness.load_cell(spec, args.workload, args.seed,
                                 bool(args.trace))
        result, verdict = harness.run_cell(spec, cell, args.seconds,
                                           T_START)
    except (harness.CellError, OSError, ImportError) as e:
        print(f"bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    harness.print_result(result, verdict)
    return 0


if __name__ == "__main__":
    sys.exit(main())
