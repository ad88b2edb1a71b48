#!/usr/bin/env python3
"""Times the fitmask kernels on one CUDA card, case by case, for the
kernels of a given source tree: the multi-box kernel (K1, and K3
through it), the occupancy counts (K2) and the fused bucketed launch
(bool planes and counts in one launch).

    python3 benchmarks_torch/fitmask_bench.py [--src DIR] [--tree NAME]
        [--variants] [--quick] [--out PATH]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's). Pointed at another checkout (a ``git
archive`` of an earlier commit unpacked under ``build/``), it times that
tree's kernels on the same cases, so two kernels can be compared inside
one call to the card, in turns (earlier, this, this, earlier).
``--variants`` also times each way this checkout's kernel may OR a
box's rows (``kernel.OR_MODES``: direct, staged, and shuffle where the
grid allows it).

The cases and their seeded grids are ``chip_smoke.py``'s kernel cases
(K2 also its count-only cases). Each timed call is first held bit-exact
against the plain version; a tree that refuses a grid prints
``refused``, one without the kernel ``absent``. ``ms`` is device time per
launch, queued behind a spin kernel (``chip_smoke.device_ms``). Beside
each multi-box case it times the card's floor for writing the same int32
output (``Tensor.zero_``), and once the floor for one launch
(``chip_smoke.launch_floor_ms``). Prints the card's name and power
limit, then CSV rows ``fitmask_bench,tree,kernel,case,box,plan,ms``.

Last, the single-pass section: K1 (one launch for all K boxes) against
``fitmask_multibox_singlepass_baseline`` (K launches of K3, stacked) on
the cells of ``repro``'s ``benchmarks/fitmask_bench.py`` (grids 8^3 and
16^3, B 1, 8 and 64, K 1, 4, 8 and 16; its candidate boxes and grids of
30 % occupancy from numpy's generator, seed 0). Each timed call is first
held bit-exact against K1. Prints ``singlepass`` rows and the headline,
the multi-box speed-up at 16^3 with K >= 4. ``--quick`` runs only the
single-pass section's headline cell (16^3, B 8, K 4), as repro's
``--quick``. The JSON (``--out``, default
``experiments/fitmask_bench_torch.json``; '' disables; never a committed
BENCH_*.json) holds the card, the case rows (``cases``: kernel, case,
box, plan, ms), the single-pass rows (``sweep``: grid, batch, k,
multibox_ms, singlepass_ms, speedup) and the headline.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# repro's benchmarks/fitmask_bench.py: candidate boxes in the spirit of
# fold enumeration (the flat and compact shapes RFold queries), truncated
# to K and filtered by grid, and its sweep.
CANDIDATE_BOXES = [
    (4, 4, 4), (8, 4, 2), (2, 2, 2), (16, 2, 2), (8, 8, 1), (4, 2, 1),
    (16, 4, 1), (2, 4, 8), (8, 2, 4), (1, 1, 1), (16, 16, 1), (4, 8, 2),
    (3, 3, 3), (6, 2, 2), (12, 2, 1), (2, 8, 4), (5, 2, 2), (2, 6, 2),
    (4, 4, 1), (7, 1, 1), (1, 8, 2), (2, 2, 5), (6, 4, 1), (3, 2, 4),
]
SINGLEPASS_CELLS = [(grid, bsz, k) for grid in ((8, 8, 8), (16, 16, 16))
                    for bsz in (1, 8, 64) for k in (1, 4, 8, 16)]
# --quick: the headline cell of repro's --quick.
QUICK_CELL = ((16, 16, 16), 8, 4)


def boxes_for(grid, k):
    out = [b for b in CANDIDATE_BOXES
           if all(e <= d for e, d in zip(b, grid))]
    if len(out) < k:
        raise ValueError(f"{len(out)} candidate boxes fit {grid}, not {k}")
    return out[:k]


def singlepass_sweep(kernel, device, timer, cells=SINGLEPASS_CELLS):
    """K1 against the single-pass baseline on ``cells`` ((grid, B, K)),
    each first held bit-exact against K1; ``timer(fn)`` gives ms. Prints
    one row a cell and the headline; returns the rows."""
    import numpy as np

    rng = np.random.default_rng(0)
    rows = []
    print("singlepass,grid,B,K,multibox_ms,singlepass_ms,speedup")
    for grid, bsz, k in cells:
        occ = torch.from_numpy(rng.uniform(size=(bsz,) + grid) < 0.3).to(
            device)
        boxes = boxes_for(grid, k)
        multi = lambda: kernel.fitmask_multibox(occ, boxes)  # noqa: E731
        single = lambda: kernel.fitmask_multibox_singlepass_baseline(  # noqa: E731
            occ, boxes)
        if not torch.equal(single(), multi()):
            raise AssertionError(f"single-pass baseline at {grid}, B {bsz}, "
                                 f"K {k}: differs from K1")
        m_ms, s_ms = timer(multi), timer(single)
        rows.append(dict(grid="x".join(map(str, grid)), batch=bsz, k=k,
                         multibox_ms=m_ms, singlepass_ms=s_ms,
                         speedup=s_ms / m_ms))
        print("singlepass,%s,%d,%d,%s,%s,%s" % (
            rows[-1]["grid"], bsz, k, m_ms, s_ms, rows[-1]["speedup"]),
            flush=True)
    head = [r["speedup"] for r in rows if r["grid"] == "16x16x16"
            and r["k"] >= 4]
    if head:
        print(f"# headline: at 16^3, K >= 4, one K1 launch is {min(head)}x "
              f"to {max(head)}x faster than K launches of K3")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tree", default="this")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the single-pass headline cell only (16^3, B 8, "
                         "K 4)")
    ap.add_argument("--out", default=os.path.join(
        "experiments", "fitmask_bench_torch.json"),
        help="JSON output ('' disables); never a committed BENCH_*.json")
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        ap.error("the committed BENCH_*.json snapshots are the reference "
                 "package's; write the port's JSON elsewhere")
    if not torch.cuda.is_available():
        print("fitmask_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels.fitmask import kernel

    card = cs.card_line()
    print(card)
    print(f"# {args.tree}: {Path(kernel.__file__).resolve()}")
    device = torch.device("cuda")

    def run(name, label, box, plan, fn, plain):
        try:
            got = fn()
        except ValueError:
            ms = "refused"
        else:
            if not cs.same(got, plain()):
                raise AssertionError(f"{args.tree} {name} on {label} "
                                     f"({plan}): differs from plain")
            ms = cs.device_ms(fn, cs.time_ms(fn))
        box = "" if box is None else "x".join(map(str, box))
        cases.append(dict(kernel=name, case=label, box=box, plan=plan,
                          ms=ms))
        print(f"fitmask_bench,{args.tree},{name},{label},{box},{plan},{ms}",
              flush=True)

    def counts(label, occ):
        run("occupancy_counts", label, None, "default",
            lambda: kernel.occupancy_counts(occ),
            lambda: kernel.occupancy_counts_plain(occ))

    cases = []
    out = {"tree": args.tree, "card": card, "cases": cases, "sweep": []}
    if args.quick:
        return _finish(kernel, device, args.out, out, [QUICK_CELL])
    print(f"fitmask_bench,{args.tree},launch floor,,,,{cs.launch_floor_ms()}")
    bucketed = getattr(kernel, "fitmask_multibox_bucketed", None)
    for label, bsz, dims, occ in cs.count_inputs(device):
        counts(label, occ)
    for label, bsz, dims, boxes, occ in cs.kernel_inputs(device):
        counts(label, occ)
        if not boxes:
            continue
        if bucketed is None:
            print(f"fitmask_bench,{args.tree},fitmask_multibox_bucketed,"
                  f"{label},,default,absent")
        else:
            run("fitmask_multibox_bucketed", label, None, "default",
                lambda: bucketed(occ, boxes),
                lambda: kernel.fitmask_multibox_bucketed_plain(occ, boxes))
        work = [("fitmask_multibox", None, boxes)]
        work += [("fitmask_batched", box, [box])
                 for box in cs.single_boxes(dims, boxes).values()]
        for name, box, table in work:
            def plain(table=table):
                return kernel.fitmask_multibox_plain(occ, table)
            if name == "fitmask_multibox":
                fn = lambda: kernel.fitmask_multibox(occ, boxes)  # noqa: E731
            else:
                fn = lambda box=box: kernel.fitmask_batched(  # noqa: E731
                    occ, box)[:, None]
            run(name, label, box, "default", fn, plain)
            if name == "fitmask_multibox":     # the same bytes, written alone
                fill = torch.empty((bsz, len(boxes), *dims),
                                   dtype=torch.int32, device=device)
                ms = cs.device_ms(fill.zero_, cs.time_ms(fill.zero_))
                print(f"fitmask_bench,{args.tree},write floor,{label},,"
                      f"zero_,{ms}")
            if not args.variants:
                continue
            host = kernel.box_table(table)
            for mode in kernel.OR_MODES:
                if mode == "shuffle" and 32 % dims[1]:
                    continue
                plan = kernel.launch_plan(bsz, *dims, host, mode=mode)
                run(name, label, box, mode,
                    lambda plan=plan, host=host:
                    kernel._launch_multibox(occ, host, plan), plain)
    if not hasattr(kernel, "fitmask_multibox_singlepass_baseline"):
        print(f"fitmask_bench,{args.tree},singlepass,,,,absent")
        return _write(args.out, out)
    return _finish(kernel, device, args.out, out, SINGLEPASS_CELLS)


def _finish(kernel, device, path, out, cells) -> int:
    """The single-pass section on ``cells`` into ``out``, then the JSON."""
    import chip_smoke as cs

    rows = singlepass_sweep(kernel, device,
                            lambda fn: cs.device_ms(fn, cs.time_ms(fn)),
                            cells=cells)
    out["sweep"] = rows
    head = [r["speedup"] for r in rows if r["grid"] == "16x16x16"
            and r["k"] >= 4]
    if head:
        out["headline"] = {
            "criterion": "one K1 launch beats K launches of K3 (K >= 4, "
                         "16^3, device time)",
            "min_speedup": min(head), "max_speedup": max(head),
            "pass": all(h > 1.0 for h in head)}
    return _write(path, out)


def _write(path, out) -> int:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
