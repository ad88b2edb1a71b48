#!/usr/bin/env python3
"""Times the fitmask kernels on one CUDA card, case by case, for the
kernels of a given source tree: the multi-box kernel (K1, and K3
through it), the occupancy counts (K2) and the fused bucketed launch
(bool planes and counts in one launch).

    python3 benchmarks_torch/fitmask_bench.py [--src DIR] [--tree NAME]
                                              [--variants]

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
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tree", default="this")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fitmask_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels.fitmask import kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True,
                         check=True).stdout.strip())
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
        print(f"fitmask_bench,{args.tree},{name},{label},{box},{plan},{ms}",
              flush=True)

    def counts(label, occ):
        run("occupancy_counts", label, None, "default",
            lambda: kernel.occupancy_counts(occ),
            lambda: kernel.occupancy_counts_plain(occ))

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
