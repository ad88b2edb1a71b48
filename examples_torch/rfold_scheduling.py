#!/usr/bin/env python3
"""The paper's core demo on the port: RFold vs baselines on a generated
trace, plus one folded placement inspected end to end.

    python3 examples_torch/rfold_scheduling.py                  # the card
    python3 examples_torch/rfold_scheduling.py --engine numpy   # the host
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default=None,
                    help="fitmask engine (default: cuda, on the card)")
    ap.add_argument("--device", default=None,
                    help="torch device of a tensor engine (default: the "
                         "card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import (EngineConfig, JobShape, Simulator,
                                 TraceConfig, generate_trace, make_policy,
                                 summarize)

    engine = EngineConfig(args.engine, device=args.device)

    # 1. One job, inspected: the paper's 18x1x1 example.
    rf = make_policy("rfold", num_xpus=4096, cube_n=4, engine=engine)
    p = rf.try_place(0, JobShape((18, 1, 1)))
    print("18x1x1 placed as:", p.meta["fold"],
          "| cubes:", p.meta["num_cubes"],
          "| OCS links:", p.meta["ocs_links"],
          "| rings intact:", not p.broken_rings)
    rf.release(0)

    # 2. The paper's impossible-in-static shape.
    ff = make_policy("firstfit", dims=(16, 16, 16), engine=engine)
    print("4x4x32 on static 16^3:",
          "placeable" if ff.can_ever_place(JobShape((4, 4, 32)))
          else "never placeable (paper, Sec 3.2)")
    p2 = rf.try_place(1, JobShape((4, 4, 32)))
    print("4x4x32 on RFold(4^3): cubes =", p2.meta["num_cubes"],
          "wrap =", p2.meta["wrap"])
    rf.release(1)

    # 3. Mini trace comparison (Table-1-style).
    cfg = TraceConfig(num_jobs=120, seed=0, target_load=1.5)
    for name, kw in [("firstfit", dict(dims=(16, 16, 16))),
                     ("folding", dict(dims=(16, 16, 16))),
                     ("reconfig", dict(num_xpus=4096, cube_n=4)),
                     ("rfold", dict(num_xpus=4096, cube_n=4))]:
        pol = make_policy(name, engine=engine, **kw)
        s = summarize(Simulator(pol, generate_trace(cfg)).run())
        print(f"{name:9s} JCR={s['jcr']:.2f} "
              f"JCT(p50)={s['jct_p50']:8.0f}s util={s['util_mean']:.2f}")


if __name__ == "__main__":
    main()
