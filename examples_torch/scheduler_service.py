#!/usr/bin/env python3
"""Allocator-as-a-service demo on the port: a live scheduling daemon,
streaming submissions, and pushed SETUP/RECONFIG/RELEASE topology
events.

    python3 examples_torch/scheduler_service.py                  # the card
    python3 examples_torch/scheduler_service.py --engine numpy   # the host
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
    from repro_torch.api import (EngineConfig, Scheduler, TraceConfig,
                                 generate_trace)

    trace = generate_trace(TraceConfig(num_jobs=12, seed=7,
                                       cluster_xpus=512, size_max=512))
    with Scheduler(policy="rfold",
                   policy_kw=dict(num_xpus=512, cube_n=4),
                   engine=EngineConfig(args.engine, device=args.device),
                   max_queue=4) as sched:
        print("daemon listening on %s:%d" % tuple(sched.address))
        running = []
        for job in trace:
            r = sched.submit(job.shape, job_id=job.job_id)
            print(f"submit job {job.job_id} {'x'.join(map(str, job.shape.dims))}"
                  f" -> {r['outcome']}")
            if r["outcome"] == "placed":
                running.append(job.job_id)
            elif r["outcome"] == "rejected" and running:
                # Overloaded: retire the oldest running job, retry once.
                done = sched.done(running.pop(0))
                for st in done["started"]:
                    print(f"  queue drained: job {st['job_id']} "
                          f"-> {st['outcome']}")
                r = sched.submit(job.shape, job_id=job.job_id)
                print(f"  resubmit -> {r['outcome']}")
                if r["outcome"] == "placed":
                    running.append(job.job_id)
        for ev in sched.events(max_wait=0.2):
            detail = ev.get("detail", {})
            extra = (f" ocs_links={detail['ocs_links']}"
                     if "ocs_links" in detail else "")
            print(f"event {ev['event']:8s} job {ev['job_id']}{extra}")
        st = sched.status()
        print(f"final: {st['allocated']} allocated, "
              f"{st['queue_depth']} queued, util={st['utilization']:.2f}")


if __name__ == "__main__":
    main()
