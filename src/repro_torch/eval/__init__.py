"""Parallel paper-scale evaluation subsystem.

The paper's headline numbers (Table 1 JCR, Fig 3 JCT percentiles,
Fig 4 utilization CDF) average 100 independent seeded simulator runs
per policy configuration — an embarrassingly parallel run x policy
matrix. This package fans that matrix out across a process pool with
per-run JSON checkpointing (an interrupted sweep resumes instead of
restarting) and aggregates the per-run records into the paper's
tables/figures with deltas against the paper-reported values.

Layout:
  runner.py     EvalTask, deterministic seed derivation, the process-
                pool runner and the checkpoint store.
  aggregate.py  per-label aggregation + Table 1 / Fig 3 / Fig 4
                builders with the paper-reported reference numbers.
"""
from .aggregate import (PAPER_FIG3_RATIOS, PAPER_FIG4_DELTAS,  # noqa: F401
                        PAPER_TABLE1, aggregate_by_label, fig3, fig4, table1)
from .runner import (EvalRunner, EvalTask, derive_seed,  # noqa: F401
                     make_tasks, prune_checkpoints, run_fleet_tasks,
                     run_task)

__all__ = [
    "EvalRunner", "EvalTask", "derive_seed", "make_tasks", "run_task",
    "run_fleet_tasks", "prune_checkpoints",
    "aggregate_by_label", "table1", "fig3", "fig4",
    "PAPER_TABLE1", "PAPER_FIG3_RATIOS", "PAPER_FIG4_DELTAS",
]
