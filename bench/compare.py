"""What the sweep cells compare: one row per job of a finished
simulator run, the same for the program's jobs and the reference's."""
from __future__ import annotations

import json
from typing import Any, List, Tuple


def schedule_rows(jobs) -> List[Tuple[Any, ...]]:
    """(id, arrival, start, finish, dropped, slowdown, placement,
    preemptions, migrations, killed) of each job, by id. Floats are
    compared exactly: both sides run the same host arithmetic."""
    return [(j.job_id, j.arrival, j.start, j.finish, bool(j.dropped),
             j.slowdown, json.dumps(j.placement_meta, sort_keys=True,
                                    default=str),
             j.preemptions, j.migrations, bool(j.killed))
            for j in sorted(jobs, key=lambda j: j.job_id)]


def schedule_json(jobs) -> str:
    """:func:`schedule_rows` as one JSON string (read back with
    ``json.loads``, each row a list)."""
    return json.dumps(schedule_rows(jobs))
