"""Two-level evaluation runner: process pool x in-process fleets,
with per-run JSON checkpointing.

A unit of work (:class:`EvalTask`) is one seeded simulator run of one
policy configuration. Tasks are independent, so the runner fans them
out across worker processes; every finished task is checkpointed as one
JSON file, keyed by a fingerprint of the task's full configuration, so
an interrupted sweep resumes from the completed subset instead of
restarting. Fingerprints and records are those of ``repro.eval`` for
the same task, byte for byte (``sim_s`` aside), so the two packages'
records can be compared.

Fleet mode is the default on a device engine: each worker runs its
slice of the matrix as a continuously-batched *fleet*
(``repro_torch.sim.fleet``) — the
simulators' fitmask/free-counts queries coalesce through a shared
query broker into batched engine calls (grids stacked on the multibox
``B`` axis; on the ``cuda`` engine one launch of the fused bucketed
kernel a flush), with rounds flushed on quorum or deadline so a fleet
never stalls on its slowest member. Chunks group tasks whose grids
share a cell shape so the broker gets to stack them. Records and
checkpoints are byte-identical to the per-task path (the per-task path
is the parity oracle, selected with ``fleet_size=0``, and the default
on the host ``numpy`` engine).

The engine: one :class:`~repro_torch.core.engineconfig.EngineConfig`
(engine, device and fleet fields) reaches every worker. Its default is
the registry's, ``cuda`` on the card: with no card and no engine asked
for, a run raises; it never carries on on the CPU. Workers are forked,
except where the engine runs on a CUDA device or CUDA is already
initialised in this process: a CUDA context does not survive ``fork``,
so those workers are spawned. An engine on the card runs inline
(``workers=0``) unless the caller asks for a pool: each spawned worker
makes its own CUDA context on the one card.

Checkpoint layout: files are bucketed into fingerprint-prefix
subdirectories (``<dir>/<fp[:2]>/<name>.json``, 256 shards); lookups
fall back to the un-sharded path, so a flat store keeps resuming.

Determinism contract: the per-run seed depends only on ``(seed0,
run_idx)`` — never on the worker count, the executor schedule, or which
checkpoints already exist — so pool runs, serial runs and resumed runs
all produce identical records.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def derive_seed(seed0: int, run_idx: int) -> int:
    """Seed for run ``run_idx`` of a sweep rooted at ``seed0``.

    A pure function of ``(seed0, run_idx)``: stable across worker
    counts and completion order, and shared by every policy in the
    matrix so policies are compared on *paired* traces (the paper
    averages each policy over the same 100 traces). Kept as the
    affine form the pre-subsystem sequential harness used, so
    historical CI-sized numbers remain reproducible.
    """
    return seed0 + run_idx


@dataclass
class EvalTask:
    """One seeded simulator run of one policy configuration."""

    label: str                 # display label, e.g. "RFold (4^3)"
    policy: str                # repro_torch.core.allocator.make_policy name
    policy_kw: Dict = field(default_factory=dict)
    run_idx: int = 0
    seed: int = 0
    num_jobs: int = 200
    load: float = 1.5
    trace_kw: Dict = field(default_factory=dict)   # extra TraceConfig fields
    sim_kw: Dict = field(default_factory=dict)     # extra Simulator kwargs
    # Named chaos scenario to run this task under. Kept so that
    # fingerprints stay equal to the reference's; the port has no chaos
    # layer yet, so run_task refuses a task that names one. None =
    # healthy.
    scenario: Optional[str] = None

    def fingerprint(self) -> str:
        """Hash of every field that affects the run's outcome. The
        display label is deliberately excluded: renaming a config, or
        evaluating one config under two labels (the ablation arms do),
        must neither invalidate nor duplicate checkpoints. A None
        scenario is dropped before hashing so every pre-scenario
        checkpoint store keeps resuming."""
        fields = asdict(self)
        fields.pop("label")
        if fields.get("scenario") is None:
            fields.pop("scenario", None)
        blob = json.dumps(fields, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def checkpoint_name(self) -> str:
        slug = re.sub(r"[^A-Za-z0-9]+", "_", self.label).strip("_").lower()
        return f"{slug}__r{self.run_idx}__{self.fingerprint()}.json"


SHARD_CHARS = 2   # 16^2 = 256 buckets; plenty below any fs dir limit

# <slug>__r<idx>__<16-hex-fingerprint>.json — what checkpoint_name()
# emits; prune only ever deletes files matching this.
CKPT_NAME_RE = re.compile(r"__r\d+__([0-9a-f]{16})\.json$")


def shard_dir(checkpoint_dir: str, fingerprint: str) -> str:
    """Fingerprint-prefix bucket for one checkpoint."""
    return os.path.join(checkpoint_dir, fingerprint[:SHARD_CHARS])


def iter_checkpoints(checkpoint_dir: str):
    """All checkpoint JSON paths in a store, sharded or legacy-flat."""
    for root, _dirs, files in os.walk(checkpoint_dir):
        for name in files:
            if name.endswith(".json"):
                yield os.path.join(root, name)


def record_crc(rec: Dict) -> int:
    """Content CRC of a checkpoint record (over canonical JSON, the
    ``_crc32`` field itself excluded) — file formatting and key order
    don't matter, payload bytes do."""
    body = {k: v for k, v in rec.items() if k != "_crc32"}
    return zlib.crc32(json.dumps(body, sort_keys=True,
                                 default=str).encode())


def verify_record(rec: Dict) -> bool:
    """True when the record's self-CRC matches (or when it predates
    CRC framing — legacy checkpoints keep loading)."""
    crc = rec.get("_crc32")
    if crc is None:
        return True
    try:
        return int(crc) == record_crc(rec)
    except (TypeError, ValueError):
        return False


def save_checkpoint(checkpoint_dir: str, task: "EvalTask",
                    rec: Dict) -> None:
    """Atomically + durably write one task's record into the (sharded)
    store: the record carries a self-CRC (loaders reject bit-rot
    instead of trusting it), the tmp file is fsynced before the rename
    (a crash can't publish a half-written file under the final name),
    and the rename is atomic (a checkpoint is whole or absent)."""
    path = os.path.join(shard_dir(checkpoint_dir, task.fingerprint()),
                        task.checkpoint_name())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({**rec, "_crc32": record_crc(rec)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def prune_checkpoints(checkpoint_dir: str, tasks: Sequence["EvalTask"],
                      max_bytes: Optional[int] = None) -> Dict:
    """Compact a checkpoint store so the actions/cache entry backing
    the scheduled full sweep stops growing unboundedly: drop every
    checkpoint whose fingerprint is absent from the current task set
    (stale configs, old seeds, bumped job counts), then optionally cap
    the survivors' total size, evicting oldest-mtime first. Works on
    sharded and legacy-flat stores alike (fingerprints are parsed
    from the file name, which both layouts share); files that don't
    look like checkpoints are never touched, and emptied shard
    directories are removed."""
    keep = {t.fingerprint() for t in tasks}
    stats = {"scanned": 0, "removed": 0, "kept": 0, "bytes_freed": 0}
    survivors = []
    for path in list(iter_checkpoints(checkpoint_dir)):
        m = CKPT_NAME_RE.search(os.path.basename(path))
        if m is None:
            continue   # not ours — leave foreign files alone
        stats["scanned"] += 1
        if m.group(1) in keep:
            survivors.append(path)
        else:
            stats["bytes_freed"] += os.path.getsize(path)
            os.remove(path)
            stats["removed"] += 1
    if max_bytes is not None:
        survivors.sort(key=os.path.getmtime, reverse=True)  # newest first
        total = 0
        evicting = False
        for path in survivors:
            size = os.path.getsize(path)
            # Strictly oldest-first: once the cumulative (newest-first)
            # budget is exceeded, everything older goes too — never
            # keep an older file in place of an evicted newer one.
            evicting = evicting or total + size > max_bytes
            if evicting:
                os.remove(path)
                stats["removed"] += 1
                stats["bytes_freed"] += size
            else:
                total += size
    stats["kept"] = stats["scanned"] - stats["removed"]
    for name in os.listdir(checkpoint_dir):
        sub = os.path.join(checkpoint_dir, name)
        if os.path.isdir(sub) and not os.listdir(sub):
            os.rmdir(sub)
    return stats


def make_tasks(configs: Sequence[Tuple[str, str, dict]], runs: int,
               num_jobs: int, load: float, seed0: int,
               trace_kw: Optional[dict] = None,
               sim_kw: Optional[dict] = None,
               scenario: Optional[str] = None) -> List[EvalTask]:
    """Expand ``(label, policy, policy_kw)`` configs into the run
    matrix, with paired per-run seeds across configs. ``scenario``
    runs every cell under a named chaos scenario (degraded-fabric
    paper eval); ``None`` is the healthy paper baseline."""
    return [
        EvalTask(label=label, policy=policy, policy_kw=dict(kw),
                 run_idx=r, seed=derive_seed(seed0, r),
                 num_jobs=num_jobs, load=load,
                 trace_kw=dict(trace_kw or {}), sim_kw=dict(sim_kw or {}),
                 scenario=scenario)
        for label, policy, kw in configs for r in range(runs)
    ]


def run_task(task: EvalTask, mask_client=None, engine=None) -> Dict:
    """Execute one task (worker-side) and return its record.

    ``mask_client`` routes the policy's fitmask/free-counts queries
    through a request/response client (the fleet path installs its
    query broker here); ``None`` keeps the inline engine path. ``engine``
    (an engine name or :class:`~repro_torch.core.engineconfig.EngineConfig`,
    default the registry's, ``cuda``) is the policy's own engine, unless
    ``policy_kw`` names one: the inline path's, and the one its empty
    clones use. Either way the record is byte-identical apart from
    ``sim_s``.

    A task with a ``scenario`` raises ``NotImplementedError``: it needs
    the chaos layer (fault streams and scenarios), which the port does
    not have yet, and is never run without its faults.
    """
    from repro_torch.core.allocator import make_policy
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.metrics import summarize, utilization_cdf
    from repro_torch.sim.simulator import Simulator
    from repro_torch.traces.generator import TraceConfig, generate_trace

    if task.scenario is not None:
        raise NotImplementedError(
            f"task {task.label!r} runs under scenario {task.scenario!r}; "
            "scenarios need the chaos layer (sim/faults.py and "
            "sim/scenarios.py), which repro_torch does not have yet")
    cfg = TraceConfig(num_jobs=task.num_jobs, seed=task.seed,
                      target_load=task.load, **task.trace_kw)
    jobs = generate_trace(cfg)
    policy_kw = dict(task.policy_kw)
    if "engine" not in policy_kw and "fitmask_engine" not in policy_kw:
        policy_kw["engine"] = EngineConfig.coerce(engine)
    policy = make_policy(task.policy, mask_client=mask_client, **policy_kw)
    t0 = time.perf_counter()
    res = Simulator(policy, jobs, **task.sim_kw).run()
    wall = time.perf_counter() - t0
    levels, cdf = utilization_cdf(res)
    return {
        "fingerprint": task.fingerprint(),
        "label": task.label,
        "run_idx": task.run_idx,
        "seed": task.seed,
        "summary": summarize(res),
        "cdf_levels": [float(x) for x in levels],
        "cdf": [float(x) for x in cdf],
        "sim_s": round(wall, 4),
    }


# -- fleet path --------------------------------------------------------

def task_grid_bucket(task: EvalTask) -> Tuple:
    """Cell shape of the occupancy grids this task's mask queries
    carry. The query broker can only stack same-shape grids on the
    multibox B axis, so fleet chunks group tasks by this key
    (mirrors the ``make_policy`` defaults)."""
    kw = task.policy_kw
    if task.policy in ("firstfit", "folding"):
        return ("static", tuple(int(d) for d in kw.get("dims",
                                                       (16, 16, 16))))
    return ("cube", int(kw.get("cube_n", 4)))


def make_fleet_chunks(tasks: Sequence[EvalTask], pending: Sequence[int],
                      fleet_size: int) -> List[List[int]]:
    """Group pending task indices into fleets of at most
    ``fleet_size``, never mixing grid buckets within one fleet (a
    mixed fleet is *correct* — the broker buckets again at flush time
    — it just coalesces worse). Stable within a bucket, so the
    configs x runs task order keeps same-config runs together."""
    by_bucket: Dict[Tuple, List[int]] = {}
    for i in pending:
        by_bucket.setdefault(task_grid_bucket(tasks[i]), []).append(i)
    chunks = []
    for _, idxs in sorted(by_bucket.items()):
        chunks.extend(idxs[o:o + fleet_size]
                      for o in range(0, len(idxs), fleet_size))
    return chunks


def run_fleet_tasks(tasks: Sequence[EvalTask],
                    checkpoint_dir: Optional[str] = None,
                    engine=None, quorum="auto",
                    timeout="auto") -> Tuple[List[Dict], Dict]:
    """Worker-side: run a chunk of tasks as one continuously-batched
    fleet sharing a query broker (``repro_torch.sim.fleet``). Each
    simulator checkpoints itself the moment it finishes, so per-run
    resume granularity survives a worker dying mid-fleet. Returns the
    records (task order) and the broker's coalescing stats.

    ``engine`` selects the broker's engine: a registry name, an
    :class:`~repro_torch.core.engineconfig.EngineConfig` (its device
    and flush fields are used), an engine instance, or ``None`` for the
    registry default (``cuda``). The policies get the same engine for
    their empty clones. The broker is the fleet's single engine: a
    per-task ``fitmask_engine`` in ``policy_kw`` is overridden on this
    path (answers are bit-identical across engines, so records don't
    change — only where the masks get computed).

    ``quorum``/``timeout`` tune the broker's flush policy (``"auto"``:
    the config's, else engine-aware; see
    :class:`repro_torch.sim.fleet.Fleet`) — schedules are invariant to
    them by the broker's parity contract, only wall-time moves.
    """
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.fleet import Fleet

    fleet = Fleet(engine, quorum=quorum, timeout=timeout)
    broker = fleet.broker
    policy_engine = EngineConfig(broker.engine_name
                                 or getattr(broker.engine, "name", None),
                                 device=broker.device)

    def unit(task: EvalTask):
        def go(broker):
            rec = run_task(task, mask_client=broker, engine=policy_engine)
            if checkpoint_dir:
                save_checkpoint(checkpoint_dir, task, rec)
            return rec
        return go

    records = fleet.run([unit(t) for t in tasks])
    return records, broker.stats.as_dict()


class EvalRunner:
    """Fan tasks across a process pool, checkpointing each result.

    ``workers=None`` uses ``os.cpu_count()`` for an engine on the host
    or the CPU and 0 for one on the card; ``workers <= 1`` runs inline
    (no pool) — useful for tests and debugging. With
    ``checkpoint_dir`` set, completed tasks are skipped on re-run when
    their stored fingerprint matches the requested configuration;
    mismatching or unreadable checkpoints are ignored and re-executed.

    ``engine`` is one :class:`~repro_torch.core.engineconfig.EngineConfig`
    (or an engine name) for backend, device and fleet drive, handed as
    it is to every worker and to the per-task path. The default engine
    is the registry's (``cuda``, on the card).

    Its ``fleet_size`` controls the second pool level: pending tasks
    are chunked into in-process fleets of at most that many simulators,
    and each chunk's mask queries ride one shared query broker as
    continuously-batched engine calls. ``None``/``0``/``1`` selects the
    per-task oracle path; records are byte-identical either way. The
    default ``"auto"`` runs fleets on a device engine (``cuda``,
    ``torch``), sized from the pending count and worker width, and the
    per-task path on the host ``numpy`` engine. That split is not a
    measured optimum: on the card the ``cuda`` fleet has so far been
    slower than ``cuda`` per task (``PERF.md`` §5), and the default is
    an open item of ``ROADMAP.md``.
    """

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 workers: Optional[int] = None, emit=None, engine=None):
        from repro_torch.core.engineconfig import EngineConfig
        self.checkpoint_dir = checkpoint_dir
        self.engine_config = EngineConfig.coerce(engine)
        self.fleet_size = self.engine_config.fleet_size
        if workers is None:
            workers = 0 if self._on_card() else os.cpu_count()
        self.workers = workers
        self.emit = emit or (lambda *a: None)
        self.last_stats: Dict = {}

    def _host_engine(self) -> bool:
        from repro_torch.kernels.fitmask import ops
        name = self.engine_config.resolve_name()
        return bool(getattr(ops._REGISTRY[name], "host_free", False))

    def _on_card(self) -> bool:
        """True when the engine computes on a CUDA device."""
        import torch
        device = self.engine_config.device
        return not self._host_engine() and torch.device(
            "cuda" if device is None else device).type == "cuda"

    def start_method(self) -> str:
        """How pool workers start: ``spawn`` where the engine runs on a
        CUDA device or CUDA is initialised in this process (a CUDA
        context does not survive ``fork``), else ``fork`` (which keeps
        ``sys.path`` without a fresh import), where the platform has it."""
        import multiprocessing as mp

        import torch
        if (self._on_card() or torch.cuda.is_initialized()
                or "fork" not in mp.get_all_start_methods()):
            return "spawn"
        return "fork"

    def _pool(self) -> ProcessPoolExecutor:
        import multiprocessing as mp
        return ProcessPoolExecutor(
            max_workers=self.workers,
            mp_context=mp.get_context(self.start_method()))

    # -- checkpoint store ---------------------------------------------
    def _ckpt_path(self, task: EvalTask) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        return os.path.join(shard_dir(self.checkpoint_dir,
                                      task.fingerprint()),
                            task.checkpoint_name())

    def _load_checkpoint(self, task: EvalTask) -> Optional[Dict]:
        if not self.checkpoint_dir:
            return None
        fp = task.fingerprint()
        shard = shard_dir(self.checkpoint_dir, fp)
        # Sharded location first, then the legacy flat layout (stores
        # written before sharding keep resuming).
        path = next((p for p in (
            os.path.join(shard, task.checkpoint_name()),
            os.path.join(self.checkpoint_dir, task.checkpoint_name()))
            if os.path.exists(p)), None)
        if path is None:
            # Same config may have been checkpointed under another
            # label (fingerprints are label-independent).
            pattern = f"*__r{task.run_idx}__{fp}.json"
            hits = (glob.glob(os.path.join(shard, pattern))
                    or glob.glob(os.path.join(self.checkpoint_dir,
                                              pattern)))
            path = hits[0] if hits else None
            if path is None:
                return None
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        if not verify_record(rec):
            return None   # bit-rot: ignored and re-executed
        rec.pop("_crc32", None)
        if rec.get("fingerprint") != task.fingerprint():
            return None
        rec["label"] = task.label   # restamp: label is display-only
        return rec

    def _save_checkpoint(self, task: EvalTask, rec: Dict) -> None:
        if self.checkpoint_dir:
            save_checkpoint(self.checkpoint_dir, task, rec)

    # -- execution -----------------------------------------------------
    def _resolve_fleet_size(self, n_pending: int) -> Optional[int]:
        fs = self.fleet_size
        if fs in (None, 0, 1):
            return None
        if fs == "auto":
            if self._host_engine():
                return None   # the host engine answers inline
            # Several chunks per worker (rebalancing headroom for the
            # wildly different per-policy sim costs), batching benefit
            # saturating around 8 simulators per broker round (the
            # reference's sizing, kept as it is).
            workers = max(1, self.workers or 1)
            return max(2, min(8, -(-n_pending // (4 * workers))))
        return int(fs)

    def run(self, tasks: Sequence[EvalTask]) -> List[Dict]:
        """Run the matrix; returns records ordered like ``tasks``."""
        t0 = time.perf_counter()
        records: List[Optional[Dict]] = [None] * len(tasks)
        pending: List[int] = []
        for i, task in enumerate(tasks):
            rec = self._load_checkpoint(task)
            if rec is not None:
                records[i] = rec
            else:
                pending.append(i)
        reused = len(tasks) - len(pending)
        if reused:
            self.emit(f"# resume: {reused}/{len(tasks)} tasks "
                      "from checkpoints")

        fleet_size = self._resolve_fleet_size(len(pending))
        if pending and fleet_size:
            self._run_fleets(tasks, pending, records, fleet_size)
        elif pending:
            if self.workers and self.workers > 1:
                self._run_pool(tasks, pending, records)
            else:
                for i in pending:
                    records[i] = run_task(tasks[i],
                                          engine=self.engine_config)
                    self._save_checkpoint(tasks[i], records[i])

        self.last_stats = {
            "tasks": len(tasks),
            "reused_from_checkpoint": reused,
            "executed": len(pending),
            "workers": self.workers,
            "wall_s": round(time.perf_counter() - t0, 3),
            "sim_s_total": round(sum(r["sim_s"] for r in records
                                     if r is not None), 3),
        }
        if pending and fleet_size:
            self.last_stats["fleet"] = self._fleet_stats
        return [r for r in records if r is not None]

    def _run_fleets(self, tasks: Sequence[EvalTask], pending: List[int],
                    records: List[Optional[Dict]],
                    fleet_size: int) -> None:
        """Two-level pool: fan task chunks across worker processes,
        each chunk running as one cooperatively-batched fleet.
        Checkpoints are written worker-side as each simulator
        finishes, so resume granularity stays per-run."""
        chunks = make_fleet_chunks(tasks, pending, fleet_size)
        broker_totals: List[Dict] = []

        def account(chunk: List[int], result) -> None:
            recs, stats = result
            for i, rec in zip(chunk, recs):
                records[i] = rec
            broker_totals.append(stats)
            self.emit(f"# eval fleet {len(broker_totals)}/{len(chunks)}: "
                      f"{len(chunk)} sims "
                      f"({sum(r['sim_s'] for r in recs):.1f}s sim, "
                      f"B~{stats['mean_grids_per_call']})")

        if self.workers and self.workers > 1 and len(chunks) > 1:
            with self._pool() as pool:
                futs = {pool.submit(run_fleet_tasks,
                                    [tasks[i] for i in chunk],
                                    self.checkpoint_dir,
                                    self.engine_config): chunk
                        for chunk in chunks}
                remaining = set(futs)
                while remaining:
                    finished, remaining = wait(remaining,
                                               return_when=FIRST_COMPLETED)
                    for fut in finished:
                        account(futs[fut], fut.result())
        else:
            for chunk in chunks:
                account(chunk, run_fleet_tasks(
                    [tasks[i] for i in chunk], self.checkpoint_dir,
                    self.engine_config))

        count_keys = ("requests", "flushes", "engine_calls",
                      "batched_calls", "grids", "flush_all_parked",
                      "flush_quorum", "flush_timeout", "requeued",
                      "fc_inline", "fc_cache_hits", "fc_cache_misses",
                      "steppers_reaped", "engine_retries",
                      "engine_failovers", "canary_checks",
                      "canary_mismatches", "park_s", "engine_s")
        agg = {k: sum(s.get(k, 0) for s in broker_totals)
               for k in count_keys}
        agg["max_grids"] = max((s["max_grids"] for s in broker_totals),
                               default=0)
        agg["max_coalesced"] = max((s["max_coalesced"]
                                    for s in broker_totals), default=0)
        agg["mean_grids_per_call"] = (
            round(agg["grids"] / agg["engine_calls"], 2)
            if agg["engine_calls"] else None)
        self._fleet_stats = {"size": fleet_size, "fleets": len(chunks),
                             "broker": agg}

    def _run_pool(self, tasks: Sequence[EvalTask], pending: List[int],
                  records: List[Optional[Dict]]) -> None:
        done = 0
        with self._pool() as pool:
            futs = {pool.submit(run_task, tasks[i], None,
                                self.engine_config): i for i in pending}
            remaining = set(futs)
            while remaining:
                finished, remaining = wait(remaining,
                                           return_when=FIRST_COMPLETED)
                for fut in finished:
                    i = futs[fut]
                    records[i] = fut.result()
                    self._save_checkpoint(tasks[i], records[i])
                    done += 1
                    self.emit(f"# eval {done}/{len(pending)}: "
                              f"{tasks[i].label} run {tasks[i].run_idx} "
                              f"({records[i]['sim_s']:.1f}s)")
