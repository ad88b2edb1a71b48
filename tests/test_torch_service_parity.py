"""The port's allocator service against the reference's, op for op.

One seeded op stream per (policy, scenario) — the trace's submits, a
``done`` after every 3rd submit, the scenario's fault/repair schedule,
preempt and migrate ops, ``can_ever_place`` probes, a resent
request_id, a promotion and a lease expiry, from two clients — is
applied to the reference's ``AllocatorCore`` (``repro``, ``numpy``) and
to the port's on ``numpy`` and on ``torch`` and ``cuda`` with CPU
tensors. After every op the encoded reply and events must be the same
bytes and ``state_digest()`` the same; at the end the journal records,
the WAL's bytes and the digests after recovery must be equal too. A
port daemon on ``cuda`` over TCP encodes every reply of the stream (a
torch value in an answer would fail there) and pushes the reference's
events; and each package recovers the other's checkpoint store.
"""
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from repro.core.allocator import make_policy as ref_make_policy
from repro.serve.scheduler import protocol as ref_protocol
from repro.serve.scheduler.core import AllocatorCore as RefAllocatorCore
from repro.serve.scheduler.core import SchedulerConfig as RefSchedulerConfig
from repro.sim.scenarios import SCENARIOS as REF_SCENARIOS
from repro.sim.scenarios import fault_schedule as ref_fault_schedule
from repro.traces.generator import TraceConfig as RefTraceConfig
from repro.traces.generator import generate_trace as ref_generate_trace
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.serve.scheduler import (AllocatorCore, Scheduler,
                                         SchedulerClient, SchedulerConfig,
                                         protocol)
from repro_torch.serve.scheduler.journal import recover_journal

torch.set_num_threads(1)

MEDIUM = dict(num_xpus=512, cube_n=4)
STATIC = dict(dims=(8, 8, 8))
ENGINES = {
    "numpy": EngineConfig("numpy"),
    "torch-on-cpu": EngineConfig("torch", device="cpu"),
    "cuda-on-cpu": EngineConfig("cuda", device="cpu"),
}
engines = pytest.mark.parametrize("engine", sorted(ENGINES))
STREAMS = {
    "rfold-node_churn": ("rfold", MEDIUM, "node_churn"),
    "reconfig-ocs_degraded": ("reconfig", MEDIUM, "ocs_degraded"),
    "rfold_be-multi_tenant": ("rfold_be", MEDIUM, "multi_tenant"),
    "firstfit-node_churn": ("firstfit", STATIC, "node_churn"),
    "folding-ocs_degraded": ("folding", STATIC, "ocs_degraded"),
}
streams = pytest.mark.parametrize("stream", sorted(STREAMS))
NUM_JOBS, SEED = 60, 11


def op_stream(policy, kw, scenario, num_jobs=NUM_JOBS, seed=SEED):
    """The stream, built with the reference's trace and fault schedule
    (the oracle's), with ``request_id``/``client`` on every op."""
    sc = REF_SCENARIOS[scenario]
    # Jobs of at most 128 XPUs on 512: most fit, and the cluster fills.
    jobs = ref_generate_trace(RefTraceConfig(
        num_jobs=num_jobs, seed=seed, cluster_xpus=512, size_max=128,
        size_scale=48.0, **sc.trace_kw))
    pol = ref_make_policy(policy, engine="numpy", **kw)
    model = getattr(pol, "torus", None) or pol.cluster
    faults = ref_fault_schedule(sc, model, jobs, seed)
    rng = random.Random(seed)
    timeline = []
    submitted = []
    for n, job in enumerate(jobs, start=1):
        t = job.arrival
        timeline.append((t, {"op": "submit", "job_id": job.job_id,
                             "shape": list(job.shape.dims)}))
        submitted.append(job.job_id)
        if n % 3 == 0:
            timeline.append((t, {"op": "done",
                                 "job_id": submitted[n // 3 - 1]}))
        if n % 5 == 0:
            timeline.append((t, {"op": "preempt",
                                 "job_id": rng.choice(submitted[-6:])}))
        if n % 4 == 0:
            timeline.append((t, {"op": "migrate",
                                 "job_id": rng.choice(submitted[-6:])}))
        if n % 11 == 0:
            timeline.append((t, {"op": "can_ever_place",
                                 "shape": list(job.shape.dims)}))
    for ev in faults:
        timeline.append((ev.time, {
            "op": ev.action, "kind": ev.kind,
            "targets": [list(t) if isinstance(t, tuple) else t
                        for t in ev.targets]}))
    timeline.sort(key=lambda e: e[0])   # stable: draw order breaks ties
    ops = []
    for i, (_, msg) in enumerate(timeline):
        cid = f"c{i % 2}"
        ops.append(dict(msg, client=cid, request_id=f"{cid}:{i}"))
        if i == len(timeline) // 2:
            ops.append({"op": "promote"})
        if i % 17 == 16:
            ops.append(dict(ops[-3]))    # a resend: dedup or stateless
    ops.append({"op": "lease_expire", "client": "c1", "action": "release"})
    ops.append({"op": "status"})
    return ops


def records(journal):
    """Journal records as canonical JSON: a live core holds fault
    targets as tuples, a recovered one as lists."""
    return json.dumps(journal, sort_keys=True)


def encoded(reply, events, proto):
    return proto.encode(reply), [proto.encode(e) for e in events]


def cores(stream, engine, ref_dir=None, port_dir=None):
    policy, kw, _ = STREAMS[stream]
    ref = RefAllocatorCore(RefSchedulerConfig(
        policy=policy, policy_kw=dict(kw), engine="numpy",
        checkpoint_dir=ref_dir, checkpoint_every=0, fsync=False))
    port = AllocatorCore(SchedulerConfig(
        policy=policy, policy_kw=dict(kw), engine=ENGINES[engine],
        checkpoint_dir=port_dir, checkpoint_every=0, fsync=False))
    return ref, port


@streams
@engines
def test_every_reply_event_and_digest_equal(stream, engine, tmp_path):
    ops = op_stream(*STREAMS[stream])
    ref, port = cores(stream, engine, str(tmp_path / "ref"),
                      str(tmp_path / "port"))
    outcomes = set()
    for i, op in enumerate(ops):
        want = encoded(*ref.apply(dict(op)), ref_protocol)
        got = encoded(*port.apply(dict(op)), protocol)
        assert got == want, f"op {i}: {op}"
        assert port.state_digest() == ref.state_digest(), f"op {i}: {op}"
        reply = json.loads(want[0])
        outcomes.add(reply.get("outcome"))
        outcomes.update(v["outcome"] for v in reply.get("victims", []))
    # The stream reached every branch it was built for.
    assert {"placed", "queued", "preempted", "migrated"} <= outcomes
    assert ref.counters["dedup_hits"] > 0 and ref.epoch == 2
    assert port.counters == ref.counters
    assert records(port.journal) == records(ref.journal)
    assert port.next_id == ref.next_id
    # The WAL holds the same bytes (its name carries the fingerprint).
    with open(port._wal_path(), "rb") as f, open(ref._wal_path(), "rb") as g:
        assert f.read() == g.read()
    assert recover_journal(port._wal_path())[0] == \
        recover_journal(ref._wal_path())[0]


@streams
@engines
def test_recovered_port_core_digests_like_the_reference(stream, engine,
                                                        tmp_path):
    """Snapshots every 7 ops plus the WAL tail: the port recovers its
    own store to the reference's live state, replies and dedup cache
    included."""
    policy, kw, _ = STREAMS[stream]
    ops = op_stream(*STREAMS[stream])
    kill = len(ops) * 2 // 3
    ref = RefAllocatorCore(RefSchedulerConfig(
        policy=policy, policy_kw=dict(kw), engine="numpy"))
    cfg = SchedulerConfig(policy=policy, policy_kw=dict(kw),
                          engine=ENGINES[engine],
                          checkpoint_dir=str(tmp_path), checkpoint_every=7,
                          fsync=False)
    port = AllocatorCore(cfg)
    for op in ops[:kill]:
        ref.apply(dict(op))
        port.apply(dict(op))
    back = AllocatorCore.recover(cfg)     # the crash: no final snapshot
    assert back.state_digest() == ref.state_digest()
    assert records(back.journal) == records(ref.journal)
    assert back.epoch == ref.epoch
    assert back.recovered_ops == len(ref.journal)
    assert back.counters["wal_tail_ops"] > 0
    for i, op in enumerate(ops[kill:], start=kill):
        want = encoded(*ref.apply(dict(op)), ref_protocol)
        got = encoded(*back.apply(dict(op)), protocol)
        # A resent op answered from the cache pushes no events in either;
        # status differs in the recovery counters only.
        if op["op"] != "status":
            assert got[0] == want[0], f"op {i}: {op}"
        assert back.state_digest() == ref.state_digest()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_recovers_the_others_store(writer, tmp_path):
    """On ``numpy`` the fingerprints, checkpoint names and file formats
    are equal, so one package's snapshot + WAL is the other's."""
    ops = op_stream(*STREAMS["rfold-node_churn"])
    common = dict(policy="rfold", policy_kw=dict(MEDIUM), engine="numpy",
                  checkpoint_dir=str(tmp_path), checkpoint_every=7,
                  fsync=False)
    ref_cfg, port_cfg = RefSchedulerConfig(**common), SchedulerConfig(**common)
    assert port_cfg.fingerprint() == ref_cfg.fingerprint()
    assert port_cfg.checkpoint_name() == ref_cfg.checkpoint_name()
    first = (RefAllocatorCore(ref_cfg) if writer == "reference"
             else AllocatorCore(port_cfg))
    for op in ops[:len(ops) // 2]:
        first.apply(dict(op))
    other = (AllocatorCore.recover(port_cfg) if writer == "reference"
             else RefAllocatorCore.recover(ref_cfg))
    assert other.state_digest() == first.state_digest()
    assert records(other.journal) == records(first.journal)


@pytest.mark.parametrize("policy,kw", [("rfold", MEDIUM),
                                       ("firstfit", STATIC)])
def test_fingerprint_equals_the_reference_on_numpy(policy, kw):
    common = dict(policy=policy, policy_kw=dict(kw), backfill=True,
                  max_queue=9, engine="numpy")
    port = SchedulerConfig(**common)
    ref = RefSchedulerConfig(**common)
    assert port.fingerprint() == ref.fingerprint()
    assert port.checkpoint_name() == ref.checkpoint_name()
    for device in ("cpu", torch.device("cpu"), "cuda", "cuda:0"):
        moved = SchedulerConfig(**dict(
            common, engine=EngineConfig("numpy", device=device)))
        assert moved.fingerprint() == ref.fingerprint()


def test_cuda_daemon_encodes_every_reply_over_tcp():
    """The stream over TCP against a port daemon on ``cuda`` (CPU
    tensors): every reply leaves the event loop encoded and equals the
    reference core's (less the daemon's own ``seq``/``epoch`` and the
    status reply's daemon counters), and the subscriber receives the
    reference's events in order."""
    ops = op_stream(*STREAMS["rfold-node_churn"])
    ref = RefAllocatorCore(RefSchedulerConfig(
        policy="rfold", policy_kw=dict(MEDIUM), engine="numpy"))
    want_events = []
    with Scheduler(SchedulerConfig(policy="rfold", policy_kw=dict(MEDIUM),
                                   engine=ENGINES["cuda-on-cpu"])) as s:
        raw = SchedulerClient(s.address, max_retries=0)
        for i, op in enumerate(ops):
            reply, events = ref.apply(dict(op))
            want_events += [json.loads(ref_protocol.encode(e))
                            for e in events]
            raw._sock.sendall(protocol.encode(dict(op, seq=i)))
            got = raw._await_reply(i, 30.0)
            assert got.pop("seq") == i
            want = json.loads(ref_protocol.encode(reply))
            if op["op"] == "status":
                assert got["state_digest"] == want["state_digest"]
                continue
            epoch = got.pop("epoch")
            assert epoch == ref.epoch
            if op["op"] == "promote":   # the daemon's reply names the role
                assert got.pop("role") == "primary"
                got["epoch"] = epoch
            assert got == want, f"op {i}: {op}"
        raw.close()
        got_events = []
        for _ in range(100):
            got_events += s.events(max_wait=0.05)
            if len(got_events) >= len(want_events):
                break
        assert got_events == want_events
        assert s.status()["state_digest"] == ref.state_digest()


def test_protocol_flattens_numpy_and_refuses_torch():
    import numpy as np

    msg = {"a": np.int64(3), "b": np.float32(0.5), "c": np.arange(2)}
    assert protocol.encode(msg) == ref_protocol.encode(msg)
    with pytest.raises(TypeError, match="not JSON-serializable"):
        protocol.encode({"x": torch.tensor(1)})
    assert protocol.detuple([1, [2, 3], {"k": [4]}]) == (1, (2, 3),
                                                         {"k": (4,)})


def test_port_scheduler_modules_import_nothing_of_repro():
    """The service modules name the port's own layers only."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch")
    for name in ("protocol", "journal", "core", "daemon", "client",
                 "service", "__init__"):
        src = open(os.path.join(root, "serve", "scheduler",
                                name + ".py")).read()
        assert "from repro." not in src and "import repro\n" not in src
        assert "jax" not in src
    api = open(os.path.join(root, "api.py")).read()
    assert "from repro." not in api and "jax" not in api


@pytest.mark.parametrize("example", ["rfold_scheduling",
                                     "scheduler_service"])
def test_examples_print_the_references_output(example):
    """Each ``examples_torch`` script on ``--engine numpy`` prints what
    its namesake in ``examples/`` prints (but the daemon's port)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))

    def run(*argv):
        out = subprocess.run([sys.executable, *argv], cwd=root, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return [line for line in out.stdout.splitlines()
                if not line.startswith("daemon listening on")]

    port = run(os.path.join("examples_torch", example + ".py"),
               "--engine", "numpy")
    assert port and port == run(os.path.join("examples", example + ".py"))
