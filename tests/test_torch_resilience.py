"""Port tests of the service's resilience, mirroring the service half of
``tests/test_resilience.py``: WAL framing and torn-tail truncation,
checkpoint-shard corruption, idempotent retries across daemon crashes,
lease expiry dispositions, client reconnection, SIGKILL crash-loop
recovery — and the replicated scheduler: standby WAL tailing,
epoch-fenced promotion, NOT_LEADER redirects, stale-reply rejection,
sync/async ack modes, heartbeat jitter. (The fleet half — the broker's
watchdog and engine failover — is in ``tests/test_torch_fleet.py``.)

Each test does what its namesake does, on ``repro_torch``; daemons place
on the ``cuda`` engine's plain version on CPU tensors, and the SIGKILL
test's subprocess daemon on every engine. The WAL tests also hold the
port's framing byte for byte to the reference's.
"""
import os
import random
import signal
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

import repro_torch
from repro.serve.scheduler import journal as ref_journal
from repro_torch.api import (EngineConfig, Scheduler, SchedulerClient,
                             SchedulerConfig)
from repro_torch.eval.runner import record_crc, shard_dir, verify_record
from repro_torch.serve.scheduler import PLACED, jittered_interval, protocol
from repro_torch.serve.scheduler.journal import (MAGIC, JournalWriter,
                                                 decode_frames,
                                                 encode_frames,
                                                 frame_record,
                                                 recover_journal)

torch.set_num_threads(1)

SMALL = dict(num_xpus=64, cube_n=4)      # one 4^3 cube: trivially full
MEDIUM = dict(num_xpus=512, cube_n=4)    # 8 cubes
CUDA = EngineConfig("cuda", device="cpu")


def config(policy_kw=MEDIUM, **kw):
    return SchedulerConfig(policy="rfold", policy_kw=policy_kw,
                           engine=CUDA, **kw)


# ------------------------------------------------------------ WAL unit
def _write_wal(path, records):
    w = JournalWriter(path, fsync=False)
    for rec in records:
        w.append(rec)
    w.close()


def test_wal_roundtrip(tmp_path):
    path = str(tmp_path / "a.wal")
    recs = [{"op": "submit", "i": i} for i in range(5)]
    _write_wal(path, recs)
    got, truncated = recover_journal(path)
    assert got == recs and not truncated
    # The reference's writer frames the same records byte for byte.
    ref = str(tmp_path / "ref.wal")
    w = ref_journal.JournalWriter(ref, fsync=False)
    for rec in recs:
        w.append(rec)
    w.close()
    assert open(path, "rb").read() == open(ref, "rb").read()


def test_wal_missing_file_is_empty_not_error(tmp_path):
    assert recover_journal(str(tmp_path / "never.wal")) == ([], False)


def test_wal_torn_tail_truncated_and_repaired(tmp_path):
    path = str(tmp_path / "a.wal")
    recs = [{"op": "submit", "i": i} for i in range(3)]
    _write_wal(path, recs)
    size = os.path.getsize(path)
    with open(path, "ab") as f:   # SIGKILL mid-append: half a frame
        f.write(struct.pack("<II", 999, 0) + b'{"op": "half')
    got, truncated = recover_journal(path)
    assert got == recs and truncated
    # Repaired back to the last good offset: appends are well-formed.
    assert os.path.getsize(path) == size
    w = JournalWriter(path, fsync=False)
    w.append({"op": "done"})
    w.close()
    assert recover_journal(path) == (recs + [{"op": "done"}], False)


def test_wal_bitflip_stops_at_corrupt_record(tmp_path):
    path = str(tmp_path / "a.wal")
    recs = [{"op": "submit", "i": i} for i in range(5)]
    _write_wal(path, recs)
    data = bytearray(open(path, "rb").read())
    # Walk the frames to the payload of record 2 and flip one bit.
    off = len(MAGIC)
    for _ in range(2):
        length, _crc = struct.unpack_from("<II", data, off)
        off += 8 + length
    data[off + 8 + 2] ^= 0x40
    with open(path, "wb") as f:
        f.write(data)
    got, truncated = recover_journal(path)
    assert got == recs[:2] and truncated


def test_frames_roundtrip_and_torn_flag():
    """The wire-side halves of the framing: every intact record comes
    back, a torn trailing frame only sets the flag; the bytes are the
    reference's."""
    recs = [{"op": "submit", "i": i, "shape": [4, 4, i + 1]}
            for i in range(4)]
    blob = encode_frames(recs)
    assert blob == ref_journal.encode_frames(recs)
    assert decode_frames(blob) == (recs, False)
    assert decode_frames(blob + frame_record(recs[0])[:7]) == (recs, True)
    assert decode_frames(b"") == ([], False)
    assert ref_journal.decode_frames(blob) == (recs, False)


def test_torn_tail_every_byte_offset(tmp_path):
    """Exhaustive torn-tail sweep: truncate the WAL at *every* byte
    offset strictly inside the last record; recovery must yield
    exactly the acked prefix (all records but the last), flagged as
    truncated, at every single offset."""
    recs = [{"op": "submit", "i": i, "pad": "x" * (3 * i)}
            for i in range(4)]
    whole = MAGIC + encode_frames(recs)
    last_start = len(MAGIC) + len(encode_frames(recs[:-1]))
    path = str(tmp_path / "torn.wal")
    for cut in range(last_start + 1, len(whole)):
        with open(path, "wb") as f:
            f.write(whole[:cut])
        got, truncated = recover_journal(path, repair=False)
        assert got == recs[:-1], f"cut at byte {cut}"
        assert truncated, f"cut at byte {cut} not flagged"
    # And with repair: the file is truncated back to the acked prefix
    # and a re-recovery is clean.
    with open(path, "wb") as f:
        f.write(whole[:len(whole) - 1])
    assert recover_journal(path, repair=True) == (recs[:-1], True)
    assert os.path.getsize(path) == last_start
    assert recover_journal(path) == (recs[:-1], False)


def test_wal_foreign_header_ignored_wholesale(tmp_path):
    path = str(tmp_path / "a.wal")
    with open(path, "wb") as f:
        f.write(b"GARBAGE!" + b"\x01" * 32)
    assert recover_journal(path) == ([], True)
    # Repair leaves a well-formed empty journal behind.
    assert recover_journal(path) == ([], False)


# ------------------------------------------- checkpoint-shard bit-rot
def test_eval_checkpoint_crc_detects_bitflip():
    rec = {"fingerprint": "x", "metrics": {"jcr": 0.5}}
    rec["_crc32"] = record_crc(rec)
    assert verify_record(rec)
    rec["metrics"]["jcr"] = 0.6
    assert not verify_record(rec)
    rec["_crc32"] = "not-a-crc"
    assert not verify_record(rec)


def _daemon_cfg(tmp_path, **kw):
    kw.setdefault("checkpoint_every", 1000)   # keep ops in the WAL
    return config(checkpoint_dir=str(tmp_path / "ckpt"), **kw)


def _snapshot_path(cfg):
    return os.path.join(shard_dir(cfg.checkpoint_dir, cfg.fingerprint()),
                        cfg.checkpoint_name())


@pytest.mark.parametrize("corrupt", ["bitflip", "truncate"])
def test_corrupt_snapshot_never_replays(tmp_path, corrupt):
    cfg = _daemon_cfg(tmp_path, checkpoint_every=1)
    with Scheduler(cfg) as s:
        s.submit((4, 4, 4))
        assert s.status()["journal_ops"] == 1
    path = _snapshot_path(cfg)
    data = bytearray(open(path, "rb").read())
    if corrupt == "bitflip":
        data[len(data) // 2] ^= 0xFF
    else:
        data = data[:len(data) // 2]
    with open(path, "wb") as f:
        f.write(bytes(data))
    # A corrupt shard must start fresh (never crash, never half-replay).
    s2 = Scheduler(cfg).start()
    st = s2.status()
    s2.kill()
    assert st["journal_ops"] == 0 and st["allocated"] == 0


def test_daemon_truncated_wal_recovers_acked_prefix(tmp_path):
    cfg = _daemon_cfg(tmp_path)
    s = Scheduler(cfg).start()
    for dims in [(4, 4, 4), (2, 4, 8), (4, 4, 8)]:
        s.submit(dims)
    n_ops = s.status()["journal_ops"]
    s.kill()   # crash: recovery is WAL-only (no final snapshot)
    wal = os.path.join(shard_dir(cfg.checkpoint_dir, cfg.fingerprint()),
                       cfg.checkpoint_name() + ".wal")
    with open(wal, "rb") as f:
        data = f.read()
    with open(wal, "wb") as f:   # tear the last record mid-payload
        f.write(data[:-5])
    s2 = Scheduler(cfg).start()
    st = s2.status()
    s2.kill()
    assert st["journal_ops"] == n_ops - 1
    assert st["resilience"]["wal_truncated"] == 1
    assert st["resilience"]["wal_tail_ops"] == n_ops - 1
    # The recovered state is byte-identical to a run that only ever
    # saw the surviving prefix.
    s3 = Scheduler(config(checkpoint_dir=str(tmp_path / "control"))).start()
    for dims in [(4, 4, 4), (2, 4, 8)]:
        s3.submit(dims)
    digest = s3.status()["state_digest"]
    s3.kill()
    assert st["state_digest"] == digest


# --------------------------------------------------- idempotent retry
class _Raw:
    """Wire client with a fixed client id and explicit request_ids, so
    a byte-identical resend is the genuine retry path."""

    def __init__(self, address, cid="raw"):
        self._c = SchedulerClient(address, client_id=cid, max_retries=0)
        self._cid = cid

    def send(self, i, msg):
        wire = dict(msg, seq=i, client=self._cid,
                    request_id=f"{self._cid}:{i}")
        self._c._sock.sendall(protocol.encode(wire))
        return self._c._await_reply(i, 30.0)

    def close(self):
        self._c.close()


def test_retry_same_request_id_applied_once():
    s = Scheduler(config()).start()
    c = _Raw(s.address)
    try:
        r1 = c.send(0, {"op": "submit", "shape": [4, 4, 4]})
        assert r1["outcome"] == PLACED
        r2 = c.send(0, {"op": "submit", "shape": [4, 4, 4]})
        assert r2["job_id"] == r1["job_id"]
        st = c.send(1, {"op": "status"})
        assert st["allocated"] == 1   # applied exactly once
        assert st["resilience"]["dedup_hits"] >= 1
    finally:
        c.close()
        s.stop()


def test_dedup_cache_survives_crash(tmp_path):
    cfg = _daemon_cfg(tmp_path)
    s = Scheduler(cfg).start()
    c = _Raw(s.address)
    r1 = c.send(0, {"op": "submit", "shape": [4, 4, 4]})
    c.close()
    s.kill()
    # Replay repopulates the dedup cache from the journaled rids: the
    # retry a reconnecting client sends must still be exactly-once.
    s2 = Scheduler(cfg).start()
    c2 = _Raw(s2.address)
    try:
        before = c2.send(1, {"op": "status"})
        r2 = c2.send(0, {"op": "submit", "shape": [4, 4, 4]})
        after = c2.send(2, {"op": "status"})
        assert r2["job_id"] == r1["job_id"]
        assert after["state_digest"] == before["state_digest"]
        assert after["resilience"]["dedup_hits"] >= 1
    finally:
        c2.close()
        s2.stop()


# --------------------------------------------------------- liveness
def _await_expiry(s, deadline=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        st = s.status()
        if st["resilience"]["lease_expiries"] >= 1:
            return st
        time.sleep(0.05)
    raise AssertionError("lease never expired")


def test_lease_expiry_requeues_dead_clients_jobs():
    s = Scheduler(config(SMALL, lease_timeout=0.3,
                         lease_policy="requeue")).start()
    try:
        c = _Raw(s.address, cid="doomed")
        r = c.send(0, {"op": "submit", "shape": [4, 4, 4]})
        assert r["outcome"] == PLACED
        c.close()   # no more heartbeats: the lease lapses
        st = _await_expiry(s)
        assert st["allocated"] == 0
        assert st["queue_depth"] == 1   # work-preserving eviction
    finally:
        s.stop()


def test_lease_expiry_release_frees_capacity():
    s = Scheduler(config(SMALL, lease_timeout=0.3,
                         lease_policy="release")).start()
    try:
        c = _Raw(s.address, cid="doomed")
        assert c.send(0, {"op": "submit",
                          "shape": [4, 4, 4]})["outcome"] == PLACED
        c.close()
        st = _await_expiry(s)
        assert st["allocated"] == 0 and st["queue_depth"] == 0
        assert st["busy_xpus"] == 0
    finally:
        s.stop()


def test_facade_heartbeat_keeps_own_lease_alive():
    s = Scheduler(config(SMALL, lease_timeout=0.3)).start()
    try:
        assert s.submit((4, 4, 4))["outcome"] == PLACED
        time.sleep(1.0)   # several lease periods
        st = s.status()
        assert st["allocated"] == 1
        assert st["resilience"]["lease_expiries"] == 0
    finally:
        s.stop()


# ----------------------------------------------- client reconnection
def test_client_reconnect_clears_partial_buffer():
    s = Scheduler(config(SMALL)).start()
    c = SchedulerClient(s.address)
    try:
        assert c.status()["ok"]
        c._buf = b'{"torn": '   # half a frame from a dying connection
        c.connect()             # reconnect must not parse stale bytes
        assert c._buf == b""
        assert c.status()["num_xpus"] == 64
    finally:
        c.close()
        s.stop()


def test_stop_and_kill_drop_connected_clients():
    """A daemon stops at once even with clients still connected, and a
    killed daemon serves none of their later requests: the connection
    is gone, not answered by the dying loop."""
    s = Scheduler(config(SMALL)).start()
    idle = SchedulerClient(s.address, max_retries=0)
    assert idle.status()["ok"]
    t0 = time.monotonic()
    s.kill()
    assert time.monotonic() - t0 < 5.0
    with pytest.raises((ConnectionError, OSError)):
        idle._request("submit", _retries=0, shape=[2, 2, 2])
    idle.close()


# ------------------------------------------------ SIGKILL crash loop
_CHILD = """\
import sys, time
from repro_torch.api import EngineConfig, Scheduler, SchedulerConfig
cfg = SchedulerConfig(policy="rfold",
                      policy_kw=dict(num_xpus=512, cube_n=4),
                      engine=EngineConfig(sys.argv[2], device=sys.argv[3]),
                      checkpoint_dir=sys.argv[1], checkpoint_every=3)
s = Scheduler(cfg).start()
for i, dims in enumerate({shapes!r}):
    s.submit(dims)
    print("acked", i, flush=True)
    time.sleep(0.05)
s.kill()
"""

_SHAPES = [(4, 4, 4), (2, 4, 8), (4, 4, 8), (2, 2, 4),
           (4, 4, 4), (2, 4, 4), (4, 8, 4), (2, 2, 2)]


@pytest.mark.parametrize("engine", ["numpy", "torch", "cuda"])
def test_sigkill_midstream_recovers_acked_prefix(tmp_path, engine):
    """SIGKILL the daemon process at a seeded point mid-stream; a
    fresh daemon on the same store must hold every acknowledged op
    (fsync-before-ack) and match a control run over that prefix. The
    child names its engine and device (the CPU) explicitly: its
    default would be the card."""
    ckpt = str(tmp_path / "ckpt")
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(shapes=_SHAPES))
    kill_after = random.Random(7).randrange(2, 6)
    src = os.path.dirname(list(repro_torch.__path__)[0])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen([sys.executable, str(script), ckpt, engine,
                             "cpu"],
                            stdout=subprocess.PIPE, text=True, env=env)
    acked = 0
    try:
        for line in proc.stdout:
            if line.startswith("acked"):
                acked += 1
                if acked == kill_after:
                    os.kill(proc.pid, signal.SIGKILL)
                    break
        proc.wait(timeout=60)
    finally:
        proc.stdout.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert acked == kill_after

    cfg = SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                          engine=EngineConfig(engine, device="cpu"),
                          checkpoint_dir=ckpt, checkpoint_every=3)
    s2 = Scheduler(cfg).start()
    st = s2.status()
    s2.kill()
    # Every acked submit is durable; at most the one op in flight at
    # the kill may additionally have committed.
    assert acked <= st["journal_ops"] <= acked + 1

    s3 = Scheduler(config(checkpoint_dir=str(tmp_path / "control"))).start()
    for dims in _SHAPES[:st["journal_ops"]]:
        s3.submit(dims)
    digest = s3.status()["state_digest"]
    s3.kill()
    assert st["state_digest"] == digest


# --------------------------------------- replicated scheduler
def _pair(tmp_path, **primary_kw):
    """A primary + warm standby on private checkpoint stores."""
    pri = Scheduler(config(
        checkpoint_every=3, checkpoint_dir=str(tmp_path / "pri"),
        repl_poll=0.1, **primary_kw)).start()
    sby = Scheduler(config(
        checkpoint_every=3, checkpoint_dir=str(tmp_path / "sby"),
        repl_poll=0.1, role="standby", replicate_from=pri.address,
        **primary_kw)).start()
    return pri, sby


def _await_repl(sby, n_ops, deadline=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        st = sby.status()
        if st["journal_ops"] >= n_ops:
            return st
        time.sleep(0.02)
    raise AssertionError(f"standby never reached {n_ops} ops")


def _await_follower(pri, deadline=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        if pri.status()["repl"]["follower_live"]:
            return
        time.sleep(0.02)
    raise AssertionError("standby never pulled from the primary")


def test_standby_tails_primary_digest_tracks(tmp_path):
    """The replication stream: every journaled op the primary acks
    shows up on the standby, whose state digest tracks the primary's
    record-for-record."""
    pri, sby = _pair(tmp_path)
    try:
        for dims in _SHAPES[:5]:
            pri.submit(dims)
        pri.done(1)
        sp = pri.status()
        ss = _await_repl(sby, sp["journal_ops"])
        assert ss["state_digest"] == sp["state_digest"]
        assert ss["journal_ops"] == sp["journal_ops"]
        assert ss["resilience"]["repl_applied"] == sp["journal_ops"]
        assert ss["role"] == "standby" and sp["role"] == "primary"
    finally:
        sby.kill()
        pri.kill()


def test_standby_refuses_writes_and_redirects(tmp_path):
    """A standby answers writes with NOT_LEADER + the primary's
    address; a client pointed only at the standby follows the
    redirect and the op lands on the primary exactly once."""
    pri, sby = _pair(tmp_path)
    c = SchedulerClient(sby.address, client_id="redir", backoff=0.01)
    try:
        r = c.submit((4, 4, 4))
        assert r["outcome"] == PLACED
        assert c.redirects >= 1
        assert tuple(c.address) == tuple(pri.address)
        assert pri.status()["journal_ops"] == 1
        st = _await_repl(sby, 1)
        assert st["journal_ops"] == 1   # via replication, not the write
    finally:
        c.close()
        sby.kill()
        pri.kill()


def test_promotion_fences_old_primary_journal_side(tmp_path):
    """After a promotion, a request stamped with the new epoch makes
    the old primary fence itself: the write is refused and nothing
    reaches its journal — the no-double-place invariant."""
    pri, sby = _pair(tmp_path)
    c = SchedulerClient([pri.address, sby.address], client_id="fence",
                        backoff=0.01)
    try:
        for dims in _SHAPES[:3]:
            assert c.submit(dims)["ok"]
        _await_repl(sby, 3)
        pr = sby.promote()
        assert pr["promoted"] and pr["epoch"] == 2
        ops_before = pri.status()["journal_ops"]
        stale = SchedulerClient(pri.address, client_id="stale",
                                max_retries=0)
        stale.epoch_seen = pr["epoch"]   # witnessed the new leader
        with pytest.raises(ConnectionError):
            stale._request("submit", shape=[2, 2, 2])
        stale.close()
        sp = pri.status()
        assert sp["fenced"]
        assert sp["repl"]["fenced_rejections"] >= 1
        assert sp["journal_ops"] == ops_before   # zero fenced writes
    finally:
        c.close()
        sby.kill()
        pri.kill()


def test_client_discards_stale_epoch_reply():
    """Client-side fencing: a reply whose epoch is below the client's
    watermark is discarded like a connection failure — a superseded
    leader's ack is not an ack."""
    srv = __import__("socket").socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    address = srv.getsockname()[:2]
    done = threading.Event()

    def stale_leader():
        while not done.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn, conn.makefile("rb") as f:
                for line in f:
                    msg = protocol.decode(line)
                    conn.sendall(protocol.encode(
                        {"ok": True, "seq": msg.get("seq"), "epoch": 1,
                         "outcome": PLACED, "job_id": 0}))

    t = threading.Thread(target=stale_leader, daemon=True)
    t.start()
    c = SchedulerClient(address, client_id="wm", max_retries=1,
                        backoff=0.01)
    try:
        c.epoch_seen = 3   # witnessed a newer leader elsewhere
        with pytest.raises(ConnectionError, match="epoch"):
            c._request("submit", shape=[2, 2, 2])
        assert c.stale_rejections >= 1
    finally:
        done.set()
        srv.close()
        c.close()


def test_leader_kill_failover_exactly_once_digest_identical(tmp_path):
    """The acceptance scenario in miniature: kill the primary
    mid-stream, promote the standby, resend the last acked rid (the
    replicated dedup cache absorbs it), finish the stream — the final
    digest is byte-identical to an uninterrupted control run."""
    pri, sby = _pair(tmp_path, ack_mode="sync", sync_timeout=2.0)
    c = SchedulerClient([pri.address, sby.address], client_id="fo",
                        backoff=0.02)
    try:
        _await_follower(pri)
        replies = {}
        for i, dims in enumerate(_SHAPES[:4]):
            r = c._request("submit", request_id=f"fo:{i}",
                           shape=list(dims))
            assert r["ok"] and r["replicated"], r
            replies[i] = r
        pri.kill()   # no final checkpoint; clients see a dead socket
        assert sby.promote()["epoch"] == 2
        # Replay the in-flight rid: exactly-once across the failover.
        before = c._request("status")
        r2 = c._request("submit", request_id="fo:3",
                        shape=list(_SHAPES[3]))
        after = c._request("status")
        assert r2["job_id"] == replies[3]["job_id"]
        assert after["state_digest"] == before["state_digest"]
        assert after["resilience"]["dedup_hits"] >= 1
        assert c.epoch_seen == 2
        for i, dims in enumerate(_SHAPES[4:], start=4):
            assert c._request("submit", request_id=f"fo:{i}",
                              shape=list(dims))["ok"]
        final = c._request("status")
    finally:
        c.close()
        sby.kill()
    control = Scheduler(config()).start()
    for dims in _SHAPES:
        control.submit(dims)
    digest = control.status()["state_digest"]
    control.stop()
    assert final["state_digest"] == digest


def test_sync_ack_degrades_without_follower(tmp_path):
    """ack_mode=sync with no live standby must not stall the service:
    the op acks degraded (replicated=False) and the timeout is
    counted."""
    s = Scheduler(config(ack_mode="sync", sync_timeout=0.2)).start()
    try:
        t0 = time.monotonic()
        r = s.submit((4, 4, 4))
        assert time.monotonic() - t0 < 1.0   # no follower: no wait
        assert r["ok"] and r["replicated"] is False
        assert s.status()["repl"]["sync_timeouts"] >= 1
    finally:
        s.stop()


def test_promoted_standby_recovers_epoch_from_own_wal(tmp_path):
    """The fencing token is journaled state: a promoted standby that
    crashes recovers its epoch (and state) from its own WAL."""
    pri, sby = _pair(tmp_path)
    for dims in _SHAPES[:3]:
        pri.submit(dims)
    sp = pri.status()
    _await_repl(sby, sp["journal_ops"])
    pri.kill()
    assert sby.promote()["epoch"] == 2
    want = sby.status()
    sby.kill()
    s2 = Scheduler(config(checkpoint_every=3,
                          checkpoint_dir=str(tmp_path / "sby"))).start()
    st = s2.status()
    s2.kill()
    assert st["epoch"] == 2
    assert st["state_digest"] == want["state_digest"]
    assert st["journal_ops"] == want["journal_ops"]


def test_heartbeat_jitter_bounds():
    """The jittered interval stays inside [1-j, 1+j] of the base for
    any draw, degenerates to the base at jitter=0, and clamps bad
    jitter values instead of going negative."""
    for u in (0.0, 0.25, 0.5, 0.999):
        assert jittered_interval(3.0, 0.0, u) == 3.0
        v = jittered_interval(3.0, 0.25, u)
        assert 3.0 * 0.75 <= v <= 3.0 * 1.25
    assert jittered_interval(3.0, 0.25, 0.0) == pytest.approx(2.25)
    assert jittered_interval(3.0, 5.0, 0.0) == pytest.approx(0.0)
    assert jittered_interval(3.0, -1.0, 0.7) == 3.0


def test_config_validates_replication_fields():
    with pytest.raises(ValueError, match="role"):
        SchedulerConfig(role="observer")
    with pytest.raises(ValueError, match="ack_mode"):
        SchedulerConfig(ack_mode="paxos")
    with pytest.raises(ValueError, match="replicate_from"):
        SchedulerConfig(role="standby")
    # Replication knobs never change the checkpoint identity: a
    # standby shares the primary's fingerprint (the stream id).
    a = config()
    b = config(role="standby", replicate_from=("h", 1), ack_mode="sync")
    assert a.fingerprint() == b.fingerprint()
