"""Crash-safe write-ahead journal for the allocator daemon.

The snapshot store (``repro_torch.eval.runner``'s atomic tmp+rename
checkpoints) makes *whole* snapshots durable, but anything between two
snapshots dies with the process. This module adds the missing tail: an
append-only WAL where every journaled op is framed, checksummed and
fsynced **before** its reply leaves the daemon, so recovery replays
``snapshot + WAL tail`` and loses nothing that was acknowledged.

Framing (little-endian, one record per committed op)::

    file   := MAGIC(8) record*
    record := length:u32 crc32:u32 payload[length]

``payload`` is canonical JSON (``sort_keys=True``) of the op dict. The
magic doubles as the format version: an unrecognized header is treated
as an incompatible (foreign) file and ignored wholesale rather than
misparsed.

Torn-write semantics — the entire point of the framing: a crash (or
SIGKILL) mid-``write`` leaves a trailing record that is short, fails
its CRC, or is not valid JSON. :func:`recover_journal` stops at the
first such record and **truncates the file back to the last good
offset**, so the journal is again well-formed for subsequent appends;
it never raises on a corrupt tail. Every acknowledged op precedes the
torn one by the fsync ordering, so truncation only ever discards
unacknowledged work.

Replication: the framing doubles as the **over-the-wire
replication format**. :func:`encode_frames` / :func:`decode_frames`
are the pure-bytes halves of the writer/recovery above — the primary
daemon answers a follower's cursor with a run of framed records (no
MAGIC; the stream id travels as the config fingerprint instead), and
the follower applies every frame that checks out, ignoring a torn
tail exactly as crash recovery would. One format, one parser, one set
of torn-tail semantics for disk and wire.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, List, Tuple

MAGIC = b"RPROWAL1"
_HEADER = struct.Struct("<II")   # payload length, crc32(payload)


def frame_record(rec: Dict[str, Any]) -> bytes:
    """One framed record: ``length u32 | crc32 u32 | canonical JSON``."""
    payload = json.dumps(rec, sort_keys=True).encode()
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def encode_frames(records: List[Dict[str, Any]]) -> bytes:
    """Frame a run of records for the replication stream (no MAGIC —
    the stream identity is negotiated separately)."""
    return b"".join(frame_record(r) for r in records)


def scan_frames(data: bytes,
                offset: int = 0) -> Tuple[List[Dict[str, Any]], int]:
    """Parse framed records starting at ``offset``; stops at the first
    short/corrupt frame. Returns ``(records, end_offset)`` where
    ``end_offset`` is the byte just past the last intact record."""
    records: List[Dict[str, Any]] = []
    off = offset
    good = off
    while off + _HEADER.size <= len(data):
        length, crc = _HEADER.unpack_from(data, off)
        payload = data[off + _HEADER.size:off + _HEADER.size + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break
        try:
            rec = json.loads(payload)
        except ValueError:
            break
        records.append(rec)
        off += _HEADER.size + length
        good = off
    return records, good


def decode_frames(data: bytes) -> Tuple[List[Dict[str, Any]], bool]:
    """Wire-side frame parse: every intact record plus a flag for
    trailing garbage (a torn frame in a replication reply means a
    corrupted reply — the follower re-pulls from its cursor)."""
    records, good = scan_frames(data, 0)
    return records, good != len(data)


class JournalWriter:
    """Append-only framed writer with fsync-on-commit.

    ``fsync=False`` trades durability of the last few ops for write
    latency (tests and benchmarks that only need crash *consistency*,
    not durability, use it); framing and torn-tail recovery are
    unaffected either way.
    """

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            self._f.write(MAGIC)
            self._commit()

    def _commit(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def append(self, rec: Dict[str, Any]) -> None:
        """Frame + write + (optionally) fsync one record. On return
        the record is durable: a crash after ``append`` replays it."""
        self._f.write(frame_record(rec))
        self._commit()

    def reset(self) -> None:
        """Truncate back to an empty (header-only) journal — called
        right after a snapshot subsumes the tail."""
        self._f.close()
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._commit()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def recover_journal(path: str,
                    repair: bool = True) -> Tuple[List[Dict[str, Any]],
                                                  bool]:
    """Read every intact record; returns ``(records, truncated)``.

    ``truncated`` is True when a torn/corrupt tail (short frame, CRC
    mismatch, bad JSON — or a foreign/garbage header) was found; with
    ``repair=True`` the file is truncated back to the last good record
    so future appends land on a well-formed journal. Missing file =
    ``([], False)``: never an error.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], False
    if not data.startswith(MAGIC):
        # Unknown version or garbage: nothing salvageable.
        if repair and data:
            with open(path, "wb") as f:
                f.write(MAGIC)
        return [], bool(data)
    records, good = scan_frames(data, len(MAGIC))
    truncated = good != len(data)
    if truncated and repair:
        with open(path, "r+b") as f:
            f.truncate(good)
    return records, truncated
