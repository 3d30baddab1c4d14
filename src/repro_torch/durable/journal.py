"""`EpochJournal` — a CRC-framed, fsync'd, torn-tail-tolerant record log.

The write-ahead journal of the durability plane: every corpus append is
recorded here *before* it is installed in memory, so a crashed process
can rebuild exactly the epochs it acknowledged (plus at most one it
journaled but never got to install — which replay applies, matching the
uncrashed timeline; see "Durability & recovery" in the JAX package's
`docs/guarantees.md`, which holds for the port unchanged).

Framing: each record is ``MAGIC(4) | payload_len(u32 LE) | crc32(u32
LE) | payload`` with a JSON payload. Appends write the frame then fsync
before acknowledging; `scan` walks frames from the start and stops at
the first bad magic, short frame, or CRC mismatch — a torn tail (the
one frame a mid-write crash can leave) is silently dropped, and a
journal opened for append truncates that tail away so the next record
lands on a clean boundary. Replay therefore never raises on a crashed
file and never invents a record.

>>> import tempfile, os
>>> path = os.path.join(tempfile.mkdtemp(), "journal.log")
>>> with EpochJournal(path) as j:
...     _ = j.append({"type": "append", "epoch": 1})
...     _ = j.append({"type": "append", "epoch": 2})
>>> [r["epoch"] for r in EpochJournal(path).replay()]
[1, 2]
>>> with open(path, "ab") as f:       # torn tail: half a record
...     _ = f.write(b"EPJ1\\x99")
>>> [r["epoch"] for r in EpochJournal(path).replay()]
[1, 2]
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

from repro_torch.durable.atomic import crashpoint, fsync_dir

MAGIC = b"EPJ1"
_HEADER = struct.Struct("<4sII")      # magic, payload length, crc32


def _frame(record: dict) -> bytes:
    payload = json.dumps(record, sort_keys=True).encode("utf-8")
    return _HEADER.pack(MAGIC, len(payload),
                        zlib.crc32(payload) & 0xFFFFFFFF) + payload


def scan(path) -> Tuple[List[dict], int]:
    """Parse every valid record of a journal file.

    Returns ``(records, valid_bytes)`` where `valid_bytes` is the byte
    offset of the first invalid frame (== file size for a clean file).
    Tolerant by construction: a missing file is an empty journal, and
    the scan stops — without raising — at the first torn, truncated, or
    corrupt frame, so a crash mid-append can only ever cost the record
    being written, never a parsed-garbage epoch.
    """
    try:
        with open(str(path), "rb") as f:
            data = f.read()
    except OSError:
        return [], 0
    records: List[dict] = []
    off = 0
    while off + _HEADER.size <= len(data):
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != MAGIC:
            break
        start = off + _HEADER.size
        payload = data[start:start + length]
        if len(payload) < length:
            break                      # torn tail: frame cut short
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                      # corrupt frame: stop, don't guess
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except ValueError:
            break
        off = start + length
    return records, off


class EpochJournal:
    """Append-only record log with CRC framing and fsync'd appends.

    Opening scans the existing file and truncates any torn tail (the
    incomplete frame a mid-write crash leaves) so appends resume on a
    record boundary. `append` is durable on return: the frame is
    written and fsync'd before the call acknowledges.
    """

    def __init__(self, path):
        self.path = str(path)
        parent = os.path.dirname(self.path) or "."
        os.makedirs(parent, exist_ok=True)
        records, valid = scan(self.path)
        self._records = records
        created = not os.path.exists(self.path)
        self._f = open(self.path, "ab" if created else "r+b")
        if created:
            fsync_dir(parent)          # make the journal's name durable
        else:
            self._f.truncate(valid)    # drop the torn tail, if any
        self._f.seek(valid)
        self.valid_bytes = valid

    def __enter__(self) -> "EpochJournal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> List[dict]:
        """The journal's valid records (snapshot copy)."""
        return list(self._records)

    def append(self, record: dict) -> int:
        """Durably append one record; returns its index.

        Two crashpoints bracket the write: `journal_pre_append` (crash
        → nothing written, the caller never acknowledged) and
        `journal_pre_fsync` (crash → the frame may survive in the page
        cache; replay applies it — same outcome the caller was about to
        acknowledge).
        """
        frame = _frame(record)
        crashpoint("journal_pre_append")
        self._f.write(frame)
        self._f.flush()
        crashpoint("journal_pre_fsync")
        os.fsync(self._f.fileno())
        self._records.append(record)
        self.valid_bytes += len(frame)
        return len(self._records) - 1

    def replay(self) -> List[dict]:
        """Re-scan the file from disk and return every valid record."""
        return scan(self.path)[0]

    def close(self) -> None:
        """Close the underlying file handle. Idempotent."""
        if not self._f.closed:
            self._f.close()
