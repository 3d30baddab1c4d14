"""`DurabilityPlane` — journal + shard spool + snapshot for one corpus.

Composes the layer's pieces into the recovery unit a `SelectionServer`
(or a bare `IngestPlane`) owns:

  * `record_append` makes an append durable *before* it is installed:
    each shard's bytes are spooled to ``<root>/shards/`` through an
    atomic replace (with a content CRC recorded alongside), then one
    journal record names the new epoch and its shard manifest, then
    ``crashpoint("post_journal_pre_install")`` marks the window where
    the intent is durable but the in-memory epoch is not.
  * `replay_into` rebuilds a corpus: every journaled epoch past the
    target plane's current one is loaded from the spool (CRC-checked)
    and re-applied through `IngestPlane.append`, which copies it to the
    engine's device and sketches it (one `score_hist` launch a chunk on
    the card). The delta path is bit for bit a cold build, so replay
    reproduces the crashed corpus exactly, and replaying an
    already-applied record is a no-op (the epoch guard skips it).
  * `write_snapshot` / `read_snapshot` persist the serving-plane state
    that must *not* be recomputed (certified taus, ledger balances,
    sentinel reference probes) through one atomic JSON replace.

**The card.** A shard handed over as a CUDA tensor is copied to the host
once (`_to_host`), and that copy is what is spooled (``np.save``: the
bytes a JAX-package spool holds for the same scores) and CRC'd. The
append then installs the caller's device tensor itself, whose bytes the
copy equals, so the install needs no host-to-device copy. Host arrays
and `ScoreStore`s are spooled and installed as they are. Journals,
spools and snapshots are the JAX package's formats, so either package
restores what the other wrote.

What is deliberately *not* journaled: oracle labels and query results.
Certifications are snapshotted, never re-run — recovery re-derives only
what is free and deterministic (sketches, CDFs, threshold walks) and
restores what cost oracle budget.

>>> import numpy as np, tempfile
>>> from repro_torch.core.engine import SelectionEngine
>>> from repro_torch.live.ingest import IngestPlane
>>> root = tempfile.mkdtemp()
>>> base = np.linspace(0, 1, 256, dtype=np.float32)
>>> dur = DurabilityPlane(root)
>>> with SelectionEngine([base], num_bins=32, device="cpu") as eng:
...     plane = IngestPlane(eng)
...     arrs = dur.record_append(np.full(128, 0.5, np.float32),
...                              epoch=plane.epoch + 1)
...     epoch = plane.append(arrs)
...     n_crashed = eng.n_total
>>> with SelectionEngine([base], num_bins=32, device="cpu") as eng2:
...     replayed = dur.replay_into(IngestPlane(eng2))
...     (replayed, eng2.n_total == n_crashed, eng2.epoch)
(1, True, 1)
"""
from __future__ import annotations

import dataclasses
import io
import os
import zlib
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.durable import atomic
from repro_torch.durable.journal import EpochJournal

SNAPSHOT_NAME = "snapshot.json"


def encode_key(key) -> Optional[dict]:
    """Serialize a PRNG key array (or None) to a JSON-safe dict."""
    if key is None:
        return None
    arr = np.asarray(key)
    return {"dtype": str(arr.dtype), "data": arr.tolist()}


def decode_key(obj: Optional[dict]):
    """Inverse of `encode_key`."""
    if obj is None:
        return None
    return np.asarray(obj["data"], dtype=np.dtype(obj["dtype"]))


def encode_query(q) -> dict:
    """Serialize a `SUPGQuery` / `JointSUPGQuery` to a JSON-safe dict."""
    kind = type(q).__name__
    if kind not in ("SUPGQuery", "JointSUPGQuery"):
        raise TypeError(f"cannot serialize query of type {kind}")
    return {"kind": kind, "fields": dataclasses.asdict(q)}


def decode_query(obj: dict):
    """Inverse of `encode_query`."""
    from repro_torch.core.queries import JointSUPGQuery, SUPGQuery
    cls = {"SUPGQuery": SUPGQuery,
           "JointSUPGQuery": JointSUPGQuery}[obj["kind"]]
    return cls(**obj["fields"])


def _to_host(shard: torch.Tensor) -> np.ndarray:
    """One shard tensor's scores as a host array: the append's one
    device-to-host copy for a CUDA tensor, a view for a CPU one."""
    return shard.detach().cpu().numpy()


def _normalize_batch(shards: Union[Sequence, np.ndarray, torch.Tensor,
                                   object]) -> List:
    """One shard or a sequence -> list of shards, exactly as
    `IngestPlane.append` normalizes (ScoreStores pass their memmap)."""
    batch = (list(shards) if isinstance(shards, (list, tuple))
             else [shards])
    return [getattr(s, "scores", s) for s in batch]


class DurabilityPlane:
    """Owns one corpus's journal, shard spool, and snapshot file.

    Layout under `root`::

        journal.log       append-only epoch journal (CRC-framed)
        shards/           spooled shard payloads, one .npy per shard
        snapshot.json     latest serving-state snapshot (atomic replace)
    """

    def __init__(self, root):
        self.root = str(root)
        self.shard_dir = os.path.join(self.root, "shards")
        os.makedirs(self.shard_dir, exist_ok=True)
        self.journal = EpochJournal(os.path.join(self.root, "journal.log"))
        self.journaled_appends = 0    # appends recorded this process
        self.replayed_epochs = 0      # epochs re-applied by replay_into
        self.snapshots = 0            # snapshots written this process

    # -- observability ---------------------------------------------------

    @property
    def journal_records(self) -> int:
        """Valid records currently in the journal (including recovered)."""
        return len(self.journal)

    @property
    def journal_bytes(self) -> int:
        """Valid journal bytes on disk."""
        return self.journal.valid_bytes

    # -- write-ahead append ----------------------------------------------

    def record_append(self, shards, *, epoch: int) -> List:
        """Durably record an append destined to install as `epoch`.

        Spools each shard's bytes (atomic replace + content CRC), then
        journals the epoch manifest, then announces
        `post_journal_pre_install`. Returns the shard list the caller
        installs: the host arrays that were spooled, and a tensor shard
        as it was given (its bytes are the spooled copy's). A crash
        before the journal fsync means the append was never acknowledged
        — the client retries; the epoch guard in `replay_into` (and the
        caller's resume path) makes the retry exactly-once.
        """
        batch = _normalize_batch(shards)
        install = []
        manifest = []
        for i, shard in enumerate(batch):
            if isinstance(shard, torch.Tensor):
                arr = _to_host(shard)
                install.append(shard)
            else:
                arr = np.asarray(shard)
                install.append(arr)
            name = f"epoch_{epoch:08d}_{i:04d}.npy"
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(arr))
            data = buf.getvalue()
            atomic.atomic_write_bytes(os.path.join(self.shard_dir, name),
                                      data)
            manifest.append({"file": name, "records": int(arr.shape[0]),
                             "crc": zlib.crc32(data) & 0xFFFFFFFF})
        self.journal.append({"type": "append", "epoch": int(epoch),
                             "shards": manifest})
        self.journaled_appends += 1
        atomic.crashpoint("post_journal_pre_install")
        return install

    def _load_shard(self, entry: dict) -> np.ndarray:
        path = os.path.join(self.shard_dir, entry["file"])
        with open(path, "rb") as f:
            data = f.read()
        if zlib.crc32(data) & 0xFFFFFFFF != entry["crc"]:
            raise ValueError(
                f"spooled shard {entry['file']} fails its content CRC — "
                f"the journal acknowledged bytes that are no longer on "
                f"disk")
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        if int(arr.shape[0]) != entry["records"]:
            raise ValueError(
                f"spooled shard {entry['file']} has {arr.shape[0]} "
                f"records, journal says {entry['records']}")
        return arr

    def replay_into(self, plane) -> int:
        """Re-apply journaled appends past `plane`'s current epoch.

        `plane` is an `IngestPlane` (anything with ``epoch`` and
        ``append``). Records at or below the current epoch are skipped —
        replaying an already-applied record is a no-op — so the call is
        idempotent and safe to run on a half-recovered corpus. Returns
        the number of epochs applied.
        """
        applied = 0
        for rec in self.journal.replay():
            if rec.get("type") != "append":
                continue
            if int(rec["epoch"]) <= plane.epoch:
                continue
            arrs = [self._load_shard(e) for e in rec["shards"]]
            got = plane.append(arrs)
            if got != int(rec["epoch"]):
                raise RuntimeError(
                    f"journal replay installed epoch {got}, expected "
                    f"{rec['epoch']} — the journal and corpus disagree")
            applied += 1
        self.replayed_epochs += applied
        return applied

    # -- snapshots --------------------------------------------------------

    @property
    def snapshot_path(self) -> str:
        """Path of the snapshot file (may not exist yet)."""
        return os.path.join(self.root, SNAPSHOT_NAME)

    def write_snapshot(self, state: dict) -> str:
        """Atomically publish a serving-state snapshot; returns its path.

        `pre_snapshot_publish` marks the window before the replace: a
        crash there leaves the previous snapshot fully intact.
        """
        atomic.crashpoint("pre_snapshot_publish")
        atomic.atomic_write_json(self.snapshot_path, state)
        self.snapshots += 1
        return self.snapshot_path

    def read_snapshot(self) -> Optional[dict]:
        """The latest snapshot, or None when none was ever published."""
        return atomic.read_json(self.snapshot_path)

    def close(self) -> None:
        """Close the journal's file handle. Idempotent."""
        self.journal.close()
