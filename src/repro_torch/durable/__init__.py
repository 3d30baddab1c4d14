"""Durability & crash-recovery plane, ported.

Three layers, leaf first:

  * `repro_torch.durable.atomic` — atomic replace, two-phase length
    commit, fsync barriers, and the named-crashpoint hook (`CRASHPOINTS`).
  * `repro_torch.durable.journal` — `EpochJournal`, the CRC-framed,
    fsync'd, torn-tail-tolerant write-ahead log of corpus appends.
  * `repro_torch.durable.recovery` — `DurabilityPlane`, composing journal
    + shard spool + snapshot into the unit `SelectionServer` owns; plus
    the query/key codecs snapshots serialize with.

Journal frames, spooled shards and snapshots are the JAX package's
formats byte for byte, so either package restores what the other wrote.
The contract (what survives a crash, and why a recovered tau is still
certified) is "Durability & recovery" in the JAX package's
`docs/guarantees.md`.
"""
from repro_torch.durable.atomic import (
    CRASHPOINTS,
    atomic_write_bytes,
    atomic_write_json,
    commit_length,
    committed_length,
    crashpoint,
    discard_uncommitted_tail,
    read_json,
    set_crash_hook,
)
from repro_torch.durable.journal import EpochJournal, scan
from repro_torch.durable.recovery import (
    DurabilityPlane,
    decode_key,
    decode_query,
    encode_key,
    encode_query,
)

__all__ = [
    "CRASHPOINTS",
    "DurabilityPlane",
    "EpochJournal",
    "atomic_write_bytes",
    "atomic_write_json",
    "commit_length",
    "committed_length",
    "crashpoint",
    "decode_key",
    "decode_query",
    "discard_uncommitted_tail",
    "encode_key",
    "encode_query",
    "read_json",
    "scan",
    "set_crash_hook",
]
