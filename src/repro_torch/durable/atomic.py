"""Atomic filesystem commit primitives + the named-crashpoint hook.

This is the leaf of the durability plane: every on-disk mutation the
repo wants to survive a crash goes through one of three shapes —

  * **atomic replace** (`atomic_write_bytes` / `atomic_write_json`):
    write to a same-directory temp file, fsync it, `os.replace` it over
    the destination, fsync the directory. A crash at any instant leaves
    either the old file or the new file, never a mixture.
  * **length commit** (`commit_length` / `committed_length`): for files
    that only ever *grow* (a `ScoreStore`'s backing array), the data is
    written and fsync'd past the committed length first, then the new
    length is published through an atomically-replaced sidecar. Bytes
    past the committed length are recovery garbage by definition and
    are truncated away on the next open.
  * **fsync barriers** (`fsync_path` / `fsync_dir`): make already-written
    bytes (and directory entries) durable before a dependent commit.

**Crashpoints.** Durable code announces the instants a crash is
interesting by calling ``crashpoint("name")`` between its write and its
commit. In production the hook is unset and the call is a dict lookup;
under test, a crash injector installs a hook that raises
`SimulatedCrash` at a scheduled hit — deterministic kill-at-this-
instant, no signals or subprocesses. The registry of names is
`CRASHPOINTS`; injectors validate against it so a renamed point cannot
silently turn a crash test into a no-op.

No package-internal imports: `repro_torch.data.pipeline` (and anything else)
can depend on this module without cycles.

>>> import tempfile, os, pathlib
>>> d = tempfile.mkdtemp()
>>> p = os.path.join(d, "state.json")
>>> atomic_write_json(p, {"epoch": 1})
>>> read_json(p)["epoch"]
1
>>> atomic_write_json(p, {"epoch": 2})     # replace, never a torn mix
>>> read_json(p)["epoch"]
2
>>> commit_length(p, 10)
>>> committed_length(p)
10
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

# Every named instant a `CrashInjector` may kill at. Grouped by the
# commit path that announces them; see each call site for the exact
# write-vs-commit window the point sits in.
CRASHPOINTS = (
    "pre_fsync",                  # atomic replace: temp written, not yet durable
    "pre_rename",                 # atomic replace: durable temp, not yet visible
    "journal_pre_append",         # journal: record not yet written at all
    "journal_pre_fsync",          # journal: frame written, not yet durable
    "post_journal_pre_install",   # ingest: journaled, epoch not yet installed
    "pre_length_commit",          # store append: data durable, length not committed
    "mid_bitmask_commit",         # bitmask grow: file grown, meta not committed
    "pre_snapshot_publish",       # snapshot: state built, not yet replacing
)

_hook: Optional[Callable[[str], None]] = None


def set_crash_hook(fn: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the process-wide crashpoint hook.

    Test-only surface: a crash injector is the supported
    installer. The hook is called with the crashpoint name and may raise
    to simulate the process dying at that instant.
    """
    global _hook
    _hook = fn


def crashpoint(name: str) -> None:
    """Announce a named crash-interesting instant (no-op in production)."""
    if _hook is not None:
        _hook(name)


def fsync_path(path) -> None:
    """fsync an existing file's contents to stable storage."""
    fd = os.open(str(path), os.O_RDWR)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path) -> None:
    """fsync a directory so renames/creates inside it are durable."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path, data: bytes) -> None:
    """Atomically replace `path` with `data` (write temp, fsync, rename).

    A crash at any instant leaves either the previous file or the new
    one — `crashpoint("pre_fsync")` and `crashpoint("pre_rename")` mark
    the two windows a `CrashInjector` can kill in to prove it.
    """
    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        crashpoint("pre_fsync")
        os.fsync(f.fileno())
    crashpoint("pre_rename")
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def atomic_write_json(path, obj) -> None:
    """Atomically replace `path` with `obj` serialized as JSON."""
    atomic_write_bytes(path, (json.dumps(obj, sort_keys=True) + "\n")
                       .encode("utf-8"))


def read_json(path, default=None):
    """Read a JSON file; `default` when it does not exist (or is torn —
    an interrupted non-atomic writer; atomic writers never leave one)."""
    try:
        with open(str(path), "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


def _length_sidecar(path) -> str:
    return f"{path}.commit"


def commit_length(path, length: int) -> None:
    """Publish `length` as `path`'s committed length (atomic sidecar).

    The second phase of a grow-only file's two-phase append: call only
    after the bytes below `length` are written *and fsync'd*.
    """
    atomic_write_json(_length_sidecar(path), {"length": int(length)})


def committed_length(path, default: Optional[int] = None) -> Optional[int]:
    """Read `path`'s committed length; `default` when never committed."""
    meta = read_json(_length_sidecar(path))
    if meta is None:
        return default
    return int(meta["length"])


def discard_uncommitted_tail(path) -> Optional[int]:
    """Truncate `path` down to its committed length (crash recovery for
    grow-only files). Returns the committed length, or None when the
    file has no length sidecar (nothing to recover against)."""
    n = committed_length(path)
    if n is None:
        return None
    if os.path.getsize(str(path)) > n:
        with open(str(path), "r+b") as f:
            f.truncate(n)
            f.flush()
            os.fsync(f.fileno())
    return n


def publish_dir(tmp, final) -> None:
    """Atomically publish a staged directory: `os.replace` the temp dir
    over `final` and fsync the parent so the rename is durable. The
    checkpointing primitive a checkpointer stages under."""
    os.replace(str(tmp), str(final))
    fsync_dir(os.path.dirname(str(final)) or ".")
