"""Incremental ingestion: grow a live corpus without cold rebuilds.

`IngestPlane` is the public face of `SelectionEngine._append_shards`: it
takes appended score shards (numpy arrays, tensors, or `ScoreStore`s),
sketches only the new chunks (one `score_hist` launch a chunk on the
card), folds them onto the engine's global sketch, refreshes the
normalizers and every cached chunk-mass CDF from cached chunk masses
without reading an old record, and installs the result as a new corpus
*epoch*:

  * installs are atomic; a plan that pinned its epoch keeps computing
    against a frozen, consistent corpus;
  * results over any epoch are bit for bit those of a cold engine built
    over exactly that corpus;
  * `shards_since(epoch)` names the shards an epoch transition added,
    the unit the standing-query plane re-emits over.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from repro_torch.core.engine import CorpusState, SelectionEngine


class IngestPlane:
    """Appends score shards to a `SelectionEngine`, one epoch per append.

    >>> import numpy as np
    >>> from repro_torch.core.engine import SelectionEngine
    >>> eng = SelectionEngine([np.linspace(0, 1, 512, dtype=np.float32)],
    ...                       num_bins=32, device="cpu")
    >>> plane = IngestPlane(eng)
    >>> epoch = plane.append(np.linspace(0, 1, 256, dtype=np.float32))
    >>> (epoch, eng.epoch, eng.n_total, plane.shards_since(0))
    (1, 1, 768, [1])
    >>> eng.close()
    """

    def __init__(self, engine: SelectionEngine):
        self.engine = engine
        self._lock = threading.Lock()
        # epoch -> shard count at that epoch, for shards_since(); seeded
        # with the engine's current epoch, so a plane attached late still
        # resolves deltas from its attach point.
        self._shard_count_at: Dict[int, int] = {
            engine.epoch: len(engine.shards)}
        self.appends = 0             # epochs installed through this plane
        self.records_ingested = 0    # records those epochs added

    @property
    def epoch(self) -> int:
        """The engine's current corpus epoch."""
        return self.engine.epoch

    def append(self, shards: Union[Sequence, np.ndarray, torch.Tensor,
                                   object]) -> int:
        """Append one shard (array, tensor or ScoreStore) or a sequence of
        shards; returns the new epoch number.

        Only the appended data is sketched; everything else is rebuilt
        from cached state in O(n_chunks). A tensor on the engine's device
        (fresh scores from the scoring plane) is taken without a host
        round trip. Safe to call while queries run: in-flight plans keep
        their pinned epoch.
        """
        batch = list(shards) if isinstance(shards, (list, tuple)) \
            else [shards]
        with self._lock:
            before = self.engine.n_total
            state = self.engine._append_shards(batch)
            self._shard_count_at[state.epoch] = len(state.shards)
            self.appends += 1
            self.records_ingested += state.n_total - before
            return state.epoch

    def shards_since(self, epoch: int) -> List[int]:
        """Shard ids appended strictly after `epoch` (through this plane):
        the shards a standing query certified at `epoch` must walk to
        catch up with the current corpus."""
        with self._lock:
            if epoch not in self._shard_count_at:
                raise ValueError(
                    f"epoch {epoch} was not recorded by this IngestPlane "
                    f"(known: {sorted(self._shard_count_at)})")
            return list(range(self._shard_count_at[epoch],
                              len(self.engine.shards)))

    def pin(self) -> CorpusState:
        """Snapshot the current epoch (`engine.pin()`); pair with `unpin`
        so `gc_epochs` can free superseded epochs."""
        return self.engine.pin()

    def unpin(self, state: CorpusState) -> None:
        """Release a `pin` reference (`engine.unpin()`)."""
        self.engine.unpin(state)
