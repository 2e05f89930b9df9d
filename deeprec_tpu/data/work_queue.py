"""WorkQueue: elastic sharding of input work items across workers.

Rebuild of DeepRec's WorkQueue (reference:
core/kernels/work_queue_ops.cc:70 — a PS-hosted global queue of work items;
python/ops/work_queue.py:113 — take()/input_dataset()/add_summary, saveable
state; docs/WorkQueue.md). Fast workers take more items; a restarted worker
resumes from the surviving claim state.

The reference hosts the queue on a PS task over gRPC. Here there is no PS:
coordination happens through a **shared filesystem directory** (the norm on
accelerator clusters: GCS/NFS mount) with O_CREAT|O_EXCL claim files — atomic on POSIX
and GCS — plus an in-process mode for single-host multi-thread loaders.

Semantics:
  * items (file names / shard descriptors) are registered once with a
    stable index;
  * ``take()`` returns the next unclaimed item or None when the epoch is
    exhausted (the reference raises OutOfRange);
  * ``num_epochs``: when an epoch drains, the claim namespace rolls over
    (take() keeps the reference's "queue is re-filled num_epochs times"
    behaviour);
  * claim state lives on disk → checkpoint/restore of the queue is free
    (the reference saves queue contents through its Saveable).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Iterator, List, Optional, Sequence


class WorkQueue:
    """Elastic work-item queue over a shared directory (or in-memory)."""

    def __init__(
        self,
        items: Sequence[str],
        path: Optional[str] = None,
        num_epochs: int = 1,
        worker: str = "",
    ):
        if not items:
            raise ValueError("WorkQueue needs at least one work item")
        self.items = list(items)
        self.num_epochs = num_epochs
        self.path = path
        self.worker = worker or f"pid{os.getpid()}"
        self._lock = threading.Lock()
        self._mem_claims: set = set()
        self._cursor = 0  # scan position (optimisation only; claims decide)
        if path:
            os.makedirs(os.path.join(path, "claims"), exist_ok=True)
            manifest = os.path.join(path, "items.json")
            if not os.path.exists(manifest):
                tmp = manifest + f".tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump({"items": self.items,
                               "num_epochs": num_epochs}, f)
                try:
                    os.rename(tmp, manifest)
                except OSError:
                    os.unlink(tmp)
            with open(manifest) as f:
                m = json.load(f)
            if m["items"] != self.items:
                raise ValueError("WorkQueue directory was initialised with "
                                 "different items")

    # -- claims ----------------------------------------------------------
    def _claim_name(self, epoch: int, idx: int) -> str:
        return f"e{epoch:04d}-i{idx:06d}"

    def _try_claim(self, epoch: int, idx: int) -> bool:
        name = self._claim_name(epoch, idx)
        if self.path is None:
            with self._lock:
                if name in self._mem_claims:
                    return False
                self._mem_claims.add(name)
                return True
        try:
            fd = os.open(os.path.join(self.path, "claims", name),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.write(fd, self.worker.encode())
        os.close(fd)
        return True

    def take(self) -> Optional[str]:
        """Claim and return the next work item, or None when all epochs are
        exhausted (the OutOfRange analog)."""
        n = len(self.items)
        total = n * self.num_epochs
        while self._cursor < total:
            pos = self._cursor
            self._cursor += 1
            epoch, idx = divmod(pos, n)
            if self._try_claim(epoch, idx):
                return self.items[idx]
        return None

    def __iter__(self) -> Iterator[str]:
        while True:
            item = self.take()
            if item is None:
                return
            yield item

    # -- introspection -----------------------------------------------------
    def claimed(self) -> int:
        if self.path is None:
            return len(self._mem_claims)
        return len(os.listdir(os.path.join(self.path, "claims")))

    def water_level(self) -> float:
        """Fraction of all work claimed (the add_summary water-level metric,
        python/ops/work_queue.py add_summary)."""
        return self.claimed() / (len(self.items) * self.num_epochs)

    def reset(self):
        """Drop all claims (a fresh run over the same directory)."""
        if self.path is None:
            with self._lock:
                self._mem_claims.clear()
        else:
            d = os.path.join(self.path, "claims")
            for f in os.listdir(d):
                os.unlink(os.path.join(d, f))
        self._cursor = 0

    # -- checkpoint state ---------------------------------------------------
    # The reference WorkQueue is a SaveableObject: queue position lives IN
    # the training checkpoint (python/ops/work_queue.py:113), so restoring
    # an older checkpoint rewinds the data position consistently with the
    # table state — work claimed between that save and a crash is re-served,
    # not silently skipped. Attach to a CheckpointManager:
    #     mgr.attach_aux("workqueue", q.snapshot, q.restore_snapshot)

    def snapshot(self) -> dict:
        """Claim state at this instant (JSON-safe)."""
        if self.path is None:
            with self._lock:
                claims = sorted(self._mem_claims)
        else:
            claims = sorted(os.listdir(os.path.join(self.path, "claims")))
        return {"claims": claims, "items": self.items,
                "num_epochs": self.num_epochs}

    def restore_snapshot(self, snap: dict) -> None:
        """Rewind the claim namespace to EXACTLY a snapshot's state.

        Run from ONE process before workers resume (the reference's queue
        restore also happens on the PS hosting the queue). Claims taken
        after the snapshot are released (their items will be re-served);
        claims present in the snapshot are re-asserted."""
        if snap.get("items", self.items) != self.items:
            raise ValueError("WorkQueue snapshot was taken over different "
                             "items")
        want = set(snap["claims"])
        if self.path is None:
            with self._lock:
                self._mem_claims = set(want)
        else:
            d = os.path.join(self.path, "claims")
            have = set(os.listdir(d))
            for name in have - want:
                os.unlink(os.path.join(d, name))
            for name in want - have:
                with open(os.path.join(d, name), "w") as f:
                    f.write(self.worker)
        self._cursor = 0  # rescan; claims decide


def input_producer(queue: WorkQueue, reader, *reader_args, **reader_kwargs):
    """Chain a WorkQueue with a per-item batch reader: yields batches from
    each claimed item in turn (the work_queue.input_producer analog —
    reference python/ops/work_queue.py).

    ``reader(item, *args, **kwargs)`` must return a batch iterator (e.g.
    :func:`deeprec_tpu.data.criteo.read_criteo`).
    """
    for item in queue:
        yield from reader(item, *reader_args, **reader_kwargs)
