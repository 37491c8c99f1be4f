"""Dataset protocol and a threaded prefetching loader.

cv2 and numpy release the GIL on the decode and resize path, so worker
threads overlap host IO with device work without worker processes. The
order is deterministic: with ``shuffle`` each epoch permutes the indices
with ``np.random.RandomState(seed + epoch)``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


class Dataset:
    """Minimal map-style dataset protocol."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, index: int) -> Any:  # pragma: no cover - interface
        raise NotImplementedError


def _collate(samples: Sequence[Any]) -> Any:
    first = samples[0]
    if isinstance(first, np.ndarray):
        return np.stack(samples, 0)
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, (int, float, np.floating, np.integer)):
        return np.asarray(samples)
    return list(samples)


class DataLoader:
    """Threaded prefetching loader. ``batch_size=None`` yields samples as
    they are; otherwise samples are collated by stacking.

    ``process_shard=(process_id, process_count)``: every process sees the
    same global batch order and loads only its ``batch_size /
    process_count`` slice of each batch.
    """

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 8,
                 process_shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.process_shard = process_shard
        if process_shard is not None and batch_size is not None:
            _, pc = process_shard
            if batch_size % pc != 0:
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"process_count {pc}")
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.batch_size is None:
            return n
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        if self.batch_size is None:
            return [[int(i)] for i in order]
        batches = [order[i:i + self.batch_size].tolist()
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.process_shard is not None:
            pid, pc = self.process_shard
            batches = [b[pid::pc] for b in batches]
        return batches

    def _load(self, b: List[int]) -> Any:
        samples = [self.dataset[i] for i in b]
        return samples[0] if self.batch_size is None else _collate(samples)

    def __iter__(self) -> Iterator[Any]:
        batches = self._index_batches()
        self._epoch += 1
        if self.num_workers == 0:
            for b in batches:
                yield self._load(b)
            return
        yield from self._threaded_iter(batches)

    def _threaded_iter(self, batches: List[List[int]]) -> Iterator[Any]:
        """Workers take batch positions in order and park results until the
        consumer reaches them; at most ``prefetch`` results wait at once. A
        worker's exception is raised in the consumer."""
        results: Dict[int, Any] = {}
        cond = threading.Condition()
        done = threading.Event()
        tasks: "queue.Queue" = queue.Queue()
        for pos, b in enumerate(batches):
            tasks.put((pos, b))
        errors: List[BaseException] = []
        slots = threading.Semaphore(self.prefetch)

        def worker():
            while not done.is_set():
                try:
                    pos, b = tasks.get_nowait()
                except queue.Empty:
                    return
                slots.acquire()
                if done.is_set():
                    return
                try:
                    out = self._load(b)
                except BaseException as e:  # raised in the consumer
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return
                with cond:
                    results[pos] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(len(batches)):
                with cond:
                    cond.wait_for(lambda: errors or pos in results)
                    if errors:
                        raise errors[0]
                    out = results.pop(pos)
                slots.release()
                yield out
        finally:
            done.set()
            for _ in threads:
                slots.release()  # unblock workers waiting for a slot
            for t in threads:
                t.join(timeout=1.0)
