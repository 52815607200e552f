"""Host-side batch loader (copied from ``list_tpu/data/loader.py``).

Replaces ``torch.utils.data.DataLoader(batch_size, shuffle=True,
num_workers=4, drop_last=True)`` (reference: train.py:136-140) with a
thread-prefetching batcher producing numpy dict batches ready for device
put.  Threads (not processes) because the heavy per-item work is h5py/PIL/
NumPy which releases the GIL; a bounded queue gives pipeline parallelism
with the accelerator step.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        vals = [np.asarray(it[k]) for it in items]
        out[k] = np.stack(vals, axis=0)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 333, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        batches = []
        for s in range(0, len(idx), self.batch_size):
            b = idx[s:s + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                continue
            batches.append(list(b))
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        if not batches:
            return
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        task_q: 'queue.Queue' = queue.Queue()
        results: Dict[int, Dict] = {}
        results_lock = threading.Lock()
        stop = threading.Event()

        for i, b in enumerate(batches):
            task_q.put((i, b))

        def worker():
            while not stop.is_set():
                try:
                    i, b = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = collate([self.dataset[j] for j in b])
                except Exception as e:  # surface loader errors to the consumer
                    batch = e
                with results_lock:
                    results[i] = batch

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                while True:
                    with results_lock:
                        if i in results:
                            batch = results.pop(i)
                            break
                    threading.Event().wait(0.002)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
