"""Host-side data pipeline (port of the JAX package's data/pipeline.py).

Samples are numpy dicts, built inline (``num_workers=0``) or on a thread
pool with a small prefetch queue, and collated into numpy batches; the
harness moves them to the device. With ``cache_device`` the whole dataset
is stacked once on ``device`` (string fields dropped) and each batch is
gathered there, in the order the host batches would come in.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device


def collate(samples: List[Optional[Dict[str, Any]]]
            ) -> Optional[Dict[str, Any]]:
    """Stack samples into a batch, dropping None samples; strings become
    lists."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    batch: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            batch[k] = vals
        else:
            batch[k] = np.stack([np.asarray(v) for v in vals])
    return batch


class DataLoader:
    """Minimal map-style loader: dataset[i] -> sample dict."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 1, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, n_epochs: Optional[int] = None,
                 cache_device: bool = False,
                 device: torch.device | str = "cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 0)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.n_epochs = n_epochs  # None = loop forever
        self.cache_device = cache_device
        self.device = device      # where cache_device keeps the dataset
        self._device_cache: Optional[Dict[str, torch.Tensor]] = None

    def _index_stream(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed)
        epoch = 0
        n = len(self.dataset)
        while self.n_epochs is None or epoch < self.n_epochs:
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(0, n - (self.batch_size - 1 if self.drop_last
                                   else 0), self.batch_size):
                yield [int(j) for j in order[i: i + self.batch_size]]
            epoch += 1

    def _ensure_device_cache(self, dev: torch.device
                             ) -> Dict[str, torch.Tensor]:
        if self._device_cache is None:
            items = [self.dataset[i] for i in range(len(self.dataset))]
            self._device_cache = {
                k: torch.from_numpy(np.stack(
                    [np.asarray(it[k]) for it in items])).to(dev)
                for k, v0 in items[0].items()
                if not isinstance(v0, (str, bytes))}
        return self._device_cache

    def __iter__(self) -> Iterator[Optional[Dict[str, Any]]]:
        if self.cache_device:
            dev = resolve_device(self.device)
            cache = self._ensure_device_cache(dev)
            for idxs in self._index_stream():
                ji = torch.as_tensor(idxs, device=dev)
                yield {k: v[ji] for k, v in cache.items()}
            return
        if self.num_workers == 0:
            for idxs in self._index_stream():
                yield collate([self.dataset[j] for j in idxs])
            return

        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        ex = ThreadPoolExecutor(max_workers=self.num_workers)

        def producer():
            try:
                for idxs in self._index_stream():
                    if stop.is_set():
                        return
                    q.put([ex.submit(self.dataset.__getitem__, j)
                           for j in idxs])
            finally:
                q.put(StopIteration)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is StopIteration:
                    return
                yield collate([f.result() for f in item])
        finally:
            stop.set()
            ex.shutdown(wait=False, cancel_futures=True)
