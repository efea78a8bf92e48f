"""Host-side batched data loader with thread prefetch, and the upload of
its batches ahead of the device step.

Counterpart of ``bodyct_dram_emph_subtype_tpu/data/loader.py``
(``DataLoader``, ``default_collate``, ``prefetch_to_device``): loader
threads read and prepare samples, batches are prefetched ahead of the
device step, and :func:`prefetch_to_device` keeps the next batches' copies
to the device in flight while the current step runs.  On a CUDA device
:func:`pinned_collate` stacks the batches into pinned host memory in the
loader thread, and :class:`DeviceUploader` copies them on a stream of its
own (the JAX package leaves both to its runtime).
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import numpy as np
import torch

from ..utils.spans import span


def prefetch_to_device(iterator: Iterable, put_fn: Callable, size: int = 2):
    """Keep ``size`` batches in flight: ``put_fn`` (the upload) of batch
    n + size is called before batch n is yielded, so its copy overlaps the
    step on batch n.  Yields ``put_fn``'s results in order; stops when the
    iterator is exhausted and every queued batch has been yielded."""
    queue_: "collections.deque" = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            queue_.append(put_fn(next(it)))
    except StopIteration:
        pass
    while queue_:
        out = queue_.popleft()
        try:
            queue_.append(put_fn(next(it)))
        except StopIteration:
            pass
        yield out


class Upload:
    """Tensors of one batch on the device.  On a CUDA device their copies
    were enqueued on the uploader's stream; :meth:`ready` makes the current
    stream wait for them and tells the caching allocator that the current
    stream uses them.  The pinned host arrays stay referenced here while
    the caller holds the upload (the step that reads it is enqueued and
    run before the caller drops it)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event=None,
                 host=None, device=None):
        self.tensors = tensors
        self._event = event
        self._host = host
        self._device = device

    def ready(self) -> Dict[str, torch.Tensor]:
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            for t in self.tensors.values():
                t.record_stream(stream)
            self._event = None
        return self.tensors


class DeviceUploader:
    """``put_fn`` for :func:`prefetch_to_device`: a dict of host arrays ->
    :class:`Upload`.  On a CUDA device the arrays are put in pinned memory
    (left as they are when :func:`pinned_collate` already put them there),
    copied with ``non_blocking=True`` on a dedicated copy stream, and an
    event is recorded behind the copies; on the CPU they become tensors
    without a copy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, arrays: Dict[str, Any]) -> Upload:
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in arrays.items()}
        if self.stream is None:
            return Upload({k: t.to(self.device) for k, t in host.items()})
        host = {k: t if t.is_pinned() else t.pin_memory()
                for k, t in host.items()}
        with torch.cuda.stream(self.stream):
            tensors = {k: t.to(self.device, non_blocking=True)
                       for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return Upload(tensors, event, host, self.device)


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields, list the rest (uid strings etc.)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, (np.ndarray, np.generic)) or hasattr(first, "__array__"):
            out[key] = np.stack([np.asarray(v) for v in vals])
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def pinned_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """:func:`default_collate` whose stacked numeric arrays live in pinned
    host memory (numpy views of pinned tensors, which keep them alive), so
    the upload to a CUDA device copies them without staging."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) and vals[0].dtype.kind in "biuf":
            dtype = torch.from_numpy(np.empty(0, vals[0].dtype)).dtype
            buf = torch.empty((len(vals), *vals[0].shape), dtype=dtype,
                              pin_memory=True).numpy()
            for i, v in enumerate(vals):
                buf[i] = v
            out[key] = buf
        else:
            out.update(default_collate([{key: v} for v in vals]))
    return out


class DataLoader:
    """Iterates ``dataset`` over ``indices`` in batches, ``num_workers``
    threads reading samples and up to ``PREFETCH`` batches ahead;
    ``drop_last`` drops a short final batch (the training loader);
    ``collate`` stacks a batch (in the producer thread).  The consumer's
    time blocked on the next batch is a ``wait.loader`` span
    (``utils/spans.py``), added to ``counters`` when given."""

    PREFETCH = 2

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 batch_size: int = 1, num_workers: int = 4,
                 drop_last: bool = False,
                 collate: Callable = default_collate,
                 counters: Optional[Dict[str, float]] = None):
        self.dataset = dataset
        self.indices = indices
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate = collate
        self.counters = counters

    def _index_batches(self) -> List[List[int]]:
        idx = (list(self.indices) if self.indices is not None
               else list(range(len(self.dataset))))
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self):
        return len(self._index_batches())

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                # pipeline the per-sample fetches, preserve batch order
                futures = [
                    [pool.submit(self.dataset.__getitem__, i) for i in b]
                    for b in batches]
                for fb in futures:
                    if stop.is_set():
                        for f in fb:
                            f.cancel()
                        continue
                    try:
                        q.put(self.collate([f.result() for f in fb]))
                    except Exception as exc:  # surface in consumer
                        q.put(exc)
                        break
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                with span("wait.loader", self.counters):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
