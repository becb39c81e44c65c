"""Host → device data pipeline: threaded batch loading and a prefetch onto
the card on a side stream.  Counterpart of ``vst_tpu/data/pipeline.py``.

- ``BatchLoader`` — the JAX package's shuffling batcher, the same order
  for the same seed, with a thread pool for sample loading (PIL and numpy
  release the GIL).
- ``device_prefetch`` — keeps ``size`` batches in flight: pinned host
  copies sent to the card on a CUDA side stream, so the step never waits
  on a host-to-device copy.

A batch's loading (the pool's samples and their stack) runs in the span
"vst::data.load", its pinning and copies in "vst::data.upload"
(``utils/profiling.py::span``), both on the consumer's thread and closed
before the batch is yielded.
"""

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vst_tpu_torch.utils.profiling import span


class BatchLoader:
    """Iterate minibatches of stacked numpy arrays over an epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, drop_last: bool = True,
                 epoch: int = 0, start_batch: int = 0,
                 process_id: int = 0, num_processes: int = 1):
        """``epoch`` seeds the dataset's per-item randomness (set_epoch) for
        the first iteration; callers constructing one loader per epoch (as
        run_training does) pass the epoch number so crops and style picks
        differ across epochs yet stay reproducible.

        ``start_batch``: skip the first k batches of the (deterministic,
        seed-derived) shuffle at the index level — no samples are decoded
        for skipped batches.  Mid-epoch resume after preemption: the
        remaining iteration is exactly the tail of the uninterrupted
        epoch.

        ``process_id``/``num_processes``: multi-process data loading.
        ``batch_size`` stays the global batch; each process decodes only
        its ``batch_size/num_processes`` slice of every global batch (the
        shuffle is seed-derived, so all processes agree on the global
        order with no communication).  Batch count, start_batch and epoch
        are in global terms."""
        if batch_size % num_processes:
            raise ValueError(f"batch_size {batch_size} must divide by "
                             f"num_processes {num_processes}")
        if num_processes > 1 and not drop_last:
            # a short final batch would slice unequal or empty shards
            raise ValueError("drop_last=False is incompatible with "
                             "multi-process loading")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.drop_last = drop_last
        self._epoch = epoch
        self.start_batch = start_batch
        self.process_id = process_id
        self.num_processes = num_processes

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        first = min(self.start_batch, n_batches)
        self.start_batch = 0  # one-shot: later iterations run the full epoch
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers else None
        try:
            for b in range(first, n_batches):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                if self.num_processes > 1:
                    lb = self.batch_size // self.num_processes
                    idxs = idxs[self.process_id * lb:
                                (self.process_id + 1) * lb]
                with span("vst::data.load"):
                    if pool is not None:
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idxs))
                    else:
                        samples = [self.dataset[i] for i in idxs]
                    if isinstance(samples[0], tuple):
                        batch = tuple(np.stack(parts)
                                      for parts in zip(*samples))
                    else:
                        batch = np.stack(samples)
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def _map(fn, batch):
    return tuple(map(fn, batch)) if isinstance(batch, tuple) else fn(batch)


def _leaves(batch):
    return batch if isinstance(batch, tuple) else (batch,)


def device_prefetch(iterator, size: int = 2, device="cuda"):
    """Wrap a host batch iterator (numpy arrays, or tuples of them), keeping
    ``size`` batches in flight to ``device`` ahead of consumption.

    On the card each batch is copied into pinned host memory and sent with
    ``non_blocking`` copies on a side stream.  Before a batch is yielded the
    consumer's current stream waits on its copy, and each of its tensors is
    marked as used by that stream (``record_stream``), so the caching
    allocator does not hand its memory to a later copy while the consumer's
    work may still read it.  The pinned source is kept until its copy has
    completed.  On the CPU the arrays only become tensors."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in iterator:
            with span("vst::data.upload"):
                batch = _map(torch.from_numpy, batch)
            yield batch
        return

    stream = torch.cuda.Stream(device=dev)
    in_flight = collections.deque()   # (device batch, pinned source, event)
    retired = collections.deque()     # pinned sources whose copy may run

    def put(batch):
        with span("vst::data.upload"):
            host = _map(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                        .pin_memory(), batch)
            with torch.cuda.stream(stream):
                out = _map(lambda h: h.to(dev, non_blocking=True), host)
                done = torch.cuda.Event()
                done.record(stream)
            return out, host, done

    it = iter(iterator)
    try:
        for _ in range(size):
            in_flight.append(put(next(it)))
    except StopIteration:
        pass
    try:
        while in_flight:
            out, host, done = in_flight.popleft()
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in _leaves(out):
                t.record_stream(consumer)
            retired.append((host, done))
            while retired and retired[0][1].query():
                retired.popleft()
            try:
                in_flight.append(put(next(it)))
            except StopIteration:
                pass
            yield out
    finally:
        for _, done in retired:
            done.synchronize()
        for _, _, done in in_flight:
            done.synchronize()
