"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``).

Batches are collated on the host by ``collate_fn`` (``default_collate_fn``:
numpy stacks, tensor stacks, dicts and tuples of them) and handed out as
tensors on the loader's device (``places``, default the current device,
``device.set_device``): float64 host data becomes the default float
dtype, as in the JAX package.

Three ways to make the host batches, chosen per epoch as the JAX package
chooses them:

- ``num_workers > 0`` over a map-style dataset with a batch sampler and
  ``use_shared_memory`` (fork available, the ring's library built): W
  forked worker processes, worker w collating batches w, w+W, ... into
  its own shared-memory ring (``io/shm_ring.py``); the consumer pops
  ring ``seq % W``, so batches come in sampler order.  A worker killed
  without a word (an OOM kill) is seen by polling its liveness; with
  ``worker_restarts`` (default ``PADDLE_TPU_WORKER_RESTARTS``, else 0) it
  is forked again on a fresh ring from the first batch the consumer has
  not received, otherwise a ``RuntimeError`` names it.  A dataset or
  collate error comes back with its traceback and is never retried.
- otherwise ``num_workers > 0`` with ``use_buffer_reader``: threads
  collate into a bounded reorder buffer (``_Prefetcher``);
- otherwise the batches are made in this process.

Fork caveat (the JAX package's too): a worker is a fork of a process that
may hold a CUDA context and other threads.  ``__getitem__``,
``collate_fn`` and ``worker_init_fn`` must stay on the host (numpy, or
torch CPU tensors) and touch no CUDA tensor; each worker runs torch on
one intra-op thread.  Workers are forked anew every epoch.

``worker_stats`` describes the loader's last epoch: its mode
(``"processes"``, ``"threads"`` or ``"main"``), and for worker
processes their pids, the ms each fork took, frames popped and the pids
of the processes they came from, the ms of each pop and unpickle,
restarts and the rings' names; in every mode the host ms of each batch's
move to the device (``h2d_ms``).
"""
from __future__ import annotations

import itertools
import os
import threading
import time

import numpy as np
import torch

from ..core.dtype import default_float_dtype
from ..device import current_device, resolve_device
from ..testing import faults
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "WorkerInfo",
           "get_worker_info"]


def default_collate_fn(batch):
    """Stack a list of samples into batch arrays (tensors stay
    tensors)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if torch.is_tensor(sample):
        return torch.stack(batch, dim=0)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(f)) for f in zip(*batch))
    return np.asarray(batch)


class _Prefetcher:
    """Thread workers collating into a bounded reorder buffer, handed out
    in order.

    - Backpressure: a worker waits while results plus in-flight tasks
      fill ``capacity``.
    - An error of the batch iterator itself reaches the consumer (a
      worker that died on it would leave the consumer waiting).
    - Leaving the loop early (``break``, GeneratorExit) sets the stop
      flag, wakes every worker and joins them.
    """

    def __init__(self, make_batch_iter, num_workers, capacity):
        self._make_iter = make_batch_iter
        self._num_workers = max(1, num_workers)
        self._capacity = max(1, capacity)

    def __iter__(self):
        task_iter = enumerate(self._make_iter())
        cond = threading.Condition()
        iter_lock = threading.Lock()  # serializes next(task_iter) only
        results = {}  # seq -> collated batch or the exception it raised
        state = {"done": False, "stop": False, "inflight": 0,
                 "next_emit": 0, "iter_error": None}

        def worker():
            while True:
                with cond:
                    # take an in-flight slot before pulling a task, so the
                    # consumer's done-and-drained check stays sound while
                    # this worker holds only the iterator lock
                    while (not state["stop"] and not state["done"] and
                           len(results) + state["inflight"] >=
                           self._capacity):
                        cond.wait(timeout=0.1)
                    if state["stop"] or state["done"]:
                        return
                    state["inflight"] += 1
                # pulled outside the condition lock: a slow iterator must
                # not keep the consumer from batches already collated
                got, err = False, None
                with iter_lock:
                    try:
                        seq, thunk = next(task_iter)
                        got = True
                    except StopIteration:
                        pass
                    except BaseException as e:  # delivered to the consumer
                        err = e
                if not got:
                    with cond:
                        if err is not None:
                            state["iter_error"] = err
                        state["done"] = True
                        state["inflight"] -= 1
                        cond.notify_all()
                    return
                try:
                    res = thunk()
                except BaseException as e:  # delivered to the consumer
                    res = e
                with cond:
                    results[seq] = res
                    state["inflight"] -= 1
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"pd-prefetch-{i}")
                   for i in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                with cond:
                    while True:
                        if state["next_emit"] in results:
                            res = results.pop(state["next_emit"])
                            state["next_emit"] += 1
                            cond.notify_all()  # frees a worker's slot
                            break
                        if state["done"] and state["inflight"] == 0:
                            if state["iter_error"] is not None:
                                raise state["iter_error"]
                            return
                        cond.wait(timeout=0.1)
                if isinstance(res, BaseException):
                    raise res
                yield res
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()
            for t in threads:
                t.join(timeout=5)


class _WorkerDied(Exception):
    def __init__(self, w, seq, exitcode):
        super().__init__(w, seq, exitcode)
        self.w, self.seq, self.exitcode = w, seq, exitcode


class _MultiprocessIter:
    """Fork workers over shared-memory rings: worker w collates batches
    w, w+W, ... and pushes each as a pickled frame into its own ring; the
    consumer pops ring ``seq % W``, so batches keep the sampler's order
    with no reorder buffer.  ``stats`` (the loader's ``worker_stats``)
    receives the pids, fork ms, pop and unpickle ms and restarts."""

    def __init__(self, loader, batch_lists, num_workers, capacity_bytes,
                 timeout_ms, worker_init_fn=None, worker_restarts=0,
                 stats=None):
        self.loader = loader
        self.batch_lists = batch_lists
        self.num_workers = num_workers
        self.capacity = capacity_bytes
        self.timeout_ms = timeout_ms
        self.worker_init_fn = worker_init_fn
        # revives a worker may take after a crash-style death (a kill, a
        # segfault); a dataset error is deterministic and never retried
        self.worker_restarts = max(0, int(worker_restarts))
        self.stats = stats if stats is not None else {}

    def __iter__(self):
        import multiprocessing as mp
        import pickle
        import shutil
        import tempfile
        import traceback as tb_mod

        from .shm_ring import RingClosed, RingTimeout, ShmRing

        ctx = mp.get_context("fork")
        W = self.num_workers
        stats = self.stats
        ds, collate = self.loader.dataset, self.loader.collate_fn
        init_fn = self.worker_init_fn
        rings = []
        procs = [None] * W
        # a worker spills its traceback here too: the error frame's push
        # can itself fail (ring full or torn down)
        err_dir = tempfile.mkdtemp(prefix="pd_dl_err_")
        err_path = [os.path.join(err_dir, f"worker{w}.err")
                    for w in range(W)]

        def work(w, ring_name, batches):
            torch.set_num_threads(1)
            ring = ShmRing.attach(ring_name)
            done = 0
            try:
                _set_worker_info(WorkerInfo(w, W, ds))
                if init_fn is not None:
                    init_fn(w)
                for idxs in batches:
                    payload = pickle.dumps(
                        ("b", collate([ds[i] for i in idxs])),
                        protocol=pickle.HIGHEST_PROTOCOL)
                    ring.push(payload)
                    done += 1
                    faults.maybe_kill_worker(w, done)
            except Exception:
                trace = tb_mod.format_exc()
                try:
                    with open(err_path[w], "w") as f:
                        f.write(trace)
                except OSError:
                    pass
                try:
                    ring.push(pickle.dumps(("e", trace)))
                except Exception:  # the spill file carries the traceback
                    pass
            finally:
                ring.close_writer()

        def spawn(w, skip):
            """Fork worker w from its skip-th batch."""
            p = ctx.Process(target=work,
                            args=(w, rings[w].name,
                                  self.batch_lists[w::W][skip:]),
                            daemon=True)
            t0 = time.perf_counter()
            p.start()
            stats["fork_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["pids"].append(p.pid)
            return p

        def pop_watched(seq):
            """Pop with liveness polling: a SIGKILLed worker never closes
            its ring, so the pop waits in slices and checks the process
            between them."""
            w = seq % W
            deadline = (time.monotonic() + self.timeout_ms / 1000.0) \
                if self.timeout_ms and self.timeout_ms > 0 else None
            while True:
                try:
                    return rings[w].pop(timeout_ms=500)
                except RingTimeout:
                    if not procs[w].is_alive():
                        # it may have exited cleanly after pushing this
                        # batch: drain once more before calling it dead
                        try:
                            return rings[w].pop(timeout_ms=100)
                        except (RingTimeout, RingClosed):
                            raise _WorkerDied(w, seq, procs[w].exitcode)
                except RingClosed:
                    raise _WorkerDied(w, seq, procs[w].exitcode)
                if deadline and time.monotonic() > deadline:
                    raise RuntimeError(f"dataloader worker {w} timed out")

        def worker_error(w):
            """The traceback worker w spilled, if any."""
            try:
                with open(err_path[w]) as f:
                    return f.read().strip() or None
            except OSError:
                return None

        produced = [0] * W  # batches the consumer popped from each worker
        revives = [self.worker_restarts] * W

        def revive_or_raise(dead):
            w = dead.w
            trace = worker_error(w)
            if trace is not None:
                raise RuntimeError(f"dataloader worker {w} failed:\n{trace}")
            if revives[w] <= 0:
                raise RuntimeError(
                    f"dataloader worker {w} died before producing batch "
                    f"{dead.seq} (exitcode {dead.exitcode}, "
                    f"{self.worker_restarts} restart(s) exhausted)")
            revives[w] -= 1
            stats["restarts"] += 1
            procs[w].join(5)
            # the old ring may hold frames never popped, or half a frame
            # from the kill: a new ring, refilled from the consumer's
            # high-water mark
            rings[w].destroy()
            rings[w] = ShmRing.create(self.capacity)
            stats["rings"].append(rings[w].name)
            procs[w] = spawn(w, produced[w])

        try:
            for _ in range(W):
                rings.append(ShmRing.create(self.capacity))
                stats["rings"].append(rings[-1].name)
            for w in range(W):
                procs[w] = spawn(w, 0)
            for seq in range(len(self.batch_lists)):
                w = seq % W
                t0 = time.perf_counter()
                while True:
                    try:
                        raw = pop_watched(seq)
                        break
                    except _WorkerDied as dead:
                        revive_or_raise(dead)
                t1 = time.perf_counter()
                kind, payload = pickle.loads(raw)
                del raw
                stats["pop_ms"].append((t1 - t0) * 1e3)
                stats["unpickle_ms"].append((time.perf_counter() - t1) * 1e3)
                if kind == "e":
                    raise RuntimeError(
                        f"dataloader worker {w} failed:\n{payload}")
                produced[w] += 1
                stats["popped"] += 1
                stats["producers"].add(procs[w].pid)
                yield payload
        finally:
            for p in procs:
                if p is not None and p.is_alive():
                    p.terminate()
            for p in procs:
                if p is not None:
                    p.join(5)
            for r in rings:
                r.destroy()
            shutil.rmtree(err_dir, ignore_errors=True)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, shm_ring_capacity=32 << 20,
                 worker_restarts=None):
        self.dataset = dataset
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        if worker_restarts is None:
            worker_restarts = int(os.environ.get(
                "PADDLE_TPU_WORKER_RESTARTS", "0"))
        self.worker_restarts = max(0, int(worker_restarts))
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.shm_ring_capacity = shm_ring_capacity
        self.worker_stats = {}
        self._iterable_ds = isinstance(dataset, IterableDataset)
        if self._iterable_ds:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _to_tensors(self, collated, device):
        if isinstance(collated, dict):
            return {k: self._to_tensors(v, device)
                    for k, v in collated.items()}
        if isinstance(collated, (tuple, list)):
            return [self._to_tensors(v, device) for v in collated]
        if isinstance(collated, np.ndarray):
            collated = torch.from_numpy(np.ascontiguousarray(collated))
            if collated.dtype == torch.float64:
                collated = collated.to(default_float_dtype())
        if torch.is_tensor(collated):
            return collated.to(device, non_blocking=True)
        return collated

    def _batch_thunks(self):
        """Zero-argument thunks, each making one collated host batch."""
        collate = self.collate_fn
        ds = self.dataset
        if self._iterable_ds:
            def gen():
                it = iter(ds)
                while True:
                    batch = list(itertools.islice(it, self.batch_size))
                    if not batch or (len(batch) < self.batch_size
                                     and self.drop_last):
                        return
                    yield lambda b=batch: collate(b)
            return gen()
        if self.batch_sampler is None:
            return (lambda i=i: collate([ds[i]]) for i in range(len(ds)))
        return (lambda idxs=idxs: collate([ds[i] for i in idxs])
                for idxs in self.batch_sampler)

    def _can_multiprocess(self) -> bool:
        if (self.num_workers <= 0 or not self.use_shared_memory or
                self._iterable_ds or self.batch_sampler is None):
            return False
        import multiprocessing as mp
        if "fork" not in mp.get_all_start_methods():
            return False
        from .shm_ring import available
        return available()

    def __iter__(self):
        device = current_device() if self.places is None \
            else resolve_device(self.places)
        if self._can_multiprocess():
            stats = self.worker_stats = {
                "mode": "processes", "workers": self.num_workers,
                "pids": [], "fork_ms": [], "popped": 0, "producers": set(),
                "pop_ms": [], "unpickle_ms": [], "restarts": 0,
                "rings": [], "h2d_ms": []}
            source = _MultiprocessIter(
                self, list(self.batch_sampler), self.num_workers,
                self.shm_ring_capacity,
                int(self.timeout * 1000) if self.timeout else -1,
                self.worker_init_fn, worker_restarts=self.worker_restarts,
                stats=stats)
        elif self.num_workers > 0 and self.use_buffer_reader:
            stats = self.worker_stats = {
                "mode": "threads", "workers": self.num_workers, "h2d_ms": []}
            source = _Prefetcher(
                self._batch_thunks, self.num_workers,
                capacity=self.prefetch_factor * max(1, self.num_workers))
        else:
            stats = self.worker_stats = {"mode": "main", "h2d_ms": []}
            source = (thunk() for thunk in self._batch_thunks())
        for collated in source:
            t0 = time.perf_counter()
            batch = self._to_tensors(collated, device)
            stats["h2d_ms"].append((time.perf_counter() - t0) * 1e3)
            yield batch

    def __call__(self):
        return self.__iter__()


class WorkerInfo:
    """``id``, ``num_workers`` and ``dataset`` of a worker process, as
    ``get_worker_info()`` returns them inside it."""

    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset

    def __repr__(self):
        return f"WorkerInfo(id={self.id}, num_workers={self.num_workers})"


_WORKER_INFO = None


def get_worker_info():
    """The ``WorkerInfo`` inside a DataLoader worker process, None in the
    main process."""
    return _WORKER_INFO


def _set_worker_info(info):
    global _WORKER_INFO
    _WORKER_INFO = info
