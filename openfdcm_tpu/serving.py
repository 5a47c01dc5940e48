"""Production serving: a warm, bank-resident matcher with micro-batching.

The reference is a library call per scene; production serving on an
accelerator wants the opposite shape: ONE process owns the device, keeps
the template bank and compiled executables resident, and batches
concurrent requests into scene-chunked dispatches (dispatch latency and
compile reuse weigh on throughput).  :class:`MatcherService` provides that:

- ``submit(scene) -> Future`` from any thread; a single dispatch thread
  collects requests for up to ``max_batch_delay_s`` (or until
  ``max_batch`` scenes are waiting) and runs them through one
  ``match_many`` call — identical results to calling it directly;
- shapes hit the same canvas/line buckets as the offline pipeline, so a
  warmed service never recompiles;
- ``warmup(example_scenes)`` pre-compiles the buckets the deployment
  expects (first-compile latency never lands on a request).

This is a deliberate superset of the reference's surface (it ships no
serving story); results remain reference-exact per scene.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import numpy as np

from .matching import featuremap as fm
from .matching.match import TemplateBank, prepare_templates
from .matching.pipeline import match_many

__all__ = ["MatcherService"]


class MatcherService:
    """A long-lived matching service around a fixed template bank.

    Parameters mirror :func:`openfdcm_tpu.match_many`; ``top_k`` is
    required (serving returns ranked results, never full candidate lists).
    """

    def __init__(self, templates, params: fm.Dt3Params, searcher, optimizer,
                 *, top_k: int, penalty=None, template_lengths=None,
                 mesh=None, max_batch: int = 16,
                 max_batch_delay_s: float = 0.005):
        self.bank: TemplateBank = (
            templates if isinstance(templates, TemplateBank)
            else prepare_templates(templates))
        self.params = params
        self.searcher = searcher
        self.optimizer = optimizer
        self.top_k = top_k
        self.penalty = penalty
        self.template_lengths = template_lengths
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_batch_delay_s = max_batch_delay_s
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="openfdcm-matcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, scene) -> Future:
        """Enqueue one scene; resolves to ``list[Match]`` (k best,
        ascending score)."""
        if self._closed.is_set():
            raise RuntimeError("MatcherService is closed")
        fut: Future = Future()
        self._queue.put((np.asarray(scene, np.float32), fut))
        return fut

    def match(self, scene, timeout: float | None = None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(scene).result(timeout)

    def warmup(self, example_scenes) -> None:
        """Pre-compile every shape bucket the given scenes exercise."""
        futs = [self.submit(s) for s in example_scenes]
        for f in futs:
            f.result()

    def close(self) -> None:
        self._closed.set()
        self._queue.put(None)           # wake the dispatcher
        self._thread.join(timeout=30)
        # fail any request that raced the shutdown instead of dropping it
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].cancelled():
                item[1].set_exception(RuntimeError("MatcherService closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _collect(self):
        """Block for one request, then drain more until the batch window
        closes or ``max_batch`` is reached."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        import time
        t_end = time.monotonic() + max(self.max_batch_delay_s, 0.0)
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                # zero delay still drains whatever is already queued —
                # concurrent submitters coalesce, a lone request never waits
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if item is None:
                self._queue.put(None)   # re-signal close after this batch
                break
            batch.append(item)
        return batch

    def _loop(self):
        while not self._closed.is_set():
            batch = self._collect()
            if batch is None:
                return
            scenes = [s for s, _ in batch]
            futs = [f for _, f in batch]
            try:
                results = match_many(
                    scenes, self.bank, self.params, self.searcher,
                    self.optimizer, penalty=self.penalty,
                    template_lengths=self.template_lengths,
                    top_k=self.top_k, mesh=self.mesh)
            except Exception as exc:  # noqa: BLE001 — fail the whole batch
                for f in futs:
                    if not f.cancelled():
                        f.set_exception(exc)
                continue
            for f, r in zip(futs, results):
                if not f.cancelled():
                    f.set_result(r)
