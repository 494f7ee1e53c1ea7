"""Shared event-loop scaffolding for manager control components.

Every L3 component in the reference is a `Run(ctx)` goroutine over store
watches started on leadership (manager/manager.go:1093-1146). Here each is a
thread: snapshot-then-watch, dispatch events, periodic idle callback.

The port's copy of the JAX package's `orchestrator/base.py`.
"""
from __future__ import annotations

import logging
import threading

from ..store.memory import MemoryStore
from ..store.watch import ChannelClosed
from ..utils.leadership import leadership_lost

log = logging.getLogger("swarmkit_tpu_torch.orchestrator")


class EventLoopComponent:
    name = "component"
    # burst drain bound: after a blocking get, up to this many queued
    # events are consumed without sleeping before flush_events() runs —
    # batching components (the batched replicated orchestrator) coalesce
    # a mass-update storm into ONE vectorized pass per burst instead of
    # one store transaction per event
    MAX_DRAIN = 256

    def __init__(self, store: MemoryStore):
        self.store = store
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- subclass hooks ------------------------------------------------------
    def setup(self, tx):
        """Runs under the snapshot view; return value is passed to on_start."""

    def on_start(self, snapshot):
        """Initial reconcile after snapshot, before consuming events."""

    def handle(self, event):
        raise NotImplementedError

    def flush_events(self):
        """Called after each drained event burst (and before going back
        to blocking on the channel). Components that coalesce work
        across events (batched reconcile passes) apply it here."""

    def idle(self):
        """Called when no events arrived within the poll interval."""

    # -- loop ----------------------------------------------------------------
    def _run(self):
        snapshot, ch = self.store.view_and_watch(self.setup, limit=None)
        try:
            try:
                self.on_start(snapshot)
            except Exception as exc:
                if leadership_lost(exc):
                    # demoted before the initial reconcile committed: stop
                    # cleanly, the manager's leadership handler stop()s us
                    log.info("%s: leadership lost; stopping", self.name)
                    return
                # initial reconcile may fail transiently; the event loop
                # must still come up — events re-drive the state
                log.exception("%s: initial reconcile failed", self.name)
            while not self._stop.is_set():
                try:
                    ev = ch.get(timeout=0.2)
                except TimeoutError:
                    try:
                        self.idle()
                    except Exception as exc:
                        if leadership_lost(exc):
                            log.info("%s: leadership lost; stopping",
                                     self.name)
                            return
                        log.exception("%s: idle pass failed", self.name)
                    continue
                except ChannelClosed:
                    return
                closed = False
                drained = 1
                while True:
                    try:
                        self.handle(ev)
                    except Exception as exc:
                        if leadership_lost(exc):
                            log.info("%s: leadership lost; stopping",
                                     self.name)
                            return
                        log.exception("%s: error handling %r",
                                      self.name, ev)
                    # drain the burst without sleeping so flush_events
                    # sees the whole storm at once; never pop an event
                    # this burst won't handle (budget checked BEFORE
                    # the pop, or the 257th event would be dropped)
                    if drained >= self.MAX_DRAIN:
                        break
                    try:
                        ev = ch.try_get()
                    except ChannelClosed:
                        closed, ev = True, None
                    if ev is None:
                        break
                    drained += 1
                try:
                    self.flush_events()
                except Exception as exc:
                    if leadership_lost(exc):
                        log.info("%s: leadership lost; stopping", self.name)
                        return
                    log.exception("%s: flush pass failed", self.name)
                if closed:
                    return
        finally:
            self.store.queue.stop_watch(ch)
