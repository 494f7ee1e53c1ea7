"""Broadcast watch queue (reference: watch/watch.go:20-186, watch/queue/queue.go).

Components subscribe with an optional matcher; `publish` fans events out to
per-subscriber unbounded deques guarded by one condition variable. A bounded
`limit` mirrors the reference's LimitQueue: a slow subscriber whose queue
exceeds the limit is closed rather than blocking publishers.

The port's copy of the JAX package's `store/watch.py`.
"""
from __future__ import annotations

import threading
from ..analysis.lockgraph import make_lock, make_rlock
from collections import deque
from typing import Any, Callable, Iterable

Matcher = Callable[[Any], bool]


class ChannelClosed(Exception):
    pass


class Channel:
    """One subscriber's event stream."""

    def __init__(self, matcher: Matcher | None, limit: int | None):
        self._matcher = matcher
        self._limit = limit
        self._events: deque[Any] = deque()
        self._cond = threading.Condition(make_rlock("store.watch.cond"))
        self._closed = False
        self._error: Exception | None = None

    def _raise_closed(self):
        exc = ChannelClosed(str(self._error) if self._error else "")
        exc.error = self._error   # cause, when the closer supplied one
        raise exc

    def _offer(self, event: Any) -> bool:
        """Returns False when the channel could not take the event — it
        was already closed, or this offer tripped the slow-subscriber
        limit. Publishers that track per-subscriber delivery state (the
        dispatcher's known-assignment maps) key off this so a shed
        subscriber's bookkeeping is never advanced past what it saw."""
        if self._matcher is not None and not self._matcher(event):
            return True            # filtered out, not a delivery failure
        with self._cond:
            if self._closed:
                return False
            if self._limit is not None and len(self._events) >= self._limit:
                # Slow-subscriber protection (watch/queue/queue.go LimitQueue).
                self._closed = True
                self._cond.notify_all()
                return False
            self._events.append(event)
            self._cond.notify_all()
            return True

    def _offer_many(self, events: list) -> None:
        """Batched fan-out: one matcher pass, ONE lock acquisition and ONE
        notify for the whole batch (the store publishes each commit's
        events as a batch, so this is the per-commit delivery path).
        Observable behavior matches per-event _offer calls, including the
        slow-subscriber close after exactly `limit` queued events."""
        m = self._matcher
        if m is not None:
            events = [e for e in events if m(e)]
            if not events:
                return
        with self._cond:
            if self._closed:
                return
            if self._limit is not None:
                room = self._limit - len(self._events)
                if len(events) > room:
                    self._events.extend(events[:room])
                    self._closed = True
                    self._cond.notify_all()
                    return
            self._events.extend(events)
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> Any:
        with self._cond:
            if not self._cond.wait_for(lambda: self._events or self._closed, timeout):
                raise TimeoutError("no event within timeout")
            if self._events:
                return self._events.popleft()
            self._raise_closed()

    def try_get(self) -> Any | None:
        with self._cond:
            if self._events:
                return self._events.popleft()
            if self._closed:
                self._raise_closed()
            return None

    def drain(self) -> list[Any]:
        with self._cond:
            out = list(self._events)
            self._events.clear()
            return out

    def wait_any(self, timeout: float | None = None) -> bool:
        """Block until at least one event is queued (or closed). True if events."""
        with self._cond:
            self._cond.wait_for(lambda: self._events or self._closed, timeout)
            if self._events:
                return True
            if self._closed:
                self._raise_closed()
            return False

    def close(self, error: Exception | None = None) -> None:
        """Close the stream; `error` (e.g. a server ERR on an RPC stream)
        is carried to consumers on the ChannelClosed they receive."""
        with self._cond:
            if error is not None and self._error is None:
                self._error = error
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return


class WatchQueue:
    """Fan-out publisher (reference: watch/watch.go Queue).

    The subscriber list is copy-on-write (a tuple swapped under `_lock`):
    `publish`/`publish_all` read one immutable snapshot with NO lock or
    copy on the hot path — at 10k subscribers the old list-copy-per-event
    dominated publish cost (the
    reference benches this exact fan-out, watch/watch_test.go:153-216)."""

    def __init__(self, default_limit: int | None = 10000):
        self._subs: tuple[Channel, ...] = ()
        self._lock = make_lock('store.watch.lock')
        self._default_limit = default_limit
        self._closed = False

    def watch(self, matcher: Matcher | None = None, limit: int | None = -1) -> Channel:
        if limit == -1:
            limit = self._default_limit
        ch = Channel(matcher, limit)
        with self._lock:
            if self._closed:
                ch.close()
            else:
                self._subs = self._subs + (ch,)
        return ch

    def callback_watch(self, cb: Callable[[Any], None], matcher: Matcher | None = None):
        """Synchronous-callback subscription (watch/watch.go CallbackWatch)."""

        class _CallbackChannel(Channel):
            def _offer(self, event):
                if matcher is not None and not matcher(event):
                    return True
                cb(event)
                return True

            def _offer_many(self, events):
                for event in events:
                    self._offer(event)

        ch = _CallbackChannel(None, None)
        with self._lock:
            self._subs = self._subs + (ch,)
        return ch

    def has_watchers(self) -> bool:
        """True when any subscriber would see a published event."""
        return bool(self._subs)

    def publish(self, event: Any) -> None:
        for ch in self._subs:
            ch._offer(event)

    def publish_all(self, events: Iterable[Any]) -> None:
        """Batched publish — what the store uses per commit: each
        subscriber pays one lock/notify per BATCH, not per event."""
        events = events if isinstance(events, list) else list(events)
        if not events:
            return
        for ch in self._subs:
            ch._offer_many(events)

    def stop_watch(self, ch: Channel) -> None:
        ch.close()
        with self._lock:
            if ch in self._subs:
                self._subs = tuple(c for c in self._subs if c is not ch)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            subs = self._subs
            self._subs = ()
        for ch in subs:
            ch.close()


def match_events(*predicates: Matcher) -> Matcher:
    """OR-combination matcher, mirroring state.Matcher(specifiers...)."""

    def matcher(event: Any) -> bool:
        return any(p(event) for p in predicates)

    return matcher
