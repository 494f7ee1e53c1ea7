"""Lock factory and store-view hooks (the port's copy of the JAX package's
`analysis/lockgraph.py`, cut down to its disarmed behaviour).

The reference's factories hand out plain `threading` locks unless its
lock-order detector is armed. The port carries only the disarmed
behaviour: `make_lock()` and `make_rlock()` return a plain
`threading.Lock`/`RLock`, and the name records what the lock guards.
`_STATE` stays None, so the store's view bracket (`store/memory.py`
`_tracked_view`) runs its callback straight, and `view_enter`/`view_exit`
do nothing.
"""
from __future__ import annotations

import threading

# the armed detector's state; the port has no detector, so always None
_STATE = None


def make_lock(name: str = "lock"):
    """A plain `threading.Lock`; `name` says what it guards."""
    return threading.Lock()


def make_rlock(name: str = "rlock"):
    """A plain `threading.RLock`; `name` says what it guards."""
    return threading.RLock()


def view_enter() -> None:
    """Opens a store.view callback's hazard window (nothing while
    disarmed)."""


def view_exit() -> None:
    """Closes a store.view callback's hazard window (nothing while
    disarmed)."""
