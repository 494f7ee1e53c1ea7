"""Lock factory (the port's copy of the JAX package's `analysis/lockgraph.py`,
cut down to what the commit plane uses).

The reference's factories hand out plain `threading` locks unless its
lock-order detector is armed. The port carries only the disarmed
behaviour: `make_lock()` and `make_rlock()` return a plain
`threading.Lock`/`RLock`, and the name records what the lock guards.
"""
from __future__ import annotations

import threading


def make_lock(name: str = "lock"):
    """A plain `threading.Lock`; `name` says what it guards."""
    return threading.Lock()


def make_rlock(name: str = "rlock"):
    """A plain `threading.RLock`; `name` says what it guards."""
    return threading.RLock()
