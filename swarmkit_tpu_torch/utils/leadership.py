"""Demotion-tolerant store writes for leader-only component threads.

Every manager control component (role manager, key manager, CA signer,
orchestrators, …) runs as a thread started on leadership win and stopped
on leadership loss (reference manager/manager.go:1093-1149). Between the
raft step-down and the manager's stop() reaching the component there is a
window where a store write fails with ProposeError/NotLeader; the
reference components treat that as a normal shutdown signal and exit
cleanly (manager.go:1149+), never as a crash. These helpers give the
Python threads the same contract: `leadership_lost(exc)` classifies the
exception, `leader_write(store, txn)` returns False instead of raising
when leadership is gone mid-write.

The port's copy of the JAX package's `utils/leadership.py`.
"""
from __future__ import annotations

import logging

log = logging.getLogger("swarmkit_tpu_torch.leadership")


def _lost_types() -> tuple[type, ...]:
    # lazy: utils must not import raft at module load (raft imports utils).
    # NOTE: plain ProposeError (quorum-loss timeout, dropped proposal) is
    # deliberately NOT here — it can happen while still leading, and a
    # component that stops on it would never come back until the next
    # leadership change; only the structured demotion signals count.
    from ..raft.node import NotLeader
    from ..raft.proposer import LeadershipLost

    return (LeadershipLost, NotLeader)


def leadership_lost(exc: BaseException) -> bool:
    """True if `exc` means this manager stopped being the raft leader (or
    never was) — the component should stop cleanly, not crash."""
    return isinstance(exc, _lost_types())


def leader_write(store, txn, component: str = "") -> bool:
    """Run a leader-only store update. Returns True on commit, False when
    leadership was lost mid-write (logged at info — it is an expected
    shutdown signal, the manager's stop() is already on its way). Any
    other failure propagates."""
    try:
        store.update(txn)
        return True
    except Exception as exc:
        if leadership_lost(exc):
            log.info("%s: leadership lost during store write (%s)",
                     component or "component", exc)
            return False
        raise
