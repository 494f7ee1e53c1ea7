"""Raft proposer (the port's copy of the JAX package's `raft/proposer.py`;
so far only its exceptions, which `utils/leadership.py` classifies)."""
from __future__ import annotations


class ProposeError(Exception):
    pass


class LeadershipLost(ProposeError):
    """The proposal failed because this node is not (or stopped being) the
    raft leader — distinct from transient failures like a quorum-loss
    timeout, which may resolve while still leading. Leader-only component
    threads treat this as a clean-shutdown signal
    (utils/leadership.leadership_lost)."""
