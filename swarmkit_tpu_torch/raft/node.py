"""Raft node (the port's copy of the JAX package's `raft/node.py`; so far
only the exception that `utils/leadership.py` classifies)."""
from __future__ import annotations


class NotLeader(Exception):
    def __init__(self, leader_id: int | None, leader_addr: str | None = None):
        super().__init__(f"not the leader (leader={leader_id})")
        self.leader_id = leader_id
        self.leader_addr = leader_addr
