"""Proposer seam between the store and consensus
(reference: manager/state/proposer.go:17-31).

The store never talks to raft directly; it hands a changelist to a Proposer
and commits locally only when the proposer confirms. `LocalProposer` is the
no-consensus stand-in used by single-manager tests (the analogue of
manager/state/testutils/mock_proposer.go MockProposer).

The port's copy of the JAX package's `state/proposer.py`.
"""
from __future__ import annotations

from typing import Callable, Protocol

from ..api.objects import Version


class Proposer(Protocol):
    def propose_value(self, actions,
                      commit_cb: Callable[..., None]) -> None:
        """Replicate `actions`; once committed, invoke
        commit_cb(version_index=<replicated index>) — the store stamps object
        versions from it so replicas agree. Must not return before commit_cb
        has run (raft.ProposeValue blocks on quorum)."""
        ...

    def get_version(self) -> Version:
        ...

    def changes_between(self, from_v: Version, to_v: Version) -> list:
        ...

    # Proposers may additionally offer `propose_async(actions, commit_cb)
    # -> handle` (handle.wait/result/done) — the non-blocking path the
    # store's pipelined Batch rides so depth-K transactions share one raft
    # group-commit flush. Callers feature-test with hasattr; the blocking
    # propose_value semantics above stay the contract.


class _CompletedProposal:
    """LocalProposer's propose_async handle: commit already happened."""

    done = True

    def wait(self, timeout=None) -> bool:
        return True

    def result(self, timeout=None) -> None:
        return None


class LocalProposer:
    """Versioning without consensus (MockProposer in the reference tests)."""

    def __init__(self):
        self._index = 0
        self._log: list[tuple[int, list]] = []

    def propose_value(self, actions, commit_cb: Callable[..., None]) -> None:
        self._index += 1
        self._log.append((self._index, list(actions)))
        commit_cb(version_index=self._index)

    def propose_async(self, actions, commit_cb: Callable[..., None]):
        self.propose_value(actions, commit_cb)
        return _CompletedProposal()

    def get_version(self) -> Version:
        return Version(self._index)

    def changes_between(self, from_v: Version, to_v: Version) -> list:
        return [
            actions for idx, actions in self._log
            if from_v.index < idx <= to_v.index
        ]
