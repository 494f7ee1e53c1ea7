"""Sustained-load tick pipeline: hide the counts' copy to the host under
host work, up to `depth` waves deep (the port of the JAX package's
`ops/pipeline.py`, with the synchronous commit).

At depth 1 a wave runs in this order:

  wave k:   pull counts(k-1)            <- the copy ran in the background
            fold_counts(k-1)            <- vectorized encoder fold; all the
                                           next encode() needs
            encode(k) + dispatch(k)     <- the fill and the counts copy run
                                           on the card asynchronously
            commit(k-1)                 <- the heavy host work runs WHILE
                                           counts(k) are under way
            restamp_counts(k-1)         <- fingerprint stamp after add_task

`depth=D` keeps D waves in flight. The card needs nothing from the host
between waves (its in-scan carry already folded every dispatched wave,
quantized); the host-side consequences of depth >= 2 are handled here:

  * encode(k) runs before waves k-D+1..k-1 folded into the encoder — legal
    because their add_task/restamp did not run either, so no node row looks
    dirty and nothing node-sized ships;
  * the problem emitted for wave k is stale by those pending waves;
    completion applies `encode.fold_problem` (the kernels' quantized fold)
    for each pending predecessor, in order, BEFORE the encoder fold, the
    oracle parity or the slot materialization consume it;
  * anything that would ship node rows mid-pipe would clobber the card's
    un-pulled folds, so the pipe DRAINS to serial first on: external node
    mutations (nodes_clean false), queued quantization corrections
    (resident pending rows), hypothetical service rows (row numbering is
    only stable once a fold allocates it), a full re-upload, or a
    fold_problem shape mismatch.

Placements stay bit-identical to the CPU oracle at every depth. The commit
runs on the calling thread; the JAX package's background commit worker
(`async_commit=True`) is not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np

from ..scheduler.encode import (
    EncodedProblem,
    IncrementalEncoder,
    fold_problem,
)
from .resident import ResidentPlacement

ASYNC_COMMIT_TODO = ("async_commit=True (the background commit worker, "
                     "ops/commit.py) is not ported yet (ROADMAP.md, queue 1: "
                     "binpack fill and the async commit plane)")


class TickPipeline:
    """Drives ResidentPlacement ticks with up to `depth` waves in flight.

    commit_cb(problem, counts) must perform EXACTLY one successful
    NodeInfo.add_task per placed task (the apply_counts contract) plus
    whatever store writes the caller needs; the pipeline brackets it with
    fold_counts (before the encoder next re-reads those arrays) and
    restamp_counts (after)."""

    def __init__(self, encoder: IncrementalEncoder,
                 resident: ResidentPlacement,
                 commit_cb: Callable[[EncodedProblem, np.ndarray], None],
                 depth: int = 1, async_commit: bool = False):
        if async_commit:
            raise NotImplementedError(ASYNC_COMMIT_TODO)
        self.encoder = encoder
        self.resident = resident
        self.commit_cb = commit_cb
        self.depth = max(1, depth)
        # (problem, handle, n_pending): n_pending = how many dispatched-
        # but-unfolded waves preceded this one at its encode time
        self._inflight: deque[tuple] = deque()
        # completed (problem, counts) pairs still needed as fold sources
        self._recent: deque[tuple] = deque(maxlen=max(1, self.depth - 1))
        self.timings: list[dict] = []      # per-wave phase seconds

    # ------------------------------------------------------------------ steps
    def _pull_oldest(self) -> tuple:
        """Pop the oldest in-flight wave and wait for its counts."""
        p, h, n_pending = self._inflight.popleft()
        t0 = time.perf_counter()
        counts = h.get()
        return p, counts, n_pending, time.perf_counter() - t0

    def _fold_pulled(self, p: EncodedProblem, counts: np.ndarray,
                     n_pending: int) -> float:
        """The completion: problem fold (deep pipe), encoder array fold,
        correction-row bookkeeping. Must precede the next encode()."""
        t0 = time.perf_counter()
        if n_pending:
            # bring the emitted problem up to the card's view: fold the
            # waves that were still in flight when it was encoded
            assert n_pending <= len(self._recent)
            for pp, cc in list(self._recent)[-n_pending:]:
                if not fold_problem(p, pp, cc):
                    # shapes moved under the pipe (the drain gates should
                    # prevent it): the card's carry is unusable
                    self.resident.invalidate()
                    break
        if not self.encoder.fold_counts(p, counts):
            # node set diverged under us: the card's carry is unusable
            self.resident.invalidate()
        self.resident.after_apply(p, counts)
        self._recent.append((p, counts))
        return time.perf_counter() - t0

    def _complete(self) -> tuple[EncodedProblem, np.ndarray, dict] | None:
        """Pull + problem-fold + encoder-fold the OLDEST in-flight wave;
        the commit stays with the caller."""
        if not self._inflight:
            return None
        p, counts, n_pending, pull_s = self._pull_oldest()
        fold_s = self._fold_pulled(p, counts, n_pending)
        return p, counts, {"pull_s": pull_s, "fold_s": fold_s}

    def _heavy(self, p: EncodedProblem, counts: np.ndarray) -> None:
        """The commit's heavy half: the caller's add_task/store work, then
        the fingerprint restamp."""
        self.commit_cb(p, counts)
        self.encoder.restamp_counts(p, counts)

    def _commit(self, p: EncodedProblem, counts: np.ndarray) -> float:
        t0 = time.perf_counter()
        self._heavy(p, counts)
        return time.perf_counter() - t0

    def _hazards(self) -> bool:
        """True when dispatching another wave PAST the current in-flight
        ones would ship node rows (queued quantization corrections — their
        row SET would clobber the card's un-pulled in-scan folds) or create
        ambiguous service-row numbering (hypothetical rows only become
        stable once a fold allocates them). Irrelevant at depth 1, where
        the pipe is always empty at dispatch time."""
        return bool(self.resident.pending_rows
                    or any(p.has_hypo_rows for p, _h, _n in self._inflight))

    # -------------------------------------------------------------------- API
    def tick(self, infos, groups, *, now=None, volume_set=None,
             ) -> list[tuple[EncodedProblem, np.ndarray]]:
        """Dispatch one wave; completes (commits) the oldest in-flight wave
        once the pipe is `depth` deep. Returns the waves completed by this
        call — empty while the pipe is filling, one in steady state, up to
        `depth` on a drain."""
        timing = {"pull_s": 0.0, "fold_s": 0.0, "dirty_scan_s": 0.0,
                  "commit_s": 0.0}
        t_wave = time.perf_counter()
        completed: list[tuple] = []
        # a completed-but-not-yet-committed wave (commits stay FIFO and are
        # never dropped: fold_counts already ran for it)
        deferred: tuple | None = None

        def commit_deferred():
            nonlocal deferred
            if deferred is not None:
                timing["commit_s"] += self._commit(*deferred)
                deferred = None

        def complete_oldest():
            p, c, t = self._complete()
            timing["pull_s"] += t["pull_s"]
            timing["fold_s"] += t["fold_s"]
            completed.append((p, c))
            return p, c

        def drain_serial():
            # the one drain sequence every trigger uses: the deferred wave
            # first (FIFO — it is the oldest), then complete and commit
            # everything left
            commit_deferred()
            while self._inflight:
                timing["commit_s"] += self._commit(*complete_oldest())

        # external node mutations: drain fully so dirty rows re-encode from
        # infos that already include every wave's tasks
        t0 = time.perf_counter()
        serial = bool(self._inflight) and not self.encoder.nodes_clean(infos)
        timing["dirty_scan_s"] += time.perf_counter() - t0
        if serial:
            drain_serial()
        else:
            if len(self._inflight) >= self.depth:
                deferred = complete_oldest()
            # hazards may have been CREATED by that completion (e.g.
            # after_apply queued corrections): re-check before dispatching
            # past anything still in flight
            if self._inflight and self._hazards():
                serial = True
                drain_serial()

        t0 = time.perf_counter()
        p = self.encoder.encode(infos, groups, now=now, volume_set=volume_set)
        if self._inflight and self.resident.needs_full_upload(p):
            # bucket/vocab growth (new generic kind, node remap, stale
            # carry) forces a full re-upload, which would be built from
            # host arrays missing the in-flight waves' folds: drain, then
            # re-encode against the folded state
            serial = True
            drain_serial()
            p = self.encoder.encode(infos, groups, now=now,
                                    volume_set=volume_set)
        timing["encode_s"] = time.perf_counter() - t0
        # the scan part of encode() (sort + fingerprint compare) is its own
        # stage
        timing["dirty_scan_s"] += self.encoder.last_scan_s
        timing["encode_s"] = max(
            0.0, timing["encode_s"] - self.encoder.last_scan_s)
        t0 = time.perf_counter()
        h = self.resident.schedule_async(p)
        timing["dispatch_s"] = time.perf_counter() - t0
        self._inflight.append((p, h, len(self._inflight)))

        # the completed wave's heavy half runs now, after encode+dispatch
        # stopped reading host state for this tick, while this wave's
        # counts are under way
        commit_deferred()
        timing["serial_fallback"] = serial
        timing["wall_s"] = time.perf_counter() - t_wave
        self._record(timing)
        return completed

    def _record(self, timing: dict) -> None:
        # a long-lived driver must not accumulate one dict per tick forever
        if len(self.timings) >= 4096:
            del self.timings[:2048]
        self.timings.append(timing)

    def flush(self) -> list[tuple[EncodedProblem, np.ndarray]]:
        """Complete and commit every in-flight wave (pipeline drain),
        oldest first; one timings entry per completed wave."""
        out = []
        while self._inflight:
            p, counts, timing = self._complete()
            timing["commit_s"] = self._commit(p, counts)
            timing["dirty_scan_s"] = 0.0
            timing["serial_fallback"] = False
            timing["encode_s"] = timing["dispatch_s"] = 0.0
            timing["wall_s"] = timing["pull_s"] + timing["fold_s"] \
                + timing["commit_s"]
            self._record(timing)
            out.append((p, counts))
        return out

    def close(self) -> None:
        """Nothing to stop: the commit runs on the calling thread. Does not
        flush — call flush() first on an orderly shutdown."""
