"""Sustained-load tick pipeline: hide the counts' copy to the host under
host work, up to `depth` waves deep (the port of the JAX package's
`ops/pipeline.py`).

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

THE ASYNC COMMIT PLANE (`async_commit=True`): the commit's heavy half
(slot materialization, the native add_task walk, the caller's store
write-back, the fingerprint restamp) moves to ONE background CommitWorker
(`ops/commit.py`), strict FIFO, and overlaps the next wave's dispatch and
counts pull (the pull's event wait releases the GIL, and so does the C
walk between node segments). What stays on the wave loop is what the
invariants above need:

  * `fold_counts` + `after_apply` run at completion, BEFORE the next
    encode/dispatch (parity depends on the correction rows being known
    before anything else ships);
  * every tick takes a worker BARRIER before the dirty scan
    (`nodes_clean`), so wave k's deferred add_task/restamp is retired
    before any fingerprint is read, and so before every drain trigger;
  * the wave's heavy half is enqueued only AFTER this tick's encode and
    dispatch returned, so the encoder is never read mid-walk;
  * a worker exception re-raises out of the NEXT tick's barrier (it never
    dies with the thread); the caller owns the heal.

ENCODE/COMMIT OVERLAP (tracked encoders only): with
`IncrementalEncoder(tracked=True)` a steady tick's nodes_clean check and
its zero-scan encode read neither NodeInfo objects nor fingerprints, the
only host state the riding heavy commit writes. So while that O(1) gate
holds, the top-of-tick barrier is SKIPPED and the completed wave's heavy
half is submitted BEFORE encode: the encode and dispatch of wave k+1 run
beside commit(k). When the gate breaks (pending marks, node churn, a
failed worker, any drain trigger) the tick takes the barriered order.
drain_serial always barriers first, so an inline commit never runs beside
or ahead of a riding heavy one, and FIFO wave order holds.

Placements stay bit-identical to the CPU oracle at every depth and in both
commit modes. The JAX package also files each stage as a trace span; the
port keeps the stages in `timings` only.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from typing import Callable

import numpy as np

from ..scheduler.encode import (
    EncodedProblem,
    IncrementalEncoder,
    fold_problem,
)
from .commit import CommitWorker
from .resident import ResidentPlacement


class TickPipeline:
    """Drives ResidentPlacement ticks with up to `depth` waves in flight.

    commit_cb(problem, counts) must perform EXACTLY one successful
    NodeInfo.add_task per placed task (the apply_counts contract) plus
    whatever store writes the caller needs; the pipeline brackets it with
    fold_counts (before the encoder next re-reads those arrays) and
    restamp_counts (after).

    async_commit=True runs commit_cb + restamp on a single background
    CommitWorker (FIFO, barriered at the top of every tick, on every drain,
    in flush() and close()): commit_cb must then touch ONLY state that
    nothing else reads between the enqueue and the next barrier (NodeInfo
    objects, the store, the encoder's fingerprint stamp), and must launch
    no kernel. The contract cuts both ways: a CALLER that mutates NodeInfos
    between ticks (node churn, an external add_task) must call barrier()
    FIRST."""

    def __init__(self, encoder: IncrementalEncoder,
                 resident: ResidentPlacement,
                 commit_cb: Callable[[EncodedProblem, np.ndarray], None],
                 depth: int = 1, async_commit: bool = False):
        self.encoder = encoder
        self.resident = resident
        self.commit_cb = commit_cb
        self.depth = max(1, depth)
        self.worker = CommitWorker(name="tick-commit") if async_commit \
            else None
        # (problem, handle, n_pending): n_pending = how many dispatched-
        # but-unfolded waves preceded this one at its encode time
        self._inflight: deque[tuple] = deque()
        # completed (problem, counts) pairs still needed as fold sources
        self._recent: deque[tuple] = deque(maxlen=max(1, self.depth - 1))
        self.timings: list[dict] = []      # per-wave phase seconds

    # ------------------------------------------------------------------ steps
    def _pull_oldest(self) -> tuple:
        """Pop the oldest in-flight wave and wait for its counts, WITHOUT
        folding it. In async mode this runs BEFORE the commit barrier: the
        wait releases the GIL, so the worker's riding heavy commit runs
        under it."""
        p, h, n_pending = self._inflight.popleft()
        t0 = time.perf_counter()
        counts = h.get()
        return p, counts, n_pending, time.perf_counter() - t0

    def _fold_pulled(self, p: EncodedProblem, counts: np.ndarray,
                     n_pending: int) -> float:
        """The completion's synchronous half: problem fold (deep pipe),
        encoder array fold, correction-row bookkeeping. Must precede the
        next encode()."""
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
        the fingerprint restamp. Runs inline (sync mode, drains) or on the
        CommitWorker (async mode)."""
        self.commit_cb(p, counts)
        self.encoder.restamp_counts(p, counts)

    def _commit(self, p: EncodedProblem, counts: np.ndarray) -> float:
        t0 = time.perf_counter()
        self._heavy(p, counts)
        return time.perf_counter() - t0

    def _barrier(self, timing: dict | None = None) -> None:
        """Retire every enqueued heavy commit (async mode). A worker
        exception re-raises HERE, i.e. into the next tick."""
        if self.worker is None:
            return
        if self.worker.idle:
            self.worker.barrier()     # raises a captured exception
            return
        t0 = time.perf_counter()
        self.worker.barrier()
        if timing is not None:
            timing["barrier_s"] += time.perf_counter() - t0

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
        `depth` on a drain. In async mode a returned wave's heavy commit may
        still be riding the worker; the next tick's barrier (or flush())
        retires it."""
        timing = {"pull_s": 0.0, "fold_s": 0.0, "barrier_s": 0.0,
                  "dirty_scan_s": 0.0, "commit_s": 0.0}
        t_wave = time.perf_counter()
        completed: list[tuple] = []
        # a completed-but-not-yet-committed wave (commits stay FIFO and are
        # never dropped: fold_counts already ran for it)
        deferred: tuple | None = None
        # async mode: the pulled-but-not-yet-folded oldest wave
        pulled: tuple | None = None

        # encode/commit overlap gate: with a TRACKED encoder and no pending
        # marks, this tick's nodes_clean and encode read no NodeInfo and no
        # fingerprint (exactly what the riding heavy commit writes), so the
        # top-of-tick barrier may be skipped. The gate is O(1) and never
        # reads what the worker writes; a failed worker closes it so the
        # pending exception re-raises at the barrier.
        overlap = False
        if self.worker is not None:
            if len(self._inflight) >= self.depth:
                p0, c0, np0, pull_s = self._pull_oldest()
                timing["pull_s"] += pull_s
                pulled = (p0, c0, np0)
            t0 = time.perf_counter()
            overlap = (self.encoder.tracked
                       and self.encoder.nodes_clean(infos)
                       and not self.worker.failed)
            timing["dirty_scan_s"] += time.perf_counter() - t0
            if not overlap:
                # barrier BEFORE any host-state read: the earlier waves'
                # add_task/restamp retire before the dirty scan below and
                # every drain trigger; worker exceptions surface here
                self._barrier(timing)

        def finish_pulled():
            nonlocal pulled
            if pulled is None:
                return None
            p, c, n_p = pulled
            pulled = None
            timing["fold_s"] += self._fold_pulled(p, c, n_p)
            completed.append((p, c))
            return (p, c)

        def complete_oldest():
            p, c, t = self._complete()
            timing["pull_s"] += t["pull_s"]
            timing["fold_s"] += t["fold_s"]
            completed.append((p, c))
            return p, c

        def commit_deferred(sync: bool = False):
            # sync=True (drains): the heavy half completes before this tick
            # reads or ships node state again; sync=False (steady async):
            # enqueue, the NEXT tick's barrier retires it
            nonlocal deferred
            if deferred is None:
                return
            p, c = deferred
            deferred = None
            if self.worker is not None and not sync:
                try:
                    self.worker.submit(functools.partial(self._heavy, p, c))
                except BaseException:
                    # overlap window: a riding heavy failed after the gate
                    # and submit refused this wave, whose fold already ran;
                    # poison its placed-on rows and the carry so the
                    # caller's heal starts from honest state
                    self.encoder.force_numeric_reencode(
                        np.flatnonzero(c.sum(axis=0)))
                    self.resident.invalidate()
                    raise
            else:
                timing["commit_s"] += self._commit(p, c)

        def drain_serial():
            # the one drain sequence every trigger uses, always post-
            # barrier: the deferred or pulled wave first (FIFO — it is the
            # oldest), then complete and commit everything left, inline.
            # The barrier is a no-op on the barriered async path but
            # REQUIRED on the overlap path, where the top one was skipped
            self._barrier(timing)
            commit_deferred(sync=True)
            done = finish_pulled()
            if done is not None:
                timing["commit_s"] += self._commit(*done)
            while self._inflight:
                timing["commit_s"] += self._commit(*complete_oldest())

        # external node mutations: drain fully so dirty rows re-encode from
        # infos that already include every wave's tasks
        if overlap:
            serial = False      # the gate already proved nodes_clean
        else:
            t0 = time.perf_counter()
            serial = bool(self._inflight or pulled) \
                and not self.encoder.nodes_clean(infos)
            timing["dirty_scan_s"] += time.perf_counter() - t0
        if serial:
            drain_serial()
        else:
            if pulled is not None:
                deferred = finish_pulled()
            elif len(self._inflight) >= self.depth:
                deferred = complete_oldest()
            # hazards may have been CREATED by that completion (e.g.
            # after_apply queued corrections): re-check before dispatching
            # past anything still in flight
            if self._inflight and self._hazards():
                serial = True
                drain_serial()
            elif overlap and deferred is not None:
                # overlap: the completed wave's heavy half goes to the
                # worker NOW, so the zero-scan encode below runs beside it
                commit_deferred()

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
        # counts are under way: inline (sync mode) or enqueued (async; on
        # the overlap path it was submitted before encode and this is a
        # no-op)
        commit_deferred()
        timing["serial_fallback"] = serial
        timing["commit_overlapped"] = overlap
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
        oldest first; one timings entry per completed wave. In async mode
        the worker is barriered first, so on return NOTHING rides the
        plane (a worker exception re-raises here)."""
        out = []
        self._barrier()
        while self._inflight:
            p, counts, timing = self._complete()
            timing["commit_s"] = self._commit(p, counts)
            timing["dirty_scan_s"] = timing["barrier_s"] = 0.0
            timing["serial_fallback"] = timing["commit_overlapped"] = False
            timing["encode_s"] = timing["dispatch_s"] = 0.0
            timing["wall_s"] = timing["pull_s"] + timing["fold_s"] \
                + timing["commit_s"]
            self._record(timing)
            out.append((p, counts))
        return out

    def barrier(self) -> None:
        """Public commit barrier: a caller MUST take it before mutating any
        NodeInfo between ticks in async mode (the riding heavy commit walks
        those same objects). A no-op in sync mode; a worker exception
        re-raises here."""
        self._barrier()

    def close(self) -> None:
        """Retire every queued heavy commit and stop the worker thread
        (async mode; idempotent). Does not flush the in-flight waves (call
        flush() first on an orderly shutdown) and does not re-raise a
        worker exception (call barrier() to see it)."""
        if self.worker is not None:
            self.worker.close()
