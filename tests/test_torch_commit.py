"""The async commit plane of the PyTorch port: `CommitWorker` and
`TickPipeline(async_commit=True)`.

The worker's contract (FIFO, barrier re-raise, poison drops queued jobs,
reset, close joins, the `commit.worker.job` failpoint, its counters) is
pinned directly. The async pipeline must place exactly as the port's
synchronous pipeline and as the JAX package's async pipeline, wave for
wave, at depth 1-3, through churn, new service rows and quantization
corrections (after the JAX package's tests/test_pipeline.py): async only
changes WHEN the heavy half runs. Every output is integer, so the
tolerance is exact equality. Every test closes the pipelines and workers
it starts and disarms what it armed; clusters stay at a dozen nodes.
"""
import random
import threading
import time

import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import pipeline as jax_pipeline
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
from swarmkit_tpu_torch.ops.commit import CommitWorker
from swarmkit_tpu_torch.utils import failpoints
from test_torch_pipeline import make_commit
from test_torch_resident import (
    NOW,
    SIDES,
    assert_fold,
    assert_states_equal,
    counters,
    make_info,
    make_waves,
    mutate,
    odd_group,
    plain_group,
    resident_of,
    service_group,
)

torch.set_num_threads(1)

PIPELINES = {"jax": jax_pipeline.TickPipeline,
             "torch": torch_pipeline.TickPipeline}


@pytest.fixture
def worker():
    w = CommitWorker(name="test-commit")
    try:
        yield w
    finally:
        w.close()
        failpoints.disarm_all()


# ------------------------------------------------------------ the worker
def test_worker_runs_fifo_and_counts(worker):
    ran = []
    for i in range(20):
        worker.submit(lambda i=i: (time.sleep(0.001 * (i % 3)),
                                   ran.append(i)))
    worker.barrier()
    assert ran == list(range(20))
    assert worker.idle and worker.pending == 0
    assert worker.jobs_total == 20 and len(worker.job_s) == 20
    assert worker.busy_s >= sum(worker.job_s) * 0.999
    assert worker.poisoned_total == 0 and not worker.failed


def test_worker_barrier_reraises_and_poison_drops_queued(worker):
    """Jobs queued behind a failed one were built on state the failure left
    undefined: dropped unrun; submit and barrier re-raise until reset()."""
    gate = threading.Event()
    ran = []

    def blocker():
        gate.wait(5)
        raise RuntimeError("poisoned")

    worker.submit(blocker)
    worker.submit(lambda: ran.append(1))     # queued behind the failure
    gate.set()
    with pytest.raises(RuntimeError, match="poisoned"):
        worker.barrier()
    assert ran == [] and worker.failed and worker.poisoned_total == 1
    with pytest.raises(RuntimeError, match="poisoned"):
        worker.barrier()                     # stays poisoned
    with pytest.raises(RuntimeError, match="poisoned"):
        worker.submit(lambda: ran.append(2))
    worker.reset()
    worker.submit(lambda: ran.append(3))
    worker.barrier()
    assert ran == [3] and not worker.failed


def test_worker_failpoint_poisons_at_the_job_boundary(worker):
    ran = []
    with failpoints.armed("commit.worker.job", error=True, times=1) as fp:
        worker.submit(lambda: ran.append(1))
        with pytest.raises(failpoints.FailpointError):
            worker.barrier()
        assert fp.fired == 1
    assert ran == []                         # the job never started
    worker.reset()
    worker.submit(lambda: ran.append(2))
    worker.barrier()
    assert ran == [2] and worker.jobs_total == 2


def test_worker_close_drains_joins_and_refuses(worker):
    ran = []
    for i in range(5):
        worker.submit(lambda i=i: (time.sleep(0.002), ran.append(i)))
    thread = worker._thread
    worker.close()
    assert ran == list(range(5))             # close ran the queue out
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="after close"):
        worker.submit(lambda: None)
    worker.close()                           # idempotent


def test_worker_bounds_its_queue(worker):
    """submit() blocks at max_pending until the worker retires a job."""
    w = CommitWorker(name="test-bounded", max_pending=2)
    gate = threading.Event()
    try:
        w.submit(lambda: gate.wait(5))
        w.submit(lambda: None)
        t = threading.Thread(target=w.submit, args=(lambda: None,))
        t.start()
        t.join(0.05)
        assert t.is_alive() and w.pending == 2   # blocked on the bound
        gate.set()
        t.join(5)
        assert not t.is_alive()
        w.barrier()
        assert w.jobs_total == 3
    finally:
        gate.set()
        w.close()


# ------------------------------------------------------ async pipeline
def run(side, seed, depth, async_commit, steps=6, group_maker=plain_group,
        churn=False, fresh_services=False, steady=False):
    """A pipelined wave trace on one side (tests/test_torch_pipeline.py's
    run_pipelined, with the commit mode chosen and the barrier a caller
    takes before mutating NodeInfos in async mode). steady=True sends
    waves of the same two services, which pipeline without drains."""
    api, _mod, batch = SIDES[side]
    rng = random.Random(seed)
    infos = [make_info(api, rng, i) for i in range(12)]
    next_node_id = 12
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc)
    pipe = PIPELINES[side](enc, rp, make_commit(side, infos), depth=depth,
                           async_commit=async_commit)
    completed = []
    try:
        for step in range(steps):
            if churn and step and step % 3 == 0:
                pipe.barrier()
                next_node_id = mutate(api, rng, infos, next_node_id, step)
            if steady:
                groups = [service_group(api, "svc-a", step + 1, 5),
                          service_group(api, "svc-b", step + 1, 3)]
            else:
                groups = make_waves(api, rng, step, group_maker)
            if fresh_services and step % 2 == 0:
                for g in groups:
                    g.service_id = f"fresh{step}-{g.service_id}"
                    for t in g.tasks:
                        t.service_id = g.service_id
            completed.extend(pipe.tick(infos, groups, now=NOW))
        completed.extend(pipe.flush())
        if async_commit:
            assert pipe.worker.idle
    finally:
        pipe.close()
    assert len(completed) == steps
    for step, (p, counts) in enumerate(completed):
        np.testing.assert_array_equal(
            counts, batch.cpu_schedule_encoded(p),
            err_msg=f"{side} seed {seed} depth {depth} wave {step}")
    p, counts = completed[-1]
    st = rp.pull_state()
    assert_fold(st, p, counts, f"{side} depth {depth} final carry")
    assert enc.nodes_clean(infos)
    return {"counts": [c for _p, c in completed],
            "serial": [t["serial_fallback"] for t in pipe.timings],
            "barrier": [t.get("barrier_s", 0.0) for t in pipe.timings],
            "state": st, "counters": counters(rp),
            "enc": (enc.avail_res, enc.total0, enc._svc_mat, enc._fp_mut),
            "jobs": pipe.worker.jobs_total if async_commit else None,
            "thread_alive": bool(pipe.worker and pipe.worker._thread
                                 and pipe.worker._thread.is_alive())}


CASES = {
    "d1-plain": dict(depth=1),
    "d2-churn": dict(depth=2, churn=True),
    "d3-churn-fresh": dict(depth=3, churn=True, fresh_services=True),
    "d3-odd": dict(depth=3, group_maker=odd_group),
    "d3-steady": dict(depth=3, steady=True, steps=8),
    "d2-steady-churn": dict(depth=2, steady=True, churn=True, steps=8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_async_pipeline_matches_sync_and_jax(case):
    """Wave for wave: the port's async pipeline equals its synchronous one
    (counts, encoder state, carry) and the JAX package's async pipeline
    (counts, drain decisions, carry, upload counters)."""
    kw = CASES[case]
    sync = run("torch", 90, async_commit=False, **kw)
    got = run("torch", 90, async_commit=True, **kw)
    want = run("jax", 90, async_commit=True, **kw)
    for other, what in ((sync, "sync"), (want, "jax async")):
        assert len(got["counts"]) == len(other["counts"])
        for step, (a, b) in enumerate(zip(got["counts"], other["counts"])):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {step}")
        for a, b in zip(got["enc"], other["enc"]):
            np.testing.assert_array_equal(a, b, err_msg=what)
        assert_states_equal(got["state"], other["state"], what)
    assert got["serial"] == want["serial"] == sync["serial"]
    assert got["counters"] == want["counters"] == sync["counters"]
    # the same heavy halves rode the worker on both sides
    assert got["jobs"] == want["jobs"]
    if kw.get("steady") or case == "d1-plain":
        assert got["jobs"] > 0, "no heavy half rode the worker"
    if kw.get("churn") or kw.get("fresh_services"):
        assert any(got["serial"]), "no drain: the serial order went unused"


@pytest.mark.parametrize("depth", [2, 3])
def test_async_deep_pipeline_matches_sync_depth_one(depth):
    one = run("torch", 95, 1, async_commit=False, churn=True,
              fresh_services=True)
    deep = run("torch", 95, depth, async_commit=True, churn=True,
               fresh_services=True)
    for step, (a, b) in enumerate(zip(deep["counts"], one["counts"])):
        np.testing.assert_array_equal(a, b, err_msg=f"wave {step}")
    for a, b in zip(deep["enc"], one["enc"]):
        np.testing.assert_array_equal(a, b)


def _tracked_run(async_commit):
    """Steady waves of the same services on a tracked encoder: the
    encode/commit overlap gate holds, so async ticks skip the top barrier
    and submit the heavy half before encode."""
    api, _mod, batch = SIDES["torch"]
    rng = random.Random(70)
    infos = [make_info(api, rng, i) for i in range(12)]
    enc = api.encode.IncrementalEncoder(tracked=True)
    rp = resident_of("torch", enc)
    pipe = torch_pipeline.TickPipeline(enc, rp, make_commit("torch", infos),
                                       depth=2, async_commit=async_commit)
    done = []
    try:
        for step in range(6):
            groups = [service_group(api, "svc-a", step + 1, 5),
                      service_group(api, "svc-b", step + 1, 3)]
            done.extend(pipe.tick(infos, groups, now=NOW))
        done.extend(pipe.flush())
    finally:
        pipe.close()
    for p, counts in done:
        np.testing.assert_array_equal(counts, batch.cpu_schedule_encoded(p))
    return done, pipe.timings, enc


def test_async_overlap_on_a_tracked_encoder_matches_sync():
    sync, _t, enc_s = _tracked_run(False)
    got, timings, enc_a = _tracked_run(True)
    assert len(got) == len(sync) == 6
    for (_p, a), (_q, b) in zip(got, sync):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(enc_a.total0, enc_s.total0)
    np.testing.assert_array_equal(enc_a._svc_mat, enc_s._svc_mat)
    assert any(t["commit_overlapped"] for t in timings), \
        "the overlap gate never held"


def test_async_worker_exception_surfaces_on_next_tick():
    """A worker-side commit exception re-raises out of a LATER tick (the
    next barrier): it never dies with the thread and is never skipped;
    flush re-raises until the owner resets the plane."""
    api, _mod, _batch = SIDES["torch"]
    rng = random.Random(5)
    infos = [make_info(api, rng, i) for i in range(8)]
    enc = api.encode.IncrementalEncoder()
    rp = resident_of("torch", enc)
    base = make_commit("torch", infos)
    boom = {"armed": False}

    def commit(p, counts):
        if boom["armed"]:
            raise RuntimeError("injected commit failure")
        base(p, counts)

    pipe = torch_pipeline.TickPipeline(enc, rp, commit, depth=1,
                                       async_commit=True)
    try:
        pipe.tick(infos, make_waves(api, rng, 0, plain_group), now=NOW)
        boom["armed"] = True
        # completes wave 0 and enqueues its (failing) heavy commit
        pipe.tick(infos, make_waves(api, rng, 1, plain_group), now=NOW)
        with pytest.raises(RuntimeError, match="injected commit failure"):
            pipe.tick(infos, make_waves(api, rng, 2, plain_group), now=NOW)
        with pytest.raises(RuntimeError, match="injected commit failure"):
            pipe.flush()
        with pytest.raises(RuntimeError, match="injected commit failure"):
            pipe.barrier()
        pipe.worker.reset()
        pipe.barrier()
    finally:
        pipe.close()
    assert not pipe.worker._thread.is_alive()


def test_async_drain_triggers_wait_for_inflight_commit():
    """No dirty scan and no other commit interleaves a running heavy
    commit, across external-mutation drains, correction-row hazards, new
    service rows and a new generic kind (a full re-upload); commits retire
    FIFO, once per wave."""
    api, _mod, batch = SIDES["torch"]
    rng = random.Random(17)
    infos = [make_info(api, rng, i) for i in range(10)]
    next_node_id = 10
    enc = api.encode.IncrementalEncoder()
    rp = resident_of("torch", enc)
    events = []
    base = make_commit("torch", infos)

    def commit(p, counts):
        key = p.groups[0].tasks[0].id if p.groups else "?"
        events.append(("start", key))
        time.sleep(0.01)        # widen the race window
        base(p, counts)
        events.append(("end", key))

    pipe = torch_pipeline.TickPipeline(enc, rp, commit, depth=3,
                                       async_commit=True)
    orig_clean = enc.nodes_clean

    def clean(infos_):
        events.append(("scan", None))
        return orig_clean(infos_)

    enc.nodes_clean = clean
    completed = []
    try:
        for step in range(10):
            if step == 3:
                pipe.barrier()      # the external-mutator contract
                next_node_id = mutate(api, rng, infos, next_node_id, step)
            maker = odd_group if step in (4, 5) else plain_group
            groups = make_waves(api, rng, step, maker)
            if step == 6:
                for g in groups:    # fresh services: hypothetical rows
                    g.service_id = f"fresh-{g.service_id}"
                    for t in g.tasks:
                        t.service_id = g.service_id
            if step == 8:           # a new generic kind: signature growth
                groups[0].tasks[0].spec.resources.reservations.generic = \
                    {"exotic": 1}
            completed.extend(pipe.tick(infos, groups, now=NOW))
        completed.extend(pipe.flush())
    finally:
        pipe.close()

    assert len(completed) == 10
    for step, (p, counts) in enumerate(completed):
        np.testing.assert_array_equal(
            counts, batch.cpu_schedule_encoded(p), err_msg=f"step {step}")
    assert any(t["serial_fallback"] for t in pipe.timings)
    open_key, seen = None, []
    for kind, key in events:
        if kind == "start":
            assert open_key is None, f"{key!r} started during {open_key!r}"
            open_key = key
        elif kind == "end":
            assert open_key == key
            seen.append(key)
            open_key = None
        else:
            assert open_key is None, f"dirty scan during {open_key!r}"
    assert open_key is None
    assert len(seen) == len(set(seen)) == 10


def test_flush_and_close_leave_nothing_riding():
    """flush() barriers and commits every in-flight wave inline; close()
    stops the thread. The timings carry the barrier stage."""
    got = run("torch", 99, 3, async_commit=True, steps=7, steady=True)
    # 7 ticks, and one entry per wave the flush completed: the pipe was
    # 3 deep when it began
    assert len(got["barrier"]) == 7 + 3
    assert all(b >= 0.0 for b in got["barrier"]) and got["jobs"] > 0
    assert not got["thread_alive"]
