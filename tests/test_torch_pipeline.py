"""TickPipeline of the PyTorch port against the JAX reference.

The port's pipeline (synchronous commit) drives its ResidentPlacement on
`device="cpu"`; the JAX package's `TickPipeline(async_commit=False)` drives
its own, over wave traces built from the same seed in either package. Every
completed wave's counts, the serial-drain decisions, the final carried
state, the upload counters and the encoder's folded arrays must be equal,
and every wave must equal the CPU oracle on its completed problem: the
tolerance is exact equality. Depth D must place exactly as depth 1 does,
through node churn, new service rows and quantization corrections, which
drain the pipe to the serial order.
"""
import random

import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import pipeline as jax_pipeline
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
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


def make_commit(side, infos_ref):
    """One add_task per placement (the apply_counts contract). A deferred
    commit can target a node that churn removed or replaced after dispatch:
    the registry keeps dispatch-time objects reachable, as a scheduler's
    node map outlives the wave that placed onto it."""
    batch = SIDES[side][2]
    registry: dict = {}

    def commit(p, counts):
        for i in infos_ref:
            registry[i.node.id] = i
        task_by_id = {t.id: t for g in p.groups for t in g.tasks}
        n_added = sum(registry[nid].add_task(task_by_id[tid])
                      for tid, nid in batch.materialize(p, counts).items())
        assert n_added == int(counts.sum())
    return commit


def run_pipelined(side, seed, depth, steps=6, group_maker=plain_group,
                  churn=False, fresh_services=False):
    api, _mod, batch = SIDES[side]
    rng = random.Random(seed)
    infos = [make_info(api, rng, i) for i in range(12)]
    next_node_id = 12
    enc = api.encode.IncrementalEncoder()
    rp = resident_of(side, enc)
    kw = {"async_commit": False} if side == "jax" else {}
    pipe = PIPELINES[side](enc, rp, make_commit(side, infos), depth=depth,
                           **kw)
    completed = []
    for step in range(steps):
        if churn and step and step % 3 == 0:
            next_node_id = mutate(api, rng, infos, next_node_id, step)
        groups = make_waves(api, rng, step, group_maker)
        if fresh_services and step % 2 == 0:
            # brand-new services: no persistent service row yet, so the
            # wave's row numbering is hypothetical until it folds
            for g in groups:
                g.service_id = f"fresh{step}-{g.service_id}"
                for t in g.tasks:
                    t.service_id = g.service_id
        completed.extend(pipe.tick(infos, groups, now=NOW))
    completed.extend(pipe.flush())
    pipe.close()
    assert len(completed) == steps
    # each wave equals the oracle on its COMPLETED problem: at depth > 1
    # completion folded the then-pending waves into it (fold_problem)
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
            "state": st, "counters": counters(rp),
            "enc": (enc.avail_res, enc.total0, enc._svc_mat)}


def assert_runs_equal(a, b, what=""):
    assert len(a["counts"]) == len(b["counts"])
    for step, (ca, cb) in enumerate(zip(a["counts"], b["counts"])):
        np.testing.assert_array_equal(ca, cb, err_msg=f"{what} wave {step}")
    for x, y in zip(a["enc"], b["enc"]):
        np.testing.assert_array_equal(x, y, err_msg=what)


CASES = {
    "d1-plain": dict(depth=1),
    "d2-churn": dict(depth=2, churn=True),
    "d3-churn-fresh": dict(depth=3, churn=True, fresh_services=True),
    "d3-odd": dict(depth=3, group_maker=odd_group),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case):
    kw = CASES[case]
    want = run_pipelined("jax", 50, **kw)
    got = run_pipelined("torch", 50, **kw)
    assert_runs_equal(got, want, case)
    assert got["serial"] == want["serial"]
    assert_states_equal(got["state"], want["state"], case)
    assert got["counters"] == want["counters"]
    if kw.get("churn") or kw.get("fresh_services"):
        assert any(got["serial"]), "no drain: the serial order went unused"


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("seed", range(2))
def test_deep_pipeline_matches_depth_one(seed, depth):
    """Churn, new service rows and odd reservations: depth D places exactly
    as depth 1, draining to the serial order where it must."""
    for kw in (dict(churn=True, fresh_services=True),
               dict(group_maker=odd_group)):
        one = run_pipelined("torch", 60 + seed, 1, **kw)
        deep = run_pipelined("torch", 60 + seed, depth, **kw)
        assert_runs_equal(deep, one, f"depth {depth} {sorted(kw)}")
        assert any(deep["serial"])


def test_steady_waves_pipeline_without_drains():
    """After the first wave allocates the service rows, waves of the same
    services on an unchanged cluster never drain, and nothing node-sized
    ships after the cold upload."""
    api, _mod, batch = SIDES["torch"]
    rng = random.Random(70)
    infos = [make_info(api, rng, i) for i in range(12)]
    enc = api.encode.IncrementalEncoder()
    rp = resident_of("torch", enc)
    pipe = torch_pipeline.TickPipeline(enc, rp, make_commit("torch", infos),
                                       depth=3)
    done = []
    for step in range(6):
        groups = [service_group(api, "svc-a", step + 1, 5),
                  service_group(api, "svc-b", step + 1, 3)]
        done.extend(pipe.tick(infos, groups, now=NOW))
    done.extend(pipe.flush())
    assert len(done) == 6
    for p, counts in done:
        np.testing.assert_array_equal(counts, batch.cpu_schedule_encoded(p))
    # wave 1 drains once: wave 0's service rows were hypothetical
    assert [t["serial_fallback"] for t in pipe.timings][2:] == [False] * 7
    assert rp.uploads_full == 1 and rp.uploads_delta_rows == 0
