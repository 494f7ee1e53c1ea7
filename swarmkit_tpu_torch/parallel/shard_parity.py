"""Parity at oracle-infeasible sizes: sampled-shard oracle + invariants
(the port of the JAX package's `parallel/shard_parity.py`; host numpy over
the port's greedy CPU oracle, `scheduler/batch.py`).

The judged property is bit-parity between the placement kernels and the
CPU greedy oracle. The oracle is Python per task, so at the mesh
flagship's 100k-1M-node x 1M-task grid a full-oracle check cannot run.
This module holds the scale-out verification ladder:

  1. full oracle at every feasible shape;
  2. SAMPLED-SHARD oracle above that: for problems built shard-
     partitioned (`models.cluster_step.synth_shard_cluster` — every
     group eligible on exactly one contiguous node slice, spread
     branches and warm service counts confined to their slice, port ids
     reused only within a slice), the global sequential-group fill
     RESTRICTED to a slice is bit-identical to the greedy oracle run on
     that slice alone: groups of other slices cannot place there (the
     eligibility mask), their service rows are distinct, and every fold
     they perform (totals, avail, ports, svc counts) touches only their
     own slice — so they are no-ops on this slice's state. Slicing
     preserves the relative node order (the canonical node_idx
     tie-break) and the relative branch-rank order (the pour's
     tie-break), so the restricted fill IS the slice's fill.
  3. invariant checks on the FULL output: non-negativity, per-group task
     conservation, static-mask eligibility (with the CSI volume-topology
     leg: `cpu_static_mask` carries it), resource capacity, max-replicas
     caps, ORDER-AWARE host-port claims (the oracle's incremental
     batch-internal conflict semantics), and the topology-balance water
     property of the outermost preference level — each a vectorized
     numpy pass, feasible at any size the arrays fit in memory.

The sampled-shard oracle is STRATEGY-AWARE: `slice_shard_problem`
carries `strategy` and the group-side `vol_topo` rows, and
`cpu_schedule_encoded` dispatches on them — so binpack and topology
fills at the scale-out grid are held to the same sliced bit-parity bar
as spread.

A violation raises AssertionError.
"""
from __future__ import annotations

import numpy as np


def slice_shard_problem(p, group_idx: np.ndarray, node_lo: int,
                        node_hi: int):
    """Restrict an EncodedProblem to `group_idx` (ascending, original
    order) × the contiguous node slice [node_lo, node_hi). Service rows
    are kept whole (svc_idx values stay valid); only their node columns
    are sliced."""
    from ..scheduler.encode import EncodedProblem

    gsel = np.asarray(group_idx, np.int64)
    sl = slice(node_lo, node_hi)
    q = EncodedProblem(
        node_ids=p.node_ids[node_lo:node_hi],
        group_keys=[p.group_keys[int(g)] for g in gsel],
        service_ids=p.service_ids,
        groups=[],
    )
    q.ready = np.ascontiguousarray(p.ready[sl])
    q.node_val = np.ascontiguousarray(p.node_val[sl])
    q.node_plat = np.ascontiguousarray(p.node_plat[sl])
    q.node_plugins = np.ascontiguousarray(p.node_plugins[sl])
    q.port_used0 = np.ascontiguousarray(p.port_used0[sl])
    q.avail_res = np.ascontiguousarray(p.avail_res[sl])
    q.total0 = np.ascontiguousarray(p.total0[sl])
    q.svc_count0 = np.ascontiguousarray(p.svc_count0[:, sl])
    q.n_tasks = p.n_tasks[gsel]
    q.svc_idx = p.svc_idx[gsel]
    q.need_res = p.need_res[gsel]
    q.max_replicas = p.max_replicas[gsel]
    q.constraints = p.constraints[gsel]
    q.plat_req = p.plat_req[gsel]
    q.req_plugins = p.req_plugins[gsel]
    q.has_ports = p.has_ports[gsel]
    q.group_ports = p.group_ports[gsel]
    q.penalty = np.ascontiguousarray(p.penalty[gsel][:, sl])
    q.extra_mask = np.ascontiguousarray(p.extra_mask[gsel][:, sl])
    q.spread_rank = np.ascontiguousarray(
        np.asarray(p.spread_rank)[gsel][:, :, sl])
    vt = getattr(p, "vol_topo", None)
    if vt is not None:
        # group-side CSI topology rows: the group axis slices, the node
        # axis never appears (the mask leg gathers node_val columns by
        # row key, and node_val keeps its columns under node slicing)
        q.vol_topo = np.ascontiguousarray(np.asarray(vt)[gsel])
        q.vol_topo_any = bool(q.vol_topo.shape[1])
    # the slice oracle must score with the SAME strategy as the kernel
    q.strategy = getattr(p, "strategy", "spread")
    return q


def sampled_shard_parity(p, counts: np.ndarray, group_shard: np.ndarray,
                         n_shards: int, sample, log=None) -> list[int]:
    """Bit-parity of `counts` against the greedy oracle on sampled shards.

    `sample`: iterable of shard indices (or an int — that many shards
    picked deterministically, spread across the range). For each sampled
    shard s the oracle re-runs on s's node slice with s's groups, and
    counts[groups_of_s] must (a) equal the oracle inside the slice and
    (b) be identically zero outside it. Returns the shards checked."""
    from ..scheduler.batch import cpu_schedule_encoded

    N = len(p.node_ids)
    per = N // n_shards
    group_shard = np.asarray(group_shard)
    if isinstance(sample, int):
        k = max(1, min(sample, n_shards))
        sample = sorted({int(s) for s in
                         np.linspace(0, n_shards - 1, k).round()})
    checked = []
    for s in sample:
        s = int(s)
        gsel = np.flatnonzero(group_shard == s)
        a, b = s * per, (s + 1) * per
        sub = slice_shard_problem(p, gsel, a, b)
        expected = cpu_schedule_encoded(sub)
        got = counts[gsel]
        outside = got.copy()
        outside[:, a:b] = 0
        assert not outside.any(), \
            f"shard {s}: placements leaked outside the shard's node slice"
        np.testing.assert_array_equal(
            got[:, a:b], expected,
            err_msg=f"shard {s}: kernel fill != greedy oracle on the "
                    f"shard's node slice [{a}, {b})")
        checked.append(s)
        if log is not None:
            log(f"sampled-shard parity ok: shard {s} "
                f"({len(gsel)} groups, {per} nodes, "
                f"{int(expected.sum())} placed)")
    return checked


def check_fill_invariants(p, counts: np.ndarray) -> dict:
    """Vectorized invariant checks on a full fill output — the guardrail
    at sizes where even the sampled oracle covers only a fraction.
    Raises AssertionError on violation; returns summary stats."""
    from ..scheduler.batch import cpu_static_mask

    c = np.asarray(counts, np.int64)
    assert (c >= 0).all(), "negative placement count"
    placed_per_group = c.sum(axis=1)
    assert (placed_per_group <= p.n_tasks.astype(np.int64)).all(), \
        "a group placed more tasks than it has"

    mask = cpu_static_mask(p)
    assert not (c[~mask] > 0).any(), \
        "placement on a statically-ineligible node"

    used = c.T @ p.need_res.astype(np.int64)              # [N, R]
    assert (used <= p.avail_res.astype(np.int64)).all(), \
        "resource capacity overcommitted"

    # max-replicas: final per-service per-node count never exceeds the cap
    svc_final = p.svc_count0.astype(np.int64).copy()
    np.add.at(svc_final, p.svc_idx, c)
    for gi in np.flatnonzero(p.max_replicas > 0):
        assert (svc_final[p.svc_idx[gi]]
                <= int(p.max_replicas[gi])).all(), \
            f"group {gi}: max_replicas cap exceeded"

    # host ports, ORDER-AWARE: claims fold in canonical group order, so
    # group gi may never claim a port occupied by the initial state OR by
    # any earlier group's claim — the oracle's incremental-claim
    # semantics, which the kernel's in-scan port fold must mirror. (Also
    # subsumes the pairwise "no two groups share a port on one node".)
    port_occ = p.port_used0.copy()                        # [N, PV]
    for gi in np.flatnonzero(p.has_ports):
        assert (c[gi] <= 1).all(), \
            f"port group {gi}: >1 task on one node"
        pids = np.flatnonzero(p.group_ports[gi])
        conflict = port_occ[:, pids].any(axis=1)
        assert not (c[gi][conflict] > 0).any(), \
            f"port group {gi}: placed on a node whose port was already " \
            f"claimed (initial state or an earlier group in batch order)"
        port_occ[np.ix_(c[gi] > 0, pids)] = True

    # topology balance: the outermost preference level pours by the water
    # principle, so a branch with END-state slack (a fortiori slack at
    # fill time — capacity only depletes as groups fold) bounds every
    # poured branch's final service total to within one unit. Binpack
    # ignores preferences (flat consolidation fill) so the check applies
    # to the spread/topology strategies only; binpack's fill itself is
    # covered by the strategy-aware sampled oracle above.
    sr = np.asarray(p.spread_rank)
    if sr.shape[1] > 0 and getattr(p, "strategy", "spread") != "binpack":
        _check_topology_balance(p, c, mask, used, svc_final, port_occ)

    return {
        "placed": int(c.sum()),
        "tasks": int(p.n_tasks.sum()),
        "groups": int(len(p.n_tasks)),
        "nodes": len(p.node_ids),
    }


def _check_topology_balance(p, c, mask, used, svc_final, port_occ):
    """Water property of the outermost preference level.

    The level-0 pour gives each unit to the branch with the smallest
    (service total, rank), where a branch's total counts ALL its nodes
    (nodeset.go:88-104) and its cap sums eligible nodes' capacity. Hence
    at completion, for any poured branch a and any branch b that still
    had capacity: k_a + y_a <= k_b + y_b + 1 (b was in the pour heap the
    whole time, so a's last unit went to a total no higher than b's).
    Fill-time caps are unobservable post-hoc, but capacity is MONOTONE
    non-increasing across the batch fold — so end-state slack implies
    fill-time slack, and the end-state check is sound (conservative:
    branches saturated only late escape it). Fill-time service totals
    are exact: unique service rows (the synth builder's shape) read
    svc_count0 directly; shared rows replay the canonical fold order.
    """
    G, N = c.shape
    r0 = np.asarray(p.spread_rank)[:, 0, :]
    B = int(r0.max()) + 1
    avail_end = p.avail_res.astype(np.int64) - used            # [N, R]
    svc_idx = np.asarray(p.svc_idx)
    unique_rows = len(np.unique(svc_idx)) == len(svc_idx)
    if not unique_rows:
        run: dict[int, np.ndarray] = {}
        before = []
        for gi in range(G):
            s = int(svc_idx[gi])
            b = run.get(s)
            if b is None:
                b = p.svc_count0[s].astype(np.int64)
            before.append(b)
            run[s] = b + c[gi]

    # chunked over groups: each chunk is a handful of O(chunk·N) C-speed
    # passes (bincount on flattened (group, branch) keys), so the sweep
    # stays feasible at the scale-out grid without a [G, N] staging copy
    CH = 128
    big = np.int64(1) << 40
    for g0 in range(0, G, CH):
        gs = slice(g0, min(g0 + CH, G))
        ch = gs.stop - g0
        r = np.ascontiguousarray(r0[gs]).astype(np.int64)
        flat = (np.arange(ch, dtype=np.int64)[:, None] * B + r).ravel()
        y = np.bincount(flat, weights=c[gs].ravel(),
                        minlength=ch * B).reshape(ch, B).astype(np.int64)
        if unique_rows:
            sb = p.svc_count0[svc_idx[gs]]
        else:
            sb = np.stack(before[g0:gs.stop])
        k = np.bincount(flat, weights=np.asarray(sb, np.float64).ravel(),
                        minlength=ch * B).reshape(ch, B).astype(np.int64)
        slack = mask[gs] & (avail_end[None, :, :]
                            >= p.need_res[gs][:, None, :]).all(axis=2)
        for j in np.flatnonzero(p.max_replicas[gs] > 0):
            slack[j] &= (svc_final[svc_idx[g0 + j]]
                         < int(p.max_replicas[g0 + j]))
        for j in np.flatnonzero(p.has_ports[gs]):
            pids = np.flatnonzero(p.group_ports[g0 + j])
            slack[j] &= ~port_occ[:, pids].any(axis=1)
        b_slack = np.bincount(flat, weights=slack.ravel(),
                              minlength=ch * B).reshape(ch, B) > 0
        ky = k + y
        poured = y > 0
        hi = np.where(poured, ky, -big).max(axis=1)
        lo = np.where(b_slack, ky, big).min(axis=1)
        valid = poured.any(axis=1) & b_slack.any(axis=1)
        bad = valid & (hi > lo + 1)
        assert not bad.any(), (
            f"group {g0 + int(np.flatnonzero(bad)[0])}: topology "
            f"imbalance — a poured branch's service total exceeds a "
            f"slack branch's by more than one")
