"""Batched scheduling backends over an EncodedProblem.

Both backends consume the same encoder output and the same canonical spread
semantics; they differ only in the fill engine:

  * `cpu_schedule_encoded` — numpy + greedy heap fill (the oracle);
  * `device_schedule_encoded` — the placement kernels of `ops.placement`.

Placement parity between them is the judged property. `materialize` turns
per-(group, node) counts into the deterministic task→node map both backends
share: a group's tasks, sorted by id, zip with the canonical slot order.

The commit walk (`apply_placements`) runs in C (`native/_hostops.c`) when
the native module is built, and in Python otherwise; the Python walk is the
oracle the C one is held to.
"""
from __future__ import annotations

from operator import itemgetter

import numpy as np

from .. import native
from ..utils import failpoints
from .encode import UNLIMITED, VOL_TOPO_MOUNTS, EncodedProblem
from .nodeinfo import NodeInfo, task_reservations
from .spread import GroupFill, binpack_fill, greedy_fill, tree_fill


def _group_caps(p: EncodedProblem, gi: int, avail: np.ndarray,
                svc: np.ndarray, port_used: np.ndarray) -> np.ndarray:
    """Dynamic per-node capacity for group gi — numpy mirror of the kernel's
    step() capacity computation."""
    N = avail.shape[0]
    need = p.need_res[gi]
    caps = np.full(N, UNLIMITED, np.int64)
    for r in range(need.shape[0]):
        if need[r] > 0:
            caps = np.minimum(caps, avail[:, r] // need[r])
    if p.max_replicas[gi] > 0:
        caps = np.minimum(caps, p.max_replicas[gi] - svc)
    if p.has_ports[gi]:
        conflict = (p.group_ports[gi][None, :] & port_used).any(axis=1)
        caps = np.minimum(caps, np.where(conflict, 0, 1))
    return np.clip(caps, 0, UNLIMITED)


def _static_legs(p: EncodedProblem) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The static mask's component legs — (cons_ok, plat_ok, missing),
    each [G, N] — shared by cpu_static_mask and cpu_filter_explain."""
    cols = np.clip(p.constraints[:, :, 0], 0, None)
    ops_ = p.constraints[:, :, 1]
    vals = p.constraints[:, :, 2]
    padded = p.constraints[:, :, 0] < 0
    nv = p.node_val[:, cols]                       # [N, G, C]
    hit = nv == vals[None]
    ok = np.where(ops_[None] == 0, hit, ~hit)
    cons_ok = np.all(ok | padded[None], axis=2).T  # [G, N]

    pr = p.plat_req
    row_valid = pr[:, :, 0] > -2
    has_plat = row_valid.any(axis=1)
    os_ok = (pr[:, :, 0][:, :, None] == 0) | (
        pr[:, :, 0][:, :, None] == p.node_plat[:, 0][None, None, :])
    arch_ok = (pr[:, :, 1][:, :, None] == 0) | (
        pr[:, :, 1][:, :, None] == p.node_plat[:, 1][None, None, :])
    plat_hit = (os_ok & arch_ok & row_valid[:, :, None]).any(axis=1)
    plat_ok = np.where(has_plat[:, None], plat_hit, True)

    missing = (p.req_plugins[:, None, :] & ~p.node_plugins[None, :, :]).any(axis=2)
    return cons_ok, plat_ok, missing


def cpu_static_mask(p: EncodedProblem) -> np.ndarray:
    """numpy mirror of ops.placement.build_static_mask."""
    cons_ok, plat_ok, missing = _static_legs(p)
    out = p.ready[None, :] & cons_ok & plat_ok & ~missing & p.extra_mask
    vt = getattr(p, "vol_topo", None)
    if vt is not None and vt.shape[1] > 0:
        out = out & _cpu_vol_topo_ok(p.node_val, vt)
    return out


def _cpu_vol_topo_ok(node_val: np.ndarray, vol_topo: np.ndarray) -> np.ndarray:
    """numpy mirror of ops.placement._vol_topo_ok: a node passes a group's
    volume leg when EVERY mount has SOME candidate row all of whose
    (key, value) pairs match the node's columns. Padded keys (-1) match
    anything; a looked-up value id of -1 matches nothing (no node carries
    that value). Mount ids beyond the group's rows impose no constraint —
    zero-candidate mounts were blanked via extra_mask at encode time."""
    G, VA, W = vol_topo.shape
    N = node_val.shape[0]
    mount = vol_topo[:, :, 0]
    row_ok = np.ones((G, VA, N), bool)
    for s in range((W - 1) // 2):
        k = vol_topo[:, :, 1 + 2 * s]
        v = vol_topo[:, :, 2 + 2 * s]
        nv = node_val[:, np.clip(k, 0, None)]          # [N, G, VA]
        ok = (k < 0)[None] | (nv == v[None])
        row_ok &= np.transpose(ok, (1, 2, 0))
    vol_ok = np.ones((G, N), bool)
    for m in range(VOL_TOPO_MOUNTS):
        is_m = mount == m
        has_m = is_m.any(axis=1)
        m_ok = (row_ok & is_m[:, :, None]).any(axis=1)
        vol_ok &= np.where(has_m[:, None], m_ok, True)
    return vol_ok


def cpu_schedule_encoded(p: EncodedProblem) -> np.ndarray:
    """Sequential-groups greedy fill; returns counts int32[G, N]."""
    G, N = p.extra_mask.shape
    static_mask = cpu_static_mask(p)
    totals = p.total0.astype(np.int64).copy()
    svc_counts = p.svc_count0.astype(np.int64).copy()
    avail = p.avail_res.astype(np.int64).copy()
    port_used = p.port_used0.copy()
    out = np.zeros((G, N), np.int32)
    for gi in range(G):
        svc = svc_counts[p.svc_idx[gi]]
        caps = _group_caps(p, gi, avail, svc, port_used)
        g = GroupFill(
            n_tasks=int(p.n_tasks[gi]),
            eligible=static_mask[gi].tolist(),
            capacity=caps.tolist(),
            penalty=p.penalty[gi].tolist(),
            svc_count=svc.tolist(),
            total_count=totals.tolist(),
        )
        if getattr(p, "strategy", "spread") == "binpack":
            # binpack ignores spread preferences: flat fullest-first fill
            counts = np.array(binpack_fill(g), np.int32)
        else:
            lmax = 0 if p.spread_rank is None else p.spread_rank.shape[1]
            if lmax:
                level_ranks = [p.spread_rank[gi, li].tolist()
                               for li in range(lmax)]
                counts = np.array(tree_fill(g, level_ranks), np.int32)
            else:
                counts = np.array(greedy_fill(g), np.int32)
        out[gi] = counts
        totals += counts
        svc_counts[p.svc_idx[gi]] += counts
        avail -= counts[:, None].astype(np.int64) * p.need_res[gi][None, :]
        port_used |= p.group_ports[gi][None, :] & (counts > 0)[:, None]
    return out


def device_schedule_encoded(p: EncodedProblem, device=None) -> np.ndarray:
    """The device backend (counterpart of the JAX package's
    `tpu_schedule_encoded`): the placement kernels on the card, or their
    plain PyTorch versions with `device="cpu"`. Returns counts int32[G, N]."""
    # deferred: the scheduler's host modules do not need torch loaded
    from ..ops import placement as placement_ops

    return placement_ops.schedule_encoded(p, device=device)


def materialize_orders(p: EncodedProblem, counts: np.ndarray) -> list:
    """counts[G, N] → per-group canonical slot order (node indices),
    deterministic across backends.

    Vectorized slot ordering: a group's filled slots sort by
    (key_at_slot, total_at_slot, node_idx) — the order greedy filled them.
    All slot tuples are distinct (within a node both key and total strictly
    increase per slot; across nodes the index differs), so the numpy lexsort
    reproduces the per-slot heap order exactly. The group's id-sorted tasks zip
    with its order; tasks beyond the order length are unplaced and stay
    PENDING."""
    from .spread import PENALTY_BASE

    N = len(p.node_ids)
    node_arange = np.arange(N)
    totals = p.total0.astype(np.int64).copy()
    svc_counts = p.svc_count0.astype(np.int64).copy()
    orders: list[np.ndarray] = []
    for gi in range(len(p.groups)):
        c = counts[gi].astype(np.int64)
        placed = int(c.sum())
        if placed:
            svc = svc_counts[p.svc_idx[gi]]
            if getattr(p, "strategy", "spread") == "binpack":
                # binpack slot order = nodes in INITIAL key order
                # (penalty, -svc, -total, idx), each repeated counts[i]
                # times: every slot on a node sorts before any slot on the
                # next node (spread.binpack_slot_order)
                pen = np.where(p.penalty[gi], 1, 0)
                order_nodes = np.lexsort((node_arange, -totals, -svc, pen))
                orders.append(np.repeat(order_nodes, c[order_nodes]))
                totals += c
                svc_counts[p.svc_idx[gi]] += c
                continue
            base_k = np.where(p.penalty[gi], PENALTY_BASE, 0) + svc
            idx = np.repeat(node_arange, c)                       # [placed]
            j = np.arange(placed) - np.repeat(np.cumsum(c) - c, c)
            key = base_k[idx] + j
            tot = totals[idx] + j
            # per-group 3-key lexsorts measured FASTER than one global
            # batched sort at every probed shape (5 ms vs 19 ms at
            # 100k x 10k quiet: the ~5k-row per-group sorts stay cache-
            # resident; a fused [T]-sized 4-key radix does not) — keep
            # the simple loop
            orders.append(idx[np.lexsort((idx, tot, key))])
            totals += c
            svc_counts[p.svc_idx[gi]] += c
        else:
            orders.append(node_arange[:0])
    return orders


def group_needs_per_task_add(t0) -> bool:
    """True when a group's bookkeeping can't be bulked: generic-resource
    claims mutate per-task pools and host-published ports maintain the
    node's port set — both need the full `NodeInfo.add_task` path."""
    return bool(task_reservations(t0.spec).generic
                or NodeInfo._host_ports(t0))


def _add_serial(info, tasks) -> int:
    """Per-task oracle path (collision-segment fallback of both the native
    and the Python bulk walks)."""
    return sum(1 for t in tasks if info.add_task(t))


def apply_placements(infos: list, placed_groups: list, *,
                     native_walk: bool = True) -> int:
    """Bulk NodeInfo bookkeeping for one committed scheduler wave.
    placed_groups: (t0, tasks, node_idx[, ids]) per group — tasks[i] was
    placed on infos[node_idx[i]]; t0 is any task carrying the group's
    shared spec content; optional ids is the parallel id list built while
    the tasks were cache-hot (TaskGroup.ids); with it the native walk never
    dereferences a task object. State lands bit-identical
    to calling `add_task` per task — mutations counter included (the encoder fingerprint contract)
    — at O(nodes + cells) Python cost instead of O(tasks)
    attribute-chasing per placement (the reference pays that walk in
    updateNodeInfo, manager/scheduler/scheduler.go:330-346; typical big
    waves degenerate to ~1 task per (group, node) cell, so per-cell
    bulking alone doesn't pay either).

    Caller contract (what the scheduler's commit guarantees): a group's
    tasks share spec CONTENT (same (service_id, spec_version) group) and
    have desired_state <= COMPLETE (active). Groups with generic
    reservations or host-published ports take the full per-task path
    (their claims mutate per-task pools). Defensive residue: a node whose
    incoming ids collide with tasks already on it falls back to per-task
    add_task for its whole segment; a None info (node removed between
    encode and commit) is skipped, uncounted.

    The walk runs in C (`native/_hostops.c`, built at first use) unless the
    module is unavailable or `native_walk=False`, which takes the Python
    walk below: the oracle the C walk is held to."""
    # failpoint `commit.walk`: a crash at the walk's stage boundary, before
    # any NodeInfo mutates (the all-or-nothing point)
    failpoints.fp("commit.walk")
    # validate EVERYTHING before mutating anything: a mid-wave raise
    # would leave NodeInfo bookkeeping half-applied with no heal path
    checked: list[tuple] = []
    for entry in placed_groups:
        t0, tasks, nidx = entry[0], entry[1], entry[2]
        ids = entry[3] if len(entry) > 3 else None
        nidx = np.asarray(nidx, np.int64)
        if len(tasks) != len(nidx):
            # a silent zip-truncation here would book the wrong tasks
            # onto nodes once groups concatenate — fail loudly instead
            raise ValueError(
                f"apply_placements: group {t0.service_id!r} has "
                f"{len(tasks)} tasks but {len(nidx)} node indices")
        if len(nidx) and (int(nidx.min()) < 0
                          or int(nidx.max()) >= len(infos)):
            # a leaked unplaced sentinel (-1) would silently wrap to
            # infos[-1] in the per-task branch below
            raise IndexError(
                f"apply_placements: group {t0.service_id!r} node index "
                f"out of range for {len(infos)} nodes")
        if ids is None:
            ids = [t.id for t in tasks]     # cold-but-correct fallback
        elif len(ids) != len(tasks):
            raise ValueError(
                f"apply_placements: group {t0.service_id!r} ids/tasks "
                "length mismatch")
        if len(tasks):
            checked.append((t0, tasks, nidx, ids))

    n_added = 0
    plain: list[tuple] = []
    for t0, tasks, nidx, ids in checked:
        if group_needs_per_task_add(t0):
            for t, ni in zip(tasks, nidx.tolist()):
                info = infos[ni]
                if info is not None and info.add_task(t):
                    n_added += 1
        else:
            plain.append((t0, tasks, nidx, ids))
    if not plain:
        return n_added

    hostops = native.load() if native_walk else None
    if hostops is not None:
        # whole-wave native path: the per-group lists go straight in; the C
        # side counting-sorts node-major (group-stable: the order of the
        # argsort concatenation below) and walks the segments in one pass,
        # releasing the GIL between them
        entries = []
        for t0, tasks, nidx, ids in plain:
            res = task_reservations(t0.spec)
            entries.append((
                tasks if isinstance(tasks, list) else list(tasks),
                ids if isinstance(ids, list) else list(ids),
                np.ascontiguousarray(nidx, np.int64),
                int(res.memory_bytes or 0), int(res.nano_cpus or 0),
                t0.service_id))
        return n_added + hostops.apply_wave(infos, entries, _add_serial)

    # exact int64 per-node aggregates, one vector op per group
    N = len(infos)
    mem_acc = np.zeros(N, np.int64)
    cpu_acc = np.zeros(N, np.int64)
    tasks_all: list = []
    ids_all: list = []
    nodes_parts: list[np.ndarray] = []
    gi_parts: list[np.ndarray] = []
    svc_of: list[str] = []
    for gi, (t0, tasks, nidx, ids) in enumerate(plain):
        res = task_reservations(t0.spec)
        svc_of.append(t0.service_id)
        cg = np.bincount(nidx, minlength=N)
        if res.memory_bytes:
            mem_acc += cg * res.memory_bytes
        if res.nano_cpus:
            cpu_acc += cg * res.nano_cpus
        tasks_all.extend(tasks)
        ids_all.extend(ids)
        nodes_parts.append(nidx)
        gi_parts.append(np.full(len(nidx), gi, np.int64))

    nodes_all = np.concatenate(nodes_parts)
    oi = np.argsort(nodes_all, kind="stable")     # node-major, group-stable
    nodes_srt = nodes_all[oi]

    # itemgetter gather, NOT a numpy object array: filling one inspects
    # every element for the sequence protocol (~1.3 s/M tasks measured)
    oi_l = oi.tolist()
    tasks_srt = (list(itemgetter(*oi_l)(tasks_all)) if len(oi_l) > 1
                 else [tasks_all[oi_l[0]]])
    ids_srt = (list(itemgetter(*oi_l)(ids_all)) if len(oi_l) > 1
               else [ids_all[oi_l[0]]])
    svc_arr = np.empty(len(plain), object)
    svc_arr[:] = svc_of
    svc_srt = svc_arr[np.concatenate(gi_parts)[oi]].tolist()

    starts = np.flatnonzero(np.diff(nodes_srt, prepend=-1))
    seg_bounds = np.append(starts, len(nodes_srt)).tolist()
    seg_nodes = nodes_srt[starts].tolist()
    mem_l, cpu_l = mem_acc.tolist(), cpu_acc.tolist()
    for si, node in enumerate(seg_nodes):
        a, b = seg_bounds[si], seg_bounds[si + 1]
        info = infos[node]
        if info is None:
            continue
        ids = ids_srt[a:b]
        if not info.tasks.keys().isdisjoint(ids):
            # collision (e.g. a healed double-commit): full per-task path
            # for this node — it does its own counter/resource/service
            # bookkeeping, so skip every bulk update below
            n_added += _add_serial(info, tasks_srt[a:b])
            continue
        k = b - a
        before = len(info.tasks)
        info.tasks.update(zip(ids, tasks_srt[a:b]))
        if len(info.tasks) - before != k:
            # duplicate id WITHIN the wave (contract breach): the dict
            # dedups but the counters below would double-count — undo
            # the inserts and heal through the serial path, whose re-add
            # logic counts each id once (bit-identical to the oracle)
            for i in ids:
                info.tasks.pop(i, None)
            n_added += _add_serial(info, tasks_srt[a:b])
            continue
        info.mutations += k
        info.active_tasks_count += k
        ar = info.available_resources
        ar.memory_bytes -= mem_l[node]
        ar.nano_cpus -= cpu_l[node]
        # one C-speed multiset fold per segment (why by-service counts
        # are a Counter): each task contributes its group's service name
        info.active_tasks_count_by_service.update(svc_srt[a:b])
        n_added += k
    return n_added


def apply_wave(infos: list, groups: list, orders: list, *,
               native_walk: bool = True) -> int:
    """One scheduler wave's NodeInfo bookkeeping: per group, the id-sorted
    tasks zip with the canonical slot order (materialize_orders output);
    tasks past the order length are unplaced. infos is indexed by the
    problem's node order (None = node gone). Returns tasks added —
    `== counts.sum()` iff the wave applied cleanly (the apply_counts
    contract). `native_walk=False` takes the Python walk."""
    placed_groups = []
    for g, order in zip(groups, orders):
        k = len(order)
        if k:
            ids = g.task_ids() if hasattr(g, "task_ids") else None
            placed_groups.append(
                (g.tasks[0], g.tasks[:k] if k < len(g.tasks) else g.tasks,
                 order, ids[:k] if ids is not None and k < len(ids)
                 else ids))
    return apply_placements(infos, placed_groups, native_walk=native_walk)


def materialize(p: EncodedProblem, counts: np.ndarray) -> dict[str, str]:
    """counts[G, N] → {task_id: node_id} (materialize_orders + id zip)."""
    assignments: dict[str, str] = {}
    node_ids_arr = np.array(p.node_ids, dtype=object)
    for group, order in zip(p.groups, materialize_orders(p, counts)):
        if len(order):
            chosen = node_ids_arr[order].tolist()
            assignments.update(zip((t.id for t in group.tasks), chosen))
    return assignments
