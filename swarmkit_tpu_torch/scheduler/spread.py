"""Canonical spread-placement semantics (the parity oracle).

The reference's spread strategy (manager/scheduler/scheduler.go:694-921)
round-robins a task group over nodes ordered by the `nodeLess` comparator —
recent-failure penalty, then per-service active count, then total active
count (scheduler.go:708-735) — re-filtering each node after every assignment.
Go map iteration makes the reference nondeterministic across runs; per
SURVEY.md §7 we instead define a *canonical deterministic ordering* — ties
break by node index — and implement it twice:

  * here: greedy heap fill (the oracle);
  * ops/placement.py: a closed-form water-fill, as hand-written CUDA
    kernels and their plain PyTorch versions, that provably emits
    identical placements (greedy with uniform (+1,+1) increments equals
    taking the globally smallest slots in sorted order).

The binpack strategy has its own oracles here (`binpack_fill`, the heap
greedy; `binpack_reference`, the closed form the K9 kernel computes;
`binpack_slot_order`, the canonical assignment order).

A node's *capacity* within one group fill folds in the dynamic filters the
reference re-checks mid-fill (scheduler.go:910): resource depletion,
max-replicas, and host-port exclusivity.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

PENALTY_BASE = 1 << 20  # lexicographic linearization of (penalty, svc_count)


@dataclass
class GroupFill:
    """One (service, spec_version) task group's placement problem against a
    fixed node table. All arrays are parallel over nodes."""

    n_tasks: int
    eligible: list[bool]     # static mask: ready/constraint/platform/plugin
    capacity: list[int]      # per-node cap: resources // need, max-replicas, ports
    penalty: list[bool]      # >=5 recent failures for this service version
    svc_count: list[int]     # active tasks of this service on the node
    total_count: list[int]   # total active tasks on the node


def greedy_fill(g: GroupFill) -> list[int]:
    """Assign g.n_tasks over nodes; returns per-node counts.

    Greedy: repeatedly give one task to the smallest node by
    (penalty*B + svc_count, total_count, node_idx); each assignment increments
    both svc_count and total_count and consumes one unit of capacity.
    """
    n = len(g.eligible)
    counts = [0] * n
    heap: list[tuple[int, int, int]] = []
    key = [0] * n
    tot = list(g.total_count)
    for i in range(n):
        if g.eligible[i] and g.capacity[i] > 0:
            key[i] = (PENALTY_BASE if g.penalty[i] else 0) + g.svc_count[i]
            heapq.heappush(heap, (key[i], tot[i], i))
    remaining = g.n_tasks
    while remaining > 0 and heap:
        k, t, i = heapq.heappop(heap)
        counts[i] += 1
        remaining -= 1
        key[i] += 1
        tot[i] += 1
        if counts[i] < g.capacity[i]:
            heapq.heappush(heap, (key[i], tot[i], i))
    return counts


def tree_fill(g: GroupFill, level_ranks: list[list[int]]) -> list[int]:
    """Canonical spread-preference fill (the oracle for the hierarchical
    kernel).

    Re-derivation of the reference's preference tree walk
    (manager/scheduler/nodeset.go:50-124 builds a tree bucketing nodes by
    each preference's label value; scheduler.go:772-822 splits a task group
    so per-branch service totals equalize). The reference's split is
    Go-map-order dependent; our canonical semantics (documented, applied
    identically by the oracle and the kernels):

      at each level, branches are filled by the SAME water principle as
      nodes — pour the level's quota so per-branch totals
      (existing service tasks + newly assigned) equalize, capped by branch
      capacity, ties broken by branch rank — then recurse per branch; the
      leaf level is the flat canonical fill over nodes.

    `level_ranks[l][i]` is node i's branch id at level l; branch ids are
    contiguous ranks of the value-path PREFIX (so equal rank at level l
    implies equal rank at every level above). Branch totals count the
    service tasks of ALL of a branch's nodes — even scheduling-ineligible
    ones (nodeset.go:88-104).
    """
    if not level_ranks:
        return greedy_fill(g)
    n = len(g.eligible)
    branch_svc = g.svc_count

    def fill(level: int, node_idx: list[int], quota: int) -> list[tuple[int, int]]:
        """Returns [(node, count)] with sum(count) <= quota."""
        if level == len(level_ranks):
            sub = GroupFill(
                n_tasks=quota,
                eligible=[g.eligible[i] for i in node_idx],
                capacity=[g.capacity[i] for i in node_idx],
                penalty=[g.penalty[i] for i in node_idx],
                svc_count=[g.svc_count[i] for i in node_idx],
                total_count=[g.total_count[i] for i in node_idx],
            )
            counts = greedy_fill(sub)
            return [(node_idx[j], c) for j, c in enumerate(counts) if c]

        ranks = level_ranks[level]
        branches: dict[int, list[int]] = {}
        for i in node_idx:
            branches.setdefault(ranks[i], []).append(i)
        border = sorted(branches)
        # branch aggregates: existing totals over ALL branch nodes;
        # capacity over eligible nodes only
        k = {b: sum(branch_svc[i] for i in branches[b]) for b in border}
        cap = {b: sum(g.capacity[i] for i in branches[b]
                      if g.eligible[i] and g.capacity[i] > 0)
               for b in border}
        # pour `quota` over branches: greedy by (current total, rank)
        give = _pour(quota, [k[b] for b in border], [cap[b] for b in border])
        out: list[tuple[int, int]] = []
        for rank_pos, b in enumerate(border):
            q = give[rank_pos]
            if q > 0:
                out.extend(fill(level + 1, branches[b], q))
        return out

    pairs = fill(0, list(range(n)), g.n_tasks)
    counts = [0] * n
    for i, c in pairs:
        counts[i] += c
    return counts


def _pour(quota: int, totals: list[int], caps: list[int]) -> list[int]:
    """Equalize: repeatedly give one unit to the smallest (total, index)
    entry with remaining cap. Greedy form — the branch-level analogue of
    greedy_fill, provably equal to the closed-form water level."""
    m = len(totals)
    give = [0] * m
    heap = [(totals[j], j) for j in range(m) if caps[j] > 0]
    heapq.heapify(heap)
    left = quota
    while left > 0 and heap:
        t, j = heapq.heappop(heap)
        give[j] += 1
        left -= 1
        if give[j] < caps[j]:
            heapq.heappush(heap, (t + 1, j))
    return give


def binpack_fill(g: GroupFill) -> list[int]:
    """Binpack strategy oracle: prefer the FULLEST feasible node.

    Canonical order (documented, applied identically by the oracle and the
    kernel):
    (penalty, -svc_count, -total_count, node_idx) — the spread comparator
    with the count legs inverted, penalty still dominant, node index the
    final tie-break. Each assignment increments svc/total, so an assigned
    node's key strictly IMPROVES (-svc decreases) — greedy therefore
    drains each node to capacity before moving on, i.e. sequential
    consumption in initial-key order (`binpack_reference` is the closed
    form the kernel mirrors). Spread preferences are ignored: binpack is
    a pure consolidation strategy (flat fill).
    """
    n = len(g.eligible)
    counts = [0] * n
    heap: list[tuple[int, int, int]] = []
    key = [0] * n
    tot = list(g.total_count)
    for i in range(n):
        if g.eligible[i] and g.capacity[i] > 0:
            key[i] = (PENALTY_BASE if g.penalty[i] else 0) - g.svc_count[i]
            heapq.heappush(heap, (key[i], -tot[i], i))
    remaining = g.n_tasks
    while remaining > 0 and heap:
        k, t, i = heapq.heappop(heap)
        counts[i] += 1
        remaining -= 1
        key[i] -= 1
        tot[i] += 1
        if counts[i] < g.capacity[i]:
            heapq.heappush(heap, (key[i], -tot[i], i))
    return counts


def binpack_reference(g: GroupFill) -> list[int]:
    """Closed-form binpack (the kernel's math, host-side): sort nodes by
    the INITIAL key (penalty, -svc_count, -total_count, node_idx) and
    consume capacities sequentially. Equal to `binpack_fill` because an
    assignment only improves the assigned node's key — the heap never
    switches nodes before capacity exhausts."""
    n = len(g.eligible)
    cap = [g.capacity[i] if g.eligible[i] and g.capacity[i] > 0 else 0
           for i in range(n)]
    order = sorted(range(n), key=lambda i: (
        1 if g.penalty[i] else 0, -g.svc_count[i], -g.total_count[i], i))
    left = min(g.n_tasks, sum(cap))
    counts = [0] * n
    for i in order:
        if left <= 0:
            break
        take = min(cap[i], left)
        counts[i] = take
        left -= take
    return counts


def binpack_slot_order(g: GroupFill, counts: list[int]) -> list[int]:
    """Canonical assignment order of a binpack fill: nodes in initial-key
    order, each node's slots consecutive (sequential consumption)."""
    order = sorted(range(len(g.eligible)), key=lambda i: (
        1 if g.penalty[i] else 0, -g.svc_count[i], -g.total_count[i], i))
    out: list[int] = []
    for i in order:
        out.extend([i] * counts[i])
    return out
