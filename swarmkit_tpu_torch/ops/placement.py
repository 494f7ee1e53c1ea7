"""Batched task×node placement (the port of the JAX package's
`ops/placement.py`).

`schedule_groups` places every pending task group, in order, over the
nodes: a static eligibility mask[G, N], then for each group a step that
computes the group's per-node capacity, fills its tasks (spread: a water
fill under the canonical order (penalty, svc_count, total_count,
node_idx); binpack: fullest first, in the order (penalty, -svc_count,
-total_count, node_idx)) and folds the result into the node state that the
next group sees. The counts are bit-identical to the greedy CPU oracle
(`scheduler.batch.cpu_schedule_encoded`) and to the JAX reference.

Four kernels carry it, each a hand-written CUDA kernel (csrc/) with its
plain PyTorch version beside its wrapper:

  * `static_mask`       (K1, csrc/static_mask.cu)  — the mask
                                                     (`sharded_static_mask`:
                                                     k node shards in one
                                                     launch);
  * `flat_fill_step`    (K2, csrc/flat_fill.cu)    — a spread step, no
                                                     spread levels;
  * `tree_fill_step`    (K3, csrc/tree_fill.cu)    — a spread step with
                                                     spread levels;
  * `binpack_fill_step` (K9, csrc/binpack_fill.cu) — a binpack step (spread
                                                     levels ignored).

A wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; anything else raises. Every launch adds
one to the wrapper's `launches` counter. Groups depend on each other through
the node state, so the host launches one step per group, in order, on the
current stream; nothing synchronises between them.

The int32 contract: every int32 sum of a group step is bounded by the
group's capacity sum, the sum over its eligible nodes of min(cap, n_tasks),
so the reference (which has no x64) is exact while that sum stays below
2^31. Each step takes the sum in 64 bits and writes the group's overflow
flag (flags[g], 1 from 2^31 on, when the group places and folds nothing);
the entries raise `ValueError` ("... >= 2^31") when they read a set flag
with the counts.

`schedule_core` is that loop on tensors already on the device, folding into
a caller-owned `FillState` in place: the one-shot entries below call it on
clones of their inputs, and the device-resident tick (`ops/resident.py`) on
the state it keeps on the card across ticks. `strategy=0` is spread (and
topology, which the encoder turns into an extra outer spread level),
`strategy=1` binpack.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..convert import to_kernel_tensors
from ..device import resolve_device
from ..scheduler.encode import VOL_TOPO_MOUNTS, kernel_args
from ..scheduler.spread import PENALTY_BASE
from . import _kernels

UNLIMITED = 1 << 30
_POUR_BITS = 30          # water-level search range: 31 bisect steps
_SEC_PAD = 1 << 30       # secondary key of nodes off the boundary
_I32_MAX = (1 << 31) - 1
_I32_LIMIT = 1 << 31     # a group's capacity sum is refused from here


class FillTables(NamedTuple):
    """Group-side inputs of the fill steps (read-only)."""

    mask: torch.Tensor           # bool[G, N] static eligibility
    need_res: torch.Tensor       # int32[G, R]
    n_tasks: torch.Tensor        # int32[G]
    svc_idx: torch.Tensor        # int32[G]
    max_replicas: torch.Tensor   # int32[G]; 0 == unlimited
    penalty: torch.Tensor        # bool[G, N]
    has_ports: torch.Tensor      # bool[G]
    group_ports: torch.Tensor    # bool[G, PV]
    spread_rank: torch.Tensor    # int32[G, LMAX, N]


class FillState(NamedTuple):
    """Node-side carry of the scan; each step folds its counts in place."""

    totals: torch.Tensor         # int32[N]
    svc_counts: torch.Tensor     # int32[S, N]
    avail: torch.Tensor          # int32[N, R]
    port_used: torch.Tensor      # bool[N, PV]


def _expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor):
    return t.data_ptr() or None


# ---------------------------------------------------------------- K1 mask
def static_mask_plain(ready, node_val, node_plat, node_plugins, constraints,
                      plat_req, req_plugins, extra_mask, vol_topo):
    """Plain PyTorch eligibility mask[G, N] (JAX `build_static_mask`)."""
    K = node_val.shape[1]
    cols = constraints[:, :, 0].clamp(0, K - 1).long()       # [G, C]
    ops = constraints[:, :, 1]
    vals = constraints[:, :, 2]
    padded = constraints[:, :, 0] < 0
    nv = node_val[:, cols]                                   # [N, G, C]
    hit = nv == vals[None]
    ok = torch.where(ops[None] == 0, hit, ~hit)
    cons_ok = (ok | padded[None]).all(dim=2).T               # [G, N]

    pr = plat_req
    row_valid = pr[:, :, 0] > -2                             # [G, P]
    has_plat = row_valid.any(dim=1)
    os_ok = (pr[:, :, 0][:, :, None] == 0) | (
        pr[:, :, 0][:, :, None] == node_plat[:, 0][None, None, :])
    arch_ok = (pr[:, :, 1][:, :, None] == 0) | (
        pr[:, :, 1][:, :, None] == node_plat[:, 1][None, None, :])
    plat_hit = (os_ok & arch_ok & row_valid[:, :, None]).any(dim=1)
    plat_ok = torch.where(has_plat[:, None], plat_hit, True)

    # "some required plugin is missing" == the reference's einsum > 0.5
    missing = (req_plugins[:, None, :] & ~node_plugins[None, :, :]).any(dim=2)

    out = ready[None, :] & cons_ok & plat_ok & ~missing & extra_mask
    G, VA, W = vol_topo.shape
    if VA > 0:
        mount = vol_topo[:, :, 0]
        row_ok = torch.ones((G, VA, node_val.shape[0]), dtype=torch.bool,
                            device=out.device)
        for s in range((W - 1) // 2):
            k = vol_topo[:, :, 1 + 2 * s]
            v = vol_topo[:, :, 2 + 2 * s]
            nv = node_val[:, k.clamp(0, K - 1).long()]       # [N, G, VA]
            row_ok &= ((k < 0)[None] | (nv == v[None])).permute(1, 2, 0)
        for m in range(VOL_TOPO_MOUNTS):
            is_m = mount == m
            m_ok = (row_ok & is_m[:, :, None]).any(dim=1)
            out &= torch.where(is_m.any(dim=1)[:, None], m_ok, True)
    return out


def _mask_dims(args) -> tuple[int, ...]:
    """Shapes, dtypes and layout of K1's inputs (`static_mask`'s argument
    order), each tensor by `_expect`. Returns (G, N, K, PL, C, P, VA, W)."""
    (ready, node_val, node_plat, node_plugins, constraints, plat_req,
     req_plugins, extra_mask, vol_topo) = args
    G, N = extra_mask.shape
    K, PL = node_val.shape[1], node_plugins.shape[1]
    C, P = constraints.shape[1], plat_req.shape[1]
    VA, W = vol_topo.shape[1], vol_topo.shape[2]
    for t, name, dtype, shape in (
            (ready, "ready", torch.bool, (N,)),
            (node_val, "node_val", torch.int32, (N, K)),
            (node_plat, "node_plat", torch.int32, (N, 2)),
            (node_plugins, "node_plugins", torch.bool, (N, PL)),
            (constraints, "constraints", torch.int32, (G, C, 3)),
            (plat_req, "plat_req", torch.int32, (G, P, 2)),
            (req_plugins, "req_plugins", torch.bool, (G, PL)),
            (extra_mask, "extra_mask", torch.bool, (G, N)),
            (vol_topo, "vol_topo", torch.int32, (G, VA, W))):
        _expect(t, name, dtype, shape)
    return G, N, K, PL, C, P, VA, W


def static_mask(ready, node_val, node_plat, node_plugins, constraints,
                plat_req, req_plugins, extra_mask, vol_topo):
    """Eligibility mask[G, N]: the plain version for CPU tensors, kernel K1
    (csrc/static_mask.cu) for CUDA tensors."""
    args = (ready, node_val, node_plat, node_plugins, constraints, plat_req,
            req_plugins, extra_mask, vol_topo)
    if _kernels.route("placement", *args) == "plain":
        return static_mask_plain(*args)
    G, N, K, PL, C, P, VA, W = _mask_dims(args)
    out = torch.empty((G, N), dtype=torch.bool, device=extra_mask.device)
    if G * N == 0:
        return out
    if K == 0:
        raise ValueError("node_val needs at least one key column")
    rc = _kernels.lib("static_mask").skt_static_mask(
        *(_ptr(t) for t in args), _ptr(out), G, N, K, PL, C, P, VA, W,
        _kernels.raw_stream(out))
    _kernels.check(rc, "static_mask")
    static_mask.launches += 1
    return out


static_mask.launches = 0


def _fits(x, dtype, shape) -> bool:
    return x.dtype == dtype and x.shape == shape and x.is_contiguous()


def _sharded_mask_dims(ready, node_val, node_plat, node_plugins,
                       constraints, plat_req, req_plugins, extra_mask,
                       vol_topo):
    """The checks of `static_mask` on every shard, in one pass: the same
    conditions (and one shard width), each tensor read once, the
    group-side tables once for all shards. Whatever it does not accept
    goes through `_mask_dims` shard by shard, in the order of a loop of
    `static_mask` calls, which raises its error as before; shards that
    each pass but differ in width raise ValueError. Returns ((k, G, n, K,
    PL, C, P, VA, W), rows): rows the five data pointers of each shard,
    in the order of the kernel's pointer table."""
    k = len(ready)
    rows = None
    try:
        G, n = extra_mask[0].shape
        K, PL = node_val[0].shape[1], node_plugins[0].shape[1]
        C, P = constraints.shape[1], plat_req.shape[1]
        VA, W = vol_topo.shape[1], vol_topo.shape[2]
        i32, b8 = torch.int32, torch.bool
        if (len(node_val) == len(node_plat) == len(node_plugins)
                == len(extra_mask) == k
                and _fits(constraints, i32, (G, C, 3))
                and _fits(plat_req, i32, (G, P, 2))
                and _fits(req_plugins, b8, (G, PL))
                and _fits(vol_topo, i32, (G, VA, W))):
            rows = []
            sn, snk, sn2, snp, sgn = (n,), (n, K), (n, 2), (n, PL), (G, n)
            for r, v, pf, pg, e in zip(ready, node_val, node_plat,
                                       node_plugins, extra_mask):
                if not (r.dtype == b8 and v.dtype == i32
                        and pf.dtype == i32 and pg.dtype == b8
                        and e.dtype == b8 and r.shape == sn
                        and v.shape == snk and pf.shape == sn2
                        and pg.shape == snp and e.shape == sgn
                        and r.is_contiguous() and v.is_contiguous()
                        and pf.is_contiguous() and pg.is_contiguous()
                        and e.is_contiguous()):
                    rows = None
                    break
                rows.append((r.data_ptr(), v.data_ptr(), pf.data_ptr(),
                             pg.data_ptr(), e.data_ptr()))
    except (AttributeError, IndexError, TypeError, ValueError):
        rows = None
    if rows is not None:
        if G * n and K == 0:
            raise ValueError("node_val needs at least one key column")
        return (k, G, n, K, PL, C, P, VA, W), rows
    widths = set()
    for b in range(k):
        Gb, Nb, Kb, *_ = _mask_dims((
            ready[b], node_val[b], node_plat[b], node_plugins[b],
            constraints, plat_req, req_plugins, extra_mask[b], vol_topo))
        if Gb * Nb and Kb == 0:
            raise ValueError("node_val needs at least one key column")
        widths.add(Nb)
    lengths = [len(x) for x in (node_val, node_plat, node_plugins,
                                extra_mask)]
    raise ValueError(f"{k} shards of widths {sorted(widths)}, node lists "
                     f"of lengths {lengths}: expected one width and one "
                     "tensor a shard in each list")


def sharded_static_mask(ready, node_val, node_plat, node_plugins,
                        constraints, plat_req, req_plugins, extra_mask,
                        vol_topo):
    """The eligibility masks of k node shards: `ready`, `node_val`,
    `node_plat`, `node_plugins` and `extra_mask` are lists of k per-shard
    tensors (one width n), the group-side tables one tensor each (the same
    `extra_mask` tensor may stand for several shards). Returns k masks
    bool[G, n]. For CPU tensors, `static_mask` shard by shard (the plain
    version); for CUDA tensors kernel K1 (csrc/static_mask.cu) over every
    shard in one launch, the masks the k views of one bool[k, G, n]."""
    k = len(ready)
    if _kernels.route("placement", *ready, *node_val, *node_plat,
                      *node_plugins, *extra_mask, constraints, plat_req,
                      req_plugins, vol_topo) == "plain":
        return [static_mask(ready[b], node_val[b], node_plat[b],
                            node_plugins[b], constraints, plat_req,
                            req_plugins, extra_mask[b], vol_topo)
                for b in range(k)]
    if k == 0:
        return []
    (k, G, n, K, PL, C, P, VA, W), rows = _sharded_mask_dims(
        ready, node_val, node_plat, node_plugins, constraints, plat_req,
        req_plugins, extra_mask, vol_topo)
    dev = constraints.device
    out = torch.empty((k, G, n), dtype=torch.bool, device=dev)
    if G * n == 0:
        return list(out.unbind(0))
    table = _kernels.pointer_table(rows, dev)
    rc = _sharded_mask_entry()(
        table.data_ptr(), _ptr(constraints), _ptr(plat_req),
        _ptr(req_plugins), _ptr(vol_topo), out.data_ptr(), k, G, n, K, PL,
        C, P, VA, W, _kernels.raw_stream(out))
    _kernels.check(rc, "sharded_static_mask")
    sharded_static_mask.launches += 1
    return list(out.unbind(0))


sharded_static_mask.launches = 0


@functools.cache
def _sharded_mask_entry():
    return _kernels.lib("static_mask").skt_sharded_static_mask


# ------------------------------------------------------- the group step
def _node_caps_plain(t: FillTables, s: FillState, g: int):
    """(cap, svc) of group g: the capacity after eligibility and the n_tasks
    clip, and the group's service-count row (JAX `_schedule_core` step)."""
    row = t.svc_idx[g:g + 1].long()
    svc = s.svc_counts.index_select(0, row)[0]                # [N]
    g_need = t.need_res[g]
    need = g_need.clamp(min=1)
    caps = torch.where(g_need[None, :] > 0,
                       torch.div(s.avail, need[None, :], rounding_mode="floor"),
                       UNLIMITED)
    cap_res = caps.amin(dim=1)
    mr = t.max_replicas[g]
    cap_mr = torch.where(mr > 0, mr - svc, UNLIMITED)
    conflict = (t.group_ports[g][None, :] & s.port_used).any(dim=1)
    cap_port = torch.where(t.has_ports[g],
                           torch.where(conflict, 0, 1).to(torch.int32),
                           UNLIMITED)
    cap = torch.minimum(torch.minimum(cap_res, cap_mr), cap_port) \
        .clamp(0, UNLIMITED)
    cap = torch.minimum(torch.where(t.mask[g], cap, 0), t.n_tasks[g])
    return cap.to(torch.int32), svc


def _fold_plain(t: FillTables, s: FillState, g: int, counts) -> None:
    """The state fold after group g (JAX placement.py:364-373)."""
    s.totals.add_(counts)
    s.svc_counts.index_add_(0, t.svc_idx[g:g + 1].long(), counts[None])
    s.avail.sub_(counts[:, None] * t.need_res[g][None, :])
    s.port_used.logical_or_(t.group_ports[g][None, :] & (counts > 0)[:, None])


def _bisect(filled, q, shape, device):
    """The reference's 31-step upper-midpoint bisect for the largest level
    with filled(level) <= q, elementwise over `shape`."""
    lo = torch.zeros(shape, dtype=torch.int32, device=device)
    hi = torch.full(shape, 1 << _POUR_BITS, dtype=torch.int32, device=device)
    for _ in range(_POUR_BITS + 1):
        mid = lo + (hi - lo + 1) // 2
        take = filled(mid) <= q
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid - 1)
    return lo


def _flat_water_fill_plain(cap, pen, svc, total, n_tasks):
    """JAX `_flat_water_fill`: scalar water level, remainder by the stable
    order of (total + counts, node index)."""
    N = cap.shape[0]
    k = torch.where(pen, PENALTY_BASE, 0).to(torch.int32) + svc
    q = torch.minimum(n_tasks, cap.sum(dtype=torch.int32))
    level = _bisect(
        lambda lv: torch.minimum(cap, (lv - k).clamp(min=0))
        .sum(dtype=torch.int32), q, (), cap.device)
    counts = torch.minimum(cap, (level - k).clamp(min=0))
    rem = q - counts.sum(dtype=torch.int32)
    boundary = (cap > counts) & (k <= level) & (counts == level - k)
    sec = torch.where(boundary, total + counts, _SEC_PAD)
    order = torch.sort(sec, stable=True).indices
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(N, device=cap.device))
    extra = boundary & (pos < rem)
    return counts + extra.to(torch.int32)


def _segment_sum(data, seg, n):
    out = torch.zeros(n, dtype=torch.int32, device=data.device)
    return out.index_add_(0, seg.long(), data.to(torch.int32))


def _segment_min(data, seg, n):
    out = torch.full((n,), _I32_MAX, dtype=torch.int32, device=data.device)
    return out.scatter_reduce_(0, seg.long(), data.to(torch.int32),
                               reduce="amin", include_self=True)


def _segmented_pour_plain(quota_seg, k_child, cap_child, parent_of, valid, n):
    """JAX `_segmented_pour`: per-parent water fill over child segments."""
    cap = torch.where(valid, cap_child, 0).to(torch.int32)
    q = torch.minimum(quota_seg, _segment_sum(cap, parent_of, n))
    pl = parent_of.long()
    level = _bisect(
        lambda lp: _segment_sum(
            torch.minimum(cap, (lp[pl] - k_child).clamp(min=0)),
            parent_of, n), q, (n,), cap.device)
    lvl = level[pl]
    give = torch.where(valid, torch.minimum(cap, (lvl - k_child).clamp(min=0)),
                       0).to(torch.int32)
    rem = q - _segment_sum(give, parent_of, n)
    boundary = valid & (cap > give) & (k_child <= lvl) & (give == lvl - k_child)
    b32 = boundary.to(torch.int32)
    cum = torch.cumsum(b32, 0, dtype=torch.int32) - b32
    offset = _segment_min(torch.where(valid, cum, _SEC_PAD), parent_of, n)
    rank = cum - offset[pl]
    extra = boundary & (rank < rem[pl])
    return give + extra.to(torch.int32)


def _tree_water_fill_plain(cap, pen, svc, total, n_tasks, spread_rank):
    """JAX `_tree_water_fill` for LMAX > 0: pour the quota down the spread
    levels, then fill each leaf; remainder by (leaf, sec, node index)."""
    N = cap.shape[0]
    dev = cap.device
    zeros = torch.zeros(N, dtype=torch.int32, device=dev)
    parent_seg = zeros
    quota_seg = zeros.clone()
    quota_seg[0] = torch.minimum(n_tasks, cap.sum(dtype=torch.int32))
    for li in range(spread_rank.shape[0]):
        seg = spread_rank[li]
        k_child = _segment_sum(svc, seg, N)
        cap_child = _segment_sum(cap, seg, N)
        valid = _segment_sum(torch.ones_like(seg), seg, N) > 0
        parent_of = torch.where(valid, _segment_min(parent_seg, seg, N), 0)
        quota_seg = _segmented_pour_plain(quota_seg, k_child, cap_child,
                                          parent_of, valid, N)
        parent_seg = seg

    leaf = parent_seg
    ll = leaf.long()
    k_node = torch.where(pen, PENALTY_BASE, 0).to(torch.int32) + svc
    q = torch.minimum(quota_seg, _segment_sum(cap, leaf, N))
    level = _bisect(
        lambda lp: _segment_sum(
            torch.minimum(cap, (lp[ll] - k_node).clamp(min=0)), leaf, N),
        q, (N,), dev)
    lvl = level[ll]
    counts = torch.minimum(cap, (lvl - k_node).clamp(min=0))
    rem = q - _segment_sum(counts, leaf, N)
    boundary = (cap > counts) & (k_node <= lvl) & (counts == lvl - k_node)
    sec = torch.where(boundary, total + counts, _SEC_PAD)
    # lexsort((idx, sec, leaf)): stable sorts from the least significant key
    o1 = torch.sort(sec, stable=True).indices
    order = o1[torch.sort(leaf[o1], stable=True).indices]
    b_sorted = boundary[order].to(torch.int32)
    cum = torch.cumsum(b_sorted, 0, dtype=torch.int32) - b_sorted
    leaf_sorted = leaf[order]
    offset = _segment_min(cum, leaf_sorted, N)
    rank = torch.empty_like(cum).scatter_(
        0, order, cum - offset[leaf_sorted.long()])
    extra = boundary & (rank < rem[ll])
    return counts + extra.to(torch.int32)


def _binpack_fill_plain(cap, pen, svc, total, n_tasks):
    """JAX `_binpack_fill`: stable lexsort by (pen, -svc, -total, idx) as
    chained stable sorts from the least significant key, then the sorted
    capacities' prefix clipped against q = min(n_tasks, sum(cap))."""
    order = torch.arange(cap.shape[0], device=cap.device)
    for key in (-total, -svc, pen.to(torch.int32)):
        order = order[torch.sort(key[order], stable=True).indices]
    cap_sorted = cap[order]
    before = torch.cumsum(cap_sorted, 0, dtype=torch.int32) - cap_sorted
    q = torch.minimum(n_tasks, cap.sum(dtype=torch.int32))
    counts_sorted = torch.minimum((q - before).clamp(min=0), cap_sorted)
    return torch.empty_like(cap).scatter_(0, order, counts_sorted)


def _step_plain(fill, t: FillTables, s: FillState, g: int, out,
                flags) -> None:
    """A plain group step around `fill(cap, svc)`: the capacity sum in
    int64 decides the overflow flag; an overflowing group places and folds
    nothing (its fill ran on wrapped sums, as the reference's would, and
    is dropped without a branch on the device's data)."""
    cap, svc = _node_caps_plain(t, s, g)
    over = cap.sum(dtype=torch.int64) >= _I32_LIMIT
    counts = torch.where(over, 0, fill(cap, svc)).to(torch.int32)
    flags[g] = over.to(torch.int32)
    out[g] = counts
    _fold_plain(t, s, g, counts)


def flat_fill_step_plain(t: FillTables, s: FillState, g: int, out,
                         flags) -> None:
    """Plain PyTorch group step, no spread levels: writes out[g] and
    flags[g], folds s."""
    _step_plain(lambda cap, svc: _flat_water_fill_plain(
        cap, t.penalty[g], svc, s.totals, t.n_tasks[g]), t, s, g, out, flags)


def tree_fill_step_plain(t: FillTables, s: FillState, g: int, out,
                         flags) -> None:
    """Plain PyTorch group step with spread levels: writes out[g] and
    flags[g], folds s."""
    _step_plain(lambda cap, svc: _tree_water_fill_plain(
        cap, t.penalty[g], svc, s.totals, t.n_tasks[g], t.spread_rank[g]),
        t, s, g, out, flags)


def binpack_fill_step_plain(t: FillTables, s: FillState, g: int, out,
                            flags) -> None:
    """Plain PyTorch binpack group step: writes out[g] and flags[g],
    folds s."""
    _step_plain(lambda cap, svc: _binpack_fill_plain(
        cap, t.penalty[g], svc, s.totals, t.n_tasks[g]), t, s, g, out, flags)


def _check_fill(t: FillTables, s: FillState, out,
                flags) -> tuple[int, ...]:
    G, N = t.mask.shape
    R, PV = t.need_res.shape[1], t.group_ports.shape[1]
    S, L = s.svc_counts.shape[0], t.spread_rank.shape[1]
    for x, name, dtype, shape in (
            (t.mask, "mask", torch.bool, (G, N)),
            (t.need_res, "need_res", torch.int32, (G, R)),
            (t.n_tasks, "n_tasks", torch.int32, (G,)),
            (t.svc_idx, "svc_idx", torch.int32, (G,)),
            (t.max_replicas, "max_replicas", torch.int32, (G,)),
            (t.penalty, "penalty", torch.bool, (G, N)),
            (t.has_ports, "has_ports", torch.bool, (G,)),
            (t.group_ports, "group_ports", torch.bool, (G, PV)),
            (t.spread_rank, "spread_rank", torch.int32, (G, L, N)),
            (s.totals, "totals", torch.int32, (N,)),
            (s.svc_counts, "svc_counts", torch.int32, (S, N)),
            (s.avail, "avail", torch.int32, (N, R)),
            (s.port_used, "port_used", torch.bool, (N, PV)),
            (out, "out", torch.int32, (G, N)),
            (flags, "flags", torch.int32, (G,))):
        _expect(x, name, dtype, shape)
    return G, N, R, PV, L


def _scratch_words(words: int, what: str) -> int:
    """A C scratch query's int32 word count; negative means it passed an
    int, where the kernels' offsets stop."""
    if words < 0:
        raise ValueError(f"{what}: scratch past 2^31 int32 words")
    return words


def _group_ptrs(t: FillTables):
    return (_ptr(t.mask), _ptr(t.need_res), _ptr(t.n_tasks), _ptr(t.svc_idx),
            _ptr(t.max_replicas), _ptr(t.penalty), _ptr(t.has_ports),
            _ptr(t.group_ports))


def _state_ptrs(s: FillState):
    return (_ptr(s.totals), _ptr(s.svc_counts), _ptr(s.avail),
            _ptr(s.port_used))


def flat_fill_step(t: FillTables, s: FillState, g: int, out,
                   flags) -> None:
    """Group g's step with no spread levels: writes out[g] and the
    overflow flag flags[g], and folds the counts into s. Plain version for
    CPU tensors, kernel K2 (csrc/flat_fill.cu) for CUDA tensors."""
    if _kernels.route("placement", *t, *s, out, flags) == "plain":
        return flat_fill_step_plain(t, s, g, out, flags)
    G, N, R, PV, _ = _check_fill(t, s, out, flags)
    if not 0 <= g < G:
        raise IndexError(f"group {g} out of range for {G} groups")
    cdll = _kernels.lib("flat_fill")
    scratch = torch.empty(_scratch_words(cdll.skt_flat_fill_scratch_i32(N),
                                         "flat_fill_step"),
                          dtype=torch.int32, device=out.device)
    rc = cdll.skt_flat_fill_step(
        *_group_ptrs(t), *_state_ptrs(s), _ptr(out), _ptr(flags),
        _ptr(scratch), g, N, R, PV, _kernels.raw_stream(out))
    _kernels.check(rc, "flat_fill_step")
    flat_fill_step.launches += 1


flat_fill_step.launches = 0


def tree_fill_step(t: FillTables, s: FillState, g: int, out,
                   flags) -> None:
    """Group g's step with spread levels (LMAX > 0): writes out[g] and the
    overflow flag flags[g], and folds the counts into s. Plain version for
    CPU tensors, kernel K3 (csrc/tree_fill.cu) for CUDA tensors."""
    if _kernels.route("placement", *t, *s, out, flags) == "plain":
        return tree_fill_step_plain(t, s, g, out, flags)
    G, N, R, PV, L = _check_fill(t, s, out, flags)
    if not 0 <= g < G:
        raise IndexError(f"group {g} out of range for {G} groups")
    if L == 0:
        raise ValueError("tree_fill_step needs LMAX > 0 (use flat_fill_step)")
    cdll = _kernels.lib("tree_fill")
    scratch = torch.empty(_scratch_words(cdll.skt_tree_fill_scratch_i32(N, L),
                                         "tree_fill_step"),
                          dtype=torch.int32, device=out.device)
    scratch64 = torch.empty(2 * N, dtype=torch.int64, device=out.device)
    rc = cdll.skt_tree_fill_step(
        *_group_ptrs(t), _ptr(t.spread_rank), *_state_ptrs(s), _ptr(out),
        _ptr(flags), _ptr(scratch), _ptr(scratch64), g, N, R, PV, L,
        _kernels.raw_stream(out))
    _kernels.check(rc, "tree_fill_step")
    tree_fill_step.launches += 1


tree_fill_step.launches = 0


def binpack_fill_step(t: FillTables, s: FillState, g: int, out,
                      flags) -> None:
    """Group g's binpack step (spread levels ignored): writes out[g] and
    the overflow flag flags[g], and folds the counts into s. Plain version
    for CPU tensors, kernel K9 (csrc/binpack_fill.cu) for CUDA tensors."""
    if _kernels.route("placement", *t, *s, out, flags) == "plain":
        return binpack_fill_step_plain(t, s, g, out, flags)
    G, N, R, PV, _ = _check_fill(t, s, out, flags)
    if not 0 <= g < G:
        raise IndexError(f"group {g} out of range for {G} groups")
    cdll = _kernels.lib("binpack_fill")
    scratch = torch.empty(_scratch_words(
        cdll.skt_binpack_fill_scratch_i32(N), "binpack_fill_step"),
        dtype=torch.int32, device=out.device)
    rc = cdll.skt_binpack_fill_step(
        *_group_ptrs(t), *_state_ptrs(s), _ptr(out), _ptr(flags),
        _ptr(scratch), g, N, R, PV, _kernels.raw_stream(out))
    _kernels.check(rc, "binpack_fill_step")
    binpack_fill_step.launches += 1


binpack_fill_step.launches = 0


# ------------------------------------------------------------ entries
def raise_on_overflow(flags) -> None:
    """Raise ValueError when a group's overflow flag is set (flags: the
    steps' int32[G], numpy or a host tensor)."""
    bad = np.flatnonzero(np.asarray(flags))
    if bad.size:
        raise ValueError(
            f"groups {bad.tolist()}: the capacity sum over eligible nodes "
            "of min(cap, n_tasks) is >= 2^31, where the reference's int32 "
            "sums wrap")


def _check_ranges(n_tasks, svc_idx, spread_rank, N: int, S: int) -> int:
    """Host checks on values the kernels index with, in one device round
    trip; returns max(n_tasks). Sums that could wrap are the steps' to flag
    (`raise_on_overflow`)."""
    G = n_tasks.shape[0]
    if G == 0:
        return 0
    stats = [n_tasks.max(), svc_idx.min(), svc_idx.max()]
    if spread_rank.numel():
        stats += [spread_rank.min(), spread_rank.max()]
    vals = torch.stack([v.to(torch.int64) for v in stats]).tolist()
    max_nt = vals[0]
    if vals[1] < 0 or vals[2] >= S:
        raise ValueError(f"svc_idx outside [0, {S})")
    if len(vals) > 3 and (vals[3] < 0 or vals[4] >= N):
        raise ValueError(f"spread_rank outside [0, {N})")
    return max_nt


def schedule_core(ready, node_val, node_plat, node_plugins, extra_mask,
                  constraints, plat_req, req_plugins, vol_topo, n_tasks,
                  svc_idx, need_res, max_replicas, penalty, has_ports,
                  group_ports, spread_rank, state: FillState,
                  strategy: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The placement on tensors already on one device: K1, then one step
    per group, in order: K9 for binpack (`strategy=1`), else K2 or K3 as
    LMAX, the spread table's depth as given, says. Folds every group's
    counts into the caller-owned `state` IN PLACE (the counterpart of the
    JAX resident tick's donated state) and returns (counts int32[G, N],
    overflow flags int32[G]); the caller reads the flags with the counts
    (`raise_on_overflow`).

    No host round trip: the value checks the kernels index with (svc_idx
    in [0, S), spread_rank in [0, N)) are the caller's, made on the host
    before the upload or by `_check_ranges`."""
    G, N = extra_mask.shape
    dev = extra_mask.device
    counts = torch.zeros((G, N), dtype=torch.int32, device=dev)
    flags = torch.zeros(G, dtype=torch.int32, device=dev)
    if G and N:
        mask = static_mask(ready, node_val, node_plat, node_plugins,
                           constraints, plat_req, req_plugins, extra_mask,
                           vol_topo)
        tables = FillTables(mask, need_res, n_tasks, svc_idx, max_replicas,
                            penalty, has_ports, group_ports, spread_rank)
        if strategy == 1:
            step = binpack_fill_step
        else:
            step = tree_fill_step if spread_rank.shape[1] else flat_fill_step
        for g in range(G):
            step(tables, state, g, counts, flags)
    return counts, flags


def _schedule(args, strategy: int, device):
    if strategy not in (0, 1):
        raise ValueError(f"unknown strategy {strategy}")
    dev = resolve_device(device)
    (ready, node_val, node_plat, node_plugins, extra_mask, constraints,
     plat_req, req_plugins, avail_res, total0, svc_count0, n_tasks, svc_idx,
     need_res, max_replicas, penalty, has_ports, group_ports, port_used0,
     spread_rank, vol_topo) = to_kernel_tensors(args, dev)
    G, N = extra_mask.shape
    max_nt = _check_ranges(n_tasks, svc_idx, spread_rank, N,
                           svc_count0.shape[0])
    state = FillState(total0.clone(), svc_count0.clone(), avail_res.clone(),
                      port_used0.clone())
    # LMAX is the problem's, as in the reference (placement.py:225)
    counts, flags = schedule_core(ready, node_val, node_plat, node_plugins,
                           extra_mask, constraints, plat_req, req_plugins,
                           vol_topo, n_tasks, svc_idx, need_res, max_replicas,
                           penalty, has_ports, group_ports, spread_rank, state,
                           strategy)
    raise_on_overflow(flags.cpu())
    return counts, state, max_nt


def schedule_groups(*args, strategy: int = 0, device=None):
    """One-shot entry: (counts int32[G, N], totals int32[N],
    svc_counts int32[S, N]). `args` are the KERNEL_ARG_FIELDS arrays (numpy
    or tensors; `vol_topo` may be left out); strategy 0 is spread, 1
    binpack. Runs on the card unless `device="cpu"`; the inputs are not
    modified. Raises ValueError when a group's capacity sum reaches 2^31."""
    counts, state, _ = _schedule(args, strategy, device)
    return counts, state.totals, state.svc_counts


def schedule_groups_compact(*args, strategy: int = 0, device=None):
    """schedule_groups' counts, downcast to int16 when max(n_tasks) < 2^15
    (halves the bytes the counts take back to the host)."""
    counts, _, max_nt = _schedule(args, strategy, device)
    return counts.to(torch.int16) if max_nt < (1 << 15) else counts


def schedule_encoded(p, device=None) -> np.ndarray:
    """Run the placement on an EncodedProblem; returns numpy counts
    int32[G, N]. No bucket padding: PyTorch does not recompile per shape."""
    strategy = 1 if getattr(p, "strategy", "spread") == "binpack" else 0
    counts = schedule_groups_compact(*kernel_args(p), strategy=strategy,
                                     device=device)
    return counts.cpu().numpy().astype(np.int32)
