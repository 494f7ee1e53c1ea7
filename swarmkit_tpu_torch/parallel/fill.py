"""The sharded placement scan: k node shards on one device.

The JAX package has no such module: under `jit` with the node axis sharded
(`parallel/mesh.py`), XLA writes the cross-shard sums of the water fill and
the gather of the boundary sort itself. Here they are written out.

A sharded step takes, per shard, the one-device step's `FillTables` (the
shard's mask, penalty and spread-rank columns; the group-side tables are
replicated, one copy shared by every shard) and `FillState` (the shard's
node carry), and a counts tensor int32[G, n] per shard; it writes the
group's overflow flag and folds each shard's state in place, as the
one-device steps do (`ops/placement.py`). Two kernels carry it, each a
hand-written CUDA kernel with its plain PyTorch version beside its wrapper:

  * `sharded_water_fill_step`   (K20, csrc/sharded_water_fill.cu) — spread
    and topology, flat (no spread levels) or tree: the water-fill body of
    csrc/water_fill.cuh (K3's too), one thread block cluster whose blocks
    share the global node range in chunks, whatever the shard count;
  * `sharded_binpack_fill_step` (K21, csrc/sharded_binpack_fill.cu) —
    binpack: the cap-weighted radix select of csrc/binpack_select.cuh
    (K9's too), one thread block cluster over the global node range.

A wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on one CUDA device; shards on two devices, or more
shards than `max_shards` allows, raise. Every launch adds one to the
wrapper's `launches` counter.

The plain versions are the reference's algorithms in sharded form: each
reduction over nodes is a sum over the shards of each shard's own sum (the
`psum`), and the boundary sort gathers the shards' keys (XLA's gather).

`sharded_schedule_core` is the launch loop: `fill_inputs` runs K1 over
every shard in one launch (`ops.placement.sharded_static_mask`), then
`sharded_fill` one step per group, in order. The overflow flags and their
refusal are `ops/placement.py`'s.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import _kernels
from ..ops.placement import (
    _I32_LIMIT,
    _SEC_PAD,
    PENALTY_BASE,
    FillState,
    FillTables,
    _bisect,
    _binpack_fill_plain,
    _check_fill,
    _fits,
    _fold_plain,
    _node_caps_plain,
    _scratch_words,
    _segment_min,
    _segment_sum,
    _segmented_pour_plain,
    sharded_static_mask,
)

_GROUP_FIELDS = ("need_res", "n_tasks", "svc_idx", "max_replicas",
                 "has_ports", "group_ports")


def _psum(parts):
    """The cross-shard sum of per-shard values, in shard order."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def _seg_psum(datas, segs, n):
    """Segment sums over global branch ids, summed over the shards."""
    return _psum([_segment_sum(d, s, n) for d, s in zip(datas, segs)])


def _seg_pmin(datas, segs, n):
    """Segment minimums over global branch ids, the least over shards."""
    return functools.reduce(torch.minimum,
                            [_segment_min(d, s, n) for d, s in
                             zip(datas, segs)])


def _gather(parts):
    """The shards' node-axis values as one vector (XLA's all-gather)."""
    return torch.cat(parts)


def _split(full, n):
    return list(torch.split(full, n))


# ------------------------------------------------------ plain versions
def _flat_fill_sharded(caps, pens, svcs, totals, n_tasks):
    """JAX `_flat_water_fill` over shards: a scalar water level from
    cross-shard sums, the remainder ranked by (sec, global index) on the
    gathered keys."""
    dev = caps[0].device
    n = caps[0].shape[0]
    ks = [torch.where(p, PENALTY_BASE, 0).to(torch.int32) + s
          for p, s in zip(pens, svcs)]
    q = torch.minimum(n_tasks, _psum([c.sum(dtype=torch.int32)
                                      for c in caps]))
    level = _bisect(lambda lv: _psum([
        torch.minimum(c, (lv - k).clamp(min=0)).sum(dtype=torch.int32)
        for c, k in zip(caps, ks)]), q, (), dev)
    counts = [torch.minimum(c, (level - k).clamp(min=0))
              for c, k in zip(caps, ks)]
    rem = q - _psum([c.sum(dtype=torch.int32) for c in counts])
    bnd = [(c > x) & (k <= level) & (x == level - k)
           for c, x, k in zip(caps, counts, ks)]
    sec = _gather([torch.where(b, t + x, _SEC_PAD)
                   for b, t, x in zip(bnd, totals, counts)])
    order = torch.sort(sec, stable=True).indices
    pos = _split(torch.empty_like(order).scatter_(
        0, order, torch.arange(sec.shape[0], device=dev)), n)
    return [x + (b & (p < rem)).to(torch.int32)
            for x, b, p in zip(counts, bnd, pos)]


def _tree_fill_sharded(caps, pens, svcs, totals, n_tasks, ranks):
    """JAX `_tree_water_fill` over shards: branch aggregates are segment
    sums over global branch ids summed over the shards, the pour runs on
    those replicated [N padded] vectors (`_segmented_pour_plain`), the leaf
    remainder is ranked by the lexsort (leaf, sec, global index) of the
    gathered keys."""
    dev = caps[0].device
    n = caps[0].shape[0]
    Np = n * len(caps)
    parent_seg = [torch.zeros(n, dtype=torch.int32, device=dev)
                  for _ in caps]
    quota_seg = torch.zeros(Np, dtype=torch.int32, device=dev)
    quota_seg[0] = torch.minimum(n_tasks, _psum([c.sum(dtype=torch.int32)
                                                 for c in caps]))
    for li in range(ranks[0].shape[0]):
        seg = [r[li] for r in ranks]
        k_child = _seg_psum(svcs, seg, Np)
        cap_child = _seg_psum(caps, seg, Np)
        valid = _seg_psum([torch.ones_like(s) for s in seg], seg, Np) > 0
        parent_of = torch.where(valid, _seg_pmin(parent_seg, seg, Np), 0)
        quota_seg = _segmented_pour_plain(quota_seg, k_child, cap_child,
                                          parent_of, valid, Np)
        parent_seg = seg

    leaf = parent_seg
    ks = [torch.where(p, PENALTY_BASE, 0).to(torch.int32) + s
          for p, s in zip(pens, svcs)]
    q = torch.minimum(quota_seg, _seg_psum(caps, leaf, Np))
    level = _bisect(lambda lp: _seg_psum([
        torch.minimum(c, (lp[lf.long()] - k).clamp(min=0))
        for c, lf, k in zip(caps, leaf, ks)], leaf, Np), q, (Np,), dev)
    lvls = [level[lf.long()] for lf in leaf]
    counts = [torch.minimum(c, (lv - k).clamp(min=0))
              for c, lv, k in zip(caps, lvls, ks)]
    rem = q - _seg_psum(counts, leaf, Np)
    bnd = [(c > x) & (k <= lv) & (x == lv - k)
           for c, x, k, lv in zip(caps, counts, ks, lvls)]
    sec_all = _gather([torch.where(b, t + x, _SEC_PAD)
                       for b, t, x in zip(bnd, totals, counts)])
    leaf_all = _gather(leaf)
    b_all = _gather(bnd)
    # lexsort((idx, sec, leaf)): stable sorts from the least significant key
    o1 = torch.sort(sec_all, stable=True).indices
    order = o1[torch.sort(leaf_all[o1], stable=True).indices]
    b_sorted = b_all[order].to(torch.int32)
    cum = torch.cumsum(b_sorted, 0, dtype=torch.int32) - b_sorted
    leaf_sorted = leaf_all[order]
    offset = _segment_min(cum, leaf_sorted, Np)
    rank = _split(torch.empty_like(cum).scatter_(
        0, order, cum - offset[leaf_sorted.long()]), n)
    return [x + (b & (r < rem[lf.long()])).to(torch.int32)
            for x, b, r, lf in zip(counts, bnd, rank, leaf)]


def _binpack_fill_sharded(caps, pens, svcs, totals, n_tasks):
    """JAX `_binpack_fill` over shards: its stable lexsort by (penalty,
    -svc, -total, index) and capacity prefix need every key, so the shards'
    columns are gathered (as XLA gathers them) and the counts split back."""
    n = caps[0].shape[0]
    return _split(_binpack_fill_plain(_gather(caps), _gather(pens),
                                      _gather(svcs), _gather(totals),
                                      n_tasks), n)


def _sharded_step_plain(fill, tables, states, g, outs, flags) -> None:
    """A plain sharded group step around `fill(caps, pens, svcs, totals,
    n_tasks)`: each shard's capacities, the capacity sum over the shards in
    int64 for the overflow flag (an overflowing group places and folds
    nothing), then each shard's counts and fold."""
    cs = [_node_caps_plain(t, s, g) for t, s in zip(tables, states)]
    caps = [c for c, _ in cs]
    svcs = [s for _, s in cs]
    over = _psum([c.sum(dtype=torch.int64) for c in caps]) >= _I32_LIMIT
    counts = fill(caps, [t.penalty[g] for t in tables], svcs,
                  [s.totals for s in states], tables[0].n_tasks[g])
    flags[g] = over.to(torch.int32)
    for t, s, out, c in zip(tables, states, outs, counts):
        c = torch.where(over, 0, c).to(torch.int32)
        out[g] = c
        _fold_plain(t, s, g, c)


def sharded_water_fill_step_plain(tables, states, g, outs, flags) -> None:
    """Plain PyTorch sharded spread step: the flat fill without spread
    levels, the tree fill with them. Writes outs[b][g] and flags[g], folds
    every shard's state."""
    if tables[0].spread_rank.shape[1] == 0:
        fill = _flat_fill_sharded
    else:
        def fill(caps, pens, svcs, totals, n_tasks):
            return _tree_fill_sharded(caps, pens, svcs, totals, n_tasks,
                                      [t.spread_rank[g] for t in tables])
    _sharded_step_plain(fill, tables, states, g, outs, flags)


def sharded_binpack_fill_step_plain(tables, states, g, outs,
                                    flags) -> None:
    """Plain PyTorch sharded binpack step: writes outs[b][g] and flags[g],
    folds every shard's state."""
    _sharded_step_plain(_binpack_fill_sharded, tables, states, g, outs,
                        flags)


# ----------------------------------------------------------- wrappers
def _tensors(tables, states, outs, flags):
    return [x for t in tables for x in t] + [x for s in states for x in s] \
        + list(outs) + [flags]


def _check_shards(tables, states, outs, flags, g) -> tuple[int, ...]:
    """Shapes, dtypes and layout of a sharded step's inputs: every shard
    as the one-device step takes it, the same shard width everywhere, the
    group-side tables one replicated copy. Returns (k, n, R, PV, L)."""
    k = len(tables)
    if k == 0 or len(states) != k or len(outs) != k:
        raise ValueError(f"{k} shard tables, {len(states)} states and "
                         f"{len(outs)} counts: expected one each a shard")
    dims = [_check_fill(t, s, o, flags) for t, s, o in
            zip(tables, states, outs)]
    if len(set(dims)) != 1:
        raise ValueError(f"shards of different shapes: {sorted(set(dims))}")
    for name in _GROUP_FIELDS:
        ref = getattr(tables[0], name)
        if any(getattr(t, name) is not ref for t in tables[1:]):
            raise ValueError(f"{name}: the group-side tables must be one "
                             "replicated copy shared by every shard")
    G, n, R, PV, L = dims[0]
    if not 0 <= g < G:
        raise IndexError(f"group {g} out of range for {G} groups")
    if k * n >= 1 << 31:
        raise ValueError(f"{k} x {n} nodes: the node index is int32")
    return k, n, R, PV, L


def _water_fill_dims(tables, states, outs, flags, g) -> tuple[int, ...]:
    """`_check_shards` in one pass for K20's and K21's launches: the same
    conditions, each tensor read once (the group-side tables once for all
    shards).
    Whatever it does not accept goes through `_check_shards`, which raises
    its error as before. Returns (k, n, R, PV, L)."""
    try:
        k = len(tables)
        t0 = tables[0]
        G, n = t0.mask.shape
        R, PV = t0.need_res.shape[1], t0.group_ports.shape[1]
        L, S = t0.spread_rank.shape[1], states[0].svc_counts.shape[0]
        i32, b8 = torch.int32, torch.bool
        group = [getattr(t0, f) for f in _GROUP_FIELDS]
        ok = (len(states) == k == len(outs) and 0 <= g < G
              and k * n < 1 << 31 and _fits(flags, i32, (G,))
              and all(_fits(x, dt, sh) for x, dt, sh in zip(
                  group, (i32, i32, i32, i32, b8, b8),
                  ((G, R), (G,), (G,), (G,), (G,), (G, PV))))
              and all(all(getattr(t, f) is x
                          for f, x in zip(_GROUP_FIELDS, group))
                      and _fits(t.mask, b8, (G, n))
                      and _fits(t.penalty, b8, (G, n))
                      and _fits(t.spread_rank, i32, (G, L, n))
                      and _fits(s.totals, i32, (n,))
                      and _fits(s.svc_counts, i32, (S, n))
                      and _fits(s.avail, i32, (n, R))
                      and _fits(s.port_used, b8, (n, PV))
                      and _fits(o, i32, (G, n))
                      for t, s, o in zip(tables, states, outs)))
    except (AttributeError, IndexError, TypeError, ValueError):
        ok = False
    if ok:
        return k, n, R, PV, L
    return _check_shards(tables, states, outs, flags, g)


def _shard_rows(tables, states, outs):
    """Each shard's row of the kernels' pointer table, in the order of
    csrc/mesh.cuh's ShardRow."""
    return [[t.mask.data_ptr(), t.penalty.data_ptr(),
             t.spread_rank.data_ptr(), s.totals.data_ptr(),
             s.svc_counts.data_ptr(), s.avail.data_ptr(),
             s.port_used.data_ptr(), o.data_ptr()]
            for t, s, o in zip(tables, states, outs)]


def _group_ptrs(t: FillTables):
    return tuple(getattr(t, name).data_ptr() or None
                 for name in _GROUP_FIELDS)


def sharded_water_fill_step(tables, states, g, outs, flags,
                            n_branches: int | None = None) -> None:
    """Group g's spread step over k shards: writes outs[b][g] and the
    overflow flag flags[g], and folds the counts into every shard's state.
    Plain version for CPU tensors, kernel K20 (csrc/sharded_water_fill.cu)
    for CUDA tensors. `n_branches`: one past the largest branch id of the
    problem's spread ranks (default: every id below the padded node count;
    the launch loop passes the exact bound, which it checks)."""
    if _kernels.route("sharded placement",
                      *_tensors(tables, states, outs, flags)) == "plain":
        return sharded_water_fill_step_plain(tables, states, g, outs, flags)
    k, n, R, PV, L = _water_fill_dims(tables, states, outs, flags, g)
    Np = k * n
    NB = 1 if L == 0 else (Np if n_branches is None else n_branches)
    if not 1 <= NB <= Np:
        raise ValueError(f"n_branches {NB} outside [1, {Np}]")
    dev = flags.device
    cdll = _kernels.lib("sharded_water_fill")
    words = cdll.skt_sharded_water_fill_scratch
    nb_words = _scratch_words(words(0, Np, NB, L), "sharded_water_fill_step")
    node_words = _scratch_words(words(1, Np, NB, L),
                                "sharded_water_fill_step")
    # one allocation: the branch words, the int64 pair (8-byte aligned),
    # the node words
    at64 = (nb_words + 1) // 2 * 2
    scratch = torch.empty(at64 + 4 * NB + node_words, dtype=torch.int32,
                          device=dev)
    base = scratch.data_ptr()
    rows = _kernels.pointer_table(_shard_rows(tables, states, outs),
                                   dev)
    rc = cdll.skt_sharded_water_fill_step(
        *_group_ptrs(tables[0]), rows.data_ptr(), flags.data_ptr(),
        base + 4 * (at64 + 4 * NB), base, base + 4 * at64, None, g,
        k, n, R, PV, L, NB, _kernels.raw_stream(flags))
    _kernels.check(rc, "sharded_water_fill_step")
    sharded_water_fill_step.launches += 1


sharded_water_fill_step.launches = 0


def sharded_binpack_fill_step(tables, states, g, outs, flags) -> None:
    """Group g's binpack step over k shards: writes outs[b][g] and the
    overflow flag flags[g], and folds the counts into every shard's state.
    Plain version for CPU tensors, kernel K21 (csrc/sharded_binpack_fill.cu)
    for CUDA tensors."""
    if _kernels.route("sharded placement",
                      *_tensors(tables, states, outs, flags)) == "plain":
        return sharded_binpack_fill_step_plain(tables, states, g, outs,
                                               flags)
    _binpack_launches(tables, states, outs, flags, (g,))


sharded_binpack_fill_step.launches = 0


def _binpack_launches(tables, states, outs, flags, groups) -> None:
    """K21's steps for `groups`, in order, on CUDA tensors: the checks
    (`_water_fill_dims` with the first group; every other must be in
    range too), the node scratch and the pointer table once, then one
    launch a group. The launch loop (`sharded_fill`) passes all its
    groups, so a step costs it one ctypes call."""
    k, n, R, PV, _ = _water_fill_dims(tables, states, outs, flags,
                                      groups[0])
    dev = flags.device
    words = _binpack_scratch(dev.index, k, n)
    scratch = torch.empty(words, dtype=torch.int32, device=dev) \
        if words else None
    rows = _kernels.pointer_table(_shard_rows(tables, states, outs),
                                   dev)
    args = (*_group_ptrs(tables[0]), rows.data_ptr(), flags.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    step, stream = _binpack_entries()[0], _kernels.raw_stream(flags)
    for g in groups:
        rc = step(*args, g, k, n, R, PV, stream)
        _kernels.check(rc, "sharded_binpack_fill_step")
        sharded_binpack_fill_step.launches += 1


@functools.cache
def _binpack_entries():
    """K21's C entries: (step, plan, scratch words)."""
    cdll = _kernels.lib("sharded_binpack_fill")
    return (cdll.skt_sharded_binpack_fill_step,
            cdll.skt_sharded_binpack_fill_plan,
            cdll.skt_sharded_binpack_fill_scratch_i32)


def binpack_plan(k: int, n: int, device_index: int = 0) -> tuple[int, ...]:
    """How K21's step over k x n nodes launches on the device: (cluster
    size, dynamic shared memory, nodes in shared memory)."""
    buf = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        rc = _binpack_entries()[1](k, n, buf)
    if rc:
        raise _kernels.KernelLaunchError(
            f"sharded_binpack_fill_step: plan query, CUDA error {rc}")
    return tuple(buf)


@functools.lru_cache(maxsize=64)
def _binpack_scratch(device_index: int, k: int, n: int) -> int:
    """int32 words of node scratch K21's step over k x n nodes needs: 0
    when its plan keeps the nodes in shared memory."""
    if binpack_plan(k, n, device_index)[2]:
        return 0
    return _scratch_words(_binpack_entries()[2](k, n),
                          "sharded_binpack_fill_step")


def max_shards(strategy: int = 0) -> int:
    """The most shards the strategy's kernel takes: a fixed 1,024 for K20
    and for K21 (their blocks do not map to shards; the limit keeps the
    per-call pointer table to one small upload). One more raises
    `KernelLaunchError` at the launch."""
    if strategy == 1:
        return _kernels.lib("sharded_binpack_fill") \
            .skt_sharded_binpack_fill_max_shards()
    return _kernels.lib("sharded_water_fill") \
        .skt_sharded_water_fill_max_shards()


# -------------------------------------------------------- launch loop
def _check_ranges(svc_idx, spread_rank, Np: int, S: int) -> int:
    """Host checks on the values the kernels index with, in one device
    read: svc_idx in [0, S), every shard's branch ids in [0, Np). Returns
    one past the largest branch id (1 without spread levels)."""
    if svc_idx.shape[0] == 0:
        return 1
    stats = [svc_idx.min(), svc_idx.max()]
    if spread_rank[0].numel():
        stats += [torch.stack([r.min() for r in spread_rank]).min(),
                  torch.stack([r.max() for r in spread_rank]).max()]
    vals = torch.stack([v.to(torch.int64) for v in stats]).tolist()
    if vals[0] < 0 or vals[1] >= S:
        raise ValueError(f"svc_idx outside [0, {S})")
    if len(vals) > 2:
        if vals[2] < 0 or vals[3] >= Np:
            raise ValueError(f"spread_rank outside [0, {Np})")
        return vals[3] + 1
    return 1


def fill_inputs(args):
    """The sharded steps' inputs from `parallel.mesh.shard_problem`'s
    tuple (KERNEL_ARG_FIELDS order, each node-axis field a list of k
    per-shard tensors, each group-side field one tensor, all on one
    device): K1 over every shard in one launch for the tables, clones of
    the node state (the inputs are not modified). Returns (tables,
    states, n_branches), n_branches one past the largest branch id,
    checked with svc_idx in one device read."""
    (ready, node_val, node_plat, node_plugins, extra_mask, constraints,
     plat_req, req_plugins, avail_res, total0, svc_count0, n_tasks, svc_idx,
     need_res, max_replicas, penalty, has_ports, group_ports, port_used0,
     spread_rank, vol_topo) = args
    k = len(ready)
    n = ready[0].shape[0]
    n_branches = _check_ranges(svc_idx, spread_rank, k * n,
                               svc_count0[0].shape[0])
    masks = sharded_static_mask(ready, node_val, node_plat, node_plugins,
                                constraints, plat_req, req_plugins,
                                extra_mask, vol_topo)
    tables = [FillTables(
        masks[b], need_res, n_tasks, svc_idx, max_replicas, penalty[b],
        has_ports, group_ports, spread_rank[b]) for b in range(k)]
    states = [FillState(total0[b].clone(), svc_count0[b].clone(),
                        avail_res[b].clone(), port_used0[b].clone())
              for b in range(k)]
    return tables, states, n_branches


def sharded_fill(tables, states, strategy: int = 0,
                 n_branches: int | None = None):
    """One K20 (spread, topology) or K21 (binpack, `strategy=1`) step per
    group, in order, each folding every shard's state in place (K21's
    steps on the card share one check and one pointer table). Returns
    (counts: k tensors int32[G, n], overflow flags int32[G])."""
    G, n = tables[0].mask.shape
    dev = tables[0].n_tasks.device
    counts = [torch.zeros((G, n), dtype=torch.int32, device=dev)
              for _ in tables]
    flags = torch.zeros(G, dtype=torch.int32, device=dev)
    if n and G:
        if strategy == 1:
            if _kernels.route("sharded placement", *_tensors(
                    tables, states, counts, flags)) == "kernel":
                _binpack_launches(tables, states, counts, flags, range(G))
                return counts, flags
            step = sharded_binpack_fill_step
        else:
            step = functools.partial(sharded_water_fill_step,
                                     n_branches=n_branches)
        for g in range(G):
            step(tables, states, g, counts, flags)
    return counts, flags


def sharded_schedule_core(args, strategy: int = 0):
    """The placement over shards: `fill_inputs`, then `sharded_fill`.
    Returns (counts: k tensors int32[G, n], overflow flags int32[G], the
    folded states); the caller reads the flags with the counts
    (`placement.raise_on_overflow`)."""
    if strategy not in (0, 1):
        raise ValueError(f"unknown strategy {strategy}")
    tables, states, n_branches = fill_inputs(args)
    counts, flags = sharded_fill(tables, states, strategy, n_branches)
    return counts, flags, states
