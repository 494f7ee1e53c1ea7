"""The host side of the redesigned K3 (tree fill) and K20 (sharded water
fill), on the CPU.

  * the plain versions, which the card tests hold the kernels to bit for
    bit, against the JAX reference's group step (`_tree_water_fill`, and
    `_flat_water_fill` through it when there are no spread levels) over
    the card tests' edge-case generator (`fill_case`: one branch and a
    branch a node, ties in totals + counts, groups without capacity or
    with more tasks than capacity, a group whose capacity sum reaches
    2^31, phantom padded nodes), one device and split over k shards;
  * K20's one-pass shard check (`parallel.fill._water_fill_dims`): the
    answer of `_check_shards` on every input it accepts, and its error on
    every input it refuses;
  * the scratch-size guard of both wrappers (`placement._scratch_words`).

Integer outputs: the tolerance is exact equality.
"""
import jax
import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import placement as jax_placement
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.parallel import fill as torch_fill
from test_torch_gpu_redesign_fill import (
    SHARD_CASES,
    TREE_CASES,
    FillState,
    assert_same,
    fill_case,
    run_sharded,
    run_tree,
    shard_case,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
UNLIMITED = 1 << 30
_tree_water_fill = jax.jit(jax_placement._tree_water_fill)


def jax_steps(case):
    """Every group's step as the JAX reference's `_schedule_core` takes it
    (the capacity of the step, `_tree_water_fill`, the fold), in numpy
    around the JAX fill. Returns (counts, folded state); a group whose
    capacity sum reaches 2^31 is reported as None (the reference's int32
    sums wrap there: the port refuses it)."""
    mask, need = case["mask"], case["need_res"]
    totals = case["totals"].copy()
    svc_counts = case["svc_counts"].copy()
    avail = case["avail"].copy()
    port_used = case["port_used"].copy()
    G, N = mask.shape
    counts = []
    for g in range(G):
        svc = svc_counts[case["svc_idx"][g]]
        caps = np.where(need[g][None, :] > 0,
                        avail // np.maximum(need[g], 1)[None, :], UNLIMITED)
        mr = case["max_replicas"][g]
        cap_mr = np.where(mr > 0, mr - svc, UNLIMITED)
        conflict = (case["group_ports"][g][None, :] & port_used).any(axis=1)
        cap_port = np.where(case["has_ports"][g],
                            np.where(conflict, 0, 1), UNLIMITED)
        cap = np.clip(np.minimum(np.minimum(caps.min(axis=1), cap_mr),
                                 cap_port), 0, UNLIMITED).astype(np.int32)
        capsum = np.minimum(np.where(mask[g], cap, 0).astype(np.int64),
                            case["n_tasks"][g]).sum()
        if capsum >= 1 << 31:
            counts.append(None)
            continue
        c = np.asarray(_tree_water_fill(
            mask[g], cap, case["penalty"][g], svc, totals,
            case["n_tasks"][g], case["spread_rank"][g])).astype(np.int32)
        counts.append(c)
        totals += c
        svc_counts[case["svc_idx"][g]] += c
        avail -= c[:, None] * need[g][None, :]
        port_used |= case["group_ports"][g][None, :] & (c > 0)[:, None]
    return counts, FillState(*(torch.from_numpy(x) for x in (
        totals, svc_counts, avail, port_used)))


def assert_reference(got, case):
    """The plain run `got` (counts, flags, state) against the reference:
    equal counts on every group the reference can run, flag 0 there; flag
    1 and no counts on a refused group."""
    counts, flags, state = got
    want, want_state = jax_steps(case)
    for g, w in enumerate(want):
        if w is None:
            assert int(flags[g]) == 1 and not counts[g].any()
        else:
            assert int(flags[g]) == 0
            assert np.array_equal(counts[g].numpy(), w), g
    for f in FillState._fields:
        assert torch.equal(getattr(state, f), getattr(want_state, f)), f


HOST_TREE = [c for c in TREE_CASES if c[1] <= 5000]
HOST_SHARD = [c for c in SHARD_CASES if c[1] * c[2] <= 5000]


@pytest.mark.parametrize("seed,N,G,L,arity,nb,leaf_unique,opts", HOST_TREE)
def test_tree_fill_plain_matches_jax(seed, N, G, L, arity, nb, leaf_unique,
                                     opts):
    case = fill_case(seed, N, G, L, arity, nb, leaf_unique, **opts)
    assert_reference(run_tree(torch_placement.tree_fill_step_plain, case,
                              CPU), case)


@pytest.mark.parametrize("seed,k,n,G,L,arity,nb,leaf_unique,opts",
                         HOST_SHARD)
def test_sharded_water_fill_plain_matches_jax(seed, k, n, G, L, arity, nb,
                                              leaf_unique, opts):
    case = fill_case(seed, k * n, G, L, arity, nb, leaf_unique, **opts)
    got = run_sharded(torch_fill.sharded_water_fill_step_plain, case, k, CPU)
    assert_reference(got, case)
    if L:  # the one-device plain step on the joined arrays agrees
        assert_same(got, run_tree(torch_placement.tree_fill_step_plain,
                                  case, CPU))


def test_the_generator_covers_the_edges():
    # the cases the card tests rely on are really in the inputs
    one = fill_case(1, 64, 3, 1, 1)
    assert one["spread_rank"].max() == 0                 # NB = 1
    each = fill_case(2, 64, 3, 1, 4, leaf_unique=True)
    assert all(len(set(r[0])) == 64 for r in each["spread_rank"])
    ties = fill_case(3, 300, 4, 2, 3)
    assert len(set(ties["totals"].tolist())) <= 3
    spread = fill_case(5, 700, 4, 2, 3, nb=40)
    assert spread["spread_rank"].max() < 40
    over = fill_case(10, 700, 4, 3, 3, overflow=True)
    assert over["n_tasks"][-1] == 1 << 30 and over["mask"][-1].all()
    pad = fill_case(11, 500, 3, 3, 4, phantoms=37)
    assert not pad["mask"][:, -37:].any()
    assert not pad["spread_rank"][:, :, -37:].any()


# ----------------------------------------------- K20's one-pass check
def _shards(k=4, n=50, L=2):
    case = fill_case(71, k * n, 3, L, 3)
    tables, states = shard_case(case, k, CPU)
    outs = [torch.zeros((3, n), dtype=torch.int32) for _ in range(k)]
    flags = torch.zeros(3, dtype=torch.int32)
    return tables, states, outs, flags


@pytest.mark.parametrize("k,L,g", [(1, 0, 0), (4, 2, 2), (8, 3, 1)])
def test_one_pass_check_answers_as_check_shards(k, L, g):
    tables, states, outs, flags = _shards(k, 40, L)
    assert (torch_fill._water_fill_dims(tables, states, outs, flags, g)
            == torch_fill._check_shards(tables, states, outs, flags, g))


def _breakages():
    """(name, mutate) pairs: each makes `_check_shards` refuse."""
    def dtype(field, where):
        def f(t, s, o, fl):
            box = {"t": t, "s": s}[where]
            i = 1
            x = getattr(box[i], field)
            box[i] = box[i]._replace(**{field: x.to(torch.int64)
                                        if x.dtype != torch.int64
                                        else x.to(torch.int32)})
        return f

    def shape(field, where):
        def f(t, s, o, fl):
            box = {"t": t, "s": s}[where]
            x = getattr(box[2], field)
            box[2] = box[2]._replace(**{field: x[..., :-1].contiguous()})
        return f

    def strided(t, s, o, fl):
        s[1] = s[1]._replace(avail=s[1].avail.t().contiguous().t())

    def copied_group(t, s, o, fl):
        t[3] = t[3]._replace(n_tasks=t[3].n_tasks.clone())

    def bad_out(t, s, o, fl):
        o[0] = o[0][:, :-1].contiguous()

    def bad_flags(t, s, o, fl):
        fl.append("flags")

    def fewer_states(t, s, o, fl):
        s.pop()

    out = [(f"dtype {f}", dtype(f, w)) for f, w in (
        ("mask", "t"), ("penalty", "t"), ("spread_rank", "t"),
        ("totals", "s"), ("svc_counts", "s"), ("avail", "s"),
        ("port_used", "s"))]
    out += [(f"shape {f}", shape(f, w)) for f, w in (
        ("mask", "t"), ("spread_rank", "t"), ("svc_counts", "s"),
        ("avail", "s"))]
    out += [("strided avail", strided), ("copied group table", copied_group),
            ("counts shape", bad_out), ("flags", bad_flags),
            ("fewer states", fewer_states)]
    return out


@pytest.mark.parametrize("name,mutate", _breakages(),
                         ids=[b[0] for b in _breakages()])
def test_one_pass_check_raises_as_check_shards(name, mutate):
    tables, states, outs, flags = _shards()
    box = []
    mutate(tables, states, outs, box)
    fl = flags[:-1].contiguous() if box else flags
    with pytest.raises((TypeError, ValueError, IndexError)) as want:
        torch_fill._check_shards(tables, states, outs, fl, 0)
    with pytest.raises(type(want.value)) as got:
        torch_fill._water_fill_dims(tables, states, outs, fl, 0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("g", [-1, 3])
def test_one_pass_check_refuses_the_group_as_check_shards(g):
    tables, states, outs, flags = _shards()
    with pytest.raises(IndexError, match="out of range") as want:
        torch_fill._check_shards(tables, states, outs, flags, g)
    with pytest.raises(IndexError) as got:
        torch_fill._water_fill_dims(tables, states, outs, flags, g)
    assert str(got.value) == str(want.value)


def test_one_pass_check_refuses_no_shards():
    flags = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError) as want:
        torch_fill._check_shards([], [], [], flags, 0)
    with pytest.raises(ValueError) as got:
        torch_fill._water_fill_dims([], [], [], flags, 0)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ scratch guard
def test_scratch_words_passes_counts_and_refuses_past_an_int():
    assert torch_placement._scratch_words(0, "x") == 0
    assert torch_placement._scratch_words(123_456, "x") == 123_456
    with pytest.raises(ValueError, match="tree_fill_step: scratch past"):
        torch_placement._scratch_words(-1, "tree_fill_step")
