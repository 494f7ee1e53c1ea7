"""The host side of the redesigned K21 (sharded binpack fill) and K1
(static mask, one device or every shard in one launch), on the CPU.

  * K21's plain version, which the card tests hold the kernel to bit for
    bit, against the JAX reference's group step (`_binpack_fill` with the
    capacity and the fold) on the joined node axis, over the card tests'
    shard cases (phantom pad nodes, ties, q = 0, q at and above the
    capacity sum, a capacity sum reaching 2^31, keys over 63 bits);
  * `sharded_static_mask`'s plain route (a loop of `static_mask` over the
    shards) against JAX `build_static_mask`, shard by shard and on the
    joined node axis, over the card tests' `mask_case` generator;
  * the one-pass checks of the CUDA branches (`_sharded_mask_dims` for
    K1, `_water_fill_dims` for K21) against the checks they replace (a
    loop of `static_mask`'s `_mask_dims` over the shards; `_check_shards`)
    on the same good and faulty inputs: the same answer, or the same error
    and words.

Integer and bool outputs: the tolerance is exact equality.
"""
import jax
import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import placement as jax_placement
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.parallel import fill as torch_fill
from tests.test_torch_gpu_redesign_fill import run_sharded, shard_case
from tests.test_torch_gpu_redesign_flat_binpack import np_caps
from tests.test_torch_gpu_redesign_mask_binpack import (
    MASK_CASES,
    MASK_IDS,
    SHARD_CASES,
    SHARD_IDS,
    _binpack_case,
    mask_args,
    mask_case,
    shard_args,
    split_mask,
)
from tests.test_torch_redesign_binpack_host import assert_reference

torch.set_num_threads(1)
CPU = torch.device("cpu")
_build_static_mask = jax.jit(jax_placement.build_static_mask)

HOST_SHARD = [(c, i) for c, i in zip(SHARD_CASES, SHARD_IDS)
              if c[1] * c[2] <= 20_000]
HOST_MASK = [(c, i) for c, i in zip(MASK_CASES, MASK_IDS)
             if c[1] * c[2] <= 20_000]


# ------------------------------------------------------------ K21
@pytest.mark.parametrize("seed,k,n,G,opts", [c for c, _ in HOST_SHARD],
                         ids=[i for _, i in HOST_SHARD])
def test_sharded_binpack_plain_matches_jax(seed, k, n, G, opts):
    case = _binpack_case(seed, k, n, G, opts)
    got = run_sharded(torch_fill.sharded_binpack_fill_step_plain, case, k,
                      CPU)
    assert_reference(got, case, binpack=True)


def test_the_shard_cases_cover_the_edges():
    """Across the host cases: a group with q = 0, one with q at its
    capacity sum, one above it, one refused at 2^31, phantom pad nodes
    (nothing eligible on the tail), and ties in the totals."""
    seen = set()
    for (seed, k, n, G, opts), _ in HOST_SHARD:
        case = _binpack_case(seed, k, n, G, opts)
        for g in range(G):
            cap = np.minimum(np.where(case["mask"][g], np_caps(case, g), 0),
                             case["n_tasks"][g])
            nt, capsum = int(case["n_tasks"][g]), int(cap.sum())
            if capsum >= 1 << 31:
                seen.add("refused")
            elif nt == 0:
                seen.add("q = 0")
            elif nt == capsum > 0:
                seen.add("q = capsum")
            elif nt > capsum:
                seen.add("q > capsum")
            else:
                seen.add("search")
        if opts.get("phantoms"):
            assert not case["mask"][:, -opts["phantoms"]:].any()
            seen.add("phantoms")
        if len(np.unique(case["totals"])) < case["totals"].size:
            seen.add("ties")
    assert seen == {"refused", "q = 0", "q = capsum", "q > capsum",
                    "search", "phantoms", "ties"}, seen


# ------------------------------------------------------------ K1
def _jax_mask(args):
    return np.asarray(_build_static_mask(*[np.asarray(a) for a in args]))


@pytest.mark.parametrize("seed,k,n,opts", [c for c, _ in HOST_MASK],
                         ids=[i for _, i in HOST_MASK])
def test_sharded_static_mask_plain_matches_jax(seed, k, n, opts):
    case = mask_case(seed, k * n, **opts)
    args = split_mask(case, k, CPU)
    got = torch_placement.sharded_static_mask(*args)
    assert len(got) == k
    for b, m in enumerate(got):
        assert np.array_equal(m.numpy(), _jax_mask(shard_args(args, b))), b
    joined = _jax_mask(mask_args(case, CPU))
    assert np.array_equal(torch.cat(got, 1).numpy(), joined)


def test_sharded_static_mask_plain_takes_one_extra_for_all():
    case = mask_case(21, 4 * 30, G=6, VA=2)
    args = split_mask(case, 4, CPU, same_extra=True)
    got = torch_placement.sharded_static_mask(*args)
    for b, m in enumerate(got):
        assert np.array_equal(m.numpy(), _jax_mask(shard_args(args, b)))


def test_the_mask_cases_cover_the_legs():
    """Across the host cases every leg both passes and fails somewhere:
    each constraint op, a clamped key column, platform pad rows and
    wildcards, a missing plugin, mounts inside and outside [0, 4)."""
    cons, plat, vol, clamped, missing = [], [], [], False, False
    for (seed, k, n, opts), _ in HOST_MASK:
        case = mask_case(seed, k * n, **opts)
        K = case["node_val"].shape[1]
        cons.append(case["constraints"].reshape(-1, 3))
        plat.append(case["plat_req"].reshape(-1, 2))
        if case["vol_topo"].shape[1]:
            vol.append(case["vol_topo"][:, :, 0].ravel())
        clamped |= bool((case["constraints"][:, :, 0] >= K).any())
        missing |= bool((case["req_plugins"][:, None, :]
                         & ~case["node_plugins"][None, :, :]).any())
    cons, plat, vol = np.concatenate(cons), np.concatenate(plat), \
        np.concatenate(vol)
    assert clamped and missing
    assert {0, 1} <= set(cons[:, 1]) and (cons[:, 0] < 0).any()
    assert (plat[:, 0] <= -2).any() and (plat[:, 0] == 0).any()
    assert ((vol >= 0) & (vol < 4)).any() and ((vol < 0) | (vol >= 4)).any()


# --------------------------------------------- one-pass checks, K1
def _old_mask_checks(args):
    """The checks of a loop of `static_mask` calls over the shards: each
    shard's `_mask_dims`, then its key-column refusal. Returns the
    dims of every shard."""
    out = []
    for b in range(len(args[0])):
        dims = torch_placement._mask_dims(shard_args(args, b))
        G, N, K = dims[:3]
        if G * N and K == 0:
            raise ValueError("node_val needs at least one key column")
        out.append(dims)
    return out


def _mask_inputs(k=4, n=30, **opts):
    return split_mask(mask_case(41, k * n, G=5, VA=2, **opts), k, CPU)


@pytest.mark.parametrize("k,opts", [(1, {}), (4, {}), (8, {"PL": 0}),
                                    (3, {"K": 1, "C": 0})])
def test_mask_one_pass_answers_as_the_shard_loop(k, opts):
    args = _mask_inputs(k, **opts)
    new, rows = torch_placement._sharded_mask_dims(*args)
    old = _old_mask_checks(args)
    assert len(old) == k and set(old) == {new[1:]}
    assert new[0] == k
    # the kernel's pointer table: each shard's node arrays, in order
    assert rows == [tuple(args[i][b].data_ptr() for i in (0, 1, 2, 3, 7))
                    for b in range(k)]


def _mask_breakages():
    """(name, mutate) pairs: each makes the shard loop's checks refuse."""
    def node(i, how):
        def f(args):
            x = args[i][1]
            args[i][1] = {"dtype": x.to(torch.int64) if x.dtype
                          != torch.int64 else x.to(torch.int32),
                          "shape": x[:-1].contiguous(),
                          "strided": x.t().contiguous().t() if x.dim() == 2
                          else x.repeat(2)[::2]}[how]
        return f

    def group(i, how):
        def f(args):
            x = args[i]
            args[i] = {"dtype": x.to(torch.int64) if x.dtype != torch.int64
                       else x.to(torch.int32),
                       "shape": x[:-1].contiguous()}[how]
        return f

    def no_key(args):
        args[1] = [v[:, :0].contiguous() for v in args[1]]

    out = [(f"{how} {name}", node(i, how))
           for i, name in ((0, "ready"), (1, "node_val"), (2, "node_plat"),
                           (3, "node_plugins"), (7, "extra_mask"))
           for how in ("dtype", "shape", "strided")]
    out += [(f"{how} {name}", group(i, how))
            for i, name in ((4, "constraints"), (5, "plat_req"),
                            (6, "req_plugins"), (8, "vol_topo"))
            for how in ("dtype", "shape")]
    out += [("no key column", no_key)]
    return out


@pytest.mark.parametrize("name,mutate", _mask_breakages(),
                         ids=[b[0] for b in _mask_breakages()])
def test_mask_one_pass_raises_as_the_shard_loop(name, mutate):
    args = [list(a) if isinstance(a, list) else a for a in _mask_inputs()]
    mutate(args)
    with pytest.raises((TypeError, ValueError, IndexError)) as want:
        _old_mask_checks(args)
    with pytest.raises(type(want.value)) as got:
        torch_placement._sharded_mask_dims(*args)
    assert str(got.value) == str(want.value)


def test_mask_one_pass_refuses_shards_of_two_widths():
    """Shards that each pass the loop's checks but differ in width: the
    one launch writes one [k, G, n] tensor, so it refuses them."""
    args = [list(a) if isinstance(a, list) else a for a in _mask_inputs()]
    for i in (0, 1, 2, 3, 7):
        args[i][2] = args[i][2][..., :-1].contiguous() if i in (0, 7) \
            else args[i][2][:-1].contiguous()
    assert len(_old_mask_checks(args)) == 4
    with pytest.raises(ValueError, match="widths \\[29, 30\\]"):
        torch_placement._sharded_mask_dims(*args)


def test_mask_plain_route_is_the_shard_loop():
    """On CPU tensors `sharded_static_mask` is `static_mask` shard by
    shard, whatever the shapes: shards of two widths included."""
    args = [list(a) if isinstance(a, list) else a for a in _mask_inputs()]
    for i in (0, 1, 2, 3, 7):
        args[i][2] = args[i][2][..., :-1].contiguous() if i in (0, 7) \
            else args[i][2][:-1].contiguous()
    got = torch_placement.sharded_static_mask(*args)
    for b, m in enumerate(got):
        assert torch.equal(m, torch_placement.static_mask(
            *shard_args(args, b)))
    assert torch_placement.sharded_static_mask(
        [], [], [], [], *args[4:7], [], args[8]) == []


# -------------------------------------------- one-pass checks, K21
def _binpack_shards(k=4, n=45):
    case = _binpack_case(71, k, n, 3, {"phantoms": 4})
    tables, states = shard_case(case, k, CPU)
    outs = [torch.zeros((3, n), dtype=torch.int32) for _ in range(k)]
    return tables, states, outs, torch.zeros(3, dtype=torch.int32)


@pytest.mark.parametrize("k,g", [(1, 0), (3, 2), (16, 1)])
def test_binpack_one_pass_answers_as_check_shards(k, g):
    tables, states, outs, flags = _binpack_shards(k)
    assert (torch_fill._water_fill_dims(tables, states, outs, flags, g)
            == torch_fill._check_shards(tables, states, outs, flags, g))


def _binpack_breakages():
    def retype(where, field):
        def f(t, s, o, fl):
            box = {"t": t, "s": s}[where]
            x = getattr(box[1], field)
            box[1] = box[1]._replace(**{field: x.to(torch.int64)})
        return f

    def narrow(t, s, o, fl):
        s[2] = s[2]._replace(totals=s[2].totals[:-1].contiguous())

    def strided(t, s, o, fl):
        s[0] = s[0]._replace(avail=s[0].avail.t().contiguous().t())

    def own_table(t, s, o, fl):
        t[2] = t[2]._replace(need_res=t[2].need_res.clone())

    def short_out(t, s, o, fl):
        o[3] = o[3][:2].contiguous()

    def wide_flags(t, s, o, fl):
        fl.append(torch.zeros(4, dtype=torch.int32))

    def no_outs(t, s, o, fl):
        o.clear()

    out = [(f"dtype {f}", retype(w, f)) for w, f in (
        ("t", "mask"), ("t", "penalty"), ("s", "totals"),
        ("s", "svc_counts"), ("s", "port_used"))]
    out += [("narrow totals", narrow), ("strided avail", strided),
            ("own group table", own_table), ("short counts", short_out),
            ("flags shape", wide_flags), ("no counts", no_outs)]
    return out


@pytest.mark.parametrize("name,mutate", _binpack_breakages(),
                         ids=[b[0] for b in _binpack_breakages()])
def test_binpack_one_pass_raises_as_check_shards(name, mutate):
    tables, states, outs, flags = _binpack_shards()
    box = []
    mutate(tables, states, outs, box)
    fl = box[0] if box else flags
    with pytest.raises((TypeError, ValueError, IndexError)) as want:
        torch_fill._check_shards(tables, states, outs, fl, 0)
    with pytest.raises(type(want.value)) as got:
        torch_fill._water_fill_dims(tables, states, outs, fl, 0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("g", [-1, 3])
def test_binpack_one_pass_refuses_the_group_as_check_shards(g):
    tables, states, outs, flags = _binpack_shards()
    with pytest.raises(IndexError) as want:
        torch_fill._check_shards(tables, states, outs, flags, g)
    with pytest.raises(IndexError) as got:
        torch_fill._water_fill_dims(tables, states, outs, flags, g)
    assert str(got.value) == str(want.value)
