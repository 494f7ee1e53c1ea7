"""The host side of the redesigned K2 (flat fill) and K9 (binpack fill), on
the CPU.

  * the plain versions, which the card tests hold the kernels to bit for
    bit, against the JAX reference's group steps (`_flat_water_fill`,
    `_binpack_fill`) over the card tests' edge-case generator
    (`flat_binpack_case`: ties in totals + counts, q = 0, q = capsum and q
    above it, a capacity sum reaching 2^31, groups eligible on one chunk
    of 32 nodes, binpack keys over 63 bits);
  * that generator: each edge it promises is in its inputs, and the wide
    cases really take K9's component route (`key_bits`);
  * the scratch-size guard of both wrappers (`placement._scratch_words`).

Integer outputs: the tolerance is exact equality.
"""
import jax
import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import placement as jax_placement
from swarmkit_tpu_torch.ops import placement as torch_placement
from tests.test_torch_gpu_redesign_fill import FillState, run_tree
from tests.test_torch_gpu_redesign_flat_binpack import (
    CASE_IDS,
    CASES,
    CHUNK,
    flat_binpack_case,
    key_bits,
    np_caps,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
_flat = jax.jit(jax_placement._flat_water_fill)
_binpack = jax.jit(jax_placement._binpack_fill)


def jax_steps(case, binpack):
    """Every group's step as the JAX reference's `_schedule_core` takes it
    (the capacity, `_flat_water_fill` or `_binpack_fill`, the fold), in
    numpy around the JAX fill. Returns (counts, folded state); a group
    whose capacity sum reaches 2^31 is None (the reference's int32 sums
    wrap there: the port refuses it)."""
    st = {f: case[f].copy() for f in FillState._fields}
    G = case["mask"].shape[0]
    counts = []
    for g in range(G):
        cap = np_caps({**case, **st}, g).astype(np.int32)
        nt = case["n_tasks"][g]
        capped = np.minimum(np.where(case["mask"][g], cap, 0), nt)
        if capped.astype(np.int64).sum() >= 1 << 31:
            counts.append(None)
            continue
        svc = st["svc_counts"][case["svc_idx"][g]]
        if binpack:
            c = _binpack(case["mask"][g], cap, case["penalty"][g], svc,
                         st["totals"], nt)
        else:
            c = _flat(capped, case["penalty"][g], svc, st["totals"], nt)
        c = np.asarray(c).astype(np.int32)
        counts.append(c)
        st["totals"] += c
        st["svc_counts"][case["svc_idx"][g]] += c
        st["avail"] -= c[:, None] * case["need_res"][g][None, :]
        st["port_used"] |= case["group_ports"][g][None, :] & (c > 0)[:, None]
    return counts, FillState(*(torch.from_numpy(st[f])
                               for f in FillState._fields))


def assert_reference(got, case, binpack):
    counts, flags, state = got
    want, want_state = jax_steps(case, binpack)
    for g, w in enumerate(want):
        if w is None:
            assert int(flags[g]) == 1 and not counts[g].any()
        else:
            assert int(flags[g]) == 0
            assert np.array_equal(counts[g].numpy(), w), g
    for f in FillState._fields:
        assert torch.equal(getattr(state, f), getattr(want_state, f)), f


HOST = [(c, i) for c, i in zip(CASES, CASE_IDS) if c[1] <= 2000]


@pytest.mark.parametrize("seed,N,G,opts", [c for c, _ in HOST],
                         ids=[i for _, i in HOST])
@pytest.mark.parametrize("name", ["flat", "binpack"])
def test_plain_matches_jax(name, seed, N, G, opts):
    case = flat_binpack_case(seed, N, G, **opts)
    got = run_tree(getattr(torch_placement, f"{name}_fill_step_plain"), case,
                   CPU)
    assert_reference(got, case, name == "binpack")


# ------------------------------------------------------------ generator
def test_wide_cases_take_the_component_route():
    for seed, N, G, opts in CASES:
        if N > 2000:
            continue
        bits = [b for b in key_bits(flat_binpack_case(seed, N, G, **opts))
                if b is not None]
        if opts.get("wide"):
            assert bits and max(bits) > 63, (seed, bits)
        else:
            assert all(b <= 63 for b in bits), (seed, bits)


def test_the_generator_covers_the_edges():
    one = flat_binpack_case(8, 2000, 4, one_chunk=True)
    assert one["mask"].any() and not one["mask"][:, :CHUNK].any()
    assert not one["mask"][:, 2 * CHUNK:].any()
    small = flat_binpack_case(10, 31, 3, one_chunk=True)
    assert small["mask"].any()
    exact = flat_binpack_case(5, 200, 4, exact_quota=True)
    cap = np.where(exact["mask"][0], np_caps(exact, 0), 0)
    assert exact["n_tasks"][0] == cap.sum() > 0
    assert (cap <= exact["n_tasks"][0]).all()     # q == capsum
    wide = flat_binpack_case(7, 1000, 3, wide=True)
    assert wide["totals"].max() > 1 << 29 and wide["totals"].min() < 3
    assert (wide["totals"].astype(np.int64) + 300 < 1 << 30).all()
    over = flat_binpack_case(9, 700, 3, overflow=True)
    assert over["n_tasks"][-1] == 1 << 30 and over["mask"][-1].all()
    bits = [b for c in CASES if c[1] <= 2000
            for b in key_bits(flat_binpack_case(c[0], c[1], c[2], **c[3]))]
    assert None in bits and any(b is not None for b in bits)


# ------------------------------------------------------ scratch guard
@pytest.mark.parametrize("what", ["flat_fill_step", "binpack_fill_step"])
def test_scratch_words_guard_names_the_step(what):
    assert torch_placement._scratch_words(4_096, what) == 4_096
    with pytest.raises(ValueError, match=f"{what}: scratch past"):
        torch_placement._scratch_words(-1, what)
