"""The host halves of the redesigned K24 (sharded counts pull) wrapper:
pure functions, on the CPU.

  * `resident_mesh.pull_vector`: the dense form's vector path only when
    every shard and the window start on 16-byte boundaries and both widths
    are multiples of 4 cells;
  * `resident_mesh._check_pull`: one pass over the shards when they are
    all well formed, and, for every input it refuses, the exception type
    and words that checking the shards one by one with `_expect` gives
    (the check as it was before the pass, kept here as the oracle);
  * `resident_mesh.shard_pointers`: the shard addresses packed as the
    ctypes array of pointers that the C entries read would hold them.

Exact equality throughout.
"""
import ctypes

import pytest
import torch

from swarmkit_tpu_torch.ops import resident_mesh as torch_rm
from swarmkit_tpu_torch.ops.placement import _expect


def _check_pull_one_by_one(counts, g, n):
    ks = len(counts)
    if not 1 <= ks <= torch_rm.MAX_PULL_SHARDS:
        raise ValueError(f"{ks} shards: the pull takes 1 to "
                         f"{torch_rm.MAX_PULL_SHARDS}")
    Gc, ns = counts[0].shape if counts[0].dim() == 2 else (-1, -1)
    for b, c in enumerate(counts):
        _expect(c, f"counts[{b}]", torch.int32, (Gc, ns))
    if not (0 <= g <= Gc and 0 <= n <= ks * ns):
        raise ValueError(f"window [{g}, {n}] outside {ks} shards of "
                         f"[{Gc}, {ns}]")
    return ks, ns


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (TypeError, ValueError) as e:
        return (type(e).__name__, str(e))


def _shards(k, Gc=3, n=8, dtype=torch.int32):
    return [torch.zeros((Gc, n), dtype=dtype) for _ in range(k)]


def _faulty(case):
    """(counts, g, n) for one refused or accepted input."""
    c = _shards(4)
    if case == "good":
        return c, 3, 30
    if case == "good empty window":
        return c, 0, 0
    if case == "no shards":
        return [], 1, 1
    if case == "too many shards":
        return _shards(torch_rm.MAX_PULL_SHARDS + 1, 1, 1), 1, 1
    if case == "dtype of shard 2":
        c[2] = c[2].long()
        return c, 3, 30
    if case == "dtype of shard 0":
        c[0] = c[0].short()
        return c, 3, 30
    if case == "width of shard 3":
        c[3] = torch.zeros((3, 9), dtype=torch.int32)
        return c, 3, 30
    if case == "rows of shard 1":
        c[1] = torch.zeros((2, 8), dtype=torch.int32)
        return c, 3, 30
    if case == "shard 0 1-D":
        c[0] = torch.zeros(24, dtype=torch.int32)
        return c, 3, 30
    if case == "shard 0 3-D":
        c[0] = torch.zeros((3, 8, 1), dtype=torch.int32)
        return c, 3, 30
    if case == "shard 0 1-D int64":
        c[0] = torch.zeros(24, dtype=torch.int64)
        return c, 3, 30
    if case == "shard 2 not contiguous":
        c[2] = torch.zeros((8, 3), dtype=torch.int32).t()
        return c, 3, 30
    if case == "shard 1 strided rows":
        c[1] = torch.zeros((3, 16), dtype=torch.int32)[:, ::2]
        return c, 3, 30
    if case == "two faults, dtype first":
        c[1] = c[1].long()
        c[3] = torch.zeros((3, 9), dtype=torch.int32)
        return c, 3, 30
    if case == "two faults, shape first":
        c[1] = torch.zeros((3, 9), dtype=torch.int32)
        c[3] = c[3].long()
        return c, 3, 30
    if case == "g above":
        return c, 4, 30
    if case == "g negative":
        return c, -1, 30
    if case == "n above":
        return c, 3, 33
    if case == "n negative":
        return c, 3, -1
    raise AssertionError(case)


CASES = ["good", "good empty window", "no shards", "too many shards",
         "dtype of shard 2", "dtype of shard 0", "width of shard 3",
         "rows of shard 1", "shard 0 1-D", "shard 0 3-D",
         "shard 0 1-D int64", "shard 2 not contiguous",
         "shard 1 strided rows", "two faults, dtype first",
         "two faults, shape first", "g above", "g negative", "n above",
         "n negative"]


@pytest.mark.parametrize("case", CASES)
def test_check_pull_agrees_with_the_checks_one_by_one(case):
    counts, g, n = _faulty(case)
    got = _outcome(torch_rm._check_pull, counts, g, n)
    want = _outcome(_check_pull_one_by_one, counts, g, n)
    assert got == want
    assert (got[0] == "ok") == case.startswith("good")


def test_check_pull_no_shards_raises_as_before():
    # the words the refusal had before the single pass
    with pytest.raises(ValueError, match="0 shards: the pull takes 1 to "
                       f"{torch_rm.MAX_PULL_SHARDS}"):
        torch_rm._check_pull([], 1, 1)


A16 = 1 << 20          # an address on a 16-byte boundary


@pytest.mark.parametrize("ptrs,dst,n,ns,want", [
    ([A16] * 8, A16, 10_000, 2048, True),
    ([A16], A16 + 4096, 2048, 2048, True),
    ([A16 + 16 * i for i in range(256)], A16, 1024, 4, True),
    ([A16] * 8, A16, 10_001, 2048, False),       # window width % 4
    ([A16] * 8, A16, 10_002, 2048, False),
    ([A16] * 8, A16, 10_003, 2048, False),
    ([A16] * 3, A16, 3000, 1003, False),          # shard width % 4
    ([A16] * 2, A16, 2000, 1002, False),
    ([A16] * 8, A16, 10_000, 2049, False),
    ([A16] * 7 + [A16 + 4], A16, 10_000, 2048, False),   # a shard off
    ([A16 + 8] + [A16] * 7, A16, 10_000, 2048, False),
    ([A16] * 8, A16 + 2, 10_000, 2048, False),            # the window off
    ([A16] * 8, A16 + 8, 10_000, 2048, False),
    ([A16] * 8, A16, 0, 2048, True),
    ([A16] * 8, 0, 0, 2048, True),                # an empty window
])
def test_pull_vector(ptrs, dst, n, ns, want):
    assert torch_rm.pull_vector(ptrs, dst, n, ns) is want


@pytest.mark.parametrize("ptrs", [[A16], [A16, 0, 12_345], [1 << 47] * 8,
                                  [A16 + 16 * i for i in range(256)]])
def test_shard_pointers_pack_as_a_ctypes_array(ptrs):
    want = bytes((ctypes.c_void_p * len(ptrs))(*ptrs))
    assert torch_rm.shard_pointers(len(ptrs)).pack(*ptrs) == want
