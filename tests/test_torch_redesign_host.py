"""The host halves of the redesigned K12 (match-index commit) and K6 (counts
window) wrappers: pure functions, on the CPU.

  * `raft_replay.host_quorum`: every host form of a quorum gives the int
    that `torch.as_tensor(quorum, dtype=torch.int32)` gives, and what that
    refuses raises the same way; a tensor on another device is left to the
    kernel (None);
  * `resident.window_vector`: K6's vector path only when both arrays' rows
    start on 16-byte boundaries.

Exact equality throughout.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.ops import raft_replay as torch_replay
from swarmkit_tpu_torch.ops import resident as torch_resident

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.mark.parametrize("q", [-5, -1, 0, 1, 3, 1000, INT32_MIN, INT32_MAX])
def test_host_quorum_forms_agree(q):
    forms = [q, np.int32(q), np.int64(q), torch.tensor(q, dtype=torch.int32),
             torch.tensor(q, dtype=torch.int64), torch.tensor([q]),
             np.array([q], np.int32)]
    for f in forms:
        got = torch_replay.host_quorum(f)
        assert type(got) is int and got == q, repr(f)
        assert got == int(torch.as_tensor(f, dtype=torch.int32).reshape(1)[0])


@pytest.mark.parametrize("q", [2**31, -2**31 - 1, 2**40, np.int64(2**31),
                               np.int64(-2**31 - 1), np.uint32(2**31)])
def test_host_quorum_refuses_what_int32_refuses(q):
    with pytest.raises(RuntimeError) as want:
        torch.as_tensor(q, dtype=torch.int32)
    with pytest.raises(RuntimeError) as got:
        torch_replay.host_quorum(q)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("q", [True, 2.7, np.float64(3.9),
                               torch.tensor(2**40), torch.tensor(7.5)])
def test_host_quorum_converts_as_torch_does(q):
    assert torch_replay.host_quorum(q) == int(
        torch.as_tensor(q, dtype=torch.int32))


def test_host_quorum_leaves_device_tensors_to_the_kernel():
    # a tensor off the host is never read there (a meta tensor cannot be)
    assert torch_replay.host_quorum(
        torch.empty((), dtype=torch.int32, device="meta")) is None


@pytest.mark.parametrize("q", [-6, -5, -1, 0, 1, 3, 5, 6, INT32_MAX])
def test_every_host_form_commits_alike(q):
    # on CPU tensors the wrapper takes the plain route: each host form of
    # the quorum gives the int's answer
    mi = torch.tensor([7, 0, 9, 9, 2**31 - 1], dtype=torch.int32)
    want = int(torch_replay.match_index_commit(mi, q))
    for f in (np.int32(q), np.int64(q), torch.tensor(q),
              torch.tensor(q, dtype=torch.int32)):
        assert int(torch_replay.match_index_commit(mi, f)) == want


@pytest.mark.parametrize("src,dst,n,n_pad,vector", [
    (0, 0, 10000, 16384, True),
    (1 << 20, 512, 4, 4, True),
    (0, 0, 10001, 16384, False),
    (0, 0, 10002, 16384, False),
    (0, 0, 10003, 16384, False),
    (0, 0, 10000, 16383, False),
    (4, 0, 10000, 16384, False),
    (8, 0, 10000, 16384, False),
    (0, 8, 10000, 16384, False),
    (0, 2, 10000, 16384, False),
])
def test_window_vector_needs_every_alignment(src, dst, n, n_pad, vector):
    assert torch_resident.window_vector(src, dst, n, n_pad) is vector


def test_window_vector_on_an_offset_view():
    # a contiguous counts view one int32 into its storage: rows 4 bytes off
    base = torch.zeros(8 * 16384 + 1, dtype=torch.int32)
    counts = base[1:].view(8, 16384)
    out = torch.empty((8, 10000), dtype=torch.int16)
    assert counts.is_contiguous()
    assert not torch_resident.window_vector(counts.data_ptr(), out.data_ptr(),
                                            10000, 16384)
    aligned = torch.zeros((8, 16384), dtype=torch.int32)
    assert torch_resident.window_vector(aligned.data_ptr(), out.data_ptr(),
                                        10000, 16384)
