"""The port's bit-pack pair (`ops/bitpack.py`: `pack_bits` on the host,
`unpack_bits` plain PyTorch on the CPU) and the raft ack upload built on it
(`ops/raft_replay.unpack_acks`), against the JAX package. Every output is
bool or uint8, so the tolerance is exact equality. Kernel K10 is held
against `unpack_bits_plain` on the card (tests/test_torch_gpu_replay.py)."""
import numpy as np
import pytest
import torch

from swarmkit_tpu.ops import bitpack as jax_bitpack
from swarmkit_tpu.ops import raft_replay as jax_replay
from swarmkit_tpu_torch.ops import bitpack as torch_bitpack
from swarmkit_tpu_torch.ops import raft_replay as torch_replay

torch.set_num_threads(1)


def _rows(seed, r, c, p=0.5):
    return np.random.RandomState(seed).rand(r, c) < p


@pytest.mark.parametrize("r,c", [(1, 1), (3, 7), (5, 8), (5, 13), (2, 999),
                                 (5, 1000), (7, 4097)])
def test_pack_bits_matches_jax(r, c):
    rows = _rows(r * 31 + c, r, c)
    got = torch_bitpack.pack_bits(rows)
    want = jax_bitpack.pack_bits(rows)
    assert got.dtype == np.uint8 and got.shape == (r, (c + 7) // 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["unpack_bits", "unpack_acks"])
@pytest.mark.parametrize("r,c", [(1, 1), (3, 7), (5, 8), (5, 13), (2, 999),
                                 (5, 1003), (4, 65_541)])
def test_unpack_matches_jax_and_round_trips(fn, r, c):
    rows = _rows(r * 17 + c, r, c, 0.7)
    packed = torch_bitpack.pack_bits(rows)
    if fn == "unpack_bits":
        got = torch_bitpack.unpack_bits(torch.from_numpy(packed), c)
        want = jax_bitpack.unpack_bits(packed, c)
    else:
        got = torch_replay.unpack_acks(torch.from_numpy(packed), c)
        want = jax_replay.unpack_acks(packed, c)
    assert got.dtype == torch.bool and tuple(got.shape) == (r, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), rows)


@pytest.mark.parametrize("c", [1, 9, 64])
def test_unpack_of_fewer_columns_than_packed(c):
    """n_cols below the packed width reads the leading bits, as the
    reference's gather does."""
    rows = _rows(c, 3, 64)
    packed = torch_bitpack.pack_bits(rows)
    got = torch_bitpack.unpack_bits(torch.from_numpy(packed), c)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_bitpack.unpack_bits(packed, c)))
    np.testing.assert_array_equal(got.numpy(), rows[:, :c])


def test_unpack_refuses_a_matrix_too_narrow():
    """The reference clamps an out-of-range word index; the port raises."""
    packed = torch.from_numpy(torch_bitpack.pack_bits(_rows(0, 2, 16)))
    with pytest.raises(ValueError, match="cannot hold 17 columns"):
        torch_bitpack.unpack_bits(packed, 17)
    with pytest.raises(ValueError, match="cannot hold"):
        torch_replay.unpack_acks(packed, 24)
    with pytest.raises(TypeError, match="uint8"):
        torch_bitpack.unpack_bits(packed.to(torch.int32), 16)
    with pytest.raises(ValueError, match="meta"):
        torch_bitpack.unpack_bits(packed.to("meta"), 16)
