"""Batched IPAM and port grants (the port of the JAX package's
`ops/alloc.py`).

One primitive serves both allocators: given an occupancy mask over a pool
and the scalar allocator's probe cursor, list every FREE slot in the exact
circular probe order the scalar oracle (`allocator/ipam.py _Pool.allocate`,
`allocator/allocator.py PortAllocator._find_dynamic`) would visit it. A
batch of K grants is then K sequential scalar calls, bit for bit (no
release interleaves inside a batch).

  * `grant_order_np`: numpy, the oracle and the small-pool path;
  * `grant_order_plain`: the reference kernel's body in PyTorch (a stable
    argsort of the masked probe key), for CPU tensors;
  * `grant_order_tensor`: kernel K19 (csrc/grant_order.cu, launched by
    `grant_order_launch`) for CUDA tensors, the plain version for CPU
    tensors; any other device raises;
  * `grant_order`: the reference's dispatch, numpy at or below
    POOL_THRESHOLD slots and the device branch above it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import _kernels

# pools at or under this size take the numpy path, larger ones the device
# (the JAX package's JAX_POOL_THRESHOLD): a /24 pool is 256 slots, where a
# device round trip would cost more than the grant
POOL_THRESHOLD = 4096

_I32 = 1 << 31


def grant_order_np(taken: np.ndarray, cursor: int, lo: int,
                   hi: int) -> np.ndarray:
    """Free offsets of `taken[lo..hi]` in circular probe order starting at
    `cursor` (clamped to `lo` when outside the range, the scalar wrap
    reset). Pure numpy: a copy of the reference's oracle."""
    span = hi - lo + 1
    start = cursor if lo <= cursor <= hi else lo
    pos = np.arange(lo, hi + 1, dtype=np.int32)
    key = (pos - np.int32(start)) % np.int32(span)
    free = ~taken[lo:hi + 1]
    order = np.argsort(np.where(free, key, np.int32(span)), kind="stable")
    n_free = int(free.sum())
    return pos[order[:n_free]]


def _check_range(size: int, lo: int, hi: int) -> None:
    if size >= _I32:
        raise ValueError(f"a pool of {size} slots: positions past 2^31 - 1 "
                         "do not fit the reference's int32 positions")
    if not 0 <= lo <= hi < size:
        raise ValueError(f"probe range [{lo}, {hi}] outside a pool of "
                         f"{size} slots")


def grant_order_plain(taken, cursor: int, lo: int, hi: int):
    """Plain PyTorch version on taken's device: the reference kernel's
    body, a stable argsort of the masked key, cut at the free count.
    taken: bool[size]; returns int32[n_free]."""
    _check_range(taken.shape[0], lo, hi)
    span = hi - lo + 1
    start = cursor if lo <= cursor <= hi else lo
    pos = torch.arange(lo, hi + 1, dtype=torch.int32, device=taken.device)
    key = torch.remainder(pos - start, span).to(torch.int32)
    free = ~taken[lo:hi + 1]
    order = torch.argsort(torch.where(free, key, span), stable=True)
    n_free = int(free.sum())
    return pos[order[:n_free]]


def _check_mask(taken) -> None:
    if not isinstance(taken, torch.Tensor) or taken.dtype != torch.bool \
            or taken.dim() != 1:
        raise TypeError("taken: expected a 1-D bool tensor")


def grant_order_launch(taken, cursor: int, lo: int, hi: int):
    """Kernel K19 (csrc/grant_order.cu) on a CUDA mask, without reading
    its count: (out int32[span], n_free int32[1]) on taken's device, the
    grant order in out[:n_free]. taken: bool[size], size < 2^31."""
    _check_mask(taken)
    if taken.device.type != "cuda":
        raise ValueError(f"no grant order kernel for device {taken.device}")
    _check_range(taken.shape[0], lo, hi)
    if not taken.is_contiguous():
        raise ValueError("taken: not contiguous")
    span = hi - lo + 1
    start = cursor if lo <= cursor <= hi else lo
    seg = taken[lo:hi + 1]
    dev = taken.device
    out = torch.empty(span, dtype=torch.int32, device=dev)
    n_free = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _kernels.lib("grant_order")
    n_tiles = -(-span // lib.skt_grant_order_tile())
    scratch = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    rc = lib.skt_grant_order(seg.data_ptr(), out.data_ptr(),
                             n_free.data_ptr(), scratch.data_ptr(), span,
                             start - lo, lo, _kernels.stream_of(seg))
    _kernels.check(rc, "grant_order")
    grant_order_launch.launches += 1
    return out, n_free


grant_order_launch.launches = 0


def grant_order_tensor(taken, cursor: int, lo: int, hi: int):
    """Free positions of `taken[lo..hi]` in circular probe order from
    `cursor`, as int32[n_free] on taken's device: kernel K19 for a CUDA
    tensor, with one read of n_free; the plain version for a CPU tensor;
    any other device raises. taken: bool[size], size < 2^31."""
    _check_mask(taken)
    if _kernels.route("grant order", taken) == "plain":
        return grant_order_plain(taken, cursor, lo, hi)
    out, n_free = grant_order_launch(taken, cursor, lo, hi)
    return out[:int(n_free.item())]


def grant_order(taken: np.ndarray, cursor: int, lo: int, hi: int,
                device=None) -> np.ndarray:
    """The reference's dispatch: numpy at or below POOL_THRESHOLD slots,
    the device branch above it: the mask is uploaded to `device` (None:
    the current CUDA device, raising without one; "cpu": the plain
    version), the grant order computed there and returned as int32
    numpy. Bit-identical either way."""
    if taken.shape[0] <= POOL_THRESHOLD:
        return grant_order_np(taken, cursor, lo, hi)
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(taken, dtype=bool)).to(dev)
    return grant_order_tensor(t, cursor, lo, hi).cpu().numpy()
