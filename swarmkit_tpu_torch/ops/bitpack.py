"""Little-endian bit-pack/unpack pair for cold bool-matrix uploads (the port
of the JAX package's `ops/bitpack.py`).

A cold [R, C] bool matrix (the raft ack matrix, later the global diff's
eligibility) ships to the card as uint8 words, 8x fewer bytes, and unpacks
there. `pack_bits` is the host half (numpy); `unpack_bits` the device half:
kernel K10 (csrc/unpack_bits.cu) for CUDA tensors, its plain PyTorch version
`unpack_bits_plain` for CPU tensors; anything else raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _kernels


def pack_bits(rows) -> np.ndarray:
    """Host half: bool[R, C] -> uint8[R, ceil(C/8)], little bit order."""
    return np.packbits(np.asarray(rows, bool), axis=1, bitorder="little")


def _check_packed(packed, n_cols: int) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"packed: expected uint8[R, W], got {packed.dtype}"
                        f"{list(packed.shape)}")
    if n_cols < 0 or packed.shape[1] < (n_cols + 7) // 8:
        # the reference's gather would clamp the word index; the port
        # refuses a matrix too narrow for n_cols instead
        raise ValueError(f"packed: {packed.shape[1]} words a row cannot "
                         f"hold {n_cols} columns")


def unpack_bits_plain(packed, n_cols: int):
    """Plain PyTorch device half: uint8[R, >= ceil(C/8)] -> bool[R, C]."""
    _check_packed(packed, n_cols)
    idx = torch.arange(n_cols, device=packed.device)
    words = packed[:, idx // 8]
    return ((words >> (idx % 8).to(torch.uint8)) & 1).to(torch.bool)


def unpack_bits(packed, n_cols: int):
    """Device half: uint8[R, ceil(C/8)] -> bool[R, C] (out[r, c] = bit c % 8
    of packed[r, c // 8]). Raises ValueError when a row has fewer than
    ceil(n_cols / 8) words."""
    if _kernels.route("unpack_bits", packed) == "plain":
        return unpack_bits_plain(packed, n_cols)
    _check_packed(packed, n_cols)
    if not packed.is_contiguous():
        raise ValueError("packed: not contiguous")
    R, W = packed.shape
    out = torch.empty((R, n_cols), dtype=torch.bool, device=packed.device)
    if R * n_cols == 0:
        return out
    rc = _kernels.lib("unpack_bits").skt_unpack_bits(
        packed.data_ptr(), out.data_ptr(), R, W, n_cols,
        _kernels.stream_of(out))
    _kernels.check(rc, "unpack_bits")
    unpack_bits.launches += 1
    return out


unpack_bits.launches = 0
