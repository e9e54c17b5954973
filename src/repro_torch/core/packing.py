"""Trit packing: 4 ternary values per byte (2-bit fields).

The storage format of the reference package, byte for byte:
  field encoding  0b00 -> 0,  0b01 -> +1,  0b10 -> -1   (0b11 unused)
  byte layout     trit j occupies bits [2*(j%4), 2*(j%4)+1] of byte j//4.
"""

from __future__ import annotations

import math

import torch

__all__ = ["pack_trits", "unpack_trits", "packed_nbytes", "ptqtp_weight_bytes"]


def pack_trits(t: torch.Tensor) -> torch.Tensor:
    """Pack trits (..., d) in {-1, 0, 1}, d % 4 == 0, into (..., d//4) uint8."""
    if t.shape[-1] % 4:
        raise ValueError(f"last dim {t.shape[-1]} must be divisible by 4")
    t = t.to(torch.int8)
    enc = torch.where(t == -1, torch.full_like(t, 2), t).to(torch.uint8)
    e = enc.reshape(*t.shape[:-1], t.shape[-1] // 4, 4)
    return e[..., 0] | (e[..., 1] << 2) | (e[..., 2] << 4) | (e[..., 3] << 6)


def unpack_trits(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Unpack (..., b) uint8 -> (..., 4*b) trits in {-1, 0, 1} of ``dtype``."""
    p = packed.to(torch.uint8)
    fields = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=-1)
    t = (fields == 1).to(torch.int8) - (fields == 2).to(torch.int8)
    return t.reshape(*packed.shape[:-1], packed.shape[-1] * 4).to(dtype)


def packed_nbytes(shape) -> int:
    """Bytes used by one packed trit-plane of logical ``shape``."""
    n = math.prod(shape)
    if n % 4:
        raise ValueError(f"{shape} does not pack into whole bytes")
    return n // 4


def ptqtp_weight_bytes(shape, group_size: int = 128, scale_bytes: int = 2) -> int:
    """PTQTP storage of a weight of ``shape``: 2 planes + 2 scales per group
    (paper Eq. 13)."""
    n = math.prod(shape[:-1])
    d = int(shape[-1])
    n_groups = -(-d // group_size)
    return 2 * packed_nbytes((n, d)) + n_groups * n * 2 * scale_bytes
