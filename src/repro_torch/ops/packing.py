"""Field packing layouts (paper guideline G5, the 48-bit vs 64-bit
study): the port of ``repro/ops/packing.py``, bit for bit.

The paper packs the per-node (mark, rank) pair into a single 64-bit union so
each list node costs one memory transaction instead of two. The same
idea is a layout choice here:

* **SoA** ("48-bit analogue"): separate ``owner[n]`` / ``rank[n]`` arrays.
  Following a pointer costs two independent gathers.
* **AoS** ("64-bit analogue"): one ``(n, 2)`` int32 array; a row gather
  fetches both fields in one 8-byte contiguous access.
* **word64**: true bit packing into one int64 word, rank in the high 32
  bits and owner in the low 32; closest to the paper's union trick, kept
  for the packing benchmark. torch has int64 always (the reference needs
  ``jax_enable_x64``).

These helpers are deliberately dtype-strict: the roofline term for the
gather-dominated kernels is computed directly from these layouts' byte
counts (the packing benchmark).
"""
from __future__ import annotations

import torch


def pack_aos(rank: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """Interleave two int32 fields into an (n, 2) array-of-structs."""
    if rank.shape != owner.shape:
        raise ValueError(f"shape mismatch {tuple(rank.shape)} vs {tuple(owner.shape)}")
    return torch.stack([rank.to(torch.int32), owner.to(torch.int32)], dim=-1)


def unpack_aos(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return packed[..., 0], packed[..., 1]


def gather_aos(packed: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One row gather -> both fields (the single 64-bit transaction)."""
    row = packed[idx.long()]
    return row[..., 0], row[..., 1]


def pack_word64(rank: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """Pack (rank, owner) into one int64 word: rank in high 32, owner low
    32 (the owner's 32 bits as unsigned), as the reference's uint64
    arithmetic packs them."""
    r = rank.to(torch.int64)
    o = owner.to(torch.int64) & 0xFFFFFFFF
    return (r << 32) | o


def unpack_word64(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``pack_word64``: the two int32 fields, each its
    word's 32 bits (wrapping as the reference's casts wrap)."""
    w = packed.to(torch.int64)
    rank = _wrap32(w >> 32)
    owner = _wrap32(w & 0xFFFFFFFF)
    return rank, owner


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as int32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bytes_per_node(pack_mode: str) -> dict[str, int]:
    """Analytic per-node traffic of one RS3 walk step (paper section 3.3).

    Returns bytes moved per list node per iteration for the sub-list walking
    kernel, used by the Table-2/Fig-3 reproduction to predict the inflection
    ordering between layouts.
    """
    if pack_mode == "soa":
        # read succ(4) + read owner(4) + write owner(4) + write rank(4)
        return {"read": 8, "write": 8}
    if pack_mode == "aos":
        # read succ(4) + row read (8) + row write (8)
        return {"read": 12, "write": 8}
    if pack_mode == "word64":
        # read succ(4) + word read (8) + word write (8)
        return {"read": 12, "write": 8}
    raise ValueError(f"unknown pack_mode {pack_mode!r}")
