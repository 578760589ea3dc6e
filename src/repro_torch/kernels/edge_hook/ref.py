"""Plain PyTorch version of the edge_hook kernel (the unfused SV2/SV3
phases), in the ``n + 1`` drop-buffer form of ``repro``'s oracle, and
the layout of the kernel's packed path stated plainly
(``edge_hook_packed_ref``): sv2's packed label words and sv3's root
bits, which its node passes write, the stamp bytes its sv2 edge pass
sets, and the stamps its last pass writes from them."""
from __future__ import annotations

import torch


def drop_scatter_min(
    target: torch.Tensor, index: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``target`` with ``values`` min-scattered at ``index``; index ``n``
    (one past the end) is the no-op lane. The counterpart of JAX's
    ``.at[index].min(values, mode="drop")``: the old value takes part in
    the min, and the drop lane is a scratch slot cut off afterwards."""
    n = target.shape[0]
    buf = torch.cat([target, target.new_full((1,), n)])
    buf.scatter_reduce_(0, index.long(), values, "amin", include_self=True)
    return buf[:n]


def drop_scatter_fill(
    target: torch.Tensor, index: torch.Tensor, value: int
) -> torch.Tensor:
    """``target`` with the one scalar ``value`` stored at ``index``; index
    ``n`` is the no-op lane. Every lane writes the same value, so
    duplicate indices commute."""
    n = target.shape[0]
    buf = torch.cat([target, target.new_zeros(1)])
    buf.index_fill_(0, index.long(), value)
    return buf[:n]


def edge_hook_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    labels: torch.Tensor,
    labels_prev: torch.Tensor,
    stamps: torch.Tensor,
    s: int,
    *,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """sv2 returns ``(labels_out, stamps_out)``; sv3 returns
    ``(labels_out, live)`` with ``live = labels[a] != labels[b]``."""
    n = labels.shape[0]
    Da, Db = labels[a], labels[b]
    if mode == "sv2":
        cond = (Da == labels_prev[a]) & (Db < Da)
        out = drop_scatter_min(
            labels, torch.where(cond, Da, n), torch.where(cond, Db, n)
        )
        return out, drop_scatter_fill(stamps, torch.where(cond, Db, n), s)
    if mode == "sv3":
        live = Da != Db
        cond = (stamps[Da] < s) & (labels[Da] == Da) & live
        out = drop_scatter_min(
            labels, torch.where(cond, Da, n), torch.where(cond, Db, n)
        )
        return out, live
    raise ValueError(f"unknown mode {mode!r}")


LABEL_BITS = 0x7FFFFFFF  # a packed word: the label in bits 0-30, a flag in bit 31


def stagnant_words(labels: torch.Tensor, labels_prev: torch.Tensor) -> torch.Tensor:
    """sv2's node pass: ``P[i] = labels[i] | (labels[i] == labels_prev[i])
    << 31``, the label and the stagnant test in one gathered word; the
    32-bit words as int64."""
    return labels.long() | ((labels == labels_prev).long() << 31)


def bit_words(flags: torch.Tensor) -> torch.Tensor:
    """``flags`` (n bools) as ``(n + 31) // 32`` 32-bit words (int64):
    bit ``i % 32`` of word ``i // 32`` is ``flags[i]``."""
    words = torch.zeros((flags.shape[0] + 31) // 32, dtype=torch.int64,
                        device=flags.device)
    node = torch.nonzero(flags).flatten()
    # Distinct bits of one word add up to their OR.
    return words.index_add_(0, node >> 5, torch.ones_like(node) << (node & 31))


def bit_of(words: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Bit ``node`` of ``words`` (``bit_words``'s layout), as bools."""
    node = node.long()
    return (words[node >> 5] >> (node & 31)) & 1 == 1


def root_bits(labels: torch.Tensor, stamps: torch.Tensor, s: int) -> torch.Tensor:
    """sv3's node pass: bit i set where ``stamps[i] < s`` and
    ``labels[i] == i`` (a stagnant root), in ``bit_words``'s layout; a
    live edge reads bit ``labels[a]`` for both of its root tests."""
    node = torch.arange(labels.shape[0], device=labels.device)
    return bit_words((stamps < s) & (labels == node))


def stamp_bytes(nodes: torch.Tensor, n: int) -> torch.Tensor:
    """One uint8 a node, 1 for every node in ``nodes``: what sv2's edge
    pass writes, with plain stores of one value, where a hook stamps a
    node."""
    stamped = torch.zeros(n, dtype=torch.uint8, device=nodes.device)
    return stamped.index_fill_(0, nodes.long(), 1)


def stamps_from_bytes(stamped: torch.Tensor, stamps: torch.Tensor, s: int) -> torch.Tensor:
    """sv2's last node pass: ``s`` where a node was stamped, else its stamp,
    whatever the stamp was."""
    return torch.where(stamped == 1, s, stamps)


def edge_hook_packed_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    labels: torch.Tensor,
    labels_prev: torch.Tensor,
    stamps: torch.Tensor,
    s: int,
    *,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``edge_hook_ref`` computed the way of the kernel's packed path:
    sv2's edge pass gathers only the packed words, sv3's reads the root
    test of a live edge from the root bits, and sv2's stamps go through
    the stamp bytes. Returns what ``edge_hook_ref`` returns."""
    n = labels.shape[0]
    if mode == "sv2":
        P = stagnant_words(labels, labels_prev)
        pa, pb = P[a], P[b]
        Da, Db = pa & LABEL_BITS, pb & LABEL_BITS
        hook = (pa >> 31 == 1) & (Db < Da)
    elif mode == "sv3":
        Da, Db = labels[a].long(), labels[b].long()
        live = Da != Db
        hook = live & bit_of(root_bits(labels, stamps, s), Da)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = drop_scatter_min(labels, torch.where(hook, Da, n),
                           torch.where(hook, Db, n).to(labels.dtype))
    if mode == "sv2":
        return out, stamps_from_bytes(stamp_bytes(Db[hook], n), stamps, s)
    return out, live
