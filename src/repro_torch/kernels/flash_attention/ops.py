"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py::_attn_kernel``
(launched by ``flash_attention_pallas``, wrapper
``repro/kernels/flash_attention/ops.py::flash_attention``). It computes
``attention_ref``'s function -- blocked online-softmax attention with
causal and sliding-window masks and GQA by head index (query head ``h``
reads KV head ``h // (Hq // Hkv)``; no repeated K/V is made) -- on
``(B, Hq, Sq, D)`` queries, ``(B, Hkv, Sk, D)`` keys and ``(B, Hkv, Sk,
Dv)`` values. ``Dv`` is ``D`` but for MLA, whose queries and keys are
192 wide (128 without rope, 64 with) and values 128.
What bounds it on the H100 is the tensor cores' arithmetic: a causal
prefill at S = 4096 does about 330 operations per byte it must move.

Unlike the Pallas wrapper, this one pads nothing: ragged ``Sq`` and
``Sk`` are bounds checks inside the kernel, and keys past ``Sk`` never
score, so non-causal ragged calls equal ``attention_ref`` (the Pallas
path's padded keys do score there; ROADMAP queue 3).

bfloat16 inputs go to the kernel as they come, any ``(B, H, S, D)``
strides whose last is 1: the kernel reads them through TMA tensor maps,
so the model's transposed ``(B, S, H, D)`` views need no copy, and the
output is allocated with ``q``'s strides, so its transpose back is a
view. ``kv_tile_plan`` states the kernel's tile schedule, and
``block_order`` the order of its blocks (bf16; the backward's first pass
runs its blocks in the same order).

Gradients: on the card, inputs that require grad go through
``_Attention``, a ``torch.autograd.Function`` whose forward is the
kernel above, writing each row's log-sum-exp beside the output, and
whose backward is a second hand kernel (``csrc/flash_attention_bwd.cu``,
``flash_attention_bwd`` here) that reads it: the reference takes that
VJP by autodiff, and no card path runs the plain version.
``ref.py::attention_vjp_ref`` is its plain counterpart,
``attention_bwd_ref`` the same function written as the kernel computes
it. The backward has two designs (``bwd_design``) with their tiles
(``bwd_tiles``); ``bwd_tile_plan`` states the schedule of the wgmma
design's second pass and ``bwd_head_groups`` how many blocks share one
KV head's query heads there.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import check_status, launch_counts, resolve_impl
from repro_torch.kernels.flash_attention.ref import attention_lse_ref, attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, out, lse (or null); dtype, batch, hq, hkv, sq, sk, d, dv,
# causal, window; the (batch, head, row) strides of q, k, v and out; the
# stream.
_ARGTYPES = (_P, _P, _P, _P, _P, *(_I,) * 10, *(_L,) * 12, _P)
# q, k, v, out, dout, dq, dk, dv, lse, stats, partials (or null); dtype,
# batch, hq, hkv, sq, sk, d, dv, causal, window, groups; a pointer to the
# 15 (batch, head, row) strides of q, k, v, out and dout; the stream.
_BWD_ARGTYPES = (*(_P,) * 11, *(_I,) * 11, _P, _P)

# Head dims with a template instance in csrc/flash_attention.cu: every
# head_dim of the GQA LM configs and their smoke configs (Dv = D).
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# (D, Dv) pairs with Dv != D, bfloat16 only: MLA's (nope 128 + rope 64,
# v 128) of deepseek-v3.
SPLIT_HEAD_DIMS = ((192, 128),)
# dtype -> the kernel's dtype code: bf16 runs on the tensor cores
# (wgmma, float32 accumulators), float32 in float32 FMA (never TF32).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows a block of the bf16 kernel; the float32 kernel's grid.y is
# B * Hq, and the backward's second pass (and both fma passes) put tiles
# on y, under this limit. The bf16 forward's blocks and the wgmma
# backward's first pass's, in block_order, are at most MAX_GRID_X.
BLOCK_Q = 128
MAX_GRID_Y = 65_535
MAX_GRID_X = 2**31 - 1


# The backward's wgmma design in bf16: D = Dv in these head dims (every
# one the forward takes), and the (D, Dv) pairs of SPLIT_HEAD_DIMS.
BWD_WGMMA_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# SMs of an H100 SXM: the card bwd_head_groups balances pass 2 for. A
# constant, not the card's count, so that a shape's sums run in one order
# on every card.
H100_SMS = 132
# bwd_head_groups' limit on the longest pass-2 block against the mean
# work per SM.
BWD_GROUP_SLACK = 1.1


class BwdTiles(NamedTuple):
    """The backward kernel's tiles for one instance
    (``csrc/flash_attention_bwd.cu``): pass 1 takes query tiles of
    ``block_q`` rows against K/V tiles of ``block_kv`` keys
    (``kv_tile_plan``'s schedule); pass 2 key tiles of ``block_k`` keys
    against Q/dO tiles of ``stat_rows`` rows (``bwd_tile_plan``), whose
    (lse, D_i) rows it reads from a scratch padded to ``stat_rows``."""
    block_q: int
    block_kv: int
    block_k: int
    stat_rows: int


def bwd_design(dtype: torch.dtype, d: int, dv: int) -> str:
    """The backward kernel's design for an instance the forward takes, as
    ``csrc/flash_attention_bwd.cu`` chooses it: ``"wgmma"`` (the
    forward's warp-specialised wgmma and TMA shape, seven products) for
    bfloat16 with D = Dv in ``BWD_WGMMA_HEAD_DIMS`` and for bfloat16
    (192, 128); ``"fma"`` (float32 FMA through shared memory) for
    float32. Raises ``ValueError`` on what the forward does not take."""
    if dtype not in _DTYPES or not (
            (d == dv and d in HEAD_DIMS)
            or ((d, dv) in SPLIT_HEAD_DIMS and dtype == torch.bfloat16)):
        raise ValueError(
            f"flash_attention has no instance for (D, Dv) = ({d}, {dv}) in {dtype}")
    if dtype == torch.bfloat16 and (d in BWD_WGMMA_HEAD_DIMS or (d, dv) in SPLIT_HEAD_DIMS):
        return "wgmma"
    return "fma"


def bwd_tiles(dtype: torch.dtype, d: int, dv: int) -> BwdTiles:
    """The tiles of the instance ``bwd_design`` names. wgmma: 128 query
    rows a block in pass 1 against K/V tiles of 128 keys, 128 keys a
    block in pass 2 against Q/dO tiles of 64 rows; at (192, 128) K/V
    tiles of 64 keys and Q/dO tiles of 32 rows, since dQ's (96) and dK's
    and dV's (160) float32 registers a thread leave too few of a
    consumer's 240 for the larger tiles; at D = 256 K/V tiles of 48 keys
    (dQ takes 128), and pass 2 splits dK and dV (128 each) between its
    two consumers, which then share 64 keys, against 64-row tiles. fma:
    16 rows and 16 keys."""
    design = bwd_design(dtype, d, dv)
    if design == "wgmma":
        if d == 256:
            return BwdTiles(128, 48, 64, 64)
        return BwdTiles(128, 64, 128, 32) if max(d, dv) > 128 else BwdTiles(128, 128, 128, 64)
    return BwdTiles(16, 16, 16, 16)


@functools.lru_cache(maxsize=64)
def bwd_head_groups(
    batch: int, hq: int, hkv: int, sq: int, sk: int, causal: bool,
    window: int | None, block_q: int, block_k: int,
) -> int:
    """G, the blocks of the wgmma design's second pass that share one KV
    head's query heads (each walks ``(hq // hkv) // G`` of them and
    writes float32 partial dK and dV that a third launch adds in group
    order). A block walks ``heads x len(tiles)`` steps of
    ``bwd_tile_plan(sq, sk, causal, window, block_q, block_k)`` for its
    key tile; the card's time is about the longer of its longest block
    and the mean work per SM (of ``H100_SMS``). G is the smallest
    divisor of the group whose longest block is at most
    ``BWD_GROUP_SLACK`` (1.1) times the mean per SM, else the whole
    group.

    At gemma-2b's training shape (B=1, Hq=8, Hkv=1, S=4096, causal, D =
    256: 64-key tiles against 64-row tiles) G = 4: 256 blocks, the
    longest 128 steps against a mean of 126 on 132 SMs (G = 1: 512).
    At qwen3-4b's (B=1, Hq=32, Hkv=8) and MLA's (group 1) G = 1."""
    group = hq // hkv
    walks = [len(tiles) for tiles in bwd_tile_plan(sq, sk, causal, window, block_q, block_k)]
    mean = batch * hkv * group * sum(walks) / H100_SMS
    for g in range(1, group + 1):
        if group % g == 0 and group // g * max(walks) <= BWD_GROUP_SLACK * mean:
            return g
    return group


def bwd_tile_plan(
    sq: int, sk: int, causal: bool, window: int | None,
    block_q: int, block_k: int,
) -> list[list[tuple[int, bool]]]:
    """The wgmma design's second pass, as ``csrc/flash_attention_bwd.cu``
    runs it (``QueryWalk``): for each key tile ``j`` (keys ``[j * block_k,
    min((j + 1) * block_k, sk))``), the query tiles of ``block_q`` rows it
    visits for each query head of its KV head, in its order (first
    first), each with whether it takes the mask.

    A key tile visits the query tiles that hold a live pair with one of
    its keys and, where rows with no live key exist (only with a window
    and ``Sq >= Sk + window``), every tile from the first that holds such
    a row: the reference gives those rows ``1 / Sk`` on every key. A tile
    runs without a mask only where every score in it is live: below the
    causal diagonal, inside the window, below ``Sk``."""
    last = -(-sq // block_q) - 1
    plan = []
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk) - 1
        live_hi, dead_lo = last, last + 1
        if window is not None:
            live_hi = min(sq - 1, k1 + window - 1) // block_q
            if sk + window - 1 <= sq - 1:
                dead_lo = (sk + window - 1) // block_q

        def skip(t):
            return dead_lo if live_hi < t < dead_lo else t

        # Causal: from the tile holding row k0, none where there is no such row.
        tiles, t = [], (last + 1 if k0 >= sq else skip(k0 // block_q)) if causal else 0
        while t <= last:
            q0 = t * block_q
            q1 = min(q0 + block_q, sq) - 1
            tiles.append((t, (causal and k0 + block_k - 1 > q0)
                          or (window is not None and q1 - k0 >= window)
                          or k0 + block_k > sk))
            t = skip(t + 1)
        plan.append(tiles)
    return plan


def block_k(v_head_dim: int) -> int:
    """Keys a K/V tile of the bf16 kernel: 128, or 64 for Dv = 256 (its
    float32 output accumulator alone takes 128 registers a thread)."""
    return 128 if v_head_dim <= 128 else 64


def kv_tile_plan(
    sq: int, sk: int, causal: bool, window: int | None,
    block_q: int, block_k: int,
) -> list[list[tuple[int, bool]]]:
    """The kernel's schedule, as ``csrc/flash_attention.cu`` runs it: for
    each query tile ``t`` (rows ``[t * block_q, min((t + 1) * block_q,
    sq))``), the K/V tiles it visits, in its order (last first), each
    with whether it takes the mask.

    A tile is skipped where it is wholly masked for every row of the
    query tile; a query tile that holds a row with no live key (only
    with a window and ``Sq >= Sk + window``) visits every tile, since
    the reference gives such a row equal weights on every key. A tile
    runs without a mask only where every score in it is live: below the
    causal diagonal for the first row, inside the window for the last,
    and below ``Sk``."""
    n_k = -(-sk // block_k)
    plan = []
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq) - 1
        lo, hi = 0, n_k - 1
        if window is None or q1 < sk + window - 1:
            if causal:
                hi = min(hi, q1 // block_k)
            if window is not None and q0 - window + 1 > 0:
                lo = (q0 - window + 1) // block_k
        tiles = []
        for j in range(hi, lo - 1, -1):
            k0 = j * block_k
            tiles.append((j, (causal and k0 + block_k - 1 > q0)
                          or (window is not None and q1 - k0 >= window)
                          or k0 + block_k > sk))
        plan.append(tiles)
    return plan


def block_order(batch: int, hq: int, hkv: int, sq: int) -> list[tuple[int, int, int]]:
    """The bf16 forward's blocks in launch order, as
    ``csrc/flash_attention.cu`` decodes its one-dimensional block index
    (``hopper_attention.cuh::block_of``), and those of the wgmma
    backward's first pass (``csrc/flash_attention_bwd.cu``, whose query
    tiles are ``BLOCK_Q`` rows too): ``(b, h, query tile)`` for each.
    The blocks go by KV head (``b * Hkv + kvh``); inside one the query
    tiles go longest first (the causal rows that visit the most K/V
    tiles), each tile over the KV head's ``Hq // Hkv`` query heads in
    order. So the blocks in flight read the K and V of a few KV heads,
    which stay in L2 while their query tiles pass, and the short tiles at
    each KV head's end fill the card behind the long ones."""
    tiles = -(-sq // BLOCK_Q)
    group = hq // hkv
    order = []
    for idx in range(batch * hq * tiles):
        g, r = divmod(idx, group * tiles)
        rank, j = divmod(r, group)
        bh = g * group + j
        order.append((bh // hq, bh % hq, tiles - 1 - rank))
    return order


def tma_strides(x: torch.Tensor) -> tuple[int, int, int] | None:
    """The element strides (batch, head, row) under which the kernel's
    TMA maps read the ``(B, H, S, D)`` tensor ``x`` in place, or None
    where they cannot: a last stride other than 1, or an address or a
    stride that is not a multiple of 16 bytes (or is 0). A dimension of
    size 1 is never stepped; its stride is given as 16 bytes."""
    size = x.element_size()
    if x.stride(3) != 1 and x.shape[3] > 1 or x.data_ptr() % 16:
        return None
    out = []
    for dim in range(3):
        st = x.stride(dim)
        if x.shape[dim] == 1:
            st = 16 // size
        elif st <= 0 or st * size % 16:
            return None
        out.append(st)
    return tuple(out)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` on what the kernel does not take: a head_dim
    (or a (D, Dv) pair, bfloat16 only) without an instance, a dtype other
    than one of bfloat16 and float32 for all three, tensors on different
    devices, or sizes past its grid's limits."""
    b, hq, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "flash_attention kernel takes bfloat16 or float32 q, k, v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if dv == d and d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel has no instance for head_dim {d}; "
            f"it takes {HEAD_DIMS}"
        )
    if dv != d and ((d, dv) not in SPLIT_HEAD_DIMS or q.dtype != torch.bfloat16):
        raise ValueError(
            f"flash_attention kernel has no instance for head dims (D, Dv) = "
            f"({d}, {dv}) in {q.dtype}; it takes {SPLIT_HEAD_DIMS} in "
            "torch.bfloat16"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.dtype == torch.bfloat16:
        blocks, limit, grid_limit = b * hq * -(-sq // BLOCK_Q), MAX_GRID_X, \
            "B*Hq*ceil(Sq/128) < 2**31"
    else:
        blocks, limit, grid_limit = b * hq, MAX_GRID_Y, "B*Hq <= 65535"
    if blocks > limit or b * hq >= 1 << 31 or max(sq, sk) >= 1 << 31:
        raise ValueError(
            f"flash_attention kernel takes {grid_limit} for {q.dtype}, B*Hq "
            f"and lengths below 2**31; got B*Hq={b * hq}, Sq={sq}, Sk={sk}"
        )


def _kernel_operand(x: torch.Tensor, dtype: torch.dtype):
    """``(tensor, strides)`` as the kernel reads them. bf16 goes in as it
    is where TMA can read it; a copy is made only where it cannot (see
    ``tma_strides``). The float32 kernel reads contiguous rows."""
    if dtype == torch.bfloat16:
        st = tma_strides(x)
        if st is not None:
            return x, st
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, tma_strides(x)


def _empty_out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """The output ``(B, Hq, Sq, Dv)``, laid out as ``q`` is: its dims in
    the order of ``q``'s strides, the head dim innermost. Where ``q`` is
    a transposed ``(B, S, H, D)`` view, so is the output, and its
    transpose back is a view."""
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    shape = [q.shape[i] for i in order[:3]] + [dv]
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    return out.permute(*sorted(range(4), key=order.index))


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int | None) -> None:
    """Raise ``ValueError`` unless ``q``, ``k``, ``v`` are ``(B, Hq, Sq,
    D)``, ``(B, Hkv, Sk, D)``, ``(B, Hkv, Sk, Dv)`` with Hq a multiple of
    Hkv, and ``window`` is None or at least 1."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            "flash_attention takes q (B, Hq, Sq, D), k (B, Hkv, Sk, D) and "
            f"v (B, Hkv, Sk, Dv); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "need the same batch and head_dim, and Hq a multiple of Hkv"
        )
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def _kernel_window(q, k, window: int | None) -> int | None:
    """``window`` as the kernels take it: None where it masks nothing (at
    least Sq + Sk; a C int would wrap past 2**31)."""
    if window is not None and window >= q.shape[2] + k.shape[2]:
        return None
    return window


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v``; returns ``(B, Hq, Sq, Dv)`` in
    ``q``'s dtype (for bf16 laid out as ``q`` is), the scores scaled by
    ``1 / sqrt(D)``. ``window=w`` keeps a score iff ``0 <= qpos - kpos <
    w`` with ``causal``, iff ``qpos - kpos < w`` without.

    The plain version (CPU tensors) carries autograd by itself. On the
    kernel's route, where grad mode is on and ``q``, ``k`` or ``v``
    requires grad, the call goes through ``_Attention``: the same
    forward launch, and ``flash_attention_bwd``'s kernel for the
    gradients."""
    _check_shapes(q, k, v, window)
    if resolve_impl(impl, q) == "torch":
        return attention_ref(q, k, v, causal=causal, window=window)
    check_kernel_inputs(q, k, v)
    window = _kernel_window(q, k, window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        check_backward_grid(q, k, v)
        return _Attention.apply(q, k, v, causal, window)
    return _forward_kernel(q, k, v, causal, window)


def flash_attention_lse(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: ``flash_attention``'s output and each row's
    log-sum-exp of its scaled scores, ``(B, Hq, Sq)`` float32 in natural
    log units, ``+inf`` for a row with no live key -- what ``_Attention``
    saves for ``flash_attention_bwd``. On the card one forward launch
    (counted) that writes both; on CPU tensors ``attention_ref`` and
    ``attention_lse_ref``. No autograd."""
    _check_shapes(q, k, v, window)
    if resolve_impl(impl, q) == "torch":
        with torch.no_grad():
            return (attention_ref(q, k, v, causal=causal, window=window),
                    attention_lse_ref(q, k, causal=causal, window=window))
    check_kernel_inputs(q, k, v)
    window = _kernel_window(q, k, window)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.no_grad():
        return _forward_kernel(q, k, v, causal, window, lse), lse


def _forward_kernel(q, k, v, causal: bool, window: int | None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel's launch on checked inputs; where ``lse`` (a
    contiguous ``(B, Hq, Sq)`` float32 tensor) is given, the kernel also
    writes each row's log-sum-exp into it."""
    from repro_torch.kernels.build import function

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dtype = q.dtype
    (q, q_st), (k, k_st), (v, v_st) = (_kernel_operand(x, dtype) for x in (q, k, v))
    dv = v.shape[3]
    out = _empty_out(q, dv)
    if out.numel() == 0 or sk == 0:  # no key: zeros, as attention_ref
        if lse is not None:
            lse.fill_(float("inf"))
        return out.zero_()
    o_st = tuple(out.stride()[:3])
    fn = function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    check_status("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _DTYPES[dtype], b, hq, hkv, sq, sk, d, dv, int(causal),
        0 if window is None else int(window),
        *q_st, *k_st, *v_st, *o_st,
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    launch_counts["flash_attention"] += 1
    return out


class _Attention(torch.autograd.Function):
    """``flash_attention`` on the card with gradients: the forward kernel,
    writing each row's log-sum-exp beside the output, then
    ``flash_attention_bwd``'s kernel on the saved ``q, k, v``, output and
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = _forward_kernel(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward_kernel(q, k, v, out, dout, lse, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def _bwd_operand(x: torch.Tensor):
    """``(tensor, strides)`` as the backward kernel reads it: any
    ``(B, H, S, D)`` strides whose last is 1 and whose others, and whose
    address, are multiples of 16 bytes (``tma_strides``); else a
    contiguous copy."""
    st = tma_strides(x)
    if st is None:
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        st = tma_strides(x)
    return x, st


def check_backward_grid(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` where the backward kernel's grids would pass
    their limit, at the instance's ``bwd_tiles``. The wgmma design's first
    pass is one-dimensional (``block_order``): B * Hq * ceil(Sq / block_q)
    blocks, at most ``MAX_GRID_X``. Its second pass, and both passes of
    the fma design, put the key tiles (pass 2) or query tiles (pass 1) on
    grid.y, at most ``MAX_GRID_Y``."""
    b, hq, sq = q.shape[:3]
    sk = k.shape[2]
    tiles = bwd_tiles(q.dtype, q.shape[3], v.shape[3])
    bq, bk = tiles.block_q, tiles.block_k
    if bwd_design(q.dtype, q.shape[3], v.shape[3]) == "wgmma":
        if b * hq * -(-sq // bq) > MAX_GRID_X or -(-sk // bk) > MAX_GRID_Y:
            raise ValueError(
                f"flash_attention's backward kernel takes B*Hq*ceil(Sq/{bq}) <= 2**31 - 1 "
                f"and Sk <= 65535 * {bk} for {q.dtype}; got B*Hq={b * hq}, Sq={sq}, Sk={sk}"
            )
        return
    if -(-sq // bq) > MAX_GRID_Y or -(-sk // bk) > MAX_GRID_Y:
        raise ValueError(
            f"flash_attention's backward kernel takes Sq <= 65535 * {bq} and "
            f"Sk <= 65535 * {bk} for {q.dtype}; got Sq={sq}, Sk={sk}"
        )


def flash_attention_bwd(
    q: torch.Tensor,     # (B, Hq, Sq, D)
    k: torch.Tensor,     # (B, Hkv, Sk, D)
    v: torch.Tensor,     # (B, Hkv, Sk, Dv)
    out: torch.Tensor,   # (B, Hq, Sq, Dv): flash_attention(q, k, v)
    dout: torch.Tensor,  # (B, Hq, Sq, Dv)
    lse: torch.Tensor,   # (B, Hq, Sq) float32: flash_attention_lse's
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's launch on CUDA tensors: ``(dq, dk, dv)``,
    contiguous, in the inputs' dtype, the VJP of ``attention_ref`` at
    ``dout`` (``attention_vjp_ref``'s function; dK and dV summed over
    each KV head's query heads in float32), from the forward's ``out``
    and ``lse`` (``flash_attention_lse``). Takes the instances the
    forward takes, on the design ``bwd_design`` names, and raises, before
    anything is built, on the others. Counts the launch."""
    resolve_impl("cuda", q)  # raises for tensors off the card
    check_kernel_inputs(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, x in (("out", out), ("dout", dout)):
        if tuple(x.shape) != (b, hq, sq, dv) or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} must be {(b, hq, sq, dv)} {q.dtype} on "
                f"{q.device}; got {tuple(x.shape)} {x.dtype} on {x.device}"
            )
    if (tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(
            f"flash_attention_bwd: lse must be {(b, hq, sq)} torch.float32 on {q.device}; "
            f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}"
        )
    check_backward_grid(q, k, v)
    return _backward_kernel(q, k, v, out, dout, lse, causal, _kernel_window(q, k, window))


def _backward_kernel(q, k, v, out, dout, lse, causal: bool, window: int | None):
    """The backward kernel's launch on checked inputs."""
    from repro_torch.kernels.build import function

    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    kw = dict(dtype=q.dtype, device=q.device)
    dq = torch.empty((b, hq, sq, d), **kw)
    dk = torch.empty((b, hkv, sk, d), **kw)
    dv_ = torch.empty((b, hkv, sk, dv), **kw)
    if dq.numel() == 0 or sk == 0:  # no query row or no key: zero gradients
        return dq.zero_(), dk.zero_(), dv_.zero_()
    operands = [_bwd_operand(x) for x in (q, k, v, out, dout)]
    strides = (ctypes.c_longlong * 15)(*(s for _, st in operands for s in st))
    lse = lse.contiguous()
    design = bwd_design(q.dtype, d, dv)
    tiles = bwd_tiles(q.dtype, d, dv)
    # Pass 1 writes each row's (lse, D_i) here for pass 2 (the fma design:
    # D_i alone), rows padded to the instance's stat_rows.
    rows = tiles.stat_rows
    stats = torch.empty(b * hq * -(-sq // rows) * rows * 2,
                        dtype=torch.float32, device=q.device)
    groups, partials = 1, None
    if design == "wgmma":
        groups = bwd_head_groups(b, hq, hkv, sq, sk, causal, window,
                                 tiles.stat_rows, tiles.block_k)
    if groups > 1:  # pass 2's float32 partial dK and dV, one slice a head group
        partials = torch.empty(groups * b * hkv * sk * (d + dv),
                               dtype=torch.float32, device=q.device)
    fn = function("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)
    check_status("flash_attention_bwd", fn(
        *(x.data_ptr() for x, _ in operands), dq.data_ptr(), dk.data_ptr(),
        dv_.data_ptr(), lse.data_ptr(), stats.data_ptr(),
        None if partials is None else partials.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, dv, int(causal),
        0 if window is None else int(window), groups, ctypes.addressof(strides),
        torch.cuda.current_stream(q.device).cuda_stream,
    ))
    launch_counts["flash_attention.bwd" if design == "wgmma" else "flash_attention.bwd.fma"] += 1
    return dq, dk, dv_
