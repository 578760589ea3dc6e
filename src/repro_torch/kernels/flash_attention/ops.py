"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py::_attn_kernel``
(launched by ``flash_attention_pallas``, wrapper
``repro/kernels/flash_attention/ops.py::flash_attention``). It computes
``attention_ref``'s function -- blocked online-softmax attention with
causal and sliding-window masks and GQA by head index (query head ``h``
reads KV head ``h // (Hq // Hkv)``; no repeated K/V is made) -- on
``(B, Hq, Sq, D)`` queries and ``(B, Hkv, Sk, D)`` keys and values.
What bounds it on the H100 is the tensor cores' arithmetic: a causal
prefill at S = 4096 does about 330 operations per byte it must move.

Unlike the Pallas wrapper, this one pads nothing: ragged ``Sq`` and
``Sk`` are bounds checks inside the kernel, and keys past ``Sk`` never
score, so non-causal ragged calls equal ``attention_ref`` (the Pallas
path's padded keys do score there; ROADMAP queue 3).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_status, launch_counts, resolve_impl
from repro_torch.kernels.flash_attention.ref import attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)

# Head dims with a template instance in csrc/flash_attention.cu: every
# head_dim of the dense LM configs and their smoke configs.
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# dtype -> the kernel's dtype code: bf16 runs on the tensor cores
# (mma.sync, float32 accumulators), float32 in float32 FMA (never TF32).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, at a 16-byte-aligned address (the kernel loads
    rows in 16-byte vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v``; returns ``(B, Hq, Sq, D)`` in
    ``q``'s dtype. ``window=w`` keeps a score iff ``0 <= qpos - kpos < w``
    with ``causal``, iff ``qpos - kpos < w`` without."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            "flash_attention takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "need the same batch and head_dim, and Hq a multiple of Hkv"
        )
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if resolve_impl(impl, q) == "torch":
        return attention_ref(q, k, v, causal=causal, window=window)
    from repro_torch.kernels.build import function

    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel has no instance for head_dim {d}; "
            f"it takes {HEAD_DIMS}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "flash_attention kernel takes bfloat16 or float32 q, k, v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if b * hq > 65_535 or max(sq, sk) >= 1 << 31:
        raise ValueError(
            f"flash_attention kernel takes B*Hq <= 65535 and lengths below "
            f"2**31; got B*Hq={b * hq}, Sq={sq}, Sk={sk}"
        )
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0 or sk == 0:  # no key: zeros, as attention_ref
        return out.zero_()
    fn = function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    check_status("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, int(causal),
        0 if window is None else int(window),
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    launch_counts["flash_attention"] += 1
    return out
