"""Mixture-of-Experts layer with sort-based (coalesced) token dispatch:
the port's copy of the single-shard path of
``repro.models.transformer.moe``.

Top-k expert routing is an irregular scatter and gather, treated as the
paper treats list pointers: token copies are sorted by expert id with
one stable sort (``ops/sorted_dispatch.py::sort_by_key``), so every
later access is a contiguous block; a copy past its expert's capacity
is dropped without a branch (its slot is a scratch row past the end).
``dispatch="unsorted"`` builds the same buffers by a one-hot cumulative
sum in token order, the uncoalesced baseline; both drop the same copies
(first arrival in token order).

The combine, the reference's scatter-add ``out.at[tok].add(contrib)``,
is a float segment sum over token ids: the contributions are put back in
token-major order (each token owns ``top_k`` rows, so the ids are sorted
by construction) and summed by ``ops/segment.py::segment_sum``, which on
the card is the ``segment_sum`` kernel. It adds in float32 and rounds
once; the reference adds in the activation dtype, so in bf16 a token's
sum of ``top_k > 2`` rows can differ in its last bit.

The experts keep the reference's ``(E, d, f)`` and ``(E, f, d)``
layouts, the router its float32 ``(d, E)`` and the shared expert its
``(d, f)``/``(f, d)`` matrices, so carrying weights across is a copy.
The batched expert products are ``torch.bmm``, as the reference's are
einsums outside any Pallas kernel.

With a ``mesh`` the layer runs one of the reference's three schedules
(``moe_ffn``), on this rank's tokens and this rank's blocks of the
weights as ``configs/lm_family.py::moe_param_specs`` lays them out:

* ``all_to_all`` expert parallelism (``_moe_a2a``): each rank of the
  ``"model"`` axis routes its slice of the tokens, two all-to-alls over
  the EP axes bring each expert its rows and back, and an all-gather
  over ``"model"`` rebuilds the tokens. With ``a2a_dtype`` the dispatch
  payload travels as float8 bytes with a bf16 scale per row.
* the small-batch psum (``_moe_psum``): the few tokens are gathered over
  the data part of the EP axes, every rank runs its resident experts
  densely, and a sum over the EP axes combines them.
* expert tensor parallelism (``_moe_expert_tp``): every rank runs every
  expert over its slice of ``d_ff`` and a sum over ``"model"`` combines.

The collectives' gradients follow ``distributed/collectives.py``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    chunk,
    copy_to,
    exchange,
    gather_from,
    reduce_from,
    scatter_to,
)
from repro_torch.models.transformer.attention import normal_
from repro_torch.ops.segment import segment_sum
from repro_torch.ops.sorted_dispatch import (
    grouped_offsets,
    position_in_group,
    sort_by_key,
)

DISPATCHES = ("sorted_ep", "unsorted")


class MoE(nn.Module):
    """The parameters of one MoE feed-forward block, under the
    reference's keys and in its layouts."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt))

        self.router = param(d, e, dt=torch.float32)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)
        if m.num_shared_experts:
            fs = f * m.num_shared_experts
            self.w_gate_shared = param(d, fs)
            self.w_up_shared = param(d, fs)
            self.w_down_shared = param(fs, d)
        else:
            self.w_gate_shared = self.w_up_shared = self.w_down_shared = None


def init_moe_params(p: MoE, cfg, generator: torch.Generator) -> None:
    """Draw ``p``'s weights in place with the reference's scales:
    ``d ** -0.5`` for the router and the gate and up projections,
    ``f ** -0.5`` for the down projections (``f`` the expert width, times
    the shared experts for theirs)."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for w, scale in ((p.router, d ** -0.5), (p.w_gate, d ** -0.5),
                     (p.w_up, d ** -0.5), (p.w_down, f ** -0.5)):
        normal_(w, scale, generator)
    if p.w_gate_shared is not None:
        fs = f * cfg.moe.num_shared_experts
        for w, scale in ((p.w_gate_shared, d ** -0.5),
                         (p.w_up_shared, d ** -0.5),
                         (p.w_down_shared, fs ** -0.5)):
            normal_(w, scale, generator)


def _route(tokens: torch.Tensor, router: torch.Tensor, m):
    """float32 router -> (gates (T, k) float32, expert ids (T, k) int32),
    the largest probability first."""
    logits = tokens.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, m.top_k, dim=-1)
    if m.router_renorm:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, eidx.to(torch.int32)


def _dispatch(tokens, gates, eidx, m, num_experts: int, capacity: int):
    """Pack token copies into a dense ``(E, C, d)`` buffer.

    Returns ``(buffer, slot, kept, token_of_row, gate_of_row, order)``:
    the first five are the reference's, row for row (in expert order for
    ``"sorted_ep"``, in token order for ``"unsorted"``); ``order`` is the
    token-major index of each row (the sort's permutation), or None where
    the rows are already in token-major order. A dropped copy's slot is
    ``E * C``."""
    t, d = tokens.shape
    k = m.top_k
    dev = tokens.device
    flat_e = eidx.reshape(-1)
    flat_tok = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)
    flat_gate = gates.reshape(-1)

    if m.dispatch == "sorted_ep":
        keys, order, tok_s, gate_s = sort_by_key(flat_e, flat_tok, flat_gate)
        _, offsets = grouped_offsets(keys, num_experts)
        pos = torch.arange(t * k, dtype=torch.int32, device=dev) - offsets[keys.long()]
    elif m.dispatch == "unsorted":
        keys, order, tok_s, gate_s = flat_e, None, flat_tok, flat_gate
        pos = position_in_group(keys, num_experts)
    else:
        raise ValueError(
            f"unknown dispatch {m.dispatch!r}; valid choices: "
            + ", ".join(repr(c) for c in DISPATCHES))

    kept = pos < capacity
    slot = torch.where(kept, keys * capacity + pos, num_experts * capacity)
    # Dropped copies write to one scratch row past the end, cut off.
    buf = tokens.new_zeros(num_experts * capacity + 1, d)
    buf[slot.long()] = tokens[tok_s.long()]
    return (buf[:-1].reshape(num_experts, capacity, d), slot, kept, tok_s,
            gate_s, order)


def _token_major(order, *rows):
    """``rows`` (each indexed by dispatch row) put back in token-major
    order: row ``i`` goes to ``order[i]``."""
    out = []
    for r in rows:
        back = torch.empty_like(r)
        back[order] = r
        out.append(back)
    return out


def _combine(expert_rows, slot, kept, tok_s, gate_s, num_tokens: int, dtype,
             order=None):
    """Each kept copy's expert output times its gate, summed per token
    through ``segment_sum`` over token-major rows; returns
    ``(num_tokens, d)`` in ``dtype``. ``order`` is ``_dispatch``'s."""
    rows = expert_rows.reshape(-1, expert_rows.shape[-1])
    if order is not None:
        slot, kept, tok_s, gate_s = _token_major(order, slot, kept, tok_s, gate_s)
    safe = slot.long().clamp(0, rows.shape[0] - 1)
    contrib = torch.where(kept[:, None], rows[safe], 0)
    contrib = contrib * gate_s[:, None].to(contrib.dtype)
    out = segment_sum(contrib, tok_s, num_tokens, indices_are_sorted=True)
    return out.to(dtype)


def _expert_ffn(buf, w_gate, w_up, w_down, act):
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h.to(buf.dtype), w_down)


def _shared_ffn(x, w_gate, w_up, w_down, act):
    h = act(x @ w_gate) * (x @ w_up)
    return h.to(x.dtype) @ w_down


def _shared(p: MoE):
    return p.w_gate_shared, p.w_up_shared, p.w_down_shared


def _capacity(tokens_per_shard: int, m, num_experts: int) -> int:
    return max(
        1,
        math.ceil(tokens_per_shard * m.top_k / num_experts * m.capacity_factor),
    )


def moe_ffn_local(p: MoE, cfg, x: torch.Tensor, act) -> torch.Tensor:
    """Single-shard MoE: x (B, S, d) -> (B, S, d)."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    gates, eidx = _route(tokens, p.router, m)
    cap = _capacity(tokens.shape[0], m, m.num_experts)
    buf, slot, kept, tok_s, gate_s, order = _dispatch(
        tokens, gates, eidx, m, m.num_experts, cap)
    outs = _expert_ffn(buf, p.w_gate, p.w_up, p.w_down, act)
    out = _combine(outs, slot, kept, tok_s, gate_s, tokens.shape[0], x.dtype,
                   order)
    if m.num_shared_experts:
        out = out + _shared_ffn(tokens, *_shared(p), act)
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# sharded schedules
# ---------------------------------------------------------------------------


def _ep_axes(m, mesh, tp_axis: str) -> tuple:
    """The flat expert-parallel axes: the config's that the mesh has, else
    the tensor-parallel axis."""
    return tuple(a for a in m.ep_axes if a in mesh.axis_names) or (tp_axis,)


# The largest float32 magnitude that a cast to float8_e4m3fn rounds to its
# largest finite value (448); above it the reference's cast gives NaN,
# where torch's saturates to 448.
_E4M3_LIMIT = 464.0


def _to_f8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` (float32) cast to ``dtype`` as the reference's ``astype``
    casts it: NaN past the float8 range, where torch's cast saturates."""
    q = x.to(dtype)
    if dtype == torch.float8_e4m3fn:
        q = torch.where(x.abs() > _E4M3_LIMIT, torch.full_like(q, float("nan")), q)
    return q


class _Fp8Exchange(torch.autograd.Function):
    """The dispatch all-to-all with the reference's fp8 payload: a scale
    per row of ``max|x| / 448 + 1e-12`` (sent as bf16), the rows divided
    by it and cast to ``dtype`` (sent as their bytes), and multiplied
    back in float32 on arrival.

    The backward is the reference's VJP of those casts (``jax.vjp`` of
    its block, ``moe.py:221-236``), not a straight-through gradient:

    1. the cotangent ``g`` is widened to float32;
    2. ``g * sy`` is cast to ``dtype`` and sent back as its bytes, so a
       payload gradient under 2^-10 in size is exactly 0,
       and one past 464 is NaN, as the reference's cast gives (torch's
       would saturate at 448);
    3. on the sender it is widened and divided by ``scale``;
    4. the scale's own terms: ``sum(g * qy)`` per row sent back as bf16,
       plus ``-sum(g_q * buf / scale^2)`` from the division, both over
       448 and cast to the buffer's dtype, reach each row's arg-max of
       ``|buf|`` (ties split evenly, as the VJP of ``max`` splits them)
       with the sign of that element (+ at 0, as ``abs``'s).
    """

    @staticmethod
    def forward(ctx, buf, mesh, axes, dtype):
        ctx.mesh, ctx.axes, ctx.dtype = mesh, axes, dtype
        mx = buf.abs().amax(dim=-1, keepdim=True)
        scale = mx.float() / 448.0 + 1e-12
        qbuf = (buf.float() / scale).to(dtype)
        qy = exchange(qbuf, mesh, axes, 0, 1)
        sy = exchange(scale.to(torch.bfloat16), mesh, axes, 0, 1)
        ctx.save_for_backward(buf, mx, scale, qy, sy)
        return (qy.float() * sy.float()).to(buf.dtype)

    @staticmethod
    def backward(ctx, g):
        buf, mx, scale, qy, sy = ctx.saved_tensors
        mesh, axes = ctx.mesh, ctx.axes
        g32 = g.float()
        g_q = _to_f8(g32 * sy.float(), ctx.dtype)
        g_s = (g32 * qy.float()).sum(dim=-1, keepdim=True).to(torch.bfloat16)
        g_r = exchange(g_q, mesh, axes, 1, 0).float()
        g_scale = exchange(g_s, mesh, axes, 1, 0).float()
        b32 = buf.float()
        g_scale = g_scale + (-(g_r * (1.0 / (scale * scale))) * b32).sum(
            dim=-1, keepdim=True)
        g_mx = (g_scale / 448.0).to(buf.dtype)
        at_max = (buf.abs() == mx).to(buf.dtype)
        g_abs = g_mx / at_max.sum(dim=-1, keepdim=True) * at_max
        g_buf = (g_r / scale).to(buf.dtype) + torch.where(buf >= 0, g_abs, -g_abs)
        return g_buf, None, None, None


def _moe_a2a(p: MoE, cfg, x, act, mesh, ep_axes, tp_axis):
    """all_to_all EP: this rank routes its ``1/tp`` slice of the tokens,
    with a capacity per slice."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    chunk_len = tokens.shape[0] // mesh.shape[tp_axis]
    cap = _capacity(chunk_len, m, m.num_experts)
    my = scatter_to(tokens, mesh, tp_axis, 0)
    gates, eidx = _route(my, copy_to(p.router, mesh, tp_axis), m)
    buf, slot, kept, tok_s, gate_s, order = _dispatch(
        my, gates, eidx, m, m.num_experts, cap)
    if m.a2a_dtype is not None:
        y = _Fp8Exchange.apply(buf, mesh, ep_axes, getattr(torch, m.a2a_dtype))
    else:
        y = all_to_all(buf, mesh, ep_axes, 0, 1)  # (E / ep, ep * cap, d)
    outs = _expert_ffn(y, p.w_gate, p.w_up, p.w_down, act)
    z = all_to_all(outs, mesh, ep_axes, 1, 0)  # (E, cap, d)
    out = _combine(z, slot, kept, tok_s, gate_s, chunk_len, x.dtype, order)
    if m.num_shared_experts:
        # The shared expert runs whole on this rank's slice.
        w = [copy_to(gather_from(t, mesh, tp_axis, dim), mesh, tp_axis)
             for t, dim in zip(_shared(p), (1, 1, 0))]
        out = out + _shared_ffn(my, *w, act)
    return gather_from(out, mesh, tp_axis, 0).reshape(b, s, d)


class _GatherRows(torch.autograd.Function):
    """Rows gathered over ``rows`` (a part of ``axes``) for work split over
    all of ``axes``: the backward sums the gradient over ``axes`` and
    keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh, rows, axes):
        ctx.args = (mesh, rows, axes)
        return all_gather(x, mesh, rows, 0)

    @staticmethod
    def backward(ctx, g):
        mesh, rows, axes = ctx.args
        g = all_reduce(g, mesh, axes)
        return chunk(g, mesh, rows, 0).clone(), None, None, None


class _PsumRows(torch.autograd.Function):
    """The sum over ``axes``, of which this rank keeps its rows over
    ``rows``: the backward gathers every rank's row gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes, rows):
        ctx.args = (mesh, rows)
        return chunk(all_reduce(x, mesh, axes), mesh, rows, 0).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, rows = ctx.args
        return all_gather(g, mesh, rows, 0), None, None, None


class _BmmF32(torch.autograd.Function):
    """``a (E, T, k) @ b (E, k, n)`` of bf16 operands summed and written in
    float32: one batched GEMM on the card, with no float32 copy of ``b``.
    Its backward rounds the float32 cotangent to the operands' dtype once,
    as ``model._UnembedF32``'s does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, summed and written in float32 (the reference's
    ``preferred_element_type=float32``). The CPU has no GEMM with a wider
    output, so there the operands are widened (their products are exact
    in float32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _resident_experts(tokens, gate_local, p: MoE, act) -> torch.Tensor:
    """Every resident expert densely on all ``tokens`` (T, d), weighted by
    ``gate_local`` (T, e_local) and summed over the experts: float32
    (T, d), as the reference's einsums with float32 results."""
    t = tokens.expand(p.w_gate.shape[0], *tokens.shape).contiguous()  # (e, T, d)
    h = act(_bmm_f32(t, p.w_gate)) * _bmm_f32(t, p.w_up)
    y = _bmm_f32(h.to(tokens.dtype), p.w_down)  # (e, T, d)
    return torch.einsum("etd,te->td", y, gate_local)


def _moe_psum(p: MoE, cfg, x, act, mesh, ep_axes, dp_axes, tp_axis):
    """Small-batch EP (decode): the experts stay put and the few tokens
    move. Tokens are gathered over the data part of the EP axes, every
    rank runs its resident experts densely on all of them (no capacity,
    so nothing drops), and a sum over the EP axes combines."""
    m = cfg.moe
    b, s, d = x.shape
    e_local = p.w_gate.shape[0]
    tokens_local = x.reshape(-1, d)
    gather_axes = tuple(a for a in ep_axes if a in dp_axes)
    # Routing is per token, so each rank routes its own rows and the
    # gates travel with them.
    gates, eidx = _route(tokens_local, p.router, m)
    if gather_axes:
        tokens = _GatherRows.apply(tokens_local, mesh, gather_axes, ep_axes)
        gates = _GatherRows.apply(gates, mesh, gather_axes, ep_axes)
        eidx = all_gather(eidx, mesh, gather_axes, 0)
    else:
        tokens = copy_to(tokens_local, mesh, ep_axes)
        gates = copy_to(gates, mesh, ep_axes)
    e0 = mesh.axis_index(ep_axes) * e_local
    mine = torch.arange(e0, e0 + e_local, dtype=eidx.dtype, device=x.device)
    match = (eidx[:, :, None] == mine).to(gates.dtype)
    gate_local = (gates[:, :, None] * match).sum(1)  # (T, e_local)
    out = _resident_experts(tokens, gate_local, p, act).to(x.dtype)
    if gather_axes:
        out = _PsumRows.apply(out, mesh, ep_axes, gather_axes)
    else:
        out = reduce_from(out, mesh, ep_axes)
    if m.num_shared_experts:
        sh = _shared_ffn(copy_to(tokens_local, mesh, tp_axis), *_shared(p), act)
        out = out + reduce_from(sh, mesh, tp_axis)
    return out.reshape(b, s, d)


def _moe_expert_tp(p: MoE, cfg, x, act, mesh, tp_axis):
    """Expert TP: every rank runs every expert over its ``d_ff`` slice,
    with the capacity of all its tokens, and the partial outputs are
    summed over ``tp_axis``."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    cap = _capacity(tokens.shape[0], m, m.num_experts)
    gates, eidx = _route(tokens, p.router, m)
    tin = copy_to(tokens, mesh, tp_axis)
    buf, slot, kept, tok_s, gate_s, order = _dispatch(
        tin, copy_to(gates, mesh, tp_axis), eidx, m, m.num_experts, cap)
    outs = _expert_ffn(buf, p.w_gate, p.w_up, p.w_down, act)  # partial over f
    out = _combine(outs, slot, kept, tok_s, gate_s, tokens.shape[0], x.dtype,
                   order)
    if m.num_shared_experts:
        out = out + _shared_ffn(tin, *_shared(p), act)
    return reduce_from(out, mesh, tp_axis).reshape(b, s, d)


def moe_schedule(cfg, mesh, tokens_per_rank: int, dp_axes=("pod", "data"),
                 tp_axis: str = "model") -> str:
    """The reference's choice (``moe.py:184-201``): ``"a2a"`` when the
    experts divide over the EP axes and this rank's tokens divide over
    ``tp_axis``, else ``"psum"`` when the experts divide over more than
    one rank, else ``"expert_tp"``; ``"local"`` without a mesh or a
    ``tp_axis`` on it."""
    if mesh is None or mesh.empty or tp_axis not in mesh.axis_names:
        return "local"
    m = cfg.moe
    tp = mesh.shape[tp_axis]
    ep_size = mesh.axis_size(_ep_axes(m, mesh, tp_axis))
    if m.num_experts % ep_size == 0 and ep_size > 1:
        if tokens_per_rank % tp == 0 and tokens_per_rank >= tp:
            return "a2a"
        return "psum"
    return "expert_tp"


def moe_ffn(p: MoE, cfg, x: torch.Tensor, act, *, mesh=None,
            dp_axes: tuple[str, ...] = ("pod", "data"),
            tp_axis: str = "model") -> torch.Tensor:
    """The MoE layer: x (B, S, d) -> (B, S, d). Without a mesh (or a
    ``tp_axis`` on it) the single-shard layer. With one, ``x`` is this
    rank's block of the batch, split over those of ``dp_axes`` that the
    mesh has (and replicated over the rest), ``p`` holds this rank's
    blocks under ``lm_family.moe_param_specs``, and the schedule is
    ``moe_schedule``'s; the result is this rank's block."""
    schedule = moe_schedule(cfg, mesh, x.shape[0] * x.shape[1], dp_axes, tp_axis)
    if schedule == "local":
        return moe_ffn_local(p, cfg, x, act)
    ep_axes = _ep_axes(cfg.moe, mesh, tp_axis)
    _check_layout(p, cfg, mesh, ep_axes, tp_axis, schedule)
    if schedule == "a2a":
        return _moe_a2a(p, cfg, x, act, mesh, ep_axes, tp_axis)
    if schedule == "psum":
        dp_axes = tuple(a for a in dp_axes if a in mesh.axis_names)
        return _moe_psum(p, cfg, x, act, mesh, ep_axes, dp_axes, tp_axis)
    return _moe_expert_tp(p, cfg, x, act, mesh, tp_axis)


def _check_layout(p: MoE, cfg, mesh, ep_axes, tp_axis, schedule) -> None:
    m = cfg.moe
    if schedule == "expert_tp":
        want = (m.num_experts, cfg.d_model, m.d_ff_expert // mesh.shape[tp_axis])
    else:
        want = (m.num_experts // mesh.axis_size(ep_axes), cfg.d_model, m.d_ff_expert)
    if tuple(p.w_gate.shape) != want:
        raise ValueError(
            f"the {schedule} schedule needs this rank's w_gate block {want}; "
            f"got {tuple(p.w_gate.shape)} (lay the weights out with "
            "configs/lm_family.py::moe_param_specs)")
