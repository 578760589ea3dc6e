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
einsums outside any Pallas kernel. The sharded schedules (all_to_all
expert parallelism, the small-batch psum, expert tensor parallelism)
and the fp8 dispatch payload wait for ROADMAP queue 1, item 16: a
``mesh=`` raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn

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


def _shared_ffn(x, p: MoE, act):
    h = act(x @ p.w_gate_shared) * (x @ p.w_up_shared)
    return h.to(x.dtype) @ p.w_down_shared


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
        out = out + _shared_ffn(tokens, p, act)
    return out.reshape(b, s, d)


def moe_ffn(p: MoE, cfg, x: torch.Tensor, act, *, mesh=None) -> torch.Tensor:
    """The MoE layer. The port runs on one card: with a ``mesh`` it
    raises (the reference's three shard_map schedules wait for item 16)."""
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch runs the MoE layer on one card: its sharded "
            "schedules (all_to_all expert parallelism, the small-batch "
            "psum, expert tensor parallelism) and the fp8 dispatch wait "
            "for distributed/sharding.py (ROADMAP queue 1, item 16)"
        )
    return moe_ffn_local(p, cfg, x, act)
