"""GPipe-style pipeline parallelism over a mesh axis (usually "pod"): the
port of ``repro/distributed/pipeline.py``.

Stages hold contiguous layer groups; microbatches stream through a ring
of sends and receives. The ring shift is an autograd function whose
backward shifts the gradients the other way, so the same construct
trains.

Schedule: T = num_microbatches + num_stages - 1 ticks. At tick t, stage
s processes microbatch (t - s) when 0 <= t - s < M. Bubble fraction =
(S - 1) / T.

Model-agnostic: it pipelines any ``layer_fn(carry, layer_params) ->
carry`` over a stacked layer tree (dicts and lists of tensors).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import copy_to, reduce_from
from repro_torch.distributed.sharding import tree_map
from repro_torch.train.tree import leaves


def _ring_shift(y: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """``y`` of stage ``s`` arrives at stage ``s + step`` (mod S); no
    autograd."""
    n = mesh.shape[axis]
    if n == 1:
        return y.detach().clone()
    group = mesh.group(axis)
    me = mesh.coords[axis]
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    send = y.detach().contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()
    return recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ring_shift(y, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.mesh, ctx.axis, -1), None, None


class _Tie(torch.autograd.Function):
    """Returns its first input; the backward hands the others zero
    gradients. Every rank ties each ring shift's output (and the copied
    inputs) to the result, so every rank runs every shift's backward
    (and the inputs' sum), in the same order, even where the value went
    unused: the sends of one rank's backward are the receives of its
    neighbours'."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes))


def pipeline_apply(
    layer_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    stage_params: Any,  # this stage's block: leaves (1, layers_per_stage, ...)
    x_microbatches: torch.Tensor,  # (num_microbatches, mb, ...), every stage
    mesh,
    stage_axis: str = "pod",
) -> torch.Tensor:
    """Run the pipeline; returns the (num_microbatches, mb, ...) outputs
    on every stage. ``stage_params`` is this stage's block of the
    ``(num_stages, layers_per_stage, ...)`` stack, as ``shard_tree``
    with spec ``(stage_axis,)`` gives it. The last stage's buffer is
    broadcast by a sum over the axis (every other stage's is zero); the
    inputs' gradient, which only stage 0 computes, is summed over the
    axis, so every stage holds it."""
    num_stages = mesh.shape[stage_axis]
    sid = mesh.coords[stage_axis]
    num_mb = x_microbatches.shape[0]
    params = tree_map(lambda a: a[0], stage_params)
    n_layers = leaves(params)[0].shape[0]
    xs = copy_to(x_microbatches, mesh, stage_axis)
    # The first state requires grad on every stage, so every stage's ring
    # shifts are in its graph (a shift of a value without grad has no
    # backward, and its neighbours would wait for it).
    state = torch.zeros_like(xs[0]).requires_grad_(torch.is_grad_enabled())
    outs = [torch.zeros_like(xs[0]) for _ in range(num_mb)]
    shifted = []

    for t in range(num_mb + num_stages - 1):
        mb = t - sid
        if 0 <= mb < num_mb:
            y = xs[mb] if sid == 0 else state
            for layer in range(n_layers):
                y = layer_fn(y, tree_map(lambda a, i=layer: a[i], params))
            if sid == num_stages - 1:
                outs[mb] = y
        else:
            y = state
        state = _RingShift.apply(y, mesh, stage_axis)
        shifted.append(state)
    out = reduce_from(torch.stack(outs), mesh, stage_axis)
    return _Tie.apply(out, xs, *shifted)

