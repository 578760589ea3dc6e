"""PRAM -> accelerator adaptation utilities (paper section 2), in PyTorch.

The port of ``repro.core.pram``:

* G1 striding vs partitioning: the two canonical assignments of N data
  items to p lanes, as index matrices and reshaping views.
* G3 branch-freedom: ``lockstep_walk``, the masked loop that executes
  divergent per-lane walks SIMD-style until the slowest lane finishes.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

# How many walk steps run between two reads of "is any lane still
# active?". A step with no active lane changes nothing (the step
# functions mask every update), so running past the end is harmless;
# the exact step count is counted on the device.
WALK_CHECK_EVERY = 32


def striding_indices(n: int, p: int, device=None) -> torch.Tensor:
    """(steps, p) index matrix: lane i touches A[i + s*p] at step s.
    Requires p | n (pad first otherwise)."""
    if n % p:
        raise ValueError(f"striding requires p|n, got n={n} p={p}")
    return torch.arange(n, dtype=torch.int32, device=device).reshape(n // p, p)


def partitioning_indices(n: int, p: int, device=None) -> torch.Tensor:
    """(steps, p) index matrix: lane i touches A[i*(n/p) + s] at step s."""
    if n % p:
        raise ValueError(f"partitioning requires p|n, got n={n} p={p}")
    return (
        torch.arange(p, dtype=torch.int32, device=device)[None, :] * (n // p)
        + torch.arange(n // p, dtype=torch.int32, device=device)[:, None]
    )


def strided_view(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reshape (n,) -> (steps, p) so that row s holds step-s lane values."""
    return x.reshape(-1, p)


def partitioned_view(x: torch.Tensor, p: int) -> torch.Tensor:
    return x.reshape(p, -1).T


def lockstep_walk(
    state: Any,
    active_fn: Callable[[Any], torch.Tensor],
    step_fn: Callable[[Any, torch.Tensor], Any],
    max_steps: int | None = None,
) -> tuple[Any, int, bool]:
    """Run per-lane walks in SIMD lockstep until every lane is done.

    ``active_fn(state)`` gives the (p,) bool mask of lanes still
    walking; ``step_fn(state, active)`` must mask every update with
    ``active`` (guideline G3), so a step with no active lane leaves the
    state as it is.

    Returns ``(final_state, steps_taken, converged)``: ``steps_taken``
    is the number of steps in which some lane was active (the maximum
    lane walk length, capped at ``max_steps``), exactly the trip count
    of the reference's ``lax.while_loop``; ``converged`` is False iff
    ``max_steps`` cut lanes off mid-walk. The host reads the step count
    once every ``WALK_CHECK_EVERY`` steps instead of once per step.
    """
    steps = None
    done = 0
    while max_steps is None or done < max_steps:
        chunk = WALK_CHECK_EVERY
        if max_steps is not None:
            chunk = min(chunk, max_steps - done)
        for _ in range(chunk):
            active = active_fn(state)
            any_active = active.any().to(torch.int64)
            steps = any_active if steps is None else steps + any_active
            state = step_fn(state, active)
        done += chunk
        if int(steps) < done:  # some step found no active lane: finished
            break
    converged = not bool(active_fn(state).any())
    return state, 0 if steps is None else int(steps), converged
