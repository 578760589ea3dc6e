"""AdamW with a configurable moment dtype, the port of
``repro.train.optimizer``.

The state is ``{"step", "m", "v"}``: ``step`` a 0-d int32 tensor, ``m``
and ``v`` trees shaped as the parameters (a module's as the dict of its
parameters) in ``moment_dtype``. The update is the reference's: a global
norm clip, warm-up then cosine decay to 0.1 of the peak, bias-corrected
moments, and weight decay decoupled from the gradient, each leaf
upcast to float32 and cast back to its own dtype. Unlike the
reference, which returns new arrays, ``adamw_update`` writes the
parameters and moments in place (the 4B-parameter config keeps 48 GB
of state on the card, with no room for a second copy) and works through
each leaf in chunks of ``CHUNK`` elements, so its float32 temporaries
stay small. Every number it computes stays on the device: no host
read.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.train.tree import leaves, map_tree, named_leaves

# Elements of a leaf updated at once: float32 temporaries of 256 MB.
CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_opt_state(params, cfg: AdamWConfig) -> dict[str, Any]:
    dt = _dtype(cfg.moment_dtype)
    first = leaves(params)
    device = first[0].device if first else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": map_tree(zeros, params),
        "v": map_tree(zeros, params),
    }


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a float32 tensor)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cosine = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf of ``tree`` together."""
    total = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig, *,
                 grad_norm: torch.Tensor | None = None):
    """Returns ``(params, new_opt_state, metrics)``; ``params`` and the
    moments are updated in place (see the module docstring), ``metrics``
    holds the device tensors ``grad_norm`` and ``lr``. ``grad_norm``, when
    given, is the clip's global norm in place of ``global_norm(grads)``
    (the sharded step's, over every rank's blocks)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    lr = _lr_at(cfg, stepf)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    p_leaves, g_leaves = named_leaves(params), leaves(grads)
    m_leaves, v_leaves = leaves(opt_state["m"]), leaves(opt_state["v"])
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("adamw_update: grads, moments and params differ in leaves")
    for (_, p), g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for at in range(0, pf.numel(), CHUNK):
            sl = slice(at, at + CHUNK)
            g32 = gf[sl].float() * scale
            m32 = b1 * mf[sl].float() + (1 - b1) * g32
            v32 = b2 * vf[sl].float() + (1 - b2) * g32 * g32
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = pf[sl].float()
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
            pf[sl].copy_(p32 - lr * delta)
            mf[sl].copy_(m32)
            vf[sl].copy_(v32)
    new_state = {"step": step, "m": opt_state["m"], "v": opt_state["v"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
