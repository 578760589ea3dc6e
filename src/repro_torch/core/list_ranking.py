"""Parallel list ranking in PyTorch (paper section 3).

The port of ``repro.core.list_ranking``. Two algorithms, as in the paper:

* ``wylie_rank`` -- Wylie's pointer jumping. O(n log n) work, O(log n)
  steps; two gathers per step in SoA layout, or ONE row gather in AoS
  layout (the paper's 64-bit packing of (rank, last), guideline G5).

* ``random_splitter_rank`` -- Reid-Miller's random splitter algorithm
  (paper Algorithm 1/3), O(n + p log p) work, in five phases:
    RS1/RS2  init + splitter selection (KISS, one stream per lane),
    RS3      lockstep masked sub-list walk (``pram.lockstep_walk``),
    RS4      pointer jumping on the p-node splitter list (the
             ``pointer_jump`` kernel: one block, all steps in shared
             memory),
    RS5      streaming rank aggregation (the ``splitter_aggregate``
             kernel: the splitter table in shared memory).

rank[j] = number of edges from j to the last list element (rank[last] = 0).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.components import ConvergenceError, check_choice
from repro_torch.core.pram import lockstep_walk
from repro_torch.device import as_int32
from repro_torch.kernels.pointer_jump.ops import default_iters, pointer_jump
from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate
from repro_torch.obs import trace
from repro_torch.ops.kiss import KissRng

PACK_MODES = ("aos", "soa", "word64")
# wylie_rank's subset: pointer jumping has no word64-packed variant.
WYLIE_PACK_MODES = ("aos", "soa")
KERNEL_IMPLS = ("auto", "torch", "cuda")


def max_splitters_for_linear_work(n: int) -> int:
    """Largest p with p*log2(p) <= n (paper: keeps total work O(n))."""
    p = max(2, n)
    while p * math.log2(max(p, 2)) > n and p > 2:
        p //= 2
    return p


def wylie_rank(
    succ, *, pack_mode: str = "aos", num_iters: int | None = None,
    device=None,
) -> torch.Tensor:
    """Wylie's pointer jumping: int32 ranks of the list ``succ``."""
    check_choice("pack_mode", pack_mode, WYLIE_PACK_MODES)
    succ = as_int32(succ, device)
    n = succ.shape[0]
    iters = num_iters if num_iters is not None else default_iters(n)
    lane = torch.arange(n, dtype=torch.int32, device=succ.device)
    rank = (succ != lane).to(torch.int32)
    if pack_mode == "soa":
        last = succ
        for _ in range(iters):
            # two independent irregular gathers per step
            rank, last = rank + rank[last], last[last]
        return rank
    packed = torch.stack([rank, succ], dim=-1)
    for _ in range(iters):
        # ONE row gather fetches (rank[last], last[last]) together.
        row = packed[packed[:, 1]]
        packed = torch.stack([packed[:, 0] + row[:, 0], row[:, 1]], dim=-1)
    return packed[:, 0]


@dataclass
class SplitterStats:
    """Observables the paper reports in Tables 2/3."""

    splitters: np.ndarray  # (p,) node ids
    sublist_lengths: np.ndarray  # (p,) walk lengths (= RS4 weights)
    walk_steps: int  # lockstep trip count = max sub-list length
    expected_mean: float  # n / p (Table 3 "Mean")

    def publish(self, registry=None, prefix: str = "rank.splitter") -> None:
        """Publish into the metrics registry (``repro_torch.obs.metrics``)."""
        from repro_torch.obs.metrics import publish_stats

        publish_stats(self, prefix, registry)


def select_splitters(n: int, p: int, seed: int = 0, head: int = 0) -> np.ndarray:
    """RS2: one KISS stream per lane picks a splitter in its n/p block.

    Lane 0's pick is replaced by the list head so every node is covered
    (Reid-Miller's convention; the head starts the first sub-list).
    """
    if p < 1 or p > n:
        raise ValueError(f"need 1 <= p <= n, got p={p} n={n}")
    block = n // p
    rng = KissRng(seed, n_streams=p)
    offs = rng.next_u32().astype(np.int64) % max(block, 1)
    spl = np.minimum(np.arange(p, dtype=np.int64) * block + offs, n - 1)
    spl[0] = head
    # Ensure distinctness (head may collide with lane 0's block anyway).
    spl = np.unique(spl)
    if len(spl) < p:  # refill collisions deterministically
        missing = p - len(spl)
        pool = np.setdiff1d(np.arange(n, dtype=np.int64), spl, assume_unique=True)
        spl = np.concatenate([spl, pool[:missing]])
    return np.sort(spl)


def even_splitters(succ: np.ndarray, p: int, head: int = 0) -> np.ndarray:
    """Perfect splitters for the Table-3 control: every n/p-th list node."""
    n = len(succ)
    order = np.empty(n, dtype=np.int64)
    j = head
    for i in range(n):
        order[i] = j
        j = succ[j]
    return np.sort(order[:: max(n // p, 1)][:p])


def _splitter_list_rank(w_adj, spsucc, iters, impl):
    """RS4: weighted pointer jumping over the p-node splitter list.

    Returns final splitter ranks: rank_sp[s] = edges from s to the last
    list element. Terminal splitters (spsucc == self) carry their
    residual walk length in w_adj."""
    lanes = torch.arange(w_adj.shape[0], dtype=torch.int32, device=w_adj.device)
    is_term = spsucc == lanes
    r, nxt = pointer_jump(
        spsucc, torch.where(is_term, 0, w_adj), iters=iters, impl=impl
    )
    # nxt now points at each chain's terminal; add its residual once.
    return r + w_adj[nxt]


def _walk_fns(succ, is_stop, lanes, pack_mode, valid=None):
    """RS3 active/step functions. The store buffers have one extra row,
    index ``n``, where inactive lanes write (the drop lane); they are
    updated in place, since the walk owns them. ``valid`` masks padded
    lanes inert (the sharded engine's)."""
    n = succ.shape[0]

    def active_fn(st):
        act = ~is_stop[st["nxt"]] & (st["nxt"] != st["cur"])
        return act if valid is None else act & valid

    def step_fn(st, active):
        nxt, cur, dist = st["nxt"], st["cur"], st["dist"]
        tgt = torch.where(active, nxt, n).long()  # drop lane n: branch-free
        if pack_mode == "soa":
            owner, local = st["store"]
            owner.index_copy_(0, tgt, lanes)
            local.index_copy_(0, tgt, dist)
        else:
            (packed,) = st["store"]
            packed.index_copy_(0, tgt, torch.stack([dist, lanes], dim=-1))
        return dict(
            store=st["store"],
            cur=torch.where(active, nxt, cur),
            nxt=torch.where(active, succ[nxt], nxt),
            dist=dist + active.to(torch.int32),
        )

    return active_fn, step_fn


def aos_walk_fns(succ, is_stop, lanes, valid=None):
    """RS3's active/step functions over the AoS ``[local, owner]`` store
    (``n + 1`` rows, the last the drop row). Shared by the single-device
    core and the sharded engine, which passes offset global lane ids and
    a ``valid`` mask for padded lanes, so the two walk the same way."""
    return _walk_fns(succ, is_stop, lanes, "aos", valid)


def _random_splitter_core(succ, splitters, *, pack_mode="aos",
                          max_steps=None, kernel_impl="auto"):
    """RS1..RS5 on ``succ``'s device. Returns ``(rank, sublist_lengths,
    walk_steps, converged)``."""
    n = succ.shape[0]
    p = splitters.shape[0]
    dev = succ.device
    lanes = torch.arange(p, dtype=torch.int32, device=dev)
    spl = splitters.long()

    is_stop = torch.zeros(n, dtype=torch.bool, device=dev)
    is_stop[spl] = True
    if pack_mode == "soa":
        owner = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        owner[spl] = lanes
        store = (owner, torch.zeros(n + 1, dtype=torch.int32, device=dev))
    else:
        # AoS rows [local_rank, owner].
        packed = torch.full((n + 1, 2), -1, dtype=torch.int32, device=dev)
        packed[:, 0] = 0
        packed[spl, 1] = lanes
        store = (packed,)

    # --- RS3: lockstep masked walk --------------------------------------
    state = dict(
        store=store,
        cur=splitters,
        nxt=succ[spl],
        dist=torch.ones(p, dtype=torch.int32, device=dev),
    )
    active_fn, step_fn = _walk_fns(succ, is_stop, lanes, pack_mode)
    with trace.span("rank.splitter.walk", device=True, p=p) as sp:
        final, steps, converged = lockstep_walk(
            state, active_fn, step_fn, max_steps=max_steps
        )
        sp.block_on(final["dist"])
        sp.tag(steps=steps)
    if pack_mode == "soa":
        owner, local = (x[:n] for x in final["store"])
        rows = torch.stack([local, owner], dim=-1)
    else:
        rows = final["store"][0][:n]
        owner = rows[:, 1]

    # --- RS4: rank the splitter linked list ------------------------------
    spsucc = owner[final["nxt"]]
    is_term = spsucc == lanes
    w_adj = final["dist"] - is_term.to(torch.int32)
    rank_sp = _splitter_list_rank(w_adj, spsucc, default_iters(p), kernel_impl)

    # --- RS5: streaming aggregation over the [local, owner] rows ---------
    rank = splitter_aggregate(rows, rank_sp, impl=kernel_impl)
    return rank, final["dist"], steps, converged


def random_splitter_rank(
    succ,
    num_splitters: int | None = None,
    *,
    splitters: np.ndarray | None = None,
    head: int = 0,
    seed: int = 0,
    pack_mode: str = "aos",
    max_steps: int | None = None,
    kernel_impl: str = "auto",
    with_stats: bool = False,
    device=None,
):
    """Rank a linked list with Reid-Miller's random splitter algorithm.

    ``kernel_impl`` picks RS4/RS5's implementation: ``"auto"`` (the
    CUDA kernels for tensors on the card, their plain versions on the
    CPU), ``"cuda"`` or ``"torch"``. If ``max_steps`` cuts the lockstep
    walk off before every lane reaches its splitter, the ranks would be
    wrong, so this raises ``ConvergenceError`` instead. Host inputs go
    to ``device`` (default: the CUDA card); a tensor stays where it is.
    """
    check_choice("pack_mode", pack_mode, PACK_MODES)
    check_choice("kernel_impl", kernel_impl, KERNEL_IMPLS)
    if pack_mode == "word64":
        # word64 packs [local, owner] into one 8-byte word: exactly the
        # (n, 2) int32 rows of aos, so it is aos by another name.
        pack_mode = "aos"
    succ = as_int32(succ, device)
    n = succ.shape[0]
    if splitters is None:
        p = num_splitters or min(4096, max_splitters_for_linear_work(n))
        p = min(p, n)
        splitters = select_splitters(n, p, seed=seed, head=head)
    splitters = np.asarray(splitters)
    with trace.span("rank.splitter", device=True, n=n) as sp:
        rank, sublens, steps, converged = _random_splitter_core(
            succ, as_int32(splitters, succ.device), pack_mode=pack_mode,
            max_steps=max_steps, kernel_impl=kernel_impl,
        )
        sp.block_on(rank)
    if not converged:
        raise ConvergenceError(
            f"random_splitter_rank walk hit max_steps={max_steps} "
            "with lanes still active; ranks would be truncated -- "
            "raise max_steps or add splitters"
        )
    if not with_stats:
        return rank
    stats = SplitterStats(
        splitters=splitters,
        sublist_lengths=sublens.cpu().numpy(),
        walk_steps=steps,
        expected_mean=n / len(splitters),
    )
    return rank, stats
