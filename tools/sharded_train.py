#!/usr/bin/env python3
"""Sharded training of the port over NCCL with one rank on each CUDA card
of one host.

    python3 tools/sharded_train.py [P]          # P ranks (default: every card)
    python3 tools/sharded_train.py 4 --cpu      # four gloo ranks on the CPU

Spawns P ranks (P even), rank r on card r, joined by an NCCL group whose
rendezvous is a ``FileStore`` in a temporary directory (no network), on
a ``(P / 2, 2)`` ``("data", "model")`` mesh. Every rank builds
``chip_smoke.py``'s phase 18 (a) model (deepseek-v3 at full width: its 3
dense layers, one MoE layer of all 256 experts, the MTP layer; bf16) with
its experts over ``("data", "model")``, at B=2, S=512. The capacity
factor is read off this batch's routing (a meshless forward, the expert
ids of every token): 1.25 times what the fullest expert needs, over the
whole batch and over each rank's chunk, at most experts / top_k, so no
chunk drops a token and the sharded and meshless routes compute one
function. A spy on ``_dispatch`` checks that nothing dropped. Random
weights route unevenly (at S=1024 the fullest expert took 582 of 2,048
tokens, 378 of a chunk's 512), so the capacity is close to every token.

Oracles (every rank compares its own blocks; the sums of squares are
added over the ranks, so no rank gathers a whole gradient):

* the meshless bf16 step on each rank's card, each gradient's block
  moved to the host as the backward writes it (the weights, 31.4 GB,
  and the activations at that capacity leave no room for a whole
  gradient set; its time includes those copies), and
* the float32 step on the mesh (the same bf16 weights widened; the
  attention on its plain route, as the kernel has no float32 instance
  for MLA's head dims): the meshless float32 step does not fit one card
  at 256 experts (62.6 GB of weights and as much of gradients). The
  CPU tests hold the float32 sharded step to the reference's meshless
  gradients at 2e-3.

Checks: the meshless bf16 step's distance in norm from the float32 step
is at most ``PLAIN_MAX`` for every leaf (a fault that the float32 and
bf16 sharded steps shared would show here), and each sharded bf16 step
is at most ``TOL`` further from it than the meshless bf16 step, leaf by
leaf, and ``FP8_TOL`` with the fp8 dispatch payload. A bf16 step is a
rounding of the float32 one, and sharding reorders the roundings: the
router's gradient, a softmax's (``p_i (u_i - sum_j p_j u_j)``), cancels,
and two valid bf16 orders of it lie several per cent apart. The fp8
payload's backward is straight-through (``moe._Fp8Exchange``), where the
reference differentiates the casts. Both bf16 steps are timed on the
host clock after a warm-up, the cards synchronised.

A decode: ``prefill(mesh=)`` of 8 tokens at B=2 (``serve_step``, the MoE
layer on the small-batch psum schedule) against the meshless prefill,
the last logits within ``TOL`` in norm; timed with the psum schedule's
expert products on their float32-output GEMMs
(``moe._resident_experts``) and on their plain version, the weights
widened to float32 on each call, in the order new, plain, plain, new.

The schedules that ran are read by spies on ``moe.py``'s schedule
functions. Rank 0 prints; every line carries the card's name and power
limit. ``--cpu`` runs the same on gloo ranks at the deepseek-v3 smoke
config (a dry run of this script's collectives).
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300  # a collective that waits longer raises
TOL = 3e-2
# the meshless bf16 step's largest distance from the float32 step, the
# router's on NVIDIA H100 80GB HBM3 at 700 W: 0.066 with 32 experts at
# S=1024, 0.1305 with 256 at S=512; a fault is O(1)
PLAIN_MAX = 0.15
# with the fp8 payload: e4m3 keeps 3 mantissa bits, so each dispatched
# value moves by up to 2^-4 of itself, and the leaves that read the
# payload (the expert bank, the router) inherit up to that
FP8_TOL = TOL + 2 ** -4
S = {"cuda": 512, "cpu": 16}  # the meshless step's activations at ~every-token capacity
CAPACITY_MARGIN = 1.25
DECODE_TOKENS = 8


def _cfg(cs, cpu: bool, fp8: bool = False, capacity_factor=None):
    from repro_torch.configs import get_arch

    if cpu:
        cfg = dataclasses.replace(get_arch("deepseek-v3-671b").smoke_config,
                                  dtype="bfloat16")
    else:
        cfg = cs.sharded_lm_cfg()
    moe = dataclasses.replace(cfg.moe, ep_axes=("data", "model"),
                              a2a_dtype="float8_e4m3fn" if fp8 else None)
    if capacity_factor is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
    return dataclasses.replace(cfg, moe=moe)


def _spied(moe, ran, kept):
    """Spies on the schedules (their names into ``ran``) and on
    ``_dispatch`` (whether it kept every token, into ``kept``); returns
    the originals."""
    names = ("_moe_a2a", "_moe_psum", "_moe_expert_tp", "_dispatch")
    saved = {s: getattr(moe, s) for s in names}

    def spy(name):
        def call(*a, **k):
            out = saved[name](*a, **k)
            if name == "_dispatch":
                kept.append(bool(out[2].all()))
            else:
                ran.add(name)
            return out
        return call

    for name in names:
        setattr(moe, name, spy(name))
    return saved


def _restore(moe, saved):
    for name, fn in saved.items():
        setattr(moe, name, fn)


def _capacity_factor(params, cfg, tokens, chunks: int) -> tuple:
    """(the capacity factor at which neither the whole batch nor any of
    ``chunks`` equal runs of its tokens drops one, times
    ``CAPACITY_MARGIN`` and at most experts / top_k; the loads it read)."""
    import torch

    from repro_torch.models.transformer import forward, moe

    m = cfg.moe
    got = []
    saved = moe._route

    def spy(*a, **k):
        out = saved(*a, **k)
        got.append(out[1])
        return out

    moe._route = spy
    try:
        with torch.no_grad():
            forward(params, cfg, tokens)
    finally:
        moe._route = saved
    t = got[0].shape[0]
    load = lambda ids: int(torch.bincount(  # noqa: E731
        ids.long().reshape(-1), minlength=m.num_experts).max())
    full = max(load(eidx) for eidx in got)  # each MoE layer's routing
    part = max(load(c) for eidx in got for c in eidx.chunk(chunks))
    need = max(full / (t * m.top_k / m.num_experts),
               part / (t // chunks * m.top_k / m.num_experts))
    cf = min(need * CAPACITY_MARGIN, m.num_experts / m.top_k)
    return max(cf, m.capacity_factor), {"batch": full, "chunk": part}


def _meshless_step(params, cfg, batch, specs, mesh) -> tuple:
    """The meshless bf16 step: (loss, {name: this rank's block of its
    gradient, on the host}). Each gradient is cut to its block and moved
    to the host as soon as the backward has written it, and dropped from
    the card."""
    from repro_torch.distributed.sharding import shard_tensor
    from repro_torch.models.transformer import loss_fn

    out, hooks = {}, []
    for name, p in params.named_parameters():
        def take(p, name=name):
            out[name] = shard_tensor(p.grad, specs.get(name, ()), mesh).cpu()
            p.grad = None
        hooks.append(p.register_post_accumulate_grad_hook(take))
    try:
        loss = loss_fn(params, cfg, batch)
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return loss.detach(), out


def _distances(got: dict, want: dict, mesh) -> dict:
    """Per leaf, ``|got - want| / |want|`` over the whole tensors, from
    each rank's blocks: the sums of squares added over the ranks (every
    element sits on the same number of ranks, so the ratio is the whole
    tensor's)."""
    import torch
    import torch.distributed as dist

    names = sorted(want)
    sums = torch.zeros(len(names), 2, dtype=torch.float64, device=mesh.device)
    for i, n in enumerate(names):
        w = want[n].to(mesh.device).float()
        g = got[n].to(mesh.device).float()
        sums[i, 0] = (g - w).square().sum(dtype=torch.float64)
        sums[i, 1] = w.square().sum(dtype=torch.float64)
        del w, g
    dist.all_reduce(sums)
    err = (sums[:, 0] / sums[:, 1].clamp_min(1e-60)).sqrt().tolist()
    return dict(zip(names, err))


def _norm_err(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _rank(rank: int, size: int, store_dir: str, card: str, cpu: bool) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs.lm_family import lm_param_specs
    from repro_torch.data.lm import lm_batch
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params, moe, prefill
    from repro_torch.train.tree import trainable

    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    store = dist.FileStore(f"{store_dir}/store", size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    say = print if rank == 0 else (lambda *a, **k: None)
    gb = lambda tree: sum(t.numel() * t.element_size() for t in tree) / 1e9  # noqa: E731
    try:
        mesh = make_test_mesh((size // 2, 2), device=dev)
        s = S[dev.type]
        cfg0 = _cfg(cs, cpu)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in lm_batch(2, s, cfg0.vocab_size, seed=6).items()}
        params = trainable(init_params(cfg0, device=dev,
                                       generator=torch.Generator(dev).manual_seed(0)))
        cf, loads = _capacity_factor(params, cfg0, batch["tokens"], size)
        cfg = _cfg(cs, cpu, capacity_factor=cf)
        say(f"sharded_train {cfg.name} {cfg.moe.num_experts} experts mesh "
            f"{tuple(mesh.shape.values())} B=2 S={s}: largest expert load {loads['batch']} "
            f"tokens over the batch, {loads['chunk']} in a chunk of {2 * s // size}; "
            f"capacity factor {cf} [{card}]", flush=True)
        specs = lm_param_specs(params, cfg, mesh)
        tokens = batch["tokens"][:, :DECODE_TOKENS]
        ran, kept = set(), []
        saved = _spied(moe, ran, kept)
        try:
            with torch.no_grad():
                want_logits, _ = prefill(params, cfg, tokens, 2 * DECODE_TOKENS)
            _meshless_step(params, cfg, batch, specs, mesh)  # warm-up
            kept.clear()
            (loss_r, ref), plain_s = cs.timed_call(
                lambda: _meshless_step(params, cfg, batch, specs, mesh))
        finally:
            _restore(moe, saved)
        cs.check(kept and all(kept), f"the meshless step dropped no token: {kept}")
        full_gb = gb(list(params.parameters()))
        sharded = shard_tree(params, specs, mesh)
        del params
        if not cpu:
            torch.cuda.empty_cache()
        say(f"sharded_train weights {full_gb} GB whole, {gb(list(sharded.parameters()))} "
            f"GB on each rank [{card}]", flush=True)

        # the float32 step on the mesh, every leaf's block on the host
        wide = copy.deepcopy(sharded).float()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        with cs.attention_on_plain_route():
            _, g32 = cs.lm_grads(wide, cfg32, batch, mesh, specs)
        exact = {n: g.detach().cpu() for n, g in g32.items()}
        del wide, g32
        if not cpu:
            torch.cuda.empty_cache()
        d_plain = _distances(ref, exact, mesh)
        worst_plain = max(d_plain, key=d_plain.get)
        cs.check(d_plain[worst_plain] <= PLAIN_MAX,
                 f"the meshless bf16 step within {PLAIN_MAX} of the float32 step on the "
                 f"mesh ({worst_plain}: {d_plain[worst_plain]})")

        for fp8 in (False, True):
            cfg_q = _cfg(cs, cpu, fp8, cf)
            ran.clear()
            saved = _spied(moe, ran, kept)
            try:
                cs.lm_grads(sharded, cfg_q, batch, mesh, specs)  # warm-up
                dist.barrier()
                kept.clear()
                (loss_m, grads_m), mesh_s = cs.timed_call(
                    lambda: cs.lm_grads(sharded, cfg_q, batch, mesh, specs))
                dist.barrier()
            finally:
                _restore(moe, saved)
            d_mesh = _distances(grads_m, exact, mesh)
            apart = _distances(grads_m, ref, mesh)
            excess = {n: d_mesh[n] - d_plain[n] for n in exact}
            worst = max(excess, key=excess.get)
            far = max(apart, key=apart.get)
            loss_err = abs(float(loss_m) - float(loss_r)) / abs(float(loss_r))
            cs.check(ran == {"_moe_a2a"}, f"the step ran the all_to_all schedule: {ran}")
            cs.check(kept and all(kept), f"no chunk dropped a token: {kept}")
            cs.check(loss_err <= TOL, f"loss within {TOL} ({loss_err})")
            tol = FP8_TOL if fp8 else TOL
            cs.check(excess[worst] <= tol,
                     f"fp8 dispatch={fp8}: {worst}: {d_mesh[worst]} from the float32 step, "
                     f"the meshless route {d_plain[worst]}: more than {tol} further")
            say(f"sharded_train {cfg.name} {cfg.moe.num_experts} experts mesh "
                f"{tuple(mesh.shape.values())} B=2 S={s} fp8 dispatch={fp8}: loss "
                f"mesh={float(loss_m)} meshless={float(loss_r)} rel_err={loss_err}; "
                f"{len(exact)} leaves, in norm from the float32 step's: the sharded route "
                f"worst {max(d_mesh.values())}, the meshless route worst "
                f"{d_plain[worst_plain]} ({worst_plain}), the largest excess "
                f"{excess[worst]} ({worst}: {d_mesh[worst]} against {d_plain[worst]}; "
                f"limit {tol}); "
                f"sharded against meshless: worst {apart[far]} ({far}), median "
                f"{sorted(apart.values())[len(apart) // 2]}; schedules {sorted(ran)}; "
                f"step mesh_s={mesh_s} meshless_s={plain_s} (with its gradients' copies to "
                f"the host) [{card}]", flush=True)
            del grads_m
            for p in sharded.parameters():
                p.grad = None
            if not cpu:
                torch.cuda.empty_cache()

        rows = tokens.shape[0] // 2  # the batch of 2 over "data"
        new, plain = moe._resident_experts, cs.resident_experts_widened
        times, errs = {"new": [], "plain": []}, []
        ran.clear()
        saved = _spied(moe, ran, kept)
        try:
            with torch.no_grad():
                for route in ("new", "plain", "new", "plain", "plain", "new"):
                    moe._resident_experts = new if route == "new" else plain
                    dist.barrier()
                    (got, cache), secs = cs.timed_call(
                        lambda: prefill(sharded, cfg, tokens, 2 * DECODE_TOKENS, mesh=mesh))
                    times[route].append(secs)
                    block = mesh.axis_index(cache.batch_axes) if cache.batch_axes else 0
                    errs.append(_norm_err(
                        got, want_logits[block * rows:(block + 1) * rows]))
        finally:
            moe._resident_experts = new
            _restore(moe, saved)
        cs.check(ran == {"_moe_psum"}, f"the decode ran the psum schedule: {ran}")
        cs.check(max(errs) <= TOL, f"decode logits within {TOL} in norm ({errs})")
        say(f"sharded_train decode {cfg.name} mesh {tuple(mesh.shape.values())} B=2, "
            f"{DECODE_TOKENS} tokens through serve_step (psum schedule): logits in norm "
            f"worst {max(errs)}; prefill_s, after a warm-up of each, in the order new, "
            f"plain, plain, new: float32-output GEMMs {times['new'][1:]}, weights widened "
            f"{times['plain'][1:]} [{card}]", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import multiprocessing as mp

    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("sharded_train: CUDA is not available (--cpu runs gloo ranks)",
              file=sys.stderr)
        return 2
    size = int(args[0]) if args else torch.cuda.device_count()
    if size % 2:
        print(f"sharded_train: {size} ranks do not make a (P / 2, 2) mesh", file=sys.stderr)
        return 2
    card = "cpu" if cpu else cs.card_line().replace("\n", "; ")
    # the ranks' allocators map what they free back into one range
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    print(f"card: {card} ranks={size}")
    if not cpu:
        from repro_torch.kernels import build

        build.build(("flash_attention", "flash_attention_bwd", "segment_sum"))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as store_dir:
        procs = [ctx.Process(target=_rank, args=(r, size, store_dir, card, cpu))
                 for r in range(size)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=4 * TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    print(f"rank exit codes: {codes}")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
