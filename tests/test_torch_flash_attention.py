"""The port's flash_attention wrapper on the CPU, where it runs its plain
PyTorch version: against ``repro``'s ``attention_ref`` and its Pallas
kernel (interpret mode) on the ``test_flash_attention_sweep`` grid, on
ragged and unequal lengths, and the wrapper contract; the plain log-sum-exp
against ``jax.nn.logsumexp`` of the reference's scores; the backward's
designs and its second pass's schedule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref,
)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models.transformer.convert import to_tensor  # noqa: E402

# The tolerances of tests/test_kernels.py between a kernel and its oracle.
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _qkv(seed, b, hq, hkv, sq, sk, d, dtype):
    r = np.random.default_rng(seed)
    jt = jnp.dtype(dtype)
    q = jnp.asarray(r.normal(size=(b, hq, sq, d)), jt)
    k = jnp.asarray(r.normal(size=(b, hkv, sk, d)), jt)
    v = jnp.asarray(r.normal(size=(b, hkv, sk, d)), jt)
    return (q, k, v), tuple(to_tensor(np.asarray(x)) for x in (q, k, v))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
def test_flash_attention_sweep_matches_reference_and_pallas(
    hq, hkv, causal, window, dtype
):
    (jq, jk, jv), (q, k, v) = _qkv(hq * 10 + hkv, 2, hq, hkv, 128, 128, 32, dtype)
    before = dict(launch_counts)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert launch_counts == before, "no launch for CPU tensors"
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal, window=window), dtype)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                 impl="pallas", block_q=64, block_k=64)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 16)])
def test_ragged_length_matches_reference(causal, window, dtype):
    # S = 100 is not a multiple of any block: the Pallas path pads keys
    # it does not mask when causal=False (ROADMAP queue 3), so the port
    # is held to attention_ref only.
    (jq, jk, jv), (q, k, v) = _qkv(100, 1, 4, 2, 100, 100, 32, dtype)
    got = flash_attention(q, k, v, causal=causal, window=window)
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("sq,sk", [(50, 100), (100, 50)])
@pytest.mark.parametrize("causal", [False, True])
def test_unequal_lengths_match_reference(sq, sk, causal):
    (jq, jk, jv), (q, k, v) = _qkv(sq + sk, 2, 4, 1, sq, sk, 16, "float32")
    got = flash_attention(q, k, v, causal=causal)
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal), "float32")


def test_fully_masked_rows_are_the_mean_of_v():
    # q_offset=-2 leaves rows 0 and 1 without a live key: both packages
    # give them equal weights on every key, i.e. the mean of v.
    (jq, jk, jv), (q, k, v) = _qkv(7, 1, 2, 2, 16, 16, 16, "float32")
    got = attention_ref(q, k, v, causal=True, q_offset=-2)
    want = np.asarray(jax_attention_ref(jq, jk, jv, causal=True, q_offset=-2))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    mean_v = v.mean(dim=2)
    np.testing.assert_allclose(got[:, :, 0].numpy(), mean_v.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, :, 1].numpy(), mean_v.numpy(), rtol=1e-5, atol=1e-6)


def test_impl_contract_on_cpu_tensors():
    _, (q, k, v) = _qkv(0, 1, 2, 1, 8, 8, 16, "float32")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="window must be >= 1"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="Hq a multiple of Hkv"):
        flash_attention(q[:, :1], torch.cat([k, k], dim=1), torch.cat([v, v], dim=1))
    np.testing.assert_array_equal(
        flash_attention(q, k, v, impl="torch").numpy(),
        attention_ref(q, k, v).numpy(),
    )


# --- the kernel's tile schedule, transposed views, validation -------------

from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    BLOCK_Q,
    block_k,
    check_kernel_inputs,
    kv_tile_plan,
    tma_strides,
)

_LENGTHS = (1, 127, 128, 129, 300)


def _live(sq, sk, causal, window):
    """attention_ref's mask: True where (q, k) scores."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= q >= k
    if window is not None:
        keep &= (q - k) < window
    return keep


@pytest.mark.parametrize("bq,bk", [(BLOCK_Q, block_k(128)), (BLOCK_Q, block_k(256)), (64, 32)])
@pytest.mark.parametrize("window", [None, 1, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_tile_plan_covers_the_mask(causal, window, bq, bk):
    for sq in _LENGTHS:
        for sk in _LENGTHS:
            live = _live(sq, sk, causal, window)
            plan = kv_tile_plan(sq, sk, causal, window, bq, bk)
            n_k = -(-sk // bk)
            assert len(plan) == -(-sq // bq)
            for t, tiles in enumerate(plan):
                rows = live[t * bq:(t + 1) * bq]
                visited = [j for j, _ in tiles]
                # The kernel's order: from the last tile down, each once.
                assert visited == sorted(visited, reverse=True)
                assert len(set(visited)) == len(visited)
                assert all(0 <= j < n_k for j in visited)
                for j in range(n_k):
                    block = rows[:, j * bk:(j + 1) * bk]
                    if j not in visited:
                        # Skipped: wholly masked, and no row lacks a live key.
                        assert not block.any(), (sq, sk, t, j)
                        assert rows.any(axis=1).all(), (sq, sk, t, j)
                for j, needs_mask in tiles:
                    if not needs_mask:
                        # Run without a mask: every score live, below Sk.
                        assert (j + 1) * bk <= sk, (sq, sk, t, j)
                        assert rows[:, j * bk:(j + 1) * bk].all(), (sq, sk, t, j)
                if not rows.any(axis=1).all():
                    # A row with no live key weighs every key: all visited.
                    assert sorted(visited) == list(range(n_k)), (sq, sk, t)


def test_kv_tile_plan_prefill_shape():
    # Causal S=4096 in 128 x 128 tiles: query tile t visits tiles t..0,
    # and only the diagonal one takes the mask.
    plan = kv_tile_plan(4096, 4096, True, None, BLOCK_Q, block_k(128))
    assert len(plan) == 32
    for t, tiles in enumerate(plan):
        assert tiles == [(t, True)] + [(j, False) for j in range(t - 1, -1, -1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transposed_views_match_contiguous_inputs(dtype):
    # The model passes (B, S, H, D) tensors transposed to (B, H, S, D).
    r = np.random.default_rng(3)
    tt = getattr(torch, dtype)
    qs, ks, vs = (torch.from_numpy(r.normal(size=(2, 40, h, 32)).astype(np.float32)).to(tt)
                  for h in (4, 2, 2))
    views = [x.transpose(1, 2) for x in (qs, ks, vs)]
    assert not views[0].is_contiguous()
    dense = [x.contiguous() for x in views]
    for causal, window in ((True, None), (False, None), (True, 8)):
        got = flash_attention(*views, causal=causal, window=window)
        want = flash_attention(*dense, causal=causal, window=window)
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def test_tma_strides_take_the_model_views_without_a_copy():
    x = torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16)  # (B, S, H, D)
    assert tma_strides(x.transpose(1, 2)) == (64 * 8 * 128, 128, 8 * 128)
    assert tma_strides(x[:1].transpose(1, 2)) == (8, 128, 8 * 128)  # B = 1
    # A last stride other than 1, a stride off 16 bytes, an address off 16
    # bytes: the wrapper copies these.
    assert tma_strides(x.transpose(1, 3)) is None
    assert tma_strides(torch.zeros(1, 2, 5, 12, dtype=torch.bfloat16)[..., :8]) is None
    n = 2 * 8 * 64 * 128
    flat = torch.zeros(n + 64, dtype=torch.bfloat16)
    assert tma_strides(flat[4:4 + n].reshape(2, 8, 64, 128)) is None  # 8 bytes in
    assert tma_strides(flat[8:8 + n].reshape(2, 8, 64, 128)) == (8 * 64 * 128, 64 * 128, 128)


def test_kernel_validation_raises_where_it_did():
    def t(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    q, k = t((1, 4, 8, 64)), t((1, 2, 8, 64))
    check_kernel_inputs(q, k, k)  # accepted
    check_kernel_inputs(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="no instance for head_dim 48"):
        check_kernel_inputs(t((1, 4, 8, 48)), t((1, 2, 8, 48)), t((1, 2, 8, 48)))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        check_kernel_inputs(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        check_kernel_inputs(q, k.float(), k)
    # The bf16 grid is one-dimensional (block_order): its limit is on
    # B*Hq*ceil(Sq/128), no longer on the query tiles alone.
    tall = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(1, 1, 65_535 * 128 + 1, 64)
    check_kernel_inputs(tall, k, k)  # accepted
    big = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(1, 2**14, 2**17 * 128 + 1, 64)
    with pytest.raises(ValueError, match="B\\*Hq\\*ceil\\(Sq/128\\) < 2\\*\\*31"):
        check_kernel_inputs(big, k, k)
    wide = torch.zeros(1, 1, 1, 64).expand(1, 65_536, 8, 64)
    with pytest.raises(ValueError, match="B\\*Hq <= 65535"):
        check_kernel_inputs(wide, k.float()[:, :1], k.float()[:, :1])
    with pytest.raises(ValueError, match="same batch and head_dim"):
        flash_attention(q, k[..., :32], k[..., :32])


class _Built(Exception):
    """Raised by the patched ``build.function``: the wrapper got as far
    as building its kernel."""


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_kernel_route_refuses_inputs_that_require_grad(monkeypatch, which):
    # (The name is kept from the slices before the backward kernel, when
    # this route raised.) The kernel route (forced by the patch) on an
    # input that requires grad goes through the autograd Function: its
    # forward launch and, in the backward, the backward kernel's, both
    # patched to their plain versions here; the gradient is
    # attention_vjp_ref's. The Function hands the forward a log-sum-exp to
    # write (under no_grad none) and the backward the same tensor, filled.
    # Under no_grad the same call is one forward launch with no grad_fn.
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref, attention_vjp_ref

    monkeypatch.setattr(ops, "resolve_impl", lambda impl, x: "cuda")
    calls, handed = [], []

    def fwd(q, k, v, causal, window, lse=None):
        calls.append("fwd")
        handed.append(lse)
        with torch.no_grad():
            if lse is not None:
                assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
                lse.copy_(attention_lse_ref(q, k, causal=causal, window=window))
            return attention_ref(q, k, v, causal=causal, window=window)

    def bwd(q, k, v, out, dout, lse, causal, window):
        calls.append("bwd")
        assert lse is handed[0]
        torch.testing.assert_close(
            lse, attention_lse_ref(q, k, causal=causal, window=window), rtol=0, atol=0)
        return attention_vjp_ref(q, k, v, dout, causal=causal, window=window)

    monkeypatch.setattr(ops, "_forward_kernel", fwd)
    monkeypatch.setattr(ops, "_backward_kernel", bwd)
    _, (q, k, v) = _qkv(0, 1, 4, 2, 16, 16, 16, "float32")
    inputs = {"q": q, "k": k, "v": v}
    inputs[which] = inputs[which].clone().requires_grad_()
    out = flash_attention(inputs["q"], inputs["k"], inputs["v"], window=5)
    assert out.grad_fn is not None and calls == ["fwd"]
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(dout)
    assert calls == ["fwd", "bwd"]
    want = attention_vjp_ref(q, k, v, dout, window=5)["qkv".index(which)]
    torch.testing.assert_close(inputs[which].grad, want, rtol=0, atol=0)
    with torch.no_grad():
        plain = flash_attention(inputs["q"], inputs["k"], inputs["v"], window=5)
    assert plain.grad_fn is None and calls == ["fwd", "bwd", "fwd"] and handed[1] is None
    torch.testing.assert_close(plain, out.detach(), rtol=0, atol=0)


def test_plain_route_keeps_autograd():
    _, (q, k, v) = _qkv(1, 1, 4, 2, 16, 16, 16, "float32")
    q.requires_grad_()
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


# --- the forward's log-sum-exp; the backward's designs and schedule ---------

from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    HEAD_DIMS,
    MAX_GRID_X,
    MAX_GRID_Y,
    SPLIT_HEAD_DIMS,
    H100_SMS,
    bwd_design,
    bwd_head_groups,
    bwd_tile_plan,
    bwd_tiles,
    check_backward_grid,
    flash_attention_lse,
)

# The wgmma design's tiles at D = Dv = 128, at MLA's (192, 128) and at
# gemma-2b's D = Dv = 256.
_BWD = bwd_tiles(torch.bfloat16, 128, 128)
_BWD_MLA = bwd_tiles(torch.bfloat16, 192, 128)
_BWD_256 = bwd_tiles(torch.bfloat16, 256, 256)
from repro_torch.kernels.flash_attention.ref import attention_lse_ref  # noqa: E402


def _reference_scores(q, k, causal, window):
    """repro's ``attention_ref``'s float32 scores, scaled and masked as it
    forms them before its softmax (masked scores -1e30)."""
    hq, sq, d = q.shape[1:]
    hkv, sk = k.shape[1:3]
    kr = jnp.repeat(k, hq // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), kr.astype(jnp.float32))
    s = s / (d ** 0.5)
    qpos = jnp.arange(sq)[:, None]
    kpos = jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), jnp.bool_)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return jnp.where(mask[None, None], s, -1e30), np.asarray(mask)


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Sq, Sk, D, causal, window)
    (2, 4, 2, 24, 24, 16, True, None),     # GQA
    (1, 4, 1, 40, 40, 32, True, 8),        # MQA, a sliding window
    (1, 2, 2, 30, 30, 192, True, None),    # MLA's query/key head dim
    (1, 2, 1, 21, 13, 16, False, None),    # non-causal, ragged lengths
    (1, 2, 2, 30, 10, 16, True, 4),        # rows with no live key
])
def test_attention_lse_ref_matches_jax_logsumexp_of_the_reference_scores(case):
    b, hq, hkv, sq, sk, d, causal, window = case
    r = np.random.default_rng(sum(case[:6]))
    q = r.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = r.normal(size=(b, hkv, sk, d)).astype(np.float32)
    scores, mask = _reference_scores(jnp.asarray(q), jnp.asarray(k), causal, window)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, window=window).numpy()
    assert got.shape == (b, hq, sq) and got.dtype == np.float32
    live = np.broadcast_to(mask.any(axis=1), got.shape)
    assert (~live).any() == (window is not None and sq >= sk + window)
    # A row with no live key: +inf, where the reference's -1e30 scores give
    # about -1e30; the backward reads +inf as "weigh every key 1 / Sk".
    assert np.isposinf(got[~live]).all()
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 3])
def test_flash_attention_lse_on_cpu_is_the_plain_pair(window):
    _, (q, k, v) = _qkv(5, 1, 4, 2, 20, 20, 16, "float32")
    out, lse = flash_attention_lse(q, k, v, window=window)
    np.testing.assert_array_equal(out.numpy(),
                                  flash_attention(q, k, v, window=window).numpy())
    np.testing.assert_array_equal(lse.numpy(),
                                  attention_lse_ref(q, k, window=window).numpy())
    with pytest.raises(ValueError, match="window must be >= 1"):
        flash_attention_lse(q, k, v, window=0)


def test_bwd_design_names_a_design_for_every_forward_instance():
    for dtype in (torch.bfloat16, torch.float32):
        for d in HEAD_DIMS:
            want = "wgmma" if dtype == torch.bfloat16 else "fma"
            assert bwd_design(dtype, d, d) == want, (dtype, d)
    # gemma-2b's head dim runs on the wgmma design.
    assert bwd_design(torch.bfloat16, 256, 256) == "wgmma"
    for d, dv in SPLIT_HEAD_DIMS:
        assert bwd_design(torch.bfloat16, d, dv) == "wgmma"
        with pytest.raises(ValueError, match="no instance"):
            bwd_design(torch.float32, d, dv)
    for dtype, d, dv in ((torch.bfloat16, 48, 48), (torch.float16, 64, 64),
                         (torch.bfloat16, 128, 64)):
        with pytest.raises(ValueError, match="no instance"):
            bwd_design(dtype, d, dv)


@pytest.mark.parametrize("bq,bk", [(_BWD.stat_rows, _BWD.block_k),
                                   (_BWD_MLA.stat_rows, _BWD_MLA.block_k),
                                   (_BWD_256.stat_rows, _BWD_256.block_k), (64, 32),
                                   (16, 48)])
@pytest.mark.parametrize("window", [None, 1, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_tile_plan_visits_every_live_pair_once(causal, window, bq, bk):
    for sq in _LENGTHS:
        for sk in _LENGTHS:
            live = _live(sq, sk, causal, window)
            dead = ~live.any(axis=1)  # rows with no live key: weigh every key
            plan = bwd_tile_plan(sq, sk, causal, window, bq, bk)
            n_q = -(-sq // bq)
            assert len(plan) == -(-sk // bk)
            for j, tiles in enumerate(plan):
                visited = [t for t, _ in tiles]
                # The kernel's order: first tile first, each once.
                assert visited == sorted(set(visited)), (sq, sk, j)
                for t in range(n_q):
                    block = live[t * bq:(t + 1) * bq, j * bk:(j + 1) * bk]
                    has_dead = bool(dead[t * bq:(t + 1) * bq].any())
                    # Every live pair once a head; no tile without one or a
                    # row with no live key.
                    assert (t in visited) == (block.any() or has_dead), (sq, sk, j, t)
                for t, needs_mask in tiles:
                    if not needs_mask:
                        # Run without a mask: every score live, below Sk.
                        assert (j + 1) * bk <= sk, (sq, sk, j, t)
                        assert live[t * bq:(t + 1) * bq, j * bk:(j + 1) * bk].all()
                        assert not dead[t * bq:(t + 1) * bq].any()


def test_bwd_schedules_at_the_training_shape():
    # qwen3-4b: B=1, Hq=32, Hkv=8, S=4096, causal, on 132 SMs. Pass 2 has
    # 8 * 32 = 256 blocks; the longest walks 4 heads x 64 query tiles, the
    # mean per SM is the same 256 steps. Pass 1 has 32 * 32 = 1,024
    # blocks, the longest 32 key tiles against a mean of 128 per SM.
    hq, hkv, s, sms = 32, 8, 4096, 132
    group = hq // hkv
    plan = bwd_tile_plan(s, s, True, None, _BWD.stat_rows, _BWD.block_k)
    steps = [group * len(tiles) for tiles in plan]
    assert hkv * len(plan) == 256
    assert max(steps) == 256 and hkv * sum(steps) == 33_792
    assert hkv * sum(steps) / sms == 256
    # Only the two query tiles on the diagonal of each key tile are masked.
    for j, tiles in enumerate(plan):
        assert [t for t, _ in tiles] == list(range(2 * j, s // _BWD.stat_rows))
        assert [t for t, masked in tiles if masked] == [2 * j, 2 * j + 1]
    first = kv_tile_plan(s, s, True, None, _BWD.block_q, _BWD.block_kv)
    assert hq * len(first) == 1_024 and max(len(tiles) for tiles in first) == 32
    assert hq * sum(len(tiles) for tiles in first) / sms == 128


def test_bwd_tiles_of_each_design():
    assert _BWD == (128, 128, 128, 64)
    # MLA: dQ's 96 float32 registers a thread leave room for 64-key S and
    # dP tiles, dK's and dV's 160 for 32-row S^T and dP^T tiles.
    assert _BWD_MLA == (128, 64, 128, 32)
    assert bwd_tiles(torch.bfloat16, 64, 64) == _BWD
    # D = 256: dQ's 128 float32 registers a thread leave room for 48-key S
    # and dP tiles; pass 2 splits dK and dV (128 each) between its two
    # consumers, which share 64 keys, against 64-row tiles.
    assert _BWD_256 == (128, 48, 64, 64)
    assert bwd_tiles(torch.float32, 128, 128) == (16, 16, 16, 16)
    assert bwd_tiles(torch.float32, 256, 256) == (16, 16, 16, 16)


@pytest.mark.parametrize("kernel_pass", [1, 2])
def test_bwd_schedules_at_mla_training_shape(kernel_pass):
    # deepseek-v3's MLA at phase 17 (e)'s shape: B=1, H = Hkv = 128,
    # S=2048, causal, (D, Dv) = (192, 128).
    h, s = 128, 2048
    if kernel_pass == 1:
        # 16 query tiles of 128 rows a head; tile t visits the 64-key
        # tiles 2t + 1 down to 0 (2t + 2 of them), the two on its diagonal
        # masked: 2 + 4 + ... + 32 = 272 a head.
        plan = kv_tile_plan(s, s, True, None, _BWD_MLA.block_q, _BWD_MLA.block_kv)
        assert h * len(plan) == 2_048 and max(len(tiles) for tiles in plan) == 32
        assert sum(len(tiles) for tiles in plan) == 272
        for t, tiles in enumerate(plan):
            assert [j for j, _ in tiles] == list(range(2 * t + 1, -1, -1))
            assert [j for j, masked in tiles if masked] == [2 * t + 1, 2 * t]
    else:
        # 16 key tiles of 128 keys a KV head (group 1); key tile j walks
        # the 32-row query tiles 4j .. 63 (64 - 4j of them), the four on
        # its diagonal masked: 64 + 60 + ... + 4 = 544 a head.
        plan = bwd_tile_plan(s, s, True, None, _BWD_MLA.stat_rows, _BWD_MLA.block_k)
        assert h * len(plan) == 2_048 and max(len(tiles) for tiles in plan) == 64
        assert sum(len(tiles) for tiles in plan) == 544
        for j, tiles in enumerate(plan):
            assert [t for t, _ in tiles] == list(range(4 * j, 64))
            assert [t for t, masked in tiles if masked] == [4 * j + t for t in range(4)]


@pytest.mark.parametrize("dtype,d,dv,rows,keys", [
    (torch.bfloat16, 128, 128, 128, 128),
    (torch.bfloat16, 192, 128, 128, 128),
    (torch.bfloat16, 256, 256, 128, 64),
    (torch.float32, 64, 64, 16, 16),
])
def test_check_backward_grid_follows_the_tiles(dtype, d, dv, rows, keys):
    def call(sq, sk, heads=1):
        q = torch.empty(1, heads, sq, d, dtype=dtype, device="meta")
        k = torch.empty(1, heads, sk, d, dtype=dtype, device="meta")
        v = torch.empty(1, heads, sk, dv, dtype=dtype, device="meta")
        check_backward_grid(q, k, v)

    if dtype == torch.bfloat16:
        # The wgmma design's pass 1 is a 1-D grid of B * Hq tiles of `rows`
        # query rows, at most 2**31 - 1 blocks; pass 2 puts its key tiles
        # of `keys` keys on grid.y.
        heads = MAX_GRID_X // 1024
        call(1024 * rows, MAX_GRID_Y * keys, heads)
        call(MAX_GRID_Y * rows + 1, 1)
        limit = f"ceil\\(Sq/{rows}\\) <= 2\\*\\*31 - 1 and Sk <= 65535 \\* {keys}"
        with pytest.raises(ValueError, match=limit):
            call(1024 * rows + 1, 1, heads)
        with pytest.raises(ValueError, match=limit):
            call(1, MAX_GRID_Y * keys + 1)
        return
    call(MAX_GRID_Y * rows, MAX_GRID_Y * keys)
    with pytest.raises(ValueError, match=f"Sq <= 65535 \\* {rows} and Sk <= 65535 \\* {keys}"):
        call(MAX_GRID_Y * rows + 1, 1)
    with pytest.raises(ValueError, match="backward kernel takes"):
        call(1, MAX_GRID_Y * keys + 1)


def _pass2_blocks(b, hq, hkv, sq, sk, causal, window, tiles, groups):
    """The wgmma design's second pass as the kernel launches it, written
    out: one block a (b * Hkv + KV head, head group, key tile), each the
    list of (query head, key tile, query tile) steps it walks in order."""
    group = hq // hkv
    heads = group // groups
    plan = bwd_tile_plan(sq, sk, causal, window, tiles.stat_rows, tiles.block_k)
    blocks = []
    for j, walk in enumerate(plan):
        for bhk in range(b * hkv):
            for g in range(groups):
                h0 = bhk % hkv * group + g * heads
                blocks.append([(bhk // hkv * hq + h, j, t)
                               for h in range(h0, h0 + heads) for t, _ in walk])
    return blocks


def test_bwd_schedules_at_gemma_training_shape():
    # gemma-2b: B=1, Hq=8, Hkv=1 (MQA), S=4096, causal, D = 256, on 132
    # SMs.
    b, hq, hkv, s = 1, 8, 1, 4096
    # Pass 1: 8 heads x 32 query tiles of 128 rows = 256 blocks; tile t
    # walks the 48-key tiles (128t + 127) // 48 down to 0, the longest 86
    # (the last holds keys 4080-4095) against a mean of 8 * 1,419 / 132 =
    # 86 per SM.
    first = kv_tile_plan(s, s, True, None, _BWD_256.block_q, _BWD_256.block_kv)
    assert hq * len(first) == 256 and max(len(tiles) for tiles in first) == 86
    assert sum(len(tiles) for tiles in first) == 1_419
    assert round(hq * 1_419 / H100_SMS) == 86
    for t, tiles in enumerate(first):
        assert [j for j, _ in tiles] == list(range((128 * t + 127) // 48, -1, -1))
    # Pass 2: 64 key tiles of 64 keys; key tile j walks the 64-row query
    # tiles j .. 63 for each of the 8 heads: 16,640 steps, 126 per SM.
    # One block a key tile would walk 512 steps; four head groups of two
    # heads give 256 blocks whose longest walks 128.
    groups = bwd_head_groups(b, hq, hkv, s, s, True, None,
                             _BWD_256.stat_rows, _BWD_256.block_k)
    assert groups == 4
    blocks = _pass2_blocks(b, hq, hkv, s, s, True, None, _BWD_256, groups)
    walks = [len(block) for block in blocks]
    total = sum(walks)
    assert len(blocks) == 256 and max(walks) == 128 and total == 16_640
    assert int(total / H100_SMS) == 126 and max(walks) <= 1.1 * total / H100_SMS
    for g in (1, 2):  # the smaller divisors leave the longest block too long
        assert max(map(len, _pass2_blocks(b, hq, hkv, s, s, True, None, _BWD_256, g))) \
            > 1.1 * total / H100_SMS
    # Every (query head, key tile, query tile) step once across the groups.
    steps = [step for block in blocks for step in block]
    assert len(set(steps)) == len(steps) == total


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8), (False, None)])
def test_bwd_head_groups_visit_every_live_pair_once(causal, window):
    # At small MQA and GQA shapes (where the card is far from full, so the
    # rule takes the whole group), the groups' blocks walk every query
    # tile with a live pair, once for each head of the group.
    for b, hq, hkv, s in ((1, 8, 1, 40), (2, 8, 2, 300), (1, 4, 4, 129)):
        groups = bwd_head_groups(b, hq, hkv, s, s, causal, window,
                                 _BWD_256.stat_rows, _BWD_256.block_k)
        assert (hq // hkv) % groups == 0
        live = _live(s, s, causal, window)
        want = {(bb * hq + h, j, t)
                for bb in range(b) for h in range(hq)
                for j in range(-(-s // _BWD_256.block_k))
                for t in range(-(-s // _BWD_256.stat_rows))
                if live[t * 64:(t + 1) * 64, j * 64:(j + 1) * 64].any()}
        steps = [step for block in _pass2_blocks(b, hq, hkv, s, s, causal, window,
                                                 _BWD_256, groups) for step in block]
        assert len(steps) == len(set(steps)) and set(steps) == want, (b, hq, hkv, s)


@pytest.mark.parametrize("shape,tiles", [
    ((1, 32, 8, 4096), _BWD),      # qwen3-4b
    ((1, 128, 128, 2048), _BWD_MLA),  # deepseek-v3's MLA
])
def test_bwd_head_groups_keep_one_group_at_the_other_training_shapes(shape, tiles):
    b, hq, hkv, s = shape
    assert bwd_head_groups(b, hq, hkv, s, s, True, None, tiles.stat_rows, tiles.block_k) == 1


# --- the bf16 forward's block order -----------------------------------------

from repro_torch.kernels.flash_attention.ops import BLOCK_Q, block_order  # noqa: E402

# (B, Hq, Hkv, S, D, Dv) of the main path's bf16 prefills.
FORWARD_SHAPES = {
    "qwen3-4b": (2, 32, 8, 4096, 128, 128),
    "mla": (1, 128, 128, 4096, 192, 128),
    "mla ragged": (1, 128, 128, 1000, 192, 128),
    "mla training": (1, 128, 128, 2048, 192, 128),
    "mixtral": (1, 32, 8, 8192, 128, 128),
    "gemma-2b": (1, 8, 1, 4096, 256, 256),
}
# A third of the H100's 50 MB L2: the K and V that the blocks in flight
# may read, the rest left to their Q tiles, outputs and other lines.
KV_IN_FLIGHT = 50_000_000 // 3


@pytest.mark.parametrize("name", list(FORWARD_SHAPES))
def test_block_order_is_a_permutation_longest_first(name):
    # Every (b, h, query tile) once; the KV heads b * Hkv + kvh in order,
    # and inside one the query tiles longest causal rows first, each over
    # the KV head's query heads in order.
    b, hq, hkv, s, _, _ = FORWARD_SHAPES[name]
    tiles, group = -(-s // BLOCK_Q), hq // hkv
    order = block_order(b, hq, hkv, s)
    assert sorted(order) == [(i, h, t) for i in range(b) for h in range(hq)
                             for t in range(tiles)]
    for g in range(b * hkv):
        block = order[g * group * tiles:(g + 1) * group * tiles]
        assert {(i * hkv + h // group) for i, h, _ in block} == {g}
        assert [t for _, _, t in block] == sorted((t for _, _, t in block), reverse=True)
        assert [h % group for _, h, _ in block] == list(range(group)) * tiles


@pytest.mark.parametrize("name", list(FORWARD_SHAPES))
def test_block_order_keeps_kv_in_flight_under_its_budget(name):
    # Any H100_SMS consecutive blocks (one a SM) read the K and V of at
    # most KV_IN_FLIGHT bytes of whole KV heads; at MLA's shapes the
    # heads-fastest order's first wave read all 128 heads' (335 MB at
    # S = 4096).
    b, hq, hkv, s, d, dv = FORWARD_SHAPES[name]
    order = block_order(b, hq, hkv, s)
    group, kv_bytes = hq // hkv, s * (d + dv) * 2
    most = max(len({(i, h // group) for i, h, _ in order[w:w + H100_SMS]})
               for w in range(max(1, len(order) - H100_SMS + 1)))
    assert most * kv_bytes <= KV_IN_FLIGHT
    if name.startswith("mla"):
        assert min(b * hq, H100_SMS) // group * kv_bytes > 4 * KV_IN_FLIGHT


@pytest.mark.parametrize("b, hq, hkv, s", [(1, 8, 1, 4096), (1, 4, 4, 300), (2, 6, 2, 129)])
def test_block_order_at_its_two_ends(b, hq, hkv, s):
    # One KV head a batch (MQA): every query head of a tile together, the
    # heads-fastest order of a (B * Hq, query tiles) grid; one query head a
    # KV head: each head's tiles in a row. Between: KV head by KV head.
    tiles = -(-s // BLOCK_Q)
    order = block_order(b, hq, hkv, s)
    if hkv == 1:
        assert order == [(i, h, tiles - 1 - r) for i in range(b) for r in range(tiles)
                         for h in range(hq)]
    elif hkv == hq:
        assert order == [(i, h, tiles - 1 - r) for i in range(b) for h in range(hq)
                         for r in range(tiles)]
    else:
        group = hq // hkv
        assert order == [(i, kvh * group + j, tiles - 1 - r) for i in range(b)
                         for kvh in range(hkv) for r in range(tiles) for j in range(group)]


# --- the wgmma backward's block orders ---------------------------------------

# (B, Hq, Hkv, S, D, Dv) of the backward's main-path shapes and small
# ragged ones.
BACKWARD_SHAPES = {
    "qwen3-4b training": (1, 32, 8, 4096, 128, 128),
    "mla training": (1, 128, 128, 2048, 192, 128),
    "gemma-2b training": (1, 8, 1, 4096, 256, 256),
    "gqa ragged": (2, 6, 2, 300, 128, 128),
    "mla ragged": (2, 4, 4, 777, 192, 128),
}


@pytest.mark.parametrize("name", list(BACKWARD_SHAPES))
def test_bwd_pass1_runs_in_block_order(name):
    # Pass 1's blocks are the forward's (b, h, 128-row query tile) blocks
    # in block_order: each once, KV heads contiguous in order, the longest
    # causal tiles first inside one.
    b, hq, hkv, s, d, dv = BACKWARD_SHAPES[name]
    assert bwd_tiles(torch.bfloat16, d, dv).block_q == BLOCK_Q
    tiles, group = -(-s // BLOCK_Q), hq // hkv
    order = block_order(b, hq, hkv, s)
    assert sorted(order) == [(i, h, t) for i in range(b) for h in range(hq)
                             for t in range(tiles)]
    kv_heads = [i * hkv + h // group for i, h, _ in order]
    assert kv_heads == sorted(kv_heads)
    for g in range(b * hkv):
        block = order[g * group * tiles:(g + 1) * group * tiles]
        assert [t for _, _, t in block] == sorted((t for _, _, t in block), reverse=True)


@pytest.mark.parametrize("name", ["mla training", "mla ragged"])
def test_bwd_pass1_keeps_mla_kv_in_flight_under_the_budget(name):
    # At MLA's shapes (H = Hkv) any H100_SMS consecutive pass-1 blocks read
    # the K and V of at most KV_IN_FLIGHT bytes of whole heads (1.31 MB a
    # head at (192, 128) and S = 2048); the (B * Hq, query tiles) grid
    # that pass 1 launched before, heads fastest, read all 128 heads' (168
    # MB) in its first wave at the training shape.
    b, hq, hkv, s, d, dv = BACKWARD_SHAPES[name]
    head_bytes = s * (d + dv) * 2
    heads = [(i, h) for i, h, _ in block_order(b, hq, hkv, s)]
    most = max(len(set(heads[w:w + H100_SMS]))
               for w in range(max(1, len(heads) - H100_SMS + 1)))
    assert most * head_bytes <= KV_IN_FLIGHT
    if name == "mla training":
        head_on_x = [(0, h) for _ in range(-(-s // BLOCK_Q)) for h in range(hq)]
        assert len(set(head_on_x[:H100_SMS])) * head_bytes > 4 * KV_IN_FLIGHT


@pytest.mark.parametrize("shape", [(1, 1024, 1, 128), (2, 64, 8, 4096), (1, 4096, 4096, 1)])
def test_check_backward_grid_raises_at_the_one_dimensional_limit(shape):
    # bf16 (wgmma): pass 1 launches B * Hq * ceil(Sq / 128) blocks on a 1-D
    # grid, at most 2**31 - 1, at D = 128 and (192, 128); pass 2 keeps its
    # key tiles on grid.y. The fma design's 2-D grids are not bound by
    # B * Hq.
    b, hq, hkv, s = shape
    for d, dv in ((128, 128), (192, 128)):
        def call(sq, sk, dtype=torch.bfloat16):
            q = torch.empty(b, hq, sq, d, dtype=dtype, device="meta")
            k = torch.empty(b, hkv, sk, d, dtype=dtype, device="meta")
            v = torch.empty(b, hkv, sk, dv, dtype=dtype, device="meta")
            check_backward_grid(q, k, v)

        most = MAX_GRID_X // (b * hq) * BLOCK_Q  # query rows at the limit
        call(most, s)
        with pytest.raises(ValueError, match="B\\*Hq\\*ceil\\(Sq/128\\) <= 2\\*\\*31 - 1"):
            call(most + BLOCK_Q, s)
    q = torch.empty(b, hq, MAX_GRID_Y * 16, 64, device="meta")
    k = torch.empty(b, hkv, MAX_GRID_Y * 16, 64, device="meta")
    check_backward_grid(q, k, k)  # float32: the fma design's grid.y
