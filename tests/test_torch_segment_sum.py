"""The port's sorted segment sum on the CPU (its plain version) against
``repro``'s Pallas kernel in interpret mode and its oracle, and the
wrapper's contract (impl choice, no launch off the card, no autograd).

Tolerances: float32 at 2e-5 (the two sum in different orders), bf16 at
2e-2 (the Pallas kernel accumulates into a bf16 output block; the port
sums in float32 and rounds once), as in ``tests/test_kernels.py``. In
bf16 the oracle runs on the inputs widened to float32, the yardstick
``tests/test_kernels.py`` holds the Pallas kernel to: the oracle in bf16
sums in bf16 and is itself off the float32 sum by more than 2e-2."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_sum.ops import (  # noqa: E402
    segment_sum_sorted as jax_segment_sum_sorted,
)
from repro.kernels.segment_sum.ref import segment_sum_sorted_ref as jax_ref  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum_sorted  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(r, shape, dtype):
    """The same values for both packages: float32 from numpy, rounded to
    bf16 by each package (both round to nearest even)."""
    x = r.normal(size=shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _check(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=TOL[dtype], atol=TOL[dtype],
    )


def _both(seg, shape, ns, dtype, seed, **pallas_kw):
    r = np.random.default_rng(seed)
    jdata, tdata = _inputs(r, shape, dtype)
    got = segment_sum_sorted(tdata, torch.from_numpy(seg), ns)
    assert got.dtype == tdata.dtype and tuple(got.shape) == (ns, *shape[1:])
    jseg = jnp.asarray(seg)
    _check(got, jax_ref(jdata.astype(jnp.float32), jseg, ns), dtype)
    flat = jdata.reshape(shape[0], -1)
    want = jax_segment_sum_sorted(flat, jseg, ns, impl="pallas", **pallas_kw)
    _check(got.reshape(ns, -1), want, dtype)
    return got


@pytest.mark.parametrize(
    "m,d,ns,dtype",
    [
        (100, 4, 13, "float32"),
        (3000, 16, 700, "float32"),
        (2048, 32, 256, "bfloat16"),
        (513, 8, 999, "float32"),  # ragged sizes -> the reference's padding
        (700, 1, 90, "float32"),  # GAT's denominators
        (700, 47, 90, "float32"),  # gat-cora's last layer at ogb_products
        (700, 47, 90, "bfloat16"),
    ],
)
def test_segment_sum_matches_pallas(m, d, ns, dtype):
    r = np.random.default_rng(m * 7 + d)
    seg = np.sort(r.integers(0, ns, m)).astype(np.int32)
    _both(seg, (m, d), ns, dtype, m, block_e=256, block_s=128)


def test_segment_sum_hub_segment():
    # One segment owns most rows, across many of the reference's edge
    # blocks (tests/test_kernels.py's skewed-degree case).
    m, d, ns = 2000, 8, 64
    r = np.random.default_rng(5)
    seg = np.sort(np.minimum(r.integers(0, ns, m), 3)).astype(np.int32)
    _both(seg, (m, d), ns, "float32", 5, block_e=128, block_s=32)


@pytest.mark.parametrize("feat", [(8, 8), (8, 1), (1, 47), (2, 3, 5)])
def test_segment_sum_keeps_trailing_dims(feat):
    # GAT's (m, heads, d_out) messages and (m, heads) denominators.
    m, ns = 600, 77
    r = np.random.default_rng(sum(feat))
    seg = np.sort(r.integers(0, ns, m)).astype(np.int32)
    _both(seg, (m, *feat), ns, "float32", 11, block_e=128, block_s=64)


def test_segment_sum_drops_negative_and_sentinel_ids():
    # Empty segments read 0; ids below 0 or at/after num_segments (the
    # reference's padding ids num_segments and ns_pad + block_s) are
    # dropped.
    ns = 50
    r = np.random.default_rng(9)
    body = r.choice(np.arange(0, ns, 3), 400)  # two thirds of segments empty
    seg = np.sort(np.concatenate(
        [[-7, -1, -1], body, [ns, ns, ns + 5, ns + 300]])).astype(np.int32)
    got = _both(seg, (len(seg), 6), ns, "float32", 3, block_e=128, block_s=32)
    empty = np.setdiff1d(np.arange(ns), body)
    assert empty.size and not got[torch.from_numpy(empty)].any()


@pytest.mark.parametrize("shape", [(0, 5), (0, 2, 3)])
def test_segment_sum_of_no_rows_is_zero(shape):
    data = torch.zeros(shape)
    got = segment_sum_sorted(data, torch.zeros(0, dtype=torch.int32), 4)
    assert tuple(got.shape) == (4, *shape[1:]) and not got.any()
    want = jax_ref(jnp.zeros(shape), jnp.zeros(0, jnp.int32), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_path_on_the_cpu_launches_nothing():
    before = launch_counts["segment_sum"]
    seg = torch.tensor([0, 0, 2], dtype=torch.int32)
    for impl in ("auto", "torch"):
        out = segment_sum_sorted(torch.ones(3, 2), seg, 3, impl=impl)
        np.testing.assert_array_equal(out.numpy(), [[2, 2], [0, 0], [1, 1]])
    assert launch_counts["segment_sum"] == before


def test_cuda_impl_on_a_cpu_tensor_raises():
    seg = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        segment_sum_sorted(torch.ones(3, 2), seg, 1, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        segment_sum_sorted(torch.ones(3, 2), seg, 1, impl="pallas")


def test_grad_requiring_input_raises(monkeypatch):
    # (The name is kept from the slices before the autograd Function,
    # when this raised.) A data tensor that requires grad now has a
    # gradient on both routes: the plain one by autograd, the kernel's
    # (forced by the patch, its launch patched to the plain version)
    # through the Function, whose backward is the gather grad[ids] with
    # zero rows for dropped ids. Under no_grad the same call has no
    # grad_fn.
    from repro_torch.kernels.segment_sum import ops

    seg = torch.tensor([-1, 0, 0, 2, 3], dtype=torch.int32)
    grad = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    want = torch.tensor([[0, 0], [1, 2], [1, 2], [5, 6], [0, 0]], dtype=torch.float32)
    data = torch.ones(5, 2, requires_grad=True)
    segment_sum_sorted(data, seg, 3).backward(grad)
    np.testing.assert_array_equal(data.grad.numpy(), want.numpy())
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, x: "cuda")
    launched = []

    def launch(d, ids, n):
        launched.append(n)
        with torch.no_grad():
            return ops.segment_sum_sorted_ref(d, ids, n), None

    monkeypatch.setattr(ops, "segment_sum_and_pointers", launch)
    data.grad = None
    out = segment_sum_sorted(data, seg, 3)
    assert out.grad_fn is not None and launched == [3]
    np.testing.assert_array_equal(out.detach().numpy(), [[2, 2], [0, 0], [1, 1]])
    out.backward(grad)
    np.testing.assert_array_equal(data.grad.numpy(), want.numpy())
    with torch.no_grad():
        out = segment_sum_sorted(data, seg, 3)
    assert out.grad_fn is None and launched == [3, 3]


def test_mismatched_lengths_raise():
    with pytest.raises(ValueError, match="disagree"):
        segment_sum_sorted(torch.ones(3, 2), torch.zeros(4, dtype=torch.int32), 2)
