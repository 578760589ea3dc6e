"""The port's flash_attention wrapper on the CPU, where it runs its plain
PyTorch version: against ``repro``'s ``attention_ref`` and its Pallas
kernel (interpret mode) on the ``test_flash_attention_sweep`` grid, on
ragged and unequal lengths, and the wrapper contract."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
