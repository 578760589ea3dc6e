"""Real spherical harmonics and real Clebsch-Gordan coefficients (l <= 3),
the port of ``repro/models/gnn/so3.py``.

MACE needs CG tensor products over real-basis irreps. They are solved
for numerically, once per (l1, l2, l3), by the reference's own numpy
solver, copied here line for line with its seeds and its order of
operations (the reference module imports jax, so it is not imported):

* real Wigner-D matrices are fit from the identity Y_l(R v) = D_l(R) Y_l(v)
  over a well-conditioned set of sample directions;
* the CG tensor C is the (1-dimensional) null space of the equivariance
  constraint C (D1 x D2) = D3 C stacked over a few random rotations,
  its sign fixed so that its first nonzero entry is positive.

The same numpy gives the reference's coefficients bit for bit
(``tests/test_torch_gnn_geometric.py``). ``real_sph_harm`` is the same
formulas on tensors; ``cg_tensor`` is a coefficient tensor on a device,
cached.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SQRT_PI = np.sqrt(np.pi)


def num_m(l: int) -> int:
    return 2 * l + 1


def real_sph_harm_np(l: int, v: np.ndarray) -> np.ndarray:
    """Orthonormal real spherical harmonics on unit vectors v (N, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.full(v.shape[:-1] + (1,), 0.5 / _SQRT_PI)
    if l == 1:
        c = np.sqrt(3.0 / (4 * np.pi))
        return np.stack([c * y, c * z, c * x], axis=-1)
    if l == 2:
        c1 = 0.5 * np.sqrt(15.0 / np.pi)
        c2 = 0.25 * np.sqrt(5.0 / np.pi)
        c3 = 0.25 * np.sqrt(15.0 / np.pi)
        return np.stack(
            [
                c1 * x * y,
                c1 * y * z,
                c2 * (3 * z * z - 1.0),
                c1 * x * z,
                c3 * (x * x - y * y),
            ],
            axis=-1,
        )
    if l == 3:
        return np.stack(
            [
                0.25 * np.sqrt(35 / (2 * np.pi)) * y * (3 * x * x - y * y),
                0.5 * np.sqrt(105 / np.pi) * x * y * z,
                0.25 * np.sqrt(21 / (2 * np.pi)) * y * (5 * z * z - 1),
                0.25 * np.sqrt(7 / np.pi) * z * (5 * z * z - 3),
                0.25 * np.sqrt(21 / (2 * np.pi)) * x * (5 * z * z - 1),
                0.25 * np.sqrt(105 / np.pi) * (x * x - y * y) * z,
                0.25 * np.sqrt(35 / (2 * np.pi)) * x * (x * x - 3 * y * y),
            ],
            axis=-1,
        )
    raise NotImplementedError(f"l={l} > 3")


def real_sph_harm(l: int, v: torch.Tensor) -> torch.Tensor:
    """The same formulas on tensors; v must be unit vectors (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return torch.full(v.shape[:-1] + (1,), float(0.5 / _SQRT_PI),
                          dtype=v.dtype, device=v.device)
    if l == 1:
        c = float(np.sqrt(3.0 / (4 * np.pi)))
        return torch.stack([c * y, c * z, c * x], dim=-1)
    if l == 2:
        c1 = float(0.5 * np.sqrt(15.0 / np.pi))
        c2 = float(0.25 * np.sqrt(5.0 / np.pi))
        c3 = float(0.25 * np.sqrt(15.0 / np.pi))
        return torch.stack(
            [
                c1 * x * y,
                c1 * y * z,
                c2 * (3 * z * z - 1.0),
                c1 * x * z,
                c3 * (x * x - y * y),
            ],
            dim=-1,
        )
    raise NotImplementedError(f"l={l} > 2 (tensor path)")


def _sample_dirs(k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(k, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rand_rotation(rng) -> np.ndarray:
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def wigner_d_real(l: int, rot: np.ndarray) -> np.ndarray:
    """Real Wigner-D: Y_l(R v) = D_l(R) @ Y_l(v) (column convention)."""
    dirs = _sample_dirs(max(4 * num_m(l), 16))
    a = real_sph_harm_np(l, dirs)  # (K, 2l+1)
    b = real_sph_harm_np(l, dirs @ rot.T)  # (K, 2l+1)
    dt, *_ = np.linalg.lstsq(a, b, rcond=None)
    return dt.T  # D such that Y(Rv) = D @ Y(v)


@functools.lru_cache(maxsize=None)
def clebsch_gordan_real(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real coupling tensor C (2l1+1, 2l2+1, 2l3+1), Frobenius-normalized.

    Returns None when the triangle inequality fails. C satisfies, for every
    rotation R:  C_{a'b'c} D1_{a'a} D2_{b'b} = D3_{cc'} C_{abc'}.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    n1, n2, n3 = num_m(l1), num_m(l2), num_m(l3)
    rng = np.random.default_rng(12345)
    rows = []
    for _ in range(4):
        rot = _rand_rotation(rng)
        d1 = wigner_d_real(l1, rot)
        d2 = wigner_d_real(l2, rot)
        d3 = wigner_d_real(l3, rot)
        # constraint matrix acting on vec(C): (D1xD2xI - IxIxD3^T) vec = 0
        m = np.kron(np.kron(d1.T, d2.T), np.eye(n3)) - np.kron(
            np.kron(np.eye(n1), np.eye(n2)), d3
        )
        rows.append(m)
    m = np.concatenate(rows, axis=0)
    _u, s, vh = np.linalg.svd(m)
    null = vh[s.size - np.sum(s < 1e-8) :] if np.sum(s < 1e-8) else vh[-1:]
    # For l<=3 couplings of distinct irreps the null space is 1-dim.
    c = null[0].reshape(n1, n2, n3)
    c = c / np.linalg.norm(c)
    # Fix sign deterministically: first nonzero entry positive.
    flat = c.reshape(-1)
    idx = np.argmax(np.abs(flat) > 1e-10)
    if flat[idx] < 0:
        c = -c
    return c


@functools.lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype = torch.float32,
              device: str = "cpu") -> torch.Tensor | None:
    """``clebsch_gordan_real(l1, l2, l3)`` as a ``dtype`` tensor on
    ``device`` (a string, so the cache key is stable), or None. Made
    outside inference mode even when first asked for inside it: a cached
    inference tensor could never be saved for a later backward."""
    c = clebsch_gordan_real(l1, l2, l3)
    if c is None:
        return None
    with torch.inference_mode(False):
        return torch.tensor(c, dtype=dtype, device=device)
