"""Real spherical harmonics + Clebsch-Gordan coefficients for l <= 2
(torch port of ``repro/models/gnn/irreps.py``: the numpy half copied, so
its coefficients are the reference's to the bit; the torch
``spherical_harmonics`` in place of the jnp one).

Everything the E(3)-equivariant pipeline needs, self-contained (no e3nn):

  * ``spherical_harmonics(vec)`` — real SH Y_0, Y_1, Y_2 of unit vectors;
  * ``cg_real(l1, l2, l3)``      — real-basis Clebsch-Gordan tensors,
    computed numerically at import from the complex CG recursion + the
    real<->complex SH change of basis. For parity-odd (l1+l2+l3 odd) paths
    the real-basis tensor is purely imaginary; we fold the i into the
    coefficient (SO(3)-equivariance is preserved, which is the symmetry the
    tests check);
  * ``wigner_d_from_sh(l, R)``   — numerical Wigner-D in the real basis,
    recovered from the SH themselves (used by the equivariance tests).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

L_MAX = 2
DIMS = {0: 1, 1: 3, 2: 5}


# ---------------------------------------------------------------------------
# real spherical harmonics (component order: m = -l..l, standard real basis)
# ---------------------------------------------------------------------------

def spherical_harmonics_np(vec: np.ndarray) -> Dict[int, np.ndarray]:
    """vec: (..., 3) unit vectors -> {l: (..., 2l+1)}; normalization chosen so
    each component set is orthonormal on the sphere up to a common constant
    (absorbed into learned weights)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    y0 = np.ones_like(x)[..., None]
    y1 = np.stack([y, z, x], axis=-1)
    s3 = math.sqrt(3.0)
    y2 = np.stack([
        s3 * x * y,
        s3 * y * z,
        0.5 * (3 * z * z - 1.0),
        s3 * x * z,
        0.5 * s3 * (x * x - y * y),
    ], axis=-1)
    return {0: y0, 1: y1, 2: y2}


def spherical_harmonics(vec: torch.Tensor) -> Dict[int, torch.Tensor]:
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    y0 = torch.ones_like(x)[..., None]
    y1 = torch.stack([y, z, x], dim=-1)
    s3 = math.sqrt(3.0)
    y2 = torch.stack([
        s3 * x * y,
        s3 * y * z,
        0.5 * (3 * z * z - 1.0),
        s3 * x * z,
        0.5 * s3 * (x * x - y * y),
    ], dim=-1)
    return {0: y0, 1: y1, 2: y2}


# ---------------------------------------------------------------------------
# complex Clebsch-Gordan (Racah formula) + real change of basis
# ---------------------------------------------------------------------------

def _f(n: int) -> float:
    return float(math.factorial(n))


def _cg_complex(j1, m1, j2, m2, j3, m3) -> float:
    if m3 != m1 + m2:
        return 0.0
    pre = math.sqrt(
        (2 * j3 + 1) * _f(j3 + j1 - j2) * _f(j3 - j1 + j2) * _f(j1 + j2 - j3)
        / _f(j1 + j2 + j3 + 1))
    pre *= math.sqrt(_f(j3 + m3) * _f(j3 - m3) * _f(j1 - m1) * _f(j1 + m1)
                     * _f(j2 - m2) * _f(j2 + m2))
    s = 0.0
    for k in range(0, 20):
        d1 = j1 + j2 - j3 - k
        d2 = j1 - m1 - k
        d3 = j2 + m2 - k
        d4 = j3 - j2 + m1 + k
        d5 = j3 - j1 - m2 + k
        if min(d1, d2, d3, d4, d5) < 0:
            continue
        s += (-1.0) ** k / (_f(k) * _f(d1) * _f(d2) * _f(d3) * _f(d4) * _f(d5))
    return pre * s


def _real_to_complex_U(l: int) -> np.ndarray:
    """U[mc_idx, mr_idx]: complex SH = U @ real SH. Real basis order m=-l..l
    with convention: m<0 -> sin, m>0 -> cos components."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), complex)
    sq2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        ic = m + l
        if m < 0:
            U[ic, -m + l] = sq2              # cos(|m|) part
            U[ic, m + l] = -1j * sq2         # sin(|m|) part
        elif m == 0:
            U[ic, l] = 1.0
        else:
            U[ic, m + l] = (-1) ** m * sq2
            U[ic, -m + l] = 1j * (-1) ** m * sq2
    return U


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C[(2l1+1),(2l2+1),(2l3+1)] (numpy, cached)."""
    if abs(l1 - l2) > l3 or l3 > l1 + l2:
        return np.zeros((DIMS[l1], DIMS[l2], DIMS[l3]))
    Cc = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if -l3 <= m3 <= l3:
                Cc[m1 + l1, m2 + l2, m3 + l3] = _cg_complex(l1, m1, l2, m2, l3, m3)
    U1, U2, U3 = (_real_to_complex_U(l) for l in (l1, l2, l3))
    # C_real = U1^T . U2^T . conj(U3) applied to complex CG
    Cr = np.einsum("abc,ai,bj,ck->ijk", Cc, U1, U2, np.conj(U3))
    if (l1 + l2 + l3) % 2 == 1:      # parity-odd path: purely imaginary
        Cr = Cr.imag
    else:
        Cr = Cr.real
    return np.ascontiguousarray(Cr)


def cg_paths(l_max: int = L_MAX):
    """All (l1, l2, l3) with nonzero CG and every l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                c = cg_real(l1, l2, l3)
                if np.abs(c).max() > 1e-12:
                    out.append((l1, l2, l3))
    return out


# ---------------------------------------------------------------------------
# numerical Wigner-D (for tests): solve Y(R v) = D_l Y(v)
# ---------------------------------------------------------------------------

def wigner_d_from_sh(l: int, R: np.ndarray, n_samples: int = 64,
                     seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    v = rng.normal(size=(n_samples, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    Y = spherical_harmonics_np(v)[l]                     # (N, 2l+1)
    Yr = spherical_harmonics_np(v @ R.T)[l]              # (N, 2l+1)
    D, *_ = np.linalg.lstsq(Y, Yr, rcond=None)           # Y @ D ≈ Yr
    return D.T                                           # Yr^T = D Y^T


def random_rotation(seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q
