"""Real-basis SO(3) representation machinery for NequIP (l ≤ 3).

Rather than porting e3nn's tables (and risking basis-convention drift), we
derive everything *numerically from our own real spherical harmonics*:

  * ``wigner_d(l, R)`` — fit D_l from Y_l(R x) = D_l Y_l(x) over sample
    points (exact up to lstsq noise, ~1e-12).
  * ``real_cg(l1, l2, l3)`` — the (unique up to scale) equivariant
    bilinear map V_{l1} ⊗ V_{l2} → V_{l3}, found as the nullspace of the
    intertwining constraint stacked over random rotations.

Learned per-path weights absorb the arbitrary normalisation, and the
equivariance *tests* (rotate inputs ⇒ outputs rotate with D_l) hold
against these same conventions by construction.  All of this is plain
numpy (counterpart of ``repro.models.equivariant``, line for line, so the
port's tables equal the reference's on one machine); the model copies
the tables to its device once per call.
"""
from __future__ import annotations

import functools

import numpy as np


def real_sh(l: int, xyz: np.ndarray) -> np.ndarray:
    """Real spherical harmonics (unnormalised, consistent basis).

    xyz (..., 3) unit vectors -> (..., 2l+1).
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if l == 0:
        return np.ones(xyz.shape[:-1] + (1,))
    if l == 1:
        return np.stack([x, y, z], axis=-1)
    if l == 2:
        return np.stack([
            x * y, y * z,
            (3 * z * z - 1.0) / (2 * np.sqrt(3.0)),
            x * z,
            (x * x - y * y) / 2.0,
        ], axis=-1) * np.sqrt(3.0)
    if l == 3:
        return np.stack([
            y * (3 * x * x - y * y),
            x * y * z,
            y * (5 * z * z - 1.0),
            z * (5 * z * z - 3.0),
            x * (5 * z * z - 1.0),
            z * (x * x - y * y),
            x * (x * x - 3 * y * y),
        ], axis=-1)
    raise NotImplementedError(f"l={l}")


def _unit_points(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def random_rotation(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@functools.lru_cache(maxsize=None)
def _sh_basis_cache(l: int):
    pts = _unit_points(max(64, 8 * (2 * l + 1)), seed=l + 1)
    return pts, np.linalg.pinv(real_sh(l, pts))


def wigner_d(l: int, rotation: np.ndarray) -> np.ndarray:
    """D_l with Y_l(R x) = D_l(R) Y_l(x) in our real basis. (2l+1, 2l+1)."""
    pts, pinvA = _sh_basis_cache(l)
    b = real_sh(l, pts @ rotation.T)          # Y(R x_p)
    return (pinvA @ b).T


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Clebsch-Gordan tensor T (2l3+1, 2l1+1, 2l2+1), or zeros when
    the triangle inequality fails.  Normalised to unit Frobenius norm."""
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((n3, n1, n2))
    rows = []
    for s in range(4):
        rot = random_rotation(seed=100 + 7 * s + l1 + 10 * l2 + 100 * l3)
        d1, d2, d3 = wigner_d(l1, rot), wigner_d(l2, rot), wigner_d(l3, rot)
        # constraint: Σ T[m3,m1,m2] D1[m1,a] D2[m2,b] = Σ D3[m3,c] T[c,a,b]
        lhs = np.einsum("ma,nb->manb", d1, d2)       # (n1,n1',n2,n2')
        block = np.zeros((n3 * n1 * n2, n3 * n1 * n2))
        # unknowns vec(T) with index (m3, m1, m2)
        for m3 in range(n3):
            for a in range(n1):
                for b in range(n2):
                    row = np.zeros((n3, n1, n2))
                    row[m3] += lhs[:, a, :, b]
                    for c in range(n3):
                        row[c, a, b] -= d3[m3, c]
                    block[(m3 * n1 + a) * n2 + b] = row.reshape(-1)
        rows.append(block)
    mat = np.concatenate(rows, axis=0)
    _, sing, vt = np.linalg.svd(mat)
    # scale-aware tolerance; the (0,0,0) constraint matrix is identically 0
    null_dim = int(np.sum(sing < 1e-8 * max(sing[0], 1e-3)))
    if null_dim != 1:
        raise RuntimeError(
            f"CG nullspace for ({l1},{l2},{l3}) has dim {null_dim}")
    t = vt[-1].reshape(n3, n1, n2)
    return t / np.linalg.norm(t)


def allowed_paths(l_max: int):
    """All (l_in, l_filter, l_out) triples with every l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    out.append((l1, l2, l3))
    return out
