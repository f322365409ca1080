"""Exact 5-point minimal essential-matrix solver as fixed-shape tensor code.

Port of ``uasl_motion_estimation_tpu/ops/fivepoint.py`` (Nister's 5-point
inside ``cv::findEssentialMat``, src/vo/MonoVisualOdometry.cpp:20), in the
same steps:

1. **Nullspace**: the 4-dim nullspace of the 5x9 epipolar system by SVD,
   E(x, y, z) = x E1 + y E2 + z E3 + E4 (``nullspace_basis``). A Jacobi eigh
   of A^T A was tried in the JAX package and reverted: squaring the
   conditioning pushed candidate epipolar residuals past the 5e-3 contract.
2. **Constraint matrix**: the 10 cubic constraints (det E = 0 and
   2 E E^T E - tr(E E^T) E = 0) at a fixed z are polynomials in (x, y) over
   the 10 monomials of degree <= 3; their coefficients come from 10 fixed
   evaluation nodes and a precomputed inverse Vandermonde (``_M_of_z``).
3. **Roots**: det M(z) = 0 is a degree-10 polynomial in z, evaluated as a
   batched 10x10 determinant (``det_unrolled``); real roots are bracketed by
   sign changes on a 128-node tan grid and refined by 22 bisection steps.
4. **Back-substitution**: (x, y) from the nullvector of M(z*) (Jacobi eigh
   of M^T M, ops/smallalg.py), then a projection onto the essential
   manifold (``svd3_rotation``).

The nullspace basis is not unique (any orthonormal basis of the 4-dim null
space is an SVD's valid ``Vt[5:9]``, and LAPACK builds differ), and it sets
the parametrisation, so the roots, their order and which ones the grid
brackets depend on it: ``candidates_from_basis`` takes the basis as an
argument. Every function is batched over leading dims; the iteration counts
are fixed, so nothing reads a device value on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import const
from . import smallalg as sal

# xy-monomial basis of degree <= 3, the column order of M(z):
#   x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1
_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
          (1, 0), (0, 1), (0, 0)]
_IDX_X = _MONOS.index((1, 0))
_IDX_Y = _MONOS.index((0, 1))
_IDX_1 = _MONOS.index((0, 0))


def _make_xy_nodes() -> tuple[np.ndarray, np.ndarray]:
    """10 fixed (x, y) evaluation nodes and the inverse Vandermonde over
    _MONOS (float64; cond ~ 38). The nodes are the degree-3 principal
    lattice {(i, j): i + j <= 3}, centred and scaled: unisolvent for
    bivariate interpolation of total degree 3."""
    s = 0.8
    pts = np.asarray(
        [(s * (i - 1.0), s * (j - 1.0)) for i in range(4) for j in range(4 - i)]
    )
    V = np.stack([[x**a * y**b for (a, b) in _MONOS] for x, y in pts])
    return pts, np.linalg.inv(V)


_XY_NODES, _XY_VINV = _make_xy_nodes()

# root search domain |z| <= tan(_PHI_MAX) ~ 140, on a tan grid
_PHI_MAX = 1.5637
_N_GRID = 128
_MAX_ROOTS = 10
# after ~19 halvings of a 0.0246 rad bracket the float32 midpoint equals an
# endpoint; 22 steps, as the JAX package runs
_BISECT_ITERS = 22
_PHI = np.linspace(-_PHI_MAX, _PHI_MAX, _N_GRID)


def _constraints(E: torch.Tensor) -> torch.Tensor:
    """The 10 essential-manifold cubics at numeric E (..., 3, 3):
    [det E, vec(2 E E^T E - tr(E E^T) E)], (..., 10). The determinant is by
    cofactors (no LU library call)."""
    EEt = torch.matmul(E, E.transpose(-1, -2))
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    c = 2.0 * torch.matmul(EEt, E) - tr[..., None, None] * E
    return torch.cat([sal.det3(E)[..., None], c.flatten(-2)], dim=-1)


def _node_part(basis: torch.Tensor) -> torch.Tensor:
    """x E1 + y E2 at the 10 nodes: (..., 10, 3, 3), the part of E that
    does not change with z."""
    nodes = const(_XY_NODES.tolist(), basis.dtype, basis.device)  # (10, 2)
    b = basis[..., None, :, :, :]  # (..., 1, 4, 3, 3)
    return nodes[:, 0, None, None] * b[..., 0, :, :] + nodes[:, 1, None, None] * b[..., 1, :, :]


def _M_of_z(basis: torch.Tensor, z: torch.Tensor, node_part: torch.Tensor | None = None
            ) -> torch.Tensor:
    """(..., m, 10, 10) xy-coefficient matrices of the constraint system at
    the m values z (..., m) of each basis (..., 4, 3, 3); ``node_part`` is
    ``_node_part(basis)``, made once per basis. Rows are the constraints,
    columns the _MONOS monomials."""
    if node_part is None:
        node_part = _node_part(basis)
    vinv = const(_XY_VINV.tolist(), basis.dtype, basis.device)  # (10 monomials, 10 nodes)
    b = basis[..., None, None, :, :, :]  # (..., 1, 1, 4, 3, 3)
    # x E1 + y E2 + z E3 + E4, summed in that order
    E = (node_part[..., None, :, :, :] + z[..., :, None, None, None] * b[..., 2, :, :]
         + b[..., 3, :, :])  # (..., m, 10, 3, 3)
    vals = _constraints(E)  # (..., m, node, constraint)
    return torch.matmul(vinv, vals).transpose(-1, -2)


def det_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., n, n) by unrolled, partially pivoted Gaussian
    elimination in batched tensor ops (n small and static): the pivot is
    the first largest |entry| of the column at or below the diagonal (as
    ``jnp.argmax``). No LU library call, which on the card would also read
    an info flag on the host.

    Each step keeps only the trailing block the later steps read: the
    entries it computes are those of the JAX package's full-matrix
    elimination, operation for operation, and the eliminated columns,
    which no later step reads, are not formed."""
    n = M.shape[-1]
    det = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    for k in range(n - 1):
        m = n - k
        rows = torch.arange(m, device=M.device)[:, None]
        p = torch.argmax(torch.abs(M[..., :, 0]), dim=-1)  # first maximum
        pk = p[..., None, None]
        row_p = torch.take_along_dim(M, pk, dim=-2)  # (..., 1, m)
        M = torch.where(rows == 0, row_p, torch.where(rows == pk, M[..., :1, :], M))
        det = torch.where(p != 0, -det, det)
        piv = M[..., 0, 0]
        det = det * piv
        safe = torch.where(torch.abs(piv) < 1e-30, 1e-30, piv)
        factor = M[..., 1:, :1] / safe[..., None, None]
        M = M[..., 1:, 1:] - factor * M[..., :1, 1:]
    return det * M[..., 0, 0]


def _det_sign_value(basis: torch.Tensor, z: torch.Tensor, node_part: torch.Tensor
                    ) -> torch.Tensor:
    """det M(z) with each row scaled by (1 + |z|)^-3 (every constraint has
    z-degree <= 3): bounded float32 magnitudes, the same sign. (..., m)."""
    M = _M_of_z(basis, z, node_part)
    return det_unrolled(M / ((1.0 + torch.abs(z)) ** 3)[..., None, None])


def nullspace_basis(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3, 3) orthonormal nullspace basis [E1, E2, E3, E4] of the
    5x9 epipolar systems of normalized correspondences p1, p2 (..., 5, 2):
    rows 5-8 of the SVD's V^T."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)  # (..., 5, 9)
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    return Vh[..., 5:9, :].reshape(*A.shape[:-2], 4, 3, 3)


def candidates_from_basis(basis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every essential matrix of the pencil E(x, y, z) of ``basis``
    (..., 4, 3, 3): (Es (..., 10, 3, 3) unit-norm, valid (..., 10) bool), one
    candidate per real root of det M(z) found on the grid, in grid order."""
    dtype, dev = basis.dtype, basis.device
    node_part = _node_part(basis)

    # --- bracket real roots of det M(z) on the tan grid ---
    phi = const(_PHI.tolist(), dtype, dev)
    g = _det_sign_value(basis, torch.tan(phi), node_part)
    s = torch.sign(g)
    change = s[..., :-1] * s[..., 1:] < 0.0  # strict sign change between i and i+1
    grid_idx = torch.arange(_N_GRID - 1, device=dev)
    order = torch.where(change, grid_idx, _N_GRID)
    idx = torch.sort(order, dim=-1).values[..., :_MAX_ROOTS]  # first brackets, in grid order
    valid = idx < (_N_GRID - 1)
    idx_c = torch.clamp(idx, 0, _N_GRID - 2)
    lo = phi[idx_c]
    hi = phi[idx_c + 1]
    glo = torch.take_along_dim(g, idx_c, dim=-1)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        gm = _det_sign_value(basis, torch.tan(mid), node_part)
        left = (torch.sign(gm) == torch.sign(glo)) & (gm != 0.0)
        lo = torch.where(left, mid, lo)
        hi = torch.where(left, hi, mid)
        glo = torch.where(left, gm, glo)
    z = torch.tan(0.5 * (lo + hi))  # (..., R)

    # --- (x, y) from the right nullvector of M(z*) ---
    M = _M_of_z(basis, z, node_part) / ((1.0 + torch.abs(z)) ** 3)[..., None, None]
    _, VM = sal.eigh_jacobi(torch.matmul(M.transpose(-1, -2), M), sweeps=10)
    v = VM[..., :, 0]  # (..., R, 10) monomial weights
    scale = v[..., _IDX_1]
    ok = torch.abs(scale) > 1e-5 * torch.amax(torch.abs(v), dim=-1)
    safe = torch.where(torch.abs(scale) < 1e-20, 1e-20, scale)
    x = (v[..., _IDX_X] / safe)[..., None, None]
    y = (v[..., _IDX_Y] / safe)[..., None, None]
    b = basis[..., None, :, :, :]
    E = x * b[..., 0, :, :] + y * b[..., 1, :, :] + z[..., None, None] * b[..., 2, :, :] \
        + b[..., 3, :, :]
    nrm = torch.linalg.norm(E, dim=(-2, -1), keepdim=True)
    E = E / torch.where(nrm < 1e-12, 1.0, nrm)
    # exact essential-manifold projection: singular values -> (1, 1, 0)/sqrt(2)
    U, _, Vt = sal.svd3_rotation(E)
    E = torch.matmul(U * const([1.0, 1.0, 0.0], dtype, dev), Vt) / math.sqrt(2.0)
    return E, valid & ok & torch.all(torch.isfinite(E), dim=(-2, -1))


def fivepoint_candidates(p1: torch.Tensor, p2: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """All essential matrices consistent with 5 normalized correspondences
    p1, p2 (..., 5, 2) (prev, cur): (Es (..., 10, 3, 3), valid (..., 10))."""
    return candidates_from_basis(nullspace_basis(p1, p2))
