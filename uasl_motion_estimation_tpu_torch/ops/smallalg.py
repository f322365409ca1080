"""Batched small-matrix decompositions as fixed-sweep tensor programs.

Port of ``uasl_motion_estimation_tpu/ops/smallalg.py``:

* ``eigh_jacobi`` — parallel-ordered cyclic Jacobi for symmetric n x n
  (n small), a fixed number of sweeps, each round of disjoint Givens
  rotations applied as one batched similarity transform;
* ``svd3_rotation`` — 3x3 SVD via eigh of A^T A plus orthonormalization of
  the image basis.

The sweeps are fixed and no LAPACK routine (``torch.linalg.eigh``) is used,
so the results track the JAX Jacobi, not LAPACK's choice of eigenvector
signs and orderings. Every function is batched over leading dims.
"""

from __future__ import annotations

import functools

import torch


def _round_robin_rounds(n: int) -> list[list[tuple[int, int]]]:
    """Tournament schedule: (n-1 or n) rounds of DISJOINT index pairs
    covering every (p, q) once (circle method; odd n gets a bye)."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _round_index(n: int, device: torch.device) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """The rounds as (p, q) index tensors on ``device``, made once."""
    return tuple((torch.tensor([a for a, _ in pairs], device=device),
                  torch.tensor([b for _, b in pairs], device=device))
                 for pairs in _round_robin_rounds(n))


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no LU library call)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def eigh_jacobi(M: torch.Tensor, sweeps: int = 6) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric (..., n, n), ascending eigenvalues.

    Returns (w (..., n), V (..., n, n)) with M ~= V @ diag(w) @ V^T."""
    n = M.shape[-1]
    batch = M.shape[:-2]
    dev, dtype = M.device, M.dtype
    eye = torch.eye(n, dtype=dtype, device=dev)
    V = eye.expand(*batch, n, n)
    A = 0.5 * (M + M.transpose(-1, -2))
    rounds = _round_index(n, dev)

    for _ in range(sweeps):
        for p, q in rounds:
            # one orthogonal G embedding every (p, q) rotation of this round
            apq = A[..., p, q]
            app = A[..., p, p]
            aqq = A[..., q, q]
            tiny = torch.abs(apq) < 1e-30
            tau = (aqq - app) / (2.0 * torch.where(tiny, torch.full_like(apq, 1e-30), apq))
            # NOT sign(tau): sign(0) == 0 would skip the 45-degree rotation
            # needed when the two diagonal entries are exactly equal (e.g.
            # E^T E of skew((1, 1, 0) / sqrt(2))) and never diagonalize
            sgn = torch.where(tau >= 0.0, 1.0, -1.0).to(dtype)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tiny, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            G = eye.expand(*batch, n, n).clone()
            G[..., p, p] = c
            G[..., q, q] = c
            G[..., p, q] = s
            G[..., q, p] = -s
            A = torch.matmul(torch.matmul(G.transpose(-1, -2), A), G)
            V = torch.matmul(V, G)

    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def svd3_rotation(E: torch.Tensor, sweeps: int = 7
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of (..., 3, 3): (U, s, Vt) with E = U diag(s) Vt, columns by
    DESCENDING s. V from Jacobi eigh of E^T E; U = E V / s, the last column
    completed by a cross product when E is (near-)rank-2."""
    EtE = torch.matmul(E.transpose(-1, -2), E)
    w, V = eigh_jacobi(EtE, sweeps)
    w = torch.flip(w, dims=(-1,))
    V = torch.flip(V, dims=(-1,))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U01 = torch.matmul(E, V[..., :2])
    U01 = U01 / torch.clamp(s[..., None, :2], min=1e-20)
    u0 = U01[..., 0]
    u0 = u0 / torch.clamp(torch.linalg.norm(u0, dim=-1, keepdim=True), min=1e-20)
    u1 = U01[..., 1]
    u1 = u1 - torch.sum(u0 * u1, dim=-1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.norm(u1, dim=-1, keepdim=True), min=1e-20)
    # last column: E v2 / s2 when s2 carries signal (its SIGN matters for
    # full-rank inputs), cross-product completion when E is (near-)rank-2
    u2_raw = torch.matmul(E, V[..., 2:3])[..., 0]
    nrm2 = torch.linalg.norm(u2_raw, dim=-1, keepdim=True)
    scale = torch.amax(s, dim=-1, keepdim=True)
    u2 = torch.where(nrm2 > 1e-5 * torch.clamp(scale, min=1e-20),
                     u2_raw / torch.clamp(nrm2, min=1e-30),
                     torch.linalg.cross(u0, u1, dim=-1))
    u2 = u2 - torch.sum(u0 * u2, dim=-1, keepdim=True) * u0
    u2 = u2 - torch.sum(u1 * u2, dim=-1, keepdim=True) * u1
    u2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True), min=1e-20)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)
