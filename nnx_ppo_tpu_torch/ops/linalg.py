"""Small batched linear algebra for articulated-body physics.

Port of ``nnx_ppo_tpu/ops/linalg.py``: Cholesky factorization and solves
of the tiny per-env systems of rigid-body dynamics (n ≤ ~20 dofs),
written as plain tensor arithmetic over the leading (batch) dimensions,
with the same order of operations as the JAX functions, so that the two
agree to rounding. No LAPACK-style call is used: the port's tests hold
these against the JAX package, and the passed-in-factor physics path
(``physics/engine.py::mass_matrix_factor``) needs the factor exactly as
the JAX env builds it.
"""

from __future__ import annotations

import torch

UNROLL_MAX_N = 10


def cholesky_solve_small(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``M x = rhs`` for symmetric positive-definite ``M``
    (``[..., n, n]``, ``rhs[..., n]``). ``n <= UNROLL_MAX_N``: fully
    unrolled scalar expressions; larger ``n``:
    :func:`cholesky_solve_blocked`."""
    n = M.shape[-1]
    if n > UNROLL_MAX_N:
        return cholesky_solve_blocked(M, rhs)
    if rhs.shape[-1] != n:
        raise ValueError(f"rhs last dim {rhs.shape[-1]} != n {n}")
    zero = torch.zeros(M.shape[:-2], dtype=M.dtype, device=M.device)

    # Cholesky factorization M = L Lᵀ, unrolled over (i, j).
    L = [[zero] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j] - sum((L[i][k] * L[j][k] for k in range(j)), zero)
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]

    # Forward substitution L y = rhs.
    y: list[torch.Tensor] = []
    for i in range(n):
        y.append((rhs[..., i] - sum((L[i][k] * y[k] for k in range(i)), zero)) / L[i][i])

    # Back substitution Lᵀ x = y.
    x: list[torch.Tensor] = [zero] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((L[k][i] * x[k] for k in range(i + 1, n)), zero)) / L[i][i]
    return torch.stack(x, dim=-1)


def cholesky_factor_blocked(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor by right-looking rank-1 updates: ``n`` steps
    of O(n²) vector operations over the batch."""
    n = M.shape[-1]
    idx = torch.arange(n, device=M.device)
    cols = []
    A = M
    for j in range(n):
        d = torch.sqrt(A[..., j, j])
        col = A[..., :, j] / d[..., None]
        # Zero above the diagonal so the trailing-submatrix update and
        # the stored column are restricted to rows >= j.
        col = torch.where(idx >= j, col, 0.0)
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def cholesky_backsub(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``L Lᵀ x = rhs`` given the lower factor (two scalar-unrolled
    triangular substitutions)."""
    n = L.shape[-1]
    if rhs.shape[-1] != n:
        raise ValueError(f"rhs last dim {rhs.shape[-1]} != n {n}")
    ys: list[torch.Tensor] = []
    for i in range(n):
        acc = rhs[..., i]
        for k in range(i):
            acc = acc - L[..., i, k] * ys[k]
        ys.append(acc / L[..., i, i])
    xs: list = [None] * n
    for i in reversed(range(n)):
        acc = ys[i]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i] * xs[k]
        xs[i] = acc / L[..., i, i]
    return torch.stack(xs, dim=-1)


def tri_lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched lower-triangular matrix by 2x2 block
    recursion: ``[[A,0],[C,D]]⁻¹ = [[A⁻¹,0],[-D⁻¹ C A⁻¹, D⁻¹]]``."""
    n = L.shape[-1]
    if n == 1:
        return 1.0 / L
    if n == 2:
        a = L[..., 0, 0]
        c = L[..., 1, 0]
        d = L[..., 1, 1]
        zero = torch.zeros_like(a)
        inv_a = 1.0 / a
        inv_d = 1.0 / d
        row0 = torch.stack([inv_a, zero], -1)
        row1 = torch.stack([-c * inv_a * inv_d, inv_d], -1)
        return torch.stack([row0, row1], -2)
    m = n // 2
    Ai = tri_lower_inverse(L[..., :m, :m])
    Di = tri_lower_inverse(L[..., m:, m:])
    B21 = -Di @ L[..., m:, :m] @ Ai
    top = torch.cat([Ai, torch.zeros(L.shape[:-2] + (m, n - m), dtype=L.dtype, device=L.device)], -1)
    bot = torch.cat([B21, Di], -1)
    return torch.cat([top, bot], -2)


def spd_inverse_from_factor(L: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ = L⁻ᵀ L⁻¹``: a recursive triangular inverse plus one
    batched matrix product."""
    X = tri_lower_inverse(L)
    return X.transpose(-1, -2) @ X


def cholesky_solve_blocked(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """SPD solve via :func:`cholesky_factor_blocked` and
    :func:`cholesky_backsub`."""
    n = M.shape[-1]
    if rhs.shape[-1] != n:
        raise ValueError(f"rhs last dim {rhs.shape[-1]} != n {n}")
    return cholesky_backsub(cholesky_factor_blocked(M), rhs)
