"""Small dense SPD solves by an explicit, unrolled Cholesky — port of
`android_svo_tpu/geometry/linsolve.py`.

Not `torch.linalg`: the same elementwise factorization with the same pivot
floor runs on both sides of the port, so a near-singular normal equation
fails (returns finite, meaningless values that callers mask) the same way.
All functions act on the last two axes and broadcast over leading ones.
"""

from __future__ import annotations

import torch

_PIVOT_FLOOR = 1e-20


def _chol_unrolled(H: torch.Tensor):
    d = H.shape[-1]
    L = [[None] * d for _ in range(d)]
    for j in range(d):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=_PIVOT_FLOOR))
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, d):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_ljj
    return L


def _chol_solve_cols(L, b_cols):
    d = len(L)
    outs = []
    for b in b_cols:
        y = [None] * d
        for i in range(d):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * d
        for i in reversed(range(d)):
            s = y[i]
            for k in range(i + 1, d):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        outs.append(x)
    return outs


def solve_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x with H x = g for SPD H: (..., d, d) @ (..., d) -> (..., d)."""
    d = H.shape[-1]
    L = _chol_unrolled(H)
    (x,) = _chol_solve_cols(L, [[g[..., i] for i in range(d)]])
    return torch.stack(x, dim=-1)


def inv_spd(H: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD (..., d, d) via Cholesky column solves."""
    d = H.shape[-1]
    L = _chol_unrolled(H)
    one = torch.ones(H.shape[:-2], dtype=H.dtype, device=H.device)
    zero = torch.zeros_like(one)
    cols = [[one if i == j else zero for i in range(d)] for j in range(d)]
    xs = _chol_solve_cols(L, cols)
    return torch.stack([torch.stack(col, dim=-1) for col in xs], dim=-1)


def det2x2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2x2(A: torch.Tensor, det=None) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) (general, not just SPD)."""
    if det is None:
        det = det2x2(A)
    inv_det = 1.0 / det
    row0 = torch.stack([A[..., 1, 1] * inv_det, -A[..., 0, 1] * inv_det], -1)
    row1 = torch.stack([-A[..., 1, 0] * inv_det, A[..., 0, 0] * inv_det], -1)
    return torch.stack([row0, row1], dim=-2)


def solve_spd_loop(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x with H x = g for one larger SPD system (d up to ~100; local BA's
    (6 NC)^2 reduced camera system): Jacobi preconditioning, a right-looking
    Cholesky and two substitutions, one Python loop each over the columns
    (port of `solve_spd_loop`, `android_svo_tpu/geometry/linsolve.py:120`).

    The preconditioning factors D^-1/2 H D^-1/2 so every pivot is O(1) even
    when one camera block carries huge J^T J terms.  Each step is the
    reference's masked column update restricted to the rows it changes; no
    value is read back to the host."""
    d = H.shape[-1]
    diag = torch.diagonal(H)
    dinv = 1.0 / torch.sqrt(torch.clamp(torch.abs(diag), min=_PIVOT_FLOOR))
    L = H * dinv[:, None] * dinv[None, :]
    g = g * dinv
    for j in range(d):
        pivot = torch.sqrt(torch.clamp(L[j, j], min=_PIVOT_FLOOR))
        col = L[j:, j] / pivot                     # L column j (diag incl.)
        L[j + 1:, j + 1:] -= col[1:, None] * col[None, 1:]
        L[j:, j] = col
    y = torch.zeros_like(g)
    for i in range(d):
        y[i] = (g[i] - torch.dot(L[i, :i], y[:i])) / L[i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(d)):
        x[i] = (y[i] - torch.dot(L[i + 1:, i], x[i + 1:])) / L[i, i]
    return x * dinv                                # undo preconditioning
