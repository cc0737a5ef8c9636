"""Numerical helpers shared across the port (counterpart of
``chirpgp_tpu.utils.numerics``)."""

import torch

__all__ = ["as_real_tensor", "phi1", "ou_variance", "psd_cholesky",
           "cholesky_or_nan", "psd_solve", "psd_solve_factored",
           "solve_small", "psd_solve_batched"]


def as_real_tensor(x) -> torch.Tensor:
    """Tensors pass through; Python numbers, sequences and NumPy arrays
    become float64 host tensors (the JAX package evaluates such constants
    at x64 on the host)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def phi1(x: torch.Tensor) -> torch.Tensor:
    r"""Smooth evaluation of :math:`\phi_1(x) = (1 - e^{-x}) / x`, with a
    Taylor switch at ``|x| < 1e-4`` (no 0/0 at ``x = 0``)."""
    x = as_real_tensor(x)
    small = x.abs() < 1e-4
    x_safe = torch.where(small, torch.ones_like(x), x)
    exact = -torch.expm1(-x_safe) / x_safe
    taylor = 1.0 - x / 2.0 + x * x / 6.0
    return torch.where(small, taylor, exact)


def ou_variance(b, lam, dt) -> torch.Tensor:
    r"""Stationary-increment variance of a damped (OU-like) channel:
    :math:`b^2 (1 - e^{-2\lambda dt}) / (2\lambda)`, smoothly equal to
    ``b^2 dt`` at ``lam = 0``."""
    return b ** 2 * dt * phi1(2.0 * as_real_tensor(lam) * dt)


def psd_cholesky(P: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Lower Cholesky-like factor of a PSD matrix that may be SINGULAR.

    Unrolled Cholesky that zeroes the pivot and its column when the pivot
    falls below ``eps``, so ``L L^T`` still reproduces the nonsingular
    block exactly (``torch.linalg.cholesky`` raises on such inputs).
    Accepts ``(..., d, d)``.
    """
    d = P.shape[-1]
    rows = [[None] * d for _ in range(d)]
    zero = torch.zeros_like(P[..., 0, 0])
    for j in range(d):
        acc = P[..., j, j]
        for k in range(j):
            acc = acc - rows[j][k] * rows[j][k]
        ok = acc > eps
        Ljj = torch.where(ok, torch.sqrt(acc.clamp_min(eps)), zero)
        inv = torch.where(ok, 1.0 / torch.where(ok, Ljj, zero + 1.0), zero)
        rows[j][j] = Ljj
        for i in range(j + 1, d):
            acc2 = P[..., i, j]
            for k in range(j):
                acc2 = acc2 - rows[i][k] * rows[j][k]
            rows[i][j] = acc2 * inv
    return torch.stack(
        [torch.stack([rows[i][j] if j <= i else zero for j in range(d)],
                     dim=-1) for i in range(d)], dim=-2)


def cholesky_or_nan(P: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``P`` (..., d, d), NaN where ``P`` is not
    positive definite -- what JAX's Cholesky returns, where
    ``torch.linalg.cholesky`` raises, for the whole batch of a
    ``torch.func.vmap``.  A non-finite lane of a batched objective so
    carries NaN and leaves the other lanes alone."""
    L, info = torch.linalg.cholesky_ex(P)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, L, torch.full_like(L, float("nan")))


def psd_solve(P: torch.Tensor, B: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Solve ``P X = B`` for PSD ``P`` that may be singular.

    Factors ``P = L L^T`` with :func:`psd_cholesky` and runs forward/back
    substitution that treats clamped (zero) pivots as zero contribution:
    the pseudo-inverse on the degenerate subspace, exact on PD inputs.
    ``P``: (d, d); ``B``: (d,) or (d, k).
    """
    return psd_solve_factored(psd_cholesky(P, eps), B)


def psd_solve_factored(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """:func:`psd_solve` from the factor ``L = psd_cholesky(P)``: forward
    and back substitution with zero pivots contributing zero.  For several
    solves against one ``P`` (the continuous-discrete smoothers' four RK4
    stages), the same values as :func:`psd_solve` at one factorization."""
    d = L.shape[-1]
    vec = B.dim() == 1
    Bm = B[:, None] if vec else B
    inv = []
    for j in range(d):
        ok = L[j, j] > 0
        inv.append(torch.where(ok, 1.0 / torch.where(ok, L[j, j], 1.0), 0.0))
    # forward: L Y = B
    Y = [None] * d
    for j in range(d):
        acc = Bm[j]
        for k in range(j):
            acc = acc - L[j, k] * Y[k]
        Y[j] = acc * inv[j]
    # backward: L^T X = Y
    X = [None] * d
    for j in range(d - 1, -1, -1):
        acc = Y[j]
        for k in range(j + 1, d):
            acc = acc - L[k, j] * X[k]
        X[j] = acc * inv[j]
    out = torch.stack(X, dim=0)
    return out[:, 0] if vec else out


def solve_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched solve ``A X = B`` for small ``d`` by unrolled Gaussian
    elimination WITHOUT pivoting, as the JAX package does it (a closed-form
    adjugate at d = 2).  ``A``: (..., d, d); ``B``: (..., d, k).

    The JAX package wrote it because a pivoted LU on tiny batched systems
    was slow on the TPU; the port keeps the same arithmetic so that the
    parallel-scan combines agree with it to round-off.  Without pivoting it
    is meant for the combines' ``I + C J`` with ``C``, ``J`` PSD and for
    SPD systems, whose leading principal minors stay positive; at d >= 3 a
    zero leading minor gives Inf/NaN where a pivoted solve would not
    (kept as in the reference).
    """
    d = A.shape[-1]
    k = B.shape[-1]
    if d == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, e = A[..., 1, 0], A[..., 1, 1]
        inv_det = 1.0 / (a * e - b * c)
        r0 = e[..., None] * B[..., 0, :] - b[..., None] * B[..., 1, :]
        r1 = -c[..., None] * B[..., 0, :] + a[..., None] * B[..., 1, :]
        return torch.stack([r0, r1], dim=-2) * inv_det[..., None, None]
    M = [[A[..., i, j] for j in range(d)] for i in range(d)]
    X = [[B[..., i, j] for j in range(k)] for i in range(d)]
    for i in range(d):
        inv = 1.0 / M[i][i]
        for j in range(i + 1, d):
            M[i][j] = M[i][j] * inv
        for j in range(k):
            X[i][j] = X[i][j] * inv
        for r in range(i + 1, d):
            f = M[r][i]
            for j in range(i + 1, d):
                M[r][j] = M[r][j] - f * M[i][j]
            for j in range(k):
                X[r][j] = X[r][j] - f * X[i][j]
    for i in range(d - 2, -1, -1):
        for r in range(i + 1, d):
            f = M[i][r]
            for j in range(k):
                X[i][j] = X[i][j] - f * X[r][j]
    return torch.stack([torch.stack(row, dim=-1) for row in X], dim=-2)


def psd_solve_batched(P: torch.Tensor, B: torch.Tensor,
                      eps: float = 1e-30) -> torch.Tensor:
    """Batched solve ``P X = B`` for SPD/PSD ``P`` with small ``d``:
    :func:`psd_cholesky` (degenerate-safe) and unrolled substitutions in
    which a zero pivot contributes zero.  ``P``: (..., d, d); ``B``:
    (..., d, k)."""
    L = psd_cholesky(P, eps)
    d = P.shape[-1]
    k = B.shape[-1]
    inv = []
    for j in range(d):
        Ljj = L[..., j, j]
        ok = Ljj > 0
        inv.append(torch.where(ok, 1.0 / torch.where(ok, Ljj, 1.0), 0.0))
    Bl = [[B[..., i, j] for j in range(k)] for i in range(d)]
    Y = [None] * d
    for j in range(d):
        acc = Bl[j]
        for kk in range(j):
            acc = [a - L[..., j, kk] * y for a, y in zip(acc, Y[kk])]
        Y[j] = [a * inv[j] for a in acc]
    X = [None] * d
    for j in range(d - 1, -1, -1):
        acc = Y[j]
        for kk in range(j + 1, d):
            acc = [a - L[..., kk, j] * x for a, x in zip(acc, X[kk])]
        X[j] = [a * inv[j] for a in acc]
    return torch.stack([torch.stack(row, dim=-1) for row in X], dim=-2)
