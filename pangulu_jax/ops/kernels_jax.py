"""Block kernels in pure JAX (dense nb x nb tiles).

Counterparts of the reference's four block kernels
(platforms/.../pangulu_platform_0100000.c:57-397 CPU,
platforms/.../pangulu_platform_0201000.cu:547-873 CUDA):

  * :func:`getrf`  — unpivoted LU of a diagonal tile (recursive blocked,
    matmul trailing updates; tiny-pivot substitution like the
    reference's ``PANGULU_TOL`` path, pangulu_platform_0100000.c:80-84).
  * :func:`tstrf`  — panel solve ``X @ U = B``  (L-panel).
  * :func:`gessm`  — panel solve ``L @ X = B``  (U-panel, unit diag L).
  * :func:`ssssm`  — batched Schur update ``C -= A @ B`` (the dominant
    kernel, a batched matmul).

Where the reference gathers sparse blocks into compacted dense panels
before cBLAS/cuBLAS (0100000.c:245-315, 0201000.cu:826-852), here every
present block *is* a dense tile — structural zeros are exact IEEE zeros
and stay zero through the factorization, so results match the
sparse-block formulation exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# The reference substitutes 1e-16 for tiny diagonal pivots
# (pangulu_common.h:133 PANGULU_TOL); we scale the default by dtype.
DEFAULT_TOL = {
    jnp.dtype("float32"): 1e-8,
    jnp.dtype("float64"): 1e-16,
    jnp.dtype("complex64"): 1e-8,
    jnp.dtype("complex128"): 1e-16,
}

_BASE = 32  # unblocked base-case size for the recursive LU


def _safe_pivot(d, tol):
    return jnp.where(jnp.abs(d) < tol, jnp.asarray(tol, d.dtype), d)


def _getrf_unblocked(a, tol):
    """Doolittle LU on a small m x m tile via rank-1 updates."""
    m = a.shape[-1]
    idx = jnp.arange(m)

    def body(k, a):
        piv = _safe_pivot(a[k, k], tol)
        lcol = jnp.where(idx > k, a[:, k] / piv, jnp.zeros((), a.dtype))
        urow = jnp.where(idx > k, a[k, :], jnp.zeros((), a.dtype))
        a = a - jnp.outer(lcol, urow)
        a = a.at[:, k].set(jnp.where(idx > k, lcol, a[:, k]))
        a = a.at[k, k].set(piv)
        return a

    return lax.fori_loop(0, m, body, a, unroll=4)


def _split(m):
    """Split m into two halves that are multiples of the base size."""
    h = ((m + 1) // 2 + _BASE - 1) // _BASE * _BASE
    return min(h, m - _BASE) if m - h < _BASE and m > _BASE else h


def getrf(a, tol=None):
    """Unpivoted LU of a dense tile: returns L\\U packed in-place
    (unit-diagonal L strictly below, U on and above the diagonal)."""
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    m = a.shape[-1]
    if m <= _BASE:
        return _getrf_unblocked(a, tol)
    m1 = _split(m)
    a11, a12 = a[:m1, :m1], a[:m1, m1:]
    a21, a22 = a[m1:, :m1], a[m1:, m1:]
    f11 = getrf(a11, tol)
    u12 = lax.linalg.triangular_solve(
        f11, a12, left_side=True, lower=True, unit_diagonal=True)
    l21 = lax.linalg.triangular_solve(
        f11, a21, left_side=False, lower=False, unit_diagonal=False)
    s22 = a22 - l21 @ u12
    f22 = getrf(s22, tol)
    top = jnp.concatenate([f11, u12], axis=1)
    bot = jnp.concatenate([l21, f22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def tstrf(diag, b):
    """L-panel solve: X @ U = B where U = triu(diag) (incl diagonal).
    Reference: pangulu_platform_0100000.c:137-175.  Batched over
    leading dims of ``b``."""
    return lax.linalg.triangular_solve(
        diag, b, left_side=False, lower=False, unit_diagonal=False)


def gessm(diag, b):
    """U-panel solve: L @ X = B where L = unit_tril(diag).
    Reference: pangulu_platform_0100000.c:178-209."""
    return lax.linalg.triangular_solve(
        diag, b, left_side=True, lower=True, unit_diagonal=True)


def ssssm(c, a, b):
    """Schur update C -= A @ B on batched dense tiles.
    Reference: pangulu_platform_0100000.c:211-397 /
    0201000.cu:717-873."""
    prod = jnp.matmul(a, b, preferred_element_type=c.dtype)
    return c - prod


def trsv_lower_unit(diag, x):
    """Forward substitution on one tile (unit lower).  Reference
    in-block sptrsv: pangulu_platform_0100000.c:466-486."""
    return lax.linalg.triangular_solve(
        diag, x[:, None] if x.ndim == 1 else x,
        left_side=True, lower=True, unit_diagonal=True
    ).reshape(x.shape)


def trsv_upper(diag, x, tol=None):
    """Backward substitution on one tile (upper, diag divide with
    tiny-pivot substitution — pangulu_platform_0100000.c:488-506)."""
    if tol is None:
        tol = DEFAULT_TOL[diag.dtype]
    n = diag.shape[-1]
    eye = jnp.eye(n, dtype=diag.dtype)
    d = jnp.diagonal(diag)
    safe = _safe_pivot(d, tol)
    diag = diag + (safe - d) * eye
    return lax.linalg.triangular_solve(
        diag, x[:, None] if x.ndim == 1 else x,
        left_side=True, lower=False, unit_diagonal=False
    ).reshape(x.shape)


def diag_inverses(diag):
    """(L^-1, U^-1) of a factored diagonal tile (L\\U packed).

    Panel-solve strategy: invert the two triangles once per level,
    then every TSTRF/GESSM panel solve is a batched matmul
    instead of a serialized substitution.  The inversion itself is one
    fixed-shape triangular solve against I, so it compiles once.
    """
    nb = diag.shape[-1]
    eye = jnp.eye(nb, dtype=diag.dtype)
    linv = lax.linalg.triangular_solve(
        diag, eye, left_side=True, lower=True, unit_diagonal=True)
    uinv = lax.linalg.triangular_solve(
        diag, eye, left_side=True, lower=False, unit_diagonal=False)
    return linv, uinv


def unit_lower_inv_newton(f):
    """Exact inverse of unit_tril(f) by Newton–Schulz doubling.

    For L = I + N with N strictly lower (nilpotent), X_0 = I - N and
    X_{k+1} = X_k (2I - L X_k) satisfies L X_k = I - N^(2^{k+1}), so
    after ceil(log2(nb)) - 1 steps the inverse is EXACT (not an
    approximation) — ceil(log2(nb)) matmul pairs instead of nb
    sequential substitution steps.  Pure matmul work.
    """
    nb = f.shape[-1]
    dt = f.dtype
    eye = jnp.eye(nb, dtype=dt)
    lmat = jnp.tril(f, -1) + eye
    x = 2 * eye - lmat  # I - N
    steps = max((nb - 1).bit_length() - 1, 0)
    for _ in range(steps):
        x = jnp.matmul(x, 2 * eye - jnp.matmul(lmat, x,
                                               preferred_element_type=dt),
                       preferred_element_type=dt)
    return x


def upper_inv_newton(f, tol):
    """Exact inverse of triu(f) (with tiny-pivot substitution) via the
    same doubling on the unit-upper part: U = D (I + M) with
    M = D^-1 R strictly upper -> U^-1 = (I + M)^-1 D^-1."""
    nb = f.shape[-1]
    dt = f.dtype
    eye = jnp.eye(nb, dtype=dt)
    d = _safe_pivot(jnp.diagonal(f), tol)
    dinv = 1.0 / d
    m = jnp.triu(f, 1) * dinv[:, None]  # D^-1 R
    x = eye - m
    umat = eye + m
    steps = max((nb - 1).bit_length() - 1, 0)
    for _ in range(steps):
        x = jnp.matmul(x, 2 * eye - jnp.matmul(umat, x,
                                               preferred_element_type=dt),
                       preferred_element_type=dt)
    return x * dinv[None, :]


def _unblocked_lu_with_inv(a, tol):
    """Base case: rank-1 LU fori pass + Newton-doubling inverses."""
    f = _getrf_unblocked(a, tol)
    return f, unit_lower_inv_newton(f), upper_inv_newton(f, tol)


def getrf_with_inverses(a, tol=None):
    """Fused GETRF + triangle inverses, matmul-only recursion.

    Computing (f, L^-1, U^-1) jointly turns the
    recursive TRSM steps into matmuls against already-computed child
    inverses, and assembles the parent inverses by block formulas

        L^-1 = [[L11^-1, 0], [-L22^-1 L21 L11^-1, L22^-1]]
        U^-1 = [[U11^-1, -U11^-1 U12 U22^-1], [0, U22^-1]]

    so the entire diagonal step is matmuls + one small base case — no
    TriangularSolve custom calls in the factorization hot loop.
    """
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    m = a.shape[-1]
    if m <= _BASE:
        return _unblocked_lu_with_inv(a, tol)
    m1 = _split(m)
    dt = a.dtype
    a11, a12 = a[:m1, :m1], a[:m1, m1:]
    a21, a22 = a[m1:, :m1], a[m1:, m1:]
    f11, linv11, uinv11 = getrf_with_inverses(a11, tol)
    u12 = jnp.matmul(linv11, a12, preferred_element_type=dt)
    l21 = jnp.matmul(a21, uinv11, preferred_element_type=dt)
    s22 = a22 - jnp.matmul(l21, u12, preferred_element_type=dt)
    f22, linv22, uinv22 = getrf_with_inverses(s22, tol)
    z_tr = jnp.zeros((m1, m - m1), dt)
    z_bl = jnp.zeros((m - m1, m1), dt)
    f = jnp.concatenate([
        jnp.concatenate([f11, u12], axis=1),
        jnp.concatenate([l21, f22], axis=1)], axis=0)
    linv = jnp.concatenate([
        jnp.concatenate([linv11, z_tr], axis=1),
        jnp.concatenate([-jnp.matmul(linv22, jnp.matmul(
            l21, linv11, preferred_element_type=dt),
            preferred_element_type=dt), linv22], axis=1)], axis=0)
    uinv = jnp.concatenate([
        jnp.concatenate([uinv11, -jnp.matmul(uinv11, jnp.matmul(
            u12, uinv22, preferred_element_type=dt),
            preferred_element_type=dt)], axis=1),
        jnp.concatenate([z_bl, uinv22], axis=1)], axis=0)
    return f, linv, uinv


def spmv_sub(y, a, x):
    """y -= A @ x (reference spmv, pangulu_platform_0100000.c:435-453),
    in full working precision (never TF32)."""
    return y - jnp.matmul(a, x, precision=lax.Precision.HIGHEST)


def vecadd(y, x):
    """y += x (reference vecadd, pangulu_platform_0100000.c:455-464)."""
    return y + x


getrf_batched = jax.vmap(getrf, in_axes=(0,))
