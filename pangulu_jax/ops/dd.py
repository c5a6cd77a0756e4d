"""Double-float (dd) arithmetic: f64-class precision from f32 arithmetic.

The reference factors R64 natively on its platforms
(pangulu_common.h:11-33), and so does the default engine here.  The dd
engines represent every value as an UNEVALUATED PAIR of f32 (hi, lo)
with |lo| <= ulp(hi)/2 — ~48 significant bits — and keep the FLOPs in
f32:

* Elementwise dd ops use the classic error-free transformations
  (Knuth two_sum, Dekker split/two_prod — no FMA needed).
* ``dd_matmul`` uses an Ozaki-style exact-slicing scheme: operands are
  scaled per-row/col by powers of two, cut into ``NSLICE`` slices of
  ``WBITS`` bits on a fixed exponent grid, and the slice products run
  as plain f32 matmuls whose accumulations are EXACT by construction
  (WBITS*2 + log2(K) <= 24); the per-magnitude partial results are
  then combined in dd.  ~21 f32 matmuls per logical f64 matmul.

These kernels power the ``dispatch="dd"`` factorization engine and the
dd triangular solve, both chosen only on explicit request.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

f32 = jnp.float32

# ---------------------------------------------------------------------------
# error-free transformations (all f32)
# ---------------------------------------------------------------------------

# The error terms below must be computed, not cancelled.  XLA's code
# generators may reassociate the pure-f32 error-free transformations
# (``(ah*bh - p) + ...``) when they vectorize broadcast operands
# (measured on the CPU backend: the correction terms collapse and dd
# degrades to f32; optimization_barrier does NOT stop it — the rewrite
# happens below HLO).  So the EFTs use exact f64 upcasts: the result
# is exactly the EFT value.


def two_sum(a, b):
    s = a + b
    err = ((a.astype(jnp.float64) + b.astype(jnp.float64))
           - s.astype(jnp.float64)).astype(f32)
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    return two_sum(a, b)


def two_prod(a, b):
    p = a * b
    err = ((a.astype(jnp.float64) * b.astype(jnp.float64))
           - p.astype(jnp.float64)).astype(f32)
    return p, err


# ---------------------------------------------------------------------------
# dd scalar/array ops — values are (hi, lo) pairs of f32 arrays
# ---------------------------------------------------------------------------


def dd(x):
    """Split a float64 (host/jnp) array into a dd pair."""
    import numpy as np

    x = np.asarray(x)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(x.dtype)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def dd_to_f64(h, l):
    import numpy as np

    return np.asarray(h).astype(np.float64) + np.asarray(l).astype(
        np.float64)


def dd_add(xh, xl, yh, yl):
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_mul(xh, xl, yh, yl):
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def dd_div(xh, xl, yh, yl):
    """One Newton correction on the f32 quotient (~2^-47 accurate)."""
    q1 = xh / yh
    # r = x - q1*y, in dd
    ph, pl = dd_mul(yh, yl, q1, jnp.zeros_like(q1))
    rh, rl = dd_sub(xh, xl, ph, pl)
    q2 = (rh + rl) / yh
    return quick_two_sum(q1, q2)


def dd_where(m, xh, xl, yh, yl):
    return jnp.where(m, xh, yh), jnp.where(m, xl, yl)


# ---------------------------------------------------------------------------
# exact-sliced dd matmul
# ---------------------------------------------------------------------------

WBITS = 8     # slice width: 2*WBITS + log2(K) <= 24 for K <= 256
NSLICE = 7    # 7*8 = 56 mantissa bits carried


def _pow2_from_exp(e):
    """2^(e-127) as f32 from a biased exponent field (int32)."""
    return lax.bitcast_convert_type(
        (e.astype(jnp.int32) << 23), jnp.float32)


def _scale_pow2(x, axis):
    """Per-row/col power-of-two scale sigma >= max|x| and its exact
    reciprocal (both powers of two)."""
    m = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    m = jnp.maximum(m, f32(1e-30))
    bits = lax.bitcast_convert_type(m, jnp.int32)
    e = ((bits >> 23) & 0xFF) + 1  # ceil to the next power of two
    sigma = _pow2_from_exp(e)
    inv_sigma = _pow2_from_exp(254 - e)  # 2^(127-(e-127)) = 1/sigma
    return sigma, inv_sigma


def _slices(xh, xl, inv_sigma):
    """Cut x/sigma (|.| < 1) into NSLICE slices of WBITS bits on the
    fixed grid 2^(-WBITS*(i+1)); each slice is exactly representable
    and the remainder is tracked in dd, so sum(slices) = x/sigma to
    NSLICE*WBITS bits."""
    rh = xh * inv_sigma     # exact: inv_sigma is a power of two
    rl = xl * inv_sigma
    out = []
    for i in range(NSLICE):
        sc = f32(2.0 ** (WBITS * (i + 1)))
        inv_sc = f32(2.0 ** (-WBITS * (i + 1)))
        s = jnp.round(rh * sc) * inv_sc
        out.append(s)
        rh, rl = dd_sub(rh, rl, s, jnp.zeros_like(s))
    return out


# slice-product pairs (i, j) with i + j < NSLICE, grouped by magnitude
_PAIRS = [(i, d - i) for d in range(NSLICE) for i in range(d + 1)]
_I_SEL = tuple(i for i, _ in _PAIRS)
_J_SEL = tuple(j for _, j in _PAIRS)
_D_START = [sum(1 for p in _PAIRS if sum(p) < d) for d in range(NSLICE + 1)]


@jax.custom_batching.custom_vmap
def dd_matmul(ah, al, bh, bl):
    """(..., m, k) @ (..., k, n) in dd.

    All NSLICE*(NSLICE+1)/2 slice products run as ONE batched matmul
    (a separate matmul per pair is dispatch-bound at block sizes);
    each product is EXACT — slice values are WBITS-bit integers on a
    power-of-two grid, so reduced-precision operands (bf16: 8-bit
    mantissas, TF32: 10) and the <=24-bit f32 accumulation are
    lossless.  Same-magnitude (d = i+j) partials sum in f32
    (error ~2^-(24+WBITS*d) of the result scale), then the NSLICE
    magnitude groups combine in dd."""
    sig_a, inv_a = _scale_pow2(ah, axis=-1)            # per row
    sig_b, inv_b = _scale_pow2(bh, axis=-2)            # per col
    a_s = jnp.stack(_slices(ah, al, inv_a))            # [S, ..., m, k]
    b_s = jnp.stack(_slices(bh, bl, inv_b))
    pa = a_s[jnp.asarray(_I_SEL)]                      # [P, ..., m, k]
    pb = b_s[jnp.asarray(_J_SEL)]
    # align batch ranks (one operand may carry extra batch dims), then
    # canonicalize to ONE flattened batch dim for the dot: XLA's dot
    # simplifier miscompiles dot_generals with many batch dims (hlo
    # verifier failure observed on CPU when this runs under nested
    # vmap, e.g. the batched-group dd engine), and a single batch dim
    # keeps the lowering identical whether or not callers batch.
    if pa.ndim > pb.ndim:
        pb = pb.reshape(pb.shape[:1]
                        + (1,) * (pa.ndim - pb.ndim) + pb.shape[1:])
    elif pb.ndim > pa.ndim:
        pa = pa.reshape(pa.shape[:1]
                        + (1,) * (pb.ndim - pa.ndim) + pa.shape[1:])
    bshape = jnp.broadcast_shapes(pa.shape[:-2], pb.shape[:-2])
    mdim, kdim = pa.shape[-2:]
    ndim_ = pb.shape[-1]
    pa = jnp.broadcast_to(pa, bshape + (mdim, kdim))
    pb = jnp.broadcast_to(pb, bshape + (kdim, ndim_))
    prod = jnp.matmul(pa.reshape((-1, mdim, kdim)),
                      pb.reshape((-1, kdim, ndim_)),
                      preferred_element_type=f32)
    prod = prod.reshape(bshape + (mdim, ndim_))
    ch = jnp.sum(prod[_D_START[0]:_D_START[1]], axis=0)
    cl = jnp.zeros_like(ch)
    for d in range(1, NSLICE):
        part = jnp.sum(prod[_D_START[d]:_D_START[d + 1]], axis=0)
        ch, cl = dd_add(ch, cl, part, jnp.zeros_like(part))
    scale = sig_a * sig_b                               # power of two
    return ch * scale, cl * scale


@dd_matmul.def_vmap
def _dd_matmul_vmap(axis_size, in_batched, ah, al, bh, bl):
    """vmap folds into dd_matmul's native leading batch dims instead of
    adding dot_general batch dims.  Without this, nested vmap (the
    batched-group dd engine maps over group members, dd_lu_inverses
    maps over panel columns inside) produces multi-batch-dim dots that
    XLA:CPU's dot simplifier rejects.  dd_matmul
    broadcasts leading batch shapes and flattens them to ONE dot batch
    dim, so the rule just materializes the mapped axis as a size-1
    leading dim on unbatched operands and recurses — every vmap layer
    re-flattens."""
    def lift(x, b):
        return x if b else x[None]
    out = dd_matmul(lift(ah, in_batched[0]), lift(al, in_batched[1]),
                    lift(bh, in_batched[2]), lift(bl, in_batched[3]))
    return out, (True, True)


# ---------------------------------------------------------------------------
# dd LU + Newton triangle inverses (the dd diag step)
# ---------------------------------------------------------------------------


def dd_eye(nb):
    e = jnp.where(
        lax.broadcasted_iota(jnp.int32, (nb, nb), 0)
        == lax.broadcasted_iota(jnp.int32, (nb, nb), 1),
        f32(1.0), f32(0.0))
    return e, jnp.zeros_like(e)


_DD_LU_BASE = 128  # rank-1 base case size: the blocked recursion
# below it adds many dispatch-bound tiny matmuls


def dd_lu_inverses(ah, al, *, nb, tol):
    """Unpivoted LU of one nb x nb tile in dd, returning the packed
    factor and both triangle inverses.

    Recursive BLOCKED formulation: factor A11, panel-solve A12/A21
    against its inverses, Schur-update A22, recurse — so nearly all
    flops are dd_matmul work and the sequential rank-1 loop only runs
    on the _DD_LU_BASE-sized base case.  Inverse assembly uses the exact block formulas
    inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]] (and its upper
    transpose)."""
    if nb <= _DD_LU_BASE:
        return _dd_lu_base(ah, al, nb=nb, tol=tol)
    h = nb // 2
    a11 = (ah[..., :h, :h], al[..., :h, :h])
    a12 = (ah[..., :h, h:], al[..., :h, h:])
    a21 = (ah[..., h:, :h], al[..., h:, :h])
    a22 = (ah[..., h:, h:], al[..., h:, h:])
    f11, li11, ui11 = dd_lu_inverses(*a11, nb=h, tol=tol)
    u12 = dd_matmul(*li11, *a12)           # L11^-1 A12
    l21 = dd_matmul(*a21, *ui11)           # A21 U11^-1
    p = dd_matmul(*l21, *u12)
    s22 = dd_sub(*a22, *p)
    f22, li22, ui22 = dd_lu_inverses(*s22, nb=nb - h, tol=tol)
    fh = jnp.concatenate([
        jnp.concatenate([f11[0], u12[0]], axis=-1),
        jnp.concatenate([l21[0], f22[0]], axis=-1)], axis=-2)
    fl = jnp.concatenate([
        jnp.concatenate([f11[1], u12[1]], axis=-1),
        jnp.concatenate([l21[1], f22[1]], axis=-1)], axis=-2)
    # linv = [[Li11, 0], [-Li22 L21 Li11, Li22]]
    t = dd_matmul(*l21, *li11)
    x21 = dd_matmul(*li22, *t)
    z12 = jnp.zeros(li11[0].shape[:-2] + (h, nb - h), f32)
    lih = jnp.concatenate([
        jnp.concatenate([li11[0], z12], axis=-1),
        jnp.concatenate([-x21[0], li22[0]], axis=-1)], axis=-2)
    lil = jnp.concatenate([
        jnp.concatenate([li11[1], z12], axis=-1),
        jnp.concatenate([-x21[1], li22[1]], axis=-1)], axis=-2)
    # uinv = [[Ui11, -Ui11 U12 Ui22], [0, Ui22]]
    t = dd_matmul(*ui11, *u12)
    x12 = dd_matmul(*t, *ui22)
    z21 = jnp.zeros(ui11[0].shape[:-2] + (nb - h, h), f32)
    uih = jnp.concatenate([
        jnp.concatenate([ui11[0], -x12[0]], axis=-1),
        jnp.concatenate([z21, ui22[0]], axis=-1)], axis=-2)
    uil = jnp.concatenate([
        jnp.concatenate([ui11[1], -x12[1]], axis=-1),
        jnp.concatenate([z21, ui22[1]], axis=-1)], axis=-2)
    return (fh, fl), (lih, lil), (uih, uil)


def _dd_scan_math(ah, al, *, nb, tol):
    """Rank-1 dd LU + L-scale finalize, written with masked
    reductions."""
    rows = lax.broadcasted_iota(jnp.int32, (nb, 1), 0)
    cols = lax.broadcasted_iota(jnp.int32, (1, nb), 1)
    rows_f = lax.broadcasted_iota(jnp.int32, (nb, nb), 0)
    cols_f = lax.broadcasted_iota(jnp.int32, (nb, nb), 1)
    diag_m = rows_f == cols_f
    lower_m = rows_f > cols_f
    # np.float32 scalars: under jax_enable_x64 a weak Python float
    # would materialize as an f64 constant
    z = np.float32(0.0)
    tol = np.float32(tol)

    def lu_body(k, f):
        fh, fl = f
        rm = rows_f == k
        cm = cols_f == k
        rvh = jnp.sum(jnp.where(rm, fh, z), axis=0, keepdims=True)
        rvl = jnp.sum(jnp.where(rm, fl, z), axis=0, keepdims=True)
        cvh = jnp.sum(jnp.where(cm, fh, z), axis=1, keepdims=True)
        cvl = jnp.sum(jnp.where(cm, fl, z), axis=1, keepdims=True)
        pvh = jnp.sum(jnp.where(cols == k, rvh, z), axis=1,
                      keepdims=True)
        pvl = jnp.sum(jnp.where(cols == k, rvl, z), axis=1,
                      keepdims=True)
        small = jnp.abs(pvh) < tol
        pvh = jnp.where(small, tol, pvh)
        pvl = jnp.where(small, z, pvl)
        below = rows > k
        right = cols > k
        lch, lcl = dd_div(cvh, cvl, jnp.broadcast_to(pvh, cvh.shape),
                          jnp.broadcast_to(pvl, cvh.shape))
        lch = jnp.where(below, lch, z)
        lcl = jnp.where(below, lcl, z)
        urh = jnp.where(right, rvh, z)
        url = jnp.where(right, rvl, z)
        ph, pl = dd_mul(lch, lcl, urh, url)   # broadcast outer product
        return dd_sub(fh, fl, ph, pl)

    fh, fl = lax.fori_loop(0, nb, lu_body, (ah, al))
    # finalize: scale L columns by 1/pivot, clamp diagonal
    dvh = jnp.sum(jnp.where(diag_m, fh, z), axis=0, keepdims=True)
    dvl = jnp.sum(jnp.where(diag_m, fl, z), axis=0, keepdims=True)
    small = jnp.abs(dvh) < tol
    dvh = jnp.where(small, tol, dvh)
    dvl = jnp.where(small, z, dvl)
    sh, sl = dd_div(fh, fl, jnp.broadcast_to(dvh, fh.shape),
                    jnp.broadcast_to(dvl, fh.shape))
    fh, fl = dd_where(lower_m, sh, sl, fh, fl)
    fh = jnp.where(diag_m, jnp.broadcast_to(dvh, fh.shape), fh)
    fl = jnp.where(diag_m, jnp.broadcast_to(dvl, fh.shape), fl)
    return fh, fl


def _dd_lu_base(ah, al, *, nb, tol):
    """Base case: rank-1 dd LU + block-recursive triangle inverses."""
    rows_f = lax.broadcasted_iota(jnp.int32, (nb, nb), 0)
    cols_f = lax.broadcasted_iota(jnp.int32, (nb, nb), 1)
    diag_m = rows_f == cols_f
    lower_m = rows_f > cols_f
    upper_m = rows_f < cols_f
    z = jnp.zeros((), f32)
    tol = np.float32(tol)
    fh, fl = _dd_scan_math(ah, al, nb=nb, tol=tol)
    dvh = jnp.sum(jnp.where(diag_m, fh, z), axis=0, keepdims=True)
    dvl = jnp.sum(jnp.where(diag_m, fl, z), axis=0, keepdims=True)
    small = jnp.abs(dvh) < tol
    dvh = jnp.where(small, tol, dvh)
    dvl = jnp.where(small, z, dvl)

    # Newton-doubling inverses in dd
    eh, el = dd_eye(nb)
    lmh = jnp.where(lower_m, fh, z) + eh
    lml = jnp.where(lower_m, fl, z)
    # D^-1 row and U = I + D^-1 R
    invdh, invdl = dd_div(jnp.ones_like(dvh), jnp.zeros_like(dvh),
                          dvh, dvl)
    rh = jnp.where(upper_m, fh, z)
    rl = jnp.where(upper_m, fl, z)
    mh, ml = dd_mul(rh, rl, jnp.broadcast_to(invdh.T, rh.shape),
                    jnp.broadcast_to(invdl.T, rh.shape))
    umh, uml = mh + eh, ml

    # Triangle inverses by RECURSIVE BLOCK inversion — exact block
    # formula inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]], log2(nb)
    # levels of batched dd matmuls.  (Newton doubling, used by the f32
    # kernels, is unstable in dd: with ||strict part|| > 1 its
    # intermediate iterates grow combinatorially and the cancellation
    # destroys the low word.)
    # both triangles in ONE batched recursion (the upper via its
    # transpose identity) — halves the sequential inversion latency
    sh_ = jnp.stack([lmh, jnp.swapaxes(umh, -1, -2)])
    sl_ = jnp.stack([lml, jnp.swapaxes(uml, -1, -2)])
    inv_h, inv_l = jax.vmap(dd_tri_inv_lower_unit)(sh_, sl_)
    xh, xl = inv_h[0], inv_l[0]
    yh = jnp.swapaxes(inv_h[1], -1, -2)
    yl = jnp.swapaxes(inv_l[1], -1, -2)
    # uinv = y * D^-1 (scale columns)
    uih, uil = dd_mul(yh, yl, jnp.broadcast_to(invdh, yh.shape),
                      jnp.broadcast_to(invdl, yh.shape))
    return (fh, fl), (xh, xl), (uih, uil)


def dd_blocked_residual(ath, atl, row_ids, row_cols, xh, xl, bh, bl_):
    """Exact dd residual ``r = b - A x`` over the blocked tile store.

    ``x``/``b``: [bl+1, nb, nrhs] dd pairs (last segment = scratch);
    ``row_ids``: [bl, W] tile ids of block row k (pad: the scratch
    tile, which is exactly zero, so padded slots are exact no-ops);
    ``row_cols``: [bl, W] the tiles' block columns (pad: scratch
    segment).  The W per-row tile products are each an exact-sliced
    :func:`dd_matmul`; their accumulation is a dd chain (two_sum per
    step), so the residual carries ~48 significant bits — the
    ingredient that lets f32 correction solves refine to f64-class
    accuracy (device-side mixed-precision IR)."""
    w_count = row_ids.shape[1]
    nbl = row_ids.shape[0]
    rh, rl = bh, bl_

    def body(w, c):
        rh, rl = c
        ph, pl = dd_matmul(ath[row_ids[:, w]], atl[row_ids[:, w]],
                           xh[row_cols[:, w]], xl[row_cols[:, w]])
        nh, nl = dd_sub(rh[:nbl], rl[:nbl], ph, pl)
        return rh.at[:nbl].set(nh), rl.at[:nbl].set(nl)

    return lax.fori_loop(0, w_count, body, (rh, rl))


def dd_tri_inv_lower_unit(lh, ll):
    """Inverse of a UNIT lower-triangular dd matrix by bottom-up block
    recursion: maintain per-level the inverses of the diagonal s x s
    blocks [m, s, s]; merging two neighbours costs two batched dd
    matmuls.  Stable (intermediates are subblocks of the true inverse).
    nb is padded to a power of two with an identity extension."""
    nb = lh.shape[-1]
    p = 1 << (nb - 1).bit_length()
    if p != nb:
        pad = [(0, 0)] * (lh.ndim - 2) + [(0, p - nb), (0, p - nb)]
        lh = jnp.pad(lh, pad)
        ll = jnp.pad(ll, pad)
        eye_ext = (lax.broadcasted_iota(jnp.int32, (p, p), 0)
                   == lax.broadcasted_iota(jnp.int32, (p, p), 1))
        ext = jnp.logical_and(
            eye_ext, lax.broadcasted_iota(jnp.int32, (p, p), 0) >= nb)
        lh = jnp.where(ext, f32(1.0), lh)
    # current diagonal-block inverses, [m, s, s]; unit diag -> start I
    m, s = p, 1
    bdh = jnp.ones((m, 1, 1), f32)
    bdl = jnp.zeros((m, 1, 1), f32)
    while s < p:
        m //= 2
        idx = jnp.arange(m)

        def get_c(mat, i, s=s):
            return lax.dynamic_slice(mat, ((2 * i + 1) * s, 2 * i * s),
                                     (s, s))

        ch = jax.vmap(lambda i: get_c(lh, i))(idx)
        cl = jax.vmap(lambda i: get_c(ll, i))(idx)
        ah, al = bdh[0::2], bdl[0::2]
        bh, bl = bdh[1::2], bdl[1::2]
        th, tl = dd_matmul(ch, cl, ah, al)
        xh, xl = dd_matmul(bh, bl, th, tl)
        z = jnp.zeros_like(ah)
        top_h = jnp.concatenate([ah, z], axis=-1)
        top_l = jnp.concatenate([al, z], axis=-1)
        bot_h = jnp.concatenate([-xh, bh], axis=-1)
        bot_l = jnp.concatenate([-xl, bl], axis=-1)
        bdh = jnp.concatenate([top_h, bot_h], axis=-2)
        bdl = jnp.concatenate([top_l, bot_l], axis=-2)
        s *= 2
    out_h, out_l = bdh[0], bdl[0]
    if p != nb:
        out_h, out_l = out_h[:nb, :nb], out_l[:nb, :nb]
    return out_h, out_l
