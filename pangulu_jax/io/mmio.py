"""Matrix IO: MatrixMarket and simple binary-vector formats.

Counterpart of the reference's vendored MatrixMarket reader
(``examples/mmio_highlevel.h``, ~900 LoC C) — here a thin layer over
``scipy.io`` (the idiomatic Python path) plus the RHS-file convention of
the reference example driver (``examples/example.c:100-164,252-266``).
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp

from pangulu_jax.sparse import CscMatrix


def _read_mtx_native(path):
    """Native C++ coordinate-mtx reader (native/pangulu_host.cpp
    pangulu_mmio_read — the counterpart of the reference's vendored C
    reader, examples/mmio_highlevel.h; measured at parity with scipy's
    fast_matrix_market engine).  Returns a scipy matrix or None
    (gz / dense / array variants fall back to scipy)."""
    if str(path).endswith(".gz"):
        return None
    from pangulu_jax import native

    try:
        out = native.mmio_read(path)
    except Exception:
        return None
    if out is None:
        return None
    nrows, ncols, rows, cols, vals, symmetry = out
    a = sp.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols))
    if symmetry:  # expand symmetric / skew / hermitian storage
        off = rows != cols
        v = vals[off]
        if symmetry == 2:
            v = -v
        elif symmetry == 3:
            v = np.conj(v)
        a = a + sp.coo_matrix((v, (cols[off], rows[off])),
                              shape=(nrows, ncols))
    return sp.csc_matrix(a)


def _read_lid(path, dtype=None) -> sp.csc_matrix:
    """Binary ``.lid`` CSR reader, matching the reference example's
    format (examples/example.c:100-164): header ``m:u32 n:u32 nnz:u64``
    followed by ``rowptr[n+1]:u64``, ``colidx[nnz]:u32`` (0-based, as
    the reference reads them raw) and ``values[nnz]`` of the build's
    value type.  The value type is not self-describing in the format
    (the reference fixes it at compile time, pangulu_common.h:11-33):
    we infer its byte width from the file size and use ``dtype`` to
    disambiguate 8-byte values (f64 vs complex64)."""
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype=np.uint32, count=2)
        if len(head) != 2:
            raise ValueError(f"{path}: truncated .lid header")
        m, n = int(head[0]), int(head[1])
        nnz_arr = np.fromfile(f, dtype=np.uint64, count=1)
        if len(nnz_arr) != 1:
            raise ValueError(f"{path}: truncated .lid header")
        nnz = int(nnz_arr[0])
        rowptr = np.fromfile(f, dtype=np.uint64, count=n + 1)
        colidx = np.fromfile(f, dtype=np.uint32, count=nnz)
        if len(rowptr) != n + 1 or len(colidx) != nnz:
            raise ValueError(f"{path}: truncated .lid index data")
        payload = f.read()
    if nnz and len(payload) % nnz == 0 and len(payload) // nnz in (
            4, 8, 16):
        itemsize = len(payload) // nnz
    else:
        raise ValueError(
            f"{path}: .lid value payload is {len(payload)} bytes for "
            f"{nnz} entries — not a 4/8/16-byte value type")
    vdt = {4: np.float32, 8: np.float64, 16: np.complex128}[itemsize]
    if dtype is not None and np.dtype(dtype).itemsize == itemsize:
        vdt = np.dtype(dtype)   # e.g. complex64 at 8 bytes
    values = np.frombuffer(payload, dtype=vdt)
    if int(rowptr[-1]) != nnz:
        raise ValueError(f"{path}: rowptr[-1]={int(rowptr[-1])} != "
                         f"nnz={nnz}")
    a = sp.csr_matrix(
        (values, colidx.astype(np.int64), rowptr.astype(np.int64)),
        shape=(m, n)).tocsc()
    return a


def write_lid(path, a: CscMatrix) -> None:
    """Write the binary ``.lid`` CSR format (see :func:`_read_lid`)."""
    s = a.to_scipy().tocsr()
    s.sort_indices()
    with open(path, "wb") as f:
        np.asarray(s.shape, dtype=np.uint32).tofile(f)
        np.asarray([s.nnz], dtype=np.uint64).tofile(f)
        s.indptr.astype(np.uint64).tofile(f)
        s.indices.astype(np.uint32).tofile(f)
        s.data.tofile(f)


def read_matrix(path, dtype=None) -> CscMatrix:
    """Read a sparse matrix into CSC.

    Formats: MatrixMarket ``.mtx`` (also ``.mtx.gz``; symmetric / skew
    / hermitian storage expanded to full general pattern, like the
    reference reader), the reference's binary ``.lid`` CSR format
    (examples/example.c:100-164), and the binary ``.npz`` written by
    :func:`write_matrix`.  ``dtype`` optionally casts values (pattern
    matrices get ones).
    """
    path = str(path)
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        n = int(z["shape"][0])
        a = sp.csc_matrix((z["data"], z["indices"], z["indptr"]),
                          shape=(n, int(z["shape"][1])))
    elif path.endswith(".lid"):
        a = _read_lid(path, dtype)
    else:
        a = _read_mtx_native(path)
        if a is None:
            a = sp.csc_matrix(scipy.io.mmread(path))
    if dtype is not None:
        a = a.astype(dtype)
    a.sum_duplicates()
    a.sort_indices()
    return CscMatrix.from_scipy(a)


def write_matrix(path, a: CscMatrix) -> None:
    """Write ``.mtx`` (text), ``.lid`` (the reference's binary CSR) or
    ``.npz`` (binary CSC — loads orders of magnitude faster for large
    matrices)."""
    path = str(path)
    s = a.to_scipy()
    if path.endswith(".npz"):
        np.savez_compressed(path, indptr=s.indptr, indices=s.indices,
                            data=s.data, shape=np.asarray(s.shape))
    elif path.endswith(".lid"):
        write_lid(path, a)
    else:
        scipy.io.mmwrite(path, s)


def read_rhs(path, n: int, dtype) -> np.ndarray:
    """Read a right-hand side: one value per line (reference example's
    ``-r rhs`` file), a MatrixMarket dense vector, or binary ``.npy``/
    ``.npz`` (key ``b``)."""
    path = str(path)
    if path.endswith(".mtx"):
        b = np.asarray(scipy.io.mmread(path)).reshape(-1)
    elif path.endswith(".npy"):
        b = np.load(path).reshape(-1)
    elif path.endswith(".npz"):
        b = np.load(path)["b"].reshape(-1)
    else:
        b = np.loadtxt(path).reshape(-1)
    if b.shape[0] != n:
        raise ValueError(f"rhs length {b.shape[0]} != n {n}")
    return b.astype(dtype)


def generated_rhs(a: CscMatrix) -> np.ndarray:
    """Default rhs ``b = A @ 1`` so the exact solution is the ones
    vector (reference: examples/example.c:252-266)."""
    return np.asarray(a.to_scipy() @ np.ones(a.n, dtype=a.values.dtype))
