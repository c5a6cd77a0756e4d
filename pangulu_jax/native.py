"""ctypes loader for the native host runtime (native/pangulu_host.cpp).

The performance-critical sequential host pipeline — elimination tree,
symbolic fill enumeration, minimum-degree ordering, MC64 matching with
exact dual scalings — is implemented in C++ (the reference implements
these in C: pangulu_symbolic.c, pangulu_reordering.c).  Python
fallbacks exist for every function, but at scale they are slow
(hours for millions of rows), so a failed build is logged as a warning
with the compiler's error.  The library is built from source on first
use, or ahead of time with::

    make native            # or: python -m pangulu_jax.native
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

from pangulu_jax.utils.log import get_logger

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = str(_SRC / "libpangulu_host.so")
_lib = None
_tried = False


def _build() -> bool:
    """Compile the library from source; on failure log the compiler's
    error and return False.  Builds to a temporary name and renames, so
    concurrent processes never load a half-written file."""
    src = _SRC / "pangulu_host.cpp"
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
           str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except subprocess.CalledProcessError as e:
        err = e.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        err = str(e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    get_logger().warning(
        "native host library build failed (%s); falling back to the "
        "pure-Python host pipeline, which is slow at scale:\n%s",
        " ".join(cmd), err)
    return False


_ABI_VERSION = 5


def _load_checked():
    """dlopen + ABI stamp check; returns None on mismatch (stale .so)."""
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.pangulu_abi_version.restype = ctypes.c_int64
        lib.pangulu_abi_version.argtypes = []
        if lib.pangulu_abi_version() != _ABI_VERSION:
            return None
        return lib
    except (OSError, AttributeError):
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _load_checked() if os.path.exists(_LIB_PATH) else None
    if lib is None:
        # absent or stale: (re)build from source
        if not _build():
            return None
        lib = _load_checked()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pangulu_etree.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.pangulu_etree.restype = None
    lib.pangulu_fill_walk.argtypes = [ctypes.c_int64, i64p, i32p, i64p,
                                      ctypes.c_int64, u8p, ctypes.c_int64]
    lib.pangulu_fill_walk.restype = ctypes.c_int64
    lib.pangulu_fill_walk_counts.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, ctypes.c_int64, u8p,
        ctypes.c_int64, i64p]
    lib.pangulu_fill_walk_counts.restype = ctypes.c_int64
    lib.pangulu_fill_entries.argtypes = [ctypes.c_int64, i64p, i32p, i64p,
                                         i32p, i32p]
    lib.pangulu_fill_entries.restype = ctypes.c_int64
    lib.pangulu_mindeg.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.pangulu_mindeg.restype = None
    lib.pangulu_ndorder.argtypes = [ctypes.c_int64, i64p, i32p,
                                    ctypes.c_int64, i64p]
    lib.pangulu_ndorder.restype = None
    lib.pangulu_ndorder_aligned.argtypes = [
        ctypes.c_int64, i64p, i32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.pangulu_ndorder_aligned.restype = None
    lib.pangulu_mc64.argtypes = [ctypes.c_int64, i64p, i32p, f64p, i64p,
                                 f64p, f64p]
    lib.pangulu_mc64.restype = ctypes.c_int
    lib.pangulu_mmio_probe.argtypes = [ctypes.c_char_p, i64p]
    lib.pangulu_mmio_probe.restype = ctypes.c_int
    lib.pangulu_mmio_read.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      i32p, i32p, f64p, f64p]
    lib.pangulu_mmio_read.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def etree(n, indptr, indices):
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i64(indptr), _i32(indices)
    parent = np.empty(n, dtype=np.int64)
    lib.pangulu_etree(n, _ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int32),
                      _ptr(parent, ctypes.c_int64))
    return parent


def fill_walk(n, indptr, indices, parent, nb, bl):
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    mark = np.zeros(bl * bl, dtype=np.uint8)
    count = lib.pangulu_fill_walk(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), nb, _ptr(mark, ctypes.c_uint8), bl)
    return int(count), mark.reshape(bl, bl).astype(bool)


def fill_walk_counts(n, indptr, indices, parent, nb, bl):
    """fill_walk + per-column strictly-lower L counts (exact sparse
    flop accounting).  Returns (count, mark, colcnt) or None."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    mark = np.zeros(bl * bl, dtype=np.uint8)
    colcnt = np.zeros(n, dtype=np.int64)
    count = lib.pangulu_fill_walk_counts(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), nb, _ptr(mark, ctypes.c_uint8), bl,
        _ptr(colcnt, ctypes.c_int64))
    return int(count), mark.reshape(bl, bl).astype(bool), colcnt


def fill_entries(n, indptr, indices, parent, count):
    """All strictly-lower fill entries (i, j) of L, or None."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    out_i = np.empty(count, dtype=np.int32)
    out_j = np.empty(count, dtype=np.int32)
    got = lib.pangulu_fill_entries(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), _ptr(out_i, ctypes.c_int32),
        _ptr(out_j, ctypes.c_int32))
    if got != count:
        return None
    return out_i, out_j


def mindeg(n, indptr, indices):
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i64(indptr), _i32(indices)
    order = np.empty(n, dtype=np.int64)
    lib.pangulu_mindeg(n, _ptr(indptr, ctypes.c_int64),
                       _ptr(indices, ctypes.c_int32),
                       _ptr(order, ctypes.c_int64))
    return order


def ndorder(n, indptr, indices, leaf_size=128, align_nb=0):
    """Multilevel nested dissection ordering (METIS_NodeND role), or
    None when the native lib is unavailable.  ``align_nb > 1`` aligns
    part sizes to multiples of the tile size so disjoint subtrees map
    to disjoint nb-blocks (keeps the etree parallelism visible to the
    block-level super-level schedule)."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i64(indptr), _i32(indices)
    order = np.empty(n, dtype=np.int64)
    lib.pangulu_ndorder_aligned(n, _ptr(indptr, ctypes.c_int64),
                                _ptr(indices, ctypes.c_int32), leaf_size,
                                align_nb, _ptr(order, ctypes.c_int64))
    return order


def mc64(n, colptr, rowidx, absval):
    """Returns (colperm, row_scale, col_scale) or None (no lib /
    structurally singular)."""
    lib = get_lib()
    if lib is None:
        return None
    colptr, rowidx = _i64(colptr), _i32(rowidx)
    absval = np.ascontiguousarray(absval, dtype=np.float64)
    colperm = np.empty(n, dtype=np.int64)
    rs = np.empty(n, dtype=np.float64)
    cs = np.empty(n, dtype=np.float64)
    rc = lib.pangulu_mc64(n, _ptr(colptr, ctypes.c_int64),
                          _ptr(rowidx, ctypes.c_int32),
                          _ptr(absval, ctypes.c_double),
                          _ptr(colperm, ctypes.c_int64),
                          _ptr(rs, ctypes.c_double),
                          _ptr(cs, ctypes.c_double))
    if rc != 0:
        return None
    return colperm, rs, cs


def mmio_read(path):
    """Fast MatrixMarket coordinate read: (nrows, ncols, rows, cols,
    values, symmetry) or None (no lib / unsupported variant — caller
    falls back to scipy).  symmetry: 0 general, 1 symmetric,
    2 skew-symmetric, 3 hermitian.  Symmetry is NOT expanded here."""
    lib = get_lib()
    if lib is None:
        return None
    hdr = np.zeros(5, dtype=np.int64)
    pathb = str(path).encode()
    if lib.pangulu_mmio_probe(pathb, _ptr(hdr, ctypes.c_int64)) != 0:
        return None
    nrows, ncols, nnz, field, symmetry = (int(x) for x in hdr)
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    re = np.empty(nnz, dtype=np.float64)
    im = np.empty(nnz, dtype=np.float64) if field == 3 else None
    got = lib.pangulu_mmio_read(
        pathb, nnz, _ptr(rows, ctypes.c_int32),
        _ptr(cols, ctypes.c_int32), _ptr(re, ctypes.c_double),
        _ptr(im, ctypes.c_double) if im is not None else None)
    if got != nnz:
        return None
    vals = re + 1j * im if field == 3 else re
    return nrows, ncols, rows, cols, vals, symmetry


if __name__ == "__main__":
    ok = _build()
    print("native build:", "ok" if ok else "FAILED", "->", _LIB_PATH)
