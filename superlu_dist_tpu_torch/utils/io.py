"""Sparse-matrix file I/O.

A copy of the JAX package's readers (numpy and scipy only), so the port
reads a matrix file without that package. Readers for the formats the
reference supports (reference: SRC/double/dreadhb.c, dreadrb.c,
dreadMM.c, dreadtriple.c, dreadtriple_noheader.c, dbinary_io.c — one
reader set per precision there; here one dtype-generic implementation):

- Harwell-Boeing (.rua / .rsa / .cua / .csa / .pua ...)
- Rutherford-Boeing (.rb)
- MatrixMarket (.mtx)
- "triple" coordinate text (n n nnz header, then i j v lines)
- simple binary (.npz via numpy)

All readers return ``scipy.sparse.csc_matrix`` (the host-side analog of the
reference's compressed-column ``NCformat``)::

    from superlu_dist_tpu_torch.utils.io import read_matrix
    A = read_matrix("g20.rua")
"""

from __future__ import annotations

import re

import numpy as np
import scipy.sparse as sp

__all__ = [
    "read_hb", "read_rb", "read_mm", "read_triple", "read_binary",
    "write_binary", "read_matrix",
]


_FMT_RE = re.compile(
    r"\(\s*(?:(\d+)\s*[xX]\s*,?\s*)?(?:\d+\s*[pP]\s*,?\s*)?(\d*)\s*"
    r"([iIeEdDfFgG])\s*(\d+)(?:\.(\d+))?", )


def _parse_fortran_format(fmt: str):
    """Parse a Fortran edit descriptor like (16I5), (5E15.8), (1P,4D20.12).

    Returns (per_line_count, field_width, kind) where kind is 'int' or 'float'.
    """
    m = _FMT_RE.search(fmt)
    if not m:
        raise ValueError(f"unsupported Fortran format: {fmt!r}")
    _skip, count, letter, width = m.group(1), m.group(2), m.group(3), m.group(4)
    count = int(count) if count else 1
    kind = "int" if letter.lower() == "i" else "float"
    return count, int(width), kind


def _read_fixed(lines_iter, fmt: str, n_items: int, dtype):
    """Read ``n_items`` numbers laid out in fixed-width Fortran format."""
    per_line, width, kind = _parse_fortran_format(fmt)
    out = np.empty(n_items, dtype=dtype)
    got = 0
    while got < n_items:
        line = next(lines_iter)
        # strip trailing newline but keep internal spacing; pad short lines
        line = line.rstrip("\r\n")
        take = min(per_line, n_items - got)
        for i in range(take):
            field = line[i * width:(i + 1) * width]
            if not field.strip():
                # Short line: fewer items than per_line on the final line.
                break
            s = field.strip().replace("D", "E").replace("d", "e")
            out[got] = int(s) if kind == "int" else float(s)
            got += 1
    return out


def read_hb(path) -> sp.csc_matrix:
    """Read a Harwell-Boeing file (real or complex, assembled).

    Analog of ``dreadhb``/``zreadhb`` (reference: SRC/double/dreadhb.c).
    Symmetric (\\*SA) and skew (\\*ZA) types are expanded to full storage.
    Pattern-only (P\\*\\*) matrices get unit values.
    """
    with open(path, "r") as f:
        lines = iter(f.readlines())

    next(lines)  # title + key
    card = next(lines).split()
    # HB line 2: TOTCRD PTRCRD INDCRD VALCRD RHSCRD (RHSCRD may be absent)
    rhscrd = int(card[4]) if len(card) >= 5 else 0

    l3 = next(lines)
    mxtype = l3[:3].strip().upper()
    nums = l3[3:].split()
    nrow, ncol, nnz = int(nums[0]), int(nums[1]), int(nums[2])

    l4 = next(lines)
    # formats occupy fixed 16-char fields: PTRFMT INDFMT VALFMT RHSFMT
    ptrfmt = l4[0:16].strip()
    indfmt = l4[16:32].strip()
    valfmt = l4[32:52].strip()
    if rhscrd > 0:
        next(lines)  # RHS descriptor line — RHS ignored (as the reference does)

    colptr = _read_fixed(lines, ptrfmt, ncol + 1, np.int64) - 1
    rowind = _read_fixed(lines, indfmt, nnz, np.int64) - 1

    value_type = mxtype[0]  # R, C, or P
    if value_type == "P" or not valfmt:
        vals = np.ones(nnz, dtype=np.float64)
    elif value_type == "C":
        raw = _read_fixed(lines, valfmt, 2 * nnz, np.float64)
        vals = raw[0::2] + 1j * raw[1::2]
    else:
        vals = _read_fixed(lines, valfmt, nnz, np.float64)

    A = sp.csc_matrix((vals, rowind, colptr), shape=(nrow, ncol))

    sym_type = mxtype[1]  # U, S, Z, H, R
    if sym_type == "S":          # symmetric: lower triangle stored
        A = A + A.T - sp.diags(A.diagonal())
    elif sym_type == "Z":        # skew-symmetric
        A = A - A.T
    elif sym_type == "H":        # hermitian
        A = A + A.conj().T - sp.diags(A.diagonal())
    return A.tocsc()


def read_rb(path) -> sp.csc_matrix:
    """Read a Rutherford-Boeing file (analog of dreadrb.c).

    RB is HB without the RHS card: line 2 has 4 counters, line 4 has 3 formats.
    """
    with open(path, "r") as f:
        lines = iter(f.readlines())
    next(lines)
    next(lines)  # totcrd ptrcrd indcrd valcrd
    l3 = next(lines)
    mxtype = l3[:3].strip().upper()
    nums = l3[3:].split()
    nrow, ncol, nnz = int(nums[0]), int(nums[1]), int(nums[2])
    l4 = next(lines).split()
    ptrfmt, indfmt = l4[0], l4[1]
    valfmt = l4[2] if len(l4) > 2 else ""

    colptr = _read_fixed(lines, ptrfmt, ncol + 1, np.int64) - 1
    rowind = _read_fixed(lines, indfmt, nnz, np.int64) - 1
    if mxtype[0] == "P" or not valfmt:
        vals = np.ones(nnz, dtype=np.float64)
    elif mxtype[0] == "C":
        raw = _read_fixed(lines, valfmt, 2 * nnz, np.float64)
        vals = raw[0::2] + 1j * raw[1::2]
    else:
        vals = _read_fixed(lines, valfmt, nnz, np.float64)
    A = sp.csc_matrix((vals, rowind, colptr), shape=(nrow, ncol))
    if mxtype[1] == "S":
        A = A + A.T - sp.diags(A.diagonal())
    elif mxtype[1] == "Z":
        A = A - A.T
    elif mxtype[1] == "H":
        A = A + A.conj().T - sp.diags(A.diagonal())
    return A.tocsc()


def read_mm(path) -> sp.csc_matrix:
    """Read a MatrixMarket file (analog of dreadMM.c)."""
    from scipy.io import mmread
    return sp.csc_matrix(mmread(path))


def read_triple(path, zero_based: bool = False) -> sp.csc_matrix:
    """Read coordinate text: header ``m n nnz`` (or ``n nnz``) then i j v lines.

    Analog of dreadtriple.c / dreadtriple_noheader.c.
    """
    with open(path, "r") as f:
        first = f.readline().split()
        toks = f.read().split()
    # header form is decided by the first line's token count: "m n nnz"
    # (3 tokens) or "n nnz" (2 tokens) — sniffing the third whitespace
    # token of the whole file misparses integer-valued triples.
    if len(first) >= 3:
        m, n, nnz = int(first[0]), int(first[1]), int(first[2])
        body = first[3:] + toks
    elif len(first) == 2:
        m = n = int(first[0])
        nnz = int(first[1])
        body = toks
    else:
        raise ValueError("read_triple: malformed header line")
    arr = np.array(body[: 3 * nnz])
    i = arr[0::3].astype(np.int64)
    j = arr[1::3].astype(np.int64)
    v = arr[2::3].astype(np.float64)
    if not zero_based:
        i -= 1
        j -= 1
    return sp.csc_matrix((v, (i, j)), shape=(m, n))


def write_binary(path, A) -> None:
    """Write CSC in a compact binary container (analog of dbinary_io.c)."""
    A = sp.csc_matrix(A)
    np.savez_compressed(
        path, shape=np.asarray(A.shape), indptr=A.indptr,
        indices=A.indices, data=A.data)


def read_binary(path) -> sp.csc_matrix:
    z = np.load(path)
    return sp.csc_matrix(
        (z["data"], z["indices"], z["indptr"]),
        shape=tuple(z["shape"]))


def read_matrix(path) -> sp.csc_matrix:
    """Dispatch on file extension (mirrors the example drivers' -s/-m flags)."""
    p = str(path)
    low = p.lower()
    if low.endswith((".rua", ".rsa", ".cua", ".csa", ".pua", ".psa", ".hb")):
        return read_hb(p)
    if low.endswith(".rb"):
        return read_rb(p)
    if low.endswith((".mtx", ".mm")):
        return read_mm(p)
    if low.endswith(".npz"):
        return read_binary(p)
    if low.endswith((".triple", ".dat", ".txt")):
        return read_triple(p)
    raise ValueError(f"unknown matrix format: {p}")
