"""The port's matrix readers against the JAX package's, on files each
test writes itself from a seeded matrix: Harwell-Boeing (real,
symmetric, complex, each field at its declared width; and
``scipy.io.hb_write``'s files, which both refuse), Rutherford-Boeing, MatrixMarket (real,
complex, symmetric, pattern), triple (one- and zero-based) and the
binary container; and ``reference_matrix``."""

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from superlu_dist_tpu.utils import io as jio
from superlu_dist_tpu_torch.utils import io as tio
from superlu_dist_tpu_torch.utils import testing as tt


def _matrix(n=30, density=0.15, seed=0, complex_=False):
    """A seeded sparse matrix with a full diagonal and mixed signs."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc")
    A.data = rng.uniform(-4.0, 4.0, A.nnz)
    A = A + sp.diags(rng.uniform(5.0, 9.0, n))
    if complex_:
        B = sp.csc_matrix(A, copy=True)
        B.data = rng.uniform(-2.0, 2.0, B.nnz)
        A = A + 1j * B
    return sp.csc_matrix(A)


def _same(A, B):
    assert A.shape == B.shape and A.dtype == B.dtype
    assert (sp.csc_matrix(A) != sp.csc_matrix(B)).nnz == 0


def _write(kind, tmp_path):
    """(path, the matrix it holds) for each written format."""
    if kind == "hb_real":
        A = _matrix()
        p = tmp_path / "m.rua"
        tt.write_hb(p, A, "RUA")
    elif kind == "hb_symmetric":
        A = _matrix(seed=1)
        A = sp.csc_matrix(A + A.T)
        p = tmp_path / "m.rsa"
        tt.write_hb(p, sp.tril(A, format="csc"), "RSA")
    elif kind == "hb_complex":
        A = _matrix(seed=2, complex_=True)
        p = tmp_path / "m.cua"
        tt.write_hb(p, A, "CUA")
    elif kind == "rb_real":
        A = _matrix(seed=3)
        p = tmp_path / "m.rb"
        tt.write_hb(p, A, "rua", rb=True)
    elif kind == "mm_real":
        A = _matrix(seed=4)
        p = tmp_path / "m.mtx"
        scipy.io.mmwrite(str(p), A)
    elif kind == "mm_complex":
        A = _matrix(seed=5, complex_=True)
        p = tmp_path / "m.mtx"
        scipy.io.mmwrite(str(p), A)
    elif kind == "mm_symmetric":
        A = _matrix(seed=6)
        A = sp.csc_matrix(A + A.T)
        p = tmp_path / "m.mtx"
        scipy.io.mmwrite(str(p), A, symmetry="symmetric")
    elif kind == "mm_pattern":
        A = _matrix(seed=7)
        A.data[:] = 1.0
        scipy.io.mmwrite(str(tmp_path / "m.mtx"), A, field="pattern")
        p = (tmp_path / "m.mtx").rename(tmp_path / "m.mm")
    elif kind == "triple":
        A = sp.coo_matrix(_matrix(seed=8))
        p = tmp_path / "m.triple"
        p.write_text(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n" + "".join(
            f"{i + 1} {j + 1} {float(v)!r}\n"
            for i, j, v in zip(A.row, A.col, A.data)))
    elif kind == "triple_n_nnz":
        A = sp.coo_matrix(_matrix(seed=9))
        p = tmp_path / "m.dat"
        p.write_text(f"{A.shape[0]} {A.nnz}\n" + "".join(
            f"{i + 1} {j + 1} {float(v)!r}\n"
            for i, j, v in zip(A.row, A.col, A.data)))
    elif kind == "binary":
        A = _matrix(seed=10, complex_=True)
        p = tmp_path / "m.npz"
        tio.write_binary(p, A)
    return p, sp.csc_matrix(A)


@pytest.mark.parametrize("kind", [
    "hb_real", "hb_symmetric", "hb_complex", "rb_real", "mm_real",
    "mm_complex", "mm_symmetric", "mm_pattern", "triple", "triple_n_nnz",
    "binary"])
def test_read_matrix_matches_jax(tmp_path, kind):
    p, A = _write(kind, tmp_path)
    B = tio.read_matrix(p)
    _same(B, jio.read_matrix(p))
    assert B.shape == A.shape
    assert np.abs((B - A).toarray()).max() <= 1e-11 * np.abs(A.data).max()


@pytest.mark.parametrize("zero_based", [False, True])
def test_read_triple_matches_jax(tmp_path, zero_based):
    A = sp.coo_matrix(_matrix(seed=11))
    off = 0 if zero_based else 1
    p = tmp_path / "m.txt"
    p.write_text(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n" + "".join(
        f"{i + off} {j + off} {float(v)!r}\n"
        for i, j, v in zip(A.row, A.col, A.data)))
    B = tio.read_triple(p, zero_based=zero_based)
    _same(B, jio.read_triple(p, zero_based=zero_based))
    _same(B, sp.csc_matrix(A))


def test_binary_round_trip_both_ways(tmp_path):
    A = _matrix(seed=12)
    tio.write_binary(tmp_path / "t.npz", A)
    jio.write_binary(tmp_path / "j.npz", A)
    _same(tio.read_binary(tmp_path / "j.npz"), A)
    _same(jio.read_binary(tmp_path / "t.npz"), A)
    _same(tio.read_binary(tmp_path / "t.npz"), A)


@pytest.mark.parametrize("k", [4, 6])
def test_scipy_hb_write_is_refused_as_by_jax(tmp_path, k):
    """``scipy.io.hb_write`` declares its values E25.16 (E15.7 for float32
    data) but writes them one character narrower, so a fixed field
    straddles two numbers: the port's reader raises there, as the JAX
    package's does, rather than guess where the numbers lie."""
    A = tt.laplacian_3d(k).astype(np.float32)
    p = tmp_path / "lap.rua"
    scipy.io.hb_write(str(p), A)
    with pytest.raises(ValueError):
        jio.read_matrix(p)
    with pytest.raises(ValueError):
        tio.read_matrix(p)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_hb_round_trips(tmp_path, dtype):
    """``utils/testing.py::write_hb`` keeps the declared widths, and its
    values round-trip float64 exactly."""
    A = _matrix(seed=14).astype(dtype)
    tt.write_hb(tmp_path / "w.rua", A)
    B = tio.read_matrix(tmp_path / "w.rua")
    _same(B, jio.read_matrix(tmp_path / "w.rua"))
    _same(B, sp.csc_matrix(A, dtype=np.float64))


def test_fixed_width_fields_parse_as_the_jax_reader_does():
    """Lines that parse at their declared width, the short last line
    included, read as the JAX package's reader reads them."""
    lines = ["   1.5000000E+00  -2.2500000D+00   3.0000000E-01",
             "  -4.0000000E+02"]
    got = tio._read_fixed(iter(lines), "(3E16.7)", 4, np.float64)
    ref = jio._read_fixed(iter(lines), "(3E16.7)", 4, np.float64)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, [1.5, -2.25, 0.3, -400.0])


def test_unknown_extension_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown matrix format"):
        tio.read_matrix(tmp_path / "m.xyz")


def test_reference_matrix_unset_is_none(monkeypatch):
    monkeypatch.setattr(tt, "REFERENCE_EXAMPLE_DIR", None)
    assert tt.reference_matrix("g20.rua") is None


def test_reference_matrix_absent_is_none(tmp_path, monkeypatch):
    monkeypatch.setattr(tt, "REFERENCE_EXAMPLE_DIR", str(tmp_path))
    assert tt.reference_matrix("g20.rua") is None


def test_reference_matrix_reads_the_fixture(tmp_path, monkeypatch):
    A = _matrix(seed=13)
    tt.write_hb(tmp_path / "g.rua", A, "RUA")
    monkeypatch.setattr(tt, "REFERENCE_EXAMPLE_DIR", str(tmp_path))
    B = tt.reference_matrix("g.rua")
    _same(B, jio.read_matrix(tmp_path / "g.rua"))
