"""Native (C++) partition machinery vs the pure-Python reference."""

import numpy as np
import pytest

from common_tpu import native, testutil


def _python_partitions(n):
    def rec(prefix, maxg):
        if len(prefix) == n:
            yield tuple(prefix)
            return
        for g in range(maxg + 2):
            yield from rec(prefix + [g], max(maxg, g))

    return list(rec([0], 0))


needs_native = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


def test_bell_numbers():
    truth = {1: 1, 2: 2, 3: 5, 4: 15, 5: 52, 6: 203, 7: 877, 8: 4140,
             10: 115975, 12: 4213597}
    for n, b in truth.items():
        assert native.bell(n) == b, n


@needs_native
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_enumeration_matches_python(n):
    got = native.enumerate_partitions(n)
    want = np.array(_python_partitions(n), np.int32).reshape(-1, n)
    assert got.shape == want.shape
    assert (got == want).all()


@needs_native
def test_canonicalize_batch_matches_python():
    r = np.random.default_rng(0)
    arr = r.integers(0, 7, size=(500, 9)).astype(np.int32)
    got = native.canonicalize_batch(arr)
    for row_in, row_out in zip(arr, got):
        relabel, want = {}, []
        for a in row_in.tolist():
            relabel.setdefault(a, len(relabel))
            want.append(relabel[a])
        assert list(row_out) == want


@needs_native
@pytest.mark.parametrize("n", [2, 4, 6, 8])
def test_rank_roundtrip(n):
    parts = native.enumerate_partitions(n)
    ranks = native.rank_partitions(parts)
    assert (ranks == np.arange(len(parts))).all()


def test_rank_python_fallback_matches():
    import os

    parts = native.enumerate_partitions(5)
    got = native.rank_partitions(parts)
    # force fallback path by computing directly with the numpy ranker
    old = native._LIB, native._TRIED
    try:
        native._LIB, native._TRIED = None, True
        fb = native.rank_partitions(parts)
    finally:
        native._LIB, native._TRIED = old
    assert (got == fb).all()


def test_testutil_uses_native_consistently():
    # permutation_iter must yield identical sequences either way
    via_testutil = list(testutil.permutation_iter(6))
    assert via_testutil == _python_partitions(6)
    # batch canonicalization agrees with the scalar version
    r = np.random.default_rng(1)
    arr = r.integers(0, 5, size=(50, 6))
    batch = testutil.canonicalize_batch(arr)
    scalar = [testutil.permutation_canonical(row) for row in arr]
    assert batch == scalar


def test_csv_loader_matches_numpy(tmp_path):
    """Native multithreaded CSV parse == numpy parse (values + shape),
    across separators, comments, and blank lines."""
    import numpy as np

    from common_tpu.io import load_csv_f32

    r = np.random.default_rng(0)
    X = r.normal(size=(500, 7)).astype(np.float32)
    p = tmp_path / "rows.csv"
    with open(p, "w") as f:
        f.write("# header comment\n\n")
        for i, row in enumerate(X):
            sep = [", ", ";", "\t", " "][i % 4]
            f.write(sep.join(f"{v:.7g}" for v in row) + "\n")
    got = load_csv_f32(str(p), n_threads=3)
    assert got.shape == X.shape
    np.testing.assert_allclose(got, X, rtol=1e-5)


def test_csv_loader_ragged_raises(tmp_path):
    import pytest as _pytest

    from common_tpu import native
    from common_tpu.io import load_csv_f32

    p = tmp_path / "bad.csv"
    with open(p, "w") as f:
        f.write("1,2,3\n4,5\n")
    if native._load() is not None and hasattr(native._load(), "ct_csv_shape"):
        with _pytest.raises(ValueError, match="ragged"):
            load_csv_f32(str(p))
    else:  # numpy fallback raises its own error type
        with _pytest.raises(Exception):
            load_csv_f32(str(p))


def test_csv_loader_fallback_parity(tmp_path, monkeypatch):
    """COMMON_TPU_NO_NATIVE=1 path returns the same values."""
    import numpy as np

    import common_tpu.native as native
    from common_tpu.io import load_csv_f32

    r = np.random.default_rng(1)
    X = r.normal(size=(40, 3)).astype(np.float32)
    p = tmp_path / "rows2.csv"
    np.savetxt(p, X, delimiter=",", fmt="%.7g")
    a = load_csv_f32(str(p))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    b = load_csv_f32(str(p))
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert b.dtype == np.float32


def test_csv_loader_crlf(tmp_path):
    """CRLF line endings parse identically to LF (native + fallback).

    Regression: count_cols once read a trailing '\\r' as field content /
    an extra field, so CRLF files failed with a misleading 'ragged rows'
    error on the native path while the numpy fallback accepted them."""
    import numpy as np

    from common_tpu.io import load_csv_f32

    r = np.random.default_rng(2)
    X = r.normal(size=(30, 4)).astype(np.float32)
    p = tmp_path / "crlf.csv"
    with open(p, "wb") as f:
        f.write(b"# crlf header\r\n\r\n")
        for row in X:
            f.write((",".join(f"{v:.7g}" for v in row)).encode() + b"\r\n")
    got = load_csv_f32(str(p), n_threads=2)
    assert got.shape == X.shape
    np.testing.assert_allclose(got, X, rtol=1e-5)
