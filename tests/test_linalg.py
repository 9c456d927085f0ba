"""Batched-panel Cholesky (utils/linalg.py) agreement battery.

The blocked batch factorization replaces XLA's cholesky in the NIW hot
paths at large batch x dim; these tests pin it to XLA's
semantics: factor agreement across shapes/panels, padding path, NaN
propagation on non-PSD input, and the size dispatcher.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from common_tpu.utils import linalg


def _psd(b, d, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    A = r.normal(size=(b, d, max(d // 2, 2))).astype(dtype)
    return A @ np.swapaxes(A, -1, -2) + d * np.eye(d, dtype=dtype)


@pytest.mark.parametrize("b,d,panel", [
    (4, 8, 64), (16, 64, 64), (8, 256, 64), (8, 256, 128),
    (3, 100, 64),  # padding path (100 % 64 != 0)
    (5, 96, 32),
])
def test_matches_xla_cholesky(b, d, panel):
    M = _psd(b, d, seed=b + d)
    L = np.asarray(linalg.cholesky_batched(jnp.asarray(M), panel=panel))
    Lref = np.linalg.cholesky(M)
    np.testing.assert_allclose(L, Lref, rtol=2e-4, atol=2e-4)
    # exact zeros above the diagonal
    assert (np.triu(L, 1) == 0).all()


def test_leading_batch_shapes():
    M = _psd(6, 64, seed=0).reshape(2, 3, 64, 64)
    L = np.asarray(linalg.cholesky_batched(jnp.asarray(M)))
    np.testing.assert_allclose(
        L, np.linalg.cholesky(M), rtol=2e-4, atol=2e-4
    )


def test_nan_propagation_matches_xla():
    """Non-PSD input must yield NaN on the factor diagonal (the NIW
    sampler's jitter-retry detection depends on it)."""
    M = _psd(4, 64, seed=1)
    M[2] -= 3 * 64 * np.eye(64, dtype=np.float32)  # make index 2 indefinite
    L = np.asarray(linalg.cholesky_batched(jnp.asarray(M)))
    diag = np.diagonal(L, axis1=-2, axis2=-1)
    assert np.isnan(diag[2]).any()
    ok = [0, 1, 3]
    assert np.isfinite(diag[ok]).all()
    np.testing.assert_allclose(
        L[ok], np.linalg.cholesky(M[ok]), rtol=2e-4, atol=2e-4
    )


def test_dispatcher_routes_both_paths():
    small = _psd(2, 8, seed=2)
    big = _psd(64, 64, seed=3)
    for M in (small, big):
        L = np.asarray(linalg.cholesky(jnp.asarray(M)))
        np.testing.assert_allclose(
            L, np.linalg.cholesky(M), rtol=2e-4, atol=2e-4
        )
