"""User-facing model descriptor registry.

Rebuild of ``common:microscopes/models.py``: the reference exposes a zoo of
`model_descriptor` objects (``bb``, ``niw``, ``gp``, ``nich``, ``dd(n)``,
``dm(n)``, ``bnb``, ``bbnc``), each pairing a likelihood implementation
with default hyperparameters and the runtime type of its data column.  The
reference's dual ``py_desc``/``c_desc`` backends (pure-python debug vs C++)
map here onto the JAX implementation (:mod:`common_tpu.likelihoods`) vs the
scipy/numpy oracle used by the test-suite cross-checks
(``tests/ref_impls.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

from common_tpu import runtime_types as rt
from common_tpu import validator
from common_tpu.likelihoods import base as _base
from common_tpu import likelihoods as _lik


@dataclass(frozen=True)
class model_descriptor:
    """A likelihood + its default hyperparameters + its data-column schema."""

    likelihood: _base.Likelihood
    default_hyper: Dict[str, Any] = field(default_factory=dict)
    rtype: rt.runtime_type = rt.TYPE_F32

    @property
    def name(self) -> str:
        return self.likelihood.name

    def with_hyper(self, **hyper) -> "model_descriptor":
        merged = {**self.default_hyper, **hyper}
        return model_descriptor(self.likelihood, merged, self.rtype)

    def canonical_hyper(self, hyper: Dict[str, Any] | None = None):
        """Merge user hyper over defaults and canonicalize to jnp arrays."""
        merged = {**self.default_hyper, **(hyper or {})}
        return self.likelihood.validate_hyper(merged)

    def __repr__(self):
        return f"<model {self.name} {self.rtype.dtype}{self.rtype.shape}>"


# --- the zoo (names/shapes mirror the reference registry) -----------------

bb = model_descriptor(
    _lik.bb, {"alpha": 1.0, "beta": 1.0}, rt.TYPE_B
)

bbnc = model_descriptor(
    _lik.bbnc, {"alpha": 1.0, "beta": 1.0}, rt.TYPE_B
)

gp = model_descriptor(
    _lik.gp, {"alpha": 1.0, "inv_beta": 1.0}, rt.TYPE_I32
)

nich = model_descriptor(
    _lik.nich,
    {"mu": 0.0, "kappa": 1.0, "sigmasq": 1.0, "nu": 1.0},
    rt.TYPE_F32,
)

bnb = model_descriptor(
    _lik.bnb, {"alpha": 1.0, "beta": 1.0, "r": 1.0}, rt.TYPE_I32
)


def niw(dim: int) -> model_descriptor:
    """Normal–Inverse-Wishart over R^dim (multivariate Gaussian rows)."""
    validator.validate_positive(dim, "niw dim")
    hyper = {
        "mu0": np.zeros(dim, np.float32),
        "kappa": 1.0,
        "psi": np.eye(dim, dtype=np.float32),
        "nu": float(dim),
    }
    return model_descriptor(_lik.niw, hyper, rt.vector(rt.TYPE_F32, dim))


def bbv(d: int) -> model_descriptor:
    """d independent Beta-Bernoulli binary columns as ONE vector feature.

    The vectorized encoding of the reference's "d scalar bb features"
    pattern (config-2 binary feature matrices): identical posterior,
    per-column (alpha, beta) hypers, matmul-formulated scoring.
    """
    validator.validate_positive(d, "bbv columns")
    return model_descriptor(
        _lik.bbv,
        {"alpha": np.ones(d, np.float32), "beta": np.ones(d, np.float32)},
        rt.vector(rt.TYPE_B, d),
    )


def dd(n: int) -> model_descriptor:
    """Dirichlet–Discrete over n categories."""
    validator.validate_positive(n, "dd categories")
    return model_descriptor(
        _lik.dd, {"alphas": np.ones(n, np.float32)}, rt.TYPE_I32
    )


def dm(n: int) -> model_descriptor:
    """Dirichlet–Multinomial over n categories (rows are count vectors)."""
    validator.validate_positive(n, "dm categories")
    return model_descriptor(
        _lik.dm, {"alphas": np.ones(n, np.float32)}, rt.vector(rt.TYPE_I32, n)
    )
