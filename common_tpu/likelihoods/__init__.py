"""Likelihood registry — pure-functional exponential-family model library.

JAX rebuild of the reference's likelihood layer: the `distributions`
C++ library's Shared/Group model structs plus the adapter hierarchy in
``common:include/microscopes/models/``.  See ``base.py`` for the interface.
"""

from common_tpu.likelihoods.base import (  # noqa: F401
    Likelihood,
    fold,
    get,
    names,
    register,
    scatter_fold,
    zero_slot,
)
from common_tpu.likelihoods.bb import bb  # noqa: F401
from common_tpu.likelihoods.bbnc import bbnc  # noqa: F401
from common_tpu.likelihoods.bbv import bbv  # noqa: F401
from common_tpu.likelihoods.bnb import bnb  # noqa: F401
from common_tpu.likelihoods.dd import dd  # noqa: F401
from common_tpu.likelihoods.dm import dm  # noqa: F401
from common_tpu.likelihoods.gp import gp  # noqa: F401
from common_tpu.likelihoods.nich import nich  # noqa: F401
from common_tpu.likelihoods.niw import niw  # noqa: F401
