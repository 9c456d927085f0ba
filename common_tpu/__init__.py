"""common_tpu — probabilistic-programming foundation for accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``datamicroscopes/common`` (reference: github.com/datamicroscopes/common):
Dirichlet-process mixture bookkeeping, conjugate exponential-family
likelihoods, MCMC kernels (collapsed Gibbs, blocked/uncollapsed Gibbs,
slice, grid hyper-Gibbs, HMC/NUTS, SMC, SVI), posterior query utilities,
and exact-enumeration test machinery — all as pure functions over pytrees
with static shapes, designed for `jit`/`vmap`/`shard_map` over device meshes.

Reference layer map (see SURVEY.md and README.md):
  - likelihoods/    <- distributions lib + common:include/microscopes/models/
                       (+ expfam.py: natural-param machinery for SVI)
  - state.py        <- common:include/microscopes/common/group_manager.hpp
                       + entity_state.hpp (entity_based_state_object)
  - data/           <- common recarray/sparse_ndarray/variadic dataviews
  - kernels/        <- kernels repo (gibbs.pyx, slice.pyx) + north-star
                       extras: blocked.py, hmc.py, smc.py, svi.py
  - models.py       <- common:microscopes/models.py descriptor registry
  - scalar_functions.py <- common:include/microscopes/common/scalar_functions.hpp
  - query.py        <- common:microscopes/common/query.py
  - testutil.py     <- common:microscopes/common/testutil.py
  - validator.py    <- common:microscopes/common/validator.py
  - relational/     <- irm sibling repo (IRM states + kernels)
  - topic/          <- lda sibling repo (HDP-LDA)
  - parallel/       <- (new) chain/data mesh sharding
  - ops/            <- (new) hand-written Pallas GPU kernel (fused assign)
  - io/             <- schema.proto serialization -> pytree checkpoints
  - native/         <- C++ host-side oracle machinery (ctypes)
  - utils/          <- diagnostics (ESS/R-hat), profiling
"""

from common_tpu import validator  # noqa: F401
from common_tpu.rng import rng  # noqa: F401
from common_tpu import models  # noqa: F401

__version__ = "0.1.0"
