"""Clustering an [n, d] binary feature matrix (BASELINE config 2).

Uses the vector Beta-Bernoulli likelihood `bbv(d)` — the vectorized
packing of the reference's "d scalar bb features" pattern: identical
posterior, per-column (alpha, beta) hypers, and the whole [N, K] score
table computed as one matmul.  Hyperparameters are slice-sampled
coordinate-wise each sweep.

Run: python examples/binary_matrix.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)  # run from a bare checkout: python examples/<name>.py

import numpy as np
import jax
import jax.numpy as jnp

from common_tpu import models, scalar_functions as sf, state as st
from common_tpu.kernels import blocked, slice_

r = np.random.default_rng(0)
n, d = 2000, 24
probs = np.where(r.uniform(size=(4, d)) < 0.5, 0.1, 0.9)
zt = r.integers(0, 4, n)
X = (r.uniform(size=(n, d)) < probs[zt]).astype(np.float32)

defn = st.model_definition(n, [models.bbv(d)], k_max=16)
data = ((jnp.asarray(X), jnp.ones(n)),)
s = st.initialize(defn, data, jax.random.key(0), cluster_hp={"alpha": 1.0})

# NOTE: with the uncollapsed blocked sweep, keep slice bounds moderate
# (>= 0.5): hyper draws fitted to mixed early-sweep stats otherwise make
# empty-slot prior draws extreme and the sampler cannot seed clusters.
specs = {0: {
    "alpha": {"prior": sf.log_exponential(1.0), "w": 0.5,
              "bounds": (0.5, 50.0)},
    "beta": {"prior": sf.log_exponential(1.0), "w": 0.5,
             "bounds": (0.5, 50.0)},
}}
cluster = {"prior": sf.log_exponential(1.0), "w": 0.5, "bounds": (1e-3, 1e3)}

for i in range(50):
    k = jax.random.fold_in(jax.random.key(1), i)
    s = blocked.sweep(s, data, jax.random.fold_in(k, 0))
    s = slice_.hp(s, data, jax.random.fold_in(k, 1), specs, cluster=cluster)

z = np.asarray(s.assignments)
agree = ((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).mean()
print(f"clusters found: {int((np.asarray(s.counts) > 0).sum())} (truth: 4)")
print(f"co-assignment agreement: {agree:.3f}")
print(f"CRP alpha after slice:   {float(s.cluster_hp['alpha']):.2f}")
