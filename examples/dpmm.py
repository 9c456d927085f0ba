"""Dirichlet-process mixture on synthetic 2-D Gaussians (BASELINE config 1).

Run: python examples/dpmm.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)  # run from a bare checkout: python examples/<name>.py

import numpy as np
import jax
import jax.numpy as jnp

from common_tpu import models, query, scalar_functions as sf, state as st
from common_tpu.runner import runner

rng = np.random.default_rng(0)
centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
z_true = rng.integers(0, 3, 600)
X = (centers[z_true] + rng.normal(scale=0.6, size=(600, 2))).astype(np.float32)

defn = st.model_definition(600, [models.niw(2)], k_max=32)
data = ((jnp.asarray(X), jnp.ones(600)),)
s = st.initialize(defn, data, jax.random.key(42), cluster_hp={"alpha": 1.0})

r = runner(defn, data, s, [
    ("assign", {}),                                # exact collapsed Gibbs
    ("grid_cluster_hp", {"prior": sf.log_exponential(1.0),
                         "grid": np.geomspace(0.1, 10, 30)}),
], jsonl_path="dpmm_sweeps.jsonl")
out = r.run(jax.random.key(1), 60)

co = query.zmatrix(r.assignment_trace[-20:]) > 0.5
agree = (co == (z_true[:, None] == z_true[None, :])).mean()
print(f"k_active = {int((np.asarray(out.counts) > 0).sum())}  "
      f"alpha = {float(out.cluster_hp['alpha']):.2f}  "
      f"co-assignment agreement = {agree:.3f}")

# posterior-predictive draws from the fitted model
pp, _ = st.sample_post_pred(out, jax.random.key(2), size=5)
print("posterior-predictive rows:\n", np.asarray(pp[0][0]).round(2))
