"""Block-SMC: posterior + marginal likelihood for a DPMM in one pass.

Config-5 shape (BASELINE.md): rows absorbed in blocks of B with particle
weights tracking the model evidence — O(N/B) device steps, so 1M rows in
blocks of 4096 is ~250 steps.

Run: python examples/smc_evidence.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)  # run from a bare checkout: python examples/<name>.py

import numpy as np
import jax
import jax.numpy as jnp

from common_tpu import models, state as st
from common_tpu.kernels import smc

# synthetic 3-cluster Gaussian data
r = np.random.default_rng(0)
centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
zt = r.integers(0, 3, 5000)
X = (centers[zt] + r.normal(scale=0.6, size=(5000, 2))).astype(np.float32)

defn = st.model_definition(5000, [models.niw(2)], k_max=16)
data = ((jnp.asarray(X), jnp.ones(5000)),)

# 64 particles, blocks of 512 rows -> 10 device steps
parts = smc.init_particles(defn, data, jax.random.key(0), 64,
                           cluster_hp={"alpha": 1.0})
res = smc.run_blocked(parts, data, jax.random.key(1), block=512)

print(f"log evidence estimate: {float(res.logz):.1f}")
print(f"resampling events:     {int(res.n_resamples)}")

# sanity: log Z >= log p(z, data) for ANY z (Gibbs joint-score bound) —
# the invariant the round-4 estimator violated at scale
from common_tpu.kernels import blocked

s_g = st.initialize(defn, data, jax.random.key(9), cluster_hp={"alpha": 1.0})
for i in range(30):
    s_g = blocked.sweep(s_g, data, jax.random.key(20 + i))
bound = float(st.score_joint(s_g))
ok = "OK" if float(res.logz) >= bound else "VIOLATED"
print(f"gibbs joint lower bound: {bound:.1f}  [{ok}]")

# one posterior partition sample ~ final particle weights
s = smc.posterior_sample(jax.random.key(2), res)
z = np.asarray(s.assignments)
agree = ((z[:, None] == z[None, :]) == (zt[:, None] == zt[None, :])).mean()
print(f"co-assignment agreement with truth: {agree:.3f}")
print(f"clusters found: {int((np.asarray(s.counts) > 0).sum())}")

# multi-chip: shard the particle axis over a mesh (collective resampling)
#   mesh = smc.make_particle_mesh()
#   parts, sdata = smc.shard_particles(mesh, parts, data)
#   res = smc.run_blocked_sharded(mesh, parts, sdata, jax.random.key(1))
