"""Multi-chain inference with convergence diagnostics and held-out scoring.

Runs C independent blocked-Gibbs chains of a DPMM-NIW on ONE device via
`blocked.sweep_chains` (the chain axis folded into wide matmuls at small
D),
computes split-R-hat / ESS over the joint-score traces, and reports the
mean posterior-predictive log-likelihood of held-out rows
(`state.heldout_logp` — the BASELINE quality metric) per chain.

Run: python examples/multichain_heldout.py   (~1 min on CPU)
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
from common_tpu.kernels import blocked
from common_tpu.utils import diagnostics

C, n, n_held, d = 4, 4000, 500, 2
r = np.random.default_rng(0)
centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
zt = r.integers(0, 3, n + n_held)
X = (centers[zt] + r.normal(scale=0.6, size=(n + n_held, d))).astype(
    np.float32
)
x_fit, x_held = jnp.asarray(X[:n]), jnp.asarray(X[n:])

defn = st.model_definition(n, [models.niw(d)], k_max=16)
data = ((x_fit, jnp.ones(n, jnp.float32)),)
held = ((x_held, jnp.ones(n_held, jnp.float32)),)

# C chains stacked on the leading axis (vmapped initialize)
states = jax.vmap(
    lambda k: st.initialize(defn, data, k, cluster_hp={"alpha": 1.0})
)(jax.random.split(jax.random.key(0), C))


@jax.jit
def run(states, key, sweeps=80):
    def body(ss, t):
        ss = blocked.sweep_chains(ss, data, jax.random.fold_in(key, t))
        # per-sweep held-out predictive per chain — the convergence
        # summary users care about (joint-score traces are sensitive to
        # transient tiny clusters and over-disperse R-hat)
        lp = jax.vmap(
            lambda c: jnp.mean(st.heldout_logp(
                jax.tree_util.tree_map(lambda l: l[c], ss), held
            ))
        )(jnp.arange(C))
        return ss, (jax.vmap(st.score_joint)(ss), lp)

    return jax.lax.scan(body, states, jnp.arange(sweeps))


states, (scores, lp_trace) = run(states, jax.random.key(1))
scores = np.asarray(scores)[20:]     # [sweeps-20, C]
lp_trace = np.asarray(lp_trace)[20:]

rhat = diagnostics.split_rhat(jnp.asarray(lp_trace.T))
print(f"split-R-hat of the held-out predictive traces: {float(rhat):.4f}")
for c in range(C):
    ess = float(diagnostics.ess(
        jnp.asarray(scores[:, c] - scores[:, c].mean())
    ))
    k_act = int((np.asarray(states.counts[c]) > 0).sum())
    print(
        f"chain {c}: K_active={k_act}  score-ESS={min(ess, len(scores)):.0f}"
        f"  held-out logp/row={lp_trace[-1, c]:.3f}"
    )
