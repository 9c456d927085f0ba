"""Normal–Inverse-Wishart likelihood (multivariate Gaussian, conjugate).

Reference analog: `distributions:include/distributions/models/nw.hpp`
(normal_inverse_wishart Shared/Group: add_value/remove_value/score_value/
score_data with per-group mean+scatter suffstats and Student-t predictive),
surfaced through ``common:microscopes/models.py`` as the ``niw`` descriptor.

Vectorized design: suffstats are exact sums ``(n, Σx, ΣxxT)`` with leading
cluster axis; the Student-t predictive and the marginal likelihood are
computed for *all K clusters at once* from batched Cholesky factorizations
(vmapped `jnp.linalg.cholesky` + triangular solves), and the uncollapsed
path scores an [N, K] table via per-cluster matmuls.

Hyperparameters (Murphy, "Conjugate Bayesian analysis of the Gaussian"):
  mu0 [D]   prior mean
  kappa     prior pseudo-count on the mean (reference calls it `lambda`)
  psi [D,D] prior scatter matrix
  nu        prior degrees of freedom (> D - 1)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from common_tpu.utils.linalg import cholesky as _cholesky
from jax.scipy.special import gammaln, multigammaln

from common_tpu.likelihoods import base


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _chol_logdet(chol):
    """log|A| from its Cholesky factor (batched)."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)


def scatter_product(a, b):
    """aᵀ b for the scatter-matrix sums Σ w x xᵀ, accurate to ~2^-16.

    A DEFAULT-precision f32 matmul runs in TF32 on the GPU, which drops
    each input's low mantissa bits: every product shrinks by ~2^-11 on
    average, so the error does not average down over rows (5.7e-4 of a
    cluster's largest entry at 1M x 256, K = 64 on an H100) — for data far
    from the origin a ~1% bias in the scatter about the mean.  Three bf16
    passes (each input split into hi + lo; hi·hi + hi·lo + lo·hi, f32
    sums) stay on the tensor cores at 1.4e-5 there, where full f32 is off
    them and 2.2x slower than TF32 (PERF.md); on the CPU that algorithm
    is plain f32.  XLA's CPU backend rejects it for a dot with a unit
    output dimension (D = 1), so that case, and other dtypes, take a plain
    `highest`-precision product.
    """
    if (a.dtype != jnp.float32 or b.dtype != jnp.float32
            or 1 in (a.shape[-1], b.shape[-1])):
        return jnp.matmul(a.T, b, precision="highest")
    return jnp.matmul(a.T, b,
                      precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3)


class NIW(base.Likelihood):
    name = "niw"
    conjugate = True

    def default_hyper(self):
        # 2-d default; real use passes explicit hypers (models.niw(d))
        return {
            "mu0": jnp.zeros(2),
            "kappa": jnp.asarray(1.0),
            "psi": jnp.eye(2),
            "nu": jnp.asarray(3.0),
        }

    def init_stats(self, hyper, batch_shape):
        d = hyper["mu0"].shape[-1]
        dt = hyper["mu0"].dtype
        return {
            "n": jnp.zeros(batch_shape, dt),
            "sum_x": jnp.zeros((*batch_shape, d), dt),
            "sum_xxT": jnp.zeros((*batch_shape, d, d), dt),
        }

    def tx(self, hyper, x, mask):
        m = jnp.asarray(mask, x.dtype)
        return {"n": m, "sum_x": m * x, "sum_xxT": m * _outer(x, x)}

    def stats_from_assignments(self, hyper, X, mask, gid, K):
        """Scatter-matrix suffstats via per-cluster matmuls.

        Never materializes [N, D, D]: sum_xxT[k] = Xᵀ diag(w_k) X with
        w_k the masked one-hot column of cluster k, computed as a scan of
        [D, N] @ [N, D] matmuls.
        """
        dt = hyper["mu0"].dtype
        X = jnp.asarray(X, dt)
        w = jnp.asarray(mask, dt) * (gid < K)
        onehot = (gid[:, None] == jnp.arange(K)[None, :]).astype(dt) * w[:, None]
        n = jnp.sum(onehot, axis=0)
        sum_x = jnp.matmul(onehot.T, X, precision="float32")

        def per_cluster(_, wk):
            return None, scatter_product(X * wk[:, None], X)

        _, sum_xxT = jax.lax.scan(per_cluster, None, onehot.T)
        return {"n": n, "sum_x": sum_x, "sum_xxT": sum_xxT}

    def stats_from_weights(self, hyper, X, mask, r):
        """Soft-weighted suffstats via per-cluster matmuls (SVI M-step).

        Mirrors stats_from_assignments: never materializes [N, D, D];
        sum_xxT[k] = Xᵀ diag(r_k·mask) X as a scan of matmuls.
        """
        dt = hyper["mu0"].dtype
        X = jnp.asarray(X, dt)
        w = r * jnp.asarray(mask, dt)[:, None]  # [N, K]
        n = jnp.sum(w, axis=0)
        sum_x = jnp.matmul(w.T, X, precision="float32")

        def per_cluster(_, wk):
            return None, scatter_product(X * wk[:, None], X)

        _, sum_xxT = jax.lax.scan(per_cluster, None, w.T)
        return {"n": n, "sum_x": sum_x, "sum_xxT": sum_xxT}

    # -- conjugate exponential family over (mu, Sigma) ---------------------
    # T(theta) = (Lam mu, -1/2 Lam, -1/2 mu' Lam mu, -1/2 log|Sigma|),
    # eta = (kappa mu0, psi + kappa mu0 mu0', kappa, nu + d + 2).
    has_expfam = True

    def nat_params(self, hyper):
        mu0, kappa = hyper["mu0"], hyper["kappa"]
        return {
            "e1": kappa * mu0,
            "e2": hyper["psi"] + kappa * _outer(mu0, mu0),
            "e3": kappa,
            "e4": hyper["nu"] + mu0.shape[-1] + 2.0,
        }

    def log_partition(self, nat):
        d = nat["e1"].shape[-1]
        kappa = nat["e3"]
        nu = nat["e4"] - d - 2.0
        psi = nat["e2"] - _outer(nat["e1"], nat["e1"]) / kappa
        return (
            0.5 * d * (jnp.log(2.0 * jnp.pi) - jnp.log(kappa))
            + 0.5 * nu * d * jnp.log(2.0)
            - 0.5 * nu * jnp.linalg.slogdet(psi)[1]
            + multigammaln(nu / 2.0, d)
        )

    def suffstat_pair(self, hyper, x, mask):
        m = jnp.asarray(mask, x.dtype)
        return {
            "e1": m * x,
            "e2": m * _outer(x, x),
            "e3": m,
            "e4": m,
        }

    def log_h(self, hyper, x, mask):
        d = hyper["mu0"].shape[-1]
        m = jnp.asarray(mask, jnp.float32)
        return -0.5 * d * jnp.log(2.0 * jnp.pi) * m

    # -- posterior NIW parameters from suffstats (broadcasts over batch) --
    def posterior_hyper(self, hyper, stats):
        mu0, kappa, psi, nu = (
            hyper["mu0"], hyper["kappa"], hyper["psi"], hyper["nu"],
        )
        n = stats["n"]
        kappa_n = kappa + n
        mu_n = (kappa * mu0 + stats["sum_x"]) / kappa_n[..., None]
        nu_n = nu + n
        # psi_n = psi + Σ x xT + kappa mu0 mu0T - kappa_n mu_n mu_nT
        psi_n = (
            psi
            + stats["sum_xxT"]
            + kappa * _outer(mu0, mu0)
            - kappa_n[..., None, None] * _outer(mu_n, mu_n)
        )
        # Harden against f32 incremental add/remove drift (SURVEY.md §7
        # "NIW numerics"): long downdate chains can leave sum_xxT slightly
        # asymmetric and psi_n indefinite, which poisons Cholesky/slogdet.
        # Symmetrize exactly and add a relative diagonal jitter (~1e-6 of
        # the mean diagonal — below f32 accumulation noise at any scale).
        # Jitter is gated on n > 0: empty slots hold exact zeros (no drift)
        # and must keep scoring exactly 0 under marginal_loglik.
        d = psi_n.shape[-1]
        psi_n = 0.5 * (psi_n + jnp.swapaxes(psi_n, -1, -2))
        mean_diag = jnp.trace(psi_n, axis1=-2, axis2=-1) / d
        jitter = 1e-6 * mean_diag * (n > 0)
        psi_n = psi_n + jitter[..., None, None] * jnp.eye(
            d, dtype=psi_n.dtype
        )
        return {"mu0": mu_n, "kappa": kappa_n, "psi": psi_n, "nu": nu_n}

    def marginal_loglik(self, hyper, stats):
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)  # symmetrized + jittered
        n = stats["n"]
        # PD log-determinants via the batched-panel Cholesky (XLA's
        # batched slogdet is an LU with the same batch-sequential cost
        # profile the factorization had)
        logdet_psi = _chol_logdet(_cholesky(hyper["psi"]))
        logdet_psi_n = _chol_logdet(_cholesky(post["psi"]))
        ml = (
            -0.5 * n * d * jnp.log(jnp.pi)
            + multigammaln(post["nu"] / 2.0, d)
            - multigammaln(hyper["nu"] / 2.0, d)
            + 0.5 * hyper["nu"] * logdet_psi
            - 0.5 * post["nu"] * logdet_psi_n
            + 0.5 * d * (jnp.log(hyper["kappa"]) - jnp.log(post["kappa"]))
        )
        # Empty-slot exact-zero invariant (CLAUDE.md): the two log-dets
        # above may take DIFFERENT dispatch paths in utils.linalg._cholesky
        # (unbatched prior psi vs batched [K,D,D] posterior psi), so their
        # rounding no longer cancels bitwise at n=0.  Hard-gate: a slot
        # with no data has marginal likelihood exactly 1.
        return jnp.where(n > 0, ml, 0.0)

    def pred_logpdf(self, hyper, stats, x):
        """Student-t posterior predictive, batched over stats' cluster axis."""
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        mu_n, kappa_n, psi_n, nu_n = (
            post["mu0"], post["kappa"], post["psi"], post["nu"],
        )
        df = nu_n - d + 1.0
        scale = ((kappa_n + 1.0) / (kappa_n * df))[..., None, None] * psi_n
        chol = _cholesky(scale)  # batched-panel fast path (utils/linalg.py)
        dev = jnp.broadcast_to(x - mu_n, mu_n.shape)[..., None]
        y = solve_triangular(chol, dev, lower=True)[..., 0]
        quad = jnp.sum(y * y, axis=-1)
        return (
            gammaln((df + d) / 2.0)
            - gammaln(df / 2.0)
            - 0.5 * d * (jnp.log(df) + jnp.log(jnp.pi))
            - 0.5 * _chol_logdet(chol)
            - 0.5 * (df + d) * jnp.log1p(quad / df)
        )

    # -- explicit-parameter path -----------------------------------------
    def sample_params(self, key, hyper, stats):
        """theta = (mu, cov sqrt) ~ NIW posterior, batched over clusters.

        Bartlett decomposition: with L = chol(psi_n), A the Bartlett factor
        of Wishart(nu_n, I), M = L @ A^-T satisfies M M^T ~ IW(nu_n, psi_n).
        """
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        mu_n, kappa_n, psi_n, nu_n = (
            post["mu0"], post["kappa"], post["psi"], post["nu"],
        )
        batch = psi_n.shape[:-2]
        kn, kc, km = jax.random.split(key, 3)
        # Bartlett factor A: lower-tri, diag_i = sqrt(chi2(nu_n - i)), offdiag N(0,1)
        normals = jax.random.normal(kn, (*batch, d, d), psi_n.dtype)
        i = jnp.arange(d, dtype=psi_n.dtype)
        chi_df = jnp.maximum(nu_n[..., None] - i, 1e-3)  # [*, d]
        chi = 2.0 * jax.random.gamma(kc, chi_df / 2.0, dtype=psi_n.dtype)
        A = jnp.tril(normals, -1) + jnp.sqrt(chi)[..., :, None] * jnp.eye(d, dtype=psi_n.dtype)
        L = _cholesky(psi_n)  # batched-panel fast path (utils/linalg.py)
        # M = L @ A^{-T}  (solve A M^T = L^T for M^T; A lower)
        Mt = solve_triangular(A, jnp.swapaxes(L, -1, -2), lower=True)
        M = jnp.swapaxes(Mt, -1, -2)  # M M^T = Sigma ~ IW(nu_n, psi_n)
        z = jax.random.normal(km, (*batch, d), psi_n.dtype)
        mu = mu_n + jnp.einsum("...ij,...j->...i", M, z) / jnp.sqrt(kappa_n)[..., None]
        # canonical lower-tri Cholesky of Sigma = M Mᵀ for fast logpdf.
        # For heavy-tailed ν₀ = d + 2 prior draws (empty clusters) the
        # occasional ‖M‖ ~ 1e4 makes the f32 Gram matrix lose PSD-ness to
        # rounding and cholesky returns NaN (~1e-2 of prior draws at
        # d = 2); retry those slots with a relative diagonal jitter
        # (1e-5 · mean diag ≫ the f32 rounding that broke PSD-ness, and
        # statistically negligible on the affected extreme draws).  A
        # QR-of-Mᵀ factorization would avoid the Gram matrix entirely;
        # that alternative has not been measured on the GPU.
        sigma = jnp.einsum("...ij,...kj->...ik", M, M)
        chol = _cholesky(sigma)
        bad = jnp.isnan(
            jnp.diagonal(chol, axis1=-2, axis2=-1)
        ).any(axis=-1)  # [*batch]
        tr = jnp.einsum("...ii->...", sigma) / d
        eye = jnp.eye(d, dtype=sigma.dtype)
        jitter = (1e-5 * tr + 1e-30)[..., None, None] * eye
        chol2 = _cholesky(sigma + jitter)
        chol = jnp.where(bad[..., None, None], chol2, chol)
        return {"mu": mu, "cov_chol": chol}

    def sample_params_prec(self, key, hyper, stats):
        """theta = (mu, precision, logdet Sigma) ~ NIW posterior.

        Same posterior draw as `sample_params` (identical Bartlett
        construction, same key layout) but returns the PRECISION matrix
        instead of a covariance Cholesky, computed purely from the
        factors already in hand:  with Sigma = M Mᵀ and M = L A⁻ᵀ,
            Sigma⁻¹ = L⁻ᵀ (A Aᵀ) L⁻¹,     log|Sigma| = 2Σlog diag L
                                                       − 2Σlog diag A,
        so the whole draw costs ONE Cholesky (of psi_n) and one
        triangular solve — `sample_params` needs two more Choleskys (plus
        a NaN-retry third) only to produce a canonical triangular factor.
        Consumers that score via the quadratic form (kernels/blocked.py
        `sweep_chains`) don't need that factor, and the Cholesky chain is
        a fixed latency of every multi-chain sweep at small D.
        """
        d = hyper["mu0"].shape[-1]
        post = self.posterior_hyper(hyper, stats)
        mu_n, kappa_n, psi_n, nu_n = (
            post["mu0"], post["kappa"], post["psi"], post["nu"],
        )
        batch = psi_n.shape[:-2]
        kn, kc, km = jax.random.split(key, 3)
        normals = jax.random.normal(kn, (*batch, d, d), psi_n.dtype)
        i = jnp.arange(d, dtype=psi_n.dtype)
        chi_df = jnp.maximum(nu_n[..., None] - i, 1e-3)
        chi = 2.0 * jax.random.gamma(kc, chi_df / 2.0, dtype=psi_n.dtype)
        A = jnp.tril(normals, -1) + jnp.sqrt(chi)[..., :, None] * jnp.eye(
            d, dtype=psi_n.dtype
        )
        L = _cholesky(psi_n)  # batched-panel fast path (utils/linalg.py)
        eye = jnp.eye(d, dtype=psi_n.dtype)
        Li = solve_triangular(L, jnp.broadcast_to(eye, L.shape), lower=True)
        # Sigma^{-1} = (Aᵀ L⁻¹)ᵀ (Aᵀ L⁻¹) = Minvᵀ Minv with M = L A⁻ᵀ the
        # Bartlett covariance factor; Minv doubles as the precision
        # square root (‖Minv (x−μ)‖² is the Mahalanobis form).
        # Symmetrize for safety.  f32 precision is load-bearing:
        # consumers feed `prec` into an expanded quadratic form whose
        # cancellation amplifies input error; a reduced-precision (bf16)
        # einsum here once cut a 4000-row cluster-recovery drive from
        # 1.00 to 0.79 co-assignment agreement.
        minv = jnp.einsum("...ji,...jk->...ik", A, Li, precision="float32")
        prec = jnp.einsum(
            "...ji,...jk->...ik", minv, minv, precision="float32"
        )
        prec = 0.5 * (prec + jnp.swapaxes(prec, -1, -2))
        logdet = 2.0 * (
            jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
            - jnp.sum(jnp.log(jnp.abs(
                jnp.diagonal(A, axis1=-2, axis2=-1)
            )), axis=-1)
        )
        # mu = mu_n + M z / sqrt(kappa_n), M z = L (A^{-T} z)
        z = jax.random.normal(km, (*batch, d), psi_n.dtype)
        y = solve_triangular(
            jnp.swapaxes(A, -1, -2), z[..., None], lower=False
        )
        mu = mu_n + jnp.einsum(
            "...ij,...j->...i", L, y[..., 0]
        ) / jnp.sqrt(kappa_n)[..., None]
        return {"mu": mu, "prec": prec, "logdet": logdet, "minv": minv}

    def logpdf(self, theta, x):
        d = x.shape[-1]
        chol = theta["cov_chol"]
        dev = jnp.broadcast_to(x - theta["mu"], theta["mu"].shape)[..., None]
        y = solve_triangular(chol, dev, lower=True)[..., 0]
        return (
            -0.5 * jnp.sum(y * y, axis=-1)
            - 0.5 * _chol_logdet(chol)
            - 0.5 * d * jnp.log(2.0 * jnp.pi)
        )

    def logpdf_batch(self, theta, X, mask):
        """[N, K] Gaussian log-likelihood table via per-cluster matmuls.

        For each cluster k:  y = (X - mu_k) @ L_k^{-T},  quad = rowsum(y^2).
        Implemented as a scan over K so peak memory stays [N, D].
        """
        d = X.shape[-1]
        const = -0.5 * d * jnp.log(2.0 * jnp.pi)

        def per_cluster(carry, th):
            chol, mu = th["cov_chol"], th["mu"]
            # B = L^{-T}: solve L B = I then transpose -> X @ B as one matmul
            binv = solve_triangular(chol, jnp.eye(d, dtype=X.dtype), lower=True)
            y = (X - mu) @ binv.T
            quad = jnp.sum(y * y, axis=-1)
            logdet = _chol_logdet(chol)
            return carry, const - 0.5 * logdet - 0.5 * quad

        _, cols = jax.lax.scan(per_cluster, None, theta)  # [K, N]
        return cols.T * mask[:, None]

    def sample_value(self, key, theta):
        mu = theta["mu"]
        z = jax.random.normal(key, mu.shape, mu.dtype)
        return mu + jnp.einsum("...ij,...j->...i", theta["cov_chol"], z)

    def prior_logpdf(self, hyper, theta):
        """log NIW(mu, Sigma | hyper) with Sigma = chol @ chol.T."""
        d = hyper["mu0"].shape[-1]
        chol = theta["cov_chol"]
        nu, kappa, psi, mu0 = hyper["nu"], hyper["kappa"], hyper["psi"], hyper["mu0"]
        logdet_sigma = _chol_logdet(chol)
        logdet_psi = jnp.linalg.slogdet(psi)[1]
        # inverse-Wishart density
        psi_b = jnp.broadcast_to(psi, chol.shape)
        sol = solve_triangular(chol, psi_b, lower=True)
        sol = solve_triangular(
            jnp.swapaxes(chol, -1, -2), sol, lower=False
        )  # Sigma^{-1} psi
        trace = jnp.trace(sol, axis1=-2, axis2=-1)
        iw = (
            0.5 * nu * logdet_psi
            - 0.5 * nu * d * jnp.log(2.0)
            - multigammaln(nu / 2.0, d)
            - 0.5 * (nu + d + 1.0) * logdet_sigma
            - 0.5 * trace
        )
        # normal on mu: N(mu0, Sigma/kappa)
        dev = (theta["mu"] - mu0)[..., None]
        y = solve_triangular(chol, dev, lower=True)[..., 0]
        norm = (
            -0.5 * kappa * jnp.sum(y * y, axis=-1)
            - 0.5 * logdet_sigma
            + 0.5 * d * (jnp.log(kappa) - jnp.log(2.0 * jnp.pi))
        )
        return iw + norm


niw = base.register(NIW())
