"""Independent torch-float64 oracle of the full hierarchical ScaML-GP forward.

The reference's numeric engine is torch (``/root/reference/scamlgp/model.py``);
this test re-implements its exact equations — per-task Standardize, source GP
posteriors, weighted source prior (mu_s = sum w_i mu_i, Sigma_s = sum w_i^2
Sigma_i), frozen concat-Standardize, weight pruning, residual target kernel,
exact conditioning (``model.py:359-384``), and the MAP objective
(MLL + hyperpriors, ``utils.py:139-212`` / ``optimizer.py:61-85``) — in plain
torch float64, with no shared code, and pins the JAX implementation against it
at <= 1e-5 (the BASELINE "posterior moments within MC error" check, done
exactly instead of by Monte Carlo).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import gp
from scamlgp_tpu.models import scamlgp as m
from tests.torch_threads import one_thread  # noqa: F401

torch.set_default_dtype(torch.float64)

JITTER = 1e-10  # config.JITTER_F64; oracle replicates the jitter policy


# ---------------------------------------------------------------------------
# torch oracle
# ---------------------------------------------------------------------------

def t_sigmoid_interval(raw, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(torch.as_tensor(raw))


def t_softplus_weights(raw):
    return torch.nn.functional.softplus(torch.as_tensor(raw)) + 1e-10


def t_rbf(x, z, ls, os_):
    xs = x / ls
    zs = z / ls
    d2 = (xs.unsqueeze(-2) - zs.unsqueeze(-3)).pow(2).sum(-1)
    return os_ * torch.exp(-0.5 * d2)


def t_standardize(y):
    """BoTorch Standardize: ddof=1 std, clamped to 1 for n<=1 or tiny std."""
    n = y.shape[0]
    mean = y.mean()
    std = y.std(unbiased=True) if n > 1 else torch.tensor(1.0)
    if n <= 1 or float(std) < 1e-8:
        std = torch.tensor(1.0)
    return mean, std


def t_source_posterior(Xi, yi, ls, os_, noise, P):
    """One source GP's posterior at P in the ORIGINAL y space
    (``model.py:108-135`` via gpytorch exact predictive)."""
    t_mean, t_std = t_standardize(yi)
    y_std = (yi - t_mean) / t_std
    K = t_rbf(Xi, Xi, ls, os_)
    jit = JITTER * (1.0 + K.diagonal().abs().mean())
    A = K + (noise + jit) * torch.eye(Xi.shape[0])
    Ainv = torch.linalg.inv(A)
    Kxp = t_rbf(Xi, P, ls, os_)
    mean = Kxp.T @ (Ainv @ y_std)
    cov = t_rbf(P, P, ls, os_) - Kxp.T @ Ainv @ Kxp
    return t_mean + t_std * mean, (t_std ** 2) * cov


class TorchOracle:
    """Plain-torch ScaML-GP: constructed from raw data + raw parameters."""

    def __init__(self, xs, ys, src_raw, X_t, y_t, tgt_raw, raw_weights,
                 src_cfg, tgt_cfg):
        self.xs = [torch.as_tensor(x) for x in xs]
        self.ys = [torch.as_tensor(np.asarray(y).reshape(-1)) for y in ys]
        self.X_t = torch.as_tensor(X_t)
        self.y_t = torch.as_tensor(np.asarray(y_t).reshape(-1))
        self.M = len(xs)
        self.n = self.X_t.shape[0]

        def constrained(raw, c):
            return t_sigmoid_interval(raw, c.lower, c.upper)

        self.src = []
        for i in range(self.M):
            self.src.append(dict(
                ls=constrained(src_raw.raw_lengthscale[i],
                               src_cfg.lengthscale_constraint),
                os=constrained(src_raw.raw_outputscale[i],
                               src_cfg.outputscale_constraint),
                noise=constrained(src_raw.raw_noise[i],
                                  src_cfg.noise_constraint)))
        self.tgt = dict(
            ls=constrained(tgt_raw.raw_lengthscale,
                           tgt_cfg.lengthscale_constraint),
            os=constrained(tgt_raw.raw_outputscale,
                           tgt_cfg.outputscale_constraint),
            noise=constrained(tgt_raw.raw_noise, tgt_cfg.noise_constraint))
        self.w = t_softplus_weights(raw_weights)
        self.tgt_cfg = tgt_cfg

        # per-task std of ORIGINAL meta Y (pruning statistic, model.py:192-215)
        self.task_stds = torch.stack([t_standardize(y)[1] for y in self.ys])

        # frozen global Standardize over concat(meta Y, target Y)
        # (model.py:261-276); identity if the target is empty (:307-308)
        all_y = torch.cat(self.ys + [self.y_t])
        if self.n > 0:
            self.out_mean, self.out_std = t_standardize(all_y)
        else:
            self.out_mean, self.out_std = torch.tensor(0.0), torch.tensor(1.0)

    def source_mixture(self, P, weights):
        """(sum w_i mu_i(P), sum w_i^2 Sigma_i(P)) in the original space."""
        mean = torch.zeros(P.shape[0])
        cov = torch.zeros(P.shape[0], P.shape[0])
        for i in range(self.M):
            mu_i, cov_i = t_source_posterior(
                self.xs[i], self.ys[i], self.src[i]["ls"], self.src[i]["os"],
                self.src[i]["noise"], P)
            mean = mean + weights[i] * mu_i
            cov = cov + weights[i] ** 2 * cov_i
        return mean, cov

    def pruned_weights(self, threshold):
        w_sigma = self.w * self.task_stds
        norm = w_sigma * self.M / w_sigma.sum()
        return self.w * (norm >= threshold)

    def posterior(self, Xq, pruning_threshold):
        """Eval-mode joint conditioning (``model.py:359-384``), original
        scale."""
        Xq = torch.as_tensor(Xq)
        P = torch.cat([self.X_t, Xq])
        w_eff = self.pruned_weights(pruning_threshold)
        prior_mean, prior_cov = self.source_mixture(P, w_eff)
        mean_std = (prior_mean - self.out_mean) / self.out_std
        cov_std = prior_cov / self.out_std ** 2
        Kt = t_rbf(P, P, self.tgt["ls"], self.tgt["os"])
        cov_full = cov_std + Kt

        n = self.n
        Knn = cov_full[:n, :n]
        jit = JITTER * (1.0 + Knn.diagonal().abs().mean())
        A = Knn + (self.tgt["noise"] + jit) * torch.eye(n)
        Ainv = torch.linalg.inv(A)
        y_std = (self.y_t - self.out_mean) / self.out_std
        resid = y_std - mean_std[:n]
        mean_q = mean_std[n:] + cov_full[:n, n:].T @ (Ainv @ resid)
        cov_q = cov_full[n:, n:] - cov_full[:n, n:].T @ Ainv @ cov_full[:n, n:]
        return (mean_q * self.out_std + self.out_mean,
                cov_q * self.out_std ** 2)

    def map_objective(self):
        """Negative (target MLL + hyperpriors) — training mode: UNPRUNED
        weights, source moments cached at train_X (``model.py:278-289,
        359-363``)."""
        prior_mean, prior_cov = self.source_mixture(self.X_t, self.w)
        mean_std = (prior_mean - self.out_mean) / self.out_std
        cov_std = prior_cov / self.out_std ** 2
        Kt = t_rbf(self.X_t, self.X_t, self.tgt["ls"], self.tgt["os"])
        Knn = cov_std + Kt
        jit = JITTER * (1.0 + Knn.diagonal().abs().mean())
        A = Knn + (self.tgt["noise"] + jit) * torch.eye(self.n)
        y_std = (self.y_t - self.out_mean) / self.out_std
        resid = y_std - mean_std
        L = torch.linalg.cholesky(A)
        alpha = torch.cholesky_solve(resid.unsqueeze(-1), L).squeeze(-1)
        mll = -0.5 * (resid @ alpha + 2.0 * L.diagonal().log().sum()
                      + self.n * math.log(2.0 * math.pi))

        def gamma_lp(x, a, b):
            return (a * math.log(b) - math.lgamma(a)
                    + (a - 1.0) * torch.log(x) - b * x)

        def lognormal_lp(x, mu, s):
            lx = torch.log(x)
            return (-0.5 * ((lx - mu) / s) ** 2 - lx - math.log(s)
                    - 0.5 * math.log(2.0 * math.pi))

        c = self.tgt_cfg
        lp = (lognormal_lp(self.tgt["ls"], c.lengthscale_prior.loc,
                           c.lengthscale_prior.scale).sum()
              + lognormal_lp(self.tgt["os"], c.outputscale_prior.loc,
                             c.outputscale_prior.scale)
              + lognormal_lp(self.tgt["noise"], c.noise_prior.loc,
                             c.noise_prior.scale)
              + gamma_lp(self.w, 1.0, 1.0).sum())
        return -(mll + lp)


# ---------------------------------------------------------------------------
# fixtures: random instances with heterogeneous task sizes
# ---------------------------------------------------------------------------

def _random_instance(seed, M=3, n_target=6, d=2):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(4, 9, size=M)
    xs = [rng.uniform(size=(s, d)) for s in sizes]
    ys = [np.sin(3 * x[:, 0]) + 0.5 * x[:, 1] + 0.1 * rng.standard_normal(len(x))
          for x in xs]
    X_t = rng.uniform(size=(n_target, d))
    y_t = np.sin(3 * X_t[:, 0]) + 0.3 * rng.standard_normal(n_target)
    Xq = rng.uniform(size=(5, d))

    src_raw = gp.GPParams(
        raw_lengthscale=jnp.asarray(rng.normal(-7.0, 0.5, size=(M, d))),
        raw_outputscale=jnp.asarray(rng.normal(-7.0, 0.5, size=(M,))),
        raw_noise=jnp.asarray(rng.normal(0.0, 1.0, size=(M,))))
    tgt_raw = gp.GPParams(
        raw_lengthscale=jnp.asarray(rng.normal(-7.0, 0.5, size=(d,))),
        raw_outputscale=jnp.asarray(rng.normal(-7.5, 0.5)),
        raw_noise=jnp.asarray(rng.normal(0.0, 1.0)))
    # one weight small enough to be pruned at the default threshold
    raw_w = m.weights_inverse(jnp.asarray(
        np.concatenate([rng.uniform(0.3, 1.5, size=M - 1), [1e-6]])))
    return xs, ys, X_t, y_t, Xq, src_raw, tgt_raw, raw_w


def _build_jax_model(xs, ys, X_t, y_t, src_raw, tgt_raw, raw_w,
                     src_cfg, tgt_cfg):
    data = m.pack_task_data(xs, ys, dtype=jnp.float64)
    stack = m.finalize_source_stack(data, src_cfg, src_raw)
    tparams = m.TargetParams(raw_weights=raw_w, gp=tgt_raw)
    return m.build_scamlgp(stack, src_cfg, jnp.asarray(X_t),
                           jnp.asarray(y_t), target_cfg=tgt_cfg,
                           params=tparams)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_posterior_matches_torch_oracle(seed):
    src_cfg, tgt_cfg = gp.source_gp_config(), gp.target_gp_config()
    xs, ys, X_t, y_t, Xq, src_raw, tgt_raw, raw_w = _random_instance(seed)
    model = _build_jax_model(xs, ys, X_t, y_t, src_raw, tgt_raw, raw_w,
                             src_cfg, tgt_cfg)
    oracle = TorchOracle(xs, ys, src_raw, X_t, y_t, tgt_raw,
                         np.asarray(raw_w), src_cfg, tgt_cfg)

    for thresh in (m.DEFAULT_PRUNING_THRESHOLD, 0.0):
        mean_j, cov_j = m.scamlgp_posterior(
            model, src_cfg, tgt_cfg, jnp.asarray(Xq),
            pruning_threshold=thresh)
        mean_t, cov_t = oracle.posterior(Xq, thresh)
        np.testing.assert_allclose(np.asarray(mean_j), mean_t.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cov_j), cov_t.numpy(),
                                   rtol=1e-6, atol=1e-6)

    # the pruning must actually bite for this instance (last weight tiny)
    w_eff = oracle.pruned_weights(m.DEFAULT_PRUNING_THRESHOLD)
    assert float(w_eff[-1]) == 0.0 and float(w_eff[0]) > 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_objective_matches_torch_oracle(seed):
    src_cfg, tgt_cfg = gp.source_gp_config(), gp.target_gp_config()
    xs, ys, X_t, y_t, _, src_raw, tgt_raw, raw_w = _random_instance(seed)
    model = _build_jax_model(xs, ys, X_t, y_t, src_raw, tgt_raw, raw_w,
                             src_cfg, tgt_cfg)
    obj_j = float(m.scamlgp_map_objective(model, tgt_cfg, model.params))
    oracle = TorchOracle(xs, ys, src_raw, X_t, y_t, tgt_raw,
                         np.asarray(raw_w), src_cfg, tgt_cfg)
    obj_t = float(oracle.map_objective())
    assert obj_j == pytest.approx(obj_t, rel=1e-8, abs=1e-6)


def test_empty_target_identity_normalizer():
    """With no target data the outcome transform is the identity
    (``model.py:307-308``) — posterior equals the pure source mixture +
    target prior kernel."""
    src_cfg, tgt_cfg = gp.source_gp_config(), gp.target_gp_config()
    xs, ys, _, _, Xq, src_raw, tgt_raw, raw_w = _random_instance(7)
    X_t = np.zeros((0, 2))
    y_t = np.zeros((0,))
    model = _build_jax_model(xs, ys, X_t, y_t, src_raw, tgt_raw, raw_w,
                             src_cfg, tgt_cfg)
    assert float(model.out_mean) == 0.0 and float(model.out_std) == 1.0

    oracle = TorchOracle(xs, ys, src_raw, X_t, y_t, tgt_raw,
                         np.asarray(raw_w), src_cfg, tgt_cfg)
    w_eff = oracle.pruned_weights(m.DEFAULT_PRUNING_THRESHOLD)
    prior_mean, prior_cov = oracle.source_mixture(torch.as_tensor(Xq), w_eff)
    Kt = t_rbf(torch.as_tensor(Xq), torch.as_tensor(Xq),
               oracle.tgt["ls"], oracle.tgt["os"])
    mean_j, cov_j = m.scamlgp_posterior(model, src_cfg, tgt_cfg,
                                        jnp.asarray(Xq))
    np.testing.assert_allclose(np.asarray(mean_j), prior_mean.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(cov_j), (prior_cov + Kt).numpy(),
                               rtol=1e-6, atol=1e-6)
