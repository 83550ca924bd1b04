"""Shared inputs of the posterior-fit parity tests (``test_torch_hmc.py``,
``test_torch_vi.py``; not a test module).

- ``target_models``: the ScaML-GP target of ``tests/test_hmc.py:72-81``
  (2 meta-tasks x 16 points, d=1, 5 target points) on a fixed data seed,
  as the port's model and the JAX model holding the same arrays.
- ``JCFG``, ``TCFG``: the target GP config of each package.
- The ``*_draws`` functions rebuild, from a JAX key, the random numbers
  that a JAX sampler draws from it, in the order in which it splits the
  key, as the tensors the port's samplers take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import hmc as thmc
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.models import vi as tvi

F64 = jnp.float64
JCFG, TCFG = jgp.target_gp_config(), tgp.target_gp_config()


def target_models(seed: int = 4):
    """(JAX model, port model): the same target model in both packages.
    The port meta-fits the source GPs (1 restart, 20 L-BFGS steps, as the
    JAX test does) and builds the target model; the JAX model holds the
    same arrays (a JAX meta-fit and build would cost long compiles)."""
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(size=(16, 1)) for _ in range(2)]
    ys = [np.sin(6 * x[:, 0]) for x in xs]
    stack, cfg = tm.meta_fit_scamlgp(
        xs, ys, torch.Generator().manual_seed(1),
        num_restarts_log_likelihood=1, num_steps=20, device="cpu")
    Xt = rng.uniform(size=(5, 1))
    yt = np.sin(6 * Xt[:, 0])
    tmodel = tm.build_scamlgp(stack, cfg, tensor(Xt), tensor(yt))
    return to_jax(tmodel), tmodel


def to_jax(tree):
    """A port structure (NamedTuples of tensors, nested) as the JAX
    package's structure of the same class name."""
    cls = getattr(jm, type(tree).__name__, None) or getattr(
        jgp, type(tree).__name__)
    return cls(*[to_jax(v) if isinstance(v, tuple) else
                 jnp.asarray(v.detach().numpy()) for v in tree])


def tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def chain_keys(key, num_chains: int):
    """Each chain's (init key, run key), as the JAX package splits them
    (``hmc.py:368-372``, ``:401-405``, ``campaign.py:202-205``)."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, num_chains))
    return pairs[:, 0], pairs[:, 1]


def target_inits(keys, tcfg, M: int, d: int):
    """Prior-drawn chain starts of the target parameters, one a key."""
    draws = jax.vmap(lambda k: jm.sample_target_params(tcfg, k, M, d, F64))(
        keys)
    return draws, convert.target_params(convert.to_numpy_dict(draws),
                                        device="cpu")


def hmc_draws(run_keys, T: int, dim: int) -> thmc.HMCDraws:
    """HMC's draws of each chain from its run key (``hmc.py:100-101,164``):
    T transitions' momentum normals and accept uniforms."""
    def one(key):
        ks = jax.vmap(jax.random.split)(jax.random.split(key, T + 1)[:T])
        mom = jax.vmap(lambda k: jax.random.normal(k, (dim,), F64))(ks[:, 0])
        u = jax.vmap(lambda k: jax.random.uniform(k, dtype=F64))(ks[:, 1])
        return mom, u

    mom, u = jax.jit(jax.vmap(one))(run_keys)
    return thmc.HMCDraws(momentum=tensor(mom), uniform=tensor(u))


def nuts_draws(run_keys, T: int, dim: int, max_depth: int) -> thmc.NUTSDraws:
    """NUTS's draws of each chain from its run key (``hmc.py:232-235,268,
    289,313``): per transition the momentum normals and first direction,
    then per leapfrog step a pick uniform and the next subtree's
    direction (drawn every step, used on a subtree's completion)."""
    K = 2 ** max_depth - 1

    def one(key):
        ks = jax.random.split(key, T)
        three = jax.vmap(lambda k: jax.random.split(k, 3))(ks)
        mom = jax.vmap(lambda k: jax.random.normal(k, (dim,), F64))(
            three[:, 0])
        dir0 = jax.vmap(jax.random.bernoulli)(three[:, 1])
        run = three[:, 2]
        picks, dirs = [], []
        for _ in range(K):
            run, k_pick = jnp.moveaxis(jax.vmap(jax.random.split)(run), 1, 0)
            picks.append(jax.vmap(lambda k: jax.random.uniform(
                k, dtype=F64))(k_pick))
            run, k_dir = jnp.moveaxis(jax.vmap(jax.random.split)(run), 1, 0)
            dirs.append(jax.vmap(jax.random.bernoulli)(k_dir))
        return mom, dir0, jnp.stack(picks, -1), jnp.stack(dirs, -1)

    mom, dir0, pick, dirs = jax.jit(jax.vmap(one))(run_keys)

    def sign(b):
        return tensor(np.where(np.asarray(b), 1.0, -1.0))

    return thmc.NUTSDraws(momentum=tensor(mom), direction0=sign(dir0),
                          pick=tensor(pick), direction=sign(dirs))


def advi_eps(key, num_steps: int, num_mc: int, dim: int) -> torch.Tensor:
    """ADVI's reparametrization draws (``vi.py:92,128``): (steps, mc, D)."""
    keys = jax.random.split(key, num_steps)
    return tensor(jax.vmap(lambda k: jax.random.normal(
        k, (num_mc, dim), F64))(keys))


def q_normals(key, num_samples: int, dim: int) -> torch.Tensor:
    """``sample_q``'s normals (``vi.py:136``): (num_samples, D)."""
    return tensor(jax.random.normal(key, (num_samples, dim), F64))


def vi_draws(key, num_steps: int, num_mc: int, num_draws: int,
             dim: int) -> tvi.VIDraws:
    """``fit_scamlgp_vi``'s draws (``vi.py:159``): the fit's eps, then the
    mixture's normals."""
    k_fit, k_draw = jax.random.split(key)
    return tvi.VIDraws(eps=advi_eps(k_fit, num_steps, num_mc, dim),
                       sample=q_normals(k_draw, num_draws, dim))
