"""Port parity: the headline step's stages (``profile_headline``) against
the JAX package's functions, in float64 on the CPU, at B = 4, N = 8, D = 2.

Each stage's unscaled value, and its gradient where it has one, equals the
JAX computation of the same stage (``scripts/bench_profile_headline.py``,
its functions vmapped over the batch) at rtol 1e-8.  The JAX sweep route's
gradient fails on its scalar ``n_active`` (the reference fault of ROADMAP
queue 3), so ``mll_vg_sweep``'s gradient is held against the ``chol``
route's, its value against the JAX sweep forward.  On the CPU the sweep
stages take the plain version, as every CPU tensor does; the kernel's
launches are counted on the card only (the chip smoke's ``entry`` phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.ops import inverse_mll as jinv
from scamlgp_tpu.ops import kernels as jK
from scamlgp_tpu.ops import linalg as jlinalg
from scamlgp_tpu.ops import pallas_sweep as jps
from scamlgp_tpu_torch import profile_headline as ph
from tests.torch_threads import one_thread  # noqa: F401

B, N, D = 4, 8, 2
RTOL = 1e-8


def close(a, b, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def ins():
    return ph.inputs(B, N, D, torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jins(ins):
    """The same inputs as JAX arrays."""
    cfg = jgp.source_gp_config()
    p = jgp.GPParams(*[jnp.asarray(leaf.numpy()) for leaf in ins["params"]])
    return cfg, p, *(jnp.asarray(ins[k].numpy()) for k in ("X", "y", "A0"))


def _np(t):
    return t.detach().numpy()


def test_inputs_are_the_scripts_draws(ins):
    """X, y and A0 are the JAX script's ``default_rng(0)`` draws in its
    order (its A0 is built in float32; here in the inputs' dtype)."""
    rng = np.random.default_rng(0)
    close(_np(ins["X"]), rng.uniform(size=(B, N, D)), rtol=0, atol=0)
    close(_np(ins["y"]), rng.normal(size=(B, N)), rtol=0, atol=0)
    A0 = rng.normal(size=(B, N, N))
    A0 = (A0 @ A0.transpose(0, 2, 1)) / N + 2.0 * np.eye(N)
    close(_np(ins["A0"]), A0, rtol=0, atol=0)
    assert sorted(ph.STAGE_FNS) == sorted(ph.STAGES)


def _jax_vg(f, p, *data):
    return jax.vmap(jax.value_and_grad(f))(p, *data)


def _close_grads(tg, jg):
    for a, b in zip(tg, jg):
        close(_np(a), b)


def test_gram_vg(ins, jins):
    cfg, p, X, _, _ = jins

    def one(pp, x):
        c = jgp.constrain(cfg, pp)
        return jnp.sum(jK.gram(cfg.kernel, x, x, c.lengthscale,
                               c.outputscale))

    jv, jg = _jax_vg(one, p, X)
    v, g = ph.gram_vg(ins, torch.zeros((), dtype=torch.float64))
    close(_np(v), jv)
    _close_grads(g, jg)
    assert not g.raw_noise.any()


def test_inverse_fwd(ins, jins):
    jinv_, jlogdet = jps._sweep_inverse_impl(jins[4])
    inv, logdet = ph.inverse_fwd(ins, torch.zeros((), dtype=torch.float64))
    close(_np(inv), jinv_)
    close(_np(logdet), jlogdet)


@pytest.mark.parametrize("method", ["sweep", "chol"])
def test_mll_vg(ins, jins, method):
    cfg, p, X, y, _ = jins

    def obj(m):
        return lambda pp, x, yy: jgp.map_objective(cfg, pp, x, yy, method=m)

    jv = jax.vmap(obj(method))(p, X, y)
    _, jg = _jax_vg(obj("chol"), p, X, y)
    v, g = ph.STAGE_FNS[f"mll_vg_{method}"](
        ins, torch.zeros((), dtype=torch.float64))
    close(_np(v), jv)
    _close_grads(g, jg)


def test_mll_fwd_sweep(ins, jins):
    cfg, p, X, y, _ = jins
    jv = jax.vmap(lambda pp, x, yy: jgp.mll(cfg, pp, x, yy,
                                            method="sweep"))(p, X, y)
    with torch.no_grad():
        v = ph.mll_fwd_sweep(ins, torch.zeros((), dtype=torch.float64))
    close(_np(v), jv)


def test_assemble_fwd(ins, jins):
    cfg, p, X, _, _ = jins

    def one(pp, x):
        c = jgp.constrain(cfg, pp)
        K = jK.gram(cfg.kernel, x, x, c.lengthscale, c.outputscale)
        return jnp.sum(jlinalg.mask_system(K, c.noise, None))

    v = ph.assemble_fwd(ins, torch.zeros((), dtype=torch.float64))
    close(_np(v), jax.vmap(one)(p, X))


def test_mll_via_inv_preA(ins, jins):
    _, _, _, y, A0 = jins
    jv = jinv.mll_via_inverse(A0, y, jnp.asarray(float(N)))
    with torch.no_grad():
        v = ph.mll_via_inv_preA(ins, torch.zeros((), dtype=torch.float64))
    close(_np(v), jv)


def test_chain_time_fetches_around_the_rounds():
    """One untimed call, then the rounds, the carry read on the host before
    and after them."""
    calls = []

    def step(c):
        calls.append(float(c))
        return c + 1.0

    seconds = ph.chain_time(step, torch.zeros(()), 3)
    assert calls == [0.0, 1.0, 2.0, 3.0] and seconds >= 0.0


def test_run_on_the_cpu_and_cuda_by_default(capsys):
    out = ph.main(["--B", "2", "--N", "4", "--D", "2", "--rounds", "1",
                   "--device", "cpu"])
    for name in ph.STAGES:
        assert out[name] > 0 and out["ns_per_eval"][name] > 0
        # plain versions on CPU tensors: no kernel launch to count
        assert out["launches"][name] == {}
    assert out["card"] == "cpu"
    assert '"mll_via_inv_preA"' in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ph.run(B=2, N=4, D=2, rounds=1)
