"""Port parity: the RBF Gram kernel's module (``ops/gram.py``) against the
JAX package's ``rbf_gram_pallas`` (``ops/pallas_gram.py``), whose Pallas
kernel runs in interpret mode off the TPU.

- The plain version against the Pallas kernel on the same numpy inputs,
  float32 and float64: atol 2e-5, the JAX package's own tolerance for this
  kernel against ``K.rbf`` (``tests/test_parallel.py``); both compute in
  float32 inside.
- The gradients of ``rbf_gram`` (on the CPU: the plain forward) against
  ``jax.vjp`` of ``rbf_gram_pallas`` for x, z, the lengthscales and the
  outputscale, rtol 1e-6 in float64: both are the VJP of the plain RBF.
- The launch count counts launches only: an empty output launches
  nothing and leaves it as it was.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.ops.pallas_gram import rbf_gram_pallas
from scamlgp_tpu_torch.ops import gram
from scamlgp_tpu_torch.ops import kernels as K


def inputs(n, m, d, seed=0):
    rng = np.random.default_rng(seed + 100 * d + n)
    return (rng.uniform(size=(n, d)), rng.uniform(size=(m, d)),
            rng.uniform(0.3, 1.0, size=d), 1.3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,m,d", [(300, 200, 3), (257, 513, 6), (1, 1, 1)])
def test_plain_matches_the_pallas_kernel(n, m, d, dtype):
    x, z, ls, os_ = inputs(n, m, d)
    jdt = getattr(jnp, dtype)
    Kj = rbf_gram_pallas(jnp.asarray(x, jdt), jnp.asarray(z, jdt),
                         jnp.asarray(ls, jdt), os_)
    tdt = getattr(torch, dtype)
    Kt = gram.rbf_gram_plain(torch.as_tensor(x, dtype=tdt),
                             torch.as_tensor(z, dtype=tdt),
                             torch.as_tensor(ls, dtype=tdt), os_)
    assert Kt.shape == (n, m) and Kt.dtype == tdt
    assert np.asarray(Kj).dtype == np.dtype(dtype)
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=0, atol=2e-5)
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    before = gram.rbf_gram.launches
    Kw = gram.rbf_gram(torch.as_tensor(x, dtype=tdt),
                       torch.as_tensor(z, dtype=tdt),
                       torch.as_tensor(ls, dtype=tdt), os_)
    assert torch.equal(Kw, Kt)
    assert gram.rbf_gram.launches == before


def test_gradients_match_the_pallas_vjp():
    x, z, ls, os_ = inputs(40, 30, 3)
    rng = np.random.default_rng(5)
    cot = rng.normal(size=(40, 30))
    primals = (jnp.asarray(x), jnp.asarray(z), jnp.asarray(ls),
               jnp.asarray(os_))
    _, vjp = jax.vjp(rbf_gram_pallas, *primals)
    jgrads = vjp(jnp.asarray(cot))
    leaves = [torch.tensor(np.asarray(a), dtype=torch.float64,
                           requires_grad=True) for a in (x, z, ls, os_)]
    Kt = gram.rbf_gram(*leaves)
    tgrads = torch.autograd.grad(Kt, leaves, torch.as_tensor(cot))
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-12)


def test_gradient_of_a_subset_of_inputs():
    """Only the inputs that ask for a gradient get one; a float outputscale
    and a scalar lengthscale are taken."""
    x, z, _, _ = inputs(8, 5, 2)
    xt = torch.tensor(x, requires_grad=True)
    zt = torch.as_tensor(z)
    (gx,) = torch.autograd.grad(gram.rbf_gram(xt, zt, 0.7, 2.0).sum(), [xt])
    xr = torch.tensor(x, requires_grad=True)
    (gr,) = torch.autograd.grad(K.rbf(xr, zt, 0.7, 2.0).sum(), [xr])
    np.testing.assert_allclose(gx.numpy(), gr.numpy(), rtol=1e-12)


@pytest.mark.parametrize("n, m", [(0, 5), (5, 0), (0, 0)])
def test_empty_output_launches_nothing(n, m):
    """``_launch`` returns an empty (n, m) Gram before it reaches the card,
    and counts nothing."""
    before = gram.rbf_gram.launches
    out = gram._launch(torch.zeros((n, 3)), torch.zeros((m, 3)), 0.5, 1.0)
    assert out.shape == (n, m)
    assert gram.rbf_gram.launches == before


def test_wrapper_rejects_a_device_it_does_not_run_on():
    x = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gram.rbf_gram(x, x, torch.ones(2, device="meta"),
                      torch.ones((), device="meta"))
