"""Port parity: the entry points (``scamlgp_tpu_torch.entry``) against the
root ``__graft_entry__.py``, in float64 on the CPU.

``build_small_model`` builds the JAX ``_build_small_model(jnp.float64)``'s
model field for field (rtol 1e-8: the same numpy draws; the source
factors' alpha moves by 1e-10 between the two Cholesky routes), and
``entry()``'s forward step gives the JAX step's MAP objective and
posterior mean and variance at rtol 1e-8, on the model's own parameters
and on perturbed ones carried across with ``convert.py``.
``dryrun_multichip`` runs its four legs on one and on two ``cpu`` slots
with finite weights and campaign losses.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch import entry as te
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-8


@pytest.fixture(scope="module")
def jentry():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side(jentry):
    """The JAX model in float64, its forward step and the queries."""
    model, scfg, tcfg = jentry._build_small_model(jnp.float64)

    @jax.jit
    def forward_step(params, Xq):
        obj = jm.scamlgp_map_objective(model, tcfg, params)
        mean, var = jm.scamlgp_posterior_diag(
            model._replace(params=params), scfg, tcfg, Xq)
        return obj, mean, var

    Xq = jnp.asarray(np.random.default_rng(1).uniform(size=(8, 2)))
    return model, forward_step, Xq


def test_small_model_equals_the_jax_one(jax_side):
    jmodel = convert.to_numpy_dict(jax_side[0])
    tmodel = convert.to_numpy_dict(
        te.build_small_model(torch.float64, "cpu")[0])

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12,
                                       err_msg=path)

    walk(tmodel, jmodel)


@pytest.mark.parametrize("shift", [0.0, 0.3])
def test_forward_step_matches(jax_side, shift):
    jmodel, jfwd, Xq = jax_side
    rng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(
        lambda leaf: leaf + shift * rng.normal(size=leaf.shape),
        jmodel.params)
    fn, (params, tXq) = te.entry(device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(tXq.numpy(), np.asarray(Xq))
    tparams = convert.target_params(convert.to_numpy_dict(jparams),
                                    device="cpu")
    for ours, ref in zip(fn(tparams, tXq), jfwd(jparams, Xq)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=1e-12)
    assert all(o.dtype == torch.float64 for o in fn(params, tXq))


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_cpu_slots(n):
    out = te.dryrun_multichip(n, device="cpu")
    assert out["slots"] == ["cpu"] * n
    assert out["mesh"] == ([1, 2] if n == 2 else [1, 1])
    assert len(out["weights"]) == max(2, n)
    assert np.isfinite(out["weights"]).all()
    y = np.asarray(out["y_clean"])
    assert y.shape == (out["studies"], 2) and np.isfinite(y).all()
    for leg in ("meta_fit_sharded", "build_sharded_target",
                "fit_target_sharded", "campaign"):
        assert out[f"{leg}_s"] >= 0


def test_main_runs_both_and_cuda_by_default(capsys):
    te.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "entry ok: [(), (8,), (8,)]"
    assert '"dryrun_multichip": 1' in lines[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.dryrun_multichip(1)
