"""Port parity: the task-sharded ScaML-GP (``parallel/scamlgp_sharded.py``)
against the JAX package in float64.

The JAX functions run on the conftest's eight virtual CPU devices (a
``task`` mesh of 8), the port on a mesh of eight ``cpu`` slots, from the
same source stack carried across by ``convert``.  The sharded meta-fit is
held to the port's one-batch ``meta_fit_task_stack`` on the same restart
stack.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from scamlgp_tpu.models import gp as jgp
from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.parallel import scamlgp_sharded as jsh
from scamlgp_tpu_torch import convert
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.parallel import scamlgp_sharded as tsh
from scamlgp_tpu_torch.parallel.mesh import make_mesh
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64
M, N, D, SLOTS = 6, 12, 2, 8


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(a, b, rtol, atol=1e-12):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def meta():
    rng = np.random.default_rng(5)
    xs = [rng.uniform(size=(N, D)) for _ in range(M)]
    ys = [np.sin(4 * x[:, 0]) + 0.1 * rng.normal(size=N) for x in xs]
    return xs, ys


@pytest.fixture(scope="module")
def target(meta):
    """The JAX package's padded source stack (random hyperparameters, the
    last task's repeated into the padding, as ``tests/test_parallel.py``
    pads), its sharded target state and 20 Adam steps of its target fit."""
    xs, ys = meta
    rng = np.random.default_rng(2)
    cfg = jgp.source_gp_config()
    data = jsh.pad_task_data(jm.pack_task_data(xs, ys, dtype=jnp.float64),
                             SLOTS)
    raw = jgp.GPParams(
        raw_lengthscale=jnp.asarray(rng.normal(size=(M, D)) * 0.5),
        raw_outputscale=jnp.asarray(rng.normal(size=M) * 0.5),
        raw_noise=jnp.asarray(rng.normal(size=M) * 0.5 - 2.0))
    params = jax.tree_util.tree_map(
        lambda l: jnp.concatenate(
            [l, jnp.broadcast_to(l[-1:], (SLOTS - M,) + l.shape[1:])]), raw)
    stack = jm.finalize_source_stack(data, cfg, params)
    Xt = jnp.asarray(rng.uniform(size=(5, D)))
    yt = jnp.sin(4 * Xt[:, 0])
    mask = jnp.ones(5)
    mesh = JMesh(np.asarray(jax.devices()[:SLOTS]).reshape(SLOTS), ("task",))
    state = jsh.build_sharded_target(stack, cfg, Xt, yt, mask, mesh)
    tcfg = jgp.target_gp_config()
    p0 = jm.init_target_params(tcfg, SLOTS, D, jnp.float64)
    fitted = jsh.fit_target_sharded(state, tcfg, p0, mesh, num_steps=20)
    return dict(stack=stack, Xt=Xt, yt=yt, mask=mask, state=state, p0=p0,
                fitted=fitted)


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_mesh(study=1, devices=["cpu"] * SLOTS)


def test_build_sharded_target_matches(target, cpu_mesh):
    """Caches and the slot-summed normalizer equal the JAX psum's."""
    stack = convert.source_stack(convert.to_numpy_dict(target["stack"]),
                                 device="cpu")
    state = tsh.build_sharded_target(
        stack, tgp.source_gp_config(), T(target["Xt"]), T(target["yt"]),
        T(target["mask"]), cpu_mesh)
    for name, ref in zip(target["state"]._fields, target["state"]):
        close(getattr(state, name), ref, rtol=1e-10)


def test_fit_target_sharded_matches(target, cpu_mesh):
    """20 Adam steps from the same start equal the JAX fit; every slot's
    weight shard moved (its gradient reached it through the slot sum)."""
    state = convert.sharded_target_state(
        convert.to_numpy_dict(target["state"]), device="cpu")
    p0 = convert.target_params(convert.to_numpy_dict(target["p0"]),
                               device="cpu")
    fitted = tsh.fit_target_sharded(state, tgp.target_gp_config(), p0,
                                    cpu_mesh, num_steps=20)
    ref = convert.target_params(convert.to_numpy_dict(target["fitted"]),
                                device="cpu")
    close(tfit.flatten(fitted, 0), tfit.flatten(ref, 0), rtol=1e-8)
    moved = (fitted.raw_weights - p0.raw_weights).abs()
    assert bool((moved[:M] > 0).all())
    # the padded tasks carry no observations: their prior alone moves them
    assert torch.isfinite(fitted.raw_weights).all()


def test_fitted_params_beat_init_through_the_unsharded_path(target,
                                                            cpu_mesh):
    """As ``tests/test_parallel.py`` checks: the sharded fit, restricted to
    the real tasks, lowers the unsharded MAP objective."""
    stack = convert.source_stack(convert.to_numpy_dict(target["stack"]),
                                 device="cpu")
    scfg, tcfg = tgp.source_gp_config(), tgp.target_gp_config()
    real = tfit.tree_map(lambda leaf: leaf[:M], stack)
    model = tm.build_scamlgp(real, scfg, T(target["Xt"]), T(target["yt"]),
                             T(target["mask"]))
    state = tsh.build_sharded_target(stack, scfg, T(target["Xt"]),
                                     T(target["yt"]), T(target["mask"]),
                                     cpu_mesh)
    close(state.out_mean, model.out_mean, rtol=1e-10)
    close(state.out_std, model.out_std, rtol=1e-10)
    p0 = tm.init_target_params(tcfg, SLOTS, D, F64)
    fitted = tsh.fit_target_sharded(state, tcfg, p0, cpu_mesh, num_steps=60)
    assert torch.isfinite(tm.weights_forward(fitted.raw_weights)).all()
    init = float(tm.scamlgp_map_objective(model, tcfg, model.params))
    trunc = tm.TargetParams(raw_weights=fitted.raw_weights[:M],
                            gp=fitted.gp)
    assert float(tm.scamlgp_map_objective(model, tcfg, trunc)) < init


def test_meta_fit_sharded_matches_one_batch(meta):
    """4 CPU slots (6 tasks padded to 8) against ``meta_fit_task_stack`` on
    the same restart stack, drawn once for the padded task axis; the padded
    tasks stay inert (no observations, mean 0, std 1, alpha 0)."""
    xs, ys = meta
    cfg = tgp.source_gp_config()
    data = tm.pack_task_data(xs, ys, dtype=F64)
    mesh = make_mesh(study=1, devices=["cpu"] * 4)
    sharded = tsh.meta_fit_sharded(
        data, cfg, torch.Generator().manual_seed(3), mesh, num_restarts=2,
        num_steps=25)
    warm = tgp.init_params(cfg, D, F64, batch_shape=(8,))
    draws = tgp.sample_params(cfg, torch.Generator().manual_seed(3), D, F64,
                              batch_shape=(8, 2))
    init = tfit.stack_restarts(warm, draws, batch_ndim=1)
    single = tm.meta_fit_task_stack(
        data, cfg, num_steps=25,
        init_stack=tfit.tree_map(lambda leaf: leaf[:M], init))
    for a, b in zip(tfit.tree_leaves(sharded), tfit.tree_leaves(single)):
        close(a[:M], b.numpy(), rtol=1e-10)
    pad = sharded.data
    assert (pad.mask[M:] == 0).all() and (pad.mean[M:] == 0).all()
    assert (pad.std[M:] == 1).all() and (sharded.alpha[M:] == 0).all()
    assert torch.isfinite(sharded.chol).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_meta_fit_split_probe_on_the_cpu(dtype, capsys):
    """``python -m scamlgp_tpu_torch.meta_fit_split`` at a CPU size: on the
    CPU a split and a permuted batch equal the one batch bit for bit (L-BFGS
    couples no rows), and the float64 objective does not follow the
    parameters' memory layout."""
    from scamlgp_tpu_torch import meta_fit_split as probe

    lines = probe.main(["--device", "cpu", "--tasks", "8", "--points", "6",
                        "--seeds", "0", "--steps", "6", "--restarts", "1",
                        "--dtype", dtype])
    (line,) = lines
    for way in ("split", "permuted"):
        assert line[way]["equal"] == 8 and line[way]["gap_max"] == 0.0
        assert line["sum"][way] == line["sum"]["one"]
    total = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert total["split_equal"] == total["permuted_equal"] == 8
    params = tgp.init_params(tgp.source_gp_config(), 1, F64,
                             batch_shape=(8, 2))
    strided = tfit.tree_map(lambda leaf: leaf[:, 0], params)
    contiguous = tfit.tree_map(lambda leaf: leaf.contiguous(), strided)
    data = tm.TaskData(*[torch.as_tensor(a) for a in (
        np.linspace(0, 1, 48).reshape(8, 6, 1), np.sin(np.arange(48.0))
        .reshape(8, 6), np.ones((8, 6)), np.zeros(8), np.ones(8))])
    cfg = tgp.source_gp_config()
    assert torch.equal(probe.map_objective64(cfg, strided, data),
                       probe.map_objective64(cfg, contiguous, data))
