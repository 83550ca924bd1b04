"""Entry points of the port: the flagship model's forward step, and one
sharded training step over a mesh of slots (port of the root
``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)``: ``fn(params, Xq)`` evaluates,
on the small flagship ScaML-GP model (4 meta-tasks x 16 points, d = 2,
6 target points), the training-mode MAP objective (MLL and priors, on the
objective's default route) and the hierarchical posterior mean and variance
at a query batch, the two hot paths of the BO loop.

``dryrun_multichip(n)`` runs the sharded legs on ``n`` slots of the port's
``parallel.mesh`` (``mesh.local_slots``: one card a slot where there are
``n`` cards, else the one device repeated): the task-sharded meta-fit, the
target caches with the slot-summed global normalizer, the task-sharded
target fit, and a lock-step campaign on a (n // 2, 2) (study, task) mesh
for even n > 1, else (n, 1).  It returns each leg's seconds and checks.
The JAX function forces a virtual CPU topology before it runs; the port
runs on the slots it is given.  Its draws come from torch generators where
the JAX function takes JAX keys.

    python -m scamlgp_tpu_torch.entry [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.torch_adapters import branin_unit
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.parallel import scamlgp_sharded as sh
from scamlgp_tpu_torch.parallel.campaign import CampaignConfig, run_campaign
from scamlgp_tpu_torch.parallel.mesh import local_slots, make_mesh
from scamlgp_tpu_torch.utils.profiling import synchronize

#: Branin's task-parameter ranges of the campaign leg
BRANIN_RANGES = (("a", 0.5, 1.5), ("b", 0.1, 0.15), ("c", 1.0, 2.0),
                 ("r", 5.0, 7.0), ("s", 8.0, 12.0), ("t", 0.03, 0.05))


def build_small_model(dtype=torch.float32, device=None):
    """(model, source config, target config): the flagship model from
    ``default_rng(0)``, its source GPs at their initial parameters."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    M, N, d = 4, 16, 2
    xs = [rng.uniform(size=(N, d)) for _ in range(M)]
    ys = [np.sin(4 * x[:, 0]) + 0.5 * np.cos(3 * x[:, 1]) for x in xs]
    cfg = gp.source_gp_config()
    data = m.pack_task_data(xs, ys, dtype=dtype, device=device)
    params = gp.init_params(cfg, d, dtype, device, batch_shape=(M,))
    stack = m.finalize_source_stack(data, cfg, params)
    Xt = torch.as_tensor(rng.uniform(size=(6, d)), dtype=dtype, device=device)
    yt = torch.sin(4 * Xt[:, 0])
    model = m.build_scamlgp(stack, cfg, Xt, yt)
    return model, cfg, gp.target_gp_config()


def entry(device=None, dtype=torch.float32):
    """(fn, example_args): the forward step ``fn(params, Xq) -> (objective,
    mean, var)`` of the flagship model, and its parameters and 8 queries
    from ``default_rng(1)``."""
    model, source_cfg, target_cfg = build_small_model(dtype, device)

    def forward_step(params, Xq):
        obj = m.scamlgp_map_objective(model, target_cfg, params)
        mean, var = m.scamlgp_posterior_diag(
            model._replace(params=params), source_cfg, target_cfg, Xq)
        return obj, mean, var

    rng = np.random.default_rng(1)
    Xq = torch.as_tensor(rng.uniform(size=(8, 2)), dtype=dtype,
                         device=model.train_X.device)
    return forward_step, (model.params, Xq)


def _campaign_inputs(S: int, M: int, N: int, dtype, device, seed: int = 1):
    """Per study: Branin task parameters from their ranges, and M meta-tasks
    of N uniform points with noise 0.1, from one generator."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, dtype=dtype)

    tp = {name: lo + (hi - lo) * u(S) for name, lo, hi in BRANIN_RANGES}
    X = u(S, M, N, 2)
    y = branin_unit(X, {k: v[:, None, None] for k, v in tp.items()})
    y = y + 0.1 * torch.randn(y.shape, generator=g, dtype=dtype)
    packed = [m.pack_task_data(list(X[s].numpy()), list(y[s].numpy()),
                               dtype=dtype, device=device) for s in range(S)]
    meta = m.TaskData(*[torch.stack(leaves) for leaves in zip(*packed)])
    return {k: v.to(device) for k, v in tp.items()}, meta


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded training step over ``n_devices`` slots in float32; each
    leg's seconds, the fitted weights and the campaign's noise-free losses.
    Raises where a leg gives a non-finite result."""
    device = resolve_device(device)
    dtype = torch.float32
    n = max(int(n_devices), 1)
    slots = local_slots(device, n)
    home = slots[0]
    out = {"slots": [str(s) for s in slots]}
    rng = np.random.default_rng(0)
    M, N, d = max(2, n), 8, 2
    xs = [rng.uniform(size=(N, d)) for _ in range(M)]
    ys = [np.sin(4 * x[:, 0]) + 0.1 * rng.normal(size=N) for x in xs]
    data = m.pack_task_data(xs, ys, dtype=dtype, device=home)
    cfg, tcfg = gp.source_gp_config(), gp.target_gp_config()
    mesh = make_mesh(1, n, devices=slots)

    def leg(name, fn):
        t0 = time.perf_counter()
        res = fn()
        synchronize(home)
        out[f"{name}_s"] = time.perf_counter() - t0
        return res

    # 1) task-sharded meta-fit (1 restart, 3 L-BFGS steps)
    stack = leg("meta_fit_sharded", lambda: sh.meta_fit_sharded(
        data, cfg, torch.Generator().manual_seed(0), mesh, num_restarts=1,
        num_steps=3))
    # 2) target caches and the slot-summed global normalizer
    Xt = torch.as_tensor(rng.uniform(size=(4, d)), dtype=dtype, device=home)
    yt = torch.sin(4 * Xt[:, 0])
    state = leg("build_sharded_target", lambda: sh.build_sharded_target(
        stack, cfg, Xt, yt, torch.ones(4, dtype=dtype, device=home), mesh))
    # 3) task-sharded target fit (weights split, slot-summed MLL)
    params0 = m.init_target_params(tcfg, stack.num_tasks, d, dtype, home)
    params1 = leg("fit_target_sharded", lambda: sh.fit_target_sharded(
        state, tcfg, params0, mesh, num_steps=3))
    w = m.weights_forward(params1.raw_weights).detach().cpu()
    if w.shape != (stack.num_tasks,) or not bool(torch.isfinite(w).all()):
        raise RuntimeError(f"sharded target fit gave weights {w}")
    out["weights"] = w.tolist()
    # 4) a lock-step campaign on a 2-D (study, task) mesh
    shape = (n // 2, 2) if n >= 2 and n % 2 == 0 else (n, 1)
    mesh2d = make_mesh(*shape, devices=slots)
    S = max(shape[0], 2)
    tp, md = _campaign_inputs(S, 2, 6, dtype, home)
    cfg2 = CampaignConfig(n_evaluations=2, noise_std=0.1, fit_steps=5,
                          fit_restarts=1, acq_raw_samples=32, acq_topk=2,
                          acq_steps=3)
    res = leg("campaign", lambda: run_campaign(
        branin_unit, tp, md, 2, cfg=cfg2, meta_fit_restarts=1,
        meta_fit_steps=3, mesh=mesh2d, device=home))
    y_clean = res.y_clean.detach().cpu()
    if y_clean.shape != (S, 2) or not bool(torch.isfinite(y_clean).all()):
        raise RuntimeError(f"campaign on a {shape} mesh gave {y_clean}")
    out.update(mesh=list(shape), studies=S, y_clean=y_clean.tolist())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fn, example = entry(device)
    outs = fn(*example)
    print("entry ok:", [tuple(o.shape) for o in outs], flush=True)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    res = dryrun_multichip(n, device)
    print(json.dumps({"dryrun_multichip": n, **res}), flush=True)
    return res


if __name__ == "__main__":
    main()
