"""Large-N fit accuracy: a float32 fit against the float64 oracle, BASELINE
config 5's fit leg (port of ``scripts/validate_large_n_fit.py``).

At N >= 512 the float32 MLL surface is distorted enough that a float32 fit
can end elsewhere than the float64 one (the JAX script saw the fitted noise
saturate at its Interval(1e-8, 1e-2) ceiling).  Per N, y is drawn from a
known GP (lengthscale 0.5, outputscale 1.0, noise ``--noise``) and the MAP
hyperparameters are fitted three ways from one restart stack, each a
batched L-BFGS of ``--steps`` steps (``models.fit.fit_map_restarts``), all
on the device:

- ``oracle_f64``: float64 parameters and data, the ``chol`` objective;
- ``f32_fit``: float32, ``--mll-method`` (``chol`` by default; ``sweep
  --route-blocked`` sends N = 512 and 1024 through the ``global``
  blocked-Cholesky kernel at (R, N, N));
- ``f32_chol64``: float32 parameters and data on the ``chol64`` objective,
  whose Gram is assembled and factored in float64.

The JAX script's third leg fitted in float32 on the TPU and then polished
the result against the float64 objective on the host CPU
(``scamlgp_tpu/models/fit.py::refine_map_f64_cpu``), because ``chol64``
crashed the TPU's compiler.  The card computes float64 natively, so the
float64 objective runs on the device inside the fit and there is no host
hop: ``f32_chol64`` stands where the polish stood, and ``chol64_vs_oracle``
where ``polish_vs_oracle`` did.

Each leg reports its constrained hyperparameters, its objective in float64
at its parameters (``objective_f64``), its raw parameters and its wall
seconds, the device synchronized before and after.  X, y and the restart
stack (the constraints' initial values, then ``--restarts`` prior draws)
come from a ``torch.Generator`` seeded with N on the host; JAX's keys do
not carry over, so the draws differ from the JAX script's.

    python -m scamlgp_tpu_torch.validate_large_n_fit [--sizes 512 1024]
        [--mll-method chol|sweep] [--route-blocked] [--out rows.json]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import inverse_mll
from scamlgp_tpu_torch.utils.profiling import synchronize

F64 = torch.float64


def draw(N: int, d: int, restarts: int, noise: float):
    """X (N, d) uniform, y (N,) a draw of the GP with lengthscale 0.5,
    outputscale 1.0 and ``noise``, and the restart stack (initial values,
    then ``restarts`` prior draws), float64 on the host from a generator
    seeded with N: numpy arrays and a ``GPParams`` of numpy arrays."""
    cfg = gp.source_gp_config()
    g = torch.Generator().manual_seed(N)
    X = torch.rand((N, d), generator=g, dtype=F64)
    true = gp.Constrained(lengthscale=torch.full((d,), 0.5, dtype=F64),
                          outputscale=torch.tensor(1.0, dtype=F64),
                          noise=torch.tensor(noise, dtype=F64))
    K = gp.gram(cfg, true, X)
    L = torch.linalg.cholesky(K + noise * torch.eye(N, dtype=F64))
    y = L @ torch.randn(N, generator=g, dtype=F64)
    stack = fit_lib.stack_restarts(
        gp.init_params(cfg, d, F64),
        gp.sample_params(cfg, g, d, F64, batch_shape=(restarts,)))
    return X.numpy(), y.numpy(), gp.GPParams(*[t.numpy() for t in stack])


def fit_leg(X, y, stack, dtype, method: str, route_blocked: bool,
            steps: int, device):
    """One leg: ``fit_map_restarts`` of the MAP objective in ``dtype`` with
    ``method``, from ``stack``; the result and its wall seconds."""
    cfg = gp.source_gp_config()
    Xd = torch.as_tensor(X, dtype=dtype, device=device)
    yd = torch.as_tensor(y, dtype=dtype, device=device)
    st = gp.GPParams(*[torch.as_tensor(leaf, dtype=dtype, device=device)
                       for leaf in stack])

    def objective(p):
        return gp.map_objective(cfg, p, Xd, yd, method=method,
                                route_blocked=route_blocked)

    synchronize(device)
    t0 = time.perf_counter()
    res = fit_lib.fit_map_restarts(objective, st, num_steps=steps)
    synchronize(device)
    return res, time.perf_counter() - t0


def report(params: gp.GPParams, X, y, device) -> dict:
    """A leg's constrained hyperparameters and its MAP objective in float64
    at its parameters, on the device."""
    cfg = gp.source_gp_config()
    p64 = gp.GPParams(*[leaf.to(dtype=F64, device=device) for leaf in params])
    c = gp.constrain(cfg, p64)
    obj = gp.map_objective(cfg, p64,
                           torch.as_tensor(X, dtype=F64, device=device),
                           torch.as_tensor(y, dtype=F64, device=device))
    return {
        "lengthscale_mean": float(c.lengthscale.mean()),
        "outputscale": float(c.outputscale),
        "noise": float(c.noise),
        "noise_at_ceiling": bool(c.noise > 0.99e-2),
        "objective_f64": float(obj),
        "raw": {k: np.atleast_1d(v.detach().cpu().numpy()).tolist()
                for k, v in p64._asdict().items()},
    }


def versus(leg: dict, oracle: dict) -> dict:
    return {
        "noise_rel_err": abs(leg["noise"] - oracle["noise"]) / oracle["noise"],
        "ls_rel_err": abs(leg["lengthscale_mean"]
                          - oracle["lengthscale_mean"])
        / oracle["lengthscale_mean"],
        "objective_gap": leg["objective_f64"] - oracle["objective_f64"],
    }


def fit_rows(X, y, stack, steps: int = 60, mll_method: str = "chol",
             route_blocked: bool = False, noise: float = 1e-3,
             device=None) -> dict:
    """The row at one N from X (N, d), y (N,) and a restart stack (a
    ``GPParams`` with a leading restart axis), numpy arrays or tensors:
    the three legs, each against the oracle, and the hand kernels' launches
    of the ``f32_fit`` leg."""
    device = resolve_device(device)
    legs = {}
    runs = (("oracle_f64", F64, "chol", False),
            ("f32_fit", torch.float32, mll_method, route_blocked),
            ("f32_chol64", torch.float32, "chol64", False))
    launches = {}
    for name, dtype, method, blocked in runs:
        before = inverse_mll.kernel_launches()
        res, wall = fit_leg(X, y, stack, dtype, method, blocked, steps,
                            device)
        after = inverse_mll.kernel_launches()
        if name == "f32_fit":
            launches = {k: after[k] - before[k] for k in after
                        if after[k] > before[k]}
        legs[name] = {**report(res.params, X, y, device),
                      "fit_objective": float(res.objective),
                      "wall_s": wall}
    oracle = legs["oracle_f64"]
    N, d = np.shape(X)
    return {"N": N, "d": d, "true_noise": noise,
            "restarts": int(np.shape(stack.raw_noise)[0]), "steps": steps,
            "f32_method": mll_method, "route_blocked": route_blocked,
            **legs,
            "f32_vs_oracle": versus(legs["f32_fit"], oracle),
            "chol64_vs_oracle": versus(legs["f32_chol64"], oracle),
            "f32_fit_launches": launches}


def run(sizes=(512, 1024), d: int = 6, restarts: int = 3, steps: int = 60,
        noise: float = 1e-3, mll_method: str = "chol",
        route_blocked: bool = False, device=None, out_path=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": str(device), "card": _card(device), "rows": []}
    for N in sizes:
        X, y, stack = draw(N, d, restarts, noise)
        row = fit_rows(X, y, stack, steps, mll_method, route_blocked, noise,
                       device)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(out, fh, indent=1)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--restarts", type=int, default=3)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--noise", type=float, default=1e-3)
    ap.add_argument("--mll-method", choices=("chol", "sweep"),
                    default="chol",
                    help="the f32_fit leg's objective")
    ap.add_argument("--route-blocked", action="store_true",
                    help="with --mll-method sweep: N in [192, 1024] through "
                         "the blocked-Cholesky kernel")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.sizes, args.d, args.restarts, args.steps, args.noise,
               args.mll_method, args.route_blocked, args.device, args.out)


if __name__ == "__main__":
    main()
