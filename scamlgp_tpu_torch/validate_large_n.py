"""Large-N predictive-path validation, BASELINE config 5 (port of
``scripts/validate_large_n.py``).

Fits nothing.  At each N (512, 1024 and 2048 by default) the GP posterior
mean and variance at ``--queries`` points and the MLL are computed in
float32 and in float64 on the same inputs (``gp.condition``,
``gp.predict(full_cov=False)``, ``gp.mll``; the Gram assembled and
factored in the working type), and the float32 results are held against
the float64 ones: a row passes when the mean's largest error is under 1e-2
of the float64 mean's largest magnitude, the variance's under 5e-2 of the
float64 variance's, and every float32 variance is positive.

The data are the JAX script's: one ``np.random.default_rng(0)`` drawn in
the same order for each N in turn (X uniform (N, d), y a sum of cosines of
X with noise 0.03 then standardized, the queries uniform (queries, d)), and
the same mid-range hyperparameters (lengthscale 0.6, outputscale 1.0,
noise 1e-3, the source GP's constraints), so that the system is
realistically conditioned (``cond_est``, the float64 condition number of
K + 1e-3 I, from its extreme eigenvalues on the device).

    python -m scamlgp_tpu_torch.validate_large_n [--sizes 512 1024 2048]
        [--queries 64] [--d 6] [--out rows.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp


def draw(rng: np.random.Generator, N: int, d: int, queries: int):
    """One size's X (N, d), y (N,) and queries (queries, d), drawn from
    ``rng`` in the JAX script's order."""
    X = rng.uniform(size=(N, d))
    f = np.sum(np.cos(3.0 * X + np.arange(d)), axis=1)
    y = f + 0.03 * rng.normal(size=N)
    y = (y - y.mean()) / y.std()
    Xq = rng.uniform(size=(queries, d))
    return X, y, Xq


def mid_range_params(d: int) -> gp.GPParams:
    """Raw float64 parameters at lengthscale 0.6, outputscale 1.0 and noise
    1e-3 (typical of a converged fit)."""
    cfg = gp.source_gp_config()
    f64 = torch.float64
    return gp.GPParams(
        raw_lengthscale=cfg.lengthscale_constraint.inverse(
            torch.full((d,), 0.6, dtype=f64)),
        raw_outputscale=cfg.outputscale_constraint.inverse(
            torch.tensor(1.0, dtype=f64)),
        raw_noise=cfg.noise_constraint.inverse(torch.tensor(1e-3, dtype=f64)))


def predictions(X, y, Xq, dtype, device):
    """The posterior mean and variance at Xq and the MLL, in ``dtype`` on
    ``device``: (mean, var) as float64 numpy arrays, the MLL a float."""
    cfg = gp.source_gp_config()

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    p = gp.GPParams(*[leaf.to(dtype=dtype, device=device)
                      for leaf in mid_range_params(X.shape[1])])
    Xd, yd = t(X), t(y)
    ps = gp.condition(cfg, p, Xd, yd)
    mean, var = gp.predict(cfg, ps, t(Xq), full_cov=False)
    mll = gp.mll(cfg, p, Xd, yd)
    return (mean.double().cpu().numpy(), var.double().cpu().numpy(),
            float(mll))


def condition_number(X, device) -> float:
    """cond(K + 1e-3 I) in float64 at the mid-range parameters: the ratio of
    its extreme eigenvalues (the matrix is SPD)."""
    cfg = gp.source_gp_config()
    p = gp.GPParams(*[leaf.to(device) for leaf in
                      mid_range_params(X.shape[1])])
    K = gp.gram(cfg, gp.constrain(cfg, p),
                torch.as_tensor(X, dtype=torch.float64, device=device))
    ev = torch.linalg.eigvalsh(
        K + 1e-3 * torch.eye(K.shape[0], dtype=K.dtype, device=device))
    return float(ev[-1] / ev[0])


def validate_row(X, y, Xq, device) -> dict:
    """The JAX script's row at one N: float32 against float64, and its
    pass flag."""
    m64, v64, mll64 = predictions(X, y, Xq, torch.float64, device)
    m32, v32, mll32 = predictions(X, y, Xq, torch.float32, device)
    scale = float(np.abs(m64).max() + 1e-12)
    row = {
        "N": X.shape[0],
        "cond_est": condition_number(X, device),
        "mean_max_abs_err": float(np.abs(m32 - m64).max()),
        "mean_rel_err": float(np.abs(m32 - m64).max() / scale),
        "var_max_rel_err": float(
            np.abs(v32 - v64).max() / (np.abs(v64).max() + 1e-12)),
        "var_min_f32": float(v32.min()),
        "mll_rel_err_f32": abs(mll32 - mll64) / abs(mll64),
    }
    row["pass"] = bool(row["mean_rel_err"] < 1e-2
                       and row["var_max_rel_err"] < 5e-2
                       and row["var_min_f32"] > 0.0)
    return row


def run(sizes=(512, 1024, 2048), queries: int = 64, d: int = 6,
        device=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    out = {"device": str(device), "card": _card(device), "d": d,
           "queries": queries, "rows": []}
    for N in sizes:
        row = validate_row(*draw(rng, N, d, queries), device)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    out["all_pass"] = all(r["pass"] for r in out["rows"])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", nargs="*", type=int, default=[512, 1024, 2048])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.sizes, args.queries, args.d, args.device)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
