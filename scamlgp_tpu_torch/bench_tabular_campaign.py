"""A tabular campaign on the card at the reference experiments' shape (port
of ``scripts/bench_tabular_campaign.py``).

The reference's tabular experiments (HPOBench lr/svm: 28 tasks x 64
points, 60 evaluations x 256 studies; ``lr_tabular.py``) run one study a
process.  This bench runs that shape as one lock-step ``run_campaign``
whose objective is a batched grid lookup on the card
(``benchmarking/tabular_adapters.make_grid_lut_fn``) and reports studies
per hour.  The real tables are not in the repository, so each (study,
task) table is a smooth random trigonometric surface on the grid, built
from ``default_rng(0)`` exactly as the JAX script builds it
(``synthetic_tables``): the run exercises the meta-fit (in
``--meta-fit-chunks`` sequential batches), the refits, the acquisition and
the lookup; its regret is of synthetic tables.

One JSON line of setup seconds, then one of the run: campaign seconds,
seconds an iteration and a study-iteration, studies per hour, the median
final simple regret, the meta-fit seconds, the ``GLOBAL_TIMER`` split of
the iterations (``stages``: ``iteration_*`` and ``campaign_*``) and each
kernel's launches.  With ``--seq-driver-json FILE`` (the output of
``bench_sequential_driver``; its ``hpobench`` row's median iteration) it
adds ``seq_driver_studies_per_hour`` and ``speedup_vs_seq_driver``; without
it those keys are left out.  Dropped from the JAX script: the persistent
compilation cache (``.jaxcache``), the ``.tpuq`` checkpoint path and
``SCAMLGP_ITER_DEBUG`` (the ``iteration_*`` stages take its place), and its
fixed sequential-driver time.  ``--cpu`` becomes ``--device``; ``backend``
becomes ``device`` and ``card``.

    python -m scamlgp_tpu_torch.bench_tabular_campaign [--levels 32,32]
        [--tasks 28] [--points 64] [--evals 60] [--studies 256]
        [--meta-fit-chunks 32] [--study-chunk K] [--mll-method chol|sweep]
        [--seq-driver-json FILE] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.benchmarking.tabular_adapters import make_grid_lut_fn
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
)
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER


def synthetic_tables(levels, S: int, M: int, N: int):
    """The JAX script's synthetic problem, in its order of draws from
    ``default_rng(0)``: per study a target table over the row-major grid
    (S, G), and M meta-tasks of N uniform points each, looked up in the
    task's own perturbed table.  Returns float32 numpy arrays
    (tables, meta X (S, M, N, d), meta y (S, M, N))."""
    d = len(levels)
    rng = np.random.default_rng(0)
    axes = [np.linspace(0.5 / n, 1 - 0.5 / n, n) for n in levels]
    mesh = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    grid = mesh.reshape(-1, d)                      # (G, d)

    def surface(key_row):
        w = key_row[:d * 3].reshape(3, d) * 4.0
        ph = key_row[d * 3:d * 3 + 3] * 2 * np.pi
        amp = 0.5 + key_row[d * 3 + 3:d * 3 + 6]
        return sum(a * np.cos(grid @ wi + p)
                   for a, wi, p in zip(amp, w, ph))

    base_keys = rng.standard_normal((S, d * 3 + 6))
    task_keys = rng.standard_normal((S, M, d * 3 + 6)) * 0.3
    tables = np.empty((S, grid.shape[0]), np.float32)
    meta_xs = rng.uniform(size=(S, M, N, d)).astype(np.float32)
    meta_ys = np.empty((S, M, N), np.float32)
    snap = [np.minimum((meta_xs[..., i] * n).astype(int), n - 1)
            for i, n in enumerate(levels)]
    flat = snap[0]
    for i in range(1, d):
        flat = flat * levels[i] + snap[i]
    for s in range(S):
        tables[s] = surface(base_keys[s])
        for t in range(M):
            task_tab = surface(base_keys[s] + task_keys[s, t])
            meta_ys[s, t] = task_tab[flat[s, t]]
    return tables, meta_xs, meta_ys


def campaign_inputs(levels, S: int, M: int, N: int, device=None):
    """(lookup fn, task params, meta TaskData, optima): the tables and the
    meta-data on ``device`` in float32, each task standardized as
    ``pack_task_data`` does (sample std)."""
    device = resolve_device(device)
    tables, meta_xs, meta_ys = synthetic_tables(levels, S, M, N)
    mu = meta_ys.mean(axis=-1, keepdims=True)
    sd = meta_ys.std(axis=-1, ddof=1, keepdims=True)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    meta = m.TaskData(X=t(meta_xs), y=t((meta_ys - mu) / sd),
                      mask=t(np.ones((S, M, N), np.float32)),
                      mean=t(mu[..., 0]), std=t(sd[..., 0]))
    return (make_grid_lut_fn(levels), {"table": t(tables)}, meta,
            t(tables.min(axis=1)))


def seq_driver_iteration_s(path) -> float:
    """The median iteration seconds of the ``hpobench`` row of a
    ``bench_sequential_driver`` output."""
    with open(path) as fh:
        out = json.load(fh)
    rows = [r for r in out["rows"] if r["scenario"] == "hpobench"]
    if not rows:
        raise ValueError(f"{path} has no hpobench row")
    return float(rows[0]["per_iter_median_s"])


def run(levels=(32, 32), tasks: int = 28, points: int = 64, evals: int = 60,
        studies: int = 256, meta_fit_chunks: int = 32, study_chunk=None,
        mll_method: str = "chol", seq_driver_json=None, device=None) -> dict:
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    levels = [int(n) for n in levels]
    S, M, N, E = studies, tasks, points, evals
    t0 = time.perf_counter()
    fn, task_params, meta, optima = campaign_inputs(levels, S, M, N, device)
    setup_s = time.perf_counter() - t0
    print(json.dumps({"setup_s": setup_s}), flush=True)
    cfg = CampaignConfig(n_evaluations=E, noise_std=0.0,
                         mll_method=mll_method)
    GLOBAL_TIMER.reset()
    t1 = time.perf_counter()
    res = run_campaign(fn, task_params, meta, 0, cfg=cfg,
                       meta_fit_chunks=meta_fit_chunks,
                       study_chunk=study_chunk, device=device)
    run_s = time.perf_counter() - t1
    reg = simple_regret(res.y_clean, optima).cpu().numpy()
    out = {
        "device": str(device), "card": _card(device),
        "mll_method": mll_method, "levels": levels, "tasks": M,
        "points": N, "evals": E, "studies": S,
        "meta_fit_chunks": meta_fit_chunks, "study_chunk": study_chunk,
        "setup_s": setup_s,
        "campaign_s": run_s,
        "s_per_iter": run_s / E,
        "s_per_study_iter": run_s / E / S,
        "studies_per_hour": S / (run_s / 3600.0),
        "meta_fit_s": res.meta_fit_seconds,
        "iteration_s": list(res.iteration_seconds),
        "median_final_regret_synthetic": float(np.median(reg[:, -1])),
        # each kernel's launches in the meta-fit and in all iterations
        "launches": {k: {"meta_fit": v[0], "iterations": sum(v[1:])}
                     for k, v in res.launches.items() if sum(v)},
        "stages": GLOBAL_TIMER.report(),
    }
    if seq_driver_json:
        it_s = seq_driver_iteration_s(seq_driver_json)
        out["seq_driver_it_s"] = it_s
        out["seq_driver_studies_per_hour"] = 3600.0 / (it_s * E)
        out["speedup_vs_seq_driver"] = (S / run_s) * it_s * E
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", default="32,32",
                    help="grid levels per dim (comma-separated)")
    ap.add_argument("--tasks", type=int, default=28)
    ap.add_argument("--points", type=int, default=64)
    ap.add_argument("--evals", type=int, default=60)
    ap.add_argument("--studies", type=int, default=256)
    ap.add_argument("--meta-fit-chunks", type=int, default=32)
    ap.add_argument("--study-chunk", type=int, default=None)
    ap.add_argument("--mll-method", default="chol", choices=["chol", "sweep"],
                    help="fit-objective route: 'sweep' sends every fit's "
                         "MLL through the sweep kernel (N <= 128)")
    ap.add_argument("--seq-driver-json", default=None,
                    help="a bench_sequential_driver output: its hpobench "
                         "row's median iteration for the comparison keys")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = run([int(x) for x in args.levels.split(",")], args.tasks,
              args.points, args.evals, args.studies, args.meta_fit_chunks,
              args.study_chunk, args.mll_method, args.seq_driver_json,
              args.device)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
