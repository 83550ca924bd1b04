"""Ablation campaigns of the port: average cumulative regret against the
meta-data's scale, the number of meta-tasks M or of points per task N_m
(the reference's ``configurations/branin_ablation_num_meta_tasks.py`` and
``..._num_points_per_task.py``; ``scripts/run_ablation.py`` runs them on
the JAX package).

    python -m scamlgp_tpu_torch.ablation --benchmark Branin --axis tasks \\
        --values 2 4 8 16 32 --points 32 --sigma 1.0 --evals 40 \\
        --studies 16 [--fit-method map|hmc|nuts|vi] [--checkpoint] \
        --out rows.json

For each value, the studies (seeds ``--seed-offset`` on) run as lock-step
campaigns (``parallel/campaign.py``) of at most ``--study-chunk`` studies
(0: all in one campaign).  The campaign of the chunk that starts at study
index c0 runs with ``seed=c0`` (0 for the first chunk and for unchunked
runs; the summary's ``prng`` field says so).  Each value's row holds the
mean +- SEM over studies of each study's average cumulative simple regret
and the median final regret, with the value's wall seconds and the card.

With ``--out``, every finished value is written at once and skipped when
the command runs again, and every finished chunk's regrets are cached as
``<out>.chunks/v<value>_c<c0>.npy``.  ``--checkpoint`` also checkpoints each
(value, chunk) campaign there (``v<value>_c<c0>.ckpt.npz``, its optima
beside it), so a run killed mid-campaign resumes from its last checkpoint;
both are removed once the chunk's regrets are cached.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking import benchmarks
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.ops.sweep import VARIANTS
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
)
from scamlgp_tpu_torch.utils import checkpoint as ckpt
from scamlgp_tpu_torch.validate import _card, pinned_optima, regret_summary

PRNG = "run_campaign seed = c0, the chunk's first study index (0 unchunked)"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--benchmark", required=True)
    ap.add_argument("--axis", choices=["tasks", "points"], required=True)
    ap.add_argument("--values", type=int, nargs="+", required=True)
    ap.add_argument("--tasks", type=int, default=8,
                    help="fixed M when --axis points")
    ap.add_argument("--points", type=int, default=32,
                    help="fixed N_m when --axis tasks")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--evals", type=int, default=40)
    ap.add_argument("--studies", type=int, default=16)
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="first study seed")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--optimum-method", default="shgo",
                    choices=["shgo", "device"])
    ap.add_argument("--meta-fit-chunks", type=int, default=1,
                    help="sequential meta-fit batches, where they divide a "
                         "chunk's studies")
    ap.add_argument("--fit-method", default="map",
                    choices=["map", "hmc", "nuts", "vi"],
                    help="the target fit: MAP, or posterior draws by HMC, "
                         "NUTS or ADVI with a mixture acquisition")
    ap.add_argument("--mll-method", default="chol",
                    choices=["chol", "sweep", "chol64"])
    ap.add_argument("--route-blocked", action="store_true",
                    help="let 192 <= N <= 1024 take the blocked-Cholesky "
                         "kernels (with --mll-method sweep)")
    ap.add_argument("--sweep-variant", default="select", choices=VARIANTS)
    ap.add_argument("--study-chunk", type=int, default=0,
                    help="studies per campaign (0: all in one)")
    ap.add_argument("--checkpoint", action="store_true",
                    help="checkpoint each (value, chunk) campaign in "
                         "<out>.chunks/")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = _card(device)
    dtype = torch.float64 if args.f64 else torch.float32
    bench = getattr(benchmarks, args.benchmark)
    cfg = CampaignConfig(n_evaluations=args.evals, noise_std=args.sigma,
                         fit_method=args.fit_method,
                         mll_method=args.mll_method,
                         route_blocked=args.route_blocked,
                         sweep_variant=args.sweep_variant)

    rows = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as fh:
            rows = json.load(fh).get("rows", [])
        if rows:
            print(f"# resuming; values done: {[r['value'] for r in rows]}",
                  flush=True)
    done = {r["value"] for r in rows}

    def persist() -> dict:
        summary = {"benchmark": args.benchmark, "axis": args.axis,
                   "sigma": args.sigma, "evals": args.evals,
                   "studies": args.studies, "device": str(device),
                   "card": card, "dtype": str(dtype).split(".")[-1],
                   "prng": PRNG, "rows": rows}
        if args.out:
            ckpt.write_atomic(args.out, lambda fh: fh.write(
                json.dumps(summary, indent=1).encode()))
        return summary

    cache_dir = f"{args.out}.chunks" if args.out else None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    chunk = min(args.study_chunk or args.studies, args.studies)
    for v in args.values:
        if v in done:
            continue
        M = v if args.axis == "tasks" else args.tasks
        N = args.points if args.axis == "tasks" else v
        t0 = time.perf_counter()
        parts = []
        for c0 in range(0, args.studies, chunk):
            stem = (os.path.join(cache_dir, f"v{v}_c{c0}") if cache_dir
                    else None)
            if stem and os.path.exists(stem + ".npy"):
                parts.append(np.load(stem + ".npy"))
                continue
            seeds = range(args.seed_offset + c0,
                          args.seed_offset + min(c0 + chunk, args.studies))
            fn, tp, md, optima = campaign_inputs_from_benchmark(
                bench, [N] * M, seeds, noise_std=args.sigma, dtype=dtype,
                device=device, optimum_method=args.optimum_method)
            ckpt_path = stem + ".ckpt" if args.checkpoint and stem else None
            if ckpt_path:
                optima = pinned_optima(ckpt_path, optima)
            mfc = (args.meta_fit_chunks
                   if len(seeds) % args.meta_fit_chunks == 0 else 1)
            tc = time.perf_counter()
            res = run_campaign(fn, tp, md, seed=c0, cfg=cfg,
                               meta_fit_chunks=mfc,
                               checkpoint_path=ckpt_path, device=device)
            part = simple_regret(res.y_clean, optima).cpu().numpy()
            print(json.dumps({
                "value": v, "chunk": c0, "studies": len(seeds),
                "run_s": time.perf_counter() - tc,
                "meta_fit_s": res.meta_fit_seconds,
                "iterations_run": len(res.iteration_seconds),
                "mean_iteration_s": (float(np.mean(res.iteration_seconds))
                                     if res.iteration_seconds else None),
                "nonfinite_source_tasks": res.nonfinite_source_tasks,
                "launches": {k: sum(n) for k, n in res.launches.items()}}),
                flush=True)
            if stem:
                ckpt.write_atomic(stem + ".npy",
                                  lambda fh: np.save(fh, part))
            if ckpt_path:
                for f in (ckpt_path + ".npz", ckpt_path + "_optima.npy"):
                    if os.path.exists(f):
                        os.remove(f)
            parts.append(part)
        summary = regret_summary(np.concatenate(parts, axis=0))
        row = {"value": v, "M": M, "N": N, "mll_method": args.mll_method,
               "fit_method": args.fit_method,
               "avg_cum_regret_mean": summary["mean_cumulative_regret"],
               "avg_cum_regret_sem": summary["avg_cum_regret_sem"],
               "median_final_regret": summary["median_final_regret"],
               "wall_s": round(time.perf_counter() - t0, 1), "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        persist()

    rows.sort(key=lambda r: r["value"])
    summary = persist()
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
