"""Full-size campaign of the port on a synthetic benchmark, for comparison
with the JAX package's committed regret rows.

    python -m scamlgp_tpu_torch.validate [--benchmark Branin] [--tasks 8]
        [--points 32] [--sigma 1.0] [--studies 128] [--evals 40]
        [--mll-method sweep|chol|chol64] [--fit-method map|hmc|nuts|vi]
        [--route-blocked]
        [--sweep-variant select] [--optimum-method shgo] [--seed 0]
        [--study-chunk K] [--shard-studies N [--slots-at-once]]
        [--checkpoint PATH]
        [--stop-after N] [--loop host|device]
        [--out regrets.npy] [--compare curve.npy] [--device cuda]
        [--driver campaign|sequential]

The defaults are the Branin T8 run of the committed curve
``docs/branin_t8_p32_n1_regrets_tpu_128studies.npy``: 8 meta-tasks x 32
points, noise 1.0.  The points-per-task ablation rows are
``--points 256 --studies 16 --route-blocked`` (Branin, committed in
``docs/branin_ablation_points_n256_tpu.json``; ``--mll-method chol64``
assembles and factors those systems in float64) and ``--benchmark
Hartmann6D --points 512 --sigma 0.1 --studies 16 --evals 80
--route-blocked --optimum-method device`` (``docs/hm6_ablation_points_tpu.json``).
The paper's main Hartmann6D cell, T8 N_m=128 (committed curve
``docs/hm6_t8_p128_n01_regrets_tpu_128studies.npy``), is ``--benchmark
Hartmann6D --points 128 --sigma 0.1 --evals 80 --optimum-method device``;
``--sweep-variant fused`` runs it as the reference's
``SCAMLGP_SWEEP_STEP=fused``.  The many-task configuration of BASELINE.json
(config 4) is ``--benchmark Quadratic --tasks 128 --points 32 --sigma 0.05
--studies 4 --evals 16``.  ``--fit-method hmc|nuts|vi`` draws each
refit from the target parameters' posterior (the CampaignConfig sampler
defaults) and acquires under the draws' mixture: the committed rows are
``docs/branin_t8_p32_n1_{hmc,vi}_regrets_tpu_16studies.npy`` (``--studies
16``) and, with NUTS, ``docs/hm6_t8_p128_n01_nuts_regrets_tpu_16studies.npy``
(the Hartmann6D cell, ``--studies 16``).  Always the CampaignConfig
defaults and float32.  Prints one JSON line with the median simple regret per
iteration, the timings (and the campaign's stages from
``utils.profiling.GLOBAL_TIMER``), each kernel's launches, and the card's
name and power limit.

``--study-chunk K`` runs the BO loop over chunks of K studies, one after
another.  ``--checkpoint PATH`` writes the campaign's state to
``PATH.npz`` (``run_campaign``'s ``checkpoint_path``) and the studies'
optima to ``PATH_optima.npy``; run the same command again to resume from
it.  ``--stop-after N`` (not with ``--study-chunk``) returns after N
iterations; the JSON line then summarizes the iterations completed.

``--shard-studies N`` splits the studies over a study mesh of N slots
(``parallel.mesh``): the card repeated N times, or N cards where
``--device cuda`` finds that many (``mesh.local_slots``), each slot its
rows' meta-fit and iterations, the slots one after another, or at once
with ``--slots-at-once`` (``mesh.run_slots``: a host thread and a CUDA
stream a slot).  Not with ``--study-chunk``.

``--loop device`` runs the campaign's iterations with no host sync
(``run_campaign(loop="device")``): on a card, iteration 0 eagerly and
every later one as a replay of one captured CUDA graph; the JSON line then
holds the graph's capture and instantiate seconds, its kernel nodes and
the device memory around them (``graph``).  Not with ``--study-chunk``,
``--checkpoint`` or ``--stop-after``.  The default is ``host``.  On a
card, ``peak_memory_bytes`` is the campaign's peak allocated memory
(meta-fit included) under either loop.

``--driver sequential`` runs the same experiment study by study through
the sequential driver instead, as the reference runs it: for each study
seed, ``run_study(ScaMLGPBO, {}, benchmark, {"n_data_per_task": ...},
evals, seed, HomoscedasticGaussianNoise({"loss": sigma}))``, float64 on
the Cholesky route with the driver's defaults (5 restarts, 60 L-BFGS
steps, UCB(9), 1024 raw samples, 8 starts x 50 ascent steps).  Its regret
is the best noise-free loss so far minus the study's optimum; its JSON
line holds the same summary, with the driver's stages (``meta_fit``,
``refit``, ``acquisition``) and each study's seconds.  ``--fit-method``
applies to it too (the driver's own sampler defaults).  The campaign's
``--mll-method``, ``--route-blocked``, ``--sweep-variant`` and
``--optimum-method`` do not apply to it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking import benchmarks
from scamlgp_tpu_torch.benchmarking.local_runner import run_study
from scamlgp_tpu_torch.benchmarking.noise import HomoscedasticGaussianNoise
from scamlgp_tpu_torch.bo import ScaMLGPBO
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
from scamlgp_tpu_torch.parallel.mesh import local_slots, make_mesh
from scamlgp_tpu_torch.utils import checkpoint as ckpt
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def pinned_optima(checkpoint, optima: torch.Tensor) -> torch.Tensor:
    """The optima of the target tasks that a campaign checkpointed at
    ``checkpoint`` restores.  Targets are drawn unseeded, so a new process
    draws others: where the checkpoint exists, the optima written beside
    it (``<checkpoint>_optima.npy``) are returned; otherwise ``optima``,
    written there first."""
    path = str(checkpoint) + "_optima.npy"
    if ckpt.exists(checkpoint) and os.path.exists(path):
        return torch.as_tensor(np.load(path), dtype=optima.dtype,
                               device=optima.device)
    ckpt.write_atomic(path, lambda fh: np.save(fh, optima.cpu().numpy()))
    return optima


def compare(ref: np.ndarray, reg: np.ndarray, seed: int = 0,
            draws: int = 2000) -> dict:
    """A committed regret curve ``ref`` (S_ref, E) beside a run's ``reg``
    (S, E): the reference's median final and average cumulative regret
    (mean +- SEM over studies), and the 2.5 / 50 / 97.5 percentiles of the
    median final regret over ``draws`` random S-study subsets of the
    reference: the spread that S studies of the reference itself give."""
    S = reg.shape[0]
    cum = ref.mean(axis=1)
    rng = np.random.default_rng(seed)
    sub = [np.median(ref[rng.choice(len(ref), S, replace=False), -1])
           for _ in range(draws)] if S <= len(ref) else []
    return {"ref_studies": int(ref.shape[0]),
            "ref_median_final_regret": float(np.median(ref[:, -1])),
            "ref_final_regret_25_75": [float(v) for v in
                                       np.percentile(ref[:, -1], [25, 75])],
            "ref_median_first_regret": float(np.median(ref[:, 0])),
            "ref_mean_cumulative_regret": float(cum.mean()),
            "ref_avg_cum_regret_sem": float(cum.std(ddof=1)
                                            / np.sqrt(len(cum))),
            "ref_median_final_subsets_2.5_50_97.5":
                [float(v) for v in np.percentile(sub, [2.5, 50, 97.5])]
                if sub else None}


def study_regret(result: dict) -> np.ndarray:
    """Best noise-free loss so far minus the study's optimum, per
    evaluation of one ``run_study`` result."""
    losses = [e["objectives"]["loss (noise free)"]
              for e in result["evaluations"]]
    return np.minimum.accumulate(losses) - result["optimum"]


def regret_summary(reg: np.ndarray) -> dict:
    """The JSON line's regret entries for an (S, E) regret array."""
    med = np.median(reg, axis=0)
    cum = reg.mean(axis=1)      # each study's average cumulative regret
    return {
        "median_regret": [float(v) for v in med],
        "median_final_regret": float(med[-1]),
        "mean_final_regret": float(reg[:, -1].mean()),
        "mean_cumulative_regret": float(reg.mean()),
        "avg_cum_regret_sem": float(cum.std(ddof=1) / np.sqrt(len(cum)))
        if len(cum) > 1 else None,
    }


def run_sequential(args, device: torch.device):
    """Study seeds ``--seed`` .. ``--seed + --studies - 1``, each through
    ``run_study`` and the sequential driver; returns (the JSON line, the
    (S, E) regrets)."""
    bench = getattr(benchmarks, args.benchmark)
    kwargs = {} if args.device is None else {"device": args.device}
    if args.fit_method != "map":
        kwargs["fit_method"] = args.fit_method
    GLOBAL_TIMER.reset()
    regrets, study_s = [], []
    t0 = time.perf_counter()
    for seed in range(args.seed, args.seed + args.studies):
        ts = time.perf_counter()
        res = run_study(ScaMLGPBO, kwargs, bench,
                        {"n_data_per_task": [args.points] * args.tasks},
                        args.evals, seed,
                        HomoscedasticGaussianNoise({"loss": args.sigma}))
        study_s.append(time.perf_counter() - ts)
        regrets.append(study_regret(res))
    reg = np.stack(regrets)
    out = {
        "driver": "sequential", "benchmark": args.benchmark,
        "tasks": args.tasks, "points": args.points, "sigma": args.sigma,
        "studies": args.studies, "evals": args.evals,
        "study_seeds": [args.seed, args.seed + args.studies - 1],
        "fit_method": args.fit_method, "dtype": "float64",
        "device": str(device), "card": _card(device),
        "run_s": time.perf_counter() - t0, "study_s": study_s,
        "stages": GLOBAL_TIMER.report(), **regret_summary(reg),
    }
    return out, reg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--benchmark", default="Branin",
                    choices=["Branin", "Hartmann3D", "Hartmann6D",
                             "Quadratic"])
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--studies", type=int, default=128)
    ap.add_argument("--evals", type=int, default=40)
    ap.add_argument("--mll-method", default="sweep",
                    choices=["chol", "sweep", "chol64"],
                    help="the fit objectives' MLL route; chol64 assembles "
                         "and factors each system in float64")
    ap.add_argument("--fit-method", default="map",
                    choices=["map", "hmc", "nuts", "vi"],
                    help="the target fit: MAP, or posterior draws by HMC, "
                         "NUTS or ADVI with a mixture acquisition")
    ap.add_argument("--route-blocked", action="store_true",
                    help="let 192 <= N <= 1024 take the blocked-Cholesky "
                         "kernels (with --mll-method sweep)")
    ap.add_argument("--sweep-variant", default="select", choices=VARIANTS,
                    help="the sweep kernel's step scheme (with --mll-method "
                         "sweep)")
    ap.add_argument("--optimum-method", default="shgo",
                    choices=["shgo", "device"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--study-chunk", type=int, default=None,
                    help="run the BO loop over chunks of at most this many "
                         "studies, one after another (0: all at once)")
    ap.add_argument("--shard-studies", type=int, default=None, metavar="N",
                    help="split the studies over a study mesh of N slots")
    ap.add_argument("--slots-at-once", action="store_true",
                    help="run the mesh's slots at once, a host thread each")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint the campaign at PATH.npz; resumes "
                         "from it when it exists")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="checkpoint and stop after this many iterations")
    ap.add_argument("--loop", default="host", choices=["host", "device"],
                    help="the campaign's loop: the host's, or one with no "
                         "host sync (a CUDA graph replayed per iteration)")
    ap.add_argument("--out", default=None, help="save the (S, E) regrets")
    ap.add_argument("--compare", default=None,
                    help="a committed (S_ref, E) regret curve (.npy) to "
                         "report beside the run")
    ap.add_argument("--device", default=None)
    ap.add_argument("--driver", default="campaign",
                    choices=["campaign", "sequential"],
                    help="the lock-step campaign (float32), or one study "
                         "after another through ScaMLGPBO (float64)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.driver == "sequential":
        out, reg = run_sequential(args, device)
        return _finish(args, out, reg)
    t0 = time.perf_counter()
    fn, tp, md, optima = campaign_inputs_from_benchmark(
        getattr(benchmarks, args.benchmark), [args.points] * args.tasks,
        range(args.studies), noise_std=args.sigma, dtype=torch.float32,
        device=device, optimum_method=args.optimum_method)
    if args.checkpoint:
        optima = pinned_optima(args.checkpoint, optima)
    setup_s = time.perf_counter() - t0
    cfg = CampaignConfig(n_evaluations=args.evals, noise_std=args.sigma,
                         fit_method=args.fit_method,
                         mll_method=args.mll_method,
                         route_blocked=args.route_blocked,
                         sweep_variant=args.sweep_variant)
    mesh = (make_mesh(study=args.shard_studies, task=1,
                      devices=local_slots(device, args.shard_studies),
                      at_once=args.slots_at_once)
            if args.shard_studies else None)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    GLOBAL_TIMER.reset()
    t0 = time.perf_counter()
    res = run_campaign(fn, tp, md, seed=args.seed, cfg=cfg, device=device,
                       mesh=mesh, checkpoint_path=args.checkpoint,
                       stop_after=args.stop_after,
                       study_chunk=args.study_chunk, loop=args.loop)
    run_s = time.perf_counter() - t0
    reg = simple_regret(res.y_clean, optima).cpu().numpy()
    completed = int(res.mask.sum(-1).min())
    if completed < args.evals:
        print(f"# stopped after {completed} of {args.evals} iterations; run "
              "again with the same --checkpoint to resume", file=sys.stderr)
        reg = reg[:, :max(completed, 1)]
    out = {
        "benchmark": args.benchmark, "tasks": args.tasks,
        "points": args.points, "sigma": args.sigma,
        "studies": args.studies, "evals": args.evals,
        "completed_iterations": completed,
        "dtype": "float32", "fit_method": args.fit_method,
        "mll_method": args.mll_method,
        "route_blocked": args.route_blocked,
        "sweep_variant": args.sweep_variant,
        "optimum_method": args.optimum_method,
        "study_chunk": args.study_chunk, "loop": args.loop,
        "shard_studies": args.shard_studies,
        "mesh_slots": (None if mesh is None
                       else [str(dv) for dv in mesh.devices[:, 0]]),
        "checkpoint": args.checkpoint,
        "device": str(device), "card": _card(device),
        "setup_s": setup_s, "run_s": run_s,
        "meta_fit_s": res.meta_fit_seconds,
        "nonfinite_source_tasks": res.nonfinite_source_tasks,
        "iterations_run": len(res.iteration_seconds),
        "mean_iteration_s": (float(np.mean(res.iteration_seconds))
                             if res.iteration_seconds else None),
        "iteration_s": res.iteration_seconds, "graph": res.graph,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
        "stages": GLOBAL_TIMER.report(),
        "launches": {k: sum(v) for k, v in res.launches.items()},
        "launches_meta_fit": {k: v[0] for k, v in res.launches.items()},
        "launches_per_iteration": {k: v[1:] for k, v in res.launches.items()
                                   if sum(v[1:])},
        **regret_summary(reg),
    }
    return _finish(args, out, reg)


def _finish(args, out: dict, reg: np.ndarray) -> dict:
    if args.compare:
        out["compare"] = compare(np.load(args.compare), reg, args.seed)
    print(json.dumps(out), flush=True)
    if args.out:
        np.save(args.out, reg)
    return out


if __name__ == "__main__":
    main()
