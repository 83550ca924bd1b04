"""Full-size Branin T8 campaign of the port, for comparison with the JAX
package's committed curve ``docs/branin_t8_p32_n1_regrets_tpu_128studies.npy``.

    python -m scamlgp_tpu_torch.validate [--studies 128] [--evals 40]
        [--mll-method sweep] [--seed 0] [--out regrets.npy] [--device cuda]

Branin, 8 meta-tasks x 32 points, noise 1.0, the CampaignConfig defaults,
float32.  Prints one JSON line with the median simple regret
per iteration, the timings, the sweep kernel's launches, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.benchmarks import Branin
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.ops import sweep
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
)

TASKS, POINTS = 8, 32


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=128)
    ap.add_argument("--evals", type=int, default=40)
    ap.add_argument("--mll-method", default="sweep", choices=["chol", "sweep"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="save the (S, E) regrets")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    fn, tp, md, optima = campaign_inputs_from_benchmark(
        Branin, [POINTS] * TASKS, range(args.studies),
        noise_std=1.0, dtype=torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    cfg = CampaignConfig(n_evaluations=args.evals, noise_std=1.0,
                         mll_method=args.mll_method)
    sweep.sweep_inverse.launches = 0
    t0 = time.perf_counter()
    res = run_campaign(fn, tp, md, seed=args.seed, cfg=cfg, device=device)
    run_s = time.perf_counter() - t0
    reg = simple_regret(res.y_clean, optima).cpu().numpy()
    med = np.median(reg, axis=0)
    out = {
        "benchmark": "Branin", "tasks": TASKS, "points": POINTS,
        "studies": args.studies, "evals": args.evals,
        "dtype": "float32",
        "mll_method": args.mll_method, "device": str(device),
        "card": _card(device),
        "setup_s": setup_s, "run_s": run_s,
        "meta_fit_s": res.meta_fit_seconds,
        "mean_iteration_s": float(np.mean(res.iteration_seconds)),
        "sweep_launches": sweep.sweep_inverse.launches,
        "sweep_launches_meta_fit": res.sweep_launches[0],
        "sweep_launches_per_iteration": res.sweep_launches[1:],
        "median_regret": [float(v) for v in med],
        "median_final_regret": float(med[-1]),
        "mean_final_regret": float(reg[:, -1].mean()),
        "mean_cumulative_regret": float(reg.mean()),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        np.save(args.out, reg)
    return out


if __name__ == "__main__":
    main()
