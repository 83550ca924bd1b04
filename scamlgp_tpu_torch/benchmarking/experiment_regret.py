"""Regret of one experiment's persisted results, beside a committed regret
row of the JAX package.

    python -m scamlgp_tpu_torch.benchmarking.experiment_regret MODULE KEY
        [--submit] [--device cuda] [--output-root DIR] [--compare ROW.npy]

``MODULE`` names a configuration module (``branin``, ``hartmann6``, ...)
and ``KEY`` one of its experiments.  With ``--submit`` the experiment first
runs as ``python -m scamlgp_tpu_torch.benchmarking.configurations.MODULE
submit KEY --device DEVICE`` runs it (``local_runner.main``, one process),
with the campaign's stages timed (``utils.profiling.GLOBAL_TIMER``).  Then
the results are read back through ``utils.load_results_from_disk``, each
study's running-min regret of the noise-free objective is taken
(``plotting._regret_curves``), and one JSON line is printed: the regret
summary and, with ``--compare``, the committed row's statistics
(``validate.regret_summary`` and ``validate.compare``), the stages, the
seconds and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking import local_runner
from scamlgp_tpu_torch.benchmarking.plotting import _regret_curves
from scamlgp_tpu_torch.benchmarking.utils import load_results_from_disk
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER
from scamlgp_tpu_torch.validate import _card, compare, regret_summary

CONFIGURATIONS = "scamlgp_tpu_torch.benchmarking.configurations"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("module")
    ap.add_argument("key")
    ap.add_argument("--submit", action="store_true",
                    help="run the experiment before reading its results")
    ap.add_argument("--device", default=None)
    ap.add_argument("--output-root", default=None,
                    help="root of the results directories (default: the "
                         "repository)")
    ap.add_argument("--compare", default=None,
                    help="a committed (studies, evaluations) regret row")
    args = ap.parse_args(argv)

    module = f"{CONFIGURATIONS}.{args.module}"
    config = importlib.import_module(module).EXPERIMENTS[args.key]
    out = {"module": module, "key": args.key}
    if args.submit:
        device = resolve_device(args.device)
        GLOBAL_TIMER.reset()
        t0 = time.perf_counter()
        local_runner.main(config, module, args.key, 1,
                          output_root=args.output_root, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        out.update(device=str(device), card=_card(device),
                   submit_s=time.perf_counter() - t0,
                   stages=GLOBAL_TIMER.report())
    results = load_results_from_disk({args.key: config}, module,
                                     args.output_root)
    studies = sorted(results[args.key]["studies"], key=lambda s: s["seed"])
    reg = _regret_curves(studies)
    out.update(studies=len(studies), evaluations=int(reg.shape[1]),
               **regret_summary(reg),
               final_regret_25_75=[float(v) for v in
                                   np.percentile(reg[:, -1], [25, 75])])
    if args.compare:
        out["compare"] = compare(np.load(args.compare), reg)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
