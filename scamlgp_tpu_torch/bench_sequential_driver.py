"""Cost of the sequential driver ``ScaMLGPBO`` at tabular-benchmark scale
(port of ``scripts/bench_sequential_driver.py``).

Tabular benchmarks (HPOBench, FCNet, PD1) look their objective up on the
host, so a user drives them one study at a time through ``ScaMLGPBO``:
meta-fit once, then per evaluation a proposal (acquisition) and a report
(refit).  Shapes are the reference experiments':

- ``fcnet``:    3 meta-tasks x 256 points, 80 evaluations, d = 6;
- ``hpobench``: 28 meta-tasks x 64 points, 60 evaluations, d = 4.

The meta-data are synthetic (the driver's cost is set by the shapes, not
the values) and the objective is a quadratic evaluated on the host, as a
table lookup would be; both are drawn from ``default_rng(seed)`` exactly as
the JAX script draws them (``scenario_inputs``).

One JSON line per scenario: the script's medians, p90 and initialization
seconds, the loop's total, the iterations slower than 5x the median
(``outlier_iters``), and ``stages``, the ``GLOBAL_TIMER`` split into
``meta_fit``, ``refit`` and ``acquisition`` (total and per-evaluation
median); then one line with every row.  Dropped from the JAX script:
``--capacity-hint`` and its ``capacity_hint`` key, which pre-size the JAX
driver's padded target buffers, and the reading of its recompile
iterations: the port's driver has no compile buckets, so its slow
iterations are only outliers.  ``--cpu`` (a virtual CPU topology) becomes
``--device``; ``backend`` becomes ``device`` and ``card``.

    python -m scamlgp_tpu_torch.bench_sequential_driver
        [--scenarios fcnet hpobench] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.bo.core import Evaluation, Objective
from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER

SCENARIOS = {
    "fcnet": {"M": 3, "Nm": 256, "evals": 80, "d": 6},
    "hpobench": {"M": 28, "Nm": 64, "evals": 60, "d": 4},
}

def scenario_inputs(spec: dict, seed: int = 0):
    """(search space, objective function, meta-data) of a scenario, drawn
    from ``default_rng(seed)`` in the JAX script's order."""
    M, Nm, d = spec["M"], spec["Nm"], spec["d"]
    rng = np.random.default_rng(seed)
    space = ParameterSpace()
    for j in range(d):
        space.add(ContinuousParameter(f"x{j}", (0.0, 1.0)))
    center = rng.uniform(0.2, 0.8, size=d)

    def objective_fn(cfg):
        x = np.asarray([cfg[f"x{j}"] for j in range(d)])
        return float(np.sum((x - center) ** 2))

    meta = {}
    for t in range(M):
        shift = center + 0.05 * rng.normal(size=d)
        evals = []
        for _ in range(Nm):
            u = rng.uniform(size=d)
            evals.append(Evaluation(
                configuration={f"x{j}": float(u[j]) for j in range(d)},
                objectives={"loss": float(np.sum((u - shift) ** 2)
                                          + 0.01 * rng.normal())}))
        meta[f"task{t}"] = evals
    return space, objective_fn, meta


def run_scenario(name: str, spec: dict, seed: int = 0, device=None) -> dict:
    """Meta-fit, then ``spec["evals"]`` generate / evaluate / report
    rounds, the driver in its own dtype (float64); the row of seconds."""
    device = resolve_device(device)
    space, objective_fn, meta = scenario_inputs(spec, seed)
    GLOBAL_TIMER.reset()
    t0 = time.perf_counter()
    opt = ScaMLGPBO(space, Objective("loss", False), meta, seed=seed,
                    device=device)
    init_s = time.perf_counter() - t0
    per_eval = {"refit": [], "acquisition": []}   # GLOBAL_TIMER stages
    gen_times, rep_times = [], []
    for _ in range(spec["evals"]):
        before = dict(GLOBAL_TIMER.totals)
        t0 = time.perf_counter()
        s = opt.generate_evaluation_specification()
        t1 = time.perf_counter()
        y = objective_fn(s.configuration)
        opt.report(Evaluation(configuration=s.configuration,
                              objectives={"loss": y}))
        t2 = time.perf_counter()
        gen_times.append(t1 - t0)
        rep_times.append(t2 - t1)
        for k in per_eval:
            per_eval[k].append(GLOBAL_TIMER.totals.get(k, 0.0)
                               - before.get(k, 0.0))
    gen, rep = np.asarray(gen_times), np.asarray(rep_times)
    tot = gen + rep
    med = float(np.median(tot))
    totals = dict(GLOBAL_TIMER.totals)
    return {
        "scenario": name, **spec, "seed": seed,
        "dtype": str(opt.dtype).replace("torch.", ""),
        "meta_fit_plus_build_s": init_s,
        "total_loop_s": float(tot.sum()),
        "per_iter_median_s": med,
        "per_iter_p90_s": float(np.percentile(tot, 90)),
        "generate_median_s": float(np.median(gen)),
        "report_median_s": float(np.median(rep)),
        "outlier_iters": [int(i) for i in np.nonzero(tot > 5 * med)[0]],
        "steady_state_iters_per_s": 1.0 / med,
        "stages": {
            "meta_fit_s": totals.get("meta_fit", 0.0),
            **{f"{k}_total_s": totals.get(k, 0.0) for k in per_eval},
            **{f"{k}_median_s": float(np.median(v))
               for k, v in per_eval.items()},
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", nargs="*", default=list(SCENARIOS),
                    choices=list(SCENARIOS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device), "card": _card(device), "rows": []}
    for name in args.scenarios:
        row = run_scenario(name, SCENARIOS[name], device=device)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
