"""BASELINE.json config 4, the many-task regime: quadratic meta-tasks, the
source-GP stack fitted as one batch and task-sharded
(``scripts/run_many_tasks.py``).

    python -m scamlgp_tpu_torch.many_tasks [--tasks 32 64 128]
        [--points 32] [--restarts 5] [--steps 60] [--repeats 3]
        [--slots N] [--slots-at-once] [--mll-method chol|sweep]
        [--campaign] [--evals 16]
        [--device cuda] [--out many_tasks.json]

For each M of ``--tasks``, M quadratic meta-tasks of ``--points`` points
(the JAX script's ``build_meta``: numpy's generator seeded 0 draws each
task's a, b, c and its points; float32) are fitted by
``meta_fit_task_stack`` as one batch on one device, and by
``meta_fit_sharded`` with the task axis over ``--slots`` slots
(``mesh.local_slots``: every card where ``--device cuda`` finds several,
else slots of the one device; 4 by default on one device), the slots one
after another, or at once with ``--slots-at-once`` (``mesh.run_slots``).
Both start from one restart stack (``init_stack``: the warm start, then
``--restarts`` prior draws of a generator seeded 0).  Each leg's time is
the median of ``--repeats`` fits after one untimed warm-up fit, the device
synchronized after each.

The sharded fit is held to the one batch by ``meta_fit_split``'s rule
(``SPLIT_META_TOL``: in float32 the batch size moves last bits, so each
task's float64 MAP objective is compared, and every task must end at or
below its warm start), and each slot bit for bit to that slot's tasks
fitted alone.  ``--campaign`` adds a lock-step campaign at the largest M
(Quadratic meta-data with noise 0.05, study seeds 0-3, ``--evals``
evaluations, device optima, the meta-fit in batches of 32 studies' worth
of tasks, as the JAX script's).  Prints one JSON line: the rows, the
campaign, the device and the card's name and power limit (each row also
goes to the standard error as it ends); exits 1 where a row's sharded fit
fails these checks or the campaign's regret is not finite.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.benchmarks import Quadratic
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.meta_fit_split import (
    SPLIT_META_TOL,
    map_objective64,
)
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.parallel import scamlgp_sharded as sh
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
)
from scamlgp_tpu_torch.parallel.mesh import local_slots, make_mesh, split_rows
from scamlgp_tpu_torch.validate import _card


def build_meta(M: int, N: int, device, seed: int = 0) -> m.TaskData:
    """M quadratic meta-tasks x N points: a^2 (x + b)^2 + c with a, b, c
    and x uniform (the JAX script's ``build_meta``), float32."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(M):
        a = rng.uniform(0.5, 1.5)
        b = rng.uniform(-0.9, 0.9)
        c = rng.uniform(-1.0, 1.0)
        x = rng.uniform(size=(N, 1))
        xs.append(x)
        ys.append(a ** 2 * (x[:, 0] + b) ** 2 + c)
    return m.pack_task_data(xs, ys, dtype=torch.float32, device=device)


def init_stack(cfg, data: m.TaskData, restarts: int) -> gp.GPParams:
    """The restart stack of ``data``'s tasks: the warm start, then
    ``restarts`` prior draws of a generator seeded 0, on the data's
    device."""
    T, _, d = data.X.shape
    warm = gp.init_params(cfg, d, data.X.dtype, data.X.device,
                          batch_shape=(T,))
    draws = gp.sample_params(cfg, torch.Generator().manual_seed(0), d,
                             data.X.dtype, batch_shape=(T, restarts))
    return fit_lib.stack_restarts(
        warm, fit_lib.tree_map(lambda leaf: leaf.to(data.X.device), draws),
        1)


def _sync(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def time_fit(fit, devices, repeats: int):
    """(the last result, the median seconds of ``repeats`` fits after one
    untimed warm-up fit)."""
    out = fit()
    seconds = []
    for _ in range(repeats):
        _sync(devices)
        t0 = time.perf_counter()
        out = fit()
        _sync(devices)
        seconds.append(time.perf_counter() - t0)
    return out, statistics.median(seconds)


def run_row(M: int, args, device, slots) -> dict:
    """One M: the one-batch and the sharded fit, timed and held to each
    other, and each slot to its tasks fitted alone."""
    cfg = gp.source_gp_config()
    data = build_meta(M, args.points, device)
    padded = sh.pad_task_data(data, len(slots))
    T = padded.X.shape[0]
    init = init_stack(cfg, padded, args.restarts)
    warm = fit_lib.tree_map(lambda leaf: leaf[:, 0], init)
    mesh = make_mesh(study=1, devices=slots, at_once=args.slots_at_once)
    kw = dict(num_steps=args.steps, mll_method=args.mll_method)
    single, single_s = time_fit(lambda: m.meta_fit_task_stack(
        data, cfg, init_stack=fit_lib.tree_map(lambda leaf: leaf[:M], init),
        **kw), [device], args.repeats)
    sharded, sharded_s = time_fit(lambda: sh.meta_fit_sharded(
        data, cfg, None, mesh, init_stack=init, **kw), slots, args.repeats)
    # each slot alone, on its own device, against its rows of the sharded fit
    k = T // len(slots)
    slot_equal = []
    for j, (local, init_j) in enumerate(zip(split_rows(padded, slots),
                                            split_rows(init, slots))):
        alone = m.meta_fit_task_stack(local, cfg, init_stack=init_j, **kw)
        slot_equal.append(all(
            torch.equal(a, b[j * k:(j + 1) * k].to(a.device))
            for a, b in zip(fit_lib.tree_leaves(alone),
                            fit_lib.tree_leaves(sharded))))
    o_1 = map_objective64(cfg, single.params, data)
    o_s = map_objective64(cfg, fit_lib.tree_map(lambda leaf: leaf[:M],
                                                sharded.params), data)
    o_warm = map_objective64(cfg, fit_lib.tree_map(lambda leaf: leaf[:M],
                                                   warm), data)
    gaps = (o_s - o_1).abs() / o_1.abs().clamp_min(1.0)
    median, p90 = gaps.median().item(), torch.quantile(gaps, 0.9).item()
    within = (bool(torch.isfinite(gaps).all())
              and median <= SPLIT_META_TOL["median"]
              and p90 <= SPLIT_META_TOL["p90"]
              and bool((o_s <= o_warm).all()))
    return {"M": M, "single_s": single_s, "tasks_per_s": M / single_s,
            "sharded_s": sharded_s, "slots": len(slots),
            "objective_gap_median": median, "objective_gap_p90": p90,
            "objective_gap_max": gaps.max().item(),
            "sharded_within_split_tol": within,
            "slots_equal_alone": slot_equal,
            "sharded_matches_single": within and all(slot_equal)}


def run_campaign_leg(M: int, args, device) -> dict:
    """The JAX script's ``--campaign``: M tasks, 4 studies."""
    fn, tps, md, optima = campaign_inputs_from_benchmark(
        Quadratic, [args.points] * M, [0, 1, 2, 3], noise_std=0.05,
        dtype=torch.float32, device=device, optimum_method="device")
    cfg = CampaignConfig(n_evaluations=args.evals, noise_std=0.05,
                         mll_method=args.mll_method)
    t0 = time.perf_counter()
    res = run_campaign(fn, tps, md, seed=0,
                       cfg=cfg, meta_fit_restarts=args.restarts,
                       meta_fit_steps=args.steps,
                       meta_fit_chunks=max(1, M // 32), device=device)
    _sync([device])
    reg = simple_regret(res.y_clean, optima)
    return {"tasks": M, "studies": 4, "evals": args.evals,
            "wall_s": time.perf_counter() - t0,
            "meta_fit_s": res.meta_fit_seconds,
            "iteration_s": res.iteration_seconds,
            "median_final_regret": reg[:, -1].median().item(),
            "finite": bool(torch.isfinite(reg).all())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", nargs="+", type=int, default=[32, 64, 128])
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--restarts", type=int, default=5)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--slots", type=int, default=None,
                    help="task slots (default: every card where there are "
                         "several, else 4 of the one device)")
    ap.add_argument("--slots-at-once", action="store_true",
                    help="run the slots at once, a host thread each")
    ap.add_argument("--mll-method", default="chol", choices=["chol", "sweep"])
    ap.add_argument("--campaign", action="store_true")
    ap.add_argument("--evals", type=int, default=16)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    n = args.slots or (cards if device.index is None and cards > 1 else 4)
    slots = local_slots(device, n)
    result = {"device": str(device), "card": _card(device),
              "device_count": cards, "slots": [str(s) for s in slots],
              "points": args.points, "restarts": args.restarts,
              "steps": args.steps, "repeats": args.repeats,
              "slots_at_once": args.slots_at_once,
              "mll_method": args.mll_method,
              "split_meta_tol": SPLIT_META_TOL,
              "rows": []}
    for M in args.tasks:
        result["rows"].append(run_row(M, args, device, slots))
        print(json.dumps({"row": result["rows"][-1]}), file=sys.stderr,
              flush=True)
    if args.campaign:
        result["campaign"] = run_campaign_leg(max(args.tasks), args, device)
    result["ok"] = (all(r["sharded_matches_single"] for r in result["rows"])
                    and result.get("campaign", {}).get("finite", True))
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
