"""Whether a task's lock-step meta-fit depends on the other tasks in its
batch.

    python -m scamlgp_tpu_torch.meta_fit_split [--device cuda] [--tasks 128]
        [--points 32] [--splits 4] [--seeds 0 1 2 3 4] [--steps 50]
        [--restarts 3] [--dtype float32] [--mll-method sweep]

The meta-data of the Quadratic campaign's first study (``--tasks`` x
``--points``, d=1, noise 0.05: the smoke's task-sharded leg) is fitted by
``meta_fit_task_stack`` from one restart stack (the warm start, then
``--restarts`` prior draws of ``torch.Generator().manual_seed(seed)``)
three ways: as one batch (``one``); as ``--splits`` batches of consecutive
tasks, one after another, which is what ``meta_fit_sharded`` runs on a task
mesh of ``--splits`` slots (``split``); and as one batch with the tasks in
a random order (``permuted``: the same batch size, other positions).

L-BFGS treats every row as its own problem (a row that has finished its
line search is frozen while the others go on), so only rounding that
depends on the batch can tell the three apart.  Each fit's MAP objective
is evaluated in float64, on the parameters and the data cast to it: in
float32 the objective at a fitted point carries rounding noise of up to
1e-3 relative (a nearly singular Gram matrix), enough to move with the
memory layout of the parameters alone (on the CPU, strided and
contiguous copies of the same values evaluate differently).  For each
seed, one JSON line: each way's summed objective and seconds, and for
``split`` and ``permuted`` against ``one`` the tasks whose fitted
parameters are equal bit for bit, the tasks whose objective is lower or
higher by more than 1e-6 relative, and the median, 90th percentile and
largest gap relative to max(1, |objective|); and the one-batch fit's
objective in the data's dtype against the float64 one, and with its parameters
strided (as the fit returns them) against contiguous.  A last line sums
the seeds.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from scamlgp_tpu_torch.benchmarking.benchmarks import Quadratic
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m

#: a gap below this, relative, counts as neither lower nor higher
SAME_RTOL = 1e-6


def _timed(device, fn):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def map_objective64(cfg, params, data: m.TaskData) -> torch.Tensor:
    """Per-task MAP objective of ``params`` on ``data``, both cast to
    float64 and contiguous."""
    def f64(leaf):
        return leaf.to(torch.float64).contiguous()

    return gp.map_objective(cfg, fit_lib.tree_map(f64, params),
                            *[f64(leaf) for leaf in data[:3]])


def same_params(a, b) -> torch.Tensor:
    """Per task, whether every parameter of ``a`` equals ``b``'s."""
    eq = [(x == y).reshape(len(x), -1).all(-1)
          for x, y in zip(fit_lib.tree_leaves(a), fit_lib.tree_leaves(b))]
    return torch.stack(eq).all(0)


def compare(ref: torch.Tensor, other: torch.Tensor, equal) -> dict:
    """Per-task MAP objectives ``other`` against ``ref``; ``equal``: the
    tasks whose parameters are equal."""
    gap = (other - ref) / ref.abs().clamp_min(1.0)
    return {"equal": int(equal.sum()),
            "lower": int((gap < -SAME_RTOL).sum()),
            "higher": int((gap > SAME_RTOL).sum()),
            "gap_median": gap.abs().median().item(),
            "gap_p90": torch.quantile(gap.abs(), 0.9).item(),
            "gap_max": gap.abs().max().item(),
            "sum_minus_one": (other - ref).sum().item()}


def run_seed(data: m.TaskData, cfg, seed: int, args, device) -> dict:
    T, _, d = data.X.shape
    dtype = data.X.dtype
    warm = gp.init_params(cfg, d, dtype, batch_shape=(T,))
    draws = gp.sample_params(cfg, torch.Generator().manual_seed(seed), d,
                             dtype, batch_shape=(T, args.restarts))
    init = fit_lib.tree_map(lambda leaf: leaf.to(device),
                            fit_lib.stack_restarts(warm, draws, batch_ndim=1))

    def fit(rows):
        return m.meta_fit_task_stack(
            m.TaskData(*[leaf[rows] for leaf in data]), cfg,
            num_steps=args.steps, mll_method=args.mll_method,
            init_stack=fit_lib.tree_map(lambda leaf: leaf[rows], init))

    everyone = torch.arange(T, device=device)
    one, one_s = _timed(device, lambda: fit(everyone))
    size = -(-T // args.splits)

    def split():
        parts = [fit(everyone[i:i + size]) for i in range(0, T, size)]
        return fit_lib.tree_map(lambda *leaves: torch.cat(leaves),
                                *[p.params for p in parts])

    split_params, split_s = _timed(device, split)
    order = torch.randperm(T, generator=torch.Generator().manual_seed(seed))
    order = order.to(device)
    perm, perm_s = _timed(device, lambda: fit(order))
    back = torch.argsort(order)
    perm_params = fit_lib.tree_map(lambda leaf: leaf[back], perm.params)
    o_one = map_objective64(cfg, one.params, data)
    # the one-batch fit's objective in the data's dtype: its parameters as
    # the fit returns them (strided) and as contiguous copies, against
    # float64
    o32 = gp.map_objective(cfg, one.params, *data[:3])
    o32c = gp.map_objective(cfg, fit_lib.tree_map(
        lambda leaf: leaf.contiguous(), one.params), *data[:3])
    noise32 = (o32.double() - o_one).abs() / o_one.abs().clamp_min(1.0)
    o_split = map_objective64(cfg, split_params, data)
    o_perm = map_objective64(cfg, perm_params, data)
    return {"seed": seed, "dtype": str(dtype).replace("torch.", ""),
            "sum": {"one": o_one.sum().item(), "split": o_split.sum().item(),
                    "permuted": o_perm.sum().item()},
            "seconds": {"one": one_s, "split": split_s, "permuted": perm_s},
            "one_objective_in_dtype": {
                "equal_strided_contiguous": int((o32 == o32c).sum()),
                "gap_to_float64_median": noise32.median().item(),
                "gap_to_float64_max": noise32.max().item()},
            "split": compare(o_one, o_split,
                             same_params(one.params, split_params)),
            "permuted": compare(o_one, o_perm,
                                same_params(one.params, perm_params))}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--tasks", type=int, default=128)
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--splits", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--restarts", type=int, default=3)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--mll-method", default="sweep",
                    choices=["chol", "sweep", "chol64"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    _, _, md, _ = campaign_inputs_from_benchmark(
        Quadratic, [args.points] * args.tasks, [0], noise_std=0.05,
        dtype=getattr(torch, args.dtype), device=device)
    data = m.TaskData(*[leaf[0] for leaf in md])
    cfg = gp.source_gp_config()
    lines = []
    for seed in args.seeds:
        lines.append(run_seed(data, cfg, seed, args, device))
        print(json.dumps(lines[-1]), flush=True)
    total = {"device": str(device), "tasks": args.tasks,
             "points": args.points, "splits": args.splits,
             "steps": args.steps, "restarts": args.restarts,
             "mll_method": args.mll_method, "seeds": args.seeds,
             "split_lower_sum_seeds": sum(
                 ln["sum"]["split"] < ln["sum"]["one"] for ln in lines),
             "permuted_lower_sum_seeds": sum(
                 ln["sum"]["permuted"] < ln["sum"]["one"] for ln in lines)}
    for way in ("split", "permuted"):
        for k in ("equal", "lower", "higher"):
            total[f"{way}_{k}"] = sum(ln[way][k] for ln in lines)
    print(json.dumps(total), flush=True)
    return lines


if __name__ == "__main__":
    main()
