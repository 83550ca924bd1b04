"""Which operation makes a lock-step campaign study's result depend on how
many studies share its batch.

    python -m scamlgp_tpu_torch.batch_probe [--device cuda] [--tasks 128]
        [--points 32] [--studies 4] [--chunk 2] [--limit 20000]
    python -m scamlgp_tpu_torch.batch_probe --meta-fit [--tasks 32]
        [--chunk 8] [--steps 2] [--restarts 5] [--mll-method sweep|chol]

One lock-step iteration (``parallel.campaign.run_iteration``: iteration 2
with two points observed, the draws of ``iteration_generator(0, 2)``, the
CampaignConfig defaults and ``mll_method="sweep"``) runs on the Quadratic
campaign's first ``--studies`` studies and on its first ``--chunk``
studies, each under a recorder of every ATen operation (its first
``--limit``).  The two recordings are walked in step.  Each output of the
chunk's run is held against the same rows of the full run's output: the
one axis whose size differs is the study axis, or a flattened axis that
leads with it.  An operation that reduces over the study axis (an input
differs in shape, its output does not) is not compared.

Prints one JSON line: whether the iteration's results agree, the
operations compared, the first operation whose inputs agree and whose
outputs do not (the operation that depends on the batch size) with its
shapes, and the first operation whose output differs at all.  The source
stack is the meta-data conditioned at the initial hyperparameters, without
a meta-fit: that does not change which operation depends on the batch.

``--meta-fit`` probes the source GPs' meta-fit instead: ``--steps`` L-BFGS
steps of ``meta_fit_task_stack`` on ``many_tasks``' quadratic meta-data
(``--tasks`` tasks of ``--points`` points, its restart stack) against the
same fit of its first ``--chunk`` tasks, as a task-sharded fit over
``--tasks / --chunk`` slots runs them.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from scamlgp_tpu_torch.benchmarking.benchmarks import Quadratic
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m
from scamlgp_tpu_torch.parallel import campaign as tc

#: allocations: their outputs hold whatever the memory held
UNCOMPARED = ("aten.empty", "aten.new_empty", "aten.empty_like",
              "aten.empty_strided", "aten.new_empty_strided")


class Recorder(TorchDispatchMode):
    """Keeps a copy of the tensor inputs and outputs of the first ``limit``
    ATen operations."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit, self.calls = limit, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if len(self.calls) < self.limit and not name.startswith(UNCOMPARED):
            def copies(tree):
                return [t.detach().clone() for t in tree_flatten(tree)[0]
                        if isinstance(t, torch.Tensor)]
            self.calls.append((name, copies((args, kwargs)), copies(out)))
        return out


def rows(full: torch.Tensor, part: torch.Tensor):
    """The part of ``full`` that corresponds to ``part``, or None."""
    if full.shape == part.shape:
        return full
    if full.dim() != part.dim():
        return None
    axes = [i for i in range(full.dim()) if full.shape[i] != part.shape[i]]
    if len(axes) != 1 or full.shape[axes[0]] < part.shape[axes[0]]:
        return None
    return full.narrow(axes[0], 0, part.shape[axes[0]])


def same(a, b) -> bool:
    if a is None or a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def shapes(ts):
    return [list(t.shape) for t in ts]


def compare(full_calls, part_calls) -> dict:
    """The first operation whose (mapped) inputs agree and whose outputs do
    not, and the first whose output differs."""
    out = {"compared": 0, "first_output_difference": None,
           "batch_dependent_op": None}
    for k, ((nf, inf, outf), (np_, inp, outp)) in enumerate(
            zip(full_calls, part_calls)):
        if nf != np_ or len(outf) != len(outp):
            out["diverged_at"] = {"index": k, "full": nf, "chunk": np_}
            break
        if any(a.shape != b.shape for a, b in zip(inf, inp)) and all(
                a.shape == b.shape for a, b in zip(outf, outp)):
            continue    # reduces over the study axis
        out["compared"] += 1
        diff = [i for i, (a, b) in enumerate(zip(outf, outp))
                if not same(rows(a, b), b)]
        if not diff:
            continue
        a, b = rows(outf[diff[0]], outp[diff[0]]), outp[diff[0]]
        entry = {"index": k, "op": nf, "inputs_full": shapes(inf),
                 "inputs_chunk": shapes(inp), "outputs_full": shapes(outf),
                 "outputs_chunk": shapes(outp),
                 "max_abs_diff": (None if a is None else
                                  (a.double() - b.double()).abs().max()
                                  .item())}
        if out["first_output_difference"] is None:
            out["first_output_difference"] = entry
        if all(same(rows(a, b), b) for a, b in zip(inf, inp)):
            out["batch_dependent_op"] = entry
            break
    return out


def iteration(fn, tp, md, S, cfg, device):
    """Iteration 2 of a campaign of the first S studies, two points seen."""
    sub = {k: v[:S] for k, v in tp.items()}
    data = m.TaskData(*[leaf[:S] for leaf in md])
    _, M, _, d = data.X.shape
    flat = m.TaskData(*[leaf.reshape((-1,) + leaf.shape[2:])
                        for leaf in data])
    scfg, tcfg = gp.source_gp_config(), gp.target_gp_config()
    params = gp.init_params(scfg, d, data.X.dtype, device,
                            batch_shape=flat.X.shape[:1])
    stack = tc.fit_lib.tree_map(
        lambda leaf: leaf.reshape((S, M) + leaf.shape[1:]),
        m.finalize_source_stack(flat, scfg, params))
    gen = torch.Generator().manual_seed(1)
    E = cfg.n_evaluations
    X = torch.zeros((S, E, d), dtype=data.X.dtype)
    X[:, :2] = torch.rand((S, 2, d), generator=gen, dtype=data.X.dtype)
    X = X.to(device)
    yc = fn(X, {k: v[:, None] for k, v in sub.items()})
    mask = torch.zeros((S, E), dtype=X.dtype, device=device)
    mask[:, :2] = 1.0
    y = yc * mask
    draws = tc._rows(tc.iteration_draws(
        tc.iteration_generator(0, 2), cfg, tcfg, len(next(iter(
            tp.values()))), M, d, X.dtype, device), 0, S)
    p0 = m.init_target_params(tcfg, M, d, X.dtype, device, batch_shape=(S,))
    return tc.run_iteration(fn, stack, sub, X, y, yc * mask, mask, p0, draws,
                            2, scfg, tcfg, cfg)


def meta_fit(data: m.TaskData, T: int, args):
    """``args.steps`` steps of the meta-fit of the first T tasks of
    ``data``, from ``many_tasks``' restart stack."""
    from scamlgp_tpu_torch.many_tasks import init_stack

    cfg = gp.source_gp_config()
    sub = m.TaskData(*[leaf[:T] for leaf in data])
    init = tc.fit_lib.tree_map(lambda leaf: leaf[:T],
                               init_stack(cfg, data, args.restarts))
    return m.meta_fit_task_stack(sub, cfg, num_steps=args.steps,
                                 mll_method=args.mll_method,
                                 init_stack=init)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--tasks", type=int, default=128)
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--studies", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--evals", type=int, default=4)
    ap.add_argument("--limit", type=int, default=20000)
    ap.add_argument("--meta-fit", action="store_true",
                    help="probe the meta-fit of --tasks against --chunk "
                         "tasks")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--restarts", type=int, default=5)
    ap.add_argument("--mll-method", default="sweep",
                    choices=["chol", "sweep"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.meta_fit:
        from scamlgp_tpu_torch.many_tasks import build_meta

        data = build_meta(args.tasks, args.points, device)
        runs = {}
        for T in (args.tasks, args.chunk):
            rec = Recorder(args.limit)
            with rec:
                res = meta_fit(data, T, args)
            runs[T] = (rec.calls, res)
        (calls_f, res_f), (calls_p, res_p) = (runs[args.tasks],
                                              runs[args.chunk])
        leaves = list(zip(tc.fit_lib.tree_leaves(res_f),
                          tc.fit_lib.tree_leaves(res_p)))
        out = {"device": str(device), "meta_fit": True,
               "tasks": args.tasks, "chunk": args.chunk,
               "points": args.points, "steps": args.steps,
               "restarts": args.restarts, "mll_method": args.mll_method,
               "recorded": [len(calls_f), len(calls_p)],
               "results_equal": all(same(rows(a, b), b) for a, b in leaves),
               **compare(calls_f, calls_p)}
        print(json.dumps(out), flush=True)
        return out
    fn, tp, md, _ = campaign_inputs_from_benchmark(
        Quadratic, [args.points] * args.tasks, range(args.studies),
        noise_std=0.05, dtype=torch.float32, device=device)
    cfg = tc.CampaignConfig(n_evaluations=args.evals, noise_std=0.05,
                            mll_method="sweep")
    runs = {}
    for S in (args.studies, args.chunk):
        rec = Recorder(args.limit)
        with rec:
            res = iteration(fn, tp, md, S, cfg, device)
        runs[S] = (rec.calls, res)
    (calls_f, res_f), (calls_p, res_p) = runs[args.studies], runs[args.chunk]
    out = {"device": str(device), "tasks": args.tasks,
           "points": args.points, "studies": args.studies,
           "chunk": args.chunk, "recorded": [len(calls_f), len(calls_p)],
           "results_equal": all(same(rows(a, b), b) for a, b in zip(
               res_f[:4], res_p[:4])),
           "max_abs_diff_x": (res_f[0][:args.chunk] - res_p[0]).abs().max()
           .item(),
           **compare(calls_f, calls_p)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
