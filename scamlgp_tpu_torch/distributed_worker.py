"""One process of a multi-process ScaML-GP campaign
(``scripts/distributed_worker.py``).

    python -m scamlgp_tpu_torch.distributed_worker --process-id 0 \
        --num-processes 2 --coordinator 127.0.0.1:PORT \
        --slots-per-process 1 --studies 8 --evals 4 --out p0.npz

Launched once per process.  Every process joins the gloo group
(``parallel.distributed.initialize``), builds the campaign inputs (or loads
them with ``--inputs``), pins process 0's draw of the unseeded target
tasks on every process, runs ``run_campaign`` over the global (study, 1)
mesh, whose rows of its own slots it runs, and writes its study rows and
phase times, beside the inputs it ran, to ``--out`` (an ``.npz``), then
prints one JSON line.  ``--coordinator`` (or ``SCAMLGP_COORDINATOR``) is
required: give every launch of one group the same free port.

``--slots-per-process`` is the number of this process's slots:
``--device cpu`` or ``cuda:0`` repeated, or, for ``cuda`` with several
cards, distinct cards (``parallel.mesh.local_slots``).  A process's slots
run one after another, or at once with ``--slots-at-once``
(``parallel.mesh.run_slots``), on one device too.  ``--repeats N`` runs
the campaign N times on the same inputs (the reference's warm repeats):
the line's ``run_times_s`` holds every run's seconds, the rest is the last
run's.  ``--device`` defaults to ``cuda``; without a CUDA device the
worker fails unless ``--device cpu`` is given.  A CPU process runs one
torch thread.  ``--loop device`` runs each of the process's rows
as ``run_campaign(loop="device")`` does (on a card: a CUDA graph a row,
replayed every iteration after the first); the default is ``host``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed

from scamlgp_tpu_torch.benchmarking import benchmarks
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    TORCH_FUNCTIONS,
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models.scamlgp import TaskData
from scamlgp_tpu_torch.parallel import distributed as dist
from scamlgp_tpu_torch.parallel.campaign import CampaignConfig, run_campaign
from scamlgp_tpu_torch.parallel.mesh import local_slots
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER


def input_arrays(tps, md, optima) -> dict:
    """(task_params dict, meta TaskData, optima) as named numpy arrays."""
    arrays = {f"tp__{k}": v.cpu().numpy() for k, v in tps.items()}
    for field in md._fields:
        arrays[f"md__{field}"] = getattr(md, field).cpu().numpy()
    arrays["optima"] = optima.cpu().numpy()
    return arrays


def save_campaign_inputs(path, tps, md, optima) -> None:
    """Persist (task_params dict, meta TaskData, optima) as one npz."""
    np.savez(path, **input_arrays(tps, md, optima))


def load_campaign_inputs(path, device):
    """``save_campaign_inputs``' (task_params, meta TaskData, optima) on
    ``device``, in their saved dtypes; a worker's ``--out`` holds them
    too."""
    z = np.load(path)

    def t(a):
        return torch.as_tensor(a, device=device)

    tps = {k[len("tp__"):]: t(z[k]) for k in z.files if k.startswith("tp__")}
    md = TaskData(**{f: t(z[f"md__{f}"]) for f in TaskData._fields})
    return tps, md, t(z["optima"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", default=None,
                    help="host:port where process 0 listens (default: "
                         "SCAMLGP_COORDINATOR)")
    ap.add_argument("--slots-per-process", type=int, default=1)
    ap.add_argument("--slots-at-once", action="store_true",
                    help="run this process's slots at once, a host thread "
                         "each")
    ap.add_argument("--repeats", type=int, default=1,
                    help="run the campaign this many times; every run's "
                         "seconds are recorded (the first includes the "
                         "kernels' first use)")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("--benchmark", default="Branin",
                    choices=sorted(TORCH_FUNCTIONS))
    ap.add_argument("--studies", type=int, default=8)
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--evals", type=int, default=4)
    ap.add_argument("--fit-steps", type=int, default=20)
    ap.add_argument("--meta-fit-steps", type=int, default=20)
    ap.add_argument("--meta-fit-restarts", type=int, default=3)
    ap.add_argument("--mll-method", default="chol",
                    choices=["chol", "sweep", "chol64"])
    ap.add_argument("--inputs", default=None,
                    help="npz of campaign inputs (save_campaign_inputs): "
                         "pins the same unseeded target-task draws across "
                         "separate launches")
    ap.add_argument("--loop", default="host", choices=["host", "device"],
                    help="run_campaign's loop: the host's, or one with no "
                         "host sync (a CUDA graph replayed per iteration)")
    ap.add_argument("--out", required=True)
    return ap


def campaign_config(args) -> CampaignConfig:
    return CampaignConfig(n_evaluations=args.evals, noise_std=args.sigma,
                          fit_steps=args.fit_steps,
                          mll_method=args.mll_method)


def campaign_kwargs(args) -> dict:
    """``run_campaign``'s arguments besides the inputs and the mesh."""
    return dict(seed=0, cfg=campaign_config(args),
                meta_fit_restarts=args.meta_fit_restarts,
                meta_fit_steps=args.meta_fit_steps, loop=args.loop)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.initialize(coordinator_address=args.coordinator,
                    num_processes=args.num_processes,
                    process_id=args.process_id)
    try:
        slots = local_slots(device, args.slots_per_process, args.process_id)
        mesh = dist.global_mesh(task=1, devices=slots,
                                at_once=args.slots_at_once)
        t0 = time.perf_counter()
        if args.inputs:
            tps, md, optima = load_campaign_inputs(args.inputs, slots[0])
        else:
            _, tps, md, optima = campaign_inputs_from_benchmark(
                getattr(benchmarks, args.benchmark),
                [args.points] * args.tasks, range(args.studies),
                noise_std=args.sigma, dtype=torch.float32, device=slots[0],
                optimum_method="device")
            # pin every process to process 0's (unseeded) target-task draw
            tps, md, optima = dist.broadcast_from_host0((tps, md, optima))
        setup_s = time.perf_counter() - t0
        fn = TORCH_FUNCTIONS[args.benchmark]
        if slots[0].type == "cuda":
            torch.cuda.reset_peak_memory_stats(slots[0])
        run_times = []
        for _ in range(max(args.repeats, 1)):
            GLOBAL_TIMER.reset()
            t0 = time.perf_counter()
            res = run_campaign(fn, tps, md, mesh=mesh,
                               **campaign_kwargs(args))
            run_times.append(time.perf_counter() - t0)
        run_s = run_times[-1]
        idx, X = dist.local_study_rows(res.X, mesh)
        _, y = dist.local_study_rows(res.y, mesh)
        _, y_clean = dist.local_study_rows(res.y_clean, mesh)
        peak = (torch.cuda.max_memory_allocated(slots[0])
                if slots[0].type == "cuda" else None)
        np.savez(args.out, idx=idx, X=X, y=y, y_clean=y_clean,
                 run_s=run_s, setup_s=setup_s,
                 **input_arrays(tps, md, optima))
        line = {"process": args.process_id, "device": str(slots[0]),
                "local_slots": len(slots),
                "global_slots": int(mesh.devices.size),
                "mesh": mesh.shape, "local_studies": int(idx.size),
                "loop": args.loop, "graph": res.graph,
                "setup_s": setup_s, "run_s": run_s,
                "run_times_s": run_times,
                "meta_fit_s": res.meta_fit_seconds,
                "iteration_s": res.iteration_seconds,
                "launches": {k: sum(v) for k, v in res.launches.items()},
                "launches_meta_fit": {k: v[0]
                                      for k, v in res.launches.items()},
                "launches_per_iteration": {k: v[1:] for k, v in
                                           res.launches.items()},
                "peak_memory_bytes": peak, "phases": GLOBAL_TIMER.report()}
        print(json.dumps(line), flush=True)
        return line
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
