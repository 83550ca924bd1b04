"""Weak scaling over the study axis: one rank against n ranks, each rank a
process with a card of its own (``scripts/bench_multihost.py``).

    python -m scamlgp_tpu_torch.bench_multihost [--studies 16] [--tasks 8]
        [--points 32] [--evals 10] [--ranks 2 4] [--loop host|device]
        [--mll-method sweep] [--meta-fit-steps 50] [--repeats 4]
        [--slots-at-once] [--no-pin] [--device cuda] [--timeout 1800]
        [--out bench_multihost.json]

BASELINE.md's target is a scaling efficiency of at least 70%.  Studies
never communicate, so n ranks over gloo (``parallel/distributed.py``,
host tensors only) each run S studies of an n*S-study campaign.  Every
rank is one ``python -m scamlgp_tpu_torch.distributed_worker`` process;
the legs, S = ``--studies``:

- ``base``: one rank on the first card, S studies;
- ``ranks_n``: n ranks, rank r on card r (modulo the cards), n*S studies;
- ``control_n``: n unrelated one-rank campaigns at once, each the base's S
  studies on card i: what the ranks would take with no group between them
  (host cores, memory and PCIe shared as in ``ranks_n``);
- ``mesh_n``: one process whose (n, 1) study mesh lays its rows over
  cards 0 .. n-1, n*S studies, the rows in turn, or at once with
  ``--slots-at-once`` (``mesh.run_slots``).

Each process runs its campaign ``--repeats`` times on the same inputs
(the worker's ``--repeats``; each run's ``run_campaign`` seconds, meta-fit
and BO loop, after the inputs are loaded).  As in the JAX script, a
process's time is the median of its runs after the first (the first
builds and configures the kernels), and a leg's time is its slowest
process's; ``cold_t_s`` is the slowest first run.  Where ``taskset``
exists and ``--no-pin`` is not given, each process is pinned to cores of
its own, one a slot (the JAX script pins each process to a core).
The efficiencies against the 70% target: ``raw`` = t_base / t_ranks (each
rank does the base's work, so perfect scaling is equal time),
``vs_control`` = t_control / t_ranks (the contention of n processes on one
host divided out) and ``mesh`` = t_base / t_mesh.  The n*S studies'
inputs are drawn once on the first device, seeds 0 .. n*S - 1, and each
leg reads its first S or n*S of them from a file (``--inputs``), so base
and control run the same studies.  The kernels are built before any leg.
With ``--device cpu`` every process runs on the CPU (one torch thread
each).  Prints one JSON line; each leg's line goes to the standard error
as it ends.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from scamlgp_tpu_torch import distributed_worker as worker
from scamlgp_tpu_torch.benchmarking import benchmarks
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models.scamlgp import TaskData
from scamlgp_tpu_torch.ops import cuda_build
from scamlgp_tpu_torch.validate import _card

TARGET = 0.70
ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_inputs(args, device, counts, workdir: Path) -> dict:
    """The campaign inputs of max(counts) studies, drawn once; for each
    count k, a file of its first k studies.  Returns {k: path}."""
    n = max(counts)
    _, tps, md, optima = campaign_inputs_from_benchmark(
        getattr(benchmarks, args.benchmark), [args.points] * args.tasks,
        range(n), noise_std=args.sigma, dtype=torch.float32, device=device,
        optimum_method="device")
    paths = {}
    for k in sorted(set(counts)):
        paths[k] = workdir / f"inputs_{k}.npz"
        worker.save_campaign_inputs(
            paths[k], {key: v[:k] for key, v in tps.items()},
            TaskData(*[leaf[:k] for leaf in md]), optima[:k])
    return paths


def worker_args(args) -> list:
    return ["--benchmark", args.benchmark, "--tasks", str(args.tasks),
            "--points", str(args.points), "--sigma", str(args.sigma),
            "--evals", str(args.evals), "--fit-steps", str(args.fit_steps),
            "--meta-fit-steps", str(args.meta_fit_steps),
            "--meta-fit-restarts", str(args.meta_fit_restarts),
            "--mll-method", args.mll_method, "--loop", args.loop,
            "--repeats", str(args.repeats)] + (
                ["--slots-at-once"] if args.slots_at_once else [])


def run_leg(name: str, groups: list, args, workdir: Path) -> dict:
    """Start every process of ``groups`` at once, each group a gloo group
    on a free port: a group is (its inputs file, its ranks' (device,
    slots)).  Waits at most ``--timeout`` s, every process stopped on a
    failure.  Returns the leg's time and its processes' lines."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    pin = not args.no_pin and shutil.which("taskset") is not None
    procs, core = [], 0
    for g, (inputs, ranks) in enumerate(groups):
        port = _free_port()
        for r, (device, slots) in enumerate(ranks):
            out = workdir / f"{name}_g{g}_r{r}.npz"
            cmd = [sys.executable, "-m",
                   "scamlgp_tpu_torch.distributed_worker",
                   "--process-id", str(r), "--num-processes", str(len(ranks)),
                   "--coordinator", f"127.0.0.1:{port}", "--device", device,
                   "--slots-per-process", str(slots), "--inputs", str(inputs),
                   "--out", str(out)] + worker_args(args)
            if pin:
                cmd = ["taskset", "-c", f"{core}-{core + slots - 1}"] + cmd
            core += slots
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs, deadline = [], time.monotonic() + args.timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"{name}: a worker exited {p.returncode}:\n"
                               f"{log[-3000:]}")
        line = json.loads([ln for ln in log.splitlines()
                           if ln.startswith("{")][-1])
        lines.append({k: line[k] for k in (
            "process", "device", "local_slots", "global_slots", "mesh",
            "local_studies", "setup_s", "run_times_s", "meta_fit_s",
            "iteration_s", "launches", "peak_memory_bytes")})
    warm = [statistics.median(ln["run_times_s"][1:] or ln["run_times_s"])
            for ln in lines]
    leg = {"t_s": max(warm), "cold_t_s": max(ln["run_times_s"][0]
                                             for ln in lines),
           "warm_s": warm, "pinned": pin, "processes": lines}
    print(json.dumps({"leg": name, **leg}), file=sys.stderr, flush=True)
    return leg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--benchmark", default="Branin")
    ap.add_argument("--studies", type=int, default=16,
                    help="studies a rank (weak scaling)")
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--evals", type=int, default=10)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--loop", default="host", choices=["host", "device"])
    ap.add_argument("--mll-method", default="sweep",
                    choices=["chol", "sweep"])
    ap.add_argument("--fit-steps", type=int, default=60)
    ap.add_argument("--meta-fit-steps", type=int, default=50)
    ap.add_argument("--meta-fit-restarts", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=4,
                    help="campaign runs a process; the median of those "
                         "after the first is its time")
    ap.add_argument("--slots-at-once", action="store_true",
                    help="run the mesh leg's rows at once, a host thread "
                         "each")
    ap.add_argument("--no-pin", action="store_true",
                    help="do not pin the processes to cores")
    ap.add_argument("--device", default=None,
                    help="cuda (default: a card a rank) or cpu")
    ap.add_argument("--timeout", type=float, default=1800,
                    help="seconds a leg may take")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards:
        cuda_build.build_all()

    def card(i):
        return f"cuda:{i % cards}" if cards else "cpu"

    S = args.studies
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="bench_multihost_",
                                     dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        inputs = write_inputs(args, device, [S] + [n * S for n in args.ranks],
                              workdir)
        legs = {"base": run_leg("base", [(inputs[S], [(card(0), 1)])],
                                args, workdir)}
        for n in args.ranks:
            legs[f"ranks_{n}"] = run_leg(
                f"ranks_{n}", [(inputs[n * S], [(card(r), 1)
                                                for r in range(n)])],
                args, workdir)
            legs[f"control_{n}"] = run_leg(
                f"control_{n}", [(inputs[S], [(card(i), 1)])
                                 for i in range(n)], args, workdir)
            legs[f"mesh_{n}"] = run_leg(
                f"mesh_{n}", [(inputs[n * S], [(device.type, n)])], args,
                workdir)
    t1 = legs["base"]["t_s"]
    scaling = []
    for n in args.ranks:
        tr, tc, tm = (legs[f"{k}_{n}"]["t_s"]
                      for k in ("ranks", "control", "mesh"))
        scaling.append({
            "n": n, "studies": n * S, "t_ranks_s": tr, "t_control_s": tc,
            "t_mesh_s": tm, "samples_per_s_ranks": n * S * args.evals / tr,
            "samples_per_s_mesh": n * S * args.evals / tm,
            "contention_factor": t1 / tc,
            "efficiency_raw": t1 / tr, "efficiency_vs_control": tc / tr,
            "efficiency_mesh": t1 / tm,
            "meets_target_raw": t1 / tr >= TARGET,
            "meets_target_vs_control": tc / tr >= TARGET,
            "meets_target_mesh": t1 / tm >= TARGET})
    result = {"benchmark": args.benchmark, "loop": args.loop,
              "mll_method": args.mll_method, "studies_per_rank": S,
              "tasks": args.tasks, "points": args.points,
              "evals": args.evals, "meta_fit_steps": args.meta_fit_steps,
              "repeats": args.repeats, "slots_at_once": args.slots_at_once,
              "device": str(device), "cards": cards,
              "card": _card(device), "t_base_s": t1,
              "samples_per_s_base": S * args.evals / t1, "target": TARGET,
              "scaling": scaling, "legs": legs}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)
    return result


if __name__ == "__main__":
    main()
