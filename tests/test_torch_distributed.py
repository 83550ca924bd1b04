"""Multi-process campaigns of the port (``parallel/distributed.py``,
``python -m scamlgp_tpu_torch.distributed_worker``) on a gloo group of CPU
ranks.

Two ranks, each one ``cpu`` slot of a (2, 1) mesh, draw their own
campaign inputs (the target tasks are unseeded, so the draws differ),
pin process 0's with ``broadcast_from_host0``, run ``run_campaign`` over
the global mesh and write their rows.  The merged rows must cover every
study once and match a one-process run on a (2, 1) mesh of ``cpu`` slots
on the same inputs, within ``tests/test_distributed.py``'s tolerances.
Each rank runs one torch thread.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed

from scamlgp_tpu_torch import distributed_worker as worker
from scamlgp_tpu_torch.benchmarking.torch_adapters import TORCH_FUNCTIONS
from scamlgp_tpu_torch.parallel import distributed as dist
from scamlgp_tpu_torch.parallel.campaign import run_campaign
from scamlgp_tpu_torch.parallel.mesh import make_mesh
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a small campaign: Branin, 4 studies x 2 evaluations, 2 meta-tasks x 6
#: points, short fits
ARGS = ["--benchmark", "Branin", "--studies", "4", "--evals", "2",
        "--tasks", "2", "--points", "6", "--fit-steps", "10",
        "--meta-fit-steps", "10", "--meta-fit-restarts", "1"]
RANK_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(outs):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "scamlgp_tpu_torch.distributed_worker",
         "--process-id", str(rank), "--num-processes", str(len(outs)),
         "--coordinator", f"127.0.0.1:{port}", "--device", "cpu",
         "--out", out] + ARGS, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank, out in enumerate(outs)]


def _wait(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    return [json.loads([l for l in log.splitlines()
                        if l.startswith("{")][-1]) for log in logs]


def test_two_rank_campaign_matches_one_process_mesh(tmp_path):
    outs = [str(tmp_path / f"p{r}.npz") for r in (0, 1)]
    lines = _wait(_launch(outs))
    for line in lines:
        assert line["global_slots"] == 2 and line["local_studies"] == 2
        assert line["mesh"] == {"study": 2, "task": 1}
    z = [np.load(p) for p in outs]
    # broadcast_from_host0 pinned rank 0's draw of the unseeded targets
    for key in z[0].files:
        if key.startswith(("tp__", "md__", "optima")):
            np.testing.assert_array_equal(z[1][key], z[0][key])
    idx = np.concatenate([f["idx"] for f in z])
    assert sorted(idx.tolist()) == [0, 1, 2, 3]
    order = np.argsort(idx)
    merged = {k: np.concatenate([f[k] for f in z])[order]
              for k in ("X", "y", "y_clean")}

    args = worker.build_parser().parse_args(
        ["--process-id", "0", "--num-processes", "1", "--out", "-"] + ARGS)
    tps, md, _ = worker.load_campaign_inputs(outs[0], "cpu")
    one = run_campaign(TORCH_FUNCTIONS["Branin"], tps, md,
                       mesh=make_mesh(study=2, devices=["cpu"] * 2),
                       device="cpu", **worker.campaign_kwargs(args))
    np.testing.assert_allclose(merged["X"], one.X.numpy(), rtol=0, atol=5e-5)
    for k in ("y", "y_clean"):
        np.testing.assert_allclose(merged[k], getattr(one, k).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_worker_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--process-id", "0", "--num-processes", "1",
                     "--out", str(tmp_path / "x.npz")] + ARGS)


@pytest.fixture
def one_rank_group():
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_global_mesh_layout_one_rank(one_rank_group):
    """Rows process-major, the task axis inside the rank; a task extent
    that does not divide the local slots is refused."""
    mesh = dist.global_mesh(task=2, devices=["cpu"] * 4)
    assert mesh.axis_names == ("study", "task")
    assert mesh.shape == {"study": 2, "task": 2}
    assert mesh.ranks.tolist() == [0, 0] and mesh.rank == 0
    assert mesh.group is not None
    with pytest.raises(ValueError):
        dist.global_mesh(task=3, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.global_mesh()
    x = {"a": torch.arange(4.0), "b": (torch.ones(2, 2),)}
    assert dist.broadcast_from_host0(x) is x
    gathered = dist.allgather(x)
    np.testing.assert_array_equal(gathered["a"], np.arange(4.0))


@pytest.mark.parametrize("n", [8, 6])
def test_local_study_rows_round_trip(n):
    """One process holds every study of a (4, 1) mesh, in order; with six
    studies the padded rows are left out."""
    mesh = make_mesh(study=4, devices=["cpu"] * 4)
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    idx, rows = dist.local_study_rows(x, mesh)
    np.testing.assert_array_equal(idx, np.arange(n))
    np.testing.assert_array_equal(rows, x.numpy())


def test_bench_multihost_on_the_cpu(capsys):
    """``bench_multihost`` at a CPU size (one study a rank, 2 ranks, 2
    runs a process): its legs' processes and studies, each leg's time the
    slowest process's runs after the first, and efficiencies that follow
    from its times."""
    from scamlgp_tpu_torch import bench_multihost

    out = bench_multihost.main([
        "--studies", "1", "--tasks", "2", "--points", "6", "--evals", "1",
        "--ranks", "2", "--meta-fit-steps", "2", "--fit-steps", "2",
        "--repeats", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    legs = out["legs"]
    assert list(legs) == ["base", "ranks_2", "control_2", "mesh_2"]
    assert [len(legs[k]["processes"]) for k in legs] == [1, 2, 2, 1]
    assert [p["local_studies"] for p in legs["ranks_2"]["processes"]] == [
        1, 1]
    assert legs["mesh_2"]["processes"][0]["mesh"] == {"study": 2, "task": 1}
    # the JAX script's timing: a process's runs after the first, the
    # slowest process
    for leg in legs.values():
        runs = [p["run_times_s"] for p in leg["processes"]]
        assert all(len(r) == 2 for r in runs)
        assert leg["t_s"] == max(r[1] for r in runs)
        assert leg["cold_t_s"] == max(r[0] for r in runs)
    (row,) = out["scaling"]
    assert row["efficiency_raw"] == out["t_base_s"] / row["t_ranks_s"]
    assert row["meets_target_raw"] == (row["efficiency_raw"] >= 0.7)
