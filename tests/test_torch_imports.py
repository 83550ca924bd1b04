"""The port needs only torch, numpy and scipy, and nothing of JAX.

Every module of ``scamlgp_tpu_torch`` and ``chip_smoke`` (as a module, its
``main`` not run) is imported in a fresh interpreter in which a
``sys.meta_path`` finder refuses JAX, optax, the JAX package, pandas,
matplotlib, h5py and triton: a GPU host set up for the port need not have
them.  Where they are installed those imports would succeed, so only the
finder can show that the port does not need them.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "optax", "scamlgp_tpu", "pandas", "matplotlib",
           "h5py", "triton")

SCRIPT = textwrap.dedent(f"""
    import importlib, pkgutil, sys

    BLOCKED = {BLOCKED!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"refused: {{name}}", name=name)
            return None

    sys.meta_path.insert(0, Refuse())
    import scamlgp_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        scamlgp_tpu_torch.__path__, "scamlgp_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("imported", len(names) + 2)
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[-1])
    assert n >= 30


def test_the_walk_reaches_the_bench_and_the_profiling_hooks():
    """The import guard above walks the package; the kernel N-scaling bench,
    the profiling hooks, the Gram kernel's module, the sequential driver,
    the study unit, the checkpoints, the ablation driver, the Quadratic
    benchmark, the HMC, NUTS and ADVI samplers, and the experiment layer
    (its configuration modules, CLI, plotting, tabular benchmarks and
    device adapters), the mesh, the ports of ``run_many_tasks.py`` and
    ``bench_multihost.py``, and the loop-shape probes and the large-N
    checks (the ports of ``bench_chol_fused_probe.py``,
    ``bench_vpu_ceiling.py``, ``validate_large_n.py`` and
    ``validate_large_n_fit.py``) are among the modules that it imports."""
    import pkgutil

    import scamlgp_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        scamlgp_tpu_torch.__path__, "scamlgp_tpu_torch.")}
    assert {"scamlgp_tpu_torch.bench_sweep_n",
            "scamlgp_tpu_torch.utils.profiling",
            "scamlgp_tpu_torch.ops.sweep",
            "scamlgp_tpu_torch.validate",
            "scamlgp_tpu_torch.ops.gram",
            "scamlgp_tpu_torch.bo.optimizer",
            "scamlgp_tpu_torch.testing",
            "scamlgp_tpu_torch.benchmarking.noise.base",
            "scamlgp_tpu_torch.benchmarking.noise.benchmark",
            "scamlgp_tpu_torch.benchmarking.noise.homoscedastic",
            "scamlgp_tpu_torch.benchmarking.bbo_helper",
            "scamlgp_tpu_torch.benchmarking.local_runner",
            "scamlgp_tpu_torch.utils.checkpoint",
            "scamlgp_tpu_torch.ablation",
            "scamlgp_tpu_torch.batch_probe",
            "scamlgp_tpu_torch.benchmarking.functions.quadratic",
            "scamlgp_tpu_torch.benchmarking.benchmarks.quadratic",
            "scamlgp_tpu_torch.models.hmc",
            "scamlgp_tpu_torch.models.vi",
            "scamlgp_tpu_torch.benchmarking.experiment_config_utils",
            "scamlgp_tpu_torch.benchmarking.utils",
            "scamlgp_tpu_torch.benchmarking.plotting",
            "scamlgp_tpu_torch.benchmarking.tabular_adapters",
            "scamlgp_tpu_torch.benchmarking.benchmarks.hpo_bench_tabular",
            "scamlgp_tpu_torch.benchmarking.benchmarks."
            "fcnet_fixed_fidelity_tabular",
            "scamlgp_tpu_torch.benchmarking.benchmarks.pd1",
            "scamlgp_tpu_torch.benchmarking.configurations._shared",
            "scamlgp_tpu_torch.benchmarking.configurations.styles",
            "scamlgp_tpu_torch.parallel.mesh",
            "scamlgp_tpu_torch.parallel.scamlgp_sharded",
            "scamlgp_tpu_torch.parallel.distributed",
            "scamlgp_tpu_torch.distributed_worker",
            "scamlgp_tpu_torch.many_tasks",
            "scamlgp_tpu_torch.bench_multihost",
            "scamlgp_tpu_torch.ops.probes",
            "scamlgp_tpu_torch.bench_chol_fused_probe",
            "scamlgp_tpu_torch.bench_traversal_floor",
            "scamlgp_tpu_torch.validate_large_n",
            "scamlgp_tpu_torch.validate_large_n_fit"} <= names
    configurations = {n.rsplit(".", 1)[1] for n in names if n.startswith(
        "scamlgp_tpu_torch.benchmarking.configurations.")}
    assert len(configurations - {"_shared", "styles"}) == 17


def test_chip_smoke_fails_without_cuda():
    """Where torch sees no CUDA device the script exits non-zero with the
    device message and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    the script fails and prints no result line."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
