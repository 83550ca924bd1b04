#!/usr/bin/env python3
"""Chip smoke test of the port ``scamlgp_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own seconds:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: nvcc builds the kernel of ``scamlgp_tpu_torch/csrc`` into
   ``build/torch_kernels``;
3. kernel: the kernel's wrapper against its plain PyTorch version on the
   card, on the fixture's shapes and on the campaign's, then timed at the
   campaign's shapes beside the plain version, one PyTorch library call
   computing the same function, and the roofline bound;
4. slice: the Branin T8 MAP campaign (8 meta-tasks x 32 points, d=2,
   noise 1.0, CampaignConfig defaults with mll_method="sweep", float32)
   through ``run_campaign``, with the launch counts of every kernel taken
   over that run alone;
5. the card's nvidia-smi line, the kernels line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the result lines.  With no CUDA
device it exits 2 at once.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from scamlgp_tpu_torch.benchmarking.benchmarks import Branin
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import cuda_build, inverse_mll, linalg, sweep
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
)

# Slice size: S studies x E evaluations of Branin T8 (the model's width,
# M=8 tasks x N=32 points and the CampaignConfig defaults, is not cut).
STUDIES, EVALS, TASKS, POINTS = 32, 10, 8, 32
META_RESTARTS, META_STEPS = 3, 50

# H100 SXM data-sheet peaks: HBM bandwidth; float32 and float64 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
# kernel vs plain: inverse to this share of max|A^-1|, logdet relative
TOL_INV = {torch.float32: 1e-4, torch.float64: 1e-11}
TOL_LOGDET = {torch.float32: 1e-5, torch.float64: 1e-12}


def emit(phase, seconds, **kw):
    print(json.dumps({"phase": phase, "seconds": seconds, **kw}), flush=True)


def check(ok, msg):
    if not ok:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def spd_batch(rng, b, n, jitter=0.5):
    """The fixture of tests/test_sweep.py::_spd_batch."""
    X = rng.normal(size=(b, n, n)).astype(np.float32)
    return np.einsum("bij,bkj->bik", X, X) / n + jitter * np.eye(
        n, dtype=np.float32)


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_inverse(A):
    """Yardstick only, never called by the port: library Cholesky inverse
    and the log-determinant from the factor's diagonal."""
    L = torch.linalg.cholesky(A)
    return (torch.cholesky_inverse(L),
            2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))


def bound(B, N, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = (2 * B * N * N + B) * itemsize / HBM_BYTES_PER_S
    t_ops = B * N ** 3 / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs the "
              "port on an NVIDIA GPU", file=sys.stderr, flush=True)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", time.perf_counter() - t0,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build():
    t0 = time.perf_counter()
    cold = not cuda_build.library_path("sweep_inverse").exists()
    cuda_build.load("sweep_inverse")
    emit("build", time.perf_counter() - t0, source="sweep_inverse",
         built_cold=cold)


def check_sweep(A, n, what):
    """The kernel against the plain sweep on the same A, within the stated
    tolerances; returns the inverse's largest absolute error."""
    dtype = A.dtype
    inv_k, ld_k = sweep.sweep_inverse(A)
    torch.cuda.synchronize()
    inv_p, ld_p = sweep.sweep_inverse_reference(A)
    err = (inv_k - inv_p).abs().max().item()
    scale = inv_p.abs().max().item()
    ld_err = ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item()
    emit("kernel_check", None, kernel="sweep_inverse", shapes=what, n=n,
         batch=A.shape[0], dtype=str(dtype), max_abs_err=err,
         max_abs_inv=scale, logdet_rel_err=ld_err)
    check(err <= TOL_INV[dtype] * scale,
          f"sweep inverse {what} n={n} {dtype}: {err} > "
          f"{TOL_INV[dtype]} * {scale}")
    check(ld_err <= TOL_LOGDET[dtype],
          f"sweep logdet {what} n={n} {dtype}: {ld_err}")
    return err


def phase_kernel():
    """Sweep kernel against the plain sweep; then times at the campaign's
    shapes.  Returns the kernels-line fields measured here."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in (8, 32, 40, 128):
            A = torch.as_tensor(spd_batch(rng, 256, n), dtype=dtype,
                                device="cuda")
            err = check_sweep(A, n, "fixture")
            if dtype == torch.float32:
                max_err = max(max_err, err)

    cfg = CampaignConfig()
    shapes = {"meta_fit": (STUDIES * TASKS * (META_RESTARTS + 1), POINTS),
              "target_fit": (STUDIES * (cfg.fit_restarts + 1), EVALS)}
    timed = {}
    for what, (B, N) in shapes.items():
        A = torch.as_tensor(spd_batch(rng, B, N), dtype=torch.float32,
                            device="cuda")
        max_err = max(max_err, check_sweep(A, N, what))
        ms = time_ms(lambda: sweep.sweep_inverse(A), 200)
        plain_ms = time_ms(lambda: sweep.sweep_inverse_reference(A), 10)
        lib_ms = time_ms(lambda: library_inverse(A), 50)
        bound_ms, bound_by = bound(B, N, torch.float32)
        timed[what] = dict(batch=B, n=N, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
    emit("kernel", time.perf_counter() - t0, kernel="sweep_inverse",
         dtype="float32", shapes=timed)
    return max_err, timed


def mll_plain(A, y, n_active):
    """``inverse_mll.mll_via_inverse`` with the plain sweep in place of the
    kernel."""
    Ainv, logdet = sweep.sweep_inverse_reference(A)
    quad = torch.sum(y * torch.sum(Ainv * y[:, None, :], -1), -1)
    return -0.5 * (quad + logdet + n_active * np.log(2 * np.pi))


def phase_slice():
    t0 = time.perf_counter()
    fn, tp, md, optima = campaign_inputs_from_benchmark(
        Branin, [POINTS] * TASKS, range(STUDIES), noise_std=1.0,
        dtype=torch.float32, device="cuda")
    setup_s = time.perf_counter() - t0
    cfg = CampaignConfig(n_evaluations=EVALS, noise_std=1.0,
                         mll_method="sweep")

    sweep.sweep_inverse.launches = 0
    res = run_campaign(fn, tp, md, seed=0, cfg=cfg,
                       meta_fit_restarts=META_RESTARTS,
                       meta_fit_steps=META_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = sweep.sweep_inverse.launches

    check(launches > 0, "the campaign launched the sweep kernel no time")
    X = res.X
    check(X.shape == (STUDIES, EVALS, 2), f"proposal shape {tuple(X.shape)}")
    check(bool(torch.isfinite(X).all()), "non-finite proposal")
    check(bool(((X >= 0) & (X <= 1)).all()), "proposal outside [0,1]^2")
    regret = simple_regret(res.y_clean, optima)
    check(bool(torch.isfinite(regret).all()), "non-finite regret")

    # one batch of the campaign's own systems: the meta-fit's first
    # objective evaluation (every task at the warm start), kernel vs plain
    S, M, N, d = md.X.shape
    flat_X, flat_y, flat_m = (t.reshape((S * M,) + t.shape[2:])
                              for t in (md.X, md.y, md.mask))
    scfg = gp.source_gp_config()
    c = gp.constrain(scfg, gp.init_params(scfg, d, torch.float32, "cuda",
                                          batch_shape=(S * M,)))
    A = linalg.mask_system(gp.gram(scfg, c, flat_X), c.noise, flat_m)
    y = flat_y * flat_m
    na = flat_m.sum(-1)
    plain = mll_plain(A, y, na)
    diff = (inverse_mll.mll_via_inverse(A, y, na) - plain).abs()

    per_iter = res.iteration_seconds
    emit("slice", time.perf_counter() - t0, setup_s=setup_s,
         meta_fit_s=res.meta_fit_seconds, iteration_s=per_iter,
         mean_iteration_s=float(np.mean(per_iter)),
         median_final_regret=float(regret[:, -1].median()),
         median_regret=[float(v) for v in regret.median(dim=0).values],
         sweep_launches=launches,
         sweep_launches_meta_fit=res.sweep_launches[0],
         sweep_launches_per_iteration=res.sweep_launches[1:],
         studies=STUDIES, evaluations=EVALS,
         mll_kernel_vs_plain_max_abs=diff.max().item(),
         mll_kernel_vs_plain_max_rel=(diff / plain.abs().clamp_min(1.0))
         .max().item())
    return launches


def main():
    card = phase_device()
    phase_build()
    max_err, timed = phase_kernel()
    launches = phase_slice()
    head = timed["meta_fit"]
    kernels = [{
        "name": "sweep_inverse",
        "route": "cuda",
        "source": "scamlgp_tpu_torch/csrc/sweep_inverse.cu",
        "replaces": "scamlgp_tpu/ops/pallas_sweep.py:96",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
