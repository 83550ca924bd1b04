#!/usr/bin/env python3
"""Chip smoke test of the port ``scamlgp_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own seconds:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: nvcc builds every kernel source of ``scamlgp_tpu_torch/csrc``
   into ``build/torch_kernels``, one nvcc per source, all started together;
3. kernel: each kernel's wrapper against its plain PyTorch version on the
   card, on the fixture's shapes and on the campaign's, in float32 and
   float64, then timed at the campaign's shapes beside the plain version,
   one PyTorch library call computing the same function, and the roofline
   bound.  Kernels: the sweep inverse in its four step schemes (``select``,
   ``fused``, ``pair``, ``blocked``), and the blocked-Cholesky inverse in
   its two variants, ``smem`` and ``global``.  ``fused``, ``pair``,
   ``blocked`` and ``global`` are also timed against their first versions
   (``old_ms``, ``csrc/baseline_kernels.cu``), in turns (old, new, new,
   old), ``pair`` and ``blocked`` at all three of their timed shapes
   ((1024, 32, 32), (1024, 128, 128) and (4096, 128, 128)).  ``pair`` in
   float32 must equal its plain version bit for bit on every float32
   input of the phase (``BITWISE``);
3b. gram: the RBF Gram kernel (``ops/gram.py``) against its plain version
   at ``GRAM_CHECKS`` in float32 and float64 (atol 2e-5; m % 4 != 0,
   shapes under one tile, more tiles than resident CTAs), its gradients
   against autograd of ``kernels.rbf`` at (300, 200, 3) (rtol 1e-4), and
   its times (``profile_kernels.gram_times``) at (2048, 2048, 6) and
   (4096, 4096, 2) in float32 and at (4096, 4096, 2) in float64: the
   kernel alone (``ms_kernel``, outputs rotated beyond the L2) beside its
   first version (``old_ms``, ``csrc/baseline_kernels.cu``) in turns and a
   ``fill_`` of the same outputs, the call through ``rbf_gram`` (``ms``)
   beside the first kernel through an equivalent wrapper
   (``old_call_ms``) in turns, with the host's issue time a call, the plain
   version, ``kernels.rbf`` (the RBF the port's models compute: an eager
   expression of a few calls; no single library call computes this
   function, so ``library_ms`` is null) and the bytes bound.  No path of
   the port launches this kernel, as none of the JAX package does: its
   count in the kernels line is this phase's, every launch of the phase
   (``gram.run`` counts each, the timed ones included);
4. slices, each through ``run_campaign`` in float32 with
   ``mll_method="sweep"`` and the CampaignConfig defaults, with the launch
   counts of every kernel set to 0 just before and read just after:

   - Branin T8 (8 meta-tasks x 32 points, d=2, noise 1.0): the ``select``
     sweep kernel in the meta-fit and the target fits;
   - Branin T8 N_m=256 (noise 1.0, ``route_blocked=True``): the meta-fit's
     (1024, 256, 256) systems through the ``smem`` blocked kernel;
   - Hartmann6D T8 N_m=512 (d=6, noise 0.1, ``route_blocked=True``): the
     meta-fit's (256, 512, 512) systems through the ``global`` blocked
     kernel;
   - Hartmann6D T8 N_m=128 (d=6, noise 0.1, ``sweep_variant="fused"``, the
     reference's ``SCAMLGP_SWEEP_STEP=fused``): the meta-fit's
     (1024, 128, 128) systems and the target fits through the ``fused``
     sweep kernel;

   each cut in studies and evaluations only; a slice fails if a source GP
   is left with a non-finite factor after the meta-fit (a task whose
   factor fails on the inverse route is fitted again on the Cholesky
   route, ``models.scamlgp.refit_nonfinite_tasks``, and its time is the
   ``meta_fit_refit_chol`` stage).  The MLL of the meta-fit's own float32
   systems is held against float64 for each kernel of the slice's route
   and its plain version (every sweep scheme at N <= 128, the blocked
   variant on the ``route_blocked`` slices): a kernel farther from float64
   than twice its plain version fails.  So the ``pair`` and ``blocked``
   kernels, though no slice's route takes them, are held to twice their
   plain versions' distance from float64 on the p32 and hm6 p128 slices'
   own float32 systems (``rounding``).  The p256 slice's ``chol64`` entry
   holds ``gp.mll(method="chol64")`` on the slice's float32 inputs and
   warm-start parameters to ``gp.mll(method="chol")`` on the same inputs
   and parameters cast to float64 (rtol 1e-6: the float32 cast of the
   result alone), and prints how far the kernel route and the float32
   systems promoted to float64 lie from that float64-assembled MLL;
4b. campaign_resume: the many-task configuration (BASELINE.json config 4):
   Quadratic, 128 meta-tasks x 32 points, d=1, noise 0.05, study seeds
   0-3, float32, ``mll_method="sweep"`` (``select``), E=4, three ways:
   (a) uninterrupted; (b) checkpointed with ``stop_after=2``, then resumed
   to E from the checkpoint; (c) ``study_chunk=2``, checkpointed.  (b) must
   equal (a) bit for bit; (c) must too, or, where the card's
   batch-size-dependent library operations move a last bit
   (``CHUNK_TOL``), match (a) in each study's noise draws and first
   proposals.  One line per run with its
   seconds, meta-fit seconds and ``sweep_inverse`` launches;
5. bench_sweep_n: the kernel N-scaling bench (``scamlgp_tpu_torch.
   bench_sweep_n``) at (B, N) = (4096, 128) with every variant, with the
   launch counts set to 0 just before: the ``pair`` and ``blocked`` sweep
   kernels on the MAP objective's value and gradient;
5b. driver: the paper's ``BRANIN_T8_P32_N1_SCAMLGP`` experiment (8 meta-tasks
   x 32 points, d=2, noise 1.0, the driver's defaults) through
   ``run_study`` and the sequential driver ``ScaMLGPBO`` on the card in
   float64, cut to DRIVER_SEEDS studies x DRIVER_EVALS evaluations; one
   line per study with the meta-fit seconds, each evaluation's refit and
   acquisition seconds, the best-so-far regret and the peak device
   memory.  It fails on a proposal that is not finite or leaves the search
   space, on a source factor that is not finite, and where the final
   model's ``predict`` at 64 Sobol points differs by more than rtol 1e-6
   from ``scamlgp_posterior_diag`` on the same model moved to the CPU in
   float64 (``convert.scamlgp_model``).  This path runs on the Cholesky
   route, as the JAX package's does, and launches no kernel of the port;
6. the card's nvidia-smi line, the kernels line (each kernel's entry with
   its times at its other timed shapes under ``other_shapes``), and the
   last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the result lines.  With no CUDA
device it exits 2 at once.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from scamlgp_tpu_torch import bench_sweep_n, convert
from scamlgp_tpu_torch.benchmarking.benchmarks import (
    Branin,
    Hartmann6D,
    Quadratic,
)
from scamlgp_tpu_torch.benchmarking.local_runner import run_study
from scamlgp_tpu_torch.benchmarking.noise import HomoscedasticGaussianNoise
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.optimize import sobol_unit
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as model_lib
from scamlgp_tpu_torch.ops import (
    blocked_chol,
    cuda_build,
    gram,
    inverse_mll,
    kernels,
    linalg,
    sweep,
)
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
)
from scamlgp_tpu_torch.profile_kernels import (
    BASELINES,
    bound,
    gram_times,
    library_inverse,
    time_ms,
)
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER
from scamlgp_tpu_torch.validate import study_regret

# Slices: S studies x E evaluations of each configuration (the model's
# width, M=8 tasks x N_m points, d, the noise and the CampaignConfig
# defaults, is not cut).
SLICES = {
    "branin_t8_p32": dict(benchmark=Branin, studies=32, evals=4, tasks=8,
                          points=32, sigma=1.0, route_blocked=False,
                          sweep_variant="select", optimum="shgo",
                          kernels=("sweep_inverse",)),
    "branin_t8_p256": dict(benchmark=Branin, studies=32, evals=3, tasks=8,
                           points=256, sigma=1.0, route_blocked=True,
                           sweep_variant="select", optimum="shgo",
                           kernels=("blocked_chol_inverse_smem",),
                           chol64=True),
    "hartmann6_t8_p512": dict(benchmark=Hartmann6D, studies=8, evals=2,
                              tasks=8, points=512, sigma=0.1,
                              route_blocked=True, sweep_variant="select",
                              optimum="device",
                              kernels=("blocked_chol_inverse_global",)),
    "hartmann6_t8_p128": dict(benchmark=Hartmann6D, studies=32, evals=2,
                              tasks=8, points=128, sigma=0.1,
                              route_blocked=False, sweep_variant="fused",
                              optimum="device",
                              kernels=("sweep_inverse_fused",)),
}
META_RESTARTS, META_STEPS = 3, 50
#: the bench phase's shape and rounds (every variant of the bench)
BENCH_SHAPE, BENCH_ROUNDS = (4096, 128), 5
#: the gram phase's checked shapes (the JAX package's test shape first;
#: m % 4 != 0 and d = 33, three feature chunks; under one tile; more tiles
#: than resident CTAs) and timed shapes, (n, m, d), float32, then
#: (4096, 4096, 2) in float64; the kernels line carries the first timed
#: shape
GRAM_CHECKS = ((300, 200, 3), (2048, 2048, 6), (4096, 1024, 2),
               (129, 131, 33), (3, 5, 1), (4096, 4096, 2))
GRAM_TIMED = ((2048, 2048, 6), (4096, 4096, 2))
#: the driver phase: BRANIN_T8_P32_N1_SCAMLGP cut to these studies x
#: evaluations (its width, 8 tasks x 32 points and the driver's defaults,
#: is not cut)
DRIVER_SEEDS, DRIVER_EVALS = (0, 1), 6
#: the campaign_resume phase: BASELINE.json config 4 (M=128 x N_m=32,
#: sigma 0.05, study seeds 0-3) cut to RESUME_EVALS evaluations, stopped
#: after RESUME_STOP, chunked by RESUME_CHUNK studies
RESUME_TASKS, RESUME_POINTS, RESUME_SIGMA = 128, 32, 0.05
RESUME_SEEDS, RESUME_EVALS, RESUME_STOP, RESUME_CHUNK = range(4), 4, 2, 2
#: where the phase's checkpoints go (removed at its end)
RESUME_DIR = Path(__file__).resolve().parent / "build" / "smoke_checkpoints"
#: chol64 against the MLL computed wholly in float64: the cast alone
TOL_CHOL64 = 1e-6
#: the chunked run against the uninterrupted one where it is not bit for
#: bit.  On the card two library operations give a study's rows other last
#: bits in a batch of 2 studies than in one of 4 (``batch_probe``): the
#: row sums of ``output_normalizer``'s standardization (a (S, M*N + E) sum
#: whose reduction layout follows the number of rows) and cuBLAS's batched
#: product vᵀv of ``source_predict``'s covariance ((S*M, E, N) x
#: (S*M, N, E), whose kernel follows the batch count).  The 60-step L-BFGS
#: target fits amplify such bits in later iterations, so what is held is
#: each study's own noise draws (y - y_clean, to f32 rounding) and the
#: first proposals (no target data yet, so neither operation reaches the
#: first fit's objective), in the unit cube
CHUNK_TOL = {"noise": 1e-5, "first_x": 5e-3}

# kernel vs plain: inverse to this share of max|A^-1|, logdet relative
TOL_INV = {torch.float32: 1e-4, torch.float64: 1e-11}
TOL_LOGDET = {torch.float32: 1e-5, torch.float64: 1e-12}
#: kernels that repeat their plain version's operations element by element,
#: held to its bits in float32
BITWISE = ("sweep_inverse_pair",)


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


def reset_launches():
    """Every kernel's launch count to 0."""
    inverse_mll.reset_kernel_launches()
    gram.rbf_gram.launches = 0


def launches_now() -> dict:
    """Every kernel's launch count, by name."""
    return {**inverse_mll.kernel_launches(),
            "rbf_gram": gram.rbf_gram.launches}


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
    cold = [n for n in cuda_build.SOURCES
            if not cuda_build.library_path(n).exists()]
    cuda_build.build_all()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    emit("build", time.perf_counter() - t0, sources=list(cuda_build.SOURCES),
         built_cold=cold)


def blocked(variant):
    return lambda A: blocked_chol.blocked_chol_inverse(A, variant)


def swept(variant):
    return (lambda A: sweep.sweep_inverse(A, variant),
            lambda A: sweep.sweep_inverse_reference(A, variant))


# name -> (kernel wrapper, plain version)
KERNELS = {
    **{sweep.kernel_name(v): swept(v) for v in sweep.VARIANTS},
    "blocked_chol_inverse_smem": (
        blocked("smem"), blocked_chol.blocked_chol_inverse_reference),
    "blocked_chol_inverse_global": (
        blocked("global"), blocked_chol.blocked_chol_inverse_reference),
}


def check_kernel(name, A, what):
    """The kernel against its plain version on the same A, within the
    stated tolerances; returns the inverse's largest absolute error."""
    kernel, plain = KERNELS[name]
    dtype, n = A.dtype, A.shape[-1]
    inv_k, ld_k = kernel(A)
    torch.cuda.synchronize()
    inv_p, ld_p = plain(A)
    err = (inv_k - inv_p).abs().max().item()
    scale = inv_p.abs().max().item()
    ld_err = ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item()
    bitwise = bool(torch.equal(inv_k, inv_p) and torch.equal(ld_k, ld_p))
    emit("kernel_check", None, kernel=name, shapes=what, n=n,
         batch=A.shape[0], dtype=str(dtype), max_abs_err=err,
         max_abs_inv=scale, logdet_rel_err=ld_err, bitwise_equal=bitwise)
    if name in BITWISE and dtype == torch.float32:
        check(bitwise, f"{name} {what} n={n}: not bit for bit with its "
              "plain version in float32")
    check(err <= TOL_INV[dtype] * scale,
          f"{name} inverse {what} n={n} {dtype}: {err} > "
          f"{TOL_INV[dtype]} * {scale}")
    check(ld_err <= TOL_LOGDET[dtype],
          f"{name} logdet {what} n={n} {dtype}: {ld_err}")
    return err


def time_kernel(name, A, reps, plain_reps):
    """The kernel's time beside its plain version's, the library call's and
    the bound; for a kernel with a first version (``BASELINES``), that
    version's time too, the two timed in turns (old, new, new, old)."""
    kernel, plain = KERNELS[name]
    B, N, _ = A.shape
    bound_ms, bound_by = bound(B, N, A.dtype)
    out = dict(batch=B, n=N)
    if name in BASELINES:
        old = BASELINES[name]
        t = [time_ms(f, reps) for f in (lambda: old(A), lambda: kernel(A),
                                        lambda: kernel(A), lambda: old(A))]
        out.update(ms=(t[1] + t[2]) / 2, old_ms=(t[0] + t[3]) / 2)
    else:
        out["ms"] = time_ms(lambda: kernel(A), reps)
    return dict(out, plain_ms=time_ms(lambda: plain(A), plain_reps),
                library_ms=time_ms(lambda: library_inverse(A), 10),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel():
    """Every kernel against its plain version on the fixture's shapes and at
    the campaign's; then times at the campaign's shapes.  Returns, per
    kernel, the largest f32 error, the timings at its head shape and those
    at its other timed shapes."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    max_err = dict.fromkeys(KERNELS, 0.0)

    def fixture(b, n, dtype):
        return torch.as_tensor(spd_batch(rng, b, n), dtype=dtype,
                               device="cuda")

    # each scheme at the N it takes: odd and even N for select and fused,
    # even N for pair, N % 32 == 0 for blocked
    sweep_ns = {"select": (8, 32, 40, 128), "fused": (9, 32, 40, 128),
                "pair": (8, 32, 40, 128), "blocked": (32, 64, 96, 128)}
    for dtype in (torch.float32, torch.float64):
        for variant, ns in sweep_ns.items():
            name = sweep.kernel_name(variant)
            for n in ns:
                err = check_kernel(name, fixture(256, n, dtype), "fixture")
                if dtype == torch.float32:
                    max_err[name] = max(max_err[name], err)
        for n in (64, 88, 192, 256, 512, 1024):
            A = fixture(64 if n <= 256 else 16, n, dtype)
            for variant in blocked_chol.VARIANTS:
                if (variant == "smem" and blocked_chol.smem_bytes(
                        n, A.element_size()) > blocked_chol.SMEM_LIMIT):
                    continue
                name = f"blocked_chol_inverse_{variant}"
                err = check_kernel(name, A, "fixture")
                if dtype == torch.float32:
                    max_err[name] = max(max_err[name], err)

    cfg = CampaignConfig()
    p32, p256, p512, p128 = (SLICES[k] for k in
                             ("branin_t8_p32", "branin_t8_p256",
                              "hartmann6_t8_p512", "hartmann6_t8_p128"))

    def meta_batch(sl):
        return sl["studies"] * sl["tasks"] * (META_RESTARTS + 1)

    # (kernel, what, B, N, launches timed, plain launches timed)
    shapes = [
        ("sweep_inverse", "target_fit",
         p32["studies"] * (cfg.fit_restarts + 1), p32["evals"], 200, 10),
        ("blocked_chol_inverse_smem", "meta_fit", meta_batch(p256),
         p256["points"], 20, 3),
        ("blocked_chol_inverse_global", "meta_fit", meta_batch(p512),
         p512["points"], 20, 3),
        # the other variant at the smem shape: what the choice by bytes costs
        ("blocked_chol_inverse_global", "smem_shape", meta_batch(p256),
         p256["points"], 20, 3),
    ]
    # every sweep scheme at the p32 and hm6 p128 meta-fits' shapes and at
    # the bench's
    for variant in sweep.VARIANTS:
        name = sweep.kernel_name(variant)
        shapes += [
            (name, "p32_meta_fit", meta_batch(p32), p32["points"], 200, 10),
            (name, "p128_meta_fit", meta_batch(p128), p128["points"], 20, 2),
            (name, "bench", *BENCH_SHAPE, 20, 2),
        ]
    # the shape of each kernel's own path, for the kernels line
    head = {"sweep_inverse": "p32_meta_fit",
            "sweep_inverse_fused": "p128_meta_fit",
            "sweep_inverse_pair": "bench", "sweep_inverse_blocked": "bench",
            "blocked_chol_inverse_smem": "meta_fit",
            "blocked_chol_inverse_global": "meta_fit"}
    timed = {}
    for name, what, B, N, reps, plain_reps in shapes:
        A = fixture(B, N, torch.float32)
        max_err[name] = max(max_err[name], check_kernel(name, A, what))
        timed.setdefault(name, {})[what] = time_kernel(name, A, reps,
                                                      plain_reps)
        del A
        torch.cuda.empty_cache()
    emit("kernel", time.perf_counter() - t0, dtype="float32", shapes=timed)
    others = {k: {w: t for w, t in timed[k].items() if w != head[k]}
              for k in head}
    return max_err, {k: timed[k][w] for k, w in head.items()}, others


def mll_of(Ainv, logdet, y, n_active):
    quad = torch.sum(y * torch.sum(Ainv * y[:, None, :], -1), -1)
    return -0.5 * (quad + logdet + n_active * np.log(2 * np.pi))


def mll_plain(A, y, n_active, variant="select"):
    """``inverse_mll.mll_via_inverse`` with the plain versions in place of
    the kernels, routed as the port routes with ``route_blocked``."""
    N = A.shape[-1]
    if sweep.sweep_profitable(N):
        Ainv, logdet = sweep.sweep_inverse_reference(A, variant)
    else:
        Ainv, logdet = blocked_chol.blocked_chol_inverse_reference(A)
    return mll_of(Ainv, logdet, y, n_active)


def inverse_schemes(N, route_blocked):
    """The float32 inverse kernels that a slice's route takes at N, each as
    (name, kernel, plain version): every sweep scheme that N allows where
    the sweep serves N, else, with ``route_blocked``, the blocked variant
    that routing picks.  The kernels launch through the wrappers' uncounted
    ``_launch``: these comparisons are not the main path's launches."""
    if sweep.sweep_profitable(N):
        return [(v, lambda A, v=v: sweep._launch(A, v),
                 lambda A, v=v: sweep.sweep_inverse_reference(A, v))
                for v in sweep.VARIANTS if sweep.resolve_variant(N, v) == v]
    if blocked_chol.blocked_profitable(N, 4, route_blocked):
        v = blocked_chol.choose_variant(N, 4)
        return [(v, lambda A: blocked_chol._launch(A, v),
                 blocked_chol.blocked_chol_inverse_reference)]
    return []


def rounding(A, y, n_active, truth, key, schemes):
    """Each scheme's float32 MLL on these systems against ``truth``
    (float64): the kernel and its plain version, each as [max, median] over
    the systems of the relative error (|error| / max(|truth|, 1)).  Fails
    if the kernel's max is above twice the plain version's.  ``schemes``:
    ``inverse_schemes``' list."""
    def rel(v):
        r = (v.double() - truth).abs() / truth.abs().clamp_min(1.0)
        return [r.max().item(), r.median().item()]

    out = {}
    for name, kernel, plain in schemes:
        out[name] = {"kernel": rel(mll_of(*kernel(A), y, n_active)),
                     "plain": rel(mll_of(*plain(A), y, n_active))}
        check(out[name]["kernel"][0] <= 2.0 * out[name]["plain"][0],
              f"{key}: the {name} kernel's MLL is {out[name]['kernel'][0]} "
              f"from float64, its plain version's {out[name]['plain'][0]}")
    return out


def phase_slice(key):
    """One slice's campaign; returns its launches of every kernel."""
    sl = SLICES[key]
    t0 = time.perf_counter()
    fn, tp, md, optima = campaign_inputs_from_benchmark(
        sl["benchmark"], [sl["points"]] * sl["tasks"], range(sl["studies"]),
        noise_std=sl["sigma"], dtype=torch.float32, device="cuda",
        optimum_method=sl["optimum"])
    setup_s = time.perf_counter() - t0
    cfg = CampaignConfig(n_evaluations=sl["evals"], noise_std=sl["sigma"],
                         mll_method="sweep",
                         route_blocked=sl["route_blocked"],
                         sweep_variant=sl["sweep_variant"])
    S, M, N, d = md.X.shape

    GLOBAL_TIMER.reset()
    reset_launches()
    res = run_campaign(fn, tp, md, seed=0, cfg=cfg,
                       meta_fit_restarts=META_RESTARTS,
                       meta_fit_steps=META_STEPS, device="cuda")
    torch.cuda.synchronize()
    launches = launches_now()
    stages = GLOBAL_TIMER.report()

    for name in sl["kernels"]:
        check(res.launches[name][0] > 0,
              f"{key}: the meta-fit launched {name} no time")
    for name, counts in res.launches.items():
        if name not in sl["kernels"]:
            check(counts[0] == 0, f"{key}: the meta-fit launched {name}")
    # the target fits' systems are E x E: the slice's scheme where E allows
    # it, else select
    target = sweep.kernel_name(sweep.resolve_variant(sl["evals"],
                                                     sl["sweep_variant"]))
    check(sum(res.launches[target][1:]) > 0,
          f"{key}: the target fits launched {target} no time")
    check(sum(launches.values()) == sum(sum(c) for c in
                                        res.launches.values()),
          f"{key}: launch counts of the run and of the result differ")
    # a source GP left with a non-finite factor would poison its study
    check(res.nonfinite_source_tasks == 0,
          f"{key}: {res.nonfinite_source_tasks} source GPs with a "
          "non-finite factor")
    X = res.X
    check(X.shape == (S, sl["evals"], d), f"proposal shape {tuple(X.shape)}")
    check(bool(torch.isfinite(X).all()), f"{key}: non-finite proposal")
    check(bool(((X >= 0) & (X <= 1)).all()),
          f"{key}: proposal outside the unit cube")
    regret = simple_regret(res.y_clean, optima)
    check(bool(torch.isfinite(regret).all()), f"{key}: non-finite regret")

    # one batch of the campaign's own systems: the meta-fit's first
    # objective evaluation (every task at the warm start), kernel vs plain
    flat_X, flat_y, flat_m = (t.reshape((S * M,) + t.shape[2:])
                              for t in (md.X, md.y, md.mask))
    scfg = gp.source_gp_config()
    c = gp.constrain(scfg, gp.init_params(scfg, d, torch.float32, "cuda",
                                          batch_shape=(S * M,)))
    A = linalg.mask_system(gp.gram(scfg, c, flat_X), c.noise, flat_m)
    y = flat_y * flat_m
    na = flat_m.sum(-1)
    plain = mll_plain(A, y, na, sl["sweep_variant"])
    kern = inverse_mll.mll_via_inverse(A, y, na, sl["route_blocked"],
                                       sl["sweep_variant"])
    diff = (kern - plain).abs()
    # both f32 results against the plain version in f64 on the same systems
    truth = mll_plain(A.double(), y.double(), na.double())
    rounded = rounding(A, y, na, truth, key,
                       inverse_schemes(N, sl["route_blocked"]))

    def rel_to_truth(v):
        return ((v.double() - truth).abs()
                / truth.abs().clamp_min(1.0)).max().item()

    extra = {}
    if "chol64" in sl:
        extra["chol64"] = chol64_entry(key, scfg, flat_X, flat_y, flat_m,
                                       kern, truth)

    per_iter = res.iteration_seconds
    emit("slice", time.perf_counter() - t0, slice=key,
         benchmark=sl["benchmark"].__name__, tasks=M, points=N, d=d,
         sigma=sl["sigma"], route_blocked=sl["route_blocked"],
         sweep_variant=sl["sweep_variant"],
         studies=S, evaluations=sl["evals"], setup_s=setup_s,
         meta_fit_s=res.meta_fit_seconds, iteration_s=per_iter,
         nonfinite_source_tasks=res.nonfinite_source_tasks,
         mean_iteration_s=float(np.mean(per_iter)),
         median_final_regret=float(regret[:, -1].median()),
         median_regret=[float(v) for v in regret.median(dim=0).values],
         launches=launches,
         launches_meta_fit={k: v[0] for k, v in res.launches.items()},
         launches_per_iteration={k: v[1:] for k, v in res.launches.items()},
         mll_kernel_vs_plain_max_abs=diff.max().item(),
         mll_kernel_vs_plain_max_rel=(diff / plain.abs().clamp_min(1.0))
         .max().item(),
         mll_kernel_vs_f64_max_rel=rel_to_truth(kern),
         mll_plain_vs_f64_max_rel=rel_to_truth(plain), stages=stages,
         rounding=rounded, **extra)
    return launches


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def chol64_entry(key, scfg, X, y, mask, kern, truth):
    """``gp.mll(method="chol64")`` on a slice's float32 inputs at the
    warm start against ``gp.mll(method="chol")`` on the same inputs and
    parameters cast to float64, which must agree to TOL_CHOL64 relative;
    with the distances of the kernel route's MLL ``kern`` and of ``truth``
    (the float32 systems promoted to float64) from that float64 MLL."""
    d = X.shape[-1]
    p32 = gp.init_params(scfg, d, X.dtype, X.device,
                         batch_shape=X.shape[:1])
    p64 = gp.GPParams(*[leaf.double() for leaf in p32])
    t0 = time.perf_counter()
    v64 = gp.mll(scfg, p32, X, y, mask, method="chol64")
    sync(X.device)
    chol64_s = time.perf_counter() - t0
    ref = gp.mll(scfg, p64, X.double(), y.double(), mask.double(),
                 method="chol")

    def rel(v):
        r = (v.double() - ref).abs() / ref.abs().clamp_min(1.0)
        return [r.max().item(), r.median().item()]

    out = {"chol64_vs_f64": rel(v64), "chol64_dtype": str(v64.dtype),
           "chol64_s": chol64_s, "kernel_vs_f64_assembled": rel(kern),
           "f32_systems_in_f64_vs_f64_assembled": rel(truth)}
    check(v64.dtype == torch.float32 and bool(torch.isfinite(v64).all()),
          f"{key}: chol64 MLL {v64.dtype}, finite "
          f"{bool(torch.isfinite(v64).all())}")
    check(out["chol64_vs_f64"][0] <= TOL_CHOL64,
          f"{key}: chol64 is {out['chol64_vs_f64'][0]} from the MLL "
          "computed in float64")
    return out


def phase_campaign_resume(device="cuda"):
    """The many-task campaign uninterrupted, stopped and resumed, and in
    study chunks; returns the phase's launches of every kernel."""
    t0 = time.perf_counter()
    fn, tp, md, optima = campaign_inputs_from_benchmark(
        Quadratic, [RESUME_POINTS] * RESUME_TASKS, RESUME_SEEDS,
        noise_std=RESUME_SIGMA, dtype=torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    cfg = CampaignConfig(n_evaluations=RESUME_EVALS, noise_std=RESUME_SIGMA,
                         mll_method="sweep")
    kw = dict(seed=0, cfg=cfg, meta_fit_restarts=META_RESTARTS,
              meta_fit_steps=META_STEPS, device=device)
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    RESUME_DIR.mkdir(parents=True)
    runs = [("uninterrupted", {}),
            ("stopped", dict(checkpoint_path=RESUME_DIR / "b",
                             stop_after=RESUME_STOP)),
            ("resumed", dict(checkpoint_path=RESUME_DIR / "b")),
            ("chunked", dict(checkpoint_path=RESUME_DIR / "c",
                             study_chunk=RESUME_CHUNK))]
    reset_launches()
    out, lines = {}, []
    for name, extra in runs:
        tr = time.perf_counter()
        res = run_campaign(fn, tp, md, **kw, **extra)
        sync(device)
        out[name] = res
        n = res.launches["sweep_inverse"]
        lines.append({"run": name, "seconds": time.perf_counter() - tr,
                      "meta_fit_s": res.meta_fit_seconds,
                      "iteration_s": res.iteration_seconds,
                      "completed": int(res.mask.sum(-1).min()),
                      "sweep_inverse_launches": sum(n),
                      "sweep_inverse_meta_fit": n[0],
                      "sweep_inverse_per_iteration": n[1:]})
        check(n[0] > 0 and sum(n[1:]) > 0,
              f"campaign_resume {name}: sweep_inverse launches {n}")
    launches = launches_now()
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    check(lines[1]["completed"] == RESUME_STOP,
          f"campaign_resume: the stopped run completed "
          f"{lines[1]['completed']} iterations")
    a = out["uninterrupted"]
    check(a.X.shape == (len(RESUME_SEEDS), RESUME_EVALS, 1)
          and bool(torch.isfinite(a.X).all())
          and bool(((a.X >= 0) & (a.X <= 1)).all())
          and bool(torch.isfinite(a.y_clean).all()),
          "campaign_resume: proposals or losses out of range")
    equal = {}
    for name in ("resumed", "chunked"):
        b = out[name]
        equal[name] = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
                       for f in ("X", "y", "y_clean")}
        equal[name]["max_abs_diff_X"] = (a.X - b.X).abs().max().item()
        equal[name]["max_abs_diff_X_per_iteration"] = (
            (a.X - b.X).abs().amax(dim=(0, 2)).tolist())
        equal[name]["max_abs_diff_noise"] = ((a.y - a.y_clean)
                                             - (b.y - b.y_clean)).abs().max(
                                             ).item()
    same = {k: all(equal[k][f] for f in ("X", "y", "y_clean"))
            for k in equal}
    check(same["resumed"], "campaign_resume: the resumed run differs from "
          f"the uninterrupted one: {equal['resumed']}")
    # the chunked run: bit for bit, or, where a batch-size-dependent
    # library operation moved a last bit (CHUNK_TOL), each study's own
    # noise draws and first proposals, and valid proposals throughout
    ec, c = equal["chunked"], out["chunked"]
    check(same["chunked"] or (
        ec["max_abs_diff_noise"] <= CHUNK_TOL["noise"]
        and ec["max_abs_diff_X_per_iteration"][0] <= CHUNK_TOL["first_x"]
        and bool(torch.isfinite(c.X).all())
        and bool(((c.X >= 0) & (c.X <= 1)).all())),
          f"campaign_resume: the chunked run differs from the "
          f"uninterrupted one beyond {CHUNK_TOL}: {ec}")
    regret = simple_regret(a.y_clean, optima)
    emit("campaign_resume", time.perf_counter() - t0,
         benchmark="Quadratic", tasks=RESUME_TASKS, points=RESUME_POINTS,
         d=1, sigma=RESUME_SIGMA, studies=len(RESUME_SEEDS),
         evaluations=RESUME_EVALS, stop_after=RESUME_STOP,
         study_chunk=RESUME_CHUNK, setup_s=setup_s, runs=lines,
         equal_to_uninterrupted=equal,
         nonfinite_source_tasks=a.nonfinite_source_tasks,
         median_regret=[float(v) for v in regret.median(dim=0).values],
         launches=launches)
    return launches


def phase_bench():
    """The kernel N-scaling bench at BENCH_SHAPE with every variant; every
    entry must be a number, and the pair and blocked variants must have
    run their kernels.  Returns the launches of every kernel."""
    t0 = time.perf_counter()
    reset_launches()
    out = bench_sweep_n.run([BENCH_SHAPE], list(bench_sweep_n.VARIANTS),
                            device="cuda", rounds=BENCH_ROUNDS)
    torch.cuda.synchronize()
    launches = launches_now()
    row = out["results"][0]
    for variant in bench_sweep_n.VARIANTS:
        check(isinstance(row[variant], float),
              f"bench_sweep_n {variant}: {row[variant]}")
    for variant in ("fused", "pair", "blocked"):
        name = sweep.kernel_name(variant)
        check(row["launches"][variant].get(name, 0) > 0,
              f"bench_sweep_n {variant} launched {name} no time")
    emit("bench_sweep_n", time.perf_counter() - t0, card=out["card"],
         B=row["B"], N=row["N"], rounds=BENCH_ROUNDS,
         evals_per_s={v: row[v] for v in bench_sweep_n.VARIANTS},
         launches_by_variant=row["launches"], launches=launches)
    return launches


def phase_gram():
    """The RBF Gram kernel against its plain version and its gradient
    against autograd of ``kernels.rbf``; then its times.  Returns the
    kernels-line entries and the phase's launches of the kernel."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    gram.rbf_gram.launches = 0

    def make(n, m, d, dtype, grad=False):
        vals = (rng.uniform(size=(n, d)), rng.uniform(size=(m, d)),
                rng.uniform(0.3, 1.0, size=d), np.asarray(1.3))
        return [torch.tensor(v, dtype=dtype, device="cuda",
                             requires_grad=grad) for v in vals]

    max_err, checks = 0.0, []
    for dtype in (torch.float32, torch.float64):
        for n, m, d in GRAM_CHECKS:
            args = make(n, m, d, dtype)
            Kk = gram.rbf_gram(*args)
            torch.cuda.synchronize()
            err = (Kk - gram.rbf_gram_plain(*args)).abs().max().item()
            checks.append({"n": n, "m": m, "d": d, "dtype": str(dtype),
                           "max_abs_err": err})
            check(Kk.dtype == dtype and Kk.shape == (n, m),
                  f"rbf_gram ({n}, {m}, {d}) {dtype}: {Kk.dtype} "
                  f"{tuple(Kk.shape)}")
            check(err <= 2e-5, f"rbf_gram ({n}, {m}, {d}) {dtype}: {err}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
        vals = make(*GRAM_CHECKS[0], dtype, grad=True)
        refs = [v.detach().clone().requires_grad_(True) for v in vals]
        cot = torch.randn((GRAM_CHECKS[0][0], GRAM_CHECKS[0][1]),
                          dtype=dtype, device="cuda")
        gk = torch.autograd.grad(gram.rbf_gram(*vals), vals, cot)
        gr = torch.autograd.grad(kernels.rbf(*refs), refs, cot)
        grad_err = max(((a - b).abs() / b.abs().clamp_min(1e-30)).max()
                       .item() for a, b in zip(gk, gr))
        checks.append({"gradient": list(GRAM_CHECKS[0]),
                       "dtype": str(dtype), "max_rel_err": grad_err})
        check(grad_err <= 1e-4, f"rbf_gram gradient {dtype}: {grad_err}")

    timed = [gram_times(n, m, d, dtype) for (n, m, d), dtype in
             [(s, torch.float32) for s in GRAM_TIMED]
             + [((4096, 4096, 2), torch.float64)]]
    for t in timed:
        check(t["max_abs_err"] <= 2e-5 and t["old_max_abs_err"] <= 2e-5,
              f"rbf_gram timed ({t['n']}, {t['m']}, {t['d']}) {t['dtype']}: "
              f"{t['max_abs_err']}, first version {t['old_max_abs_err']}")
    launches = gram.rbf_gram.launches
    emit("gram", time.perf_counter() - t0, checks=checks, timed=timed,
         launches=launches)
    return {**timed[0], "max_abs_err": max_err}, launches


class TimedBO(ScaMLGPBO):
    """``ScaMLGPBO`` that keeps itself and the driver stages' totals after
    the meta-fit and after each report, so that each evaluation's refit
    and acquisition seconds can be told apart."""

    made = []

    def __init__(self, search_space, objective, meta_data, **kwargs):
        super().__init__(search_space, objective, meta_data, **kwargs)
        self.marks = [dict(GLOBAL_TIMER.totals)]
        TimedBO.made.append(self)

    def report(self, evaluations):
        super().report(evaluations)
        self.marks.append(dict(GLOBAL_TIMER.totals))


def phase_driver():
    """BRANIN_T8_P32_N1_SCAMLGP through ``run_study`` on the card, one line
    per study; returns the launches of every kernel in the phase."""
    t0 = time.perf_counter()
    reset_launches()
    for seed in DRIVER_SEEDS:
        ts = time.perf_counter()
        GLOBAL_TIMER.reset()
        TimedBO.made.clear()
        torch.cuda.reset_peak_memory_stats()
        res = run_study(TimedBO, {}, Branin,
                        {"n_data_per_task": [32] * 8}, DRIVER_EVALS, seed,
                        HomoscedasticGaussianNoise({"loss": 1.0}))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        opt = TimedBO.made[0]
        check(opt.device.type == "cuda" and opt.dtype == torch.float64,
              f"driver seed {seed}: {opt.device} {opt.dtype}")
        space = opt.search_space
        for e in res["evaluations"]:
            vec = space.to_numerical(e["configuration"])
            check(bool(np.isfinite(vec).all()) and bool(
                ((vec >= 0) & (vec <= 1)).all())
                and space.check_validity(e["configuration"]),
                f"driver seed {seed}: proposal {e['configuration']}")
        src = opt.source_gps
        check(bool(torch.isfinite(src.chol).all())
              and bool(torch.isfinite(src.alpha).all()),
              f"driver seed {seed}: a source factor is not finite")
        # the final model's predict on the card against the joint posterior
        # of the same model moved to the CPU in float64
        Xq = sobol_unit(seed, 64, len(space), torch.float64)
        configs = [space.from_numerical(v) for v in Xq.numpy()]
        mean, std = opt.predict(configs)
        cpu = convert.scamlgp_model(convert.to_numpy_dict(opt.model),
                                    torch.float64, "cpu")
        Xc = torch.as_tensor(np.stack([space.to_numerical(c)
                                       for c in configs]))
        cmean, cvar = model_lib.scamlgp_posterior_diag(
            cpu, opt.source_cfg, opt.target_cfg, Xc)
        cmean, cstd = cmean.numpy(), np.sqrt(cvar.numpy())
        rel = max(float(np.max(np.abs(mean - cmean)
                               / np.maximum(np.abs(cmean), 1e-12))),
                  float(np.max(np.abs(std - cstd)
                               / np.maximum(np.abs(cstd), 1e-12))))
        check(bool(np.isfinite(mean).all()) and rel <= 1e-6,
              f"driver seed {seed}: predict on the card is {rel} from the "
              "CPU's posterior")

        def per_eval(stage):
            tot = [m.get(stage, 0.0) for m in opt.marks]
            return [b - a for a, b in zip(tot, tot[1:])]

        regret = study_regret(res)
        check(bool(np.isfinite(regret).all()) and regret.min() >= -1e-6,
              f"driver seed {seed}: regret {regret}")
        emit("driver", time.perf_counter() - ts, seed=seed,
             experiment="BRANIN_T8_P32_N1_SCAMLGP", tasks=8, points=32,
             d=len(space), sigma=1.0, evaluations=DRIVER_EVALS,
             dtype="float64", optimum=float(res["optimum"]),
             meta_fit_s=opt.marks[0].get("meta_fit", 0.0),
             refit_s=per_eval("refit"),
             acquisition_s=per_eval("acquisition"),
             regret=[float(v) for v in regret],
             predict_vs_cpu_max_rel=rel, max_memory_allocated=peak,
             stages=GLOBAL_TIMER.report())
    launches = launches_now()
    emit("driver_phase", time.perf_counter() - t0, launches=launches)
    return launches


REPLACES = {
    "sweep_inverse": ("scamlgp_tpu_torch/csrc/sweep_inverse.cu",
                      "scamlgp_tpu/ops/pallas_sweep.py:96"),
    "sweep_inverse_fused": ("scamlgp_tpu_torch/csrc/sweep_variants.cu",
                            "scamlgp_tpu/ops/pallas_sweep.py:140"),
    "sweep_inverse_pair": ("scamlgp_tpu_torch/csrc/sweep_variants.cu",
                           "scamlgp_tpu/ops/pallas_sweep.py:183"),
    "sweep_inverse_blocked": ("scamlgp_tpu_torch/csrc/sweep_variants.cu",
                              "scamlgp_tpu/ops/pallas_sweep.py:268"),
    "blocked_chol_inverse_smem": (
        "scamlgp_tpu_torch/csrc/blocked_chol_inverse.cu",
        "scamlgp_tpu/ops/pallas_blocked_chol.py:225"),
    "blocked_chol_inverse_global": (
        "scamlgp_tpu_torch/csrc/blocked_chol_inverse.cu",
        "scamlgp_tpu/ops/pallas_blocked_chol.py:244"),
    "rbf_gram": ("scamlgp_tpu_torch/csrc/gram.cu",
                 "scamlgp_tpu/ops/pallas_gram.py:31"),
}


def main():
    card = phase_device()
    phase_build()
    max_err, head, others = phase_kernel()
    head["rbf_gram"], gram_launches = phase_gram()
    max_err["rbf_gram"] = head["rbf_gram"]["max_abs_err"]
    by_slice = {key: phase_slice(key) for key in SLICES}
    by_slice["campaign_resume"] = phase_campaign_resume()
    by_slice["bench_sweep_n"] = phase_bench()
    by_slice["driver"] = phase_driver()
    # each kernel's launches in the slice (or the bench) whose main path
    # carries it
    carrier = {name: key for key, sl in SLICES.items()
               for name in sl["kernels"]}
    carrier.update(sweep_inverse_pair="bench_sweep_n",
                   sweep_inverse_blocked="bench_sweep_n")
    launches = {name: by_slice[key][name] for name, key in carrier.items()}
    # no path launches the Gram kernel: its count is the gram phase's
    launches["rbf_gram"] = gram_launches
    kernels = []
    for name in (*KERNELS, "rbf_gram"):
        source, replaces = REPLACES[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "launches_by_slice": {key: n[name] for key, n in by_slice.items()},
            "max_abs_err": max_err[name],
            "ms": head[name]["ms"],
            "plain_ms": head[name]["plain_ms"],
            "bound_ms": head[name]["bound_ms"],
            "bound_by": head[name]["bound_by"],
            "library_ms": head[name]["library_ms"],
            # the first version's time, timed in turns with this one
            "old_ms": head[name].get("old_ms"),
            # rbf_gram: its own time without the wrapper, the host's issue
            # time of a call, and the first kernel through its wrapper
            **{k: head[name][k] for k in ("ms_kernel", "host_ms",
                                          "old_call_ms", "rbf_eager_ms")
               if k in head[name]},
            # the kernel's times at its other timed shapes (select at the
            # hm6 p128 meta-fit's and the bench's N = 128, global at the
            # smem variant's shape)
            "other_shapes": others.get(name, {}),
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
