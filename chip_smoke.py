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
3c. probes: the sweep's two loop-shape probes (``ops/probes.py``,
   ``csrc/probe_kernels.cu``) at (PROBE_CHECK_B, n, n), n in
   PROBE_CHECK_NS (the warp path and the blocked one, ragged panels at
   100 and 127).  The Cholesky kernel against its panel recurrence
   (``blocked_cholesky_mirror``) and its plain version within
   TOL_PROBE_CHOL max|L|, and against ``torch.linalg.cholesky`` (rel
   TOL_PROBE_LIBRARY); the floor kernel against its FMA recurrence
   (``traversal_floor_fma_reference``) within TOL_PROBE_FLOOR_ULPS, with
   the share of elements that are not bit for bit, and within n ulps of
   its unfused plain version (one tie a step); their first versions
   (``PROBE_BASELINES``, ``csrc/baseline_kernels.cu``): the factor within
   TOL_PROBE_CHOL of its plain version, the floor bit for bit, their
   launch ``select``'s, and the new kernels' the one
   ``probes.launch_geometry`` gives.  Then, with every launch count set
   to 0, the two probes' entry points at their defaults
   (``bench_chol_fused_probe.run`` and ``bench_traversal_floor.run`` at
   PROBE_SHAPE, PROBE_REPS chained launches, each beside ``select``,
   and each timed alone too); each must launch its kernel.  Then both
   kernels at PROBE_TIMED on the entry points' batch
   (``profile_kernels.probe_row``): held there to the same checks, and
   timed beside their first versions in turns (old, new, new, old)
   through the wrappers and alone (bare launches behind a device spin),
   with ``select``, ``torch.linalg.cholesky``, their plain versions and
   bounds (``profile_kernels.probe_bound``).  Then
   ``validate_large_n`` (BASELINE config 5) at LARGE_N_SIZES, d = 6, 64
   queries, whose every row, N = 2048 included, must pass;
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
4a. device_loop: the Branin T8 N_m=32 slice's cell again, on the same
   inputs, through ``run_campaign(loop="device")``: iteration 0 eagerly,
   the body captured once as a CUDA graph and replayed for iterations
   1 .. E-1, capture and replays under ``set_sync_debug_mode("error")``.
   Its X, y and y_clean must equal the slice's host-loop result bit for
   bit.  ``select`` must be launched in every replay: the graph's own
   kernel nodes (``utils.cuda_graph.kernel_nodes``, read through the CUDA
   driver API) must hold it the fixed-trip target fit's 1 + fit_steps x 20 +
   1 times and no other hand-written kernel, as many as the wrapper
   counted while the graph was captured and as the warm-up launched.  The
   phase's launches are the counters' (meta-fit, warm-up) and each
   replay's kernel nodes, never the capture's count.  One line with the
   host loop's and the device loop's seconds an iteration, the capture
   and instantiate seconds, the kernel nodes a replay, the launches
   (trips) a target fit of both loops, and the peak device memory
   (counted from a reset just before the run) without and with the
   graph's pool;
4b. campaign_resume: the many-task configuration (BASELINE.json config 4):
   Quadratic, 128 meta-tasks x 32 points, d=1, noise 0.05, study seeds
   0-3, float32, ``mll_method="sweep"`` (``select``), E=RESUME_EVALS,
   three ways:
   (a) uninterrupted; (b) checkpointed with ``stop_after=2``, then resumed
   to E from the checkpoint; (c) ``study_chunk=2``, checkpointed.  (b) must
   equal (a) bit for bit; (c) must too, or, where the card's
   batch-size-dependent library operations move a last bit
   (``CHUNK_TOL``), match (a) in each study's noise draws and first
   proposals.  One line per run with its
   seconds, meta-fit seconds and ``sweep_inverse`` launches;
4c. posterior: the posterior-marginalized fits on Branin T8 (8 meta-tasks x
   32 points, d=2, noise 1.0), float32, ``mll_method="sweep"``, the
   CampaignConfig sampler defaults, POSTERIOR_STUDIES studies: three
   campaigns, ``fit_method`` ``"hmc"`` (2 chains x (64 warmup + 16
   samples) x 12 leapfrog steps) and ``"vi"`` (200 ADVI steps x 8 draws)
   over POSTERIOR_EVALS evaluations, ``"nuts"`` (max depth 6) over
   POSTERIOR_NUTS_EVALS = 1: its lock-step transitions run to the longest
   chain's 63 steps, so that one NUTS iteration costs about six HMC ones,
   and its launch bounds hold at one iteration as at many.  Each campaign
   has its own meta-fit.  Every sampler step evaluates the target log-density and
   gradient of all studies x chains (or x Monte-Carlo draws) as one batch,
   one ``select`` launch.  Each campaign's launches per iteration must be
   what the design predicts (``posterior_launches``): HMC 1 + 80 x 12 =
   961 (the leapfrog's last evaluation is the accept step's, where the
   JAX package evaluates it again: 1041 there), ADVI 200, NUTS between
   1 + 80 x 2 = 161 and 1 + 80 x 64 = 5121 (each transition's doublings
   and its extra gradient at the chosen state).  Every proposal must be
   finite and in the unit cube.  The HMC campaign's last mixture draws
   then hold the kernel route's float32 log-density and gradient at the
   final data against the plain version's (``sweep_inverse_reference``
   in place of the kernel), each within twice the plain version's
   distance from the float64 ones.  Then the sequential driver with
   ``fit_method`` ``"hmc"`` and ``"vi"`` (its default sampler settings,
   float64, the Cholesky route: no kernel) through ``run_study``, 1 study
   x POSTERIOR_DRIVER_EVALS evaluations each.  ``select`` is then timed
   at the samplers' shapes (``posterior_times``);
4d. experiment: the experiment layer.  ``submit`` of the paper's
   ``BRANIN_T8_P32_N1_SCAMLGP`` (8 meta-tasks x 32 points, d=2, noise 1.0,
   not cut) cut to EXPERIMENT_STUDIES x EXPERIMENT_EVALS, a copy of the
   ``Experiment`` from ``configurations/branin.py``, through
   ``local_runner.main`` on the card into EXPERIMENT_DIR: the log must
   show the campaign route, ``load_results_from_disk`` must read back
   every study, their regret curves equal to the ``CampaignResult``'s to
   float32 rounding (TOL_REGRET), and the ``hash`` CLI must print the JAX
   package's hashes (BRANIN_HASHES).  Then two table campaigns of
   EXPERIMENT_TABLE_STUDIES x EXPERIMENT_TABLE_EVALS through
   ``tabular_adapters`` and ``run_campaign``, float32, the CampaignConfig
   defaults, on synthetic tables made from TABLE_DATA_SEED at the
   published shapes: ``GridTable``, two ordinal dimensions of 32 levels
   (G = 1024) with 28 meta-tasks x 64 points (``lr_tabular``'s width),
   every observation equal to the benchmark's own host lookup of
   ``from_numerical(x)``; ``NNTable``, PD1's four continuous dimensions
   with 22 meta-tasks x 128 points (``pd1``'s width) and target tables of
   1024 to 4096 rows, every observation the host's float64 L1 argmin (or,
   at a float32 near tie, a row as near).  One line with each run's setup,
   meta-fit and per-iteration seconds and the tables' bytes on the card.
   ``submit`` runs ``chol``, the default of both packages, so the phase
   launches no hand kernel;
4e. sharded: the sharding layer (``parallel/mesh.py``,
   ``parallel/scamlgp_sharded.py``, ``parallel/distributed.py``,
   ``distributed_worker``) on slots of the card (``mesh.local_slots``: on a
   machine of several cards, one card a slot), the slots of a mesh at
   once (``mesh.run_slots``: a host thread and a CUDA stream a slot) and,
   to compare, in turn, float32, ``sweep``:
   (a) the many-task regime (SHARD_A: Quadratic, 128 meta-tasks x 32
   points, d=1, noise 0.05, one study) on a (1, SHARD_TASK_SLOTS) mesh:
   ``meta_fit_sharded`` against ``meta_fit_task_stack`` on the same
   restarts (SHARD_META_STEPS steps), held in each task's MAP objective,
   evaluated in float64 (SHARD_META_TOL), and bit for bit against the
   same mesh's slots in turn (each slot's tasks fitted alone),
   ``build_sharded_target``'s normalizer against the unsharded model's
   (SHARD_NORM_RTOL), and ``fit_target_sharded`` (SHARD_TARGET_STEPS Adam
   steps), which must lower the unsharded objective with finite weights;
   (b) the width of ``BRANIN_T8_P32_N1_SCAMLGP`` (SHARD_B: 8 meta-tasks x
   32 points, d=2, noise 1.0, 8 studies x 2 evaluations, the
   CampaignConfig defaults) three ways: unsharded, on a (2, 1) mesh in
   this process with its rows at once, and as two gloo ranks of
   ``distributed_worker`` sharing the card (subprocesses on a free port, SHARD_RANK_TIMEOUT s), whose
   rows must cover every study once.  The mesh and the ranks must equal
   each other and, on the card, the unsharded run bit for bit (on the
   CPU, where the batch size moves last bits, the unsharded run as the
   chunks are, CHUNK_TOL).  One line with each leg's seconds, leg (a)'s
   slots at once over in turn, peak device memory and ``select``
   launches, the ranks' own lines inside it; the phase's launches include
   the ranks';
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

import contextlib
import dataclasses
import io
import json
import logging
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from scamlgp_tpu_torch import (
    bench_chol_fused_probe,
    bench_sweep_n,
    bench_traversal_floor,
    convert,
    distributed_worker,
    meta_fit_split,
    validate_large_n,
)
from scamlgp_tpu_torch.benchmarking.benchmarks import (
    Branin,
    Hartmann6D,
    Quadratic,
)
from scamlgp_tpu_torch.benchmarking import local_runner, tabular_adapters
from scamlgp_tpu_torch.benchmarking import utils as experiment_utils
from scamlgp_tpu_torch.benchmarking.benchmarks.api import Benchmark, Task
from scamlgp_tpu_torch.benchmarking.configurations import (
    branin as branin_experiments,
)
from scamlgp_tpu_torch.benchmarking.local_runner import run_study
from scamlgp_tpu_torch.benchmarking.noise import HomoscedasticGaussianNoise
from scamlgp_tpu_torch.benchmarking.plotting import _regret_curves
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.core import (
    Evaluation,
    EvaluationSpecification,
    Objective,
)
from scamlgp_tpu_torch.bo.space import (
    ContinuousParameter,
    OrdinalParameter,
    ParameterSpace,
)
from scamlgp_tpu_torch.bo.optimize import sobol_unit
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch.models import fit as fit_lib
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as model_lib
from scamlgp_tpu_torch.ops import (
    blocked_chol,
    cuda_build,
    gram,
    inverse_mll,
    kernels,
    linalg,
    probes,
    sweep,
)
from scamlgp_tpu_torch.parallel import scamlgp_sharded
from scamlgp_tpu_torch.parallel.campaign import (
    CampaignConfig,
    run_campaign,
    simple_regret,
    target_objective,
)
from scamlgp_tpu_torch.parallel.mesh import Mesh, local_slots, make_mesh
from scamlgp_tpu_torch.profile_kernels import (
    BASELINES,
    PROBE_BASELINES,
    baseline_probe_geometry,
    bound,
    gram_times,
    library_inverse,
    probe_bound,
    probe_errors,
    probe_row,
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
DRIVER_SEEDS, DRIVER_EVALS = (0, 1), 4
#: the campaign_resume phase: BASELINE.json config 4 (M=128 x N_m=32,
#: sigma 0.05, study seeds 0-3) cut to RESUME_EVALS evaluations, stopped
#: after RESUME_STOP, chunked by RESUME_CHUNK studies
RESUME_TASKS, RESUME_POINTS, RESUME_SIGMA = 128, 32, 0.05
RESUME_SEEDS, RESUME_EVALS, RESUME_STOP, RESUME_CHUNK = range(4), 3, 2, 2
#: where the phase's checkpoints go (removed at its end)
RESUME_DIR = Path(__file__).resolve().parent / "build" / "smoke_checkpoints"
#: the posterior phase: Branin T8 N_m=32 (its width and the CampaignConfig
#: sampler defaults are not cut) cut to POSTERIOR_STUDIES x POSTERIOR_EVALS
#: (NUTS: x POSTERIOR_NUTS_EVALS), one campaign a fit method; the
#: sequential driver, 1 study x POSTERIOR_DRIVER_EVALS a method, with its
#: own sampler defaults
POSTERIOR_TASKS, POSTERIOR_POINTS, POSTERIOR_SIGMA = 8, 32, 1.0
POSTERIOR_STUDIES, POSTERIOR_EVALS, POSTERIOR_DRIVER_EVALS = 4, 2, 2
POSTERIOR_NUTS_EVALS = 1
POSTERIOR_METHODS, POSTERIOR_DRIVER_METHODS = ("hmc", "nuts", "vi"), (
    "hmc", "vi")
#: the experiment phase: BRANIN_T8_P32_N1_SCAMLGP (8 meta-tasks x 32
#: points, noise 1.0, not cut) cut to EXPERIMENT_STUDIES x
#: EXPERIMENT_EVALS through ``local_runner.main``, its results under
#: EXPERIMENT_DIR; then two table campaigns of EXPERIMENT_TABLE_STUDIES x
#: EXPERIMENT_TABLE_EVALS: a grid of two ordinal dimensions of GRID_LEVELS
#: levels (G = 1024) with GRID_TASKS x GRID_POINTS meta-data (lr_tabular's
#: width), and PD1's four continuous dimensions with NN_TASKS x NN_POINTS
#: meta-data (pd1's width) and target tables of up to NN_MAX_ROWS rows
EXPERIMENT_KEY = "BRANIN_T8_P32_N1_SCAMLGP"
EXPERIMENT_STUDIES, EXPERIMENT_EVALS = 4, 2
EXPERIMENT_DIR = Path(__file__).resolve().parent / "build" / \
    "smoke_experiments"
#: the JAX package's hashes of configurations/branin.py's experiments
#: (``python -m scamlgp_tpu.benchmarking.configurations.branin hash all``)
BRANIN_HASHES = {
    "BRANIN_T8_P32_N1_SCAMLGP":
        "08334b78e90305aae7f101472a1a2d86cc769da413526a7e268584bc163da9c4",
    "BRANIN_T32_P32_N1_SCAMLGP":
        "6dd8f805b91f5cac81c9ef895ba173f9f4011fb8bcb90a7c258534258e586d34",
}
EXPERIMENT_TABLE_STUDIES, EXPERIMENT_TABLE_EVALS = 8, 2
GRID_LEVELS, GRID_TASKS, GRID_POINTS = 32, 28, 64
NN_TASKS, NN_POINTS, NN_MAX_ROWS = 22, 128, 4096
#: the synthetic tables are drawn from this seed, the studies' targets and
#: meta-data from each study's seed
TABLE_DATA_SEED = 1234
#: the persisted regret curves against the campaign's, float32 rounding
TOL_REGRET = 1e-6
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

#: the sharded phase, its meta-fits SHARD_META_STEPS L-BFGS steps: (a) the
#: many-task regime (BASELINE.json config 4's width, one study) with its
#: task axis over SHARD_TASK_SLOTS slots of the device, its target fit
#: SHARD_TARGET_STEPS Adam steps on SHARD_A's ``target_points`` noisy
#: target observations; (b) the width of BRANIN_T8_P32_N1_SCAMLGP,
#: SHARD_B's studies x evaluations, unsharded, on a (2, 1) mesh and as two
#: gloo ranks (on one card: sharing it), the ranks given SHARD_RANK_TIMEOUT
#: s together; their files go to SHARD_DIR
SHARD_A = dict(tasks=128, points=32, sigma=0.05, target_points=8)
SHARD_B = dict(studies=8, evals=2, tasks=8, points=32, sigma=1.0)
SHARD_TASK_SLOTS, SHARD_TARGET_STEPS, SHARD_RANK_TIMEOUT = 4, 100, 300
#: 12: at 25 steps the phase was the smoke's longest (185 s of a 991 s
#: cold smoke on a slow host)
SHARD_META_STEPS = 12
SHARD_DIR = Path(__file__).resolve().parent / "build" / "smoke_sharded"
#: the task-sharded meta-fit against the one-batch fit on the same
#: restarts: ``meta_fit_split``'s rule and its reasons
SHARD_META_TOL = meta_fit_split.SPLIT_META_TOL
#: the slot-summed normalizer against the unsharded model's
SHARD_NORM_RTOL = 1e-5

# the probes phase: checks at (PROBE_CHECK_B, n, n); the entry points at
# PROBE_SHAPE with PROBE_REPS chained launches (their defaults); the kernels
# timed at PROBE_TIMED (B, N), PROBE_TIMED_REPS launches (the plain versions
# PROBE_PLAIN_REPS); the large-N rows
PROBE_CHECK_B = 256
PROBE_CHECK_NS = (8, 32, 40, 100, 127, 128)
PROBE_SHAPE = (4096, 128)
PROBE_REPS = 30
PROBE_TIMED = ((4096, 128), (1024, 32))
PROBE_TIMED_REPS = 20
PROBE_PLAIN_REPS = 2
LARGE_N_SIZES = (512, 1024, 2048)
#: the Cholesky probe against its panel recurrence and its plain version,
#: in max|L|: the kernel fuses each multiply-subtract and sums in its own
#: order, so it is bit for bit with neither
TOL_PROBE_CHOL = 1e-5
#: the Cholesky probe against torch.linalg.cholesky, relative
TOL_PROBE_LIBRARY = 1e-4
#: the floor against its FMA recurrence, in ulps (expected: bit for bit)
TOL_PROBE_FLOOR_ULPS = 1

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
    probes.reset_kernel_launches()


def launches_now() -> dict:
    """Every kernel's launch count, by name."""
    return {**inverse_mll.kernel_launches(),
            "rbf_gram": gram.rbf_gram.launches,
            **probes.kernel_launches()}


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


#: each slice's inputs, configuration and result, for the device_loop phase
SLICE_RUNS = {}
#: the device_loop phase runs this slice's cell with loop="device"
DEVICE_LOOP_SLICE = "branin_t8_p32"
#: the L-BFGS line search's cap of trips (``models/fit.py``)
LINESEARCH_TRIPS = 20
#: a CUDA graph's kernel nodes of ``select`` (``csrc/sweep_inverse.cu``),
#: and of any hand-written kernel, by (mangled) function name
SELECT_NODE = re.compile(r"(^|\d)sweep_(warp|cta)_kernel")
HAND_NODE = re.compile(r"(^|\d)(sweep|blocked_chol|rbf_gram|baseline)\w*"
                       r"_kernel")


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

    SLICE_RUNS[key] = dict(inputs=(fn, tp, md, optima), cfg=cfg, res=res)
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


def phase_device_loop():
    """The DEVICE_LOOP_SLICE cell through the device loop, held to the
    slice's host-loop run bit for bit; returns its launches of every
    kernel: the counters' (the meta-fit and the warm-up) and, for each
    replay, the kernel nodes of its graph (``select``'s in SELECT_NODE)."""
    t0 = time.perf_counter()
    host = SLICE_RUNS[DEVICE_LOOP_SLICE]
    fn, tp, md, optima = host["inputs"]
    cfg = host["cfg"]
    E = cfg.n_evaluations
    GLOBAL_TIMER.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run_campaign(fn, tp, md, seed=0, cfg=cfg,
                       meta_fit_restarts=META_RESTARTS,
                       meta_fit_steps=META_STEPS, device="cuda",
                       loop="device")
    torch.cuda.synchronize()
    # the meta-fit, the warm-up and the capture (which launches nothing)
    counted = launches_now()
    g = res.graph
    name = "sweep_inverse"
    trips = 1 + cfg.fit_steps * LINESEARCH_TRIPS + 1
    captured = g["launches_per_replay"]
    check(len(g["capture_seconds"]) == 1 and len(res.iteration_seconds) == E,
          f"device_loop: {len(g['capture_seconds'])} graphs, "
          f"{len(res.iteration_seconds)} iterations timed")
    # what a replay launches, read from the graph's own kernel nodes
    nodes = g["kernel_nodes"][0]
    select_nodes = sum(n for k, n in nodes.items() if SELECT_NODE.search(k))
    hand_nodes = {k: n for k, n in nodes.items() if HAND_NODE.search(k)}
    check(select_nodes == trips,
          f"device_loop: the graph holds {select_nodes} {name} kernel "
          f"nodes, not the fixed {trips} trips")
    check(sum(hand_nodes.values()) == select_nodes,
          f"device_loop: the graph holds other hand kernels: {hand_nodes}")
    check(res.launches[name][1] == trips and captured[name] == trips,
          f"device_loop: {name} launched {res.launches[name][1]} times in "
          f"the warm-up and counted {captured[name]} in the capture, not "
          f"the fixed {trips}")
    for other, n in captured.items():
        if other != name:
            check(n == 0, f"device_loop: the capture counted {other}")
    check(counted[name] == sum(res.launches[name][:2]) + captured[name],
          "device_loop: the counters and the result's launches differ")
    eq = compare_runs(host["res"], res)
    check(all(eq[f] for f in ("X", "y", "y_clean")),
          f"device_loop: not the host loop's run bit for bit: {eq}")
    regret = simple_regret(res.y_clean, optima)
    check(bool(torch.isfinite(regret).all()),
          "device_loop: non-finite regret")
    launched = {k: n - captured.get(k, 0) for k, n in counted.items()}
    launched[name] += (E - 1) * select_nodes
    emit("device_loop", time.perf_counter() - t0, slice=DEVICE_LOOP_SLICE,
         studies=md.X.shape[0], evaluations=E, mll_method=cfg.mll_method,
         bit_for_bit=True, vs_host=eq,
         host_iteration_s=host["res"].iteration_seconds,
         device_iteration_s=res.iteration_seconds,
         host_meta_fit_s=host["res"].meta_fit_seconds,
         device_meta_fit_s=res.meta_fit_seconds,
         capture_s=g["capture_seconds"],
         instantiate_s=g["instantiate_seconds"],
         select_nodes_per_replay=select_nodes, replays=E - 1,
         kernel_nodes_s=g["kernel_nodes_seconds"],
         kernel_nodes_per_replay=nodes,
         launches_counted_in_capture=captured, launches=launched,
         trips_per_target_fit_host=host["res"].launches[name][1:],
         trips_per_target_fit_warmup=res.launches[name][1],
         peak_allocated_warmup=g["peak_allocated_warmup"],
         reserved_before_capture=g["reserved_before_capture"],
         reserved_after_capture=g["reserved_after_capture"],
         peak_allocated=g["peak_allocated"], peak_reserved=g["peak_reserved"],
         sync_debug_mode="error",
         median_final_regret=float(regret[:, -1].median()),
         stages=GLOBAL_TIMER.report())
    return launched


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


def compare_runs(a, b) -> dict:
    """Run ``b`` against run ``a`` (each with X, y, y_clean): bit for bit
    per field, the largest proposal difference overall and per iteration,
    and the largest difference of the noise draws (y - y_clean)."""
    out = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
           for f in ("X", "y", "y_clean")}
    out["max_abs_diff_X"] = (a.X - b.X).abs().max().item()
    out["max_abs_diff_X_per_iteration"] = (
        (a.X - b.X).abs().amax(dim=(0, 2)).tolist())
    out["max_abs_diff_noise"] = ((a.y - a.y_clean)
                                 - (b.y - b.y_clean)).abs().max().item()
    return out


def within_chunk_tol(eq: dict, X: torch.Tensor) -> bool:
    """Bit for bit, or, where a batch-size-dependent library operation
    moved a last bit (CHUNK_TOL), the same noise draws and first
    proposals, and proposals in the unit cube throughout."""
    return all(eq[f] for f in ("X", "y", "y_clean")) or (
        eq["max_abs_diff_noise"] <= CHUNK_TOL["noise"]
        and eq["max_abs_diff_X_per_iteration"][0] <= CHUNK_TOL["first_x"]
        and bool(torch.isfinite(X).all())
        and bool(((X >= 0) & (X <= 1)).all()))


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
    equal = {name: compare_runs(a, out[name])
             for name in ("resumed", "chunked")}
    check(all(equal["resumed"][f] for f in ("X", "y", "y_clean")),
          "campaign_resume: the resumed run differs from the uninterrupted "
          f"one: {equal['resumed']}")
    check(within_chunk_tol(equal["chunked"], out["chunked"].X),
          f"campaign_resume: the chunked run differs from the "
          f"uninterrupted one beyond {CHUNK_TOL}: {equal['chunked']}")
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


class TablePool(Benchmark):
    """What the smoke's synthetic tables share: a pool of ``n_pool`` tasks
    from which the study seed draws the target task and, without
    replacement, one meta-task per entry of ``n_data_per_task``, as
    ``HPOBenchTabular`` and ``PD1`` do."""

    def _draw_tasks(self, n_pool, n_data_per_task, seed):
        self._n_data = list(n_data_per_task)
        prng = np.random.default_rng(seed)
        pool = list(range(n_pool))
        target = int(prng.choice(pool))
        pool.remove(target)
        meta = prng.choice(pool, size=len(self._n_data), replace=False)
        self._target = Task(uid=target, descriptors={}, settings={},
                            context={})
        self._meta = {int(t): Task(uid=int(t), descriptors={}, settings={},
                                   context={}) for t in meta}

    @property
    def target_task(self):
        return self._target

    @property
    def meta_tasks(self):
        return self._meta

    @property
    def search_space(self):
        return self._space

    @property
    def output_dimensions(self):
        return 1


class GridTable(TablePool):
    """A synthetic grid-table benchmark at ``lr_tabular``'s shape: two
    ordinal dimensions of ``GRID_LEVELS`` levels, one value a grid cell,
    in a pool of ``GRID_TASKS + 4`` tasks whose tables (shifted, scaled
    quadratic bowls plus noise) come from ``TABLE_DATA_SEED``; evaluation
    is a table lookup."""

    objectives = [Objective("loss", greater_is_better=False)]

    def __init__(self, n_data_per_task=(), seed=None):
        levels = np.linspace(-6.0, 0.0, GRID_LEVELS)
        self._space = ParameterSpace()
        for name in ("log_lr", "log_wd"):
            self._space.add(OrdinalParameter(name, [float(v)
                                                    for v in levels]))
        rng = np.random.default_rng(TABLE_DATA_SEED)
        n_pool = GRID_TASKS + 4
        u = (np.arange(GRID_LEVELS) + 0.5) / GRID_LEVELS
        c = rng.uniform(0.2, 0.8, size=(n_pool, 2, 1, 1))
        bowl = ((u[:, None] - c[:, 0]) ** 2 + (u[None, :] - c[:, 1]) ** 2)
        tables = (0.05 + rng.uniform(0.5, 2.0, size=(n_pool, 1, 1)) * bowl
                  + 0.01 * rng.standard_normal(bowl.shape))
        self._tables = tables.reshape(n_pool, -1)
        self._draw_tasks(n_pool, n_data_per_task, seed)

    @property
    def optimum(self) -> float:
        return float(self._tables[self._target.uid].min())

    def _value(self, config, task) -> float:
        i, j = (p.values.index(config[p.name]) for p in self._space._params)
        return float(self._tables[task, i * GRID_LEVELS + j])

    def __call__(self, eval_spec, task_uid=None):
        task = self._target.uid if task_uid is None else task_uid
        return eval_spec.create_evaluation(
            {"loss": self._value(eval_spec.configuration, task)})

    def get_meta_data(self, distribution="random", seed=None):
        rng = np.random.default_rng(seed)
        out = {}
        for uid, n in zip(self._meta, self._n_data):
            configs = [self._space.sample(rng) for _ in range(n)]
            out[uid] = [Evaluation(configuration=c,
                                   objectives={"loss": self._value(c, uid)})
                        for c in configs]
        return out


#: PD1's search space (``benchmarks/pd1.py``)
NN_BOUNDS = {"decay_steps_factor": (0.01, 0.99),
             "initial_value": (float(np.log(1e-5)), float(np.log(10))),
             "power": (0.1, 2.0),
             "momentum": (float(np.log(1e-3)), 0.0)}


class NNTable(TablePool):
    """A synthetic PD1-like benchmark: PD1's four plain continuous
    dimensions, a pool of ``NN_TASKS + 4`` tasks of 1024 to
    ``NN_MAX_ROWS`` rows each (so the studies' padded target tables differ
    in length), drawn from ``TABLE_DATA_SEED``; evaluation is PD1's L1
    nearest-neighbour lookup, in float64 on the host, and ``task_rows``
    hands a task's rows on as ``PD1.task_rows`` does."""

    objectives = [Objective("best_valid/error_rate", greater_is_better=False)]

    def __init__(self, n_data_per_task=(), seed=None):
        self._space = ParameterSpace()
        for name, bounds in NN_BOUNDS.items():
            self._space.add(ContinuousParameter(name, bounds))
        lo = np.array([b[0] for b in NN_BOUNDS.values()])
        hi = np.array([b[1] for b in NN_BOUNDS.values()])
        rng = np.random.default_rng(TABLE_DATA_SEED)
        n_pool = NN_TASKS + 4
        self._rows = []
        for _ in range(n_pool):
            r = int(rng.integers(1024, NN_MAX_ROWS + 1))
            u = rng.uniform(size=(r, 4))
            c = rng.uniform(0.2, 0.8, size=4)
            v = 0.05 + 0.9 * np.tanh(((u - c) ** 2).sum(-1)) \
                + 0.01 * rng.uniform(size=r)
            self._rows.append((lo + (hi - lo) * u, v))
        self._draw_tasks(n_pool, n_data_per_task, seed)

    @property
    def optimum(self) -> float:
        return float(self._rows[self._target.uid][1].min())

    def task_rows(self, task_uid=None):
        return self._rows[self._target.uid if task_uid is None
                          else task_uid]

    def distances(self, config, task_uid=None) -> np.ndarray:
        """Float64 L1 distances of ``config`` to the task's rows."""
        coords, _ = self.task_rows(task_uid)
        x = np.array([config[n] for n in NN_BOUNDS])
        return np.abs(coords - x).sum(-1)

    def __call__(self, eval_spec, task_uid=None):
        _, values = self.task_rows(task_uid)
        i = int(np.argmin(self.distances(eval_spec.configuration, task_uid)))
        return eval_spec.create_evaluation(
            {self.objectives[0].name: float(values[i])})

    def get_meta_data(self, distribution="random", seed=None):
        rng = np.random.default_rng(seed)
        out = {}
        for uid, n in zip(self._meta, self._n_data):
            coords, values = self._rows[uid]
            rows = rng.choice(len(values), size=n, replace=False)
            out[uid] = [Evaluation(
                configuration=dict(zip(NN_BOUNDS, coords[r].tolist())),
                objectives={self.objectives[0].name: float(values[r])})
                for r in rows]
        return out


def table_campaign(name, build, factory, device):
    """One table campaign of EXPERIMENT_TABLE_STUDIES x
    EXPERIMENT_TABLE_EVALS through ``build`` (a ``tabular_adapters``
    input function) and ``run_campaign`` on ``device``; returns its result, its
    proposals as a numpy array and the line's entries."""
    seeds = list(range(EXPERIMENT_TABLE_STUDIES))
    t0 = time.perf_counter()
    fn, tp, md, optima = build(factory, seeds, device=device)
    sync(device)
    setup_s = time.perf_counter() - t0
    cfg = CampaignConfig(n_evaluations=EXPERIMENT_TABLE_EVALS,
                         noise_std=0.0)
    t0 = time.perf_counter()
    res = run_campaign(fn, tp, md, seed=0, cfg=cfg, device=device)
    sync(device)
    X = res.X.detach().cpu().numpy()
    check(res.X.shape == (len(seeds), EXPERIMENT_TABLE_EVALS, md.X.shape[-1])
          and bool(torch.isfinite(res.X).all())
          and bool(((res.X >= 0) & (res.X <= 1)).all())
          and bool(torch.equal(res.y, res.y_clean)),
          f"experiment {name}: proposals out of the cube or noisy losses")
    regret = simple_regret(res.y_clean, torch.as_tensor(optima))
    check(bool((regret >= 0).all()),
          f"experiment {name}: an observation beat its table's optimum")
    line = {"table": name, "studies": len(seeds),
            "evaluations": EXPERIMENT_TABLE_EVALS,
            "meta_tasks": md.X.shape[1], "meta_points": md.X.shape[2],
            "d": md.X.shape[-1], "seconds": time.perf_counter() - t0,
            "setup_s": setup_s, "meta_fit_s": res.meta_fit_seconds,
            "iteration_s": res.iteration_seconds,
            "task_params_shapes": {k: list(v.shape) for k, v in tp.items()},
            "table_bytes_on_device": sum(v.numel() * v.element_size()
                                         for v in tp.values()),
            "nonfinite_source_tasks": res.nonfinite_source_tasks,
            "median_regret": [float(v) for v in
                              regret.median(dim=0).values]}
    return res, X, line


def phase_experiment(device="cuda"):
    """The experiment layer on the card: ``submit`` of a cut Branin
    experiment through ``local_runner.main`` (routed, persisted, read
    back, its hashes printed), then the grid-table and NN-table
    campaigns; returns the phase's launches of every kernel."""
    t0 = time.perf_counter()
    reset_launches()
    module = "scamlgp_tpu_torch.benchmarking.configurations.branin"
    experiments = branin_experiments.EXPERIMENTS
    config = dataclasses.replace(experiments[EXPERIMENT_KEY],
                                 n_studies=EXPERIMENT_STUDIES,
                                 n_evaluations=EXPERIMENT_EVALS)
    shutil.rmtree(EXPERIMENT_DIR, ignore_errors=True)
    messages = []

    class Record(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    campaigns, entered = [], []
    real = local_runner.run_campaign

    def recording(*args, **kw):
        entered.append(time.perf_counter())
        campaigns.append(real(*args, **kw))
        return campaigns[-1]

    handler = Record(level=logging.WARNING)
    runner_log = logging.getLogger("scamlgp_tpu_torch.runner")
    runner_log.addHandler(handler)
    local_runner.run_campaign = recording
    try:
        ts = time.perf_counter()
        out_dir = local_runner.main(config, module, EXPERIMENT_KEY, 1,
                                    output_root=EXPERIMENT_DIR,
                                    device=device)
        sync(device)
        submit_s = time.perf_counter() - ts
    finally:
        local_runner.run_campaign = real
        runner_log.removeHandler(handler)
    check(any("lock-step campaign" in m for m in messages)
          and len(campaigns) == 1,
          f"experiment submit: not routed through the campaign: {messages}")
    res = campaigns[0]
    loaded = experiment_utils.load_results_from_disk(
        {EXPERIMENT_KEY: config}, module, EXPERIMENT_DIR)
    studies = sorted(loaded.get(EXPERIMENT_KEY, {}).get("studies", []),
                     key=lambda st: st["seed"])
    check([st["seed"] for st in studies] == list(range(EXPERIMENT_STUDIES)),
          f"experiment submit: read back {len(studies)} studies from "
          f"{out_dir}")
    persisted = _regret_curves(studies)
    optima = torch.tensor([st["optimum"] for st in studies],
                          dtype=res.y_clean.dtype, device=res.y_clean.device)
    campaign = simple_regret(res.y_clean, optima).double().cpu().numpy()
    regret_diff = float(np.abs(persisted - campaign).max())
    scale = 1.0 + float(np.abs(res.y_clean.double().cpu().numpy()).max())
    check(persisted.shape == (EXPERIMENT_STUDIES, EXPERIMENT_EVALS)
          and regret_diff <= TOL_REGRET * scale,
          f"experiment submit: persisted regret {persisted.shape} lies "
          f"{regret_diff} from the campaign's")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        experiment_utils.run_experiment_cli(module, experiments,
                                            lambda results: None,
                                            ["hash", "all"])
    hashes = {key: h for h, key in
              (line.split() for line in printed.getvalue().splitlines()[1:])}
    check(hashes == BRANIN_HASHES,
          f"experiment hash: printed {hashes}, not {BRANIN_HASHES}")
    submit = {"experiment": EXPERIMENT_KEY, "studies": EXPERIMENT_STUDIES,
              "evaluations": EXPERIMENT_EVALS, "seconds": submit_s,
              "setup_s": entered[0] - ts,
              "meta_fit_s": res.meta_fit_seconds,
              "iteration_s": res.iteration_seconds,
              "route": [m for m in messages if "submit" in m],
              "results_dir": str(out_dir.relative_to(EXPERIMENT_DIR)),
              "max_abs_regret_diff": regret_diff,
              "median_regret": [float(v) for v in
                                np.median(persisted, axis=0)],
              "hashes_equal_jax": True}

    # the grid table: every proposal's device value is the benchmark's own
    # host lookup of from_numerical(x), exactly (float32 of the table)
    def grid(seed):
        return GridTable([GRID_POINTS] * GRID_TASKS, seed=seed)

    gres, X, grid_line = table_campaign(
        "grid", tabular_adapters.campaign_inputs_from_grid_tabular, grid,
        device)
    y = gres.y_clean.cpu().numpy()
    for s in range(X.shape[0]):
        b = grid(s)
        for e in range(X.shape[1]):
            cfg = b.search_space.from_numerical(X[s, e].astype(np.float64))
            host = b(EvaluationSpecification(configuration=cfg))
            check(np.float32(host.objectives["loss"]) == y[s, e],
                  f"experiment grid: study {s} evaluation {e}: device "
                  f"{y[s, e]} against the host lookup "
                  f"{host.objectives['loss']}")

    # the NN table: the device's row is the host's float64 L1 argmin, or
    # (float32 against float64 distances) a row as near to float32
    # rounding
    def nn(seed):
        return NNTable([NN_POINTS] * NN_TASKS, seed=seed)

    nres, X, nn_line = table_campaign(
        "nn", tabular_adapters.campaign_inputs_from_pd1, nn, device)
    y = nres.y_clean.cpu().numpy()
    exact = 0
    for s in range(X.shape[0]):
        b = nn(s)
        _, values = b.task_rows()
        for e in range(X.shape[1]):
            cfg = b.search_space.from_numerical(X[s, e].astype(np.float64))
            dist = b.distances(cfg)
            host = b(EvaluationSpecification(configuration=cfg))
            name = b.objectives[0].name
            if np.float32(host.objectives[name]) == y[s, e]:
                exact += 1
                continue
            same = dist[values.astype(np.float32) == y[s, e]]
            check(same.size and same.min() <= dist.min() * (1 + 1e-5)
                  + 1e-6, f"experiment nn: study {s} evaluation {e}: "
                  f"device {y[s, e]}, host L1 argmin "
                  f"{host.objectives[name]}")
    nn_line["host_argmin_exact"] = [exact, X.shape[0] * X.shape[1]]
    launches = launches_now()
    emit("experiment", time.perf_counter() - t0, submit=submit,
         tables=[grid_line, nn_line], launches=launches)
    return launches


def peak_memory(device):
    return (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else None)


def reset_peak_memory(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def worker_args():
    """The sharded phase's study-sharded campaign as the worker's
    arguments: Branin at SHARD_B's width, the CampaignConfig defaults,
    ``mll_method="sweep"``, META_RESTARTS restarts of SHARD_META_STEPS
    steps."""
    b = SHARD_B
    return ["--benchmark", "Branin", "--studies", str(b["studies"]),
            "--evals", str(b["evals"]), "--tasks", str(b["tasks"]),
            "--points", str(b["points"]), "--sigma", str(b["sigma"]),
            "--fit-steps", str(CampaignConfig().fit_steps),
            "--meta-fit-steps", str(SHARD_META_STEPS),
            "--meta-fit-restarts", str(META_RESTARTS),
            "--mll-method", "sweep"]


def launch_ranks(device, inputs: Path, outs) -> list:
    """The study-sharded campaign as ``len(outs)`` gloo ranks of
    ``distributed_worker`` sharing ``device``, on a free port; waits at most
    SHARD_RANK_TIMEOUT s and fails, every rank stopped, if a rank fails or
    runs out of time.  Returns each rank's JSON line."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "scamlgp_tpu_torch.distributed_worker",
         "--process-id", str(rank), "--num-processes", str(len(outs)),
         "--coordinator", f"127.0.0.1:{port}", "--device", str(device),
         "--inputs", str(inputs), "--out", str(out)] + worker_args(),
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank, out in enumerate(outs)]
    logs, deadline = [], time.monotonic() + SHARD_RANK_TIMEOUT
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
            except subprocess.TimeoutExpired:
                check(False, f"sharded: a rank ran past "
                      f"{SHARD_RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0,
              f"sharded: rank {rank} exited {p.returncode}:\n{log[-3000:]}")
    return [json.loads([line for line in log.splitlines()
                        if line.startswith("{")][-1]) for log in logs]


def phase_sharded(device="cuda"):
    """Task- and study-sharded ScaML-GP over slots on one device; returns
    the phase's launches of every kernel, the ranks' included."""
    t0 = time.perf_counter()
    reset_launches()
    scfg, tcfg = gp.source_gp_config(), gp.target_gp_config()
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)

    # (a) the many-task regime, the task axis over SHARD_TASK_SLOTS slots
    a = SHARD_A
    ta = time.perf_counter()
    reset_peak_memory(device)
    fn, tp, md, _ = campaign_inputs_from_benchmark(
        Quadratic, [a["points"]] * a["tasks"], [0], noise_std=a["sigma"],
        dtype=torch.float32, device=device)
    data = model_lib.TaskData(*[leaf[0] for leaf in md])
    mesh = make_mesh(study=1, task=SHARD_TASK_SLOTS,
                     devices=local_slots(device, SHARD_TASK_SLOTS),
                     at_once=True)
    M, _, d = data.X.shape
    warm = gp.init_params(scfg, d, torch.float32, batch_shape=(M,))
    draws = gp.sample_params(scfg, torch.Generator().manual_seed(0), d,
                             torch.float32, batch_shape=(M, META_RESTARTS))
    init = fit_lib.stack_restarts(warm, draws, batch_ndim=1)
    tf = time.perf_counter()
    single = model_lib.meta_fit_task_stack(
        data, scfg, num_steps=SHARD_META_STEPS, mll_method="sweep",
        init_stack=fit_lib.tree_map(lambda leaf: leaf.to(device), init))
    sync(device)
    single_s = time.perf_counter() - tf
    tf = time.perf_counter()
    sharded = scamlgp_sharded.meta_fit_sharded(
        data, scfg, None, mesh, num_steps=SHARD_META_STEPS,
        mll_method="sweep", init_stack=init)
    sync(device)
    sharded_s = time.perf_counter() - tf
    # the slots in turn, each its tasks fitted alone: the slots at once
    # give their bits
    tf = time.perf_counter()
    in_turn = scamlgp_sharded.meta_fit_sharded(
        data, scfg, None, Mesh(mesh.devices), num_steps=SHARD_META_STEPS,
        mll_method="sweep", init_stack=init)
    sync(device)
    in_turn_s = time.perf_counter() - tf
    check(all(torch.equal(x, y) for x, y in zip(
        fit_lib.tree_leaves(in_turn), fit_lib.tree_leaves(sharded))),
          "sharded: the task-sharded meta-fit with its slots at once "
          "differs from its slots in turn")

    def objective(params):
        return meta_fit_split.map_objective64(scfg, params, data)

    sharded_params = fit_lib.tree_map(lambda leaf: leaf[:M], sharded.params)
    o_1, o_s = objective(single.params), objective(sharded_params)
    o_warm = objective(fit_lib.tree_map(lambda leaf: leaf.to(device), warm))
    gaps = (o_s - o_1).abs() / o_1.abs().clamp_min(1.0)
    p90 = torch.quantile(gaps, 0.9).item()
    check(bool(torch.isfinite(gaps).all())
          and gaps.median().item() <= SHARD_META_TOL["median"]
          and p90 <= SHARD_META_TOL["p90"] and bool((o_s <= o_warm).all()),
          f"sharded: the task-sharded meta-fit's MAP objectives lie "
          f"{gaps.median().item()} (median), {p90} (90th percentile) from "
          f"the one-batch fit's (bounds {SHARD_META_TOL}), or above their "
          f"warm start in {int((o_s > o_warm).sum())} tasks")
    worst = torch.argsort(gaps, descending=True)[:4].tolist()
    g = torch.Generator().manual_seed(1)
    f32 = torch.float32
    tX = torch.rand((a["target_points"], d), generator=g, dtype=f32)
    tX = tX.to(device)
    clean = fn(tX, {k: v[0] for k, v in tp.items()})
    ty = clean + a["sigma"] * torch.randn(len(tX), generator=g,
                                          dtype=f32).to(device)
    tmask = torch.ones(len(tX), dtype=f32, device=device)
    state = scamlgp_sharded.build_sharded_target(sharded, scfg, tX, ty,
                                                 tmask, mesh)
    model = model_lib.build_scamlgp(
        fit_lib.tree_map(lambda leaf: leaf[:M], sharded), scfg, tX, ty,
        tmask)
    norm_rel = max(((state.out_mean - model.out_mean).abs()
                    / model.out_mean.abs()).item(),
                   ((state.out_std - model.out_std).abs()
                    / model.out_std.abs()).item())
    check(norm_rel <= SHARD_NORM_RTOL,
          f"sharded: the slot-summed normalizer lies {norm_rel} from the "
          f"unsharded model's (rtol {SHARD_NORM_RTOL})")
    p0 = model_lib.init_target_params(tcfg, len(sharded.alpha), d,
                                      torch.float32, device)
    tf = time.perf_counter()
    fitted = scamlgp_sharded.fit_target_sharded(
        state, tcfg, p0, mesh, num_steps=SHARD_TARGET_STEPS)
    sync(device)
    target_s = time.perf_counter() - tf

    def real(p):
        return model_lib.TargetParams(raw_weights=p.raw_weights[:M], gp=p.gp)

    before = model_lib.scamlgp_map_objective(model, tcfg, real(p0)).item()
    after = model_lib.scamlgp_map_objective(model, tcfg,
                                            real(fitted)).item()
    check(bool(torch.isfinite(fitted.raw_weights).all()) and after < before,
          f"sharded: the task-sharded target fit took the unsharded "
          f"objective from {before} to {after}")
    leg_a = {"seconds": time.perf_counter() - ta,
             "meta_fit_one_batch_s": single_s, "meta_fit_sharded_s": sharded_s,
             "meta_fit_in_turn_s": in_turn_s,
             "at_once_bit_for_bit_in_turn": True,
             "fit_target_sharded_s": target_s,
             "peak_memory_bytes": peak_memory(device),
             "objective_gap_max": gaps.max().item(),
             "objective_gap_median": gaps.median().item(),
             "objective_gap_p90": p90,
             "tasks_gap_over_2e-2": int((gaps > 2e-2).sum()),
             "tasks_sharded_lower_higher": [
                 int((o_s < o_1 - 1e-6 * o_1.abs().clamp_min(1.0)).sum()),
                 int((o_s > o_1 + 1e-6 * o_1.abs().clamp_min(1.0)).sum())],
             "objective_sum_one_batch_sharded": [o_1.sum().item(),
                                                 o_s.sum().item()],
             "tasks_equal_params": int(meta_fit_split.same_params(
                 single.params, sharded_params).sum()),
             # (task, one-batch, sharded, warm-start objective)
             "largest_gaps": [[i, o_1[i].item(), o_s[i].item(),
                               o_warm[i].item()] for i in worst],
             "normalizer_max_rel": norm_rel,
             "target_objective_init_fitted": [before, after],
             "sweep_inverse_launches": launches_now()["sweep_inverse"]}

    # (b) the studies of Branin T8 N_m=32: unsharded, a (2, 1) mesh in this
    # process with its rows at once, two gloo ranks sharing the device
    b = SHARD_B
    _, tp, md, optima = campaign_inputs_from_benchmark(
        Branin, [b["points"]] * b["tasks"], range(b["studies"]),
        noise_std=b["sigma"], dtype=torch.float32, device=device,
        optimum_method="device")
    inputs = SHARD_DIR / "inputs.npz"
    distributed_worker.save_campaign_inputs(inputs, tp, md, optima)
    kw = distributed_worker.campaign_kwargs(
        distributed_worker.build_parser().parse_args(
            ["--process-id", "0", "--num-processes", "1", "--out", "-"]
            + worker_args()))
    fn = distributed_worker.TORCH_FUNCTIONS["Branin"]
    runs, legs = {}, {}
    for name, mesh in (("unsharded", None),
                       ("mesh_2x1", make_mesh(
                           study=2, devices=local_slots(device, 2),
                           at_once=True))):
        tr = time.perf_counter()
        reset_peak_memory(device)
        before = launches_now()["sweep_inverse"]
        runs[name] = run_campaign(fn, tp, md, mesh=mesh, device=device,
                                  **kw)
        sync(device)
        legs[name] = {"seconds": time.perf_counter() - tr,
                      "meta_fit_s": runs[name].meta_fit_seconds,
                      "iteration_s": runs[name].iteration_seconds,
                      "peak_memory_bytes": peak_memory(device),
                      "sweep_inverse_launches":
                          launches_now()["sweep_inverse"] - before,
                      "sweep_inverse_meta_fit":
                          runs[name].launches["sweep_inverse"][0],
                      "sweep_inverse_per_iteration":
                          runs[name].launches["sweep_inverse"][1:]}
    launches = launches_now()
    tr = time.perf_counter()
    outs = [SHARD_DIR / f"rank{r}.npz" for r in range(2)]
    ranks = launch_ranks(device, inputs, outs)
    legs["ranks_2"] = {"seconds": time.perf_counter() - tr, "ranks": ranks}
    for line in ranks:
        for k, n in line["launches"].items():
            launches[k] = launches.get(k, 0) + n
    z = [np.load(p) for p in outs]
    idx = np.concatenate([f["idx"] for f in z])
    check(sorted(idx.tolist()) == list(range(b["studies"])),
          f"sharded: the ranks' rows cover studies {sorted(idx.tolist())}")
    order = np.argsort(idx)
    runs["ranks_2"] = types.SimpleNamespace(**{
        k: torch.as_tensor(np.concatenate([f[k] for f in z])[order],
                           device=device) for k in ("X", "y", "y_clean")})
    ref = runs["unsharded"]
    equal = {}
    # the mesh and the ranks run the same batches: bit for bit with each
    # other; with the unsharded run bit for bit on the card (as measured
    # there), on the CPU as the chunks are (vector tails follow the batch)
    exact = torch.device(device).type == "cuda"
    for name, (first, second) in (("mesh_2x1", ("unsharded", "mesh_2x1")),
                                  ("ranks_2", ("unsharded", "ranks_2")),
                                  ("ranks_vs_mesh", ("mesh_2x1", "ranks_2"))):
        eq = equal[name] = compare_runs(runs[first], runs[second])
        loose = not exact and first == "unsharded"
        check(within_chunk_tol(eq, runs[second].X) if loose
              else all(eq[f] for f in ("X", "y", "y_clean")),
              f"sharded: the {second} run differs from the {first} one"
              f"{f' beyond {CHUNK_TOL}' if loose else ''}: {eq}")
    check(bool(torch.isfinite(ref.X).all())
          and bool(((ref.X >= 0) & (ref.X <= 1)).all())
          and bool(torch.isfinite(ref.y_clean).all()),
          "sharded: proposals or losses out of range")
    check(sum(line["launches"]["sweep_inverse"] for line in ranks) > 0
          or torch.device(device).type != "cuda",
          "sharded: the ranks launched sweep_inverse no time")
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    emit("sharded", time.perf_counter() - t0,
         task_sharded=dict(benchmark="Quadratic", tasks=a["tasks"],
                           points=a["points"], d=1, sigma=a["sigma"],
                           task_slots=SHARD_TASK_SLOTS,
                           target_steps=SHARD_TARGET_STEPS, **leg_a),
         study_sharded=dict(benchmark="Branin", tasks=b["tasks"],
                            points=b["points"], d=2, sigma=b["sigma"],
                            studies=b["studies"], evaluations=b["evals"],
                            legs=legs, equal_to_unsharded=equal,
                            bit_for_bit_required=exact),
         slots_at_once_over_in_turn=sharded_s / in_turn_s,
         launches=launches)
    return launches


def posterior_launches(cfg: CampaignConfig):
    """The ``select`` launches that one iteration of a posterior-fit
    campaign makes, as (least, most): one a log-density evaluation of the
    whole batch.  HMC: the start, then ``hmc_leapfrog`` a transition.
    ADVI: one a step.  NUTS: the start, then a transition's leapfrog steps
    (1 to 2^max_depth - 1, the longest chain's) and the gradient at its
    chosen state."""
    T = cfg.hmc_warmup + cfg.hmc_samples
    if cfg.fit_method == "hmc":
        n = 1 + T * cfg.hmc_leapfrog
        return n, n
    if cfg.fit_method == "vi":
        return cfg.vi_steps, cfg.vi_steps
    return 1 + 2 * T, 1 + T * 2 ** cfg.hmc_max_depth


@contextlib.contextmanager
def plain_sweep():
    """``sweep.sweep_inverse`` replaced by its plain version (on any
    device), so that the route's callers run it instead of the kernel."""
    kernel = sweep.sweep_inverse

    def plain(A, variant="select"):
        return sweep.sweep_inverse_reference(
            A, sweep.resolve_variant(A.shape[-1], variant))

    sweep.sweep_inverse = plain
    try:
        yield
    finally:
        sweep.sweep_inverse = kernel


def log_density_and_grad(res, cfg, draws, dtype, plain=False):
    """The campaign's target log-density and its gradient at the draws
    (S, K, ...) on the campaign's final data, on ``cfg``'s route, with
    every input cast to ``dtype``: ((S, K) values, (S, K, D) gradients)."""
    def cast(tree):
        return fit_lib.tree_map(lambda leaf: leaf.to(dtype), tree)

    stack = cast(res.stack)
    X, y, mask = (t.to(dtype) for t in (res.X, res.y, res.mask))
    out_mean, out_std = model_lib.output_normalizer(stack, y, mask)
    objective = target_objective(stack, gp.source_gp_config(),
                                 gp.target_gp_config(), X, y, mask, out_mean,
                                 out_std, cfg)
    q = fit_lib.flatten(cast(draws), 2).detach().requires_grad_(True)
    with torch.enable_grad(), (plain_sweep() if plain
                               else contextlib.nullcontext()):
        v = -objective(fit_lib.unflatten(q, draws, 2))
        g, = torch.autograd.grad(v.sum(), q)
    return v.detach(), g


def posterior_rounding(res, cfg):
    """The kernel route's float32 log-density and gradient at the
    campaign's mixture draws against the plain version's, each as [max,
    median] over the draws of its distance from float64 (the same
    objective on the Cholesky route, every input promoted): |value error|
    / max(|value|, 1) and max |gradient error| / max(max |gradient|, 1).
    Fails where the kernel is farther than twice the plain version."""
    draws = res.samples
    v64, g64 = log_density_and_grad(
        res, CampaignConfig(fit_method=cfg.fit_method, mll_method="chol"),
        draws, torch.float64)

    def rel(v, g):
        rv = (v.double() - v64).abs() / v64.abs().clamp_min(1.0)
        rg = ((g.double() - g64).abs().amax(-1)
              / g64.abs().amax(-1).clamp_min(1.0))
        return ([rv.max().item(), rv.median().item()],
                [rg.max().item(), rg.median().item()])

    out = {}
    for name, plain in (("kernel", False), ("plain", True)):
        v, g = log_density_and_grad(res, cfg, draws, torch.float32, plain)
        check(bool(torch.isfinite(v).all() and torch.isfinite(g).all()),
              f"posterior rounding: the {name} route is not finite")
        out[name] = dict(zip(("value", "gradient"), rel(v, g)))
    for what in ("value", "gradient"):
        check(out["kernel"][what][0] <= 2.0 * out["plain"][what][0],
              f"posterior rounding: the kernel's {what} is "
              f"{out['kernel'][what][0]} from float64, its plain version's "
              f"{out['plain'][what][0]}")
    out["draws"] = int(v64.numel())
    return out


def phase_posterior(device="cuda"):
    """The HMC, NUTS and ADVI campaigns on Branin T8 N_m=32, the rounding
    guard on the HMC campaign's draws, then the sequential driver with
    HMC and VI; returns the campaigns' launches of every kernel."""
    t0 = time.perf_counter()
    S, E = POSTERIOR_STUDIES, POSTERIOR_EVALS
    fn, tp, md, optima = campaign_inputs_from_benchmark(
        Branin, [POSTERIOR_POINTS] * POSTERIOR_TASKS, range(S),
        noise_std=POSTERIOR_SIGMA, dtype=torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    reset_launches()
    campaigns, kept = [], {}
    for method in POSTERIOR_METHODS:
        E_m = POSTERIOR_NUTS_EVALS if method == "nuts" else E
        cfg = CampaignConfig(n_evaluations=E_m, noise_std=POSTERIOR_SIGMA,
                             mll_method="sweep", fit_method=method)
        tr = time.perf_counter()
        GLOBAL_TIMER.reset()
        res = run_campaign(fn, tp, md, seed=0, cfg=cfg,
                           meta_fit_restarts=META_RESTARTS,
                           meta_fit_steps=META_STEPS, device=device)
        sync(device)
        stages = GLOBAL_TIMER.report()
        kept[method] = (res, cfg)
        lo, hi = posterior_launches(cfg)
        per_iter = res.launches["sweep_inverse"][1:]
        X = res.X
        check(X.shape == (S, E_m, 2) and bool(torch.isfinite(X).all())
              and bool(((X >= 0) & (X <= 1)).all()),
              f"posterior {method}: proposals out of the unit cube")
        check(res.launches["sweep_inverse"][0] > 0,
              f"posterior {method}: the meta-fit launched select no time")
        check(all(lo <= n <= hi for n in per_iter),
              f"posterior {method}: select launches per iteration "
              f"{per_iter}, expected {lo}..{hi}")
        check(all(sum(v[1:]) == 0 for k, v in res.launches.items()
                  if k != "sweep_inverse"),
              f"posterior {method}: another kernel launched: "
              f"{res.launches}")
        check(res.nonfinite_source_tasks == 0,
              f"posterior {method}: a source GP with a non-finite factor")
        regret = simple_regret(res.y_clean, optima)
        check(bool(torch.isfinite(regret).all()),
              f"posterior {method}: non-finite regret")
        sampler = stages.get("iteration_sample_target", {})
        loop = stages.get("campaign_iteration", {})
        campaigns.append({
            "fit_method": method, "evaluations": E_m,
            "seconds": time.perf_counter() - tr,
            "meta_fit_s": res.meta_fit_seconds,
            "iteration_s": res.iteration_seconds,
            "select_launches_meta_fit": res.launches["sweep_inverse"][0],
            "select_launches_per_iteration": per_iter,
            "predicted_per_iteration": [lo, hi],
            "sampler_share": (sampler.get("total_s", 0.0)
                              / max(loop.get("total_s", 0.0), 1e-12)),
            "median_regret": [float(v) for v in regret.median(0).values],
            "stages": stages})
    launches = launches_now()
    res, cfg = kept["hmc"]
    rounded = posterior_rounding(res, cfg)

    drivers = []
    for method in POSTERIOR_DRIVER_METHODS:
        ts = time.perf_counter()
        GLOBAL_TIMER.reset()
        TimedBO.made.clear()
        out = run_study(TimedBO, {"fit_method": method, "device": device},
                        Branin,
                        {"n_data_per_task": [POSTERIOR_POINTS]
                         * POSTERIOR_TASKS}, POSTERIOR_DRIVER_EVALS, 0,
                        HomoscedasticGaussianNoise({"loss": POSTERIOR_SIGMA}))
        sync(device)
        opt = TimedBO.made[0]
        space = opt.search_space
        for e in out["evaluations"]:
            vec = space.to_numerical(e["configuration"])
            check(bool(np.isfinite(vec).all())
                  and bool(((vec >= 0) & (vec <= 1)).all())
                  and space.check_validity(e["configuration"]),
                  f"posterior driver {method}: proposal "
                  f"{e['configuration']}")
        check(opt._hyper_samples is not None,
              f"posterior driver {method}: no mixture draws")
        mean, std = opt.predict([space.from_numerical(v) for v in
                                 sobol_unit(0, 16, len(space)).numpy()])
        check(bool(np.isfinite(mean).all() and np.isfinite(std).all()),
              f"posterior driver {method}: predict is not finite")

        def per_eval(stage):
            tot = [m.get(stage, 0.0) for m in opt.marks]
            return [b - a for a, b in zip(tot, tot[1:])]

        drivers.append({
            "fit_method": method, "seconds": time.perf_counter() - ts,
            "evaluations": POSTERIOR_DRIVER_EVALS,
            "meta_fit_s": opt.marks[0].get("meta_fit", 0.0),
            "refit_s": per_eval("refit"),
            "acquisition_s": per_eval("acquisition"),
            "mixture_draws": int(opt._hyper_samples.raw_weights.shape[0]),
            "regret": [float(v) for v in study_regret(out)]})
    emit("posterior", time.perf_counter() - t0, benchmark="Branin",
         tasks=POSTERIOR_TASKS, points=POSTERIOR_POINTS, d=2,
         sigma=POSTERIOR_SIGMA, studies=S, setup_s=setup_s, campaigns=campaigns, rounding=rounded,
         drivers=drivers, launches=launches)
    return launches


def posterior_times():
    """``select`` timed beside its plain version, the library call and the
    bound at the samplers' batches: this phase's (S x chains and S x ADVI
    draws, E x E) and the validate runs' (16 studies: 32 chains or 128 ADVI
    draws at n = 40; 32 chains at n = 80)."""
    cfg = CampaignConfig()
    rng = np.random.default_rng(5)
    shapes = [(POSTERIOR_STUDIES * cfg.hmc_chains, POSTERIOR_EVALS),
              (POSTERIOR_STUDIES * cfg.vi_mc, POSTERIOR_EVALS),
              (16 * cfg.hmc_chains, 40), (16 * cfg.vi_mc, 40),
              (16 * cfg.hmc_chains, 80)]
    out = []
    for B, n in shapes:
        A = torch.as_tensor(spd_batch(rng, B, n), device="cuda")
        err = check_kernel("sweep_inverse", A, "sampler")
        out.append({**time_kernel("sweep_inverse", A, 200, 20),
                    "max_abs_err": err})
    emit("posterior_times", None, kernel="sweep_inverse", timed=out)
    return out


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


def check_probe_errors(row, where):
    """The phase's checks on a row of ``probe_errors`` (either kernel's
    keys, or both) for B matrices n x n, ``where`` naming the shape."""
    n = row["n"]
    if "chol_max_abs_err" in row:
        scale = row["max_abs_l"]
        for key in ("chol_max_abs_err", "chol_max_abs_err_mirror",
                    "old_chol_max_abs_err"):
            check(row[key] <= TOL_PROBE_CHOL * scale,
                  f"probes {where}: {key} {row[key]} > {TOL_PROBE_CHOL} * "
                  f"{scale}")
        check(row["chol_rel_err_vs_library"] < TOL_PROBE_LIBRARY,
              f"rank1_cholesky {where}: {row['chol_rel_err_vs_library']} "
              "from torch.linalg.cholesky")
        check(row["chol_upper_zero"],
              f"rank1_cholesky {where}: the strict upper triangle is not 0")
    if "floor_max_ulps_fma" in row:
        check(row["floor_max_ulps_fma"] <= TOL_PROBE_FLOOR_ULPS,
              f"traversal_floor {where}: {row['floor_max_ulps_fma']} ulps "
              f"from its FMA recurrence ({row['floor_share_not_bitwise_fma']}"
              " of the elements not bit for bit)")
        # the unfused plain version rounds each step's product apart: one
        # tie a step at most, the first step exact (its addend is 0)
        check(row["floor_max_ulps_plain"] <= n,
              f"traversal_floor {where}: {row['floor_max_ulps_plain']} ulps "
              "from its plain version")
        check(row["old_floor_bitwise_equal"],
              f"the first traversal_floor {where}: not bit for bit with its "
              "plain version")


def check_probes(A, n):
    """The two probe kernels and their first versions on A (PROBE_CHECK_B,
    n, n) against their plain versions and mirrors (``probe_errors``, the
    phase's checks); returns the phase's row."""
    out = {name: (getattr(probes, name)(A), PROBE_BASELINES[name](A))
           for name in probes.KERNELS}
    sync(A.device.type)
    row = dict(n=n, batch=A.shape[0],
               geometry=probes.launch_geometry("rank1_cholesky", A.shape[0],
                                               n)["path"])
    for name, (new, old) in out.items():
        row.update(probe_errors(name, A, new, old))
    check_probe_errors(row, f"n={n}")
    return row


def phase_probes(device="cuda"):
    """The two probe kernels and their first versions against their plain
    versions and mirrors, and their launch geometry; the probes' entry
    points with the launch counts from 0; their times beside their first
    versions at PROBE_TIMED (``probe_row``), checked there as at the
    check shapes; the large-N rows.  Returns each kernel's largest float32
    error against its plain version, its timings at PROBE_TIMED[0] and at
    the other shapes, and the entry points' launches."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    err_key = {"rank1_cholesky": "chol_max_abs_err",
               "traversal_floor": "floor_max_abs_err"}
    max_err = dict.fromkeys(probes.KERNELS, 0.0)
    checks = []
    for n in PROBE_CHECK_NS:
        A = spd_batch(rng, PROBE_CHECK_B, n)
        A = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), device=device)
        row = check_probes(A, n)
        checks.append(row)
        for name, key in err_key.items():
            max_err[name] = max(max_err[name], row[key])
    if device == "cuda":
        # the built kernels' launches: the first versions select's, the new
        # ones launch_geometry's
        for n in range(1, probes.MAX_N + 1):
            want = sweep.launch_geometry(n)
            got = baseline_probe_geometry(n)
            check(got == {k: want[k] for k in got},
                  f"the first probe kernels' geometry at n={n}: {got}")
            for name in probes.KERNELS:
                for B in (PROBE_CHECK_B, *(b for b, _ in PROBE_TIMED)):
                    want = probes.launch_geometry(name, B, n)
                    got = probes.kernel_geometry(name, B, n)
                    check(got == {k: want[k] for k in got},
                          f"{name}'s geometry at ({B}, {n}): {got}")

    # the main path: the probes' entry points, with every count from 0
    reset_launches()
    B, N = PROBE_SHAPE
    chol_line = bench_chol_fused_probe.run(B, N, PROBE_REPS, device)
    floor_line = bench_traversal_floor.run(B, N, PROBE_REPS, device)
    sync(device)
    launches = launches_now()
    for name in probes.KERNELS:
        check(launches[name] > 0,
              f"probes: the entry points launched {name} no time")
    for ratio in (chol_line["chol_over_sweep"],
                  chol_line["chol_over_sweep_alone"],
                  floor_line["sweep_pct_of_ceiling"],
                  floor_line["sweep_pct_of_ceiling_alone"]):
        check(np.isfinite(ratio) and ratio > 0,
              f"probes: a probe's ratio is {ratio}")

    # each kernel at the timed shapes, the entry points' batch: checked
    # against its plain version and mirror there, and timed beside its
    # first version
    timed = {name: {} for name in probes.KERNELS}
    for B, N in PROBE_TIMED:
        A = bench_chol_fused_probe.probe_batch(B, N, device)
        select_ms = time_ms(lambda: sweep.sweep_inverse(A), PROBE_TIMED_REPS)
        for name in probes.KERNELS:
            row = probe_row(name, A, select_ms, PROBE_TIMED_REPS,
                            PROBE_PLAIN_REPS)
            check_probe_errors(row, f"timed ({B}, {N})")
            max_err[name] = max(max_err[name], row["max_abs_err"])
            timed[name][f"{B}x{N}"] = row
        del A
        if device == "cuda":
            torch.cuda.empty_cache()

    large_n = validate_large_n.run(LARGE_N_SIZES, 64, 6, device)
    for row in large_n["rows"]:
        check(row["pass"], f"validate_large_n N={row['N']}: {row}")
    check(max(r["N"] for r in large_n["rows"]) == max(LARGE_N_SIZES),
          "validate_large_n: the largest N did not run")
    emit("probes", time.perf_counter() - t0, checks=checks,
         chol_fused_probe=chol_line, traversal_floor_probe=floor_line,
         timed=timed, large_n=large_n, launches=launches)
    head_key = f"{PROBE_TIMED[0][0]}x{PROBE_TIMED[0][1]}"
    head = {name: t[head_key] for name, t in timed.items()}
    others = {name: {k: v for k, v in t.items() if k != head_key}
              for name, t in timed.items()}
    return max_err, head, others, launches


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
    "rank1_cholesky": ("scamlgp_tpu_torch/csrc/probe_kernels.cu",
                       "scripts/bench_chol_fused_probe.py:49"),
    "traversal_floor": ("scamlgp_tpu_torch/csrc/probe_kernels.cu",
                        "scripts/bench_vpu_ceiling.py:50"),
}


def main():
    card = phase_device()
    phase_build()
    max_err, head, others = phase_kernel()
    head["rbf_gram"], gram_launches = phase_gram()
    max_err["rbf_gram"] = head["rbf_gram"]["max_abs_err"]
    probe_err, probe_head, probe_others, probe_launches = phase_probes()
    max_err.update(probe_err)
    head.update(probe_head)
    others.update(probe_others)
    by_slice = {key: phase_slice(key) for key in SLICES}
    by_slice["probes"] = probe_launches
    by_slice["device_loop"] = phase_device_loop()
    by_slice["campaign_resume"] = phase_campaign_resume()
    by_slice["posterior"] = phase_posterior()
    by_slice["experiment"] = phase_experiment()
    by_slice["sharded"] = phase_sharded()
    sampler_times = posterior_times()
    by_slice["bench_sweep_n"] = phase_bench()
    by_slice["driver"] = phase_driver()
    # each kernel's launches in the slice (or the bench) whose main path
    # carries it
    carrier = {name: key for key, sl in SLICES.items()
               for name in sl["kernels"]}
    carrier.update(sweep_inverse_pair="bench_sweep_n",
                   sweep_inverse_blocked="bench_sweep_n",
                   rank1_cholesky="probes", traversal_floor="probes")
    launches = {name: by_slice[key][name] for name, key in carrier.items()}
    # no path launches the Gram kernel: its count is the gram phase's
    launches["rbf_gram"] = gram_launches
    kernels = []
    for name in (*KERNELS, "rbf_gram", *probes.KERNELS):
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
            # time of a call, and the first kernel through its wrapper; the
            # probes: select timed in turns with them at the same shape,
            # and each alone beside its first version
            **{k: head[name][k] for k in ("ms_kernel", "host_ms",
                                          "old_call_ms", "rbf_eager_ms",
                                          "select_ms", "ms_alone",
                                          "old_ms_alone")
               if k in head[name]},
            # the kernel's times at its other timed shapes (select at the
            # hm6 p128 meta-fit's and the bench's N = 128, global at the
            # smem variant's shape, the probes at (1024, 32, 32))
            "other_shapes": others.get(name, {}),
        })
    # select at the posterior samplers' batches
    next(k for k in kernels if k["name"] == "sweep_inverse")[
        "sampler_shapes"] = sampler_times
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
