"""The chip smoke's float32 rounding guard, its ``chol64`` entry, its
``campaign_resume``, ``posterior`` and ``probes`` phases, on CPU tensors.

``chip_smoke.rounding`` holds each kernel of a slice's route to at most
twice its plain version's distance from float64 on the slice's own
systems; ``chip_smoke.inverse_schemes`` names those kernels.  Here the
plain versions stand in for the kernels (the CUDA kernels have no CPU
mode), so the guard's comparison and its failure, the ``chol64`` entry and
the resume phase's runs and checks and the posterior phase's launch
arithmetic are exercised without a card.
"""

import functools
import json
import time

import numpy as np
import pytest
import torch

import chip_smoke
from scamlgp_tpu_torch import profile_kernels
from scamlgp_tpu_torch.benchmarking import local_runner
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import blocked_chol, cuda_build, linalg, probes
from scamlgp_tpu_torch.ops import sweep
from scamlgp_tpu_torch.parallel import campaign

from tests.torch_threads import one_thread  # noqa: F401


def _systems(n, b=6, seed=0):
    """Nearly singular float32 SPD systems (an RBF Gram of close points plus
    a small noise), their targets and active counts, and the float64
    truth of their MLL."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(b, n, 2))
    d2 = ((X[:, :, None, :] - X[:, None, :, :]) ** 2).sum(-1)
    A = np.exp(-0.5 * d2 / 0.3 ** 2) + 1e-2 * np.eye(n)
    y = rng.normal(size=(b, n))
    A32 = torch.as_tensor(A, dtype=torch.float32)
    y32 = torch.as_tensor(y, dtype=torch.float32)
    na = torch.full((b,), float(n))
    truth = chip_smoke.mll_plain(A32.double(), y32.double(), na.double())
    return A32, y32, na, truth


@pytest.mark.parametrize("n,route_blocked,names", [
    (33, False, ["select", "fused"]),
    (64, False, ["select", "fused", "pair", "blocked"]),
    (256, True, ["smem"]),
    (320, True, ["global"]),
    (512, True, ["global"]),
    (256, False, []),
])
def test_inverse_schemes_follow_the_route(n, route_blocked, names):
    """The sweep schemes that N allows, or the blocked variant that the
    route picks (float32: ``smem`` at N = 256, ``global`` from N = 320);
    no inverse kernel off both routes."""
    assert [s[0] for s in chip_smoke.inverse_schemes(
        n, route_blocked)] == names


@pytest.mark.parametrize("n,itemsize,variant", [
    (256, 4, "smem"), (320, 4, "global"), (512, 4, "global"),
    (1024, 4, "global"), (192, 8, "smem"), (256, 8, "global"),
    (704, 8, "global")])
def test_blocked_route_picks_the_variant(n, itemsize, variant):
    """The blocked route's variant at the sizes the campaign cells use:
    ``global`` takes float32 N >= 320 and float64 N >= 256."""
    assert blocked_chol.blocked_profitable(n, itemsize, True)
    assert blocked_chol.choose_variant(n, itemsize) == variant


@pytest.mark.parametrize("n,route_blocked", [(40, False), (256, True)])
def test_rounding_guard_passes_the_plain_versions(n, route_blocked):
    """With each plain version standing in for its kernel, every scheme
    lies exactly as far from float64 as itself, and the guard passes."""
    A, y, na, truth = _systems(n)
    schemes = [(name, plain, plain) for name, _, plain in
               chip_smoke.inverse_schemes(n, route_blocked)]
    out = chip_smoke.rounding(A, y, na, truth, "cpu", schemes)
    assert list(out) == [s[0] for s in schemes]
    for name, r in out.items():
        assert r["kernel"] == r["plain"]
        assert 0.0 < r["plain"][1] <= r["plain"][0] < 1e-2


def test_rounding_guard_fails_a_kernel_twice_as_far():
    """A stand-in kernel whose log-determinant moves its MLL by 4x the plain
    version's largest error fails the guard; one within it passes."""
    n = 40
    A, y, na, truth = _systems(n)
    plain = lambda M: sweep.sweep_inverse_reference(M, "select")  # noqa
    ref = chip_smoke.mll_of(*plain(A), y, na)
    worst = ((ref.double() - truth).abs()
             / truth.abs().clamp_min(1.0)).max().item()
    scale = truth.abs().clamp_min(1.0).float()

    def off_by(factor):
        def kernel(M):
            inv, ld = plain(M)
            # the MLL moves by -ld / 2: shift it by factor x worst
            return inv, ld - 2.0 * factor * worst * scale
        return kernel

    ok = chip_smoke.rounding(A, y, na, truth, "cpu",
                             [("select", off_by(0.5), plain)])
    assert ok["select"]["kernel"][0] <= 2.0 * ok["select"]["plain"][0]
    with pytest.raises(SystemExit):
        chip_smoke.rounding(A, y, na, truth, "cpu",
                            [("select", off_by(4.0), plain)])


def test_chol64_entry_on_nearly_singular_systems():
    """The p256 slice's ``chol64`` entry on small nearly singular float32
    inputs: ``chol64`` lies within the cast of the MLL computed wholly in
    float64, and the entry reports the other routes' distances from it."""
    rng = np.random.default_rng(3)
    b, n = 4, 48
    X = torch.as_tensor(rng.uniform(size=(b, n, 2)) * 0.2, dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(b, n)), dtype=torch.float32)
    mask = torch.ones((b, n))
    mask[:, -3:] = 0.0
    scfg = gp.source_gp_config()
    c = gp.constrain(scfg, gp.init_params(scfg, 2, torch.float32,
                                          batch_shape=(b,)))
    A = linalg.mask_system(gp.gram(scfg, c, X), c.noise, mask)
    na = mask.sum(-1)
    kern = chip_smoke.mll_plain(A, y * mask, na)
    truth = chip_smoke.mll_plain(A.double(), (y * mask).double(), na.double())
    out = chip_smoke.chol64_entry("cpu", scfg, X, y, mask, kern, truth)
    assert out["chol64_dtype"] == "torch.float32"
    assert 0.0 <= out["chol64_vs_f64"][0] <= chip_smoke.TOL_CHOL64
    for k in ("kernel_vs_f64_assembled",
              "f32_systems_in_f64_vs_f64_assembled"):
        assert 0.0 < out[k][1] <= out[k][0] < 1e-2


def _small_resume_phase(monkeypatch, tmp_path):
    """The campaign_resume phase's constants at a CPU size, and a counting
    wrapper around the plain sweep in place of the kernel."""
    plain = sweep.sweep_inverse_reference

    def counted(A, variant="select"):
        counted.launches[variant] += 1
        return plain(A, variant)

    counted.launches = sweep.sweep_inverse.launches
    monkeypatch.setattr(sweep, "sweep_inverse", counted)
    small = functools.partial(chip_smoke.CampaignConfig, fit_steps=8,
                              fit_restarts=1, acq_raw_samples=16, acq_topk=2,
                              acq_steps=4)
    for name, value in (("RESUME_TASKS", 2), ("RESUME_POINTS", 8),
                        ("META_RESTARTS", 1), ("META_STEPS", 6),
                        ("RESUME_DIR", tmp_path / "ck"),
                        ("CampaignConfig", small)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_campaign_resume_phase_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The campaign_resume phase at a small size, its plain versions
    standing in for the kernels through a counting wrapper: the stopped
    run completes RESUME_STOP iterations, the resumed and the chunked runs
    equal the uninterrupted one bit for bit, and the line carries each
    run's seconds and launches."""
    _small_resume_phase(monkeypatch, tmp_path)
    launches = chip_smoke.phase_campaign_resume("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "campaign_resume"
    assert [r["run"] for r in line["runs"]] == [
        "uninterrupted", "stopped", "resumed", "chunked"]
    E, stop = chip_smoke.RESUME_EVALS, chip_smoke.RESUME_STOP
    assert [r["completed"] for r in line["runs"]] == [E, stop, E, E]
    # the chunked run: two chunks of E iterations each
    assert [len(r["iteration_s"]) for r in line["runs"]] == [
        E, stop, E - stop, 2 * E]
    for name in ("resumed", "chunked"):
        eq = line["equal_to_uninterrupted"][name]
        assert eq["X"] and eq["y"] and eq["y_clean"]
        assert eq["max_abs_diff_X"] == 0.0
    assert launches["sweep_inverse"] == sum(
        r["sweep_inverse_launches"] for r in line["runs"]) > 0
    assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("shift_x,shift_y,passes", [
    (1e-4, 0.0, True),     # later proposals moved: within CHUNK_TOL
    (0.0, 1e-2, False),    # another study's noise: beyond it
])
def test_chunked_run_held_to_its_tolerance(monkeypatch, tmp_path, shift_x,
                                           shift_y, passes):
    """Where the chunked run is not bit for bit, it passes with the same
    noise draws and first proposals, and fails otherwise."""
    _small_resume_phase(monkeypatch, tmp_path)
    run = chip_smoke.run_campaign

    def perturbed(*args, **kw):
        res = run(*args, **kw)
        if kw.get("study_chunk"):
            X = res.X.clone()
            X[:, 1:] = (X[:, 1:] + shift_x).clamp(0.0, 1.0)
            res = res._replace(X=X, y=res.y + shift_y)
        return res

    monkeypatch.setattr(chip_smoke, "run_campaign", perturbed)
    if passes:
        chip_smoke.phase_campaign_resume("cpu")
    else:
        with pytest.raises(SystemExit):
            chip_smoke.phase_campaign_resume("cpu")


def _small_posterior_phase(monkeypatch):
    """The posterior phase's constants at a CPU size (Branin 2 tasks x 6
    points, 2 studies x 2 evaluations, NUTS 1, small samplers, and a
    driver class that adds small settings to the phase's arguments), and
    a counting wrapper around the plain sweep in place of the kernel."""
    plain = sweep.sweep_inverse_reference

    def counted(A, variant="select"):
        counted.launches[variant] += 1
        return plain(A, variant)

    counted.launches = sweep.sweep_inverse.launches
    monkeypatch.setattr(sweep, "sweep_inverse", counted)
    small = functools.partial(
        chip_smoke.CampaignConfig, fit_steps=6, fit_restarts=1,
        acq_raw_samples=16, acq_topk=2, acq_steps=3, hmc_warmup=4,
        hmc_samples=3, hmc_leapfrog=3, hmc_max_depth=3, mixture_samples=4,
        vi_steps=6, vi_mc=3)
    driver = {"hmc_kwargs": {"num_warmup": 4, "num_samples": 3,
                             "num_leapfrog": 3, "mixture_samples": 4},
              "vi_kwargs": {"num_steps": 6, "num_mc": 3,
                            "mixture_samples": 4},
              "num_restarts_log_likelihood": 1, "num_fit_steps": 8,
              "af_optimizer_kwargs": {"raw_samples": 16, "num_restarts": 2,
                                      "num_steps": 3}}

    class SmallBO(chip_smoke.TimedBO):
        def __init__(self, search_space, objective, meta_data, **kwargs):
            super().__init__(search_space, objective, meta_data,
                             **{**driver, **kwargs})

    for name, value in (("POSTERIOR_TASKS", 2), ("POSTERIOR_POINTS", 6),
                        ("POSTERIOR_STUDIES", 2), ("POSTERIOR_EVALS", 2),
                        ("POSTERIOR_DRIVER_EVALS", 2), ("META_RESTARTS", 1),
                        ("META_STEPS", 6), ("TimedBO", SmallBO),
                        ("CampaignConfig", small)):
        monkeypatch.setattr(chip_smoke, name, value)
    return small


def test_posterior_launch_arithmetic():
    """One select launch a log-density evaluation of the whole batch: HMC
    961 an iteration at the CampaignConfig defaults, ADVI 200, NUTS 161 to
    5121."""
    cfg = chip_smoke.CampaignConfig
    assert chip_smoke.posterior_launches(cfg(fit_method="hmc")) == (961, 961)
    assert chip_smoke.posterior_launches(cfg(fit_method="vi")) == (200, 200)
    assert chip_smoke.posterior_launches(cfg(fit_method="nuts")) == (161,
                                                                      5121)


def test_posterior_phase_on_the_cpu(monkeypatch, capsys, one_thread):
    """The posterior phase at a small size, its plain version standing in
    for the kernel through a counting wrapper: each campaign's launches
    per iteration are the design's, the rounding guard compares the route
    with itself, and both sequential drivers run."""
    small = _small_posterior_phase(monkeypatch)
    launches = chip_smoke.phase_posterior("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "posterior"
    runs = {c["fit_method"]: c for c in line["campaigns"]}
    assert list(runs) == ["hmc", "nuts", "vi"]
    T = 4 + 3
    assert runs["hmc"]["select_launches_per_iteration"] == [1 + T * 3] * 2
    assert runs["vi"]["select_launches_per_iteration"] == [6] * 2
    assert [runs[m]["evaluations"] for m in runs] == [2, 1, 2]
    assert len(runs["nuts"]["select_launches_per_iteration"]) == 1
    for n in runs["nuts"]["select_launches_per_iteration"]:
        assert 1 + 2 * T <= n <= 1 + T * 2 ** 3
    assert launches["sweep_inverse"] == sum(
        c["select_launches_meta_fit"] + sum(c["select_launches_per_iteration"])
        for c in line["campaigns"])
    for c in line["campaigns"]:
        assert c["predicted_per_iteration"] == list(
            chip_smoke.posterior_launches(small(fit_method=c["fit_method"])))
        assert 0.0 < c["sampler_share"] < 1.0
    r = line["rounding"]
    assert r["draws"] == 2 * 4
    assert r["kernel"] == r["plain"]
    assert 0.0 < r["plain"]["value"][0] < 1e-2
    assert [d["fit_method"] for d in line["drivers"]] == ["hmc", "vi"]
    for d in line["drivers"]:
        assert d["mixture_draws"] == 4 and len(d["refit_s"]) == 2


def test_experiment_phase_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The experiment phase at a CPU size (the Branin submit cut to 2
    studies x 2 evaluations, small fits; tables of 2 studies x 2
    evaluations with 3 meta-tasks x 8 points): routed through the
    campaign, read back equal to it, the JAX package's hashes printed;
    every grid observation the host lookup's, every NN one the host's L1
    argmin; no kernel launched (``chol``)."""
    small_cfg = functools.partial(chip_smoke.CampaignConfig, fit_steps=6,
                                  fit_restarts=1, acq_raw_samples=16,
                                  acq_topk=2, acq_steps=3)
    small_run = functools.partial(campaign.run_campaign, meta_fit_restarts=1,
                                  meta_fit_steps=6)
    monkeypatch.setattr(local_runner, "CampaignConfig", small_cfg)
    monkeypatch.setattr(local_runner, "run_campaign", small_run)
    for name, value in (("EXPERIMENT_STUDIES", 2), ("EXPERIMENT_EVALS", 2),
                        ("EXPERIMENT_DIR", tmp_path / "ex"),
                        ("EXPERIMENT_TABLE_STUDIES", 2),
                        ("EXPERIMENT_TABLE_EVALS", 2), ("GRID_TASKS", 3),
                        ("GRID_POINTS", 8), ("NN_TASKS", 3),
                        ("NN_POINTS", 8), ("CampaignConfig", small_cfg),
                        ("run_campaign", small_run)):
        monkeypatch.setattr(chip_smoke, name, value)
    launches = chip_smoke.phase_experiment("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "experiment"
    sub = line["submit"]
    assert sub["hashes_equal_jax"] and sub["max_abs_regret_diff"] <= 1e-6
    assert "lock-step campaign" in sub["route"][0]
    assert len(sub["iteration_s"]) == 2
    assert (tmp_path / "ex" / sub["results_dir"] / "info.json").exists()
    grid, nn = line["tables"]
    assert grid["task_params_shapes"] == {"table": [2, 1024]}
    assert nn["task_params_shapes"]["coords"][::2] == [2, 4]
    assert 1024 <= nn["task_params_shapes"]["coords"][1] <= 4096
    assert grid["table_bytes_on_device"] == 2 * 1024 * 4
    assert nn["host_argmin_exact"][1] == 4
    assert [t["meta_tasks"] for t in (grid, nn)] == [3, 3]
    assert all(v == 0 for v in launches.values())


def test_experiment_tables_are_seeded():
    """The smoke's synthetic tables: the study seed draws the target and
    distinct meta-tasks; the same seed, the same draw; the grid has 1024
    cells and its host lookup is the table; the NN rows stay in PD1's
    bounds."""
    a, b = (chip_smoke.GridTable([4] * 3, seed=s) for s in (5, 5))
    assert a.target_task == b.target_task and list(a.meta_tasks) == list(
        b.meta_tasks)
    assert a.target_task.uid not in a.meta_tasks and len(a.meta_tasks) == 3
    assert a._tables.shape[1] == 1024
    assert a.optimum == a._tables[a.target_task.uid].min()
    nn = chip_smoke.NNTable([4] * 2, seed=1)
    coords, values = nn.task_rows()
    lo, hi = np.array(list(chip_smoke.NN_BOUNDS.values())).T
    assert ((coords >= lo) & (coords <= hi)).all()
    assert nn.optimum == values.min()
    md = nn.get_meta_data(seed=3)
    assert [len(v) for v in md.values()] == [4, 4]


def test_sharded_phase_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The sharded phase at a CPU size (Quadratic 8 tasks x 6 points over 4
    task slots; Branin 4 studies x 2 evaluations, 2 tasks x 6 points, short
    fits), its plain version standing in for the kernel through a counting
    wrapper: the task-sharded fits held to the unsharded ones, the (2, 1)
    mesh and two gloo ranks of CPU workers equal to the unsharded campaign
    and bit for bit to each other, the task slots at once bit for bit to
    the slots in turn (each its tasks fitted alone), every study covered
    once, each leg's seconds and launches and the slots' at once over in
    turn on the line."""
    plain = sweep.sweep_inverse_reference

    def counted(A, variant="select"):
        # the slots call this from their threads at once
        cuda_build.count_launch(counted.launches, variant)
        return plain(A, variant)

    counted.launches = sweep.sweep_inverse.launches
    monkeypatch.setattr(sweep, "sweep_inverse", counted)
    small = functools.partial(chip_smoke.CampaignConfig, fit_steps=6)
    for name, value in (
            ("SHARD_A", dict(tasks=8, points=6, sigma=0.05, target_points=4)),
            ("SHARD_B", dict(studies=4, evals=2, tasks=2, points=6,
                             sigma=1.0)),
            ("SHARD_TARGET_STEPS", 5), ("SHARD_META_STEPS", 6),
            ("SHARD_DIR", tmp_path / "sh"),
            ("META_RESTARTS", 1), ("META_STEPS", 6),
            ("CampaignConfig", small)):
        monkeypatch.setattr(chip_smoke, name, value)
    launches = chip_smoke.phase_sharded("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "sharded"
    a, b = line["task_sharded"], line["study_sharded"]
    assert a["task_slots"] == 4 and a["normalizer_max_rel"] <= 1e-5
    tol = chip_smoke.SHARD_META_TOL
    assert a["objective_gap_median"] <= tol["median"]
    assert a["objective_gap_p90"] <= tol["p90"]
    fitted = a["target_objective_init_fitted"]
    assert fitted[1] < fitted[0]
    assert list(b["legs"]) == ["unsharded", "mesh_2x1", "ranks_2"]
    for name in ("mesh_2x1", "ranks_2"):
        eq = b["equal_to_unsharded"][name]
        assert eq["max_abs_diff_noise"] <= chip_smoke.CHUNK_TOL["noise"]
    # the slots at once: their bits are the slots' in turn
    assert a["at_once_bit_for_bit_in_turn"]
    assert not b["bit_for_bit_required"]
    assert all(b["equal_to_unsharded"]["ranks_vs_mesh"][f]
               for f in ("X", "y", "y_clean"))
    assert line["slots_at_once_over_in_turn"] == (
        a["meta_fit_sharded_s"] / a["meta_fit_in_turn_s"])
    ranks = b["legs"]["ranks_2"]["ranks"]
    assert [r["local_studies"] for r in ranks] == [2, 2]
    assert all(r["launches"]["sweep_inverse"] == 0 for r in ranks)
    assert launches["sweep_inverse"] == a["sweep_inverse_launches"] + sum(
        b["legs"][k]["sweep_inverse_launches"]
        for k in ("unsharded", "mesh_2x1")) > 0
    assert not (tmp_path / "sh").exists()


def test_probes_phase_on_the_cpu(monkeypatch, capsys):
    """The probes phase at a CPU size, counting wrappers around the
    kernels' mirrors (their recurrences) standing in for the kernels and
    the plain versions for their first versions: the checks pass, the
    entry points launch each probe as often as they call it (the factor
    once to check it, then a warm-up, reps + 1 chained and reps alone; the
    floor a warm-up, reps chained and reps alone), no other kernel, and
    every large-N row passes; the timed rows (the card's event timer and
    device spin replaced by the host clock) carry the kernels line's
    fields and the checks' errors at both shapes."""
    def counting(plain):
        def counted(A):
            cuda_build.count_launch(vars(counted), "launches")
            return plain(A)
        counted.launches = 0
        return counted

    monkeypatch.setattr(probes, "rank1_cholesky",
                        counting(probes.blocked_cholesky_mirror))
    monkeypatch.setattr(probes, "traversal_floor",
                        counting(probes.traversal_floor_fma_reference))
    firsts = {"rank1_cholesky": probes.rank1_cholesky_reference,
              "traversal_floor": probes.traversal_floor_reference}
    monkeypatch.setattr(chip_smoke, "PROBE_BASELINES", firsts)
    monkeypatch.setattr(profile_kernels, "PROBE_BASELINES", firsts)

    def host_ms(fn, reps):
        # the card's event timer, on the host clock
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    monkeypatch.setattr(chip_smoke, "time_ms", host_ms)
    monkeypatch.setattr(profile_kernels, "time_ms", host_ms)
    monkeypatch.setattr(profile_kernels, "device_ms",
                        lambda launch, reps: host_ms(lambda: launch(0), reps))
    for name, value in (("PROBE_CHECK_B", 4), ("PROBE_CHECK_NS", (5, 33)),
                        ("PROBE_SHAPE", (8, 16)), ("PROBE_REPS", 2),
                        ("PROBE_TIMED", ((8, 16), (4, 5))),
                        ("PROBE_TIMED_REPS", 1), ("PROBE_PLAIN_REPS", 1),
                        ("LARGE_N_SIZES", (32, 64))):
        monkeypatch.setattr(chip_smoke, name, value)
    max_err, head, others, launches = chip_smoke.phase_probes("cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "probes"
    assert [c["n"] for c in line["checks"]] == [5, 33]
    assert [c["geometry"] for c in line["checks"]] == ["warp", "blocked"]
    for c in line["checks"]:
        assert c["old_floor_bitwise_equal"] and c["chol_upper_zero"]
        assert c["floor_max_ulps_fma"] == 0
        assert c["floor_share_not_bitwise_fma"] == 0.0
        assert c["old_chol_max_abs_err"] == 0.0
        assert c["chol_max_abs_err"] <= 1e-5 * c["max_abs_l"]
        assert 0 <= c["floor_max_ulps_plain"] <= c["n"]
    assert max_err == {
        "rank1_cholesky": max(c["chol_max_abs_err"] for c in line["checks"]),
        "traversal_floor": max(c["floor_max_abs_err"]
                               for c in line["checks"])}
    assert launches["rank1_cholesky"] == 2 + 3 + 2
    assert launches["traversal_floor"] == 1 + 2 + 2
    assert sum(launches.values()) == 2 + 3 + 2 + 1 + 2 + 2
    assert line["launches"] == launches
    chol_line = line["chol_fused_probe"]
    assert chol_line["B"] == 8 and chol_line["chol_over_sweep_alone"] > 0
    assert set(chol_line["allocator_counts"]) == {"chol", "sweep", "library",
                                                  "chain"}
    assert line["traversal_floor_probe"]["sweep_pct_of_ceiling_alone"] > 0
    assert [r["N"] for r in line["large_n"]["rows"]] == [32, 64]
    assert line["large_n"]["all_pass"]
    for name in probes.KERNELS:
        entry = head[name]
        assert (entry["batch"], entry["n"]) == (8, 16)
        assert entry["ms"] > 0 and entry["plain_ms"] > 0
        assert entry["old_ms"] > 0 and entry["ms_alone"] > 0
        assert entry["old_ms_alone"] > 0
        assert len(entry["turns_ms"]) == len(entry["turns_alone_ms"]) == 4
        assert (entry["bound_ms"], entry["bound_by"]) == (
            chip_smoke.probe_bound(name, 8, 16))
        assert list(others[name]) == ["4x5"]
        for row in (entry, others[name]["4x5"]):
            assert row["max_abs_err"] <= max_err[name]
    for row in (head["rank1_cholesky"], others["rank1_cholesky"]["4x5"]):
        assert row["chol_upper_zero"] and row["old_chol_max_abs_err"] == 0.0
        assert row["chol_max_abs_err_mirror"] == 0.0
        assert row["chol_rel_err_vs_library"] < 1e-4
    for row in (head["traversal_floor"], others["traversal_floor"]["4x5"]):
        assert row["floor_max_ulps_fma"] == 0 and row["old_floor_bitwise_equal"]
        assert 0 <= row["floor_max_ulps_plain"] <= row["n"]
    assert head["rank1_cholesky"]["library_ms"] > 0
    assert head["traversal_floor"]["library_ms"] is None


def test_entry_phase_on_the_cpu(monkeypatch, capsys):
    """The entry phase on the CPU at a small headline shape, the plain
    sweep standing in for the kernel through a counting wrapper: the
    float32 step within ENTRY_RTOL of float64, the dry run on one slot,
    and ``select`` launched once a round (and once to warm up) in each of
    the four sweep stages of the headline profile, never in the others."""
    plain = sweep.sweep_inverse_reference

    def counted(A, variant="select"):
        counted.launches[variant] += 1
        return plain(A, variant)

    counted.launches = sweep.sweep_inverse.launches
    monkeypatch.setattr(sweep, "sweep_inverse", counted)
    monkeypatch.setattr(chip_smoke, "HEADLINE_SHAPE", (4, 8, 2))
    monkeypatch.setattr(chip_smoke, "HEADLINE_ROUNDS", 2)
    launches = chip_smoke.phase_entry("cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    head, line = json.loads(lines[-2]), json.loads(lines[-1])
    assert line["phase"] == "entry"
    assert (head["B"], head["N"], head["D"], head["rounds"]) == (4, 8, 2, 2)
    assert head["launches"]["inverse_fwd"] == {"sweep_inverse": 3}
    assert head["launches"]["mll_vg_chol"] == {}
    assert launches["sweep_inverse"] == 4 * 3
    assert sum(launches.values()) == 4 * 3
    assert line["launches"] == launches
    assert len(line["entry_max_rel"]) == 3
    assert 0 < max(line["entry_max_rel"]) <= chip_smoke.ENTRY_RTOL
    assert line["dryrun"]["slots"] == ["cpu"]
    assert line["dryrun"]["mesh"] == [1, 1]
