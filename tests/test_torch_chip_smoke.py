"""The chip smoke's float32 rounding guard, its ``chol64`` entry and its
``campaign_resume`` phase, on CPU tensors.

``chip_smoke.rounding`` holds each kernel of a slice's route to at most
twice its plain version's distance from float64 on the slice's own
systems; ``chip_smoke.inverse_schemes`` names those kernels.  Here the
plain versions stand in for the kernels (the CUDA kernels have no CPU
mode), so the guard's comparison and its failure, the ``chol64`` entry and
the resume phase's runs and checks are exercised without a card.
"""

import functools
import json

import numpy as np
import pytest
import torch

import chip_smoke
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import blocked_chol, linalg, sweep


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
    assert [r["completed"] for r in line["runs"]] == [4, 2, 4, 4]
    assert [len(r["iteration_s"]) for r in line["runs"]] == [4, 2, 2, 8]
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
