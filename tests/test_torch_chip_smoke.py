"""The chip smoke's float32 rounding guard, on CPU tensors.

``chip_smoke.rounding`` holds each kernel of a slice's route to at most
twice its plain version's distance from float64 on the slice's own
systems; ``chip_smoke.inverse_schemes`` names those kernels.  Here the
plain versions stand in for the kernels (the CUDA kernels have no CPU
mode), so the guard's comparison and its failure are checked without a
card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from scamlgp_tpu_torch.ops import blocked_chol, sweep


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
