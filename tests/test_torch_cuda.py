"""The port's CUDA kernels on the card: each against its plain PyTorch
version (the sweep in its four step schemes, both variants of the blocked
Cholesky, the RBF Gram, and the sweep's two loop-shape probes; the first
versions kept as yardsticks), and the campaign and the sequential driver on
the card against the same on the CPU.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so it also runs where those are
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from scamlgp_tpu_torch.benchmarking.benchmarks import Branin, Hartmann6D
from scamlgp_tpu_torch.benchmarking.torch_adapters import (
    campaign_inputs_from_benchmark,
)
from scamlgp_tpu_torch import testing as conformance
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.ops import blocked_chol, gram, inverse_mll, probes
from scamlgp_tpu_torch.ops import sweep
from scamlgp_tpu_torch.ops import kernels as K
from scamlgp_tpu_torch.parallel.campaign import CampaignConfig, run_campaign
from tests.torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spd_batch(rng, b, n, jitter=0.5):
    X = rng.normal(size=(b, n, n)).astype(np.float32)
    return np.einsum("bij,bkj->bik", X, X) / n + jitter * np.eye(
        n, dtype=np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 8, 10, 32, 40, 128])
def test_sweep_kernel_matches_plain(cuda, n, dtype):
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 64, n),
                        dtype=dtype, device=cuda)
    before = sweep.sweep_inverse.launches["select"]
    inv_k, ld_k = sweep.sweep_inverse(A)
    torch.cuda.synchronize()
    assert sweep.sweep_inverse.launches["select"] == before + 1
    inv_p, ld_p = sweep.sweep_inverse_reference(A)
    tol_inv, tol_ld = ((1e-4, 1e-5) if dtype == torch.float32
                       else (1e-11, 1e-12))
    assert (inv_k - inv_p).abs().max().item() <= tol_inv * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= tol_ld


SELECT_NS = [1, 2, 5, 31, 32, 33, 63, 64, 65, 127, 128]


@pytest.mark.parametrize("n", SELECT_NS)
def test_select_kernel_equals_plain_bit_for_bit_f32(cuda, n):
    """The select kernel repeats ``_sweep_select``'s operations element by
    element (no FMA), so in float32 it gives the same bits; N crosses every
    register capacity and the warp and CTA paths, and the batch (37) is no
    multiple of the matrices a CTA owns."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        device=cuda)
    inv_k, ld_k = sweep.sweep_inverse(A)
    torch.cuda.synchronize()
    inv_p, ld_p = sweep.sweep_inverse_reference(A)
    assert torch.equal(inv_k, inv_p)
    assert torch.equal(ld_k, ld_p)


@pytest.mark.parametrize("n", SELECT_NS)
def test_select_kernel_matches_plain_f64(cuda, n):
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        dtype=torch.float64, device=cuda)
    inv_k, ld_k = sweep.sweep_inverse(A)
    torch.cuda.synchronize()
    inv_p, ld_p = sweep.sweep_inverse_reference(A)
    assert (inv_k - inv_p).abs().max().item() <= 1e-11 * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= 1e-12


def test_select_kernel_geometry_is_the_wrappers(cuda):
    for n in range(1, 129):
        want = sweep.launch_geometry(n)
        got = sweep.kernel_geometry(n)
        assert got == {k: want[k] for k in got}, n


FUSED_NS = [1, 2, 5, 9, 31, 32, 33, 41, 63, 64, 65, 127, 128]


@pytest.mark.parametrize("n", FUSED_NS)
def test_fused_kernel_equals_plain_bit_for_bit_f32(cuda, n):
    """The fused kernel repeats ``_sweep_fused``'s operations element by
    element, (A + cd u) + e_k w with the zero term kept (no FMA), so in
    float32 it gives the same bits, zeros' signs included; N crosses every
    register capacity and the warp and CTA paths, and the batch (37) is no
    multiple of the matrices a CTA owns."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        device=cuda)
    before = sweep.sweep_inverse.launches["fused"]
    inv_k, ld_k = sweep.sweep_inverse(A, "fused")
    torch.cuda.synchronize()
    assert sweep.sweep_inverse.launches["fused"] == before + 1
    inv_p, ld_p = sweep.sweep_inverse_reference(A, "fused")
    assert torch.equal(inv_k, inv_p)
    assert torch.equal(torch.signbit(inv_k), torch.signbit(inv_p))
    assert torch.equal(ld_k, ld_p)


@pytest.mark.parametrize("n", FUSED_NS)
def test_fused_kernel_matches_plain_f64(cuda, n):
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        dtype=torch.float64, device=cuda)
    inv_k, ld_k = sweep.sweep_inverse(A, "fused")
    torch.cuda.synchronize()
    inv_p, ld_p = sweep.sweep_inverse_reference(A, "fused")
    assert (inv_k - inv_p).abs().max().item() <= 1e-11 * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= 1e-12


@pytest.mark.parametrize("variant", ["fused", "pair", "blocked"])
def test_fused_kernel_geometry_is_the_wrappers(cuda, variant):
    """Each further scheme's built geometry at every N it takes."""
    for n in range(1, 129):
        if sweep.resolve_variant(n, variant) != variant:
            continue
        want = sweep.launch_geometry(n, variant=variant)
        got = sweep.kernel_geometry(n, variant)
        assert got == {k: want[k] for k in got}, n


PAIR_NS = [2, 8, 30, 32, 34, 40, 64, 66, 126, 128]


@pytest.mark.parametrize("n", PAIR_NS)
def test_pair_kernel_equals_plain_bit_for_bit_f32(cuda, n):
    """The pair kernel repeats ``_sweep_pair``'s operations element by
    element, the borders' zero terms kept (no FMA), so in float32 it gives
    the same bits; N crosses the warp path's capacities (2, 8, 30, 32),
    the CTA path's (34 ... 128) and a pair across its 16-column groups
    (34, 66, 126), and the batch (37) is no multiple of the matrices a CTA
    owns."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        device=cuda)
    before = sweep.sweep_inverse.launches["pair"]
    inv_k, ld_k = sweep.sweep_inverse(A, "pair")
    torch.cuda.synchronize()
    assert sweep.sweep_inverse.launches["pair"] == before + 1
    inv_p, ld_p = sweep.sweep_inverse_reference(A, "pair")
    assert torch.equal(inv_k, inv_p)
    assert torch.equal(ld_k, ld_p)


@pytest.mark.parametrize("n", PAIR_NS)
def test_pair_kernel_matches_plain_f64(cuda, n):
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        dtype=torch.float64, device=cuda)
    inv_k, ld_k = sweep.sweep_inverse(A, "pair")
    torch.cuda.synchronize()
    inv_p, ld_p = sweep.sweep_inverse_reference(A, "pair")
    assert (inv_k - inv_p).abs().max().item() <= 1e-11 * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [32, 64, 96, 128])
def test_blocked_sweep_kernel_matches_plain(cuda, n, dtype):
    """The blocked kernel at every N it takes (32 on the warp path, one
    panel; 64, 96, 128 on the CTA path, 96 with a masked register tile),
    batch 37, within chip_smoke.py's TOL_INV / TOL_LOGDET: its rank-32
    sums run in another order than the library matmul's."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 37, n),
                        dtype=dtype, device=cuda)
    before = sweep.sweep_inverse.launches["blocked"]
    inv_k, ld_k = sweep.sweep_inverse(A, "blocked")
    torch.cuda.synchronize()
    assert sweep.sweep_inverse.launches["blocked"] == before + 1
    inv_p, ld_p = sweep.sweep_inverse_reference(A, "blocked")
    tol_inv, tol_ld = ((1e-4, 1e-5) if dtype == torch.float32
                       else (1e-11, 1e-12))
    assert (inv_k - inv_p).abs().max().item() <= tol_inv * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= tol_ld


@pytest.mark.parametrize("variant", ["pair", "blocked"])
def test_sweep_profiling_build_computes_the_same(cuda, variant):
    """The -DSWEEP_PROFILE build (clock64 stamps, no added barrier) gives
    the default build's bits."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(5), 16, 128),
                        device=cuda)
    got = sweep._launch(A, variant, ("-DSWEEP_PROFILE",))
    want = sweep._launch(A, variant)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name,n", [
    ("sweep_inverse_fused", 40), ("sweep_inverse_fused", 128),
    ("sweep_inverse_pair", 40), ("sweep_inverse_pair", 128),
    ("sweep_inverse_blocked", 64), ("sweep_inverse_blocked", 128),
    ("blocked_chol_inverse_global", 200), ("blocked_chol_inverse_global", 512)])
def test_baseline_kernels_match_plain(cuda, name, n):
    """The first versions, kept to be timed beside the redesigned kernels,
    still compute the function (float32, the sweep's tolerances)."""
    from scamlgp_tpu_torch.profile_kernels import BASELINES
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 8, n),
                        device=cuda)
    inv_k, ld_k = BASELINES[name](A)
    torch.cuda.synchronize()
    inv_p, ld_p = (
        sweep.sweep_inverse_reference(A, name.rsplit("_", 1)[1])
        if name.startswith("sweep")
        else blocked_chol.blocked_chol_inverse_reference(A))
    assert (inv_k - inv_p).abs().max().item() <= 1e-4 * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= 1e-5


def test_sweep_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        sweep.sweep_inverse(torch.eye(130, device=cuda).expand(2, 130, 130)
                            .contiguous())
    with pytest.raises(TypeError):
        sweep.sweep_inverse(torch.eye(4, device=cuda,
                                      dtype=torch.float16)[None])
    with pytest.raises(ValueError):
        sweep.sweep_inverse(torch.eye(4, device=cuda)[None].transpose(1, 2)
                            .expand(2, 4, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant,n", [
    ("fused", 1), ("fused", 9), ("fused", 32), ("fused", 41), ("fused", 128),
    ("pair", 2), ("pair", 8), ("pair", 40), ("pair", 128),
    ("blocked", 32), ("blocked", 64), ("blocked", 96), ("blocked", 128)])
def test_sweep_variant_kernel_matches_plain(cuda, variant, n, dtype):
    """Each step scheme's kernel against its own plain version, at the N it
    takes (odd and even for fused, even for pair, N % 32 == 0 for blocked),
    with the select kernel's tolerances; the launch goes to the scheme's
    own count."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 64, n),
                        dtype=dtype, device=cuda)
    before = dict(sweep.sweep_inverse.launches)
    inv_k, ld_k = sweep.sweep_inverse(A, variant)
    torch.cuda.synchronize()
    after = sweep.sweep_inverse.launches
    assert {v: after[v] - before[v] for v in after} == {
        v: int(v == variant) for v in after}
    inv_p, ld_p = sweep.sweep_inverse_reference(A, variant)
    tol_inv, tol_ld = ((1e-4, 1e-5) if dtype == torch.float32
                       else (1e-11, 1e-12))
    assert (inv_k - inv_p).abs().max().item() <= tol_inv * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= tol_ld


@pytest.mark.parametrize("variant,n", [("pair", 9), ("blocked", 40)])
def test_sweep_variant_the_shape_refuses_runs_select(cuda, variant, n):
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 8, n),
                        device=cuda)
    before = dict(sweep.sweep_inverse.launches)
    inv, _ = sweep.sweep_inverse(A, variant)
    after = sweep.sweep_inverse.launches
    assert after["select"] == before["select"] + 1
    assert after[variant] == before[variant]
    inv_p, _ = sweep.sweep_inverse_reference(A)
    assert (inv - inv_p).abs().max().item() <= 1e-4 * inv_p.abs().max().item()


@pytest.mark.parametrize("variant", ["fused", "pair", "blocked"])
def test_sweep_variant_rejects_what_its_kernel_does_not_take(cuda, variant):
    with pytest.raises(ValueError, match="shared memory"):
        sweep.sweep_inverse(torch.eye(160, device=cuda).expand(2, 160, 160)
                            .contiguous(), variant)
    with pytest.raises(TypeError):
        sweep.sweep_inverse(torch.eye(32, device=cuda,
                                      dtype=torch.float16)[None], variant)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep_inverse(torch.eye(32, device=cuda)[None].transpose(1, 2)
                            .expand(2, 32, 32), variant)


@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("variant", sweep.VARIANTS)
def test_sweep_kernel_of_indefinite_matrix_gives_nan_logdet(cuda, variant,
                                                            n):
    """N = 32 on the warp path, 64 and 128 on the CTA path, f32 and
    f64."""
    for dtype in (torch.float64, torch.float32):
        A = torch.eye(n, dtype=dtype)
        A[0, 1] = A[1, 0] = 2.0
        _, ld = sweep.sweep_inverse(A[None].to(cuda), variant)
        assert torch.isnan(ld).all()


def test_kernel_launches_names_every_kernel(cuda):
    inverse_mll.reset_kernel_launches()
    A = torch.as_tensor(_spd_batch(np.random.default_rng(3), 4, 64),
                        device=cuda)
    for variant in sweep.VARIANTS:
        sweep.sweep_inverse(A, variant)
    blocked_chol.blocked_chol_inverse(A, "global")
    assert inverse_mll.kernel_launches() == {
        "sweep_inverse": 1, "sweep_inverse_fused": 1,
        "sweep_inverse_pair": 1, "sweep_inverse_blocked": 1,
        "blocked_chol_inverse_smem": 0, "blocked_chol_inverse_global": 1}


@pytest.mark.parametrize("variant", sweep.VARIANTS)
def test_sweep_inverse_gradient_on_the_card(cuda, variant):
    """``mll_via_sweep`` (``SweepInverse``'s analytic VJP) on the card
    against the CPU, float64."""
    rng = np.random.default_rng(4)
    A = torch.as_tensor(_spd_batch(rng, 6, 32), dtype=torch.float64)
    y = torch.as_tensor(rng.normal(size=(6, 32)))
    out = []
    for dev in ("cpu", cuda):
        Ad = A.to(dev).requires_grad_(True)
        v = sweep.mll_via_sweep(Ad, y.to(dev), variant=variant).sum()
        out.append([t.cpu() for t in (v, *torch.autograd.grad(v, (Ad,)))])
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("variant", blocked_chol.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [64, 88, 192, 256, 320, 448, 512, 704, 1000,
                               1024])
def test_blocked_kernel_matches_plain(cuda, n, dtype, variant):
    """Each variant at every fixture shape it can take (``smem`` needs the
    lower blocks in one CTA's shared memory), same tolerances as the
    sweep: N = 320, 448, 704 and 1000 cross ``global``'s routing window
    (float32 from 320, float64 up to 704) and its panel chunks, 1000 is no
    multiple of 64."""
    itemsize = torch.finfo(dtype).bits // 8
    if variant == "smem" and (blocked_chol.smem_bytes(n, itemsize)
                              > blocked_chol.SMEM_LIMIT):
        with pytest.raises(ValueError, match="shared memory"):
            blocked_chol.blocked_chol_inverse(
                torch.eye(n, dtype=dtype, device=cuda)[None], variant)
        return
    A = torch.as_tensor(_spd_batch(np.random.default_rng(n), 16, n),
                        dtype=dtype, device=cuda)
    before = blocked_chol.blocked_chol_inverse.launches[variant]
    inv_k, ld_k = blocked_chol.blocked_chol_inverse(A, variant)
    torch.cuda.synchronize()
    assert blocked_chol.blocked_chol_inverse.launches[variant] == before + 1
    inv_p, ld_p = blocked_chol.blocked_chol_inverse_reference(A)
    tol_inv, tol_ld = ((1e-4, 1e-5) if dtype == torch.float32
                       else (1e-11, 1e-12))
    assert (inv_k - inv_p).abs().max().item() <= tol_inv * \
        inv_p.abs().max().item()
    assert ((ld_k - ld_p).abs() / ld_p.abs().clamp_min(1.0)).max().item() \
        <= tol_ld


@pytest.mark.parametrize("variant", blocked_chol.VARIANTS)
def test_blocked_kernel_of_indefinite_matrix_is_not_finite(cuda, variant):
    A = torch.eye(70, dtype=torch.float64)
    A[0, 1] = A[1, 0] = 2.0
    inv, ld = blocked_chol.blocked_chol_inverse(A[None].to(cuda), variant)
    assert torch.isnan(ld).all() and not torch.isfinite(inv).all()


def test_blocked_on_the_card_never_reaches_the_plain_version(cuda,
                                                             monkeypatch):
    def refuse(A):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(blocked_chol, "blocked_chol_inverse_reference",
                        refuse)
    A = torch.as_tensor(_spd_batch(np.random.default_rng(2), 4, 256),
                        device=cuda)
    for variant in (None, *blocked_chol.VARIANTS):
        inv, _ = blocked_chol.blocked_chol_inverse(A, variant)
        assert inv.device.type == "cuda"
    v = inverse_mll.mll_via_inverse(A, torch.ones(4, 256, device=cuda),
                                    torch.full((4,), 256.0, device=cuda),
                                    route_blocked=True)
    assert torch.isfinite(v).all()
    with pytest.raises(TypeError):
        blocked_chol.blocked_chol_inverse(A.half())


def test_mll_via_inverse_gradient_on_the_card(cuda):
    rng = np.random.default_rng(1)
    A = torch.as_tensor(_spd_batch(rng, 8, 24), dtype=torch.float64)
    y = torch.as_tensor(rng.normal(size=(8, 24)))
    na = torch.full((8,), 24.0, dtype=torch.float64)
    out = []
    for dev in ("cpu", cuda):
        Ad = A.to(dev).requires_grad_(True)
        yd = y.to(dev).requires_grad_(True)
        v = inverse_mll.mll_via_inverse(Ad, yd, na.to(dev)).sum()
        out.append([t.cpu() for t in (v, *torch.autograd.grad(v, (Ad, yd)))])
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-11)


def test_campaign_on_the_card_matches_the_cpu(cuda):
    """A tiny float64 campaign proposes the same points through the kernel
    on the card as through the plain sweep on the CPU."""
    fn, tp, md, _ = campaign_inputs_from_benchmark(
        Branin, [8] * 2, range(2), noise_std=1.0, dtype=torch.float64,
        device="cpu")
    cfg = CampaignConfig(n_evaluations=2, mll_method="sweep", fit_steps=10,
                         acq_raw_samples=32, acq_topk=3, acq_steps=8)
    xs = []
    for dev in ("cpu", cuda):
        inverse_mll.reset_kernel_launches()
        res = run_campaign(fn, tp, md, seed=0, cfg=cfg, meta_fit_restarts=2,
                           meta_fit_steps=12, device=dev)
        xs.append(res.X.cpu())
    counts = res.launches["sweep_inverse"]
    assert sweep.sweep_inverse.launches["select"] == sum(counts) > 0
    assert len(counts) == 3
    torch.testing.assert_close(xs[1], xs[0], rtol=1e-6, atol=1e-8)


def test_blocked_route_campaign_on_the_card_matches_the_cpu(cuda):
    """N_m = 192 with ``route_blocked``: the meta-fit's systems take the
    blocked kernel on the card and its plain version on the CPU, and the
    two propose the same points (float64)."""
    fn, tp, md, _ = campaign_inputs_from_benchmark(
        Branin, [192] * 2, range(2), noise_std=1.0, dtype=torch.float64,
        device="cpu")
    cfg = CampaignConfig(n_evaluations=2, mll_method="sweep",
                         route_blocked=True, fit_steps=10,
                         acq_raw_samples=32, acq_topk=3, acq_steps=8)
    xs = []
    for dev in ("cpu", cuda):
        res = run_campaign(fn, tp, md, seed=0, cfg=cfg, meta_fit_restarts=1,
                           meta_fit_steps=8, device=dev)
        xs.append(res.X.cpu())
    assert res.launches["blocked_chol_inverse_smem"][0] > 0
    assert sum(res.launches["blocked_chol_inverse_global"]) == 0
    torch.testing.assert_close(xs[1], xs[0], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("variant", ["fused", "pair", "blocked"])
def test_sweep_variant_campaign_on_the_card_matches_the_cpu(cuda, variant):
    """A tiny float64 Hartmann6D campaign (N_m = 32) with
    ``sweep_variant``: the meta-fit's systems take the scheme's kernel on
    the card and its plain version on the CPU, and the two propose the same
    points."""
    fn, tp, md, _ = campaign_inputs_from_benchmark(
        Hartmann6D, [32] * 2, range(2), noise_std=0.1, dtype=torch.float64,
        device="cpu", optimum_method="device")
    cfg = CampaignConfig(n_evaluations=2, mll_method="sweep",
                         sweep_variant=variant, fit_steps=10,
                         acq_raw_samples=32, acq_topk=3, acq_steps=8)
    xs = []
    for dev in ("cpu", cuda):
        res = run_campaign(fn, tp, md, seed=0, cfg=cfg, meta_fit_restarts=1,
                           meta_fit_steps=8, device=dev)
        xs.append(res.X.cpu())
    name = f"sweep_inverse_{variant}"
    assert res.launches[name][0] > 0
    assert all(c[0] == 0 for k, c in res.launches.items() if k != name)
    torch.testing.assert_close(xs[1], xs[0], rtol=1e-6, atol=1e-8)


GRAM_SHAPES = [(1, 1, 1), (300, 200, 3), (257, 513, 6), (130, 70, 40),
               (2048, 2048, 6), (129, 131, 33), (3, 5, 1), (4096, 4096, 2)]


def _gram_inputs(n, m, d, dtype, device):
    rng = np.random.default_rng(n + d)
    x, z = (torch.as_tensor(rng.uniform(size=s), dtype=dtype, device=device)
            for s in ((n, d), (m, d)))
    ls = torch.as_tensor(rng.uniform(0.3, 1.0, size=d), dtype=dtype,
                         device=device)
    return x, z, ls, torch.tensor(1.3, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,d", GRAM_SHAPES)
def test_gram_kernel_matches_plain(cuda, n, m, d, dtype):
    """The RBF Gram kernel against its plain version on the card, atol 2e-5
    (the JAX package's tolerance for this kernel).  The shapes reach every
    branch: d = 33 and 40 take three and two feature chunks; rows that do
    not start on 16 bytes (m % 4 != 0 in float32: 1, 513, 70, 131, 5; m
    odd in float64) take the element-wise stores, the others 16-byte runs
    with element-wise stores at the ragged tile edge; (3, 5, 1) is under
    one tile; (4096, 4096, 2) has more tiles than resident CTAs (8 a CTA on
    an H100)."""
    x, z, ls, os_ = _gram_inputs(n, m, d, dtype, cuda)
    before = gram.rbf_gram.launches
    Kk = gram.rbf_gram(x, z, ls, os_)
    torch.cuda.synchronize()
    assert gram.rbf_gram.launches == before + 1
    assert Kk.dtype == dtype and Kk.shape == (n, m)
    Kp = gram.rbf_gram_plain(x, z, ls, os_)
    assert (Kk - Kp).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,d", [(3, 5, 1), (129, 131, 33),
                                   (2048, 2048, 6), (4096, 4096, 2)])
def test_gram_kernel_matches_its_first_version(cuda, n, m, d, dtype):
    """The redesigned kernel against the first one
    (``baseline_rbf_gram``, ``csrc/baseline_kernels.cu``) on the same
    operands, atol 2e-5."""
    from scamlgp_tpu_torch.profile_kernels import baseline_gram
    ops = gram.prepare(*_gram_inputs(n, m, d, dtype, cuda))
    new = gram.run(*ops, torch.empty((n, m), dtype=dtype, device=cuda))
    old = baseline_gram(*ops, torch.empty((n, m), dtype=dtype, device=cuda))
    torch.cuda.synchronize()
    assert (new - old).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_kernel_geometry_is_the_wrappers(cuda, dtype):
    """The built kernel's launch rule (``rbf_gram_geometry``) is
    ``gram.launch_geometry``'s, on this card's SMs and on others."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, m, d in GRAM_SHAPES + [(64, 128, 0), (100, 384, 16)]:
        for s in (1, 2, sms):
            want = gram.launch_geometry(n, m, d, dtype, s)
            got = gram.kernel_geometry(n, m, d, dtype, s)
            assert got == {k: want[k] for k in got}, (n, m, d, s)


def test_gram_kernel_takes_an_unaligned_output(cuda):
    """An output that does not start on 16 bytes takes the element-wise
    stores, and the kernel writes nothing outside it."""
    n, m, d = 64, 256, 3
    ops = gram.prepare(*_gram_inputs(n, m, d, torch.float32, cuda))
    buf = torch.full((n * m + 2,), float("nan"), device=cuda)
    out = gram.run(*ops, buf[1:1 + n * m].view(n, m))
    torch.cuda.synchronize()
    assert (out - gram.rbf_gram_plain(*ops)).abs().max().item() <= 2e-5
    assert bool(torch.isnan(buf[0])) and bool(torch.isnan(buf[-1]))


@pytest.mark.parametrize("baseline", [False, True])
def test_gram_profiling_build_computes_the_same(cuda, baseline):
    """The -DGRAM_PROFILE builds (clock64 stamps) give the default
    builds' bits."""
    from scamlgp_tpu_torch import profile_kernels as pk
    n, m, d = 257, 513, 6
    ops = gram.prepare(*_gram_inputs(n, m, d, torch.float32, cuda))
    outs = [torch.empty((n, m), device=cuda) for _ in range(2)]
    if baseline:
        pk.baseline_gram(*ops, outs[0], pk.baseline_lib(pk.GRAM_PROFILE_FLAGS))
        pk.baseline_gram(*ops, outs[1])
    else:
        gram.run(*ops, outs[0], pk.GRAM_PROFILE_FLAGS)
        gram.run(*ops, outs[1])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_gram_kernel_gradient_on_the_card(cuda):
    """``RbfGram``'s gradients on the card: the VJP of ``kernels.rbf``."""
    rng = np.random.default_rng(1)
    vals = (rng.uniform(size=(300, 3)), rng.uniform(size=(200, 3)),
            rng.uniform(0.3, 1.0, size=3), np.asarray(1.3))
    kleaves = [torch.tensor(v, device=cuda, requires_grad=True)
               for v in vals]
    rleaves = [torch.tensor(v, device=cuda, requires_grad=True)
               for v in vals]
    cot = torch.as_tensor(rng.normal(size=(300, 200)), device=cuda)
    gk = torch.autograd.grad(gram.rbf_gram(*kleaves), kleaves, cot)
    gr = torch.autograd.grad(K.rbf(*rleaves), rleaves, cot)
    for a, b in zip(gk, gr):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_gram_counts_launches_only(cuda):
    """One launch a non-empty call, also a bare one through ``gram.run``;
    an empty output launches nothing."""
    x = torch.rand((64, 2), device=cuda)
    before = gram.rbf_gram.launches
    gram.rbf_gram(x, x, 0.5, 1.0)
    assert gram.rbf_gram.launches == before + 1
    assert gram.rbf_gram(x[:0], x, 0.5, 1.0).shape == (0, 64)
    assert gram.rbf_gram.launches == before + 1
    gram.run(*gram.prepare(x, x, 0.5, 1.0), torch.empty((64, 64),
                                                        device=cuda))
    assert gram.rbf_gram.launches == before + 2


def test_gram_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.rand((4, 2), device=cuda)
    with pytest.raises(TypeError):
        gram.rbf_gram(x.half(), x.half(), 1.0, 1.0)
    with pytest.raises(ValueError):
        gram.rbf_gram(x, torch.rand((4, 3), device=cuda), 1.0, 1.0)
    with pytest.raises(ValueError):
        gram.rbf_gram(x, x.cpu(), 1.0, 1.0)


def test_driver_on_the_card_matches_the_cpu(cuda):
    """``ScaMLGPBO`` in float64 proposes the same points on the card as on
    the CPU from one seed (the generator lives on the CPU)."""
    xs = []
    for dev in ("cpu", cuda):
        opt = ScaMLGPBO(conformance._space_1d(0), Objective("loss", False),
                        conformance.META_DATA_1D, seed=3, device=dev,
                        num_restarts_log_likelihood=2, num_fit_steps=20,
                        af_optimizer_kwargs={"raw_samples": 128,
                                             "num_restarts": 4,
                                             "num_steps": 15})
        assert opt.source_gps.chol.device.type == torch.device(dev).type
        run = []
        for _ in range(3):
            es = opt.generate_evaluation_specification()
            run.append(es.configuration["x0"])
            opt.report(es.create_evaluation(objectives={
                "loss": conformance._run_experiment_1d_deterministic(
                    **es.configuration)}))
        xs.append(run)
    np.testing.assert_allclose(xs[1], xs[0], rtol=1e-6)


def test_graph_kernel_nodes_hold_each_captured_launch(cuda):
    """``kernel_nodes`` reads from a captured graph one ``select`` node
    for each launch that the wrapper counted while capturing."""
    from scamlgp_tpu_torch.utils.cuda_graph import kernel_nodes
    A = torch.as_tensor(_spd_batch(np.random.default_rng(0), 8, 4),
                        device=cuda)
    sweep.sweep_inverse(A)      # builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = sweep.sweep_inverse.launches["select"]
    with torch.cuda.graph(graph):
        for _ in range(3):
            inv, _ = sweep.sweep_inverse(A)
    assert sweep.sweep_inverse.launches["select"] == before + 3
    nodes = kernel_nodes(graph)
    assert sum(n for k, n in nodes.items() if "sweep_" in k) == 3, nodes
    graph.replay()
    torch.cuda.synchronize()
    inv_p, _ = sweep.sweep_inverse_reference(A)
    assert (inv - inv_p).abs().max().item() <= 1e-4 * \
        inv_p.abs().max().item()


PROBE_NS = [1, 5, 8, 9, 16, 31, 32, 33, 40, 64, 65, 96, 100, 127, 128]


def _symmetric_spd(rng, b, n):
    A = _spd_batch(rng, b, n)
    return 0.5 * (A + A.transpose(0, 2, 1))


@pytest.mark.parametrize("n", PROBE_NS)
def test_rank1_cholesky_kernel_matches_plain(cuda, n):
    """The Cholesky probe against its panel recurrence
    (``blocked_cholesky_mirror``) and its plain version, within 1e-5
    max|L| each (the kernel fuses each multiply-subtract, the two do not;
    ``rsqrtf`` may round otherwise than ``torch.rsqrt``), and the library
    factor (rel 1e-4), on both paths, every warp capacity, ragged panels
    (N % 32 != 0) and N % 4 != 0 (4-byte copies), a batch (37) that is no
    multiple of the matrices a CTA owns; the strict upper triangle zero."""
    A = torch.as_tensor(_symmetric_spd(np.random.default_rng(n), 37, n),
                        device=cuda)
    before = probes.rank1_cholesky.launches
    L = probes.rank1_cholesky(A)
    torch.cuda.synchronize()
    assert probes.rank1_cholesky.launches == before + 1
    Lp = probes.rank1_cholesky_reference(A)
    scale = Lp.abs().max().item()
    assert (L - Lp).abs().max().item() <= 1e-5 * scale
    assert (L - probes.blocked_cholesky_mirror(A)).abs().max().item() <= \
        1e-5 * scale
    ref = torch.linalg.cholesky(A)
    assert (L - ref).abs().max().item() < 1e-4 * ref.abs().max().item()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))


@pytest.mark.parametrize("n", [40, 128])
def test_rank1_cholesky_kernel_on_a_misaligned_view(cuda, n):
    """A contiguous view 4 bytes past an aligned start takes the 4-byte
    copies and stores, and gives the aligned launch's bits; a non-positive
    pivot gives NaN in its matrix only."""
    A = torch.as_tensor(_symmetric_spd(np.random.default_rng(n), 5, n),
                        device=cuda)
    buf = torch.empty(A.numel() + 1, device=cuda)
    buf[1:] = A.reshape(-1)
    view = buf[1:].view(A.shape)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(probes.rank1_cholesky(view), probes.rank1_cholesky(A))
    A[2, 3, 3] = -1.0
    L = probes.rank1_cholesky(A)
    assert torch.isnan(L[2]).any()
    assert torch.isfinite(L[[0, 1, 3, 4]]).all()


@pytest.mark.parametrize("n", PROBE_NS)
def test_traversal_floor_kernel_matches_its_fma_recurrence(cuda, n):
    """One FMA an element a step: bit for bit the float32 FMA recurrence
    (``traversal_floor_fma_reference``), 16-byte runs and the scalar tail
    (37 n^2 is odd at odd n), and on a view 4 bytes past an aligned start
    (single elements); within n ulps of the unfused plain version, which
    rounds each step's product apart (1 ulp a step, the first step exact)."""
    A = torch.as_tensor(_symmetric_spd(np.random.default_rng(n), 37, n),
                        device=cuda)
    before = probes.traversal_floor.launches
    out = probes.traversal_floor(A)
    torch.cuda.synchronize()
    assert probes.traversal_floor.launches == before + 1
    assert torch.equal(out, probes.traversal_floor_fma_reference(A))
    buf = torch.empty(A.numel() + 1, device=cuda)
    buf[1:] = A.reshape(-1)
    assert torch.equal(probes.traversal_floor(buf[1:].view(A.shape)), out)
    plain = probes.traversal_floor_reference(A)
    big = torch.maximum(A.abs(), plain.abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    assert ((out - plain).abs() / ulp).max().item() <= n


@pytest.mark.parametrize("n", PROBE_NS)
def test_traversal_floor_kernel_equals_plain_bit_for_bit(cuda, n):
    """The first floor kernel (``baseline_kernels.cu``): a multiply, then an
    add, rounded apart on both sides (__fmul_rn, __fadd_rn)."""
    from scamlgp_tpu_torch.profile_kernels import PROBE_BASELINES
    A = torch.as_tensor(_symmetric_spd(np.random.default_rng(n), 37, n),
                        device=cuda)
    out = PROBE_BASELINES["traversal_floor"](A)
    torch.cuda.synchronize()
    assert torch.equal(out, probes.traversal_floor_reference(A))


@pytest.mark.parametrize("n", [8, 32, 40, 128])
def test_baseline_rank1_cholesky_matches_plain(cuda, n):
    """The first Cholesky probe kernel, kept to be timed beside the new
    one, still computes its plain version's factor (within 1e-5 max|L|)."""
    from scamlgp_tpu_torch.profile_kernels import PROBE_BASELINES
    A = torch.as_tensor(_symmetric_spd(np.random.default_rng(n), 37, n),
                        device=cuda)
    L = PROBE_BASELINES["rank1_cholesky"](A)
    torch.cuda.synchronize()
    Lp = probes.rank1_cholesky_reference(A)
    assert (L - Lp).abs().max().item() <= 1e-5 * Lp.abs().max().item()


def test_probe_kernel_geometry_is_select_s(cuda):
    """The first probe kernels keep the select kernel's layout at every N."""
    from scamlgp_tpu_torch.profile_kernels import baseline_probe_geometry
    for n in range(1, 129):
        want = sweep.launch_geometry(n)
        got = baseline_probe_geometry(n)
        assert got == {k: want[k] for k in got}, n


def test_probe_kernel_geometry_is_the_wrappers(cuda):
    """The built probe kernels report ``probes.launch_geometry``'s launch."""
    for name in probes.KERNELS:
        for B in (1, 37, 4096):
            for n in range(1, 129):
                want = probes.launch_geometry(name, B, n)
                got = probes.kernel_geometry(name, B, n)
                assert got == {k: want[k] for k in got}, (name, B, n)


@pytest.mark.parametrize("n", [33, 128])
def test_probe_profiling_build_computes_the_same(cuda, n):
    """The Cholesky probe built with -DPROBE_PROFILE gives the default
    build's bits and stamps every warp of every CTA."""
    import ctypes

    from scamlgp_tpu_torch.ops import cuda_build
    from scamlgp_tpu_torch.profile_kernels import (PROBE_PHASES,
                                                   PROBE_PROFILE_FLAGS)
    A = torch.as_tensor(_symmetric_spd(np.random.default_rng(n), 9, n),
                        device=cuda)
    lib = cuda_build.load("probe_kernels", PROBE_PROFILE_FLAGS)
    lib.probe_profile_reset.restype = ctypes.c_int
    lib.probe_profile_read.argtypes = [ctypes.c_void_p]
    lib.probe_profile_read.restype = ctypes.c_int
    assert lib.probe_profile_reset() == 0
    L = probes._launch("rank1_cholesky", A, PROBE_PROFILE_FLAGS)
    torch.cuda.synchronize()
    totals = (ctypes.c_ulonglong * (len(PROBE_PHASES) + 1))()
    assert lib.probe_profile_read(ctypes.addressof(totals)) == 0
    warps = probes.launch_geometry("rank1_cholesky", 9, n)["threads"] // 32
    assert totals[len(PROBE_PHASES)] == 9 * warps
    assert all(totals[i] > 0 for i in range(len(PROBE_PHASES)))
    assert torch.equal(L, probes.rank1_cholesky(A))


@pytest.mark.parametrize("wrapper", [probes.rank1_cholesky,
                                     probes.traversal_floor])
def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda, wrapper):
    before = probes.kernel_launches()
    with pytest.raises(ValueError):
        wrapper(torch.eye(130, device=cuda).expand(2, 130, 130).contiguous())
    with pytest.raises(TypeError):
        wrapper(torch.eye(4, device=cuda, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        wrapper(torch.eye(4, device=cuda)[None].transpose(1, 2)
                .expand(2, 4, 4))
    assert wrapper(torch.empty((0, 4, 4), device=cuda)).shape == (0, 4, 4)
    assert probes.kernel_launches() == before
