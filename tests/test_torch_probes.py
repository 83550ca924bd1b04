"""Port parity: the loop-shape probes (``ops/probes.py``) against the Pallas
kernels of ``scripts/bench_chol_fused_probe.py`` (``_chol_kernel``) and
``scripts/bench_vpu_ceiling.py`` (``_floor_kernel``).

Each JAX script runs as ``__main__`` at B = N = 16 with one repetition,
``pallas_call`` patched to pass ``interpret=True``, and the callable that
it builds for its kernel is kept; the fixture then calls it on this
file's own seeded numpy SPD batch (made exactly symmetric).  The scripts
build float32 batches only without x64, so the fixture turns x64 off
while they run and restores it.

- The rank-1 Cholesky's plain version against the Pallas body within
  1e-5 max|L| in float32 (the two round rsqrt and the products in their
  own ways), and in float64 against ``numpy.linalg.cholesky`` at 1e-12.
- The traversal floor: XLA's CPU contracts the body's multiply and add
  into one FMA, so the Pallas body is not the plain version's bits.  Held
  instead: the Pallas output equals, bit for bit, the recurrence with one
  rounding a step (computed in numpy with the port's constants); the
  plain version equals the recurrence with a rounded multiply, then a
  rounded add, bit for bit; from every state of the trajectory one step
  of the two lies within 1 ulp; after the 16 steps they lie within 16.
- The kernels' mirrors: ``blocked_cholesky_mirror`` (the factor's panel
  recurrence) in float64 equals ``numpy.linalg.cholesky`` and the rank-1
  plain version to 1e-12 at N across the panel boundaries, ragged panels
  included, its strict upper triangle exactly 0, and lies within 1e-5
  max|L| of the Pallas body in float32; ``traversal_floor_fma_reference``
  (one rounding a step) gives the Pallas body's bits, within N ulps of
  the unfused plain version, and its single rounding is exact where a
  plain float64 sum would make a float32 tie.
- The launch rule ``probes.launch_geometry`` (the card tests hold the
  built kernels to it).
- Both probe modules' ``main`` at a tiny size on the CPU print the JAX
  scripts' keys.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``).
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scamlgp_tpu_torch import bench_chol_fused_probe, bench_traversal_floor
from scamlgp_tpu_torch.ops import probes
from scamlgp_tpu_torch.profile_kernels import probe_bound
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = N = 16
SCRIPTS = ("scripts/bench_chol_fused_probe.py", "scripts/bench_vpu_ceiling.py")


def spd(rng, b, n, dtype=np.float32):
    X = rng.normal(size=(b, n, n))
    A = np.einsum("bij,bkj->bik", X, X) / n + 0.5 * np.eye(n)
    return (0.5 * (A + A.transpose(0, 2, 1))).astype(dtype)


@pytest.fixture(scope="module")
def batch():
    return spd(np.random.default_rng(2024), B, N)


@pytest.fixture(scope="module")
def pallas_out(batch):
    """Each kernel's Pallas body, in interpret mode, on ``batch``."""
    kept = {}
    orig = pl.pallas_call

    def interpreted(kernel, *args, **kwargs):
        call = orig(kernel, *args, **{**kwargs, "interpret": True})
        kept.setdefault(kernel.__name__, call)
        return call

    mp = pytest.MonkeyPatch()
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        mp.setattr(pl, "pallas_call", interpreted)
        for path in SCRIPTS:
            mp.setattr(sys, "argv", [path, "--B", str(B), "--N", str(N),
                                     "--reps", "1"])
            runpy.run_path(os.path.join(ROOT, path), run_name="__main__")
        return {name: np.asarray(kept[name](jnp.asarray(batch)))
                for name in ("_chol_kernel", "_floor_kernel")}
    finally:
        mp.undo()
        jax.config.update("jax_enable_x64", x64)


def test_rank1_cholesky_plain_matches_the_pallas_body(batch, pallas_out):
    L = pallas_out["_chol_kernel"]
    Lp = probes.rank1_cholesky_reference(torch.as_tensor(batch)).numpy()
    assert Lp.dtype == np.float32
    assert np.abs(Lp - L).max() <= 1e-5 * np.abs(L).max()
    assert (np.triu(Lp, 1) == 0).all()


@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_rank1_cholesky_reference_f64_matches_numpy(n):
    A = spd(np.random.default_rng(n), 4, n, np.float64)
    L = probes.rank1_cholesky_reference(torch.as_tensor(A)).numpy()
    ref = np.linalg.cholesky(A)
    assert np.abs(L - ref).max() <= 1e-12 * np.abs(ref).max()


def _fused_step(X, k):
    """One step with one rounding: the product exact in float64, the sum
    then rounded to float32."""
    add = np.float32(k) * probes.FLOOR_STEP
    return (X.astype(np.float64) * probes.FLOOR_SCALE
            + np.float64(add)).astype(np.float32)


def _split_step(X, k):
    """One step as the TPU kernel writes it: a rounded multiply, then a
    rounded add."""
    add = np.float32(k) * probes.FLOOR_STEP
    return (X * np.float32(probes.FLOOR_SCALE)) + add


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_traversal_floor_pallas_body_is_the_fused_recurrence(batch,
                                                             pallas_out):
    """The constants and each step's addend are the Pallas body's: with one
    rounding a step (XLA's CPU FMA) the recurrence gives its bits."""
    X = batch
    for k in range(N):
        X = _fused_step(X, k)
    assert np.array_equal(X, pallas_out["_floor_kernel"])


def test_traversal_floor_plain_is_the_split_recurrence(batch, pallas_out):
    """The plain version rounds the multiply and the add apart, bit for bit
    the recurrence so written; one step of it lies within 1 ulp of the
    fused step from every state, and the 16 steps within 16 ulps of the
    Pallas body."""
    plain = probes.traversal_floor_reference(torch.as_tensor(batch)).numpy()
    X, fused = batch, batch
    for k in range(N):
        assert _ulps(_split_step(fused, k), _fused_step(fused, k)).max() <= 1
        X = _split_step(X, k)
        fused = _fused_step(fused, k)
    assert np.array_equal(plain, X)
    assert _ulps(plain, pallas_out["_floor_kernel"]).max() <= N


@pytest.mark.parametrize("wrapper,plain", [
    (probes.rank1_cholesky, probes.rank1_cholesky_reference),
    (probes.traversal_floor, probes.traversal_floor_reference)])
def test_wrappers_run_the_plain_version_on_the_cpu(batch, wrapper, plain):
    """A CPU tensor goes to the plain version and launches nothing; a tensor
    of another shape or device is refused."""
    A = torch.as_tensor(batch)
    before = probes.kernel_launches()
    assert torch.equal(wrapper(A), plain(A))
    assert probes.kernel_launches() == before
    with pytest.raises(ValueError):
        wrapper(A[0])
    with pytest.raises(ValueError):
        wrapper(A.to("meta"))


@pytest.mark.parametrize("name,ms,by", [
    ("rank1_cholesky", 0.1205, "bytes"),
    ("traversal_floor", 0.2564, "operations")])
def test_bounds_at_the_probes_default_shape(name, ms, by):
    """(4096, 128, 128): the factor reads the lower triangle and writes the
    whole of L, 404 MB in 0.1205 ms at 3.35 TB/s, and its N^3 / 3
    operations take 0.021 ms at 67 TFLOP/s; the floor moves 537 MB in
    0.160 ms, and its 2 N^3 operations take 0.256 ms."""
    got, bound_by = probe_bound(name, 4096, 128)
    assert bound_by == by and got == pytest.approx(ms, rel=1e-3)


def test_chol_probe_main_on_the_cpu(capsys):
    out = bench_chol_fused_probe.main(["--B", "8", "--N", "12", "--reps", "1",
                                       "--device", "cpu"])
    keys = {"B", "N", "reps", "chol_ms_per_batch", "sweep_ms_per_batch",
            "chol_over_sweep", "fused_chol_inverse_lower_bound_ms",
            "fused_over_sweep_lower_bound", "verdict",
            "max_abs_err_vs_xla_cholesky", "library_chol_ms"}
    assert keys <= set(out)
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert out["max_abs_err_vs_xla_cholesky"] < 1e-5
    assert out["fused_chol_inverse_lower_bound_ms"] == 2 * out[
        "chol_ms_per_batch"]
    assert '"chol_over_sweep"' in capsys.readouterr().out


def test_floor_probe_main_on_the_cpu():
    out = bench_traversal_floor.main(["--B", "8", "--N", "40", "--reps", "1",
                                      "--device", "cpu"])
    keys = {"B", "N", "reps", "floor_ms_per_batch", "ceiling_evals_per_s",
            "floor_elem_fma_per_s", "floor_unit", "sweep_ms_per_batch",
            "sweep_evals_per_s", "sweep_traversal_equiv",
            "sweep_pct_of_ceiling"}
    assert keys <= set(out)
    assert "VMEM" not in out["floor_unit"]
    assert "32 independent chains" in out["floor_unit"]
    assert "no barrier" in out["floor_unit"]
    assert out["geometry"] == probes.launch_geometry("traversal_floor", 8, 40)
    assert out["sweep_traversal_equiv"] == pytest.approx(
        out["sweep_ms_per_batch"] / out["floor_ms_per_batch"])


MIRROR_NS = [8, 32, 33, 64, 100, 127, 128]


@pytest.mark.parametrize("n", MIRROR_NS)
def test_blocked_cholesky_mirror_f64_matches_numpy_and_rank1(n):
    """The panel recurrence is a Cholesky factor: in float64 it equals
    ``numpy.linalg.cholesky`` and the rank-1 plain version to 1e-12 of
    max|L|, full and ragged last panels alike, the strict upper triangle
    exactly 0."""
    A = spd(np.random.default_rng(100 + n), 3, n, np.float64)
    L = probes.blocked_cholesky_mirror(torch.as_tensor(A)).numpy()
    ref = np.linalg.cholesky(A)
    rank1 = probes.rank1_cholesky_reference(torch.as_tensor(A)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(L - ref).max() <= 1e-12 * scale
    assert np.abs(L - rank1).max() <= 1e-12 * scale
    assert (np.triu(L, 1) == 0).all()


def test_blocked_cholesky_mirror_reads_the_lower_triangle():
    """Only the lower triangle is read, as the kernel reads it: garbage
    above the diagonal changes nothing; a non-positive pivot gives NaN in
    its matrix only."""
    A = torch.as_tensor(spd(np.random.default_rng(5), 3, 70))
    junk = A + torch.triu(torch.full_like(A, 7.0), 1)
    assert torch.equal(probes.blocked_cholesky_mirror(junk),
                       probes.blocked_cholesky_mirror(A))
    A[1, 40, 40] = -1.0
    L = probes.blocked_cholesky_mirror(A)
    assert torch.isnan(L[1]).any()
    assert torch.isfinite(L[0]).all() and torch.isfinite(L[2]).all()


def test_blocked_cholesky_mirror_matches_the_pallas_body(batch, pallas_out):
    L = pallas_out["_chol_kernel"]
    Lm = probes.blocked_cholesky_mirror(torch.as_tensor(batch)).numpy()
    assert Lm.dtype == np.float32
    assert np.abs(Lm - L).max() <= 1e-5 * np.abs(L).max()
    assert (np.triu(Lm, 1) == 0).all()


def test_traversal_floor_fma_reference_is_the_pallas_body(batch, pallas_out):
    """XLA's CPU contracts the Pallas body into one FMA a step: the FMA
    recurrence gives its bits, and lies within N ulps of the unfused plain
    version (one tie a step at most, the first step exact)."""
    A = torch.as_tensor(batch)
    F = probes.traversal_floor_fma_reference(A).numpy()
    assert F.dtype == np.float32
    assert np.array_equal(F, pallas_out["_floor_kernel"])
    assert _ulps(F, pallas_out["_floor_kernel"]).max() <= N
    plain = probes.traversal_floor_reference(A).numpy()
    assert _ulps(F, plain).max() <= N


def test_fma_step_rounds_once():
    """p + c with p = 1 + 2^-24 (a float32 tie) and c tiny: a float64 sum
    rounds c away and the float32 rounding then goes to even (1.0); the
    one rounding of the exact sum goes up, as an FMA does.  On random
    float32 products and addends the step equals the exact sum rounded
    once (``fractions``)."""
    from fractions import Fraction

    tie = torch.tensor([1.0 + 2.0 ** -24, -(1.0 + 2.0 ** -24)],
                       dtype=torch.float64)
    got = probes._fma_to_f32(tie, 2.0 ** -80)
    assert got.tolist() == [1.0 + 2.0 ** -23, -1.0]
    rng = np.random.default_rng(0)
    x = rng.normal(size=2000).astype(np.float32)
    p = torch.as_tensor(x).double() * probes.FLOOR_SCALE
    for k in (0, 1, 77, 127):
        c = float(np.float32(k) * probes.FLOOR_STEP)
        got = probes._fma_to_f32(p, c).numpy()
        for xi, gi in zip(x[:200], got[:200]):
            exact = Fraction(float(xi)) * Fraction(probes.FLOOR_SCALE) \
                + Fraction(c)
            lo = np.float32(float(exact))   # a candidate; check its neighbours
            best = min((np.nextafter(lo, np.float32(-np.inf)), lo,
                        np.nextafter(lo, np.float32(np.inf))),
                       key=lambda f: (abs(Fraction(float(f)) - exact),
                                      int(np.float32(f).view(np.int32)) & 1))
            assert gi == best


@pytest.mark.parametrize("name,B,N,want", [
    ("rank1_cholesky", 4096, 128,
     {"path": "blocked", "capacity": 128, "threads": 192,
      "matrices_per_cta": 1, "shared_bytes": (10 * 32 * 36 + 128) * 4,
      "ctas": 4096}),
    ("rank1_cholesky", 37, 100,
     {"path": "blocked", "capacity": 128, "threads": 192,
      "matrices_per_cta": 1, "shared_bytes": (10 * 32 * 36 + 128) * 4,
      "ctas": 37}),
    ("rank1_cholesky", 37, 33,
     {"path": "blocked", "capacity": 64, "threads": 192,
      "matrices_per_cta": 1, "shared_bytes": (3 * 32 * 36 + 128) * 4,
      "ctas": 37}),
    ("rank1_cholesky", 1024, 32,
     {"path": "warp", "capacity": 32, "threads": 128,
      "matrices_per_cta": 4, "shared_bytes": 0, "ctas": 256}),
    ("rank1_cholesky", 37, 5,
     {"path": "warp", "capacity": 8, "threads": 128,
      "matrices_per_cta": 16, "shared_bytes": 0, "ctas": 3}),
    ("traversal_floor", 4096, 128,
     {"path": "flat", "capacity": 32, "threads": 256,
      "matrices_per_cta": 0, "shared_bytes": 0, "ctas": 8192}),
    ("traversal_floor", 37, 5,
     {"path": "flat", "capacity": 32, "threads": 256,
      "matrices_per_cta": 0, "shared_bytes": 0, "ctas": 1})])
def test_launch_geometry(name, B, N, want):
    """The blocked path's shared memory at N = 128: the 10 lower 32 x 32
    tiles, rows 9 granules apart (an odd count: eight consecutive rows in
    eight bank groups), 46.6 KB with the pivots' and column buffers, four
    CTAs an SM; a ragged N takes the next panel."""
    assert probes.launch_geometry(name, B, N) == want
    with pytest.raises(ValueError):
        probes.launch_geometry(name, B, 129)

