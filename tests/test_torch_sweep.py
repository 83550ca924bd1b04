"""Port parity: the sweep inverse and the analytic-gradient MLL.

- The plain torch sweep against the TPU kernel body ``_sweep_kernel`` run
  through ``pallas_call(..., interpret=True)`` (float32, atol 5e-5, as
  ``tests/test_sweep.py`` holds the kernel against numpy) and against numpy
  float64 (rtol 1e-10).
- ``mll_via_inverse`` value and gradient against the JAX ``mll_via_inverse``
  called with a batch-shaped ``n_active``, rtol 1e-9.

The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import scamlgp_tpu.ops.pallas_sweep as ps
from scamlgp_tpu.ops import inverse_mll as jim
from scamlgp_tpu_torch.ops import inverse_mll as tim
from scamlgp_tpu_torch.ops import sweep as tsw
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64


def _spd_batch(rng, b, n, jitter=0.5):
    X = rng.normal(size=(b, n, n)).astype(np.float32)
    return np.einsum("bij,bkj->bik", X, X) / n + jitter * np.eye(
        n, dtype=np.float32)


def _run_pallas_sweep(A, g):
    b, n, _ = A.shape
    return pl.pallas_call(
        ps._sweep_kernel,
        out_shape=(jax.ShapeDtypeStruct((b, n, n), jnp.float32),
                   jax.ShapeDtypeStruct((b, 1), jnp.float32)),
        grid_spec=pl.GridSpec(
            grid=(b // g,),
            in_specs=[pl.BlockSpec((g, n, n), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=(pl.BlockSpec((g, n, n), lambda i: (i, 0, 0),
                                    memory_space=pltpu.VMEM),
                       pl.BlockSpec((g, 1), lambda i: (i, 0),
                                    memory_space=pltpu.VMEM)),
        ),
        interpret=True,
    )(jnp.asarray(A))


@pytest.mark.parametrize("n", [8, 32])
def test_plain_sweep_matches_pallas_kernel_f32(n):
    A = _spd_batch(np.random.default_rng(n), 8, n)
    inv_j, ld_j = _run_pallas_sweep(A, 4)
    inv_t, ld_t = tsw.sweep_inverse_reference(torch.as_tensor(A))
    assert inv_t.dtype == torch.float32
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), atol=5e-5)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j[:, 0]),
                               atol=5e-5)


@pytest.mark.parametrize("n", [1, 8, 40])
def test_plain_sweep_matches_numpy_f64(n):
    A = _spd_batch(np.random.default_rng(n + 100), 6, n).astype(np.float64)
    inv_t, ld_t = tsw.sweep_inverse(torch.as_tensor(A))   # CPU: plain path
    np.testing.assert_allclose(inv_t.numpy(), np.linalg.inv(A), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ld_t.numpy(), np.linalg.slogdet(A)[1],
                               rtol=1e-10)


def test_sweep_of_indefinite_matrix_gives_nan_logdet():
    A = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=F64)
    _, ld = tsw.sweep_inverse(A)
    assert torch.isnan(ld).all()


def test_chol_inverse_matches_numpy():
    A = _spd_batch(np.random.default_rng(3), 3, 20).astype(np.float64)
    inv, ld = tsw.chol_inverse(torch.as_tensor(A))
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(A), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(A)[1],
                               rtol=1e-10)


def test_sweep_routing():
    assert tsw.sweep_profitable(128) and tsw.sweep_profitable(40)
    assert not tsw.sweep_profitable(129)
    assert tim.inverse_mll_profitable(128, 4)
    assert not tim.inverse_mll_profitable(256, 4)
    with pytest.raises(ValueError):
        tsw.sweep_inverse(torch.zeros(3, 4, 5, dtype=F64))


@pytest.mark.parametrize("n", [24, 130])
def test_mll_via_inverse_value_and_grad(n):
    """n = 130 takes the Cholesky-inverse route, n = 24 the sweep."""
    rng = np.random.default_rng(n)
    b = 3
    A = _spd_batch(rng, b, n).astype(np.float64)
    y = rng.normal(size=(b, n))
    n_active = np.full((b,), float(n))

    def jfn(A, y, na):
        return jnp.sum(jim.mll_via_inverse(A, y, na) * jnp.arange(1.0, b + 1))

    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(A), jnp.asarray(y), jnp.asarray(n_active))
    tA, ty, tn = (torch.as_tensor(a).requires_grad_(True)
                  for a in (A, y, n_active))
    tv = torch.sum(tim.mll_via_inverse(tA, ty, tn)
                   * torch.arange(1.0, b + 1, dtype=F64))
    tg = torch.autograd.grad(tv, (tA, ty, tn))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-9)
    for a, g in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=1e-9,
                                   atol=1e-11)


def test_mll_via_inverse_scalar_n_active_cotangent_has_its_shape():
    """The reference returns a (1,)-shaped cotangent for a scalar n_active
    (``ops/inverse_mll.py:107``); the port returns one of shape ()."""
    A = torch.as_tensor(_spd_batch(np.random.default_rng(0), 1, 6)
                        .astype(np.float64))
    y = torch.ones(1, 6, dtype=F64)
    na = torch.tensor(6.0, dtype=F64, requires_grad=True)
    v = tim.mll_via_inverse(A, y, na).sum()
    g, = torch.autograd.grad(v, na)
    assert g.shape == ()
    np.testing.assert_allclose(g.item(), -0.5 * np.log(2 * np.pi),
                               rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_select_kernel_launch_geometry(dtype):
    """The select kernel's launch geometry at every N it takes: a warp path
    with the smallest register capacity that holds N up to N = 32, a CTA of
    16 x 16 threads with 4 x 4 or 8 x 8 register tiles above; the card test
    holds the built kernel to the same rule."""
    seen = {}
    for n in range(1, tsw._SWEEP_MAX_N + 1):
        g = tsw.launch_geometry(n, dtype)
        assert g["capacity"] >= n
        assert g["capacity"] == 8 or g["capacity"] // 2 < n
        if n <= 32:
            assert g["path"] == "warp" and g["threads"] == 128
            assert g["matrices_per_cta"] * g["capacity"] == 128
        else:
            assert g["path"] == "cta" and g["threads"] == 256
            assert g["matrices_per_cta"] == 1
            assert g["tile"] * 16 == g["capacity"]
            assert g["ctas_per_sm"] == (
                1 if dtype == F64 and g["tile"] == 8 else 2)
        seen[g["capacity"]] = seen.get(g["capacity"], 0) + 1
    assert seen == {8: 8, 16: 8, 32: 16, 64: 32, 128: 64}
    for bad in (0, tsw._SWEEP_MAX_N + 1):
        with pytest.raises(ValueError):
            tsw.launch_geometry(bad, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_kernel_launch_geometry_is_selects(dtype):
    """The fused, pair and blocked kernels keep their matrix in registers
    as select does, on select's geometry at every N each takes (the card
    test holds the built kernels to it); an N a scheme does not take and
    an unknown scheme are refused."""
    for n in range(1, tsw._SWEEP_MAX_N + 1):
        want = tsw.launch_geometry(n, dtype, "select")
        assert tsw.launch_geometry(n, dtype, "fused") == want
        if n % 2 == 0:
            assert tsw.launch_geometry(n, dtype, "pair") == want
        if n % tsw.BLOCK == 0:
            got = tsw.launch_geometry(n, dtype, "blocked")
            assert {k: got[k] for k in want} == want
    for variant, n in (("pair", 9), ("blocked", 40)):
        with pytest.raises(ValueError, match="does not take"):
            tsw.launch_geometry(n, dtype, variant)
    with pytest.raises(ValueError, match="unknown sweep variant"):
        tsw.launch_geometry(64, dtype, "rank2")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 8, 30, 32, 34, 40, 64, 66, 126, 128])
def test_pair_kernel_launch_geometry(n, dtype):
    """The pair kernel at even N: a warp path up to N = 32 (CAP lanes a
    matrix, 128 / CAP matrices a CTA of 128 threads), above one matrix a
    CTA of 16 x 16 threads, whose tile rows and columns cover the
    capacity; pairs p, q = p + 1 (p even) fall in one register column of
    two neighbouring threads."""
    g = tsw.launch_geometry(n, dtype, "pair")
    if n <= 32:
        assert g["path"] == "warp" and g["threads"] == 128
        assert g["matrices_per_cta"] * g["capacity"] == 128
    else:
        assert g["path"] == "cta" and g["threads"] == 256
        assert g["matrices_per_cta"] == 1
        assert 16 * g["tile"] == g["capacity"] >= n
        for p in range(0, n, 2):
            assert p // 16 == (p + 1) // 16 and (p + 1) % 16 == p % 16 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [32, 64, 96, 128])
def test_blocked_kernel_launch_geometry(n, dtype):
    """The blocked kernel at N % 32 == 0: N = 32 is one panel on the warp
    path (a lane holds its column of all 32 rows); above, every one of the
    256 threads holds the same number of each panel's rows (rows
    ty + 16 r in register rows 2 b and 2 b + 1), so a panel's pivots keep
    all threads busy; the rank-32 operands fit the shared memory of the
    CTAs an SM runs."""
    g = tsw.launch_geometry(n, dtype, "blocked")
    if n == 32:
        assert g["path"] == "warp" and g["capacity"] == 32
        assert g["matrices_per_cta"] == 4
        assert g["panel_rows_per_thread"] == tsw.BLOCK
        return
    assert g["path"] == "cta" and g["threads"] == 256
    tile, per = g["tile"], g["panel_rows_per_thread"]
    assert per == 2
    for b in range(n // tsw.BLOCK):
        panel = range(tsw.BLOCK * b, tsw.BLOCK * (b + 1))
        for ty in range(16):
            rows = [r for r in range(tile) if ty + 16 * r in panel]
            assert rows == [2 * b, 2 * b + 1][:per]
    itemsize = torch.finfo(dtype).bits // 8
    assert g["shared_bytes"] == tsw.BLOCK * (2 * g["capacity"] + 1) * itemsize
    # the pivot buffers are static: two columns of 32 and two rows of CAP
    static = (2 * tsw.BLOCK + 2 * g["capacity"]) * itemsize
    assert g["ctas_per_sm"] * (g["shared_bytes"] + static) <= 227 * 1024
