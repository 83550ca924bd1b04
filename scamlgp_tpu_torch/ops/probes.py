"""The two loop-shape probes of the sweep: a Cholesky factor and the
traversal floor.

Ports of the Pallas kernels of ``scripts/bench_chol_fused_probe.py``
(``_chol_kernel``, ``:49``) and ``scripts/bench_vpu_ceiling.py``
(``_floor_kernel``, ``:50``), for a batch of N x N float32 blocks,
N <= 128.  The kernels are designed for the card, not in the ``select``
sweep kernel's layout (their first versions were; they stay in
``csrc/baseline_kernels.cu`` as yardsticks), so that their times say what
a Cholesky factor and an N-step pass cost here (``csrc/probe_kernels.cu``):

- ``rank1_cholesky(A)``: the lower Cholesky factor, what the TPU kernel's
  right-looking rank-1 steps compute.  Step k: d = A[k, k], s = rsqrt(d),
  column k from the diagonal down becomes A[:, k] s, the trailing block
  loses the outer product of that column with itself.  The kernel takes
  the steps a warp a matrix at N <= 32 and by panels of 32 columns above:
  the diagonal block's steps, the rows below solved against it, then the
  trailing block's lower triangle updated once a panel
  (``blocked_cholesky_mirror``), each multiply-subtract one rounding.
  The strict upper triangle of the result is zero.  How long the factor
  of a factor-then-invert scheme takes, beside the sweep's one loop.
- ``traversal_floor(A)``: N steps of A <- A * 0.9999999 + float32(k) 1e-12
  over the whole block, one FMA an element a step
  (``traversal_floor_fma_reference``): the floor of any N-step pass that
  touches every element once a step.

On a CPU tensor each wrapper runs its plain version, which repeats the TPU
kernel's operations in their order, one vectorized step per serial trip
(the tests hold them against the Pallas bodies in interpret mode); on a
CUDA tensor its kernel, counting the launch in ``<wrapper>.launches``, or
it raises.  The mirrors are the kernels' own recurrences in plain PyTorch,
for the tests and the smoke only: no wrapper runs them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from scamlgp_tpu_torch.ops import cuda_build

#: largest N a kernel takes: one matrix in the shared memory of one CTA
MAX_N = 128
#: the factor's panel of columns (``csrc/probe_kernels.cu::PANEL``)
PANEL = 32
#: the floor's multiplier and step constant, each rounded to float32 as
#: the TPU kernel's weakly typed literals are
FLOOR_SCALE = float(np.float32(0.9999999))
FLOOR_STEP = np.float32(1e-12)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def rank1_cholesky_reference(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of A (B, N, N) by N rank-1
    steps over the whole block, the Pallas kernel's operations in its
    order.  No pivoting: a non-positive pivot gives NaN."""
    B, N, _ = A.shape
    A = A.clone()
    idx = torch.arange(N, device=A.device)
    for k in range(N):
        col = A[:, :, k:k + 1]                      # (B, N, 1)
        row = A[:, k:k + 1, :]                      # (B, 1, N)
        s = torch.rsqrt(A[:, k:k + 1, k:k + 1])     # (B, 1, 1)
        c = col * s
        r = row * s
        trail = ((idx[:, None] > k) & (idx[None, :] > k)).to(A.dtype)
        A = A - c * r * trail
        A[:, k:, k] = c[:, k:, 0]
    return A * (idx[:, None] >= idx[None, :]).to(A.dtype)


def traversal_floor_reference(A: torch.Tensor) -> torch.Tensor:
    """N steps of A <- A * 0.9999999 + float32(k) * 1e-12 over each block
    of A (B, N, N), each constant and the step's addend rounded to
    float32 as in the Pallas kernel."""
    N = A.shape[-1]
    for k in range(N):
        A = A * FLOOR_SCALE + float(np.float32(k) * FLOOR_STEP)
    return A


# ---------------------------------------------------------------------------
# Mirrors of the kernels' recurrences (tests and smoke only)
# ---------------------------------------------------------------------------

def blocked_cholesky_mirror(A: torch.Tensor, panel: int = PANEL
                            ) -> torch.Tensor:
    """The ``rank1_cholesky`` kernel's panel recurrence on A (B, N, N): the
    lower triangle only, ``panel`` columns at a time: (a) the diagonal
    block's rank-1 steps (s = rsqrt(d); column k from the diagonal down
    times s; the block's trailing lower triangle loses that column's outer
    product); (b) each row below solved against the block in the same
    order (x_k = a_k s_k, then a_m -= x_k L[m, k] for m > k); (c) the
    trailing block's lower triangle loses L21 L21^T, the panel's columns
    one after another.  A ragged last panel is narrower.  The kernel fuses
    each multiply-subtract into one rounding; this rounds the product and
    the difference apart.  The strict upper triangle of the result is
    zero; a non-positive pivot gives NaN."""
    N = A.shape[-1]
    A = torch.tril(A)
    for c0 in range(0, N, panel):
        c1 = min(c0 + panel, N)
        s = {}
        for k in range(c0, c1):
            s[k] = torch.rsqrt(A[:, k, k])[:, None]
            A[:, k:c1, k] = A[:, k:c1, k] * s[k]
            c = A[:, k + 1:c1, k]
            A[:, k + 1:c1, k + 1:c1] -= torch.tril(c[:, :, None]
                                                   * c[:, None, :])
        if c1 == N:
            break
        for k in range(c0, c1):
            A[:, c1:, k] = A[:, c1:, k] * s[k]
            A[:, c1:, k + 1:c1] -= (A[:, c1:, k:k + 1]
                                    * A[:, k + 1:c1, k][:, None, :])
        for k in range(c0, c1):
            c = A[:, c1:, k]
            A[:, c1:, c1:] -= torch.tril(c[:, :, None] * c[:, None, :])
    return A


def _fma_to_f32(p: torch.Tensor, c: float) -> torch.Tensor:
    """p + c rounded once to float32, p a float64 tensor and c a float64
    scalar: the float64 sum rounded to odd (an inexact sum whose last bit
    is even moves one float64 ulp toward the exact sum, from the TwoSum
    error), then to float32 to nearest.  53 >= 24 + 2 bits, so the two
    roundings give the one rounding of the exact sum: no float32 tie is
    made by the first."""
    t = p + c
    bb = t - p
    err = (p - (t - bb)) + (c - bb)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(t, float("inf")),
                         torch.full_like(t, float("-inf")))
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    return t.to(torch.float32)


def traversal_floor_fma_reference(A: torch.Tensor) -> torch.Tensor:
    """The ``traversal_floor`` kernel's recurrence on float32 A (B, N, N):
    N steps of A <- fma(A, 0.9999999, float32(k) 1e-12), one rounding a
    step.  Each step is (A.double() * s + c).float(): the product of two
    float32 values is exact in float64, and the sum is rounded to odd in
    float64 before float32 (``_fma_to_f32``), so that the step is an FMA
    in every case."""
    if A.dtype != torch.float32:
        raise TypeError(f"the FMA recurrence is float32's, not {A.dtype}")
    N = A.shape[-1]
    for k in range(N):
        A = _fma_to_f32(A.double() * FLOOR_SCALE,
                        float(np.float32(k) * FLOOR_STEP))
    return A


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_C_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p]


@cuda_build.once_per_key
def _kernel_fn(name: str, extra: tuple = ()):
    """The C entry point ``<name>_f32`` of ``csrc/probe_kernels.cu`` built
    with ``extra`` flags, and the library's error-string function."""
    lib = cuda_build.load("probe_kernels", extra)
    fn = getattr(lib, f"{name}_f32")
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    return fn, lib.probe_error_string


def launch_geometry(name: str, B: int, N: int) -> dict:
    """How the kernel ``name`` is launched at (B, N, N), the rule of
    ``csrc/probe_kernels.cu::cholesky_geometry`` and ``floor_geometry``:
    ``capacity`` (the factor: CAP = 8, 16 or 32 lanes a matrix on the warp
    path, N <= 32; NP = N rounded up to a panel on the blocked path; the
    floor: the elements a thread, in 16-byte runs), ``threads`` a CTA,
    ``matrices_per_cta`` (0 for the floor, which walks the flat batch),
    dynamic ``shared_bytes`` (the blocked path's lower 32 x 32 tiles, each
    row 36 floats, then two panels' pivot factors and the factor's two
    column buffers) and ``ctas``."""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the probe kernels take 1 <= N <= {MAX_N}, got {N}")
    if name == "traversal_floor":
        per_thread = 32
        return {"path": "flat", "capacity": per_thread, "threads": 256,
                "matrices_per_cta": 0, "shared_bytes": 0,
                "ctas": -(-B * N * N // (256 * per_thread))}
    if name != "rank1_cholesky":
        raise ValueError(f"unknown probe kernel {name!r}")
    if N <= 32:
        cap = 8 if N <= 8 else 16 if N <= 16 else 32
        return {"path": "warp", "capacity": cap, "threads": 128,
                "matrices_per_cta": 128 // cap, "shared_bytes": 0,
                "ctas": -(-B // (128 // cap))}
    panels = -(-N // PANEL)
    tiles = panels * (panels + 1) // 2
    return {"path": "blocked", "capacity": panels * PANEL, "threads": 192,
            "matrices_per_cta": 1,
            "shared_bytes": (tiles * PANEL * (PANEL + 4) + 4 * PANEL) * 4,
            "ctas": B}


def kernel_geometry(name: str, B: int, N: int) -> dict:
    """The geometry that the built kernel ``name`` reports at (B, N, N)
    (``probe_geometry``), in ``launch_geometry``'s keys; the card tests
    hold the two equal."""
    fn = cuda_build.load("probe_kernels").probe_geometry
    out = (ctypes.c_longlong * 5)()
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = None
    fn(KERNELS.index(name), B, N, ctypes.addressof(out))
    return dict(zip(("capacity", "threads", "matrices_per_cta",
                     "shared_bytes", "ctas"), out))


def _launch(name: str, A: torch.Tensor, extra: tuple = ()) -> torch.Tensor:
    """One launch of the kernel ``name`` (its source built with ``extra``
    flags) on a float32 CUDA tensor that the wrapper has checked; counts
    nothing."""
    out = torch.empty_like(A)
    if A.shape[0] == 0:
        return out
    fn, err_string = _kernel_fn(name, extra)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[-1],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + err_string(err).decode())
    return out


def _run(name: str, wrapper, plain, A: torch.Tensor) -> torch.Tensor:
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{name} takes (B, N, N), got {tuple(A.shape)}")
    if A.device.type == "cpu":
        return plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes float32, not {A.dtype}")
    N = A.shape[-1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the {name} kernel takes N <= {MAX_N}, got {N}")
    if not A.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    out = _launch(name, A)
    if A.shape[0]:
        cuda_build.count_launch(vars(wrapper), "launches")
    return out


def rank1_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of A (B, N, N):
    ``rank1_cholesky_reference`` on a CPU tensor, the kernel (by panels,
    ``blocked_cholesky_mirror``'s recurrence) on a float32 CUDA tensor
    (N <= 128)."""
    return _run("rank1_cholesky", rank1_cholesky, rank1_cholesky_reference,
                A)


def traversal_floor(A: torch.Tensor) -> torch.Tensor:
    """N multiply-add passes over each block of A (B, N, N):
    ``traversal_floor_reference`` on a CPU tensor, the kernel (one FMA an
    element a step, ``traversal_floor_fma_reference``) on a float32 CUDA
    tensor (N <= 128)."""
    return _run("traversal_floor", traversal_floor, traversal_floor_reference,
                A)


rank1_cholesky.launches = 0
traversal_floor.launches = 0

#: the probe kernels' wrappers, each named as its launch counter
KERNELS = ("rank1_cholesky", "traversal_floor")


def kernel_launches() -> dict:
    """Launches so far of each probe kernel (of the wrapper that this
    module holds under its name now)."""
    return {name: globals()[name].launches for name in KERNELS}


def reset_kernel_launches() -> None:
    for name in KERNELS:
        globals()[name].launches = 0

