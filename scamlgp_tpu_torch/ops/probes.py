"""The two loop-shape probes of the sweep: a rank-1 Cholesky and the
traversal floor.

Ports of the Pallas kernels of ``scripts/bench_chol_fused_probe.py``
(``_chol_kernel``, ``:49``) and ``scripts/bench_vpu_ceiling.py``
(``_floor_kernel``, ``:50``).  Both run N serial steps over a batch of
N x N float32 blocks, N <= 128, held on chip, in the layout of the
``select`` sweep kernel (``csrc/sweep_inverse.cu``): a warp a matrix at
N <= 32, a CTA of 16 x 16 threads with a register tile each at N <= 128,
one barrier a step.  So their times against ``select``'s compare loop
shapes, not implementations (``csrc/probe_kernels.cu``):

- ``rank1_cholesky(A)``: right-looking Cholesky, one rank-1 update a step.
  Step k: d = A[k, k], s = rsqrt(d), c = A[:, k] s, r = A[k, :] s; the
  trailing block (i > k, j > k) loses c r (a multiply, then a subtract);
  column k from the diagonal down becomes c.  The strict upper triangle of
  the result is zeroed, giving L.  How long one N-step loop of a
  factor-then-invert scheme takes, beside the sweep's one loop.
- ``traversal_floor(A)``: N steps of A <- A * 0.9999999 + float32(k) 1e-12
  over the whole block, a multiply pass and an add pass a step: the floor
  of any N-step loop that touches every element of the block once a step.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor its
kernel, counting the launch in ``<wrapper>.launches``, or it raises.  The
plain versions repeat the TPU kernels' operations in their order, one
vectorized step per serial trip; the tests hold them against the Pallas
bodies in interpret mode.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from scamlgp_tpu_torch.ops import cuda_build

#: largest N a kernel takes: one matrix in the registers of one CTA
MAX_N = 128
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
# Kernels
# ---------------------------------------------------------------------------

_C_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p]


@cuda_build.once_per_key
def _kernel_fn(name: str):
    """The C entry point ``<name>_f32`` of ``csrc/probe_kernels.cu`` and the
    library's error-string function."""
    lib = cuda_build.load("probe_kernels")
    fn = getattr(lib, f"{name}_f32")
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    return fn, lib.probe_error_string


def kernel_geometry(N: int) -> dict:
    """The geometry that the built kernels report at N
    (``probe_geometry``), in the keys of ``sweep.launch_geometry``, the
    ``select`` kernel's layout that they keep; the card tests hold the two
    equal."""
    fn = cuda_build.load("probe_kernels").probe_geometry
    out = (ctypes.c_int * 3)()
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    fn(N, ctypes.addressof(out))
    return {"capacity": out[0], "threads": out[1],
            "matrices_per_cta": out[2]}


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
        raise ValueError(f"the {name} kernel holds one matrix in the "
                         f"registers of one CTA: N <= {MAX_N}, got {N}")
    if not A.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    out = torch.empty_like(A)
    if A.shape[0] == 0:
        return out
    fn, err_string = _kernel_fn(name)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], N,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + err_string(err).decode())
    cuda_build.count_launch(vars(wrapper), "launches")
    return out


def rank1_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of A (B, N, N) by the rank-1
    probe: ``rank1_cholesky_reference`` on a CPU tensor, the kernel on a
    float32 CUDA tensor (N <= 128)."""
    return _run("rank1_cholesky", rank1_cholesky, rank1_cholesky_reference,
                A)


def traversal_floor(A: torch.Tensor) -> torch.Tensor:
    """N multiply and add passes over each block of A (B, N, N):
    ``traversal_floor_reference`` on a CPU tensor, the kernel on a float32
    CUDA tensor (N <= 128)."""
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

