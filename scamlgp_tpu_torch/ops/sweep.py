"""Batched SPD inverse and log-determinant by the sweep operator.

Port of ``scamlgp_tpu/ops/pallas_sweep.py``.  ``sweep_inverse`` maps a batch
of SPD matrices A (B, N, N), N <= 128, to (A^{-1}, log|A|):

- on a CUDA tensor it launches the hand-written kernel
  ``csrc/sweep_inverse.cu`` (the port of the TPU kernel ``_sweep_kernel``,
  ``pallas_sweep.py:96``), or raises;
- on a CPU tensor it runs ``sweep_inverse_reference``, the same recurrence
  as one vectorized torch step per pivot.

The kernel keeps one matrix per CTA in shared memory for all N pivots, so
device memory sees one read and one write of the batch; its bound on the
card and what the design does about it are set out in the source.  The
reference's G-matrices-per-program batching and identity padding
(``_choose_g``, ``_pad_batch``) existed for the TPU's VMEM and are not
carried over.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scamlgp_tpu_torch.ops import cuda_build
from scamlgp_tpu_torch.ops.linalg import cholesky

#: Largest N routed through the sweep (``pallas_sweep.py:72``), kept for
#: parity with the reference's routing until an H100 measurement moves it.
_SWEEP_MAX_N = 128


def sweep_profitable(N: int) -> bool:
    """Whether the sweep route serves this system size.  At N <= 128 one
    matrix fits one CTA's shared memory in f32 and f64 alike (at most
    130 KiB of Hopper's 227 KiB), so N alone decides."""
    return N <= _SWEEP_MAX_N


def sweep_inverse_reference(A: torch.Tensor):
    """Plain PyTorch sweep: the kernel's recurrence, one vectorized step per
    pivot.  A: (B, N, N) -> (A^{-1} (B, N, N), log|A| (B,))."""
    B, N, _ = A.shape
    A = A.clone()
    logdet = torch.zeros(B, dtype=A.dtype, device=A.device)
    for k in range(N):
        col = A[:, :, k].clone()
        row = A[:, k, :].clone()
        d = row[:, k]
        inv_d = 1.0 / d
        cd = col * inv_d[:, None]
        A = A - cd[:, :, None] * row[:, None, :]
        A[:, :, k] = cd
        A[:, k, :] = row * inv_d[:, None]
        A[:, k, k] = -inv_d
        logdet = logdet + torch.log(d)
    return -A, logdet


_C_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = cuda_build.load("sweep_inverse")
    for name in ("sweep_inverse_f32", "sweep_inverse_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _C_ARGS
        fn.restype = ctypes.c_int
    lib.sweep_error_string.argtypes = [ctypes.c_int]
    lib.sweep_error_string.restype = ctypes.c_char_p
    return lib


def sweep_inverse(A: torch.Tensor):
    """(A^{-1}, log|A|) for a batch of SPD matrices A: (B, N, N).

    A CPU tensor goes to ``sweep_inverse_reference``; a CUDA tensor to the
    CUDA kernel, which counts its launches in ``sweep_inverse.launches``.
    """
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"sweep_inverse takes (B, N, N), got {tuple(A.shape)}")
    if A.device.type == "cpu":
        return sweep_inverse_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"sweep_inverse runs on cpu or cuda, not {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep_inverse takes float32 or float64, not {A.dtype}")
    B, N, _ = A.shape
    if not sweep_profitable(N):
        raise ValueError(f"sweep_inverse takes N <= {_SWEEP_MAX_N}, got {N}")
    if not A.is_contiguous():
        raise ValueError("sweep_inverse needs a contiguous tensor")
    inv = torch.empty_like(A)
    logdet = torch.empty(B, dtype=A.dtype, device=A.device)
    if B == 0:
        return inv, logdet
    lib = _kernel_fns()
    fn = (lib.sweep_inverse_f32 if A.dtype == torch.float32
          else lib.sweep_inverse_f64)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), inv.data_ptr(), logdet.data_ptr(), B, N,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("sweep_inverse kernel launch failed: "
                           + lib.sweep_error_string(err).decode())
    sweep_inverse.launches += 1
    return inv, logdet


sweep_inverse.launches = 0


def chol_inverse(A: torch.Tensor):
    """Cholesky-based (A^{-1}, log|A|) (``pallas_sweep.py:378-389``): the
    route for N above the sweep's threshold."""
    L = cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Ainv = torch.matmul(Linv.transpose(-1, -2), Linv)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return Ainv, logdet
