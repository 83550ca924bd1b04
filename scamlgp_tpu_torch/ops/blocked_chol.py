"""Batched SPD inverse and log-determinant by a blocked Cholesky.

Port of ``scamlgp_tpu/ops/pallas_blocked_chol.py``, the mid-N route
(192 <= N <= 1024) of the inverse MLL.  ``blocked_chol_inverse`` maps a
batch of SPD matrices A (B, N, N) to (A^{-1}, log|A|):

- on a CUDA tensor it launches one of the two hand-written kernels of
  ``csrc/blocked_chol_inverse.cu``, or raises:

  - ``"smem"`` (the port of ``_make_kernel``, ``pallas_blocked_chol.py:225``)
    keeps the padded lower triangle of one matrix in one CTA's shared
    memory;
  - ``"global"`` (the port of ``_make_hbm_kernel``, ``:244``) keeps the
    blocks in a device buffer (``global_work``) and streams them through
    shared memory, each block column of the factor held there while it
    updates the rest;

  ``variant=None`` takes ``"smem"`` where the blocks fit a CTA's shared
  memory and ``"global"`` elsewhere;
- on a CPU tensor it runs ``blocked_chol_inverse_reference``, the
  reference's ``_inverse_body`` over (B, 64, 64) blocks in plain torch.

Both compute: pad N to a multiple of 64 with an identity block; a
right-looking blocked Cholesky whose diagonal blocks are factored column by
column (their pivots give log|A|); each diagonal block's inverse; W = L^{-1}
by blocked forward substitution; A^{-1} = W^T W.

``blocked_runnable`` and ``blocked_profitable`` keep the reference's routing
window and VMEM arithmetic, so that the port routes exactly as the JAX
package does; the reference's module constant ``_ROUTE_BLOCKED`` is the
argument ``route_blocked`` here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scamlgp_tpu_torch.ops import cuda_build

#: block size of the factorization (``pallas_blocked_chol.py:42``)
BS = 64

#: the reference's routing window (``pallas_blocked_chol.py:63-64``)
_MIN_N = 192
_MAX_N = 1024

# The reference's VMEM model (``pallas_blocked_chol.py:45-59,77-110``), kept
# only so that ``blocked_runnable`` answers as the JAX package does.
_DEFAULT_G = 8
_VMEM_BUDGET = 9_500_000
_VMEM_BUDGET_STAGED = 12_000_000

#: shared memory one CTA may use on Hopper (sm_90: 227 KiB)
SMEM_LIMIT = 232_448

VARIANTS = ("smem", "global")


def _block_values_bytes(N: int, itemsize: int) -> int:
    nb = -(-N // BS)
    blocks = 3 * nb * (nb + 1) // 2 + 2 * nb
    return blocks * BS * BS * itemsize


def _choose_g(B: int, N: int, itemsize: int) -> int:
    npad = -(-N // BS) * BS
    per_g = 4 * npad * npad * itemsize + _block_values_bytes(N, itemsize)
    return min(_DEFAULT_G, B, _VMEM_BUDGET // per_g)


def _hbm_staged_fits(N: int, itemsize: int) -> bool:
    npad = -(-N // BS) * BS
    need = npad * npad * itemsize + _block_values_bytes(N, itemsize)
    return need <= _VMEM_BUDGET_STAGED


def blocked_runnable(N: int, itemsize: int = 4) -> bool:
    """The reference's capability window (``pallas_blocked_chol.py:105``):
    192 <= N <= 1024 and some TPU variant fits its VMEM budget."""
    if not (_MIN_N <= N <= _MAX_N):
        return False
    return _choose_g(1, N, itemsize) >= 1 or _hbm_staged_fits(N, itemsize)


def blocked_profitable(N: int, itemsize: int = 4,
                       route_blocked: bool = False) -> bool:
    """Whether routing picks the blocked kernel at this N
    (``pallas_blocked_chol.py:113``); off unless ``route_blocked``, as the
    reference's ``_ROUTE_BLOCKED`` is."""
    return route_blocked and blocked_runnable(N, itemsize)


def smem_bytes(N: int, itemsize: int) -> int:
    """Shared memory of the ``smem`` variant: the nb(nb+1)/2 lower blocks
    of the padded matrix and the diagonal factorization's eight BS-vectors
    (``csrc/blocked_chol_inverse.cu::launch_smem``)."""
    nb = -(-N // BS)
    return (nb * (nb + 1) // 2 * BS * BS + 8 * BS) * itemsize


def choose_variant(N: int, itemsize: int, variant=None) -> str:
    """``variant``, checked against the shape, or the one that the bytes
    pick: ``smem`` where the blocks fit one CTA, else ``global``.  Where
    both run, the pick is the faster one: at N=256 in float32 ``smem``
    took 1.542 ms at (1024, 256, 256) against ``global``'s 1.618 on one
    H100 80GB HBM3, 700.00 W (``profile_kernels times``; PERF.md, kernel
    table)."""
    fits = smem_bytes(N, itemsize) <= SMEM_LIMIT
    if variant is None:
        return "smem" if fits else "global"
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (smem | global)")
    if variant == "smem" and not fits:
        raise ValueError(
            f"variant 'smem' needs {smem_bytes(N, itemsize)} bytes of shared "
            f"memory at N={N}, itemsize={itemsize}; a CTA has {SMEM_LIMIT}")
    return variant


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _pad_to_identity(A: torch.Tensor, Np: int) -> torch.Tensor:
    """blockdiag(A, I): the padding's inverse is I and adds 0 to log|A|
    (``pallas_blocked_chol.py:273``)."""
    B, N, _ = A.shape
    if Np == N:
        return A
    out = torch.zeros((B, Np, Np), dtype=A.dtype, device=A.device)
    out[:, :N, :N] = A
    idx = torch.arange(N, Np, device=A.device)
    out[:, idx, idx] = 1.0
    return out


def _chol_block(P: torch.Tensor):
    """Lower Cholesky factor of each (B, BS, BS) block, one rank-1 downdate
    per column, and sum(log pivot) (``_chol_block``,
    ``pallas_blocked_chol.py:120``)."""
    P = P.clone()
    n = P.shape[-1]
    ar = torch.arange(n, device=P.device)
    logdet = torch.zeros(P.shape[0], dtype=P.dtype, device=P.device)
    for j in range(n):
        d = P[:, j, j]
        inv_sd = torch.rsqrt(d)[:, None]
        below = (ar > j).to(P.dtype)
        lcol = P[:, :, j] * inv_sd * below
        lrow = P[:, j, :] * inv_sd * below
        P = P - lcol[:, :, None] * lrow[:, None, :]
        P[:, :, j] = lcol
        P[:, j, j] = torch.sqrt(d)
        logdet = logdet + torch.log(d)
    return torch.tril(P), logdet


def _triinv_block(L: torch.Tensor) -> torch.Tensor:
    """X = L^{-1} of lower-triangular (B, BS, BS) blocks by row-wise forward
    substitution, X[j, :] = (e_j - L[j, :] X) / L[j, j]
    (``_triinv_block``, ``pallas_blocked_chol.py:151``)."""
    n = L.shape[-1]
    X = torch.zeros_like(L)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    for j in range(n):
        s = torch.matmul(L[:, j:j + 1, :], X)[:, 0]
        X[:, j, :] = (eye[j] - s) / L[:, j, j:j + 1]
    return X


def blocked_chol_inverse_reference(A: torch.Tensor):
    """Plain PyTorch blocked-Cholesky inverse, the reference's
    ``_inverse_body`` (``pallas_blocked_chol.py:169-222``) over
    (B, BS, BS) blocks.  A: (B, N, N) -> (A^{-1} (B, N, N), log|A| (B,))."""
    B, N, _ = A.shape
    Np = -(-N // BS) * BS
    nb = Np // BS
    Ap = _pad_to_identity(A, Np)

    def blk(i, j):
        return Ap[:, i * BS:(i + 1) * BS, j * BS:(j + 1) * BS]

    def mt(X):
        return X.transpose(1, 2)

    Ab = {(i, j): blk(i, j) for i in range(nb) for j in range(i + 1)}
    L, Linv = {}, {}
    logdet = torch.zeros(B, dtype=A.dtype, device=A.device)
    for b in range(nb):
        Lbb, ld = _chol_block(Ab[(b, b)])
        logdet = logdet + ld
        Li = _triinv_block(Lbb)
        L[(b, b)], Linv[(b, b)] = Lbb, Li
        for i in range(b + 1, nb):
            L[(i, b)] = torch.matmul(Ab[(i, b)], mt(Li))
        for i in range(b + 1, nb):
            for j in range(b + 1, i + 1):
                Ab[(i, j)] = Ab[(i, j)] - torch.matmul(L[(i, b)],
                                                       mt(L[(j, b)]))
    W = {}
    for i in range(nb):
        W[(i, i)] = Linv[(i, i)]
        for j in range(i):
            S = torch.matmul(L[(i, j)], W[(j, j)])
            for k in range(j + 1, i):
                S = S + torch.matmul(L[(i, k)], W[(k, j)])
            W[(i, j)] = -torch.matmul(Linv[(i, i)], S)
    inv = torch.empty((B, Np, Np), dtype=A.dtype, device=A.device)
    for i in range(nb):
        for j in range(i + 1):
            V = torch.matmul(mt(W[(i, i)]), W[(i, j)])
            for k in range(i + 1, nb):
                V = V + torch.matmul(mt(W[(k, i)]), W[(k, j)])
            inv[:, i * BS:(i + 1) * BS, j * BS:(j + 1) * BS] = V
            inv[:, j * BS:(j + 1) * BS, i * BS:(i + 1) * BS] = mt(V)
    return inv[:, :N, :N], logdet


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def kernel_lib(extra: tuple = ()):
    """The kernel library built with ``extra`` nvcc flags, its entry points
    typed for ctypes."""
    lib = cuda_build.load("blocked_chol_inverse", extra)
    for dt in ("f32", "f64"):
        smem = getattr(lib, f"blocked_chol_inverse_smem_{dt}")
        smem.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
        smem.restype = ctypes.c_int
        glob = getattr(lib, f"blocked_chol_inverse_global_{dt}")
        glob.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
        glob.restype = ctypes.c_int
    lib.blocked_chol_error_string.argtypes = [ctypes.c_int]
    lib.blocked_chol_error_string.restype = ctypes.c_char_p
    return lib


def blocked_chol_inverse(A: torch.Tensor, variant=None):
    """(A^{-1}, log|A|) for a batch of SPD matrices A: (B, N, N).

    A CPU tensor goes to ``blocked_chol_inverse_reference``; a CUDA tensor
    to the kernel of ``variant`` (``None``: chosen by bytes, see
    ``choose_variant``), which counts its launches in
    ``blocked_chol_inverse.launches[variant]``.  A variant that cannot take
    the shape raises, on either device.
    """
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(
            f"blocked_chol_inverse takes (B, N, N), got {tuple(A.shape)}")
    B, N, _ = A.shape
    variant = choose_variant(N, A.element_size(), variant)
    if A.device.type == "cpu":
        return blocked_chol_inverse_reference(A)
    if A.device.type != "cuda":
        raise ValueError(
            f"blocked_chol_inverse runs on cpu or cuda, not {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"blocked_chol_inverse takes float32 or float64, not {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("blocked_chol_inverse needs a contiguous tensor")
    out = _launch(A, variant)
    blocked_chol_inverse.launches[variant] += 1
    return out


def global_work(A: torch.Tensor) -> torch.Tensor:
    """The device buffer that the ``global`` kernel works in, apart from A
    and the output: Np^2 elements a matrix (Np = 64 ceil(N / 64)), the
    nb(nb+1)/2 lower 64 x 64 blocks of its factor and the nb(nb-1)/2
    strictly lower blocks of W = L^{-1}, a block's elements contiguous."""
    B, N, _ = A.shape
    Np = -(-N // BS) * BS
    return torch.empty((B, Np, Np), dtype=A.dtype, device=A.device)


def _launch(A: torch.Tensor, variant: str, lib=None):
    """Runs ``variant``'s kernel on a checked, contiguous CUDA batch;
    counts nothing (``blocked_chol_inverse`` counts its own launches).
    ``lib``: another build of the source (``kernel_lib(extra)``)."""
    B, N, _ = A.shape
    inv = torch.empty_like(A)
    logdet = torch.empty(B, dtype=A.dtype, device=A.device)
    if B == 0:
        return inv, logdet
    lib = lib or kernel_lib()
    dt = "f32" if A.dtype == torch.float32 else "f64"
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "smem":
            err = getattr(lib, f"blocked_chol_inverse_smem_{dt}")(
                A.data_ptr(), inv.data_ptr(), logdet.data_ptr(), B, N, stream)
        else:
            err = getattr(lib, f"blocked_chol_inverse_global_{dt}")(
                A.data_ptr(), global_work(A).data_ptr(), inv.data_ptr(),
                logdet.data_ptr(), B, N, stream)
    if err != 0:
        raise RuntimeError(f"blocked_chol_inverse ({variant}) kernel launch "
                           "failed: "
                           + lib.blocked_chol_error_string(err).decode())
    return inv, logdet


blocked_chol_inverse.launches = {v: 0 for v in VARIANTS}
