"""Batched SPD inverse and log-determinant by the sweep operator.

Port of ``scamlgp_tpu/ops/pallas_sweep.py``.  ``sweep_inverse(A, variant)``
maps a batch of SPD matrices A (B, N, N), N <= 128, to (A^{-1}, log|A|) by
one of four step schemes, each the port of one TPU kernel:

- ``"select"``: N rank-1 pivots, border writes as selects (``_sweep_kernel``,
  ``pallas_sweep.py:96``) -> ``csrc/sweep_inverse.cu``;
- ``"fused"``: the border writes folded into the bulk pass as a second
  rank-1 term (``_sweep_kernel_fused``, ``:140``);
- ``"pair"``: two pivots per serial trip, N even (``_sweep_kernel_pair``,
  ``:183``);
- ``"blocked"``: 32-pivot panels swept element by element, then a rank-32
  update of the other rows, N % 32 == 0 (``_sweep_kernel_blocked``,
  ``:268``);

the last three -> ``csrc/sweep_variants.cu``.  A variant that the shape does
not allow takes ``"select"``, as the reference's dispatch falls through
(``pallas_sweep.py:428-436``).  On a CUDA tensor the variant's kernel runs,
or the wrapper raises; on a CPU tensor ``sweep_inverse_reference`` runs the
variant's recurrence in plain torch, one vectorized step per serial trip.

Each kernel keeps its matrices in registers for all their pivots, so
device memory sees one read and one write of the batch: a warp a matrix at
N <= 32, a CTA of 16 x 16 threads with a register tile each at N <= 128,
one rule for the four schemes (``launch_geometry``); ``blocked`` also
stages each panel's rank-32 operands in shared memory.  The bound on the
card and what each design does about it are set out in the sources.  The
reference's G-matrices-per-program batching and identity padding
(``_choose_g``, ``_pad_batch``) existed for the TPU's VMEM and are not
carried over.

``SweepInverse`` and ``mll_via_sweep`` are the reference's ``sweep_inverse``
with its analytic VJP (``:454-470``) and ``mll_via_sweep`` (``:473``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from scamlgp_tpu_torch.ops import cuda_build
from scamlgp_tpu_torch.ops.linalg import cholesky

#: Largest N routed through the sweep (``pallas_sweep.py:72``), kept for
#: parity with the reference's routing until an H100 measurement moves it.
_SWEEP_MAX_N = 128

#: step schemes, each the port of one TPU kernel
VARIANTS = ("select", "fused", "pair", "blocked")

#: panel width of the blocked scheme (``pallas_sweep.py:265``)
BLOCK = 32

#: (kernel source, C entry point prefix, error-string function) of each
#: variant
_KERNELS = {
    "select": ("sweep_inverse", "sweep_inverse", "sweep_error_string"),
    "fused": ("sweep_variants", "sweep_fused", "sweep_variants_error_string"),
    "pair": ("sweep_variants", "sweep_pair", "sweep_variants_error_string"),
    "blocked": ("sweep_variants", "sweep_blocked",
                "sweep_variants_error_string"),
}


def sweep_profitable(N: int) -> bool:
    """Whether the sweep route serves this system size.  Every scheme's
    kernel holds one matrix in the registers of one CTA up to N = 128, in
    f32 and f64 alike, so N alone decides."""
    return N <= _SWEEP_MAX_N


def launch_geometry(N: int, dtype: torch.dtype = torch.float32,
                    variant: str = "select") -> dict:
    """How ``variant``'s kernel is launched at an N it takes
    (``resolve_variant``), the rule of ``csrc/sweep_inverse.cu::geometry``
    and ``csrc/sweep_variants.cu::geometry``, one rule for the four
    schemes: the register capacity (the smallest of 8, 16, 32, 64, 128 that
    holds N), the threads of a CTA and the matrices a CTA owns.  Up to
    N = 32 a matrix is CAP lanes of a warp, one column a lane, 128 / CAP
    matrices a CTA of 128 threads; above, one CTA of 16 x 16 threads owns
    one matrix, a ``tile`` x ``tile`` register tile a thread (rows
    ty + 16 r, columns tx + 16 c).  ``ctas_per_sm`` is the CTA path's
    launch bound: two CTAs an SM (at most 128 registers a thread) except
    for the float64 8 x 8 tile, whose 64 doubles need one CTA an SM and up
    to 255.

    ``blocked`` also gives ``panel_rows_per_thread``, the rows of each
    32-row panel that one thread (a lane on the warp path) holds: on the
    CTA path panel b is register rows 2 b and 2 b + 1 of every thread, so a
    panel's pivots keep all 256 threads busy; and, on the CTA path,
    ``shared_bytes``, the dynamic shared memory that stages the panel's
    columns of every row (32 x (CAP + 1), padded) and the swept panel
    (32 x CAP) for the rank-32 update."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown sweep variant {variant!r} "
                         f"({' | '.join(VARIANTS)})")
    if not 1 <= N <= _SWEEP_MAX_N:
        raise ValueError(f"the {variant} kernel takes 1 <= N <= "
                         f"{_SWEEP_MAX_N}, got {N}")
    if resolve_variant(N, variant) != variant:
        raise ValueError(f"the {variant} kernel does not take N = {N} "
                         "(pair: N even; blocked: N % 32 == 0)")
    capacity = next(c for c in (8, 16, 32, 64, 128) if N <= c)
    if capacity <= 32:
        geo = {"path": "warp", "capacity": capacity, "threads": 128,
               "matrices_per_cta": 128 // capacity}
        if variant == "blocked":
            geo["panel_rows_per_thread"] = BLOCK
        return geo
    tile = capacity // 16
    geo = {"path": "cta", "capacity": capacity, "threads": 256,
           "matrices_per_cta": 1, "tile": tile,
           "ctas_per_sm": 1 if (dtype == torch.float64 and tile == 8) else 2}
    if variant == "blocked":
        geo["panel_rows_per_thread"] = BLOCK // 16
        geo["shared_bytes"] = (BLOCK * (capacity + 1) + BLOCK * capacity) * (
            torch.finfo(dtype).bits // 8)
    return geo


def kernel_name(variant: str) -> str:
    """The launch counters' name of ``variant``'s kernel."""
    return "sweep_inverse" if variant == "select" else f"sweep_inverse_{variant}"


def resolve_variant(N: int, variant: str = "select") -> str:
    """The scheme that runs at N: ``blocked`` only where N % 32 == 0,
    ``pair`` only where N is even, else ``select``
    (``pallas_sweep.py:428-436``)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown sweep variant {variant!r} "
                         f"({' | '.join(VARIANTS)})")
    if variant == "blocked" and N % BLOCK:
        return "select"
    if variant == "pair" and N % 2:
        return "select"
    return variant


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _sweep_select(A, logdet):
    N = A.shape[-1]
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
    return A, logdet


def _sweep_fused(A, logdet):
    """A' = A + cd (x) (e_k - row) + e_k (x) (row/d - e_k (1/d + 2))."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    for k in range(N):
        e = eye[k]
        col = A[:, :, k]
        row = A[:, k, :]
        d = row[:, k:k + 1]
        inv_d = 1.0 / d
        cd = col * inv_d
        u = e - row
        w = row * inv_d - e * (inv_d + 2.0)
        A = A + cd[:, :, None] * u[:, None, :] + e[:, None] * w[:, None, :]
        logdet = logdet + torch.log(d[:, 0])
    return A, logdet


def _sweep_pair(A, logdet):
    """Two pivots p = 2kk, q = p + 1 per trip; q's borders after pivot p are
    rebuilt from p's in O(N) (``pallas_sweep.py:194-205``)."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    for p in range(0, N, 2):
        q = p + 1
        e_p, e_q = eye[p], eye[q]
        col_p, col_q = A[:, :, p], A[:, :, q]
        row_p, row_q = A[:, p, :], A[:, q, :]
        d_p = row_p[:, p:p + 1]
        rpq = row_p[:, q:q + 1]
        inv_dp = 1.0 / d_p
        cd_p = col_p * inv_dp
        cdpq = cd_p[:, q:q + 1]
        col_q1 = col_q - cd_p * rpq + e_p * (rpq * inv_dp)
        row_q1 = row_q - cdpq * row_p + e_p * cdpq
        d_q1 = row_q1[:, q:q + 1]
        inv_dq = 1.0 / d_q1
        cd_q = col_q1 * inv_dq
        cdqp = cd_q[:, p:p + 1]
        row_p_fix = row_p * inv_dp - e_p * (inv_dp + 1.0)
        row_q_fix = row_q1 * inv_dq - e_q * (inv_dq + 1.0)
        row_p_fin = row_p_fix - cdqp * row_q1 + e_q * cdqp
        col_p_fin = cd_p - cd_q * cdpq
        A = (A - cd_p[:, :, None] * row_p[:, None, :]
             - cd_q[:, :, None] * row_q1[:, None, :])
        A[:, :, p] = col_p_fin
        A[:, :, q] = cd_q
        A[:, p, :] = row_p_fin
        A[:, q, :] = row_q_fix
        logdet = logdet + torch.log(d_p[:, 0]) + torch.log(d_q1[:, 0])
    return A, logdet


def _sweep_blocked(A, logdet):
    """Per panel of BLOCK pivots: sweep the panel rows [P | Q] element by
    element into W = [-P^-1 | P^-1 Q], then update the other rows as
    [R | S] -> [R P^-1 | S - R P^-1 Q] by batched matmuls
    (``pallas_sweep.py:268-356``)."""
    N = A.shape[-1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    eye_bs = torch.eye(BLOCK, dtype=A.dtype, device=A.device)
    for base in range(0, N, BLOCK):
        blk = slice(base, base + BLOCK)
        P = A[:, blk, :]
        for jj in range(BLOCK):
            k = base + jj
            e_lane = eye[k]
            e_sub = eye_bs[jj][:, None]
            col = P[:, :, k:k + 1]
            row = P[:, jj:jj + 1, :]
            d = row[:, :, k:k + 1]
            inv_d = 1.0 / d
            cd = col * inv_d
            P = (P - cd * row + e_sub * (row * inv_d) + cd * e_lane
                 + (-inv_d - 2.0) * (e_sub * e_lane))
            logdet = logdet + torch.log(d[:, 0, 0])
        W = P
        RB = A[:, :, blk]
        Pinv = -W[:, :, blk]
        M = W.clone()
        M[:, :, blk] = M[:, :, blk] + (Pinv + eye_bs)
        A = A - torch.matmul(RB, M)
        A[:, :, blk] = A[:, :, blk] + torch.matmul(RB, Pinv)
        A[:, blk, :] = W
    return A, logdet


_PLAIN = {"select": _sweep_select, "fused": _sweep_fused, "pair": _sweep_pair,
          "blocked": _sweep_blocked}


def sweep_inverse_reference(A: torch.Tensor, variant: str = "select"):
    """Plain PyTorch sweep: the recurrence of ``variant``'s kernel
    (resolved by ``resolve_variant``), one vectorized step per serial trip.
    A: (B, N, N) -> (A^{-1} (B, N, N), log|A| (B,))."""
    variant = resolve_variant(A.shape[-1], variant)
    logdet = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    out, logdet = _PLAIN[variant](A.clone(), logdet)
    return -out, logdet


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_C_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


@cuda_build.once_per_key
def _kernel_fn(variant: str, dtype: torch.dtype, extra: tuple = ()):
    """The C entry point of ``variant``'s kernel in ``dtype`` (the source
    built with ``extra`` flags), and the library's error-string
    function."""
    source, prefix, err_name = _KERNELS[variant]
    lib = cuda_build.load(source, extra)
    fn = getattr(lib, f"{prefix}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    err = getattr(lib, err_name)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def kernel_geometry(N: int, variant: str = "select") -> dict:
    """The geometry that ``variant``'s built kernel reports at N
    (``sweep_inverse_geometry``, ``sweep_{fused,pair,blocked}_geometry``),
    in ``launch_geometry``'s keys; the card tests hold the two equal."""
    source, prefix, _ = _KERNELS[variant]
    lib = cuda_build.load(source)
    fn = getattr(lib, f"{prefix}_geometry")
    out = (ctypes.c_int * 3)()
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    fn(N, ctypes.addressof(out))
    return {"capacity": out[0], "threads": out[1],
            "matrices_per_cta": out[2]}


def _launch(A: torch.Tensor, variant: str, extra: tuple = ()):
    """Runs ``variant``'s kernel on a checked, contiguous CUDA batch;
    counts nothing (``sweep_inverse`` counts its own launches).
    ``extra``: the nvcc flags of another build of the source (a profiling
    build's ``-D`` macro)."""
    B = A.shape[0]
    inv = torch.empty_like(A)
    logdet = torch.empty(B, dtype=A.dtype, device=A.device)
    if B == 0:
        return inv, logdet
    fn, err_string = _kernel_fn(variant, A.dtype, extra)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), inv.data_ptr(), logdet.data_ptr(), B,
                 A.shape[-1], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_inverse ({variant}) kernel launch failed: "
                           + err_string(err).decode())
    return inv, logdet


def sweep_inverse(A: torch.Tensor, variant: str = "select"):
    """(A^{-1}, log|A|) for a batch of SPD matrices A: (B, N, N).

    ``variant`` picks the step scheme (``resolve_variant`` says which runs
    at this N).  A CPU tensor goes to ``sweep_inverse_reference``; a CUDA
    tensor to the scheme's kernel, which counts its launches in
    ``sweep_inverse.launches[scheme]``, or the wrapper raises.
    """
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"sweep_inverse takes (B, N, N), got {tuple(A.shape)}")
    N = A.shape[-1]
    variant = resolve_variant(N, variant)
    if A.device.type == "cpu":
        return sweep_inverse_reference(A, variant)
    if A.device.type != "cuda":
        raise ValueError(f"sweep_inverse runs on cpu or cuda, not {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep_inverse takes float32 or float64, not {A.dtype}")
    if not sweep_profitable(N):
        raise ValueError(f"sweep_inverse ({variant}) holds one matrix in the "
                         "registers of one CTA (a panel's operands in its "
                         f"shared memory): N <= {_SWEEP_MAX_N}, got {N}")
    if not A.is_contiguous():
        raise ValueError("sweep_inverse needs a contiguous tensor")
    out = _launch(A, variant)
    cuda_build.count_launch(sweep_inverse.launches, variant)
    return out


sweep_inverse.launches = {v: 0 for v in VARIANTS}


class SweepInverse(torch.autograd.Function):
    """``sweep_inverse`` with the reference's analytic VJP (``_sweep_bwd``,
    ``pallas_sweep.py:459-467``): dA = -A^{-1} dAinv A^{-1} + g_logdet
    A^{-1} (A symmetric)."""

    @staticmethod
    def forward(ctx, A, variant="select"):
        Ainv, logdet = sweep_inverse(A, variant)
        ctx.save_for_backward(Ainv)
        return Ainv, logdet

    @staticmethod
    def backward(ctx, dAinv, dlogdet):
        (Ainv,) = ctx.saved_tensors
        term1 = -torch.matmul(torch.matmul(Ainv, dAinv), Ainv)
        return term1 + dlogdet[:, None, None] * Ainv, None


def mll_via_sweep(A: torch.Tensor, y: torch.Tensor, n_active=None,
                  variant: str = "select") -> torch.Tensor:
    """Gaussian log-density through ``SweepInverse``
    (``pallas_sweep.py:473-488``): A (B, N, N) the masked system matrix
    (``linalg.mask_system``), y (B, N) with padded entries zero."""
    Ainv, logdet = SweepInverse.apply(A, variant)
    alpha = torch.einsum("bij,bj->bi", Ainv, y)
    quad = torch.sum(y * alpha, dim=-1)
    if n_active is None:
        n_active = A.shape[-1]
    return -0.5 * (quad + logdet + n_active * math.log(2.0 * math.pi))


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
