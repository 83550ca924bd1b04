"""Probes of the port's CUDA kernels on the card, one JSON line each.

    python -m scamlgp_tpu_torch.profile_kernels ptxas
    python -m scamlgp_tpu_torch.profile_kernels phases [--batch B] [--n N]
    python -m scamlgp_tpu_torch.profile_kernels times

- ``ptxas``: builds every kernel source with ``-Xptxas -v`` and prints each
  kernel's registers, shared memory and spill lines.
- ``phases``: the ``smem`` blocked-Cholesky kernel's phase profile on one
  launch at (B, N, N) float32 (default (1024, 256, 256), the Branin
  N_m=256 meta-fit's batch): the source built with
  ``-DBLOCKED_CHOL_PROFILE`` stamps ``clock64()`` after a CTA barrier at
  the end of each phase (load and pad, diagonal blocks, panel TRSM,
  trailing update, triangular inverse, W^T W and the store).  Prints the
  mean cycles a CTA spends in each phase and their shares, with the
  kernel's time in the default build and in the profiling build (whose
  barriers add to it).
- ``times``: the ``select`` sweep kernel and both blocked-Cholesky
  variants at the campaign's shapes, each beside its plain version, the
  library Cholesky inverse and the roofline bound, and whether ``select``
  in float32 equals its plain version bit for bit.

``time_ms``, ``library_inverse`` and ``bound`` are also ``chip_smoke.py``'s.

Needs a CUDA device and nvcc; the card's name and power limit head the
output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from scamlgp_tpu_torch.ops import blocked_chol, cuda_build, sweep

PHASES = ("load", "diag", "trsm", "syrk", "trinv", "wtw_store")
PROFILE_FLAGS = ("-DBLOCKED_CHOL_PROFILE",)
# H100 SXM data-sheet peaks: HBM bandwidth; float32 and float64 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spd(batch: int, n: int, seed: int = 0, dtype=torch.float32):
    """X X^T / n + I / 2 for X standard normal, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((batch, n, n), generator=g, device="cuda",
                    dtype=torch.float64)
    A = torch.matmul(X, X.transpose(1, 2)) / n
    A += 0.5 * torch.eye(n, device="cuda", dtype=torch.float64)
    return A.to(dtype).contiguous()


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_inverse(A):
    """Yardstick only, on no path of the port: library Cholesky inverse
    and the log-determinant from the factor's diagonal."""
    L = torch.linalg.cholesky(A)
    return (torch.cholesky_inverse(L),
            2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))


def bound(B, N, dtype):
    """Least time for (A^{-1}, log|A|) of B SPD matrices N x N: one read of A
    and one write of the outputs at the HBM rate, against the N^3 operations
    that the function needs at the least (a Cholesky, a triangular inverse
    and W^T W at N^3 / 3 each, as LAPACK's potrf + potri), at the peak rate
    of the type.  The same count holds for every kernel of the function,
    whatever its own scheme does (the sweep does 2 N^3)."""
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = (2 * B * N * N + B) * itemsize / HBM_BYTES_PER_S
    t_ops = B * N ** 3 / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cmd_ptxas():
    for name in cuda_build.SOURCES:
        path = cuda_build.build_all([name], ("-Xptxas", "-v"))[0]
        lines = [ln.strip() for ln in cuda_build.BUILD_LOGS[str(path)]
                 .splitlines() if "ptxas info" in ln or "spill" in ln]
        _emit(probe="ptxas", source=name, lines=lines)


def cmd_phases(batch: int, n: int):
    lib = cuda_build.load("blocked_chol_inverse", PROFILE_FLAGS)
    fn = lib.blocked_chol_inverse_smem_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.blocked_chol_profile_read.argtypes = [ctypes.c_void_p]
    lib.blocked_chol_profile_read.restype = ctypes.c_int
    lib.blocked_chol_profile_reset.argtypes = []
    lib.blocked_chol_profile_reset.restype = ctypes.c_int
    A = spd(batch, n)
    inv = torch.empty_like(A)
    ld = torch.empty(batch, device="cuda")

    def launch():
        err = fn(A.data_ptr(), inv.data_ptr(), ld.data_ptr(), batch, n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"profiling launch failed: {err}")

    launch()
    torch.cuda.synchronize()
    if lib.blocked_chol_profile_reset():
        raise RuntimeError("blocked_chol_profile_reset failed")
    launch()
    torch.cuda.synchronize()
    totals = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    if lib.blocked_chol_profile_read(ctypes.addressof(totals)):
        raise RuntimeError("blocked_chol_profile_read failed")
    ctas = totals[len(PHASES)]
    cycles = {p: totals[i] / ctas for i, p in enumerate(PHASES)}
    whole = sum(cycles.values())
    ms_profiled = time_ms(launch, 10)
    ms = time_ms(lambda: blocked_chol.blocked_chol_inverse(A, "smem"), 10)
    ref_inv, ref_ld = blocked_chol.blocked_chol_inverse(A, "smem")
    torch.cuda.synchronize()
    _emit(probe="phases", kernel="blocked_chol_inverse_smem", batch=batch,
          n=n, dtype="float32", ctas=ctas, cycles_per_cta=cycles,
          share={p: c / whole for p, c in cycles.items()},
          cycles_per_cta_total=whole, ms=ms, ms_profiling_build=ms_profiled,
          profiling_build_equal=bool(torch.equal(inv, ref_inv)
                                     and torch.equal(ld, ref_ld)))


def cmd_times():
    rows = []
    for B, N in ((192, 6), (1024, 32), (1024, 128), (4096, 128)):
        A = spd(B, N)
        inv_k, ld_k = sweep.sweep_inverse(A, "select")
        inv_p, ld_p = sweep.sweep_inverse_reference(A, "select")
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="sweep_inverse", batch=B, n=N,
            bitwise_equal_plain=bool(torch.equal(inv_k, inv_p)
                                     and torch.equal(ld_k, ld_p)),
            ms=time_ms(lambda: sweep.sweep_inverse(A, "select"), 20),
            plain_ms=time_ms(lambda: sweep.sweep_inverse_reference(A), 2),
            library_ms=time_ms(lambda: library_inverse(A), 10),
            bound_ms=bound(B, N, A.dtype)[0]))
    A = spd(1024, 256)
    ref_inv, ref_ld = blocked_chol.blocked_chol_inverse_reference(A)
    for variant in blocked_chol.VARIANTS:
        inv, ld = blocked_chol.blocked_chol_inverse(A, variant)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel=f"blocked_chol_inverse_{variant}", batch=1024, n=256,
            max_abs_err=(inv - ref_inv).abs().max().item(),
            max_abs_inv=ref_inv.abs().max().item(),
            logdet_max_abs_err=(ld - ref_ld).abs().max().item(),
            ms=time_ms(lambda: blocked_chol.blocked_chol_inverse(A, variant),
                       10),
            library_ms=time_ms(lambda: library_inverse(A), 10),
            bound_ms=bound(1024, 256, A.dtype)[0]))
    for row in rows:
        _emit(probe="times", dtype="float32", **row)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("ptxas", "phases", "times"))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _emit(probe="device", name=torch.cuda.get_device_name(0),
          nvidia_smi=_card(), torch=torch.__version__, cuda=torch.version.cuda)
    if args.probe == "ptxas":
        cmd_ptxas()
    elif args.probe == "phases":
        cmd_phases(args.batch, args.n)
    else:
        cmd_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
