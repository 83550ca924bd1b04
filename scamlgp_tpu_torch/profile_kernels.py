"""Probes of the port's CUDA kernels on the card, one JSON line each.

    python -m scamlgp_tpu_torch.profile_kernels ptxas
    python -m scamlgp_tpu_torch.profile_kernels phases [--batch B] [--n N]
        [--d D] [--variant smem|global|pair|blocked|gram|rank1_cholesky]
        [--baseline]
    python -m scamlgp_tpu_torch.profile_kernels times
    python -m scamlgp_tpu_torch.profile_kernels probes [--repeat R]
    python -m scamlgp_tpu_torch.profile_kernels gram

- ``ptxas``: builds every kernel source with ``-Xptxas -v`` and prints each
  kernel's registers, shared memory and spill lines.
- ``phases``: a blocked-Cholesky kernel's phase profile on one launch at
  (B, N, N) float32 (default ``smem`` at (1024, 256, 256), the Branin
  N_m=256 meta-fit's batch; ``--variant global --batch 256 --n 512`` is
  the Hartmann6D N_m=512 one): the source built with
  ``-DBLOCKED_CHOL_PROFILE`` stamps ``clock64()`` after a CTA barrier at
  the end of each phase (load and pad, diagonal blocks, panel TRSM,
  trailing update, triangular inverse, W^T W and the store).  Prints the
  mean cycles a CTA spends in each phase and their shares, with the
  kernel's time in the default build and in the profiling build (whose
  barriers add to it).  ``--baseline`` profiles the first ``global``
  kernel (``csrc/baseline_kernels.cu``) instead.  ``--variant pair`` or
  ``blocked`` (default shape (1024, 128, 128), the Hartmann6D N_m=128
  meta-fit's): the sweep scheme's CTA path built with ``-DSWEEP_PROFILE``,
  where every warp stamps ``clock64()`` at the end of each phase, without
  added barriers: the mean cycles a warp spends in each phase (``pair``:
  load and store, border rebuild, update pass, barrier waits, stamped
  through each barrier's predicate; ``blocked``: load and store, R and W
  staging (the first version's R copy), panel pivots, rank-32 update, each
  with the waits at its barriers), with ``--baseline`` for the first
  version.  ``--variant gram`` (default (n, m, d) = (4096, 4096, 2), n = m
  = ``--n``, d = ``--d``): the RBF Gram kernel built with
  ``-DGRAM_PROFILE``, every warp stamping ``clock64()`` at the end of each
  phase (staging, norms, cross term, exp and store, the waits at its
  barriers, and the current kernel's waits for its own asynchronous
  copies; it sums the norms while it stages, so its ``norms`` is 0);
  ``--baseline``: the first Gram kernel.  ``--variant rank1_cholesky``
  (default shape (1024, 128, 128); ``--batch 4096`` is the probe's): the
  Cholesky probe's blocked path built with ``-DPROBE_PROFILE``, every warp
  stamping ``clock64()`` at the end of each phase (load, diagonal block,
  panel solve, trailing update, the waits at its barriers, store).
- ``times``: the ``select`` sweep kernel at the campaign's shapes beside
  its plain version, the library Cholesky inverse and the roofline bound;
  the loop-shape probes (``ops/probes.py``: the Cholesky factor and the
  traversal floor) at ``PROBE_TIMED``, each beside its first version
  (``PROBE_BASELINES``) in turns (old, new, new, old), through the wrapper
  and alone, with ``select``, its plain version and mirror, its bound and
  (the factor) ``torch.linalg.cholesky`` (``probe_row``);
  the ``fused``, ``pair`` and ``blocked`` sweep kernels and the ``global``
  blocked-Cholesky kernel beside their first versions (``BASELINES``),
  timed in turns (old, new, new, old), with ``select``, ``smem`` and the
  library call at the same shapes; whether ``select``, ``fused`` and
  ``pair`` in float32 equal their plain versions bit for bit; and the RBF
  Gram kernel's rows of ``gram``.
- ``probes``: the loop-shape probes' rows of ``times`` alone
  (``probe_rows``), ``--repeat`` times over at each shape, so that the
  turns' spread through the wrapper shows.
- ``gram``: the RBF Gram kernel at ``GRAM_TIMED`` in float32 and at
  (4096, 4096, 2) in float64 (``gram_times`` with ``full``): the kernel
  alone beside its first version in turns, its outputs rotated over
  ``GRAM_OUTS`` buffers, and with one output; a ``fill_`` of the same
  outputs; the profiler's device time of each kernel; the time through
  ``rbf_gram`` beside the first kernel through an equivalent wrapper.

``time_ms``, ``library_inverse``, ``bound``, ``gram_times``, ``probe_row``
and ``probe_errors`` are also ``chip_smoke.py``'s.

Needs a CUDA device and nvcc; the card's name and power limit head the
output.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time

import torch

from scamlgp_tpu_torch.ops import blocked_chol, cuda_build, gram, probes, sweep
from scamlgp_tpu_torch.ops import kernels as K

PHASES = ("load", "diag", "trsm", "syrk", "trinv", "wtw_store")
PROFILE_FLAGS = ("-DBLOCKED_CHOL_PROFILE",)
#: the sweep schemes' phases, in the order of their stamps' slots
SWEEP_PHASES = {"pair": ("load_store", "rebuild", "update", "barrier"),
                "blocked": ("load_store", "copy", "pivots", "update")}
SWEEP_PROFILE_FLAGS = ("-DSWEEP_PROFILE",)
#: the Gram kernels' phases, in the order of their stamps' slots
GRAM_PHASES = ("stage", "norms", "cross", "exp_store", "barrier",
               "copy_wait")
GRAM_PROFILE_FLAGS = ("-DGRAM_PROFILE",)
#: the blocked Cholesky probe's phases, in the order of its stamps' slots
PROBE_PHASES = ("load", "diagonal", "panel_solve", "trailing_update",
                "barrier", "store")
PROBE_PROFILE_FLAGS = ("-DPROBE_PROFILE",)
#: the probes' timed shapes (B, N), float32, first versions beside them
PROBE_TIMED = ((1024, 32), (1024, 128), (4096, 128))
#: the Gram kernel's timed shapes (n, m, d), float32, and the output
#: buffers that its kernel-only times rotate over: four outputs of the
#: smaller shape (16.8 MB each) overrun the H100's 50 MB L2
GRAM_TIMED = ((2048, 2048, 6), (4096, 4096, 2))
GRAM_OUTS = 4
# H100 SXM data-sheet peaks: HBM bandwidth; float32 and float64 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}


_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def baseline_lib(extra: tuple = ()):
    """``csrc/baseline_kernels.cu``: the first versions of the ``global``
    blocked-Cholesky kernel, the ``fused``, ``pair`` and ``blocked`` sweep
    kernels and the two probes (``ops/probes.py``), float32, and of the RBF
    Gram kernel, float32 and float64, kept as yardsticks."""
    lib = cuda_build.load("baseline_kernels", extra)
    lib.baseline_global_f32.argtypes = [_P] * 4 + [ctypes.c_longlong,
                                                   ctypes.c_int, _P]
    lib.baseline_global_f32.restype = ctypes.c_int
    for name in ("fused", "pair", "blocked"):
        fn = getattr(lib, f"baseline_{name}_f32")
        fn.argtypes = [_P] * 3 + [ctypes.c_longlong, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    for name in ("baseline_rbf_gram_f32", "baseline_rbf_gram_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 5 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
    for name in ("rank1_cholesky", "traversal_floor"):
        fn = getattr(lib, f"baseline_{name}_f32")
        fn.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    lib.baseline_probe_geometry.argtypes = [ctypes.c_int, _P]
    lib.baseline_probe_geometry.restype = None
    lib.baseline_error_string.argtypes = [ctypes.c_int]
    lib.baseline_error_string.restype = ctypes.c_char_p
    return lib


def baseline_gram(x, z, ls, os_, out, lib=None):
    """The first Gram kernel on ``gram.prepare``'s operands into ``out``
    (n, m); a bare launch, as ``gram.run`` is."""
    lib = lib or baseline_lib()
    fn = (lib.baseline_rbf_gram_f32 if x.dtype == torch.float32
          else lib.baseline_rbf_gram_f64)
    err = fn(x.data_ptr(), z.data_ptr(), ls.data_ptr(), os_.data_ptr(),
             out.data_ptr(), out.shape[0], out.shape[1], x.shape[1],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("baseline rbf_gram launch failed: "
                           + lib.baseline_error_string(err).decode())
    return out


def _baseline(A, name, lib=None):
    lib = lib or baseline_lib()
    if A.dtype != torch.float32:
        raise TypeError("the baseline kernels take float32")
    B, N, _ = A.shape
    inv = torch.empty_like(A)
    ld = torch.empty(B, dtype=A.dtype, device=A.device)
    stream = torch.cuda.current_stream().cuda_stream
    if name == "global":
        np_ = -(-N // blocked_chol.BS) * blocked_chol.BS
        # the first kernel worked in place in a padded copy, the output
        # itself at N = Np
        work = inv if np_ == N else torch.empty((B, np_, np_), device=A.device)
        err = lib.baseline_global_f32(A.data_ptr(), work.data_ptr(),
                                      inv.data_ptr(), ld.data_ptr(), B, N,
                                      stream)
    else:
        err = getattr(lib, f"baseline_{name}_f32")(
            A.data_ptr(), inv.data_ptr(), ld.data_ptr(), B, N, stream)
    if err:
        raise RuntimeError(f"baseline {name} launch failed: "
                           + lib.baseline_error_string(err).decode())
    return inv, ld


#: the kernels' names -> their first version, for timing beside them
BASELINES = {
    "blocked_chol_inverse_global": lambda A: _baseline(A, "global"),
    "sweep_inverse_fused": lambda A: _baseline(A, "fused"),
    "sweep_inverse_pair": lambda A: _baseline(A, "pair"),
    "sweep_inverse_blocked": lambda A: _baseline(A, "blocked"),
}


def baseline_probe(A, name, lib=None):
    """The first version of the probe kernel ``name`` (``rank1_cholesky``
    or ``traversal_floor``, in the ``select`` kernel's layout) on a float32
    CUDA tensor (B, N, N), N <= 128, through a wrapper that checks and
    launches as ``ops/probes.py``'s does, so that the two compare through
    their wrappers too."""
    lib = lib or baseline_lib()
    if A.ndim != 3 or A.shape[-1] != A.shape[-2] or not A.is_contiguous():
        raise ValueError(f"baseline {name} takes a contiguous (B, N, N)")
    if A.dtype != torch.float32 or A.device.type != "cuda":
        raise TypeError("the first probe kernels take float32 CUDA tensors")
    if not 1 <= A.shape[-1] <= probes.MAX_N:
        raise ValueError(f"baseline {name} takes N <= {probes.MAX_N}")
    out = torch.empty_like(A)
    with torch.cuda.device(A.device):
        err = getattr(lib, f"baseline_{name}_f32")(
            A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[-1],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline {name} launch failed: "
                           + lib.baseline_error_string(err).decode())
    return out


def baseline_probe_geometry(n: int) -> dict:
    """The first probe kernels' launch geometry at n (``select``'s), in the
    keys of ``sweep.launch_geometry``."""
    out = (ctypes.c_int * 3)()
    baseline_lib().baseline_probe_geometry(n, ctypes.addressof(out))
    return {"capacity": out[0], "threads": out[1],
            "matrices_per_cta": out[2]}


#: the probe kernels' names -> their first version, for timing beside them
PROBE_BASELINES = {name: functools.partial(baseline_probe, name=name)
                   for name in probes.KERNELS}


def global_tile_transfers(nb: int, first: bool = False) -> int:
    """The 64 x 64 tiles that the ``global`` kernel reads from and writes to
    device memory for one matrix of nb blocks (``first``: its first
    version, ``baseline_kernels.cu``), counted from their loops with every
    panel on chip (nb <= 10 in float32).  A Cholesky step reads and writes
    its diagonal block, its m = nb - 1 - b panel tiles and the m(m+1)/2
    tiles it updates once each (the first version began with a padded copy
    of the lower blocks and read a panel tile again for every tile it
    updated); W reads two tiles a product and L(i, i), and writes its
    block; W^T W reads one or two tiles a product and writes the output's
    blocks.  A count, not a measurement: ``ncu`` does not run on the card's
    machine."""
    if first:
        chol = nb * (nb + 1) + sum(2 + 2 * m + 3 * m * (m + 1) // 2
                                   for m in range(nb))
    else:
        chol = sum(2 * (1 + m + m * (m + 1) // 2) for m in range(nb))
    trinv = sum(2 * (i - j) + 2 for i in range(nb) for j in range(i))
    wtw = sum((nb - i + 1) * (1 if i == j else 2)
              for i in range(nb) for j in range(i + 1))
    return chol + trinv + wtw


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


def device_ms(launch, reps):
    """ms of one ``launch(i)`` on the device alone: the timed launches are
    queued behind a spin of the device (``torch.cuda._sleep``) longer than
    the host takes to issue them, so that the events time back-to-back
    kernels and not the host's ``ctypes`` calls."""
    for i in range(3):
        launch(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        launch(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # about 2e9 cycles a second: spin for twice the host's issue time
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)
    start.record()
    for i in range(reps):
        launch(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(launch, reps, kernel):
    """The profiler's mean device time of the kernels whose name holds
    ``kernel`` over ``reps`` launches, in ms; None if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    launch(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            launch(i)
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += (getattr(ev, "device_time_total", 0)
                         or getattr(ev, "cuda_time_total", 0))
            count += ev.count
    return total_us / count / 1e3 if count and total_us else None


def gram_operands(n, m, d, dtype, seed=7):
    """x, z uniform on [0, 1), lengthscales on [0.3, 1) and the
    outputscale 1.3, made on the card, as ``rbf_gram`` takes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((n, d), generator=g, device="cuda", dtype=dtype)
    z = torch.rand((m, d), generator=g, device="cuda", dtype=dtype)
    ls = 0.3 + 0.7 * torch.rand(d, generator=g, device="cuda", dtype=dtype)
    return x, z, ls, torch.tensor(1.3, device="cuda", dtype=dtype)


def gram_bound(n, m, d, dtype):
    """Least time for the Gram of x (n, d) and z (m, d): one read of the
    inputs and one write of the (n, m) output at the HBM rate, against
    (2 d + 8) operations an output (2 d for the cross term, 2 for the
    norms' sum, 3 for the distance and the clamp, 2 for the scale and the
    exp's argument, 1 exp) at the float32 peak: the arithmetic is float32
    whatever the inputs' type."""
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = ((n * d + m * d + d + 1) + n * m) * itemsize / HBM_BYTES_PER_S
    t_ops = n * m * (2 * d + 8) / PEAK_OPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class _BaselineGram(gram.RbfGram):
    """``rbf_gram``'s path with the first Gram kernel behind it, as its
    first wrapper ran it: the autograd ``Function``, the checks and casts,
    the output's allocation, the device context and one ``ctypes`` call."""

    @staticmethod
    def forward(ctx, x, z, lengthscale, outputscale):
        ctx.save_for_backward(x, z, lengthscale, outputscale)
        x, z, ls, os_ = gram.prepare(x, z, lengthscale, outputscale)
        out = torch.empty((x.shape[0], z.shape[0]), dtype=x.dtype,
                          device=x.device)
        with torch.cuda.device(x.device):
            return baseline_gram(x, z, ls, os_, out)


def baseline_call(x, z, lengthscale, outputscale):
    """The first Gram kernel through a wrapper equivalent to its own."""
    return _BaselineGram.apply(x, z, gram._as_tensor(lengthscale, x),
                               gram._as_tensor(outputscale, x))


def call_ms(fn, reps):
    """``time_ms`` of ``fn``, and the host's ms a call to issue it (the
    wall time of the issuing loop, before the device is waited for)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_s * 1e3 / reps


def gram_times(n, m, d, dtype=torch.float32, reps=100, full=False):
    """The RBF Gram kernel at (n, m, d): its own time (``ms_kernel``:
    bare launches through ``gram.run`` on operands prepared once, each
    into the next of ``GRAM_OUTS`` outputs, ``device_ms``) beside the
    first version's (``old_ms``), timed in turns (old, new, new, old);
    ``fill_ms``, a store-only yardstick: ``Tensor.fill_`` of the same
    outputs in the same turns, what the card's store stream gives at this
    size; the time through ``rbf_gram`` (``ms``, as a caller sees it)
    beside the first kernel through an equivalent wrapper
    (``old_call_ms``, ``baseline_call``), in turns, with the host's issue
    time of each call (``host_ms``, ``old_host_ms``); the plain version,
    ``kernels.rbf`` (the RBF the port's models compute: an eager
    expression of several calls; no single PyTorch call computes this
    function, so ``library_ms`` is None) and the bound.  ``full`` adds the
    same turns with one output (``ms_kernel_one_out``, ``old_ms_one_out``),
    which the L2 may hold, and the profiler's device time of each
    kernel."""
    x, z, ls, os_ = gram_operands(n, m, d, dtype)
    ops = gram.prepare(x, z, ls, os_)
    outs = [torch.empty((n, m), dtype=dtype, device="cuda")
            for _ in range(GRAM_OUTS)]
    ref = gram.rbf_gram_plain(x, z, ls, os_)
    new_k = gram.run(*ops, outs[0]).clone()
    old_k = baseline_gram(*ops, outs[1]).clone()
    torch.cuda.synchronize()
    err = (new_k - ref).abs().max().item()
    old_err = (old_k - ref).abs().max().item()
    del new_k, old_k, ref

    def new(i, outs=outs):
        gram.run(*ops, outs[i % len(outs)])

    def old(i, outs=outs):
        baseline_gram(*ops, outs[i % len(outs)])

    def fill(i, outs=outs):
        outs[i % len(outs)].fill_(0.5)

    t = [device_ms(f, reps) for f in (old, new, fill, fill, new, old)]
    t = t[:2] + t[4:] + t[2:4]  # (old, new, new, old), then the fills
    bound_ms, bound_by = gram_bound(n, m, d, dtype)
    row = dict(
        n=n, m=m, d=d, dtype=str(dtype).replace("torch.", ""),
        geometry=gram.launch_geometry(
            n, m, d, dtype,
            torch.cuda.get_device_properties(0).multi_processor_count),
        max_abs_err=err, old_max_abs_err=old_err,
        ms_kernel=(t[1] + t[2]) / 2, old_ms=(t[0] + t[3]) / 2,
        fill_ms=(t[4] + t[5]) / 2, turns_ms=t,
        outs=len(outs), out_bytes=outs[0].numel() * outs[0].element_size())
    if full:
        one = [device_ms(lambda i, f=f: f(i, outs[:1]), reps)
               for f in (old, new, new, old)]
        row.update(
            ms_kernel_one_out=(one[1] + one[2]) / 2,
            old_ms_one_out=(one[0] + one[3]) / 2,
            profiler_ms=profiled_ms(new, reps, "rbf_gram_kernel"),
            old_profiler_ms=profiled_ms(old, reps, "baseline_gram_kernel"))
    del outs
    new_call = lambda: gram.rbf_gram(x, z, ls, os_)  # noqa: E731
    old_call = lambda: baseline_call(x, z, ls, os_)  # noqa: E731
    calls = [call_ms(f, 50) for f in (old_call, new_call, new_call,
                                      old_call)]
    row.update(ms=(calls[1][0] + calls[2][0]) / 2,
               old_call_ms=(calls[0][0] + calls[3][0]) / 2,
               host_ms=(calls[1][1] + calls[2][1]) / 2,
               old_host_ms=(calls[0][1] + calls[3][1]) / 2,
               call_turns_ms=[c[0] for c in calls])
    row["write_tb_per_s"] = row["out_bytes"] / row["ms_kernel"] / 1e9
    row.update(plain_ms=time_ms(lambda: gram.rbf_gram_plain(x, z, ls, os_),
                                20),
               rbf_eager_ms=time_ms(lambda: K.rbf(x, z, ls, os_), 20),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    torch.cuda.empty_cache()
    return row


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


def probe_bound(name: str, B: int, N: int) -> tuple:
    """Least time in ms for the work of the probe kernel ``name``
    (``ops/probes.py``) on B float32 N x N blocks, and what bounds it: the
    bytes the function must move at the HBM rate, against the operations
    at the float32 peak.  The factor reads the lower triangle of A (N (N +
    1) / 2 elements: the factor of a symmetric matrix needs no more) and
    writes the whole of L, its upper triangle zero; it needs N^3 / 3
    operations (N^3 / 6 multiply-subtracts, LAPACK potrf's count).  The
    floor reads and writes every element and does 2 N^3 operations (a
    multiply and an add an element a step)."""
    read = {"rank1_cholesky": N * (N + 1) // 2,
            "traversal_floor": N * N}[name]
    t_bytes = B * (read + N * N) * 4 / HBM_BYTES_PER_S
    ops = {"rank1_cholesky": N ** 3 / 3, "traversal_floor": 2 * N ** 3}[name]
    t_ops = B * ops / PEAK_OPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ulps_apart(a, b) -> int:
    """The largest distance in float32 units in the last place between two
    float32 tensors of one sign pattern."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max().item())


def ulps_of_larger(a, b, start) -> float:
    """The largest |a - b| in units in the last place of the larger of
    |start| and |b|, elementwise: the unit in which N steps of the floor
    from ``start`` part the fused and the unfused recurrences by at most N.
    Each step moves them at most one ulp of the step's value apart, and a
    value of the recurrence never exceeds the larger of its start and its
    end (it falls, or falls and then rises), where a plain count of ulps
    would grow when a value falls below a power of two."""
    big = torch.maximum(start.abs(), b.abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    return ((a - b).abs() / ulp).max().item()


def probe_errors(name, A, out, old) -> dict:
    """How far the probe kernel ``name``'s output ``out`` on A lies from its
    plain version and its mirror (``ops/probes.py``), and its first
    version's ``old`` from the plain version.  The factor (keys ``chol_``):
    max abs against both, max abs relative to ``torch.linalg.cholesky``,
    whether its strict upper triangle is 0, and max|L| (``max_abs_l``, the
    scale of its tolerance).  The floor (keys ``floor_``): ulps from its
    FMA recurrence and the share of elements not bit for bit with it, ulps
    from the unfused plain version (``ulps_of_larger``) and max abs, and
    whether the first version equals the plain version bit for bit."""
    plain = getattr(probes, f"{name}_reference")(A)
    if name == "rank1_cholesky":
        mirror = probes.blocked_cholesky_mirror(A)
        lib = torch.linalg.cholesky(A)
        return dict(
            max_abs_l=plain.abs().max().item(),
            chol_max_abs_err=(out - plain).abs().max().item(),
            chol_max_abs_err_mirror=(out - mirror).abs().max().item(),
            chol_rel_err_vs_library=((out - lib).abs().max().item()
                                     / lib.abs().max().item()),
            chol_upper_zero=bool(torch.equal(torch.triu(out, 1),
                                             torch.zeros_like(out))),
            old_chol_max_abs_err=(old - plain).abs().max().item())
    fma = probes.traversal_floor_fma_reference(A)
    return dict(
        floor_max_ulps_fma=ulps_apart(out, fma),
        floor_share_not_bitwise_fma=(out != fma).double().mean().item(),
        floor_max_ulps_plain=ulps_of_larger(out, plain, A),
        floor_max_abs_err=(out - plain).abs().max().item(),
        old_floor_bitwise_equal=bool(torch.equal(old, plain)))


def probe_row(name, A, select_ms, reps=20, plain_reps=2):
    """The probe kernel ``name`` at A's shape beside its first version
    (``PROBE_BASELINES``), in turns (old, new, new, old) through the
    wrapper (``ms``, ``old_ms``) and alone (``ms_alone``, ``old_ms_alone``:
    bare launches queued behind a device spin, ``device_ms``), ``reps``
    launches a turn; its errors at this shape (``probe_errors``, and
    ``max_abs_err``: against the plain version), the plain version's time
    (``plain_reps`` calls), the library call's (the factor: ``torch.
    linalg.cholesky``) and the bound."""
    B, N, _ = A.shape
    kernel = getattr(probes, name)
    old = PROBE_BASELINES[name]
    plain = getattr(probes, f"{name}_reference")
    out, out_old = kernel(A), old(A)
    if A.is_cuda:
        torch.cuda.synchronize()
    errors = probe_errors(name, A, out, out_old)
    del out, out_old
    calls = (lambda: old(A), lambda: kernel(A), lambda: kernel(A),
             lambda: old(A))
    t = [time_ms(f, reps) for f in calls]
    alone = [device_ms(lambda i, f=f: f(), reps) for f in calls]
    bound_ms, bound_by = probe_bound(name, B, N)
    return dict(
        kernel=name, batch=B, n=N, **errors,
        max_abs_err=errors[{"rank1_cholesky": "chol_max_abs_err",
                            "traversal_floor": "floor_max_abs_err"}[name]],
        ms=(t[1] + t[2]) / 2, old_ms=(t[0] + t[3]) / 2, turns_ms=t,
        ms_alone=(alone[1] + alone[2]) / 2,
        old_ms_alone=(alone[0] + alone[3]) / 2, turns_alone_ms=alone,
        select_ms=select_ms, plain_ms=time_ms(lambda: plain(A), plain_reps),
        library_ms=(time_ms(lambda: torch.linalg.cholesky(A), reps)
                    if name == "rank1_cholesky" else None),
        geometry=probes.launch_geometry(name, B, N),
        bound_ms=bound_ms, bound_by=bound_by)


def probe_rows(repeat: int = 1) -> list:
    """``probe_row`` of both probe kernels at each of ``PROBE_TIMED``,
    ``repeat`` times over (the rows' ``repeat``), ``select`` timed at the
    shape before each repeat."""
    rows = []
    for B, N in PROBE_TIMED:
        A = spd(B, N)
        A = 0.5 * (A + A.transpose(1, 2))
        for r in range(repeat):
            select_ms = time_ms(lambda: sweep.sweep_inverse(A, "select"), 20)
            for name in probes.KERNELS:
                rows.append(dict(probe_row(name, A, select_ms), repeat=r))
        del A
        torch.cuda.empty_cache()
    return rows


def cmd_ptxas():
    for name in cuda_build.SOURCES:
        path = cuda_build.build_all([name], ("-Xptxas", "-v"))[0]
        lines = [ln.strip() for ln in cuda_build.BUILD_LOGS[str(path)]
                 .splitlines() if "ptxas info" in ln or "spill" in ln]
        _emit(probe="ptxas", source=name, lines=lines)


def cmd_gram_phases(n: int, d: int, baseline: bool = False):
    """One Gram launch's phase profile at (n, n, d) float32: mean cycles a
    warp in each of ``GRAM_PHASES`` (the current kernel sums the norms
    while it stages, so its ``norms`` is 0; the first one loads
    synchronously, so its ``copy_wait`` is 0), with the kernel's own time
    in the default and the profiling build."""
    x, z, ls, os_ = gram.prepare(*gram_operands(n, n, d, torch.float32))
    out, ref = (torch.empty((n, n), device="cuda") for _ in range(2))
    if baseline:
        lib = baseline_lib(GRAM_PROFILE_FLAGS)
        read, reset = (lib.baseline_gram_profile_read,
                       lib.baseline_gram_profile_reset)
        name = "baseline_rbf_gram"
        launch = lambda i=0: baseline_gram(x, z, ls, os_, out, lib)  # noqa
        default = lambda i=0: baseline_gram(x, z, ls, os_, ref)  # noqa
    else:
        lib = cuda_build.load("gram", GRAM_PROFILE_FLAGS)
        read, reset = lib.gram_profile_read, lib.gram_profile_reset
        name = "rbf_gram"
        launch = lambda i=0: gram.run(  # noqa: E731
            x, z, ls, os_, out, GRAM_PROFILE_FLAGS)
        default = lambda i=0: gram.run(x, z, ls, os_, ref)  # noqa: E731
    read.argtypes = [ctypes.c_void_p]
    read.restype = reset.restype = ctypes.c_int
    reset.argtypes = []
    launch()
    torch.cuda.synchronize()
    if reset():
        raise RuntimeError("phase profile reset failed")
    launch()
    default()
    torch.cuda.synchronize()
    totals = (ctypes.c_ulonglong * (len(GRAM_PHASES) + 1))()
    if read(ctypes.addressof(totals)):
        raise RuntimeError("phase profile read failed")
    count = totals[len(GRAM_PHASES)]
    if count == 0:
        raise RuntimeError(f"{name} stamped nothing at n={n}")
    cycles = {p: totals[i] / count for i, p in enumerate(GRAM_PHASES)}
    whole = sum(cycles.values())
    _emit(probe="phases", kernel=name, n=n, m=n, d=d, dtype="float32",
          warps=count, cycles_per_warp=cycles,
          share={p: c / whole for p, c in cycles.items()},
          cycles_per_warp_total=whole,
          geometry=None if baseline else gram.launch_geometry(
              n, n, d, torch.float32,
              torch.cuda.get_device_properties(0).multi_processor_count),
          ms=device_ms(default, 50), ms_profiling_build=device_ms(launch, 50),
          profiling_build_equal=bool(torch.equal(out, ref)))


def cmd_probe_phases(batch: int, n: int):
    """One launch of the blocked Cholesky probe (``rank1_cholesky``, its
    blocked path: 32 < n <= 128) at (batch, n, n) float32, built with
    ``-DPROBE_PROFILE``: the mean cycles a warp spends in each phase (load,
    diagonal block, panel solve, trailing update, the waits at its
    barriers, store), with the kernel's time alone in the default build and
    in the profiling build."""
    A = spd(batch, n)
    A = 0.5 * (A + A.transpose(1, 2))
    lib = cuda_build.load("probe_kernels", PROBE_PROFILE_FLAGS)
    read, reset = lib.probe_profile_read, lib.probe_profile_reset
    read.argtypes, reset.argtypes = [ctypes.c_void_p], []
    read.restype = reset.restype = ctypes.c_int

    def launch(i=0):
        return probes._launch("rank1_cholesky", A, PROBE_PROFILE_FLAGS)

    launch()
    torch.cuda.synchronize()
    if reset():
        raise RuntimeError("phase profile reset failed")
    L = launch()
    torch.cuda.synchronize()
    totals = (ctypes.c_ulonglong * (len(PROBE_PHASES) + 1))()
    if read(ctypes.addressof(totals)):
        raise RuntimeError("phase profile read failed")
    count = totals[len(PROBE_PHASES)]
    if count == 0:
        raise RuntimeError(f"rank1_cholesky stamped nothing at n={n} (its "
                           "warp path, n <= 32, has no stamps)")
    cycles = {p: totals[i] / count for i, p in enumerate(PROBE_PHASES)}
    whole = sum(cycles.values())
    ref = probes.rank1_cholesky(A)
    torch.cuda.synchronize()
    _emit(probe="phases", kernel="rank1_cholesky", batch=batch, n=n,
          dtype="float32", warps=count, cycles_per_warp=cycles,
          share={p: c / whole for p, c in cycles.items()},
          cycles_per_warp_total=whole,
          geometry=probes.launch_geometry("rank1_cholesky", batch, n),
          ms=device_ms(lambda i: probes.rank1_cholesky(A), 20),
          ms_profiling_build=device_ms(launch, 20),
          profiling_build_equal=bool(torch.equal(L, ref)))


def cmd_phases(batch: int, n: int, variant: str, baseline: bool = False):
    """One launch's phase profile at (batch, n, n) float32: ``variant``'s
    kernel built with its profiling flags, or with ``baseline`` its first
    version (``baseline_kernels.cu``; the first ``global`` for ``smem``
    and ``global``).  The blocked-Cholesky kernels count cycles a CTA, the
    sweep schemes cycles a warp (their current kernels stamp only their
    CTA path, n > 32)."""
    A = spd(batch, n)
    if variant in SWEEP_PHASES:
        phases, unit = SWEEP_PHASES[variant], "warp"
        if baseline:
            lib = baseline_lib(SWEEP_PROFILE_FLAGS)
            read, reset = (lib.baseline_sweep_profile_read,
                           lib.baseline_sweep_profile_reset)
            name = f"baseline_{variant}"
            launch = lambda: _baseline(A, variant, lib)  # noqa: E731
            default = BASELINES[sweep.kernel_name(variant)]
        else:
            lib = cuda_build.load("sweep_variants", SWEEP_PROFILE_FLAGS)
            read, reset = lib.sweep_profile_read, lib.sweep_profile_reset
            name = sweep.kernel_name(variant)
            launch = lambda: sweep._launch(  # noqa: E731
                A, variant, SWEEP_PROFILE_FLAGS)
            default = lambda A: sweep.sweep_inverse(A, variant)  # noqa
        read.argtypes = [ctypes.c_int, ctypes.c_void_p]
        read = functools.partial(read, tuple(SWEEP_PHASES).index(variant))
    else:
        phases, unit = PHASES, "cta"
        if baseline:
            lib = baseline_lib(PROFILE_FLAGS)
            read, reset = lib.baseline_profile_read, \
                lib.baseline_profile_reset
            name = "baseline_global"
            launch = lambda: _baseline(A, "global", lib)  # noqa: E731
            default = lambda A: _baseline(A, "global")  # noqa: E731
        else:
            lib = blocked_chol.kernel_lib(PROFILE_FLAGS)
            read, reset = lib.blocked_chol_profile_read, \
                lib.blocked_chol_profile_reset
            name = f"blocked_chol_inverse_{variant}"
            launch = lambda: blocked_chol._launch(A, variant, lib)  # noqa
            default = lambda A: blocked_chol.blocked_chol_inverse(  # noqa
                A, variant)
        read.argtypes = [ctypes.c_void_p]
    for fn in (read, reset):
        getattr(fn, "func", fn).restype = ctypes.c_int
    reset.argtypes = []

    launch()
    torch.cuda.synchronize()
    if reset():
        raise RuntimeError("phase profile reset failed")
    inv, ld = launch()
    torch.cuda.synchronize()
    totals = (ctypes.c_ulonglong * (len(phases) + 1))()
    if read(ctypes.addressof(totals)):
        raise RuntimeError("phase profile read failed")
    count = totals[len(phases)]
    if count == 0:
        raise RuntimeError(f"{name} stamped nothing at n={n}")
    cycles = {p: totals[i] / count for i, p in enumerate(phases)}
    whole = sum(cycles.values())
    nb = -(-n // blocked_chol.BS)
    counted = {}
    if unit == "cta" and (baseline or variant == "global") and nb <= 10:
        counted["device_bytes_counted"] = (
            batch * global_tile_transfers(nb, baseline)
            * blocked_chol.BS ** 2 * A.element_size())
    ms_profiled = time_ms(launch, 10)
    ms = time_ms(lambda: default(A), 10)
    ref_inv, ref_ld = default(A)
    torch.cuda.synchronize()
    _emit(probe="phases", kernel=name,
          batch=batch, n=n, dtype="float32", **{f"{unit}s": count},
          **{f"cycles_per_{unit}": cycles},
          share={p: c / whole for p, c in cycles.items()},
          **{f"cycles_per_{unit}_total": whole}, ms=ms,
          ms_profiling_build=ms_profiled,
          profiling_build_equal=bool(torch.equal(inv, ref_inv)
                                     and torch.equal(ld, ref_ld)),
          **counted)


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
    # the loop-shape probes beside their first versions, in turns (old, new,
    # new, old), through the wrappers and alone (``device_ms``), with select,
    # the plain versions and mirrors, the library Cholesky and the bounds
    rows += probe_rows()
    # the redesigned kernels beside their first versions, in turns (old,
    # new, new, old), with select and the library call at the same shapes
    for B, N in ((1024, 128), (4096, 128), (1024, 32)):
        A = spd(B, N)
        select_ms = time_ms(lambda: sweep.sweep_inverse(A, "select"), 20)
        library_ms = time_ms(lambda: library_inverse(A), 10)
        for variant in ("fused", "pair", "blocked"):
            name = sweep.kernel_name(variant)
            inv_k, ld_k = sweep.sweep_inverse(A, variant)
            inv_p, ld_p = sweep.sweep_inverse_reference(A, variant)
            torch.cuda.synchronize()
            new = lambda v=variant: sweep.sweep_inverse(A, v)  # noqa: E731
            old = lambda n=name: BASELINES[n](A)  # noqa: E731
            t = [time_ms(f, 20) for f in (old, new, new, old)]
            rows.append(dict(
                kernel=name, batch=B, n=N,
                bitwise_equal_plain=bool(torch.equal(inv_k, inv_p)
                                         and torch.equal(ld_k, ld_p)),
                max_abs_err=(inv_k - inv_p).abs().max().item(),
                max_abs_inv=inv_p.abs().max().item(),
                ms=(t[1] + t[2]) / 2, old_ms=(t[0] + t[3]) / 2, turns_ms=t,
                select_ms=select_ms, library_ms=library_ms,
                bound_ms=bound(B, N, A.dtype)[0]))
        del A, inv_k, inv_p
        torch.cuda.empty_cache()
    for B, N in ((256, 512), (1024, 256)):
        A = spd(B, N)
        ref_inv, ref_ld = blocked_chol.blocked_chol_inverse_reference(A)
        inv, ld = blocked_chol.blocked_chol_inverse(A, "global")
        torch.cuda.synchronize()
        new = lambda: blocked_chol.blocked_chol_inverse(A, "global")  # noqa
        old = lambda: BASELINES["blocked_chol_inverse_global"](A)  # noqa
        t = [time_ms(f, 10) for f in (old, new, new, old)]
        row = dict(
            kernel="blocked_chol_inverse_global", batch=B, n=N,
            max_abs_err=(inv - ref_inv).abs().max().item(),
            max_abs_inv=ref_inv.abs().max().item(),
            logdet_max_abs_err=(ld - ref_ld).abs().max().item(),
            ms=(t[1] + t[2]) / 2, old_ms=(t[0] + t[3]) / 2, turns_ms=t,
            library_ms=time_ms(lambda: library_inverse(A), 10),
            bound_ms=bound(B, N, A.dtype)[0])
        if N == 256:
            row["smem_ms"] = time_ms(
                lambda: blocked_chol.blocked_chol_inverse(A, "smem"), 10)
        rows.append(row)
        del A, ref_inv, inv
        torch.cuda.empty_cache()
    for row in rows:
        _emit(probe="times", dtype="float32", **row)
    cmd_gram()


def cmd_gram():
    """``gram_times`` (``full``) at ``GRAM_TIMED`` in float32 and at
    (4096, 4096, 2) in float64."""
    for shape, dtype in ([(s, torch.float32) for s in GRAM_TIMED]
                         + [((4096, 4096, 2), torch.float64)]):
        _emit(probe="times", kernel="rbf_gram",
              **gram_times(*shape, dtype, full=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe",
                    choices=("ptxas", "phases", "times", "probes", "gram"))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n", type=int, default=None,
                    help="default 256; 128 for pair, blocked and "
                    "rank1_cholesky; 4096 (n = m) for gram")
    ap.add_argument("--d", type=int, default=2, help="gram's features")
    ap.add_argument("--repeat", type=int, default=3,
                    help="probes: the rows' repeats at each shape")
    ap.add_argument("--variant",
                    choices=(blocked_chol.VARIANTS + tuple(SWEEP_PHASES)
                             + ("gram", "rank1_cholesky")),
                    default="smem")
    ap.add_argument("--baseline", action="store_true",
                    help="phases of the variant's first kernel (global, "
                    "pair, blocked, gram)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _emit(probe="device", name=torch.cuda.get_device_name(0),
          nvidia_smi=_card(), torch=torch.__version__, cuda=torch.version.cuda)
    if args.probe == "ptxas":
        cmd_ptxas()
    elif args.probe == "phases" and args.variant == "rank1_cholesky":
        cmd_probe_phases(args.batch, args.n or 128)
    elif args.probe == "phases" and args.variant == "gram":
        cmd_gram_phases(args.n or 4096, args.d, args.baseline)
    elif args.probe == "phases":
        n = args.n or (128 if args.variant in SWEEP_PHASES else 256)
        cmd_phases(args.batch, n, args.variant, args.baseline)
    elif args.probe == "gram":
        cmd_gram()
    elif args.probe == "probes":
        for row in probe_rows(args.repeat):
            _emit(probe="times", dtype="float32", **row)
    else:
        cmd_times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
