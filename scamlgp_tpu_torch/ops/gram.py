"""ARD-RBF Gram matrix through a hand-written kernel, float32 inside.

Port of ``scamlgp_tpu/ops/pallas_gram.py``: ``rbf_gram(x, z, lengthscale,
outputscale)`` maps x (n, d) and z (m, d) to

    K = os * exp(-0.5 * max(|x/l|^2 - 2 (x/l)(z/l)^T + |z/l|^2, 0))   (n, m)

computed in float32 whatever the inputs' type, as the TPU kernel computes
it (``_gram_kernel``, ``pallas_gram.py:31``), and returned in x's type:

- on a CUDA tensor it launches ``csrc/gram.cu``, counted in
  ``rbf_gram.launches``, or raises;
- on a CPU tensor it runs ``rbf_gram_plain``, the same arithmetic in plain
  torch.

Its gradient is the VJP of the port's ``ops/kernels.py::rbf`` in the
inputs' type, as the reference's ``custom_jvp`` (``:93-107``) takes the
tangent of ``K.rbf`` and not of the kernel.  The reference pads rows to its
256-row tiles and features to the MXU's lanes, then slices; the card needs
neither.

The kernel is persistent: about four CTAs an SM each walk a run of 32 x 128
output tiles, storing 16-byte runs where the rows allow it
(``launch_geometry`` mirrors its launch rule).

The JAX package calls none of this outside its tests, and neither does the
port.
"""

from __future__ import annotations

import ctypes

import torch

from scamlgp_tpu_torch.ops import cuda_build
from scamlgp_tpu_torch.ops import kernels as K


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def rbf_gram_plain(x, z, lengthscale, outputscale=1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the lengthscales cast to
    float32, the scaled inputs rounded to float32, the expanded distance
    clamped at 0, all in float32; the result in x's type
    (``pallas_gram.py:62-90``)."""
    d = x.shape[-1]
    ls32 = torch.broadcast_to(_as_tensor(lengthscale, x), (d,)).to(
        torch.float32)
    xs = (x / ls32.to(x.dtype)).to(torch.float32)
    zs = (z / ls32.to(z.dtype)).to(torch.float32)
    x2 = torch.sum(xs * xs, dim=-1, keepdim=True)
    z2 = torch.sum(zs * zs, dim=-1, keepdim=True)
    cross = torch.matmul(xs, zs.transpose(-1, -2))
    d2 = torch.clamp_min(x2 - 2.0 * cross + z2.transpose(-1, -2), 0.0)
    os32 = _as_tensor(outputscale, x).to(torch.float32)
    return (os32 * torch.exp(-0.5 * d2)).to(x.dtype)


# csrc/gram.cu's launch rule: a tile of ROWS x COLS outputs, THREADS a CTA,
# at most CTAS_PER_SM CTAs an SM, features staged CHUNK at a time
ROWS, COLS, THREADS, CTAS_PER_SM, CHUNK = 32, 128, 256, 4, 12
#: the SMs of an H100 SXM, launch_geometry's default
H100_SMS = 132


def launch_geometry(n: int, m: int, d: int,
                    dtype: torch.dtype = torch.float32,
                    sms: int = H100_SMS) -> dict:
    """How ``csrc/gram.cu`` launches at (n, m, d) on a card of ``sms``
    SMs: the (n, m) output in ``tiles`` tiles of ``tile`` = (32, 128), at
    most ``ctas_per_sm`` x sms CTAs of ``threads`` threads, each taking
    ``tiles_per_cta`` consecutive tiles (row-major); ``grid`` is the fewest
    CTAs that cover the tiles at that count.  Features are staged ``chunk``
    at a time in ``chunks`` passes.  ``vector_stores``: the rows start on
    16 bytes (m a multiple of 4 floats or 2 doubles), so full runs of 16
    bytes are stored at once (the kernel also needs a 16-byte aligned
    output, which ``torch.empty`` gives).  ``shared_bytes``: the dynamic
    shared memory of a CTA, two buffers of each part (the scaled float32
    chunk of the tile's z and x rows, their squared norms, and their raw
    rows in the input's type, padded to an odd stride);
    ``scratch_bytes``: device memory besides the output, none."""
    if n < 1 or m < 1 or d < 0:
        raise ValueError(f"the Gram kernel takes n, m >= 1 and d >= 0, got "
                         f"({n}, {m}, {d})")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the Gram kernel takes float32 or float64, not "
                        f"{dtype}")
    elem = torch.finfo(dtype).bits // 8
    tiles_n = -(-m // COLS)
    tiles = -(-n // ROWS) * tiles_n
    per = -(-tiles // (sms * CTAS_PER_SM))
    kc = min(d, CHUNK)
    stride = kc | 1
    shared = 2 * (4 * (kc + 1) * (COLS + ROWS)
                  + elem * (COLS + ROWS) * stride)
    return {"threads": THREADS, "tile": (ROWS, COLS),
            "ctas_per_sm": CTAS_PER_SM, "tiles": tiles,
            "tiles_per_cta": per, "grid": -(-tiles // per), "chunk": CHUNK,
            "chunks": max(1, -(-d // CHUNK)),
            "vector_stores": m % (16 // elem) == 0,
            "shared_bytes": shared, "scratch_bytes": 0}


_C_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@cuda_build.once_per_key
def _kernel_fn(dtype: torch.dtype, extra: tuple = ()):
    """The entry point for ``dtype`` and the error-string function of
    ``csrc/gram.cu`` built with ``extra`` flags (a profiling build's
    ``-D`` macro)."""
    lib = cuda_build.load("gram", extra)
    fn = getattr(lib, "rbf_gram_f32" if dtype == torch.float32
                 else "rbf_gram_f64")
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    err = lib.rbf_gram_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def kernel_geometry(n: int, m: int, d: int,
                    dtype: torch.dtype = torch.float32,
                    sms: int = H100_SMS) -> dict:
    """The geometry that the built kernel reports at (n, m, d) on ``sms``
    SMs (``rbf_gram_geometry``), in ``launch_geometry``'s keys; the card
    tests hold the two equal."""
    fn = cuda_build.load("gram").rbf_gram_geometry
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_longlong * 4)()
    fn(n, m, d, torch.finfo(dtype).bits // 8, sms, ctypes.addressof(out))
    return {"grid": out[0], "tiles_per_cta": out[1], "chunks": out[2],
            "shared_bytes": out[3]}


def prepare(x, z, lengthscale, outputscale):
    """The kernel's operands: x and z checked and contiguous, the
    lengthscales broadcast to (d,) and the outputscale to (1,), in x's
    type on x's device."""
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"rbf_gram takes x (n, d) and z (m, d), got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    if x.dtype not in (torch.float32, torch.float64) or z.dtype != x.dtype:
        raise TypeError(f"rbf_gram takes float32 or float64 inputs of one "
                        f"type, not {x.dtype} and {z.dtype}")
    d = x.shape[1]
    ls = torch.broadcast_to(_as_tensor(lengthscale, x).to(x.dtype),
                            (d,)).contiguous()
    os_ = _as_tensor(outputscale, x).to(x.dtype).reshape(1)
    if any(t.device != x.device for t in (z, ls, os_)):
        raise ValueError("rbf_gram needs every input on one CUDA device")
    return x.contiguous(), z.contiguous(), ls, os_


def run(x, z, ls, os_, out, extra: tuple = ()) -> torch.Tensor:
    """Launches the kernel (``extra``: the flags of another build) on
    ``prepare``'s operands into ``out`` (n, m), counted in
    ``rbf_gram.launches``."""
    fn, err_string = _kernel_fn(x.dtype, extra)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), z.data_ptr(), ls.data_ptr(), os_.data_ptr(),
                 out.data_ptr(), out.shape[0], out.shape[1], x.shape[1],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("rbf_gram kernel launch failed: "
                           + err_string(err).decode())
    cuda_build.count_launch(vars(rbf_gram), "launches")
    return out


def _launch(x, z, lengthscale, outputscale) -> torch.Tensor:
    """Checks the inputs and runs the kernel (``run``, which counts it); an
    empty output launches nothing."""
    x, z, ls, os_ = prepare(x, z, lengthscale, outputscale)
    out = torch.empty((x.shape[0], z.shape[0]), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    return run(x, z, ls, os_, out)


def _forward(x, z, lengthscale, outputscale) -> torch.Tensor:
    if x.device.type == "cpu":
        return rbf_gram_plain(x, z, lengthscale, outputscale)
    if x.device.type != "cuda":
        raise ValueError(f"rbf_gram runs on cpu or cuda, not {x.device}")
    return _launch(x, z, lengthscale, outputscale)


class RbfGram(torch.autograd.Function):
    """The kernel forward; the backward is the VJP of ``kernels.rbf`` in the
    inputs' type, for x, z, the lengthscales and the outputscale."""

    @staticmethod
    def forward(ctx, x, z, lengthscale, outputscale):
        ctx.save_for_backward(x, z, lengthscale, outputscale)
        return _forward(x, z, lengthscale, outputscale)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return None, None, None, None
        with torch.enable_grad():
            Kv = K.rbf(*inputs)
            grads = iter(torch.autograd.grad(Kv, wanted, grad_out))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def rbf_gram(x, z, lengthscale, outputscale=1.0) -> torch.Tensor:
    """ARD-RBF Gram (n, m) of x (n, d) and z (m, d), float32 inside; on a
    CUDA tensor through the kernel (counted in ``rbf_gram.launches``),
    on a CPU tensor through ``rbf_gram_plain``.  Differentiable in every
    input (``RbfGram``)."""
    return RbfGram.apply(x, z, _as_tensor(lengthscale, x),
                         _as_tensor(outputscale, x))


rbf_gram.launches = 0

