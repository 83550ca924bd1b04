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

The JAX package calls none of this outside its tests, and neither does the
port.
"""

from __future__ import annotations

import ctypes
import functools

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


_C_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    lib = cuda_build.load("gram")
    fn = getattr(lib, "rbf_gram_f32" if dtype == torch.float32
                 else "rbf_gram_f64")
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    err = lib.rbf_gram_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(x, z, lengthscale, outputscale) -> torch.Tensor:
    """Checks the inputs and runs the kernel, counted in
    ``rbf_gram.launches``; an empty output launches nothing."""
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"rbf_gram takes x (n, d) and z (m, d), got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    if x.dtype not in (torch.float32, torch.float64) or z.dtype != x.dtype:
        raise TypeError(f"rbf_gram takes float32 or float64 inputs of one "
                        f"type, not {x.dtype} and {z.dtype}")
    n, d = x.shape
    m = z.shape[0]
    ls = torch.broadcast_to(_as_tensor(lengthscale, x).to(x.dtype),
                            (d,)).contiguous()
    os_ = _as_tensor(outputscale, x).to(x.dtype).reshape(1)
    if any(t.device != x.device for t in (z, ls, os_)):
        raise ValueError("rbf_gram needs every input on one CUDA device")
    x, z = x.contiguous(), z.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn, err_string = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), z.data_ptr(), ls.data_ptr(), os_.data_ptr(),
                 out.data_ptr(), n, m, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("rbf_gram kernel launch failed: "
                           + err_string(err).decode())
    rbf_gram.launches += 1
    return out


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

