"""Fused bias + GELU epilogue: ``gelu(x + b)`` with the exact erf GELU.

The forward of ``mxnet_tpu/ops/pallas/epilogue.py:bias_gelu``.  On a CUDA
tensor it launches a Triton kernel; on a CPU tensor it runs
:func:`bias_gelu_plain`, the same math in plain PyTorch.

Kernel note.  Replaces the TPU kernel ``_bg_fwd_kernel``
(``mxnet_tpu/ops/pallas/epilogue.py:135``, launched by ``_rowblock_call``
at ``:146`` from ``bias_gelu`` at ``:197``).  Bound on the card: bytes.
It is one elementwise pass over (R, C) with a broadcast bias: each
element is read once and written once, with a few dozen flops of erf
between, and no data is reused.  The kernel therefore streams the
flattened tensor in blocks of contiguous elements (masked at the ragged
end), computes in fp32 and stores in ``x.dtype``; the bias row is small
enough to stay in cache.  Triton's masked block loads reach the same
bandwidth as a hand-written CUDA loop here.
"""
from __future__ import annotations

import math

import torch

__all__ = ["bias_gelu", "bias_gelu_plain"]

_SQRT_HALF = math.sqrt(0.5)
_BLOCK = 1024

# Bound to triton.language and the module holding ``erf`` when the kernel
# is first built, so that importing this module needs no triton.
tl = None
_math = None
_kernel = None


def _bias_gelu_body(x_ptr, b_ptr, o_ptr, n, C, BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + offs % C, mask=mask, other=0.0).to(tl.float32)
    u = x + b
    y = 0.5 * u * (1.0 + _math.erf(u * 0.7071067811865476))
    tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)


def _build():
    global tl, _math, _kernel
    if _kernel is None:
        import triton
        import triton.language as language
        tl = language
        if hasattr(language, "erf"):
            _math = language
        else:
            from triton.language.extra import libdevice
            _math = libdevice
        _kernel = triton.jit(_bias_gelu_body)
    return _kernel


def bias_gelu_plain(x, b):
    """gelu(x + b) in fp32, returned in ``x.dtype``.  x: (..., C), b: (C,)."""
    u = x.float() + b.float()
    return (0.5 * u * (1.0 + torch.erf(u * _SQRT_HALF))).to(x.dtype)


def bias_gelu(x, b):
    """gelu(x + b), exact erf.  x: (..., C) contiguous, b: (C,).

    A CPU tensor takes :func:`bias_gelu_plain`; a CUDA tensor launches the
    Triton kernel (and counts the launch in ``bias_gelu.launches``)."""
    if x.device.type == "cpu":
        return bias_gelu_plain(x, b)
    if x.device.type != "cuda":
        raise ValueError("bias_gelu: unsupported device %s" % x.device)
    C = x.shape[-1]
    if b.shape != (C,) or b.device != x.device:
        raise ValueError("bias_gelu: bias must be (%d,) on %s, got %s on %s"
                         % (C, x.device, tuple(b.shape), b.device))
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError("bias_gelu: unsupported dtype %s" % x.dtype)
    if not (x.is_contiguous() and b.is_contiguous()):
        raise ValueError("bias_gelu: x and b must be contiguous")
    kernel = _build()
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        kernel[(-(-n // _BLOCK),)](x, b, out, n, C, BLOCK=_BLOCK)
        bias_gelu.launches += 1
    return out


bias_gelu.launches = 0
