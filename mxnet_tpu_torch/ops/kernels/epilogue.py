"""Fused transformer epilogues with their gradients: the port of
``mxnet_tpu/ops/pallas/epilogue.py``.

- :func:`bias_gelu` — ``gelu(x + b)``, exact erf.  Forward: the CUDA
  kernel of ``csrc/epilogue.cu`` replacing ``_bg_fwd_kernel``
  (``epilogue.py:135``), launched as :func:`bias_gelu_plan` says.  Backward
  (:func:`bias_gelu_backward`): the Triton kernel replacing
  ``_bg_bwd_kernel`` (``epilogue.py:140``), ``dx = g * gelu'(x + b)``; it
  saves ``(x, b)`` and recomputes ``u = x + b``, as the JAX op does.
- :func:`bias_dropout_residual` — ``r + dropout(x + b)``.  Forward and
  backward: the CUDA kernels of ``csrc/epilogue.cu`` replacing
  ``_bdr_fwd_kernel`` and ``_bdr_bwd_kernel`` (``epilogue.py:213, 221``).
  The mask is the counter hash of :mod:`.dropout_hash` over global (row,
  column) positions, so the backward rebuilds it from the seed: the op
  saves the seed and nothing activation-sized.

``db`` of both ops is an fp32 column sum of ``dx`` outside the kernels,
cast to the bias's dtype (``epilogue.py:190, 280``).

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor (or raises), counting launches:
``bias_gelu.launches``, ``bias_gelu_backward.launches``,
``bias_dropout_residual.launches_fwd`` and ``.launches_bwd``; each
wrapper's ``last_dtype`` is the dtype of its last launch.

Kernel note.  All four are bound by bytes on the card: one elementwise
pass over (R, C) with a broadcast bias, each element read once and written
once, a few dozen flops (erf, exp) or integer operations (the hash)
between, and no reuse.  The GELU forward is a CUDA kernel whose threads
each own a 16-byte column vector and walk rows, bias in registers, all
of a pass's loads in flight (its design note is in ``csrc/epilogue.cu``);
it is launched through ctypes, whose enqueue costs the serving path less
than Triton's launcher.  The Triton backward streams the flattened tensor
in blocks of contiguous elements (masked at the ragged end), computes in
fp32 and stores in ``x.dtype``; the bias row stays in cache.  The dropout
kernels are CUDA C++ so that the uint32 hash wraps as C++ defines it and
the mask equals the plain version's bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from . import _build
from . import dropout_hash as _hash

__all__ = ["bias_gelu", "bias_gelu_plain", "bias_gelu_plan",
           "bias_gelu_backward",
           "bias_gelu_backward_plain", "bias_dropout_residual",
           "bias_dropout_residual_plain",
           "bias_dropout_residual_backward_plain", "fuse_epilogue_enabled"]

_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_BLOCK = 1024

# Bound to triton.language and the module holding ``erf`` when the kernels
# are first built, so that importing this module needs no triton.
tl = None
_math = None
_kernels = {}


def fuse_epilogue_enabled():
    """The layer-level gate ``MXNET_FUSE_EPILOGUE`` (default on), read as
    the JAX package reads it: Dense/FFN/BERT take the fused ops unless it
    is '0', 'false', 'False' or 'off'.  The ops stay callable either way."""
    return os.environ.get("MXNET_FUSE_EPILOGUE", "1") not in (
        "0", "false", "False", "off")


# ---------------------------------------------------------------------------
# Triton body: a plain module function that triton.jit wraps at first use
# ---------------------------------------------------------------------------
def _bias_gelu_bwd_body(x_ptr, g_ptr, b_ptr, o_ptr, n, C,
                        BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + offs % C, mask=mask, other=0.0).to(tl.float32)
    u = x + b
    # d/du [u * Phi(u)] = Phi(u) + u * phi(u)
    phi = tl.exp(-0.5 * u * u) * 0.3989422804014327
    d = 0.5 * (1.0 + _math.erf(u * 0.7071067811865476)) + u * phi
    tl.store(o_ptr + offs, (g * d).to(o_ptr.dtype.element_ty), mask=mask)


def _triton_kernel(body):
    global tl, _math
    kernel = _kernels.get(body)
    if kernel is None:
        import triton
        import triton.language as language
        tl = language
        if hasattr(language, "erf"):
            _math = language
        else:
            from triton.language.extra import libdevice
            _math = libdevice
        kernel = _kernels[body] = triton.jit(body)
    return kernel


def _check_rowwise(what, x, b, dtypes, bias_dtype_of_x=False):
    C = x.shape[-1]
    if b.shape != (C,) or b.device != x.device:
        raise ValueError("%s: bias must be (%d,) on %s, got %s on %s"
                         % (what, C, x.device, tuple(b.shape), b.device))
    if x.dtype not in dtypes or (bias_dtype_of_x and b.dtype != x.dtype):
        raise TypeError("%s: unsupported dtypes %s, %s" % (what, x.dtype,
                                                           b.dtype))
    if not (x.is_contiguous() and b.is_contiguous()):
        raise ValueError("%s: tensors must be contiguous" % what)


def _device_of(what, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    return x.device.type


# ---------------------------------------------------------------------------
# bias_gelu
# ---------------------------------------------------------------------------
def _dgelu_f32(u):
    phi = torch.exp(-0.5 * u * u) * _INV_SQRT_2PI
    return 0.5 * (1.0 + torch.erf(u * _SQRT_HALF)) + u * phi


def bias_gelu_plain(x, b):
    """gelu(x + b) in fp32, returned in ``x.dtype``.  x: (..., C), b: (C,)."""
    u = x.float() + b.float()
    return (0.5 * u * (1.0 + torch.erf(u * _SQRT_HALF))).to(x.dtype)


def bias_gelu_backward_plain(x, g, b):
    """dx = g * gelu'(x + b) in fp32, returned in ``x.dtype``."""
    u = x.float() + b.float()
    return (g.float() * _dgelu_f32(u)).to(x.dtype)


_GELU_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the H100's SMs: the plan's default, and what the CPU tests plan for
SMS = 132


#: x of at most this many elements (the serving path's shapes) is
#: launched for latency: 4 elements a thread, one row a pass
GELU_SMALL = 1 << 18


@functools.lru_cache(maxsize=None)
def bias_gelu_plan(R, C, itemsize, aligned, sms=SMS):
    """The forward kernel's launch for x of shape (R, C) and elements of
    ``itemsize`` bytes, ``aligned`` when x, out and a bias of x's dtype
    start on 16 bytes: ``(vec, threads, rows, (gx, gy))``.

    - vec: elements a thread moves at once: 16 bytes of them (4 fp32, 8
      bf16 or fp16), at most 4 while R C <= ``GELU_SMALL``; 1 when C is
      not a multiple of that or the pointers are not aligned (a ragged
      C);
    - threads: a block's threads, 128 halved (down to 32) while the grid
      would give fewer blocks than ``sms`` with one row a pass;
    - rows: rows a thread loads before it computes: 1 while R C <=
      ``GELU_SMALL``, else the most of 4, 2 (fp32: 2) that still leaves
      ``sms`` blocks;
    - gx blocks cover a row's C / vec vectors, gy = ceil(R / rows) row
      groups, at most 65535 (the kernel grid-strides over rows beyond
      them).

    The choices were timed on an H100 against the other launches of
    ``chip_smoke.GELU_LAUNCHES`` (a grid-strided launch at large R, other
    rows a pass, 16-byte vectors at the serving shapes)."""
    small = R * C <= GELU_SMALL
    per = min(16 // itemsize, 4) if small else 16 // itemsize
    vec = per if aligned and C % per == 0 else 1
    nv = C // vec
    threads = 128
    while threads > 32 and -(-nv // threads) * R < sms:
        threads //= 2
    gx = -(-nv // threads)
    rows = 1 if small else next(
        (k for k in ((2,) if itemsize == 4 else (4, 2))
         if gx * -(-R // k) >= sms), 1)
    return vec, threads, rows, (gx, min(-(-R // rows), 65535))


def _bias_gelu_forward(x, b):
    if _device_of("bias_gelu", x) == "cpu":
        return bias_gelu_plain(x, b)
    _check_rowwise("bias_gelu", x, b, tuple(_GELU_DTYPES))
    if b.dtype not in _GELU_DTYPES:
        raise TypeError("bias_gelu: unsupported bias dtype %s" % b.dtype)
    if b.dtype != x.dtype:
        b = b.float()           # exact: every bias dtype fits in fp32
    out = torch.empty_like(x)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError("bias_gelu: %d elements, at most 2**31 - 1" % n)
    if n:
        C = x.shape[-1]
        R = n // C
        same = b.dtype == x.dtype
        xp, bp, op = x.data_ptr(), b.data_ptr(), out.data_ptr()
        # the plan checks C; the vectors need x, out (and a bias of x's
        # dtype, loaded as one) on 16 bytes
        aligned = (xp | op | (bp if same else 0)) % 16 == 0
        vec, threads, rows, (gx, gy) = bias_gelu_plan(
            R, C, x.element_size(), aligned, _sms(x.device.index))
        lib = _lib()
        rc = lib.mxt_bias_gelu_fwd(
            xp, bp, op, R, C, _GELU_DTYPES[x.dtype], int(not same), vec,
            threads, rows, gx, gy,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "bias_gelu")
        bias_gelu.launches += 1
        bias_gelu.last_dtype = x.dtype
    return out


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def bias_gelu_backward(x, g, b):
    """dx = g * gelu'(x + b), exact erf.  x, g: (..., C) contiguous, of one
    dtype; b: (C,).  A CPU tensor takes :func:`bias_gelu_backward_plain`; a
    CUDA tensor launches the Triton kernel (counted in
    ``bias_gelu_backward.launches``)."""
    if _device_of("bias_gelu_backward", x) == "cpu":
        return bias_gelu_backward_plain(x, g, b)
    _check_rowwise("bias_gelu_backward", x, b, tuple(_GELU_DTYPES))
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("bias_gelu_backward: g must match x")
    g = g.contiguous()
    kernel = _triton_kernel(_bias_gelu_bwd_body)
    dx = torch.empty_like(x)
    n = x.numel()
    if n:
        kernel[(-(-n // _BLOCK),)](x, g, b, dx, n, x.shape[-1], BLOCK=_BLOCK)
        bias_gelu_backward.launches += 1
        bias_gelu_backward.last_dtype = x.dtype
    return dx


bias_gelu_backward.launches = 0
bias_gelu_backward.last_dtype = None


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b):
        ctx.save_for_backward(x, b)
        return _bias_gelu_forward(x, b)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        dx = bias_gelu_backward(x, g.contiguous(), b)
        db = dx.reshape(-1, dx.shape[-1]).float().sum(0).to(b.dtype)
        return dx, db


def bias_gelu(x, b):
    """gelu(x + b), exact erf, with its gradient.  x: (..., C) contiguous,
    b: (C,).

    A CPU tensor takes :func:`bias_gelu_plain`; a CUDA tensor launches the
    CUDA kernel (counted in ``bias_gelu.launches``).
    Under autograd the backward is :func:`bias_gelu_backward`."""
    if torch.is_grad_enabled() and (x.requires_grad or b.requires_grad):
        return _BiasGelu.apply(x, b)
    return _bias_gelu_forward(x, b)


bias_gelu.launches = 0
bias_gelu.last_dtype = None


# ---------------------------------------------------------------------------
# bias_dropout_residual
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_BDR_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its entry points typed (once)."""
    lib = _build.load("epilogue")
    fn = lib.mxt_bias_dropout_residual_fwd
    fn.argtypes = [_P] * 5 + [_I] * 5 + [ctypes.c_uint, ctypes.c_float, _P]
    fn.restype = _I
    fn = lib.mxt_bias_dropout_residual_bwd
    fn.argtypes = [_P] * 3 + [_I] * 4 + [ctypes.c_uint, ctypes.c_float, _P]
    fn.restype = _I
    fn = lib.mxt_bias_gelu_fwd
    fn.argtypes = [_P] * 3 + [_I] * 9 + [_P]
    fn.restype = _I
    return lib


def _vec(*tensors):
    """16 bytes per thread when every row and pointer allows it."""
    t = tensors[0]
    per16 = 16 // t.element_size()
    ok = t.shape[-1] % per16 == 0 and all(
        a.data_ptr() % 16 == 0 for a in tensors)
    return per16 if ok else 1


def bias_dropout_residual_plain(x, b, r, rate, seed=None):
    """r + dropout_hash(x + b) in fp32, returned in ``x.dtype``.  x, r:
    (R, C); ``seed``: an int64 tensor of one element (unused at rate 0)."""
    u = x.float() + b.float()
    if rate:
        u = u * _hash.keep_scale_rows(seed, 0, u.shape, rate)
    return (r.float() + u).to(x.dtype)


def bias_dropout_residual_backward_plain(g, rate, seed):
    """dx = keep * g for rate > 0, in ``g.dtype``."""
    return (g.float() * _hash.keep_scale_rows(seed, 0, g.shape, rate)).to(
        g.dtype)


def _bdr_forward(x, b, r, rate, seed):
    if _device_of("bias_dropout_residual", x) == "cpu":
        return bias_dropout_residual_plain(x, b, r, rate, seed)
    _check_rowwise("bias_dropout_residual", x, b, tuple(_BDR_DTYPES),
                   bias_dtype_of_x=True)
    if (r.shape != x.shape or r.dtype != x.dtype or r.device != x.device
            or not r.is_contiguous()):
        raise ValueError("bias_dropout_residual: r must match x")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError("bias_dropout_residual: %d elements, at most "
                         "2**31 - 1" % n)
    out = torch.empty_like(x)
    if n:
        lib = _lib()
        rc = lib.mxt_bias_dropout_residual_fwd(
            x.data_ptr(), b.data_ptr(), r.data_ptr(),
            seed.data_ptr() if rate else None, out.data_ptr(), n,
            x.shape[-1], _BDR_DTYPES[x.dtype], _vec(x, b, r, out),
            int(bool(rate)), _hash.keep_threshold(rate) if rate else 0,
            _hash.keep_scale(rate) if rate else 1.0,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "bias_dropout_residual")
        bias_dropout_residual.launches_fwd += 1
        bias_dropout_residual.last_dtype = x.dtype
    return out


def _bdr_backward(g, rate, seed):
    if _device_of("bias_dropout_residual", g) == "cpu":
        return bias_dropout_residual_backward_plain(g, rate, seed)
    if g.dtype not in _BDR_DTYPES:
        raise TypeError("bias_dropout_residual: unsupported dtype %s"
                        % g.dtype)
    g = g.contiguous()
    dx = torch.empty_like(g)
    n = g.numel()
    if n:
        lib = _lib()
        rc = lib.mxt_bias_dropout_residual_bwd(
            g.data_ptr(), seed.data_ptr(), dx.data_ptr(), n, g.shape[-1],
            _BDR_DTYPES[g.dtype], _vec(g, dx), _hash.keep_threshold(rate),
            _hash.keep_scale(rate),
            torch.cuda.current_stream(g.device).cuda_stream)
        _build.check(lib, rc, "bias_dropout_residual (backward)")
        bias_dropout_residual.launches_bwd += 1
        bias_dropout_residual.last_dtype = g.dtype
    return dx


class _BiasDropoutResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, r, seed, rate):
        # only the one-element seed is saved: the backward rebuilds the
        # mask from (seed, position)
        ctx.rate, ctx.b_dtype = rate, b.dtype
        if rate:
            ctx.save_for_backward(seed)
        return _bdr_forward(x, b, r, rate, seed)

    @staticmethod
    def backward(ctx, g):
        if ctx.rate:
            (seed,) = ctx.saved_tensors
            dx = _bdr_backward(g, ctx.rate, seed)
        else:
            dx = g
        db = dx.float().sum(0).to(ctx.b_dtype)
        return dx, db, g, None, None


def bias_dropout_residual(x, b, r, rate=0.0, seed=None, generator=None):
    """r + dropout(x + b) with its gradient, ``rate`` already resolved for
    train or eval mode (0 = no dropout).  x, r: (..., C) contiguous, b:
    (C,).

    The mask is the hash of (seed, global row, column) of the (R, C) view.
    ``seed`` (a uint32 int) fixes it, as the tests do to match the JAX
    package; otherwise a uint32 is drawn on ``x``'s device from
    ``generator`` (the default generator when None).  At rate 0 the
    backward is ``dx = g`` and launches nothing."""
    if not 0.0 <= rate < 1.0:
        raise ValueError("bias_dropout_residual: rate must be in [0, 1), "
                         "got %r" % (rate,))
    rate = float(rate)
    if rate == 0.0:
        seed_t = None
    elif seed is not None:
        seed_t = torch.tensor([int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                              device=x.device)
    else:
        seed_t = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                               device=x.device, generator=generator)
    shape = x.shape
    C = shape[-1]
    x2 = x.reshape(-1, C).contiguous()
    r2 = r.reshape(-1, C).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or b.requires_grad
                                    or r.requires_grad):
        out = _BiasDropoutResidual.apply(x2, b, r2, seed_t, rate)
    else:
        out = _bdr_forward(x2, b, r2, rate, seed_t)
    return out.reshape(shape)


bias_dropout_residual.launches_fwd = 0
bias_dropout_residual.launches_bwd = 0
bias_dropout_residual.last_dtype = None
