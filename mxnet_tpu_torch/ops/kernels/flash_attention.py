"""Flash attention with its gradient: the port of
``mxnet_tpu/ops/pallas/flash_attention.py``.

- :func:`flash_attention_fwd` — ``(out, lse)``; the CUDA kernel #5 of
  ``csrc/flash_attention.cu``, replacing ``_fwd_kernel``
  (``flash_attention.py:158``).
- :func:`flash_attention_bwd_dq` — ``dq``; kernel #6, replacing
  ``_bwd_dq_kernel`` (``:262``).
- :func:`flash_attention_bwd_dkv` — ``(dk, dv)``; kernel #7, replacing
  ``_bwd_dkv_kernel`` (``:314``).
- :func:`flash_attention_bwd_delta` — ``delta = sum_d dO * O`` in fp32,
  the row statistic #6 and #7 read, over the dropped output ``O``; a
  CUDA kernel of its own, where the JAX package reduces in jnp between
  its kernels (``:466``): it replaces no TPU kernel.
- :func:`flash_attention` — the kernels as a ``torch.autograd.Function``
  that saves ``q, k, v, out, lse``, the one-element seed and
  ``kv_length``, and no (L, L) tensor: the backward recomputes the
  probabilities from ``lse``.

q, k, v: (B, H, L, D).  All three kernels read strided views where they
lie (a head slice, BERT's permuted projection, the transposed gradient
of the output; see :func:`_strided_ok`), and write into given output
views (``out=`` and ``lse=``; ``dq=``; ``dk=`` and ``dv=``), so a caller
that works on slices of larger tensors copies nothing.  The mask is the
JAX kernel's: ``causal``, a
symmetric band ``window``, and ``kv_length`` (B,) valid keys per batch
row.  Dropout drops normalised probabilities with the hash of
:mod:`.dropout_hash` over (seed, b * H + h, row, key); the normaliser sums
the undropped ones.  A row with no valid key gives 0 and ``lse = -inf``,
as the reference attention does (the JAX kernel's output there depends
on its tiling).

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor (or raises), counting launches in
``flash_attention.launches_fwd``, ``.launches_dq``, ``.launches_dkv`` and
``.launches_delta``;
``flash_attention.last_dtype`` is the dtype of the last launch.  The
kernels take float32 and bfloat16 and any head dim in [1, 128]
(:data:`HEAD_DIMS`).  The kernels themselves run a multiple of 8 (every D
but 32, 64 and 128 on the kernels of the next of them, on zero-filled
columns); for any other D each wrapper zero-pads q, k, v (and dO, O) to
the next multiple of 8, takes the default scale from the true D, and
slices out, dq, dk and dv back to D (:func:`_pad8`);
:func:`flash_attention` pads q, k, v and dO once for its forward and
backward together.  That is exact: zero columns add nothing to QK^T, the
zero columns of V give zero columns of O, which the slice drops, lse is
unchanged, and the dropout hash keys on (batch * head, row, key), not on
D.  In bfloat16 the probabilities are rounded to bf16 before ``P @ V`` and
``dS`` before its two products, as the JAX kernel casts.  The float32
kernels run their products on the tensor cores in 3xTF32, which keeps
them fp32-accurate.  What bounds
them and how they are tiled: the note at the top of the CUDA source.
:func:`flash_attention` casts ``kv_length`` to int32 once for the three
kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from . import dropout_hash as _hash

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_delta", "flash_attention_bwd_delta_plain",
           "HEAD_DIMS"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the wrappers take on the card: any D in [1, 128]
HEAD_DIMS = _build.HEAD_DIMS["flash"]
_TAIL = [_I] * 5 + [ctypes.c_float, _I, _I, ctypes.c_uint, ctypes.c_float,
                    _P]


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its entry points typed (once)."""
    lib = _build.load("flash_attention")
    for name, n_ptr in (("mxt_flash_fwd", 7), ("mxt_flash_bwd_dq", 9),
                        ("mxt_flash_bwd_dkv", 10)):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * n_ptr + _TAIL + [_P]    # ... strides
        fn.restype = _I
    lib.mxt_flash_bwd_delta.argtypes = [_P] * 3 + [_I] * 5 + [_P, _P]
    lib.mxt_flash_bwd_delta.restype = _I
    return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _valid(B, H, L, causal, window, kv_length, device):
    """Boolean (B or 1, 1, L, L) mask of valid (row, key) pairs, or None."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    m = None
    if causal:
        m = j <= i
    if window is not None:
        w = (i - j).abs() <= window
        m = w if m is None else m & w
    if m is not None:
        m = m[None, None]
    if kv_length is not None:
        km = j[None, None] < kv_length.to(device).reshape(B, 1, 1, 1)
        m = km if m is None else m & km
    return m


def _keep(seed, B, H, L, rate, device):
    """Float32 (B, H, L, L) dropout multiplier: 0 or ``keep_scale``."""
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    gi = torch.arange(L, device=device)[:, None]
    gj = torch.arange(L, device=device)[None, :]
    bits = _hash.hash_keep_bits(seed.reshape(()), bh, gi, gj)
    return (bits >= _hash.keep_threshold(rate)).float() * _hash.keep_scale(
        rate)


def _round(t, dtype):
    """``t`` as a cast to ``dtype`` and back leaves it."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _scale(scale, D):
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def flash_attention_plain(q, k, v, causal=False, window=None, scale=None,
                          dropout=0.0, seed=None, kv_length=None):
    """The kernels' function in plain PyTorch: ``(out (B, H, L, D) in
    q.dtype, lse (B, H, L) float32)``.  Differentiable by autograd (it
    keeps the (L, L) probabilities).  ``seed``: an int64 tensor of one
    element, read when ``dropout > 0``."""
    B, H, L, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(
        scale, D)
    valid = _valid(B, H, L, causal, window, kv_length, q.device)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m = s.detach().amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                        # 0 where masked
    l = p.sum(-1, keepdim=True)
    if dropout:
        p = p * _keep(seed, B, H, L, dropout, q.device)
    empty = l == 0
    out = torch.matmul(_round(p, q.dtype), v.float()) / torch.where(
        empty, torch.ones_like(l), l)
    lse = torch.where(empty, float("-inf"), m + torch.log(l))
    return out.to(q.dtype), lse[..., 0]


def _bwd_parts(q, k, v, do, lse, delta, causal, window, scale, dropout,
               seed, kv_length):
    """(P * keep, dS) as float32 (B, H, L, L), each rounded as the
    kernels round it."""
    B, H, L, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(
        scale, D)
    ok = torch.isfinite(lse)[..., None].expand(B, H, L, L)
    valid = _valid(B, H, L, causal, window, kv_length, q.device)
    if valid is not None:
        ok = ok & valid
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    pd = p
    if dropout:
        keep = _keep(seed, B, H, L, dropout, q.device)
        dp = dp * keep
        pd = p * keep
    ds = p * (dp - delta[..., None])
    return _round(pd, q.dtype), _round(ds, q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 window=None, scale=None, dropout=0.0,
                                 seed=None, kv_length=None):
    """dq of the kernels' backward in plain PyTorch, in q.dtype."""
    _, ds = _bwd_parts(q, k, v, do, lse, delta, causal, window, scale,
                       dropout, seed, kv_length)
    return (torch.matmul(ds, k.float()) * _scale(scale, q.shape[-1])).to(
        q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  window=None, scale=None, dropout=0.0,
                                  seed=None, kv_length=None):
    """(dk, dv) of the kernels' backward in plain PyTorch, in q.dtype."""
    pd, ds = _bwd_parts(q, k, v, do, lse, delta, causal, window, scale,
                        dropout, seed, kv_length)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * _scale(
        scale, q.shape[-1])
    dv = torch.matmul(pd.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_delta_plain(do, out):
    """``delta = sum_d dO * O`` (B, H, L) in fp32, in plain PyTorch."""
    return (do.float() * out.float()).sum(-1)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------
def _on_cpu(what, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (what, q.device))
    return q.device.type == "cpu"


def _card(t):
    """``t`` contiguous and 16-byte aligned, as the kernels read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=256)
def _layout(shape, stride):
    """(strides, contiguous) of a view of ``shape`` and ``stride``: its
    strides in elements, a dim of size 1 given the stride a contiguous
    tensor would have there (it is never stepped along, and
    ``contiguous()`` leaves whatever stride it had), and whether they are
    a contiguous tensor's.  Cached: a caller hands the same few layouts
    every step."""
    out, run, contiguous = [], 1, True
    for n, s in zip(reversed(shape), reversed(stride)):
        contiguous = contiguous and (n == 1 or s == run)
        out.append(s if n > 1 else run)
        run *= n
    return tuple(out[::-1]), contiguous


def _strides(t):
    """``t``'s strides in elements, as :func:`_layout` gives them."""
    return _layout(t.shape, t.stride())[0]


@functools.lru_cache(maxsize=256)
def _layout_ok(shape, stride, elt):
    """:func:`_strided_ok` but for the base's alignment."""
    st, contiguous = _layout(shape, stride)
    if contiguous:              # every stride a multiple of D's row
        return shape[-1] * elt % 16 == 0
    return st[-1] == 1 and all(0 < s * elt < 2 ** 40 and s * elt % 16 == 0
                               for s in st[:-1])


def _strided_ok(t):
    """Whether the kernels can read or write the (B, H, L, D) view
    ``t`` where it lies: unit stride along D, and TMA's rules for a tensor
    map (a 16-byte aligned base, every other stride a positive multiple of
    16 bytes below 2**40).  Any other view is copied first."""
    return t.data_ptr() % 16 == 0 and _layout_ok(t.shape, t.stride(),
                                                 t.element_size())


def _as_read(t):
    """``t`` as the kernels read it: the view itself, or a copy."""
    return t if _strided_ok(t) else _card(t)


def _as_stats(t):
    """The (B, H, L) float32 ``t`` (lse, delta) as the backward kernels
    read it: the view itself where its rows have unit stride, else a
    copy."""
    return t if _strides(t)[-1] == 1 else t.contiguous()


def _stride_args(views, stats):
    """The entry points' ``strides``: None when every tensor is
    contiguous, else the B, H and L strides of each (B, H, L, D) view of
    ``views`` and the B and H strides of each (B, H, L) tensor of
    ``stats``."""
    return _stride_array(tuple((t.shape, t.stride()) for t in views),
                         tuple((t.shape, t.stride()) for t in stats))


@functools.lru_cache(maxsize=256)
def _stride_array(views, stats):
    """:func:`_stride_args` of the views' and stats' (shape, stride), one
    ctypes array per layout (the entry points only read it)."""
    views = [_layout(*v) for v in views]
    stats = [_layout(*t) for t in stats]
    if all(contiguous for _, contiguous in views + stats):
        return None
    flat = ([s for own, _ in views for s in own[:3]]
            + [s for own, _ in stats for s in own[:2]])
    return (ctypes.c_longlong * len(flat))(*flat)


def _target(q, t):
    """What a kernel writes for the output view ``t`` shaped like q: ``t``
    itself where it can write it in place, else a new tensor (also when
    ``t`` is None), which :func:`_deliver` copies into ``t``."""
    return t if t is not None and _strided_ok(t) else torch.empty(
        q.shape, dtype=q.dtype, device=q.device)


def _deliver(written, t):
    """The result of an output view ``t`` (None: none given) that the
    kernel wrote into ``written``."""
    return written if t is None or written is t else t.copy_(written)


def _check(what, q, k, v, window, kv_length):
    B, H, L, D = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError("%s: unsupported dtype %s (float32, bfloat16)"
                        % (what, q.dtype))
    _build.check_head_dim(what, D, "flash")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("%s: q, k and v must match: %s %s %s"
                             % (what, tuple(q.shape), q.dtype, q.device))
    if not 0 < B * H <= 65535:
        raise ValueError("%s: B * H = %d, at most 65535" % (what, B * H))
    if window is not None and int(window) < 0:
        raise ValueError("%s: window must be >= 0" % what)
    if kv_length is not None and (kv_length.shape != (B,)
                                  or kv_length.device != q.device):
        raise ValueError("%s: kv_length must be (%d,) on %s"
                         % (what, B, q.device))


def _common(q, causal, window, scale, dropout, seed, kv_length):
    """The entry points' trailing arguments and the kept tensors."""
    B, H, L, D = q.shape
    kvl = None if kv_length is None else kv_length.to(torch.int32)
    seed_t = seed if dropout else None
    tail = [B * H, H, L, D, _DTYPES[q.dtype], _scale(scale, D), int(causal),
            -1 if window is None else int(window),
            _hash.keep_threshold(dropout) if dropout else 0,
            _hash.keep_scale(dropout) if dropout else 1.0,
            torch.cuda.current_stream(q.device).cuda_stream]
    ptrs = [None if seed_t is None else seed_t.data_ptr(),
            None if kvl is None else kvl.data_ptr()]
    return tail, ptrs, (seed_t, kvl)


def _pad8(D, *tensors):
    """``tensors`` zero-padded along their last dim from ``D`` to the next
    multiple of 8, as the kernels take them (they are contiguous after)."""
    pad = -D % 8
    return [torch.nn.functional.pad(t, (0, pad)) for t in tensors]


def _check_like(what, q, **outs):
    """Raise unless each given output view is shaped, typed and placed
    like q."""
    for name, t in outs.items():
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype
                              or t.device != q.device):
            raise ValueError("%s: %s must match q" % (what, name))


def _check_outputs(q, out, lse):
    B, H, L, _ = q.shape
    _check_like("flash_attention", q, out=out)
    if lse is not None and (lse.shape != (B, H, L)
                            or lse.dtype != torch.float32
                            or lse.device != q.device):
        raise ValueError("flash_attention: lse must be float32 %s"
                         % ((B, H, L),))


def flash_attention_fwd(q, k, v, causal=False, window=None, scale=None,
                        dropout=0.0, seed=None, kv_length=None, out=None,
                        lse=None):
    """``(out, lse)``: a CPU tensor takes :func:`flash_attention_plain`; a
    CUDA tensor launches kernel #5 (counted in
    ``flash_attention.launches_fwd``).  ``seed``: an int64 tensor of one
    element on q's device, read when ``dropout > 0``.

    q, k and v may be strided (B, H, L, D) views (a head slice, BERT's
    permuted projection): the kernel reads them where they lie when
    :func:`_strided_ok` admits them, else reads a contiguous copy.  ``out``
    (like q) and ``lse`` (float32 (B, H, L)), when given, are views the
    results are written into, and nothing else of their storage is
    touched; they are returned."""
    _check_outputs(q, out, lse)
    if _on_cpu("flash_attention", q):
        # the plain version on contiguous copies, so a view gives the same
        # bits as its copy
        o, l = flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, window, scale,
                                     dropout, seed, kv_length)
        if out is not None:
            o = out.copy_(o)
        if lse is not None:
            l = lse.copy_(l)
        return o, l
    _check("flash_attention", q, k, v, window, kv_length)
    D = q.shape[-1]
    if D % 8:
        o, l = flash_attention_fwd(*_pad8(D, q, k, v), causal, window,
                                   _scale(scale, D), dropout, seed, kv_length,
                                   lse=lse)
        return _deliver(o[..., :D], out), l
    q, k, v = _as_read(q), _as_read(k), _as_read(v)
    B, H, L, _ = q.shape
    ko = _target(q, out)
    kl = lse if lse is not None and _strides(lse)[-1] == 1 else torch.empty(
        B, H, L, dtype=torch.float32, device=q.device)
    tail, ptrs, _alive = _common(q, causal, window, scale, dropout, seed,
                                 kv_length)
    lib = _lib()
    rc = lib.mxt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
                           ko.data_ptr(), kl.data_ptr(), *tail,
                           _stride_args([q, k, v, ko], [kl]))
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches_fwd += 1
    flash_attention.last_dtype = q.dtype
    return _deliver(ko, out), _deliver(kl, lse)


def _bwd_inputs(what, q, k, v, do, lse, delta, window, kv_length):
    """(q, k, v, dO, lse, delta) as the backward kernels read them: each
    view where it lies, when the kernels can read it there."""
    _check(what, q, k, v, window, kv_length)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("%s: dout must match q" % what)
    for t in (lse, delta):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError("%s: lse and delta must be float32 %s"
                             % (what, tuple(q.shape[:3])))
    return ([_as_read(t) for t in (q, k, v, do)]
            + [_as_stats(t) for t in (lse, delta)])


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           window=None, scale=None, dropout=0.0, seed=None,
                           kv_length=None, dq=None):
    """dq from (q, k, v, dO, lse, delta = sum_d dO * O): a CPU tensor takes
    :func:`flash_attention_bwd_dq_plain`; a CUDA tensor launches kernel
    #6 (counted in ``flash_attention.launches_dq``).

    Every input may be a strided view (as for :func:`flash_attention_fwd`;
    lse and delta need unit stride along L, else they are copied).  ``dq``
    (like q), when given, is a view the result is written into, and
    nothing else of its storage is touched; it is returned."""
    what = "flash_attention_bwd_dq"
    _check_like(what, q, dq=dq)
    if _on_cpu(what, q):
        # the plain version on contiguous copies, so a view gives the same
        # bits as its copy
        r = flash_attention_bwd_dq_plain(
            *(t.contiguous() for t in (q, k, v, do, lse, delta)), causal,
            window, scale, dropout, seed, kv_length)
        return _deliver(r, dq)
    ins = _bwd_inputs(what, q, k, v, do, lse, delta, window, kv_length)
    D = q.shape[-1]
    if D % 8:
        r = flash_attention_bwd_dq(*_pad8(D, q, k, v, do), lse, delta,
                                   causal, window, _scale(scale, D), dropout,
                                   seed, kv_length)
        return _deliver(r[..., :D], dq)
    out_q = _target(q, dq)
    tail, ptrs, _alive = _common(ins[0], causal, window, scale, dropout,
                                 seed, kv_length)
    lib = _lib()
    rc = lib.mxt_flash_bwd_dq(*(t.data_ptr() for t in ins), *ptrs,
                              out_q.data_ptr(), *tail,
                              _stride_args(ins[:4] + [out_q], ins[4:]))
    _build.check(lib, rc, what)
    flash_attention.launches_dq += 1
    flash_attention.last_dtype = q.dtype
    return _deliver(out_q, dq)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            window=None, scale=None, dropout=0.0, seed=None,
                            kv_length=None, dk=None, dv=None):
    """(dk, dv) from (q, k, v, dO, lse, delta): a CPU tensor takes
    :func:`flash_attention_bwd_dkv_plain`; a CUDA tensor launches kernel
    #7 (counted in ``flash_attention.launches_dkv``).  Inputs as
    :func:`flash_attention_bwd_dq`'s; ``dk`` and ``dv`` (like q), when
    given, are views the results are written into, and returned."""
    what = "flash_attention_bwd_dkv"
    _check_like(what, q, dk=dk, dv=dv)
    if _on_cpu(what, q):
        rk, rv = flash_attention_bwd_dkv_plain(
            *(t.contiguous() for t in (q, k, v, do, lse, delta)), causal,
            window, scale, dropout, seed, kv_length)
        return _deliver(rk, dk), _deliver(rv, dv)
    ins = _bwd_inputs(what, q, k, v, do, lse, delta, window, kv_length)
    D = q.shape[-1]
    if D % 8:
        rk, rv = flash_attention_bwd_dkv(*_pad8(D, q, k, v, do), lse, delta,
                                         causal, window, _scale(scale, D),
                                         dropout, seed, kv_length)
        return _deliver(rk[..., :D], dk), _deliver(rv[..., :D], dv)
    out_k, out_v = _target(q, dk), _target(q, dv)
    tail, ptrs, _alive = _common(ins[0], causal, window, scale, dropout,
                                 seed, kv_length)
    lib = _lib()
    rc = lib.mxt_flash_bwd_dkv(*(t.data_ptr() for t in ins), *ptrs,
                               out_k.data_ptr(), out_v.data_ptr(), *tail,
                               _stride_args(ins[:4] + [out_k, out_v],
                                            ins[4:]))
    _build.check(lib, rc, what)
    flash_attention.launches_dkv += 1
    flash_attention.last_dtype = q.dtype
    return _deliver(out_k, dk), _deliver(out_v, dv)


def flash_attention_bwd_delta(do, out):
    """``delta = sum_d dO * O``, (B, H, L) float32, from dO and O (B, H, L,
    D) of one dtype: a CPU tensor takes
    :func:`flash_attention_bwd_delta_plain`; a CUDA tensor launches the
    delta kernel (counted in ``flash_attention.launches_delta``).  dO and
    O may be strided views, read where they lie when :func:`_strided_ok`
    admits them, else from contiguous copies."""
    what = "flash_attention_bwd_delta"
    if _on_cpu(what, do):
        return flash_attention_bwd_delta_plain(do, out)
    B, H, L, D = do.shape
    if (out.shape != do.shape or out.dtype != do.dtype
            or out.device != do.device):
        raise ValueError("%s: dout and out must match: %s %s %s"
                         % (what, tuple(do.shape), do.dtype, do.device))
    if do.dtype not in _DTYPES:
        raise TypeError("%s: unsupported dtype %s (float32, bfloat16)"
                        % (what, do.dtype))
    _build.check_head_dim(what, D, "flash")
    if not B * H * L:
        raise ValueError("%s: shape %s; the kernel takes no empty dim"
                         % (what, tuple(do.shape)))
    if D % 8:
        return flash_attention_bwd_delta(*_pad8(D, do, out))
    do, out = _as_read(do), _as_read(out)
    delta = torch.empty(B, H, L, dtype=torch.float32, device=do.device)
    lib = _lib()
    rc = lib.mxt_flash_bwd_delta(
        do.data_ptr(), out.data_ptr(), delta.data_ptr(), B * H, H, L, D,
        _DTYPES[do.dtype], torch.cuda.current_stream(do.device).cuda_stream,
        _stride_args([do, out], []))
    _build.check(lib, rc, what)
    flash_attention.launches_delta += 1
    return delta


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, kv_length, causal, window, scale,
                dropout):
        D = q.shape[-1]
        if D % 8 and not _on_cpu("flash_attention", q):
            # pad q, k and v once for the forward and the backward, rather
            # than in each of the four wrappers they reach
            _check("flash_attention", q, k, v, window, kv_length)
            q, k, v = _pad8(D, q, k, v)
            scale = _scale(scale, D)
        out, lse = flash_attention_fwd(q, k, v, causal, window, scale,
                                       dropout, seed, kv_length)
        ctx.cfg = (causal, window, scale, dropout)
        ctx.save_for_backward(q, k, v, out, lse, seed, kv_length)
        return out if out.shape[-1] == D else out[..., :D]

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seed, kv_length = ctx.saved_tensors
        D = g.shape[-1]
        if out.shape[-1] != D:
            g, = _pad8(D, g)
        # g (the transposed gradient of BERT's output, say) is read where
        # it lies, as q, k and v are
        delta = flash_attention_bwd_delta(g, out)
        args = ctx.cfg + (seed, kv_length)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, *args)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, *args)
        if out.shape[-1] != D:
            dq, dk, dv = dq[..., :D], dk[..., :D], dv[..., :D]
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal=False, window=None, scale=None,
                    dropout=0.0, seed=None, kv_length=None, generator=None):
    """Blockwise attention with its gradient: q, k, v (B, H, L, D) ->
    (B, H, L, D), ``dropout`` already resolved for train or eval mode.

    ``seed`` (an int, or an int64 tensor of one element) fixes the dropout
    mask, as the tests do to match the JAX package; otherwise a uint32 is
    drawn on q's device from ``generator`` (the default generator when
    None), with no host sync.  ``kv_length``: (B,) valid keys per row."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError("flash_attention: dropout must be in [0, 1), got %r"
                         % (dropout,))
    dropout = float(dropout)
    if not dropout:
        seed_t = None
    elif isinstance(seed, torch.Tensor):
        seed_t = (seed.reshape(1).to(device=q.device, dtype=torch.int64)
                  & 0xFFFFFFFF)
    elif seed is not None:
        seed_t = torch.tensor([int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                              device=q.device)
    else:
        seed_t = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                               device=q.device, generator=generator)
    if kv_length is not None:
        # int32, as the kernels read it: cast once here, not by each of
        # #5, #6 and #7
        kv_length = torch.as_tensor(kv_length, device=q.device).to(
            torch.int32)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, seed_t, kv_length, causal,
                                     window, scale, dropout)
    return flash_attention_fwd(q, k, v, causal, window, scale, dropout,
                               seed_t, kv_length)[0]


flash_attention.launches_fwd = 0
flash_attention.launches_dq = 0
flash_attention.launches_dkv = 0
flash_attention.launches_delta = 0
flash_attention.last_dtype = None
