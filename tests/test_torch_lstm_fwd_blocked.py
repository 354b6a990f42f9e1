"""The LSTM forward kernel #10's arithmetic, emulated on the CPU, against
the JAX kernel ``_lstm_fwd_kernel`` run by the Pallas interpreter.

The card's #10 (``csrc/lstm.cu``) forms each step's gate pre-activations
of a block's units as a (32 x 4U) product over K = H on the tensor cores,
``mma.sync`` m16n8k8 in tf32, the 8 warps of a block each taking a slice
of whole k8 steps.  Its arithmetic, emulated in fp32 torch:

- 3xTF32: the fp32 carry h and W each read as their fp32 words (the
  tensor core takes the top 19 bits: hi) and split into the residual
  (lo), lo hi + hi lo + hi hi; the hi lo product left out when W holds
  bf16 values (exact in tf32);
- each warp's K slice summed on its own, the slices added in warp order;
- g = (gx + the sum) + b, the nonlinearities and the carries in fp32,
  out in the layer's type.

It is held within ``chip_smoke``'s tolerance of the JAX kernel
(``TOL_LSTM``, and one bf16 step for a bf16 layer), and a single-TF32
product is shown to fail it, so the tolerance tells the two apart.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu_torch.ops.kernels import fused_cell as tfc

torch.set_num_threads(2)

TOL = chip_smoke.TOL_LSTM
NWARPS = 8                       # warps of a block, each a slice of K


def _trunc(x):
    """x with the low 13 bits of each fp32 word cleared: the tf32 value a
    tensor core reads from an fp32 word."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _slices(H):
    """Each warp's K range: whole k8 steps of K padded to 8, split as the
    kernel splits them, [w nk / 8, (w + 1) nk / 8) steps."""
    nk = -(-H // 8)
    return [(8 * (w * nk // NWARPS), min(H, 8 * ((w + 1) * nk // NWARPS)))
            for w in range(NWARPS)]


def _product(h, w, w_exact, single=False):
    """h W over one K slice as the tensor cores form it in 3xTF32 (one
    product of operands read as tf32 when ``single``)."""
    hh, wh = _trunc(h), _trunc(w)
    if single:
        return hh @ wh
    out = _trunc(h - hh) @ wh
    if not w_exact:
        out = out + hh @ _trunc(w - wh)
    return out + hh @ wh


def emulate_fwd(gx, h0, c0, w, b, single=False):
    """out (the layer's type) and cseq (fp32) of the forward as the card's
    #10 computes them."""
    T, B, G = gx.shape
    H = G // 4
    W = w.float()
    w_exact = w.dtype == torch.bfloat16
    h, c = h0.float(), c0.float()
    out = torch.empty(T, B, H, dtype=gx.dtype)
    cseq = torch.empty(T, B, H)
    for t in range(T):
        pre = None
        for k0, k1 in _slices(H):
            if k0 >= k1:
                continue
            p = _product(h[:, k0:k1], W[k0:k1], w_exact, single)
            pre = p if pre is None else pre + p
        i, f, u, o = tfc._lstm_gates(gx[t].float() + pre + b.float())
        c = f * c + i * u
        h = o * torch.tanh(c)
        out[t] = h.to(gx.dtype)
        cseq[t] = c
    return out, cseq


def _case(T, B, H, dt, w_dt, seed):
    """The forward's inputs as ``chip_smoke.lstm_inputs`` makes them
    (random initial state), from numpy."""
    rng = np.random.default_rng(seed)

    def t(a, d=torch.float32):
        return torch.tensor(np.asarray(a, np.float32)).to(d)

    gx = t(rng.standard_normal((T, B, 4 * H)), dt)
    h0 = t(0.5 * rng.standard_normal((B, H)), dt)
    c0 = t(0.5 * rng.standard_normal((B, H)), dt)
    w = t((6.0 / (5 * H)) ** 0.5 * (rng.random((4 * H, H)) * 2 - 1),
          w_dt).T
    b = t(0.1 * rng.standard_normal(4 * H), w_dt)
    return gx, h0, c0, w, b


def _jax_fwd(gx, h0, c0, w, b):
    """The JAX kernel ``_lstm_fwd_kernel`` in interpret mode."""
    def j(x):
        a = jnp.asarray(x.float().numpy())
        return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a

    out, cseq, _ = jfc._lstm_seq_fwd_pallas(j(gx), j(h0), j(c0),
                                            j(w.contiguous()), j(b), True)
    return [torch.tensor(np.asarray(r.astype(jnp.float32)))
            for r in (out, cseq)]


def _errors(got, ref, dt):
    """chip_smoke's measure: max |got - ref| of out (in bf16, what exceeds
    one bf16 step of ref) and of cseq."""
    out, cseq = got
    e_out = (float((out.float() - ref[0]).abs().max()) if dt == torch.float32
             else chip_smoke.within_bf16_step(out, ref[0]))
    return [e_out, float((cseq - ref[1]).abs().max())]


CASES = [((7, 5, 37), torch.float32, None),
         ((7, 5, 37), torch.bfloat16, None),
         ((12, 4, 650), torch.float32, None),
         ((12, 4, 650), torch.bfloat16, None),
         ((12, 4, 650), torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape,dt,w_dt", CASES,
                         ids=["%dx%dx%d-%s%s" % (s + (str(d)[6:],
                                                      "-w32" if w else ""))
                              for s, d, w in CASES])
def test_emulated_kernel_matches_jax_interpret(shape, dt, w_dt):
    """out and cseq of the emulated #10 within ``TOL_LSTM`` of the JAX
    kernel's (fp32), out within one bf16 step and ``TOL_LSTM`` beyond it
    (bf16)."""
    T, B, H = shape
    args = _case(T, B, H, dt, w_dt or dt, seed=H + T)
    errs = _errors(emulate_fwd(*args), _jax_fwd(*args), dt)
    assert max(errs) <= TOL, errs


def test_single_tf32_product_fails_the_tolerance():
    """At the word LM's width a single product of operands read as tf32
    lands outside ``TOL_LSTM`` of the JAX kernel on out and cseq, where
    the 3xTF32 one is ~100x inside it."""
    args = _case(35, 4, 650, torch.float32, torch.float32, seed=685)
    ref = _jax_fwd(*args)
    three = _errors(emulate_fwd(*args), ref, torch.float32)
    single = _errors(emulate_fwd(*args, single=True), ref, torch.float32)
    assert max(three) <= TOL / 20, three
    assert min(single) > TOL, single


@pytest.mark.parametrize("H", [37, 650, 8, 1])
def test_warp_slices_cover_k_once(H):
    """The 8 warps' K slices are whole k8 steps, in order, and cover
    0 .. H once (a warp may get none)."""
    s = _slices(H)
    assert s[0][0] == 0 and s[-1][1] == H
    assert all(a[1] == b[0] or a[1] == H for a, b in zip(s, s[1:]))
    assert all(k0 % 8 == 0 for k0, k1 in s if k0 < k1)
