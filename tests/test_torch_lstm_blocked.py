"""The LSTM backward kernel #11's arithmetic, emulated on the CPU, against
the JAX kernel ``_lstm_bwd_kernel`` run by the Pallas interpreter.

The card's #11 (``csrc/lstm.cu``) recomputes the gate activations in one
product over all steps and then runs the time loop on per-block partial
sums.  Its arithmetic, emulated in fp32 torch:

- the recompute ``h_prev W`` in 3xTF32 on wgmma: each fp32 operand split
  into hi = its top 19 bits (what the tensor core reads) and lo = the
  residual, read the same way; hi hi + hi lo + lo hi, the lo product of a
  bf16 operand (exact in tf32) left out; bf16 h with bf16 W as exact
  products summed in fp32;
- dh as the per-block partial products over U-unit slices of dg's gate
  columns (fp32 FMAs on the CUDA cores: fp32 products summed in fp32),
  summed in the kernel's fixed order: groups of consecutive writer blocks
  in block order, then the groups in order.

It is held within ``chip_smoke``'s tolerances of the kernel on the card
(``TOL_LSTM``, and one bf16 step for a bf16 layer), and a single-TF32
recompute is shown to fail them, so the tolerance tells the two apart.
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
SMS = 132                        # an H100's SMs: the time loop's plan
NTHREADS = 256                   # threads of a time-loop block


def _trunc(x):
    """x with the low 13 bits of each fp32 word cleared: the tf32 value a
    tensor core reads from an fp32 word."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _recompute(hp, w, a_exact, b_exact, single=False):
    """h_prev W as the recompute kernel forms it (``single``: one product
    of operands read as tf32)."""
    if a_exact and b_exact:
        return hp @ w
    ah, bh = _trunc(hp), _trunc(w)
    if single:
        return ah @ bh
    out = ah @ bh
    if not b_exact:
        out = out + ah @ _trunc(w - bh)
    if not a_exact:
        out = out + _trunc(hp - ah) @ bh
    return out


def _plan(H, B):
    """Units per block, blocks and writer groups of the time loop on an
    H100 (the fewest units that put every block on its own SM)."""
    U = max(1, -(-H // SMS))
    nb = -(-H // U)
    nq = -(-B * U // 4)
    return U, nb, max(1, min(nb, NTHREADS // nq))


def _partials(dg, w, U, nb):
    """(nb, B, H): block k's partial product over its units' gate columns,
    in fp32."""
    B, G = dg.shape
    H = G // 4
    pad = nb * U - H
    dgb = torch.nn.functional.pad(dg.reshape(B, 4, H), (0, pad))
    dgb = dgb.reshape(B, 4, nb, U).permute(2, 0, 1, 3).reshape(nb, B, 4 * U)
    wb = torch.nn.functional.pad(w.reshape(H, 4, H), (0, pad))
    wb = wb.reshape(H, 4, nb, U).permute(2, 0, 1, 3).reshape(nb, H, 4 * U)
    return dgb @ wb.transpose(1, 2)


def _group_sum(parts, ng):
    """The partials summed as the kernel sums them: each group of
    consecutive writers in block order, then the groups in order."""
    nb = parts.shape[0]
    total = None
    for gi in range(ng):
        s = torch.zeros_like(parts[0])
        for k in range(gi * nb // ng, (gi + 1) * nb // ng):
            s = s + parts[k]
        total = s if total is None else total + s
    return total


def emulate_bwd(gx, hp, cp, cseq, dout, dcseq, w, b, single=False):
    """dgx, dh0, dc0 of the backward as the card's #11 computes them."""
    T, B, G = gx.shape
    H = G // 4
    W = w.float()
    a_exact = hp.dtype == torch.bfloat16
    w_exact = w.dtype == torch.bfloat16
    pre = _recompute(hp.float().reshape(T * B, H), W, a_exact, w_exact,
                     single).reshape(T, B, G)
    i, f, u, o = (a for a in tfc._lstm_gates(gx.float() + pre + b.float()))
    U, nb, ng = _plan(H, B)
    dh = torch.zeros(B, H)
    dc = torch.zeros(B, H)
    dgx = torch.empty_like(gx)
    for t in range(T - 1, -1, -1):
        dh = dh + dout[t].float()
        tc = torch.tanh(cseq[t])
        d_o = dh * tc
        dc = dc + dcseq[t] + dh * o[t] * (1 - tc * tc)
        dg = torch.cat([(dc * u[t]) * i[t] * (1 - i[t]),
                        (dc * cp[t]) * f[t] * (1 - f[t]),
                        (dc * i[t]) * (1 - u[t] * u[t]),
                        d_o * o[t] * (1 - o[t])], -1)
        dgx[t] = dg.to(gx.dtype)
        dh = _group_sum(_partials(dg, W, U, nb), ng)
        dc = dc * f[t]
    return dgx, dh.to(gx.dtype), dc.to(gx.dtype)


def _case(T, B, H, dt, w_dt, seed):
    """The backward's inputs as ``chip_smoke.lstm_inputs`` makes them
    (random initial state), from numpy, and the forward's carries."""
    rng = np.random.default_rng(seed)

    def t(a, d=torch.float32):
        return torch.tensor(np.asarray(a, np.float32)).to(d)

    gx = t(rng.standard_normal((T, B, 4 * H)), dt)
    h0 = t(0.5 * rng.standard_normal((B, H)), dt)
    c0 = t(0.5 * rng.standard_normal((B, H)), dt)
    w = t((6.0 / (5 * H)) ** 0.5 * (rng.random((4 * H, H)) * 2 - 1),
          w_dt).T
    b = t(0.1 * rng.standard_normal(4 * H), w_dt)
    out, cseq = tfc.lstm_sequence_plain(gx, h0, c0, w, b)
    hp = torch.cat([h0[None], out[:-1]])
    cp = torch.cat([c0[None].float(), cseq[:-1]])
    dout = t(rng.standard_normal((T, B, H)), dt)
    dcs = torch.zeros(T, B, H)
    dcs[-1] = t(rng.standard_normal((B, H)))
    return gx, hp, cp, cseq, dout, dcs, w, b


def _jax_bwd(gx, hp, cp, cseq, dout, dcs, w, b):
    """The JAX kernel ``_lstm_bwd_kernel`` in interpret mode."""
    def j(x):
        a = jnp.asarray(x.float().numpy())
        return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a

    res = jfc._lstm_seq_bwd_pallas(j(gx), j(hp), j(cp), j(cseq), j(dout),
                                   j(dcs), j(w.contiguous()), j(b), True)
    return [torch.tensor(np.asarray(r.astype(jnp.float32))) for r in res]


def _errors(got, ref, dt):
    """chip_smoke's measure per output: max |got - ref| over the largest
    |ref| in fp32; in bf16 what exceeds one bf16 step of ref."""
    out = []
    for g, r in zip(got, ref):
        g = g.float()
        scale = max(float(r.abs().max()), 1e-30)
        if dt == torch.float32:
            out.append(float((g - r).abs().max()) / scale)
        else:
            out.append(chip_smoke.within_bf16_step(g, r) / scale)
    return out


CASES = [((7, 5, 37), torch.float32, None),
         ((7, 5, 37), torch.bfloat16, None),
         ((35, 4, 650), torch.float32, None),
         ((35, 4, 650), torch.bfloat16, None),
         ((35, 4, 650), torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("shape,dt,w_dt", CASES,
                         ids=["%dx%dx%d-%s%s" % (s + (str(d)[6:],
                                                      "-w32" if w else ""))
                              for s, d, w in CASES])
def test_emulated_kernel_matches_jax_interpret(shape, dt, w_dt):
    """dgx, dh0 and dc0 of the emulated #11 within ``TOL_LSTM`` of the JAX
    kernel's (fp32), or within one bf16 step and ``TOL_LSTM`` beyond it."""
    T, B, H = shape
    args = _case(T, B, H, dt, w_dt or dt, seed=H + T)
    errs = _errors(emulate_bwd(*args), _jax_bwd(*args), dt)
    assert max(errs) <= TOL, errs


def test_single_tf32_recompute_fails_the_tolerance():
    """At the word LM's width a recompute of one tf32 product (operands
    read as tf32 once) lands outside ``TOL_LSTM`` of the JAX kernel on
    dgx, dh0 and dc0, where the 3xTF32 one is ~100x inside it."""
    args = _case(35, 4, 650, torch.float32, torch.float32, seed=685)
    ref = _jax_bwd(*args)
    three = _errors(emulate_bwd(*args), ref, torch.float32)
    single = _errors(emulate_bwd(*args, single=True), ref, torch.float32)
    assert max(three) <= TOL / 20, three
    assert min(single) > TOL, single


def test_record_layout_round_trip():
    """``lstm_record_gates`` reads back the activations that the recompute
    kernel's epilogue writes: element (m = t B + b, n = gate H + j) at
    record (t, gate, j, b) of a record nb U units wide, nb U over H."""
    T, B, H, U = 3, 5, 13, 4
    nb = -(-H // U)
    act = torch.randn(T, B, 4 * H, generator=torch.Generator().manual_seed(0))
    rec = torch.full((T * 8 * nb * U * B,), float("nan"))
    m = torch.arange(T * B)[:, None]
    n = torch.arange(4 * H)[None, :]
    gate, j = n // H, n % H
    t, b = m // B, m % B
    idx = ((t * 8 + gate) * nb * U + j) * B + b
    rec[idx.reshape(-1)] = act.reshape(-1)
    assert torch.equal(tfc.lstm_record_gates(rec, T, B, H, U), act)


def test_plain_recompute_is_the_backward_plain_gates():
    """``lstm_bwd_gates_plain`` holds the activations the plain backward
    recomputes: the derivative of out[T-1] with respect to gx's o block
    is tanh(c) o (1 - o), with o from the plain recompute."""
    T, B, H = 2, 3, 5
    gx, hp, cp, cseq, dout, dcs, w, b = _case(T, B, H, torch.float32,
                                              torch.float32, seed=3)
    act = tfc.lstm_bwd_gates_plain(gx, hp, w, b)
    dout = torch.zeros(T, B, H)
    dout[-1] = 1.0
    dgx, _, _ = tfc.lstm_sequence_backward_plain(
        gx, hp, cp, cseq, dout, torch.zeros(T, B, H), w, b)
    o = act[-1, :, 3 * H:]
    torch.testing.assert_close(dgx[-1, :, 3 * H:],
                               torch.tanh(cseq[-1]) * o * (1 - o))


@pytest.mark.parametrize("e,w_e,carry_products,recompute_products",
                         [(4, 4, 3, 3), (2, 2, 2, None), (2, 4, 3, 2)],
                         ids=["fp32", "bf16", "bf16-w32"])
def test_bounds_charge_the_products_the_function_needs(
        e, w_e, carry_products, recompute_products):
    """``chip_smoke.lstm_bounds`` at the word LM's layer: #10's products
    (fp32 h by W) and #11's dh products (fp32 dg by W) take three tf32
    products with an fp32 W and two with a bf16 one (exact in tf32); the
    recompute (h_prev by W) likewise, and bf16 x bf16 runs at the bf16
    rate (``None``)."""
    T, B, H = 35, 32, 650
    flops = 2 * T * B * H * 4 * H
    (f, f_by), (b, b_by), (g, _) = chip_smoke.lstm_bounds(T, B, H, e, w_e)
    carry = carry_products * flops / chip_smoke.TF32_FLOPS
    recompute = (flops / chip_smoke.BF16_FLOPS if recompute_products is None
                 else recompute_products * flops / chip_smoke.TF32_FLOPS)
    assert f_by == b_by == "operations"
    assert f == pytest.approx(carry * 1e3)
    assert b == pytest.approx((carry + recompute) * 1e3)
    assert g >= recompute * 1e3 * (1 - 1e-9)
