"""Port parity: ``mxnet_tpu_torch.ops.kernels.fused_cell.lstm_sequence``
(its plain versions, which CPU tensors take) against the JAX
``fused_cell.lstm_sequence(..., mode="interpret")``, the Pallas kernels
#10 and #11 run by the interpreter, forward and gradients through the JAX
``custom_vjp``; the plain backward against autograd through the plain
forward; a bf16 case; and the gate order (a swap of f and u is caught).

The inputs are made with numpy from a seed and handed to both packages.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu_torch.ops.kernels import fused_cell as tfc

torch.set_num_threads(2)

SHAPES = [(6, 3, 8), (5, 2, 13)]          # (T, B, H); 13 is ragged


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        gx=rng.standard_normal((T, B, 4 * H)).astype(f32),
        h0=(0.5 * rng.standard_normal((B, H))).astype(f32),
        c0=(0.5 * rng.standard_normal((B, H))).astype(f32),
        w=(0.3 * rng.standard_normal((H, 4 * H))).astype(f32),
        b=(0.2 * rng.standard_normal(4 * H)).astype(f32))


def _weights(T, B, H, seed):
    """Cotangent weights of a loss over out, hT and cT."""
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((T, B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _jax_run(a, ro, rh, rc, dtype=jnp.float32):
    args = [jnp.asarray(a[k]).astype(dtype)
            for k in ("gx", "h0", "c0", "w", "b")]

    def loss(gx, h0, c0, w, b):
        out, hT, cT = jfc.lstm_sequence(gx, h0, c0, w, b, mode="interpret")
        f = lambda t: t.astype(jnp.float32)         # noqa: E731
        return ((f(out) * ro).sum() + (f(hT) * rh).sum()
                + (f(cT) * rc).sum()), (out, hT, cT)

    (_, fwd), grads = jax.value_and_grad(loss, argnums=range(5),
                                         has_aux=True)(*args)
    return ([np.asarray(t.astype(jnp.float32)) for t in fwd],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _torch_run(a, ro, rh, rc, dtype=torch.float32):
    args = [torch.tensor(a[k]).to(dtype).requires_grad_()
            for k in ("gx", "h0", "c0", "w", "b")]
    out, hT, cT = tfc.lstm_sequence(*args)
    loss = ((out.float() * torch.tensor(ro)).sum()
            + (hT.float() * torch.tensor(rh)).sum()
            + (cT.float() * torch.tensor(rc)).sum())
    loss.backward()
    return ([t.detach().float().numpy() for t in (out, hT, cT)],
            [t.grad.float().numpy() for t in args])


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_forward_and_gradients_match_jax_interpret(T, B, H):
    a = _inputs(T, B, H, seed=T * 100 + H)
    ro, rh, rc = _weights(T, B, H, seed=H)
    jf, jg = _jax_run(a, ro, rh, rc)
    launches = (tfc.lstm_sequence.launches_fwd,
                tfc.lstm_sequence.launches_bwd)
    tf, tg = _torch_run(a, ro, rh, rc)
    # CPU tensors take the plain versions: no kernel is launched
    assert launches == (tfc.lstm_sequence.launches_fwd,
                        tfc.lstm_sequence.launches_bwd)
    # fp32 on both sides; products summed in other orders over H and T
    # steps: a few ulps, ~1e-6 on values of order 1
    for name, t, j in zip(("out", "hT", "cT"), tf, jf):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5, err_msg=name)
    for name, t, j in zip(("dgx", "dh0", "dc0", "dW", "db"), tg, jg):
        # dW and db sum T * B products: allow 1e-5 of the largest element
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(j).max()),
                                   err_msg=name)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_plain_backward_matches_autograd_through_plain_forward(T, B, H):
    a = _inputs(T, B, H, seed=7 + H)
    ro, rh, rc = _weights(T, B, H, seed=3 + H)
    _, tg = _torch_run(a, ro, rh, rc)
    args = [torch.tensor(a[k]).requires_grad_()
            for k in ("gx", "h0", "c0", "w", "b")]
    out, cseq = tfc.lstm_sequence_plain(*args)
    loss = ((out * torch.tensor(ro)).sum() + (out[-1] * torch.tensor(rh)).sum()
            + (cseq[-1] * torch.tensor(rc)).sum())
    loss.backward()
    # the same fp32 math, arranged differently (the Function recomputes
    # the gates and contracts dW outside the loop): a few ulps
    for name, t, r in zip(("dgx", "dh0", "dc0", "dW", "db"), tg, args):
        ref = r.grad.numpy()
        np.testing.assert_allclose(t, ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


def test_saved_tensors_are_the_jax_residuals():
    T, B, H = 4, 2, 5
    a = _inputs(T, B, H, seed=1)
    args = [torch.tensor(a[k]).requires_grad_()
            for k in ("gx", "h0", "c0", "w", "b")]
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        tfc.lstm_sequence(*args)
    # gx, h0, c0, W, b, out, cseq (and the views taken of out and cseq for
    # hT and cT): nothing of the per-gate size (T, B, 4H) but gx itself
    assert shapes.count((T, B, 4 * H)) == 1
    assert shapes.count((T, B, H)) == 2, shapes


def _within_bf16_step(t, ref, what):
    """|t - ref| at most one bf16 step of ref (2**-7 relative, an upper
    bound of the spacing) plus 1e-5 of the largest element: the two
    packages' fp32 results, a few ulps apart, can round to neighbouring
    bf16 values."""
    excess = np.abs(t - ref) - np.abs(ref) * 2.0 ** -7
    assert excess.max() <= 1e-5 * max(1.0, np.abs(ref).max()), (
        what, float(excess.max()))


def test_bf16_matches_jax_within_one_bf16_step():
    T, B, H = 5, 3, 13
    a = _inputs(T, B, H, seed=11)
    ro, rh, rc = _weights(T, B, H, seed=11)
    jf, jg = _jax_run(a, ro, rh, rc, jnp.bfloat16)
    tf, tg = _torch_run(a, ro, rh, rc, torch.bfloat16)
    for name, t, j in zip(("out", "hT", "cT", "dgx", "dh0", "dc0", "dW",
                           "db"), tf + tg, jf + jg):
        _within_bf16_step(t, j, name)


def _numpy_reference(a, order):
    """The LSTM loop in float64 numpy, reading the gate blocks of g in the
    given order of (i, f, u, o)."""
    H = a["h0"].shape[1]
    sig = lambda v: 1 / (1 + np.exp(-v))             # noqa: E731
    h, c = a["h0"].astype(np.float64), a["c0"].astype(np.float64)
    outs = []
    for gx in a["gx"]:
        g = gx + h @ a["w"] + a["b"]
        blk = {k: g[:, n * H:(n + 1) * H] for n, k in enumerate(order)}
        c = sig(blk["f"]) * c + sig(blk["i"]) * np.tanh(blk["u"])
        h = sig(blk["o"]) * np.tanh(c)
        outs.append(h)
    return np.stack(outs)


def test_gate_order_i_f_u_o():
    """The port reads g as [i, f, c, o]: it matches a numpy loop in that
    order, and these inputs tell that order from one with f and u
    swapped, so a swap in the port would fail here."""
    a = _inputs(6, 3, 8, seed=5)
    out, _, _ = tfc.lstm_sequence(*(torch.tensor(a[k]) for k in
                                    ("gx", "h0", "c0", "w", "b")))
    right = _numpy_reference(a, ("i", "f", "u", "o"))
    swapped = _numpy_reference(a, ("i", "u", "f", "o"))
    np.testing.assert_allclose(out.numpy(), right, rtol=1e-5, atol=1e-5)
    assert np.abs(swapped - right).max() > 0.1


def test_unsupported_device_raises():
    """A tensor on neither the CPU nor a CUDA card is refused before any
    kernel is built."""
    a = _inputs(2, 1, 4, seed=0)
    t = [torch.tensor(a[k]).to("meta") for k in ("gx", "h0", "c0", "w",
                                                  "b")]
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.lstm_sequence(*t)
