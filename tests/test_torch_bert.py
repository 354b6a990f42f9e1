"""Port parity: ``mxnet_tpu_torch.models.bert`` against
``mxnet_tpu.models.bert`` on the CPU, at ``bert_tiny`` size (2 layers, 64
units, 2 heads, vocab 1000), with the JAX model's weights carried across
by name (``load_jax_params``) and random biases and LN affines.

- parameter names equal the JAX ``collect_params()`` keys;
- MLM and NSP logits match at dropout 0, without a mask, with a (B,)
  valid-length mask (one row of length 0) and with a dense causal mask,
  with ``MXNET_FUSE_EPILOGUE`` on and off, and with untied embeddings;
- every parameter's gradient of the summed MLM + NSP loss matches the JAX
  ``autograd.record()``/``backward()`` gradient;
- with ``use_flash=True`` (the default) the logits and gradients match
  the JAX model running its flash kernel in Pallas interpret mode
  (``MXNET_FLASH_ATTENTION=interpret``), the port's attention taking the
  kernels' plain version;
- without a GPU the model needs ``device="cpu"``;
- train mode at dropout 0.1 is reproducible from the generator's seed and
  differs from eval mode;
- CPU runs launch no kernel;
- flash attention hands the kernels' wrappers q, k, v as views of the
  layer's projection and dO as the transposed gradient, uncopied.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu import np as mnp
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.ops.kernels import epilogue as tep
from torch_parity import tiny_bert_with_affine

torch.set_num_threads(2)

B, L, V = 3, 12, 1000
# fp32 on both sides; the two frameworks' GEMMs, erf and softmax differ by
# a few ulps, which 2 layers and a 1000-way log-softmax grow to ~1e-6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    return tiny_bert_with_affine()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return dict(tokens=rng.integers(0, V, (B, L)),
                types=rng.integers(0, 2, (B, L)),
                valid=np.array([L, 5, 0]),
                mlm=rng.integers(0, V, (B, L)),
                nsp=rng.integers(0, 2, (B,)))


def port_model(params, **kw):
    kw.setdefault("dropout", 0.0)
    kw.setdefault("use_flash", False)
    net = tbert.bert_tiny(device="cpu", **kw)
    return net.load_jax_params(params)


def test_parameter_names_match_jax(models):
    jnet, params = models
    names = [n for n, _ in port_model(params).named_parameters()]
    assert len(names) == 38
    assert sorted(names) == sorted(jnet.collect_params())


def mask_of(kind, batch):
    """None, the (B,) valid lengths, or a dense causal (1, 1, L, L) mask."""
    if kind == "lengths":
        return batch["valid"]
    if kind == "dense":
        return np.tril(np.ones((L, L), bool))[None, None]
    return None


@pytest.mark.parametrize("fuse", ["1", "0"])
@pytest.mark.parametrize("masked", ["none", "lengths", "dense"])
def test_logits_match_jax(monkeypatch, models, batch, fuse, masked):
    monkeypatch.setenv("MXNET_FUSE_EPILOGUE", fuse)
    jnet, params = models
    net = port_model(params).eval()
    mask = mask_of(masked, batch)
    jm, jn = jnet(mnp.array(batch["tokens"]), mnp.array(batch["types"]),
                  None if mask is None else mnp.array(mask))
    with torch.no_grad():
        tm, tn = net(torch.tensor(batch["tokens"]),
                     torch.tensor(batch["types"]),
                     None if mask is None else torch.tensor(mask))
    assert tm.shape == (B, L, V) and tn.shape == (B, 2)
    np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), **TOL)
    np.testing.assert_allclose(tn.numpy(), jn.asnumpy(), **TOL)


def test_untied_logits_match_jax(batch):
    jnet, params = tiny_bert_with_affine(tie_embeddings=False)
    assert "mlm_decoder.weight" in params
    net = port_model(params, tie_embeddings=False).eval()
    jm, _ = jnet(mnp.array(batch["tokens"]), None, mnp.array(batch["valid"]))
    with torch.no_grad():
        tm, _ = net(torch.tensor(batch["tokens"]), None,
                    torch.tensor(batch["valid"]))
    np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), **TOL)


def jax_grads(jnet, batch):
    mlm_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        jm, jn = jnet(mnp.array(batch["tokens"]), mnp.array(batch["types"]),
                      mnp.array(batch["valid"]))
        loss = (mlm_fn(jm, mnp.array(batch["mlm"]))
                + mlm_fn(jn, mnp.array(batch["nsp"])))
    loss.backward()
    return float(loss.sum()), {n: p.grad().asnumpy()
                               for n, p in jnet.collect_params().items()}


def port_loss(net, batch):
    ce = tloss.SoftmaxCrossEntropyLoss()
    tm, tn = net(torch.tensor(batch["tokens"]), torch.tensor(batch["types"]),
                 torch.tensor(batch["valid"]))
    return (ce(tm, torch.tensor(batch["mlm"]))
            + ce(tn, torch.tensor(batch["nsp"])))


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_gradients_match_jax(monkeypatch, models, batch, fuse):
    monkeypatch.setenv("MXNET_FUSE_EPILOGUE", fuse)
    jnet, params = models
    jloss, jg = jax_grads(jnet, batch)
    net = port_model(params)
    loss = port_loss(net, batch)
    assert loss.shape == (B,)
    loss.backward(torch.ones_like(loss))
    np.testing.assert_allclose(float(loss.detach().sum()), jloss, rtol=1e-6)
    for name, p in net.named_parameters():
        # gradients are sums over B*L positions of products of the
        # activations above; scale the absolute tolerance to the tensor
        scale = max(1.0, float(np.abs(jg[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), jg[name], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.fixture
def flash_models(models):
    """The module's JAX model with its attention switched to the flash
    path (the flag is read at call time) for the test, and back after."""
    jnet, params = models
    attn = [layer.attention for layer in jnet.encoder.layers]
    for a in attn:
        a._use_flash = True
    yield jnet, params
    for a in attn:
        a._use_flash = False


@pytest.mark.parametrize("masked", ["none", "lengths", "dense"])
def test_flash_logits_match_jax(monkeypatch, flash_models, batch, masked):
    """use_flash=True against the JAX model's flash kernel (interpret
    mode); a dense mask takes the batched-matmul path on both sides."""
    from mxnet_tpu.ops import attention as jatt
    from mxnet_tpu_torch.ops import attention as tatt
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "interpret")
    jnet, params = flash_models
    net = port_model(params, use_flash=True).eval()
    mask = mask_of(masked, batch)
    jm, jn = jnet(mnp.array(batch["tokens"]), mnp.array(batch["types"]),
                  None if mask is None else mnp.array(mask))
    tatt.last_path = None
    with torch.no_grad():
        tm, tn = net(torch.tensor(batch["tokens"]),
                     torch.tensor(batch["types"]),
                     None if mask is None else torch.tensor(mask))
    if masked == "dense":
        assert tatt.last_path is None
    else:
        assert jatt.last_path == "pallas-interpret"
        assert tatt.last_path == "plain"
    np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), **TOL)
    np.testing.assert_allclose(tn.numpy(), jn.asnumpy(), **TOL)


def test_flash_gradients_match_jax(monkeypatch, flash_models, batch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "interpret")
    jnet, params = flash_models
    jloss, jg = jax_grads(jnet, batch)
    net = port_model(params, use_flash=True)
    loss = port_loss(net, batch)
    loss.backward(torch.ones_like(loss))
    np.testing.assert_allclose(float(loss.detach().sum()), jloss, rtol=1e-6)
    for name, p in net.named_parameters():
        # as in test_gradients_match_jax
        scale = max(1.0, float(np.abs(jg[name]).max()))
        np.testing.assert_allclose(p.grad.numpy(), jg[name], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_flash_is_the_default():
    net = tbert.bert_tiny(device="cpu")
    assert all(layer.attention._use_flash for layer in net.encoder.layers)
    assert tbert.MultiHeadAttention(64, 2, device="cpu")._use_flash


def test_model_without_device_needs_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.bert_tiny(use_flash=False)


def test_train_mode_dropout_reproducible(models, batch):
    _, params = models
    net = port_model(params, dropout=0.1)
    toks = torch.tensor(batch["tokens"])
    valid = torch.tensor(batch["valid"])
    outs = []
    for _ in range(2):
        net.generator.manual_seed(5)
        with torch.no_grad():
            outs.append(net(toks, None, valid)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with torch.no_grad():
        other = net(toks, None, valid)[0]          # generator moved on
        ev = net.eval()(toks, None, valid)[0]
        ev2 = net(toks, None, valid)[0]
    assert not torch.equal(outs[0], other)
    assert not torch.equal(outs[0], ev)
    torch.testing.assert_close(ev, ev2, rtol=0, atol=0)


def test_cpu_training_step_launches_no_kernel(models, batch):
    _, params = models
    net = port_model(params, dropout=0.1)
    counts = (tep.bias_gelu.launches, tep.bias_gelu_backward.launches,
              tep.bias_dropout_residual.launches_fwd,
              tep.bias_dropout_residual.launches_bwd)
    loss = port_loss(net, batch)
    loss.backward(torch.ones_like(loss))
    assert all(p.grad is not None for p in net.parameters())
    assert counts == (tep.bias_gelu.launches, tep.bias_gelu_backward.launches,
                      tep.bias_dropout_residual.launches_fwd,
                      tep.bias_dropout_residual.launches_bwd)


def test_initialize_from_seed():
    a = tbert.bert_tiny(use_flash=False, device="cpu", seed=3)
    b = tbert.bert_tiny(use_flash=False, device="cpu", seed=3,
                        init="xavier")
    pa = {n: p.detach() for n, p in a.named_parameters()}
    pb = {n: p.detach() for n, p in b.named_parameters()}
    for name in ("encoder.layers.0.attention.qkv.bias", "mlm_bias",
                 "embed_ln.beta"):
        assert torch.count_nonzero(pa[name]) == 0, name
    assert torch.all(pa["mlm_ln.gamma"] == 1)
    # Uniform(0.07) by default; Xavier's bound sqrt(6 / (64 + 192)) = 0.153
    w = pa["encoder.layers.0.attention.qkv.weight"]
    assert 0.06 < float(w.abs().max()) <= 0.07
    w = pb["encoder.layers.0.attention.qkv.weight"]
    assert 0.14 < float(w.abs().max()) <= (6 / 256) ** 0.5
    again = tbert.bert_tiny(use_flash=False, device="cpu", seed=3)
    for name, p in again.named_parameters():
        assert torch.equal(p, pa[name]), name


def test_flash_attention_reads_the_projection_uncopied(monkeypatch):
    """A BERT attention layer with flash attention hands the kernels'
    wrappers q, k and v as views of its (B, L, 3, H, D) projection and dO
    as the transposed gradient of its output: nothing is made contiguous
    in front of #5, #6 or #7."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
    seen = {}
    fns = {n: getattr(tfa, n) for n in ("flash_attention_fwd",
                                        "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")}

    def spy(name):
        def fn(*args, **kw):
            seen[name] = args
            return fns[name](*args, **kw)
        return fn
    for name in fns:
        monkeypatch.setattr(tfa, name, spy(name))
    layer = tbert.MultiHeadAttention(64, 2, device="cpu")
    projections = []
    layer.qkv.register_forward_hook(lambda m, i, o: projections.append(o))
    x = torch.randn(2, 12, 64, requires_grad=True)
    layer(x, torch.tensor([12, 7])).sum().backward()
    qkv = projections[0]
    lo = qkv.untyped_storage().data_ptr()
    hi = lo + qkv.untyped_storage().nbytes()
    assert set(seen) == set(fns)
    for name, args in seen.items():
        for t in args[:3]:                          # q, k, v
            assert t.shape == (2, 2, 12, 32) and not t.is_contiguous()
            assert lo <= t.data_ptr() < hi, name
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        do = seen[name][3]
        assert do.shape == (2, 2, 12, 32) and not do.is_contiguous()
        assert do.stride(2) == 64                   # (B, L, H, D) rows
