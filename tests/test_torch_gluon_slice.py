"""The Gluon slice end to end on the CPU against ``mxnet_tpu``: a small
LeNet (B 4, the MNIST synthetic fallback through ``ToTensor`` and a
shuffled ``DataLoader``, SGD) and a small word LM (the
``example/gluon/word_language_model.py`` model at vocab 50, 2 x 16, T 5,
B 2, dropout 0, SGD lr 1 with ``clip_global_norm(0.25)``) take three
steps in both packages from the same weights (carried by
``save_parameters``) on the same batches; each step's loss agrees.
"""
from __future__ import annotations

import contextlib

import numpy as np

from gluon_parity import carry, jax_mx, port_mx

# fp32 on both sides; three steps of a conv net or an LSTM compound a few
# ulps per op into the losses' 6th digit
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)


def _lenet(g):
    net = g.nn.Sequential()
    net.add(g.nn.Conv2D(6, 5, activation="tanh"), g.nn.MaxPool2D(2),
            g.nn.Conv2D(16, 5, activation="tanh"), g.nn.MaxPool2D(2),
            g.nn.Flatten(), g.nn.Dense(120, activation="tanh"),
            g.nn.Dense(84, activation="tanh"), g.nn.Dense(10))
    return net


def _scope(mx):
    return (mx.Context("cpu") if mx is port_mx()
            else contextlib.nullcontext())


def _lenet_losses(mx, net):
    with _scope(mx):
        g = mx.gluon
        tf = g.data.vision.transforms.ToTensor()
        np.random.seed(5)
        loader = g.data.DataLoader(
            g.data.vision.MNIST(train=True).transform_first(tf),
            batch_size=4, shuffle=True)
        trainer = g.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05})
        ce = g.loss.SoftmaxCrossEntropyLoss()
        acc = g.metric.Accuracy()
        losses = []
        for i, (x, y) in enumerate(loader):
            if i == 3:
                break
            with mx.autograd.record():
                out = net(x)
                loss = ce(out, y)
            loss.backward()
            trainer.step(x.shape[0])
            acc.update(y, out)
            losses.append(float(loss.mean()))
    return losses, acc.get()


def test_lenet_three_steps_match_jax(tmp_path):
    jmx, tmx = jax_mx(), port_mx()
    jn = _lenet(jmx.gluon)
    jn.initialize(jmx.init.Xavier())
    jn(jmx.np.zeros((1, 1, 28, 28)))
    with tmx.Context("cpu"):
        tn = _lenet(tmx.gluon)
        tn.initialize(tmx.init.Xavier())
    carry(jn, tn, tmp_path / "lenet.npz")
    want, want_acc = _lenet_losses(jmx, jn)
    got, got_acc = _lenet_losses(tmx, tn)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got_acc == want_acc


def _word_lm(g, vocab=50, emsize=16, nhid=16, nlayers=2, dropout=0.0):
    class RNNModel(g.HybridBlock):
        def __init__(self):
            super().__init__()
            self.drop = g.nn.Dropout(dropout)
            self.encoder = g.nn.Embedding(vocab, emsize)
            self.lstm = g.rnn.LSTM(nhid, num_layers=nlayers, layout="NTC",
                                   dropout=dropout, input_size=emsize)
            self.decoder = g.nn.Dense(vocab, flatten=False, in_units=nhid)

        def forward(self, x, state=None):
            emb = self.drop(self.encoder(x))
            if state is None:
                return self.decoder(self.drop(self.lstm(emb)))
            out, state = self.lstm(emb, state)
            return self.decoder(self.drop(out)), state

    return RNNModel()


def _lm_losses(mx, model, data, vocab=50, bptt=5):
    with _scope(mx):
        g = mx.gluon
        model.hybridize()
        trainer = g.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": 1.0})
        ce = g.loss.SoftmaxCrossEntropyLoss()
        losses, norms = [], []
        for i in range(3):
            lo = i * bptt
            x = mx.np.array(data[:, lo:lo + bptt])
            y = mx.np.array(data[:, lo + 1:lo + bptt + 1])
            with mx.autograd.record():
                logits = model(x)
                loss = ce(logits.reshape((-1, vocab)),
                          y.reshape((-1,))).mean()
            loss.backward()
            grads = [p.grad() for p in model.collect_params().values()
                     if p.grad_req != "null"]
            norms.append(g.utils.clip_global_norm(grads, 0.25))
            trainer.step(1)
            losses.append(float(loss))
    return losses, norms


def test_word_lm_three_steps_match_jax(tmp_path):
    jmx, tmx = jax_mx(), port_mx()
    data = np.random.RandomState(3).randint(0, 50, (2, 16)).astype(np.int32)
    jm = _word_lm(jmx.gluon)
    jm.initialize(jmx.init.Xavier())
    with tmx.Context("cpu"):
        tm = _word_lm(tmx.gluon)
        tm.initialize(tmx.init.Xavier())
    carry(jm, tm, tmp_path / "lm.npz")
    want, want_norms = _lm_losses(jmx, jm, data)
    got, got_norms = _lm_losses(tmx, tm, data)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    np.testing.assert_allclose(got_norms, want_norms, rtol=2e-5)
