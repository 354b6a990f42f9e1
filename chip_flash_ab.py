"""Time the port's flash attention, epilogue, LSTM and decode phase kernels
over checkouts of the repo, in turns, on one card.

    python3 chip_flash_ab.py [--phases PHASE,...] TREE ...

Builds the kernels of every TREE at once (one ``nvcc`` per source), then
runs the phases in each TREE in order and then in reverse (with two trees:
parent, change, change, parent), each run a process of its own that
imports that TREE's ``mxnet_tpu_torch`` and this checkout's
``chip_smoke.py``:

- ``delta``: ``chip_smoke.check_flash_delta`` (the delta kernel held in
  every case, bit for bit across views and shards), then
  ``chip_smoke.delta_timing`` (fp32 and bf16 at B 32, H 12, L 128, D 32,
  64 and 128 and at B 4, L 2048, D 64, each also after a flush that
  leaves the L2 clean; the flash backward, delta + #6 + #7, of a BERT
  layer);
- ``route``: ``chip_smoke.check_flash_delta``, then
  ``chip_smoke.check_sharded_attention`` with its profile of the #16
  route's backward (dp 2 x tp 2, B 32, H 12, L 128, D 64, causal):
  launches, time beside SDPA's ``is_causal`` backward and the bound, and
  the ops and kernel spans of one call;
- ``kernels``: ``chip_smoke.flash_timing`` for fp32 and bf16 at the
  training shape and bf16 at B 4, L 2048: #5-#7 on contiguous inputs,
  their fixed part, at dropout 0 beside SDPA given the same key mask,
  and on BERT's permuted projection;
- ``host``: ``chip_smoke.bert_attention_split``, one BERT layer's
  attention forward and backward through autograd (fp32 and bf16 at
  B 32, L 128, bf16 at B 4, L 2048): the host's enqueue time, the aten
  ops and the kernel spans of one call;
- ``bert``: ``chip_smoke.train``'s phases, fp32 and AMP bf16 at B 32,
  L 128 (10 steps) and AMP bf16 at B 4, L 2048 (3 steps), each with 3
  steps under torch.profiler (kernel spans, device ms); the step-1 loss
  and the dropout-free loss after step 1 are printed exactly, so two
  trees' can be compared bit for bit;
- ``amp``: the AMP bf16 phase at B 32, L 128 alone, ``--steps`` steps
  (default 30) and no profiler: its step p50 over more steps;
- ``epilogue``: ``chip_smoke.check_bias_gelu`` (#1 held and timed at
  (16, 64, 4096) x 3072, a ragged C 770 and the tp 2 bias shard C 1536,
  fp32 and bf16, beside the timer's floor, with the host's enqueue µs a
  call beside ``F.gelu(x + b)``'s; on a tree with ``bias_gelu_plan`` the
  other launches of ``chip_smoke.GELU_LAUNCHES``), then the serving
  model served 48
  requests per-op at tp 1 (12 launches of #1 a decode step and a prefill
  chunk): tokens/s, decode p50, prefill chunk p50;
- ``lstm``: the LSTM kernels' build report (ptxas registers and spills),
  the forward's plan, ``chip_smoke.lstm_timing`` in fp32 and bf16 (T 35,
  B 32, H 650: #10 and #11 beside their plain versions, bounds and cuDNN;
  #11's recompute and time loop apart; the forward's and the backward's
  phases by ``%globaltimer``; digests of #10's and
  #11's outputs, to compare trees bit for bit), then
  ``chip_smoke.train_lm`` for the word LM, fp32 and AMP bf16, 10 steps
  each, with the step-1 loss printed exactly;
- ``tp``: ``chip_smoke.check_fused`` (#12 held in every case of
  ``FUSED_CASES``, stamped, timed with mixed lengths and with every row
  at 512, with a digest of its outputs), ``chip_smoke.check_tp_phases`` (#13 and #14
  held on every shard at tp 2, 4 and a GQA geometry, with digests of
  their outputs at tp 2; #13 timed at B 16 with mixed lengths and with
  every row at 512, #14 with mixed lengths, each with its phases by
  ``%globaltimer``), then the serving model
  (BERT-base widths, seed 0) served 48 requests fused at tp 1, 2 and 4
  and per-op at tp 1 and 2 (``chip_smoke.serve``: tokens/s, decode p50
  and p99, launches, census), with the streams of each TP run compared
  to its tp 1 run's;
- ``fused``: ``chip_smoke.check_fused`` alone (the ``tp`` phase's first
  step: #12 in every case of ``FUSED_CASES``, its stamps, its times with
  mixed lengths and with every row at 512, the digest);
- ``qmm``: ``chip_smoke.check_quant_matmul`` (#8 and #9 held and timed
  beside their plain versions, ``F.linear`` on the dequantized weight and
  the bound at M 1, 16 and 64 on a layer's three GEMM shapes; a tree with
  ``qmm_plan`` also on the tensor-parallel shards and the ragged input
  dims, with its plan, its phases by ``%globaltimer`` and the other plans
  of ``chip_smoke.QMM_PLANS``), then the serving model served 48 requests
  with int8 weights + int8 KV pages and with int4 weights (group 128):
  tokens/s, decode p50 and p99, prefill chunk p50, launches and a digest
  of the streams; then 16 requests of each under torch.profiler (the
  device's busy share, the kernels with the most device time);
- ``paged``: ``chip_smoke.check_paged_attention`` and
  ``check_paged_attention_int8`` (#15 over fp and int8 pages at H 12 over
  12 and 4 KV heads, D 64, and over 4 KV heads at D 32 and 128, held in
  every case of ``TP_CASES``; timed at D 64, B 16, with mixed lengths and
  with every row at 512, with its phases by ``%globaltimer``);
- ``dims``: ``chip_smoke.check_decode_dims`` (#12, #13 and #15 over fp
  and int8 pages at every head dim that is a multiple of 8 up to 256,
  each held and timed) and ``chip_smoke.check_flash_dims`` (#5-#7 and
  the delta kernel at every multiple of 8 up to 120 but 32 and 64 in fp32
  and bf16, held; timed there and at D 64); only in a tree whose kernels
  take those head dims;
- ``dims16``: ``chip_smoke.check_decode_dims`` at the multiples of 16 up
  to 128 alone, each held and timed: the head dims that a checkout from
  before the multiples of 8 takes too, so that it can be the other TREE;
- ``spec``: ``chip_smoke.spec_phase`` (speculative decoding on the
  serving model: each row of ``SPEC_RUNS`` beside the same engine
  without speculation, streams held, launches held to the path); only in
  a tree that speculates;
- ``array``: ``chip_smoke.array_core_phase`` (the BERT-base encoder
  through np/npx and ``npx.rnn`` on the card, held and counted), then
  the np/npx encoder step and the torch-native ``BERTEncoder``'s on the
  same weights in turns (np, native, native, np, three rounds), each the
  median of 10 CUDA-event spans beside the host's enqueue ms of one step
  (from an idle card to the call's return, median of 5); only in a tree
  with the array core;
- ``gluon``: ``chip_smoke.gluon_phase`` (LeNet, the BERT-base FFN and
  the 2 x 650 word LM through Gluon on the card, held and counted, the
  Gluon LM step timed beside the torch-native one); only in a tree with
  Gluon;
- ``zoo_grad``: where the fp32 ResNet-50's first-step gradients part:
  from ``chip_smoke.zoo_model``'s first weights and batch (fp32 NCHW,
  B 32), the gradients of the Gluon model, of the torch-native model
  twice (cuDNN's BatchNorm), of the torch-native model with
  ``torch.native_batch_norm`` (the Gluon layer's kernel) and of the
  torch-native model in fp64, each against fp64 (``zoo_grad_errors``);
  then the loss after one SGD step (lr 0.05) from each of those
  gradients, evaluated in fp64 and in the fp32 torch-native model;
- ``zoo``: ``chip_smoke.zoo_phase`` (ResNet-50 v1 training through the
  model zoo and ``gluon.Trainer`` in fp32 NCHW and NHWC at B 32 and bf16
  NHWC at B 256, the torch-native ResNet-50 beside it, the profiler's
  trace, each family against the CPU, every ``get_model`` name, the
  examples on the card); only in a tree with the model zoo.

A TREE named more than once runs that many more turns; a TREE whose
build fails is left out of the turns (the exit code is then 1).  Every
line a run prints starts with its TREE's directory name.  Needs one
card; the kernels' builds go into each TREE's ``mxnet_tpu_torch/_build``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("delta", "route", "kernels", "host", "bert", "amp", "epilogue",
          "lstm", "tp", "paged", "fused", "qmm", "dims", "dims16",
          "spec", "array", "gluon", "zoo_grad", "zoo")


def build(trees, names):
    """Each tree's kernel sources ``names`` (all when None), built at once;
    the exit code of each tree's build."""
    code = ("from mxnet_tpu_torch.ops.kernels import _build; _build.build(%s)"
            % ("" if names is None else repr(names)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=t)
             for t in trees]
    return [p.wait() for p in procs]


def run(tree, phases, steps):
    """The phases in ``tree``, in this process."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import torch
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    assert os.path.abspath(fa.__file__).startswith(
        os.path.join(os.path.abspath(tree), "")), fa.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log("card: %s" % cs.card_line())
    timer = cs.Timer(torch)
    if "delta" in phases:
        cs.check_flash_delta(torch, fa, timer, {})
        cs.delta_timing(torch, fa, timer)
    if "route" in phases:
        cs.check_flash_delta(torch, fa, timer, {})
        cs.check_sharded_attention(torch, timer, {}, profile=True)
    if "kernels" in phases:
        cs.flash_timing(torch, fa, timer, torch.float32, {})
        cs.flash_timing(torch, fa, timer, torch.bfloat16, {})
        cs.flash_timing(torch, fa, timer, torch.bfloat16, {}, B=cs.LONG_B,
                        L=cs.LONG_L)
    if "host" in phases:
        for dt, B, L in ((torch.float32, cs.TRAIN_B, cs.TRAIN_L),
                         (torch.bfloat16, cs.TRAIN_B, cs.TRAIN_L),
                         (torch.bfloat16, cs.LONG_B, cs.LONG_L)):
            cs.bert_attention_split(torch, dt, B, L)
    if "bert" in phases:
        torch.cuda.empty_cache()
        for name, amp, B, L, steps, kw in (
                ("fp32", False, cs.TRAIN_B, cs.TRAIN_L, cs.TRAIN_STEPS, {}),
                ("amp_bf16", True, cs.TRAIN_B, cs.TRAIN_L, cs.TRAIN_STEPS,
                 {}),
                ("long_amp_bf16", True, cs.LONG_B, cs.LONG_L, cs.LONG_STEPS,
                 dict(max_length=cs.LONG_L))):
            _, st = cs.train(torch, 0, name, B, L, steps, amp=amp,
                             profile_steps=3, **kw)
            cs.log("bert %s: %s" % (name, json.dumps(st)))
    if "epilogue" in phases:
        from mxnet_tpu_torch.ops.kernels import epilogue as ep
        cs.check_bias_gelu(torch, timer, {})
        cs.bias_gelu_launches(torch, ep, timer)
        lm, _ = decode_models(cs, torch)
        _, _, _, st = cs.serve(torch, lm, cs.traffic(0, 48), "per_op", False)
        cs.log("epilogue serve per_op: %s" % json.dumps(st))
        del lm
        torch.cuda.empty_cache()
    if "lstm" in phases:
        from mxnet_tpu_torch.ops.kernels import _build
        from mxnet_tpu_torch.ops.kernels import fused_cell as fc
        log = _build.build(["lstm"])["lstm"].with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.log("ptxas lstm: %s" % line.strip())
        for dt in (torch.float32, torch.bfloat16):
            cs.log("lstm forward plan (H 650, B 32, %s): %s"
                   % (str(dt)[6:], fc.lstm_plan(650, 32, dt)))
        cs.lstm_timing(torch, fc, timer, torch.float32)
        cs.lstm_timing(torch, fc, timer, torch.bfloat16)
        torch.cuda.empty_cache()
        for label, amp in (("lstm_lm_fp32", False),
                           ("lstm_lm_amp_bf16", True)):
            _, st = cs.train_lm(torch, 0, label, amp=amp)
            cs.log("lstm %s: step-1 loss %r; %s"
                   % (label, st["first_loss"], json.dumps(st)))
    if "paged" in phases:
        cs.check_paged_attention(torch, timer, {})
        cs.check_paged_attention_int8(torch, timer, {})
    if "tp" in phases:
        tp_phase(cs, torch, timer)
    if "fused" in phases:
        lm, lm_gqa = decode_models(cs, torch)
        report = {}
        cs.check_fused(torch, timer, report, lm, lm_gqa)
        cs.log("fused: %s" % json.dumps(report["fused"]))
    if "qmm" in phases:
        qmm_phase(cs, torch, timer)
    if "dims" in phases:
        report = {}
        cs.check_decode_dims(torch, timer, report, timed=cs.DECODE_DIMS)
        cs.check_flash_dims(torch, timer, report, timed=sorted(
            cs.FLASH_NEW_DIMS + (64,)))
        cs.log("dims: %s" % json.dumps(report))
    if "dims16" in phases:
        report = {}
        d16 = range(16, 129, 16)
        cs.check_decode_dims(torch, timer, report, dims=d16, timed=d16)
        cs.log("dims16: %s" % json.dumps(report))
    if "spec" in phases:
        lm, _ = decode_models(cs, torch)
        cs.spec_phase(torch, lm, 0)
    if "array" in phases:
        array_phase(cs, torch)
    if "gluon" in phases:
        _, rep = cs.gluon_phase(torch, 0)
        cs.log("gluon: %s" % json.dumps(rep))
    if "zoo_grad" in phases:
        zoo_grad_phase(cs, torch)
    if "zoo" in phases:
        _, rep = cs.zoo_phase(torch, 0)
        cs.log("zoo: %s" % json.dumps(rep))
    if "amp" in phases:
        torch.cuda.empty_cache()
        _, st = cs.train(torch, 0, "amp_bf16", cs.TRAIN_B, cs.TRAIN_L, steps,
                         amp=True)
        cs.log("amp %d steps: %s" % (steps, json.dumps(st)))


def zoo_grad_phase(cs, torch):
    """The ``zoo_grad`` phase (the module docstring says what it runs)."""
    import copy
    import types
    import mxnet_tpu_torch as mx
    F = torch.nn.functional
    B = 32
    net, x, y = cs.zoo_model(torch, mx, 0, B, "NCHW")
    twin = cs.resnet50_native(torch, net, cs.ZOO_CLASSES)
    xt, yt = x._data, y._data.long()
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    grads = {"gluon": {cs.zoo_twin_name(k): p.leaf.grad / B
                       for k, p in net.collect_params().items()
                       if p.grad_req != "null"}}
    losses = {"gluon": float(loss.mean())}

    def native_bn(self, inp):
        return torch.native_batch_norm(inp, self.weight, self.bias, None,
                                       None, True, 0.0, self.eps)[0]

    twin_nbn = copy.deepcopy(twin)
    for m in twin_nbn.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.forward = types.MethodType(native_bn, m)
    twin64 = copy.deepcopy(twin).double()
    for name, model, xin in (("native", twin, xt), ("native_again", twin, xt),
                             ("native_bn", twin_nbn, xt),
                             ("fp64", twin64, xt.double())):
        lo, g = cs.native_grads(torch, model, xin, yt)
        grads[name] = {k: v.detach().clone() for k, v in g.items()}
        losses[name] = float(lo)
    ref = grads["fp64"]
    for name in ("gluon", "native", "native_again", "native_bn"):
        errs, zero, l2 = cs.zoo_grad_errors(grads[name], ref)
        cs.log("zoo_grad: %s: first loss %.8f (fp64 %.8f); against fp64: "
               "relative L2 %.4g, worst %s; zero-gradient largest %.3g"
               % (name, losses[name], losses["fp64"], l2, cs.zoo_worst(errs),
                  max(zero.values())))
    # over each fp64 gradient's largest; the gradients zero but for
    # rounding over the net's largest (zoo_grad_errors)
    top = max(float(r.abs().max()) for r in ref.values())
    zero = {k for k, r in ref.items()
            if float(r.abs().max()) <= cs.ZOO_ZERO_GRAD * top}
    for a, b in (("gluon", "native_bn"), ("gluon", "native"),
                 ("native", "native_again")):
        d = {k: float((grads[a][k] - grads[b][k]).abs().max())
             / (top if k in zero else float(ref[k].abs().max()))
             for k in ref}
        cs.log("zoo_grad: %s against %s: largest difference over the fp64 "
               "gradient's largest %.4g (worst %s); over the net's largest "
               "for the %d zero but for rounding %.3g"
               % (a, b, max(v for k, v in d.items() if k not in zero),
                  cs.zoo_worst({k: v for k, v in d.items() if k not in zero}),
                  len(zero), max(d[k] for k in zero)))
    w0 = {k: p.detach().clone() for k, p in twin64.named_parameters()}

    def loss_after(g, model, xin):
        """The mean loss of ``model`` at w0 - lr g (training mode)."""
        with torch.no_grad():
            params = dict(model.named_parameters())
            keep = {k: p.detach().clone() for k, p in params.items()}
            for k, p in params.items():
                p.copy_((w0[k] - cs.ZOO_LR * g[k].double()).to(p.dtype))
            out = float(F.cross_entropy(model(xin), yt))
            for k, p in params.items():
                p.copy_(keep[k])
        return out

    for name in ("gluon", "native", "native_again", "native_bn", "fp64"):
        cs.log("zoo_grad: the loss after one SGD step (lr %g) from the %s "
               "gradient: evaluated in fp64 %.6f, in fp32 (torch-native) "
               "%.6f" % (cs.ZOO_LR, name,
                         loss_after(grads[name], twin64, xt.double()),
                         loss_after(grads[name], twin, xt)))
    # the fp64 gradient against a central finite difference in fp64 along
    # a random unit direction r (each fp32 gradient's r-component beside)
    gen = torch.Generator(device=xt.device).manual_seed(5)
    r = {k: torch.randn(w.shape, generator=gen, device=xt.device,
                        dtype=torch.float64) for k, w in w0.items()}
    norm = math.sqrt(sum(float((v * v).sum()) for v in r.values()))
    h = 1e-7
    with torch.no_grad():
        side = []
        for sgn in (1.0, -1.0):
            for k, p in twin64.named_parameters():
                p.copy_(w0[k] + sgn * h * r[k] / norm)
            side.append(float(F.cross_entropy(twin64(xt.double()), yt)))
        for k, p in twin64.named_parameters():
            p.copy_(w0[k])
    fd = (side[0] - side[1]) / (2 * h)
    dots = {name: sum(float((grads[name][k].double() * r[k]).sum())
                      for k in r) / norm
            for name in ("fp64", "gluon", "native", "native_bn")}
    cs.log("zoo_grad: along a random unit direction, a central difference "
           "of the fp64 loss (h %g) %.7g; the gradients' components: %s"
           % (h, fd, ", ".join("%s %.7g" % kv for kv in dots.items())))
    cs.log("zoo_grad: card %s" % cs.card_line())
    del net, twin, twin64, twin_nbn, grads
    torch.cuda.empty_cache()


def array_phase(cs, torch):
    """The ``array`` phase (the module docstring says what it runs)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    cs.array_core_phase(torch, 0)
    net = cs.encoder_weights(torch, 5, cs.DEV)
    params = cs.np_params(mx, net, cs.DEV)
    rng = np.random.default_rng(5)
    x, w = (mx.np.array(rng.standard_normal(
        (cs.NP_B, cs.NP_L, cs.BERT["units"])).astype(np.float32), ctx=cs.DEV)
        for _ in range(2))
    valid = mx.np.array(rng.integers(cs.NP_L // 2, cs.NP_L + 1, cs.NP_B)
                        .astype(np.int32), ctx=cs.DEV)
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    for layer in net.layers:
        for mod in (layer, layer.attention, layer.ffn):
            mod._dropout, mod._generator = cs.NP_DROPOUT, gen

    def np_step():
        cs.np_step(mx, params, x, valid, w, cs.NP_DROPOUT)

    def native():
        out = net(x._data, valid._data)
        ((out - w._data) ** 2).mean().backward()

    def enqueue_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        t = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return t

    rows = {"np": [], "native": []}
    for label, fn in [("np", np_step), ("native", native),
                      ("native", native), ("np", np_step)] * 3:
        ms = cs.event_ms(torch, fn, iters=10)
        host = statistics.median(enqueue_ms(fn) for _ in range(5))
        rows[label].append((ms, host))
        cs.log("array step %s (B %d, L %d, dropout %g, fp32): device span "
               "%.3f ms, host enqueue %.3f ms" % (label, cs.NP_B, cs.NP_L,
                                                 cs.NP_DROPOUT, ms, host))
    cs.log("array steps: %s" % json.dumps(rows))


def decode_models(cs, torch):
    """The serving model (BERT-base widths, seed 0) and its 2-layer GQA
    variant (12 heads over 4 KV heads, seed 1), as ``chip_smoke.main``
    makes them."""
    from mxnet_tpu_torch.models import decoder as dec
    lm = cs.perturb_affine(torch, dec.CausalLM(**cs.WIDTHS, device=cs.DEV,
                                               seed=0), 0)
    lm_gqa = cs.perturb_affine(torch, dec.CausalLM(
        **dict(cs.WIDTHS, num_layers=2, num_kv_heads=4), device=cs.DEV,
        seed=1), 1)
    return lm, lm_gqa


def tp_phase(cs, torch, timer):
    """The ``tp`` phase: the decode phase kernels' checks, times and
    stamps, then serving at tp 1, 2 and 4."""
    lm, lm_gqa = decode_models(cs, torch)
    report = {}
    cs.check_fused(torch, timer, report, lm, lm_gqa)
    cs.check_tp_phases(torch, timer, report, lm, lm_gqa)
    cs.log("fused: %s" % json.dumps(report["fused"]))
    cs.log("tp phases: %s" % json.dumps(report["tp_phases"]))
    reqs = cs.traffic(0, 48)
    runs = {}
    for label, fused, tp in (("fused", True, 1), ("per_op", False, 1),
                             ("tp2_fused", True, 2), ("tp4_fused", True, 4),
                             ("tp2_per_op", False, 2)):
        runs[label] = cs.serve(torch, lm, reqs, label, fused,
                               sharding=cs.tp_sharding(tp) if tp > 1
                               else None)
    for label in ("tp2_fused", "tp4_fused", "tp2_per_op"):
        one = runs["fused" if label.endswith("fused") else "per_op"][1]
        same = sum(a["tokens"] == b["tokens"]
                   for a, b in zip(one, runs[label][1]))
        cs.log("tp %s streams identical to tp 1's for %d of %d requests"
               % (label, same, len(reqs)))
        if same != len(reqs):
            raise AssertionError("%s streams differ from tp 1's" % label)
    cs.log("tp serve: %s" % json.dumps({k: r[3] for k, r in runs.items()}))


def qmm_phase(cs, torch, timer):
    """The ``qmm`` phase: #8 and #9 held and timed, then quantized
    serving."""
    import hashlib
    from mxnet_tpu_torch.ops.kernels import quant_matmul as qm
    grid = [c for c in cs.qmm_cases() if c[1:3] in cs.QMM_SHAPES]
    planned = hasattr(qm, "qmm_plan")
    cs.check_quant_matmul(torch, timer, {},
                          plans=cs.QMM_PLANS if planned else (),
                          cases=None if planned else grid)
    lm, _ = decode_models(cs, torch)
    reqs = cs.traffic(0, 48)
    for label, quant in (("int8_kv8", dict(quantize="int8", kv_dtype="int8")),
                         ("int4", dict(quantize="int4", quant_group=128))):
        _, outs, counts, st = cs.serve(torch, lm, reqs, label, True, **quant)
        streams = hashlib.sha256(json.dumps(
            [o["tokens"] for o in outs]).encode()).hexdigest()[:16]
        cs.log("qmm serve %s: %s; streams digest %s"
               % (label, json.dumps(st), streams))
    for quant in (dict(quantize="int8", kv_dtype="int8"),
                  dict(quantize="int4", quant_group=128)):
        cs.profile(torch, lm, reqs[:16], True, **quant)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--steps", type=int, default=30,
                    help="steps of the amp phase")
    ap.add_argument("--run", action="store_true",
                    help="run the phases in the one TREE, in this process")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error("phases are %s" % (PHASES,))
    if args.run:
        run(args.trees[0], phases, args.steps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in args.trees]
    names = [n for n, ps in (("flash_attention", {"delta", "route", "kernels",
                                                 "host"}),
                             ("fused_decode", {"fused"}),
                             ("epilogue", {"epilogue"})) if ps & set(phases)]
    rcs = build(sorted(set(trees)), None if {"bert", "amp", "lstm", "tp",
                                             "paged", "qmm", "epilogue",
                                             "dims", "dims16", "spec"}
                & set(phases) else names)
    built = {t for t, rc in zip(sorted(set(trees)), rcs) if not rc}
    failed = len(set(trees) - built)
    if failed:
        # the other trees still run, so one call compares what did build
        print("chip_flash_ab: the build failed in %s"
              % sorted(set(trees) - built), file=sys.stderr)
    for t in [t for t in trees + trees[::-1] if t in built]:
        label = os.path.basename(t)
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--run", "--phases", args.phases,
                              "--steps", str(args.steps), t], cwd=t,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        for line in p.stdout:
            print(label, line, end="", flush=True)
        failed += p.wait() != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
