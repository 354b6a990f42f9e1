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
  with every row at 512, with its phases by ``%globaltimer``).

A TREE named more than once runs that many more turns; a TREE whose
build fails is left out of the turns (the exit code is then 1).  Every
line a run prints starts with its TREE's directory name.  Needs one
card; the kernels' builds go into each TREE's ``mxnet_tpu_torch/_build``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("delta", "route", "kernels", "host", "bert", "amp", "epilogue",
          "lstm", "tp", "paged", "fused", "qmm")


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
    if "amp" in phases:
        torch.cuda.empty_cache()
        _, st = cs.train(torch, 0, "amp_bf16", cs.TRAIN_B, cs.TRAIN_L, steps,
                         amp=True)
        cs.log("amp %d steps: %s" % (steps, json.dumps(st)))


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
                                             "paged", "qmm", "epilogue"}
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
