"""Time the port's flash attention and LSTM kernels over checkouts of the
repo, in turns, on one card.

    python3 chip_flash_ab.py [--phases route,kernels,host,bert,lstm] TREE ...

Builds the kernels of every TREE at once (one ``nvcc`` per source), then
runs the phases in each TREE in order and then in reverse (with two trees:
parent, change, change, parent), each run a process of its own that
imports that TREE's ``mxnet_tpu_torch`` and this checkout's
``chip_smoke.py``:

- ``route``: ``chip_smoke.check_sharded_attention`` with its profile of
  the #16 route's backward (dp 2 x tp 2, B 32, H 12, L 128, D 64,
  causal): launches, time beside SDPA's ``is_causal`` backward and the
  bound, and the ops and kernel spans of one call;
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
- ``lstm``: the LSTM kernels' build report (ptxas registers and spills),
  ``chip_smoke.lstm_timing`` in fp32 and bf16 (T 35, B 32, H 650: #10
  and #11 beside their plain versions, bounds and cuDNN; #11's recompute
  and time loop apart where the tree has them; the backward's phases by
  ``%globaltimer`` where the tree stamps them; digests of #10's and
  #11's outputs, to compare trees bit for bit), then
  ``chip_smoke.train_lm`` for the word LM, fp32 and AMP bf16, 10 steps
  each, with the step-1 loss printed exactly.

A TREE named more than once runs that many more turns.  Every line a run
prints starts with its TREE's directory name.  Needs one card; the
kernels' builds go into each TREE's ``mxnet_tpu_torch/_build``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("route", "kernels", "host", "bert", "amp", "lstm")


def build(trees, names):
    """Each tree's kernel sources ``names`` (all when None), built at once."""
    code = ("from mxnet_tpu_torch.ops.kernels import _build; _build.build(%s)"
            % ("" if names is None else repr(names)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=t)
             for t in trees]
    return [p.wait() for p in procs]


def legacy_lstm(cs, fc):
    """Shims that let ``chip_smoke``'s LSTM phases run a tree older than
    its backward's two kernels: where #11 is one kernel, ``_lstm_bwd_parts``
    gives a recompute that does nothing (and so does its plain version)
    and a time loop that is the whole backward, and the word LM expects no
    recompute launches; where the backward stamps no phases,
    ``lstm_stamps`` returns None."""
    if not hasattr(fc, "_lstm_bwd_parts"):
        fc.lstm_sequence.launches_bwd_gates = 0
        cs.LM_PER_STEP.pop("lstm_sequence_bwd_gates")
        fc._lstm_bwd_parts = lambda *a: (
            lambda stamps=None: None, lambda stamps=None: fc._lstm_bwd(*a),
            None, None)
        fc.lstm_bwd_gates_plain = lambda *a: None
    if not hasattr(fc, "lstm_bwd_phase_times"):
        cs.lstm_stamps = lambda *a, **k: None


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
    if "route" in phases:
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
        del timer
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
    if "lstm" in phases:
        from mxnet_tpu_torch.ops.kernels import _build
        from mxnet_tpu_torch.ops.kernels import fused_cell as fc
        per_step = dict(cs.LM_PER_STEP)
        legacy_lstm(cs, fc)
        try:
            log = _build.build(["lstm"])["lstm"].with_suffix(".log")
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling" in line):
                    cs.log("ptxas lstm: %s" % line.strip())
            cs.lstm_timing(torch, fc, timer, torch.float32)
            cs.lstm_timing(torch, fc, timer, torch.bfloat16)
            torch.cuda.empty_cache()
            for label, amp in (("lstm_lm_fp32", False),
                               ("lstm_lm_amp_bf16", True)):
                _, st = cs.train_lm(torch, 0, label, amp=amp)
                cs.log("lstm %s: step-1 loss %r; %s"
                       % (label, st["first_loss"], json.dumps(st)))
        finally:
            cs.LM_PER_STEP.clear()
            cs.LM_PER_STEP.update(per_step)
    if "amp" in phases:
        torch.cuda.empty_cache()
        _, st = cs.train(torch, 0, "amp_bf16", cs.TRAIN_B, cs.TRAIN_L, steps,
                         amp=True)
        cs.log("amp %d steps: %s" % (steps, json.dumps(st)))


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
    rcs = build(sorted(set(trees)), None if {"bert", "amp", "lstm"}
                & set(phases) else ["flash_attention"])
    if any(rcs):
        print("chip_flash_ab: a build failed: %s" % rcs, file=sys.stderr)
        return 1
    failed = 0
    for t in trees + trees[::-1]:
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
