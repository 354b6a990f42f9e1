"""Time the port's flash attention over checkouts of the repo, in turns,
on one card.

    python3 chip_flash_ab.py [--phases route,kernels,host,bert] TREE ...

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
  (default 30) and no profiler: its step p50 over more steps.

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
PHASES = ("route", "kernels", "host", "bert", "amp")


def build(trees, names):
    """Each tree's kernel sources ``names`` (all when None), built at once."""
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
    rcs = build(sorted(set(trees)), None if {"bert", "amp"} & set(phases)
                else ["flash_attention"])
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
