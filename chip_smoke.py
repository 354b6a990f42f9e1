#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's LLM serving (tensor-parallel serving and
the HTTP surface included), BERT training, LSTM training and array-core
(``mx.np``/``mx.npx``/``mx.autograd``) paths on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):

1. Set-up: build every kernel of the paths from ``mxnet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel; Triton compiles the GELU
   backward at its first launch), print the card's name and power limit,
   turn TF32 off.
2. Kernel checks: each kernel against its plain PyTorch version on the
   card, at the main paths' full-width shapes and at a GQA geometry, with
   the tolerance stated; each kernel's time, its plain version's time,
   its bound and (where one exists) one PyTorch call's time.  The timer's
   floor (an empty kernel) first.  The GELU forward (#1) at (16, 64,
   4096) x 3072, a ragged C 770 and the tp 2 bias shard C 1536, fp32 and
   bf16, with its launch plan and the host's enqueue time a call.  The
   quantized-serving kernels (``quant_matmul`` int8 and int4) are checked
   at the three GEMM shapes of a layer and M in {1, 16, 64}.  Paged
   attention (#15), over fp32 and over int8 pages, at H 12 over 12 and 4
   KV heads, D 64, in the cases of ``TP_CASES`` (B 16 with mixed lengths,
   lengths on each side of its 64-key chunks, every row at 512; B 1), every
   length-0 row zero; timed at mixed lengths and every row at 512 with its
   phases by ``%globaltimer``.  The fused decode layer group (#12) prints a
   digest of its outputs.  The
   training kernels: ``bias_gelu_backward`` at (4096, 3072), (4096, 768)
   and (4095, 3072) in float32 and bfloat16; ``bias_dropout_residual``
   forward (rates 0, 0.1, 0.5) and backward (0.1, 0.5) at (4096, 768) and
   (4095, 766), the mask held exactly.  Flash attention (#5 forward, #6
   dq, #7 dk/dv) against ``flash_attention_plain``, its backward and
   autograd through it: float32 and bfloat16 at D 32, 64 and 128 (all
   six run on wgmma and TMA, the fp32 ones in 3xTF32 with out, dq, dk and
   dv within the tighter TOL_FLASH_3XTF32), (B, H, L) of
   (32, 12, 128), (4, 12, 2048) and a ragged (2, 6, 200), with no mask,
   causal, a window of 32 and kv_length with a row of length 0 (and one
   of length 1 where B > 2), at dropout 0 and 0.1 (144 cases); the
   dropout mask read off the output (q = k = 0, V = I) in every element
   at rates 0.1 and 0.5 and seeds 0 and 2**32 - 1; the three kernels on
   strided views (BERT's permuted projection and transposed dO, head
   slices; the backward at D 32, 64 and 128) and into output views, bit
   for bit their results on contiguous copies; the three kernels timed
   at the training shape in fp32 and bf16 and at the long-context shape
   (B 4, L 2048) in bf16, beside their plain versions and SDPA, on
   BERT's layout, the kernels' fixed part (every kv_length 0) in both
   types, and at dropout 0 beside SDPA given the same key mask (the same
   function).  The LSTM time loop
   (#10 forward, #11 backward: its gate recompute and its time loop)
   against its plain versions, #11's recompute against its own, two
   launches of #10 and of #11 bit for bit, and #11 (through the autograd
   Function)
   against autograd through the plain forward: float32 and bfloat16,
   (T, B, H) of (35, 32, 650), (7, 5, 37), (35, 1, 650), (35, 64, 650),
   (1, 32, 650) and (400, 32, 650), and a bfloat16 layer with a float32 W
   at the first two, zero and random initial state, dcseq zero but at T-1
   (28 cases); both timed at (35, 32, 650) beside their plain versions,
   their bounds and cuDNN's LSTM on the same weights, #11's two kernels
   also apart, #10's and #11's time loops' phases by ``%globaltimer``
   (#10's set-up too), #10's plan and its other plans, and #11's serial
   chain's floor; the SASS of the LSTM kernels: #11's recompute's and
   #10's tensor-core products, no atomic in any.  The tensor-parallel
   decode phases (#13 attention, #14 FFN) on every shard of one layer at
   tp 2 and 4 of the serving model and at tp 2 of a GQA one (12 heads
   over 4 KV heads), at B 16 (lengths 1..512 with one row of length 0;
   lengths on each side of #13's 64-key chunks; every row at 512) and
   B 1, pages and partial products held, with digests of #13's and #14's
   outputs on shard 0 at tp 2; #13 timed at B 16 on shard 0 with mixed
   lengths and with every row at 512, #14 with mixed lengths, each with
   its phases stamped by ``%globaltimer``.  The
   #16 route (``flash_attention_sharded`` on a dp 2 x tp 2 mesh at B 32,
   H 12, L 128, D 64, causal, fp32 and bf16: one flash call over the
   whole tensors) against the plain causal attention, the unsharded #5
   and, bit for bit, the per-shard composition, forward and gradients,
   with one launch of #5 per call and of the delta kernel, #6 and #7 per
   backward; its backward timed beside SDPA's is_causal backward and its
   bound (the function's least bytes and products), and the design's own
   floor.  The delta kernel (``delta = sum_d dO * O``, which #6 and #7
   read) against its plain version in both dtypes at D 32, 64 and 128,
   on a transposed dO and per shard bit for bit, timed beside its plain
   version and ``torch.linalg.vecdot``.  The head dims (``check_decode_dims``,
   ``check_flash_dims``): #12, #13 (both shards of tp 2) and #15 over fp
   and int8 pages at every head dim that is a multiple of 8 up to 256, on
   a 2-layer model of that head dim at B 16 with mixed lengths, each held,
   and timed at ``DECODE_TIMED``; #5-#7 and the delta kernel at every
   multiple of 8 up to 120 but 32 and 64, and at D 12, 20, 36 and 100,
   which the wrappers zero-pad to the next multiple of 8
   (``FLASH_PADDED``), in fp32 and bf16 (544 flash cases at (8, 12, 128)
   and (2, 6, 200), every mask, dropout 0 and 0.1), the #16 route at
   ``ROUTE_DIMS``, timed at the training shape at ``FLASH_TIMED``.
   ``--kernels-only`` stops here.
3. Serving: a ``CausalLM`` at BERT-base widths (vocab 30522, 12 layers,
   768 units, FFN 3072, 12 heads, max length 512; random weights from
   ``--seed``, with random biases and LN affines, which the kernel checks
   use too) served by ``DecodeEngine`` (16 slots, page size 16, prefill
   chunk 64) with 48 requests, nine times: with the fused decode kernel;
   with ``MXNET_DECODE_FUSED=0``; with int8 weights and int8 KV pages;
   with int4 weights (group 128) and fp KV pages; and tensor-parallel
   (``sharding=ShardingConfig.for_transformer(mesh_shape=(1, tp),
   axis_names=("dp", "tp"))``, the shards in turn on the card) fused at
   tp 2 and tp 4 and per-op at tp 2; int8 weights + int8 KV at tp 2 and
   int4 weights at tp 4, per-op (the TP rows serve the first
   ``TP_REQUESTS`` = 24 of the 48 requests).  Kernel launch counts are set to 0
   before each run and read after it (a fused TP step launches #13 and
   #14 12 tp times each, a per-op one paged attention 12 tp times), and
   a TP engine's collective census must read 24 all-reduces and nothing
   else.  Then, for 3 requests, teacher-forced prefill + decode through
   each engine's programs is held against ``full_forward`` (which attends
   through the flash forward kernel; over the quantized weights for
   int4), each TP engine's also against the tp 1 engine's, and for the
   int8-KV run against the same programs on CPU copies of the params.
   Every serving row runs the engine's defaults: the async decode
   pipeline (dispatch depth 1; the inputs staged from pinned rings, each
   step's tokens read back through a pinned buffer once its CUDA event
   has passed) and the prefix cache on.  Prefill chunks are timed by CUDA
   events recorded around each call and read after the run.  Each row
   also prints its host gap, dispatch depth, deferred reads, the drains a
   completing prompt caused, staging-ring waits and the host time of the
   launch and retire halves; launched decode steps must equal retired
   ones (the discarded flights are printed where they differ).  The
   fused tp 1 and int8 + int8 KV tp 2 rows run the launch half under
   ``torch.cuda.set_sync_debug_mode("error")``: an operation there that
   synchronises the stream fails the run.  The fused, per-op and int8 +
   int8 KV tp 1 rows are served again by the synchronous loop
   (``async_decode=False``): streams equal token for token, both loops'
   numbers side by side.  Prefix traffic (fused tp 1, and int8 weights +
   int8 KV tp 1): a shared prefix (fp 200 tokens, 12 full pages and 8
   tokens, so every hit forks the partial page copy-on-write; int8 192,
   12 whole pages) served alone, then 47 requests of the prefix and 8-56
   unique tokens (a distinct first token each), 16-64 new, from
   ``--seed``, with the prefix cache on and off: 47 hits, 47 x the
   prefix's tokens saved, 47 forks (fp) or none (int8), streams equal
   (where one differs, ``full_forward``'s top-2 margin there below
   1e-4), time to first token and chunks on and off.  Sessions (fused
   tp 1): 16 two-turn sessions (64 prompt tokens and 32 new, then 32 and
   32), each continuation equal to the one-shot request over the whole
   conversation; 4 parked sessions exported and imported into a second
   engine (pages bit-equal), a third turn equal on both; the same between
   two int8-KV engines (v2 blobs with scales).  Launch counts are set to
   0 before the prefix and session phases and read after them.
   The JAX package's serving-test model, ``decoder_tiny_lm(seed=0)`` (head
   dim 16), served 16 requests fused, per-op and with int8 KV pages, each
   run's launches held to its path and its streams to the same engine's on
   CPU copies of the weights (equal, or apart only after a near-tie).  The
   HTTP surface: a ``ModelServer`` on 127.0.0.1 serving the full-width
   model and the tiny LM through ``attach_engine``, a ``ServingClient``
   sending 4 generate requests to each and a resume of an unknown session
   (typed ``SessionResetError``); the tokens must equal the same requests
   sent straight to the engines; round trips printed beside the engines'
   own times.
   Speculative decoding (``spec_phase``): 32 requests (three in four
   repeating a 3-8 token phrase to 16-128 tokens, 32-128 new) through
   each row of ``SPEC_RUNS`` (n-gram fp on the sync and the async loop,
   the draft model, n-gram with int8 weights + int8 KV, int4, tp 2, and
   fp and int8 + int8 KV again with drafts the target accepts in part),
   each beside the same engine without speculation: streams equal (or apart
   only at a near-tie of the engine's own prefill program, printed),
   launches held to the path (plain steps, each verify step's census, the
   draft model's steps and chunks), tokens/s, accepted / drafted, tokens
   a step, the verify step's device time (CUDA events), the draft's host
   time.
   The sharded-attention path: forward and backward through
   ``flash_attention_sharded`` (dp 2 x tp 2, causal) in fp32 and bf16,
   launching #5, the delta kernel, #6 and #7 once a call.
4. Training: ``BERTModel`` at BERT-base widths (the same widths, 2 token
   types, dropout 0.1, ``use_flash=True``, fused epilogues; Xavier
   weights from ``--seed`` with random biases and LN affines), three
   times through ``gluon.Trainer`` with Adam (lr 1e-4) on a fixed MLM +
   NSP batch (valid lengths L/2..L): 10 steps at B 32, L 128 in fp32; the
   same under ``amp.convert_hybrid_block(net, "bfloat16")``, whose step-1
   loss must agree with fp32's and whose parameters stay fp32 while the
   flash and epilogue kernels run in bf16; and 3 AMP steps at B 4, L 2048
   (``max_length=2048``).  In each the dropout-free loss must fall, each
   step must launch ``bias_gelu`` and its backward 13 times,
   ``bias_dropout_residual`` forward and backward 24 times each and each
   flash kernel 12 times (counts set to 0 before the phase), every
   tensor autograd saves must be on the card, and none may be a (B, H,
   L, L) attention matrix.  Then one Adam step at B 2, L 32, dropout 0,
   on the card and on CPU copies of the weights: loss, gradients and
   weights agree.
5. LSTM training (``lstm_lm``): the word LM of the reference's
   ``example/rnn/word_lm``, "medium" config (``Embedding(10000, 650)``,
   ``gluon.rnn.LSTM(650, num_layers=2, layout="NTC")``,
   ``Dense(10000)``; Xavier weights and random biases from ``--seed``),
   10 SGD steps (lr 0.1, ``Trainer.step(B)``) at B 32, bptt 35 on the
   Zipf-plus-bigram corpus of ``example/gluon/word_language_model.py``,
   with truncated BPTT (each step starts from the last one's detached
   state), in fp32 and again under AMP bf16, whose step-1 loss must agree
   with fp32's.  The loss on segment 0 from a zero state must fall, each
   step must launch #10 and #11's two kernels twice (counts set to 0
   before the phase)
   and every tensor autograd saves must be on the card.  Then one SGD
   step of a small word LM (vocab 100, 2 x 64, B 4, T 8) on the card and
   on CPU copies: loss, gradients and weights agree.
6. The array and op core (``array_core_phase``): the BERT-base encoder
   (12 layers, 768 units, FFN 3072, 12 heads) composed of ``mx.np`` /
   ``mx.npx`` ops (``models.bert.encoder_np``, the JAX package's
   composition with flash attention and the fused epilogues) with
   ``np.ndarray`` parameters under ``autograd.record()`` at B 32, L 128,
   valid lengths L/2..L, dropout 0.1: 3 forward + backward steps in fp32
   and one under ``amp.init("bfloat16")`` + ``amp.op_scope()`` (on step
   1's dropout masks, its loss within 1% of step 1's), the second fp32
   step under ``torch.cuda.set_sync_debug_mode("error")`` (it must
   enqueue without a host wait), each step
   launching ``bias_gelu`` and its backward 12 times,
   ``bias_dropout_residual`` forward and backward 24 times each and #5,
   the delta kernel, #6 and #7 12 times; then the 2 x 650 LSTM through
   ``npx.rnn`` on one flat parameter vector (B 32, T 35), forward and
   backward: #10 and #11's two kernels twice each.  Every ``.grad`` must
   be on the card.  At dropout 0 the encoder's output and gradients are
   held to ``models.bert.BERTEncoder`` on the same weights, ``npx.rnn``
   to ``gluon.rnn.LSTM``; the encoder at B 2, L 32 with hash dropout 0.1
   (the FFN's ``npx.dropout`` off) to the same program on the CPU;
   ``nd.save``/``nd.load`` round trips on the card, npz and legacy; the
   np/npx step timed beside the torch-native encoder's by CUDA events,
   and one ``apply_op`` dispatch's host time beside ``torch.add``'s.
7. Gluon (``gluon_phase``), through the user's entry points on
   ``ndarray``s (counts set to 0 before the main path): LeNet (bench
   config 1: ``Conv2D(6, 5, tanh)``, ``MaxPool2D``, ``Conv2D(16, 5,
   tanh)``, ``MaxPool2D``, ``Flatten``, ``Dense(120, tanh)``,
   ``Dense(84, tanh)``, ``Dense(10)``, ``initialize(Xavier())``) for 20
   SGD steps (lr 0.05) on the MNIST synthetic fallback through
   ``ToTensor`` and a shuffled ``DataLoader(batch_size=64)``, with
   ``metric.Accuracy``: the loss on the first batch must fall; the
   BERT-base FFN as ``HybridSequential(Dense(3072, "gelu"), Dense(768))``
   at (32, 128, 768), forward and backward under ``record()``: one launch
   of #1 and of #2; the word LM of ``example/gluon/word_language_model.py``
   (vocab 10000, 2 x 650, NTC, dropout 0.2, ``hybridize()``d) for 5 SGD
   steps (lr 1) at B 32, bptt 35 with ``clip_global_norm(grads, 0.25)``:
   the loss on segment 0 must fall and #10/#11 launch twice a step.  Then
   the checks (not counted): the FFN's output and its four gradients
   against ``F.linear`` -> ``F.gelu`` -> ``F.linear`` on the same
   weights; the Gluon word LM at dropout 0 against the torch-native
   ``word_lm`` from the same weights, one step's loss and gradients; one
   LeNet step at B 4 and one small word-LM step on the card and on the
   CPU from the same weights; the Gluon LM step timed in turns beside the
   torch-native one (``train_lm``'s); one layer call's host time with
   ``ndarray``s beside torch tensors and ``F.linear``.
8. The kernels line (launches summed over the serving runs, the prefix,
   session, tiny-LM, HTTP and speculative phases, the sharded-attention
   path, the training phases, the array-core and the Gluon phases), the
   card line and, last, the result line ``{"ok": true, "device":
   {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# fp32-accurate products on the tensor cores: 3xTF32 (hi hi + hi lo + lo
# hi) at the TF32 peak.  The bound of the fp32 flash rows: the card can do
# their fp32 work this fast, faster than on its FMAs.
TF32X3_FLOPS = TF32_FLOPS / 3

# tolerances of the kernel checks, kernel vs plain version on the card
TOL_BIAS_GELU = 1e-5     # one fp32 erf per element
TOL_ATTENTION = 1e-4     # fp32 online vs two-pass softmax over <= 512 keys
TOL_FUSED = 1e-3         # fp32, 12 layers, GEMV sums in another order
TOL_LOGITS = 1e-3        # teacher-forced logits vs full_forward, fp32
# quant_matmul vs its plain version (dequantize, then x @ w.T): the kernel
# adds its products in another order (K slices, warps, tensor-core sums),
# splits x into two tf32 pieces (x - hi - lo within 2^-22 of x), and for
# int8 and grouped int4 applies the scale after a sum rather than to each
# weight, so the two round differently: ~1e-5 at most on outputs of order
# 1 (x ~ N(0, 1), Xavier weights, up to 3072 inputs); one tf32 piece
# (~5e-4 off) fails it
TOL_QMM = 1e-4
# teacher-forced logits with int8 KV pages, card vs CPU copies of the
# params and pages: K/V that differ in the last fp32 bit between the two
# devices can round to neighbouring int8 codes at a .5 boundary, moving
# one element by one step of its page's scale (~amax/127); such flips in
# 12 layers move logits of order 0.2 by up to ~1e-2
TOL_LOGITS_INT8KV = 2e-2
# bias_gelu_backward: fp32 erf and exp a few ulps from torch's, on dx of
# order 1 (x, g ~ N(0, 1)); in bf16 the check allows one bf16 step of the
# plain version's value (within_bf16_step) and this much beyond it
TOL_BIAS_GELU_BWD = 1e-5
# bias_dropout_residual: the kernels do the plain version's fp32 adds and
# multiplies in the same order with round-to-nearest, so 0 is expected
TOL_BDR = 1e-6

WIDTHS = dict(vocab_size=30522, num_layers=12, units=768, hidden_size=3072,
              num_heads=12, num_kv_heads=12, max_length=512)
SLOTS, PAGE, CHUNK, MAX_CTX = 16, 16, 64, 512
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timer:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    write of a buffer larger than the 50 MB L2, so every launch starts
    with a cold cache as the serving path's kernels mostly do.  A ~0.1 ms
    spin kernel sits between the flush and the start event, so the host
    has enqueued ``fn``'s launches before the card reaches them: the time
    is the card's, not the wrapper's Python."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, iters=20, spin=200_000, clean=False):
        """``clean``: empty the L2 by reading the buffer instead of writing
        it, so the lines ``fn``'s reads evict need no write-back (a
        diagnostic of what the dirty lines cost a streaming kernel)."""
        torch = self.torch
        fn()
        ms = []
        words = self.flush.view(torch.int32)
        for _ in range(iters):
            if clean:
                words.amax()
            else:
                self.flush.zero_()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        return statistics.median(ms)

    def floor(self):
        """The timer's own floor: the time of an empty kernel (a spin of 0
        cycles) between the events, measured once.  A small kernel's time
        reads as this floor plus its work."""
        if not hasattr(self, "_floor"):
            self._floor = self(lambda: self.torch.cuda._sleep(0))
            log("timer floor (an empty kernel, median of 20): %.4f ms"
                % self._floor)
        return self._floor


def bound(nbytes, flops, peak=FP32_FLOPS):
    return bound_time(nbytes, flops / peak)


def bound_time(nbytes, t_ops):
    """(ms, by): the larger of the bytes' time at the card's memory rate
    and ``t_ops`` seconds of operations."""
    t_b = nbytes / HBM_BYTES_PER_S
    return max(t_b, t_ops) * 1e3, ("bytes" if t_b >= t_ops else "operations")


def tables_for(rng, lengths, pps, first_page=1):
    """Distinct pages for every row up to its length; unused entries on
    the scratch page 0."""
    need = [-(-int(n) // PAGE) for n in lengths]
    pages = rng.permutation(np.arange(first_page, first_page + sum(need)))
    t = np.zeros((len(lengths), pps), np.int32)
    k = 0
    for b, n in enumerate(need):
        t[b, :n] = pages[k:k + n]
        k += n
    return t


def perturb_affine(torch, lm, seed):
    """Random biases and LN betas (N(0, 0.1)) and LN gammas (1 + N(0,
    0.1)), in place.  The initialiser leaves them at 0 and 1, where a
    kernel that dropped or swapped one would still agree with its plain
    version and with ``full_forward``."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if p.dim() == 1:
                base = 1.0 if name.endswith(("ln1g", "ln2g")) else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, device=DEV,
                                                 generator=g))
    return lm


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
#: (R, C) of the bias_gelu checks: the per-op decode step, the prefill
#: chunk and BERT training at FFN1's width; a ragged C (one element a
#: thread) and FFN1's bias shard at tp 2
BIAS_GELU_SHAPES = ((16, 3072), (64, 3072), (4096, 3072), (16, 770),
                    (64, 770), (16, 1536), (64, 1536))


def check_bias_gelu(torch, timer, report):
    """bias_gelu (the CUDA forward) against its plain version at every
    (R, C) of ``BIAS_GELU_SHAPES`` in float32 and bfloat16, each within
    ``TOL_BIAS_GELU`` (bf16: beyond one bf16 step of the plain value),
    timed beside its plain version, its bound and the timer's floor, with
    its launch plan; then the host's enqueue time (``bias_gelu_host``).
    The row in the kernels line is (64, 3072) fp32, the prefill chunk."""
    from mxnet_tpu_torch.ops.kernels import epilogue as ep
    g = torch.Generator(device=DEV).manual_seed(1)
    floor = timer.floor()
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for R, C in BIAS_GELU_SHAPES:
            x = torch.randn(R, C, device=DEV, generator=g).to(dt)
            b = torch.randn(C, device=DEV, generator=g).to(dt)
            out, ref = ep.bias_gelu(x, b), ep.bias_gelu_plain(x, b)
            err = (float((out - ref).abs().max()) if dt == torch.float32
                   else within_bf16_step(out, ref))
            ms = timer(lambda: ep.bias_gelu(x, b))
            plain = timer(lambda: ep.bias_gelu_plain(x, b))
            e = x.element_size()
            bms, by = bound(e * (2 * R * C + C), 12 * R * C)
            plan = (ep.bias_gelu_plan(R, C, e, True, ep._sms(x.device.index))
                    if hasattr(ep, "bias_gelu_plan") else None)
            log("bias_gelu (%d, %d) %s: max_abs_err %.3g (tol %g%s) kernel "
                "%.4f ms (timer floor %.4f) plain %.4f ms bound %.4f ms "
                "(%s)%s" % (R, C, str(dt)[6:], err, TOL_BIAS_GELU,
                            "" if dt == torch.float32 else
                            " beyond one bf16 step", ms, floor, plain, bms,
                            by, "; plan vec %d, %d threads, %d rows a pass, "
                            "grid %s" % plan
                            if plan else ""))
            if not err <= TOL_BIAS_GELU:
                raise AssertionError("bias_gelu (%d, %d) %s disagrees with "
                                     "its plain version" % (R, C, dt))
            rows[R, C, dt] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bms, bound_by=by)
    report["bias_gelu"] = dict(
        name="bias_gelu", route="cuda",
        source="mxnet_tpu_torch/csrc/epilogue.cu",
        replaces="mxnet_tpu/ops/pallas/epilogue.py:135", library_ms=None,
        shape="(64, 3072) prefill chunk",
        **rows[64, 3072, torch.float32])
    bias_gelu_host(torch, ep)


#: launches of #1 timed beside its plan (``bias_gelu_launches``): (R, C,
#: dtype name, elements a thread, threads, rows a pass, row groups or
#: None for ceil(R / rows)); at (4096, 3072) a grid-strided launch of 8
#: blocks of 128 threads an SM and one pass of 1, 2 or 4 rows, at the
#: bf16 serving shapes 16- and 8-byte vectors of one or two rows
GELU_LAUNCHES = tuple(
    [(4096, 3072, dt, v, 128, 4, 1056 // (3072 // v // 128))
     for dt, v in (("float32", 4), ("bfloat16", 8))]
    + [(4096, 3072, dt, v, 128, r, None)
       for dt, v in (("float32", 4), ("bfloat16", 8)) for r in (1, 2, 4)]
    + [(R, C, "bfloat16", v, 128, r, None) for R, C in ((16, 3072),
                                                       (64, 3072),
                                                       (64, 1536))
       for v in (8, 4) for r in (1, 2)])


def bias_gelu_launches(torch, ep, timer, launches=GELU_LAUNCHES):
    """#1 launched as each of ``launches`` describes (through the C entry
    point, bypassing the plan), held against the plain version and timed;
    a tree without ``bias_gelu_plan`` prints nothing."""
    if not hasattr(ep, "bias_gelu_plan"):
        return
    from mxnet_tpu_torch.ops.kernels import _build
    g = torch.Generator(device=DEV).manual_seed(8)
    lib = ep._lib()
    for R, C, name, vec, threads, rows, gy in launches:
        dt = getattr(torch, name)
        x = torch.randn(R, C, device=DEV, generator=g).to(dt)
        b = torch.randn(C, device=DEV, generator=g).to(dt)
        out = torch.empty_like(x)
        gx, gy = -(-C // vec // threads), gy or -(-R // rows)

        def launch():
            _build.check(lib, lib.mxt_bias_gelu_fwd(
                x.data_ptr(), b.data_ptr(), out.data_ptr(), R, C,
                ep._GELU_DTYPES[dt], 0, vec, threads, rows, gx, gy,
                torch.cuda.current_stream().cuda_stream), "bias_gelu")

        launch()
        ref = ep.bias_gelu_plain(x, b)
        err = (float((out - ref).abs().max()) if dt == torch.float32
               else within_bf16_step(out, ref))
        log("bias_gelu (%d, %d) %s launched with %d elements a thread, %d "
            "threads, %d rows a pass, grid (%d, %d): %.4f ms, max_abs_err "
            "%.3g; the plan: %s" % (R, C, name, vec, threads, rows, gx, gy,
                                    timer(launch), err,
                                    ep.bias_gelu_plan(R, C, x.element_size(),
                                                      True)))
        if not err <= TOL_BIAS_GELU:
            raise AssertionError("bias_gelu launch disagrees")


def bias_gelu_host(torch, ep, n=500):
    """The host's enqueue time of one call (us, median of 5 runs of n
    calls issued back to back, then one synchronize): bias_gelu, its
    plain version and ``F.gelu(x + b)`` (two PyTorch calls) at (16, 3072)
    fp32, a per-op decode step's FFN1 epilogue, and at (64, 3072); and two
    parts of every wrapper's call, ``torch.empty_like`` and the current
    stream.  The serving path is host-bound, so this is what a call costs
    it."""
    import torch.nn.functional as F
    g = torch.Generator(device=DEV).manual_seed(7)
    out = {}
    for R in (16, 64):
        x = torch.randn(R, 3072, device=DEV, generator=g)
        b = torch.randn(3072, device=DEV, generator=g)
        for name, fn in (("kernel", lambda: ep.bias_gelu(x, b)),
                         ("plain", lambda: ep.bias_gelu_plain(x, b)),
                         ("F.gelu(x + b)", lambda: F.gelu(x + b)),
                         ("empty_like", lambda: torch.empty_like(x)),
                         ("current_stream", lambda: torch.cuda.current_stream(
                             x.device).cuda_stream)):
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(n):
                    fn()
                runs.append((time.perf_counter() - t) / n * 1e6)
                torch.cuda.synchronize()
            out["(%d, 3072) %s" % (R, name)] = round(statistics.median(runs),
                                                     2)
    log("bias_gelu host enqueue, us a call: %s" % json.dumps(out))
    return out


#: the paged attention cases timed (the first is the kernels line's)
PAGED_TIMED = ("mixed", "all512")


def paged_cases(rng):
    """(case, lengths) of each case of TP_CASES for the paged attention
    checks: "mixed" random 1..512 with row 3 at 0 and row 5 at 512, B 1 at
    512, the others the case's own lengths."""
    for case, B, fixed in TP_CASES:
        if fixed is not None:
            lengths = np.array(fixed)
        elif B == 1:
            lengths = np.array([512])
        else:
            lengths = rng.integers(1, 513, B)
            lengths[3] = 0
            lengths[5] = 512
        yield case, lengths


def check_paged(torch, timer, report, int8):
    """#15 over fp pages, or over int8 QPages (``int8``), against
    ``paged_attention_reference`` (for int8 pages: gather_pages_deq +
    attend_ctx) at H 12 over 12 and over 4 KV heads, D 64 (and over 4 KV
    heads at D 32 and 128, the kernel's other instantiations), in every
    case of TP_CASES; every length-0 row must be zero.  Times at D 64 in
    PAGED_TIMED beside the plain version and SDPA on the gathered
    (dequantized) cache."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    name = "paged_attention_int8" if int8 else "paged_attention"
    P, pps = SLOTS * 32 + 1, 32
    for H, KVH, D in ((12, 12, 64), (12, 4, 64), (12, 4, 32), (12, 4, 128)):
        rng = np.random.default_rng(7 if int8 else 2)
        g = torch.Generator(device=DEV).manual_seed(8 if int8 else 3)
        for case, lengths in paged_cases(rng):
            B = len(lengths)
            q = torch.randn(B, H, D, device=DEV, generator=g)
            if int8:
                def pages():
                    codes = torch.randint(-127, 128, (KVH, P, PAGE, D),
                                          device=DEV, generator=g)
                    scales = torch.rand(KVH, P, device=DEV, generator=g)
                    return pa.QPages(q=codes.to(torch.int8),
                                     s=scales * 0.05)
                kp, vp = pages(), pages()
            else:
                kp = torch.randn(KVH, P, PAGE, D, device=DEV, generator=g)
                vp = torch.randn(KVH, P, PAGE, D, device=DEV, generator=g)
            ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            tb = torch.tensor(tables_for(rng, lengths, pps), device=DEV)
            out = pa.paged_attention(q, kp, vp, ln, tb)
            ref = pa.paged_attention_reference(q, kp, vp, ln, tb)
            err = float((out - ref).abs().max())
            zero = lengths == 0
            if not torch.all(out[torch.tensor(zero, device=DEV)] == 0):
                raise AssertionError("%s: a length-0 row is not zero" % name)
            log("%s B=%d H=%d KVH=%d D=%d %s lengths %d..%d (%d of length "
                "0): max_abs_err %.3g (tol %g)"
                % (name, B, H, KVH, D, case, lengths.min(), lengths.max(),
                   zero.sum(), err, TOL_ATTENTION))
            if not err <= TOL_ATTENTION:
                raise AssertionError("%s disagrees with its plain version"
                                     % name)
            if case not in PAGED_TIMED or D != 64:
                continue
            ms = timer(lambda: pa.paged_attention(q, kp, vp, ln, tb))
            plain = timer(lambda: pa.paged_attention_reference(q, kp, vp, ln,
                                                               tb))
            # yardstick: one SDPA call over the pre-gathered contiguous
            # (for int8 pages dequantized) cache
            if int8:
                kc = pa.gather_pages_deq(kp.q, kp.s, tb)
                vc = pa.gather_pages_deq(vp.q, vp.s, tb)
            else:
                kc, vc = pa.gather_pages(kp, tb), pa.gather_pages(vp, tb)
            mask = (torch.arange(pps * PAGE, device=DEV)[None, None, None, :]
                    < ln.reshape(B, 1, 1, 1))
            lib = timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kc, vc, attn_mask=mask,
                enable_gqa=(H != KVH)))
            toks = int(lengths.sum())
            if int8:
                pages_read = int(sum(-(-int(n) // PAGE) for n in lengths))
                nbytes = (2 * toks * KVH * D + 2 * 4 * pages_read * KVH
                          + 4 * (2 * B * H * D + B + B * pps))
            else:
                nbytes = 4 * (2 * B * H * D + 2 * toks * KVH * D + B
                              + B * pps)
            bms, by = bound(nbytes, 4 * H * D * toks)
            log("%s B=%d H=%d KVH=%d D=%d %s lengths: kernel %.4f ms plain "
                "%.4f ms sdpa(%sgathered) %.4f ms bound %.4f ms"
                % (name, B, H, KVH, D, case, ms, plain,
                   "dequantized, " if int8 else "", lib, bms))
            if hasattr(pa, "paged_attention_times"):
                st = phase_stamps(torch, timer, pa.paged_attention_times,
                                  (q, kp, vp, ln, tb))
                log("%s H=%d KVH=%d %s lengths, phases by %%globaltimer "
                    "(block 0, median of 5 launches): %s; sum %.2f us"
                    % (name, H, KVH, case, " ".join(
                        "%s %.2f us" % kv for kv in st.items()),
                       sum(st.values())))
            if H == KVH and case == PAGED_TIMED[0]:
                report[name] = dict(
                    name=name, route="cuda",
                    source="mxnet_tpu_torch/csrc/paged_attention.cu",
                    replaces="mxnet_tpu/ops/pallas/paged_attention.py:%s"
                    % ("237" if int8 else "251"),
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape="B=16 H=12 KVH=12 D=64%s, mixed lengths"
                    % (" int8 pages" if int8 else ""))


def check_paged_attention(torch, timer, report):
    check_paged(torch, timer, report, int8=False)


#: the held cases of the fused decode check: (case, model, B, lengths
#: after the append, or None for random 1..512 with row 7 at 0).  "lm" is
#: the 12-layer serving model, "gqa" its 2-layer GQA variant (12 heads
#: over 4 KV heads); the others are 2-layer models of FUSED_MODELS.
#: "mixed" is the timed case of the kernels line and the digest, "all512"
#: the worst case, also timed; "one" is B 1; "b20" two passes of 16 rows
FUSED_CASES = (("mixed", "lm", SLOTS, None),
               ("all512", "lm", SLOTS, (512,) * SLOTS),
               ("one", "lm", 1, (512,)),
               ("gqa", "gqa", SLOTS, None),
               ("b20", "gqa", 20, None),
               ("d32", "d32", SLOTS, None),
               ("d128", "d128", SLOTS, None),
               ("wide", "wide", SLOTS, None))
FUSED_TIMED = ("mixed", "all512")
#: 2-layer models of the fused check: head dims 32 (g 1) and 128 (g 3),
#: the kernel's other instantiations; and "wide" (C 1024, F 4096), whose
#: qkv, FFN1 and FFN2 K slices are too long for the weight buffers and
#: whose FFN1 has more units than the grid has blocks, so its units stream
#: their weight rows from device memory (the path shapes that do not fit
#: take)
FUSED_MODELS = dict(
    d32=dict(units=768, hidden_size=3072, num_heads=24, num_kv_heads=24),
    d128=dict(units=768, hidden_size=3072, num_heads=6, num_kv_heads=2),
    wide=dict(units=1024, hidden_size=4096, num_heads=16, num_kv_heads=16))


def fused_bound(cfg, after, pps):
    """Bound of #12 over cfg's layers at these lengths (after the append):
    each weight once, the KV of every token read once and the appended
    rows written once, x read and written once, the metadata; 2 flops per
    weight and row, 4 per (head, key, dim)."""
    B, C, Fh, L = len(after), cfg.units, cfg.hidden_size, cfg.num_layers
    kvc = cfg.num_kv_heads * cfg.head_dim
    n_w = L * (2 * C * C + 2 * C * kvc + 2 * C * Fh + 6 * C + 2 * kvc + Fh)
    toks = int(after.sum())
    nbytes = 4 * (n_w + L * 2 * toks * kvc + 2 * L * 2 * B * kvc
                  + 2 * B * C + 4 * B + B * pps)
    flops = 2 * B * n_w + L * 4 * cfg.num_heads * cfg.head_dim * toks
    return bound(nbytes, flops)


def fused_stamps(torch, timer, fc, args, runs=5):
    """#12's ``fused_cell.phase_times`` over ``runs`` launches, each after
    the L2 flush: per key and layer the median (None where every launch
    gave None)."""
    out = []
    for _ in range(runs + 1):
        timer.flush.zero_()
        out.append(fc.phase_times(*args))
    med = {}
    for k in out[0]:
        med[k] = []
        for li in range(len(out[0][k])):
            vals = [r[k][li] for r in out[1:] if r[k][li] is not None]
            med[k].append(statistics.median(vals) if vals else None)
    return med


def check_fused(torch, timer, report, lm, lm_gqa):
    """#12 against its plain version in every case of FUSED_CASES: x and
    every page after page 0 (the scratch page inactive rows write) within
    TOL_FUSED.  Its phases by ``%globaltimer`` in every case, with when
    each GEMV's weight rows had landed and how many units streamed them
    (where the kernel reports these): at full width every unit of every
    GEMV must have its rows copied in and none stream, in "wide" some must
    stream.  Timed in FUSED_TIMED; a digest of "mixed"'s outputs (equal
    digests in two trees: the same bits)."""
    from mxnet_tpu_torch.models import decoder as dec
    from mxnet_tpu_torch.ops.kernels import fused_cell as fc
    models = {"lm": lm, "gqa": lm_gqa}
    for key, kw in FUSED_MODELS.items():
        models[key] = perturb_affine(torch, dec.CausalLM(
            vocab_size=64, num_layers=2, max_length=MAX_CTX, device=DEV,
            seed=21, **kw), 21)
    pps, rows, worst = MAX_CTX // PAGE, {}, 0.0
    for case, key, B, fixed in FUSED_CASES:
        model = models[key]
        cfg = model.config
        rng = np.random.default_rng(4)
        after = rng.integers(1, 513, B)      # lengths after this append
        if B > 7:
            after[7] = 0                     # inactive row
        if fixed is not None:
            after = np.array(fixed)
        P = B * pps + 1
        tb_np = tables_for(rng, after, pps)
        pos = np.maximum(after - 1, 0)
        wp = np.where(after > 0, tb_np[np.arange(B), pos // PAGE], 0)
        ws = np.where(after > 0, pos % PAGE, 0)
        g = torch.Generator(device=DEV).manual_seed(5)
        shape = (cfg.num_layers, cfg.num_kv_heads, P, PAGE, cfg.head_dim)
        kp0 = torch.randn(shape, device=DEV, generator=g) * 0.5
        vp0 = torch.randn(shape, device=DEV, generator=g) * 0.5
        x = torch.randn(B, cfg.units, device=DEV, generator=g)
        meta = torch.tensor(np.stack([wp, ws]), dtype=torch.int32,
                            device=DEV)
        tb = torch.tensor(tb_np, device=DEV)
        ln = torch.tensor(after, dtype=torch.int32, device=DEV)
        layers = model.params()["layers"]
        table = fc.WeightTable(layers, x.device)
        kp1, vp1 = kp0.clone(), vp0.clone()
        kp2, vp2 = kp0.clone(), vp0.clone()
        _, _, xk = fc.decode_layer_group(x, kp1, vp1, table, meta, tb, ln,
                                         cfg)
        _, _, xp = fc.decode_layer_group_plain(x, kp2, vp2, layers, meta, tb,
                                               ln, cfg)
        err_x = float((xk - xp).abs().max())
        err_p = float(max((kp1[:, :, 1:] - kp2[:, :, 1:]).abs().max(),
                          (vp1[:, :, 1:] - vp2[:, :, 1:]).abs().max()))
        err = max(err_x, err_p)
        L = cfg.num_layers
        log("decode_layer_group %s: L=%d C=%d H=%d KVH=%d D=%d B=%d lengths "
            "%d..%d: max_abs_err x %.3g pages %.3g (tol %g); %d blocks"
            % (case, L, cfg.units, cfg.num_heads, cfg.num_kv_heads,
               cfg.head_dim, B, after.min(), after.max(), err_x, err_p,
               TOL_FUSED, fc.grid_blocks(cfg)))
        if not err <= TOL_FUSED:
            raise AssertionError("decode_layer_group disagrees with its plain "
                                 "version (%s)" % case)
        worst = max(worst, err)
        args = (x, kp1, vp1, table, meta, tb, ln, cfg)
        st = fused_stamps(torch, timer, fc, args)
        tags = ("arrived", "landed", "streamed")
        phases = [k for k in st if not k.endswith(tags)]
        log("  %s phases by %%globaltimer, us summed over %d layers (block "
            "0, median of 5 launches): %s; sum %.1f" % (
                case, L, ", ".join("%s %.1f" % (k, sum(st[k]) / 1e3)
                                   for k in phases),
                sum(sum(st[k]) for k in phases) / 1e3))
        arrived = [k for k in st if k.endswith("arrived")]
        landed = [k for k in st if k.endswith("landed")]
        streamed = {k[:-9]: sum(st[k]) for k in st if k.endswith("streamed")}
        if arrived:
            log("  %s last block at each phase's closing barrier, us after "
                "the phase's start, summed over layers: %s" % (case, ", ".join(
                    "%s %.1f" % (k[:-8], sum(st[k]) / 1e3) for k in arrived)))
        if landed:
            # layer 0's rows were issued at launch, the others' one GEMV
            # ahead
            log("  %s weight rows landed, us after the phase's start, layer "
                "0 / mean of the others: %s; units streamed, all layers: %s"
                % (case, ", ".join("%s %s / %s" % (k[:-7], *(
                    "none" if v is None else "%.2f" % (v / 1e3) for v in (
                        st[k][0], None if None in st[k][1:] or L < 2 else
                        sum(st[k][1:]) / (L - 1))))
                    for k in landed),
                   ", ".join("%s %d" % kv for kv in streamed.items())))
            copied = all(None not in st[k] for k in landed)
            if key != "wide" and (not copied or any(streamed.values())):
                raise AssertionError("decode_layer_group streamed weight "
                                     "rows at %s" % case)
            if key == "wide" and not any(streamed.values()):
                raise AssertionError("decode_layer_group's streamed path "
                                     "was not taken at %s" % case)
        row = dict(max_abs_err=err, stamps_us={
            k: sum(st[k]) / 1e3 for k in phases})
        if arrived:
            row["arrived_us"] = {k[:-8]: sum(st[k]) / 1e3 for k in arrived}
        if landed:
            row["landed_us"] = {k[:-7]: [None if v is None else v / 1e3
                                         for v in st[k]] for k in landed}
            row["streamed"] = streamed
        if case == "mixed":
            # a fresh launch on the held inputs: equal digests in two trees
            # mean #12 computes the same bits
            k3, v3 = kp0.clone(), vp0.clone()
            _, _, x3 = fc.decode_layer_group(x, k3, v3, table, meta, tb, ln,
                                             cfg)
            log("decode_layer_group L=%d B=%d digest of x, kp, vp: %s"
                % (L, B, digest(torch, x3, k3, v3)))
        if case in FUSED_TIMED:
            ms = timer(lambda: fc.decode_layer_group(*args), iters=10)
            plain = timer(lambda: fc.decode_layer_group_plain(
                x, kp2, vp2, layers, meta, tb, ln, cfg), iters=10)
            bms, by = fused_bound(cfg, after, pps)
            log("decode_layer_group %s L=%d B=%d: kernel %.4f ms plain %.4f "
                "ms bound %.4f ms (%s)" % (case, L, B, ms, plain, bms, by))
            row.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        rows[case] = row
    report["fused"] = rows
    main = {k: v for k, v in rows["mixed"].items()
            if k not in ("stamps_us", "arrived_us", "landed_us", "streamed")}
    main["max_abs_err"] = worst          # over every held case
    report["decode_layer_group"] = dict(
        name="decode_layer_group", route="cuda",
        source="mxnet_tpu_torch/csrc/fused_decode.cu",
        replaces="mxnet_tpu/ops/pallas/fused_cell.py:341",
        library_ms=None, shape="12 layers, B=16, full width, mixed lengths",
        **main)


QMM_SHAPES = ((768, 768), (3072, 768), (768, 3072))   # (O, I) of a layer
# the shards the quantized tensor-parallel runs launch: at tp 2 the column
# shards of q, k, v (384, 768) and FFN1 (1536, 768), the row shards of the
# out-projection (768, 384) and FFN2 (768, 1536); at tp 4 (192, 768),
# (768, 192), and FFN1 and FFN2 both (768, 768), a layer's own shape
QMM_TP_SHAPES = ((384, 768), (768, 384), (1536, 768), (768, 1536),
                 (192, 768), (768, 192))
# input dims no K stage divides, (fmt, O, I, group asked of quantize_w4):
# int8 with unaligned code rows (I 100) and x rows (99); int4 groups that
# w4_group shrinks to 8 (I 200), 40 (not a multiple of the MMA's k step)
# and 2 (I 98, unaligned x rows): each folds the scale into the weight
QMM_RAGGED = (("w8", 768, 100, None), ("w8", 768, 99, None),
              ("w4", 768, 200, 128), ("w4", 768, 120, 40),
              ("w4", 768, 98, 128))
QMM_M = (1, 16, 64)
# other plans timed beside qmm_plan's at the layer's shapes (replan
# fields; ``m`` keeps one to that M): 16 or 32 channels a block and the
# K split at M 1 and 16, the K split at M 64
QMM_PLANS = tuple(
    [dict(m=m, wch=w, ks=k) for m in (1, 16) for w in (1, 2)
     for k in (2, 3, 4, 6, 8)]
    + [dict(m=64, ks=k) for k in (2, 3, 4, 6, 8)])


def qmm_cases():
    """(fmt, O, I, group) of every shape ``check_quant_matmul`` holds."""
    return ([(f, o, i, 128) for f in ("w8", "w4")
             for o, i in QMM_SHAPES + QMM_TP_SHAPES] + list(QMM_RAGGED))


def qmm_bound(M, O, I, qw):
    """(ms, by): the codes, scales, x and y moved once, against two tf32
    products per fp32 product (the codes are exact in tf32, x is split
    in two)."""
    nbytes = qw.q.numel() + 4 * qw.s.numel() + 4 * (M * I + M * O)
    return bound_time(nbytes, product_time(2 * M * O * I, 4, 2))


def replan(plan, I, **fields):
    """``plan`` with ``fields`` replaced; a new ``ks`` recuts K into that
    many slices of whole stages, or fewer where the stages run out."""
    from mxnet_tpu_torch.ops.kernels import quant_matmul as qm
    ks = fields.pop("ks", None)
    plan = plan._replace(**fields)
    if ks is not None:
        stages = -(-I // qm.KSTAGE)
        per = -(-stages // min(ks, stages))
        plan = plan._replace(ks=-(-stages // per), slice=per * qm.KSTAGE)
    return plan


def check_quant_matmul(torch, timer, report, plans=(), cases=None):
    """quant_matmul int8 and int4 against quant_matmul_plain, for one
    token, a decode batch and a prefill chunk (M 1, 16, 64), at the three
    GEMM shapes of a layer (group 128), the tensor-parallel row shards and
    the ragged input dims of ``QMM_RAGGED``: each within ``TOL_QMM``, two
    launches on the same inputs equal bit for bit, and the kernel, plain,
    ``F.linear`` (fp32, the dequantized weight) and bound times printed.
    At the layer's shapes it also prints the kernel's phases by
    ``%globaltimer`` (``qmm_phase_times``) and times ``plans``, other
    ``qmm_plan`` fields (each a dict of fields for ``replan``), launched
    through ``_launch`` (a dict's ``m`` keeps it to that M).  ``cases``:
    the (fmt, O, I, group) to hold, all of ``qmm_cases()`` by default; a
    tree without ``qmm_plan`` (the design before it) gets no plan, stamps
    or ``plans`` lines.  The
    row in the kernels line is (3072, 768) at M 16, a decode step's
    FFN1."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.kernels import quant_matmul as qm
    g = torch.Generator(device=DEV).manual_seed(6)
    worst = {}
    cases = qmm_cases() if cases is None else cases
    planned = hasattr(qm, "qmm_plan")
    for fmt, O, I, group in cases:
        bound_w = (6.0 / (O + I)) ** 0.5
        w = (torch.rand(O, I, device=DEV, generator=g) * 2 - 1) * bound_w
        qw = qm.quantize_w8(w) if fmt == "w8" else qm.quantize_w4(w, group)
        wd = qm.dequantize_weight(qw)
        gq = I if fmt == "w8" else I // qw.s.shape[1]
        for M in QMM_M:
            x = torch.randn(M, I, device=DEV, generator=g)
            out = qm.quant_matmul(x, qw)
            again = qm.quant_matmul(x, qw)
            ref = qm.quant_matmul_plain(x, qw)
            err = float((out - ref).abs().max())
            same = bool(torch.equal(out, again))
            ms = timer(lambda: qm.quant_matmul(x, qw))
            plain = timer(lambda: qm.quant_matmul_plain(x, qw))
            lib = timer(lambda: F.linear(x, wd))
            bms, by = qmm_bound(M, O, I, qw)
            plan = (qm.qmm_plan(M, O, I, 8 if fmt == "w8" else 4, gq)
                    if planned else None)
            log("quant_matmul_%s (M=%d, O=%d, I=%d, group %d): max_abs_err "
                "%.3g (tol %g), repeat bit-equal %s; kernel %.4f ms%s plain "
                "%.4f ms F.linear(fp32 dequantized) %.4f ms (kernel/F.linear "
                "%.2f) bound %.4f ms (%s)%s"
                % (fmt, M, O, I, gq, err, TOL_QMM, same, ms,
                   " (timer floor %.4f)" % timer.floor() if M == 1 else "",
                   plain, lib, ms / lib, bms, by,
                   "; plan ks %d slice %d wch %d nt %d fold %s wg %s, %d "
                   "blocks" % (plan.ks, plan.slice, plan.wch, plan.nt,
                               plan.fold, plan.wg, plan.blocks(M, O))
                   if plan else ""))
            if not (err <= TOL_QMM and same):
                raise AssertionError("quant_matmul_%s (M=%d, O=%d, I=%d) "
                                     "disagrees with its plain version or "
                                     "with itself" % (fmt, M, O, I))
            worst[fmt] = max(worst.get(fmt, 0.0), err)
            if (O, I) in QMM_SHAPES and planned:
                log("quant_matmul_%s (M=%d, O=%d, I=%d) stamps (ns; phase: "
                    "median, largest over the blocks): %s"
                    % (fmt, M, O, I, qm.qmm_phase_times(x, qw)))
                for alt in plans:
                    alt = dict(alt)
                    if alt.pop("m", M) != M:
                        continue
                    p = replan(plan, I, **alt)
                    y = torch.empty(M, O, device=DEV)
                    qm._launch(x, qw, y, p)
                    ok = float((y - ref).abs().max()) <= TOL_QMM
                    t = timer(lambda: qm._launch(x, qw, y, p))
                    log("quant_matmul_%s (M=%d, O=%d, I=%d) plan %s: %.4f "
                        "ms, %d blocks, within tol %s; stamps %s"
                        % (fmt, M, O, I, dict(p._asdict()), t,
                           p.blocks(M, O), ok,
                           qm.qmm_phase_times(x, qw, p)))
                    if not ok:
                        raise AssertionError("quant_matmul plan %s "
                                             "disagrees" % (p,))
            if (O, I, M) == (3072, 768, 16):
                report["quant_matmul_" + fmt] = dict(
                    name="quant_matmul_" + fmt, route="cuda",
                    source="mxnet_tpu_torch/csrc/quant_matmul.cu",
                    replaces="mxnet_tpu/ops/pallas/quant_matmul.py:%d"
                    % (179 if fmt == "w8" else 185),
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape="M=16 O=3072 I=768 (decode FFN1)")
    log("quant_matmul: %d cases, largest max_abs_err %s (tol %g)"
        % (len(cases) * len(QMM_M), worst, TOL_QMM))
    # what the kernel does not take raises, and launches nothing
    x = torch.randn(16, 1536, device=DEV, generator=g)[:, ::2]
    qw = qm.quantize_w8(torch.rand(64, 768, device=DEV, generator=g))
    before = qm.quant_matmul.launches_w8
    for bad in (x, x.contiguous().double()):
        try:
            qm.quant_matmul(bad, qw)
        except ValueError as e:
            log("quant_matmul refuses %s %s: %s"
                % (bad.dtype, tuple(bad.stride()), e))
        else:
            raise AssertionError("quant_matmul took a tensor it should "
                                 "refuse")
    assert qm.quant_matmul.launches_w8 == before
    qmm_host(torch, qm)


def qmm_host(torch, qm, n=500):
    """The host's enqueue time of one call (us, median of 5 runs of n
    calls issued back to back, then one synchronize): quant_matmul,
    quant_matmul_plain and F.linear at M 16, (768, 768), a decode step's
    q, k, v or out-projection.  The serving path is host-bound, so this
    is what a call costs it."""
    import torch.nn.functional as F
    g = torch.Generator(device=DEV).manual_seed(7)
    w = torch.rand(768, 768, device=DEV, generator=g) - 0.5
    x = torch.randn(16, 768, device=DEV, generator=g)
    out = {}
    for fmt, qw in (("w8", qm.quantize_w8(w)), ("w4", qm.quantize_w4(w))):
        wd = qm.dequantize_weight(qw)
        for name, fn in (("kernel", lambda: qm.quant_matmul(x, qw)),
                         ("plain", lambda: qm.quant_matmul_plain(x, qw)),
                         ("F.linear", lambda: F.linear(x, wd))):
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(n):
                    fn()
                runs.append((time.perf_counter() - t) / n * 1e6)
                torch.cuda.synchronize()
            out["%s %s" % (fmt, name)] = round(statistics.median(runs), 2)
    log("quant_matmul host enqueue, us a call (M 16, (768, 768)): %s"
        % json.dumps(out))
    return out


def check_qmm_sass(libs):
    """Every instantiation of the quantized matmul issues tf32 products on
    the tensor cores and holds no atomic: mma.sync (HMMA ... TF32) up to
    16 rows, wgmma (HGMMA ... TF32) in the 64-channel kernels (the last
    template flag, ``...ELb1EEE``); opcodes read whole."""
    census = sass_census(libs["quant_matmul"], "qmm_kernel", full=True)
    bad = []
    for fn, ops in sorted(census.items()):
        kind = "HGMMA" if "Lb1EEE" in fn else "HMMA"
        tf32 = sum(n for op, n in ops.items()
                   if op.split(".")[0] == kind and "TF32" in op.split("."))
        atomics = sum(n for op, n in ops.items()
                      if op.split(".")[0] in ATOMIC_OPS)
        log("SASS %s: %s tf32 %d, atomics %d"
            % (fn[-60:], kind, tf32, atomics))
        if not tf32 or atomics:
            bad.append(fn)
    # int8, int4 and int4 folded: 2 channel tiles x 2 row tiles on
    # mma.sync, one tile on wgmma
    if len(census) != 15 or bad:
        raise AssertionError("quant_matmul SASS: %d kernels, without tf32 "
                             "tensor-core products or with atomics: %s"
                             % (len(census), bad))


def check_paged_attention_int8(torch, timer, report):
    check_paged(torch, timer, report, int8=True)


def within_bf16_step(out, ref):
    """Largest |out - ref| beyond one bfloat16 step of ref (2**-7 relative):
    two fp32 results a few ulps apart can round to neighbouring bf16
    values, no further.  0 when every element is within a step."""
    d = (out.float() - ref.float()).abs() - ref.float().abs() * 2.0 ** -7
    return max(0.0, float(d.max()))


def check_bias_gelu_backward(torch, timer, report):
    """bias_gelu_backward (Triton) against its plain version at the
    training path's shapes: (4096, 3072) is FFN1 at B 32, L 128 and
    (4096, 768) the MLM transform; 4095 rows leave a ragged last block."""
    from mxnet_tpu_torch.ops.kernels import epilogue as ep
    g = torch.Generator(device=DEV).manual_seed(9)
    for R, C in ((4096, 3072), (4096, 768), (4095, 3072)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(R, C, device=DEV, generator=g).to(dt)
            b = torch.randn(C, device=DEV, generator=g).to(dt)
            gr = torch.randn(R, C, device=DEV, generator=g).to(dt)
            out = ep.bias_gelu_backward(x, gr, b)
            ref = ep.bias_gelu_backward_plain(x, gr, b)
            if dt == torch.float32:
                err = float((out - ref).abs().max())
                ok = err <= TOL_BIAS_GELU_BWD
            else:
                err = within_bf16_step(out, ref)
                ok = err <= TOL_BIAS_GELU_BWD
            if not ok:
                raise AssertionError("bias_gelu_backward (%d, %d) %s "
                                     "disagrees with its plain version: %g"
                                     % (R, C, dt, err))
            if dt != torch.float32 or (R, C) == (4095, 3072):
                log("bias_gelu_backward (%d, %d) %s: max_abs_err %.3g (tol "
                    "%g%s)" % (R, C, str(dt)[6:], err, TOL_BIAS_GELU_BWD,
                               ", beyond one bf16 step"
                               if dt != torch.float32 else ""))
                continue
            ms = timer(lambda: ep.bias_gelu_backward(x, gr, b))
            plain = timer(lambda: ep.bias_gelu_backward_plain(x, gr, b))
            u = x + b
            lib = timer(lambda: torch.ops.aten.gelu_backward(gr, u))
            bms, by = bound(4 * (3 * R * C + C), 20 * R * C)
            log("bias_gelu_backward (%d, %d) float32: max_abs_err %.3g (tol "
                "%g) kernel %.4f ms plain %.4f ms aten.gelu_backward(g, "
                "x+b precomputed, omits the add) %.4f ms bound %.4f ms (%s)"
                % (R, C, err, TOL_BIAS_GELU_BWD, ms, plain, lib, bms, by))
            if (R, C) == (4096, 3072):
                report["bias_gelu_backward"] = dict(
                    name="bias_gelu_backward", route="triton",
                    source="mxnet_tpu_torch/ops/kernels/epilogue.py",
                    replaces="mxnet_tpu/ops/pallas/epilogue.py:140",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)


def check_bias_dropout_residual(torch, timer, report):
    """bias_dropout_residual forward (rates 0, 0.1, 0.5) and backward (0.1,
    0.5) against their plain versions at (4096, 768), the training path's
    residual joins at B 32, L 128, and at (4095, 766), whose rows take the
    one-element path.  The mask is held exactly: with x = 1, b = 0, r = 0
    the output is the keep scale or 0, and not one element may differ; the
    dropped share must lie within 0.005 of the rate.  Values then on random
    inputs, float32 and bfloat16."""
    from mxnet_tpu_torch.ops.kernels import epilogue as ep
    g = torch.Generator(device=DEV).manual_seed(10)
    for R, C in ((4096, 768), (4095, 766)):
        for rate in (0.0, 0.1, 0.5):
            seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                                 device=DEV, generator=g)
            one = torch.ones(R, C, device=DEV)
            zb, zr = torch.zeros(C, device=DEV), torch.zeros(R, C, device=DEV)
            mk = ep._bdr_forward(one, zb, zr, rate, seed)
            mp = ep.bias_dropout_residual_plain(one, zb, zr, rate, seed)
            mism = int((mk != mp).sum())
            dropped = float((mk == 0).float().mean())
            if mism or abs(dropped - rate) > 0.005:
                raise AssertionError(
                    "bias_dropout_residual mask (%d, %d) rate %g: %d "
                    "mismatches, dropped share %.5f" % (R, C, rate, mism,
                                                         dropped))
            errs = []
            for dt in (torch.float32, torch.bfloat16):
                x, r = (torch.randn(R, C, device=DEV, generator=g).to(dt)
                        for _ in range(2))
                b = torch.randn(C, device=DEV, generator=g).to(dt)
                gr = torch.randn(R, C, device=DEV, generator=g).to(dt)
                errs.append(float((ep._bdr_forward(x, b, r, rate, seed)
                                   - ep.bias_dropout_residual_plain(
                                       x, b, r, rate, seed)).float().abs()
                                  .max()))
                if rate:
                    errs.append(float(
                        (ep._bdr_backward(gr, rate, seed)
                         - ep.bias_dropout_residual_backward_plain(
                             gr, rate, seed)).float().abs().max()))
            err = max(errs)
            log("bias_dropout_residual (%d, %d) rate %g: mask mismatches %d, "
                "dropped %.5f; max_abs_err fwd%s f32/bf16 %s (tol %g)"
                % (R, C, rate, mism, dropped, "/bwd" if rate else "",
                   " ".join("%.3g" % e for e in errs), TOL_BDR))
            if not err <= TOL_BDR:
                raise AssertionError("bias_dropout_residual disagrees with "
                                     "its plain version")
            if (R, C, rate) != (4096, 768, 0.1):
                continue
            x, r, gr = (torch.randn(R, C, device=DEV, generator=g)
                        for _ in range(3))
            b = torch.randn(C, device=DEV, generator=g)
            for key, fn, plain_fn, nbytes, err_k in (
                    ("bias_dropout_residual_fwd",
                     lambda: ep._bdr_forward(x, b, r, rate, seed),
                     lambda: ep.bias_dropout_residual_plain(x, b, r, rate,
                                                            seed),
                     4 * (3 * R * C + C), errs[0]),
                    ("bias_dropout_residual_bwd",
                     lambda: ep._bdr_backward(gr, rate, seed),
                     lambda: ep.bias_dropout_residual_backward_plain(
                         gr, rate, seed),
                     4 * 2 * R * C, errs[1])):
                ms = timer(fn)
                plain = timer(plain_fn)
                bms, by = bound(nbytes, 20 * R * C)
                log("%s (%d, %d) rate %g float32: kernel %.4f ms plain %.4f "
                    "ms bound %.4f ms (%s); no PyTorch call takes a hash mask"
                    % (key, R, C, rate, ms, plain, bms, by))
                report[key] = dict(
                    name=key, route="cuda",
                    source="mxnet_tpu_torch/csrc/epilogue.cu",
                    replaces="mxnet_tpu/ops/pallas/epilogue.py:%d"
                    % (213 if key.endswith("fwd") else 221),
                    max_abs_err=err_k, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


# flash attention #5-#7 against flash_attention_plain on the card.  fp32
# lse and gradients against autograd through the plain forward: the
# kernel's online softmax and its fp32 sums run in another order than the
# plain version's two-pass softmax and cuBLAS products, over up to 2048
# keys: ~1e-6 of the largest element; these allow 100x that.  bf16:
# the kernels round P (forward) and dS (backward) to bf16 where the plain
# version does, but an exp a few ulps apart can round to the neighbouring
# bf16 value, and the outputs are rounded to bf16 at the end: two bf16
# steps (2**-7) of the largest element.  Against autograd through the
# plain forward in bf16: the kernels' delta = sum dO * O reads the output
# rounded to bf16 (as the JAX kernel's does, flash_attention.py:466), and
# dS = P (dP - delta) cancels where dP is close to delta, so that rounding
# (2**-9 of O) reaches a few percent of dS's largest element; 2**-5.
TOL_FLASH_F32 = 1e-4
# The fp32 kernels' results (#5's out, #6's dq, #7's dk and dv) against
# their plain versions: 3xTF32 products keep about 2^-20 of each product
# (a single TF32 product 2^-11), summed over up to 2048 keys: a few 1e-6
# of the largest element at most, where a kernel with single TF32
# products reads ~1e-3 and fails.  tests/test_torch_flash_attention_views.py
# (test_tf32x3_tolerance, test_tf32x3_forward_tolerance) holds the
# emulated products of both against this bound.
TOL_FLASH_3XTF32 = 1e-5
TOL_FLASH_BF16 = 2.0 ** -7
TOL_FLASH_GRAD_BF16 = 2.0 ** -5
BF16_FLOPS = 989e12
#: (B, H, L) of the flash checks: the training shape, the long-context
#: shape and a ragged L
FLASH_SHAPES = ((32, 12, 128), (4, 12, 2048), (2, 6, 200))
#: head dims of the flash checks per dtype: every instantiation
FLASH_DIMS = {"float32": (32, 64, 128), "bfloat16": (32, 64, 128)}
#: the spin kernel's cycles before each timed flash launch (~0.5 ms)
FLASH_SPIN = 1_000_000
#: the flash kernels' wrappers, #5, #6, #7
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def rel_err(a, b):
    """max |a - b| over the largest |b|, in fp32 (0 for two zero
    tensors)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def one_key_bounds(q, k, v, do, rate):
    """The scale of the rounding noise in dq and dk of (B, H, L, D) rows
    whose only valid key is key 0, element by element.  There dS_i =
    dP_i * keep * ks - delta_i is a difference of two dot products of dO_i
    with v_0 (delta through O = ks v_0), each rounded to within a small
    multiple of eps * |dO_i| |v_0|.  So dq_i = scale dS_i k_0 is held to
    scale ks |dO_i| |v_0| |k_0| (a bound, not a typical size), and dk_j =
    scale sum_i dS_i q_i, whose terms' roundings are independent, to scale
    ks |v_j| sqrt(sum_i |dO_i|^2 q_i^2).  A value of ordinary size, dS_i of
    about |dO_i| |v_0| / sqrt(D), is 1 / sqrt(D) of these: a kernel writing
    one into such a row exceeds tol times the bound 1 / (tol sqrt(D))
    times over, 11x and more in bf16 up to D 128 and ~10^4x in fp32."""
    D = q.shape[-1]
    ks = 1.0 / (1.0 - rate) if rate else 1.0
    c = ks / D ** 0.5
    q, k, v, do = (t.float() for t in (q, k, v, do))
    nv = v.norm(dim=-1, keepdim=True)
    ndo = do.norm(dim=-1, keepdim=True)
    b_dq = c * ndo * nv[:, :, :1] * k[:, :, :1].abs()
    b_dk = c * nv * (ndo.square() * q.square()).sum(2, keepdim=True).sqrt()
    return b_dq, b_dk


def flash_case(torch, fa, g, B, H, L, D, dt, mask, rate):
    """One flash check: the kernels' out, lse, dq, dk, dv against the plain
    version (forward and backward with the kernels' rounding) and against
    autograd through the plain forward.  Returns the worst error of each
    and the tolerances."""
    q, k, v, do = (torch.randn(B, H, L, D, device=DEV, generator=g).to(dt)
                   for _ in range(4))
    kw = dict(dropout=rate)
    if rate:
        kw["seed"] = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                                   device=DEV, generator=g)
    if mask == "causal":
        kw["causal"] = True
    elif mask == "window":
        kw["window"] = 32
    elif mask == "kv_length":
        kvl = torch.randint(1, L + 1, (B,), device=DEV, generator=g)
        kvl[0] = 0
        if B > 2:
            kvl[1] = 1
        kw["kv_length"] = kvl
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    pout, plse = fa.flash_attention_plain(q, k, v, **kw)
    if not torch.equal(torch.isinf(lse), torch.isinf(plse)):
        raise AssertionError("flash_attention_fwd: rows without a key differ")
    fin = torch.isfinite(plse)
    errs = {"out": rel_err(out, pout),
            "lse": float((lse[fin] - plse[fin]).abs().max()) if bool(
                fin.any()) else 0.0}
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    pdq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    pdk, pdv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                **kw)
    f32 = dt == torch.float32
    tol = TOL_FLASH_F32 if f32 else TOL_FLASH_BF16
    tol_ag = TOL_FLASH_F32 if f32 else TOL_FLASH_GRAD_BF16
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref, _ = fa.flash_attention_plain(*leaves, **kw)
    grads = torch.autograd.grad(ref, leaves, do)
    # a batch row with exactly one valid key has P = 1 there and dS = P (dP
    # - delta) = 0, so its dq and dk are 0 in exact arithmetic and both
    # sides hold rounding noise: the ratio over their largest element means
    # nothing there.  Those rows' differences are held element by element
    # to tol times the size of the terms whose rounding makes the noise
    # (one_key_bounds; "one_key" and "one_key_autograd" are the worst
    # difference over that, at most 1), the other rows to the ratio over
    # their largest element.
    rows = torch.ones(B, dtype=torch.bool, device=q.device)
    if mask == "kv_length":
        one = kvl == 1
        rows = ~one
        if bool(one.any()):
            b_dq, b_dk = one_key_bounds(q[one], k[one], v[one], do[one], rate)

            def over(a, b, t, bnd):
                return float(((a[one].float() - b[one].float()).abs()
                              / (t * bnd).clamp_min(1e-30)).max())

            errs["one_key"] = max(over(dq, pdq, tol, b_dq),
                                  over(dk, pdk, tol, b_dk))
            errs["one_key_autograd"] = max(over(dq, grads[0], tol_ag, b_dq),
                                           over(dk, grads[1], tol_ag, b_dk))

    def rows_err(a, b):
        return rel_err(a[rows], b[rows]) if bool(rows.any()) else 0.0

    errs.update(dq=rows_err(dq, pdq), dk=rows_err(dk, pdk),
                dv=rel_err(dv, pdv))
    errs["autograd"] = max(rows_err(dq, grads[0]), rows_err(dk, grads[1]),
                           rel_err(dv, grads[2]))
    tols = dict(lse=tol, autograd=tol_ag, one_key=1.0, one_key_autograd=1.0,
                **{n: TOL_FLASH_3XTF32 if f32 else tol
                   for n in ("out", "dq", "dk", "dv")})
    bad = [n for n, e in errs.items() if not e <= tols[n]]
    if bad:
        raise AssertionError(
            "flash attention B %d H %d L %d D %d %s mask %s rate %g: %s "
            "beyond tolerance: %s" % (B, H, L, D, str(dt)[6:], mask, rate,
                                      bad, errs))
    return errs


def check_flash_mask(torch, fa):
    """The dropout mask read off the kernel's output: with q = k = 0 every
    valid probability is 1/64, and with V = I at L = D = 64 the output is
    out[bh, i, j] = keep[bh, i, j] / 64 exactly, so every element of the
    kernel's mask is compared with the plain hash's, at two rates and the
    extreme seeds."""
    from mxnet_tpu_torch.ops.kernels import dropout_hash as dh
    B, H, L = 2, 4, 64
    zeros = torch.zeros(B, H, L, L, device=DEV)
    eye = torch.eye(L, device=DEV).expand(B, H, L, L)
    bh = torch.arange(B * H, device=DEV).reshape(B, H, 1, 1)
    gi = torch.arange(L, device=DEV)[:, None]
    for rate in (0.1, 0.5):
        for seed in (0, 2 ** 32 - 1):
            st = torch.tensor([seed], dtype=torch.int64, device=DEV)
            out, _ = fa.flash_attention_fwd(zeros, zeros, eye, dropout=rate,
                                            seed=st)
            keep = dh.hash_keep_bits(seed, bh, gi, gi.T) >= dh.keep_threshold(
                rate)
            want = keep.float() * dh.keep_scale(rate) / L
            mism = int((out != want).sum())
            dropped = float((out == 0).float().mean())
            log("flash_attention mask rate %g seed %d: %d of %d elements "
                "differ from the plain hash; dropped share %.5f"
                % (rate, seed, mism, out.numel(), dropped))
            if mism or abs(dropped - rate) > 0.01:
                raise AssertionError("flash attention dropout mask differs "
                                     "from the plain hash")


def flash_timing(torch, fa, timer, dt, report, B=None, L=None):
    """#5-#7 at the training shape (B 32, H 12, L 128, D 64; or at ``B``,
    ``L``, as the long-context phase's B 4, L 2048), with the training
    batch's valid lengths at that shape and dropout 0.1, beside the plain
    versions and SDPA; at dropout 0 beside SDPA given the same key mask,
    which computes the same function (``same_function``); and on BERT's
    layout of q, k, v and dO.  Each row's ``library_ms`` is SDPA on the
    same function, its ``dense_library_ms`` SDPA dense at dropout 0 (it
    takes no hash mask).  The training shape's fp32 rows go into
    ``report``."""
    import torch.nn.functional as F
    train_shape = B is None
    B = TRAIN_B if train_shape else B
    L = TRAIN_L if train_shape else L
    H, D = BERT["num_heads"], 64
    g = torch.Generator(device=DEV).manual_seed(12)
    q, k, v, do = (torch.randn(B, H, L, D, device=DEV, generator=g).to(dt)
                   for _ in range(4))
    # int32, as flash_attention hands it to the kernels (no cast per call)
    kvl = pretrain_batch(torch, 0, B, L, DEV)["valid"].to(torch.int32)
    seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=DEV,
                         generator=g)
    kw = dict(dropout=0.1, seed=seed, kv_length=kvl)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    # SDPA's enqueue, as a wrapper's, can outlast the timer's usual 0.1 ms
    # spin on a loaded host; autograd's backward takes longer still: spin
    # ~2 ms there
    dense = {"fwd": timer(lambda: F.scaled_dot_product_attention(q, k, v),
                          spin=FLASH_SPIN),
             "bwd": timer(lambda: torch.autograd.grad(
                 sdpa_out, leaves, do, retain_graph=True), spin=4_000_000)}
    same = same_function(torch, fa, timer, q, k, v, do, kvl, leaves)
    elt = q.element_size()
    keys = float(kvl.sum()) * H * L       # (row, key) pairs the mask keeps
    # the least bytes: each (B, H, L, D) tensor the function reads or
    # writes in full once, k and v only up to each row's kv_length (no
    # key past it is needed), lse and delta once
    full = B * H * L * D * elt
    kv = 2 * float(kvl.sum()) * H * D * elt
    stat = B * H * L * 4
    peak = TF32X3_FLOPS if dt == torch.float32 else BF16_FLOPS
    errs = flash_case(torch, fa, g, B, H, L, D, dt, "kv_length", 0.1)
    rows = {}
    for name, fn, plain, flops, nbytes, err in (
            ("flash_attention_fwd",      # reads q, k, v; writes out, lse
             lambda: fa.flash_attention_fwd(q, k, v, **kw),
             lambda: fa.flash_attention_plain(q, k, v, **kw),
             4 * keys * D, 2 * full + kv + stat,
             max(errs["out"], errs["lse"])),
            ("flash_attention_bwd_dq",   # q, k, v, dO, lse, delta; dq
             lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
             lambda: fa.flash_attention_bwd_dq_plain(*bwd, **kw),
             6 * keys * D, 3 * full + kv + 2 * stat,
             errs["dq"]),
            ("flash_attention_bwd_dkv",  # q, k, v, dO, lse, delta; dk, dv
             lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
             lambda: fa.flash_attention_bwd_dkv_plain(*bwd, **kw),
             8 * keys * D, 4 * full + kv + 2 * stat,
             max(errs["dk"], errs["dv"]))):
        # each wrapper's Python (checks, strides, allocations) takes tens
        # of us to enqueue on a loaded host: spin ~0.5 ms so the card's
        # time is timed
        ms = timer(fn, spin=FLASH_SPIN)
        plain_ms = timer(plain)
        bms, by = bound(nbytes, flops, peak)
        way = "fwd" if name.endswith("fwd") else "bwd"
        log("%s (B %d, H %d, L %d, D %d, kv_length, rate 0.1) %s: "
            "max err / largest %.3g; kernel %.4f ms plain %.4f ms bound "
            "%.4f ms (%s) SDPA %s %.4f ms on the same function at dropout "
            "0, %.4f ms dense" % (
                name, B, H, L, D, str(dt)[6:], err, ms, plain_ms, bms, by,
                "forward" if way == "fwd" else
                "backward (dq, dk and dv in one call)", same[way],
                dense[way]))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, library_ms=same[way],
                          dense_library_ms=dense[way], rate0_ms=same[name],
                          max_abs_err=err)
    # the kernels' fixed part: every kv_length 0, so no tile is visited,
    # but each launch still loads its own side and writes zeros
    z = torch.zeros_like(kvl)
    fixed = {"flash_attention_fwd": timer(
                 lambda: fa.flash_attention_fwd(q, k, v, dropout=0.1,
                                                seed=seed, kv_length=z),
                 spin=FLASH_SPIN),
             "flash_attention_bwd_dq": timer(
                 lambda: fa.flash_attention_bwd_dq(*bwd, dropout=0.1,
                                                   seed=seed, kv_length=z),
                 spin=FLASH_SPIN),
             "flash_attention_bwd_dkv": timer(
                 lambda: fa.flash_attention_bwd_dkv(*bwd, dropout=0.1,
                                                    seed=seed, kv_length=z),
                 spin=FLASH_SPIN)}
    log("%s #5, #6, #7 with every kv_length 0 (B %d, H %d, L %d, D %d), "
        "the launches' fixed part: fwd %.4f ms, dq %.4f ms, dkv %.4f ms"
        % (str(dt)[6:], B, H, L, D, fixed["flash_attention_fwd"],
           fixed["flash_attention_bwd_dq"], fixed["flash_attention_bwd_dkv"]))
    for name, ms in fixed.items():
        rows[name]["fixed_ms"] = ms
    # #5-#7 on BERT's layout, read where it lies: q, k, v permuted out of
    # the (B, L, 3, H, D) projection, dO the transposed gradient of the
    # (B, L, H, D) output, holding q, k, v and dO's values, so each result
    # must equal the contiguous call's bit for bit
    pq, pk, pv = torch.empty(B, L, 3, H, D, device=DEV, dtype=dt).permute(
        2, 0, 3, 1, 4)
    pdo = torch.empty(B, L, H, D, device=DEV, dtype=dt).transpose(1, 2)
    for view, t in zip((pq, pk, pv, pdo), (q, k, v, do)):
        view.copy_(t)
    pbwd = (pq, pk, pv, pdo, lse, delta)
    calls = {"flash_attention_fwd": (
                 lambda: fa.flash_attention_fwd(pq, pk, pv, **kw),
                 lambda: fa.flash_attention_fwd(q, k, v, **kw)),
             "flash_attention_bwd_dq": (
                 lambda: fa.flash_attention_bwd_dq(*pbwd, **kw),
                 lambda: fa.flash_attention_bwd_dq(*bwd, **kw)),
             "flash_attention_bwd_dkv": (
                 lambda: fa.flash_attention_bwd_dkv(*pbwd, **kw),
                 lambda: fa.flash_attention_bwd_dkv(*bwd, **kw))}
    for name in FLASH_KERNELS:
        permuted, contiguous = calls[name]
        got, want = permuted(), contiguous()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("%s on BERT's layout (B %d, L %d) %s differs "
                                 "from the contiguous call"
                                 % (name, B, L, str(dt)[6:]))
        rows[name]["permuted_ms"] = timer(permuted, spin=FLASH_SPIN)
    log("%s #5, #6, #7 on BERT's permuted projection and transposed dO (B "
        "%d, H %d, L %d, D %d, kv_length, rate 0.1), equal to the contiguous "
        "calls bit for bit: %s ms (contiguous: %s)"
        % (str(dt)[6:], B, H, L, D, ", ".join(
            "%.4f" % rows[n]["permuted_ms"] for n in FLASH_KERNELS),
           ", ".join("%.4f" % rows[n]["ms"] for n in FLASH_KERNELS)))
    if dt == torch.float32 and train_shape:
        for name, row in rows.items():
            line = 158 if name.endswith("fwd") else (
                262 if name.endswith("dq") else 314)
            report[name] = dict(
                name=name, route="cuda",
                source="mxnet_tpu_torch/csrc/flash_attention.cu",
                replaces="mxnet_tpu/ops/pallas/flash_attention.py:%d" % line,
                **row)
    return rows


def same_function(torch, fa, timer, q, k, v, do, kvl, leaves):
    """#5, #6 and #7 at dropout 0 with the batch's kv_length, beside SDPA
    given that key mask as a boolean (B, 1, 1, L) ``attn_mask``, forward
    and backward (autograd: dq, dk and dv in one call): one PyTorch call
    computing the same function.  Prints the kernels that are slower than
    it and by what factor; returns each kernel's time by its wrapper's
    name and SDPA's as ``fwd`` and ``bwd``."""
    import torch.nn.functional as F
    B, H, L, D = q.shape
    kw = dict(kv_length=kvl)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    bwd = (q, k, v, do, lse, (do.float() * out.float()).sum(-1))
    mask = (torch.arange(L, device=DEV) < kvl[:, None])[:, None, None]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    err = rel_err(lib_out.detach(), out)
    kernels = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(
                   q, k, v, **kw),
               "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                   *bwd, **kw),
               "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
                   *bwd, **kw)}
    ms = {n: timer(fn, spin=FLASH_SPIN) for n, fn in kernels.items()}
    # the spins of flash_timing's dense SDPA calls: the mask's conversion
    # adds host ops to the forward's enqueue
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=mask),
                    spin=FLASH_SPIN)
    lib_bwd = timer(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                retain_graph=True),
                    spin=4_000_000)
    bwd_ms = ms["flash_attention_bwd_dq"] + ms["flash_attention_bwd_dkv"]
    pairs = (("#5", ms["flash_attention_fwd"], lib_fwd),
             ("#6 + #7", bwd_ms, lib_bwd))
    slower = ["%s %.2fx" % (n, t / lib) for n, t, lib in pairs if t > lib]
    log("%s same function (B %d, H %d, L %d, D %d, kv_length, dropout 0; "
        "SDPA given the key mask as a (B, 1, 1, L) boolean attn_mask, its "
        "out within %.3g of #5's): #5 %.4f ms, SDPA forward %.4f ms; #6 "
        "%.4f + #7 %.4f = %.4f ms, SDPA backward %.4f ms; slower than "
        "SDPA: %s"
        % (str(q.dtype)[6:], B, H, L, D, err, ms["flash_attention_fwd"],
           lib_fwd, ms["flash_attention_bwd_dq"],
           ms["flash_attention_bwd_dkv"], bwd_ms, lib_bwd,
           ", ".join(slower) or "none"))
    return dict(ms, fwd=lib_fwd, bwd=lib_bwd)


#: SASS opcodes of global or shared-memory atomics and reductions
ATOMIC_OPS = ("ATOM", "ATOMG", "ATOMS", "RED", "REDG")


def sass_census(path, marker, full=False):
    """Per kernel whose name holds ``marker``, the count of each SASS
    opcode (its first dotted part, or with ``full`` the whole opcode, as
    ``HGMMA.64x64x8.F32.TF32``) in the library at ``path``, read with the
    toolkit's cuobjdump."""
    from mxnet_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    census, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if marker in name else None
            if fn:
                census[fn] = {}
        elif fn and line.strip().startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0] if full else words[0].split(".")[0]
                census[fn][op] = census[fn].get(op, 0) + 1
    return census


def check_flash_sass(libs):
    """The bf16 flash kernels (#5 forward, #6 and #7 backward) issue wgmma
    (HGMMA), load by TMA (UTMALDG), store by TMA (UTMASTG) and hold no
    atomic; the fp32 kernels (#5, #6, #7) issue tf32 products on wgmma
    and mma.sync, load and store by TMA and hold no atomic; no kernel of
    the CUDA-core fp32 forward is left."""
    census = sass_census(libs["flash_attention"], "_sm90")
    bad = []
    for fn, ops in sorted(census.items()):
        want = {op: ops.get(op, 0) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
        atomics = sum(ops.get(op, 0) for op in ATOMIC_OPS)
        log("SASS %s: %s, atomics %d" % (fn[-60:], want, atomics))
        if not all(want.values()) or atomics:
            bad.append(fn)
    forward = sum("flash_fwd_sm90" in fn for fn in census)
    # 3 kernels (#5, #6, #7) x 3 head dims x dropout on or off
    if len(census) != 18 or forward != 6 or bad:
        raise AssertionError("flash bf16 SASS: %d kernels (%d forward), "
                             "without wgmma/TMA or with atomics: %s"
                             % (len(census), forward, bad))
    # the fp32 kernels (#5, #6, #7): tf32 products on the tensor cores,
    # wgmma (HGMMA ... TF32) and mma.sync (HMMA ... TF32), read from the
    # whole opcode; TMA loads and stores; no atomic
    census = sass_census(libs["flash_attention"], "_tf32", full=True)
    bad = []
    for fn, ops in sorted(census.items()):
        parts = {op: op.split(".") for op in ops}
        tc = {kind: sum(n for op, n in ops.items()
                        if parts[op][0] == kind and "TF32" in parts[op])
              for kind in ("HGMMA", "HMMA")}
        tma = {kind: sum(n for op, n in ops.items() if parts[op][0] == kind)
               for kind in ("UTMALDG", "UTMASTG")}
        atomics = sum(n for op, n in ops.items()
                      if parts[op][0] in ATOMIC_OPS)
        log("SASS %s: tf32 %s, %s, atomics %d"
            % (fn[-60:], tc, tma, atomics))
        if not (all(tc.values()) and all(tma.values())) or atomics:
            bad.append(fn)
    forward = sum("flash_fwd_tf32" in fn for fn in census)
    dkv = sum("flash_bwd_dkv_tf32" in fn for fn in census)
    # 3 kernels (#5, #6, #7) x 3 head dims x dropout on or off
    if len(census) != 18 or forward != 6 or dkv != 6 or bad:
        raise AssertionError("flash fp32 SASS: %d kernels (%d forward, %d "
                             "dk/dv), without tf32 tensor-core products or "
                             "TMA, or with atomics: %s"
                             % (len(census), forward, dkv, bad))
    # the CUDA-core fp32 forward is gone
    left = sass_census(libs["flash_attention"], "flash_fwd_kernel")
    if left:
        raise AssertionError("flash fp32 SASS: CUDA-core forward kernels "
                             "left: %s" % sorted(left))


def check_flash_strided(torch, fa):
    """#5 on strided views equals #5 on their contiguous copies exactly
    (``torch.equal``), in float32 and bfloat16: q, k and v as BERT's head
    permute of a (B, L, 3, H, D) projection and as head slices, the
    kernel reading them where they lie; a view the kernel cannot read in
    place (an expanded, a misaligned one) is copied.  ``out=`` and
    ``lse=`` into slices of larger buffers write those slices and nothing
    else."""
    g = torch.Generator(device=DEV).manual_seed(16)
    B, H, L, D = 4, 12, 200, 64
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(B, L, 3, H, D, device=DEV, generator=g).to(dt)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        whole = torch.randn(3, B, H + 4, L, D, device=DEV, generator=g).to(dt)
        heads = whole[:, :, 2:H + 2]
        odd = torch.randn(B * H * L * D + 1, device=DEV, generator=g).to(dt)
        odd = odd[1:].view(B, H, L, D)          # 2 or 4 bytes off alignment
        kvl = torch.randint(1, L + 1, (B,), device=DEV, generator=g)
        seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=DEV,
                             generator=g)
        cases = (("permuted qkv", (q, k, v), True),
                 ("head slices", tuple(heads), True),
                 ("expanded k", (q, k[:, :1].expand(B, H, L, D), v), False),
                 ("misaligned q", (odd, k, v), False))
        for label, views, in_place in cases:
            if all(fa._strided_ok(t) for t in views) != in_place:
                raise AssertionError("_strided_ok(%s) is not %s"
                                     % (label, in_place))
            for kw in (dict(causal=True), dict(kv_length=kvl, dropout=0.1,
                                               seed=seed)):
                got = fa.flash_attention_fwd(*views, **kw)
                want = fa.flash_attention_fwd(
                    *(t.contiguous() for t in views), **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError("flash_attention_fwd on %s %s %s "
                                         "differs from its contiguous copy"
                                         % (label, str(dt)[6:], kw))
                n += 1
        # out= and lse= into slices of larger buffers
        out_buf = torch.full((B + 1, H + 2, L, D), float("nan"), device=DEV,
                             dtype=dt)
        lse_buf = torch.full((B + 1, H + 2, L), float("nan"), device=DEV)
        out_v, lse_v = out_buf[1:, 1:H + 1], lse_buf[1:, 1:H + 1]
        got = fa.flash_attention_fwd(q, k, v, causal=True, out=out_v,
                                     lse=lse_v)
        want = fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True)
        inside = torch.zeros_like(lse_buf, dtype=torch.bool)
        inside[1:, 1:H + 1] = True
        if not (got[0].data_ptr() == out_v.data_ptr()
                and torch.equal(out_v, want[0])
                and torch.equal(lse_v, want[1])
                and bool(out_buf[~inside].isnan().all())
                and bool(lse_buf[~inside].isnan().all())):
            raise AssertionError("flash_attention_fwd out=/lse= %s wrote "
                                 "other than its slices" % str(dt)[6:])
        n += 1
    log("flash_attention_fwd on strided views (B %d, H %d, L %d, D %d): %d "
        "cases equal their contiguous copies exactly; out=/lse= write only "
        "their slices" % (B, H, L, D, n))
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for D in FLASH_DIMS[str(dt)[6:]]:
            n += check_flash_strided_bwd(torch, fa, g, dt, B, H, L, D)
    log("flash_attention_bwd_dq/_dkv on strided views (B %d, H %d, L %d, D "
        "32, 64, 128, fp32 and bf16): %d cases equal their contiguous copies "
        "exactly; dq=/dk=/dv= write only their slices" % (B, H, L, n))


def check_flash_strided_bwd(torch, fa, g, dt, B, H, L, D):
    """#6 and #7 on strided views equal #6 and #7 on their contiguous
    copies exactly: q, k, v as BERT's permuted projection with dO as a
    transposed gradient, and as head slices, with lse and delta as slices
    of larger buffers, read where they lie; an expanded dO and a
    misaligned q are copied.  dq=, dk= and dv= into slices of larger
    buffers write those slices and nothing else; a misaligned output view
    is written through a copy.  Causal, and kv_length with dropout 0.1.
    Returns the number of cases."""
    def randn(*shape):
        return torch.randn(*shape, device=DEV, generator=g).to(dt)
    q, k, v = randn(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
    do = randn(B, L, H, D).transpose(1, 2)
    heads = randn(4, B, H + 4, L, D)[:, :, 2:H + 2]
    odd = randn(B * H * L * D + 1)[1:].view(B, H, L, D)
    kvl = torch.randint(1, L + 1, (B,), device=DEV, generator=g)
    seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=DEV,
                         generator=g)
    cases = (("permuted qkv, transposed dO", (q, k, v, do), True),
             ("head slices", tuple(heads), True),
             ("expanded dO", (q, k, v, do[:, :1].expand(B, H, L, D)), False),
             ("misaligned q", (odd, k, v, do), False))
    n = 0
    for kw in (dict(causal=True), dict(kv_length=kvl, dropout=0.1,
                                       seed=seed)):
        for label, views, in_place in cases:
            if all(fa._strided_ok(t) for t in views) != in_place:
                raise AssertionError("_strided_ok(%s) is not %s"
                                     % (label, in_place))
            out, lse = fa.flash_attention_fwd(*views[:3], **kw)
            delta = (views[3].float() * out.float()).sum(-1)
            stats = [torch.full((B + 1, H + 2, L), float("nan"), device=DEV)
                     [1:, 1:H + 1].copy_(t) for t in (lse, delta)]
            flat = [t.contiguous() for t in views] + [lse, delta]
            got = (fa.flash_attention_bwd_dq(*views, *stats, **kw),
                   *fa.flash_attention_bwd_dkv(*views, *stats, **kw))
            want = (fa.flash_attention_bwd_dq(*flat, **kw),
                    *fa.flash_attention_bwd_dkv(*flat, **kw))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(
                    "flash_attention_bwd on %s %s D %d %s differs from its "
                    "contiguous copy" % (label, str(dt)[6:], D, kw))
            n += 1
        # dq=, dk=, dv= into slices of larger buffers (dv's misaligned)
        bufs = [torch.full((B + 1, H + 2, L, D), float("nan"), device=DEV,
                           dtype=dt) for _ in range(2)]
        flat_buf = torch.full(((B + 1) * (H + 2) * L * D + 1,), float("nan"),
                              device=DEV, dtype=dt)
        bufs.append(flat_buf[1:].view(B + 1, H + 2, L, D))
        outs = [b[1:, 1:H + 1] for b in bufs]
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, dq=outs[0],
                                         **kw),
               *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                           dk=outs[1], dv=outs[2], **kw))
        inside = torch.zeros(B + 1, H + 2, L, D, dtype=torch.bool,
                             device=DEV)
        inside[1:, 1:H + 1] = True
        flat = [t.contiguous() for t in (q, k, v, do)] + [lse, delta]
        want = (fa.flash_attention_bwd_dq(*flat, **kw),
                *fa.flash_attention_bwd_dkv(*flat, **kw))
        if not (all(a.data_ptr() == o.data_ptr() for a, o in zip(got, outs))
                and not fa._strided_ok(outs[2])
                and all(torch.equal(o, w) for o, w in zip(outs, want))
                and all(bool(b[~inside].isnan().all()) for b in bufs)):
            raise AssertionError("flash_attention_bwd dq=/dk=/dv= %s D %d %s "
                                 "wrote other than its slices"
                                 % (str(dt)[6:], D, kw))
        n += 1
    return n


# delta = sum_d dO * O against its plain version: the kernel adds each
# lane's rounded products in element order and the lanes' partials in a
# butterfly, torch in its own order.  Two fp32 sums of the same <= 128
# rounded products differ by at most ~D * 2**-24 of the row's sum of
# |products| (7.6e-6 at D 128); 1e-5 of that sum is allowed
TOL_DELTA = 1e-5


# (B, H, L) beside FLASH_SHAPES where the delta kernel's split has edges:
# fewer rows than a warp's pass at every D (3), rows no block's pass
# divides (1155, 15015, 222), and a grid of one or two blocks (3, 222)
DELTA_EDGE_SHAPES = ((1, 1, 3), (3, 5, 77), (5, 3, 1001), (2, 3, 37))


def check_flash_delta(torch, fa, timer, report):
    """The delta kernel against its plain version in float32 and bfloat16
    at D 32, 64 and 128 and the (B, H, L) of FLASH_SHAPES and
    DELTA_EDGE_SHAPES, each row's error over its sum of |dO O|; its
    results on BERT's transposed dO and per (dp 2, tp 2) shard where B
    and H split equal the whole contiguous call's bit for bit (its sum
    order depends on D and the dtype alone).  Timed at the training shape
    beside its plain version, its bound and, in fp32,
    ``torch.linalg.vecdot`` (the same function in one call)."""
    g = torch.Generator(device=DEV).manual_seed(18)
    worst, n = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        for B, H, L in FLASH_SHAPES + DELTA_EDGE_SHAPES:
            for D in FLASH_DIMS[str(dt)[6:]]:
                do, out = (torch.randn(B, H, L, D, device=DEV,
                                       generator=g).to(dt) for _ in range(2))
                n0 = fa.flash_attention.launches_delta
                got = fa.flash_attention_bwd_delta(do, out)
                if fa.flash_attention.launches_delta != n0 + 1:
                    raise AssertionError("flash_attention_bwd_delta did not "
                                         "launch its kernel")
                want = fa.flash_attention_bwd_delta_plain(do, out)
                row = (do.float() * out.float()).abs().sum(-1)
                err = float(((got - want).abs()
                             / row.clamp_min(1e-30)).max())
                worst = max(worst, err)
                n += 1
                # BERT's transposed dO, read where it lies
                dot = torch.empty(B, L, H, D, device=DEV,
                                  dtype=dt).transpose(1, 2)
                dot.copy_(do)
                same = [fa.flash_attention_bwd_delta(dot, out)]
                if B % 2 == 0 and H % 2 == 0:
                    b2, h2 = B // 2, H // 2
                    parts = [[fa.flash_attention_bwd_delta(
                        do[d * b2:(d + 1) * b2, t * h2:(t + 1) * h2],
                        out[d * b2:(d + 1) * b2, t * h2:(t + 1) * h2])
                        for t in range(2)] for d in range(2)]
                    same.append(torch.cat([torch.cat(r, dim=1)
                                           for r in parts], dim=0))
                if not all(torch.equal(t, got) for t in same):
                    raise AssertionError(
                        "flash_attention_bwd_delta (B %d, H %d, L %d, D %d) "
                        "%s: a view or the shards differ from the whole "
                        "contiguous call" % (B, H, L, D, str(dt)[6:]))
    log("flash_attention_bwd_delta: %d cases pass, worst error / the row's "
        "sum of |dO O| %.3g (tol %g); transposed dO and dp 2 x tp 2 shards "
        "bit for bit the whole call" % (n, worst, TOL_DELTA))
    if not worst <= TOL_DELTA:
        raise AssertionError("flash_attention_bwd_delta disagrees with its "
                             "plain version: %g" % worst)
    B, H, L, D = TRAIN_B, BERT["num_heads"], TRAIN_L, 64
    for dt in (torch.float32, torch.bfloat16):
        do, out = (torch.randn(B, H, L, D, device=DEV, generator=g).to(dt)
                   for _ in range(2))
        err = float((fa.flash_attention_bwd_delta(do, out)
                     - fa.flash_attention_bwd_delta_plain(do, out))
                    .abs().max())
        ms = timer(lambda: fa.flash_attention_bwd_delta(do, out),
                   spin=FLASH_SPIN)
        plain_ms = timer(lambda: fa.flash_attention_bwd_delta_plain(do, out),
                         spin=FLASH_SPIN)
        f32 = dt == torch.float32
        lib = (timer(lambda: torch.linalg.vecdot(do, out), spin=FLASH_SPIN)
               if f32 else None)
        # reads dO and O once, writes delta once; D products and sums a row
        bms, by = bound(2 * do.numel() * do.element_size() + B * H * L * 4,
                        2 * do.numel())
        log("flash_attention_bwd_delta (B %d, H %d, L %d, D %d) %s: max abs "
            "err %.3g; kernel %.4f ms plain %.4f ms bound %.4f ms (%s) %s"
            % (B, H, L, D, str(dt)[6:], err, ms, plain_ms, bms, by,
               "torch.linalg.vecdot %.4f ms" % lib if f32 else
               "(no single PyTorch call sums bf16 products in fp32)"))
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib, max_abs_err=err)
        if f32:
            report["flash_attention_bwd_delta"] = dict(
                name="flash_attention_bwd_delta", route="cuda",
                source="mxnet_tpu_torch/csrc/flash_attention.cu",
                replaces="mxnet_tpu/ops/pallas/flash_attention.py:466 (a jnp "
                "reduction, not a TPU kernel)", **row)
        else:
            report["flash_delta_bf16"] = row


def delta_bound(B, H, L, D, itemsize):
    """(ms, by) of the delta kernel: dO and O read once, delta written
    once; D products and sums a row."""
    return bound(2 * B * H * L * D * itemsize + B * H * L * 4,
                 2 * B * H * L * D)


def delta_timing(torch, fa, timer):
    """The delta kernel's times in fp32 and bf16 at the training shape
    (B 32, H 12, L 128) at D 32, 64 and 128 and at the long shape (B 4,
    L 2048, D 64), beside the bound and beside its time after a flush that
    leaves the L2 clean (``Timer(clean=True)``); then the flash backward of a
    BERT layer (the delta kernel, #6 and #7 at D 64, kv_length and dropout
    0.1) at the training shape in both dtypes.  ``chip_flash_ab.py
    --phases delta`` runs it; the smoke run does not."""
    g = torch.Generator(device=DEV).manual_seed(19)
    H = BERT["num_heads"]
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for B, L, D in ([(TRAIN_B, TRAIN_L, d) for d in (32, 64, 128)]
                        + [(LONG_B, LONG_L, 64)]):
            do, out = (torch.randn(B, H, L, D, device=DEV,
                                   generator=g).to(dt) for _ in range(2))
            ms = timer(lambda: fa.flash_attention_bwd_delta(do, out),
                       spin=FLASH_SPIN)
            clean = timer(lambda: fa.flash_attention_bwd_delta(do, out),
                          spin=FLASH_SPIN, clean=True)
            bms, by = delta_bound(B, H, L, D, do.element_size())
            log("delta timing (B %d, H %d, L %d, D %d) %s: kernel %.4f ms "
                "(after a read flush, the L2 clean: %.4f ms) bound %.4f ms "
                "(%s)" % (B, H, L, D, name, ms, clean, bms, by))
        B, L, D = TRAIN_B, TRAIN_L, 64
        q, k, v, do = (torch.randn(B, H, L, D, device=DEV,
                                   generator=g).to(dt) for _ in range(4))
        kvl = pretrain_batch(torch, 0, B, L, DEV)["valid"].to(torch.int32)
        seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=DEV,
                             generator=g)
        kw = dict(dropout=0.1, seed=seed, kv_length=kvl)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)

        def backward():
            delta = fa.flash_attention_bwd_delta(do, out)
            fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)

        log("flash backward timing (B %d, H %d, L %d, D %d, kv_length, rate "
            "0.1) %s: delta + #6 + #7 %.4f ms"
            % (B, H, L, D, name, timer(backward, spin=2 * FLASH_SPIN)))


def check_flash_attention(torch, timer, report):
    """Kernels #5-#7 against the plain version and autograd through it, in
    float32 and bfloat16 at D 32, 64 and 128, at (B, H, L)
    of the training shape (BH 384), the long-context shape (BH 48) and a
    ragged L 200, with no mask, causal, a window of 32 and kv_length with
    a row of length 0 (and one of length 1 where B > 2), at dropout 0 and
    0.1; then the mask exactly, and
    the times at the training shape (and the long one in bf16)."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator(device=DEV).manual_seed(11)
    worst = {}
    n = n32 = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, H, L in FLASH_SHAPES:
            for D in FLASH_DIMS[str(dt)[6:]]:
                for mask in ("none", "causal", "window", "kv_length"):
                    for rate in (0.0, 0.1):
                        errs = flash_case(torch, fa, g, B, H, L, D, dt, mask,
                                          rate)
                        n += 1
                        n32 += dt == torch.float32
                        key = str(dt)[6:]
                        for name, e in errs.items():
                            w = worst.setdefault(key, {})
                            w[name] = max(w.get(name, 0.0), e)
        torch.cuda.empty_cache()
    log("flash attention: %d cases pass; worst error / largest element %s "
        "(tol fp32 %g, fp32 out/dq/dk/dv %g, bf16 %g, bf16 vs autograd %g)"
        % (n, json.dumps(worst), TOL_FLASH_F32, TOL_FLASH_3XTF32,
           TOL_FLASH_BF16, TOL_FLASH_GRAD_BF16))
    log("flash_attention_fwd float32 (3xTF32): worst out error / largest "
        "element %.3g over %d cases (tol %g)"
        % (worst["float32"]["out"], n32, TOL_FLASH_3XTF32))
    # a negative scale: the kernels take their running max over -S
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 6, 200, 64, device=DEV, generator=g).to(dt)
                   for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=-0.125)
        pout, plse = fa.flash_attention_plain(q, k, v, causal=True,
                                              scale=-0.125)
        tol = TOL_FLASH_F32 if dt == torch.float32 else TOL_FLASH_BF16
        err = max(rel_err(out, pout), float((lse - plse).abs().max()))
        log("flash_attention_fwd scale -0.125 %s: max err %.3g (tol %g)"
            % (str(dt)[6:], err, tol))
        if not err <= tol:
            raise AssertionError("flash_attention_fwd with a negative scale "
                                 "disagrees: %g" % err)
    check_flash_mask(torch, fa)
    check_flash_strided(torch, fa)
    check_flash_delta(torch, fa, timer, report)
    flash_timing(torch, fa, timer, torch.float32, report)
    report["flash_bf16"] = flash_timing(torch, fa, timer, torch.bfloat16,
                                        report)
    report["flash_bf16_long"] = flash_timing(torch, fa, timer,
                                             torch.bfloat16, report,
                                             B=LONG_B, L=LONG_L)


# the LSTM kernels #10 and #11 against their plain versions on the card.
# fp32: the kernels sum each gate's H products in another order than the
# plain version's cuBLAS (#10: 8 warp slices; #11: the recompute's 3xTF32
# tensor-core products, ~2^-21 relative each, and the dh partial sums per
# block of units), over up to 400 steps whose carries feed back: ~1e-6 on
# h and c of order 1 (the first runs read <= 5e-7); these allow 100x that,
# absolute on h, c and the recomputed activations, relative to the largest
# element on the gradients.  A single-TF32 recompute (~2e-4 on dgx) fails
# them (``tests/test_torch_lstm_blocked.py``).  bf16: both compute in fp32
# and round h, dgx, dh0 and dc0 to bf16 at the end, so fp32 results a few
# ulps apart can round to neighbouring bf16 values: one bf16 step of the
# plain value, and 1e-4 of the largest element beyond it.  Against autograd
# through the plain forward in bf16: the backward recomputes the gates from
# the bf16-rounded h_prev (as the JAX backward does, fused_cell.py:287)
# where autograd differentiates the fp32 carries, a 2**-9 relative change
# in every recurrent product: 2**-5 of the largest element.
TOL_LSTM = 1e-4
TOL_LSTM_GRAD_BF16 = 2.0 ** -5
#: the spin (cycles, ~0.5 ms) before each timed launch of #11 and its
#: yardsticks, so that the host has enqueued the wrapper's work before
#: the card reaches it
LSTM_BWD_SPIN = 1_000_000
#: (T, B, H) of the LSTM checks: the word LM's layer, a ragged H with a
#: batch below one warp, one sequence, a batch over two 32-row passes, one
#: step, and 400 steps (133 MB of fp32 activations, over the 50 MB L2)
LSTM_SHAPES = ((35, 32, 650), (7, 5, 37), (35, 1, 650), (35, 64, 650),
               (1, 32, 650), (400, 32, 650))


def lstm_inputs(torch, g, T, B, H, dt, zero_state, w_dt=None):
    """gx, h0, c0, W (a transposed view of w_h2h, as the layer passes it),
    b of the LSTM checks, in ``dt`` (W and b in ``w_dt`` when given)."""
    w_dt = w_dt or dt
    gx = torch.randn(T, B, 4 * H, device=DEV, generator=g).to(dt)
    h0, c0 = ((torch.zeros(B, H, device=DEV) if zero_state else
               0.5 * torch.randn(B, H, device=DEV, generator=g)).to(dt)
              for _ in range(2))
    w = ((6.0 / (5 * H)) ** 0.5 * (torch.rand(4 * H, H, device=DEV,
                                              generator=g) * 2 - 1)).to(
        w_dt).T
    b = (0.1 * torch.randn(4 * H, device=DEV, generator=g)).to(w_dt)
    return gx, h0, c0, w, b


def lstm_case(torch, fc, g, T, B, H, dt, zero_state, w_dt=None):
    """#10 and #11 against the plain versions, #11's recompute kernel
    against its own, two launches of #10 and of #11 bit for bit, and #11
    (through
    the autograd Function) against autograd through the plain forward,
    with a loss over out and cT (dcseq zero except at T-1).  Returns the
    worst errors."""
    gx, h0, c0, w, b = lstm_inputs(torch, g, T, B, H, dt, zero_state, w_dt)
    out, cseq = fc._lstm_fwd(gx, h0, c0, w, b)
    if not all(torch.equal(x, y) for x, y in zip(
            (out, cseq), fc._lstm_fwd(gx, h0, c0, w, b))):
        raise AssertionError("lstm_sequence T %d B %d H %d %s: two launches "
                             "of #10 differ" % (T, B, H, str(dt)[6:]))
    pout, pcseq = fc.lstm_sequence_plain(gx, h0, c0, w, b)
    f32 = dt == torch.float32
    errs = {"out": (float((out - pout).abs().max()) if f32
                    else within_bf16_step(out, pout)),
            "cseq": float((cseq - pcseq).abs().max())}
    hp = torch.cat([h0[None], out[:-1]])
    cp = torch.cat([c0[None].float(), cseq[:-1]])
    dout = torch.randn(T, B, H, device=DEV, generator=g).to(dt)
    dcs = torch.zeros(T, B, H, device=DEV)
    dcs[-1] = torch.randn(B, H, device=DEV, generator=g)
    kern = fc._lstm_bwd(gx, hp, cp, cseq, dout, dcs, w, b)
    again = fc._lstm_bwd(gx, hp, cp, cseq, dout, dcs, w, b)
    if not all(torch.equal(x, y) for x, y in zip(kern, again)):
        raise AssertionError("lstm_sequence T %d B %d H %d %s: two launches "
                             "of #11 differ" % (T, B, H, str(dt)[6:]))
    gates, _, _, (rec, units) = fc._lstm_bwd_parts(gx, hp, cp, cseq, dout,
                                                   dcs, w, b)
    gates()
    errs["gates"] = float((fc.lstm_record_gates(rec, T, B, H, units)
                           - fc.lstm_bwd_gates_plain(gx, hp, w, b))
                          .abs().max())
    plain = fc.lstm_sequence_backward_plain(gx, hp, cp, cseq, dout, dcs, w,
                                            b)
    for name, k, p in zip(("dgx", "dh0", "dc0"), kern, plain):
        errs[name] = (rel_err(k, p) if f32 else within_bf16_step(k, p)
                      / max(float(p.float().abs().max()), 1e-30))
    # the Function's gradients (kernels) against autograd through the plain
    # forward, for loss = <out, dout> + <cT, dcs[-1]>
    grads = []
    for fwd in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in
                  (gx, h0, c0, w, b)]
        if fwd == "kernel":
            o, _, cT = fc.lstm_sequence(*leaves)
            cT = cT.float()
        else:
            o, cs = fc.lstm_sequence_plain(*leaves)
            cT = cs[-1]
        loss = (o.float() * dout.float()).sum() + (cT * dcs[-1]).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    errs["autograd"] = max(rel_err(a, p) for a, p in zip(*grads))
    tol_ag = TOL_LSTM if f32 else TOL_LSTM_GRAD_BF16
    bad = [n for n, e in errs.items()
           if not e <= (tol_ag if n == "autograd" else TOL_LSTM)]
    if bad:
        raise AssertionError("lstm_sequence T %d B %d H %d %s (W %s) %s "
                             "state: %s beyond tolerance: %s"
                             % (T, B, H, str(dt)[6:], str(w.dtype)[6:],
                                "zero" if zero_state else "random", bad,
                                errs))
    return errs


def product_time(flops, a_e, b_e):
    """Seconds the card needs at least for ``flops`` of fp32-accurate
    products of operands of ``a_e`` and ``b_e`` bytes: bf16 x bf16 at the
    bf16 rate (exact in fp32); otherwise 3xTF32 at the TF32 rate, less the
    residual product of a bf16 operand, which is exact in tf32 (an fp32 x
    bf16 product takes two tf32 products)."""
    if a_e == b_e == 2:
        return flops / BF16_FLOPS
    return (1 + (a_e == 4) + (b_e == 4)) * flops / TF32_FLOPS


def lstm_bounds(T, B, H, e, w_e=None):
    """(bound ms, by) of #10, of #11 (both launches) and of #11's
    recompute, for the layer's elements of ``e`` bytes and W's of ``w_e``
    (``e`` when None): each input read and each output written once (the
    recompute writes the activations, T B 4H fp32); the recurrent products
    (2 T B H 4H each) at ``product_time``'s rates: #10's take the fp32
    carry h and W, #11's recompute h_prev (the layer's type) and W, #11's
    dh products the fp32 dg and W."""
    w_e = w_e or e
    G = 4 * H
    flops = 2 * T * B * H * G
    carry = product_time(flops, 4, w_e)
    rec = product_time(flops, e, w_e)
    wb = w_e * (H * G + G)
    fwd_bytes = e * (T * B * G + T * B * H + 2 * B * H) + wb + 4 * T * B * H
    bwd_bytes = e * (2 * T * B * G + 2 * T * B * H + 2 * B * H) + wb \
        + 4 * 3 * T * B * H
    gates_bytes = e * (T * B * G + T * B * H) + wb + 4 * T * B * G
    return (bound_time(fwd_bytes, carry), bound_time(bwd_bytes, rec + carry),
            bound_time(gates_bytes, rec))


def lstm_stamps(torch, fc, timer, bwd, T, runs=5):
    """The backward's phases by ``%globaltimer`` (``fused_cell.
    lstm_bwd_phase_times``: the time loop's block 0 and the recompute's
    first block), each launch after the L2 flush:
    per phase the median over ``runs`` launches of its sum over the T
    steps, in µs.  Printed and returned; then the serial chain's floor, T
    times the stamped barrier and exchange (the dh sum) a step."""
    totals = []
    for _ in range(runs + 1):
        timer.flush.zero_()
        totals.append(fc.lstm_bwd_phase_times(*bwd)[0])
    med = {p: statistics.median(t[p] for t in totals[1:])
           for p in totals[0]}
    loop = {p: med[p] for p in fc.LSTM_BWD_PHASES}
    dt = str(bwd[0].dtype)[6:]
    log("lstm_sequence_bwd %s phases by %%globaltimer (block 0, median of "
        "%d launches, T %d): %s; per step %s; sum %.2f us per step"
        % (dt, runs, T, " ".join("%s %.2f us" % kv for kv in loop.items()),
           " ".join("%s %.3f" % (p, v / T) for p, v in loop.items()),
           sum(loop.values()) / T))
    gates = {p: v for p, v in med.items() if p not in loop}
    if gates:
        log("lstm_sequence_bwd %s recompute's first block by %%globaltimer: "
            "%s" % (dt, " ".join("%s %.2f us" % kv for kv in gates.items())))
    if "dh_sum" in med:
        log("lstm_sequence_bwd %s serial chain floor: T x (barrier + dh "
            "sum) = %.4f ms" % (dt, (med["barrier"] + med["dh_sum"]) / 1e3))
    return med


#: #10's plans timed beside the one it takes: (units per block, batch
#: lanes); one lane of the fewest units at the word LM's layer
LSTM_FWD_PLANS = ((5, 1),)


def lstm_fwd_plans(torch, fc, timer, fwd, plans=LSTM_FWD_PLANS):
    """#10 on ``fwd`` (the arguments of ``_lstm_fwd``) under each of
    ``plans`` that fits the card: its time, phases by
    ``%globaltimer``, error against the plain version (bf16: beyond one
    bf16 step), two launches bit-equal, digest.  A tree whose plan takes
    no units prints nothing."""
    if not hasattr(fc, "LstmPlan"):
        return
    gx = fwd[0]
    T, B, H = gx.shape[0], gx.shape[1], gx.shape[2] // 4
    pout, pcseq = fc.lstm_sequence_plain(*fwd)
    for u, lanes in plans:
        try:
            p = fc.lstm_plan(H, B, gx.dtype, units=u, lanes=lanes)
        except RuntimeError:
            log("lstm_sequence_fwd U %d, %d lanes: does not fit" % (u, lanes))
            continue
        out, cseq = fc._lstm_fwd(*fwd, plan=p)
        again = fc._lstm_fwd(*fwd, plan=p)
        same = torch.equal(out, again[0]) and torch.equal(cseq, again[1])
        err = max(float((out.float() - pout.float()).abs().max())
                  if gx.dtype == torch.float32 else within_bf16_step(out, pout),
                  float((cseq - pcseq).abs().max()))
        ms = timer(lambda: fc._lstm_fwd(*fwd, plan=p))
        ph = [fc.lstm_fwd_phase_times(*fwd, plan=p)[0] for _ in range(4)]
        med = {k: statistics.median(x[k] for x in ph[1:]) / T
               for k in fc.LSTM_FWD_PHASES}
        log("lstm_sequence_fwd %s plan %s: %.4f ms (%.2f us per step), "
            "max err %.3g (tol %g), two launches equal %s, digest %s; per "
            "step %s" % (str(gx.dtype)[6:], tuple(p), ms, ms / T * 1e3, err,
                         TOL_LSTM, same, digest(torch, out, cseq),
                         " ".join("%s %.3f" % kv for kv in med.items())))
        if not (err <= TOL_LSTM and same):
            raise AssertionError("lstm_sequence_fwd plan %s disagrees" % (p,))


def lstm_fwd_stamps(torch, fc, timer, fwd, T, runs=5):
    """The forward's phases by ``%globaltimer`` (``fused_cell.
    lstm_fwd_phase_times``, block 0), each launch after the L2 flush: per
    phase the median over ``runs`` launches of its sum over the T steps,
    in µs.  Printed and returned."""
    totals = []
    for _ in range(runs + 1):
        timer.flush.zero_()
        totals.append(fc.lstm_fwd_phase_times(*fwd)[0])
    med = {p: statistics.median(t[p] for t in totals[1:])
           for p in totals[0]}
    steps = {p: med[p] for p in fc.LSTM_FWD_PHASES}
    log("lstm_sequence_fwd %s phases by %%globaltimer (block 0, median of "
        "%d launches, T %d): %s; per step %s; sum %.2f us per step%s"
        % (str(fwd[0].dtype)[6:], runs, T,
           " ".join("%s %.2f us" % kv for kv in steps.items()),
           " ".join("%s %.3f" % (p, v / T) for p, v in steps.items()),
           sum(steps.values()) / T,
           "; set-up %.2f us (W's columns %.2f)" % (med["setup"],
                                                    med["w_columns"])
           if "setup" in med else ""))
    return med


def digest(torch, *tensors):
    """The first 16 hex digits of sha256 over the tensors' bytes (as
    fp32): equal digests in two runs mean equal results bit for bit."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def lstm_timing(torch, fc, timer, dt):
    """#10 and #11 at the word LM's layer shape (T 35, B 32, H 650) beside
    their plain versions, their bounds, and cuDNN's LSTM (one layer of the
    same weights, forward, and its backward through autograd), which also
    runs its own i2h GEMM: beside it stand #10 plus the i2h product, and
    #11 plus the products around it (the i2h backward and dW).  #11's two
    kernels, the recompute and the time loop, also apart, #10's phases
    and #11's time loop's by their stamps; the digests of #10's outputs and of
    #11's, to hold two trees' results bit for bit."""
    T, B, H = 35, 32, 650
    g = torch.Generator(device=DEV).manual_seed(14)
    gx, h0, c0, w, b = lstm_inputs(torch, g, T, B, H, dt, False)
    x = torch.randn(T, B, H, device=DEV, generator=g).to(dt)
    w_i2h = (0.05 * torch.randn(4 * H, H, device=DEV, generator=g)).to(dt)
    out, cseq = fc._lstm_fwd(gx, h0, c0, w, b)
    hp = torch.cat([h0[None], out[:-1]])
    cp = torch.cat([c0[None].float(), cseq[:-1]])
    dout = torch.randn(T, B, H, device=DEV, generator=g).to(dt)
    dcs = torch.zeros(T, B, H, device=DEV)
    dcs[-1] = torch.randn(B, H, device=DEV, generator=g)
    bwd = (gx, hp, cp, cseq, dout, dcs, w, b)
    log("lstm_sequence (T %d, B %d, H %d) %s digests: #10 out, cseq %s; #11 "
        "dgx, dh0, dc0 %s" % (T, B, H, str(dt)[6:], digest(torch, out, cseq),
                              digest(torch, *fc._lstm_bwd(*bwd))))
    # the backward's wrappers enqueue more than the default spin covers
    spin = LSTM_BWD_SPIN
    ms = {"fwd": timer(lambda: fc._lstm_fwd(gx, h0, c0, w, b)),
          "bwd": timer(lambda: fc._lstm_bwd(*bwd), spin=spin)}
    plain = {"fwd": timer(lambda: fc.lstm_sequence_plain(gx, h0, c0, w, b),
                          iters=5),
             "bwd": timer(lambda: fc.lstm_sequence_backward_plain(*bwd),
                          iters=5)}
    gates, loop, _, _ = fc._lstm_bwd_parts(*bwd)
    gates()
    parts = {"gates": timer(gates, spin=spin),
             "loop": timer(loop, spin=spin),
             "plain_gates": timer(lambda: fc.lstm_bwd_gates_plain(
                 gx, hp, w, b), spin=spin)}
    with_i2h = timer(lambda: fc._lstm_fwd(torch.matmul(x, w_i2h.T) + b, h0,
                                          c0, w, b))

    def bwd_with_products():
        dgx, _, _ = fc._lstm_bwd(*bwd)
        dg = dgx.reshape(T * B, 4 * H)
        torch.matmul(dg, w_i2h)                       # dx
        torch.matmul(hp.reshape(T * B, H).T, dg)      # dW_h2h
        torch.matmul(x.reshape(T * B, H).T, dg)       # dW_i2h

    bwd_products = timer(bwd_with_products, spin=spin)
    fwd_stamps = lstm_fwd_stamps(torch, fc, timer, (gx, h0, c0, w, b), T)
    log("lstm_sequence_fwd (T %d, B %d, H %d) %s plan: %s"
        % (T, B, H, str(dt)[6:], fc.lstm_plan(H, B, dt)))
    lstm_fwd_plans(torch, fc, timer, (gx, h0, c0, w, b))
    stamps = lstm_stamps(torch, fc, timer, bwd, T)
    cudnn = torch.nn.LSTM(H, H).to(DEV, dt)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_i2h)
        cudnn.weight_hh_l0.copy_(w.T)
        cudnn.bias_ih_l0.copy_(b)      # b is both b_i2h and b_h2h here
        cudnn.bias_hh_l0.copy_(b)
    state = (h0[None].contiguous(), c0[None].contiguous())
    with torch.no_grad():
        lib_out, _ = cudnn(x, state)
    ref, _ = fc._lstm_fwd(torch.matmul(x, w_i2h.T) + b, h0, c0, w, b)
    same = float((lib_out.float() - ref.float()).abs().max())
    lib_fwd = timer(lambda: cudnn(x, state))
    xl = x.detach().clone().requires_grad_()
    lo, _ = cudnn(xl, state)
    leaves = [xl] + list(cudnn.parameters())
    lib_bwd = timer(lambda: torch.autograd.grad(lo, leaves, dout,
                                                retain_graph=True),
                    spin=4_000_000)
    (bf, byf), (bb, byb), (bg, byg) = lstm_bounds(T, B, H, gx.element_size())
    rows = {}
    for key, k_ms, lib, bms, by, extra in (
            ("lstm_sequence_fwd", ms["fwd"], lib_fwd, bf, byf,
             "with the i2h product %.4f ms" % with_i2h),
            ("lstm_sequence_bwd", ms["bwd"], lib_bwd, bb, byb,
             "with the dx and dW products %.4f ms" % bwd_products)):
        kind = key[-3:]
        log("%s (T %d, B %d, H %d) %s: kernel %.4f ms (%.2f us per step; %s) "
            "plain %.4f ms bound %.4f ms (%s); cuDNN LSTM %s %.4f ms (its own "
            "i2h GEMM included)" % (key, T, B, H, str(dt)[6:], k_ms,
                                    k_ms / T * 1e3, extra, plain[kind], bms,
                                    by, "forward" if kind == "fwd" else
                                    "backward (autograd: dx, dh0, dc0, dW)",
                                    lib))
        rows[key] = dict(ms=k_ms, plain_ms=plain[kind], bound_ms=bms,
                         bound_by=by, library_ms=lib, us_per_step=k_ms / T
                         * 1e3)
    rows["lstm_sequence_fwd"]["with_i2h_ms"] = with_i2h
    rows["lstm_sequence_fwd"]["phase_us"] = fwd_stamps
    rows["lstm_sequence_bwd"]["with_products_ms"] = bwd_products
    rows["lstm_sequence_bwd"]["phase_us"] = stamps
    log("lstm_sequence_bwd (T %d, B %d, H %d) %s apart: recompute %.4f ms "
        "(bound %.4f ms, %s; plain %.4f ms), time loop %.4f ms (%.2f us per "
        "step); both in one call %.4f ms"
        % (T, B, H, str(dt)[6:], parts["gates"], bg, byg,
           parts["plain_gates"], parts["loop"], parts["loop"] / T * 1e3,
           ms["bwd"]))
    rows["lstm_sequence_bwd"]["loop_ms"] = parts["loop"]
    rows["lstm_sequence_bwd_gates"] = dict(
        ms=parts["gates"], plain_ms=parts["plain_gates"], bound_ms=bg,
        bound_by=byg, library_ms=None)
    log("cuDNN LSTM output vs #10 + i2h on the same weights (%s): max abs "
        "diff %.3g (the yardstick computes the same function)"
        % (str(dt)[6:], same))
    return rows


def check_lstm(torch, timer, report):
    """Kernels #10 and #11 at every (T, B, H) of ``LSTM_SHAPES``, float32
    and bfloat16, with h0/c0 zero and random, and a bfloat16 layer with a
    float32 W (the recompute's two-product path) at the first two: the
    forward and backward against the plain versions, #11's recompute
    kernel against its own, two launches of #11 bit for bit, and the
    gradients of the autograd Function against autograd through the plain
    forward; then the times at the word LM's shape in float32 and
    bfloat16."""
    from mxnet_tpu_torch.ops.kernels import fused_cell as fc
    g = torch.Generator(device=DEV).manual_seed(13)
    cases = [(dt, None, shape) for dt in (torch.float32, torch.bfloat16)
             for shape in LSTM_SHAPES]
    cases += [(torch.bfloat16, torch.float32, shape)
              for shape in LSTM_SHAPES[:2]]
    worst, n = {}, 0
    for dt, w_dt, (T, B, H) in cases:
        for zero_state in (True, False):
            errs = lstm_case(torch, fc, g, T, B, H, dt, zero_state, w_dt)
            n += 1
            w = worst.setdefault(str(dt)[6:] + ("" if w_dt is None else
                                                " (W float32)"), {})
            for k, e in errs.items():
                w[k] = max(w.get(k, 0.0), e)
    plan = fc.lstm_plan(650, 32), fc.lstm_plan(650, 32, backward=True)
    log("lstm_sequence: %d cases pass, #10 and #11 bit for bit across two "
        "launches "
        "in each; worst errors %s (tol %g; bf16: beyond one bf16 step, and "
        "%g against autograd); (units per block, blocks, shared bytes) at "
        "H 650, B 32: forward %s, backward %s"
        % (n, json.dumps(worst), TOL_LSTM, TOL_LSTM_GRAD_BF16, plan[0],
           plan[1]))
    rows = lstm_timing(torch, fc, timer, torch.float32)
    f32 = worst["float32"]
    for key, line, err in (
            ("lstm_sequence_fwd", 142, f32["out"]),
            ("lstm_sequence_bwd", 195, max(f32[k] for k in ("dgx", "dh0",
                                                            "dc0"))),
            ("lstm_sequence_bwd_gates", 195, f32["gates"])):
        report[key] = dict(
            name=key, route="cuda", source="mxnet_tpu_torch/csrc/lstm.cu",
            replaces="mxnet_tpu/ops/pallas/fused_cell.py:%d" % line,
            max_abs_err=err, **{k: rows[key][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    report["lstm_fp32"] = rows
    report["lstm_bf16"] = lstm_timing(torch, fc, timer, torch.bfloat16)


def check_lstm_sass(libs):
    """#11's recompute kernel issues tensor-core products, wgmma in bf16
    (HGMMA ... BF16) and in tf32 (HGMMA ... TF32) in its float
    instantiations; #10's time loops issue mma.sync tf32 (HMMA ... TF32);
    no kernel holds an atomic."""
    census = sass_census(libs["lstm"], "lstm_", full=True)
    bad, gates, loops, fwd = [], 0, 0, 0
    for fn, ops in sorted(census.items()):
        parts = {op: op.split(".") for op in ops}
        tc = {kind: sum(n for op, n in ops.items() if parts[op][0] == kind
                        and ("TF32" in parts[op] or "BF16" in parts[op]))
              for kind in ("HGMMA", "HMMA")}
        atomics = sum(n for op, n in ops.items()
                      if parts[op][0] in ATOMIC_OPS)
        ok = True
        if "lstm_bwd_gates_kernel" in fn:
            gates += 1
            want = "TF32" if "gates_kernelIf" in fn else "BF16"
            ok = any(parts[op][0] == "HGMMA" and want in parts[op]
                     for op in ops)
        elif "lstm_fwd_kernel" in fn:
            fwd += 1
            ok = any(parts[op][0] == "HMMA" and "TF32" in parts[op]
                     for op in ops)
        else:
            loops += 1
        log("SASS %s: tensor-core %s, atomics %d" % (fn[-60:], tc, atomics))
        if not ok or atomics:
            bad.append(fn)
    # the recompute in bf16 and four tf32 ones (which operands take their
    # residual product, the layer's type); the backward's time loops for 2
    # types x U 1..8, the forward's for 2 types x U 1..10
    if gates != 5 or loops != 16 or fwd != 20 or bad:
        raise AssertionError("lstm SASS: %d recompute, %d backward and %d "
                             "forward time-loop kernels; without their "
                             "tensor-core products or with atomics: %s"
                             % (gates, loops, fwd, bad))


# ---------------------------------------------------------------------------
# tensor-parallel decode phases (#13, #14) and the sharded causal route (#16)
# ---------------------------------------------------------------------------
# the phase kernels against their plain versions: one layer of one shard in
# fp32, the GEMVs adding their products in another order than cuBLAS (K
# split over up to 8 slices, warp sums) and attention in the online form
# against the plain two-pass softmax over <= 512 keys (TOL_ATTENTION):
# ~1e-6 on outputs and pages of order 1; 100x that allowed, 10x tighter
# than #12's 12 layers
TOL_PHASE = 1e-4
TP_DEGREES = (2, 4)
#: the mesh of the sharded-attention checks and path: batch over dp,
#: heads over tp
SHARDED_MESH = (2, 2)
#: launches of #5, #6, #7 and the delta kernel per call of the #16 route
#: (one flash call over the whole tensors), and the route's own count of
#: the #5 launches it made
ROUTE_LAUNCHES = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                  "flash_attention_bwd_dkv": 1,
                  "flash_attention_bwd_delta": 1,
                  "flash_attention_sharded_causal": 1}


def tp_sharding(tp, dp=1):
    from mxnet_tpu_torch.parallel import ShardingConfig
    return ShardingConfig.for_transformer(mesh_shape=(dp, tp),
                                          axis_names=("dp", "tp"))


def phase_bounds(cfg, lcfg, after, pps):
    """Bounds of #13 and #14 for one shard at these lengths (after the
    append): each weight, input and output once, the KV of the tokens the
    rows had before this step read once and the appended rows written
    once; 2 flops per weight and row, 4 per (head, key, dim)."""
    B, C, D = len(after), cfg.units, cfg.head_dim
    Cl, KVCl = lcfg.num_heads * D, lcfg.num_kv_heads * D
    Fl = lcfg.hidden_size
    live = int((after > 0).sum())
    toks = int(after.sum())
    w_attn = C * (2 * Cl + 2 * KVCl) + Cl + 2 * KVCl
    attn = bound(4 * (w_attn + 2 * (toks - live) * KVCl + 2 * live * KVCl
                      + 2 * B * C + 4 * B + B * pps),
                 2 * B * (w_attn - Cl - 2 * KVCl) + 4 * Cl * toks)
    ffn = bound(4 * (2 * C * Fl + Fl + 2 * B * C), 4 * B * C * Fl)
    return attn, ffn


#: the held cases of the decode phase check: (name, B, lengths after the
#: append or None for random 1..512 with row 0 at 512 and row 7 at 0).
#: "boundary" puts rows on each side of the split attention's 64-key
#: chunks; "all512" is the worst case, every row at the longest length
TP_CASES = (("mixed", SLOTS, None),
            ("boundary", SLOTS, (1, 63, 64, 65, 127, 128, 129, 0, 191, 192,
                                 193, 255, 256, 257, 511, 512)),
            ("all512", SLOTS, (512,) * SLOTS), ("one", 1, None))
#: the cases timed, with their stamps
TP_TIMED = ("mixed", "all512")


def phase_stamps(torch, timer, times, args, runs=5):
    """A phase kernel's phases by ``%globaltimer`` (``times`` is
    ``fused_cell.decode_attn_phase_times`` or ``decode_ffn_phase_times``:
    block 0, the end of each phase), each launch after the L2 flush: per
    phase the median over ``runs`` launches, in us."""
    stamps = []
    for _ in range(runs + 1):
        timer.flush.zero_()
        stamps.append(times(*args))
    return {p: statistics.median(t[p] for t in stamps[1:]) / 1e3
            for p in stamps[0]}


def check_tp_phases(torch, timer, report, lm, lm_gqa):
    """#13 and #14 against their plain versions on every shard of one layer
    at tp 2 and 4 of the full-width model and at tp 2 of the GQA model (12
    heads over 4 KV heads: 2 KV heads per shard), in the cases of
    TP_CASES: B 16 with mixed lengths 1..512 (one row of 512, one of 0),
    with lengths on each side of the 64-key chunks, with every row at 512,
    and B 1 (length 512); pages and partial products held, and digests of
    the outputs on shard 0 of tp 2 with mixed lengths (equal digests in two
    trees: the same bits).  Times at B 16 on shard 0 of the full-width
    model, #13 at mixed lengths and all at 512 (the worst case), #14 at
    mixed lengths, each with its phases by ``%globaltimer``."""
    from mxnet_tpu_torch.models import decoder as dec
    from mxnet_tpu_torch.ops.kernels import fused_cell as fc
    P, pps = SLOTS * 32 + 1, 32
    rows = {}
    for model, tp in ((lm, 2), (lm, 4), (lm_gqa, 2)):
        cfg = model.config
        plan = dec.tp_plan(cfg, tp_sharding(tp))
        lcfg = plan.local_cfg
        shards = plan.shard_params(model.params())
        for case, B, fixed in TP_CASES:
            rng = np.random.default_rng(13 + B)
            after = rng.integers(1, 513, B)   # lengths after this append
            after[0] = 512
            if B > 1:
                after[7] = 0                  # inactive row
            if fixed is not None:
                after = np.array(fixed)
            tb_np = tables_for(rng, after, pps)
            pos = np.maximum(after - 1, 0)
            wp = np.where(after > 0, tb_np[np.arange(B), pos // PAGE], 0)
            ws = np.where(after > 0, pos % PAGE, 0)
            g = torch.Generator(device=DEV).manual_seed(14)
            shape = (1, cfg.num_kv_heads, P, PAGE, cfg.head_dim)
            kp0 = torch.randn(shape, device=DEV, generator=g) * 0.5
            vp0 = torch.randn(shape, device=DEV, generator=g) * 0.5
            x = torch.randn(B, cfg.units, device=DEV, generator=g)
            meta = torch.tensor(np.stack([wp, ws]), dtype=torch.int32,
                                device=DEV)
            tb = torch.tensor(tb_np, device=DEV)
            ln = torch.tensor(after, dtype=torch.int32, device=DEV)
            errs = {"o_part": 0.0, "pages": 0.0, "f_part": 0.0}
            for r in range(tp):
                lp = shards[r]["layers"][0]
                k1, v1, k2, v2 = (t.clone() for t in (kp0, vp0, kp0, vp0))
                _, _, ok = fc.decode_attn_phase(
                    x, plan.kv_view(k1, 0, r), plan.kv_view(v1, 0, r), lp,
                    meta, tb, ln, lcfg)
                _, _, op = fc.decode_attn_phase_plain(
                    x, plan.kv_view(k2, 0, r), plan.kv_view(v2, 0, r), lp,
                    meta, tb, ln, lcfg)
                fk = fc.decode_ffn_phase(x, lp["w1"], lp["b1"], lp["w2"])
                fp = fc.decode_ffn_phase_plain(x, lp["w1"], lp["b1"],
                                               lp["w2"])
                for b in np.flatnonzero(after == 0):
                    if bool(ok[b].any()):
                        raise AssertionError("decode_attn_phase: the "
                                             "length-0 row's partial is not "
                                             "zero")
                # page 0 is the scratch page every inactive row writes
                errs["o_part"] = max(errs["o_part"],
                                     float((ok - op).abs().max()))
                errs["pages"] = max(errs["pages"], float(max(
                    (k1[:, :, 1:] - k2[:, :, 1:]).abs().max(),
                    (v1[:, :, 1:] - v2[:, :, 1:]).abs().max())))
                errs["f_part"] = max(errs["f_part"],
                                     float((fk - fp).abs().max()))
                if (model, tp, case, r) == (lm, 2, "mixed", 0):
                    log("decode phases tp 2 B %d mixed, shard 0: digest of "
                        "o_part and pages %s, of f_part %s"
                        % (B, digest(torch, ok, k1, v1), digest(torch, fk)))
            log("decode phases tp %d (H %d KVH %d per shard) B %d %s lengths "
                "%d..%d, all %d shards: max_abs_err o_part %.3g pages %.3g "
                "f_part %.3g (tol %g)"
                % (tp, lcfg.num_heads, lcfg.num_kv_heads, B, case,
                   after.min(), after.max(), tp, errs["o_part"],
                   errs["pages"], errs["f_part"], TOL_PHASE))
            if not max(errs.values()) <= TOL_PHASE:
                raise AssertionError("a decode phase kernel disagrees with "
                                     "its plain version")
            if case not in TP_TIMED or model is not lm:
                continue
            lp = shards[0]["layers"][0]
            kv = (plan.kv_view(kp0, 0, 0), plan.kv_view(vp0, 0, 0))
            args = (x, *kv, lp, meta, tb, ln, lcfg)
            (ba, bya), (bf, byf) = phase_bounds(cfg, lcfg, after, pps)
            fargs = (x, lp["w1"], lp["b1"], lp["w2"])
            timed = [("decode_attn_phase",
                      lambda: fc.decode_attn_phase(*args),
                      lambda: fc.decode_attn_phase_plain(*args),
                      ba, bya, max(errs["o_part"], errs["pages"]),
                      fc.decode_attn_phase_times, args)]
            if case == "mixed":
                timed.append((
                    "decode_ffn_phase",
                    lambda: fc.decode_ffn_phase(*fargs),
                    lambda: fc.decode_ffn_phase_plain(*fargs),
                    bf, byf, errs["f_part"], fc.decode_ffn_phase_times,
                    fargs))
            for name, fn, plain, bms, by, err, times, targs in timed:
                ms = timer(fn)
                # the plain version's ~20 ops take longer to enqueue than
                # the usual spin: spin ~2 ms so the card's time is timed
                plain_ms = timer(plain, spin=4_000_000)
                log("%s tp %d B %d full width, %s lengths: kernel %.4f ms "
                    "plain %.4f ms bound %.4f ms (%s); %d blocks"
                    % (name, tp, B, case, ms, plain_ms, bms, by,
                       fc.phase_grid_blocks(lcfg)[name.endswith("ffn_phase")]))
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, max_abs_err=err)
                row["stamps_us"] = phase_stamps(torch, timer, times, targs)
                log("%s tp %d B %d %s lengths, phases by %%globaltimer "
                    "(block 0, median of 5 launches): %s; sum %.2f us"
                    % (name, tp, B, case, " ".join(
                        "%s %.2f us" % kv for kv in row["stamps_us"].items()),
                       sum(row["stamps_us"].values())))
                key = "tp%d" % tp if case == "mixed" else "tp%d_%s" % (tp,
                                                                       case)
                rows.setdefault(name, {})[key] = row
    # #14 at B 16 and 20 (two passes of 16 rows) on shard 0 of tp 2, and on
    # a whole layer's FFN (tp 1's widths), whose units are too large for
    # the shared-memory budget and stream their weight rows
    plan = dec.tp_plan(lm.config, tp_sharding(2))
    g = torch.Generator(device=DEV).manual_seed(15)
    for label, lp in (("tp 2 shard 0",
                       plan.shard_params(lm.params())[0]["layers"][0]),
                      ("whole layer", lm.params()["layers"][0])):
        for B in (16, 20):
            x = torch.randn(B, lm.config.units, device=DEV, generator=g)
            fargs = (x, lp["w1"], lp["b1"], lp["w2"])
            err = float((fc.decode_ffn_phase(*fargs)
                         - fc.decode_ffn_phase_plain(*fargs)).abs().max())
            log("decode_ffn_phase %s (FFN width %d) B %d: max_abs_err %.3g "
                "(tol %g)" % (label, lp["w1"].shape[0], B, err, TOL_PHASE))
            if not err <= TOL_PHASE:
                raise AssertionError("decode_ffn_phase disagrees with its "
                                     "plain version")
    for name, line in (("decode_attn_phase", 509), ("decode_ffn_phase", 617)):
        report[name] = dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/csrc/decode_phase.cu",
            replaces="mxnet_tpu/ops/pallas/fused_cell.py:%d" % line,
            library_ms=None, **{k: v for k, v in rows[name]["tp2"].items()
                                if k != "stamps_us"})
    report["tp_phases"] = rows


def decode_instance(D, name):
    """The instance of kernel ``name`` that serves head dim D: for #12 and
    #15 its own (D a compile-time constant) at a multiple of 16 up to 128,
    else its class's (``csrc/decode_common.cuh:split_class``, D a runtime
    value); #13 (``decode_attn_phase``) runs every D on its class's."""
    if D % 16 == 0 and D <= 128 and name != "decode_attn_phase":
        return "own"
    return "class %d" % next(c for c in (32, 64, 128, 256) if D <= c)


def decode_dim_geometry(D):
    """(units, heads, KV heads) of the 2-layer model ``check_decode_dims``
    holds head dim ``D`` at: the most heads of D that fit 768 units, an
    even count, over the largest GQA group of 4, 3, 2 or 1 that leaves an
    even count of KV heads (tp 2 cuts both)."""
    H = 768 // D
    H -= H % 2
    g = next(g for g in (4, 3, 2, 1) if H % g == 0 and (H // g) % 2 == 0)
    return H * D, H, H // g


#: every head dim the decode kernels #12, #13 and #15 take (each multiple
#: of 8 in [8, 256]: its own instance, or its class's), and the (units,
#: heads, KV heads) of the 2-layer model
#: check_decode_dims holds them at: units at most 768 and a multiple of D,
#: GQA groups of 1 to 4 (the multiples of 16 up to 128 keep PR 22's
#: geometries)
DECODE_DIMS = {D: decode_dim_geometry(D) for D in range(8, 257, 8)}
DECODE_DIMS.update({16: (768, 48, 16), 32: (768, 24, 8), 48: (768, 16, 4),
                    64: (768, 12, 4), 80: (640, 8, 4), 96: (768, 8, 8),
                    112: (672, 6, 2), 128: (768, 6, 2)})
#: the head dims check_decode_dims times (each beside its plain version and
#: bound): D 64, and D on each class's instance (E 1, 2, 4, 8) across the
#: range each serves
DECODE_TIMED = (8, 24, 40, 64, 72, 120, 136, 160, 192, 200, 256)
#: the head dims the flash kernels take on the kernels of the next of 32,
#: 64 and 128 (their columns past D zero-filled by TMA), and (FLASH_PADDED)
#: head dims that are not a multiple of 8, which the wrappers zero-pad to
#: the next multiple of 8 before the kernels run
FLASH_PADDED = (12, 20, 36, 100)
FLASH_NEW_DIMS = (8, 16, 24, 40, 48, 56, 72, 80, 88, 96, 104, 112,
                  120) + FLASH_PADDED
#: the head dims check_flash_dims times at the training shape
FLASH_TIMED = (8, 16, 24, 40, 64, 80, 96, 120) + FLASH_PADDED
#: the head dims of the #16 route's check
ROUTE_DIMS = (16, 20, 24, 80, 120)
#: (B, H, L) of the flash checks at FLASH_NEW_DIMS: the training shape's
#: L with fewer rows, and the ragged L
FLASH_NEW_SHAPES = ((8, 12, 128), (2, 6, 200))


def check_decode_dims(torch, timer, report, dims=None, timed=DECODE_TIMED):
    """#12, #13 and #15 (fp and int8 pages) at each head dim of ``dims``
    (every one of DECODE_DIMS when None) against their plain versions, on
    a 2-layer model of that head dim at B 16 with mixed lengths 1..512
    (row 7 of length 0): #12 over both layers, #13 on shard 0 and 1 of tp
    2, #15 over the model's heads; at the head dims of ``timed`` each
    timed beside its plain version and its bound."""
    from mxnet_tpu_torch.models import decoder as dec
    from mxnet_tpu_torch.ops.kernels import fused_cell as fc
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    pps, B = MAX_CTX // PAGE, SLOTS
    P = B * pps + 1
    rows = {}
    for D in DECODE_DIMS if dims is None else dims:
        C, H, KVH = DECODE_DIMS[D]
        model = perturb_affine(torch, dec.CausalLM(
            vocab_size=64, num_layers=2, units=C, hidden_size=3072,
            num_heads=H, num_kv_heads=KVH, max_length=MAX_CTX, device=DEV,
            seed=41), 41)
        cfg = model.config
        rng = np.random.default_rng(42)
        after = rng.integers(1, 513, B)
        after[7] = 0
        tb_np = tables_for(rng, after, pps)
        pos = np.maximum(after - 1, 0)
        meta = torch.tensor(np.stack([
            np.where(after > 0, tb_np[np.arange(B), pos // PAGE], 0),
            np.where(after > 0, pos % PAGE, 0)]), dtype=torch.int32,
            device=DEV)
        tb = torch.tensor(tb_np, device=DEV)
        ln = torch.tensor(after, dtype=torch.int32, device=DEV)
        g = torch.Generator(device=DEV).manual_seed(43)
        shape = (cfg.num_layers, KVH, P, PAGE, D)
        kp0 = torch.randn(shape, device=DEV, generator=g) * 0.5
        vp0 = torch.randn(shape, device=DEV, generator=g) * 0.5
        x = torch.randn(B, C, device=DEV, generator=g)
        row = {}
        def time_of(fn, **kw):
            return timer(fn, **kw) if D in timed else float("nan")
        # 12: both layers in one launch
        layers = model.params()["layers"]
        table = fc.WeightTable(layers, x.device)
        k1, v1, k2, v2 = (t.clone() for t in (kp0, vp0, kp0, vp0))
        _, _, xk = fc.decode_layer_group(x, k1, v1, table, meta, tb, ln, cfg)
        _, _, xp = fc.decode_layer_group_plain(x, k2, v2, layers, meta, tb,
                                               ln, cfg)
        err = max(float((xk - xp).abs().max()), float(max(
            (k1[:, :, 1:] - k2[:, :, 1:]).abs().max(),
            (v1[:, :, 1:] - v2[:, :, 1:]).abs().max())))
        bms, by = fused_bound(cfg, after, pps)
        row["decode_layer_group"] = dict(
            max_abs_err=err, tol=TOL_FUSED, bound_ms=bms, bound_by=by,
            ms=time_of(lambda: fc.decode_layer_group(
                x, k1, v1, table, meta, tb, ln, cfg), iters=10),
            plain_ms=time_of(lambda: fc.decode_layer_group_plain(
                x, k2, v2, layers, meta, tb, ln, cfg), iters=10))
        # 13: both shards of tp 2, layer 0
        plan = dec.tp_plan(cfg, tp_sharding(2))
        lcfg = plan.local_cfg
        shards = plan.shard_params(model.params())
        err = 0.0
        for r in range(2):
            lp = shards[r]["layers"][0]
            k1, v1, k2, v2 = (t[:1].clone() for t in (kp0, vp0, kp0, vp0))
            _, _, ok = fc.decode_attn_phase(
                x, plan.kv_view(k1, 0, r), plan.kv_view(v1, 0, r), lp, meta,
                tb, ln, lcfg)
            _, _, op = fc.decode_attn_phase_plain(
                x, plan.kv_view(k2, 0, r), plan.kv_view(v2, 0, r), lp, meta,
                tb, ln, lcfg)
            if bool(ok[7].any()):
                raise AssertionError("decode_attn_phase D %d: the length-0 "
                                     "row's partial is not zero" % D)
            err = max(err, float((ok - op).abs().max()), float(max(
                (k1[:, :, 1:] - k2[:, :, 1:]).abs().max(),
                (v1[:, :, 1:] - v2[:, :, 1:]).abs().max())))
        args = (x, plan.kv_view(k1, 0, 1), plan.kv_view(v1, 0, 1), lp, meta,
                tb, ln, lcfg)
        (bms, by), _ = phase_bounds(cfg, lcfg, after, pps)
        row["decode_attn_phase"] = dict(
            max_abs_err=err, tol=TOL_PHASE, bound_ms=bms, bound_by=by,
            ms=time_of(lambda: fc.decode_attn_phase(*args)),
            plain_ms=time_of(lambda: fc.decode_attn_phase_plain(*args),
                             spin=4_000_000))
        # 15 over fp and int8 pages
        q = torch.randn(B, H, D, device=DEV, generator=g)
        toks = int(after.sum())
        for name in ("paged_attention", "paged_attention_int8"):
            if name.endswith("int8"):
                kp, vp = (pa.QPages(
                    q=torch.randint(-127, 128, (KVH, P, PAGE, D), device=DEV,
                                    generator=g).to(torch.int8),
                    s=torch.rand(KVH, P, device=DEV, generator=g) * 0.05)
                    for _ in range(2))
                pages_read = int(sum(-(-int(n) // PAGE) for n in after))
                nbytes = (2 * toks * KVH * D + 2 * 4 * pages_read * KVH
                          + 4 * (2 * B * H * D + B + B * pps))
            else:
                kp, vp = kp0[0], vp0[0]
                nbytes = 4 * (2 * B * H * D + 2 * toks * KVH * D + B
                              + B * pps)
            out = pa.paged_attention(q, kp, vp, ln, tb)
            ref = pa.paged_attention_reference(q, kp, vp, ln, tb)
            if bool(out[7].any()):
                raise AssertionError("%s D %d: a length-0 row is not zero"
                                     % (name, D))
            bms, by = bound(nbytes, 4 * H * D * toks)
            row[name] = dict(
                max_abs_err=float((out - ref).abs().max()),
                tol=TOL_ATTENTION, bound_ms=bms, bound_by=by,
                ms=time_of(lambda: pa.paged_attention(q, kp, vp, ln, tb)),
                plain_ms=time_of(lambda: pa.paged_attention_reference(
                    q, kp, vp, ln, tb)))
        for name, r in row.items():
            log("%s D %d (C %d, H %d, KVH %d, B %d mixed lengths; instance "
                "%s): max_abs_err %.3g (tol %g); kernel %.4f ms plain %.4f "
                "ms bound %.4f ms (%s)"
                % (name, D, C, H, KVH, B, decode_instance(D, name),
                   r["max_abs_err"], r["tol"], r["ms"], r["plain_ms"],
                   r["bound_ms"], r["bound_by"]))
            if not r["max_abs_err"] <= r["tol"]:
                raise AssertionError("%s disagrees with its plain version at "
                                     "head dim %d" % (name, D))
        rows[D] = row
        del model, kp0, vp0
        torch.cuda.empty_cache()
    report["decode_dims"] = rows


def check_flash_dims(torch, timer, report, timed=FLASH_TIMED):
    """#5-#7 and the delta kernel at the head dims of FLASH_NEW_DIMS, in
    float32 and bfloat16, against the plain versions: ``flash_case`` at
    FLASH_NEW_SHAPES with no mask, causal, a window of 32 and kv_length
    with a row of length 0 (and one of length 1 where B > 2), at dropout 0
    and 0.1; the delta kernel at
    those shapes and DELTA_EDGE_SHAPES; the #16 route
    (``flash_attention_sharded``, dp 2 x tp 2, causal) at ROUTE_DIMS,
    forward and gradients against autograd through the plain attention.
    Then #5-#7 and delta timed at
    the training shape (B 32, H 12, L 128, kv_length, dropout 0.1) at the
    head dims of ``timed`` beside their plain versions and bounds."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator(device=DEV).manual_seed(51)
    worst, n = {}, 0
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)[6:]
        for D in FLASH_NEW_DIMS:
            for B, H, L in FLASH_NEW_SHAPES:
                for mask in ("none", "causal", "window", "kv_length"):
                    for rate in (0.0, 0.1):
                        errs = flash_case(torch, fa, g, B, H, L, D, dt, mask,
                                          rate)
                        n += 1
                        w = worst.setdefault(key, {})
                        for name, e in errs.items():
                            w[name] = max(w.get(name, 0.0), e)
            for B, H, L in FLASH_NEW_SHAPES + DELTA_EDGE_SHAPES:
                do, out = (torch.randn(B, H, L, D, device=DEV,
                                       generator=g).to(dt) for _ in range(2))
                got = fa.flash_attention_bwd_delta(do, out)
                want = fa.flash_attention_bwd_delta_plain(do, out)
                rows = (do.float() * out.float()).abs().sum(-1)
                e = float(((got - want).abs() / rows.clamp_min(1e-30)).max())
                w = worst.setdefault(key, {})
                w["delta"] = max(w.get("delta", 0.0), e)
        torch.cuda.empty_cache()
    log("flash attention at D %s: %d cases pass; worst error / largest "
        "element %s (tol fp32 %g, fp32 out/dq/dk/dv %g, bf16 %g, bf16 vs "
        "autograd %g, delta over the row's sum of |dO O| %g)"
        % (FLASH_NEW_DIMS, n, json.dumps(worst), TOL_FLASH_F32,
           TOL_FLASH_3XTF32, TOL_FLASH_BF16, TOL_FLASH_GRAD_BF16, TOL_DELTA))
    if not all(w["delta"] <= TOL_DELTA for w in worst.values()):
        raise AssertionError("flash_attention_bwd_delta disagrees with its "
                             "plain version at a new head dim")
    # the #16 route at ROUTE_DIMS: one flash call over the whole tensors of
    # a (dp 2, tp 2) mesh, forward and gradients against autograd through
    # the plain causal attention
    from mxnet_tpu_torch.ops import attention as att
    cfg = tp_sharding(SHARDED_MESH[1], SHARDED_MESH[0])
    for dt in (torch.float32, torch.bfloat16):
        f32 = dt == torch.float32
        for D in ROUTE_DIMS:
            q, k, v, do = (torch.randn(8, 12, 128, D, device=DEV,
                                       generator=g).to(dt) for _ in range(4))
            ls = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lp = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = att.flash_attention_sharded(*ls, cfg, causal=True)
            ref = fa.flash_attention_plain(*lp, causal=True)[0]
            gs = torch.autograd.grad(out, ls, do)
            gp = torch.autograd.grad(ref, lp, do)
            err = rel_err(out, ref)
            err_g = max(rel_err(a, b) for a, b in zip(gs, gp))
            tol = TOL_FLASH_F32 if f32 else TOL_FLASH_BF16
            tol_g = TOL_FLASH_F32 if f32 else TOL_FLASH_GRAD_BF16
            log("flash_attention_sharded dp 2 x tp 2 (8, 12, 128, D %d) %s "
                "causal, route %s: out err %.3g (tol %g), gradients %.3g "
                "(tol %g)" % (D, str(dt)[6:], att.last_path, err, tol, err_g,
                              tol_g))
            if not (err <= tol and err_g <= tol_g
                    and att.last_path == "flash-causal-shard"):
                raise AssertionError("flash_attention_sharded disagrees at "
                                     "head dim %d" % D)
    B, H, L = TRAIN_B, BERT["num_heads"], TRAIN_L
    kvl = pretrain_batch(torch, 0, B, L, DEV)["valid"].to(torch.int32)
    seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64, device=DEV,
                         generator=g)
    kw = dict(dropout=0.1, seed=seed, kv_length=kvl)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        peak = TF32X3_FLOPS if dt == torch.float32 else BF16_FLOPS
        for D in timed:
            q, k, v, do = (torch.randn(B, H, L, D, device=DEV,
                                       generator=g).to(dt) for _ in range(4))
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            delta = fa.flash_attention_bwd_delta(do, out)
            bwd = (q, k, v, do, lse, delta)
            elt = q.element_size()
            keys = float(kvl.sum()) * H * L
            full = B * H * L * D * elt
            kv = 2 * float(kvl.sum()) * H * D * elt
            stat = B * H * L * 4
            for name, fn, plain, flops, nbytes in (
                    ("flash_attention_fwd",
                     lambda: fa.flash_attention_fwd(q, k, v, **kw),
                     lambda: fa.flash_attention_plain(q, k, v, **kw),
                     4 * keys * D, 2 * full + kv + stat),
                    ("flash_attention_bwd_dq",
                     lambda: fa.flash_attention_bwd_dq(*bwd, **kw),
                     lambda: fa.flash_attention_bwd_dq_plain(*bwd, **kw),
                     6 * keys * D, 3 * full + kv + 2 * stat),
                    ("flash_attention_bwd_dkv",
                     lambda: fa.flash_attention_bwd_dkv(*bwd, **kw),
                     lambda: fa.flash_attention_bwd_dkv_plain(*bwd, **kw),
                     8 * keys * D, 4 * full + kv + 2 * stat),
                    ("flash_attention_bwd_delta",
                     lambda: fa.flash_attention_bwd_delta(do, out),
                     lambda: fa.flash_attention_bwd_delta_plain(do, out),
                     2 * B * H * L * D, 2 * full + stat)):
                bms, by = bound(nbytes, flops, peak)
                r = dict(ms=timer(fn, spin=FLASH_SPIN),
                         plain_ms=timer(plain, spin=FLASH_SPIN),
                         bound_ms=bms, bound_by=by)
                log("%s (B %d, H %d, L %d, D %d, kv_length, rate 0.1) %s: "
                    "kernel %.4f ms plain %.4f ms bound %.4f ms (%s)"
                    % (name, B, H, L, D, str(dt)[6:], r["ms"], r["plain_ms"],
                       bms, by))
                rows["%s %s D %d" % (name, str(dt)[6:], D)] = r
            if D % 8:
                # the main path at such a D: forward and backward through
                # flash_attention, which pads q, k, v and dO once, beside
                # the same at the padded D
                Dp = D + -D % 8
                pad_in = [torch.randn(B, H, L, Dp, device=DEV,
                                      generator=g).to(dt) for _ in range(4)]

                def step(ts, grad):
                    ls = [t.detach().requires_grad_() for t in ts]
                    return torch.autograd.grad(fa.flash_attention(*ls, **kw),
                                               ls, grad)

                # autograd's enqueue of the whole step outlasts FLASH_SPIN:
                # spin ~2 ms, so the time is the card's
                r = dict(ms=timer(lambda: step((q, k, v), do),
                                  spin=4_000_000),
                         padded_ms=timer(lambda: step(pad_in[:3], pad_in[3]),
                                         spin=4_000_000))
                log("flash_attention forward + backward (B %d, H %d, L %d, "
                    "kv_length, rate 0.1) %s: D %d %.4f ms, D %d %.4f ms"
                    % (B, H, L, str(dt)[6:], D, r["ms"], Dp, r["padded_ms"]))
                rows["flash_attention fwd+bwd %s D %d" % (str(dt)[6:], D)] = r
        torch.cuda.empty_cache()
    report["flash_dims"] = rows


def per_shard_causal(torch, q, k, v, dp, tp):
    """The #16 route composed per shard, as it ran before it became one
    call: contiguous slices, the scale folded into q in q's dtype,
    ``flash_attention``, then two concats.  At D 64 the scale 1/8 is a
    power of two, so folding it into q gives the bits of applying it in
    the kernels."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    B, H, _, D = q.shape
    Bl, Hl, s = B // dp, H // tp, 1.0 / math.sqrt(D)
    rows = []
    for d in range(dp):
        heads = []
        for t in range(tp):
            qs, ks, vs = (x[d * Bl:(d + 1) * Bl, t * Hl:(t + 1) * Hl]
                          for x in (q, k, v))
            heads.append(fa.flash_attention((qs * s).to(qs.dtype), ks, vs,
                                            causal=True, scale=1.0))
        rows.append(torch.cat(heads, dim=1))
    return torch.cat(rows, dim=0)


def span_kind(name):
    """The kind of a kernel span of a flash-attention call, by its name."""
    for key, kind in (("flash_fwd", "#5"), ("flash_bwd_dq", "#6"),
                      ("flash_bwd_dkv", "#7"), ("flash_bwd_delta", "delta"),
                      ("reduce_kernel", "sums"), ("MulFunctor", "products"),
                      ("copy", "copies")):
        if key in name:
            return kind
    return "other"


def op_split(torch, fn, iters=5, samples=20):
    """``fn`` (after one warm call) ``iters`` times under torch.profiler,
    back to back: per call, the top-level aten ops on the host, the kernel
    spans and their device ms by :func:`span_kind`, the window from the
    first span's start to the last one's end, and the device's idle ms in
    it.  Also the host's enqueue time of one call, the median of
    ``samples`` calls timed while the card runs a ~60 ms spin, so that no
    launch waits for the card."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(120_000_000)
    enqueue = []
    for _ in range(samples):
        t = time.perf_counter()
        fn()
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == cuda)
    kinds = {}
    busy, end = 0.0, None
    for a, b, name in spans:
        n, ms = kinds.get(span_kind(name), (0, 0.0))
        kinds[span_kind(name)] = (n + 1, ms + (b - a) / 1e3)
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ops = sum(1 for e in prof.events()
              if e.device_type != cuda and e.name.startswith("aten::")
              and not (e.cpu_parent is not None
                       and e.cpu_parent.name.startswith("aten::")))
    window = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return dict(aten_ops=ops / iters, spans=len(spans) / iters,
                kinds={k: (n / iters, ms / iters)
                       for k, (n, ms) in sorted(kinds.items())},
                window_ms=window / iters,
                idle_ms=(window - busy / 1e3) / iters,
                enqueue_ms=statistics.median(enqueue))


def bert_attention_split(torch, dt, B, L):
    """:func:`op_split` of one BERT layer's flash attention, forward and
    backward through autograd as the training step runs it: q, k and v
    permuted out of the (B, L, 3, H, D) projection, dropout 0.1, the
    training batch's valid lengths, the output's gradient taken through
    its transpose back to (B, L, H, D).  Logs the host's enqueue time,
    the aten ops and the kernel spans of one call."""
    from mxnet_tpu_torch.ops import attention as att
    H, D = BERT["num_heads"], 64
    g = torch.Generator(device=DEV).manual_seed(17)
    proj = torch.randn(B, L, 3 * H * D, device=DEV, generator=g).to(
        dt).requires_grad_()
    dout = torch.randn(B, L, H, D, device=DEV, generator=g).to(dt)
    valid = pretrain_batch(torch, 0, B, L, DEV)["valid"]

    def step():
        q, k, v = proj.reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
        out = att.flash_attention(q, k, v, dropout=0.1, kv_length=valid,
                                  generator=g)
        return torch.autograd.grad(out.transpose(1, 2), proj, dout)
    split = op_split(torch, step)
    log("profile BERT attention %s (B %d, H %d, L %d, D %d), forward and "
        "backward per call: host enqueue %.4f ms, %.0f aten ops, %.0f kernel "
        "spans (%s), device busy %.4f ms"
        % (str(dt)[6:], B, H, L, D, split["enqueue_ms"], split["aten_ops"],
           split["spans"], ", ".join("%s %g in %.4f ms" % (k, n, ms)
                                     for k, (n, ms) in split["kinds"].items()),
           split["window_ms"] - split["idle_ms"]))
    return split


def check_sharded_attention(torch, timer, report, profile=False):
    """The #16 route: ``flash_attention_sharded`` on a (dp 2, tp 2) mesh at
    the training shape (B 32, H 12, L 128, D 64), causal, fp32 and bf16:
    its output and gradients equal, bit for bit, the per-shard composition
    (``per_shard_causal``), and are held against
    ``flash_attention_plain(causal=True)`` on the whole tensors and
    against the unsharded kernel #5; ROUTE_LAUNCHES launches of #5 per
    call (counted by #5 and by the route), and of the delta kernel, #6
    and #7 per backward, and dp * tp causal shards counted apart; its
    gradient against the unsharded kernels' at
    dropout 0.  Forward and backward timed beside the plain
    version, SDPA (is_causal) and the bound; with ``profile`` the
    backward's ops and kernel spans (:func:`op_split`)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    cfg = tp_sharding(SHARDED_MESH[1], SHARDED_MESH[0])
    shards = SHARDED_MESH[0] * SHARDED_MESH[1]
    B, H, L, D = TRAIN_B, BERT["num_heads"], TRAIN_L, 64
    g = torch.Generator(device=DEV).manual_seed(15)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(B, H, L, D, device=DEV, generator=g).to(dt)
                       for _ in range(4))
        n0 = launch_counts()
        c0 = att.flash_attention_sharded.causal_shards
        out = att.flash_attention_sharded(q, k, v, cfg, causal=True)
        n1 = launch_counts()
        n_fwd, n_route = (n1[k] - n0[k] for k in (
            "flash_attention_fwd", "flash_attention_sharded_causal"))
        n_shards = att.flash_attention_sharded.causal_shards - c0
        want = (ROUTE_LAUNCHES["flash_attention_fwd"],
                ROUTE_LAUNCHES["flash_attention_sharded_causal"], shards)
        if ((n_fwd, n_route, n_shards) != want
                or att.last_path != "flash-causal-shard"):
            raise AssertionError("flash_attention_sharded: %d launches of #5 "
                                 "(%d counted by the route) and %d causal "
                                 "shards, want %s (route %s)"
                                 % (n_fwd, n_route, n_shards, want,
                                    att.last_path))
        plain = fa.flash_attention_plain(q, k, v, causal=True)[0]
        whole = att.flash_attention(q, k, v, causal=True)
        ls = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lw = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        gs = torch.autograd.grad(att.flash_attention_sharded(
            *ls, cfg, causal=True), ls, do)
        gw = torch.autograd.grad(att.flash_attention(*lw, causal=True), lw,
                                 do)
        lc = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        comp = per_shard_causal(torch, *lc, *SHARDED_MESH)
        gc = torch.autograd.grad(comp, lc, do)
        if not (torch.equal(out, comp.detach())
                and all(torch.equal(a, b) for a, b in zip(gs, gc))):
            raise AssertionError("flash_attention_sharded %s: output or "
                                 "gradients differ from the per-shard "
                                 "composition" % str(dt)[6:])
        errs = dict(plain=rel_err(out, plain), whole=rel_err(out, whole),
                    grad=max(rel_err(a, b) for a, b in zip(gs, gw)))
        f32 = dt == torch.float32
        tol = TOL_FLASH_F32 if f32 else TOL_FLASH_BF16
        tol_g = TOL_FLASH_F32 if f32 else TOL_FLASH_GRAD_BF16
        # the route enqueues its casts and launches through the wrappers'
        # Python, the plain version ~12 ops: spin ~2 ms so the card's time
        # is timed, not the host's enqueue
        ms = timer(lambda: att.flash_attention_sharded(q, k, v, cfg,
                                                       causal=True),
                   spin=4_000_000)
        plain_ms = timer(lambda: fa.flash_attention_plain(q, k, v,
                                                          causal=True),
                         spin=4_000_000)
        lib = timer(lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True))
        # the route's backward (the delta kernel, #6 and #7) beside SDPA's
        # is_causal backward on the whole tensors, both through autograd
        lb = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o_route = att.flash_attention_sharded(*lb, cfg, causal=True)

        def route_bwd():
            return torch.autograd.grad(o_route, lb, do, retain_graph=True)
        bwd_names = ("flash_attention_bwd_delta", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv")
        n0 = launch_counts()
        route_bwd()
        n1 = launch_counts()
        n_bwd = tuple(n1[k] - n0[k] for k in bwd_names)
        want_bwd = tuple(ROUTE_LAUNCHES[k] for k in bwd_names)
        if n_bwd != want_bwd:
            raise AssertionError("flash_attention_sharded backward: %s "
                                 "launches of the delta kernel, #6 and #7, "
                                 "want %s" % (n_bwd, want_bwd))
        bwd_ms = timer(route_bwd, spin=4_000_000)
        o_sdpa = F.scaled_dot_product_attention(*lb, is_causal=True)
        lib_bwd = timer(lambda: torch.autograd.grad(o_sdpa, lb, do,
                                                    retain_graph=True),
                        spin=4_000_000)
        pairs = B * H * L * (L + 1) // 2          # causal (row, key) pairs
        peak = TF32X3_FLOPS if dt == torch.float32 else BF16_FLOPS
        elt = q.element_size()
        # the function's least work: read q, k, v, dO, out and lse once,
        # write dq, dk and dv once; the products S, dP, dV, dK, dQ
        bwd_bms, bwd_by = bound(8 * B * H * L * D * elt + B * H * L * 4,
                                10 * pairs * D, peak)
        # this design's own: the delta pass reads dO and O and writes
        # delta; #6 reads q, k, v, dO, lse, delta and writes dq; #7 reads
        # the same and writes dk, dv, computing S and dP again
        design_bms, _ = bound(13 * B * H * L * D * elt + 5 * B * H * L * 4,
                              14 * pairs * D, peak)
        log("flash_attention_sharded %s backward (%d launches of the delta "
            "kernel, %d of #6 and %d of #7): %.4f ms, bound %.4f ms (%s); "
            "SDPA is_causal backward on the whole tensors %.4f ms"
            % ((str(dt)[6:],) + n_bwd + (bwd_ms, bwd_bms, bwd_by, lib_bwd)))
        log("flash_attention_sharded %s backward, the design's own floor "
            "(delta reads dO and O; #6 and #7 each read q, k, v, dO, lse and "
            "delta; #7 computes S and dP again): %.4f ms"
            % (str(dt)[6:], design_bms))
        if profile:
            split = op_split(torch, route_bwd)
            log("profile flash_attention_sharded %s backward, per call: %.0f "
                "aten ops, %.0f kernel spans (%s), device busy %.4f of a "
                "%.4f ms window (idle %.4f ms); host enqueue %.4f ms"
                % (str(dt)[6:], split["aten_ops"], split["spans"],
                   ", ".join("%s %g in %.4f ms" % (k, n, ms) for k, (n, ms)
                             in split["kinds"].items()),
                   split["window_ms"] - split["idle_ms"], split["window_ms"],
                   split["idle_ms"], split["enqueue_ms"]))
        bms, by = bound(4 * B * H * L * D * q.element_size(), 4 * pairs * D,
                        TF32X3_FLOPS if f32 else BF16_FLOPS)
        log("flash_attention_sharded dp %d tp %d (B %d, H %d, L %d, D %d, "
            "causal) %s: %d launches of #5 per call; max err / largest vs "
            "plain %.3g, vs unsharded #5 %.3g (tol %g), gradients vs "
            "unsharded %.3g (tol %g); route %.4f ms plain %.4f ms bound "
            "%.4f ms (%s) SDPA is_causal %.4f ms"
            % (SHARDED_MESH + (B, H, L, D, str(dt)[6:], n_fwd, errs["plain"],
                               errs["whole"], tol, errs["grad"], tol_g, ms,
                               plain_ms, bms, by, lib)))
        log("flash_attention_sharded %s: output and gradients equal the "
            "per-shard composition (slices, the scale folded into q, "
            "flash_attention, concat) bit for bit" % str(dt)[6:])
        if not (errs["plain"] <= tol and errs["whole"] <= tol
                and errs["grad"] <= tol_g):
            raise AssertionError("flash_attention_sharded disagrees: %s"
                                 % errs)
        rows[str(dt)[6:]] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=by, library_ms=lib,
                                 max_abs_err=max(errs.values()),
                                 bwd_ms=bwd_ms, bwd_bound_ms=bwd_bms,
                                 bwd_design_floor_ms=design_bms,
                                 library_bwd_ms=lib_bwd)
    report["flash_attention_sharded_causal"] = dict(
        name="flash_attention_sharded_causal", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_attention.cu",
        replaces="mxnet_tpu/ops/attention.py:302", **rows["float32"])
    report["sharded_attention"] = rows


def sharded_attention_path(torch, seed):
    """The #16 route's path: a user's forward and backward through
    ``flash_attention_sharded`` on the (dp 2, tp 2) mesh at the training
    shape, causal, in fp32 and bf16, with the launch counts set to 0
    before and read after: each call launches ROUTE_LAUNCHES of #5, the
    delta kernel, #6 and #7, the route counts its one launch of #5, and
    it counts dp * tp causal shards apart from the launches."""
    from mxnet_tpu_torch.ops import attention as att
    cfg = tp_sharding(SHARDED_MESH[1], SHARDED_MESH[0])
    shards = SHARDED_MESH[0] * SHARDED_MESH[1]
    B, H, L, D = TRAIN_B, BERT["num_heads"], TRAIN_L, 64
    g = torch.Generator(device=DEV).manual_seed(seed)
    inputs = [[torch.randn(B, H, L, D, device=DEV, generator=g).to(dt)
               for _ in range(4)] for dt in (torch.float32, torch.bfloat16)]
    torch.cuda.synchronize()
    c0 = att.flash_attention_sharded.causal_shards
    launch_counts(reset=True)
    for q, k, v, do in inputs:
        leaves = [t.requires_grad_() for t in (q, k, v)]
        out = att.flash_attention_sharded(*leaves, cfg, causal=True)
        out.backward(do)
        if not all(bool(torch.isfinite(t.grad).all()) for t in leaves):
            raise AssertionError("flash_attention_sharded: non-finite "
                                 "gradients")
    torch.cuda.synchronize()
    counts = launch_counts()
    n_shards = att.flash_attention_sharded.causal_shards - c0
    want = dict.fromkeys(KERNELS, 0)
    for name, n in ROUTE_LAUNCHES.items():
        want[name] = n * len(inputs)
    log("sharded attention path: forward and backward at dp %d tp %d, fp32 "
        "and bf16: launches %s; %d causal shards"
        % (SHARDED_MESH + ({k: n for k, n in counts.items() if n},
                           n_shards)))
    if counts != want or n_shards != shards * len(inputs):
        raise AssertionError("sharded attention launches %s and %d causal "
                             "shards, want %s and %d"
                             % (counts, n_shards, want, shards * len(inputs)))
    return counts


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def traffic(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, WIDTHS["vocab_size"],
                          int(rng.integers(16, 257))).tolist(),
             int(rng.integers(16, 129))) for _ in range(n)]


KERNELS = ("bias_gelu", "paged_attention", "decode_layer_group",
           "quant_matmul_w8", "quant_matmul_w4", "paged_attention_int8",
           "bias_gelu_backward", "bias_dropout_residual_fwd",
           "bias_dropout_residual_bwd", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_delta", "lstm_sequence_fwd",
           "lstm_sequence_bwd", "lstm_sequence_bwd_gates",
           "decode_attn_phase", "decode_ffn_phase",
           "flash_attention_sharded_causal")


def launch_counts(reset=False):
    """Every kernel wrapper's launch count (set to 0 first when ``reset``)."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops.kernels import epilogue as ep
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.kernels import fused_cell as fc
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    from mxnet_tpu_torch.ops.kernels import quant_matmul as qm
    counters = {"bias_gelu": (ep.bias_gelu, "launches"),
                "paged_attention": (pa.paged_attention, "launches"),
                "decode_layer_group": (fc.decode_layer_group, "launches"),
                "quant_matmul_w8": (qm.quant_matmul, "launches_w8"),
                "quant_matmul_w4": (qm.quant_matmul, "launches_w4"),
                "paged_attention_int8": (pa.paged_attention,
                                         "launches_int8"),
                "bias_gelu_backward": (ep.bias_gelu_backward, "launches"),
                "bias_dropout_residual_fwd": (ep.bias_dropout_residual,
                                              "launches_fwd"),
                "bias_dropout_residual_bwd": (ep.bias_dropout_residual,
                                              "launches_bwd"),
                "flash_attention_fwd": (fa.flash_attention, "launches_fwd"),
                "flash_attention_bwd_dq": (fa.flash_attention, "launches_dq"),
                "flash_attention_bwd_dkv": (fa.flash_attention,
                                            "launches_dkv"),
                "flash_attention_bwd_delta": (fa.flash_attention,
                                              "launches_delta"),
                "lstm_sequence_fwd": (fc.lstm_sequence, "launches_fwd"),
                "lstm_sequence_bwd": (fc.lstm_sequence, "launches_bwd"),
                "lstm_sequence_bwd_gates": (fc.lstm_sequence,
                                            "launches_bwd_gates"),
                "decode_attn_phase": (fc.decode_attn_phase, "launches"),
                "decode_ffn_phase": (fc.decode_ffn_phase, "launches"),
                # the #16 route: the launches of #5 its calls made
                "flash_attention_sharded_causal": (att.flash_attention_sharded,
                                                   "launches")}
    if reset:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


class Driven:
    """One engine's run, counted and timed from outside: the decode steps
    it launched, its prefill chunks (timed on the card by CUDA events
    recorded around each call and read after the run — a synchronise
    after each chunk would be a host wait the engine does not have), and
    the host time of each launch half and retire half of the async loop.
    With ``sync_check`` the launch half runs under
    ``torch.cuda.set_sync_debug_mode("error")``: an operation there that
    synchronises the stream raises, and the lanes it carried fail."""

    def __init__(self, torch, eng, sync_check=False):
        self.torch, self.eng = torch, eng
        self.launched, self.events = 0, []
        self.launch_ms, self.retire_ms = [], []
        self.saved = {k: getattr(eng, k) for k in (
            "_decode_fn", "_prefill_fn", "_launch_decode", "_retire_one")}
        decode, prefill = self.saved["_decode_fn"], self.saved["_prefill_fn"]
        launch, retire = self.saved["_launch_decode"], self.saved["_retire_one"]

        def counted_decode(*a):
            self.launched += 1
            return decode(*a)

        def timed_prefill(*a):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = prefill(*a)
            e.record()
            self.events.append((s, e))
            return out

        def timed_launch():
            t = time.perf_counter()
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return launch()
            finally:
                if sync_check:
                    torch.cuda.set_sync_debug_mode("default")
                self.launch_ms.append((time.perf_counter() - t) * 1e3)

        def timed_retire():
            t = time.perf_counter()
            out = retire()
            self.retire_ms.append((time.perf_counter() - t) * 1e3)
            return out

        eng._decode_fn, eng._prefill_fn = counted_decode, timed_prefill
        eng._launch_decode, eng._retire_one = timed_launch, timed_retire

    def restore(self):
        """Put the engine's own methods back; the chunks' device ms."""
        for k, fn in self.saved.items():
            setattr(self.eng, k, fn)
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def path_launches(eng, steps, chunks):
    """The kernel launches of ``steps`` decode steps and ``chunks`` prefill
    chunks of ``eng``'s path, by the names of ``KERNELS``."""
    L, tp = eng.cfg.num_layers, eng.tp
    want = dict.fromkeys(KERNELS, 0)
    if eng.decode_fused and eng.sharding is not None:
        want["decode_attn_phase"] = want["decode_ffn_phase"] = steps * L * tp
        want["bias_gelu"] = chunks * L * tp
    elif eng.decode_fused:
        want["decode_layer_group"] = steps * eng.launch_stats["layer_groups"]
        want["bias_gelu"] = chunks * L
    else:
        attn = ("paged_attention_int8" if eng.kv_dtype == "int8"
                else "paged_attention")
        want[attn] = steps * L * tp
        want["bias_gelu"] = (chunks + steps) * L * tp
    if eng.quant is not None:
        fmt = "w8" if eng.quant[0] == "int8" else "w4"
        want["quant_matmul_" + fmt] = 6 * L * tp * (steps + chunks)
    return want


def check_launches(what, counts, want, runs):
    """``counts`` (launches read after a phase) must equal ``want``; ``runs``
    are (label, Driven, decode_steps_total) of the phase's engines.  Where
    an engine launched more steps than it retired, the discarded flights
    are printed (the check stays exact)."""
    for label, drv, steps in runs:
        if drv.launched != steps:
            log("%s %s: %d decode steps launched, %d retired: %d discarded "
                "flights" % (what, label, drv.launched, steps,
                             drv.launched - steps))
    if counts != want:
        raise AssertionError("%s: launch counts do not match the path: %s, "
                             "want %s" % (what, counts, want))


def pct(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


def serve(torch, lm, reqs, label, fused, sharding=None, async_decode=None,
          sync_check=False, **quant):
    """Serve ``reqs`` through a fresh engine (the engine's defaults: async,
    dispatch depth 1, prefix cache on, unless ``async_decode`` says
    otherwise); check every request's length, that the run launched
    exactly the kernels of its path and, under ``sharding``, the engine's
    collective census.  ``sync_check``: the launch half runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from mxnet_tpu_torch.serving import DecodeEngine
    os.environ["MXNET_DECODE_FUSED"] = "1" if fused else "0"
    eng = DecodeEngine(lm, name="smoke", slots=SLOTS, page_size=PAGE,
                       max_ctx=MAX_CTX, prefill_chunk=CHUNK, device=DEV,
                       sharding=sharding, async_decode=async_decode, **quant)
    eng.warmup()
    torch.cuda.synchronize()
    launch_counts(reset=True)
    drv = Driven(torch, eng, sync_check)
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if not eng.stop():
        raise AssertionError("engine worker did not stop")
    chunk_ms = drv.restore()
    snap = eng.metrics.snapshot()["models"]["smoke"]
    steps = snap["counters"]["decode_steps_total"]
    for (p, n), o in zip(reqs, outs):
        if len(o["tokens"]) != n or o["finish_reason"] != "length":
            raise AssertionError("request finished early or short: %r"
                                 % ({k: o[k] for k in ("finish_reason",
                                                       "completion_tokens")},))
    tp = eng.tp
    chunks = len(chunk_ms)
    gen = sum(len(o["tokens"]) for o in outs)
    step = snap["generate"]["decode_step"]
    gap = snap["generate"]["host_gap_us"]
    depth = snap["generate"]["dispatch_depth"]
    st = eng.stats()["async"]
    loop = "async" if eng.async_decode else "sync"
    log("serve %s (decode %s, weights %s, kv %s, tp %d, %s loop%s): %d "
        "requests, %d tokens in %.3f s = %.1f tokens/s; %d decode steps p50 "
        "%.3f ms p99 %.3f ms; %d prefill chunks p50 %.3f ms total %.1f ms "
        "(device, CUDA events); launches %s"
        % (label, "fused" if eng.decode_fused else "per-op",
           eng.quant and "/".join(map(str, eng.quant)), eng.kv_dtype, tp,
           loop, ", sync debug 'error' in the launch half" if sync_check
           else "", len(outs), gen, wall, gen / wall, steps, step["p50_ms"],
           step["p99_ms"], chunks, statistics.median(chunk_ms),
           sum(chunk_ms), counts))
    log("serve %s %s loop: host gap p50 %.1f us p99 %.1f us (%d steps); "
        "dispatch depth p50 %s max %s; deferred reads %d; prompt-completion "
        "drains %d; staging waits %d; launch half host p50 %.3f ms, retire "
        "half host p50 %.3f ms (%d retires)"
        % (label, loop, gap.get("p50_us", 0.0), gap.get("p99_us", 0.0),
           gap["count"], depth.get("p50"), depth.get("max"),
           snap["counters"]["deferred_reads_total"], st["prefill_drains"],
           st["staging_waits"], pct(drv.launch_ms, 50),
           pct(drv.retire_ms, 50), len(drv.retire_ms)))
    check_launches("serve " + label, counts, path_launches(eng, steps, chunks),
                   [(label, drv, steps)])
    if not chunks or not steps:
        raise AssertionError("serve %s: no decode step or no chunk" % label)
    if sharding is not None:
        shd = eng.stats()["sharding"]
        L = lm.config.num_layers
        log("serve %s: mesh %s, collectives per decode step (counted at "
            "attach) %s" % (label, shd["mesh"], shd["collectives"]))
        if (eng.tp != sharding.axis_size("tp")
                or shd["collectives"]["all-reduce"] != 2 * L
                or shd["collectives"]["total"] != 2 * L):
            raise AssertionError("tp %d engine: census %s, want %d "
                                 "all-reduces and nothing else"
                                 % (eng.tp, shd["collectives"], 2 * L))
    return eng, outs, counts, dict(
        tokens_per_s=gen / wall, decode_step_p50_ms=step["p50_ms"],
        decode_step_p99_ms=step["p99_ms"],
        prefill_chunk_p50_ms=statistics.median(chunk_ms), tp=tp, loop=loop,
        host_gap_p50_us=gap.get("p50_us", 0.0),
        dispatch_depth_max=depth.get("max"),
        deferred_reads=snap["counters"]["deferred_reads_total"],
        prefill_drains=st["prefill_drains"],
        staging_waits=st["staging_waits"],
        launch_half_p50_ms=pct(drv.launch_ms, 50),
        retire_half_p50_ms=pct(drv.retire_ms, 50))


#: requests of the tensor-parallel rows: the first half of the traffic,
#: which keeps the smoke's time near its length before the async/sync
#: A/B and the prefix and session phases came
TP_REQUESTS = 24

#: the tp 1 rows served again by the synchronous loop (async_decode=False),
#: whose streams must equal the async rows' token for token
AB_ROWS = (("fused", True, {}), ("per_op", False, {}),
           ("int8_kv8", True, dict(quantize="int8", kv_dtype="int8")))
#: the rows whose launch half runs under set_sync_debug_mode("error")
SYNC_CHECKED = ("fused", "int8_kv8_tp2")


def check_ab(torch, lm, reqs, runs):
    """The A/B rows: each served by the synchronous loop, streams held
    against the async run's, and both loops' numbers side by side."""
    for label, fused, quant in AB_ROWS:
        sync = label + "_sync"
        runs[sync] = serve(torch, lm, reqs, sync, fused, async_decode=False,
                           **quant)
        a, s = runs[label], runs[sync]
        same = sum(x["tokens"] == y["tokens"] for x, y in zip(a[1], s[1]))
        log("A/B %s: async vs sync streams identical for %d of %d; "
            "tokens/s %.1f vs %.1f; decode p50 %.3f vs %.3f ms, p99 %.3f vs "
            "%.3f ms; host gap p50 %.1f vs %.1f us; dispatch depth max %s vs "
            "%s; deferred reads %d vs %d; prompt-completion drains %d vs %d"
            % (label, same, len(reqs), a[3]["tokens_per_s"],
               s[3]["tokens_per_s"], a[3]["decode_step_p50_ms"],
               s[3]["decode_step_p50_ms"], a[3]["decode_step_p99_ms"],
               s[3]["decode_step_p99_ms"], a[3]["host_gap_p50_us"],
               s[3]["host_gap_p50_us"], a[3]["dispatch_depth_max"],
               s[3]["dispatch_depth_max"], a[3]["deferred_reads"],
               s[3]["deferred_reads"], a[3]["prefill_drains"],
               s[3]["prefill_drains"]))
        if same != len(reqs):
            raise AssertionError("A/B %s: the async and sync loops' streams "
                                 "differ" % label)


#: the shared prefix of the prefix traffic, by KV dtype: fp 12 full pages
#: of 16 and 8 tokens, so every hit forks the partial page copy-on-write;
#: int8 12 whole pages (a partial page's scale latches at its first
#: write, which the cache moves into another chunk)
PREFIX_TOKENS = {"float32": 200, "int8": 192}
PREFIX_REQUESTS = 47
PREFIX_RUNS = (("prefix_fused", True, {}),
               ("prefix_int8_kv8", True, dict(quantize="int8",
                                              kv_dtype="int8")))


def prefix_traffic(seed, n_prefix):
    """The shared prefix, then ``PREFIX_REQUESTS`` requests of the prefix
    plus 8-56 unique tokens (a distinct first token each) asking for
    16-64 new tokens."""
    rng = np.random.default_rng(seed + 1000)
    V = WIDTHS["vocab_size"]
    prefix = rng.integers(0, V, n_prefix).tolist()
    firsts = rng.choice(V, PREFIX_REQUESTS, replace=False)
    reqs = [(prefix + [int(f)] + rng.integers(0, V, int(rng.integers(
        7, 56))).tolist(), int(rng.integers(16, 65))) for f in firsts]
    return prefix, reqs


def near_tie(torch, eng, prompt, got, want):
    """The first position where two streams differ, and the top-2 margin
    of ``full_forward`` over the engine's weights there."""
    from mxnet_tpu_torch.models import decoder as dec
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    with torch.no_grad():
        lg = dec.full_forward(eng.params, eng.cfg, torch.tensor(
            [prompt + got[:i]], device=DEV))[0, -1]
    top2 = torch.topk(lg, 2).values
    return i, float(top2[0] - top2[1])


def prefix_phase(torch, lm, seed):
    """Prefix traffic, as many chats sharing one system prompt send it: per
    row of ``PREFIX_RUNS``, the shared prefix alone (waited for), then
    ``PREFIX_REQUESTS`` requests at once, with the prefix cache on and
    off.  The streams must be equal (or differ only at a near-tie of
    ``full_forward``); the hits, tokens saved and forks must be what the
    traffic gives.  Returns the phase's launch counts."""
    from mxnet_tpu_torch.serving import DecodeEngine
    os.environ["MXNET_DECODE_FUSED"] = "1"
    total = dict.fromkeys(KERNELS, 0)
    for label, _, quant in PREFIX_RUNS:
        kv = quant.get("kv_dtype", "float32")
        n_prefix = PREFIX_TOKENS[kv]
        prefix, reqs = prefix_traffic(seed, n_prefix)
        res = {}
        for on in (True, False):
            eng = DecodeEngine(lm, name="smoke", slots=SLOTS, page_size=PAGE,
                               max_ctx=MAX_CTX, prefill_chunk=CHUNK,
                               device=DEV, prefix_cache=on, **quant)
            eng.warmup()
            torch.cuda.synchronize()
            launch_counts(reset=True)
            drv = Driven(torch, eng)
            t0 = time.perf_counter()
            warm = eng.submit(prefix, max_new_tokens=16).result(timeout=900)
            outs = [f.result(timeout=900) for f in
                    [eng.submit(p, max_new_tokens=n) for p, n in reqs]]
            wall = time.perf_counter() - t0
            counts = launch_counts()
            if not eng.stop():
                raise AssertionError("engine worker did not stop")
            chunk_ms = drv.restore()
            snap = eng.metrics.snapshot()["models"]["smoke"]
            c, steps = snap["counters"], snap["counters"]["decode_steps_total"]
            check_launches(label, counts, path_launches(eng, steps,
                                                        len(chunk_ms)),
                           [(label, drv, steps)])
            for k in KERNELS:
                total[k] += counts[k]
            res[on] = (eng, [warm] + outs)
            log("%s cache %s: %d requests in %.3f s; prefix hits %d, tokens "
                "saved %d, copy-on-write forks %d; ttft p50 %.3f ms; %d "
                "prefill chunks (%.1f device ms); decode p50 %.3f ms"
                % (label, "on" if on else "off", len(reqs) + 1, wall,
                   c["prefix_hits_total"], c["prefix_tokens_saved_total"],
                   c["cow_forks_total"], snap["generate"]["ttft"]["p50_ms"],
                   len(chunk_ms), sum(chunk_ms),
                   snap["generate"]["decode_step"]["p50_ms"]))
            want = ((PREFIX_REQUESTS, PREFIX_REQUESTS * n_prefix,
                     PREFIX_REQUESTS if kv == "float32" else 0) if on
                    else (0, 0, 0))
            got = (c["prefix_hits_total"], c["prefix_tokens_saved_total"],
                   c["cow_forks_total"])
            if got != want:
                raise AssertionError("%s cache %s: hits, tokens saved, forks "
                                     "%s, want %s" % (label, on, got, want))
        eng = res[True][0]
        same = 0
        for (p, _), a, b in zip([(prefix, 16)] + reqs, res[True][1],
                                res[False][1]):
            if a["tokens"] == b["tokens"]:
                same += 1
                continue
            i, margin = near_tie(torch, eng, p, a["tokens"], b["tokens"])
            log("%s: streams differ at %d, full_forward top-2 margin %.3g"
                % (label, i, margin))
            if not margin < 1e-4:
                raise AssertionError("%s: cache on and off differ without a "
                                     "near-tie" % label)
        log("%s: cache on vs off streams identical for %d of %d"
            % (label, same, len(reqs) + 1))
    return total


#: the tiny LM's serving rows: (label, MXNET_DECODE_FUSED, engine
#: kwargs); int8 KV asks for the fused step and is given the per-op one
TINY_RUNS = (("tiny_fused", "1", {}), ("tiny_per_op", "0", {}),
             ("tiny_int8_kv8", "1", dict(kv_dtype="int8")))
TINY_ENGINE = dict(slots=8, page_size=8, max_ctx=128, prefill_chunk=16)
TINY_REQUESTS = 16


def tiny_traffic(seed, n, vocab=128, max_ctx=128):
    """``n`` (prompt, max_new) of the tiny LM: prompts of 2..48 tokens,
    8..48 new, within its context."""
    rng = np.random.default_rng(seed + 23)
    out = []
    for _ in range(n):
        p = int(rng.integers(2, 49))
        out.append((rng.integers(0, vocab, p).tolist(),
                    int(rng.integers(8, min(49, max_ctx - p + 1)))))
    return out


def tiny_phase(torch, seed):
    """The JAX package's serving-test model, ``decoder_tiny_lm(seed=0)``
    (units 64 over 4 heads over 2 KV heads: head dim 16), served on the
    card in each row of TINY_RUNS on the engine's defaults, the launches of
    each run held to its path (#12 at D 16 fused, #15 at D 16 per-op, over
    fp or int8 pages); every stream equal to the same engine's on CPU
    copies of the weights (where the plain versions serve), or differing
    only after a near-tie of ``full_forward`` (top-2 margin below 1e-4).
    Returns the phase's launch counts."""
    from mxnet_tpu_torch.models import decoder as dec
    from mxnet_tpu_torch.serving import DecodeEngine
    lm = dec.decoder_tiny_lm(seed=0, device=DEV)
    cpu_lm = dec.decoder_tiny_lm(seed=0, device="cpu")
    reqs = tiny_traffic(seed, TINY_REQUESTS)
    total = dict.fromkeys(KERNELS, 0)
    for label, fused, kw in TINY_RUNS:
        os.environ["MXNET_DECODE_FUSED"] = fused
        eng = DecodeEngine(lm, name="tiny", device=DEV, **TINY_ENGINE, **kw)
        eng.warmup()
        torch.cuda.synchronize()
        launch_counts(reset=True)
        drv = Driven(torch, eng)
        t0 = time.perf_counter()
        outs = [f.result(timeout=900)["tokens"] for f in
                [eng.submit(p, max_new_tokens=n) for p, n in reqs]]
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if not eng.stop():
            raise AssertionError("engine worker did not stop")
        chunk_ms = drv.restore()
        steps = eng.metrics.snapshot()["models"]["tiny"]["counters"][
            "decode_steps_total"]
        check_launches(label, counts, path_launches(eng, steps,
                                                    len(chunk_ms)),
                       [(label, drv, steps)])
        for k in KERNELS:
            total[k] += counts[k]
        ceng = DecodeEngine(cpu_lm, name="tiny", device="cpu", **TINY_ENGINE,
                            **kw)
        try:
            ref = [f.result(timeout=900)["tokens"] for f in
                   [ceng.submit(p, max_new_tokens=n) for p, n in reqs]]
        finally:
            ceng.stop()
        same = 0
        for (p, _), got, want in zip(reqs, outs, ref):
            if got == want:
                same += 1
                continue
            i, margin = near_tie(torch, eng, p, got, want)
            log("%s: the card's stream leaves the CPU's at %d, full_forward "
                "top-2 margin %.3g" % (label, i, margin))
            if not margin < 1e-4:
                raise AssertionError("%s: the card's stream differs from the "
                                     "CPU's without a near-tie" % label)
        log("%s: decoder_tiny_lm (D %d) decode step %s, %s KV: %d requests, "
            "%d tokens in %.3f s; %d decode steps, launches %s; streams "
            "equal to the CPU run's for %d of %d"
            % (label, eng.cfg.head_dim,
               "fused" if eng.decode_fused else "per-op", eng.kv_dtype,
               len(reqs), sum(len(o) for o in outs), wall, steps,
               {k: v for k, v in counts.items() if v}, same, len(reqs)))
    os.environ["MXNET_DECODE_FUSED"] = "1"
    return total


#: the HTTP phase's requests per model, and the full-width model's engine
HTTP_REQUESTS = 4


def http_phase(torch, lm, seed):
    """The HTTP surface on the card: a ``ModelServer`` on 127.0.0.1 (an
    ephemeral port) serves the full-width ``lm`` as "lm" and
    ``decoder_tiny_lm(seed=0)`` as "tiny" through ``attach_engine`` (fused
    decode, the prefix cache off so a request's pages never depend on an
    earlier one's); a ``ServingClient`` sends HTTP_REQUESTS generate
    requests to each, one after another, and a resume of a session the
    server does not hold, which must come back as the typed
    ``SessionResetError`` (409 ``session_reset``).  The same requests then
    go straight to each engine: the tokens must be equal.  Prints each
    model's round trip (p50 over its requests) beside the engine's own
    time for the same request, with the card's line.  Launch counts are
    set to 0 after the engines' warmup and read after the last request,
    held to both engines' paths.  Returns them."""
    from mxnet_tpu_torch.models import decoder as dec
    from mxnet_tpu_torch.serving import (DecodeEngine, ModelRegistry,
                                         ModelServer, ServingClient,
                                         SessionResetError)
    os.environ["MXNET_DECODE_FUSED"] = "1"
    tiny = dec.decoder_tiny_lm(seed=0, device=DEV)
    engines = {
        "lm": DecodeEngine(lm, device=DEV, slots=SLOTS, page_size=PAGE,
                           max_ctx=MAX_CTX, prefill_chunk=CHUNK,
                           prefix_cache=False),
        "tiny": DecodeEngine(tiny, device=DEV, prefix_cache=False,
                             **TINY_ENGINE)}
    rng = np.random.default_rng(seed + 31)
    reqs = {"lm": [(rng.integers(0, WIDTHS["vocab_size"],
                                 int(rng.integers(16, 129))).tolist(),
                    int(rng.integers(16, 65))) for _ in range(HTTP_REQUESTS)],
            "tiny": tiny_traffic(seed + 1, HTTP_REQUESTS)}
    srv = ModelServer(ModelRegistry(), host="127.0.0.1", port=0)
    cli = None
    try:
        srv.start()
        for name, eng in engines.items():
            srv.attach_engine(name, eng)     # warms the engine up
        torch.cuda.synchronize()
        launch_counts(reset=True)
        drivers = {name: Driven(torch, eng) for name, eng in engines.items()}
        cli = ServingClient(*srv.address, timeout=300.0)
        rows = {}
        for name, eng in engines.items():
            wire, direct, rtt, own = [], [], [], []
            for p, n in reqs[name]:
                t = time.perf_counter()
                wire.append(cli.generate(name, p, max_tokens=n)["tokens"])
                rtt.append((time.perf_counter() - t) * 1e3)
            for p, n in reqs[name]:
                t = time.perf_counter()
                direct.append(eng.submit(p, max_new_tokens=n).result(
                    timeout=900)["tokens"])
                own.append((time.perf_counter() - t) * 1e3)
            if wire != direct:
                raise AssertionError("http %s: the tokens over HTTP differ "
                                     "from the engine's" % name)
            rows[name] = dict(requests=len(wire),
                              tokens=sum(len(t) for t in wire),
                              rtt_p50_ms=pct(rtt, 50),
                              engine_p50_ms=pct(own, 50))
        try:
            cli.generate("lm", [1, 2, 3], max_tokens=2, session="unknown",
                         resume=True)
            raise AssertionError("http: resuming an unknown session did not "
                                 "raise")
        except SessionResetError as e:
            log("http: resume of an unknown session: %s (typed, 409)"
                % type(e).__name__)
        counts = launch_counts()
        want = dict.fromkeys(KERNELS, 0)
        runs = []
        for name, eng in engines.items():
            chunk_ms = drivers[name].restore()
            steps = eng.metrics.snapshot()["models"][name]["counters"][
                "decode_steps_total"]
            for k, v in path_launches(eng, steps, len(chunk_ms)).items():
                want[k] += v
            runs.append((name, drivers[name], steps))
        check_launches("http", counts, want, runs)
    finally:
        if cli is not None:
            cli.close()
        srv.stop()
    for name, r in rows.items():
        log("http %s (D %d): %d requests, %d tokens over HTTP equal to the "
            "engine's; round trip p50 %.3f ms, the engine's own p50 %.3f ms "
            "(%s)" % (name, engines[name].cfg.head_dim, r["requests"],
                      r["tokens"], r["rtt_p50_ms"], r["engine_p50_ms"],
                      card_line()))
    return counts


SESSIONS, SESSION_EXPORTS = 16, 4


#: the speculative rows: (label, drafter, engine knobs); each is served
#: beside the same engine without speculation
SPEC_RUNS = (("spec_ngram_sync", "ngram", dict(async_decode=False)),
             ("spec_ngram", "ngram", {}),
             ("spec_draft", "model", {}),
             ("spec_ngram_int8_kv8", "ngram",
              dict(quantize="int8", kv_dtype="int8")),
             ("spec_ngram_int4", "ngram",
              dict(quantize="int4", quant_group=128)),
             ("spec_ngram_tp2", "ngram", dict(tp=2)),
             ("spec_partial", "partial", {}),
             ("spec_partial_int8_kv8", "partial",
              dict(quantize="int8", kv_dtype="int8")))
#: the rows whose drafts the target must accept in part (0 < accepted <
#: drafted, with rollbacks): the random model's greedy output repeats its
#: prompt, which the plain n-gram drafter predicts in full
SPEC_PARTIAL = ("spec_partial", "spec_partial_int8_kv8")
SPEC_REQUESTS = 32
SPEC_K = 4
#: a speculative stream may leave the plain run's only where the engine's
#: own prefill program's top-2 logits are this close at the first
#: difference: the verify step (cuBLAS at M = B W, fp32 attention over
#: gathered pages) and the decode step (#12, or #15 per-op) round apart,
#: by up to TOL_FUSED through 12 layers; with int8 pages a code may also
#: round the other way (TOL_LOGITS_INT8KV)
TOL_SPEC_TIE = {"float32": TOL_FUSED, "int8": TOL_LOGITS_INT8KV}


def spec_traffic(seed, n):
    """``n`` requests of 32-128 new tokens: three in four repeat a random
    3-8 token phrase to 16-128 tokens (code, templates and chat quoting
    itself: what prompt lookup is for), one in four is random."""
    rng = np.random.default_rng(seed + 2300)
    V = WIDTHS["vocab_size"]
    reqs = []
    for i in range(n):
        L = int(rng.integers(16, 129))
        if i % 4 == 3:
            prompt = rng.integers(0, V, L)
        else:
            phrase = rng.integers(0, V, int(rng.integers(3, 9)))
            prompt = np.tile(phrase, L // len(phrase) + 1)[:L]
        reqs.append(([int(t) for t in prompt], int(rng.integers(32, 129))))
    return reqs


def own_margin(torch, eng, seq):
    """The top-2 margin of the last logits of ``eng``'s own prefill
    program over ``seq``, on a fresh one-sequence pool of its KV format."""
    cfg = eng.cfg
    pps = -(-len(seq) // PAGE)
    shape = (cfg.num_layers, cfg.num_kv_heads, pps + 1, PAGE, cfg.head_dim)
    kp = fresh_pool(torch, eng.kv_dtype, shape, DEV)
    vp = fresh_pool(torch, eng.kv_dtype, shape, DEV)
    row = torch.arange(1, pps + 1, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        for c0 in range(0, len(seq), CHUNK):
            n = min(CHUNK, len(seq) - c0)
            toks = torch.zeros(CHUNK, dtype=torch.int64, device=DEV)
            toks[:n] = torch.tensor(seq[c0:c0 + n])
            _, _, _, last = eng._prefill_fn(eng.params, kp, vp, toks, c0, n,
                                            row)
    top2 = torch.topk(last, 2).values
    return float(top2[0] - top2[1])


def partial_drafter(seed):
    """An n-gram drafter that changes one token, at a seeded random place,
    of half its drafts: the verify then rejects the tail from there, and
    the rejected positions' pages are rolled back, at a rate strictly
    between 0 and 1."""
    from mxnet_tpu_torch.serving.speculate import NGramDrafter

    class PartialDrafter(NGramDrafter):
        name = "partial"

        def __init__(self):
            super().__init__()
            self.rng = np.random.default_rng(seed + 2301)

        def propose(self, owner, context, k):
            out = super().propose(owner, context, k)
            if out and self.rng.random() < 0.5:
                i = int(self.rng.integers(len(out)))
                out[i] = (out[i] + 1) % WIDTHS["vocab_size"]
            return out
    return PartialDrafter()


class SpecDriven:
    """One speculative engine's run, counted from outside: its plain decode
    steps and prefill chunks, its verify steps (by width, each timed by
    CUDA events recorded around the call and read after the run) and the
    draft model's decode steps and chunks."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        self.n = dict(steps=0, chunks=0, draft_steps=0, draft_chunks=0)
        self.verifies, self.events = [], []
        drafter = eng._spec.drafter if eng._spec is not None else None
        self.saved = [(eng, k, getattr(eng, k)) for k in (
            "_decode_fn", "_prefill_fn", "_verify_fn")]
        if hasattr(drafter, "_decode_fn"):
            self.saved += [(drafter, k, getattr(drafter, k))
                           for k in ("_decode_fn", "_prefill_fn")]
        for obj, k, fn in self.saved:
            setattr(obj, k, self._wrap(obj is eng, k, fn))

    def _wrap(self, target, k, fn):
        torch = self.torch
        if k == "_verify_fn":
            def verify_fn(width):
                step = fn(width)

                def timed(*a):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    out = step(*a)
                    e.record()
                    self.verifies.append(width)
                    self.events.append((s, e))
                    return out
                return timed
            return verify_fn
        name = ("" if target else "draft_") + (
            "steps" if k == "_decode_fn" else "chunks")

        def counted(*a):
            self.n[name] += 1
            return fn(*a)
        return counted

    def restore(self):
        """Put the methods back; the verify steps' device ms."""
        for obj, k, fn in self.saved:
            setattr(obj, k, fn)
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def spec_launches(eng, drv):
    """The kernel launches of a speculative run's path: its plain decode
    steps and prefill chunks (``path_launches``), each verify step's
    census (``verify_launch_stats``: #1, and #8/#9 under quantized
    weights), and the draft model's per-op decode steps (#15 and #1 a
    layer) and chunks (#1 a layer)."""
    want = path_launches(eng, drv.n["steps"], drv.n["chunks"])
    fmt = None if eng.quant is None else (
        "quant_matmul_w8" if eng.quant[0] == "int8" else "quant_matmul_w4")
    for width in drv.verifies:
        for k, n in eng.verify_launch_stats(width)["kernels"].items():
            want[fmt if k == "quant_matmul" else k] += n
    if drv.n["draft_steps"] or drv.n["draft_chunks"]:
        Ld = eng._spec.drafter.cfg.num_layers
        want["paged_attention"] += drv.n["draft_steps"] * Ld
        want["bias_gelu"] += (drv.n["draft_steps"]
                              + drv.n["draft_chunks"]) * Ld
    return want


def spec_serve(torch, lm, reqs, label, drafter, speculate, tp=1, **kw):
    """``reqs`` through a fresh engine (fused decode asked for; the
    engine's defaults otherwise), with speculation (``spec_k`` SPEC_K) or
    without; the run's launches held to its path.  Returns (engine,
    streams, counts, numbers)."""
    from mxnet_tpu_torch.serving import DecodeEngine
    os.environ["MXNET_DECODE_FUSED"] = "1"
    if drafter == "partial":
        drafter = partial_drafter(0)
    eng = DecodeEngine(lm, name="smoke", slots=SLOTS, page_size=PAGE,
                       max_ctx=MAX_CTX, prefill_chunk=CHUNK, device=DEV,
                       sharding=tp_sharding(tp) if tp > 1 else None,
                       speculate=speculate, spec_k=SPEC_K,
                       drafter=drafter if speculate else None, **kw)
    eng.warmup()
    torch.cuda.synchronize()
    launch_counts(reset=True)
    drv = SpecDriven(torch, eng)
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = [f.result(timeout=900)["tokens"] for f in futs]
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if not eng.stop():
        raise AssertionError("engine worker did not stop")
    verify_ms = drv.restore()
    eng.alloc.check_leaks()
    if eng.alloc.num_used:
        raise AssertionError("%s: %d pages still held after stop"
                             % (label, eng.alloc.num_used))
    for (p, n), o in zip(reqs, outs):
        if len(o) != n:
            raise AssertionError("%s: a request ended early" % label)
    check_launches("spec " + label, counts, spec_launches(eng, drv), [])
    snap = eng.metrics.snapshot()["models"]["smoke"]
    c, gen = snap["counters"], snap["generate"]
    tokens = sum(len(o) for o in outs)
    st = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
              decode_steps=c["decode_steps_total"],
              tokens_per_step_p50=gen["tokens_per_step"].get("p50"),
              plain_steps=drv.n["steps"], verify_steps=len(verify_ms),
              verify_p50_ms=pct(verify_ms, 50),
              drafted=c["spec_draft_tokens_total"],
              accepted=c["spec_accepted_tokens_total"],
              draft_p50_ms=(gen.get("speculative") or {}).get(
                  "draft_step", {}).get("p50_ms"),
              draft_model_steps=drv.n["draft_steps"],
              draft_model_chunks=drv.n["draft_chunks"],
              rollbacks=c["spec_rollbacks_total"],
              launches={k: v for k, v in counts.items() if v})
    return eng, outs, counts, st


def spec_phase(torch, lm, seed):
    """Speculative decoding on the full-width model: SPEC_REQUESTS
    requests of ``spec_traffic`` per row of SPEC_RUNS, each row served
    without speculation, then with it (k up to SPEC_K).  Per row: tokens/s
    beside the plain run's, the accepted / drafted rate, tokens a step
    (p50), the verify step's device time (p50, CUDA events), the draft's
    host time (p50), the streams equal to the plain run's (a difference
    allowed only at a near-tie of the engine's own prefill program, each
    printed) and the launches, held to the path.  Returns the phase's
    launch counts (the speculative runs')."""
    reqs = spec_traffic(seed, SPEC_REQUESTS)
    total = dict.fromkeys(KERNELS, 0)
    plain = {}
    rows = {}
    for label, drafter, kw in SPEC_RUNS:
        key = json.dumps(kw, sort_keys=True)
        if key not in plain:
            plain[key] = spec_serve(torch, lm, reqs, label + "_plain", None,
                                    False, **kw)
        peng, pouts, _, pst = plain[key]
        eng, outs, counts, st = spec_serve(torch, lm, reqs, label, drafter,
                                           True, **kw)
        for k in KERNELS:
            total[k] += counts[k]
        same, ties = 0, []
        tol = TOL_SPEC_TIE[eng.kv_dtype]
        for (p, _), got, want in zip(reqs, outs, pouts):
            if got == want:
                same += 1
                continue
            i = next((j for j, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            margin = own_margin(torch, eng, p + got[:i])
            ties.append((i, margin))
            log("%s: stream leaves the plain run's at %d; the engine's own "
                "top-2 margin there %.3g (tol %g)" % (label, i, margin, tol))
            if not margin < tol:
                raise AssertionError("%s: a speculative stream differs from "
                                     "plain decode without a near-tie"
                                     % label)
        st.update(plain_tokens_per_s=pst["tokens_per_s"],
                  plain_decode_steps=pst["decode_steps"],
                  speedup=st["tokens_per_s"] / pst["tokens_per_s"],
                  streams_equal=same, near_ties=len(ties))
        rate = st["accepted"] / max(1, st["drafted"])
        log("spec %s (drafter %s, decode %s, weights %s, kv %s, tp %d, %s "
            "loop, k <= %d): %d requests, %d tokens in %.3f s = %.1f tokens/s "
            "vs %.1f plain (%.3fx); accepted/drafted %d/%d = %.3f; %d decode "
            "steps (%d plain) vs %d plain, tokens a step p50 %s; %d verify "
            "steps p50 %.3f ms (device, CUDA events); draft p50 %s ms (host); "
            "draft model %d steps, %d chunks; %d rollbacks; streams equal to "
            "plain %d of %d, %d near-tie differences; launches %s"
            % (label, drafter, "fused" if eng.decode_fused else "per-op",
               eng.quant and "/".join(map(str, eng.quant)), eng.kv_dtype,
               eng.tp, "async" if eng.async_decode else "sync", SPEC_K,
               len(reqs), st["tokens"], st["wall_s"], st["tokens_per_s"],
               pst["tokens_per_s"], st["speedup"], st["accepted"],
               st["drafted"], rate, st["decode_steps"], st["plain_steps"],
               pst["decode_steps"], st["tokens_per_step_p50"],
               st["verify_steps"], st["verify_p50_ms"], st["draft_p50_ms"],
               st["draft_model_steps"], st["draft_model_chunks"],
               st["rollbacks"], same, len(reqs), len(ties), st["launches"]))
        if not st["verify_steps"] or not st["drafted"]:
            raise AssertionError("%s: no verify step ran" % label)
        if label in SPEC_PARTIAL and not (
                0 < st["accepted"] < st["drafted"] and st["rollbacks"]):
            raise AssertionError("%s: the drafts were not accepted in part"
                                 % label)
        rows[label] = st
    log("spec rows: %s" % json.dumps(rows))
    return total


def session_pages(torch, eng, sid):
    """A parked session's pages (codes and scales for int8) on the card."""
    idx = torch.tensor(eng.alloc.pages(eng._sessions[sid].owner),
                       device=DEV)
    if eng.kv_dtype == "int8":
        return [t[:, :, idx] for t in (eng._kp.q, eng._vp.q, eng._kp.s,
                                       eng._vp.s)]
    return [eng._kp[:, :, idx], eng._vp[:, :, idx]]


def session_phase(torch, lm, seed):
    """Decode sessions on the fused tp 1 engine: ``SESSIONS`` two-turn
    conversations (64 prompt tokens and 32 new, then 32 more and 32 new),
    each continuation held against the one-shot request over the whole
    conversation; ``SESSION_EXPORTS`` parked sessions exported and imported
    into a second engine on the same weights, pages bit-equal and a third
    turn equal on both; then the same export and import between two int8-KV
    engines (v2 blobs, with scales).  Returns the phase's launch counts."""
    from mxnet_tpu_torch.serving import DecodeEngine, unpack_session
    os.environ["MXNET_DECODE_FUSED"] = "1"
    rng = np.random.default_rng(seed + 2000)
    V = WIDTHS["vocab_size"]

    def toks(n):
        return rng.integers(0, V, n).tolist()

    def engine(**kw):
        eng = DecodeEngine(lm, name="smoke", slots=SLOTS, page_size=PAGE,
                           max_ctx=MAX_CTX, prefill_chunk=CHUNK, device=DEV,
                           **kw)
        eng.warmup()
        return eng

    def turn(eng, prompts, n, sids, resume):
        futs = [eng.submit(p, max_new_tokens=n, session=s, resume=resume)
                for p, s in zip(prompts, sids)]
        return [f.result(timeout=900)["tokens"] for f in futs]

    engines = {"e1": engine(), "e2": engine(),
               "i1": engine(kv_dtype="int8"), "i2": engine(kv_dtype="int8")}
    torch.cuda.synchronize()
    launch_counts(reset=True)
    runs_driven = {k: Driven(torch, e) for k, e in engines.items()}
    e1, e2, i1, i2 = (engines[k] for k in ("e1", "e2", "i1", "i2"))
    sids = ["s%d" % i for i in range(SESSIONS)]
    t1 = [toks(64) for _ in sids]
    r1 = turn(e1, t1, 32, sids, False)
    t2 = [toks(32) for _ in sids]
    r2 = turn(e1, t2, 32, sids, True)
    one = turn(e1, [a + b + c for a, b, c in zip(t1, r1, t2)], 32,
               [None] * SESSIONS, False)
    same = sum(a == b for a, b in zip(r2, one))
    log("sessions: %d two-turn sessions on %s; continuations equal to the "
        "one-shot stream for %d of %d" % (SESSIONS, "fused tp 1", same,
                                          SESSIONS))
    if same != SESSIONS:
        raise AssertionError("session continuations differ from one-shot")
    for src, dst, label, kv in ((e1, e2, "fp", "float32"),
                                (i1, i2, "int8 KV", "int8")):
        moved = sids[:SESSION_EXPORTS]
        if kv == "int8":
            turn(src, t1[:SESSION_EXPORTS], 32, moved, False)
        sizes = []
        t = time.perf_counter()
        for sid in moved:
            blob = src.export_session(sid)
            sizes.append(len(blob))
            _, _, _, ks, _ = unpack_session(blob, with_scales=True)
            if (ks is not None) != (kv == "int8"):
                raise AssertionError("%s blob has the wrong format" % label)
            dst.import_session(blob)
            for a, b in zip(session_pages(torch, src, sid),
                            session_pages(torch, dst, sid)):
                if not torch.equal(a, b):
                    raise AssertionError("imported %s pages differ" % label)
        ms = (time.perf_counter() - t) * 1e3
        t3 = [toks(16) for _ in moved]
        a = turn(src, t3, 16, moved, True)
        b = turn(dst, t3, 16, moved, True)
        log("sessions %s: %d exported and imported (blobs %d-%d bytes, %.1f "
            "ms host for the lot, pages bit-equal); continuations on the "
            "importer equal the exporter's for %d of %d"
            % (label, len(moved), min(sizes), max(sizes), ms,
               sum(x == y for x, y in zip(a, b)), len(moved)))
        if a != b:
            raise AssertionError("imported %s sessions continue otherwise"
                                 % label)
    counts = launch_counts()
    want, runs = dict.fromkeys(KERNELS, 0), []
    for k, eng in engines.items():
        if not eng.stop():
            raise AssertionError("engine worker did not stop")
        drv = runs_driven[k]
        chunks = len(drv.restore())
        steps = eng.metrics.snapshot()["models"]["smoke"]["counters"][
            "decode_steps_total"]
        runs.append(("sessions " + k, drv, steps))
        for name, n in path_launches(eng, steps, chunks).items():
            want[name] += n
        if eng.alloc.num_used:
            raise AssertionError("sessions: pages left after stop")
    check_launches("sessions", counts, want, runs)
    return counts


# quantized tensor-parallel serving runs: (label, tp, engine arguments)
QUANT_TP_RUNS = (("int8_kv8_tp2", 2, dict(quantize="int8", kv_dtype="int8")),
                 ("int4_tp4", 4, dict(quantize="int4", quant_group=128)))


def check_quant_tp(torch, runs, seqs, tf8, fp_ref, cfg):
    """The quantized TP runs' logits, teacher-forced through each engine's
    own prefill and decode programs: int8 weights + int8 KV at tp 2
    against the tp 1 int8_kv8 engine's (``tf8``; the codes and each KV
    head's scale latch are the same at any tp, but the row-parallel sums
    run in another order, so K and V can round to neighbouring codes:
    ``TOL_LOGITS_INT8KV``); int4 at tp 4 against ``full_forward`` over the
    engine's own tp 4 integer weights (``TOL_LOGITS``), with its top-1
    agreement with the fp32 model."""
    eng = runs["int8_kv8_tp2"][0]
    tf = teacher_forced(torch, eng, eng.params, seqs)
    err = max_err(tf, tf8)
    log("teacher-forced int8_kv8_tp2 vs the tp 1 int8_kv8 engine over %d "
        "sequences: max_abs_err %.3g (tol %g); top-1 agreement with the fp32 "
        "model %.4f" % (len(seqs), err, TOL_LOGITS_INT8KV,
                        top1_agreement(tf, fp_ref)))
    if not err <= TOL_LOGITS_INT8KV:
        raise AssertionError("int8/int8-KV tp 2 logits disagree with tp 1")
    eng = runs["int4_tp4"][0]
    tf = teacher_forced(torch, eng, eng.params, seqs)
    err = max_err(tf, full_logits(torch, eng.model.params(tp=4), cfg, seqs))
    log("teacher-forced int4_tp4 vs full_forward(its tp 4 int4 weights) over "
        "%d sequences: max_abs_err %.3g (tol %g); top-1 agreement with the "
        "fp32 model %.4f" % (len(seqs), err, TOL_LOGITS,
                             top1_agreement(tf, fp_ref)))
    if not err <= TOL_LOGITS:
        raise AssertionError("int4 tp 4 logits disagree with full_forward")


def fresh_pool(torch, kv_dtype, shape, dev):
    from mxnet_tpu_torch.ops.kernels import paged_attention as pa
    if kv_dtype == "int8":
        return pa.QPages(q=torch.zeros(shape, dtype=torch.int8, device=dev),
                         s=torch.ones(shape[:3], device=dev))
    return torch.zeros(shape, device=dev)


def params_to(params, dev):
    """A copy of a params dict (fp or quantized leaves) on ``dev``."""
    def leaf(t):
        return (type(t)(*(a.to(dev) for a in t)) if isinstance(t, tuple)
                else t.to(dev))
    return {"embed": leaf(params["embed"]), "pos": leaf(params["pos"]),
            "layers": [{k: leaf(v) for k, v in lp.items()}
                       for lp in params["layers"]]}


def teacher_forced(torch, eng, params, seqs, dev=None):
    """Logits at every position from the middle of each sequence on,
    through the engine's own prefill and decode programs on a fresh
    one-sequence page pool of the engine's KV format on ``dev``; one
    (positions, vocab) tensor per sequence."""
    cfg, out, dev = eng.cfg, [], dev or DEV
    for seq in seqs:
        n_pre = len(seq) // 2
        pps = -(-len(seq) // PAGE)
        shape = (cfg.num_layers, cfg.num_kv_heads, pps + 1, PAGE,
                 cfg.head_dim)
        kp = fresh_pool(torch, eng.kv_dtype, shape, dev)
        vp = fresh_pool(torch, eng.kv_dtype, shape, dev)
        row = torch.arange(1, pps + 1, dtype=torch.int32, device=dev)
        got = []
        for c0 in range(0, n_pre, CHUNK):
            n = min(CHUNK, n_pre - c0)
            toks = torch.zeros(CHUNK, dtype=torch.int64, device=dev)
            toks[:n] = torch.tensor(seq[c0:c0 + n])
            _, _, _, last = eng._prefill_fn(params, kp, vp, toks, c0, n, row)
        got.append(last)
        for t in range(n_pre, len(seq) - 1):
            _, _, _, lg = eng._decode_fn(
                params, kp, vp, torch.tensor([seq[t]], device=dev),
                torch.tensor([t], device=dev), row[None],
                torch.ones(1, dtype=torch.bool, device=dev))
            got.append(lg[0])
        out.append(torch.stack(got).float().to(DEV))
    return out


def full_logits(torch, params, cfg, seqs):
    """``full_forward`` logits at the positions :func:`teacher_forced`
    reads."""
    from mxnet_tpu_torch.models import decoder as dec
    return [dec.full_forward(params, cfg, torch.tensor(
        [seq[:-1]], device=DEV))[0][len(seq) // 2 - 1:] for seq in seqs]


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def top1_agreement(a, b):
    hit = sum(int((x.argmax(-1) == y.argmax(-1)).sum()) for x, y in zip(a, b))
    return hit / sum(x.shape[0] for x in a)


def device_summary(torch, prof, wall):
    """The device's busy share of a profiled window of ``wall`` seconds, its
    number of kernel spans, and the 8 kernels with the most device time
    as (name, ms)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return (100.0 * busy / 1e6 / wall, len(spans),
            "; ".join("%s %.1f" % (k[:60], v / 1e3) for k, v in top))


#: substrings of the flash kernels' names in a profiler trace
FLASH_SPANS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
               "flash_bwd_delta")


def span_ms(torch, prof, keys):
    """Device ms of the kernel spans whose name contains each of ``keys``,
    and of all kernel spans."""
    out = dict.fromkeys(keys, 0.0)
    total = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = (e.time_range.end - e.time_range.start) / 1e3
        total += dur
        for k in keys:
            if k in e.name:
                out[k] += dur
    return out, total


def profile(torch, lm, reqs, fused, sharding=None, async_decode=None,
            **quant):
    """torch.profiler over one engine serving ``reqs`` (``quant``: the
    engine's quantization options; ``async_decode`` its loop): the
    device's busy share of the window and the kernels that took the most
    device time."""
    from torch.profiler import ProfilerActivity
    from mxnet_tpu_torch.serving import DecodeEngine
    os.environ["MXNET_DECODE_FUSED"] = "1" if fused else "0"
    eng = DecodeEngine(lm, name="prof", slots=SLOTS, page_size=PAGE,
                       max_ctx=MAX_CTX, prefill_chunk=CHUNK, device=DEV,
                       sharding=sharding, async_decode=async_decode, **quant)
    eng.warmup()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [eng.submit(p, max_new_tokens=n) for p, n in reqs]:
            f.result(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.stop()
    busy, n, top = device_summary(torch, prof, wall)
    log("profile fused=%s tp=%d%s %s loop: %d requests in %.3f s, device "
        "busy %.1f%% (%d kernel spans); top kernels by device ms: %s"
        % (fused, eng.tp, " %s" % (quant,) if quant else "",
           "async" if eng.async_decode else "sync", len(reqs), wall, busy,
           n, top))


# ---------------------------------------------------------------------------
# phase 4: training BERT-base
# ---------------------------------------------------------------------------
BERT = dict(vocab_size=30522, num_layers=12, units=768, hidden_size=3072,
            num_heads=12, max_length=512, token_types=2)
TRAIN_B, TRAIN_L, TRAIN_STEPS, TRAIN_LR = 32, 128, 10, 1e-4
#: the long-context phase: bench_bert_long's shape (bench.py:1469)
LONG_B, LONG_L, LONG_STEPS = 4, 2048, 3
#: kernel launches of one training step at dropout > 0: FFN1 in 12 layers
#: plus the MLM transform, the two residual joins of 12 layers, and the
#: attention of 12 layers forward and back (the delta kernel in each
#: backward)
PER_STEP = {"bias_gelu": 13, "bias_gelu_backward": 13,
            "bias_dropout_residual_fwd": 24, "bias_dropout_residual_bwd": 24,
            "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
            "flash_attention_bwd_dkv": 12, "flash_attention_bwd_delta": 12}
#: launches of one dropout-free evaluation forward
PER_EVAL = {"bias_gelu": 13, "bias_dropout_residual_fwd": 24,
            "flash_attention_fwd": 12}
# AMP bf16 vs fp32, the training loss of step 1 (the same weights, batch
# and dropout masks): bf16 keeps 8 bits of mantissa, so each GEMM,
# attention and epilogue output carries ~2**-9 relative rounding, which 12
# post-LN layers carry to the logits; the mean cross entropy over 4096
# tokens averages the per-token deviations.  1% of the loss (~0.12 nat)
# allows that, and lies below the ~1.8 nat the fp32 run's 10 steps move it
TOL_AMP_LOSS = 1e-2
# one Adam step, card vs CPU copies at dropout 0: fp32 sums in another
# order over 12 layers.  The loss and each gradient tensor (relative to
# its largest element) agree to ~1e-6; these allow 100x that
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD = 1e-3
# after the step: Adam's first update is lr * g / (|g| + 3.2e-7), so a
# weight moves by at most lr whichever device; a gradient within rounding
# of 0 may move the two copies apart by up to 2 lr.  At most this share
# of weights may differ by more than 1% of lr
TOL_STEP_SHARE = 1e-4


def bert_model(torch, seed, dropout, device, **kw):
    """``BERTModel`` at BERT-base widths (``use_flash=True``), Xavier
    weights from ``seed`` and random biases and LN affines (N(0, 0.1),
    gammas 1 + N(0, 0.1)) drawn on the CPU, so the same seed gives the
    same weights on any device."""
    from mxnet_tpu_torch.models import bert
    net = bert.BERTModel(**dict(BERT, **kw), dropout=dropout, use_flash=True,
                         device=device, seed=seed, init="xavier")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                base = 1.0 if name.endswith("gamma") else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    return net


def pretrain_batch(torch, seed, B, L, device):
    """A fixed MLM + NSP batch from a numpy seed: valid lengths from L/2 to
    L, two segments per row (token types 0 then 1), MLM labels at every
    position, NSP labels."""
    rng = np.random.default_rng(seed)
    valid = rng.integers(L // 2, L + 1, B)
    split = rng.integers(1, valid)
    types = (np.arange(L)[None, :] >= split[:, None]).astype(np.int64)
    V = BERT["vocab_size"]
    arrays = dict(tokens=rng.integers(0, V, (B, L)), types=types,
                  valid=valid, mlm=rng.integers(0, V, (B, L)),
                  nsp=rng.integers(0, 2, B))
    return {k: torch.tensor(v, device=device) for k, v in arrays.items()}


def pretrain_loss(torch, net, batch):
    """Per-sample MLM + NSP cross entropy, (B,)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    ce = SoftmaxCrossEntropyLoss()
    mlm, nsp = net(batch["tokens"], batch["types"], batch["valid"])
    return ce(mlm, batch["mlm"]) + ce(nsp, batch["nsp"])


def train_flops(B, L):
    """Matmul FLOPs of one training step (forward and backward, 3x the
    forward): the layers' GEMMs, attention's two batched products, the MLM
    transform and the tied logits."""
    C, F, V, N = (BERT["units"], BERT["hidden_size"], BERT["vocab_size"],
                  BERT["num_layers"])
    per_token = (N * (2 * (4 * C * C + 2 * C * F) + 4 * L * C)
                 + 2 * C * C + 2 * C * V)
    return 3 * per_token * B * L


def train(torch, seed, label, B, L, steps, amp=False, profile_steps=0,
          **model_kw):
    """``steps`` Adam steps of BERT-base at dropout 0.1 on a fixed batch
    through the user's entry points (wrapped by
    ``amp.convert_hybrid_block(net, "bfloat16")`` when ``amp``); checks
    the loss falls, the launches per step, that every tensor autograd
    saves is on the card and none is a (B, H, L, L) attention matrix, and
    under AMP that the parameters stay fp32 and the kernels ran in
    bfloat16."""
    from mxnet_tpu_torch import amp as amp_mod
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.ops.kernels import epilogue as ep
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    net = bert_model(torch, seed, 0.1, DEV, **model_kw)
    model = amp_mod.convert_hybrid_block(net, "bfloat16") if amp else net
    batch = pretrain_batch(torch, seed, B, L, DEV)
    trainer = Trainer(dict(net.named_parameters()), "adam",
                      {"learning_rate": TRAIN_LR})
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.device.type))
        return t

    def eval_loss():
        net.eval()
        with torch.no_grad():
            out = float(pretrain_loss(torch, model, batch).mean())
        net.train()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    losses, step_ms, evals = [], [], []
    for step in range(steps):
        t = time.perf_counter()
        if step == 0:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = pretrain_loss(torch, model, batch)
        else:
            loss = pretrain_loss(torch, model, batch)
        loss.backward(torch.ones_like(loss))
        trainer.step(B)
        losses.append(float(loss.detach().mean()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if step in (0, steps - 1):
            # the loss without dropout after the first and the last update
            evals.append(eval_loss())
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = statistics.median(step_ms[1:])
    flops = train_flops(B, L)
    log("train %s: BERT-base B=%d L=%d dropout 0.1, Adam lr %g: loss %s; "
        "step p50 %.3f ms (first %.1f ms), %.1f tokens/s, %.2f TFLOP/s of "
        "matmul (%.2f TFLOP per step); peak memory %.2f GB; launches %s"
        % (label, B, L, TRAIN_LR, " ".join("%.4f" % v for v in losses), p50,
           step_ms[0], B * L / p50 * 1e3, flops / p50 / 1e9, flops / 1e12,
           peak_gb, counts))
    log("train %s: loss without dropout after step 1 %.6f, after step %d "
        "%.6f" % (label, evals[0], steps, evals[1]))
    if not (all(np.isfinite(losses + evals)) and evals[1] < evals[0]):
        raise AssertionError("training loss did not fall: %s" % evals)
    want = dict.fromkeys(KERNELS, 0)
    for k, n in PER_STEP.items():
        want[k] = n * steps + PER_EVAL.get(k, 0) * len(evals)
    if counts != want:
        raise AssertionError("training launches do not match the path: %s, "
                             "want %s" % (counts, want))
    H = BERT["num_heads"]
    off = [s for s in saved if s[1] != torch.device(DEV).type]
    shapes = {s[0] for s in saved}
    if off or (B, L) not in shapes or (B, H, L, L) in shapes:
        raise AssertionError("%d saved tensors off the card (first %s), no "
                             "(B, L) among them, or a (B, H, L, L) one"
                             % (len(off), off[:4]))
    log("train %s: %d tensors saved for backward in step 1, all on %s, none "
        "of (B, H, L, L)" % (label, len(saved), DEV))
    if amp:
        wide = [n for n, p in net.named_parameters()
                if p.dtype != torch.float32]
        ran = {"flash_attention": fa.flash_attention.last_dtype,
               "bias_gelu": ep.bias_gelu.last_dtype,
               "bias_gelu_backward": ep.bias_gelu_backward.last_dtype,
               "bias_dropout_residual": ep.bias_dropout_residual.last_dtype}
        log("train %s: parameters not fp32: %d; dtype of each kernel's last "
            "launch: %s" % (label, len(wide), {k: str(v)[6:]
                                               for k, v in ran.items()}))
        if wide or any(v != torch.bfloat16 for v in ran.values()):
            raise AssertionError("AMP: parameters not fp32 %s, or a kernel "
                                 "did not run in bfloat16 %s" % (wide, ran))
    if profile_steps:
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                loss = pretrain_loss(torch, model, batch)
                loss.backward(torch.ones_like(loss))
                trainer.step(B)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, n, top = device_summary(torch, prof, wall)
        log("profile train %s: %d steps in %.3f s, device busy %.1f%% (%d "
            "kernel spans); top kernels by device ms: %s"
            % (label, profile_steps, wall, busy, n, top))
        fl, total = span_ms(torch, prof, FLASH_SPANS)
        log("profile train %s: flash kernels' device ms over %d steps: %s; "
            "%.1f of %.1f device ms (%.1f%%), %.1f%% of the %.1f ms wall"
            % (label, profile_steps, " ".join(
                "%s %.2f" % kv for kv in fl.items()), sum(fl.values()),
               total, 100.0 * sum(fl.values()) / max(total, 1e-9),
               100.0 * sum(fl.values()) / (wall * 1e3), wall * 1e3))
    del model, net, trainer
    torch.cuda.empty_cache()
    return counts, dict(step_p50_ms=p50, tokens_per_s=B * L / p50 * 1e3,
                        first_loss=losses[0], eval_loss_after_first=evals[0],
                        eval_loss_after_last=evals[1],
                        peak_memory_gb=peak_gb)


def card_vs_cpu_step(torch, seed):
    """One Adam step of BERT-base at dropout 0, B 2, L 32, on the card and
    on the CPU (the plain versions) from the same weights and batch: the
    loss, every gradient and the updated weights agree."""
    from mxnet_tpu_torch.gluon import Trainer
    B, L = 2, 32
    res = {}
    for dev in (DEV, "cpu"):
        net = bert_model(torch, seed + 1, 0.0, dev)
        trainer = Trainer(dict(net.named_parameters()), "adam",
                          {"learning_rate": TRAIN_LR})
        loss = pretrain_loss(torch, net, pretrain_batch(torch, seed + 1, B,
                                                        L, dev))
        loss.backward(torch.ones_like(loss))
        grads = {n: p.grad.detach().cpu() for n, p in net.named_parameters()}
        trainer.step(B)
        res[dev] = (loss.detach().cpu(), grads,
                    {n: p.detach().cpu() for n, p in net.named_parameters()})
        del net, trainer
    (lc, gc, wc), (lp, gp, wp) = res[DEV], res["cpu"]
    loss_err = float(((lc - lp).abs() / lp.abs()).max())
    grad_err = max(float((gc[n] - gp[n]).abs().max())
                   / max(float(gp[n].abs().max()), 1e-30) for n in gp)
    w_max = max(float((wc[n] - wp[n]).abs().max()) for n in wp)
    far = sum(int(((wc[n] - wp[n]).abs() > 0.01 * TRAIN_LR).sum())
              for n in wp)
    share = far / sum(t.numel() for t in wp.values())
    log("one Adam step, card vs CPU copies (B=%d L=%d dropout 0): loss rel "
        "err %.3g (tol %g); gradients max err / tensor max %.3g (tol %g); "
        "weights max abs diff %.3g (bound 2 lr = %g), share beyond 1%% of lr "
        "%.3g (tol %g)" % (B, L, loss_err, TOL_STEP_LOSS, grad_err,
                           TOL_STEP_GRAD, w_max, 2 * TRAIN_LR, share,
                           TOL_STEP_SHARE))
    if not (loss_err <= TOL_STEP_LOSS and grad_err <= TOL_STEP_GRAD
            and w_max <= 2 * TRAIN_LR and share <= TOL_STEP_SHARE):
        raise AssertionError("training step on the card disagrees with the "
                             "CPU")


# ---------------------------------------------------------------------------
# phase 5: training the LSTM word LM
# ---------------------------------------------------------------------------
#: the word LM of the reference's example/rnn/word_lm, "medium" config, as
#: bench.py config 5 runs it (bench.py:1891-1929): Embedding(10000, 650),
#: LSTM(650, 2 layers, NTC), Dense(10000); bptt 35, batch 32, SGD lr 0.1
LM = dict(vocab=10000, emsize=650, nhid=650, nlayers=2)
LM_B, LM_T, LM_STEPS, LM_LR = 32, 35, 10, 0.1
#: kernel launches of one training step (one per layer each way) and of
#: one loss evaluation (forward only)
LM_PER_STEP = {"lstm_sequence_fwd": 2, "lstm_sequence_bwd": 2,
               "lstm_sequence_bwd_gates": 2}
LM_PER_EVAL = {"lstm_sequence_fwd": 2}
# AMP bf16 vs fp32, the loss of step 1 (the same weights and tokens): bf16
# rounds the embedding, the i2h products, h and the decoder's inputs to 8
# bits of mantissa (~2**-9 relative each); the mean cross entropy over
# 1120 tokens averages the per-token deviations.  1% of the loss (~0.09
# nat at ln 10000) allows that
TOL_LM_AMP_LOSS = 1e-2
# one SGD step of the small word LM, card vs CPU copies: fp32 sums in
# another order through 8 steps of 2 layers, ~1e-6 relative; these allow
# 100x that.  SGD moves a weight by lr g / B, so the weights stay within
# lr / B times the gradients' difference
TOL_LM_STEP_LOSS = 1e-4
TOL_LM_STEP_GRAD = 1e-4
TOL_LM_STEP_W = 1e-5


def synthetic_corpus(n_tokens, vocab, seed):
    """The Zipf-plus-bigram token stream of
    ``example/gluon/word_language_model.py:41-51``: half the tokens follow
    (prev * 31 + 7) % vocab, half are drawn from a 1/rank unigram, so the
    model has something to learn."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    toks = [int(rng.choice(vocab, p=p))]
    for _ in range(n_tokens - 1):
        prev = toks[-1]
        toks.append((prev * 31 + 7) % vocab if rng.rand() < 0.5
                    else int(rng.choice(vocab, p=p)))
    return np.array(toks, "int64")


def word_lm(torch, seed, device, vocab, emsize, nhid, nlayers):
    """The word LM from the port's blocks: Xavier weights from ``seed``
    and random biases (N(0, 0.1), which the initializer leaves at 0, where
    a kernel that dropped b_h2h would still agree), drawn on the CPU so the
    same seed gives the same model on any device.  ``net(x, states)``
    returns (logits, states)."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import nn as gnn, rnn as grnn

    class WordLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = gnn.Embedding(vocab, emsize, device=device)
            self.lstm = grnn.LSTM(nhid, num_layers=nlayers, layout="NTC",
                                  input_size=emsize, device=device)
            self.decoder = gnn.Dense(vocab, flatten=False, in_units=nhid,
                                     device=device)

        def forward(self, x, states):
            out, states = self.lstm(self.embed(x), states)
            return self.decoder(out), states

    net = WordLM()
    gen = torch.Generator().manual_seed(seed)
    init = initializer.Xavier()
    for name, p in net.named_parameters():
        init(name, p, gen)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return net


def lm_segments(torch, seed, B, T, steps, vocab, device):
    """(inputs, targets) of ``steps`` consecutive bptt segments of a
    corpus of B (steps T + 1) tokens, batchified as the example does."""
    n = steps * T + 1
    data = torch.tensor(synthetic_corpus(B * n, vocab, seed).reshape(B, n),
                        device=device)
    return [(data[:, s * T:(s + 1) * T], data[:, s * T + 1:(s + 1) * T + 1])
            for s in range(steps)]


def train_lm(torch, seed, label, amp=False, profile_steps=0):
    """``LM_STEPS`` SGD steps of the 2 x 650 word LM through the user's
    entry points (wrapped by ``amp.convert_hybrid_block(net, "bfloat16")``
    when ``amp``), truncated BPTT: step s trains on segment s from the
    (hT, cT) of step s - 1, detached.  Checks the loss on segment 0 with
    zero state falls from before step 1 to after the last, two launches
    of each LSTM kernel per step, every tensor autograd saves on the
    card, and under AMP fp32 parameters and bf16 kernels."""
    from mxnet_tpu_torch import amp as amp_mod
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.kernels import fused_cell as fc
    net = word_lm(torch, seed, DEV, **LM)
    model = amp_mod.convert_hybrid_block(net, "bfloat16") if amp else net
    segs = lm_segments(torch, seed, LM_B, LM_T, LM_STEPS, LM["vocab"], DEV)
    trainer = Trainer(dict(net.named_parameters()), "sgd",
                      {"learning_rate": LM_LR})
    ce = SoftmaxCrossEntropyLoss()
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.device.type))
        return t

    def eval_loss():
        with torch.no_grad():
            x, y = segs[0]
            logits, _ = model(x, net.lstm.begin_state(LM_B))
            return float(ce(logits, y).mean())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    evals = [eval_loss()]
    states = net.lstm.begin_state(LM_B)
    losses, step_ms = [], []
    for step, (x, y) in enumerate(segs):
        t = time.perf_counter()
        states = [s.detach() for s in states]
        if step == 0:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                logits, states = model(x, states)
                loss = ce(logits, y)
        else:
            logits, states = model(x, states)
            loss = ce(logits, y)
        loss.backward(torch.ones_like(loss))
        trainer.step(LM_B)
        losses.append(float(loss.detach().mean()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    evals.append(eval_loss())
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p50 = statistics.median(step_ms[1:])
    log("train %s: LSTM word LM (vocab %d, %d x %d) B=%d T=%d, SGD lr %g, "
        "truncated BPTT: loss %s; step p50 %.3f ms (first %.1f ms), %.1f "
        "tokens/s; peak memory %.2f GB; launches %s"
        % (label, LM["vocab"], LM["nlayers"], LM["nhid"], LM_B, LM_T, LM_LR,
           " ".join("%.4f" % v for v in losses), p50, step_ms[0],
           LM_B * LM_T / p50 * 1e3, peak_gb, counts))
    log("train %s: loss on segment 0 from zero state before step 1 %.6f, "
        "after step %d %.6f" % (label, evals[0], LM_STEPS, evals[1]))
    if not (all(np.isfinite(losses + evals)) and evals[1] < evals[0]):
        raise AssertionError("LSTM LM loss did not fall: %s" % evals)
    want = dict.fromkeys(KERNELS, 0)
    for k, n in LM_PER_STEP.items():
        want[k] = n * LM_STEPS + LM_PER_EVAL.get(k, 0) * len(evals)
    if counts != want:
        raise AssertionError("LSTM LM launches do not match the path: %s, "
                             "want %s" % (counts, want))
    off = [s for s in saved if s[1] != torch.device(DEV).type]
    if off or not saved:
        raise AssertionError("%d of %d saved tensors off the card (first %s)"
                             % (len(off), len(saved), off[:4]))
    log("train %s: %d tensors saved for backward in step 1, all on %s"
        % (label, len(saved), DEV))
    if amp:
        wide = [n for n, p in net.named_parameters()
                if p.dtype != torch.float32]
        ran = fc.lstm_sequence.last_dtype
        log("train %s: parameters not fp32: %d; dtype of the LSTM kernels' "
            "last launch: %s" % (label, len(wide), str(ran)[6:]))
        if wide or ran != torch.bfloat16:
            raise AssertionError("AMP: parameters not fp32 %s, or the LSTM "
                                 "kernels did not run in bfloat16 (%s)"
                                 % (wide, ran))
    busy = None
    if profile_steps:
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for x, y in segs[:profile_steps]:
                states = [s.detach() for s in states]
                logits, states = model(x, states)
                loss = ce(logits, y)
                loss.backward(torch.ones_like(loss))
                trainer.step(LM_B)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, n, top = device_summary(torch, prof, wall)
        log("profile train %s: %d steps in %.3f s, device busy %.1f%% (%d "
            "kernel spans); top kernels by device ms: %s"
            % (label, profile_steps, wall, busy, n, top))
        fl, total = span_ms(torch, prof, FLASH_SPANS)
        log("profile train %s: flash kernels' device ms over %d steps: %s; "
            "%.1f of %.1f device ms (%.1f%%), %.1f%% of the %.1f ms wall"
            % (label, profile_steps, " ".join(
                "%s %.2f" % kv for kv in fl.items()), sum(fl.values()),
               total, 100.0 * sum(fl.values()) / max(total, 1e-9),
               100.0 * sum(fl.values()) / (wall * 1e3), wall * 1e3))
    del model, net, trainer
    torch.cuda.empty_cache()
    return counts, dict(step_p50_ms=p50, tokens_per_s=LM_B * LM_T / p50 * 1e3,
                        first_loss=losses[0], eval_loss_before=evals[0],
                        eval_loss_after=evals[1], peak_memory_gb=peak_gb,
                        device_busy_pct=busy)


def lm_card_vs_cpu_step(torch, seed):
    """One SGD step of a small word LM (vocab 100, 2 x 64, B 4, T 8), from
    a nonzero carried state, on the card (the LSTM kernels) and on the CPU
    (the plain versions) from the same weights and tokens: the loss, every
    gradient and the updated weights agree."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    B, T, cfg = 4, 8, dict(vocab=100, emsize=64, nhid=64, nlayers=2)
    res = {}
    for dev in (DEV, "cpu"):
        net = word_lm(torch, seed + 2, dev, **cfg)
        trainer = Trainer(dict(net.named_parameters()), "sgd",
                          {"learning_rate": LM_LR})
        (x0, _), (x, y) = lm_segments(torch, seed + 2, B, T, 2, cfg["vocab"],
                                      dev)
        with torch.no_grad():
            _, states = net(x0, net.lstm.begin_state(B))
        logits, _ = net(x, states)
        loss = SoftmaxCrossEntropyLoss()(logits, y)
        loss.backward(torch.ones_like(loss))
        grads = {n: p.grad.detach().cpu() for n, p in net.named_parameters()}
        trainer.step(B)
        res[dev] = (loss.detach().cpu(), grads,
                    {n: p.detach().cpu() for n, p in net.named_parameters()})
    (lc, gc, wc), (lp, gp, wp) = res[DEV], res["cpu"]
    loss_err = float(((lc - lp).abs() / lp.abs()).max())
    grad_err = max(rel_err(gc[n], gp[n]) for n in gp)
    w_err = max(float((wc[n] - wp[n]).abs().max()) for n in wp)
    log("one SGD step of the word LM (vocab 100, 2 x 64, B %d, T %d, carried "
        "state), card vs CPU copies: loss rel err %.3g (tol %g); gradients "
        "max err / tensor max %.3g (tol %g); weights max abs diff %.3g (tol "
        "%g)" % (B, T, loss_err, TOL_LM_STEP_LOSS, grad_err, TOL_LM_STEP_GRAD,
                 w_err, TOL_LM_STEP_W))
    if not (loss_err <= TOL_LM_STEP_LOSS and grad_err <= TOL_LM_STEP_GRAD
            and w_err <= TOL_LM_STEP_W):
        raise AssertionError("word LM step on the card disagrees with the "
                             "CPU")


# ---------------------------------------------------------------------------
# phase 6: the array and op core (mx.np, mx.npx, mx.autograd on the card)
# ---------------------------------------------------------------------------
#: the BERT-base encoder through np/npx: B, L, dropout, steps in fp32
NP_B, NP_L, NP_DROPOUT, NP_STEPS = 32, 128, 0.1, 3
#: kernel launches of one np/npx encoder step (forward and backward, 12
#: layers): FFN1's bias + GELU, the two residual joins, the attention
NP_PER_STEP = {"bias_gelu": 12, "bias_gelu_backward": 12,
               "bias_dropout_residual_fwd": 24,
               "bias_dropout_residual_bwd": 24, "flash_attention_fwd": 12,
               "flash_attention_bwd_dq": 12, "flash_attention_bwd_dkv": 12,
               "flash_attention_bwd_delta": 12}
#: of one npx.rnn LSTM forward and backward over 2 layers
NP_RNN_LAUNCHES = {"lstm_sequence_fwd": 2, "lstm_sequence_bwd": 2,
                   "lstm_sequence_bwd_gates": 2}
# the np/npx encoder against the torch-native BERTEncoder on the same
# weights at dropout 0: the same kernels on the same shapes, the graphs
# built by different code (split views vs indexing), so fp32 sums may
# differ in order only; the output and each gradient within 1e-5 of the
# tensor's largest element
TOL_NP_ENCODER = 1e-5
# npx.rnn against gluon.rnn.LSTM on the same weights: the same kernels
TOL_NP_LSTM = 1e-6
# the np program at B 2, L 32 on the card and on the CPU (plain
# versions), hash dropout 0.1: fp32 in another order through 12 layers
# (as card_vs_cpu_step); 1e-4 of each gradient's largest element
TOL_NP_CARD_CPU = 1e-4


def encoder_weights(torch, seed, device):
    """The port's torch-native ``BERTEncoder`` at BERT-base widths with
    weights N(0, 0.02) and biases / LN affines N(0, 0.1) (gammas about 1)
    drawn on the CPU from ``seed``."""
    from mxnet_tpu_torch.models import bert
    net = bert.BERTEncoder(BERT["num_layers"], BERT["units"],
                           BERT["hidden_size"], BERT["num_heads"],
                           dropout=0.0, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                base = 1.0 if name.endswith("gamma") else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return net


def np_params(mx, net, device):
    """The encoder's parameters as mx.np arrays with gradients attached
    (copies of the module's)."""
    out = {}
    for name, p in net.named_parameters():
        a = mx.np.array(p.detach(), ctx=device)
        a.attach_grad()
        out[name] = a
    return out


def np_step(mx, params, x, valid, w, dropout, ffn_dropout=None):
    """One forward and backward of the np/npx encoder with the scalar loss
    mean((out - w)**2): returns (the loss array, the output array); nothing
    waits on the card."""
    from mxnet_tpu_torch.models.bert import encoder_np
    with mx.autograd.record():
        out = encoder_np(params, x, valid, BERT["num_heads"], dropout,
                         ffn_dropout=ffn_dropout)
        loss = ((out - w) ** 2).mean()
    loss.backward()
    return loss, out


def grad_err(torch, got, want):
    """The largest error of ``got`` against ``want`` over each tensor's
    largest element."""
    return max(float((a.detach() - b.detach()).abs().max())
               / max(float(b.detach().abs().max()), 1e-30)
               for a, b in zip(got, want))


def host_dispatch_us(torch, mx, n=2000):
    """Host microseconds of one ``apply_op`` dispatch (``mx.np.add`` on two
    (256,) arrays on the card, recording off) beside ``torch.add`` on
    their tensors: the median of ``n`` calls' perf_counter spans."""
    a = mx.np.ones((256,), ctx=DEV)
    b = mx.np.ones((256,), ctx=DEV)
    ta, tb = a._data, b._data
    out = {}
    for label, fn in (("np.add", lambda: mx.np.add(a, b)),
                      ("torch.add", lambda: torch.add(ta, tb))):
        for _ in range(50):
            fn()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e6)
        torch.cuda.synchronize()
        out[label] = statistics.median(ts)
    return out


def event_ms(torch, fn, iters=5):
    """Median device-timeline ms of ``fn`` between two CUDA events (the
    host runs ahead as it does in training; one warm-up call first)."""
    fn()
    ms = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    return statistics.median(ms)


def lstm_flat_grad(torch, lstm):
    """The gradients of a gluon LSTM's parameters in the order of its flat
    vector (``_flat_params``: weights layer-major, then biases)."""
    sfx = [s for s, _ in lstm._suffixes()]
    leaves = lstm._parameters
    chunks = [leaves[k + s].grad.reshape(-1) for s in sfx
              for k in ("i2h_weight", "h2h_weight")]
    chunks += [leaves[k + s].grad for s in sfx
               for k in ("i2h_bias", "h2h_bias")]
    return torch.cat(chunks)


def array_core_phase(torch, seed):
    """The array and op core on the card.  The main path (counted): the
    BERT-base encoder composed of np/npx ops (``models.bert.encoder_np``,
    the JAX package's composition) with ``np.ndarray`` parameters under
    ``autograd.record()``, NP_STEPS forward + backward steps in fp32 at
    dropout 0.1 and one under AMP bf16 (``amp.init`` + ``amp.op_scope``),
    each step's launches held to NP_PER_STEP; then the 2 x 650 LSTM
    through ``npx.rnn`` on one flat parameter vector, forward and
    backward (NP_RNN_LAUNCHES).  Then the checks: every ``.grad`` on the
    card; at dropout 0 the encoder's output and gradients against the
    port's ``BERTEncoder`` on the same weights; the LSTM against
    ``gluon.rnn.LSTM``; the encoder at B 2, L 32 with hash dropout 0.1 on
    the card and on the CPU (the same masks for one seed); ``nd.save`` /
    ``nd.load`` round trips, npz and legacy; the np/npx step beside the
    torch-native step (CUDA events) and the host microseconds of one
    ``apply_op`` dispatch.  Returns the main path's launches."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon import rnn as grnn
    from mxnet_tpu_torch.ops import rnn as orn
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    t0 = time.perf_counter()
    C = BERT["units"]
    net = encoder_weights(torch, seed + 5, DEV)
    params = np_params(mx, net, DEV)
    rng = np.random.default_rng(seed + 5)
    x_np = rng.standard_normal((NP_B, NP_L, C)).astype(np.float32)
    w_np = rng.standard_normal((NP_B, NP_L, C)).astype(np.float32)
    valid_np = rng.integers(NP_L // 2, NP_L + 1, NP_B).astype(np.int32)
    x = mx.np.array(x_np, ctx=DEV)
    w = mx.np.array(w_np, ctx=DEV)
    valid = mx.np.array(valid_np, ctx=DEV)
    # -- the main path, counted -------------------------------------------
    torch.cuda.synchronize()
    launch_counts(reset=True)
    losses, prev = [], launch_counts()
    for step in range(NP_STEPS + 1):
        bf16 = step == NP_STEPS
        if step in (0, NP_STEPS):
            # the AMP step draws the dropout masks of step 0 again
            mx.random.seed(seed)
        if bf16:
            saved_target = amp._TARGET
            amp.init("bfloat16")
            with amp.op_scope():
                loss, out = np_step(mx, params, x, valid, w, NP_DROPOUT)
            amp._TARGET = saved_target
            if out.dtype != mx.np.bfloat16 or fa.flash_attention.last_dtype \
                    != torch.bfloat16:
                raise AssertionError("np/npx encoder under AMP: output %s, "
                                     "flash kernels %s" % (
                                         out.dtype,
                                         fa.flash_attention.last_dtype))
        elif step == 1:
            # the step enqueues without a host wait: an operation that
            # synchronises the stream raises here
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss, out = np_step(mx, params, x, valid, w, NP_DROPOUT)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            loss, out = np_step(mx, params, x, valid, w, NP_DROPOUT)
        losses.append(float(loss))
        now = launch_counts()
        got = {k: now[k] - prev[k] for k in KERNELS}
        prev = now
        want = dict.fromkeys(KERNELS, 0)
        want.update(NP_PER_STEP)
        if got != want:
            raise AssertionError("np/npx encoder step %d launches %s, want "
                                 "%s" % (step, got, want))
    L2, H2 = LM["nlayers"], LM["nhid"]
    T, Bl = LM_T, LM_B
    lstm = grnn.LSTM(H2, num_layers=L2, input_size=H2, device=DEV)
    g = torch.Generator().manual_seed(seed + 6)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_((0.08 * torch.randn(p.shape, generator=g)))
    xs_np = rng.standard_normal((T, Bl, H2)).astype(np.float32)
    st_np = [rng.standard_normal((L2, Bl, H2)).astype(np.float32)
             for _ in range(2)]
    flat = mx.np.array(lstm._flat_params().detach(), ctx=DEV)
    if flat.shape != (orn.param_size("lstm", H2, H2, L2),):
        raise AssertionError("npx.rnn flat vector of %s" % (flat.shape,))
    xs = mx.np.array(xs_np, ctx=DEV)
    h0, c0 = (mx.np.array(s, ctx=DEV) for s in st_np)
    for a in (flat, xs, h0, c0):
        a.attach_grad()
    with mx.autograd.record():
        rout, hT, cT = mx.npx.rnn(xs, flat, h0, c0, mode="lstm",
                                  state_size=H2, num_layers=L2)
        rloss = (rout * rout).sum() + hT.sum() + (cT * cT).sum()
    rloss.backward()
    counts = launch_counts()
    rnn_got = {k: counts[k] - prev[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(NP_RNN_LAUNCHES)
    if rnn_got != want:
        raise AssertionError("npx.rnn launches %s, want %s" % (rnn_got,
                                                                want))
    log("array core: np/npx BERT-base encoder (B %d, L %d, dropout %g) "
        "losses %s (fp32 x %d, then AMP bf16 on step 1's masks); npx.rnn "
        "%d x %d LSTM (B %d, T %d) forward and backward; launches %s"
        % (NP_B, NP_L, NP_DROPOUT, " ".join("%.6f" % v for v in losses),
           NP_STEPS, L2, H2, Bl, T, {k: v for k, v in counts.items() if v}))
    if not all(np.isfinite(losses)) or abs(losses[-1] - losses[0]) > \
            TOL_AMP_LOSS * abs(losses[0]):
        raise AssertionError("np/npx encoder losses %s: AMP bf16 differs "
                             "from fp32 step 0 (the same masks) by more "
                             "than %g" % (losses, TOL_AMP_LOSS))
    # -- checks (launches not counted) --------------------------------------
    card = torch.device(DEV).type
    bad = [n for n, p in params.items() if p.grad is None
           or p.grad.ctx.type != card]
    bad += [n for n, a in (("flat", flat), ("x", xs), ("h0", h0), ("c0", c0))
            if a.grad is None or a.grad.ctx.type != card]
    if bad:
        raise AssertionError("gradients missing or off the card: %s" % bad)
    # the encoder at dropout 0 against the torch-native BERTEncoder
    for p in params.values():
        p.grad[:] = 0
    _, out = np_step(mx, params, x, valid, w, 0.0)
    ref = net(x._data, valid._data)
    ((ref - w._data) ** 2).mean().backward()
    names = [n for n, _ in net.named_parameters()]
    err_out = grad_err(torch, [out._data], [ref.detach()])
    err_g = grad_err(torch, [params[n].grad._data for n in names],
                     [p.grad for _, p in net.named_parameters()])
    log("array core: np/npx encoder vs models.bert.BERTEncoder on the same "
        "weights (dropout 0): output err / max %.3g, gradients err / max "
        "%.3g (tol %g)" % (err_out, err_g, TOL_NP_ENCODER))
    if not (err_out <= TOL_NP_ENCODER and err_g <= TOL_NP_ENCODER):
        raise AssertionError("np/npx encoder disagrees with BERTEncoder")
    # npx.rnn against gluon.rnn.LSTM on the same weights
    lx = torch.tensor(xs_np, device=DEV)
    ls = [torch.tensor(s, device=DEV) for s in st_np]
    lout, (lh, lc) = lstm(lx, ls)
    ((lout * lout).sum() + lh.sum() + (lc * lc).sum()).backward()
    err_r = grad_err(torch, [rout._data, hT._data, cT._data,
                             flat.grad._data],
                     [lout.detach(), lh.detach(), lc.detach(),
                      lstm_flat_grad(torch, lstm)])
    log("array core: npx.rnn vs gluon.rnn.LSTM on the same weights: outputs "
        "and flat gradient err / max %.3g (tol %g)" % (err_r, TOL_NP_LSTM))
    if not err_r <= TOL_NP_LSTM:
        raise AssertionError("npx.rnn disagrees with gluon.rnn.LSTM")
    # the np program at B 2, L 32 on the card and on the CPU, hash dropout
    res = {}
    small = encoder_weights(torch, seed + 7, "cpu")
    xsm = rng.standard_normal((2, 32, C)).astype(np.float32)
    wsm = rng.standard_normal((2, 32, C)).astype(np.float32)
    vsm = np.array([32, 19], np.int32)
    for dev in (DEV, "cpu"):
        with mx.Context(dev):
            ps = np_params(mx, small, dev)
            mx.random.seed(seed + 7)
            lv, o = np_step(mx, ps, mx.np.array(xsm), mx.np.array(vsm),
                            mx.np.array(wsm), 0.1, ffn_dropout=0.0)
            res[dev] = (float(lv), [o._data.detach().cpu()] + [
                ps[n].grad._data.cpu() for n in sorted(ps)])
    lerr = abs(res[DEV][0] - res["cpu"][0]) / abs(res["cpu"][0])
    gerr = grad_err(torch, res[DEV][1], res["cpu"][1])
    log("array core: np/npx encoder at B 2, L 32, hash dropout 0.1, card vs "
        "CPU: loss rel err %.3g, output and gradients err / max %.3g (tol "
        "%g)" % (lerr, gerr, TOL_NP_CARD_CPU))
    if not (lerr <= TOL_NP_CARD_CPU and gerr <= TOL_NP_CARD_CPU):
        raise AssertionError("np/npx program on the card disagrees with the "
                             "CPU")
    # nd.save / nd.load round trips on the card
    arrs = {"w": params["layers.0.attention.qkv.weight"],
            "i": mx.np.array(valid_np, ctx=DEV),
            "b": mx.np.array(valid_np > 70, ctx=DEV)}
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("npz", "legacy"):
            f = os.path.join(d, "a." + fmt)
            mx.nd.save(f, arrs, format=fmt)
            back = mx.nd.load(f, ctx=DEV)
            for k, a in arrs.items():
                if back[k].ctx.type != card or back[k].dtype != a.dtype \
                        or not torch.equal(back[k]._data, a._data):
                    raise AssertionError("nd.load(%s) of %s differs" % (fmt,
                                                                        k))
    log("array core: nd.save / nd.load on the card, npz and legacy: 3 "
        "arrays (float32, int32, bool) equal after the round trip")
    # the np/npx step beside the torch-native step, and one op's dispatch
    np_ms = event_ms(torch, lambda: np_step(mx, params, x, valid, w,
                                            NP_DROPOUT))
    net.train()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for layer in net.layers:
        for mod in (layer, layer.attention, layer.ffn):
            mod._dropout, mod._generator = NP_DROPOUT, gen

    def native():
        out = net(x._data, valid._data)
        ((out - w._data) ** 2).mean().backward()
    nat_ms = event_ms(torch, native)
    host = host_dispatch_us(torch, mx)
    log("array core: encoder step (B %d, L %d, dropout %g, fp32, forward + "
        "backward, CUDA events, median of 5): np/npx %.3f ms, torch-native "
        "BERTEncoder %.3f ms (ratio %.3f); host us a dispatch (median of "
        "2000): %s; card %s"
        % (NP_B, NP_L, NP_DROPOUT, np_ms, nat_ms, np_ms / nat_ms,
           json.dumps({k: round(v, 2) for k, v in host.items()}),
           card_line()))
    log("array core phase done in %.1f s" % (time.perf_counter() - t0))
    del net, params, small
    torch.cuda.empty_cache()
    return {k: counts[k] for k in KERNELS}, dict(
        np_step_ms=np_ms, native_step_ms=nat_ms,
        host_us_np_add=host["np.add"], host_us_torch_add=host["torch.add"])



# ---------------------------------------------------------------------------
# phase 7: Gluon (Parameter, Block, layers, loss, metric, data, Trainer)
# ---------------------------------------------------------------------------
#: LeNet (bench config 1): batch, SGD steps, learning rate
GL_LENET_B, GL_LENET_STEPS, GL_LENET_LR = 64, 20, 0.05
#: the BERT-base FFN as Gluon layers: (B, L, units), hidden width
GL_FFN_SHAPE, GL_FFN_HIDDEN = (32, 128, 768), 3072
#: the word LM of example/gluon/word_language_model.py at config 5's
#: widths: SGD steps, lr, dropout, the clip of the global gradient norm
GL_LM_STEPS, GL_LM_LR, GL_LM_DROPOUT, GL_LM_CLIP = 5, 1.0, 0.2, 0.25
GL_FFN_LAUNCHES = {"bias_gelu": 1, "bias_gelu_backward": 1}
# the Gluon FFN against F.linear -> F.gelu -> F.linear on the same
# weights: the same fp32 GEMMs, but the bias added by #1 after a
# bias-free GEMM where addmm adds it in the GEMM's epilogue (one rounding
# apart), and #1/#2's erf a few ulps from ATen's; the output and each
# gradient within 1e-5 of the tensor's largest element
TOL_GL_FFN = 1e-5
# the Gluon word LM at dropout 0 against the torch-native word_lm from the
# same weights: the same kernels and ops on the same shapes, reached by
# different code; the loss and each gradient within 1e-5 (relative, of
# each tensor's largest element)
TOL_GL_LM = 1e-5
# one step on the card and on the CPU from the same weights: fp32 sums in
# another order (cuDNN's convolutions, the LSTM kernels' blocking), ~1e-6
# relative; these allow 100x that, as lm_card_vs_cpu_step does
TOL_GL_CARD_CPU_LOSS = 1e-4
TOL_GL_CARD_CPU_GRAD = 1e-4


def gluon_lenet(mx):
    net = mx.gluon.nn.Sequential()
    nn = mx.gluon.nn
    net.add(nn.Conv2D(6, 5, activation="tanh"), nn.MaxPool2D(2),
            nn.Conv2D(16, 5, activation="tanh"), nn.MaxPool2D(2),
            nn.Flatten(), nn.Dense(120, activation="tanh"),
            nn.Dense(84, activation="tanh"), nn.Dense(10))
    return net


def gluon_word_lm(mx, vocab, emsize, nhid, nlayers, dropout):
    """``example/gluon/word_language_model.py``'s ``RNNModel``."""
    g = mx.gluon

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


def gluon_lm_step(mx, model, trainer, ce, x, y, vocab, clip=True):
    """One training step as the example takes it: the mean cross entropy
    over every token, the global gradient norm clipped to GL_LM_CLIP,
    ``trainer.step(1)``.  Returns the loss (an ndarray on the card)."""
    with mx.autograd.record():
        logits = model(x)
        loss = ce(logits.reshape((-1, vocab)), y.reshape((-1,))).mean()
    loss.backward()
    if clip:
        mx.gluon.utils.clip_global_norm(
            [p.grad() for p in model.collect_params().values()
             if p.grad_req != "null"], GL_LM_CLIP)
    trainer.step(1)
    return loss


def gluon_lenet_step_grads(mx, net, x, y, dev):
    """One LeNet SGD step on ``dev``: (loss, {name: grad}, {name: weight
    after the step}) on the host."""
    with mx.Context(dev):
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": GL_LENET_LR})
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.autograd.record():
            loss = ce(net(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        grads = {n: p.grad()._data.detach().cpu().clone()
                 for n, p in net.collect_params().items()}
        trainer.step(x.shape[0])
    return (loss._data.detach().cpu(), grads,
            {n: p.leaf.detach().cpu() for n, p in
             net.collect_params().items()})


def gluon_phase(torch, seed):
    """Gluon on the card, through the user's entry points (see the module
    docstring, item 7).  Returns the main path's launches and the
    numbers."""
    import tempfile
    import mxnet_tpu_torch as mx
    F = torch.nn.functional
    t0 = time.perf_counter()
    g = mx.gluon
    V = LM["vocab"]
    # -- build everything before the counted main path --------------------
    np.random.seed(seed)
    mx.random.seed(seed)
    with mx.Context(DEV):
        lenet = gluon_lenet(mx)
        lenet.initialize(mx.init.Xavier())
        tf = g.data.vision.transforms.ToTensor()
        loader = g.data.DataLoader(
            g.data.vision.MNIST(train=True).transform_first(tf),
            batch_size=GL_LENET_B, shuffle=True)
        ffn = g.nn.HybridSequential()
        ffn.add(g.nn.Dense(GL_FFN_HIDDEN, activation="gelu", flatten=False,
                           in_units=GL_FFN_SHAPE[-1]),
                g.nn.Dense(GL_FFN_SHAPE[-1], flatten=False,
                           in_units=GL_FFN_HIDDEN))
        ffn.initialize(mx.init.Xavier())
        rng = np.random.default_rng(seed + 9)
        fx_np = rng.standard_normal(GL_FFN_SHAPE).astype(np.float32)
        fw_np = rng.standard_normal(GL_FFN_SHAPE).astype(np.float32)
        fx, fw = mx.np.array(fx_np), mx.np.array(fw_np)
        fx.attach_grad()
        lm = gluon_word_lm(mx, V, LM["emsize"], LM["nhid"], LM["nlayers"],
                           GL_LM_DROPOUT)
        lm.initialize(mx.init.Xavier())
        lm.hybridize()
        lm_trainer = g.Trainer(lm.collect_params(), "sgd",
                               {"learning_rate": GL_LM_LR})
        segs = [(mx.np.array(a), mx.np.array(b)) for a, b in lm_segments(
            torch, seed, LM_B, LM_T, GL_LM_STEPS, V, DEV)]
    ce = g.loss.SoftmaxCrossEntropyLoss()
    metric = g.metric.Accuracy()
    lenet_trainer = g.Trainer(lenet.collect_params(), "sgd",
                              {"learning_rate": GL_LENET_LR})

    def lenet_eval(x0, y0):
        return float(ce(lenet(x0), y0).mean())

    def lm_eval():
        x, y = segs[0]
        return float(ce(lm(x).reshape((-1, V)), y.reshape((-1,))).mean())

    # -- the main path, counted -------------------------------------------
    torch.cuda.synchronize()
    launch_counts(reset=True)
    lenet_ms, lenet_losses, first = [], [], None
    with mx.Context(DEV):
        for i, (x, y) in enumerate(loader):
            if i == GL_LENET_STEPS:
                break
            if first is None:
                first = (x, y)
                lenet_before = lenet_eval(x, y)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            with mx.autograd.record():
                out = lenet(x)
                loss = ce(out, y)
            loss.backward()
            lenet_trainer.step(x.shape[0])
            e.record()
            metric.update(y, out)
            lenet_losses.append(loss)
            lenet_ms.append((s, e))
        lenet_after = lenet_eval(*first)
        with mx.autograd.record():
            fout = ffn(fx)
        fout.backward(fw)
        lm_before = lm_eval()
        lm_losses = [gluon_lm_step(mx, lm, lm_trainer, ce, x, y, V)
                     for x, y in segs]
        lm_after = lm_eval()
    torch.cuda.synchronize()
    counts = launch_counts()
    # -- checks (launches not counted) --------------------------------------
    step_ms = [s.elapsed_time(e) for s, e in lenet_ms]
    lenet_p50 = statistics.median(step_ms[1:])
    acc = metric.get()[1]
    log("gluon: LeNet (bench config 1) B %d, %d SGD steps (lr %g) on the "
        "MNIST synthetic fallback via DataLoader: loss %s; first-batch loss "
        "%.6f before, %.6f after; accuracy %.4f; step p50 %.3f ms (CUDA "
        "events, first %.1f ms), %.0f images/s"
        % (GL_LENET_B, GL_LENET_STEPS, GL_LENET_LR,
           " ".join("%.4f" % float(v.mean()) for v in lenet_losses),
           lenet_before, lenet_after, acc, lenet_p50, step_ms[0],
           GL_LENET_B / lenet_p50 * 1e3))
    if not (np.isfinite(lenet_after) and lenet_after < lenet_before):
        raise AssertionError("Gluon LeNet loss did not fall: %.6f -> %.6f"
                             % (lenet_before, lenet_after))
    lm_vals = [float(v) for v in lm_losses]
    log("gluon: word LM (vocab %d, %d x %d, NTC, dropout %g, hybridized) "
        "B %d, bptt %d, %d SGD steps (lr %g, clip_global_norm %g): loss %s; "
        "segment-0 loss %.6f before, %.6f after"
        % (V, LM["nlayers"], LM["nhid"], GL_LM_DROPOUT, LM_B, LM_T,
           GL_LM_STEPS, GL_LM_LR, GL_LM_CLIP,
           " ".join("%.4f" % v for v in lm_vals), lm_before, lm_after))
    if not (all(np.isfinite(lm_vals)) and lm_after < lm_before):
        raise AssertionError("Gluon word LM loss did not fall: %.6f -> %.6f"
                             % (lm_before, lm_after))
    want = dict.fromkeys(KERNELS, 0)
    want.update(GL_FFN_LAUNCHES)
    for k, n in LM_PER_STEP.items():
        want[k] = want.get(k, 0) + n * GL_LM_STEPS + LM_PER_EVAL.get(k, 0) * 2
    if counts != want:
        raise AssertionError("Gluon main path launches %s, want %s"
                             % ({k: v for k, v in counts.items() if v},
                                {k: v for k, v in want.items() if v}))
    # the FFN against F.linear -> F.gelu -> F.linear on the same weights
    d1, d2 = ffn[0], ffn[1]
    ref_leaves = [p.leaf.detach().clone().requires_grad_(True) for p in
                  (d1.weight, d1.bias, d2.weight, d2.bias)]
    rx = fx._data.detach().clone().requires_grad_(True)
    w1, b1, w2, b2 = ref_leaves
    ref = F.linear(F.gelu(F.linear(rx, w1, b1)), w2, b2)
    ref.backward(fw._data)
    got = [fout._data, fx.grad._data] + [
        p.grad()._data for p in (d1.weight, d1.bias, d2.weight, d2.bias)]
    err_ffn = grad_err(torch, got, [ref, rx.grad] + [t.grad for t in
                                                      ref_leaves])
    log("gluon: BERT-base FFN as HybridSequential(Dense(3072, gelu), "
        "Dense(768)) on ndarrays %s, forward + backward under record(): "
        "#1 %d launch, #2 %d launch; output, dx and the four gradients vs "
        "F.linear -> F.gelu -> F.linear, err / max %.3g (tol %g)"
        % (GL_FFN_SHAPE, counts["bias_gelu"], counts["bias_gelu_backward"],
           err_ffn, TOL_GL_FFN))
    if not err_ffn <= TOL_GL_FFN:
        raise AssertionError("Gluon FFN disagrees with the plain chain")
    # the Gluon word LM at dropout 0 against the torch-native word_lm
    native = word_lm(torch, seed + 3, DEV, **LM)
    with mx.Context(DEV):
        glm = gluon_word_lm(mx, V, LM["emsize"], LM["nhid"], LM["nlayers"],
                            0.0)
        glm.initialize(mx.init.Zero())
    rename = {"embed.": "encoder."}
    with torch.no_grad():
        for n, t in native.named_parameters():
            for a, b in rename.items():
                n = n.replace(a, b)
            glm.collect_params()[n].leaf.copy_(t)
    x, y = segs[1]
    nlog, _ = native(x._data, native.lstm.begin_state(LM_B))
    nloss = ce(nlog, y._data)
    nloss.backward(torch.ones_like(nloss))
    with mx.autograd.record():
        gloss = ce(glm(x), y)
    gloss.backward()
    pairs = [(glm.collect_params()[n.replace("embed.", "encoder.")].grad()
              ._data, t.grad) for n, t in native.named_parameters()]
    err_lm = grad_err(torch, [gloss._data] + [a for a, _ in pairs],
                      [nloss.detach()] + [b for _, b in pairs])
    log("gluon: word LM at dropout 0 vs the torch-native word_lm on the "
        "same weights (segment 1, zero state): loss and gradients err / max "
        "%.3g (tol %g)" % (err_lm, TOL_GL_LM))
    if not err_lm <= TOL_GL_LM:
        raise AssertionError("Gluon word LM disagrees with the torch-native "
                             "one")
    # card against CPU: one LeNet step at B 4, one small word-LM step
    with tempfile.TemporaryDirectory() as d:
        xb, yb = first[0][:4].asnumpy(), first[1][:4].asnumpy()
        res = {}
        for dev in ("cpu", DEV):
            with mx.Context(dev):
                net = gluon_lenet(mx)
                net.initialize(mx.init.Xavier())
                net(mx.np.array(xb))
            if dev == "cpu":
                net.save_parameters(os.path.join(d, "lenet.npz"))
            else:
                net.load_parameters(os.path.join(d, "lenet.npz"), device=dev)
            res[dev] = gluon_lenet_step_grads(mx, net, xb, yb, dev)
        small = dict(vocab=100, emsize=64, nhid=64, nlayers=2)
        tokens = synthetic_corpus(4 * 9, small["vocab"], seed).reshape(4, 9)
        for dev in ("cpu", DEV):
            with mx.Context(dev):
                net = gluon_word_lm(mx, small["vocab"], small["emsize"],
                                    small["nhid"], small["nlayers"], 0.0)
                net.initialize(mx.init.Xavier())
                if dev == "cpu":
                    net.save_parameters(os.path.join(d, "lm.npz"))
                else:
                    net.load_parameters(os.path.join(d, "lm.npz"), device=dev)
                tr = g.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": GL_LM_LR})
                loss = gluon_lm_step(mx, net, tr, ce,
                                     mx.np.array(tokens[:, :8]),
                                     mx.np.array(tokens[:, 1:]),
                                     small["vocab"], clip=False)
                res[dev + "_lm"] = (loss._data.detach().cpu().reshape(1), {
                    n: p.leaf.detach().cpu()
                    for n, p in net.collect_params().items()})
    (lc, gc, wc), (lp, gp, wp) = res[DEV], res["cpu"]
    lenet_loss_err = float(((lc - lp).abs() / lp.abs()).max())
    lenet_grad_err = grad_err(torch, [gc[n] for n in gp], [gp[n] for n in gp])
    lenet_w_err = max(float((wc[n] - wp[n]).abs().max()) for n in wp)
    (llc, lwc), (llp, lwp) = res[DEV + "_lm"], res["cpu_lm"]
    lm_loss_err = float(((llc - llp).abs() / llp.abs()).max())
    lm_w_err = max(float((lwc[n] - lwp[n]).abs().max()) for n in lwp)
    log("gluon: card vs CPU from the same weights: one LeNet step at B 4, "
        "loss rel err %.3g (tol %g), gradients err / max %.3g (tol %g), "
        "weights max abs diff %.3g; one word-LM step (vocab 100, 2 x 64, "
        "B 4, T 8), loss rel err %.3g, weights max abs diff %.3g (tol %g)"
        % (lenet_loss_err, TOL_GL_CARD_CPU_LOSS, lenet_grad_err,
           TOL_GL_CARD_CPU_GRAD, lenet_w_err, lm_loss_err, lm_w_err,
           TOL_LM_STEP_W))
    if not (lenet_loss_err <= TOL_GL_CARD_CPU_LOSS
            and lenet_grad_err <= TOL_GL_CARD_CPU_GRAD
            and lenet_w_err <= TOL_LM_STEP_W
            and lm_loss_err <= TOL_GL_CARD_CPU_LOSS
            and lm_w_err <= TOL_LM_STEP_W):
        raise AssertionError("Gluon step on the card disagrees with the CPU")
    # the Gluon LM step beside the torch-native one (train_lm's), in turns
    n_trainer = g.Trainer(dict(native.named_parameters()), "sgd",
                          {"learning_rate": LM_LR})
    n_states = native.lstm.begin_state(LM_B)
    xn, yn = segs[0][0]._data, segs[0][1]._data

    def native_step():
        logits, _ = native(xn, n_states)
        loss = ce(logits, yn)
        loss.backward(torch.ones_like(loss))
        n_trainer.step(LM_B)

    # train_lm's work on the dropout-0 Gluon copy of the native weights
    glm_trainer = g.Trainer(glm.collect_params(), "sgd",
                            {"learning_rate": LM_LR})

    def gluon_step_same_work():
        with mx.autograd.record():
            loss = ce(glm(segs[0][0]), segs[0][1])
        loss.backward()
        glm_trainer.step(LM_B)

    times = {"gluon_example": [], "gluon_same_work": [], "native": []}
    fns = {"gluon_example": lambda: gluon_lm_step(
        mx, lm, lm_trainer, ce, segs[0][0], segs[0][1], V),
        "gluon_same_work": gluon_step_same_work, "native": native_step}
    for _ in range(2):
        for k in ("gluon_example", "native", "gluon_same_work"):
            times[k].append(event_ms(torch, fns[k], iters=3))
    med = {k: statistics.median(v) for k, v in times.items()}
    # one layer call's host time: ndarray call, torch call, F.linear
    with mx.Context(DEV):
        dense = g.nn.Dense(768, flatten=False, in_units=768)
        dense.initialize()
        xa = mx.np.ones((8, 768))
    xt, wt, bt = xa._data, dense.weight.leaf, dense.bias.leaf
    host = {}
    with torch.no_grad():
        for label, fn in (("gluon_ndarray", lambda: dense(xa)),
                          ("gluon_torch", lambda: dense(xt)),
                          ("F.linear", lambda: F.linear(xt, wt, bt))):
            for _ in range(50):
                fn()
            ts = []
            for _ in range(2000):
                t = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t) * 1e6)
            torch.cuda.synchronize()
            host[label] = statistics.median(ts)
    log("gluon: word-LM step (vocab %d, %d x %d, B %d, bptt %d, CUDA "
        "events, median of 2 x 3, in turns): Gluon as the example (dropout "
        "%g, mean loss, clip_global_norm, step(1)) %.3f ms, Gluon on "
        "train_lm's work (dropout 0, per-sample loss, step(B)) %.3f ms, "
        "torch-native word_lm %.3f ms (ratio %.3f); host us of a Dense(768) "
        "call on (8, 768) (median of 2000): %s; card %s"
        % (V, LM["nlayers"], LM["nhid"], LM_B, LM_T, GL_LM_DROPOUT,
           med["gluon_example"],
           med["gluon_same_work"], med["native"],
           med["gluon_same_work"] / med["native"],
           json.dumps({k: round(v, 2) for k, v in host.items()}),
           card_line()))
    log("gluon phase done in %.1f s" % (time.perf_counter() - t0))
    del lenet, ffn, lm, glm, native
    torch.cuda.empty_cache()
    return {k: counts[k] for k in KERNELS}, dict(
        lenet_step_p50_ms=lenet_p50,
        lenet_images_per_s=GL_LENET_B / lenet_p50 * 1e3,
        lenet_loss_before=lenet_before, lenet_loss_after=lenet_after,
        lm_loss_before=lm_before, lm_loss_after=lm_after,
        lm_step_ms_example=med["gluon_example"],
        lm_step_ms_same_work=med["gluon_same_work"],
        lm_step_ms_native=med["native"],
        host_us_dense=host["gluon_ndarray"],
        host_us_dense_torch=host["gluon_torch"],
        host_us_f_linear=host["F.linear"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 16 requests through each decode step "
                    "(fused, per-op and int8 + int8 KV at tp 1, fused at tp "
                    "2; async and sync loops) and 3 "
                    "steps of each training phase (the flash kernels' "
                    "share of the BERT ones), the #16 route's backward "
                    "(its ops and kernel spans by kind) and a BERT layer's "
                    "attention (the host's enqueue, ops and spans)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mxnet_tpu_torch.models import decoder as dec
        from mxnet_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print("chip_smoke: run from the root of a checkout (%s)" % e,
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python",
        sys.version.split()[0])
    t = time.perf_counter()
    libs = _build.build()
    log("built %s in %.1f s" % (sorted(libs), time.perf_counter() - t))
    for name, path in libs.items():
        log_path = path.with_suffix(".log")
        if log_path.exists():
            fn = ""
            for line in log_path.read_text().splitlines():
                if "Function properties for" in line:
                    fn = line.split("Function properties for")[-1].strip()
                elif "spill" in line:       # the kernel it belongs to
                    log("  %s: %s: %s" % (name, fn, line.strip()))
                elif "registers" in line:
                    log("  %s: %s" % (name, line.strip()))

    check_flash_sass(libs)
    check_lstm_sass(libs)
    check_qmm_sass(libs)
    timer = Timer(torch)
    report = {}
    lm = perturb_affine(torch, dec.CausalLM(**WIDTHS, device=DEV,
                                            seed=args.seed), args.seed)
    lm_gqa = perturb_affine(torch, dec.CausalLM(
        **dict(WIDTHS, num_layers=2, num_kv_heads=4), device=DEV,
        seed=args.seed + 1), args.seed + 1)
    check_bias_gelu(torch, timer, report)
    check_paged_attention(torch, timer, report)
    check_fused(torch, timer, report, lm, lm_gqa)
    check_quant_matmul(torch, timer, report)
    check_paged_attention_int8(torch, timer, report)
    check_bias_gelu_backward(torch, timer, report)
    check_bias_dropout_residual(torch, timer, report)
    check_flash_attention(torch, timer, report)
    check_lstm(torch, timer, report)
    check_tp_phases(torch, timer, report, lm, lm_gqa)
    check_decode_dims(torch, timer, report)
    check_flash_dims(torch, timer, report)
    check_sharded_attention(torch, timer, report, profile=args.profile)
    if args.profile:
        for dt, B, L in ((torch.float32, TRAIN_B, TRAIN_L),
                         (torch.bfloat16, TRAIN_B, TRAIN_L),
                         (torch.bfloat16, LONG_B, LONG_L)):
            bert_attention_split(torch, dt, B, L)
    del timer
    log("kernel checks done at %.1f s" % (time.perf_counter() - t_start))
    if args.kernels_only:
        log("kernel checks passed")
        return 0

    reqs = traffic(args.seed, args.requests)
    runs = {}
    for label, fused, quant in (
            ("fused", True, {}), ("per_op", False, {}),
            # quantized serving asks for the fused step and must be given
            # the per-op one
            ("int8_kv8", True, dict(quantize="int8", kv_dtype="int8")),
            ("int4", True, dict(quantize="int4", quant_group=128))):
        runs[label] = serve(torch, lm, reqs, label, fused,
                            sync_check=label in SYNC_CHECKED, **quant)
    # the synchronous loop beside the async one, streams held equal
    check_ab(torch, lm, reqs, runs)
    # tensor-parallel serving: the shards run in turn on the card, on the
    # first TP_REQUESTS requests
    tp_reqs = reqs[:TP_REQUESTS]
    for label, fused, tp in (("tp2_fused", True, 2), ("tp4_fused", True, 4),
                             ("tp2_per_op", False, 2)):
        runs[label] = serve(torch, lm, tp_reqs, label, fused,
                            sharding=tp_sharding(tp))
    # quantized tensor-parallel serving: each asks for the fused step and
    # must be given the per-op one; int4 at tp 4 quantizes wo with group 64
    # (its shard's 192 inputs)
    for label, tp, quant in QUANT_TP_RUNS:
        runs[label] = serve(torch, lm, tp_reqs, label, True,
                            sharding=tp_sharding(tp),
                            sync_check=label in SYNC_CHECKED, **quant)
        eng = runs[label][0]
        wo = eng.params[0]["layers"][0]["wo"]
        log("serve %s: decode step %s; wo's shard %s with %s scales"
            % (label, "fused" if eng.decode_fused else "per-op",
               tuple(wo.q.shape), tuple(wo.s.shape)))
        if eng.decode_fused or eng.tp != tp:
            raise AssertionError("%s: a quantized engine must take the "
                                 "per-op TP step at tp %d" % (label, tp))
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(
        runs["int8_kv8"][1], runs["int8_kv8_tp2"][1]))
    log("int8_kv8_tp2 streams identical to the tp 1 int8_kv8 run's for %d of "
        "%d requests" % (same, len(tp_reqs)))
    outs_f = runs["fused"][1]
    for label in ("per_op", "tp2_fused", "tp4_fused", "tp2_per_op"):
        same = sum(a["tokens"] == b["tokens"]
                   for a, b in zip(outs_f, runs[label][1]))
        log("%s streams identical to the tp 1 fused run's for %d of %d "
            "requests" % (label, same, len(runs[label][1])))
    seqs = [p + o["tokens"] for (p, _), o in zip(reqs[:3], outs_f[:3])]
    cfg, params = lm.config, lm.params()
    fp_ref = full_logits(torch, params, cfg, seqs)
    tf1 = {}
    for label in ("fused", "per_op", "tp2_fused", "tp4_fused", "tp2_per_op"):
        eng = runs[label][0]
        tf1[label] = teacher_forced(torch, eng, eng.params, seqs)
        err = max_err(tf1[label], fp_ref)
        log("teacher-forced %s prefill+decode vs full_forward over %d "
            "sequences: max_abs_err %.3g (tol %g)"
            % (label, len(seqs), err, TOL_LOGITS))
        if not err <= TOL_LOGITS:
            raise AssertionError("engine logits disagree with full_forward")
        if label.startswith("tp"):
            one = tf1["fused" if label.endswith("fused") else "per_op"]
            err = max_err(tf1[label], one)
            log("teacher-forced %s vs the tp 1 engine's programs: "
                "max_abs_err %.3g (tol %g)" % (label, err, TOL_LOGITS))
            if not err <= TOL_LOGITS:
                raise AssertionError("tensor-parallel logits disagree with "
                                     "tp 1")
    # int4 weights, fp KV: the engine's programs against full_forward over
    # the same integer weights (quant_matmul_plain)
    eng4 = runs["int4"][0]
    tf4 = teacher_forced(torch, eng4, eng4.params, seqs)
    err = max_err(tf4, full_logits(torch, eng4.params, cfg, seqs))
    log("teacher-forced int4 prefill+decode vs full_forward(int4 weights) "
        "over %d sequences: max_abs_err %.3g (tol %g); top-1 agreement with "
        "the fp32 model %.4f" % (len(seqs), err, TOL_LOGITS,
                                 top1_agreement(tf4, fp_ref)))
    if not err <= TOL_LOGITS:
        raise AssertionError("int4 engine logits disagree with full_forward")
    # int8 weights, int8 KV: the same programs on the card and on CPU copies
    # of the params (where the plain versions serve), over the first 96
    # tokens of each sequence
    eng8 = runs["int8_kv8"][0]
    tf8 = teacher_forced(torch, eng8, eng8.params, seqs)
    short = [q[:96] for q in seqs]
    with torch.no_grad():
        on_card = teacher_forced(torch, eng8, eng8.params, short)
        on_cpu = teacher_forced(torch, eng8, params_to(eng8.params, "cpu"),
                                short, dev="cpu")
    err = max_err(on_card, on_cpu)
    log("teacher-forced int8/int8-KV prefill+decode, card vs CPU copies over "
        "%d sequences of 96 tokens: max_abs_err %.3g (tol %g); top-1 "
        "agreement with the fp32 model %.4f"
        % (len(short), err, TOL_LOGITS_INT8KV, top1_agreement(tf8, fp_ref)))
    if not err <= TOL_LOGITS_INT8KV:
        raise AssertionError("int8-KV engine logits on the card disagree "
                             "with the CPU")
    check_quant_tp(torch, runs, seqs, tf8, fp_ref, cfg)
    paths = {"prefix": prefix_phase(torch, lm, args.seed),
             "sessions": session_phase(torch, lm, args.seed),
             "tiny_lm": tiny_phase(torch, args.seed),
             "http": http_phase(torch, lm, args.seed),
             "speculative": spec_phase(torch, lm, args.seed)}
    if args.profile:
        for fused, tp, quant in ((True, 1, {}), (False, 1, {}), (True, 2, {}),
                                 (True, 1, dict(quantize="int8",
                                                kv_dtype="int8"))):
            for async_decode in (True, False):
                profile(torch, lm, reqs[:16], fused,
                        tp_sharding(tp) if tp > 1 else None,
                        async_decode=async_decode, **quant)
    log("serving done at %.1f s" % (time.perf_counter() - t_start))
    paths["sharded_attention"] = sharded_attention_path(torch, args.seed)
    trains = {}
    trains["fp32"] = train(torch, args.seed, "fp32", TRAIN_B, TRAIN_L,
                           TRAIN_STEPS, profile_steps=3 if args.profile
                           else 0)
    trains["amp_bf16"] = train(torch, args.seed, "amp_bf16", TRAIN_B,
                               TRAIN_L, TRAIN_STEPS, amp=True,
                               profile_steps=3 if args.profile else 0)
    l32 = trains["fp32"][1]["first_loss"]
    l16 = trains["amp_bf16"][1]["first_loss"]
    amp_err = abs(l16 - l32) / abs(l32)
    log("train: step-1 loss AMP bf16 %.6f vs fp32 %.6f, rel err %.3g (tol "
        "%g)" % (l16, l32, amp_err, TOL_AMP_LOSS))
    if not amp_err <= TOL_AMP_LOSS:
        raise AssertionError("AMP step-1 loss disagrees with fp32")
    trains["long_amp_bf16"] = train(torch, args.seed, "long_amp_bf16",
                                    LONG_B, LONG_L, LONG_STEPS, amp=True,
                                    profile_steps=LONG_STEPS if args.profile
                                    else 0, max_length=LONG_L)
    card_vs_cpu_step(torch, args.seed)
    log("training done at %.1f s" % (time.perf_counter() - t_start))
    trains["lstm_lm_fp32"] = train_lm(torch, args.seed, "lstm_lm_fp32",
                                      profile_steps=3 if args.profile else 0)
    trains["lstm_lm_amp_bf16"] = train_lm(
        torch, args.seed, "lstm_lm_amp_bf16", amp=True,
        profile_steps=3 if args.profile else 0)
    l32 = trains["lstm_lm_fp32"][1]["first_loss"]
    l16 = trains["lstm_lm_amp_bf16"][1]["first_loss"]
    amp_err = abs(l16 - l32) / abs(l32)
    log("train lstm_lm: step-1 loss AMP bf16 %.6f vs fp32 %.6f, rel err %.3g "
        "(tol %g)" % (l16, l32, amp_err, TOL_LM_AMP_LOSS))
    if not amp_err <= TOL_LM_AMP_LOSS:
        raise AssertionError("LSTM LM AMP step-1 loss disagrees with fp32")
    lm_card_vs_cpu_step(torch, args.seed)
    log("LSTM training done at %.1f s" % (time.perf_counter() - t_start))
    paths["array_core"], array_core = array_core_phase(torch, args.seed)
    log("array core done at %.1f s" % (time.perf_counter() - t_start))
    paths["gluon"], gluon_report = gluon_phase(torch, args.seed)
    log("gluon done at %.1f s" % (time.perf_counter() - t_start))
    kernels = []
    for name in KERNELS:
        row = report[name]
        row["launches"] = (sum(run[2][name] for run in runs.values())
                           + sum(c[name] for c, _ in trains.values())
                           + sum(c[name] for c in paths.values()))
        if not row["launches"]:
            raise AssertionError("%s was not launched on the main path"
                                 % name)
        kernels.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(json.dumps({"serve": {k: run[3] for k, run in runs.items()},
                    "train": {k: st for k, (_, st) in trains.items()},
                    "flash_bf16": report["flash_bf16"],
                    "flash_bf16_long": report["flash_bf16_long"],
                    "lstm_fp32": report["lstm_fp32"],
                    "lstm_bf16": report["lstm_bf16"],
                    "fused": report["fused"],
                    "tp_phases": report["tp_phases"],
                    "array_core": array_core,
                    "gluon": gluon_report,
                    "sharded_attention": report["sharded_attention"]}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
