#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check exits non-zero; there is no CPU fallback):

1. device: the card's name, count and ``nvidia-smi`` name / power limit;
2. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (one process per source, all at once) and print each kernel's
   registers and spills from ptxas' report;
3. GEMM kernels vs plain: K3' and K4' at the serving path's shapes (M = 4
   and 128) against their plain PyTorch twins -- bitwise on exact-sum
   inputs, at most 1e-4 one-ulp flips on N(0, 1) inputs -- and timed with
   CUDA events beside the bound, the twin and the bare fp32 GEMM
   (``torch.matmul``, the GEMM-only yardstick: no single PyTorch call
   computes the rounded function), K3' and the yardstick at the decode
   shapes also by CUDA-graph replay (``device_ms``); K3''s decode route
   holds each row bit for bit whatever rows share the call (the same A
   rows at M = 1, 2, 4, 8 and 16, K3' and K3) and equals its large-M
   route bit for bit at every decode shape; K4' run on both its routes
   (the route forced) at every shape, every output bit for bit equal, and
   timed by CUDA-graph replay too;
4. update kernels vs plain: K2' and K2 (the eq.-8 update) at n = 2**24 + 37
   under five rounding configs and the eleven chains of their wide
   instance (``WIDE_UPDATE_CONFIGS``: fixed point, sr2 at r = 8 and 16,
   the bf16 bit trick, rz / ra / rd / ru, rn with overflow to +-inf on
   inputs that overflow, a shifted grid, e4m3 signed-SRe overflowing to
   +-inf) and at the full tinyllama-1.1b parameter count under the
   trainer's config, and the momentum FMA at both sizes, bitwise against
   their twins, timed beside the bound, the twin and the unrounded ``x -
   t * g`` / ``torch.add(g, m, alpha=0.9)`` (yardsticks only); K2' and K2
   under each compiled instance a config fits (the wide one takes every
   chain; the trainer's config: the trainer, generic and wide instances,
   the first two timed), at the tail lengths 1, 3, 5 and 129 (with -0
   inputs) and on views one element off a 16-byte boundary too, each
   config's instances printed; at the full count the generic and the wide
   instance on ``WIDE_TIMED`` (binary8 rn/sr/sr, a chain both take) by
   CUDA events and by CUDA-graph replay (``device_ms``), in turns;
5. training GEMMs vs plain: K3' at every forward/dgrad/wgrad shape of a
   batch-4 x 256 train step and K4' with residuals (on both routes, and
   by graph replay), checked and timed as in phase 3;
6. serve: ``repro_torch.launch.serve.run`` on tinyllama-1.1b at full width
   and depth (random weights from a seeded generator) under
   ``binary8-paper``, with every kernel's launch count checked;
7. serve agreement: reduced tinyllama on the card against the same model on
   the CPU (plain twins), teacher-forced;
8. train: ``repro_torch.launch.train.run`` of ``train.PAPER_RUN``:
   tinyllama-1.1b at full width and depth, batch 4 x 256 tokens, 4 steps
   through the TrainLoop (a fresh checkpoint directory, removed after),
   ``binary8-paper`` GEMMs and the signed-SRe binary8 update through K2'
   (``--update-path fused``): launch counts, a finite loss at every step,
   ms/step, tokens/s, memory;
9. train agreement: reduced tinyllama, 2 steps on the card against the CPU
   twins from the same parameters and batches (through ``train.run``, each
   in a fresh checkpoint directory), for ``fused`` (K2') and
   ``fused_bits`` (K2): at most ``AGREE_MAX_PARAMS`` parameters differ and
   the losses agree within ``AGREE_MAX_REL_LOSS``;
10. attention kernels vs plain: K6, K7 and K7' at the train step's shapes
   (B.H = 128, S = 256, d = 64, B.KV = 16, causal) and on a multi-block
   ragged case (blocks of 64, S = 200) with 32-, 16- and 8-bit draws, K9
   at the decode shapes (B.KV = 16, G = 8, S_max = 48, packed e4m3 codes,
   lengths 1, 17, 48) on both its routes (the decode kernel it launches
   and ``flash_decode_tiled``, forced; each launch counted on its route):
   the rounded logits and m bitwise on exact-sum inputs, out/dq/dk/dv at
   most 1e-4 of the elements different on N(0, 1) inputs, K9 over codes
   bitwise K9 over the unpacked values, K9's decode kernel bitwise its
   tiled kernel there and at S_max 200 and 300 (blocks of 64 with a ragged
   last block, a window, blocks of 256), 32-, 16- and 8-bit draws, e4m3
   and float32 caches; K7 and K7' on their tiled kernels bitwise equal to
   their first kernels (``flash_bwd_dq_simple``, ``flash_bwd_dkv_simple``,
   forced; each launch counted on its route) in dq, dk and dv on N(0, 1)
   inputs at the train step's shapes and in the three ragged cases; K6's
   single pass bitwise equal to its two-pass
   kernel in out, m, l and the logits on N(0, 1) inputs, and a block too
   large for the single pass (S = 1024, d = 128) run by the two-pass kernel
   and counted apart; timed beside the bound, the twin and
   ``scaled_dot_product_attention`` (float32, unrounded: a yardstick
   only; for K7 and K7' its backward alone, one forward kept, beside the
   forward + backward), K9 on both routes, K7 and K7' on both routes,
   SDPA and SDPA's backward also by CUDA-graph replay (``device_ms``:
   device time without the host's cost per call);
11. serve tinyllama-1.1b under ``binary8-paper-attn`` (rounded attention,
   packed e4m3 KV cache): launch counts (K9 once per layer per token, on
   its decode kernel: the tiled route launched no time);
12. its agreement: reduced tinyllama card vs CPU, logits and cache codes;
13. train tinyllama-1.1b under ``binary8-paper-attn`` (4 steps, batch 4 x
   256): K6, K7, K7' once per layer per step, on their single-pass and
   tiled kernels (the two-pass and first kernels launched no time), finite
   losses;
14. its agreement: reduced tinyllama, 2 steps card vs CPU;
15. MoE kernels vs plain: K1' (the SR cast, 128-lane bits) bitwise at
   n = 2**24 + 37 and at the path's (128, 1, 768) for binary8 sr with 32-,
   16- and 8-bit draws and rn, its sr_r32 instance (the path's spec)
   bitwise its generic one; K8' (the batched GEMM) at the path's decode
   shapes (128 experts x 1 row: 2048 -> 768 and 768 -> 2048), a
   whole-prompt forward's (128 x 10 rows, the capacity of batch 4 x
   prompt 32 at once; ``serve.run`` absorbs prompts token by token) and a
   ragged one (5 x 3 x 70 x 50), bf16 and float32 b, bitwise on exact-sum
   inputs and within the 1e-4 one-ulp contract on N(0, 1) inputs, where
   its weight-stream and large-M routes (the route forced) are also
   bitwise equal; timed beside the bound, the twin and an unrounded
   yardstick (a bf16 cast for K1', bf16 ``torch.bmm`` for K8'), K1', K8'
   and their yardsticks at the path's shapes also by CUDA-graph replay
   (``device_ms``);
16. MoE agreement: reduced qwen3-moe-30b-a3b on the card against the same
   weights on the CPU, teacher-forced: logits and greedy picks;
17. MoE serve: ``serve.run(**serve.MOE_SERVE_RUN)``, qwen3-moe-30b-a3b at
   full width and depth (48 layers, 128 experts, 30.5 B parameters) under
   ``binary8-paper``, run after the dense phases released their models:
   launch counts against the code's prediction, tok/s, peak memory;
18. K5 (the fused QAdam step) vs plain: at n = 2**24 + 37 for bf16-sr
   codes, bf16-sr/e4m3-sr codes, bit-trick bf16 codes, bf16-sr codes with
   Kahan carries and float32 carries, each under the trainer's chain and
   phase 4's extra configs, and on a view off a 16-byte boundary: x, the
   moments and the carries bitwise; then over the 1,100,048,384
   tinyllama-1.1b parameters with non-zero bf16-sr moment codes under
   ``ADAM_RUN``'s learning rate through K5's trainer instance, bitwise,
   and timed beside its bound, the twin and ``torch.optim.Adam(fused=
   True)`` (float32 moments, unrounded: a yardstick only);
19. QAdam training: ``train.run(**train.ADAM_RUN)``, tinyllama-1.1b at
   full size for 4 steps through the TrainLoop (bf16-sr moment codes
   through K5, binary8-packed checkpoints): launch counts, losses (the
   last below the first, and step 1's batch below its first reading
   after the 4 steps), ms/step, peak memory, the checkpoint's bytes
   and its save and restore seconds; then 2 steps and a resume to 4 in
   one directory, parameters and moment codes bitwise equal to the
   uninterrupted run;
20. QAdam agreement: reduced tinyllama, 2 steps card vs CPU for ``fused``
   (K5) and ``fused_bits`` (K2 + the plain moments) at phase 9's learning
   rate, held to phase 9's limits (the moments too); at ``ADAM_RUN``'s
   learning rate, the card's per-leaf moment step on the CPU's state and
   gradients bitwise equal to the CPU's; a fault drill on the card
   (preemptions around a garbled checkpoint) bitwise equal to a clean run;
21. explicit-bits kernels vs plain: K3 and K4 at the oracle path's shapes
   (M = 4: q/k/v/o, down, lm head; the fused GLU 2048 -> 5632) and a
   ragged one, K8 at the MoE path's decode and whole-prompt shapes and a
   ragged one (on both its routes, bitwise), K1 on
   (128, 1, 768), a ragged and a 2**20 + 37 tensor: on exact-sum inputs
   each equal to its plain twin (K4's residuals bitwise, its hidden within
   the act grid's flips) and every one bitwise equal to its in-kernel-bits
   kernel fed the same words (``counter_bits_reduced`` /
   ``counter_bits_batch``), with 32-, 16- and 8-bit draws; packed outputs
   (e4m3 saturating at 480) the codes of the float ones, packed operands
   (one view off a 16-byte boundary, -0.0 codes among them) summing as
   their values; K1 and K1''s signed-SRe branch bitwise on any input; on
   N(0, 1) inputs the GEMM contract; each timed beside its bound (the
   bits stream counted), its in-kernel-bits kernel, the twin and the
   unrounded yardstick of its primed kernel, K3 and K4 at the decode
   shapes (with K3'/K4' and the yardstick), K8 at the MoE path's shapes
   (with K8' and bf16 ``torch.bmm``), K1 (both its instances: ``sr_r32``,
   the path's spec, and the generic one, each bitwise the twin aligned and
   through a view off a 16-byte boundary) and the cast at the path's
   shape also by CUDA-graph replay (``device_ms``); K4 and K4' on N(0, 1)
   inputs bitwise equal on both routes (the route forced);
22. serve tinyllama-1.1b under ``e4m3-sr-oracle`` (K3, K4; every
   in-kernel-bits kernel launched no time) and under ``e4m3-sr``: tokens
   and logits bitwise equal; the host seconds spent issuing the bits;
23. serve tinyllama-1.1b under ``binary8-paper-packed``: the hidden
   stored as uint8 codes in every K4' call and decoded by every down
   GEMM, tokens and logits bitwise equal to phase 6's;
24. reduced qwen3-moe under the oracle form of ``binary8-paper`` card vs
   CPU, held to phase 16's tolerances; reduced tinyllama, 2 train steps
   under ``binary8-paper-packed`` and ``e4m3-sr-oracle`` card vs CPU, held
   to phase 9's limits, and bitwise equal on the card to the same run
   under ``binary8-paper`` / ``e4m3-sr``;
25. serve qwen3-moe-30b-a3b at full width and depth under the oracle form
   of ``binary8-paper`` (K3, K8, K1): launch counts, tok/s, peak memory,
   the host seconds spent issuing the bits;
26. K10 (the paged decode) vs plain: B.KV = 32 (8 requests x 4 kv heads),
   G = 8, d = 64, n_max = 4, pages of 8, 16 and 64 at random placements,
   lengths 1, page-1, page, page+1, the full table and random ones, 32-,
   16- and 8-bit draws: bitwise equal to its twin on exact-sum inputs
   (every key of a request equal: each row's logits equal, every exp
   exactly 1, every sum exact), within the attention contract on N(0, 1)
   inputs, over packed e4m3 codes bitwise equal to over their values,
   bitwise equal to K9's tiled kernel (``flash_decode_tiled``, the
   independent one) on each request's contiguous cache with ``kv_block ==
   page``, the same bits at two placements; timed at the
   engine's decode shape beside the bound, the twin and
   ``scaled_dot_product_attention`` over the gathered float32 cache
   (unrounded: a yardstick only), both also by CUDA-graph replay
   (``device_ms``);
27. the continuous-batching engine at full width and depth:
   ``serve.run_engine`` over ``serve.ENGINE_RUN`` (tinyllama-1.1b, 16
   requests, 4 slots, pages of 64) under ``serve.ENGINE_POLICY``: every
   request drains, every page comes back, K10 launched 22 times per
   decode step and nothing else; the same requests under two other slot
   counts, pools and arrival schedules give the same streams bit for bit;
   tok/s, time to first token, pool bytes, peak memory; then one run
   under ``binary8-paper-attn`` with K3', K4' and K10 counted against the
   engine's calls;
28. engine agreement: the reduced engine on the card against the same
   weights on the CPU, teacher-forced on the CPU's picks: logits held to
   phase 12's limits, the card's own picks within 0.1 of the CPU's best
   logit, the pools' codes at most 1 % different per layer;
29. the paper's GD experiments (``repro_torch.paper``): the convergence
   harness's smoke run (bfloat16, binary8, fxp16.8 x rn / sr / sr2, 2 sims
   of the stagnation, PL and Setting-I quadratics) on both engines, the
   reference's ordering gate on each, K2''s launches against steps x sims
   x problems x configs (none on the "jnp" engine) and by instance (generic
   and wide); Fig. 4's MLR (784 x 10, 3000 / 800 synthetic samples, t =
   0.5) and Fig. 6's NN (784 -> 100 -> 1, t = 0.09375) at full width under
   binary32 / rn / sr / signed-SRe 0.1, depth cut to 30 and 20 epochs and
   one simulation (printed); card against CPU: Setting I (n = 1000), 50
   steps at its t and at t = 0.5 under two chains (a generic one and a
   wide one), the iterates bitwise on both engines, and 3 MLR epochs at
   full size (W after epoch 1 at most 1e-3 of its elements one binary8
   step apart, the test errors within 0.02); ms per GD step and per epoch
   beside the card's name and power limit;
30. one JSON line of per-kernel numbers (K3''s, K3's, K4''s, K4's, K8''s,
   K8's, K9's (both routes), K10's, K1''s and K1's with the registers and
   spills ptxas reports for their instances, phase 2; K3', K3, K4' and K4
   with their device time per decode step, K4' also per train step; K9's
   tiled route and K1's generic instance beside the ones the path runs;
   K2' and K2 with the wide and the generic instance on ``WIDE_TIMED``
   under ``wide_timed_chain`` and K2''s launches in phase 29), then the
   result line.

Detailed numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD = HERE / "build"
T_START = time.time()
# H100 SXM peaks (data sheet): fp32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# int32 on the CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz (the fp32
# peak above is 132 x 128 lanes x 2 (FMA) x 1.98 GHz; Hopper white paper)
PEAK_INT32_OPS = 16.7e12
# a lower bound on the integer operations of one Threefry-2x32: 20 rounds
# of add, rotate, xor
THREEFRY_OPS = 60
L2_BYTES = 50 * 2 ** 20

TINYLLAMA = dict(d=2048, n_layers=22, q=2048, kv=256, ff=5632, vocab=32000)
MOE_ARCH = "qwen3-moe-30b-a3b"
LAYERS = TINYLLAMA["n_layers"]
# (K, N, launches per decode step) of each kernel's calls on the path
QMATMUL_SHAPES = [(2048, 2048, 2 * 22), (2048, 256, 2 * 22),
                  (5632, 2048, 22), (2048, 32000, 1)]
SWIGLU_SHAPES = [(2048, 5632, 22)]
RAGGED = (37, 45, 70)
BATCH, PROMPT, GEN = 4, 32, 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 256, 4
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
# K3' calls of one train step: (M, K, N, B operand, launches per step).
# dgrad is g (M, N_fwd) @ W^T, wgrad a^T (K_fwd, M) @ g with a float32 B.
TRAIN_GEMMS = [
    (TRAIN_M, 2048, 2048, "bf16", 4 * LAYERS),    # q, o fwd + dgrad
    (TRAIN_M, 2048, 256, "bf16", 2 * LAYERS),     # k, v fwd
    (TRAIN_M, 256, 2048, "bf16", 2 * LAYERS),     # k, v dgrad
    (TRAIN_M, 5632, 2048, "bf16", 3 * LAYERS),    # down fwd, gate/up dgrad
    (TRAIN_M, 2048, 5632, "bf16", LAYERS),        # down dgrad
    (TRAIN_M, 2048, 32000, "bf16", 1),            # lm head fwd
    (TRAIN_M, 32000, 2048, "bf16", 1),            # lm head dgrad
    (2048, TRAIN_M, 2048, "f32", 2 * LAYERS),     # q, o wgrad
    (2048, TRAIN_M, 256, "f32", 2 * LAYERS),      # k, v wgrad
    (5632, TRAIN_M, 2048, "f32", LAYERS),         # down wgrad
    (2048, TRAIN_M, 5632, "f32", 2 * LAYERS),     # gate, up wgrad
    (2048, TRAIN_M, 32000, "f32", 1),             # lm head wgrad
]
TRAIN_QMATMUL_PER_STEP = 19 * LAYERS + 3
UPDATE_T = 0.05
UPDATE_SEED = (0x1234ABCD, 0x0BADF00D)
UPDATE_N_SMALL = 2 ** 24 + 37
# phase 4's tails: lengths with 1 to 3 elements past the last group of
# four (and one whole group), each also off a 16-byte boundary
UPDATE_TAILS = (1, 3, 5, 129)
MOMENTUM = 0.9
# phase 9's limits, set from its readings (0 of 90,432 parameters differ,
# losses within 9.8e-8 relative: one float32 ulp of the cross-entropy sum)
AGREE_MAX_PARAMS = 8
AGREE_MAX_REL_LOSS = 5e-7
# attention shapes: the train step's (batch 4 x 256, 32 query / 4 kv
# heads of 64) and a decode step's (batch 4, S_max = prompt + gen)
ATTN = dict(BH=TRAIN_BATCH * 32, BKV=TRAIN_BATCH * 4, S=TRAIN_SEQ, d=64,
            n_heads=32, n_kv=4)
DECODE = dict(BKV=BATCH * 4, G=8, Smax=PROMPT + GEN, d=64)
ATTN_POLICY = "binary8-paper-attn"
# the engine's run (serve.ENGINE_RUN, phases 26-27): 4 slots, pages of 64
# tokens, 12 short requests (prompt 4 + 2 generated) and 4 long (48 + 32)
ENGINE = dict(n_slots=4, page=64, short=(4, 2), long=(48, 32))
# phases 21-25: the explicit-bits (oracle) and packed-storage presets
ORACLE_POLICY = "e4m3-sr-oracle"
PACKED_POLICY = "binary8-paper-packed"
# phase 12's limit on the share of differing KV-cache codes per layer, set
# from its reading (0 of 768 per layer; phase 14 reads 0 parameters and
# equal losses, held to phase 9's limits): a GEMM sum flipped upstream
# would move whole rows of later layers' codes
ATTN_AGREE_MAX_CODE_SHARE = 0.01
# the MoE serve cell (phases 15-17): qwen3-moe-30b-a3b, decode at batch 4
# gives T = 4 tokens per layer and step, top-8 of 128 experts, capacity
# C = max(1, int(4 * 8 * 1.25 / 128)) = 1 row per expert
MOE = dict(d=2048, n_layers=48, q=4096, kv=512, n_experts=128, top_k=8,
           d_expert=768, vocab=151936)
MOE_LAYERS = MOE["n_layers"]
# (E, M, K, N, launches per decode step) of K8' on the path: gate and up,
# then down; and K1''s rounding of the (E, C, d_expert) hidden
BATCHED_SHAPES = [(128, 1, 2048, 768, 2 * MOE_LAYERS),
                  (128, 1, 768, 2048, MOE_LAYERS)]
# the same GEMMs in a whole-prompt forward (batch 4 x prompt 32 = 128
# tokens at once: capacity C = int(128 * 8 * 1.25 / 128) = 10 rows per
# expert; serve.run absorbs prompts token by token, at the shapes above),
# launches per such forward
BATCHED_PREFILL = [(128, 10, 2048, 768, 2 * MOE_LAYERS),
                   (128, 10, 768, 2048, MOE_LAYERS)]
BATCHED_RAGGED = (5, 3, 70, 50)
SR_CAST_PATH = (128, 1, 768)
SR_CAST_SIZES = [(UPDATE_N_SMALL,), SR_CAST_PATH]
# phase 18: K5's moment cases, (m spec, v spec, packed, Kahan), each under
# the trainer's chain and phase 4's extra update configs
ADAM_CASES = [("bf16-sr", "bf16-sr", True, False),
              ("bf16-sr", "e4m3-sr", True, False),
              ("bf16-sr-bittrick", "bf16-sr", True, False),
              ("bf16-sr", "bf16-sr", True, True),
              ("fp32", "fp32", False, False)]
# phase 19's resume: this many steps, then the rest in the same directory
RESUME_AT = 2
# phase 29: the paper's MLR / NN data (train, test samples), depth cut to
# these epochs (the figures run 150 and 50), and card-vs-CPU GD steps
PAPER_MLR_DATA = (3000, 800)
PAPER_NN_DATA = (3000, 800)
PAPER_MLR_EPOCHS = 30
PAPER_NN_EPOCHS = 20
PAPER_AGREE_STEPS = 50
# phase 20's fault drill on the reduced model
DRILL = dict(steps=8, checkpoint_every=2,
             fault_schedule="preempt@3,corrupt@4,preempt@5")
# (grad, mul, sub) spec names of the extra update configs of phase 4
UPDATE_CONFIGS = {
    "sr_eps-binary8": ("binary8-rn", "binary8-sr_eps-e0.1", "binary8-sr"),
    "sr-r16-binary8": ("binary8-sr-r16",) * 3,
    "rn-binary8": ("binary8-rn",) * 3,
    "signed_sr_eps-bf16": ("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1"),
}
# phase 4's chains of K2' and K2's wide instance: (grad, mul, sub) spec
# names, the scales of x and g (inputs that overflow where the chain
# overflows to +-inf).  "shift8" is binary8 shifted by scale 0.5, mu 0.25.
WIDE_UPDATE_CONFIGS = {
    "fxp16.8-sr2": (("fxp16.8-rn", "fxp16.8-sr2", "fxp16.8-sr2"), 1.0, 1.0),
    "fxp16.8-sr": (("fxp16.8-rn", "fxp16.8-sr", "fxp16.8-sr"), 1.0, 1.0),
    "fxp8.4-rn": (("fxp8.4-rn",) * 3, 50.0, 10.0),
    "binary8-sr2 (r 8)": (("binary8-rn", "binary8-sr2", "binary8-sr2"),
                          1.0, 1.0),
    "binary8-sr2 (r 16)": (("binary8-rn", "binary8-sr2-r16",
                            "binary8-sr2-r16"), 1.0, 1.0),
    "bf16-sr_bittrick": (("bf16-rn", "bf16-sr-bittrick", "bf16-sr-bittrick"),
                         1.0, 1.0),
    "binary8-rz/ra/rd": (("binary8-rz", "binary8-ra", "binary8-rd"),
                         1.0, 1.0),
    "binary8-ru": (("binary8-ru",) * 3, 1.0, 1.0),
    "binary8-rn-inf": (("binary8-rn-inf",) * 3, 1.0, 1e7),
    "shift8 rn/sr/signed-SRe": (("shift8-rn", "shift8-sr",
                                 "shift8-signed_sr_eps-e0.2"), 1.0, 1.0),
    "e4m3-signed_sr_eps-inf": (("e4m3-rn", "e4m3-sr",
                                "e4m3-signed_sr_eps-e0.3-inf"), 3e4, 1e4),
}
# the chain phase 4 times on both the generic and the wide instance
WIDE_TIMED = ("binary8-rn", "binary8-sr", "binary8-sr")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(M, K, N, n_weights, b_bytes=2, extra_out=0):
    """Least time for a GEMM's work: the larger of the bytes (each input
    read once, each output written once) over HBM rate and the fp32 flops
    over the fp32 peak."""
    nbytes = M * K * 4 + n_weights * K * N * b_bytes + (1 + extra_out) \
        * M * N * 4
    flops = 2 * n_weights * M * N * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, n_copies, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls after a warm-up, cycling over
    ``n_copies`` operand sets so the weights come from HBM, not L2."""
    for i in range(warmup):
        fn(i % n_copies)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, n_copies, iters=20, warmup=3, stream=None):
    """Device ms per call: ``iters`` calls (cycling over ``n_copies``
    operand sets) captured in one CUDA graph and replayed between two CUDA
    events, so the host's cost of issuing each call drops out.  ``time_ms``
    beside it includes that cost: for a kernel that moves little, the two
    differ by the wrapper's Python.  ``stream``: the stream to warm up and
    capture on (an autograd backward must run on its forward's)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i % n_copies)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i % n_copies)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def max_steps(torch, ref, got, fmt):
    """Largest distance, in grid steps, between differing values."""
    from repro_torch.core.rounding import ulp
    diff = ref != got
    if not bool(diff.any()):
        return 0.0
    r, g = ref[diff], got[diff]
    return float(((r - g).abs() / ulp(torch.minimum(r.abs(), g.abs()),
                                      fmt)).max())


def bitwise(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def batched_cases():
    """Phases 15 and 21's K8'/K8 cases: (E, M, K, N, launches per decode
    step, launches per prompt)."""
    return ([(*c, 0) for c in BATCHED_SHAPES]
            + [(*c[:4], 0, c[4]) for c in BATCHED_PREFILL]
            + [(*BATCHED_RAGGED, 0, 0)])


def batched_routes_agree(torch, tq, run, label):
    """K8' or K8 run by ``run()`` on both routes (the route forced): bitwise
    equal, or the phase fails."""
    keep, outs = tq.BATCHED_STREAM_MAX_M, []
    for limit in (1 << 30, 0):
        tq.BATCHED_STREAM_MAX_M = limit
        try:
            outs.append(run())
        finally:
            tq.BATCHED_STREAM_MAX_M = keep
    torch.cuda.synchronize()
    if not bitwise(torch, *outs):
        fail(f"{label}: the weight-stream route differs from the large-M "
             "route")


@contextlib.contextmanager
def forced_route(tq, route):
    """K3''s and K4''s route forced: "decode" or "large" (the large-M
    route), whatever M."""
    keep = tq.DECODE_MAX_M
    tq.DECODE_MAX_M = (1 << 30) if route == "decode" else 0
    try:
        yield
    finally:
        tq.DECODE_MAX_M = keep


def glu_routes_agree(torch, tq, run, label):
    """K4' or K4 run by ``run()`` on both routes: every output (h and the
    residuals) bitwise equal, or the phase fails."""
    outs = {}
    for route in ("decode", "large"):
        with forced_route(tq, route):
            o = run()
        outs[route] = o if isinstance(o, tuple) else (o,)
    torch.cuda.synchronize()
    if not all(bitwise(torch, d, g)
               for d, g in zip(outs["decode"], outs["large"])):
        fail(f"{label}: the decode route differs from the large-M route")


def gemm_cases(train: bool):
    """Phase 3 (serving shapes) or phase 5 (train-step shapes): dicts of
    kernel, M, K, N, B dtype, launches per step, residuals."""
    if train:
        cases = [dict(kernel="qmatmul_sr", M=M, K=K, N=N, b=b, per_step=c,
                      residuals=False) for (M, K, N, b, c) in TRAIN_GEMMS]
        cases.append(dict(kernel="qmatmul_swiglu_sr", M=TRAIN_M,
                          K=TINYLLAMA["d"], N=TINYLLAMA["ff"], b="bf16",
                          per_step=LAYERS, residuals=True))
        return cases
    cases = [dict(kernel="qmatmul_sr", M=M, K=K, N=N, b="bf16", per_step=c,
                  residuals=False)
             for (K, N, c) in QMATMUL_SHAPES for M in (4, 128)]
    cases += [dict(kernel="qmatmul_swiglu_sr", M=M, K=K, N=N, b="bf16",
                   per_step=c, residuals=False)
              for (K, N, c) in SWIGLU_SHAPES for M in (4, 128)]
    cases += [dict(kernel=k, M=RAGGED[0], K=RAGGED[1], N=RAGGED[2], b="bf16",
                   per_step=0, residuals=False)
              for k in ("qmatmul_sr", "qmatmul_swiglu_sr")]
    return cases


def gemm_phase(torch, tq, cases):
    """Each GEMM kernel case against its plain twin; returns rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    words = (0x3C6EF372, 0xA54FF53A)
    seeds = ((0x510E527F, 0x9B05688C), (0x1F83D9AB, 0x5BE0CD19),
             (0xCBBB9D5D, 0x629A292A))
    from repro_torch.core.rounding import grid_flips, spec
    act = spec("binary8", "sr")
    rows = []

    def ints(shape, div):
        return (torch.randint(-8, 9, shape, generator=gen, device=dev)
                .float() / div)

    for case in cases:
        name, M, K, N = case["kernel"], case["M"], case["K"], case["N"]
        swiglu = name == "qmatmul_swiglu_sr"
        res = case["residuals"]
        nw = 2 if swiglu else 1
        b_dtype = torch.bfloat16 if case["b"] == "bf16" else torch.float32
        b_bytes = 2 if case["b"] == "bf16" else 4

        def run_kernel(a, ws, fmt="binary8", mode="sr", rb=32):
            if swiglu:
                return tq.qmatmul_swiglu_prng(a, ws[0], ws[1], seeds, fmt,
                                              mode, act_spec=act,
                                              rand_bits=rb, residuals=res)
            return tq.qmatmul_prng(a, ws[0], words, fmt, mode, rb)

        def run_plain(a, ws, fmt="binary8", mode="sr", rb=32):
            if swiglu:
                return tq.qmatmul_swiglu_plain(a, ws[0], ws[1], seeds, fmt,
                                               mode, rb, act_spec=act,
                                               residuals=res)
            return tq.qmatmul_plain(a, ws[0], words, fmt, mode, rb)

        def hidden(out):
            return out[0] if res else out

        # (a) exact sums: dyadic small values, every partial sum exact
        a = ints((M, K), 8.0)
        ws = [ints((K, N), 4.0).to(b_dtype) for _ in range(nw)]
        variants = [("binary8", "sr", 32), ("binary8", "rn", 32)]
        if (M, K, N) == RAGGED:
            variants += [("e4m3", "sr", 16), ("binary8", "sr", 8),
                         ("binary16", "rn", 32), ("bfloat16", "sr", 32)]
        for fmt, mode, rb in variants:
            got = run_kernel(a, ws, fmt, mode, rb)
            ref = run_plain(a, ws, fmt, mode, rb)
            torch.cuda.synchronize()
            if swiglu:
                glu_routes_agree(torch, tq, lambda: run_kernel(
                    a, ws, fmt, mode, rb), f"{name} {M}x{K}x{N} "
                    f"{fmt}-{mode}-r{rb}")
            if not swiglu and not bitwise(torch, got, ref):
                fail(f"{name} {M}x{K}x{N} {fmt}-{mode}-r{rb}: not bitwise "
                     "equal to the plain twin on exact-sum inputs")
            if swiglu:
                # the rounded branches are exact; SiLU's exp may move the
                # hidden across one act-grid decision
                if res and not all(bitwise(torch, r, g)
                                   for r, g in zip(ref[1:], got[1:])):
                    fail(f"{name} {M}x{K}x{N} {fmt}-{mode}: residuals not "
                         "bitwise equal on exact-sum inputs")
                n_bad, adjacent = grid_flips(hidden(ref), hidden(got),
                                             "binary8")
                if n_bad > 1e-4 * hidden(ref).numel() or not adjacent:
                    fail(f"{name} {M}x{K}x{N} {fmt}-{mode}: {n_bad} "
                         "mismatches on exact-sum inputs")
        # (b) N(0, 1) inputs: at most 1e-4 of the outputs differ.  A
        # qmatmul output differs by one grid step; in the fused kernel a
        # flip of a rounded branch (one step of g or u) propagates through
        # silu(g) * u, so the hidden may move by several act-grid steps
        a = torch.randn((M, K), generator=gen, device=dev)
        n_copies = max(2, math.ceil(2 * L2_BYTES / (nw * K * N * b_bytes)))
        if (M, K, N) == RAGGED:
            n_copies = 1
        wsets = [[(torch.randn((K, N), generator=gen, device=dev)
                   / math.sqrt(K)).to(b_dtype) for _ in range(nw)]
                 for _ in range(n_copies)]
        got = hidden(run_kernel(a, wsets[0]))
        ref = hidden(run_plain(a, wsets[0]))
        torch.cuda.synchronize()
        if swiglu:
            glu_routes_agree(torch, tq, lambda: run_kernel(a, wsets[0]),
                             f"{name} {M}x{K}x{N} N(0, 1)")
        n_bad, adjacent = grid_flips(ref, got, "binary8")
        share = n_bad / ref.numel()
        steps = max_steps(torch, ref, got, "binary8")
        if share > 1e-4 or not (adjacent or swiglu):
            fail(f"{name} {M}x{K}x{N}: {n_bad} mismatches ({share:.2e}), "
                 f"adjacent on the grid: {adjacent}")
        max_err = float((got - ref).abs().max())
        ms = time_ms(torch, lambda i: run_kernel(a, wsets[i]), n_copies)
        plain = time_ms(torch, lambda i: run_plain(a, wsets[i]), n_copies,
                        iters=3, warmup=1)
        w32 = [[w.float() for w in ws_] for ws_ in wsets]
        gemm = time_ms(torch, lambda i: [a @ w for w in w32[i]], n_copies)
        bms, by = bound_ms(M, K, N, nw, b_bytes, 2 if res else 0)
        row = dict(kernel=name, M=M, K=K, N=N, b=case["b"],
                   residuals=res, per_step=case["per_step"],
                   mismatches=n_bad, mismatch_share=share,
                   max_grid_steps=steps, max_abs_err=max_err, ms=ms,
                   plain_ms=plain, gemm_only_ms=gemm, bound_ms=bms,
                   bound_by=by)
        dev_note = ""
        if case["per_step"] and (swiglu or M <= tq.DECODE_MAX_M):
            # K3''s decode route and K4' at every path shape: device time by
            # graph replay beside the yardstick's, since time_ms here reads
            # the wrapper's host cost
            row["device_ms"] = graph_ms(
                torch, lambda i: run_kernel(a, wsets[i]), n_copies)
            row["library_device_ms"] = graph_ms(
                torch, lambda i: [a @ w for w in w32[i]], n_copies)
            dev_note = (f"  device {row['device_ms']:8.4f} ms (torch.matmul "
                        f"{row['library_device_ms']:8.4f})")
        rows.append(row)
        print(f"  {name:18s} M={M:5d} K={K:5d} N={N:6d} B={case['b']:4s}"
              f"{' +res' if res else ''}  kernel {ms:8.4f} ms  bound "
              f"{bms:8.4f} ms ({by})  plain {plain:8.3f} ms  "
              f"gemm-only(torch.matmul fp32) {gemm:8.4f} ms{dev_note}  flips "
              f"{n_bad}/{ref.numel()} (max {steps:g} steps)", flush=True)
        del a, ws, wsets, w32, got, ref
    return rows


def decode_rows_phase(torch, tq, tc):
    """K3''s decode route: each row bit for bit the same whatever rows
    share the call (the same A rows at M = 1, 2, 4, 8 and the route's
    largest M), for K3' and for K3 on the same words, and the large-M
    route's result bit for bit, at every decode shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    words = (0x243F6A88, 0x85A308D3)
    top = tq.DECODE_MAX_M
    for K, N, _ in QMATMUL_SHAPES:
        a = torch.randn((top, K), generator=gen, device=dev)
        w = (torch.randn((K, N), generator=gen, device=dev)
             / math.sqrt(K)).to(torch.bfloat16)
        full = tq.qmatmul_prng(a, w, words, "binary8")
        bits = int32_words(_bits2d(torch, tc, words, (top, N), 32))
        if not bitwise(torch, tq.qmatmul(a, w, bits, "binary8"), full):
            fail(f"qmatmul_bits {top}x{K}x{N}: not bitwise equal to "
                 "qmatmul_sr on the same words")
        for m in (1, 2, 4, 8):
            got = tq.qmatmul_prng(a[:m], w, words, "binary8")
            got_bits = tq.qmatmul(a[:m], w, bits[:m], "binary8")
            if not (bitwise(torch, got, full[:m])
                    and bitwise(torch, got_bits, full[:m])):
                fail(f"qmatmul_sr {m}x{K}x{N}: decode-route rows differ "
                     f"from the same rows at M = {top}")
        tq.DECODE_MAX_M = 0                 # the large-M route
        large = tq.qmatmul_prng(a, w, words, "binary8")
        tq.DECODE_MAX_M = top
        if not bitwise(torch, large, full):
            fail(f"qmatmul_sr {top}x{K}x{N}: the decode route differs from "
                 "the large-M route")
        print(f"  decode route K={K:5d} N={N:6d}: rows at M = 1, 2, 4, 8 "
              f"bitwise equal to the same rows at M = {top} (K3' and K3), "
              "and to the large-M route", flush=True)


def attn_bound(flops, n_threefry, nbytes):
    """(ms, bound_by) of attention work: bytes over the HBM rate against
    the larger of the fp32 flops over the fp32 peak and the Threefry
    integer work over the int32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(flops / PEAK_FP32_FLOPS,
                n_threefry * THREEFRY_OPS / PEAK_INT32_OPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_work(kernel, BH, BKV, S, d, pairs, G=None):
    """(flops, Threefry evaluations, bytes) one call needs for ``pairs``
    unmasked (query, key) pairs: each logit drawn once, two draws per
    Threefry evaluation; float32 operands read once, outputs written
    once (K9's cache: one byte per code, the ``S`` valid rows)."""
    if kernel == "flash_decode":
        rows = BKV * G
        return (2 * pairs * 2 * d, (pairs + 2 * rows * d) / 2,
                4 * rows * d * 2 + 2 * BKV * S * d)
    q_elems, kv_elems, rows = BH * S * d, BKV * S * d, BH * S
    if kernel == "flash_fwd":     # qk, pv; draws qk, av, out
        return (2 * pairs * 2 * d, (pairs + 2 * q_elems) / 2,
                4 * (2 * q_elems + 2 * kv_elems + 2 * rows))
    if kernel == "flash_bwd_dq":  # qk, dp, dq; draws qk, dq
        return (2 * pairs * 3 * d, (pairs + q_elems) / 2,
                4 * (3 * q_elems + 2 * kv_elems + 3 * rows))
    # flash_bwd_dkv: qk, dp, dv, dk; draws qk, dk, dv (per query head)
    return (2 * pairs * 4 * d, (pairs + 2 * q_elems) / 2,
            4 * (4 * q_elems + 2 * kv_elems + 3 * rows))


def attention_phase(torch, tfa):
    """K6, K7, K7' and K9 against their plain twins; timed at the main
    path's shapes.  Returns rows keyed by kernel."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.rounding import grid_flips, parse_spec
    from repro_torch.kernels import common
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    rng = np.random.default_rng(4321)

    def ints(shape):
        return torch.randint(-8, 9, shape, generator=gen,
                             device=dev).float() / 8

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def check_flips(what, ref, got, fmt):
        n_bad, adjacent = grid_flips(ref, got, fmt)
        share = n_bad / ref.numel()
        if share > max(1e-4, 1.0 / ref.numel()):
            fail(f"{what}: {n_bad} of {ref.numel()} elements differ")
        return dict(mismatches=n_bad, mismatch_share=share,
                    adjacent=adjacent,
                    max_abs_err=float((got - ref).abs().max()))

    def check_bitwise(what, ref, got):
        if not bitwise(torch, ref, got):
            fail(f"{what}: not bitwise equal to the plain twin")

    rows = {}
    # --- K6, K7, K7' at the train step's shapes, then a ragged case ---
    BH, BKV, S, d = (ATTN[k] for k in ("BH", "BKV", "S", "d"))
    cases = [(BH, BKV, S, 1024, "binary8-sr", ATTN["n_heads"], ATTN["n_kv"]),
             (32, 4, 200, 64, "binary8-sr", 8, 1),
             (32, 4, 200, 64, "binary8-sr-r16", 8, 1),
             (32, 4, 200, 64, "binary8-sr-r8", 8, 1)]
    for (bh, bkv, s_len, blk, name, nh, nkv) in cases:
        main = bh == BH and s_len == S
        specs = [parse_spec(name)] * 3
        seeds = rng.integers(0, 2 ** 32, (bh, 6), dtype=np.uint64)
        kw = dict(scale=d ** -0.5, n_heads=nh, n_kv=nkv, causal=True,
                  q_block=blk, kv_block=blk)
        tag = f"{name} B.H={bh} S={s_len} blocks={blk}"
        q, k, v = ints((bh, s_len, d)), ints((bkv, s_len, d)), \
            ints((bkv, s_len, d))
        got = tfa.flash_fwd(q, k, v, seeds, specs, return_logits=True, **kw)
        ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, return_logits=True,
                                  **kw)
        torch.cuda.synchronize()
        check_bitwise(f"flash_fwd logits {tag}", ref[3], got[3])
        check_bitwise(f"flash_fwd m {tag}", ref[1], got[1])
        del got, ref
        q, k, v, do = normal((bh, s_len, d)), normal((bkv, s_len, d)), \
            normal((bkv, s_len, d)), normal((bh, s_len, d))
        out, m, l = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
        r_out, r_m, r_l = tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
        torch.cuda.synchronize()
        res = {"flash_fwd": check_flips(f"flash_fwd out {tag}", r_out, out,
                                        "binary8")}
        rel_l = float(((l - r_l).abs() / r_l.abs()).max())
        # the single pass against the two-pass kernel: every output bitwise
        one = tfa.flash_fwd(q, k, v, seeds, specs, return_logits=True, **kw)
        two = tfa.flash_fwd(q, k, v, seeds, specs, return_logits=True,
                            kernel="flash_fwd_two_pass", **kw)
        torch.cuda.synchronize()
        for nm, a, b in zip(("out", "m", "l", "logits"), one, two):
            if not bitwise(torch, a, b):
                fail(f"flash_fwd {nm} {tag}: the single pass differs from "
                     "the two-pass kernel")
        del one, two
        dd = (do * r_out).sum(-1)
        seeds_dq = np.concatenate([seeds[:, :2], seeds[:, 4:]], axis=1)
        bwd = dict(dq=(tfa.flash_bwd_dq, tfa.flash_bwd_dq_plain,
                       (seeds_dq, specs[0], specs[0])),
                   dkv=(tfa.flash_bwd_dkv, tfa.flash_bwd_dkv_plain,
                        (seeds, specs[0], specs[0], specs[1])))
        for key, (kern, plain, extra) in bwd.items():
            before = dict(tfa.LAUNCHES)
            got = kern(q, k, v, do, r_m, r_l, dd, *extra, **kw)
            first = kern(q, k, v, do, r_m, r_l, dd, *extra, **kw,
                         kernel=f"{kern.__name__}_simple")
            ref = plain(q, k, v, do, r_m, r_l, dd, *extra, **kw)
            torch.cuda.synchronize()
            launched = {n: tfa.LAUNCHES[n] - before[n] for n in before
                        if tfa.LAUNCHES[n] != before[n]}
            if launched != {kern.__name__: 1, f"{kern.__name__}_simple": 1}:
                fail(f"{kern.__name__} {tag}: launches {launched}, not one "
                     "on each route")
            # the tiled kernel against the first kernel: bitwise
            for nm, a, b in zip(("dq",) if key == "dq" else ("dk", "dv"),
                                (got,) if key == "dq" else got,
                                (first,) if key == "dq" else first):
                if not bitwise(torch, a, b):
                    fail(f"flash_bwd {nm} {tag}: the tiled kernel differs "
                         "from the first kernel")
            del first
            pairs = zip(("dq",), (got,), (ref,)) if key == "dq" else \
                zip(("dk", "dv"), got, ref)
            checks = [check_flips(f"flash_bwd {nm} {tag}", r, g, "binary8")
                      for nm, g, r in pairs]
            res[kern.__name__] = {
                "mismatches": sum(c["mismatches"] for c in checks),
                "mismatch_share": max(c["mismatch_share"] for c in checks),
                "adjacent": all(c["adjacent"] for c in checks),
                "max_abs_err": max(c["max_abs_err"] for c in checks)}
            del got, ref
        print(f"  {tag}: logits and m bitwise (exact sums); dq, dk, dv of "
              "the tiled kernels bitwise the first kernels'; N(0,1) "
              f"mismatches out {res['flash_fwd']['mismatches']}, dq "
              f"{res['flash_bwd_dq']['mismatches']}, dk+dv "
              f"{res['flash_bwd_dkv']['mismatches']} (adjacent: "
              f"{[r['adjacent'] for r in res.values()]}); l max rel diff "
              f"{rel_l:.3g}", flush=True)
        if rel_l > 1e-5:
            fail(f"flash_fwd l {tag}: relative difference {rel_l}")
        for kname, r in res.items():
            rows.setdefault(kname, []).append(dict(case=tag, main=main, **r))
        if not main:
            continue
        # timing at the train shape (one launch per layer per step)
        pairs = bh * s_len * (s_len + 1) // 2
        gqa = dict(is_causal=True, enable_gqa=True)
        q4 = q.view(TRAIN_BATCH, nh, s_len, d)
        k4, v4 = (x.view(TRAIN_BATCH, nkv, s_len, d) for x in (k, v))
        do4 = do.view(TRAIN_BATCH, nh, s_len, d)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

        def sdpa_fwd_bwd(i):
            o = F.scaled_dot_product_attention(qg, kg, vg, **gqa)
            torch.autograd.grad(o, (qg, kg, vg), do4)

        # SDPA's backward alone, K7 and K7''s yardstick: one forward kept,
        # its graph retained across the timed calls; the forward on a
        # stream of its own, which its backward runs on, timed and
        # captured there
        def sdpa_bwd(i):
            torch.autograd.grad(o_kept, (qg, kg, vg), do4, retain_graph=True)

        sdpa_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, **gqa), 1)
        sdpa_both = time_ms(torch, sdpa_fwd_bwd, 1)
        s_bwd = torch.cuda.Stream()
        s_bwd.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s_bwd):
            o_kept = F.scaled_dot_product_attention(qg, kg, vg, **gqa)
            sdpa_bwd_ms = time_ms(torch, sdpa_bwd, 1)
            sdpa_bwd_dev = graph_ms(torch, sdpa_bwd, 1, stream=s_bwd)
        torch.cuda.current_stream().wait_stream(s_bwd)
        timed = {
            "flash_fwd": (lambda i: tfa.flash_fwd(q, k, v, seeds, specs,
                                                  **kw),
                          lambda i: tfa.flash_fwd_plain(q, k, v, seeds,
                                                        specs, **kw),
                          sdpa_fwd, "scaled_dot_product_attention forward"),
            "flash_bwd_dq": (
                lambda i: tfa.flash_bwd_dq(q, k, v, do, r_m, r_l, dd,
                                           seeds_dq, specs[0], specs[0],
                                           **kw),
                lambda i: tfa.flash_bwd_dq_plain(q, k, v, do, r_m, r_l, dd,
                                                 seeds_dq, specs[0],
                                                 specs[0], **kw),
                sdpa_bwd_ms, "scaled_dot_product_attention backward"),
            "flash_bwd_dkv": (
                lambda i: tfa.flash_bwd_dkv(q, k, v, do, r_m, r_l, dd, seeds,
                                            specs[0], specs[0], specs[1],
                                            **kw),
                lambda i: tfa.flash_bwd_dkv_plain(q, k, v, do, r_m, r_l, dd,
                                                  seeds, specs[0], specs[0],
                                                  specs[1], **kw),
                sdpa_bwd_ms, "scaled_dot_product_attention backward"),
        }
        # the backward kernels by graph replay: seed words already on the
        # card (a host copy cannot be captured)
        seeds_c, seeds_dq_c = (
            torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(dev)
            for x in (seeds, seeds_dq))

        def bwd_call(kname, on_card, **route):
            """One backward launch (``route``: a ``kernel=``), its seed
            words from the host or, for graph replay, on the card."""
            if kname == "flash_bwd_dq":
                return lambda i: tfa.flash_bwd_dq(
                    q, k, v, do, r_m, r_l, dd,
                    seeds_dq_c if on_card else seeds_dq, specs[0], specs[0],
                    **kw, **route)
            return lambda i: tfa.flash_bwd_dkv(
                q, k, v, do, r_m, r_l, dd, seeds_c if on_card else seeds,
                specs[0], specs[0], specs[1], **kw, **route)
        for kname, (kern, plain, lib, lib_what) in timed.items():
            ms = time_ms(torch, kern, 1)
            plain_ms = time_ms(torch, plain, 1, iters=3, warmup=1)
            flops, n_tf, nbytes = attn_work(kname, bh, bkv, s_len, d, pairs)
            bms, by = attn_bound(flops, n_tf, nbytes)
            rows[kname][-1].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                   bound_by=by, library_ms=lib,
                                   library=lib_what,
                                   tflops=flops / (ms * 1e-3) / 1e12)
            if kname != "flash_fwd":   # the backward: device times too,
                # and the first kernel's beside the tiled one's
                first = dict(kernel=f"{kname}_simple")
                rows[kname][-1].update(
                    device_ms=graph_ms(torch, bwd_call(kname, True), 1,
                                       iters=10),
                    library_device_ms=sdpa_bwd_dev,
                    library_fwd_bwd_ms=sdpa_both,
                    simple_ms=time_ms(torch, bwd_call(kname, False, **first),
                                      1),
                    simple_device_ms=graph_ms(
                        torch, bwd_call(kname, True, **first), 1, iters=10))
            print(f"  {kname:14s} B.H={bh} S={s_len} d={d}: kernel "
                  f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s)"
                  f"  bound {bms:.4f} ms ({by})  plain {plain_ms:.3f} ms  "
                  f"{lib_what} (float32, unrounded) {lib:.4f} ms"
                  + (f"; device (graph replay) kernel "
                     f"{rows[kname][-1]['device_ms']:.4f} ms (first kernel "
                     f"{rows[kname][-1]['simple_device_ms']:.4f}, by events "
                     f"{rows[kname][-1]['simple_ms']:.4f}), SDPA backward "
                     f"{sdpa_bwd_dev:.4f} ms, SDPA forward + backward "
                     f"{sdpa_both:.4f} ms" if kname != "flash_fwd" else ""),
                  flush=True)
        del o_kept
        del q, k, v, do, out, r_out, qg, kg, vg
        torch.cuda.empty_cache()

    # --- a logical block whose logits do not fit in shared memory: the
    # two-pass kernel, counted apart ---
    nf_bh, nf_s, nf_d = 4, 1024, 128
    if tfa.fwd_kernel_for(nf_s, nf_d, nf_d, nf_s) != "flash_fwd_two_pass":
        fail(f"flash_fwd: S={nf_s} d={nf_d} in one block was expected not "
             "to fit the single pass")
    before = dict(tfa.LAUNCHES)
    q, k, v = ints((nf_bh, nf_s, nf_d)), ints((1, nf_s, nf_d)), \
        ints((1, nf_s, nf_d))
    seeds = rng.integers(0, 2 ** 32, (nf_bh, 6), dtype=np.uint64)
    kw = dict(scale=nf_d ** -0.5, n_heads=nf_bh, n_kv=1, causal=True,
              q_block=nf_s, kv_block=nf_s)
    specs = [parse_spec("binary8-sr")] * 3
    got = tfa.flash_fwd(q, k, v, seeds, specs, return_logits=True, **kw)
    ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, return_logits=True,
                              **kw)
    torch.cuda.synchronize()
    check_bitwise(f"flash_fwd_two_pass logits S={nf_s} d={nf_d}", ref[3],
                  got[3])
    check_bitwise(f"flash_fwd_two_pass m S={nf_s} d={nf_d}", ref[1], got[1])
    launched = {n: tfa.LAUNCHES[n] - before[n] for n in before}
    if launched["flash_fwd_two_pass"] != 1 or launched["flash_fwd"] != 0:
        fail(f"flash_fwd S={nf_s} d={nf_d}: launches {launched}, not one "
             "two-pass launch")
    print(f"  B.H={nf_bh} S={nf_s} d={nf_d} in one block: the two-pass "
          "kernel, counted apart; logits and m bitwise (exact sums)",
          flush=True)
    del q, k, v, got, ref

    # --- K9 at the decode shapes: packed e4m3 codes, both routes ---
    BKVd, G, Smax = (DECODE[k] for k in ("BKV", "G", "Smax"))
    specs = [parse_spec("binary8-sr")] * 3
    seeds = rng.integers(0, 2 ** 32, (BKVd, 6), dtype=np.uint64)
    q = normal((BKVd, G, d))
    codes = [common.pack_block(parse_spec("e4m3-rn")(normal((BKVd, Smax, d))),
                               "e4m3") for _ in range(2)]
    floats = [common.unpack_block(c, "e4m3") for c in codes]
    seeds_d = torch.from_numpy(seeds.astype(np.uint32).view(np.int32)).to(dev)
    if tfa.decode_kernel_for(Smax, 512, d, d, 1) != "flash_decode":
        fail(f"flash_decode: S_max {Smax} was expected to run the decode "
             "kernel")
    tiled = dict(kernel="flash_decode_tiled")
    rows["flash_decode"] = []
    for length in (1, 17, Smax):
        kw = dict(scale=d ** -0.5, kv_fmt="e4m3")
        before = dict(tfa.LAUNCHES)
        got = tfa.flash_decode(q, *codes, seeds, length, specs, **kw)
        got_t = tfa.flash_decode(q, *codes, seeds, length, specs, **kw,
                                 **tiled)
        launched = {n: tfa.LAUNCHES[n] - before[n] for n in before
                    if tfa.LAUNCHES[n] != before[n]}
        unpacked = tfa.flash_decode(q, *floats, seeds, length, specs,
                                    scale=d ** -0.5)
        ref = tfa.flash_decode_plain(q, *codes, seeds, length, specs, **kw)
        torch.cuda.synchronize()
        if launched != {"flash_decode": 1, "flash_decode_tiled": 1}:
            fail(f"flash_decode length {length}: launches {launched}, not "
                 "one on each route")
        check_bitwise(f"flash_decode length {length}: packed vs unpacked",
                      unpacked, got)
        if not bitwise(torch, got_t, got):
            fail(f"flash_decode length {length}: the decode kernel differs "
                 "from the tiled kernel")
        r = check_flips(f"flash_decode length {length}", ref, got, "binary8")
        ms = time_ms(torch, lambda i: tfa.flash_decode(
            q, *codes, seeds, length, specs, **kw), 1, iters=50)
        tiled_ms = time_ms(torch, lambda i: tfa.flash_decode(
            q, *codes, seeds, length, specs, **kw, **tiled), 1, iters=50)
        plain_ms = time_ms(torch, lambda i: tfa.flash_decode_plain(
            q, *codes, seeds, length, specs, **kw), 1, iters=3, warmup=1)
        q4 = q.view(BATCH, DECODE["BKV"] // BATCH * G, 1, d)
        k4, v4 = (f.view(BATCH, DECODE["BKV"] // BATCH, Smax, d)[:, :, :length]
                  for f in floats)
        lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True), 1, iters=50)
        # device times (graph replay; the seed words already on the card)
        dev_ms = graph_ms(torch, lambda i: tfa.flash_decode(
            q, *codes, seeds_d, length, specs, **kw), 1)
        tiled_dev_ms = graph_ms(torch, lambda i: tfa.flash_decode(
            q, *codes, seeds_d, length, specs, **kw, **tiled), 1)
        lib_dev_ms = graph_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True), 1)
        flops, n_tf, nbytes = attn_work("flash_decode", None, BKVd, length,
                                        d, BKVd * G * length, G)
        bms, by = attn_bound(flops, n_tf, nbytes)
        rows["flash_decode"].append(dict(
            case=f"length {length}", main=length == Smax, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib,
            library="scaled_dot_product_attention (float32 cache, "
                    "unrounded)", device_ms=dev_ms,
            library_device_ms=lib_dev_ms, tiled_ms=tiled_ms,
            tiled_device_ms=tiled_dev_ms, **r))
        print(f"  flash_decode B.KV={BKVd} G={G} length={length}: packed == "
              f"unpacked, decode kernel == tiled kernel bitwise; mismatches "
              f"vs plain {r['mismatches']}; kernel {ms:.4f} ms (tiled "
              f"{tiled_ms:.4f})  bound {bms:.5f} ms ({by})  plain "
              f"{plain_ms:.3f} ms  sdpa {lib:.4f} ms; device (graph replay) "
              f"kernel {dev_ms:.5f} ms (tiled {tiled_dev_ms:.5f}), sdpa "
              f"{lib_dev_ms:.5f} ms", flush=True)
    # the routes on blocks of 64 with a ragged last block (S_max 200), a
    # window and blocks longer than one 128-key round, 32-, 16- and 8-bit
    # draws, e4m3 codes and float32: bitwise
    n_cases = 0
    for s_max, kb, lengths, window in ((200, 64, (1, 63, 65, 200), 0),
                                       (200, 64, (65, 200), 50),
                                       (300, 256, (129, 257, 300), 0)):
        kf, vf = (normal((BKVd, s_max, d)) for _ in range(2))
        cache = {None: (kf, vf), "e4m3": tuple(
            common.pack_block(parse_spec("e4m3-rn")(x), "e4m3")
            for x in (kf, vf))}
        for name in ("binary8-sr", "binary8-sr-r16", "binary8-sr-r8"):
            sp = [parse_spec(name)] * 3
            for fmt, (kc, vc) in cache.items():
                kw = dict(scale=d ** -0.5, kv_block=kb, window=window,
                          kv_fmt=fmt)
                for length in lengths:
                    a = tfa.flash_decode(q, kc, vc, seeds, length, sp, **kw)
                    b = tfa.flash_decode(q, kc, vc, seeds, length, sp, **kw,
                                         **tiled)
                    ref = tfa.flash_decode_plain(q, kc, vc, seeds, length,
                                                 sp, **kw)
                    torch.cuda.synchronize()
                    tag = (f"flash_decode S_max {s_max} kv_block {kb} "
                           f"window {window} {name} {fmt} length {length}")
                    if not bitwise(torch, a, b):
                        fail(f"{tag}: the decode kernel differs from the "
                             "tiled kernel")
                    r = check_flips(tag, ref, a, "binary8")
                    rows["flash_decode"].append(dict(case=tag, main=False,
                                                     **r))
                    n_cases += 1
    print(f"  flash_decode: {n_cases} more cases (S_max 200 / 300, blocks "
          "of 64 and 256, a window, 32/16/8-bit draws, e4m3 and float32): "
          "decode kernel == tiled kernel bitwise, within the contract of "
          "the twin", flush=True)
    return rows


def tinyllama_params() -> int:
    """Parameters of tinyllama-1.1b: embedding, lm head, final norm and
    per layer two norms, q/k/v/o and the three FFN matrices."""
    d, q, kv, ff = (TINYLLAMA[k] for k in ("d", "q", "kv", "ff"))
    per_layer = 2 * d + d * q + 2 * d * kv + q * d + 3 * d * ff
    return 2 * TINYLLAMA["vocab"] * d + d + LAYERS * per_layer


def n_threefry(cfg) -> int:
    """Threefry evaluations per element of K2': one per two stochastic
    steps."""
    return -(-sum(s.stochastic for s in cfg.step_specs()) // 2)


def update_bound(cfg, n: int, explicit_bits: bool):
    """(ms, bound_by, bytes) of one update of n elements: x, g read, x_new
    written, plus the bit rows of the stochastic steps for K2; K2''s
    operations are its Threefry integer work at the int32 rate."""
    rows = sum(s.stochastic for s in cfg.step_specs())
    nbytes = n * 4 * (3 + (rows if explicit_bits else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 0.0 if explicit_bits else \
        n * n_threefry(cfg) * THREEFRY_OPS / PEAK_INT32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def off_boundary(torch, t, offset: int):
    """A copy of ``t`` on its device that starts ``offset`` elements past a
    16-byte boundary (a view of a larger buffer)."""
    if not offset:
        return t
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


def update_instances(tfu, cfg):
    """The compiled instances of K2' and K2 a config fits: the wide one
    (every chain), the generic one where no site needs the wide one, and
    the trainer's where the chain is ``train.PAPER_RUN``'s."""
    own = tfu.k2_instance(cfg)
    return ["wide"] + (["generic"] if own != "wide" else []) + (
        ["trainer"] if own == "trainer" else [])


def register_wide_grids():
    """The shifted grid of ``WIDE_UPDATE_CONFIGS`` (idempotent)."""
    from repro_torch.core import grids
    grids.register_grid(grids.shifted_grid("binary8", 0.5, 0.25,
                                           name="shift8"))


def update_check(torch, tfu, prng, x, g, cfg, name, offset=0):
    """K2' and K2 under every instance the config fits against their
    twins, bitwise, with x, g and the bit rows ``offset`` elements off a
    16-byte boundary; returns (max abs error of K2', of K2, the bits)."""
    n = x.numel()
    bits3 = prng.random_words(prng.fold_in(prng.PRNGKey(5), n), (3, n),
                              x.device)
    ref_prng = tfu.fused_qupdate_prng_plain(x, g, UPDATE_T, UPDATE_SEED, cfg)
    ref_bits = tfu.fused_qupdate_plain(x, g, UPDATE_T, bits3, cfg)
    xv, gv = off_boundary(torch, x, offset), off_boundary(torch, g, offset)
    bv = off_boundary(torch, bits3, offset)
    errs = [0.0, 0.0]
    for instance in update_instances(tfu, cfg):
        for k, (got, ref) in enumerate((
                (tfu.fused_qupdate_prng(xv, gv, UPDATE_T, UPDATE_SEED, cfg,
                                        instance=instance), ref_prng),
                (tfu.fused_qupdate(xv, gv, UPDATE_T, bv, cfg,
                                   instance=instance), ref_bits))):
            torch.cuda.synchronize()
            if not bitwise(torch, got, ref):
                fail(f"{('fused_qupdate_prng', 'fused_qupdate_bits')[k]} "
                     f"n={n} {name} instance {instance} offset {offset}: "
                     "not bitwise equal to the plain twin")
            errs[k] = max(errs[k], float((got - ref).abs().max()))
            del got
    del ref_prng, ref_bits, xv, gv, bv
    return errs[0], errs[1], bits3


def update_phase(torch, n_full: int):
    """K2' and K2 against their plain twins (bitwise, under each compiled
    instance a config fits) and timed."""
    from repro_torch.core import gd, prng
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.launch.train import rounding_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    register_wide_grids()
    trainer = rounding_config("signed_sr_eps", "binary8", 0.1)
    configs = {"signed_sr_eps-binary8 (trainer)": trainer}
    configs.update({k: gd.GDRounding(*(parse_spec(s) for s in v))
                    for k, v in UPDATE_CONFIGS.items()})
    scales = dict.fromkeys(configs, (1.0, 1.0))
    for k, (v, sx, sg) in WIDE_UPDATE_CONFIGS.items():
        configs[k] = gd.GDRounding(*(parse_spec(s) for s in v))
        scales[k] = (sx, sg)
        if tfu.k2_instance(configs[k]) != "wide":
            fail(f"{k}: not a chain of the wide instance")
    rows = []
    for name, cfg in configs.items():
        sx, sg = scales[name]
        for n in UPDATE_TAILS:
            x = torch.randn(n, generator=gen, device=dev) * (0.02 * sx)
            g = torch.randn(n, generator=gen, device=dev) * (0.3 * sg)
            x[::7] = -0.0
            for offset in (0, 1):
                update_check(torch, tfu, prng, x, g, cfg, name, offset)
        print(f"  {name}: instances {update_instances(tfu, cfg)} (runs "
              f"{tfu.k2_instance(cfg)}): K2' and K2 bitwise equal to their "
              f"twins at n = {UPDATE_TAILS}, aligned and one element off a "
              "16-byte boundary", flush=True)
    for n, names in ((UPDATE_N_SMALL, list(configs)),
                     (n_full, ["signed_sr_eps-binary8 (trainer)"])):
        x0 = torch.randn(n, generator=gen, device=dev) * 0.02
        g0 = torch.randn(n, generator=gen, device=dev) * 0.3
        for name in names:
            cfg = configs[name]
            sx, sg = scales[name]
            x, g = (x0, g0) if (sx, sg) == (1.0, 1.0) else (x0 * sx, g0 * sg)
            err_prng, err_bits, bits3 = update_check(torch, tfu, prng, x, g,
                                                     cfg, name)
            if n == UPDATE_N_SMALL:     # and the view off the boundary
                update_check(torch, tfu, prng, x, g, cfg, name, offset=1)
            row = dict(n=n, config=name, bitwise=True,
                       instance=tfu.k2_instance(cfg),
                       instances_checked=update_instances(tfu, cfg),
                       max_abs_err_prng=err_prng, max_abs_err_bits=err_bits)
            if name.endswith("(trainer)"):
                iters = 10 if n > UPDATE_N_SMALL else 50
                row.update(
                    prng_ms=time_ms(torch, lambda i: tfu.fused_qupdate_prng(
                        x, g, UPDATE_T, UPDATE_SEED, cfg), 1, iters=iters),
                    bits_ms=time_ms(torch, lambda i: tfu.fused_qupdate(
                        x, g, UPDATE_T, bits3, cfg), 1, iters=iters),
                    # the same config through the generic instance
                    prng_generic_ms=time_ms(
                        torch, lambda i: tfu.fused_qupdate_prng(
                            x, g, UPDATE_T, UPDATE_SEED, cfg,
                            instance="generic"), 1, iters=iters),
                    bits_generic_ms=time_ms(
                        torch, lambda i: tfu.fused_qupdate(
                            x, g, UPDATE_T, bits3, cfg, instance="generic"),
                        1, iters=iters),
                    prng_plain_ms=time_ms(
                        torch, lambda i: tfu.fused_qupdate_prng_plain(
                            x, g, UPDATE_T, UPDATE_SEED, cfg), 1,
                        iters=1, warmup=1),
                    bits_plain_ms=time_ms(
                        torch, lambda i: tfu.fused_qupdate_plain(
                            x, g, UPDATE_T, bits3, cfg), 1,
                        iters=1, warmup=1),
                    axpy_ms=time_ms(torch, lambda i: torch.add(
                        x, g, alpha=-UPDATE_T), 1, iters=iters),
                    # a plain PyTorch step of the trainer around the update
                    bf16_cast_ms=time_ms(torch, lambda i: x.to(
                        torch.bfloat16), 1, iters=iters))
                for mode, explicit in (("prng", False), ("bits", True)):
                    bms, by, nbytes = update_bound(cfg, n, explicit)
                    row[f"{mode}_bound_ms"], row[f"{mode}_bound_by"] = bms, by
                    row[f"{mode}_bytes"] = nbytes
                row["threefry_per_elt"] = n_threefry(cfg)
                row.update(wide_timing(torch, tfu, x, g, bits3, n))
                print(f"  n={n:11d} {name}, instance {row['instance']}: K2' "
                      f"{row['prng_ms']:.3f} ms (generic instance "
                      f"{row['prng_generic_ms']:.3f}; bound "
                      f"{row['prng_bound_ms']:.3f} ms, "
                      f"{row['prng_bound_by']}; plain "
                      f"{row['prng_plain_ms']:.1f} ms)  K2 "
                      f"{row['bits_ms']:.3f} ms (generic "
                      f"{row['bits_generic_ms']:.3f}; bound "
                      f"{row['bits_bound_ms']:.3f} ms, "
                      f"{row['bits_bound_by']}; plain "
                      f"{row['bits_plain_ms']:.1f} ms)  unrounded x - t*g "
                      f"{row['axpy_ms']:.3f} ms; bf16 cast "
                      f"{row['bf16_cast_ms']:.3f} ms", flush=True)
            else:
                print(f"  n={n:11d} {name}, instances "
                      f"{update_instances(tfu, cfg)}: K2' and K2 bitwise "
                      "equal to their twins (also off a 16-byte boundary)",
                      flush=True)
            rows.append(row)
            del bits3, x, g
        rows.append(momentum_fma_check(torch, tfu, x0, g0, n == n_full))
        del x0, g0
        torch.cuda.empty_cache()
    return rows


def wide_timing(torch, tfu, x, g, bits3, n: int):
    """K2' and K2 under ``WIDE_TIMED`` (a chain both instances take) on
    the generic and the wide instance: ms by CUDA events, ``device_ms`` by
    graph replay, and the chain's bound."""
    from repro_torch.core import gd
    from repro_torch.core.rounding import parse_spec
    cfg = gd.GDRounding(*(parse_spec(s) for s in WIDE_TIMED))
    out = dict(wide_timed_chain="/".join(WIDE_TIMED))
    for mode, explicit in (("prng", False), ("bits", True)):
        for inst in ("generic", "wide", "wide", "generic"):
            def call(i, inst=inst):
                if explicit:
                    return tfu.fused_qupdate(x, g, UPDATE_T, bits3, cfg,
                                             instance=inst)
                return tfu.fused_qupdate_prng(x, g, UPDATE_T, UPDATE_SEED,
                                              cfg, instance=inst)
            out.setdefault(f"{mode}_{inst}_rss_ms", []).append(
                time_ms(torch, call, 1, iters=5, warmup=1))
            out.setdefault(f"{mode}_{inst}_rss_device_ms", []).append(
                graph_ms(torch, call, 1, iters=3, warmup=1))
        bms, by, _ = update_bound(cfg, n, explicit)
        out[f"{mode}_rss_bound_ms"], out[f"{mode}_rss_bound_by"] = bms, by
        for inst in ("generic", "wide"):
            for key in (f"{mode}_{inst}_rss_ms", f"{mode}_{inst}_rss_device_ms"):
                out[key] = min(out[key])
        label = "K2" if explicit else "K2'"
        print(f"  n={n:11d} {out['wide_timed_chain']}: {label}"
              f" generic {out[f'{mode}_generic_rss_device_ms']:.3f} ms device "
              f"({out[f'{mode}_generic_rss_ms']:.3f} events), wide "
              f"{out[f'{mode}_wide_rss_device_ms']:.3f} ms device "
              f"({out[f'{mode}_wide_rss_ms']:.3f}); ratio "
              f"{out[f'{mode}_wide_rss_device_ms'] / out[f'{mode}_generic_rss_device_ms']:.3f}; "
              f"bound {bms:.3f} ms ({by})", flush=True)
    return out


def momentum_fma_check(torch, tfu, m, g, timed: bool):
    """The momentum FMA kernel against its float64 emulation (bitwise),
    with float32 subnormal operands and results in the mix."""
    m = m.clone()
    m[2::23] = 1e-40
    m[5::41] = 2e-38
    g = g.clone()
    g[5::41] = -1.7e-38
    got = tfu.momentum_fma(MOMENTUM, m, g)
    ref = tfu.momentum_fma_plain(MOMENTUM, m, g)
    torch.cuda.synchronize()
    n = m.numel()
    if not bitwise(torch, got, ref):
        fail(f"momentum_fma n={n}: not bitwise equal to the plain twin")
    row = dict(n=n, config="momentum_fma", bitwise=True,
               max_abs_err_fma=float((got - ref).abs().max()))
    del got, ref
    if timed:
        nbytes = 12 * n
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2 * n / PEAK_FP32_FLOPS
        row.update(
            fma_ms=time_ms(torch, lambda i: tfu.momentum_fma(MOMENTUM, m, g),
                           1, iters=10),
            fma_plain_ms=time_ms(torch, lambda i: tfu.momentum_fma_plain(
                MOMENTUM, m, g), 1, iters=3, warmup=1),
            add_alpha_ms=time_ms(torch, lambda i: torch.add(
                g, m, alpha=MOMENTUM), 1, iters=10),
            fma_bound_ms=1e3 * max(t_bytes, t_ops),
            fma_bound_by="bytes" if t_bytes >= t_ops else "operations",
            fma_bytes=nbytes)
        print(f"  n={n:11d} momentum fma: kernel {row['fma_ms']:.3f} ms "
              f"(bound {row['fma_bound_ms']:.3f} ms, {row['fma_bound_by']}; "
              f"plain {row['fma_plain_ms']:.1f} ms)  torch.add(alpha) "
              f"{row['add_alpha_ms']:.3f} ms", flush=True)
    else:
        print(f"  n={n:11d} momentum fma bitwise equal to its twin",
              flush=True)
    return row


def serve_phase(torch, mods, serve, policy="binary8-paper", keep=None):
    """The full-size serve run under ``policy`` (a preset name or a
    QuantPolicy); every launch count checked.  Under an oracle policy the
    explicit-bits kernels run in place of the in-kernel-bits ones, and the
    host seconds spent issuing the bits are reported.  ``keep``: a dict
    that receives the run's tokens and logits (on the host)."""
    from repro_torch.precision.policy import resolve_policy
    gc.collect()          # an earlier phase's cycles hold device memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all(*mods)
    run = serve.SERVE_RUN
    if (run["arch"], run["batch"], run["prompt_len"], run["gen"]) != (
            "tinyllama-1.1b", BATCH, PROMPT, GEN):
        fail(f"serve.SERVE_RUN {run} is not the run whose shapes phases 3 and 10 "
             "checks")
    oracle = resolve_policy(policy).oracle
    with bits_clock() as bits_s:
        out = serve.run(**run, gemm_policy=policy, device="cuda")
    launches = all_launches(*mods)
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT + GEN
    attn = policy == ATTN_POLICY
    q, glu = ("qmatmul_bits", "qmatmul_swiglu_bits") if oracle \
        else ("qmatmul_sr", "qmatmul_swiglu_sr")
    want = {q: 5 * LAYERS * steps + GEN, glu: LAYERS * steps,
            "flash_decode": LAYERS * steps if attn else 0}
    want = every_kernel(want, launches)
    if launches != want:
        fail(f"launch counts {launches} != expected {want}")
    toks, logits = out["tokens"], out["logits"]
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= TINYLLAMA["vocab"]:
        fail(f"bad tokens {toks.tolist()}")
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    if keep is not None:
        keep.update(tokens=toks.cpu(), logits=logits.cpu())
    wall = out["t_prefill"] + out["t_decode"]
    print(f"  prefill {out['prefill_tokps']:.1f} tok/s, decode "
          f"{out['decode_tokps']:.1f} tok/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, kv cache {out['cache_dtype']} "
          f"{out['cache_bytes']} bytes, launches "
          f"{ {k: v for k, v in launches.items() if v} }"
          + (f", bits issued in {bits_s[0]:.3f} s of {wall:.3f} s on the "
             "host" if oracle else ""), flush=True)
    return dict(prefill_tokps=out["prefill_tokps"],
                decode_tokps=out["decode_tokps"], t_prefill=out["t_prefill"],
                t_decode=out["t_decode"], peak_bytes=peak,
                cache_dtype=str(out["cache_dtype"]),
                cache_bytes=out["cache_bytes"], launches=launches,
                bits_host_s=bits_s[0], bits_host_share=bits_s[0] / wall)


@contextlib.contextmanager
def bits_clock():
    """Host seconds spent in the oracle's bits builders
    (``common.counter_bits_reduced`` / ``counter_bits_batch``, plain
    tensor code that the explicit-bits sites run before each launch),
    accumulated into the yielded one-element list."""
    from repro_torch.kernels import common
    total = [0.0]
    saved = {n: getattr(common, n) for n in ("counter_bits_reduced",
                                             "counter_bits_batch")}

    def timed(fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                total[0] += time.perf_counter() - t0
        return wrapped
    for n, fn in saved.items():
        setattr(common, n, timed(fn))
    try:
        yield total
    finally:
        for n, fn in saved.items():
            setattr(common, n, fn)


def agreement_phase(torch, serve, policy="binary8-paper"):
    """The whole serving path on the card vs the plain twins on the CPU;
    under a packed-cache policy the uint8 cache codes are compared too."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy=policy)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(7))
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(8))
    cpu = serve.serve_batch(model, params, prompts, 4)

    def to_cuda(t):
        return {k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.cuda()

    card = serve.serve_batch(model, to_cuda(params), prompts.cuda(), 4,
                             forced=cpu["tokens"].cuda())
    d = (card["logits"].cpu() - cpu["logits"]).abs()
    med, share = float(d.median()), float((d > 0.05).float().mean())
    res = dict(median_abs_dlogit=med, share_over_0_05=share)
    if policy == ATTN_POLICY:
        cc, gc = cpu["caches"]["attn"], card["caches"]["attn"]
        if gc.k.dtype != torch.uint8:
            fail(f"{policy} cache holds {gc.k.dtype}, not uint8 codes")
        per_layer = [float(((a[i] != b[i].cpu()).float().mean()))
                     for a, b in ((cc.k, gc.k), (cc.v, gc.v))
                     for i in range(a.shape[0])]
        res["code_share_by_layer"] = per_layer
    print(f"  reduced tinyllama {policy} card vs cpu: median |dlogit| "
          f"{med:.4g}, share > 0.05 {share:.4g}"
          + (f", cache codes differing by layer (k, then v) "
             f"{res['code_share_by_layer']}" if "code_share_by_layer" in res
             else ""), flush=True)
    if not (med < 0.02 and share <= 0.10):
        fail("card and CPU paths disagree beyond the stated tolerance")
    if max(res.get("code_share_by_layer", [0.0])) > ATTN_AGREE_MAX_CODE_SHARE:
        fail("card and CPU cache codes disagree beyond the stated tolerance")
    return res


@contextlib.contextmanager
def ckpt_dir(tag: str):
    """A fresh checkpoint directory under the checkout's ``build/``,
    removed afterwards (a directory holding a checkpoint at the run's
    total step count would make ``train.run`` resume and take no step)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    path = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=BUILD)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def reset_all(*mods):
    for mod in mods:
        mod.reset_launches()


def all_launches(*mods):
    return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}


def policy_name(policy) -> str:
    """A preset name as it is; a QuantPolicy by its oracle form."""
    if isinstance(policy, str):
        return policy
    return f"oracle {policy.fwd}" if policy.oracle else str(policy)


def every_kernel(want, launches):
    """``want`` over every counted kernel: those it does not name were
    launched no time."""
    return {**dict.fromkeys(launches, 0), **want}


def train_phase(torch, mods, train, policy="binary8-paper"):
    """The full-size train run (``train.PAPER_RUN`` under ``policy``);
    returns its numbers."""
    gc.collect()          # an earlier run's cycles hold device memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = dict(train.PAPER_RUN, gemm_policy=policy)
    if (run["arch"], run["batch"], run["seq"]) != ("tinyllama-1.1b",
                                                   TRAIN_BATCH, TRAIN_SEQ):
        fail(f"train.PAPER_RUN {run} is not the run whose shapes phase 5 "
             "checks")
    reset_all(*mods)
    with ckpt_dir("paper") as ckpt:
        out = train.run(steps=TRAIN_STEPS, device="cuda", ckpt_dir=ckpt,
                        **run)
    launches = all_launches(*mods)
    peak = torch.cuda.max_memory_allocated()
    n_attn = TRAIN_STEPS * LAYERS if policy == ATTN_POLICY else 0
    want = {"qmatmul_sr": TRAIN_STEPS * TRAIN_QMATMUL_PER_STEP,
            "qmatmul_swiglu_sr": TRAIN_STEPS * LAYERS,
            "qmatmul_batched_sr": 0, "sr_cast_prng": 0,
            "fused_qupdate_prng": TRAIN_STEPS, "fused_qupdate_bits": 0,
            "momentum_fma": TRAIN_STEPS, "fused_qadam_prng": 0,
            "flash_fwd": n_attn,
            "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn,
            "flash_decode": 0}
    want = every_kernel(want, launches)
    if launches != want:
        fail(f"train launch counts {launches} != expected {want}")
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v)
                                             for v in losses):
        fail(f"train losses not finite: {losses}")
    step_ms = [h["ms"] for h in out["history"]]
    # the first step includes one-time CUDA library start-up
    steady = step_ms[1:] if len(step_ms) > 1 else step_ms
    steady_ms = sum(steady) / len(steady)
    if out["n_params"] != tinyllama_params():
        fail(f"train run has {out['n_params']} parameters, not "
             f"{tinyllama_params()}")
    res = dict(losses=losses, step_ms=step_ms, steady_ms=steady_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (steady_ms / 1e3),
               peak_bytes=peak, launches=launches, n_params=out["n_params"])
    print(f"  params {out['n_params']}, losses {losses}, ms/step {step_ms}, "
          f"steady {steady_ms:.1f} ms/step, "
          f"{res['tokens_per_s']:.1f} tok/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}", flush=True)
    del out
    torch.cuda.empty_cache()
    return res


def train_agreement_phase(torch, mods, train, policy="binary8-paper",
                          paths=("fused", "fused_bits"), adam=False):
    """Reduced tinyllama, 2 steps on the card vs the CPU twins from the
    same parameters and batches: the parameters bitwise equal but for a
    handful (``AGREE_MAX_PARAMS``; with ``adam``, the m and v codes or
    values too) and the losses within ``AGREE_MAX_REL_LOSS`` relative.  A
    GEMM sum that lands within a float32 ulp of a rounding decision would
    flip and move the stochastic updates behind it (percents of the
    parameters); this draw has none."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.tree_update import tree_leaves
    from repro_torch.models import build_model
    cfg = reduced(get_config("tinyllama-1.1b"))
    master = build_model(cfg).init_master(torch.Generator().manual_seed(3))
    res, launches = {}, {}
    # phase 9's learning rate, at which these limits were read
    opt_kw = {k: train.ADAM_RUN[k] for k in
              ("optimizer", "moments_spec", "ckpt_fmt")} if adam else {}
    for path in paths:
        kw = dict(reduced=True, steps=2, batch=2, seq=16,
                  gemm_policy=policy, rounding_kind="signed_sr_eps",
                  fmt="binary8", eps=0.1, update_path=path, verbose=False,
                  **opt_kw)
        with ckpt_dir("agree_cpu") as ckpt:
            cpu = train.run("tinyllama-1.1b", device="cpu", params=master,
                            ckpt_dir=ckpt, **kw)
        reset_all(*mods)
        with ckpt_dir("agree_card") as ckpt:
            card = train.run("tinyllama-1.1b", device="cuda",
                             params=_to(master, "cuda"), ckpt_dir=ckpt, **kw)
        torch.cuda.synchronize()
        launches[path] = all_launches(*mods)
        if adam:
            kernel = "fused_qadam_prng" if path == "fused" \
                else "fused_qupdate_bits"
            want = {kernel: 2, "momentum_fma": 0, "fused_qupdate_prng": 0}
        else:
            kernel = "fused_qupdate_prng" if path == "fused" \
                else "fused_qupdate_bits"
            want = {kernel: 2, "momentum_fma": 2}
        if policy == ATTN_POLICY:
            want.update({k: 2 * cfg.n_layers for k in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
        for k, n in want.items():
            if launches[path][k] != n:
                fail(f"train agreement {path}: {k} launched "
                     f"{launches[path][k]} times, not {n}")
        lc = [h["loss"] for h in cpu["history"]]
        lg = [h["loss"] for h in card["history"]]
        rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        n_diff, n = differing(torch, tree_leaves(cpu["params"]),
                              tree_leaves(card["params"]))
        moments = {}
        if adam:
            for name in ("m", "v"):
                moments[name] = differing(
                    torch, tree_leaves(getattr(cpu["opt_state"], name)),
                    tree_leaves(getattr(card["opt_state"], name)))[0]
        print(f"  {policy} {path}: losses cpu {lc} card {lg} (max rel diff "
              f"{rel:.3g}), parameters differing {n_diff}/{n} "
              f"({n_diff / n:.3g})"
              + (f", moments differing {moments}" if adam else ""),
              flush=True)
        if rel > AGREE_MAX_REL_LOSS or n_diff > AGREE_MAX_PARAMS \
                or max(moments.values(), default=0) > AGREE_MAX_PARAMS:
            fail(f"train agreement {path}: beyond the stated tolerance")
        res[path] = dict(losses_cpu=lc, losses_card=lg, max_rel_loss=rel,
                         params_differing=n_diff, params=n,
                         moments_differing=moments)
    return res, launches


def differing(torch, leaves_a, leaves_b):
    """(elements whose bits differ, elements) over two lists of tensors on
    any devices."""
    n_diff = n = 0
    for a, b in zip(leaves_a, leaves_b):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n_diff += int((a != b).sum())
        n += a.numel()
    return n_diff, n


def adam_bound(cfg, n: int, m_spec, v_spec, packed: bool, kahan: bool):
    """(ms, bound_by, bytes, Threefry per element) of one K5 launch over n
    elements: x, g, the carries (and Kahan carries) read once, x⁺ and the
    new carries written once; Threefry evaluations: a moment site drawing
    r-bit fields takes one word pair per 64 / r elements, the chain one
    per element for every two stochastic steps."""
    from repro_torch.kernels.common import pack_bytes
    per = 12 + (16 if kahan else 0)
    for sp in (m_spec, v_spec):
        per += 2 * (pack_bytes(sp.fmt) if packed else 4)
    tf = sum(sp.rand_bits / 64 for sp in (m_spec, v_spec) if sp.stochastic)
    tf += n_threefry(cfg)
    t_bytes = n * per / PEAK_BYTES_PER_S
    t_ops = n * tf * THREEFRY_OPS / PEAK_INT32_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", n * per, tf)


def adam_inputs(torch, n, m_spec, v_spec, packed, kahan, gen, dev):
    """Mid-trajectory K5 operands: x, g, the carries on their grids (as
    codes when packed), float32 subnormals and subnormal squares mixed
    in.  The carries are made 2**26 elements at a time: the plain
    rounding's temporaries over all of tinyllama's parameters would not
    fit on the card."""
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels.common import pack_block
    x = torch.randn(n, generator=gen, device=dev) * 0.02
    g = torch.randn(n, generator=gen, device=dev) * 0.3
    g[3::83] = 2e-39
    g[5::79] = 1e-20

    def start(sp, vals):
        vals = vals if sp.is_identity else parse_spec(f"{sp.fmt}-rn")(vals)
        return pack_block(vals, sp.fmt) if packed else vals
    parts = [(start(m_spec, 0.1 * gi), start(v_spec, 0.05 * gi * gi + 1e-6))
             for gi in g.split(1 << 26)]
    m, v = (torch.cat([p[k] for p in parts]) for k in (0, 1))
    del parts
    comp = [torch.randn(n, generator=gen, device=dev) * s
            for s in (1e-7, 1e-10)] if kahan else [None, None]
    return x, g, m, v, comp


def adam_phase(torch, tfu, n_full: int):
    """K5 against its plain twin (bitwise in x, the moments and the Kahan
    carries) at n = 2**24 + 37 for every case and chain, on a view off a
    16-byte boundary, then bitwise and timed over the tinyllama-1.1b
    parameter count beside the bound, the twin and
    ``torch.optim.Adam(fused=True)``."""
    from repro_torch.core import gd
    from repro_torch.core.rounding import parse_spec
    from repro_torch.launch.train import rounding_config
    from repro_torch.optim import qadam
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    configs = {"signed_sr_eps-binary8 (trainer)":
               rounding_config("signed_sr_eps", "binary8", 0.1)}
    configs.update({k: gd.GDRounding(*(parse_spec(s) for s in v))
                    for k, v in UPDATE_CONFIGS.items()})
    scal = qadam(lr=UPDATE_T, weight_decay=0.01).scalars(UPDATE_T, 3)
    rows = []

    def check(x, g, m, v, comp, cfg, m_spec, v_spec, packed, what,
              scal=scal):
        kw = dict(m_spec=m_spec, v_spec=v_spec, b1=0.9, b2=0.999,
                  packed=packed, cm=comp[0], cv=comp[1])
        got = tfu.fused_qadam_prng(x, g, m, v, scal, UPDATE_SEED, cfg, **kw)
        ref = tfu.fused_qadam_prng_plain(x, g, m, v, scal, UPDATE_SEED, cfg,
                                         **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if a.dtype == torch.float32:
                same = bitwise(torch, a, b)
            else:
                same = torch.equal(a, b)
            if not same:
                fail(f"fused_qadam_prng {what}: not bitwise equal to the "
                     "plain twin")
        return float((got[0] - ref[0]).abs().max())

    n = UPDATE_N_SMALL
    for case in ADAM_CASES:
        m_spec, v_spec = parse_spec(case[0]), parse_spec(case[1])
        x, g, m, v, comp = adam_inputs(torch, n, m_spec, v_spec, case[2],
                                       case[3], gen, dev)
        for name, cfg in configs.items():
            err = check(x, g, m, v, comp, cfg, m_spec, v_spec, case[2],
                        f"n={n} {case} {name}")
            rows.append(dict(n=n, case=list(case), config=name,
                             bitwise=True, max_abs_err=err,
                             instance=tfu.k5_instance(cfg, m_spec, v_spec,
                                                      case[2], case[3])))
        insts = sorted({r["instance"] for r in rows
                        if r["case"] == list(case)})
        print(f"  n={n} m={case[0]} v={case[1]} packed={case[2]} "
              f"kahan={case[3]}: bitwise equal to the twin under "
              f"{len(configs)} chains (instances {insts})", flush=True)
        if case == ADAM_CASES[0]:
            # the same operands at an odd element offset: 4-byte aligned
            # only, as a view of a larger tensor is
            xo = torch.cat([x[:1], x])[1:]
            go = torch.cat([g[:1], g])[1:]
            cfg = configs["signed_sr_eps-binary8 (trainer)"]
            err = check(xo, go, m, v, comp, cfg, m_spec, v_spec, case[2],
                        "off a 16-byte boundary")
            rows.append(dict(n=n, case=list(case), config="unaligned view",
                             bitwise=True, max_abs_err=err))
            print("  a view off a 16-byte boundary: bitwise equal",
                  flush=True)
        del x, g, m, v, comp
    torch.cuda.empty_cache()

    # one launch over the tinyllama-1.1b parameters as train.ADAM_RUN
    # makes it from its step 2 on: bf16-sr codes of moments that are not
    # zero, the trainer's chain, ADAM_RUN's learning rate at step 3; held
    # bitwise to the twin at this size (64-bit indexing, rows past 2**24),
    # then timed
    from repro_torch.launch.train import ADAM_RUN
    m_spec = parse_spec(ADAM_RUN["moments_spec"])
    cfg = configs["signed_sr_eps-binary8 (trainer)"]
    x, g, m, v, _ = adam_inputs(torch, n_full, m_spec, m_spec, True, False,
                                gen, dev)
    torch.cuda.empty_cache()
    lr = ADAM_RUN["lr"]
    scal3 = qadam(lr=lr).scalars(lr, 3)
    kw = dict(m_spec=m_spec, v_spec=m_spec, b1=0.9, b2=0.999, packed=True)
    instance = tfu.k5_instance(cfg, m_spec, m_spec, True, False)
    if instance != "trainer":
        fail(f"K5 runs ADAM_RUN's case through its {instance} instance")
    err = check(x, g, m, v, [None, None], cfg, m_spec, m_spec, True,
                f"n={n_full} (ADAM_RUN's operands)", scal=scal3)
    torch.cuda.empty_cache()
    print(f"  n={n_full} bf16-sr codes of non-zero moments: x, m and v "
          "bitwise equal to the twin", flush=True)
    k5_ms = time_ms(torch, lambda i: tfu.fused_qadam_prng(
        x, g, m, v, scal3, UPDATE_SEED, cfg, **kw), 1, iters=10)
    plain_ms = time_ms(torch, lambda i: tfu.fused_qadam_prng_plain(
        x, g, m, v, scal3, UPDATE_SEED, cfg, **kw), 1, iters=1, warmup=1)
    del m, v
    torch.cuda.empty_cache()
    p = torch.nn.Parameter(x)
    p.grad = g
    adam = torch.optim.Adam([p], lr=UPDATE_T, fused=True)
    lib_ms = time_ms(torch, lambda i: adam.step(), 1, iters=10)
    del adam, p, x, g
    gc.collect()
    torch.cuda.empty_cache()
    bms, by, nbytes, tf = adam_bound(cfg, n_full, m_spec, m_spec, True,
                                     False)
    full = dict(n=n_full, case=list(ADAM_CASES[0]),
                config="signed_sr_eps-binary8 (trainer)", bitwise=True,
                max_abs_err=err, ms=k5_ms, instance=instance,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, bytes=nbytes, threefry_per_elt=tf)
    print(f"  n={n_full} bf16-sr codes: K5 {k5_ms:.3f} ms (bound "
          f"{bms:.3f} ms, {by}; {nbytes} bytes, {tf} Threefry per element; "
          f"plain {plain_ms:.1f} ms)  torch.optim.Adam(fused=True) "
          f"{lib_ms:.3f} ms (float32 moments, unrounded)", flush=True)
    return rows, full


def adam_train_phase(torch, mods, train):
    """Phase 19: ``train.ADAM_RUN`` at full size for 4 steps through the
    TrainLoop, launch counts, the packed checkpoint's bytes and seconds;
    then 2 steps and the remaining 2 resumed in one directory, bitwise
    equal to the uninterrupted run."""
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train.ADAM_RUN
    if (run["arch"], run["batch"], run["seq"]) != ("tinyllama-1.1b",
                                                   TRAIN_BATCH, TRAIN_SEQ):
        fail(f"train.ADAM_RUN {run} is not the run whose shapes phase 5 "
             "checks")
    reset_all(*mods)
    with ckpt_dir("adam") as ckpt:
        out = train.run(steps=TRAIN_STEPS, device="cuda", ckpt_dir=ckpt,
                        **run)
        launches = all_launches(*mods)
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = dir_bytes(Path(ckpt) / f"step_{TRAIN_STEPS}")
        meta = json.loads((Path(ckpt) / f"step_{TRAIN_STEPS}" / "meta.json")
                          .read_text())
    want = {"qmatmul_sr": TRAIN_STEPS * TRAIN_QMATMUL_PER_STEP,
            "qmatmul_swiglu_sr": TRAIN_STEPS * LAYERS,
            "qmatmul_batched_sr": 0, "sr_cast_prng": 0,
            "fused_qupdate_prng": 0, "fused_qupdate_bits": 0,
            "momentum_fma": 0, "fused_qadam_prng": TRAIN_STEPS,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_decode": 0}
    want = every_kernel(want, launches)
    if launches != want:
        fail(f"ADAM_RUN launch counts {launches} != expected {want}")
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v)
                                             for v in losses):
        fail(f"ADAM_RUN losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"ADAM_RUN's loss did not fall over {TRAIN_STEPS} steps: "
             f"{losses}")
    # each step reads another batch, so step 1's batch again, through the
    # trained parameters and step 1's GEMM keys, is where the loss must fall
    tr = train.setup(device="cuda", params=out["params"], **run)
    _, metrics = tr.train_step.grads_and_metrics(
        tr.params, tr.opt_state.key, 0, tr.batch(0))
    loss_again = float(metrics["loss"])
    del tr, metrics
    if not loss_again < losses[0]:
        fail(f"ADAM_RUN's loss on step 1's batch after {TRAIN_STEPS} steps "
             f"is {loss_again}, not below its {losses[0]} before them")
    if out["n_params"] != tinyllama_params():
        fail(f"ADAM_RUN has {out['n_params']} parameters")
    n = out["n_params"]
    # params as uint8 binary8 codes, m and v as uint16 bf16 codes
    want_bytes = n * (1 + 2 + 2)
    if not want_bytes <= ckpt_bytes <= 1.001 * want_bytes:
        fail(f"ADAM_RUN checkpoint holds {ckpt_bytes} bytes, not about "
             f"{want_bytes} (leaves packed: "
             f"{[leaf['packed'] for leaf in meta['leaves']]})")
    step_ms = [h["ms"] for h in out["history"]]
    steady_ms = sum(step_ms[1:]) / len(step_ms[1:])
    final = (out["params"], out["opt_state"])
    save_s = out["save_s"]
    del out
    with ckpt_dir("adam_resume") as ckpt:
        half = train.run(steps=RESUME_AT, device="cuda", ckpt_dir=ckpt,
                         verbose=False, **run)
        del half
        rest = train.run(steps=TRAIN_STEPS, device="cuda", ckpt_dir=ckpt,
                         verbose=False, **run)
    if [h["step"] for h in rest["history"]] != list(
            range(RESUME_AT + 1, TRAIN_STEPS + 1)):
        fail(f"the resumed run took steps {rest['history']}")
    from repro_torch.kernels.tree_update import tree_leaves
    n_diff = differing(torch, tree_leaves(final[0]),
                       tree_leaves(rest["params"]))[0]
    m_diff = sum(differing(torch, [getattr(final[1], k)],
                           [getattr(rest["opt_state"], k)])[0]
                 for k in ("m", "v"))
    if n_diff or m_diff:
        fail(f"resumed run differs from the uninterrupted one: {n_diff} "
             f"parameters, {m_diff} moment codes")
    res = dict(losses=losses, step_ms=step_ms, steady_ms=steady_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (steady_ms / 1e3),
               peak_bytes=peak, launches=launches, n_params=n,
               ckpt_bytes=ckpt_bytes, ckpt_bytes_raw_float32=8 * n,
               step1_batch_loss_after=loss_again,
               save_s=save_s, resume_s=rest["resume_s"],
               resumed_at=RESUME_AT, resumed_losses=[
                   h["loss"] for h in rest["history"]])
    del final, rest
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    print(f"  params {n}, losses {losses} (step 1's batch after them "
          f"{loss_again}), ms/step {step_ms}, steady "
          f"{steady_ms:.1f} ms/step, {res['tokens_per_s']:.1f} tok/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB, launches {launches}; "
          f"checkpoint {ckpt_bytes} bytes (raw float32 {8 * n}), final "
          f"save {res['save_s']:.1f} s, restore {res['resume_s']:.1f} s; "
          f"resumed at step {RESUME_AT}: parameters and m/v codes bitwise "
          f"equal; phase {res['phase_s']:.1f} s", flush=True)
    return res


def moment_path_phase(torch, train):
    """Phase 20 at ``ADAM_RUN``'s learning rate: reduced tinyllama, 2
    ``fused_bits`` steps on the CPU and on the card from the same
    parameters.  The card's per-leaf moment step on the CPU's state and
    gradients must equal the CPU's bitwise, so every moment in which the
    two runs differ follows from a gradient element that differs (a GEMM
    or float32 sum on the other side of a rounding decision); the counts
    of both are reported."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.tree_update import tree_leaves
    from repro_torch.models import build_model
    cfg = reduced(get_config("tinyllama-1.1b"))
    master = build_model(cfg).init_master(torch.Generator().manual_seed(3))
    kw = {k: train.ADAM_RUN[k] for k in ("optimizer", "moments_spec", "lr",
                                         "gemm_policy", "rounding_kind",
                                         "fmt", "eps")}
    trs = {dev: train.setup("tinyllama-1.1b", reduced=True, batch=2, seq=16,
                            update_path="fused_bits", device=dev,
                            params=_to(master, dev), **kw)
           for dev in ("cpu", "cuda")}

    def on_card(state):
        return state._replace(m=_to(state.m, "cuda"), v=_to(state.v, "cuda"))

    rows = []
    for i in range(2):
        seen = {}
        for dev, tr in trs.items():
            ts = tr.train_step
            grads, _ = ts.grads_and_metrics(tr.params, tr.opt_state.key,
                                            tr.opt_state.step, tr.batch(i))
            seen[dev] = (tr.opt_state, grads)
            tr.params, tr.opt_state = ts.optimizer.apply(tr.params, grads,
                                                         tr.opt_state)
        opt = trs["cpu"].train_step.optimizer
        state, grads = seen["cpu"]
        ref = opt.moment_trees(state, grads)[:2]
        card = opt.moment_trees(on_card(state), _to(grads, "cuda"))[:2]
        path = sum(differing(torch, tree_leaves(a), tree_leaves(b))[0]
                   for a, b in zip(ref, card))
        if path:
            fail(f"QAdam's per-leaf moment step, step {i + 1}: {path} "
                 "values differ card vs cpu on identical inputs")
        row = dict(step=i + 1, grads_differing=differing(
            torch, tree_leaves(seen["cpu"][1]),
            tree_leaves(seen["cuda"][1]))[0])
        for name in ("m", "v"):
            row[f"{name}_differing"] = differing(
                torch, tree_leaves(getattr(trs["cpu"].opt_state, name)),
                tree_leaves(getattr(trs["cuda"].opt_state, name)))[0]
        rows.append(row)
    print(f"  fused_bits at lr {kw['lr']}: the moment step bitwise equal "
          f"card vs cpu on identical inputs; the runs differ in {rows}",
          flush=True)
    return rows


def adam_drill_phase(torch, train):
    """Phase 20's fault drill on the card: reduced tinyllama under
    ``ADAM_RUN``'s settings, preemptions around a garbled checkpoint, held
    bitwise to a clean run."""
    from repro_torch.kernels.tree_update import tree_leaves
    kw = dict(train.ADAM_RUN, reduced=True, batch=2, seq=16, device="cuda",
              verbose=False, steps=DRILL["steps"])
    del kw["arch"]
    with ckpt_dir("drill") as ckpt:
        drill = train.run("tinyllama-1.1b", ckpt_dir=ckpt,
                          checkpoint_every=DRILL["checkpoint_every"],
                          fault_schedule=DRILL["fault_schedule"], **kw)
    with ckpt_dir("clean") as ckpt:
        clean = train.run("tinyllama-1.1b", ckpt_dir=ckpt, **kw)
    log = drill["fault_log"]
    corrupt = [e for e in log if e["kind"] == "corrupt"]
    if drill["restarts"] != 2 or [e["kind"] for e in log] != [
            "preempt", "corrupt", "preempt"] or corrupt[0]["ckpt_step"] != 4:
        fail(f"fault drill: restarts {drill['restarts']}, log {log}")
    n_diff = differing(torch, tree_leaves(clean["params"]),
                       tree_leaves(drill["params"]))[0]
    m_diff = sum(differing(torch, [getattr(clean["opt_state"], k)],
                           [getattr(drill["opt_state"], k)])[0]
                 for k in ("m", "v"))
    if n_diff or m_diff:
        fail(f"fault drill differs from the clean run: {n_diff} "
             f"parameters, {m_diff} moment codes")
    print(f"  fault drill {DRILL['fault_schedule']} over {DRILL['steps']} "
          f"steps: restarts {drill['restarts']}, log {log}; parameters "
          "and m/v codes bitwise equal to the clean run", flush=True)
    return dict(restarts=drill["restarts"], fault_log=log,
                losses=[h["loss"] for h in drill["history"]])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def moe_params() -> int:
    """Parameters of qwen3-moe-30b-a3b: embedding, lm head, final norm and
    per layer two norms, q/k/v/o, the router and three expert stacks."""
    d, q, kv, E, F = (MOE[k] for k in ("d", "q", "kv", "n_experts",
                                       "d_expert"))
    per_layer = 2 * d + d * q + 2 * d * kv + q * d + d * E + 3 * E * d * F
    return 2 * MOE["vocab"] * d + d + MOE_LAYERS * per_layer


def sr_cast_bound(n: int, rand_bits: int):
    """(ms, bound_by) of one K1' call over n elements: 8 bytes each
    against one Threefry (>= 60 int32 operations) per two 32-bit words of
    random fields on the 128-lane layout."""
    rows = -(-n // 128)
    n_threefry = rows * 64 * rand_bits // 32
    t_bytes = 8 * n / PEAK_BYTES_PER_S
    t_ops = n_threefry * THREEFRY_OPS / PEAK_INT32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sr_cast_phase(torch, tsr):
    """K1' against its plain twin (bitwise) and timed; returns rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    words = (0x6A09E667, 0xBB67AE85)
    rows = []
    for shape in SR_CAST_SIZES:
        n = math.prod(shape)
        n_copies = max(1, math.ceil(2 * L2_BYTES / (8 * n)))
        xs = [torch.randn(shape, generator=gen, device=dev) * 4
              for _ in range(n_copies)]
        max_err = 0.0
        for fmt, mode, rb in (("binary8", "sr", 32), ("binary8", "sr", 16),
                              ("binary8", "sr", 8), ("binary8", "rn", 32)):
            got = tsr.sr_cast_prng(xs[0], words, fmt, mode, rand_bits=rb)
            ref = tsr.sr_cast_prng_plain(xs[0], words, fmt, mode, rb)
            torch.cuda.synchronize()
            if tuple(got.shape) != shape or not bitwise(torch, got, ref):
                fail(f"sr_cast_prng {shape} {fmt}-{mode}-r{rb}: not bitwise "
                     "equal to the plain twin")
            max_err = max(max_err, float((got - ref).abs().max()))
        # the path's spec runs the sr_r32 instance: bitwise the generic one
        path = tsr.sr_cast_prng(xs[0], words, "binary8")
        generic = tsr.sr_cast_prng(xs[0], words, "binary8",
                                   instance="generic")
        torch.cuda.synchronize()
        if tsr.sr_cast_instance("sr", 32, False) != "sr_r32" \
                or not bitwise(torch, path, generic):
            fail(f"sr_cast_prng {shape}: the sr_r32 instance differs from "
                 "the generic one")
        # timed under the path's spec (binary8 sr, 32-bit draws)
        ms = time_ms(torch, lambda i: tsr.sr_cast_prng(xs[i], words,
                                                       "binary8"), n_copies)
        plain = time_ms(torch, lambda i: tsr.sr_cast_prng_plain(
            xs[i], words, "binary8"), n_copies, iters=3, warmup=1)
        lib = time_ms(torch, lambda i: xs[i].to(torch.bfloat16), n_copies)
        bms, by = sr_cast_bound(n, 32)
        per_step = MOE_LAYERS if shape == SR_CAST_PATH else 0
        dev_ms = lib_dev_ms = None
        if per_step:    # device time at the path's shape: graph replay
            dev_ms = graph_ms(torch, lambda i: tsr.sr_cast_prng(
                xs[i], words, "binary8"), n_copies)
            lib_dev_ms = graph_ms(torch, lambda i: xs[i].to(torch.bfloat16),
                                  n_copies)
        rows.append(dict(kernel="sr_cast_prng", shape=list(shape), n=n,
                         per_step=per_step, max_abs_err=max_err,
                         mismatch_share=0.0, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by,
                         device_ms=dev_ms, library_device_ms=lib_dev_ms))
        print(f"  sr_cast_prng n={n:9d} {str(shape):16s} kernel {ms:8.4f} "
              f"ms  bound {bms:8.5f} ms ({by})  plain {plain:8.3f} ms  "
              f"bf16 cast {lib:8.4f} ms  bitwise"
              + (f"; device (graph replay) kernel {dev_ms:.5f} ms, bf16 "
                 f"cast {lib_dev_ms:.5f} ms" if per_step else ""),
              flush=True)
        del xs
    return rows


def batched_bound(E, M, K, N, b_bytes, bits=False):
    """(ms, bound_by) of one K8' call (with ``bits``, K8's: the (E, M, N)
    bits operand read too): each input read once, the output written once,
    against the fp32 flops at the fp32 peak."""
    nbytes = E * M * K * 4 + E * K * N * b_bytes + E * M * N * 4 \
        * (2 if bits else 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * E * M * N * K / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def batched_phase(torch, tq):
    """K8' against its plain twin at the MoE path's shapes and a ragged
    one; returns rows."""
    import numpy as np
    from repro_torch.core.rounding import grid_flips
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = []

    def ints(shape, div):
        return (torch.randint(-8, 9, shape, generator=gen, device=dev)
                .float() / div)

    for E, M, K, N, per_step, per_prompt in batched_cases():
        seeds = np.random.default_rng(E * K + N).integers(
            0, 2 ** 32, (E, 2), dtype=np.int64)
        a = ints((E, M, K), 8.0)
        b = ints((E, K, N), 4.0)
        variants = [("binary8", "sr", 32), ("binary8", "sr", 16),
                    ("binary8", "sr", 8), ("binary8", "rn", 32)]
        if (E, M, K, N) == BATCHED_RAGGED:
            variants.append(("e4m3", "sr", 16))
        for b_dtype in (torch.bfloat16, torch.float32):
            bt = b.to(b_dtype)
            for fmt, mode, rb in variants:
                got = tq.qmatmul_batched_prng(a, bt, seeds, fmt, mode, rb)
                ref = tq.qmatmul_batched_plain(a, bt, seeds, fmt, mode, rb)
                torch.cuda.synchronize()
                if not bitwise(torch, got, ref):
                    fail(f"qmatmul_batched_sr {E}x{M}x{K}x{N} {b_dtype} "
                         f"{fmt}-{mode}-r{rb}: not bitwise equal to the "
                         "plain twin on exact-sum inputs")
            del bt
        del a, b
        # N(0, 1) inputs, bf16 experts as the path stores them
        n_copies = max(1, math.ceil(2 * L2_BYTES / (E * K * N * 2)))
        a = torch.randn((E, M, K), generator=gen, device=dev)
        ws = [(torch.randn((E, K, N), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        got = tq.qmatmul_batched_prng(a, ws[0], seeds, "binary8")
        ref = tq.qmatmul_batched_plain(a, ws[0], seeds, "binary8")
        torch.cuda.synchronize()
        n_bad, adjacent = grid_flips(ref, got, "binary8")
        share = n_bad / ref.numel()
        if share > 1e-4 or not adjacent:
            fail(f"qmatmul_batched_sr {E}x{M}x{K}x{N}: {n_bad} mismatches "
                 f"({share:.2e}), adjacent on the grid: {adjacent}")
        batched_routes_agree(
            torch, tq, lambda: tq.qmatmul_batched_prng(a, ws[0], seeds,
                                                       "binary8"),
            f"qmatmul_batched_sr {E}x{M}x{K}x{N}")
        max_err = float((got - ref).abs().max())
        steps = max_steps(torch, ref, got, "binary8")

        def call(i):
            return tq.qmatmul_batched_prng(a, ws[i], seeds, "binary8")
        a16 = a.to(torch.bfloat16)

        def lib_call(i):
            return torch.bmm(a16, ws[i])
        ms = time_ms(torch, call, n_copies)
        plain = time_ms(torch, lambda i: tq.qmatmul_batched_plain(
            a, ws[i], seeds, "binary8"), n_copies, iters=3, warmup=1)
        lib = time_ms(torch, lib_call, n_copies)
        bms, by = batched_bound(E, M, K, N, 2)
        row = dict(kernel="qmatmul_batched_sr", E=E, M=M, K=K, N=N,
                   b="bf16", per_step=per_step, per_prompt=per_prompt,
                   route=tq.batched_route(M), mismatches=n_bad,
                   mismatch_share=share, max_grid_steps=steps,
                   max_abs_err=max_err, ms=ms, plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by)
        dev_note = ""
        if per_step or per_prompt:
            row.update(device_ms=graph_ms(torch, call, n_copies),
                       library_device_ms=graph_ms(torch, lib_call, n_copies))
            dev_note = (f"; device (graph replay) kernel "
                        f"{row['device_ms']:.5f} ms, bmm(bf16) "
                        f"{row['library_device_ms']:.5f} ms")
        rows.append(row)
        print(f"  qmatmul_batched_sr E={E:3d} M={M:2d} K={K:5d} N={N:5d} "
              f"B=bf16 ({row['route']})  kernel {ms:8.4f} ms  bound "
              f"{bms:8.4f} ms ({by})  plain {plain:8.3f} ms  bmm(bf16) "
              f"{lib:8.4f} ms  flips {n_bad}/{ref.numel()} (max {steps:g} "
              f"steps), routes bitwise{dev_note}", flush=True)
        del a, a16, ws, got, ref
    return rows


def moe_agreement_phase(torch, serve, policy="binary8-paper"):
    """Reduced qwen3-moe-30b-a3b on the card against the same weights on
    the CPU (plain twins), teacher-forced on the CPU's picks: the logits
    within the serve tolerance and the card's own picks within 0.1 of the
    CPU's best logit (bf16 logits tie often)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced(get_config(MOE_ARCH)),
                              gemm_policy=policy)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(9))
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(10))
    cpu = serve.serve_batch(model, params, prompts, 4)
    card = serve.serve_batch(model, _to(params, "cuda"), prompts.cuda(), 4,
                             forced=cpu["tokens"].cuda())
    lc = cpu["logits"]
    d = (card["logits"].cpu() - lc).abs()
    med, share = float(d.median()), float((d > 0.05).float().mean())
    chosen = torch.gather(lc, -1, card["tokens"].cpu()[..., None])[..., 0]
    gap = float((lc.max(-1).values - chosen).max())
    print(f"  reduced {MOE_ARCH} {policy_name(policy)} card vs cpu: median "
          f"|dlogit| {med:.4g}, share > 0.05 {share:.4g}, picks equal "
          f"{int((card['tokens'].cpu() == cpu['tokens']).sum())}/"
          f"{cpu['tokens'].numel()}, largest gap of a card pick to the "
          f"best cpu logit {gap:.4g}", flush=True)
    if not (med < 0.02 and share <= 0.10 and gap <= 0.1):
        fail("MoE card and CPU paths disagree beyond the stated tolerance")
    return dict(median_abs_dlogit=med, share_over_0_05=share,
                max_pick_gap=gap)


def moe_serve_phase(torch, mods, serve, policy="binary8-paper"):
    """The full-size qwen3-moe-30b-a3b serve run under ``policy``; every
    launch count checked against the prediction from the code (the
    explicit-bits kernels under an oracle policy)."""
    from repro_torch.precision.policy import resolve_policy
    gc.collect()          # the dense phases' models and caches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = serve.MOE_SERVE_RUN
    if (run["arch"], run["batch"], run["prompt_len"], run["gen"]) != (
            MOE_ARCH, BATCH, PROMPT, GEN):
        fail(f"serve.MOE_SERVE_RUN {run} is not the run whose shapes phase "
             "15 checks")
    reset_all(*mods)
    oracle = resolve_policy(policy).oracle
    with bits_clock() as bits_s:
        out = serve.run(**run, gemm_policy=policy, device="cuda")
    launches = all_launches(*mods)
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT + GEN
    # per layer and step: q, k, v, o and the router through K3' (K3), gate,
    # up and down through K8' (K8), the hidden through K1' (K1); the lm
    # head per generated token
    q, bmm, cast = ("qmatmul_bits", "qmatmul_batched_bits", "sr_cast_bits") \
        if oracle else ("qmatmul_sr", "qmatmul_batched_sr", "sr_cast_prng")
    want = {q: 5 * MOE_LAYERS * steps + GEN,
            bmm: 3 * MOE_LAYERS * steps, cast: MOE_LAYERS * steps}
    want = every_kernel(want, launches)
    if launches != want:
        fail(f"MoE serve launch counts {launches} != expected {want}")
    if out["n_params"] != moe_params():
        fail(f"MoE serve run has {out['n_params']} parameters, not "
             f"{moe_params()}")
    toks, logits = out["tokens"], out["logits"]
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= MOE["vocab"]:
        fail(f"bad tokens {toks.tolist()}")
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    wall = out["t_prefill"] + out["t_decode"]
    print(f"  params {out['n_params']}, prefill {out['prefill_tokps']:.2f} "
          f"tok/s, decode {out['decode_tokps']:.2f} tok/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, kv cache {out['cache_dtype']} "
          f"{out['cache_bytes']} bytes, launches "
          f"{ {k: v for k, v in launches.items() if v} }, sample "
          f"{toks[0].tolist()}"
          + (f", bits issued in {bits_s[0]:.3f} s of {wall:.3f} s on the "
             "host" if oracle else ""), flush=True)
    res = dict(prefill_tokps=out["prefill_tokps"],
               decode_tokps=out["decode_tokps"], t_prefill=out["t_prefill"],
               t_decode=out["t_decode"], peak_bytes=peak,
               n_params=out["n_params"],
               cache_dtype=str(out["cache_dtype"]),
               cache_bytes=out["cache_bytes"], launches=launches,
               bits_host_s=bits_s[0], bits_host_share=bits_s[0] / wall)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phases 21-25: the explicit-bits kernels K3, K4, K8, K1, the oracle and
# packed serve paths
# ---------------------------------------------------------------------------
def _bits2d(torch, tc, words, shape, rb, stream=0):
    return tc.counter_bits_reduced(words[0], words[1], shape, rb,
                                   stream=stream, device="cuda")


def _unaligned(torch, t):
    """A copy of ``t`` in a buffer that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        fail("the unaligned view is 16-byte aligned")
    return view


def int32_words(bits):
    """uint32 words (int64) as the int32 bit patterns a kernel reads."""
    from repro_torch.core.prng import int32_words as to_int32
    return to_int32(bits)


def bits_gemm_phase(torch, tq, tc):
    """K3 and K4 against their plain twins and against K3'/K4' fed the
    same words, at the oracle path's shapes (M = 4) and a ragged one;
    packed operands and outputs; timed.  Returns rows."""
    from repro_torch.core.rounding import grid_flips, spec
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2024)
    words = (0x3C6EF372, 0xA54FF53A)
    seeds = ((0x510E527F, 0x9B05688C), (0x1F83D9AB, 0x5BE0CD19),
             (0xCBBB9D5D, 0x629A292A))
    rows = []

    def ints(shape, div):
        return (torch.randint(-8, 9, shape, generator=gen, device=dev)
                .float() / div)

    cases = [("qmatmul_bits", 4, K, N, c) for (K, N, c) in QMATMUL_SHAPES]
    cases += [("qmatmul_swiglu_bits", 4, K, N, c)
              for (K, N, c) in SWIGLU_SHAPES]
    cases += [(k, *RAGGED, 0) for k in ("qmatmul_bits",
                                        "qmatmul_swiglu_bits")]
    act8 = spec("binary8", "sr")
    for name, M, K, N, per_step in cases:
        glu = name == "qmatmul_swiglu_bits"
        nw = 2 if glu else 1
        ragged = (M, K, N) == RAGGED

        def k_bits(a, ws, fmt, mode, rb, act=None, **kw):
            bg = _bits2d(torch, tc, seeds[0] if glu else words, (M, N), rb)
            if not glu:
                return tq.qmatmul(a, ws[0], bg, fmt, mode, rb, **kw)
            bu = _bits2d(torch, tc, seeds[1], (M, N), rb)
            ab = _bits2d(torch, tc, seeds[2], (M, N), 32, stream=1) \
                if act is not None and act.stochastic else None
            return tq.qmatmul_swiglu(a, ws[0], ws[1], bg, bu, fmt, mode,
                                     act_spec=act, act_bits=ab,
                                     rand_bits=rb, residuals=True, **kw)

        def k_prng(a, ws, fmt, mode, rb, act=None, **kw):
            if not glu:
                return tq.qmatmul_prng(a, ws[0], words, fmt, mode, rb, **kw)
            return tq.qmatmul_swiglu_prng(a, ws[0], ws[1], seeds, fmt, mode,
                                          act_spec=act, rand_bits=rb,
                                          residuals=True, **kw)

        def k_plain(a, ws, fmt, mode, rb, act=None):
            bg = _bits2d(torch, tc, seeds[0] if glu else words, (M, N), rb)
            if not glu:
                return tq.qmatmul_bits_plain(a, ws[0], bg, fmt, mode, rb)
            bu = _bits2d(torch, tc, seeds[1], (M, N), rb)
            ab = _bits2d(torch, tc, seeds[2], (M, N), 32, stream=1) \
                if act is not None and act.stochastic else None
            return tq.qmatmul_swiglu_bits_plain(a, ws[0], ws[1], bg, bu, fmt,
                                                mode, rb, act, ab, True)

        def outs(o):
            return list(o) if isinstance(o, tuple) else [o]

        # (a) exact sums: K3 == twin == K3' bitwise; K4 == K4' bitwise,
        # its residuals == twin's, its hidden within the act-grid flips
        a = ints((M, K), 8.0)
        ws = [ints((K, N), 4.0).to(torch.bfloat16) for _ in range(nw)]
        variants = [("e4m3", "sr", 32, None), ("binary8", "sr", 32, act8),
                    ("binary8", "rn", 32, None)]
        if ragged:
            variants += [("binary8", "sr", 16, act8),
                         ("binary8", "sr", 8, None),
                         ("bfloat16", "sr", 32, None)]
        for fmt, mode, rb, act in variants:
            act = act if glu else None
            got = outs(k_bits(a, ws, fmt, mode, rb, act))
            prng = outs(k_prng(a, ws, fmt, mode, rb, act))
            ref = outs(k_plain(a, ws, fmt, mode, rb, act))
            torch.cuda.synchronize()
            if not all(bitwise(torch, g, p) for g, p in zip(got, prng)):
                fail(f"{name} {M}x{K}x{N} {fmt}-{mode}-r{rb}: not bitwise "
                     "equal to the in-kernel-bits kernel on the same words")
            if glu:
                if not all(bitwise(torch, g, r)
                           for g, r in zip(got[1:], ref[1:])):
                    fail(f"{name} {M}x{K}x{N}: residuals not bitwise equal "
                         "to the twin on exact-sum inputs")
                # SiLU's expf may differ from the twin's exp by an ulp: an
                # unrounded hidden within float32 ulps, a rounded one
                # within the act grid's flips
                if act is None:
                    far = (got[0] - ref[0]).abs() > 1e-5 * ref[0].abs() \
                        + 1e-6
                    n_bad = int(far.sum())
                else:
                    n_bad, _ = grid_flips(ref[0], got[0], act.fmt)
                if n_bad > 1e-4 * ref[0].numel():
                    fail(f"{name} {M}x{K}x{N}: {n_bad} hidden mismatches")
            elif not bitwise(torch, got[0], ref[0]):
                fail(f"{name} {M}x{K}x{N} {fmt}-{mode}-r{rb}: not bitwise "
                     "equal to the plain twin on exact-sum inputs")
        # packed storage: codes of the float results; a packed A (a view
        # off a 16-byte boundary, -0.0 among its codes) sums as its values
        for fmt in ("e4m3", "binary8"):
            act = act8 if glu else None
            flt = outs(k_bits(a * 64, ws, fmt, "sr", 32, act))
            kw = dict(out_packed=True, residuals_packed=True) if glu \
                else dict(out_packed=True)
            codes = outs(k_bits(a * 64, ws, fmt, "sr", 32, act, **kw))
            codes_p = outs(k_prng(a * 64, ws, fmt, "sr", 32, act, **kw))
            grids = [act.fmt, fmt, fmt] if glu else [fmt]
            if not all(torch.equal(c, tc.pack_block(f, g)) and
                       torch.equal(c, p)
                       for c, f, p, g in zip(codes, flt, codes_p, grids)):
                fail(f"{name} {M}x{K}x{N} {fmt}: packed outputs are not the "
                     "codes of the float outputs")
        if not glu:
            vals = tc.round_block(torch.randn((M, K), generator=gen,
                                              device=dev), None, "binary8",
                                  "rn")
            vals[0, :3] = -0.0
            ac = _unaligned(torch, tc.pack_block(vals, "binary8"))
            for fn in (k_bits, k_prng):
                got = fn(ac, ws, "e4m3", "sr", 32, a_fmt="binary8")
                if not bitwise(torch, got, fn(vals, ws, "e4m3", "sr", 32)):
                    fail(f"{name} {M}x{K}x{N}: a_fmt codes do not sum as "
                         "their values")
        # (b) N(0, 1) inputs, the oracle path's spec (e4m3 sr, identity
        # act site): K3 == K3' bitwise; the twin within the GEMM contract
        a = torch.randn((M, K), generator=gen, device=dev)
        n_copies = 1 if ragged else max(
            2, math.ceil(2 * L2_BYTES / (nw * K * N * 2)))
        wsets = [[(torch.randn((K, N), generator=gen, device=dev)
                   / math.sqrt(K)).to(torch.bfloat16) for _ in range(nw)]
                 for _ in range(n_copies)]
        got = outs(k_bits(a, wsets[0], "e4m3", "sr", 32))
        prng = outs(k_prng(a, wsets[0], "e4m3", "sr", 32))
        ref = outs(k_plain(a, wsets[0], "e4m3", "sr", 32))
        torch.cuda.synchronize()
        if not all(bitwise(torch, g, p) for g, p in zip(got, prng)):
            fail(f"{name} {M}x{K}x{N}: K != K' bitwise on N(0, 1) inputs")
        if glu:
            for fn, what in ((k_bits, "K4"), (k_prng, "K4'")):
                glu_routes_agree(torch, tq, lambda: fn(
                    a, wsets[0], "e4m3", "sr", 32, act8),
                    f"{what} {M}x{K}x{N} N(0, 1)")
        n_bad, adjacent = grid_flips(ref[-1], got[-1], "e4m3")
        share = n_bad / ref[-1].numel()
        if share > 1e-4 or not adjacent:
            fail(f"{name} {M}x{K}x{N}: {n_bad} mismatches ({share:.2e})")
        max_err = float((got[0] - ref[0]).abs().max())
        # the words as the kernels read them (int32 bit patterns), so the
        # timings below hold no conversion
        bits = [int32_words(_bits2d(torch, tc, w, (M, N), 32))
                for w in (seeds[:2] if glu else [words])]

        def run_k(i):
            if glu:
                return tq.qmatmul_swiglu(a, *wsets[i], *bits, "e4m3")
            return tq.qmatmul(a, wsets[i][0], bits[0], "e4m3")

        def run_p(i):
            if glu:
                return tq.qmatmul_swiglu_prng(a, *wsets[i], seeds, "e4m3")
            return tq.qmatmul_prng(a, wsets[i][0], words, "e4m3")

        def run_plain(i):
            if glu:
                return tq.qmatmul_swiglu_bits_plain(a, *wsets[i], *bits,
                                                    "e4m3")
            return tq.qmatmul_bits_plain(a, wsets[i][0], bits[0], "e4m3")
        ms = time_ms(torch, run_k, n_copies)
        prng_ms = time_ms(torch, run_p, n_copies)
        plain = time_ms(torch, run_plain, n_copies, iters=3, warmup=1)
        w32 = [[w.float() for w in ws_] for ws_ in wsets]
        gemm = time_ms(torch, lambda i: [a @ w for w in w32[i]], n_copies)
        # the bits operands: 4 B per output element each
        bms, by = bound_ms(M, K, N, nw, 2, nw)
        row = dict(kernel=name, M=M, K=K, N=N, b="bf16",
                   per_step=per_step, mismatches=n_bad,
                   mismatch_share=share, max_abs_err=max_err, ms=ms,
                   prng_ms=prng_ms, plain_ms=plain, gemm_only_ms=gemm,
                   bound_ms=bms, bound_by=by)
        dev_note = ""
        if per_step:
            # K3 and K4 at decode: device time by graph replay (K3'/K4' and
            # the yardstick beside it), time_ms reads the wrapper's host cost
            row.update(device_ms=graph_ms(torch, run_k, n_copies),
                       prng_device_ms=graph_ms(torch, run_p, n_copies),
                       library_device_ms=graph_ms(
                           torch, lambda i: [a @ w for w in w32[i]],
                           n_copies))
            dev_note = (f"  device {row['device_ms']:8.4f} ms (in-kernel "
                        f"bits {row['prng_device_ms']:8.4f}, torch.matmul "
                        f"{row['library_device_ms']:8.4f})")
        rows.append(row)
        print(f"  {name:20s} M={M:3d} K={K:5d} N={N:6d}  kernel {ms:8.4f} "
              f"ms  in-kernel bits {prng_ms:8.4f} ms  bound {bms:8.4f} ms "
              f"({by})  plain {plain:8.3f} ms  gemm-only(fp32) "
              f"{gemm:8.4f} ms{dev_note}  flips {n_bad}/{ref[-1].numel()}, "
              "bitwise equal to the in-kernel-bits kernel", flush=True)
        del a, ws, wsets, w32, got, prng, ref, bits
    return rows


def bits_batched_phase(torch, tq, tc):
    """K8 against its twin and against K8' fed the same words, at the MoE
    path's shapes and a ragged one; packed storage; timed.  Returns
    rows."""
    import numpy as np
    from repro_torch.core.rounding import grid_flips
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    rows = []
    for E, M, K, N, per_step, per_prompt in batched_cases():
        seeds = np.random.default_rng(E * K + N + 1).integers(
            0, 2 ** 32, (E, 2), dtype=np.int64)
        a = (torch.randint(-8, 9, (E, M, K), generator=gen, device=dev)
             .float() / 8)
        b = (torch.randint(-8, 9, (E, K, N), generator=gen, device=dev)
             .float() / 4).to(torch.bfloat16)
        for fmt, mode, rb in (("binary8", "sr", 32), ("binary8", "sr", 16),
                              ("binary8", "sr", 8), ("binary8", "rn", 32),
                              ("e4m3", "sr", 16)):
            bits = tc.counter_bits_batch(seeds, (E, M, N), rb, device=dev)
            got = tq.qmatmul_batched(a, b, bits, fmt, mode, rb)
            ref = tq.qmatmul_batched_bits_plain(a, b, bits, fmt, mode, rb)
            prng = tq.qmatmul_batched_prng(a, b, seeds, fmt, mode, rb)
            torch.cuda.synchronize()
            if not (bitwise(torch, got, ref) and bitwise(torch, got, prng)):
                fail(f"qmatmul_batched_bits {E}x{M}x{K}x{N} {fmt}-{mode}-"
                     f"r{rb}: not bitwise equal to the twin and K8'")
        bits = tc.counter_bits_batch(seeds, (E, M, N), 32, device=dev)
        codes = tq.qmatmul_batched(a, b, bits, "binary8", out_packed=True)
        flt = tq.qmatmul_batched(a, b, bits, "binary8")
        ac = _unaligned(torch, tc.pack_block(a, "binary8"))
        if not (torch.equal(codes, tc.pack_block(flt, "binary8")) and
                bitwise(torch, tq.qmatmul_batched(ac, b, bits, "binary8",
                                                  a_fmt="binary8"), flt)):
            fail(f"qmatmul_batched_bits {E}x{M}x{K}x{N}: packed storage "
                 "differs from the float path")
        del a, b, codes, flt, ac
        n_copies = max(1, math.ceil(2 * L2_BYTES / (E * K * N * 2)))
        a = torch.randn((E, M, K), generator=gen, device=dev)
        ws = [(torch.randn((E, K, N), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        got = tq.qmatmul_batched(a, ws[0], bits, "binary8")
        prng = tq.qmatmul_batched_prng(a, ws[0], seeds, "binary8")
        ref = tq.qmatmul_batched_bits_plain(a, ws[0], bits, "binary8")
        torch.cuda.synchronize()
        if not bitwise(torch, got, prng):
            fail(f"qmatmul_batched_bits {E}x{M}x{K}x{N}: K8 != K8' bitwise "
                 "on N(0, 1) inputs")
        batched_routes_agree(
            torch, tq, lambda: tq.qmatmul_batched(a, ws[0], bits, "binary8"),
            f"qmatmul_batched_bits {E}x{M}x{K}x{N}")
        n_bad, adjacent = grid_flips(ref, got, "binary8")
        share = n_bad / ref.numel()
        if share > 1e-4 or not adjacent:
            fail(f"qmatmul_batched_bits {E}x{M}x{K}x{N}: {n_bad} mismatches")
        max_err = float((got - ref).abs().max())
        bits = int32_words(bits)

        def call(i):
            return tq.qmatmul_batched(a, ws[i], bits, "binary8")

        def prng_call(i):
            return tq.qmatmul_batched_prng(a, ws[i], seeds, "binary8")
        a16 = a.to(torch.bfloat16)

        def lib_call(i):
            return torch.bmm(a16, ws[i])
        ms = time_ms(torch, call, n_copies)
        prng_ms = time_ms(torch, prng_call, n_copies)
        plain = time_ms(torch, lambda i: tq.qmatmul_batched_bits_plain(
            a, ws[i], bits, "binary8"), n_copies, iters=3, warmup=1)
        lib = time_ms(torch, lib_call, n_copies)
        bms = batched_bound(E, M, K, N, 2, bits=True)
        row = dict(kernel="qmatmul_batched_bits", E=E, M=M, K=K, N=N,
                   b="bf16", per_step=per_step, per_prompt=per_prompt,
                   route=tq.batched_route(M), mismatches=n_bad,
                   mismatch_share=share, max_abs_err=max_err, ms=ms,
                   prng_ms=prng_ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bms[0], bound_by=bms[1])
        dev_note = ""
        if per_step or per_prompt:
            row.update(device_ms=graph_ms(torch, call, n_copies),
                       prng_device_ms=graph_ms(torch, prng_call, n_copies),
                       library_device_ms=graph_ms(torch, lib_call, n_copies))
            dev_note = (f"; device (graph replay) kernel "
                        f"{row['device_ms']:.5f} ms, in-kernel bits "
                        f"{row['prng_device_ms']:.5f} ms, bmm(bf16) "
                        f"{row['library_device_ms']:.5f} ms")
        rows.append(row)
        print(f"  qmatmul_batched_bits E={E:3d} M={M:2d} K={K:5d} N={N:5d} "
              f"({row['route']})  kernel {ms:8.4f} ms  in-kernel bits "
              f"{prng_ms:8.4f} ms  bound {bms[0]:8.4f} ms ({bms[1]})  plain "
              f"{plain:8.3f} ms  bmm(bf16) {lib:8.4f} ms  flips "
              f"{n_bad}/{ref.numel()}, routes bitwise{dev_note}",
              flush=True)
        del a, a16, ws, got, prng, ref
    return rows


def bits_cast_phase(torch, tsr, tc):
    """K1 (bits keyed by the flat index, as the oracle's qact draws them)
    and K1''s signed-SRe branch against their twins, bitwise, on ragged
    sizes, the path's (128, 1, 768) and a view off a 16-byte boundary;
    timed at the path's shape.  Returns rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    words = (0x6A09E667, 0xBB67AE85)
    rows = []
    for shape in [SR_CAST_PATH, (3, 7, 61), (2 ** 20 + 37,)]:
        n = math.prod(shape)
        x = torch.randn(shape, generator=gen, device=dev) * 4
        v = torch.randn(shape, generator=gen, device=dev)
        max_err = 0.0
        for fmt, mode, rb, eps in (("binary8", "sr", 32, 0.0),
                                   ("binary8", "sr", 16, 0.0),
                                   ("binary8", "sr", 8, 0.0),
                                   ("binary8", "rn", 32, 0.0),
                                   ("e4m3", "sr_eps", 32, 0.1),
                                   ("binary8", "signed_sr_eps", 32, 0.1)):
            vv = v if mode == "signed_sr_eps" else None
            bits = tc.counter_bits_reduced(*words, (n, 1), rb,
                                           device=dev).reshape(shape)
            got = tsr.sr_cast(x, bits, fmt, mode, eps, vv, rand_bits=rb)
            ref = tsr.sr_cast_plain(x, bits, fmt, mode, rb, eps, vv)
            gp = tsr.sr_cast_prng(x, words, fmt, mode, eps, vv, rand_bits=rb)
            rp = tsr.sr_cast_prng_plain(x, words, fmt, mode, rb, eps, vv)
            torch.cuda.synchronize()
            if not (bitwise(torch, got, ref) and bitwise(torch, gp, rp)):
                fail(f"sr_cast_bits / sr_cast_prng {shape} {fmt}-{mode}-"
                     f"r{rb}: not bitwise equal to the plain twins")
            max_err = max(max_err, float((got - ref).abs().max()))
        xu, vu = _unaligned(torch, x.reshape(-1)), _unaligned(
            torch, v.reshape(-1))
        bits = _unaligned(torch, tc.counter_bits_reduced(
            *words, (n, 1), 32, device=dev).reshape(-1).to(torch.int32))
        if not bitwise(torch, tsr.sr_cast(xu, bits, "binary8",
                                          "signed_sr_eps", 0.2, vu),
                       tsr.sr_cast_plain(xu, bits, "binary8",
                                         "signed_sr_eps", 32, 0.2, vu)):
            fail(f"sr_cast_bits {shape}: an unaligned view differs")
        # the path's instance (sr, 32-bit draws) and the generic one,
        # aligned and through the unaligned view: bitwise the twin
        for xx, bb in ((x, tc.counter_bits_reduced(*words, (n, 1), 32,
                                                   device=dev).reshape(shape)),
                       (xu, bits)):
            ref = tsr.sr_cast_plain(xx, bb, "binary8")
            for inst in ("sr_r32", "generic"):
                if not bitwise(torch, tsr.sr_cast(xx, bb, "binary8",
                                                  instance=inst), ref):
                    fail(f"sr_cast_bits {shape}: instance {inst} differs "
                         "from the twin")
        bits = int32_words(tc.counter_bits_reduced(
            *words, (n, 1), 32, device=dev).reshape(shape))
        n_copies = max(1, math.ceil(2 * L2_BYTES / (12 * n)))
        xs = [torch.randn(shape, generator=gen, device=dev) * 4
              for _ in range(n_copies)]
        if tsr.sr_cast_bits_instance("sr", 32, False) != "sr_r32":
            fail("sr_cast_bits: the path's spec does not take sr_r32")
        ms = time_ms(torch, lambda i: tsr.sr_cast(xs[i], bits, "binary8"),
                     n_copies)
        generic_ms = time_ms(torch, lambda i: tsr.sr_cast(
            xs[i], bits, "binary8", instance="generic"), n_copies)
        prng_ms = time_ms(torch, lambda i: tsr.sr_cast_prng(
            xs[i], words, "binary8"), n_copies)
        plain = time_ms(torch, lambda i: tsr.sr_cast_plain(
            xs[i], bits, "binary8"), n_copies, iters=3, warmup=1)
        lib = time_ms(torch, lambda i: xs[i].to(torch.bfloat16), n_copies)
        bms = 1e3 * 12 * n / PEAK_BYTES_PER_S
        per_step = MOE_LAYERS if shape == SR_CAST_PATH else 0
        dev_ms = lib_dev_ms = generic_dev_ms = None
        if per_step:    # device time at the path's shape: graph replay
            dev_ms = graph_ms(torch, lambda i: tsr.sr_cast(
                xs[i], bits, "binary8"), n_copies)
            generic_dev_ms = graph_ms(torch, lambda i: tsr.sr_cast(
                xs[i], bits, "binary8", instance="generic"), n_copies)
            lib_dev_ms = graph_ms(torch, lambda i: xs[i].to(torch.bfloat16),
                                  n_copies)
        rows.append(dict(kernel="sr_cast_bits", shape=list(shape), n=n,
                         per_step=per_step, max_abs_err=max_err,
                         mismatch_share=0.0, ms=ms, prng_ms=prng_ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bms,
                         bound_by="bytes", device_ms=dev_ms,
                         library_device_ms=lib_dev_ms, generic_ms=generic_ms,
                         generic_device_ms=generic_dev_ms))
        print(f"  sr_cast_bits n={n:8d} {str(shape):14s} kernel {ms:8.4f} "
              f"ms (generic instance {generic_ms:8.4f})  in-kernel bits "
              f"{prng_ms:8.4f} ms  bound {bms:8.5f} ms (bytes)  plain "
              f"{plain:8.3f} ms  bf16 cast {lib:8.4f} ms  bitwise"
              + (f"; device (graph replay) kernel {dev_ms:.5f} ms (generic "
                 f"{generic_dev_ms:.5f}), bf16 cast {lib_dev_ms:.5f} ms"
                 if per_step else ""),
              flush=True)
        del x, v, xs
    return rows


def oracle_serve_phase(torch, mods, serve):
    """Path 1: tinyllama-1.1b under e4m3-sr-oracle (K3, K4), and under
    e4m3-sr in the same phase: tokens and logits bitwise equal."""
    oracle, base = {}, {}
    res = serve_phase(torch, mods, serve, ORACLE_POLICY, keep=oracle)
    res_base = serve_phase(torch, mods, serve, "e4m3-sr", keep=base)
    same = torch.equal(oracle["tokens"], base["tokens"]) and bitwise(
        torch, oracle["logits"], base["logits"])
    print(f"  {ORACLE_POLICY} vs e4m3-sr: tokens and logits bitwise "
          f"{'equal' if same else 'DIFFERENT'}; decode "
          f"{res['decode_tokps']:.2f} vs {res_base['decode_tokps']:.2f} "
          "tok/s", flush=True)
    if not same:
        fail(f"{ORACLE_POLICY} serve differs from e4m3-sr")
    return dict(oracle=res, e4m3_sr=res_base, bitwise_equal=same)


def packed_serve_phase(torch, mods, serve, unpacked):
    """Path 2: tinyllama-1.1b under binary8-paper-packed (K4' emits the
    hidden as uint8 codes, the down GEMM decodes them on load): tokens and
    logits bitwise equal to phase 6's binary8-paper run."""
    from repro_torch.precision import fused, policy
    seen = {"h": [], "down": 0}
    glu, qmm = fused.qmatmul_swiglu_prng, policy.qmatmul_prng

    def glu_rec(*a, **k):
        out = glu(*a, **k)
        seen["h"].append((out.dtype, out.numel() * out.element_size()))
        return out

    def qmm_rec(a, *rest, **k):
        seen["down"] += k.get("a_fmt") is not None
        return qmm(a, *rest, **k)
    fused.qmatmul_swiglu_prng, policy.qmatmul_prng = glu_rec, qmm_rec
    try:
        got = {}
        res = serve_phase(torch, mods, serve, PACKED_POLICY, keep=got)
    finally:
        fused.qmatmul_swiglu_prng, policy.qmatmul_prng = glu, qmm
    steps = PROMPT + GEN
    h_bytes = {b for dt, b in seen["h"] if dt == torch.uint8}
    if len(seen["h"]) != LAYERS * steps or {dt for dt, _ in seen["h"]} != {
            torch.uint8} or seen["down"] != LAYERS * steps:
        fail(f"{PACKED_POLICY}: the hidden was not stored as uint8 codes "
             f"in every call ({len(seen['h'])} calls, down GEMMs decoding "
             f"{seen['down']})")
    same = torch.equal(got["tokens"], unpacked["tokens"]) and bitwise(
        torch, got["logits"], unpacked["logits"])
    print(f"  {PACKED_POLICY} vs phase 6 (binary8-paper): tokens and logits "
          f"bitwise {'equal' if same else 'DIFFERENT'}; hidden "
          f"{sorted(h_bytes)} bytes of uint8 codes per call "
          f"({BATCH} x {TINYLLAMA['ff']}; float32 would be "
          f"{4 * BATCH * TINYLLAMA['ff']})", flush=True)
    if not same:
        fail(f"{PACKED_POLICY} serve differs from binary8-paper")
    return dict(res, bitwise_equal=same, hidden_bytes_per_call=max(h_bytes),
                hidden_bytes_float32=4 * BATCH * TINYLLAMA["ff"])


def preset_train_phase(torch, mods, train):
    """Reduced tinyllama, 2 train steps under binary8-paper-packed and
    e4m3-sr-oracle: card against the CPU held to phase 9's limits, and the
    card's run bitwise equal to its run under the unpacked / in-kernel
    preset (packing and the oracle's bits change nothing)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.tree_update import tree_leaves
    from repro_torch.models import build_model
    cfg = reduced(get_config("tinyllama-1.1b"))
    master = build_model(cfg).init_master(torch.Generator().manual_seed(3))
    L, res = cfg.n_layers, {}
    for preset, base in ((PACKED_POLICY, "binary8-paper"),
                         (ORACLE_POLICY, "e4m3-sr")):
        outs = {}
        for name, pol, dev in ((preset, preset, "cpu"),
                               (preset, preset, "cuda"),
                               (base, base, "cuda")):
            kw = dict(reduced=True, steps=2, batch=2, seq=16,
                      gemm_policy=pol, rounding_kind="signed_sr_eps",
                      fmt="binary8", eps=0.1, update_path="fused",
                      verbose=False)
            reset_all(*mods)
            with ckpt_dir("preset") as ckpt:
                outs[(name, dev)] = train.run(
                    "tinyllama-1.1b", device=dev, params=_to(master, dev),
                    ckpt_dir=ckpt, **kw)
            torch.cuda.synchronize()
            if dev == "cuda" and name == preset:
                launches = all_launches(*mods)
        q, glu = ("qmatmul_bits", "qmatmul_swiglu_bits") \
            if preset == ORACLE_POLICY else ("qmatmul_sr",
                                             "qmatmul_swiglu_sr")
        want = every_kernel({q: 2 * (19 * L + 3), glu: 2 * L,
                             "fused_qupdate_prng": 2, "momentum_fma": 2},
                            launches)
        if launches != want:
            fail(f"{preset} train launches {launches} != {want}")
        cpu, card, card_base = (outs[(preset, "cpu")],
                                outs[(preset, "cuda")], outs[(base, "cuda")])
        lc = [h["loss"] for h in cpu["history"]]
        lg = [h["loss"] for h in card["history"]]
        lb = [h["loss"] for h in card_base["history"]]
        rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        n_diff, n = differing(torch, tree_leaves(cpu["params"]),
                              tree_leaves(card["params"]))
        n_base, _ = differing(torch, tree_leaves(card["params"]),
                              tree_leaves(card_base["params"]))
        print(f"  {preset}: losses cpu {lc} card {lg} (max rel diff "
              f"{rel:.3g}), parameters differing card vs cpu {n_diff}/{n}; "
              f"card vs card {base}: {n_base} parameters differ, losses "
              f"{'equal' if lg == lb else lb}", flush=True)
        if rel > AGREE_MAX_REL_LOSS or n_diff > AGREE_MAX_PARAMS:
            fail(f"{preset} train agreement beyond the stated tolerance")
        if n_base or lg != lb:
            fail(f"{preset} train run differs from {base} on the card")
        res[preset] = dict(losses_cpu=lc, losses_card=lg, max_rel_loss=rel,
                           params_differing=n_diff, params=n,
                           params_differing_vs_base=n_base,
                           launches=launches)
    return res


# ---------------------------------------------------------------------------
# Phases 26-28: K10 (paged decode) and the continuous-batching engine
# ---------------------------------------------------------------------------
def paged_case(torch, page, exact, seed, n_kv=4, G=8, d=64, n_max=4, B=8,
               lengths=None):
    """K10's inputs on the card: B requests of n_kv kv heads (lengths 1,
    page-1, page, page+1, the full table and random ones unless given),
    the logical k/v (B.KV, n_max.page, d) as e4m3 grid values, and a
    function that scatters a logical cache into a (P.KV, page, d) pool at
    a random placement (pages among 1..P-1, filler entries 0).  Exact:
    dyadic q, every key of a request equal (each row's logits equal, every
    exp exactly 1), dyadic v: every sum exact."""
    import numpy as np
    from repro_torch.core.rounding import parse_spec
    rng = np.random.default_rng(seed)
    S = n_max * page
    if lengths is None:
        lengths = [1, max(1, page - 1), page, page + 1, S] \
            + list(rng.integers(1, S + 1, B - 5))
    lengths = np.asarray(lengths, np.int32)
    if exact:
        q = rng.integers(-4, 5, (B * n_kv, G, d)) / 4
        k = np.repeat(rng.integers(-4, 5, (B * n_kv, 1, d)) / 4, S, axis=1)
        v = rng.integers(-8, 9, (B * n_kv, S, d)) / 8
    else:
        q = rng.standard_normal((B * n_kv, G, d))
        k = rng.standard_normal((B * n_kv, S, d))
        v = rng.standard_normal((B * n_kv, S, d))
    grid = parse_spec("e4m3-rn")
    dev = torch.device("cuda")
    q = torch.from_numpy(q.astype(np.float32)).to(dev)
    k, v = (grid(torch.from_numpy(x.astype(np.float32)).to(dev))
            for x in (k, v))
    P = B * n_max + 3

    def place(pl_seed):
        r = np.random.default_rng(pl_seed)
        free = list(r.permutation(np.arange(1, P)))
        tables = np.zeros((B, n_max), np.int32)
        for b, n in enumerate(lengths):
            for j in range(-(-int(n) // page)):
                tables[b, j] = free.pop()
        phys = []
        for b in range(B):
            for j in range(n_max):
                if tables[b, j]:
                    phys.append((b, j, int(tables[b, j])))
        return tables, phys

    def pool(x, placed):
        _, phys = placed
        out = torch.zeros((P, n_kv, page, d), dtype=x.dtype, device=dev)
        xv = x.view(B, n_kv, n_max, page, d)
        for b, j, p in phys:
            out[p] = xv[b, :, j]
        return out.view(P * n_kv, page, d)
    return q, k, v, lengths, place, pool


def paged_work(lengths, n_kv, G, d, code_bytes=1):
    """(flops, Threefry evaluations, bytes) of one K10 call over
    ``lengths``: the valid keys' logits and P.V products, each logit and
    each av/out element drawn once (two draws per Threefry), q and out
    float32, the valid cache rows' codes read once, tables and lengths."""
    keys = n_kv * int(sum(int(n) for n in lengths))
    rows = n_kv * len(lengths) * G
    pairs = G * keys
    nbytes = 4 * rows * d * 2 + 2 * keys * d * code_bytes \
        + 4 * len(lengths) * 5
    return 2 * pairs * 2 * d, (pairs + 2 * rows * d) / 2, nbytes


def paged_phase(torch, tfa):
    """K10 against its plain twin at B.KV = 32, G = 8, d = 64, n_max = 4,
    pages of 8, 16 and 64, 32-, 16- and 8-bit draws; then timed at the
    engine's decode shape.  Returns the rows."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core.rounding import grid_flips, parse_spec
    from repro_torch.kernels import common
    n_kv, G, d = 4, 8, 64
    rows = []
    for page in (8, 16, 64):
        for name in ("binary8-sr", "binary8-sr-r16", "binary8-sr-r8"):
            specs = [parse_spec(name)] * 3
            for exact in (True, False):
                q, k, v, lengths, place, pool = paged_case(
                    torch, page, exact, page + len(name))
                seeds = np.random.default_rng(page).integers(
                    0, 2 ** 32, (q.shape[0], 6), dtype=np.uint64)
                kw = dict(scale=d ** -0.5, n_kv=n_kv)
                outs = []
                for pl_seed in (0, 1):
                    placed = place(pl_seed)
                    tables = placed[0]
                    kp, vp = pool(k, placed), pool(v, placed)
                    codes = [common.pack_block(x, "e4m3") for x in (kp, vp)]
                    got = tfa.flash_decode_paged(q, *codes, seeds, lengths,
                                                 tables, specs,
                                                 kv_fmt="e4m3", **kw)
                    values = tfa.flash_decode_paged(q, kp, vp, seeds,
                                                    lengths, tables, specs,
                                                    **kw)
                    ref = tfa.flash_decode_paged_plain(
                        q, *codes, seeds, lengths, tables, specs,
                        kv_fmt="e4m3", **kw)
                    torch.cuda.synchronize()
                    tag = (f"page {page} {name} "
                           f"{'exact' if exact else 'N(0,1)'}")
                    if not bitwise(torch, got, values):
                        fail(f"flash_decode_paged {tag}: codes and values "
                             "differ")
                    n_bad, adjacent = grid_flips(ref, got, "binary8")
                    if exact and n_bad:
                        fail(f"flash_decode_paged {tag}: {n_bad} elements "
                             "differ from the plain twin on exact sums")
                    if n_bad > max(1e-4 * got.numel(), 1):
                        fail(f"flash_decode_paged {tag}: {n_bad} of "
                             f"{got.numel()} elements differ")
                    outs.append(got)
                if not bitwise(torch, outs[0], outs[1]):
                    fail(f"flash_decode_paged {tag}: two placements differ")
                for b, n in enumerate(lengths):
                    sl = slice(b * n_kv, (b + 1) * n_kv)
                    k9 = tfa.flash_decode(q[sl], k[sl], v[sl], seeds[sl],
                                          int(n), specs, scale=d ** -0.5,
                                          kv_block=page,
                                          kernel="flash_decode_tiled")
                    if not bitwise(torch, k9, outs[0][sl]):
                        fail(f"flash_decode_paged {tag}: request {b} "
                             f"(length {n}) differs from K9's tiled kernel "
                             "with kv_block = page")
                rows.append(dict(
                    case=tag, main=False, mismatches=n_bad,
                    mismatch_share=n_bad / got.numel(), adjacent=adjacent,
                    max_abs_err=float((got - ref).abs().max())))
        print(f"  page {page}: 32/16/8-bit draws, exact sums bitwise, "
              f"N(0,1) within the contract, codes == values, placement-"
              f"invariant, == K9's tiled kernel (kv_block = page)",
              flush=True)
    # timed at the engine's decode shape: 4 slots x 4 kv heads, pages of
    # 64, n_max 4, every slot at a long request's last length (48 + 32)
    eng = ENGINE
    lengths = [eng["long"][0] + eng["long"][1]] * eng["n_slots"]
    specs = [parse_spec("binary8-sr")] * 3
    q, k, v, lengths, place, pool = paged_case(
        torch, eng["page"], False, 99, B=eng["n_slots"], lengths=lengths)
    placed = place(5)
    codes = [common.pack_block(pool(x, placed), "e4m3") for x in (k, v)]
    seeds = np.random.default_rng(99).integers(0, 2 ** 32, (q.shape[0], 6),
                                               dtype=np.uint64)
    dev = torch.device("cuda")
    lens_d = torch.from_numpy(lengths).to(dev)
    tbl_d = torch.from_numpy(placed[0]).to(dev)
    # int32 bit patterns on the card, as the engine passes them
    seeds_d = torch.from_numpy(seeds.astype(np.uint32).view(np.int32)).to(dev)
    kw = dict(scale=d ** -0.5, n_kv=n_kv, kv_fmt="e4m3")
    got = tfa.flash_decode_paged(q, *codes, seeds_d, lens_d, tbl_d, specs,
                                 **kw)
    ref = tfa.flash_decode_paged_plain(q, *codes, seeds, lengths, placed[0],
                                       specs, **kw)
    torch.cuda.synchronize()
    n_bad, adjacent = grid_flips(ref, got, "binary8")
    ms = time_ms(torch, lambda i: tfa.flash_decode_paged(
        q, *codes, seeds_d, lens_d, tbl_d, specs, **kw), 1, iters=50)
    plain_ms = time_ms(torch, lambda i: tfa.flash_decode_paged_plain(
        q, *codes, seeds, lengths, placed[0], specs, **kw), 1, iters=3,
        warmup=1)
    S = int(max(lengths))
    B = len(lengths)
    q4 = q.view(B, n_kv * G, 1, d)
    k4, v4 = (x.view(B, n_kv, -1, d)[:, :, :S] for x in (k, v))
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, enable_gqa=True), 1, iters=50)
    dev_ms = graph_ms(torch, lambda i: tfa.flash_decode_paged(
        q, *codes, seeds_d, lens_d, tbl_d, specs, **kw), 1)
    lib_dev_ms = graph_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, k4, v4, enable_gqa=True), 1)
    flops, n_tf, nbytes = paged_work(lengths, n_kv, G, d)
    bms, by = attn_bound(flops, n_tf, nbytes)
    rows.append(dict(
        case=f"engine decode B={B} KV={n_kv} page {eng['page']} lengths "
             f"{S}", main=True, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib, device_ms=dev_ms,
        library_device_ms=lib_dev_ms,
        library="scaled_dot_product_attention over the gathered float32 "
                "cache, unrounded",
        mismatches=n_bad, mismatch_share=n_bad / got.numel(),
        adjacent=adjacent, max_abs_err=float((got - ref).abs().max())))
    print(f"  engine decode shape B={B} KV={n_kv} G={G} length {S}: kernel "
          f"{ms:.4f} ms  bound {bms:.5f} ms ({by})  plain {plain_ms:.3f} ms"
          f"  sdpa {lib:.4f} ms; device (graph replay) kernel {dev_ms:.5f} "
          f"ms, sdpa {lib_dev_ms:.5f} ms; mismatches vs plain {n_bad}",
          flush=True)
    return rows


def engine_phase(torch, mods, serve):
    """The engine at full width and depth under ENGINE_POLICY: every
    request drains, every page comes back, K10 launched once per layer per
    decode step (no one-token prefill chunk in this mix), nothing else
    launched; the streams equal under other slot counts, pools and
    arrivals; then one run under binary8-paper-attn with K3', K4' and K10
    counted against the engine's calls."""
    from repro_torch.precision.policy import get_policy
    gc.collect()
    torch.cuda.empty_cache()
    run = {k: v for k, v in serve.ENGINE_RUN.items() if k != "arch"}
    ec = run["engine"]
    if (serve.ENGINE_RUN["arch"], ec.n_slots, ec.page_size, run["long"],
            run["short"], run["n_short"], run["n_long"]) != (
            "tinyllama-1.1b", ENGINE["n_slots"], ENGINE["page"],
            ENGINE["long"], ENGINE["short"], 12, 4):
        fail(f"serve.ENGINE_RUN {serve.ENGINE_RUN} is not the run whose "
             "shapes phase 26 times")
    built = serve.build("tinyllama-1.1b", gemm_policy=serve.ENGINE_POLICY,
                        device="cuda")
    n_req = run["n_short"] + run["n_long"]
    want_len = {}
    schedules = [("ENGINE_RUN", ec, None),
                 ("2 slots, 5 pages, staggered arrivals",
                  dataclasses.replace(ec, n_slots=2, total_pages=5),
                  [i // 2 for i in range(n_req)]),
                 ("3 slots, 7 pages, late arrivals first",
                  dataclasses.replace(ec, n_slots=3, total_pages=7),
                  [(n_req - i) % 5 for i in range(n_req)])]
    res, streams = {}, None
    for label, cfg, arrivals in schedules:
        reset_all(*mods)
        kw = dict(run, engine=cfg)
        out = serve.run_engine(built=built, arrivals=arrivals,
                               device="cuda", verbose=False, **kw)
        launches = all_launches(*mods)
        eng = out["engine"]
        if not want_len:
            want_len = {r.rid: r.max_new_tokens for r in
                        serve.engine_workload(TINYLLAMA["vocab"],
                                              run["n_short"], run["n_long"],
                                              run["short"], run["long"],
                                              run["workload_seed"],
                                              run["long_every"])}
        got_len = {rid: len(t) for rid, t in out["tokens"].items()}
        if got_len != want_len:
            fail(f"engine ({label}): streams {got_len} != {want_len}")
        if eng.free_pages != cfg.total_pages - 1:
            fail(f"engine ({label}): {eng.free_pages} free pages of "
                 f"{cfg.total_pages - 1}")
        want = every_kernel({"flash_decode_paged": LAYERS * (
            eng.decode_steps + eng.single_token_chunks)}, launches)
        if eng.single_token_chunks or launches != want:
            fail(f"engine ({label}): launches {launches} != {want} "
                 f"({eng.decode_steps} decode steps, "
                 f"{eng.single_token_chunks} one-token chunks)")
        toks = out["tokens"]
        if any(t < 0 or t >= TINYLLAMA["vocab"] for s in toks.values()
               for t in s):
            fail(f"engine ({label}): bad tokens")
        if streams is None:
            streams = toks
        elif toks != streams:
            fail(f"engine ({label}): streams differ from ENGINE_RUN's")
        res[label] = dict(
            tokps=out["tokps"], ttft_p50_s=out["ttft_p50_s"],
            ttft_p99_s=out["ttft_p99_s"], wall_s=out["wall_s"],
            pool_bytes=out["pool_bytes"], peak_bytes=out["peak_bytes"],
            iterations=eng.iterations, decode_steps=eng.decode_steps,
            prefill_calls=eng.prefill_calls, launches=launches)
        print(f"  {label}: {eng.iterations} iterations, {eng.decode_steps} "
              f"decode steps, {out['tokps']:.1f} tok/s, ttft p50 "
              f"{out['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{out['ttft_p99_s'] * 1e3:.1f} ms, pool {out['pool_bytes']} "
              f"bytes, peak {out['peak_bytes'] / 2 ** 30:.2f} GiB, K10 "
              f"launches {launches['flash_decode_paged']}", flush=True)
        del out, eng
    del built
    gc.collect()
    torch.cuda.empty_cache()
    # rounded GEMMs too: the streams now depend on the schedule, the
    # launch arithmetic does not
    reset_all(*mods)
    out = serve.run_engine(gemm_policy=get_policy(ATTN_POLICY),
                           device="cuda", verbose=False, **run)
    launches = all_launches(*mods)
    eng = out["engine"]
    calls = eng.decode_steps + eng.prefill_calls
    logit_calls = eng.decode_steps + n_req
    want = every_kernel({
        "qmatmul_sr": 5 * LAYERS * calls + logit_calls,
        "qmatmul_swiglu_sr": LAYERS * calls,
        "flash_decode_paged": LAYERS * (eng.decode_steps
                                        + eng.single_token_chunks)},
        launches)
    if launches != want:
        fail(f"engine {ATTN_POLICY}: launches {launches} != {want}")
    if eng.free_pages != ec.total_pages - 1 or \
            {rid: len(t) for rid, t in out["tokens"].items()} != want_len:
        fail(f"engine {ATTN_POLICY}: did not drain")
    res[ATTN_POLICY] = dict(
        tokps=out["tokps"], ttft_p50_s=out["ttft_p50_s"],
        ttft_p99_s=out["ttft_p99_s"], wall_s=out["wall_s"],
        pool_bytes=out["pool_bytes"], peak_bytes=out["peak_bytes"],
        iterations=eng.iterations, decode_steps=eng.decode_steps,
        prefill_calls=eng.prefill_calls, launches=launches)
    print(f"  {ATTN_POLICY}: {eng.decode_steps} decode steps, "
          f"{eng.prefill_calls} prefill chunks, {out['tokps']:.1f} tok/s, "
          f"launches {launches}", flush=True)
    del out, eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def engine_agreement_phase(torch, serve):
    """The reduced engine on the card against the same weights on the
    CPU, teacher-forced on the CPU's picks (the same schedule on both):
    logits within phase 12's limits, the card's own picks within 0.1 of
    the CPU's best logit, and the pools' codes (scratch page 0 aside)
    differing in at most ATTN_AGREE_MAX_CODE_SHARE per layer."""
    import numpy as np
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    class Recording(ContinuousBatchingEngine):
        forced = None

        def _pick(self, logits, rows):
            own = super()._pick(logits, rows)
            last = logits[:, -1].float().cpu()
            picks = own.copy()
            for row, i in enumerate(rows):
                if i is None:
                    continue
                rid = self._slots[i].req.rid
                t = len(self.results[rid].tokens)
                self.logits.setdefault(rid, []).append(last[row])
                self.own.setdefault(rid, []).append(int(own[row]))
                if self.forced is not None:
                    picks[row] = self.forced[rid][t]
            return picks

    cfg_run = dict(n_short=6, n_long=2, short=(8, 3), long=(48, 32),
                   long_every=4, workload_seed=7)
    ec = EngineConfig(n_slots=4, page_size=8, total_pages=40,
                      max_pages_per_request=12, prefill_chunk=8,
                      token_budget=16)
    cpu = serve.build("tinyllama-1.1b", reduced=True,
                      gemm_policy=serve.ENGINE_POLICY, seed=7, device="cpu")
    cfg, model, params = cpu
    card_params = _to(params, torch.device("cuda"))
    reqs = serve.engine_workload(cfg.vocab_size, cfg_run["n_short"],
                                 cfg_run["n_long"], cfg_run["short"],
                                 cfg_run["long"], cfg_run["workload_seed"],
                                 cfg_run["long_every"])
    engines = []
    for prm, forced in ((params, None), (card_params, "cpu")):
        eng = Recording(model, prm, ec)
        eng.logits, eng.own = {}, {}
        if forced:
            eng.forced = {rid: r.tokens for rid, r in
                          engines[0].results.items()}
        eng.run([dataclasses.replace(r) for r in reqs])
        engines.append(eng)
    e_cpu, e_card = engines
    ref = torch.stack([x for rid in sorted(e_cpu.logits)
                       for x in e_cpu.logits[rid]])
    got = torch.stack([x for rid in sorted(e_card.logits)
                       for x in e_card.logits[rid]])
    d = (got - ref).abs()
    med, share = float(d.median()), float((d > 0.05).float().mean())
    own = torch.tensor([t for rid in sorted(e_card.own)
                        for t in e_card.own[rid]])
    chosen = ref.gather(1, own[:, None])[:, 0]
    picks_ok = bool((chosen >= ref.max(1).values - 0.1).all())
    pick_diff = int((own != ref.argmax(1)).sum())
    per_layer = []
    for a, b in ((e_cpu._k_pages, e_card._k_pages),
                 (e_cpu._v_pages, e_card._v_pages)):
        for i in range(a.shape[0]):
            per_layer.append(float((a[i, 1:] != b[i, 1:].cpu())
                                   .float().mean()))
    print(f"  reduced engine card vs cpu ({len(reqs)} requests, "
          f"{ref.shape[0]} picks): median |dlogit| {med:.4g}, share > 0.05 "
          f"{share:.4g}, card picks differing {pick_diff} (all within 0.1 "
          f"of the best: {picks_ok}), pool codes differing by layer (k, "
          f"then v) {per_layer}", flush=True)
    if not (med < 0.02 and share <= 0.10 and picks_ok):
        fail("engine card and CPU disagree beyond the stated tolerance")
    if max(per_layer) > ATTN_AGREE_MAX_CODE_SHARE:
        fail("engine card and CPU pool codes disagree beyond the stated "
             "tolerance")
    return dict(median_abs_dlogit=med, share_over_0_05=share,
                picks=int(ref.shape[0]), card_picks_differing=pick_diff,
                code_share_by_layer=per_layer)


def paper_phase(torch, tfu, smi: str):
    """Phase 29: the paper's GD experiments (``repro_torch.paper``) on the
    card: the convergence harness's smoke run on both engines (the
    ordering gate, K2''s launches by instance), MLR and the two-layer NN at
    full width, and card against CPU."""
    import numpy as np
    from repro_torch.core import gd, prng
    from repro_torch.core.rounding import spec
    from repro_torch.data import synthetic_binary_mnist, synthetic_mnist
    from repro_torch.paper import convergence as conv, paper_models as pm
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    print(f"  {smi}", flush=True)
    out = {}
    # (a) the convergence harness, both engines
    st = conv.settings(smoke=True)
    per_cell = st["sims"] * (st["steps_stag"] + st["steps_pl"]
                             + st["steps_ill"])
    want = {"generic": 0, "trainer": 0, "wide": 0}
    for grid in conv.GRIDS:
        cfgs = conv.scheme_cfgs(grid)
        for lab in st["labels"]:
            want[tfu.k2_instance(cfgs[lab])] += per_cell
    n_steps = sum(want.values())
    for engine in ("jnp", "kernel"):
        tfu.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        rows, failures = conv.run(smoke=True, engine=engine, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = tfu.LAUNCHES["fused_qupdate_prng"]
        by_inst = dict(tfu.INSTANCE_LAUNCHES)
        expect = n_steps if engine == "kernel" else 0
        if got != expect or (engine == "kernel" and by_inst != want):
            fail(f"convergence ({engine}): K2' launched {got} times "
                 f"{by_inst}, expected {expect} {want}")
        if failures:
            fail(f"convergence ({engine}): ordering gate failed {failures}")
        stag = {name.split("/")[1]: v for name, _, v in rows
                if name.endswith("stagnation_final_f")}
        out[f"convergence_{engine}"] = dict(
            wall_s=wall, gd_steps=n_steps, ms_per_gd_step=1e3 * wall / n_steps,
            launches=got, by_instance=by_inst,
            rows={name: v for name, _, v in rows[1:]})
        print(f"  convergence --smoke, engine {engine}: {n_steps} GD steps "
              f"in {wall:.1f} s ({1e3 * wall / n_steps:.3f} ms per step), "
              f"K2' {got} launches {by_inst}; ordering gate passed; "
              f"stagnation final f {stag}", flush=True)
    # (b) MLR and (c) the two-layer NN at full width
    f8, sr8 = "binary8", spec("binary8", "sr")
    schemes = {
        "binary32": (gd.fp32_config(), None, None),
        "rn": (gd.make_config(f8, "rn", "rn", "rn"), spec(f8, "rn"), f8),
        "sr": (gd.make_config(f8, "sr", "sr", "sr"), sr8, f8),
        "signed_sr_eps0.1": (gd.GDRounding(
            grad=sr8, mul=sr8, sub=spec(f8, "signed_sr_eps", 0.1),
            sub_v="grad"), sr8, f8)}
    for model, data, cls, t, epochs, every in (
            ("mlr", synthetic_mnist(*PAPER_MLR_DATA, seed=0), pm.MLRTrainer,
             0.5, PAPER_MLR_EPOCHS, 10),
            ("nn", synthetic_binary_mnist(*PAPER_NN_DATA, seed=0),
             pm.TwoLayerNNTrainer, 0.09375, PAPER_NN_EPOCHS, 5)):
        X, y, Xte, yte = pm.to_device(data, dev)
        res = {}
        for name, (cfg, gspec, pf) in schemes.items():
            tr = cls(cfg=cfg, t=t, grad_spec=gspec)
            torch.cuda.synchronize()
            t0 = time.time()
            _, hist = tr.train(X, y, Xte, yte, epochs, seed=0,
                               eval_every=every, param_fmt=pf)
            wall = time.time() - t0
            errs = [e for _, e in hist]
            if not all(0.0 <= e <= 1.0 for e in errs):
                fail(f"{model} {name}: test errors {errs}")
            res[name] = dict(test_errors=hist, ms_per_epoch=1e3 * wall
                             / epochs)
            print(f"  {model} ({X.shape[1]} -> "
                  f"{'10' if model == 'mlr' else '100 -> 1'}, "
                  f"{X.shape[0]} / {Xte.shape[0]} samples, t = {t}, depth "
                  f"cut to {epochs} epochs and 1 sim) {name}: test errors "
                  f"{[round(e, 4) for e in errs]}, "
                  f"{1e3 * wall / epochs:.2f} ms per epoch", flush=True)
        out[model] = res
    # (d) card against CPU
    agree = {}
    cfgs = {"bf16 sr/signed-SRe 0.4 (Fig. 3)": (
        gd.GDRounding(grad=spec("bfloat16", "rn"), mul=spec("bfloat16", "sr"),
                      sub=spec("bfloat16", "signed_sr_eps", 0.4),
                      sub_v="grad"), "bfloat16"),
            "binary8 sr2 (convergence)": (
        conv.scheme_cfgs("binary8")["sr2"], "binary8")}
    for t_name, t_step in (("Setting I's t", None), ("t = 0.5", 0.5)):
        for name, (cfg, fmt) in cfgs.items():
            for engine in ("jnp", "kernel"):
                res = []
                for d in (dev, cpu):
                    diag, x0, xstar, t, _ = pm.setting1(d)
                    fs, x = gd.run_gd(
                        lambda v: 0.5 * torch.sum(diag * (v - xstar) ** 2),
                        lambda v: diag * (v - xstar), x0, t_step or t, cfg,
                        PAPER_AGREE_STEPS, key=prng.PRNGKey(0),
                        param_fmt=fmt, engine=engine)
                    res.append((fs.cpu(), x.cpu()))
                if not bitwise(torch, res[0][1], res[1][1]):
                    fail(f"Setting I {name} {t_name} ({engine}): card "
                         "iterates not bitwise the CPU's")
                rel = float(((res[0][0] - res[1][0]).abs()
                             / res[1][0].abs().clamp_min(1e-30)).max())
                if rel > 1e-6:
                    fail(f"Setting I {name} ({engine}): f differs by {rel}")
                agree[f"setting1 {name} {t_name} {engine}"] = dict(
                    bitwise=True, f_max_rel=rel, final_f=float(res[0][0][-1]))
    print(f"  Setting I (n = 1000), {PAPER_AGREE_STEPS} steps, card vs CPU: "
          f"iterates bitwise on both engines under {list(cfgs)} at Setting "
          "I's t and at t = 0.5", flush=True)
    X, y, Xte, yte = synthetic_mnist(*PAPER_MLR_DATA, seed=0)
    tr = pm.MLRTrainer(cfg=schemes["sr"][0], t=0.5, grad_spec=sr8)
    Ws, errs = [], []
    for d in (dev, cpu):
        Xd, Xted, yted = (torch.as_tensor(a).to(d) for a in (X, Xte, yte))
        Y1h = torch.nn.functional.one_hot(torch.as_tensor(y).long().to(d),
                                          10).float()
        W, key = torch.zeros((784, 10), device=d), prng.PRNGKey(0)
        for e in range(3):
            key, sub = prng.split(key)
            W = tr.epoch(W, Xd, Y1h, sub)
            if e == 0:
                Ws.append(W.cpu())
        errs.append(tr.test_error(W, Xted, yted))
    from repro_torch.core.rounding import grid_flips
    n_diff, adjacent = grid_flips(Ws[1], Ws[0], "binary8")
    if n_diff > 1e-3 * Ws[0].numel() or not adjacent \
            or abs(errs[0] - errs[1]) > 0.02:
        fail(f"MLR card vs CPU: {n_diff} of W's {Ws[0].numel()} elements "
             f"differ (adjacent {adjacent}), test errors {errs}")
    agree["mlr"] = dict(w_epoch1_differing=n_diff, adjacent=adjacent,
                        test_error_card=errs[0], test_error_cpu=errs[1])
    print(f"  MLR full size card vs CPU: W after epoch 1 {n_diff} of "
          f"{Ws[0].numel()} elements one binary8 step apart; test error "
          f"after 3 epochs {errs[0]:.4f} (card) {errs[1]:.4f} (CPU)",
          flush=True)
    out["agreement"] = agree
    return out


def moe_kernel_entry(rows, name, source, replaces, launches, library):
    """A kernel of the MoE path: times per decode step (per-call time x
    launches per step at each path shape)."""
    path = [r for r in rows if r["per_step"]]

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in path)
    prompt = [r for r in rows if r.get("per_prompt")]
    extra = {}
    if prompt:
        extra = {f"prompt_{key}": sum(r[key] * r["per_prompt"]
                                      for r in prompt)
                 for key in ("ms", "device_ms", "bound_ms", "library_ms",
                             "library_device_ms")}
        extra["prompt_timed"] = (f"one {MOE_ARCH} whole-prompt forward's "
                                 f"launches (batch {BATCH} x prompt "
                                 f"{PROMPT} at once, {prompt[0]['M']} rows "
                                 "per expert)")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_step("ms"), plain_ms=per_step("plain_ms"),
        bound_ms=per_step("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in path)
        else "operations",
        library_ms=per_step("library_ms"), library=library,
        **({"device_ms": per_step("device_ms"),
            "library_device_ms": per_step("library_device_ms")}
           if all(r.get("device_ms") is not None for r in path) else {}),
        mismatch_share=max(r["mismatch_share"] for r in rows),
        timed=f"one {MOE_ARCH} decode step's launches (batch {BATCH}, "
              f"{MOE_LAYERS} layers)",
        launches_path=f"serve {MOE_ARCH} binary8-paper", **extra)


def kernel_entry(rows, name, source, replaces, launches, path_rows, timed,
                 **extra):
    def per_step(key):
        return sum(r[key] * r["per_step"] for r in path_rows)
    entry = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_step("ms"), plain_ms=per_step("plain_ms"),
        bound_ms=per_step("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes"
                                for r in path_rows) else "operations",
        library_ms=None, gemm_only_ms=per_step("gemm_only_ms"),
        mismatch_share=max(r["mismatch_share"] for r in rows),
        timed=timed)
    if all("device_ms" in r for r in path_rows):
        entry.update(device_ms=per_step("device_ms"),
                     library_device_ms=per_step("library_device_ms"))
    entry.update(extra)
    return entry


def ptxas_usage(log: str):
    """{kernel: registers and spill bytes} from ptxas' -v report (the
    build's log), kernel names demangled where c++filt is found."""
    usage, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            usage[current] = dict(registers=None, spill_stores=0,
                                  spill_loads=0)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[current]["spill_stores"] = int(m.group(1))
            usage[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[current]["registers"] = int(m.group(1))
    if usage and shutil.which("c++filt"):
        names = list(usage)
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout
        plain = out.splitlines()
        if len(plain) == len(names):
            usage = {p.replace("(anonymous namespace)::", "")
                     .removeprefix("void ").split("(")[0]: usage[n]
                     for n, p in zip(names, plain)}
    return usage


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(HERE / "src"))
    try:
        from repro_torch.kernels import build, common as tcommon, \
            flash_attention as tfa, fused_update as tfu, qmatmul as tq, \
            sr_cast as tsr
        from repro_torch.launch import serve, train
        from repro_torch.precision import get_policy
    except ImportError as exc:
        fail(f"cannot import the port ({exc}); run from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: device", flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{kind} x{count}", flush=True)
    print(smi[0], flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.time()
    paths = build.build_all()
    t_build = time.time() - t0
    print(f"  built {sorted(paths)} in {t_build:.1f} s", flush=True)
    resources = {name: ptxas_usage(build.build_log(name))
                 for name in sorted(paths)}
    for name, kernels_ in resources.items():
        for fn, use in kernels_.items():
            print(f"  {name}: {fn}: {use['registers']} registers, spill "
                  f"{use['spill_stores']}/{use['spill_loads']} B "
                  "(stores/loads)", flush=True)

    print("== phase 3: GEMM kernels vs plain twins (serving shapes)",
          flush=True)
    rows = gemm_phase(torch, tq, gemm_cases(train=False))
    decode_rows_phase(torch, tq, tcommon)

    n_full = tinyllama_params()
    print(f"== phase 4: update kernels vs plain twins (n = "
          f"{UPDATE_N_SMALL} and {n_full})", flush=True)
    update_rows = update_phase(torch, n_full)

    print("== phase 5: GEMM kernels vs plain twins (train-step shapes)",
          flush=True)
    train_rows = gemm_phase(torch, tq, gemm_cases(train=True))

    print("== phase 6: serve tinyllama-1.1b binary8-paper", flush=True)
    mods = (tq, tfu, tfa, tsr)
    unpacked = {}           # its tokens and logits, for phase 23
    served = serve_phase(torch, mods, serve, keep=unpacked)

    print("== phase 7: serve agreement card vs cpu", flush=True)
    agree = agreement_phase(torch, serve)

    print(f"== phase 8: train tinyllama-1.1b, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, binary8-paper, signed-SRe "
          "binary8 update (fused)", flush=True)
    trained = train_phase(torch, mods, train)

    print("== phase 9: train agreement card vs cpu (reduced)", flush=True)
    train_agree, agree_launches = train_agreement_phase(torch, mods, train)

    print("== phase 10: attention kernels vs plain twins", flush=True)
    attn_rows = attention_phase(torch, tfa)

    print(f"== phase 11: serve tinyllama-1.1b {ATTN_POLICY}", flush=True)
    served_attn = serve_phase(torch, mods, serve, ATTN_POLICY)

    print(f"== phase 12: serve agreement card vs cpu ({ATTN_POLICY})",
          flush=True)
    agree_attn = agreement_phase(torch, serve, ATTN_POLICY)

    print(f"== phase 13: train tinyllama-1.1b, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, {ATTN_POLICY}", flush=True)
    trained_attn = train_phase(torch, mods, train, ATTN_POLICY)

    print(f"== phase 14: train agreement card vs cpu ({ATTN_POLICY}, "
          "reduced)", flush=True)
    train_agree_attn, _ = train_agreement_phase(torch, mods, train,
                                                ATTN_POLICY, ("fused",))

    print("== phase 15: MoE kernels (K1', K8') vs plain twins", flush=True)
    sr_cast_rows = sr_cast_phase(torch, tsr)
    batched_rows = batched_phase(torch, tq)

    print(f"== phase 16: serve agreement card vs cpu (reduced {MOE_ARCH})",
          flush=True)
    agree_moe = moe_agreement_phase(torch, serve)

    print(f"== phase 17: serve {MOE_ARCH} binary8-paper", flush=True)
    served_moe = moe_serve_phase(torch, mods, serve)

    print(f"== phase 18: K5 (fused QAdam) vs plain twin (n = "
          f"{UPDATE_N_SMALL} and {n_full})", flush=True)
    adam_rows, adam_full = adam_phase(torch, tfu, n_full)

    print(f"== phase 19: train tinyllama-1.1b, train.ADAM_RUN (QAdam, "
          f"bf16-sr codes through K5), {TRAIN_STEPS} steps + resume",
          flush=True)
    trained_adam = adam_train_phase(torch, mods, train)

    print("== phase 20: QAdam train agreement card vs cpu (reduced) and "
          "the fault drill", flush=True)
    adam_agree, adam_agree_launches = train_agreement_phase(
        torch, mods, train, adam=True)
    moment_path = moment_path_phase(torch, train)
    drill = adam_drill_phase(torch, train)

    print("== phase 21: explicit-bits kernels (K3, K4, K8, K1) vs plain "
          "twins and vs their in-kernel-bits kernels", flush=True)
    bits_rows = bits_gemm_phase(torch, tq, tcommon)
    bits_batched_rows = bits_batched_phase(torch, tq, tcommon)
    bits_cast_rows = bits_cast_phase(torch, tsr, tcommon)

    print(f"== phase 22: serve tinyllama-1.1b {ORACLE_POLICY} (and e4m3-sr)",
          flush=True)
    served_oracle = oracle_serve_phase(torch, mods, serve)

    print(f"== phase 23: serve tinyllama-1.1b {PACKED_POLICY}", flush=True)
    served_packed = packed_serve_phase(torch, mods, serve, unpacked)

    moe_oracle = dataclasses.replace(get_policy("binary8-paper"),
                                     oracle=True)
    print(f"== phase 24: agreement card vs cpu: reduced {MOE_ARCH} under "
          f"oracle binary8-paper; reduced tinyllama train steps under "
          f"{PACKED_POLICY} and {ORACLE_POLICY}", flush=True)
    agree_moe_oracle = moe_agreement_phase(torch, serve, moe_oracle)
    preset_train = preset_train_phase(torch, mods, train)

    print(f"== phase 25: serve {MOE_ARCH} oracle binary8-paper", flush=True)
    served_moe_oracle = moe_serve_phase(torch, mods, serve, moe_oracle)

    print("== phase 26: K10 (paged decode) vs plain twin", flush=True)
    paged_rows = paged_phase(torch, tfa)

    print("== phase 27: engine serve tinyllama-1.1b (ENGINE_RUN, "
          "ENGINE_POLICY)", flush=True)
    engine_runs = engine_phase(torch, mods, serve)

    print("== phase 28: engine agreement card vs cpu (reduced)", flush=True)
    engine_agree = engine_agreement_phase(torch, serve)

    print("== phase 29: the paper's GD experiments (repro_torch.paper)",
          flush=True)
    t0 = time.time()
    paper = paper_phase(torch, tfu, smi[0])
    paper["wall_s"] = time.time() - t0
    print(f"  phase 29 took {paper['wall_s']:.1f} s", flush=True)

    kernels = []
    replaces = {"qmatmul_sr": "src/repro/kernels/qmatmul.py:360",
                "qmatmul_swiglu_sr": "src/repro/kernels/qmatmul.py:846"}
    for name in ("qmatmul_sr", "qmatmul_swiglu_sr"):
        serve_rows = [r for r in rows if r["kernel"] == name and r["M"] == 4
                      and r["per_step"]]
        path_rows = [r for r in train_rows if r["kernel"] == name]
        all_rows = [r for r in rows + train_rows if r["kernel"] == name]
        kernels.append(kernel_entry(
            all_rows, name, f"src/repro_torch/csrc/{name}.cu",
            replaces[name], trained["launches"][name], path_rows,
            "sum over one batch-4 x 256 train step's launches",
            launches_serve=served["launches"][name],
            launches_moe_serve=served_moe["launches"][name],
            serve_step_ms=sum(r["ms"] * r["per_step"] for r in serve_rows),
            serve_step_bound_ms=sum(r["bound_ms"] * r["per_step"]
                                    for r in serve_rows),
            serve_step_plain_ms=sum(r["plain_ms"] * r["per_step"]
                                    for r in serve_rows),
            serve_step_gemm_only_ms=sum(r["gemm_only_ms"] * r["per_step"]
                                        for r in serve_rows),
            **({"serve_step_device_ms": sum(
                r["device_ms"] * r["per_step"] for r in serve_rows),
                "serve_step_library_device_ms": sum(
                    r["library_device_ms"] * r["per_step"]
                    for r in serve_rows)}
               if all("device_ms" in r for r in serve_rows) else {})))
    qupdate_rows = [r for r in update_rows if r["config"] != "momentum_fma"]
    full = [r for r in qupdate_rows if r["n"] == n_full][0]
    for name, mode, n_launch, line in (
            ("fused_qupdate_prng", "prng",
             trained["launches"]["fused_qupdate_prng"], 123),
            ("fused_qupdate_bits", "bits",
             agree_launches["fused_bits"]["fused_qupdate_bits"], 68)):
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/fused_qupdate.cu",
            replaces=f"src/repro/kernels/fused_update.py:{line}",
            launches=n_launch,
            max_abs_err=max(r[f"max_abs_err_{mode}"] for r in qupdate_rows),
            ms=full[f"{mode}_ms"], plain_ms=full[f"{mode}_plain_ms"],
            bound_ms=full[f"{mode}_bound_ms"],
            bound_by=full[f"{mode}_bound_by"], library_ms=None,
            unrounded_axpy_ms=full["axpy_ms"], instance=full["instance"],
            generic_instance_ms=full[f"{mode}_generic_ms"],
            wide_timed_chain=dict(
                chain=full["wide_timed_chain"],
                wide_ms=full[f"{mode}_wide_rss_ms"],
                generic_ms=full[f"{mode}_generic_rss_ms"],
                wide_device_ms=full[f"{mode}_wide_rss_device_ms"],
                generic_device_ms=full[f"{mode}_generic_rss_device_ms"],
                bound_ms=full[f"{mode}_rss_bound_ms"],
                bound_by=full[f"{mode}_rss_bound_by"]),
            launches_paper=(paper["convergence_kernel"]["launches"]
                            if mode == "prng" else None),
            launches_paper_by_instance=(
                paper["convergence_kernel"]["by_instance"]
                if mode == "prng" else None),
            timed=f"one launch over the {n_full} tinyllama-1.1b parameters "
                  "(one train step) on the trainer's chain, also on the "
                  "generic instance (generic_instance_ms); wide_timed_chain "
                  "holds both instances on another chain over the same "
                  "elements",
            launches_path="train" if mode == "prng"
            else "train agreement, --update-path fused_bits"))
    fma_full = [r for r in update_rows
                if r["n"] == n_full and r["config"] == "momentum_fma"][0]
    kernels.append(dict(
        name="momentum_fma", route="cuda",
        source="src/repro_torch/csrc/fused_qupdate.cu",
        replaces="src/repro/optim/sgd.py:72 (XLA's fused multiply-add of "
                 "the momentum; no Pallas kernel)",
        launches=trained["launches"]["momentum_fma"],
        max_abs_err=max(r["max_abs_err_fma"] for r in update_rows
                        if r["config"] == "momentum_fma"),
        ms=fma_full["fma_ms"], plain_ms=fma_full["fma_plain_ms"],
        bound_ms=fma_full["fma_bound_ms"], bound_by=fma_full["fma_bound_by"],
        library_ms=None, add_alpha_ms=fma_full["add_alpha_ms"],
        timed=f"one launch over the {n_full} tinyllama-1.1b parameters "
              "(one train step)", launches_path="train"))
    lines = {"flash_fwd": 195, "flash_bwd_dq": 344, "flash_bwd_dkv": 438,
             "flash_decode": 649}
    for name, line in lines.items():
        main_row = [r for r in attn_rows[name] if r["main"]][0]
        serve_path = name == "flash_decode"
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            launches=(served_attn if serve_path
                      else trained_attn)["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in attn_rows[name]),
            ms=LAYERS * main_row["ms"], plain_ms=LAYERS * main_row["plain_ms"],
            bound_ms=LAYERS * main_row["bound_ms"],
            bound_by=main_row["bound_by"],
            library_ms=LAYERS * main_row["library_ms"],
            library=main_row["library"] + ", float32, unrounded",
            **({"device_ms": LAYERS * main_row["device_ms"],
                "library_device_ms": LAYERS * main_row["library_device_ms"],
                "tiled_ms": LAYERS * main_row["tiled_ms"],
                "tiled_device_ms": LAYERS * main_row["tiled_device_ms"],
                "launches_tiled": served_attn["launches"][
                    "flash_decode_tiled"]}
               if serve_path else
               {"launches_two_pass": trained_attn["launches"][
                   "flash_fwd_two_pass"]} if name == "flash_fwd" else
               {"device_ms": LAYERS * main_row["device_ms"],
                "library_device_ms": LAYERS * main_row["library_device_ms"],
                "library_fwd_bwd_ms": LAYERS * main_row[
                    "library_fwd_bwd_ms"],
                "simple_ms": LAYERS * main_row["simple_ms"],
                "simple_device_ms": LAYERS * main_row["simple_device_ms"],
                "launches_simple": trained_attn["launches"][
                    f"{name}_simple"]}),
            mismatch_share=max(r["mismatch_share"] for r in attn_rows[name]),
            timed=(f"one decode step's {LAYERS} launches at length "
                   f"{DECODE['Smax']}" if serve_path else
                   f"one batch-{TRAIN_BATCH} x {TRAIN_SEQ} train step's "
                   f"{LAYERS} launches"),
            launches_path=f"{'serve' if serve_path else 'train'} "
                          f"{ATTN_POLICY}"))
    kernels.append(dict(
        name="fused_qadam_prng", route="cuda",
        source="src/repro_torch/csrc/fused_qupdate.cu",
        replaces="src/repro/kernels/fused_update.py:234",
        launches=trained_adam["launches"]["fused_qadam_prng"],
        max_abs_err=max(r["max_abs_err"] for r in adam_rows),
        ms=adam_full["ms"], plain_ms=adam_full["plain_ms"],
        bound_ms=adam_full["bound_ms"], bound_by=adam_full["bound_by"],
        library_ms=adam_full["library_ms"],
        library="torch.optim.Adam([flat], fused=True).step(), float32 "
                "moments, unrounded",
        timed=f"one launch over the {n_full} tinyllama-1.1b parameters "
              "(one ADAM_RUN step, bf16-sr codes)",
        launches_path="train ADAM_RUN",
        launches_agreement_fused_bits=adam_agree_launches["fused_bits"][
            "fused_qupdate_bits"]))
    kernels.append(moe_kernel_entry(
        sr_cast_rows, "sr_cast_prng", "src/repro_torch/csrc/sr_cast.cu",
        "src/repro/kernels/sr_cast.py:148",
        served_moe["launches"]["sr_cast_prng"],
        "x.to(torch.bfloat16) (a cast, not the rounding)"))
    kernels.append(moe_kernel_entry(
        batched_rows, "qmatmul_batched_sr",
        "src/repro_torch/csrc/qmatmul_batched_sr.cu",
        "src/repro/kernels/qmatmul.py:599",
        served_moe["launches"]["qmatmul_batched_sr"],
        "torch.bmm over bf16 operands, unrounded"))
    k3_rows = [r for r in bits_rows if r["kernel"] == "qmatmul_bits"]
    k4_rows = [r for r in bits_rows if r["kernel"] == "qmatmul_swiglu_bits"]
    path1 = f"serve tinyllama-1.1b {ORACLE_POLICY}"
    for name, rows_, line, path_launches in (
            ("qmatmul_bits", k3_rows, 332,
             served_oracle["oracle"]["launches"]["qmatmul_bits"]),
            ("qmatmul_swiglu_bits", k4_rows, 822,
             served_oracle["oracle"]["launches"]["qmatmul_swiglu_bits"])):
        path_rows = [r for r in rows_ if r["per_step"]]
        source = "qmatmul_sr" if name == "qmatmul_bits" \
            else "qmatmul_swiglu_sr"
        dev = {key: sum(r[key] * r["per_step"] for r in path_rows)
               for key in ("device_ms", "prng_device_ms",
                           "library_device_ms")
               if all(key in r for r in path_rows)}
        kernels.append(kernel_entry(
            rows_, name, f"src/repro_torch/csrc/{source}.cu",
            f"src/repro/kernels/qmatmul.py:{line}", path_launches, path_rows,
            f"one tinyllama-1.1b decode step's launches (batch {BATCH}, "
            f"{LAYERS} layers)", launches_path=path1,
            launches_moe_oracle=served_moe_oracle["launches"][name],
            in_kernel_bits_ms=sum(r["prng_ms"] * r["per_step"]
                                  for r in path_rows), **dev))
    for rows_, name, source, line, lib in (
            (bits_batched_rows, "qmatmul_batched_bits",
             "qmatmul_batched_sr.cu", "qmatmul.py:578",
             "torch.bmm over bf16 operands, unrounded"),
            (bits_cast_rows, "sr_cast_bits", "sr_cast.cu", "sr_cast.py:73",
             "x.to(torch.bfloat16) (a cast, not the rounding)")):
        entry = moe_kernel_entry(
            rows_, name, f"src/repro_torch/csrc/{source}",
            f"src/repro/kernels/{line}",
            served_moe_oracle["launches"][name], lib)
        entry.update(launches_path=f"serve {MOE_ARCH} oracle binary8-paper",
                     in_kernel_bits_ms=sum(r["prng_ms"] * r["per_step"]
                                           for r in rows_ if r["per_step"]))
        if all("prng_device_ms" in r for r in rows_ if r["per_step"]):
            entry["in_kernel_bits_device_ms"] = sum(
                r["prng_device_ms"] * r["per_step"] for r in rows_
                if r["per_step"])
        for key, out in (("generic_ms", "generic_instance_ms"),
                         ("generic_device_ms",
                          "generic_instance_device_ms")):   # K1's
            if all(r.get(key) is not None for r in rows_ if r["per_step"]):
                entry[out] = sum(r[key] * r["per_step"] for r in rows_
                                 if r["per_step"])
        kernels.append(entry)
    main_row = [r for r in paged_rows if r["main"]][0]
    kernels.append(dict(
        name="flash_decode_paged", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:743",
        launches=engine_runs["ENGINE_RUN"]["launches"]["flash_decode_paged"],
        max_abs_err=max(r["max_abs_err"] for r in paged_rows),
        ms=LAYERS * main_row["ms"], plain_ms=LAYERS * main_row["plain_ms"],
        bound_ms=LAYERS * main_row["bound_ms"],
        bound_by=main_row["bound_by"],
        library_ms=LAYERS * main_row["library_ms"],
        library=main_row["library"],
        device_ms=LAYERS * main_row["device_ms"],
        library_device_ms=LAYERS * main_row["library_device_ms"],
        mismatch_share=max(r["mismatch_share"] for r in paged_rows),
        timed=f"one engine decode step's {LAYERS} launches ("
              f"{main_row['case']})",
        launches_path="engine serve tinyllama-1.1b ENGINE_RUN, "
                      "ENGINE_POLICY"))
    # each kernel's instances in ptxas' report: names holding all of the
    # parts (K9: the decode kernel's contiguous instances and the tiled
    # route's fwd_kernel)
    stems = {"flash_decode": [("decode_paged_kernel", "true>"),
                              ("fwd_kernel",)],
             "flash_decode_paged": [("decode_paged_kernel", "false>")],
             "fused_qupdate_prng": [("fused_qupdate_kernel<",),
                                    ("fused_qupdate_wide_kernel<",)],
             "fused_qupdate_bits": [("fused_qupdate_kernel<",),
                                    ("fused_qupdate_wide_kernel<",)],
             "sr_cast_prng": [("sr_cast_prng_kernel",)],
             "sr_cast_bits": [("sr_cast_bits_kernel",)],
             **dict.fromkeys(("qmatmul_sr", "qmatmul_bits",
                              "qmatmul_swiglu_sr", "qmatmul_swiglu_bits",
                              "qmatmul_batched_sr", "qmatmul_batched_bits"),
                             [("_kernel",)])}
    for entry in kernels:
        src = Path(entry["source"]).stem
        parts = stems.get(entry["name"])
        if parts:
            entry["registers"] = {
                fn: use for fn, use in resources.get(src, {}).items()
                if any(all(p in fn for p in alt) for alt in parts)}
    report = dict(device=kind, nvidia_smi=smi[0], build_s=t_build,
                  registers=resources,
                  rows=rows, train_rows=train_rows, update_rows=update_rows,
                  serve=served, agreement=agree, train=trained,
                  train_agreement=train_agree,
                  train_agreement_launches=agree_launches,
                  attention_rows=attn_rows, serve_attn=served_attn,
                  agreement_attn=agree_attn, train_attn=trained_attn,
                  train_agreement_attn=train_agree_attn,
                  sr_cast_rows=sr_cast_rows, batched_rows=batched_rows,
                  agreement_moe=agree_moe, serve_moe=served_moe,
                  adam_rows=adam_rows, adam_full=adam_full,
                  train_adam=trained_adam, train_agreement_adam=adam_agree,
                  train_agreement_adam_launches=adam_agree_launches,
                  moment_path_adam=moment_path, fault_drill=drill,
                  bits_rows=bits_rows, bits_batched_rows=bits_batched_rows,
                  bits_cast_rows=bits_cast_rows, serve_oracle=served_oracle,
                  serve_packed=served_packed,
                  agreement_moe_oracle=agree_moe_oracle,
                  train_presets=preset_train,
                  serve_moe_oracle=served_moe_oracle,
                  paged_rows=paged_rows, engine=engine_runs,
                  engine_agreement=engine_agree, paper=paper,
                  t_total_s=time.time() - T_START, kernels=kernels)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"  total {report['t_total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
