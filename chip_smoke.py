#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check exits non-zero; there is no CPU fallback):

1. device: the card's name, count and ``nvidia-smi`` name / power limit;
2. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (one process per source, all at once);
3. GEMM kernels vs plain: K3' and K4' at the serving path's shapes (M = 4
   and 128) against their plain PyTorch twins -- bitwise on exact-sum
   inputs, at most 1e-4 one-ulp flips on N(0, 1) inputs -- and timed with
   CUDA events beside the bound, the twin and the bare fp32 GEMM
   (``torch.matmul``, the GEMM-only yardstick: no single PyTorch call
   computes the rounded function);
4. update kernels vs plain: K2' and K2 (the eq.-8 update) at n = 2**24 + 37
   under five rounding configs and at the full tinyllama-1.1b parameter
   count under the trainer's config, and the momentum FMA at both sizes,
   bitwise against their twins, timed beside the bound, the twin and the
   unrounded ``x - t * g`` / ``torch.add(g, m, alpha=0.9)`` (yardsticks
   only);
5. training GEMMs vs plain: K3' at every forward/dgrad/wgrad shape of a
   batch-4 x 256 train step and K4' with residuals, checked and timed as in
   phase 3;
6. serve: ``repro_torch.launch.serve.run`` on tinyllama-1.1b at full width
   and depth (random weights from a seeded generator) under
   ``binary8-paper``, with every kernel's launch count checked;
7. serve agreement: reduced tinyllama on the card against the same model on
   the CPU (plain twins), teacher-forced;
8. train: ``repro_torch.launch.train.run`` of ``train.PAPER_RUN``:
   tinyllama-1.1b at full width and depth, batch 4 x 256 tokens, 4 steps,
   ``binary8-paper`` GEMMs and the signed-SRe binary8 update through K2'
   (``--update-path fused``): launch counts, a finite loss at every step,
   ms/step, tokens/s, memory;
9. train agreement: reduced tinyllama, 2 steps on the card against the CPU
   twins from the same parameters and batches, for ``fused`` (K2') and
   ``fused_bits`` (K2): at most ``AGREE_MAX_PARAMS`` parameters differ and
   the losses agree within ``AGREE_MAX_REL_LOSS``;
10. one JSON line of per-kernel numbers, then the result line.

Detailed numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
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
MOMENTUM = 0.9
# phase 9's limits, set from its readings (0 of 90,432 parameters differ,
# losses within 9.8e-8 relative: one float32 ulp of the cross-entropy sum)
AGREE_MAX_PARAMS = 8
AGREE_MAX_REL_LOSS = 5e-7
# (grad, mul, sub) spec names of the extra update configs of phase 4
UPDATE_CONFIGS = {
    "sr_eps-binary8": ("binary8-rn", "binary8-sr_eps-e0.1", "binary8-sr"),
    "sr-r16-binary8": ("binary8-sr-r16",) * 3,
    "rn-binary8": ("binary8-rn",) * 3,
    "signed_sr_eps-bf16": ("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1"),
}


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
        rows.append(row)
        print(f"  {name:18s} M={M:5d} K={K:5d} N={N:6d} B={case['b']:4s}"
              f"{' +res' if res else ''}  kernel {ms:8.4f} ms  bound "
              f"{bms:8.4f} ms ({by})  plain {plain:8.3f} ms  "
              f"gemm-only(torch.matmul fp32) {gemm:8.4f} ms  flips "
              f"{n_bad}/{ref.numel()} (max {steps:g} steps)", flush=True)
        del a, ws, wsets, w32, got, ref
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


def update_phase(torch, n_full: int):
    """K2' and K2 against their plain twins (bitwise) and timed."""
    from repro_torch.core import gd, prng
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.launch.train import rounding_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    trainer = rounding_config("signed_sr_eps", "binary8", 0.1)
    configs = {"signed_sr_eps-binary8 (trainer)": trainer}
    configs.update({k: gd.GDRounding(*(parse_spec(s) for s in v))
                    for k, v in UPDATE_CONFIGS.items()})
    rows = []
    for n, names in ((UPDATE_N_SMALL, list(configs)),
                     (n_full, ["signed_sr_eps-binary8 (trainer)"])):
        x = torch.randn(n, generator=gen, device=dev) * 0.02
        g = torch.randn(n, generator=gen, device=dev) * 0.3
        for name in names:
            cfg = configs[name]
            got = tfu.fused_qupdate_prng(x, g, UPDATE_T, UPDATE_SEED, cfg)
            ref = tfu.fused_qupdate_prng_plain(x, g, UPDATE_T, UPDATE_SEED,
                                               cfg)
            torch.cuda.synchronize()
            if not bitwise(torch, got, ref):
                fail(f"fused_qupdate_prng n={n} {name}: not bitwise equal "
                     "to the plain twin")
            err_prng = float((got - ref).abs().max())
            del got, ref
            bits3 = prng.random_words(prng.fold_in(prng.PRNGKey(5), n),
                                      (3, n), dev)
            got = tfu.fused_qupdate(x, g, UPDATE_T, bits3, cfg)
            ref = tfu.fused_qupdate_plain(x, g, UPDATE_T, bits3, cfg)
            torch.cuda.synchronize()
            if not bitwise(torch, got, ref):
                fail(f"fused_qupdate_bits n={n} {name}: not bitwise equal "
                     "to the plain twin")
            err_bits = float((got - ref).abs().max())
            del got, ref
            row = dict(n=n, config=name, bitwise=True,
                       max_abs_err_prng=err_prng, max_abs_err_bits=err_bits)
            if name.endswith("(trainer)"):
                iters = 10 if n > UPDATE_N_SMALL else 50
                row.update(
                    prng_ms=time_ms(torch, lambda i: tfu.fused_qupdate_prng(
                        x, g, UPDATE_T, UPDATE_SEED, cfg), 1, iters=iters),
                    bits_ms=time_ms(torch, lambda i: tfu.fused_qupdate(
                        x, g, UPDATE_T, bits3, cfg), 1, iters=iters),
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
                print(f"  n={n:11d} {name}: K2' {row['prng_ms']:.3f} ms "
                      f"(bound {row['prng_bound_ms']:.3f} ms, "
                      f"{row['prng_bound_by']}; plain "
                      f"{row['prng_plain_ms']:.1f} ms)  K2 "
                      f"{row['bits_ms']:.3f} ms (bound "
                      f"{row['bits_bound_ms']:.3f} ms, "
                      f"{row['bits_bound_by']}; plain "
                      f"{row['bits_plain_ms']:.1f} ms)  unrounded x - t*g "
                      f"{row['axpy_ms']:.3f} ms; bf16 cast "
                      f"{row['bf16_cast_ms']:.3f} ms", flush=True)
            else:
                print(f"  n={n:11d} {name}: K2' and K2 bitwise equal to "
                      "their twins", flush=True)
            rows.append(row)
            del bits3
        rows.append(momentum_fma_check(torch, tfu, x, g, n == n_full))
        del x, g
        torch.cuda.empty_cache()
    return rows


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


def serve_phase(torch, tq, serve):
    torch.cuda.reset_peak_memory_stats()
    tq.reset_launches()
    out = serve.run("tinyllama-1.1b", batch=BATCH, prompt_len=PROMPT,
                    gen=GEN, gemm_policy="binary8-paper", device="cuda")
    launches = dict(tq.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = PROMPT + GEN
    want = {"qmatmul_sr": 5 * TINYLLAMA["n_layers"] * steps + GEN,
            "qmatmul_swiglu_sr": TINYLLAMA["n_layers"] * steps}
    if launches != want:
        fail(f"launch counts {launches} != expected {want}")
    toks, logits = out["tokens"], out["logits"]
    if tuple(toks.shape) != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= TINYLLAMA["vocab"]:
        fail(f"bad tokens {toks.tolist()}")
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    print(f"  prefill {out['prefill_tokps']:.1f} tok/s, decode "
          f"{out['decode_tokps']:.1f} tok/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}", flush=True)
    return dict(prefill_tokps=out["prefill_tokps"],
                decode_tokps=out["decode_tokps"], t_prefill=out["t_prefill"],
                t_decode=out["t_decode"], peak_bytes=peak,
                launches=launches)


def agreement_phase(torch, serve):
    """The whole serving path on the card vs the plain twins on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy="binary8-paper")
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
    print(f"  reduced tinyllama card vs cpu: median |dlogit| {med:.4g}, "
          f"share > 0.05 {share:.4g}", flush=True)
    if not (med < 0.02 and share <= 0.10):
        fail("card and CPU paths disagree beyond the stated tolerance")
    return dict(median_abs_dlogit=med, share_over_0_05=share)


def reset_all(tq, tfu):
    tq.reset_launches()
    tfu.reset_launches()


def all_launches(tq, tfu):
    return {**tq.LAUNCHES, **tfu.LAUNCHES}


def train_phase(torch, tq, tfu, train):
    """The full-size train run; returns its numbers."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train.PAPER_RUN
    if (run["arch"], run["batch"], run["seq"]) != ("tinyllama-1.1b",
                                                   TRAIN_BATCH, TRAIN_SEQ):
        fail(f"train.PAPER_RUN {run} is not the run whose shapes phase 5 "
             "checks")
    reset_all(tq, tfu)
    out = train.run(steps=TRAIN_STEPS, device="cuda", **run)
    launches = all_launches(tq, tfu)
    peak = torch.cuda.max_memory_allocated()
    want = {"qmatmul_sr": TRAIN_STEPS * TRAIN_QMATMUL_PER_STEP,
            "qmatmul_swiglu_sr": TRAIN_STEPS * LAYERS,
            "fused_qupdate_prng": TRAIN_STEPS, "fused_qupdate_bits": 0,
            "momentum_fma": TRAIN_STEPS}
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


def train_agreement_phase(torch, tq, tfu, train):
    """Reduced tinyllama, 2 steps on the card vs the CPU twins from the
    same parameters and batches: the parameters bitwise equal but for a
    handful (``AGREE_MAX_PARAMS``) and the losses within
    ``AGREE_MAX_REL_LOSS`` relative.  A GEMM sum that lands within a
    float32 ulp of a rounding decision would flip and move the stochastic
    updates behind it (percents of the parameters); this draw has none."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.tree_update import tree_leaves
    from repro_torch.models import build_model
    cfg = reduced(get_config("tinyllama-1.1b"))
    master = build_model(cfg).init_master(torch.Generator().manual_seed(3))
    res, launches = {}, {}
    for path in ("fused", "fused_bits"):
        kw = dict(reduced=True, steps=2, batch=2, seq=16,
                  gemm_policy="binary8-paper", rounding_kind="signed_sr_eps",
                  fmt="binary8", eps=0.1, update_path=path, verbose=False)
        cpu = train.run("tinyllama-1.1b", device="cpu", params=master, **kw)
        reset_all(tq, tfu)
        card = train.run("tinyllama-1.1b", device="cuda",
                         params=_to(master, "cuda"), **kw)
        torch.cuda.synchronize()
        launches[path] = all_launches(tq, tfu)
        kernel = "fused_qupdate_prng" if path == "fused" \
            else "fused_qupdate_bits"
        for k in (kernel, "momentum_fma"):
            if launches[path][k] != 2:
                fail(f"train agreement {path}: {k} launched "
                     f"{launches[path][k]} times, not 2")
        lc = [h["loss"] for h in cpu["history"]]
        lg = [h["loss"] for h in card["history"]]
        rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        n_diff = n = 0
        for a, b in zip(tree_leaves(cpu["params"]),
                        tree_leaves(card["params"])):
            n_diff += int((a.view(torch.int32)
                           != b.cpu().view(torch.int32)).sum())
            n += a.numel()
        share = n_diff / n
        print(f"  {path}: losses cpu {lc} card {lg} (max rel diff "
              f"{rel:.3g}), parameters differing {n_diff}/{n} "
              f"({share:.3g})", flush=True)
        if rel > AGREE_MAX_REL_LOSS or n_diff > AGREE_MAX_PARAMS:
            fail(f"train agreement {path}: beyond the stated tolerance")
        res[path] = dict(losses_cpu=lc, losses_card=lg, max_rel_loss=rel,
                         params_differing=n_diff, params=n)
    return res, launches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def kernel_entry(rows, name, source, replaces, launches, path_rows, timed,
                 **extra):
    def per_step(key):
        return sum(r[key] * r["per_step"] for r in path_rows)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_step("ms"), plain_ms=per_step("plain_ms"),
        bound_ms=per_step("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes"
                                for r in path_rows) else "operations",
        library_ms=None, gemm_only_ms=per_step("gemm_only_ms"),
        mismatch_share=max(r["mismatch_share"] for r in rows),
        timed=timed, **extra)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(HERE / "src"))
    try:
        from repro_torch.kernels import build, fused_update as tfu, \
            qmatmul as tq
        from repro_torch.launch import serve, train
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
    for name in sorted(paths):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    print("== phase 3: GEMM kernels vs plain twins (serving shapes)",
          flush=True)
    rows = gemm_phase(torch, tq, gemm_cases(train=False))

    n_full = tinyllama_params()
    print(f"== phase 4: update kernels vs plain twins (n = "
          f"{UPDATE_N_SMALL} and {n_full})", flush=True)
    update_rows = update_phase(torch, n_full)

    print("== phase 5: GEMM kernels vs plain twins (train-step shapes)",
          flush=True)
    train_rows = gemm_phase(torch, tq, gemm_cases(train=True))

    print("== phase 6: serve tinyllama-1.1b binary8-paper", flush=True)
    served = serve_phase(torch, tq, serve)

    print("== phase 7: serve agreement card vs cpu", flush=True)
    agree = agreement_phase(torch, serve)

    print(f"== phase 8: train tinyllama-1.1b, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, binary8-paper, signed-SRe "
          "binary8 update (fused)", flush=True)
    trained = train_phase(torch, tq, tfu, train)

    print("== phase 9: train agreement card vs cpu (reduced)", flush=True)
    train_agree, agree_launches = train_agreement_phase(torch, tq, tfu,
                                                        train)

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
            serve_step_ms=sum(r["ms"] * r["per_step"] for r in serve_rows),
            serve_step_bound_ms=sum(r["bound_ms"] * r["per_step"]
                                    for r in serve_rows),
            serve_step_plain_ms=sum(r["plain_ms"] * r["per_step"]
                                    for r in serve_rows)))
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
            unrounded_axpy_ms=full["axpy_ms"],
            timed=f"one launch over the {n_full} tinyllama-1.1b parameters "
                  "(one train step)",
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
    report = dict(device=kind, nvidia_smi=smi[0], build_s=t_build,
                  rows=rows, train_rows=train_rows, update_rows=update_rows,
                  serve=served, agreement=agree, train=trained,
                  train_agreement=train_agree,
                  train_agreement_launches=agree_launches, kernels=kernels)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
