#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check exits non-zero; there is no CPU fallback):

1. device: the card's name, count and ``nvidia-smi`` name / power limit;
2. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc;
3. kernels vs plain: each kernel at the serving path's shapes (M = 4 and
   128) against its plain PyTorch twin -- bitwise on exact-sum inputs, at
   most 1e-4 one-ulp flips on N(0, 1) inputs -- and timed with CUDA events
   beside its bound, the twin and the bare fp32 GEMM (``torch.matmul``, the
   GEMM-only yardstick: no single PyTorch call computes the rounded
   function);
4. serve: ``repro_torch.launch.serve.run`` on tinyllama-1.1b at full width
   and depth (random weights from a seeded generator) under the
   ``binary8-paper`` policy, with every kernel's launch count checked;
5. path agreement: reduced tinyllama on the card against the same model on
   the CPU (plain twins), teacher-forced;
6. one JSON line of per-kernel numbers, then the result line.

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
L2_BYTES = 50 * 2 ** 20

TINYLLAMA = dict(d=2048, n_layers=22, q=2048, kv=256, ff=5632, vocab=32000)
# (K, N, launches per decode step) of each kernel's calls on the path
QMATMUL_SHAPES = [(2048, 2048, 2 * 22), (2048, 256, 2 * 22),
                  (5632, 2048, 22), (2048, 32000, 1)]
SWIGLU_SHAPES = [(2048, 5632, 22)]
RAGGED = (37, 45, 70)
BATCH, PROMPT, GEN = 4, 32, 16


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(M, K, N, n_weights, b_bytes=2):
    """Least time for the work: the larger of the bytes (each input read
    once, the output written once) over HBM rate and the fp32 flops over
    the fp32 peak."""
    nbytes = M * K * 4 + n_weights * K * N * b_bytes + M * N * 4
    flops = 2 * n_weights * M * N * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, n_copies, iters=20):
    """Mean ms per call over ``iters`` calls after a warm-up, cycling over
    ``n_copies`` operand sets so the weights come from HBM, not L2."""
    for i in range(3):
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


def kernel_phase(torch, tq):
    """Kernel vs plain twin at the path's shapes; returns per-shape rows."""
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

    cases = [("qmatmul_sr", M, K, N, c) for (K, N, c) in QMATMUL_SHAPES
             for M in (4, 128)]
    cases += [("qmatmul_swiglu_sr", M, K, N, c) for (K, N, c) in SWIGLU_SHAPES
              for M in (4, 128)]
    cases += [("qmatmul_sr", RAGGED[0], RAGGED[1], RAGGED[2], 0),
              ("qmatmul_swiglu_sr", RAGGED[0], RAGGED[1], RAGGED[2], 0)]
    for name, M, K, N, per_step in cases:
        swiglu = name == "qmatmul_swiglu_sr"
        nw = 2 if swiglu else 1

        def run_kernel(a, ws, fmt="binary8", mode="sr", rb=32):
            if swiglu:
                return tq.qmatmul_swiglu_prng(a, ws[0], ws[1], seeds, fmt,
                                              mode, act_spec=act,
                                              rand_bits=rb)
            return tq.qmatmul_prng(a, ws[0], words, fmt, mode, rb)

        def run_plain(a, ws, fmt="binary8", mode="sr", rb=32):
            if swiglu:
                return tq.qmatmul_swiglu_plain(a, ws[0], ws[1], seeds, fmt,
                                               mode, rb, act_spec=act)
            return tq.qmatmul_plain(a, ws[0], words, fmt, mode, rb)

        # (a) exact sums: dyadic small values, every partial sum exact
        a = ints((M, K), 8.0)
        ws = [ints((K, N), 4.0).to(torch.bfloat16) for _ in range(nw)]
        variants = [("binary8", "sr", 32), ("binary8", "rn", 32)]
        if (M, K, N) == RAGGED:
            variants += [("e4m3", "sr", 16), ("binary8", "sr", 8),
                         ("binary16", "rn", 32), ("bfloat16", "sr", 32)]
        for fmt, mode, rb in variants:
            got = run_kernel(a, ws, fmt, mode, rb)
            ref = run_plain(a, ws, fmt, mode, rb)
            torch.cuda.synchronize()
            if not swiglu and not torch.equal(got.view(torch.int32),
                                              ref.view(torch.int32)):
                fail(f"{name} {M}x{K}x{N} {fmt}-{mode}-r{rb}: not bitwise "
                     "equal to the plain twin on exact-sum inputs")
            if swiglu:
                # the rounded branches are exact; SiLU's exp may move the
                # hidden across one act-grid decision
                n_bad, adjacent = grid_flips(ref, got, "binary8")
                if n_bad > 1e-4 * ref.numel() or not adjacent:
                    fail(f"{name} {M}x{K}x{N} {fmt}-{mode}: {n_bad} "
                         "mismatches on exact-sum inputs")
        # (b) N(0, 1) inputs: at most 1e-4 of the outputs differ.  A
        # qmatmul output differs by one grid step; in the fused kernel a
        # flip of a rounded branch (one step of g or u) propagates through
        # silu(g) * u, so the hidden may move by several act-grid steps
        a = torch.randn((M, K), generator=gen, device=dev)
        n_copies = max(2, math.ceil(2 * L2_BYTES / (nw * K * N * 2)))
        if (M, K, N) == RAGGED:
            n_copies = 1
        wsets = [[(torch.randn((K, N), generator=gen, device=dev)
                   / math.sqrt(K)).to(torch.bfloat16) for _ in range(nw)]
                 for _ in range(n_copies)]
        got = run_kernel(a, wsets[0])
        ref = run_plain(a, wsets[0])
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
                        iters=5)
        w32 = [[w.float() for w in ws_] for ws_ in wsets]
        gemm = time_ms(torch, lambda i: [a @ w for w in w32[i]], n_copies)
        bms, by = bound_ms(M, K, N, nw)
        row = dict(kernel=name, M=M, K=K, N=N, per_decode_step=per_step,
                   mismatches=n_bad, mismatch_share=share,
                   max_grid_steps=steps,
                   max_abs_err=max_err, ms=ms, plain_ms=plain,
                   gemm_only_ms=gemm, bound_ms=bms, bound_by=by)
        rows.append(row)
        print(f"  {name:18s} M={M:4d} K={K:5d} N={N:6d}  kernel "
              f"{ms:8.4f} ms  bound {bms:8.4f} ms ({by})  plain "
              f"{plain:8.3f} ms  gemm-only(torch.matmul fp32) {gemm:8.4f} ms"
              f"  flips {n_bad}/{ref.numel()} (max {steps:g} steps)", flush=True)
    return rows


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
    """The whole path on the card vs the plain twins on the CPU."""
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(HERE / "src"))
    try:
        from repro_torch.kernels import build, qmatmul as tq
        from repro_torch.launch import serve
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

    print("== phase 3: kernels vs plain twins", flush=True)
    rows = kernel_phase(torch, tq)

    print("== phase 4: serve tinyllama-1.1b binary8-paper", flush=True)
    served = serve_phase(torch, tq, serve)

    print("== phase 5: path agreement card vs cpu", flush=True)
    agree = agreement_phase(torch, serve)

    kernels = []
    replaces = {"qmatmul_sr": "src/repro/kernels/qmatmul.py:360",
                "qmatmul_swiglu_sr": "src/repro/kernels/qmatmul.py:846"}
    for name in ("qmatmul_sr", "qmatmul_swiglu_sr"):
        path_rows = [r for r in rows if r["kernel"] == name and r["M"] == 4
                     and r["per_decode_step"]]
        all_rows = [r for r in rows if r["kernel"] == name]

        def per_step(key, rs=path_rows):
            return sum(r[key] * r["per_decode_step"] for r in rs)

        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces[name], launches=served["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in all_rows),
            mismatch_share=max(r["mismatch_share"] for r in all_rows),
            ms=per_step("ms"), plain_ms=per_step("plain_ms"),
            bound_ms=per_step("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes"
                                    for r in path_rows) else "operations",
            library_ms=None, gemm_only_ms=per_step("gemm_only_ms"),
            timed="sum over one batch-4 decode step's launches"))
    report = dict(device=kind, nvidia_smi=smi[0], build_s=t_build,
                  rows=rows, serve=served, agreement=agree,
                  kernels=kernels)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
