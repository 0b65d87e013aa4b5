#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line):

1. print the card (nvidia-smi name and power limit) and build the nine
   CUDA sources from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a, one nvcc per source, started together, and print ptxas'
   registers and spill bytes for every kernel;
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time kernel, plain version and, where one
   exists, the library call (median of per-call CUDA-event times, after a
   clock warm-up):
   - the cohort gather, bitwise, on the FEMNIST paper-scale federation
     (with n=0, n=max_n and clamped lanes); library ``flat_x[idx]``;
   - MCLR local SGD within rtol = atol = 2e-5 at K=10, max_n=400, d=784,
     C=26, B=10, max_iters=960 (prox_mu 0 and 0.1) and at the synthetic
     set's shape (d=60, C=10, max_n=2000);
   - dense MLP local SGD (H=64) within rtol 5e-4, atol 5e-5 at the same
     two shapes, budgets random with two zero lanes and one full lane;
   - the top-k + int8 compressor, bitwise, at K=10 with P = 51,930 (the
     MLP) and 20,410 (MCLR), planted threshold ties, a zero row, k=0,
     k=P; library ``torch.topk`` of |ef| (timing only: its tie rule
     differs);
   - flash-attention forward (out and lse) at Llama-3.2-3B's full width
     (24 q / 8 kv heads, hd=128, bf16, causal) at B=1 and at the serving
     path's B=4, both S=2048, plus a window, a non-causal, a ragged
     S=1000 and a float32 case: 2e-2 in bf16, 2e-5 in float32; every bf16
     call must take the tensor-core route and the float32 one must not
     (the wrapper's ``tensor_core_launches``), and the bf16 error against
     the rounding model ``ref.attention_lse_tc`` is printed; library
     ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
     (timing only); bound: its causal bf16 flop at 989 TFLOP/s or its
     bytes, whichever is larger;
   - the selective scan at Falcon-Mamba-7B's width (d=8192, N=16) for
     B=4 at S=512, at the serving path's S=1024 and at decode's S=1,
     within 1e-4; no library call computes it; bound: its bytes;
   - flash-attention backward (dq, dk, dv) at Llama-3.2-3B's training
     shape (B=1, S=2048, 24/8 heads, hd=128, bf16 causal), plus a window
     of 512, a non-causal, a ragged S=1000 and a float32 case: 2e-2 in
     bf16, atol 2e-5 / rtol 2e-4 in float32; routes checked and the
     rounding model ``ref.flash_attention_bwd_tc`` printed as for the
     forward; library: the backward of
     ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``;
     bound: FlashAttention-2's five products per unmasked pair in bf16;
   - the fused cross-entropy forward (loss and lse) at Llama's loss chunk
     (T=1,024, d=3,072, V=128,256, bf16: the tensor-core route), a ragged
     vocabulary (V=50,257, bf16) and float32 (both the CUDA-core route),
     within 1e-4; library ``logsumexp(h.float() @ W.float()) - gold``;
     bound: 2 T d V flop in bf16; then its backward kernels at the chunk
     (dh, dW) against the plain recompute (``ref.softmax_xent`` under
     autograd on the same bf16 leaves) within rtol 2^-7 and atol 2^-9
     max|want| per leaf, the rounding model ``ref.softmax_xent_bwd_tc``
     printed; no one library call computes it; bound: the three products'
     3 x 2 T d V flop in bf16;
3. check the port end to end on small federations: the same server on
   the card and on the CPU, with the same init and minibatch draws, picks
   the same cohorts and workloads; MCLR ends within 2e-5, the MLP with
   top-k + int8 compression within 2/test_n of final accuracy; serve
   both LM smoke configs in float32 on the card and on the CPU from the
   same params: the same greedy tokens, logits within 1e-4; and train
   them there: ``train_loss`` and every gradient leaf within 1e-4, and one
   ``SiloFedSAE`` round with the same L, H and step budgets and losses
   and global params within 1e-4;
4. the main paths, each with every kernel's launch count set to 0 just
   before and read just after: ``FedSAEServer`` on FEMNIST at paper scale
   (200 clients, K=10, algo="ira"), MCLR for 5 rounds with sampling="iid"
   then 2 with sampling="shuffle"; and the MLP (d=784, H=64, C=26) with
   sampling="iid" and upload_compress="topk_q8" (topk_frac 0.1) for 5
   rounds, whose gather, dense-SGD and compress launches must each be 5
   and whose last round must keep ``transmitted + residual' == delta +
   residual`` bitwise; losses, params and residual must be finite; then
   ``repro_torch.launch.serve.generate`` at full width with random
   weights, one model after the other: Llama-3.2-3B (batch 4, prompt
   2048, 32 greedy tokens; 28 flash launches, one per layer of the
   prefill, all 28 on the tensor cores) and Falcon-Mamba-7B (batch 4,
   prompt 1024, 32 tokens; 64 scan launches for the prefill and for each
   decode step), with finite logits, prefill ms and decode tokens/s;
   then this slice's path,
   cross-silo FedSAE training Llama-3.2-3B at full width and depth
   (``SiloFedSAE``, K=2 silos, max_steps=4, B=1, S=2048, lr 5e-3) for 2
   rounds, with finite losses, L <= H and per local step 56 flash-forward
   calls (28 layers, each recomputed under remat), 28 flash-backward calls
   and 2 fused cross-entropy forward and 2 backward calls (one per
   1,024-position chunk), every flash and cross-entropy call on the tensor
   cores and no plain cross-entropy recompute, round wall, ms per step and
   peak memory; and ``repro_torch.launch.train --arch llama3.2-3b --smoke
   --steps 5`` (2, 2, 1 and 1 calls per step, all on the tensor cores);
5. profile one steady round of each FL path, one prefill plus four
   decode steps of each LM, and one full-width silo step (torch.profiler):
   host wall, device time and the kernels that take it.

It then prints one JSON line with every kernel's launches (the flash and
cross-entropy kernels' tensor-core launches too), error, times and
roofline bound, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repo's ``src/`` beside it, it exits non-zero and prints no result.  It
needs one card with ~70 GB free (the full-width silo round holds the
global params, the two silos' params and one silo's gradients, 14.4 GB
each in float32).
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-5                 # the reference's local-SGD kernel-vs-XLA bound
DENSE_RTOL, DENSE_ATOL = 5e-4, 5e-5   # its MLP pallas-vs-xla bound
LM_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # flash vs plain, by dtype
SCAN_TOL = 1e-4            # the reference's selective-scan kernel bound
SERVE_TOL = 1e-4           # float32 logits, card vs CPU
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-4)}  # atol, rtol
XENT_TOL = 1e-4            # the reference's fused-xent bound
# the bf16 backward kernels against the plain recompute, per leaf: rtol one
# bf16 ulp, atol 2^-9 of the leaf's largest magnitude
XENT_BWD_RTOL, XENT_BWD_ATOL = 2.0 ** -7, 2.0 ** -9
TRAIN_TOL = 1e-4           # float32 losses, grads and silo params, card/CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(sym: str) -> str:
    """A kernel's name (and its first int or bool template argument) from its
    mangled symbol: the last <length><identifier> of the _ZN...
    nested name."""
    i, name = sym.find("_ZN") + 3, sym[:48]
    if i < 3:
        m = re.match(r"_Z(\d+)", sym)      # a function at namespace scope
        return sym[m.end():m.end() + int(m.group(1))] if m else name
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
    t = re.match(r"I\w*?L[ib](\d+)E", sym[i:])
    return f"{name}<{t.group(1)}>" if t else name


def ptxas_report(log: str):
    """[(kernel, registers, spill bytes stored + loaded)] from ptxas' -v
    report, one per compiled entry function (the kernel's name is cut
    from its mangled symbol)."""
    rows, entry, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = kernel_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1)), spill))
    return rows


def spin(torch, seconds: float = 1.0) -> None:
    """Keep the card busy for ``seconds`` so that its clocks have ramped
    up before anything is timed."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def time_ms(torch, fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls, from CUDA events
    around each call; ``flush`` (a large tensor) is overwritten between
    calls, outside the timed region, so each call finds the L2 cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def reset_counts(counted) -> None:
    """Set every wrapper's launch count (and the flash wrappers' tensor-core
    count) to 0."""
    for fn in counted.values():
        fn.launches = 0
        if hasattr(fn, "tensor_core_launches"):
            fn.tensor_core_launches = 0


def tensor_core_counts(counted) -> dict:
    return {k: fn.tensor_core_launches for k, fn in counted.items()
            if hasattr(fn, "tensor_core_launches")}


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(torch, fa, ref, gen, dev):
    """Phase 2: flash attention against its plain version at Llama-3.2-3B's
    widths, then times at the serving path's shape.  Returns the kernel's
    JSON fields (launches filled in later)."""
    import torch.nn.functional as F
    Hq, Hkv, hd = 24, 8, 128
    cases = [  # (label, B, S, causal, window, dtype)
        ("llama B=1 S=2048 causal bf16", 1, 2048, True, 0, torch.bfloat16),
        ("llama B=4 S=2048 causal bf16", 4, 2048, True, 0, torch.bfloat16),
        ("window 512", 1, 2048, True, 512, torch.bfloat16),
        ("non-causal", 1, 2048, False, 0, torch.bfloat16),
        ("ragged S=1000", 2, 1000, True, 0, torch.bfloat16),
        ("float32", 1, 1024, True, 0, torch.float32),
    ]
    err = model_err = 0.0
    for label, B, S, causal, window, dtype in cases:
        q = torch.randn((B, S, Hq, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        tc_before = fa.tensor_core_launches
        out, lse = fa(q, k, v, causal, window)
        want, want_lse = ref.attention_lse(q, k, v, causal=causal,
                                           window=window)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        if fa.tensor_core_launches != tc_before + bf16:
            raise RuntimeError(f"flash forward took the wrong route "
                               f"({label})")
        tol = LM_TOL[str(dtype).split(".")[-1]]
        e_out = float((out.float() - want.float()).abs().max())
        e_lse = float((lse - want_lse).abs().max())
        e_model = "-"
        if bf16:
            model = ref.attention_lse_tc(q, k, v, causal=causal,
                                         window=window)[0]
            e_model = float((out.float() - model.float()).abs().max())
            model_err = max(model_err, e_model)
            e_model = f"{e_model:.3e}"
        print(f"flash_attention_fwd {label} q={tuple(q.shape)} "
              f"{str(dtype).split('.')[-1]}: out max_abs_err {e_out:.3e} "
              f"(tol {tol}), lse {e_lse:.3e} (tol 2e-5 rel); rounding "
              f"model {e_model}", flush=True)
        if not (torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
                and torch.allclose(lse, want_lse, rtol=2e-5, atol=2e-5)):
            raise RuntimeError(f"flash kernel differs from plain ({label})")
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"flash kernel: non-finite ({label})")
        err = max(err, e_out)
        if label.startswith("llama B=4"):
            main = (q, k, v)
    q, k, v = main
    B, S = q.shape[:2]
    qt, kt, vt = (t.transpose(1, 2) for t in main)
    spin(torch)
    ms = time_ms(torch, lambda: fa(q, k, v, True, 0), 20)
    plain = time_ms(torch, lambda: ref.attention_lse(q, k, v, causal=True),
                    3)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    pairs = B * Hq * S * (S + 1) // 2          # unmasked (q, k) pairs
    flops = 4 * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * Hq * S
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    print(f"flash_attention_fwd B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} bf16 "
          f"causal (tensor cores): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, sdpa "
          f"{lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), bound "
          f"{b_ms:.4f} ms ({b_by}: {flops} flop, {nbytes} B); rounding "
          f"model max_abs_err {model_err:.3e}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "rounding_model_max_abs_err": model_err}


def check_scan(torch, ss, ref, gen, dev):
    """Phase 2: the selective scan against its plain version at
    Falcon-Mamba-7B's width, then times at the serving path's shape."""
    B, d, N = 4, 8192, 16
    err = 0.0
    for S in (512, 1024, 1):
        dt = torch.rand((B, S, d), generator=gen, device=dev) * 0.1 + 1e-3
        A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
            d, N).contiguous()
        Bm = torch.randn((B, S, N), generator=gen, device=dev)
        Cm = torch.randn((B, S, N), generator=gen, device=dev)
        x = torch.randn((B, S, d), generator=gen, device=dev)
        h0 = torch.randn((B, d, N), generator=gen, device=dev)
        args = (dt, A, Bm, Cm, x, h0)
        y, hT = ss(*args)
        wy, wh = ref.selective_scan(*args)
        torch.cuda.synchronize()
        e = max(float((y - wy).abs().max()), float((hT - wh).abs().max()))
        print(f"selective_scan_fwd B={B} S={S} d={d} N={N}: max_abs_err "
              f"{e:.3e} (tol {SCAN_TOL})", flush=True)
        if not (torch.allclose(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
                and torch.allclose(hT, wh, rtol=SCAN_TOL, atol=SCAN_TOL)):
            raise RuntimeError(f"scan kernel differs from plain (S={S})")
        if not (torch.isfinite(y).all() and torch.isfinite(hT).all()):
            raise RuntimeError(f"scan kernel: non-finite (S={S})")
        err = max(err, e)
        if S == 1024:
            main = args
    S = main[0].shape[1]
    spin(torch)
    ms = time_ms(torch, lambda: ss(*main), 20)
    plain = time_ms(torch, lambda: ref.selective_scan(*main), 3)
    nbytes = 4 * (3 * B * S * d + 2 * B * S * N + d * N + 2 * B * d * N)
    flops = 6 * B * S * d * N        # dt*A, h update (3), y fma (2); + exp
    b_ms, b_by = bound(nbytes, flops)
    print(f"selective_scan_fwd B={B} S={S} d={d} N={N}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
          f"{flops} flop and {B * S * d * N} exp)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_flash_bwd(torch, fa, ref, gen, dev):
    """Phase 2: the flash-attention backward against its plain version at
    Llama-3.2-3B's training shape, then times."""
    import torch.nn.functional as F
    Hq, Hkv, hd = 24, 8, 128
    cases = [  # (label, B, S, causal, window, dtype)
        ("llama B=1 S=2048 causal bf16", 1, 2048, True, 0, torch.bfloat16),
        ("window 512", 1, 2048, True, 512, torch.bfloat16),
        ("non-causal", 1, 2048, False, 0, torch.bfloat16),
        ("ragged S=1000", 1, 1000, True, 0, torch.bfloat16),
        ("float32", 1, 1024, True, 0, torch.float32),
    ]
    err = model_err = 0.0
    for label, B, S, causal, window, dtype in cases:
        q, k, v, do = (torch.randn((B, S, H, hd), generator=gen,
                                   device=dev).to(dtype)
                       for H in (Hq, Hkv, Hkv, Hq))
        out, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
        tc_before = fa.tensor_core_launches
        got = fa(q, k, v, out, lse, do, causal, window)
        want = ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        if fa.tensor_core_launches != tc_before + bf16:
            raise RuntimeError(f"flash backward took the wrong route "
                               f"({label})")
        name = str(dtype).split(".")[-1]
        atol, rtol = BWD_TOL[name]
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)]
        e_model = "-"
        if bf16:
            model = ref.flash_attention_bwd_tc(q, k, v, out, lse, do,
                                               causal=causal, window=window)
            e_model = [float((g.float() - m.float()).abs().max())
                       for g, m in zip(got, model)]
            model_err = max(model_err, *e_model)
        print(f"flash_attention_bwd {label} q={tuple(q.shape)} {name}: "
              f"dq/dk/dv max_abs_err {errs} (atol {atol}, rtol {rtol}); "
              f"rounding model {e_model}", flush=True)
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"flash bwd kernel: non-finite ({label})")
            if not torch.allclose(g.float(), w.float(), rtol=rtol,
                                  atol=atol):
                raise RuntimeError(f"flash bwd kernel differs from plain "
                                   f"({label})")
        err = max(err, *errs)
        if label.startswith("llama"):
            main = (q, k, v, out.contiguous(), lse, do)
    q, k, v, out, lse, do = main
    B, S = q.shape[:2]
    spin(torch)
    ms = time_ms(torch, lambda: fa(q, k, v, out, lse, do, True, 0), 20)
    plain = time_ms(torch, lambda: ref.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True), 3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), 20)
    pairs = B * Hq * S * (S + 1) // 2
    flops = 10 * hd * pairs            # s, dp, dv, dk, dq: 2 hd flop each
    # reads q, out, do, k, v and lse; writes dq, dk, dv
    nbytes = 2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) \
        + 4 * B * Hq * S
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    print(f"flash_attention_bwd B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} bf16 "
          f"causal (tensor cores): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, sdpa "
          f"backward {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), bound "
          f"{b_ms:.4f} ms ({b_by}: {flops} flop, {nbytes} B); rounding "
          f"model max_abs_err {model_err:.3e}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "rounding_model_max_abs_err": model_err}


def check_xent(torch, fx, fx_lse, bx, ops, ref, gen, dev):
    """Phase 2: the fused cross-entropy forward against its plain version
    at Llama-3.2-3B's loss chunk (tensor cores), a ragged vocabulary and
    float32 (CUDA cores), then its backward kernels at the chunk against the
    plain recompute; then times.  Returns the forward's and the backward's
    JSON fields (launches filled in later)."""
    cases = [  # (label, T, d, V, dtype, tensor cores)
        ("llama chunk bf16", 1024, 3072, 128256, torch.bfloat16, True),
        ("ragged V=50257 bf16", 256, 3072, 50257, torch.bfloat16, False),
        ("float32", 300, 256, 5000, torch.float32, False),
    ]
    err = 0.0
    for label, T, d, V, dtype, tc in cases:
        h = torch.randn((T, d), generator=gen, device=dev).to(dtype)
        W = (torch.randn((d, V), generator=gen, device=dev)
             * d ** -0.5).to(dtype)
        labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                               dtype=torch.int32)
        tc_before = fx.tensor_core_launches
        got, lse = fx_lse(h, W, labels)
        want, want_lse = ref.softmax_xent_lse(h, W, labels)
        torch.cuda.synchronize()
        if fx.tensor_core_launches != tc_before + tc:
            raise RuntimeError(f"xent forward took the wrong route ({label})")
        e = float((got - want).abs().max())
        e_lse = float((lse - want_lse).abs().max())
        print(f"fused_softmax_xent_fwd {label} T={T} d={d} V={V} "
              f"({'tensor' if tc else 'CUDA'} cores): max_abs_err {e:.3e}, "
              f"lse {e_lse:.3e} (tol {XENT_TOL})", flush=True)
        if not (torch.isfinite(got).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"xent kernel: non-finite ({label})")
        if not (torch.allclose(got, want, rtol=XENT_TOL, atol=XENT_TOL)
                and torch.allclose(lse, want_lse, rtol=XENT_TOL,
                                   atol=XENT_TOL)):
            raise RuntimeError(f"xent kernel differs from plain ({label})")
        err = max(err, e)
        if label.startswith("llama"):
            main = (h, W, labels, lse)
        del h, W
    h, W, labels, lse = main
    (T, d), V = h.shape, W.shape[1]
    # the backward at the chunk: a loss cotangent like the training step's
    # (mask / count) with some spread
    g = (torch.rand((T,), generator=gen, device=dev) + 0.5) / 2048
    tc_before = bx.tensor_core_launches
    dh, dW = bx(h, W, labels, lse, g)
    want = ops._recompute_vjp(ref.softmax_xent, (h, W, labels), (g,))[:2]
    torch.cuda.synchronize()
    if bx.tensor_core_launches != tc_before + 1:
        raise RuntimeError("xent backward did not take the tensor cores")
    b_err = []
    for name, got_g, want_g in (("dh", dh, want[0]), ("dW", dW, want[1])):
        if got_g.dtype != torch.bfloat16 or not torch.isfinite(got_g).all():
            raise RuntimeError(f"xent backward: {name} {got_g.dtype}, or "
                               f"non-finite")
        scale = float(want_g.float().abs().max())
        e = float((got_g.float() - want_g.float()).abs().max())
        ok = torch.allclose(got_g.float(), want_g.float(),
                            rtol=XENT_BWD_RTOL, atol=XENT_BWD_ATOL * scale)
        print(f"fused_softmax_xent_bwd llama chunk {name}: max_abs_err "
              f"{e:.3e} (max|want| {scale:.3e}; rtol 2^-7, atol 2^-9 "
              f"max|want|)", flush=True)
        if not ok:
            raise RuntimeError(f"xent backward differs from the plain "
                               f"recompute ({name})")
        b_err.append(e)
    del want
    model = ref.softmax_xent_bwd_tc(h, W, labels, lse, g)
    m_err = [float((a.float() - b.float()).abs().max())
             for a, b in zip((dh, dW), model)]
    print(f"fused_softmax_xent_bwd llama chunk: rounding model "
          f"(ref.softmax_xent_bwd_tc) dh/dW max_abs_err {m_err}", flush=True)
    del model, dh, dW
    torch.cuda.empty_cache()

    def library():
        logits = h.float() @ W.float()
        return (torch.logsumexp(logits, -1)
                - logits.gather(1, labels.long()[:, None])[:, 0])

    spin(torch)
    ms = time_ms(torch, lambda: fx(h, W, labels), 10)
    plain = time_ms(torch, lambda: ref.softmax_xent(h, W, labels), 5)
    lib = time_ms(torch, library, 5)
    b_ms = time_ms(torch, lambda: bx(h, W, labels, lse, g), 10)
    b_plain = time_ms(torch, lambda: ops._recompute_vjp(
        ref.softmax_xent, (h, W, labels), (g,)), 3)
    parts = ("xent_dlogits_tc", "xent_grad_gemm_tc_kernel<true>",
             "xent_grad_gemm_tc_kernel<false>")
    split_ms = profiled(torch, lambda: bx(h, W, labels, lse, g), parts)[3]
    flops = 2 * T * d * V
    nbytes = 2 * (h.numel() + W.numel()) + 4 * T + 4 * T
    f_bound, f_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    # backward: the logits, dh and dW products; reads h, W, labels, lse and
    # g, writes dh and dW
    b_flops = 3 * flops
    b_bytes = 4 * (h.numel() + W.numel()) + 12 * T
    b_bound, b_by = bound(b_bytes, b_flops, BF16_FLOPS_PER_S)
    print(f"fused_softmax_xent_fwd T={T} d={d} V={V} bf16 (tensor cores): "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain:.4f} ms, logsumexp(h.float() @ W.float()) - gold "
          f"{lib:.4f} ms, bound {f_bound:.4f} ms ({f_by}: {flops} flop, "
          f"{nbytes} B)", flush=True)
    print(f"fused_softmax_xent_bwd T={T} d={d} V={V} bf16 (tensor cores): "
          f"kernels {b_ms:.4f} ms ({b_flops / b_ms / 1e9:.1f} TFLOP/s of "
          f"useful work), plain recompute {b_plain:.4f} ms, bound "
          f"{b_bound:.4f} ms ({b_by}: {b_flops} flop, {b_bytes} B); one "
          f"call profiled: dlogits {split_ms[0]:.4f} ms, dh "
          f"{split_ms[1]:.4f} ms, dW {split_ms[2]:.4f} ms", flush=True)
    return ({"max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": f_bound, "bound_by": f_by, "library_ms": lib},
            {"max_abs_err": max(b_err), "ms": b_ms, "plain_ms": b_plain,
             "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
             "rounding_model_max_abs_err": max(m_err),
             "profiled_ms": dict(zip(("dlogits", "dh", "dW"), split_ms))})


def silo_batches(torch, cfg, K, max_steps, B, S, ri, device):
    """One round's batches as ``launch.fl_train.run_silo`` makes them:
    its token stream, labels = the tokens."""
    from repro_torch.launch.fl_train import silo_tokens
    toks = torch.as_tensor(silo_tokens(ri, cfg, K, max_steps, B, S),
                           device=device)
    return {"tokens": toks, "labels": toks}


def train_card_vs_cpu(torch, np, get_config, build_model, arch):
    """Phase 3: a smoke config trained in float32 on the card and on the
    CPU from the same params: train_loss and every gradient leaf, then one
    SiloFedSAE round each."""
    from repro_torch.convert import params_from_reference, params_to_numpy
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    model = build_model(cfg)
    init = params_to_numpy(model.init(torch.Generator("cpu").manual_seed(0)))
    ri = np.random.default_rng(3)
    toks = ri.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    runs = []
    for where in ("cuda", "cpu"):
        params = params_from_reference(init, where)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        t = torch.as_tensor(toks, device=where)
        loss, _ = model.train_loss(params, {"tokens": t, "labels": t})
        grads = torch.autograd.grad(loss, leaves)
        runs.append((float(loss.detach()), [g.cpu() for g in grads]))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    if abs(l_card - l_cpu) > TRAIN_TOL * (1 + abs(l_cpu)) or not all(
            torch.allclose(a, b, rtol=TRAIN_TOL, atol=TRAIN_TOL)
            for a, b in zip(g_card, g_cpu)):
        raise RuntimeError(f"{arch} smoke: card and CPU train_loss {l_card} "
                           f"vs {l_cpu}, grads differ by {g_err}")
    feds = []
    for where in ("cuda", "cpu"):
        fed = SiloFedSAE(model, 2, lr=5e-3, max_steps=3, init_params=init,
                         device=where)
        fed.run_round(silo_batches(torch, cfg, 2, 3, 2, 32,
                                   np.random.default_rng(4), where),
                      np.array([300, 700]))
        feds.append(fed)
    on_card, on_cpu = feds
    if not (np.array_equal(on_card.L, on_cpu.L)
            and np.array_equal(on_card.H, on_cpu.H)
            and np.array_equal(on_card.last_n_steps, on_cpu.last_n_steps)):
        raise RuntimeError(f"{arch} silo: card and CPU budgets differ")
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(on_card.params), tree_leaves(on_cpu.params)))
    loss_err = abs(on_card.stats["loss"][-1] - on_cpu.stats["loss"][-1])
    if p_err > TRAIN_TOL or loss_err > TRAIN_TOL:
        raise RuntimeError(f"{arch} silo: card and CPU params differ by "
                           f"{p_err}, losses by {loss_err}")
    print(f"train {arch} smoke float32, card vs CPU: train_loss {l_card:.6f} "
          f"vs {l_cpu:.6f}, grads max_abs_err {g_err:.3e}; one SiloFedSAE "
          f"round (budgets {on_card.last_n_steps.tolist()}): same L/H, "
          f"params max_abs_err {p_err:.3e}, loss diff {loss_err:.3e} (tol "
          f"{TRAIN_TOL})", flush=True)


def silo_path(torch, np, get_config, build_model, counted, ref, rounds=2):
    """Phase 4 (and 5): cross-silo FedSAE training Llama-3.2-3B at full
    width and depth, K=2 silos, B=1, S=2048.  Every kernel's count is set
    to 0 just before the counted rounds and read just after; each local
    step must launch 56 flash forwards (28 layers, each recomputed under
    remat), 28 flash backwards and 2 cross-entropy chunks forward and
    backward, every flash and cross-entropy call on the tensor cores, and
    the plain ``ref.softmax_xent`` recompute must not run."""
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("llama3.2-3b")
    model = build_model(cfg)
    K, max_steps, B, S = 2, 4, 1, 2048
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = SiloFedSAE(model, K, lr=5e-3, max_steps=max_steps, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(fed.params))
    ri = np.random.default_rng(0)
    sizes = np.asarray(ri.integers(100, 1000, K))
    all_batches = [silo_batches(torch, cfg, K, max_steps, B, S, ri, "cuda")
                   for _ in range(rounds)]
    plain_xent, recomputes = ref.softmax_xent, []

    def counted_plain_xent(*a):
        recomputes.append(1)
        return plain_xent(*a)

    ref.softmax_xent = counted_plain_xent
    reset_counts(counted)
    rounds_out = []
    try:
        for r in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = fed.run_round(all_batches[r], sizes)
            torch.cuda.synchronize()
            rounds_out.append(dict(wall_s=time.perf_counter() - t0,
                                   n_steps=fed.last_n_steps.tolist(),
                                   loss=stats["loss"][-1],
                                   L=fed.L.tolist(), H=fed.H.tolist()))
    finally:
        ref.softmax_xent = plain_xent
    launches = {k: fn.launches for k, fn in counted.items()}
    tc_launches = tensor_core_counts(counted)
    steps = sum(sum(r["n_steps"]) for r in rounds_out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if steps <= 0:
        raise RuntimeError("the silo rounds ran no local step")
    if not np.isfinite(stats["loss"]).all() or not (fed.L <= fed.H).all():
        raise RuntimeError(f"silo rounds: losses {stats['loss']}, L {fed.L},"
                           f" H {fed.H}")
    for t in tree_leaves(fed.params):
        if not torch.isfinite(t).all():
            raise RuntimeError("silo rounds: non-finite global params")
    want = {"flash_attention_fwd": 56 * steps,
            "flash_attention_bwd": 28 * steps,
            "fused_softmax_xent_fwd": 2 * steps,
            "fused_softmax_xent_bwd": 2 * steps}
    if {k: launches[k] for k in want} != want or any(
            launches[k] for k in launches if k not in want):
        raise RuntimeError(f"silo path launched {launches} in {steps} "
                           f"steps, wanted {want}")
    # every flash and cross-entropy call of the bf16 path on the tensor
    # cores, none on the float32 or CUDA-core routes, and no plain recompute
    want_tc = {k: want[k] for k in tc_launches}
    if tc_launches != want_tc or recomputes:
        raise RuntimeError(f"silo path: tensor-core launches {tc_launches}, "
                           f"wanted {want_tc}; {len(recomputes)} plain "
                           f"cross-entropy recomputes")
    walls = [r["wall_s"] for r in rounds_out]
    summary = dict(params=n_params, init_s=init_s, silos=K,
                   max_steps=max_steps, batch=B, seq=S, rounds=rounds_out,
                   local_steps=steps,
                   ms_per_local_step=sum(walls) / steps * 1e3,
                   peak_gib=peak, launches=launches,
                   tensor_core_launches=tc_launches)
    print(f"main path silo llama3.2-3b (full width, {n_params} params f32, "
          f"bf16 compute, remat): {rounds} rounds x {K} silos, B={B}, S={S}:"
          f" round wall {[round(w, 3) for w in walls]} s, {steps} local "
          f"steps ({summary['ms_per_local_step']:.1f} ms each, round "
          f"overhead included), losses "
          f"{[round(r['loss'], 4) for r in rounds_out]}, budgets "
          f"{[r['n_steps'] for r in rounds_out]}, peak {peak:.1f} GiB; "
          f"launches {json.dumps(launches)}, tensor-core "
          f"{json.dumps(tc_launches)}", flush=True)

    # phase 5: one local step alone, timed and profiled, outside the count
    row = tree_map(torch.clone, fed.params)
    one = tree_map(lambda b: b[0], all_batches[0])
    train_silo = fed.round_fn.train_silo
    train_silo(row, fed.params, one, 1)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_silo(row, fed.params, one, 1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    before = torch.cuda.memory_stats()
    wall, device, top, (flash, xent) = profiled(
        torch, lambda: train_silo(row, fed.params, one, 1),
        ("flash_", "xent_"))
    after = torch.cuda.memory_stats()
    summary["step_ms"] = step_ms
    summary["profile"] = dict(
        wall_ms=wall, device_ms=device, device_busy=device / wall,
        device_share_of_unprofiled_step=device / step_ms,
        flash_kernels_ms=flash, xent_kernels_ms=xent, top_kernels_ms=top,
        alloc_retries=after["num_alloc_retries"]
        - before["num_alloc_retries"],
        cuda_mallocs=after["num_device_alloc"] - before["num_device_alloc"])
    print(f"profile silo llama3.2-3b one local step (B=1, S=2048): step "
          f"{step_ms:.1f} ms unprofiled; {json.dumps(summary['profile'])}",
          flush=True)
    del row, fed
    return summary


def serve_card_vs_cpu(torch, get_config, build_model, serve, arch):
    """Phase 3: one smoke config served in float32 on the card and on the
    CPU from the same params (drawn on the CPU): same tokens, close
    logits."""
    from repro_torch.convert import params_from_reference, params_to_numpy
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    on_card = params_from_reference(params_to_numpy(params), "cuda")
    runs = []
    for p, where in ((on_card, "cuda"), (params, "cpu")):
        tokens = serve.prompt_tokens(cfg, 3, 40, where)
        runs.append(serve.generate(model, p, tokens, 6))
    (tok_card, lg_card, _), (tok_cpu, lg_cpu, _) = runs
    err = float((lg_card.cpu() - lg_cpu).abs().max())
    if not torch.equal(tok_card.cpu(), tok_cpu):
        raise RuntimeError(f"{arch} smoke: card and CPU generated different "
                           f"tokens:\n{tok_card.cpu()}\n{tok_cpu}")
    if not torch.allclose(lg_card.cpu(), lg_cpu, rtol=SERVE_TOL,
                          atol=SERVE_TOL):
        raise RuntimeError(f"{arch} smoke: card and CPU logits differ by "
                           f"{err}")
    print(f"serve {arch} smoke float32, batch 3, prompt 40, 6 tokens, card "
          f"vs CPU: same tokens {tok_cpu[0].tolist()}, last logits "
          f"max_abs_err {err:.3e} (tol {SERVE_TOL})", flush=True)


def profiled(torch, fn, part="flash_"):
    """(host wall ms, device ms, top kernels, part ms) of one call of
    ``fn`` under torch.profiler, ending in a device sync.  Device time sums
    the events that ran on the card (kernels, copies), each once: the CPU
    op that launched a kernel reports the same time again, so CPU events
    are left out.  Part ms sums the kernels whose name holds ``part`` (a
    string or a tuple of them; by default the flash-attention kernels:
    forward, backward and the backward's delta kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    device = sum(t for _, t in events) / 1e3
    top = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    parts = (part,) if isinstance(part, str) else part
    part_ms = [sum(t for k, t in events if p in k) / 1e3 for p in parts]
    return (wall, device, [(k[:60], t / 1e3) for k, t in top[:6]],
            part_ms[0] if isinstance(part, str) else part_ms)


def serve_path(torch, get_config, build_model, serve, arch, batch, prompt,
               gen, counted, want):
    """Phase 4 (and 5): ``serve.generate`` at full width with random
    weights.  Every kernel's count is set to 0 just before the counted run
    and read just after; ``want`` maps kernel name -> launches."""
    cfg = get_config(arch)
    model = build_model(cfg)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = serve.prompt_tokens(cfg, batch, prompt, dev)
    serve.generate(model, params, tokens[:, :64], 2)      # warm-up
    reset_counts(counted)
    out, logits, times = serve.generate(model, params, tokens, gen)
    launches = {k: fn.launches for k, fn in counted.items()}
    tc_launches = tensor_core_counts(counted)
    if tuple(out.shape) != (batch, gen + 1) or tuple(logits.shape) != (
            batch, cfg.vocab_size):
        raise RuntimeError(f"{arch}: generated {tuple(out.shape)}, logits "
                           f"{tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{arch}: non-finite logits")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError(f"{arch}: token ids out of range")
    got = {k: launches[k] for k in want}
    if got != want or any(launches[k] for k in launches if k not in want):
        raise RuntimeError(f"{arch}: launched {launches}, wanted {want}")
    want_tc = {k: want.get(k, 0) for k in tc_launches}
    if tc_launches != want_tc:
        raise RuntimeError(f"{arch}: tensor-core flash launches "
                           f"{tc_launches}, wanted {want_tc}")
    summary = dict(
        params=n_params, init_s=init_s, batch=batch, prompt=prompt, gen=gen,
        prefill_ms=times["prefill_s"] * 1e3,
        prefill_tokens_per_s=batch * prompt / times["prefill_s"],
        decode_s=times["decode_s"],
        decode_tokens_per_s=batch * gen / times["decode_s"],
        decode_ms_per_step=times["decode_s"] / gen * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        sample=out[0, :8].tolist(), launches=launches,
        tensor_core_launches=tc_launches)
    print(f"main path serve {arch} (full width, {n_params} params f32, "
          f"{cfg.dtype} compute): batch {batch}, prompt {prompt}: prefill "
          f"{summary['prefill_ms']:.1f} ms "
          f"({summary['prefill_tokens_per_s']:.0f} tok/s), {gen} greedy "
          f"steps in {times['decode_s'] * 1e3:.1f} ms "
          f"({summary['decode_tokens_per_s']:.1f} tok/s, "
          f"{summary['decode_ms_per_step']:.2f} ms/step), peak "
          f"{summary['peak_gib']:.1f} GiB, logits finite, sample "
          f"{summary['sample']}; launches {json.dumps(launches)}",
          flush=True)

    with torch.inference_mode():
        state = {}

        def prefill():
            state["logits"], state["cache"] = model.prefill(
                params, {"tokens": tokens})

        def decode4():
            tok = torch.argmax(state["logits"], -1)[:, None].to(torch.int32)
            for i in range(4):
                lg, state["cache"] = model.decode_step(
                    params, state["cache"], tok, prompt + i)
                tok = torch.argmax(lg, -1)[:, None].to(torch.int32)

        prof = {}
        for label, fn in (("prefill", prefill), ("decode x4", decode4)):
            wall, device, top, flash = profiled(torch, fn)
            prof[label] = dict(wall_ms=wall, device_ms=device,
                               device_busy=device / wall,
                               flash_kernels_ms=flash, top_kernels_ms=top)
            print(f"profile {arch} {label}: {json.dumps(prof[label])}",
                  flush=True)
    summary["profile"] = prof
    return summary


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the port's package is not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.core import compression as comp
    from repro_torch.core.aggregation import _flatten_clients
    from repro_torch.core.engine import iid_indices
    from repro_torch.core.server import FedSAEServer, ServerConfig
    from repro_torch.data.federated import (make_femnist_like,
                                            make_synthetic)
    from repro_torch.device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, fed_compress, fed_gather,
                                     fed_local_sgd, fed_local_sgd_dense,
                                     flash_attention, fused_xent, ops,
                                     ref, selective_scan)
    from repro_torch.launch import serve, train
    from repro_torch.models.api import build_model

    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    dev = resolve_device("cuda")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {json.dumps(built)} wall {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in build.SIGNATURES:
        for entry, regs, spill in ptxas_report(build.build_log(name)):
            print(f"ptxas {name} {entry}: {regs} registers, {spill} bytes "
                  f"spilled")

    # -- 2. kernels against their plain versions --------------------------
    gather = fed_gather.fed_cohort_gather
    sgd = fed_local_sgd.fed_local_sgd_mclr
    femnist = make_femnist_like()
    max_n = int(femnist.sizes.max())
    pk = femnist.packed(max_n, device=dev)
    rng = np.random.default_rng(0)
    K = 10
    sizes = femnist.sizes
    ids = rng.choice(femnist.n_clients, K, replace=False)
    ids[1] = int(np.argmax(sizes))          # a full lane (n = max_n)
    ids[2] = femnist.n_clients - 1          # the last client: tail slack
    ids_t = torch.as_tensor(ids, device=dev)
    starts = pk.offsets[ids_t].contiguous()
    ns = torch.clamp(pk.lengths[ids_t], max=max_n)
    ns[0] = 0                               # an empty lane
    starts[3] = pk.x.shape[0] - 5           # past rows - max_n: clamped
    flat_x = pk.x.contiguous()
    feat = flat_x.shape[1]
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    got = gather(flat_x, pk.y, starts, ns, max_n)
    want = ref.fed_cohort_gather(flat_x, pk.y, starts, ns, max_n=max_n)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("x", "y", "mask")):
        if not torch.equal(g, w):
            raise RuntimeError(f"gather kernel differs from plain ({what})")
    assert int(got[2][0].sum()) == 0 and int(got[2][1].sum()) == max_n
    pos = torch.arange(max_n, device=dev)
    lib_idx = (torch.clamp(starts.long(), max=flat_x.shape[0] - max_n)[:, None]
               + pos[None, :])
    spin(torch)
    g_ms = time_ms(torch, lambda: gather(flat_x, pk.y, starts, ns, max_n),
                   50, flush)
    g_plain = time_ms(torch, lambda: ref.fed_cohort_gather(
        flat_x, pk.y, starts, ns, max_n=max_n), 50, flush)
    g_lib = time_ms(torch, lambda: flat_x[lib_idx], 50, flush)
    g_bytes = (2 * K * max_n * feat * 4 + 3 * K * max_n * 4 + 2 * K * 4)
    g_bound, g_by = bound(g_bytes, 0)
    print(f"fed_cohort_gather K={K} max_n={max_n} feat={feat}: bitwise "
          f"equal; kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, "
          f"flat_x[idx] {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}, "
          f"{g_bytes} B)", flush=True)

    x, y = got[0], got[1]
    B, C, max_iters, lr = 10, femnist.n_classes, 960, 0.03
    gen = torch.Generator(dev).manual_seed(0)
    n_iters = torch.as_tensor(rng.integers(1, max_iters, K), device=dev,
                              dtype=torch.int32)
    n_iters[0], n_iters[1], n_iters[4] = 0, max_iters, 0
    idx = iid_indices(gen, ns, max_iters, B)
    w0 = torch.randn((feat, C), generator=gen, device=dev) * 0.01
    b0 = torch.zeros(C, device=dev)

    synth = make_synthetic()
    s_max_n = int(synth.sizes.max())
    spk = synth.packed(s_max_n, device=dev)
    s_ids = torch.as_tensor(rng.choice(synth.n_clients, K, replace=False),
                            device=dev)
    s_ns = torch.clamp(spk.lengths[s_ids], max=s_max_n)
    sx, sy, _ = gather(spk.x, spk.y, spk.offsets[s_ids].contiguous(), s_ns,
                       s_max_n)
    s_w0 = torch.randn((sx.shape[2], synth.n_classes), generator=gen,
                       device=dev) * 0.01
    s_b0 = torch.zeros(synth.n_classes, device=dev)
    s_iters = torch.as_tensor(rng.integers(0, max_iters + 1, K), device=dev,
                              dtype=torch.int32)
    s_idx = iid_indices(gen, s_ns, max_iters, B)
    cases = [
        ("femnist prox_mu=0", (x, y, idx, w0, b0, ns, n_iters), lr, 0.0),
        ("femnist prox_mu=0.1", (x, y, idx, w0, b0, ns, n_iters), lr, 0.1),
        ("synthetic prox_mu=0", (sx, sy, s_idx, s_w0, s_b0, s_ns, s_iters),
         0.01, 0.0),
    ]
    sgd_err = 0.0
    for label, args, c_lr, mu in cases:
        got_s = sgd(*args, c_lr, mu)
        want_s = ref.fed_local_sgd_mclr(*args, lr=c_lr, prox_mu=mu)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got_s, want_s))
        ok = all(torch.allclose(g, w, rtol=TOL, atol=TOL)
                 for g, w in zip(got_s, want_s))
        for t in got_s:
            if not torch.isfinite(t).all():
                raise RuntimeError(f"local SGD kernel: non-finite ({label})")
        print(f"fed_local_sgd_mclr {label} x={tuple(args[0].shape)}: "
              f"max_abs_err {err:.3e} (tol {TOL})", flush=True)
        if not ok:
            raise RuntimeError(f"local SGD kernel differs from plain beyond "
                               f"{TOL} ({label})")
        sgd_err = max(sgd_err, err)
    s_args = cases[0][1]
    spin(torch)
    s_ms = time_ms(torch, lambda: sgd(*s_args, lr, 0.0), 10)
    s_plain = time_ms(torch, lambda: ref.fed_local_sgd_mclr(
        *s_args, lr=lr, prox_mu=0.0), 3)
    executed = int(torch.clamp(n_iters, 0, max_iters).sum())
    s_flops = executed * (4 * B * feat * C + 2 * feat * C + 8 * B * C)
    s_bytes = (x.numel() * 4 + y.numel() * 4 + idx.numel() * 4
               + (w0.numel() + b0.numel()) * 4 + 2 * K * 4
               + K * (feat * C + C + 1) * 4)
    s_bound, s_by = bound(s_bytes, s_flops)
    print(f"fed_local_sgd_mclr femnist: kernel {s_ms:.4f} ms, plain "
          f"{s_plain:.4f} ms, bound {s_bound:.4f} ms ({s_by}: {executed} "
          f"executed iterations, {s_flops} flop, {s_bytes} B)", flush=True)

    dense = fed_local_sgd_dense.fed_local_sgd_dense
    H = 64

    def mlp_init(d_in, n_cls):
        return (torch.randn((d_in, H), generator=gen, device=dev)
                * d_in ** -0.5, torch.zeros(H, device=dev),
                torch.randn((H, n_cls), generator=gen, device=dev)
                * H ** -0.5, torch.zeros(n_cls, device=dev))

    d_cases = [
        ("femnist prox_mu=0", (x, y, idx, *mlp_init(feat, C), ns, n_iters),
         lr, 0.0),
        ("femnist prox_mu=0.1", (x, y, idx, *mlp_init(feat, C), ns,
                                 n_iters), lr, 0.1),
        ("synthetic prox_mu=0", (sx, sy, s_idx,
                                 *mlp_init(sx.shape[2], synth.n_classes),
                                 s_ns, s_iters), 0.01, 0.0),
    ]
    dense_err = 0.0
    for label, args, c_lr, mu in d_cases:
        got_d = dense(*args, c_lr, mu)
        want_d = ref.fed_local_sgd_dense(*args, lr=c_lr, prox_mu=mu)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got_d, want_d))
        ok = all(torch.allclose(g, w, rtol=DENSE_RTOL, atol=DENSE_ATOL)
                 for g, w in zip(got_d, want_d))
        for t in got_d:
            if not torch.isfinite(t).all():
                raise RuntimeError(f"dense SGD kernel: non-finite ({label})")
        print(f"fed_local_sgd_dense {label} x={tuple(args[0].shape)} H={H}: "
              f"max_abs_err {err:.3e} (rtol {DENSE_RTOL}, atol "
              f"{DENSE_ATOL})", flush=True)
        if not ok:
            raise RuntimeError(f"dense SGD kernel differs from plain beyond "
                               f"rtol {DENSE_RTOL}, atol {DENSE_ATOL} "
                               f"({label})")
        dense_err = max(dense_err, err)
    d_args = d_cases[0][1]
    spin(torch)
    d_ms = time_ms(torch, lambda: dense(*d_args, lr, 0.0), 10)
    d_plain = time_ms(torch, lambda: ref.fed_local_sgd_dense(
        *d_args, lr=lr, prox_mu=0.0), 3)
    d_flops = executed * (4 * B * feat * H + 6 * B * H * C)
    d_params = feat * H + H + H * C + C
    d_bytes = (x.numel() * 4 + y.numel() * 4 + idx.numel() * 4
               + d_params * 4 + 2 * K * 4 + K * (d_params + 1) * 4)
    d_bound, d_by = bound(d_bytes, d_flops)
    print(f"fed_local_sgd_dense femnist: kernel {d_ms:.4f} ms, plain "
          f"{d_plain:.4f} ms, bound {d_bound:.4f} ms ({d_by}: {executed} "
          f"executed iterations, {d_flops} flop, {d_bytes} B)", flush=True)

    compress = fed_compress.fed_compress_topk_q8
    frac = 0.1
    for P in (d_params, feat * C + C):      # the MLP's P, then MCLR's
        ef = torch.randn((K, P), generator=gen, device=dev) * 1e-3
        tie = torch.randperm(P, generator=gen, device=dev)[:P // 5]
        ef[0, tie] = 2.5e-3                 # ties at the threshold
        ef[3, tie[:P // 20]] = -2.5e-3
        ef[1] = 0.0                         # a zero row
        ef[2, 7] = -1.0                     # |e| == amax on a negative
        k_main = comp.resolve_k(frac, P)
        for k_case in (k_main, 0, P, 1, P - 1):
            q, sc = compress(ef, k_case)
            wq, ws = ref.fed_compress_topk_q8(ef, k=k_case)
            torch.cuda.synchronize()
            if not (torch.equal(q, wq) and torch.equal(sc, ws)):
                raise RuntimeError(f"compress kernel differs from plain "
                                   f"(P={P}, k={k_case})")
            sent = (q != 0).sum(1)
            if k_case == k_main and int(sent[0]) != k_case:
                raise RuntimeError(f"compress kept {int(sent[0])} of the "
                                   f"tied row, not k={k_case}")
        print(f"fed_compress_topk_q8 K={K} P={P}: bitwise equal at k in "
              f"({k_main}, 0, P, 1, P-1), ties, a zero row", flush=True)
        if P == d_params:
            c_ef, c_k = ef, k_main
    spin(torch)
    c_ms = time_ms(torch, lambda: compress(c_ef, c_k), 50)
    c_plain = time_ms(torch, lambda: ref.fed_compress_topk_q8(c_ef, k=c_k),
                      50)
    c_lib = time_ms(torch, lambda: torch.topk(c_ef.abs(), c_k, dim=1), 50)
    c_bytes = K * d_params * (4 + 1) + 4 * K
    c_bound, c_by = bound(c_bytes, 0)
    print(f"fed_compress_topk_q8 K={K} P={d_params} k={c_k}: kernel "
          f"{c_ms:.4f} ms, plain {c_plain:.4f} ms, torch.topk(|ef|) "
          f"{c_lib:.4f} ms, bound {c_bound:.4f} ms ({c_by}, {c_bytes} B)",
          flush=True)

    fa = flash_attention.flash_attention_fwd
    ss = selective_scan.selective_scan_fwd
    fa_bwd = flash_attention.flash_attention_bwd
    fx = fused_xent.fused_softmax_xent_fwd
    fx_bwd = fused_xent.fused_softmax_xent_bwd
    flash_row = check_flash(torch, fa, ref, gen, dev)
    scan_row = check_scan(torch, ss, ref, gen, dev)
    bwd_row = check_flash_bwd(torch, fa_bwd, ref, gen, dev)
    xent_row, xent_bwd_row = check_xent(
        torch, fx, fused_xent.fused_softmax_xent_fwd_lse, fx_bwd, ops, ref,
        gen, dev)
    torch.cuda.empty_cache()

    # -- 3. end to end on a small federation: card vs CPU -----------------
    small = make_femnist_like(n_clients=30, total=900, dim=64, max_size=40)
    small_cfg = dict(rounds=3, n_selected=6, sampling="iid", batch_size=4,
                     h_cap=6.0, fixed_epochs=4.0)
    small_iters = math.ceil(6.0 * math.ceil(int(small.sizes.max()) / 4))
    init = {"w": (np.random.default_rng(1).normal(size=(64, 26)) * 0.01)
            .astype(np.float32), "b": np.zeros(26, np.float32)}

    def draws(t, ids_, n_):
        r = np.random.default_rng(100 + t)
        return (r.random((len(ids_), small_iters, 4))
                * np.maximum(n_, 1)[:, None, None]).astype(np.int32)

    runs = []
    for where in ("cuda", "cpu"):
        srv = FedSAEServer(small, cfg=ServerConfig(device=where, **small_cfg),
                           init_params=init, data_draws=draws)
        assert srv.max_iters == small_iters
        srv.run()
        runs.append(srv)
    on_card, on_cpu = runs
    for a, b in zip(on_card.cohorts, on_cpu.cohorts):
        if not np.array_equal(a, b):
            raise RuntimeError("card and CPU runs picked different cohorts")
    if not (np.array_equal(on_card.L, on_cpu.L)
            and np.array_equal(on_card.H, on_cpu.H)):
        raise RuntimeError("card and CPU runs predicted different workloads")
    e2e_err = max(float((on_card.params[k].cpu() - on_cpu.params[k])
                        .abs().max()) for k in init)
    if not all(torch.allclose(on_card.params[k].cpu(), on_cpu.params[k],
                              rtol=TOL, atol=TOL) for k in init):
        raise RuntimeError(f"card and CPU params differ by {e2e_err}")
    print(f"small federation, 3 iid rounds, card vs CPU: same cohorts and "
          f"workloads, params max_abs_err {e2e_err:.3e}", flush=True)

    r1 = np.random.default_rng(2)
    mlp0 = {"w1": (r1.normal(size=(64, H)) * 64 ** -0.5).astype(np.float32),
            "b1": np.zeros(H, np.float32),
            "w2": (r1.normal(size=(H, 26)) * H ** -0.5).astype(np.float32),
            "b2": np.zeros(26, np.float32)}
    runs = []
    for where in ("cuda", "cpu"):
        srv = FedSAEServer(small, cfg=ServerConfig(
            device=where, model="mlp", upload_compress="topk_q8",
            **small_cfg), init_params=mlp0, data_draws=draws)
        hist = srv.run()
        runs.append((srv, hist))
    (on_card, h_card), (on_cpu, h_cpu) = runs
    for a, b in zip(on_card.cohorts, on_cpu.cohorts):
        if not np.array_equal(a, b):
            raise RuntimeError("MLP + topk_q8: card and CPU runs picked "
                               "different cohorts")
    if not (np.array_equal(on_card.L, on_cpu.L)
            and np.array_equal(on_card.H, on_cpu.H)):
        raise RuntimeError("MLP + topk_q8: card and CPU runs predicted "
                           "different workloads")
    acc_gap = abs(h_card["acc"][-1] - h_cpu["acc"][-1])
    if acc_gap > 2.0 / len(small.test_y):
        raise RuntimeError(f"MLP + topk_q8: final accuracy differs by "
                           f"{acc_gap} (card {h_card['acc'][-1]}, CPU "
                           f"{h_cpu['acc'][-1]})")
    mlp_err = max(float((on_card.params[k].cpu() - on_cpu.params[k])
                        .abs().max()) for k in mlp0)
    print(f"small federation, MLP + topk_q8, 3 iid rounds, card vs CPU: "
          f"same cohorts and workloads, final acc {h_card['acc'][-1]:.4f} "
          f"vs {h_cpu['acc'][-1]:.4f} (limit {2.0 / len(small.test_y):.4f}),"
          f" params max_abs_err {mlp_err:.3e}", flush=True)

    for arch in ("llama3.2-3b", "falcon-mamba-7b"):
        serve_card_vs_cpu(torch, get_config, build_model, serve, arch)
        train_card_vs_cpu(torch, np, get_config, build_model, arch)

    # -- 4. the main paths ------------------------------------------------
    counted = {"fed_cohort_gather": gather, "fed_local_sgd_mclr": sgd,
               "fed_local_sgd_dense": dense,
               "fed_compress_topk_q8": compress,
               "flash_attention_fwd": fa, "selective_scan_fwd": ss,
               "flash_attention_bwd": fa_bwd, "fused_softmax_xent_fwd": fx,
               "fused_softmax_xent_bwd": fx_bwd}
    summary, path_launches = {}, {}

    def drive(label, rounds, **cfg):
        srv = FedSAEServer(femnist, cfg=ServerConfig(
            algo="ira", n_selected=10, rounds=rounds, **cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = np.asarray(hist["train_loss"], np.float64)
        if not np.isfinite(losses).all() or not np.isfinite(
                hist["test_loss"]).all():
            raise RuntimeError(f"non-finite losses ({label}): {hist}")
        for k, v in srv.params.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"non-finite global params {k} ({label})")
        if srv.residual is not None and not torch.isfinite(
                srv.residual).all():
            raise RuntimeError(f"non-finite residual ({label})")
        steady = (rounds - 1) / sum(srv.wall_times[1:])
        summary[label] = dict(rounds=rounds, wall_s=wall,
                              rounds_per_s=rounds / wall,
                              round0_s=srv.wall_times[0],
                              steady_rounds_per_s=steady,
                              round_wall_s=srv.wall_times,
                              acc=hist["acc"],
                              train_loss=hist["train_loss"])
        print(f"main path femnist paper scale, ira, {label}: {rounds} "
              f"rounds in {wall:.3f} s ({rounds / wall:.3f} rounds/s; "
              f"round 0 (warm-up) {srv.wall_times[0]:.4f} s, after it "
              f"{steady:.3f} rounds/s), round wall "
              f"{[round(w, 4) for w in srv.wall_times]} s, acc "
              f"{[round(a, 4) for a in hist['acc']]}, train_loss "
              f"{[round(a, 4) for a in hist['train_loss']]}", flush=True)
        return srv

    def run_path(name, legs):
        reset_counts(counted)
        for label, rounds, cfg in legs:
            drive(label, rounds, **cfg)
        path_launches[name] = {k: fn.launches for k, fn in counted.items()}
        print(f"path {name} launches: {json.dumps(path_launches[name])}",
              flush=True)

    run_path("mclr", [("iid", 5, dict(sampling="iid")),
                      ("shuffle", 2, dict(sampling="shuffle"))])

    # this slice's path; the upload stage of every round is captured, and
    # the last round's error-feedback identity is checked on the card
    stage = {}
    inner_stage = comp.apply_upload_compress

    def capture_stage(global_params, params_k, residual_rows, uploaded, k):
        out = inner_stage(global_params, params_k, residual_rows, uploaded,
                          k)
        stage.update(g=global_params, pk=params_k, res=residual_rows,
                     up=uploaded, k=k, out=out)
        return out

    comp.apply_upload_compress = capture_stage
    try:
        run_path("mlp_topk_q8", [("mlp iid topk_q8", 5, dict(
            sampling="iid", model="mlp", upload_compress="topk_q8",
            topk_frac=frac))])
    finally:
        comp.apply_upload_compress = inner_stage
    want = {"fed_cohort_gather": 5, "fed_local_sgd_mclr": 0,
            "fed_local_sgd_dense": 5, "fed_compress_topk_q8": 5,
            "flash_attention_fwd": 0, "selective_scan_fwd": 0,
            "flash_attention_bwd": 0, "fused_softmax_xent_fwd": 0,
            "fused_softmax_xent_bwd": 0}
    if path_launches["mlp_topk_q8"] != want:
        raise RuntimeError(f"MLP + topk_q8 path launched "
                           f"{path_launches['mlp_topk_q8']}, not {want}")
    ef = (_flatten_clients(stage["pk"]) - comp.flatten_global(stage["g"])
          [None, :]) + stage["res"]
    _, new_res, sent = stage["out"]
    up = stage["up"]
    if not (torch.equal((sent + new_res)[up], ef[up])
            and torch.equal(new_res[~up], stage["res"][~up])
            and not sent[~up].any()):
        raise RuntimeError("error-feedback identity broken on the card")
    n_sent = [int(v) for v in (sent != 0).sum(1)]
    if max(n_sent) > stage["k"]:
        raise RuntimeError(f"a client sent more than k={stage['k']} values")
    print(f"error-feedback identity on the card, last round: "
          f"transmitted + residual' == delta + residual bitwise on "
          f"{int(up.sum())} uploading rows (k={stage['k']}, values sent "
          f"{n_sent}); non-uploaders kept their residual", flush=True)
    # the LM serving paths, one model after the other (each frees its
    # weights on return)
    gen_steps = 32
    serving = {}
    serving["llama3.2-3b"] = serve_path(
        torch, get_config, build_model, serve, "llama3.2-3b", 4, 2048,
        gen_steps, counted, {"flash_attention_fwd": 28})
    path_launches["serve_llama3.2-3b"] = serving["llama3.2-3b"]["launches"]
    torch.cuda.empty_cache()
    serving["falcon-mamba-7b"] = serve_path(
        torch, get_config, build_model, serve, "falcon-mamba-7b", 4, 1024,
        gen_steps, counted, {"selective_scan_fwd": 64 * (1 + gen_steps)})
    path_launches["serve_falcon-mamba-7b"] = \
        serving["falcon-mamba-7b"]["launches"]
    torch.cuda.empty_cache()
    # this slice's path: cross-silo FedSAE training at full width, then the
    # centralized training CLI on the smoke config
    training = {"silo_llama3.2-3b": silo_path(torch, np, get_config,
                                              build_model, counted, ref)}
    path_launches["silo_llama3.2-3b"] = \
        training["silo_llama3.2-3b"]["launches"]
    torch.cuda.empty_cache()
    reset_counts(counted)
    t0 = time.perf_counter()
    cli_losses = train.main(["--arch", "llama3.2-3b", "--smoke", "--steps",
                             "5"])
    torch.cuda.synchronize()
    cli_launches = {k: fn.launches for k, fn in counted.items()}
    cli_tc = tensor_core_counts(counted)
    want = dict({k: 0 for k in counted}, flash_attention_fwd=10,
                flash_attention_bwd=10, fused_softmax_xent_fwd=5,
                fused_softmax_xent_bwd=5)
    want_tc = {k: want[k] for k in cli_tc}      # bf16: all tensor cores
    if (cli_launches != want or cli_tc != want_tc
            or not np.isfinite(cli_losses).all()):
        raise RuntimeError(f"launch.train smoke: losses {cli_losses}, "
                           f"launched {cli_launches} (tensor cores "
                           f"{cli_tc}), wanted {want}")
    training["train_cli_smoke"] = dict(
        losses=cli_losses, wall_s=time.perf_counter() - t0,
        launches=cli_launches, tensor_core_launches=cli_tc)
    path_launches["train_cli_smoke"] = cli_launches
    print(f"main path python -m repro_torch.launch.train --arch llama3.2-3b "
          f"--smoke --steps 5: losses {[round(x, 4) for x in cli_losses]}; "
          f"launches {json.dumps(cli_launches)}", flush=True)
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in counted}
    tc_runs = [serving[a]["tensor_core_launches"] for a in serving] + [
        training[t]["tensor_core_launches"] for t in training]
    tc_total = {k: sum(r[k] for r in tc_runs) for k in tc_runs[0]}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main paths never launched {name}")

    # -- 5. where a steady round's time goes (outside the counted run) ---
    profiles = {}
    for label, cfg in (("iid", dict(sampling="iid")),
                       ("shuffle", dict(sampling="shuffle")),
                       ("mlp iid topk_q8", dict(
                           sampling="iid", model="mlp",
                           upload_compress="topk_q8", topk_frac=frac))):
        srv = FedSAEServer(femnist, cfg=ServerConfig(
            algo="ira", n_selected=10, **cfg))
        srv.run_round(0)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run_round(1)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        row = {}
        prof_wall, device_ms, top, _ = profiled(
            torch, lambda: row.update(srv.run_round(2)))
        profiles[label] = dict(
            round1_wall_ms=plain_wall * 1e3,
            round2_budgets=[int(v) for v in row["n_iters"]],
            round2_wall_ms_profiled=prof_wall,
            round2_device_ms=device_ms,
            round2_device_busy=device_ms / prof_wall,
            top_kernels_ms=top[:5])
        print(f"profile {label}: {json.dumps(profiles[label])}",
              flush=True)

    kernels = [
        {"name": "fed_cohort_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed_gather.cu",
         "replaces": "src/repro/kernels/fed_gather.py:56",
         "launches": launches["fed_cohort_gather"], "max_abs_err": 0.0,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": g_lib},
        {"name": "fed_local_sgd_mclr", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed_local_sgd.cu",
         "replaces": "src/repro/kernels/fed_local_sgd.py:99",
         "launches": launches["fed_local_sgd_mclr"], "max_abs_err": sgd_err,
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None},
        {"name": "fed_local_sgd_dense", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed_local_sgd_dense.cu",
         "replaces": "src/repro/kernels/fed_local_sgd_dense.py:119",
         "launches": launches["fed_local_sgd_dense"],
         "max_abs_err": dense_err, "ms": d_ms, "plain_ms": d_plain,
         "bound_ms": d_bound, "bound_by": d_by, "library_ms": None},
        {"name": "fed_compress_topk_q8", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed_compress.cu",
         "replaces": "src/repro/kernels/fed_compress.py:78",
         "launches": launches["fed_compress_topk_q8"], "max_abs_err": 0.0,
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": c_lib},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": launches["flash_attention_fwd"],
         "tensor_core_launches": tc_total["flash_attention_fwd"],
         **flash_row},
        {"name": "selective_scan_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:49",
         "launches": launches["selective_scan_fwd"], **scan_row},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:197",
         "launches": launches["flash_attention_bwd"],
         "tensor_core_launches": tc_total["flash_attention_bwd"],
         **bwd_row},
        {"name": "fused_softmax_xent_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_xent.cu",
         "replaces": "src/repro/kernels/fused_xent.py:50",
         "launches": launches["fused_softmax_xent_fwd"],
         "tensor_core_launches": tc_total["fused_softmax_xent_fwd"],
         **xent_row},
        {"name": "fused_softmax_xent_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_xent_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:95",
         "launches": launches["fused_softmax_xent_bwd"],
         "tensor_core_launches": tc_total["fused_softmax_xent_bwd"],
         **xent_bwd_row},
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"main_path": summary, "path_launches": path_launches,
                      "profile": profiles, "serving": serving,
                      "training": training}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
