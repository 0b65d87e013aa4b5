#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line):

1. print the card (nvidia-smi name and power limit) and build the four
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a, one nvcc per source, started together;
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
3. check the port end to end on small federations: the same server on
   the card and on the CPU, with the same init and minibatch draws, picks
   the same cohorts and workloads; MCLR ends within 2e-5, the MLP with
   top-k + int8 compression within 2/test_n of final accuracy;
4. the main paths, each with every kernel's launch count set to 0 just
   before and read just after: ``FedSAEServer`` on FEMNIST at paper scale
   (200 clients, K=10, algo="ira"), MCLR for 5 rounds with sampling="iid"
   then 2 with sampling="shuffle"; and the MLP (d=784, H=64, C=26) with
   sampling="iid" and upload_compress="topk_q8" (topk_frac 0.1) for 5
   rounds, whose gather, dense-SGD and compress launches must each be 5
   and whose last round must keep ``transmitted + residual' == delta +
   residual`` bitwise; losses, params and residual must be finite;
5. profile one steady round of each path (torch.profiler): host wall,
   device time and the kernels that take it.

It then prints one JSON line with every kernel's launches, error, times
and roofline bound, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
repo's ``src/`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-5                 # the reference's local-SGD kernel-vs-XLA bound
DENSE_RTOL, DENSE_ATOL = 5e-4, 5e-5   # its MLP pallas-vs-xla bound
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM, float32 outside the tensor cores


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.kernels import (build, fed_compress, fed_gather,
                                     fed_local_sgd, fed_local_sgd_dense, ref)

    card = nvidia_smi()
    print(f"card: {card}", flush=True)
    dev = resolve_device("cuda")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {json.dumps(built)} wall {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in build.SIGNATURES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

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

    # -- 4. the main paths ------------------------------------------------
    counted = {"fed_cohort_gather": gather, "fed_local_sgd_mclr": sgd,
               "fed_local_sgd_dense": dense,
               "fed_compress_topk_q8": compress}
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
        for fn in counted.values():
            fn.launches = 0
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
            "fed_local_sgd_dense": 5, "fed_compress_topk_q8": 5}
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
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in counted}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main paths never launched {name}")

    # -- 5. where a steady round's time goes (outside the counted run) ---
    from torch.profiler import ProfilerActivity, profile
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            row = srv.run_round(2)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        events = [(e.key, getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)))
                  for e in prof.key_averages()]
        device_ms = sum(t for _, t in events) / 1e3
        top = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
        profiles[label] = dict(
            round1_wall_ms=plain_wall * 1e3,
            round2_budgets=[int(v) for v in row["n_iters"]],
            round2_wall_ms_profiled=prof_wall * 1e3,
            round2_device_ms=device_ms,
            round2_device_busy=device_ms / (prof_wall * 1e3),
            top_kernels_ms=[(k[:60], t / 1e3) for k, t in top[:5]])
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
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"main_path": summary, "path_launches": path_launches,
                      "profile": profiles}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
