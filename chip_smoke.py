#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line):

1. print the card (nvidia-smi name and power limit) and build both CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one
   nvcc per source, started together;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: the cohort gather bitwise on the FEMNIST
   paper-scale federation (with n=0, n=max_n and clamped lanes), MCLR
   local SGD within rtol = atol = 2e-5 at K=10, max_n=400, d=784, C=26,
   B=10, max_iters=960 (prox_mu 0 and 0.1) and at the synthetic set's
   shape (d=60, C=10, max_n=2000); time kernel, plain version and, for the
   gather, the library call ``flat_x[idx]`` (median of per-call CUDA-event
   times, after a clock warm-up);
3. check the port end to end on a small federation: the same server on
   the card and on the CPU, with the same init and minibatch draws, picks
   the same cohorts and ends within 2e-5;
4. the main path: ``FedSAEServer`` on FEMNIST at paper scale (200 clients,
   K=10, algo="ira") for 5 rounds with sampling="iid", then 2 rounds with
   sampling="shuffle", with every kernel's launch count set to 0 just
   before and read just after; losses must be finite and both kernels
   launched;
5. profile one steady round of each sampling (torch.profiler): host wall,
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
    from repro_torch.core.engine import iid_indices
    from repro_torch.core.server import FedSAEServer, ServerConfig
    from repro_torch.data.federated import (make_femnist_like,
                                            make_synthetic)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, fed_gather, fed_local_sgd, ref

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

    # -- 4. the main path ---------------------------------------------------
    gather.launches = 0
    sgd.launches = 0
    summary = {}
    for sampling, rounds in (("iid", 5), ("shuffle", 2)):
        srv = FedSAEServer(femnist, cfg=ServerConfig(
            algo="ira", n_selected=10, rounds=rounds, sampling=sampling))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = np.asarray(hist["train_loss"], np.float64)
        if not np.isfinite(losses).all() or not np.isfinite(
                hist["test_loss"]).all():
            raise RuntimeError(f"non-finite losses ({sampling}): {hist}")
        for k, v in srv.params.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"non-finite global params {k}")
        steady = (rounds - 1) / sum(srv.wall_times[1:])
        summary[sampling] = dict(rounds=rounds, wall_s=wall,
                                 rounds_per_s=rounds / wall,
                                 steady_rounds_per_s=steady,
                                 round_wall_s=srv.wall_times,
                                 acc=hist["acc"],
                                 train_loss=hist["train_loss"])
        print(f"main path femnist paper scale, ira, {sampling}: {rounds} "
              f"rounds in {wall:.3f} s ({rounds / wall:.3f} rounds/s; "
              f"after the first round {steady:.3f} rounds/s), round wall "
              f"{[round(w, 4) for w in srv.wall_times]} s, acc "
              f"{[round(a, 4) for a in hist['acc']]}, train_loss "
              f"{[round(a, 4) for a in hist['train_loss']]}", flush=True)
    launches = {"fed_cohort_gather": gather.launches,
                "fed_local_sgd_mclr": sgd.launches}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main path never launched {name}")

    # -- 5. where a steady round's time goes (outside the counted run) ---
    from torch.profiler import ProfilerActivity, profile
    profiles = {}
    for sampling in ("iid", "shuffle"):
        srv = FedSAEServer(femnist, cfg=ServerConfig(
            algo="ira", n_selected=10, sampling=sampling))
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
        profiles[sampling] = dict(
            round1_wall_ms=plain_wall * 1e3,
            round2_budgets=[int(v) for v in row["n_iters"]],
            round2_wall_ms_profiled=prof_wall * 1e3,
            round2_device_ms=device_ms,
            round2_device_busy=device_ms / (prof_wall * 1e3),
            top_kernels_ms=[(k[:60], t / 1e3) for k, t in top[:4]])
        print(f"profile {sampling}: {json.dumps(profiles[sampling])}",
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
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"main_path": summary, "profile": profiles}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
