#!/usr/bin/env python3
"""Time the port's selective-scan and cohort-gather kernels against an
earlier version of their sources, on one CUDA card.

    git show <commit>:src/repro_torch/kernels/csrc/selective_scan.cu \
        > _scratch/old/selective_scan.cu
    git show <commit>:src/repro_torch/kernels/csrc/fed_gather.cu \
        > _scratch/old/fed_gather.cu
    python3 scripts/kernel_ab.py --old-dir _scratch/old [--split] [--ab]

``--split`` takes the old scan apart (the scan of the port's first
version, one thread per channel with a staged chunk of 32 steps): it
builds two variants of the old source besides the old source itself,
made by textual edits in the build directory (nothing in the repository
changes):

- staging only: each chunk is loaded into shared memory as before, and
  only one value per chunk is stored to y, so the recurrence never runs;
- compute only: the recurrence runs on values made from the indices in
  place of the loads of dt, x, B and C, and stores y as before;

and times the three in turns at Falcon-Mamba-7B's prefill shape.

``--ab`` times old and current kernels in turns (old, new, new, old) on
the same inputs: the scan at the prefill shape (B=4, S=1,024, d=8,192,
N=16), at decode's S=1 for N in 1..64, and at B=1; the gather at the
FEMNIST paper-scale shape (K=10, max_n=400, feat=784), with
``flat_x[idx]`` and a same-size ``Tensor.copy_`` beside it, after a
flush that leaves the L2 dirty (as ``chip_smoke.py`` has timed the gather
since it was written) and after one that leaves it clean.  Old and
current results are each held against the plain version (the scan within
1e-4), and the two gathers against each other, bitwise.

Times are medians of per-call CUDA-event times after a clock warm-up, as
in ``chip_smoke.py``, whose helpers this script uses.  The card's name
and power limit are printed first; the results go to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
SCAN_ARGS = [P] * 8 + [I] * 4 + [P]
OLD_GATHER_ARGS = [P] * 7 + [ctypes.c_longlong, I, I, I, I, P]

#: (find, replace) edits of the old scan for the two split variants; each
#: must match the old source exactly once
SPLIT_EDITS = [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n"
     "#ifdef SPLIT_COMPUTE_ONLY\n"
     "#define SPLIT_LD(p, i) (1e-3f * (float)((i) & 31) + 1e-3f)\n"
     "#else\n"
     "#define SPLIT_LD(p, i) (p)[i]\n"
     "#endif\n"),
    ("dtb[(long long)(t0 + t) * d + ch]",
     "SPLIT_LD(dtb, (long long)(t0 + t) * d + ch)"),
    ("xb[(long long)(t0 + t) * d + ch]",
     "SPLIT_LD(xb, (long long)(t0 + t) * d + ch)"),
    ("Bb[o]", "SPLIT_LD(Bb, o)"),
    ("Cb[o]", "SPLIT_LD(Cb, o)"),
    ("    if (!live) continue;\n",
     "    if (!live) continue;\n"
     "#ifdef SPLIT_STAGING_ONLY\n"
     "    yb[(long long)t0 * d + ch] = dts[len - 1][tid] + xs[0][tid]\n"
     "        + Bs[len - 1][0] + Cs[0][N - 1];\n"
     "    continue;\n"
     "#endif\n"),
]


def nvcc(src: str, out: str, defines=()) -> str:
    from repro_torch.kernels import build
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *[f"-D{d}" for d in defines],
           "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return out


def bind(path: str, fn: str, argtypes) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = I
    return lib


def split_sources(old_src: str, build_dir: str) -> str:
    with open(old_src) as f:
        text = f.read()
    for find, repl in SPLIT_EDITS:
        if text.count(find) != 1:
            raise RuntimeError(f"the old scan does not hold {find!r} once")
        text = text.replace(find, repl)
    path = os.path.join(build_dir, "scan_split.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def scan_inputs(torch, B, S, d, N, seed=0):
    return cs.scan_inputs(torch, B, S, d, N,
                          torch.Generator("cuda").manual_seed(seed), "cuda")


def scan_caller(torch, lib, args):
    """A call of ``lib``'s scan entry on ``args``, into fresh outputs."""
    dt, A, Bm, Cm, x, h0 = args
    B, S, d = dt.shape
    N = A.shape[1]
    y = torch.empty_like(dt)
    hT = torch.empty_like(h0)
    ptrs = [t.data_ptr() for t in (dt, A, Bm, Cm, x, h0, y, hT)]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.selective_scan_fwd_launch(*ptrs, B, S, d, N, stream)
        if code:
            raise RuntimeError(f"scan launch failed: CUDA error {code}")
        return y, hT
    return call


def turns(torch, a, b, reps):
    """Times of a, b, b, a (medians of ``reps`` calls each)."""
    ta1 = cs.time_ms(torch, a, reps)
    tb1 = cs.time_ms(torch, b, reps)
    tb2 = cs.time_ms(torch, b, reps)
    ta2 = cs.time_ms(torch, a, reps)
    return [ta1, ta2], [tb1, tb2]


def scan_bound(B, S, d, N):
    ms, by, parts = cs.scan_bound(*cs.scan_work(B, S, d, N))
    return {"ms": ms, "by": by, "parts": parts}


def run_split(torch, old_src, build_dir, out):
    B, S, d, N = 4, 1024, 8192, 16
    split = split_sources(old_src, build_dir)
    libs = {
        "full": bind(nvcc(old_src, os.path.join(build_dir, "old_scan.so")),
                     "selective_scan_fwd_launch", SCAN_ARGS),
        "staging_only": bind(nvcc(split, os.path.join(
            build_dir, "old_scan_staging.so"), ["SPLIT_STAGING_ONLY"]),
            "selective_scan_fwd_launch", SCAN_ARGS),
        "compute_only": bind(nvcc(split, os.path.join(
            build_dir, "old_scan_compute.so"), ["SPLIT_COMPUTE_ONLY"]),
            "selective_scan_fwd_launch", SCAN_ARGS),
    }
    args = scan_inputs(torch, B, S, d, N)
    calls = {k: scan_caller(torch, lib, args) for k, lib in libs.items()}
    cs.spin(torch)
    order = ["full", "staging_only", "compute_only", "compute_only",
             "staging_only", "full"]
    times = {k: [] for k in libs}
    for k in order:
        times[k].append(cs.time_ms(torch, calls[k], 20))
    res = {"shape": [B, S, d, N], "ms": times,
           "bound_ms": scan_bound(B, S, d, N)}
    print(f"old scan split B={B} S={S} d={d} N={N}: {json.dumps(res)}",
          flush=True)
    out["scan_split"] = res


def run_ab(torch, old_dir, build_dir, out):
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fed_gather
    new_scan = build.load("selective_scan")
    old_scan = bind(nvcc(os.path.join(old_dir, "selective_scan.cu"),
                         os.path.join(build_dir, "old_scan.so")),
                    "selective_scan_fwd_launch", SCAN_ARGS)
    cs.spin(torch)
    rows = []
    shapes = [(4, 1024, 8192, 16, 20), (1, 1024, 8192, 16, 20)] + [
        (4, 1, 8192, n, 200) for n in (1, 3, 8, 16, 17, 32, 64)] + [
        (1, 1, 8192, 16, 200)]
    for B, S, d, N, reps in shapes:
        args = scan_inputs(torch, B, S, d, N)
        old_call = scan_caller(torch, old_scan, args)
        new_call = scan_caller(torch, new_scan, args)
        oy, oh = (t.clone() for t in old_call())
        ny, nh = new_call()
        wy, wh = ref.selective_scan(*args)
        torch.cuda.synchronize()
        err = {"old": max(float((oy - wy).abs().max()),
                          float((oh - wh).abs().max())),
               "new": max(float((ny - wy).abs().max()),
                          float((nh - wh).abs().max()))}
        for k, (y, h) in (("old", (oy, oh)), ("new", (ny, nh))):
            if not (torch.allclose(y, wy, rtol=cs.SCAN_TOL, atol=cs.SCAN_TOL)
                    and torch.allclose(h, wh, rtol=cs.SCAN_TOL,
                                       atol=cs.SCAN_TOL)):
                raise RuntimeError(f"{k} scan differs from plain at "
                                   f"{(B, S, d, N)}: {err}")
        t_old, t_new = turns(torch, old_call, new_call, reps)
        row = {"shape": [B, S, d, N], "old_ms": t_old, "new_ms": t_new,
               "max_abs_err": err, "bound_ms": scan_bound(B, S, d, N)}
        print(f"scan {json.dumps(row)}", flush=True)
        rows.append(row)
    out["scan_ab"] = rows

    # -- the gather, at the FEMNIST paper-scale shape ---------------------
    from repro_torch.data.federated import make_femnist_like
    import numpy as np
    femnist = make_femnist_like()
    max_n = int(femnist.sizes.max())
    pk = femnist.packed(max_n, device="cuda")
    rng = np.random.default_rng(0)
    K = 10
    ids = torch.as_tensor(rng.choice(femnist.n_clients, K, replace=False),
                          device="cuda")
    starts = pk.offsets[ids].contiguous()
    ns = torch.clamp(pk.lengths[ids], max=max_n)
    flat_x, flat_y = pk.x.contiguous(), pk.y
    rows_, feat = flat_x.shape
    old_gather = bind(nvcc(os.path.join(old_dir, "fed_gather.cu"),
                           os.path.join(build_dir, "old_gather.so")),
                      "fed_cohort_gather_launch", OLD_GATHER_ARGS)
    ox = torch.empty((K, max_n, feat), device="cuda")
    oy = torch.empty((K, max_n), dtype=torch.int32, device="cuda")
    om = torch.empty((K, max_n), device="cuda")
    rpb = max(1, min(max_n, 4096 // feat))

    def old_call():
        code = old_gather.fed_cohort_gather_launch(
            flat_x.data_ptr(), flat_y.data_ptr(), starts.data_ptr(),
            ns.data_ptr(), ox.data_ptr(), oy.data_ptr(), om.data_ptr(),
            rows_, feat, K, max_n, rpb, torch.cuda.current_stream()
            .cuda_stream)
        if code:
            raise RuntimeError(f"old gather failed: CUDA error {code}")

    def new_call():
        return fed_gather.fed_cohort_gather(flat_x, flat_y, starts, ns,
                                            max_n)
    old_call()
    got = new_call()
    torch.cuda.synchronize()
    for g, w in zip(got, (ox, oy, om)):
        if not torch.equal(g, w):
            raise RuntimeError("old and new gather differ")
    idx = (torch.clamp(starts.long(), max=rows_ - max_n)[:, None]
           + torch.arange(max_n, device="cuda")[None, :])
    src = torch.empty((K * max_n * feat,), device="cuda")
    dst = torch.empty_like(src)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    cs.spin(torch)
    order = [("old", old_call), ("new", new_call),
             ("library", lambda: flat_x[idx]), ("copy", lambda: dst.copy_(src)),
             ("copy", lambda: dst.copy_(src)), ("library", lambda: flat_x[idx]),
             ("new", new_call), ("old", old_call)]
    times = {}
    for clean in (False, True):
        for name, fn in order:
            times.setdefault(("clean " if clean else "") + name, []).append(
                cs.time_ms(torch, fn, 50, flush, clean))
    g_bytes = 2 * K * max_n * feat * 4 + 3 * K * max_n * 4 + 2 * K * 4
    res = {"shape": [K, max_n, feat], "ms": times,
           "bound_ms": cs.bound(g_bytes, 0)[0], "bytes": g_bytes}
    print(f"gather {json.dumps(res)}", flush=True)
    out["gather_ab"] = res


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", required=True,
                    help="directory holding the old selective_scan.cu and "
                         "fed_gather.cu")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--build-dir", default=os.path.join(ROOT, "_scratch",
                                                        "kernel_ab"))
    ap.add_argument("--out", default=os.path.join(ROOT, "_scratch",
                                                  "kernel_ab.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    os.makedirs(a.build_dir, exist_ok=True)
    card = cs.nvidia_smi()
    print(f"card: {card}", flush=True)
    out = {"card": card, "kind": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    if a.split:
        run_split(torch, os.path.join(a.old_dir, "selective_scan.cu"),
                  a.build_dir, out)
    if a.ab:
        run_ab(torch, a.old_dir, a.build_dir, out)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
