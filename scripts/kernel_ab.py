#!/usr/bin/env python3
"""Time the port's selective-scan, cohort-gather, local-SGD, top-k
compressor and cross-entropy kernels against an earlier version of their
sources, on one CUDA card.

    for k in selective_scan fed_gather fed_local_sgd fed_local_sgd_dense \
             fed_compress; do
        git show <commit>:src/repro_torch/kernels/csrc/$k.cu \
            > _scratch/old/$k.cu
    done
    python3 scripts/kernel_ab.py --old-dir _scratch/old [--split] [--ab] \
        [--sgd] [--compress] [--stamps] [--xent] [--scan-bwd]

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

``--sgd`` times the two local-SGD kernels (MCLR and the dense MLP)
against the old ``fed_local_sgd.cu`` and ``fed_local_sgd_dense.cu``, in
turns (old, new, new, old), at FEMNIST's shape (max_n=400, d=784, C=26,
B=10, MLP H=64, lr 0.03) for K in {1, 10, 20} and the longest client's
budget L in {40, 240, 960} (the other clients' budgets drawn from [1, L]),
FedProx (prox_mu 0.1) at K=10, L=600 (15 epochs of 40 iterations), and
the synthetic set's d=60, C=10 at K=10; each result is held against the
plain version first (MCLR 2e-5, dense rtol 5e-4, atol 5e-5).  It also
splits the old kernels' time at K=10, L=960 with two variants of each old
source, made by textual edits in the build directory: staging only (each
step loads its indices and batch rows and stops there) and compute only
(the indices and rows are loaded at the first step only, and every later
step computes on those rows).

``--compress`` times the top-k + int8 compressor against the old
``fed_compress.cu`` (``git show <commit>:.../fed_compress.cu >
_scratch/old/fed_compress.cu``), in turns (old, new, new, old), each
shape's results held bitwise against the plain version first and old
against new after the timed calls: K in {1, 10, 20} with P in {20,410
(MCLR), 51,930 (the MLP at H=64)} at ``resolve_k(0.1, P)``; at K=10,
P=51,930 also k in {1, P/2} and a heavily tied row; the streamed route
at K=2, P=4,194,304; and the new kernel at every cluster size at K=10
for both P.  The plan (route, cluster size) is printed beside each time.
With ``--compress``, ``--split`` takes the old compressor apart in place
of the scan: two variants of the old source, made by textual edits in the
build directory, stop after amax and after the four radix passes, and
the three are timed in turns at K=10, P=51,930.

``--stamps`` builds a copy of the current ``fed_compress.cu`` with
clock64 stamps between its phases (thread 0 of each CTA writes them to a
device array; made by textual edits in the build directory) and one that
returns at once, and prints, at K in {1, 10, 20} with P = 51,930, each
phase's cycles (least, median and most over the CTAs) beside the
stamped call's time and the empty launch's.

``--scan-bwd`` times the scan's backward against an older
``selective_scan_bwd.cu`` (``git show <commit>:.../selective_scan_bwd.cu
> _scratch/old/selective_scan_bwd.cu``; the first version's, whose C
entry takes h0 and recomputes the forward's checkpoints itself), called
through the old source's own C entry, in turns (old, new given the
forward's checkpoints, new alone, the same again, new alone, new given,
old) at Falcon-Mamba-7B's width (d = 8,192, N = 16), B = 1 and B = 4,
S = 4,096; "new given" is the backward as training runs it, from the
checkpoints of the forward's checkpointing instance, and "new alone" the
wrapper without them, which launches that forward first.  Each result,
from a second call (the first call's errors
are printed beside: the first version's kernel once wrote a wrong ddt on
its first call in a process at B = 1), is first held against the plain
``ref.selective_scan_bwd`` (per gradient rtol 1e-4, atol 1e-4 of its
largest magnitude, ``chip_smoke.SCAN_BWD_TOL``; the plain result is kept
on the host, since on the card it came out changed after the first
version's kernel had run beside it at B = 4) and a third call must give
its bits again; the forward's two instances (serving's, the
checkpointing one) are timed in turns beside it.  Then ptxas' registers and spills of both sources' kernels: the new
one's from its build log (every N instance), the old one's from its
``nvcc -Xptxas -v`` here.

With ``--scan-bwd``, ``--split`` takes the current backward apart in
place of the scan: variants made by textual edits in the build directory
(``SCAN_BWD_SPLIT_EDITS``: staging only, compute only, no epilogue, no
dB/dC shuffles) timed in turns with the full kernel at B = 1 and 4.

``--xent`` times the fused cross-entropy against the old
``fused_xent.cu`` and ``fused_xent_bwd.cu`` (``git show <commit>:...`` of
both, and of the headers they include, ``xent_tc.cuh`` and
``hopper_tc.cuh``, into the old directory), in turns (old, new, new, old),
called through the old sources' own C entry points: at Llama-3.2-3B's
loss chunk (T=1,024, d=3,072, V=128,256, bf16, the tensor-core route of
both) the forward and the backward, the backward also split by kernel
(one profiled call of each; ``chip_smoke.profiled``); at internvl2-2b's
odd chunk (T=1,024, d=2,048, V=92,553) the old CUDA-core forward on a
contiguous W against the new tensor-core forward on a pitched one, and
the new backward against the plain recompute (``ref.softmax_xent`` under
autograd), which took its place before; each result first held against
its plain version (the forward within 1e-4, the backward per leaf against
``ref.softmax_xent_bwd_tc`` at rtol 2^-7, atol 2^-9 max|want|), each time
beside its bound.

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


def scan_caller(torch, lib, args, ckpt_arg=False):
    """A call of ``lib``'s scan entry on ``args``, into fresh outputs;
    ``ckpt_arg``: the entry takes a checkpoint buffer (null here: serving's
    instance), as the current source's does."""
    dt, A, Bm, Cm, x, h0 = args
    B, S, d = dt.shape
    N = A.shape[1]
    y = torch.empty_like(dt)
    hT = torch.empty_like(h0)
    ptrs = [t.data_ptr() for t in (dt, A, Bm, Cm, x, h0, y, hT)]
    if ckpt_arg:
        ptrs.append(None)

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
        new_call = scan_caller(torch, new_scan, args, ckpt_arg=True)
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


#: (find, replace) edits of the old local-SGD kernels (both sources hold
#: each text once) for the staging-only and compute-only variants
SGD_SPLIT_EDITS = [
    ("      xb[e] = xk[(long long)sidx[bb] * d + j];\n    }\n"
     "    __syncthreads();\n",
     "      xb[e] = xk[(long long)sidx[bb] * d + j];\n    }\n"
     "    __syncthreads();\n"
     "#ifdef SPLIT_STAGING_ONLY\n    continue;\n#endif\n"),
    ("    for (int bb = tid; bb < B; bb += nt) {\n"
     "      int r = idxk[(long long)i * B + bb];\n",
     "#ifdef SPLIT_COMPUTE_ONLY\n    if (i == 0)\n#endif\n"
     "    for (int bb = tid; bb < B; bb += nt) {\n"
     "      int r = idxk[(long long)i * B + bb];\n"),
    ("    for (int e = tid; e < B * d; e += nt) {\n"
     "      const int bb = e / d, j = e - bb * d;\n",
     "#ifdef SPLIT_COMPUTE_ONLY\n    if (i == 0)\n#endif\n"
     "    for (int e = tid; e < B * d; e += nt) {\n"
     "      const int bb = e / d, j = e - bb * d;\n"),
]
OLD_MCLR_ARGS = [P] * 10 + [I] * 7 + [ctypes.c_float, ctypes.c_float, P]
OLD_DENSE_ARGS = [P] * 14 + [I] * 8 + [ctypes.c_float, ctypes.c_float, P]
SGD_LR, SGD_H, SGD_B = 0.03, 64, 10


def sgd_split_source(old_src: str, build_dir: str, name: str) -> str:
    with open(old_src) as f:
        text = f.read()
    for find, repl in SGD_SPLIT_EDITS:
        if text.count(find) != 1:
            raise RuntimeError(f"{old_src} does not hold {find!r} once")
        text = text.replace(find, repl)
    path = os.path.join(build_dir, f"{name}_split.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def sgd_data(torch, dataset: str):
    """(flat x, flat y, offsets, lengths, max_n, n_classes) of the FEMNIST
    paper-scale or the synthetic federation, on the card."""
    from repro_torch.data.federated import make_femnist_like, make_synthetic
    fed = make_femnist_like() if dataset == "femnist" else make_synthetic()
    max_n = int(fed.sizes.max())
    pk = fed.packed(max_n, device="cuda")
    return pk, max_n, fed.n_classes, fed.n_clients


def sgd_case(torch, data, K: int, L: int, mlp: bool, seed: int):
    """Inputs of one local-SGD call: K clients (the largest first), the
    longest budget L, the others from [1, L]."""
    import numpy as np
    from repro_torch.core.engine import iid_indices
    from repro_torch.kernels import ref
    pk, max_n, C, n_clients = data
    rng = np.random.default_rng(seed)
    ids = rng.choice(n_clients, K, replace=False)
    ids[0] = int(torch.argmax(pk.lengths))
    ids_t = torch.as_tensor(ids, device="cuda")
    ns = torch.clamp(pk.lengths[ids_t], max=max_n)
    x, y, _ = ref.fed_cohort_gather(pk.x.contiguous(), pk.y,
                                    pk.offsets[ids_t].contiguous(), ns,
                                    max_n=max_n)
    n_iters = torch.as_tensor(rng.integers(1, L + 1, K), dtype=torch.int32,
                              device="cuda")
    n_iters[0] = L
    gen = torch.Generator("cuda").manual_seed(seed)
    idx = iid_indices(gen, ns, L, SGD_B)
    d = x.shape[2]
    if mlp:
        params = (torch.randn((d, SGD_H), generator=gen, device="cuda")
                  * d ** -0.5, torch.zeros(SGD_H, device="cuda"),
                  torch.randn((SGD_H, C), generator=gen, device="cuda")
                  * SGD_H ** -0.5, torch.zeros(C, device="cuda"))
    else:
        params = (torch.randn((d, C), generator=gen, device="cuda") * 0.01,
                  torch.zeros(C, device="cuda"))
    return (x.contiguous(), y.contiguous(), idx, *params, ns.contiguous(),
            n_iters)


def old_sgd_caller(torch, lib, args, mlp: bool, mu: float):
    """A call of the old kernel's C entry on ``args`` into fresh outputs."""
    x, y, idx = args[:3]
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    if mlp:
        H, C = args[5].shape
        outs = [torch.empty(s, device="cuda")
                for s in ((K, d, H), (K, H), (K, H, C), (K, C), (K,))]
        dims = [K, max_n, d, H, C, max_iters, B, max(1, min(1024 // H, d))]
        fn = lib.fed_local_sgd_dense_launch
    else:
        C = args[3].shape[1]
        outs = [torch.empty(s, device="cuda") for s in ((K, d, C), (K, C),
                                                        (K,))]
        dims = [K, max_n, d, C, max_iters, B,
                max(1, min(1024 // max(B * C, 1), d))]
        fn = lib.fed_local_sgd_mclr_launch
    ptrs = [t.data_ptr() for t in (*args, *outs)]

    def call():
        code = fn(*ptrs, *dims, SGD_LR, mu,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"old SGD kernel failed: CUDA error {code}")
        return outs
    return call


def check_sgd(torch, got, want, mlp: bool, what: str) -> float:
    rtol, atol = (cs.DENSE_RTOL, cs.DENSE_ATOL) if mlp else (cs.TOL, cs.TOL)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.allclose(g, w, rtol=rtol, atol=atol)
               for g, w in zip(got, want)):
        raise RuntimeError(f"{what} differs from plain: {err}")
    return err


def run_sgd(torch, old_dir, build_dir, out):
    from repro_torch.kernels import fed_local_sgd, fed_local_sgd_dense, ref
    kinds = {
        "mclr": ("fed_local_sgd", OLD_MCLR_ARGS, "fed_local_sgd_mclr_launch",
                 fed_local_sgd.fed_local_sgd_mclr, ref.fed_local_sgd_mclr),
        "dense": ("fed_local_sgd_dense", OLD_DENSE_ARGS,
                  "fed_local_sgd_dense_launch",
                  fed_local_sgd_dense.fed_local_sgd_dense,
                  ref.fed_local_sgd_dense),
    }
    femnist = sgd_data(torch, "femnist")
    libs = {}
    for kind, (src, argtypes, entry, _, _) in kinds.items():
        old_src = os.path.join(old_dir, f"{src}.cu")
        split = sgd_split_source(old_src, build_dir, src)
        libs[kind] = {
            variant: bind(nvcc(path, os.path.join(
                build_dir, f"old_{src}_{variant}.so"), defines), entry,
                argtypes)
            for variant, path, defines in (
                ("full", old_src, ()),
                ("staging_only", split, ["SPLIT_STAGING_ONLY"]),
                ("compute_only", split, ["SPLIT_COMPUTE_ONLY"]))}
    cs.spin(torch)
    # the old kernels' split at K=10, L=960
    split_rows = {}
    for kind in kinds:
        mlp = kind == "dense"
        args = sgd_case(torch, femnist, 10, 960, mlp, seed=0)
        calls = {v: old_sgd_caller(torch, lib, args, mlp, 0.0)
                 for v, lib in libs[kind].items()}
        times = {v: [] for v in calls}
        for v in ("full", "staging_only", "compute_only", "compute_only",
                  "staging_only", "full"):
            times[v].append(cs.time_ms(torch, calls[v], 5))
        row = {"shape": {"K": 10, "L": 960}, "ms": times,
               "us_per_iteration": {v: [t * 1e3 / 960 for t in ts]
                                    for v, ts in times.items()}}
        print(f"old {kind} SGD split {json.dumps(row)}", flush=True)
        split_rows[kind] = row
    out["sgd_split"] = split_rows

    # old against new in turns
    synthetic = sgd_data(torch, "synthetic")
    shapes = [("femnist", K, L, 0.0) for K in (1, 10, 20)
              for L in (40, 240, 960)]
    shapes += [("femnist", 10, 600, 0.1), ("synthetic", 10, 40, 0.0),
               ("synthetic", 10, 960, 0.0)]
    rows = []
    for kind, (_, _, _, wrapper, plain) in kinds.items():
        mlp = kind == "dense"
        for dataset, K, L, mu in shapes:
            data = femnist if dataset == "femnist" else synthetic
            args = sgd_case(torch, data, K, L, mlp, seed=K + L)
            old_call = old_sgd_caller(torch, libs[kind]["full"], args, mlp,
                                      mu)

            def new_call(args=args, mu=mu):
                return wrapper(*args, SGD_LR, mu)
            want = plain(*args, lr=SGD_LR, prox_mu=mu)
            err = {"old": check_sgd(torch, [t.clone() for t in old_call()],
                                    want, mlp, f"old {kind}"),
                   "new": check_sgd(torch, new_call(), want, mlp,
                                    f"new {kind}")}
            reps = 5 if L >= 600 else 20
            t_old, t_new = turns(torch, old_call, new_call, reps)
            d, C = args[0].shape[2], args[-3].shape[0]   # the last bias: [C]
            size = (fed_local_sgd_dense.checked_cluster_size(
                K, d, SGD_H, C, SGD_B, mu != 0) if mlp else
                fed_local_sgd.checked_cluster_size(K, d, C, SGD_B, mu != 0))
            row = {"kernel": kind, "data": dataset, "K": K, "L": L,
                   "prox_mu": mu, "cluster_size": size, "old_ms": t_old,
                   "new_ms": t_new,
                   "old_us_per_iteration": [t * 1e3 / L for t in t_old],
                   "new_us_per_iteration": [t * 1e3 / L for t in t_new],
                   "max_abs_err": err}
            print(f"sgd {json.dumps(row)}", flush=True)
            rows.append(row)
    out["sgd_ab"] = rows


#: (find, replace) edits of the old compressor for the split variants
COMPRESS_SPLIT_EDITS = [
    ("  if (tid == 0) scale_out[blockIdx.x] = scale;\n",
     "  if (tid == 0) scale_out[blockIdx.x] = scale;\n"
     "#ifdef SPLIT_AMAX_ONLY\n  return;\n#endif\n"),
    ("  const unsigned thr = prefix;\n",
     "  const unsigned thr = prefix;\n"
     "#ifdef SPLIT_SELECT_ONLY\n  if (tid == 0) q[0] = (int8_t)(thr & 127u);"
     "\n  return;\n#endif\n"),
]
OLD_COMPRESS_ARGS = [P, P, P, I, I, I, P]


def compress_split_source(old_src: str, build_dir: str) -> str:
    with open(old_src) as f:
        text = f.read()
    for find, repl in COMPRESS_SPLIT_EDITS:
        if text.count(find) != 1:
            raise RuntimeError(f"{old_src} does not hold {find!r} once")
        text = text.replace(find, repl)
    path = os.path.join(build_dir, "fed_compress_split.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def compress_input(torch, K: int, P: int, kind: str, seed: int):
    """ef [K, P] on the card: N(0, 1e-3) deltas; ``tied`` draws every
    coordinate from 17 values (k/P of a row sits in a few tied levels)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    if kind == "tied":
        return (torch.randint(-8, 9, (K, P), generator=gen, device="cuda")
                .float() * 1e-3)
    return torch.randn((K, P), generator=gen, device="cuda") * 1e-3


def old_compress_caller(torch, lib, ef, k: int):
    K, P = ef.shape
    q = torch.empty((K, P), dtype=torch.int8, device="cuda")
    scale = torch.zeros((K,), device="cuda")
    k = max(-1, min(k, P))

    def call():
        code = lib.fed_compress_topk_q8_launch(
            ef.data_ptr(), q.data_ptr(), scale.data_ptr(), K, P, k,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"old compressor failed: CUDA error {code}")
        return q, scale
    return call


def compress_bound(K: int, P: int):
    nbytes = K * P * (4 + 1) + 4 * K
    return {"ms": cs.bound(nbytes, 0)[0], "bytes": nbytes}


def run_compress(torch, old_dir, build_dir, out, split: bool):
    from repro_torch.core.compression import resolve_k
    from repro_torch.kernels import fed_compress, ref
    old_src = os.path.join(old_dir, "fed_compress.cu")
    old = bind(nvcc(old_src, os.path.join(build_dir, "old_compress.so")),
               "fed_compress_topk_q8_launch", OLD_COMPRESS_ARGS)
    new = fed_compress.fed_compress_topk_q8
    cs.spin(torch)
    if split:
        path = compress_split_source(old_src, build_dir)
        libs = {"full": old}
        for name, define in (("amax_only", "SPLIT_AMAX_ONLY"),
                             ("amax_select", "SPLIT_SELECT_ONLY")):
            libs[name] = bind(nvcc(path, os.path.join(
                build_dir, f"old_compress_{name}.so"), [define]),
                "fed_compress_topk_q8_launch", OLD_COMPRESS_ARGS)
        K, P = 10, 51930
        ef = compress_input(torch, K, P, "normal", 0)
        k = resolve_k(0.1, P)
        calls = {v: old_compress_caller(torch, lib, ef, k)
                 for v, lib in libs.items()}
        times = {v: [] for v in libs}
        for v in ("full", "amax_only", "amax_select", "amax_select",
                  "amax_only", "full"):
            times[v].append(cs.time_ms(torch, calls[v], 50))
        res = {"shape": {"K": K, "P": P, "k": k}, "ms": times,
               "bound_ms": compress_bound(K, P)}
        print(f"old compress split {json.dumps(res)}", flush=True)
        out["compress_split"] = res

    shapes = [(K, P, resolve_k(0.1, P), "normal", None)
              for K in (1, 10, 20) for P in (20410, 51930)]
    shapes += [(10, 51930, 1, "normal", None),
               (10, 51930, 51930 // 2, "normal", None),
               (10, 51930, resolve_k(0.1, 51930), "tied", None),
               (2, 4194304, resolve_k(0.1, 4194304), "normal", None)]
    shapes += [(10, P, resolve_k(0.1, P), "normal", c)
               for P in (20410, 51930) for c in fed_compress.CLUSTER_SIZES]
    rows = []
    for i, (K, P, k, kind, cluster) in enumerate(shapes):
        ef = compress_input(torch, K, P, kind, i)
        old_call = old_compress_caller(torch, old, ef, k)

        def new_call(ef=ef, k=k, cluster=cluster):
            return new(ef, k, cluster=cluster)
        want = ref.fed_compress_topk_q8(ef, k=k)
        got_old = [t.clone() for t in old_call()]
        got_new = new_call()
        torch.cuda.synchronize()
        for name, got in (("old", got_old), ("new", got_new)):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} compressor differs from plain "
                                   f"at K={K}, P={P}, k={k}, {kind}")
        reps = 10 if P > 10**6 else 50
        t_old, t_new = turns(torch, old_call, new_call, reps)
        if not all(torch.equal(a, b) for a, b in zip(old_call(),
                                                     new_call())):
            raise RuntimeError(f"old and new compressor differ after the "
                               f"timed calls at K={K}, P={P}, k={k}")
        pl = fed_compress.plan(K, P, cluster)
        row = {"K": K, "P": P, "k": k, "input": kind,
               "route": pl.route, "cluster_size": pl.cs,
               "forced": cluster is not None, "old_ms": t_old,
               "new_ms": t_new, "bound_ms": compress_bound(K, P)}
        print(f"compress {json.dumps(row)}", flush=True)
        rows.append(row)
    out["compress_ab"] = rows


STAMP_HEAD = r"""
__device__ unsigned long long g_stamps[4096 * 32];
#define STAMP() do { if (threadIdx.x == 0) \
    g_stamps[blockIdx.x * 32 + st] = clock64(); ++st; } while (0)
extern "C" int read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n * sizeof(long long));
}
"""
#: (find, replace) edits of the current compressor for its stamped copy;
#: each must match the source exactly once
STAMP_EDITS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n" + STAMP_HEAD),
    ("  const int G = (pad + n + 3) >> 2;\n",
     "  const int G = (pad + n + 3) >> 2;\n  int st = 0;\n"
     "#ifdef EARLY_EXIT\n  if (P > 0) return;\n#endif\n  STAMP();\n"),
    ('  if (kResident) asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n",
     '  if (kResident) asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n  STAMP();\n"),
    ("    sync_cluster();   // the pass's one barrier: every histogram "
     "complete\n",
     "    STAMP();\n    sync_cluster();\n    STAMP();\n"),
    ("    const unsigned c = ctl.sel_c, base = ctl.sel_base;\n",
     "    const unsigned c = ctl.sel_c, base = ctl.sel_base;\n    STAMP();\n"),
    ("    known |= (unsigned)(nb - 1) << shift;\n  }\n",
     "    known |= (unsigned)(nb - 1) << shift;\n    STAMP();\n  }\n"),
    ("  if (CS > 1) cluster_arrive();        // no more remote reads\n",
     "  STAMP();\n  if (CS > 1) cluster_arrive();\n"),
    ("  if (CS > 1) cluster_wait();          // no CTA leaves while read "
     "remotely\n}",
     "  STAMP();\n  if (CS > 1) cluster_wait();\n  STAMP();\n}"),
]
#: the phases between consecutive stamps: the load, then per pass the
#: sweep (with the chunk sums), the cluster barrier, the chunk's find and
#: the bin's find, then the tie counts, the quantise sweep, the last wait
STAMP_PHASES = (["load"] + [f"{x}{p}" for p in range(3)
                            for x in ("sweep", "barrier", "chunk", "bin")]
                + ["ties", "quantise", "wait"])


def stamped_library(build_dir: str, define: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    with open(build.source_path("fed_compress")) as f:
        text = f.read()
    for find, repl in STAMP_EDITS:
        if text.count(find) != 1:
            raise RuntimeError(f"fed_compress.cu does not hold {find!r} "
                               f"once")
        text = text.replace(find, repl)
    path = os.path.join(build_dir, "fed_compress_stamped.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = ctypes.CDLL(nvcc(path, os.path.join(
        build_dir, f"fed_compress_stamped_{define or 'full'}.so"),
        [define] if define else []))
    for fn, (argtypes, restype) in build.SIGNATURES["fed_compress"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.read_stamps.argtypes = [P, I]
    lib.read_stamps.restype = I
    return lib


def run_stamps(torch, build_dir, out):
    import statistics
    from repro_torch.core.compression import resolve_k
    from repro_torch.kernels import fed_compress, ref
    libs = {"stamped": stamped_library(build_dir, ""),
            "empty": stamped_library(build_dir, "EARLY_EXIT")}
    cs.spin(torch)
    rows = []
    for K, P in ((10, 51930), (1, 51930), (20, 51930)):
        ef = compress_input(torch, K, P, "normal", K)
        k = resolve_k(0.1, P)
        pl = fed_compress.plan(K, P)
        q = torch.empty((K, P), dtype=torch.int8, device="cuda")
        scale = torch.empty((K,), device="cuda")
        calls = {}
        for name, lib in libs.items():
            def call(lib=lib):
                code = lib.fed_compress_topk_q8_launch(
                    ef.data_ptr(), q.data_ptr(), scale.data_ptr(), K, P, k,
                    pl.cs, pl.slice, int(pl.route == "resident"), pl.smem,
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"stamped compressor failed: CUDA "
                                       f"error {code}")
            calls[name] = call
        ms = {name: cs.time_ms(torch, call, 50)
              for name, call in calls.items()}
        calls["stamped"]()
        torch.cuda.synchronize()
        wq, ws = ref.fed_compress_topk_q8(ef, k=k)
        if not (torch.equal(q, wq) and torch.equal(scale, ws)):
            raise RuntimeError("the stamped compressor differs from plain")
        n = K * pl.cs * 32
        buf = (ctypes.c_ulonglong * n)()
        if libs["stamped"].read_stamps(buf, n):
            raise RuntimeError("reading the stamps failed")
        ctas = [[buf[b * 32 + i] for i in range(len(STAMP_PHASES) + 1)]
                for b in range(K * pl.cs)]
        phases = {}
        for i, name in enumerate(STAMP_PHASES):
            d = [c[i + 1] - c[i] for c in ctas]
            phases[name] = [min(d), statistics.median(d), max(d)]
        totals = [c[-1] - c[0] for c in ctas]
        row = {"K": K, "P": P, "k": k, "route": pl.route,
               "cluster_size": pl.cs, "ms": ms["stamped"],
               "empty_launch_ms": ms["empty"],
               "cycles_total": [min(totals), max(totals)],
               "cycles": phases}
        print(f"compress stamps {json.dumps(row)}", flush=True)
        rows.append(row)
    out["compress_stamps"] = rows


OLD_XENT_FWD_ARGS = [P] * 6 + [I] * 6 + [P]
OLD_XENT_BWD_ARGS = [P] * 10 + [I] * 4 + [P]


OLD_SCAN_BWD_ARGS = [P] * 17 + [I] * 4 + [P]


def old_scan_bwd_caller(torch, lib, args, gy, gh):
    """A call of an older ``selective_scan_bwd.cu``'s C entry (the first
    version's:
    inputs, cotangents, outputs, its own checkpoint and partial buffers,
    B, S, d, N, stream) on ``args``, into fresh outputs."""
    dt, A, Bm, Cm, x, h0 = args
    B, S, d = dt.shape
    N = A.shape[1]
    chunk = lib.selective_scan_bwd_chunk(N)
    outs = [torch.empty_like(t) for t in (dt, A, Bm, Cm, x, h0)]
    ckpt = torch.empty((B, -(-S // chunk), d, N), device="cuda")
    part = torch.empty((2, -(-d // 64), B, S, N), device="cuda")
    dA_part = torch.empty((B, d, N), device="cuda")
    ddt, dA, dB, dC, dx, dh0 = outs
    ptrs = [t.data_ptr() for t in (dt, A, Bm, Cm, x, h0, gy, gh, ddt, dA,
                                   dB, dC, dx, dh0, ckpt, part, dA_part)]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.selective_scan_bwd_launch(*ptrs, B, S, d, N, stream)
        if code:
            raise RuntimeError(f"old scan backward failed: CUDA error "
                               f"{code}")
        return outs
    return call


def ptxas_lines(log: str, kernel: str):
    """ptxas' register and spill lines of ``kernel``'s instances in an
    ``-Xptxas -v`` log: [(function line, usage lines)]."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            usage = [ln.strip() for ln in lines[i + 1:i + 5]
                     if "Used" in ln or "spill" in ln]
            out.append((line.split("'")[1] if "'" in line else line,
                        usage))
    return out


#: (find, replace) edits of the current selective_scan_bwd.cu for the
#: variants of --scan-bwd --split; each must match the source exactly once
SCAN_BWD_SPLIT_EDITS = {
    # staging, the epilogue and the partials, no recompute or reverse step
    "staging_only": [
        ("    float hp[NPL];                            // h before the chunk",
         "    if (d < 0) {\n    float hp[NPL];"),
        ("    __syncthreads();\n    // the chunk's ddt and dx rows",
         "    }\n    __syncthreads();\n    // the chunk's ddt and dx rows")],
    # the first chunks staged only: every other chunk computes on them
    "compute_only": [
        ("    if (k - (STAGES - 1) >= 0)\n      stage_chunk(",
         "    if (d < 0)\n      stage_chunk(")],
    # no ddt/dx rows and no dB/dC block sums or partials
    "no_epilogue": [
        ("    for (int i = tid; i < 2 * CH * CHANNELS; i += THREADS) {",
         "    if (d < 0) for (int i = tid; i < 2 * CH * CHANNELS; "
         "i += THREADS) {"),
        ("    for (int e = tid; e < E; e += THREADS) {\n"
         "      float s = sm.red[0][e];",
         "    if (d < 0) for (int e = tid; e < E; e += THREADS) {\n"
         "      float s = sm.red[0][e];")],
    # dB and dC not summed over the warp's channels (no shuffles)
    "no_dbdc_shuffles": [
        ("const int off = reduce_scatter<V>(v, wl, 16, LANES, cnt);",
         "cnt = 1; const int off = wl >> 3;")],
}


def run_scan_bwd_split(torch, build_dir, out):
    """The current backward and its variants (``SCAN_BWD_SPLIT_EDITS``, made
    in the build directory) in turns at Falcon's width, B = 1 and 4,
    S = 4,096, given the forward's checkpoints, all through the current C
    entry."""
    from repro_torch.kernels import build
    from repro_torch.kernels import selective_scan as ss
    with open(build.source_path("selective_scan_bwd")) as f:
        text = f.read()
    sources = {"full": build.source_path("selective_scan_bwd")}
    for name, edits in SCAN_BWD_SPLIT_EDITS.items():
        t = text
        for find, repl in edits:
            if t.count(find) != 1:
                raise RuntimeError(f"the backward does not hold {find!r} "
                                   f"once")
            t = t.replace(find, repl)
        sources[name] = os.path.join(build_dir, f"scan_bwd_{name}.cu")
        with open(sources[name], "w") as f:
            f.write(t)
    procs = {name: subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
         os.path.join(build_dir, f"scan_bwd_{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(build_dir, f"scan_bwd_{name}.so"))
        for fn, (argtypes, restype) in build.SIGNATURES[
                "selective_scan_bwd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    d, N, S = 8192, 16, 4096
    rows = []
    for B in (1, 4):
        args = scan_inputs(torch, B, S, d, N, seed=B)
        g = torch.Generator("cuda").manual_seed(100 + B)
        gy = torch.randn((B, S, d), generator=g, device="cuda")
        gh = torch.randn((B, d, N), generator=g, device="cuda")
        ckpt = ss.selective_scan_fwd(*args, checkpoints=True)[2]
        dt, A, Bm, Cm, x, h0 = args
        outs = [torch.empty_like(t) for t in args]
        part = torch.empty(
            (2, libs["full"].selective_scan_bwd_blocks(d), B, S, N),
            device="cuda")
        dA_part = torch.empty((B, d, N), device="cuda")
        ptrs = [t.data_ptr() for t in (dt, A, Bm, Cm, x, gy, gh, ckpt)] + [
            outs[i].data_ptr() for i in (0, 1, 2, 3, 4, 5)] + [
            part.data_ptr(), dA_part.data_ptr()]

        def caller(lib):
            def call():
                code = lib.selective_scan_bwd_launch(
                    *ptrs, B, S, d, N, torch.cuda.current_stream()
                    .cuda_stream)
                if code:
                    raise RuntimeError(f"CUDA error {code}")
            return call
        cs.spin(torch)
        order = list(libs) + list(libs)[::-1]
        times = {k: [] for k in libs}
        for k in order:
            times[k].append(cs.time_ms(torch, caller(libs[k]), 10))
        row = {"shape": [B, S, d, N], "ms": times}
        print(f"scan_bwd split {json.dumps(row)}", flush=True)
        rows.append(row)
        del args, gy, gh, ckpt, outs, part, dA_part
        torch.cuda.empty_cache()
    out["scan_bwd_split"] = rows


def run_scan_bwd(torch, old_dir, build_dir, out):
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import selective_scan as ss
    old_src = os.path.join(old_dir, "selective_scan_bwd.cu")
    old_so = os.path.join(build_dir, "old_scan_bwd.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", old_so, old_src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {old_src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    old_log = proc.stdout + proc.stderr
    old = ctypes.CDLL(old_so)
    old.selective_scan_bwd_launch.argtypes = OLD_SCAN_BWD_ARGS
    old.selective_scan_bwd_launch.restype = I
    old.selective_scan_bwd_chunk.argtypes = [I]
    old.selective_scan_bwd_chunk.restype = I
    build.load("selective_scan_bwd")
    build.load("selective_scan")
    ptxas = {
        "new": ptxas_lines(build.build_log("selective_scan_bwd"),
                           "selective_scan_bwd_kernel"),
        "old": ptxas_lines(old_log, "selective_scan_bwd_kernel"),
        "forward": ptxas_lines(build.build_log("selective_scan"),
                               "selective_scan_kernel")}
    for k, rows in ptxas.items():
        for fn, usage in rows:
            print(f"ptxas {k} {fn}: {' | '.join(usage)}", flush=True)
    d, N, S = 8192, 16, 4096
    rows = []
    for B in (1, 4):
        args = scan_inputs(torch, B, S, d, N, seed=B)
        g = torch.Generator("cuda").manual_seed(100 + B)
        gy = torch.randn((B, S, d), generator=g, device="cuda")
        gh = torch.randn((B, d, N), generator=g, device="cuda")
        ckpt = ss.selective_scan_fwd(*args, checkpoints=True)[2]
        old_call = old_scan_bwd_caller(torch, old, args, gy, gh)
        calls = {"old": old_call,
                 "new given": lambda: ss.selective_scan_bwd(*args, gy, gh,
                                                            ckpt),
                 "new alone": lambda: ss.selective_scan_bwd(*args, gy, gh)}
        # kept on the host, out of reach of the card's kernels
        want = [w.cpu() for w in ref.selective_scan_bwd(*args, gy, gh)]
        scales = [float(w.abs().max()) for w in want]
        errs, first_errs, bad = {}, {}, []
        for name, fn in calls.items():
            first = [t.cpu() for t in fn()]
            got = [t.cpu() for t in fn()]
            again = [t.cpu() for t in fn()]
            first_errs[name] = [float((a - w).abs().max())
                                for a, w in zip(first, want)]
            errs[name] = [float((a - w).abs().max())
                          for a, w in zip(got, want)]
            if not all(torch.allclose(a, w, rtol=cs.SCAN_BWD_TOL,
                                      atol=cs.SCAN_BWD_TOL * max(sc, 1e-6))
                       for a, w, sc in zip(got, want, scales)):
                bad.append(f"{name} differs from plain")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                bad.append(f"{name}: two runs differ")
            del first, got, again
        del want
        print(f"scan_bwd B={B} S={S}: max_abs_err {json.dumps(errs)}, on "
              f"each one's first call in this process "
              f"{json.dumps(first_errs)}, against scales {scales}",
              flush=True)
        if bad:
            raise RuntimeError(f"scan backward at B={B}: {bad}")
        fwd = {"serving": scan_caller(torch, build.load("selective_scan"),
                                      args, ckpt_arg=True),
               "checkpointing": lambda: ss.selective_scan_fwd(
                   *args, checkpoints=True)}
        cs.spin(torch)
        times = {k: [] for k in calls}
        for k in ("old", "new given", "new alone", "new alone",
                  "new given", "old"):
            times[k].append(cs.time_ms(torch, calls[k], 10))
        ftimes = {k: [] for k in fwd}
        for k in ("serving", "checkpointing", "checkpointing", "serving"):
            ftimes[k].append(cs.time_ms(torch, fwd[k], 10))
        nbytes, flops, exps = cs.scan_bwd_work(B, S, d, N)
        b_ms, b_by, parts = cs.scan_bound(nbytes, flops, exps)
        row = {"shape": [B, S, d, N], "ms": times, "forward_ms": ftimes,
               "max_abs_err": errs, "first_call_max_abs_err": first_errs,
               "scales": scales, "bound_ms": b_ms,
               "bound_by": b_by, "bound_parts_ms": parts}
        print(f"scan_bwd {json.dumps(row)}", flush=True)
        rows.append(row)
        del args, gy, gh, ckpt, calls, fwd, old_call
        torch.cuda.empty_cache()
    out["scan_bwd_ab"] = {"rows": rows, "ptxas": ptxas}


def xent_inputs(torch, T, d, V, seed=0):
    """(h, W, labels, g) bf16 on the card, W contiguous; g like a training
    step's cotangent (mask / count, with some spread)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    h = torch.randn((T, d), generator=gen, device="cuda").bfloat16()
    W = (torch.randn((d, V), generator=gen, device="cuda")
         * d ** -0.5).bfloat16()
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda",
                           dtype=torch.int32)
    g = (torch.rand((T,), generator=gen, device="cuda") + 0.5) / 2048
    return h, W, labels, g


def old_xent_fwd(torch, lib, h, W, labels, tc: bool):
    """A call of the old forward entry (contiguous W, split count by its
    own rule: four blocks an SM over the row tiles, 128-column tiles)."""
    import math
    (T, d), V = h.shape, W.shape[1]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    split = max(1, min(math.ceil(V / 128),
                       math.ceil(4 * n_sm / math.ceil(T / 128))))
    loss = torch.empty((T,), device="cuda")
    lse = torch.empty((T,), device="cuda")
    part = torch.empty((3, split, T), device="cuda")

    def call():
        code = lib.fused_xent_fwd_launch(
            h.data_ptr(), W.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), part.data_ptr(), T, d, V, split, 1, int(tc),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"old xent forward failed: code {code}")
        return loss, lse
    return call


def old_xent_bwd(torch, lib, h, W, labels, lse, g):
    """A call of the old backward entry (W contiguous, V % 8 == 0)."""
    (T, d), V = h.shape, W.shape[1]
    Tp = -(-T // 8) * 8
    hT = torch.zeros((d, Tp), dtype=h.dtype, device="cuda")
    hT[:, :T] = h.t()
    hi = torch.empty((T, V), dtype=torch.bfloat16, device="cuda")
    lo = torch.empty_like(hi)
    dh, dW = torch.empty_like(h), torch.empty_like(W)

    def call():
        code = lib.fused_xent_bwd_launch(
            h.data_ptr(), hT.data_ptr(), W.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            dh.data_ptr(), dW.data_ptr(), T, Tp, d, V,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"old xent backward failed: code {code}")
        return dh, dW
    return call


def check_xent_grads(torch, got, model, what):
    errs = []
    for a, b in zip(got, model):
        sc = float(b.float().abs().max())
        errs.append(float((a.float() - b.float()).abs().max()))
        if not torch.allclose(a.float(), b.float(), rtol=cs.XENT_BWD_RTOL,
                              atol=cs.XENT_BWD_ATOL * sc):
            raise RuntimeError(f"{what}: dh/dW differ from the rounding "
                               f"model: {errs}")
    return errs


def xent_bounds(T, d, V):
    flops = 2 * T * d * V
    f = cs.bound(2 * (T * d + d * V) + 8 * T, flops, cs.BF16_FLOPS_PER_S)
    b = cs.bound(4 * (T * d + d * V) + 12 * T, 3 * flops,
                 cs.BF16_FLOPS_PER_S)
    return {"forward_ms": f[0], "forward_by": f[1], "backward_ms": b[0],
            "backward_by": b[1]}


def run_xent(torch, old_dir, build_dir, out):
    from repro_torch.kernels import fused_xent, ops, ref
    fx, bx = fused_xent.fused_softmax_xent_fwd, fused_xent.fused_softmax_xent_bwd
    old_f = bind(nvcc(os.path.join(old_dir, "fused_xent.cu"),
                      os.path.join(build_dir, "old_xent.so")),
                 "fused_xent_fwd_launch", OLD_XENT_FWD_ARGS)
    old_b = bind(nvcc(os.path.join(old_dir, "fused_xent_bwd.cu"),
                      os.path.join(build_dir, "old_xent_bwd.so")),
                 "fused_xent_bwd_launch", OLD_XENT_BWD_ARGS)
    old_parts = (("dlogits", "xent_dlogits_tc"),
                 ("dh", "xent_grad_gemm_tc_kernel<true>"),
                 ("dW", "xent_grad_gemm_tc_kernel<false>"))
    res = {}

    # -- Llama-3.2-3B's chunk: both versions on the tensor cores ----------
    T, d, V = 1024, 3072, 128256
    h, W, labels, g = xent_inputs(torch, T, d, V)
    want, want_lse = ref.softmax_xent_lse(h, W, labels)
    o_fwd = old_xent_fwd(torch, old_f, h, W, labels, True)
    n_fwd = lambda: fx(h, W, labels)                        # noqa: E731
    ol, olse = (t.clone() for t in o_fwd())
    nl, nlse = fused_xent.fused_softmax_xent_fwd_lse(h, W, labels)
    torch.cuda.synchronize()
    f_err = {"old": float((ol - want).abs().max()),
             "new": float((nl - want).abs().max())}
    for k, (l_, s_) in (("old", (ol, olse)), ("new", (nl, nlse))):
        if not (torch.allclose(l_, want, rtol=cs.XENT_TOL, atol=cs.XENT_TOL)
                and torch.allclose(s_, want_lse, rtol=cs.XENT_TOL,
                                   atol=cs.XENT_TOL)):
            raise RuntimeError(f"{k} xent forward differs from plain: "
                               f"{f_err}")
    lse = want_lse
    model = ref.softmax_xent_bwd_tc(h, W, labels, lse, g)
    o_bwd = old_xent_bwd(torch, old_b, h, W, labels, lse, g)
    n_bwd = lambda: bx(h, W, labels, lse, g)                # noqa: E731
    b_err = {"old": check_xent_grads(torch, [t.clone() for t in o_bwd()],
                                     model, "old backward"),
             "new": check_xent_grads(torch, n_bwd(), model, "new backward")}
    del model
    torch.cuda.empty_cache()
    cs.spin(torch)
    f_old, f_new = turns(torch, o_fwd, n_fwd, 10)
    b_old, b_new = turns(torch, o_bwd, n_bwd, 10)
    split = {}
    for k, fn, parts in (("old", o_bwd, old_parts),
                         ("new", n_bwd, cs.XENT_BWD_PARTS),
                         ("new", n_bwd, cs.XENT_BWD_PARTS),
                         ("old", o_bwd, old_parts)):
        ms = cs.profiled(torch, fn, tuple(p for _, p in parts))[3]
        split.setdefault(k, []).append(dict(zip((n for n, _ in parts), ms)))
    row = {"shape": [T, d, V], "forward_ms": {"old": f_old, "new": f_new},
           "backward_ms": {"old": b_old, "new": b_new},
           "backward_split_ms": split, "forward_max_abs_err": f_err,
           "backward_rounding_model_max_abs_err": b_err,
           "bound_ms": xent_bounds(T, d, V)}
    print(f"xent llama chunk {json.dumps(row)}", flush=True)
    res["llama_chunk"] = row
    del h, W, labels, g, o_bwd, ol, olse, nl, nlse, want, want_lse, lse
    torch.cuda.empty_cache()

    # -- internvl2-2b's odd chunk: the old CUDA-core forward and the plain
    # recompute against the new tensor-core kernels on a pitched W --------
    T, d, V = 1024, 2048, 92553
    h, Wc, labels, g = xent_inputs(torch, T, d, V)
    W = fused_xent.pitched(Wc)
    if fused_xent.tensor_core_route(h, Wc) or not \
            fused_xent.tensor_core_route(h, W):
        raise RuntimeError("internvl2 chunk: the routes are not CUDA cores "
                           "(contiguous W) and tensor cores (pitched W)")
    want, lse = ref.softmax_xent_lse(h, Wc, labels)
    o_fwd = old_xent_fwd(torch, old_f, h, Wc, labels, False)
    n_fwd = lambda: fx(h, W, labels)                        # noqa: E731
    f_err = {"old": float((o_fwd()[0] - want).abs().max()),
             "new": float((n_fwd() - want).abs().max())}
    if max(f_err.values()) > cs.XENT_TOL:
        raise RuntimeError(f"internvl2 chunk forward: {f_err}")
    plain_bwd = lambda: ops._recompute_vjp(                 # noqa: E731
        ref.softmax_xent, (h, Wc, labels), (g,))
    n_bwd = lambda: bx(h, W, labels, lse, g)                # noqa: E731
    model = ref.softmax_xent_bwd_tc(h, Wc, labels, lse, g)
    b_err = {"new": check_xent_grads(torch, n_bwd(), model, "new backward"),
             "plain recompute": check_xent_grads(
                 torch, plain_bwd()[:2], model, "plain recompute")}
    del model
    torch.cuda.empty_cache()
    cs.spin(torch)
    f_old, f_new = turns(torch, o_fwd, n_fwd, 10)
    b_plain, b_new = turns(torch, plain_bwd, n_bwd, 3)
    split = [dict(zip((n for n, _ in cs.XENT_BWD_PARTS), cs.profiled(
        torch, n_bwd, tuple(p for _, p in cs.XENT_BWD_PARTS))[3]))]
    row = {"shape": [T, d, V],
           "forward_ms": {"old CUDA cores": f_old, "new": f_new},
           "backward_ms": {"plain recompute": b_plain, "new": b_new},
           "backward_split_ms": {"new": split}, "forward_max_abs_err": f_err,
           "backward_rounding_model_max_abs_err": b_err,
           "bound_ms": xent_bounds(T, d, V)}
    print(f"xent internvl2 chunk {json.dumps(row)}", flush=True)
    res["internvl2_chunk"] = row
    out["xent_ab"] = res


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", required=True,
                    help="directory holding the old selective_scan.cu, "
                         "fed_gather.cu, fed_local_sgd.cu, "
                         "fed_local_sgd_dense.cu and fed_compress.cu, or "
                         "for --xent fused_xent.cu, fused_xent_bwd.cu, "
                         "xent_tc.cuh and hopper_tc.cuh, or for --scan-bwd "
                         "selective_scan_bwd.cu")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--sgd", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--xent", action="store_true")
    ap.add_argument("--scan-bwd", action="store_true")
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
    if a.split and not (a.compress or a.scan_bwd):
        run_split(torch, os.path.join(a.old_dir, "selective_scan.cu"),
                  a.build_dir, out)
    if a.ab:
        run_ab(torch, a.old_dir, a.build_dir, out)
    if a.sgd:
        run_sgd(torch, a.old_dir, a.build_dir, out)
    if a.compress:
        run_compress(torch, a.old_dir, a.build_dir, out, a.split)
    if a.stamps:
        run_stamps(torch, a.build_dir, out)
    if a.xent:
        run_xent(torch, a.old_dir, a.build_dir, out)
    if a.scan_bwd:
        run_scan_bwd(torch, a.old_dir, a.build_dir, out)
    if a.scan_bwd and a.split:
        run_scan_bwd_split(torch, a.build_dir, out)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
