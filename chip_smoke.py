#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line):

1. print the card (nvidia-smi name and power limit) and build the ten
   CUDA sources from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a, one nvcc per source, started together, and print ptxas'
   registers and spill bytes for every kernel;
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time kernel, plain version and, where one
   exists, the library call (median of per-call CUDA-event times, after a
   clock warm-up, each call queued behind a device spin so that the host's
   launch time is not counted):
   - the cohort gather, bitwise, on the FEMNIST paper-scale federation
     (with n=0, n=max_n and clamped lanes); library ``flat_x[idx]``, timed
     in four turns each with the kernel and a same-size ``Tensor.copy_``
     (the card's copy yardstick), after a flush that leaves the L2 dirty
     and after one that leaves it clean; and on the Sent140 paper-scale
     federation (rows of 25 int32 tokens, the kernel's 4-byte path; K=10,
     max_n=300, an empty, a full and a clamped lane), timed against its
     plain version, ``flat_x[idx]`` and its bound; and (in
     ``experiments_phase``) the same at MNIST-like's K=30 and Synthetic
     (1,1)'s max_n of 2,000;
   - MCLR local SGD within rtol = atol = 2e-5 at K=10, max_n=400, d=784,
     C=26, B=10, max_iters=960 (prox_mu 0 and 0.1) and at the synthetic
     set's shape (d=60, C=10, max_n=2000);
   - dense MLP local SGD (H=64) within rtol 5e-4, atol 5e-5 at the same
     two shapes, budgets random with two zero lanes and one full lane;
   - the top-k + int8 compressor, bitwise, at K=10 with P = 51,930 (the
     MLP) and 20,410 (MCLR), planted threshold ties, a zero row, k=0,
     k=P; ties that straddle the cluster's slices (the cut in a later
     rank than the first tie) and a row of 500,001 on the streamed
     route; its plan (route, cluster size) beside its time; library
     ``torch.topk`` of |ef| (timing only: its tie rule differs);
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
     B=4 at S=512, at the serving path's S=1024, at S=4096 and at
     decode's S=1, within 1e-4, with the error against the plain model of
     its order of operations (``ref.selective_scan_lanes``) printed; timed
     at the prefill and at the decode shape; no library call computes it;
     bound: the largest of its bytes, its float32 flop and its exps at the
     special-function units' rate;
   - the scan's backward (six gradients) at Falcon-Mamba-7B's width
     against its plain reverse recurrence ``ref.selective_scan_bwd``:
     B=1 at train_4k's S=4096, B=4 at S=1024, a ragged S=1000, S=1 and
     N=8, each gradient within rtol 1e-4 and atol 1e-4 of its largest
     magnitude, a second run bitwise the first, and the backward given
     the forward's checkpoints (what training runs) bitwise the one that
     launches the checkpointing forward itself; timed at B=1 and B=4,
     S=4096 both ways, beside the forward's serving and checkpointing
     instances on the same inputs; the plain version timed at B=1 and,
     for scale, the old backward (autograd through the plain
     ``ref.selective_scan``) at S=256; no library call computes it;
     bound: its bytes, float32 flop and exps (``scan_bwd_work``);
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
     vocabulary in a contiguous W (V=50,257, bf16: rows not 16 bytes
     apart) and float32 (both the CUDA-core route), within 1e-4; library
     ``logsumexp(h.float() @ W.float()) - gold``; bound: 2 T d V flop in
     bf16; then its backward kernels at the chunk (dh, dW) against the
     plain recompute (``ref.softmax_xent`` under autograd on the same bf16
     leaves) within rtol 2^-7 and atol 2^-9 max|want| per leaf, the
     rounding model ``ref.softmax_xent_bwd_tc`` printed; library (timing
     only): the autograd backward of the forward's library expression;
     bound: the three products' 3 x 2 T d V flop in bf16; the backward's
     four kernels' split from one profiled call;
   - at the shapes the VLM and the encoder-decoder give them
     (``check_slice_shapes``): the flash forward and backward at
     whisper-tiny's encoder (B=4, S=T=1,500 frames, 6/6 heads, hd 64,
     non-causal, bf16, the last k tile partial) on the tensor cores, and
     the cross-entropy forward and backward on the tensor cores at a
     1,024-row chunk of the odd vocabularies, whisper-tiny (d=384,
     V=51,865), granite-moe (d=1,024, V=49,155) and internvl2-2b
     (d=2,048, V=92,553), W in a ``[d, ceil8(V)]`` buffer whose pad
     columns are NaN, each against its plain version (the backward also
     against its rounding model) and timed beside its bound and library
     call;
3. check the port end to end on small federations: the same server on
   the card and on the CPU, with the same init and minibatch draws, picks
   the same cohorts and workloads; MCLR ends within 2e-5, the MLP with
   top-k + int8 compression within 2/test_n of final accuracy; a small
   Sent140 federation (40 clients, 1,200 tweets, vocabulary 260) trained
   by the LSTM for 3 shuffle rounds: same cohorts and workloads, params
   within 2e-5, accuracy within 2/test_n; each robust aggregator
   (trimmed_mean, median, krum, geometric_median, bulyan, and weighted
   trimmed_mean, multi-Krum and Bulyan) on a fixed [10, 56,962] stack with
   an adversarial row and a dropped client, card against CPU under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host read fails):
   Krum's and Bulyan's chosen clients equal, values within 1e-6 (1e-5 for
   the geometric median); serve
   both LM smoke configs in float32 on the card and on the CPU from the
   same params: the same greedy tokens, logits within 1e-4; and train
   them there: ``train_loss`` and every gradient leaf within 1e-4, and one
   ``SiloFedSAE`` round with the same L, H and step budgets and losses
   and global params within 1e-4; the same for the smoke configs of the
   decoder family, of internvl2-2b (patches before the prompt; the silo
   CLI's token-only batches leave its ``modality_proj`` as it was) and of
   whisper-tiny (frames; silo batches with frames), and for the
   Falcon-Mamba smoke with ``ssm_scan="sequential"`` and
   ``ssm_input_dtype="bfloat16"`` (``SSM_OPTIONS``); the Mamba smokes'
   card side runs the scan and its backward as kernels, and no plain scan
   on a CUDA tensor (``counting_plain``, as in every training leg
   below);
4. the main paths, each with every kernel's launch count set to 0 just
   before and read just after: ``FedSAEServer`` on FEMNIST at paper scale
   (200 clients, K=10), MCLR with algo="ira" for 5 rounds with
   sampling="iid" and 2 with sampling="shuffle", then algo="fedprox"
   (fixed_epochs 15: budgets up to 600 iterations; prox_mu 0.1) for 3 iid
   rounds; the MLP (d=784, H=64, C=26) with algo="ira", sampling="iid" and
   upload_compress="topk_q8" (topk_frac 0.1) for 5 rounds, whose last
   round must keep ``transmitted + residual' == delta + residual``
   bitwise; and the MLP with algo="fedprox" for 3 iid rounds; Sent140 at
   paper scale (772 clients, vocabulary 1,000, 25 tokens) with the paper's
   LSTM (E=32, H=64, P=56,962), K=10, B=10, lr 0.03, for 3 shuffle rounds
   (one gather launch a round) and 2 iid rounds with topk_q8 (one gather
   and one compress launch a round, the identity checked on the last);
   and FEMNIST MCLR iid for 2 rounds under each robust aggregator
   (trimmed_mean, median, krum and bulyan with n_byzantine=1,
   geometric_median; one gather and one SGD launch a round); each leg's
   launches of every kernel are checked (one gather and one SGD launch a
   iid round, one compress launch a compressed round), its budgets per
   round and rounds/s printed; losses, params and residual must be
   finite; then
   ``repro_torch.launch.serve.generate`` at full width with random
   weights, one model after the other: Llama-3.2-3B (batch 4, prompt
   2048, 32 greedy tokens; 28 flash launches, one per layer of the
   prefill, all 28 on the tensor cores) and Falcon-Mamba-7B (batch 4,
   prompt 1024, 32 tokens; 64 scan launches for the prefill and for each
   decode step, 2,048 of them at S=1), with finite logits, prefill ms and
   decode tokens/s;
   then this slice's path,
   cross-silo FedSAE training Llama-3.2-3B at full width and depth
   (``SiloFedSAE``, K=2 silos, max_steps=4, B=1, S=2048, lr 5e-3) for 2
   rounds, with finite losses, L <= H and per local step 56 flash-forward
   calls (28 layers, each recomputed under remat), 28 flash-backward calls
   and 2 fused cross-entropy forward and 2 backward calls (one per
   1,024-position chunk), every flash and cross-entropy call on the tensor
   cores and no plain cross-entropy recompute, round wall, ms per step and
   peak memory, and one ``RoundRecord`` a round in its ``RingBufferSink``
   (``train_loss`` the round's loss, a finite wall time); then
   Falcon-Mamba-7B the same way at full width, cut to
   ``SILO_FALCON_LAYERS`` (32) of its 64 layers (per local step 64 scan
   forwards under remat, 32 scan backwards, 2 cross-entropy forwards and 2
   backwards on the tensor cores; its peak under ``DRYRUN_FIT`` of the
   card); and
   ``repro_torch.launch.train --arch llama3.2-3b --smoke --steps 5`` (2, 2,
   1 and 1 calls per step, all on the tensor cores); then the telemetry
   path (``telemetry_phase``): femnist-iid with and without a
   ``JsonlSink`` bitwise the same, with the same host syncs, the file read
   back, the extras and the byte ledger; mlp-topk's compressed bytes below
   dense; the four stage ranges of a traced round, each holding its FL
   kernels' launches; the port's ``fl_report`` on the file; and, outside
   the count, the sinks' overhead in turns;
   then the failure-handling path (``faults_phase``), at FEMNIST paper
   scale: MCLR iid 5 rounds with nan and with inf uploads (probability
   0.3), each bitwise its ``corrupt="crash"`` twin (params, L/H/theta,
   values, cohorts) with screened uploads recorded; the MLP + topk_q8 5
   rounds with exploded uploads bitwise its twin, residual included;
   diurnal + Pareto + dropout + sign_flip under the median for 5 rounds,
   every loss finite; kill/resume of the MLP + topk_q8 with nan faults (2
   rounds, a checkpoint, a fresh server, 2 more) bitwise 4 straight
   rounds; a small faulted federation card against CPU (same cohorts,
   L/H and screened counts, params within 2e-5); and one full-width
   Llama-3.2-3B silo round without and one with ``screen_norm=1e-6``
   (both silos screened, the global params bitwise the pre-round params),
   each with its peak memory and its aggregate stage's time; every leg's
   launches checked;
   then the device-resident drivers (``scan_phase``), at FEMNIST paper
   scale: each scan run (``driver="scan"``: one round captured as a CUDA
   graph, replayed once a round; any host read inside a block raises, the
   guard checked live first) bitwise its host run with
   ``rng_impl="device"`` (cohorts, budgets, params, L/H/theta, values,
   residual, quarantine counters, records but the wall time): MCLR iid
   Ira 40 rounds in blocks of 16, 16 and 8 with ``host_syncs`` == blocks
   + evals, the MLP + topk_q8 16 rounds, MCLR shuffle one block of 4, nan
   uploads at 0.3 with the screen and quarantine at 0.3; the nan run's
   crash twin on the scan driver; kill/resume at a block boundary; a
   ``JsonlSink`` run bitwise the run without; the rounds/s of the numpy
   host driver, the device-rng host driver and the scan driver in turns,
   one block's device time, the capture's ms and the graph's nodes; small
   federations (MCLR iid, the Sent140 LSTM) on the scan driver card
   against CPU from injected draws: the same cohorts, params within 2e-5;
   the scan legs' launches are each program's real ones (the warm-up's,
   then one capture's times its replays);
   then client-axis sharding and prefetch (``shard_phase``), at FEMNIST
   paper scale, K=10: this process as a world-1 NCCL group, MCLR iid and
   the MLP + topk_q8 on the scan driver (the round's collectives captured
   in its graph, whose nodes are printed beside the replicated one's) and
   on the host driver with device rng, capacity "full" and 10 each
   bitwise the replicated run, capacity 4 (slots overflow) scan bitwise
   host; two gloo ranks spawned on the one card (host driver, device
   rng), each bitwise the world-1 run; ``prefetch="double_buffer"``
   bitwise off on the scan driver; rounds/s of the replicated and the
   world-1 sharded scan in turns;
   then an architecture id as the packed round's local step
   (``lm_fed_phase``, the lanes trained in turn in one [K, ...] stack)
   on a Sent140-like token federation: Llama-3.2-3B at full width and
   depth, K=2, 2 rounds on the numpy host driver (iid, FedAvg,
   uncompressed) with finite losses, L <= H, the peak memory (< 80 GB)
   and the flash and cross-entropy launches its budgets imply (56, 28,
   1 and 1 a local step under remat); the Llama and Falcon-Mamba smoke
   LMs the reference's CLI resolves, on the numpy host driver (iid,
   shuffle, topk_q8, nan uploads bitwise their crash twin), the scan
   driver bitwise the device-rng host driver, a world-1 NCCL sharded
   scan bitwise the replicated one and a scan kill/resume bitwise, each
   leg's launches checked against its budgets and its rounds/s and
   graph nodes printed; and the float32 Llama smoke round card vs CPU
   within 1e-4; granite-moe-1b-a400m (the MoE FFN, 1.38 B params) at
   full width the same way, K=2 on the numpy host driver and K=2 on the
   scan driver, its cross-entropy on the tensor cores (V = 49,155, W
   handed over pitched; no plain recompute, counted); the smoke configs of
   granite-moe, mistral-large-123b, kimi-k2-1t-a32b and the jamba hybrid
   by id (``model=<id>``, as ``fl_train --model <id>``), 2 rounds on the
   scan driver bitwise the device-rng host driver; the LM kernels at these
   legs' shapes (flash at hd = 64 and the jamba smoke's window, the
   cross-entropy at V = 49,155, the scan at the jamba smoke's width, and
   granite-moe's silo shape);
   granite-moe-1b-a400m, Minitron-8B and Granite-8B served at full width
   (batch 4, prompt 2048, 32 tokens; one flash launch a layer of the
   prefill), granite-moe trained cross-silo at full width as Llama is;
   internvl2-2b (1.89 B params) served at full width (batch 4, 512
   patches + 1,536 tokens, 32 tokens; 24 flash launches) and
   whisper-tiny (batch 4, 1,500 frames under a 4-token decoder prompt,
   32 tokens; 4 non-causal and 4 causal flash launches), both trained
   cross-silo at full width (K=2, max_steps 4, 2 rounds; internvl2 at
   B=1, 512 patches + 1,536 tokens, remat; whisper at B=4, 1,500 frames
   under 448 tokens), their cross-entropy on the tensor cores with its
   backward kernels (no plain recompute, counted), and both through
   ``launch.train --smoke``; internvl2-2b as the packed round's local step at full
   width (K=2 host, K=2 scan) and by id at smoke size on every driver
   (topk_q8 too), and ``model="whisper-tiny"`` refused with the
   reference's error;
   and the seed interface's padded round (``padded_phase``:
   ``make_round_fn`` on FEMNIST paper data, K=10, B=10, max_iters 960,
   MCLR and MLP iid 3 rounds each with their fused kernels, MCLR shuffle
   1 round, card vs CPU within 2e-5); the smoke configs of the decoder
   family are served and trained card vs CPU in phase 3 beside Llama's
   and Falcon's; and, outside the count, why the full-width MoE legs
   scale their random expert ``w_down`` by ``MOE_DOWN_SCALE`` and train
   at ``MOE_LR`` (``moe_scale_phase``: the activations' growth through
   granite-moe's 24 layers at either scale, 8 SGD steps at each lr);
   then the paper's experiments (``experiments_phase``,
   ``repro_torch.experiments``, every run ``FedSAEServer`` on the host
   driver with the plain shuffle SGD): the gather bitwise at MNIST-like's
   K=30 (max_n 400, 784 floats) and Synthetic(1,1)'s largest max_n (2,000
   rows of 60 floats), timed; a reduced FEMNIST Ira run card against CPU
   from the same numpy init and shuffle draws (cohorts and workloads
   bitwise, train loss within 2e-5, accuracy within 2/test_n); Table II
   at paper scale on all four datasets, five algorithms each
   (``EXP_TABLE2_ROUNDS`` rounds a run), Figs. 1, 5, 7 and 8 at reduced
   scale (``EXP_FIG_ROUNDS``) and ``examples/paper_scale_fl_torch.py``
   (1,000 clients, K=30, ``EXP_RECIPE_ROUNDS``); each run's CSV line,
   rounds/s and budgets, every final accuracy finite, the gather's
   launches exactly one a round run on the card;
5. profile one steady round of each FL leg (Sent140's shuffle leg too,
   with its device launches per local step), one prefill plus four
   decode steps of each LM, and one full-width silo step (torch.profiler):
   host wall, device time and the kernels that take it.
6. the dry-run and its tooling (``dryrun_phase``), last, so that its
   profiled steps follow every other profiler window: whole steps at
   full width with random float32 weights and bf16 compute
   (``DRYRUN_LEGS``): Llama-3.2-3B train_4k (one 4,096-token row, SGD,
   remat), prefill_32k (B=1) and decode_32k (the mesh's per-device batch
   of 8, or 4 when the trace says its 32,768-slot cache does not fit),
   Falcon-Mamba-7B prefill_32k (B=1) and train_4k (B=1, SGD, remat, 32 of
   its 64 layers: all 64 do not fit the card), each with its median step
   ms (CUDA
   events), its own peak memory beside the trace's estimate on mesh
   (1, 1), the trace's compute, memory and collective terms, the step's
   share of the bf16 peak, its launches (counted like every main path's,
   checked exactly: every flash and cross-entropy call on the tensor
   cores) and one profiled step's top kernels; then ``python -m
   repro_torch.launch.dryrun --all`` (every architecture x shape pair
   traced on the meta device as one device's share of a 16x16 mesh) in
   a subprocess beside the reference scripts' twins (``TWINS``) on the
   card: each must exit 0; the report table and the dry-run's wall time
   printed.

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

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
if os.path.isdir(os.path.join(SRC, "repro_torch")):
    # the H100 rates and the kernels' bound formulas (alone, without the
    # repo's src/, main() says so and exits)
    sys.path.insert(0, SRC)
    from repro_torch.roofline.analysis import (  # noqa: F401
        BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, SFU_PER_S,
        bound, compress_work, dense_sgd_work, flash_bwd_work,
        flash_fwd_work, gather_work, mclr_sgd_work, scan_bound,
        scan_bwd_work, scan_work, xent_bwd_work, xent_fwd_work)
TOL = 2e-5                 # the reference's local-SGD kernel-vs-XLA bound
DENSE_RTOL, DENSE_ATOL = 5e-4, 5e-5   # its MLP pallas-vs-xla bound
LM_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # flash vs plain, by dtype
SCAN_TOL = 1e-4            # the reference's selective-scan kernel bound
# the scan's backward against its plain version, per gradient: rtol 1e-4,
# atol 1e-4 of the gradient's largest magnitude (dA sums B S terms, dB and
# dC d terms, and lam carries a sum over the steps ahead)
SCAN_BWD_TOL = 1e-4
SERVE_TOL = 1e-4           # float32 logits, card vs CPU
BWD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-4)}  # atol, rtol
XENT_TOL = 1e-4            # the reference's fused-xent bound
# the bf16 backward kernels against the plain recompute, per leaf: rtol one
# bf16 ulp, atol 2^-9 of the leaf's largest magnitude
XENT_BWD_RTOL, XENT_BWD_ATOL = 2.0 ** -7, 2.0 ** -9
TRAIN_TOL = 1e-4           # float32 losses, grads and silo params, card/CPU
# the robust aggregators, card against CPU: the rank-based ones (a sort,
# then a sum of at most K values) and the geometric median (eight Weiszfeld
# steps, each a distance summed over every coordinate)
RANK_TOL, GM_TOL = 1e-6, 1e-5
# device cycles of torch.cuda._sleep queued ahead of each timed call (~0.5
# ms at 1.98 GHz): longer than the host takes to enqueue one call, even the
# gather's wrapper on a slow host (a 256 MB flush alone, ~0.08 ms, was not)
QUEUE_CYCLES = 1_000_000


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
        if not m:
            return name
        name, i = sym[m.end():m.end() + int(m.group(1))], \
            m.end() + int(m.group(1))
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


def time_ms(torch, fn, reps: int, flush=None, clean: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` calls, from CUDA events
    around each call.  Each call is queued behind a spin of
    ``QUEUE_CYCLES`` on the device, so that the host has enqueued it
    before the start event fires and its launch time is not counted.
    ``flush`` (a large tensor) is overwritten between calls, outside the
    timed region, so each call finds the L2 cold and ~50 MB of dirty lines
    in it to write back; with ``clean`` it is summed instead (read), so the
    L2 is cold and clean."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum() if clean else flush.zero_()
        torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def reset_counts(counted) -> None:
    """Set every wrapper's launch count (and the flash and cross-entropy
    wrappers' tensor-core counts, the scan's single-step count, the scan
    backward's count of checkpointing forwards of its own) to 0."""
    for fn in counted.values():
        fn.launches = 0
        for extra in ("tensor_core_launches", "single_step_launches",
                      "own_checkpoint_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


def tensor_core_counts(counted) -> dict:
    return {k: fn.tensor_core_launches for k, fn in counted.items()
            if hasattr(fn, "tensor_core_launches")}


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
    flops, nbytes = flash_fwd_work(B, S, S, Hq, Hkv, hd, True)
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


def scan_inputs(torch, B, S, d, N, gen, dev):
    """Seeded scan inputs at Falcon's ranges: dt in [1e-3, 0.101), A the
    Mamba init -(1..N) per channel, the rest standard normal."""
    dt = torch.rand((B, S, d), generator=gen, device=dev) * 0.1 + 1e-3
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
        d, N).contiguous()
    Bm = torch.randn((B, S, N), generator=gen, device=dev)
    Cm = torch.randn((B, S, N), generator=gen, device=dev)
    x = torch.randn((B, S, d), generator=gen, device=dev)
    h0 = torch.randn((B, d, N), generator=gen, device=dev)
    return dt, A, Bm, Cm, x, h0


def check_scan(torch, ss, ref, gen, dev):
    """Phase 2: the selective scan against its plain version at
    Falcon-Mamba-7B's width for S = 512, the serving path's prefill
    S = 1,024, S = 4,096 (error growth) and decode's S = 1 (from a random
    h0), with the error against the plain model of the kernel's order of
    operations (``ref.selective_scan_lanes``) printed; then times at the
    prefill and decode shapes, each with its own bound."""
    B, d, N = 4, 8192, 16
    err = model_err = 0.0
    main = {}
    for S in (512, 1024, 4096, 1):
        args = scan_inputs(torch, B, S, d, N, gen, dev)
        y, hT = ss(*args)
        wy, wh = ref.selective_scan(*args)
        my, mh = ref.selective_scan_lanes(*args)
        torch.cuda.synchronize()
        e = max(float((y - wy).abs().max()), float((hT - wh).abs().max()))
        em = max(float((y - my).abs().max()), float((hT - mh).abs().max()))
        print(f"selective_scan_fwd B={B} S={S} d={d} N={N}: max_abs_err "
              f"{e:.3e} (tol {SCAN_TOL}); against the lane model "
              f"ref.selective_scan_lanes {em:.3e}", flush=True)
        if not (torch.allclose(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
                and torch.allclose(hT, wh, rtol=SCAN_TOL, atol=SCAN_TOL)):
            raise RuntimeError(f"scan kernel differs from plain (S={S})")
        if not (torch.isfinite(y).all() and torch.isfinite(hT).all()):
            raise RuntimeError(f"scan kernel: non-finite (S={S})")
        err, model_err = max(err, e), max(model_err, em)
        if S in (1024, 1):
            main[S] = args
        del args, y, hT, wy, wh, my, mh
    spin(torch)
    row = {"max_abs_err": err, "lane_model_max_abs_err": model_err}
    for S, key in ((1024, ""), (1, "decode_")):
        args = main[S]
        ms = time_ms(torch, lambda: ss(*args), 20 if S > 1 else 200)
        plain = time_ms(torch, lambda: ref.selective_scan(*args),
                        3 if S > 1 else 20)
        nbytes, flops, exps = scan_work(B, S, d, N)
        b_ms, b_by, parts = scan_bound(nbytes, flops, exps)
        print(f"selective_scan_fwd B={B} S={S} d={d} N={N}: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; bytes {parts['bytes']:.4f} ms for {nbytes} B, "
              f"operations {parts['operations']:.4f} ms for {flops} flop, "
              f"exp {parts['exp']:.4f} ms for {exps} exp)", flush=True)
        row.update({f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}bound_ms": b_ms, f"{key}bound_by": b_by,
                    f"{key}bound_parts_ms": parts})
    row["library_ms"] = None
    return row


def check_scan_bwd(torch, sb, ss, ops, ref, gen, dev):
    """Phase 2: the scan's backward against its plain reverse recurrence
    (``ref.selective_scan_bwd``) at Falcon-Mamba-7B's width (d = 8,192,
    N = 16): B = 1 at train_4k's S = 4,096 (the whole-step leg's shape),
    B = 4 at S = 1,024, a ragged S = 1,000, S = 1, and N = 8; each of the
    six gradients within rtol 1e-4 and atol 1e-4 of its largest magnitude
    (``SCAN_BWD_TOL``), a second run bitwise the first, and the backward
    given the checkpoints of the forward's checkpointing instance (what
    training runs) bitwise the one that launches that forward itself.
    Then times at B = 1 and B = 4, S = 4,096, each beside its bound
    (``scan_bwd_work``: bytes, float32 flop and exps): the backward given
    the forward's checkpoints (the row's ``ms``) and alone (``alone_ms``,
    the checkpointing forward included), and the forward's serving and
    checkpointing instances on the same inputs; the plain version's at
    B = 1, S = 4,096 (one call, host clock around a device sync: it
    launches ~15 kernels a step); and, for scale only, the old backward
    (autograd through the plain ``ref.selective_scan``, quadratic in S)
    at S = 256.  No library call computes it."""
    d = 8192
    err = rel = 0.0
    for B, S, N in ((1, 4096, 16), (4, 1024, 16), (2, 1000, 16),
                    (4, 1, 16), (2, 333, 8)):
        args = scan_inputs(torch, B, S, d, N, gen, dev)
        gy = torch.randn((B, S, d), generator=gen, device=dev)
        gh = torch.randn((B, d, N), generator=gen, device=dev)
        ckpt = ss(*args, checkpoints=True)[2]
        got = sb(*args, gy, gh, ckpt)
        again = sb(*args, gy, gh, ckpt)
        alone = sb(*args, gy, gh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref.selective_scan_bwd(*args, gy, gh)
        torch.cuda.synchronize()
        if (B, S) == (1, 4096):      # one call: ~60k launches, 2-3 s
            plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        scales = [float(w.abs().max()) for w in want]
        print(f"selective_scan_bwd B={B} S={S} d={d} N={N}: max_abs_err "
              f"(ddt, dA, dB, dC, dx, dh0) "
              f"{[float(f'{e:.3e}') for e in errs]} against scales "
              f"{[float(f'{v:.3e}') for v in scales]} (rtol "
              f"{SCAN_BWD_TOL}, atol {SCAN_BWD_TOL} x scale)", flush=True)
        if not all(torch.allclose(g, w, rtol=SCAN_BWD_TOL,
                                  atol=SCAN_BWD_TOL * max(sc, 1e-6))
                   for g, w, sc in zip(got, want, scales)):
            raise RuntimeError(f"scan backward differs from plain (B={B}, "
                               f"S={S}, N={N})")
        if not all(torch.isfinite(g).all() for g in got):
            raise RuntimeError(f"scan backward: non-finite (S={S})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"scan backward: two runs differ (S={S})")
        if not all(torch.equal(a, b) for a, b in zip(got, alone)):
            raise RuntimeError(f"scan backward: the forward's checkpoints "
                               f"and its own give different bits (S={S})")
        err = max(err, *errs)
        rel = max(rel, *(e / max(sc, 1e-6) for e, sc in zip(errs, scales)))
        del args, gy, gh, ckpt, got, again, alone, want
        torch.cuda.empty_cache()
    spin(torch)
    row = {"max_abs_err": err, "max_err_over_scale": rel,
           "plain_ms": plain_ms, "library_ms": None}
    N, S = 16, 4096
    for B, key in ((1, ""), (4, "B4_")):
        args = scan_inputs(torch, B, S, d, N, gen, dev)
        gy = torch.randn((B, S, d), generator=gen, device=dev)
        gh = torch.randn((B, d, N), generator=gen, device=dev)
        ckpt = ss(*args, checkpoints=True)[2]
        ms = time_ms(torch, lambda: sb(*args, gy, gh, ckpt), 10)
        alone = time_ms(torch, lambda: sb(*args, gy, gh), 10)
        fwd = time_ms(torch, lambda: ss(*args), 10)
        fwd_ck = time_ms(torch, lambda: ss(*args, checkpoints=True), 10)
        nbytes, flops, exps = scan_bwd_work(B, S, d, N)
        b_ms, b_by, parts = scan_bound(nbytes, flops, exps)
        row.update({f"{key}ms": ms, f"{key}alone_ms": alone,
                    f"{key}fwd_ms": fwd, f"{key}fwd_checkpointing_ms": fwd_ck,
                    f"{key}bound_ms": b_ms, f"{key}bound_by": b_by,
                    f"{key}bound_parts_ms": parts})
        print(f"selective_scan_bwd B={B} S={S} d={d} N={N}: kernel "
              f"{ms:.4f} ms given the forward's checkpoints, {alone:.4f} ms "
              f"alone (the checkpointing forward first); the forward "
              f"{fwd:.4f} ms serving, {fwd_ck:.4f} ms checkpointing; "
              f"plain {f'{plain_ms:.1f}' if B == 1 else '-'}"
              f" ms, bound {b_ms:.4f} ms ({b_by}; bytes "
              f"{parts['bytes']:.4f} ms for {nbytes} B, operations "
              f"{parts['operations']:.4f} ms for {flops} flop, exp "
              f"{parts['exp']:.4f} ms for {exps} exp)", flush=True)
        del args, gy, gh, ckpt
        torch.cuda.empty_cache()
    S = 256
    args = scan_inputs(torch, 1, S, d, N, gen, dev)
    gy = torch.randn((1, S, d), generator=gen, device=dev)
    gh = torch.randn((1, d, N), generator=gen, device=dev)
    row["old_recompute_S256_ms"] = time_ms(torch, lambda: ops._recompute_vjp(
        ref.selective_scan, args, (gy, gh)), 1)
    row["S256_alone_ms"] = time_ms(torch, lambda: sb(*args, gy, gh), 10)
    print(f"selective_scan_bwd B=1 S={S} d={d} N={N}: kernel alone "
          f"{row['S256_alone_ms']:.4f} ms; the old backward (autograd "
          f"through ref.selective_scan, quadratic in S) "
          f"{row['old_recompute_S256_ms']:.4f} ms", flush=True)
    return row


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
    flops, nbytes = flash_bwd_work(B, S, S, Hq, Hkv, hd, True)
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
    at Llama-3.2-3B's loss chunk (tensor cores), a ragged vocabulary in a
    contiguous bf16 W (V = 50,257: its rows are not 16 bytes apart, so the
    CUDA cores) and float32 (CUDA cores), then its backward kernels at the
    chunk against the plain recompute; then times (``xent_times``).
    Returns the forward's and the backward's JSON fields (launches filled
    in later)."""
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

    spin(torch)
    f_row, b_row = xent_times(torch, fx, bx, ops, ref, h, W, labels, lse, g)
    f_row["max_abs_err"] = err
    b_row.update(max_abs_err=max(b_err),
                 rounding_model_max_abs_err=max(m_err))
    return f_row, b_row


#: the backward's kernels in a profile: (label, name fragment)
XENT_BWD_PARTS = (("dlogits", "xent_dlogits_tc"), ("dh", "xent_dh_tc"),
                  ("dh sum", "xent_dh_reduce"), ("dW", "xent_dw_tc"))


def xent_times(torch, fx, bx, ops, ref, h, W, labels, lse, g, tag=""):
    """Times of the cross-entropy forward and backward on (h, W, labels)
    and the loss cotangent g, each beside its plain version, its bound and
    its library yardstick (timing only): the forward against
    ``logsumexp(h.float() @ W.float()) - gold``, the backward against that
    expression's autograd backward (its graph built once); and the
    backward's split by kernel from one profiled call.  Returns the
    forward's and the backward's JSON fields (no errors, no launches)."""
    (T, d), V = h.shape, W.shape[1]
    hg, Wg = (t.detach().float().requires_grad_() for t in (h, W))

    def library_expr(a, b):
        logits = a @ b
        return (torch.logsumexp(logits, -1)
                - logits.gather(1, labels.long()[:, None])[:, 0])

    out = library_expr(hg, Wg)
    ms = time_ms(torch, lambda: fx(h, W, labels), 10)
    plain = time_ms(torch, lambda: ref.softmax_xent(h, W, labels), 5)
    lib = time_ms(torch, lambda: library_expr(h.float(), W.float()), 5)
    b_ms = time_ms(torch, lambda: bx(h, W, labels, lse, g), 10)
    b_plain = time_ms(torch, lambda: ops._recompute_vjp(
        ref.softmax_xent, (h, W, labels), (g,)), 3)
    b_lib = time_ms(torch, lambda: torch.autograd.grad(
        out, (hg, Wg), g, retain_graph=True), 3)
    del out, hg, Wg
    split_ms = profiled(torch, lambda: bx(h, W, labels, lse, g),
                        tuple(p for _, p in XENT_BWD_PARTS))[3]
    flops, nbytes = xent_fwd_work(T, d, V)
    f_bound, f_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    b_flops, b_bytes = xent_bwd_work(T, d, V)
    b_bound, b_by = bound(b_bytes, b_flops, BF16_FLOPS_PER_S)
    split = dict(zip((k for k, _ in XENT_BWD_PARTS), split_ms))
    print(f"fused_softmax_xent_fwd {tag}T={T} d={d} V={V} bf16 (tensor "
          f"cores): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain:.4f} ms, logsumexp(h.float() @ W.float()) - gold "
          f"{lib:.4f} ms, bound {f_bound:.4f} ms ({f_by}: {flops} flop, "
          f"{nbytes} B)", flush=True)
    print(f"fused_softmax_xent_bwd {tag}T={T} d={d} V={V} bf16 (tensor "
          f"cores): kernels {b_ms:.4f} ms ({b_flops / b_ms / 1e9:.1f} "
          f"TFLOP/s of useful work), plain recompute {b_plain:.4f} ms, the "
          f"library expression's backward {b_lib:.4f} ms, bound "
          f"{b_bound:.4f} ms ({b_by}: {b_flops} flop, {b_bytes} B); one "
          f"call profiled: {json.dumps(split)}", flush=True)
    return ({"ms": ms, "plain_ms": plain, "bound_ms": f_bound,
             "bound_by": f_by, "library_ms": lib},
            {"ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
             "bound_by": b_by, "library_ms": b_lib, "profiled_ms": split})


def check_slice_shapes(torch, counted, ref, gen, dev):
    """Phase 2: the kernels at the shapes the VLM and the encoder-decoder
    give them, against their plain versions, then times beside their
    bounds: the flash forward and backward at whisper-tiny's encoder
    (B=4, S=T=1,500 frames, 6/6 heads, hd 64, non-causal, bf16: the last
    k tile partial), on the tensor cores, with their rounding-model
    errors; library ``F.scaled_dot_product_attention`` (its backward for
    the backward); and the fused cross-entropy forward and backward on the
    tensor cores at a 1,024-row chunk of whisper-tiny (d=384, V=51,865),
    granite-moe (d=1,024, V=49,155) and internvl2-2b (d=2,048, V=92,553):
    no V is a multiple of 8, so W is built as ``chunked_lm_loss`` builds
    it, in a ``[d, ceil8(V)]`` buffer, its pad columns NaN; the forward
    against its plain version, the backward against the rounding model
    ``ref.softmax_xent_bwd_tc`` and the plain recompute; times from
    ``xent_times``.  Bounds: the flash's unmasked pairs at 4 (forward) or
    10 (backward) hd flop each, the cross-entropy's 2 T d V (3 of them
    backward), all at the bf16 tensor cores' rate, or the bytes,
    whichever is larger.  Returns {kernel: {shape label: fields}}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_xent import (fused_softmax_xent_fwd_lse,
                                                pitched, tensor_core_route)
    fa, fa_bwd = counted["flash_attention_fwd"], counted["flash_attention_bwd"]
    fx, bx = counted["fused_softmax_xent_fwd"], counted["fused_softmax_xent_bwd"]
    out = {"flash_attention_fwd": {}, "flash_attention_bwd": {},
           "fused_softmax_xent_fwd": {}, "fused_softmax_xent_bwd": {}}
    B, S, H, hd = 4, 1500, 6, 64
    label = f"whisper-tiny encoder B={B} S=T={S} {H}/{H} hd={hd} non-causal"
    q, k, v, do = (torch.randn((B, S, H, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    tc0 = fa.tensor_core_launches
    o, lse = fa(q, k, v, False, 0)
    want, want_lse = ref.attention_lse(q, k, v, causal=False)
    model = ref.attention_lse_tc(q, k, v, causal=False)[0]
    torch.cuda.synchronize()
    tol = LM_TOL["bfloat16"]
    err = float((o.float() - want.float()).abs().max())
    e_lse = float((lse - want_lse).abs().max())
    e_model = float((o.float() - model.float()).abs().max())
    if fa.tensor_core_launches != tc0 + 1:
        raise RuntimeError(f"flash forward took the wrong route ({label})")
    if not (torch.isfinite(o).all() and torch.allclose(
            o.float(), want.float(), rtol=tol, atol=tol)
            and torch.allclose(lse, want_lse, rtol=2e-5, atol=2e-5)):
        raise RuntimeError(f"flash kernel differs from plain ({label}): out "
                           f"{err}, lse {e_lse}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    spin(torch)
    ms = time_ms(torch, lambda: fa(q, k, v, False, 0), 20)
    plain = time_ms(torch, lambda: ref.attention_lse(q, k, v, causal=False),
                    3)
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                  20)
    flops, nbytes = flash_fwd_work(B, S, S, H, H, hd, False)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    out["flash_attention_fwd"][label] = dict(
        max_abs_err=err, lse_max_abs_err=e_lse,
        rounding_model_max_abs_err=e_model, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    print(f"flash_attention_fwd {label} bf16 (tensor cores): out max_abs_err "
          f"{err:.3e} (tol {tol}), lse {e_lse:.3e}, rounding model "
          f"{e_model:.3e}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}: {flops} flop, {nbytes} B)", flush=True)

    o = want.contiguous()
    tc0 = fa_bwd.tensor_core_launches
    got = fa_bwd(q, k, v, o, want_lse, do, False, 0)
    wants = ref.flash_attention_bwd(q, k, v, o, want_lse, do, causal=False)
    models = ref.flash_attention_bwd_tc(q, k, v, o, want_lse, do,
                                        causal=False)
    torch.cuda.synchronize()
    atol, rtol = BWD_TOL["bfloat16"]
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, wants)]
    e_model = max(float((g.float() - m.float()).abs().max())
                  for g, m in zip(got, models))
    if fa_bwd.tensor_core_launches != tc0 + 1:
        raise RuntimeError(f"flash backward took the wrong route ({label})")
    if not all(torch.isfinite(g).all() and torch.allclose(
            g.float(), w.float(), rtol=rtol, atol=atol)
            for g, w in zip(got, wants)):
        raise RuntimeError(f"flash bwd kernel differs from plain ({label}): "
                           f"dq/dk/dv {errs}")
    del got, wants, models
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    og = F.scaled_dot_product_attention(qg, kg, vg)
    dot = do.transpose(1, 2)
    spin(torch)
    ms = time_ms(torch, lambda: fa_bwd(q, k, v, o, want_lse, do, False, 0),
                 20)
    plain = time_ms(torch, lambda: ref.flash_attention_bwd(
        q, k, v, o, want_lse, do, causal=False), 3)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        og, (qg, kg, vg), dot, retain_graph=True), 20)
    flops, nbytes = flash_bwd_work(B, S, S, H, H, hd, False)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    out["flash_attention_bwd"][label] = dict(
        max_abs_err=max(errs), rounding_model_max_abs_err=e_model, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    print(f"flash_attention_bwd {label} bf16 (tensor cores): dq/dk/dv "
          f"max_abs_err {errs} (atol {atol}, rtol {rtol}), rounding model "
          f"{e_model:.3e}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain:.4f} ms, sdpa backward {lib:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {flops} flop, {nbytes} B)",
          flush=True)
    del q, k, v, do, o, lse, want, want_lse, model, qg, kg, vg, og
    torch.cuda.empty_cache()

    T = 1024
    for arch, d, V in (("whisper-tiny", 384, 51865),
                       ("granite-moe-1b-a400m", 1024, 49155),
                       ("internvl2-2b", 2048, 92553)):
        label = f"{arch} chunk T={T} d={d} V={V}"
        h = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
        W = nan_padded(pitched, (torch.randn(
            (d, V), generator=gen, device=dev) * d ** -0.5).to(
                torch.bfloat16))
        labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                               dtype=torch.int32)
        if not tensor_core_route(h, W):
            raise RuntimeError(f"{label}: a pitched W (strides "
                               f"{W.stride()}) must take the tensor cores")
        tc0, n0 = fx.tensor_core_launches, fx.launches
        got, lse = fused_softmax_xent_fwd_lse(h, W, labels)
        want, want_lse = ref.softmax_xent_lse(h, W, labels)
        torch.cuda.synchronize()
        if fx.launches != n0 + 1 or fx.tensor_core_launches != tc0 + 1:
            raise RuntimeError(f"xent forward took the wrong route ({label})")
        err = float((got - want).abs().max())
        e_lse = float((lse - want_lse).abs().max())
        if not (torch.isfinite(got).all() and torch.allclose(
                got, want, rtol=XENT_TOL, atol=XENT_TOL)
                and torch.allclose(lse, want_lse, rtol=XENT_TOL,
                                   atol=XENT_TOL)):
            raise RuntimeError(f"xent kernel differs from plain ({label}): "
                               f"{err}, lse {e_lse}")
        g = (torch.rand((T,), generator=gen, device=dev) + 0.5) / 2048
        tc0 = bx.tensor_core_launches
        dh, dW = bx(h, W, labels, lse, g)
        models = ref.softmax_xent_bwd_tc(h, W, labels, lse, g)
        wants = ops._recompute_vjp(ref.softmax_xent, (h, W, labels),
                                   (g,))[:2]
        torch.cuda.synchronize()
        if bx.tensor_core_launches != tc0 + 1 or dW.shape != (d, V):
            raise RuntimeError(f"xent backward: route or dW shape "
                               f"{tuple(dW.shape)} ({label})")
        b_err, m_err = [], []
        for got_g, model, want_g in zip((dh, dW), models, wants):
            for errs, ref_g in ((m_err, model), (b_err, want_g)):
                sc = float(ref_g.float().abs().max())
                errs.append(float((got_g.float() - ref_g.float())
                                  .abs().max()))
                if not (torch.isfinite(got_g).all() and torch.allclose(
                        got_g.float(), ref_g.float(), rtol=XENT_BWD_RTOL,
                        atol=XENT_BWD_ATOL * sc)):
                    raise RuntimeError(f"xent backward differs from its "
                                       f"plain version ({label}): dh/dW "
                                       f"model {m_err}, recompute {b_err}")
        print(f"fused_softmax_xent {label} bf16, W pitched with NaN pads "
              f"(tensor cores): forward max_abs_err {err:.3e}, lse "
              f"{e_lse:.3e} (tol {XENT_TOL}); backward dh/dW against the "
              f"rounding model {m_err}, against the plain recompute "
              f"{b_err} (rtol 2^-7, atol 2^-9 max|want|)", flush=True)
        del got, want, want_lse, dh, dW, models, wants
        torch.cuda.empty_cache()
        spin(torch)
        f_row, b_row = xent_times(torch, fx, bx, ops, ref, h, W, labels,
                                  lse, g, tag=f"{arch} chunk ")
        out["fused_softmax_xent_fwd"][label] = dict(
            f_row, max_abs_err=err, lse_max_abs_err=e_lse,
            route="tensor cores")
        out["fused_softmax_xent_bwd"][label] = dict(
            b_row, max_abs_err=max(b_err),
            rounding_model_max_abs_err=max(m_err), route="tensor cores")
        del h, W, lse
        torch.cuda.empty_cache()
    return out


def xent_on_tensor_cores(cfg) -> bool:
    """Whether a config's loss takes the cross-entropy's tensor-core route:
    bfloat16 compute and d a multiple of 8, whatever the vocabulary
    (``chunked_lm_loss`` hands the kernels W in a ``[d, ceil8(V)]``
    buffer)."""
    import torch
    return cfg.compute_dtype == torch.bfloat16 and cfg.d_model % 8 == 0


def nan_padded(pitched, W):
    """``pitched(W)`` (``fused_xent.pitched``) with the buffer's pad
    columns (at and past V) set to NaN, so that a kernel that reads past V
    shows it."""
    P = pitched(W)
    P.as_strided((P.shape[0], P.stride(0) - P.shape[1]), P.stride(),
                 P.storage_offset() + P.shape[1]).fill_(float("nan"))
    return P


#: the plain scan and its plain backward, which no training leg may run on
#: the card (its forward and backward are the kernels)
PLAIN_SCANS = ("selective_scan", "selective_scan_bwd")


@contextlib.contextmanager
def counting_plain(ref, *names):
    """While the block runs, record every call of the plain versions
    ``names`` of ``kernels.ref`` on a CUDA tensor: yields a list that gets
    the function's name a call.  Counts the plain ``softmax_xent``
    recompute (the cross-entropy op's backward off the tensor-core route)
    and the ``PLAIN_SCANS``."""
    plain = {k: getattr(ref, k) for k in names}
    calls = []

    def counted(name):
        def call(*a, **kw):
            if a[0].device.type == "cuda":
                calls.append(name)
            return plain[name](*a, **kw)
        return call

    for k in plain:
        setattr(ref, k, counted(k))
    try:
        yield calls
    finally:
        for k, fn in plain.items():
            setattr(ref, k, fn)


def silo_batches(torch, cfg, K, max_steps, B, S, ri, device, patches=False):
    """One round's batches as ``launch.fl_train.run_silo`` makes them: its
    token stream, labels = the tokens.  An encoder-decoder's steps also
    carry S frames [B, S, 128] from ``ri.normal``, under min(
    max_decoder_len, S) tokens (the CLI's token-only batches cannot train
    one); with ``patches`` a VLM's steps carry P = min(n_patches, S // 4)
    patches [B, P, 1024] before S - P tokens, drawn after them from
    ``ri.normal`` (without it, the CLI's token-only batches)."""
    from repro_torch.launch.fl_train import silo_tokens
    from repro_torch.models.api import VLM_FRONTEND_DIM
    from repro_torch.models.encdec import FRONTEND_DIM
    normal = lambda *shape: torch.as_tensor(ri.normal(size=shape),
                                            dtype=torch.float32,
                                            device=device)
    patches = patches and cfg.n_patches
    T, extra = S, {}
    if cfg.is_encoder_decoder:
        T = min(cfg.max_decoder_len, S)
    elif patches:
        T = S - min(cfg.n_patches, S // 4)
    toks = torch.as_tensor(silo_tokens(ri, cfg, K, max_steps, B, T),
                           device=device)
    if cfg.is_encoder_decoder:
        extra["frames"] = normal(K, max_steps, B, S, FRONTEND_DIM)
    elif patches:
        extra["patches"] = normal(K, max_steps, B, S - T, VLM_FRONTEND_DIM)
    return dict(extra, tokens=toks, labels=toks)


def train_card_vs_cpu(torch, np, get_config, build_model, train, arch,
                      over=None):
    """Phase 3: a smoke config (with ``over``'s fields) trained in float32
    on the card and on the CPU from the same params: train_loss and every
    gradient leaf (a VLM's and an encoder-decoder's batch the train CLI's,
    ``train.synth_batch_from``), then one SiloFedSAE round each on the
    silo CLI's batches (an encoder-decoder's with frames); a VLM's
    token-only silo round leaves its ``modality_proj`` as it was (a zero
    gradient; FedAvg of the equal rows within 1e-6 of it).  A Mamba
    layer's scan and its backward run as the kernels on the card: the
    plain scan must not run on a CUDA tensor (``counting_plain``)."""
    from repro_torch.convert import params_from_reference, params_to_numpy
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               **(over or {}))
    model = build_model(cfg)
    init = params_to_numpy(model.init(torch.Generator("cpu").manual_seed(0)))
    ri = np.random.default_rng(3)
    if cfg.is_encoder_decoder or cfg.n_patches:
        batch = {k: v.numpy() for k, v in train.synth_batch_from(
            cfg, ri, 2, 64).items()}
    else:
        toks = ri.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
    runs, feds = [], []
    with counting_plain(ref, *PLAIN_SCANS) as plain_calls:
        for where in ("cuda", "cpu"):
            params = params_from_reference(init, where)
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = model.train_loss(params, {
                k: torch.as_tensor(v, device=where)
                for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
            runs.append((float(loss.detach()), [g.cpu() for g in grads]))
        for where in ("cuda", "cpu"):
            fed = SiloFedSAE(model, 2, lr=5e-3, max_steps=3,
                             init_params=init, device=where)
            fed.run_round(silo_batches(torch, cfg, 2, 3, 2, 32,
                                       np.random.default_rng(4), where),
                          np.array([300, 700]))
            feds.append(fed)
    if plain_calls:
        raise RuntimeError(f"{arch} smoke: the plain scan ran on the card "
                           f"({plain_calls[:4]}...)")
    (l_card, g_card), (l_cpu, g_cpu) = runs
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    if abs(l_card - l_cpu) > TRAIN_TOL * (1 + abs(l_cpu)) or not all(
            torch.allclose(a, b, rtol=TRAIN_TOL, atol=TRAIN_TOL)
            for a, b in zip(g_card, g_cpu)):
        raise RuntimeError(f"{arch} smoke: card and CPU train_loss {l_card} "
                           f"vs {l_cpu}, grads differ by {g_err}")
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
    note = ""
    if cfg.n_patches:
        proj = on_card.params["modality_proj"].cpu()
        want = torch.from_numpy(init["modality_proj"])
        moved = float((proj - want).abs().max())
        if not torch.allclose(proj, want, rtol=1e-6, atol=0):
            raise RuntimeError(f"{arch} token-only silo round moved "
                               f"modality_proj by {moved}")
        note = (f"; token-only batches: modality_proj unchanged (max_abs "
                f"{moved:.3e}, FedAvg's rounding)")
    label = f"{arch}{' ' + json.dumps(over) if over else ''}"
    print(f"train {label} smoke float32, card vs CPU: train_loss "
          f"{l_card:.6f} vs {l_cpu:.6f}, grads max_abs_err {g_err:.3e}; one "
          f"SiloFedSAE round (budgets {on_card.last_n_steps.tolist()}): same "
          f"L/H, params max_abs_err {p_err:.3e}, loss diff {loss_err:.3e} "
          f"(tol {TRAIN_TOL}){note}", flush=True)


def silo_path(torch, np, get_config, build_model, counted, ref, rounds=2,
              arch="llama3.2-3b", lr=5e-3, B=1, S=2048, layers=None):
    """Phase 4 (and 5): cross-silo FedSAE training ``arch`` at full width
    and depth (``layers`` of them where given), K=2 silos, B rows of S
    positions a step (a VLM's
    S // 4 of them patches, an encoder-decoder's S frames under
    min(448, S) tokens: ``silo_batches``).  Every kernel's count is set
    to 0 just before the counted rounds and read just after; each local
    step must launch one flash forward an attention layer, two on a
    decoder under remat (56 for Llama-3.2-3B's 28 layers; the
    encoder-decoder's encoder and decoder layers once each), one flash
    backward a layer and one cross-entropy forward a loss chunk (1,024
    token positions, or one chunk of them all where 1,024 does not divide
    them), every flash call on the tensor cores.  On the cross-entropy's
    tensor-core route (bf16, d a multiple of 8: ``xent_on_tensor_cores``,
    the odd vocabularies included: granite-moe's V = 49,155, internvl2's
    92,553, whisper's 51,865) a step launches a backward a chunk and the
    plain ``ref.softmax_xent`` recompute must not run; off it the forward
    takes the CUDA cores and each chunk's backward is that plain recompute
    (counted, printed).  A Mamba layer launches the scan forward once a
    step, twice under remat, and its backward once, and neither plain scan
    may run on the card (``counting_plain``)."""
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.obs import RingBufferSink
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    xent_tc = xent_on_tensor_cores(cfg)
    if cfg.is_encoder_decoder:
        n_attn, n_mamba = cfg.n_encoder_layers + cfg.n_layers, 0
        fwd_per_attn = 1
    else:
        (n_attn, n_mamba), fwd_per_attn = mixer_layers(cfg), \
            1 + bool(cfg.remat)
    model = build_model(cfg)
    K, max_steps = 2, 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ring = RingBufferSink()
    fed = SiloFedSAE(dataclasses.replace(model, init=tamed_init(model.init,
                                                                cfg)),
                     K, lr=lr, max_steps=max_steps, seed=0, sink=ring)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(fed.params))
    ri = np.random.default_rng(0)
    sizes = np.asarray(ri.integers(100, 1000, K))
    all_batches = [silo_batches(torch, cfg, K, max_steps, B, S, ri, "cuda",
                                patches=True) for _ in range(rounds)]
    T_tok = all_batches[0]["tokens"].shape[-1]
    reset_counts(counted)
    rounds_out = []
    with counting_plain(ref, "softmax_xent") as recomputes, \
            counting_plain(ref, *PLAIN_SCANS) as plain_scans:
        for r in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = fed.run_round(all_batches[r], sizes)
            torch.cuda.synchronize()
            rounds_out.append(dict(wall_s=time.perf_counter() - t0,
                                   n_steps=fed.last_n_steps.tolist(),
                                   loss=stats["loss"][-1],
                                   L=fed.L.tolist(), H=fed.H.tolist()))
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
    recs = ring.records
    if ([r.round for r in recs] != list(range(rounds))
            or [r.train_loss for r in recs] != stats["loss"]
            or not all(math.isfinite(r.wall_time_s) for r in recs)):
        raise RuntimeError(f"silo records {[r.to_json() for r in recs]}, "
                           f"losses {stats['loss']}")
    chunks = T_tok // 1024 if T_tok % 1024 == 0 else 1
    want = {"fused_softmax_xent_fwd": chunks * steps,
            "fused_softmax_xent_bwd": chunks * steps if xent_tc else 0}
    if n_attn:
        want["flash_attention_fwd"] = fwd_per_attn * n_attn * steps
        want["flash_attention_bwd"] = n_attn * steps
    if n_mamba:
        want["selective_scan_fwd"] = fwd_per_attn * n_mamba * steps
        want["selective_scan_bwd"] = n_mamba * steps
    own_ckpt = counted["selective_scan_bwd"].own_checkpoint_launches
    if {k: launches[k] for k in want} != want or any(
            launches[k] for k in launches if k not in want) or plain_scans \
            or own_ckpt:
        raise RuntimeError(f"silo path {arch} launched {launches} in "
                           f"{steps} steps, wanted {want}; the plain scan "
                           f"ran {len(plain_scans)} times on the card; the "
                           f"scan backward ran {own_ckpt} checkpointing "
                           f"forwards of its own")
    # every flash call of the bf16 path on the tensor cores; the
    # cross-entropy on its route, its backward the kernel there or the
    # plain recompute on the CUDA-core route
    want_tc = {k: want.get(k, 0) for k in tc_launches}
    if not xent_tc:
        want_tc["fused_softmax_xent_fwd"] = 0
    want_recomputes = 0 if xent_tc else chunks * steps
    if tc_launches != want_tc or len(recomputes) != want_recomputes:
        raise RuntimeError(f"silo path {arch}: tensor-core launches "
                           f"{tc_launches}, wanted {want_tc}; "
                           f"{len(recomputes)} plain cross-entropy "
                           f"recomputes, wanted {want_recomputes}")
    if peak * 2**30 >= 80e9:
        raise RuntimeError(f"silo path {arch}: peak {peak:.1f} GiB")
    xent_route = ("tensor cores" if xent_tc else
                  "CUDA cores, backward the plain recompute")
    walls = [r["wall_s"] for r in rounds_out]
    per_step = {k: v / steps for k, v in launches.items() if v}
    summary = dict(arch=arch, lr=lr, params=n_params, init_s=init_s, silos=K,
                   layers=cfg.n_layers, max_steps=max_steps, batch=B, seq=S,
                   tokens=T_tok, plain_scan_calls=len(plain_scans),
                   rounds=rounds_out, local_steps=steps,
                   xent_route=xent_route,
                   plain_xent_recomputes=len(recomputes),
                   ms_per_local_step=sum(walls) / steps * 1e3,
                   peak_gib=peak, launches=launches,
                   launches_per_step=per_step,
                   tensor_core_launches=tc_launches,
                   records=[r.to_json() for r in recs])
    remat = "remat" if fwd_per_attn == 2 else "no remat"
    print(f"main path silo {arch} (full width, {cfg.n_layers} layers, "
          f"{n_params} params f32, "
          f"bf16 compute, {remat}): {rounds} rounds x {K} silos, B={B}, "
          f"S={S} ({T_tok} tokens): round wall "
          f"{[round(w, 3) for w in walls]} s, {steps} local "
          f"steps ({summary['ms_per_local_step']:.1f} ms each, round "
          f"overhead included), losses "
          f"{[round(r['loss'], 4) for r in rounds_out]}, budgets "
          f"{[r['n_steps'] for r in rounds_out]}, peak {peak:.1f} GiB; "
          f"launches a step {json.dumps(per_step)}; "
          f"launches {json.dumps(launches)}, tensor-core "
          f"{json.dumps(tc_launches)}; cross-entropy route {xent_route} "
          f"({len(recomputes)} plain recomputes); one RoundRecord a round, "
          f"train_loss == stats['loss'], wall_time_s "
          f"{[round(r.wall_time_s, 3) for r in recs]}", flush=True)

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
    wall, device, top, (flash, xent, scan), _ = profiled(
        torch, lambda: train_silo(row, fed.params, one, 1),
        ("flash_", "xent_", "selective_scan"))
    after = torch.cuda.memory_stats()
    summary["step_ms"] = step_ms
    summary["profile"] = dict(
        wall_ms=wall, device_ms=device, device_busy=device / wall,
        device_share_of_unprofiled_step=device / step_ms,
        flash_kernels_ms=flash, xent_kernels_ms=xent,
        scan_kernels_ms=scan, top_kernels_ms=top,
        alloc_retries=after["num_alloc_retries"]
        - before["num_alloc_retries"],
        cuda_mallocs=after["num_device_alloc"] - before["num_device_alloc"])
    print(f"profile silo {arch} one local step (B={B}, S={S}): step "
          f"{step_ms:.1f} ms unprofiled; {json.dumps(summary['profile'])}",
          flush=True)
    del row, fed
    return summary


def serve_card_vs_cpu(torch, get_config, build_model, serve, arch,
                      over=None):
    """Phase 3: one smoke config (with ``over``'s fields) served in float32
    on the card and on the CPU from the same params (drawn on the CPU) and
    the serve driver's batch (a VLM's patches, an encoder-decoder's
    frames): same tokens, close logits."""
    from repro_torch.convert import params_from_reference, params_to_numpy
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               **(over or {}))
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    on_card = params_from_reference(params_to_numpy(params), "cuda")
    # a sliding-window config prefills past its window, so the cache
    # keeps the rolled trailing window and decode writes its ring buffer
    prompt = (cfg.window_size + 16 if cfg.attention == "sliding_window"
              else 40)
    runs = []
    for p, where in ((on_card, "cuda"), (params, "cpu")):
        batch = serve.prompt_batch(cfg, 3, prompt, where)
        runs.append(serve.generate(model, p, batch, 6))
    (tok_card, lg_card, _), (tok_cpu, lg_cpu, _) = runs
    err = float((lg_card.cpu() - lg_cpu).abs().max())
    label = f"{arch}{' ' + json.dumps(over) if over else ''}"
    if not torch.equal(tok_card.cpu(), tok_cpu):
        raise RuntimeError(f"{label} smoke: card and CPU generated "
                           f"different tokens:\n{tok_card.cpu()}\n{tok_cpu}")
    if not torch.allclose(lg_card.cpu(), lg_cpu, rtol=SERVE_TOL,
                          atol=SERVE_TOL):
        raise RuntimeError(f"{label} smoke: card and CPU logits differ by "
                           f"{err}")
    print(f"serve {label} smoke float32, batch 3, prompt {prompt}, 6 "
          f"tokens, card vs CPU: same tokens {tok_cpu[0].tolist()}, last "
          f"logits max_abs_err {err:.3e} (tol {SERVE_TOL})", flush=True)


def profiled(torch, fn, part="flash_"):
    """(host wall ms, device ms, top kernels, part ms, device launches) of
    one call of ``fn`` under torch.profiler (``obs.warm_profile``: no
    device record lost at the window's start), ending in a device sync.
    A window in which a kernel launch has no device record (the profiler
    lost it: ``lost_records``) counts nothing: ``fn`` is profiled again,
    up to ``TRACE_ATTEMPTS`` windows, each retry printed, and if every
    window lost records, ``TraceIncomplete`` is raised.
    Device time sums the events that ran on the card (kernels, copies),
    each once: the CPU op that launched a kernel reports the same time
    again, so CPU events are left out, and so are the device spans of the
    stage ranges (``fed.*``, user annotations), which cover the kernels
    launched inside them and the gaps between; device launches counts
    those events.  Part ms sums the kernels whose name holds ``part`` (a
    string or a tuple of them; by default the flash-attention kernels:
    forward, backward and the backward's delta kernel)."""
    from torch.autograd import DeviceType
    from repro_torch.obs import warm_profile
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with warm_profile() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = trace_events(prof)
        lost, n_launches = unrecorded_launches(events)
        if not lost:
            break
        print(f"profiled: window {attempt} of {TRACE_ATTEMPTS}: {lost} of "
              f"its {n_launches} kernel launches have no device record "
              f"(their places in launch order: "
              f"{unrecorded_ranks(events)[:16]}); profiling it again",
              flush=True)
    else:
        raise TraceIncomplete(f"all {TRACE_ATTEMPTS} profiled windows lost "
                              f"device records")
    averages = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU
                and not (e.is_user_annotation or e.key.startswith("fed."))]
    events = [(e.key, e.self_device_time_total) for e in averages]
    device = sum(t for _, t in events) / 1e3
    top = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    parts = (part,) if isinstance(part, str) else part
    part_ms = [sum(t for k, t in events if p in k) / 1e3 for p in parts]
    return (wall, device, [(k[:60], t / 1e3) for k, t in top[:6]],
            part_ms[0] if isinstance(part, str) else part_ms,
            sum(e.count for e in averages))


def trace_events(prof) -> list:
    """The complete ("X") events of a finished profile, as its chrome
    trace holds them (written to a temporary file and read back)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]


def serve_path(torch, get_config, build_model, serve, arch, batch, prompt,
               gen, counted, want, dec_tokens=None):
    """Phase 4 (and 5): ``serve.generate`` at full width with random
    weights on the serve driver's batch of ``prompt`` positions
    (``serve.prompt_batch``: a VLM's prompt // 4 of them patches, an
    encoder-decoder's ``prompt`` frames under its first ``dec_tokens``
    decoder tokens).  Every kernel's count is set to 0 just before the
    counted run and read just after; ``want`` maps kernel name ->
    launches."""
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    model = build_model(cfg)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tamed_init(model.init, cfg)(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    def prompt_batch(n):
        out = serve.prompt_batch(cfg, batch, n, dev)
        if dec_tokens:
            out["tokens"] = out["tokens"][:, :dec_tokens]
        return out

    inputs = prompt_batch(prompt)
    n_tok = inputs["tokens"].shape[1]
    serve.generate(model, params, prompt_batch(64), 2)      # warm-up
    reset_counts(counted)
    out, logits, times = serve.generate(model, params, inputs, gen)
    launches = {k: fn.launches for k, fn in counted.items()}
    tc_launches = tensor_core_counts(counted)
    single_steps = counted["selective_scan_fwd"].single_step_launches
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
    if "selective_scan_fwd" in want and single_steps != cfg.n_layers * gen:
        raise RuntimeError(f"{arch}: {single_steps} single-step scan "
                           f"launches, wanted one per layer and decode "
                           f"step ({cfg.n_layers * gen})")
    summary = dict(
        params=n_params, init_s=init_s, batch=batch, prompt=prompt,
        prompt_tokens=n_tok, gen=gen,
        prefill_ms=times["prefill_s"] * 1e3,
        prefill_tokens_per_s=batch * prompt / times["prefill_s"],
        decode_s=times["decode_s"],
        decode_tokens_per_s=batch * gen / times["decode_s"],
        decode_ms_per_step=times["decode_s"] / gen * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        sample=out[0, :8].tolist(), launches=launches,
        tensor_core_launches=tc_launches,
        scan_single_step_launches=single_steps)
    print(f"main path serve {arch} (full width, {n_params} params f32, "
          f"{cfg.dtype} compute): batch {batch}, prompt {prompt} positions "
          f"({n_tok} tokens): prefill "
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
            state["logits"], state["cache"] = model.prefill(params, inputs)

        def decode4():
            tok = torch.argmax(state["logits"], -1)[:, None].to(torch.int32)
            for i in range(4):
                lg, state["cache"] = model.decode_step(
                    params, state["cache"], tok, n_tok + i)
                tok = torch.argmax(lg, -1)[:, None].to(torch.int32)

        prof = {}
        for label, fn in (("prefill", prefill), ("decode x4", decode4)):
            wall, device, top, (flash, scan), _ = profiled(
                torch, fn, ("flash_", "selective_scan"))
            prof[label] = dict(wall_ms=wall, device_ms=device,
                               device_busy=device / wall,
                               flash_kernels_ms=flash, scan_kernels_ms=scan,
                               top_kernels_ms=top)
            print(f"profile {arch} {label}: {json.dumps(prof[label])}",
                  flush=True)
    summary["profile"] = prof
    return summary


def record_budgets(srv):
    """Wrap ``srv.run_round`` so that each round's budgets (n_iters) are
    appended to the list returned."""
    budgets, run_round = [], srv.run_round

    def recorded_round(t):
        row = run_round(t)
        budgets.append([int(v) for v in row["n_iters"]])
        return row

    srv.run_round = recorded_round
    return budgets


def sent140_card_vs_cpu(torch, np, FedSAEServer, ServerConfig,
                        make_sent140_like):
    """Phase 3: a small Sent140 federation (40 clients, 1,200 tweets,
    vocabulary 260) trained by the LSTM for 3 shuffle rounds on the card
    and on the CPU, from the same numpy init and epoch draws: the same
    cohorts and workloads, params within 2e-5, final accuracy within
    2/test_n."""
    small = make_sent140_like(n_clients=40, total=1200, vocab=260)
    max_n = int(small.sizes.max())
    vocab = max(int(x.max()) for x in small.clients_x) + 1
    r = np.random.default_rng(5)
    E, H = 32, 64
    init = {"emb": r.normal(size=(vocab, E)) * 0.1,
            "wx": r.normal(size=(E, 4 * H)) * E ** -0.5,
            "wh": r.normal(size=(H, 4 * H)) * H ** -0.5,
            "b": np.zeros(4 * H), "w_out": r.normal(size=(H, 2)) * H ** -0.5,
            "b_out": np.zeros(2)}
    init = {k: v.astype(np.float32) for k, v in init.items()}

    def draws(t, ids_, n_):
        return np.random.default_rng(200 + t).random(
            (len(ids_), max_n)).astype(np.float32)

    runs = []
    for where in ("cuda", "cpu"):
        srv = FedSAEServer(small, cfg=ServerConfig(
            device=where, rounds=3, sampling="shuffle"), init_params=init,
            data_draws=draws)
        budgets = record_budgets(srv)
        runs.append((srv, srv.run(), budgets))
    (on_card, h_card, budgets), (on_cpu, h_cpu, _) = runs
    for a, b in zip(on_card.cohorts, on_cpu.cohorts):
        if not np.array_equal(a, b):
            raise RuntimeError("Sent140 LSTM: card and CPU runs picked "
                               "different cohorts")
    if not (np.array_equal(on_card.L, on_cpu.L)
            and np.array_equal(on_card.H, on_cpu.H)):
        raise RuntimeError("Sent140 LSTM: card and CPU runs predicted "
                           "different workloads")
    err = max(float((on_card.params[k].cpu() - on_cpu.params[k]).abs().max())
              for k in init)
    if not all(torch.allclose(on_card.params[k].cpu(), on_cpu.params[k],
                              rtol=TOL, atol=TOL) for k in init):
        raise RuntimeError(f"Sent140 LSTM: card and CPU params differ by "
                           f"{err}")
    acc_gap = abs(h_card["acc"][-1] - h_cpu["acc"][-1])
    if acc_gap > 2.0 / len(small.test_y):
        raise RuntimeError(f"Sent140 LSTM: final accuracy differs by "
                           f"{acc_gap}")
    print(f"small Sent140 federation, LSTM (vocab {vocab}), 3 shuffle "
          f"rounds, card vs CPU: same cohorts and workloads (budgets "
          f"{budgets}), params max_abs_err {err:.3e} (tol {TOL}), final acc "
          f"{h_card['acc'][-1]:.4f} vs {h_cpu['acc'][-1]:.4f} (limit "
          f"{2.0 / len(small.test_y):.4f})", flush=True)
    return dict(max_abs_err=err, acc=[h_card["acc"][-1], h_cpu["acc"][-1]],
                budgets=budgets)


#: the robust aggregators held card against CPU: (name, keyword arguments)
ROBUST_CASES = [
    ("trimmed_mean", dict(trim_ratio=0.2)),
    ("median", {}),
    ("krum", dict(n_byzantine=1)),
    ("geometric_median", {}),
    ("bulyan", dict(n_byzantine=1)),
    ("trimmed_mean", dict(trim_ratio=0.2, weighted=True)),
    ("krum", dict(n_byzantine=1, multi=3, weighted=True)),
    ("bulyan", dict(n_byzantine=1, weighted=True)),
]


def robust_card_vs_cpu(torch, np, aggregation):
    """Phase 3: each robust aggregator (and weighted variants) on the card
    against the CPU, on a fixed seeded [10, 56,962] stack (the LSTM's P):
    clients at distinct distances from a common centre (no two Krum scores
    near a tie), a far-out adversarial row (client 3) and a dropped client
    (weight 0, client 6).  Every card call runs under
    ``set_sync_debug_mode("error")``, so a read back to the host fails the
    run.  Krum's and Bulyan's chosen clients must be equal; values within
    ``RANK_TOL`` (``GM_TOL`` for the geometric median)."""
    K, P = 10, 56_962
    rng = np.random.default_rng(13)
    centre = rng.normal(size=P) * 0.1
    spread = np.linspace(0.01, 0.1, K)[rng.permutation(K)]
    flat = (centre[None, :] + spread[:, None]
            * rng.normal(size=(K, P))).astype(np.float32)
    flat[3] += 50.0
    glob = (centre + 0.01 * rng.normal(size=P)).astype(np.float32)
    w = rng.integers(1, 300, K).astype(np.float32)
    w[6] = 0.0
    host = ({"a": flat[:, :-6], "b": flat[:, -6:]},
            {"a": glob[:-6], "b": glob[-6:]}, w)
    out = {}
    for name, kw in ROBUST_CASES:
        agg = aggregation.get_aggregator(name, **kw)
        card, cpu = [({k: torch.from_numpy(v).to(dev)
                       for k, v in host[0].items()},
                      {k: torch.from_numpy(v).to(dev)
                       for k, v in host[1].items()},
                      torch.from_numpy(host[2]).to(dev))
                     for dev in ("cuda", "cpu")]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = agg(*card)
            chosen = (agg.select(aggregation._flatten_clients(card[0]),
                                 card[2]) if hasattr(agg, "select")
                      else None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = agg(*cpu)
        tol = GM_TOL if name == "geometric_median" else RANK_TOL
        err = max(float((got[k].cpu() - want[k]).abs().max()) for k in want)
        if not all(torch.allclose(got[k].cpu(), want[k], rtol=tol, atol=tol)
                   for k in want):
            raise RuntimeError(f"aggregator {name} {kw}: card and CPU differ"
                               f" by {err} (tol {tol})")
        label = f"{name} {json.dumps(kw)}"
        row = dict(max_abs_err=err, tol=tol)
        if chosen is not None:
            c_cpu = agg.select(aggregation._flatten_clients(cpu[0]), cpu[2])
            row["chosen"] = [int(i) for i in
                             np.flatnonzero(chosen.cpu().numpy())]
            if not torch.equal(chosen.cpu(), c_cpu) or 3 in row["chosen"]:
                raise RuntimeError(f"aggregator {label}: chose "
                                   f"{row['chosen']} on the card, "
                                   f"{np.flatnonzero(c_cpu.numpy())} on the "
                                   f"CPU")
        out[label] = row
        print(f"aggregator {label} K={K} P={P}, card vs CPU under sync "
              f"debug mode 'error': {json.dumps(row)}", flush=True)
    return out


#: the FL kernels: wrapper -> (kernel symbol in a trace, stage it is
#: launched in)
FL_KERNELS = {
    "fed_cohort_gather": ("fed_gather_kernel", "fed.gather"),
    "fed_local_sgd_mclr": ("fed_sgd_cluster_kernel", "fed.local_sgd"),
    "fed_local_sgd_dense": ("fed_dense_sgd_cluster_kernel",
                            "fed.local_sgd"),
    "fed_compress_topk_q8": ("fed_compress_cluster_kernel",
                             "fed.upload_transform"),
}
STAGES = ("fed.gather", "fed.local_sgd", "fed.upload_transform",
          "fed.aggregate")


#: rounds traced at most, one after another, until a trace holds a device
#: record of every launch in its window
TRACE_ATTEMPTS = 3


class TraceIncomplete(RuntimeError):
    """A trace with kernel launches that have no device record: the
    profiler lost them, and the trace can check no stage range and count
    no device time."""


def unrecorded_launches(events):
    """(lost, launches) of a trace's complete events: the kernel launches
    recorded on the host (``cudaLaunchKernel`` / ``cuLaunchKernel`` calls,
    by correlation id) and how many of them have no kernel event on the
    device."""
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    recorded = {e["args"].get("correlation") for e in events
                if e.get("cat") == "kernel"}
    launches = [c for c, e in calls.items()
                if re.match(r"cu(da)?LaunchKernel", e["name"])]
    return sum(c not in recorded for c in launches), len(launches)


def unrecorded_ranks(events):
    """The places, in host launch order (0 the window's first), of the
    kernel launches of ``unrecorded_launches`` that have no device
    record."""
    recorded = {e["args"].get("correlation") for e in events
                if e.get("cat") == "kernel"}
    launches = sorted((e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and re.match(r"cu(da)?LaunchKernel", e["name"])),
                      key=lambda e: e.get("ts", 0))
    return [i for i, e in enumerate(launches)
            if e["args"].get("correlation") not in recorded]


def stage_ranges(path, launched, stages):
    """Read the chrome trace of one round: every stage in ``stages`` must
    appear, and each launch of an FL kernel (its kernel events, linked to
    the host call that launched them by their correlation id) must lie
    inside its stage's host range; the kernel events of each wrapper must
    number its ``launched`` count.  Raises ``TraceIncomplete`` first if a
    kernel launch in the window has no device record.  Returns {stage:
    {"host_ms", "device_ms", "kernels"}}: the stage ranges' host time and
    the device time and count of the kernels launched inside them."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] in STAGES]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    lost, n_launches = unrecorded_launches(events)
    if lost:
        raise TraceIncomplete(f"{lost} of the window's {n_launches} kernel "
                              f"launches have no device record")
    out = {s: dict(host_ms=0.0, device_ms=0.0, kernels=0) for s in STAGES}
    for r in ranges:
        out[r["name"]]["host_ms"] += r["dur"] / 1e3
    absent = [s for s in stages if not any(r["name"] == s for r in ranges)]
    if absent:
        raise RuntimeError(f"trace {path}: no range named {absent}")
    found = {name: 0 for name in launched}
    for k in (e for e in events if e.get("cat") == "kernel"):
        call = calls.get(k.get("args", {}).get("correlation"))
        inside = [] if call is None else [
            r["name"] for r in ranges if r["ts"] <= call["ts"]
            and call["ts"] + call["dur"] <= r["ts"] + r["dur"]]
        for name in set(inside):
            out[name]["device_ms"] += k["dur"] / 1e3
            out[name]["kernels"] += 1
        for name in launched:
            sym, want = FL_KERNELS[name]
            if re.search(rf"\b{sym}\b", k["name"]):
                found[name] += 1
                if want not in inside:
                    raise RuntimeError(
                        f"trace {path}: {name}'s kernel {k['name'][:60]} "
                        f"was launched by {call and call['name']} outside "
                        f"{want} (inside {inside})")
    if found != launched:
        raise RuntimeError(f"trace {path}: FL kernel events {found}, the "
                           f"wrappers counted {launched}")
    return out


def telemetry_costs(np, srv, meta, tmp, reps=2000):
    """Host microseconds of each piece of a round's telemetry, on one of
    ``srv``'s rounds (a server with telemetry on), each the median of 5
    runs of ``reps`` calls: the extras' two float32 histograms
    (``np.add.at``), the record's construction (the per-record list
    conversion), its ``to_json`` (``json.dumps``) and a ``JsonlSink``'s
    ``emit`` (``to_json`` and the buffered write); and of one stage range
    with no profiler recording (``obs.profiling.stage``, 5-8 a round)
    beside a bare ``torch.profiler.record_function``, which it opens only
    while a profiler records."""
    import torch
    from repro_torch.obs import (LOSS_HIST_BINS, LOSS_HIST_MAX,
                                 STAGE_GATHER, WORKLOAD_HIST_BINS,
                                 JsonlSink, histogram_counts,
                                 record_from_row, stage)
    row = srv.run_round(srv.cfg.rounds)
    row["wall_time_s"], row["acc"], row["test_loss"] = 2.5e-3, 0.5, 1.5
    rec = record_from_row(0, row)
    up = (row["n_iters"] > 0).astype(np.float32)
    # the budgets stand in for the uploaded epochs: a histogram's cost
    # does not depend on the values
    work = row["n_iters"].astype(np.float64)

    def hists():
        histogram_counts(row["losses"], up, 0.0, LOSS_HIST_MAX,
                         LOSS_HIST_BINS)
        histogram_counts(work, up, 0.0, srv.cfg.h_cap, WORKLOAD_HIST_BINS)

    sink = JsonlSink(os.path.join(tmp, "costs.jsonl"), meta=meta)
    def enter(ctx):
        with ctx(STAGE_GATHER):
            pass

    parts = {"histograms": hists,
             "record_from_row": lambda: record_from_row(0, row),
             "to_json": rec.to_json, "jsonl_emit": lambda: sink.emit(rec),
             "stage": lambda: enter(stage),
             "record_function": lambda: enter(
                 torch.profiler.record_function)}
    out = {}
    for name, fn in parts.items():
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs.append((time.perf_counter() - t0) / reps * 1e6)
        out[name] = statistics.median(runs)
    sink.close()
    return out


def telemetry_phase(torch, np, FedSAEServer, ServerConfig, femnist,
                    counted, frac):
    """Phase 6: the telemetry of ``repro_torch.obs`` on the card.

    femnist-iid at paper scale (5 rounds) twice without telemetry, which
    must give the same bits (else a kernel is non-deterministic), then with
    a ``JsonlSink`` and ``telemetry=True``: params and history bitwise the
    same, ``host_syncs`` equal, the file read back equal to the ring
    buffer and its header, every record with its extras and the byte
    ledger ``upload_bytes == sum(client_uploaded) * bytes_per_client``;
    mlp-topk (2 rounds, a sink): compressed bytes below dense every round;
    one more round of each under ``trace_if`` (another, up to
    ``TRACE_ATTEMPTS``, while the trace lost device records): the four
    stage ranges, each holding its FL kernels' launches; every count set
    to 0 before these runs and read after.  Then ``python -m
    repro_torch.launch.fl_report`` on the femnist file (``--validate
    --expect-rounds 5``, and the full report), and the overhead, outside
    the count: femnist-iid with no telemetry, a ``NullSink`` and a
    ``JsonlSink`` in turns (none, null, jsonl, jsonl, null, none), each
    turn 20 rounds after one warm-up round, the median round wall of
    each."""
    import shutil
    import tempfile
    from repro_torch.obs import (JsonlSink, NullSink, RingBufferSink,
                                 read_jsonl, trace_if)
    iid = dict(algo="ira", n_selected=10, rounds=5, sampling="iid")
    mlp = dict(iid, rounds=2, model="mlp", upload_compress="topk_q8",
               topk_frac=frac)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        path = os.path.join(tmp, "femnist_iid.jsonl")
        meta = dict(rounds=5, driver="host", backend="xla", path="flat",
                    dataset="femnist", algo="ira", model=None)
        reset_counts(counted)
        runs = {}
        for label, kw in (("off", {}), ("off again", {}),
                          ("on", dict(sink=JsonlSink(path, meta=meta),
                                      telemetry=True))):
            srv = FedSAEServer(femnist, cfg=ServerConfig(**iid), **kw)
            srv.run()
            srv.sink.close()
            torch.cuda.synchronize()
            runs[label] = srv

        def same_bits(a, b):
            return (all(torch.equal(a.params[k], b.params[k])
                        for k in a.params)
                    and json.dumps(a.history) == json.dumps(b.history))

        off, on = runs["off"], runs["on"]
        if not same_bits(off, runs["off again"]):
            raise RuntimeError("two femnist-iid runs without telemetry, "
                               "from the same seeds, differ: a kernel is "
                               "non-deterministic (a port fault)")
        if not same_bits(off, on):
            raise RuntimeError("telemetry changed the femnist-iid run's "
                               "params or history")
        if not off.host_syncs == on.host_syncs == 5:
            raise RuntimeError(f"host syncs {off.host_syncs} without "
                               f"telemetry, {on.host_syncs} with")
        got_meta, got = read_jsonl(path)
        recs = on._records.records
        if got_meta != meta or got != recs or len(recs) != 5:
            raise RuntimeError(f"JSONL read back: meta {got_meta}, "
                               f"{len(got)} records, ring {len(recs)}")
        for r in recs:
            if any(getattr(r, f) is None for f in (
                    "ids", "client_uploaded", "loss_hist",
                    "workload_hist")) or r.upload_bytes != sum(
                    r.client_uploaded) * on.bytes_per_client:
                raise RuntimeError(f"femnist-iid record {r.to_json()}: "
                                   f"extras or byte ledger wrong")
        ring = RingBufferSink()
        msrv = FedSAEServer(femnist, cfg=ServerConfig(**mlp), sink=ring)
        msrv.run()
        ratios = [r.upload_bytes / r.dense_upload_bytes
                  for r in ring.records]
        if len(ring) != 2 or not all(r < 1 for r in ratios):
            raise RuntimeError(f"mlp-topk byte ledger: compressed / dense "
                               f"{ratios}")
        print(f"telemetry femnist-iid paper scale, 5 rounds: with a "
              f"JsonlSink and telemetry=True the same params and history "
              f"bits as without (two runs without: the same bits), "
              f"host_syncs {on.host_syncs} both, the file read back equal "
              f"to the ring buffer and its _meta, extras and byte ledger "
              f"in every record; mlp-topk 2 rounds: upload bytes / dense "
              f"{ratios}", flush=True)

        stages = {}
        no_upload = STAGES[:2] + STAGES[3:]
        traced = {}
        for label, srv, want in (("femnist-iid", off, no_upload),
                                 ("mlp-topk", msrv, STAGES)):
            # a trace that lost device records checks nothing: another
            # round is traced, up to TRACE_ATTEMPTS (obs.profiling's
            # warm-up takes the records a late window loses first; 4 of
            # scripts/trace_record_probe.py's 96 windows still lost all or
            # part of theirs)
            for attempt in range(1, TRACE_ATTEMPTS + 1):
                before = {k: fn.launches for k, fn in counted.items()}
                tdir = os.path.join(tmp, f"{label}-{attempt}")
                with trace_if(tdir):
                    srv.run_round(srv.cfg.rounds)
                    torch.cuda.synchronize()
                launched = {k: fn.launches - before[k]
                            for k, fn in counted.items()
                            if k in FL_KERNELS and fn.launches > before[k]}
                (trace,) = os.listdir(tdir)
                try:
                    stages[label] = stage_ranges(os.path.join(tdir, trace),
                                                 launched, want)
                    break
                except TraceIncomplete as e:
                    print(f"telemetry trace {label}, attempt {attempt}: "
                          f"{e}", flush=True)
            else:
                raise RuntimeError(f"telemetry {label}: all "
                                   f"{TRACE_ATTEMPTS} traces lost device "
                                   f"records")
            traced[label] = attempt
            stages[label].update(launched=launched, attempts=attempt)
            print(f"telemetry stage ranges {label}, one round: "
                  f"{json.dumps(stages[label])}", flush=True)
        launches = {k: fn.launches for k, fn in counted.items()}
        n_iid, n_mlp = traced["femnist-iid"], traced["mlp-topk"]
        want = dict({k: 0 for k in counted},
                    fed_cohort_gather=17 + n_iid + n_mlp,
                    fed_local_sgd_mclr=15 + n_iid,
                    fed_local_sgd_dense=2 + n_mlp,
                    fed_compress_topk_q8=2 + n_mlp)
        if launches != want:
            raise RuntimeError(f"telemetry path launched {launches}, "
                               f"wanted {want}")

        report = {}
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        for args in (["--validate", "--expect-rounds", "5"], []):
            done = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.fl_report", path]
                + args, capture_output=True, text=True, timeout=300,
                env=env)
            if done.returncode != 0:
                raise RuntimeError(f"fl_report {args}: rc "
                                   f"{done.returncode}: {done.stderr}")
            report[" ".join(args) or "full"] = done.stdout
        heads = ("Round summary", "Stragglers", "Per-client reliability",
                 "Upload ledger", "Throughput")
        missing = [h for h in heads if f"## {h}" not in report["full"]]
        if missing or not report["--validate --expect-rounds 5"].startswith(
                "fl_report: OK — 5 valid round records"):
            raise RuntimeError(f"fl_report: {report}, sections missing "
                               f"{missing}")
        print(f"telemetry python -m repro_torch.launch.fl_report: "
              f"{report['--validate --expect-rounds 5'].strip()}; the full "
              f"report has {', '.join(heads)}", flush=True)

        walls = {"none": [], "null": [], "jsonl": []}
        for i, leg in enumerate(("none", "null", "jsonl", "jsonl", "null",
                                 "none")):
            sink = {"none": None, "null": NullSink(),
                    "jsonl": JsonlSink(os.path.join(tmp, f"turn{i}.jsonl"),
                                       meta=meta)}[leg]
            srv = FedSAEServer(femnist, cfg=ServerConfig(
                **dict(iid, rounds=21)), sink=sink)
            srv.run()
            srv.sink.close()
            walls[leg].append(statistics.median(srv.wall_times[1:]))
        med = {k: statistics.median(v) for k, v in walls.items()}
        overhead = dict(
            turn_median_round_s=walls, median_round_s=med,
            jsonl_over_null=med["jsonl"] / med["null"] - 1,
            jsonl_over_none=med["jsonl"] / med["none"] - 1,
            ceiling=0.09, host_us=telemetry_costs(np, on, meta, tmp))
        print(f"telemetry overhead femnist-iid, 20 rounds a turn: "
              f"{json.dumps(overhead)}", flush=True)
        return dict(upload_ratio_mlp_topk=ratios, stages=stages,
                    launches=launches, overhead=overhead)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _same_run(torch, np, a, b):
    """Two servers' runs bitwise equal: cohorts, history (L, H, theta, the
    values), params and, when compressing, the residual.  Returns the
    first difference's name, or None."""
    from repro_torch.tree import tree_items
    if len(a.cohorts) != len(b.cohorts) or not all(
            np.array_equal(x, y) for x, y in zip(a.cohorts, b.cohorts)):
        return "cohorts"
    for name in ("L", "H", "theta"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            return name
    if not np.array_equal(a.values.v, b.values.v):
        return "values"
    bp = dict(tree_items(b.params))
    for k, v in tree_items(a.params):
        if not torch.equal(v, bp[k]):
            return f"params {k}"
    if a.residual is not None and not torch.equal(a.residual, b.residual):
        return "residual"
    return None


def timed_stage(torch, fn, into):
    """``fn`` wrapped to append the device time of each call (CUDA events,
    after a synchronize) and its host wall, in ms, to ``into``."""
    def timed(*a):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        result = fn(*a)
        e1.record()
        torch.cuda.synchronize()
        into.append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
        return result
    return timed


def silo_screen(torch, np, get_config, build_model, counted):
    """Phase 7, the silo leg: one Llama-3.2-3B round at full width (K=2,
    max_steps 4, B=1, S=2048, the silo path's first round: budgets [2, 2])
    without the screen, then, on a fresh ``SiloFedSAE``, the same round
    with ``screen_norm=1e-6``, which no upload meets: both silos screened,
    the global params bitwise the pre-round params (held on the host), the
    record ``screened == 2``.  Each round's peak device memory from a
    reset just before it, and the aggregate stage (``engine._finish``:
    screen and FedAvg) timed with CUDA events and on the host clock."""
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.obs import RingBufferSink
    from repro_torch.tree import tree_leaves
    cfg = get_config("llama3.2-3b")
    model = build_model(cfg)
    K, max_steps, B, S = 2, 4, 1, 2048
    out = {}
    for label, bound in (("unscreened", None), ("screened", 1e-6)):
        ring = RingBufferSink()
        fed = SiloFedSAE(model, K, lr=5e-3, max_steps=max_steps, seed=0,
                         sink=ring, screen_norm=bound)
        ri = np.random.default_rng(0)
        sizes = np.asarray(ri.integers(100, 1000, K))
        batches = silo_batches(torch, cfg, K, max_steps, B, S, ri, "cuda")
        before = ([t.cpu() for t in tree_leaves(fed.params)]
                  if bound is not None else None)
        times = []
        fed.engine._finish = timed_stage(torch, fed.engine._finish, times)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = fed.run_round(batches, sizes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec = ring.last
        stage = dict(zip(("device_ms", "host_ms"), times[0]))
        n_up = int((fed.last_n_steps > 0).sum())
        if not np.isfinite(stats["loss"][-1]) or peak >= 80e9 / 2**30:
            raise RuntimeError(f"silo {label}: loss {stats['loss']}, peak "
                               f"{peak:.1f} GiB")
        if bound is not None:
            kept = all(torch.equal(b, t.cpu()) for b, t in
                       zip(before, tree_leaves(fed.params)))
            if rec.screened != 2.0 or n_up != 2 or not kept:
                raise RuntimeError(f"silo screened round: screened "
                                   f"{rec.screened} of {n_up} uploads, "
                                   f"params kept bitwise {kept}")
            del before
        elif rec.screened is not None:
            raise RuntimeError("silo unscreened round recorded a screen")
        out[label] = dict(wall_s=wall, peak_gib=peak,
                          n_steps=fed.last_n_steps.tolist(),
                          screened=rec.screened,
                          aggregate_device_ms=stage["device_ms"],
                          aggregate_host_ms=stage["host_ms"])
        print(f"faults silo llama3.2-3b full width, {label} round (budgets "
              f"{out[label]['n_steps']}, screen_norm {bound}): wall "
              f"{wall:.3f} s, peak {peak:.2f} GiB, aggregate stage "
              f"{stage['device_ms']:.2f} ms on the device (CUDA events), "
              f"{stage['host_ms']:.2f} ms host; screened {rec.screened}"
              + ("; global params bitwise the pre-round params"
                 if bound is not None else ""), flush=True)
        del fed, batches, stats
        torch.cuda.empty_cache()
    return out


def faults_phase(torch, np, FedSAEServer, ServerConfig, femnist, counted,
                 frac, get_config, build_model):
    """Phase 7: failure handling on the card (``repro_torch.faults`` and
    ``repro_torch.checkpoint``), every count set to 0 just before and read
    just after, each leg's launches checked.  At FEMNIST paper scale (200
    clients, K=10): MCLR iid 5 rounds with ``corrupt="nan"`` and with
    ``"inf"`` (probability 0.3), each bitwise its ``"crash"`` twin
    (params, history, cohorts) with screened uploads in its records; the
    MLP + topk_q8 5 rounds with ``"explode"`` bitwise its twin, residual
    included; diurnal (day_rounds 8) + Pareto (alpha 1.5) + dropout 0.1 +
    sign_flip 0.2 under ``aggregator="median"`` for 5 rounds, every loss
    finite; kill/resume on the MLP + topk_q8 with nan faults, 4 rounds
    straight against 2, a checkpoint, a fresh server restored and 2 more,
    bitwise (residual and the CUDA generator included).  A small faulted
    federation (30 clients, nan at 0.3, numpy draws) on the card against
    the CPU: the same cohorts, L/H and screened counts, params within
    2e-5.  Then ``silo_screen``, whose two rounds must launch 56 flash
    forwards, 28 backwards and 2 cross-entropy chunks each way a local
    step, all on the tensor cores."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.data.federated import make_femnist_like
    from repro_torch.faults import FaultModel
    iid = dict(algo="ira", n_selected=10, sampling="iid")
    mlp = dict(iid, model="mlp", upload_compress="topk_q8", topk_frac=frac)
    summary = {}
    reset_counts(counted)

    def run(label, rounds, fault, want, ds=femnist, run_kw=None,
            time_aggregate=False, **cfg):
        fm = None if fault is None else FaultModel(**fault)
        srv = FedSAEServer(ds, cfg=ServerConfig(
            **dict(iid, rounds=rounds, faults=fm, **cfg)))
        times = []
        if time_aggregate:
            srv.engine._finish = timed_stage(torch, srv.engine._finish,
                                             times)
        before = {k: fn.launches for k, fn in counted.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = srv.run(**(run_kw or {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches - before[k] for k, fn in counted.items()}
        if got != dict({k: 0 for k in counted}, **want):
            raise RuntimeError(f"faults leg {label} launched {got}, not "
                               f"{want}")
        n = want["fed_cohort_gather"]           # the rounds this run ran
        summary[label] = dict(
            rounds=n, wall_s=wall, rounds_per_s=n / wall,
            screened=[r.screened for r in srv._records.records],
            train_loss=hist["train_loss"], host_syncs=srv.host_syncs,
            launches=got)
        if times:
            dev_ms, host_ms = zip(*times[1:])       # after round 0
            summary[label].update(
                aggregate_device_ms=statistics.median(dev_ms),
                aggregate_host_ms=statistics.median(host_ms))
        print(f"faults {label}: {n} rounds in {wall:.3f} s "
              f"({n / wall:.1f} rounds/s), screened "
              f"{summary[label]['screened']}, train_loss "
              f"{[round(v, 4) for v in hist['train_loss']]}, launches "
              f"{json.dumps({k: v for k, v in got.items() if v})}"
              + ("" if not times else
                 f"; aggregate stage (median of rounds 1-4) "
                 f"{summary[label]['aggregate_device_ms']:.4f} ms device, "
                 f"{summary[label]['aggregate_host_ms']:.4f} ms host"),
              flush=True)
        return srv

    def twin_check(label, a, b):
        diff = _same_run(torch, np, a, b)
        if diff is not None:
            raise RuntimeError(f"faults {label}: not bitwise its crash "
                               f"twin ({diff})")
        if not sum(r.screened for r in b._records.records) > 0:
            raise RuntimeError(f"faults {label}: nothing screened")
        print(f"faults {label}: bitwise its crash twin (params, L/H/theta, "
              f"values, cohorts" + (", residual" if b.residual is not None
                                    else "") + ")", flush=True)

    mclr_want = lambda r: dict(fed_cohort_gather=r, fed_local_sgd_mclr=r)
    mlp_want = lambda r: dict(fed_cohort_gather=r, fed_local_sgd_dense=r,
                              fed_compress_topk_q8=r)
    fault = lambda mode, **kw: dict(seed=3, corrupt=mode, corrupt_prob=0.3,
                                    **kw)
    twin = run("mclr iid crash", 5, fault("crash"), mclr_want(5))
    for mode in ("nan", "inf"):
        twin_check(f"mclr iid {mode}", twin, run(
            f"mclr iid {mode}", 5, fault(mode), mclr_want(5)))
    # the screen's cost: the aggregate stage with the screen off (no
    # faults), on with nothing to reject, and on against nan uploads
    for label, f, screen in (("aggregate plain", None, "auto"),
                             ("aggregate screen idle", None, "on"),
                             ("aggregate screen nan", fault("nan"),
                              "auto")):
        run(label, 5, f, mclr_want(5), time_aggregate=True,
            upload_screen=screen)
    twin = run("mlp topk_q8 crash", 5, fault("crash"), mlp_want(5), **mlp)
    twin_check("mlp topk_q8 explode", twin, run(
        "mlp topk_q8 explode", 5, fault("explode"), mlp_want(5), **mlp))
    stress = run("stress median", 5, dict(
        seed=5, availability="diurnal", day_rounds=8, straggler="pareto",
        pareto_alpha=1.5, dropout_prob=0.1, corrupt="sign_flip",
        corrupt_prob=0.2), mclr_want(5), aggregator="median")
    hist = stress.history
    if not (np.isfinite(hist["train_loss"]).all()
            and np.isfinite(hist["test_loss"]).all()
            and all(torch.isfinite(v).all() for v in stress.params.values())
            and sum(r.screened for r in stress._records.records) == 0):
        raise RuntimeError(f"faults stress: losses {hist['train_loss']}, "
                           f"{hist['test_loss']}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        nan = fault("nan")
        full = run("kill/resume straight", 4, nan, mlp_want(4), **mlp)
        run("kill/resume first half", 4, nan, mlp_want(2),
            run_kw=dict(rounds=2, checkpoint_dir=tmp), **mlp)
        if [r for r, _ in list_checkpoints(tmp)] != [2]:
            raise RuntimeError(f"kill/resume: checkpoints "
                               f"{list_checkpoints(tmp)}")
        resumed = run("kill/resume resumed", 4, nan, mlp_want(2),
                      run_kw=dict(checkpoint_dir=tmp, resume=True), **mlp)
        diff = _same_run(torch, np, full, resumed)
        if diff is None and not torch.equal(full.data_gen.get_state(),
                                            resumed.data_gen.get_state()):
            diff = "data generator state"
        recs = [[json.loads(r.to_json()) for r in s._records.records]
                for s in (full, resumed)]
        for rs in recs:
            for r in rs:
                r.pop("wall_time_s")
        if diff is None and recs[0] != recs[1]:
            diff = "records"
        if diff is not None:
            raise RuntimeError(f"kill/resume not bitwise ({diff})")
        print("faults kill/resume, mlp topk_q8 with nan faults: 2 rounds, "
              "a checkpoint, a fresh server restored, 2 more: bitwise the "
              "4 straight rounds (params, residual, L/H/theta, values, "
              "cohorts, records but wall_time_s, the CUDA generator)",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    small = make_femnist_like(n_clients=30, total=900, dim=64, max_size=40)
    init = {"w": (np.random.default_rng(1).normal(size=(64, 26)) * 0.01)
            .astype(np.float32), "b": np.zeros(26, np.float32)}
    small_cfg = dict(rounds=3, n_selected=6, sampling="iid", batch_size=4,
                     h_cap=6.0, fixed_epochs=4.0,
                     faults=FaultModel(**fault("nan")))
    small_iters = math.ceil(6.0 * math.ceil(int(small.sizes.max()) / 4))

    def draws(t, ids_, n_):
        r = np.random.default_rng(100 + t)
        return (r.random((len(ids_), small_iters, 4))
                * np.maximum(n_, 1)[:, None, None]).astype(np.int32)

    before = {k: fn.launches for k, fn in counted.items()}
    runs = []
    for where in ("cuda", "cpu"):
        srv = FedSAEServer(small, cfg=ServerConfig(device=where, **small_cfg),
                           init_params=init, data_draws=draws)
        srv.run()
        runs.append(srv)
    got = {k: fn.launches - before[k] for k, fn in counted.items()}
    if got != dict({k: 0 for k in counted}, **mclr_want(3)):
        raise RuntimeError(f"faults card vs CPU launched {got}")
    on_card, on_cpu = runs
    scr = [[r.screened for r in s._records.records] for s in runs]
    err = max(float((on_card.params[k].cpu() - on_cpu.params[k]).abs().max())
              for k in init)
    if (not all(np.array_equal(a, b) for a, b in
                       zip(on_card.cohorts, on_cpu.cohorts))
            or not np.array_equal(on_card.L, on_cpu.L)
            or not np.array_equal(on_card.H, on_cpu.H)
            or scr[0] != scr[1] or sum(scr[0]) <= 0 or err > TOL):
        raise RuntimeError(f"faults card vs CPU: screened {scr}, params "
                           f"max_abs_err {err}")
    summary["small card vs cpu"] = dict(screened=scr[0], max_abs_err=err,
                                        launches=got)
    print(f"faults small federation, nan at 0.3, 3 iid rounds, card vs CPU:"
          f" same cohorts, L/H and screened {scr[0]}, params max_abs_err "
          f"{err:.3e} (tol {TOL})", flush=True)

    torch.cuda.empty_cache()
    before = {k: fn.launches for k, fn in counted.items()}
    summary["silo"] = silo_screen(torch, np, get_config, build_model,
                                  counted)
    got = {k: fn.launches - before[k] for k, fn in counted.items()}
    steps = sum(sum(r["n_steps"]) for r in summary["silo"].values())
    want = {"flash_attention_fwd": 56 * steps,
            "flash_attention_bwd": 28 * steps,
            "fused_softmax_xent_fwd": 2 * steps,
            "fused_softmax_xent_bwd": 2 * steps}
    tc = tensor_core_counts(counted)        # the silo legs' alone
    if (got != dict({k: 0 for k in counted}, **want)
            or tc != {k: want[k] for k in tc}):
        raise RuntimeError(f"faults silo rounds launched {got} (tensor "
                           f"cores {tc}), not {want}, all on the tensor "
                           f"cores")
    summary["silo"]["launches"] = got
    summary["tensor_core_launches"] = tc
    summary["launches"] = {k: fn.launches for k, fn in counted.items()}
    print(f"path faults launches: {json.dumps(summary['launches'])}",
          flush=True)
    return summary


def _scan_records(srv):
    """The run's records as JSON dicts without ``wall_time_s``."""
    out = []
    for r in srv._records.records:
        d = json.loads(r.to_json())
        d.pop("wall_time_s")
        out.append(d)
    return out


def _scan_same_run(torch, np, host, scan, block):
    """The scan run bitwise the host run with device rng: ``_same_run``'s
    state, the budgets, the quarantine counters and every record but its
    wall time; the scan evaluates at block ends only, so those records
    must equal the host's and the ones inside a block carry the previous
    block end's accuracy and no test loss.  Returns the first difference,
    or None."""
    diff = _same_run(torch, np, host, scan)
    if diff is not None:
        return diff
    if len(host.budgets) != len(scan.budgets) or not all(
            np.array_equal(a, b) for a, b in zip(host.budgets,
                                                 scan.budgets)):
        return "budgets"
    for name in ("q_fail", "q_try", "q_susp"):
        if not np.array_equal(getattr(host, name), getattr(scan, name)):
            return name
    hr, sr = _scan_records(host), _scan_records(scan)
    if len(hr) != len(sr):
        return "records"
    prev = None
    for i, (a, b) in enumerate(zip(hr, sr)):
        ha = (a.pop("acc"), a.pop("test_loss"))
        sa = (b.pop("acc"), b.pop("test_loss"))
        end = (i + 1) % block == 0 or i == len(hr) - 1
        if a != b or (sa != ha if end else sa != (prev, None)):
            return f"record {i}"
        if end:
            prev = ha[0]
    return None


def scan_phase(torch, np, FedSAEServer, ServerConfig, femnist, counted,
               frac, make_sent140_like):
    """Phase 8: the device-resident drivers (``driver="scan"``, and the
    host driver with ``rng_impl="device"``) at FEMNIST paper scale (200
    clients, K=10, B=10, lr 0.03, max_iters 960), every count set to 0
    just before and read just after.  The scan driver captures one round
    as a CUDA graph and replays it once a round; inside a block any
    synchronizing call raises (``core.graphs.sync_checked``, checked live
    first).  Legs, each scan run bitwise its host run with device rng
    (cohorts, budgets, params, L/H/theta, values, residual, quarantine
    counters, records but the wall time, block ends' evals): MCLR iid Ira
    40 rounds in blocks of 16, 16 and 8 (``host_syncs`` == blocks +
    evals); the MLP + topk_q8 iid 16 rounds in blocks of 8 (residual
    included); MCLR shuffle, one block of 4 (all 960 slots masked in the
    graph); nan uploads at 0.3 with the screen and quarantine at 0.3, 16
    rounds in blocks of 8 (quarantined counts equal), and its crash twin
    on the scan driver bitwise; kill/resume at a block boundary (8 rounds,
    a checkpoint, a fresh server, 8 more) bitwise 16 straight; a
    ``JsonlSink`` run bitwise the run without, the same ``host_syncs``,
    the file read back.  The speed of the numpy host driver, the
    device-rng host driver and the scan driver in turns (40 rounds each,
    twice), one block's device time (torch.profiler), the capture's ms and
    the graph's nodes.  Then small federations on the scan driver, card
    against CPU from injected draws (MCLR iid; the Sent140 LSTM, shuffle):
    the same cohorts, params within 2e-5.  The scan legs' launches are
    each program's real ones (the warm-up's, then the launches one capture
    recorded times the replays): the wrappers' counters run once, at
    capture."""
    import shutil
    import tempfile
    from repro_torch.core.graphs import sync_checked
    from repro_torch.faults import FaultModel
    from repro_torch.obs import JsonlSink, read_jsonl
    base = dict(algo="ira", n_selected=10, sampling="iid")
    mlp = dict(model="mlp", upload_compress="topk_q8", topk_frac=frac)
    out = {"legs": {}}
    reset_counts(counted)
    real = {k: 0 for k in counted}          # real launches of the path

    try:                                    # the guard is live
        with sync_checked("cuda"):
            torch.ones(1, device="cuda").sum().item()
        raise AssertionError("no error")
    except RuntimeError as e:
        if "synchroniz" not in str(e).lower():
            raise
    print("scan sync check: a host read inside sync_checked raises",
          flush=True)

    def drive(label, driver, rounds, block=16, run_kw=None, ds=femnist,
              sink=None, resumed=0, **cfg):
        before = {k: fn.launches for k, fn in counted.items()}
        srv = FedSAEServer(ds, cfg=ServerConfig(**dict(
            base, rounds=rounds, driver=driver, block_size=block,
            rng_impl="device" if driver == "host" else "", **cfg)),
            sink=sink)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run(**(run_kw or {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches - before[k] for k, fn in counted.items()}
        prog = srv.program
        if driver == "scan":
            # the counters ran at the warm-up and once at capture
            want = {k: prog.warmup_launches.get(k, 0)
                    + prog.per_replay.get(k, 0) for k in counted}
            if got != want:
                raise RuntimeError(f"scan {label}: counters {got}, not the "
                                   f"warm-up's and one capture's {want}")
            got = {k: prog.launches().get(k, 0) for k in counted}
        for k in counted:
            real[k] += got[k]
        for k, v in srv.params.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"scan {label}: non-finite params {k}")
        n = (run_kw or {}).get("rounds", rounds) - resumed
        leg = dict(driver=driver, rounds=n, wall_s=wall,
                   rounds_per_s=n / wall, host_syncs=srv.host_syncs,
                   launches={k: v for k, v in got.items() if v})
        if prog is not None and prog.graphed:
            leg.update(replays=prog.replays, capture_ms=prog.capture_ms,
                       graph_nodes=prog.nodes,
                       per_replay={k: v for k, v in prog.per_replay.items()
                                   if v})
        out["legs"][f"{label} {driver}"] = leg
        print(f"scan {label} {driver}: {json.dumps(leg)}", flush=True)
        return srv

    def pair(label, rounds, block, **cfg):
        host = drive(label, "host", rounds, block, **cfg)
        scan = drive(label, "scan", rounds, block, **cfg)
        diff = _scan_same_run(torch, np, host, scan, block)
        if diff is not None:
            raise RuntimeError(f"scan {label}: not bitwise the host driver "
                               f"with device rng ({diff})")
        print(f"scan {label}: scan == host (device rng) bitwise over "
              f"{rounds} rounds in blocks of {block}", flush=True)
        return host, scan

    # -- MCLR iid Ira, 40 rounds in blocks of 16, 16, 8 -------------------
    host, scan = pair("mclr iid", 40, 16)
    blocks, evals = 3, 3
    if scan.host_syncs != blocks + evals:
        raise RuntimeError(f"scan mclr iid: {scan.host_syncs} host syncs, "
                           f"not {blocks + evals}")
    if scan.program.replays != 40:
        raise RuntimeError(f"scan mclr iid: {scan.program.replays} replays")
    out["mclr_iid"] = dict(host_syncs=scan.host_syncs, blocks=blocks,
                           evals=evals, budgets=[int(max(b)) for b in
                                                 scan.budgets])
    # -- the other paths --------------------------------------------------
    _, scan_mlp = pair("mlp topk_q8 iid", 16, 8, **mlp)
    if not bool(scan_mlp.residual.abs().sum() > 0):
        raise RuntimeError("scan mlp topk_q8: the residual stayed 0")
    pair("mclr shuffle", 4, 4, sampling="shuffle")
    nan = dict(faults=FaultModel(seed=3, corrupt="nan", corrupt_prob=0.3),
               quarantine_threshold=0.3, quarantine_min_tries=1)
    host_q, scan_q = pair("faults nan quarantine", 16, 8, **nan)
    quarantined = [r.quarantined for r in scan_q._records.records]
    screened = [r.screened for r in scan_q._records.records]
    if max(quarantined) <= 0 or sum(screened) <= 0:
        raise RuntimeError(f"scan faults: quarantined {quarantined}, "
                           f"screened {screened}")
    out["faults"] = dict(quarantined=quarantined, screened=screened)
    crash = drive("faults crash twin", "scan", 16, 8, faults=FaultModel(
        seed=3, corrupt="crash", corrupt_prob=0.3))
    twin = drive("faults nan twin", "scan", 16, 8, faults=FaultModel(
        seed=3, corrupt="nan", corrupt_prob=0.3))
    diff = _same_run(torch, np, crash, twin)
    if diff is not None or sum(r.screened for r in
                               twin._records.records) <= 0:
        raise RuntimeError(f"scan crash twin: not bitwise ({diff})")
    print("scan crash twin: nan uploads screened, bitwise the crash run "
          "(params, L/H/theta, values, cohorts)", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    try:
        kr = dict(mlp, faults=FaultModel(seed=3, corrupt="nan",
                                          corrupt_prob=0.3))
        full = drive("kill/resume straight", "scan", 16, 8, **kr)
        drive("kill/resume first half", "scan", 16, 8,
              run_kw=dict(rounds=8, checkpoint_dir=tmp), **kr)
        resumed = drive("kill/resume resumed", "scan", 16, 8,
                        run_kw=dict(checkpoint_dir=tmp, resume=True),
                        resumed=8, **kr)
        diff = _scan_same_run(torch, np, full, resumed, 8)
        if diff is None and not (
                torch.equal(full.data_gen.get_state(),
                            resumed.data_gen.get_state())
                and torch.equal(full.sel_gen.get_state(),
                                resumed.sel_gen.get_state())):
            diff = "generator states"
        if diff is not None:
            raise RuntimeError(f"scan kill/resume not bitwise ({diff})")
        print("scan kill/resume at a block boundary: bitwise 16 straight "
              "rounds (params, residual, L/H/theta, values, cohorts, "
              "budgets, records, both CUDA generators)", flush=True)
        path = os.path.join(tmp, "scan.jsonl")
        with JsonlSink(path) as sink:
            sunk = drive("jsonl sink", "scan", 16, 8, sink=sink)
        plain = drive("no sink", "scan", 16, 8)
        _, recs = read_jsonl(path)
        same = (_same_run(torch, np, plain, sunk) is None
                and plain.host_syncs == sunk.host_syncs
                and recs == sunk._records.records and len(recs) == 16
                and all(r.loss_hist is not None for r in recs))
        if not same:
            raise RuntimeError("scan JsonlSink run: not the run without "
                               "a sink, or the file differs")
        print(f"scan JsonlSink: bitwise the run without, host_syncs "
              f"{sunk.host_syncs} both, 16 records read back with their "
              f"extras", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- speed: the three drivers in turns --------------------------------
    speed = {"numpy host": [], "device host": [], "scan": []}
    for _ in range(2):
        for label, driver, rng in (("numpy host", "host", "numpy"),
                                   ("device host", "host", "device"),
                                   ("scan", "scan", "")):
            srv = FedSAEServer(femnist, cfg=ServerConfig(**dict(
                base, rounds=40, driver=driver, block_size=16,
                rng_impl=rng)))
            srv.run(rounds=16)                       # warm-up, capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.run(rounds=40)
            torch.cuda.synchronize()
            speed[label].append(40 / (time.perf_counter() - t0))
    prog = srv.program
    prog.begin_block(40, srv._block_inputs(40, 16))
    wall, device_ms, top, _, n_launched = profiled(
        torch, lambda: prog.run(16))
    out["speed"] = dict(rounds_per_s=speed, block_rounds=16,
                        block_wall_ms=wall, block_device_ms=device_ms,
                        block_device_launches=n_launched,
                        capture_ms=prog.capture_ms, graph_nodes=prog.nodes,
                        top_kernels_ms=top[:5])
    print(f"scan speed (FEMNIST MCLR iid, 40 rounds a turn): "
          f"{json.dumps(out['speed'])}", flush=True)

    # -- card against CPU on the scan driver ------------------------------
    from repro_torch.data.federated import make_femnist_like
    small = make_femnist_like(n_clients=30, total=900, dim=64, max_size=40)
    lstm = make_sent140_like(n_clients=40, total=1200, vocab=260,
                             max_size=40)
    cases = (("mclr iid", small, dict(sampling="iid", batch_size=4,
                                      h_cap=6.0, fixed_epochs=4.0)),
             ("sent140 lstm shuffle", lstm, dict(sampling="shuffle",
                                                 h_cap=4.0,
                                                 fixed_epochs=4.0)))
    out["card_vs_cpu"] = {}
    for label, ds, cfg in cases:
        B = cfg.get("batch_size", 10)
        max_n = int(ds.sizes.max())
        iters = math.ceil(max(cfg["h_cap"], cfg["fixed_epochs"])
                          * math.ceil(max_n / B))
        shape = (6, iters, B) if cfg["sampling"] == "iid" else (6, max_n)

        def draws(t, n=ds.n_clients, shape=shape):
            r = np.random.default_rng(300 + t)
            return (r.normal(size=n).astype(np.float32),
                    -np.log(-np.log(r.random(n).astype(np.float32)
                                    + np.float32(1e-30))),
                    r.random(shape).astype(np.float32))

        runs = []
        for where in ("cuda", "cpu"):
            srv = FedSAEServer(ds, cfg=ServerConfig(**dict(
                cfg, algo="ira", n_selected=6, rounds=6, driver="scan",
                block_size=3, device=where)), device_draws=draws)
            if where == "cpu":
                srv.params = {k: v.cpu() for k, v in
                              runs[0][1].items()}
            runs.append((srv, {k: v.clone() for k, v in
                               srv.params.items()}))
            srv.run()
        prog = runs[0][0].program
        for k in counted:
            real[k] += prog.launches().get(k, 0)
        (card, _), (cpu, _) = runs
        err = max(float((card.params[k].cpu() - cpu.params[k]).abs().max())
                  for k in card.params)
        if (not all(np.array_equal(a, b) for a, b in
                    zip(card.cohorts, cpu.cohorts))
                or not np.array_equal(card.L, cpu.L) or err > TOL):
            raise RuntimeError(f"scan card vs CPU {label}: params "
                               f"max_abs_err {err}")
        out["card_vs_cpu"][label] = dict(max_abs_err=err,
                                         graph_nodes=prog.nodes,
                                         capture_ms=prog.capture_ms)
        print(f"scan card vs CPU, {label} (small federation, 6 rounds in "
              f"blocks of 3, injected draws): same cohorts and L/H, params "
              f"max_abs_err {err:.3e} (tol {TOL}); graph "
              f"{prog.nodes} nodes, captured in {prog.capture_ms:.1f} ms",
              flush=True)

    for k in ("fed_cohort_gather", "fed_local_sgd_mclr",
              "fed_local_sgd_dense", "fed_compress_topk_q8"):
        if real[k] <= 0:
            raise RuntimeError(f"the scan path never launched {k}")
    out["launches"] = real
    print(f"path scan launches (replays x launches a capture, plus the "
          f"eager rounds): {json.dumps(real)}", flush=True)
    return out


def _run_summary(srv) -> dict:
    """A finished server's state and records as host values: what two runs
    must share to be the same run (cohorts, budgets, L/H/theta, values,
    params, residual, the records but their wall times)."""
    from repro_torch.tree import tree_items
    return {"cohorts": [c.tolist() for c in srv.cohorts],
            "budgets": [b.tolist() for b in srv.budgets],
            "L": srv.L, "H": srv.H, "theta": srv.theta,
            "values": srv.values.v,
            "params": {k: v.cpu() for k, v in tree_items(srv.params)},
            "residual": (None if srv.residual is None
                         else srv.residual.cpu()),
            "records": _scan_records(srv)}


def _summary_diff(torch, np, a, b):
    """The first field where two ``_run_summary`` dicts differ bitwise, or
    None."""
    for k in ("cohorts", "budgets", "records"):
        if a[k] != b[k]:
            return k
    for k in ("L", "H", "theta", "values"):
        if not np.array_equal(a[k], b[k]):
            return k
    for k in a["params"]:
        if not torch.equal(a["params"][k], b["params"][k]):
            return f"params {k}"
    if (a["residual"] is None) != (b["residual"] is None) or (
            a["residual"] is not None
            and not torch.equal(a["residual"], b["residual"])):
        return "residual"
    return None


#: CUgraphNodeType values (cuda.h) -> names
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_node_types(graph) -> dict:
    """A kept CUDA graph's nodes counted by type (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``)."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                  ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def _gloo_rank(rank, cfg, rounds):
    """One rank of ``shard_phase``'s world of two gloo ranks on the one
    card (spawned by ``launch.mesh.spawn_world``): the scan driver refuses
    the gloo group, then the FEMNIST paper-scale federation runs on the
    host driver with the device streams, sharded over the two ranks;
    returns the run's summary and this rank's FL kernel launches."""
    import torch
    from repro_torch.core.graphs import FL_KERNELS
    from repro_torch.core.server import FedSAEServer, ServerConfig
    from repro_torch.data.federated import make_femnist_like
    ds = make_femnist_like()
    try:                    # gloo's collectives cannot join a CUDA graph
        FedSAEServer(ds, cfg=ServerConfig(**dict(cfg, driver="scan",
                                                 rng_impl="")))
        raise AssertionError("the scan driver took a gloo group on CUDA")
    except ValueError as e:
        if "cannot be captured" not in str(e):
            raise
    before = {k: fn.launches for k, fn in FL_KERNELS.items()}
    srv = FedSAEServer(ds, cfg=ServerConfig(**cfg))
    srv.run(rounds=rounds)
    torch.cuda.synchronize()
    return {"summary": _run_summary(srv), "launches": {
        k: fn.launches - before[k] for k, fn in FL_KERNELS.items()}}


def shard_phase(torch, np, FedSAEServer, ServerConfig, femnist, counted,
                frac):
    """Phase 9: client-axis sharding and prefetch at FEMNIST paper scale
    (200 clients, K=10, B=10, lr 0.03), every count set to 0 just before
    and read just after.  This process joins a world-1 NCCL group and
    runs, for MCLR iid and for the MLP + topk_q8, on the scan driver
    (graphed: the round's collectives captured with it) and on the host
    driver with device rng, 16 rounds each: the sharded run with capacity
    "full" (the masked K lanes) and with capacity 10 (the compacted
    lanes) bitwise its replicated run (cohorts, budgets, L/H/theta,
    values, params, residual, records but the wall time); capacity 4
    (slots overflow) scan bitwise host, overflow counted; the graph's
    nodes with and without the collectives.  Then a world of two gloo
    ranks spawned on the one card, the host driver with device rng,
    MCLR iid (capacity "full") and MLP + topk_q8 (capacity 10), each
    rank's run bitwise the world-1 run; any failure of the world fails
    the phase.  Prefetch (``prefetch="double_buffer"``) bitwise off on
    the scan driver, both models, in blocks of 8 and of 1.  Speed:
    FEMNIST MCLR iid rounds/s of the replicated scan and the world-1
    sharded scan in turns (40 rounds a turn after a 16-round warm-up,
    twice), then one block of 16 replays of each under torch.profiler
    (device ms, the device-to-device copies) and each graph's nodes by
    type."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh
    base = dict(algo="ira", n_selected=10, sampling="iid")
    mlp = dict(model="mlp", upload_compress="topk_q8", topk_frac=frac)
    out = {"legs": {}, "world1": {}}
    reset_counts(counted)
    real = {k: 0 for k in counted}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))

    def drive(label, driver, rounds=16, block=8, **cfg):
        before = {k: fn.launches for k, fn in counted.items()}
        srv = FedSAEServer(femnist, cfg=ServerConfig(**dict(
            base, rounds=rounds, driver=driver, block_size=block,
            rng_impl="device" if driver == "host" else "", **cfg)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches - before[k] for k, fn in counted.items()}
        prog = srv.program
        if prog.graphed:
            got = {k: prog.launches().get(k, 0) for k in counted}
        for k in counted:
            real[k] += got[k]
        for k, v in srv.params.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"shard {label}: non-finite params {k}")
        leg = dict(driver=driver, rounds=rounds, wall_s=wall,
                   rounds_per_s=rounds / wall,
                   overflowed=float(np.sum(srv.history["overflowed"])),
                   launches={k: v for k, v in got.items() if v})
        if prog.graphed:
            leg.update(graph_nodes=prog.nodes, capture_ms=prog.capture_ms,
                       replays=prog.replays)
        out["legs"][f"{label} {driver}"] = leg
        print(f"shard {label} {driver}: {json.dumps(leg)}", flush=True)
        return srv

    def same(label, a, b):
        diff = _summary_diff(torch, np, _run_summary(a), _run_summary(b))
        if diff is not None:
            raise RuntimeError(f"shard {label}: not bitwise ({diff})")

    try:
        for name, extra in (("mclr iid", {}), ("mlp topk_q8", mlp)):
            for driver in ("scan", "host"):
                rep = drive(f"{name} replicated", driver, **extra)
                for cap in ("full", 10):
                    sh = drive(f"{name} world-1 capacity {cap}", driver,
                               mesh_shards=1, cohort_capacity=cap, **extra)
                    same(f"{name} {driver} capacity {cap}", rep, sh)
                    if driver == "scan":
                        out["world1"][f"{name} capacity {cap}"] = dict(
                            graph_nodes=sh.program.nodes,
                            replicated_graph_nodes=rep.program.nodes)
                print(f"shard {name} {driver}: world-1 capacity full and "
                      f"10 bitwise the replicated run over 16 rounds",
                      flush=True)
                if driver == "scan":
                    pf = drive(f"{name} prefetch", "scan",
                               prefetch="double_buffer", **extra)
                    same(f"{name} prefetch", rep, pf)
                    # blocks of one round: prepare, then execute
                    same(f"{name} prefetch blocks of 1",
                         drive(f"{name} blocks of 1", "scan", block=1,
                               **extra),
                         drive(f"{name} prefetch blocks of 1", "scan",
                               block=1, prefetch="double_buffer", **extra))
                    print(f"shard {name}: prefetch double_buffer bitwise "
                          f"off on the scan driver, blocks of 8 and of 1",
                          flush=True)
            over = {d: drive(f"{name} world-1 capacity 4", d, mesh_shards=1,
                             cohort_capacity=4, **extra)
                    for d in ("scan", "host")}
            diff = _scan_same_run(torch, np, over["host"], over["scan"], 8)
            ovf = float(np.sum(over["scan"].history["overflowed"]))
            if diff is not None or ovf <= 0:
                raise RuntimeError(f"shard {name} capacity 4: scan vs host "
                                   f"{diff}, overflowed {ovf}")
            out["world1"][f"{name} capacity 4"] = dict(
                overflowed=ovf, graph_nodes=over["scan"].program.nodes)
            print(f"shard {name} capacity 4: {ovf:.0f} slots overflowed in "
                  f"16 rounds, scan bitwise host (device rng)", flush=True)

        # -- two gloo ranks on the one card ------------------------------
        # (no slot overflows at capacity "full" or 10 = K, so the two
        # layouts run the same federation)
        out["world2_gloo"] = {}
        for name, cap, extra in (("mclr iid", "full", {}),
                                 ("mlp topk_q8", 10, mlp)):
            cfg = dict(base, driver="host", rng_impl="device", rounds=8,
                       cohort_capacity=cap, **extra)
            one = drive(f"{name} world-1 for world-2", "host", rounds=8,
                        mesh_shards=1, cohort_capacity=cap, **extra)
            t0 = time.perf_counter()
            ranks = mesh.spawn_world(_gloo_rank, 2, backend="gloo",
                                     device="cuda",
                                     args=(dict(cfg, mesh_shards=2), 8))
            want = _run_summary(one)
            diffs = []
            for rank, r in enumerate(ranks):
                got = dict(r["summary"])
                if got["residual"] is not None:     # this rank's rows
                    C = got["residual"].shape[0]
                    got["residual"] = torch.cat(
                        [want["residual"][:rank * C], got["residual"],
                         want["residual"][(rank + 1) * C:]])
                diffs.append(_summary_diff(torch, np, want, got))
            if any(d is not None for d in diffs):
                raise RuntimeError(f"shard world-2 gloo {name}: not the "
                                   f"world-1 run ({diffs})")
            for r in ranks:
                for k in counted:
                    real[k] += r["launches"].get(k, 0)
            out["world2_gloo"][name] = dict(
                wall_s=time.perf_counter() - t0,
                launches=[r["launches"] for r in ranks])
            print(f"shard world-2 gloo {name}: both ranks bitwise the "
                  f"world-1 run over 8 rounds (capacity {cap}); launches "
                  f"{[r['launches'] for r in ranks]}", flush=True)

        # -- speed: replicated and world-1 sharded, in turns ------------
        speed = {"replicated": [], "world-1 sharded": []}
        last = {}
        for _ in range(2):
            for label, kw in (("replicated", {}),
                              ("world-1 sharded", dict(mesh_shards=1))):
                srv = FedSAEServer(femnist, cfg=ServerConfig(**dict(
                    base, rounds=40, driver="scan", block_size=16, **kw)))
                srv.run(rounds=16)                    # warm-up, capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                srv.run(rounds=40)
                torch.cuda.synchronize()
                speed[label].append(40 / (time.perf_counter() - t0))
                last[label] = srv
        # one block of 16 replays of each under torch.profiler, and each
        # program's graph nodes by type (NCCL runs a world-1 collective
        # as a device-to-device copy, no kernel)
        blocks = {}
        for label, srv in last.items():
            prog = srv.program
            prog.begin_block(40, srv._block_inputs(40, 16))
            wall, device_ms, top, copy_ms, n = profiled(
                torch, lambda: prog.run(16), part="Memcpy DtoD")
            types = graph_node_types(prog.graph)
            blocks[label] = dict(wall_ms=wall, device_ms=device_ms,
                                 launches=n, dtod_copy_ms=copy_ms,
                                 graph_nodes=prog.nodes, node_types=types,
                                 top_ms=top[:4])
        out["speed"] = dict(rounds_per_s=speed, block_of_16=blocks)
        print(f"shard speed (FEMNIST MCLR iid scan, 40 rounds a turn; one "
              f"block of 16 replays profiled): {json.dumps(out['speed'])}",
              flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    for k in ("fed_cohort_gather", "fed_local_sgd_mclr",
              "fed_local_sgd_dense", "fed_compress_topk_q8"):
        if real[k] <= 0:
            raise RuntimeError(f"the shard path never launched {k}")
    out["launches"] = real
    print(f"path shard launches (replays x launches a capture, plus the "
          f"eager rounds and the gloo ranks'): {json.dumps(real)}",
          flush=True)
    return out


#: A random full-depth MoE's residual stream grows doubly exponentially:
#: the experts take the un-normalised ``x`` (the reference's
#: ``moe.py:168``) and its expert stacks are drawn at scale E^-0.5, so
#: each MoE layer adds ~c x^2.  At the init, granite-moe-1b-a400m's
#: activations overflow to inf and NaN within its first layers, in the
#: reference and the port alike.  The full-width
#: MoE legs scale the drawn ``w_down`` of every expert stack by this
#: factor, which keeps all 24 layers' activations near their input's
#: scale (ROADMAP §C, "Reference caveats"; ``moe_scale_phase`` prints the
#: growth at either scale).
MOE_DOWN_SCALE = 1e-3
#: The same growth runs away under training: on the LM federation's
#: tweets SGD at the LM legs' 5e-3 turns the loss NaN within a few steps,
#: and at 5e-4 the scaled ``w_down`` regrows within a round's 8 steps
#: (``moe_scale_phase`` prints each lr's steps).  The full-width MoE
#: training legs take this lr.
MOE_LR = 1e-5
#: the lrs ``moe_scale_phase`` steps at: the LM legs', a tenth of it, and
#: ``MOE_LR``
MOE_PROBE_LRS = (5e-3, 5e-4, MOE_LR)
#: the full-width internvl2-2b as the packed round's local step on the
#: scan driver: K=2 (its 7.56 GB float32 copies fit where Llama's 14.4 GB
#: did not)
VLM_SCAN_K = 2
#: the layers of the full-width Falcon-Mamba-7B silo leg: the silo holds
#: ~4.2x the float32 params (Llama-3.2-3B's 3.61 B took 56.8 GiB), and 32
#: layers (3.90 B params) stay under ``DRYRUN_FIT`` of the card
SILO_FALCON_LAYERS = 32
#: the scan options of ROADMAP A13 (ii) (d), served and trained card vs
#: CPU on the Falcon-Mamba smoke config
SSM_OPTIONS = {"ssm_scan": "sequential", "ssm_input_dtype": "bfloat16"}


def tamed_init(init, cfg, scale=MOE_DOWN_SCALE):
    """``init`` with the expert stacks' ``w_down`` ([G, E, f, d]) scaled by
    ``scale`` for an MoE config; ``init`` itself otherwise."""
    if not cfg.n_experts:
        return init
    from repro_torch.tree import tree_items

    def init_scaled(generator):
        params = init(generator)
        for path, leaf in tree_items(params):
            if path.endswith("ffn/w_down") and leaf.dim() == 4:
                leaf.mul_(scale)
        return params
    return init_scaled


#: the smoke configs of this slice's decoder family that ``lm_fed_phase``
#: runs on the scan driver against the device-rng host driver
NEW_SMOKE_ARCHS = ("granite-moe-1b-a400m", "mistral-large-123b",
                   "kimi-k2-1t-a32b", "jamba-1.5-large-398b", "internvl2-2b")


def mixer_layers(cfg):
    """(attention layers, Mamba layers) of a decoder config: the hybrid's
    period-P group walk has one attention layer a group."""
    period = cfg.attn_period or 1
    attn = sum(cfg.is_attn_layer(p) for p in range(period))
    G = cfg.n_layers // period
    return attn * G, (period - attn) * G


def lm_launches(cfg, steps, evals=0, passes=0, xent_tc=True):
    """The LM kernels' launches of ``steps`` local steps, ``evals`` test
    evals and ``passes`` post-training loss passes (shuffle) of
    ``from_model(cfg)``, derived from ``models/decoder.py``: a step runs
    each layer's mixer forward once, twice under remat (the group is
    recomputed in the backward), the flash backward once an attention
    layer, the scan's backward once a Mamba layer, and the
    loss as one cross-entropy chunk forward and backward (25-token rows:
    S - 1 = 24 positions, below the 1,024-position chunk, so one chunk);
    an eval runs the forward without remat twice (``accuracy``, then
    ``loss``: one chunk); a pass once.  The MoE FFN launches no kernel.
    The backward launches its kernel on the tensor-core route only
    (``xent_tc``)."""
    n_attn, n_mamba = mixer_layers(cfg)
    fwd = (2 if cfg.remat else 1) * steps + 2 * evals + passes
    want = {"fused_softmax_xent_fwd": steps + evals + passes,
            "fused_softmax_xent_bwd": steps if xent_tc else 0}
    if n_attn:
        want["flash_attention_fwd"] = n_attn * fwd
        want["flash_attention_bwd"] = n_attn * steps
    if n_mamba:
        want["selective_scan_fwd"] = n_mamba * fwd
        want["selective_scan_bwd"] = n_mamba * steps
    return want


def check_lm_fed_shapes(torch, counted, ops, ref, cfgs, rows, S, gen,
                        tag="lm shapes"):
    """The LM kernels at the shapes a path's legs give them, outside the
    count: for each config of ``cfgs`` (arch label -> config) and each
    batch of ``rows`` (label -> sequences: a local step's minibatch, the
    test split), on an attention layer the flash forward (and, for a step,
    backward) on q/k/v [rows, S, H, hd] with the config's window, on a
    Mamba layer the selective scan at [rows, S, d_inner, N], and the fused
    cross-entropy forward (and backward) on h [rows * S, d], W [d, V], all
    bfloat16 as the legs run them (the scan and, for a step, its backward
    in float32), each against its plain version at
    phase 2's tolerances and each on the route the legs took: the flash
    calls on the tensor cores, the cross-entropy on the tensor cores
    whenever d is a multiple of 8 (``xent_on_tensor_cores``: W built into
    a ``[d, ceil8(V)]`` buffer as ``chunked_lm_loss`` builds it, its pad
    columns NaN), else on the CUDA cores with the plain recompute as its
    backward (printed, no kernel to hold).  All on ``gen``'s device.
    Returns {kernel: max_abs_err}."""
    from repro_torch.kernels.fused_xent import (fused_softmax_xent_fwd_lse,
                                                pitched, tensor_core_route)
    dev = gen.device
    bf16 = torch.bfloat16
    fa, fa_bwd = counted["flash_attention_fwd"], counted["flash_attention_bwd"]
    fx, bx = counted["fused_softmax_xent_fwd"], counted["fused_softmax_xent_bwd"]
    errs = {}

    def note(kernel, label, e, tol, ok, route_ok=True):
        errs[kernel] = max(errs.get(kernel, 0.0), *e)
        print(f"{tag} {kernel} {label}: max_abs_err "
              f"{[float(f'{x:.3e}') for x in e]} (tol {tol})", flush=True)
        if not ok:
            raise RuntimeError(f"{tag}: {kernel} differs from its plain "
                               f"version at {label}")
        if not route_ok:
            raise RuntimeError(f"{tag}: {kernel} took the wrong route at "
                               f"{label}")

    for arch, cfg in cfgs.items():
        n_attn, n_mamba = mixer_layers(cfg)
        window = cfg.window_size if cfg.attention == "sliding_window" else 0
        for what, B in rows.items():
            step = what == "step"
            label = f"{arch} {what}"
            if n_mamba:
                args = scan_inputs(torch, B, S, cfg.d_inner, cfg.ssm_state,
                                   gen, dev)
                y, hT = counted["selective_scan_fwd"](*args)
                wy, wh = ref.selective_scan(*args)
                torch.cuda.synchronize()
                e = [float((y - wy).abs().max()), float((hT - wh).abs().max())]
                note("selective_scan_fwd",
                     f"{label} B={B} S={S} d={cfg.d_inner} "
                     f"N={cfg.ssm_state}", e, SCAN_TOL,
                     torch.allclose(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
                     and torch.allclose(hT, wh, rtol=SCAN_TOL,
                                        atol=SCAN_TOL))
                if step:
                    gy = torch.randn(y.shape, generator=gen, device=dev)
                    gh = torch.randn(hT.shape, generator=gen, device=dev)
                    got = counted["selective_scan_bwd"](*args, gy, gh)
                    wants = ref.selective_scan_bwd(*args, gy, gh)
                    torch.cuda.synchronize()
                    scales = [max(float(w.abs().max()), 1e-6)
                              for w in wants]
                    note("selective_scan_bwd",
                         f"{label} B={B} S={S} d={cfg.d_inner} "
                         f"N={cfg.ssm_state}",
                         [float((g - w).abs().max())
                          for g, w in zip(got, wants)],
                         f"rtol {SCAN_BWD_TOL}, atol {SCAN_BWD_TOL} x "
                         f"max|want|",
                         all(torch.allclose(g, w, rtol=SCAN_BWD_TOL,
                                            atol=SCAN_BWD_TOL * sc)
                             for g, w, sc in zip(got, wants, scales)))
            if n_attn:
                hd = cfg.resolved_head_dim
                q, k, v, do = (torch.randn((B, S, H, hd), generator=gen,
                                           device=dev).to(bf16)
                               for H in (cfg.n_heads, cfg.n_kv_heads,
                                         cfg.n_kv_heads, cfg.n_heads))
                shape = (f"q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"window={window}")
                tc0 = fa.tensor_core_launches
                out, lse = fa(q, k, v, True, window)
                want, want_lse = ref.attention_lse(q, k, v, causal=True,
                                                   window=window)
                torch.cuda.synchronize()
                tol = LM_TOL["bfloat16"]
                note("flash_attention_fwd", f"{label} {shape}",
                     [float((out.float() - want.float()).abs().max()),
                      float((lse - want_lse).abs().max())],
                     f"{tol}, lse 2e-5",
                     torch.allclose(out.float(), want.float(), rtol=tol,
                                    atol=tol)
                     and torch.allclose(lse, want_lse, rtol=2e-5,
                                        atol=2e-5),
                     fa.tensor_core_launches == tc0 + 1)
                if step:
                    tc0 = fa_bwd.tensor_core_launches
                    got = fa_bwd(q, k, v, want.contiguous(), want_lse, do,
                                 True, window)
                    wants = ref.flash_attention_bwd(q, k, v, want,
                                                    want_lse, do,
                                                    causal=True,
                                                    window=window)
                    torch.cuda.synchronize()
                    atol, rtol = BWD_TOL["bfloat16"]
                    note("flash_attention_bwd", f"{label} {shape}",
                         [float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, wants)],
                         f"atol {atol}, rtol {rtol}",
                         all(torch.allclose(g.float(), w.float(), rtol=rtol,
                                            atol=atol)
                             for g, w in zip(got, wants)),
                         fa_bwd.tensor_core_launches == tc0 + 1)
                del q, k, v, do, out, lse, want, want_lse
            T, d, V = B * S, cfg.d_model, cfg.vocab_size
            h = torch.randn((T, d), generator=gen, device=dev).to(bf16)
            W = nan_padded(pitched, (torch.randn(
                (d, V), generator=gen, device=dev) * d ** -0.5).to(bf16))
            labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                                   dtype=torch.int32)
            tc = tensor_core_route(h, W)
            if tc != (d % 8 == 0):
                raise RuntimeError(f"{tag}: {label} W {tuple(W.shape)} "
                                   f"strides {W.stride()}: tensor-core "
                                   f"route {tc}")
            shape = (f"h={tuple(h.shape)} W={tuple(W.shape)} route "
                     f"{'tensor cores' if tc else 'CUDA cores'}")
            tc0, n0 = fx.tensor_core_launches, fx.launches
            got, lse = fused_softmax_xent_fwd_lse(h, W, labels)
            want, want_lse = ref.softmax_xent_lse(h, W, labels)
            torch.cuda.synchronize()
            note("fused_softmax_xent_fwd", f"{label} {shape}",
                 [float((got - want).abs().max()),
                  float((lse - want_lse).abs().max())], XENT_TOL,
                 torch.allclose(got, want, rtol=XENT_TOL, atol=XENT_TOL)
                 and torch.allclose(lse, want_lse, rtol=XENT_TOL,
                                    atol=XENT_TOL),
                 fx.launches == n0 + 1 and fx.tensor_core_launches == tc0 + tc)
            if step and not tc:
                print(f"{tag} fused_softmax_xent_bwd {label} {shape}: no "
                      f"kernel on this route; the op's backward is the "
                      f"plain recompute (ops._recompute_vjp of "
                      f"ref.softmax_xent)", flush=True)
            if step and tc:
                # a loss cotangent like the step's: mask / count
                g = torch.full((T,), 1.0 / T, device=dev)
                tc0 = bx.tensor_core_launches
                dh, dW = bx(h, W, labels, lse, g)
                wants = ops._recompute_vjp(ref.softmax_xent, (h, W, labels),
                                           (g,))[:2]
                torch.cuda.synchronize()
                scales = [float(w.float().abs().max()) for w in wants]
                note("fused_softmax_xent_bwd", f"{label} {shape}",
                     [float((a.float() - w.float()).abs().max())
                      for a, w in zip((dh, dW), wants)],
                     "rtol 2^-7, atol 2^-9 max|want|",
                     all(torch.allclose(a.float(), w.float(),
                                        rtol=XENT_BWD_RTOL,
                                        atol=XENT_BWD_ATOL * sc)
                         for a, w, sc in zip((dh, dW), wants, scales)),
                     bx.tensor_core_launches == tc0 + 1)
                del dh, dW, wants
            del h, W, got, lse, want, want_lse
            torch.cuda.empty_cache()
    return errs


def lm_fed_phase(torch, np, FedSAEServer, ServerConfig, counted,
                 get_config, make_sent140_like):
    """Phase 10: an architecture id as every client's local step of the
    packed round (ROADMAP A13 (iii)), the lanes trained one after another
    in place in their rows of one [K, ...] stack, every count set to 0
    just before and read just after.  The federation is Sent140-like from
    seed 0 (20 clients, 300 tweets of 25 tokens, vocabulary 300, at most
    20 a client; the test split cut to its first 64 rows), B=10, lr 5e-3.

    1. Llama-3.2-3B at full width and depth (``from_model(get_config(
       "llama3.2-3b"))``: 3.61 B float32 params, bf16 compute, remat on),
       K=2, h_cap = fixed_epochs = 4 (max_iters 8), the numpy host driver,
       iid, FedAvg, no compression (an error-feedback residual would be
       [N, P], 14.4 GB a client), 2 rounds: finite losses and params,
       L <= H, the peak device memory (< 80 GB), and the launches the
       recorded budgets imply (``lm_launches``: 56 flash forwards, 28
       backwards, one cross-entropy chunk forward and backward a local
       step; 56 flash forwards and one chunk an eval).  Then the scan
       driver at the same width, K=1, h_cap = fixed_epochs = 2 (max_iters
       4), one block of 2 rounds: the same checks, its graph nodes,
       capture time and peak memory printed.  Then granite-moe-1b-a400m
       the same way (1.38 B params, its random expert ``w_down`` scaled by
       ``MOE_DOWN_SCALE``, lr ``MOE_LR``), K=2 on the scan driver too, its
       cross-entropy on the tensor cores (V = 49,155, W pitched).
    2. The smoke configs the reference's CLI resolves (``model=
       "llama3.2-3b"`` and ``"falcon-mamba-7b"``, bf16), K=4, h_cap =
       fixed_epochs = 2 (max_iters 4), 4 rounds a leg: the numpy host
       driver iid and shuffle; the scan driver (blocks of 2: every lane's
       4 slots masked in the graph, no host read inside a block) bitwise
       the host driver with device rng; a world-1 NCCL sharded scan
       bitwise the replicated scan; topk_q8 (one compress launch a
       round); nan uploads at 0.5 with the screen bitwise their crash
       twin; a scan run killed and resumed at its block boundary bitwise
       the straight run.  The smoke configs of ``NEW_SMOKE_ARCHS`` by id,
       2 rounds on the scan driver bitwise the device-rng host driver.  Every leg's LM and FL launches are checked
       against its budgets (the scan legs': the warm-up's, the evals'
       and replays x one capture's), its rounds/s, budgets and graph
       nodes printed, the cross-entropy's route (tensor-core launches).
    3. The LM kernels at these legs' own shapes (``check_lm_fed_shapes``,
       outside the count): a local step's 10 sequences and the test
       split's 64, 24 positions, at both full widths and at every smoke
       width; and granite-moe's silo shape (one 2,048-token row).
    4. The float32 Llama smoke packed round on the card and on the CPU
       from the same init and draws, 2 rounds: the same cohorts, budgets
       and L/H, params and losses within 1e-4 (outside the count)."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.convert import params_to_numpy
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.faults import FaultModel
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import from_model
    from repro_torch.tree import tree_items
    out = {"legs": {}}
    reset_counts(counted)
    real = {k: 0 for k in counted}
    real_tc = {k: 0 for k in tensor_core_counts(counted)}
    ds = make_sent140_like(seed=0, n_clients=20, total=300, vocab=300,
                           max_size=20)
    ds = FederatedDataset(ds.name, ds.clients_x, ds.clients_y,
                          ds.test_x[:64], ds.test_y[:64], ds.n_classes,
                          task="text")
    base = dict(algo="ira", batch_size=10, lr=5e-3, sampling="iid")

    def drive(label, arch_cfg, rounds, model=None, run_kw=None,
              resumed=0, **cfg):
        """One leg: a server run, its real launches (the scan legs' put
        together from the program's counts) checked against its budgets
        and added to the path's."""
        before = {k: fn.launches for k, fn in counted.items()}
        tc_before = tensor_core_counts(counted)
        srv = FedSAEServer(ds, model=model, cfg=ServerConfig(**dict(
            base, rounds=rounds, **cfg)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_plain(ref, "softmax_xent") as recomputes, \
                counting_plain(ref, *PLAIN_SCANS) as plain_scans:
            srv.run(**(run_kw or {}))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if plain_scans:
            raise RuntimeError(f"lm {label}: the plain scan ran on the card"
                               f" ({plain_scans[:4]}...)")
        got = {k: fn.launches - before[k] for k, fn in counted.items()}
        tc = {k: v - tc_before[k] for k, v in
              tensor_core_counts(counted).items()}
        prog = srv.program
        if prog is not None and prog.graphed:
            # the counters ran at the warm-up, once at capture and in the
            # evals: add the other replays' launches
            for k in got:
                got[k] += (prog.replays - 1) * prog.per_replay.get(k, 0)
            for k in tc:
                tc[k] += ((prog.replays - 1)
                          * prog.per_replay_tensor_core.get(k, 0))
        for k in counted:
            real[k] += got[k]
        for k in tc:
            real_tc[k] += tc[k]
        # what the budgets imply: the numpy host driver runs each lane's
        # budget, the device rounds every lane's max_iters slots (the
        # scan's warm-up round too); one eval a round on the host drivers,
        # a block on the scan
        n = (run_kw or {}).get("rounds", rounds) - resumed
        K = int(srv.cfg.n_selected)
        device = srv.rng_impl == "device"
        executed = (prog.replays + 1 if prog is not None and prog.graphed
                    else n)
        steps = (executed * K * srv.max_iters if device
                 else int(sum(int(b.sum()) for b in srv.budgets[-n:])))
        evals = (-(-n // srv.block_size) if srv.cfg.driver == "scan"
                 else n)
        passes = executed * K if srv.cfg.sampling == "shuffle" else 0
        xent_tc = xent_on_tensor_cores(arch_cfg)
        if (tc["fused_softmax_xent_fwd"] != (got["fused_softmax_xent_fwd"]
                                             if xent_tc else 0)
                or (xent_tc and recomputes)):
            raise RuntimeError(
                f"lm {label}: cross-entropy forwards {got} of which "
                f"{tc['fused_softmax_xent_fwd']} on the tensor cores, "
                f"{len(recomputes)} plain recomputes; wanted "
                f"{'every one and none' if xent_tc else 'none'}")
        want = dict({k: 0 for k in counted},
                    **lm_launches(arch_cfg, steps, evals, passes, xent_tc),
                    fed_cohort_gather=executed)
        if srv.engine.compressing:
            want["fed_compress_topk_q8"] = executed
        if got != want:
            raise RuntimeError(f"lm {label}: launched {got}, the budgets "
                               f"({steps} local steps, {evals} evals, "
                               f"{passes} passes) imply {want}")
        hist = srv.history
        loss = np.asarray(hist["train_loss"], np.float64)
        if not np.isfinite(loss[~np.isnan(loss)]).all() or not np.isfinite(
                loss).any() or not (srv.L <= srv.H).all():
            raise RuntimeError(f"lm {label}: losses {hist['train_loss']}, "
                               f"L {srv.L}, H {srv.H}")
        for k, v in tree_items(srv.params):
            if not torch.isfinite(v).all():
                raise RuntimeError(f"lm {label}: non-finite params {k}")
        leg = dict(rounds=n, wall_s=wall, rounds_per_s=n / wall,
                   local_steps=steps, max_iters=srv.max_iters,
                   budgets=[b.tolist() for b in srv.budgets[-n:]],
                   train_loss=hist["train_loss"][-n:],
                   xent_route="tensor cores" if xent_tc else "CUDA cores",
                   plain_xent_recomputes=len(recomputes),
                   launches={k: v for k, v in got.items() if v},
                   tensor_core_launches={k: v for k, v in tc.items() if v})
        if prog is not None and prog.graphed:
            leg.update(graph_nodes=prog.nodes, capture_ms=prog.capture_ms,
                       replays=prog.replays)
        out["legs"][label] = leg
        print(f"lm {label}: {json.dumps(leg)}", flush=True)
        return srv

    def same(label, a, b, budgets=True):
        diff = _same_run(torch, np, a, b)
        if diff is None and budgets and not all(
                np.array_equal(x, y) for x, y in zip(a.budgets, b.budgets)):
            diff = "budgets"
        if diff is not None:
            raise RuntimeError(f"lm {label}: not bitwise ({diff})")
        print(f"lm {label}: bitwise", flush=True)

    # -- 1. full width: Llama-3.2-3B, then granite-moe-1b-a400m ----------
    def full_width(arch, scan_K, lr=base["lr"]):
        """K=2 on the numpy host driver (h_cap = fixed_epochs = 4:
        max_iters 8), then the scan driver at K=``scan_K`` (h_cap =
        fixed_epochs = 2: max_iters 4, one block of 2 rounds), both at
        ``lr``; each leg's peak memory, the host leg's ms a local step,
        the scan leg's graph nodes and capture time."""
        fcfg = get_config(arch)

        def step():
            s = from_model(fcfg)
            s.init_params = s.init = tamed_init(s.init_params, fcfg)
            return s

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        label = f"{arch} full width host iid"
        full = drive(label, fcfg, 2, model=step(), n_selected=2,
                     h_cap=4.0, fixed_epochs=4.0, lr=lr)
        peak = torch.cuda.max_memory_allocated()
        if peak >= 80e9:
            raise RuntimeError(f"lm {arch} full width: peak "
                               f"{peak / 1e9:.1f} GB")
        leg = out["legs"][label]
        # round 1's wall less one eval (timed again here, outside the
        # count) over its local steps: the steady local step, the round's
        # gather and aggregation included
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full.eval_fn(full.params, full.test_x, full.test_y)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        leg.update(peak_gb=peak / 1e9, peak_gib=peak / 2**30,
                   params=sum(v.numel() for _, v in tree_items(full.params)),
                   round_wall_s=full.wall_times, eval_s=eval_s,
                   ms_per_local_step=(full.wall_times[1] - eval_s)
                   / max(int(full.budgets[1].sum()), 1) * 1e3)
        print(f"lm {arch} full width: {leg['params']} params, peak "
              f"{leg['peak_gb']:.2f} GB ({leg['peak_gib']:.2f} GiB), round "
              f"walls {[round(w, 3) for w in full.wall_times]} s (eval "
              f"included; an eval {eval_s * 1e3:.1f} ms), round 1: "
              f"{leg['ms_per_local_step']:.1f} ms a local step, "
              f"cross-entropy route {leg['xent_route']} "
              f"({leg['plain_xent_recomputes']} plain recomputes)",
              flush=True)
        del full
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        label = f"{arch} full width scan iid"
        fscan = drive(label, fcfg, 2, model=step(),
                      n_selected=scan_K, h_cap=2.0, fixed_epochs=2.0,
                      driver="scan", block_size=2, lr=lr)
        leg = out["legs"][label]
        leg.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
        print(f"lm {arch} full width scan K={scan_K}: {leg['graph_nodes']} "
              f"graph nodes, capture {leg['capture_ms']:.1f} ms, "
              f"{leg['replays']} replays of {scan_K} x {fscan.max_iters} "
              f"local steps, peak {leg['peak_gb']:.2f} GB allocated, "
              f"{leg['peak_reserved_gb']:.2f} GB reserved, cross-entropy "
              f"route {leg['xent_route']} ({leg['plain_xent_recomputes']} "
              f"plain recomputes)", flush=True)
        del fscan
        torch.cuda.empty_cache()
        return fcfg

    # Llama's scan at K=2 does not fit (the server's params, the program's
    # carry, the new global and the stack with the aggregation's
    # temporaries pass 80 GB); granite-moe's copies are 5.5 GB
    full_cfg = full_width("llama3.2-3b", 1)
    moe_cfg = full_width("granite-moe-1b-a400m", 2, lr=MOE_LR)
    # the VLM (1.89 B params, 7.56 GB a copy in float32) on the clients'
    # tokens alone: its modality_proj's gradient is zero; K=2 on the scan
    vlm_cfg = full_width("internvl2-2b", VLM_SCAN_K)

    # -- 2. the smoke configs ----------------------------------------------
    smoke = dict(n_selected=4, h_cap=2.0, fixed_epochs=2.0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        for arch in ("llama3.2-3b", "falcon-mamba-7b"):
            acfg = get_config(arch, smoke=True)
            kw = dict(smoke, model=arch)
            drive(f"{arch} host iid", acfg, 4, **kw)
            drive(f"{arch} host shuffle", acfg, 4,
                  **dict(kw, sampling="shuffle"))
            host = drive(f"{arch} device-rng host iid", acfg, 4,
                         rng_impl="device", block_size=2, **kw)
            scan = drive(f"{arch} scan iid", acfg, 4, driver="scan",
                         block_size=2, **kw)
            same(f"{arch} scan vs device-rng host", host, scan)
            sharded = drive(f"{arch} world-1 sharded scan iid", acfg, 4,
                            driver="scan", block_size=2, mesh_shards=1,
                            **kw)
            same(f"{arch} world-1 NCCL sharded scan vs replicated", scan,
                 sharded)
            drive(f"{arch} host iid topk_q8", acfg, 4,
                  upload_compress="topk_q8", **kw)
            fm = dict(seed=1, corrupt_prob=0.5)
            nan = drive(f"{arch} host iid nan", acfg, 4,
                        faults=FaultModel(corrupt="nan", **fm), **kw)
            crash = drive(f"{arch} host iid crash", acfg, 4,
                          faults=FaultModel(corrupt="crash", **fm),
                          upload_screen="on", **kw)
            if not sum(r.screened for r in nan._records.records):
                raise RuntimeError(f"lm {arch}: no nan upload screened")
            same(f"{arch} nan + screen vs its crash twin", nan, crash,
                 budgets=False)
            ck = os.path.join(tmp, f"ck_{arch}")
            drive(f"{arch} scan killed", acfg, 4, driver="scan",
                  block_size=2, run_kw=dict(rounds=2, checkpoint_dir=ck),
                  **kw)
            resumed = drive(f"{arch} scan resumed", acfg, 4, driver="scan",
                            block_size=2, resumed=2,
                            run_kw=dict(checkpoint_dir=ck, resume=True),
                            **kw)
            same(f"{arch} scan kill/resume vs straight", scan, resumed)
        # the decoder family this slice ports, by id as ``fl_train --model
        # <id>`` resolves it (its bf16 smoke config): 2 rounds on the scan
        # driver bitwise the device-rng host driver
        for arch in NEW_SMOKE_ARCHS:
            acfg = get_config(arch, smoke=True)
            kw = dict(smoke, model=arch)
            host = drive(f"{arch} device-rng host iid", acfg, 2,
                         rng_impl="device", block_size=2, **kw)
            scan = drive(f"{arch} scan iid", acfg, 2, driver="scan",
                         block_size=2, **kw)
            same(f"{arch} scan vs device-rng host", host, scan)
        # the VLM by id on the numpy host driver too, and with topk_q8
        acfg = get_config("internvl2-2b", smoke=True)
        kw = dict(smoke, model="internvl2-2b")
        drive("internvl2-2b host iid", acfg, 2, **kw)
        drive("internvl2-2b host iid topk_q8", acfg, 2,
              upload_compress="topk_q8", **kw)
        # the encoder-decoder is no local step: the reference's error
        try:
            FedSAEServer(ds, cfg=ServerConfig(**dict(
                base, rounds=1, model="whisper-tiny")))
        except ValueError as e:
            if "decoder-only" not in str(e):
                raise
            out["whisper_by_id"] = str(e)
            print(f"lm whisper-tiny by id raises: {e}", flush=True)
        else:
            raise RuntimeError("lm whisper-tiny by id built a server")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = dict(real)
    out["tensor_core_launches"] = dict(real_tc)
    print(f"path lm_fed launches: {json.dumps(real)}, tensor-core "
          f"{json.dumps(real_tc)}", flush=True)

    # -- 3. the kernels at the legs' shapes (outside the count) ----------
    gen = torch.Generator("cuda").manual_seed(3)
    cfgs = {"llama3.2-3b full width": full_cfg,
            "granite-moe-1b-a400m full width": moe_cfg,
            "internvl2-2b full width": vlm_cfg}
    cfgs.update({f"{a} smoke": get_config(a, smoke=True)
                 for a in ("llama3.2-3b", "falcon-mamba-7b")
                 + NEW_SMOKE_ARCHS})
    out["shape_errs"] = check_lm_fed_shapes(
        torch, counted, ops, ref, cfgs,
        {"step": base["batch_size"], "eval": len(ds.test_y)},
        ds.clients_x[0].shape[1] - 1, gen)
    # and at the silo's shape: one 2,048-token row a step
    for k, e in check_lm_fed_shapes(
            torch, counted, ops, ref,
            {"granite-moe-1b-a400m full width": moe_cfg}, {"step": 1}, 2048,
            gen, tag="silo shapes").items():
        out["shape_errs"][k] = max(out["shape_errs"].get(k, 0.0), e)

    # -- 4. card vs CPU, float32 Llama smoke (outside the count) --------
    acfg = get_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    step = from_model(acfg)
    init = params_to_numpy(step.init_params(
        torch.Generator("cpu").manual_seed(0)))

    def draws(t, ids, n):
        r = np.random.default_rng(100 + t)
        return (r.random((len(ids), 4, 10))
                * np.maximum(n, 1)[:, None, None]).astype(np.int32)

    runs = []
    for where in ("cuda", "cpu"):
        srv = FedSAEServer(ds, model=step, cfg=ServerConfig(**dict(
            base, **smoke, rounds=2, device=where)), init_params=init,
            data_draws=draws)
        srv.run()
        runs.append(srv)
    card, cpu = runs
    if not (all(np.array_equal(a, b) for a, b in zip(card.cohorts,
                                                     cpu.cohorts))
            and all(np.array_equal(a, b) for a, b in zip(card.budgets,
                                                         cpu.budgets))
            and np.array_equal(card.L, cpu.L)
            and np.array_equal(card.H, cpu.H)):
        raise RuntimeError("lm card vs CPU: cohorts, budgets or L/H differ")
    cp = dict(tree_items(cpu.params))
    p_err = max(float((v.cpu() - cp[k]).abs().max())
                for k, v in tree_items(card.params))
    l_err = float(np.nanmax(np.abs(np.subtract(
        card.history["train_loss"], cpu.history["train_loss"]))))
    if not p_err <= TRAIN_TOL or not l_err <= TRAIN_TOL:
        raise RuntimeError(f"lm card vs CPU: params differ by {p_err}, "
                           f"losses by {l_err} (tol {TRAIN_TOL})")
    out["card_vs_cpu"] = dict(params_max_abs_err=p_err,
                              loss_max_abs_err=l_err,
                              budgets=[b.tolist() for b in card.budgets])
    print(f"lm card vs CPU, float32 Llama smoke, 2 host rounds: same "
          f"cohorts, budgets and L/H; params max_abs_err {p_err:.3e}, "
          f"losses {l_err:.3e} (tol {TRAIN_TOL})", flush=True)
    return out


def moe_scale_phase(torch, np, get_config, make_sent140_like):
    """Why the full-width MoE legs scale their random ``w_down`` and take
    ``MOE_LR`` (outside the count): granite-moe-1b-a400m at full width, a
    forward pass over 10 of the LM federation's tweets (24 positions) at
    the init's ``w_down`` and at ``MOE_DOWN_SCALE``, printing the largest
    |h| after each layer; then at the scaled init 8 SGD steps
    (``LocalStep.local_sgd_step``) at each of ``MOE_PROBE_LRS``, printing
    the losses and the largest |w_down|.  Fails unless the scaled forward
    and the steps at ``MOE_LR`` stay finite."""
    from repro_torch.models import decoder
    from repro_torch.models.api import from_model
    from repro_torch.tree import tree_items
    cfg = get_config("granite-moe-1b-a400m")
    step = from_model(cfg)
    dev = torch.device("cuda")
    tweets = np.concatenate(make_sent140_like(
        seed=0, n_clients=20, total=300, vocab=300, max_size=20).clients_x)
    ri = np.random.default_rng(1)
    batches = [torch.as_tensor(tweets[ri.integers(0, len(tweets), 10)],
                               dtype=torch.int32, device=dev)
               for _ in range(8)]
    out = {"max_h": {}, "steps": {}}

    def init(scale):
        return tamed_init(step.init_params, cfg, scale)(
            torch.Generator(dev).manual_seed(7))

    for scale in (1.0, MOE_DOWN_SCALE):
        params = init(scale)
        h = decoder.embed_inputs(params, cfg, {"tokens": batches[0][:, :-1]})
        B, S = h.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
        mags = []
        with torch.no_grad():
            for g in range(cfg.n_layers):
                h, _, _ = decoder._apply_block(
                    decoder.group(params["blocks"], g)["pos0"], cfg, 0, h,
                    pos, "train", None, None)
                mags.append(float(h.float().abs().max()))
        out["max_h"][str(scale)] = mags
        print(f"moe scale granite-moe-1b-a400m w_down x {scale}: max|h| "
              f"after each layer {[float(f'{m:.3g}') for m in mags]}",
              flush=True)
        del params, h
        torch.cuda.empty_cache()
    if not all(math.isfinite(m) for m in out["max_h"][str(MOE_DOWN_SCALE)]):
        raise RuntimeError("moe scale: the scaled forward is not finite")
    for lr in MOE_PROBE_LRS:
        params = init(MOE_DOWN_SCALE)
        losses, w_down = [], []
        for x in batches:
            params, loss = step.local_sgd_step(
                params, {"x": x, "mask": torch.ones(10, device=dev)}, lr)
            losses.append(float(loss))
            w_down.append(max(float(v.abs().max()) for k, v in
                              tree_items(params) if k.endswith("ffn/w_down")))
        out["steps"][str(lr)] = dict(losses=losses, max_w_down=w_down)
        print(f"moe scale granite-moe-1b-a400m lr {lr}: losses "
              f"{[round(x, 4) for x in losses]}, max|w_down| "
              f"{[float(f'{x:.3g}') for x in w_down]}", flush=True)
        del params
        torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in out["steps"][str(MOE_LR)]["losses"]):
        raise RuntimeError(f"moe scale: the steps at lr {MOE_LR} are not "
                           f"finite")
    return out


def padded_phase(torch, np, femnist, counted):
    """The seed interface's padded round (``core.rounds.make_round_fn``
    over ``RoundEngine.make_padded_round``, ROADMAP A16) on FEMNIST at
    paper scale: K=10 host-stacked clients a round (``stacked``), B=10,
    lr 0.03, max_iters 960, budgets drawn in [0, 960] (one lane 0, one
    960), numpy draws.  MCLR iid and the MLP iid 3 rounds each, MCLR
    shuffle 1 round, each on the card and on the CPU from the same init,
    clients, budgets and draws: params and losses within 2e-5.  Every
    count is set to 0 just before; the card's iid legs launch the fused
    local-SGD kernel once a round (B2 for MCLR, B3 for the MLP), the
    shuffle leg none (the plain walk), the CPU runs none."""
    from repro_torch.convert import params_from_reference, params_to_numpy
    from repro_torch.core.rounds import make_round_fn
    from repro_torch.models.fl_models import make_mclr, make_mlp
    K, B, max_iters, lr = 10, 10, 960, 0.03
    max_n = int(femnist.sizes.max())
    d, C = femnist.clients_x[0].shape[1], femnist.n_classes
    out = {"legs": {}}
    reset_counts(counted)
    for label, step, sampling, rounds, kernel in (
            ("mclr iid", make_mclr(d, C), "iid", 3, "fed_local_sgd_mclr"),
            ("mlp iid", make_mlp(d, C), "iid", 3, "fed_local_sgd_dense"),
            ("mclr shuffle", make_mclr(d, C), "shuffle", 1, None)):
        init = params_to_numpy(step.init_params(
            torch.Generator().manual_seed(0)))
        ri = np.random.default_rng(5)
        plan = []
        for _ in range(rounds):
            x, y, mask, n = femnist.stacked(
                ri.choice(femnist.n_clients, K, replace=False), max_n)
            n_iters = ri.integers(0, max_iters + 1, K).astype(np.int32)
            n_iters[0], n_iters[1] = 0, max_iters
            draws = ((ri.random((K, max_iters, B))
                      * np.maximum(n, 1)[:, None, None]).astype(np.int32)
                     if sampling == "iid"
                     else ri.random((K, max_n)).astype(np.float32))
            plan.append(((x, y, mask, n, n_iters), draws))
        runs = {}
        for where in ("cuda", "cpu"):
            fn = make_round_fn(step, lr, B, max_iters, sampling=sampling)
            params = params_from_reference(init, where)
            before = {k: f.launches for k, f in counted.items()}
            walls, losses = [], []
            for args, draws in plan:
                t0 = time.perf_counter()
                params, loss, up = fn(params, *args, draws=draws)
                if where == "cuda":
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(loss.cpu())
                if not bool(up):
                    raise RuntimeError(f"padded {label}: nothing uploaded")
            got = {k: f.launches - before[k] for k, f in counted.items()}
            runs[where] = (params, torch.stack(losses), got, walls)
        (pc, lc, got, walls), (pp, lp, got_cpu, cpu_walls) = (
            runs["cuda"], runs["cpu"])
        want = {k: 0 for k in counted}
        if kernel:
            want[kernel] = rounds
        if got != want or any(got_cpu.values()):
            raise RuntimeError(f"padded {label}: the card launched {got}, "
                               f"wanted {want}; the CPU {got_cpu}")
        p_err = max(float((pc[k].cpu() - pp[k]).abs().max()) for k in pp)
        l_err = float((lc - lp).abs().max())
        if not (all(torch.allclose(pc[k].cpu(), pp[k], rtol=TOL, atol=TOL)
                    for k in pp)
                and torch.allclose(lc, lp, rtol=TOL, atol=TOL)):
            raise RuntimeError(f"padded {label}: card and CPU differ, "
                               f"params {p_err}, losses {l_err}")
        for k, v in pc.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"padded {label}: non-finite {k}")
        out["legs"][label] = dict(
            rounds=rounds, launches={k: v for k, v in got.items() if v},
            params_max_abs_err=p_err, loss_max_abs_err=l_err,
            round_wall_s=walls, cpu_round_wall_s=cpu_walls,
            budgets=[a[4].tolist() for a, _ in plan])
        print(f"padded {label}: {rounds} rounds card vs CPU, params "
              f"max_abs_err {p_err:.3e}, losses {l_err:.3e} (tol {TOL}); "
              f"launches {json.dumps(out['legs'][label]['launches'])}; "
              f"round wall card {[round(w, 4) for w in walls]} s, CPU "
              f"{[round(w, 3) for w in cpu_walls]} s", flush=True)
    out["launches"] = {k: f.launches for k, f in counted.items()}
    print(f"path padded launches: {json.dumps(out['launches'])}",
          flush=True)
    return out


# the experiments phase's cuts, in rounds only (every width is the
# paper's): Table II at paper scale 1 round a run, the figures 3 of their
# 40, the recipe 20 of its 200 (from 2, 5 and 40, whose 119, 38 and 13 s
# of 183 in the phase pushed the script to 1,115 s on a slow host once
# Falcon-Mamba-7B trained on the card; PERF.md §6); the card-vs-CPU leg
# runs 5 reduced rounds
EXP_CARD_CPU_ROUNDS = 5
EXP_TABLE2_ROUNDS = 1
EXP_FIG_ROUNDS = 3
EXP_RECIPE_ROUNDS = 20
RECIPE = os.path.join(HERE, "examples", "paper_scale_fl_torch.py")


def nan_array(np, values):
    """A history list (None for NaN, as the payload writes it) as float64."""
    return np.array([np.nan if v is None else v for v in values], np.float64)


def gather_shape_row(torch, np, ref, gather, ds, K, flush, seed):
    """The gather on ``ds``'s paper-scale federation at cohort size K,
    bitwise its plain version (an empty lane, the largest client's full
    lane, a start past rows - max_n, clamped), then timed beside its
    plain version, ``flat_x[idx]`` and its bound."""
    dev = torch.device("cuda")
    max_n = int(ds.sizes.max())
    pk = ds.packed(max_n, device=dev)
    flat_x = pk.x.contiguous()
    rows, feat = flat_x.shape
    ids = np.random.default_rng(seed).choice(ds.n_clients, K, replace=False)
    ids[1] = int(np.argmax(ds.sizes))
    ids_t = torch.as_tensor(ids, device=dev)
    starts = pk.offsets[ids_t].contiguous()
    ns = torch.clamp(pk.lengths[ids_t], max=max_n)
    ns[0] = 0
    starts[2] = rows - 5
    got = gather(flat_x, pk.y, starts, ns, max_n)
    want = ref.fed_cohort_gather(flat_x, pk.y, starts, ns, max_n=max_n)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("x", "y", "mask")):
        if not torch.equal(g, w):
            raise RuntimeError(f"gather kernel differs from plain on "
                               f"{ds.name} at K={K} ({what})")
    if int(got[2][0].sum()) != 0 or int(got[2][1].sum()) != max_n:
        raise RuntimeError(f"{ds.name} gather case: no empty and full lane")
    lib_idx = (torch.clamp(starts.long(), max=rows - max_n)[:, None]
               + torch.arange(max_n, device=dev)[None, :])
    spin(torch)
    ms = time_ms(torch, lambda: gather(flat_x, pk.y, starts, ns, max_n), 50,
                 flush)
    plain = time_ms(torch, lambda: ref.fed_cohort_gather(
        flat_x, pk.y, starts, ns, max_n=max_n), 20, flush)
    lib = time_ms(torch, lambda: flat_x[lib_idx], 50, flush)
    nbytes = gather_work(K, max_n, feat)[1]
    b_ms, b_by = bound(nbytes, 0)
    row = dict(K=K, max_n=max_n, feat=feat, rows=rows, ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               max_abs_err=0.0)
    print(f"fed_cohort_gather {ds.name} paper scale K={K} max_n={max_n} "
          f"feat={feat} ({feat * 4} B rows, lanes n = {ns.tolist()}): "
          f"bitwise equal; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"flat_x[idx] {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{nbytes} B)", flush=True)
    return row


def experiments_phase(torch, np, counted, ref):
    """The paper's experiments on the port (``repro_torch.experiments``,
    each run ``FedSAEServer`` on the host driver, ``sampling="shuffle"``):
    the gather at the new shapes, bitwise (MNIST-like at K=30, Synthetic
    (1,1) at its largest ``max_n``); then, with every count set to 0, a
    reduced FEMNIST Ira run on the card and on the CPU from the same
    numpy init and shuffle draws (dropout, assigned, uploaded, true
    workload and the cohorts bitwise, train loss within ``TOL``, accuracy
    within 2/test_n); Table II at paper scale on all four datasets
    (``EXP_TABLE2_ROUNDS`` rounds a run), Figs. 1, 5, 7 and 8 at reduced
    scale (``EXP_FIG_ROUNDS``), and the paper-scale recipe
    (``examples/paper_scale_fl_torch.py``: 1,000 clients, K=30, Fassa with
    AL for the first quarter, ``EXP_RECIPE_ROUNDS``).  Each run's rounds/s
    and longest budgets are printed beside its CSV line, every final
    accuracy must be finite, and the gather's launches must be exactly
    the rounds the configs run: one a round, a FedAvg round whose whole
    cohort dropped included."""
    import importlib.util
    import tempfile

    from repro_torch.data.federated import make_mnist_like, make_synthetic
    from repro_torch.experiments import (common, fig1_motivation,
                                         fig5_u_sweep, fig6_table2_main,
                                         fig7_fassa_params, fig8_table3_al)
    t_phase = time.perf_counter()
    gather = counted["fed_cohort_gather"]
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    out = {"cuts": {"card_vs_cpu_rounds": EXP_CARD_CPU_ROUNDS,
                    "table2_paper_rounds": EXP_TABLE2_ROUNDS,
                    "figure_reduced_rounds": EXP_FIG_ROUNDS,
                    "recipe_rounds": EXP_RECIPE_ROUNDS},
           "gather_shapes": {}, "runs": []}
    mnist_paper, synth_paper = make_mnist_like(), make_synthetic()
    out["gather_shapes"]["mnist K=30"] = gather_shape_row(
        torch, np, ref, gather, mnist_paper, 30, flush, 3)
    out["gather_shapes"]["synthetic K=10"] = gather_shape_row(
        torch, np, ref, gather, synth_paper, 10, flush, 4)
    del flush, mnist_paper, synth_paper
    torch.cuda.empty_cache()

    # the launches every run makes, worked out from the configs
    R2, Rf, Rr = EXP_TABLE2_ROUNDS, EXP_FIG_ROUNDS, EXP_RECIPE_ROUNDS
    suites = (("fig1_motivation", fig1_motivation.run, 2 * 4),
              ("fig5_u_sweep", fig5_u_sweep.run, 2 * 4),
              ("fig7_fassa_params", fig7_fassa_params.run,
               2 * len(fig7_fassa_params.GRID)),
              ("fig8_table3_al", fig8_table3_al.run,
               2 * len(fig8_table3_al.al_grid(Rf))))
    n_table2 = len(fig6_table2_main.ALGOS) * len(fig6_table2_main.DATASETS)
    want = dict({k: 0 for k in counted}, fed_cohort_gather=(
        EXP_CARD_CPU_ROUNDS + n_table2 * R2 + sum(n for *_, n in suites) * Rf
        + Rr))
    current = {"suite": "card_vs_cpu"}
    inner = common.run_made

    def timed_run(srv, config, dataset_name):
        budgets = record_budgets(srv)
        on_card = srv.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = inner(srv, config, dataset_name)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        R = config["rounds"]
        knobs = {k: v for k, v in config.items()
                 if k not in ("algo", "rounds", "n_selected", "lr", "h_cap",
                              "eval_every", "seed")}
        longest = [max(b) for b in budgets]
        run = dict(suite=current["suite"], dataset=dataset_name,
                   algo=config["algo"], knobs=knobs, device=srv.device.type,
                   clients=srv.ds.n_clients, K=config["n_selected"],
                   rounds=R, wall_s=wall, rounds_per_s=R / wall,
                   longest_budgets=longest,
                   round_wall_s=[round(w, 4) for w in srv.wall_times],
                   all_dropped_rounds=int(sum(
                       d == 1.0 for d in payload["history"]["dropout"])),
                   final_acc=payload["final_acc"],
                   mean_dropout=payload["mean_dropout"])
        if not math.isfinite(payload["final_acc"]):
            raise RuntimeError(f"experiments: final accuracy not finite "
                               f"({run})")
        out["runs"].append(run)
        print(f"experiments run {current['suite']} {dataset_name} "
              f"{config['algo']} {json.dumps(knobs)} on {srv.device.type}: "
              f"{R} rounds in {wall:.3f} s ({R / wall:.3f} rounds/s), "
              f"longest budget a round {longest}, final_acc "
              f"{payload['final_acc']:.4f}", flush=True)
        return payload

    common.run_made = timed_run
    reset_counts(counted)
    try:
        # card against CPU: the same numpy init and shuffle draws
        ds, model = common.build_dataset("femnist", "reduced")
        max_n = int(ds.sizes.max())
        init = {"w": (np.random.default_rng(5).normal(size=(64, 26)) * 0.01)
                .astype(np.float32), "b": np.zeros(26, np.float32)}

        def draws(t, ids, n):
            return np.random.default_rng(200 + t).random(
                (len(ids), max_n)).astype(np.float32)

        pair = {}
        for where in ("cuda", "cpu"):
            srv, config = common.make_server(
                ds, model, "ira", EXP_CARD_CPU_ROUNDS, "femnist",
                device=where, init_params=init, data_draws=draws)
            pair[where] = (srv, common.run_made(srv, config, "femnist"))
        (c_srv, c_pay), (h_srv, h_pay) = pair["cuda"], pair["cpu"]
        hc, hh = c_pay["history"], h_pay["history"]
        same = all(np.array_equal(a, b)
                   for a, b in zip(c_srv.cohorts, h_srv.cohorts))
        for k in ("dropout", "assigned", "uploaded", "true_workload"):
            same = same and hc[k] == hh[k]
        loss_err = float(np.nanmax(np.abs(nan_array(np, hc["train_loss"])
                                          - nan_array(np, hh["train_loss"]))))
        acc_err = float(np.max(np.abs(np.subtract(hc["acc"], hh["acc"]))))
        acc_tol = 2.0 / len(ds.test_y)
        out["card_vs_cpu"] = dict(bitwise=same, train_loss_err=loss_err,
                                  acc_err=acc_err, acc_tol=acc_tol,
                                  acc=[hc["acc"], hh["acc"]])
        print(f"experiments card vs CPU, femnist reduced, ira, "
              f"{EXP_CARD_CPU_ROUNDS} shuffle rounds from the same init and "
              f"draws: cohorts, dropout, assigned, uploaded, true_workload "
              f"bitwise {same}; train_loss max_abs_err {loss_err:.3e} (tol "
              f"{TOL}); acc max diff {acc_err:.4f} (limit {acc_tol:.4f})",
              flush=True)
        if not (same and loss_err <= TOL and acc_err <= acc_tol):
            raise RuntimeError(f"experiments: card and CPU runs differ "
                               f"{out['card_vs_cpu']}")

        with tempfile.TemporaryDirectory() as tmp:
            current["suite"] = "fig6_table2_main"
            t0 = time.perf_counter()
            fig6_table2_main.run("paper", R2, dev, tmp)
            out["table2_wall_s"] = time.perf_counter() - t0
            with open(os.path.join(tmp, "fig6_table2_main.json")) as f:
                t2 = json.load(f)
            out["table2"] = dict(summary=t2["summary"],
                                 avg_acc_gain=t2["avg_acc_gain"],
                                 avg_straggler_reduction=t2[
                                     "avg_straggler_reduction"])
            for name, fn, _ in suites:
                current["suite"] = name
                t0 = time.perf_counter()
                fn("reduced", Rf, dev, tmp)
                out[f"{name}_wall_s"] = time.perf_counter() - t0
                with open(os.path.join(tmp, f"{name}.json")) as f:
                    if not json.load(f):
                        raise RuntimeError(f"experiments: {name} wrote no "
                                           f"runs")
    finally:
        common.run_made = inner

    # the paper-scale recipe, through the example twin's own main()
    spec = importlib.util.spec_from_file_location("paper_scale_fl_torch",
                                                  RECIPE)
    recipe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(recipe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = recipe.main(["--rounds", str(Rr)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    final = hist["acc"][-1]
    out["recipe"] = dict(clients=1000, K=30, rounds=Rr, wall_s=wall,
                         rounds_per_s=Rr / wall, final_acc=final,
                         mean_dropout=float(np.nanmean(hist["dropout"])))
    print(f"experiments recipe examples/paper_scale_fl_torch.py --rounds "
          f"{Rr}: 1,000 clients, K=30, fassa + AL for {Rr // 4} rounds: "
          f"{Rr} rounds in {wall:.3f} s ({Rr / wall:.3f} rounds/s), final "
          f"acc {final:.4f}", flush=True)
    if not math.isfinite(final):
        raise RuntimeError("experiments: the recipe's accuracy is not finite")

    got = {k: fn.launches for k, fn in counted.items()}
    ran = sum(r["rounds"] for r in out["runs"] if r["device"] == "cuda") + Rr
    out["launches"], out["rounds_on_card"] = got, ran
    out["all_dropped_rounds"] = sum(r["all_dropped_rounds"]
                                    for r in out["runs"]
                                    if r["device"] == "cuda")
    if got != want or ran != want["fed_cohort_gather"]:
        raise RuntimeError(f"experiments: launched {got}, wanted {want} "
                           f"({ran} rounds run on the card)")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"experiments phase: launches {json.dumps(got)} (one gather a "
          f"round: {ran} rounds on the card, {out['all_dropped_rounds']} of "
          f"them with every client dropped); wall {out['wall_s']:.1f}s",
          flush=True)
    print(json.dumps({"experiments": out}), flush=True)
    return out


#: the whole steps ``dryrun_phase`` runs at full width on the card: (label,
#: arch, shape id, global batch, layers); every leg is one sequence but
#: decode's, which takes the 16x16 mesh's per-device batch (128 / 16) when
#: the trace says its 32,768-slot cache fits beside the weights, else 4;
#: every leg at full depth (layers None) but Falcon-Mamba-7B's train_4k,
#: whose 64 layers the trace puts at 111.8 GiB on mesh (1, 1): 32 of them
#: (57.9 GiB; 40 would be 71.4 GiB, past ``DRYRUN_FIT`` of the card)
DRYRUN_LEGS = (("llama3.2-3b train_4k", "llama3.2-3b", "train_4k", 1, None),
               ("llama3.2-3b prefill_32k", "llama3.2-3b", "prefill_32k", 1,
                None),
               ("falcon-mamba-7b prefill_32k", "falcon-mamba-7b",
                "prefill_32k", 1, None),
               ("falcon-mamba-7b train_4k", "falcon-mamba-7b", "train_4k",
                1, 32),
               ("llama3.2-3b decode_32k", "llama3.2-3b", "decode_32k", 8,
                None))
#: timed steps a leg, after one warm-up step
DRYRUN_REPS = 3
#: the share of the card's memory a leg's traced estimate may take
DRYRUN_FIT = 0.9
#: how far the Falcon-Mamba-7B train_4k leg's peak may stray from the
#: trace's estimate (the scan's checkpoints included in both)
DRYRUN_PEAK_TOL = 0.02
#: the reference scripts' twins, run on the card as subprocesses
TWINS = ("scripts/smoke_models_torch.py", "scripts/smoke_fl_torch.py",
         "examples/serve_batch_torch.py",
         "examples/fl_silo_transformer_torch.py")


def whole_step(torch, np, counted, get_config, build_model, arch, shape_id,
               B, layers=None):
    """One full-width step of ``arch`` (``layers`` of its layers where
    given) at ``shape_id`` with ``B`` rows on
    the card (random float32 weights, bf16 compute), beside its dry-run
    trace on mesh (1, 1): the median of ``DRYRUN_REPS`` CUDA-event step
    times after a warm-up, the peak memory against the trace's estimate,
    the trace's roofline terms, the step's share of the bf16 peak, the
    launches of every kernel (counts set to 0 just before the warm-up and
    read just after the last step) and, outside the count, one profiled
    step's top kernels.  A train step must run no plain scan on the card
    (``counting_plain``)."""
    from repro_torch.configs import ShapeConfig, get_shape
    from repro_torch.kernels import ref
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline import analysis as A
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg)
    dev = torch.device("cuda")
    base = get_shape(shape_id)
    S, kind = base.seq_len, base.kind
    shape = ShapeConfig(shape_id, S, B, kind)
    t0 = time.perf_counter()
    cost, _, mem = St.trace_step(model, shape,
                                 AbstractMesh((1, 1), ("data", "model")))
    est = mem["argument_bytes"] + mem["temp_bytes"]
    model_flops = A.model_flops_estimate(cfg, shape)
    rep = A.roofline_terms(cost, 1, arch=arch, shape=shape_id, mesh="1x1",
                           model_flops=model_flops, bytes_per_device=est)
    trace_s = time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # earlier phases' tensors
    params = model.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=dev)
    if kind == "train":
        opt = St.make_optimizer("sgd", lr=5e-3)
        state, batch = opt.init(params), {"tokens": tokens, "labels": tokens}
        train_step = St.make_train_step(model, opt)
        step = lambda: train_step(params, state, batch)     # noqa: E731
    elif kind == "prefill":
        prefill = St.make_prefill_step(model)
        step = lambda: prefill(params, {"tokens": tokens})  # noqa: E731
    else:
        cache = model.init_cache(B, S, dev)
        decode = St.make_decode_step(model)
        step = lambda: decode(params, cache, tokens[:, :1], S - 1)  # noqa
    reset_counts(counted)
    with counting_plain(ref, *PLAIN_SCANS) as plain_scans:
        out = step()
        del out
        times = []
        for _ in range(DRYRUN_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            del out
    if plain_scans:
        raise RuntimeError(f"dryrun leg {arch} {shape_id}: the plain scan "
                           f"ran on the card ({plain_scans[:4]}...)")
    own_ckpt = counted["selective_scan_bwd"].own_checkpoint_launches
    if own_ckpt:
        raise RuntimeError(f"dryrun leg {arch} {shape_id}: the scan "
                           f"backward ran {own_ckpt} checkpointing forwards "
                           f"of its own, not given the forward's")
    launches = {k: fn.launches for k, fn in counted.items()}
    tc = tensor_core_counts(counted)
    peak = torch.cuda.max_memory_allocated() - base
    ms = statistics.median(times)
    prof_wall, device_ms, top, _, n_launched = profiled(
        torch, lambda: step(), part="flash_")
    del params, step
    if kind == "train":
        del state, batch
    if kind == "decode":
        del cache
    torch.cuda.empty_cache()
    row = dict(
        arch=arch, shape=shape_id, global_batch=B, seq_len=S, kind=kind,
        layers=cfg.n_layers,
        step_ms=ms, step_ms_all=times, peak_bytes=peak,
        allocated_before_bytes=base,
        trace_estimate_bytes=est, trace_memory=mem, trace_s=trace_s,
        t_compute_ms=rep.t_compute * 1e3, t_memory_ms=rep.t_memory * 1e3,
        t_collective_ms=rep.t_collective * 1e3, bottleneck=rep.bottleneck,
        roofline_ms=max(rep.t_compute, rep.t_memory, rep.t_collective) * 1e3,
        trace_flops=cost.flops, trace_bytes=cost.bytes_accessed,
        model_flops=model_flops,
        peak_share=model_flops / (ms / 1e3 * BF16_FLOPS_PER_S),
        launches=launches, tensor_core_launches=tc,
        profiled_wall_ms=prof_wall, profiled_device_ms=device_ms,
        profiled_device_launches=n_launched, top_kernels_ms=top)
    print(f"dryrun leg {arch} {shape_id} B={B} S={S} ({cfg.n_layers} "
          f"layers): step "
          f"{ms:.3f} ms (median of {times}); roofline (trace, mesh 1x1) "
          f"compute {row['t_compute_ms']:.3f} ms, memory "
          f"{row['t_memory_ms']:.3f} ms, collective "
          f"{row['t_collective_ms']:.3f} ms -> {rep.bottleneck} "
          f"({cost.flops:.4e} flop, {cost.bytes_accessed:.4e} B); share "
          f"of the bf16 peak {row['peak_share']:.4f} ({model_flops:.4e} "
          f"model flop); peak memory {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before, against the "
          f"trace's {est / 2**30:.3f} GiB (arguments "
          f"{mem['argument_bytes'] / 2**30:.3f} + live "
          f"{mem['temp_bytes'] / 2**30:.3f}); launches "
          f"{json.dumps(launches)} (tensor cores {json.dumps(tc)}); one "
          f"profiled step: wall {prof_wall:.1f} ms, device "
          f"{device_ms:.1f} ms, {n_launched} launches, top "
          f"{json.dumps(top)}", flush=True)
    return row


def dryrun_phase(torch, np, counted, get_config, build_model):
    """The dry-run and its tooling on the card: (a) the whole steps of
    ``DRYRUN_LEGS`` against their traces (``whole_step``), the flash
    forward and backward, the cross-entropy forward and backward and the
    scan each launched on them; (b) ``python -m repro_torch.launch.dryrun
    --all`` (every pair on the 16x16 mesh, on the host, beside (c)) must
    exit 0, its report table printed with its wall time; (c) the
    reference scripts' twins (``TWINS``) on the card, each exiting 0."""
    import shutil
    import tempfile
    from repro_torch.configs import ShapeConfig, get_shape
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import AbstractMesh
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    legs, total = {}, {k: 0 for k in counted}
    total_mem = torch.cuda.get_device_properties(0).total_memory
    for label, arch, shape_id, B, layers in DRYRUN_LEGS:
        if get_shape(shape_id).kind == "decode":
            _, _, mem = St.trace_step(
                build_model(get_config(arch)),
                ShapeConfig(shape_id, get_shape(shape_id).seq_len, B,
                            "decode"),
                AbstractMesh((1, 1), ("data", "model")))
            est = mem["argument_bytes"] + mem["temp_bytes"]
            if est > DRYRUN_FIT * total_mem:
                print(f"dryrun leg {label}: the trace's estimate "
                      f"{est / 2**30:.2f} GiB at B={B} exceeds "
                      f"{DRYRUN_FIT} of the card's "
                      f"{total_mem / 2**30:.2f} GiB: B=4", flush=True)
                B = 4
        row = whole_step(torch, np, counted, get_config, build_model,
                         arch, shape_id, B, layers)
        legs[label] = row
        for k, n in row["launches"].items():
            total[k] += n
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "fused_softmax_xent_fwd", "fused_softmax_xent_bwd",
                 "selective_scan_fwd", "selective_scan_bwd"):
        if total[name] <= 0:
            raise RuntimeError(f"the dry-run legs never launched {name}")
    n = DRYRUN_REPS + 1
    want = {"llama3.2-3b train_4k": dict(
                flash_attention_fwd=56 * n, flash_attention_bwd=28 * n,
                fused_softmax_xent_fwd=4 * n,
                fused_softmax_xent_bwd=4 * n),
            "llama3.2-3b prefill_32k": dict(flash_attention_fwd=28 * n),
            "falcon-mamba-7b prefill_32k": dict(
                selective_scan_fwd=64 * n),
            # 32 layers, remat: each layer's scan twice a step, its
            # backward once; four 1,024-position loss chunks
            "falcon-mamba-7b train_4k": dict(
                selective_scan_fwd=2 * 32 * n, selective_scan_bwd=32 * n,
                fused_softmax_xent_fwd=4 * n,
                fused_softmax_xent_bwd=4 * n),
            "llama3.2-3b decode_32k": {}}
    for label, w in want.items():
        got = legs[label]["launches"]
        if got != dict({k: 0 for k in counted}, **w) or any(
                legs[label]["tensor_core_launches"][k] != got[k]
                for k in legs[label]["tensor_core_launches"]):
            raise RuntimeError(f"dryrun leg {label}: launched {got} "
                               f"(tensor cores "
                               f"{legs[label]['tensor_core_launches']}),"
                               f" wanted {w}, all on the tensor cores")
    falcon = legs["falcon-mamba-7b train_4k"]
    ratio = falcon["peak_bytes"] / falcon["trace_estimate_bytes"]
    print(f"dryrun leg falcon-mamba-7b train_4k: {falcon['step_ms']:.3f} "
          f"ms a step, peak {falcon['peak_bytes'] / 2**30:.3f} GiB = "
          f"{ratio:.4f} x the trace's estimate (tolerance "
          f"{DRYRUN_PEAK_TOL}), per step "
          f"{falcon['launches']['selective_scan_fwd'] // n} / "
          f"{falcon['launches']['selective_scan_bwd'] // n} scan forward / "
          f"backward launches, no checkpointing forward of the backward's "
          f"own", flush=True)
    if abs(ratio - 1) > DRYRUN_PEAK_TOL:
        raise RuntimeError(f"dryrun leg falcon-mamba-7b train_4k: peak "
                           f"{ratio:.4f} x the trace's estimate")

    # the dry-run on the host beside the twins (not beside the legs, whose
    # timed and profiled steps it would share the host with)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    t_dry = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out-dir", tmp], env=env, cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        twins = {}
        for path in TWINS:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, os.path.join(HERE, path)],
                                 env=env, cwd=HERE, capture_output=True,
                                 text=True, timeout=600)
            wall = time.perf_counter() - t0
            tail = (res.stdout.strip().splitlines() or [""])[-1]
            print(f"dryrun twin {path}: rc {res.returncode}, wall "
                  f"{wall:.1f}s, last line: {tail}", flush=True)
            if res.returncode != 0:
                raise RuntimeError(f"{path} exited {res.returncode}:\n"
                                   f"{res.stdout[-4000:]}\n"
                                   f"{res.stderr[-4000:]}")
            twins[path] = dict(rc=res.returncode, wall_s=wall, last=tail)

        out, _ = dry.communicate(timeout=900)
        dry_wall = time.perf_counter() - t_dry
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    if dry.returncode != 0:
        raise RuntimeError(f"python -m repro_torch.launch.dryrun --all "
                           f"exited {dry.returncode}:\n{out[-4000:]}")
    n_pairs = out.count(": ok ")
    table = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", "--dir", tmp],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=120,
        check=True).stdout
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"dryrun --all (16x16): rc 0, {n_pairs} pairs, wall "
          f"{dry_wall:.1f}s (beside the twins)\n{table}",
          flush=True)
    wall = time.perf_counter() - t_phase
    print(f"dryrun phase wall {wall:.1f}s", flush=True)
    return dict(legs=legs, launches=total, twins=twins,
                dryrun_all=dict(rc=0, pairs=n_pairs, wall_s=dry_wall),
                report=table, wall_s=wall)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's package is not under {SRC}",
              file=sys.stderr)
        return 1
    from repro_torch.core import aggregation
    from repro_torch.core import compression as comp
    from repro_torch.core.aggregation import _flatten_clients
    from repro_torch.core.engine import iid_indices
    from repro_torch.core.server import FedSAEServer, ServerConfig
    from repro_torch.data.federated import (make_femnist_like,
                                            make_sent140_like,
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
    laps = {"at": time.perf_counter()}

    def lap(name):
        """Print the seconds since the last lap: where the script's time
        limit goes."""
        now = time.perf_counter()
        print(f"lap {name}: {now - laps['at']:.1f}s", flush=True)
        laps["at"] = now

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {json.dumps(built)} wall {time.perf_counter() - t0:.2f}s",
          flush=True)
    for name in build.SIGNATURES:
        for entry, regs, spill in ptxas_report(build.build_log(name)):
            print(f"ptxas {name} {entry}: {regs} registers, {spill} bytes "
                  f"spilled")

    lap("build")
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
    copy_src = torch.empty((K * max_n * feat,), device=dev)
    copy_dst = torch.empty_like(copy_src)
    spin(torch)
    # the kernel, flat_x[idx] and a same-size copy_ (the card's copy
    # yardstick; timing only) in turns, kernel, library, copy, copy,
    # library, kernel twice over, after each kind of flush; each reads the
    # median of its four turns
    g_turns = {}
    turn = (("kernel", lambda: gather(flat_x, pk.y, starts, ns, max_n)),
            ("library", lambda: flat_x[lib_idx]),
            ("copy", lambda: copy_dst.copy_(copy_src)))
    for clean in (False, True):
        for name, fn in 2 * (turn + turn[::-1]):
            g_turns.setdefault(("clean " if clean else "") + name, []).append(
                time_ms(torch, fn, 50, flush, clean))
    g_med = {k: statistics.median(v) for k, v in g_turns.items()}
    g_ms, g_lib = g_med["kernel"], g_med["library"]
    g_plain = time_ms(torch, lambda: ref.fed_cohort_gather(
        flat_x, pk.y, starts, ns, max_n=max_n), 50, flush)
    g_bytes = gather_work(K, max_n, feat)[1]
    g_bound, g_by = bound(g_bytes, 0)
    print(f"fed_cohort_gather K={K} max_n={max_n} feat={feat}: bitwise "
          f"equal; kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, "
          f"flat_x[idx] {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}, "
          f"{g_bytes} B); turns after a dirty / a clean flush "
          f"{json.dumps(g_turns)}", flush=True)

    # the gather at Sent140's shape: rows of 25 int32 tokens, a width not
    # a multiple of 4 (the kernel's 4-byte path), with an empty lane and a
    # full one (n = max_n = 300)
    sent140 = make_sent140_like()
    if sent140.clients_x[0].dtype != np.int32:
        raise RuntimeError("Sent140 gather case: tokens are not int32")
    g25 = gather_shape_row(torch, np, ref, gather, sent140, K, flush, 1)
    if g25["feat"] != 25:
        raise RuntimeError("Sent140 gather case: rows are not 25 tokens")

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
    s_flops, s_bytes = mclr_sgd_work(executed, K, max_n, feat, C, B,
                                     max_iters)
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
    d_params = feat * H + H + H * C + C
    d_flops, d_bytes = dense_sgd_work(executed, K, max_n, feat, H, C, B,
                                      max_iters)
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
    # ties that straddle the cluster's slices (from rank 3 on, cut in rank
    # 5), and a row too long for shared memory (the streamed route)
    for label, (cK, cP) in (("ties across ranks", (3, 40_000)),
                            ("streamed", (2, 500_001))):
        ef = torch.randn((cK, cP), generator=gen, device=dev) * 1e-3
        plan = fed_compress.plan(cK, cP)
        ks = [comp.resolve_k(frac, cP)]
        if label == "ties across ranks":
            S = plan.slice
            ef[ef.abs() >= 2.5e-3] = 1e-3
            ef[:, 3 * S::11] = 2.5e-3
            ef[1, 3 * S::22] = -2.5e-3
            cut = len(range(3 * S, 5 * S + S // 2, 11))
            ks = [cut, cut + 1, len(range(3 * S, cP, 11)) + 5]
        for k_case in ks:
            q, sc = compress(ef, k_case)
            wq, ws = ref.fed_compress_topk_q8(ef, k=k_case)
            torch.cuda.synchronize()
            if not (torch.equal(q, wq) and torch.equal(sc, ws)):
                raise RuntimeError(f"compress kernel differs from plain "
                                   f"({label}, K={cK}, P={cP}, k={k_case})")
        print(f"fed_compress_topk_q8 {label} K={cK} P={cP} ({plan.route}, "
              f"cluster size {plan.cs}): bitwise equal at k in {ks}",
              flush=True)
    spin(torch)
    c_ms = time_ms(torch, lambda: compress(c_ef, c_k), 50)
    c_plain = time_ms(torch, lambda: ref.fed_compress_topk_q8(c_ef, k=c_k),
                      50)
    c_lib = time_ms(torch, lambda: torch.topk(c_ef.abs(), c_k, dim=1), 50)
    c_bytes = compress_work(K, d_params)[1]
    c_bound, c_by = bound(c_bytes, 0)
    c_plan = fed_compress.plan(K, d_params)
    print(f"fed_compress_topk_q8 K={K} P={d_params} k={c_k} ({c_plan.route}, "
          f"cluster size {c_plan.cs}, {c_plan.slice} coordinates a CTA): "
          f"kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms, torch.topk(|ef|) "
          f"{c_lib:.4f} ms, bound {c_bound:.4f} ms ({c_by}, {c_bytes} B)",
          flush=True)

    fa = flash_attention.flash_attention_fwd
    ss = selective_scan.selective_scan_fwd
    fa_bwd = flash_attention.flash_attention_bwd
    fx = fused_xent.fused_softmax_xent_fwd
    fx_bwd = fused_xent.fused_softmax_xent_bwd
    flash_row = check_flash(torch, fa, ref, gen, dev)
    scan_row = check_scan(torch, ss, ref, gen, dev)
    sb = selective_scan.selective_scan_bwd
    scan_bwd_row = check_scan_bwd(torch, sb, ss, ops, ref, gen, dev)
    bwd_row = check_flash_bwd(torch, fa_bwd, ref, gen, dev)
    xent_row, xent_bwd_row = check_xent(
        torch, fx, fused_xent.fused_softmax_xent_fwd_lse, fx_bwd, ops, ref,
        gen, dev)
    torch.cuda.empty_cache()
    slice_rows = check_slice_shapes(
        torch, {"flash_attention_fwd": fa, "flash_attention_bwd": fa_bwd,
                "fused_softmax_xent_fwd": fx,
                "fused_softmax_xent_bwd": fx_bwd}, ref, gen, dev)

    lap("kernels")
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

    checks = {"sent140_card_vs_cpu": sent140_card_vs_cpu(
        torch, np, FedSAEServer, ServerConfig, make_sent140_like),
        "robust_card_vs_cpu": robust_card_vs_cpu(torch, np, aggregation)}

    for arch in (("llama3.2-3b", "falcon-mamba-7b") + NEW_SMOKE_ARCHS
                 + ("whisper-tiny",)):
        serve_card_vs_cpu(torch, get_config, build_model, serve, arch)
        train_card_vs_cpu(torch, np, get_config, build_model, train, arch)
    # the scan options: the sequential route and bf16 scan inputs, which
    # the port computes as the reference's kernel route does
    serve_card_vs_cpu(torch, get_config, build_model, serve,
                      "falcon-mamba-7b", SSM_OPTIONS)
    train_card_vs_cpu(torch, np, get_config, build_model, train,
                      "falcon-mamba-7b", SSM_OPTIONS)

    lap("card vs CPU")
    # -- 4. the main paths ------------------------------------------------
    counted = {"fed_cohort_gather": gather, "fed_local_sgd_mclr": sgd,
               "fed_local_sgd_dense": dense,
               "fed_compress_topk_q8": compress,
               "flash_attention_fwd": fa, "selective_scan_fwd": ss,
               "selective_scan_bwd": sb,
               "flash_attention_bwd": fa_bwd, "fused_softmax_xent_fwd": fx,
               "fused_softmax_xent_bwd": fx_bwd}
    summary, path_launches = {}, {}

    def drive(label, rounds, algo="ira", ds=femnist, **cfg):
        srv = FedSAEServer(ds, cfg=ServerConfig(
            algo=algo, n_selected=10, rounds=rounds, **cfg))
        budgets = record_budgets(srv)
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
                              budgets=budgets, acc=hist["acc"],
                              train_loss=hist["train_loss"])
        print(f"main path {ds.name} paper scale, {algo}, {label}: {rounds} "
              f"rounds in {wall:.3f} s ({rounds / wall:.3f} rounds/s; "
              f"round 0 (warm-up) {srv.wall_times[0]:.4f} s, after it "
              f"{steady:.3f} rounds/s), round wall "
              f"{[round(w, 4) for w in srv.wall_times]} s, acc "
              f"{[round(a, 4) for a in hist['acc']]}, train_loss "
              f"{[round(a, 4) for a in hist['train_loss']]}, budgets per "
              f"round (longest) {[max(b) for b in budgets]}", flush=True)
        return srv

    def run_path(name, legs):
        """Drive the legs with every count set to 0 just before the path;
        each leg's launches must be its ``want`` (counts not named: 0)."""
        reset_counts(counted)
        for label, rounds, cfg, want in legs:
            before = {k: fn.launches for k, fn in counted.items()}
            drive(label, rounds, **cfg)
            got = {k: fn.launches - before[k] for k, fn in counted.items()}
            if got != dict({k: 0 for k in counted}, **want):
                raise RuntimeError(f"path {name}, leg {label} launched "
                                   f"{got}, not {want}")
            summary[label]["launches"] = got
        path_launches[name] = {k: fn.launches for k, fn in counted.items()}
        print(f"path {name} launches: {json.dumps(path_launches[name])}",
              flush=True)

    # the FedProx legs: the paper's FedProx baseline, fixed_epochs 15 (the
    # default; budgets up to 15 x 40 = 600 iterations) and prox_mu 0.1 (the
    # default), the SGD kernels' prox term on
    fedprox = dict(algo="fedprox", sampling="iid")
    run_path("mclr", [
        ("iid", 5, dict(sampling="iid"),
         dict(fed_cohort_gather=5, fed_local_sgd_mclr=5)),
        ("shuffle", 2, dict(sampling="shuffle"), dict(fed_cohort_gather=2)),
        ("fedprox iid", 3, fedprox,
         dict(fed_cohort_gather=3, fed_local_sgd_mclr=3))])

    def run_captured(name, legs):
        """run_path with the upload stage of every compressed round
        captured; the last one's error-feedback identity is checked on
        the card."""
        stage = {}
        inner_stage = comp.apply_upload_compress

        def capture_stage(global_params, params_k, residual_rows, uploaded,
                          k):
            out = inner_stage(global_params, params_k, residual_rows,
                              uploaded, k)
            stage.update(g=global_params, pk=params_k, res=residual_rows,
                         up=uploaded, k=k, out=out)
            return out

        comp.apply_upload_compress = capture_stage
        try:
            run_path(name, legs)
        finally:
            comp.apply_upload_compress = inner_stage
        ef = (_flatten_clients(stage["pk"]) - comp.flatten_global(
            stage["g"])[None, :]) + stage["res"]
        _, new_res, sent = stage["out"]
        up = stage["up"]
        if not (torch.equal((sent + new_res)[up], ef[up])
                and torch.equal(new_res[~up], stage["res"][~up])
                and not sent[~up].any()):
            raise RuntimeError(f"error-feedback identity broken on the card"
                               f" (path {name})")
        n_sent = [int(v) for v in (sent != 0).sum(1)]
        if max(n_sent) > stage["k"]:
            raise RuntimeError(f"a client sent more than k={stage['k']} "
                               f"values (path {name})")
        print(f"error-feedback identity on the card, path {name}, last "
              f"round: transmitted + residual' == delta + residual bitwise "
              f"on {int(up.sum())} uploading rows (P={ef.shape[1]}, "
              f"k={stage['k']}, values sent {n_sent}); non-uploaders kept "
              f"their residual", flush=True)

    run_captured("mlp", [
        ("mlp iid topk_q8", 5, dict(
            sampling="iid", model="mlp", upload_compress="topk_q8",
            topk_frac=frac),
         dict(fed_cohort_gather=5, fed_local_sgd_dense=5,
              fed_compress_topk_q8=5)),
        ("mlp fedprox iid", 3, dict(fedprox, model="mlp"),
         dict(fed_cohort_gather=3, fed_local_sgd_dense=3))])
    # Sent140 at paper scale with the paper's LSTM (E=32, H=64, vocabulary
    # 1,000: P = 56,962): no fused SGD kernel exists for it, so a round
    # launches the gather (int32 tokens) and, compressed, the compressor
    run_captured("sent140", [
        ("sent140 lstm shuffle", 3, dict(ds=sent140, sampling="shuffle"),
         dict(fed_cohort_gather=3)),
        ("sent140 lstm iid topk_q8", 2, dict(
            ds=sent140, sampling="iid", upload_compress="topk_q8",
            topk_frac=frac),
         dict(fed_cohort_gather=2, fed_compress_topk_q8=2))])
    # the robust aggregators on the MCLR iid path (the fused SGD kernel),
    # each aggregating on the card
    run_path("robust", [
        (f"robust {name}", 2, dict(sampling="iid", aggregator=name, **kw),
         dict(fed_cohort_gather=2, fed_local_sgd_mclr=2))
        for name, kw in (("trimmed_mean", {}), ("median", {}),
                         ("krum", dict(n_byzantine=1)),
                         ("geometric_median", {}),
                         ("bulyan", dict(n_byzantine=1)))])
    lap("FL paths")
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
    # the decoder family at full width where it fits one card: the MoE
    # (granite-moe-1b-a400m, 24 layers), Minitron-8B (32) and Granite-8B
    # (36), one flash launch a layer of the prefill
    for arch in ("granite-moe-1b-a400m", "minitron-8b", "granite-8b"):
        serving[arch] = serve_path(
            torch, get_config, build_model, serve, arch, 4, 2048, gen_steps,
            counted, {"flash_attention_fwd": get_config(arch).n_layers})
        path_launches[f"serve_{arch}"] = serving[arch]["launches"]
        torch.cuda.empty_cache()
    # the VLM: 512 patches before 1,536 tokens (a flash launch a layer of
    # the prefill); the encoder-decoder: Whisper's 30 s window of 1,500
    # frames under a 4-token decoder prompt (its 4 encoder layers
    # non-causal, its 4 decoder layers causal; decode runs no kernel)
    serving["internvl2-2b"] = serve_path(
        torch, get_config, build_model, serve, "internvl2-2b", 4, 2048,
        gen_steps, counted, {"flash_attention_fwd": 24})
    path_launches["serve_internvl2-2b"] = serving["internvl2-2b"]["launches"]
    torch.cuda.empty_cache()
    serving["whisper-tiny"] = serve_path(
        torch, get_config, build_model, serve, "whisper-tiny", 4, 1500,
        gen_steps, counted, {"flash_attention_fwd": 8}, dec_tokens=4)
    path_launches["serve_whisper-tiny"] = serving["whisper-tiny"]["launches"]
    torch.cuda.empty_cache()
    lap("serving")
    # this slice's path: cross-silo FedSAE training at full width, then the
    # centralized training CLI on the smoke config
    training = {"silo_llama3.2-3b": silo_path(torch, np, get_config,
                                              build_model, counted, ref)}
    path_launches["silo_llama3.2-3b"] = \
        training["silo_llama3.2-3b"]["launches"]
    torch.cuda.empty_cache()
    # Falcon-Mamba-7B at full width, cut to the deepest of 16 / 24 / 32
    # layers whose peak stays under DRYRUN_FIT of the card: the scan and
    # its backward kernel on every Mamba layer
    falcon = silo_path(torch, np, get_config, build_model, counted, ref,
                       arch="falcon-mamba-7b", layers=SILO_FALCON_LAYERS)
    fit = DRYRUN_FIT * torch.cuda.get_device_properties(0).total_memory
    if falcon["peak_gib"] * 2**30 >= fit:
        raise RuntimeError(f"silo falcon-mamba-7b: peak "
                           f"{falcon['peak_gib']:.2f} GiB at "
                           f"{SILO_FALCON_LAYERS} layers, past "
                           f"{fit / 2**30:.2f} GiB")
    training["silo_falcon-mamba-7b"] = falcon
    path_launches["silo_falcon-mamba-7b"] = falcon["launches"]
    torch.cuda.empty_cache()
    training["silo_granite-moe-1b-a400m"] = silo_path(
        torch, np, get_config, build_model, counted, ref,
        arch="granite-moe-1b-a400m", lr=MOE_LR)
    path_launches["silo_granite-moe-1b-a400m"] = \
        training["silo_granite-moe-1b-a400m"]["launches"]
    torch.cuda.empty_cache()
    # this slice's models trained cross-silo at full width: the VLM on
    # 512 patches + 1,536 tokens a row, the encoder-decoder on 4 rows of
    # Whisper's 30 s window (1,500 frames) under 448 tokens
    for arch, kw in (("internvl2-2b", {}),
                     ("whisper-tiny", dict(B=4, S=1500))):
        training[f"silo_{arch}"] = silo_path(
            torch, np, get_config, build_model, counted, ref, arch=arch,
            **kw)
        path_launches[f"silo_{arch}"] = training[f"silo_{arch}"]["launches"]
        torch.cuda.empty_cache()

    def train_cli(label, arch, steps, per_step):
        """``launch.train --arch <arch> --smoke`` (batch 4, 128 positions),
        its launches ``per_step`` times ``steps``, every flash and
        cross-entropy call on the tensor cores (bf16) and no plain
        cross-entropy recompute."""
        reset_counts(counted)
        t0 = time.perf_counter()
        with counting_plain(ref, "softmax_xent") as recomputes, \
                counting_plain(ref, *PLAIN_SCANS) as plain_scans:
            losses = train.main(["--arch", arch, "--smoke", "--steps",
                                 str(steps)])
            torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counted.items()}
        tc = tensor_core_counts(counted)
        want = dict({k: 0 for k in counted},
                    **{k: n * steps for k, n in per_step.items()})
        want_tc = {k: want[k] for k in tc}
        if (got != want or tc != want_tc or recomputes or plain_scans
                or not np.isfinite(losses).all()):
            raise RuntimeError(f"launch.train {arch} smoke: losses {losses},"
                               f" launched {got} (tensor cores {tc}), "
                               f"wanted {want}; {len(recomputes)} plain "
                               f"cross-entropy recomputes")
        training[label] = dict(losses=losses,
                               wall_s=time.perf_counter() - t0,
                               launches=got, tensor_core_launches=tc,
                               xent_route="tensor cores",
                               plain_xent_recomputes=len(recomputes))
        path_launches[label] = got
        print(f"main path python -m repro_torch.launch.train --arch {arch} "
              f"--smoke --steps {steps}: losses "
              f"{[round(x, 4) for x in losses]}; launches {json.dumps(got)}"
              f"; cross-entropy route tensor cores ({len(recomputes)} plain "
              f"recomputes)", flush=True)

    one_each = dict(fused_softmax_xent_fwd=1, fused_softmax_xent_bwd=1)
    train_cli("train_cli_smoke", "llama3.2-3b", 5, dict(
        one_each, flash_attention_fwd=2, flash_attention_bwd=2))
    # the VLM's batch: 16 patches + 112 tokens; the encoder-decoder's: 128
    # frames under 32 tokens, its 2 encoder and 2 decoder layers
    train_cli("train_cli_internvl2-2b", "internvl2-2b", 2, dict(
        one_each, flash_attention_fwd=2, flash_attention_bwd=2))
    train_cli("train_cli_whisper-tiny", "whisper-tiny", 2, dict(
        one_each, flash_attention_fwd=4, flash_attention_bwd=4))
    lap("silo and train CLI")
    # this slice's path: telemetry on the FL paths
    telemetry = telemetry_phase(torch, np, FedSAEServer, ServerConfig,
                                femnist, counted, frac)
    path_launches["telemetry"] = telemetry["launches"]
    lap("telemetry")
    # this slice's path: failure handling (faults, the screen, checkpoints)
    torch.cuda.empty_cache()
    faults = faults_phase(torch, np, FedSAEServer, ServerConfig, femnist,
                          counted, frac, get_config, build_model)
    path_launches["faults"] = faults["launches"]
    lap("faults")
    # this slice's path: the device-resident drivers, the scan driver's
    # rounds replayed from a CUDA graph
    torch.cuda.empty_cache()
    scan = scan_phase(torch, np, FedSAEServer, ServerConfig, femnist,
                      counted, frac, make_sent140_like)
    path_launches["scan"] = scan["launches"]
    lap("scan")
    # this slice's path: client-axis sharding (world-1 NCCL, world-2 gloo
    # on the one card) and prefetch
    torch.cuda.empty_cache()
    shard = shard_phase(torch, np, FedSAEServer, ServerConfig, femnist,
                        counted, frac)
    path_launches["shard"] = shard["launches"]
    lap("shard")
    # this slice's path: an architecture id as the packed round's local
    # step (Llama-3.2-3B at full width, the smoke LMs on every driver)
    torch.cuda.empty_cache()
    lm_fed = lm_fed_phase(torch, np, FedSAEServer, ServerConfig, counted,
                          get_config, make_sent140_like)
    path_launches["lm_fed"] = lm_fed["launches"]
    lap("lm_fed")
    # this slice's path: the seed interface's padded round
    padded = padded_phase(torch, np, femnist, counted)
    path_launches["padded"] = padded["launches"]
    # why the full-width MoE legs scale w_down and cut the lr
    moe_scale = moe_scale_phase(torch, np, get_config, make_sent140_like)
    lap("padded and moe_scale")
    # this slice's path: the paper's experiments, Table II at paper scale
    torch.cuda.empty_cache()
    experiments = experiments_phase(torch, np, counted, ref)
    path_launches["experiments"] = experiments["launches"]
    lap("experiments")
    # -- 5. where a steady round's time goes (outside the counted run) ---
    profiles = {}
    for label, cfg in (("iid", dict(sampling="iid")),
                       ("shuffle", dict(sampling="shuffle")),
                       ("fedprox iid", fedprox),
                       ("mlp iid topk_q8", dict(
                           sampling="iid", model="mlp",
                           upload_compress="topk_q8", topk_frac=frac)),
                       ("mlp fedprox iid", dict(fedprox, model="mlp")),
                       ("sent140 lstm shuffle", dict(sampling="shuffle",
                                                     ds=sent140))):
        cfg = dict(cfg)
        srv = FedSAEServer(cfg.pop("ds", femnist), cfg=ServerConfig(
            **{"algo": "ira", "n_selected": 10, **cfg}))
        srv.run_round(0)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run_round(1)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        row = {}
        prof_wall, device_ms, top, _, n_launched = profiled(
            torch, lambda: row.update(srv.run_round(2)))
        longest = int(max(row["n_iters"]))
        profiles[label] = dict(
            round1_wall_ms=plain_wall * 1e3,
            round2_budgets=[int(v) for v in row["n_iters"]],
            round2_wall_ms_profiled=prof_wall,
            round2_device_ms=device_ms,
            round2_device_busy=device_ms / prof_wall,
            round2_device_launches=n_launched,
            round2_launches_per_local_step=n_launched / max(longest, 1),
            top_kernels_ms=top[:5])
        print(f"profile {label}: {json.dumps(profiles[label])}",
              flush=True)

    lap("profiles")
    # this slice's path, last: the dry-run, whole steps against their
    # roofline and the reference scripts' twins.  Its profiled steps come
    # after every other phase's profiler windows, so that theirs keep the
    # history they had before it (late windows lose device records:
    # ``obs.profiling.PROFILER_WARMUP_LAUNCHES``)
    torch.cuda.empty_cache()
    dryrun = dryrun_phase(torch, np, counted, get_config, build_model)
    path_launches["dryrun"] = dryrun["launches"]
    lap("dryrun")
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in counted}
    scan_single_steps = sum(serving[a]["scan_single_step_launches"]
                            for a in serving)
    tc_runs = [serving[a]["tensor_core_launches"] for a in serving] + [
        training[t]["tensor_core_launches"] for t in training] + [
        faults["tensor_core_launches"], lm_fed["tensor_core_launches"]] + [
        leg["tensor_core_launches"] for leg in dryrun["legs"].values()]
    tc_total = {k: sum(r[k] for r in tc_runs) for k in tc_runs[0]}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main paths never launched {name}")

    kernels = [
        {"name": "fed_cohort_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fed_gather.cu",
         "replaces": "src/repro/kernels/fed_gather.py:56",
         "launches": launches["fed_cohort_gather"], "max_abs_err": 0.0,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": g_lib,
         "sent140_ms": g25["ms"], "sent140_plain_ms": g25["plain_ms"],
         "copy_ms": g_med["copy"], "clean_flush_ms": g_med["clean kernel"],
         "clean_flush_library_ms": g_med["clean library"],
         "clean_flush_copy_ms": g_med["clean copy"],
         "experiments_shapes": experiments["gather_shapes"]},
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
         "bound_by": c_by, "library_ms": c_lib, "plan_route": c_plan.route,
         "cluster_size": c_plan.cs},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": launches["flash_attention_fwd"],
         "tensor_core_launches": tc_total["flash_attention_fwd"],
         **flash_row},
        {"name": "selective_scan_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
         "replaces": "src/repro/kernels/selective_scan.py:49",
         "launches": launches["selective_scan_fwd"],
         "decode_launches": scan_single_steps,
         "prefill_launches": launches["selective_scan_fwd"]
         - scan_single_steps, **scan_row},
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:73",
         "launches": launches["selective_scan_bwd"], **scan_bwd_row},
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
         "cuda_core_launches": launches["fused_softmax_xent_fwd"]
         - tc_total["fused_softmax_xent_fwd"],
         **xent_row},
        {"name": "fused_softmax_xent_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_xent_bwd.cu",
         "replaces": "src/repro/kernels/ops.py:95",
         "launches": launches["fused_softmax_xent_bwd"],
         "tensor_core_launches": tc_total["fused_softmax_xent_bwd"],
         **xent_bwd_row},
    ]
    for row in kernels:
        if row["name"] in lm_fed["shape_errs"]:
            row["lm_fed_shapes_max_abs_err"] = lm_fed["shape_errs"][
                row["name"]]
        if row["name"] in slice_rows:
            row["vlm_encdec_shapes"] = slice_rows[row["name"]]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"main_path": summary, "path_launches": path_launches,
                      "profile": profiles, "serving": serving,
                      "training": training, "checks": checks,
                      "telemetry": telemetry, "faults": faults,
                      "scan": scan, "shard": shard, "lm_fed": lm_fed,
                      "padded": padded, "moe_scale": moe_scale,
                      "dryrun": dryrun}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
