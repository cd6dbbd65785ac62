#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), holds each kernel against its plain
torch version on the card, drives the port's main paths — the static
tiering tick through ``simulate`` / ``run_engine``; tiered paged-KV serving
of Llama 3.2 1B and of Zamba2-7B through ``build_serve_step``; the prefill
of both through ``make_prefill_step``; the churn tick; the fleet through
``run_fleet`` / ``run_mixed_fleet`` / ``fleet_rollout``; serving and the
prefill of the moe, ssm and remaining dense configs, and of the encdec
(whisper-tiny) and vlm (Llama 3.2 Vision) families — and checks what
comes out. Phases,
one line each, each with its duration:

  1. device: nvidia-smi name and power limit, torch/CUDA versions, the build
  2. tick kernels (K1-K4) vs plain versions on the card, bitwise, at full
     width (T=64, S=4096, k=256; L=262,144, C=4096, N=16,384) and edge cases
     (K1 also on the dynamic path's rowspace, S=262,144 with a prefix of
     valid lanes; K2 also on unaligned rows and x / valid views at odd
     offsets)
  3. the reference's ``static_small`` golden through ``simulate(impl="cuda")``
  4. the tick at full width: T=64, L=262,144, equilibria, 20 ticks, "cuda"
     vs "ref" on the card; every tick kernel must launch in this run, K1 on
     its "staged" route (``seg_topk.routes``)
  5. ``stacked64`` in all four modes, "cuda" vs "ref"
  6. tick kernels: time, launches per tick, bound, plain and library times,
     the earlier designs' times and the launch floor (an empty kernel); K1
     and K4 also at the arguments of C1's first and tenth (settled) ticks
  7. where a full-width tick's device time goes (torch.profiler)
  8. serving kernels (K5 tiered attention, K6 page migration) vs plain
     versions on the card at full width: K5 at S1's and S3's widths in bf16
     and f32, window None and 40, free slots, mid-page lengths; K6 bitwise
     in bf16 and f32, one pool and K+V in one launch, at S1's and S3's
     pages, odd page sizes, unaligned pools, indices out of range; D1 (the
     Mamba2 decode-state kernel) at Zamba2's and mamba2-130m's widths at
     B=256 and 3 and at 16 x 16, x/B/C in bf16 (the conv step's views and
     contiguous) and f32, on layer 2 of a stacked cache: the state in place
     bit for bit, the other layers untouched, y within ``D1_TOL``
  9. serving at full width: Llama 3.2 1B (random weights from a seed), 4
     tenants, 64 sequences, 512 decode steps, equilibria, impl "cuda" vs
     "ref" step by step from a shared state on teacher-forced tokens; then
     tpp and static for 64 steps each; K5 and K6 must launch, D1 must not
 10. decode == full-sequence forward at full width in float32 (TF32 off),
     4 sequences x 128 steps, with pages migrating
 11. serving kernels: time, launches per step, bound, plain, library times
     (K5's yardstick: the faster of scaled_dot_product_attention with
     expanded K/V and with enable_gqa=True); the earlier designs' times;
     K6 as one pool and as the K+V pair the tiering step launches; D1 at
     the decode cell's B=256 (Zamba2's and mamba2-130m's widths) beside its
     plain version, the plain version plus the cache copy, and its bound
 12. where one decode step's device time goes (torch.profiler), and each
     serving op's device launches per op call
 13. prefill kernels (K7 flash attention, K8 SSD scan) vs plain versions on
     the card: K7 at zamba2's and llama's heads, causal / window 64 /
     non-causal, Sq < Skv and a ragged S=200, f32 and bf16, and bf16 views
     2 bytes off alignment; every f32 and unaligned bf16 launch on the
     tf32x3 kernel, every other bf16 launch on the wgmma kernel, as the
     launcher reports; K8 at zamba2's and mamba2-130m's widths under
     real-init and strong decays
 14. prefill at full width (``make_prefill_step``), Llama 3.2 1B at full
     depth then Zamba2-7B at depth 24 of 81 (4 of its 14 shared-block
     periods, each layer's weights at the full model's scale,
     ``cut_depth_model``; random weights from a seed; the Llama models are
     freed first): cuda vs ref at B=2, S=4096 in bf16 and f32; then one timed
     prefill at B=1, S=32,768 (the reference's prefill_32k, its batch of 32
     cut to 1); K7 and K8 must launch, 16 (llama) / 4 and 24 (zamba2)
     times. In each of these prefills the first K7 and K8 call (layer 0) is
     also held against the plain version on the path's own arguments
     (strided [B,S,H,D] views, real activations): at S=4096 in bf16 and
     f32 in full, at S=32,768 K7's last 1,024 query rows against all keys
     and K8 over the whole length (128 chunks of state carry)
 15. hybrid serving at full width: Zamba2-7B at depth 24, 4 tenants, 32 sequences, 256
     decode steps, equilibria, cuda vs ref step by step; tpp and static 16
     steps each; one profiled step; K5 and K6 must launch, D1 once a Mamba2
     layer a step; D1 on each layer slice of the run's own final state with
     the inputs the path last gave the layer, held as in phase 8; K5 and K6
     timed at S3's widths on the run's own cache, as in phase 11
 16. hybrid decode == full-sequence forward (K7 and K8) in float32, 4
     sequences x 64 steps, with pages migrating; D1 held as in phase 15
 17. prefill kernels: time, launches per prefill, bound, plain and library
     (``scaled_dot_product_attention`` for K7; none for K8) times, the
     earlier designs' times; K8 also at S=32,768
 18. where one Zamba2-7B prefill's device time goes (torch.profiler), and
     K8's device launches per op call
 19. dynamic ownership (churn): the reference's ``churn_small`` and
     ``churn16_sketch`` goldens through ``simulate_churn(impl="cuda")``; K1
     must launch
 20. H1, a churned host of C1's size (T=64 slots: 24 stable, 24 Poisson, 16
     serverless; L=261,824 pages), equilibria, 40 ticks: "cuda", "ref"
     and "batched" in turns from the same all-free pool, integer outputs
     and state bitwise every tick, conservation every tick; tick ms for
     each impl, K1 launches per tick (all on its "long" route), one
     profiled tick
 21. H1 for 20 ticks with the sampled, sketch (outside full coverage: the
     threefry probe draw on the card) and neomem providers, "cuda" vs
     "ref"; stacked64 with its owner vector permuted (non-contiguous),
     "cuda" == "ref" == "batched"
 22. K1 at the dynamic path's rowspace width (T=64, S=L=261,824) at a
     moving tick's own quotas, and on a tied copy (every valid score 0.0):
     its route, bitwise against the plain version; time beside K1's
     earlier design on the same rows (``EARLIER_TOPK_SOURCE``, built at
     phase 1 beside the port's sources), the dense bound and the must-read
     bound, the launch floor, the plain version, ``torch.topk`` and
     ``torch.sort``

 23. the fleet (slice D), static: ``run_fleet`` over 4 hosts of C1's size
     (T=64, L=262,144, ``heterogeneous_mixes``), 20 ticks, detect=True,
     "cuda" vs "ref" (every state leaf and FleetResult array bitwise,
     offline pathologies included), host-ticks/s of each, timed in turns;
     K1-K4 must launch
 24. the mixed fleet: ``run_mixed_fleet`` over 8 hosts of H1's size (4
     static rosters of 64 stable slots, 4 churned H1-style rosters),
     40 ticks, "cuda" vs "ref" bitwise, conservation on every host at
     every tick; host-ticks/s; one profiled fleet tick; K1 must launch
 25. ``fleet_rollout`` over phase 24's 8 archetypes with the streaming
     detectors and the attribution ledger, chunk 16 over 40 ticks, warm:
     "cuda" vs "ref" in every leaf, equal to phase 24 outside the seams,
     the ledger conserving on every host; stall percentiles, host-ticks/s
 26. the seams' cost on an H1 tick (with and without detector + attrib,
     alternating); the reference's ``fleet_obs --smoke`` property on the
     port (noisy fleet flags tenant 0 on every host, clean fleet silent);
     the rollout's Chrome trace and Prometheus exposition through the
     validators; ``counterfactual_run`` on ``churn_small``, "cuda" vs "ref"

 27. moe serving: granite-moe-3b-a800m at full width and depth 8 of 32
     (``cut_depth_model``; 40 experts, top-8, f32 weights), 4 tenants, 64 sequences x 256 steps
     under ``full_load``, cuda vs ref step by step: integers as in phase
     9, logits and hotness in the steps whose expert routing agrees in
     every layer; tpp and static 32 steps each; one profiled step; K5's
     first call of every step and every K6 call that moves a page held
     against the plain versions on the path; one step held layer by layer,
     each layer fed the ref run's input, beside the free-running
     divergence and a one-ulp witness (``moe_layer_check``); K5 and K6
     timed on the run's cache, K6 also held bitwise on its pools
 28. moe prefill: granite, then Mixtral 8x22B at full width and depth 8
     of 56 in bf16 weights (window 4,096): cuda vs ref at B=2, S=4,096 in
     bf16 and f32 (held where the routing agrees in every layer), a timed
     prefill at B=1, S=32,768, layer 0's K7 held on the path (at
     S=32,768 on the last query rows); Mixtral serving 16 x 64 as phase 27
 29. the dense configs h2o-danube-3-4b (window 4,096, head dim 120),
     codeqwen1.5-7b and qwen3-32b (bf16 weights, qk-norm), each at full
     width and depth 8 (of 24, 32 and 64; ``cut_depth_model``): the prefill as in phase 28 (qwen3 compared at B=1) and
     32 x 64 serving, cuda vs ref held as in phase 9; danube's timed
     prefill (P5) profiled by class. Every timed bf16 prefill (phases 14,
     28-30, 32-33) counts K7's launches by the route the launcher reports
     and requires all of them on the wgmma kernel (P5: 8 of 8)
 30. mamba2-130m: the prefill through K8 (24 op calls), 64 x 256 serving
     (D1 its one kernel, once a layer a step; cuda vs ref: layer 0's state
     bitwise, the logits within the bf16 bound; D1 held as in phase 15)
     and decode == forward in f32 over 4 x 64 steps
 31. K5 at each new (H, K, D) over random pools of 4,000-6,000 tokens
     (past a 4,096 window), bf16 and f32; K6 bitwise at each new page
     size; K7 at each new head shape, causal and window 4,096, S = 4,096
     and 32,768: time, plain, the faster SDPA form, bound, the route the
     launcher reports; K7's f32 route (the tf32x3 kernel) at danube's
     heads, S=4,096 (beside the plain version and f32 SDPA) and S=16,384
     (beside f32 SDPA), with both bounds (three TF32 products on the tensor
     cores, the kernels line's; the same work on the CUDA cores)

 32. encdec: whisper-tiny at full width and depth (4 + 4 layers, f32
     weights), its biases opened (seeded, nonzero): 64 x 256 serving under
     ``full_load`` (the budget binds) with the cross K/V from
     ``encode_frames`` + ``compute_cross_kv`` on seeded frames, cuda vs
     ref step by step as phase 27 (integers every step; K5's first call
     each step and every K6 call that moves a page held on the path); the
     prefill as phase 28 with the frames in the batch, layer 0's encoder
     (full, 1,500 x 1,500), decoder self (causal) and cross (Sq > Skv) K7
     calls each held on the path; decode == forward in f32 over 4 x 128
     steps. Its random model carries a last-bit change to every output (a
     one-ulp witness is printed beside each comparison), so its logits and
     hotness are held block by block: one decode step and the prefill in
     bf16 and f32 with each block fed the ref run's input, and decode ==
     forward with each block fed the forward's input (``block_trace``);
     float32 runs are also held end to end within 10x their witness
 33. vlm: Llama 3.2 Vision at full width and depth 10 of 100 (two units of
     4 self + 1 gated cross layer, bf16 weights), its gates opened: the
     prefill (compared at B=1; self and cross K7 held on the path) and
     16 x 64 serving, held end to end as phases 27-29 (K5 on the path to a
     bound that grows with its scores, ``k5_vs_plain``) and block by block
     as phase 32; decode == forward in f32 as phase 32
 34. K7's cross-attention shapes (whisper H=6 D=64 against 1,500 frames,
     the vlm's H=64 K=8 D=128 against 1,600 image tokens; Sq = 4,096 and
     32,768) and the encoder's 1,500 x 1,500, non-causal, bf16: time,
     plain (where its scores fit), non-causal SDPA, bound

 35. K7 and K8 under autograd (``FlashAttention``, ``SSDScan``: the
     kernel's forward, the plain version's gradient): q, k and v's (x, a,
     b and c's) gradients against autograd of the plain version on the
     same inputs, the incoming gradient out + g so the forward's error
     shows: K7 at Llama 3.2 1B's GQA (B=2, S=4,096, bf16), Zamba2's D=112,
     h2o-danube's D=120 in f32, a 4,096 window at S=6,144, whisper's
     encoder 1,500 x 1,500 and its cross Sq=4,096 > Skv=1,500; K8 at
     mamba2-130m's widths (B=8, S=4,096); forward + backward ms beside the
     plain version's and SDPA's
 36. training Llama 3.2 1B at full width and depth (16 layers, f32
     masters, bf16 compute, train_4k's S=4,096 at B=2, remat "block"):
     cuda vs ref loss and gradient norm from the same state beside a
     one-ulp witness; six steps on one batch through ``TrainDriver``
     (loss falling, every .grad finite, K7 twice a layer a step); step
     ms, tokens/s, model FLOP/s share, peak memory; one profiled step
     with the plain attention backward and AdamW timed by CUDA events;
     cuda vs ref at depth 2 in f32: the loss end to end, every gradient
     leaf block by block (``block_grads``: each block fed the ref run's
     input and output gradient)
 37. mamba2-130m at full width and depth (B=8, S=4,096) through
     ``TrainDriver`` with a checkpoint every 2 steps and a RuntimeError
     injected at step 3 (restored and retried once), a fresh driver
     resuming bitwise; cuda vs ref in bf16 and f32; one f32 step each of
     Zamba2-7B at depth 6, granite-moe at depth 4 (aux loss; the cuda step
     takes the ref step's expert picks and gates, ``held_routing``) and
     whisper-tiny at full depth, cuda vs ref every gradient leaf
     (granite's and whisper's loss end to end, their gradients block by
     block), with
     the cross-entropy's gradient at the logits from both forwards;
     ``launch/dryrun.py``'s bytes of every train_4k cell

 38. the port's static-analysis gate (``repro_torch.analysis``, ``--fast``)
     on the card: the tick targets under ``set_sync_debug_mode("warn")``,
     the kernel-backed tick (K1-K4), the eight kernel wrappers (each must
     launch; K7 on its tf32x3 route), the fleet chunk's
     ``memory_allocated`` never above its value after the second tick, the constancy sweeps, the
     cuda tick at C1's size (T=32 and 64 under sync debug in both
     controller phases: equal op histograms and launches a tick), a child
     process capturing the C1 tick at T=64 in a CUDA graph, one per
     controller phase; no finding outside the committed baseline. Prints
     the C1 tick's aten ops and launches a tick, its purity, the capture
     verdicts with warm medians of eager ticks and replays, and the sync
     sites; the kernels line gains each row's ``analysis_launches``

Any failure raises (non-zero exit). The last lines are the card's name and
power limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is present or the
port's sources are missing.
"""
from __future__ import annotations

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor
import gc
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "static_small.json"

# full width: the repo's scale point (benchmarks/roofline.py, bench_tick)
T0, L0, K_MAX = 64, 262144, 256
MAIN_TICKS = 20
STACKED_TICKS = 120
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published
F32_OPS_PER_S = 67e12          # H100 SXM float32/int32 outside tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak
SOURCE = "src/repro_torch/kernels/csrc/selection.cu"
SERVE_SOURCE = "src/repro_torch/kernels/csrc/serving.cu"
REPLACES = {
    "seg_topk": "src/repro/kernels/select/kernel.py:69",
    "seg_reduce": "src/repro/kernels/select/kernel.py:126",
    "seg_sums": "src/repro/kernels/select/kernel.py:152",
    "commit_moves": "src/repro/kernels/migrate/kernel.py:135",
}
SERVE_REPLACES = {
    "pool_attention_partial":
        "src/repro/kernels/tiered_attention/kernel.py:99",
    "migrate_pages": "src/repro/kernels/migrate/kernel.py:50",
    # D1, the Mamba2 decode-state kernel, replaces none: the reference's
    # decode step (src/repro/models/ssm.py mamba_decode_step) is plain jnp
    "ssd_decode": None,
}
# serving: the measured load (the configs' SERVE_LOAD under
# repro_torch.launch.serve.full_load), 16 layers
FWD_BATCH, FWD_STEPS = 4, 128
SIDE_STEPS = 64                # tpp and static
# tolerances, with their reasons
K5_TOL = 1e-4        # K5 vs plain: float32 sums in another order (bf16 K/V
#                      are read exactly, so the same tolerance holds)
# cuda vs ref, one step from a shared state. In bf16 (phase 9) K5's and the
# plain version's last-bit float differences round some attention outputs
# to neighbouring bf16 values; every later layer then scores with
# activations that differ by ~2^-8 relative, and under the very peaked
# softmax of these random weights (scores spread over hundreds) that can
# move a head's attention to another token: logits and page hotness then
# differ by a few percent. In float32 (phase 10) the differences stay at
# float32 rounding.
TOL = {"bf16": {"logit_rtol": 1e-1, "hot_atol": 5e-2},
       "f32": {"logit_rtol": 1e-4, "hot_atol": 1e-4}}
FWD_RTOL = 1e-3      # decode vs forward in float32, relative to max |logit|
# prefill (slice F1): K7 and K8, Zamba2-7B and Llama 3.2 1B
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
PREFILL_SOURCE = "src/repro_torch/kernels/csrc/prefill.cu"
PREFILL_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:87",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:61",
}
# the reference's kernel-test tolerances (tests/test_kernels.py:11-12 and
# :137-141)
K7_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# K8 vs its plain version on the card is held tighter than the reference's
# kernel-test bound (atol 1e-4, rtol 5e-2, which the CPU tests against the
# reference keep): both compute in float32 with a_cum and its differences
# in float64 and were measured 9.5e-7 apart on phase 13's inputs on an
# H100 (PERF.md), while a kernel computing in bf16 or TF32 (~1e-3
# relative) fails this bound
K8_ATOL, K8_RTOL = 1e-5, 1e-4
# D1 vs its plain version: the state bit for bit (the same float64
# multiply-add, one rounding), y within atol and rtol 1e-5 (float32 sums
# over N in another order)
D1_TOL = 1e-5
# D1 timed at the decode cell's batch: (B, H, P, N, G) of Zamba2-7B's
# Mamba2 layers and of mamba2-130m's
D1_WIDTHS = {"zamba2": (256, 112, 64, 64, 2),
             "mamba2_130m": (256, 32, 48, 128, 1)}
PATH_TAIL = 1024     # K7's query rows checked on the S=32,768 path
# card times of the earlier designs of K1 (a block-wide argmax per winner),
# K2 (a block scan per 1,024-lane chunk with a running carry), K3 (a block
# of 256 threads per row, one scalar load at a time), K4 (one block
# walking the stream twice, a chunked scan), K5 (a block per sequence and
# kv head walking page by page), K6 (a block per layer and sequence, one
# 16-byte load in flight a thread; its time also held the wrapper's cast
# of a bool sel to int32), K7 (mma.sync over 64-query tiles) and
# K8 (a block per batch and head walking its chunks in order), as PERF.md
# records them (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
# times
EARLIER_MS = {"seg_topk": 0.3567, "seg_reduce": 0.0084, "seg_sums": 0.0112,
              "commit_moves": 0.0319, "pool_attention_partial": 0.3725,
              "migrate_pages": 0.0095,
              "flash_attention": 1.4350, "flash_attention_llama": 1.1220,
              "ssd_scan": 5.5703}
# the device kernels behind each redesigned op (profiler names), counted
# per op call
DEVICE_KERNELS = {
    "pool_attention_partial": ("pool_attention_split_kernel",
                               "pool_attention_merge_kernel"),
    "migrate_pages": ("migrate_pages_kernel",),
    "ssd_decode": ("ssd_decode_state_kernel",),
    "ssd_scan": ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                 "ssd_chunk_out_kernel"),
}
KERNEL_TAG = {"flash_attention": "K7", "ssd_scan": "K8"}


def ssd_ops(B: int, S: int, H: int, P: int, N: int, G: int, Q: int) -> int:
    """The operations K8's function needs: per chunk, C B^T once per group
    (2 tri N), and per head its masked product with x (2 tri P) and the
    chunk state and its readout (4 Q P N)."""
    tri = Q * (Q + 1) // 2
    return B * (S // Q) * (G * 2 * tri * N
                           + H * (2 * tri * P + 4 * Q * P * N))


PREFILL_B, PREFILL_S = 2, 4096           # cuda vs ref at full width
F32_LONG_S = 16384       # K7's f32 route also timed here (plain: no)
# bf16: phase 9's bound, relative to max |logit|; f32: float32 sums in
# another order through 16 or 24 layers
PREFILL_TOL = {"bfloat16": 1e-1, "float32": 1e-3}
TIMED_B, TIMED_S = 1, 32768              # the reference's prefill_32k, B cut
HYBRID_SIDE_STEPS = 16                   # tpp and static, hybrid serving
# Zamba2-7B at full width and 4 of its 14 shared-block periods (24 of 81
# Mamba2 layers): at full depth phases 14-16 took 195 s of the script's
# time limit
ZAMBA2_DEPTH = 24
HYBRID_FWD_BATCH, HYBRID_FWD_STEPS = 4, 64
# dynamic ownership (slices B and C): H1 is a churned host of C1's size
H1_TICKS, H1_HOT_TICKS = 40, 20
PERMUTED_TICKS = 60                      # stacked64, owner vector permuted
CHURN_IMPLS = ("cuda", "ref", "batched")
# K1's earlier design, timed beside the port's at the dynamic rowspace
# width: one block a row, whose rows past the 24,576 lanes it stages in
# shared memory are read again from device memory on every pass
EARLIER_TOPK_SOURCE = "scripts/selection_one_block.cu"


_LAST = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    print(f"[{name}] ({now - _LAST[0]:.1f}s) {msg}", flush=True)
    _LAST[0] = now


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ timing ----
def device_ms(fn, n: int = 50) -> float:
    """Median device time of ``fn`` over ``n`` launches, each bracketed by
    CUDA events. A sleep kernel runs first so the host enqueues every launch
    before the device reaches them: the events then time back-to-back device
    work, not host launch gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[n // 2]


def copy_bandwidth() -> float:
    """Bytes/s of a 512 MiB device-to-device ``copy_`` (read + write)."""
    import torch
    n = 1 << 27
    x = torch.empty(n, dtype=torch.float32, device="cuda").fill_(1.0)
    y = torch.empty_like(x)
    ms = device_ms(lambda: y.copy_(x), n=10)
    return 2 * 4 * n / (ms * 1e-3)


# ----------------------------------------------------------- phase 2 ----
def _topk_inputs(rng, T, S, int_rows=0.5, special=0.05):
    import numpy as np
    score = rng.standard_normal((T, S)).astype(np.float32)
    ints = rng.random(T) < int_rows          # integer rows force ties
    score[ints] = rng.integers(-20, 20, (int(ints.sum()), S))
    sp = rng.random((T, S))
    score[sp < special / 3] = np.inf
    score[(sp >= special / 3) & (sp < 2 * special / 3)] = -np.inf
    score[(sp >= 2 * special / 3) & (sp < special)] = np.nan
    valid = rng.random((T, S)) < 0.6
    return score, valid


def check_kernels(torch, np, OPS, REFS):
    """Every kernel wrapper vs its plain version on the card, bitwise."""
    KSEL, KMIG = OPS
    RSEL, RMIG = REFS
    rng = np.random.default_rng(0)
    cuda = "cuda"
    err = {k: 0.0 for k in REPLACES}
    cases = {k: 0 for k in REPLACES}

    def same(name, got, want):
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"{name}: shape/dtype {g.shape} {g.dtype} vs "
                    f"{w.shape} {w.dtype}")
            d = (g.to(torch.float64) - w.to(torch.float64)).abs()
            err[name] = max(err[name], float(d.max()) if d.numel() else 0.0)
            require(torch.equal(g, w), f"{name}: kernel != plain version")
        cases[name] += 1

    # seg_topk: full width, then edge cases (ties, +-inf, NaN, zero and
    # negative quotas, k > S, an all-invalid row)
    topk_cases = []
    score, valid = _topk_inputs(rng, T0, L0 // T0)
    quotas = rng.integers(-4, K_MAX + 40, T0).astype(np.int32)
    quotas[:3] = (0, -1, K_MAX)
    topk_cases.append((score, valid, quotas, K_MAX))
    for (T, S, k) in ((5, 7, 20), (9, 130, 5), (3, 1, 1), (4, 2049, 300)):
        score, valid = _topk_inputs(rng, T, S, special=0.2)
        valid[0] = False
        quotas = rng.integers(-2, S + 3, T).astype(np.int32)
        topk_cases.append((score, valid, quotas, k))
    score = np.zeros((2, 4096), np.float32)          # one big tie
    topk_cases.append((score, np.ones_like(score, bool),
                       np.array([4096, 17], np.int32), 4096))
    # the radix select's edges: single rows of 262,144 (past the 24,576
    # staged in shared memory), winners past the 2,048 sorted at once, rows
    # with nothing eligible, all-tied rows (-0.0 against +0.0) and quotas
    # -1, 0, 1, k, k + 40
    score, valid = _topk_inputs(rng, 1, 262144)
    for k in (K_MAX, 3000):
        topk_cases.append((score, valid, np.array([k], np.int32), k))
    score, valid = _topk_inputs(rng, 3, 8192)
    topk_cases.append((score, valid, np.array([5000, 2049, 4097], np.int32),
                       5000))
    for score, valid in ((np.full((2, 1000), np.nan, np.float32),
                          np.ones((2, 1000), bool)),
                         (rng.standard_normal((2, 1000)).astype(np.float32),
                          np.zeros((2, 1000), bool))):
        topk_cases.append((score, valid, np.array([5, 1000], np.int32), 300))
    for k, (score, valid) in ((2500, (np.full((5, 3000), 2.5, np.float32),
                                      np.ones((5, 3000), bool))),
                              (K_MAX, _topk_inputs(rng, 5, 4096))):
        if k == 2500:
            score[1] = np.where(rng.random(3000) < 0.5, -0.0, 0.0)
        topk_cases.append((score, valid,
                           np.array([-1, 0, 1, k, k + 40], np.int32), k))
    # the dynamic path's rowspace (S = L, K1's long route): each row's valid
    # lanes a prefix of about 1,250 columns, a third of the scores 0.0
    # (some -0.0), row 1's winners running into the tie at 0.0
    score = (rng.random((4, 262144)) * 4).astype(np.float32)
    u = rng.random(score.shape)
    score[u < 1 / 3] = 0.0
    score[u < 1 / 30] = -0.0
    score[1, 5:] = 0.0
    valid = np.arange(262144)[None, :] < rng.integers(1150, 1350, 4)[:, None]
    topk_cases.append((score, valid, np.array([0, 19, 7, 19], np.int32),
                       K_MAX))
    for score, valid, quotas, k in topk_cases:
        args = (torch.as_tensor(score, device=cuda),
                torch.as_tensor(valid, device=cuda),
                torch.as_tensor(quotas, device=cuda))
        kk = max(min(k, score.shape[1]), 1)
        same("seg_topk", KSEL.seg_topk(*args, k), RSEL.seg_topk_ref(*args, kk))
    # the long route on views at offsets (score, valid): in phase (1, 1),
    # out of phase (1, 3: every lane one at a time), with a block's keys
    # staged (2% valid) and overflowing the stage and the candidate buffer
    # (60%, winners past the 2,048 sorted at once)
    lrng = np.random.default_rng(22)
    for s_off, v_off, p_valid in ((1, 1, 0.6), (1, 3, 0.02), (1, 3, 0.6)):
        score = (lrng.random((2, 262144)) * 4).astype(np.float32)
        valid = lrng.random(score.shape) < p_valid
        args = (at_offset(torch, torch.as_tensor(score, device=cuda), s_off),
                at_offset(torch, torch.as_tensor(valid, device=cuda), v_off),
                torch.tensor([K_MAX, 3000], dtype=torch.int32, device=cuda))
        same("seg_topk", KSEL.seg_topk(*args, 3000),
             RSEL.seg_topk_ref(*args, 3000))

    # seg_reduce / seg_sums: full-width 0/1 masks (what the tick feeds) and
    # full-range int32 values whose sums wrap
    S0 = L0 // T0
    xs = [rng.integers(0, 2, (T0, S0)).astype(np.int32),
          rng.integers(-2**31, 2**31, (T0, S0), dtype=np.int64
                       ).astype(np.int32),
          rng.integers(-5, 5, (7, 3000)).astype(np.int32)]
    for x in xs:
        valid = rng.random(x.shape) < 0.7
        a = (torch.as_tensor(x, device=cuda),
             torch.as_tensor(valid, device=cuda))
        same("seg_reduce", KSEL.seg_reduce(*a), RSEL.seg_reduce_ref(*a))
        same("seg_sums", (KSEL.seg_sums(*a),), (RSEL.seg_sums_ref(*a),))
    # K2's alignment paths: rows not 16-byte aligned, a long row (runs of
    # many units), x and valid as views at odd offsets (in phase and out)
    for T, S, x_off, v_off in ((T0, S0 + 1, 0, 0), (T0, S0 - 3, 1, 1),
                               (T0, S0, 1, 0), (1, 262144, 0, 3),
                               (200, S0, 3, 3)):
        x = rng.integers(-2**31, 2**31, (T, S), dtype=np.int64
                         ).astype(np.int32)
        a = (at_offset(torch, torch.as_tensor(x, device=cuda), x_off),
             at_offset(torch, torch.as_tensor(rng.random((T, S)) < 0.7,
                                              device=cuda), v_off))
        same("seg_reduce", KSEL.seg_reduce(*a), RSEL.seg_reduce_ref(*a))

    # commit_moves: full-width stream with more taken lanes than C (ring
    # overflow) and head near 2**31 (wraps), then a small stream
    for (L, C, T, k, p_take, head) in (
            (L0, 4096, T0, K_MAX, 0.4, 2**31 - 1000),
            (L0, 4096, T0, K_MAX, 0.1, 7), (48, 8, 3, 5, 0.5, 2**31 - 3)):
        S = L // T
        cols = np.stack([rng.permutation(S)[:k] for _ in range(T)])
        pages = (np.arange(T)[:, None] * S + cols).astype(np.int32)
        take = rng.random((T, k)) < p_take
        pages = np.where(take, pages, L).reshape(-1).astype(np.int32)
        tenants = np.repeat(np.arange(T, dtype=np.int32), k)
        hot = rng.standard_normal(T * k).astype(np.float32)
        tier = rng.integers(0, 2, L).astype(np.int32)
        ring = rng.integers(-9, 9, (C, 5)).astype(np.int32)

        def run(fn, bits):
            tt = torch.as_tensor(tier, device=cuda)
            rr = torch.as_tensor(ring, device=cuda)
            hh = torch.tensor(head, dtype=torch.int32, device=cuda)
            h = torch.as_tensor(hot, device=cuda)
            return fn(tt, rr, hh, torch.as_tensor(pages, device=cuda),
                      torch.as_tensor(take.reshape(-1), device=cuda),
                      torch.as_tensor(tenants, device=cuda),
                      h.view(torch.int32) if bits else h, 11,
                      direction=1, to_tier=0)
        same("commit_moves", run(KMIG.commit_moves, False),
             run(RMIG.commit_moves_ref, True))
    torch.cuda.synchronize()
    return err, cases


def at_offset(torch, t, offset: int):
    """``t`` as a contiguous view ``offset`` elements into a larger buffer
    (not 16-byte aligned for an odd offset)."""
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


# ----------------------------------------------------------- phase 3 ----
def _events_to_lists(ev) -> list:
    return [[int(e["tick"]), int(e["tenant"]), int(e["page"]),
             int(e["direction"]), round(float(e["hotness"]), 5)] for e in ev]


def collect(r, ring_head: int = 40) -> dict:
    """The telemetry fields the reference's golden fixtures pin (a copy of
    tests/test_golden_trace.py ``_collect``)."""
    ts = r.tier_stats
    return {
        "final_fast_usage": r.fast_usage[-1].tolist(),
        "final_slow_usage": r.slow_usage[-1].tolist(),
        "total_promotions": r.promotions.sum(0).tolist(),
        "total_demotions": r.demotions.sum(0).tolist(),
        "total_attempted": r.attempted.sum(0).tolist(),
        "final_thrash_events": r.thrash_events[-1].tolist(),
        "final_pool_free": int(r.pool_free[-1]),
        "promo_attempts": ts["promo_attempts"].tolist(),
        "promo_success": ts["promo_success"].tolist(),
        "demo_attempts": ts["demo_attempts"].tolist(),
        "demo_success": ts["demo_success"].tolist(),
        "resid_hist": ts["resid_hist"].tolist(),
        "resid_p50": ts["resid_p50"].tolist(),
        "resid_p99": ts["resid_p99"].tolist(),
        "contended_frac": [round(float(x), 6) for x in ts["contended_frac"]],
        "throttled_frac": [round(float(x), 6) for x in ts["throttled_frac"]],
        "below_protection_frac": [round(float(x), 6)
                                  for x in ts["below_protection_frac"]],
        "obs_ticks": int(ts["ticks"]),
        "ring_events_decoded": len(r.migrations),
        "ring_events_dropped": int(r.migrations_dropped),
        "ring_head": _events_to_lists(r.migrations[:ring_head]),
        "ring_tail": _events_to_lists(r.migrations[-ring_head:]),
    }


def diff(got, want, path="") -> None:
    """Exact on ints/strings, atol 1e-4 on floats, recursive on lists."""
    if isinstance(want, list):
        require(isinstance(got, list) and len(got) == len(want),
                f"{path}: length {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            diff(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str)):
        require(got == want, f"{path}: {got!r} != {want!r}")
    elif isinstance(want, int):
        require(int(got) == want, f"{path}: {got} != {want}")
    elif isinstance(want, float):
        require(abs(float(got) - want) <= 1e-4, f"{path}: {got} != {want}")
    else:
        require(got == want, f"{path}: {got!r} != {want!r}")


# ----------------------------------------------------------- phase 4 ----
def bench_config(TieringConfig, T: int, L: int):
    share = L // (4 * T)
    return TieringConfig(
        n_tenants=T, n_fast_pages=L // 4, n_slow_pages=L,
        lower_protection=(max(share // 2, 1),) * T,
        upper_bound=(2 * share,) * T)


def bench_trace(np, T: int, L: int, ticks: int):
    """bench_tick's inputs: 30% of pages hot (4.0), the rest 0.1, all alive,
    the same every tick."""
    rng = np.random.default_rng(0)
    acc = np.where(rng.random(L) < 0.3, 4.0, 0.1).astype(np.float32)
    owner = np.repeat(np.arange(T, dtype=np.int32), L // T)
    return (owner, np.broadcast_to(acc, (ticks, L)).copy(),
            np.ones((ticks, L), bool))


def state_leaves(state):
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if hasattr(v, "_fields"):
            for g in v._fields:
                out[f"{f}.{g}"] = getattr(v, g)
        elif v is not None:
            out[f] = v
    return out


def compare_runs(torch, a_state, a_out, b_state, b_out, what: str) -> None:
    pairs = {**{f"state.{k}": (v, state_leaves(b_state)[k])
                for k, v in state_leaves(a_state).items()},
             **{f"out.{f}": (getattr(a_out, f), getattr(b_out, f))
                for f in a_out._fields}}
    for name, (x, y) in pairs.items():
        if not torch.is_tensor(x):
            require(x == y, f"{what}: {name} {x} != {y}")
        elif x.is_floating_point():
            require(bool(torch.isfinite(x).all()), f"{what}: {name} finite")
            require(torch.allclose(x, y, rtol=1e-5, atol=1e-4),
                    f"{what}: {name} floats differ")
        else:
            require(torch.equal(x, y), f"{what}: {name} differs")


def tick_ms(torch, make_tick, init_state, cfg, owner, acc, impl,
            n: int = 10) -> float:
    """Mean device-synchronised time of one tick (CUDA events), after a
    warm-up tick, over ``n`` ticks of the bench trace."""
    tick = make_tick(cfg, owner, "equilibria", K_MAX, impl=impl,
                     device="cuda")
    state = init_state(cfg, owner.shape[0], owner=owner, device="cuda")
    a = torch.as_tensor(acc, device="cuda")
    alive = torch.ones_like(a, dtype=torch.bool)
    state, _ = tick(state, (a, alive))
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        state, _ = tick(state, (a, alive))
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def tick_profile(torch, make_tick, init_state, cfg, owner, acc, impl,
                 n: int = 5):
    """Where one tick's device time goes: ``torch.profiler`` over ``n``
    ticks after a warm-up tick. Returns (device events per tick, busy ms per
    tick as the union of their intervals, [(name, ms per tick, count per
    tick)] by total time), or None when the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tick = make_tick(cfg, owner, "equilibria", K_MAX, impl=impl,
                     device="cuda")
    state = init_state(cfg, owner.shape[0], owner=owner, device="cuda")
    a = torch.as_tensor(acc, device="cuda")
    alive = torch.ones_like(a, dtype=torch.bool)
    state, _ = tick(state, (a, alive))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = tick(state, (a, alive))
        torch.cuda.synchronize()
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for s, e, name in dev:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        ms, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e3, cnt + 1)
    top = sorted(((k, v[0] / n, v[1] / n) for k, v in by_name.items()),
                 key=lambda r: -r[1])
    return len(dev) / n, busy / 1e3 / n, top


# ----------------------------------------------------------- phase 8 ----
def _attn_case(np, rng, B, H, K, D, pt, Mp, n_pages):
    """Full-width K5 inputs: pages drawn from ``n_pages`` ids, ~15% of the
    slots free, lengths anywhere inside a page."""
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kv = [rng.standard_normal((B, Mp, pt, K, D)).astype(np.float32)
          for _ in range(2)]
    slot = np.stack([rng.permutation(n_pages)[:Mp] for _ in range(B)])
    slot = np.where(rng.random((B, Mp)) < 0.15, -1, slot).astype(np.int32)
    seq = rng.integers(3 * pt, n_pages * pt, B).astype(np.int32)
    return q, kv[0], kv[1], slot, seq


def check_serve_kernels(torch, np, TA, TA_REF, KMIG, KMIG_REF):
    """K5 and K6 wrappers vs their plain versions on the card at the serving
    path's full-width shapes."""
    rng = np.random.default_rng(8)
    err = {k: 0.0 for k in SERVE_REPLACES}
    cases = {k: 0 for k in SERVE_REPLACES}
    pt = 16
    # S1's widths (Llama 3.2 1B, fast and slow pools), then S3's (Zamba2-7B)
    for B, H, K, D, Mp in ((64, 32, 8, 64, 32), (64, 32, 8, 64, 16),
                           (32, 32, 32, 112, 16)):
        q, pk, pv, slot, seq = _attn_case(np, rng, B, H, K, D, pt, Mp, 40)
        for dtype in (torch.bfloat16, torch.float32):
            a = [torch.as_tensor(x, device="cuda") for x in
                 (q, pk, pv, slot, seq)]
            a[0] = a[0].to(dtype)
            a[1], a[2] = a[1].to(dtype), a[2].to(dtype)
            for window in (None, 40):
                got = TA.pool_attention_partial(*a, window=window)
                want = TA_REF.pool_attention_partial_ref(*a, window=window)
                for g, w in zip(got, want):
                    require(bool(torch.isfinite(g).all()), "K5: non-finite")
                    d = float((g - w).abs().max())
                    err["pool_attention_partial"] = max(
                        err["pool_attention_partial"], d)
                    require(torch.allclose(g, w, atol=K5_TOL, rtol=K5_TOL),
                            f"K5 B={B} H={H} K={K} D={D} Mp={Mp} {dtype} "
                            f"window={window}: max err {d}")
                cases["pool_attention_partial"] += 1
    # K6, one pool and K+V in one launch: S1's and S3's pools at full depth,
    # then a page of 15 elements (not a multiple of 16 bytes) with more
    # sequences than one block compacts at once; aligned and unaligned
    for (L, B, Mf, Ms, pt_, K, D), offsets in (
            ((16, 64, 32, 16, 16, 8, 64), (0, 1)),
            ((14, 32, 16, 16, 16, 32, 112), (0, 1)),
            ((3, 300, 4, 3, 3, 1, 5), (0,))):
        si = torch.as_tensor(rng.integers(0, Mf, B).astype(np.int32),
                             device="cuda")
        di = torch.as_tensor(rng.integers(0, Ms, B).astype(np.int32),
                             device="cuda")
        sel = torch.as_tensor(rng.random(B) < 0.25, device="cuda")
        same = torch.clamp(si, max=Ms - 1)
        oob_s, oob_d = si.clone(), di.clone()
        oob_s[0::3], oob_s[1::3], oob_d[0::2], oob_d[1::2] = -3, Mf + 2, \
            Ms + 5, -1
        for dtype in (torch.bfloat16, torch.float32):
            for offset in offsets:
                pools = [at_offset(torch, torch.randn(
                    (L, B, m, pt_, K, D), device="cuda").to(dtype), offset)
                    for m in (Mf, Ms, Mf, Ms)]
                for s_i, d_i, se in ((si, di, sel), (same, same, sel),
                                     (si, di, torch.zeros_like(sel)),
                                     (oob_s, oob_d, torch.ones_like(sel))):
                    got = KMIG.migrate_pages(pools[0], pools[1].clone(), s_i,
                                             d_i, se)
                    want = KMIG_REF.migrate_pages_ref(
                        pools[0], pools[1].clone(), s_i, d_i, se)
                    require(torch.equal(got, want),
                            f"K6 {dtype} L={L} B={B} K={K} D={D} offset "
                            f"{offset}: kernel != plain")
                    got = KMIG.migrate_pages_kv(
                        pools[0], pools[1].clone(), pools[2],
                        pools[3].clone(), s_i, d_i, se)
                    want = KMIG_REF.migrate_pages_kv_ref(
                        pools[0], pools[1].clone(), pools[2],
                        pools[3].clone(), s_i, d_i, se)
                    require(all(torch.equal(g, w) for g, w in zip(got, want)),
                            f"K6 K+V {dtype} L={L} B={B} K={K} D={D} offset "
                            f"{offset}: kernel != plain")
                    cases["migrate_pages"] += 2
                del pools
    torch.cuda.synchronize()
    return err, cases


def ssd_decode_inputs(torch, B, H, P, N, G, seed: int, dtype, conv: bool,
                      layers: int = 4):
    """Seeded inputs of D1 on the card: a stacked [layers, B, H, P, N]
    float32 state, x [B,H,P] and b, c [B,G,N] in ``dtype`` (with ``conv``
    as the conv step's outputs are: transposed views of [C, B] tensors,
    else contiguous), dt (softplus of N(0, 1.2), as the init's), da =
    exp(-dt) and D [H]."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def low(cols):
        t = (torch.randn((cols, B) if conv else (B, cols), generator=g,
                         device="cuda") * 0.5).to(dtype)
        return t.t() if conv else t

    h = torch.randn((layers, B, H, P, N), generator=g, device="cuda")
    x = low(H * P).reshape(B, H, P)
    b = low(G * N).reshape(B, G, N)
    c = low(G * N).reshape(B, G, N)
    dt = torch.nn.functional.softplus(
        torch.randn((B, H), generator=g, device="cuda") * 1.2)
    D = 1.0 + 0.1 * torch.randn(H, generator=g, device="cuda")
    return h, x, b, c, dt, torch.exp(-dt), D


def bitwise(torch, a, b) -> bool:
    """Equal float32 tensors bit for bit (NaNs included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_ssd_decode(torch, SDEC, SDEC_REF):
    """D1 against its plain version on the card: at the decode cell's B=256
    with Zamba2-7B's and mamba2-130m's widths, at B=3 with each and at the
    smoke configs' 16 x 16 (B=5); x, B and C in bf16 (as the conv step's
    transposed views, and contiguous) and in float32; on layer slice 2 of a
    stacked [4, B, H, P, N] cache: the slice updated in place and equal to
    the plain state bit for bit, the other layers untouched, y within
    ``D1_TOL``, one launch a call. Returns (max |y - plain y|, cases)."""
    err, cases = 0.0, 0
    for B, H, P, N, G in (*D1_WIDTHS.values(), (3, 112, 64, 64, 2),
                          (3, 32, 48, 128, 1), (5, 8, 16, 16, 1)):
        for dtype, conv in ((torch.bfloat16, True), (torch.bfloat16, False),
                            (torch.float32, True)):
            h, x, b, c, dt, da, D = ssd_decode_inputs(
                torch, B, H, P, N, G, 8 + cases, dtype, conv)
            before = h.clone()
            want_h, want_y = SDEC_REF.ssd_decode_ref(h[2], x, b, c, dt, da, D)
            n0 = SDEC.ssd_decode.launches
            got_h, got_y = SDEC.ssd_decode(h[2], x, b, c, dt, da, D)
            torch.cuda.synchronize()
            what = (f"D1 B={B} H={H} P={P} N={N} G={G} {dtype} "
                    f"{'conv views' if conv else 'contiguous'}")
            require(SDEC.ssd_decode.launches == n0 + 1
                    and got_h.data_ptr() == h[2].data_ptr(),
                    f"{what}: not one launch in place")
            require(bitwise(torch, h[2], want_h), f"{what}: state != plain")
            require(all(bitwise(torch, h[i], before[i]) for i in (0, 1, 3)),
                    f"{what}: another layer of the cache moved")
            d = float((got_y - want_y).abs().max())
            err = max(err, d)
            require(torch.allclose(got_y, want_y, atol=D1_TOL, rtol=D1_TOL),
                    f"{what}: y max abs err {d}")
            cases += 1
            del h, before, want_h, want_y, got_y
    torch.cuda.empty_cache()
    return err, cases


def d1_numbers(torch, SDEC, SDEC_REF, B, H, P, N, G) -> dict:
    """D1 timed on layer 1 of a stacked cache with x, B and C as the conv
    step's bf16 views: the kernel, its plain version, the plain version
    plus the copy of the new state into the cache (the decode step's path
    before D1), and its bound (one read and one write of the state at 3.35
    TB/s)."""
    h, x, b, c, dt, da, D = ssd_decode_inputs(torch, B, H, P, N, G, 11,
                                              torch.bfloat16, True)
    layer = h[1]

    def plain_copy():
        new, _ = SDEC_REF.ssd_decode_ref(layer, x, b, c, dt, da, D)
        layer.copy_(new)

    nbytes = 2 * B * H * P * N * 4
    out = dict(
        ms=device_ms(lambda: SDEC.ssd_decode(layer, x, b, c, dt, da, D)),
        plain_ms=device_ms(
            lambda: SDEC_REF.ssd_decode_ref(layer, x, b, c, dt, da, D), n=10),
        plain_copy_ms=device_ms(plain_copy, n=10),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
    del h, layer
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def d1_inputs(SDEC, n_layers: int, found: dict):
    """While active, the inputs but the state of each card call of
    ``ssd_decode`` under impl "cuda" are kept in ``found`` by layer (the
    call's index mod ``n_layers``: a step calls it once a layer, in order),
    the last of each layer last. The op counts its launches on the module's
    global of its name, the hook while it is active; the count is carried
    over both ways."""
    orig = SDEC.ssd_decode
    calls = [0]

    def hooked(h, *ins, impl="cuda"):
        if impl == "cuda" and h.is_cuda:
            found[calls[0] % n_layers] = ins
            calls[0] += 1
        return orig(h, *ins, impl=impl)

    hooked.launches = orig.launches
    SDEC.ssd_decode = hooked
    try:
        yield
    finally:
        SDEC.ssd_decode = orig
        orig.launches = hooked.launches


def d1_replay(torch, SDEC, SDEC_REF, hs, found: dict, label: str) -> float:
    """D1 on each layer slice of a run's own stacked state ``hs`` [L, B, H,
    P, N] (left as it is: the calls update a copy), with the inputs the
    path last gave that layer (``d1_inputs``), against the plain version:
    each slice updated in place and equal bit for bit, the layers after it
    untouched, y within ``D1_TOL``, one launch a call. Returns the largest
    |y - plain y|."""
    L = hs.shape[0]
    require(sorted(found) == list(range(L)),
            f"{label}: D1's inputs seen for layers {sorted(found)} of {L}")
    work, err = hs.clone(), 0.0
    for idx in range(L):
        want_h, want_y = SDEC_REF.ssd_decode_ref(hs[idx], *found[idx])
        n0 = SDEC.ssd_decode.launches
        got_h, got_y = SDEC.ssd_decode(work[idx], *found[idx])
        torch.cuda.synchronize()
        what = f"{label}: D1 on layer {idx} of the run's state {_shape(hs)}"
        require(SDEC.ssd_decode.launches == n0 + 1
                and got_h.data_ptr() == work[idx].data_ptr(),
                f"{what}: not one launch in place")
        require(bitwise(torch, work[idx], want_h), f"{what}: state != plain")
        require(bitwise(torch, work[idx + 1:], hs[idx + 1:]),
                f"{what}: a later layer moved")
        d = float((got_y - want_y).abs().max())
        require(torch.allclose(got_y, want_y, atol=D1_TOL, rtol=D1_TOL),
                f"{what}: y max abs err {d}")
        err = max(err, d)
    del work
    return err


def d1_launches(cfg, steps: int) -> int:
    """D1's launches in ``steps`` decode steps of ``cfg``'s serve step under
    impl "cuda": one a Mamba2 layer a step (the hybrid and ssm families'
    layers are all Mamba2 layers; the others have none)."""
    return cfg.num_layers * steps if cfg.family in ("hybrid", "ssm") else 0


# ----------------------------------------------------------- phase 9 ----
def clone_tree(torch, x):
    """A deep copy of a (nested) NamedTuple of tensors."""
    if torch.is_tensor(x):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(clone_tree(torch, v) for v in x))
    return x


def clone_state(torch, state: dict) -> dict:
    """A deep copy of a serve state (the KV cache, and the Mamba2 decode
    state of the hybrid)."""
    return {k: clone_tree(torch, v) for k, v in state.items()}


def _cache_parts(torch, kv):
    """(integer leaves, float leaves) of a TieredKVCache's metadata, by name;
    the ring's hotness column is float bits."""
    ints, floats = {}, {}
    for f in kv._fields:
        v = getattr(kv, f)
        if f in ("fast_k", "fast_v", "slow_k", "slow_v", "t"):
            continue
        leaves = ({f"{f}.{g}": getattr(v, g) for g in v._fields}
                  if hasattr(v, "_fields") else {f: v})
        for name, x in leaves.items():
            if name == "ring.data":
                ints[name] = x[:, :4]
                floats["ring.hot"] = x[:, 4].contiguous().view(torch.float32)
            elif x.is_floating_point():
                floats[name] = x
            else:
                ints[name] = x
    return ints, floats


def deciding_margin(torch, fused_mul_add, rec, tenant, tcfg) -> float:
    """The smallest gap between the values that decide this step's moves,
    from the plain run's inputs to the tiering step: per sequence the two
    coldest fast pages (demotion source) and the two hottest slow-or-
    demoted pages (promotion source), the hottest slow page against the
    promotion threshold, and per tenant the order of the sequences."""
    fast_hot, slow_hot, fast_used, slow_used, mf, ms = rec
    fh = torch.where(fast_used, fused_mul_add(tcfg.hot_decay, fast_hot, mf),
                     0.0)
    sh = torch.where(slow_used, fused_mul_add(tcfg.hot_decay, slow_hot, ms),
                     0.0)
    cold = torch.where(fast_used, fh, float("inf")).sort(dim=1).values
    hot = torch.cat([torch.where(slow_used, sh, float("-inf")), cold[:, :1]],
                    dim=1).sort(dim=1, descending=True).values
    gaps = [cold[:, 1] - cold[:, 0], hot[:, 0] - hot[:, 1],
            (hot[:, 0] - tcfg.promo_hot_threshold).abs()]
    for vals in (cold[:, 0], hot[:, 0]):
        for t in range(tcfg.n_tenants):
            v = vals[tenant == t].sort().values
            gaps.append(v[1:] - v[:-1])
    g = torch.cat([x[torch.isfinite(x)] for x in gaps])
    return float(g.min()) if g.numel() else float("inf")


@contextlib.contextmanager
def patched(mod, name: str, make):
    """While active, ``mod.name`` is ``make(original)``; restored after."""
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield orig
    finally:
        setattr(mod, name, orig)


@contextlib.contextmanager
def moe_inputs(LAYERS, calls: list):
    """While active, every ``moe_block`` (prefill) and ``moe_block_decode``
    call appends (params, input, capacity) to ``calls``; it launches
    nothing, so a timed step stays as it was."""
    def recording(capacity):
        def make(orig):
            def f(p, x, cfg):
                calls.append((p, x, capacity))
                return orig(p, x, cfg)
            return f
        return make

    with patched(LAYERS, "moe_block", recording(True)), \
            patched(LAYERS, "moe_block_decode", recording(False)):
        yield


def moe_routes(torch, LAYERS, cfg, calls) -> list:
    """The routing of each recorded moe call, as the layer decides it from
    its own input: each token's top-k experts (sorted; the prefill's
    membership mask) and, in the prefill, each expert's kept tokens
    (sorted); with each token's deciding margin, the gap between its k-th
    and (k+1)-th router probabilities."""
    out = []
    for p, x, capacity in calls:
        m = cfg.moe
        k = m.top_k
        probs = LAYERS._router(p, x)
        vals, idx = LAYERS.top_k(probs, k + 1)
        margin = (vals[..., k - 1] - vals[..., k]).reshape(-1)
        if not capacity:
            out.append(([idx[..., :k].reshape(-1, k).sort(-1).values],
                        margin))
            continue
        member = probs >= vals[..., k - 1:k]
        s = x.shape[1]
        c = min(max(math.ceil(s * k / m.num_experts * m.capacity_factor), 4),
                s)
        kept = LAYERS.top_k(torch.where(member, probs, 0.0).transpose(1, 2),
                            c)[1].sort(-1).values
        out.append(([member, kept], margin))
    return out


def route_diff(torch, a: list, b: list) -> list:
    """Per moe layer, the routing decisions that differ between two runs'
    ``moe_routes``: tokens whose experts differ, plus (prefill) experts
    whose kept tokens differ."""
    if not a:
        return []
    n = [sum((x != y).any(-1).sum() for x, y in zip(ra, rb))
         for (ra, _), (rb, _) in zip(a, b)]
    return torch.stack(n).tolist()


def serve_compare(torch, np, ctx, mode: str, steps: int, tol: dict,
                  snapshot_at=None):
    """Decode ``steps`` teacher-forced tokens with impl "cuda", and from a
    copy of the same state before every step the plain "ref" step; compare.
    Integer KV metadata must be bitwise equal, unless the step's deciding
    margin is within ``tol["hot_atol"]`` (an excused near-tie flip); logits
    within ``tol["logit_rtol"]`` of max |logit|, hotness within
    ``tol["hot_atol"]``, except in a moe model's steps whose expert routing
    differs between the two runs (``route_flips``: step, first layer,
    decisions); the hybrid's Mamba2 state is reported relative to its max
    |value| (``mamba_rel``). Returns the run's numbers, the final cuda
    state and the cuda logits per step."""
    SD, fused_mul_add = ctx["SD"], ctx["fused_mul_add"]
    cfg, tcfg, model, toks = ctx["cfg"], ctx["tcfg"], ctx["model"], \
        ctx["toks"]
    B, seq = toks.shape[0], ctx["steps"]
    step_c = SD.build_serve_step(cfg, tcfg, B, seq, mode=mode, impl="cuda")
    step_r = SD.build_serve_step(cfg, tcfg, B, seq, mode=mode, impl="ref")
    state = SD.init_serve_state(cfg, tcfg, B, seq)
    if ctx.get("cross") is not None:       # encdec, vlm: precomputed K/V
        state["cross_k"], state["cross_v"] = (x.clone()
                                              for x in ctx["cross"])
    rec = ctx["rec"]
    out = {"logit_rel": [], "hot_err": [], "float_err": 0.0, "flips": [],
           "route_flips": [], "snapshot": None, "logits": []}
    e0 = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    e1 = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    calls: list = []
    moe = cfg.family == "moe"
    with torch.no_grad(), (moe_inputs(ctx["LAYERS"], calls) if moe
                           else contextlib.nullcontext()):
        for i in range(steps):
            if snapshot_at == i:
                out["snapshot"] = clone_state(torch, state)
            ref_state = None          # one copy of the pools at a time
            ref_state = clone_state(torch, state)
            tok = toks[:, i:i + 1]
            calls.clear()
            e0[i].record()
            lc, state = step_c(model, state, tok)
            e1[i].record()
            calls_c = list(calls)
            calls.clear()
            lr, ref_state = step_r(model, ref_state, tok)
            require(bool(torch.isfinite(lc).all()), f"{mode} step {i}: "
                    "non-finite logits")
            routed = False
            if moe:
                diff = route_diff(torch, moe_routes(torch, ctx["LAYERS"], cfg,
                                                    calls_c),
                                  moe_routes(torch, ctx["LAYERS"], cfg,
                                             calls))
                first = next((n for n, d in enumerate(diff) if d), None)
                if first is not None:
                    routed = True
                    out["route_flips"].append((i, first, sum(diff)))
            out["logits"].append(lc[:, 0])
            out["slow_hot_max"] = max(out.get("slow_hot_max", 0.0), float(
                state["kv"].slow_hot.max()))
            out["fast_hot_max"] = max(out.get("fast_hot_max", 0.0), float(
                state["kv"].fast_hot.max()))
            out["logit_rel"].append(float(
                (lc.float() - lr.float()).abs().max()
                / lr.float().abs().max()))
            if "mamba" in state:
                for f in ("h", "conv_x"):
                    a = getattr(state["mamba"], f).float()
                    b = getattr(ref_state["mamba"], f).float()
                    out["mamba_rel"] = max(out.get("mamba_rel", 0.0), float(
                        (a - b).abs().max() / b.abs().max().clamp(min=1e-30)))
            ic, fc = _cache_parts(torch, state["kv"])
            ir, fr = _cache_parts(torch, ref_state["kv"])
            bad = [k for k in ic if not torch.equal(ic[k], ir[k])]
            if bad:
                margin = deciding_margin(torch, fused_mul_add, rec["ref"],
                                         state["kv"].tenant, tcfg)
                out["flips"].append((i, margin, bad))
                continue
            hot = 0.0
            for k in fc:
                d = float((fc[k] - fr[k]).abs().max()) if fc[k].numel() \
                    else 0.0
                if k in ("fast_hot", "slow_hot", "ring.hot"):
                    hot = max(hot, d)
                elif not routed:
                    out["float_err"] = max(out["float_err"], d)
            out["hot_err"].append((i, hot))
    torch.cuda.synchronize()
    out["ms"] = [a.elapsed_time(b) for a, b in zip(e0, e1)]
    out["state"] = state
    return out


def check_compare(np, run, tol: dict, what: str,
                  hold_floats: bool = True) -> None:
    """Print a ``serve_compare`` run's agreement (max and p99 over steps)
    and raise unless it is within ``tol``: the integers in every step (a
    flip excused only within its deciding margin), logits and hotness in
    every step whose expert routing agrees (all steps but a moe model's),
    unless ``hold_floats`` is False (a cell held block by block)."""
    routed = {i for i, _, _ in run["route_flips"]}
    lr_all = np.asarray(run["logit_rel"])
    lr = np.asarray([v for i, v in enumerate(run["logit_rel"])
                     if i not in routed] or [0.0])
    he_all = np.asarray([h for _, h in run["hot_err"]] or [0.0])
    he = np.asarray([h for i, h in run["hot_err"] if i not in routed]
                    or [0.0])
    flips = [(i, float(f"{m:.3g}")) for i, m, _ in run["flips"]]
    worst = max((m for _, m in flips), default=0.0)
    msg = (f"cuda vs ref: ints bitwise in {len(lr_all) - len(flips)} of "
           f"{len(lr_all)} steps, {len(flips)} near-tie flips excused "
           f"(largest deciding margin {worst:.3g}; first {flips[:5]})")
    if run["route_flips"]:
        msg += (f"; expert routing differs in {len(routed)} steps (step, "
                f"first layer, decisions: {run['route_flips'][:4]}): over "
                f"all steps logits rel err max {lr_all.max():.3g} median "
                f"{np.median(lr_all):.3g}, hotness err max "
                f"{he_all.max():.3g}; held in the other "
                f"{len(lr_all) - len(routed)}")
    phase(what, msg + f"; logits rel err max {lr.max():.3g} p99 "
          f"{np.quantile(lr, 0.99):.3g} median {np.median(lr):.3g} <= "
          f"{tol['logit_rtol']}; hotness err max {he.max():.3g} p99 "
          f"{np.quantile(he, 0.99):.3g} median {np.median(he):.3g} <= "
          f"{tol['hot_atol']}")
    for i, margin, bad in run["flips"]:
        require(margin <= tol["hot_atol"], f"{what} step {i}: integers "
                f"differ in {bad} with deciding margin {margin:.3g} > "
                f"{tol['hot_atol']}")
    require(run["float_err"] <= 1e-5, f"{what}: float state differs by "
            f"{run['float_err']:.3g}")
    if not hold_floats:
        phase(what, "logits and hotness not held end to end here: the "
                    "cell is held block by block (serve_layer_check)")
        return
    require(lr.max() <= tol["logit_rtol"], f"{what}: logits differ by "
            f"{lr.max():.3g} of max |logit| > {tol['logit_rtol']}")
    require(he.max() <= tol["hot_atol"], f"{what}: hotness differs by "
            f"{he.max():.3g} > {tol['hot_atol']}")


# ----------------------------------------------------------- phase 11 ----
def valid_tokens(torch, slot_page, seq_len, pt) -> int:
    tok = slot_page[:, :, None] * pt + torch.arange(pt,
                                                    device=slot_page.device)
    ok = (slot_page >= 0)[:, :, None] & (tok <= seq_len[:, None, None])
    return int(ok.sum())


def sdpa_inputs(torch, q, pools, pages, seq_len, pt):
    """The valid tokens of both pools gathered into dense [B, K, T, D] K/V
    with a validity mask, for one scaled_dot_product_attention call."""
    ks, vs, oks = [], [], []
    for pk, pv, page in zip(pools[0::2], pools[1::2], pages):
        B, Mp, _, K, D = pk.shape
        ks.append(pk.reshape(B, Mp * pt, K, D))
        vs.append(pv.reshape(B, Mp * pt, K, D))
        tok = page[:, :, None] * pt + torch.arange(pt, device=page.device)
        oks.append(((page >= 0)[:, :, None] & (tok <= seq_len[:, None, None])
                    ).reshape(B, Mp * pt))
    k = torch.cat(ks, 1).transpose(1, 2).contiguous()
    v = torch.cat(vs, 1).transpose(1, 2).contiguous()
    mask = torch.cat(oks, 1)[:, None, None, :]
    return q[:, :, None, :], k, v, mask


def profile_fn(torch, fn):
    """Device events of one call of ``fn`` under torch.profiler: (events,
    busy ms as the union of their intervals, [(name, ms, count)] by total
    time, wall ms of the profiled call), or None without device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    busy, end = 0.0, float("-inf")
    by_name: dict = {}
    for s, e, name in dev:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        ms, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e3, cnt + 1)
    top = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                 key=lambda r: -r[1])
    return len(dev), busy / 1e3, top, wall


def sdpa_yardstick(torch, F, q, k, v, mask, groups: int):
    """(ms, form) of the faster single scaled_dot_product_attention call
    over dense K/V: with K/V expanded to the query heads, and with
    ``enable_gqa=True`` where the backend takes a mask with it."""
    ke = k.repeat_interleave(groups, dim=1)
    ve = v.repeat_interleave(groups, dim=1)
    best = (device_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask)), "expanded K/V")
    del ke, ve
    try:
        ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        best = min(best, (ms, "enable_gqa"))
    except (RuntimeError, TypeError):
        pass                 # no backend takes the mask with enable_gqa
    return best


def k5_numbers(torch, F, TA, TA_REF, kv, pt: int, H: int) -> dict:
    """K5 on a serving path's cache as it stands (one layer, both pools:
    one op call each): its time, the plain version's, the SDPA yardstick
    over the same valid tokens, the bound, and device launches per call."""
    Kh, D = kv.fast_k.shape[-2], kv.fast_k.shape[-1]
    B = kv.fast_k.shape[1]
    Mf, Ms = kv.fast_page.shape[1], kv.slow_page.shape[1]
    q = torch.randn((B, H, D), device="cuda").to(torch.bfloat16)
    pools = (kv.fast_k[0], kv.fast_v[0], kv.slow_k[0], kv.slow_v[0])
    n_valid = (valid_tokens(torch, kv.fast_page, kv.seq_len, pt)
               + valid_tokens(torch, kv.slow_page, kv.seq_len, pt))
    qs, ks, vs, mask = sdpa_inputs(torch, q, pools,
                                   (kv.fast_page, kv.slow_page), kv.seq_len,
                                   pt)

    def pair(partial):
        return lambda: (partial(q, pools[0], pools[1], kv.fast_page,
                                kv.seq_len),
                        partial(q, pools[2], pools[3], kv.slow_page,
                                kv.seq_len))

    elem = kv.fast_k.element_size()
    nbytes = (n_valid * Kh * D * elem * 2 + B * H * D * elem
              + B * (Mf + Ms) * 4 + B * 4
              + 2 * (B * H * D * 4 + 2 * B * H * 4) + B * H * (Mf + Ms) * 4)
    nops = n_valid * H * D * 4
    lib_ms, lib_form = sdpa_yardstick(torch, F, qs, ks, vs, mask, H // Kh)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return dict(ms=device_ms(pair(TA.pool_attention_partial)),
                plain_ms=device_ms(pair(TA_REF.pool_attention_partial_ref)),
                library_ms=lib_ms, library_form=lib_form,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, n_valid=n_valid)


def k6_numbers(torch, np, KMIG, RMIG, kv, seed: int, n_sel: int = 16
               ) -> dict:
    """K6 on a serving path's cache (all its layers), moving the pages of
    ``n_sel`` sequences from the fast to the slow pools: first held bitwise
    against the plain version on copies of the run's own destination pools
    (one pool, then K+V), then one pool (the single-pool op) with its plain
    and library (``index_copy_`` of the gathered pages) times, and K+V in
    one launch (what the tiering step calls). Bound: each page read once
    and written once, plus the indices."""
    L, B, Mf = kv.fast_k.shape[:3]
    Ms = kv.slow_k.shape[2]
    rng = np.random.default_rng(seed)
    sel = torch.zeros(B, dtype=torch.bool, device="cuda")
    sel[torch.as_tensor(rng.permutation(B)[:n_sel], device="cuda")] = True
    # int64 indices and a bool mask, as the tiering step passes them
    si = torch.as_tensor(rng.integers(0, Mf, B), device="cuda")
    di = torch.as_tensor(rng.integers(0, Ms, B), device="cuda")
    # the kernel writes the run's own pools (spent: only timed from here),
    # the plain version copies of them
    want = RMIG.migrate_pages_ref(kv.fast_k, kv.slow_k.clone(), si, di, sel)
    require(torch.equal(KMIG.migrate_pages(kv.fast_k, kv.slow_k, si, di,
                                           sel), want),
            f"K6 on the run's pools {_shape(kv.slow_k)}: kernel != plain")
    want = RMIG.migrate_pages_kv_ref(kv.fast_k, kv.slow_k.clone(), kv.fast_v,
                                     kv.slow_v.clone(), si, di, sel)
    got = KMIG.migrate_pages_kv(kv.fast_k, kv.slow_k, kv.fast_v, kv.slow_v,
                                si, di, sel)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"K6 K+V on the run's pools {_shape(kv.slow_k)}: kernel != plain")
    del want, got
    page_elems = kv.fast_k[0, 0, 0].numel()
    sel_b = sel.nonzero()[:, 0]
    lay = torch.arange(L, device="cuda")[:, None]
    src_rows = ((lay * B + sel_b) * Mf + si[sel_b]).reshape(-1)
    dst_rows = ((lay * B + sel_b) * Ms + di[sel_b]).reshape(-1)
    gathered = kv.fast_k.view(-1, page_elems).index_select(0, src_rows)
    slow_flat = kv.slow_k.view(-1, page_elems)
    one = n_sel * L * page_elems * kv.fast_k.element_size() * 2
    nb, nb_kv = one + 3 * B * 4, 2 * one + 3 * B * 4
    pools = (kv.fast_k, kv.slow_k, kv.fast_v, kv.slow_v)
    return dict(
        ms=device_ms(lambda: KMIG.migrate_pages(kv.fast_k, kv.slow_k, si, di,
                                                sel)),
        plain_ms=device_ms(lambda: RMIG.migrate_pages_ref(
            kv.fast_k, kv.slow_k, si, di, sel)),
        library_ms=device_ms(lambda: slow_flat.index_copy_(0, dst_rows,
                                                           gathered)),
        bound_ms=nb / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nb,
        n_sel=n_sel,
        kv=dict(ms=device_ms(lambda: KMIG.migrate_pages_kv(*pools, si, di,
                                                           sel)),
                plain_ms=device_ms(lambda: RMIG.migrate_pages_kv_ref(
                    *pools, si, di, sel)),
                bound_ms=nb_kv / HBM_BYTES_PER_S * 1e3, bytes=nb_kv))


def profile_serve_step(torch, step, model, snap, tok):
    """Wall ms (median of 3, synchronised) of one decode step from the
    snapshot ``snap``, and its device events under torch.profiler."""
    walls = []
    with torch.no_grad():
        for _ in range(3):
            s0 = clone_state(torch, snap)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, s0, tok)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        s0 = clone_state(torch, snap)
        torch.cuda.synchronize()
        prof = profile_fn(torch, lambda: step(model, s0, tok))
    return sorted(walls)[1], prof


# ---------------------------------------------------------- phase 13 ----
def k7_routes(FA, fn):
    """(fn's result, the K7 launches it made by route, as the launcher
    reports them: "wgmma" or "tf32x3")."""
    before = dict(FA.flash_attention.routes)
    out = fn()
    return out, {r: n - before[r] for r, n in FA.flash_attention.routes.items()}


def one_route(counts: dict, what: str) -> str:
    """The route of a single K7 launch, from ``k7_routes``' counts."""
    require(sum(counts.values()) == 1, f"{what}: K7 launches {counts}")
    return next(r for r, n in counts.items() if n)


def check_prefill_kernels(torch, np, FA, FA_REF, SSD, SSD_REF):
    """K7 and K8 wrappers vs their plain versions on the card at the prefill
    path's widths. Returns (max abs error, cases) per kernel; cases also
    holds K7's launches by route ("k7_routes")."""
    rng = np.random.default_rng(13)
    err = {k: 0.0 for k in PREFILL_REPLACES}
    cases = {k: 0 for k in PREFILL_REPLACES}
    cases["k7_routes"] = {r: 0 for r in FA.flash_attention.routes}
    # (H, K, D): zamba2's heads (G=1, D=112), llama's (G=4, D=64), D=128 at
    # G=1 and G=4, then h2o-danube's (G=4, D=120: 8 k-steps, the last half
    # the TMA's zeros). (B, Sq, Skv, v scale): 200 and 300/333 are not
    # multiples of the 128-row tiles, 256/1024 and 300/333 have Sq < Skv;
    # v x 64 holds the tensor-core kernels' P V to the plain version's
    # float32 where |v| is large, as on the Llama path (f32 at an atol of
    # K7_TOL x 64, its rtol K7_TOL). Each case runs again
    # on strided [B, S, H, D] views and must read the same. bf16 must take
    # the wgmma kernel, f32 the tf32x3 kernel (the route the launcher
    # reports); so must a bf16 view 2 bytes off 16-byte alignment, which the
    # TMA refuses (once per head shape, the first lengths).
    for H, K, D in ((32, 32, 112), (32, 8, 64), (8, 8, 128), (16, 4, 128),
                    (32, 8, 120)):
        for B, Sq, Skv, vs in ((2, 1024, 1024, 1.0), (1, 200, 200, 1.0),
                               (2, 256, 1024, 1.0), (1, 300, 333, 1.0),
                               (2, 1024, 1024, 64.0)):
            qkv = [torch.as_tensor(rng.standard_normal(shape).astype(
                np.float32), device="cuda") for shape in
                ((B, H, Sq, D), (B, K, Skv, D), (B, K, Skv, D))]
            qkv[2] *= vs
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (x.to(dtype) for x in qkv)
                views = [x.transpose(1, 2).contiguous().transpose(1, 2)
                         for x in (q, k, v)]
                for causal, window in ((True, None), (True, 64),
                                       (False, None)):
                    got, rc = k7_routes(FA, lambda: FA.flash_attention(
                        q, k, v, causal=causal, window=window))
                    route = one_route(rc, f"K7 H={H} D={D} {dtype}")
                    require(route == ("wgmma" if dtype == torch.bfloat16
                                      else "tf32x3"),
                            f"K7 H={H} K={K} D={D} {dtype}: route {route}")
                    cases["k7_routes"][route] += 1
                    want = FA_REF.flash_attention_ref(q, k, v, causal=causal,
                                                      window=window)
                    require(got.dtype == dtype and bool(
                        torch.isfinite(got).all()), "K7: dtype / finite")
                    d = float((got.float() - want.float()).abs().max())
                    tol = K7_TOL[str(dtype).removeprefix("torch.")]
                    # f32: the absolute bound grows with |v| (3xTF32 keeps
                    # 22 significant bits of p; one TF32 p misses it)
                    atol = tol * vs if dtype == torch.float32 else tol
                    err["flash_attention"] = max(err["flash_attention"], d)
                    what = (f"K7 H={H} K={K} D={D} B={B} Sq={Sq} Skv={Skv} "
                            f"v x{vs} {dtype} causal={causal} window="
                            f"{window}")
                    require(torch.allclose(got.float(), want.float(),
                                           atol=atol, rtol=tol),
                            f"{what}: max err {d}")
                    require(torch.equal(FA.flash_attention(
                        *views, causal=causal, window=window), got),
                        f"{what}: strided views read otherwise")
                    cases["flash_attention"] += 1
        # bf16 read 2 bytes off alignment: columns 1 .. D of a D + 8 wide
        # tensor (D of 112, 64, 128, 128, 120), refused by the TMA
        B, Sq, Skv = 1, 200, 200
        rng_u = np.random.default_rng(130 + D)
        wide = [torch.as_tensor(rng_u.standard_normal(shape).astype(
                    np.float32), device="cuda").to(torch.bfloat16)[..., 1:D + 1]
                for shape in ((B, H, Sq, D + 8), (B, K, Skv, D + 8),
                              (B, K, Skv, D + 8))]
        require(wide[0].data_ptr() % 16 == 2, "K7: unaligned view")
        for causal, window in ((True, None), (True, 64), (False, None)):
            got, rc = k7_routes(FA, lambda: FA.flash_attention(
                *wide, causal=causal, window=window))
            route = one_route(rc, f"K7 H={H} D={D} unaligned bf16")
            require(route == "tf32x3", f"K7 H={H} K={K} D={D} unaligned bf16:"
                                       f" route {route}")
            cases["k7_routes"][route] += 1
            want = FA_REF.flash_attention_ref(*wide, causal=causal,
                                              window=window)
            d = float((got.float() - want.float()).abs().max())
            err["flash_attention"] = max(err["flash_attention"], d)
            require(torch.allclose(got.float(), want.float(),
                                   atol=K7_TOL["bfloat16"],
                                   rtol=K7_TOL["bfloat16"]),
                    f"K7 H={H} K={K} D={D} unaligned bf16 causal={causal} "
                    f"window={window}: max err {d}")
            cases["flash_attention"] += 1
    # (H, P, N, G): zamba2's Mamba2 widths, then mamba2-130m's
    for H, P, N, G in ((112, 64, 64, 1), (32, 48, 128, 1)):
        B, S, Q = 1, 1024, 256
        z = rng.standard_normal((B, S, H))
        x = torch.as_tensor((rng.standard_normal((B, S, H, P)) * 0.5
                             ).astype(np.float32), device="cuda")
        bc = [torch.as_tensor((rng.standard_normal((B, S, G, N)) * 0.5
                               ).astype(np.float32), device="cuda")
              for _ in range(2)]
        for decay, a_np in (("init", -np.logaddexp(z * 1.2, 0.0)),
                            ("strong", -np.abs(z) * 8.0)):
            a = torch.as_tensor(a_np.astype(np.float32), device="cuda")
            for dtype in (torch.bfloat16, torch.float32):
                b, c = (t.to(dtype) for t in bc)
                y, h = SSD.ssd_scan(x, a, b, c, chunk=Q)
                y_r, h_r = SSD_REF.ssd_scan_ref(x, a, b, c, Q)
                for g, w in ((y, y_r), (h, h_r)):
                    require(bool(torch.isfinite(g).all()), "K8: non-finite")
                    d = float((g - w).abs().max())
                    err["ssd_scan"] = max(err["ssd_scan"], d)
                    require(torch.allclose(g, w, atol=K8_ATOL, rtol=K8_RTOL),
                            f"K8 H={H} P={P} N={N} {decay} {dtype}: max err "
                            f"{d}")
                cases["ssd_scan"] += 1
    torch.cuda.synchronize()
    return err, cases


# ---------------------------------------------------------- phase 14 ----
def reading(torch, what: str, got, want, atol: float, rtol: float) -> dict:
    """Max abs error of ``got`` vs ``want`` (in float32, or float64 when
    ``want`` is) and the largest share of the allclose bound ``atol + rtol *
    |want|`` it uses (<= 1 passes)."""
    wide = torch.float64 if want.dtype == torch.float64 else torch.float32
    d = (got.to(wide) - want.to(wide)).abs()
    share = float((d / (atol + rtol * want.to(wide).abs())).max())
    return dict(what=what, err=float(d.max()), share=share, atol=atol,
                rtol=rtol)


def _shape(t) -> str:
    return f"{tuple(t.shape)}/{t.stride()} {str(t.dtype)[6:]}"


def attention_f64(torch, q, k, v, *, causal=True, window=None):
    """The plain version's attention (GQA, right-aligned queries, the finite
    NEG_INF on masked scores) computed in float64, a few heads at a time."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    step = max(1, (1 << 30) // (sq * skv * 8))          # 1 GiB of scores
    for bi in range(b):
        for h0 in range(0, h, step):
            heads = torch.arange(h0, min(h, h0 + step), device=q.device)
            kv = heads // (h // kh)
            s = torch.einsum("hqd,hkd->hqk", q[bi, heads].double()
                             / math.sqrt(d), k[bi, kv].double())
            s = torch.where(mask, s, -1e30)
            out[bi, heads] = torch.einsum("hqk,hkd->hqd", torch.softmax(
                s, dim=-1), v[bi, kv].double())
    return out


def k7_vs_plain(torch, FA_REF, out, q, k, v, *, causal=True, window=None,
                impl="cuda", tail=None, scaled=False) -> list:
    """K7's output on the path vs the plain version on the same views; with
    ``tail``, only the last ``tail`` query rows (right-aligned, they see the
    same keys). The bound is ``K7_TOL`` elementwise (atol and rtol), or with
    ``scaled`` ``K7_TOL`` of the output's max |value| (phases 28-30).

    In float32 the reference is the same attention in float64, and the
    plain version's own largest distance from it is added to atol. On
    random weights the path's float32 scores reach hundreds (Llama 3.2 1B's
    layer 0: |s| up to 816), where one ulp of a score moves p by ~6e-5: the
    plain version is then itself ~100x K7_TOL from the float64 value, and
    any other float32 summation order (its own with the head dim reversed,
    f32 SDPA) as far from it, so an elementwise bound against it holds only
    a kernel that repeats its rounding order. Where the plain version is
    near the float64 value, this is the elementwise bound."""
    if tail is not None and tail < q.shape[2]:
        q, out = q[:, :, -tail:], out[:, :, -tail:]
    want = FA_REF.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = K7_TOL[str(q.dtype)[6:]]
    what = (f"K7 q {_shape(q)} k {_shape(k)} causal={causal} window="
            f"{window} max |v| {float(v.abs().max()):.3g}")
    plain_err = 0.0
    if q.dtype == torch.float32:
        exact = attention_f64(torch, q, k, v, causal=causal, window=window)
        plain_err = float((want.double() - exact).abs().max())
        what += f" (vs float64; the plain version {plain_err:.3g} from it)"
        want = exact
    atol, rtol = (tol * float(want.abs().max()), 0.0) if scaled else (tol,
                                                                      tol)
    return [reading(torch, what, out, want, atol + plain_err, rtol)]


def k8_vs_plain(torch, SSD_REF, out, x, a, b, c, *, chunk, impl="cuda"
                ) -> list:
    """K8's (y, h) on the path vs the plain version on the same tensors."""
    y_r, h_r = SSD_REF.ssd_scan_ref(x, a, b, c, chunk)
    what = f"K8 x {_shape(x)} b {_shape(b)} chunk {chunk}"
    return [reading(torch, f"{what} y", out[0], y_r, K8_ATOL, K8_RTOL),
            reading(torch, f"{what} h", out[1], h_r, K8_ATOL, K8_RTOL)]


@contextlib.contextmanager
def on_path(mod, name: str, compare, found: list, label: str,
            every: int = 0, kind=None):
    """While active, the first ``impl="cuda"`` call of ``mod.name`` on a card
    tensor (with ``every``, also each ``every``-th such call after it; with
    ``kind(*args, **kwargs)``, the first call of each kind) is held
    against its plain version by ``compare(out, *args, **kwargs)``; its
    readings go to ``found``, tagged ``label``. The path's own output
    stands for the kernel's, so the check launches nothing. The op counts
    its launches on the module's global of its name, the hook while it is
    active; the count is carried over both ways."""
    orig = getattr(mod, name)
    calls = [0]
    kinds: set = set()

    def hooked(*args, **kwargs):
        out = orig(*args, **kwargs)
        if kwargs.get("impl", "cuda") == "cuda" and args[0].is_cuda:
            n = calls[0]
            calls[0] += 1
            new = kind is not None and kind(*args, **kwargs) not in kinds
            if new:
                kinds.add(kind(*args, **kwargs))
            if new or (kind is None and n == 0) or (every and n % every
                                                    == 0):
                found.extend(dict(r, label=label)
                             for r in compare(out, *args, **kwargs))
        return out

    hooked.launches = orig.launches
    setattr(mod, name, hooked)
    try:
        yield
    finally:
        setattr(mod, name, orig)
        orig.launches = hooked.launches


@contextlib.contextmanager
def k6_on_path(torch, KMIG, RMIG, held: list, label: str):
    """While active, every card call of ``migrate_pages_kv`` (the tiering
    step's page moves) that moves a page is held bitwise against the plain
    version on the path's own tensors: the plain copy runs first on copies
    of the destination pools. Appends the pages moved by each held call to
    ``held``."""
    def make(orig):
        def hooked(src_k, dst_k, src_v, dst_v, si, di, sel):
            if not (dst_k.is_cuda and bool(sel.any())):
                return orig(src_k, dst_k, src_v, dst_v, si, di, sel)
            want = RMIG.migrate_pages_kv_ref(src_k, dst_k.clone(), src_v,
                                             dst_v.clone(), si, di, sel)
            got = orig(src_k, dst_k, src_v, dst_v, si, di, sel)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{label}: K6 on the path (call {len(held)}, "
                    f"{int(sel.sum())} pages, pools {_shape(dst_k)}): "
                    "kernel != plain")
            held.append(int(sel.sum()))
            return got
        return hooked

    with patched(KMIG, "migrate_pages_kv", make):
        yield


def prefill_agree(torch, make_prefill_step, model, toks, tol: float,
                  LAYERS, extra=None, layered: bool = False) -> tuple:
    """Last-position logits of ``make_prefill_step`` with impl "cuda" and
    "ref" on the same model and tokens; raises unless finite and within
    ``tol`` of max |logit|, where a moe model's expert routing (top-k and
    capacity) agrees in every layer. Returns (the relative error, the
    routing decisions that differ per moe layer, [] without moe)."""
    cfg = model.cfg
    outs, calls = {}, {"cuda": [], "ref": []}
    for impl in ("cuda", "ref"):
        with moe_inputs(LAYERS, calls[impl]):
            outs[impl] = make_prefill_step(cfg, impl=impl)(
                model, {"tokens": toks, **(extra or {})})
    got, want = outs["cuda"], outs["ref"]
    require(got.shape == (toks.shape[0], cfg.vocab_size), "prefill shape")
    require(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite")
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    routed = route_diff(torch, *(moe_routes(torch, LAYERS, cfg, calls[i])
                                 for i in ("cuda", "ref")))
    require(rel <= tol or any(routed) or layered, f"{cfg.name} {cfg.dtype} "
            f"prefill: cuda vs ref {rel:.3g} > {tol} with the expert routing "
            "equal")
    return rel, routed


def time_prefill(torch, step, model, toks, extra=None):
    """(warm-up ms, ms, peak GiB) of two prefills (CUDA events) of the batch
    ``toks`` (and ``extra``'s encoder input); the second is the
    measurement, its peak memory from a reset."""
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits = step(model, {"tokens": toks, **(extra or {})})
        e.record()
        torch.cuda.synchronize()
        require(bool(torch.isfinite(logits).all()), "prefill: non-finite")
        out.append(s.elapsed_time(e))
    return out[0], out[1], torch.cuda.max_memory_allocated() / 2**30


def with_dtype(model, dtype: str):
    """A view of ``model`` whose config computes in ``dtype``, sharing the
    (float32) weights."""
    import copy
    import dataclasses
    m = copy.copy(model)
    m.cfg = dataclasses.replace(model.cfg, dtype=dtype)
    return m


# ---------------------------------------------------------- phase 19 ----
def churn_golden_run(name: str, impl: str, device="cuda"):
    """The reference's churn golden scenarios (tests/test_golden_trace.py
    ``_churn_small``, ``_churn16_sketch``) through the port's
    ``simulate_churn``."""
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core import simulator as SIM
    from repro_torch.core import workloads as W
    if name == "churn_small":
        slots = [W.ChurnSlot(W.web_like(40), [(0, 80)]),
                 W.ChurnSlot(W.microbenchmark(32, ramp=3),
                             [(4, 30), (40, 70)]),
                 *W.serverless_bursts(2, 80, footprint=24, seed=3)]
        cfg = TieringConfig(n_tenants=4, n_fast_pages=64, n_slow_pages=120,
                            lower_protection=(16, 8, 0, 0),
                            upper_bound=(0, 24, 0, 0))
        return SIM.simulate_churn(cfg, slots, 80, k_max=32, impl=impl,
                                  device=device)
    cfg, slots = SIM.CHURN_PRESETS["churn16"]()
    return SIM.simulate_churn(cfg.with_(n_tenants=len(slots)), slots, 100,
                              k_max=64, hotness="sketch", impl=impl,
                              device=device)


# ---------------------------------------------------------- phase 20 ----
def h1_roster(ticks: int, seeds=(0, 1)):
    """H1's 64 slots: 24 stable (web/cache alternating, 3,840-4,352 pages,
    arriving over the first 8 ticks), 24 Poisson-churned and 16 serverless
    slots of 2,048 pages, from the port's generators; the churned slots
    are drawn from ``seeds`` (H1 itself is (0, 1))."""
    from repro_torch.core import workloads as W
    stable = [W.ChurnSlot((W.web_like, W.cache_like)[i % 2](
        3840 + 256 * (i % 3)), [(i % 8, ticks)]) for i in range(24)]
    return (stable
            + W.poisson_churn(24, ticks, base_footprint=2048, seed=seeds[0])
            + W.serverless_bursts(16, ticks, footprint=2048, seed=seeds[1]))


def churn_lockstep(torch, cfg, sched, impls, ticks: int, hotness=None,
                   k_max: int = K_MAX, keep_at=None):
    """The dynamic-ownership tick of each impl in turns, tick by tick, from
    the same all-free pool. After every tick each impl's outputs and state
    are held against the first's (ints bitwise, floats rtol 1e-5), and
    conservation is checked: fast + slow + free == L, departed slots own
    nothing. Returns ({impl: [tick ms]}, {impl: [TickOutput]}, float state
    leaves that were not bitwise, and (tick, state, inputs) of the first
    impl's tick ``keep_at``, to profile it again)."""
    from repro_torch.core.churn import make_churn_tick
    from repro_torch.core.state import init_state
    L = cfg.n_fast_pages + cfg.n_slow_pages
    tick = {i: make_churn_tick(cfg, L, k_max=k_max, hotness=hotness, impl=i,
                               device="cuda") for i in impls}
    state = {i: init_state(cfg, L, device="cuda", hotness=hotness)
             for i in impls}
    rates = torch.as_tensor(sched.rates[:ticks], device="cuda")
    want = torch.as_tensor(sched.want[:ticks], device="cuda")
    ms = {i: [] for i in impls}
    outs = {i: [] for i in impls}
    inexact, kept = set(), None
    for t in range(ticks):
        inp = (rates[t], want[t])
        if t == keep_at:
            kept = (tick[impls[0]], state[impls[0]], inp)
        for i in impls:
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            state[i], out = tick[i](state[i], inp)
            e.record()
            torch.cuda.synchronize()
            ms[i].append(s.elapsed_time(e))
            outs[i].append(out)
        a = impls[0]
        for i in impls[1:]:
            compare_runs(torch, state[a], outs[a][-1], state[i], outs[i][-1],
                         f"tick {t} {a} vs {i}")
            for k, v in state_leaves(state[a]).items():
                if torch.is_tensor(v) and v.is_floating_point() and \
                        not torch.equal(v, state_leaves(state[i])[k]):
                    inexact.add(k)
        o = outs[a][-1]
        owned = o.fast_usage + o.slow_usage
        require(int(owned.sum() + o.pool_free) == L,
                f"tick {t}: fast + slow + free != L")
        require(not bool(owned[want[t] == 0].any()),
                f"tick {t}: a departed slot owns pages")
    return ms, outs, sorted(inexact), kept


def ms_summary(v) -> str:
    v = sorted(v)
    return f"median {v[len(v) // 2]:.3f} ({v[0]:.3f}-{v[-1]:.3f})"


# ------------------------------------------------------ phases 19-22 ----
def earlier_topk(torch, lib, k: int):
    """K1 as its earlier design computes it (``EARLIER_TOPK_SOURCE``, built
    with ``build_variant``), called as the port's wrapper calls its
    kernel: outputs allocated on each call, launched on the current
    stream."""
    import ctypes
    fn = lib.seg_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int

    def run(score, valid, quotas):
        T, S = score.shape
        dev = score.device
        cols = torch.empty((T, k), dtype=torch.int32, device=dev)
        take = torch.empty((T, k), dtype=torch.bool, device=dev)
        counts = torch.empty((T,), dtype=torch.int32, device=dev)
        err = fn(score.data_ptr(), valid.data_ptr(), quotas.data_ptr(), T, S,
                 k, cols.data_ptr(), take.data_ptr(), counts.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"K1's earlier design: CUDA error {err}")
        return cols, take, counts

    return run


def churn_phases(torch, np, rows: list, floor_ms: float,
                 earlier_lib) -> None:
    """Phases 19-22: dynamic ownership and the hotness providers on the
    card; appends K1's dynamic-width entry to ``rows``, timed beside its
    earlier design (``earlier_lib``, a ``build_variant`` build of
    ``EARLIER_TOPK_SOURCE``)."""
    from repro_torch.core import simulator as SIM
    from repro_torch.core.churn import churn_events
    from repro_torch.core.engine import run_engine
    from repro_torch.core.workloads import build_churn_schedule, build_trace
    from repro_torch.kernels.migrate import ops as KMIG
    from repro_torch.kernels.select import ops as KSEL
    wrappers = {"seg_topk": KSEL.seg_topk, "seg_reduce": KSEL.seg_reduce,
                "seg_sums": KSEL.seg_sums, "commit_moves": KMIG.commit_moves}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        for r in KSEL.seg_topk.routes:      # in place: the launcher's dict
            KSEL.seg_topk.routes[r] = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    # ---- 19. dynamic ownership: the churn goldens ---------------------------
    # under the sketch every selection is a running count over its buffers
    # and the dynamic strategy has no move kernel: no kernel of the tick
    # runs there, and the golden holds the rest of the cuda path
    gold = []
    for name in ("churn_small", "churn16_sketch"):
        reset_counts()
        r = churn_golden_run(name, "cuda")
        counts = read_counts()
        if name == "churn_small":
            require(counts["seg_topk"] > 0, f"{name}: K1 never launched")
        want = json.loads((GOLDEN.parent / f"{name}.json").read_text())
        got = collect(r)
        require(sorted(want) == sorted(got), f"{name}: key set drifted")
        for key in sorted(want):
            diff(got[key], want[key], f"{name}.{key}")
        gold.append(f"{name} ({len(r.migrations)} ring events, launches "
                    f"{counts})")
    phase("19-churn-golden", "impl=cuda reproduces " + ", ".join(gold))

    # ---- 20. H1: a churned host of C1's size, three impls ---------------
    h1_slots = h1_roster(H1_TICKS)
    h1_cfg = SIM.churn_roster_config(h1_slots)
    h1_sched = build_churn_schedule(h1_slots, H1_TICKS)
    L1 = h1_cfg.n_fast_pages + h1_cfg.n_slow_pages
    arrivals, departures = churn_events(h1_sched.want)
    reset_counts()
    h1_ms, h1_outs, h1_inexact, kept = churn_lockstep(
        torch, h1_cfg, h1_sched, CHURN_IMPLS, H1_TICKS, keep_at=H1_TICKS // 2)
    h1_launches = read_counts()
    require(h1_launches["seg_topk"] > 0, "H1: K1 never launched")
    h1_routes = dict(KSEL.seg_topk.routes)
    require(h1_routes == {"staged": 0, "long": h1_launches["seg_topk"]},
            f"H1: K1's routes {h1_routes}, want all long (S = L)")
    o = h1_outs["cuda"]
    h1_moves = (int(sum(int(x.promotions.sum()) for x in o)),
                int(sum(int(x.demotions.sum()) for x in o)))
    require(h1_moves[0] > 0 and h1_moves[1] > 0, "H1: no migrations")
    phase("20-churn-host", f"H1 T={h1_cfg.n_tenants} L={L1} (fast "
          f"{h1_cfg.n_fast_pages}, S={h1_sched.rates.shape[2]}) equilibria "
          f"{H1_TICKS} ticks, {arrivals} arrivals {departures} departures, "
          f"peak demand {int(h1_sched.want.sum(1).max())}: cuda == ref == "
          f"batched (ints bitwise every tick, floats rtol 1e-5; float state "
          f"not bitwise: {h1_inexact or 'none'}), conservation every tick; "
          f"promotions {h1_moves[0]} demotions {h1_moves[1]}; launches "
          f"{h1_launches} ({h1_launches['seg_topk'] / H1_TICKS:g} K1 a "
          f"tick, by route {h1_routes}); tick ms (CUDA events) " + "; ".join(
              f"{i} {ms_summary(v)}" for i, v in h1_ms.items()))
    h1_tick_ms = sorted(h1_ms["cuda"])[H1_TICKS // 2]
    h1_prof = profile_fn(torch, lambda: kept[0](kept[1], kept[2]))
    del kept
    if h1_prof is None:
        phase("20-churn-profile", "device time not measured: the profiler "
                                  "saw no device event")
    else:
        n_dev, busy_ms, top, pwall = h1_prof
        k1 = [(t, c) for nm, t, c in top if "seg_topk" in nm]   # either route
        phase("20-churn-profile", f"impl=cuda tick {H1_TICKS // 2}: {n_dev} "
              f"device events, busy {busy_ms:.4f} ms of {h1_tick_ms:.4f} ms "
              f"(median tick; idle share {1 - busy_ms / h1_tick_ms:.3f}; "
              f"profiled wall {pwall:.3f} ms); K1 "
              f"{sum(t for t, _ in k1):.4f} ms x{sum(c for _, c in k1)}; "
              "top by device ms: " + "; ".join(
                  f"{nm[:60]} {t:.4f} ms x{c}" for nm, t, c in top[:10]))

    # ---- 21. hotness providers on H1; non-contiguous stacked64 -------------
    hot_res = []
    for hotness in ("sampled", "sketch", "neomem"):
        hms, houts, hinexact, _ = churn_lockstep(
            torch, h1_cfg, h1_sched, ("cuda", "ref"), H1_HOT_TICKS,
            hotness=hotness)
        moves = sum(int(x.promotions.sum() + x.demotions.sum())
                    for x in houts["cuda"])
        require(moves > 0, f"H1 {hotness}: no migrations")
        hot_res.append(f"{hotness}: {moves} moves, float state not bitwise "
                       f"{hinexact or 'none'}, tick ms " + ", ".join(
                           f"{i} {ms_summary(v)}" for i, v in hms.items()))
    phase("21-hotness-host", f"H1 {H1_HOT_TICKS} ticks, cuda == ref (ints "
          "bitwise every tick; sketch probe 4096 over 64 slots = 64 lanes a "
          f"slot of S={h1_sched.rates.shape[2]}: threefry draws): "
          + " | ".join(hot_res))
    p_cfg, p_tenants = SIM.PRESETS["stacked64"]()
    p_owner, p_acc, p_alive = build_trace(p_tenants, PERMUTED_TICKS)
    perm = np.random.default_rng(64).permutation(p_owner.shape[0])
    p_runs = {impl: run_engine(p_cfg, p_owner[perm], p_acc[:, perm],
                               p_alive[:, perm], mode="equilibria",
                               k_max=128, impl=impl, device="cuda")
              for impl in CHURN_IMPLS}
    for impl in CHURN_IMPLS[1:]:
        compare_runs(torch, *p_runs["cuda"], *p_runs[impl],
                     f"stacked64 permuted cuda vs {impl}")
    p_out = p_runs["cuda"][1]
    phase("21-permuted", f"stacked64 owner permuted (L={p_owner.shape[0]}) "
          f"{PERMUTED_TICKS} ticks: cuda == ref == batched; promotions "
          f"{int(p_out.promotions.sum())} demotions "
          f"{int(p_out.demotions.sum())}")
    del p_runs, p_out

    k1_dynamic_phase(torch, rows, floor_ms, earlier_lib, h1_cfg, h1_sched,
                     h1_launches["seg_topk"])


# ------------------------------------------------------------ phase 22 ----
def k1_dynamic_phase(torch, rows: list, floor_ms: float, earlier_lib,
                     h1_cfg, h1_sched, h1_k1_launches: int) -> None:
    """Phase 22: K1 at the dynamic rowspace width, on the calls of H1's
    tick 10 (``h1_cfg``, ``h1_sched``: phase 20's host; its K1 launches
    ``h1_k1_launches``), beside its earlier design (``earlier_lib``);
    appends the ``seg_topk_dynamic`` row to ``rows``."""
    from repro_torch.core.churn import make_churn_tick
    from repro_torch.core.state import init_state
    from repro_torch.kernels.select import ops as KSEL
    from repro_torch.kernels.select import ref as RSEL
    L1 = h1_cfg.n_fast_pages + h1_cfg.n_slow_pages
    # the seg_topk calls of one moving tick of H1's cuda path (tick 10:
    # arrivals, promotions and demotions), recorded on the way in
    calls = []
    orig_topk = KSEL.seg_topk

    def recording_topk(score, valid, quotas, k):
        calls.append((score.clone(), valid.clone(), quotas.clone(), k))
        return orig_topk(score, valid, quotas, k)

    recording_topk.launches = orig_topk.launches
    KSEL.seg_topk = recording_topk
    try:
        tick = make_churn_tick(h1_cfg, L1, k_max=K_MAX, impl="cuda",
                               device="cuda")
        state = init_state(h1_cfg, L1, device="cuda")
        for t in range(11):
            calls.clear()
            state, _ = tick(state, (
                torch.as_tensor(h1_sched.rates[t], device="cuda"),
                torch.as_tensor(h1_sched.want[t], device="cuda")))
    finally:
        KSEL.seg_topk = orig_topk
        orig_topk.launches = recording_topk.launches
    del state, tick
    require(len(calls) > 0, "H1 tick 10 called no seg_topk")
    score, valid, quotas, k = max(calls, key=lambda c: int(
        c[2].clamp(min=0).sum()))
    T1, S1 = score.shape
    kk = min(k, S1)
    old = earlier_topk(torch, earlier_lib, kk)
    # the bounds, each with the quotas and the outputs: must-read (the
    # kernels line's bound), what this call's data needs: a row at quota
    # <= 0 takes nothing and is not read, every other row's valid mask is,
    # and the 64 bytes of scores behind each of its 16-lane groups that
    # holds a valid lane; and dense, every lane's score and valid byte
    active = valid[quotas > 0]
    n_active = active.shape[0]
    act16 = torch.cat([active, active.new_zeros((n_active, (-S1) % 16))], 1)
    n_groups = int(act16.view(n_active, -1, 16).any(dim=2).sum())
    out_bytes = T1 * 4 + T1 * kk * 5 + T1 * 4
    nbytes = T1 * S1 * 5 + out_bytes
    must_bytes = n_active * S1 + 64 * n_groups + out_bytes
    t_bytes = max(nbytes / HBM_BYTES_PER_S, T1 * S1 / F32_OPS_PER_S) * 1e3
    t_must = must_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_active * S1 / F32_OPS_PER_S * 1e3
    del active, act16
    res = {}
    for label, sc in (("H1", score),
                      ("tied", torch.where(valid, torch.zeros_like(score),
                                           score))):
        before = dict(KSEL.seg_topk.routes)
        got = orig_topk(sc, valid, quotas, k)
        route = [r for r, n in KSEL.seg_topk.routes.items()
                 if n != before[r]]
        require(route == ["long"], f"K1 {label}: route {route}, want long")
        plain = RSEL.seg_topk_ref(sc, valid, quotas, kk)
        for g, e, w in zip(got, old(sc, valid, quotas), plain):
            require(torch.equal(g, w), f"K1 != plain at the dynamic width "
                                       f"({label})")
            require(torch.equal(e, w), f"K1's earlier design != plain at the "
                                       f"dynamic width ({label})")
        masked = torch.where(valid, sc, float("-inf"))
        # the two designs in turns: new, earlier, earlier, new
        t_new = [device_ms(lambda: orig_topk(sc, valid, quotas, k))]
        t_old = [device_ms(lambda: old(sc, valid, quotas), n=20)]
        t_old.append(device_ms(lambda: old(sc, valid, quotas), n=20))
        t_new.append(device_ms(lambda: orig_topk(sc, valid, quotas, k)))
        res[label] = {
            "ms": sum(t_new) / 2, "new": t_new, "earlier_ms": sum(t_old) / 2,
            "old": t_old,
            "plain_ms": device_ms(lambda: RSEL.seg_topk_ref(
                sc, valid, quotas, kk), n=10),
            "topk_ms": device_ms(lambda: torch.topk(masked, kk, dim=1)),
            "sort_ms": device_ms(lambda: torch.sort(
                masked, dim=1, descending=True, stable=True), n=10),
            "winners": int(got[2].sum()),
        }
    h, tied = res["H1"], res["tied"]
    rows.append({
        "name": "seg_topk_dynamic", "kernel": "seg_topk", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES["seg_topk"],
        "launches": h1_k1_launches, "max_abs_err": 0.0,
        "ms": h["ms"], "plain_ms": h["plain_ms"],
        "bound_ms": max(t_must, t_ops),
        "bound_by": "bytes" if t_must >= t_ops else "operations",
        "bound_must_read_ms": max(t_must, t_ops), "bound_dense_ms": t_bytes,
        "library_ms": h["topk_ms"], "sort_ms": h["sort_ms"],
        "earlier_ms": h["earlier_ms"], "earlier_source": EARLIER_TOPK_SOURCE,
        "kernel_route": "long", "tied_ms": tied["ms"],
        "tied_earlier_ms": tied["earlier_ms"],
        "tied_plain_ms": tied["plain_ms"], "tied_library_ms": tied["topk_ms"],
        "width": f"T={T1} S={S1} (dynamic rowspace, S = L)", "k": kk,
        "quota_max": int(quotas.max()), "bytes": nbytes,
        "bytes_must_read": must_bytes, "valid_lanes": int(valid.sum()),
        "rows_read": n_active, "valid_groups": n_groups,
        "launch_floor_ms": floor_ms,
        "launches_per_tick": h1_k1_launches / H1_TICKS,
    })
    phase("22-kernel", f"seg_topk [T={T1} S={S1}, k={kk}, quotas max "
          f"{int(quotas.max())} sum {int(quotas.clamp(min=0).sum())} "
          f"({int((quotas <= 0).sum())} rows <= 0), {int(valid.sum())} valid "
          f"lanes, {n_groups} 16-lane groups holding one in the {n_active} "
          f"rows at quota > 0; H1 tick 10's largest call of "
          f"{len(calls)}], route long, bitwise = plain = the earlier design; "
          + "; ".join(
              f"{lb}: {r['ms']:.4f} ms (readings {r['new'][0]:.4f}, "
              f"{r['new'][1]:.4f}; earlier design {r['earlier_ms']:.4f}: "
              f"{r['old'][0]:.4f}, {r['old'][1]:.4f}; plain "
              f"{r['plain_ms']:.4f}, torch.topk {r['topk_ms']:.4f}, "
              f"torch.sort {r['sort_ms']:.4f}; {r['winners']} winners)"
              for lb, r in (("H1 call", h), ("tied copy", tied)))
          + f"; bounds: must-read {max(t_must, t_ops):.5f} ms ({must_bytes} "
          f"B), dense {t_bytes:.5f} ({nbytes} B) at 3.35 TB/s; launch floor "
          f"{floor_ms:.4f}")
    del calls, score, valid, quotas



# ------------------------------------------------------ phases 23-26 ----
FLEET_STATIC_HOSTS, FLEET_TICKS = 4, 20           # phase 23, C1's hosts
MIXED_HOSTS, MIXED_TICKS = 8, 40                  # phases 24-25, H1's hosts
ROLL_CHUNK = 16                                   # two chunks + remainder
SEAM_TICKS = 12                                   # phase 26, each variant
OBS_HOSTS, OBS_TICKS = 4, 120                     # fleet_obs --smoke


def require_same_tree(torch, a, b, what: str, skip=()) -> None:
    """Every leaf of two (host-stacked) states bitwise, floats included."""
    la, lb = ({k: v for k, v in state_leaves(x).items()
               if k.split(".")[0] not in skip} for x in (a, b))
    require(sorted(la) == sorted(lb), f"{what}: leaf sets differ")
    for k, x in la.items():
        y = lb[k]
        if torch.is_tensor(x):
            require(x.dtype == y.dtype and torch.equal(x, y),
                    f"{what}: {k} differs")
        else:
            require(x == y, f"{what}: {k} {x} != {y}")


def require_same_fleet(np, a, b, what: str) -> None:
    """Two FleetResults: every per-tick array, roster, offline pathology
    and decoded stat bitwise."""
    for f in ("fast_usage", "slow_usage", "promotions", "demotions",
              "throughput", "latency", "thrash_events", "attempted",
              "active"):
        require(np.array_equal(getattr(a, f), getattr(b, f)),
                f"{what}: FleetResult.{f} differs")
    require([[(p.kind, p.tenant, p.severity) for p in ps]
             for ps in a.pathologies] ==
            [[(p.kind, p.tenant, p.severity) for p in ps]
             for ps in b.pathologies], f"{what}: pathologies differ")
    for sa, sb in zip(a.stats, b.stats):
        for k, v in sa.items():
            require(np.array_equal(np.asarray(v), np.asarray(sb[k])),
                    f"{what}: stats {k} differ")


def fleet_phases(torch, np, wrappers: dict) -> dict:
    """Phases 23-26: the fleet (static, mixed, the chunked rollout with the
    streaming detectors and the attribution ledger), the seams' cost, the
    noisy-neighbour property, the exporters and the counterfactual
    harness, all with impl="cuda" against impl="ref". Returns each fleet
    path's kernel launches ({path: {kernel: count}})."""
    from repro_torch.core import simulator as SIM
    from repro_torch.core.churn import make_churn_tick
    from repro_torch.core.state import host_slice, init_state
    from repro_torch.core.workloads import build_churn_schedule
    from repro_torch.configs.base import TieringConfig
    from repro_torch.obs import attribution as AT
    from repro_torch.obs import export as EX
    from repro_torch.obs import fleet as FL
    from repro_torch.obs import streaming as DS
    from repro_torch.obs.counterfactual import counterfactual_run

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    launches = {}
    # ---- 23. static fleet at C1's width ------------------------------------
    cfg0 = bench_config(TieringConfig, T0, L0)
    mixes = FL.heterogeneous_mixes((L0 // T0,) * T0, FLEET_STATIC_HOSTS,
                                   seed=0)
    runs, walls = {}, {"cuda": [], "ref": []}
    for impl in ("cuda", "ref", "ref", "cuda"):       # timed in turns
        reset_counts()
        run, wall = timed(lambda: FL.run_fleet(
            cfg0, mixes, FLEET_TICKS, k_max=K_MAX, detect=True, impl=impl,
            device="cuda"))
        runs.setdefault(impl, run)
        walls[impl].append(wall)
        if impl == "cuda":
            launches["fleet_static"] = read_counts()
    for k in ("seg_topk", "seg_reduce", "seg_sums", "commit_moves"):
        require(launches["fleet_static"][k] > 0,
                f"fleet static: {k} never launched")
    a, b = runs["cuda"], runs["ref"]
    require_same_tree(torch, a._final_state, b._final_state,
                      "fleet static cuda vs ref")
    require_same_fleet(np, a, b, "fleet static cuda vs ref")
    moves = int(a.promotions.sum() + a.demotions.sum())
    require(moves > 0, "fleet static: no migrations")
    ht = FLEET_STATIC_HOSTS * FLEET_TICKS
    phase("23-fleet-static", f"run_fleet {FLEET_STATIC_HOSTS} hosts x "
          f"T={T0} L={L0} {FLEET_TICKS} ticks, detect=True: cuda == ref "
          f"(every state leaf, every FleetResult array, offline "
          f"pathologies {a.pathology_counts()}); {moves} moves; launches "
          f"{launches['fleet_static']}; host-ticks/s (call wall, trace "
          "build and detection included; cuda, ref, ref, cuda) " + ", ".join(
              f"{i} " + " / ".join(f"{ht / w:.1f} ({w:.2f} s)" for w in ws)
              for i, ws in walls.items()))
    del runs, a, b

    # ---- 24. mixed fleet at H1's width -------------------------------------
    t0 = time.perf_counter()
    churned = [h1_roster(MIXED_TICKS, (2 * h, 2 * h + 1))
               for h in range(MIXED_HOSTS // 2)]
    cfg1 = SIM.churn_roster_config(churned[0])
    L1 = cfg1.n_fast_pages + cfg1.n_slow_pages
    static = FL.heterogeneous_mixes((L1 // T0 - 1,) * T0, MIXED_HOSTS // 2,
                                    seed=1)
    hosts = FL.mixed_fleet_hosts(static, churned, MIXED_TICKS)
    want, rates = FL.stack_schedules([build_churn_schedule(h, MIXED_TICKS)
                                      for h in hosts])
    build_s = time.perf_counter() - t0
    # conservation on every host at every tick, read off each tick's output
    seen = []
    orig = FL.make_churn_tick

    def recording_tick(*args, **kw):
        tick = orig(*args, **kw)

        def rec(state, inputs):
            state2, out = tick(state, inputs)
            seen.append(out.fast_usage.sum() + out.slow_usage.sum()
                        + out.pool_free)
            return state2, out
        return rec

    mixed, mwalls = {}, {}
    FL.make_churn_tick = recording_tick
    try:
        for impl in ("cuda", "ref"):
            seen.clear()
            reset_counts()
            mixed[impl], mwalls[impl] = timed(lambda: FL.run_mixed_fleet(
                cfg1, hosts, MIXED_TICKS, k_max=K_MAX, detect=True,
                n_pages=L1, impl=impl, device="cuda"))
            if impl == "cuda":
                launches["fleet_mixed"] = read_counts()
            owned = torch.stack(seen)
            require(owned.numel() == MIXED_HOSTS * MIXED_TICKS and
                    bool((owned == L1).all()),
                    f"fleet mixed {impl}: fast + slow + free != L")
    finally:
        FL.make_churn_tick = orig
    require(launches["fleet_mixed"]["seg_topk"] > 0,
            "fleet mixed: K1 never launched")
    a, b = mixed["cuda"], mixed["ref"]
    require_same_tree(torch, a._final_state, b._final_state,
                      "fleet mixed cuda vs ref")
    require_same_fleet(np, a, b, "fleet mixed cuda vs ref")
    require(bool((a.fast_usage + a.slow_usage)[want == 0].sum() == 0),
            "fleet mixed: a departed slot owns pages")
    ht = MIXED_HOSTS * MIXED_TICKS
    phase("24-fleet-mixed", f"run_mixed_fleet {MIXED_HOSTS} hosts "
          f"({MIXED_HOSTS // 2} static x {T0} stable slots, "
          f"{MIXED_HOSTS // 2} churned H1-style rosters) L={L1} "
          f"{MIXED_TICKS} ticks: cuda == ref (every state leaf, every "
          "FleetResult array), conservation on every host every tick; "
          f"moves {int(a.promotions.sum() + a.demotions.sum())}, offline "
          f"pathologies {a.pathology_counts()}; launches "
          f"{launches['fleet_mixed']} "
          f"({launches['fleet_mixed']['seg_topk'] / ht:g} K1 a host-tick); "
          f"schedules built in {build_s:.1f} s; host-ticks/s (call wall, "
          "transfers and detection included) " + ", ".join(
              f"{i} {ht / w:.1f} ({w:.2f} s)" for i, w in mwalls.items()))
    tick = make_churn_tick(cfg1, L1, k_max=K_MAX, impl="cuda", device="cuda")
    states = [host_slice(a._final_state, h) for h in range(MIXED_HOSTS)]
    w_d = torch.as_tensor(want[:, -1], device="cuda")
    r_d = torch.as_tensor(rates[:, -1], device="cuda")

    def fleet_tick():
        for h, st in enumerate(states):
            tick(st, (r_d[h], w_d[h]))

    fleet_tick()
    prof = profile_fn(torch, fleet_tick)
    if prof is None:
        phase("24-fleet-profile", "device time not measured: the profiler "
                                  "saw no device event")
    else:
        n_dev, busy_ms, top, pwall = prof
        k1 = [(t, c) for nm, t, c in top if "seg_topk" in nm]
        phase("24-fleet-profile", f"one fleet tick ({MIXED_HOSTS} hosts, "
              f"impl=cuda): {n_dev} device events, busy {busy_ms:.3f} ms of "
              f"{pwall:.3f} ms wall (idle share {1 - busy_ms / pwall:.3f}); "
              f"K1 {sum(t for t, _ in k1):.3f} ms x{sum(c for _, c in k1)}; "
              "top by device ms: " + "; ".join(
                  f"{nm[:50]} {t:.3f} ms x{c}" for nm, t, c in top[:6]))
    del states, tick, w_d, r_d

    # ---- 25. the chunked rollout with both seams ---------------------------
    rolls = {}
    for impl in ("cuda", "ref"):
        reset_counts()
        rolls[impl] = FL.fleet_rollout(
            cfg1, want, rates, MIXED_TICKS, k_max=K_MAX, chunk=ROLL_CHUNK,
            n_pages=L1, warmup=True, impl=impl, device="cuda")
        if impl == "cuda":
            launches["fleet_rollout"] = read_counts()
    require(launches["fleet_rollout"]["seg_topk"] > 0,
            "rollout: K1 never launched")
    ra, rb = rolls["cuda"], rolls["ref"]
    require(ra.final_state.det is not None and
            ra.final_state.attrib is not None, "rollout: seams missing")
    require_same_tree(torch, ra.final_state, rb.final_state,
                      "rollout cuda vs ref")
    for f in ("latency_mean", "throughput_mean", "migrations_per_tick"):
        require(np.array_equal(getattr(ra, f), getattr(rb, f)),
                f"rollout cuda vs ref: {f} differs")
    # the seams change no decision: outside det/attrib the rollout ends
    # where phase 24's fleet did
    require_same_tree(torch, ra.final_state, a._final_state,
                      "rollout vs mixed fleet", skip=("det", "attrib"))
    require(ra.attribution_conserved(), "rollout: ledger does not conserve")
    led = ra.ledger.total
    for f in ("attempted_promotions", "promotions", "reclaims"):
        fin = getattr(ra.final_state.counters, f).cpu().numpy()
        require(np.array_equal(getattr(led["counters"], f),
                               fin.astype(np.int64)),
                f"rollout ledger: {f} != the int32 counters")
    c = led["counters"]
    require(np.array_equal(led["att"]["total"],
                           c.attempted_promotions - c.promotions
                           + c.reclaims), "rollout: ledger totals")
    pct = ra.stall_percentiles((0.5, 0.95, 0.99))
    rup = ra.attribution_rollup()
    phase("25-rollout", f"fleet_rollout {MIXED_HOSTS} archetypes x period "
          f"{MIXED_TICKS}, chunk={ROLL_CHUNK} over {MIXED_TICKS} ticks, "
          "warmup, detect + attrib: cuda == ref (every leaf, det and attrib "
          "included; means bitwise), == phase 24 outside det/attrib; ledger "
          f"conserves on every host; stall units {rup['stall_units_total']} "
          f"by cause {rup['component_totals']}; stall p50/p95/p99 "
          f"{pct[0]:g}/{pct[1]:g}/{pct[2]:g}; pathologies "
          f"{ra.pathology_counts()}; launches {launches['fleet_rollout']}; "
          "host_ticks_per_s " + ", ".join(
              f"{i} {r.host_ticks_per_s:.1f} ({r.elapsed_s:.2f} s)"
              for i, r in rolls.items()))
    del mixed, a, b, rb

    # ---- 26. the seams' cost, the noisy-neighbour property, exporters,
    # counterfactuals ------------------------------------------------------
    h1_w, h1_r = want[MIXED_HOSTS // 2], rates[MIXED_HOSTS // 2]  # H1
    det = DS.make_detector(SEAM_TICKS * 2, T0, cfg1.lower_protection)
    att = AT.make_attribution(T0, cfg1.lat_fast)
    ticks_ = {"plain": make_churn_tick(cfg1, L1, k_max=K_MAX, impl="cuda",
                                       device="cuda"),
              "seams": make_churn_tick(cfg1, L1, k_max=K_MAX, detector=det,
                                       attrib=att, impl="cuda",
                                       device="cuda")}
    sts = {"plain": init_state(cfg1, L1, device="cuda"),
           "seams": init_state(cfg1, L1, device="cuda", detector=det,
                               attrib=att)}
    ms = {k: [] for k in ticks_}
    for t in range(SEAM_TICKS * 2):
        inp = (torch.as_tensor(h1_r[t], device="cuda"),
               torch.as_tensor(h1_w[t], device="cuda"))
        for k in (("plain", "seams") if t % 2 == 0 else ("seams", "plain")):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            sts[k], _ = ticks_[k](sts[k], inp)
            e1.record()
            torch.cuda.synchronize()
            if t >= 2:                      # the first ticks warm up
                ms[k].append(e0.elapsed_time(e1))
    require_same_tree(torch, sts["plain"], sts["seams"], "seams vs plain",
                      skip=("det", "attrib"))
    seam_ms = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    # the device side, which the host's load does not move: one more tick
    # of each under the profiler
    inp = (torch.as_tensor(h1_r[-1], device="cuda"),
           torch.as_tensor(h1_w[-1], device="cuda"))
    dev = {k: profile_fn(torch, lambda k=k: ticks_[k](sts[k], inp))
           for k in ticks_}
    del sts, ticks_
    seen_dev = ("device " + "; ".join(
        f"{k} {p[0]} events, busy {p[1]:.3f} ms" for k, p in dev.items())
        if all(dev.values()) else "device time not measured")
    phase("26-obs-seams", f"H1 cuda tick with and without detector + "
          f"attrib, alternating, {len(ms['plain'])} ticks each (CUDA "
          "events): " + "; ".join(f"{k} {ms_summary(v)}"
                                  for k, v in ms.items())
          + f"; seams add {seam_ms['seams'] - seam_ms['plain']:.3f} ms a "
          f"tick (median difference); {seen_dev}; decisions unchanged")

    # the reference's fleet_obs --smoke property
    T = 4
    foot = [160, 160] + [120] * (T - 2)
    n_fast = max(int(sum(foot) * 1.15), 256)
    cfg_o = TieringConfig(n_tenants=T, n_fast_pages=n_fast,
                          n_slow_pages=n_fast, lower_protection=(96,) * T,
                          upper_bound=(0,) * T, migration_cost=0.005)
    o_mixes = FL.heterogeneous_mixes(foot, OBS_HOSTS, seed=0)
    clean = FL.run_fleet(cfg_o, o_mixes, OBS_TICKS, device="cuda")
    noisy = FL.run_fleet(
        cfg_o.with_(upper_bound=(24,) + (0,) * (T - 1)),
        FL.inject_noisy_neighbor(o_mixes, tenant=0, fast_share=24,
                                 arrival=max(OBS_TICKS // 4, 10)),
        OBS_TICKS, device="cuda")
    require(not clean.tenants_flagged(),
            f"clean fleet flagged {clean.tenants_flagged()}")
    for kind in ("chronic_thrashing", "protection_violation"):
        flagged = {h for h, t in noisy.tenants_flagged(kind) if t == 0}
        require(len(flagged) == OBS_HOSTS,
                f"noisy fleet: {kind} flagged tenant 0 on {len(flagged)} of "
                f"{OBS_HOSTS} hosts")
    # the exporters over the rollout's telemetry
    events = {h: ra.host_migrations(h)[0] for h in range(ra.n_hosts)}
    n_trace = EX.validate_chrome_trace(json.dumps(EX.chrome_trace(
        events, t_resident=cfg1.t_resident, horizon=MIXED_TICKS)))
    n_prom = EX.validate_exposition(EX.rollout_exposition(ra))
    phase("26-obs-fleet", f"fleet_obs --smoke property ({OBS_HOSTS} hosts, "
          f"{OBS_TICKS} ticks, T={T}, thrasher from tick "
          f"{max(OBS_TICKS // 4, 10)}): noisy fleet flags tenant 0 on every "
          f"host ({noisy.pathology_counts()}), clean fleet silent; the "
          f"rollout's Chrome trace ({n_trace} events) and Prometheus "
          f"exposition ({n_prom} samples) pass the validators")
    del clean, noisy, ra, rolls

    # counterfactuals on the churn_small golden roster
    from repro_torch.core import workloads as W
    slots = [W.ChurnSlot(W.web_like(40), [(0, 80)]),
             W.ChurnSlot(W.microbenchmark(32, ramp=3), [(4, 30), (40, 70)]),
             *W.serverless_bursts(2, 80, footprint=24, seed=3)]
    cfg_c = TieringConfig(n_tenants=4, n_fast_pages=64, n_slow_pages=120,
                          lower_protection=(16, 8, 0, 0),
                          upper_bound=(0, 24, 0, 0))
    sched_c = build_churn_schedule(slots, 80)
    cf = {}
    for impl in ("cuda", "ref"):
        reset_counts()
        cf[impl] = counterfactual_run(cfg_c, sched_c, k_max=32, impl=impl,
                                      device="cuda")
        if impl == "cuda":
            launches["counterfactual"] = read_counts()
    require(launches["counterfactual"]["seg_topk"] > 0,
            "counterfactual: K1 never launched")
    require_same_tree(torch, cf["cuda"].stacked_state,
                      cf["ref"].stacked_state, "counterfactual stacked")
    require_same_tree(torch, cf["cuda"].isolated_states,
                      cf["ref"].isolated_states, "counterfactual isolated")
    require(np.array_equal(cf["cuda"].interference, cf["ref"].interference),
            "counterfactual: interference differs")
    summ = cf["cuda"].summary()
    phase("26-counterfactual", "counterfactual_run on churn_small (stacked "
          "+ 4 isolated runs): cuda == ref (every leaf of every run); "
          f"interference {np.round(summ['interference'], 4).tolist()}, "
          f"launches {launches['counterfactual']}")
    return launches


# ------------------------------------------------------ phases 27-31 ----
# the decoder-only families (slice E1/F2a), every run at full width
GRANITE, MIXTRAL, MAMBA2 = "granite_moe_3b_a800m", "mixtral_8x22b", \
    "mamba2_130m"
DENSE_ARCHS = ("h2o_danube_3_4b", "codeqwen15_7b", "qwen3_32b")
DANUBE = DENSE_ARCHS[0]                  # head dim 120: P5
# Mixtral 8x22B's 141B parameters fit no single card in any dtype: its
# full width at 8 of its 56 layers, bf16 weights (20.4B parameters)
MIXTRAL_DEPTH = 8
# granite-moe (32 layers) and the dense configs (24, 32 and 64 layers)
# run at full width and depth 8 too (``cut_depth_model``): at full depth
# their serving and prefill took 265 of the script's 1,020 s on an H100,
# and the script must end within 1,200 s on a card that may run slower.
# Page hotness is the attention mass averaged over the layers, so the
# tiering load keeps its scale at any depth
SERVE_DEPTH = 8


def cut_depth_model(arch: str, depth: int, **replace):
    """``arch`` at full width and depth ``depth`` (``reduced_depth_config``,
    then ``replace``), its stacked weights at the full model's scale. The
    init draws a stacked weight with std scale / sqrt(layers), as the
    reference does, so drawn as it is a model at depth 8 has weights up to
    sqrt(64 / 8) = 2.8x those of the full model's layers, and activations
    and scores to match: on an H100 h2o-danube's layer-0 K7 outputs reached
    114 at depth 8, where one bf16 ulp (0.5) is past K7_TOL. Every such
    weight is scaled by sqrt(depth / full depth), so each layer's weights
    have the full model's distribution."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced_depth_config
    from repro_torch.models import transformer as TF
    cfg = dataclasses.replace(reduced_depth_config(arch, depth), **replace)
    model = TF.make_model(cfg, seed=0, device="cuda")
    factor = math.sqrt(cfg.num_layers / get_config(arch).num_layers)

    def scale(specs, tree):
        for k, spec in specs.items():
            if isinstance(spec, dict):
                scale(spec, tree[k])
            elif spec.init == "normal":
                tree[k].mul_(factor)

    with torch.no_grad():
        scale(TF.model_specs(cfg)["layers"], model.layers.tree())
    return model
MOE_SIDE_STEPS = 32                      # tpp and static, granite
SSM_FWD_BATCH, SSM_FWD_STEPS = 4, 64     # mamba2 decode == forward (f32)
NEW_WINDOW = 4096                        # Mixtral's and h2o-danube's window
K5_SEQ = (4000, 6000)   # phase 31: random pools past the window's edge
# plain K7 at S=32,768 holds [B, H, tail, S] float32 scores: the tail of
# query rows it checks keeps that at 2**30 elements (4 GiB), as for
# Llama's 32 heads at PATH_TAIL
PATH_SCORES = 1 << 30
# A moe model's cuda and ref runs route some tokens to other experts
# (top-k and capacity near-ties that the kernels' float differences tip),
# and under these random weights later layers carry such a jump to every
# output (one granite step in bf16: 6.4e-3 of max |hidden| after layer 0,
# 1.1 after 32). So its end-to-end logits and hotness are held in the
# steps and prefills whose routing agrees in every layer, its integers in
# every step; and one decode step is held layer by layer, each layer fed
# the ref run's input (``moe_layer_check``): the router's input and the
# output of the tokens whose experts agree within LAYER_RTOL of the ref
# tensor's max |value|. A layer's own rounding in bf16 is one ulp, 2^-8
# (3.9e-3) of a value; the bound leaves room for the attention's and the
# experts' sums, and a wrong head group or expert moves whole values
LAYER_RTOL = 5e-2
# K5 on the path against its plain version, relative to each output's max
# |value|: the path's scores reach about 10^3 under these random weights
# (q and k elements near 7 at D=64), where float32 rounding in another
# summation order moves a score by about 1e-4 and the softmax carries that
# into every output (granite on an H100, PERF.md: 9.5e-4 absolute,
# 5x phase 8's atol of 1e-4, on outputs of order 1)
K5_PATH_RTOL = 1e-3
K5_PATH_SCORES = 1e3
SERVE_CLASSES = (("K5 tiered attention", DEVICE_KERNELS[
    "pool_attention_partial"]), ("K6 migrate_pages", ("migrate_pages",)))


def path_tail(cfg) -> int:
    """Query rows of the S=32,768 path check of ``cfg``'s K7 call."""
    return min(PATH_TAIL, PATH_SCORES // (cfg.num_heads * TIMED_S))


def class_ms(top, classes=()) -> dict:
    """Device ms and launches by kernel class: ``classes`` first, then
    phase 18's."""
    out: dict = {}
    for nm, t, cnt in top:
        cls = next((c for c, keys in classes if any(k in nm for k in keys)),
                   None) or classify(nm)
        ms0, c0 = out.get(cls, (0.0, 0))
        out[cls] = (ms0 + t, c0 + cnt)
    return out


def format_classes(by_cls: dict) -> str:
    return ", ".join(f"{k} {v[0]:.2f} x{v[1]}" for k, v in sorted(
        by_cls.items(), key=lambda kv: -kv[1][0]))


def n_parameters(model) -> int:
    return sum(p.numel() for p in model.parameters())


def k5_vs_plain(torch, TA_REF, out, q, pool_k, pool_v, slot_page, seq_len,
                *, window=None, sm_scale=None, score_scaled=False) -> list:
    """K5's (acc, m, l, mass) on the path vs the plain version on the same
    tensors, each within ``K5_PATH_RTOL`` of its own max |value|: one
    reading, the largest share of the bound over the four. With
    ``score_scaled``, the bound grows with the path's max |score| past
    ``K5_PATH_SCORES`` (``K5_PATH_RTOL`` was set at scores near 10^3; the
    float32 rounding of a score, and so of each softmax weight, grows with
    its magnitude)."""
    want = TA_REF.pool_attention_partial_ref(q, pool_k, pool_v, slot_page,
                                             seq_len, window=window,
                                             sm_scale=sm_scale)
    b, h, d = q.shape
    kh = pool_k.shape[-2]
    smax = float((torch.einsum(
        "bkgd,btkd->bkgt", q.float().reshape(b, kh, h // kh, d),
        pool_k.float().reshape(b, -1, kh, d)).abs().max()) * (
            sm_scale if sm_scale is not None else d ** -0.5))
    rtol = K5_PATH_RTOL * (max(1.0, smax / K5_PATH_SCORES) if score_scaled
                           else 1.0)
    rs = [reading(torch, "", g, w, rtol * float(w.abs().max()), 0.0)
          for g, w in zip(out, want)]
    worst = max(rs, key=lambda r: r["share"])
    return [dict(worst, what=f"K5 q {_shape(q)} pool {_shape(pool_k)} "
                             f"window={window} max |score| {smax:.4g}"
                             + (f" (bound {rtol:.3g} of each output's max "
                                "|value|)" if score_scaled else ""))]


def one_ulp(torch, x):
    """``x`` with every element moved one unit in the last place (away
    from zero)."""
    bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return (x.contiguous().view(bits) + 1).view(x.dtype)


def moe_layer_check(torch, env: dict, model, tcfg, seq: int, snap, tok,
                    tag: str) -> dict:
    """One decode step of a moe model from the snapshot ``snap``, layer by
    layer, four times: impl "ref"; "cuda" teacher-forced (every layer fed
    the ref run's input to it); "cuda" free-running; and a witness, "ref"
    with the embedding moved by one ulp. Held for every layer of the
    teacher-forced run: the router's input within ``LAYER_RTOL`` of the ref
    run's and the layer's output within ``LAYER_RTOL`` on every token whose
    experts agree, each relative to the ref tensor's max |value|; tokens
    whose experts differ are counted, with the ref run's deciding margin.
    The free-running and witness runs' divergence after each layer is
    printed: how far the model itself carries a last-bit difference."""
    SD, TF, LAYERS = env["SD"], env["TF"], env["LAYERS"]
    cfg = model.cfg
    B = tok.shape[0]

    def run(impl, feed=None, nudge=False):
        ins, outs, calls = [], [], []

        def make(orig):
            def block(p, x, *args):
                if feed is not None:
                    x = feed[len(ins)]
                elif nudge and not ins:
                    x = one_ulp(torch, x)
                ins.append(x)
                outs.append(orig(p, x, *args))
                return outs[-1]
            return block

        step = SD.build_serve_step(cfg, tcfg, B, seq, impl=impl)
        with torch.no_grad(), patched(TF, "decoder_block_decode", make), \
                moe_inputs(LAYERS, calls):
            step(model, clone_state(torch, snap), tok)
        return ins, outs, calls

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    r_in, r_out, r_calls = run("ref")
    _, t_out, t_calls = run("cuda", feed=r_in)
    free = [rel(a, b) for a, b in zip(run("cuda")[1], r_out)]
    witness = [rel(a, b) for a, b in zip(run("ref", nudge=True)[1], r_out)]
    layers = []
    for (rr, mr), (rt, _), (_, xr, _), (_, xt, _), yr, yt in zip(
            moe_routes(torch, LAYERS, cfg, r_calls),
            moe_routes(torch, LAYERS, cfg, t_calls), r_calls, t_calls,
            r_out, t_out):
        agree = (rr[0] == rt[0]).all(-1)
        d = (yt.float() - yr.float()).reshape(agree.shape[0], -1).abs()
        flips = int((~agree).sum())
        layers.append(dict(
            route_in=rel(xt, xr),
            out=float(d[agree].max() / yr.float().abs().max())
            if bool(agree.any()) else 0.0,
            flips=flips, margin=float(mr[~agree].max()) if flips else 0.0))
    worst_in = max(x["route_in"] for x in layers)
    worst_out = max(x["out"] for x in layers)
    flips = sum(x["flips"] for x in layers)
    margin = max(x["margin"] for x in layers)
    phase(f"{tag}-layers", f"one step at position {seq // 2}, each layer "
          f"fed the ref run's input: router input rel err max "
          f"{worst_in:.3g}, layer output rel err max {worst_out:.3g} on the "
          f"tokens whose experts agree (<= {LAYER_RTOL}); experts differ "
          f"for {flips} of {B * len(layers)} token-layers (largest ref "
          f"deciding margin {margin:.3g}); max |d hidden| / max |hidden| "
          "after each layer, cuda vs ref free-running: "
          + " ".join(f"{x:.1e}" for x in free) + "; witness, ref vs ref "
          "with the embedding one ulp off: "
          + " ".join(f"{x:.1e}" for x in witness))
    bad = [(n, x) for n, x in enumerate(layers)
           if max(x["route_in"], x["out"]) > LAYER_RTOL]
    require(not bad, f"{tag}: layers fed the ref run's input disagree: "
                     f"{bad[:3]}")
    return dict(route_in=worst_in, out=worst_out, flips=flips,
                margin=margin, free=free, witness=witness)


def serve_cell(torch, np, env: dict, model, *, batch: int, steps: int,
               seed: int, tag: str, side_steps: int = 0,
               profile: bool = False, need_moves: bool = False,
               cross=None, layered: bool = False,
               k5_scaled: bool = False) -> dict:
    """Phase 9's serving check at ``model``'s config: ``batch`` sequences x
    ``steps`` teacher-forced steps under ``full_load``, equilibria, impl
    "cuda" against "ref" step by step from a shared state (``check_compare``:
    integers bitwise but for near-tie flips within the deciding margin,
    logits and hotness wherever a moe model's expert routing agrees); K5's
    first call of every step and every K6 call that moves a page held
    against their plain versions on the path; a moe model's layers held one
    by one (``moe_layer_check``); tpp and static for ``side_steps`` each;
    with ``profile`` one profiled step; K5 and K6 timed on the run's own
    cache. K5 and K6 must launch, and with ``need_moves`` pages must move
    (and K6's path check must have held some). ``cross``: the encdec's or
    vlm's precomputed cross K/V, copied into each run's initial state; for
    these families one step is also held block by block
    (``serve_layer_check``), and with ``layered`` the end-to-end logits
    and hotness are printed beside the one-ulp witness but held only
    through that check. ``k5_scaled``: K5's path bound grows with the
    path's scores (``k5_vs_plain``). Returns the run's numbers."""
    F, SD, TA, TA_REF = env["F"], env["SD"], env["TA"], env["TA_REF"]
    KMIG, RMIG, swrap = env["KMIG"], env["RMIG"], env["swrap"]
    cfg = model.cfg
    tcfg = env["full_load"](cfg, batch, steps)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, steps)).astype(np.int32), device="cuda")
    rec: dict = {}
    kv_step = SD.equilibria_kv_step

    def recording_kv_step(cache, mf, ms, *args, impl, **kw):
        # the tiering step's inputs, for the deciding margin of a flip
        rec[impl] = (cache.fast_hot, cache.slow_hot, cache.fast_page >= 0,
                     cache.slow_page >= 0, mf, ms)
        return kv_step(cache, mf, ms, *args, impl=impl, **kw)

    SD.equilibria_kv_step = recording_kv_step
    try:
        ctx = dict(SD=SD, fused_mul_add=env["fused_mul_add"], cfg=cfg,
                   tcfg=tcfg, model=model, toks=toks, steps=steps, rec=rec,
                   LAYERS=env["LAYERS"], cross=cross)
        torch.cuda.reset_peak_memory_stats()
        for w in swrap.values():
            w.launches = 0
        path, moved = [], []
        # K5 runs twice a KV layer (fast and slow pool): layer 0's fast
        # call opens every step
        with on_path(TA, "pool_attention_partial", functools.partial(
                k5_vs_plain, torch, TA_REF, score_scaled=k5_scaled), path,
                tag,
                every=2 * env["KC"].kv_layer_count(cfg)), \
                k6_on_path(torch, KMIG, RMIG, moved, tag):
            run = serve_compare(torch, np, ctx, "equilibria", steps,
                                TOL["bf16"], snapshot_at=steps // 2)
        launches = {k: w.launches for k, w in swrap.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        kv = run["state"]["kv"]
        c = kv.counters
        promos, demos = int(c.promotions.sum()), int(c.demotions.sum())
        ms = sorted(run["ms"])
        mean = sum(ms) / len(ms)
        out = dict(step_ms=mean, median_ms=ms[len(ms) // 2],
                   p90_ms=ms[int(len(ms) * 0.9)], tokens_per_s=batch / (
                       mean / 1e3), peak_gib=peak, launches=launches,
                   promotions=promos, demotions=demos)
        phase(tag, f"{cfg.name} {cfg.num_layers} layers ("
              f"{n_parameters(model):,} parameters, {cfg.param_dtype} "
              f"weights), {batch} seqs x {steps} steps, {tcfg.n_tenants} "
              f"tenants, equilibria, bf16: promotions {promos} (attempted "
              f"{int(c.attempted_promotions.sum())}) demotions {demos} "
              f"thrash {int(c.thrash_events.sum())}; launches {launches} "
              f"({launches['pool_attention_partial'] / steps:g} and "
              f"{launches['migrate_pages'] / steps:g} a step); step ms mean "
              f"{mean:.3f} median {out['median_ms']:.3f} p90 "
              f"{out['p90_ms']:.3f} (CUDA events, impl=cuda); decode "
              f"{out['tokens_per_s']:.1f} tokens/s; peak memory {peak:.2f} "
              f"GiB; fast budget "
              f"{SD.fast_budget_pages(cfg, tcfg, batch, steps)} pages")
        worst = max(path, key=lambda r: r["share"])
        out["path_err"] = max(r["err"] for r in path)
        phase(f"{tag}-path", f"K5 on the path, layer 0's fast pool at each "
              f"of {len(path)} steps: max abs err {out['path_err']:.3g}, "
              f"{worst['share']:.3g} of the bound ({K5_PATH_RTOL} of each "
              f"output's max |value|); "
              f"{worst['what']}")
        require(len(path) == steps and worst["share"] <= 1.0,
                f"{tag}: K5 on the path {worst}")
        out["k6_path_calls"], out["k6_path_pages"] = len(moved), sum(moved)
        phase(f"{tag}-path", f"K6 on the path: {len(moved)} of "
              f"{launches['migrate_pages']} calls moved pages ("
              f"{sum(moved)} sequences' pages over "
              f"{env['KC'].kv_layer_count(cfg)} KV layers, "
              "K and V), each bitwise equal to the plain version on the "
              "path's own pools and indices")
        check_compare(np, run, TOL["bf16"], f"{tag}-agree",
                      hold_floats=not layered)
        for name, n in launches.items():
            want = d1_launches(cfg, steps) if name == "ssd_decode" else None
            require(n > 0 if want is None else n == want,
                    f"{tag}: the serving path launched {name} {n} times")
        if need_moves:
            require(promos > 0 and demos > 0 and moved, f"{tag}: promotions "
                    f"{promos}, demotions {demos}, K6 held on the path "
                    f"{len(moved)} times")
        out["k5"] = k5_numbers(torch, F, TA, TA_REF, kv, tcfg.page_tokens,
                               cfg.num_heads)
        out["k6"] = k6_numbers(torch, np, KMIG, RMIG, kv, seed)
        k5, k6 = out["k5"], out["k6"]
        phase(f"{tag}-kernels", f"on the run's cache: pool_attention_partial"
              f" [H={cfg.num_heads} K={cfg.num_kv_heads} "
              f"D={cfg.resolved_head_dim}, one layer, both pools (2 op "
              f"calls), {k5['n_valid']} valid tokens]: {k5['ms']:.4f} ms "
              f"(plain {k5['plain_ms']:.4f}, library {k5['library_ms']:.4f} "
              f"(SDPA, {k5['library_form']}), bound {k5['bound_ms']:.5f}); "
              f"migrate_pages [{k6['n_sel']} of {batch} sequences x "
              f"{cfg.num_layers} layers, page "
              f"{kv.fast_k[0, 0, 0].numel() * kv.fast_k.element_size()} "
              f"bytes, one pool]: {k6['ms']:.4f} ms (plain "
              f"{k6['plain_ms']:.4f}, library {k6['library_ms']:.4f}, bound "
              f"{k6['bound_ms']:.5f}); K+V {k6['kv']['ms']:.4f} (bound "
              f"{k6['kv']['bound_ms']:.5f})")
        snap = run["snapshot"]
        del run, kv
        torch.cuda.empty_cache()
        if profile:
            step_c = SD.build_serve_step(cfg, tcfg, batch, steps,
                                         impl="cuda")
            wall, prof = profile_serve_step(
                torch, step_c, model, snap,
                toks[:, steps // 2:steps // 2 + 1])
            if prof is None:
                phase(f"{tag}-profile", "device time not measured: the "
                                        "profiler saw no device event")
            else:
                n_dev, busy, top, _ = prof
                out.update(device_events=n_dev, busy_ms=busy, wall_ms=wall,
                           idle_share=1 - busy / wall)
                phase(f"{tag}-profile", f"one decode step at position "
                      f"{steps // 2}: {n_dev} device events, busy "
                      f"{busy:.4f} ms of {wall:.4f} ms wall (idle share "
                      f"{1 - busy / wall:.3f}); device ms by class: "
                      + format_classes(class_ms(top, SERVE_CLASSES))
                      + "; top: " + "; ".join(f"{nm[:50]} {t:.4f} ms x{n}"
                                              for nm, t, n in top[:8]))
        if cfg.family == "moe":
            out["layers"] = moe_layer_check(
                torch, env, model, tcfg, steps, snap,
                toks[:, steps // 2:steps // 2 + 1], tag)
        if cfg.family in DEC_BLOCKS:
            out["layers"] = serve_layer_check(
                torch, env, model, tcfg, steps, snap,
                toks[:, steps // 2:steps // 2 + 1], tag)
        del snap
        torch.cuda.empty_cache()
        side = []
        for mode in ("tpp", "static") if side_steps else ():
            mv: list = []
            with k6_on_path(torch, KMIG, RMIG, mv, f"{tag}-{mode}"):
                r = serve_compare(torch, np, ctx, mode, side_steps,
                                  TOL["bf16"])
            c = r["state"]["kv"].counters
            side.append(f"{mode}: promotions {int(c.promotions.sum())} "
                        f"demotions {int(c.demotions.sum())} (K6 held on "
                        f"the path in {len(mv)} calls), step ms mean "
                        f"{sum(r['ms']) / len(r['ms']):.3f}")
            check_compare(np, r, TOL["bf16"], f"{tag}-{mode}-agree")
            del r
        if side:
            phase(f"{tag}-modes", f"{side_steps} steps each: "
                  + " | ".join(side))
    finally:
        SD.equilibria_kv_step = kv_step
    return out


def ssm_serve_cell(torch, np, env: dict, model, *, batch: int, steps: int,
                   seed: int, tag: str) -> dict:
    """The ssm family's serving: no paged KV and no tiering step; D1 once a
    Mamba2 layer a step. impl "cuda" and "ref" step by step from a shared
    state: layer 0's Mamba2 state bit for bit (its inputs are the same),
    the logits within the bf16 bound of max |logit| (D1's y sums in another
    order, so a later layer's input can differ in its last bf16 bit, as K5's
    outputs do in phase 9), the state's largest gap reported; D1 launched
    once a layer a step and held on the run's own final state
    (``d1_replay``); then decode == full-sequence forward (K8) in float32.
    Returns the run's numbers."""
    SD, SDEC = env["SD"], env["SDEC"]
    cfg = model.cfg
    tcfg = env["full_load"](cfg, batch, steps)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, steps)).astype(np.int32), device="cuda")
    step_c = SD.build_serve_step(cfg, tcfg, batch, steps, impl="cuda")
    step_r = SD.build_serve_step(cfg, tcfg, batch, steps, impl="ref")
    state = SD.init_serve_state(cfg, tcfg, batch, steps)
    require(sorted(state) == ["mamba"], f"{tag}: state {sorted(state)}")
    torch.cuda.reset_peak_memory_stats()
    e0 = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    e1 = [torch.cuda.Event(enable_timing=True) for _ in range(steps)]
    logit_rel, state_rel, d1_in = [], 0.0, {}
    n0 = SDEC.ssd_decode.launches
    with torch.no_grad(), d1_inputs(SDEC, cfg.num_layers, d1_in):
        for i in range(steps):
            ref_state = clone_state(torch, state)
            tok = toks[:, i:i + 1]
            e0[i].record()
            lc, state = step_c(model, state, tok)
            e1[i].record()
            lr, ref_state = step_r(model, ref_state, tok)
            require(bool(torch.isfinite(lc).all()), f"{tag} step {i}: "
                    "non-finite logits")
            logit_rel.append(float((lc.float() - lr.float()).abs().max()
                                   / lr.float().abs().max()))
            for f in state["mamba"]._fields:
                a = getattr(state["mamba"], f)
                b = getattr(ref_state["mamba"], f)
                require(torch.equal(a[0], b[0]), f"{tag} step {i}: layer "
                        f"0's {f} differs")
                state_rel = max(state_rel, float(
                    (a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30)))
    torch.cuda.synchronize()
    launched = SDEC.ssd_decode.launches - n0
    require(launched == d1_launches(cfg, steps),
            f"{tag}: D1 launched {launched} times, want "
            f"{d1_launches(cfg, steps)}")
    require(max(logit_rel) <= TOL["bf16"]["logit_rtol"],
            f"{tag}: logits differ by {max(logit_rel):.3g} of max |logit|")
    d1_err = d1_replay(torch, SDEC, env["SDEC_REF"], state["mamba"].h, d1_in,
                       tag)
    ms = sorted(a.elapsed_time(b) for a, b in zip(e0, e1))
    mean = sum(ms) / len(ms)
    out = dict(step_ms=mean, median_ms=ms[len(ms) // 2],
               p90_ms=ms[int(len(ms) * 0.9)],
               tokens_per_s=batch / (mean / 1e3),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               d1_launches=launched, d1_err=d1_err)
    phase(tag, f"{cfg.name} {cfg.num_layers} Mamba2 layers, {batch} seqs x "
          f"{steps} steps, bf16: cuda vs ref every step: layer 0's Mamba2 "
          f"state bitwise, logits rel err max {max(logit_rel):.3g} median "
          f"{float(np.median(logit_rel)):.3g} <= "
          f"{TOL['bf16']['logit_rtol']}, Mamba2 state max rel "
          f"{state_rel:.3g}; D1 launches {launched} ({cfg.num_layers} a "
          f"step), on the run's final state bitwise, y max abs err "
          f"{d1_err:.3g}; step ms mean "
          f"{mean:.3f} median {out['median_ms']:.3f} p90 {out['p90_ms']:.3f}"
          f" (CUDA events); decode {out['tokens_per_s']:.1f} tokens/s; peak "
          f"memory {out['peak_gib']:.2f} GiB")
    # decode == forward in float32
    m32 = with_dtype(model, "float32")
    toks_fw = toks[:SSM_FWD_BATCH, :SSM_FWD_STEPS].contiguous()
    step32 = SD.build_serve_step(m32.cfg, tcfg, SSM_FWD_BATCH, SSM_FWD_STEPS)
    st = SD.init_serve_state(m32.cfg, tcfg, SSM_FWD_BATCH, SSM_FWD_STEPS)
    outs = []
    ssd = env["pwrap"]["ssd_scan"]
    with torch.no_grad():
        for i in range(SSM_FWD_STEPS):
            lg, st = step32(m32, st, toks_fw[:, i:i + 1])
            outs.append(lg[:, 0])
        ssd.launches = 0
        ref = env["ssm_lm_forward"](m32, toks_fw)
    fw_launches = ssd.launches
    rel = float((torch.stack(outs, 1) - ref).abs().max() / ref.abs().max())
    require(rel <= FWD_RTOL, f"{tag}: decode != forward {rel:.3g}")
    require(fw_launches == cfg.num_layers, f"{tag}: the forward launched K8 "
                                           f"{fw_launches} times")
    out["fwd_rel"] = rel
    phase(f"{tag}-forward", f"f32 full width, {SSM_FWD_BATCH} seqs x "
          f"{SSM_FWD_STEPS} steps: max |decode - forward| / max |logit| = "
          f"{rel:.3g} <= {FWD_RTOL}; forward K8 launches {fw_launches}")
    return out


def k7_shape_numbers(torch, F, FA, FA_REF, H, K, D, S, window) -> dict:
    """K7 at one head shape, causal with ``window``, B=1, bf16 inputs:
    agreement with the plain version (on the last ``tail`` query rows at
    long S), its time, the plain version's (S <= 4,096: its scores are
    [H, S, S] float32), the faster SDPA form and the bound over the band's
    pairs."""
    g = torch.Generator(device="cuda").manual_seed(31)
    q, k, v = (torch.randn((1, h, S, D), generator=g, device="cuda").to(
        torch.bfloat16) for h in (H, K, K))
    out, rc = k7_routes(FA, lambda: FA.flash_attention(q, k, v,
                                                       window=window))
    route = one_route(rc, f"K7 H={H} K={K} D={D} S={S}")
    require(route == "wgmma", f"K7 H={H} K={K} D={D} S={S} bf16: route "
                              f"{route}, want wgmma")
    tail = min(S, PATH_SCORES // (H * S))
    want = FA_REF.flash_attention_ref(q[:, :, -tail:], k, v, window=window)
    err = float((out[:, :, -tail:].float() - want.float()).abs().max())
    require(torch.allclose(out[:, :, -tail:].float(), want.float(),
                           atol=K7_TOL["bfloat16"], rtol=K7_TOL["bfloat16"]),
            f"K7 H={H} K={K} D={D} S={S} window={window}: max err {err}")
    del want
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    nbytes = 2 * (2 * H * S * D + 2 * K * S * D)
    nops = 4 * H * D * pairs
    n = 10 if S <= 4096 else 3
    if window is None:
        lib = (device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), n=n), "causal GQA")
    else:
        lib = sdpa_band(torch, F, q, k, v, window, n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_OPS_PER_S * 1e3
    return dict(H=H, K=K, D=D, S=S, window=window, err=err, tail=tail,
                ms=device_ms(lambda: FA.flash_attention(q, k, v,
                                                        window=window), n=n),
                plain_ms=device_ms(lambda: FA_REF.flash_attention_ref(
                    q, k, v, window=window), n=3) if S <= 4096 else None,
                library_ms=lib[0], library_form=lib[1],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                route=route)


def k7_f32_numbers(torch, F, FA, FA_REF, H, K, D, S) -> dict:
    """K7's f32 route (the tf32x3 kernel) at one head shape, B=1, causal:
    the route the launcher reports, its time beside f32 SDPA's (the faster
    of ``enable_gqa`` and K/V expanded to the query heads, causal, TF32 off)
    and, at S <= 4,096 (where its [H, S, S] float32 scores fit), agreement
    with the plain version, the plain version's time and SDPA's own
    distance from it; and two bounds: float32-accurate products on the
    tensor cores, three TF32 products per product (495 TFLOP/s,
    ``bound_ms``), and the same work on the CUDA cores (67 TFLOP/s,
    ``cuda_core_bound_ms``, a side field)."""
    g = torch.Generator(device="cuda").manual_seed(34)
    q, k, v = (torch.randn((1, h, S, D), generator=g, device="cuda")
               for h in (H, K, K))
    out, rc = k7_routes(FA, lambda: FA.flash_attention(q, k, v))
    route = one_route(rc, f"K7 f32 H={H} D={D} S={S}")
    require(route == "tf32x3", f"K7 f32 H={H} D={D}: route {route}")
    require(bool(torch.isfinite(out).all()), f"K7 f32 S={S}: non-finite")
    ke, ve = (x.repeat_interleave(H // K, dim=1) for x in (k, v))
    forms = {"enable_gqa": lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True),
             "expanded K/V": lambda: F.scaled_dot_product_attention(
                 q, ke, ve, is_causal=True)}
    n = 10 if S <= PREFILL_S else 3
    lib = min((device_ms(f, n=n), form) for form, f in forms.items())
    err = lib_err = plain_ms = None
    if S <= PREFILL_S:
        want = FA_REF.flash_attention_ref(q, k, v)
        err = float((out - want).abs().max())
        require(torch.allclose(out, want, atol=K7_TOL["float32"],
                               rtol=K7_TOL["float32"]),
                f"K7 f32 H={H} K={K} D={D} S={S}: max err {err}")
        lib_err = float((forms[lib[1]]() - want).abs().max())
        del want
        plain_ms = device_ms(lambda: FA_REF.flash_attention_ref(q, k, v),
                             n=3)
    del ke, ve, forms
    pairs = S * (S + 1) // 2
    t_bytes = 4 * (2 * H * S * D + 2 * K * S * D) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * H * D * pairs / F32_OPS_PER_S * 1e3
    t_tf32 = 3 * 4 * H * D * pairs / TF32_OPS_PER_S * 1e3
    return dict(H=H, K=K, D=D, S=S, route=route, err=err,
                ms=device_ms(lambda: FA.flash_attention(q, k, v), n=n),
                plain_ms=plain_ms, library_ms=lib[0], library_form=lib[1],
                library_err=lib_err, bound_ms=max(t_bytes, t_tf32),
                bound_by="bytes" if t_bytes >= t_tf32 else "operations",
                cuda_core_bound_ms=max(t_bytes, t_ops))


def sdpa_band(torch, F, q, k, v, window: int, n: int):
    """(ms, form) of scaled_dot_product_attention over the causal band of
    ``window`` keys: K/V expanded to the query heads and a boolean band
    mask, on the memory-efficient backend (the math backend would hold
    [H, S, S] scores); (None, why) where that backend refuses it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S = q.shape[2]
    pos = torch.arange(S, device="cuda")
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    ke, ve = (x.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
              for x in (k, v))
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return (device_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask), n=n),
                "expanded K/V, band mask, memory-efficient backend")
    except RuntimeError as e:
        return None, f"not measured: {str(e)[:80]}"


def check_k5_new_widths(torch, np, TA, TA_REF, widths) -> tuple:
    """K5 at each new (H, K, D) against its plain version over random pools
    whose sequences hold 4,000 to 6,000 tokens (past a 4,096 window's
    edge), bf16 and f32, window None and 4,096; timed in bf16 at each
    width's own window. Returns (max abs error, cases, {width: times})."""
    rng = np.random.default_rng(31)
    # the pools (up to 3.5 GB in float32) are drawn on the card: drawn
    # with numpy and copied over, they took 40 s of the phase
    gen = torch.Generator(device="cuda").manual_seed(31)
    pt, err, cases, times = 16, 0.0, 0, {}
    for label, (B, H, K, D, window) in widths.items():
        Mp = 208                       # the windowed configs' fast pool
        n_pages = K5_SEQ[1] // pt + 1
        q, pk, pv = (torch.randn(shape, generator=gen, device="cuda")
                     for shape in ((B, H, D), (B, Mp, pt, K, D),
                                   (B, Mp, pt, K, D)))
        slot = np.stack([rng.permutation(n_pages)[:Mp] for _ in range(B)])
        slot = np.where(rng.random((B, Mp)) < 0.15, -1, slot).astype(np.int32)
        seq = rng.integers(*K5_SEQ, B).astype(np.int32)
        for dtype in (torch.bfloat16, torch.float32):
            a = [x.to(dtype) for x in (q, pk, pv)] + [
                torch.as_tensor(x, device="cuda") for x in (slot, seq)]
            for win in (None, NEW_WINDOW):
                got = TA.pool_attention_partial(*a, window=win)
                want = TA_REF.pool_attention_partial_ref(*a, window=win)
                for g, w in zip(got, want):
                    require(bool(torch.isfinite(g).all()), "K5: non-finite")
                    d = float((g - w).abs().max())
                    err = max(err, d)
                    require(torch.allclose(g, w, atol=K5_TOL, rtol=K5_TOL),
                            f"K5 {label} B={B} H={H} K={K} D={D} {dtype} "
                            f"window={win}: max err {d}")
                cases += 1
                if dtype == torch.bfloat16 and win == window:
                    elem = a[1].element_size()
                    tok = (torch.as_tensor(slot, device="cuda")[:, :, None]
                           * pt + torch.arange(pt, device="cuda"))
                    cur = a[4][:, None, None]
                    ok = (a[3] >= 0)[:, :, None] & (tok <= cur)
                    if win is not None:
                        ok &= tok > cur - win
                    n_valid = int(ok.sum())
                    nbytes = (n_valid * K * D * elem * 2 + B * H * D * elem
                              + B * Mp * 4 + B * 4 + B * H * D * 4
                              + 2 * B * H * 4 + B * H * Mp * 4)
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = n_valid * H * D * 4 / F32_OPS_PER_S * 1e3
                    times[label] = dict(
                        B=B, H=H, K=K, D=D, window=win, n_valid=n_valid,
                        ms=device_ms(lambda: TA.pool_attention_partial(
                            *a, window=win)),
                        plain_ms=device_ms(
                            lambda: TA_REF.pool_attention_partial_ref(
                                *a, window=win), n=10),
                        bound_ms=max(t_bytes, t_ops))
            del a
    torch.cuda.synchronize()
    return err, cases, times


def check_k6_new_pages(torch, np, KMIG, KMIG_REF, pages) -> int:
    """K6 bitwise against its plain version at each new page size (one
    pool and K+V, bf16, aligned and at an odd offset). Returns cases."""
    rng = np.random.default_rng(32)
    cases = 0
    for label, (L, B, Mf, Ms, pt, K, D) in pages.items():
        si = torch.as_tensor(rng.integers(0, Mf, B), device="cuda")
        di = torch.as_tensor(rng.integers(0, Ms, B), device="cuda")
        sel = torch.as_tensor(rng.random(B) < 0.5, device="cuda")
        for offset in (0, 1):
            pools = [at_offset(torch, torch.randn(
                (L, B, m, pt, K, D), device="cuda").to(torch.bfloat16),
                offset) for m in (Mf, Ms, Mf, Ms)]
            got = KMIG.migrate_pages(pools[0], pools[1].clone(), si, di, sel)
            want = KMIG_REF.migrate_pages_ref(pools[0], pools[1].clone(), si,
                                              di, sel)
            require(torch.equal(got, want), f"K6 {label} offset {offset}: "
                                            "kernel != plain")
            got = KMIG.migrate_pages_kv(pools[0], pools[1].clone(), pools[2],
                                        pools[3].clone(), si, di, sel)
            want = KMIG_REF.migrate_pages_kv_ref(
                pools[0], pools[1].clone(), pools[2], pools[3].clone(), si,
                di, sel)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"K6 K+V {label} offset {offset}: kernel != plain")
            cases += 2
            del pools
    torch.cuda.synchronize()
    return cases


def family_phases(torch, np, env: dict) -> dict:
    """Phases 27-31: the moe, dense and ssm families at full width, each
    model freed before the next. Returns {"serve": {label: numbers},
    "prefill_labels": [...], "k5": ..., "k7": [...], ...} for the kernels'
    record."""
    import dataclasses
    from repro_torch.configs import (get_config, get_serve_load,
                                     reduced_depth_config)
    make_model, prefill_cell = env["make_model"], env["prefill_cell"]
    pwrap = env["pwrap"]
    res = {"serve": {}, "prefill": []}

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    free()
    phase("27-31", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                   "allocated before the first model")

    # ---- 27. MoE serving: granite-moe-3b-a800m, full width, depth 8 --------
    model = cut_depth_model(GRANITE, SERVE_DEPTH)
    gB, gsteps = get_serve_load(GRANITE)
    res["serve"]["S5 granite"] = serve_cell(
        torch, np, env, model, batch=gB, steps=gsteps, seed=27,
        tag="27-moe-serve", side_steps=MOE_SIDE_STEPS, profile=True,
        need_moves=True)

    # ---- 28. MoE prefill: granite, then Mixtral 8x22B at depth 8 ----------
    prefill_cell(model, "granite", tag="28-moe-prefill")
    res["prefill"].append("granite")
    del model
    free()
    mcfg = dataclasses.replace(reduced_depth_config(MIXTRAL, MIXTRAL_DEPTH),
                               param_dtype="bfloat16")
    model = make_model(mcfg, seed=0, device="cuda")
    # Mixtral's K7 on the path is held to K7_TOL of each output's max
    # |value| (every other prefill elementwise, as phase 14): at depth 8
    # the stacked init's std of 1/sqrt(layers) per weight leaves q and k
    # elements near 28 and scores in the thousands, which K7's bf16
    # tensor-core products accumulate in float32 in another order than the
    # plain version; the softmax carries that into each output relative to
    # its scale (on an H100, PERF.md: 0.5 where |v| reaches 141, 1.68x the
    # elementwise bound; random inputs at its shape stay within that bound,
    # phase 31)
    prefill_cell(model, "mixtral", tag="28-moe-prefill", scaled=True,
                 tail=path_tail(mcfg))
    res["prefill"].append("mixtral")
    mB, msteps = get_serve_load(MIXTRAL)
    res["serve"]["S5 mixtral"] = serve_cell(
        torch, np, env, model, batch=mB, steps=msteps, seed=28,
        tag="28-moe-serve", profile=True)
    del model
    free()

    # ---- 29. the dense configs: h2o-danube-3-4b, codeqwen1.5-7b, qwen3 ---
    for arch in DENSE_ARCHS:
        batch = PREFILL_B
        if arch == "qwen3_32b":
            # bf16 weights, as at full depth 64 (65.5 GB)
            model = cut_depth_model(arch, SERVE_DEPTH,
                                    param_dtype="bfloat16")
            batch = 1        # plain K7's [B, 64, S, S] float32 scores
        else:
            model = cut_depth_model(arch, SERVE_DEPTH)
        cfg = model.cfg
        step, toks = prefill_cell(model, arch, tag="29-dense-prefill",
                                  batch=batch, tail=path_tail(cfg))
        if arch == DANUBE:
            profile_prefill(torch, step, model, toks, "29-danube-p5")
        del step, toks
        res["prefill"].append(arch)
        b, steps = get_serve_load(arch)
        res["serve"][f"S6 {arch}"] = serve_cell(
            torch, np, env, model, batch=b, steps=steps, seed=29,
            tag="29-dense-serve", profile=arch == "qwen3_32b")
        del model
        free()

    # ---- 30. Mamba2-130m: prefill through K8, serving, decode == forward --
    scfg = get_config(MAMBA2)
    model = make_model(scfg, seed=0, device="cuda")
    prefill_cell(model, "mamba2", tag="30-ssm-prefill")
    res["prefill"].append("mamba2")
    sB, ssteps = get_serve_load(MAMBA2)
    res["serve"]["S7 mamba2"] = ssm_serve_cell(
        torch, np, env, model, batch=sB, steps=ssteps, seed=30,
        tag="30-ssm-serve")
    del model
    free()

    # ---- 31. K5, K6 and K7 at the new widths --------------------------------
    F, FA, FA_REF = env["F"], env["FA"], env["FA_REF"]
    shapes = {}
    for arch in (GRANITE, MIXTRAL) + DENSE_ARCHS:
        c = get_config(arch)
        shapes[arch] = (c.num_heads, c.num_kv_heads, c.resolved_head_dim,
                        c.sliding_window)
    k5_err, k5_cases, k5_times = check_k5_new_widths(
        torch, np, env["TA"], env["TA_REF"],
        {a: (get_serve_load(a)[0], H, K, D, w)
         for a, (H, K, D, w) in shapes.items()})
    phase("31-k5", f"pool_attention_partial within {K5_TOL} of plain (max "
          f"abs err {k5_err:.3g}) over {k5_cases} cases (G = 3, 6, 4, 1, "
          f"8: " + ", ".join(f"{a} H={H} K={K} D={D}" for a, (H, K, D, _)
                             in shapes.items())
          + f"; seq_len {K5_SEQ[0]}-{K5_SEQ[1]}, 208-slot pools, bf16/f32, "
          f"window None/{NEW_WINDOW}); bf16 at each config's window: " +
          "; ".join(f"{a} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                    f"bound {t['bound_ms']:.5f}, {t['n_valid']} valid tokens)"
                    for a, t in k5_times.items()))
    pages = {}
    for arch in (GRANITE, MIXTRAL) + DENSE_ARCHS:
        c = get_config(arch)
        pages[arch] = (4, 32, 16, 16, 16, c.num_kv_heads,
                       c.resolved_head_dim)
    k6_cases = check_k6_new_pages(torch, np, env["KMIG"], env["RMIG"], pages)
    phase("31-k6", f"migrate_pages bitwise over {k6_cases} cases at the new "
          "page sizes (bytes, bf16: " + ", ".join(
              f"{a} {16 * K * D * 2}" for a, (*_, K, D) in pages.items())
          + "; one pool and K+V, aligned and at an odd offset)")
    k7 = []
    for arch, (H, K, D, _) in shapes.items():
        for S in (PREFILL_S, TIMED_S):
            for window in (None, NEW_WINDOW):
                r = k7_shape_numbers(torch, F, FA, FA_REF, H, K, D, S,
                                     window)
                r["arch"] = arch
                k7.append(r)
                plain = ("not measured (its [H, S, S] float32 scores)"
                         if r["plain_ms"] is None else f"{r['plain_ms']:.4f}")
                lib = ("none" if r["library_ms"] is None
                       else f"{r['library_ms']:.4f}")
                phase("31-k7", f"flash_attention [{arch} H={H} K={K} D={D}"
                      f", B=1 S={S}, bf16, causal, window {window}; route "
                      f"{r['route']} (counted)]: "
                      f"{r['ms']:.4f} ms (plain {plain}, library "
                      f"{lib} (SDPA, {r['library_form']}), "
                      f"bound {r['bound_ms']:.5f} ({r['bound_by']})); max "
                      f"abs err {r['err']:.3g} over the last {r['tail']} "
                      "query rows")
                free()
    # the f32 route (the tf32x3 kernel) at danube's heads: phase 35's shape,
    # then S=16,384 (its plain version's scores do not fit)
    H, K, D, _ = shapes[DANUBE]
    k7_f32 = []
    for S in (PREFILL_S, F32_LONG_S):
        r = k7_f32_numbers(torch, F, FA, FA_REF, H, K, D, S)
        k7_f32.append(r)
        plain = ("not measured (its [H, S, S] float32 scores)"
                 if r["plain_ms"] is None else f"{r['plain_ms']:.4f}")
        agree = ("" if r["err"] is None else
                 f"; max abs err {r['err']:.3g}, SDPA's "
                 f"{r['library_err']:.3g} from plain")
        phase("31-k7-f32", f"flash_attention [{DANUBE} H={H} K={K} D={D}, "
              f"B=1 S={S}, f32, causal; route {r['route']} (counted)]: "
              f"{r['ms']:.4f} ms (plain {plain}, library "
              f"{r['library_ms']:.4f} (f32 SDPA, causal, "
              f"{r['library_form']}), bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}, three TF32 products, 495 TFLOP/s; on the "
              f"CUDA cores at 67 TFLOP/s {r['cuda_core_bound_ms']:.5f}))"
              f"{agree}")
        free()
    res.update(k5_err=k5_err, k5_times=k5_times, k7=k7, k7_f32=k7_f32)
    return res


def profile_prefill(torch, step, model, toks, tag: str) -> None:
    """One more prefill of ``toks`` (``step`` from ``run_prefill_cell``,
    which timed it and held K7's routes), profiled by kernel class."""
    cfg = model.cfg
    prof = profile_fn(torch, lambda: step(model, {"tokens": toks}))
    if prof is None:
        phase(tag, "device time not measured: the profiler saw no device "
                   "event")
        return
    n_dev, busy, top, wall = prof
    phase(tag, f"{cfg.name} B={toks.shape[0]} S={toks.shape[1]} {cfg.dtype}"
          f" profiled: {n_dev} device events, busy {busy:.1f} of {wall:.1f} "
          f"ms wall (idle share {1 - busy / wall:.4f}); device ms by class: "
          f"{format_classes(class_ms(top))}; top: " + "; ".join(
              f"{nm[:60]} {t:.1f} ms x{c}" for nm, t, c in top[:6]))


def k7_kind(q, k, v, *, causal=True, window=None, impl="cuda") -> str:
    """The kind of a K7 call: causal self-attention (or windowed), full
    self-attention (an encoder's) or cross-attention (Sq != Skv)."""
    if causal or window is not None:
        return "causal" if window is None else "window"
    return "full" if q.shape[2] == k.shape[2] else "cross"


def path_hooks(torch, env: dict, label: str, tail=None, scaled=False):
    """The ``on_path`` hooks of K7 (its last ``tail`` query rows; the bound
    ``scaled`` or not, ``k7_vs_plain``) and K8: the first kernel call of
    each K7 kind (``k7_kind``) and the first K8 call of a prefill held
    against the plain version on the path's own arguments, readings to
    ``env["checks"]``."""
    stack = contextlib.ExitStack()
    stack.enter_context(on_path(
        env["FA"], "flash_attention", functools.partial(
            k7_vs_plain, torch, env["FA_REF"], tail=tail, scaled=scaled),
        env["checks"], label, kind=k7_kind))
    stack.enter_context(on_path(
        env["SSD"], "ssd_scan", functools.partial(
            k8_vs_plain, torch, env["SSD_REF"]), env["checks"], label))
    return stack


def run_prefill_cell(torch, np, env: dict, model, label, tag="14-prefill",
                     batch=PREFILL_B, tail=PATH_TAIL, scaled=False,
                     extra=None, layered=False):
    """Phase 14's prefill cell at ``model``'s config: cuda vs ref at
    S=4,096 in bf16 and f32, then one timed prefill at B=1, S=32,768 after
    a warm-up, with layer 0's K7 (each kind) and K8 calls held on the path
    (K7's bound ``scaled`` or not, ``k7_vs_plain``). ``extra(b)`` gives
    the encoder input of a batch of ``b`` (encdec, vlm), whose prefill is
    also held block by block (``prefill_layer_check``); with ``layered``
    its end-to-end logits are printed but held only through that check.
    Records ``env["rows"][label]``; returns (the step, the timed
    tokens)."""
    extra = extra or (lambda b: {})
    make_prefill_step, pwrap = env["make_prefill_step"], env["pwrap"]
    cfg_m = model.cfg
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        0, cfg_m.vocab_size, (batch, PREFILL_S)).astype(np.int32),
        device="cuda")
    rel, routed = {}, {}
    for dt in ("bfloat16", "float32"):
        with path_hooks(torch, env, f"{label} B={batch} S={PREFILL_S} {dt}",
                        scaled=scaled):
            rel[dt], routed[dt] = prefill_agree(
                torch, make_prefill_step, with_dtype(model, dt), toks,
                PREFILL_TOL[dt], env["LAYERS"], extra(batch), layered)
    layers = (prefill_layer_check(torch, env, model, toks, extra(batch), tag)
              if cfg_m.family in FWD_BLOCKS else None)
    step = make_prefill_step(cfg_m, impl="cuda")
    toks = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg_m.vocab_size, (TIMED_B, TIMED_S)).astype(np.int32),
        device="cuda")
    # layer 0's K7 (last ``tail`` query rows) and K8 (all 128 chunks)
    # at the timed length, in a prefill of its own
    timed_extra = extra(TIMED_B)
    with path_hooks(torch, env, f"{label} B={TIMED_B} S={TIMED_S} "
                    f"{cfg_m.dtype}", tail=tail, scaled=scaled):
        step(model, {"tokens": toks, **timed_extra})
    torch.cuda.synchronize()
    for w in pwrap.values():
        w.launches = 0
    (warm_ms, ms, peak), routes = k7_routes(env["FA"], lambda: time_prefill(
        torch, step, model, toks, timed_extra))
    n = {k: w.launches // 2 for k, w in pwrap.items()}
    routes = {r: c // 2 for r, c in routes.items()}
    # every K7 launch of a bf16 prefill on the wgmma kernel, as its
    # launcher reports (its activations' strides and bases suit the TMA)
    require(cfg_m.dtype != "bfloat16" or routes == {
        "wgmma": n["flash_attention"], "tf32x3": 0},
        f"{label}: K7 launches by route {routes}, want all "
        f"{n['flash_attention']} on wgmma")
    env["rows"][label] = dict(ms=ms, peak=peak, launches=n,
                              layers=cfg_m.num_layers,
                              ssm=cfg_m.family == "ssm", k7_routes=routes)
    if layers is not None:
        env["rows"][label]["blocks"] = layers
    def agreement(dt):
        r = routed[dt]
        first = next((i for i, d in enumerate(r) if d), None)
        held = rel[dt] <= PREFILL_TOL[dt]
        return (f"{rel[dt]:.3g}" + (f" <= {PREFILL_TOL[dt]}" if held else
                                    ", held block by block" if layered
                                    else ", not held")
                + ("" if not r else " (expert routing equal in every layer)"
                   if first is None else f" (expert routing differs from "
                   f"layer {first}: {r[first]} decisions there, {sum(r)} "
                   f"over {len(r)} layers)"))

    phase(tag, f"{cfg_m.name} {cfg_m.num_layers} layers: cuda "
          f"vs ref at B={batch} S={PREFILL_S}: bf16 max |d logit| / "
          f"max |logit| {agreement('bfloat16')}, f32 "
          f"{agreement('float32')}, all finite; timed B={TIMED_B} "
          f"S={TIMED_S} bf16 (impl=cuda, CUDA events): {ms:.1f} ms "
          f"(warm-up {warm_ms:.1f}), {TIMED_B * TIMED_S / (ms / 1e3):.1f}"
          f" tokens/s, peak memory {peak:.2f} GiB; launches per prefill "
          f"{n}, K7's by route {routes}")
    env["rows"][label]["routed"] = routed
    return step, toks


def record_families(rows: list, fam: dict, prefill_rows: dict,
                    checks: list) -> None:
    """Phases 28-30's path checks (each within its bound) and launch
    counts (K7 once a layer in every attention prefill, K8 in mamba2's),
    and the new paths' launches and widths on the kernels' rows."""
    for r in checks:
        phase("28-30-prefill-path", f"{r['label']}: {r['what']}: max abs "
              f"err {r['err']:.3g}, {r['share']:.3g} of the bound (atol "
              f"{r['atol']}, rtol {r['rtol']})")
        require(r["share"] <= 1.0, f"{r['label']} {r['what']}: max abs err "
                                   f"{r['err']:.3g} exceeds the bound")
    # K7 in each attention prefill, K8 in mamba2's: layer 0 at S=4,096 in
    # bf16 and f32 and at S=32,768 (K8: y and h)
    require(len(checks) == 3 * (len(fam["prefill"]) - 1)
            + 3 * 2, f"path checks: {len(checks)} readings")
    for label in fam["prefill"]:
        pr = prefill_rows[label]
        want = {"flash_attention": 0 if pr["ssm"] else pr["layers"],
                "ssd_scan": pr["layers"] if pr["ssm"] else 0}
        require(pr["launches"] == want, f"{label} prefill launches "
                                        f"{pr['launches']}, want {want}")
    # the new paths' launches, beside each row's main-path count
    by_name = {r["name"]: r for r in rows if "kernel" not in r}
    d1 = by_name["ssd_decode"]
    for label, sv in fam["serve"].items():
        if "launches" not in sv:       # ssm serving: D1 its only kernel
            d1.setdefault("family_launches", {})[label] = sv["d1_launches"]
            d1["max_abs_err"] = max(d1["max_abs_err"], sv["d1_err"])
            continue
        for k in ("pool_attention_partial", "migrate_pages"):
            fl = by_name[k].setdefault("family_launches", {})
            fl[label] = sv["launches"][k]
            wk = "k5" if k == "pool_attention_partial" else "k6"
            by_name[k].setdefault("family_widths", {})[label] = {
                f: sv[wk][f] for f in ("ms", "plain_ms", "library_ms",
                                       "bound_ms")}
    for label in fam["prefill"]:
        for k, n in prefill_rows[label]["launches"].items():
            if n:
                by_name[k].setdefault("family_launches", {})[
                    f"prefill {label}"] = n
    by_name["pool_attention_partial"]["past_window"] = fam["k5_times"]
    by_name["pool_attention_partial"]["max_abs_err"] = max(
        by_name["pool_attention_partial"]["max_abs_err"], fam["k5_err"])
    by_name["flash_attention"]["family_shapes"] = fam["k7"]
    by_name["flash_attention"]["f32_route"] = fam["k7_f32"]
    by_name["flash_attention"]["max_abs_err"] = max(
        [by_name["flash_attention"]["max_abs_err"]]
        + [r["err"] for r in fam["k7"]])
    for k in ("flash_attention", "ssd_scan"):
        by_name[k]["max_abs_err"] = max(
            [by_name[k]["max_abs_err"]] + [
                r["err"] for r in checks
                if r["what"].startswith(KERNEL_TAG[k])])


# ------------------------------------------------------ phases 32-34 ----
# the encoder-decoder and vision families (slice E1/F2b), at full width
WHISPER, VISION = "whisper_tiny", "llama32_vision_90b"
# Llama 3.2 Vision 90B's 87.7B parameters fit no single card in any dtype:
# its full width at 10 of its 100 layers (two units of 4 self layers and 1
# gated cross layer), bf16 weights (10.66B parameters)
VISION_DEPTH = 10
ENC_INPUT_STD = 0.02     # the reference's data/pipeline.py encoder inputs
# phase 34: the query lengths of K7's cross-attention calls
CROSS_SQ = (PREFILL_S, TIMED_S)
# plain K7's float32 scores [H, Sq, Skv] are timed up to 4 GiB
PLAIN_SCORES_BYTES = 1 << 32
# The blocks whose input and output the layer checks read, by family, in
# the full-sequence forward and in the decode step (x is each one's second
# argument; ``decoder_block`` returns (x, aux)); the encoder's blocks only
# in the prefill, whose decoder blocks follow them.
FWD_BLOCKS = {"encdec": ("encoder_block", "encdec_dec_block"),
              "vlm": ("decoder_block", "cross_block")}
DEC_BLOCKS = {"encdec": ("encdec_dec_block",),
              "vlm": ("decoder_block_decode", "cross_block")}
# A block's output against the ref run's (or the forward's), both fed the
# same input, relative to the ref output's max |value|: in bf16 one ulp is
# 2^-8 of a value (LAYER_RTOL, phase 27's bound); in float32 sums in
# another order move a score by about |s| 2^-24 per add, and the softmax
# carries that into the block's output. The stacked init's scores reach
# 450 on whisper's path and 1.9e4 on the vlm's (K5 on the path, NVIDIA
# H100 80GB HBM3, 700 W): at K5_PATH_RTOL's rate of 1e-3 per 10^3 of
# score that is 1e-2 and more
BLOCK_RTOL = {"bfloat16": LAYER_RTOL, "float32": 1e-2}
# A float32 run held block by block is also held end to end against its
# witness: the kernels' last-bit differences enter at every attention
# call, the witness's at one, and the random model carries either to the
# logits (whisper: a one-ulp change at the first block reaches 0.18 of max
# |logit| in its prefill); a wrong block would carry O(1) differences
WITNESS_FACTOR = 10


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@contextlib.contextmanager
def block_trace(torch, TF, names, ins: list, outs: list, feed=None,
                nudge: bool = False):
    """While active, every call of the blocks ``names`` of ``TF`` appends
    its input x and its output to ``ins`` and ``outs``, in call order. With
    ``feed``, call i takes x = ``feed(i, x)`` (teacher forcing: each block
    fed another run's input); with ``nudge``, the first call's x moves one
    ulp (the witness of how far the model carries a last-bit change)."""
    origs = {n: getattr(TF, n) for n in names}

    def make(orig):
        def block(p, x, *args, **kwargs):
            i = len(ins)
            if feed is not None:
                x = feed(i, x)
            elif nudge and i == 0:
                x = one_ulp(torch, x)
            ins.append(x)
            out = orig(p, x, *args, **kwargs)
            outs.append(out[0] if isinstance(out, tuple) else out)
            return out
        return block

    for n, f in origs.items():
        setattr(TF, n, make(f))
    try:
        yield
    finally:
        for n, f in origs.items():
            setattr(TF, n, f)


def layer_readings(torch, run, tag: str, what: str, dt: str) -> dict:
    """``run(impl, feed=None, nudge=False) -> (ins, outs, logits)``, four
    times: "ref"; "cuda" teacher-forced (each block fed the ref run's
    input); "cuda" free-running; "ref" with the first block's input one
    ulp off. Holds every teacher-forced block within ``BLOCK_RTOL[dt]`` of
    the ref output's max |value|; prints the free-running and witness
    divergence after each block and at the logits."""
    r_in, r_out, r_lg = run("ref")
    t_out = run("cuda", feed=lambda i, x: r_in[i])[1]
    blocks = [_rel(a, b) for a, b in zip(t_out, r_out)]
    _, f_out, f_lg = run("cuda")
    free = [_rel(a, b) for a, b in zip(f_out, r_out)]
    _, w_out, w_lg = run("ref", nudge=True)
    witness = [_rel(a, b) for a, b in zip(w_out, r_out)]
    out = dict(blocks=blocks, free=free, witness=witness,
               free_logits=_rel(f_lg, r_lg), witness_logits=_rel(w_lg, r_lg))
    phase(tag, f"{what}, {dt}, {len(blocks)} blocks: teacher-forced cuda vs "
          f"ref max {max(blocks):.3g} (per block "
          + " ".join(f"{x:.2g}" for x in blocks)
          + f") <= {BLOCK_RTOL[dt]}; free-running "
          + " ".join(f"{x:.2g}" for x in free)
          + f", logits {out['free_logits']:.3g}; witness (ref, one ulp "
          "off at the first block) " + " ".join(f"{x:.2g}" for x in witness)
          + f", logits {out['witness_logits']:.3g}")
    require(len(blocks) == len(r_out) and max(blocks) <= BLOCK_RTOL[dt],
            f"{tag}: a block's cuda output differs from ref by "
            f"{max(blocks):.3g} > {BLOCK_RTOL[dt]}")
    return out


def prefill_layer_check(torch, env: dict, model, toks, extra: dict,
                        tag: str) -> dict:
    """The prefill of an encdec or vlm model at ``toks`` in bf16 and f32,
    block by block (``layer_readings``): each encoder, decoder and cross
    block."""
    TF, make_prefill_step = env["TF"], env["make_prefill_step"]
    out = {}
    for dt in ("bfloat16", "float32"):
        m = with_dtype(model, dt)

        def run(impl, feed=None, nudge=False):
            ins, outs = [], []
            with torch.no_grad(), block_trace(
                    torch, TF, FWD_BLOCKS[m.cfg.family], ins, outs, feed,
                    nudge):
                lg = make_prefill_step(m.cfg, impl=impl)(
                    m, {"tokens": toks, **extra})
            return ins, outs, lg

        out[dt] = r = layer_readings(torch, run, f"{tag}-layers",
                                     f"{m.cfg.name} prefill B="
                                     f"{toks.shape[0]} S={toks.shape[1]}",
                                     dt)
        if dt == "float32":
            require(r["free_logits"] <= max(
                PREFILL_TOL[dt], WITNESS_FACTOR * r["witness_logits"]),
                f"{tag}: f32 prefill cuda vs ref {r['free_logits']:.3g} > "
                f"{WITNESS_FACTOR} x the witness {r['witness_logits']:.3g}")
    return out


def serve_layer_check(torch, env: dict, model, tcfg, seq: int, snap, tok,
                      tag: str) -> dict:
    """One bf16 decode step of an encdec or vlm model from the snapshot
    ``snap`` (its cross K/V included), block by block
    (``layer_readings``)."""
    SD, TF = env["SD"], env["TF"]
    cfg = model.cfg

    def run(impl, feed=None, nudge=False):
        ins, outs = [], []
        step = SD.build_serve_step(cfg, tcfg, tok.shape[0], seq, impl=impl)
        with torch.no_grad(), block_trace(torch, TF, DEC_BLOCKS[cfg.family],
                                          ins, outs, feed, nudge):
            lg, _ = step(model, clone_state(torch, snap), tok)
        return ins, outs, lg

    return layer_readings(torch, run, f"{tag}-layers",
                          f"one step at position {seq // 2}", cfg.dtype)


def open_gates(torch, np, model, seed: int) -> int:
    """Give every scalar gate (``gate``, ``gate_mlp``) a value from U[0.5,
    1.0] and every bias (``b1``, ``b2``) one from N(0, 0.1), seeded (the
    CPU tests' ``open_tree``): the reference's init leaves them at zero,
    which hides the gated cross blocks and the bias path. Returns the
    number of values set."""
    rng = np.random.default_rng(seed)
    n = 0
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gate", "gate_mlp"):
            v = rng.uniform(0.5, 1.0, tuple(p.shape))
        elif leaf in ("b1", "b2"):
            v = rng.standard_normal(tuple(p.shape)) * 0.1
        else:
            continue
        with torch.no_grad():
            p.copy_(torch.as_tensor(v, dtype=torch.float32, device="cuda"))
        n += p.numel()
    return n


def encoder_input(torch, np, cfg, batch: int) -> dict:
    """A batch's seeded encoder input on the card, float32: {"frames": [B,
    encoder_seq, d]} (encdec) or {"image_embeds": [B, n_img, d]} (vlm),
    normal x ``ENC_INPUT_STD``."""
    key, n = (("frames", cfg.encoder_seq) if cfg.family == "encdec"
              else ("image_embeds", cfg.num_image_tokens))
    x = np.random.default_rng(320 + batch).standard_normal(
        (batch, n, cfg.d_model), dtype=np.float32) * ENC_INPUT_STD
    return {key: torch.as_tensor(x, device="cuda")}


def cross_kv(torch, env: dict, model, extra: dict):
    """The cross K/V of every cross layer (impl "cuda": the encoder's K7)."""
    SD, TF = env["SD"], env["TF"]
    with torch.no_grad():
        x = next(iter(extra.values()))
        enc = (TF.encode_frames(model, x) if model.cfg.family == "encdec"
               else x)
        return SD.compute_cross_kv(model, model.cfg, enc)


def cross_decode_forward(torch, np, env: dict, model, tag: str) -> dict:
    """Decode == forward in float32, impl "cuda": ``FWD_BATCH`` x
    ``FWD_STEPS`` teacher-forced tokens of the tiered decode, its cross K/V
    from ``compute_cross_kv``, under bounds that put pages in the slow
    tier, against ``model_forward`` of the same tokens and encoder input.
    Held block by block: a second decode feeds every decoder and cross
    block at step t the forward's input to that block at position t (so
    its cache holds the forward's K/V), and each block's output must be
    within ``BLOCK_RTOL["float32"]`` of the forward's at t, relative to
    the forward block output's max |value|. End to end, the free-running
    decode's logits are held within ``FWD_RTOL`` of the forward's or
    ``WITNESS_FACTOR`` times a witness, the forward with its first block's
    input one ulp off."""
    SD, TF = env["SD"], env["TF"]
    m32 = with_dtype(model, "float32")
    cfg = m32.cfg
    tcfg = env["TieringConfig"](n_tenants=2, page_tokens=16,
                                thrash_table_slots=256,
                                lower_protection=(2, 2), upper_bound=(3, 3))
    toks = torch.as_tensor(np.random.default_rng(33).integers(
        0, cfg.vocab_size, (FWD_BATCH, FWD_STEPS)).astype(np.int32),
        device="cuda")
    extra = encoder_input(torch, np, cfg, FWD_BATCH)
    batch = {"tokens": toks, **extra}
    cross = cross_kv(torch, env, m32, extra)
    fwd_names = tuple(n for n in FWD_BLOCKS[cfg.family]
                      if n != "encoder_block")

    def forward(nudge=False):
        ins, outs = [], []
        with torch.no_grad(), block_trace(torch, TF, fwd_names, ins, outs,
                                          nudge=nudge):
            return TF.model_forward(m32, batch), ins, outs

    def decode(feed=None):
        state = SD.init_serve_state(cfg, tcfg, FWD_BATCH, FWD_STEPS)
        state["cross_k"], state["cross_v"] = (x.clone() for x in cross)
        step = SD.build_serve_step(cfg, tcfg, FWD_BATCH, FWD_STEPS)
        logits, outs = [], []
        with torch.no_grad():
            for t in range(FWD_STEPS):
                ins, o = [], []
                with block_trace(torch, TF, DEC_BLOCKS[cfg.family], ins, o,
                                 None if feed is None else
                                 functools.partial(feed, t)):
                    lg, state = step(m32, state, toks[:, t:t + 1])
                logits.append(lg[:, 0])
                outs.append(o)
        return torch.stack(logits, dim=1), outs, state

    ref, f_in, f_out = forward()
    dec, _, state = decode()
    rel = _rel(dec, ref)
    witness = _rel(forward(nudge=True)[0], ref)
    _, t_outs, _ = decode(feed=lambda t, i, x: f_in[i][:, t:t + 1])
    blocks = [max(float((o[i].float() - f_out[i][:, t:t + 1].float()).abs()
                        .max()) for t, o in enumerate(t_outs))
              / float(f_out[i].float().abs().max()) for i in range(len(f_out))]
    kv = state["kv"]
    moves = int(kv.counters.promotions.sum() + kv.counters.demotions.sum())
    slow = int((kv.slow_page >= 0).sum())
    phase(tag, f"{cfg.name} f32, {FWD_BATCH} seqs x {FWD_STEPS} steps, cross "
          f"K/V from compute_cross_kv, {moves} page moves, {slow} slow "
          f"pages: teacher-forced decode vs forward, per block "
          + " ".join(f"{x:.2g}" for x in blocks)
          + f" <= {BLOCK_RTOL['float32']}; free-running max |decode - "
          f"forward| / max |logit| = {rel:.3g} <= max({FWD_RTOL}, "
          f"{WITNESS_FACTOR} x the witness (forward, one ulp off at the "
          f"first block) {witness:.3g})")
    require(bool(torch.isfinite(dec).all())
            and all(len(o) == len(f_out) for o in t_outs)
            and max(blocks) <= BLOCK_RTOL["float32"],
            f"{tag}: decode != forward block by block: {max(blocks):.3g}")
    require(rel <= max(FWD_RTOL, WITNESS_FACTOR * witness),
            f"{tag}: decode != forward end to end: {rel:.3g}")
    require(slow > 0, f"{tag}: no page in the slow tier")
    return dict(rel=rel, witness=witness, blocks=blocks, moves=moves,
                slow=slow)


def k7_cross_numbers(torch, F, FA, FA_REF, H, K, D, Sq, Skv) -> dict:
    """K7 on a full-attention call of one shape (cross-attention, Sq !=
    Skv, or an encoder's Sq = Skv), B=1, bf16 inputs: agreement with the
    plain version (on the last query rows whose scores fit
    ``PATH_SCORES``), its time, the plain version's (where its [H, Sq,
    Skv] float32 scores fit ``PLAIN_SCORES_BYTES``), non-causal SDPA's and
    the bound over all Sq x Skv pairs."""
    g = torch.Generator(device="cuda").manual_seed(34)
    q = torch.randn((1, H, Sq, D), generator=g, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((1, K, Skv, D), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    out = FA.flash_attention(q, k, v, causal=False)
    tail = min(Sq, PATH_SCORES // (H * Skv))
    want = FA_REF.flash_attention_ref(q[:, :, -tail:], k, v, causal=False)
    err = float((out[:, :, -tail:].float() - want.float()).abs().max())
    require(torch.allclose(out[:, :, -tail:].float(), want.float(),
                           atol=K7_TOL["bfloat16"], rtol=K7_TOL["bfloat16"]),
            f"K7 cross H={H} K={K} D={D} Sq={Sq} Skv={Skv}: max err {err}")
    del want
    n = 10 if Sq <= PREFILL_S else 3
    t_bytes = 2 * (2 * H * Sq * D + 2 * K * Skv * D) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * H * D * Sq * Skv / BF16_OPS_PER_S * 1e3
    plain = None
    if 4 * H * Sq * Skv <= PLAIN_SCORES_BYTES:
        plain = device_ms(lambda: FA_REF.flash_attention_ref(
            q, k, v, causal=False), n=3)
    return dict(H=H, K=K, D=D, Sq=Sq, Skv=Skv, err=err, tail=tail,
                ms=device_ms(lambda: FA.flash_attention(q, k, v,
                                                        causal=False), n=n),
                plain_ms=plain,
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, enable_gqa=True), n=n),
                library_form="non-causal GQA",
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def cross_phases(torch, np, env: dict) -> dict:
    """Phases 32-34: whisper-tiny at full width and depth, Llama 3.2 Vision
    at full width and depth ``VISION_DEPTH`` in bf16 weights, each with its
    gates and biases opened and freed before the next; then K7's cross and
    encoder shapes. Returns {"serve": {label: numbers}, "prefill":
    [labels], "fwd": {...}, "k7": [...]} for the kernels' record."""
    import dataclasses
    from repro_torch.configs import (get_config, get_serve_load,
                                     reduced_depth_config)
    make_model, prefill_cell = env["make_model"], env["prefill_cell"]
    res: dict = {"serve": {}, "prefill": [], "fwd": {}, "k7_calls": {}}

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # ---- 32. whisper-tiny: serving (S8), prefill (P9), decode == forward --
    free()
    model = make_model(get_config(WHISPER), seed=0, device="cuda")
    wcfg = model.cfg
    n_open = open_gates(torch, np, model, seed=32)
    phase("32-encdec", f"{wcfg.name}: {wcfg.encoder_layers} encoder and "
          f"{wcfg.num_layers} decoder layers, d={wcfg.d_model}, "
          f"{n_parameters(model):,} parameters ({wcfg.param_dtype}), "
          f"{n_open:,} bias values opened")
    B, steps = get_serve_load(WHISPER)
    # whisper's random model carries a last-bit difference to every output
    # (the witnesses printed beside each run), so its serving and prefill
    # are held block by block, their end-to-end logits printed
    res["serve"]["S8 whisper"] = serve_cell(
        torch, np, env, model, batch=B, steps=steps, seed=32,
        tag="32-encdec-serve", need_moves=True, layered=True,
        cross=cross_kv(torch, env, model, encoder_input(torch, np, wcfg, B)))
    prefill_cell(model, "whisper", tag="32-encdec-prefill", layered=True,
                 extra=functools.partial(encoder_input, torch, np, wcfg))
    res["prefill"].append("whisper")
    res["k7_calls"]["whisper"] = wcfg.encoder_layers + 2 * wcfg.num_layers
    res["fwd"]["whisper"] = cross_decode_forward(
        torch, np, env, model, "32-encdec-forward")
    del model
    free()

    # ---- 33. Llama 3.2 Vision at depth 10, bf16 weights (S9, P10) ---------
    vcfg = dataclasses.replace(reduced_depth_config(VISION, VISION_DEPTH),
                               param_dtype="bfloat16")
    model = make_model(vcfg, seed=0, device="cuda")
    n_open = open_gates(torch, np, model, seed=33)
    phase("33-vlm", f"{vcfg.name} at depth {vcfg.num_layers} of 100 "
          f"({vcfg.num_layers // vcfg.cross_attn_every} units of "
          f"{vcfg.cross_attn_every - 1} self + 1 gated cross layer), "
          f"d={vcfg.d_model}, {n_parameters(model):,} parameters "
          f"(bf16), {n_open} gates opened; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # the stacked init's std of 1/sqrt(units) per weight (0.71 at two
    # units) puts scores in the thousands, as Mixtral's depth 8 does: K7
    # on the path is held to K7_TOL of each output's max |value| (phase 28)
    prefill_cell(model, "vlm", tag="33-vlm-prefill", batch=1, scaled=True,
                 tail=path_tail(vcfg),
                 extra=functools.partial(encoder_input, torch, np, vcfg))
    res["prefill"].append("vlm")
    res["k7_calls"]["vlm"] = vcfg.num_layers      # self and cross layers
    B, steps = get_serve_load(VISION)
    res["serve"]["S9 vlm"] = serve_cell(
        torch, np, env, model, batch=B, steps=steps, seed=33,
        tag="33-vlm-serve", k5_scaled=True, cross=cross_kv(
            torch, env, model, encoder_input(torch, np, vcfg, B)))
    res["fwd"]["vlm"] = cross_decode_forward(torch, np, env, model,
                                             "33-vlm-forward")
    del model
    free()

    # ---- 34. K7's cross-attention and encoder shapes ----------------------
    F, FA, FA_REF = env["F"], env["FA"], env["FA_REF"]
    shapes = []
    for arch in (WHISPER, VISION):
        c = get_config(arch)
        skv = c.encoder_seq if c.family == "encdec" else c.num_image_tokens
        for sq in CROSS_SQ:
            shapes.append((arch, c.num_heads, c.num_kv_heads,
                           c.resolved_head_dim, sq, skv))
    c = get_config(WHISPER)
    shapes.append((f"{WHISPER} encoder", c.num_heads, c.num_kv_heads,
                   c.resolved_head_dim, c.encoder_seq, c.encoder_seq))
    k7 = []
    for label, H, K, D, sq, skv in shapes:
        r = k7_cross_numbers(torch, F, FA, FA_REF, H, K, D, sq, skv)
        r["arch"] = label
        k7.append(r)
        plain = ("not measured (its [H, Sq, Skv] float32 scores)"
                 if r["plain_ms"] is None else f"{r['plain_ms']:.4f}")
        phase("34-k7-cross", f"flash_attention [{label} H={H} K={K} D={D}, "
              f"B=1 Sq={sq} Skv={skv}, bf16, non-causal]: {r['ms']:.4f} ms "
              f"(plain {plain}, library {r['library_ms']:.4f} (SDPA, "
              f"{r['library_form']}), bound {r['bound_ms']:.5f} "
              f"({r['bound_by']})); max abs err {r['err']:.3g} over the "
              f"last {r['tail']} query rows")
        free()
    res["k7"] = k7
    return res


def record_cross(rows: list, res: dict, prefill_rows: dict,
                 checks: list) -> None:
    """Phases 32-33's path checks (each within its bound: every K7 kind of
    each prefill, at S=4,096 in bf16 and f32 and at S=32,768) and launch
    counts (K7 once per encoder, self and cross layer), and the new paths'
    launches and widths on the kernels' rows."""
    for r in checks:
        phase("32-33-prefill-path", f"{r['label']}: {r['what']}: max abs "
              f"err {r['err']:.3g}, {r['share']:.3g} of the bound (atol "
              f"{r['atol']}, rtol {r['rtol']})")
        require(r["share"] <= 1.0, f"{r['label']} {r['what']}: max abs err "
                                   f"{r['err']:.3g} exceeds the bound")
    # whisper: encoder (full), decoder self (causal) and cross; the vlm:
    # self (causal) and cross; three runs each
    require(len(checks) == 3 * 3 + 3 * 2, f"cross path checks: "
                                          f"{len(checks)} readings")
    for label, n in res["k7_calls"].items():
        got = prefill_rows[label]["launches"]
        require(got == {"flash_attention": n, "ssd_scan": 0},
                f"{label} prefill launches {got}, want {n} K7 calls")
    by_name = {r["name"]: r for r in rows if "kernel" not in r}
    for label, sv in res["serve"].items():
        for k in ("pool_attention_partial", "migrate_pages"):
            by_name[k].setdefault("family_launches", {})[label] = \
                sv["launches"][k]
            wk = "k5" if k == "pool_attention_partial" else "k6"
            by_name[k].setdefault("family_widths", {})[label] = {
                f: sv[wk][f] for f in ("ms", "plain_ms", "library_ms",
                                       "bound_ms")}
    fa = by_name["flash_attention"]
    for label in res["prefill"]:
        fa.setdefault("family_launches", {})[f"prefill {label}"] = \
            prefill_rows[label]["launches"]["flash_attention"]
    fa["cross_shapes"] = res["k7"]
    fa["max_abs_err"] = max([fa["max_abs_err"]]
                            + [r["err"] for r in res["k7"]])


# ------------------------------------------------------ phases 35-37 ----
TRAIN_ARCH, SSM_TRAIN_ARCH = "llama32_1b", "mamba2_130m"
TRAIN_B, SSM_TRAIN_B = 2, 8         # train_4k's global batch of 256, cut
TRAIN_S = 4096                      # train_4k's sequence length
TRAIN_STEPS = 6                     # on one repeated batch
TRAIN_LR = 1e-3
FT_EVERY, FT_FAIL_AT = 2, 3         # phase 37: checkpoint period, failure
# phase 37's one-step families: (arch, depth (0: full), batch, sequence)
SIDE_TRAIN = (("zamba2_7b", 6, 1, 2048),
              ("granite_moe_3b_a800m", 4, 1, 2048),
              ("whisper_tiny", 0, 2, 4096))
# phase 35: each gradient through the Function (K7/K8 forward, the plain
# backward) vs autograd of the plain version, relative to its max |value|,
# by the gradient's dtype; the loss 0.5 |out|^2 + <out, g> makes the
# incoming gradient depend on the forward, so the forward's error shows
GRAD35_TOL = {"torch.float32": 1e-3, "torch.bfloat16": 2e-2}
# cuda vs ref, one step's loss and gradients from the same state: float32
# (loss relative; every gradient leaf relative to its max |value|) and bf16
# (loss and global gradient norm, relative). Fixed from the readings of
# NVIDIA H100 80GB HBM3 runs (PERF.md §6): mamba2-130m 1.4e-5,
# Zamba2-7B 4.8e-5, held at 1e-2. Those runs had K7's f32 route sum in the
# plain version's order (a CUDA-core kernel); the tf32x3 kernel parts from
# it at the last bit, which the random dense, moe and encdec models carry
# as far as a one-ulp change of their input (the witness, printed beside):
# on NVIDIA H100 80GB HBM3, 700 W (PERF.md §6) Llama 3.2 1B at depth
# 2 reads a worst leaf of 0.0419 beside the witness's 0.0594, granite at
# depth 4 3.4 beside 3.39 (its cross-entropy nearly one-hot: median top
# probability 0.998), whisper 10.6 beside 1.38. End to end no bound tells
# a wrong gradient from that, so these three hold their leaves block by
# block (``block_grads``: each block fed the ref run's input and output
# gradient, BLOCK_GRAD_RTOL; read 1.9e-4, 1.7e-4, 8.5e-4) and their loss
# end to end: Llama's and granite's at TRAIN_F32_TOL (read 0 and 9.3e-6,
# granite's cuda step taking the ref step's expert picks and gates,
# ``held_routing``: its own picks part on near ties, 8.7e-5 free),
# whisper's at ENCDEC_LOSS_TOL (read 3.24e-5 with the CUDA-core kernel,
# 9.57e-5 with the tf32x3 kernel)
TRAIN_F32_TOL = {"loss": 1e-5, "grad": 1e-2}
ENCDEC_LOSS_TOL = 1e-4
TRAIN_BF16_TOL = {"loss": 1e-2, "grad_norm": 5e-2}
K7_TRAIN_SHAPES = (   # (label, B, H, K, Sq, Skv, D, dtype, causal, window)
    ("llama32_1b", 2, 32, 8, 4096, 4096, 64, "bfloat16", True, None),
    ("zamba2 D=112", 1, 32, 32, 4096, 4096, 112, "bfloat16", True, None),
    ("danube D=120 f32", 1, 32, 8, 4096, 4096, 120, "float32", True, 4096),
    ("window 4096", 1, 32, 8, 6144, 6144, 64, "bfloat16", True, 4096),
    ("whisper encoder", 2, 6, 6, 1500, 1500, 64, "bfloat16", False, None),
    ("whisper cross", 2, 6, 6, 4096, 1500, 64, "bfloat16", False, None))


def grad_readings(torch, got: list, want: list, names: str) -> dict:
    """{name: max |got - want| / max |want|} of each gradient."""
    out = {}
    for n, g, w in zip(names, got, want):
        out[n] = float((g.float() - w.float()).abs().max()
                       / w.float().abs().max().clamp_min(1e-30))
        require(bool(torch.isfinite(g).all()), f"gradient {n} not finite")
        require(out[n] <= GRAD35_TOL[str(g.dtype)],
                f"gradient {n}: {out[n]:.3g} of its scale")
    return out


def fwd_bwd_ms(torch, fn, ins: list, grads) -> float:
    """Device ms of one forward and backward of ``fn`` on ``ins`` against
    the incoming ``grads``."""
    def run():
        out = fn(*ins)
        torch.autograd.grad(out, ins, grads)
    return device_ms(run, n=3)


def k7_grad_case(torch, F, FA, FA_REF, case) -> dict:
    label, B, H, K, Sq, Skv, D, dt, causal, window = case
    dtype = getattr(torch, dt)
    g = torch.Generator(device="cuda").manual_seed(35)
    base = [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((B, H, Sq, D), (B, K, Skv, D), (B, K, Skv, D))]
    do = torch.randn((B, H, Sq, D), generator=g, device="cuda").to(dtype)

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in base]
        out = fn(*ins, causal=causal, window=window)
        of = out.float()
        ((of * do.float()).sum() + 0.5 * (of * of).sum()).backward()
        return out.detach(), [t.grad for t in ins]

    out, got = run(FA.flash_attention)
    want, wgrads = run(FA_REF.flash_attention_ref)
    err = float((out.float() - want.float()).abs().max())
    require(err <= K7_TOL[dt] * max(1.0, float(want.float().abs().max())),
            f"35 K7 {label}: forward max err {err}")
    rel = grad_readings(torch, got, wgrads, "qkv")
    del got, wgrads, want
    ins = [t.clone().requires_grad_(True) for t in base]
    kw = dict(causal=causal, window=window)
    ms = fwd_bwd_ms(torch, lambda *a: FA.flash_attention(*a, **kw), ins, do)
    plain = fwd_bwd_ms(torch, lambda *a: FA_REF.flash_attention_ref(
        *a, **kw), ins, do)
    lib = None
    if window is None:
        lib = fwd_bwd_ms(torch, lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=causal, enable_gqa=H != K), ins, do)
    pairs = (Sq * Skv if not causal else
             (lambda w: w * (w + 1) // 2 + (Sq - w) * w)(
                 Sq if window is None else min(window, Sq)))
    return dict(label=label, shape=f"B={B} H={H} K={K} Sq={Sq} Skv={Skv} "
                f"D={D} {dt} causal={causal} window={window}", err=err,
                grad_rel=rel, fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain,
                library_fwd_bwd_ms=lib, B=B, H=H, K=K, S=Sq, D=D,
                pairs=pairs, base=base if label == TRAIN_ARCH else None)


def k8_grad_case(torch, F, SSD, SSD_REF, cfg, B: int, S: int) -> dict:
    s = cfg.ssm
    H, P, N, G, Q = (s.expand * cfg.d_model // s.head_dim, s.head_dim,
                     s.state_dim, s.ngroups, s.chunk_size)
    g = torch.Generator(device="cuda").manual_seed(36)
    base = [torch.randn((B, S, H, P), generator=g, device="cuda") * 0.5,
            -F.softplus(torch.randn((B, S, H), generator=g, device="cuda")
                        * 1.2)]
    base += [(torch.randn((B, S, G, N), generator=g, device="cuda") * 0.5
              ).to(torch.bfloat16) for _ in range(2)]
    gy = torch.randn((B, S, H, P), generator=g, device="cuda")
    gh = torch.randn((B, H, P, N), generator=g, device="cuda")

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in base]
        y, h = fn(*ins)
        ((y * gy).sum() + 0.5 * (y * y).sum() + (h * gh).sum()).backward()
        return y.detach(), [t.grad for t in ins]

    y, got = run(lambda *a: SSD.ssd_scan(*a, chunk=Q))
    yr, wgrads = run(lambda *a: SSD_REF.ssd_scan_ref(*a, Q))
    err = float((y - yr).abs().max())
    require(err <= 1e-3 * float(yr.abs().max()), f"35 K8: forward {err}")
    rel = grad_readings(torch, got, wgrads, "xabc")
    del got, wgrads
    ins = [t.clone().requires_grad_(True) for t in base]
    ms = fwd_bwd_ms(torch, lambda *a: SSD.ssd_scan(*a, chunk=Q), ins,
                    (gy, gh))
    plain = fwd_bwd_ms(torch, lambda *a: SSD_REF.ssd_scan_ref(*a, Q), ins,
                       (gy, gh))
    return dict(label=cfg.name, shape=f"B={B} S={S} H={H} P={P} N={N} "
                f"G={G} chunk {Q}", err=err, grad_rel=rel, fwd_bwd_ms=ms,
                plain_fwd_bwd_ms=plain, library_fwd_bwd_ms=None, B=B, S=S,
                H=H, P=P, N=N, G=G, Q=Q, base=base)


@contextlib.contextmanager
def held_routing(torch, LAYERS, probs: list, top_k: int, mode: str,
                 flips: list):
    """While active, every ``layers._router`` call, in call order: with
    ``mode`` "record", appends its probabilities to ``probs``; "hold",
    returns the entry of ``probs`` of the same call in place of its own
    value, its gradient still flowing through its own (the run takes the
    recorded run's expert picks and gates); "count", keeps its own. "hold"
    and "count" append to ``flips`` the tokens whose own top-``top_k``
    experts differ from the recorded ones."""
    n = [0]

    def make(f):
        def router(p, x):
            pr = f(p, x)
            if mode == "record":
                probs.append(pr.detach())
                return pr
            require(n[0] < len(probs), "held_routing: more router calls "
                                       "than the recorded run made")
            want = probs[n[0]]
            n[0] += 1
            with torch.no_grad():
                own, rec = (t >= t.topk(top_k, dim=-1).values[..., -1:]
                            for t in (pr, want))
                flips.append(int((own != rec).any(-1).sum()))
            return want + (pr - pr.detach()) if mode == "hold" else pr
        return router

    with patched(LAYERS, "_router", make):
        yield
    require(mode == "record" or n[0] == len(probs),
            f"held_routing: {n[0]} router calls, the recorded run made "
            f"{len(probs)}")


def grads_at(torch, STEP, model, tc, batch, impl: str, keep: bool,
             step=None) -> dict:
    """One loss and backward of ``model`` on ``batch``: {"loss", "aux",
    "norm" (the global gradient norm), "grads" (clones, with ``keep``)}.
    With ``step`` (a ``make_train_step`` step) the train step runs, its
    update included, and the gradients read are its own; else the
    parameters' ``.grad`` are cleared after."""
    from repro_torch.optim.adamw import global_norm, init_opt_state
    model.requires_grad_(True)
    if step is not None:
        _, metrics = step(model, init_opt_state(model), batch)
        loss, aux = metrics["loss"], metrics["moe_aux"]
    else:
        for p in model.parameters():
            p.grad = None
        loss, ex = STEP.make_loss_fn(model.cfg, tc, impl=impl)(model, batch)
        loss.backward()
        aux = ex["moe_aux"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    out = {"loss": float(loss.detach()), "aux": float(aux.detach()),
           "norm": float(global_norm(grads)),
           "grads": {n: g.clone() for n, g in grads.items()} if keep
           else None}
    if step is None:
        for p in model.parameters():
            p.grad = None
    return out


def ulp_witness(torch, model, fn):
    """``fn()`` with every embedding value one unit in the last place of
    the compute dtype off (the weights restored after)."""
    from repro_torch.models.params import dtype_of
    tok = model.embed["tok"]
    saved = tok.detach().clone()
    with torch.no_grad():
        tok.copy_(one_ulp(torch, tok.to(dtype_of(model.cfg.dtype))))
    try:
        return fn()
    finally:
        with torch.no_grad():
            tok.copy_(saved)


def step_diff(a: dict, b: dict) -> dict:
    """Loss and gradient-norm differences of two ``grads_at`` results,
    relative to ``b``'s, and, where both kept their gradients, each leaf's
    worst difference relative to its max |value| (``errs``) and the worst
    leaf."""
    out = {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
           "norm": abs(a["norm"] - b["norm"]) / b["norm"]}
    if a["grads"] is None or b["grads"] is None:
        return out
    out["errs"] = {n: _rel(g, b["grads"][n]) for n, g in a["grads"].items()}
    out["grad"], out["leaf"] = max((e, n) for n, e in out["errs"].items())
    return out


def format_diff(d: dict) -> str:
    s = f"loss {d['loss']:.3g}, grad norm {d['norm']:.3g}"
    if "grad" in d:
        s += f", worst leaf {d['grad']:.3g} ({d['leaf']})"
    return s


def format_bounds() -> str:
    return f"loss {TRAIN_F32_TOL['loss']}, leaf {TRAIN_F32_TOL['grad']}"


def hold_step(tag: str, d: dict, f32: bool) -> None:
    """cuda vs ref (``d``): float32 holds the loss and every leaf
    (``TRAIN_F32_TOL``); bf16 the loss and the gradient norm
    (``TRAIN_BF16_TOL``)."""
    if f32:
        over = [n for n, e in d["errs"].items() if e > TRAIN_F32_TOL["grad"]]
        require(d["loss"] <= TRAIN_F32_TOL["loss"] and not over,
                f"{tag}: cuda vs ref {format_diff(d)}; leaves over their "
                f"bound {over}")
    else:
        require(d["loss"] <= TRAIN_BF16_TOL["loss"]
                and d["norm"] <= TRAIN_BF16_TOL["grad_norm"],
                f"{tag}: cuda vs ref {format_diff(d)}")


def logit_grad_diff(torch, TF, model, batch) -> str:
    """Where the cuda and the ref forward part, token by token: each
    token's logits relative to the ref's max |logit|, and the
    cross-entropy's gradient at the logits (softmax minus one-hot): the
    tokens whose largest logit moved and the largest swing of one token's
    gradient. A few tokens far apart and the rest at float32 rounding
    is a saturated softmax (or argmax) swapping its peak on those tokens."""
    with torch.no_grad():
        c, r = (TF.model_forward(model, batch, impl=i).float()
                for i in ("cuda", "ref"))
        tok = ((c - r).abs().amax(-1) / r.abs().amax()).flatten()
        swing = (c.softmax(-1) - r.softmax(-1)).abs().amax(-1).flatten()
        moved = int((c.argmax(-1) != r.argmax(-1)).sum())
        top = float(r.softmax(-1).amax(-1).median())
    del c, r
    return (f"; cuda vs ref forward per token of {tok.numel()}: logits "
            f"median {float(tok.median()):.3g}, worst {float(tok.max()):.3g}"
            f", {int((tok > 1e-3).sum())} above 1e-3; the loss's gradient "
            f"at the logits: {moved} tokens' largest logit moved, largest "
            f"swing {float(swing.max()):.3g}, {int((swing > 1e-3).sum())} "
            f"above 1e-3 (median top probability {top:.3g})")


def cuda_vs_ref(torch, STEP, model, tc, batch, tag: str, f32: bool,
                blocks=None) -> dict:
    """Phase 36/37's comparison: the cuda and ref steps' loss and gradients
    from the same state, beside the ref step with the embedding one ulp
    off; float32 holds every leaf, bf16 the loss and the gradient norm.
    With ``blocks`` (``block_grads``'s arguments after the model), a
    float32 step's leaves are held block by block instead, its loss end to
    end."""
    c = grads_at(torch, STEP, model, tc, batch, "cuda", keep=f32)
    r = grads_at(torch, STEP, model, tc, batch, "ref", keep=f32)
    w = ulp_witness(torch, model, lambda: grads_at(
        torch, STEP, model, tc, batch, "ref", keep=f32))
    d, wd = step_diff(c, r), step_diff(w, r)
    extra = ""
    if blocks is None:
        hold_step(tag, d, f32)
        bounds = format_bounds() if f32 else str(TRAIN_BF16_TOL)
    else:
        bl = block_grads(torch, *blocks[:3], model, tc, batch, tag)
        require(d["loss"] <= TRAIN_F32_TOL["loss"],
                f"{tag}: cuda vs ref loss {d['loss']:.3g} > "
                f"{TRAIN_F32_TOL['loss']}")
        bounds = f"loss {TRAIN_F32_TOL['loss']}, leaves block by block"
        extra = "; " + format_blocks(bl)
    phase(tag, f"{model.cfg.name} depth {model.cfg.num_layers} "
          f"{model.cfg.dtype}: cuda vs ref {format_diff(d)} (bounds "
          f"{bounds}); one-ulp witness {format_diff(wd)}; loss cuda "
          f"{c['loss']:.6f} ref {r['loss']:.6f}{extra}")
    return {"diff": d, "witness": wd, "loss": c["loss"]}


def require_grads(torch, model, tag: str) -> None:
    for n, p in model.named_parameters():
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"{tag}: {n} has no finite gradient")


def profile_train_step(torch, STEP, fn_cls, step, model, opt, batch, tag,
                       cls_name, cls_keys, what) -> dict:
    """One more train step under torch.profiler, with ``fn_cls``'s backward
    (the plain version's recompute and gradient) and the AdamW update
    bracketed by CUDA events: {"span_ms": {"backward", "adamw"},
    "profile": busy, wall, idle share, device ms by class}."""
    spans: dict = {"backward": [], "adamw": []}

    def timed(key, fn):
        def run(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[key].append((s, e))
            return out
        return run

    bwd = fn_cls.backward
    fn_cls.backward = staticmethod(timed("backward", bwd))
    try:
        with patched(STEP, "adamw_update", lambda f: timed("adamw", f)):
            prof = profile_fn(torch, lambda: step(model, opt, batch))
    finally:
        fn_cls.backward = staticmethod(bwd)
    span_ms = {k: sum(s.elapsed_time(e) for s, e in v)
               for k, v in spans.items()}
    out = {"span_ms": span_ms}
    if prof is None:
        phase(tag, "device time not measured: the profiler saw no device "
                   "event")
        return out
    n_dev, busy, top, wall = prof
    by_cls = class_ms(top, ((cls_name, cls_keys),
                            ("matmul bf16", ("bf16",)),
                            ("matmul f32", ("gemm", "cutlass", "xmma",
                                            "sm90_", "sgemm"))))
    out["profile"] = dict(busy_ms=busy, wall_ms=wall, idle=1 - busy / wall,
                          by_class={k: v[0] for k, v in by_cls.items()})
    phase(tag, f"one step: {n_dev} device events, busy {busy:.1f} of "
          f"{wall:.1f} ms wall (idle share {1 - busy / wall:.4f}); {what} "
          f"{span_ms['backward']:.1f} ms, AdamW {span_ms['adamw']:.1f} ms "
          f"(CUDA events); device ms by class: {format_classes(by_cls)}; "
          "top: " + "; ".join(f"{nm[:48]} {t:.1f} ms x{cnt}"
                              for nm, t, cnt in top[:8]))
    return out


BLOCK_GRAD_RTOL = 1e-3    # a block's gradients fed the ref run's input


def block_grads(torch, TF, LAYERS, STEP, model, tc, batch, tag) -> dict:
    """A float32 step's gradients block by block: the ref run (remat
    "none") records each block's input, the encoder's output (encdec) and
    the gradients arriving at the block's outputs (a moe block's aux loss
    too); then every block runs forward and backward again from that input
    against those gradients with impl "cuda" and "ref", and each of its
    gradients (its parameters', its input's and, for an encdec decoder
    block, the encoder output's) is held within ``BLOCK_GRAD_RTOL`` of the
    ref one's max |value|. A moe block's cuda run takes the ref run's
    expert picks and gates (``held_routing``); the tokens whose own picks
    differ are counted. A zeroed and a halved gradient of each block's
    attention and expert weights are read as well, and must fail the bound.
    {"worst": (err, where), "blocks": n, "flips": n, "planted": {...}}."""
    import dataclasses
    cfg = model.cfg
    names = (("encoder_block", "encdec_dec_block") if cfg.family == "encdec"
             else ("decoder_block",))
    k = cfg.moe.top_k if cfg.family == "moe" else 1
    origs = {n: getattr(TF, n) for n in names}
    orig_enc = TF.encode_frames
    rec, g_out, enc_box = [], {}, []

    def capture(name):
        def block(p, x, *args, **kwargs):
            out = origs[name](p, x, *args, **kwargs)
            j = len(rec)
            rec.append((name, sum(r[0] == name for r in rec),
                        x.detach().clone()))
            for m, t in enumerate(out if isinstance(out, tuple) else (out,)):
                if t.requires_grad:
                    t.register_hook(lambda g, j=j, m=m: g_out.__setitem__(
                        (j, m), g.detach().clone()))
            return out
        return block

    def encode(*a, **kw):
        out = orig_enc(*a, **kw)
        enc_box.append(out.detach().clone())
        return out

    for n in names:
        setattr(TF, n, capture(n))
    TF.encode_frames = encode
    try:
        model.requires_grad_(True)
        for p in model.parameters():
            p.grad = None
        loss, _ = STEP.make_loss_fn(cfg, dataclasses.replace(
            tc, remat_policy="none"), impl="ref")(model, batch)
        loss.backward()
    finally:
        for n, f in origs.items():
            setattr(TF, n, f)
        TF.encode_frames = orig_enc
        for p in model.parameters():
            p.grad = None
    positions = TF._positions(batch["tokens"])

    def leaves_of(tree, path, out):
        res = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                res[key] = leaves_of(v, f"{path}{key}.", out)
            else:
                t = v.detach().clone().requires_grad_(True)
                out.append((f"{path}{key}", t))
                res[key] = t
        return res

    def run(j, impl):
        name, i, x = rec[j]
        leaves = []
        src = (model.encoder_layer(i) if name == "encoder_block"
               else model.layer(i))
        p = leaves_of(src, "", leaves)
        xin = x.clone().requires_grad_(True)
        leaves.append(("x", xin))
        if name == "encoder_block":
            out = origs[name](p, xin, cfg, impl)
        elif name == "encdec_dec_block":
            e = enc_box[0].clone().requires_grad_(True)
            leaves.append(("enc", e))
            out = origs[name](
                p, xin, cfg,
                lambda pp, a: LAYERS.self_attention(
                    pp, a, cfg, positions, causal=True, impl=impl),
                lambda pp, a: LAYERS.cross_attention(pp, a, e, cfg,
                                                     impl=impl))
        else:
            out = origs[name](p, xin, cfg, positions, impl)
        outs = out if isinstance(out, tuple) else (out,)
        ms = [m for m in range(len(outs)) if (j, m) in g_out]
        grads = torch.autograd.grad([outs[m] for m in ms],
                                    [t for _, t in leaves],
                                    [g_out[(j, m)] for m in ms])
        return {n: g for (n, _), g in zip(leaves, grads)}

    worst, flips, planted = (0.0, ""), [], {}
    for j, (name, i, _) in enumerate(rec):
        probs = []
        with held_routing(torch, LAYERS, probs, k, "record", flips):
            r = run(j, "ref")
        with held_routing(torch, LAYERS, probs, k, "hold", flips):
            c = run(j, "cuda")
        for n, w in r.items():
            worst = max(worst, (_rel(c[n], w), f"{name} {i} {n}"))
            if n.endswith(("attn.wq", "moe.wu")):
                for what, f in (("zeroed", 0.0), ("halved", 0.5)):
                    err = _rel(c[n] * f, w)
                    planted[f"{n} {what}"] = min(
                        planted.get(f"{n} {what}", err), err)
    require(worst[0] <= BLOCK_GRAD_RTOL,
            f"{tag} {cfg.name} blocks: worst gradient {worst}")
    require(planted and min(planted.values()) > BLOCK_GRAD_RTOL,
            f"{tag} {cfg.name} blocks: a planted wrong gradient passes "
            f"{planted}")
    return {"worst": worst, "blocks": len(rec), "flips": sum(flips),
            "moe": cfg.family == "moe", "planted": planted}


def format_blocks(b: dict) -> str:
    return (f"held block by block ({b['blocks']} blocks fed the ref run's "
            f"input and output gradients"
            + (f" and expert picks: {b['flips']} tokens' own picks differ"
               if b["moe"] else "")
            + f"): worst gradient {b['worst'][0]:.3g} ({b['worst'][1]}), "
            f"bound {BLOCK_GRAD_RTOL}; planted wrong gradients read "
            + ", ".join(f"{n} {e:.3g}" for n, e in b["planted"].items()))


def train_phases(torch, np, env: dict) -> dict:
    """Phases 35-37: K7's and K8's gradients; Llama 3.2 1B trained at full
    width and depth; mamba2-130m trained under the fault-tolerant driver;
    one step each of Zamba2-7B, granite-moe and whisper-tiny. Returns the
    numbers for the kernels' record."""
    import dataclasses
    import itertools
    import shutil
    import tempfile
    from repro_torch.checkpoint import sharded as CKPT
    from repro_torch.configs import get_config, reduced_depth_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLoader, synthetic_batch
    from repro_torch.ft.driver import FTConfig, TrainDriver
    from repro_torch.launch.dryrun import cell_bytes, format_cell
    from repro_torch.configs import ARCH_IDS
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train import step as STEP
    F, FA, FA_REF = env["F"], env["FA"], env["FA_REF"]
    SSD, SSD_REF, LAYERS = env["SSD"], env["SSD_REF"], env["LAYERS"]
    make_model = env["make_model"]
    res: dict = {}

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # ---- 35. K7 and K8 gradients ------------------------------------------
    free()
    k7 = []
    for case in K7_TRAIN_SHAPES:
        r = k7_grad_case(torch, F, FA, FA_REF, case)
        k7.append(r)
        lib = ("none" if r["library_fwd_bwd_ms"] is None
               else f"{r['library_fwd_bwd_ms']:.3f}")
        phase("35-k7-grad", f"{r['label']} [{r['shape']}]: forward max abs "
              f"err {r['err']:.3g}; gradients vs plain autograd, relative "
              f"to each one's max: " + ", ".join(
                  f"d{k} {v:.3g}" for k, v in r["grad_rel"].items())
              + f"; forward + backward {r['fwd_bwd_ms']:.3f} ms (plain "
              f"{r['plain_fwd_bwd_ms']:.3f}, SDPA {lib})")
        free()
    scfg = get_config(SSM_TRAIN_ARCH)
    k8 = k8_grad_case(torch, F, SSD, SSD_REF, scfg, SSM_TRAIN_B, TRAIN_S)
    phase("35-k8-grad", f"{k8['label']} [{k8['shape']}, b/c bf16]: forward "
          f"max abs err {k8['err']:.3g}; gradients vs plain autograd: "
          + ", ".join(f"d{k} {v:.3g}" for k, v in k8["grad_rel"].items())
          + f"; forward + backward {k8['fwd_bwd_ms']:.3f} ms (plain "
          f"{k8['plain_fwd_bwd_ms']:.3f})")
    # the train shapes' forwards alone, for the kernels' rows
    q, k, v = k7[0].pop("base")
    k7[0].update(ms=device_ms(lambda: FA.flash_attention(q, k, v), n=10),
                 plain_ms=device_ms(lambda: FA_REF.flash_attention_ref(
                     q, k, v), n=3),
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True, enable_gqa=True), n=10))
    x, a, b, c = k8.pop("base")
    k8.update(ms=device_ms(lambda: SSD.ssd_scan(x, a, b, c, chunk=k8["Q"]),
                           n=10),
              plain_ms=device_ms(lambda: SSD_REF.ssd_scan_ref(
                  x, a, b, c, k8["Q"]), n=3), library_ms=None)
    for r in k7:
        r.pop("base", None)
    res["k7"], res["k8"] = k7, k8
    del q, k, v, x, a, b, c
    free()

    # ---- 36. Llama 3.2 1B at full width and depth -------------------------
    cfg = get_config(TRAIN_ARCH)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1, total_steps=20,
                     remat_policy="block")
    model = make_model(cfg, seed=0, device="cuda")
    n_params = n_parameters(model)
    batch = next(SyntheticLoader(cfg, TRAIN_B, TRAIN_S, seed=0,
                                 device="cuda"))
    res["llama_bf16"] = cuda_vs_ref(torch, STEP, model, tc, batch,
                                    "36-train-cmp", f32=False)
    opt = init_opt_state(model)
    step = STEP.make_train_step(cfg, tc, device="cuda")
    times: list = []

    def step_fn(state, b):
        m, o = state
        t0 = time.perf_counter()
        o, metrics = step(m, o, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return (m, o), metrics

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        FA.flash_attention.launches = 0
        SSD.ssd_scan.launches = 0
        drv = TrainDriver(step_fn, FTConfig(checkpoint_dir=ckdir,
                                            checkpoint_every=10 ** 9))
        (model, opt), logs = drv.run((model, opt), itertools.repeat(batch),
                                     num_steps=TRAIN_STEPS)
        launches = {"flash_attention": FA.flash_attention.launches,
                    "ssd_scan": SSD.ssd_scan.launches}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in logs]
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"36: loss not falling {losses}")
    require_grads(torch, model, "36")
    want = {"flash_attention": 2 * cfg.num_layers * TRAIN_STEPS,
            "ssd_scan": 0}
    require(launches == want, f"36: launches {launches}, want {want}")
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    attn = 3 * cfg.num_layers * 4 * TRAIN_B * cfg.num_heads * \
        cfg.resolved_head_dim * TRAIN_S * (TRAIN_S + 1) // 2
    flops = 6 * n_params * tokens + attn
    mfu = flops / step_s / BF16_OPS_PER_S
    res["llama"] = dict(losses=losses, step_ms=step_s * 1e3,
                        tokens_per_s=tokens / step_s, mfu=mfu,
                        model_flops=flops, peak_bytes=peak,
                        launches=launches, params=n_params,
                        steps_ms=[t * 1e3 for t in times])
    phase("36-train", f"{cfg.name}: {cfg.num_layers} layers, {n_params:,} "
          f"parameters (f32 masters, bf16 compute), B={TRAIN_B} "
          f"S={TRAIN_S}, remat block, {TRAIN_STEPS} steps on one batch "
          f"through TrainDriver: loss " + " ".join(f"{x:.4f}" for x in
                                                   losses)
          + f"; step ms {' '.join(f'{t * 1e3:.1f}' for t in times)} "
          f"(median after the first {step_s * 1e3:.1f}); "
          f"{tokens / step_s:.0f} tokens/s; model FLOP/s "
          f"{flops / step_s / 1e12:.1f} T = {mfu:.4f} of the bf16 dense "
          f"peak (6 N tokens + attention, {flops / 1e12:.2f} TFLOP a step); "
          f"peak memory {peak / 2**30:.2f} GiB; launches {launches} "
          f"(K7 {launches['flash_attention'] // TRAIN_STEPS} a step)")

    # one more step, profiled, with the plain attention backward and the
    # AdamW update bracketed by CUDA events
    res["llama"].update(profile_train_step(
        torch, STEP, FA.FlashAttention, step, model, opt, batch,
        "36-train-profile", "K7 flash_attention", ("flash_attention",),
        f"the plain attention backward ({cfg.num_layers} recompute + grad "
        "calls)"))
    del model, opt, batch, logs, step
    free()

    # float32 at full width, depth 2: every gradient leaf
    cfg2 = dataclasses.replace(reduced_depth_config(TRAIN_ARCH, 2),
                               dtype="float32")
    model = make_model(cfg2, seed=0, device="cuda")
    res["llama_f32"] = cuda_vs_ref(
        torch, STEP, model, tc, synthetic_batch(cfg2, TRAIN_B, TRAIN_S,
                                                seed=0, device="cuda"),
        "36-train-cmp", f32=True, blocks=(env["TF"], LAYERS, STEP))
    del model
    free()

    # ---- 37. mamba2-130m under the fault-tolerant driver ------------------
    model = make_model(scfg, seed=0, device="cuda")
    batch = next(SyntheticLoader(scfg, SSM_TRAIN_B, TRAIN_S, seed=0,
                                 device="cuda"))
    opt = init_opt_state(model)
    step = STEP.make_train_step(scfg, tc, device="cuda")
    times.clear()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    restores: list = []
    try:
        fail = {"armed": True}

        def inject(i):
            if i == FT_FAIL_AT and fail["armed"]:
                fail["armed"] = False
                drv.ckpt.wait()        # the failure strikes once step 1's
                raise RuntimeError("injected failure")  # checkpoint is in

        drv = TrainDriver(step_fn, FTConfig(checkpoint_dir=ckdir,
                                            checkpoint_every=FT_EVERY),
                          failure_injector=inject)

        def counted(f):
            def run(*a, **kw):
                restores.append(a[1])
                return f(*a, **kw)
            return run

        FA.flash_attention.launches = 0
        SSD.ssd_scan.launches = 0
        with patched(CKPT, "restore", counted):
            (model, opt), logs = drv.run((model, opt),
                                         itertools.repeat(batch),
                                         num_steps=TRAIN_STEPS)
        launches = {"flash_attention": FA.flash_attention.launches,
                    "ssd_scan": SSD.ssd_scan.launches}
        want = {"flash_attention": 0,
                "ssd_scan": 2 * scfg.num_layers * TRAIN_STEPS}
        require(launches == want, f"37: launches {launches}, want {want}")
        require(drv.stats.retries == 1 and restores == [FT_FAIL_AT - 2],
                f"37: retries {drv.stats.retries}, restores {restores}")
        losses = [float(m["loss"]) for m in logs]
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"37: loss not falling {losses}")
        require_grads(torch, model, "37")
        last = CKPT.latest_step(ckdir)
        fresh = make_model(scfg, seed=1, device="cuda")
        drv2 = TrainDriver(step_fn, FTConfig(checkpoint_dir=ckdir,
                                             checkpoint_every=FT_EVERY))
        (fm, fo), start = drv2.maybe_restore((fresh, init_opt_state(fresh)))
        require(start == TRAIN_STEPS and last == TRAIN_STEPS - 1,
                f"37: resumed at {start}, latest checkpoint {last}")
        live = CKPT._flatten((model, opt))
        got = CKPT._flatten((fm, fo))
        require(sorted(live) == sorted(got), "37: restored tree differs")
        for key, t in live.items():
            require(torch.equal(got[key], t), f"37: {key} not bitwise")
        step_s = float(np.median(times[1:]))
        res["mamba"] = dict(losses=losses, step_ms=step_s * 1e3,
                            tokens_per_s=SSM_TRAIN_B * TRAIN_S / step_s,
                            launches=launches, leaves=len(live))
        phase("37-train-ssm", f"{scfg.name}: {scfg.num_layers} layers, "
              f"{n_parameters(model):,} parameters, B={SSM_TRAIN_B} "
              f"S={TRAIN_S} chunk {scfg.ssm.chunk_size}, {TRAIN_STEPS} steps "
              f"through TrainDriver (checkpoint every {FT_EVERY}, a "
              f"RuntimeError injected at step {FT_FAIL_AT}): loss "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; retries {drv.stats.retries}, restored step "
              f"{restores}; step ms {step_s * 1e3:.1f} (median after the "
              f"first), {SSM_TRAIN_B * TRAIN_S / step_s:.0f} tokens/s; "
              f"launches {launches}; a fresh driver resumed at step {start}"
              f" with all {len(live)} leaves bitwise the saved state")
        del fresh, fm, fo, drv, drv2
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    res["mamba"].update(profile_train_step(
        torch, STEP, SSD.SSDScan, step, model, opt, batch,
        "37-train-profile", "K8 ssd_scan", DEVICE_KERNELS["ssd_scan"],
        f"the plain SSD backward ({scfg.num_layers} recompute + grad "
        "calls)"))
    del model, opt, step, logs
    free()
    model = make_model(scfg, seed=0, device="cuda")
    res["mamba_bf16"] = cuda_vs_ref(torch, STEP, model, tc, batch,
                                    "37-train-cmp", f32=False)
    del model
    free()
    s32 = dataclasses.replace(scfg, dtype="float32")
    model = make_model(s32, seed=0, device="cuda")
    res["mamba_f32"] = cuda_vs_ref(
        torch, STEP, model, tc, synthetic_batch(s32, SSM_TRAIN_B, TRAIN_S,
                                                seed=0, device="cuda"),
        "37-train-cmp", f32=True)
    del model, batch
    free()

    # ---- 37. one step each: the hybrid, the moe, the encdec ---------------
    res["side"] = {}
    for arch, depth, B, S in SIDE_TRAIN:
        c = dataclasses.replace(
            reduced_depth_config(arch, depth) if depth else get_config(arch),
            dtype="float32")
        model = make_model(c, seed=0, device="cuda")
        n_open = open_gates(torch, np, model, seed=37)
        batch = synthetic_batch(c, B, S, seed=37, device="cuda")
        # the cuda step takes the ref step's expert picks and gates; the
        # witness keeps its own (both counted against the ref's)
        k = c.moe.top_k if c.family == "moe" else 1
        probs, flips = [], {"cuda": [], "witness": []}
        with held_routing(torch, LAYERS, probs, k, "record", []):
            r = grads_at(torch, STEP, model, tc, batch, "ref", keep=True)
        with held_routing(torch, LAYERS, probs, k, "count",
                          flips["witness"]):
            w = ulp_witness(torch, model, lambda: grads_at(
                torch, STEP, model, tc, batch, "ref", keep=True))
        # before the cuda step updates the parameters
        logits = logit_grad_diff(torch, env["TF"], model, batch)
        FA.flash_attention.launches = 0
        SSD.ssd_scan.launches = 0
        with held_routing(torch, LAYERS, probs, k, "hold", flips["cuda"]):
            cu = grads_at(torch, STEP, model, tc, batch, "cuda", keep=True,
                          step=STEP.make_train_step(c, tc, device="cuda"))
        launches = {"flash_attention": FA.flash_attention.launches,
                    "ssd_scan": SSD.ssd_scan.launches}
        require(sum(launches.values()) > 0, f"37 {arch}: no kernel launched")
        require_grads(torch, model, f"37 {arch}")
        extra = ""
        if probs:
            extra = (f"; aux {cu['aux']:.5f}; the cuda step took the ref "
                     f"step's expert picks and gates at its {len(probs)} "
                     f"router calls (forward and recomputation): its own "
                     f"differ on {sum(flips['cuda'])} token-calls, the "
                     f"witness's on {sum(flips['witness'])}")
        d, wd = step_diff(cu, r), step_diff(w, r)
        if c.family in ("encdec", "moe"):
            # whisper's and granite's random models part their gradients
            # by O(1) of a leaf's scale on a last-bit change of the input
            # (the witness): they are held block by block, and end to end
            # their loss, their gradients printed beside the witness
            extra += "; " + format_blocks(block_grads(
                torch, env["TF"], LAYERS, STEP, model, tc, batch,
                f"37 {arch}"))
            loss_b = (ENCDEC_LOSS_TOL if c.family == "encdec"
                      else TRAIN_F32_TOL["loss"])
            require(d["loss"] <= loss_b, f"37 {arch}: cuda vs ref loss "
                                         f"{d['loss']:.3g} > {loss_b}")
            bounds = f"loss {loss_b}, leaves block by block"
        else:
            hold_step(f"37 {arch}", d, f32=True)
            bounds = format_bounds()
        extra += logits
        res["side"][arch] = dict(diff=d, witness=wd, launches=launches,
                                 depth=c.num_layers)
        phase("37-train-family", f"{c.name} depth {c.num_layers} f32 "
              f"B={B} S={S}" + (f" ({n_open:,} gate/bias values opened)"
                                if n_open else "")
              + f": one train step, every .grad present and finite; cuda "
              f"vs ref {format_diff(d)} (bounds {bounds}); one-ulp witness "
              f"{format_diff(wd)}; launches {launches}{extra}")
        del model, batch, r, w, cu, probs, logits
        free()
    # what does not fit one card: the train_4k cells, by launch/dryrun.py
    for arch in ARCH_IDS:
        phase("37-dryrun", format_cell(cell_bytes(arch, "train_4k")))
    return res


def record_train(rows: list, res: dict) -> None:
    """The train-step rows of K7 and K8: their forward at the training
    shapes (Llama 3.2 1B's B=2 S=4,096; mamba2-130m's B=8 S=4,096) with
    the launches of phases 36 and 37, and the forward + backward times."""
    k7, k8 = res["k7"][0], res["k8"]
    nbytes = 2 * (2 * k7["B"] * k7["H"] * k7["S"] * k7["D"]
                  + 2 * k7["B"] * k7["K"] * k7["S"] * k7["D"])
    nops = 4 * k7["B"] * k7["H"] * k7["D"] * k7["pairs"]
    t7 = (nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_OPS_PER_S * 1e3)
    B, S, H, P, N, G, Q = (k8[x] for x in "B S H P N G Q".split())
    ops8 = ssd_ops(B, S, H, P, N, G, Q)
    bytes8 = (4 * B * S * H * P * 2 + 4 * B * S * H + 2 * 2 * B * S * G * N
              + 4 * B * H * P * N)
    t8 = (bytes8 / HBM_BYTES_PER_S * 1e3, ops8 / F32_OPS_PER_S * 1e3)
    for name, r, t, n, per_step, extra in (
            ("flash_attention_train", k7, t7, res["llama"]["launches"][
                "flash_attention"], res["llama"]["launches"][
                    "flash_attention"] / TRAIN_STEPS,
             {"backward_ms_per_step": res["llama"]["span_ms"][
                 "backward"]}),
            ("ssd_scan_train", k8, t8, res["mamba"]["launches"]["ssd_scan"],
             res["mamba"]["launches"]["ssd_scan"] / TRAIN_STEPS,
             {"backward_ms_per_step": res["mamba"]["span_ms"][
                 "backward"]})):
        kernel = name.removesuffix("_train")
        rows.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "source": PREFILL_SOURCE, "replaces": PREFILL_REPLACES[kernel],
            "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t),
            "bound_by": "bytes" if t[0] >= t[1] else "operations",
            "library_ms": r["library_ms"], "width": r["shape"],
            "launches_per_step": per_step, "fwd_bwd_ms": r["fwd_bwd_ms"],
            "plain_fwd_bwd_ms": r["plain_fwd_bwd_ms"],
            "library_fwd_bwd_ms": r["library_fwd_bwd_ms"],
            "grad_rel_err": r["grad_rel"], **extra})
        phase("35-37-train-kernel", f"{name}: forward {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, library {r['library_ms']}, "
              f"bound {max(t):.5f}), forward + backward "
              f"{r['fwd_bwd_ms']:.3f} ms, {n} launches in the training run "
              f"({per_step:g} a step)")


# ---------------------------------------------------------- phase 38 ----
def analysis_phase(torch) -> dict:
    """Phase 38: the port's static-analysis gate (``repro_torch.analysis``)
    on the card, ``--fast``: the tick targets (``ref``) and the
    kernel-backed ``tick:cuda:equilibria`` under sync debug, the eight
    kernel wrappers, the fleet chunk's donation contract
    (``memory_allocated`` never above its value after the second tick), the constancy sweeps, the
    cuda tick at C1's size (T = 32 and 64 over L = 262,144) under sync
    debug in both controller phases, and a child process that captures
    the C1 tick at T = 64 in a CUDA graph, one per controller phase.
    Requires no finding outside the committed baseline, each of K1-K8
    launched by the audit, every K7 launch on its tf32x3 route, and equal
    op histograms and launches per tick at T=32 and 64 in each phase.
    Returns the audit's launches per kernel wrapper and its figures."""
    from repro_torch.analysis.__main__ import CAPTURE_TARGET, run_audit
    from repro_torch.analysis.findings import load_baseline
    from repro_torch.analysis.op_audit import CAPTURE_REPS
    from repro_torch.analysis.walk import KERNELS
    t0 = time.perf_counter()
    report, info = run_audit("cuda", fast=True)
    secs = time.perf_counter() - t0
    new = report.new_vs(load_baseline())
    require(not new, "38-analysis: findings outside the baseline: "
            + "; ".join(f"{f.key} ({f.message[:160]})" for f in new))
    launches = info["launches"]
    for tag, _mod, name in KERNELS:
        require(launches[name] > 0,
                f"38-analysis: the audit never launched {tag} ({name})")
    routes = {k: v for k, v in info["k7_routes"].items() if v}
    require(routes == {"tf32x3": launches["flash_attention"]},
            f"38-analysis: K7's f32 launches took routes {routes}, not "
            f"tf32x3 alone")
    memory = info["memory"].get("fleet:chunk")
    require(memory and max(memory[2:]) <= memory[1],
            f"38-analysis: the fleet chunk's memory_allocated after each "
            f"one-tick chunk is {memory}: it grows past the second")
    c1 = {}
    for name in ("tick:cuda:C1:T", "tick:cuda:C1:T:controller"):
        (t_a, sig_a), (t_b, sig_b) = info["constancy"][name]
        require(sig_a == sig_b, f"38-analysis: {name}: the C1 cuda tick "
                f"differs at T={t_a} and T={t_b}: "
                + "; ".join(sig_a.diff(sig_b)))
        c1[name] = sig_b
    cap = info["capture"]
    syncs = sorted(f.slug for f in report.findings
                   if f.pass_name == "purity" and f.slug.startswith("sync"))
    c1_syncs = sorted(f.key for f in report.findings
                      if f.target.startswith("tick:cuda:C1:")
                      and f.pass_name == "purity")
    ticks = "; ".join(
        f"{'controller tick' if name.endswith('controller') else 'tick'} "
        f"{sig.n_ops} aten ops, {sum(dict(sig.launches).values())} kernel "
        f"launches {dict(sig.launches)}" for name, sig in c1.items())
    caps = "; ".join(
        (f"{v['phase']} ok (warm medians of "
         f"{CAPTURE_REPS}: eager {v['eager_ms']:.4f} ms, replay "
         f"{v['replay_ms']:.4f} ms)" if v["ok"] else
         f"{v['phase']} FAILED at {v['where']}: {v['error'][:200]}")
        for v in cap["phases"])
    phase("38-analysis", f"C1 cuda tick (L={L0}, T={t_b}): {ticks}; equal "
          f"at T={t_a} and T={t_b}; purity at C1 under sync debug: "
          f"{', '.join(c1_syncs) or 'no host read, no sync'}; "
          f"{CAPTURE_TARGET} (T={t_b}) CUDA-graph capture: {caps}; sync "
          f"sites: {', '.join(syncs) or 'none'}; fleet chunk "
          f"memory_allocated {memory}; K7 routes {routes}; "
          f"{len(report.findings)} findings, all in the baseline; audit "
          f"launches {launches}; audit {secs:.1f} s")
    sig = c1["tick:cuda:C1:T"]
    return {"launches": launches, "seconds": secs, "capture": cap,
            "c1_ops": sig.n_ops, "c1_launches": dict(sig.launches),
            "syncs": syncs}


# ---------------------------------------------------------- phase 18 ----
KERNEL_CLASSES = (("K7 flash_attention", ("flash_attention",)),
                  ("K8 ssd_scan", DEVICE_KERNELS["ssd_scan"]),
                  ("matmul", ("gemm", "cutlass", "xmma", "cublas", "sm90_",
                              "nvjet")),
                  ("cast/copy", ("copy_kernel", "direct_copy", "to_copy")),
                  ("elementwise", ("elementwise", "vectorized")),
                  ("reduction", ("reduce",)))


def classify(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


# -------------------------------------------------------------- main ----
def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing next to this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_serve_load
    from repro_torch.configs.base import TieringConfig
    from repro_torch.core.engine import make_tick, run_engine
    from repro_torch.core.simulator import simulate, simulate_preset
    from repro_torch.core.state import init_state
    from repro_torch.core.workloads import ci_like, microbenchmark, web_like
    from repro_torch.kernels.build import build_all, build_variant
    from repro_torch.kernels.migrate import ops as KMIG
    from repro_torch.kernels.migrate import ref as RMIG
    from repro_torch.kernels.select import ops as KSEL
    from repro_torch.kernels.select import ref as RSEL
    from repro_torch.kernels.tiered_attention import ops as TA
    from repro_torch.kernels.tiered_attention import ref as TA_REF
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FA_REF
    from repro_torch.kernels.ssd_scan import ops as SSD
    from repro_torch.kernels.ssd_scan import ref as SSD_REF
    from repro_torch.kernels.ssd_decode import ops as SDEC
    from repro_torch.kernels.ssd_decode import ref as SDEC_REF
    from repro_torch.launch.serve import full_load
    from repro_torch.memtier import kvcache as KC
    from repro_torch.models import layers as LAYERS
    from repro_torch.models import transformer as TF
    from repro_torch.models.transformer import (DenseLM, hybrid_forward,
                                                lm_forward, make_model,
                                                ssm_lm_forward)
    from repro_torch.numerics import fused_mul_add
    from repro_torch.serve import decode as SD
    from repro_torch.train.step import make_prefill_step

    wrappers = {"seg_topk": KSEL.seg_topk, "seg_reduce": KSEL.seg_reduce,
                "seg_sums": KSEL.seg_sums, "commit_moves": KMIG.commit_moves}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        for r in KSEL.seg_topk.routes:      # in place: the launcher's dict
            KSEL.seg_topk.routes[r] = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    t_start = time.perf_counter()
    # ---- 1. device + build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("1-device", f"{kind} | torch {torch.__version__} cuda "
                      f"{torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # K1's earlier design (phase 22) builds beside the port's sources
    pool = ThreadPoolExecutor(max_workers=1)
    earlier_topk = pool.submit(build_variant, "selection",
                               ROOT / EARLIER_TOPK_SOURCE)
    pool.shutdown(wait=False)
    libs = build_all()
    for lib in libs.values():
        regs = [ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln]
        phase("1-build", f"{lib.path.name} built in {lib.build_s:.1f}s; "
                         "ptxas: " + " | ".join(regs))
    phase("1-build", f"all kernels built and loaded in "
                     f"{time.perf_counter() - t0:.1f}s (one nvcc per source, "
                     "in parallel)")

    # ---- 2. kernels vs plain versions -------------------------------------
    err, cases = check_kernels(torch, np, (KSEL, KMIG), (RSEL, RMIG))
    phase("2-kernels", "bitwise equal to plain versions: " + ", ".join(
        f"{k} {cases[k]} cases" for k in REPLACES))

    # ---- 3. golden ----------------------------------------------------------
    cfg = TieringConfig(n_tenants=3, n_fast_pages=128, n_slow_pages=256,
                        lower_protection=(48, 48, 0), upper_bound=(0, 64, 0))
    tenants = [microbenchmark(80), web_like(90, arrival=8),
               ci_like(70, phase_len=16)]
    r = simulate(cfg, tenants, 60, k_max=32, impl="cuda", device="cuda")
    want = json.loads(GOLDEN.read_text())
    got = collect(r)
    require(sorted(want) == sorted(got), "golden key set drifted")
    for key in sorted(want):
        diff(got[key], want[key], key)
    phase("3-golden", f"static_small matches {GOLDEN.name} with impl=cuda "
                      f"({len(r.migrations)} ring events)")

    # ---- 4. full-width main path -------------------------------------------
    cfg = bench_config(TieringConfig, T0, L0)
    owner, acc, alive = bench_trace(np, T0, L0, MAIN_TICKS)
    reset_counts()
    a_state, a_out = run_engine(cfg, owner, acc, alive, mode="equilibria",
                                k_max=K_MAX, impl="cuda", device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    b_state, b_out = run_engine(cfg, owner, acc, alive, mode="equilibria",
                                k_max=K_MAX, impl="ref", device="cuda")
    compare_runs(torch, a_state, a_out, b_state, b_out, "full width")
    promos = int(a_out.promotions.sum())
    demos = int(a_out.demotions.sum())
    require(promos > 0 and demos > 0, "full width: no migrations")
    require(a_out.fast_usage.shape == (MAIN_TICKS, T0), "output shape")
    for name, n in launches.items():
        require(n > 0, f"main path never launched {name}")
    k1_routes = dict(KSEL.seg_topk.routes)
    require(k1_routes == {"staged": launches["seg_topk"], "long": 0},
            f"full width: K1's routes {k1_routes}, want all staged")
    # in turns, so drift on the card shows as a cuda/cuda spread
    ms = [(impl, tick_ms(torch, make_tick, init_state, cfg, owner, acc[0],
                         impl)) for impl in ("cuda", "ref", "batched", "cuda")]
    phase("4-main", f"T={T0} L={L0} equilibria {MAIN_TICKS} ticks: cuda == "
                    f"ref (ints bitwise, floats rtol 1e-5); promotions "
                    f"{promos} demotions {demos}; launches {launches}, "
                    f"K1's by route {k1_routes}; tick ms "
                    + " ".join(f"{k}={v:.4f}" for k, v in ms))

    # ---- 5. stacked64, four modes ------------------------------------------
    res = []
    for mode in ("equilibria", "tpp", "memtis", "static"):
        a = simulate_preset("stacked64", ticks=STACKED_TICKS, mode=mode,
                            impl="cuda", device="cuda")
        b = simulate_preset("stacked64", ticks=STACKED_TICKS, mode=mode,
                            impl="ref", device="cuda")
        for f in ("fast_usage", "slow_usage", "promotions", "demotions",
                  "thrash_events", "attempted", "pool_free"):
            require(np.array_equal(getattr(a, f), getattr(b, f)),
                    f"stacked64 {mode}: {f}")
        require(np.array_equal(a.migrations, b.migrations),
                f"stacked64 {mode}: ring")
        for f in ("throughput", "latency", "promo_scale"):
            require(np.allclose(getattr(a, f), getattr(b, f), rtol=1e-5,
                                atol=1e-4), f"stacked64 {mode}: {f}")
        res.append(f"{mode} moves={int(a.promotions.sum())}"
                   f"+{int(a.demotions.sum())}")
    phase("5-modes", f"stacked64 {STACKED_TICKS} ticks cuda == ref: "
                     + ", ".join(res))

    # ---- 6. per-kernel numbers at full width -------------------------------
    bw = copy_bandwidth()
    rng = np.random.default_rng(1)
    S0 = L0 // T0
    score = torch.as_tensor(
        np.where(rng.random((T0, S0)) < 0.3, 4.0, 0.1).astype(np.float32)
        + rng.random((T0, S0)).astype(np.float32), device="cuda")
    valid = torch.as_tensor(rng.random((T0, S0)) < 0.5, device="cuda")
    quotas = torch.full((T0,), K_MAX, dtype=torch.int32, device="cuda")
    xmask = torch.as_tensor(rng.integers(0, 2, (T0, S0)).astype(np.int32),
                            device="cuda")
    vall = torch.ones((T0, S0), dtype=torch.bool, device="cuda")
    N = T0 * K_MAX
    C = cfg.obs_ring_capacity
    cols = np.stack([rng.permutation(S0)[:K_MAX] for _ in range(T0)])
    take_np = rng.random((T0, K_MAX)) < 0.5
    pages = torch.as_tensor(np.where(
        take_np, np.arange(T0)[:, None] * S0 + cols, L0).reshape(-1)
        .astype(np.int32), device="cuda")
    take = torch.as_tensor(take_np.reshape(-1), device="cuda")
    tenants = torch.arange(T0, dtype=torch.int32, device="cuda"
                           ).repeat_interleave(K_MAX)
    hot = torch.rand(N, device="cuda")
    tier = torch.ones(L0, dtype=torch.int32, device="cuda")
    ring = torch.zeros((C, 5), dtype=torch.int32, device="cuda")
    head = torch.zeros((), dtype=torch.int32, device="cuda")
    n_take = int(take.sum())
    nbytes = {
        "seg_topk": T0 * S0 * 5 + T0 * 4 + T0 * K_MAX * 5 + T0 * 4,
        "seg_reduce": T0 * S0 * 5 + T0 * 4 + T0 * S0 * 4,
        "seg_sums": T0 * S0 * 5 + T0 * 4,
        "commit_moves": N * 13 + 4 + n_take * 4 + min(n_take, C) * 20 + 4,
    }
    nops = {"seg_topk": T0 * S0, "seg_reduce": T0 * S0, "seg_sums": T0 * S0,
            "commit_moves": N}
    kern = {
        "seg_topk": lambda: KSEL.seg_topk(score, valid, quotas, K_MAX),
        "seg_reduce": lambda: KSEL.seg_reduce(xmask, vall),
        "seg_sums": lambda: KSEL.seg_sums(xmask, vall),
        "commit_moves": lambda: KMIG.commit_moves(
            tier, ring, head, pages, take, tenants, hot, 5, direction=0,
            to_tier=0),
    }
    hot_bits = hot.view(torch.int32)
    plain = {
        "seg_topk": lambda: RSEL.seg_topk_ref(score, valid, quotas, K_MAX),
        "seg_reduce": lambda: RSEL.seg_reduce_ref(xmask, vall),
        "seg_sums": lambda: RSEL.seg_sums_ref(xmask, vall),
        "commit_moves": lambda: RMIG.commit_moves_ref(
            tier, ring, head, pages, take, tenants, hot_bits, 5,
            direction=0, to_tier=0),
    }
    library = {
        "seg_topk": lambda: torch.sort(score, dim=1, descending=True,
                                       stable=True)[0][:, :K_MAX],
        "seg_reduce": lambda: torch.cumsum(xmask, dim=1, dtype=torch.int32),
        "seg_sums": lambda: xmask.sum(dim=1, dtype=torch.int32),
        "commit_moves": None,
    }
    # the launch floor: an empty kernel of the same library, timed alike
    floor_ms = device_ms(lambda: libs["selection"].call(
        "empty_launch", torch.cuda.current_stream().cuda_stream))
    rows = []
    for name in REPLACES:
        k_ms = device_ms(kern[name])
        p_ms = device_ms(plain[name])
        lib_ms = device_ms(library[name]) if library[name] else None
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = nops[name] / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "launches_per_tick": launches[name] / MAIN_TICKS,
            "bytes": nbytes[name],
            "bound_copy_ms": nbytes[name] / bw * 1e3,
            "launch_floor_ms": floor_ms,
        })
        earlier = (f"earlier design {EARLIER_MS[name]:.4f}, "
                   if name in EARLIER_MS else "")
        phase("6-kernel", f"{name}: {k_ms:.4f} ms ({earlier}plain "
                          f"{p_ms:.4f}, library {lib_ms if lib_ms is None else f'{lib_ms:.4f}'}"
                          f", bound {rows[-1]['bound_ms']:.5f} at 3.35 TB/s, "
                          f"{rows[-1]['bound_copy_ms']:.5f} at measured copy "
                          f"{bw / 1e12:.3f} TB/s, launch floor "
                          f"{floor_ms:.4f}) launches/tick "
                          f"{launches[name] / MAIN_TICKS:g}")

    # K1 and K4 at the arguments C1's ticks hand them: their calls in the
    # first tick of the bench trace (the one that moves pages: quotas up to
    # about 200) and in the tenth (settled: quotas 0, nothing taken),
    # recorded on the way in (an op counts its launches on the module's
    # global of its name, the recorder while it is in place; the count is
    # carried over both ways)
    calls = {"seg_topk": [], "commit_moves": []}
    orig_topk, orig_moves = KSEL.seg_topk, KMIG.commit_moves

    def recording_topk(score, valid, quotas, k):
        calls["seg_topk"].append((score.clone(), valid.clone(),
                                  quotas.clone(), k))
        return orig_topk(score, valid, quotas, k)

    def recording_moves(*args, **kw):
        calls["commit_moves"].append(
            ([a.clone() if torch.is_tensor(a) else a for a in args], kw))
        return orig_moves(*args, **kw)

    recording_topk.launches = orig_topk.launches
    recording_moves.launches = orig_moves.launches
    KSEL.seg_topk, KMIG.commit_moves = recording_topk, recording_moves
    tick_calls = {}
    try:
        tick = make_tick(cfg, owner, "equilibria", K_MAX, impl="cuda",
                         device="cuda")
        state = init_state(cfg, owner.shape[0], owner=owner, device="cuda")
        a_t = torch.as_tensor(acc[0], device="cuda")
        alive_t = torch.ones_like(a_t, dtype=torch.bool)
        for t in range(10):
            for v in calls.values():
                v.clear()
            state, _ = tick(state, (a_t, alive_t))
            if t in (0, 9):
                tick_calls["first" if t == 0 else "tenth"] = {
                    k: list(v) for k, v in calls.items()}
    finally:
        KSEL.seg_topk, KMIG.commit_moves = orig_topk, orig_moves
        orig_topk.launches = recording_topk.launches
        orig_moves.launches = recording_moves.launches
    per_tick, moves_tick = {}, {}
    for label, cs in tick_calls.items():
        require(len(cs["seg_topk"]) > 0 and len(cs["commit_moves"]) > 0,
                f"the {label} tick called no seg_topk or no commit_moves")
        per_tick[label] = [(device_ms(functools.partial(orig_topk, *c)),
                            int(c[2].max()), float(c[2].clamp(min=0).float()
                                                   .mean()))
                           for c in cs["seg_topk"]]
        # K4: ms a call and taken lanes (args: tier, ring, head, pages,
        # take, ...); bound as the phase's nbytes formula at this n_take
        moves_tick[label] = []
        for args, kw in cs["commit_moves"]:
            n_t = int(args[4].sum())
            nb = args[3].shape[0] * 13 + 8 + n_t * 4 + min(
                n_t, args[1].shape[0]) * 20
            moves_tick[label].append((device_ms(functools.partial(
                orig_moves, *args, **kw)), n_t, nb / HBM_BYTES_PER_S * 1e3))
    row_of = {r["name"]: r for r in rows}
    row_of["seg_topk"]["ms_per_tick_at_tick_quotas"] = {
        label: sum(ms for ms, _, _ in v) for label, v in per_tick.items()}
    row_of["commit_moves"]["ms_per_tick_at_tick_state"] = {
        label: sum(ms for ms, _, _ in v) for label, v in moves_tick.items()}
    phase("6-kernel", "seg_topk at C1's own quotas (k=256, ms a call, quota "
          "max/mean): " + "; ".join(
              f"{label} tick {sum(ms for ms, _, _ in v):.4f} ms (" + ", ".join(
                  f"{ms:.4f} at {qmax}/{qmean:.1f}" for ms, qmax, qmean in v)
              + ")" for label, v in per_tick.items()))
    phase("6-kernel", "commit_moves at C1's own tick states (N="
          f"{N}, C={C}; ms a call, taken lanes, bound ms; launch floor "
          f"{floor_ms:.4f}): " + "; ".join(
              f"{label} tick {sum(ms for ms, _, _ in v):.4f} ms (" + ", ".join(
                  f"{ms:.4f} at {n_t} taken, bound {b:.5f}"
                  for ms, n_t, b in v) + ")"
              for label, v in moves_tick.items()))
    del calls, tick_calls, state, tick

    # ---- 7. where a full-width tick's device time goes --------------------
    tick_cuda_ms = sum(v for k, v in ms if k == "cuda") / 2
    prof = tick_profile(torch, make_tick, init_state, cfg, owner, acc[0],
                        "cuda")
    if prof is None:
        phase("7-profile", "device time not measured: the profiler saw no "
                           "device event")
    else:
        n_dev, busy_ms, top = prof
        ours = {k: [(t, c) for name, t, c in top if f"{k}_kernel(" in name]
                for k in REPLACES}
        phase("7-profile", f"impl=cuda tick: {n_dev:g} device events/tick, "
                           f"busy {busy_ms:.4f} ms of {tick_cuda_ms:.4f} ms "
                           f"(idle share {1 - busy_ms / tick_cuda_ms:.3f}); "
                           "selection kernels ms/tick: " + ", ".join(
                               f"{k} {sum(t for t, _ in v):.4f} "
                               f"x{sum(c for _, c in v):g}"
                               for k, v in ours.items())
                           + "; top by device ms/tick: " + "; ".join(
                               f"{name[:70]} {t:.4f} ms x{c:g}"
                               for name, t, c in top[:12]))
    # ---- 8. serving kernels vs plain versions ------------------------------
    serve_err, serve_cases = check_serve_kernels(torch, np, TA, TA_REF, KMIG,
                                                 RMIG)
    phase("8-serve-kernels", f"pool_attention_partial within {K5_TOL} of "
          f"plain (max abs err {serve_err['pool_attention_partial']:.3g}) "
          f"over {serve_cases['pool_attention_partial']} cases (S1's fast "
          "and slow pools and S3's widths, bf16/f32, window None/40); "
          f"migrate_pages bitwise over "
          f"{serve_cases['migrate_pages']} cases (one pool and K+V, S1's "
          "and S3's pools and a 15-element page, bf16/f32, aligned and "
          "unaligned pools, all-unselected, src slot == dst slot, indices "
          "out of range)")
    serve_err["ssd_decode"], serve_cases["ssd_decode"] = check_ssd_decode(
        torch, SDEC, SDEC_REF)
    phase("8-serve-kernels", f"ssd_decode (D1): the state bit for bit and y "
          f"within {D1_TOL} of plain (max abs err "
          f"{serve_err['ssd_decode']:.3g}) over {serve_cases['ssd_decode']} "
          "cases (Zamba2's H=112 P=64 N=64 G=2 and mamba2-130m's H=32 P=48 "
          "N=128 at B=256 and 3, 16 x 16 at B=5; x/B/C bf16 as the conv "
          "step's views and contiguous, f32; layer 2 of a stacked cache, "
          "updated in place, the other layers untouched, one launch a call)")

    # ---- 9. tiered-KV serving at full width --------------------------------
    swrap = {"pool_attention_partial": TA.pool_attention_partial,
             "migrate_pages": KMIG.migrate_pages,
             "ssd_decode": SDEC.ssd_decode}
    cfg = get_config("llama32_1b")
    B, steps = get_serve_load("llama32_1b")
    tcfg = full_load(cfg, B, steps)
    torch.cuda.reset_peak_memory_stats()
    model = DenseLM(cfg, seed=0, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32), device="cuda")
    rec: dict = {}
    kv_step = SD.equilibria_kv_step

    def recording_kv_step(cache, mf, ms, *args, impl, **kw):
        # the tiering step's inputs, for the deciding margin of a flip
        rec[impl] = (cache.fast_hot, cache.slow_hot, cache.fast_page >= 0,
                     cache.slow_page >= 0, mf, ms)
        return kv_step(cache, mf, ms, *args, impl=impl, **kw)

    SD.equilibria_kv_step = recording_kv_step
    ctx = dict(SD=SD, fused_mul_add=fused_mul_add, cfg=cfg, tcfg=tcfg,
               model=model, toks=toks, steps=steps, rec=rec)
    for w in swrap.values():
        w.launches = 0
    run = serve_compare(torch, np, ctx, "equilibria", steps, TOL["bf16"],
                        snapshot_at=steps // 2)
    serve_launches = {k: w.launches for k, w in swrap.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kv = run["state"]["kv"]
    promos = int(kv.counters.promotions.sum())
    demos = int(kv.counters.demotions.sum())
    step_ms = sorted(run["ms"])
    mean_ms = sum(step_ms) / len(step_ms)
    fast_use = KC.by_tenant((kv.fast_page >= 0).sum(1, dtype=torch.int32),
                            kv.tenant, tcfg.n_tenants).tolist()
    slow_use = KC.by_tenant((kv.slow_page >= 0).sum(1, dtype=torch.int32),
                            kv.tenant, tcfg.n_tenants).tolist()
    phase("9-serve", f"{cfg.name} 16 layers, {B} seqs x {steps} steps, "
          f"{tcfg.n_tenants} tenants, equilibria, bf16; promotions "
          f"{promos} (attempted "
          f"{int(kv.counters.attempted_promotions.sum())}) demotions "
          f"{demos} (max hotness over the run: slow "
          f"{run['slow_hot_max']:.3g}, fast {run['fast_hot_max']:.3g}, "
          f"threshold {tcfg.promo_hot_threshold}) thrash "
          f"{int(kv.counters.thrash_events.sum())}; launches "
          f"{serve_launches}; step ms mean {mean_ms:.3f} median "
          f"{step_ms[len(step_ms) // 2]:.3f} p90 "
          f"{step_ms[int(len(step_ms) * 0.9)]:.3f} (CUDA events, impl=cuda)"
          f"; decode {B / (mean_ms / 1e3):.1f} tokens/s; peak memory "
          f"{peak_gib:.2f} GiB; fast pages per tenant {fast_use} (budget "
          f"{SD.fast_budget_pages(cfg, tcfg, B, steps)}), slow {slow_use}")
    check_compare(np, run, TOL["bf16"], "9-serve-agree")
    require(promos > 0 and demos > 0, f"serving: promotions {promos}, "
                                      f"demotions {demos}")
    for name, n in serve_launches.items():
        require(n > 0 if name != "ssd_decode" else n == 0,
                f"serving path launched {name} {n} times")
    side = []
    for mode in ("tpp", "static"):
        r = serve_compare(torch, np, ctx, mode, SIDE_STEPS, TOL["bf16"])
        c = r["state"]["kv"].counters
        side.append(f"{mode}: promotions {int(c.promotions.sum())} "
                    f"demotions {int(c.demotions.sum())}, step ms mean "
                    f"{sum(r['ms']) / len(r['ms']):.3f}")
        check_compare(np, r, TOL["bf16"], f"9-serve-{mode}-agree")
        del r
    phase("9-serve-modes", f"{SIDE_STEPS} steps each: " + " | ".join(side))

    # ---- 10. decode == forward at full width in float32 --------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tcfg_fw = TieringConfig(n_tenants=2, page_tokens=tcfg.page_tokens,
                            thrash_table_slots=256, lower_protection=(2, 2),
                            upper_bound=(3, 3))
    model32 = DenseLM(cfg32, seed=0, device="cuda")
    toks_fw = toks[:FWD_BATCH, :FWD_STEPS].contiguous()
    ctx32 = dict(ctx, cfg=cfg32, tcfg=tcfg_fw, model=model32, toks=toks_fw,
                 steps=FWD_STEPS)
    r32 = serve_compare(torch, np, ctx32, "equilibria", FWD_STEPS,
                        TOL["f32"])
    SD.equilibria_kv_step = kv_step
    with torch.no_grad():
        ref_logits = lm_forward(model32, toks_fw)
    dec = torch.stack(r32["logits"], dim=1)
    fw_rel = float((dec - ref_logits).abs().max() / ref_logits.abs().max())
    c = r32["state"]["kv"].counters
    fw_moves = int(c.promotions.sum() + c.demotions.sum())
    fw_slow = int((r32["state"]["kv"].slow_page >= 0).sum())
    require(fw_rel <= FWD_RTOL, f"decode != forward: {fw_rel:.3g}")
    require(fw_moves > 0 and fw_slow > 0, "decode/forward: no migrations")
    phase("10-serve-forward", f"f32 full width, {FWD_BATCH} seqs x "
          f"{FWD_STEPS} steps: max |decode - forward| / max |logit| = "
          f"{fw_rel:.3g} <= {FWD_RTOL} with {fw_moves} page moves and "
          f"{fw_slow} slow pages")
    check_compare(np, r32, TOL["f32"], "10-serve-f32-agree")
    del model32, r32, dec, ref_logits

    # ---- 11. serving kernels: time, bound, plain, library -----------------
    pt = tcfg.page_tokens
    H, D, Kh = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    L = cfg.num_layers
    Mf, Ms = kv.fast_page.shape[1], kv.slow_page.shape[1]
    k5 = k5_numbers(torch, F, TA, TA_REF, kv, pt, H)
    mig = k6_numbers(torch, np, KMIG, RMIG, kv, 11)
    n_sel = mig["n_sel"]
    for name, kn in (("pool_attention_partial", k5), ("migrate_pages", mig)):
        rows.append({
            "name": name, "route": "cuda", "source": SERVE_SOURCE,
            "replaces": SERVE_REPLACES[name],
            "launches": serve_launches[name],
            "max_abs_err": serve_err[name], "ms": kn["ms"],
            "plain_ms": kn["plain_ms"], "bound_ms": kn["bound_ms"],
            "bound_by": kn["bound_by"], "library_ms": kn["library_ms"],
            "launches_per_step": serve_launches[name] / steps,
            "bytes": kn["bytes"],
            "bound_copy_ms": kn["bytes"] / bw * 1e3,
        })
        if name == "pool_attention_partial":
            what = (f"S1 state, one layer, both pools (2 op calls), "
                    f"{k5['n_valid']} valid tokens")
            lib = (f"library {kn['library_ms']:.4f} (SDPA, "
                   f"{kn['library_form']}, the faster form)")
        else:
            what = f"{n_sel} of {B} sequences x {L} layers, one pool"
            lib = (f"library {kn['library_ms']:.4f} (index_copy_); K+V in "
                   f"one launch {kn['kv']['ms']:.4f} (plain "
                   f"{kn['kv']['plain_ms']:.4f}, bound "
                   f"{kn['kv']['bound_ms']:.5f})")
            rows[-1]["kv"] = kn["kv"]
        earlier = (f"earlier design {EARLIER_MS[name]:.4f}, "
                   if name in EARLIER_MS else "")
        phase("11-serve-kernel", f"{name} [{what}]: {kn['ms']:.4f} ms "
              f"({earlier}plain {kn['plain_ms']:.4f}, {lib}, bound "
              f"{kn['bound_ms']:.5f} at 3.35 TB/s, "
              f"{rows[-1]['bound_copy_ms']:.5f} at measured copy "
              f"{bw / 1e12:.3f} TB/s) launches/step "
              f"{serve_launches[name] / steps:g}")

    d1 = {name: d1_numbers(torch, SDEC, SDEC_REF, *w)
          for name, w in D1_WIDTHS.items()}
    for name, kn in d1.items():
        B_, H_, P_, N_, G_ = D1_WIDTHS[name]
        phase("11-serve-kernel", f"ssd_decode (D1) [{name} B={B_} H={H_} "
              f"P={P_} N={N_} G={G_}, x/B/C bf16 conv views, one layer of a "
              f"stacked cache]: {kn['ms']:.4f} ms (plain "
              f"{kn['plain_ms']:.4f}, plain + the cache copy "
              f"{kn['plain_copy_ms']:.4f}, library none, bound "
              f"{kn['bound_ms']:.5f} at 3.35 TB/s, {kn['bytes'] / bw * 1e3:.5f}"
              f" at measured copy; {100 * kn['bound_ms'] / kn['ms']:.1f}% of "
              "the bound)")

    # ---- 12. where one decode step's device time goes ---------------------
    step_c = SD.build_serve_step(cfg, tcfg, B, steps, impl="cuda")
    wall_ms, prof = profile_serve_step(
        torch, step_c, model, run["snapshot"],
        toks[:, steps // 2:steps // 2 + 1])
    if prof is None:
        phase("12-serve-profile", "device time not measured: the profiler "
                                  "saw no device event")
    else:
        n_dev, busy_ms, top, _ = prof
        ours = {k: [(t, c) for nm, t, c in top
                    if any(d in nm for d in DEVICE_KERNELS[k])]
                for k in SERVE_REPLACES if serve_launches[k]}
        for k, v in ours.items():
            per_call = sum(c for _, c in v) / (serve_launches[k] / steps)
            next(r for r in rows if r["name"] == k)[
                "device_launches_per_call"] = per_call
        phase("12-serve-profile", f"one decode step at position {steps // 2}"
              f": {n_dev:g} device events, busy {busy_ms:.4f} ms of "
              f"{wall_ms:.4f} ms wall (idle share "
              f"{1 - busy_ms / wall_ms:.3f}); serving kernels ms/step: "
              + ", ".join(f"{k} {sum(t for t, _ in v):.4f} "
                          f"x{sum(c for _, c in v):g} (device launches per "
                          f"op call "
                          f"{sum(c for _, c in v) / (serve_launches[k] / steps):g})"
                          for k, v in ours.items())
              + "; top by device ms: " + "; ".join(
                  f"{nm[:60]} {t:.4f} ms x{c:g}" for nm, t, c in top[:12]))
    del run, kv, step_c, toks, ctx, rec
    torch.cuda.empty_cache()

    # ---- 13. prefill kernels (K7, K8) vs plain versions ------------------
    pre_err, pre_cases = check_prefill_kernels(torch, np, FA, FA_REF, SSD,
                                               SSD_REF)
    phase("13-prefill-kernels", f"flash_attention within {K7_TOL} of plain "
          f"(max abs err {pre_err['flash_attention']:.3g}) over "
          f"{pre_cases['flash_attention']} cases (zamba2 H=K=32 D=112 and "
          "llama H=32 K=8 D=64, D=128 at H=K=8 and H=16 K=4, danube H=32 "
          "K=8 D=120; S=1024, S=200, "
          "Sq=256 < Skv=1024, Sq=300 < Skv=333; causal, window 64, "
          "non-causal; f32 and bf16; with v x 64 (f32 at atol x 64); "
          "each again on strided [B,S,H,D] views, equal; launches by route "
          f"{pre_cases['k7_routes']}: bf16 all wgmma, f32 and unaligned "
          "bf16 views all tf32x3); "
          "ssd_scan "
          f"within atol {K8_ATOL} rtol {K8_RTOL} (max abs err {pre_err['ssd_scan']:.3g})"
          f" over {pre_cases['ssd_scan']} cases (zamba2 H=112 P=64 N=64 and "
          "mamba2-130m H=32 P=48 N=128, Q=256, S=1024; init and strong "
          "decays; B/C in bf16 and f32)")

    # ---- 14. prefill at full width: Llama 3.2 1B, then Zamba2-7B ---------
    pwrap = {"flash_attention": FA.flash_attention, "ssd_scan": SSD.ssd_scan}
    prefill_rows, path_checks = {}, []
    prefill_cell = functools.partial(
        run_prefill_cell, torch, np, dict(
            FA=FA, FA_REF=FA_REF, SSD=SSD, SSD_REF=SSD_REF, pwrap=pwrap,
            LAYERS=LAYERS, TF=TF,
            make_prefill_step=make_prefill_step, rows=prefill_rows,
            checks=path_checks))

    prefill_cell(model, "llama")
    require(prefill_rows["llama"]["launches"]["flash_attention"]
            == cfg.num_layers, f"llama prefill launched K7 "
            f"{prefill_rows['llama']['launches']} times")
    del model
    torch.cuda.empty_cache()
    zmodel = cut_depth_model("zamba2_7b", ZAMBA2_DEPTH)
    zcfg = zmodel.cfg
    n_params = sum(p.numel() for p in zmodel.parameters())
    zstep, ztoks = prefill_cell(zmodel, "zamba2")
    n_apps = -(-zcfg.num_layers // zcfg.hybrid_attn_every)
    require(prefill_rows["zamba2"]["launches"] == {
        "flash_attention": n_apps, "ssd_scan": zcfg.num_layers},
        f"zamba2 prefill launches {prefill_rows['zamba2']['launches']}")
    prefill_launches = {k: sum(prefill_rows[m]["launches"][k] for m in (
        "llama", "zamba2")) for k in pwrap}
    phase("14-prefill", f"{zcfg.name}: {n_params:,} parameters (float32 "
          f"weights {n_params * 4 / 1e9:.1f} GB); K7 launches per prefill "
          f"{n_apps}, K8 {zcfg.num_layers}")
    for r in path_checks:
        phase("14-prefill-path", f"{r['label']}: {r['what']}: max abs err "
              f"{r['err']:.3g}, {r['share']:.3g} of the bound (atol "
              f"{r['atol']}, rtol {r['rtol']})")
    # llama: K7 in three prefills; zamba2: K7 and K8's y and h in three
    require(len(path_checks) == 3 + 3 * 3,
            f"path checks: {len(path_checks)} readings")
    for r in path_checks:
        require(r["share"] <= 1.0, f"{r['label']} {r['what']}: max abs err "
                                   f"{r['err']:.3g} exceeds the bound")

    # ---- 15. hybrid tiered-KV serving at full width ------------------------
    zB, zsteps = get_serve_load("zamba2_7b")
    ztcfg = full_load(zcfg, zB, zsteps)
    torch.cuda.reset_peak_memory_stats()
    ztoks_d = torch.as_tensor(np.random.default_rng(16).integers(
        0, zcfg.vocab_size, (zB, zsteps)).astype(np.int32), device="cuda")
    rec = {}
    SD.equilibria_kv_step = recording_kv_step
    zctx = dict(SD=SD, fused_mul_add=fused_mul_add, cfg=zcfg, tcfg=ztcfg,
                model=zmodel, toks=ztoks_d, steps=zsteps, rec=rec)
    for w in swrap.values():
        w.launches = 0
    d1_in: dict = {}
    with d1_inputs(SDEC, zcfg.num_layers, d1_in):
        zrun = serve_compare(torch, np, zctx, "equilibria", zsteps,
                             TOL["bf16"], snapshot_at=zsteps // 2)
    hyb_launches = {k: w.launches for k, w in swrap.items()}
    zpeak = torch.cuda.max_memory_allocated() / 2**30
    zkv = zrun["state"]["kv"]
    zpromos = int(zkv.counters.promotions.sum())
    zdemos = int(zkv.counters.demotions.sum())
    zms = sorted(zrun["ms"])
    zmean = sum(zms) / len(zms)
    zfast = KC.by_tenant((zkv.fast_page >= 0).sum(1, dtype=torch.int32),
                         zkv.tenant, ztcfg.n_tenants).tolist()
    zslow = KC.by_tenant((zkv.slow_page >= 0).sum(1, dtype=torch.int32),
                         zkv.tenant, ztcfg.n_tenants).tolist()
    phase("15-hybrid-serve", f"{zcfg.name} {zcfg.num_layers} Mamba2 layers "
          f"+ {KC.kv_layer_count(zcfg)} KV layers, {zB} seqs x {zsteps} "
          f"steps, {ztcfg.n_tenants} tenants, equilibria, bf16; promotions "
          f"{zpromos} (attempted "
          f"{int(zkv.counters.attempted_promotions.sum())}) demotions "
          f"{zdemos} (max hotness: slow {zrun['slow_hot_max']:.3g}, fast "
          f"{zrun['fast_hot_max']:.3g}, threshold "
          f"{ztcfg.promo_hot_threshold}) thrash "
          f"{int(zkv.counters.thrash_events.sum())}; launches {hyb_launches}"
          f"; step ms mean {zmean:.3f} median {zms[len(zms) // 2]:.3f} p90 "
          f"{zms[int(len(zms) * 0.9)]:.3f} (CUDA events, impl=cuda); decode "
          f"{zB / (zmean / 1e3):.1f} tokens/s; peak memory {zpeak:.2f} GiB; "
          f"fast pages per tenant {zfast} (budget "
          f"{SD.fast_budget_pages(zcfg, ztcfg, zB, zsteps)}), slow {zslow}; "
          f"Mamba2 state cuda vs ref max rel {zrun.get('mamba_rel', 0):.3g}")
    check_compare(np, zrun, TOL["bf16"], "15-hybrid-agree")
    for name, n in hyb_launches.items():
        require(n > 0, f"hybrid serving never launched {name}")
    want_d1 = d1_launches(zcfg, zsteps)
    require(hyb_launches["ssd_decode"] == want_d1,
            f"hybrid serving launched D1 {hyb_launches['ssd_decode']} times, "
            f"want {want_d1} ({zcfg.num_layers} Mamba2 layers x {zsteps} "
            "steps)")
    d1_err = d1_replay(torch, SDEC, SDEC_REF, zrun["state"]["mamba"].h,
                       d1_in, "15-hybrid-kernel")
    phase("15-hybrid-kernel", f"ssd_decode (D1) on each of the run's "
          f"{zcfg.num_layers} layer slices of its own final state, with the "
          "inputs the path last gave the layer (bf16 conv views), against "
          "the plain version: the state bit for bit in place, the later "
          f"layers untouched, y max abs err {d1_err:.3g} <= {D1_TOL}; "
          f"launches on the path {hyb_launches['ssd_decode']} = "
          f"{zcfg.num_layers} a step")
    rows.append({
        "name": "ssd_decode", "route": "cuda", "source": SERVE_SOURCE,
        "replaces": SERVE_REPLACES["ssd_decode"],
        "launches": hyb_launches["ssd_decode"],
        "max_abs_err": max(serve_err["ssd_decode"], d1_err),
        "ms": d1["zamba2"]["ms"], "plain_ms": d1["zamba2"]["plain_ms"],
        "plain_copy_ms": d1["zamba2"]["plain_copy_ms"],
        "bound_ms": d1["zamba2"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_per_step": hyb_launches["ssd_decode"] / zsteps,
        "bytes": d1["zamba2"]["bytes"],
        "bound_copy_ms": d1["zamba2"]["bytes"] / bw * 1e3,
        "widths": {name: dict(zip("BHPNG", w))
                   for name, w in D1_WIDTHS.items()},
        "mamba2_130m": d1["mamba2_130m"],
    })
    require(zpromos > 0 and zdemos > 0, f"hybrid serving: promotions "
                                        f"{zpromos}, demotions {zdemos}")
    zstep_c = SD.build_serve_step(zcfg, ztcfg, zB, zsteps, impl="cuda")
    zwall, zprof = profile_serve_step(
        torch, zstep_c, zmodel, zrun["snapshot"],
        ztoks_d[:, zsteps // 2:zsteps // 2 + 1])
    if zprof is None:
        phase("15-hybrid-profile", "device time not measured: the profiler "
                                   "saw no device event")
    else:
        n_dev, busy_ms, top, _ = zprof
        ours = {k: [(t, c) for nm, t, c in top
                    if any(d in nm for d in DEVICE_KERNELS[k])]
                for k in SERVE_REPLACES}
        phase("15-hybrid-profile", f"one decode step at position "
              f"{zsteps // 2}: {n_dev:g} device events, busy {busy_ms:.4f} "
              f"ms of {zwall:.4f} ms wall (idle share "
              f"{1 - busy_ms / zwall:.3f}); serving kernels ms/step: "
              + ", ".join(f"{k} {sum(t for t, _ in v):.4f} "
                          f"x{sum(c for _, c in v):g} (device launches per "
                          f"op call "
                          f"{sum(c for _, c in v) / (hyb_launches[k] / zsteps):g})"
                          for k, v in ours.items())
              + "; top by device ms: " + "; ".join(
                  f"{nm[:60]} {t:.4f} ms x{c:g}" for nm, t, c in top[:10]))
    # K5 at S3's widths, on the hybrid run's own cache as it ends
    k5_s3 = k5_numbers(torch, F, TA, TA_REF, zkv, ztcfg.page_tokens,
                       zcfg.num_heads)
    k5_row = next(r for r in rows if r["name"] == "pool_attention_partial")
    k5_row["s3"] = {k: k5_s3[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "n_valid")}
    phase("15-hybrid-kernel", f"pool_attention_partial [S3 state, one KV "
          f"layer, both pools (2 op calls), {k5_s3['n_valid']} valid "
          f"tokens, H={zcfg.num_heads} K={zcfg.num_kv_heads} "
          f"D={zcfg.resolved_head_dim}]: {k5_s3['ms']:.4f} ms (plain "
          f"{k5_s3['plain_ms']:.4f}, library {k5_s3['library_ms']:.4f} "
          f"(SDPA, {k5_s3['library_form']}, the faster form), bound "
          f"{k5_s3['bound_ms']:.5f} at 3.35 TB/s) launches/step "
          f"{hyb_launches['pool_attention_partial'] / zsteps:g}")
    k6_s3 = k6_numbers(torch, np, KMIG, RMIG, zkv, 15)
    k6_row = next(r for r in rows if r["name"] == "migrate_pages")
    k6_row["s3"] = {k: k6_s3[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bytes", "kv")}
    k6_row["s3"]["bound_copy_ms"] = k6_s3["bytes"] / bw * 1e3
    k6_row["s3"]["kv"]["bound_copy_ms"] = k6_s3["kv"]["bytes"] / bw * 1e3
    phase("15-hybrid-kernel", f"migrate_pages [S3 state, {k6_s3['n_sel']} "
          f"of {zB} sequences x {KC.kv_layer_count(zcfg)} layers, one pool]: "
          f"{k6_s3['ms']:.4f} ms (plain {k6_s3['plain_ms']:.4f}, library "
          f"{k6_s3['library_ms']:.4f} (index_copy_), bound "
          f"{k6_s3['bound_ms']:.5f} at 3.35 TB/s, "
          f"{k6_row['s3']['bound_copy_ms']:.5f} at measured copy); K+V in "
          f"one launch {k6_s3['kv']['ms']:.4f} (plain "
          f"{k6_s3['kv']['plain_ms']:.4f}, bound "
          f"{k6_s3['kv']['bound_ms']:.5f}, "
          f"{k6_row['s3']['kv']['bound_copy_ms']:.5f} at measured copy) "
          f"launches/step {hyb_launches['migrate_pages'] / zsteps:g}")
    del zrun, zkv, zstep_c
    torch.cuda.empty_cache()
    side = []
    for mode in ("tpp", "static"):
        r = serve_compare(torch, np, zctx, mode, HYBRID_SIDE_STEPS,
                          TOL["bf16"])
        c = r["state"]["kv"].counters
        side.append(f"{mode}: promotions {int(c.promotions.sum())} "
                    f"demotions {int(c.demotions.sum())}, step ms mean "
                    f"{sum(r['ms']) / len(r['ms']):.3f}")
        check_compare(np, r, TOL["bf16"], f"15-hybrid-{mode}-agree")
        del r
    phase("15-hybrid-modes", f"{HYBRID_SIDE_STEPS} steps each: "
          + " | ".join(side))

    # ---- 16. hybrid decode == forward at full width in float32 ------------
    z32 = with_dtype(zmodel, "float32")
    ztoks_fw = ztoks_d[:HYBRID_FWD_BATCH, :HYBRID_FWD_STEPS].contiguous()
    ctx32 = dict(zctx, cfg=z32.cfg, tcfg=tcfg_fw, model=z32, toks=ztoks_fw,
                 steps=HYBRID_FWD_STEPS)
    d1_in = {}
    with d1_inputs(SDEC, z32.cfg.num_layers, d1_in):
        r32 = serve_compare(torch, np, ctx32, "equilibria",
                            HYBRID_FWD_STEPS, TOL["f32"])
    d1_err32 = d1_replay(torch, SDEC, SDEC_REF, r32["state"]["mamba"].h,
                         d1_in, "16-hybrid-forward")
    SD.equilibria_kv_step = kv_step
    for w in pwrap.values():
        w.launches = 0
    with torch.no_grad():
        ref_logits = hybrid_forward(z32, ztoks_fw)
    fw_launches = {k: w.launches for k, w in pwrap.items()}
    dec = torch.stack(r32["logits"], dim=1)
    fw_rel = float((dec - ref_logits).abs().max() / ref_logits.abs().max())
    c = r32["state"]["kv"].counters
    fw_moves = int(c.promotions.sum() + c.demotions.sum())
    fw_slow = int((r32["state"]["kv"].slow_page >= 0).sum())
    require(fw_rel <= FWD_RTOL, f"hybrid decode != forward: {fw_rel:.3g}")
    require(fw_moves > 0 and fw_slow > 0, "hybrid decode/forward: no "
                                          "migrations")
    require(all(v > 0 for v in fw_launches.values()),
            f"hybrid forward launches {fw_launches}")
    phase("16-hybrid-forward", f"f32 full width, {HYBRID_FWD_BATCH} seqs x "
          f"{HYBRID_FWD_STEPS} steps: max |decode - forward| / max |logit| ="
          f" {fw_rel:.3g} <= {FWD_RTOL} with {fw_moves} page moves and "
          f"{fw_slow} slow pages; forward launches {fw_launches}; Mamba2 "
          f"state cuda vs ref max rel {r32.get('mamba_rel', 0):.3g}; D1 on the "
          f"run's final state with f32 x/B/C: bitwise, y max abs err "
          f"{d1_err32:.3g}")
    check_compare(np, r32, TOL["f32"], "16-hybrid-f32-agree")
    d1_row = next(r for r in rows if r["name"] == "ssd_decode")
    d1_row["max_abs_err"] = max(d1_row["max_abs_err"], d1_err32)
    del r32, dec, ref_logits, z32
    torch.cuda.empty_cache()

    # ---- 17. prefill kernels: time, bound, plain, library ------------------
    def k7_numbers(H, K, D, B=1, S=PREFILL_S):
        g = torch.Generator(device="cuda").manual_seed(17)
        q = torch.randn((B, H, S, D), generator=g, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((B, K, S, D), generator=g, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((B, K, S, D), generator=g, device="cuda").to(
            torch.bfloat16)
        n_pairs = S * (S + 1) // 2                     # causal, Sq == Skv
        nbytes = 2 * (2 * B * H * S * D + 2 * B * K * S * D)
        nops = 4 * B * H * D * n_pairs
        return dict(
            ms=device_ms(lambda: FA.flash_attention(q, k, v), n=10),
            plain_ms=device_ms(lambda: FA_REF.flash_attention_ref(q, k, v),
                               n=5),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), n=10),
            t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
            t_ops=nops / BF16_OPS_PER_S * 1e3, bytes=nbytes, ops=nops,
            peak="bf16 989 TFLOP/s")

    def k8_numbers(H, P, N, G=1, B=1, S=PREFILL_S, Q=256, plain=True):
        g = torch.Generator(device="cuda").manual_seed(18)
        x = torch.randn((B, S, H, P), generator=g, device="cuda") * 0.5
        a = -F.softplus(torch.randn((B, S, H), generator=g, device="cuda")
                        * 1.2)
        b = (torch.randn((B, S, G, N), generator=g, device="cuda") * 0.5
             ).to(torch.bfloat16)
        c = (torch.randn((B, S, G, N), generator=g, device="cuda") * 0.5
             ).to(torch.bfloat16)
        nops = ssd_ops(B, S, H, P, N, G, Q)
        nbytes = (4 * B * S * H * P * 2 + 4 * B * S * H + 2 * 2 * B * S * G
                  * N + 4 * B * H * P * N)
        return dict(
            ms=device_ms(lambda: SSD.ssd_scan(x, a, b, c, chunk=Q), n=10),
            plain_ms=device_ms(lambda: SSD_REF.ssd_scan_ref(x, a, b, c, Q),
                               n=5) if plain else None,
            library_ms=None, t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
            t_ops=nops / F32_OPS_PER_S * 1e3, bytes=nbytes, ops=nops,
            peak="f32 67 TFLOP/s (x, y, h and the products are float32)")

    knum = {"flash_attention": k7_numbers(zcfg.num_heads, zcfg.num_kv_heads,
                                          zcfg.resolved_head_dim),
            "ssd_scan": k8_numbers(112, 64, 64)}
    k8_long = k8_numbers(112, 64, 64, S=TIMED_S, plain=False)
    k7_llama = k7_numbers(cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
    for name, kn in knum.items():
        bound = max(kn["t_bytes"], kn["t_ops"])
        rows.append({
            "name": name, "route": "cuda", "source": PREFILL_SOURCE,
            "replaces": PREFILL_REPLACES[name],
            "launches": prefill_launches[name],
            "max_abs_err": max([pre_err[name]] + [
                r["err"] for r in path_checks
                if r["what"].startswith(KERNEL_TAG[name])]), "ms": kn["ms"],
            "plain_ms": kn["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if kn["t_bytes"] >= kn["t_ops"]
            else "operations",
            "library_ms": kn["library_ms"],
            "launches_per_prefill": {
                k: v["launches"][name] for k, v in prefill_rows.items()},
            "bytes": kn["bytes"], "ops": kn["ops"], "peak": kn["peak"],
        })
        lib = kn["library_ms"]
        earlier = (f"earlier design {EARLIER_MS[name]:.4f}, "
                   if name in EARLIER_MS else "")
        phase("17-prefill-kernel", f"{name} [B=1 S={PREFILL_S} zamba2 "
              f"widths, bf16 inputs]: {kn['ms']:.4f} ms ({earlier}plain "
              f"{kn['plain_ms']:.4f}, library "
              f"{'none' if lib is None else f'{lib:.4f}'}, bound "
              f"{bound:.5f}: bytes {kn['t_bytes']:.5f} at 3.35 TB/s, "
              f"operations {kn['t_ops']:.5f} at {kn['peak']}); launches per "
              f"prefill {rows[-1]['launches_per_prefill']}")
    k8_row = next(r for r in rows if r["name"] == "ssd_scan")
    k8_row["s32768"] = {"ms": k8_long["ms"], "bound_ms": max(
        k8_long["t_bytes"], k8_long["t_ops"])}
    phase("17-prefill-kernel", f"ssd_scan [B=1 S={TIMED_S} zamba2 widths, "
          f"bf16 B/C]: {k8_long['ms']:.4f} ms an op call (bound "
          f"{k8_row['s32768']['bound_ms']:.5f}: operations at "
          f"{k8_long['peak']})")
    phase("17-prefill-kernel", f"flash_attention [llama widths H=32 K=8 D=64"
          f", B=1 S={PREFILL_S}, bf16]: {k7_llama['ms']:.4f} ms (earlier "
          f"design {EARLIER_MS['flash_attention_llama']:.4f}, plain "
          f"{k7_llama['plain_ms']:.4f}, library {k7_llama['library_ms']:.4f}"
          f", bound {max(k7_llama['t_bytes'], k7_llama['t_ops']):.5f})")

    # ---- 18. where one Zamba2-7B prefill's device time goes ---------------
    pprof = profile_fn(torch, lambda: zstep(zmodel, {"tokens": ztoks}))
    if pprof is None:
        phase("18-prefill-profile", "device time not measured: the profiler "
                                    "saw no device event")
    else:
        n_dev, busy_ms, top, pwall = pprof
        by_cls = class_ms(top)
        k8_dev = by_cls.get("K8 ssd_scan", (0.0, 0))[1]
        k8_row["device_launches_per_call"] = k8_dev / zcfg.num_layers
        phase("18-prefill-profile", f"{zcfg.name} prefill B={TIMED_B} "
              f"S={TIMED_S}: K8 device launches per op call "
              f"{k8_dev / zcfg.num_layers:g}; {n_dev} device events, busy "
              f"{busy_ms:.1f} ms of"
              f" {pwall:.1f} ms wall (idle share {1 - busy_ms / pwall:.4f}); "
              "device ms by class: " + ", ".join(
                  f"{k} {v[0]:.1f} x{v[1]}" for k, v in sorted(
                      by_cls.items(), key=lambda kv: -kv[1][0]))
              + "; top: " + "; ".join(f"{nm[:50]} {t:.1f} ms x{cnt}"
                                      for nm, t, cnt in top[:8]))
    # the serving contexts hold the model too
    del zmodel, zctx, ctx32, zstep, ztoks, ztoks_d
    torch.cuda.empty_cache()

    churn_phases(torch, np, rows, floor_ms, earlier_topk.result())
    fleet_launches = fleet_phases(torch, np, wrappers)
    # the fleet paths' launches of the tick kernels, beside each row's own
    for row in rows:
        k = row.get("kernel", row["name"])
        row["fleet_launches"] = {p: c[k] for p, c in fleet_launches.items()
                                 if k in c}

    n_checks = len(path_checks)
    fam_env = dict(
        F=F, SD=SD, TF=TF, KC=KC, LAYERS=LAYERS, TA=TA, TA_REF=TA_REF,
        KMIG=KMIG, RMIG=RMIG, FA=FA,
        FA_REF=FA_REF, swrap=swrap, pwrap=pwrap, full_load=full_load,
        SDEC=SDEC, SDEC_REF=SDEC_REF,
        fused_mul_add=fused_mul_add, make_model=make_model,
        prefill_cell=prefill_cell, ssm_lm_forward=ssm_lm_forward,
        TieringConfig=TieringConfig, SSD=SSD, SSD_REF=SSD_REF)
    fam = family_phases(torch, np, fam_env)
    record_families(rows, fam, prefill_rows, path_checks[n_checks:])
    n_checks = len(path_checks)
    cross = cross_phases(torch, np, fam_env)
    record_cross(rows, cross, prefill_rows, path_checks[n_checks:])
    train = train_phases(torch, np, fam_env)
    record_train(rows, train)
    audit = analysis_phase(torch)
    # D1 is not under the audit (None)
    for row in rows:
        row["analysis_launches"] = audit["launches"].get(
            row.get("kernel", row["name"]))
    phase("done", f"{time.perf_counter() - t_start:.1f}s on {smi_line}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
