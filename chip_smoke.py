#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--record PATH]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports nothing of JAX and nothing of the JAX package.  Every phase
raises on failure and the script then exits non-zero; with no card, or
without the repository beside it, it exits non-zero before printing any
result.

Phases, in the order they run (phase 16's two ranks are this script
again, started with --mesh-rank):
  0. the card's name and power limit (nvidia-smi) and the kernel build,
     with each kernel instance's registers, spills and static shared
     memory (nvcc -Xptxas -v);
  2. the first main path, with every kernel's launch count set to 0 just
     before and read just after: each accelerator layer C2-C12 of
     ResNet-18's Table 1 at its published shape as a one-layer Program
     (three requests each), the layer2.0 residual block (C4 -> C6, C5
     shortcut, host residual add with relu), the C2 heterogeneous chain
     (cpu_only 112x112x3 -> 64 stem, C2 body, 64-channel 1x1), and one
     2^16-element vector ALU op.  Every output is held byte-equal to the
     port's numpy conv2d_reference, with zero eager GEMMs, and no request
     after a program's first builds or uploads a block map of the
     scatter instance.  After it, the cost of the exact weight-content
     keys and a torch.profiler view of one C9 request (device idle share,
     launch and copy API calls, device operations, tensor_alu launches
     by instance);
  5. the second main path, with the counts set to 0 just before it and
     read just after: the quantized decoder (serve_lm.py's defaults:
     d_model 64, 2 blocks, 2 heads, d_ff 128, vocab 32, s_max 96) on
     int4 weights (hwspec.lowbit(4), every matmul through lut_gemm) with
     attention="kernel" (decode_attention), served through
     DevicePool(size=2): 4 dialogues x 64 greedy steps, each equal to the
     port's DecoderReference run on the card, with no DRAM allocation
     after warm-up; then the int8 spec with numpy attention (4 x 24
     steps, read on its own);
  6. the int4 decoder through the Scheduler (byte-equal to serial runs)
     and under one seeded FaultPlan (a kill and a bit-flip with respawn,
     checkpoints and integrity CRCs: the fired log matches the plan, the
     loss is typed, survivors are byte-equal to serial runs); VtaLinear at
     bits 4 and 2 and a 1-bit Program, cuda against simulator; the device
     idle share of one profiled int4 decode step;
  1. vta_gemm and tensor_alu (both instances: the standalone chain, and
     the scatter of a tile batch's GEMM blocks with the epilogue, byte
     for byte with the block map each launch used) against their plain
     PyTorch versions, on the card, at every shape the first main path
     launched plus ragged shapes and every epilogue, with CUDA-event
     times beside the least time the card could take; and at every shape
     phases 5 and 6 launched (the
     int8 decoder's 1-2 row GEMMs, the decoders' epilogues), checked but
     not timed, and every shape phase 10's search launched, checked;
     vta_gemm's skinny instance (M <= 16) at M 1, 3, 16 and 17
     with K and N ragged; its wgmma instance (M > 16) at T 3 with M, N
     and K ragged, every epilogue, shifts 0, 9, 31 and 40, with bias, and
     at a deep K in one slice; at every LM shape phases 8, 9, 11 and 12
     launched
     and at Llama-3.2-3B's prefill linears at 512 and 4096 tokens (timed,
     beside torch._int_mm, T calls for T peer tiles, with M padded to 32
     below 17 rows, the GEMM alone for an epilogue); every vta_gemm row
     bitwise equal to the plain version and over two calls;
     quantized_linear's fused route bitwise against its plain chain at
     every (M, N, K, x dtype) phases 8, 9, 11 and 12 served (xlstm's gates
     at N 8, K 4096 among them) and at M 17, 130,
     512 and 4096 (with a given x_scale there too), in bfloat16 and
     float32 x, on x.5 ties and an amax below 1e-6, timed beside the
     PyTorch-op chain the port ran before and torch._int_mm's GEMM, and
     the device time of the served calls above 16 rows added up;
  7. lut_gemm and decode_attention the same way, at every decode-path
     shape (timed), every other shape phases 5 and 6 launched (checked)
     and at Llama-3.2-3B's decode shapes (src/repro/configs/llama32_3b.py);
     decode_attention in bfloat16 within 2^-6 * max|want|; lut_gemm at
     Llama's M 1 and 16 for bits 1, 2 and 4 beside torch._int_mm; the
     LM paths' decode shapes timed at the full cache and at the served
     kv_len 32, beside one scaled_dot_product_attention call (a bfloat16
     query upcast to float32 first where the caches are float32);
  8. the third main path, the LM serve path: llama3.2-3b at full width
     (src/repro_torch/configs/llama32_3b.py; random weights from
     torch.Generator seed 0, int8 PTQ) served by launch.serve.ServeEngine
     (4 slots, max_len 256, float32 caches) to the reference CLI's
     traffic (6 requests, 16-token prompts, 16 new tokens each), then 2
     requests through the bf16 weights and 2 through the int8 weights
     with the int8 KV cache (kv_cache_quant: decode_attention over the
     dequantized bf16 caches); each run replayed with the kernel ops
     swapped for their plain versions (PlainOps, no kernel launched),
     teacher-forced on the kernel run's tokens, every call's logits within
     LM_LOGIT_TOL of max|logit| (the int8 KV cache run within twice the
     gap between two plain replays, materialized and chunked attention
     oracles, where that is larger, and every launch of it held to its
     plain version); launches per prefill and per decode step;
     the device idle share of one profiled decode step.  Its vta_gemm and
     decode_attention shapes are timed in phases 1 and 7, and
     flash_attention is checked and timed in phase 7 at those shapes and
     at Llama-3.2-3B's prefill (S 4096 float32 and bfloat16, S 32768
     bfloat16 against the chunked plain version; bfloat16 runs the wgmma
     kernel, float32 the 3xTF32 one, each timed under its own kernel name
     beside scaled_dot_product_attention), a non-causal ragged
     shape and a causal one with Sk > S; every flash case is also held to
     float64 attention on its own inputs, within FLASH_ORACLE_MULT x
     SDPA's error there (the plain version's where SDPA computes another
     function); decode_attention also at
     starcoder2-7b's G = 9 and with a bfloat16 query over float32 caches;
  9. the fourth main path, the hybrid serve path: zamba2-1.2b at full
     width (src/repro_torch/configs/zamba2.py: 38 Mamba2 layers and a
     shared attention block applied 6 times; seed 0, int8 PTQ) served by
     ServeEngine (4 slots, max_len 1024, float32 caches) to the reference
     CLI's traffic, then one request with a 512-token prompt (8 chunks of
     the scan), then 2 requests through the bf16 weights and 2 through a
     float32 copy; each replayed with PlainOps (gla_chunk swapped too)
     and again with the scan by its step recurrence (the model's own
     rounding floor): the float32 run within LM_LOGIT_TOL, the bf16 and
     int8 runs, whose floor exceeds it, within twice their floor; every
     launch of the int8 and bf16 runs held to its plain version on the
     same inputs (CheckedOps); every
     prefill held to 38 gla_chunk, 6 flash_attention and 118 vta_gemm
     launches and every decode step to 6 decode_attention, 118 vta_gemm
     and 0 gla_chunk (0 vta_gemm on bf16 weights); the device idle share
     of one profiled decode step.  Its vta_gemm, decode_attention and
     flash_attention shapes join phases 1 and 7, and phase 7 holds
     gla_chunk against its plain version at every shape the path (and
     phase 11's xlstm path) launched
     (timed), at zamba2-1.2b's prefill at S 4096 and 32768 and at
     xlstm-1.3b's mLSTM scan (N 256, P 1025, chunk 512, bf16 q and k per
     head) at S 4096 (timed), at the reference's kernel-test shapes with a
     nonzero h0, at Q = 16, with bfloat16 q and k, with and without
     stride-0 heads, at N 256 with S = chunk = 512, N 72 and N 1; bitwise
     equal over two calls; up to S 4096 also against the step recurrence
     in float64, within 4x the plain version's error;
 10. the autotuner (core/autotune.py, the paper's design-space search)
     on the card, with the counts set to 0 just before it and read just
     after: search(backend="cuda", torch_device="cuda") into a local
     TuningCache on benchmarks/BENCH_autotune.json's two workloads
     (conv3x3 14x14x32-32 and matmul 64x128x128, seed 0, 12 candidates,
     top 4) and on ResNet-18's C9 (14x14, 256 -> 256, 3x3; 8 candidates,
     top 2): stage 1 (candidates, replayed cycles, ranking) equal to
     stage 1 on CPU tensors in the same run, no candidate dropped by
     validation (the CUDA engine byte-equal to the simulator on every
     segment, under tiles of block_in and block_out 8, 16 and 32), the
     winner validated, its recompile under the search's records (swapped
     into the global cache and restored) all hits, its output byte-equal
     to conv2d_reference / matmul_reference; each stage-2 trial's
     predicted over measured time recorded.  Every vta_gemm, tensor_alu
     and tensor_alu_scatter shape the search launched joins phase 1's
     checks (count 0);
 11. xlstm-1.3b served (src/repro_torch/configs/xlstm_1b.py, nothing
     cut: 42 mLSTM and 6 sLSTM layers; seed 0, int8 PTQ) by ServeEngine
     (4 slots, max_len 1024, float32 caches) to the reference CLI's
     traffic, one 512-token prompt (gla_chunk B1 S512 H4 N256 P1025 at
     chunk 512, bf16 q and k), 2 requests on bf16 weights and 2 through
     a float32 copy; each run held to its teacher-forced plain replays
     as phase 9's are, every
     launch to its plain version (CheckedOps), every prefill to 42
     gla_chunk and 306 vta_gemm launches and every decode step to 306
     vta_gemm (0 on bf16 weights) and no other kernel; the device idle
     share of one profiled decode step, and the time and device
     operations of one sLSTM layer's 512-step prefill loop.  Its
     vta_gemm and quantized_linear shapes join phase 1 and its gla_chunk
     shapes phase 7 (timed);
 12. the moe models served (models/moe.py: routing in float32, the
     sort-based capacity dispatch, the experts' torch.bmm swiglu, the
     combine), with the counts set to 0 just before each run and read
     just after: phi3.5-moe-42b-a6.6b at its published widths
     (src/repro_torch/configs/phi35_moe.py: 32 layers, d 4096, 16
     experts, top-2, expert width 6400; seed 0), its weights built on the
     card to fit (82.41 GB under int8 PTQ, the experts bf16 as the
     reference keeps them), by ServeEngine (4 slots, max_len 256, float32
     caches) to the reference CLI's traffic and one 512-token prompt
     (max_len 544) on int8 PTQ, 2 requests with bf16 attention at
     PHI_BF16_LAYERS layers beside the same experts, and 2 through a
     float32 model at PHI_F32_LAYERS layers; then kimi-k2-1t-a32b at its
     published widths (384 experts, top-8, a shared expert) cut to
     KIMI_LAYERS layers, int8, to the CLI traffic.  Each run is held to
     its plain replays, forced to its routing as to its tokens (the
     float32 run within LM_LOGIT_TOL, the others within twice the gap
     between two plain replays with other attention oracles where that
     is larger), every launch to its plain version (CheckedOps), every
     prefill to one flash_attention and every decode step to one
     decode_attention a layer, and both to 4 quantized_linear calls a
     layer (7 on kimi-k2) on int8 weights and nothing else; the float32
     matmuls may not run in TF32; records mem_get_info beside each
     build, the share of routing decisions the plain replay made as the
     run did, the dropped pairs (by layer for the long prompt), and one
     profiled decode step of each int8 model beside its byte bound, with
     its expert FFNs timed alone.  Its
     vta_gemm, quantized_linear, decode_attention and flash_attention
     shapes join phases 1 and 7 (timed);
 13. the encoder-decoder and vision paths, with the counts set to 0 just
     before each run and read just after: whisper-large-v3 at its
     published widths and full depth (src/repro_torch/configs/
     whisper_large_v3.py: 32 encoder and 32 decoder layers, d 1280, 20
     heads of 64, 1500 frames; seed 0) through T.prefill on 4 clips of
     frames (N(0, 1) from a seeded torch.Generator) and 16-token prompts,
     then 16 greedy T.decode_step calls (caches of 64 rows), on int8 PTQ
     over float32 caches (the step's cross-attention a bfloat16 query
     over float32 K/V: the mixed-dtype flash route), bf16 over bf16
     caches and a float32 model; ServeEngine refusing it; then
     phi-3-vision-4.2b at its published widths and full depth
     (configs/phi3_vision.py: 32 layers, d 3072, 32 heads of 96, 576
     patches) the same way on 2 images of patch embeddings and 16 text
     tokens each (caches of 640 rows; int8, bf16 over bf16 caches,
     float32), and on tokens alone through ServeEngine to the reference
     CLI's traffic (int8).  Each run held to its teacher-forced plain
     replays (the float32 runs within LM_LOGIT_TOL, the others within
     twice the gap between two plain replays with other attention
     oracles where that is larger), every launch to its plain version
     (CheckedOps), every prefill and step to encdec_launches; records
     mem_get_info beside each build, whisper's encoder ms apart from the
     prefill, and one profiled int8 decode step of each model beside its
     byte bound (step_bytes).  Its vta_gemm, quantized_linear,
     decode_attention and flash_attention shapes join phases 1 and 7
     (timed; the mixed-dtype flash shapes under the dtype
     "bfloat16/float32");
 14. training, with the counts set to 0 just before the run and read
     just after: llama3.2-3b at its published width and depth (28 layers,
     bf16 parameters, AdamW, remat) trains 4 steps of 2 x 4096 tokens
     through repro_torch.launch.train.Trainer (the reference's train_4k
     shape, its global batch of 256 cut to 2 for one card): per-step loss
     and ms, tokens/s, the peak allocated memory, 56 flash forward and 28
     backward launches a step (asserted), the first step's backward
     launches of layers 27 and 0 held to the plain backward, and a fifth
     step under torch.profiler for the device idle share; then full width
     at 2 layers in float32 (S 512), one step's loss and every gradient
     leaf held to a replay with every op's plain version (PlainOps), and a
     checkpoint round trip (save after step 2, restore into a fresh
     Trainer, step 3 bitwise equal to the uninterrupted run's).  (The
     flash backward kernels are held to the plain backward after phase
     16: see there.)  Then the recurrent
     models (RECURRENT_TRAIN), each with the counts set to 0 just before:
     zamba2-1.2b (38 Mamba2 layers, the shared attention block 6 times)
     4 steps of 2 x 4096 tokens, and xlstm-1.3b at 24 of its 48 layers
     (21 mLSTM, 3 sLSTM) 3 steps of 2 x 2048 (its sLSTM loops cut S and
     the depth), bf16 and AdamW with remat: per-step loss and ms,
     tokens/s, peak allocated memory, the gla_chunk and flash launches of
     every step (76 / 38 / 12 / 6 and 42 / 21 / 0 / 0, asserted), step 1's gla backward launches of the
     last and first scan layer held to the float64 plain backward,
     xlstm's sLSTM-loop share of its third step (its second step alone
     is its step ms), and one profiled step's idle share; each at one
     repeating unit (6 and 8 layers, S 512) in float32 against its plain
     replay, within twice the plain replays' own floor (the loss's, each
     leaf's) where that exceeds 1e-5 (loss) and 1e-4 (leaves), and
     through a bitwise checkpoint round trip; then the gla_chunk backward
     kernel (gla_bwd.cu) against the plain backward in float64 at
     GLA_BWD_CASES and every shape training launched (each output within
     4x the float32 plain backward's error), timed beside its bound and
     the plain backward, and the forward kernel at the long slow-decay
     case against float64.  Its flash and gla_chunk forward shapes join
     phase 7;
 15. the port's examples and the data-parallel mesh path, with the
     counts set to 0 just before each run and read just after: the main()
     of examples/quickstart_torch.py (steps 1-15 of the reference's
     quickstart on the CUDA engine, every assertion of the reference's),
     resnet18_offload_torch.py at C12 and at its default C9 (the
     simulator study, the channel-scaled chain on both engines, and the
     anchor layer unscaled on the CUDA engine alone, timed) and
     serve_lm_torch.py (2 dialogues x 6 steps on 2 slots, and 4 x 24),
     each with --device cuda at tests/test_examples.py's arguments, their
     own assertions the check, their launches by kernel recorded
     (vta_gemm, tensor_alu_scatter and lut_gemm asserted launched; every
     shape they launched joins phases 1 and 7, checked); then, on a
     one-rank nccl process group, llama3.2-3b and zamba2-1.2b at phase
     14's shapes through Trainer(mesh=make_mesh((1, 1), ("data",
     "model")), fsdp=True) for 3 steps and the meshless Trainer for 3
     from the same seed: losses, gradient norms and the parameters after
     step 3 bitwise equal, the flash and gla_chunk launches of phase 14
     (forward and backward) every step, each run's step ms, peak
     allocated memory and one profiled step's idle share; and
     compressed_mean_local on CUDA tensors at llama's largest parameter
     leaf, two steps with the error carried, bitwise against its plain
     computation on CPU tensors, the payload crossing the all-reduce as
     int32;
 16. tensor and expert parallelism: this script started again as two
     processes on the card (--mesh-rank 0 and 1), joined by gloo over
     CUDA tensors on a (data 1, model 2) mesh (nccl takes one rank a
     device; the kernels are built already, so the ranks only load
     them), each rank's counts set to 0 just before each run and read
     just after: llama3.2-3b at full width and depth, tensor-parallel
     (heads, MLP and vocab split over "model"), 3 steps of 2 x 4096
     tokens (bf16, AdamW, remat), and phi3.5-moe at full width and 2
     layers, expert-parallel (8 experts a rank) by its own moe_fused_ep,
     3 steps, then one step unfused (the psum branch); per run and rank:
     the losses (equal on both ranks), step ms, tokens/s, peak allocated
     memory, one profiled step's idle share, 2L flash forward and L
     backward launches a step at the local shapes (asserted), step 1's
     first forward launch held to the plain version and its backward
     launches of the last and first layers held to the plain backward
     row by row; then at one layer, float32, S 512 each model's two-rank
     loss and every gradient leaf (gathered whole) against the meshless
     step on rank 0: the loss within 1e-5 relative, each leaf within
     1e-4 of its max|grad| (phase 14's limits; neither model scans, so
     the plain replays' gap is 0); then llama3.2-3b at full width and
     depth on int8 PTQ weights served on the same mesh (MESH16_INT8: a
     16-token prefill of 2 rows and 4 greedy decode steps through the
     dry run's mesh serve step, vta_gemm at the tensor-parallel local
     shapes), its logits held within LM_LOGIT_TOL of max|logit| of the
     meshless int8 run on the same tokens (rank 0), and every
     quantized_linear call's activation scale held to the global max|x|
     (the ranks' maxima gathered after the run).  The local forward
     shapes join phase 7 (timed), the int8 local shapes phase 1 (held
     bitwise to the plain chain, a given x_scale too).  Then the flash backward kernels against the plain
     backward at FLASH_BWD_CASES (Llama's, whisper's encoder in bf16 and
     float32, phi-3-vision's, a long-key float32 shape, a head dim
     zero-padded and two on the wide kernel) and every shape phases 14
     and 16 launched, timed beside the bound, the plain backward and
     scaled_dot_product_attention's backward.  Phase 7 also holds the
     forward at a zero-padded head dim in each dtype and on the wide
     kernels (flash_wide.cu: wgmma in bf16, 3xTF32 in float32) at D 160
     and 256, and with the output in slices at D 320 and 512 in each
     dtype (the backward there too),
     timed;
 17. the dry run against the card: ``launch/dryrun.py`` (the meta
     device, a fake process group, no card), in a subprocess of this
     script under its own timeout, predicts the peak allocated bytes of
     phase 14's meshless llama3.2-3b and zamba2-1.2b steps and of phase
     16's rank 0 (llama3.2-3b tensor-parallel, phi3.5-moe at 2 layers
     expert-parallel); each within 10% of the measured peak, printed
     with the five largest live tensors at the predicted peak and the
     compute, memory and collective terms beside the measured step ms;
  3. the simulator and cuda engines on one stream, DRAM images compared;
  4. the kernels line, the card line, and the result line.

With --record PATH, a detailed record (per-layer request times,
per-shape kernel times, the request profile, the nvcc reports) is
written to PATH as JSON.
"""
import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# no int32 figure in the table: the non-tensor-core float32 rate stands in
# for the int32 ALU rate (tensor_alu is bound by bytes either way)
INT32_ALU_OPS_PER_S = 67e12
# where the main path runs; main() refuses to run without a card
DEVICE = "cuda"
# the most rows vta_gemm's skinny instance takes (kernel.py:SKINNY_MAX_M);
# above it the wgmma instance runs
SKINNY_ROWS = 16


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_time_ms(fn, reps=20, warmup=3):
    """Median per-call time of fn() between two CUDA events: the device
    time of one call, plus any gap while the host prepares the launch."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


#: profiler windows that saw none of their kernels and were taken again
PROFILER_RETRIES = []
#: windows in which the profiler saw fewer launches of a kernel than ran
PROFILER_DROPS = []
#: (kernel, ms) timed by CUDA events after every profiler window was empty
PROFILER_FALLBACKS = []
#: the least CUDA-event time per call that may stand in for the profiler's
#: device time: the host's share of a call is ~0.05 ms (call_ms - ms at
#: the small shapes of the kernels line), under 5% of a call this long
EVENT_CLOCK_MIN_MS = 1.0


def kernel_ms(fn, kernel_name, call_ms, reps=20, attempts=8):
    """Device time of the CUDA kernels named `kernel_name` per call of
    fn(), from torch.profiler: for each distinct kernel matched, its total
    device time over the launches the profiler recorded, summed over the
    kernels (each runs once per call).  The profiler can lose activity
    records (seen: one of three 216 ms launches recorded, and no launch
    at all in eight windows in a row); a window that recorded fewer
    launches than ran is noted, and one that recorded none is taken
    again, up to `attempts` windows in all.  When no window sees them,
    `call_ms` (fn()'s CUDA-event time) stands in if it is at least
    EVENT_CLOCK_MIN_MS, where the host's part of a call is small; the
    substitution is logged and recorded.  Below that the script fails:
    there the event time would be mostly the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call_us, seen = 0.0, []
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
            if kernel_name in ev.key and t > 0 and ev.count > 0:
                per_call_us += t / ev.count
                seen.append(ev.count)
        if seen:
            if min(seen) < reps:
                PROFILER_DROPS.append((kernel_name, min(seen), reps))
                log(f"  torch.profiler recorded {min(seen)} of {reps} "
                    f"{kernel_name} launches in this window")
            return per_call_us / 1e3
        PROFILER_RETRIES.append(kernel_name)
        log(f"  torch.profiler saw no {kernel_name} in window "
            f"{attempt + 1} of {attempts}")
    if call_ms >= EVENT_CLOCK_MIN_MS:
        PROFILER_FALLBACKS.append((kernel_name, call_ms))
        log(f"  {kernel_name}: CUDA events' {call_ms:.4f} ms per call stand "
            f"in for the profiler's device time")
        return call_ms
    fail(f"torch.profiler saw no device time for {kernel_name} in "
         f"{attempts} windows, and its call ({call_ms:.4f} ms) is too short "
         f"for CUDA events to stand in")


# ----------------------------------------------------------------------
# phase 2: the main path
# ----------------------------------------------------------------------
def layer_epilogue(shape, spec, rng):
    """3x3 layers: bias, shift, relu.  1x1 shortcut layers: shift only
    (the fused requant path)."""
    import numpy as np
    from repro_torch.core.scheduler import Epilogue
    if shape.kh == 1:
        return Epilogue(shift=6)
    bias = rng.integers(-512, 512, size=shape.oc, dtype=np.int32)
    bb = np.repeat(bias.reshape(-1, 1, spec.block_out), spec.batch, axis=1)
    return Epilogue(bias_blocked=bb, shift=8, relu=True)


def serve(compiled, make_inputs, reference, n_requests=3):
    """Serve n requests; hold each output byte-equal to its reference, and
    the block maps of the scatter instance to the first request (a later
    request that builds or uploads one fails).  Returns (wall ms per
    request, launches per request of vta_gemm, of tensor_alu's standalone
    instance and of its scatter instance)."""
    import numpy as np
    from repro_torch.core.backend import assert_fast_path, block_map_info
    from repro_torch.kernels.tensor_alu import tensor_alu, tensor_alu_scatter
    from repro_torch.kernels.vta_gemm import vta_gemm
    walls, g_l, a_l, s_l = [], [], [], []
    for r in range(n_requests):
        inputs = make_inputs(r)
        g0, a0 = vta_gemm.launches, tensor_alu.launches
        s0, maps0 = tensor_alu_scatter.launches, block_map_info()
        t0 = time.perf_counter()
        out = compiled(**inputs)      # returns host numpy: device done
        walls.append((time.perf_counter() - t0) * 1e3)
        g_l.append(vta_gemm.launches - g0)
        a_l.append(tensor_alu.launches - a0)
        s_l.append(tensor_alu_scatter.launches - s0)
        maps = block_map_info()
        if r > 0 and (maps["builds"], maps["uploads"]) != (
                maps0["builds"], maps0["uploads"]):
            fail(f"request {r} built or uploaded a block map: {maps0} -> "
                 f"{maps}")
        want = reference(inputs)
        if out.dtype != want.dtype or out.shape != want.shape \
                or not np.array_equal(out, want):
            fail(f"request {r}: output differs from conv2d_reference "
                 f"({int(np.count_nonzero(out != want))} elements)")
        assert_fast_path(compiled.last_stats)
        if any(s.backend != "cuda" for s in compiled.last_stats):
            fail("a segment did not run on the cuda engine")
    return walls, g_l, a_l, s_l


def phase_layers(rec):
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.conv import conv2d_reference
    from repro_torch.core.program import Program
    from repro_torch.core.workloads import resnet18_table1
    spec = hwspec.pynq()
    for layer in resnet18_table1():
        if layer.cpu_only:
            continue
        s = layer.shape
        rng = np.random.default_rng(1000 + s.h + s.ic + s.oc + s.kh)
        w = rng.integers(-8, 8, size=(s.oc, s.ic, s.kh, s.kw), dtype=np.int8)
        ep = layer_epilogue(s, spec, rng)
        p = Program(spec)
        p.conv2d(p.input("x", (s.n, s.ic, s.h, s.w)), p.constant("w", w), s,
                 epilogue=ep, name=layer.name)
        t0 = time.perf_counter()
        c = p.compile(use_cache=False, torch_device=DEVICE)
        compile_ms = (time.perf_counter() - t0) * 1e3

        def make(r, s=s):
            g = np.random.default_rng(r + 17 * s.h + s.ic)
            return {"x": g.integers(-64, 64, size=(s.n, s.ic, s.h, s.w),
                                    dtype=np.int8)}
        walls, g_l, a_l, s_l = serve(
            c, make, lambda inp, w=w, s=s, ep=ep: conv2d_reference(
                inp["x"], w, s, epilogue=ep))
        st = c.last_stats[0]
        row = dict(layer=layer.name, shape=str(s), lowering=c.nodes[2].lowering,
                   insns=c.insn_count, compile_ms=compile_ms,
                   request_ms=walls, vta_gemm_launches=g_l,
                   tensor_alu_launches=a_l, tensor_alu_scatter_launches=s_l,
                   tile_batches=st.tile_batches,
                   tiles_resolved=st.tiles_resolved,
                   coalesced_gemm_insns=st.coalesced_gemm_insns)
        rec["layers"].append(row)
        log(f"  {layer.name:4s} {c.nodes[2].lowering:10s} {c.insn_count:5d} "
            f"insns  compile {compile_ms:7.1f} ms  requests "
            + " ".join(f"{x:7.2f}" for x in walls)
            + f" ms  launches/request vta_gemm {g_l[-1]} tensor_alu "
            f"{a_l[-1]} scatter {s_l[-1]}")


def residual_relu(a, b):
    """int8 residual add with the tensor ALU's saturation, then relu."""
    import numpy as np
    s = np.clip(a.astype(np.int32) + b.astype(np.int32), -128, 127)
    return np.maximum(s, 0).astype(np.int8)


def phase_block(rec):
    """ResNet-18 layer2.0: C4 -> C6 main branch, C5 shortcut, host
    residual add with relu; one Program with fan-out."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.conv import conv2d_reference
    from repro_torch.core.program import Program
    from repro_torch.core.scheduler import Epilogue
    from repro_torch.core.workloads import layer_by_name
    spec = hwspec.pynq()
    c4, c5, c6 = (layer_by_name(n).shape for n in ("C4", "C5", "C6"))
    rng = np.random.default_rng(44)
    w4 = rng.integers(-8, 8, size=(c4.oc, c4.ic, 3, 3), dtype=np.int8)
    w6 = rng.integers(-8, 8, size=(c6.oc, c6.ic, 3, 3), dtype=np.int8)
    w5 = rng.integers(-8, 8, size=(c5.oc, c5.ic, 1, 1), dtype=np.int8)
    ep4 = layer_epilogue(c4, spec, rng)
    b6 = np.repeat(rng.integers(-512, 512, size=c6.oc, dtype=np.int32)
                   .reshape(-1, 1, spec.block_out), spec.batch, axis=1)
    ep6 = Epilogue(bias_blocked=b6, shift=8)       # relu after the join
    ep5 = Epilogue(shift=6)
    p = Program(spec)
    x = p.input("x", (1, c4.ic, c4.h, c4.w))
    h = p.conv2d(x, p.constant("w4", w4), c4, epilogue=ep4, name="C4")
    h = p.conv2d(h, p.constant("w6", w6), c6, epilogue=ep6, name="C6")
    sc = p.conv2d(x, p.constant("w5", w5), c5, epilogue=ep5, name="C5")
    p.output(p.host(residual_relu, h, sc, shape=(1, c6.oc, c6.oh, c6.ow),
                    name="join", key="residual_relu"))
    t0 = time.perf_counter()
    c = p.compile(use_cache=False, torch_device=DEVICE)
    compile_ms = (time.perf_counter() - t0) * 1e3

    def ref(inp):
        a = conv2d_reference(conv2d_reference(inp["x"], w4, c4, epilogue=ep4),
                             w6, c6, epilogue=ep6)
        return residual_relu(a, conv2d_reference(inp["x"], w5, c5,
                                                 epilogue=ep5))
    walls, g_l, a_l, s_l = serve(c, lambda r: {"x": np.random.default_rng(
        500 + r).integers(-64, 64, size=(1, 64, 56, 56), dtype=np.int8)},
        ref)
    rec["block"] = dict(describe=c.describe(), compile_ms=compile_ms,
                        request_ms=walls, vta_gemm_launches=g_l,
                        tensor_alu_launches=a_l,
                        tensor_alu_scatter_launches=s_l, insns=c.insn_count,
                        fences=c.n_fences)
    log(f"  layer2.0 block: {c.describe()}")
    log(f"    compile {compile_ms:.1f} ms; requests "
        + " ".join(f"{x:.2f}" for x in walls)
        + f" ms; launches/request vta_gemm {g_l[-1]} tensor_alu {a_l[-1]} "
        f"scatter {s_l[-1]}")


def phase_chain(rec):
    """examples/resnet18_offload.py's heterogeneous chain at C2: a
    cpu_only 7x7/2 stem 112x112x3 -> 64, the C2 body, a 64-channel 1x1."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.conv import ConvShape, conv2d_reference
    from repro_torch.core.program import Program
    from repro_torch.core.scheduler import Epilogue
    from repro_torch.core.workloads import layer_by_name
    spec = hwspec.pynq()
    body = layer_by_name("C2").shape
    stem = ConvShape(n=1, h=112, w=112, ic=3, oc=64, kh=7, kw=7, stride=2,
                     pad=3)
    point = ConvShape(n=1, h=56, w=56, ic=64, oc=64, kh=1, kw=1, stride=1,
                      pad=0)
    ep = Epilogue(shift=5, relu=True)
    rng = np.random.default_rng(1)
    k1 = rng.integers(-8, 8, size=(64, 3, 7, 7), dtype=np.int8)
    k2 = rng.integers(-8, 8, size=(64, 64, 3, 3), dtype=np.int8)
    k3 = rng.integers(-8, 8, size=(64, 64, 1, 1), dtype=np.int8)
    p = Program(spec)
    t = p.conv2d(p.input("x", (1, 3, 112, 112)), p.constant("k1", k1), stem,
                 epilogue=ep, cpu_only=True, name="stem")
    t = p.conv2d(t, p.constant("k2", k2), body, epilogue=ep, name="C2")
    p.conv2d(t, p.constant("k3", k3), point, epilogue=ep, name="point")
    t0 = time.perf_counter()
    c = p.compile(use_cache=False, torch_device=DEVICE)
    compile_ms = (time.perf_counter() - t0) * 1e3

    def ref(inp):
        r = conv2d_reference(inp["x"], k1, stem, epilogue=ep)
        r = conv2d_reference(r, k2, body, epilogue=ep)
        return conv2d_reference(r, k3, point, epilogue=ep)
    walls, g_l, a_l, s_l = serve(c, lambda r: {"x": np.random.default_rng(
        900 + r).integers(-64, 64, size=(1, 3, 112, 112), dtype=np.int8)},
        ref)
    rec["chain"] = dict(describe=c.describe(), compile_ms=compile_ms,
                        request_ms=walls, vta_gemm_launches=g_l,
                        tensor_alu_launches=a_l,
                        tensor_alu_scatter_launches=s_l)
    log(f"  C2 chain: {c.describe()}")
    log(f"    compile {compile_ms:.1f} ms; requests "
        + " ".join(f"{x:.2f}" for x in walls)
        + f" ms; launches/request vta_gemm {g_l[-1]} tensor_alu {a_l[-1]} "
        f"scatter {s_l[-1]}")


def phase_vector(rec):
    """One Program.vector_binop of 2^16 int32 elements (the dense vector
    ALU path: _alu_eager_region)."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.backend import assert_fast_path
    from repro_torch.core.program import Program
    from repro_torch.kernels.tensor_alu import tensor_alu
    n = 1 << 16
    p = Program(hwspec.pynq())
    p.vector_binop(p.input("a", (n,), dtype="int32"),
                   p.input("b", (n,), dtype="int32"))
    c = p.compile(use_cache=False, torch_device=DEVICE)
    rng = np.random.default_rng(65536)
    a = rng.integers(-(1 << 30), 1 << 30, size=n, dtype=np.int32)
    b = rng.integers(-(1 << 30), 1 << 30, size=n, dtype=np.int32)
    a0 = tensor_alu.launches
    t0 = time.perf_counter()
    got = c(a=a, b=b)
    wall = (time.perf_counter() - t0) * 1e3
    want = (a.astype(np.int64) + b).astype(np.int32).astype(np.int8)
    if not np.array_equal(got, want):
        fail("vector_binop differs from the int8-narrowed sum")
    assert_fast_path(c.last_stats)
    rec["vector"] = dict(n=n, request_ms=wall, insns=c.insn_count,
                         tensor_alu_launches=tensor_alu.launches - a0)
    log(f"  vector_binop 2^16: {c.insn_count} insns, {wall:.2f} ms, "
        f"tensor_alu launches {tensor_alu.launches - a0}")


def content_key_cost(rec):
    """What the exact weight-content keys cost on the card over one warm C2
    and one warm C12 request, from the engine's RunStats.content_key_*
    counters: device-to-host copies, bytes, and host ms.  Each copy also
    waits for the work queued before it, so the time is an upper bound."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.program import Program
    from repro_torch.core.workloads import layer_by_name
    out = {}
    spec = hwspec.pynq()
    for name in ("C2", "C12"):
        s = layer_by_name(name).shape
        rng = np.random.default_rng(3)
        p = Program(spec)
        p.conv2d(p.input("x", (1, s.ic, s.h, s.w)), p.constant(
            "w", rng.integers(-8, 8, (s.oc, s.ic, s.kh, s.kw),
                              dtype=np.int8)), s,
            epilogue=layer_epilogue(s, spec, rng))
        c = p.compile(use_cache=False, torch_device=DEVICE)
        x = rng.integers(-64, 64, (1, s.ic, s.h, s.w), dtype=np.int8)
        c(x=x)
        t0 = time.perf_counter()
        c(x=x)
        total = (time.perf_counter() - t0) * 1e3
        n = sum(st.content_key_copies for st in c.last_stats)
        nbytes = sum(st.content_key_bytes for st in c.last_stats)
        ms = sum(st.content_key_s for st in c.last_stats) * 1e3
        if n <= 0:
            fail(f"{name}: the engine counted no weight-content key copies")
        out[name] = dict(copies=n, bytes=nbytes, ms=ms, request_ms=total)
        log(f"  weight-content keys, {name}: {n} device-to-host copies, "
            f"{nbytes} bytes, {ms:.2f} ms of a {total:.2f} ms request")
    rec["content_keys"] = out


#: host API calls counted in a profiled request (the runtime's kernel
#: launches, plain and with attributes such as a cluster shape, and its
#: async copies)
API_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync")


def request_profile(rec, name="C9"):
    """Where one full-width request's time goes: torch.profiler over one
    request of layer `name` (after a warm one).  Device busy time is the
    sum of the CUDA kernels' and copies' device time; the rest of the
    profiled wall time the card sat idle.  Also counted in the profiled
    request: the host's launch and copy API calls, the device operations,
    and each tensor_alu instance's launches (a tree without the scatter
    instance counts none of it).  The profiler's own cost inflates the
    wall time; the unprofiled request time is recorded too."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import hwspec
    from repro_torch.core.program import Program
    from repro_torch.core.workloads import layer_by_name
    from repro_torch.kernels.tensor_alu import ops as alu_ops
    instances = {k: getattr(alu_ops, k) for k in ("tensor_alu",
                                                  "tensor_alu_scatter")
                 if hasattr(alu_ops, k)}
    spec = hwspec.pynq()
    s = layer_by_name(name).shape
    rng = np.random.default_rng(9)
    p = Program(spec)
    p.conv2d(p.input("x", (1, s.ic, s.h, s.w)), p.constant(
        "w", rng.integers(-8, 8, (s.oc, s.ic, s.kh, s.kw), dtype=np.int8)),
        s, epilogue=layer_epilogue(s, spec, rng))
    c = p.compile(use_cache=False, torch_device=DEVICE)
    x = rng.integers(-64, 64, (1, s.ic, s.h, s.w), dtype=np.int8)
    c(x=x)
    t0 = time.perf_counter()
    c(x=x)
    plain_ms = (time.perf_counter() - t0) * 1e3
    n0 = {k: op.launches for k, op in instances.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c(x=x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: op.launches - n0[k] for k, op in instances.items()}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    avgs = prof.key_averages()
    calls = {k: sum(e.count for e in avgs if e.key == k) for k in API_CALLS}
    ops = sorted(avgs, key=lambda e: -e.self_cpu_time_total)
    top = [dict(op=e.key, calls=e.count,
                self_cpu_ms=e.self_cpu_time_total / 1e3) for e in ops[:12]]
    rec["profile"] = dict(layer=name, request_ms=plain_ms,
                          profiled_ms=wall_ms, device_busy_ms=dev_ms,
                          idle_share=1 - dev_ms / wall_ms, top_cpu_ops=top,
                          api_calls=calls, device_ops=len(dev),
                          tensor_alu_launches=launches)
    log(f"  profile {name}: request {plain_ms:.2f} ms ({wall_ms:.2f} ms "
        f"profiled); device busy {dev_ms:.3f} ms -> idle share "
        f"{1 - dev_ms / wall_ms:.4f}; {len(dev)} device operations; "
        + ", ".join(f"{k} {n}" for k, n in calls.items())
        + "; tensor_alu launches " + ", ".join(
            f"{k} {n}" for k, n in launches.items()))
    for t in top[:6]:
        log(f"    {t['op']}: {t['calls']} calls, {t['self_cpu_ms']:.2f} ms "
            f"self CPU")
    return rec["profile"]


# ----------------------------------------------------------------------
# phase 1: kernels against plain versions
# ----------------------------------------------------------------------
def gemm_bound_ms(T, M, N, K, epilogue, has_bias):
    out_b = {"none": 4, "requant": 1, "dequant": 4}[epilogue]
    nbytes = T * (M * K + N * K + M * N * out_b) + 4 * N * has_bias \
        + 4 * N * (epilogue == "dequant")
    ops = 2 * T * M * N * K
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT8_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def alu_bound_ms(numel, n_ops, has_src):
    nbytes = numel * 4 * (2 + has_src)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = numel * n_ops / INT32_ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


#: (M, N, K) of Llama-3.2-3B's prefill linears at 512 and 4096 tokens
#: (q/o, k/v, gate/up, down; src/repro_torch/configs/llama32_3b.py)
LLAMA_PREFILL_GEMMS = [(m, n, k) for m in (512, 4096) for n, k in (
    (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192))]


def int_mm_ms(a, w_nk, want, epi, has_bias, M, N, K):
    """The library yardstick of a vta_gemm row (never used by the port):
    torch._int_mm, int8 x int8 -> int32 on the tensor cores, once per
    peer tile (T calls), held against the plain version's sums; it takes
    at least 17 rows, so rows at 16 or fewer go in padded to 32, and for
    an epilogue or a bias it is the GEMM alone.  (None, None) where it
    refuses the shape (K or N not a multiple of 8)."""
    import torch
    from repro_torch.kernels.vta_gemm import vta_gemm_ref
    T = a.shape[0]
    if K % 8 or N % 8:
        return None, None
    a2 = [a[t].contiguous() if M > 16 else torch.cat(
        [a[t], a.new_zeros((32 - M, K))]) for t in range(T)]
    b2 = [w_nk[t].t() for t in range(T)]
    try:
        outs = [torch._int_mm(x, y) for x, y in zip(a2, b2)]
    except RuntimeError as e:      # shape or layout it refuses
        log(f"  torch._int_mm refused {(M, N, K)}: {e}")
        return None, None
    acc = want if epi == "none" and not has_bias else vta_gemm_ref(
        a, w_nk.transpose(1, 2), epilogue="none")
    if not all(torch.equal(o[:M], acc[t]) for t, o in enumerate(outs)):
        fail("torch._int_mm disagrees with the plain version")
    ms = cuda_time_ms(lambda: [torch._int_mm(x, y) for x, y in zip(a2, b2)])
    what = "torch._int_mm" + (f", {T} calls" if T > 1 else "") + (
        "" if M > 16 else ", M padded to 32") + (
        "" if epi == "none" and not has_bias else
        ": GEMM only, no epilogue")
    return ms, what


def phase_gemm_kernel(rec, main_shapes):
    import numpy as np
    import torch
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref
    from repro_torch.kernels.vta_gemm.kernel import gemm_plan
    dev = torch.device("cuda")
    cases = [(k, n, n > 0) for k, n in main_shapes.items()]
    extra = [((1, 37, 50, 70, e, s, b), 0, False)
             for e, s in (("none", 0), ("requant", 0), ("requant", 5),
                          ("requant", 31), ("requant", 40), ("dequant", 0))
             for b in (False, True)]
    extra += [((3, 130, 72, 200, "requant", 9, False), 0, False),
              ((1, 1, 3, 5, "none", 0, True), 0, False)]
    # the skinny instance's edges: M 1, 3, 16 and 17 (past the cut), K not
    # a multiple of 16, N not a multiple of 8, every epilogue, with bias
    extra += [((1, m, 203, 1000, e, s, True), 0, False)
              for m in (1, 3, 16, 17)
              for e, s in (("none", 0), ("requant", 9), ("dequant", 0))]
    # the wgmma instance's edges: T 3, M, N and K ragged (K padded to 16
    # bytes by the wrapper), every epilogue with shifts 0, 9, 31 and 40,
    # with bias; deep K split over a cluster of 7 and of 8 slices
    extra += [((3, 130, 203, 1000, e, s, True), 0, False)
              for e, s in (("none", 0), ("requant", 0), ("requant", 9),
                           ("requant", 31), ("requant", 40), ("dequant", 0))]
    extra += [((1, 130, 260, 4100, "dequant", 0, False), 0, False),
              ((2, 300, 64, 4608, "none", 0, True), 0, False)]
    # Llama-3.2-3B's prefill linears at 512 and 4096 tokens (timed; no
    # served prompt is that long)
    extra += [((1, m, n, k, "dequant", 0, False), 0, True)
              for m, n, k in LLAMA_PREFILL_GEMMS]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, max_err = [], 0
    for (T, M, N, K, epi, shift, has_bias), launches, timed in cases + extra:
        rng = np.random.default_rng(T * 131 + M * 7 + N * 3 + K)
        a = torch.from_numpy(rng.integers(-128, 128, (T, M, K),
                                          dtype=np.int8)).to(dev)
        w_nk = torch.from_numpy(rng.integers(-128, 128, (T, N, K),
                                             dtype=np.int8)).to(dev)
        w = w_nk.transpose(1, 2)
        bias = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, N,
                                             dtype=np.int32)).to(dev) \
            if has_bias else None
        scale = torch.from_numpy(rng.random(N, dtype=np.float32)
                                 * 1e-3).to(dev)
        kw = dict(epilogue=epi, shift=shift)
        got = vta_gemm(a, w, bias, scale, **kw)
        again = vta_gemm(a, w, bias, scale, **kw)
        want = vta_gemm_ref(a, w, bias, scale, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(again, want):
            fail(f"vta_gemm {(T, M, N, K, epi, shift, has_bias)} differs "
                 f"from its plain version")
        max_err = max(max_err, int((got.to(torch.float64)
                                    - want.to(torch.float64)).abs().max()))
        if not timed:
            continue
        plan = gemm_plan(T, M, N, K, sms)
        instance = plan.route
        call_ms = cuda_time_ms(lambda: vta_gemm(a, w, bias, scale, **kw))
        ms = kernel_ms(lambda: vta_gemm(a, w, bias, scale, **kw),
                       "vta_gemm_", call_ms)
        plain = cuda_time_ms(lambda: vta_gemm_ref(a, w, bias, scale, **kw),
                             reps=5, warmup=1)
        lib, lib_what = int_mm_ms(a, w_nk, want, epi, has_bias, M, N, K)
        bound, by = gemm_bound_ms(T, M, N, K, epi, has_bias)
        rows.append(dict(T=T, M=M, N=N, K=K, epilogue=epi, shift=shift,
                         bias=has_bias, launches=launches, instance=instance,
                         tile=[plan.bm, plan.bn], splits=plan.splits,
                         ms=ms, call_ms=call_ms, plain_ms=plain,
                         library_ms=lib, library_what=lib_what,
                         bound_ms=bound, bound_by=by))
        log(f"  vta_gemm T={T} M={M} N={N} K={K} {epi}/{shift}"
            f"{' +bias' if has_bias else ''} ({instance}"
            f"{'' if instance == 'skinny' else f' {plan.bm}x{plan.bn}'}, "
            f"{plan.splits} K slices): kernel "
            f"{ms:.4f} ms, call {call_ms:.4f} ms (bound {bound:.5f} "
            f"ms by {by}; plain {plain:.4f} ms; library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms ({lib_what})'}) "
            f"x{launches}")
    rec["vta_gemm_shapes"] = rows
    return rows, max_err


def qlinear_inputs(M, K, N, dt, case, seed):
    """x (M, K) in dtype `dt` on the card ("normal" and "given": 4 x unit
    normal; "ties": every x / x_scale on k + 0.5, x_scale exactly 1/16;
    "tiny": amax below 1e-6), w_q (K, N) over (N, K) storage, w_scale
    (N,)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if case in ("normal", "given"):
        x = rng.normal(size=(M, K)) * 4
    elif case == "ties":
        x = (2 * rng.integers(-127, 127, size=(M, K)) + 1) / 32.0
        x.reshape(-1)[0] = 127 / 16
    else:
        x = rng.integers(-64, 64, size=(M, K)) * 2.0 ** -33
    w_nk = rng.integers(-128, 128, size=(N, K), dtype=np.int8)
    sc = rng.random(N) * 1e-2 + 1e-4
    dev = torch.device(DEVICE)
    return (torch.from_numpy(x.astype(np.float32)).to(dev)
            .to(getattr(torch, dt)),
            torch.from_numpy(w_nk).to(dev).t(),
            torch.from_numpy(sc.astype(np.float32)).to(dev))


def qlinear_bound_ms(M, N, K, elt):
    """x read, the int8 weights and their scales read, y written, at the
    memory rate, or the int8 operations at the tensor-core peak."""
    nbytes = M * K * elt + N * K + 4 * N + M * N * elt
    ops = 2 * M * N * K
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


#: quantized_linear shapes checked beyond the served ones: the wgmma route
#: at M 17, 130, 512 and 4096 (Llama-3.2-3B's q/o linear, and K and N not
#: multiples of 16), each with the amax and with a given x_scale
QLINEAR_EDGES = [(m, 3072, 3072) for m in (17, 130, 512, 4096)] + [
    (m, 520, 1000) for m in (17, 130, 512, 4096)]


def phase_qlinear_kernel(rec, served, given=()):
    """quantized_linear's fused route against its plain chain on the card,
    bitwise (torch.equal), at every (M, N, K, x dtype) phases 8 and 9
    served and at QLINEAR_EDGES, in bfloat16 and float32 x, on unit-scale
    inputs, on x.5 ties and on an amax below 1e-6 (and a given x_scale at
    the edges, at the shapes not timed and at those in `given`); timed at each served shape beside the chain as the port
    ran it before (amax, scale, quantization and dequantization as
    PyTorch ops around a vta_gemm launch) and, above 16 rows, beside
    torch._int_mm's GEMM alone; then the device time of the served calls
    above 16 rows added up."""
    import torch
    from repro_torch.kernels.vta_gemm import (quantized_linear,
                                              quantized_linear_ref, vta_gemm)
    from repro_torch.kernels.vta_gemm.kernel import gemm_plan
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, checked, given_at = [], 0, 0
    edges = {(M, N, K, "bfloat16"): 0 for M, N, K in QLINEAR_EDGES}
    for (M, N, K, dt), launches in sorted(served.items()) + sorted(
            edges.items()):
        cases = ("normal", "ties", "tiny") + (
            ("given",) if launches == 0 or (M, N, K, dt) in given else ())
        given_at += "given" in cases
        for xdt in ("bfloat16", "float32"):
            for case in cases:
                x, w_q, ws = qlinear_inputs(M, K, N, xdt, case,
                                            M + N + K + len(case))
                xs = torch.tensor(0.0625, device=dev) \
                    if case == "given" else None
                got = quantized_linear(x, w_q, ws, xs)
                again = quantized_linear(x, w_q, ws, xs)
                want = quantized_linear_ref(x, w_q, ws, xs)
                torch.cuda.synchronize()
                if not torch.equal(got, want) or not torch.equal(again,
                                                                 want):
                    fail(f"quantized_linear {(M, N, K, xdt, case)} differs "
                         f"from its plain chain")
                checked += 1
        if launches == 0:
            continue
        x, w_q, ws = qlinear_inputs(M, K, N, dt, "normal", M + N + K)
        plan = gemm_plan(1, M, N, K, sms)
        call = lambda: quantized_linear(x, w_q, ws)  # noqa: E731
        call_ms = cuda_time_ms(call)
        ms = kernel_ms(call, "vta_gemm_", call_ms)
        chain_ms = cuda_time_ms(
            lambda: quantized_linear_ref(x, w_q, ws, gemm=vta_gemm))
        plain = cuda_time_ms(lambda: quantized_linear_ref(x, w_q, ws),
                             reps=5, warmup=1)
        lib = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            xq = torch.randint(-128, 128, (M, K), dtype=torch.int8,
                               device=dev)
            lib = cuda_time_ms(lambda: torch._int_mm(xq, w_q))
        bound, by = qlinear_bound_ms(M, N, K, x.element_size())
        rows.append(dict(M=M, N=N, K=K, dtype=dt, launches=launches,
                         instance=plan.route, tile=[plan.bm, plan.bn],
                         splits=plan.splits, ms=ms, call_ms=call_ms,
                         chain_call_ms=chain_ms, plain_ms=plain,
                         library_ms=lib, library_what=None if lib is None
                         else "torch._int_mm: the GEMM alone",
                         bound_ms=bound, bound_by=by))
        log(f"  quantized_linear M={M} N={N} K={K} {dt} ({plan.route}, "
            f"{plan.splits} K slices): kernels {ms:.4f} ms, call "
            f"{call_ms:.4f} ms; the PyTorch-op chain around vta_gemm "
            f"{chain_ms:.4f} ms a call (bound {bound:.5f} ms by {by}; plain "
            f"{plain:.4f} ms; torch._int_mm's GEMM alone "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}) x{launches}")
    big = [r for r in rows if r["M"] > SKINNY_ROWS]
    total = sum(r["ms"] * r["launches"] for r in big)
    log(f"  quantized_linear: {len(served)} served shapes, {checked} checks "
        f"bitwise equal to the plain chain (bfloat16 and float32 x; normal, "
        f"x.5 ties, amax below 1e-6; a given x_scale too at {given_at} "
        f"shapes: QLINEAR_EDGES, the untimed and phase 16's); above "
        f"{SKINNY_ROWS} rows "
        f"{sum(r['launches'] for r in big)} served calls, {total:.4f} ms of "
        f"device time (kernel ms x launches)")
    rec["quantized_linear_shapes"] = rows
    rec["quantized_linear_above_16_rows"] = dict(
        calls=sum(r["launches"] for r in big), device_ms=total)
    return rows


def alu_library_call(chain, d, s):
    """A closure making the one PyTorch call that computes the same
    function as a one-step `chain` on (d, s); None for longer chains,
    which no single call computes.  The port never calls these."""
    import torch
    if len(chain) != 1:
        return None
    (op, imm), = chain
    if imm is None:
        fn = {"add": torch.add, "mul": torch.mul, "min": torch.minimum,
              "max": torch.maximum}.get(op)
        return None if fn is None else (lambda: fn(d, s))
    if op == "shr":
        return (lambda: torch.bitwise_right_shift(d, imm)) \
            if 0 <= imm < 32 else None
    return {"add": lambda: torch.add(d, imm), "mul": lambda: torch.mul(d, imm),
            "min": lambda: torch.clamp(d, max=imm),
            "max": lambda: torch.clamp(d, min=imm)}[op]


def phase_alu_kernel(rec, main_shapes):
    import numpy as np
    import torch
    from repro_torch.kernels.tensor_alu import tensor_alu, tensor_alu_ref
    dev = torch.device("cuda")
    i32 = np.iinfo(np.int32)
    edge = (-3, 0, 31, 33, int(i32.min), 40)
    extra = [((37, 50), (("shr", None),)),
             ((37, 50), (("mul", 3), ("add", int(i32.max)))),
             ((37, 50), (("add", None), ("mul", None), ("min", 1000))),
             ((37, 50), tuple(("shr", s) for s in edge)),
             ((5, 3), (("max", 0), ("min", 127)))]
    rows, max_err = [], 0
    for (shape, chain), launches in list(main_shapes.items()) \
            + [(e, 0) for e in extra]:
        rng = np.random.default_rng(sum(shape) + len(chain))
        d = torch.from_numpy(rng.integers(i32.min, i32.max, shape,
                                          dtype=np.int64)
                             .astype(np.int32)).to(dev)
        src = rng.integers(-40, 40, shape, dtype=np.int32)
        n_edge = min(len(edge), src.size)
        src.reshape(-1)[:n_edge] = edge[:n_edge]
        s = torch.from_numpy(src).to(dev)
        uses_src = any(imm is None for _, imm in chain)
        s_arg = s if uses_src else None
        got = tensor_alu(d, s_arg, chain=chain)
        want = tensor_alu_ref(d, s_arg, chain=chain)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"tensor_alu {shape} {chain} differs from its plain version")
        max_err = max(max_err, int((got.to(torch.int64)
                                    - want.to(torch.int64)).abs().max()))
        if launches == 0:
            continue
        call_ms = cuda_time_ms(lambda: tensor_alu(d, s_arg, chain=chain))
        ms = kernel_ms(lambda: tensor_alu(d, s_arg, chain=chain),
                       "tensor_alu_kernel", call_ms)
        plain = cuda_time_ms(lambda: tensor_alu_ref(d, s_arg, chain=chain),
                             reps=5, warmup=1)
        lib = None
        lib_fn = alu_library_call(chain, d, s_arg)
        if lib_fn is not None:
            if not torch.equal(lib_fn(), want):
                fail(f"the library call for {chain} disagrees with the "
                     f"plain version")
            lib = cuda_time_ms(lib_fn)
        numel = int(np.prod(shape))
        bound, by = alu_bound_ms(numel, len(chain), uses_src)
        rows.append(dict(shape=list(shape), chain=[list(c) for c in chain],
                         launches=launches, ms=ms, call_ms=call_ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by))
        log(f"  tensor_alu {shape} {chain}: kernel {ms:.4f} ms, call "
            f"{call_ms:.4f} ms (bound {bound:.6f} "
            f"ms by {by}; plain {plain:.4f} ms; library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}) x{launches}")
    rec["tensor_alu_shapes"] = rows
    return rows, max_err


def scatter_bound_ms(key, bmap):
    """The scatter instance's least time at one launch's shape: each GEMM
    output read once, the tensor operand read once, the tiles written
    once and the map read once, at the memory rate; or the adds (one per
    source element) and the chain's steps at the int32 rate."""
    T, R, C, _, _, dt, has_bias, chain = key
    elt = 1 if dt == "int8" else 4
    nbytes = T * sum(r * w for r, w in zip(bmap.rows, bmap.widths)) * elt \
        + T * R * C * 4 * (1 + has_bias) \
        + 4 * (bmap.row_ptr.size + bmap.ent.size)
    ops = T * (bmap.nnz * bmap.batch * bmap.block_out + R * C * len(chain))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scatter_inputs(key, bmap, dev, seed):
    """Random GEMM outputs of the map's shapes (int32 over the full
    range, so sums wrap, or int8) and tensor operands whose first values
    are the shr edge amounts."""
    import numpy as np
    import torch
    T, R, C, _, _, dt, has_bias, _ = key
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)

    def mat(rows, width):
        if dt == "int8":
            x = rng.integers(-128, 128, (rows, width), dtype=np.int8)
        else:
            x = rng.integers(i32.min, i32.max, (rows, width),
                             dtype=np.int64).astype(np.int32)
        return torch.from_numpy(x).to(dev)
    mats = [[mat(r, w) for r, w in zip(bmap.rows, bmap.widths)]
            for _ in range(T)]
    bias = None
    if has_bias:
        b = rng.integers(-40, 40, (T, R, C), dtype=np.int32)
        edges = np.array([-3, 0, 31, 33, i32.min, 40], np.int32)
        b.reshape(T, -1)[:, :edges.size] = edges[:min(edges.size, R * C)]
        bias = list(torch.from_numpy(b).to(dev))
    return mats, bias


def phase_scatter_kernel(rec, main_shapes):
    """tensor_alu's scatter instance against its plain version, byte for
    byte, at every shape a main path launched (with the block map that
    launch used): timed where the ResNet path launched it (count > 0),
    checked only where another path did."""
    import torch
    from repro_torch.kernels.tensor_alu import (tensor_alu_scatter,
                                                tensor_alu_scatter_ref)
    dev = torch.device(DEVICE)
    rows, max_err = [], 0
    for i, (key, launches) in enumerate(main_shapes.items()):
        bmap = tensor_alu_scatter.maps[key]
        T, R, C, G, nnz, dt, has_bias, chain = key
        mats, bias = scatter_inputs(key, bmap, dev, 1000 + i)
        got = tensor_alu_scatter(mats, bmap, bias, chain=chain)
        want = tensor_alu_scatter_ref(mats, bmap, bias, chain=chain)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"tensor_alu_scatter {key[:7]} differs from its plain "
                 f"version")
        max_err = max(max_err, int((got.to(torch.int64)
                                    - want.to(torch.int64)).abs().max()))
        shape = dict(T=T, R=R, C=C, groups=G, map_entries=nnz, src_dtype=dt,
                     tensor_operand=has_bias, chain=[list(c) for c in chain])
        if launches == 0:
            rows.append(dict(shape, launches=0, timed=False))
            continue
        call = lambda: tensor_alu_scatter(mats, bmap, bias,  # noqa: E731
                                          chain=chain)
        call_ms = cuda_time_ms(call)
        ms = kernel_ms(call, "tensor_alu_scatter_kernel", call_ms)
        plain = cuda_time_ms(lambda: tensor_alu_scatter_ref(
            mats, bmap, bias, chain=chain), reps=5, warmup=1)
        bound, by = scatter_bound_ms(key, bmap)
        rows.append(dict(shape, launches=launches, timed=True, ms=ms,
                         call_ms=call_ms, plain_ms=plain, library_ms=None,
                         bound_ms=bound, bound_by=by))
        log(f"  tensor_alu_scatter T{T} {R}x{C} groups {G} entries {nnz} "
            f"{dt} chain {len(chain)}: kernel {ms:.4f} ms, call "
            f"{call_ms:.4f} ms (bound {bound:.6f} ms by {by}; plain "
            f"{plain:.4f} ms) x{launches}")
    rec["tensor_alu_scatter_shapes"] = rows
    return rows, max_err


# ----------------------------------------------------------------------
def phase_engines(rec):
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.backend import CrossBackendChecker
    from repro_torch.core.runtime import Runtime
    from repro_torch.core.scheduler import (Epilogue, matmul_reference,
                                            read_matmul_result,
                                            schedule_matmul)
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
    w = rng.integers(-128, 128, size=(64, 64), dtype=np.int8)
    rt = Runtime(hwspec.pynq(), torch_device=DEVICE)
    plan = schedule_matmul(rt, a, w, epilogue=Epilogue(shift=5),
                           virtual_threads=2)
    report = CrossBackendChecker(("simulator", "cuda")).check_runtime(rt)
    if not report.matches:
        fail(f"simulator and cuda engines differ in "
             f"{report.mismatched_bytes} DRAM bytes")
    got = read_matmul_result(rt, plan)
    if not np.array_equal(got, matmul_reference(a, w, Epilogue(shift=5))):
        fail("GOLDEN matmul result differs from matmul_reference")
    rec["engines"] = dict(matches=True, mismatched_bytes=0,
                          devices=[str(r.device.torch_device)
                                   for r in report.runs])
    log("  GOLDEN matmul stream: simulator and cuda DRAM images byte-equal "
        f"on {report.runs[1].device.torch_device}")


# ----------------------------------------------------------------------
# phases 5-9: the quantized decoder served (the second main path)
# ----------------------------------------------------------------------
DECODE_STEPS = 64
DECODE_STEPS_INT8 = 24
PROMPTS = [7 * i + 3 for i in range(4)]      # examples/serve_lm.py


def greedy_reference(dec, prompt, steps):
    """The port's eager DecoderReference, greedy: attention on the
    decoder's device (the card), matmuls through the integer oracle."""
    import numpy as np
    ref, tok, out = dec.reference(), prompt, []
    for _ in range(steps):
        tok = int(np.argmax(ref.step(dec.token(tok))))
        out.append(tok)
    return out


def serve_dialogues(pool, dec, steps):
    """Lockstep greedy decode of one session per prompt.  Returns (tokens
    per dialogue, per-step wall ms of every session's request, total s,
    the RunStats of every request)."""
    import numpy as np
    sess = [pool.session() for _ in PROMPTS]
    toks, out = list(PROMPTS), [[] for _ in PROMPTS]
    step_ms, stats = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        sub = time.perf_counter()
        futs = [s.submit(x=dec.token(t)) for s, t in zip(sess, toks)]
        for i, f in enumerate(futs):
            logits = f.wait(timeout=300)
            step_ms.append((time.perf_counter() - sub) * 1e3)
            stats.extend(f.stats)
            toks[i] = int(np.argmax(logits))
            out[i].append(toks[i])
    return out, step_ms, time.perf_counter() - t0, stats


def phase_decode_int4(rec, counters):
    """The int4 decoder with kernel attention, at serve_lm.py's defaults,
    through DevicePool(size=2) on the cuda engine: 4 dialogues x 64 greedy
    steps, each equal to the eager reference run on the card.  The
    kernels' counts are set to 0 just before the pool serves and read
    just after (the reference's own launches come before)."""
    from repro_torch.core import hwspec
    from repro_torch.core.serve import DevicePool
    from repro_torch.models.vta_decoder import DecoderConfig, QuantDecoder
    dec = QuantDecoder(DecoderConfig(), spec=hwspec.lowbit(4),
                       attention="kernel", torch_device=DEVICE)
    c = dec.compile(use_cache=False)
    want = [greedy_reference(dec, p, DECODE_STEPS) for p in PROMPTS]
    with DevicePool(c, size=2, backend="cuda") as pool:
        # warm-up round on a throwaway session, then the allocation mark
        pool.session().submit(x=dec.token(0)).wait(timeout=300)
        marks = [s.device.dram._next for s in pool.slots]
        counters.reset()
        toks, step_ms, total_s, stats = serve_dialogues(pool, dec,
                                                        DECODE_STEPS)
        launches = counters.read()
        grown = [s.device.dram._next - m for s, m in zip(pool.slots, marks)]
        gangs = sum(s.ganged_steps for s in pool.slot_stats())
    for i, (got, ref) in enumerate(zip(toks, want)):
        if got != ref:
            fail(f"int4 dialogue {i} diverged from the eager reference: "
                 f"{got} vs {ref}")
    if any(grown):
        fail(f"a pool slot allocated DRAM after warm-up: {grown}")
    lut_runs = sum(s.lut_launches for s in stats)
    for k in ("lut_gemm", "decode_attention"):
        if launches[k] <= 0:
            fail(f"{k} was never launched on the decode path")
    if lut_runs <= 0:
        fail("RunStats.lut_launches is 0 on the int4 decode path")
    n = len(PROMPTS) * DECODE_STEPS
    out = dict(spec="lowbit(4)", attention="kernel", pool=2,
               sessions=len(PROMPTS), steps=DECODE_STEPS, tokens=toks,
               step_ms_median=statistics.median(step_ms),
               step_ms_p90=sorted(step_ms)[int(0.9 * len(step_ms))],
               steps_per_s=n / total_s, total_s=total_s,
               launches=launches,
               launches_per_step={k: v / n for k, v in launches.items()},
               runstats_lut_launches=lut_runs, ganged_steps=gangs,
               dram_growth=grown, persistent_bytes=c.persistent_bytes,
               describe=c.describe())
    rec["decode_int4"] = out
    log(f"  int4 decoder, kernel attention, pool 2: {len(PROMPTS)} "
        f"dialogues x {DECODE_STEPS} steps equal the reference on the card")
    log(f"    step latency median {out['step_ms_median']:.2f} ms (p90 "
        f"{out['step_ms_p90']:.2f}), {out['steps_per_s']:.1f} steps/s "
        f"aggregate, {gangs} ganged segments, DRAM growth {grown}")
    log("    launches per step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["launches_per_step"].items())
        + f"; RunStats.lut_launches {lut_runs}")
    return dec, c


def phase_decode_int8(rec, counters):
    """The same decoder on the int8 pynq spec with numpy attention:
    4 dialogues x 24 steps through DevicePool(size=2)."""
    from repro_torch.core import hwspec
    from repro_torch.core.serve import DevicePool
    from repro_torch.models.vta_decoder import DecoderConfig, QuantDecoder
    dec = QuantDecoder(DecoderConfig(), spec=hwspec.pynq(),
                       attention="numpy", torch_device=DEVICE)
    c = dec.compile(use_cache=False)
    want = [greedy_reference(dec, p, DECODE_STEPS_INT8) for p in PROMPTS]
    with DevicePool(c, size=2, backend="cuda") as pool:
        counters.reset()
        toks, step_ms, total_s, stats = serve_dialogues(pool, dec,
                                                        DECODE_STEPS_INT8)
        launches = counters.read()
    for i, (got, ref) in enumerate(zip(toks, want)):
        if got != ref:
            fail(f"int8 dialogue {i} diverged from the reference")
    if sum(s.lut_launches for s in stats) != 0:
        fail("an int8 spec went through lut_gemm")
    n = len(PROMPTS) * DECODE_STEPS_INT8
    rec["decode_int8"] = dict(spec="pynq", attention="numpy", pool=2,
                              steps=DECODE_STEPS_INT8, tokens=toks,
                              step_ms_median=statistics.median(step_ms),
                              steps_per_s=n / total_s, launches=launches)
    log(f"  int8 decoder, numpy attention: {len(PROMPTS)} x "
        f"{DECODE_STEPS_INT8} steps equal the reference; step median "
        f"{statistics.median(step_ms):.2f} ms, {n / total_s:.1f} steps/s; "
        f"launches {launches}")


def serial_logits(c, dec, feeds_per_session):
    """Fault-free serial oracle: each session's feeds run in order on a
    fresh trimmed clone of the staged image."""
    out = []
    for feeds in feeds_per_session:
        dev = c.device.clone(trim=True)
        out.append([c.run_on(dev, backend="cuda", inputs={"x": x}).outputs
                    for x in feeds])
    return out


def phase_sched(rec, dec, c):
    """The int4 decoder through the continuous-batching Scheduler: 4
    SchedSessions x 8 steps, byte-equal to serial runs."""
    import numpy as np
    from repro_torch.core.sched import SchedConfig, Scheduler
    from repro_torch.core.serve import DevicePool
    feeds = [[dec.token(p + 5 * t) for t in range(8)] for p in PROMPTS]
    serial = serial_logits(c, dec, feeds)
    with DevicePool(c, size=2, backend="cuda") as pool:
        sched = Scheduler(pool, SchedConfig(window_us=2000.0))
        try:
            sess = [sched.session() for _ in PROMPTS]
            got = [[] for _ in PROMPTS]
            t0 = time.perf_counter()
            for t in range(8):
                futs = [s.submit(x=f[t]) for s, f in zip(sess, feeds)]
                for i, fu in enumerate(futs):
                    got[i].append(fu.wait(timeout=300))
            wall = time.perf_counter() - t0
            width = sched.describe().splitlines()[0]
        finally:
            sched.close()
    for i in range(len(PROMPTS)):
        for t in range(8):
            if not np.array_equal(got[i][t], serial[i][t]):
                fail(f"Scheduler session {i} step {t} differs from serial")
    rec["sched"] = dict(sessions=len(PROMPTS), steps=8, wall_s=wall,
                        describe=width)
    log(f"  Scheduler: {len(PROMPTS)} sessions x 8 steps byte-equal to "
        f"serial in {wall:.2f} s ({width})")


def phase_chaos(rec, dec, c):
    """One seeded FaultPlan on the int4 pool: a constant bit-flip at gang
    3 and a kill of slot 0 at gang 31 (after its step-4 checkpoint), with
    max_respawns=1, checkpoint_every=4, integrity=True.  The fired log
    matches the plan, the loss is typed, and every dialogue (the
    interrupted step submitted again) is byte-equal to fault-free serial
    runs."""
    import numpy as np
    from repro_torch.core.chaos import Fault, FaultPlan
    from repro_torch.core.serve import DevicePool, SlotDied
    plan = FaultPlan(faults=[Fault(kind="flip", gang=3, slot=1, byte=12345),
                             Fault(kind="kill", gang=31, slot=0)])
    feeds = [[dec.token(t + 11 * i) for t in range(8)] for i in range(2)]
    serial = serial_logits(c, dec, feeds)
    losses = []
    with DevicePool(c, size=2, backend="cuda", max_respawns=1,
                    checkpoint_every=4, integrity=True,
                    fault_plan=plan) as pool:
        sess = [pool.session(slot=i) for i in range(2)]
        got = [[], []]
        for t in range(8):
            futs = [s.submit(x=f[t]) for s, f in zip(sess, feeds)]
            for i, fu in enumerate(futs):
                try:
                    got[i].append(fu.wait(timeout=300))
                except SlotDied as e:
                    losses.append(dict(session=i, step=t,
                                       error=type(e).__name__))
                    got[i].append(sess[i].submit(x=feeds[i][t])
                                  .wait(timeout=300))
        restores = [(s.stats.restores, s.stats.restored_from_step)
                    for s in sess]
        restages = sum(s.stats.integrity_restages for s in pool.slots)
        respawns = sum(s.stats.respawns for s in pool.slots)
    fired = [(e["kind"], e["gang"], e["slot"]) for e in plan.fired]
    if fired != [("flip", 3, 1), ("kill", 31, 0)]:
        fail(f"fired log {fired} does not match the plan")
    if losses != [dict(session=0, step=4, error="SlotDied")]:
        fail(f"unexpected losses {losses}")
    if restages < 1 or respawns != 1 or restores[0] != (1, 4):
        fail(f"recovery counters: restages {restages}, respawns "
             f"{respawns}, restores {restores}")
    for i in range(2):
        for t in range(8):
            if not np.array_equal(got[i][t], serial[i][t]):
                fail(f"chaos dialogue {i} step {t} differs from serial")
    rec["chaos"] = dict(fired=plan.fired, losses=losses, restores=restores,
                        restages=restages, respawns=respawns)
    log(f"  chaos: fired {fired}; losses {losses}; restores {restores}; "
        f"{restages} restage(s), {respawns} respawn(s); survivors "
        f"byte-equal to serial")


def phase_vta_linear(rec):
    """VtaLinear at test_lowbit.py's shape (96 -> 80), one 2-row call,
    bits 4 and 2, byte-equal between the cuda and simulator engines on the
    card; 1-bit weights (which VtaLinear cannot calibrate: int1 has no
    positive level) through a one-matmul Program at the same shape."""
    import numpy as np
    from repro_torch.core import hwspec
    from repro_torch.core.program import Program
    from repro_torch.core.scheduler import Epilogue
    from repro_torch.models.quantized import VtaLinear
    rng = np.random.default_rng(7)
    w = rng.normal(size=(96, 80)).astype(np.float32) * 0.1
    x = rng.normal(size=(2, 96)).astype(np.float32)
    rows = {}
    for bits in (4, 2):
        lin = VtaLinear(w, bits=bits, torch_device=DEVICE)
        y_cuda = lin(x, backend="cuda")
        luts = sum(s.lut_launches for s in
                   next(iter(lin._programs.values())).last_stats)
        y_sim = lin(x, backend="simulator")
        if not np.array_equal(y_cuda, y_sim) or luts <= 0:
            fail(f"VtaLinear bits={bits}: engines differ or no LUT launch")
        rows[bits] = dict(lut_launches=luts,
                          max_abs_vs_float=float(np.abs(y_cuda - x @ w)
                                                 .max()))
    w1 = rng.integers(-1, 1, size=(80, 96), dtype=np.int8)
    x1 = rng.integers(-128, 128, size=(2, 96), dtype=np.int8)
    p = Program(hwspec.lowbit(1))
    p.output(p.matmul(p.input("x", (2, 96)), p.constant("w", w1),
                      epilogue=Epilogue(shift=3)))
    c1 = p.compile(use_cache=False, torch_device=DEVICE)
    y1 = c1(backend="cuda", x=x1)
    luts1 = sum(s.lut_launches for s in c1.last_stats)
    if not np.array_equal(y1, c1(backend="simulator", x=x1)) or luts1 <= 0:
        fail("1-bit program: engines differ or no LUT launch")
    rows[1] = dict(lut_launches=luts1, program="one matmul")
    rec["vta_linear"] = rows
    log(f"  VtaLinear 96->80 x2 rows, bits 4 and 2, and a 1-bit Program: "
        f"cuda == simulator on the card ({rows})")


def decode_step_profile(rec, dec, c):
    """Device idle share of one profiled int4 decode step (serial, after
    a warm one): device busy time over the profiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = dec.token(1)
    c(x=x)
    t0 = time.perf_counter()
    c(x=x)
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c(x=x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if t > 0 and e.device_type == DeviceType.CUDA:
            kernels[e.key] = t / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    rec["decode_profile"] = dict(step_ms=plain_ms, profiled_ms=wall_ms,
                                 device_busy_ms=dev_ms,
                                 idle_share=1 - dev_ms / wall_ms,
                                 top_device_ms=top)
    log(f"  profile of one int4 decode step: {plain_ms:.2f} ms "
        f"({wall_ms:.2f} ms profiled); device busy {dev_ms:.3f} ms -> idle "
        f"share {1 - dev_ms / wall_ms:.4f}")


# ----------------------------------------------------------------------
# phase 1 (continued): the decode-path kernels against plain versions
# ----------------------------------------------------------------------
LLAMA32_3B = dict(HQ=24, KH=8, D=128, d_model=3072, d_ff=8192)
#: (B, S) of the Llama-3.2-3B decode_attention checks
LLAMA_DECODE_BS = ((1, 4096), (8, 32768))
#: prompt lengths of the Llama-3.2-3B flash_attention checks
LLAMA_PREFILL_S = (4096, 32768)


def lut_bound_ms(T, M, N, K, epilogue):
    nbytes = T * (M * K + N * K + M * N * (4 if epilogue == "none" else 1))
    ops = 2 * T * M * N * K
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT8_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_lut_kernel(rec, main_shapes):
    import numpy as np
    import torch
    from repro_torch.kernels.lut_gemm import lut_gemm, lut_gemm_ref
    dev = torch.device("cuda")
    cases = list(main_shapes.items())
    extra = [((1, m, LLAMA32_3B["d_ff"], LLAMA32_3B["d_model"], bits, 4,
               "none", 0), -1)
             for m in (1, 16) for bits in (1, 2, 4)]
    extra += [((1, 5, 50, 70, b, g, e, s), 0) for b in (1, 2, 4)
              for g in (2, 4, 8) for e, s in (("none", 0), ("requant", 5),
                                              ("requant", 40))]
    rows, max_err = [], 0
    for (T, M, N, K, bits, group, epi, shift), launches in cases + extra:
        rng = np.random.default_rng(T + M * 7 + N * 3 + K + bits)
        lo = -(1 << (bits - 1))
        a = torch.from_numpy(rng.integers(-128, 128, (T, M, K),
                                          dtype=np.int8)).to(dev)
        w_nk = torch.from_numpy(rng.integers(lo, -lo, (T, N, K),
                                             dtype=np.int8)).to(dev)
        w = w_nk.transpose(1, 2)
        kw = dict(epilogue=epi, shift=shift)
        got = lut_gemm(a, w, bits=bits, group=group, **kw)
        want = lut_gemm_ref(a, w, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"lut_gemm {(T, M, N, K, bits, group, epi, shift)} "
                 f"differs from its plain version")
        max_err = max(max_err, int((got.to(torch.float64)
                                    - want.to(torch.float64)).abs().max()))
        if launches == 0:
            continue
        call = lambda: lut_gemm(a, w, bits=bits, group=group, **kw)  # noqa
        call_ms = cuda_time_ms(call)
        ms = kernel_ms(call, "lut_gemm_kernel", call_ms)
        plain = cuda_time_ms(lambda: lut_gemm_ref(a, w, **kw), reps=5,
                             warmup=1)
        # the library yardstick: torch._int_mm on the same int8 operands
        # (it takes more than 16 rows: M is zero-padded to 32 for it)
        lib = None
        if T == 1 and epi == "none" and K % 8 == 0 and N % 8 == 0:
            a32 = torch.zeros((32, K), dtype=torch.int8, device=dev)
            a32[:M] = a[0]
            b2 = w_nk[0].t()
            lib_out = torch._int_mm(a32, b2)
            if not torch.equal(lib_out[:M], want[0]):
                fail("torch._int_mm disagrees with the plain version")
            lib = cuda_time_ms(lambda: torch._int_mm(a32, b2))
        bound, by = lut_bound_ms(T, M, N, K, epi)
        rows.append(dict(T=T, M=M, N=N, K=K, bits=bits, group=group,
                         epilogue=epi, shift=shift, launches=max(launches, 0),
                         decode_path=launches > 0, ms=ms, call_ms=call_ms,
                         plain_ms=plain, library_ms=lib,
                         library_note="torch._int_mm, M padded to 32"
                         if lib is not None else None,
                         bound_ms=bound, bound_by=by))
        log(f"  lut_gemm T={T} M={M} N={N} K={K} int{bits} g{group} "
            f"{epi}/{shift}: kernel {ms:.4f} ms, call {call_ms:.4f} ms "
            f"(bound {bound:.5f} ms by {by}; plain {plain:.4f} ms; "
            f"library {'n/a' if lib is None else f'{lib:.4f} ms'}) "
            + (f"x{launches}" if launches > 0 else "(Llama-3.2-3B)"))
    rec["lut_gemm_shapes"] = rows
    return rows, max_err


def attn_bound_ms(B, S, HQ, KH, D, kv_len, kv_elt, q_elt):
    nbytes = 2 * B * KH * kv_len * D * kv_elt + 2 * B * HQ * D * q_elt
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def attn_tolerance(dt, want):
    """float32: 1e-5 absolute on unit-scale inputs.  bfloat16 (compared
    in float32): 2^-6 * max|want|, four bf16 ulps at 2^-8 * max|want|
    each, so the limit follows the output's scale (about 0.03 at
    kv_len 4059 on unit-normal inputs).  The sums run in another order
    than the plain version's (lane groups, then splits, or 64-key tiles),
    and both sides round once to bfloat16 at the end."""
    if dt == "float32":
        return 1e-5
    return 2.0 ** -6 * float(want.float().abs().max())


def sdpa_call(q, k, v, causal):
    """A closure making one scaled_dot_product_attention call on (B, S, H,
    D) tensors (GQA through enable_gqa), or None where PyTorch refuses the
    inputs.  Flash and memory-efficient backends only, so a call never
    materializes the scores; the math backend only where the scores stay
    under 4 GB.  The port never calls this."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    B, H, S, _ = qs.shape
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    if B * H * S * ks.shape[2] * 4 < (4 << 30):
        backends.append(SDPBackend.MATH)

    def call():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True)
    try:
        call()
    except RuntimeError as e:          # a layout or size it refuses
        log(f"  scaled_dot_product_attention refused: {str(e)[:200]}")
        return None
    return call


#: the kv_len of the LM paths' last decode step (16-token prompts, 16 new)
LM_SERVED_KV = 32


def attn_timing(q, k, v, kv_len, qdt, kvdt):
    """decode_attention's kernel and call ms at one kv_len, beside its
    plain version, its bound and one scaled_dot_product_attention call
    over the [:, :kv_len] views (a query of another dtype than the caches
    is upcast before the timed call)."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref_4d)
    from repro_torch.kernels.decode_attention.kernel import decode_plan
    B, S, KH, D = k.shape
    HQ = q.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, split_len = decode_plan(B, KH, HQ // KH, S, kv_len, sms)
    call = lambda: decode_attention(q, k, v, kv_len)  # noqa: E731
    call_ms = cuda_time_ms(call)
    ms = kernel_ms(call, "decode_", call_ms)
    plain = cuda_time_ms(lambda: decode_attention_ref_4d(q, k, v, kv_len),
                         reps=5, warmup=1)
    want = decode_attention_ref_4d(q, k, v, kv_len)
    ql = q if qdt == kvdt else q.float()
    lib = lib_err = None
    lib_call = sdpa_call(ql, k[:, :kv_len], v[:, :kv_len], False)
    if lib_call is not None:
        lib_err = float((lib_call().transpose(1, 2).float()
                         - want.float()).abs().max())
        lib = cuda_time_ms(lib_call)
    bound, by = attn_bound_ms(B, S, HQ, KH, D, kv_len, k.element_size(),
                              q.element_size())
    return dict(kv_len=kv_len, splits=splits, split_len=split_len, ms=ms,
                call_ms=call_ms, plain_ms=plain, library_ms=lib,
                library_what="" if qdt == kvdt else
                " (q upcast to float32 before the call)",
                library_max_abs_err=lib_err, bound_ms=bound, bound_by=by)


def phase_attn_kernel(rec, main_shapes):
    """decode_attention against its plain version, within attn_tolerance,
    and bitwise equal over two calls."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref_4d)
    dev = torch.device(DEVICE)
    cases = []
    for (B, S, HQ, KH, D, qdt, kvdt), launches in main_shapes.items():
        cases.append(((B, S, HQ, KH, D, qdt, kvdt),
                      sorted({1, min(LM_SERVED_KV, S), S // 2, S}),
                      launches))
    for B, S in LLAMA_DECODE_BS:
        for dt in ("float32", "bfloat16"):
            cases.append(((B, S, LLAMA32_3B["HQ"], LLAMA32_3B["KH"],
                           LLAMA32_3B["D"], dt, dt), [S - 37], -1))
    # starcoder2-7b: G = 36 / 4 = 9 query heads per kv head
    for qdt, kvdt in (("float32", "float32"), ("bfloat16", "bfloat16"),
                      ("bfloat16", "float32")):
        cases.append(((1, LLAMA_PREFILL_S[0], 36, 4, 128, qdt, kvdt),
                      [1, LLAMA_PREFILL_S[0] - 37], 0))
    cases.append(((2, 300, 6, 2, 64, "float32", "float32"),
                  [0, 1, 263, 300], 0))
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    limits = {"float32": [], "bfloat16": []}
    for (B, S, HQ, KH, D, qdt, kvdt), lens, launches in cases:
        g = torch.Generator(device=dev).manual_seed(S + HQ + B)
        q, k, v = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.float32).to(getattr(torch, dt))
                   for shape, dt in (((B, 1, HQ, D), qdt),
                                     ((B, S, KH, D), kvdt),
                                     ((B, S, KH, D), kvdt)))
        for kv_len in lens:
            got = decode_attention(q, k, v, kv_len)
            again = decode_attention(q, k, v, torch.tensor(
                [kv_len], dtype=torch.int32, device=dev))
            want = decode_attention_ref_4d(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = attn_tolerance(qdt, want)
            if err > tol or not torch.equal(got, again) \
                    or got.dtype != q.dtype:
                fail(f"decode_attention {(B, S, HQ, KH, D, qdt, kvdt, kv_len)}"
                     f": error {err} > {tol} or not reproducible")
            max_err[qdt] = max(max_err[qdt], err)
            limits[qdt].append(dict(B=B, S=S, HQ=HQ, KH=KH, kv=kvdt,
                                    kv_len=kv_len, max_abs_err=err,
                                    limit=tol))
        if launches == 0:
            continue
        # timed at the full cache and, on the LM paths, at the served
        # kv_len (the last decode step of 16 + 16 tokens)
        for kv_len in [lens[-1]] + ([LM_SERVED_KV] if launches > 0
                                    and S > LM_SERVED_KV else []):
            row = attn_timing(q, k, v, kv_len, qdt, kvdt)
            row.update(B=B, S=S, HQ=HQ, KH=KH, D=D, dtype=qdt,
                       cache_dtype=kvdt, launches=max(launches, 0),
                       decode_path=launches > 0)
            rows.append(row)
            log(f"  decode_attention B={B} S={S} HQ={HQ} KH={KH} D={D} "
                f"{qdt}/{kvdt} kv_len={kv_len} ({row['splits']} splits): "
                f"kernel {row['ms']:.4f} ms, call {row['call_ms']:.4f} ms "
                f"(bound {row['bound_ms']:.5f} ms by bytes; plain "
                f"{row['plain_ms']:.4f} ms; sdpa "
                + ("n/a" if row["library_ms"] is None else
                   f"{row['library_ms']:.4f} ms{row['library_what']}")
                + ") " + (f"x{launches}" if launches > 0
                          else "(Llama-3.2-3B)"))
    rec["decode_attention_shapes"] = rows
    rec["decode_attention_limits"] = limits
    for r in limits["bfloat16"]:
        log(f"  decode_attention bfloat16 B={r['B']} S={r['S']} HQ={r['HQ']} "
            f"KH={r['KH']} cache {r['kv']} kv_len={r['kv_len']}: "
            f"max_abs_err {r['max_abs_err']:.3e} within {r['limit']:.3e}")
    return rows, max_err


# ----------------------------------------------------------------------
# phase 7 (continued): flash_attention against its plain version
# ----------------------------------------------------------------------
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12
#: the CUDA kernel each dtype's flash_attention call launches
FLASH_KERNEL_NAMES = {"bfloat16": "flash_wgmma_kernel",
                      "float32": "flash_tf32x3_kernel"}
#: above this head dim flash_attention runs the wide kernel
#: (flash_wide.cu; kernel.py MAX_D), forward and backward
FLASH_MAX_D = 128
FLASH_WIDE_NAME = "flash_wide_fwd"
#: the wide backward's three kernels (Delta, dq, dk dv)
FLASH_WIDE_BWD_NAME = "flash_wide_d"
#: (D, dtype) the wide kernel is checked and timed at in phase 7 (B1
#: S2048 H8 causal), and the head dims above 256 it walks in slices of
#: 256 columns (B1 S1024 H8 causal)
FLASH_WIDE_CASES = [(160, "bfloat16"), (256, "bfloat16"), (256, "float32")]
FLASH_SLICED_CASES = [(320, "bfloat16"), (320, "float32"), (512, "bfloat16"),
                      (512, "float32")]
#: each flash kernel's error against float64 attention on its own inputs
#: may be at most this multiple of scaled_dot_product_attention's error on
#: the same inputs (of the plain version's, where SDPA refuses them)
FLASH_ORACLE_MULT = 4.0


def flash_f64(q, k, v, causal, rows=1024):
    """Attention in float64 on the card, (B, S, HQ, D) -> (B, S, HQ, D)
    float64, one head and `rows` query rows at a time (the scores of S
    32768 whole would not fit): the oracle phase 7 holds each flash kernel
    and scaled_dot_product_attention to.  A row that sees no key gives
    zeros, as the kernels do."""
    import math
    import torch
    B, S, HQ, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    group = HQ // KH
    out = torch.empty((B, S, HQ, D), dtype=torch.float64, device=q.device)
    keys = torch.arange(Sk, device=q.device)
    for b in range(B):
        for h in range(HQ):
            kk = k[b, :, h // group].double()
            vv = v[b, :, h // group].double()
            for r0 in range(0, S, rows):
                sc = q[b, r0:r0 + rows, h].double() @ kk.T / math.sqrt(D)
                if causal:
                    last = torch.arange(r0, min(S, r0 + rows),
                                        device=q.device) + (Sk - S)
                    sc.masked_fill_(keys[None] > last[:, None],
                                    float("-inf"))
                p = torch.softmax(sc, dim=-1).nan_to_num_(0.0)
                out[b, r0:r0 + rows, h] = p @ vv
    return out


def flash_bound_ms(B, S, Sk, HQ, KH, D, causal, elt, kv_elt=None):
    """The larger of the operations (4 B HQ S Sk D, halved when causal) at
    the bf16 dense tensor-core peak and the bytes (q, k, v read once, out
    written once; q and out of `elt` bytes an element, k and v of
    `kv_elt`, default the same) at the memory rate."""
    ops = 4 * B * HQ * S * Sk * D / (2 if causal else 1)
    nbytes = 2 * B * S * HQ * D * elt \
        + 2 * B * Sk * KH * D * (kv_elt or elt)
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_flash_kernel(rec, main_shapes):
    """flash_attention against its plain version (the materialized oracle,
    or the chunked one above 2048^2 scores per head), within
    attn_tolerance, bitwise equal over two calls; against float64
    attention (flash_f64) within FLASH_ORACLE_MULT x the error of
    scaled_dot_product_attention on the same inputs; timed at every shape
    the LM path launched and at Llama-3.2-3B's prefill shapes.  A shape
    key's dtype "bfloat16/float32" is the mixed-dtype route (a bfloat16
    query over float32 K/V: the 3xTF32 kernel on the upcast query), held
    to the bfloat16 tolerance; SDPA, which takes one dtype, gets the
    query upcast there."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    dev = torch.device(DEVICE)
    L = LLAMA32_3B
    cases = [(k, n) for k, n in main_shapes.items()]
    s1, s2 = LLAMA_PREFILL_S
    cases += [((1, s1, s1, L["HQ"], L["KH"], L["D"], True, dt), -1)
              for dt in ("float32", "bfloat16")]
    cases += [((1, s2, s2, L["HQ"], L["KH"], L["D"], True, "bfloat16"), -1)]
    # non-causal with ragged tiles and Sk != S (cross-attention's shape)
    cases += [((2, 1000, 1500, 20, 20, 64, False, "float32"), -1)]
    cases += [((1, 77, 130, 8, 2, 128, True, "bfloat16"), 0)]
    # head dims the tensor-core kernels do not take as they are: zero-
    # padded by the op (D 72 in bf16, to 80; D 18 in float32, to 20), and
    # the wide kernel above 128 (timed: no config launches them)
    cases += [((1, 1024, 1024, 8, 2, 72, True, "bfloat16"), -1),
              ((1, 1024, 1024, 8, 2, 18, True, "float32"), -1)]
    cases += [((1, 2048, 2048, 8, 8, D, True, dt), -1)
              for D, dt in FLASH_WIDE_CASES]
    cases += [((1, 1024, 1024, 8, 8, D, True, dt), -1)
              for D, dt in FLASH_SLICED_CASES]
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for (B, S, Sk, HQ, KH, D, causal, dt), launches in cases:
        qdt, kvdt = (dt.split("/") * 2)[:2]
        # the kernel that runs: float32 operands anywhere take the 3xTF32
        kdt = "float32" if "float32" in (qdt, kvdt) else "bfloat16"
        g = torch.Generator(device=dev).manual_seed(S + Sk + HQ)
        q = torch.randn((B, S, HQ, D), generator=g, device=dev) \
            .to(getattr(torch, qdt))
        k = torch.randn((B, Sk, KH, D), generator=g, device=dev) \
            .to(getattr(torch, kvdt))
        v = torch.randn((B, Sk, KH, D), generator=g, device=dev) \
            .to(getattr(torch, kvdt))
        got = flash_attention(q, k, v, causal=causal)
        again = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = attn_tolerance(qdt, want)
        if err > tol or not torch.equal(got, again):
            fail(f"flash_attention {(B, S, Sk, HQ, KH, D, causal, dt)}: "
                 f"error {err} > {tol} or not reproducible")
        max_err[dt] = max(max_err.get(dt, 0.0), err)
        shape = dict(B=B, S=S, Sk=Sk, HQ=HQ, KH=KH, D=D, causal=causal,
                     dtype=dt)
        # the float64 oracle: the kernel's error beside SDPA's
        f64 = flash_f64(q, k, v, causal)
        lib_call = sdpa_call(q if qdt == kvdt else q.to(k.dtype), k, v,
                             causal)
        # SDPA's causal mask is aligned top-left: its output is another
        # function where Sk != S, and the plain version stands in there
        sdpa_base = lib_call is not None and (not causal or S == Sk)
        # in the op's output dtype (q's: the mixed route rounds its float32
        # result to bfloat16, as the plain version does)
        base = lib_call().transpose(1, 2).to(q.dtype) if sdpa_base \
            else want
        err64 = float((got.double() - f64).abs().max())
        base64 = float((base.double() - f64).abs().max())
        if err64 > FLASH_ORACLE_MULT * base64:
            fail(f"flash_attention {(B, S, Sk, HQ, KH, D, causal, dt)}: "
                 f"error {err64:.3e} against float64 is over "
                 f"{FLASH_ORACLE_MULT} x {'sdpa' if sdpa_base else 'plain'}"
                 f"'s {base64:.3e}")
        shape.update(f64_err=err64, f64_base_err=base64,
                     f64_base="sdpa" if sdpa_base else "plain")
        del f64, base
        log(f"  flash_attention {(B, S, Sk, HQ, KH, D, causal, dt)}: error "
            f"against float64 {err64:.3e}, "
            f"{'sdpa' if sdpa_base else 'plain'}'s {base64:.3e} (ratio "
            f"{err64 / max(base64, 1e-30):.3f}, limit {FLASH_ORACLE_MULT})")
        if launches == 0:
            rows.append(dict(shape, launches=0, timed=False, max_abs_err=err,
                             limit=tol))
            continue
        big = S * Sk > 8192 * 8192
        reps = 3 if big else 20
        kname = FLASH_WIDE_NAME if D > FLASH_MAX_D else FLASH_KERNEL_NAMES[kdt]
        call = lambda: flash_attention(q, k, v, causal=causal)  # noqa
        call_ms = cuda_time_ms(call, reps=reps, warmup=1)
        ms = kernel_ms(call, kname, call_ms, reps=reps)
        plain = cuda_time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal), reps=1 if big else 5, warmup=1)
        lib = lib_err = None
        if lib_call is not None:
            lib_err = float((lib_call().transpose(1, 2).float()
                             - want.float()).abs().max())
            lib = cuda_time_ms(lib_call, reps=reps, warmup=1)
        bound, by = flash_bound_ms(B, S, Sk, HQ, KH, D, causal,
                                   q.element_size(), k.element_size())
        if kdt == "float32":
            # the 3xTF32 kernel's floor: three TF32 products per product
            shape["tf32x3_floor_ms"] = 3 * 4 * B * HQ * S * Sk * D / (
                2 if causal else 1) / TF32_TENSOR_OPS_PER_S * 1e3
        rows.append(dict(shape, launches=max(launches, 0), timed=True,
                         lm_path=launches > 0, kernel=kname,
                         ms=ms, call_ms=call_ms,
                         plain_ms=plain, library_ms=lib,
                         library_what="" if qdt == kvdt else
                         " (q upcast to float32 before the call)",
                         library_max_abs_err=lib_err, bound_ms=bound,
                         bound_by=by, max_abs_err=err, limit=tol))
        log(f"  flash_attention B={B} S={S} Sk={Sk} HQ={HQ} KH={KH} D={D} "
            f"{'causal' if causal else 'full'} {dt}: kernel {ms:.4f} ms, "
            f"call {call_ms:.4f} ms (bound {bound:.5f} ms by {by}; plain "
            f"{plain:.4f} ms; sdpa "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}"
            f"{rows[-1]['library_what']}); max_abs_err "
            f"{err:.3e} within {tol:.3e} "
            + (f"x{launches}" if launches > 0 else ""))
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
    rec["flash_attention_shapes"] = rows
    return rows, max_err


# ----------------------------------------------------------------------
# phase 8: the LM serve path (the third main path)
# ----------------------------------------------------------------------
LM_ARCH = "llama3.2-3b"
LM_SLOTS, LM_MAX_LEN = 4, 256
LM_REQUESTS, LM_MAX_NEW = 6, 16          # the reference CLI's defaults
LM_BF16_REQUESTS = 2
#: requests served with the int8 KV cache (kv_cache_quant: int8 values and
#: per-row scales, dequantized to bf16 caches for decode_attention)
LM_KVQ_REQUESTS = 2
#: logits of the kernel run against the plain run (teacher-forced), as a
#: share of the plain run's max|logit| at that call
LM_LOGIT_TOL = 0.05


def gla_by_recurrence(q, k, v, la, h0=None, *, chunk=64, y_dtype=None):
    """The gla_chunk op's function computed by the step recurrence (plain
    PyTorch, the same math as the chunked plain version with its sums in
    another order): a second plain implementation, whose distance from the
    first measures how far the model carries float rounding alone."""
    import torch
    from repro_torch.kernels.gla_chunk import gla_recurrence
    B, S, H, P = v.shape
    N = q.shape[-1]
    if S % min(chunk, S):
        raise ValueError(f"S = {S} is not a multiple of the chunk")
    q, k = (t.expand(B, S, H, N) for t in (q, k))   # one row for every head

    def to_bh(t):
        return t.transpose(1, 2).reshape(B * H, 1, S, -1)
    h = torch.zeros((B * H, N, P), device=q.device) if h0 is None \
        else h0.reshape(B * H, N, P)
    y, h = gla_recurrence(to_bh(q), to_bh(k), to_bh(v), to_bh(la[..., None])
                          [..., 0], h)
    return (y.reshape(B, H, S, P).transpose(1, 2).to(y_dtype or q.dtype),
            h.reshape(B, H, N, P))


def flash_by_chunks(q, k, v, causal=True):
    """The flash_attention op's function by the chunked oracle (a loop over
    key blocks with a running softmax; plain PyTorch, float32), at every
    size: the same math as the materialized oracle that the plain version
    runs at the LM paths' shapes, with its sums in another order."""
    from repro_torch.kernels.flash_attention.ref import attention_ref_chunked
    return attention_ref_chunked(q, k, v, group=q.shape[2] // k.shape[2],
                                 causal=causal)


def decode_by_heads(q, k, v, kv_len):
    """The decode_attention op's function by the reference's head-major
    oracle (decode_attention_ref over (B * KH, G, D) rows; plain PyTorch,
    float32): the same math as the cache-layout oracle the plain version
    runs, with the scale applied after the product and the normalization
    inside the softmax."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, _, HQ, D = q.shape
    S, KH = k.shape[1], k.shape[2]

    def rows(t):
        return t.permute(0, 2, 1, 3).reshape(B * KH, S, D)
    out = decode_attention_ref(q.reshape(B * KH, HQ // KH, D), rows(k),
                               rows(v), kv_len)
    return out.reshape(B, 1, HQ, D)


class PlainOps:
    """Swap the LM paths' kernel ops for their plain versions
    (flash_attention, decode_attention, quantized_linear at the name
    models/layers.py calls it by, the vta_gemm under its CPU chain, and
    the gla_chunk under Mamba2's chunked_gla), for the duration of the
    block; with scan="recurrence" the scan is gla_by_recurrence, with
    flash="chunked" the prefill attention is flash_by_chunks, with
    decode="heads" the decode attention is decode_by_heads.
    serve_run holds every kernel op's launch count still across a plain
    replay."""

    def __init__(self, scan="chunked", flash="plain", decode="plain"):
        self.scan, self.flash, self.decode = scan, flash, decode

    @staticmethod
    def _sites():
        import repro_torch.kernels.vta_gemm.ops as vops
        import repro_torch.models.attention as att
        import repro_torch.models.layers as layers
        import repro_torch.models.ssm as ssm
        return [(att, "flash_attention"), (att, "decode_attention"),
                (layers, "quantized_linear"), (vops, "vta_gemm"),
                (ssm, "gla_chunk")]

    def _swap(self, fns):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self._sites()]
        for (mod, name), fn in zip(self._sites(), fns):
            setattr(mod, name, fn)

    def __enter__(self):
        from repro_torch.kernels.decode_attention import \
            decode_attention_ref_4d
        from repro_torch.kernels.flash_attention import flash_attention_plain
        from repro_torch.kernels.gla_chunk import gla_chunk_plain
        from repro_torch.kernels.vta_gemm import (quantized_linear_ref,
                                                  vta_gemm_ref)
        self._swap([flash_attention_plain if self.flash == "plain"
                    else flash_by_chunks,
                    decode_attention_ref_4d if self.decode == "plain"
                    else decode_by_heads,
                    quantized_linear_ref, vta_gemm_ref,
                    gla_chunk_plain if self.scan == "chunked"
                    else gla_by_recurrence])
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


class CheckedOps(PlainOps):
    """For the duration of the block, every launch of the kernel ops also
    computes its plain version on the same inputs and is held to it:
    quantized_linear and vta_gemm bitwise, gla_chunk within 3e-4 + 3e-4
    |plain| elementwise, the attention kernels within attn_tolerance.
    `worst` keeps each op's largest error relative to max|plain|, `calls`
    its launches."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.decode_attention import (
            decode_attention, decode_attention_ref_4d)
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        from repro_torch.kernels.gla_chunk import gla_chunk, gla_chunk_plain
        from repro_torch.kernels.vta_gemm import (quantized_linear,
                                                  quantized_linear_ref,
                                                  vta_gemm, vta_gemm_ref)
        self.worst, self.calls = {}, {}

        def close(name, a, b):
            if name in ("vta_gemm", "quantized_linear"):
                return torch.equal(a, b)
            d = (a.float() - b.float()).abs()
            if name == "gla_chunk":
                return bool((d <= 3e-4 + 3e-4 * b.float().abs()).all())
            dt = "float32" if b.dtype == torch.float32 else "bfloat16"
            return float(d.max()) <= attn_tolerance(dt, b)

        def checked(name, kernel, plain):
            def call(*args, **kw):
                got, want = kernel(*args, **kw), plain(*args, **kw)
                pairs = zip(got, want) if isinstance(got, tuple) \
                    else [(got, want)]
                for a, b in pairs:
                    if not close(name, a, b):
                        d = float((a.float() - b.float()).abs().max())
                        fail(f"{name} differs from its plain version at a "
                             f"launch of the served path, shapes "
                             f"{[tuple(t.shape) for t in args[:2]]}, "
                             f"dtypes {[str(t.dtype) for t in args[:3]]}:"
                             f" max|difference| {d:.3e}, max|plain| "
                             f"{float(b.float().abs().max()):.3e}")
                    rel = float((a.float() - b.float()).abs().max()
                                / b.float().abs().max().clamp_min(1e-30))
                    self.worst[name] = max(self.worst.get(name, 0.0), rel)
                self.calls[name] = self.calls.get(name, 0) + 1
                return got
            return call
        self._swap([
            checked("flash_attention", flash_attention,
                    flash_attention_plain),
            checked("decode_attention", decode_attention,
                    decode_attention_ref_4d),
            checked("quantized_linear", quantized_linear,
                    quantized_linear_ref),
            checked("vta_gemm", vta_gemm, vta_gemm_ref),
            checked("gla_chunk", gla_chunk, gla_chunk_plain)])
        return self


def lm_engine(cfg, params, counters, forced=None, slots=LM_SLOTS,
              max_len=LM_MAX_LEN):
    """A ServeEngine (float32 caches) that times each prefill
    (add_request) and decode step (both end in a host read of the chosen
    tokens), counts the kernels' launches in each, keeps every call's
    logits on the card, and, when `forced` is given, takes those tokens in
    place of its own choice."""
    import torch
    from repro_torch.launch.serve import ServeEngine

    class Engine(ServeEngine):
        def __init__(self):
            super().__init__(cfg, params, batch_slots=slots,
                             max_len=max_len, dtype=torch.float32,
                             torch_device=DEVICE)
            self.logits, self.chosen = [], []
            self.prefill_ms, self.step_ms = [], []
            self.prefill_launches, self.step_launches = [], []

        def next_tokens(self, logits):
            self.logits.append(logits.float().clone())
            own = super().next_tokens(logits)
            self.chosen.append(own)
            return own if forced is None else forced[len(self.chosen) - 1]

        def _timed(self, fn, ms, launches):
            before = {k: op.launches for k, op in counters.ops.items()}
            t0 = time.perf_counter()
            out = fn()
            dt = (time.perf_counter() - t0) * 1e3
            delta = {k: op.launches - before[k]
                     for k, op in counters.ops.items()}
            if out is not False:
                ms.append(dt)
                launches.append(delta)
            return out

        def add_request(self, req):
            return self._timed(lambda: super(Engine, self).add_request(req),
                               self.prefill_ms, self.prefill_launches)

        def step(self):
            if all(r is None for r in self.slot_req):
                return
            self._timed(lambda: super(Engine, self).step(), self.step_ms,
                        self.step_launches)
    return Engine()


def compare_logits(kernel_eng, plain_eng, what, limit=LM_LOGIT_TOL):
    """Every call's logits, kernel run against the teacher-forced plain
    run: the largest |difference| over max|plain logit|, and the share of
    rows whose argmax agrees; fails above `limit` (None: never)."""
    import torch
    if len(kernel_eng.logits) != len(plain_eng.logits):
        fail(f"{what}: {len(kernel_eng.logits)} logit calls against "
             f"{len(plain_eng.logits)} in the plain run")
    worst, agree, rows = 0.0, 0, 0
    for i, (a, b) in enumerate(zip(kernel_eng.logits, plain_eng.logits)):
        if not torch.isfinite(a).all() or a.shape != b.shape:
            fail(f"{what}: call {i} logits not finite or of another shape")
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        rows += a.shape[0]
    if limit is not None and worst > limit:
        fail(f"{what}: logits differ from the plain run by {worst:.4f} of "
             f"max|logit| (limit {limit})")
    return worst, agree / rows


def lm_summary(eng, done, wall_s):
    tokens = sum(len(r.out_tokens) for r in done)
    st = sorted(eng.step_ms)

    def per(launches):
        keys = launches[0].keys() if launches else []
        return {k: statistics.mean(d[k] for d in launches) for k in keys}
    return dict(requests=len(done), tokens=tokens, wall_s=wall_s,
                tokens_per_s=tokens / wall_s,
                prefill_ms=eng.prefill_ms,
                prefill_ms_median=statistics.median(eng.prefill_ms),
                decode_steps=len(st),
                step_ms_median=statistics.median(st),
                step_ms_p90=st[int(0.9 * (len(st) - 1))],
                launches_per_prefill=per(eng.prefill_launches),
                launches_per_step=per(eng.step_launches))


def lm_weights(arch, dtype=None, quantized=True):
    """An arch's config at full width (in `dtype` where given), its random
    weights from torch.Generator seed 0 (the reference's distributions)
    on the card, and their int8 PTQ (None unless `quantized`); the
    seconds both took."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.quantized import quantize_params
    cfg = get_arch(arch).model
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = T.init_params(cfg, torch.Generator(device=DEVICE)
                               .manual_seed(0), torch_device=DEVICE)
        qparams = quantize_params(params) if quantized else None
    torch.cuda.synchronize()
    return cfg, params, qparams, time.perf_counter() - t0


#: the second plain replays that measure a model's own rounding floor:
#: the same function with its float sums in another order
FLOOR_REPLAYS = {
    "recurrence": ("chunked scan, step recurrence",
                   dict(scan="recurrence")),
    "chunked_flash": ("materialized and chunked attention oracles",
                      dict(flash="chunked")),
    "attention_oracles": ("materialized and chunked prefill attention, "
                          "cache-layout and head-major decode attention",
                          dict(flash="chunked", decode="heads")),
}


def plain_replay(what, counters, run, forcing=None, **kind):
    """run() with the kernel ops swapped for their plain versions
    (PlainOps(**kind)), inside forcing() where given: a teacher-forced
    replay, which fails if a kernel op launched.  Returns run()'s engine,
    its caches dropped."""
    before = {k: op.launches for k, op in counters.ops.items()}
    with PlainOps(**kind), \
            (forcing() if forcing else contextlib.nullcontext()):
        eng = run()
    eng.caches = None
    moved = {k: op.launches - before[k] for k, op in counters.ops.items()
             if op.launches != before[k]}
    if moved:
        fail(f"{what}: a plain replay ({kind}) launched kernels: {moved}")
    return eng


def serve_run(cfg, what, params, requests, counters, slots=LM_SLOTS,
              max_len=LM_MAX_LEN, floor=None, forcing=None):
    """Serve `requests()` with the counts set to 0 just before and read
    just after; replay them with PlainOps, teacher-forced on the kernel
    run's tokens (no kernel op may launch in a replay), every call's
    logits within LM_LOGIT_TOL of max|logit|.  With `floor` (a key of
    FLOOR_REPLAYS), a second plain replay measures the model's own
    rounding floor, the largest gap between the two plain runs; where
    twice that floor exceeds LM_LOGIT_TOL, the kernel run is held to
    twice the floor instead.  `forcing`, where given, makes a context
    entered around each replay (phase 12's forces the kernel run's
    routing).  Returns the run's summary, with its launch counts."""
    import torch
    eng = lm_engine(cfg, params, counters, slots=slots, max_len=max_len)
    reqs = requests()
    counters.reset()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    # only the logits and tokens are compared: each run's caches go before
    # the next run's are made (phase 12's weights leave about 1 GB free)
    eng.caches = None
    # flash_attention's two kernels by dtype: wgmma for bf16, FMA for f32
    flash_by_dtype = {}
    for key, n in counters.ops["flash_attention"].shapes.items():
        flash_by_dtype[key[-1]] = flash_by_dtype.get(key[-1], 0) + n
    if len(done) != len(reqs) or any(len(r.out_tokens) != r.max_new
                                     for r in done):
        fail(f"{what}: served {len(done)} of {len(reqs)} requests")
    summary = lm_summary(eng, done, wall)

    def replay(**kind):
        def run():
            eng_p = lm_engine(cfg, params, counters, forced=eng.chosen,
                              slots=slots, max_len=max_len)
            eng_p.run(requests())
            return eng_p
        return plain_replay(what, counters, run, forcing, **kind)
    plain = replay()
    limit, floor_gap = LM_LOGIT_TOL, None
    if floor:
        alt = replay(**FLOOR_REPLAYS[floor][1])
        floor_gap, _ = compare_logits(alt, plain, what, limit=None)
        limit = max(LM_LOGIT_TOL, 2 * floor_gap)
    worst, agree = compare_logits(eng, plain, what, limit=limit)
    summary.update(launches=launches, flash_by_dtype=flash_by_dtype,
                   logit_max_rel_err=worst,
                   logit_limit=limit, logit_floor=floor_gap,
                   argmax_agreement=agree,
                   tokens_head={r.rid: r.out_tokens[:8] for r in done},
                   prefill_launches=eng.prefill_launches,
                   step_launches=eng.step_launches)
    lp, ls = summary["launches_per_prefill"], summary["launches_per_step"]
    log(f"  {what}: {summary['requests']} requests, "
        f"{summary['tokens']} tokens in {wall:.2f} s "
        f"({summary['tokens_per_s']:.1f} tokens/s); prefill median "
        f"{summary['prefill_ms_median']:.2f} ms; decode step median "
        f"{summary['step_ms_median']:.2f} ms, p90 "
        f"{summary['step_ms_p90']:.2f} ms over "
        f"{summary['decode_steps']} steps")
    log("    launches per prefill: " + ", ".join(
        f"{k} {v:.2f}" for k, v in lp.items() if v)
        + "; per decode step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in ls.items() if v))
    log(f"    against the plain run (teacher-forced): logits within "
        f"{worst:.3e} of max|logit| (limit {limit:.3e}); argmax "
        f"agreement {agree:.4f}"
        + ("" if floor_gap is None else
           f"; the two plain runs ({FLOOR_REPLAYS[floor][0]}) differ by "
           f"{floor_gap:.3e}"))
    return summary


def phase_lm(rec, counters):
    """llama3.2-3b at full width (28 layers, d 3072, 24/8 heads, hd 128,
    d_ff 8192, vocab 128256, bf16, tied embeddings, rope theta 5e5): random
    weights from torch.Generator seed 0 with the reference's distributions,
    int8 PTQ (quantize_params), served by ServeEngine(4 slots, max_len 256,
    float32 caches) to the reference CLI's traffic (6 requests, 16-token
    prompts from np.random.default_rng(0), 16 new tokens each); then 2
    requests through the bf16 weights (no vta_gemm), then 2 through the
    int8 weights with the int8 KV cache.  Each run is replayed with the
    kernels swapped for their plain versions, teacher-forced on the kernel
    run's tokens, and every call's logits held within LM_LOGIT_TOL of
    max|logit| (the int8 KV cache run within twice the gap between two
    plain oracles where that is larger, and every launch of it held to
    its plain version).  The counts are set to 0 just
    before each served run and read just after."""
    import torch
    from repro_torch.launch.serve import make_requests
    cfg, params, qparams, init_s = lm_weights(LM_ARCH)
    n_params = sum(t.numel() for t in params.state_dict().values())
    log(f"  {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}: {n_params} parameters, "
        f"init + PTQ {init_s:.1f} s")
    # warm-up: one request through each weight set (cuBLAS, allocator)
    for p in (qparams, params):
        lm_engine(cfg, p, counters).run(make_requests(cfg, 1, 2, seed=99))
    torch.cuda.synchronize()
    out = {}
    cfg_kvq = cfg.replace(kv_cache_quant=True)
    for name, c, p, n_req in (
            ("int8", cfg, qparams, LM_REQUESTS),
            ("bf16", cfg, params, LM_BF16_REQUESTS),
            ("int8_kvq", cfg_kvq, qparams, LM_KVQ_REQUESTS)):
        # the int8 KV cache run, whose model alone differs from itself by
        # more than LM_LOGIT_TOL between two plain oracles, is held as
        # phase 9's runs are (serve_run's floor)
        summary = serve_run(
            c, f"LM {name} weights" + (", int8 KV cache" if
                                       c.kv_cache_quant else ""), p,
            lambda n=n_req: make_requests(cfg, n, LM_MAX_NEW), counters,
            floor="chunked_flash" if c.kv_cache_quant else None)
        launches = summary["launches"]
        want = {"flash_attention": 1, "decode_attention": 1,
                "vta_gemm": int(p is qparams)}
        for k, need in want.items():
            if (launches[k] > 0) != bool(need):
                fail(f"LM {name}: {k} launched {launches[k]} times")
        out[name] = summary
    with CheckedOps() as chk:
        lm_engine(cfg_kvq, qparams, counters).run(
            make_requests(cfg, LM_KVQ_REQUESTS, LM_MAX_NEW))
    out["kvq_launch_checks"] = dict(worst=chk.worst, launches=chk.calls)
    log("  LM int8 weights, int8 KV cache, every launch against its plain "
        "version on the same inputs: " + ", ".join(
            f"{k} x{chk.calls[k]} within {v:.2e} of max|plain|"
            for k, v in sorted(chk.worst.items())))
    out["lm_profile"] = lm_step_profile(cfg, qparams, counters)
    rec["lm"] = dict(arch=LM_ARCH, params=n_params, init_s=init_s,
                     slots=LM_SLOTS, max_len=LM_MAX_LEN,
                     max_new=LM_MAX_NEW, **out)
    del params, qparams
    torch.cuda.empty_cache()
    return out


def lm_step_profile(cfg, params, counters, slots=LM_SLOTS,
                    max_len=LM_MAX_LEN, label="LM"):
    """Device idle share of one profiled decode step with every slot
    active (after a warm one): device busy time over the profiled wall
    time."""
    from repro_torch.launch.serve import make_requests
    eng = lm_engine(cfg, params, counters, slots=slots, max_len=max_len)
    for r in make_requests(cfg, slots, LM_MAX_NEW, seed=7):
        eng.add_request(r)
    return step_profile(eng.step, f"{label} decode step ({slots} slots, "
                        f"int8)")


def step_profile(step, label):
    """Device idle share of one profiled call of step() (after a warm one
    and a timed one): device busy time over the profiled wall time.
    step() ends in a host read, as a served step does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if t > 0 and e.device_type == DeviceType.CUDA:
            kernels[e.key] = t / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    out = dict(step_ms=plain_ms, profiled_ms=wall_ms, device_busy_ms=dev_ms,
               idle_share=1 - dev_ms / wall_ms, top_device_ms=top)
    log(f"  profile of one {label}: {plain_ms:.2f} ms "
        f"({wall_ms:.2f} ms profiled); device busy {dev_ms:.3f} ms -> idle "
        f"share {1 - dev_ms / wall_ms:.4f}")
    for k, t in top[:5]:
        log(f"    {k[:90]}: {t:.3f} ms")
    return out


# ----------------------------------------------------------------------
# phase 9: the hybrid serve path (the fourth main path)
# ----------------------------------------------------------------------
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_SLOTS, HYBRID_MAX_LEN = 4, 1024
#: one long prompt: 8 chunks of 64, so the state crosses chunks on the card
HYBRID_LONG_PROMPT = 512


def hybrid_launches(cfg, quantized):
    """The launches one prefill and one decode step must make: a gla_chunk
    per Mamba2 layer in prefill only; per application of the shared block
    one flash_attention (prefill) or decode_attention (decode); with int8
    weights a vta_gemm per quantized linear (in_proj and out_proj of each
    layer, wq wk wv wo and the MLP's wi wg wo of each application)."""
    pattern = cfg.block_pattern()
    shared = pattern.count("mamba2_sharedattn")
    gemms = (2 * len(pattern) + shared * (4 + 3)) * int(quantized)
    prefill = {"gla_chunk": len(pattern), "flash_attention": shared,
               "decode_attention": 0, "vta_gemm": gemms}
    step = {"gla_chunk": 0, "flash_attention": 0,
            "decode_attention": shared, "vta_gemm": gemms}
    return prefill, step


def phase_hybrid(rec, counters):
    """zamba2-1.2b at full width (38 Mamba2 layers, d 2048, d_inner 4096,
    64 SSM heads, N = P = 64, conv 4; the shared attention block, 32 heads
    at hd 64 with a swiglu MLP of d_ff 8192, applied after layers 6, 12,
    ..., 36; vocab 32000, untied head, bf16): random weights from
    torch.Generator seed 0, int8 PTQ, served by ServeEngine(4 slots,
    max_len 1024, float32 caches) to the reference CLI's traffic (6
    requests, 16-token prompts, 16 new tokens each), then to one request
    with a 512-token prompt (16 new tokens), then 2 requests through the
    bf16 weights and 2 through a float32 copy of them.  Each run is
    replayed with the kernels swapped for their plain versions
    (teacher-forced) and again with the scan by its step recurrence: in
    float32 the kernel run is held within LM_LOGIT_TOL of max|logit|; in
    bf16 and int8 the two plain runs alone differ by more than that (the
    model carries a rounding difference anywhere into every logit), and
    the kernel run is held within twice their gap (serve_run).  Every
    launch of the three served runs is then held to its plain version on
    the same inputs (CheckedOps, an untimed run), and every prefill and
    decode step to hybrid_launches.  The counts are set to 0 just before
    each served run and read just after."""
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import LMParams
    cfg, params, qparams, init_s = lm_weights(HYBRID_ARCH)

    def to_f32(tree):
        return {k: to_f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    cfg32, params32 = cfg.replace(dtype="float32"), \
        LMParams(to_f32(params.tree()))
    n_elems = sum(t.numel() for t in params.state_dict().values())
    log(f"  {HYBRID_ARCH}: {cfg.n_layers} Mamba2 layers, d {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads, N "
        f"{cfg.ssm_state}, P {cfg.ssm_head_dim}; shared attention every "
        f"{cfg.attn_every} layers, {cfg.n_heads} heads, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}; vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"ModelConfig.n_params {cfg.n_params} ({n_elems} elements with "
        f"norms, conv and SSM vectors), init + PTQ {init_s:.1f} s")
    kw = dict(slots=HYBRID_SLOTS, max_len=HYBRID_MAX_LEN)
    for p in (qparams, params):
        lm_engine(cfg, p, counters, **kw).run(
            make_requests(cfg, 1, 2, seed=99))
    torch.cuda.synchronize()
    runs = (
        ("int8", cfg, qparams, lambda: make_requests(cfg, LM_REQUESTS,
                                                     LM_MAX_NEW)),
        ("int8_long", cfg, qparams, lambda: make_requests(
            cfg, 1, LM_MAX_NEW, prompt_len=HYBRID_LONG_PROMPT, seed=1)),
        ("bf16", cfg, params, lambda: make_requests(cfg, LM_BF16_REQUESTS,
                                                    LM_MAX_NEW)),
        ("f32", cfg32, params32, lambda: make_requests(
            cfg, LM_BF16_REQUESTS, LM_MAX_NEW)))
    out = {}
    for name, c, p, requests in runs:
        summary = serve_run(c, f"{HYBRID_ARCH} {name}", p, requests,
                            counters, floor="recurrence", **kw)
        want_prefill, want_step = hybrid_launches(cfg, p is qparams)
        for what, got, want in (
                ("prefill", summary["prefill_launches"], want_prefill),
                ("decode step", summary["step_launches"], want_step)):
            for i, d in enumerate(got):
                bad = {k: d[k] for k in want if d[k] != want[k]}
                if bad:
                    fail(f"{HYBRID_ARCH} {name}: {what} {i} launched "
                         f"{bad}, not {want}")
        out[name] = summary
    checks = {}
    for name, c, p, requests in runs[:3]:
        with CheckedOps() as chk:
            lm_engine(c, p, counters, **kw).run(requests())
        checks[name] = dict(worst=chk.worst, launches=chk.calls)
        log(f"  {HYBRID_ARCH} {name}, every launch against its plain "
            f"version on the same inputs: " + ", ".join(
                f"{k} x{chk.calls[k]} within {v:.2e} of max|plain|"
                for k, v in sorted(chk.worst.items())))
    out["launch_checks"] = checks
    out["profile"] = lm_step_profile(cfg, qparams, counters, label=
                                     HYBRID_ARCH, **kw)
    rec["hybrid"] = dict(arch=HYBRID_ARCH, n_params=cfg.n_params,
                         elements=n_elems, init_s=init_s, **kw,
                         max_new=LM_MAX_NEW, **out)
    del params, qparams, params32
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 10: the autotuner on the card (the paper's design-space search)
# ----------------------------------------------------------------------
AUTOTUNE_SEED = 0


def autotune_workloads():
    """(workload, candidates, top-N): benchmarks/BENCH_autotune.json's two
    workloads (conv3x3 14x14x32-32 and matmul 64x128x128, seed 0, 12
    candidates, top 4), then ResNet-18's C9 at its published widths
    (paper Table 1: 14x14, 256 -> 256, 3x3), 8 candidates, top 2."""
    from repro_torch.core import autotune
    from repro_torch.core.conv import ConvShape
    from repro_torch.core.workloads import layer_by_name
    c9 = layer_by_name("C9").shape
    return [
        (autotune.conv_workload(ConvShape(n=1, h=14, w=14, ic=32, oc=32,
                                          kh=3, kw=3, stride=1, pad=1),
                                seed=AUTOTUNE_SEED), 12, 4),
        (autotune.matmul_workload(64, 128, 128, seed=AUTOTUNE_SEED), 12, 4),
        (autotune.conv_workload(c9, seed=AUTOTUNE_SEED,
                                name="C9 conv3x3_14x14x256-256"), 8, 2)]


def stage1_table(trials):
    return [(t.candidate.label(), t.predicted_cycles, t.error)
            for t in trials]


def phase_autotune(rec, counters):
    """search(..., backend="cuda", torch_device="cuda") on each workload of
    autotune_workloads, into a local TuningCache: stage 1 (the sampled
    candidates, their replayed cycles, the ranking) equal to stage 1
    computed on CPU tensors in this run; no candidate dropped by
    validation (the CUDA engine byte-equal to the simulator on every
    segment of every geometry the search took to stage 2, the output
    equal to the numpy reference); the winner validated; its program
    recompiled with the search's records swapped into the global cache
    (restored after, as benchmarks/bench_program.py does) is all hits,
    and its output byte-equal to conv2d_reference / matmul_reference.
    Each stage-2 trial's predicted over measured time is recorded (the
    engine is host-bound: no ranking by wall time is asserted).  The
    counts are set to 0 just before and read just after."""
    import numpy as np
    from repro_torch.core import autotune, hwspec
    base = hwspec.pynq()
    out = []
    counters.reset()
    t_phase = time.perf_counter()
    for wl, n_cand, top in autotune_workloads():
        kw = dict(base_spec=base, seed=AUTOTUNE_SEED, n_candidates=n_cand)
        t0 = time.perf_counter()
        cpu_trials, _, cpu_total = autotune.oracle_stage(
            wl, torch_device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        cache = autotune.TuningCache()
        t0 = time.perf_counter()
        res = autotune.search(wl, top_n=top, repeats=3, backend="cuda",
                              torch_device=DEVICE, cache=cache,
                              log=lambda s: log(f"    {s}"), **kw)
        search_s = time.perf_counter() - t0
        if res.candidates_total != cpu_total \
                or stage1_table(res.trials) != stage1_table(cpu_trials):
            fail(f"autotune {wl.name}: stage 1 on the card differs from "
                 f"stage 1 on CPU tensors")
        ranking = [t.candidate.label() for t in autotune.rank_trials(
            res.trials)]
        if ranking != [t.candidate.label()
                       for t in autotune.rank_trials(cpu_trials)]:
            fail(f"autotune {wl.name}: the ranking differs from CPU's")
        stage2 = [t for t in res.trials if t.validated is not None]
        if len(stage2) != 1 + min(top, len(ranking)):
            fail(f"autotune {wl.name}: {len(stage2)} candidates in stage 2")
        dropped = [t.candidate.label() for t in stage2 if not t.validated]
        if dropped:
            fail(f"autotune {wl.name}: candidates dropped by validation on "
                 f"the card: {dropped} ({[t.error for t in stage2]})")
        w = res.winner
        if w is None or not w.validated:
            fail(f"autotune {wl.name}: no validated winner")
        prog, feeds, refs = wl.build(w.candidate.spec,
                                     w.candidate.virtual_threads,
                                     w.candidate.lowering)
        n_ops = sum(1 for n in prog.nodes if n.op in ("conv2d", "matmul"))
        gc = autotune.global_cache()
        snap = (dict(gc.entries), gc.hits, gc.misses)
        try:
            gc.entries = dict(cache.entries)
            again = prog.compile(use_cache=False, torch_device=DEVICE)
        finally:
            gc.entries, gc.hits, gc.misses = snap
        if (again.tune_hits, again.tune_misses) != (n_ops, 0):
            fail(f"autotune {wl.name}: the winner's recompile made "
                 f"{again.tune_hits} hits, {again.tune_misses} misses over "
                 f"{n_ops} accelerator ops")
        got = again(backend="cuda", **feeds)
        if got.dtype != refs["y"].dtype or not np.array_equal(got,
                                                              refs["y"]):
            fail(f"autotune {wl.name}: the winner's output differs from the "
                 f"numpy reference")
        trials = [dict(t.to_json(), predicted_over_measured=(
            t.predicted_s / t.measured_s if t.measured_s else None))
            for t in res.trials]
        row = dict(workload=wl.name, candidates=len(res.trials),
                   candidates_total=res.candidates_total, top_n=top,
                   cpu_stage1_s=cpu_s, search_s=search_s,
                   errors=sum(t.error is not None for t in res.trials),
                   winner=w.candidate.label(),
                   baseline=res.baseline.candidate.label(),
                   speedup_predicted=res.speedup_predicted,
                   speedup_measured=res.speedup_measured,
                   recompile=dict(tune_hits=again.tune_hits,
                                  tune_misses=again.tune_misses,
                                  insns=again.insn_count),
                   records=len(cache), trials=trials)
        out.append(row)
        log(f"  {wl.name}: {len(res.trials)} of {res.candidates_total} "
            f"candidates, stage 1 equal to CPU's ({cpu_s:.1f} s there), "
            f"search {search_s:.1f} s; stage 2 validated "
            f"{len(stage2)}/{len(stage2)}; winner {w.candidate.label()} "
            f"(predicted {res.speedup_predicted:.3f}x, measured "
            f"{res.speedup_measured:.3f}x the baseline); recompile "
            f"{again.tune_hits} hit/{again.tune_misses} miss, output "
            f"byte-equal")
        for t in stage2:
            log(f"    {t.candidate.label()}: predicted {t.predicted_s * 1e3:.3f}"
                f" ms ({t.predicted_cycles:.0f} cycles at "
                f"{t.candidate.spec.freq_mhz:g} MHz), measured "
                f"{t.measured_s * 1e3:.3f} ms, predicted / measured "
                f"{t.predicted_s / t.measured_s:.4f}")
    launches = counters.read()
    for k in ("vta_gemm", "tensor_alu_scatter"):
        if launches[k] <= 0:
            fail(f"{k} was never launched by the autotuner on the card")
    rec["autotune"] = dict(seconds=time.perf_counter() - t_phase,
                           launches=launches, workloads=out)
    log(f"  autotuner launches: {launches}")
    return launches


# ----------------------------------------------------------------------
# phase 11: xlstm-1.3b served (gla_chunk's N 256 instance)
# ----------------------------------------------------------------------
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_SLOTS, XLSTM_MAX_LEN = 4, 1024
#: one prompt of one whole chunk: gla_chunk B1 S512 H4 N256 P1025
XLSTM_LONG_PROMPT = 512


def xlstm_launches(cfg, quantized):
    """The launches one prefill and one decode step must make: a gla_chunk
    per mLSTM layer in prefill only; with int8 weights a vta_gemm per
    quantized linear (up_x, up_z, wq, wk, wv, w_if and down of an mLSTM;
    w_in and down of an sLSTM); no other kernel (the sLSTM loop and the
    mLSTM decode step are plain PyTorch, as in the reference)."""
    pattern = cfg.block_pattern()
    m, s = pattern.count("mlstm"), pattern.count("slstm")
    gemms = (7 * m + 2 * s) * int(quantized)
    none = {k: 0 for k in ("tensor_alu", "tensor_alu_scatter", "lut_gemm",
                           "decode_attention", "flash_attention")}
    return (dict(none, gla_chunk=m, vta_gemm=gemms),
            dict(none, gla_chunk=0, vta_gemm=gemms))


def slstm_loop_profile(cfg, params):
    """One sLSTM layer's prefill of a XLSTM_LONG_PROMPT-token prompt (the
    loop over time) on the card, under torch.profiler: its wall ms (after
    a warm call), device operations and busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import xlstm
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.transformer import _index
    p = _index(params.tree()["layers"]["slstm"], 0)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    x = torch.randn((1, XLSTM_LONG_PROMPT, cfg.d_model), generator=g,
                    device=DEVICE).to(getattr(torch, cfg.dtype))
    h = norm_apply(cfg, p["ln1"], x)

    def run():
        cache = xlstm.init_slstm_cache(cfg, 1, torch.device(DEVICE))
        with torch.inference_mode():
            xlstm.slstm_prefill(p["slstm"], cfg, h, cache)
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    out = dict(prompt=XLSTM_LONG_PROMPT, wall_ms=wall, profiled_ms=prof_ms,
               device_operations=len(ev), device_busy_ms=busy,
               idle_share=1 - busy / prof_ms,
               operations_per_step=len(ev) / XLSTM_LONG_PROMPT)
    log(f"  sLSTM prefill loop, one layer, {XLSTM_LONG_PROMPT} tokens: "
        f"{wall:.1f} ms ({prof_ms:.1f} ms profiled), {len(ev)} device "
        f"operations ({len(ev) / XLSTM_LONG_PROMPT:.1f} a step), device "
        f"busy {busy:.2f} ms -> idle share {1 - busy / prof_ms:.4f}")
    return out


def phase_xlstm(rec, counters):
    """xlstm-1.3b at full width (48 layers, an sLSTM every 8th: 42 mLSTM
    and 6 sLSTM; d 2048, 4 heads, q/k width N 256, v width 1024 + the
    denominator channel; vocab 50304, bf16): random weights from
    torch.Generator seed 0, int8 PTQ, served by ServeEngine(4 slots,
    max_len 1024, float32 caches) to the reference CLI's traffic (6
    requests, 16-token prompts, 16 new tokens each), then to one request
    with a 512-token prompt (gla_chunk B1 S512 H4 N256 P1025 at chunk
    512, bf16 q and k), then 2 requests through the bf16 weights and 2
    through a float32 copy of them.  Each run is replayed with the
    kernels swapped for their plain versions (teacher-forced) and again
    with the scan by its step recurrence, and held within LM_LOGIT_TOL of
    max|logit| or twice the gap of the two plain runs where that is
    larger (serve_run): on random weights the int8 and bf16 models carry
    a rounding difference into every logit (their floors exceed the
    tolerance), so the float32 run is the end-to-end check that stays
    sharp where its floor is below the tolerance.
    Every launch of the four runs is then held to its plain version on
    the same inputs
    (CheckedOps), every prefill and decode step to xlstm_launches, and
    each int8 run's quantized_linear calls to its vta_gemm launches.  The
    counts are set to 0 just before each served run and read just
    after."""
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.transformer import LMParams
    cfg, params, qparams, init_s = lm_weights(XLSTM_ARCH)

    def to_f32(tree):
        return {k: to_f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    cfg32, params32 = cfg.replace(dtype="float32"), \
        LMParams(to_f32(params.tree()))
    n_elems = sum(t.numel() for t in params.state_dict().values())
    pattern = cfg.block_pattern()
    log(f"  {XLSTM_ARCH}: {cfg.n_layers} layers ({pattern.count('mlstm')} "
        f"mLSTM, {pattern.count('slstm')} sLSTM), d {cfg.d_model}, heads "
        f"{cfg.n_heads}, vocab {cfg.vocab_size}, {cfg.dtype}: "
        f"{n_elems} parameters, init + PTQ {init_s:.1f} s")
    kw = dict(slots=XLSTM_SLOTS, max_len=XLSTM_MAX_LEN)
    for p in (qparams, params):
        lm_engine(cfg, p, counters, **kw).run(
            make_requests(cfg, 1, 2, seed=99))
    torch.cuda.synchronize()
    runs = (
        ("int8", cfg, qparams, lambda: make_requests(cfg, LM_REQUESTS,
                                                     LM_MAX_NEW)),
        ("int8_long", cfg, qparams, lambda: make_requests(
            cfg, 1, LM_MAX_NEW, prompt_len=XLSTM_LONG_PROMPT, seed=1)),
        ("bf16", cfg, params, lambda: make_requests(cfg, LM_BF16_REQUESTS,
                                                    LM_MAX_NEW)),
        ("f32", cfg32, params32, lambda: make_requests(
            cfg, LM_BF16_REQUESTS, LM_MAX_NEW)))
    ql = counters.shaped["quantized_linear"]
    out = {}
    for name, c, p, requests in runs:
        summary = serve_run(c, f"{XLSTM_ARCH} {name}", p, requests,
                            counters, floor="recurrence", **kw)
        want_prefill, want_step = xlstm_launches(cfg, p is qparams)
        for what, got, want in (
                ("prefill", summary["prefill_launches"], want_prefill),
                ("decode step", summary["step_launches"], want_step)):
            for i, d in enumerate(got):
                bad = {k: d[k] for k in want if d[k] != want[k]}
                if bad:
                    fail(f"{XLSTM_ARCH} {name}: {what} {i} launched {bad}, "
                         f"not {want}")
        calls = sum(ql.shapes.values())
        if calls != summary["launches"]["vta_gemm"]:
            fail(f"{XLSTM_ARCH} {name}: {calls} quantized_linear calls, "
                 f"{summary['launches']['vta_gemm']} vta_gemm launches")
        summary["quantized_linear_calls"] = calls
        out[name] = summary
    checks = {}
    for name, c, p, requests in runs:
        with CheckedOps() as chk:
            lm_engine(c, p, counters, **kw).run(requests())
        if p is qparams and not chk.calls.get("quantized_linear"):
            fail(f"{XLSTM_ARCH} {name}: no quantized_linear launch checked")
        if not chk.calls.get("gla_chunk"):
            fail(f"{XLSTM_ARCH} {name}: no gla_chunk launch checked")
        checks[name] = dict(worst=chk.worst, launches=chk.calls)
        log(f"  {XLSTM_ARCH} {name}, every launch against its plain version "
            f"on the same inputs: " + ", ".join(
                f"{k} x{chk.calls[k]} within {v:.2e} of max|plain|"
                for k, v in sorted(chk.worst.items())))
    out["launch_checks"] = checks
    out["profile"] = lm_step_profile(cfg, qparams, counters,
                                     label=XLSTM_ARCH, **kw)
    out["slstm_loop"] = slstm_loop_profile(cfg, qparams)
    rec["xlstm"] = dict(arch=XLSTM_ARCH, elements=n_elems, init_s=init_s,
                        **kw, max_new=LM_MAX_NEW, **out)
    del params, qparams, params32
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 12: the moe models served (phi3.5-moe, kimi-k2)
# ----------------------------------------------------------------------
PHI_ARCH, KIMI_ARCH = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
MOE_SLOTS, MOE_MAX_LEN = 4, 256
#: phi3.5-moe's long prompt (capacity 80 a layer), served with caches of
#: MOE_LONG_MAX_LEN rows: the prompt and 16 new tokens, rounded up to 32
MOE_LONG_PROMPT, MOE_LONG_MAX_LEN = 512, 544
#: the bf16 phi3.5-moe run's depth, the largest that fits: its bf16
#: attention (84 MB a layer) takes the int8 attention's place beside the
#: same 32 layers of experts.  Measured on an H100 80GB HBM3 (85.02 GB by
#: mem_get_info): 3.01-3.11 GB free once the int8 attention is gone; 32
#: layers leave 0.03 GB and the run's caches do not fit (out of memory);
#: 31 leave 0.13 GB and run, at a peak of 84.05 GB allocated
PHI_BF16_LAYERS = 31
#: the float32 run's depth: phi3.5-moe's 32 layers would take 161 GB in
#: float32, 4 take 20.1 GB of experts
PHI_F32_LAYERS = 4
#: kimi-k2's depth: each of its 61 layers holds 33.8 GB of bf16 experts,
#: so 2 fit on one 80 GB card beside its 4.7 GB embedding and head
KIMI_LAYERS = 2


def mem_gb():
    """(free, total) device memory in GB (torch.cuda.mem_get_info)."""
    import torch
    free, total = torch.cuda.mem_get_info()
    return free / 1e9, total / 1e9


def free_device_memory():
    """Drop the compile cache's programs (each holds its device image,
    256 MB by default) and what nothing references any more (lm_engine's
    Engine classes hold their weights in a reference cycle, freed only
    by the cyclic collector), and return the cached blocks to the card."""
    import gc
    import torch
    from repro_torch.core.program import clear_compile_cache
    clear_compile_cache()
    gc.collect()
    torch.cuda.empty_cache()


def moe_attention(gen, cfg, quantized):
    """cfg.n_layers layers of attention (attn_init: the reference's
    distributions) drawn one layer at a time into stacks: bf16 {"w": (L,
    K, N)}, or with `quantized` their int8 PTQ as quantize_params stores
    it ({"w_q": (L, K, N), a view of contiguous (L, N, K), "w_scale": (L,
    N)}), each layer quantized before the next is drawn.  So no float32
    or bf16 stack of every layer exists beside the model."""
    import torch
    from repro_torch.models.attention import attn_init
    from repro_torch.models.layers import quantize_linear_params
    L = cfg.n_layers
    stacks = {}
    for i in range(L):
        for name, lin in attn_init(gen, cfg, torch.device(DEVICE)).items():
            if quantized:
                q = quantize_linear_params(lin)
                lin = {"w_q": q["w_q"].t(), "w_scale": q["w_scale"]}
            for leaf, t in lin.items():
                if i == 0:
                    stacks.setdefault(name, {})[leaf] = torch.empty(
                        (L,) + tuple(t.shape), dtype=t.dtype, device=DEVICE)
                stacks[name][leaf][i] = t
    if quantized:
        for s in stacks.values():
            s["w_q"] = s["w_q"].transpose(1, 2)
    return stacks


def moe_weights(arch, n_layers, dtype=None, quantized=True):
    """`arch` at its published widths cut to `n_layers` (in `dtype` where
    given), random weights from torch.Generator seed 0 with the
    reference's distributions, built on the card to fit: the embedding,
    head and final norm by init_params, then the layer stack: the norms,
    the attention by moe_attention (int8 where `quantized`), the experts
    by moe_init (straight into the model's dtype, one (d, f) matrix at a
    time) and, where `quantized`, kimi-k2's shared expert quantized
    (quantize_params).  Returns (cfg, tree, generator, record), the record
    with the build's seconds and mem_get_info before and after."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import norm_init
    from repro_torch.models.moe import moe_init
    from repro_torch.models.quantized import quantize_params
    cfg = get_arch(arch).model.replace(
        n_layers=n_layers, **({} if dtype is None else {"dtype": dtype}))
    dev, lead = torch.device(DEVICE), (n_layers,)
    before = mem_gb()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.inference_mode():
        tree = T.init_params(cfg.replace(n_layers=0), gen,
                             torch_device=dev).tree()
        tree["layers"] = {"moe": {
            "ln1": norm_init(cfg, cfg.d_model, dev, lead),
            "attn": moe_attention(gen, cfg, quantized),
            "ln2": norm_init(cfg, cfg.d_model, dev, lead),
            "moe": moe_init(gen, cfg, dev, lead)}}
        if quantized:
            tree = quantize_params(tree).tree()
    torch.cuda.synchronize()
    build = dict(arch=arch, n_layers=n_layers, dtype=cfg.dtype,
                 quantized=quantized, seconds=time.perf_counter() - t0,
                 weight_gb=tree_bytes(tree) / 1e9,
                 mem_free_total_gb_before=before,
                 mem_free_total_gb_after=mem_gb())
    log(f"  {arch}, {n_layers} layers, {cfg.dtype}"
        f"{', int8 PTQ' if quantized else ''}: {build['weight_gb']:.3f} GB "
        f"of weights built in {build['seconds']:.1f} s; mem_get_info free "
        f"/ total {before[0]:.3f} / {before[1]:.3f} GB before, "
        f"{build['mem_free_total_gb_after'][0]:.3f} GB free after")
    return cfg, tree, gen, build


def first_layers(tree, n):
    """Views of the first `n` layers of a stacked layer tree."""
    return {k: first_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def moe_capacity(cfg, tokens):
    """The capacity of each expert when `tokens` tokens are routed."""
    from repro_torch.models.moe import _capacity
    return _capacity(tokens, cfg.moe_top_k, cfg.moe_experts,
                     cfg.moe_capacity_factor)


def tree_bytes(tree, skip=()):
    """The bytes of a weight tree's tensors, the top-level keys in `skip`
    left out."""
    total = 0
    for k, v in tree.items():
        if k in skip:
            continue
        total += tree_bytes(v) if isinstance(v, dict) \
            else v.numel() * v.element_size()
    return total


def moe_launches(cfg, quantized):
    """The launches one prefill and one decode step must make: per layer
    one flash_attention (prefill) or decode_attention (decode), and with
    int8 weights one quantized_linear call, one vta_gemm count, per
    quantized linear (wq, wk, wv, wo; kimi-k2's shared expert's wi, wg,
    wo); no other kernel (routing, dispatch, the experts' torch.bmm FFN
    and the combine are PyTorch operations, as the reference's are jnp)."""
    L = cfg.n_layers
    gemms = L * (4 + 3 * cfg.n_shared_experts) * int(quantized)
    none = {k: 0 for k in ("tensor_alu", "tensor_alu_scatter", "lut_gemm",
                           "gla_chunk")}
    return (dict(none, flash_attention=L, decode_attention=0,
                 vta_gemm=gemms),
            dict(none, flash_attention=0, decode_attention=L,
                 vta_gemm=gemms))


class RouteLog:
    """While active, wrap models/moe.py's _route and dispatch_plan (moe_apply
    looks both up when it runs).  In the served run, record every moe
    layer call's routing (its top-k expert ids) and the pairs its
    dispatch plan drops.  Inside `forcing()` (around each teacher-forced
    replay), the replay's calls take the served run's routing, call by
    call, as its tokens are the served run's: each call still computes
    its own top k, which is recorded, and its gates are its own
    probabilities at the forced experts, renormalized as _route does.  So
    a routing decision near its boundary, which a rounding difference may
    flip, moves no logit, and the replay's own choices give the share of
    decisions on which it agrees with the served run."""

    def __enter__(self):
        import repro_torch.models.moe as moe
        self.mod, self.real = moe, (moe._route, moe.dispatch_plan)
        self.routes, self.drops, self.own = [], [], []
        self.at = None            # the replay's next call, inside forcing()

        def route(cfg, xt, w):
            import torch
            top_i, top_g, aux = self.real[0](cfg, xt, w)
            if self.at is None:
                self.routes.append(top_i.clone())
                return top_i, top_g, aux
            if self.at >= len(self.routes):
                fail("a replay made more moe layer calls than the served "
                     "run")
            want = self.routes[self.at]
            self.at += 1
            self.own.append(top_i.clone())
            probs = torch.softmax(xt.to(torch.float32) @ w, dim=-1)
            g = probs.gather(-1, want)
            return want, g / g.sum(-1, keepdim=True).clamp_min(1e-9), aux

        def plan(flat_e, n_experts, C):
            out = self.real[1](flat_e, n_experts, C)
            if self.at is None:
                self.drops.append((flat_e.numel(), (~out[2]).sum()))
            return out
        moe._route, moe.dispatch_plan = route, plan
        return self

    def __exit__(self, *exc):
        self.mod._route, self.mod.dispatch_plan = self.real
        return False

    @contextlib.contextmanager
    def forcing(self):
        self.at = 0
        try:
            yield
        finally:
            at, self.at = self.at, None
        if at != len(self.routes):
            fail(f"a replay made {at} moe layer calls, the served run "
                 f"{len(self.routes)}")

    def agreement(self):
        """The share of (token, layer) routing decisions (top-k sets) the
        first replay made as the served run did."""
        same = rows = 0
        for a, b in zip(self.routes, self.own):
            same += int((a.sort(-1).values == b.sort(-1).values)
                        .all(-1).sum())
            rows += a.shape[0]
        return same / rows

    def dropped(self, pairs=None):
        """The served run's dropped pairs per moe layer call (the calls
        routing `pairs` token-expert pairs, where given)."""
        return [int(d) for tk, d in self.drops
                if pairs is None or tk == pairs]


def check_launches(what, prefill, steps, want):
    """Every prefill and decode step's launch counts as `want` says."""
    for which, got, need in (("prefill", prefill, want[0]),
                             ("decode step", steps, want[1])):
        for i, d in enumerate(got):
            bad = {k: d[k] for k in need if d[k] != need[k]}
            if bad:
                fail(f"{what}: {which} {i} launched {bad}, not {need}")


def gemm_launches(what, counters, launches):
    """The run's quantized_linear calls, held equal to its vta_gemm count
    (one a call), and the vta_gemm device launches they made: one a call
    up to SKINNY_ROWS rows, the quantize launch and the wgmma instance
    above."""
    ql = counters.shaped["quantized_linear"].shapes
    calls = sum(ql.values())
    if calls != launches["vta_gemm"]:
        fail(f"{what}: {calls} quantized_linear calls, "
             f"{launches['vta_gemm']} vta_gemm counts")
    return calls, sum(n * (1 if M <= SKINNY_ROWS else 2)
                      for (M, _, _, _), n in ql.items())


def serve_moe(cfg, name, params, requests, counters, quantized, **kw):
    """serve_run on a moe model, its replays forced to the kernel run's
    routing as they are to its tokens (RouteLog: a routing decision near
    its boundary would carry a rounding difference into an expert of its
    own), held to twice the floor of the two attention oracles in
    prefill and in decode where that exceeds LM_LOGIT_TOL; every prefill
    and decode step held to moe_launches, the quantized_linear calls to
    the vta_gemm count; with the share of routing decisions the plain
    replay made as the kernel run did, the dropped pairs and the vta_gemm
    device launches (one a call up to SKINNY_ROWS rows, the quantize
    launch and the wgmma instance above)."""
    what = f"{cfg.name} {name}"
    with RouteLog() as routes:
        summary = serve_run(cfg, what, params, requests, counters,
                            floor="attention_oracles",
                            forcing=routes.forcing, **kw)
    check_launches(what, summary["prefill_launches"],
                   summary["step_launches"], moe_launches(cfg, quantized))
    calls, device = gemm_launches(what, counters, summary["launches"])
    dropped = routes.dropped()
    summary.update(quantized_linear_calls=calls,
                   vta_gemm_device_launches=device,
                   routing_agreement=routes.agreement(),
                   dropped_pairs=sum(dropped), moe_layer_calls=len(dropped))
    log(f"    routing (forced in the replays): the plain replay chose as "
        f"the kernel run did in {summary['routing_agreement']:.4f} of "
        f"(token, layer) decisions; "
        f"{sum(dropped)} pairs dropped over {len(dropped)} moe layer calls;"
        f" {calls} quantized_linear calls, {device} vta_gemm device "
        f"launches")
    return summary, routes


def checked_run(cfg, name, params, requests, counters, quantized, **kw):
    """The run again with every launch held to its plain version on the
    same inputs (CheckedOps)."""
    with CheckedOps() as chk:
        lm_engine(cfg, params, counters, **kw).run(requests())
    for k in ("flash_attention", "decode_attention") + (
            ("quantized_linear",) if quantized else ()):
        if not chk.calls.get(k):
            fail(f"{cfg.name} {name}: no {k} launch checked")
    log(f"  {cfg.name} {name}, every launch against its plain version on "
        f"the same inputs: " + ", ".join(
            f"{k} x{chk.calls[k]} within {v:.2e} of max|plain|"
            for k, v in sorted(chk.worst.items())))
    return dict(worst=chk.worst, launches=chk.calls)


def device_busy_ms(fn, windows=3):
    """Device busy ms of one call of fn(): every device operation's time
    in a torch.profiler window around one call (after a warm call), the
    largest of `windows` windows (the profiler loses records now and
    then, and a lost record only shortens a window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    busy = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy.append(sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA) / 1e3)
    return max(busy)


def expert_ffn_ms(cfg, tree, tokens):
    """One decode step's expert FFNs (torch.bmm swiglu over every layer's
    (E, C, d) buffer, C = _capacity(tokens, k, E, cf)) on their own:
    device busy ms and CUDA-event ms, beside the experts' byte bound."""
    import torch
    from repro_torch.models.moe import _expert_ffn
    E, C = cfg.moe_experts, moe_capacity(cfg, tokens)
    p = tree["layers"]["moe"]["moe"]
    g = torch.Generator(device=DEVICE).manual_seed(11)
    buf = torch.randn((E, C, cfg.d_model), generator=g, device=DEVICE) \
        .to(p["wi"].dtype)

    def step():
        with torch.inference_mode():
            for i in range(cfg.n_layers):
                _expert_ffn(buf, p["wi"][i], p["wg"][i], p["wo"][i])
    nbytes = sum(p[w].numel() * p[w].element_size()
                 for w in ("wi", "wg", "wo"))
    return dict(capacity=C, device_ms=device_busy_ms(step),
                call_ms=cuda_time_ms(step, reps=5, warmup=1),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def moe_profile(cfg, tree, counters, kw):
    """lm_step_profile of one decode step beside its byte bound (every
    weight but the embedding table read once at the memory rate) and
    the step's expert FFNs on their own."""
    prof = lm_step_profile(cfg, tree, counters, label=cfg.name, **kw)
    prof["step_bytes"] = tree_bytes(tree, skip=("embed",))
    prof["bound_ms"] = prof["step_bytes"] / HBM_BYTES_PER_S * 1e3
    prof["expert_ffn"] = expert_ffn_ms(cfg, tree, kw["slots"])
    log(f"    the step's weights {prof['step_bytes'] / 1e9:.3f} GB: byte "
        f"bound {prof['bound_ms']:.3f} ms; device busy "
        f"{prof['device_busy_ms']:.3f} ms; its expert FFNs alone "
        f"(C {prof['expert_ffn']['capacity']}): device "
        f"{prof['expert_ffn']['device_ms']:.3f} ms, events "
        f"{prof['expert_ffn']['call_ms']:.3f} ms, bound "
        f"{prof['expert_ffn']['bound_ms']:.3f} ms")
    return prof


def moe_traffic(cfg, n, prompt_len=16, seed=0):
    """n requests of `prompt_len` tokens, 16 new tokens each."""
    from repro_torch.launch.serve import make_requests
    return lambda: make_requests(cfg, n, LM_MAX_NEW, prompt_len=prompt_len,
                                 seed=seed)


def moe_serve_all(out, cfg, tree, runs, counters, quantized):
    """Serve each (name, requests, engine kwargs) of `runs` (serve_moe),
    then again with every launch checked (checked_run), after one warm-up
    request; the summaries go into `out` under "<arch> <name>", with the
    peak memory allocated since the warm-up and, for the long prompt, the
    dropped pairs by layer."""
    import torch
    from repro_torch.launch.serve import make_requests
    lm_engine(cfg, tree, counters, slots=MOE_SLOTS, max_len=MOE_MAX_LEN) \
        .run(make_requests(cfg, 1, 2, seed=99))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, requests, run_kw in runs:
        summary, routes = serve_moe(cfg, name, tree, requests, counters,
                                    quantized, **run_kw)
        if run_kw["max_len"] == MOE_LONG_MAX_LEN:
            per_layer = routes.dropped(pairs=MOE_LONG_PROMPT
                                       * cfg.moe_top_k)
            summary["long_prompt_dropped_per_layer"] = per_layer
            log(f"    the {MOE_LONG_PROMPT}-token prefill dropped "
                f"{per_layer} pairs by layer (capacity "
                f"{moe_capacity(cfg, MOE_LONG_PROMPT)} an expert)")
        summary["launch_checks"] = checked_run(
            cfg, name, tree, requests, counters, quantized, **run_kw)
        summary["peak_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        out[f"{cfg.name} {name}"] = summary


def moe_phi(out, counters):
    """phi3.5-moe at its published widths, int8 PTQ at every layer: the
    CLI traffic and the long prompt, a profiled decode step; then bf16
    attention in the int8 attention's place beside the same experts
    (moe_phi_bf16)."""
    import torch
    cfg, tree, gen, build = moe_weights(PHI_ARCH, 32)
    out["builds"].append(build)
    kw = dict(slots=MOE_SLOTS, max_len=MOE_MAX_LEN)
    moe_serve_all(out, cfg, tree, [
        ("int8", moe_traffic(cfg, LM_REQUESTS), kw),
        ("int8_long", moe_traffic(cfg, 1, MOE_LONG_PROMPT, seed=1),
         dict(slots=MOE_SLOTS, max_len=MOE_LONG_MAX_LEN))],
        counters, quantized=True)
    out[f"{cfg.name} profile"] = moe_profile(cfg, tree, counters, kw)
    moe_phi_bf16(out, counters, cfg, tree, gen)


def moe_phi_bf16(out, counters, cfg, tree, gen):
    """The bf16 phi3.5-moe run: the int8 attention of `tree` freed, bf16
    attention drawn for PHI_BF16_LAYERS layers in its place beside the
    same experts (views of their first PHI_BF16_LAYERS layers), 2
    requests."""
    import torch
    layer = tree["layers"]["moe"]
    layer["attn"] = None
    free_device_memory()
    before = mem_gb()
    t0 = time.perf_counter()
    cfg_bf = cfg.replace(n_layers=PHI_BF16_LAYERS)
    with torch.inference_mode():
        attn_bf = moe_attention(gen, cfg_bf, quantized=False)
    torch.cuda.synchronize()
    tree_bf = dict(tree, layers={"moe": dict(first_layers(
        {k: v for k, v in layer.items() if k != "attn"}, PHI_BF16_LAYERS),
        attn=attn_bf)})
    out["builds"].append(dict(arch=PHI_ARCH, n_layers=PHI_BF16_LAYERS,
                              what="bf16 attention in place of int8",
                              seconds=time.perf_counter() - t0,
                              weight_gb=tree_bytes(tree_bf) / 1e9,
                              mem_free_total_gb_before=before,
                              mem_free_total_gb_after=mem_gb()))
    log(f"  {PHI_ARCH} bf16 attention at {PHI_BF16_LAYERS} layers in the "
        f"int8 attention's place: {tree_bytes(tree_bf) / 1e9:.3f} GB of "
        f"weights; mem_get_info free {before[0]:.3f} GB before, "
        f"{mem_gb()[0]:.3f} GB after")
    moe_serve_all(out, cfg_bf, tree_bf, [
        ("bf16", moe_traffic(cfg, LM_BF16_REQUESTS),
         dict(slots=MOE_SLOTS, max_len=MOE_MAX_LEN))],
        counters, quantized=False)


def moe_phi_f32(out, counters):
    """phi3.5-moe in float32 at its published widths and PHI_F32_LAYERS
    layers, 2 requests: the end-to-end check that stays sharp."""
    cfg, tree, _, build = moe_weights(PHI_ARCH, PHI_F32_LAYERS,
                                      dtype="float32", quantized=False)
    out["builds"].append(build)
    moe_serve_all(out, cfg, tree, [
        ("f32", moe_traffic(cfg, LM_BF16_REQUESTS),
         dict(slots=MOE_SLOTS, max_len=MOE_MAX_LEN))],
        counters, quantized=False)


def moe_kimi(out, counters):
    """kimi-k2 at its published widths cut to KIMI_LAYERS layers, int8
    PTQ, the CLI traffic, a profiled decode step."""
    cfg, tree, _, build = moe_weights(KIMI_ARCH, KIMI_LAYERS)
    out["builds"].append(build)
    kw = dict(slots=MOE_SLOTS, max_len=MOE_MAX_LEN)
    moe_serve_all(out, cfg, tree, [
        ("int8", moe_traffic(cfg, LM_REQUESTS), kw)], counters,
        quantized=True)
    out[f"{cfg.name} profile"] = moe_profile(cfg, tree, counters, kw)


def phase_moe(rec, counters):
    """phi3.5-moe at its published widths (32 layers, d 4096, 32/8 heads
    at hd 128, 16 experts, top-2, expert width 6400, layernorm, vocab
    32064, bf16) on seed-0 weights built to fit (moe_weights): int8 PTQ
    served by ServeEngine(4 slots, max_len 256, float32 caches) to the
    reference CLI's traffic (6 requests, 16-token prompts, 16 new tokens
    each), then one request with a 512-token prompt (max_len 544); then
    bf16 attention in the int8 attention's place beside the same experts
    (PHI_BF16_LAYERS layers), 2 requests; then a float32 model at
    PHI_F32_LAYERS layers, 2 requests; then kimi-k2 at its published
    widths (d 7168, 64/8 heads, 384 experts, top-8, expert width 2048,
    one shared expert, rmsnorm, vocab 163840) cut to KIMI_LAYERS layers,
    int8, to the CLI traffic.  Each run is held to its teacher-forced
    plain replays (serve_moe), every launch of it to its plain version
    (checked_run), every prefill and decode step to moe_launches; the
    float32 matmuls must not run in TF32 (the router's logits are
    float32).  Records the builds' seconds and mem_get_info, each run's
    routing agreement and dropped pairs (by layer for the long prompt),
    and a profiled decode step of each int8 model beside its byte
    bound.  Each model is freed before the next is built."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmuls may run in TF32: the router's float32 logits "
             "would not be float32")
    t_phase = time.perf_counter()
    out = {"builds": [], "mem_free_total_gb_at_start": None}
    for stage in (moe_phi, moe_phi_f32, moe_kimi):
        free_device_memory()
        if out["mem_free_total_gb_at_start"] is None:
            out["mem_free_total_gb_at_start"] = mem_gb()
            out["allocated_gb_at_start"] = torch.cuda.memory_allocated() / 1e9
            log(f"  mem_get_info at the start: free / total "
                f"{out['mem_free_total_gb_at_start'][0]:.3f} / "
                f"{out['mem_free_total_gb_at_start'][1]:.3f} GB; "
                f"{out['allocated_gb_at_start']:.3f} GB allocated by "
                f"PyTorch")
        stage(out, counters)
    free_device_memory()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {out['seconds']:.1f} s")
    rec["moe"] = dict(slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                      long_max_len=MOE_LONG_MAX_LEN, max_new=LM_MAX_NEW,
                      phi_bf16_layers=PHI_BF16_LAYERS,
                      phi_f32_layers=PHI_F32_LAYERS,
                      kimi_layers=KIMI_LAYERS, **out)
    return out


# ----------------------------------------------------------------------
# phase 13: the encoder-decoder and vision paths (whisper, phi-3-vision)
# ----------------------------------------------------------------------
WHISPER_ARCH, VISION_ARCH = "whisper-large-v3", "phi-3-vision-4.2b"
#: whisper: 4 clips of frames and 16-token decoder prompts (the reference
#: CLI's prompt length), 16 greedy steps, caches of 64 rows
WHISPER_B, ENCDEC_PROMPT, ENCDEC_STEPS, WHISPER_MAX_LEN = 4, 16, 16, 64
#: phi-3-vision with patches: 2 images and 16 text tokens each; its
#: caches hold the 576 patches, the text and 16 new tokens, rounded up
VISION_B, VISION_MAX_LEN = 2, 640


def encdec_launches(cfg, quantized):
    """(prefill, decode step) launches.  whisper at prefill: per encoder
    layer one non-causal flash_attention and 6 linears (wq wk wv wo wi
    wo); per decoder layer a causal flash_attention, a cross
    flash_attention and 10 linears (4 self, wk wv of encode_cross_kv, wq
    wo of the cross-attention, wi wo); a step: per layer one
    decode_attention, one cross flash_attention (S 1) and 8 linears.
    phi-3-vision: one flash_attention (prefill) or decode_attention (a
    step) and 7 linears a layer.  One vta_gemm count a quantized linear,
    none on float weights; no other kernel."""
    L, E, q = cfg.n_layers, cfg.encoder_layers, int(quantized)
    none = {k: 0 for k in ("tensor_alu", "tensor_alu_scatter", "lut_gemm",
                           "gla_chunk")}
    if E:
        return (dict(none, flash_attention=E + 2 * L, decode_attention=0,
                     vta_gemm=q * (6 * E + 10 * L)),
                dict(none, flash_attention=L, decode_attention=L,
                     vta_gemm=q * 8 * L))
    return (dict(none, flash_attention=L, decode_attention=0,
                 vta_gemm=q * 7 * L),
            dict(none, flash_attention=0, decode_attention=L,
                 vta_gemm=q * 7 * L))


def encdec_batch(cfg, B, text=ENCDEC_PROMPT):
    """B prompts of `text` tokens and the model's stub inputs, drawn from
    torch.Generator seed 13 on the card: whisper's frames (B, 1500, d)
    and phi-3-vision's patch embeddings (B, 576, d), N(0, 1) in the
    model's dtype."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(13)
    dt = getattr(torch, cfg.dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, text),
                                     generator=g, device=DEVICE)}
    for key, on, rows in (("frames", cfg.encoder_layers, cfg.encoder_seq),
                          ("patch_emb", cfg.frontend == "vision_stub",
                           cfg.n_patches)):
        if on:
            batch[key] = torch.randn((B, rows, cfg.d_model), generator=g,
                                     device=DEVICE).to(dt)
    return batch


class EncDecDrive:
    """One prefill of a batch through T.prefill, then ENCDEC_STEPS greedy
    T.decode_step calls at one position (the reference's entry points),
    on caches of `cache_dtype` and `max_len` rows.  Keeps every call's
    logits on the card, its host ms (each ends in a host read of the
    chosen tokens) and its launches; with `forced`, takes those tokens in
    place of its own choice (a teacher-forced replay)."""

    def __init__(self, cfg, params, batch, cache_dtype, max_len, counters,
                 forced=None):
        import torch
        from repro_torch.models import transformer as T
        self.logits, self.chosen = [], []
        self.prefill_ms, self.step_ms = [], []
        self.prefill_launches, self.step_launches = [], []
        self.cfg, self.params, self.counters = cfg, params, counters
        self.forced = forced
        self.pos = batch["tokens"].shape[1] + (
            batch["patch_emb"].shape[1] if "patch_emb" in batch else 0)
        with torch.inference_mode():
            self.caches = T.init_caches(cfg, batch["tokens"].shape[0],
                                        max_len, cache_dtype, DEVICE)
            self.tok = self._timed(lambda: T.prefill(
                params, cfg, batch, self.caches)[0], self.prefill_ms,
                self.prefill_launches)
            for _ in range(ENCDEC_STEPS):
                self.step()

    def step(self):
        """One greedy decode step of every row at the next position."""
        import torch
        from repro_torch.models import transformer as T

        def call():
            token = torch.tensor(self.tok, device=DEVICE)[:, None]
            return T.decode_step(self.params, self.cfg, self.caches, token,
                                 self.pos)[0]
        with torch.inference_mode():
            self.tok = self._timed(call, self.step_ms, self.step_launches)
        self.pos += 1

    def _timed(self, fn, ms, launches):
        import torch
        ops = self.counters.ops
        before = {k: op.launches for k, op in ops.items()}
        t0 = time.perf_counter()
        logits = fn()[:, -1]
        self.logits.append(logits.float().clone())
        own = torch.argmax(logits, dim=-1).tolist()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: op.launches - before[k] for k, op in ops.items()})
        self.chosen.append(own)
        return own if self.forced is None \
            else self.forced[len(self.chosen) - 1]


def step_bytes(cfg, tree, caches, kv_len):
    """The bytes one decode step must read: the decoder's weights (every
    layer, the final norm and the head; not the embedding table, of which
    it gathers B rows, nor the cross-attention's wk and wv, which only
    prefill uses), each self-attention cache up to kv_len rows and
    whisper's cross_kv whole."""
    layers = tree["layers"]["attn"]
    skip = [layers["cross"][w] for w in ("wk", "wv")] if "cross" in layers \
        else []
    total = tree_bytes(tree, skip=("embed", "encoder")) \
        - sum(tree_bytes(w) for w in skip)
    for name, c in caches["layers"]["attn"].items():
        for t in c.values():
            rows = t.shape[2] if name == "cross_kv" else kv_len
            total += t[:, :, :rows].numel() * t.element_size()
    return total


def encdec_profile(cfg, tree, cache_dtype, max_len, batch_rows, counters):
    """One decode step (after a prefill and its first steps) profiled
    (step_profile) beside its byte bound (step_bytes at 3.35 TB/s)."""
    drive = EncDecDrive(cfg, tree, encdec_batch(cfg, batch_rows),
                        cache_dtype, max_len, counters)
    prof = step_profile(drive.step, f"{cfg.name} decode step ({batch_rows} "
                        f"rows, int8)")
    prof["kv_len"] = drive.pos
    prof["step_bytes"] = step_bytes(cfg, tree, drive.caches, drive.pos)
    prof["bound_ms"] = prof["step_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"    the step reads {prof['step_bytes'] / 1e9:.3f} GB: byte bound "
        f"{prof['bound_ms']:.3f} ms; device busy "
        f"{prof['device_busy_ms']:.3f} ms")
    return prof


def encoder_ms(cfg, tree, batch, reps=3):
    """whisper's encoder alone (T._encode over the batch's frames): the
    median of `reps` host-timed calls, each synchronized."""
    import torch
    from repro_torch.models import transformer as T
    times = []
    with torch.inference_mode():
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T._encode(tree, cfg, batch["frames"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def encdec_run(cfg, what, tree, batch_rows, cache_dtype, max_len, counters,
               quantized):
    """Prefill and ENCDEC_STEPS greedy steps (EncDecDrive) with the counts
    set to 0 just before and read just after, every prefill and step held
    to encdec_launches; replayed with PlainOps teacher-forced on the
    run's tokens (no kernel may launch) and again with the other attention
    oracles (the model's own rounding floor); the logits within
    LM_LOGIT_TOL of the plain replay's max|logit| where the model is
    float32, else within twice the floor where that is larger; then run
    again with every launch held to its plain version (CheckedOps)."""
    import torch
    batch = lambda: encdec_batch(cfg, batch_rows)  # noqa: E731
    counters.reset()
    t0 = time.perf_counter()
    run = EncDecDrive(cfg, tree, batch(), cache_dtype, max_len, counters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.read()
    run.caches = None
    check_launches(what, run.prefill_launches, run.step_launches,
                   encdec_launches(cfg, quantized))
    flash_by_dtype = {}
    for key, n in counters.ops["flash_attention"].shapes.items():
        flash_by_dtype[key[-1]] = flash_by_dtype.get(key[-1], 0) + n
    calls, device = gemm_launches(what, counters, launches)
    enc_ms = encoder_ms(cfg, tree, batch()) if cfg.encoder_layers else None

    def replay(**kind):
        return plain_replay(what, counters, lambda: EncDecDrive(
            cfg, tree, batch(), cache_dtype, max_len, counters,
            forced=run.chosen), **kind)
    plain = replay()
    floor_gap, _ = compare_logits(
        replay(**FLOOR_REPLAYS["attention_oracles"][1]), plain, what,
        limit=None)
    limit = LM_LOGIT_TOL if cfg.dtype == "float32" \
        else max(LM_LOGIT_TOL, 2 * floor_gap)
    worst, agree = compare_logits(run, plain, what, limit=limit)
    del plain
    with CheckedOps() as chk:
        EncDecDrive(cfg, tree, batch(), cache_dtype, max_len, counters)
    for k in ("flash_attention", "decode_attention") + (
            ("quantized_linear",) if quantized else ()):
        if not chk.calls.get(k):
            fail(f"{what}: no {k} launch checked")
    rows = batch_rows * (ENCDEC_STEPS + 1)
    st = sorted(run.step_ms)
    summary = dict(
        rows=batch_rows, cache_dtype=str(cache_dtype).split(".")[-1],
        max_len=max_len, launches=launches, flash_by_dtype=flash_by_dtype,
        launches_per_prefill=run.prefill_launches[0],
        launches_per_step=run.step_launches[0],
        quantized_linear_calls=calls,
        vta_gemm_device_launches=device, wall_s=wall,
        tokens=rows, tokens_per_s=rows / wall,
        prefill_ms=run.prefill_ms[0], encoder_ms=enc_ms,
        step_ms=run.step_ms, step_ms_median=statistics.median(st),
        step_ms_p90=st[int(0.9 * (len(st) - 1))],
        logit_max_rel_err=worst, logit_limit=limit,
        logit_floor=floor_gap, argmax_agreement=agree,
        launch_checks=dict(worst=chk.worst, launches=chk.calls),
        tokens_head=[c[:4] for c in run.chosen[:8]])
    log(f"  {what}: {rows} tokens in {wall:.2f} s "
        f"({summary['tokens_per_s']:.1f} tokens/s); prefill "
        f"{summary['prefill_ms']:.2f} ms"
        + ("" if enc_ms is None else f" (the encoder alone {enc_ms:.2f} ms)")
        + f"; decode step median {summary['step_ms_median']:.2f} ms, p90 "
        f"{summary['step_ms_p90']:.2f} ms over {len(st)} steps")
    log("    launches per prefill: " + ", ".join(
        f"{k} {v}" for k, v in summary["launches_per_prefill"].items() if v)
        + "; per decode step: " + ", ".join(
        f"{k} {v}" for k, v in summary["launches_per_step"].items() if v)
        + f"; {summary['quantized_linear_calls']} quantized_linear calls, "
        f"{device} vta_gemm device launches; flash by dtype "
        f"{flash_by_dtype}")
    log(f"    against the plain run (teacher-forced): logits within "
        f"{worst:.3e} of max|logit| (limit {limit:.3e}); argmax agreement "
        f"{agree:.4f}; the two plain runs "
        f"({FLOOR_REPLAYS['attention_oracles'][0]}) differ by "
        f"{floor_gap:.3e}")
    log(f"    every launch against its plain version on the same inputs: "
        + ", ".join(f"{k} x{chk.calls[k]} within {v:.2e} of max|plain|"
                    for k, v in sorted(chk.worst.items())))
    return summary


def encdec_model(out, arch, dtype, runs, counters, quantized=True):
    """Build `arch` at its published widths and full depth (lm_weights,
    in `dtype` where given), record the build and mem_get_info, and run
    each (name, int8?, cache dtype, rows, max_len) of `runs`
    (encdec_run); returns the config and the weight trees."""
    import torch
    free_device_memory()
    before = mem_gb()
    cfg, params, qparams, init_s = lm_weights(arch, dtype, quantized)
    trees = dict(float=params.tree(),
                 int8=qparams.tree() if quantized else None)
    build = dict(arch=arch, dtype=cfg.dtype, n_layers=cfg.n_layers,
                 encoder_layers=cfg.encoder_layers, seconds=init_s,
                 weight_gb=tree_bytes(trees["float"]) / 1e9,
                 int8_weight_gb=None if not quantized
                 else tree_bytes(trees["int8"]) / 1e9,
                 mem_free_total_gb_before=before,
                 mem_free_total_gb_after=mem_gb())
    out["builds"].append(build)
    log(f"  {arch}, {cfg.n_layers} layers"
        + (f" and {cfg.encoder_layers} encoder layers"
           if cfg.encoder_layers else "")
        + f", d {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, "
        f"{cfg.dtype}: {build['weight_gb']:.3f} GB of weights"
        + ("" if not quantized else
           f" ({build['int8_weight_gb']:.3f} GB under int8 PTQ)")
        + f", built in {init_s:.1f} s; mem_get_info free / total "
        f"{before[0]:.3f} / {before[1]:.3f} GB before, "
        f"{build['mem_free_total_gb_after'][0]:.3f} GB free after")
    for name, q, cache_dtype, rows, max_len in runs:
        out[f"{arch} {name}"] = encdec_run(
            cfg, f"{arch} {name}", trees["int8" if q else "float"], rows,
            getattr(torch, cache_dtype), max_len, counters, q)
    return cfg, trees


def encdec_whisper(out, counters):
    """whisper-large-v3 at full width and depth: int8 PTQ over float32
    caches (the mixed-dtype cross route), bf16 over bf16 caches, then a
    float32 model; a profiled int8 step; ServeEngine refuses it."""
    import torch
    from repro_torch.launch.serve import ServeEngine
    cfg, trees = encdec_model(out, WHISPER_ARCH, None, [
        ("int8", True, "float32", WHISPER_B, WHISPER_MAX_LEN),
        ("bf16", False, "bfloat16", WHISPER_B, WHISPER_MAX_LEN)], counters)
    out[f"{WHISPER_ARCH} profile"] = encdec_profile(
        cfg, trees["int8"], torch.float32, WHISPER_MAX_LEN,
        WHISPER_B, counters)
    try:
        ServeEngine(cfg, trees["float"], torch_device=DEVICE)
    except ValueError as e:
        out["whisper_serve_engine_refusal"] = str(e)
        log(f"  ServeEngine({WHISPER_ARCH}) refuses it: {e}")
    else:
        fail("ServeEngine took an encoder-decoder, whose requests carry no "
             "frames")
    del trees
    encdec_model(out, WHISPER_ARCH, "float32", [
        ("f32", False, "float32", WHISPER_B, WHISPER_MAX_LEN)], counters,
        quantized=False)


def encdec_vision(out, counters):
    """phi-3-vision-4.2b at full width and depth: 2 images of patches and
    16 text tokens each through T.prefill and 16 greedy steps, int8 PTQ
    over float32 caches and bf16 over bf16 caches, and a profiled int8
    step; the reference CLI's traffic (tokens alone) through ServeEngine
    on int8, held as phase 8's runs are; then a float32 model."""
    import torch
    from repro_torch.launch.serve import make_requests
    cfg, trees = encdec_model(out, VISION_ARCH, None, [
        ("int8 patches", True, "float32", VISION_B, VISION_MAX_LEN),
        ("bf16 patches", False, "bfloat16", VISION_B, VISION_MAX_LEN)],
        counters)
    out[f"{VISION_ARCH} profile"] = encdec_profile(
        cfg, trees["int8"], torch.float32, VISION_MAX_LEN, VISION_B,
        counters)
    what = f"{VISION_ARCH} int8 CLI traffic"
    requests = lambda: make_requests(cfg, LM_REQUESTS, LM_MAX_NEW)  # noqa
    summary = serve_run(cfg, what, trees["int8"], requests, counters,
                        floor="attention_oracles")
    check_launches(what, summary["prefill_launches"],
                   summary["step_launches"], encdec_launches(cfg, True))
    summary["launch_checks"] = checked_run(cfg, "int8 CLI traffic",
                                           trees["int8"], requests,
                                           counters, True)
    out[what] = summary
    del trees
    encdec_model(out, VISION_ARCH, "float32", [
        ("f32 patches", False, "float32", VISION_B, VISION_MAX_LEN)],
        counters, quantized=False)


def phase_encdec(rec, counters):
    """whisper-large-v3 (32 encoder and 32 decoder layers, d 1280, 20
    heads of 64, 1500 frames, layernorm, learned positions, gelu) and
    phi-3-vision-4.2b (32 layers, d 3072, 32 heads of 96, 576 patches,
    rmsnorm, rope, swiglu) at their published widths and full depth, seed
    0 weights: encdec_whisper, then encdec_vision.  Each model is freed
    before the next is built."""
    import torch
    t_phase = time.perf_counter()
    out = {"builds": []}
    encdec_whisper(out, counters)
    encdec_vision(out, counters)
    free_device_memory()
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  phase 13 took {out['seconds']:.1f} s")
    rec["encdec"] = dict(whisper_rows=WHISPER_B, vision_rows=VISION_B,
                         prompt=ENCDEC_PROMPT, steps=ENCDEC_STEPS,
                         whisper_max_len=WHISPER_MAX_LEN,
                         vision_max_len=VISION_MAX_LEN, **out)
    return out




# ----------------------------------------------------------------------
# phase 14: training (the seventh main path) and the flash backward kernel
# ----------------------------------------------------------------------
TRAIN_ARCH = "llama3.2-3b"
#: the reference's train_4k shape (S 4096, src/repro/configs/base.py), its
#: global batch of 256 cut to 2 sequences for one card; 4 timed steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 4
#: the float32 replay and the checkpoint round trip: full width, 2 layers
TRAIN_SMALL_LAYERS, TRAIN_SMALL_SEQ = 2, 512
#: the recurrent models trained at full width and depth (the same train_4k
#: shape and batch cut as Llama's): the steps run (the first pays the
#: warm-up), the layers of the float32 replay and the checkpoint round trip
#: (one repeating unit: 5 Mamba2 and the shared block's first application;
#: 7 mLSTM and 1 sLSTM), and the kernel launches of each step (the scans
#: and zamba2's shared attention twice a layer, the forward and its
#: recompute under remat; the backwards once)
RECURRENT_TRAIN = {
    "zamba2-1.2b": dict(steps=4, seq=TRAIN_SEQ, small_layers=6,
                        launches=dict(gla_fwd=76, gla_bwd=38, flash_fwd=12,
                                      flash_bwd=6)),
    # its sLSTM loops take 67-102 s a step at S 4096 (PERF.md): S cut to
    # 2048, a multiple of the mLSTM's chunk 512, and the depth to 3 of its
    # 6 repeating units (21 mLSTM, 3 sLSTM; 41-54 s a step at 48 layers
    # kept the script too near its time limit); the second step is timed
    # clean, the third times the loops (slstm_share_step)
    "xlstm-1.3b": dict(steps=3, seq=2048, small_layers=8, layers=24,
                       launches=dict(gla_fwd=42, gla_bwd=21, flash_fwd=0,
                                     flash_bwd=0)),
}
#: (B, S, Sk, HQ, KH, D, causal, dtype) the backward kernel is held to its
#: plain version at (and timed), besides any other shape training launched
FLASH_BWD_CASES = [
    (2, 4096, 4096, 24, 8, 128, True, "bfloat16"),    # llama3.2-3b train_4k
    (4, 1500, 1500, 20, 20, 64, False, "bfloat16"),   # whisper's encoder
    (4, 1500, 1500, 20, 20, 64, False, "float32"),
    (2, 592, 592, 32, 32, 96, True, "bfloat16"),      # phi-3-vision
    (1, 16, 8192, 4, 4, 64, False, "float32"),        # long keys
    # head dims zero-padded (D 72 in bf16) and on the wide kernel
    (1, 1024, 1024, 8, 2, 72, True, "bfloat16"),
    (1, 1024, 1024, 4, 4, 256, True, "bfloat16"),
    (1, 1024, 1024, 4, 4, 160, False, "float32"),
    # head dims above 256: the wide kernel in slices of 256 columns
    (1, 1024, 1024, 4, 4, 320, True, "bfloat16"),
    (1, 1024, 1024, 4, 4, 320, False, "float32"),
    (1, 512, 512, 4, 2, 512, True, "bfloat16"),
    (1, 512, 512, 4, 2, 512, False, "float32"),
]
#: the shape whose keys are v = 1 + N(0, 1): a one-signed error from sums
#: chained on the tensor cores would grow with the keys
FLASH_BWD_LONG = (1, 16, 8192, 4, 4, 64, False, "float32")


def _row_norms(x):
    """The 2-norm of each length-D row of x, in float64."""
    return x.double().reshape(-1, x.shape[-1]).norm(dim=-1)


def flash_bwd_errors(got, q, k, v, o, do, causal):
    """The backward kernel's (dq, dk, dv) against the plain backward on
    the same inputs.  bfloat16, row by row (a query row of dq, a key row
    of dk and dv): against the plain backward in float64 (on the inputs
    upcast, so unrounded), each row's error at most 4x that row's error of
    a floor, the plain backward that rounds P and dS once to bf16 where
    they enter a product and its result once to bf16, as the kernel does,
    plus 2^-10 of the median norm of the rows that are not zero (rows that
    see no key are); rows are compared with their own
    norms because the gradients of long causal rows and keys are an order
    smaller than those of the first ones, and a limit taken from the
    largest value would let a late row be wrong by tens of percent.
    float32: against the plain backward in float64, the error at most 4x
    the float32 plain backward's, or 1e-6 of max|want| where that is
    larger.  Returns a list of dicts (name, err, limit, ok, and the
    median and max |want|) and the largest error against the float32
    plain backward (the kernels line's max_abs_err)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_bwd_ref
    group = q.shape[2] // k.shape[2]
    want = attention_bwd_ref(q, k, v, o, do, group=group, causal=causal)
    names = ("dq", "dk", "dv")
    worst = max(float((a.float() - w.float()).abs().max())
                for a, w in zip(got, want))
    out = []
    if q.dtype == torch.float32:
        want64 = attention_bwd_ref(q, k, v, o, do, group=group,
                                   causal=causal, dtype=torch.float64)
        for name, a, w, w64 in zip(names, got, want, want64):
            w64 = w64.double()
            e64 = float((a.double() - w64).abs().max())
            base = float((w.double() - w64).abs().max())
            mx = float(w64.abs().max())
            limit = max(4 * base, 1e-6 * mx)
            out.append(dict(name=name, err=e64, limit=limit,
                            ok=e64 <= limit, median_want=float(
                                w64.abs().median()), max_want=mx,
                            rule="max abs against float64"))
        return out, worst
    del want
    oracle = attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                               group=group, causal=causal,
                               dtype=torch.float64)
    floor = attention_bwd_ref(q, k, v, o, do, group=group, causal=causal,
                              dtype=torch.float64, operands=torch.bfloat16)
    for name, a, w64, f in zip(names, got, oracle, floor):
        norms = _row_norms(w64)
        norms = norms[norms > 0] if bool((norms > 0).any()) else norms
        atol = 2.0 ** -10 * float(norms.median())
        e_k, e_f = _row_norms(a.double() - w64), _row_norms(f.double() - w64)
        lim = 4 * e_f + atol
        r = int(torch.argmax(e_k / lim))
        out.append(dict(name=name, err=float(e_k[r]), limit=float(lim[r]),
                        ok=bool((e_k <= lim).all()),
                        median_want=float(w64.abs().median()),
                        max_want=float(w64.abs().max()),
                        median_row_norm=float(norms.median()),
                        row_norm=float(_row_norms(w64)[r]), row=r,
                        max_abs_err=float((a.double() - w64).abs().max()),
                        rule="row norm against 4x a bf16-operand floor"))
    del oracle, floor
    return out, worst


def flash_bwd_check_line(checks):
    """One log line's text for flash_bwd_errors' checks."""
    return ", ".join(
        f"{c['name']} {c['err']:.3e} (limit {c['limit']:.3e}"
        + (f" at row {c['row']} of norm {c['row_norm']:.3e}, median row "
           f"norm {c['median_row_norm']:.3e}, max abs err "
           f"{c['max_abs_err']:.3e}" if "row" in c else "")
        + f"; median|want| {c['median_want']:.3e}, max|want| "
        f"{c['max_want']:.3e})" for c in checks)


def flash_bwd_bound_ms(B, S, Sk, HQ, KH, D, causal, elt):
    """The larger of the operations (5 products of S x Sk x D a head, 2
    flops a multiply-add, halved when causal) at the bf16 dense
    tensor-core peak and the bytes (q, o, do, k, v read once; dq, dk, dv
    written once) at the memory rate."""
    ops = 2 * 5 * B * HQ * S * Sk * D / (2 if causal else 1)
    nbytes = elt * (4 * B * S * HQ * D + 4 * B * Sk * KH * D)
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sdpa_bwd_call(q, k, v, do, causal):
    """A closure making the backward alone of one
    scaled_dot_product_attention call (torch.autograd.grad of a forward
    whose graph is kept, so the forward's time is not in it), flash and
    memory-efficient backends only, GQA through enable_gqa; or None where
    PyTorch refuses the inputs.  The port never calls this."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dos = do.transpose(1, 2)
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal,
                                                 enable_gqa=True)
        torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
    except RuntimeError as e:          # a layout or size it refuses
        log(f"  scaled_dot_product_attention backward refused: "
            f"{str(e)[:200]}")
        return None
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                       retain_graph=True)


def flash_bwd_inputs(B, S, Sk, HQ, KH, D, causal, dt):
    """Seed-made q, k, v, do (unit normal; v = 1 + N(0, 1) at
    FLASH_BWD_LONG), the forward kernel's o and its log-sum-exp L (None
    from a version of the port whose forward writes none)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(S + Sk + HQ + D)
    dtype = getattr(torch, dt)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q, k, v, do = t(B, S, HQ, D), t(B, Sk, KH, D), t(B, Sk, KH, D), \
        t(B, S, HQ, D)
    if (B, S, Sk, HQ, KH, D, causal, dt) == FLASH_BWD_LONG:
        v = v + 1.0
    with torch.no_grad():
        if hasattr(fa, "flash_attention_fwd"):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        else:
            o, lse = fa.flash_attention(q, k, v, causal=causal), None
    return q, k, v, o, do, lse


def phase_flash_bwd_kernel(rec, train_shapes):
    """The backward kernel, from the forward kernel's L, against the plain
    backward (flash_bwd_errors), bitwise equal over two calls, at
    FLASH_BWD_CASES and every other shape the training run launched;
    timed at each: kernel ms (torch.profiler, the three kernels of a
    call), call ms (CUDA events), the plain backward's ms, the bound, and
    SDPA's backward alone."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)
    cases = list(FLASH_BWD_CASES) + [sh for sh in train_shapes
                                     if sh not in FLASH_BWD_CASES]
    rows, max_err = [], {"bfloat16": 0.0, "float32": 0.0}
    for B, S, Sk, HQ, KH, D, causal, dt in cases:
        shape = (B, S, Sk, HQ, KH, D, causal, dt)
        q, k, v, o, do, lse = flash_bwd_inputs(*shape)
        got = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
        again = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"the flash backward kernel at {shape} is not "
                 f"reproducible")
        checks, err = flash_bwd_errors(got, q, k, v, o, do, causal)
        max_err[dt] = max(max_err[dt], err)
        bad = [c for c in checks if not c["ok"]]
        log(f"  flash backward {shape}: {flash_bwd_check_line(checks)}")
        if bad:
            fail(f"the flash backward kernel at {shape} differs from the "
                 f"plain backward: {bad}")
        del got, again
        big = S * Sk >= 4096 * 4096
        call = lambda: flash_attention_bwd(q, k, v, o, do,  # noqa
                                           causal=causal, lse=lse)
        call_ms = cuda_time_ms(call, reps=5 if big else 20, warmup=1)
        ms = kernel_ms(call, FLASH_WIDE_BWD_NAME if D > FLASH_MAX_D
                       else "flash_bwd", call_ms, reps=5 if big else 20)
        group = HQ // KH
        plain = cuda_time_ms(lambda: attention_bwd_ref(
            q, k, v, o, do, group=group, causal=causal), reps=2, warmup=1)
        lib_call = sdpa_bwd_call(q, k, v, do, causal) \
            if causal is False or S == Sk else None
        lib = cuda_time_ms(lib_call, reps=5 if big else 20, warmup=1) \
            if lib_call is not None else None
        bound, by = flash_bwd_bound_ms(B, S, Sk, HQ, KH, D, causal,
                                       q.element_size())
        row = dict(B=B, S=S, Sk=Sk, HQ=HQ, KH=KH, D=D, causal=causal,
                   dtype=dt, launches=train_shapes.get(shape, 0), ms=ms,
                   call_ms=call_ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, max_abs_err=checks,
                   err_vs_plain=err)
        rows.append(row)
        log(f"  flash backward B={B} S={S} Sk={Sk} HQ={HQ} KH={KH} D={D} "
            f"{'causal' if causal else 'full'} {dt}: kernel {ms:.4f} ms, "
            f"call {call_ms:.4f} ms (bound {bound:.5f} ms by {by}; plain "
            f"{plain:.4f} ms; sdpa backward "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'})"
            + (f" x{row['launches']}" if row["launches"] else ""))
        del q, k, v, o, do, lse, lib_call
        torch.cuda.empty_cache()
    rec["flash_bwd_shapes"] = rows
    return rows, max_err


def train_llama(out, counters):
    """llama3.2-3b at its published width and depth (28 layers, bf16
    parameters, AdamW, remat) trains TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens through Trainer, with every kernel's count set to 0
    just before; then a fifth step under torch.profiler for the device
    idle share.  Each step launches the flash forward kernel twice a layer
    (the forward and its recompute under remat) and the backward once;
    the first step's backward launches of layers 27 and 0 are held to the
    plain backward."""
    import math
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.train import Trainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spec = get_arch(TRAIN_ARCH)
    cfg = spec.model.replace(max_seq=max(spec.model.max_seq, TRAIN_SEQ))
    L = cfg.n_layers
    t0 = time.perf_counter()
    tr = Trainer(cfg, optimizer=spec.optimizer, seq_len=TRAIN_SEQ,
                 global_batch=TRAIN_BATCH, seed=0, torch_device=DEVICE)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["state_gb"] = torch.cuda.memory_allocated() / 1e9
    log(f"  {TRAIN_ARCH}: {L} layers, d {cfg.d_model}, {cfg.dtype} "
        f"parameters and AdamW state ({out['state_gb']:.2f} GB) built in "
        f"{out['build_s']:.1f} s; batch cut from 256 to {TRAIN_BATCH} "
        f"sequences of {TRAIN_SEQ}")
    captured, real_bwd = [], fops.flash_attention_bwd

    def capture(q, k, v, o, do, *, causal=True, lse=None):
        grads = real_bwd(q, k, v, o, do, causal=causal, lse=lse)
        n = len(captured)
        if n in (0, L - 1):       # the backward runs from the last layer
            captured.append(dict(layer=L - 1 - n, causal=causal,
                                 inputs=[t.detach().clone()
                                         for t in (q, k, v, o, do)],
                                 grads=[g.clone() for g in grads]))
        else:
            captured.append(None)
        return grads

    counters.reset()
    flash_attention.bwd_launches = 0
    flash_attention.bwd_shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        before = (flash_attention.launches, flash_attention.bwd_launches)
        fops.flash_attention_bwd = capture if i == 0 else real_bwd
        try:
            hist = tr.train(1, log_every=1)
        finally:
            fops.flash_attention_bwd = real_bwd
        fwd = flash_attention.launches - before[0]
        bwd = flash_attention.bwd_launches - before[1]
        steps.append(dict(loss=hist["loss"][0], ms=hist["seconds"][0] * 1e3,
                          flash_fwd=fwd, flash_bwd=bwd))
        log(f"  step {i + 1}: loss {hist['loss'][0]:.4f}, "
            f"{steps[-1]['ms']:.1f} ms, flash launches: {fwd} forward, "
            f"{bwd} backward")
        if (fwd, bwd) != (2 * L, L):
            fail(f"training step {i + 1} launched the flash kernels {fwd} "
                 f"(forward) and {bwd} (backward) times, not {2 * L} and "
                 f"{L}")
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = counters.read()
    out["bwd_launches"] = flash_attention.bwd_launches
    out["bwd_shapes"] = dict(flash_attention.bwd_shapes)
    if not all(math.isfinite(s["loss"]) for s in steps):
        fail(f"training losses are not finite: {[s['loss'] for s in steps]}")
    # the captured backward launches against the plain backward
    checked = []
    for c in (c for c in captured if c is not None):
        q, k, v, o, do = c["inputs"]
        checks, err = flash_bwd_errors(c["grads"], q, k, v, o, do,
                                       c["causal"])
        checked.append(dict(layer=c["layer"], checks=checks))
        log(f"  step 1 backward launch of layer {c['layer']}: "
            f"{flash_bwd_check_line(checks)}")
        if not all(ck["ok"] for ck in checks):
            fail(f"the flash backward launch of layer {c['layer']} differs "
                 f"from the plain backward: {checks}")
    del captured
    med = statistics.median(s["ms"] for s in steps[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # a fifth step under the profiler: device busy over the step's wall
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_loss = tr.train(1, log_every=10 ** 9)["loss"][0]
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA) / 1e3
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if t > 0 and e.device_type == DeviceType.CUDA:
            kernels[e.key] = t / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out.update(steps=steps, step_ms_median=med,
               tokens_per_s=tokens / (med / 1e3), checked_launches=checked,
               profiled_step=dict(loss=prof_loss, wall_ms=wall_ms,
                                  device_busy_ms=busy_ms,
                                  idle_share=1 - busy_ms / wall_ms,
                                  top_device_ms=top),
               batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
               reduced=["global batch 256 -> 2 sequences (one card)"])
    log(f"  {TRAIN_ARCH} training: step {med:.1f} ms (median of steps "
        f"2-{TRAIN_STEPS}), {tokens / (med / 1e3):.0f} tokens/s, peak "
        f"allocated {out['peak_allocated_gb']:.2f} GB; profiled step "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    for k, t in top[:5]:
        log(f"    {k[:90]}: {t:.2f} ms")
    del tr
    free_device_memory()


def profiled_step(tr, out):
    """One more training step under torch.profiler (device activity
    only): its wall ms, the device's busy ms (the union of the kernels'
    and copies' intervals, so that nothing is counted twice) and idle
    share, and the eight kernels with the most device time.  The events
    are read from the profiler's raw results: xlstm's step has millions of
    them, too many for its Python event tree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = tr.train(1, log_every=10 ** 9)["loss"][0]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            a, b = e.start_ns(), e.end_ns()
            spans.append((a, b))
            kernels[e.name()] = kernels.get(e.name(), 0) + (b - a) / 1e6
    spans.sort()
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy_ns / 1e6
    out["profiled_step"] = dict(loss=loss, wall_ms=wall_ms,
                                device_busy_ms=busy_ms,
                                idle_share=1 - busy_ms / wall_ms,
                                device_operations=len(spans),
                                top_device_ms=top)
    log(f"  profiled step {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}, {len(spans)} device "
        f"operations")
    for k, t in top[:5]:
        log(f"    {k[:90]}: {t:.2f} ms")


def slstm_share_step(tr, out):
    """One more xlstm training step with the sLSTM layers timed on the
    host clock, the card synchronized at each edge: their train form's
    calls (the forward and its recompute under remat) and their backward
    (from the gradient reaching a layer's output to its input, marked by
    identity autograd functions).  Records the loop's seconds and its
    share of that step's wall time."""
    import torch
    import repro_torch.models.xlstm as xm
    real = xm.slstm_train
    fwd, marks = [], []

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, tag):
            ctx.tag = tag
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            torch.cuda.synchronize()
            marks.append((ctx.tag, time.perf_counter()))
            return g, None

    def timed(p, cfg, x):
        # the recompute under remat may stop once the block's last saved
        # tensor is recomputed (non-reentrant checkpoint's early stop):
        # its time is taken all the same
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return Mark.apply(real(p, cfg, Mark.apply(x, "in")), "out")
        finally:
            torch.cuda.synchronize()
            fwd.append((t0, time.perf_counter()))
    xm.slstm_train = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.train(1, log_every=10 ** 9)
        wall = time.perf_counter() - t0
    finally:
        xm.slstm_train = real
    starts = [t for tag, t in marks if tag == "out"]
    ends = [t for tag, t in marks if tag == "in"]
    bwd = list(zip(starts, ends))
    if len(starts) != len(ends) or any(b < a for a, b in bwd):
        fail(f"the sLSTM backward marks do not pair up: {marks}")
    # a layer's recompute runs inside its backward span: the union
    loop, end = 0.0, None
    for a, b in sorted(fwd + bwd):
        if end is None or a > end:
            loop += b - a
            end = b
        elif b > end:
            loop += b - end
            end = b
    out["slstm"] = dict(step_s=wall, forward_calls=len(fwd),
                        forward_s=sum(b - a for a, b in fwd),
                        backward_s=sum(b - a for a, b in bwd),
                        loop_s=loop, share=loop / wall)
    log(f"  sLSTM loops: {len(fwd)} forward calls (the forward and the "
        f"recompute) {out['slstm']['forward_s']:.2f} s, {len(bwd)} "
        f"backwards {out['slstm']['backward_s']:.2f} s (the recompute "
        f"inside them): {loop:.2f} s of the {wall:.2f} s step, share "
        f"{loop / wall:.4f}")
    return hist


def train_recurrent(out, counters, arch):
    """`arch` (RECURRENT_TRAIN) at its published width and depth, or the
    depth its ``layers`` cuts it to (bf16
    parameters, AdamW, remat) trains its steps of TRAIN_BATCH x its seq
    tokens through Trainer, with every kernel's count set to 0 just
    before: per-step loss and ms, tokens/s, the peak allocated memory, the
    gla_chunk and flash launches of each step (asserted), the first step's
    gla backward launches of the last and the first scan layer held to
    the plain backward (gla_bwd_errors, on the kernel's float32 result);
    xlstm's last step times its sLSTM loops (slstm_share_step) and is
    left out of the median step ms; then one profiled step
    (profiled_step)."""
    import math
    import torch
    import repro_torch.kernels.gla_chunk.ops as gops
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gla_chunk import gla_chunk
    from repro_torch.kernels.gla_chunk.kernel import gla_chunk_bwd_cuda
    from repro_torch.launch.train import Trainer
    from repro_torch.tree import leaves
    conf = RECURRENT_TRAIN[arch]
    S = conf["seq"]
    spec = get_arch(arch)
    cfg = spec.model.replace(max_seq=max(spec.model.max_seq, S),
                             n_layers=conf.get("layers",
                                               spec.model.n_layers))
    t0 = time.perf_counter()
    tr = Trainer(cfg, optimizer=spec.optimizer, seq_len=S,
                 global_batch=TRAIN_BATCH, seed=0, torch_device=DEVICE)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["state_gb"] = torch.cuda.memory_allocated() / 1e9
    pattern = cfg.block_pattern()
    out["blocks"] = {b: pattern.count(b) for b in sorted(set(pattern))}
    out["parameters"] = sum(t.numel() for t in leaves(tr.params))
    log(f"  {arch}: {cfg.n_layers} layers {out['blocks']}, d "
        f"{cfg.d_model}, {out['parameters'] / 1e9:.3f} B {cfg.dtype} "
        f"parameters and AdamW state ({out['state_gb']:.2f} GB) built in "
        f"{out['build_s']:.1f} s; batch cut from 256 to {TRAIN_BATCH} "
        f"sequences of {S}")
    n_scan = conf["launches"]["gla_bwd"]
    captured, real_bwd = [], gops.gla_chunk_bwd

    def capture(q, k, v, la, h0, dy, dh, *, chunk=64):
        grads = real_bwd(q, k, v, la, h0, dy, dh, chunk=chunk)
        n = len(captured)
        if n in (0, n_scan - 1):  # the backward runs from the last layer
            captured.append(dict(
                layer=n_scan - 1 - n, chunk=chunk,
                inputs=[None if t is None else t.detach().clone()
                        for t in (q, k, v, la, h0, dy, dh)],
                grads=[g.clone() for g in grads]))
        else:
            captured.append(None)
        return grads

    def counts():
        return dict(gla_fwd=gla_chunk.launches,
                    gla_bwd=gla_chunk.bwd_launches,
                    flash_fwd=flash_attention.launches,
                    flash_bwd=flash_attention.bwd_launches)
    counters.reset()
    for op in (gla_chunk, flash_attention):
        op.bwd_launches = 0
        op.bwd_shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(conf["steps"]):
        before = counts()
        gops.gla_chunk_bwd = capture if i == 0 else real_bwd
        try:
            if i == conf["steps"] - 1 and "slstm" in pattern:
                hist = slstm_share_step(tr, out)
            else:
                hist = tr.train(1, log_every=1)
        finally:
            gops.gla_chunk_bwd = real_bwd
        got = {k: v - before[k] for k, v in counts().items()}
        steps.append(dict(loss=hist["loss"][0],
                          ms=hist["seconds"][0] * 1e3, **got))
        log(f"  step {i + 1}: loss {hist['loss'][0]:.4f}, "
            f"{steps[-1]['ms']:.1f} ms, launches {got}")
        if got != conf["launches"]:
            fail(f"{arch} training step {i + 1} launched {got}, not "
                 f"{conf['launches']}")
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = counters.read()
    out["gla_bwd_launches"] = gla_chunk.bwd_launches
    out["gla_bwd_shapes"] = dict(gla_chunk.bwd_shapes)
    out["flash_bwd_launches"] = flash_attention.bwd_launches
    if not all(math.isfinite(st["loss"]) for st in steps):
        fail(f"{arch} training losses are not finite: "
             f"{[st['loss'] for st in steps]}")
    checked = []
    for c in (c for c in captured if c is not None):
        args = c["inputs"]
        raw = gla_chunk_bwd_cuda(*args)
        if not all(torch.equal(g, r.to(g.dtype))
                   for g, r in zip(c["grads"], raw)):
            fail(f"{arch}: the gla backward launch of scan layer "
                 f"{c['layer']} is not reproduced by the kernel")
        checks, _ = gla_bwd_errors(raw, args, c["chunk"])
        checked.append(dict(layer=c["layer"], checks=checks))
        log(f"  step 1 gla backward launch of scan layer {c['layer']}: "
            f"{gla_bwd_check_line(checks)}")
        if not all(ck["ok"] for ck in checks):
            fail(f"{arch}: the gla backward launch of scan layer "
                 f"{c['layer']} differs from the plain backward: {checks}")
        del raw, args
    del captured
    # the median of the steps after the first, the instrumented one not
    timed = steps[1:len(steps) - ("slstm" in pattern)] or steps
    med = statistics.median(st["ms"] for st in timed)
    tokens = TRAIN_BATCH * S
    out.update(steps=steps, step_ms_median=med,
               tokens_per_s=tokens / (med / 1e3), checked_launches=checked,
               batch=TRAIN_BATCH, seq_len=S,
               reduced=["global batch 256 -> 2 sequences (one card)"] + (
                   [f"sequence length 4096 -> {S} (the sLSTM loops' time)"]
                   if S != TRAIN_SEQ else []))
    log(f"  {arch} training: step {med:.1f} ms (median of steps "
        f"2-{len(timed) + 1}), {tokens / (med / 1e3):.0f} tokens/s, peak "
        f"allocated {out['peak_allocated_gb']:.2f} GB")
    profiled_step(tr, out)
    del tr
    free_device_memory()


def train_f32_replay(out, counters, arch=TRAIN_ARCH,
                     n_layers=TRAIN_SMALL_LAYERS):
    """`arch` at full width and `n_layers` layers in float32: one step's
    loss and every gradient leaf with the kernels, against a replay with
    every op's plain version (PlainOps) on the same weights and batch: the
    loss within 1e-5 relative, each leaf within 1e-4 of its max|grad|.
    Where the model scans, a second plain replay takes the scan by its
    step recurrence (PlainOps(scan="recurrence"): the same function, its
    sums in another order), and the two plain replays' gap is the model's
    own rounding floor, the loss's and each leaf's apart: a limit is then
    twice its own floor where that is larger (the sLSTM's exponential
    gates carry a float32 difference in its input far, to every leaf
    before it).  No kernel may launch in a replay."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels.gla_chunk import gla_chunk
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, requires_grad_
    cfg = get_arch(arch).model.replace(n_layers=n_layers, dtype="float32")
    params = requires_grad_(T.init_params(cfg, 0, DEVICE).tree())
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_SMALL_SEQ,
                                           1, seed=0)).batch(0).items()}

    def grads():
        loss, _ = T.forward_train(params, cfg, batch)
        flat = flatten(params)
        g = torch.autograd.grad(loss, list(flat.values()))
        return float(loss.detach()), dict(zip(flat, g))
    from repro_torch.kernels.flash_attention import flash_attention

    def launched():
        bwd0 = (flash_attention.bwd_launches, gla_chunk.bwd_launches)
        counters.reset()
        loss, g = grads()
        return loss, g, dict(
            counters.read(),
            flash_bwd=flash_attention.bwd_launches - bwd0[0],
            gla_bwd=gla_chunk.bwd_launches - bwd0[1])

    def gaps(ga, gb):
        """Each leaf's max|difference| over gb's max|grad|."""
        return {k: float((ga[k] - gb[k]).abs().max()
                         / gb[k].abs().max().clamp_min(1e-30)) for k in gb}
    loss_k, g_k, kernel = launched()
    with PlainOps():
        loss_p, g_p, plain = launched()
    pattern = cfg.block_pattern()
    attn_used = any("attn" in b for b in pattern)
    scans = any(b in ("mamba2", "mamba2_sharedattn", "mlstm")
                for b in pattern)
    want = [k for k, used in (("flash_attention", attn_used),
                              ("flash_bwd", attn_used),
                              ("gla_chunk", scans), ("gla_bwd", scans))
            if used]
    if any(kernel[k] <= 0 for k in want) or any(plain.values()):
        fail(f"float32 replay: kernel run launches {kernel}, replay "
             f"launches {plain}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = gaps(g_k, g_p)
    loss_floor, fl = 0.0, dict.fromkeys(errs, 0.0)
    if scans:
        with PlainOps(scan="recurrence"):
            loss_r, g_r, again = launched()
        if any(again.values()):
            fail(f"float32 replay by the recurrence launched {again}")
        loss_floor = abs(loss_r - loss_p) / abs(loss_p)
        fl = gaps(g_r, g_p)
        del g_r
    loss_limit = max(1e-5, 2 * loss_floor)
    limits = {k: max(1e-4, 2 * fl[k]) for k in errs}
    # the worst leaf is the one nearest its own limit
    order = sorted(errs, key=lambda k: errs[k] / limits[k], reverse=True)
    worst = order[0]
    # per block type, its leaf nearest its limit
    by_block = {}
    for k in order:
        by_block.setdefault(k.split("/")[1] if k.startswith("layers/")
                            else k.split("/")[0], k)
    out.update(loss=loss_k, loss_plain=loss_p, loss_rel_err=rel,
               worst_leaf=worst, worst_leaf_rel_err=errs[worst],
               leaf_floor=fl[worst], leaf_limit=limits[worst],
               leaves=len(errs), layers=n_layers, seq_len=TRAIN_SMALL_SEQ,
               launches=kernel, loss_floor=loss_floor, loss_limit=loss_limit,
               worst_leaves=[(k, errs[k], fl[k], limits[k])
                             for k in order[:5]],
               worst_by_block={b: (k, errs[k], fl[k], limits[k])
                               for b, k in by_block.items()})
    log(f"  {arch} float32 replay ({n_layers} layers, S "
        f"{TRAIN_SMALL_SEQ}): loss {loss_k:.6f} against the plain "
        f"version's {loss_p:.6f} (relative {rel:.2e}, limit "
        f"{loss_limit:.2e}"
        + (f", the plain replays' own gap {loss_floor:.2e}" if scans else "")
        + f"); of {len(errs)} gradient leaves, each within max(1e-4, twice "
        f"the plain replays' gap) of its max|grad|, nearest its limit "
        f"(gap, plain replays' gap, limit): " + ", ".join(
            f"{k} {errs[k]:.2e} {fl[k]:.2e} {limits[k]:.2e}"
            for k in order[:5]))
    log("    per block, the leaf nearest its limit: " + ", ".join(
        f"{b}: {k} {errs[k]:.2e} {fl[k]:.2e} {limits[k]:.2e}"
        for b, k in by_block.items()))
    over = [k for k in errs if errs[k] > limits[k]]
    if rel > loss_limit or over:
        fail(f"float32 training step differs from its plain replay: loss "
             f"{rel:.2e} (limit {loss_limit:.2e}), leaves over their "
             f"limits {[(k, errs[k], limits[k]) for k in over]}")
    del params, g_k, g_p
    free_device_memory()


def train_checkpoint(out, arch=TRAIN_ARCH, n_layers=TRAIN_SMALL_LAYERS):
    """`arch` at full width and `n_layers` layers (bf16, AdamW): a run
    saves after step 2 and goes on to step 3; a fresh Trainer restores the
    checkpoint and takes step 3.  Its loss and every parameter and state
    leaf must equal the uninterrupted run's, bitwise."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import Trainer
    from repro_torch.tree import leaves
    spec = get_arch(arch)
    cfg = spec.model.replace(n_layers=n_layers)
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(optimizer=spec.optimizer, seq_len=TRAIN_SMALL_SEQ,
              global_batch=1, seed=0, torch_device=DEVICE,
              ckpt_dir=str(ckpt))
    try:
        a = Trainer(cfg, **kw)
        t0 = time.perf_counter()
        a.train(2, log_every=10 ** 9, ckpt_every=10 ** 9)  # saves at 2
        save_s = time.perf_counter() - t0
        a.ckpt = None                  # the uninterrupted run saves no more
        loss_a = a.train(1, log_every=10 ** 9)["loss"]
        b = Trainer(cfg, **kw)
        t0 = time.perf_counter()
        if not b.maybe_restore() or b.step != 2:
            fail("the training checkpoint did not restore at step 2")
        restore_s = time.perf_counter() - t0
        b.ckpt = None
        loss_b = b.train(1, log_every=10 ** 9)["loss"]
        same = loss_a == loss_b and all(
            torch.equal(x, y) for x, y in zip(
                leaves(a.params) + leaves(a.opt_state),
                leaves(b.params) + leaves(b.opt_state)))
        nbytes = sum(f.stat().st_size for f in ckpt.rglob("*.npy"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out.update(loss=loss_a[0], loss_restored=loss_b[0], bitwise=same,
               checkpoint_gb=nbytes / 1e9, save_and_steps_s=save_s,
               restore_s=restore_s, layers=n_layers)
    log(f"  {arch} checkpoint round trip ({n_layers} layers, "
        f"{nbytes / 1e9:.2f} GB on disk; two steps and the save "
        f"{save_s:.1f} s, restore {restore_s:.1f} s): step 3 loss "
        f"{loss_a[0]:.6f} uninterrupted, {loss_b[0]:.6f} restored, "
        f"bitwise equal: {same}")
    if not same:
        fail("the restored run's step 3 differs from the uninterrupted run")
    del a, b
    free_device_memory()


def phase_train(rec, counters):
    """Training on the card: train_llama (the main path, counts from 0),
    then the float32 replay and the checkpoint round trip (the flash
    backward kernel is held to its plain version at the shapes llama
    launched, and at phase 16's, after phase 16: phase_flash_bwd_kernel);
    then each of RECURRENT_TRAIN (train_recurrent, counts from 0 before
    each), its float32 replay and checkpoint round trip at one repeating
    unit, and the gla_chunk backward kernel against its plain version
    (phase_gla_bwd_kernel)."""
    t_phase = time.perf_counter()
    out = {"llama": {}, "f32_replay": {}, "checkpoint": {}}
    train_llama(out["llama"], counters)
    train_f32_replay(out["f32_replay"], counters)
    train_checkpoint(out["checkpoint"])
    bwd_shapes = out["llama"]["bwd_shapes"]
    out["llama"]["bwd_shapes"] = [list(sh) + [n] for sh, n in
                                  bwd_shapes.items()]
    gla_shapes = {}
    for arch, conf in RECURRENT_TRAIN.items():
        t0 = time.perf_counter()
        o = out[arch] = {"f32_replay": {}, "checkpoint": {}}
        train_recurrent(o, counters, arch)
        for sh, n in o["gla_bwd_shapes"].items():
            gla_shapes[sh] = gla_shapes.get(sh, 0) + n
        o["gla_bwd_shapes"] = [list(sh) + [n] for sh, n in
                               o["gla_bwd_shapes"].items()]
        train_f32_replay(o["f32_replay"], counters, arch,
                         conf["small_layers"])
        train_checkpoint(o["checkpoint"], arch, conf["small_layers"])
        o["seconds"] = time.perf_counter() - t0
        log(f"  {arch} took {o['seconds']:.1f} s")
    g_rows, g_err = phase_gla_bwd_kernel(rec, gla_shapes)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {out['seconds']:.1f} s")
    rec["train"] = out
    return out, bwd_shapes, g_rows, g_err


def gla_bound_ms(B, S, H, N, P, Q, qk_elt, y_elt, h0, broadcast):
    """The larger of the bytes (q and k once, counted once where they are
    broadcast over heads; v, la and h0 read; y and h written) at the
    memory rate and the operations at the bf16 dense tensor-core peak.
    The operations are 2T^2 N + 2T^2 P + 4TNP per tile of T rows and head,
    T the forward kernel's own tile (gla_plan's, at most min(Q, 64): the
    scan's result does not depend on it), as gla_bwd_bound_ms counts the
    backward's; a ragged last tile counts its rows alone."""
    import torch
    from repro_torch.kernels.gla_chunk.kernel import MAX_TILE, gla_plan
    qk = 2 * B * S * N * (1 if broadcast else H) * qk_elt
    nbytes = qk + B * S * H * (P + 1) * 4 + B * S * H * P * y_elt \
        + B * H * N * P * 4 * (1 + bool(h0))
    T = gla_plan(B, H, N, P, min(Q, MAX_TILE),
                 torch.bfloat16 if qk_elt == 2 else torch.float32).tile
    rows = [T] * (S // T) + [S % T] * bool(S % T)
    ops = B * H * sum(2 * t * t * N + 2 * t * t * P + 4 * t * N * P
                      for t in rows)
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


#: (B, S, H, N, P, chunk, q/k dtype, q/k heads, h0 and dh given) the
#: gla_chunk backward kernel is held to its plain version at (and timed),
#: besides any other shape training launched: q/k heads "one" is one row
#: for every head (Mamba2's C and B), "heads" one per head
GLA_BWD_CASES = [
    (2, 4096, 64, 64, 64, 64, "bfloat16", "one", False),      # zamba2-1.2b
    (2, 2048, 4, 256, 1025, 512, "bfloat16", "heads", False),  # xlstm train
    (2, 4096, 4, 256, 1025, 512, "bfloat16", "heads", False),  # xlstm-1.3b
    (2, 1024, 8, 64, 48, 64, "float32", "heads", True),       # h0 and dh
    (2, 160, 4, 32, 40, 32, "float32", "one", True),          # ragged tile
    (1, 32768, 2, 64, 64, 64, "float32", "heads", True),      # long, slow
]
#: the case whose decay is slow (la about -1e-3) and whose v = 1 + N(0, 1):
#: a one-signed error of a sum chained across the tiles would grow with S
GLA_BWD_LONG = GLA_BWD_CASES[-1]


def gla_bwd_inputs(B, S, H, N, P, chunk, dt, heads, state):
    """Seed-made q, k (B, S, 1 or H, N; k scaled by 1/sqrt(N) above N 64,
    as the mLSTM scales it), v, la = -0.3 |normal|, h0 0.1 normal, dy,
    dh 0.5 normal (h0 and dh None unless `state`); at GLA_BWD_LONG la =
    -1e-3 (1 + 0.1 |normal|) and v = 1 + N(0, 1)."""
    import torch
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(S + H + N + P)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    hq = 1 if heads == "one" else H
    dtype = getattr(torch, dt)
    q = t(B, S, hq, N).to(dtype)
    k = t(B, S, hq, N, scale=N ** -0.5 if N > 64 else 1.0).to(dtype)
    v = t(B, S, H, P)
    la = -t(B, S, H).abs() * 0.3
    if (B, S, H, N, P, chunk, dt, heads, state) == GLA_BWD_LONG:
        la = -1e-3 * (1 + 0.1 * t(B, S, H).abs())
        v = v + 1.0
    h0 = t(B, H, N, P, scale=0.1) if state else None
    dy = t(B, S, H, P)
    dh = t(B, H, N, P, scale=0.5) if state else None
    return q, k, v, la, h0, dy, dh


def gla_bwd_errors(got, args, chunk):
    """The backward kernel's float32 (dq, dk, dv, dla, dh0) against the
    plain backward in float64 on the same inputs: each output's error at
    most 4x the float32 plain backward's, or 1e-6 of its max|want| where
    that is larger (the forward's rule, gla_f64_errors).  Returns a list
    of dicts (name, err, plain, limit, ok, max_want) and the largest
    error against the float32 plain backward (the kernels line's
    max_abs_err)."""
    import torch
    from repro_torch.kernels.gla_chunk import gla_chunk_bwd_plain
    want32 = gla_chunk_bwd_plain(*args, chunk=chunk, dtype=torch.float32)
    want64 = gla_chunk_bwd_plain(*args, chunk=chunk, dtype=torch.float64)
    out, worst = [], 0.0
    for name, a, w, e in zip(("dq", "dk", "dv", "dla", "dh0"), got, want32,
                             want64):
        e = e.double()
        err = float((a.double() - e).abs().max())
        plain = float((w.double() - e).abs().max())
        top = float(e.abs().max())
        limit = max(4 * plain, 1e-6 * top)
        out.append(dict(name=name, err=err, plain=plain, limit=limit,
                        ok=err <= limit, max_want=top))
        worst = max(worst, float((a - w).abs().max()))
    del want32, want64
    return out, worst


def gla_bwd_check_line(checks):
    """One log line's text for gla_bwd_errors' checks."""
    return ", ".join(f"{c['name']} {c['err']:.3e} (plain {c['plain']:.3e}, "
                     f"limit {c['limit']:.3e}, max|want| "
                     f"{c['max_want']:.3e})" for c in checks)


def gla_bwd_bound_ms(B, S, H, N, P, Q, qk_elt, hq, state):
    """The larger of the operations at the bf16 dense tensor-core peak
    and the bytes (q, k, v, la, dy, and h0 and dh where given, read once;
    dq, dk, dv, dla and dh0 written once) at the memory rate.  The
    operations are counted per tile of T = min(Q, BWD_TILE) rows and
    head, T the kernel's own tile (its result does not depend on Q): the
    states recomputed and their gradients 4TNP, dq dk dv 6TNP, the two
    score tiles and their three products 2T^2 (3N + 2P); a ragged last
    tile counts its rows alone."""
    from repro_torch.kernels.gla_chunk.kernel import BWD_TILE
    T = min(Q, BWD_TILE)
    rows = [T] * (S // T) + [S % T] * bool(S % T)
    ops = B * H * sum(2 * t * t * (3 * N + 2 * P) + 10 * t * N * P
                      for t in rows)
    nbytes = 4 * B * S * hq * N * qk_elt + B * S * H * (3 * P + 2) * 4 \
        + B * H * N * P * 4 * (1 + 2 * bool(state))
    t_ops, t_bytes = ops / BF16_TENSOR_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gla_bwd_row(shape, launches=0):
    """The backward kernel at one GLA_BWD_CASES shape: bitwise equal over
    two calls, the op's result the kernel's float32 one in the operands'
    dtypes, every output held to the plain backward (gla_bwd_errors),
    timed (kernel ms from torch.profiler, its five kernels; call ms; the
    float32 plain backward's ms) beside gla_bwd_bound_ms.  At
    GLA_BWD_LONG the forward kernel is held to float64 on the same inputs
    as well (gla_f64_errors).  Fails on any miss; returns the row."""
    import torch
    from repro_torch.kernels.gla_chunk import (gla_chunk, gla_chunk_bwd,
                                               gla_chunk_bwd_plain,
                                               gla_chunk_plain)
    from repro_torch.kernels.gla_chunk.kernel import gla_chunk_bwd_cuda
    B, S, H, N, P, Q, dt, heads, state = shape
    args = gla_bwd_inputs(*shape)
    got = gla_chunk_bwd(*args, chunk=Q)
    again = gla_chunk_bwd(*args, chunk=Q)
    raw = gla_chunk_bwd_cuda(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"the gla_chunk backward kernel at {shape} is not reproducible")
    if not all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, raw)):
        fail(f"the gla_chunk backward op at {shape} is not its kernel's "
             f"result")
    del got, again
    checks, err = gla_bwd_errors(raw, args, Q)
    log(f"  gla backward {shape}: {gla_bwd_check_line(checks)}")
    if not all(c["ok"] for c in checks):
        fail(f"the gla_chunk backward kernel at {shape} differs from the "
             f"plain backward: {checks}")
    del raw
    row = dict(B=B, S=S, H=H, N=N, P=P, chunk=Q, qk_dtype=dt, qk_heads=heads,
               state=state, launches=launches, checks=checks,
               max_abs_err=err)
    if shape == GLA_BWD_LONG:
        q, k, v, la, h0 = args[:5]
        kw = dict(chunk=Q, y_dtype=torch.float32)
        fwd = gla_chunk(q, k, v, la, h0, **kw)
        f64 = gla_f64_errors(fwd, gla_chunk_plain(q, k, v, la, h0, **kw),
                             q, k, v, la, h0)
        row["forward_f64"] = {w: dict(kernel=ek, plain=ep, max=top)
                              for w, (ek, ep, top) in zip(("y", "h"), f64)}
        log(f"  gla forward at the long slow-decay case {shape[:6]}: "
            + ", ".join(f"{w} kernel {ek:.3e} plain {ep:.3e} (max {top:.3e})"
                        for w, (ek, ep, top) in zip(("y", "h"), f64)))
        for w, (ek, ep, top) in zip(("y", "h"), f64):
            if ek > max(4 * ep, 1e-6 * top):
                fail(f"the gla_chunk forward kernel at {shape[:6]}: {w} "
                     f"error {ek} against float64, over 4x the plain "
                     f"version's {ep}")
        del fwd
    big = S * H * P >= 4096 * 64 * 64
    call = lambda: gla_chunk_bwd(*args, chunk=Q)  # noqa: E731
    call_ms = cuda_time_ms(call, reps=5 if big else 20, warmup=1)
    ms = kernel_ms(call, "gla_bwd", call_ms, reps=5 if big else 20)
    plain = cuda_time_ms(lambda: gla_chunk_bwd_plain(*args, chunk=Q),
                         reps=2, warmup=1)
    bound, by = gla_bwd_bound_ms(B, S, H, N, P, Q, args[0].element_size(),
                                 args[0].shape[2], state)
    row.update(ms=ms, call_ms=call_ms, plain_ms=plain, library_ms=None,
               bound_ms=bound, bound_by=by)
    log(f"  gla backward B={B} S={S} H={H} N={N} P={P} chunk={Q} {dt} q/k "
        f"{heads}{' h0 dh' if state else ''}: kernel {ms:.4f} ms, call "
        f"{call_ms:.4f} ms (bound {bound:.5f} ms by {by}; plain "
        f"{plain:.4f} ms; library none)"
        + (f" x{launches}" if launches else ""))
    del args
    torch.cuda.empty_cache()
    return row


def phase_gla_bwd_kernel(rec, train_shapes):
    """The gla_chunk backward kernel (gla_bwd_row) at GLA_BWD_CASES and at
    every other shape the training runs launched (train_shapes: the op's
    bwd_shapes keys and counts)."""
    cases = {c: 0 for c in GLA_BWD_CASES}
    for (B, S, H, N, P, Q, dt, bc), n in train_shapes.items():
        key = (B, S, H, N, P, Q, dt, "one" if bc else "heads", False)
        cases[key] = cases.get(key, 0) + n
    rows = [gla_bwd_row(sh, n) for sh, n in cases.items()]
    rec["gla_bwd_shapes"] = rows
    return rows, max(r["max_abs_err"] for r in rows)


#: zamba2-1.2b's prefill scan at long prompts: (B, S, H, N, P, chunk)
ZAMBA2_PREFILL = [(1, 4096, 64, 64, 64, 64), (1, 32768, 64, 64, 64, 64)]
#: xlstm-1.3b's mLSTM scan (src/repro/models/xlstm.py: 4 heads, q/k width
#: N = max(64, 1024 / 4) = 256, v with its denominator channel P = 1025,
#: chunk 512), bf16 q and k per head, at a 4096-token prompt
XLSTM_PREFILL = (1, 4096, 4, 256, 1025, 512)
#: the longest scan the float64 check replays step by step
GLA_F64_MAX_S = 4096


def gla_inputs(B, S, H, N, P, seed, qk_dtype="float32", broadcast=True,
               h0=True):
    """Unit-normal q, k (one row per step broadcast over heads, as Mamba2
    gives them, or one per head), v; la = -0.3 |normal|; h0 0.1 normal.
    Above N 64, k is scaled by 1/sqrt(N) as the mLSTM scales it
    (src/repro/models/xlstm.py): unit-normal k there gives scores of 16
    and a plain float32 version whose own error against float64 exceeds
    the 3e-4 limit."""
    import torch
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev)
    dt = getattr(torch, qk_dtype)
    ks = N ** -0.5 if N > 64 else 1.0
    if broadcast:
        q = t(B, S, N).to(dt)[:, :, None].expand(B, S, H, N)
        k = (t(B, S, N) * ks).to(dt)[:, :, None].expand(B, S, H, N)
    else:
        q, k = t(B, S, H, N).to(dt), (t(B, S, H, N) * ks).to(dt)
    return (q, k, t(B, S, H, P), -t(B, S, H).abs() * 0.3,
            t(B, H, N, P) * 0.1 if h0 else None)


def gla_f64_errors(got, want, q, k, v, la, h0):
    """Per output (y, h): the kernel's and the plain version's max error
    against the step recurrence in float64, and the output's max|.|."""
    import torch
    from repro_torch.kernels.gla_chunk import gla_recurrence
    B, S, H, N = q.shape
    P = v.shape[-1]

    def to_bh(t):
        return t.transpose(1, 2).reshape(B * H, 1, S, -1)
    hi = torch.zeros((B * H, N, P), device=q.device) if h0 is None \
        else h0.reshape(B * H, N, P)
    y64, h64 = gla_recurrence(to_bh(q), to_bh(k), to_bh(v),
                              to_bh(la[..., None])[..., 0], hi,
                              dtype=torch.float64)
    exact = (y64.reshape(B, H, S, P).transpose(1, 2), h64.reshape(B, H, N, P))
    return [(float((g.double() - e).abs().max()),
             float((w.double() - e).abs().max()), float(e.abs().max()))
            for g, w, e in zip(got, want, exact)]


def phase_gla_kernel(rec, main_shapes, xlstm_shapes, train_shapes):
    """gla_chunk against its plain version within 3e-4 absolute plus 3e-4
    relative (the reference's own limit for its kernel against its
    oracle), y in float32 as chunked_gla asks, and bitwise equal over two
    calls; up to S 4096 also against the step recurrence in float64, the
    kernel's error at most 4x the plain version's or 1e-6 of the output's
    max|.|; timed at every shape the hybrid, xlstm and training paths
    launched, at zamba2-1.2b's prefill at S 4096 and 32768 and at
    xlstm-1.3b's at S 4096."""
    import torch
    from repro_torch.kernels.gla_chunk import gla_chunk, gla_chunk_plain
    cases = []
    for path, shapes in (("hybrid", main_shapes), ("xlstm", xlstm_shapes),
                         ("train", train_shapes)):
        for (B, S, H, N, P, Q, dt, bc), n in shapes.items():
            cases.append(((B, S, H, N, P, Q), dt, bc, False, n, path))
    cases += [(sh, "float32", True, False, -1, None)
              for sh in ZAMBA2_PREFILL]
    cases += [(XLSTM_PREFILL, "bfloat16", False, True, -1, None)]
    # the reference's kernel-test shapes (tests/test_kernels.py), nonzero
    # h0, one q and k per head; Q = 16; bf16 q and k over heads broadcast
    checked = [((2, 256, 3, 32, 32, 64), "float32", False, True, 0),
               ((1, 512, 2, 64, 64, 128), "float32", False, True, 0),
               ((2, 128, 4, 16, 48, 32), "float32", False, True, 0),
               ((1, 16, 64, 64, 64, 64), "float32", True, True, 0),
               ((1, 512, 64, 64, 64, 64), "bfloat16", True, True, 0),
               ((4, 256, 64, 64, 64, 64), "bfloat16", False, True, 0),
               # xlstm's widths at a one-chunk prompt (S 512 = chunk 512),
               # N 72 (not a multiple of 16) and N 1 (q and k padded)
               ((1, 512, 4, 256, 1025, 512), "float32", False, True, 0),
               ((1, 256, 3, 72, 40, 64), "float32", False, True, 0),
               ((2, 128, 2, 1, 16, 32), "float32", False, True, 0)]
    cases += [c + (None,) for c in checked]
    rows, max_err = [], 0.0
    for (B, S, H, N, P, Q), dt, bc, h0, launches, path in cases:
        q, k, v, la, h = gla_inputs(B, S, H, N, P, S + H + N + P, dt, bc,
                                    h0)
        kw = dict(chunk=Q, y_dtype=torch.float32)
        got = gla_chunk(q, k, v, la, h, **kw)
        again = gla_chunk(q, k, v, la, h, **kw)
        want = gla_chunk_plain(q, k, v, la, h, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for a, b, c in zip(got, again, want):
            if not torch.equal(a, b):
                fail(f"gla_chunk {(B, S, H, N, P, Q, dt, bc)}: two calls "
                     f"differ")
            d = (a - c).abs()
            if not bool((d <= 3e-4 + 3e-4 * c.abs()).all()):
                fail(f"gla_chunk {(B, S, H, N, P, Q, dt, bc)}: error "
                     f"{float(d.max())} beyond 3e-4 + 3e-4 |plain|")
            err = max(err, float(d.max()))
        max_err = max(max_err, err)
        shape = dict(B=B, S=S, H=H, N=N, P=P, chunk=Q, qk_dtype=dt,
                     heads_broadcast=bc, h0=h0)
        if S <= GLA_F64_MAX_S:
            f64 = gla_f64_errors(got, want, q, k, v, la, h)
            for what, (ek, ep, top) in zip(("y", "h"), f64):
                if ek > max(4 * ep, 1e-6 * top):
                    fail(f"gla_chunk {(B, S, H, N, P, Q, dt, bc)}: {what} "
                         f"error {ek} against float64, over 4x the plain "
                         f"version's {ep} and 1e-6 of max {top}")
            shape["f64_err"] = {w: dict(kernel=ek, plain=ep, max=top)
                                for w, (ek, ep, top) in zip(("y", "h"), f64)}
        if launches == 0:
            rows.append(dict(shape, launches=0, timed=False,
                             max_abs_err=err))
            continue
        big = S >= 32768
        reps = 5 if big else 20
        call = lambda: gla_chunk(q, k, v, la, h, **kw)  # noqa: E731
        call_ms = cuda_time_ms(call, reps=reps, warmup=1)
        ms = kernel_ms(call, "gla_kernel", call_ms, reps=reps)
        plain = cuda_time_ms(lambda: gla_chunk_plain(q, k, v, la, h, **kw),
                             reps=2 if big else 5, warmup=1)
        bound, by = gla_bound_ms(B, S, H, N, P, Q, q.element_size(), 4, h0,
                                 bc)
        rows.append(dict(shape, launches=max(launches, 0), timed=True,
                         hybrid_path=path == "hybrid",
                         xlstm_path=path == "xlstm",
                         train_path=path == "train", ms=ms, call_ms=call_ms,
                         plain_ms=plain, library_ms=None, bound_ms=bound,
                         bound_by=by, max_abs_err=err))
        log(f"  gla_chunk B={B} S={S} H={H} N={N} P={P} chunk={Q} {dt}"
            f"{' heads broadcast' if bc else ''}: kernel {ms:.4f} ms, call "
            f"{call_ms:.4f} ms (bound {bound:.5f} ms by {by}; plain "
            f"{plain:.4f} ms; library none); max_abs_err {err:.3e}"
            + gla_f64_note(shape)
            + (f" x{launches} ({path} path)" if launches > 0
               else " (long prefill)"))
        del q, k, v, la, h, got, again, want
        torch.cuda.empty_cache()
    for r in rows:
        if not r["timed"]:
            log(f"  gla_chunk checked B={r['B']} S={r['S']} H={r['H']} "
                f"N={r['N']} P={r['P']} chunk={r['chunk']} {r['qk_dtype']}"
                f"{' heads broadcast' if r['heads_broadcast'] else ''}"
                f"{' h0' if r['h0'] else ''}: max_abs_err "
                f"{r['max_abs_err']:.3e}" + gla_f64_note(r))
    rec["gla_chunk_shapes"] = rows
    return rows, max_err


def gla_f64_note(row):
    """The float64 errors of one gla_chunk row, for the log."""
    f = row.get("f64_err")
    if not f:
        return ""
    return "; against float64 " + ", ".join(
        f"{w} kernel {e['kernel']:.3e} plain {e['plain']:.3e}"
        for w, e in f.items())


# ----------------------------------------------------------------------
# phase 15: the port's examples and the data-parallel mesh path
# ----------------------------------------------------------------------
#: (example, arguments): tests/test_examples.py's, each run on the card
EXAMPLE_RUNS = [
    ("quickstart_torch", []),
    ("resnet18_offload_torch", ["C12"]),
    ("resnet18_offload_torch", []),                  # its default, C9
    ("serve_lm_torch", ["--sessions", "2", "--steps", "6", "--pool", "2"]),
    ("serve_lm_torch", ["--sessions", "4", "--steps", "24"]),
]
#: the kernels the examples' path launches (decode_attention is not on it:
#: the quantized decoder's attention is numpy by default)
EXAMPLE_KERNELS = ("vta_gemm", "tensor_alu_scatter", "lut_gemm")
#: lines of the examples' output the log repeats (all of it is recorded)
EXAMPLE_MARKERS = ("cross-backend check ok", "served 16 calls",
                   "pool-served", "decoded 8 steps", "continuous-batched",
                   "const ", "self-healed", "autotuned", "exact on VTA",
                   ": exact end-to-end", "unscaled", "served ",
                   "reproduce the eager")
MESH_TRAIN_STEPS = 3
#: the models trained on the one-rank mesh at phase 14's shape, with the
#: kernel launches of each step (as phase 14 asserts them)
MESH_TRAIN = {
    TRAIN_ARCH: dict(seq=TRAIN_SEQ, launches=dict(
        flash_fwd=56, flash_bwd=28, gla_fwd=0, gla_bwd=0)),
    "zamba2-1.2b": dict(seq=TRAIN_SEQ, launches=RECURRENT_TRAIN[
        "zamba2-1.2b"]["launches"]),
}


def load_example(name):
    """examples/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(out, counters):
    """Each of EXAMPLE_RUNS through its main() with --device cuda; their
    own assertions are the check.  The global tuning cache is restored
    after (quickstart's step 15 writes records into it)."""
    import io
    from repro_torch.core import autotune
    gc = autotune.global_cache()
    snap = (dict(gc.entries), gc.hits, gc.misses)
    runs = []
    try:
        for name, argv in EXAMPLE_RUNS:
            mod = load_example(name)
            buf = io.StringIO()
            counters.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                ret = mod.main(argv + ["--device", DEVICE])
            secs = time.perf_counter() - t0
            launches = counters.read()
            text = buf.getvalue()
            runs.append(dict(example=f"examples/{name}.py", argv=argv,
                             seconds=secs, launches=launches, stdout=text,
                             **({"anchor_ms": ret} if ret is not None
                                else {})))
            log(f"  examples/{name}.py {' '.join(argv)}: {secs:.1f} s, "
                f"launches {launches}")
            for line in text.splitlines():
                if any(m in line for m in EXAMPLE_MARKERS):
                    log(f"    {line.strip()[:150]}")
            free_device_memory()
    finally:
        gc.entries, gc.hits, gc.misses = snap
    total = {k: sum(r["launches"][k] for r in runs) for k in counters.ops}
    for k in EXAMPLE_KERNELS:
        if total[k] <= 0:
            fail(f"{k} was never launched by the examples")
    out["examples"] = runs
    out["example_launches"] = total
    log(f"  examples' launches: {total}")


def mesh_train(out, counters, arch):
    """`arch` (MESH_TRAIN) at its published width and depth, at phase
    14's shape (bf16, AdamW, remat, B2 and its S), trains MESH_TRAIN_STEPS
    steps through Trainer(mesh=make_mesh((1, 1), ("data", "model")),
    fsdp=True) on the one-rank nccl group, then as many through the
    meshless Trainer from the same seed: every step's loss and gradient
    norm, and every parameter after the last step, bitwise equal (a
    one-rank mean is the identity); the flash and gla_chunk launches
    (forward and backward) of each run asserted; each run's step ms, peak
    allocated memory, and one more step under the profiler for the idle
    share."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gla_chunk import gla_chunk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    conf = MESH_TRAIN[arch]
    S = conf["seq"]
    spec = get_arch(arch)
    cfg = spec.model.replace(max_seq=max(spec.model.max_seq, S))
    want = {k: n * MESH_TRAIN_STEPS for k, n in conf["launches"].items()}
    runs, final = {}, {}
    for name in ("mesh_fsdp", "meshless"):
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        kw = dict(mesh=make_mesh((1, 1), ("data", "model"), device=DEVICE),
                  fsdp=True) if name == "mesh_fsdp" else {}
        t0 = time.perf_counter()
        tr = Trainer(cfg, optimizer=spec.optimizer, seq_len=S,
                     global_batch=TRAIN_BATCH, seed=0, torch_device=DEVICE,
                     **kw)
        torch.cuda.synchronize()
        r = dict(build_s=time.perf_counter() - t0,
                 state_gb=torch.cuda.memory_allocated() / 1e9)
        if name == "mesh_fsdp":
            leaves = tree.flatten(tr.params)
            if not all(isinstance(v, DTensor) for v in leaves.values()):
                fail(f"{arch}: the mesh Trainer's parameters are not "
                     f"DTensors")
            r["sharded_leaves"] = sum(
                isinstance(v.placements[0], Shard) for v in leaves.values())
            r["leaves"] = len(leaves)
            del leaves
        counters.reset()
        for op in (gla_chunk, flash_attention):
            op.bwd_launches = 0
            op.bwd_shapes.clear()
        hist = tr.train(MESH_TRAIN_STEPS, log_every=1)
        launches = counters.read()
        got = dict(flash_fwd=launches["flash_attention"],
                   flash_bwd=flash_attention.bwd_launches,
                   gla_fwd=launches["gla_chunk"],
                   gla_bwd=gla_chunk.bwd_launches)
        r.update(loss=hist["loss"], grad_norm=hist["grad_norm"],
                 ms=[s * 1e3 for s in hist["seconds"]], launches=launches,
                 train_launches=got,
                 peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        if got != want:
            fail(f"{arch} {name}: {MESH_TRAIN_STEPS} steps launched {got}, "
                 f"not {want}")
        with torch.no_grad():
            final[name] = {
                k: (v.full_tensor() if isinstance(v, DTensor) else v)
                .detach().to("cpu", copy=True)
                for k, v in tree.flatten(tr.params).items()}
        r["step_ms_median"] = statistics.median(r["ms"][1:])
        r["tokens_per_s"] = TRAIN_BATCH * S / (r["step_ms_median"] / 1e3)
        profiled_step(tr, r)
        runs[name] = r
        log(f"  {arch} {name}: losses {r['loss']}, gradient norms "
            f"{r['grad_norm']}; step {r['step_ms_median']:.1f} ms (median "
            f"of steps 2-{MESH_TRAIN_STEPS}), peak allocated "
            f"{r['peak_allocated_gb']:.2f} GB, idle share "
            f"{r['profiled_step']['idle_share']:.4f}; launches {got}")
        del tr
    a, b = runs["mesh_fsdp"], runs["meshless"]
    for key in ("loss", "grad_norm"):
        if a[key] != b[key]:
            fail(f"{arch}: the one-rank mesh run's {key} differs from the "
                 f"meshless run's: {a[key]} vs {b[key]}")
    if a["profiled_step"]["loss"] != b["profiled_step"]["loss"]:
        fail(f"{arch}: the profiled step's loss differs between the runs")
    diff = [k for k in final["meshless"]
            if not torch.equal(final["mesh_fsdp"][k], final["meshless"][k])]
    if diff:
        fail(f"{arch}: parameters differ after {MESH_TRAIN_STEPS} steps: "
             f"{diff[:5]}")
    log(f"  {arch}: the one-rank nccl mesh (fsdp) and meshless runs bitwise "
        f"equal: {MESH_TRAIN_STEPS + 1} losses, {MESH_TRAIN_STEPS} gradient "
        f"norms, {len(final['meshless'])} parameter leaves")
    del final
    out[arch] = runs
    free_device_memory()


def compressed_mean_plain(g, err):
    """compressed_mean_local's arithmetic over one rank, without the
    collectives (the all-reduces of one rank are the identity)."""
    import torch
    gi = g.to(torch.float32) + err
    amax = torch.max(torch.abs(gi))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gi / scale), -128, 127).to(torch.int8)
    mean = q.to(torch.int32).to(torch.float32) * scale / 1
    new_err = gi - q.to(torch.float32) * scale
    return mean.to(g.dtype), new_err


def mesh_compression(out):
    """compressed_mean_local on CUDA tensors over the one-rank nccl group,
    at llama3.2-3b's largest parameter leaf (its dtype), two steps with
    the error carried, bitwise against its plain computation on CPU
    tensors; the all-reduces' dtypes recorded (the payload int32)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.distributed import compression
    from repro_torch.models import transformer as T
    cfg = get_arch(TRAIN_ARCH).model
    leaves = tree.flatten(T.init_params(cfg, 0, "meta").tree())
    name, leaf = max(leaves.items(), key=lambda kv: kv[1].numel())
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    calls, real = [], dist.all_reduce

    def spy(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append([str(t.dtype), t.numel(), str(op)])
        return real(t, op=op, group=group, async_op=async_op)

    err = torch.zeros(leaf.shape, dtype=torch.float32, device=DEVICE)
    err_cpu = err.cpu()
    ms = []
    dist.all_reduce = spy
    try:
        for step in range(2):
            g = torch.randn(leaf.shape, generator=gen, device=DEVICE,
                            dtype=torch.float32).to(leaf.dtype)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            mean, err = compression.compressed_mean_local(g, err)
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e))
            want, err_cpu = compressed_mean_plain(g.cpu(), err_cpu)
            if not (torch.equal(mean.cpu(), want)
                    and torch.equal(err.cpu(), err_cpu)):
                fail(f"compressed_mean_local on the card differs from its "
                     f"plain computation at step {step + 1}")
            del g, mean, want
    finally:
        dist.all_reduce = real
    big = [c for c in calls if c[1] > 1]
    if not big or any(c[0] != "torch.int32" for c in big):
        fail(f"the compressed payload crossed the all-reduce as {big}")
    out["compression"] = dict(leaf=name, shape=list(leaf.shape),
                              dtype=str(leaf.dtype), ms=ms,
                              all_reduce_calls=calls)
    log(f"  compressed_mean_local at {name} {tuple(leaf.shape)} "
        f"{leaf.dtype}: bitwise equal to its plain computation over 2 steps "
        f"(error carried); {ms[0]:.1f} / {ms[1]:.1f} ms a call; all-reduces "
        f"{calls}")
    del err, err_cpu
    free_device_memory()


def phase_mesh(rec, counters):
    """Phase 15: the examples, then the mesh path on a one-rank nccl
    group (made here, destroyed after)."""
    import socket
    import torch
    import torch.distributed as dist
    t_phase = time.perf_counter()
    out = {}
    run_examples(out, counters)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        for arch in MESH_TRAIN:
            mesh_train(out, counters, arch)
        mesh_compression(out)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    rec["mesh"] = out
    log(f"  phase 15 took {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------------
# phase 16: tensor and expert parallelism on two gloo ranks of one card
# ----------------------------------------------------------------------
#: the (data, model) mesh of phase 16: two processes on the one card,
#: joined by gloo over CUDA tensors (nccl takes one rank a device)
MESH16_SHAPE = (1, 2)
#: the runs: each at full width and phase 14's B2 S4096, bf16, AdamW with
#: remat, `steps` steps through Trainer(mesh=); `layers` cuts the depth
#: (None: the published depth).  phi3.5-moe's 32 layers of experts alone
#: are 80.5 GB: 2 layers.  After phi's steps (its own moe_fused_ep), one
#: more step with moe_fused_ep off (the psum branch of the expert-parallel
#: path).
MESH16_RUNS = {
    TRAIN_ARCH: dict(layers=None, steps=3),
    "phi3.5-moe-42b-a6.6b": dict(layers=2, steps=3, unfused_steps=1),
}
#: the float32 replays: one repeating unit (one layer) at S 512, B1
MESH16_F32 = {TRAIN_ARCH: 1, "phi3.5-moe-42b-a6.6b": 1}
#: the int8 serve run: llama3.2-3b at full width and depth on int8 PTQ
#: weights, a `prompt`-token prefill of `batch` rows and `steps` greedy
#: decode steps through the dry run's mesh serve step, its logits held to
#: the meshless int8 run on the same tokens within LM_LOGIT_TOL
MESH16_INT8 = dict(batch=2, prompt=16, steps=4)
#: seconds the two ranks may take together
MESH16_TIMEOUT = 600
MESH16_DIR = ROOT / "build" / "chip_smoke_mesh"


def mesh16_capture():
    """Wrap the flash op's forward and backward dispatch
    (flash_attention/ops.py `_forward`, `flash_attention_bwd`) to keep a
    copy of the inputs and outputs of chosen calls: the forward's first
    call, and the backward's first and last calls of the next step (the
    last layer's and the first's).  Returns (arm, captured, restore)."""
    from repro_torch.kernels.flash_attention import ops as fops
    real_fwd, real_bwd = fops._forward, fops.flash_attention_bwd
    state = dict(fwd=None, bwd=[], on=False)

    def fwd(q, k, v, causal, with_lse=False):
        out = real_fwd(q, k, v, causal, with_lse)
        if state["on"] and state["fwd"] is None:
            o = out[0] if with_lse else out
            state["fwd"] = dict(causal=causal, inputs=[
                t.detach().clone() for t in (q, k, v)], out=o.detach()
                .clone())
        return out

    def bwd(q, k, v, o, do, *, causal=True, lse=None):
        grads = real_bwd(q, k, v, o, do, causal=causal, lse=lse)
        if state["on"]:
            state["bwd"].append(dict(causal=causal, inputs=[
                t.detach().clone() for t in (q, k, v, o, do)],
                grads=[g.clone() for g in grads]))
            if len(state["bwd"]) > 2:       # keep the first and the last
                del state["bwd"][1]
        return grads

    def arm(on):
        state["on"] = on

    def restore():
        fops._forward, fops.flash_attention_bwd = real_fwd, real_bwd
    fops._forward, fops.flash_attention_bwd = fwd, bwd
    return arm, state, restore


def mesh16_check_captured(state, what):
    """The captured launches against their plain versions: the forward
    within attn_tolerance, each backward row by row (flash_bwd_errors)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    c = state["fwd"]
    q, k, v = c["inputs"]
    want = flash_attention_plain(q, k, v, causal=c["causal"])
    err = float((c["out"].float() - want.float()).abs().max())
    tol = attn_tolerance(str(q.dtype).split(".")[-1], want)
    if err > tol:
        fail(f"{what}: a flash forward launch at {tuple(q.shape)} differs "
             f"from the plain version by {err} > {tol}")
    out = dict(fwd=dict(shape=list(q.shape), kv=list(k.shape),
                        max_abs_err=err, limit=tol), bwd=[])
    for c in state["bwd"]:
        q, k, v, o, do = c["inputs"]
        checks, e = flash_bwd_errors(c["grads"], q, k, v, o, do,
                                     c["causal"])
        if not all(ck["ok"] for ck in checks):
            fail(f"{what}: a flash backward launch differs from the plain "
                 f"backward: {checks}")
        out["bwd"].append(dict(shape=list(q.shape), err=e, checks=checks))
    log(f"  {what}: the flash forward launch at q {out['fwd']['shape']} k "
        f"{out['fwd']['kv']}: error {err:.3e} within {tol:.3e}; the "
        f"backward's last and first layers: " + "; ".join(
            flash_bwd_check_line(b["checks"]) for b in out["bwd"]))
    return out


def mesh16_train(mesh, arch, conf):
    """`arch` through Trainer(mesh=) on this rank: steps, launches at the
    local shapes, peak allocated memory, a profiled step; the step's
    flash launches held to their plain versions (mesh16_check_captured)."""
    import math
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import Trainer, build_mesh_train_step
    spec = get_arch(arch)
    cfg = spec.model.replace(max_seq=max(spec.model.max_seq, TRAIN_SEQ))
    if conf["layers"]:
        cfg = cfg.replace(n_layers=conf["layers"])
    L = cfg.n_layers
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, optimizer=spec.optimizer, seq_len=TRAIN_SEQ,
                 global_batch=TRAIN_BATCH, seed=0, mesh=mesh,
                 torch_device=DEVICE)
    torch.cuda.synchronize()
    r = dict(arch=arch, layers=L, build_s=time.perf_counter() - t0,
             state_gb=torch.cuda.memory_allocated() / 1e9,
             split_leaves=sorted(k for k, v in tr.model_split.items() if v),
             reduced=[f"global batch 256 -> {TRAIN_BATCH} sequences"] + (
                 [f"{spec.model.n_layers} -> {L} layers"]
                 if L != spec.model.n_layers else []))
    flash_attention.launches = flash_attention.bwd_launches = 0
    flash_attention.shapes.clear()
    flash_attention.bwd_shapes.clear()
    arm, state, restore = mesh16_capture()
    steps = []
    try:
        for i in range(conf["steps"]):
            before = (flash_attention.launches, flash_attention.bwd_launches)
            arm(i == 0)
            hist = tr.train(1, log_every=1)
            arm(False)
            fwd = flash_attention.launches - before[0]
            bwd = flash_attention.bwd_launches - before[1]
            steps.append(dict(loss=hist["loss"][0],
                              grad_norm=hist["grad_norm"][0],
                              ms=hist["seconds"][0] * 1e3, flash_fwd=fwd,
                              flash_bwd=bwd))
            if (fwd, bwd) != (2 * L, L):
                fail(f"{arch} on the mesh: step {i + 1} launched the flash "
                     f"kernels {fwd} (forward) and {bwd} (backward) times, "
                     f"not {2 * L} and {L}")
    finally:
        restore()
    r["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["fwd_shapes"] = [list(k) + [n] for k, n in
                       flash_attention.shapes.items()]
    r["bwd_shapes"] = [list(k) + [n] for k, n in
                       flash_attention.bwd_shapes.items()]
    if not all(math.isfinite(s["loss"]) for s in steps):
        fail(f"{arch} on the mesh: losses {[s['loss'] for s in steps]}")
    r["captured"] = mesh16_check_captured(state, f"{arch} on the mesh")
    del state
    med = statistics.median(s["ms"] for s in steps[1:])
    r.update(steps=steps, step_ms_median=med,
             tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (med / 1e3))
    profiled_step(tr, r)
    if conf.get("unfused_steps"):
        # the unfused expert-parallel path on the same parameters and state
        tr.cfg = cfg.replace(moe_fused_ep=False)
        tr.step_fn = build_mesh_train_step(tr.cfg, spec.optimizer, mesh,
                                           tr.p_shard, tr.model_split)
        hist = tr.train(conf["unfused_steps"], log_every=1)
        r["unfused"] = dict(loss=hist["loss"], grad_norm=hist["grad_norm"],
                            ms=[s * 1e3 for s in hist["seconds"]])
        if not all(math.isfinite(x) for x in hist["loss"]):
            fail(f"{arch} unfused on the mesh: losses {hist['loss']}")
    log(f"  {arch} ({L} layers) on the (data 1, model 2) mesh: losses "
        f"{[round(s['loss'], 5) for s in steps]}, step {med:.1f} ms "
        f"(median of steps 2-{conf['steps']}), "
        f"{r['tokens_per_s']:.0f} tokens/s, peak allocated "
        f"{r['peak_allocated_gb']:.2f} GB on this rank, idle share "
        f"{r['profiled_step']['idle_share']:.4f}; flash launches a step "
        f"{2 * L} / {L} at {r['fwd_shapes']}"
        + (f"; unfused step {r['unfused']['ms']} ms, loss "
           f"{r['unfused']['loss']}" if "unfused" in r else ""))
    del tr
    free_device_memory()
    return r


def mesh16_f32(mesh, arch, n_layers, rank):
    """`arch` at full width, `n_layers` layers, float32, S 512, B1: the
    two-rank step's loss and every gradient leaf (gathered whole) against
    the meshless step on the same weights and batch (rank 0 compares).
    Limits as phase 14's float32 replays: the loss within max(1e-5, twice
    two plain replays' gap) relative, each leaf within max(1e-4, twice
    its own gap) of its max|grad|; these archs do not scan, so the plain
    replays' gap is 0 and the limits are 1e-5 and 1e-4."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import (Trainer, _from_local, _gather,
                                          build_mesh_grad_fn)
    from repro_torch.models import transformer as T
    cfg = get_arch(arch).model.replace(n_layers=n_layers, dtype="float32")
    free_device_memory()
    tr = Trainer(cfg, seq_len=TRAIN_SMALL_SEQ, global_batch=1, seed=0,
                 mesh=mesh, torch_device=DEVICE)
    batch = tr.batch(0)
    grad_fn = build_mesh_grad_fn(cfg, mesh, tr.p_shard, tr.model_split)
    metrics, grads = grad_fn(tr.params, batch)
    sh = tree.flatten(tr.p_shard)
    whole = {k: _gather(_from_local(g, sh[k]), ())
             for k, g in tree.flatten(grads).items()}
    loss_m = float(metrics["loss"])
    del tr, grads
    out = dict(arch=arch, layers=n_layers, seq_len=TRAIN_SMALL_SEQ,
               loss=loss_m)
    if rank == 0:
        params = tree.requires_grad_(T.init_params(cfg, 0, DEVICE).tree())
        total, m = T.forward_train(params, cfg, batch)
        flat = tree.flatten(params)
        g = dict(zip(flat, torch.autograd.grad(total, list(flat.values()))))
        loss_p = float(m["loss"])
        rel = abs(loss_m - loss_p) / abs(loss_p)
        errs = {k: float((whole[k] - g[k]).abs().max()
                         / g[k].abs().max().clamp_min(1e-30)) for k in g}
        worst = max(errs, key=errs.get)
        out.update(loss_meshless=loss_p, loss_rel_err=rel, loss_limit=1e-5,
                   leaves=len(errs), leaf_limit=1e-4, worst_leaf=worst,
                   worst_leaf_rel_err=errs[worst],
                   worst_leaves=sorted(errs.items(), key=lambda kv: -kv[1])
                   [:5])
        log(f"  {arch} float32 ({n_layers} layer, S {TRAIN_SMALL_SEQ}): the "
            f"two-rank step's loss {loss_m:.6f} against the meshless "
            f"{loss_p:.6f} (relative {rel:.2e}, limit 1e-5); of "
            f"{len(errs)} gradient leaves the farthest {worst} "
            f"{errs[worst]:.2e} of its max|grad| (limit 1e-4)")
        if rel > 1e-5 or errs[worst] > 1e-4:
            fail(f"{arch}: the two-rank float32 step differs from the "
                 f"meshless step: loss {rel:.2e}, leaves "
                 f"{[(k, e) for k, e in errs.items() if e > 1e-4]}")
        del params, g
    del whole
    free_device_memory()
    return out


def mesh16_int8(mesh, rank):
    """llama3.2-3b at full width and depth on int8 PTQ weights served on
    the (data 1, model 2) mesh through ``launch/dryrun.py:_serve_step``
    (the layers compute on their slices of the int8 weights, the
    column-parallel ones on their columns of w_scale, each activation
    scale the max over the global activation): a MESH16_INT8 prefill and
    greedy decode steps, the logits gathered over the vocab.  Rank 0 then
    runs the meshless int8 model on the same tokens and holds each call's
    logits within LM_LOGIT_TOL of its max|logit|.  Every quantized_linear
    call of the mesh run is held to the global activation scale: after the
    run the ranks' per-call max|x| are gathered (all_gather, not the
    layers' all-reduce MAX), and a call given an x_scale (a row-parallel
    layer) must have been given exactly the reference's scale of the max
    over both ranks (``ref.activation_scale``), while a call given none
    (a column-parallel layer, whose x is replicated) must see that max
    itself.  Returns the record: logit errors, vta_gemm launches and the
    quantized_linear shapes of the mesh run (the tensor-parallel local
    shapes, held bitwise to the plain chain in phase 1, with a given
    x_scale too), ms a decode step."""
    import torch
    from repro_torch import tree
    from repro_torch.distributed import meshctx
    from repro_torch.distributed.sharding import (
        batch_specs, model_split_leaves, named_shardings, param_specs)
    from repro_torch.configs import get_arch
    from repro_torch.kernels.vta_gemm import quantized_linear, vta_gemm
    from repro_torch.kernels.vta_gemm.ref import activation_scale
    from repro_torch.launch.dryrun import _cache_layout, _serve_step
    from repro_torch.launch.train import (_distribute, _rows,
                                          _split_mesh_dims)
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as T
    from repro_torch.models.quantized import quantize_params
    conf = MESH16_INT8
    B, S, steps = conf["batch"], conf["prompt"], conf["steps"]
    cfg = get_arch(TRAIN_ARCH).model
    free_device_memory()
    full = quantize_params(T.init_params(cfg, 0, DEVICE).tree()).tree()
    free_device_memory()
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(16)) \
        .to(DEVICE)
    specs = param_specs(full, cfg, mesh)
    split = model_split_leaves(specs, cfg, mesh)
    params = tree.map_tree(_distribute, full, named_shardings(specs, mesh))
    b_dims = _split_mesh_dims(mesh, batch_specs({"tokens": toks}, cfg,
                                                mesh)["tokens"])
    b_axes = [mesh.mesh_dim_names[i] for i in b_dims]
    caches = _cache_layout(T.init_caches(cfg, B, S + steps, torch.bfloat16,
                                         DEVICE), cfg, mesh, b_dims)
    model = meshctx.axis_of(mesh, "model")
    # each call's local max|x| (in x's dtype, clamped as the layer does)
    # and the x_scale it was given (nan: none)
    amax, given, x_dtypes = [], [], []
    real_ql = TL.quantized_linear

    def ql(x, w_q, w_scale, x_scale=None):
        x_dtypes.append(x.dtype)
        amax.append(x.abs().amax().clamp_min(1e-6).float())
        given.append(torch.full((), float("nan"), device=x.device)
                     if x_scale is None else x_scale.float().reshape(()))
        return real_ql(x, w_q, w_scale, x_scale)
    TL.quantized_linear = ql
    vta_gemm.launches = 0
    quantized_linear.shapes.clear()
    logits, fed, step_ms = [], [], []
    with torch.no_grad():
        for step in range(steps + 1):
            if step == 0:
                batch, kind, pos = {"tokens": _rows(toks, mesh, b_dims)}, \
                    "prefill", 0
            else:
                batch = {"token": _rows(fed[-1], mesh, b_dims)}
                kind, pos = "decode", S + step - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = _serve_step(cfg, kind, mesh, params, split, batch,
                                     caches, pos, b_axes)
            if lg.shape[-1] < cfg.vocab_size:
                lg = meshctx.all_gather_blocks(lg.contiguous(), model, 2)
            torch.cuda.synchronize()
            if step:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.float().cpu())
            fed.append(lg.argmax(-1).to(torch.int64).reshape(B, 1))
    TL.quantized_linear = real_ql
    launches = vta_gemm.launches
    shapes = [list(k) + [n] for k, n in quantized_linear.shapes.items()]
    del params, caches
    free_device_memory()
    out = dict(arch=TRAIN_ARCH, **conf, vta_gemm_launches=launches,
               quantized_linear_shapes=shapes, decode_step_ms=step_ms)
    if launches == 0:
        fail(f"{TRAIN_ARCH} int8 on the mesh launched no vta_gemm kernel")
    # the global activation scale: gathered max|x| against what was given
    local = torch.stack(amax)
    glob = meshctx.all_gather_blocks(local.reshape(1, -1), model, 0) \
        .amax(0)
    given = torch.stack(given)
    row = ~torch.isnan(given)
    want = torch.stack([activation_scale(a.to(dt))
                        for a, dt in zip(glob, x_dtypes)])
    bad_row = int((row & (given != want)).sum())
    bad_col = int((~row & (local != glob)).sum())
    out.update(scale_calls=len(amax), scale_given=int(row.sum()))
    log(f"  {TRAIN_ARCH} int8 on the (1, 2) mesh: {len(amax)} "
        f"quantized_linear calls, {int(row.sum())} given the global "
        f"activation scale (row-parallel); {bad_row} given another, "
        f"{bad_col} given none whose max|x| is not the global one")
    if bad_row or bad_col or not row.any():
        fail(f"{TRAIN_ARCH} int8 on the (1, 2) mesh: the activation scale "
             f"is not the global one ({bad_row} row-parallel calls given "
             f"another, {bad_col} calls without one whose local max|x| is "
             f"not the global max, {int(row.sum())} given one)")
    if rank == 0:
        caches = T.init_caches(cfg, B, S + steps, torch.bfloat16, DEVICE)
        errs = []
        with torch.no_grad():
            for step in range(steps + 1):
                if step == 0:
                    lg, caches = T.prefill(full, cfg, {"tokens": toks},
                                           caches)
                else:
                    lg, caches = T.decode_step(full, cfg, caches,
                                               fed[step - 1], S + step - 1)
                want = lg.float().cpu()
                errs.append(float((logits[step] - want).abs().max()
                                  / want.abs().max()))
        out.update(logit_errors=errs, limit=LM_LOGIT_TOL)
        log(f"  {TRAIN_ARCH} int8 on the (1, 2) mesh: a {S}-token prefill "
            f"of {B} rows and {steps} decode steps ({min(step_ms):.1f}-"
            f"{max(step_ms):.1f} ms a step), {launches} vta_gemm launches "
            f"at {len(shapes)} local shapes; logits against the meshless "
            f"int8 run {max(errs):.3e} of max|logit| at most (limit "
            f"{LM_LOGIT_TOL})")
        if max(errs) > LM_LOGIT_TOL:
            fail(f"{TRAIN_ARCH} int8 on the (1, 2) mesh: logits {errs} of "
                 f"max|logit| from the meshless int8 run, over "
                 f"{LM_LOGIT_TOL}")
        del caches
    del full
    free_device_memory()
    return out


def mesh16_rank(rank, port, out_path):
    """One rank of phase 16: joins the gloo group, runs MESH16_RUNS and
    MESH16_F32 on the (data 1, model 2) mesh, writes its record as JSON
    to `out_path`.  Returns 0; a failed check exits non-zero."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    res = dict(rank=rank, backend=dist.get_backend())
    try:
        mesh = make_mesh(MESH16_SHAPE, ("data", "model"), device=DEVICE)
        res["runs"] = {arch: mesh16_train(mesh, arch, conf)
                       for arch, conf in MESH16_RUNS.items()}
        res["f32"] = {arch: mesh16_f32(mesh, arch, n, rank)
                      for arch, n in MESH16_F32.items()}
        res["int8"] = mesh16_int8(mesh, rank)
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


def phase_mesh16(rec):
    """Phase 16: two processes on the one card (this script with
    --mesh-rank 0 and 1), a gloo group over CUDA tensors on a (data 1,
    model 2) mesh; every process started is stopped before it returns.
    The kernels are built already (phase 0), so the ranks only load them.
    Returns rank 0's record, both ranks' losses held equal."""
    import shutil
    import socket
    t_phase = time.perf_counter()
    free_device_memory()
    shutil.rmtree(MESH16_DIR, ignore_errors=True)
    MESH16_DIR.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for r in range(2):
        f = open(MESH16_DIR / f"rank{r}.log", "w+")
        logs.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
             str(r), "--mesh-port", str(port), "--mesh-out",
             str(MESH16_DIR / f"rank{r}.json")],
            stdout=f, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + MESH16_TIMEOUT
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > deadline:
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    codes = [p.returncode for p in procs]
    for line in texts[0].splitlines():
        if line.startswith("  "):
            log(f"  [rank 0]{line}")
    if codes != [0, 0]:
        bad = next((i for i, c in enumerate(codes) if c != 0), 0)
        fail(f"phase 16: ranks exited {codes} (timeout {MESH16_TIMEOUT} s)"
             f"; rank {bad}'s last output:\n{texts[bad][-3000:]}")
    recs = [json.loads((MESH16_DIR / f"rank{r}.json").read_text())
            for r in range(2)]
    for arch in MESH16_RUNS:
        a, b = (rc["runs"][arch] for rc in recs)
        if [s["loss"] for s in a["steps"]] != [s["loss"] for s in b["steps"]]:
            fail(f"phase 16: {arch}'s ranks report different losses")
    if recs[0]["int8"]["vta_gemm_launches"] \
            != recs[1]["int8"]["vta_gemm_launches"]:
        fail("phase 16: the int8 ranks launched vta_gemm a different "
             "number of times")
    out = dict(rank0=recs[0], rank1_peak_gb={
        arch: recs[1]["runs"][arch]["peak_allocated_gb"]
        for arch in MESH16_RUNS}, rank1_idle={
        arch: recs[1]["runs"][arch]["profiled_step"]["idle_share"]
        for arch in MESH16_RUNS}, seconds=time.perf_counter() - t_phase)
    for arch in MESH16_RUNS:
        r0 = recs[0]["runs"][arch]
        log(f"  {arch}: peak allocated {r0['peak_allocated_gb']:.2f} / "
            f"{out['rank1_peak_gb'][arch]:.2f} GB, idle share "
            f"{r0['profiled_step']['idle_share']:.4f} / "
            f"{out['rank1_idle'][arch]:.4f} (rank 0 / rank 1)")
    rec["mesh16"] = out
    log(f"  phase 16 took {out['seconds']:.1f} s")
    shutil.rmtree(MESH16_DIR, ignore_errors=True)
    return out


# ----------------------------------------------------------------------
# phase 17: the dry run against the card
# ----------------------------------------------------------------------
#: the steps phase 17 predicts with the dry run: (arch, mesh shape (()
#: the meshless step), layers (None: the published depth)), each at phase
#: 14's B2 S4096, AdamW, no FSDP, as phases 14 and 16 train them
DRYRUN_CELLS = [(TRAIN_ARCH, (), None), ("zamba2-1.2b", (), None),
                (TRAIN_ARCH, MESH16_SHAPE, None),
                ("phi3.5-moe-42b-a6.6b", MESH16_SHAPE, 2)]
#: seconds the dry run's subprocess may take, and the largest relative
#: difference of a predicted peak from the measured one
DRYRUN_TIMEOUT = 60
DRYRUN_TOL = 0.10


def dryrun17_cells(out_path):
    """The dry run of DRYRUN_CELLS (run in a subprocess of phase 17, its
    own fake process group apart from phase 16's gloo one): each cell's
    predicted peak, arguments, five largest live tensors and live bytes
    by site at the peak, its roofline terms, as JSON to `out_path`."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    cells = []
    for arch, mesh_shape, layers in DRYRUN_CELLS:
        spec = get_arch(arch)
        ov = {"max_seq": max(spec.model.max_seq, TRAIN_SEQ),
              "sharding": spec.model.sharding}
        if layers:
            ov["n_layers"] = layers
        c = dryrun.run_cell(arch, "train_4k", False, overrides=ov,
                            mesh_shape=mesh_shape, fsdp=False,
                            shape_overrides={"global_batch": TRAIN_BATCH},
                            verbose=False)
        m = c["memory"]
        cells.append(dict(
            arch=arch, mesh=list(mesh_shape), layers=layers,
            trace_seconds=c["trace_seconds"],
            peak_gb=m["total_bytes_per_device"] / 1e9,
            argument_gb=m["argument_size_in_bytes"] / 1e9,
            peak_tensors=m["peak_tensors"][:5],
            peak_by_site=m["peak_by_site"][:5],
            terms_ms={k: c["roofline"][f"{k}_term_s"] * 1e3
                      for k in ("compute", "memory", "collective")},
            dot_flops=c["hlo"]["dot_flops_per_device"],
            collective_counts=c["hlo"]["collective_counts"]))
    Path(out_path).write_text(json.dumps(cells))
    return 0


def phase_dryrun17(rec, tr, m16_runs):
    """DRYRUN_CELLS through the dry run in a subprocess (dryrun17_cells,
    under DRYRUN_TIMEOUT), each predicted peak held within DRYRUN_TOL of
    the peak allocated bytes phase 14 (meshless) or phase 16 (rank 0)
    measured; logs the five largest live tensors at each predicted peak
    and the compute, memory and collective terms beside the measured step
    ms."""
    out_path = ROOT / "build" / "chip_smoke_dryrun.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-out",
             str(out_path)], env=env, capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"phase 17: the dry run took over {DRYRUN_TIMEOUT} s")
    if proc.returncode != 0:
        fail(f"phase 17: the dry run exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    cells = json.loads(out_path.read_text())
    out_path.unlink()
    measured = {(TRAIN_ARCH, ()): tr["llama"],
                ("zamba2-1.2b", ()): tr["zamba2-1.2b"]}
    for arch, r in m16_runs.items():
        measured[(arch, tuple(MESH16_SHAPE))] = r
    bad = []
    for c in cells:
        m = measured[(c["arch"], tuple(c["mesh"]))]
        c["measured_peak_gb"] = m["peak_allocated_gb"]
        c["measured_step_ms"] = m["step_ms_median"]
        c["rel_err"] = (c["peak_gb"] - m["peak_allocated_gb"]) \
            / m["peak_allocated_gb"]
        where = f"mesh {tuple(c['mesh'])}" if c["mesh"] else "meshless"
        log(f"  {c['arch']} ({where}"
            f"{', %d layers' % c['layers'] if c['layers'] else ''}): "
            f"predicted peak {c['peak_gb']:.2f} GB (arguments "
            f"{c['argument_gb']:.2f}), measured {m['peak_allocated_gb']:.2f}"
            f" GB: {100 * c['rel_err']:+.1f}% (limit "
            f"{100 * DRYRUN_TOL:.0f}%); terms compute "
            f"{c['terms_ms']['compute']:.1f} / memory "
            f"{c['terms_ms']['memory']:.1f} / collective "
            f"{c['terms_ms']['collective']:.1f} ms (H100 datasheet peaks) "
            f"beside the measured step {m['step_ms_median']:.1f} ms; traced "
            f"in {c['trace_seconds']:.1f} s")
        for t in c["peak_tensors"]:
            log(f"    largest live at the peak: {t['shape']} {t['dtype']} "
                f"{t['bytes'] / 1e9:.3f} GB made by {t['op']} at "
                f"{t['site']}")
        for t in c["peak_by_site"]:
            log(f"    live at the peak by site: {t['bytes'] / 1e9:.3f} GB "
                f"in {t['tensors']} tensors, {t['op']} at {t['site']}")
        if abs(c["rel_err"]) > DRYRUN_TOL:
            bad.append(c)
    rec["dryrun17"] = dict(cells=cells,
                           seconds=time.perf_counter() - t0)
    log(f"  phase 17 took {rec['dryrun17']['seconds']:.1f} s")
    if bad:
        fail(f"phase 17: predicted peaks off by more than "
             f"{100 * DRYRUN_TOL:.0f}%: " + "; ".join(
                 f"{c['arch']} {c['mesh']}: {c['peak_gb']:.2f} vs "
                 f"{c['measured_peak_gb']:.2f} GB" for c in bad))


def ptxas_report(text):
    """Per kernel instance in one nvcc -Xptxas -v log: its demangled-ish
    name (the template arguments kept), registers, spill bytes and static
    shared memory (dynamic shared memory is set at launch)."""
    import re
    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            core = re.search(r"(\d+)([a-z_]+_kernel[A-Za-z_]*)(I.*?E)?E?v",
                             name)
            cur = dict(function=(core.group(2) + (core.group(3) or ""))
                       if core else name, registers=None, spill_stores=None,
                       spill_loads=None, static_smem=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem"] = int(m.group(1))
    return out


class Counters:
    """The launch counts of the six kernels (tensor_alu's two instances
    apart), and the shapes each launched
    (quantized_linear's fused calls by (M, N, K, x dtype) as well): reset
    to 0 just before a main path runs, read just after."""

    def __init__(self):
        from repro_torch.kernels.decode_attention import decode_attention
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.gla_chunk import gla_chunk
        from repro_torch.kernels.lut_gemm import lut_gemm
        from repro_torch.kernels.tensor_alu import (tensor_alu,
                                                    tensor_alu_scatter)
        from repro_torch.kernels.vta_gemm import quantized_linear, vta_gemm
        self.ops = {"vta_gemm": vta_gemm, "tensor_alu": tensor_alu,
                    "tensor_alu_scatter": tensor_alu_scatter,
                    "lut_gemm": lut_gemm,
                    "decode_attention": decode_attention,
                    "flash_attention": flash_attention,
                    "gla_chunk": gla_chunk}
        self.shaped = dict(self.ops, quantized_linear=quantized_linear)
        self.clear_shapes()

    def clear_shapes(self):
        self.shapes = {k: {} for k in self.shaped}

    def reset(self):
        for op in self.ops.values():
            op.launches = 0
        for op in self.shaped.values():
            op.shapes.clear()

    def read(self):
        for k, op in self.shaped.items():
            for shape, n in op.shapes.items():
                self.shapes[k][shape] = self.shapes[k].get(shape, 0) + n
        return {k: op.launches for k, op in self.ops.items()}


def main():
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", type=Path, default=None,
                    help="write the detailed record to this JSON file")
    # phase 16 starts this script once a rank with these
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", type=Path, default=None,
                    help=argparse.SUPPRESS)
    # phase 17 starts this script once with this (the dry run alone)
    ap.add_argument("--dryrun-out", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    # the allocator maps and unmaps pages of one growing segment, so a
    # small tensor left behind cannot pin a freed model's whole segment:
    # phase 12's phi3.5-moe needs 82.4 of the card's 85.0 GB after
    # phases 1-11 have come and gone (read before torch touches the card)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs only on the "
              "card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside the script: "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.mesh_rank is not None:
        return mesh16_rank(args.mesh_rank, args.mesh_port, args.mesh_out)
    if args.dryrun_out is not None:
        return dryrun17_cells(args.dryrun_out)
    from repro_torch.kernels import _build
    from repro_torch.kernels.tensor_alu import tensor_alu, tensor_alu_scatter
    from repro_torch.kernels.vta_gemm import vta_gemm

    rec = {"layers": []}
    # ---- phase 0: card and build --------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: no output"
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: card {name}; nvidia-smi: {card_line}")
    rec["card"] = dict(name=name, nvidia_smi=card_line,
                       torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per kernel: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                      sorted(secs.items())) + ")")
    ptxas = {k: ptxas_report(v) for k, v in _build.BUILD_LOGS.items()}
    for k, fns in sorted(ptxas.items()):
        log(f"  {k}: " + "; ".join(
            f"{f['function']}: {f['registers']} registers, "
            f"{f['spill_stores']}/{f['spill_loads']} bytes spilled "
            f"(stores/loads), {f['static_smem']} bytes static smem"
            for f in fns))
    rec["build"] = dict(seconds=secs, logs=_build.BUILD_LOGS, ptxas=ptxas)

    # ---- phase 2: the main path (counts from 0) ------------------------
    log("phase 2: the slice at full width (pynq spec, torch_device=cuda, "
        "backend=cuda)")
    main_ops = {"vta_gemm": vta_gemm, "tensor_alu": tensor_alu,
                "tensor_alu_scatter": tensor_alu_scatter}
    for op in main_ops.values():
        op.launches = 0
        op.shapes.clear()
    t_main = time.perf_counter()
    phase_layers(rec)
    phase_block(rec)
    phase_chain(rec)
    phase_vector(rec)
    main_launches = {k: op.launches for k, op in main_ops.items()}
    gemm_shapes = dict(vta_gemm.shapes)
    alu_shapes = dict(tensor_alu.shapes)
    scatter_shapes = dict(tensor_alu_scatter.shapes)
    rec["main_path"] = dict(seconds=time.perf_counter() - t_main,
                            launches=main_launches)
    log(f"  main path launches: {main_launches}")
    for k, n in main_launches.items():
        if n <= 0:
            fail(f"{k} was never launched on the main path")
    content_key_cost(rec)
    request_profile(rec)

    # ---- phase 5: the decode path (counts from 0) ------------------------
    log("phase 5: the quantized decoder served (DevicePool, cuda engine)")
    counters = Counters()
    dec4, c4 = phase_decode_int4(rec, counters)
    decode_launches = rec["decode_int4"]["launches"]
    lut_shapes = dict(counters.shapes["lut_gemm"])
    attn_shapes = dict(counters.shapes["decode_attention"])
    phase_decode_int8(rec, counters)

    # ---- phase 6: scheduler, chaos, VtaLinear, decode profile -----------
    log("phase 6: Scheduler, chaos, VtaLinear, one profiled decode step")
    counters.reset()
    phase_sched(rec, dec4, c4)
    phase_chaos(rec, dec4, c4)
    phase_vta_linear(rec)
    decode_step_profile(rec, dec4, c4)
    counters.read()
    del dec4, c4        # the decoder's device image: phase 12 needs the room

    # every shape a decode or phase-6 path launched that the sets above
    # lack is held against the plain version too (count 0: checked, not
    # timed), so each kernel is checked at every shape any path launched
    checked = {}
    for k, main in (("vta_gemm", gemm_shapes), ("tensor_alu", alu_shapes),
                    ("tensor_alu_scatter", scatter_shapes),
                    ("lut_gemm", lut_shapes),
                    ("decode_attention", attn_shapes)):
        more = [sh for sh in counters.shapes[k] if sh not in main]
        main.update((sh, 0) for sh in more)
        checked[k] = dict(decode_and_phase6_shapes=len(counters.shapes[k]),
                          added=[list(sh) for sh in more])
        log(f"  {k}: {len(counters.shapes[k])} shapes on the decode and "
            f"phase-6 paths, {len(more)} not in the timed set: checked "
            f"against the plain version as well")
    rec["shapes_checked"] = checked

    # ---- phase 8: the LM serve path (counts from 0 before each run) ------
    log("phase 8: the LM serve path (llama3.2-3b at full width, int8 PTQ "
        "and bf16 weights, ServeEngine)")
    counters.clear_shapes()
    lm = phase_lm(rec, counters)
    lm_launches = lm["int8"]["launches"]
    for k in ("flash_attention", "decode_attention", "vta_gemm"):
        if lm_launches[k] <= 0:
            fail(f"{k} was never launched on the LM serve path")
    decoder_attn = {sh for sh, n in attn_shapes.items() if n > 0}
    # the LM path's shapes are timed in phases 1 and 7 (their counts > 0)
    for main_set, k in ((gemm_shapes, "vta_gemm"),
                        (attn_shapes, "decode_attention")):
        for sh, n in counters.shapes[k].items():
            main_set[sh] = main_set.get(sh, 0) + n
    flash_shapes = dict(counters.shapes["flash_attention"])
    ql_shapes = dict(counters.shapes["quantized_linear"])
    lm_flash = set(flash_shapes)
    rec["lm_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                        for k, v in counters.shapes.items()}

    # ---- phase 9: the hybrid serve path (counts from 0 before each run) --
    log("phase 9: the hybrid serve path (zamba2-1.2b at full width, int8 "
        "PTQ and bf16 weights, ServeEngine)")
    counters.clear_shapes()
    hy = phase_hybrid(rec, counters)
    hy_runs = {name: hy[name]["launches"]
               for name in ("int8", "int8_long", "bf16", "f32")}
    hy_launches = {k: sum(r[k] for r in hy_runs.values())
                   for k in counters.ops}
    for k in ("gla_chunk", "flash_attention", "decode_attention",
              "vta_gemm"):
        if hy_launches[k] <= 0:
            fail(f"{k} was never launched on the hybrid serve path")
    # the hybrid path's shapes are timed in phases 1 and 7 too
    for main_set, k in ((gemm_shapes, "vta_gemm"),
                        (attn_shapes, "decode_attention"),
                        (flash_shapes, "flash_attention"),
                        (ql_shapes, "quantized_linear")):
        for sh, n in counters.shapes[k].items():
            main_set[sh] = main_set.get(sh, 0) + n
    gla_shapes = dict(counters.shapes["gla_chunk"])
    rec["hybrid_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                            for k, v in counters.shapes.items()}

    # ---- phase 10: the autotuner on the card (counts from 0) ------------
    log("phase 10: the autotuner on the card (search on the CUDA engine, "
        "stage 1 against CPU tensors)")
    counters.clear_shapes()
    at_launches = phase_autotune(rec, counters)
    # every engine shape the search launched under its candidates'
    # geometries is held to the plain version in phase 1 too (count 0:
    # checked, not timed), as the decode and phase-6 shapes are
    added = {}
    for main_set, k in ((gemm_shapes, "vta_gemm"), (alu_shapes, "tensor_alu"),
                        (scatter_shapes, "tensor_alu_scatter")):
        more = [sh for sh in counters.shapes[k] if sh not in main_set]
        main_set.update((sh, 0) for sh in more)
        added[k] = len(more)
        log(f"  {k}: {len(counters.shapes[k])} shapes launched by the "
            f"search, {len(more)} new: checked against the plain version "
            f"in phase 1")
    rec["autotune_shapes"] = dict(
        added=added, shapes={k: [list(sh) + [n] for sh, n in v.items()]
                             for k, v in counters.shapes.items() if v})

    # ---- phase 11: xlstm-1.3b served (counts from 0 before each run) -----
    log("phase 11: xlstm-1.3b served (full width, int8 PTQ and bf16 "
        "weights, ServeEngine)")
    counters.clear_shapes()
    xl = phase_xlstm(rec, counters)
    xl_runs = {name: xl[name]["launches"]
               for name in ("int8", "int8_long", "bf16", "f32")}
    xl_launches = {k: sum(r[k] for r in xl_runs.values())
                   for k in counters.ops}
    for k in ("gla_chunk", "vta_gemm"):
        if xl_launches[k] <= 0:
            fail(f"{k} was never launched on the xlstm serve path")
    # the xlstm path's shapes are timed in phases 1 and 7 too
    for main_set, k in ((gemm_shapes, "vta_gemm"),
                        (ql_shapes, "quantized_linear")):
        for sh, n in counters.shapes[k].items():
            main_set[sh] = main_set.get(sh, 0) + n
    xlstm_gla_shapes = dict(counters.shapes["gla_chunk"])
    rec["xlstm_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                           for k, v in counters.shapes.items()}

    # ---- phase 12: the moe models served (counts from 0 before each run) -
    log("phase 12: the moe models served (phi3.5-moe at full width, int8 "
        "PTQ, bf16 and float32; kimi-k2 at full width cut to "
        f"{KIMI_LAYERS} layers, int8 PTQ; ServeEngine)")
    counters.clear_shapes()
    moe = phase_moe(rec, counters)
    moe_runs = {name: r for name, r in moe.items()
                if isinstance(r, dict) and "launches" in r}
    moe_launches = {k: sum(r["launches"][k] for r in moe_runs.values())
                    for k in counters.ops}
    for k in ("flash_attention", "decode_attention", "vta_gemm"):
        if moe_launches[k] <= 0:
            fail(f"{k} was never launched on the moe serve path")
    # the moe path's shapes are timed in phases 1 and 7 too
    for main_set, k in ((gemm_shapes, "vta_gemm"),
                        (attn_shapes, "decode_attention"),
                        (flash_shapes, "flash_attention"),
                        (ql_shapes, "quantized_linear")):
        for sh, n in counters.shapes[k].items():
            main_set[sh] = main_set.get(sh, 0) + n
    rec["moe_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                         for k, v in counters.shapes.items()}

    # ---- phase 13: whisper and phi-3-vision (counts from 0 before each
    # run) -------------------------------------------------------------
    log("phase 13: the encoder-decoder and vision paths (whisper-large-v3 "
        "and phi-3-vision-4.2b at full width and depth, int8 PTQ, bf16 and "
        "float32; T.prefill / T.decode_step, and ServeEngine)")
    counters.clear_shapes()
    ed = phase_encdec(rec, counters)
    ed_runs = {name: r for name, r in ed.items()
               if isinstance(r, dict) and "launches" in r}
    ed_launches = {k: sum(r["launches"][k] for r in ed_runs.values())
                   for k in counters.ops}
    for k in ("flash_attention", "decode_attention", "vta_gemm"):
        if ed_launches[k] <= 0:
            fail(f"{k} was never launched on the encoder-decoder and vision "
                 f"paths")
    # their shapes are timed in phases 1 and 7 too
    for main_set, k in ((gemm_shapes, "vta_gemm"),
                        (attn_shapes, "decode_attention"),
                        (flash_shapes, "flash_attention"),
                        (ql_shapes, "quantized_linear")):
        for sh, n in counters.shapes[k].items():
            main_set[sh] = main_set.get(sh, 0) + n
    rec["encdec_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                            for k, v in counters.shapes.items()}

    # ---- phase 14: training (counts from 0 before the run) --------------
    log("phase 14: training (llama3.2-3b, zamba2-1.2b and xlstm-1.3b at "
        f"full width, xlstm at 24 of 48 layers, bf16 and AdamW, "
        f"B{TRAIN_BATCH} "
        f"S{TRAIN_SEQ}, Trainer), float32 replays, checkpoint round trips, "
        "and the flash and gla_chunk backward kernels")
    free_device_memory()
    counters.clear_shapes()
    tr, fb_shapes, gb_rows, gb_err = phase_train(rec, counters)
    train_launches = tr["llama"]["launches"]
    if train_launches["flash_attention"] <= 0 \
            or tr["llama"]["bwd_launches"] <= 0:
        fail("the flash kernels were never launched on the training path")
    for arch in RECURRENT_TRAIN:
        if tr[arch]["launches"]["gla_chunk"] <= 0 \
                or tr[arch]["gla_bwd_launches"] <= 0:
            fail(f"the gla_chunk kernels were never launched training "
                 f"{arch}")
    # its forward shapes are timed in phase 7 too
    for sh, n in counters.shapes["flash_attention"].items():
        flash_shapes[sh] = flash_shapes.get(sh, 0) + n
    train_gla_shapes = dict(counters.shapes["gla_chunk"])
    rec["train_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                           for k, v in counters.shapes.items()}

    # ---- phase 15: the examples and the mesh path (counts from 0 before
    # each run) --------------------------------------------------------
    log("phase 15: the port's examples on the card (quickstart, "
        "resnet18_offload C12 and C9, serve_lm), then llama3.2-3b and "
        "zamba2-1.2b trained through Trainer(mesh=(1, 1) data x model, "
        "fsdp=True) on a one-rank nccl group against the meshless Trainer, "
        "and compressed_mean_local")
    free_device_memory()
    counters.clear_shapes()
    mesh = phase_mesh(rec, counters)
    ex_launches = mesh["example_launches"]
    mesh_runs = {arch: mesh[arch]["mesh_fsdp"] for arch in MESH_TRAIN}
    # every shape the examples launched is held to the plain version in
    # phases 1 and 7 as well (count 0: checked, not timed)
    for main_set, k in ((gemm_shapes, "vta_gemm"), (alu_shapes, "tensor_alu"),
                        (scatter_shapes, "tensor_alu_scatter"),
                        (lut_shapes, "lut_gemm"),
                        (attn_shapes, "decode_attention")):
        for sh in counters.shapes[k]:
            main_set.setdefault(sh, 0)
    for sh, n in counters.shapes["flash_attention"].items():
        flash_shapes[sh] = flash_shapes.get(sh, 0) + n
    for sh, n in counters.shapes["gla_chunk"].items():
        train_gla_shapes[sh] = train_gla_shapes.get(sh, 0) + n
    rec["mesh_shapes"] = {k: [list(sh) + [n] for sh, n in v.items()]
                          for k, v in counters.shapes.items()}

    # ---- phase 16: tensor and expert parallelism (each rank's counts
    # from 0 before each run) --------------------------------------------
    log("phase 16: llama3.2-3b (tensor-parallel) and phi3.5-moe at 2 layers "
        "(expert-parallel) trained at full width through "
        "Trainer(mesh=(1, 2) data x model) on two gloo ranks of this card, "
        "the float32 replays against the meshless Trainer")
    m16 = phase_mesh16(rec)
    m16_runs = m16["rank0"]["runs"]
    # the int8 run's tensor-parallel local shapes: held to the plain chain
    # in phase 1 (count 0: checked, not timed), with a given x_scale too
    tp_ql_shapes = {tuple(sh[:4]) for sh in
                    m16["rank0"]["int8"]["quantized_linear_shapes"]}
    for sh in tp_ql_shapes:
        ql_shapes.setdefault(sh, 0)
    for r in m16_runs.values():
        # the local shapes: forward timed in phase 7, backward below
        for *sh, n in r["fwd_shapes"]:
            flash_shapes[tuple(sh)] = flash_shapes.get(tuple(sh), 0) + n
        for *sh, n in r["bwd_shapes"]:
            fb_shapes[tuple(sh)] = fb_shapes.get(tuple(sh), 0) + n

    # ---- phase 17: the dry run's predicted peaks against phases 14, 16 --
    log("phase 17: the dry run (launch/dryrun.py on the meta device, no "
        "card) of phase 14's and 16's steps, against their measured "
        "peaks")
    phase_dryrun17(rec, tr, m16_runs)
    fb_rows, fb_err = phase_flash_bwd_kernel(rec, fb_shapes)

    # ---- phase 1: kernels against plain versions ------------------------
    log("phase 1: kernels against their plain versions, on the card")
    g_rows, g_err = phase_gemm_kernel(rec, gemm_shapes)
    q_rows = phase_qlinear_kernel(rec, ql_shapes, given=tp_ql_shapes)
    a_rows, a_err = phase_alu_kernel(rec, alu_shapes)
    sc_rows, sc_err = phase_scatter_kernel(rec, scatter_shapes)
    log("phase 7: the decode-path, LM-path and hybrid-path kernels against "
        "their plain versions")
    l_rows, l_err = phase_lut_kernel(rec, lut_shapes)
    d_rows, d_err = phase_attn_kernel(rec, attn_shapes)
    f_rows, f_err = phase_flash_kernel(rec, flash_shapes)
    s_rows, s_err = phase_gla_kernel(rec, gla_shapes, xlstm_gla_shapes,
                                     train_gla_shapes)

    # ---- phase 3: engines against each other ----------------------------
    log("phase 3: the engines against each other")
    phase_engines(rec)

    # ---- phase 4: the kernels line --------------------------------------
    # the line reports each kernel at its heaviest main-path shape: for
    # vta_gemm the LM linear with the most weight bytes (the most launched
    # of those), with the instance it ran and its fused quantized_linear
    # call; every shape is in the record
    g = max((r for r in g_rows if r["epilogue"] == "dequant"),
            key=lambda r: (r["N"] * r["K"], r["launches"]))
    gq = [r for r in q_rows if (r["M"], r["N"], r["K"]) ==
          (g["M"], g["N"], g["K"])]
    a = max(a_rows, key=lambda r: r["launches"] * r["shape"][0]
            * r["shape"][1])
    sc = max((r for r in sc_rows if r["timed"]),
             key=lambda r: (r["launches"], r["T"] * r["R"] * r["C"]))
    kernels = [
        dict(name="vta_gemm", route="cuda",
             source="src/repro_torch/kernels/vta_gemm/csrc/" + (
                 "vta_gemm.cu" if g["instance"] == "skinny"
                 else "vta_wgmma.cu"),
             sources=["src/repro_torch/kernels/vta_gemm/csrc/vta_gemm.cu",
                      "src/repro_torch/kernels/vta_gemm/csrc/vta_wgmma.cu"],
             replaces="src/repro/kernels/vta_gemm/kernel.py:72",
             launches=main_launches["vta_gemm"],
             lm_serve_launches=lm_launches["vta_gemm"],
             hybrid_serve_launches=hy_launches["vta_gemm"],
             autotune_launches=at_launches["vta_gemm"],
             xlstm_serve_launches=xl_launches["vta_gemm"],
             moe_serve_launches=moe_launches["vta_gemm"],
             encdec_serve_launches=ed_launches["vta_gemm"],
             max_abs_err=g_err,
             ms=g["ms"], call_ms=g["call_ms"], plain_ms=g["plain_ms"],
             bound_ms=g["bound_ms"],
             bound_by=g["bound_by"], library_ms=g["library_ms"],
             library_what=g["library_what"], checked=True,
             instance=g["instance"],
             quantized_linear_call_ms=gq[0]["call_ms"] if gq else None,
             quantized_linear_chain_call_ms=gq[0]["chain_call_ms"]
             if gq else None,
             shape=dict(T=g["T"], M=g["M"], N=g["N"], K=g["K"],
                        epilogue=g["epilogue"])),
        dict(name="tensor_alu", route="cuda",
             source="src/repro_torch/kernels/tensor_alu/csrc/tensor_alu.cu",
             replaces="src/repro/kernels/tensor_alu/kernel.py:50",
             launches=main_launches["tensor_alu"], max_abs_err=a_err,
             ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
             bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], library_ms=a["library_ms"],
             checked=True, instance="standalone",
             shape=dict(shape=a["shape"], chain=a["chain"])),
        dict(name="tensor_alu_scatter", route="cuda",
             source="src/repro_torch/kernels/tensor_alu/csrc/tensor_alu.cu",
             replaces="src/repro/kernels/tensor_alu/kernel.py:50",
             launches=main_launches["tensor_alu_scatter"],
             autotune_launches=at_launches["tensor_alu_scatter"],
             max_abs_err=sc_err, ms=sc["ms"], call_ms=sc["call_ms"],
             plain_ms=sc["plain_ms"], bound_ms=sc["bound_ms"],
             bound_by=sc["bound_by"], library_ms=None, checked=True,
             instance="scatter",
             shape={k: sc[k] for k in ("T", "R", "C", "groups",
                                       "map_entries", "src_dtype",
                                       "tensor_operand", "chain")}),
    ]
    # the decode-path kernels at their heaviest decode-path shape; the
    # Llama-3.2-3B shapes are in the record and on the lines above
    lg = max((r for r in l_rows if r["decode_path"]),
             key=lambda r: r["T"] * r["M"] * r["N"] * r["K"])
    dg = max((r for r in d_rows if (r["B"], r["S"], r["HQ"], r["KH"], r["D"],
                                    r["dtype"], r["cache_dtype"])
              in decoder_attn),
             key=lambda r: r["B"] * r["KH"] * r["kv_len"] * r["D"])
    kernels += [
        dict(name="lut_gemm", route="cuda",
             source="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm.cu",
             replaces="src/repro/kernels/lut_gemm/kernel.py:81",
             launches=decode_launches["lut_gemm"], max_abs_err=l_err,
             ms=lg["ms"], call_ms=lg["call_ms"], plain_ms=lg["plain_ms"],
             bound_ms=lg["bound_ms"], bound_by=lg["bound_by"],
             library_ms=lg["library_ms"], checked=True,
             shape=dict(T=lg["T"], M=lg["M"], N=lg["N"], K=lg["K"],
                        bits=lg["bits"], group=lg["group"],
                        epilogue=lg["epilogue"])),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/decode_attention/csrc/"
                    "decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:67",
             launches=decode_launches["decode_attention"],
             lm_serve_launches=lm_launches["decode_attention"],
             hybrid_serve_launches=hy_launches["decode_attention"],
             moe_serve_launches=moe_launches["decode_attention"],
             encdec_serve_launches=ed_launches["decode_attention"],
             max_abs_err=d_err["float32"],
             max_abs_err_bf16=d_err["bfloat16"],
             ms=dg["ms"], call_ms=dg["call_ms"], plain_ms=dg["plain_ms"],
             bound_ms=dg["bound_ms"], bound_by=dg["bound_by"],
             library_ms=dg["library_ms"], checked=True,
             shape=dict(B=dg["B"], S=dg["S"], HQ=dg["HQ"], KH=dg["KH"],
                        D=dg["D"], dtype=dg["dtype"],
                        kv_len=dg["kv_len"])),
    ]
    # flash_attention's two kernels, each at its heaviest main-path shape:
    # the bf16 wgmma kernel at phase 8's (the Llama prefill), the float32
    # 3xTF32 kernel at phase 9's float32 run; the Llama prefill shapes (S 4096
    # and 32768) and every other shape are in the record and on the lines
    # above
    hy_summaries = [hy[n] for n in hy_runs]
    for dt, run, src in (("bfloat16", lm["int8"], "flash_wgmma.cu"),
                         ("float32", hy["f32"], "flash_tf32x3.cu")):
        n_main = run["flash_by_dtype"].get(dt, 0)
        if n_main <= 0:
            fail(f"the {dt} flash_attention kernel was never launched on "
                 f"its main path")
        fg = max((r for r in f_rows if r.get("lm_path")
                  and r["dtype"] == dt and (dt == "float32" or (
                      r["B"], r["S"], r["Sk"], r["HQ"], r["KH"], r["D"],
                      r["causal"], r["dtype"]) in lm_flash)),
                 key=lambda r: r["B"] * r["HQ"] * r["S"] * r["Sk"])
        kernels.append(dict(
            name="flash_attention" if dt == "bfloat16"
            else "flash_attention_f32", route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/" + src,
            replaces="src/repro/kernels/flash_attention/kernel.py:76",
            kernel=FLASH_KERNEL_NAMES[dt], dtype=dt, launches=n_main,
            instance="wgmma" if dt == "bfloat16" else "tf32x3",
            hybrid_serve_launches=sum(h["flash_by_dtype"].get(dt, 0)
                                      for h in hy_summaries),
            moe_serve_launches=sum(r["flash_by_dtype"].get(dt, 0)
                                   for r in moe_runs.values()),
            # the mixed-dtype route ("bfloat16/float32") runs the 3xTF32
            # kernel
            encdec_serve_launches=sum(
                n for r in ed_runs.values()
                for key, n in r["flash_by_dtype"].items()
                if (key == "bfloat16") == (dt == "bfloat16")),
            max_abs_err=f_err[dt],
            **({} if dt == "bfloat16" else dict(
                max_abs_err_mixed_dtype=f_err.get("bfloat16/float32"))),
            ms=fg["ms"], call_ms=fg["call_ms"], plain_ms=fg["plain_ms"],
            bound_ms=fg["bound_ms"], bound_by=fg["bound_by"],
            library_ms=fg["library_ms"], checked=True,
            shape={k: fg[k] for k in ("B", "S", "Sk", "HQ", "KH", "D",
                                       "causal", "dtype")}))
    # gla_chunk at its heaviest hybrid-path shape; zamba2's prefill at S
    # 4096 and 32768 is in the record and on the lines above
    sg = max((r for r in s_rows if r.get("hybrid_path")),
             key=lambda r: r["B"] * r["H"] * r["S"])
    kernels.append(dict(
        name="gla_chunk", route="cuda",
        source="src/repro_torch/kernels/gla_chunk/csrc/gla_chunk.cu",
        replaces="src/repro/kernels/gla_chunk/kernel.py:73",
        launches=hy_launches["gla_chunk"], launches_by_run={
            k: v["gla_chunk"] for k, v in hy_runs.items()},
        xlstm_serve_launches=xl_launches["gla_chunk"],
        xlstm_launches_by_run={k: v["gla_chunk"]
                               for k, v in xl_runs.items()},
        train_launches={a: tr[a]["launches"]["gla_chunk"]
                        for a in RECURRENT_TRAIN},
        max_abs_err=s_err, ms=sg["ms"], call_ms=sg["call_ms"],
        plain_ms=sg["plain_ms"], bound_ms=sg["bound_ms"],
        bound_by=sg["bound_by"], library_ms=None, checked=True,
        shape={k: sg[k] for k in ("B", "S", "H", "N", "P", "chunk",
                                   "qk_dtype", "heads_broadcast")}))
    # the flash backward at the training path's shape (Llama-3.2-3B's
    # train_4k); every checked shape is in the record and on the lines above
    fb = next(r for r in fb_rows if (r["B"], r["S"], r["Sk"], r["HQ"],
                                     r["KH"], r["D"], r["causal"],
                                     r["dtype"]) == FLASH_BWD_CASES[0])
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
        replaces="src/repro/kernels/flash_attention/ref.py:18",
        replaces_what="no TPU kernel: jax.value_and_grad of the reference's "
                      "attention_ref (src/repro/launch/train.py:46)",
        kernel="flash_bwd", dtype="bfloat16",
        launches=tr["llama"]["bwd_launches"],
        max_abs_err=fb_err["bfloat16"], max_abs_err_f32=fb_err["float32"],
        ms=fb["ms"], call_ms=fb["call_ms"], plain_ms=fb["plain_ms"],
        bound_ms=fb["bound_ms"], bound_by=fb["bound_by"],
        library_ms=fb["library_ms"],
        library_what="scaled_dot_product_attention's backward alone",
        checked=True,
        shape={k: fb[k] for k in ("B", "S", "Sk", "HQ", "KH", "D", "causal",
                                   "dtype")}))
    # the gla_chunk backward at zamba2-1.2b's training shape; every checked
    # shape is in the record and on the lines above
    gb = next(r for r in gb_rows if (
        r["B"], r["S"], r["H"], r["N"], r["P"], r["chunk"], r["qk_dtype"],
        r["qk_heads"], r["state"]) == GLA_BWD_CASES[0])
    kernels.append(dict(
        name="gla_chunk_bwd", route="cuda",
        source="src/repro_torch/kernels/gla_chunk/csrc/gla_bwd.cu",
        replaces="src/repro/models/ssm.py:31",
        replaces_what="no TPU kernel: jax.value_and_grad of the reference's "
                      "chunked_gla (src/repro/launch/train.py:46); the "
                      "forward's TPU kernel is "
                      "src/repro/kernels/gla_chunk/kernel.py:73",
        kernel="gla_bwd", launches=tr["zamba2-1.2b"]["gla_bwd_launches"],
        xlstm_train_launches=tr["xlstm-1.3b"]["gla_bwd_launches"],
        max_abs_err=gb_err, ms=gb["ms"], call_ms=gb["call_ms"],
        plain_ms=gb["plain_ms"], bound_ms=gb["bound_ms"],
        bound_by=gb["bound_by"], library_ms=None, checked=True,
        shape={k: gb[k] for k in ("B", "S", "H", "N", "P", "chunk",
                                   "qk_dtype", "qk_heads")}))
    # the wide kernel (D above 128): no config launches it; each of its
    # timed shapes is in the record and on the lines above, the line
    # reports D 256 in bfloat16
    fw = next(r for r in f_rows if r.get("kernel") == FLASH_WIDE_NAME
              and r["D"] == 256 and r["dtype"] == "bfloat16")
    bw = next(r for r in fb_rows if r["D"] > FLASH_MAX_D
              and r["dtype"] == "bfloat16")
    wide_src = "src/repro_torch/kernels/flash_attention/csrc/flash_wide.cu"
    kernels += [
        dict(name="flash_attention_wide", route="cuda", source=wide_src,
             replaces="src/repro/kernels/flash_attention/kernel.py:76",
             kernel=FLASH_WIDE_NAME, launches=0,
             max_abs_err=max(r["max_abs_err"] for r in f_rows
                             if r.get("kernel") == FLASH_WIDE_NAME),
             ms=fw["ms"], call_ms=fw["call_ms"], plain_ms=fw["plain_ms"],
             bound_ms=fw["bound_ms"], bound_by=fw["bound_by"],
             library_ms=fw["library_ms"], checked=True,
             shape={k: fw[k] for k in ("B", "S", "Sk", "HQ", "KH", "D",
                                        "causal", "dtype")}),
        dict(name="flash_attention_wide_bwd", route="cuda", source=wide_src,
             replaces="src/repro/kernels/flash_attention/ref.py:18",
             replaces_what="no TPU kernel: jax.value_and_grad of the "
                           "reference's attention_ref",
             kernel=FLASH_WIDE_BWD_NAME, launches=0,
             max_abs_err=bw["err_vs_plain"], ms=bw["ms"],
             call_ms=bw["call_ms"], plain_ms=bw["plain_ms"],
             bound_ms=bw["bound_ms"], bound_by=bw["bound_by"],
             library_ms=bw["library_ms"],
             library_what="scaled_dot_product_attention's backward alone",
             checked=True,
             shape={k: bw[k] for k in ("B", "S", "Sk", "HQ", "KH", "D",
                                        "causal", "dtype")}),
    ]
    for kern in kernels:
        if kern["name"] in ("flash_attention", "flash_attention_bwd"):
            key = "flash_fwd" if kern["name"] == "flash_attention" \
                else "flash_bwd"
            kern["mesh16_train_launches"] = {
                a: sum(st[key] for st in r["steps"])
                for a, r in m16_runs.items()}
        if kern["name"] == "flash_attention":
            kern["train_launches"] = train_launches["flash_attention"]
            kern["zamba2_train_launches"] = \
                tr["zamba2-1.2b"]["launches"]["flash_attention"]
            kern["mesh_train_launches"] = {
                a: r["train_launches"]["flash_fwd"]
                for a, r in mesh_runs.items()}
        if kern["name"] == "flash_attention_bwd":
            kern["zamba2_train_launches"] = \
                tr["zamba2-1.2b"]["flash_bwd_launches"]
            kern["mesh_train_launches"] = {
                a: r["train_launches"]["flash_bwd"]
                for a, r in mesh_runs.items()}
        if kern["name"] in ("gla_chunk", "gla_chunk_bwd"):
            key = "gla_fwd" if kern["name"] == "gla_chunk" else "gla_bwd"
            kern["mesh_train_launches"] = {
                a: r["train_launches"][key] for a, r in mesh_runs.items()}
        if kern["name"] in ex_launches:
            kern["examples_launches"] = ex_launches[kern["name"]]
    rec["profiler_retries"] = PROFILER_RETRIES
    rec["profiler_drops"] = PROFILER_DROPS
    rec["profiler_fallbacks"] = PROFILER_FALLBACKS
    log(f"profiler windows taken again: {len(PROFILER_RETRIES)}; windows "
        f"with lost launch records: {len(PROFILER_DROPS)}; kernel times "
        f"from CUDA events for want of any record: "
        f"{PROFILER_FALLBACKS or 'none'}")
    rec["script_seconds"] = time.perf_counter() - t_script
    log(f"the whole script took {rec['script_seconds']:.1f} s")
    if args.record is not None:
        rec["kernels"] = kernels
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(rec, indent=1, default=str))
        log(f"record written to {args.record}")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
