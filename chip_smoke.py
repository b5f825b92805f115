#!/usr/bin/env python3
"""Smoke run of sageattention_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --profile  # and device time by kernel of one
                                     # step of each server, one training
                                     # step and one LLM decode step

Phases, each of which raises (and so exits non-zero) when it fails:

1. card and build: the card's name and power limit, the torch and CUDA
   versions, and every kernel built from ``sageattention_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) into ``build/``; every
   instance's registers and stack, none in the TMA-fed ``wgmma`` ones, and
   every forward instance (kernel 1 at head dims 64-512, with masks and
   without, default and pre-quantized Q: all ``wgmma``) holding warpgroup
   MMA and no ``mma.sync`` in their SASS;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (the V quantizers for int8, e4m3 and
   e5m2 codes, kernel 5's smooth-v mean also against the sum in its
   plan's order, bit for bit; then, each from a generator of its own,
   kernel 3 at d 64-512, bf16 and fp32 K, 8 and 4 bits, with km and
   without, at a ragged (4, 16, 4001, d) and fp32 at the CogVideoX-2B
   layer, and kernel 5 on fp32 V, at d 384 and 512 and on slabs of exactly
   4 MB, two smooth-v calls bit-identical; the forward kernel for every V type with and without the
   smooth-v mean, and its ``wgmma`` instances where TMA is likeliest to
   break: sk 513 and 3001 with sq 1000 at head dims 64-256, causal and not,
   every V type, and the pre-quantized ones at 3001 with per-row K scales
   and a column bias; the decode kernels 9-12 for int8 and int4 caches, t_q
   1, 4 and 512, ragged lengths, window 4096, pages of 16 and 1024), and
   the ops' outputs and gradients against exact fp32 attention; then the
   masked forward kernel at the llm-8b-gqa layer (32/8 heads of 128):
   ``sageattn_varlen`` over four causal prompts of 4096, 2048, 1536 and
   512 tokens, and at 4096 tokens a padding mask with dead rows, an
   ALiBi bias (causal and not), non-contiguous segment ids and zig-zag
   positions, each against its plain version, against exact attention on
   the live rows, and with dead rows exactly 0 and LSE -inf; and the
   windowed backward (window 1024) against its plain version and exact
   attention's gradients; the Q/K options: kernels 3 and 4 at 4
   bits bit-exact with their plain versions at the CogVideoX-2B layer,
   kernel 4 (the row-group quantizer of every option) at 8 and 4 bits at
   groups of 1, 32 and 128 rows, on x, on x less kernel 2's mean and on
   that cast back to the 16-bit type, bit-exact with its plain version at
   the CogVideoX-2B and Wan2.1 layers, at d 256 / 384 / 512, ragged at
   every head dim in fp32 and on fp16 q's values, and
   the pre-quantized forward for per_token, per_subtile, per_block,
   smooth_q, int4 and int4 + smooth_q, bf16 and e4m3 V, at the CogVideoX-2B
   and Wan2.1 layers, the llm-8b-gqa layer (causal, GQA) and varlen's
   four prompts; the accuracy sweep of ``bench/bench_accuracy.py``'s 11
   configurations (copied here) on its "normal" and "biased" inputs at
   both DiT layer shapes against exact attention (held at 0.999 for 8
   bits, 0.9985 for "int8 no smoothing" on "biased" inputs, 0.97 for int4
   on "normal" and int4 + smooth_q on both; int4 alone on "biased" is
   printed), and its 8-bit rows on "biased" inputs at the
   Wan2.1 layer on five more seeds, each held to its floor, with the
   plain version of three of them beside the kernel on three heads; the
   decode kernels at head dims 96, 40 and 72 too (40 and 72, not multiples
   of 16, through the RAGGED instances); dQ and dK/dV without a bias (TMA
   and ``wgmma``; no stack bytes in any instance) at GQA rep 4, d 128,
   1000 tokens, causal with a window of 300, and at (1, 16/8, 3001, 256)
   causal, whose last Q tile ends inside a stage; the backward's bias instances (dQ
   with dBias, dK/dV) against their plain versions at the llm-8b-gqa layer
   (d128: causal with ALiBi at 4096 tokens in fp32 and bf16, non-causal
   with a random per-head bias at 4000 tokens, causal with a bf16 random
   one at 3001) and at CogVideoX-2B's 30 heads of 64 (non-causal at 4000
   tokens, fp32; causal at 3001, bf16), four of them with a query row
   biased to -inf, whose dq and dBias must be exactly 0 (at 3001 tokens
   each thread loads the bias, elsewhere the producer stages it by TMA);
3. the servers, each answering 2 requests x 2 denoise steps with seeded
   random weights at full width and depth 30; the launch counts of every
   kernel are zeroed just before and read just after, and those of the
   path's kernels must equal layers x steps, every other kernel's 0; one
   step's eps is checked against exact attention at depth 2:
   a. CogVideoX-2B (seq 17,776, hidden 1920, 30 heads x 64), backend
      "sage" (bf16 V);
   b. CogVideoX-2B, backend "sage_fp8" (fp8 V codes from the single-pass
      V quantizer);
   c. Wan2.1-T2V-1.3B (seq 33,272, hidden 1536, 12 heads x 128), backend
      "sage_fp8", whose 8.5 MB V slabs take the two-pass V quantizer, and
      two more steps with "sage" for the bf16 step time;
   d. CogVideoX-2B through ``SageAttnProcessor`` kwargs:
      ``server_subtile_fp8``, "sage_fp8" with ``qk_quant_gran="per_subtile"``
      (kernel 2 on K, kernel 4 on Q and on K, kernel 5 and the
      pre-quantized forward), and ``server_int4_sq``, "sage" with
      ``qk_bits=4, smooth_q=True`` (kernel 2 on Q and on K, kernel 4 on
      the centred Q, kernel 3 at 4 bits and the pre-quantized forward);
      eps floors 0.999 and 0.97;
4. the trainer: CogVideoX-2B at full width and depth 8 (fp32
   parameters, bf16 compute, AdamW), one warm-up step and 4 timed steps
   on one fixed batch and (t, eps); the counts are zeroed just before the
   timed steps and every kernel, forward and backward, must launch layers
   x steps times; the loss must be finite and fall; the parameter
   gradients with "sage" and with "sage_fp8" are checked against exact
   attention's at depth 2 and a sequence of 4,276, and the fp8 backward
   must launch no V quantizer; with ``smooth_q`` (the exact-recompute
   backward) the gradients too, and its backward launches no kernel;
   b. the bias trainer, a kernel check and not a cell: one llm-8b-gqa
   attention layer at full width (1 x 4096 tokens, 32/8 heads of 128,
   causal) training per-head ALiBi slopes and bf16 q, k, v with AdamW
   against exact attention with the standard slopes, the bias built in
   autograd at [1, 32, s, s] fp32 (the fused route); the first step's
   gradients and dBias against fp32 exact attention's (>= 0.999), the same
   step with the bias fixed (no dBias asked, the same q, k, v gradients),
   then 1 warm-up and 4 timed steps whose loss must fall, each launching
   the masked forward and the dQ and dKV bias instances once;
5. the llm-8b-gqa decode servers at full width and depth 32 (fp32
   weights, 32 GB), a prefill and 32 greedy decode steps each, timed with
   CUDA events; the counts are zeroed before each phase and read after it
   (a one-shot prefill runs kernels 1-3 once a layer, an extend block or a
   decode step the path's decode kernel once a layer, nothing else runs);
   the cached path's logits are checked against a one-shot exact-attention
   refeed at depth 2:
   a. dense int8 cache, b 4, a 4096-token prompt (kernel 9);
   b. paged int8 cache, 1024-token pages, scrambled table (kernel 11);
   c. dense packed int4 cache, calibrated on the prompt (kernel 9);
   d. vocab 32000 and a 4096-token sliding window (the Mistral-7B
      geometry), b 2, an 8192-token prompt: dense in one windowed prefill
      (the masked kernel 1 and kernels 2-3 once a layer, no decode
      kernel), then kernel 10; paged in 512-token extend blocks through
      kernel 12;
6. each kernel's time at the model shape (CUDA events, median of several
   after warm-up) beside its bound, its plain version's time and, where
   one PyTorch call computes the same function, that call's time; the
   forward kernel for every V type; one layer's attention forward +
   backward against SDPA's; the decode kernels at the servers' decode
   and extend shapes, with the L2 flushed before each call; the masked
   forward at the windowed prefill's layer and at the varlen shape, with
   bounds from the live (row, col) pairs and SDPA with the same bool mask
   as the library time, the masked pre-quantized forward over varlen's
   prompts, the masked forward with the fp32 ALiBi bias (causal, SDPA with
   the bias beside it) and ``tile_liveness``, and the windowed dQ and dKV; dQ and dK/dV without
   a bias at the llm-8b-gqa layer, causal (1, 32/8, 4096, 128), beside
   their bounds and SDPA's backward there, and every timed backward
   instance's products at phase 9's measured ``wgmma`` and ``mma.sync``
   rates, every timed ``wgmma`` forward instance's at the measured
   ``wgmma`` rates and its exp2 at the measured ``exp2f`` rate; the pre-quantized
   forward for each Q/K option at both DiT layers beside the default
   forward and SDPA, the PyTorch ``quantize_qk`` and smooth_q preparation
   beside the op's own through kernels 2-4 for each option, and kernels 3
   and 4 at 4 bits; the backward's bias instances at the
   llm-8b-gqa layer, causal with an fp32 ALiBi bias, beside their byte
   bounds, their plain versions and SDPA's backward with the bias as a
   float mask that requires grad, and the exact route once (a broadcast
   [1, 32, s, s] bias at b 2);
7. head dims above 128 (the D = 256 instances, every head dim in (128,
   256] padded to 256), drawing from a generator of their own:
   a. with the kernel checks of phase 2: kernels 2-6 at 256 bit-exact with
      their plain versions; the forward at the Gemma-7B prefill layer (4,
      16/16, 4096, 256), causal, every V type, and at d 192 ragged (1,
      16/8, 3001); the masked forward at Gemma-2-9B's local layer (1,
      16/8, 8192, 256, window 4096) and over varlen's four prompts, each
      op also against exact attention; dQ and dK/dV non-causal, causal and
      windowed at (1, 16/16, 4096, 256) and (1, 16/8, 4096, 192), and
      ``sageattn``'s d 192 gradients against exact attention's; kernels
      9-12 at 256 and 192, int8 and int4, dense and paged, windowed or not;
      the pre-quantized forward's D = 256 instances for every Q/K
      option with bf16 and e4m3 V at the Gemma-7B layer, d 192 ragged,
      Gemma-2-9B's local layer and varlen, each option as ``sageattn``
      against exact attention (0.999 for 8 bits, 0.97 for int4) at d 192
      and with a window at 256; the backward's bias instances at 256 (dQ
      with dBias, dK/dV) at (1, 16/16, 4096, 256) causal with fp32 and bf16
      ALiBi and a ragged 3001 with a bf16 random bias, and at (1, 16/8,
      4000, 192) with a random bias, each with a row biased to -inf whose
      dq and dBias must be exactly 0;
   b. after the LLM servers: ``llm_gemma7b_dense`` and
      ``llm_gemma7b_paged``, the Gemma-7B attention geometry (``GEMMA_7B``:
      hidden 3072, 16/16 heads of 256, MLP 24576, vocab 256000) at full
      width and depth 28, fp32 weights, b 4, a 4096-token prompt and 32
      decode steps over an 8192-token int8 cache (dense, kernel 9; pages
      of 1024, kernel 11), run as 5a's servers are, peak memory printed;
   c. the layer trainer: bf16 q, k, v of one Gemma-7B layer (1, 16/16,
      4096, 256), causal, AdamW towards exact attention, first-step
      gradients >= 0.999 against fp32 exact attention's, 1 warm-up and 4
      timed steps, each launching kernels 2-4, 1, 7 and 8 at 256 once;
   d. with the timings of phase 6: each D = 256 instance beside its bound,
      plain version and library call (SDPA forward and backward); the
      pre-quantized instances for every option beside the default D = 256
      forward and SDPA; the bias instances beside their byte bounds, plain
      versions and SDPA's backward with the bias as a float mask;
   e. after the layer trainer, the d256 bias trainer, a kernel check and
      not a cell: 4b's trainer at the Gemma-7B layer (1, 16/16, 4096, 256)
      through the fused route, each step launching kernels 2-4, the masked
      forward and the bias instances at 256 once, and one step of the exact
      route at the same shape timed beside it.
   A D = 256 instance that no path of this run launches (the masked
   forward, kernels 5-6, 10 and 12) is reported inside its kernel's entry
   of the ``kernels`` line, as ``hd256``;
8. the parallel slice, drawing from generators of their own:
   a. with the kernel checks of phase 2: kernels 11-12 with the ``owned``
      page mask on each of 4 shards of a scrambled pool (each shard's pages
      a tensor of their own, a forward-filled local table) against their
      plain versions, at d 64, 128 and 256, int8 and int4, t_q 1 and 4,
      with and without window 4096; the shards merged against the kernel
      on the whole pool (<= 1e-4), and shards that own no live page of a
      row giving exactly 0 with l = 0;
   b. after the head-dim-256 trainer, each with its launch counts zeroed
      before and read after: ``sharded_paged`` (llm-8b-gqa's attention at
      b 1 x 131,072 tokens, 32 layers of paged int8 caches, 4 SP shards of
      1024-token pages run one after another by ``generate.serve_shards``,
      the loop ``sharded_serve`` runs on a mesh: ``paged_prefill(pool_start)``,
      32 steps of append and kernel 11 with ``owned``; the pools
      bit-identical to an unsharded pool's, the merged outputs within 1e-4
      of its decode; each shard's launch at the last step's inputs against
      its plain version, and timed beside the whole pool's, L2 cold);
      ``sharded_dense`` (the same geometry, TP 2 x SP 2 dense caches,
      kernel 9 at the shards' chunk); ``ring`` (a world of 4's KV ring, its
      ranks and steps one after another: the CogVideoX-2B layer, 16 steps,
      and the llm-8b-gqa prefill layer at 32,768 tokens causal, 4 aligned
      and 6 full steps, 6 skipped; against ``sageattn`` of the whole
      sequence and exact attention, timed against the one op);
      ``ring_grad`` (the same world forward and backward at both layers,
      ``ring.ring_partials`` / ``merge_cotangents`` / ``ring_step_vjp``,
      the code ``ring.RingFunction`` runs: kernels 2, 3 and 1 once a step
      that ran, 4, 7 and 8 once in its backward; dq, dk and dv of the loss
      sum(o do) + sum(lse dlse) against exact fp32 attention's, one q head
      at a time, and against one ``sageattn``'s over the whole sequence;
      the world on q heads 0-1 through the kernels against the plain
      versions on the host; timed against one ``sageattn`` forward and
      backward); ``server_parallel`` (a world of one over NCCL, a
      ``FileStore`` and no port: ``make_mesh(1, 1, 1)``, the CogVideoX-2B
      server through "sage_parallel" with its eps against "sage";
      ``trainer_parallel``, the trainer cell's geometry through
      "sage_parallel" with the gradients averaged over "data", its
      gradients against the "sage" trainer's from the same weights and
      (t, eps), 1 warm-up and 3 timed steps, one checkpoint round trip;
      then the four sharded factories through the group,
      ``generate.sharded_serve``, paged and dense, 32 layers, 4 steps).
   Kernel 11's owned launches (``sharded_paged``) and kernel 12's (checked
   and timed only) sit in their kernel's entry of the ``kernels`` line, as
   ``owned``;
9. kernel 13, the rate probe (``sageattention_tpu_torch/utils/probe_mma.py``,
   the port of tools/probe_mxu.py): each probe kernel (int8 Q.K^T at
   contraction 64/128/256 and P.V in bf16, e4m3 and int8 at widths
   64/128/256, by mma.sync and by wgmma; the softmax chain's passes; a
   device-memory read and copy) against its plain chain, its SASS's
   tensor-core instruction count, its rate beside its peak (above 105 %
   fails) and the library rows (cuBLAS at 8192^3, sum and copy), with the
   card's clock before and after;
10. head dims above 256 (the D = 384 and 512 instances, every head dim in
   (256, 512] padded to the next multiple of 128), each part from a
   generator of its own: kernels 2-6 at 384 and 512 bit-exact with their
   plain versions; kernels 9-12 at 512, 384 and 320, int8 and int4, t_q 1
   and 4, window 4096, pages of 16 and 1024, and kernel 11 with ``owned``;
   kernel 1 (``attention_fwd_wide.cu``: the TMA-fed wgmma kernel, one CTA
   a 64-row Q tile with O's columns split between its two consumer
   warpgroups; phase 2 holds it at ragged lengths too) at (4, 16/16, 4096,
   d) for d 320, 384 and 512, causal and not, bf16 and e4m3 V, against its
   plain version and exact fp32 attention, and the main paths
   ``wide_prefill_hd384`` / ``_hd512`` (``sageattn`` and the fp8 variant,
   whose V codes ``widen_v_codes`` widens first); the masked instances
   (the same kernel with the masks) at (1, 16/8, 8192, 512) with window
   4096, over varlen's four prompts and at d 320 with window 1000, and the
   path ``wide_masked_hd512`` (a window with fp8 V, through kernel 6, and
   ``sageattn_varlen``, each V widened first); the pre-quantized instances for every Q/K
   option at (4, 16/16, 4096, 512) and at d 320, causal and not, and at d
   320 with a window, and the path
   ``wide_preq_hd512`` (int4 + smooth_q); the gradient at (1, 16/16, 4096,
   320), causal, which takes exact recompute and launches no backward
   kernel; decode serving at d 512 (``wide_serve_*``: b 4 prompts of 4096
   tokens, 16/16 heads, 4 layers of caches, 32 steps; dense int8 and int4,
   int8 with window 4096, paged int8 and int4 with pages of 1024 and 16,
   paged with window 4096), each path's decode kernel exactly layers x
   steps times; each instance's time beside its bound, plain version and
   library call (SDPA, naming the backend it took), its registers, and the
   forward's products at phase 9's measured ``wgmma`` rates.  A wide instance that
   no path launches sits inside its kernel's entry, as ``hd384`` /
   ``hd512``;
11. kernels 2-6 through their C entry points (``centry_ms`` in their
   entries: outputs allocated once, many calls back to back) at the kernel
   table's shapes, beside the wrapper times (``ms``) of phases 6, 7d and
   10; kernel 4 at every group and form too (``rows_centry_ms``), and a
   per_subtile layer's Q/K preparation, its three C-entry calls queued
   together (``per_subtile_prep_centry_ms``);
12. the dual-stream and cross-attention DiTs, speculative decoding and the
   SDPA patch, each path with its counts zeroed just before and read just
   after: with phase 2's checks, kernel 1 at HunyuanVideo's joint attention
   (1, 24, 119,056, 128; 2 heads, the plain version on 3,072 rows), at
   Wan2.1's cross-attention (32,760 queries x 512 text keys) and its
   self-attention (32,760 tokens), bf16 and e4m3 V, and kernels 9 and 11
   at the verify step's t_q = 5; after the servers of phase 3,
   ``server_dual`` (``DualStreamVideoDiT`` at HunyuanVideo's widths, depth
   40 cut to 4: 1 request x 2 steps with "sage", 1 with "sdpa") and
   ``server_cross`` (``CrossAttnVideoDiT`` at Wan2.1's widths and depth 30:
   2 requests x 2 steps with "sage", 1 each with "sage_fp8" and "sdpa"),
   eps against "sdpa" >= 0.999, and ``patched_sdpa`` (CogVideoX-2B on the
   "sdpa" backend under ``interop.patch_torch_sdpa``: kernels 2, 3, 1 once
   a layer and eps bit for bit the "sage" backend's; after ``undo()`` none
   of them); with the LLM servers of phase 5, ``llm_speculate`` /
   ``_paged`` (b 1, a 4,096-token prompt, K = 4, 64 tokens) beside plain
   greedy decoding (``llm_greedy`` / ``_paged``), drafts accepted >= 0.75
   and the t_q = 5 extend blocks against exact attention at depth 2; with
   phase 6's timings, each new layer through ``sageattn`` and kernel 1
   alone beside SDPA (PyTorch's pick of backend, and the flash backend).

It prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.  It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

# H100 SXM data-sheet peaks (dense)
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_BF16_FLOP_S = 989e12

COG = dict(b=1, h=30, s=17776, d=64)  # one CogVideoX-2B attention layer
WAN = dict(b=1, h=12, s=33272, d=128)  # one Wan2.1-T2V-1.3B attention layer
SERVER_DEPTH = 30  # the servers run all of their model's layers
# the trainer's depth: saved activations (about 3 GB a layer at 17,776
# tokens) and 16 bytes a parameter of fp32 weights, gradients and AdamW
# state would not fit 80 GB at all 30 layers
TRAIN_DEPTH = 8
TRAIN_STEPS = 4
LLM_DEPTH = 32  # llm-8b-gqa's layers, all of them
LLM_STEPS = 32
LLM_PAGE = 1024
# The refeed's cosine floor by cache width.  The decode numerics (the JAX
# package's) quantize each chunk's P per row to int8 against the chunk's
# largest p, and random weights give near-uniform attention over thousands
# of keys, where the mean p is a few codes out of 127: the attention output
# carries a few percent of rounding.  Measured on an H100 (NVIDIA H100 80GB
# HBM3, 700 W): 0.99861 for the dense int8 cache (4096-token chunks),
# 0.99911-0.99924 for the paged and windowed int8 paths (1024-1536-token P
# units), 0.97459 for the packed int4 cache (+-7 levels).
REFEED_FLOOR = {8: 0.998, 4: 0.97}
LOG2E = 1.4426950408889634
LLM_LAYER = dict(hq=32, hkv=8, d=128)  # one llm-8b-gqa attention layer
VARLEN_LENS = (4096, 2048, 1536, 512)  # four causal prompts packed, 8192 tokens
# Gemma-7B's attention geometry (google/gemma-7b config.json: hidden 3072,
# 28 layers, 16 query and 16 kv heads of 256, MLP 24576, vocab 256000)
# under the JAX package's Llama-style block; GeGLU, the embedding scale
# and the tied head are not modelled (none of them touches attention)
GEMMA_7B = dict(hidden=3072, heads=16, kv_heads=16, head_dim=256, depth=28, mlp_hidden=24576,
                vocab=256000)
HD256_LAYER = dict(hq=16, hkv=16, d=256)  # one Gemma-7B attention layer
GEMMA2_LOCAL = dict(hq=16, hkv=8, d=256)  # Gemma-2-9B's heads, window 4096 on its local layers
# the kernels with head-dim-256 instances (or a head-dim-256 call), each
# counted apart as ``<name>_hd256``
HD256 = ("k_channel_mean", "quant_k_chunked", "quant_q_per_token", "quant_v_per_channel",
         "v_channel_stats", "quant_v_apply", "sage_attn_fwd", "sage_attn_fwd_masked",
         "sage_attn_fwd_preq", "sage_attn_bwd_dq", "sage_attn_bwd_dkv", "sage_attn_bwd_dq_bias",
         "sage_attn_bwd_dkv_bias", "sage_decode", "sage_decode_window", "sage_paged_decode",
         "sage_paged_decode_window")
HD256_SOURCE = {"sage_attn_fwd": "attention_fwd_hd256.cu",
                "sage_attn_fwd_masked": "attention_fwd_masked_hd256.cu",
                "sage_attn_fwd_preq": "attention_fwd_preq_hd256.cu"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2, cold: bool = False) -> float:
    """Median of ``reps`` single-call times from CUDA events; with ``cold``,
    the 50 MB L2 is flushed before each call (a decode step reads every
    layer's cache cold)."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_registers(build, lib: str) -> list:
    """(kernel<template args>, registers, stack bytes) of every kernel in a
    built library, as ``cuobjdump -res-usage`` reads them."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, "-res-usage", str(build._target(lib))],
                         capture_output=True, text=True, timeout=120)
    rows, fn = [], None
    for line in out.stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        k = re.search(r"\d((?:sage_|quant|channel)[a-z0-9_]*_kernel)I", fn or "")
        if m and k:
            # the kernel's own template arguments (a parameter's mangled
            # type may hold literals too: BiasOf's std::conditional)
            targs = [a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)E", fn.split("EEv")[0])]
            dtype = " bf16" if "nv_bfloat16" in fn else ""
            rows.append((f"{k.group(1)}<{','.join(targs)}>{dtype}", m.group(1), m.group(2)))
    return rows


# the sources of kernel 1's TMA-fed wgmma instances (the forward at head
# dims 64, 128 and 256, with masks and without; at 384 and 512 the wide
# kernel, O's columns split between two warpgroups), with their kernel's name
FWD_SM90_LIBS = {"attention_fwd": "sage_attn_fwd_sm90_kernel",
                 "attention_fwd_hd256": "sage_attn_fwd_sm90_kernel",
                 "attention_fwd_masked": "sage_attn_fwd_sm90_kernel",
                 "attention_fwd_masked_hd256": "sage_attn_fwd_sm90_kernel",
                 "attention_fwd_preq": "sage_attn_fwd_sm90_kernel",
                 "attention_fwd_preq_hd256": "sage_attn_fwd_sm90_kernel",
                 "attention_fwd_wide": "sage_attn_fwd_wide_kernel",
                 "attention_fwd_masked_wide": "sage_attn_fwd_wide_kernel",
                 "attention_fwd_preq_wide": "sage_attn_fwd_wide_kernel"}


def sass_mma(build, lib: str, kernel: str) -> dict:
    """{instance: {family: count}} of the tensor-core instructions (IMMA,
    HMMA, IGMMA, HGMMA, ...) in the SASS (``cuobjdump -sass``) of every
    instance of ``kernel`` in a built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = {}
            continue
        if fn:
            for fam in re.findall(r"\b([A-Z]*MMA)\b", line):
                counts[fn][fam] = counts[fn].get(fam, 0) + 1
    return counts


def resource_usage() -> None:
    """Registers a thread and spill (stack) bytes of every built kernel; the
    TMA-fed wgmma instances (kernels 7-8, every instance of kernel 1) may
    hold no stack.  Their registers are the
    count at entry: ``setmaxnreg`` then gives a backward consumer warpgroup
    240 (160 with three) and the producer 24, a forward consumer 240 and
    the producer 24.  The forward's wgmma instances must run their products
    as warpgroup MMA (``*GMMA`` in their SASS) and hold no ``mma.sync``
    (HMMA, IMMA)."""
    from sageattention_tpu_torch.ops import _build

    for lib in _build.SIGNATURES:
        for kern, regs, stack in kernel_registers(_build, lib):
            log(f"resources {lib} {kern}: {regs} registers, {stack} bytes of stack")
            require(not (("_tma_kernel" in kern or "_sm90_kernel" in kern
                          or "_wide_kernel" in kern) and int(stack)),
                    f"{kern} spills {stack} bytes of stack")
    # kernels 7-8's BIAS instances (the last template argument: 1 the
    # threads load the bias, 2 the producer stages it by TMA)
    for kern, regs, stack in kernel_registers(_build, "attention_bwd"):
        if not kern.split(">")[0].endswith(",0"):
            log(f"bias instance {kern}: {regs} registers, {stack} bytes of stack")
    for lib, kernel in FWD_SM90_LIBS.items():
        counts = sass_mma(_build, lib, kernel)
        fams = sorted({f for c in counts.values() for f in c})
        log(f"sass {lib}: {len(counts)} wgmma forward instances, tensor-core instructions "
            f"{ {f: sorted({c.get(f, 0) for c in counts.values()}) for f in fams} }")
        require(counts and all(any(f.endswith("GMMA") for f in c) and not
                               {"HMMA", "IMMA"} & set(c) for c in counts.values()),
                f"{lib}: a wgmma forward instance without GMMA or with HMMA / IMMA")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_quant(gen, results):
    import torch
    from sageattention_tpu_torch.ops import quant_cuda

    for b, h, s, d in ((1, 30, 17776, 64), (2, 8, 4096, 128)):
        k = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = k + torch.randn(b, h, 1, d, generator=gen, device="cuda").to(torch.bfloat16) * 3
        km = quant_cuda.k_channel_mean(k)
        km_ref = quant_cuda.k_channel_mean_plain(k)
        km_err = ((km - km_ref).abs() / (km_ref.abs() + 1e-3)).max().item()
        # the chunked kernel with the plain km: bit-exact with the spec
        ki, ks = quant_cuda.quant_k_chunked(k, km_ref, group=128)
        ki_ref, ks_ref = quant_cuda.quant_k_chunked_plain(k, km_ref, group=128)
        torch.cuda.synchronize()
        exact = torch.equal(ki, ki_ref) and torch.equal(ks, ks_ref)
        # the whole prologue (kernel km): codes within +-1 on <= 1e-4
        kf, sf, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        diff = (kf.int() - ki_ref.int()).abs()
        frac = (diff > 0).float().mean().item()
        s_rel = ((sf - ks_ref).abs() / ks_ref).max().item()
        log(f"quant_k {(b, h, s, d)}: km max rel err {km_err:.3e}; chunked "
            f"bit-exact {exact}; fused codes off {frac:.2e} (max {diff.max().item()}), "
            f"scales max rel {s_rel:.2e}")
        require(km_err <= 1e-5, "k_channel_mean disagrees with its plain version")
        require(exact, "quant_k_chunked is not bit-exact with the spec")
        require(diff.max().item() <= 1 and frac <= 1e-4, "quant_k codes disagree")
        require(s_rel <= 1e-6, "quant_k scales disagree beyond rtol 1e-6")
        if (b, h, s, d) == (1, 30, 17776, 64):
            results["k_channel_mean"]["max_abs_err"] = (km - km_ref).abs().max().item()
            results["quant_k_chunked"]["max_abs_err"] = float(
                (ki.int() - ki_ref.int()).abs().max().item())


def random_v(gen, shape):
    """bf16 V with a per-channel offset, so that smooth-v moves the codes."""
    import torch

    b, h, s, d = shape
    v = torch.randn(b, h, s, d, generator=gen, device="cuda")
    return (v + torch.randn(b, h, 1, d, generator=gen, device="cuda") * 3).to(torch.bfloat16)


def k5_plan(v):
    """Kernel 5's plan for bf16 or fp32 V [b,h,s,d] on this card, as the
    wrapper makes it (``quant_cuda.quant_v_args``)."""
    from sageattention_tpu_torch.ops import quant_cuda as qc

    return qc.quant_v_device_plan(v)


def k5_mean_in_plan_order(v, m) -> bool:
    """Whether kernel 5's smooth-v mean ``m`` is the sum of V in its plan's
    order over s (``quant_cuda.v_partition_mean``), bit for bit."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda as qc

    return bool(torch.equal(m, qc.v_partition_mean(v, k5_plan(v))))


def check_quant_v(gen, results):
    """Kernels 5 and 6 against their plain versions, for each code type.
    Without smooth-v: codes and scales bit-exact.  With it: the mean to
    1e-5 relative; given the kernel's own mean, kernel 5's codes and scales
    bit-exact with the plain chain, and kernel 6's apply step bit-exact fed
    the plain mean and 1/scale; against the plain version with its own
    mean, codes differ on at most 1e-4 of the entries (int8 by one step;
    an fp8 value within the means' difference of 0 may change sign, so fp8
    steps are not compared)."""
    import torch
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import quant_cuda as qc

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    errs = {"quant_v_per_channel": 0.0, "v_channel_stats": 0.0, "quant_v_apply": 0.0}
    cog = random_v(gen, tuple(COG.values()))
    # the cluster size kernel 5 takes here, and how many slabs run at once
    plan = k5_plan(cog)
    results["quant_v_per_channel"]["plan"] = plan._asdict()
    log(f"quant_v kernel 5 at {tuple(cog.shape)}: plan {plan} (clusters of {plan.cl} CTAs, "
        f"{plan.clusters} at once: the card's room for them)")
    for kernel, v, plain in (("kernel 5", cog, qc.quant_v_per_channel_plain),
                             ("kernel 6", random_v(gen, tuple(WAN.values())),
                              qc.quant_v_blocked_plain)):
        for pv, dtype in quant.V_DTYPES.items():
            for smooth in (False, True):
                # the dispatch picks the kernel by the slab's bytes
                q, sc, m = qc.quant_v_per_channel(v, dtype=dtype, smooth=smooth)
                q_p, sc_p, m_p = plain(v, dtype=dtype, smooth=smooth)
                torch.cuda.synchronize()
                off = q.view(torch.uint8) != q_p.view(torch.uint8)
                frac = off.float().mean().item()
                s_rel = ((sc - sc_p).abs() / sc_p).max().item()
                what = f"{kernel} {tuple(v.shape)} {pv} smooth={smooth}"
                line = f"quant_v {what}: codes off {frac:.2e}, scales max rel {s_rel:.2e}"
                if not smooth:
                    require(frac == 0 and s_rel == 0, f"{what}: not bit-exact with the plain version")
                    log(line + "; bit-exact")
                    continue
                m_rel = ((m - m_p).abs() / (m_p.abs() + 1e-3)).max().item()
                line += f", mean max rel {m_rel:.2e}"
                require(m_rel <= 1e-5, f"{what}: the mean disagrees with the plain version")
                require(s_rel <= 1e-5, f"{what}: the scales disagree with the plain version")
                require(frac <= 1e-4, f"{what}: codes disagree on more than 1e-4 of the entries")
                if dtype == torch.int8:
                    step = (q.int() - q_p.int()).abs().max().item()
                    require(step <= 1, f"{what}: codes more than one step apart")
                    line += f", int8 codes at most {step} step apart"
                if kernel == "kernel 5":
                    # the plain chain from the kernel's own mean: bit-exact
                    q_m, sc_m, _ = plain(v.float() - m[..., None, :], dtype=dtype, smooth=False)
                    exact = same(q, q_m) and torch.equal(sc, sc_m)
                    require(exact, f"{what}: not bit-exact given the kernel's mean")
                    ordered = k5_mean_in_plan_order(v, m)
                    require(ordered, f"{what}: the mean is not the sum in the plan's order")
                    line += (f"; given the kernel's mean bit-exact {exact}; the mean the "
                             f"plan-order sum bit for bit {ordered}")
                    errs["quant_v_per_channel"] = max(errs["quant_v_per_channel"],
                                                      (m - m_p).abs().max().item())
                else:
                    # the apply step fed the plain mean and 1/scale: bit-exact
                    gmax, gmin, mean = qc.v_channel_stats_plain(v, smooth=True)
                    _, r = qc.v_scale_from_stats(gmax, gmin, mean, dtype)
                    exact = same(qc.quant_v_apply(v, r, mean, dtype=dtype),
                                 qc.quant_v_apply_plain(v, r, mean, dtype=dtype))
                    require(exact, f"{what}: the apply step is not bit-exact")
                    line += f"; apply with the plain mean bit-exact {exact}"
                    errs["v_channel_stats"] = max(errs["v_channel_stats"],
                                                  (m - m_p).abs().max().item())
                log(line)
    # kernel 6 called on the CogVideoX-2B slab: the same codes as kernel 5
    for pv, dtype in quant.V_DTYPES.items():
        q5, s5, _ = qc.quant_v_per_channel(cog, dtype=dtype)
        q6, s6, _ = qc.quant_v_blocked(cog, dtype=dtype, smooth=False)
        exact = same(q5, q6) and torch.equal(s5, s6)
        log(f"quant_v kernel 6 vs kernel 5 on {tuple(cog.shape)} {pv}: bit-exact {exact}")
        require(exact, f"kernel 6 and kernel 5 disagree on the CogVideoX slab ({pv})")
    for name, e in errs.items():
        results[name]["max_abs_err"] = e


# kernel 3's cases beyond the main paths': every head dim, bf16 and fp32 K,
# 8 and 4 bits, with the smooth-k mean and without, at a ragged length
# (4001 = 31 x 128 + 33) and enough (b h, group) tiles that each CTA of
# the persistent grid walks several
K_CASE_SHAPE = (4, 16, 4001)


def check_quant_k_cases(results) -> None:
    """Kernel 3 bit-exact with ``quant_k_chunked_plain`` given the same km
    at d 64-512, bf16 and fp32 K, 8 and 4 bits, with km and without, at
    ``K_CASE_SHAPE``, and with fp32 K at the CogVideoX-2B layer; from a
    generator of its own."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda as qc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    cases = [(tuple(COG.values()), torch.float32)]
    cases += [((*K_CASE_SHAPE, d), dt) for d in (64, 128, 256, 384, 512)
              for dt in (torch.bfloat16, torch.float32)]
    n = 0
    for shape, dt in cases:
        k = (torch.randn(*shape, generator=gen, device="cuda")
             + torch.randn(*shape[:2], 1, shape[3], generator=gen, device="cuda") * 3).to(dt)
        km = qc.k_channel_mean_plain(k)
        for bits in (8, 4):
            for m in (km, None):
                ki, ks = qc.quant_k_chunked(k, m, group=128, bits=bits)
                ki_p, ks_p = qc.quant_k_chunked_plain(k, m, group=128, bits=bits)
                torch.cuda.synchronize()
                exact = torch.equal(ki, ki_p) and torch.equal(ks, ks_p)
                what = (f"quant_k_chunked {shape} {str(dt)[6:]} {bits} bits "
                        f"{'with km' if m is not None else 'no smoothing'}")
                require(exact, f"{what}: not bit-exact with its plain version")
                n += 1
        log(f"quant_k cases {shape} {str(dt)[6:]}: 8 and 4 bits, with km and without, "
            "bit-exact")
        del k, km, ki, ks, ki_p, ks_p
    torch.cuda.empty_cache()
    results["quant_k_chunked"]["cases_bit_exact"] = n


# kernel 5's cases beyond the main paths': (shape, V dtype, the plan the
# case is for: "columns", the column split; "clusters", a cluster a slab
# whose CTAs stage all their rows; "re-read", one whose CTAs read the rows
# past their stage twice).  The last three are slabs of exactly
# quant_cuda.V_SINGLE_PASS_BYTES, the largest that kernel 5 takes.
V_CASES = (((1, 8, 4096, 64), "float32", "columns"),
           ((1, 30, 1024, 384), "bfloat16", "clusters"),
           ((1, 30, 768, 512), "bfloat16", "clusters"),
           ((1, 30, 512, 384), "float32", "clusters"),
           ((1, 30, 1500, 512), "float32", "re-read"),
           ((1, 16, 32768, 64), "bfloat16", "re-read"),
           ((1, 30, 16384, 128), "bfloat16", "re-read"),
           ((1, 30, 2048, 512), "float32", "re-read"))


def k5_route(plan) -> str:
    """Which of ``V_CASES``' plans kernel 5's ``plan`` is."""
    if plan.cl == 0:
        return "columns"
    return "re-read" if plan.rows_per_cta > plan.stage_rows else "clusters"


def check_quant_v_cases(results) -> None:
    """Kernel 5 beyond the main paths (``V_CASES``: fp32 V, d 384 and 512,
    slabs of exactly 4 MB), from a generator of its own, for each code
    type: without smooth-v codes and scales bit-exact with the plain
    version; with it the mean within 1e-5 relative, codes and scales
    bit-exact given the kernel's own mean, and two calls bit-identical.
    Each call must launch kernel 5 (not the two-pass kernel 6) on the plan
    the case is for."""
    import torch
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import quant_cuda as qc

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(42)
    for shape, dt, want in V_CASES:
        v = random_v(gen, shape).to(getattr(torch, dt))
        slab = shape[2] * shape[3] * v.element_size()
        plan = k5_plan(v)
        require(k5_route(plan) == want,
                f"quant_v kernel 5 {shape} {dt}: plan {plan} is {k5_route(plan)}, not {want}")
        for pv, dtype in quant.V_DTYPES.items():
            for smooth in (False, True):
                what = f"quant_v kernel 5 {shape} {dt} ({slab} B a slab) {pv} smooth={smooth}"
                before = qc.quant_v_per_channel.launches + sum(
                    getattr(qc.quant_v_per_channel, f"hd{x}_launches") for x in (256, 384, 512))
                q, sc, m = qc.quant_v_per_channel(v, dtype=dtype, smooth=smooth)
                after = qc.quant_v_per_channel.launches + sum(
                    getattr(qc.quant_v_per_channel, f"hd{x}_launches") for x in (256, 384, 512))
                require(after == before + 1, f"{what}: kernel 5 was not launched")
                q_p, sc_p, m_p = qc.quant_v_per_channel_plain(v, dtype=dtype, smooth=smooth)
                torch.cuda.synchronize()
                if not smooth:
                    require(same(q, q_p) and torch.equal(sc, sc_p),
                            f"{what}: not bit-exact with the plain version")
                    continue
                m_rel = ((m - m_p).abs() / (m_p.abs() + 1e-3)).max().item()
                require(m_rel <= 1e-5, f"{what}: the mean is {m_rel:.2e} off the plain version")
                q_m, sc_m, _ = qc.quant_v_per_channel_plain(v.float() - m[..., None, :],
                                                             dtype=dtype, smooth=False)
                require(same(q, q_m) and torch.equal(sc, sc_m),
                        f"{what}: not bit-exact given the kernel's mean")
                q2, sc2, m2 = qc.quant_v_per_channel(v, dtype=dtype, smooth=True)
                require(same(q, q2) and torch.equal(sc, sc2) and torch.equal(m, m2),
                        f"{what}: two calls differ")
                require(k5_mean_in_plan_order(v, m),
                        f"{what}: the mean is not the sum in the plan's order")
        log(f"quant_v cases {shape} {dt} ({slab} B a slab, plan {plan}, {want}): int8, e4m3, "
            "e5m2 bit-exact without smooth-v; with it the mean within 1e-5 and the plan-order "
            "sum bit for bit, bit-exact given it, two calls bit-identical")
        del v
    torch.cuda.empty_cache()


def time_quant_entries(results) -> None:
    """Phase 11: kernels 2-6 through their C entry points (with the
    ``*_args`` functions of ``ops/quant_cuda.py``: outputs allocated once,
    no wrapper)
    at the kernel table's shapes, beside the wrapper times above: K and Q
    (8 and 4 bits) at the CogVideoX-2B layer, kernel 5 there and kernel 6
    at the Wan2.1 layer (e4m3), and at head dims 256, 384 and 512 K at (4,
    16, 4096, d), Q and kernel 5 at (1, 16, 4096, d), kernel 6 at (1, 8,
    16384, d) (int8); kernel 4 also at every group and form of
    ``rows_cases`` on the same Q (and above 128 on it in fp32), and a
    per_subtile layer's Q/K preparation at the C entries, its three calls
    (kernel 2 on K, kernel 4 on Q and on K less that mean) queued together
    on one CogVideoX-2B layer's Q and K; from generators of their own."""
    import torch
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import quant_cuda as qc
    from sageattention_tpu_torch.utils.ab_common import offset_rows, rows_cases
    from sageattention_tpu_torch.utils.timing import queued_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    e4m3 = torch.float8_e4m3fn
    lib_k, lib_q, lib_v = (_build.lib(n) for n in ("quant_k", "quant_q", "quant_v"))

    def put(r, what, fn):
        r["centry_ms"] = queued_ms(fn)
        log(f"time {what} C entry: {r['centry_ms']:.4f} ms (through the wrapper "
            f"{r.get('ms')} ms)")

    for d in (64, 256, 384, 512):
        sfx = "" if d == 64 else f"_hd{d}"
        shape = tuple(COG.values()) if d == 64 else (4, 16, 4096, d)
        b, h, s, _ = shape
        k = random_v(gen, shape)
        km = torch.empty(b, h, d, device="cuda")
        args, part = qc.k_mean_args(k, km)
        put(results["k_channel_mean" + sfx], f"k_channel_mean at {shape}",
            lambda: lib_k.k_channel_mean(*args))
        out = torch.empty(shape, dtype=torch.int8, device="cuda")
        sc = torch.empty(b, h, -(-s // 128), device="cuda")
        for bits in (8, 4) if d == 64 else (8,):
            r = results["quant_k_chunked" + sfx]
            args = qc.quant_k_args(k, km, out, sc, group=128, bits=bits)
            put(r if bits == 8 else r["bits4"], f"quant_k_chunked {bits} bits at {shape}",
                lambda: lib_k.quant_k_chunked(*args))
        del k, km, part, out, sc
        shape = tuple(COG.values()) if d == 64 else (1, 16, 4096, d)
        q = random_v(gen, shape)
        out = torch.empty(shape, dtype=torch.int8, device="cuda")
        sc = torch.empty(shape[:3], device="cuda")
        fold = d**-0.5 * LOG2E
        r = results["quant_q_per_token" + sfx]
        for bits in (8, 4) if d == 64 else (8,):
            args = qc.quant_q_args(q, out, sc, scale_fold=fold, bits=bits)
            put(r if bits == 8 else r["bits4"], f"quant_q_per_token {bits} bits at {shape}",
                lambda: lib_q.quant_rows(*args))
        # kernel 4 at every group and form
        rows = r["rows_centry_ms"] = {}
        mean = qc.k_channel_mean(q)
        for x in (q, q.float()):
            b, h, s, _ = x.shape
            for group, form, m, c in rows_cases(x, mean):
                if x.dtype == torch.float32 and (form != "x" or d == 64):
                    continue
                for bits in (8, 4) if d == 64 and x is q else (8,):
                    key = f"{str(x.dtype)[6:]} group {group} {form} {bits} bits"
                    args = qc.quant_q_args(x, out, sc, scale_fold=fold, bits=bits, mean=m,
                                           group=group, cast=c)
                    rows[key] = queued_ms(lambda: lib_q.quant_rows(*args))
                    plan = qc.quant_q_plan(b * h, s, d, x.element_size(), group,
                                           mean=m is not None)
                    log(f"time quant_q_per_token {key} at {shape} C entry: {rows[key]:.4f} ms "
                        f"(plan {tuple(plan)})")
        if d == 64:
            # a per_subtile layer's Q and K at the C entries, queued together
            # as the op issues them: K's mean, Q, and K less its mean, each
            # 32 rows a scale (K from a generator of its own)
            gen_k = torch.Generator(device="cuda")
            gen_k.manual_seed(46)
            k = offset_rows(gen_k, shape, "bf16")
            km = torch.empty(shape[0], shape[1], d, device="cuda")
            k_out, k_sc = torch.empty_like(out), torch.empty_like(sc)
            a_mean, part = qc.k_mean_args(k, km)
            a_q = qc.quant_q_args(q, out, sc, scale_fold=fold, group=32)
            a_k = qc.quant_q_args(k, k_out, k_sc, scale_fold=1.0, mean=km, group=32)

            def prep():
                lib_k.k_channel_mean(*a_mean)
                lib_q.quant_rows(*a_q)
                lib_q.quant_rows(*a_k)

            r["per_subtile_prep_centry_ms"] = queued_ms(prep)
            log(f"time a per_subtile layer's Q/K preparation at the C entries (kernel 2 on K, "
                f"kernel 4 on Q and on K - km, queued together) at {shape}: "
                f"{r['per_subtile_prep_centry_ms']:.4f} ms")
            del k, km, k_out, k_sc, part
        del mean
        dtype = e4m3 if d == 64 else torch.int8
        v = q
        out = torch.empty(shape, dtype=dtype, device="cuda")
        sc = torch.empty(shape[0], shape[1], d, device="cuda")
        args = qc.quant_v_args(v, out, sc, None)
        put(results["quant_v_per_channel" + sfx], f"quant_v_per_channel {dtype} at {shape}",
            lambda: lib_v.quant_v_per_channel(*args))
        del q, v, out, sc
        shape = tuple(WAN.values()) if d == 64 else (1, 8, 16384, d)
        sfx6 = "" if shape[3] <= 128 else sfx
        v = random_v(gen, shape)
        parts = torch.empty(3, shape[0] * shape[1], -(-shape[2] // qc.V_BLOCK_ROWS), shape[3],
                            device="cuda")
        args = qc.v_stats_args(v, parts)
        put(results["v_channel_stats" + sfx6], f"v_channel_stats at {shape}",
            lambda: lib_v.quant_v_stats(*args))
        gmax, gmin, _ = qc.v_channel_stats(v, smooth=False)
        _, rr = qc.v_scale_from_stats(gmax, gmin, None, dtype)
        out = torch.empty(shape, dtype=dtype, device="cuda")
        args = qc.v_apply_args(v, rr, None, out)
        put(results["quant_v_apply" + sfx6], f"quant_v_apply {dtype} at {shape}",
            lambda: lib_v.quant_v_apply(*args))
        del v, parts, gmax, gmin, rr, out
        torch.cuda.empty_cache()


def v_operands(v):
    """(name, V, v_scale, v_mean) for each V the forward kernel takes:
    bf16 and the codes of each type, each without and with the smooth-v
    mean, built as ``core`` builds them."""
    import torch
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import quant_cuda

    yield "bf16", v, None, None
    v_c, mean = quant.sub_mean(v)
    yield "bf16+mean", v_c.to(torch.bfloat16), None, mean
    for pv, dtype in quant.V_DTYPES.items():
        for smooth in (False, True):
            vq, vs, vm = quant_cuda.quant_v_per_channel(v, dtype=dtype, smooth=smooth)
            yield pv + ("+mean" if smooth else ""), vq, vs, vm


def check_attention(gen, results):
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda, reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity, max_abs_err

    cases = [
        # name, b, hq, hkv, sq, sk, d, causal, q heads compared (None: all);
        # at the model shape a few heads across the range, so that the plain
        # version's [s,s] scores stay small
        ("cogvideox layer", 1, 30, 30, 17776, 17776, 64, False, (0, 15, 29)),
        # the d128 non-causal instances the Wan2.1 server runs, with a
        # ragged last tile (33,272 = 259 x 128 + 120)
        ("wan layer", 1, 12, 12, 33272, 33272, 128, False, (0, 6, 11)),
        ("causal gqa lse", 1, 32, 8, 2048, 2048, 128, True, None),
        ("ragged causal", 1, 4, 4, 1000, 1000, 64, True, None),
        ("rectangular", 2, 4, 2, 300, 1111, 64, False, None),
    ]
    for name, b, hq, hkv, sq, sk, d, causal, heads in cases:
        q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        fold = d**-0.5 * core.LOG2E
        # each compared q head with its own kv head (GQA: h // (hq // hkv))
        hs = list(heads) if heads is not None else list(range(hq))
        kvs = [h // (hq // hkv) for h in hs]

        def kv_heads(x):
            return x[:, kvs].contiguous() if x is not None else None

        for vname, vx, vs, vm in v_operands(v):
            o, l2 = attention_cuda.sage_attention_fwd(q, k_i8, k_sc, vx, vs, vm,
                                                      is_causal=causal, q_fold=fold,
                                                      return_lse=True)
            o_p, l2_p = attention_cuda.sage_attention_plain(
                q[:, hs].contiguous(), kv_heads(k_i8), kv_heads(k_sc), kv_heads(vx),
                kv_heads(vs), kv_heads(vm), is_causal=causal, q_fold=fold, return_lse=True)
            torch.cuda.synchronize()
            o_k, l2_k = o[:, hs].float(), l2[:, hs]
            cos = cosine_similarity(o_k.cpu(), o_p.float().cpu())
            err = (o_k - o_p.float()).abs().max().item()
            lerr = (l2_k - l2_p).abs().max().item()
            finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2).all())
            log(f"attention {name} {(b, hq, hkv, sq, sk, d)} causal={causal} V {vname}: cos "
                f"{cos:.6f}, max abs {err:.3e}, lse2 max abs {lerr:.3e} (heads "
                f"{heads if heads is not None else 'all'}); "
                f"finite {finite}")
            require(finite, f"attention {name} V {vname}: non-finite output")
            require(cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                    f"attention {name} V {vname} disagrees with its plain version")
            if name == "cogvideox layer":
                r = results["sage_attn_fwd"]
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)

    # each op on the card against the same op on the CPU (the plain
    # versions), across input dtypes, a padded head dim and GQA
    ops = (core.sageattn, core.sageattn_qk_int8_pv_int8, core.sageattn_qk_int8_pv_fp8)
    for op in ops:
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            q = torch.randn(1, 4, 300, 96, generator=gen, device="cuda").to(dtype)
            k = torch.randn(1, 2, 517, 96, generator=gen, device="cuda").to(dtype)
            v = torch.randn(1, 2, 517, 96, generator=gen, device="cuda").to(dtype)
            o, lse = op(q, k, v, is_causal=True, return_lse=True)
            o_c, lse_c = op(q.cpu(), k.cpu(), v.cpu(), is_causal=True, return_lse=True)
            cos = cosine_similarity(o.float().cpu(), o_c.float())
            err = max_abs_err(o.float().cpu(), o_c.float())
            lerr = max_abs_err(lse.cpu(), lse_c)
            log(f"{op.__name__} cuda vs cpu ({dtype}, GQA 4/2, causal, 300x517, d96): cos "
                f"{cos:.6f}, max abs {err:.3e}, lse max abs {lerr:.3e}")
            require(o.dtype == dtype and o.shape == q.shape, f"{op.__name__} output dtype/shape")
            require(cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                    f"{op.__name__} on the card disagrees with the CPU path ({dtype})")

    # each op (quantizers + kernel + LSE correction) against exact attention
    b, hq, hkv, s, d = 1, 32, 8, 2048, 128
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    o_r, lse_r = reference.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, return_lse=True)
    for op in ops:
        o, lse = op(q, k, v, tensor_layout="NHD", is_causal=True, return_lse=True)
        cos = cosine_similarity(o.float().cpu(), o_r.transpose(1, 2).float().cpu())
        lerr = (lse - lse_r).abs().max().item()
        log(f"{op.__name__} vs exact fp32 (NHD, GQA 32/8, causal, 2048, d128): cos "
            f"{cos:.6f}, lse max abs {lerr:.3e}")
        require(cos > 0.999, f"{op.__name__} vs exact attention: cosine <= 0.999")
        require(lerr < 5e-2, f"{op.__name__} LSE vs exact attention")


def check_fwd_sm90(results) -> None:
    """Kernel 1's TMA-fed wgmma instances where TMA is likeliest to break,
    against the plain version, from a generator of their own (the later
    phases' inputs stay as they were): sk 513 and 3001 (boxes that end
    inside a KV tile, rows past sk landing as zeros) with sq 1000 (the last
    128-row CTA ends inside its second warpgroup; above 256 a 64-row CTA
    inside its tile), (1, 4/2) heads, every V type with and without the
    smooth-v mean, causal and not, at head dims 64, 128, 256, 384 and 512
    (513 at 256 and 512 only; above 256 q bf16 and fp32, the wide kernel's
    two q types); the pre-quantized instances at 3001 with per-tile and
    with per-row K scales and a column bias, bf16 and e4m3 V, bf16 and fp32
    output.  Limits as every forward check's: cosine
    >= 0.9999, max-abs <= 2e-2, lse2 <= 1e-3.  First, every int8, e4m3 and
    e5m2 code at each head dim through one key: the fp32 output must be the
    code's value exactly; and the V-code widening that runs before these
    instances (``widen_v_codes``) bit for bit with its plain version on
    every code and on a CogVideoX-2B layer's codes."""
    import torch
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    # every V code the quantizers write (NaN and inf codes aside), widened
    # before the launch (widen_v_codes): with one key (sk 1) and Q = 0,
    # P = 1 and the fp32 output is each code's value exactly
    for d in (64, 128, 256, 384, 512):
        h = max(256 // d, 1)
        for vdt in quant.V_CODE_TYPES:
            codes = torch.arange(256, dtype=torch.int32)
            finite = torch.isfinite(codes.to(torch.uint8).view(vdt).float())
            codes = torch.where(finite, codes, 0).to(torch.uint8).view(vdt)
            # above 256 one head holds every code, then the first ones again
            vx = codes.view(torch.uint8).repeat(2)[:h * d].view(vdt).reshape(1, h, 1, d).cuda()
            kw = dict(is_causal=False, q_fold=d**-0.5 * LOG2E, return_lse=False)
            args = (torch.zeros(1, h, 1, d, device="cuda"), torch.zeros(1, h, 1, d, device="cuda",
                    dtype=torch.int8), torch.ones(1, h, 1, device="cuda"), vx,
                    torch.ones(1, h, d, device="cuda"))
            o = attention_cuda.sage_attention_fwd(*args, **kw)
            o_p = attention_cuda.sage_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            same = torch.equal(o, o_p) and torch.equal(o_p.flatten().cpu(), vx.float().flatten().cpu())
            log(f"attention sm90 every {vdt} code at d {d} (sk 1): exact {same}")
            require(same, f"attention sm90: a {vdt} code widens to another value at d {d}")
    # the widening alone (csrc/widen_v.cu), bit for bit with its plain
    # version: every code, and the codes of a CogVideoX-2B layer's V
    v = random_v(gen, (1, 30, 17776, 64))
    for pv, vdt in quant.V_DTYPES.items():
        every = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(vdt)
        every = torch.where(torch.isfinite(every.float()), every.view(torch.uint8), 0)
        for vx in (every.view(vdt).cuda(), quant_cuda.quant_v_per_channel(v, dtype=vdt)[0]):
            got = attention_cuda.widen_v_codes(vx)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int16), attention_cuda.widen_v_codes_plain(vx)
                               .view(torch.int16))
            log(f"widen_v_codes {pv} {tuple(vx.shape)}: bit-exact {same}")
            require(same, f"widen_v_codes {pv} differs from its plain version")
    results["widen_v_codes"]["max_abs_err"] = 0.0
    del v
    b, hq, hkv, sq = 1, 4, 2, 1000

    def agree(name, key, got, want):
        (o, l2), (o_p, l2_p) = got, want
        torch.cuda.synchronize()
        cos = cosine_similarity(o.float().cpu(), o_p.float().cpu())
        err = (o.float() - o_p.float()).abs().max().item()
        lerr = (l2 - l2_p).abs().max().item()
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2).all())
        log(f"attention sm90 {name}: cos {cos:.6f}, max abs {err:.3e}, lse2 max abs "
            f"{lerr:.3e}; finite {finite}")
        require(finite and cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                f"attention sm90 {name} disagrees with its plain version")
        results[key]["max_abs_err"] = max(results[key].get("max_abs_err", 0.0), err)

    for d, sk in ((64, 3001), (128, 3001), (256, 3001), (256, 513), (384, 3001), (512, 3001),
                  (512, 513)):
        sfx = "" if d <= 128 else f"_hd{d}"
        q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = (torch.randn(b, hkv, sk, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        fold = d**-0.5 * LOG2E
        for causal in (False, True):
            for qx in ((q, q.float()) if d > 256 else (q,)):
                for vname, vx, vs, vm in v_operands(v):
                    kw = dict(is_causal=causal, q_fold=fold, return_lse=True)
                    agree(f"{(b, hq, hkv, sq, sk, d)} causal={causal} q {qx.dtype} V {vname}",
                          "sage_attn_fwd" + sfx,
                          attention_cuda.sage_attention_fwd(qx, k_i8, k_sc, vx, vs, vm, **kw),
                          attention_cuda.sage_attention_plain(qx, k_i8, k_sc, vx, vs, vm, **kw))
        if sk == 3001:
            q_i8 = torch.randint(-127, 128, (b, hq, sk, d), generator=gen, device="cuda",
                                 dtype=torch.int8)
            k_p = torch.randint(-127, 128, (b, hkv, sk, d), generator=gen, device="cuda",
                                dtype=torch.int8)
            q_sc = (torch.rand(b, hq, sk, generator=gen, device="cuda") + 0.5) * 2e-3 * fold
            v3 = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
            vq, vqs, vqm = quant_cuda.quant_v_per_channel(v3, dtype=torch.float8_e4m3fn,
                                                          smooth=True)
            for per_row in (False, True):
                ks = (torch.rand(b, hkv, sk if per_row else -(-sk // 128), generator=gen,
                                 device="cuda") + 0.5) * 2e-2
                cb = (torch.randn(b, hq, sk, generator=gen, device="cuda") if per_row
                      else None)
                for causal in (False, True):
                    for vname, vx, vs, vm in (("bf16", v3, None, None), ("fp8+mean", vq, vqs,
                                                                         vqm)):
                        for out_dtype in (torch.bfloat16, torch.float32):
                            kw = dict(is_causal=causal, return_lse=True, out_dtype=out_dtype,
                                      col_bias=cb)
                            agree(f"preq {(b, hq, hkv, sk, sk, d)} causal={causal} per-row "
                                  f"K scales {per_row} column bias {cb is not None} V {vname} "
                                  f"o {out_dtype}", "sage_attn_fwd_preq" + sfx,
                                  attention_cuda.sage_attention_fwd_preq(
                                      q_i8, q_sc, k_p, ks, vx, vs, vm, **kw),
                                  attention_cuda.sage_attention_preq_plain(
                                      q_i8, q_sc, k_p, ks, vx, vs, vm, **kw))
        del q, k, v, k_i8, k_sc
        torch.cuda.empty_cache()


def check_quant_q(gen, results):
    """Kernel 4's per-token form at the backward's shapes, then every
    instance (``check_rows``) at ``ROWS_SHAPES``, 8 bits, bit-exact with the
    plain version."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda

    # the backward's shapes: CogVideoX-2B's layer, and the causal GQA case
    for (b, h, s, d), dtype in (((1, 30, 17776, 64), torch.bfloat16),
                                ((1, 32, 2048, 128), torch.bfloat16),
                                ((1, 4, 1000, 64), torch.float32)):
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype) * 3
        fold = d**-0.5 * LOG2E
        qi, qs = quant_cuda.quant_q_per_token(q, scale_fold=fold)
        qi_p, qs_p = quant_cuda.quant_q_per_token_plain(q, scale_fold=fold)
        torch.cuda.synchronize()
        exact = torch.equal(qi, qi_p) and torch.equal(qs, qs_p)
        log(f"quant_q_per_token {(b, h, s, d)} {dtype}: bit-exact {exact}")
        require(exact, "quant_q_per_token is not bit-exact with the spec")
        if (b, h, s, d) == (1, 30, 17776, 64):
            results["quant_q_per_token"]["max_abs_err"] = float(
                (qi.int() - qi_p.int()).abs().max().item())
    # every instance of kernel 4, from a generator of its own
    from sageattention_tpu_torch.utils.ab_common import offset_rows

    gen_r = torch.Generator(device="cuda")
    gen_r.manual_seed(44)
    for shape, dtype in ROWS_SHAPES:
        check_rows(offset_rows(gen_r, shape, dtype), 8)


# kernel 4's checked shapes: the CogVideoX-2B and Wan2.1 layers, (1, 16,
# 4096, d) above 128, ragged fp32 at every head dim, and fp16 q's values
# (widened to fp32, smooth_q's cast back to fp16) at a ragged d 128
ROWS_SHAPES = ((tuple(COG.values()), "bf16"), (tuple(WAN.values()), "bf16"),
               *(((1, 16, 4096, d), "bf16") for d in (256, 384, 512)),
               *(((2, 5, 4001, d), "fp32") for d in (64, 128, 256, 384, 512)),
               ((1, 8, 4001, 128), "fp16"))


def check_rows(x, bits: int) -> None:
    """Kernel 4 at every group and form (``ab_common.rows_cases``, the mean
    kernel 2's) against its plain version given the same mean, bit for
    bit."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda as qc
    from sageattention_tpu_torch.utils.ab_common import rows_cases

    b, h, s, d = x.shape
    fold = d**-0.5 * LOG2E
    mean = qc.k_channel_mean(x)
    for group, form, m, c in rows_cases(x, mean):
        kw = dict(group=group, cast=c, scale_fold=fold, bits=bits)
        qi, qs = qc.quant_q_per_token(x, m, **kw)
        qi_p, qs_p = qc.quant_q_per_token_plain(x, m, **kw)
        exact = torch.equal(qi, qi_p) and torch.equal(qs, qs_p)
        plan = qc.quant_q_plan(b * h, s, d, x.element_size(), group, mean=m is not None)
        what = (f"quant_q_per_token {tuple(x.shape)} {x.dtype} group {group} {form} {bits} bits, "
                f"plan {tuple(plan)}")
        torch.cuda.synchronize()
        log(f"{what}: bit-exact {exact}")
        require(exact, f"{what}: not bit-exact with the plain version")
        del qi, qs, qi_p, qs_p


def backward_case(gen, b, hq, hkv, sq, sk, d, causal, window=None, bias=None):
    """Random bf16 q, k, v, dO; the forward's residuals and the backward
    kernels' operands, built as the op builds them (the masked forward with
    a ``window`` or a ``bias``)."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import autodiff

    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = (torch.randn(b, hkv, sk, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
    masks = core._masks(q, k, is_causal=causal, attn_bias=bias, window=window)
    f = core._forward(q, k, v, is_causal=causal, sm_scale=None, smooth_k=True,
                      return_lse=True, masks=masks)
    ops = autodiff.backward_operands(q, k, v, do, o=f.o, k_i8=f.k_i8, km=f.km, dlse=None,
                                     sm_scale=f.sm_scale)
    ops.update(k_i8=f.k_i8, k_scale=f.k_scale, lse2=f.lse2)
    return ops, f.sm_scale


def dq_args(ops):
    return [ops[n] for n in ("q_i8", "q_scale", "k_i8", "k_scale", "k_sm", "v", "do",
                             "lse2", "dvec")]


def dkv_args(ops):
    return [ops[n] for n in ("q_i8", "q_scale", "q_bf", "k_i8", "k_scale", "v", "do",
                             "lse2", "dvec")]


def check_backward(gen, results):
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    cases = [
        # as check_attention; at the model shape a few heads, whose plain
        # [s,s] scores are computed one head at a time
        ("cogvideox layer", 1, 30, 30, 17776, 17776, 64, False, (0, 15, 29)),
        ("causal gqa", 1, 32, 8, 2048, 2048, 128, True, None),
        ("ragged causal", 1, 4, 4, 1000, 1000, 64, True, None),
        ("rectangular", 2, 4, 2, 300, 1111, 64, False, None),
    ]
    for name, b, hq, hkv, sq, sk, d, causal, heads in cases:
        ops, sm = backward_case(gen, b, hq, hkv, sq, sk, d, causal)
        kw = dict(is_causal=causal, sm_scale=sm)
        dq = bwd.sage_attention_bwd_dq(*dq_args(ops), **kw)
        dk, dv = bwd.sage_attention_bwd_dkv(*dkv_args(ops), **kw)
        torch.cuda.synchronize()
        if heads is not None:  # q head h with kv head h (no GQA here)
            hs = list(heads)
            ops = {n: x[:, hs].contiguous() for n, x in ops.items()}
            dq, dk, dv = (x[:, hs] for x in (dq, dk, dv))
        dq_p = bwd.sage_attention_bwd_dq_plain(*dq_args(ops), **kw)
        dk_p, dv_p = bwd.sage_attention_bwd_dkv_plain(*dkv_args(ops), **kw)
        errs = []
        for gname, g, gp in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
            cos = cosine_similarity(g.cpu(), gp.cpu())
            rel = ((g - gp).abs().max() / gp.abs().max()).item()
            finite = bool(torch.isfinite(g).all())
            errs.append((gname, cos, rel, (g - gp).abs().max().item()))
            log(f"backward {name} {(b, hq, hkv, sq, sk, d)} causal={causal} {gname}: cos "
                f"{cos:.7f}, max abs / max|g| {rel:.3e}, finite {finite} (heads "
                f"{heads if heads is not None else 'all'})")
            require(finite and cos >= 0.9999 and rel <= 1e-2,
                    f"backward {name}: {gname} kernel disagrees with its plain version")
        if name == "cogvideox layer":
            results["sage_attn_bwd_dq"]["max_abs_err"] = errs[0][3]
            results["sage_attn_bwd_dkv"]["max_abs_err"] = max(errs[1][3], errs[2][3])
        del ops, dq, dk, dv, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()

    # cases the tiling and CTA order of the instances without a bias must get
    # right, from a generator of their own (the later phases' inputs stay as
    # they were): GQA rep 4 at d 128, ragged, causal with a window of 300 (a
    # dQ CTA's two warpgroups see different KV ranges, a dK/dV CTA walks four
    # heads); at d 256 a length that ends inside a pipeline stage
    gen_t = torch.Generator(device="cuda")
    gen_t.manual_seed(13)
    for name, hq, hkv, s, d, window in (("gqa4 ragged window", 32, 8, 1000, 128, 300),
                                        ("d256 ragged causal", 16, 8, 3001, 256, None)):
        ops, sm = backward_case(gen_t, 1, hq, hkv, s, s, d, True, window=window)
        kw = dict(is_causal=True, sm_scale=sm, window=window)
        got = (bwd.sage_attention_bwd_dq(*dq_args(ops), **kw),
               *bwd.sage_attention_bwd_dkv(*dkv_args(ops), **kw))
        want = (bwd.sage_attention_bwd_dq_plain(*dq_args(ops), **kw),
                *bwd.sage_attention_bwd_dkv_plain(*dkv_args(ops), **kw))
        torch.cuda.synchronize()
        for gname, g, gp in zip(("dq", "dk", "dv"), got, want):
            cos, rel, _ = agreement(g, gp)
            finite = bool(torch.isfinite(g).all())
            log(f"backward {name} {(1, hq, hkv, s, d)} causal window={window} {gname}: cos "
                f"{cos:.7f}, max abs / max|g| {rel:.3e}, finite {finite}")
            require(finite and cos >= 0.9999 and rel <= 1e-2,
                    f"backward {name}: {gname} kernel disagrees with its plain version")
        del ops, got, want
        torch.cuda.empty_cache()

    # the op's gradients (through the LSE too) against exact fp32 attention's
    b, hq, hkv, s, d = 1, 32, 8, 2048, 128
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(b, s, hq, d, generator=gen, device="cuda")
    w = torch.randn(b, hq, s, generator=gen, device="cuda")
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = core.sageattn(*xs, tensor_layout="NHD", is_causal=True, return_lse=True)
    g_s = torch.autograd.grad((o.float() * do).sum() + (lse * w).sum(), xs)
    xr = [x.float().transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    o_r, lse_r = reference.attention_reference(*xr, is_causal=True, return_lse=True)
    g_r = torch.autograd.grad((o_r * do.transpose(1, 2)).sum() + (lse_r * w).sum(), xr)
    coss = [cosine_similarity(a.transpose(1, 2).float().cpu(), r.cpu())
            for a, r in zip(g_s, g_r)]
    log(f"sageattn grads vs exact fp32 (NHD, GQA 32/8, causal, 2048, d128, through o and "
        f"lse): cos dq {coss[0]:.6f} dk {coss[1]:.6f} dv {coss[2]:.6f}")
    require(min(coss) >= 0.999, "sageattn gradients vs exact attention: cosine < 0.999")


# --------------------------------------------------------------------------
# phase 2, masks: the masked forward, varlen and the windowed backward
# --------------------------------------------------------------------------


def layer_operands(gen, b, s, *, hq=LLM_LAYER["hq"], hkv=LLM_LAYER["hkv"], d=LLM_LAYER["d"]):
    """Random bf16 q, k, v [b, h, s, d] and the K codes and scales the op
    builds from k (smoothed)."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda

    q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    return q, k, v, k_i8, k_sc


def live_pairs(masks, b: int, sq: int, sk: int, causal: bool, heads: int) -> int:
    """The (row, col) pairs a window or varlen's ranges leave live, summed
    over batch and the query heads (the work of a masked call), counted
    from this run's masks on the card."""
    from sageattention_tpu_torch.ops import reference

    m = reference._build_mask(sq, sk, is_causal=causal, device="cuda", window=masks.window,
                              q_kv_lo=masks.kv_lo, q_kv_hi=masks.kv_hi)
    n = int(m.sum())  # [sq, sk], or [1, 1, sq, sk] from the ranges of batch 1
    return n * heads * (b if m.dim() == 2 else 1)


def masked_bound(pairs: int, d: int, moved: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of a forward over ``pairs`` live (row, col)
    pairs, int8 Q.K^T and bf16 P.V at 2d operations each, that reads and
    writes ``moved`` bytes, at the data-sheet peaks."""
    t_ops = 2 * pairs * d * (1 / PEAK_INT8_OPS_S + 1 / PEAK_BF16_FLOP_S) * 1e3
    t_bytes = moved / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def heads_of(masks, hs):
    """The masks of the query heads ``hs``: a per-head mask or bias sliced."""
    def pick(x):
        return x[:, hs] if x is not None and x.shape[1] > 1 else x

    return masks._replace(mask=pick(masks.mask), bias=pick(masks.bias))


def compare_masked(name, q, k_i8, k_sc, v, masks, causal, hs, results,
                   key: str = "sage_attn_fwd_masked") -> None:
    """The masked kernel against its plain version on the query heads
    ``hs`` (the plain version's [s, s] scores one head at a time): o
    cosine >= 0.9999 and max-abs <= 2e-2, lse2 <= 1e-3 on live rows, and
    the same dead rows, exactly 0 and -inf, on both sides."""
    import torch
    from sageattention_tpu_torch.ops import attention_cuda
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    hq, hkv, d = q.shape[1], k_i8.shape[1], q.shape[-1]
    fold = d**-0.5 * LOG2E
    o, l2 = attention_cuda.sage_attention_fwd_masked(q, k_i8, k_sc, v, masks=masks,
                                                     is_causal=causal, q_fold=fold,
                                                     return_lse=True)
    kvs = [h // (hq // hkv) for h in hs]
    o_p, l2_p = attention_cuda.sage_attention_plain(
        q[:, hs].contiguous(), k_i8[:, kvs].contiguous(), k_sc[:, kvs].contiguous(),
        v[:, kvs].contiguous(), is_causal=causal, q_fold=fold, return_lse=True,
        masks=heads_of(masks, hs))
    torch.cuda.synchronize()
    o_k, l2_k = o[:, hs].float(), l2[:, hs]
    dead = torch.isneginf(l2_p)
    same_dead = torch.equal(torch.isneginf(l2_k), dead)
    zero = bool((o_k[dead] == 0).all()) and bool((o_p.float()[dead] == 0).all())
    cos = cosine_similarity(o_k.cpu(), o_p.float().cpu())
    err = (o_k - o_p.float()).abs().max().item()
    lerr = (l2_k[~dead] - l2_p[~dead]).abs().max().item()
    finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2[~torch.isneginf(l2)]).all())
    log(f"masked attention {name} causal={causal}: cos {cos:.6f}, max abs {err:.3e}, lse2 max "
        f"abs {lerr:.3e} (heads {list(hs)}); dead rows {int(dead.sum())}, the same and 0 / -inf "
        f"{same_dead and zero}; finite {finite}")
    require(finite and same_dead and zero, f"masked attention {name}: dead rows or non-finite")
    require(cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
            f"masked attention {name} disagrees with its plain version")
    r = results[key]
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)


def op_vs_exact(name, q, k, v, causal, kwargs, *, varlen_cu=None, floor: float = 0.999) -> float:
    """``sageattn`` (or ``sageattn_varlen`` with ``varlen_cu``) with the masks
    (or the Q/K options) against exact fp32 attention with the same masks,
    on the rows with a live key (cosine >= ``floor``); its dead rows must
    be exactly 0 with LSE -inf.  Returns the cosine."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    if varlen_cu is None:
        o, lse = core.sageattn(q, k, v, is_causal=causal, return_lse=True, **kwargs)
    else:
        o, lse = core.sageattn_varlen(*(x[0].transpose(0, 1) for x in (q, k, v)), varlen_cu,
                                      varlen_cu, is_causal=causal, return_lse=True, **kwargs)
        o, lse = o.transpose(0, 1)[None], lse[None]
        seg = core.varlen_rows(varlen_cu, varlen_cu, q.shape[2], q.shape[2])[0][None]
        kwargs = dict(q_segment_ids=seg, kv_segment_ids=seg)
    ref = {n: x for n, x in kwargs.items()
           if n not in ("pv_dtype", "smooth_k_mode", "smooth_q", "qk_bits", "qk_quant_gran")}
    o_r = reference.attention_reference(q, k, v, is_causal=causal, **ref)
    live = torch.isfinite(lse)
    cos = cosine_similarity(o.float()[live].cpu(), o_r.float()[live].cpu())
    dead_ok = bool((o[~live] == 0).all()) and bool(torch.isneginf(lse[~live]).all())
    log(f"{name} vs exact fp32 attention on the {int(live.sum())} live rows: cos {cos:.6f}; "
        f"{int((~live).sum())} dead rows exactly 0 with LSE -inf {dead_ok}")
    require(cos >= floor and dead_ok, f"{name}: disagrees with exact attention")
    return cos


def varlen_masks():
    """cu_seqlens of VARLEN_LENS, each packed token's sequence, and the
    masked kernel's per-row key ranges, through ``sageattn_varlen``'s own
    packing (``core.varlen_rows``)."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    s = sum(VARLEN_LENS)
    cu = torch.tensor([0, *itertools.accumulate(VARLEN_LENS)], device="cuda")
    seg, _, lo, hi = core.varlen_rows(cu, cu, s, s)
    return cu, seg, Masks(kv_lo=lo[None], kv_hi=hi[None])


def zigzag(s: int, parts: int = 4):
    """Positions of a zig-zag ring split: chunk i beside chunk 2n-1-i."""
    import torch

    chunks = torch.arange(s, device="cuda").chunk(2 * parts)
    return torch.cat([c for i in range(parts) for c in (chunks[i], chunks[2 * parts - 1 - i])])


def alibi_slopes(hq: int):
    """ALiBi's standard per-head slopes 2^(-8 h / hq), h = 1..hq, fp32."""
    import torch

    return 2.0 ** (-8.0 * torch.arange(1, hq + 1, device="cuda", dtype=torch.float32) / hq)


def alibi_bias(slopes, s: int):
    """ALiBi-style fp32 bias [1, hq, s, s]: -slope_h * |row - col|, built in
    autograd from ``slopes``."""
    import torch

    idx = torch.arange(s, device="cuda")
    return (-slopes[:, None, None] * (idx[:, None] - idx[None, :]).abs().float())[None]


def alibi(hq: int, s: int):
    """The standard ALiBi bias [1, hq, s, s] fp32."""
    return alibi_bias(alibi_slopes(hq), s)


def check_masked(gen, results) -> dict:
    """The masked forward kernel at the llm-8b-gqa layer, through
    ``core`` (masks normalised as a user passes them) and directly."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops.attention_cuda import Masks
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    hs = (0, 13, 31)  # compared query heads: kv heads 0, 3 and 7
    out = {}
    # (a) the window at the windowed prefill's layer (its main path), and a
    # ragged one: lengths off the 64-row and 128-column tiles, a window off
    # the 128-column tile
    for b, s, w in ((2, 8192, 4096), (1, 3001, 1000)):
        q, k, v, k_i8, k_sc = layer_operands(gen, b, s)
        compare_masked(f"window {w} at {(b, s)}", q, k_i8, k_sc, v, Masks(window=w), True, hs,
                       results)
        if b == 1:  # exact fp32 scores of all 32 heads fit at this size
            out[f"window {w} at {s} vs exact"] = op_vs_exact(
                f"sageattn window {w} at {(b, s)}", q, k, v, True, dict(window=w))
        del q, k, v, k_i8, k_sc
    # (b) varlen: four causal prompts packed, the kernel's per-row ranges
    s = sum(VARLEN_LENS)
    q, k, v, k_i8, k_sc = layer_operands(gen, 1, s)
    cu, _, masks = varlen_masks()
    compare_masked(f"varlen {VARLEN_LENS}", q, k_i8, k_sc, v, masks, True, hs, results)
    kw = dict(smooth_k_mode="per_segment", pv_dtype="bf16")
    out["varlen_vs_exact"] = op_vs_exact("sageattn_varlen (per_segment, bf16 V)", q, k, v, True,
                                         kw, varlen_cu=cu)
    o_v = core.sageattn_varlen(*(x[0].transpose(0, 1) for x in (q, k, v)), cu, cu,
                               is_causal=True, **kw)
    # against one sageattn a sequence: on the K that per_segment quantizes,
    # bf16(K - the sequence's mean) without further smoothing (the same
    # codes, so >= 0.9999), and with sageattn's own smoothing, which
    # subtracts the mean in fp32 and so quantizes other K codes (two
    # independent quantizations: >= 0.999)
    same, own = [], []
    for i in range(len(VARLEN_LENS)):
        r = slice(int(cu[i]), int(cu[i + 1]))
        k_c = (k[:, :, r].float() - k[:, :, r].float().mean(dim=2, keepdim=True)).to(k.dtype)
        o_v_i = o_v[r].transpose(0, 1)[None].float().cpu()
        for cos, kk, smooth in ((same, k_c, False), (own, k[:, :, r], True)):
            o_i = core.sageattn(q[:, :, r], kk, v[:, :, r], is_causal=True, smooth_k=smooth)
            cos.append(cosine_similarity(o_v_i, o_i.float().cpu()))
    log(f"sageattn_varlen vs four sageattn calls, one a sequence, on per_segment's centred bf16 "
        f"K: cos {[round(c, 7) for c in same]}; with sageattn's own K smoothing: cos "
        f"{[round(c, 7) for c in own]}")
    require(min(same) >= 0.9999 and min(own) >= 0.999,
            "sageattn_varlen disagrees with the per-sequence calls")
    out["varlen_vs_per_sequence"] = {"same_k": same, "own_smoothing": own}
    del q, k, v, k_i8, k_sc

    # (c) the masks at 4096 tokens
    s = 4096
    q, k, v, k_i8, k_sc = layer_operands(gen, 1, s)
    idx = torch.arange(s, device="cuda")
    # keys from 3500 padded out; rows 1000-1063 (a whole Q tile) and the
    # last 96 (a tile and a half) dead
    pad = (idx[None, :] < 3500) & ~((idx[:, None] >= 1000) & (idx[:, None] < 1064))
    pad[4000:] = False
    bias = alibi(LLM_LAYER["hq"], s)
    ids = ((idx // 512) % 3).int()[None]  # 0,1,2,0,1,2,0,1: non-contiguous
    pos = zigzag(s).int()[None]
    cases = [
        ("padding mask [1,1,s,s] with dead rows", False, dict(attn_mask=pad[None, None])),
        ("ALiBi bias [1,32,s,s]", False, dict(attn_bias=bias)),
        ("ALiBi bias [1,32,s,s]", True, dict(attn_bias=bias)),
        ("non-contiguous segment ids", False, dict(q_segment_ids=ids, kv_segment_ids=ids)),
        ("zig-zag positions", False, dict(q_positions=pos, kv_positions=pos)),
    ]
    for name, causal, kwargs in cases:
        masks = core._masks(q, k, is_causal=causal, **kwargs)
        compare_masked(name, q, k_i8, k_sc, v, masks, causal, hs, results)
        out[f"{name} causal={causal} vs exact"] = op_vs_exact(
            f"sageattn {name} causal={causal}", q, k, v, causal, kwargs)
    # a bias whose rows start off a column pair's alignment (a view with an
    # odd row stride): the threads load it, where the contiguous one above
    # is staged by cp.async
    odd = alibi(LLM_LAYER["hq"], s + 1)[..., :s, :s]
    compare_masked("ALiBi bias [1,32,s,s] with an odd row stride", q, k_i8, k_sc, v,
                   Masks(bias=odd), True, hs, results)
    del q, k, v, k_i8, k_sc, bias, odd
    torch.cuda.empty_cache()
    return out


def check_window_backward(gen, results) -> dict:
    """(d) The windowed backward at (1, 32/8, 4096, 128, window 1024): dQ
    and dK/dV against their plain versions, and ``sageattn``'s gradients
    against exact attention's."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    b, s, w = 1, 4096, 1024
    hq, hkv, d = LLM_LAYER.values()
    ops, sm = backward_case(gen, b, hq, hkv, s, s, d, True, window=w)
    kw = dict(is_causal=True, sm_scale=sm, window=w)
    got = (bwd.sage_attention_bwd_dq(*dq_args(ops), **kw),
           *bwd.sage_attention_bwd_dkv(*dkv_args(ops), **kw))
    want = (bwd.sage_attention_bwd_dq_plain(*dq_args(ops), **kw),
            *bwd.sage_attention_bwd_dkv_plain(*dkv_args(ops), **kw))
    torch.cuda.synchronize()
    for gname, g, gp, key in zip(("dq", "dk", "dv"), got, want,
                                 ("sage_attn_bwd_dq", "sage_attn_bwd_dkv", "sage_attn_bwd_dkv")):
        cos = cosine_similarity(g.cpu(), gp.cpu())
        rel = ((g - gp).abs().max() / gp.abs().max()).item()
        log(f"backward window {w} {(b, hq, hkv, s, d)} {gname}: cos {cos:.7f}, max abs / "
            f"max|g| {rel:.3e}, finite {bool(torch.isfinite(g).all())}")
        require(bool(torch.isfinite(g).all()) and cos >= 0.9999 and rel <= 1e-2,
                f"windowed backward: {gname} kernel disagrees with its plain version")
        r = results[key].setdefault("window", {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), (g - gp).abs().max().item())
    del ops, got, want
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    do = torch.randn(b, hq, s, d, generator=gen, device="cuda")
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    g_s = torch.autograd.grad((core.sageattn(*xs, is_causal=True, window=w).float() * do).sum(),
                              xs)
    xr = [x.float().detach().requires_grad_() for x in (q, k, v)]
    g_r = torch.autograd.grad(
        (reference.attention_reference(*xr, is_causal=True, window=w) * do).sum(), xr)
    coss = [cosine_similarity(a.float().cpu(), r.cpu()) for a, r in zip(g_s, g_r)]
    log(f"sageattn grads with window {w} vs exact fp32 (GQA 32/8, causal, {s}, d128): cos dq "
        f"{coss[0]:.6f} dk {coss[1]:.6f} dv {coss[2]:.6f}")
    require(min(coss) >= 0.999, "windowed gradients vs exact attention: cosine < 0.999")
    del xs, xr, g_s, g_r
    torch.cuda.empty_cache()
    return {"shape": [b, hq, hkv, s, d], "window": w, "grad_cos_vs_exact": coss}


# --------------------------------------------------------------------------
# phase 2, the bias backward: kernels 7-8's bias instances
# --------------------------------------------------------------------------


def agreement(g, gp) -> tuple[float, float, float]:
    """(cosine, max-abs error / max |plain|, max-abs error) of a kernel's
    output ``g`` against its plain version ``gp``, summed in fp64 on the
    card (a dBias of 537 M entries stays there)."""
    a, b = g.double().flatten(), gp.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    cos = 1.0 if na == 0 and nb == 0 else (a @ b).item() / max(na * nb, 1e-300)
    err = (a - b).abs().max().item()
    return cos, err / max(b.abs().max().item(), 1e-30), err


# check_bias_backward's cases: name, (hq, hkv, d), s, causal, bias dtype,
# the (head, row) biased to -inf on every key or None.  The llm-8b-gqa layer
# runs the d128 instances, CogVideoX-2B's 30 heads of 64 the d64 ones; the
# kernels read a bias by TMA where a row is a multiple of 16 bytes, and a
# bf16 bias at 3001 tokens (6002 bytes a row) by each thread's loads.
BIAS_CASES = (
    ("ALiBi", (32, 8, 128), 4096, True, "float32", None),
    ("random bias, a dead row", (32, 8, 128), 4000, False, "float32", (5, 1234)),
    ("bf16 ALiBi", (32, 8, 128), 4096, True, "bfloat16", None),
    ("d64, random bias, a dead row", (30, 30, 64), 4000, False, "float32", (17, 2222)),
    ("d64, bf16 random bias, a dead row", (30, 30, 64), 3001, True, "bfloat16", (3, 2999)),
    ("bf16 random bias, ragged 3001, a dead row", (32, 8, 128), 3001, True, "bfloat16",
     (7, 2000)),
)
# the D = 256 instances (phase 7a): the Gemma-7B layer's 16/16 heads of 256,
# causal ALiBi in fp32 and bf16, and d 192 (padded) at 16/8 heads, a
# ragged 4000 tokens, non-causal, a random per-head bias, and a bf16 random
# bias at a ragged 3001 (dQ's loads; dK/dV loads it at 256 either way);
# each with a row biased to -inf on every key
BIAS_CASES_HD256 = (
    ("d256 ALiBi, a dead row", (16, 16, 256), 4096, True, "float32", (3, 777)),
    ("d256 bf16 ALiBi, a dead row", (16, 16, 256), 4096, True, "bfloat16", (9, 4095)),
    ("d192, random bias, a dead row", (16, 8, 192), 4000, False, "float32", (5, 1234)),
    ("d256 bf16 random bias, ragged 3001, a dead row", (16, 16, 256), 3001, True, "bfloat16",
     (2, 3000)),
)


def check_bias_backward(results, cases=BIAS_CASES, seed: int = 17, suffix: str = "") -> dict:
    """Kernels 7-8's bias instances against their plain versions, dBias
    included (BIAS_CASES): at the llm-8b-gqa layer (1, 32/8, s, 128) causal
    with the ALiBi bias at 4096 tokens in fp32 and in bf16, non-causal
    with a seeded per-head random bias at 4000 tokens (off the 64-row and
    128-column tiles), and causal with a bf16 random one at a ragged 3001;
    at CogVideoX-2B's heads (1, 30, s, 64) non-causal at 4000 tokens (fp32)
    and causal at a ragged 3001 (bf16).  A case with a
    dead row biases one query row to -inf on every key: its dq and dBias
    must be exactly 0 on both sides.  Held to the backward agreement of
    PERF.md section 2: cosine >= 0.9999 and max-abs <= 1e-2 of the largest
    entry.  Its inputs come from a generator of its own, so the phases after
    it see the inputs they saw before it was added.  ``cases``, ``seed`` and
    the counters' ``suffix`` serve the D = 256 instances too (phase 7a,
    BIAS_CASES_HD256)."""
    import torch
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for name, (hq, hkv, d), s, causal, dtype, dead in cases:
        if name.endswith("ALiBi"):
            bias = alibi(hq, s)
        else:
            bias = torch.randn(1, hq, s, s, generator=gen, device="cuda")
        bias = bias.to(getattr(torch, dtype))
        if dead is not None:
            bias[0, dead[0], dead[1]] = -torch.inf
        ops, sm = backward_case(gen, 1, hq, hkv, s, s, d, causal, bias=bias)
        kw = dict(is_causal=causal, sm_scale=sm, bias=bias)
        got = (*bwd.sage_attention_bwd_dq(*dq_args(ops), need_dbias=True, **kw),
               *bwd.sage_attention_bwd_dkv(*dkv_args(ops), **kw))
        want = (*bwd.sage_attention_bwd_dq_plain(*dq_args(ops), need_dbias=True, **kw),
                *bwd.sage_attention_bwd_dkv_plain(*dkv_args(ops), **kw))
        torch.cuda.synchronize()
        require(got[1].dtype == bias.dtype, f"bias backward {name}: dBias is not {dtype}")
        row = {}
        shape = (1, hq, hkv, s, d)
        for gname, g, gp, key in zip(("dq", "dbias", "dk", "dv"), got, want,
                                     ("sage_attn_bwd_dq_bias", "sage_attn_bwd_dq_bias",
                                      "sage_attn_bwd_dkv_bias", "sage_attn_bwd_dkv_bias")):
            cos, rel, err = agreement(g, gp)
            finite = bool(torch.isfinite(g).all())
            row[gname] = {"cos": cos, "max_abs_over_max": rel}
            pad0 = gname == "dbias" or bool((g[..., d:] == 0).all())
            log(f"bias backward {name} {shape} causal={causal} {dtype} {gname}: cos "
                f"{cos:.7f}, max abs / max|g| {rel:.3e}, finite {finite}, pad lanes 0 {pad0}")
            require(finite and pad0 and cos >= 0.9999 and rel <= 1e-2,
                    f"bias backward {name}: {gname} kernel disagrees with its plain version")
            r = results[key + suffix]
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if dead is not None:
            h, i = dead
            is_dead = bool(torch.isneginf(ops["lse2"][0, h, i]))
            zero = all(bool((x[0, h, i] == 0).all()) for x in (got[0], got[1], want[0],
                                                               want[1]))
            log(f"bias backward {name}: the dead row's lse2 -inf {is_dead}, its dq and dBias "
                f"exactly 0 on both sides {zero}")
            require(is_dead and zero, f"bias backward {name}: the dead row's dq or dBias is "
                                      "not 0")
        out[name] = {"shape": shape, "causal": causal, "bias_dtype": dtype, **row}
        del ops, got, want, bias
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the Q/K options: kernel 1's slices (h), (i), (k) and kernels 2-4 at 4 bits
# --------------------------------------------------------------------------

# name -> sageattn's options, each a path through the pre-quantized forward
QOPTS = {
    "per_token": dict(qk_quant_gran="per_token"),
    "per_subtile": dict(qk_quant_gran="per_subtile"),
    "per_block": dict(qk_quant_gran="per_block"),
    "smooth_q": dict(smooth_q=True),
    "int4": dict(qk_bits=4),
    "int4+smooth_q": dict(qk_bits=4, smooth_q=True),
}
# bench/bench_accuracy.py's configurations of the JAX package, copied
SWEEP = [
    ("int8 default (smooth_k)", dict()),
    ("int8 + smooth_q", dict(smooth_q=True)),
    ("int8 + smooth_v", dict(smooth_v=True)),
    ("int8 no smoothing", dict(smooth_k=False)),
    ("bf16 PV", dict(pv_dtype="bf16")),
    ("fp8 PV", dict(pv_dtype="fp8")),
    ("per-token gran", dict(qk_quant_gran="per_token")),
    ("per-subtile gran", dict(qk_quant_gran="per_subtile")),
    ("per-block gran", dict(qk_quant_gran="per_block")),
    ("int4 QK", dict(qk_bits=4)),
    ("int4 QK + smooth_q", dict(qk_bits=4, smooth_q=True)),
]
# the sweep's floors against exact attention: 0.999 for 8 bits (the verify
# skill's); 0.97 for int4, the int4 KV cache's floor, on "normal" inputs and
# with smooth_q on both.  int4 without smooth_q on "biased" inputs is
# printed, not held: the JAX arithmetic itself gives 0.86-0.93 there
# (XLA path on the CPU, (1, 2, 2048, 64/128)).
SWEEP_FLOOR = {8: 0.999, 4: 0.97}
# bf16 V with smooth_v on bf16 inputs: V - mean is cast back to bf16
# (``core.py:378-380`` of the JAX package), and where the channel mean is
# under half a bf16 step of v the cast gives v back, so the epilogue adds
# the mean to an uncentred V; the error grows with the length as the
# output shrinks.  That is the JAX arithmetic (tests/test_torch_core.py
# holds the port to it); this sweep measured it at 0.99871 (CogVideoX-2B)
# and 0.99783 (Wan2.1) on an H100.  Held at 0.997.
SWEEP_FLOOR_BY_CONFIG = {"int8 + smooth_v": 0.997}
# "int8 no smoothing" on "biased" inputs, the offsets that smooth_k exists
# to remove: at the Wan2.1 layer the cosine moves with the inputs, 0.999203
# to 0.999469 over the spread's five seeds, 0.999240 on the sweep's, and
# 0.998969 on another input set (H100).  The plain version of the same
# arithmetic gives the kernel's cosine to 1e-6 on three heads, and on the
# CPU the JAX XLA path gives the port's to 1e-7
# (tests/test_torch_sweep_witness.py): the shortfall is the arithmetic's.
# Held at 0.9985: the lowest reading's shortfall from 1 (1.03e-3) and half
# as much again.
SWEEP_FLOOR_BIASED = {"int8 no smoothing": 0.9985}


def biased_qk(gen, shape, offset: float = 0.5):
    """bf16 q, k, v [b, h, s, d] with per-channel offsets on Q and K, the
    regime smooth_q and smooth_k exist for."""
    import torch

    b, h, s, d = shape
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for _ in range(3))
    q = q + torch.randn(1, 1, 1, d, generator=gen, device="cuda") * offset
    k = k + torch.randn(1, 1, 1, d, generator=gen, device="cuda") * offset
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def check_quant_4bit(gen, results):
    """Kernels 2-4 at bits=4 against their plain versions at the
    CogVideoX-2B layer: kernel 3 fed the plain km bit-exact; the whole K
    prologue (kernel 2's own km) within one code step on at most 1e-4 of
    the entries; kernel 4 bit-exact on Q and on smooth_q's centred Q, and
    at every group and form (``check_rows``) at ``ROWS_SHAPES``."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import quant_cuda

    q, k, _ = biased_qk(gen, tuple(COG.values()), offset=3.0)
    km_ref = quant_cuda.k_channel_mean_plain(k)
    ki, ks = quant_cuda.quant_k_chunked(k, km_ref, group=128, bits=4)
    ki_p, ks_p = quant_cuda.quant_k_chunked_plain(k, km_ref, group=128, bits=4)
    kf, _, _ = quant_cuda.quant_k_fused_mean(k, group=128, bits=4)
    torch.cuda.synchronize()
    exact = torch.equal(ki, ki_p) and torch.equal(ks, ks_p)
    diff = (kf.int() - ki_p.int()).abs()
    frac = (diff > 0).float().mean().item()
    log(f"quant_k 4 bits {tuple(k.shape)}: chunked bit-exact {exact}, codes in +-"
        f"{ki.abs().max().item()}; fused codes off {frac:.2e} (max {diff.max().item()})")
    require(exact and ki.abs().max().item() == 7, "quant_k_chunked at 4 bits is not the spec")
    require(diff.max().item() <= 1 and frac <= 1e-4, "quant_k at 4 bits: codes disagree")
    results["quant_k_chunked"]["bits4"] = {"max_abs_err": 0.0}
    fold = COG["d"] ** -0.5 * LOG2E
    for name, x in (("q", q), ("smooth_q's q - qm", core._smooth_q(q)[1])):
        qi, qs = quant_cuda.quant_q_per_token(x, scale_fold=fold, bits=4)
        qi_p, qs_p = quant_cuda.quant_q_per_token_plain(x, scale_fold=fold, bits=4)
        torch.cuda.synchronize()
        exact = torch.equal(qi, qi_p) and torch.equal(qs, qs_p)
        log(f"quant_q_per_token 4 bits on {name} {tuple(x.shape)}: bit-exact {exact}")
        require(exact, f"quant_q_per_token at 4 bits is not bit-exact with the spec ({name})")
    results["quant_q_per_token"]["bits4"] = {"max_abs_err": 0.0}
    # every instance of kernel 4 at 4 bits, from a generator of its own
    from sageattention_tpu_torch.utils.ab_common import offset_rows

    gen_r = torch.Generator(device="cuda")
    gen_r.manual_seed(45)
    for shape, dtype in ROWS_SHAPES:
        check_rows(offset_rows(gen_r, shape, dtype), 4)


def preq_operands(q, k, opts: dict):
    """The pre-quantized kernel's Q and K operands as ``sageattn`` builds
    them from bf16 q, k: (q_i8, q_scale, k_i8, k_scale, col_bias)."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import _build

    d = q.shape[-1]
    q_i8, q_sc, k_i8, k_sc, _, cb = core._quant_qk(
        q, k, core.QKOptions(**opts), work=torch.bfloat16, d_pad=_build.pad_head_dim(d),
        sm_scale=d**-0.5, smooth_k=True)
    return q_i8, q_sc, k_i8, k_sc, cb


def compare_preq(name, q, k, v, opts, causal, hs, results, masks=None,
                 key: str = "sage_attn_fwd_preq") -> None:
    """The pre-quantized kernel against its plain version on the query
    heads ``hs``, with bf16 V and with e4m3 V codes: o cosine >= 0.9999
    and max-abs <= 2e-2, lse2 <= 1e-3 (PERF.md section 2's limits); its
    error goes into the entry ``key``.  V comes at the kernel's head dim
    (padded), q and k at the caller's."""
    import torch
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    hq, hkv = q.shape[1], k.shape[1]
    kvs = [h // (hq // hkv) for h in hs]
    q_i8, q_sc, k_i8, k_sc, cb = preq_operands(q, k, opts)

    def sel(x, idx):
        return x[:, idx].contiguous() if x is not None else None

    v8, v8_sc, _ = quant_cuda.quant_v_per_channel(v, dtype=torch.float8_e4m3fn)
    for vname, vx, vs in (("bf16", v, None), ("e4m3", v8, v8_sc)):
        o, l2 = attention_cuda.sage_attention_fwd_preq(
            q_i8, q_sc, k_i8, k_sc, vx, vs, is_causal=causal, return_lse=True, col_bias=cb,
            masks=masks)
        o_p, l2_p = attention_cuda.sage_attention_preq_plain(
            sel(q_i8, hs), sel(q_sc, hs), sel(k_i8, kvs), sel(k_sc, kvs), sel(vx, kvs),
            sel(vs, kvs), is_causal=causal, return_lse=True, col_bias=sel(cb, hs),
            masks=heads_of(masks, hs) if masks is not None else None)
        torch.cuda.synchronize()
        o_k, l2_k = o[:, hs].float(), l2[:, hs]
        live = torch.isfinite(l2_p)
        cos = cosine_similarity(o_k.cpu(), o_p.float().cpu())
        err = (o_k - o_p.float()).abs().max().item()
        lerr = (l2_k[live] - l2_p[live]).abs().max().item()
        finite = bool(torch.isfinite(o).all())
        log(f"preq attention {name} {opts} causal={causal} V {vname}: cos {cos:.6f}, max abs "
            f"{err:.3e}, lse2 max abs {lerr:.3e} (heads {list(hs)}); finite {finite}")
        require(finite and cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                f"preq attention {name} {opts} V {vname} disagrees with its plain version")
        r = results[key]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)


def check_preq(gen, results) -> None:
    """The pre-quantized forward against its plain version for every option,
    bf16 and e4m3 V: at the CogVideoX-2B and Wan2.1 layers (non-causal), at
    the llm-8b-gqa layer (32/8 heads, causal, 4096 tokens: smooth_q's
    column bias differs between the query heads of a KV group) and over
    varlen's four packed prompts (the masked instances)."""
    import torch

    cases = [
        ("cogvideox layer", tuple(COG.values()), COG["h"], False, (0, 15, 29)),
        ("wan layer", tuple(WAN.values()), WAN["h"], False, (0, 6, 11)),
        ("llm layer", (1, LLM_LAYER["hq"], 4096, LLM_LAYER["d"]), LLM_LAYER["hkv"], True,
         (0, 13, 31)),
    ]
    for name, (b, hq, s, d), hkv, causal, hs in cases:
        q, _, _ = biased_qk(gen, (b, hq, s, d))
        _, k, v = biased_qk(gen, (b, hkv, s, d))
        for opts in QOPTS.values():
            compare_preq(name, q, k, v, opts, causal, hs, results)
        del q, k, v
    s = sum(VARLEN_LENS)
    q, _, _ = biased_qk(gen, (1, LLM_LAYER["hq"], s, LLM_LAYER["d"]))
    _, k, v = biased_qk(gen, (1, LLM_LAYER["hkv"], s, LLM_LAYER["d"]))
    _, _, masks = varlen_masks()
    for opts in QOPTS.values():
        compare_preq(f"varlen {VARLEN_LENS}", q, k, v, opts, True, (0, 13, 31), results,
                     masks=masks)
    del q, k, v
    torch.cuda.empty_cache()


def sweep_inputs(gen, dist: str, shape):
    """bench/bench_accuracy.py's inputs: standard normal q, k, v, and for
    "biased" the channel means linspace(-5, 5) on Q and linspace(3, -3) on
    K; bf16."""
    import torch

    b, h, s, d = shape
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for _ in range(3))
    if dist == "biased":
        q = q + torch.linspace(-5, 5, d, device="cuda")
        k = k + torch.linspace(3, -3, d, device="cuda")
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def sweep_floor(cname: str, kw: dict, dist: str) -> float | None:
    """The floor a sweep row is held to against exact attention, or None
    for a row that is printed, not held (int4 without smooth_q on "biased"
    inputs)."""
    bits = kw.get("qk_bits", 8)
    if bits == 4 and dist == "biased" and not kw.get("smooth_q", False):
        return None
    if dist == "biased" and cname in SWEEP_FLOOR_BIASED:
        return SWEEP_FLOOR_BIASED[cname]
    return SWEEP_FLOOR_BY_CONFIG.get(cname, SWEEP_FLOOR[bits])


def accuracy_sweep(gen) -> dict:
    """Every configuration of SWEEP at both DiT layer shapes, "normal" and
    "biased" inputs, against exact fp32 attention: cosine and worst-row
    cosine, and under "failed" each held row below its floor
    (:func:`sweep_floor`); ``main`` fails on those after the other phases
    have run."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    out = {"failed": []}
    for lname, shape in (("cogvideox layer", tuple(COG.values())),
                         ("wan layer", tuple(WAN.values()))):
        for dist in ("normal", "biased"):
            q, k, v = sweep_inputs(gen, dist, shape)
            o_r = reference.attention_reference(q.float(), k.float(), v.float())
            for cname, kw in SWEEP:
                o = core.sageattn(q, k, v, **kw).float()
                cos = cosine_similarity(o.cpu(), o_r.cpu())
                a, r = o.reshape(-1, shape[-1]), o_r.reshape(-1, shape[-1])
                row = ((a * r).sum(-1) / (a.norm(dim=-1) * r.norm(dim=-1)).clamp_min(1e-30))
                worst = row.min().item()
                floor = sweep_floor(cname, kw, dist)
                held = floor is not None
                log(f"accuracy {lname} {dist} {cname}: cos {cos:.6f}, worst row {worst:.6f}"
                    f"{f' (floor {floor})' if held else ' (printed, not held)'}")
                row = f"{lname} {dist} {cname}"
                if held and cos < floor:
                    out["failed"].append(f"{row}: cosine {cos:.6f} below {floor}")
                out[row] = {"cos": cos, "worst_row_cos": worst, "floor": floor}
            del q, k, v, o_r
            torch.cuda.empty_cache()
    return out


# the accuracy sweep read on more seeds: its 8-bit rows on "biased" inputs at
# the Wan2.1 layer sit closest to their floors, and their cosine moves with
# the inputs by a few 1e-4
SPREAD_SEEDS = (101, 102, 103, 104, 105)
SPREAD_HEADS = (0, 6, 11)
# the configurations whose plain version is also read on SPREAD_HEADS: its
# K codes with and without the smooth-k mean, bf16 and e4m3 V
SPREAD_WITNESS = {"int8 default (smooth_k)": (True, None),
                  "int8 no smoothing": (False, None),
                  "fp8 PV": (True, "float8_e4m3fn")}


def sweep_seed_spread(failed: list) -> dict:
    """The accuracy sweep's 8-bit configurations on "biased" inputs at the
    Wan2.1 layer for each seed of SPREAD_SEEDS (a generator of its own),
    against exact fp32 attention, each held to its floor
    (:func:`sweep_floor`; a row below it is appended to ``failed``).  For
    the configurations of SPREAD_WITNESS, a second witness: the plain
    version of the same arithmetic (``quant_k_chunked_plain``,
    ``quant_v_per_channel_plain``, ``sage_attention_plain``, which the CPU
    tests hold to the JAX package's XLA path) on the heads SPREAD_HEADS,
    beside the kernel's output on the same heads, both against exact
    attention.  Where the two cosines agree, a shortfall against exact
    attention is the arithmetic's, not the kernel's: the kernel's cosine
    must be within 1e-4 of the plain version's."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda, reference

    gen = torch.Generator(device="cuda")
    shape = tuple(WAN.values())
    d, hs = shape[-1], list(SPREAD_HEADS)
    out = {}
    for seed in SPREAD_SEEDS:
        gen.manual_seed(seed)
        q, k, v = sweep_inputs(gen, "biased", shape)
        o_r = reference.attention_reference(q.float(), k.float(), v.float())
        qh, kh, vh = (x[:, hs].contiguous() for x in (q, k, v))
        for cname, kw in SWEEP:
            if kw.get("qk_bits", 8) != 8:
                continue
            floor = sweep_floor(cname, kw, "biased")
            o = core.sageattn(q, k, v, **kw)
            cos = agreement(o, o_r)[0]
            rec = {"cos": cos, "floor": floor}
            msg = f"accuracy spread wan layer biased {cname} seed {seed}: cos {cos:.6f}"
            if cname in SPREAD_WITNESS:
                smooth, vdt = SPREAD_WITNESS[cname]
                km = quant_cuda.k_channel_mean_plain(kh) if smooth else None
                k_i8, k_sc = quant_cuda.quant_k_chunked_plain(kh, km, group=core.K_GROUP)
                vx, vs, vm = vh, None, None
                if vdt is not None:
                    vx, vs, vm = quant_cuda.quant_v_per_channel_plain(
                        vh, dtype=getattr(torch, vdt), smooth=False)
                o_p = attention_cuda.sage_attention_plain(
                    qh, k_i8, k_sc, vx, vs, vm, is_causal=False, q_fold=d**-0.5 * LOG2E,
                    return_lse=False)
                rec["heads_kernel_cos"] = agreement(o[:, hs], o_r[:, hs])[0]
                rec["heads_plain_cos"] = agreement(o_p, o_r[:, hs])[0]
                gap = abs(rec["heads_kernel_cos"] - rec["heads_plain_cos"])
                msg += (f"; heads {hs}: kernel {rec['heads_kernel_cos']:.6f}, plain "
                        f"{rec['heads_plain_cos']:.6f}")
                require(gap <= 1e-4, f"accuracy spread {cname} seed {seed}: the kernel's "
                                     f"cosine is {gap:.2e} from its plain version's")
                del o_p, k_i8, k_sc, vx
            log(msg + f" (floor {floor})")
            if cos < floor:
                failed.append(f"spread seed {seed} wan layer biased {cname}: cosine "
                              f"{cos:.6f} below {floor}")
            out[f"seed {seed} {cname}"] = rec
            del o
        del q, k, v, o_r, qh, kh, vh
        torch.cuda.empty_cache()
    return out


def random_cache(gen, lead, S, d, packed):
    """Seeded int8 (or packed) K/V codes and per-token scales on the card."""
    import torch

    rows = S // 2 if packed else S
    lo = -128 if packed else -127  # a packed byte holds any two nibbles

    def codes():
        return torch.randint(lo, 128, (*lead, rows, d), generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(lo, width):
        return torch.rand(*lead, S, generator=gen, device="cuda") * width + lo

    # K scales give scores of a few units; V scales keep |v| below about 1,
    # as the model's are, so that the bf16 outputs' step is near 2^-8
    return codes(), scales(0.01, 0.05), codes(), scales(0.002, 0.005)


def paged_from_dense(gen, cache, page):
    """The dense cache's tokens in a page pool through a scrambled table:
    (pool tensors, table)."""
    import torch

    k, ks, v, vs = cache
    b, hkv, S = ks.shape
    n = S // page
    table = torch.randperm(b * n, generator=gen, device="cuda").reshape(b, n).int()
    pool = []
    for x in (k, ks, v, vs):
        rpp = x.shape[2] // n  # rows a page (page/2 packed)
        pages = x.reshape(b, hkv, n, rpp, *x.shape[3:]).transpose(1, 2).reshape(
            b * n, hkv, rpp, *x.shape[3:])
        # contiguous: at b 1 the reshape above is a strided view, and
        # empty_like would keep its strides
        out = torch.empty(pages.shape, dtype=pages.dtype, device=pages.device)
        out[table.reshape(-1).long()] = pages
        pool.append(out)
    return pool, table


def decode_agreement(res, res_p):
    """(agrees, the readings, o's max-abs) of two decodes' (o, m, l): o
    cosine >= 0.9999 and max-abs <= 2e-2 (the forward's limits); m, a max
    of scores both compute by the same fp32 chain, within 1e-5; l within
    1e-4 relative (the two sum p in other orders)."""
    import torch
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    o, m, l = res
    o_p, m_p, l_p = res_p
    torch.cuda.synchronize()
    cos = cosine_similarity(o.float().cpu(), o_p.float().cpu())
    err = (o.float() - o_p.float()).abs().max().item()
    merr = (m - m_p).abs().max().item()
    lrel = ((l - l_p).abs() / l_p.abs().clamp_min(1e-30)).max().item()
    finite = bool(torch.isfinite(o).all())
    ok = finite and cos >= 0.9999 and err <= 2e-2 and merr <= 1e-5 and lrel <= 1e-4
    return ok, (f"o cos {cos:.7f}, max abs {err:.3e}; m max abs {merr:.3e}; l max rel "
                f"{lrel:.3e}; finite {finite}"), err


def compare_decode(name, res, res_p, results, key):
    """A decode kernel's (o, m, l) against its plain version's, within
    ``decode_agreement``'s limits."""
    ok, what, err = decode_agreement(res, res_p)
    log(f"decode {name}: {what}")
    require(ok, f"decode {name}: the kernel disagrees with its plain version")
    r = results[key]
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)


def decode_case(gen, q, cache, L, page, window, **kw):
    """Kernels 9-12 on one batch: (the results key of the kernel that runs,
    its wrapper's call, the plain version's call), over the dense ``cache``
    or, with ``page``, its tokens in a scrambled page pool; ``kw`` goes to
    both calls."""
    from sageattention_tpu_torch.ops import decode_cuda as dc

    if page is None:
        key = "sage_decode" if window is None else "sage_decode_window"
        return (key, lambda: dc.sage_decode_attention(q, *cache, L, window=window, **kw),
                lambda: dc.sage_decode_attention_plain(q, *cache, L, window=window, **kw))
    key = "sage_paged_decode" if window is None else "sage_paged_decode_window"
    pool, table = paged_from_dense(gen, cache, page)
    return (key, lambda: dc.sage_paged_decode_attention(q, *pool, table, L, window=window, **kw),
            lambda: dc.sage_paged_decode_attention_plain(q, *pool, table, L, window=window,
                                                         **kw))


def check_decode(gen, results):
    """Kernels 9-12 against their plain versions at the LLM servers' shapes
    (GQA 32/8, d 128): int8 and packed int4; t_q 1, 4 and 512; ragged
    lengths 0, 1, one off the chunk grid and S; return_state; window 4096;
    pages of 16 and 1024 through scrambled tables; head dims off that path
    (64, 96, and 40 and 72, which are not multiples of 16); and the paged
    kernel with page = chunk against the dense kernel on the same tokens."""
    import torch
    from sageattention_tpu_torch.ops import decode_cuda as dc

    hq, hkv, d = 32, 8, 128

    def q_of(b, t_q):
        return torch.randn(b, hq, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)

    def lens(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    dense = [
        # name, b, t_q, S, lengths, window, packed
        ("int8 t_q 1", 4, 1, 8192, [0, 1, 4123, 8192], None, False),
        ("int4 t_q 1", 4, 1, 8192, [0, 1, 4123, 8192], None, True),
        ("int8 t_q 4", 4, 4, 8192, [4, 4103, 8192, 300], None, False),
        ("int4 t_q 4", 4, 4, 8192, [4, 4103, 8192, 300], None, True),
        ("int8 t_q 512 extend", 2, 512, 9216, [512, 3000], None, False),
        ("int8 window 4096 t_q 1", 2, 1, 9216, [8200, 1], 4096, False),
        ("int4 window 4096 t_q 1", 2, 1, 9216, [8200, 5000], 4096, True),
        ("int8 window 4096 t_q 512 extend", 2, 512, 9216, [4608, 8192], 4096, False),
    ]
    for name, b, t_q, S, ln, window, packed in dense:
        cache = random_cache(gen, (b, hkv), S, d, packed)
        q, L = q_of(b, t_q), lens(ln)
        key = "sage_decode" if window is None else "sage_decode_window"
        res = dc.sage_decode_attention(q, *cache, L, window=window, return_state=True)
        res_p = dc.sage_decode_attention_plain(q, *cache, L, window=window, return_state=True)
        compare_decode(f"dense {name} {tuple(ln)}", res, res_p, results, key)

    paged = [
        # name, b, t_q, page, S, lengths, window, packed
        ("page 16 int8 t_q 1", 4, 1, 16, 8192, [0, 1, 4123, 8192], None, False),
        ("page 16 int4 t_q 4", 4, 4, 16, 8192, [4, 17, 4123, 8192], None, True),
        ("page 1024 int8 t_q 1", 4, 1, 1024, 8192, [0, 1, 4123, 8192], None, False),
        ("page 1024 int4 t_q 1", 4, 1, 1024, 8192, [0, 1, 4123, 8192], None, True),
        ("page 1024 int8 window 4096 t_q 1", 2, 1, 1024, 9216, [8200, 3], 4096, False),
        ("page 1024 int8 window 4096 t_q 512 extend", 2, 512, 1024, 9216, [4608, 8192], 4096,
         False),
        ("page 16 int8 window 4096 t_q 1", 2, 1, 16, 9216, [8200, 4100], 4096, False),
    ]
    for name, b, t_q, page, S, ln, window, packed in paged:
        pool, table = paged_from_dense(gen, random_cache(gen, (b, hkv), S, d, packed), page)
        q, L = q_of(b, t_q), lens(ln)
        key = "sage_paged_decode" if window is None else "sage_paged_decode_window"
        res = dc.sage_paged_decode_attention(q, *pool, table, L, window=window,
                                             return_state=True)
        res_p = dc.sage_paged_decode_attention_plain(q, *pool, table, L, window=window,
                                                     return_state=True)
        compare_decode(f"paged {name} {tuple(ln)}", res, res_p, results, key)

    # shapes off the LLM path that the kernels take: d 64 and 96, GQA 1 and
    # 4, t_q 5 (20 rows, a padded 64-row tile), a 640-token chunk (a partial
    # 256-token slab), 48-token pages
    odd = [
        # name, hq, hkv, d, b, t_q, S, page, lengths, window, packed
        ("d64 gqa4 t_q 5 window 300 int4", 8, 2, 64, 2, 5, 1024, None, [1000, 37], 300, True),
        ("d64 mha t_q 1 chunk 640", 4, 4, 64, 2, 1, 640, None, [640, 333], None, False),
        ("d128 gqa4 t_q 5 page 48", 8, 2, 128, 2, 5, 960, 48, [900, 5], None, False),
        ("d64 gqa4 t_q 1 page 48 window 100 int4", 8, 2, 64, 2, 1, 960, 48, [901, 60], 100,
         True),
        # head dim 96: computed at 128, the cache read at its own head dim
        ("d96 gqa4 t_q 1", 8, 2, 96, 2, 1, 1024, None, [1000, 37], None, False),
        ("d96 gqa4 t_q 4 int4", 8, 2, 96, 2, 4, 1024, None, [1000, 300], None, True),
        ("d96 gqa4 t_q 1 page 48 window 100", 8, 2, 96, 2, 1, 960, 48, [901, 60], 100, False),
    ]
    for name, hq_, hkv_, d_, b, t_q, S, page, ln, window, packed in odd:
        cache = random_cache(gen, (b, hkv_), S, d_, packed)
        q = torch.randn(b, hq_, t_q, d_, generator=gen, device="cuda").to(torch.bfloat16)
        key, fn, plain = decode_case(gen, q, cache, lens(ln), page, window, return_state=True)
        compare_decode(f"{name} {tuple(ln)}", fn(), plain(), results, key)

    # head dims 40 and 72, not multiples of 16: the cache rows are off
    # 16-byte alignment and the RAGGED instances read them byte by byte;
    # from a generator of their own, so that the later phases' inputs stay
    ragged_gen = torch.Generator(device="cuda")
    ragged_gen.manual_seed(38)
    for d_ in (40, 72):
        for packed in (False, True):
            for name, hq_, hkv_, b, t_q, S, page, ln, window in (
                    ("gqa4 t_q 1", 32, 8, 4, 1, 8192, None, [0, 1, 4123, 8192], None),
                    ("gqa4 t_q 4 window 4096", 32, 8, 2, 4, 9216, None, [8200, 300], 4096),
                    ("page 16 t_q 1", 32, 8, 4, 1, 8192, 16, [0, 17, 4123, 8192], None),
                    ("page 1024 window 4096", 32, 8, 2, 1, 9216, 1024, [8200, 5000], 4096)):
                cache = random_cache(ragged_gen, (b, hkv_), S, d_, packed)
                q = torch.randn(b, hq_, t_q, d_, generator=ragged_gen,
                                device="cuda").to(torch.bfloat16)
                key, fn, plain = decode_case(ragged_gen, q, cache, lens(ln), page, window,
                                             return_state=True)
                compare_decode(f"d{d_} {'int4' if packed else 'int8'} {name} {tuple(ln)}", fn(),
                               plain(), results, key)

    # one page a chunk: the paged kernel walks the dense kernel's chunks
    for packed in (False, True):
        cache = random_cache(gen, (4, hkv), 8192, d, packed)
        pool, table = paged_from_dense(gen, cache, 4096)
        q, L = q_of(4, 1), lens([0, 1, 4123, 8192])
        o_d = dc.sage_decode_attention(q, *cache, L, chunk=4096)
        o_p = dc.sage_paged_decode_attention(q, *pool, table, L)
        torch.cuda.synchronize()
        same = torch.equal(o_d, o_p)
        log(f"decode paged (page 4096) vs dense (chunk 4096) {'int4' if packed else 'int8'} on "
            f"the same tokens: bit-identical {same}")
        require(same, "the paged kernel with page = chunk disagrees with the dense kernel")
    check_decode_split(results)


def decode_plan(q, cache, page, window=None, chunk=4096):
    """(cl, splits) the wrapper of kernel 9 (``page`` None) or 11, or with a
    ``window`` 10 or 12, plans for ``q`` over the dense ``cache`` in chunks
    from ``chunk`` or a pool of its tokens in pages of ``page``."""
    from sageattention_tpu_torch.ops import decode_cuda as dc

    b, hq, t_q, d = q.shape
    hkv, S = cache[0].shape[1], cache[1].shape[2]
    rows = hq // hkv * t_q
    if page is None:
        C, n_kv, n_live = dc.dense_plan(S, rows, t_q, chunk, window)
        if window is None:
            return dc.dense_split_plan(q.shape, hkv, S, C)
        return dc.window_split_plan(q.shape, hkv, C, n_live)
    if window is None:
        return dc.paged_split_plan(q.shape, hkv, page, S // page)
    n_live = dc.paged_plan(page, S // page, rows, hq // hkv, t_q, window)
    return dc.window_split_plan(q.shape, hkv, page, n_live)


# the kernels (and copies and sets) one call of each timed decode wrapper
# path puts on the card, counted in phase 2 (check_decode_split): in a whole
# run on the H100 the profiler runs of the later phases recorded no
# device events
DECODE_OPS: dict = {}


def device_ops(fn) -> int:
    """The kernels (and copies and sets) one call of ``fn`` puts on the card,
    counted by ``torch.profiler`` after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)


def check_decode_split(results):
    """The split walk of kernels 9-12 where it splits most: few (batch, kv
    head) pairs, so the plan takes many splits and wide clusters, at the
    lengths -5, 0, 1, C - 1, C, C + 1 and S around a chunk (or page) of C,
    and with a window at -5, 0, 1, about the window's first key, a chunk
    edge, S and past S; int8 and int4, t_q 1 and 4 and (with the window)
    extend blocks of 64-512 tokens; dense in chunks of 1024, 4096 and
    8192, pages of 1024, 8192 and (at d 512) of 16; d 40 (ragged) and 256;
    a sharded pool's ``owned`` shard whose first splits hold no owned page,
    and one with a window.  Each against its plain version (compare_decode's
    limits), and two calls bit-identical in (o, m, l).  From a generator of
    its own, so that the later phases' inputs stay."""
    import torch
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import decode_cuda as dc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    cases = [
        # name, hq, hkv, d, S, C (chunk or page), paged, t_q, packed, window
        ("dense chunk 1024", 8, 2, 128, 8192, 1024, False, 1, False, None),
        ("dense chunk 1024 int4 t_q 4", 8, 2, 128, 8192, 1024, False, 4, True, None),
        ("dense chunk 4096", 4, 1, 128, 16384, 4096, False, 1, False, None),
        ("dense chunk 4096 int4 t_q 4", 4, 1, 128, 16384, 4096, False, 4, True, None),
        ("page 1024", 8, 2, 128, 8192, 1024, True, 1, False, None),
        ("page 1024 int4 t_q 4", 8, 2, 128, 8192, 1024, True, 4, True, None),
        ("d256 dense chunk 4096", 4, 1, 256, 8192, 4096, False, 1, False, None),
        ("d512 page 16", 4, 2, 512, 4096, 16, True, 1, False, None),
        ("d512 page 16 int4 t_q 4", 4, 2, 512, 4096, 16, True, 4, True, None),
        ("d40 dense chunk 1024 ragged", 8, 2, 40, 8192, 1024, False, 1, False, None),
        # a chunk (page) above 8 x 512 tokens: a CTA's share is walked in
        # groups of 512 tokens, K read again for the second and third steps
        ("dense chunk 8192 (groups)", 4, 1, 128, 16384, 8192, False, 1, False, None),
        ("page 8192 int4 (groups)", 4, 1, 128, 16384, 8192, True, 1, True, None),
        # the window (kernels 10 and 12): its n_live chunks split, each row
        # tile's slabs from its own keys
        ("window 4096 dense chunk 1024", 8, 2, 128, 16384, 1024, False, 1, False, 4096),
        ("window 4096 dense chunk 1024 int4 t_q 4", 8, 2, 128, 16384, 1024, False, 4, True,
         4096),
        ("window 4096 dense t_q 512 extend", 8, 2, 128, 9216, 4096, False, 512, False, 4096),
        ("window 4096 page 1024", 8, 2, 128, 16384, 1024, True, 1, False, 4096),
        ("window 4096 page 1024 int4 t_q 4", 8, 2, 128, 16384, 1024, True, 4, True, 4096),
        ("window 4096 page 1024 t_q 512 extend", 8, 2, 128, 9216, 1024, True, 512, False, 4096),
        ("window 4096 page 1024 int4 t_q 512 extend", 8, 2, 128, 9216, 1024, True, 512, True,
         4096),
        ("window 1000 d40 dense chunk 1024 ragged", 8, 2, 40, 8192, 1024, False, 1, False, 1000),
        ("window 1000 d40 page 1024 ragged t_q 64 extend", 8, 2, 40, 8192, 1024, True, 64,
         True, 1000),
        ("window 1000 d256 page 1024 t_q 128 extend", 4, 2, 256, 8192, 1024, True, 128, False,
         1000),
        ("window 1000 d512 page 16", 4, 2, 512, 4096, 16, True, 1, False, 1000),
        ("window 1000 d512 page 16 int4 t_q 4", 4, 2, 512, 4096, 16, True, 4, True, 1000),
    ]
    out = {}
    for name, hq, hkv, d, S, C, paged, t_q, packed, window in cases:
        if window is None:
            ln = [-5, 0, 1, C - 1, C, C + 1, S]
        else:
            ln = [-5, 0, 1, window - 1, window + t_q, 3 * C + 1, S, S + 3]
        b = len(ln)
        cache = random_cache(gen, (b, hkv), S, d, packed)
        q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)
        L = torch.tensor(ln, dtype=torch.int32, device="cuda")
        kw = dict(return_state=True, window=window)
        if paged:
            pool, table = paged_from_dense(gen, cache, C)
            key = "sage_paged_decode" if window is None else "sage_paged_decode_window"
            plan = decode_plan(q, cache, C, window)
            fn = lambda: dc.sage_paged_decode_attention(q, *pool, table, L, **kw)  # noqa: E731
            plain = lambda: dc.sage_paged_decode_attention_plain(q, *pool, table, L, **kw)  # noqa: E731,E501
        else:
            key = "sage_decode" if window is None else "sage_decode_window"
            plan = decode_plan(q, cache, None, window, C)
            fn = lambda: dc.sage_decode_attention(q, *cache, L, chunk=C, **kw)  # noqa: E731
            plain = lambda: dc.sage_decode_attention_plain(q, *cache, L, chunk=C, **kw)  # noqa: E731,E501
        dp = _build.pad_head_dim(d)
        if dp > 128:
            key += f"_hd{dp}"
        res = fn()
        compare_decode(f"split {name} (cl, splits) {plan} {tuple(ln)}", res, plain(),
                       results, key)
        again = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(res, again))
        log(f"decode split {name}: two calls bit-identical {same}")
        require(same, f"decode split {name}: two calls differ")
        out[name] = {"plan": list(plan), "deterministic": same}
    # a shard of a pool whose first splits own no page: their partials are
    # empty and read nothing
    cache = random_cache(gen, (2, 8), 16384, 128, False)
    pool, table = paged_from_dense(gen, cache, 1024)
    q = torch.randn(2, 32, 1, 128, generator=gen, device="cuda").to(torch.bfloat16)
    plan = decode_plan(q, cache, 1024)
    ranges = dc.split_ranges(table.shape[1], plan[1])
    own = (torch.rand(table.shape, generator=gen, device="cuda") < 0.5).int()
    own[:, :ranges[len(ranges) // 2][0]] = 0
    L = torch.tensor([16000, 9000], dtype=torch.int32, device="cuda")
    kw = dict(owned=own, return_state=True)
    res = dc.sage_paged_decode_attention(q, *pool, table, L, **kw)
    compare_decode(f"split owned, splits {ranges[:len(ranges) // 2]} of {plan} own no page", res,
                   dc.sage_paged_decode_attention_plain(q, *pool, table, L, **kw), results,
                   "sage_paged_decode_owned")
    again = dc.sage_paged_decode_attention(q, *pool, table, L, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(res, again))
    require(same, "decode split owned: two calls differ")
    out["owned, empty first splits"] = {"plan": list(plan), "deterministic": same}
    # the same shard with a window 4096 (kernel 12 with owned): half its
    # pages owned, so that some splits of the window's pages own none
    kw_w = dict(owned=own, return_state=True, window=4096)
    plan_w = decode_plan(q, cache, 1024, 4096)
    res = dc.sage_paged_decode_attention(q, *pool, table, L, **kw_w)
    compare_decode(f"split owned window 4096, (cl, splits) {plan_w}", res,
                   dc.sage_paged_decode_attention_plain(q, *pool, table, L, **kw_w), results,
                   "sage_paged_decode_window_owned")
    again = dc.sage_paged_decode_attention(q, *pool, table, L, **kw_w)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(res, again))
    require(same, "decode split owned window: two calls differ")
    out["owned, window 4096"] = {"plan": list(plan_w), "deterministic": same}
    log(f"decode split: {len(out)} cases, every one deterministic")
    # the timed wrapper paths' launches a call, with their dtypes and options
    # (bf16 q; the sharded phases' return_state, and fp32 out with owned)
    own_kw = dict(owned=own, return_state=True, out_dtype=torch.float32)
    paths = {
        "sage_decode": lambda: dc.sage_decode_attention(q, *cache, L),
        "sage_decode_state": lambda: dc.sage_decode_attention(q, *cache, L, return_state=True),
        "sage_paged_decode": lambda: dc.sage_paged_decode_attention(q, *pool, table, L),
        "sage_paged_decode_owned": lambda: dc.sage_paged_decode_attention(q, *pool, table, L,
                                                                           **own_kw),
        "sage_decode_window": lambda: dc.sage_decode_attention(q, *cache, L, window=4096),
        "sage_paged_decode_window": lambda: dc.sage_paged_decode_attention(q, *pool, table, L,
                                                                            window=4096)}
    DECODE_OPS.update({name: device_ops(fn) for name, fn in paths.items()})
    log(f"decode: CUDA launches a call by wrapper path {DECODE_OPS}")
    out["launches_a_call"] = dict(DECODE_OPS)
    return out


def decode_bound(lengths, hq, hkv, t_q, d, packed, window):
    """(bound_ms, bound_by) of one decode call: the live K/V codes and
    scales each kv head's rows can see, read once, with Q in and O out
    (bf16); against the int8 operations of the rows' visible keys."""
    code = d // 2 if packed else d
    tokens = 0
    ops = 0
    for length in lengths:
        span = length if window is None else min(length, window + t_q - 1)
        tokens += max(span, 0)
        for t in range(t_q):
            pos = length - t_q + t
            lo = 0 if window is None else max(pos - window + 1, 0)
            ops += max(pos + 1 - lo, 0) * hq
    moved = tokens * hkv * (2 * code + 8) + 2 * len(lengths) * hq * t_q * d * 2
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = 4 * ops * d / PEAK_INT8_OPS_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_decode(gen, results):
    """Kernels 9-12 at the LLM servers' decode-step shapes (the cache of one
    layer, cold in L2) beside their bounds and plain versions, and kernels
    10 and 12 at the windowed server's 512-token extend blocks.  No PyTorch
    call computes decode over an int8 cache: library_ms is null."""
    import torch

    hq, hkv, d = 32, 8, 128

    def q_of(b, t_q):
        return torch.randn(b, hq, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)

    # (kernel, b, t_q, S, page, length, window): the servers' mid-decode step
    # (prompt + 16 tokens) and extend block
    cells = [
        ("sage_decode", 4, 1, 8192, None, 4096 + 16, None),
        ("sage_decode_window", 2, 1, 9216, None, 8192 + 16, 4096),
        ("sage_paged_decode", 4, 1, 8192, 1024, 4096 + 16, None),
        ("sage_paged_decode_window", 2, 1, 9216, 1024, 8192 + 16, 4096),
        ("sage_decode_window", 2, 512, 9216, None, 8192, 4096),
        ("sage_paged_decode_window", 2, 512, 9216, 1024, 8192, 4096),
    ]
    for name, b, t_q, S, page, length, window in cells:
        for packed in ((False, True) if t_q == 1 and window is None else (False,)):
            cache = random_cache(gen, (b, hkv), S, d, packed)
            q = q_of(b, t_q)
            L = torch.full((b,), length, dtype=torch.int32, device="cuda")
            _, fn, plain = decode_case(gen, q, cache, L, page, window)
            ms = cuda_ms(fn, reps=20, cold=True)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            bound, by = decode_bound([length] * b, hq, hkv, t_q, d, packed, window)
            ops = DECODE_OPS.get(name)
            # the split walk's plan: (cl, splits)
            plan = list(decode_plan(q, cache, page, window))
            what = f"t_q {t_q} {'int4' if packed else 'int8'}"
            log(f"time {name} {what} at b {b}, length {length}, S {S}"
                f"{'' if page is None else f', page {page}'}: {ms:.4f} ms (bound {bound:.4f} ms, "
                f"{by}), plain {plain_ms:.4f} ms; (cl, splits) {plan}; {ops} CUDA launches a call "
                f"(counted in phase 2)")
            r = results[name]
            if t_q == 1 and not packed:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
                         shape={"b": b, "hq": hq, "hkv": hkv, "t_q": 1, "d": d, "S": S,
                                "length": length, "page": page, "window": window},
                         plan=plan, device_ops_a_call=ops)
            else:
                r.setdefault("other_shapes", []).append(
                    {"t_q": t_q, "bits": 4 if packed else 8, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "plan": plan, "device_ops_a_call": ops})


# --------------------------------------------------------------------------
# phase 3: the CogVideoX-2B denoise server
# --------------------------------------------------------------------------

FORWARD = ("k_channel_mean", "quant_k_chunked", "sage_attn_fwd")
# the Q/K options' servers, a kernel named as often as a layer launches it:
# int4 + smooth_q runs kernel 2 on Q (smooth_q's mean) and on K, kernel 4 on
# the centred Q, kernel 3 at 4 bits and the pre-quantized forward;
# per_subtile runs kernel 4 on Q and on K (kernel 2's mean off), and with
# fp8 V kernel 5
FORWARD_INT4_SQ = ("k_channel_mean", "k_channel_mean", "quant_q_per_token", "quant_k_chunked",
                   "sage_attn_fwd_preq")
FORWARD_SUBTILE_FP8 = ("quant_q_per_token", "quant_q_per_token", "k_channel_mean",
                       "quant_v_per_channel", "widen_v_codes", "sage_attn_fwd_preq")
# V codes before the wgmma forward (no masks): widened to bf16
WIDEN = ("widen_v_codes",)
# the windowed one-shot prefill: kernels 2-3 and kernel 1's masked instantiation
FORWARD_MASKED = ("k_channel_mean", "quant_k_chunked", "sage_attn_fwd_masked")
BACKWARD = ("quant_q_per_token", "sage_attn_bwd_dq", "sage_attn_bwd_dkv")
# the bias trainer's step: the masked forward with the bias and the backward
# kernels' bias instances
BIAS_TRAIN = ("k_channel_mean", "quant_k_chunked", "sage_attn_fwd_masked", "quant_q_per_token",
              "sage_attn_bwd_dq_bias", "sage_attn_bwd_dkv_bias")
V_QUANT = ("quant_v_per_channel", "v_channel_stats", "quant_v_apply")
# the main path whose launches the kernels line reports for each kernel
MAIN_PATH = {**{n: "server" for n in FORWARD}, **{n: "train" for n in BACKWARD},
             "quant_v_per_channel": "server_fp8", "widen_v_codes": "server_fp8",
             "v_channel_stats": "server_wan",
             "quant_v_apply": "server_wan", "sage_decode": "llm_dense",
             "sage_decode_window": "llm_window_dense", "sage_paged_decode": "llm_paged",
             "sage_paged_decode_window": "llm_window_paged",
             "sage_attn_fwd_masked": "llm_window_dense", "sage_attn_fwd_preq": "server_int4_sq",
             "sage_attn_bwd_dq_bias": "bias_train", "sage_attn_bwd_dkv_bias": "bias_train",
             # the head-dim-256 instances on a path of this run; the others
             # (the masked forward, kernels 5-6, 10 and 12 at 256) are checked
             # and timed, and reported inside their kernel's entry
             **{n + "_hd256": "llm_gemma7b_dense" for n in FORWARD + ("sage_decode",)},
             "sage_paged_decode_hd256": "llm_gemma7b_paged",
             **{n + "_hd256": "hd256_train" for n in BACKWARD},
             # the bias instances at 256: the d256 bias trainer
             "sage_attn_bwd_dq_bias_hd256": "bias_hd256_train",
             "sage_attn_bwd_dkv_bias_hd256": "bias_hd256_train",
             # kernel 11's launches with the owned page mask (kernel 12's has no
             # path: it is checked and timed, and both sit in their kernel's entry)
             "sage_paged_decode_owned": "sharded_paged",
             # kernel 13, the rate probe: its own run
             "probe_mma": "probe",
             # the wide instances on phase 10's paths; the others (the masked
             # and pre-quantized forwards, kernels 4-6 and 9-12 at 384) are
             # checked and timed, and reported inside their kernel's entry
             **{f"{n}_hd{d}": f"wide_prefill_hd{d}" for d in (384, 512)
                for n in FORWARD + ("quant_v_per_channel",) + WIDEN},
             "sage_attn_fwd_masked_hd512": "wide_masked_hd512",
             "v_channel_stats_hd512": "wide_masked_hd512",
             "quant_v_apply_hd512": "wide_masked_hd512",
             "sage_attn_fwd_preq_hd512": "wide_preq_hd512",
             "quant_q_per_token_hd512": "wide_preq_hd512",
             "sage_decode_hd512": "wide_serve_dense",
             "sage_decode_window_hd512": "wide_serve_dense_window",
             "sage_paged_decode_hd512": "wide_serve_paged",
             "sage_paged_decode_window_hd512": "wide_serve_paged_window"}
FORWARD_HD256 = tuple(n + "_hd256" for n in FORWARD)
BACKWARD_HD256 = tuple(n + "_hd256" for n in BACKWARD)
BIAS_TRAIN_HD256 = tuple(n + "_hd256" for n in BIAS_TRAIN)


def counters():
    """Each kernel's (wrapper, counter attribute): the backward wrappers
    count their bias instances apart, every wrapper its launches at head
    dim 256."""
    from sageattention_tpu_torch.ops import (attention_bwd_cuda, attention_cuda, decode_cuda,
                                             quant_cuda)
    from sageattention_tpu_torch.utils import probe_mma

    fns = {"k_channel_mean": quant_cuda.k_channel_mean,
           "quant_k_chunked": quant_cuda.quant_k_chunked,
           "sage_attn_fwd": attention_cuda.sage_attention_fwd,
           "sage_attn_fwd_masked": attention_cuda.sage_attention_fwd_masked,
           "sage_attn_fwd_preq": attention_cuda.sage_attention_fwd_preq,
           "quant_q_per_token": quant_cuda.quant_q_per_token,
           "sage_attn_bwd_dq": attention_bwd_cuda.sage_attention_bwd_dq,
           "sage_attn_bwd_dkv": attention_bwd_cuda.sage_attention_bwd_dkv,
           "quant_v_per_channel": quant_cuda.quant_v_per_channel,
           "widen_v_codes": attention_cuda.widen_v_codes,
           "v_channel_stats": quant_cuda.v_channel_stats,
           "quant_v_apply": quant_cuda.quant_v_apply,
           "sage_decode": decode_cuda.decode_kernel,
           "sage_decode_window": decode_cuda.decode_window_kernel,
           "sage_paged_decode": decode_cuda.paged_kernel,
           "sage_paged_decode_window": decode_cuda.paged_window_kernel}
    fns["probe_mma"] = probe_mma.chain
    out = {name: (fn, "launches") for name, fn in fns.items()}
    out["sage_attn_bwd_dq_bias"] = (attention_bwd_cuda.sage_attention_bwd_dq, "bias_launches")
    out["sage_attn_bwd_dkv_bias"] = (attention_bwd_cuda.sage_attention_bwd_dkv, "bias_launches")
    for name in HD256:  # the launches at head dim 256, counted apart
        if name.endswith("_bias"):
            out[name + "_hd256"] = (out[name][0], "bias_hd256_launches")
        else:
            out[name + "_hd256"] = (fns[name], "hd256_launches")
    for name in OWNED:  # the launches over a shard of a sharded pool, counted apart
        out[name + "_owned"] = (fns[name], "owned_launches")
    for name in WIDE:  # the launches at head dims 384 and 512, counted apart
        for d in WIDE_DIMS:
            out[f"{name}_hd{d}"] = (fns[name], f"hd{d}_launches")
    return out


def zero_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def profile_device(fn, out_name: str, what: str) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``),
    and the device's idle share of its wall time, into chiprun_out/."""
    import pathlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets), by name; user
    # annotations (such as the optimizer's step) span kernels counted already
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    busy, end = 0.0, None  # the union of the device spans
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += (b - a) / 1e3
            end = b
        elif b > end:
            busy += (b - end) / 1e3
            end = b
    groups = {"sage_attn_fwd": 0.0, "sage_attn_bwd": 0.0, "sage_decode": 0.0, "quant": 0.0,
              "gemm": 0.0, "other": 0.0}
    quant_kernels = {}  # the quant group by kernel: (ms, launches)
    for name, ms, n in rows:
        low = name.lower()
        if "sage_attn_fwd" in low:
            groups["sage_attn_fwd"] += ms
        elif "sage_attn_bwd" in low:
            groups["sage_attn_bwd"] += ms
        elif "decode_kernel" in low:  # kernels 9-12
            groups["sage_decode"] += ms
        elif "quant" in low or "channel_mean" in low:  # K, Q and V quantizers
            groups["quant"] += ms
            quant_kernels[name[:120]] = {"ms": ms, "count": n}
        elif any(w in low for w in ("gemm", "cutlass", "nvjet", "sm90_xmma")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1 - busy / wall_ms), "groups_ms": groups,
           "quant_kernels": quant_kernels,
           "top": [{"kernel": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:20]]}
    path = pathlib.Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / out_name).write_text(json.dumps(out, indent=1))
    log(f"profile of {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {out['idle_share']:.4f}, by group {json.dumps(groups)}")
    for r in out["top"][:10]:
        log(f"  {r['ms']:9.3f} ms x{r['count']:4d}  {r['kernel']}")
    for name, r in quant_kernels.items():
        log(f"  quant {r['ms']:9.3f} ms x{r['count']:4d}  {name}")
    return out


def set_processors(model, backend: str, kwargs: dict | None) -> None:
    """Each block's attention through ``SageAttnProcessor(backend, kwargs)``,
    or, with ``kwargs`` None, through the global backend."""
    from sageattention_tpu_torch import models

    proc = None if kwargs is None else models.SageAttnProcessor(backend=backend, kwargs=kwargs)
    for blk in model.blocks:
        blk.attn.processor = proc


def run_server(results, profile: bool, *, model: str, backend: str, path: str,
               launched: tuple, bf16_steps: int = 0, kwargs: dict | None = None,
               eps_floor: float = 0.999) -> dict:
    """One server cell: ``model`` at full width and depth 30 with
    ``backend`` (and with ``kwargs``, the options a ``SageAttnProcessor``
    passes it), 2 requests x 2 denoise steps.  Each kernel in ``launched``
    must run as often a layer a step as ``launched`` names it, every other
    kernel not at all.
    ``bf16_steps`` more steps are then timed with "sage" (bf16 V) on the
    same model.  One step's eps is held against exact attention at depth
    2, cosine >= ``eps_floor``."""
    import torch
    from sageattention_tpu_torch import models, serve
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    depth = SERVER_DEPTH
    cfg = models.MODEL_CONFIGS[model].scaled(depth=depth)
    log(f"server {path}: {cfg.name} seq {cfg.seq_len} hidden {cfg.hidden} heads "
        f"{cfg.heads}x{cfg.head_dim} depth {cfg.depth} bf16, backend {backend!r}"
        f"{f', processor kwargs {kwargs}' if kwargs else ''}")
    t0 = time.perf_counter()
    model_ = serve.load_model(cfg, device="cuda", seed=0)
    set_processors(model_, backend, kwargs)
    requests = serve.make_requests(cfg, 2, device="cuda", seed=1)
    models.set_attention_backend(backend)
    # warm-up step (allocator, cuBLAS), not counted
    serve.denoise_step(model_, *requests[0], torch.tensor([999], device="cuda"))
    torch.cuda.synchronize()
    log(f"server {path} set-up + warm-up step: {time.perf_counter() - t0:.1f} s")

    steps = 2
    zero_counts()
    out = serve.serve(model_, requests, steps)
    launches = read_counts()
    n_steps = len(requests) * steps
    for lat in out["outputs"]:
        require(lat.shape == requests[0][0].shape and bool(torch.isfinite(lat).all()),
                f"server {path}: output is not finite or has the wrong shape")
    ms = out["step_ms"]
    log(f"server {path}: {len(requests)} requests x {steps} steps, ms per step "
        f"{[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}")
    log(f"server {path} launches: {launches} (layers x steps = {depth * n_steps})")
    for name, n in launches.items():
        want = depth * n_steps * launched.count(name)
        require(n == want, f"server {path}: {name} launched {n} times, want {want}")
        results[name].setdefault("launches_by_path", {})[path] = n
    t = torch.tensor([500], device="cuda")
    prof = {}
    if profile:
        prof[backend] = profile_device(lambda: serve.denoise_step(model_, *requests[0], t),
                                       f"profile_step_{path}.json", f"one {path} step")
    cell = {"model": model, "backend": backend, "kwargs": kwargs, "depth": depth,
            "seq": cfg.seq_len, "step_ms": ms, "median_step_ms": statistics.median(ms)}
    if bf16_steps:
        models.set_attention_backend("sage")
        ms16 = serve.serve(model_, requests[:1], bf16_steps)["step_ms"]
        log(f"server {path} with 'sage' (bf16 V): ms per step {[round(x, 3) for x in ms16]}")
        cell.update(sage_step_ms=ms16, sage_median_step_ms=statistics.median(ms16))
        if profile:
            prof["sage"] = profile_device(
                lambda: serve.denoise_step(model_, *requests[0], t),
                f"profile_step_{path}_sage.json", f"one {path} step with 'sage'")
    del model_
    torch.cuda.empty_cache()

    # one step's eps: the backend against exact attention, depth 2, full width
    cfg2 = cfg.scaled(depth=2)
    model2 = serve.load_model(cfg2, device="cuda", seed=2)
    lat, txt = serve.make_requests(cfg2, 1, device="cuda", seed=3)[0]
    with torch.no_grad():
        models.set_attention_backend(backend)
        set_processors(model2, backend, kwargs)
        eps_s = model2(lat, txt, t)
        set_processors(model2, backend, None)
        models.set_attention_backend("reference")
        eps_r = model2(lat, txt, t)
        models.set_attention_backend("sage")
    cos = cosine_similarity(eps_s.float().cpu(), eps_r.float().cpu())
    log(f"server {path} eps, {backend!r} vs exact attention (depth 2, full width, seq "
        f"{cfg2.seq_len}): cos {cos:.6f}")
    require(cos >= eps_floor, f"server {path}: eps disagrees with exact attention")
    del model2
    torch.cuda.empty_cache()
    return {**cell, "eps_cosine_vs_exact": cos, "profile": prof or None}


# --------------------------------------------------------------------------
# phase 5: the llm-8b-gqa decode servers
# --------------------------------------------------------------------------

# which decode kernel each (cache, windowed) path runs
DECODE_KERNEL = {("dense", False): "sage_decode", ("dense", True): "sage_decode_window",
                 ("paged", False): "sage_paged_decode", ("paged", True): "sage_paged_decode_window"}


def llm_refeed_cosine(cfg, *, cache, bits, b, prompt, steps, max_len, page_table,
                      chunk) -> float:
    """The server's path at depth 2, full width: the logits of the prefill's
    last position and of ``steps`` teacher-forced decode steps through the
    quantized cache, against one prefill of the whole sequence through the
    "reference" backend (exact attention).  Returns their cosine."""
    import torch
    from sageattention_tpu_torch import generate, models
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    model = generate.load_llm(cfg.scaled(depth=2), device="cuda", seed=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    seq = torch.randint(0, cfg.vocab, (b, prompt + steps), generator=gen, device="cuda")
    caches = generate.make_caches(model, b, max_len, cache=cache, page_size=LLM_PAGE,
                                  page_table=page_table, bits=bits)
    logits, caches, lengths = generate.prefill(model, seq[:, :prompt], caches,
                                               chunked_prefill=chunk)
    outs = [logits[:, -1:].cpu()]
    for i in range(steps):
        logits, caches, lengths = generate.decode_step(model, seq[:, prompt + i:prompt + i + 1],
                                                       caches, lengths)
        outs.append(logits.cpu())
    del caches, logits
    models.set_attention_backend("reference")
    with torch.inference_mode():
        ref = model(seq)[:, prompt - 1:].cpu()
    models.set_attention_backend("sage")
    del model
    torch.cuda.empty_cache()
    return cosine_similarity(torch.cat(outs, dim=1), ref)


def run_llm_server(results, model, profile: bool, *, path: str, cache: str, bits: int, b: int,
                   prompt: int, steps: int, max_len: int, page_table=None, chunk: int = 0) -> dict:
    """One LLM server cell: a seeded prompt of ``prompt`` tokens for each of
    ``b`` sequences, prefilled (one shot, or ``chunk``-token extend blocks
    through the decode kernel), then ``steps`` greedy decode steps.  The
    launch counts are zeroed before each phase and read after it: a one-shot
    prefill runs kernels 1-3 once a layer (kernel 1's masked instantiation
    with a window), an extend block and a decode step the path's decode
    kernel once a layer, and no other kernel runs.
    Then the accuracy of the path at depth 2 (:func:`llm_refeed_cosine`)."""
    import torch
    from sageattention_tpu_torch import generate

    cfg = model.cfg
    depth = cfg.depth
    sfx = "_hd256" if cfg.head_dim > 128 else ""  # the head-dim-256 instances' counters
    kern = DECODE_KERNEL[(cache, cfg.window is not None)] + sfx
    log(f"llm server {path}: {cfg.name} hidden {cfg.hidden} heads {cfg.heads}/{cfg.kv_heads}x"
        f"{cfg.head_dim} depth {depth} vocab {cfg.vocab} window {cfg.window}; {cache} int{bits} "
        f"cache, b {b}, prompt {prompt}{f' in {chunk}-token extend blocks' if chunk else ''}, "
        f"{steps} decode steps, max_len {max_len}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (b, prompt), generator=gen, device="cuda")
    caches = generate.make_caches(model, b, max_len, cache=cache, page_size=LLM_PAGE,
                                  page_table=page_table, bits=bits)
    torch.cuda.synchronize()

    def check(phase, want):
        launches = read_counts()
        log(f"llm server {path} {phase} launches: "
            f"{ {n: c for n, c in launches.items() if c} }")
        for name, n in launches.items():
            require(n == want.get(name, 0),
                    f"llm server {path} {phase}: {name} launched {n} times, want "
                    f"{want.get(name, 0)}")
        return launches

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    logits, caches, lengths = generate.prefill(model, tokens, caches, chunked_prefill=chunk)
    cur = logits[:, -1:].argmax(dim=-1)
    e.record()
    e.synchronize()
    prefill_ms = a.elapsed_time(e)
    fwd = tuple(n + sfx for n in (FORWARD_MASKED if cfg.window is not None else FORWARD))
    pre = check("prefill", {kern: depth * (prompt // chunk)} if chunk
                else {n: depth for n in fwd})
    del logits

    zero_counts()
    step_ms, out = [], [cur]
    for _ in range(steps):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        logits, caches, lengths = generate.decode_step(model, cur, caches, lengths)
        cur = logits[:, -1:].argmax(dim=-1)
        e.record()
        e.synchronize()
        step_ms.append(a.elapsed_time(e))
        out.append(cur)
    dec = check("decode", {kern: depth * steps})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = torch.cat(out, dim=1)
    require(bool(torch.isfinite(logits).all()) and toks.shape == (b, steps + 1)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
            f"llm server {path}: logits not finite or tokens out of range")
    require(lengths.tolist() == [prompt + steps] * b, f"llm server {path}: lengths")
    results[kern].setdefault("launches_by_path", {})[path] = pre[kern] + dec[kern]
    if not chunk:
        for n in fwd:
            results[n].setdefault("launches_by_path", {})[path] = pre[n]
    med = statistics.median(step_ms)
    log(f"llm server {path}: prefill {prefill_ms:.3f} ms ({b * prompt / prefill_ms * 1e3:.1f} "
        f"tokens/s); decode ms per step {[round(x, 3) for x in step_ms]}, median {med:.3f} "
        f"({b / med * 1e3:.1f} tokens/s); peak memory {peak_gb:.2f} GB; first tokens "
        f"{toks[0, :8].tolist()}")
    prof = None
    if profile:
        prof = profile_device(lambda: generate.decode_step(model, cur, caches, lengths),
                              f"profile_llm_step_{path}.json", f"one {path} decode step")
    del caches, logits
    torch.cuda.empty_cache()
    cos = llm_refeed_cosine(cfg, cache=cache, bits=bits, b=b, prompt=prompt, steps=steps,
                            max_len=max_len, page_table=page_table, chunk=chunk)
    log(f"llm server {path} logits, cached path vs a one-shot exact-attention refeed "
        f"(depth 2, full width, {steps + 1} positions): cos {cos:.6f}")
    require(cos >= REFEED_FLOOR[bits], f"llm server {path}: logits disagree with the exact refeed")
    return {"model": cfg.name, "depth": depth, "vocab": cfg.vocab, "window": cfg.window,
            "cache": cache, "bits": bits, "b": b, "prompt": prompt, "steps": steps,
            "max_len": max_len, "chunked_prefill": chunk, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": b * prompt / prefill_ms * 1e3, "step_ms": step_ms,
            "median_step_ms": med, "decode_tokens_per_s": b / med * 1e3, "peak_gb": peak_gb,
            "launches": {"prefill": {n: c for n, c in pre.items() if c},
                         "decode": {n: c for n, c in dec.items() if c}},
            "refeed_cosine_depth2": cos, "profile": prof}


def run_llm(results, profile: bool) -> dict:
    """The four LLM servers at full width and depth 32 (fp32 weights, 32 GB):
    (a) dense int8, (b) paged int8 through a scrambled table of 1024-token
    pages, (c) dense packed int4 calibrated on the prompt, b 4, a 4096-token
    prompt and 32 decode steps; (d) the Mistral-7B geometry (vocab 32000,
    window 4096), b 2, an 8192-token prompt and 32 decode steps: over the
    dense cache after one windowed prefill (the JAX model's own), over the
    paged cache after 512-token extend blocks, which keep kernel 12's
    extend path on a server.  Speculative decoding (:func:`run_speculate`)
    runs on (a)-(c)'s model."""
    import torch
    from sageattention_tpu_torch import generate, models

    models.set_attention_backend("sage")
    cfg = models.MODEL_CONFIGS["llm-8b-gqa"].scaled(depth=LLM_DEPTH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    t0 = time.perf_counter()
    model = generate.load_llm(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    # warm-up (allocator, cuBLAS), not counted: a short prompt and two steps
    warm = torch.randint(0, cfg.vocab, (4, 1024), generator=gen, device="cuda")
    generate.generate(model, warm, 2, max_len=2048)
    torch.cuda.synchronize()
    log(f"llm set-up + warm-up: {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B "
        f"parameters")
    servers = {}
    common = dict(b=4, prompt=4096, steps=LLM_STEPS, max_len=8192)
    table = torch.randperm(4 * 8, generator=gen, device="cuda").reshape(4, 8).int()
    for path, cache, bits, pt in (("llm_dense", "dense", 8, None),
                                  ("llm_paged", "paged", 8, table),
                                  ("llm_int4", "dense", 4, None)):
        t_phase = time.perf_counter()
        servers[path] = run_llm_server(results, model, profile, path=path, cache=cache,
                                       bits=bits, page_table=pt, **common)
        log(f"llm server phase {path}: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    servers["llm_speculate"] = run_speculate(results, model)
    log(f"llm_speculate phase: {time.perf_counter() - t_phase:.1f} s")
    del model
    torch.cuda.empty_cache()

    cfg_w = cfg.scaled(vocab=32000, window=4096)
    model = generate.load_llm(cfg_w, device="cuda", seed=0)
    common = dict(b=2, prompt=8192, steps=LLM_STEPS, max_len=9216)
    table = torch.randperm(2 * 9, generator=gen, device="cuda").reshape(2, 9).int()
    for path, cache, pt, chunk in (("llm_window_dense", "dense", None, 0),
                                   ("llm_window_paged", "paged", table, 512)):
        t_phase = time.perf_counter()
        servers[path] = run_llm_server(results, model, profile, path=path, cache=cache, bits=8,
                                       page_table=pt, chunk=chunk, **common)
        log(f"llm server phase {path}: {time.perf_counter() - t_phase:.1f} s")
    log(f"windowed prefill of 2 x 8192 tokens: one shot (llm_window_dense) "
        f"{servers['llm_window_dense']['prefill_ms']:.3f} ms, in 512-token extend blocks "
        f"(llm_window_paged) {servers['llm_window_paged']['prefill_ms']:.3f} ms")
    del model
    torch.cuda.empty_cache()
    return servers


# --------------------------------------------------------------------------
# phase 4: the CogVideoX-2B trainer
# --------------------------------------------------------------------------


def grads_vs_exact(cfg, backend: str = "sage", kwargs: dict | None = None) -> dict:
    """Parameter gradients of one flow-matching loss with ``backend`` (and
    the options ``kwargs`` through a ``SageAttnProcessor``) against exact
    attention, same weights, batch and (t, eps); the V quantizers'
    launches in ``backend``'s forward and backward, and every kernel's in
    its backward."""
    import torch
    from sageattention_tpu_torch import models, serve, train
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    tr = train.load_trainer(cfg, device="cuda", seed=2)
    x0, txt = serve.make_requests(cfg, 1, device="cuda", seed=3)[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    t, eps = train.draw_t_eps(x0, gen)
    grads = {}
    for name in (backend, "reference"):
        models.set_attention_backend(name)
        set_processors(tr.model, name, kwargs if name == backend else None)
        tr.model.zero_grad(set_to_none=True)
        zero_counts()
        loss = train.flow_loss(tr.model, x0, txt, t, eps)
        fwd = read_counts()
        loss.backward()
        bwd = {n: c - fwd[n] for n, c in read_counts().items() if c != fwd[n]}
        if name == backend:
            v_launches = {"forward": sum(fwd[n] for n in V_QUANT),
                          "backward": sum(bwd.get(n, 0) for n in V_QUANT)}
            bwd_launches = bwd
        grads[name] = {n: p.grad.float().cpu() for n, p in tr.model.named_parameters()}
    models.set_attention_backend("sage")
    coss, worst = {}, 0.0
    for name, g in grads[backend].items():
        ref = grads["reference"][name]
        if name.endswith("k_norm.bias"):
            # exactly 0 in exact arithmetic (a bias on every key shifts each
            # row of logits by a constant): round-off on both sides, held to
            # be negligible beside the scale's gradient
            scale = grads["reference"][name.replace("bias", "weight")].norm().item()
            worst = max(worst, max(g.norm().item(), ref.norm().item()) / scale)
            continue
        coss[name] = cosine_similarity(g, ref)
    name_min = min(coss, key=coss.get)
    del tr
    torch.cuda.empty_cache()
    return {"backend": backend, "kwargs": kwargs, "seq": cfg.seq_len, "depth": cfg.depth,
            "params": len(grads[backend]), "min_cosine": coss[name_min],
            "min_cosine_param": name_min, "k_norm_bias_over_weight": worst,
            "v_quant_launches": v_launches, "backward_launches": bwd_launches}


def run_train(results, profile: bool) -> dict:
    import torch
    from sageattention_tpu_torch import models, serve, train

    depth, steps = TRAIN_DEPTH, TRAIN_STEPS
    cfg = models.MODEL_CONFIGS["cogvideox-2b"].scaled(depth=depth)
    log(f"trainer: {cfg.name} seq {cfg.seq_len} hidden {cfg.hidden} heads "
        f"{cfg.heads}x{cfg.head_dim} depth {depth}, fp32 parameters, bf16 compute, AdamW")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = train.load_trainer(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in tr.model.parameters())
    x0, txt = serve.make_requests(cfg, 1, device="cuda", seed=5)[0]
    models.set_attention_backend("sage")
    # warm-up step (allocator, cuBLAS), not counted; the same (t, eps) as
    # the timed steps (one generator seed, fixed_noise)
    warm = train.train(tr, x0, txt, 1, seed=6, fixed_noise=True)
    log(f"trainer set-up + warm-up step: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f} B parameters, warm-up loss {warm['losses'][0]:.6f}")
    zero_counts()
    out = train.train(tr, x0, txt, steps, seed=6, fixed_noise=True)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, ms = warm["losses"] + out["losses"], out["step_ms"]
    log(f"trainer: losses {[round(x, 6) for x in losses]}; ms per step "
        f"{[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}; peak memory "
        f"{peak_gb:.2f} GB")
    log(f"trainer launches: {launches} (layers x steps = {depth * steps})")
    for name, n in launches.items():
        want = depth * steps if name in FORWARD + BACKWARD else 0
        require(n == want, f"trainer: {name} launched {n} times, want {want}")
        results[name]["launches_by_path"]["train"] = n
    require(all(map(math.isfinite, losses)), "trainer: a loss is not finite")
    require(losses[-1] < losses[0], "trainer: the loss did not fall")
    prof = None
    if profile:
        t, eps = train.step_noise(x0, 6, 0)
        prof = profile_device(lambda: train.train_step(tr, x0, txt, t, eps),
                              "profile_train_step.json", "one training step")
    del tr
    torch.cuda.empty_cache()

    # gradients: "sage" and "sage_fp8" against exact attention, depth 2, full
    # width, 3 latent frames (seq 4,276), where the exact attention's saved
    # [s,s] scores of 30 heads fit
    gs = {}
    for backend in ("sage", "sage_fp8"):
        g = gs[backend] = grads_vs_exact(cfg.scaled(depth=2, latent_frames=3), backend)
        log(f"trainer grads, {backend!r} vs exact attention (depth {g['depth']}, seq "
            f"{g['seq']}, full width, {g['params']} parameters): min cosine "
            f"{g['min_cosine']:.6f} ({g['min_cosine_param']}); k_norm.bias |g| / "
            f"|g(k_norm.weight)| {g['k_norm_bias_over_weight']:.2e}; V quantizer launches "
            f"{g['v_quant_launches']}")
        require(g["min_cosine"] >= 0.999,
                f"trainer gradients with {backend!r} disagree with exact attention")
        require(g["k_norm_bias_over_weight"] <= 1e-2, "k_norm.bias gradient is not negligible")
    require(gs["sage_fp8"]["v_quant_launches"] == {"forward": 2, "backward": 0},
            "the fp8 trainer must quantize V once a layer in the forward, never in the backward")
    # smooth_q: the exact-recompute backward, which launches no kernel of
    # this repo (its library call is SDPA's backward)
    g = gs["sage+smooth_q"] = grads_vs_exact(cfg.scaled(depth=2, latent_frames=3), "sage",
                                             kwargs={"smooth_q": True})
    log(f"trainer grads, 'sage' with smooth_q (exact recompute) vs exact attention (depth "
        f"{g['depth']}, seq {g['seq']}): min cosine {g['min_cosine']:.6f} "
        f"({g['min_cosine_param']}); backward launches {g['backward_launches']}")
    require(g["min_cosine"] >= 0.999, "trainer gradients with smooth_q disagree with exact")
    require(g["k_norm_bias_over_weight"] <= 1e-2, "k_norm.bias gradient is not negligible")
    require(g["backward_launches"] == {}, "the smooth_q backward launched a kernel of the repo")
    return {"depth": depth, "seq": cfg.seq_len, "params": n_params, "losses": losses,
            "step_ms": ms, "median_step_ms": statistics.median(ms), "peak_memory_gb": peak_gb,
            "grads_vs_exact": gs, "profile": prof}


def bias_train_inputs(layer: dict, seed: int):
    """The bias trainer's leaves and target at ``layer``'s heads (b 1, 4096
    tokens, causal): bf16 q, k, v, the ALiBi slopes at twice the standard
    ones, and exact fp32 attention with the standard slopes."""
    import torch
    from sageattention_tpu_torch.ops import reference

    s = 4096
    hq, hkv, d = layer.values()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (torch.randn(1, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    with torch.no_grad():
        target = reference.attention_reference(q.float(), k.float(), v.float(), is_causal=True,
                                               attn_bias=alibi(hq, s))
    return q, k, v, (2 * alibi_slopes(hq)).requires_grad_(), target


def run_bias_train(results, layer: dict = LLM_LAYER, seed: int = 21) -> dict:
    """Phase 4b, the bias trainer, a kernel check and not a cell: one
    llm-8b-gqa attention layer at full width (b 1, 4096 tokens, 32 query and
    8 KV heads of 128, causal; phase 7e gives Gemma-7B's 16/16 heads of 256,
    whose path is ``bias_hd256_train`` and whose launches are the D = 256
    instances) whose trainable tensors are per-head ALiBi
    slopes (fp32, started at twice the standard ones) and q, k, v (bf16
    leaves).  The bias -slope * |i - j| is built in autograd at [1, 32, s,
    s] fp32, so ``sageattn`` takes the fused route; the target is exact
    attention with the standard slopes.  MSE and AdamW: one warm-up step
    and 4 steps timed with CUDA events; the loss must be finite and fall,
    and each step must launch the masked forward and the dQ and dKV bias
    instances once, and no other kernel.  The first step's gradients of q,
    k, v and the slopes, and dBias element by element, are held at >=
    0.999 against the autograd of fp32 exact attention, and the same step
    with the bias fixed must ask for no dBias, launch the bias instances,
    give q, k and v the same gradients bit for bit and hold them at >=
    0.999.  (After the timed steps the output sits closer to the target
    than the quantization error allows a cosine to resolve.)"""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import autodiff, reference

    b, s = 1, 4096
    hq, hkv, d = layer.values()
    path = "bias_hd256_train" if d == 256 else "bias_train"
    launched = BIAS_TRAIN_HD256 if d == 256 else BIAS_TRAIN
    dq_bias, dkv_bias = launched[-2:]  # the backward's bias instances
    q0, k0, v0, slopes, target = bias_train_inputs(layer, seed)

    def exact(q, k, v, bias):
        return reference.attention_reference(q.float(), k.float(), v.float(), is_causal=True,
                                             attn_bias=bias)

    def sage(q, k, v, bias):
        o = core.sageattn(q, k, v, is_causal=True, attn_bias=bias)
        require(type(o.grad_fn).__name__ == "SageAttnFunctionBackward",
                "bias trainer: sageattn did not take the fused bias route")
        return o

    q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))

    def loss_of(attn, bias):
        return F.mse_loss(attn(q, k, v, bias).float(), target)

    # the first step's gradients against fp32 exact attention's
    names = ("q", "k", "v", "slopes", "dbias")
    grads = {}
    for name, attn in (("sage", sage), ("exact", exact)):
        bias = alibi_bias(slopes, s)
        grads[name] = torch.autograd.grad(loss_of(attn, bias), [q, k, v, slopes, bias])
    first = {n: agreement(g, r)[0] for n, g, r in zip(names, grads["sage"], grads["exact"])}
    log(f"{path} first-step gradients vs fp32 exact attention: "
        f"{ {n: round(c, 6) for n, c in first.items()} }")
    require(min(first.values()) >= 0.999, f"{path}: gradients disagree with exact")

    # the same step with the bias fixed (ALiBi while q, k, v train): no
    # dBias asked, the trainable bias's q, k, v gradients bit for bit, and
    # against exact attention's
    fixed = alibi_bias(slopes.detach(), s)
    asked = []
    vjp = autodiff.quantized_attention_vjp

    def spy(*args, **kwargs):  # what the fused backward asks of the kernels
        asked.append(kwargs["need_dbias"])
        return vjp(*args, **kwargs)

    zero_counts()
    autodiff.quantized_attention_vjp = spy
    try:
        g_s = torch.autograd.grad(loss_of(sage, fixed), [q, k, v])
    finally:
        autodiff.quantized_attention_vjp = vjp
    fixed_launches = {n: c for n, c in read_counts().items() if c}
    g_r = torch.autograd.grad(loss_of(exact, fixed), [q, k, v])
    fixed_cos = {n: agreement(a_, r_)[0] for n, a_, r_ in zip("qkv", g_s, g_r)}
    log(f"{path}, the first step with the bias fixed: dBias asked {asked}; launches "
        f"{fixed_launches}; q, k, v gradients vs exact {fixed_cos}")
    require(asked == [False], "bias trainer: a fixed bias asked the kernels for dBias")
    require(fixed_launches.get(dq_bias) == 1 and fixed_launches.get(dkv_bias) == 1,
            "bias trainer: the fixed bias did not launch the bias instances")
    require(min(fixed_cos.values()) >= 0.999, "bias trainer: fixed-bias gradients disagree")
    same = all(torch.equal(a_, t_) for a_, t_ in zip(g_s, grads["sage"][:3]))
    require(same, "bias trainer: a fixed bias changed the q, k, v gradients")
    del grads, g_s, g_r, fixed

    opt = torch.optim.AdamW([{"params": [q, k, v], "lr": 1e-2},
                             {"params": [slopes], "lr": 2e-2}], weight_decay=0.0)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(sage, alibi_bias(slopes, s))
        loss.backward()
        opt.step()
        return loss

    losses = [step().item()]  # warm-up, not counted
    zero_counts()
    ms = []
    for _ in range(TRAIN_STEPS):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step()
        e.record()
        e.synchronize()
        ms.append(a.elapsed_time(e))
        losses.append(loss.item())
    launches = read_counts()
    log(f"{path}: losses {[round(x, 8) for x in losses]}; ms per step "
        f"{[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    for name, n in launches.items():
        want = TRAIN_STEPS if name in launched else 0
        require(n == want, f"{path}: {name} launched {n} times, want {want}")
        results[name]["launches_by_path"][path] = n
    require(all(map(math.isfinite, losses)), f"{path}: a loss is not finite")
    require(losses[-1] < losses[0], f"{path}: the loss did not fall")
    out = {"shape": [b, hq, hkv, s, d], "losses": losses, "step_ms": ms,
           "median_step_ms": statistics.median(ms), "first_step_grad_cos_vs_exact": first,
           "slopes_after": slopes.detach().cpu().tolist(),
           "fixed_bias": {"dbias_asked": asked, "launches": fixed_launches,
                          "grad_cos_vs_exact": fixed_cos}}
    del q, k, v, target, opt
    torch.cuda.empty_cache()
    return out


def time_bias_exact_step(layer: dict, seed: int) -> float:
    """Phase 7e: one step of the bias trainer by the exact route, on the
    trainer's inputs at ``layer``: the same quantized forward, the backward
    by autograd of exact fp32 attention ([b, hq, s, s] scores), and AdamW.
    No backward kernel may launch.  Returns the median of 2 steps, in ms."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import autodiff

    q, k, v, slopes, target = bias_train_inputs(layer, seed)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    opt = torch.optim.AdamW([{"params": [q, k, v], "lr": 1e-2},
                             {"params": [slopes], "lr": 2e-2}], weight_decay=0.0)
    s = q.shape[2]

    def exact_step():
        opt.zero_grad(set_to_none=True)
        o = autodiff.RecomputeFunction.apply(q, k, v, alibi_bias(slopes, s), True, None, True,
                                             False, "bf16", False, None, core.QKOptions())
        F.mse_loss(o.float(), target).backward()
        opt.step()

    zero_counts()
    ms = cuda_ms(exact_step, reps=2, warmup=1)
    bwd_launches = {n: c for n, c in read_counts().items()
                    if c and n.startswith("sage_attn_bwd")}
    require(not bwd_launches, f"the bias trainer's exact route launched {bwd_launches}")
    log(f"one bias trainer step of the exact route at {tuple(q.shape)}: {ms:.3f} ms")
    del q, k, v, target, opt
    torch.cuda.empty_cache()
    return ms


# --------------------------------------------------------------------------
# phase 6: times at the model shape
# --------------------------------------------------------------------------


def time_kernels(gen, results):
    import torch
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import quant_cuda

    b, h, s, d = COG["b"], COG["h"], COG["s"], COG["d"]
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    ng = -(-s // 128)

    km = quant_cuda.k_channel_mean(k)
    r = results["k_channel_mean"]
    r["ms"] = cuda_ms(lambda: quant_cuda.k_channel_mean(k))
    r["plain_ms"] = cuda_ms(lambda: quant_cuda.k_channel_mean_plain(k))
    r["library_ms"] = cuda_ms(lambda: torch.mean(k, dim=-2, dtype=torch.float32))
    r["bound_ms"] = (k.numel() * 2 + km.numel() * 4) / PEAK_BYTES_S * 1e3
    r["bound_by"] = "bytes"

    r = results["quant_k_chunked"]
    r["ms"] = cuda_ms(lambda: quant_cuda.quant_k_chunked(k, km, group=128))
    r["plain_ms"] = cuda_ms(lambda: quant_cuda.quant_k_chunked_plain(k, km, group=128))
    r["library_ms"] = None
    r["bound_ms"] = (k.numel() * 3 + km.numel() * 4 + b * h * ng * 4) / PEAK_BYTES_S * 1e3
    r["bound_by"] = "bytes"

    # the V-code widening before the wgmma forward, e4m3 codes (server_fp8's)
    from sageattention_tpu_torch.ops import attention_cuda

    vq = quant_cuda.quant_v_per_channel(v, dtype=quant.V_DTYPES["fp8"])[0]
    r = results["widen_v_codes"]
    r["ms"] = cuda_ms(lambda: attention_cuda.widen_v_codes(vq))
    r["plain_ms"] = cuda_ms(lambda: attention_cuda.widen_v_codes_plain(vq))
    r["library_ms"] = cuda_ms(lambda: vq.to(torch.bfloat16))  # the plain version is this call
    r["bound_ms"] = vq.numel() * 3 / PEAK_BYTES_S * 1e3
    r["bound_by"] = "bytes"
    log(f"time widen_v_codes at {tuple(vq.shape)} e4m3: {r['ms']:.4f} ms (bound "
        f"{r['bound_ms']:.4f} ms, bytes), plain {r['plain_ms']:.4f} ms")
    del vq

    r = results["sage_attn_fwd"]
    cog = attention_times(gen, (b, h, s, d), ("bf16", *quant.V_DTYPES), plain=True)
    r.update(ms=cog["bf16"]["ms"], plain_ms=cog["plain_ms"], library_ms=cog["sdpa_ms"],
             bound_ms=cog["bf16"]["bound_ms"], bound_by=cog["bf16"]["bound_by"])
    r["ms_by_v_type"] = {pv: cog[pv]["ms"] for pv in ("bf16", *quant.V_DTYPES)}
    r.update(pairs=b * h * s * s, d=d)  # for the floors at the measured rates (phase 9)
    wan = attention_times(gen, tuple(WAN.values()), ("bf16", "fp8"), plain=False)
    r["wan_layer"] = {"shape": list(WAN.values()), "ms_bf16": wan["bf16"]["ms"],
                      "ms_fp8": wan["fp8"]["ms"], "sdpa_ms": wan["sdpa_ms"],
                      "bound_ms": wan["bf16"]["bound_ms"], "bound_by": wan["bf16"]["bound_by"],
                      "ms": wan["bf16"]["ms"], "pairs": WAN["b"] * WAN["h"] * WAN["s"] ** 2,
                      "d": WAN["d"]}
    for shape, t in ((COG, cog), (WAN, wan)):
        for pv, x in t.items():
            if isinstance(x, dict):
                log(f"time sage_attn_fwd at {tuple(shape.values())} V {pv}: {x['ms']:.4f} ms "
                    f"(bound {x['bound_ms']:.4f} ms, {x['bound_by']})")
        log(f"time SDPA fwd at {tuple(shape.values())}: {t['sdpa_ms']:.4f} ms")


def attention_times(gen, shape, v_types, plain: bool) -> dict:
    """The forward kernel's time at ``shape`` (b, h, s, d), non-causal, for
    each V type in ``v_types`` ("bf16" or a ``pv_dtype``) with its bound;
    SDPA's time on the bf16 inputs; with ``plain``, the plain version's."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core, quant
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda

    b, h, s, d = shape
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    fold = d**-0.5 * core.LOG2E
    pairs = b * h * s * s
    t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + 2 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
    out = {"sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=20)}
    for pv in v_types:
        if pv == "bf16":
            vq, vs = v, None
        else:
            vq, vs, _ = quant_cuda.quant_v_per_channel(v, dtype=quant.V_DTYPES[pv])
        ms = cuda_ms(lambda vq=vq, vs=vs: attention_cuda.sage_attention_fwd(
            q, k_i8, k_sc, vq, vs, is_causal=False, q_fold=fold), reps=20)
        t_bytes = (q.numel() * 2 + k_i8.numel() + k_sc.numel() * 4
                   + vq.numel() * vq.element_size() + (vs.numel() * 4 if vs is not None else 0)
                   + q.numel() * 2) / PEAK_BYTES_S * 1e3
        out[pv] = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if plain:
        out["plain_ms"] = cuda_ms(lambda: attention_cuda.sage_attention_plain(
            q, k_i8, k_sc, v, is_causal=False, q_fold=fold, return_lse=False),
            reps=10, warmup=1)
    return out


def time_qopts(gen, results) -> dict:
    """The pre-quantized forward for each Q/K option at the CogVideoX-2B and
    Wan2.1 layers (non-causal, bf16 V), beside the default forward and SDPA
    on the same inputs; its plain version at the CogVideoX-2B layer; the
    PyTorch preparation (``quant.quantize_qk`` per_subtile, smooth_q's
    centring and column bias) per layer beside the op's own through kernels
    2-4 (``core._quant_qk``) for each option; kernels 3 and 4 at 4 bits.  The
    kernels line reports int4 + smooth_q, server_int4_sq's path."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core, quant
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda

    out = {}
    for lname, shape in (("cogvideox layer", COG), ("wan layer", WAN)):
        b, h, s, d = shape.values()
        q, k, v = biased_qk(gen, (b, h, s, d))
        sm = d**-0.5
        k_i8, k_sc, km = quant_cuda.quant_k_fused_mean(k, group=128)
        pairs = b * h * s * s
        t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + 2 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
        row = {"default_ms": cuda_ms(lambda: attention_cuda.sage_attention_fwd(
                   q, k_i8, k_sc, v, is_causal=False, q_fold=sm * LOG2E), reps=20),
               "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=20)}
        for name, opts in QOPTS.items():
            q_i8, q_sc, ki, ks, cb = preq_operands(q, k, opts)
            ms = cuda_ms(lambda: attention_cuda.sage_attention_fwd_preq(
                q_i8, q_sc, ki, ks, v, is_causal=False, col_bias=cb), reps=20)
            moved = (q_i8.numel() + q_sc.numel() * 4 + ki.numel() + ks.numel() * 4
                     + (cb.numel() * 4 if cb is not None else 0) + v.numel() * 2 + q.numel() * 2)
            t_bytes = moved / PEAK_BYTES_S * 1e3
            row[name] = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            log(f"time sage_attn_fwd_preq {name} at {(b, h, s, d)}: {ms:.4f} ms (bound "
                f"{row[name]['bound_ms']:.4f} ms, {row[name]['bound_by']}; default forward "
                f"{row['default_ms']:.4f} ms)")
            if lname == "cogvideox layer" and name == "int4+smooth_q":
                r = results["sage_attn_fwd_preq"]
                r.update(ms=ms, bound_ms=row[name]["bound_ms"], bound_by=row[name]["bound_by"],
                         library_ms=row["sdpa_ms"], pairs=pairs, d=d,
                         plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_preq_plain(
                             q_i8, q_sc, ki, ks, v, is_causal=False, return_lse=False,
                             col_bias=cb), reps=5, warmup=1))
            del q_i8, q_sc, ki, ks, cb
        qm, q_c = core._smooth_q(q)
        row["quantize_qk_per_subtile_ms"] = cuda_ms(lambda: quant.quantize_qk(
            q, k, sm_scale=sm, granularity="per_subtile"))
        row["smooth_q_prep_ms"] = cuda_ms(lambda: (core._smooth_q(q), core._score_col_bias(
            qm, k, km[..., :d], sm)))
        log(f"time at {(b, h, s, d)}: quantize_qk per_subtile (PyTorch) "
            f"{row['quantize_qk_per_subtile_ms']:.4f} ms; smooth_q's qm, centred Q and column "
            f"bias (PyTorch) {row['smooth_q_prep_ms']:.4f} ms; SDPA {row['sdpa_ms']:.4f} ms")
        # the preparation the op runs (core._quant_qk: kernels 2-4, and the
        # column bias in PyTorch), each option's Q and K operands whole
        row["quant_qk_ms"] = {name: cuda_ms(lambda: core._quant_qk(
            q, k, core.QKOptions(**opts), work=torch.bfloat16, d_pad=d, sm_scale=sm,
            smooth_k=True)) for name, opts in QOPTS.items()}
        log(f"time at {(b, h, s, d)}: the op's Q/K preparation through the kernels (ms) "
            f"{ {n: round(x, 4) for n, x in row['quant_qk_ms'].items()} }")
        out[lname] = row
        if lname == "cogvideox layer":
            # kernels 3 and 4 at 4 bits; bounds as at 8 bits (the same bytes)
            fold = sm * LOG2E
            r = results["quant_q_per_token"]["bits4"]
            r.update(ms=cuda_ms(lambda: quant_cuda.quant_q_per_token(q_c, scale_fold=fold,
                                                                     bits=4)),
                     plain_ms=cuda_ms(lambda: quant_cuda.quant_q_per_token_plain(
                         q_c, scale_fold=fold, bits=4)),
                     bound_ms=(q.numel() * 3 + b * h * s * 4) / PEAK_BYTES_S * 1e3,
                     bound_by="bytes", library_ms=None)
            r = results["quant_k_chunked"]["bits4"]
            r.update(ms=cuda_ms(lambda: quant_cuda.quant_k_chunked(k, km, group=128, bits=4)),
                     plain_ms=cuda_ms(lambda: quant_cuda.quant_k_chunked_plain(
                         k, km, group=128, bits=4)),
                     bound_ms=(k.numel() * 3 + km.numel() * 4 + b * h * -(-s // 128) * 4)
                     / PEAK_BYTES_S * 1e3, bound_by="bytes", library_ms=None)
            for name in ("quant_q_per_token", "quant_k_chunked"):
                r = results[name]["bits4"]
                log(f"time {name} 4 bits at {(b, h, s, d)}: {r['ms']:.4f} ms (bound "
                    f"{r['bound_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms")
        del q, k, v, k_i8, k_sc, km, qm, q_c
        torch.cuda.empty_cache()
    return out


def time_quant_v(gen, results):
    """Kernel 5 at the CogVideoX-2B layer shape and kernel 6's two launches
    at the Wan2.1 one, with fp8 e4m3 codes and no smoothing, as the
    "sage_fp8" servers run them.  No single PyTorch call computes them.
    ``v_channel_stats`` is timed with its combine of the blocks."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda as qc

    e4m3 = torch.float8_e4m3fn
    for name, shape in (("quant_v_per_channel", COG), ("v_channel_stats", WAN),
                        ("quant_v_apply", WAN)):
        b, h, s, d = shape.values()
        v = random_v(gen, (b, h, s, d))
        n, vecs = v.numel(), b * h * d * 4  # elements; bytes of one [b,h,d] fp32
        r = results[name]
        if name == "quant_v_per_channel":
            r["ms"] = cuda_ms(lambda: qc.quant_v_per_channel(v, dtype=e4m3))
            r["plain_ms"] = cuda_ms(lambda: qc.quant_v_per_channel_plain(v, dtype=e4m3,
                                                                         smooth=False))
            moved = n * 2 + n + vecs  # V in, codes and scales out
        elif name == "v_channel_stats":
            r["ms"] = cuda_ms(lambda: qc.v_channel_stats(v, smooth=False))
            r["plain_ms"] = cuda_ms(lambda: qc.v_channel_stats_plain(v, smooth=False))
            moved = n * 2 + 2 * vecs  # V in, max and min out
        else:
            gmax, gmin, _ = qc.v_channel_stats(v, smooth=False)
            _, rs = qc.v_scale_from_stats(gmax, gmin, None, e4m3)
            r["ms"] = cuda_ms(lambda: qc.quant_v_apply(v, rs, None, dtype=e4m3))
            r["plain_ms"] = cuda_ms(lambda: qc.quant_v_apply_plain(v, rs, None, dtype=e4m3))
            moved = n * 2 + vecs + n  # V and 1/scale in, codes out
        r["library_ms"] = None
        r["bound_ms"] = moved / PEAK_BYTES_S * 1e3
        r["bound_by"] = "bytes"
        log(f"time {name} at {tuple(shape.values())} e4m3: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms, bytes), plain {r['plain_ms']:.4f} ms")


def time_backward(gen, results) -> dict:
    """Kernels 4, 7 and 8 at the model shape, and one layer's attention
    forward + backward against SDPA's."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import quant_cuda

    b, h, s, d = COG["b"], COG["h"], COG["s"], COG["d"]
    ops, sm = backward_case(gen, b, h, h, s, s, d, False)
    kw = dict(is_causal=False, sm_scale=sm)
    q = ops["q_bf"]
    fold = sm * LOG2E

    r = results["quant_q_per_token"]
    r["ms"] = cuda_ms(lambda: quant_cuda.quant_q_per_token(q, scale_fold=fold))
    r["plain_ms"] = cuda_ms(lambda: quant_cuda.quant_q_per_token_plain(q, scale_fold=fold))
    r["library_ms"] = None
    r["bound_ms"] = (q.numel() * 3 + b * h * s * 4) / PEAK_BYTES_S * 1e3
    r["bound_by"] = "bytes"

    # SDPA's bf16 backward at the same shape: (fwd + bwd) - fwd, autograd
    v, do = ops["v"], ops["do"]
    k = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*xs)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), xs, do)

    def sage_fwd_bwd():
        torch.autograd.grad(core.sageattn(*xs), xs, do)

    sdpa_f = cuda_ms(sdpa_fwd, reps=10)
    sdpa_fb = cuda_ms(sdpa_fwd_bwd, reps=10)
    sage_fb = cuda_ms(sage_fwd_bwd, reps=5)
    sdpa_bwd = sdpa_fb - sdpa_f

    pairs = b * h * s * s
    t_int8 = 2 * pairs * d / PEAK_INT8_OPS_S * 1e3
    row_bytes = b * h * s * 4  # one fp32 per row (scales, lse2, dvec)
    common_bytes = (ops["q_i8"].numel() + ops["k_i8"].numel() + ops["k_scale"].numel() * 4
                    + 3 * row_bytes + ops["v"].numel() * 2 + ops["do"].numel() * 2)
    for name, n_bf16, extra_in, out_elems in (
            ("sage_attn_bwd_dq", 4, ops["k_sm"].numel() * 2, b * h * s * d),
            ("sage_attn_bwd_dkv", 6, q.numel() * 2, 2 * b * h * s * d)):
        fn = bwd.sage_attention_bwd_dq if name.endswith("dq") else bwd.sage_attention_bwd_dkv
        plain = (bwd.sage_attention_bwd_dq_plain if name.endswith("dq")
                 else bwd.sage_attention_bwd_dkv_plain)
        args = dq_args(ops) if name.endswith("dq") else dkv_args(ops)
        r = results[name]
        r["ms"] = cuda_ms(lambda: fn(*args, **kw), reps=10)
        r["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
        r["library_ms"] = sdpa_bwd  # the yardstick of kernels 7 + 8 together
        t_ops = t_int8 + n_bf16 * pairs * d / PEAK_BF16_FLOP_S * 1e3
        t_bytes = (common_bytes + extra_in + out_elems * 4) / PEAK_BYTES_S * 1e3
        r["bound_ms"] = max(t_ops, t_bytes)
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        r.update(pairs=pairs, d=d, bf16_ops_per_pair=n_bf16 * d)
    layer = {"shape": list(COG.values()), "sage_fwd_bwd_ms": sage_fb,
             "sdpa_fwd_bwd_ms": sdpa_fb, "sdpa_fwd_ms": sdpa_f, "sdpa_bwd_ms": sdpa_bwd}
    log(f"one layer's attention at {tuple(COG.values())}: sage fwd+bwd {sage_fb:.3f} ms, "
        f"SDPA fwd+bwd {sdpa_fb:.3f} ms (fwd {sdpa_f:.3f}, bwd {sdpa_bwd:.3f})")
    for name in FORWARD + BACKWARD:
        r = results[name]
        log(f"time {name} at {tuple(COG.values())}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']} ms")
    return layer


def time_backward_gqa(results, seed: int = 14) -> dict:
    """Kernels 7 and 8 without a bias at the llm-8b-gqa layer (1, 32/8, 4096,
    128), causal: each beside its bound over the live pairs, its plain
    version and SDPA's backward at the same shape (fwd + bwd - fwd, bf16,
    ``enable_gqa``), into the kernels' ``gqa_causal`` entries.  Inputs from
    a generator of their own."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b, s = 1, 4096
    hq, hkv, d = LLM_LAYER.values()
    ops, sm = backward_case(gen, b, hq, hkv, s, s, d, True)
    kw = dict(is_causal=True, sm_scale=sm)
    pairs = live_pairs(Masks(), b, s, s, True, hq)
    xs = [x.clone().requires_grad_() for x in (ops["q_bf"], ops["k_sm"], ops["v"])]

    def sdpa():
        return F.scaled_dot_product_attention(*xs, is_causal=True, enable_gqa=True)

    sdpa_f = cuda_ms(sdpa, reps=10)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(sdpa(), xs, ops["do"]), reps=10)
    common_bytes = (ops["q_i8"].numel() + ops["k_i8"].numel() + ops["k_scale"].numel() * 4
                    + 3 * b * hq * s * 4 + ops["v"].numel() * 2 + ops["do"].numel() * 2)
    out = {"shape": [b, hq, hkv, s, d], "causal": True, "sdpa_fwd_bwd_ms": sdpa_fb,
           "sdpa_fwd_ms": sdpa_f}
    for name, n_bf16, extra_in, out_elems in (
            ("sage_attn_bwd_dq", 4, ops["k_sm"].numel() * 2, b * hq * s * d),
            ("sage_attn_bwd_dkv", 6, ops["q_bf"].numel() * 2, 2 * b * hkv * s * d)):
        dq = name.endswith("dq")
        fn, plain = ((bwd.sage_attention_bwd_dq, bwd.sage_attention_bwd_dq_plain) if dq
                     else (bwd.sage_attention_bwd_dkv, bwd.sage_attention_bwd_dkv_plain))
        args = dq_args(ops) if dq else dkv_args(ops)
        t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + n_bf16 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
        t_bytes = (common_bytes + extra_in + out_elems * 4) / PEAK_BYTES_S * 1e3
        r = results[name]["gqa_causal"] = dict(
            ms=cuda_ms(lambda: fn(*args, **kw), reps=10),
            plain_ms=cuda_ms(lambda: plain(*args, **kw), reps=3, warmup=1),
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=sdpa_fb - sdpa_f, pairs=pairs, d=d, bf16_ops_per_pair=n_bf16 * d)
        log(f"time {name} at {(b, hq, hkv, s, d)} causal: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain {r['plain_ms']:.4f} ms, SDPA bwd "
            f"(7 + 8) {r['library_ms']:.4f} ms")
    del ops, xs
    torch.cuda.empty_cache()
    return out


def time_masked(gen, results) -> dict:
    """The masked forward at the windowed prefill's layer (2, 32/8, 8192,
    128, window 4096) and at the varlen shape (the four causal prompts),
    each beside its bound over the live pairs, its plain version and SDPA
    with the equivalent bool mask (K and V repeated to 32 heads); the
    varlen call beside its four sequences' causal calls and one unskipped
    causal call over all 8192 tokens; the masked pre-quantized forward
    (int4 + smooth_q) over the same prompts; the masked forward with the fp32
    ALiBi bias at (1, 32/8, 4096, 128), causal, beside its bound (the bias
    read over the live pairs) and SDPA with that bias; ``tile_liveness``
    on the padding mask and the segment ids at 4096 tokens; and the
    windowed dQ and dK/dV at (1, 32/8, 4096, 128, window 1024)."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import attention_cuda, reference
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    hq, hkv, d = LLM_LAYER.values()
    fold = d**-0.5 * LOG2E
    out = {}

    def moved(q, k_i8, k_sc, v):  # Q, K codes and scales, V in; O out
        return q.numel() * 4 + k_i8.numel() + k_sc.numel() * 4 + v.numel() * 2

    def sdpa_ms(q, k, v, mask):
        kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask), reps=5)

    def kernel(q, k_i8, k_sc, v, masks):
        return lambda: attention_cuda.sage_attention_fwd_masked(q, k_i8, k_sc, v, masks=masks,
                                                                 is_causal=True, q_fold=fold)

    # the windowed prefill's layer
    b, s, w = 2, 8192, 4096
    q, k, v, k_i8, k_sc = layer_operands(gen, b, s)
    masks = Masks(window=w)
    pairs = live_pairs(masks, b, s, s, True, hq)
    bound, by = masked_bound(pairs, d, moved(q, k_i8, k_sc, v))
    r = results["sage_attn_fwd_masked"]
    r.update(ms=cuda_ms(kernel(q, k_i8, k_sc, v, masks), reps=10), bound_ms=bound, bound_by=by,
             plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_plain(
                 q, k_i8, k_sc, v, is_causal=True, q_fold=fold, return_lse=False,
                 masks=masks), reps=2, warmup=1),
             library_ms=sdpa_ms(q, k, v, reference._build_mask(s, s, is_causal=True,
                                                                device="cuda", window=w)),
             shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "window": w,
                    "live_pairs_per_head": pairs // (b * hq)})
    causal_ms = cuda_ms(lambda: attention_cuda.sage_attention_fwd(q, k_i8, k_sc, v,
                                                                  is_causal=True, q_fold=fold))
    log(f"time sage_attn_fwd_masked, window {w} at {(b, hq, hkv, s, d)}: {r['ms']:.4f} ms "
        f"(bound {bound:.4f} ms over {pairs // (b * hq)} live pairs a head, {by}), plain "
        f"{r['plain_ms']:.4f} ms, SDPA with the band mask {r['library_ms']:.4f} ms; the "
        f"unmasked causal kernel {causal_ms:.4f} ms")
    out["window_layer"] = {**r["shape"], "ms": r["ms"], "causal_unmasked_ms": causal_ms}
    del q, k, v, k_i8, k_sc

    # the varlen shape: per-row key ranges of four packed causal prompts
    s = sum(VARLEN_LENS)
    q, k, v, k_i8, k_sc = layer_operands(gen, 1, s)
    cu, seg, masks = varlen_masks()
    pairs = live_pairs(masks, 1, s, s, True, hq)
    bound, by = masked_bound(pairs, d, moved(q, k_i8, k_sc, v) + 2 * s * 4)
    ms = cuda_ms(kernel(q, k_i8, k_sc, v, masks), reps=20)
    seq_ms = []
    for i in range(len(VARLEN_LENS)):  # 128-row multiples: the same K groups
        rows, g = slice(int(cu[i]), int(cu[i + 1])), slice(int(cu[i]) // 128, int(cu[i + 1]) // 128)
        xs = [x[:, :, rows].contiguous() for x in (q, k_i8, v)]
        ks = k_sc[:, :, g].contiguous()
        seq_ms.append(cuda_ms(lambda xs=xs, ks=ks: attention_cuda.sage_attention_fwd(
            xs[0], xs[1], ks, xs[2], is_causal=True, q_fold=fold), reps=20))
    full_ms = cuda_ms(lambda: attention_cuda.sage_attention_fwd(q, k_i8, k_sc, v, is_causal=True,
                                                                q_fold=fold))
    block_diag = (seg[:, None] == seg[None, :]) & reference._build_mask(s, s, is_causal=True,
                                                                        device="cuda")
    lib = sdpa_ms(q, k, v, block_diag)
    out["varlen"] = {"lengths": list(VARLEN_LENS), "ms": ms, "bound_ms": bound, "bound_by": by,
                     "live_pairs_per_head": pairs // hq, "per_sequence_ms": seq_ms,
                     "per_sequence_sum_ms": sum(seq_ms), "unskipped_causal_ms": full_ms,
                     "sdpa_block_diagonal_ms": lib}
    log(f"time sage_attn_fwd_masked, varlen {VARLEN_LENS} at {(1, hq, hkv, s, d)}: {ms:.4f} ms "
        f"(bound {bound:.4f} ms over {pairs // hq} live pairs a head, {by}); the four "
        f"sequences' causal calls {[round(x, 4) for x in seq_ms]} sum {sum(seq_ms):.4f} ms; one "
        f"unskipped causal call over {s} tokens {full_ms:.4f} ms; SDPA with the block-diagonal "
        f"mask {lib:.4f} ms")
    # the masked pre-quantized forward over the same prompts (sageattn_varlen
    # with a Q/K option): int4 codes with smooth_q's column bias
    q_i8, q_sc, kq_i8, kq_sc, cb = preq_operands(q, k, QOPTS["int4+smooth_q"])
    # Q codes and scales, the column bias, K codes and scales, bf16 V in;
    # bf16 O out; the rows' key ranges
    moved_q = (q_i8.numel() * 3 + q_sc.numel() * 4 + cb.numel() * 4 + kq_i8.numel()
               + kq_sc.numel() * 4 + v.numel() * 2 + 2 * s * 4)
    bound_q, by_q = masked_bound(pairs, d, moved_q)
    ms_q = cuda_ms(lambda: attention_cuda.sage_attention_fwd_preq(
        q_i8, q_sc, kq_i8, kq_sc, v, is_causal=True, col_bias=cb, masks=masks), reps=20)
    plain_q = cuda_ms(lambda: attention_cuda.sage_attention_preq_plain(
        q_i8, q_sc, kq_i8, kq_sc, v, is_causal=True, return_lse=False, col_bias=cb, masks=masks),
        reps=2, warmup=1)
    out["varlen_preq"] = {"options": "int4+smooth_q", "ms": ms_q, "plain_ms": plain_q,
                          "bound_ms": bound_q, "bound_by": by_q, "sdpa_block_diagonal_ms": lib}
    log(f"time sage_attn_fwd_preq with masks, varlen {VARLEN_LENS} at {(1, hq, hkv, s, d)}, "
        f"int4 + smooth_q: {ms_q:.4f} ms (bound {bound_q:.4f} ms, {by_q}), plain {plain_q:.4f} "
        f"ms; SDPA with the block-diagonal mask {lib:.4f} ms")
    del q, k, v, k_i8, k_sc, block_diag, q_i8, q_sc, kq_i8, kq_sc, cb

    # the biased forward: the fp32 ALiBi bias [1, 32, s, s], causal (inputs
    # from a generator of its own, so that the later phases' stay as they were)
    s = 4096
    g_bias = torch.Generator(device="cuda")
    g_bias.manual_seed(33)
    q, k, v, k_i8, k_sc = layer_operands(g_bias, 1, s)
    bias = alibi(hq, s)
    masks = Masks(bias=bias)
    pairs = live_pairs(masks, 1, s, s, True, hq)
    bound, by = masked_bound(pairs, d, moved(q, k_i8, k_sc, v) + pairs * 4)
    ms = cuda_ms(lambda: attention_cuda.sage_attention_fwd_masked(
        q, k_i8, k_sc, v, masks=masks, is_causal=True, q_fold=fold), reps=10)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    causal_bias = bias.masked_fill(~reference._build_mask(s, s, is_causal=True, device="cuda"),
                                   float("-inf"))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=causal_bias),
                  reps=5)
    out["alibi"] = {"shape": [1, hq, hkv, s, d], "ms": ms, "bound_ms": bound, "bound_by": by,
                    "sdpa_with_the_bias_ms": lib}
    log(f"time sage_attn_fwd_masked, fp32 ALiBi bias causal at {(1, hq, hkv, s, d)}: {ms:.4f} "
        f"ms (bound {bound:.4f} ms, {by}: the bias read over {pairs // hq} live pairs a head); "
        f"SDPA with the bias {lib:.4f} ms")
    # the liveness table the masked wrapper builds on every call with ids or a mask
    idx = torch.arange(s, device="cuda")
    pad = ((idx[None, :] < 3500) & (idx[:, None] < 4000))[None, None]
    ids = ((idx // 512) % 3).int()[None]
    out["tile_liveness_ms"] = {
        "padding mask [1,1,s,s]": cuda_ms(lambda: attention_cuda.tile_liveness(
            Masks(mask=pad), s, s)),
        "segment ids": cuda_ms(lambda: attention_cuda.tile_liveness(
            Masks(q_seg=ids, kv_seg=ids), s, s))}
    log(f"time tile_liveness at {s} tokens: {out['tile_liveness_ms']} ms")
    del q, k, v, k_i8, k_sc, bias, kr, vr, causal_bias, pad

    # the windowed backward
    b, s, w = 1, 4096, 1024
    ops, sm = backward_case(gen, b, hq, hkv, s, s, d, True, window=w)
    kw = dict(is_causal=True, sm_scale=sm, window=w)
    pairs = live_pairs(Masks(window=w), b, s, s, True, hq)
    band = reference._build_mask(s, s, is_causal=True, device="cuda", window=w)
    xs = [x.clone().requires_grad_() for x in (ops["q_bf"], *(
        x.repeat_interleave(hq // hkv, dim=1) for x in (ops["k_sm"], ops["v"])))]
    sdpa_f = cuda_ms(lambda: F.scaled_dot_product_attention(*xs, attn_mask=band), reps=5)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*xs, attn_mask=band), xs, ops["do"]), reps=5)
    common_bytes = (ops["q_i8"].numel() + ops["k_i8"].numel() + ops["k_scale"].numel() * 4
                    + 3 * b * hq * s * 4 + ops["v"].numel() * 2 + ops["do"].numel() * 2)
    for name, n_bf16, extra_in, out_elems in (
            ("sage_attn_bwd_dq", 4, ops["k_sm"].numel() * 2, b * hq * s * d),
            ("sage_attn_bwd_dkv", 6, ops["q_bf"].numel() * 2, 2 * b * hkv * s * d)):
        dq = name.endswith("dq")
        fn, plain = ((bwd.sage_attention_bwd_dq, bwd.sage_attention_bwd_dq_plain) if dq
                     else (bwd.sage_attention_bwd_dkv, bwd.sage_attention_bwd_dkv_plain))
        args = dq_args(ops) if dq else dkv_args(ops)
        t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + n_bf16 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
        t_bytes = (common_bytes + extra_in + out_elems * 4) / PEAK_BYTES_S * 1e3
        r = results[name]["window"]
        r.update(ms=cuda_ms(lambda: fn(*args, **kw), reps=10),
                 plain_ms=cuda_ms(lambda: plain(*args, **kw), reps=2, warmup=1),
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 library_ms=sdpa_fb - sdpa_f,
                 shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "window": w,
                        "live_pairs_per_head": pairs // (b * hq)})
        log(f"time {name}, window {w} at {(b, hq, hkv, s, d)}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain {r['plain_ms']:.4f} ms, SDPA bwd "
            f"with the band mask (7 + 8) {r['library_ms']:.4f} ms")
    del ops, xs
    torch.cuda.empty_cache()
    return out


def time_bias_backward(results, layer: dict = LLM_LAYER, seed: int = 23) -> dict:
    """Kernels 7-8's bias instances at the llm-8b-gqa layer (1, 32/8, 4096,
    128), causal, with the fp32 ALiBi bias and dBias, beside their bounds
    over the live pairs (bytes: the bias read once, dBias written whole,
    the causal zeros included), their plain versions and SDPA's backward
    (fwd + bwd - fwd) with the bias as a float ``attn_mask`` that requires
    grad (bf16, q's dtype, the causal mask folded in as -inf; K and V
    repeated to 32 heads); ``sageattn``'s fwd + bwd beside SDPA's.  Inputs
    from a generator of its own, as in :func:`check_bias_backward`.  Phase
    7d gives Gemma-7B's 16/16 heads of 256, whose results go to the
    ``_hd256`` instances."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b, s = 1, 4096
    hq, hkv, d = layer.values()
    suffix = "_hd256" if d == 256 else ""
    bias = alibi(hq, s)
    ops, sm = backward_case(gen, b, hq, hkv, s, s, d, True, bias=bias)
    kw = dict(is_causal=True, sm_scale=sm, bias=bias)
    pairs = live_pairs(Masks(), b, s, s, True, hq)
    causal = reference._build_mask(s, s, is_causal=True, device="cuda")
    lib_mask = bias.masked_fill(~causal, -torch.inf).to(torch.bfloat16).requires_grad_()
    xs = [x.clone().requires_grad_() for x in (ops["q_bf"], *(
        x.repeat_interleave(hq // hkv, dim=1) for x in (ops["k_sm"], ops["v"])))]
    sdpa_f = cuda_ms(lambda: F.scaled_dot_product_attention(*xs, attn_mask=lib_mask), reps=5)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*xs, attn_mask=lib_mask), xs + [lib_mask], ops["do"]),
        reps=5)
    sq_, sk_, sv_ = (x.detach().clone().requires_grad_()
                     for x in (ops["q_bf"], ops["k_sm"], ops["v"]))
    bias_rg = bias.clone().requires_grad_()
    sage_fb = cuda_ms(lambda: torch.autograd.grad(
        core.sageattn(sq_, sk_, sv_, is_causal=True, attn_bias=bias_rg), [sq_, sk_, sv_, bias_rg],
        ops["do"]), reps=5)
    common_bytes = (ops["q_i8"].numel() + ops["k_i8"].numel() + ops["k_scale"].numel() * 4
                    + 3 * b * hq * s * 4 + ops["v"].numel() * 2 + ops["do"].numel() * 2
                    + pairs * bias.element_size())
    for name, n_bf16, extra_in, out_bytes in (
            ("sage_attn_bwd_dq_bias", 4, ops["k_sm"].numel() * 2,
             b * hq * s * d * 4 + bias.numel() * bias.element_size()),
            ("sage_attn_bwd_dkv_bias", 6, ops["q_bf"].numel() * 2, 2 * b * hkv * s * d * 4)):
        dq = name.startswith("sage_attn_bwd_dq")
        fn, plain = ((bwd.sage_attention_bwd_dq, bwd.sage_attention_bwd_dq_plain) if dq
                     else (bwd.sage_attention_bwd_dkv, bwd.sage_attention_bwd_dkv_plain))
        args = dq_args(ops) if dq else dkv_args(ops)
        kw_ = dict(kw, need_dbias=True) if dq else kw
        t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + n_bf16 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
        t_bytes = (common_bytes + extra_in + out_bytes) / PEAK_BYTES_S * 1e3
        r = results[name + suffix]
        r.update(ms=cuda_ms(lambda: fn(*args, **kw_), reps=10),
                 plain_ms=cuda_ms(lambda: plain(*args, **kw_), reps=2, warmup=1),
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 library_ms=sdpa_fb - sdpa_f, pairs=pairs, d=d, bf16_ops_per_pair=n_bf16 * d,
                 shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": True,
                        "bias": f"fp32 [1, {hq}, s, s]",
                        "live_pairs_per_head": pairs // (b * hq)})
        log(f"time {name + suffix} at {(b, hq, hkv, s, d)} causal, fp32 ALiBi bias: "
            f"{r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms, {r['bound_by']}; operations {t_ops:.4f} ms, bytes "
            f"{t_bytes:.4f} ms), plain {r['plain_ms']:.4f} ms, SDPA bwd with the bias as a float "
            f"mask (7 + 8) {r['library_ms']:.4f} ms")
    out = {"shape": [b, hq, hkv, s, d], "sage_fwd_bwd_ms": sage_fb, "sdpa_fwd_bwd_ms": sdpa_fb,
           "sdpa_fwd_ms": sdpa_f}
    log(f"one layer's attention with a trainable fp32 bias at {(b, hq, hkv, s, d)} causal: sage "
        f"fwd+bwd {sage_fb:.3f} ms, SDPA fwd+bwd with the bias as a float mask {sdpa_fb:.3f} ms "
        f"(fwd {sdpa_f:.3f})")
    del ops, xs, lib_mask, sq_, sk_, sv_, bias_rg, causal, bias
    torch.cuda.empty_cache()
    return out


def time_bias_exact_route(seed: int = 30) -> float:
    """Phase 6: ``sageattn``'s fwd + bwd by the exact route, for a broadcast
    [1, 32, s, s] fp32 ALiBi bias at b 2 of the llm-8b-gqa layer (4096
    tokens, causal); no backward kernel may launch.  Returns ms."""
    import torch
    from sageattention_tpu_torch import core

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b, s = 2, 4096
    hq, hkv, d = LLM_LAYER.values()
    bias = alibi(hq, s)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               .requires_grad_() for h in (hq, hkv, hkv))
    do = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    bias_rg = bias.clone().requires_grad_()

    def exact_route():
        o = core.sageattn(q, k, v, is_causal=True, attn_bias=bias_rg)
        require(type(o.grad_fn).__name__ == "RecomputeFunctionBackward",
                "a broadcast bias did not take the exact route")
        return torch.autograd.grad(o, [q, k, v, bias_rg], do)

    zero_counts()
    exact_ms = cuda_ms(exact_route, reps=1, warmup=1)
    bwd_launches = {n: c for n, c in read_counts().items()
                    if c and n.startswith("sage_attn_bwd")}
    log(f"time of the exact route (sageattn fwd + bwd) with a broadcast [1, 32, s, s] fp32 bias "
        f"at {(b, hq, hkv, s, d)} causal: {exact_ms:.3f} ms; backward kernel launches "
        f"{bwd_launches}")
    require(not bwd_launches, "the exact route launched a backward kernel")
    del q, k, v, do, bias_rg, bias
    torch.cuda.empty_cache()
    return exact_ms


# --------------------------------------------------------------------------
# phase 7: head dims above 128 (the D = 256 instances), Gemma-7B's widths
# --------------------------------------------------------------------------


def padded(x, d: int = 256):
    """x with its head dim zero-padded to ``d``, contiguous."""
    import torch.nn.functional as F

    return F.pad(x, (0, d - x.shape[-1])).contiguous()


def check_hd256_quant(gen, results, d: int = 256):
    """Kernels 2-6 at head dim ``d`` (256, or 384 and 512 in phase 10)
    against their plain versions: K at the Gemma-7B prefill layer (4, 16,
    4096, d), chunked bit-exact with the plain km and the whole prologue
    within one code step on <= 1e-4; Q at the layer trainer's (1, 16, 4096,
    d), 8 and 4 bits, bit-exact; V through kernel 5 at (1, 16, 4096, d) (a
    2-4 MB slab) and kernel 6 at (1, 8, 16384, d) (8-16 MB), each code type
    bit-exact without smooth-v, and with it the mean within 1e-5 relative
    and codes a step apart on <= 1e-4.  Errors go to the ``_hd<d>``
    entries."""
    import torch
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import quant_cuda as qc

    tag, sfx = f"hd{d}", f"_hd{d}"
    k = (torch.randn(4, 16, 4096, d, generator=gen, device="cuda")
         + torch.randn(4, 16, 1, d, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    km, km_p = qc.k_channel_mean(k), qc.k_channel_mean_plain(k)
    ki, ks = qc.quant_k_chunked(k, km_p, group=128)
    ki_p, ks_p = qc.quant_k_chunked_plain(k, km_p, group=128)
    kf, sf, _ = qc.quant_k_fused_mean(k, group=128)
    torch.cuda.synchronize()
    km_err = ((km - km_p).abs() / (km_p.abs() + 1e-3)).max().item()
    exact = torch.equal(ki, ki_p) and torch.equal(ks, ks_p)
    diff = (kf.int() - ki_p.int()).abs()
    frac = (diff > 0).float().mean().item()
    log(f"{tag} quant_k {tuple(k.shape)}: km max rel err {km_err:.3e}; chunked bit-exact "
        f"{exact}; fused codes off {frac:.2e} (max {diff.max().item()})")
    require(km_err <= 1e-5 and exact and diff.max().item() <= 1 and frac <= 1e-4,
            f"{tag}: the K quantizers disagree with their plain versions")
    results["k_channel_mean" + sfx]["max_abs_err"] = (km - km_p).abs().max().item()
    results["quant_k_chunked" + sfx]["max_abs_err"] = float(
        (ki.int() - ki_p.int()).abs().max().item())
    del k, ki, ki_p, kf

    q = torch.randn(1, 16, 4096, d, generator=gen, device="cuda").to(torch.bfloat16) * 3
    fold = d**-0.5 * LOG2E
    for bits in (8, 4):
        qi, qs = qc.quant_q_per_token(q, scale_fold=fold, bits=bits)
        qi_p, qs_p = qc.quant_q_per_token_plain(q, scale_fold=fold, bits=bits)
        torch.cuda.synchronize()
        exact = torch.equal(qi, qi_p) and torch.equal(qs, qs_p)
        log(f"{tag} quant_q_per_token {tuple(q.shape)} {bits} bits: bit-exact {exact}")
        require(exact, f"{tag}: quant_q_per_token at {bits} bits is not bit-exact")
    results["quant_q_per_token" + sfx]["max_abs_err"] = 0.0

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    for kernel, shape, plain, keys in (
            ("kernel 5", (1, 16, 4096, d), qc.quant_v_per_channel_plain,
             ("quant_v_per_channel" + sfx,)),
            ("kernel 6", (1, 8, 16384, d), qc.quant_v_blocked_plain,
             ("v_channel_stats" + sfx, "quant_v_apply" + sfx))):
        v = random_v(gen, shape)
        for pv, dtype in quant.V_DTYPES.items():
            for smooth in (False, True):
                q_, sc, m = qc.quant_v_per_channel(v, dtype=dtype, smooth=smooth)
                q_p, sc_p, m_p = plain(v, dtype=dtype, smooth=smooth)
                torch.cuda.synchronize()
                off = q_.view(torch.uint8) != q_p.view(torch.uint8)
                frac = off.float().mean().item()
                line = f"{tag} quant_v {kernel} {shape} {pv} smooth={smooth}: codes off {frac:.2e}"
                if not smooth:
                    ok = same(q_, q_p) and torch.equal(sc, sc_p)
                    log(line + f"; bit-exact {ok}")
                    require(ok, f"{tag} {kernel} {pv}: not bit-exact with the plain version")
                    continue
                m_rel = ((m - m_p).abs() / (m_p.abs() + 1e-3)).max().item()
                s_rel = ((sc - sc_p).abs() / sc_p).max().item()
                log(line + f", mean max rel {m_rel:.2e}, scales max rel {s_rel:.2e}")
                require(m_rel <= 1e-5 and s_rel <= 1e-5 and frac <= 1e-4,
                        f"{tag} {kernel} {pv} smooth-v disagrees with the plain version")
                if dtype == torch.int8:
                    require((q_.int() - q_p.int()).abs().max().item() <= 1,
                            f"{tag} {kernel}: int8 codes more than a step apart")
                for key in keys:
                    r = results[key]
                    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), (m - m_p).abs().max().item())
        del v
    torch.cuda.empty_cache()


def check_hd256_attention(gen, results):
    """Kernel 1's D = 256 instances against the plain version: at the
    Gemma-7B prefill layer (4, 16/16, 4096, 256), causal, every V type with
    and without the smooth-v mean (query heads 0, 7 and 15 of each batch);
    d 192 padded to 256, ragged (1, 16/8, 3001, 192), causal, bf16 V, and
    ``sageattn`` there against exact fp32 attention; the masked instances
    at Gemma-2-9B's local layer (1, 16/8, 8192, 256, window 4096) and over
    varlen's four packed causal prompts at 256, each also as
    ``sageattn`` / ``sageattn_varlen`` against exact attention."""
    import torch
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda
    from sageattention_tpu_torch.ops.attention_cuda import Masks
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    out = {}
    cases = [
        # name, b, hq, hkv, s, d (the caller's), compared heads, V types
        ("gemma-7b layer", 4, 16, 16, 4096, 256, (0, 7, 15), None),
        ("d192 ragged", 1, 16, 8, 3001, 192, (0, 9, 15), ("bf16",)),
    ]
    for name, b, hq, hkv, s, d, hs, vtypes in cases:
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        qp, kp, vp = padded(q), padded(k), padded(v)
        k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(kp, group=128)
        fold = d**-0.5 * LOG2E
        kvs = [h // (hq // hkv) for h in hs]

        def kv_heads(x):
            return x[:, kvs].contiguous() if x is not None else None

        for vname, vx, vs, vm in v_operands(vp):
            if vtypes is not None and vname not in vtypes:
                continue
            o, l2 = attention_cuda.sage_attention_fwd(qp, k_i8, k_sc, vx, vs, vm,
                                                      is_causal=True, q_fold=fold,
                                                      return_lse=True)
            o_p, l2_p = attention_cuda.sage_attention_plain(
                qp[:, hs].contiguous(), kv_heads(k_i8), kv_heads(k_sc), kv_heads(vx),
                kv_heads(vs), kv_heads(vm), is_causal=True, q_fold=fold, return_lse=True)
            torch.cuda.synchronize()
            o_k, l2_k = o[:, hs].float(), l2[:, hs]
            cos = cosine_similarity(o_k.cpu(), o_p.float().cpu())
            err = (o_k - o_p.float()).abs().max().item()
            lerr = (l2_k - l2_p).abs().max().item()
            finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2).all())
            pad0 = bool((o[..., d:] == 0).all())
            log(f"hd256 attention {name} {(b, hq, hkv, s, d)} causal V {vname}: cos {cos:.6f}, "
                f"max abs {err:.3e}, lse2 max abs {lerr:.3e} (heads {hs}); finite {finite}; "
                f"pad lanes 0 {pad0}")
            require(finite and pad0, f"hd256 attention {name} V {vname}: non-finite or pad lanes")
            require(cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                    f"hd256 attention {name} V {vname} disagrees with its plain version")
            r = results["sage_attn_fwd_hd256"]
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if d == 192:
            out["d192 ragged vs exact"] = op_vs_exact("sageattn d192 ragged", q, k, v, True, {})
        del q, k, v, qp, kp, vp, k_i8, k_sc
        torch.cuda.empty_cache()

    hq, hkv, d = GEMMA2_LOCAL.values()
    hs = (0, 8, 15)
    b, s, w = 1, 8192, 4096
    q, k, v, k_i8, k_sc = layer_operands(gen, b, s, hq=hq, hkv=hkv, d=d)
    compare_masked(f"hd256 window {w} at {(b, hq, hkv, s, d)}", q, k_i8, k_sc, v,
                   Masks(window=w), True, hs, results, key="sage_attn_fwd_masked_hd256")
    del q, k, v, k_i8, k_sc
    s = sum(VARLEN_LENS)
    q, k, v, k_i8, k_sc = layer_operands(gen, 1, s, hq=hq, hkv=hkv, d=d)
    cu, _, masks = varlen_masks()
    compare_masked(f"hd256 varlen {VARLEN_LENS}", q, k_i8, k_sc, v, masks, True, hs, results,
                   key="sage_attn_fwd_masked_hd256")
    out["varlen vs exact"] = op_vs_exact("hd256 sageattn_varlen (per_segment, bf16 V)", q, k, v,
                                         True, dict(smooth_k_mode="per_segment",
                                                    pv_dtype="bf16"), varlen_cu=cu)
    del q, k, v, k_i8, k_sc
    b, s, w = 1, 3001, 1000  # exact fp32 scores of the 16 heads fit at this size
    q, k, v, _, _ = layer_operands(gen, b, s, hq=hq, hkv=hkv, d=d)
    out[f"window {w} at {s} vs exact"] = op_vs_exact(f"hd256 sageattn window {w} at {(b, s)}",
                                                     q, k, v, True, dict(window=w))
    del q, k, v
    torch.cuda.empty_cache()
    return out


def check_hd256_backward(gen, results) -> dict:
    """Kernels 7-8's D = 256 instances (dQ with its fragments read from
    shared memory, dK/dV in two passes) against their plain versions,
    every head: non-causal, causal and windowed (1024) at the layer
    trainer's (1, 16/16, 4096, 256) and at d 192 padded, GQA (1, 16/8,
    4096, 192); then ``sageattn``'s gradients at d 192, causal, against
    exact fp32 attention's."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    for (hq, hkv, d) in ((16, 16, 256), (16, 8, 192)):
        for causal, window in ((False, None), (True, None), (True, 1024)):
            ops, sm = backward_case(gen, 1, hq, hkv, 4096, 4096, d, causal, window=window)
            kw = dict(is_causal=causal, sm_scale=sm, window=window)
            got = (bwd.sage_attention_bwd_dq(*dq_args(ops), **kw),
                   *bwd.sage_attention_bwd_dkv(*dkv_args(ops), **kw))
            want = (bwd.sage_attention_bwd_dq_plain(*dq_args(ops), **kw),
                    *bwd.sage_attention_bwd_dkv_plain(*dkv_args(ops), **kw))
            torch.cuda.synchronize()
            for gname, g, gp, key in zip(("dq", "dk", "dv"), got, want,
                                         ("sage_attn_bwd_dq_hd256", "sage_attn_bwd_dkv_hd256",
                                          "sage_attn_bwd_dkv_hd256")):
                cos, rel, err = agreement(g, gp)
                finite = bool(torch.isfinite(g).all())
                pad0 = bool((g[..., d:] == 0).all())
                log(f"hd256 backward {(1, hq, hkv, 4096, d)} causal={causal} window={window} "
                    f"{gname}: cos {cos:.7f}, max abs / max|g| {rel:.3e}, finite {finite}, "
                    f"pad lanes 0 {pad0}")
                require(finite and pad0 and cos >= 0.9999 and rel <= 1e-2,
                        f"hd256 backward: {gname} kernel disagrees with its plain version")
                r = results[key]
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            del ops, got, want
            torch.cuda.empty_cache()
    b, hq, hkv, s, d = 1, 16, 8, 2048, 192
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    do = torch.randn(b, hq, s, d, generator=gen, device="cuda")
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    g_s = torch.autograd.grad((core.sageattn(*xs, is_causal=True).float() * do).sum(), xs)
    xr = [x.float().detach().requires_grad_() for x in (q, k, v)]
    g_r = torch.autograd.grad((reference.attention_reference(*xr, is_causal=True) * do).sum(), xr)
    coss = [cosine_similarity(a.float().cpu(), r.cpu()) for a, r in zip(g_s, g_r)]
    log(f"hd256 sageattn grads at d192 vs exact fp32 (GQA 16/8, causal, {s}): cos dq "
        f"{coss[0]:.6f} dk {coss[1]:.6f} dv {coss[2]:.6f}")
    require(min(coss) >= 0.999, "hd256: d192 gradients vs exact attention: cosine < 0.999")
    del xs, xr, g_s, g_r
    torch.cuda.empty_cache()
    return {"d192_grad_cos_vs_exact": coss}


def check_hd256_decode(gen, results):
    """Kernels 9-12's D = 256 instances against their plain versions at the
    Gemma-7B decode shapes (16/16 heads, so one row a kv head at t_q 1):
    int8 and int4, t_q 1 and 4, ragged lengths, window 4096, pages of 16
    and 1024 through scrambled tables, and d 192 (computed at 256, the
    cache read at its own head dim)."""
    import torch

    def lens(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    cases = [
        # name, hq, hkv, d, b, t_q, S, page, lengths, window, packed
        ("int8 t_q 1", 16, 16, 256, 4, 1, 8192, None, [0, 1, 4123, 8192], None, False),
        ("int4 t_q 1", 16, 16, 256, 4, 1, 8192, None, [0, 1, 4123, 8192], None, True),
        ("int8 t_q 4 gqa 16/8", 16, 8, 256, 4, 4, 8192, None, [4, 4103, 8192, 300], None, False),
        ("int8 window 4096", 16, 16, 256, 2, 1, 9216, None, [8200, 1], 4096, False),
        ("int4 window 4096 gqa 16/8", 16, 8, 256, 2, 1, 9216, None, [8200, 5000], 4096, True),
        ("page 1024 int8", 16, 16, 256, 4, 1, 8192, 1024, [0, 1, 4123, 8192], None, False),
        ("page 1024 int4", 16, 16, 256, 4, 1, 8192, 1024, [0, 1, 4123, 8192], None, True),
        ("page 16 int8 t_q 4", 16, 16, 256, 4, 4, 8192, 16, [4, 17, 4123, 8192], None, False),
        ("page 1024 int8 window 4096", 16, 8, 256, 2, 1, 9216, 1024, [8200, 3], 4096, False),
        ("page 16 int4 window 4096", 16, 16, 256, 2, 1, 9216, 16, [8200, 4100], 4096, True),
        ("d192 int8 t_q 1", 16, 8, 192, 2, 1, 4096, None, [4000, 37], None, False),
        ("d192 page 48 int4 window 100", 16, 8, 192, 2, 1, 960, 48, [901, 60], 100, True),
    ]
    for name, hq, hkv, d, b, t_q, S, page, ln, window, packed in cases:
        cache = random_cache(gen, (b, hkv), S, d, packed)
        q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)
        key, fn, plain = decode_case(gen, q, cache, lens(ln), page, window, return_state=True)
        compare_decode(f"hd256 {name} {tuple(ln)}", fn(), plain(), results, key + "_hd256")


def run_gemma(results, profile: bool) -> dict:
    """Phase 7b: the two Gemma-7B-geometry servers at full width and depth
    28 (fp32 weights, about 37 GB; ``GEMMA_7B``), b 4, a 4096-token prompt
    and 32 greedy decode steps over an 8192-token int8 cache: dense (kernel
    9 at D = 256) and paged through a scrambled table of 1024-token pages
    (kernel 11).  The prefill runs kernels 1-3 at 256 once a layer."""
    import torch
    from sageattention_tpu_torch import generate, models

    models.set_attention_backend("sage")
    cfg = models.MODEL_CONFIGS["llm-8b-gqa"].scaled(**GEMMA_7B)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    t0 = time.perf_counter()
    model = generate.load_llm(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    warm = torch.randint(0, cfg.vocab, (4, 1024), generator=gen, device="cuda")
    generate.generate(model, warm, 2, max_len=2048)
    torch.cuda.synchronize()
    log(f"gemma-7b geometry set-up + warm-up: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f} B parameters")
    servers = {}
    table = torch.randperm(4 * 8, generator=gen, device="cuda").reshape(4, 8).int()
    for path, cache, pt in (("llm_gemma7b_dense", "dense", None),
                            ("llm_gemma7b_paged", "paged", table)):
        t_phase = time.perf_counter()
        servers[path] = run_llm_server(results, model, profile, path=path, cache=cache, bits=8,
                                       page_table=pt, b=4, prompt=4096, steps=LLM_STEPS,
                                       max_len=8192)
        servers[path]["params_b"] = n_params / 1e9
        log(f"llm server phase {path}: {time.perf_counter() - t_phase:.1f} s")
    del model
    torch.cuda.empty_cache()
    return servers


def run_hd256_train(results) -> dict:
    """Phase 7c, the layer trainer at head dim 256, a kernel check and not
    a cell: bf16 q, k, v of one Gemma-7B attention layer (1, 16/16, 4096,
    256), causal, trained with AdamW towards exact attention of another
    seeded q, k, v (MSE).  Each step runs kernels 2-3, 1, 4, 7 and 8 at D =
    256 once and no other kernel; the first step's gradients are held at
    >= 0.999 against the autograd of fp32 exact attention; one warm-up
    step and 4 timed ones, whose loss must be finite and fall."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import reference

    b, s = 1, 4096
    hq, hkv, d = HD256_LAYER.values()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)

    def qkv():
        return [torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                for h in (hq, hkv, hkv)]

    q0, k0, v0 = qkv()
    with torch.no_grad():
        target = reference.attention_reference(*(x.float() for x in qkv()), is_causal=True)
    q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))

    def sage(q, k, v):
        o = core.sageattn(q, k, v, is_causal=True)
        require(type(o.grad_fn).__name__ == "SageAttnFunctionBackward",
                "hd256 trainer: sageattn did not take the fused route")
        return o

    def exact(q, k, v):
        return reference.attention_reference(q.float(), k.float(), v.float(), is_causal=True)

    grads = {name: torch.autograd.grad(F.mse_loss(attn(q, k, v).float(), target), [q, k, v])
             for name, attn in (("sage", sage), ("exact", exact))}
    first = {n: agreement(g, r)[0] for n, g, r in zip("qkv", grads["sage"], grads["exact"])}
    log(f"hd256 trainer first-step gradients vs fp32 exact attention: "
        f"{ {n: round(c, 6) for n, c in first.items()} }")
    require(min(first.values()) >= 0.999, "hd256 trainer: gradients disagree with exact")
    del grads

    opt = torch.optim.AdamW([q, k, v], lr=1e-2, weight_decay=0.0)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = F.mse_loss(sage(q, k, v).float(), target)
        loss.backward()
        opt.step()
        return loss

    losses = [step().item()]  # warm-up, not counted
    zero_counts()
    ms = []
    for _ in range(TRAIN_STEPS):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step()
        e.record()
        e.synchronize()
        ms.append(a.elapsed_time(e))
        losses.append(loss.item())
    launches = read_counts()
    log(f"hd256 trainer: losses {[round(x, 8) for x in losses]}; ms per step "
        f"{[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    for name, n in launches.items():
        want = TRAIN_STEPS if name in FORWARD_HD256 + BACKWARD_HD256 else 0
        require(n == want, f"hd256 trainer: {name} launched {n} times, want {want}")
        results[name]["launches_by_path"]["hd256_train"] = n
    require(all(map(math.isfinite, losses)), "hd256 trainer: a loss is not finite")
    require(losses[-1] < losses[0], "hd256 trainer: the loss did not fall")
    del q, k, v, target, opt
    torch.cuda.empty_cache()
    return {"shape": [b, hq, hkv, s, d], "causal": True, "losses": losses, "step_ms": ms,
            "median_step_ms": statistics.median(ms), "first_step_grad_cos_vs_exact": first}


def time_hd256(gen, results) -> dict:
    """Phase 7d: the D = 256 instances' times (CUDA events, median) beside
    their bounds, plain versions and, where one PyTorch call computes the
    same function, that call: kernels 2-3 and the forward (every V type;
    SDPA causal as the library) at the Gemma-7B prefill layer (4, 16/16,
    4096, 256), causal; kernel 4, dQ and dK/dV at the layer trainer's
    (1, 16/16, 4096, 256), causal (SDPA's backward, fwd + bwd - fwd, as the
    library of 7 + 8), and one layer's fwd + bwd against SDPA's; the masked
    forward at Gemma-2-9B's local layer (1, 16/8, 8192, 256, window 4096;
    SDPA with the band mask); kernels 5 and 6 at their check shapes;
    kernels 9-12 at the Gemma-7B servers' mid-decode step (b 4, 16/16,
    prompt + 16 tokens; window 4096 at b 2), L2 cold."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core, quant
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda, reference
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    out = {}
    hq, hkv, d = HD256_LAYER.values()

    def log_time(name, r, what):
        log(f"time {name} {what}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
            f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms")

    # kernels 2-3 and 1 at the prefill layer
    b, s = 4, 4096
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    km = quant_cuda.k_channel_mean(k)
    ng = -(-s // 128)
    r = results["k_channel_mean_hd256"]
    r.update(ms=cuda_ms(lambda: quant_cuda.k_channel_mean(k)),
             plain_ms=cuda_ms(lambda: quant_cuda.k_channel_mean_plain(k)),
             library_ms=cuda_ms(lambda: torch.mean(k, dim=-2, dtype=torch.float32)),
             bound_ms=(k.numel() * 2 + km.numel() * 4) / PEAK_BYTES_S * 1e3, bound_by="bytes")
    log_time("k_channel_mean_hd256", r, f"at {tuple(k.shape)}")
    r = results["quant_k_chunked_hd256"]
    r.update(ms=cuda_ms(lambda: quant_cuda.quant_k_chunked(k, km, group=128)),
             plain_ms=cuda_ms(lambda: quant_cuda.quant_k_chunked_plain(k, km, group=128)),
             library_ms=None, bound_by="bytes",
             bound_ms=(k.numel() * 3 + km.numel() * 4 + b * hkv * ng * 4) / PEAK_BYTES_S * 1e3)
    log_time("quant_k_chunked_hd256", r, f"at {tuple(k.shape)}")
    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    fold = d**-0.5 * LOG2E
    pairs = b * hq * s * (s + 1) // 2
    t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + 2 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
    r = results["sage_attn_fwd_hd256"]
    by_v = {}
    for pv in ("bf16", *quant.V_DTYPES):
        if pv == "bf16":
            vq, vs = v, None
        else:
            vq, vs, _ = quant_cuda.quant_v_per_channel(v, dtype=quant.V_DTYPES[pv])
        ms = cuda_ms(lambda vq=vq, vs=vs: attention_cuda.sage_attention_fwd(
            q, k_i8, k_sc, vq, vs, is_causal=True, q_fold=fold), reps=10)
        t_bytes = (q.numel() * 4 + k_i8.numel() + k_sc.numel() * 4
                   + vq.numel() * vq.element_size()) / PEAK_BYTES_S * 1e3
        by_v[pv] = {"ms": ms, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    r.update(ms=by_v["bf16"]["ms"], bound_ms=by_v["bf16"]["bound_ms"],
             bound_by=by_v["bf16"]["bound_by"], ms_by_v_type={n: x["ms"] for n, x in by_v.items()},
             plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_plain(
                 q, k_i8, k_sc, v, is_causal=True, q_fold=fold, return_lse=False),
                 reps=2, warmup=1),
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                                reps=10), pairs=pairs, d=d,
             shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": True})
    log_time("sage_attn_fwd_hd256", r, f"at {(b, hq, hkv, s, d)} causal, bf16 V (by V type "
             f"{ {n: round(x['ms'], 4) for n, x in by_v.items()} })")
    del q, k, v, km, k_i8, k_sc
    torch.cuda.empty_cache()

    # kernels 4, 7, 8 at the trainer's layer, and one layer's fwd + bwd
    b, s = 1, 4096
    ops, sm = backward_case(gen, b, hq, hkv, s, s, d, True)
    kw = dict(is_causal=True, sm_scale=sm)
    q = ops["q_bf"]
    r = results["quant_q_per_token_hd256"]
    r.update(ms=cuda_ms(lambda: quant_cuda.quant_q_per_token(q, scale_fold=sm * LOG2E)),
             plain_ms=cuda_ms(lambda: quant_cuda.quant_q_per_token_plain(q,
                                                                         scale_fold=sm * LOG2E)),
             library_ms=None, bound_ms=(q.numel() * 3 + b * hq * s * 4) / PEAK_BYTES_S * 1e3,
             bound_by="bytes")
    log_time("quant_q_per_token_hd256", r, f"at {tuple(q.shape)}")
    k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    xs = [x.clone().requires_grad_() for x in (q, k, ops["v"])]
    sdpa_f = cuda_ms(lambda: F.scaled_dot_product_attention(*xs, is_causal=True), reps=10)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*xs, is_causal=True), xs, ops["do"]), reps=10)
    sage_fb = cuda_ms(lambda: torch.autograd.grad(core.sageattn(*xs, is_causal=True), xs,
                                                  ops["do"]), reps=5)
    pairs = b * hq * s * (s + 1) // 2
    common_bytes = (ops["q_i8"].numel() + ops["k_i8"].numel() + ops["k_scale"].numel() * 4
                    + 3 * b * hq * s * 4 + ops["v"].numel() * 2 + ops["do"].numel() * 2)
    for name, n_bf16, extra_in, out_elems in (
            ("sage_attn_bwd_dq", 4, ops["k_sm"].numel() * 2, b * hq * s * d),
            ("sage_attn_bwd_dkv", 6, q.numel() * 2, 2 * b * hkv * s * d)):
        dq = name.endswith("dq")
        fn, plain = ((bwd.sage_attention_bwd_dq, bwd.sage_attention_bwd_dq_plain) if dq
                     else (bwd.sage_attention_bwd_dkv, bwd.sage_attention_bwd_dkv_plain))
        args = dq_args(ops) if dq else dkv_args(ops)
        t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + n_bf16 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
        t_bytes = (common_bytes + extra_in + out_elems * 4) / PEAK_BYTES_S * 1e3
        r = results[name + "_hd256"]
        r.update(ms=cuda_ms(lambda: fn(*args, **kw), reps=10),
                 plain_ms=cuda_ms(lambda: plain(*args, **kw), reps=2, warmup=1),
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 library_ms=sdpa_fb - sdpa_f, pairs=pairs, d=d, bf16_ops_per_pair=n_bf16 * d,
                 shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": True})
        log_time(name + "_hd256", r, f"at {(b, hq, hkv, s, d)} causal (library: SDPA's "
                 f"backward, 7 + 8 together)")
    out["layer"] = {"shape": [b, hq, hkv, s, d], "causal": True, "sage_fwd_bwd_ms": sage_fb,
                    "sdpa_fwd_bwd_ms": sdpa_fb, "sdpa_fwd_ms": sdpa_f,
                    "sdpa_bwd_ms": sdpa_fb - sdpa_f}
    log(f"one d256 layer's attention at {(b, hq, hkv, s, d)} causal: sage fwd+bwd "
        f"{sage_fb:.3f} ms, SDPA fwd+bwd {sdpa_fb:.3f} ms (fwd {sdpa_f:.3f}, bwd "
        f"{sdpa_fb - sdpa_f:.3f})")
    del ops, xs, q, k
    torch.cuda.empty_cache()

    # the masked forward at Gemma-2-9B's local layer
    hq2, hkv2, _ = GEMMA2_LOCAL.values()
    b, s, w = 1, 8192, 4096
    q, k, v, k_i8, k_sc = layer_operands(gen, b, s, hq=hq2, hkv=hkv2, d=d)
    masks = Masks(window=w)
    pairs = live_pairs(masks, b, s, s, True, hq2)
    bound, by = masked_bound(pairs, d, q.numel() * 4 + k_i8.numel() + k_sc.numel() * 4
                             + v.numel() * 2)
    band = reference._build_mask(s, s, is_causal=True, device="cuda", window=w)
    kr, vr = (x.repeat_interleave(hq2 // hkv2, dim=1) for x in (k, v))
    r = results["sage_attn_fwd_masked_hd256"]
    r.update(ms=cuda_ms(lambda: attention_cuda.sage_attention_fwd_masked(
                 q, k_i8, k_sc, v, masks=masks, is_causal=True, q_fold=fold), reps=10),
             plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_plain(
                 q, k_i8, k_sc, v, is_causal=True, q_fold=fold, return_lse=False,
                 masks=masks), reps=2, warmup=1),
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                                       attn_mask=band), reps=5),
             bound_ms=bound, bound_by=by,
             shape={"b": b, "hq": hq2, "hkv": hkv2, "s": s, "d": d, "window": w,
                    "live_pairs_per_head": pairs // (b * hq2)})
    log_time("sage_attn_fwd_masked_hd256", r, f"window {w} at {(b, hq2, hkv2, s, d)} (library: "
             f"SDPA with the band mask)")
    del q, k, v, k_i8, k_sc, band, kr, vr
    torch.cuda.empty_cache()

    # kernels 5 and 6
    for shape, names in (((1, 16, 4096, 256), ("quant_v_per_channel",)),
                         ((1, 8, 16384, 256), ("v_channel_stats", "quant_v_apply"))):
        v = random_v(gen, shape)
        moved = v.numel() * 2 + v.numel() + shape[0] * shape[1] * shape[3] * 4
        if len(names) == 1:
            r = results[names[0] + "_hd256"]
            r.update(ms=cuda_ms(lambda: quant_cuda.quant_v_per_channel(v, dtype=torch.int8)),
                     plain_ms=cuda_ms(lambda: quant_cuda.quant_v_per_channel_plain(
                         v, dtype=torch.int8, smooth=False)),
                     library_ms=None, bound_ms=moved / PEAK_BYTES_S * 1e3, bound_by="bytes")
            log_time(names[0] + "_hd256", r, f"int8 at {shape}")
            continue
        gmax, gmin, mean = quant_cuda.v_channel_stats(v, smooth=False)
        _, rr = quant_cuda.v_scale_from_stats(gmax, gmin, mean, torch.int8)
        stats_bytes = v.numel() * 2 + 3 * shape[0] * shape[1] * shape[3] * 4
        for name, fn, plain, moved_ in (
                ("v_channel_stats", lambda: quant_cuda.v_channel_stats(v, smooth=False),
                 lambda: quant_cuda.v_channel_stats_plain(v, smooth=False), stats_bytes),
                ("quant_v_apply", lambda: quant_cuda.quant_v_apply(v, rr, None, dtype=torch.int8),
                 lambda: quant_cuda.quant_v_apply_plain(v, rr, None, dtype=torch.int8), moved)):
            r = results[name + "_hd256"]
            r.update(ms=cuda_ms(fn), plain_ms=cuda_ms(plain), library_ms=None,
                     bound_ms=moved_ / PEAK_BYTES_S * 1e3, bound_by="bytes")
            log_time(name + "_hd256", r, f"int8 at {shape}")
        del v
    torch.cuda.empty_cache()

    # kernels 9-12 at the servers' mid-decode step
    cells = [
        # kernel, b, hkv, S, page, length, window
        ("sage_decode", 4, 16, 8192, None, 4096 + 16, None),
        ("sage_paged_decode", 4, 16, 8192, 1024, 4096 + 16, None),
        ("sage_decode_window", 2, 16, 9216, None, 8192 + 16, 4096),
        ("sage_paged_decode_window", 2, 16, 9216, 1024, 8192 + 16, 4096),
    ]
    for name, b, hkv_, S, page, length, window in cells:
        for packed in (False, True):
            cache = random_cache(gen, (b, hkv_), S, d, packed)
            q = torch.randn(b, hq, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
            L = torch.full((b,), length, dtype=torch.int32, device="cuda")
            _, fn, plain = decode_case(gen, q, cache, L, page, window)
            ms = cuda_ms(fn, reps=20, cold=True)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            bound, by = decode_bound([length] * b, hq, hkv_, 1, d, packed, window)
            log(f"time {name}_hd256 {'int4' if packed else 'int8'} at b {b}, {hq}/{hkv_} heads "
                f"of {d}, length {length}, S {S}{'' if page is None else f', page {page}'}: "
                f"{ms:.4f} ms (bound {bound:.4f} ms, {by}), plain {plain_ms:.4f} ms")
            r = results[name + "_hd256"]
            if not packed:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
                         shape={"b": b, "hq": hq, "hkv": hkv_, "t_q": 1, "d": d, "S": S,
                                "length": length, "page": page, "window": window})
            else:
                r["int4"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    return out


def check_hd256_preq(results) -> dict:
    """Phase 7a, the pre-quantized forward's D = 256 instances
    (``attention_fwd_preq_hd256.cu``) against their plain version, every
    Q/K option (QOPTS) with bf16 and e4m3 V, through :func:`compare_preq`
    (o cosine >= 0.9999, max-abs <= 2e-2, lse2 <= 1e-3): at the Gemma-7B
    prefill layer (4, 16/16, 4096, 256), causal; at d 192 (padded) ragged
    (1, 16/8, 3001), causal; masked, at Gemma-2-9B's local layer (1, 16/8,
    8192, 256, window 4096) and over varlen's four packed prompts.  Then
    each option as ``sageattn`` against exact fp32 attention at d 192
    ragged and with window 1000 at (1, 16/8, 3001, 256), at the floors the
    options have at 64 and 128: 0.999 for 8 bits, 0.97 for int4.  Inputs
    from a generator of its own."""
    import torch
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    key = "sage_attn_fwd_preq_hd256"

    def operands(b, hq, hkv, s, d):
        q, _, _ = biased_qk(gen, (b, hq, s, d))
        _, k, v = biased_qk(gen, (b, hkv, s, d))
        return q, k, v

    cases = [("gemma-7b layer", (4, 16, 16, 4096, 256), True, (0, 7, 15), None),
             ("d192 ragged", (1, 16, 8, 3001, 192), True, (0, 9, 15), None),
             ("gemma-2-9b local layer, window 4096", (1, 16, 8, 8192, 256), True, (0, 8, 15),
              Masks(window=4096)),
             (f"varlen {VARLEN_LENS}", (1, 16, 8, sum(VARLEN_LENS), 256), True, (0, 8, 15),
              varlen_masks()[2])]
    for name, shape, causal, hs, masks in cases:
        q, k, v = operands(*shape)
        for opts in QOPTS.values():
            compare_preq(f"hd256 {name}", q, k, padded(v), opts, causal, hs, results,
                         masks=masks, key=key)
        del q, k, v
        torch.cuda.empty_cache()
    out = {}
    for name, d, kw in (("d192 ragged", 192, {}), ("window 1000", 256, {"window": 1000})):
        q = torch.randn(1, 16, 3001, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(1, 8, 3001, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        for oname, opts in QOPTS.items():
            floor = SWEEP_FLOOR[opts.get("qk_bits", 8)]
            out[f"{name} {oname} vs exact"] = op_vs_exact(
                f"hd256 sageattn {name} {oname} at {(1, 16, 8, 3001, d)}", q, k, v, True,
                {**kw, **opts}, floor=floor)
        del q, k, v
    torch.cuda.empty_cache()
    return out


def time_hd256_preq(results) -> dict:
    """Phase 7d, the pre-quantized D = 256 instances' times at the Gemma-7B
    prefill layer (4, 16/16, 4096, 256), causal, bf16 V, every option,
    beside the default D = 256 forward on the same layer, SDPA and the
    bound of the default forward (the same operations); the plain
    version of one option."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    b, s = 4, 4096
    hq, hkv, d = HD256_LAYER.values()
    q, _, _ = biased_qk(gen, (b, hq, s, d))
    _, k, v = biased_qk(gen, (b, hkv, s, d))
    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    default_ms = cuda_ms(lambda: attention_cuda.sage_attention_fwd(
        q, k_i8, k_sc, v, is_causal=True, q_fold=d**-0.5 * LOG2E), reps=10)
    pairs = b * hq * s * (s + 1) // 2
    t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + 2 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
    by_opt = {}
    for oname, opts in QOPTS.items():
        q_i8, q_sc, k_q, k_qs, cb = preq_operands(q, k, opts)
        by_opt[oname] = cuda_ms(lambda: attention_cuda.sage_attention_fwd_preq(
            q_i8, q_sc, k_q, k_qs, v, is_causal=True, col_bias=cb), reps=10)
        t_bytes = (q_i8.numel() + q_sc.numel() * 4 + k_q.numel() + k_qs.numel() * 4
                   + v.numel() * 2 + q.numel() * 2) / PEAK_BYTES_S * 1e3
        if oname == "int4+smooth_q":  # SageAttention2's setting carries the entry
            plain_ms = cuda_ms(lambda: attention_cuda.sage_attention_preq_plain(
                q_i8, q_sc, k_q, k_qs, v, is_causal=True, return_lse=False, col_bias=cb),
                reps=2, warmup=1)
            entry = dict(bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
        del q_i8, q_sc, k_q, k_qs, cb
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps=10)
    r = results["sage_attn_fwd_preq_hd256"]
    r.update(ms=by_opt["int4+smooth_q"], plain_ms=plain_ms, library_ms=sdpa, **entry,
             ms_by_option=by_opt, default_forward_ms=default_ms, pairs=pairs, d=d,
             shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": True,
                    "option": "int4+smooth_q"})
    log(f"time sage_attn_fwd_preq_hd256 at {(b, hq, hkv, s, d)} causal, bf16 V, by option "
        f"{ {n: round(x, 4) for n, x in by_opt.items()} } ms; the default forward "
        f"{default_ms:.4f} ms, SDPA {sdpa:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}), plain (int4+smooth_q) {plain_ms:.4f} ms")
    del q, k, v, k_i8, k_sc
    torch.cuda.empty_cache()
    return {"shape": [b, hq, hkv, s, d], "ms_by_option": by_opt, "default_forward_ms": default_ms,
            "sdpa_ms": sdpa}


# --------------------------------------------------------------------------
# phase 9: kernel 13, the rate probe
# --------------------------------------------------------------------------

# the probe row that carries kernel 13's entry of the kernels line: the
# instruction the port's attention kernels issue, at the d128 contraction
PROBE_ENTRY_ROW = "qk s8 d128 mma.sync"
PROBE_ENTRY_REPS = 256


def run_probe(results) -> dict:
    """Phase 9: ``utils/probe_mma.run``, the port of tools/probe_mxu.py.
    Every probe row's kernel against its plain chain at 5 reps over the
    rate's grid (int32 bit-exact, fp32 within 1e-3), its SASS's
    tensor-core instructions counted against a rep's (``cuobjdump
    -sass``), its rate at full occupancy from the slope between two rep
    counts beside its peak (above 105 % fails), then the library rows; the
    card's name, power limit and SM clock before and after.  The counts
    are zeroed after the checks, just before the rates, and read just
    after: only the probe launches.  Kernel 13's entry carries
    PROBE_ENTRY_ROW at the rates' grid and PROBE_ENTRY_REPS reps: its
    output against the plain chain's on the same inputs (int32, bit for
    bit), the kernel's time, the plain chain's, and the operations bound
    (no one PyTorch call computes the perturbed chain)."""
    import torch
    from sageattention_tpu_torch.utils import probe_mma

    table = probe_mma.run(log=log, before_rates=zero_counts)
    launches = read_counts()
    log(f"probe launches: { {n: c for n, c in launches.items() if c} }")
    for name, n in launches.items():
        want = n if name == "probe_mma" else 0
        require(n == want and (name != "probe_mma" or n > 0),
                f"probe: {name} launched {n} times")
        results[name].setdefault("launches_by_path", {})["probe"] = n
    row = next(r for r in probe_mma.ROWS if r.name == PROBE_ENTRY_ROW)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m = probe_mma.grid_rows(row, sms)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    x, y = probe_mma.inputs(row, m, gen)
    reps = PROBE_ENTRY_REPS
    got = probe_mma.chain(row, x, y, reps)
    want = probe_mma.plain_chain(x, y, reps)
    err = (got.long() - want.long()).abs().max().item()
    log(f"probe_mma ({row.name}, {m} rows, {reps} reps) vs its plain chain: max-abs {err}, "
        f"{(got != want).sum().item()} of {got.numel()} int32 results differ")
    require(got.dtype == want.dtype == torch.int32 and torch.equal(got, want),
            "probe_mma: the kernel's chain differs from the plain chain at the entry's inputs")
    del got, want
    ops = probe_mma.ops_per_rep(row, m) * reps
    moved = x.numel() + y.numel() + m * row.n * 4
    t_ops, t_bytes = ops / PEAK_INT8_OPS_S * 1e3, moved / PEAK_BYTES_S * 1e3
    r = results["probe_mma"]
    r.update(ms=cuda_ms(lambda: probe_mma.chain(row, x, y, reps), reps=5),
             plain_ms=cuda_ms(lambda: probe_mma.plain_chain(x, y, reps), reps=1, warmup=1),
             bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
             library_ms=None, max_abs_err=float(err),
             shape={"row": row.name, "m": m, "n": row.n, "k": row.k, "reps": reps},
             rates={t["row"]: {"rate": t["rate"], "unit": t["unit"],
                               "share_of_peak": t["share_of_peak"]} for t in table["rows"]})
    log(f"time probe_mma ({row.name}, {m} rows, {reps} reps): {r['ms']:.4f} ms (bound "
        f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain chain {r['plain_ms']:.4f} ms")
    del x, y
    torch.cuda.empty_cache()
    return table


# --------------------------------------------------------------------------
# phase 8: the parallel slice: kernels 11-12 with the owned page mask,
# sharded serving, the KV ring (a world of four run rank after rank on the
# card), and the parallel entry points in a world of one over NCCL
# --------------------------------------------------------------------------

SP = 4  # the sequence-parallel degree whose ranks the card runs one after another
SHARD_CTX = 131072  # Llama-3.1-8B's context length
SHARD_STEPS = 32
SHARD_PAGE = 1024
SHARD_LAYER = dict(hq=32, hkv=8, d=128)  # llm-8b-gqa's attention (Llama-3-8B widths)
# the ring's two layers: (name, b, hq, hkv, s, d, causal, steps that run
# kernels 1-3: 16 of 16 non-causal; 4 aligned + 6 full, 6 skipped causal)
RING_LAYERS = (("cogvideox-2b layer", 1, 30, 30, 17776, 64, False, 16),
               ("llm-8b-gqa prefill layer", 1, 32, 8, 32768, 128, True, 10))
# the owned launches are counted apart, inside kernels 11-12's entries
OWNED = ("sage_paged_decode", "sage_paged_decode_window")


def owned_bound(table, lengths, owned, page, hkv, hq, t_q, d, packed, window=None):
    """(bound_ms, bound_by) of one shard's launch: the live tokens of the
    pages it owns, read once (codes and two fp32 scales), Q in and O out."""
    code = d // 2 if packed else d
    tokens = 0
    for bi, length in enumerate(lengths):
        lo = 0 if window is None else max(length - t_q - window + 1, 0)
        for j, own in enumerate(owned[bi]):
            if own:
                tokens += max(min(length, (j + 1) * page) - max(j * page, lo), 0)
    moved = tokens * hkv * (2 * code + 8) + 2 * len(lengths) * hq * t_q * d * 2
    return moved / PEAK_BYTES_S * 1e3, "bytes"


def shard_pool(pool, s: int, n: int):
    """Pages [s*pp, (s+1)*pp) of a pool, each a tensor of its own."""
    pp = pool[0].shape[0] // n
    return [x[s * pp:(s + 1) * pp].contiguous() for x in pool]


def check_owned(gen, results) -> dict:
    """Kernels 11-12 with ``owned`` on each of 4 shards of a scrambled pool of
    16 pages of 1024 (b 2, lengths 8189 and 1000), against their plain
    versions (the decode limits), at d 64 (8/2 heads), 128 (32/8) and 256
    (16/16), int8 and int4, t_q 1 and 4, with and without window 4096; the
    four shards merged (fp32 partials) against the kernel on the whole pool,
    max-abs <= 1e-4 (the JAX tests' tolerance for the merge's fp32 sums);
    and a shard that owns no live page of batch 1 giving exactly 0, l = 0
    and m = NEG_INIT there."""
    import torch
    from sageattention_tpu_torch.ops import decode_cuda as dc
    from sageattention_tpu_torch.parallel.decode import owned_pages

    b, S, page, L = 2, 8192, 1024, [8189, 1000]
    lens = torch.tensor(L, dtype=torch.int32, device="cuda")
    merged_err, empty_rows = 0.0, 0
    for d, hq, hkv in ((64, 8, 2), (128, 32, 8), (256, 16, 16)):
        for packed, t_q, window in itertools.product((False, True), (1, 4), (None, 4096)):
            name = (f"d{d} {hq}/{hkv} {'int4' if packed else 'int8'} t_q {t_q}"
                    f"{'' if window is None else f' window {window}'}")
            pool, table = paged_from_dense(gen, random_cache(gen, (b, hkv), S, d, packed), page)
            q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)
            kw = dict(window=window, return_state=True, out_dtype=torch.float32)
            whole = dc.sage_paged_decode_attention(q, *pool, table, lens, **kw)
            key = ("sage_paged_decode" if window is None else "sage_paged_decode_window") + "_owned"
            parts = []
            for s in range(SP):
                owned, local = owned_pages(table, s, pool[0].shape[0] // SP)
                shard = shard_pool(pool, s, SP)
                res = dc.sage_paged_decode_attention(q, *shard, local, lens, owned=owned, **kw)
                res_p = dc.sage_paged_decode_attention_plain(q, *shard, local, lens, owned=owned,
                                                             **kw)
                compare_decode(f"owned {name} shard {s}", res, res_p, results, key)
                if not bool(owned[1, 0]):  # batch 1's one live page lies elsewhere
                    o, m, l = res
                    require(bool((o[1] == 0).all() and (l[1] == 0).all()
                                 and (m[1] == dc.NEG_INIT).all()),
                            f"owned {name} shard {s}: a row with no owned live page is not 0")
                    empty_rows += 1
                parts.append(res)
            o_m = dc.merge_decode_partials(*(torch.stack(x) for x in zip(*parts)))
            err = (o_m - whole[0]).abs().max().item()
            merged_err = max(merged_err, err)
            log(f"owned {name}: 4 shards merged vs the whole pool, max abs {err:.3e}")
            require(err <= 1e-4, f"owned {name}: the merged shards disagree with the whole pool")
    log(f"owned: {empty_rows} shards without a live page of batch 1 gave exactly 0")
    require(empty_rows > 0, "owned: no shard without a live page was checked")
    return {"merged_vs_whole_max_abs": merged_err, "empty_shards_checked": empty_rows}


def serving_inputs(layer: int, step: int, shapes):
    from sageattention_tpu_torch import generate

    return generate.serving_draw(9, layer, step, shapes, "cuda")


def sharded_launch_check(phase: str, want: dict) -> dict:
    launches = read_counts()
    log(f"{phase} launches: { {n: c for n, c in launches.items() if c} }")
    for name, n in launches.items():
        require(n == want.get(name, 0),
                f"{phase}: {name} launched {n} times, want {want.get(name, 0)}")
    return launches


def serve_sharded(phase: str, tp: int, sp: int, paged: bool, want) -> tuple:
    """``generate.serve_shards`` at the sharded geometry (llm-8b-gqa's
    attention, b 1 x 131,072 tokens, 32 layers of int8 caches, 32 steps),
    the TP ``tp`` x SP ``sp`` shards' local bodies in turn (each kernel
    launch counted against ``want(launches a step)``), then the same loop
    over one unsharded cache: the shards' caches bit-identical to its
    slices, the merged fp32 outputs within 1e-4 of its decode's (a dense
    decode at the shards' chunk).  Returns (the sharded run, the unsharded
    run, the launches, a summary)."""
    import dataclasses

    import torch
    from sageattention_tpu_torch import generate
    from sageattention_tpu_torch.parallel.decode import dense_shard, paged_shard

    kw = dict(b=1, **SHARD_LAYER, context=SHARD_CTX, gen=SHARD_STEPS, depth=LLM_DEPTH,
              paged=paged, page_size=SHARD_PAGE, seed=9, device="cuda")
    shards = [generate.local_shard_ops(head=t, seq=s, n_seq=sp, paged=paged)
              for t in range(tp) for s in range(sp)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    r = generate.serve_shards(shards, tp=tp, sp=sp, **kw)
    launches = sharded_launch_check(phase, want(LLM_DEPTH * SHARD_STEPS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    w = generate.serve_shards([generate.local_shard_ops(n_seq=sp, paged=paged, sharded=False)],
                              **kw)
    worst = max((o.float() - o_w.float()).abs().max().item()
                for os_, ows in zip(r["outputs"], w["outputs"]) for o, o_w in zip(os_, ows))
    cut = paged_shard if paged else dense_shard
    same = all(torch.equal(x, getattr(want_c, f))
               for sh, layers in zip(shards, r["caches"])
               for c, whole in zip(layers, w["caches"][0])
               for want_c in [cut(whole, shard=sh.seq, n_shards=sp, head_shard=sh.head,
                                  n_head_shards=tp)]
               for f, x in dataclasses.asdict(c).items())
    med, med_w = statistics.median(r["step_ms"]), statistics.median(w["step_ms"])
    log(f"{phase}: TP {tp} x SP {sp}, prompt prefilled in {r['prefill_ms']:.1f} ms; ms a step "
        f"(the {tp * sp} shards in turn) {[round(x, 3) for x in r['step_ms']]}, median "
        f"{med:.3f}; unsharded {med_w:.3f}; merged vs unsharded max abs {worst:.3e}; caches "
        f"bit-identical {same}; peak {peak:.2f} GB")
    require(same, f"{phase}: the shards' caches differ from the unsharded cache")
    require(worst <= 1e-4, f"{phase}: the merged decode disagrees with the unsharded one")
    summary = {"tp": tp, "sp": sp, "depth": LLM_DEPTH, "context": SHARD_CTX,
               "prompt": int(r["lengths"][0]) - SHARD_STEPS, "prefill_ms": r["prefill_ms"],
               "step_ms": r["step_ms"], "median_step_ms": med, "unsharded_median_step_ms": med_w,
               "merged_max_abs": worst, "peak_gb": peak,
               "launches": {n: c for n, c in launches.items() if c}}
    return r, w, launches, summary


def run_sharded_paged(results) -> dict:
    """``sharded_paged``: the serving loop over a paged pool of 1024-token
    pages (a scrambled table) split into 4 shards of pages: each step each
    shard's ``paged_append(pool_start)`` and ``local_paged_shard_decode``
    (kernel 11 with ``owned``), merged (``serve_sharded``).  Then kernel 11
    (12 with window 4096) with ``owned`` on each shard at the last step's
    inputs, held against its plain version, and timed (L2 cold) beside the
    whole pool's launch."""
    import torch
    from sageattention_tpu_torch.ops import decode_cuda as dc
    from sageattention_tpu_torch.parallel.decode import owned_pages

    hq, hkv, d = SHARD_LAYER["hq"], SHARD_LAYER["hkv"], SHARD_LAYER["d"]
    r, w, launches, out = serve_sharded(
        "sharded_paged", 1, SP, True,
        lambda n: {"sage_paged_decode": SP * n, "sage_paged_decode_owned": SP * n})
    for name in ("sage_paged_decode", "sage_paged_decode_owned"):
        results[name].setdefault("launches_by_path", {})["sharded_paged"] = launches[name]
    table, glen = r["table"], r["lengths"]
    pp = table.numel() // SP
    q = serving_inputs(0, SHARD_STEPS, [(1, hq, 1, d)])[0]
    L = glen.tolist()
    times = {}
    for window, name in ((None, "sage_paged_decode"), (4096, "sage_paged_decode_window")):
        c = w["caches"][0][0]
        whole_ms = cuda_ms(lambda: dc.sage_paged_decode_attention(
            q, c.pages_k, c.pages_k_scale, c.pages_v, c.pages_v_scale, table, glen,
            window=window), reps=20, cold=True)
        shard_ms, bounds, plain = [], [], []
        for s in range(SP):
            owned, local = owned_pages(table, s, pp)
            args = (q, *(getattr(r["caches"][s][0], f) for f in
                         ("pages_k", "pages_k_scale", "pages_v", "pages_v_scale")), local, glen)
            kw = dict(owned=owned, window=window, return_state=True, out_dtype=torch.float32)
            compare_decode(f"owned sharded_paged window {window} shard {s}",
                           dc.sage_paged_decode_attention(*args, **kw),
                           dc.sage_paged_decode_attention_plain(*args, **kw), results,
                           name + "_owned")
            shard_ms.append(cuda_ms(lambda: dc.sage_paged_decode_attention(*args, **kw), reps=20,
                                    cold=True))
            if s == 0 and window is None:
                plan = dc.paged_split_plan(q.shape, hkv, SHARD_PAGE, local.shape[1])
                ops = DECODE_OPS.get("sage_paged_decode_owned")
            bounds.append(owned_bound(table.tolist(), L, owned.tolist(), SHARD_PAGE, hkv, hq, 1,
                                      d, False, window)[0])
            plain.append(cuda_ms(lambda: dc.sage_paged_decode_attention_plain(*args, **kw),
                                 reps=3, warmup=1))
        wb, _ = decode_bound(L, hq, hkv, 1, d, False, window)
        log(f"time {name} owned at b 1, 32/8, length {L[0]}, window {window}: shards "
            f"{[round(x, 4) for x in shard_ms]} ms (bounds {[round(x, 4) for x in bounds]}, "
            f"bytes; plain {[round(x, 3) for x in plain]}), the whole pool {whole_ms:.4f} ms "
            f"(bound {wb:.4f})"
            + ("" if window is not None else
               f"; a shard's (cl, splits) {plan}, {ops} CUDA launches a call (counted in "
               f"phase 2)"))
        res = results[name + "_owned"]
        res.update(ms=statistics.median(shard_ms), plain_ms=statistics.median(plain),
                   bound_ms=statistics.median(bounds), bound_by="bytes", library_ms=None,
                   shard_ms=shard_ms, shard_bound_ms=bounds, whole_pool_ms=whole_ms,
                   whole_pool_bound_ms=wb,
                   **({} if window is not None else {"plan": list(plan),
                                                     "device_ops_a_call": ops}),
                   shape={"b": 1, "hq": hq, "hkv": hkv, "d": d, "pages": table.numel(),
                          "page": SHARD_PAGE, "shards": SP, "length": L[0], "window": window})
        times[name] = {"shard_ms": shard_ms, "whole_pool_ms": whole_ms}
    del r, w
    torch.cuda.empty_cache()
    return {**out, "shards": SP, "pages_per_shard": pp, "kernel_times": times}


def run_sharded_dense(results) -> dict:
    """``sharded_dense``: the serving loop over dense caches split TP 2 (4 kv
    heads a shard) x SP 2 (65,536 tokens a shard): each step each shard's
    ``local_shard_append`` and ``local_shard_decode`` (kernel 9), merged
    over SP and joined over TP (``serve_sharded``).  Then kernel 9 on each
    shard and on the unsharded cache, timed L2 cold."""
    import torch
    from sageattention_tpu_torch.ops import decode_cuda as dc

    hq, hkv, d = SHARD_LAYER["hq"], SHARD_LAYER["hkv"], SHARD_LAYER["d"]
    tp, sp = 2, 2
    s_local = SHARD_CTX // sp
    r, w, launches, out = serve_sharded("sharded_dense", tp, sp, False,
                                        lambda n: {"sage_decode": tp * sp * n})
    results["sage_decode"].setdefault("launches_by_path", {})["sharded_dense"] = \
        launches["sage_decode"]
    glen = r["lengths"]
    chunk = dc.dense_plan(s_local, hq // hkv, 1, 4096, None)[0]
    qh = [slice(t * hq // tp, (t + 1) * hq // tp) for t in range(tp)]
    q = serving_inputs(0, SHARD_STEPS, [(1, hq, 1, d)])[0]

    def kernel(q, c, length):
        return lambda: dc.sage_decode_attention(q, c.k_i8, c.k_scale, c.v_i8, c.v_scale, length,
                                                chunk=chunk, return_state=True)

    shard_ms = [cuda_ms(kernel(q[:, qh[t]], r["caches"][t * sp + s][0], glen - s * s_local),
                        reps=20, cold=True) for t in range(tp) for s in range(sp)]
    whole_ms = cuda_ms(kernel(q, w["caches"][0][0], glen), reps=20, cold=True)
    bound, _ = decode_bound([s_local], hq // tp, hkv // tp, 1, d, False, None)
    plan = dc.dense_split_plan((1, hq // tp, 1, d), hkv // tp, s_local, chunk)
    ops = DECODE_OPS.get("sage_decode_state")
    log(f"time sage_decode at a dense shard (b 1, 16/4 heads, {s_local} tokens): "
        f"{[round(x, 4) for x in shard_ms]} ms (bound {bound:.4f}, bytes; (cl, splits) {plan}, "
        f"{ops} CUDA launches a call, counted in phase 2); the unsharded cache (32/8, "
        f"{int(glen)} tokens) "
        f"{whole_ms:.4f} ms")
    del r, w
    torch.cuda.empty_cache()
    return {**out, "shard_kernel_ms": shard_ms, "shard_bound_ms": bound,
            "unsharded_kernel_ms": whole_ms, "shard_plan": list(plan),
            "shard_device_ops_a_call": ops}


def world_blocks(k, v, idx: int, n: int = SP):
    """Rank ``idx``'s (src, K block, V block) of a world of ``n`` in the order
    the ring hands them to it."""
    sl = k.shape[2] // n
    return [(src, k[:, :, src * sl:(src + 1) * sl], v[:, :, src * sl:(src + 1) * sl])
            for src in ((idx - step) % n for step in range(n))]


def step_kind(src: int, idx: int, causal: bool, ran: bool) -> str:
    """A ring step's kind, as the launch counts expect them."""
    return "skipped" if not ran else "aligned" if causal and src == idx else "full"


def ring_world(q, k, v, causal: bool, n: int = SP):
    """A world of ``n``'s ring run on one card, rank after rank and step after
    step (``ring.ring_partials``, the ring's own forward): the global (o,
    LSE) and the kinds of steps taken."""
    import torch
    from sageattention_tpu_torch.parallel import ring

    sl = q.shape[2] // n
    outs, lses, kinds = [], [], {"full": 0, "aligned": 0, "skipped": 0}
    for idx in range(n):
        blocks = world_blocks(k, v, idx, n)
        o_acc, lse_acc, steps = ring.ring_partials(q[:, :, idx * sl:(idx + 1) * sl], blocks,
                                                   idx=idx, is_causal=causal)
        for (src, _, _), step in zip(blocks, steps):
            kinds[step_kind(src, idx, causal, step is not None)] += 1
        o, lse = ring.finish(o_acc, lse_acc, q.dtype, True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2), kinds


def run_ring(results) -> dict:
    """``ring``: a world of 4's KV ring, its ranks and steps one after another
    on the card, at the CogVideoX-2B layer (non-causal: 16 steps, each
    kernels 2, 3 and 1 once) and the llm-8b-gqa prefill layer (1, 32/8,
    32768, 128, causal: 4 aligned and 6 full steps, 6 skipped).  Held
    against exact attention (>= 0.999, and no more than 1e-4 below the
    cosine of ``sageattn`` of the whole sequence against it: the ring loses
    no accuracy the whole op keeps) and against that whole op (>= 0.9999:
    the two quantize the same attention independently, each block's K with
    its own mean and scales, so they differ by about as much as either
    differs from exact attention); its LSE against the whole op's within
    0.1: the
    blocks' K are quantized with their own means and scales, which moves a
    score by a few hundredths where a causal row sees few keys, while an
    LSE placed at another row or block is off by the log of a ratio of key
    counts, O(1).  The same two ops through the plain versions on q heads
    0-1 (on the host), the kernels' held to them at the kernel limit
    (cosine >= 0.9999; ``tests/test_torch_ring_witness.py`` reads the JAX
    ring's gap on the CPU).  Timed against the one ``sageattn``."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    out = {}
    for name, b, hq, hkv, s, d, causal, steps in RING_LAYERS:
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        zero_counts()
        o, lse, kinds = ring_world(q, k, v, causal)
        torch.cuda.synchronize()
        launches = sharded_launch_check(f"ring {name}", {n: steps for n in FORWARD})
        for n in FORWARD:
            results[n].setdefault("launches_by_path", {})[f"ring {name}"] = launches[n]
        o_w, lse_w = core.sageattn(q, k, v, is_causal=causal, return_lse=True)
        ex = reference.attention_reference(q, k, v, is_causal=causal)
        of, exf = o.float().cpu(), ex.float().cpu()
        cos_w = cosine_similarity(of, o_w.float().cpu())
        cos_x = cosine_similarity(of, exf)
        cos_wx = cosine_similarity(o_w.float().cpu(), exf)
        lse_diff = (lse - lse_w).abs()
        lse_err, lse_mean = lse_diff.max().item(), lse_diff.mean().item()
        # the same two ops through the plain versions (CPU tensors) on q heads 0-1:
        # the kernels' ring and whole op against them (the kernel limit, 0.9999),
        # and how far the quantized arithmetic itself puts the ring from the whole op
        h2 = (slice(0, 2), slice(0, max(1, 2 * hkv // hq)))
        q2, k2, v2 = q[:, h2[0]].cpu(), k[:, h2[1]].cpu(), v[:, h2[1]].cpu()
        o_p, o_wp = ring_world(q2, k2, v2, causal)[0].float(), core.sageattn(
            q2, k2, v2, is_causal=causal).float()
        ex2 = exf[:, h2[0]]
        plain = {"ring_vs_whole": cosine_similarity(o_p, o_wp),
                 "ring_vs_exact": cosine_similarity(o_p, ex2),
                 "whole_vs_exact": cosine_similarity(o_wp, ex2),
                 "kernel_ring_vs_plain_ring": cosine_similarity(of[:, h2[0]], o_p),
                 "kernel_whole_vs_plain_whole": cosine_similarity(o_w[:, h2[0]].float().cpu(),
                                                                  o_wp),
                 "kernel_whole_vs_exact": cosine_similarity(o_w[:, h2[0]].float().cpu(), ex2)}
        log(f"ring {name}, q heads 0-1 through the plain versions: " +
            ", ".join(f"{n} {c:.7f}" for n, c in plain.items()))
        ring_ms = cuda_ms(lambda: ring_world(q, k, v, causal), reps=5, warmup=1)
        whole_ms = cuda_ms(lambda: core.sageattn(q, k, v, is_causal=causal), reps=5, warmup=1)
        log(f"ring {name} ({b}, {hq}/{hkv}, {s}, {d}, causal {causal}): steps {kinds}; vs the "
            f"whole sageattn cos {cos_w:.7f}, LSE max abs {lse_err:.3e} (mean {lse_mean:.3e}); "
            f"vs exact cos {cos_x:.6f} (the whole sageattn's {cos_wx:.6f}); the world's steps "
            f"in turn {ring_ms:.3f} ms, one sageattn "
            f"{whole_ms:.3f} ms ({ring_ms / whole_ms:.3f}x)")
        require(plain["kernel_ring_vs_plain_ring"] >= 0.9999
                and plain["kernel_whole_vs_plain_whole"] >= 0.9999,
                f"ring {name}: the kernels disagree with the plain versions")
        require(kinds["full"] + kinds["aligned"] == steps
                and kinds["skipped"] == SP * SP - steps, f"ring {name}: steps {kinds}")
        require(cos_w >= 0.9999 and lse_err <= 0.1 and cos_x >= 0.999
                and cos_x >= cos_wx - 1e-4,
                f"ring {name}: the ring disagrees with the whole op or exact attention")
        out[name] = {"shape": [b, hq, hkv, s, d], "causal": causal, "steps": kinds,
                     "cos_vs_sageattn": cos_w, "lse_max_abs_vs_sageattn": lse_err,
                     "lse_mean_abs_vs_sageattn": lse_mean,
                     "cos_vs_exact": cos_x, "sageattn_cos_vs_exact": cos_wx, "plain": plain,
                     "world_ms": ring_ms, "sageattn_ms": whole_ms,
                     "launches": {n: c for n, c in launches.items() if c}}
        del q, k, v, o, o_w, ex, of, exf
        torch.cuda.empty_cache()
    return out


def ring_grad_world(q, k, v, do, dlse, causal: bool, n: int = SP):
    """A world of ``n``'s ring forward and backward on one card, rank after
    rank (``ring_partials``, ``merge_cotangents``, ``ring_step_vjp``: the
    code ``RingFunction`` runs): dq, dk and dv (fp32) of sum(o do) +
    sum(lse dlse), and the kinds of steps.  Each step's dK/dV partial goes
    into its block's owner's slice, where the backward's hops carry it."""
    import torch
    from sageattention_tpu_torch.parallel import ring

    sl = q.shape[2] // n
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = (torch.zeros(k.shape, dtype=torch.float32, device=k.device) for _ in range(2))
    kinds = {"full": 0, "aligned": 0, "skipped": 0}
    for idx in range(n):
        mine = slice(idx * sl, (idx + 1) * sl)
        blocks = world_blocks(k, v, idx, n)
        o_acc, lse_acc, steps = ring.ring_partials(q[:, :, mine], blocks, idx=idx,
                                                   is_causal=causal, grad=True)
        cts = ring.merge_cotangents(steps, o_acc, lse_acc, do[:, :, mine], dlse[:, :, mine])
        for (src, _, _), step, ct in zip(blocks, steps, cts):
            kinds[step_kind(src, idx, causal, step is not None)] += 1
            if step is None:
                continue
            gq, gk, gv = ring.ring_step_vjp(step, *ct)
            dq[:, :, mine] += gq
            dk[:, :, src * sl:(src + 1) * sl] += gk
            dv[:, :, src * sl:(src + 1) * sl] += gv
        del steps, cts
    return dq, dk, dv, kinds


def exact_grads_by_head(q, k, v, do, dlse, causal: bool):
    """Exact fp32 attention's dq, dk and dv of sum(o do) + sum(lse dlse),
    through ``reference.attention_reference`` and ``torch.autograd`` one q
    head at a time (all heads' [s, s] scores at once would not fit), dk and
    dv summed over each kv head's group."""
    import torch
    from sageattention_tpu_torch.ops import reference

    hq, hkv = q.shape[1], k.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = (torch.zeros(k.shape, dtype=torch.float32, device=k.device) for _ in range(2))
    for h in range(hq):
        kh = h // (hq // hkv)
        xs = [x[:, i:i + 1].float().requires_grad_() for x, i in ((q, h), (k, kh), (v, kh))]
        with torch.enable_grad():
            o, lse = reference.attention_reference(*xs, is_causal=causal, return_lse=True)
        g = torch.autograd.grad((o, lse), xs, (do[:, h:h + 1].float(), dlse[:, h:h + 1]))
        dq[:, h:h + 1] = g[0]
        dk[:, kh:kh + 1] += g[1]
        dv[:, kh:kh + 1] += g[2]
    return dq, dk, dv


def sageattn_grads(q, k, v, do, dlse, causal: bool):
    """One ``sageattn`` over the whole sequence, forward and backward: its
    dq, dk and dv of sum(o do) + sum(lse dlse)."""
    import torch
    from sageattention_tpu_torch import core

    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        o, lse = core.sageattn(*xs, is_causal=causal, return_lse=True)
    return torch.autograd.grad((o, lse), xs, (do, dlse))


def grad_agreement(got, want) -> dict:
    """dq, dk, dv: cosine and max-abs over the largest |entry| of ``want``,
    on the host."""
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().cpu(), w.float().cpu()
        out[name] = {"cos": cosine_similarity(g, w),
                     "rel_max_abs": float((g - w).abs().max() / w.abs().max())}
    return out


def run_ring_grad(results) -> dict:
    """``ring_grad``: a world of 4's KV ring forward and backward, its ranks
    and steps one after another on the card (:func:`ring_grad_world`), at
    both ``RING_LAYERS``: the CogVideoX-2B layer (16 steps) and the
    llm-8b-gqa prefill layer (causal: 4 aligned and 6 full steps, 6
    skipped).  Seeded bf16 q, k, v, do and fp32 dlse; the loss sum(o do)
    + sum(lse dlse).  Kernels 2, 3 and 1 launch once a step that ran in
    the forward, 4, 7 and 8 once in its backward: the forward keeps each
    step's K codes, so the backward quantizes only Q.  dq, dk and dv
    against exact fp32 attention's (>= 0.999, and no more than 1e-4 below
    one ``sageattn``'s over the whole sequence, which is printed beside),
    the ring against that one op; on q heads 0-1 (and their kv heads) the
    world through the kernels against the plain versions on the host, the
    backward's kernel agreement limit (cosine >= 0.9999, max-abs <= 1e-2
    of the largest entry).  Timed against one ``sageattn`` forward and
    backward."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    out = {}
    for name, b, hq, hkv, s, d, causal, steps in RING_LAYERS:
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        do = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        dlse = torch.randn(b, hq, s, generator=gen, device="cuda")
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        *g_ring, kinds = ring_grad_world(q, k, v, do, dlse, causal)
        torch.cuda.synchronize()
        # above the inputs: the three gradients, one rank's residuals at a
        # time and the temporaries
        world_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = sharded_launch_check(f"ring_grad {name}",
                                        {n: steps for n in FORWARD + BACKWARD})
        for n in FORWARD + BACKWARD:
            results[n].setdefault("launches_by_path", {})[f"ring_grad {name}"] = launches[n]
        require(kinds["full"] + kinds["aligned"] == steps
                and kinds["skipped"] == SP * SP - steps, f"ring_grad {name}: steps {kinds}")
        g_whole = sageattn_grads(q, k, v, do, dlse, causal)
        vs_whole = grad_agreement(g_ring, g_whole)
        g_exact = exact_grads_by_head(q, k, v, do, dlse, causal)
        vs_exact = grad_agreement(g_ring, g_exact)
        whole_vs_exact = grad_agreement(g_whole, g_exact)
        del g_exact
        # q heads 0-1 and their kv heads: the world through the kernels and
        # through the plain versions (CPU tensors) on the same inputs
        hs = (slice(0, 2), slice(0, max(1, 2 * hkv // hq)))
        q2, do2, dlse2 = (x[:, hs[0]] for x in (q, do, dlse))
        k2, v2 = k[:, hs[1]], v[:, hs[1]]
        g_k2 = ring_grad_world(q2, k2, v2, do2, dlse2, causal)[:3]
        t_p = time.perf_counter()
        g_p2 = ring_grad_world(*(x.cpu() for x in (q2, k2, v2, do2, dlse2)), causal)[:3]
        plain_s = time.perf_counter() - t_p
        plain = grad_agreement(g_k2, g_p2)

        def world():
            ring_grad_world(q, k, v, do, dlse, causal)

        def whole():
            sageattn_grads(q, k, v, do, dlse, causal)

        world_ms = cuda_ms(world, reps=3, warmup=1)
        whole_ms = cuda_ms(whole, reps=3, warmup=1)
        log(f"ring_grad {name} ({b}, {hq}/{hkv}, {s}, {d}, causal {causal}): steps {kinds}; "
            f"vs exact {json.dumps(vs_exact)}; the whole sageattn vs exact "
            f"{json.dumps(whole_vs_exact)}; vs the whole sageattn {json.dumps(vs_whole)}; "
            f"kernels vs plain on q heads 0-1 {json.dumps(plain)} (plain world {plain_s:.1f} s "
            f"on the host); the world's forward+backward in turn {world_ms:.3f} ms, one "
            f"sageattn forward+backward {whole_ms:.3f} ms ({world_ms / whole_ms:.3f}x); the "
            f"world's peak memory above its inputs {world_gb:.3f} GB")
        require(all(r["cos"] >= 0.9999 and r["rel_max_abs"] <= 1e-2 for r in plain.values()),
                f"ring_grad {name}: the kernels disagree with the plain versions")
        require(all(vs_exact[g]["cos"] >= 0.999
                    and vs_exact[g]["cos"] >= whole_vs_exact[g]["cos"] - 1e-4
                    for g in vs_exact),
                f"ring_grad {name}: the ring's gradients disagree with exact attention's")
        out[name] = {"shape": [b, hq, hkv, s, d], "causal": causal, "steps": kinds,
                     "vs_exact": vs_exact, "sageattn_vs_exact": whole_vs_exact,
                     "vs_sageattn": vs_whole, "plain": plain, "plain_world_s": plain_s,
                     "world_ms": world_ms, "sageattn_fwd_bwd_ms": whole_ms,
                     "world_peak_gb_above_inputs": world_gb,
                     "launches": {n: c for n, c in launches.items() if c}}
        del q, k, v, do, dlse, g_ring, g_whole
        torch.cuda.empty_cache()
    return out


def run_trainer_parallel(results, mesh, train_ms: float) -> dict:
    """``trainer_parallel``, inside ``server_parallel``'s world of one: the
    CogVideoX-2B trainer at the ``trainer`` cell's geometry (depth 8, b 1,
    seeded weights) through "sage_parallel" on ``mesh``, its gradients
    averaged over "data" (``train.train(..., data=mesh)``).  One
    flow-matching loss's parameter gradients against the "sage" trainer's
    from the same weights and (t, eps) (cosine >= 0.99999; the key norm's
    bias, 0 in exact arithmetic, held negligible beside its scale's); 1
    warm-up and 3 timed steps (kernels 1-3 and 4, 7, 8 once a layer a
    step); one ``save_checkpoint`` / ``restore_latest`` round trip into a
    trainer of other weights, its parameters and AdamW state bit for bit
    the saved ones."""
    import tempfile

    import torch
    from sageattention_tpu_torch import models, serve, train
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    cfg = serve.parallel_config(models.MODEL_CONFIGS["cogvideox-2b"].scaled(depth=TRAIN_DEPTH),
                                mesh)
    tr = train.load_trainer(cfg, device="cuda", seed=0, data=mesh)
    x0, txt = serve.make_requests(cfg, 1, device="cuda", seed=5)[0]
    t, eps = train.step_noise(x0, 6, 0)
    grads = {}
    try:
        for backend in ("sage", "sage_parallel"):
            models.set_mesh(mesh if backend == "sage_parallel" else None)
            models.set_attention_backend(backend)
            tr.model.zero_grad(set_to_none=True)
            train.flow_loss(tr.model, x0, txt, t, eps).backward()
            grads[backend] = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}
        tr.model.zero_grad(set_to_none=True)
        coss, k_norm_bias = {}, 0.0
        for name, g in grads["sage_parallel"].items():
            ref = grads["sage"][name]
            if name.endswith("k_norm.bias"):
                scale = grads["sage"][name.replace("bias", "weight")].norm().item()
                k_norm_bias = max(k_norm_bias, max(g.norm().item(), ref.norm().item()) / scale)
                continue
            coss[name] = cosine_similarity(g.float().cpu(), ref.float().cpu())
        worst = min(coss, key=coss.get)
        del grads
        train.train(tr, x0, txt, 1, seed=6, data=mesh)  # warm-up, not counted
        zero_counts()
        res = train.train(tr, x0, txt, 3, seed=6, start=1, data=mesh)
        launches = sharded_launch_check("trainer_parallel",
                                        {n: TRAIN_DEPTH * 3 for n in FORWARD + BACKWARD})
    finally:
        models.set_attention_backend("sage")
        models.set_mesh(None)
    for n in FORWARD + BACKWARD:
        results[n].setdefault("launches_by_path", {})["trainer_parallel"] = launches[n]
    med = statistics.median(res["step_ms"])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t_c = time.perf_counter()
        train.save_checkpoint(tr, ckpt_dir, 3)
        other = train.load_trainer(cfg, device="cuda", seed=1)
        start = train.restore_latest(other, ckpt_dir)
        ckpt_s = time.perf_counter() - t_c
        same_params = all(torch.equal(p, p_o) for p, p_o in zip(tr.model.parameters(),
                                                                other.model.parameters()))
        same_opt = all(torch.equal(st[key], st_o[key])
                       for st, st_o in zip(tr.opt.state.values(), other.opt.state.values())
                       for key in st)
        ckpt_gb = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                      for f in os.listdir(ckpt_dir)) / 1e9
    log(f"trainer_parallel: grads 'sage_parallel' vs 'sage' min cosine {coss[worst]:.7f} "
        f"({worst}), k_norm.bias |g| / |g(k_norm.weight)| {k_norm_bias:.2e}; losses "
        f"{[round(x, 6) for x in res['losses']]}, ms per step "
        f"{[round(x, 3) for x in res['step_ms']]}, median {med:.3f} (trainer with 'sage' "
        f"{train_ms:.3f}); checkpoint {ckpt_gb:.2f} GB saved and restored in {ckpt_s:.1f} s, "
        f"resumes at step {start}, parameters equal {same_params}, AdamW state equal {same_opt}")
    require(coss[worst] >= 0.99999 and k_norm_bias <= 1e-2,
            "trainer_parallel: the 'sage_parallel' gradients disagree with 'sage'")
    require(all(map(math.isfinite, res["losses"])), "trainer_parallel: a loss is not finite")
    require(start == 4 and same_params and same_opt,
            "trainer_parallel: the checkpoint round trip is not exact")
    del tr, other
    torch.cuda.empty_cache()
    return {"grads_min_cosine_vs_sage": coss[worst], "min_cosine_param": worst,
            "k_norm_bias_over_weight": k_norm_bias, "losses": res["losses"],
            "step_ms": res["step_ms"], "median_step_ms": med, "trainer_median_step_ms": train_ms,
            "checkpoint_gb": ckpt_gb, "checkpoint_round_trip_s": ckpt_s,
            "launches": {n: c for n, c in launches.items() if c}}


def run_server_parallel(results, server_ms: float, train_ms: float) -> dict:
    """``server_parallel``: a world of one over NCCL (a ``FileStore`` in a
    temporary directory, no port), ``make_mesh(1, 1, 1)``: the CogVideoX-2B
    server through "sage_parallel" (``serve.serve_parallel``, 2 requests x
    2 steps, kernels 1-3 once a layer a step) with its eps against "sage"
    (cosine >= 0.9999), the trainer through it (:func:`run_trainer_parallel`),
    then the four sharded factories through the group
    (``generate.sharded_serve``) at the ``sharded_paged`` geometry, paged
    and dense, 32 layers, 4 steps."""
    import tempfile

    import torch
    import torch.distributed as dist
    from sageattention_tpu_torch import generate, models, serve
    from sageattention_tpu_torch.parallel import make_mesh
    from sageattention_tpu_torch.parallel.mesh import initialize_multihost
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_multihost(world_size=1, rank=0, store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh = make_mesh(1, 1, 1)
            x = torch.full((4,), 3.0, device="cuda")
            dist.all_reduce(x, group=mesh.get_group("seq"))
            torch.cuda.synchronize()
            require(bool((x == 3.0).all()), "server_parallel: an NCCL all_reduce in a world of one")
            log(f"server_parallel: backend {dist.get_backend()}, world "
                f"{dist.get_world_size()}, mesh {mesh}")
            cfg = serve.parallel_config(
                models.MODEL_CONFIGS["cogvideox-2b"].scaled(depth=SERVER_DEPTH), mesh)
            model = serve.load_model(cfg, device="cuda", seed=0)
            requests = serve.make_requests(cfg, 2, device="cuda", seed=1)
            serve.serve_parallel(model, requests[:1], 1, mesh)  # warm-up, not counted
            zero_counts()
            res = serve.serve_parallel(model, requests, 2, mesh)
            launches = sharded_launch_check("server_parallel",
                                            {n: SERVER_DEPTH * 4 for n in FORWARD})
            for n in FORWARD:
                results[n].setdefault("launches_by_path", {})["server_parallel"] = launches[n]
            lat, txt = requests[0]
            t = torch.tensor([500], device="cuda")
            with torch.no_grad():
                models.set_mesh(mesh)
                models.set_attention_backend("sage_parallel")
                eps_p = model(lat, txt, t)
                models.set_attention_backend("sage")
                models.set_mesh(None)
                eps_s = model(lat, txt, t)
            cos = cosine_similarity(eps_p.float().cpu(), eps_s.float().cpu())
            med = statistics.median(res["step_ms"])
            log(f"server_parallel: ms per step {[round(x, 3) for x in res['step_ms']]}, median "
                f"{med:.3f} (server with 'sage' {server_ms:.3f}); eps vs 'sage' cos {cos:.7f}")
            require(cos >= 0.9999 and all(bool(torch.isfinite(o).all()) for o in res["outputs"]),
                    "server_parallel: the 'sage_parallel' eps disagree with 'sage'")
            out["server"] = {"step_ms": res["step_ms"], "median_step_ms": med,
                             "server_median_step_ms": server_ms, "eps_cos_vs_sage": cos}
            del model
            torch.cuda.empty_cache()
            t_phase = time.perf_counter()
            out["trainer"] = run_trainer_parallel(results, mesh, train_ms)
            log(f"trainer_parallel phase: {time.perf_counter() - t_phase:.1f} s")
            for paged in (True, False):
                path = f"sharded_serve_{'paged' if paged else 'dense'}"
                zero_counts()
                r = generate.sharded_serve(mesh, axis="seq", head_axis="heads", b=1, **SHARD_LAYER,
                                           context=SHARD_CTX, gen=4, depth=LLM_DEPTH, paged=paged,
                                           page_size=SHARD_PAGE, seed=5)
                n = LLM_DEPTH * 4
                want = ({"sage_paged_decode": n, "sage_paged_decode_owned": n} if paged
                        else {"sage_decode": n})
                launches = sharded_launch_check(f"server_parallel {path}", want)
                unit = SHARD_PAGE if paged else 1
                require(all(bool(torch.isfinite(o).all()) for outs in r["outputs"] for o in outs)
                        and r["lengths"].tolist() == [(SHARD_CTX - 4) // unit * unit + 4],
                        f"server_parallel {path}: outputs not finite or lengths wrong")
                log(f"server_parallel {path}: prefill {r['prefill_ms']:.3f} ms, ms per step "
                    f"{[round(x, 3) for x in r['step_ms']]}, cache {r['cache_bytes'] / 1e9:.2f} GB")
                out[path] = {"prefill_ms": r["prefill_ms"], "step_ms": r["step_ms"],
                             "cache_gb": r["cache_bytes"] / 1e9,
                             "launches": {k: c for k, c in launches.items() if c}}
                del r
                torch.cuda.empty_cache()
        finally:  # a failed phase must not leave NCCL's threads holding the process
            dist.destroy_process_group()
    return out


# --------------------------------------------------------------------------
# phase 10: head dims above 256 (d_pad 384 and 512)
# --------------------------------------------------------------------------

WIDE_DIMS = (384, 512)
# the kernels with instances at head dims 384 and 512, each counted apart as
# ``<name>_hd384`` / ``<name>_hd512``
WIDE = ("k_channel_mean", "quant_k_chunked", "quant_q_per_token", "quant_v_per_channel",
        "v_channel_stats", "quant_v_apply", "widen_v_codes", "sage_attn_fwd",
        "sage_attn_fwd_masked", "sage_attn_fwd_preq", "sage_decode", "sage_decode_window",
        "sage_paged_decode", "sage_paged_decode_window")
WIDE_SOURCE = {"sage_attn_fwd": "attention_fwd_wide.cu",
               "sage_attn_fwd_masked": "attention_fwd_masked_wide.cu",
               "sage_attn_fwd_preq": "attention_fwd_preq_wide.cu",
               "sage_decode": "decode_wide.cu", "sage_decode_window": "decode_wide.cu",
               "sage_paged_decode": "paged_decode_wide.cu",
               "sage_paged_decode_window": "paged_decode_wide.cu"}
# Gemma-7B's attention geometry (HD256_LAYER: b 4 x 4096, 16/16 heads) with
# the head dim widened; no model of models/configs.py has such a head dim,
# so the paths below are the public op and cache entry points at this size
WIDE_LAYER = dict(b=4, hq=16, hkv=16, s=4096)
WIDE_HEADS = (0, 7, 15)  # the query heads compared with plain and exact versions
# the decode serving paths at d 512: attention layers (the depth cut: no
# model to take it from) and decode steps
WIDE_SERVE_LAYERS = 4
WIDE_SERVE_STEPS = 32


def drive(results, path: str, want, fn):
    """A main path: every count zeroed just before ``fn`` runs and read just
    after; each kernel of ``want`` (a dict, or a function of ``fn``'s
    result that gives it) must have launched exactly that many times (at
    least once) and every other kernel none.  Returns ``fn``'s result."""
    import torch

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    got = read_counts()
    if callable(want):
        want = want(out)
    log(f"path {path} launches: { {n: c for n, c in got.items() if c} }")
    for name, n in got.items():
        require(n == want.get(name, 0), f"{path}: {name} launched {n} times, want "
                                        f"{want.get(name, 0)}")
    for name in want:
        require(want[name] > 0, f"{path}: {name} is not on the path")
        results[name].setdefault("launches_by_path", {})[path] = got[name]
    return out


def fill(results, name: str, what: str, **entry) -> None:
    """Put a kernel's times (ms, plain_ms, bound_ms, bound_by, library_ms
    and any other fields) into its entry and log them."""
    r = results[name]
    r.update(entry)
    log(f"time {name} {what}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, {r['bound_by']}), "
        f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms")


def sdpa_backend(q, k, v, causal: bool) -> tuple[str, float]:
    """(backend, ms) of ``F.scaled_dot_product_attention`` on these inputs:
    the first of flash, cuDNN, memory-efficient and math that takes them
    (flash stops at head dim 256).  A backend that refuses the inputs
    raises before it launches anything."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel([be]), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # each refusal warns why, then raises
            try:
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            return be.name.lower(), cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), reps=5)
    raise AssertionError("no SDPA backend takes these inputs")


def wide_registers(lib: str) -> dict:
    """{"D": (fewest, most registers, most stack bytes)} over the kernel
    instances of a built library, by their first template argument; the
    TMA-fed wgmma instances apart, as "D wgmma" (their registers at entry:
    setmaxnreg then gives a consumer thread 240)."""
    from sageattention_tpu_torch.ops import _build

    out = {}
    for kern, regs, stack in kernel_registers(_build, lib):
        dd = kern.split("<", 1)[1].split(",", 1)[0]
        if kern.startswith("sage_attn_fwd_wide_kernel"):
            dd += " wgmma"
        lo, hi, st = out.get(dd, (999, 0, 0))
        out[dd] = (min(lo, int(regs)), max(hi, int(regs)), max(st, int(stack)))
    return out


def exact_heads(q, k, v, causal: bool, hs, **masks):
    """Exact fp32 attention of the query heads ``hs`` (their kv heads)."""
    from sageattention_tpu_torch.ops import reference

    kvs = [h // (q.shape[1] // k.shape[1]) for h in hs]
    return reference.attention_reference(q[:, hs].float(), k[:, kvs].float(),
                                         v[:, kvs].float(), is_causal=causal, **masks)


def check_wide_attention(results) -> dict:
    """Phase 10b: kernel 1's wide instances (``attention_fwd_wide.cu``, the
    TMA-fed wgmma kernel with O's columns split between two warpgroups; e4m3
    V widened to bf16 first) at the Gemma-7B layer widened, (4, 16/16, 4096,
    d) for d 320 (padded to 384), 384 and 512, causal and not, bf16 and e4m3
    V, and q fp32 with bf16 V: the kernel against its plain version (o
    cosine >= 0.9999, max-abs <= 2e-2, lse2 <= 1e-3) and against exact fp32
    attention (>= 0.999) on WIDE_HEADS; the main paths
    ``wide_prefill_hd384`` / ``_hd512``: ``sageattn`` and
    ``sageattn_qk_int8_pv_fp8`` on the layer, causal (kernels 2-3 and 1
    twice, kernel 5 and the V widening once), each against exact attention;
    then each instance's time, its bound, its plain version's, SDPA's
    (naming the backend it took) and its registers, and the V widening's
    time at the layer."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import _build, attention_cuda, quant_cuda
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    b, hq, hkv, s = WIDE_LAYER.values()
    hs = WIDE_HEADS
    regs = wide_registers("attention_fwd_wide")
    out = {}
    for d in (320, 384, 512):
        dp = _build.pad_head_dim(d)
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        k = k + 0.5
        qp, kp, vp = padded(q, dp), padded(k, dp), padded(v, dp)
        k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(kp, group=128)
        v8, v8_sc, _ = quant_cuda.quant_v_per_channel(vp, dtype=torch.float8_e4m3fn)
        fold = d**-0.5 * LOG2E
        cell, ms = {}, {}
        for causal in (True, False):
            o_x = exact_heads(q, k, v, causal, hs)
            for vname, vx, vs, qx in (("bf16", vp, None, qp), ("e4m3", v8, v8_sc, qp),
                                      ("bf16, q fp32", vp, None, qp.float())):
                o, l2 = attention_cuda.sage_attention_fwd(qx, k_i8, k_sc, vx, vs,
                                                          is_causal=causal, q_fold=fold,
                                                          return_lse=True)
                o_p, l2_p = attention_cuda.sage_attention_plain(
                    qx[:, hs].contiguous(), k_i8[:, hs].contiguous(), k_sc[:, hs].contiguous(),
                    vx[:, hs].contiguous(), vs[:, hs].contiguous() if vs is not None else None,
                    is_causal=causal, q_fold=fold, return_lse=True)
                torch.cuda.synchronize()
                o_k = o[:, hs].float()
                cos = cosine_similarity(o_k.cpu(), o_p.float().cpu())
                err = (o_k - o_p.float()).abs().max().item()
                lerr = (l2[:, hs] - l2_p).abs().max().item()
                cos_x = cosine_similarity(o_k[..., :d].cpu(), o_x.cpu())
                finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2).all())
                pad0 = bool((o[..., d:] == 0).all())
                log(f"wide attention d{d} (pad {dp}) {(b, hq, hkv, s)} causal={causal} V {vname}: "
                    f"vs plain cos {cos:.6f}, max abs {err:.3e}, lse2 max abs {lerr:.3e}; vs exact "
                    f"cos {cos_x:.6f} (heads {list(hs)}); finite {finite}; pad lanes 0 {pad0}")
                require(finite and pad0 and cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                        f"wide attention d{d} V {vname}: disagrees with its plain version")
                require(cos_x >= 0.999, f"wide attention d{d} V {vname}: disagrees with exact")
                r = results[f"sage_attn_fwd_hd{dp}"]
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
                cell[f"causal={causal} V {vname}"] = {"cos_plain": cos, "max_abs": err,
                                                     "cos_exact": cos_x}
                ms[f"causal={causal} V {vname}"] = cuda_ms(
                    lambda vx=vx, vs=vs, qx=qx, causal=causal:
                    attention_cuda.sage_attention_fwd(qx, k_i8, k_sc, vx, vs, is_causal=causal,
                                                      q_fold=fold), reps=10)
                del o, l2, o_p, l2_p, qx
            del o_x
        if d == dp:  # the main path: the op, twice, on the layer
            ops = drive(results, f"wide_prefill_hd{dp}",
                        {f"k_channel_mean_hd{dp}": 2, f"quant_k_chunked_hd{dp}": 2,
                         f"sage_attn_fwd_hd{dp}": 2, f"quant_v_per_channel_hd{dp}": 1,
                         f"widen_v_codes_hd{dp}": 1},
                        lambda: (core.sageattn(q, k, v, is_causal=True),
                                 core.sageattn_qk_int8_pv_fp8(q, k, v, is_causal=True)))
            o_x = exact_heads(q, k, v, True, hs)
            for oname, o in zip(("sageattn", "sageattn_qk_int8_pv_fp8"), ops):
                c = cosine_similarity(o[:, hs].float().cpu(), o_x.cpu())
                log(f"wide_prefill_hd{dp} {oname} at {(b, hq, hkv, s, d)} causal vs exact fp32 "
                    f"attention (heads {list(hs)}): cos {c:.6f}; finite "
                    f"{bool(torch.isfinite(o).all())}")
                require(c >= 0.999 and bool(torch.isfinite(o).all()),
                        f"wide_prefill_hd{dp}: {oname} disagrees with exact attention")
                cell[f"op {oname} vs exact"] = c
            del ops, o_x
        pairs = b * hq * s * (s + 1) // 2
        # at the caller's d: bf16 Q in and O out, the K codes and scales, bf16 V
        moved = q.numel() * 2 * 2 + k.numel() + k_sc.numel() * 4 + v.numel() * 2
        bound, by = masked_bound(pairs, d, moved)
        plain_ms = cuda_ms(lambda: attention_cuda.sage_attention_plain(
            qp, k_i8, k_sc, vp, is_causal=True, q_fold=fold, return_lse=False), reps=2, warmup=1)
        backend, sdpa_ms = sdpa_backend(q, k, v, True)
        reg = regs.get(f"{dp} wgmma")
        out[f"d{d}"] = {"shape": [b, hq, hkv, s, d], "d_pad": dp, "checks": cell, "ms": ms,
                        "bound_ms": bound, "bound_by": by, "plain_ms": plain_ms,
                        "sdpa_ms": sdpa_ms, "sdpa_backend": backend, "registers": reg,
                        "live_pairs": pairs}
        log(f"time wide forward d{d} (pad {dp}) at {(b, hq, hkv, s)}: "
            f"{ {n: round(x, 4) for n, x in ms.items()} } ms; bound {bound:.4f} ms ({by}, "
            f"{pairs} live pairs causal); plain {plain_ms:.4f} ms; SDPA ({backend}) "
            f"{sdpa_ms:.4f} ms; registers (fewest, most, stack bytes) {reg}")
        if d == dp:
            fill(results, f"sage_attn_fwd_hd{dp}", f"at {(b, hq, hkv, s, d)} causal, bf16 V",
                 ms=ms["causal=True V bf16"], plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 library_ms=sdpa_ms, library=f"SDPA ({backend})", ms_by_case=ms,
                 registers=reg, shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d,
                                       "causal": True, "live_pairs": pairs},
                 pairs=pairs, d=d)  # for the floors at the measured rates (phase 9)
            # the V widening the fp8 op runs before the wgmma kernel, on its codes
            fill(results, f"widen_v_codes_hd{dp}", f"at {tuple(v8.shape)} e4m3",
                 ms=cuda_ms(lambda: attention_cuda.widen_v_codes(v8)),
                 plain_ms=cuda_ms(lambda: attention_cuda.widen_v_codes_plain(v8)),
                 library_ms=cuda_ms(lambda: v8.to(torch.bfloat16)),  # the plain version's call
                 bound_ms=v8.numel() * 3 / PEAK_BYTES_S * 1e3, bound_by="bytes",
                 max_abs_err=0.0 if torch.equal(
                     attention_cuda.widen_v_codes(v8).view(torch.int16),
                     attention_cuda.widen_v_codes_plain(v8).view(torch.int16)) else None)
            require(results[f"widen_v_codes_hd{dp}"]["max_abs_err"] == 0.0,
                    f"widen_v_codes at d {dp} differs from its plain version")
        del q, k, v, qp, kp, vp, k_i8, k_sc, v8, v8_sc
        torch.cuda.empty_cache()
    return out


def check_wide_masked(results) -> dict:
    """Phase 10c: the masked wide instances (``attention_fwd_masked_wide.cu``)
    against their plain version (:func:`compare_masked`) at (1, 16/8, 8192,
    512) with window 4096 and over varlen's four packed prompts at 512, and
    at (1, 16/8, 3001, 320) (padded to 384) with window 1000; the main path
    ``wide_masked_hd512``: ``sageattn`` with window 4096 and fp8 V (an 8
    MB V slab: kernel 6) and ``sageattn_varlen`` over the four prompts
    (int8 V, per-segment K means), each V widened to bf16 before the masked
    launch, each against exact attention; the
    instances' times beside the live pairs' bound, the plain version and
    SDPA with the band mask."""
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda, reference
    from sageattention_tpu_torch.ops.attention_cuda import Masks
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    out = {}
    hq, hkv, hs = 16, 8, (0, 8, 15)
    b, s, w, d = 1, 8192, 4096, 512
    q, k, v, k_i8, k_sc = layer_operands(gen, b, s, hq=hq, hkv=hkv, d=d)
    masks = Masks(window=w)
    compare_masked(f"hd512 window {w} at {(b, hq, hkv, s, d)}", q, k_i8, k_sc, v, masks, True,
                   hs, results, key="sage_attn_fwd_masked_hd512")
    cu, _, vmasks = varlen_masks()
    compare_masked(f"hd512 varlen {VARLEN_LENS}", q, k_i8, k_sc, v, vmasks, True, hs, results,
                   key="sage_attn_fwd_masked_hd512")
    xs = [x[0].transpose(0, 1) for x in (q, k, v)]
    o_w, o_v = drive(results, "wide_masked_hd512",
                     {"k_channel_mean_hd512": 1, "quant_k_chunked_hd512": 2,
                      "sage_attn_fwd_masked_hd512": 2, "v_channel_stats_hd512": 2,
                      "quant_v_apply_hd512": 2, "widen_v_codes_hd512": 2},
                     lambda: (core.sageattn(q, k, v, is_causal=True, window=w, pv_dtype="fp8"),
                              core.sageattn_varlen(*xs, cu, cu, is_causal=True,
                                                   smooth_k_mode="per_segment")))
    seg = core.varlen_rows(cu, cu, s, s)[0][None]
    for name, o, kw in (("window 4096, fp8 V", o_w, dict(window=w)),
                        (f"varlen {VARLEN_LENS}, int8 V", o_v.transpose(0, 1)[None],
                         dict(q_segment_ids=seg, kv_segment_ids=seg))):
        o_x = exact_heads(q, k, v, True, hs, **kw)
        c = cosine_similarity(o[:, hs].float().cpu(), o_x.cpu())
        log(f"wide_masked_hd512 {name} at {(b, hq, hkv, s, d)} vs exact fp32 attention (heads "
            f"{list(hs)}): cos {c:.6f}")
        require(c >= 0.999 and bool(torch.isfinite(o).all()),
                f"wide_masked_hd512 {name}: disagrees with exact attention")
        out[f"op {name} vs exact"] = c
        del o_x
    del o_w, o_v, xs
    pairs = live_pairs(masks, b, s, s, True, hq)
    fold = d**-0.5 * LOG2E
    bound, by = masked_bound(pairs, d, q.numel() * 2 * 2 + k_i8.numel() + k_sc.numel() * 4
                             + v.numel() * 2)
    band = reference._build_mask(s, s, is_causal=True, device="cuda", window=w)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    fill(results, "sage_attn_fwd_masked_hd512", f"window {w} at {(b, hq, hkv, s, d)} (library: "
         f"SDPA with the band mask)",
         ms=cuda_ms(lambda: attention_cuda.sage_attention_fwd_masked(
             q, k_i8, k_sc, v, masks=masks, is_causal=True, q_fold=fold), reps=10),
         plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_plain(
             q, k_i8, k_sc, v, is_causal=True, q_fold=fold, return_lse=False, masks=masks),
             reps=2, warmup=1),
         library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=band),
                            reps=3),
         bound_ms=bound, bound_by=by,
         shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "window": w,
                "live_pairs_per_head": pairs // (b * hq)})
    out["registers"] = wide_registers("attention_fwd_masked_wide")
    log(f"attention_fwd_masked_wide registers (fewest, most, stack bytes): {out['registers']}")
    del q, k, v, k_i8, k_sc, band, kr, vr
    torch.cuda.empty_cache()
    b, s, w, d = 1, 3001, 1000, 320
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    k = k + 0.5
    qp, kp, vp = (padded(x, 384) for x in (q, k, v))
    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(kp, group=128)
    masks = Masks(window=w)
    compare_masked(f"hd384 window {w} at {(b, hq, hkv, s, d)}", qp, k_i8, k_sc, vp, masks, True,
                   hs, results, key="sage_attn_fwd_masked_hd384")
    out[f"d320 window {w} vs exact"] = op_vs_exact(f"hd384 sageattn d320 window {w}", q, k, v,
                                                   True, dict(window=w))
    pairs = live_pairs(masks, b, s, s, True, hq)
    fold = d**-0.5 * LOG2E
    # the work at the caller's d 320: bf16 Q in and O out, K codes, bf16 V
    bound, by = masked_bound(pairs, d, q.numel() * 2 * 2 + k.numel() + k_sc.numel() * 4
                             + v.numel() * 2)
    band = reference._build_mask(s, s, is_causal=True, device="cuda", window=w)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    fill(results, "sage_attn_fwd_masked_hd384", f"window {w} at {(b, hq, hkv, s, d)}",
         ms=cuda_ms(lambda: attention_cuda.sage_attention_fwd_masked(
             qp, k_i8, k_sc, vp, masks=masks, is_causal=True, q_fold=fold), reps=10),
         plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_plain(
             qp, k_i8, k_sc, vp, is_causal=True, q_fold=fold, return_lse=False, masks=masks),
             reps=2, warmup=1),
         library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=band),
                            reps=3),
         bound_ms=bound, bound_by=by,
         shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "window": w,
                "live_pairs_per_head": pairs // (b * hq)})
    del q, k, v, qp, kp, vp, k_i8, k_sc, band, kr, vr
    torch.cuda.empty_cache()
    return out


def check_wide_preq(results) -> dict:
    """Phase 10d: the pre-quantized wide instances
    (``attention_fwd_preq_wide.cu``; unmasked the TMA-fed wgmma kernel)
    against their plain version for every Q/K option (QOPTS) with bf16 and
    e4m3 V (:func:`compare_preq`) at (4, 16/16, 4096, 512), causal and not,
    and at (1, 16/8, 3001, 320) (padded to 384), causal and not, and with
    window 1000 (the masked instances); the main path ``wide_preq_hd512``:
    ``sageattn`` with int4 + smooth_q on the layer (kernels 4, 2-3 and the pre-quantized
    forward), against exact attention at the int4 floor 0.97, and each
    other option as the op against exact at its floor (0.999 for 8 bits,
    0.97 for int4), on normal inputs; the times by option."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda
    from sageattention_tpu_torch.ops.attention_cuda import Masks
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    out = {}
    b, hq, hkv, s = WIDE_LAYER.values()
    d, hs = 512, WIDE_HEADS
    q, _, _ = biased_qk(gen, (b, hq, s, d))
    _, k, v = biased_qk(gen, (b, hkv, s, d))
    for opts in QOPTS.values():
        for causal in (True, False):
            compare_preq(f"hd512 {(b, hq, hkv, s, d)}", q, k, v, opts, causal, hs, results,
                         key="sage_attn_fwd_preq_hd512")
    # the op against exact attention on normal inputs (the accuracy sweep
    # holds int4 alone only there)
    qn, kn, vn = (torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    o_path = drive(results, "wide_preq_hd512",
                   {"quant_q_per_token_hd512": 1, "k_channel_mean_hd512": 2,
                    "quant_k_chunked_hd512": 1, "sage_attn_fwd_preq_hd512": 1},
                   lambda: core.sageattn(qn, kn, vn, is_causal=True, qk_bits=4, smooth_q=True))
    o_x = exact_heads(qn, kn, vn, True, hs)
    for oname, opts in QOPTS.items():
        o = o_path if oname == "int4+smooth_q" else core.sageattn(qn, kn, vn, is_causal=True,
                                                                  **opts)
        c = cosine_similarity(o[:, hs].float().cpu(), o_x.cpu())
        floor = SWEEP_FLOOR[opts.get("qk_bits", 8)]
        log(f"wide preq sageattn {oname} at {(b, hq, hkv, s, d)} causal vs exact fp32 attention "
            f"(heads {list(hs)}): cos {c:.6f} (floor {floor})")
        require(c >= floor and bool(torch.isfinite(o).all()),
                f"wide preq {oname}: disagrees with exact attention")
        out[f"{oname} vs exact"] = c
    del o, o_path, o_x, qn, kn, vn
    by_opt = {}
    for oname, opts in QOPTS.items():
        q_i8, q_sc, k_q, k_qs, cb = preq_operands(q, k, opts)
        by_opt[oname] = cuda_ms(lambda: attention_cuda.sage_attention_fwd_preq(
            q_i8, q_sc, k_q, k_qs, v, is_causal=True, col_bias=cb), reps=10)
        if oname == "int4+smooth_q":  # SageAttention2's setting carries the entry
            plain_ms = cuda_ms(lambda: attention_cuda.sage_attention_preq_plain(
                q_i8, q_sc, k_q, k_qs, v, is_causal=True, return_lse=False, col_bias=cb),
                reps=2, warmup=1)
            pairs = b * hq * s * (s + 1) // 2
            bound, by = masked_bound(pairs, d, q_i8.numel() + q_sc.numel() * 4 + k_q.numel()
                                     + k_qs.numel() * 4 + v.numel() * 2 + q.numel() * 2)
        del q_i8, q_sc, k_q, k_qs, cb
    backend, sdpa_ms = sdpa_backend(q, k, v, True)
    out["registers"] = wide_registers("attention_fwd_preq_wide")
    fill(results, "sage_attn_fwd_preq_hd512", f"at {(b, hq, hkv, s, d)} causal, bf16 V, "
         f"int4+smooth_q (by option { {n: round(x, 4) for n, x in by_opt.items()} })",
         ms=by_opt["int4+smooth_q"], plain_ms=plain_ms, bound_ms=bound, bound_by=by,
         library_ms=sdpa_ms, library=f"SDPA ({backend})", ms_by_option=by_opt,
         registers=out["registers"].get("512 wgmma"), pairs=pairs, d=d,
         shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": True,
                "option": "int4+smooth_q"})
    out["ms_by_option"] = by_opt
    del q, k, v
    torch.cuda.empty_cache()
    b, hq, hkv, s, d, w = 1, 16, 8, 3001, 320, 1000
    q, _, _ = biased_qk(gen, (b, hq, s, d))
    _, k, v = biased_qk(gen, (b, hkv, s, d))
    for oname, opts in QOPTS.items():
        compare_preq(f"hd384 d320 window {w} {(b, hq, hkv, s)}", q, k, padded(v, 384), opts,
                     True, (0, 8, 15), results, masks=Masks(window=w),
                     key="sage_attn_fwd_preq_hd384")
        for causal in (True, False):
            compare_preq(f"hd384 d320 {(b, hq, hkv, s)}", q, k, padded(v, 384), opts, causal,
                         (0, 8, 15), results, key="sage_attn_fwd_preq_hd384")
    q_i8, q_sc, k_q, k_qs, cb = preq_operands(q, k, QOPTS["int4+smooth_q"])
    vp = padded(v, 384)
    pairs = b * hq * s * (s + 1) // 2
    # the work at the caller's d 320: Q and K codes (a byte each) and
    # scales, bf16 V in and O out
    bound, by = masked_bound(pairs, d, q.numel() + k.numel() + q_sc.numel() * 4
                             + k_qs.numel() * 4 + v.numel() * 2 + q.numel() * 2)
    fill(results, "sage_attn_fwd_preq_hd384", f"at {(b, hq, hkv, s, d)} causal, bf16 V, "
         f"int4+smooth_q",
         ms=cuda_ms(lambda: attention_cuda.sage_attention_fwd_preq(
             q_i8, q_sc, k_q, k_qs, vp, is_causal=True, col_bias=cb), reps=10),
         plain_ms=cuda_ms(lambda: attention_cuda.sage_attention_preq_plain(
             q_i8, q_sc, k_q, k_qs, vp, is_causal=True, return_lse=False, col_bias=cb),
             reps=2, warmup=1),
         library_ms=sdpa_backend(q, k.repeat_interleave(2, dim=1),
                                 v.repeat_interleave(2, dim=1), True)[1],
         bound_ms=bound, bound_by=by, pairs=pairs, d=d,
         registers=wide_registers("attention_fwd_preq_wide").get("384 wgmma"),
         shape={"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": True,
                "option": "int4+smooth_q"})
    del q, k, v, vp, q_i8, q_sc, k_q, k_qs, cb
    torch.cuda.empty_cache()
    return out


def check_wide_grad(results) -> dict:
    """Phase 10e: the gradient through ``sageattn`` at (1, 16/16, 4096, 320),
    causal: it takes exact recompute (kernels 7-8 have no instance above
    256, and the JAX fused backward declines d > 256), so no backward
    kernel launches, the forward's d384 instances once each; q, k and v
    gradients against exact fp32 attention's at cosine >= 0.999; the
    fwd + bwd time."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(34)
    b, hq, hkv, s, d = 1, 16, 16, 4096, 320
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    do = torch.randn(b, hq, s, d, generator=gen, device="cuda")
    xs = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        o = core.sageattn(*xs, is_causal=True)
        require(type(o.grad_fn).__name__ == "RecomputeFunctionBackward",
                "wide grad: sageattn at d 320 did not take exact recompute")
        return torch.autograd.grad((o.float() * do).sum(), xs)

    g_s = drive(results, "wide_grad_hd384",
                {"k_channel_mean_hd384": 1, "quant_k_chunked_hd384": 1,
                 "sage_attn_fwd_hd384": 1}, fwd_bwd)
    xr = [x.float().detach().requires_grad_() for x in (q, k, v)]
    g_r = torch.autograd.grad((reference.attention_reference(*xr, is_causal=True) * do).sum(), xr)
    coss = [cosine_similarity(a.float().cpu(), r.cpu()) for a, r in zip(g_s, g_r)]
    ms = cuda_ms(fwd_bwd, reps=5)
    log(f"wide grad at {(b, hq, hkv, s, d)} causal: exact recompute, no backward kernel; vs exact "
        f"fp32 cos dq {coss[0]:.6f} dk {coss[1]:.6f} dv {coss[2]:.6f}; fwd+bwd {ms:.3f} ms")
    require(min(coss) >= 0.999, "wide grad: gradients disagree with exact attention")
    del xs, xr, g_s, g_r
    torch.cuda.empty_cache()
    return {"shape": [b, hq, hkv, s, d], "grad_cos_vs_exact": coss, "fwd_bwd_ms": ms}


def check_wide_decode(results):
    """Phase 10a: kernels 9-12's wide instances against their plain versions
    at the widened Gemma-7B decode shapes (16/16 heads, and GQA 16/8):
    int8 and int4, t_q 1 and 4, ragged lengths, window 4096, pages of 16
    and 1024 through scrambled tables, d 384, 512 and 320 (computed at
    384, read at its own head dim), and kernel 11 with the ``owned`` page
    mask (half the pages of a scrambled pool) at 384 and 512."""
    import torch
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import decode_cuda as dc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(35)

    def lens(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    cases = [
        # name, hq, hkv, d, b, t_q, S, page, lengths, window, packed
        ("int8 t_q 1", 16, 16, 512, 4, 1, 8192, None, [0, 1, 4123, 8192], None, False),
        ("int4 t_q 1", 16, 16, 512, 4, 1, 8192, None, [0, 1, 4123, 8192], None, True),
        ("int8 t_q 4 gqa 16/8", 16, 8, 512, 4, 4, 8192, None, [4, 4103, 8192, 300], None, False),
        ("int8 window 4096", 16, 16, 512, 2, 1, 9216, None, [8200, 1], 4096, False),
        ("int4 window 4096 gqa 16/8", 16, 8, 512, 2, 1, 9216, None, [8200, 5000], 4096, True),
        ("page 1024 int8", 16, 16, 512, 4, 1, 8192, 1024, [0, 1, 4123, 8192], None, False),
        ("page 16 int4 t_q 4", 16, 16, 512, 4, 4, 8192, 16, [4, 17, 4123, 8192], None, True),
        ("page 1024 int8 window 4096", 16, 8, 512, 2, 1, 9216, 1024, [8200, 3], 4096, False),
        ("page 16 int4 window 4096", 16, 16, 512, 2, 1, 9216, 16, [8200, 4100], 4096, True),
        ("d384 int8 t_q 1", 16, 16, 384, 4, 1, 8192, None, [0, 1, 4123, 8192], None, False),
        ("d384 int4 window 4096", 16, 8, 384, 2, 1, 9216, None, [8200, 5000], 4096, True),
        ("d384 page 16 int8 t_q 4", 16, 16, 384, 4, 4, 8192, 16, [4, 17, 4123, 8192], None,
         False),
        ("d384 page 1024 int4 window 4096", 16, 8, 384, 2, 1, 9216, 1024, [8200, 3], 4096, True),
        ("d320 int8 t_q 1", 16, 8, 320, 2, 1, 4096, None, [4000, 37], None, False),
        ("d320 page 48 int4 window 100", 16, 8, 320, 2, 1, 960, 48, [901, 60], 100, True),
    ]
    for name, hq, hkv, d, b, t_q, S, page, ln, window, packed in cases:
        cache = random_cache(gen, (b, hkv), S, d, packed)
        q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)
        key, fn, plain = decode_case(gen, q, cache, lens(ln), page, window, return_state=True)
        dp = _build.pad_head_dim(d)
        compare_decode(f"hd{dp} {name} d{d} {tuple(ln)}", fn(), plain(), results,
                       f"{key}_hd{dp}")
    for d in WIDE_DIMS:
        for packed in (False, True):
            cache = random_cache(gen, (2, 8), 8192, d, packed)
            pool, table = paged_from_dense(gen, cache, 1024)
            own = (torch.rand(table.shape, generator=gen, device="cuda") < 0.5).int()
            q = torch.randn(2, 16, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
            L = lens([8000, 3000])
            res = dc.sage_paged_decode_attention(q, *pool, table, L, owned=own,
                                                 return_state=True)
            res_p = dc.sage_paged_decode_attention_plain(q, *pool, table, L, owned=own,
                                                         return_state=True)
            compare_decode(f"hd{d} owned (half the pages) {'int4' if packed else 'int8'}", res,
                           res_p, results, f"sage_paged_decode_hd{d}")
    torch.cuda.empty_cache()


def run_wide_serving(results) -> dict:
    """Phase 10f: decode serving at d 512 through the public cache entry
    points (``kvcache``), the widened Gemma-7B layer's attention: b 4
    prompts of 4096 tokens, 16/16 heads, WIDE_SERVE_LAYERS layers of
    caches, each prefilled from seeded K/V (``append_kv`` or
    ``paged_prefill``), then WIDE_SERVE_STEPS decode steps of one token a
    layer (append, then ``sageattn_decode`` / ``sageattn_paged_decode``):
    dense int8 and int4 caches without a window and int8 with window 4096,
    paged int8 and int4 caches of 1024-token and 16-token pages through
    scrambled tables, and paged int8 with window 4096.  The counts are
    zeroed before the prefill (no kernel: the writes are tensor code) and
    before the steps (the path's decode kernel layers x steps times, no
    other).  The last step's layer 0 against the plain decode; each
    cell's ms a step (CUDA events, median), and its kernel's time on the
    last step's cache, L2 cold, beside its byte bound."""
    import torch
    from sageattention_tpu_torch import kvcache
    from sageattention_tpu_torch.ops import decode_cuda as dc

    b, hq, hkv, prompt, d = 4, 16, 16, 4096, 512
    layers, steps = WIDE_SERVE_LAYERS, WIDE_SERVE_STEPS
    max_len = 8192
    cells = [
        # path, cache, bits, page, window
        ("wide_serve_dense", "dense", 8, None, None),
        ("wide_serve_dense_int4", "dense", 4, None, None),
        ("wide_serve_dense_window", "dense", 8, None, 4096),
        ("wide_serve_paged", "paged", 8, 1024, None),
        ("wide_serve_paged_int4", "paged", 4, 1024, None),
        ("wide_serve_paged_16", "paged", 8, 16, None),
        ("wide_serve_paged_16_int4", "paged", 4, 16, None),
        ("wide_serve_paged_window", "paged", 8, 1024, 4096),
    ]
    out = {}
    for path, cache_kind, bits, page, window in cells:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(36)
        paged = cache_kind == "paged"
        kern = ("sage_paged_decode" if paged else "sage_decode") + ("_window" if window else "")
        kern += "_hd512"

        def new_cache():
            if not paged:
                return kvcache.init_kv_cache(b, hkv, max_len, d, bits=bits)
            n = max_len // page
            table = torch.randperm(b * n, generator=gen, device="cuda").reshape(b, n).int()
            return kvcache.init_paged_kv_cache(b * n, hkv, d, table, page_size=page, bits=bits)

        caches = [new_cache() for _ in range(layers)]
        L0 = torch.zeros(b, dtype=torch.int32, device="cuda")

        def prefill():
            for c in caches:
                k, v = (torch.randn(b, hkv, prompt, d, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(2))
                if paged:
                    kvcache.paged_prefill(c, k, v)
                else:
                    kvcache.append_kv(c, L0, k, v)
                del k, v

        drive(results, path + " prefill", {}, prefill)
        inputs = [[tuple(torch.randn(b, h, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
                         for h in (hq, hkv, hkv)) for _ in range(layers)] for _ in range(steps)]
        L = torch.full((b,), prompt, dtype=torch.int32, device="cuda")
        append = kvcache.paged_append if paged else kvcache.append_kv
        decode = kvcache.sageattn_paged_decode if paged else kvcache.sageattn_decode
        step_ms = []

        def serve():
            nonlocal L
            for st in range(steps):
                a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for li, c in enumerate(caches):
                    q, kn, vn = inputs[st][li]
                    append(c, L, kn, vn)
                    o = decode(q, c, L + 1, window=window)
                L = L + 1
                e.record()
                e.synchronize()
                step_ms.append(a.elapsed_time(e))
            return o

        o = drive(results, path, {kern: layers * steps}, serve)
        require(bool(torch.isfinite(o).all()) and L.tolist() == [prompt + steps] * b,
                f"{path}: outputs not finite or lengths wrong")
        c = caches[0]
        q = inputs[-1][0][0]
        if paged:
            ops = (c.pages_k, c.pages_k_scale, c.pages_v, c.pages_v_scale, c.page_table, L)
            fn = lambda: dc.sage_paged_decode_attention(q, *ops, window=window,  # noqa: E731
                                                        return_state=True)
            plain = lambda: dc.sage_paged_decode_attention_plain(  # noqa: E731
                q, *ops, window=window, return_state=True)
        else:
            ops = (c.k_i8, c.k_scale, c.v_i8, c.v_scale, L)
            fn = lambda: dc.sage_decode_attention(q, *ops, window=window,  # noqa: E731
                                                  return_state=True)
            plain = lambda: dc.sage_decode_attention_plain(q, *ops, window=window,  # noqa: E731
                                                           return_state=True)
        res, res_p = fn(), plain()
        compare_decode(f"{path} last step, layer 0", res, res_p, results, kern)
        err = (res[0].float() - res_p[0].float()).abs().max().item()
        ms = cuda_ms(fn, reps=10, cold=True)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        bound, by = decode_bound([prompt + steps] * b, hq, hkv, 1, d, bits == 4, window)
        med = statistics.median(step_ms)
        log(f"{path}: d {d}, {layers} layers of {cache_kind} int{bits} caches"
            f"{'' if page is None else f' (pages of {page})'}, window {window}, b {b} x "
            f"{prompt} + {steps}: ms a step {[round(x, 3) for x in step_ms]}, median {med:.3f} "
            f"({b / med * 1e3:.1f} tokens/s); {kern} {ms:.4f} ms a launch (bound {bound:.4f} ms, "
            f"{by}), plain {plain_ms:.4f} ms; max-abs vs plain {err:.3e}")
        out[path] = {"cache": cache_kind, "bits": bits, "page": page, "window": window,
                     "layers": layers, "steps": steps, "b": b, "prompt": prompt, "d": d,
                     "step_ms": step_ms, "median_step_ms": med, "kernel": kern,
                     "kernel_ms": ms, "bound_ms": bound, "bound_by": by, "plain_ms": plain_ms,
                     "max_abs_vs_plain": err}
        r = results[kern]
        if bits == 8 and page in (None, 1024):  # the int8 cell of 1024-token pages carries it
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
                     shape={"b": b, "hq": hq, "hkv": hkv, "t_q": 1, "d": d, "S": max_len,
                            "length": prompt + steps, "page": page, "window": window})
        else:
            r.setdefault("other_cells", []).append(
                {"path": path, "bits": bits, "page": page, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": by})
        del caches, inputs, res, res_p, o
        torch.cuda.empty_cache()
    return out


def time_wide(results) -> None:
    """Phase 10g: the wide instances no check above times: kernels 2-6 at
    384 and 512 (K at (4, 16, 4096, d), Q at (1, 16, 4096, d), V kernel 5
    at (1, 16, 4096, d) and kernel 6 at (1, 8, 16384, d)), and kernels
    9-12 at 384 on the serving cells' last step (b 4, 16/16, 4128 tokens
    of 8192; the windows at b 2, 8208 of 9216), L2 cold, beside their
    byte bounds and plain versions."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    for d in WIDE_DIMS:
        sfx = f"_hd{d}"
        b, hq, s = 4, 16, 4096
        k = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        km = quant_cuda.k_channel_mean(k)
        ng = -(-s // 128)
        fill(results, "k_channel_mean" + sfx, f"at {tuple(k.shape)}",
             ms=cuda_ms(lambda: quant_cuda.k_channel_mean(k)),
             plain_ms=cuda_ms(lambda: quant_cuda.k_channel_mean_plain(k)),
             library_ms=cuda_ms(lambda: torch.mean(k, dim=-2, dtype=torch.float32)),
             bound_ms=(k.numel() * 2 + km.numel() * 4) / PEAK_BYTES_S * 1e3, bound_by="bytes")
        fill(results, "quant_k_chunked" + sfx, f"at {tuple(k.shape)}",
             ms=cuda_ms(lambda: quant_cuda.quant_k_chunked(k, km, group=128)),
             plain_ms=cuda_ms(lambda: quant_cuda.quant_k_chunked_plain(k, km, group=128)),
             library_ms=None, bound_by="bytes",
             bound_ms=(k.numel() * 3 + km.numel() * 4 + b * hq * ng * 4) / PEAK_BYTES_S * 1e3)
        q = k[:1]
        fold = d**-0.5 * LOG2E
        fill(results, "quant_q_per_token" + sfx, f"at {tuple(q.shape)}",
             ms=cuda_ms(lambda: quant_cuda.quant_q_per_token(q, scale_fold=fold)),
             plain_ms=cuda_ms(lambda: quant_cuda.quant_q_per_token_plain(q, scale_fold=fold)),
             library_ms=None, bound_ms=(q.numel() * 3 + q.shape[1] * s * 4) / PEAK_BYTES_S * 1e3,
             bound_by="bytes")
        del k, km, q
        for shape, names in (((1, 16, 4096, d), ("quant_v_per_channel",)),
                             ((1, 8, 16384, d), ("v_channel_stats", "quant_v_apply"))):
            v = random_v(gen, shape)
            moved = v.numel() * 2 + v.numel() + shape[1] * d * 4
            if len(names) == 1:
                fill(results, names[0] + sfx, f"int8 at {shape}",
                     ms=cuda_ms(lambda: quant_cuda.quant_v_per_channel(v, dtype=torch.int8)),
                     plain_ms=cuda_ms(lambda: quant_cuda.quant_v_per_channel_plain(
                         v, dtype=torch.int8, smooth=False)),
                     library_ms=None, bound_ms=moved / PEAK_BYTES_S * 1e3, bound_by="bytes")
                continue
            gmax, gmin, mean = quant_cuda.v_channel_stats(v, smooth=False)
            _, rr = quant_cuda.v_scale_from_stats(gmax, gmin, mean, torch.int8)
            stats_bytes = v.numel() * 2 + 3 * shape[1] * d * 4
            fill(results, "v_channel_stats" + sfx, f"at {shape}",
                 ms=cuda_ms(lambda: quant_cuda.v_channel_stats(v, smooth=False)),
                 plain_ms=cuda_ms(lambda: quant_cuda.v_channel_stats_plain(v, smooth=False)),
                 library_ms=None, bound_ms=stats_bytes / PEAK_BYTES_S * 1e3, bound_by="bytes")
            fill(results, "quant_v_apply" + sfx, f"int8 at {shape}",
                 ms=cuda_ms(lambda: quant_cuda.quant_v_apply(v, rr, None, dtype=torch.int8)),
                 plain_ms=cuda_ms(lambda: quant_cuda.quant_v_apply_plain(v, rr, None,
                                                                        dtype=torch.int8)),
                 library_ms=None, bound_ms=moved / PEAK_BYTES_S * 1e3, bound_by="bytes")
            del v
        torch.cuda.empty_cache()
    d, hq = 384, 16
    for name, b, S, page, length, window in (
            ("sage_decode", 4, 8192, None, 4096 + WIDE_SERVE_STEPS, None),
            ("sage_paged_decode", 4, 8192, 1024, 4096 + WIDE_SERVE_STEPS, None),
            ("sage_decode_window", 2, 9216, None, 8192 + 16, 4096),
            ("sage_paged_decode_window", 2, 9216, 1024, 8192 + 16, 4096)):
        cache = random_cache(gen, (b, hq), S, d, False)
        q = torch.randn(b, hq, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
        L = torch.full((b,), length, dtype=torch.int32, device="cuda")
        _, fn, plain = decode_case(gen, q, cache, L, page, window)
        bound, by = decode_bound([length] * b, hq, hq, 1, d, False, window)
        fill(results, name + "_hd384", f"int8 at b {b}, {hq}/{hq} heads of {d}, length {length}, "
             f"S {S}{'' if page is None else f', page {page}'}",
             ms=cuda_ms(fn, reps=20, cold=True), plain_ms=cuda_ms(plain, reps=3, warmup=1),
             bound_ms=bound, bound_by=by, library_ms=None,
             shape={"b": b, "hq": hq, "hkv": hq, "t_q": 1, "d": d, "S": S, "length": length,
                    "page": page, "window": window})
    torch.cuda.empty_cache()


def run_wide(results) -> dict:
    """Phase 10, head dims above 256, each part from a generator of its own."""
    import torch

    t0 = time.perf_counter()
    for d in WIDE_DIMS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(30 + d)
        check_hd256_quant(gen, results, d)
    check_wide_decode(results)
    out = {"attention": check_wide_attention(results), "masked": check_wide_masked(results),
           "preq": check_wide_preq(results), "grad": check_wide_grad(results),
           "serving": run_wide_serving(results)}
    time_wide(results)
    for name in ("attention_fwd_wide", "attention_fwd_masked_wide", "attention_fwd_preq_wide",
                 "decode_wide", "paged_decode_wide"):
        out.setdefault("registers", {})[name] = wide_registers(name)
    log(f"head dims above 256: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 12: the dual-stream and cross-attention DiTs, speculative decoding,
# the SDPA patch
# --------------------------------------------------------------------------

HUNYUAN_CUT = 4  # HunyuanVideo's 40 dual-stream layers, cut to 4 for time
SPEC_K = 4  # draft tokens a round
SPEC_PROMPT = 4096
SPEC_GEN = 64
# the caches' rows: the prompt, the tokens and a round's K + 1 rows past the
# last, rounded up to whole pages (a dense cache above 4,096 rows takes a
# multiple of 128)
SPEC_MAX_LEN = 5120
# each video model's V quantizers with fp8 V: Wan2.1's self-attention V (an
# 8.4 MB slab a head) takes the two-pass kernels, its 512 text tokens' V
# the single-pass kernel
CROSS_FP8 = FORWARD + FORWARD + ("v_channel_stats", "quant_v_apply", "quant_v_per_channel") \
    + WIDEN + WIDEN


def per_layer(kernels: tuple, n: int) -> dict:
    """{kernel: n times as often as ``kernels`` names it}."""
    return {k: n * kernels.count(k) for k in set(kernels)}


def compare_fwd_rows(name, q, k, v, hs, rows, vnames, results) -> dict:
    """Kernel 1 at a model's attention shape against its plain version on
    the query heads ``hs`` and the query ``rows`` (None: all): the kernel
    runs on every row of those heads, the plain version on the given rows
    alone, which it computes row by row as the kernel does (per-token Q
    scales, the whole K); ``vnames`` picks the V types of ``v_operands``."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    q, k, v = (x[:, list(hs)].contiguous() for x in (q, k, v))
    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    fold = q.shape[-1] ** -0.5 * core.LOG2E
    qr = q if rows is None else q[:, :, rows].contiguous()
    out = {}
    for vname, vx, vs, vm in v_operands(v):
        if vname not in vnames:
            continue
        o, l2 = attention_cuda.sage_attention_fwd(q, k_i8, k_sc, vx, vs, vm, is_causal=False,
                                                  q_fold=fold, return_lse=True)
        o_p, l2_p = attention_cuda.sage_attention_plain(qr, k_i8, k_sc, vx, vs, vm,
                                                        is_causal=False, q_fold=fold,
                                                        return_lse=True)
        torch.cuda.synchronize()
        if rows is not None:
            o, l2 = o[:, :, rows], l2[:, :, rows]
        cos = cosine_similarity(o.float().cpu(), o_p.float().cpu())
        err = (o.float() - o_p.float()).abs().max().item()
        lerr = (l2 - l2_p).abs().max().item()
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2).all())
        log(f"attention {name} {tuple(q.shape)} x {tuple(k.shape)} V {vname}: cos {cos:.7f}, "
            f"max abs {err:.3e}, lse2 max abs {lerr:.3e} (heads {tuple(hs)}, "
            f"{'all rows' if rows is None else f'{qr.shape[2]} rows'}); finite {finite}")
        require(finite and cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                f"attention {name} V {vname} disagrees with its plain version")
        out[vname] = {"cos": cos, "max_abs_err": err, "lse2_max_abs": lerr}
        r = results["sage_attn_fwd"].setdefault("model_shapes", {})
        r[f"{name} {vname}"] = out[vname]
    return out


def check_video_attention(results) -> dict:
    """Kernel 1 at the new video models' shapes, from a generator of its own:
    HunyuanVideo's joint attention (1, 24, 119,056, 128) on 2 heads, the
    plain version on 3,072 rows (its [rows, 119,056] scores; all of them
    would be 57 GB a head) at the start, the middle and the ragged end;
    Wan2.1's cross-attention, 32,760 video queries against 512 text keys,
    and its self-attention over the 32,760 video tokens, each with bf16 V
    and the e4m3 codes of "sage_fp8"."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    s = 256 + 118800
    rows = torch.cat([torch.arange(0, 1024), torch.arange(s // 2 - 512, s // 2 + 512),
                      torch.arange(s - 1024, s)]).cuda()
    out = {"dual": compare_fwd_rows("hunyuanvideo joint", randn(1, 2, s, 128),
                                    randn(1, 2, s, 128), randn(1, 2, s, 128), (0, 1), rows,
                                    ("bf16",), results)}
    q = randn(1, 12, 32760, 128)
    out["cross"] = compare_fwd_rows("wan2.1 cross", q, randn(1, 12, 512, 128),
                                    randn(1, 12, 512, 128), (0, 6, 11), None,
                                    ("bf16", "fp8"), results)
    out["self"] = compare_fwd_rows("wan2.1 self", q, randn(1, 12, 32760, 128),
                                   randn(1, 12, 32760, 128), (0, 11), None, ("bf16", "fp8"),
                                   results)
    return out


def check_spec_decode(results) -> None:
    """Kernels 9 and 11 at speculation's verify step: t_q = K + 1 query rows
    of llm-8b-gqa (b 1, 32/8 heads of 128) over the int8 cache of a 4,096-
    token prompt, dense and in a scrambled pool of 1,024-token pages, at a
    round's first and last lengths, from a generator of their own."""
    import torch
    from sageattention_tpu_torch.ops import decode_cuda as dc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    t_q, S = SPEC_K + 1, SPEC_MAX_LEN
    for ln in (SPEC_PROMPT + t_q, SPEC_PROMPT + SPEC_GEN + SPEC_K):
        cache = random_cache(gen, (1, 8), S, 128, False)
        q = torch.randn(1, 32, t_q, 128, generator=gen, device="cuda").to(torch.bfloat16)
        L = torch.tensor([ln], dtype=torch.int32, device="cuda")
        res = dc.sage_decode_attention(q, *cache, L, return_state=True)
        res_p = dc.sage_decode_attention_plain(q, *cache, L, return_state=True)
        compare_decode(f"speculation verify dense t_q {t_q} ({ln},)", res, res_p, results,
                       "sage_decode")
        pool, table = paged_from_dense(gen, cache, LLM_PAGE)
        res = dc.sage_paged_decode_attention(q, *pool, table, L, return_state=True)
        res_p = dc.sage_paged_decode_attention_plain(q, *pool, table, L, return_state=True)
        compare_decode(f"speculation verify paged t_q {t_q} ({ln},)", res, res_p, results,
                       "sage_paged_decode")


def step_eps(model, lat, txt, t, backend: str):
    """eps of one forward with ``backend``, and its time (CUDA events)."""
    import torch
    from sageattention_tpu_torch import models

    models.set_attention_backend(backend)
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        a.record()
        eps = model(lat, txt, t)
        e.record()
    e.synchronize()
    models.set_attention_backend("sage")
    return eps, a.elapsed_time(e)


def run_video_server(results, *, path: str, model: str, cls: str, depth: int, n_req: int,
                     steps: dict, launched: dict) -> dict:
    """A server of a dual-stream or cross-attention DiT at full width: the
    model at ``depth`` with seeded weights, ``n_req`` requests, then for
    each (backend, steps) of ``steps`` that many denoise steps of the first
    ``n_req`` requests (one request for all but the first backend), each
    backend's run a path of its own (``<path>`` for the first, then
    ``<path>_<backend>``) launching per layer-step the kernels of
    ``launched[backend]``.  eps of every backend against "sdpa" on one
    step: cosine >= 0.999."""
    import torch
    from sageattention_tpu_torch import models, serve
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    cfg = models.MODEL_CONFIGS[model]
    full = cfg.depth
    cfg = cfg.scaled(depth=depth)
    log(f"server {path}: {cls} {cfg.name} seq {cfg.seq_len} ({cfg.text_len} text + "
        f"{cfg.video_tokens} video tokens) hidden {cfg.hidden} heads {cfg.heads}x{cfg.head_dim} "
        f"depth {depth} of {full}{' (cut for time)' if depth < full else ''}, bf16")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mdl = serve.load_model(cfg, device="cuda", seed=0, model_cls=getattr(models, cls))
    requests = serve.make_requests(cfg, n_req, device="cuda", seed=1)
    t999 = torch.tensor([999], device="cuda")
    for backend in steps:  # warm-up (allocator, cuBLAS, SDPA), not counted
        step_eps(mdl, *requests[0], t999, backend)
    torch.cuda.synchronize()
    log(f"server {path} set-up + warm-up: {time.perf_counter() - t0:.1f} s")
    cell = {"model": model, "class": cls, "depth": depth, "full_depth": full,
            "seq": cfg.seq_len, "backends": {}}
    for i, (backend, n) in enumerate(steps.items()):
        p = path if i == 0 else f"{path}_{backend}"
        reqs = requests if i == 0 else requests[:1]
        models.set_attention_backend(backend)
        torch.cuda.reset_peak_memory_stats()
        out = drive(results, p, per_layer(launched[backend], depth * len(reqs) * n),
                    lambda: serve.serve(mdl, reqs, n))
        models.set_attention_backend("sage")
        for lat in out["outputs"]:
            require(lat.shape == reqs[0][0].shape and bool(torch.isfinite(lat).all()),
                    f"server {p}: output is not finite or has the wrong shape")
        ms = out["step_ms"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"server {p}: {len(reqs)} requests x {n} steps with {backend!r}, ms per step "
            f"{[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}; peak memory "
            f"{peak:.2f} GB")
        cell["backends"][backend] = {"path": p, "step_ms": ms,
                                     "median_step_ms": statistics.median(ms), "peak_gb": peak}
    t = torch.tensor([500], device="cuda")
    eps_r, _ = step_eps(mdl, *requests[0], t, "sdpa")
    for backend in steps:
        if backend == "sdpa":
            continue
        eps, _ = step_eps(mdl, *requests[0], t, backend)
        cos = cosine_similarity(eps.float().cpu(), eps_r.float().cpu())
        log(f"server {path} eps, {backend!r} vs 'sdpa' (depth {depth}, full width): cos "
            f"{cos:.6f}")
        require(cos >= 0.999, f"server {path}: {backend!r} eps disagrees with 'sdpa'")
        cell["backends"][backend]["eps_cosine_vs_sdpa"] = cos
    b = cell["backends"]
    cell["sage_over_sdpa"] = b["sage"]["median_step_ms"] / b["sdpa"]["median_step_ms"]
    log(f"server {path}: 'sage' / 'sdpa' ms per step {cell['sage_over_sdpa']:.4f}")
    del mdl, requests
    torch.cuda.empty_cache()
    return cell


def run_server_dual(results) -> dict:
    """HunyuanVideo (hidden 3072, 24 heads x 128, 256 text + 118,800 video
    tokens) as ``DualStreamVideoDiT``, depth 40 cut to 4: 1 request x 2
    steps with "sage" (kernels 2, 3, 1 once a layer-step on the joint
    sequence), then 1 step with "sdpa" (none of them)."""
    return run_video_server(results, path="server_dual", model="hunyuanvideo",
                            cls="DualStreamVideoDiT", depth=HUNYUAN_CUT, n_req=1,
                            steps={"sage": 2, "sdpa": 1}, launched={"sage": FORWARD, "sdpa": ()})


def run_server_cross(results) -> dict:
    """Wan2.1-T2V-1.3B (hidden 1536, 12 heads x 128, 30 layers, 32,760 video
    tokens, cross-attention to 512 text tokens) as ``CrossAttnVideoDiT`` at
    full depth: 2 requests x 2 steps with "sage" (kernels 2, 3, 1 twice a
    layer-step), then 1 step each with "sage_fp8" and "sdpa"."""
    return run_video_server(results, path="server_cross", model="wan2.1-t2v-1.3b",
                            cls="CrossAttnVideoDiT", depth=SERVER_DEPTH, n_req=2,
                            steps={"sage": 2, "sage_fp8": 1, "sdpa": 1},
                            launched={"sage": FORWARD + FORWARD, "sage_fp8": CROSS_FP8,
                                      "sdpa": ()})


def run_speculate(results, model) -> dict:
    """Speculative decoding on the llm-8b-gqa server's model (depth 32, fp32
    weights): b 1, a 4,096-token prompt, K = 4 self-drafted tokens a round,
    64 generated tokens, on the dense int8 cache (``llm_speculate``) and
    the paged one (``llm_speculate_paged``), each beside plain greedy
    ``generate`` from the same prompt (``llm_greedy`` / ``_paged``).  A
    speculative run launches kernels 1-3 once a layer in its prefill and
    the cache's decode kernel once a layer a draft step and a verify step;
    a greedy run once a layer a step.  The drafts must be accepted at >=
    0.75 (a self-draft that the verify step rejected would be a broken
    extend step or rollback); the verify step's arithmetic (t_q = K + 1
    extend blocks) is held against exact attention at depth 2."""
    import torch
    from sageattention_tpu_torch import generate

    cfg, depth = model.cfg, model.cfg.depth
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    prompt = torch.randint(0, cfg.vocab, (1, SPEC_PROMPT), generator=gen, device="cuda")
    max_len = SPEC_MAX_LEN
    generate.speculate(model, prompt[:, :1024], 8, k=SPEC_K)  # warm-up at b 1
    out = {}
    for cache in ("dense", "paged"):
        kern = DECODE_KERNEL[(cache, False)]
        sfx = "" if cache == "dense" else "_paged"
        kw = dict(cache=cache, page_size=LLM_PAGE, max_len=max_len)
        torch.cuda.reset_peak_memory_stats()
        spec = drive(results, "llm_speculate" + sfx,
                     lambda r: {**per_layer(FORWARD, depth),
                                kern: depth * len(r["n_accepted"]) * (SPEC_K + 1)},
                     lambda: generate.speculate(model, prompt, SPEC_GEN, k=SPEC_K, **kw))
        peak = torch.cuda.max_memory_allocated() / 1e9
        greedy = drive(results, "llm_greedy" + sfx,
                       {**per_layer(FORWARD, depth), kern: depth * SPEC_GEN},
                       lambda: generate.generate(model, prompt, SPEC_GEN, **kw))
        toks, ref = spec["tokens"], greedy["tokens"]
        require(toks.shape == ref.shape == (1, SPEC_GEN + 1) and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"llm_speculate{sfx}: tokens")
        same = (toks == ref)[0].tolist()
        agree = same.index(False) if False in same else len(same)
        draft, verify = statistics.median(spec["draft_ms"]), statistics.median(spec["verify_ms"])
        log(f"llm_speculate{sfx}: K {SPEC_K}, {len(spec['n_accepted'])} rounds, accepted "
            f"{spec['accepted']}/{spec['drafted']} ({spec['acceptance']:.4f}), "
            f"n_accepted {spec['n_accepted']}; draft {draft:.3f} ms a round ({SPEC_K} steps), "
            f"verify {verify:.3f} ms; {spec['tokens_per_s']:.2f} tokens/s against plain greedy "
            f"{greedy['tokens_per_s']:.2f} (median step {statistics.median(greedy['step_ms']):.3f}"
            f" ms); prefill {spec['prefill_ms']:.3f} ms; peak memory {peak:.2f} GB; tokens "
            f"equal to greedy's for the first {agree} of {SPEC_GEN + 1}")
        require(spec["acceptance"] >= 0.75, f"llm_speculate{sfx}: acceptance "
                                            f"{spec['acceptance']:.4f} < 0.75")
        out[cache] = {"k": SPEC_K, "rounds": len(spec["n_accepted"]),
                      "n_accepted": spec["n_accepted"], "acceptance": spec["acceptance"],
                      "draft_ms": spec["draft_ms"], "verify_ms": spec["verify_ms"],
                      "median_draft_round_ms": draft, "median_verify_ms": verify,
                      "tokens_per_s": spec["tokens_per_s"],
                      "greedy_tokens_per_s": greedy["tokens_per_s"],
                      "greedy_median_step_ms": statistics.median(greedy["step_ms"]),
                      "prefill_ms": spec["prefill_ms"], "peak_gb": peak,
                      "tokens_equal_to_greedy_for": agree}
    torch.cuda.empty_cache()
    for cache in ("dense", "paged"):
        # the verify step's arithmetic: a 4,100-token prompt in t_q = 5 extend
        # blocks through the decode kernel, then 4 decode steps, vs exact
        cos = llm_refeed_cosine(cfg, cache=cache, bits=8, b=1, prompt=820 * (SPEC_K + 1),
                                steps=4, max_len=max_len, page_table=None,
                                chunk=SPEC_K + 1)
        log(f"llm_speculate {cache}: logits through t_q {SPEC_K + 1} extend blocks vs a one-shot "
            f"exact-attention refeed (depth 2, full width): cos {cos:.6f}")
        require(cos >= REFEED_FLOOR[8], f"llm_speculate {cache}: extend-block logits disagree")
        out[cache]["refeed_cosine_depth2"] = cos
    return out


def run_patched_sdpa(results) -> dict:
    """CogVideoX-2B (depth 30) on the "sdpa" backend under
    ``patch_torch_sdpa()``: every layer's SDPA call runs ``sageattn``
    (kernels 2, 3, 1 once a layer), eps bit for bit the "sage" backend's;
    after ``undo()`` the same backend launches none of them.  The patch is
    undone in a ``finally`` before anything else runs: no library time is
    taken under it."""
    import torch
    from sageattention_tpu_torch import models, serve
    from sageattention_tpu_torch.interop import patch_torch_sdpa
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    cfg = models.MODEL_CONFIGS["cogvideox-2b"].scaled(depth=SERVER_DEPTH)
    mdl = serve.load_model(cfg, device="cuda", seed=0)
    lat, txt = serve.make_requests(cfg, 1, device="cuda", seed=1)[0]
    t = torch.tensor([999], device="cuda")
    step_eps(mdl, lat, txt, t, "sage")  # warm-up
    step_eps(mdl, lat, txt, t, "sdpa")
    torch.cuda.reset_peak_memory_stats()
    eps_sage, sage_ms = drive(results, "patched_sdpa_sage", per_layer(FORWARD, cfg.depth),
                              lambda: step_eps(mdl, lat, txt, t, "sage"))
    undo = patch_torch_sdpa()
    try:
        eps_p, patched_ms = drive(results, "patched_sdpa", per_layer(FORWARD, cfg.depth),
                                  lambda: step_eps(mdl, lat, txt, t, "sdpa"))
    finally:
        undo()
    eps_sdpa, sdpa_ms = drive(results, "patched_sdpa_undone", {},
                              lambda: step_eps(mdl, lat, txt, t, "sdpa"))
    peak = torch.cuda.max_memory_allocated() / 1e9
    same = torch.equal(eps_p, eps_sage)
    cos = cosine_similarity(eps_p.float().cpu(), eps_sdpa.float().cpu())
    log(f"patched_sdpa: CogVideoX-2B depth {cfg.depth}, one forward: 'sdpa' under the patch "
        f"{patched_ms:.3f} ms, 'sage' {sage_ms:.3f} ms, 'sdpa' after undo {sdpa_ms:.3f} ms "
        f"(patched / SDPA {patched_ms / sdpa_ms:.4f}); peak memory {peak:.2f} GB; eps under the "
        f"patch bit-identical to 'sage': {same}; vs SDPA's cos {cos:.6f}")
    require(same, "patched_sdpa: eps under the patch differs from the 'sage' backend's")
    require(cos >= 0.999, "patched_sdpa: eps disagrees with SDPA's")
    del mdl
    torch.cuda.empty_cache()
    return {"patched_ms": patched_ms, "sage_ms": sage_ms, "sdpa_ms": sdpa_ms, "peak_gb": peak,
            "bit_identical_to_sage": same, "eps_cosine_vs_sdpa": cos}


def time_video_layers(results) -> dict:
    """One attention layer of each new model: the op (``sageattn``: kernels
    2, 3, 1), kernel 1 alone on the op's K codes, SDPA as PyTorch picks its
    backend (the "sdpa" model backend) and SDPA on the flash backend
    (``baselines.flash``, FA2): HunyuanVideo's joint layer (1, 24, 119,056,
    128) and Wan2.1's cross- (1, 12, 32,760 x 512, 128) and self-attention,
    each beside the data sheet's bound of its two products."""
    import torch
    from sageattention_tpu_torch import baselines, core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda
    from torch.nn.attention import SDPBackend

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    out = {}
    for name, h, sq, sk in (("hunyuanvideo joint", 24, 256 + 118800, 256 + 118800),
                            ("wan2.1 cross", 12, 32760, 512), ("wan2.1 self", 12, 32760, 32760)):
        q = torch.randn(1, h, sq, 128, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(1, h, sk, 128, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        fold = 128 ** -0.5 * core.LOG2E
        reps = 3 if sq * sk > 1e10 else 20
        choice = torch._fused_sdp_choice(q, k, v, None, 0.0, False)
        t = {"op": cuda_ms(lambda: core.sageattn(q, k, v), reps=reps, warmup=1),
             "kernel": cuda_ms(lambda: attention_cuda.sage_attention_fwd(
                 q, k_i8, k_sc, v, None, None, is_causal=False, q_fold=fold), reps=reps,
                 warmup=1),
             "sdpa": cuda_ms(lambda: baselines.sdpa(q, k, v), reps=reps, warmup=1),
             "flash": cuda_ms(lambda: baselines.flash(q, k, v), reps=reps, warmup=1)}
        ops = 2 * h * sq * sk * 128
        moved = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read, o written
        bound = max(ops / PEAK_INT8_OPS_S + ops / PEAK_BF16_FLOP_S, moved / PEAK_BYTES_S) * 1e3
        be = SDPBackend(choice).name.lower()
        log(f"time {name} layer {(1, h, sq, sk, 128)}: sageattn {t['op']:.3f} ms (kernel 1 "
            f"{t['kernel']:.3f}), SDPA ({be}, PyTorch's pick) {t['sdpa']:.3f} ms, SDPA on "
            f"flash {t['flash']:.3f} ms; sageattn / SDPA {t['op'] / t['sdpa']:.4f}; bound "
            f"{bound:.3f} ms (operations)")
        out[name] = {"shape": [1, h, sq, sk, 128], "sageattn_ms": t["op"],
                     "kernel_ms": t["kernel"], "sdpa_ms": t["sdpa"], "sdpa_backend": be,
                     "flash_ms": t["flash"], "bound_ms": bound}
        del q, k, v, k_i8
    torch.cuda.empty_cache()
    return out


def measured_rate_floor(results, probe: dict) -> None:
    """Beside each timed wgmma forward instance's data-sheet bound (the
    CogVideoX-2B and Wan2.1 layers, the Gemma-7B layer at 256, the
    pre-quantized forward at both, the wide instances at 384 and 512), the
    time its products take at this run's measured ``wgmma`` rates (above
    256 phase 9's d 256 rows: int8 Q.K^T at d 256, bf16 P.V at dv 256) and
    its exp2 at the measured ``exp2f`` rate; beside each timed backward
    kernel's, the time its products take at the measured ``wgmma`` and
    ``mma.sync`` rates at
    its head dim (int8 Q.K^T, 2d a pair, and bf16 P.V for the rest), the
    bias instances' too."""
    rate = {t["row"]: t["rate"] for t in probe["rows"]}
    for name in ("sage_attn_bwd_dq", "sage_attn_bwd_dkv", "sage_attn_bwd_dq_bias",
                 "sage_attn_bwd_dkv_bias"):
        for r in (results[name], results[name].get("gqa_causal"), results[name + "_hd256"]):
            if not r or "pairs" not in r:
                continue
            for kind in ("wgmma", "mma.sync"):
                r[kind.replace(".", "_") + "_floor_ms"] = (
                    2 * r["pairs"] * r["d"] / rate[f"qk s8 d{r['d']} {kind}"]
                    + r["pairs"] * r["bf16_ops_per_pair"] / rate[f"pv bf16 dv{r['d']} {kind}"]
                ) * 1e3
            log(f"{name} d{r['d']}: {r['ms']:.4f} ms; its products at the measured rates: wgmma "
                f"{r['wgmma_floor_ms']:.4f} ms, mma.sync {r['mma_sync_floor_ms']:.4f} ms; "
                f"data-sheet bound {r['bound_ms']:.4f} ms")
    # kernel 1's wgmma instances: their int8 Q.K^T and bf16 P.V at the
    # measured wgmma rates, and the softmax's exp2 (one a score) at the
    # measured exp2f rate (the "pass exp2f" row), each its own floor
    for r in (results["sage_attn_fwd"], results["sage_attn_fwd"]["wan_layer"],
              results["sage_attn_fwd_hd256"], results["sage_attn_fwd_preq"],
              results["sage_attn_fwd_preq_hd256"],
              *(results[f"{n}_hd{dp}"] for n in ("sage_attn_fwd", "sage_attn_fwd_preq")
                for dp in WIDE_DIMS)):
        if "pairs" not in r:
            continue
        ops = 2 * r["pairs"] * r["d"]
        dr = min(r["d"], 256)  # the probe's widest rows
        r["wgmma_floor_ms"] = (ops / rate[f"qk s8 d{dr} wgmma"]
                               + ops / rate[f"pv bf16 dv{dr} wgmma"]) * 1e3
        r["exp2_floor_ms"] = r["pairs"] / rate["pass exp2f"] * 1e3
        log(f"forward d{r['d']} ({r['pairs']} scores): {r['ms']:.4f} ms; its products at the "
            f"measured wgmma rates {r['wgmma_floor_ms']:.4f} ms, its exp2 at the measured "
            f"exp2f rate {r['exp2_floor_ms']:.4f} ms; data-sheet bound {r['bound_ms']:.4f} ms")


def kernel_entries() -> dict:
    """Each kernel's entry of the ``kernels`` line, before any number: its
    route, source and the TPU kernel it replaces; the head-dim-256, -384
    and -512 instances and kernels 11-12 with ``owned`` apart."""
    src = "sageattention_tpu_torch/csrc/"
    results = {
        "k_channel_mean": {"route": "cuda", "source": src + "quant_k.cu",
                           "replaces": "sageattention_tpu/ops/quant_pallas.py:272"},
        "quant_k_chunked": {"route": "cuda", "source": src + "quant_k.cu",
                            "replaces": "sageattention_tpu/ops/quant_pallas.py:143"},
        "sage_attn_fwd": {"route": "cuda", "source": src + "attention_fwd.cu",
                          "replaces": "sageattention_tpu/ops/attention_pallas.py:1412"},
        "sage_attn_fwd_masked": {"route": "cuda", "source": src + "attention_fwd_masked.cu",
                                 "replaces": "sageattention_tpu/ops/attention_pallas.py:1412"},
        "sage_attn_fwd_preq": {"route": "cuda", "source": src + "attention_fwd_preq.cu",
                               "replaces": "sageattention_tpu/ops/attention_pallas.py:1412"},
        "quant_q_per_token": {"route": "cuda", "source": src + "quant_q.cu",
                              "replaces": "sageattention_tpu/ops/quant_pallas.py:76"},
        "sage_attn_bwd_dq": {"route": "cuda", "source": src + "attention_bwd.cu",
                             "replaces": "sageattention_tpu/ops/attention_bwd_pallas.py:82"},
        "sage_attn_bwd_dkv": {"route": "cuda", "source": src + "attention_bwd.cu",
                              "replaces": "sageattention_tpu/ops/attention_bwd_pallas.py:238"},
        "sage_attn_bwd_dq_bias": {"route": "cuda", "source": src + "attention_bwd.cu",
                                  "replaces": "sageattention_tpu/ops/attention_bwd_pallas.py:82"},
        "sage_attn_bwd_dkv_bias": {
            "route": "cuda", "source": src + "attention_bwd.cu",
            "replaces": "sageattention_tpu/ops/attention_bwd_pallas.py:238"},
        "quant_v_per_channel": {"route": "cuda", "source": src + "quant_v.cu",
                                "replaces": "sageattention_tpu/ops/quant_pallas.py:512"},
        # kernel 1's V-code widening (attention_pallas.py:807, inside
        # sage_attention_fused), a pass of its own before the wgmma forward
        "widen_v_codes": {"route": "cuda", "source": src + "widen_v.cu",
                          "replaces": "sageattention_tpu/ops/attention_pallas.py:1412"},
        "v_channel_stats": {"route": "cuda", "source": src + "quant_v.cu",
                            "replaces": "sageattention_tpu/ops/quant_pallas.py:429"},
        "quant_v_apply": {"route": "cuda", "source": src + "quant_v.cu",
                          "replaces": "sageattention_tpu/ops/quant_pallas.py:429"},
        "sage_decode": {"route": "cuda", "source": src + "decode.cu",
                        "replaces": "sageattention_tpu/ops/decode_pallas.py:222"},
        "sage_decode_window": {"route": "cuda", "source": src + "decode.cu",
                               "replaces": "sageattention_tpu/ops/decode_pallas.py:271"},
        "sage_paged_decode": {"route": "cuda", "source": src + "paged_decode.cu",
                              "replaces": "sageattention_tpu/ops/paged_decode_pallas.py:45"},
        "sage_paged_decode_window": {
            "route": "cuda", "source": src + "paged_decode.cu",
            "replaces": "sageattention_tpu/ops/paged_decode_pallas.py:116"},
        "probe_mma": {"route": "cuda", "source": src + "probe_mma.cu",
                      "replaces": "tools/probe_mxu.py:68"},
    }
    for name in HD256:  # the head-dim-256 instances, reported apart
        results[name + "_hd256"] = {
            **results[name], "source": src + HD256_SOURCE.get(name, results[name]["source"]
                                                              .rsplit("/", 1)[1])}
    for name in OWNED:  # kernels 11-12 over a shard of a sharded pool
        results[name + "_owned"] = dict(results[name])
    for name in WIDE:  # the head-dim-384 and -512 instances, reported apart
        for d in WIDE_DIMS:
            results[f"{name}_hd{d}"] = {
                **results[name], "source": src + WIDE_SOURCE.get(name, results[name]["source"]
                                                                  .rsplit("/", 1)[1])}
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one step of each server and one training step "
                         "into chiprun_out/")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run", file=sys.stderr)
        return 1
    from sageattention_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    def build(name):  # seconds from the start until this source is loaded
        _build.lib(name)
        return name, round(time.perf_counter() - t0, 1)

    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:
        done = dict(pool.map(build, _build.SIGNATURES))
    log(f"build: {done} s, {time.perf_counter() - t0:.1f} s wall, into {_build.build_dir()}")
    resource_usage()

    results = kernel_entries()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the head-dim-256 phases draw from a generator of their own, so that
    # the earlier phases' inputs stay as they were
    gen256 = torch.Generator(device="cuda")
    gen256.manual_seed(8)
    t_phase = time.perf_counter()
    check_quant(gen, results)
    check_quant_v(gen, results)
    check_quant_k_cases(results)
    check_quant_v_cases(results)
    check_attention(gen, results)
    check_fwd_sm90(results)
    check_quant_q(gen, results)
    check_backward(gen, results)
    masked = check_masked(gen, results)
    masked["window_backward"] = check_window_backward(gen, results)
    t_b = time.perf_counter()
    bias = {"kernel_checks": check_bias_backward(results)}
    log(f"bias backward checks: {time.perf_counter() - t_b:.1f} s")
    t_q = time.perf_counter()
    check_quant_4bit(gen, results)
    check_preq(gen, results)
    sweep = accuracy_sweep(gen)
    sweep["seed_spread"] = sweep_seed_spread(sweep["failed"])
    log(f"Q/K option checks and accuracy sweep: {time.perf_counter() - t_q:.1f} s")
    check_decode(gen, results)
    # the video variants' and speculation's kernel checks, each from a
    # generator of its own
    t_v = time.perf_counter()
    video = {"attention_checks": check_video_attention(results)}
    check_spec_decode(results)
    log(f"video model and speculation kernel checks: {time.perf_counter() - t_v:.1f} s")
    # the parallel slice's kernel check draws from a generator of its own
    gen_par = torch.Generator(device="cuda")
    gen_par.manual_seed(9)
    t_o = time.perf_counter()
    parallel = {"owned": check_owned(gen_par, results)}
    log(f"owned checks: {time.perf_counter() - t_o:.1f} s")
    t_h = time.perf_counter()
    check_hd256_quant(gen256, results)
    hd256 = {"attention": check_hd256_attention(gen256, results),
             "backward": check_hd256_backward(gen256, results)}
    check_hd256_decode(gen256, results)
    # the Q/K options and the trainable bias at 256, each from a generator of its own
    hd256["preq"] = check_hd256_preq(results)
    hd256["bias_backward"] = check_bias_backward(results, BIAS_CASES_HD256, seed=25,
                                                 suffix="_hd256")
    log(f"head dim 256 checks: {time.perf_counter() - t_h:.1f} s")
    log(f"kernel checks: {time.perf_counter() - t_phase:.1f} s")
    servers = {}
    for path, model, backend, launched, bf16_steps in (
            ("server", "cogvideox-2b", "sage", FORWARD, 0),
            ("server_fp8", "cogvideox-2b", "sage_fp8", FORWARD + ("quant_v_per_channel",) + WIDEN,
             0),
            ("server_wan", "wan2.1-t2v-1.3b", "sage_fp8",
             FORWARD + ("v_channel_stats", "quant_v_apply") + WIDEN, 2)):
        t_phase = time.perf_counter()
        servers[path] = run_server(results, args.profile, model=model, backend=backend,
                                   path=path, launched=launched, bf16_steps=bf16_steps)
        log(f"server phase {path}: {time.perf_counter() - t_phase:.1f} s")
    # the Q/K options through SageAttnProcessor kwargs: upstream SageAttention's
    # Hopper default (per-thread int8 Q.K^T, fp8 P.V) and SageAttention2's 4 bits
    for path, backend, launched, kwargs, floor in (
            ("server_subtile_fp8", "sage_fp8", FORWARD_SUBTILE_FP8,
             {"qk_quant_gran": "per_subtile"}, 0.999),
            ("server_int4_sq", "sage", FORWARD_INT4_SQ, {"qk_bits": 4, "smooth_q": True}, 0.97)):
        t_phase = time.perf_counter()
        servers[path] = run_server(results, args.profile, model="cogvideox-2b", backend=backend,
                                   path=path, launched=launched, kwargs=kwargs, eps_floor=floor)
        log(f"server phase {path}: {time.perf_counter() - t_phase:.1f} s")
    for path, fn in (("server_dual", run_server_dual), ("server_cross", run_server_cross),
                     ("patched_sdpa", run_patched_sdpa)):
        t_phase = time.perf_counter()
        video[path] = fn(results)
        log(f"{path} phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    trainer = run_train(results, args.profile)
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    bias["trainer"] = run_bias_train(results)
    log(f"bias trainer phase: {time.perf_counter() - t_phase:.1f} s")
    llm = run_llm(results, args.profile)
    t_phase = time.perf_counter()
    llm.update(run_gemma(results, args.profile))
    log(f"gemma-7b geometry servers: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    hd256["trainer"] = run_hd256_train(results)
    log(f"head dim 256 trainer phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    hd256["bias_trainer"] = run_bias_train(results, HD256_LAYER, seed=28)
    hd256["bias_trainer"]["exact_route_step_ms"] = time_bias_exact_step(HD256_LAYER, seed=28)
    log(f"head dim 256 bias trainer phase: {time.perf_counter() - t_phase:.1f} s")
    for name, fn in (("sharded_paged", run_sharded_paged), ("sharded_dense", run_sharded_dense),
                     ("ring", run_ring), ("ring_grad", run_ring_grad)):
        t_phase = time.perf_counter()
        parallel[name] = fn(results)
        log(f"{name} phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    parallel["server_parallel"] = run_server_parallel(results, servers["server"]["median_step_ms"],
                                                      trainer["median_step_ms"])
    log(f"server_parallel phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    time_kernels(gen, results)
    time_quant_v(gen, results)
    layer = time_backward(gen, results)
    layer["gqa_causal"] = time_backward_gqa(results)
    time_decode(gen, results)
    masked["times"] = time_masked(gen, results)
    bias["times"] = time_bias_backward(results)
    bias["times"]["exact_route_b2_ms"] = time_bias_exact_route()
    qopts_times = time_qopts(gen, results)
    hd256["times"] = time_hd256(gen256, results)
    hd256["preq_times"] = time_hd256_preq(results)
    hd256["bias_times"] = time_bias_backward(results, HD256_LAYER, seed=29)
    video["layer_times"] = time_video_layers(results)
    log(f"timing phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    probe = run_probe(results)
    log(f"probe phase: {time.perf_counter() - t_phase:.1f} s")
    wide = run_wide(results)
    t_phase = time.perf_counter()
    time_quant_entries(results)
    log(f"C-entry timing phase: {time.perf_counter() - t_phase:.1f} s")
    measured_rate_floor(results, probe)

    # a head-dim-256 instance, or kernel 12 with owned, that no path of this
    # run launches (it is checked and timed only) goes inside its kernel's entry
    nested = {"_hd256": "hd256", "_hd384": "hd384", "_hd512": "hd512", "_owned": "owned"}
    for name in [n for n in results if n not in MAIN_PATH]:
        r = results.pop(name)
        sfx = next(x for x in nested if name.endswith(x))
        results[name.removesuffix(sfx)][nested[sfx]] = {**r, "name": name, "main_path": None}
    for name, r in results.items():
        # each kernel's launches on the main path that runs it (MAIN_PATH);
        # launches_by_path has every path's
        r["launches"] = r["launches_by_path"][MAIN_PATH[name]]
    # kernel 11's owned launches (sharded_paged) sit in its entry too
    for name in [n for n in results if n.endswith("_owned")]:
        r = results.pop(name)
        results[name.removesuffix("_owned")]["owned"] = {**r, "main_path": MAIN_PATH[name]}
    kernels = [{"name": name, **r, "max_err": r["max_abs_err"]} for name, r in results.items()]
    log(json.dumps({"servers": servers}))
    log(json.dumps({"llm_servers": llm}))
    log(json.dumps({"train": trainer}))
    log(json.dumps({"layer": layer}))
    log(json.dumps({"masked": masked}))
    log(json.dumps({"bias": bias}))
    log(json.dumps({"qopts": {"accuracy_sweep": sweep, "times": qopts_times}}))
    log(json.dumps({"hd256": hd256}))
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"probe": probe}))
    log(json.dumps({"wide": wide}))
    log(json.dumps({"video_variants": video}))
    require(not sweep["failed"], f"accuracy sweep: {sweep['failed']}")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
