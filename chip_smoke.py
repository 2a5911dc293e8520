"""Smoke run of the PyTorch/CUDA port (exllamav3_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,exl3_gemm,paged_attention_quant
    python3 chip_smoke.py --phases build,paged_attention,linear_attention,serve
    python3 chip_smoke.py --phases build,serve_capacity
    python3 chip_smoke.py --phases build,int4_matmul_a8,intb_matmul_a8,serve_packed
    python3 chip_smoke.py --phases build,moe_gemm,serve_moe
    python3 chip_smoke.py --phases build,linear_attention,linear_attention_quant
    python3 chip_smoke.py --phases build,serve_spec
    python3 chip_smoke.py --phases build,latent_attention,latent_attention_quant,parity_mla,serve_mla
    python3 chip_smoke.py --phases build,ring_attention,fused_mlp,parity_gemma,serve_gemma
    python3 chip_smoke.py --phases build,ring_attention,latent_attention,attention_stats,parity_dsv4,serve_dsv4
    python3 chip_smoke.py --phases build,fused_ablate,dequant_probe,int4_sweep,a8_ablate,a8_diag_proto,dma_floor

Phases:
  build     build the CUDA kernels from exllamav3_tpu_torch/csrc/ (timed)
  kernels   each kernel against its plain PyTorch version at the shapes of
            the Llama-3.1-8B main paths: errors, kernel / plain / library
            times and the bound (bytes over 3.35 TB/s, or tensor-core
            operations over their peak rate, whichever is larger). In place
            of `kernels`, one check's name runs that check alone:
            int8_matmul, fused_mlp, paged_attention (decode and verify take
            the split-key kernel of csrc/attention_decode.cuh, chunks of more
            than 32 rows a kv head the prefill body of
            csrc/attention_prefill.cuh: seven sequences at 300 beside one at
            8192, a block table four times wider than the longest sequence,
            batch 1 at 2048 and 8192, 64-wide heads, groups 1 and 2 (the
            two-row body), and verify chunks at group 8 of 32 and 40 rows;
            prefill untimed at 64-wide heads, groups 1, 2, 5 and 7, 33 rows
            at group 1 and three sequences of unequal length whose chunks
            start mid-page; the kernel library's counts of decode-kernel and
            prefill-body launches must show each case on its body;
            decode and verify timed over inputs rotated past the
            50 MB L2, as is their SDPA yardstick, the L2-warm times beside
            them), exl3_gemm (all K and
            codebooks; also an estimate of the decode's dispatch time from the
            compiled kernel's instructions, kept apart from the bound) and
            paged_attention_quant (merged and per-head storage, with and
            without the compander; verify S = 5, seven sequences at 300
            beside one at 8192, a block table four times wider than the
            longest sequence; decode and verify take the split-key kernel of
            csrc/attention_decode.cuh, chunks of more than 32 rows a kv head
            the prefill body of csrc/attention_prefill.cuh over the packed
            words: prefill at (4, 4) and (5, 3) timed, untimed at (2, 2),
            (8, 8), (3, 7), the compander, window + softcap + sinks with a
            padded tail, groups 5 and 8, 64-wide heads, and the 40-row verify
            chunk; the library's counts must show each case on its body; the
            decode rows are timed over inputs rotated past the 50 MB L2, as
            is their SDPA yardstick, with the L2-warm times beside them),
            int4_matmul, int4_matmul_a8, intb_matmul
            and intb_matmul_a8 (the packed-integer linears: also m = 128 and
            the Llama-3.1-70B shapes at m = 8; int-B at B = 3, 4, 5, 6, also
            qkv at m = 13 (int4 a8 too), each case held to the kernels the
            library counts it launched (up to 16 rows the int-B kernels and
            the int4 a8 route run their staged bodies, the int4 bf16 route
            and larger m packed_matmul.cuh's tiling) and, up to 16 rows, to
            the blocks an SM the sizing reckons with; int-B timed at every B
            at m = 8 qkv),
            moe_gemm (the selected-expert MLP at the Qwen3-30B-A3B,
            Qwen3-235B-A22B and Mixtral-8x7B expert shapes), linear_attention
            (the linear layout over a bf16 cache: Llama-3.2-1B draft decode,
            8B decode at batch 1 and 8, a 2048-token prefill, named cache
            rows, window / softcap / sinks, a last tile cut at T = 2056;
            prefill untimed over T = 2052 as paged_attention's; timed as
            paged_attention) and
            linear_attention_quant ((4, 4) merged and (5, 3) per-head storage
            at T = 2056, compander, features, prefill; batch 1 at 2048 and
            8192, (2, 2) and (8, 8), 64-wide heads; the prefill body untimed
            over T = 2052 at (2, 2), (8, 8), (3, 7), the compander, window +
            softcap + sinks, groups 5 and 8 and 64-wide heads; timed and
            routed as paged_attention_quant), latent_attention and
            latent_attention_quant (absorbed MLA over the latent cache at
            DeepSeek-V2-Lite's 16 heads and DeepSeek-V2/V3's 128: decode,
            verify, prefill, paged and linear at T = 2056 and 2052, a
            linear prefill whose last tile holds 4 keys, a 128-head prefill;
            (4), (3) and (4) with the compander; decode takes the split-key
            kernel of csrc/latent_decode.cuh, verify and prefill the
            pre-pass and the body of csrc/latent_prefill.cuh (warpgroup
            MMAs; table rows latent_attention_prefill and
            latent_attention_quant_prefill), by the library's counts of the
            three kernels' launches;
            a decode case with a sequence of no keys and a split of no keys
            among splits that see keys, held to the split arithmetic in
            plain torch), ring_attention (decode over the
            SWA ring at Gemma-3-27B's shapes, batch 8, q positions 300-2048,
            rings wrapped and still filling, never-written and stale slots, a
            permuted slot table; D = 64 at groups 5 and 7; sinks and a softcap
            of 50; a group of 40 on the tile loop; W = 1041, no multiple of
            4), attention_stats (row 6b, the return_stats entries, at
            DeepSeek-V4's decode shapes: 128 heads over one 512-wide row,
            batch 8, the sliding ring, the HCA pool of 2-entry pages through a
            shuffled block table, the CSA top 512 in rows; rows that see no
            key; two halves merged with sinks). int8_matmul also runs the
            Qwen3-30B-A3B attention and head shapes and DeepSeek-V2-Lite's
            576- and 10944-wide ones, fused_mlp the shared experts' width,
            moe_gemm DeepSeek-V2-Lite's experts, fused_mlp Gemma-3-27B's
            gelu_pytorch_tanh MLP at m = 1 and 8 and DeepSeek-V4's clamped
            shared expert (h 7168, i 2048), moe_gemm DeepSeek-V4's clamped
            experts (256 of 7168 x 2048, top 8), the four attention checks
            GQA groups 5, 6 and 7 (and 8), the linear ones at T = 2052.
            Rows 15-20, the measurement probes (probes/), at their JAX tools'
            default shapes, every variant: fused_ablate (the trellis GEMM
            stage by stage; exl3_gemm.cu timed beside it), dequant_probe (the
            quantized-KV dequant, per head, merged and dense bf16),
            int4_sweep, a8_ablate and a8_diag_proto (the int4 bodies) and
            dma_floor (an int8 weight streamed: the memory rate reached, also
            over 128 MB). Exact where the output is integer, else 1e-4
            (dequant_probe 3e-4, as the attention kernels it mirrors)
  parity    the first layer of a 2-layer checkpoint at full 8B width
            (PARITY_LAYERS): forward_simple and paged
            prefill + decode steps on the GPU (kernels) against the CPU
            (plain versions) over the same ids and weights, for the int8 path
            for the capacity path (`fused` linears, (4, 4) cache) and for the
            packed tiers int4 and int6 (a8 kernels); then a 1-layer Qwen3-MoE
            checkpoint at full Qwen3-30B-A3B width (int8), the GPU given the
            CPU's routing, with the share of (token, layer) expert sets the
            GPU's own router picks alike
  parity_mla
            a 2-layer DeepSeek-V2-Lite checkpoint at full width (the dense
            layer and one MoE layer with shared experts), the GPU against the
            CPU on the CPU's routing over a bf16 and a (4)-bit latent cache,
            the prefill on the latent prefill body once a layer
  parity_gemma
            the first 6 layers (5 sliding, 1 global) of a Gemma-3-27B-width
            checkpoint (int8): a 1536-token prompt and 32 greedy decode steps
            over the SWA ring, the GPU (ring kernel) against the CPU (plain
            versions; its 32 new tokens as one chunk); then the same request
            with the sliding layers in the paged cache (the paged kernel with
            the window): the same greedy tokens
  parity_dsv4
            a 2-layer DeepSeek-V4 checkpoint at full width (HCA then CSA, one
            hash-routed layer; conversion/synth.py::deepseek_v4_cfg): a
            2100-token prompt, then 32 greedy decode steps through the row 6b
            kernels, against one dense forward of the same tokens given the
            decode run's routing
  serve     a 32-layer synthetic checkpoint at Llama-3.1-8B geometry loaded
            with linear_mode="auto" (int8 on an 80 GB card) over a bf16 cache
            and served by the continuous-batching generator: 8 greedy
            requests, 512-1536 token prompts sharing a 512-token prefix, 128
            new tokens each, through its default route (decode bursts of 8,
            each (batch, pages) bucket's step a captured CUDA graph), the
            launches held to the decode steps run times a batch-1 step's plus
            the prefill chunks'; then replayed against eager steps at the
            same shapes from one cache state (bit-identical logits and
            tokens), eager, replayed and JAX-table-width replayed ms a step,
            and the same requests through the eager single-step route
            (decode_burst=1, no graphs): greedy tokens equal up to a step
            where its top-2 logit gap is under 2e-2; both routes' decode
            tok/s, TTFT and busy ms, idle share and device operations a token
  serve_capacity
            the same checkpoint and requests with linear_mode="fused" (every
            linear decodes its trellis in the GEMM kernel) over a quantized
            cache, k_bits = v_bits = 4, then one request on 4 layers with a
            (5, 3) cache, whose odd widths use the per-head storage. The
            served token is held against a forward of the same weights and
            cache widths through the plain PyTorch versions only
  serve_packed
            the same checkpoint and requests with linear_mode="int4" (grouped
            4-bit codes, the int8-activation kernel) over the bf16 cache; then
            one request on 4 layers each for int6 (a8), int4 with
            EXL3TPU_INT4_A8=0 and int6 with EXL3TPU_INTB_A8=0, so that each of
            the four packed kernels serves a run of its own; then the ladder:
            linear_mode="auto" on a device just large enough for int8, int6,
            int4 and none of them loads and runs on every rung
  serve_moe a synthetic Qwen3-MoE checkpoint at Qwen3-30B-A3B width, 16 of its
            48 layers (128 experts, top 8, vocab 151936) loaded with
            linear_mode="auto" (int8 on an 80 GB card; the experts serve as
            bf16 stacks) over a bf16 cache, the same traffic: prefill chunks
            through the grouped experts, decode steps through the
            selected-expert kernel
  linear_decode
            bench.py's measurements through Model.forward over a linear
            cache: the 32-layer 8B-geometry checkpoint in int8 over a bf16
            cache, decode at batch 1 and 8 after a 512-token prefill and one
            2048-token prefill; then `fused` over a (4, 4) linear cache (32
            layers) and over (5, 3) (4 layers). The first decode step is held
            to the same step over a paged cache and to the serve phases'
            references
  serve_spec
            greedy speculative decoding on a 16-layer 8B-geometry target
            (int8, bf16 paged cache), the serve phases' traffic: plain
            decoding, then (a) a 16-layer Llama-3.2-1B-geometry draft and (b)
            the target drafting for itself, 4 tokens a job over the draft's
            linear cache. Each request's tokens equal plain decoding's up to a
            first parting at a near-tie; (b) accepts at least 0.8 of its drafts
  serve_mla a synthetic DeepSeek-V2-Lite checkpoint at full width and all 27
            layers (MLA, 64 experts top 6 with 2 shared, one dense layer,
            vocab 102400) loaded once with linear_mode="auto" (int8; bf16
            expert stacks) and served over a bf16 paged latent cache, the
            same traffic, then one request of 32 tokens over a (4)-bit
            latent cache
  serve_gemma
            a synthetic Gemma-3-27B checkpoint at full width and 12 of its 62
            layers (GEMMA_SERVE_LAYERS; gelu_pytorch_tanh, tied head, vocab
            262208) loaded with linear_mode="auto" (int8) over a bf16 paged
            cache whose 10 sliding layers keep SWA rings (recurrent_slots 9),
            the same traffic: the ring kernel 10 times and the paged kernel 2
            times a decode step
  serve_dsv4
            the 2-layer full-width DeepSeek-V4 checkpoint (~13 GB) loaded with
            linear_mode="auto" (int8; bf16 expert stacks) over a bf16 paged
            cache of compressed pools with 9 state slots of rings and
            compressor buffers, the same traffic: the three row 6b kernels,
            the clamped fused MLP and the clamped selected-expert kernel each
            decode step

Each serve phase sets every kernel's launch count to 0 before its run and
reads it after: the kernels of its path must all have launched and the
others not at all. Every serve phase runs the generator's default decode
bursts: captured CUDA graphs for the Llama family, Gemma, the MoE families
and DeepSeek V2 / V3 (these up to the batch bucket of 8 rows; wider
batches run eagerly at their exact rows, on the selected-expert kernel up
to 15), eager bursts for DeepSeek-V4; a replay adds what its capture
counted to each wrapper's count (ops/launches.py), and in `serve` the
device trace of a window of replays shows each kernel as often as the
counts say.

The second-to-last line is the kernel table as JSON and the last line is
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero
without that line. Needs CUDA; writes its checkpoints under build/chip_smoke/
(the 16-layer MoE one is ~5 GB, the 27-layer DeepSeek-V2-Lite one ~8 GB,
the 12-layer Gemma-3-27B one ~3.5 GB and the 2-layer DeepSeek-V4 one ~13 GB,
one shard a layer).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from exllamav3_tpu_torch.ops.launches import counts_since, read_counts, set_counts
from exllamav3_tpu_torch.util.timing import HBM_BYTES_PER_S, rotating, time_ms

BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core rate
INT8_OP_PER_S = 1979e12     # dense int8 tensor-core rate
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

LLAMA8B = dict(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
               num_q_heads=32, num_kv_heads=8, head_dim=128)
# Qwen/Qwen3-30B-A3B config.json (every layer MoE, no shared expert)
QWEN3_30B = dict(vocab_size=151936, hidden_size=2048, intermediate_size=6144,
                 moe_intermediate_size=768, num_q_heads=32, num_kv_heads=4, head_dim=128,
                 num_experts=128, num_experts_per_tok=8, rms_norm_eps=1e-6, rope_theta=1e6)

# deepseek-ai/DeepSeek-V2-Lite config.json: MLA (16 heads, kv_lora_rank 512, rope 64),
# 64 routed experts of width 1408, top 6, 2 shared, a dense first layer of width
# 10944, full vocabulary 102400 (conversion/synth.py::deepseek_v2_lite_cfg)
V2_LITE = dict(vocab_size=102400, hidden_size=2048, num_q_heads=16, kv_lora_rank=512,
               qk_rope_head_dim=64, num_layers=27)

# tolerances, each relative to the largest magnitude of the plain result
TOL_INT8 = 1e-4   # both sides: exact bf16 products, f32 sums in another order
TOL_MLP = 2e-3    # f32 order can flip a bf16 rounding of the activation
TOL_ATTN = 2e-4   # q and P enter the MMAs as hi + lo bf16 pairs (~2^-16 relative)
TOL_EXL3 = 1e-4   # both sides: the same bf16 weights and activations, f32 sums in another order
TOL_PACKED = 1e-4  # both sides: the same bf16 or int8 operands, f32 sums in another order
TOL_ATTN_Q = 3e-4  # as TOL_ATTN; K/V are exact hi + lo pairs, the rotation sums in another order
TOL_PROBE = 1e-4  # the probes (rows 15-20) that are not exact: f32 sums in another order
# dequant_probe (row 16) as the attention kernels it mirrors: q, and K where
# it has more than 16 significant bits, enter the MMAs as hi + lo bf16 pairs
TOL_PROBE_KV = TOL_ATTN_Q
# the selected-expert MLP, relative to the range of the plain result: the same
# bf16 products, f32 sums in another order, which now and then flip the bf16
# rounding of one activation (one flip moves an output by 2^-8 of that
# activation's term: up to 1.13e-4 of the largest magnitude at Qwen3-235B-A22B
# shapes on an H100 80GB HBM3 at 700 W)
TOL_MOE = 1e-4
# logits over a quantized cache, kernels against plain versions, relative to
# the logits' range: the two sides store different codes where a key or value
# sits on a grid edge (a step of a 4-bit grid is 1/8 of its group's range)
# and its last bf16 bit differs
TOL_QUANT_PATH = 6e-2
# logits of the a8 packed tiers, GPU against CPU: the row quantizer turns an
# activation whose last bf16 bit differs between the two devices into another
# int8 code (a step of 1/127 of the row's largest value). On the card alone,
# kernels against plain versions, upstream is identical and 2e-2 holds
TOL_A8_PATH = 6e-2
# logits of the MoE path, GPU against CPU, relative to the logits' largest
# magnitude, with the GPU given the CPU's routing at every layer (a router
# logit whose last bf16 bit differs between the devices would otherwise pick
# another expert for a token). The same sources of difference as the dense
# int8 path, held to the same limit
TOL_MOE_PATH = 2e-2
MIN_EXPERT_AGREEMENT = 0.9   # share of (token, layer) expert sets alike on both devices
# depth of the MoE serve: 16 of Qwen3-30B-A3B's 48 layers (24 until the whole
# call reached 1057 s of its 1200 s limit on an H100 host), so that the whole
# script keeps a margin within its time limit
MOE_SERVE_LAYERS = 16
# depth of the parity phase's two checkpoints (8B and Qwen3-30B-A3B width),
# cut from 2 to 1 when the probes (rows 15-20) joined the default call: their
# CPU side runs the plain versions of whole full-width layers
PARITY_LAYERS = 1

# An SM dispatches one warp instruction a clock from each of its four schedulers
LANES_PER_SM_CLOCK = 4 * 32

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "int8_matmul": ("exllamav3_tpu_torch/csrc/int8_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:44"),
    "fused_mlp": ("exllamav3_tpu_torch/csrc/fused_mlp.cu", "exllamav3_tpu/ops/fused_mlp.py:47"),
    "paged_attention": ("exllamav3_tpu_torch/csrc/paged_attention.cu",
                        "exllamav3_tpu/ops/flash_attention.py:253"),
    "exl3_gemm": ("exllamav3_tpu_torch/csrc/exl3_gemm.cu", "exllamav3_tpu/ops/exl3_gemm.py:153"),
    "paged_attention_quant_merged": ("exllamav3_tpu_torch/csrc/paged_attention_quant.cu",
                                     "exllamav3_tpu/ops/flash_attention.py:419"),
    "paged_attention_quant_per_head": ("exllamav3_tpu_torch/csrc/paged_attention_quant.cu",
                                       "exllamav3_tpu/ops/flash_attention.py:253"),
    "int4_matmul": ("exllamav3_tpu_torch/csrc/int4_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:217"),
    "int4_matmul_a8": ("exllamav3_tpu_torch/csrc/int4_matmul.cu",
                       "exllamav3_tpu/ops/q_matmul.py:315"),
    "intb_matmul": ("exllamav3_tpu_torch/csrc/intb_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:571"),
    "intb_matmul_a8": ("exllamav3_tpu_torch/csrc/intb_matmul.cu",
                       "exllamav3_tpu/ops/q_matmul.py:687"),
    "moe_gemm": ("exllamav3_tpu_torch/csrc/moe_gemm.cu", "exllamav3_tpu/ops/moe_gemm.py:48"),
    "linear_attention": ("exllamav3_tpu_torch/csrc/linear_attention.cu",
                         "exllamav3_tpu/ops/flash_attention.py:253"),
    # the prefill forms of rows 3 and 4 (chunks of more than 32 rows a kv
    # head), launched by the two entries above
    "paged_attention_prefill": ("exllamav3_tpu_torch/csrc/attention_prefill.cuh",
                                "exllamav3_tpu/ops/flash_attention.py:253"),
    "linear_attention_prefill": ("exllamav3_tpu_torch/csrc/attention_prefill.cuh",
                                 "exllamav3_tpu/ops/flash_attention.py:253"),
    "linear_attention_quant_merged": ("exllamav3_tpu_torch/csrc/linear_attention_quant.cu",
                                      "exllamav3_tpu/ops/flash_attention.py:419"),
    "linear_attention_quant_per_head": ("exllamav3_tpu_torch/csrc/linear_attention_quant.cu",
                                        "exllamav3_tpu/ops/flash_attention.py:253"),
    # the prefill forms of rows 7 and 5 (chunks of more than 32 rows a kv
    # head over the quantized cache), launched by the four entries above
    "paged_attention_quant_prefill_merged": ("exllamav3_tpu_torch/csrc/attention_prefill.cuh",
                                             "exllamav3_tpu/ops/flash_attention.py:419"),
    "paged_attention_quant_prefill_per_head": ("exllamav3_tpu_torch/csrc/attention_prefill.cuh",
                                               "exllamav3_tpu/ops/flash_attention.py:253"),
    "linear_attention_quant_prefill_merged": ("exllamav3_tpu_torch/csrc/attention_prefill.cuh",
                                              "exllamav3_tpu/ops/flash_attention.py:419"),
    "linear_attention_quant_prefill_per_head": ("exllamav3_tpu_torch/csrc/attention_prefill.cuh",
                                                "exllamav3_tpu/ops/flash_attention.py:253"),
    "latent_attention": ("exllamav3_tpu_torch/csrc/latent_attention.cu",
                         "exllamav3_tpu/ops/flash_attention.py:253"),
    "latent_attention_quant": ("exllamav3_tpu_torch/csrc/latent_attention_quant.cu",
                               "exllamav3_tpu/ops/flash_attention.py:253"),
    # the verify and prefill forms of row 6a (S > 1), launched by the two
    # entries above: the pre-pass and the body of csrc/latent_prefill.cuh
    "latent_attention_prefill": ("exllamav3_tpu_torch/csrc/latent_prefill.cuh",
                                 "exllamav3_tpu/ops/flash_attention.py:253"),
    "latent_attention_quant_prefill": ("exllamav3_tpu_torch/csrc/latent_prefill.cuh",
                                       "exllamav3_tpu/ops/flash_attention.py:253"),
    "ring_attention": ("exllamav3_tpu_torch/csrc/ring_attention.cu",
                       "exllamav3_tpu/ops/flash_attention.py:1045"),
    # row 6b, _flash_kernel with return_stats (:273), in DeepSeek-V4's three layouts
    "ring_attention_stats": ("exllamav3_tpu_torch/csrc/attention_stats.cu",
                             "exllamav3_tpu/ops/flash_attention.py:1045"),
    "pool_attention_stats": ("exllamav3_tpu_torch/csrc/attention_stats.cu",
                             "exllamav3_tpu/ops/flash_attention.py:273"),
    "rows_attention_stats": ("exllamav3_tpu_torch/csrc/attention_stats.cu",
                             "exllamav3_tpu/ops/flash_attention.py:273"),
    # rows 15-20, the measurement probes: on no served path
    "fused_ablate": ("exllamav3_tpu_torch/csrc/probe_trellis.cu", "tools/fused_ablate.py:43"),
    "dequant_probe": ("exllamav3_tpu_torch/csrc/probe_kv_dequant.cu", "tools/dequant_probe.py:39"),
    "dequant_probe_merged": ("exllamav3_tpu_torch/csrc/probe_kv_dequant.cu",
                             "tools/dequant_probe.py:125"),
    "dequant_probe_bf16": ("exllamav3_tpu_torch/csrc/probe_kv_dequant.cu",
                           "tools/dequant_probe.py:162"),
    "int4_sweep": ("exllamav3_tpu_torch/csrc/probe_int4.cu", "tools/int4_sweep.py:26"),
    "a8_ablate": ("exllamav3_tpu_torch/csrc/probe_int4.cu", "tools/a8_ablate.py:8"),
    "a8_diag_proto": ("exllamav3_tpu_torch/csrc/probe_int4.cu", "tools/a8_diag_proto.py:29"),
    "dma_floor": ("exllamav3_tpu_torch/csrc/probe_dma.cu", "tools/dma_floor.py:7"),
}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and tensor-core operations
    over their peak rate (bf16 unless the MMAs are int8)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class KernelTable:
    """Rows hold only what this run measured: a kernel's errors and times
    once the kernels phase checked it, its launches once the serve phase
    counted them (null otherwise)."""

    def __init__(self):
        self.rows = {}

    def row(self, name):
        source, replaces = KERNELS[name]
        return self.rows.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None})

    def add(self, name, err, ms, plain_ms, bnd, library_ms, shape, main, **extra):
        row = self.row(name)
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        if main and ms is not None:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=library_ms, shape=shape, **extra)

    def set_launches(self, counts):
        """A kernel that several serve phases run keeps the count of the
        first, the path it was ported for (the log prints every phase's)."""
        for name, n in counts.items():
            row = self.row(name)
            if row["launches"] is None:
                row["launches"] = n


# -- phase: kernels -------------------------------------------------------------

def _int8_launches() -> tuple:
    """The int8 library's launches so far: (staged products, tiled products,
    split-k reduce kernels), and the fused MLP's (first phases, second
    phases), as csrc/int8_matmul.cu and csrc/fused_mlp.cu count them."""
    from exllamav3_tpu_torch.ops.build import library

    lib = library()
    return (tuple(lib.exl3_int8_launches(kind) for kind in range(3)),
            tuple(lib.exl3_fused_mlp_launches(kind) for kind in range(2)))


def _int8_took(fn, args) -> tuple:
    """The kernels one call of fn(*args) launched, by the two libraries'
    counts (_int8_launches), and its output."""
    before = _int8_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    after = _int8_launches()
    return tuple(tuple(b - a for a, b in zip(x, y)) for x, y in zip(before, after)), out


def _same_twice(tag: str, fn, args, first) -> None:
    """A second call on the same inputs gives the same bits: the splits are
    added in split order whatever the order in which they arrive."""
    again = fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(again, first):
        raise AssertionError(f"{tag}: two calls on the same inputs differ by "
                             f"{float((again - first).abs().max()):.3e}")


def check_int8(table, dev):
    """The int8 matmul against its plain version: the 8B, Qwen3-30B-A3B and
    DeepSeek-V2-Lite shapes (k or n multiples of 64 only) at m = 1, 8, 12,
    16 and 2048 (12 and 16 untimed). Every case is held to the kernels it
    launched (the library's counts): up to 16 rows one staged product, above
    the tiled product and a reduce where k splits; up to 16 rows also to the
    blocks an SM the sizing reckons with, and a second call must give the
    same bits."""
    import exllamav3_tpu_torch.ops.q_matmul as qm
    from exllamav3_tpu_torch.ops.build import library

    shapes = [(4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
              (14336, 4096, "down"), (4096, 32768, "lm_head")]
    # Qwen3-30B-A3B's int8 linears: qkv, o_proj and the 151936-row head
    q3 = [(2048, 5120, "Qwen3-30B-A3B qkv"), (4096, 2048, "Qwen3-30B-A3B o_proj"),
          (2048, 151936, "Qwen3-30B-A3B lm_head")]
    # widths that are multiples of 64 but not of 128 (a cut last tile):
    # DeepSeek-V2-Lite's kv_a projection and its dense down projection
    ds = [(2048, 576, "DeepSeek-V2-Lite kv_a"), (10944, 2048, "DeepSeek-V2-Lite dense down")]
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (1, 8, 12, 16, 2048):
        for k, n, what in shapes + (q3 if m < 2048 else q3[:2]) + ds:
            def make(i, k=k, n=n, m=m):
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
                s = (torch.rand(n, generator=g, device=dev) + 0.5) * 0.01
                return x, w, s
            nb = m * k * 2 + k * n + n * 4 + m * n * 4
            timed = m in (1, 8, 2048)
            nxt = rotating(make, nb) if timed else (lambda made=make(0): made)
            x, w, s = nxt()
            ref = qm.int8_matmul_plain(x, w, s)
            took, got = _int8_took(qm.int8_matmul_kernel, (x, w, s))
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            tag = f"int8_matmul m={m} {what} ({k}x{n})"
            if not rel <= TOL_INT8:
                raise AssertionError(f"{tag}: rel err {rel} > {TOL_INT8}")
            if m <= qm.INT8_DECODE_ROWS:
                splits = qm.int8_split_count(m, k, n, sms)
                want = ((1, 0, 0), (0, 0))
                per_sm = library().exl3_int8_blocks_per_sm(m, k, n, splits)
                steps = -(-k // qm.INT8_STEP_ROWS)
                model = qm._int8_blocks_per_sm(m, -(-steps // splits))
                if per_sm != model:
                    raise AssertionError(f"{tag}: the card holds {per_sm} blocks an SM, the "
                                         f"sizing reckons with {model}")
                _same_twice(tag, qm.int8_matmul_kernel, (x, w, s), got)
                tag += f" [{splits} splits, {per_sm} blocks an SM, bitwise stable]"
            else:
                splits = qm._split_k(-(-n // 128) * -(-m // 128), k // 32, dev)
                want = ((0, 1, int(splits > 1)), (0, 0))
                tag += f" [{splits} splits]"
            if took != want:
                raise AssertionError(f"{tag}: launched ((staged, tiled, reduces), (MLP phases)) "
                                     f"{took}, not {want}")
            if not timed:
                log(f"{tag}: max_abs_err={err:.3e} rel={rel:.2e}")
                table.add("int8_matmul", err, None, None, None, None, "", main=False)
                del x, w, s, ref, got, nxt
                continue
            calls = 5 if m == 2048 else 20
            ms = time_ms(lambda: qm.int8_matmul_kernel(*nxt()), calls)
            plain = time_ms(lambda: qm.int8_matmul_plain(*nxt()), 3)
            # yardstick: cuBLAS bf16 GEMM on a dequantized copy (2 bytes/weight)
            nxt_lib = rotating(lambda i: (x, w.to(torch.bfloat16)), m * k * 2 + k * n * 2 + m * n * 2)
            lib = time_ms(lambda: torch.matmul(*nxt_lib()), calls)
            bnd = bound_ms(nb, 2.0 * m * k * n)
            log(f"{tag}: max_abs_err={err:.3e} rel={rel:.2e} "
                f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(torch.matmul bf16)={lib:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            table.add("int8_matmul", err, ms, plain, bnd, lib, f"m={m} k={k} n={n}",
                      main=(m == 8 and what == "qkv"))
            del x, w, s, ref, got, nxt, nxt_lib
    torch.cuda.empty_cache()


def check_fused_mlp(table, dev):
    """The fused MLP against its plain version at the served shapes, each case
    held to the two kernels it launched (the library's counts) and to the same
    bits from a second call; at 8B m = 8 also with the down scale and a bias
    in the kernel, which must give the bits of the caller's own multiply and
    add."""
    from exllamav3_tpu_torch.ops.fused_mlp import (fused_mlp_int8_kernel, fused_mlp_int8_plain,
                                                   fused_mlp_splits)

    g = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # Llama-3.1-8B; DeepSeek-V2-Lite's two shared experts (one gated MLP of 2 x 1408);
    # Gemma-3-27B's gelu_pytorch_tanh MLP; DeepSeek-V4's shared expert (h 7168, i 2048)
    # at its swiglu_limit of 10, and at a limit of 1 that clips about a fifth of the
    # gate values of this data
    for m, h, inter, act, clamp in ((1, 4096, 14336, "silu", 0.0), (8, 4096, 14336, "silu", 0.0),
                                    (16, 4096, 14336, "silu", 0.0), (8, 2048, 2816, "silu", 0.0),
                                    (1, 5376, 21504, "gelu_pytorch_tanh", 0.0),
                                    (8, 5376, 21504, "gelu_pytorch_tanh", 0.0),
                                    (1, 7168, 2048, "silu", 10.0), (8, 7168, 2048, "silu", 10.0),
                                    (8, 7168, 2048, "silu", 1.0)):
        def make(i, m=m, h=h, inter=inter):
            x = torch.randn((m, h), generator=g, device=dev).to(torch.bfloat16)
            gu = torch.randint(-127, 128, (h, 2 * inter), generator=g, device=dev, dtype=torch.int8)
            gs = torch.full((2 * inter,), 1.0 / (73.0 * math.sqrt(h)), device=dev)
            d = torch.randint(-127, 128, (inter, h), generator=g, device=dev, dtype=torch.int8)
            return x, gu, gs, d
        nb = m * h * 2 + 3 * h * inter + 2 * inter * 4 + m * h * 4
        nxt = rotating(make, nb)
        args = nxt()
        ref = fused_mlp_int8_plain(*args, act, clamp)
        took, got = _int8_took(fused_mlp_int8_kernel, (*args, act, clamp))
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        what = f"{act}{f' clamp {clamp:g}' if clamp else ''} m={m} h={h} i={inter}"
        if clamp:
            x, gu, gs, _ = args
            gate = (x.float() @ gu[:, :inter].float()) * gs[:inter]
            what += f" ({float((gate.abs() > clamp).float().mean()):.3f} of gate values clipped)"
        if took != ((0, 0, 0), (1, 1)):
            raise AssertionError(f"fused_mlp {what}: launched ((int8 kernels), (first, second "
                                 f"phases)) {took}, not ((0, 0, 0), (1, 1))")
        _same_twice(f"fused_mlp {what}", fused_mlp_int8_kernel, (*args, act, clamp), got)
        what += " [splits {} and {}, two kernels, bitwise stable]".format(
            *fused_mlp_splits(m, h, inter, sms))
        if m == 8 and h == 4096:  # the down scale and a bias inside the second phase
            ds = (torch.rand(h, generator=g, device=dev) + 0.5) * 0.01
            db = torch.randn(h, generator=g, device=dev)
            folded = fused_mlp_int8_kernel(*args, act, clamp, ds, db)
            if not torch.equal(folded, got * ds + db):
                raise AssertionError(f"fused_mlp {what}: the down scale and bias in the kernel "
                                     f"differ from the caller's multiply and add")
            what += " [down scale and bias in the kernel: the same bits]"
        log(f"fused_mlp {what}: max_abs_err={err:.3e} rel={rel:.2e}")
        if not rel <= TOL_MLP:
            raise AssertionError(f"fused_mlp {what}: rel err {rel} > {TOL_MLP}")
        ms = time_ms(lambda: fused_mlp_int8_kernel(*nxt(), act, clamp), 20)
        plain = time_ms(lambda: fused_mlp_int8_plain(*nxt(), act, clamp), 3)
        bnd = bound_ms(nb, 6.0 * m * h * inter)
        log(f"fused_mlp {what}: kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms=null "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add("fused_mlp", err, ms, plain, bnd, None, what, main=(m == 8 and h == 4096))
        del args, ref, got, nxt
    torch.cuda.empty_cache()


def _visible(qpos, total, window=0):
    """(visible (query, key) pairs, distinct keys each sequence's rows can
    see, summed over the sequences) of this data."""
    pairs, keys = 0, 0
    for b in range(qpos.shape[0]):
        hi = np.minimum(qpos[b], total[b] - 1)
        lo = np.maximum(qpos[b] - window + 1, 0) if window else np.zeros_like(hi)
        cnt = np.maximum(hi - lo + 1, 0)
        pairs += int(cnt.sum())
        keys += int(hi.max() - lo.min() + 1) if cnt.max() > 0 else 0
    return pairs, keys


def _attn_work(qpos, total, Hq, Hk, D, window):
    """Bytes and operations this data needs: q and the output once, each
    visible key's K and V once, 4 * D operations per visible pair and head."""
    B, S = qpos.shape
    pairs, keys = _visible(qpos, total, window)
    nbytes = B * S * Hq * D * (4 + 4) + keys * Hk * D * 2 * 2
    return nbytes, 4.0 * pairs * Hq * D


def _route(S, Hq, Hk, ring: bool = False) -> str:
    """The body an entry launches for these widths: the decode kernel, or
    past DECODE_ROWS rows a kv head the prefill body (the paged and the
    linear cache, bf16 or quantized) or the tile loop (the ring's wide
    groups)."""
    from exllamav3_tpu_torch.ops.flash_attention import attention_route
    if attention_route(S, Hq, Hk) == "decode":
        return "decode kernel"
    return "tile loop" if ring else "prefill body"


def _ms(ms, warm) -> str:
    """A time as the attention checks print it: with its L2-warm reading
    beside, where there is one."""
    if ms is None:
        return "None"
    return f"{ms:.4f}" + ("" if warm is None else f" (L2-warm {warm:.4f})")


def _body_launches(fn) -> tuple[int, int]:
    """Launches of the split-key decode kernel and of the prefill body
    that one call of fn() made, as the kernel library counts them where it
    launches each (the tile loop is not counted). Needs no profiler, which a
    host may not allow."""
    from exllamav3_tpu_torch.ops.build import library

    lib = library()
    n0 = (lib.exl3_decode_launches(), lib.exl3_prefill_launches())
    fn()
    torch.cuda.synchronize()
    return lib.exl3_decode_launches() - n0[0], lib.exl3_prefill_launches() - n0[1]


def _check_route(tag: str, rows: int, route: str, fn) -> tuple[int, int]:
    """The library's counts show that one call of fn() took `route`: one
    launch of the decode kernel or of the prefill body, or of neither (the
    tile loop)."""
    n = _body_launches(fn)
    if n != (int(route == "decode kernel"), int(route == "prefill body")):
        raise AssertionError(f"{tag}: {rows} rows a kv head made {n[0]} decode-kernel and "
                             f"{n[1]} prefill-body launches, not the {route}'s")
    return n


def check_attention(table, dev):
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (paged_attention_kernel,
                                                          paged_attention_plain)

    D = 128
    rng = np.random.default_rng(3)
    cases = []
    ctx = np.linspace(300, 2048, 8).astype(np.int32)
    cases.append(("decode B=8 ctx 300-2048", ctx[:, None] - 1, ctx, {}, True))
    # the split-key decode kernel: seven short sequences beside one of 8192
    # (their splits end early, the long one's spread), a table four times
    # wider than the longest sequence (whole splits see no key), batch 1
    # (splits of one tile fill the card), 64-wide heads (Llama-3.2-1B), and
    # the boundary: verify chunks at group 8 of 32 rows (the decode kernel)
    # and of 40 (the tile loop)
    imbalance = np.array([300] * 7 + [8192], np.int32)
    cases.append(("decode B=8, seven at ctx 300 and one at 8192", imbalance[:, None] - 1,
                  imbalance, {}, False))
    cases.append(("decode B=8 ctx 300-2048, a table of 4x the pages", ctx[:, None] - 1, ctx,
                  {"table_pages": 4 * 8}, False))
    for n in (2048, 8192):
        cases.append((f"decode B=1 ctx {n}", np.array([[n - 1]], np.int32),
                      np.array([n], np.int32), {}, False))
    cases.append(("Llama-3.2-1B heads (D=64) decode B=8 ctx 300-2048", ctx[:, None] - 1, ctx,
                  {"head_dim": 64}, False))
    for S in (4, 5):
        cases.append((f"verify S={S} B=8, group 8", ctx[:, None] - S + np.arange(S, dtype=np.int32),
                      ctx, {"kv_heads": 4}, False))
    # GQA groups that do not divide the block's 64 rows: Qwen2.5-14B/32B and
    # Qwen3-14B (40 q / 8 kv heads), Qwen2.5-1.5B (12 / 2), Qwen2.5-7B (28 / 4)
    for hq, hk in ((40, 8), (12, 2), (28, 4)):
        cases.append((f"decode B=8 ctx 300-2048, group {hq // hk}", ctx[:, None] - 1, ctx,
                      {"q_heads": hq, "kv_heads": hk}, False))
    cases.append(("verify S=5 B=8, group 7", ctx[:, None] - 5 + np.arange(5, dtype=np.int32),
                  ctx, {"q_heads": 28, "kv_heads": 4}, False))
    # Qwen3-30B-A3B: 32 q / 4 kv heads, a GQA group of 8
    cases.append(("decode B=8 ctx 300-2048, group 8", ctx[:, None] - 1, ctx, {"kv_heads": 4},
                  False))
    # the two-row body: Gemma-3-27B's global layers (32 q / 16 kv heads, a
    # group of 2), and a group of 1 (32 q / 32 kv heads, Llama-2-7B's MHA)
    for hk in (16, 32):
        cases.append((f"decode B=8 ctx 300-2048, group {32 // hk}", ctx[:, None] - 1, ctx,
                      {"kv_heads": hk}, False))
    cases.append(("prefill S=2048 on 512 cached, group 8",
                  (512 + np.arange(2048, dtype=np.int32))[None], np.array([2560], np.int32),
                  {"kv_heads": 4}, False))
    cases.append(("prefill S=2048 on 512 cached", (512 + np.arange(2048, dtype=np.int32))[None],
                  np.array([2560], np.int32), {}, True))
    # the prefill body, untimed: the 1B draft's 64-wide heads, GQA groups 1,
    # 2, 5 and 7, a chunk of 33 rows at group 1 (one past the decode route),
    # and three sequences of unequal length whose chunks start mid-page
    cases.append(("Llama-3.2-1B heads (D=64) prefill S=300 on 100 cached",
                  (100 + np.arange(300, dtype=np.int32))[None], np.array([400], np.int32),
                  {"head_dim": 64, "untimed": True}, False))
    for hq, hk in ((32, 32), (32, 16), (40, 8), (28, 4)):
        cases.append((f"prefill S=100 on 400 cached, group {hq // hk}",
                      (400 + np.arange(100, dtype=np.int32))[None], np.array([500], np.int32),
                      {"q_heads": hq, "kv_heads": hk, "untimed": True}, False))
    cases.append(("prefill S=33 from 0, group 1", np.arange(33, dtype=np.int32)[None],
                  np.array([33], np.int32), {"kv_heads": 32, "untimed": True}, False))
    three = np.array([500, 900, 1300], np.int32)
    cases.append(("prefill B=3 S=200, sequences of 500, 900 and 1300 (chunks from 300, 700, "
                  "1100)", three[:, None] - 200 + np.arange(200, dtype=np.int32), three,
                  {"untimed": True}, False))
    cases.append(("decode + sliding window 512", ctx[:, None] - 1, ctx,
                  {"sliding_window": 512}, False))
    cases.append(("decode + softcap 30", ctx[:, None] - 1, ctx, {"logit_softcap": 30.0}, False))
    cases.append(("decode + sinks", ctx[:, None] - 1, ctx, {"sinks": True}, False))
    cases.append(("prefill S=256 + window 128 + softcap + sinks, padded tail",
                  np.concatenate([700 + np.arange(200), np.full(56, 4096)]).astype(np.int32)[None],
                  np.array([900], np.int32),
                  {"sliding_window": 128, "logit_softcap": 20.0, "sinks": True}, False))
    for name, qpos, total, kw, main in cases:
        B, S = qpos.shape
        Hk = kw.pop("kv_heads", 8)
        Hq = kw.pop("q_heads", 32)
        D = kw.pop("head_dim", 128)
        untimed = kw.pop("untimed", False)
        mp = kw.pop("table_pages", int(math.ceil(total.max() / PAGE_SIZE)) + 1)
        P = B * mp + 1
        perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
        perm[:, -1] = 0  # the scratch column
        g = torch.Generator(device=dev).manual_seed(4)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        k = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        bt = torch.as_tensor(perm, device=dev)
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        args = dict(scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = paged_attention_plain(q, k, v, bt, qp, tl, **args)
        got = paged_attention_kernel(q, k, v, bt, qp, tl, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        route = _route(S, Hq, Hk)
        # the library's counts show which body the rows took
        n = _check_route(f"paged_attention {name}", S * Hq // Hk, route,
                         lambda: paged_attention_kernel(q, k, v, bt, qp, tl, **args))
        log(f"paged_attention {name}: {S * Hq // Hk} rows a kv head ran the {route} "
            f"({n[0]} decode-kernel, {n[1]} prefill-body launch)")
        row = "paged_attention_prefill" if route == "prefill body" else "paged_attention"
        if untimed:
            if not rel <= TOL_ATTN:
                raise AssertionError(f"paged_attention {name}: rel err {rel} > {TOL_ATTN}")
            log(f"paged_attention {name} (Hq={Hq} Hk={Hk} D={D}, {route}): max_abs_err={err:.3e} "
                f"rel={rel:.2e}")
            table.add(row, err, None, None, None, None, "", main=False)
            del q, k, v, ref, got
            continue
        # decode and verify (the decode kernel) over K/V rotated past L2, as
        # the main path reads its cache, the L2-warm time beside; prefill warm
        kern = lambda kv: paged_attention_kernel(q, kv["k"], kv["v"], bt, qp, tl, **args)
        if route == "decode kernel":
            ms, warm = _cold_warm(kern, {"k": k, "v": v})
        else:
            ms, warm = time_ms(lambda: kern({"k": k, "v": v}), 10), None
        plain = time_ms(lambda: paged_attention_plain(q, k, v, bt, qp, tl, **args), 2)
        lib = lib_warm = None
        if not kw:
            # SDPA over the pre-gathered contiguous K/V with the same mask,
            # timed as the kernel is
            T = mp * PAGE_SIZE
            kc = k[bt.long()].reshape(B, T, Hk, D).transpose(1, 2).contiguous()
            vc = v[bt.long()].reshape(B, T, Hk, D).transpose(1, 2).contiguous()
            kpos = torch.arange(T, device=dev)
            mask = (kpos[None, None, :] <= qp[:, :, None]) & (kpos[None, None, :] < tl[:, None, None])
            qt = q.to(torch.bfloat16).transpose(1, 2)
            sdpa = lambda kv: torch.nn.functional.scaled_dot_product_attention(
                qt, kv["k"], kv["v"], attn_mask=mask[:, None], scale=D ** -0.5, enable_gqa=True)
            if route == "decode kernel":
                lib, lib_warm = _cold_warm(sdpa, {"k": kc, "v": vc})
            else:
                lib = time_ms(lambda: sdpa({"k": kc, "v": vc}), 10)
            del kc, vc
        nb, fl = _attn_work(qpos, total, Hq, Hk, D, args["sliding_window"])
        bnd = bound_ms(nb, fl)
        log(f"paged_attention {name} (Hq={Hq} Hk={Hk} D={D}, {route}): max_abs_err={err:.3e} "
            f"rel={rel:.2e} kernel_ms={_ms(ms, warm)} plain_ms={plain:.4f} "
            f"library_ms(sdpa)={_ms(lib, lib_warm)} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        if not rel <= TOL_ATTN:
            raise AssertionError(f"paged_attention {name}: rel err {rel} > {TOL_ATTN}")
        table.add(row, err, ms, plain, bnd, lib,
                  f"{name}: B={B} S={S} Hq={Hq} Hk={Hk} D={D}", main=main, warm_ms=warm,
                  library_warm_ms=lib_warm)
        del q, k, v, ref, got
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


def _ring_rows(rng, N, W, qpos, slots, stale: int = 3):
    """(N, W) int32 positions of rings as a generator leaves them: row
    slots[b] holds its sequence's last W positions up to qpos[b] at slot
    position % W (slots of a ring still filling stay -1), then up to `stale`
    rejected speculative writes past qpos[b]; other rows hold only -1."""
    pos = np.full((N, W), -1, np.int32)
    for b, row in enumerate(slots):
        p = int(qpos[b])
        for t in range(max(0, p - W + 1), p + 1):
            pos[row, t % W] = t
        for t in range(p + 1, p + 1 + int(rng.integers(0, stale + 1))):
            pos[row, t % W] = t
    return pos


def _ring_work(pos, slots, qpos, Hq, Hk, D, window):
    """Bytes and operations of ring decode on this data: q and the output
    once, every slot's position, each visible slot's K and V once; 4 * D
    operations a visible slot and q head."""
    vis = 0
    for b, row in enumerate(slots):
        kp = pos[row]
        ok = (kp >= 0) & (kp <= qpos[b])
        if window:
            ok &= kp > qpos[b] - window
        vis += int(ok.sum())
    B = len(slots)
    nbytes = B * Hq * D * (4 + 4) + B * pos.shape[1] * 4 + vis * Hk * D * 2 * 2
    return nbytes, 4.0 * vis * Hq * D


def check_ring_attention(table, dev):
    """Row 8: decode over the SWA ring at Gemma-3-27B's shapes (batch 8, q
    positions 300-2048, so rings that have wrapped and rings still filling,
    window 1024, W = 1048, 32 q / 16 kv heads of 128), the rings in a 9-row
    state with a permuted slot table, never-written and stale slots; then
    D = 64 at GQA groups 5 and 7, sinks with a softcap of 50, a group of 40
    heads (above DECODE_ROWS: the tile loop) and a ring of W = 1041 slots (no
    multiple of 4: positions staged by 4-byte copies). Each case reads the kernel
    library's count of decode-kernel launches: 1 a call at groups up to
    DECODE_ROWS, 0 above. The Gemma-3-27B case is timed over rings rotated
    past L2, as the serve path reads them, with the L2-warm time beside."""
    from exllamav3_tpu_torch.ops.flash_attention import (ring_attention_kernel,
                                                          ring_attention_plain, ring_visible)

    rng = np.random.default_rng(21)
    qpos = np.linspace(300, 2048, 8).astype(np.int32)
    slots = np.array([3, 7, 0, 5, 8, 1, 6, 2], np.int32)
    cases = [("Gemma-3-27B decode B=8 q_pos 300-2048", (32, 16, 128), 1024, {}, True),
             ("decode B=8, D=64, group 5", (40, 8, 64), 1024, {}, False),
             ("decode B=8, D=64, group 7", (28, 4, 64), 1024, {}, False),
             ("Gemma-3-27B decode + sinks + softcap 50", (32, 16, 128), 1024,
              {"sinks": True, "logit_softcap": 50.0}, False),
             ("Gemma-2-9B-shaped decode, window 4096 (no ring wraps), softcap 50", (16, 8, 128),
              4096, {"logit_softcap": 50.0}, False),
             ("decode B=8, D=64, group 40 (the tile loop)", (40, 1, 64), 1024, {}, False),
             # W = window + 17 unrounded, no multiple of 4: rows of positions
             # that start off 16 bytes, staged by 4-byte copies
             ("Gemma-3-27B decode, W = 1041 (4-byte position copies)", (32, 16, 128), 1024,
              {"unrounded": True}, False)]
    for name, (Hq, Hk, D), window, kw, main in cases:
        W = window + 17
        if not kw.pop("unrounded", False):
            W += (-W) % 8
        N, B = 9, len(qpos)
        g = torch.Generator(device=dev).manual_seed(22)
        q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
        k = torch.randn((N, W, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((N, W, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        pos_np = _ring_rows(rng, N, W, qpos, slots)
        pos = torch.as_tensor(pos_np, device=dev)
        sl = torch.as_tensor(slots, device=dev)
        qp = torch.as_tensor(qpos[:, None], device=dev)
        args = dict(scale=168 ** -0.5, sliding_window=window,
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = ring_attention_plain(q, k, v, pos, sl, qp, **args)
        got = ring_attention_kernel(q, k, v, pos, sl, qp, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"ring_attention {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= TOL_ATTN:
            raise AssertionError(f"ring_attention {name}: rel err {rel} > {TOL_ATTN}")
        # the library's count shows which kernel the group took
        route = _route(1, Hq, Hk, ring=True)
        n = _check_route(f"ring_attention {name}", Hq // Hk, route,
                         lambda: ring_attention_kernel(q, k, v, pos, sl, qp, **args))
        kern = lambda kv: ring_attention_kernel(q, kv["k"], kv["v"], pos, sl, qp, **args)
        if main:
            ms, warm = _cold_warm(kern, {"k": k, "v": v})
        else:
            ms, warm = time_ms(lambda: kern({"k": k, "v": v}), 20), None
        plain = time_ms(lambda: ring_attention_plain(q, k, v, pos, sl, qp, **args), 3)
        lib = lib_warm = None
        if not kw and route == "decode kernel":
            # SDPA over the rings gathered by slot, with a boolean mask from pos
            kc = k[sl.long()].transpose(1, 2).contiguous()
            vc = v[sl.long()].transpose(1, 2).contiguous()
            mask = ring_visible(pos[sl.long()], qp, window)[:, None]
            qt = q.to(torch.bfloat16).transpose(1, 2)
            sdpa = lambda kv: torch.nn.functional.scaled_dot_product_attention(
                qt, kv["k"], kv["v"], attn_mask=mask, scale=168 ** -0.5, enable_gqa=True)
            if main:
                lib, lib_warm = _cold_warm(sdpa, {"k": kc, "v": vc})
            else:
                lib = time_ms(lambda: sdpa({"k": kc, "v": vc}), 20)
            del kc, vc
        bnd = bound_ms(*_ring_work(pos_np, slots, qpos, Hq, Hk, D, window))
        log(f"ring_attention {name} (Hq={Hq} Hk={Hk} D={D} N={N} W={W}, {route}: {n[0]} "
            f"decode-kernel launch): max_abs_err={err:.3e} rel={rel:.2e} "
            f"kernel_ms={_ms(ms, warm)} plain_ms={plain:.4f} library_ms(sdpa on the gathered "
            f"rings)={_ms(lib, lib_warm)} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add("ring_attention", err, ms, plain, bnd, lib,
                  f"{name}: B={B} Hq={Hq} Hk={Hk} D={D} W={W}", main=main, warm_ms=warm,
                  library_warm_ms=lib_warm)
        del q, k, v, ref, got
    torch.cuda.empty_cache()


# DeepSeek-V4's decode attention (conversion/synth.py::deepseek_v4_cfg): 128 q heads
# over one 512-wide kv row, softmax scale 512^-0.5, window 128 in a ring of 144
# slots, HCA pool entries every 128 positions (2 a 256-token page), CSA top 512
DSV4_ATTN = dict(Hq=128, D=512, window=128, ring=144, hca=128, csa=4, topk=512)


def _stats_rel(tag: str, got: tuple, ref: tuple) -> float:
    """The largest error of acc, m and l, each over the largest magnitude of
    its plain result; raises above TOL_ATTN or on a non-finite value."""
    worst = 0.0
    for what, a, b in zip(("acc", "m", "l"), got, ref):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag}: non-finite {what}")
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not rel <= TOL_ATTN:
            raise AssertionError(f"{tag}: {what} rel err {rel} > {TOL_ATTN}")
        worst = max(worst, rel)
    return worst


def _stats_library(q, k, vis, scale):
    """A callable timing SDPA over gathered rows k (B, T, 512) bf16, K and V
    alike, one kv head for all q heads, masked by vis (B, 1, T): the
    normalised output only, not the stats."""
    kk = k[:, None].contiguous()
    qt = q.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kk, kk, attn_mask=vis[:, None], scale=scale, enable_gqa=True)


def _stats_took(tag: str, fn):
    """fn() on the card, held to the library's counts: one launch of the
    latent split-key kernel (csrc/latent_decode.cuh) and none of the tile
    loop; returns fn's result."""
    from exllamav3_tpu_torch.ops.build import library

    lib = library()
    before = (lib.exl3_latent_decode_launches(), lib.exl3_tile_launches())
    got = fn()
    torch.cuda.synchronize()
    took = (lib.exl3_latent_decode_launches() - before[0], lib.exl3_tile_launches() - before[1])
    if took != (1, 0):
        raise AssertionError(f"{tag}: launched (split-key kernels, tile loops) {took}, not (1, 0)")
    return got


def _stats_bound(vis_keys: int, B: int, Hq: int, pairs: int) -> tuple:
    """Each visible key's 1024-byte row once for all heads, q in and the
    stats out once; 4 * 512 operations a visible (head, key) pair."""
    D = DSV4_ATTN["D"]
    nbytes = vis_keys * D * 2 + B * Hq * D * 2 + B * Hq * (D * 4 + 8)
    return bound_ms(nbytes, 4.0 * pairs * Hq * D)


def check_attention_stats(table, dev):
    """Row 6b at DeepSeek-V4's decode shapes, batch 8, q positions 300-2048:
    the sliding ring (9 rows, a permuted slot table, stale and never-written
    slots), the HCA pool (2 entries a page through a shuffled block table)
    and the CSA selection (512 gathered entries, the first min(visible, 512)
    of them visible); timed at 128 heads. Held, untimed, at 16 and 128
    heads: a ring still filling with up to 8 stale speculative slots, CSA
    counts that leave whole splits empty, and rows that see no key, which
    read exactly (0, -1e30, 0); and an 8192-entry pool with pages out of
    range inside the splits, at B = 1 (several tiles a split, so stages
    the gather zeroed are refilled) and at B = 32 (the split held to the
    kernel's key table). acc, m and l each against the plain version;
    every call one launch of the split-key kernel and none of the tile loop
    (the library's counts); two halves of one key range merged with sinks
    by merge_stats equal the single shot."""
    from exllamav3_tpu_torch.ops import flash_attention as F

    a = DSV4_ATTN
    Hq, D, scale = a["Hq"], a["D"], a["D"] ** -0.5
    rng = np.random.default_rng(31)
    qpos = np.linspace(300, 2048, 8).astype(np.int32)
    B = len(qpos)
    g = torch.Generator(device=dev).manual_seed(32)
    q = (torch.randn((B, 1, Hq, D), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    qp = torch.as_tensor(qpos[:, None], device=dev)

    # the ring
    N, W = 9, a["ring"]
    slots = np.array([3, 7, 0, 5, 8, 1, 6, 2], np.int32)
    pos_np = _ring_rows(rng, N, W, qpos, slots)
    ring = torch.randn((N, W, D), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.as_tensor(pos_np, device=dev)
    sl = torch.as_tensor(slots, device=dev)
    # the HCA pool: entry e of sequence b is slot e % 2 of page bt[b, e // 2]
    epp = 256 // a["hca"]
    mp = -(-int(qpos.max() + 1) // 256) + 1
    P = B * mp + 1
    bt_np = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    bt = torch.as_tensor(bt_np, device=dev)
    pool = torch.randn((P, epp, D), generator=g, device=dev).to(torch.bfloat16)
    n_pool = (qpos + 1) // a["hca"]
    # the CSA selection: 512 entries gathered a sequence, the first vcount visible
    K = a["topk"]
    vcount = np.minimum((qpos + 1) // a["csa"], K).astype(np.int32)
    sel = torch.randn((B, K, D), generator=g, device=dev).to(torch.bfloat16)

    def entries(n_):
        """(q positions (B, 1), lengths (B,)) of n_ visible entries each"""
        return (torch.as_tensor((n_ - 1)[:, None].astype(np.int32), device=dev),
                torch.as_tensor(n_.astype(np.int32), device=dev))

    pq, pt = entries(n_pool)
    rq, rt = entries(vcount)
    kpos = torch.arange(K, device=dev)
    ring_vis = F.ring_visible(pos[sl.long()], qp, a["window"])
    pool_keys, _ = F._pool_keys(pool, bt)
    cases = [
        ("ring_attention_stats", "sliding ring, W=144, window 128",
         lambda: F.ring_attention_stats_kernel(q, ring, pos, sl, qp, scale, a["window"]),
         lambda: F.ring_attention_stats_plain(q, ring, pos, sl, qp, scale, a["window"]),
         _stats_library(q, ring[sl.long()], ring_vis, scale),
         _stats_bound(int(ring_vis.sum()), B, Hq, int(ring_vis.sum()))),
        ("pool_attention_stats", f"HCA pool, {epp} entries a page, shuffled table, "
         f"{int(n_pool.min())}-{int(n_pool.max())} entries",
         lambda: F.pool_attention_stats_kernel(q, pool, bt, pq, pt, scale),
         lambda: F.pool_attention_stats_plain(q, pool, bt, pq, pt, scale),
         _stats_library(q, pool_keys, torch.arange(pool_keys.shape[1], device=dev)[None, None]
                        < pt[:, None, None], scale),
         _stats_bound(int(n_pool.sum()), B, Hq, int(n_pool.sum()))),
        ("rows_attention_stats", f"CSA top {K} gathered, {int(vcount.min())}-{int(vcount.max())} "
         f"visible",
         lambda: F.rows_attention_stats_kernel(q, sel, rq, rt, scale),
         lambda: F.rows_attention_stats_plain(q, sel, rq, rt, scale),
         _stats_library(q, sel, kpos[None, None] < rt[:, None, None], scale),
         _stats_bound(int(vcount.sum()), B, Hq, int(vcount.sum()))),
    ]
    for name, what, kern, plain_fn, lib_fn, bnd in cases:
        ref = plain_fn()
        got = _stats_took(f"{name} {what}", kern)
        rel = _stats_rel(f"{name} {what}", got, ref)
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        ms = time_ms(kern, 20)
        plain = time_ms(plain_fn, 3)
        lib = time_ms(lib_fn, 20)
        log(f"{name} DeepSeek-V4 decode B={B} Hq={Hq} D={D}, {what}: max_abs_err={err:.3e} "
            f"rel={rel:.2e} kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(sdpa on the "
            f"gathered rows; normalised output only)={lib:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(name, err, ms, plain, bnd, lib, f"DeepSeek-V4 decode B={B} Hq={Hq} D={D}, {what}",
                  main=True)

    # untimed, at 16 and 128 heads: rows that see no key (an empty pool at
    # positions below 127, no selection), CSA counts that leave whole splits
    # empty, and a ring still filling (never-written slots) with up to 8
    # stale speculative slots
    low = np.array([100, 20, 126, 127, 300, 5, 64, 0], np.int32)
    n_low = (low + 1) // a["hca"]
    lq, lt = entries(n_low)
    empty = torch.as_tensor(n_low == 0, device=dev)
    cq, ct = entries(np.array([1, 40, 64, 65, 130, 200, 0, 512], np.int32))
    fill = np.array([5, 60, 143, 144, 200, 1000, 0, 90], np.int32)
    fq = torch.as_tensor(fill[:, None], device=dev)
    fpos = torch.as_tensor(_ring_rows(rng, N, W, fill, slots, stale=8), device=dev)
    for heads in (16, Hq):
        qh = q[:, :, :heads].contiguous()
        for name, what, args in (
                ("pool_attention_stats", "rows that see no key", (qh, pool, bt, lq, lt, scale)),
                ("rows_attention_stats", "rows that see no key", (qh, sel, lq, lt, scale)),
                ("rows_attention_stats", "whole splits empty", (qh, sel, cq, ct, scale)),
                ("ring_attention_stats", "a ring still filling, stale slots",
                 (qh, ring, fpos, sl, fq, scale, a["window"]))):
            tag = f"{name} {heads} heads, {what}"
            got = _stats_took(tag, lambda: getattr(F, name + "_kernel")(*args))
            ref = getattr(F, name + "_plain")(*args)
            rel = _stats_rel(tag, got, ref)
            err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
            table.add(name, err, None, None, None, None, "", main=False)
            if what == "rows that see no key":
                acc, m, l = got
                if not ((acc[empty] == 0).all() and (m[empty] == F.NEG_INF).all()
                        and (l[empty] == 0).all()):
                    raise AssertionError(f"{tag}: a row that sees no key is not (0, -1e30, 0)")
                what += f": {int(empty.sum())} of them read exactly (0, -1e30, 0)"
            log(f"{name} {heads} heads, {what}: rel={rel:.2e}")

    # untimed, over the HCA pool of the published 1M-token context (8192
    # entries) with pages out of range inside the splits: at B = 1 and 16
    # heads a split walks several 64-key tiles over 2 stages, so a stage
    # whose rows the gather zeroed is refilled by bulk copies; at B = 32 and
    # 128 heads the grid alone would ask for splits wider than the kernel's
    # key table, and the sizing holds them to it
    t0 = time.time()
    sms = F.device_sms(dev)
    wide_mp = 8192 // epp
    wide_pool = torch.randn((wide_mp + 1, epp, D), generator=g, device=dev).to(torch.bfloat16)
    for wb, heads in ((1, 16), (32, Hq)):
        split = F.latent_split_keys(wide_mp * epp, wb, heads, sms, True)
        tk = 64 if heads <= F.LATENT_ROWS else 32  # the header's LAT_TK_BF16(_SLICES)
        if split // tk < 3:
            raise AssertionError(f"pool_attention_stats B={wb}: a split of {split} reuses no stage")
        if wb > 1 and not (split == F.LATENT_TABLE_KEYS
                           < F.latent_split_keys(wide_mp * epp, wb, heads, sms)):
            raise AssertionError(f"pool_attention_stats B={wb}: the split {split} is not the "
                                 f"table's cap")
        wt = np.stack([rng.permutation(np.arange(1, wide_mp + 1)) for _ in range(wb)]).astype(np.int32)
        wt[:, ::37] = -1
        wt[:, 5::53] = wide_mp + 1
        wpos = np.linspace(8191, 6000, wb).astype(np.int32)
        wq, wl = torch.as_tensor(wpos[:, None], device=dev), torch.as_tensor(wpos + 1, device=dev)
        qw = (torch.randn((wb, 1, heads, D), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        args = (qw, wide_pool, torch.as_tensor(wt, device=dev), wq, wl, scale)
        tag = f"pool_attention_stats B={wb} {heads} heads, 8192 entries, pages out of range"
        got = _stats_took(tag, lambda: F.pool_attention_stats_kernel(*args))
        ref = F.pool_attention_stats_plain(*args)
        rel = _stats_rel(tag, got, ref)
        table.add("pool_attention_stats", max(float((x - y).abs().max()) for x, y in zip(got, ref)),
                  None, None, None, None, "", main=False)
        log(f"{tag}: splits of {split} ({split // tk} tiles), rel={rel:.2e}")
        del got, ref
    del wide_pool
    log(f"attention_stats: the 8192-entry pool cases took {time.time() - t0:.1f} s")

    # two halves of the CSA selection, merged with sinks, against the single shot
    sinks = torch.randn(Hq, generator=g, device=dev) * 0.5
    h = K // 2
    one = _stats_took("rows_attention_stats", lambda: F.rows_attention_stats_kernel(
        q, sel, rq, rt, scale))
    lo = _stats_took("rows_attention_stats, first half", lambda: F.rows_attention_stats_kernel(
        q, sel[:, :h].contiguous(), rq, torch.clamp(rt, max=h), scale))
    hi = _stats_took("rows_attention_stats, second half", lambda: F.rows_attention_stats_kernel(
        q, sel[:, h:].contiguous(), rq - h, torch.clamp(rt - h, min=0), scale))
    merged, single = F.merge_stats([lo, hi], sinks), F.merge_stats([one], sinks)
    ref = F.merge_stats([F.rows_attention_stats_plain(q, sel, rq, rt, scale)], sinks)
    for tag, x in (("merged halves against the single shot", merged),
                   ("single shot against the plain version", single)):
        rel = float((x - (single if x is merged else ref)).abs().max()) / float(ref.abs().max())
        log(f"rows_attention_stats: {tag}, with sinks: rel={rel:.2e}")
        if not rel <= TOL_ATTN:
            raise AssertionError(f"rows_attention_stats: {tag}: rel err {rel} > {TOL_ATTN}")
    del q, ring, pool, sel, pool_keys
    torch.cuda.empty_cache()


SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*;")
SASS_MEMORY = {"LDS", "LDSM", "LDG", "LD", "LDC", "STS", "STG", "ST"}
SASS_CONTROL = {"BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BAR", "WARPSYNC",
                "NOP", "DEPBAR"}


def sass_loop(library: str, symbol: str, row_blocks: int = 1):
    """(instructions a weight, {opcode: count}, the span's lines) of the trellis
    GEMM's decode loop in kernel `symbol` (a fragment of its mangled name) of
    the library at path `library`, or None where the toolkit has no cuobjdump
    or the loop is not found. The loop is the shortest backward-branch span
    that holds a tensor-core instruction. A lane decodes 8 weights of a 16 x
    16 tile into the B fragments of two MMAs for each of the span's
    `row_blocks` 16-row blocks, so the span decodes 4 * HMMA / row_blocks
    weights a lane. Counted are the span's instructions other than
    tensor-core, memory and control ones: a static count, so a span that
    holds the A-fragment arithmetic of 8 row blocks counts all of it, also
    where a block runs only the first."""
    import exllamav3_tpu_torch.ops.build as kbuild

    tool = os.path.join(os.path.dirname(kbuild.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log("exl3_gemm decode count: no cuobjdump beside nvcc; not measured")
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    instrs, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = symbol in line
        elif inside:
            mt = SASS_LINE.match(line)
            if mt:
                instrs.append((int(mt.group(1), 16), mt.group(2), line.strip()))
    spans = []
    for addr, op, text in instrs:
        target = re.search(r"\b0x([0-9a-f]+)\s*;", text)
        if op == "BRA" and target and int(target.group(1), 16) <= addr:
            body = [i for i in instrs if int(target.group(1), 16) <= i[0] <= addr]
            if any(i[1] == "HMMA" for i in body):
                spans.append(body)
    if not spans:
        log(f"exl3_gemm decode count: no loop with HMMA found in {symbol}; not measured")
        return None
    body = min(spans, key=len)
    hist: dict = {}
    for _, op, _ in body:
        hist[op] = hist.get(op, 0) + 1
    alu = sum(n for op, n in hist.items()
              if op != "HMMA" and op not in SASS_MEMORY and op not in SASS_CONTROL)
    weights = 4 * hist["HMMA"] / row_blocks
    log(f"exl3_gemm decode count: {symbol}: the loop holds {len(body)} instructions, "
        f"{hist['HMMA']} HMMA over {row_blocks} row blocks ({weights:g} weights a lane), "
        f"{alu} neither tensor-core, memory nor control: {alu / weights:.3f} a weight; "
        + json.dumps(dict(sorted(hist.items()))))
    return alu / weights, hist, [i[2] for i in body]


def decode_dispatch_estimate(K: int = 4, cb: int = 0):
    """(thread instructions per decoded weight, thread instructions the card
    dispatches a second), read from this build and this card, or None where the
    toolkit has no cuobjdump or the loop is not found.

    Counts (sass_loop) the decode-size body of the kernel,
    exl3_gemm_kernel<K, cb, 1, GEMM_STAGES> (one 16-row block), whose loop is
    a whole unrolled k step. The 128-row body, exl3_gemm_kernel<K, cb, 8,
    PREFILL_STAGES>, is counted beside it by the same rule: its loop holds the
    A-fragment arithmetic of 8 row blocks, as the single-stage kernel's tile loop did
    (tools/torch_gemm_phases.py counts another tree's kernel so). The rate is
    SMs x 4 schedulers x 32 lanes x the card's highest SM clock."""
    import exllamav3_tpu_torch.ops.build as kbuild
    from exllamav3_tpu_torch.ops.exl3_gemm import _PREFILL_MB, _PREFILL_STAGES, _STAGES

    lib = str(kbuild.build())
    got = sass_loop(lib, f"exl3_gemm_kernelILi{K}ELi{cb}ELi1ELi{_STAGES}EE")
    if got is None:
        return None
    per_weight, _, body = got
    with open(os.path.join(WORK, f"exl3_gemm_K{K}_cb{cb}_loop.sass"), "w") as f:
        f.write("\n".join(body) + "\n")
    sass_loop(lib, f"exl3_gemm_kernelILi{K}ELi{cb}ELi{_PREFILL_MB}ELi{_PREFILL_STAGES}EE",
              row_blocks=_PREFILL_MB)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.split()[0])
    rate = torch.cuda.get_device_properties(0).multi_processor_count * LANES_PER_SM_CLOCK * mhz * 1e6
    log(f"exl3_gemm decode estimate: K={K} cb={cb} decode-size body {per_weight:.3f} "
        f"instructions a weight; dispatch rate {rate:.4e} thread instructions/s "
        f"(max SM clock {mhz:.0f} MHz)")
    return per_weight, rate


def _gemm_launches(fn) -> int:
    """Kernel launches that one call of fn() made in the trellis GEMM's
    source, as the kernel library counts them where it launches."""
    from exllamav3_tpu_torch.ops.build import library

    lib = library()
    n0 = lib.exl3_gemm_launches()
    fn()
    torch.cuda.synchronize()
    return lib.exl3_gemm_launches() - n0


def check_exl3_gemm(table, dev):
    """Row 9 at every K and codebook (m = 8, 4096 x 4096), then K = 4 3INST
    timed over inputs rotated past L2 at the five Llama-3.1-8B shapes at m =
    1, 8 and 128 and two prefill shapes at m = 2048. Every case is held to
    TOL_EXL3, to one device kernel a call (the library's launch count) and
    to the blocks an SM that the host's sizing reckons with (the library's
    occupancy reading)."""
    from exllamav3_tpu_torch.ops.build import library
    from exllamav3_tpu_torch.ops.exl3_gemm import (_blocks_per_sm, exl3_gemm_kernel,
                                                    exl3_gemm_plain, launch_plan)

    est = decode_dispatch_estimate()

    shapes = [(4096, 4096, "q/o_proj"), (4096, 1024, "k/v_proj"), (4096, 14336, "gate/up"),
              (14336, 4096, "down"), (4096, 32768, "lm_head")]
    cases = [(8, 4096, 4096, K, cb, f"K={K} cb={cb}") for K in range(1, 9) for cb in range(3)
             if (K, cb) != (4, 0)]
    cases += [(m, k, n, 4, 0, what) for m in (1, 8, 128) for k, n, what in shapes]
    cases += [(2048, 4096, 4096, 4, 0, "q/o_proj prefill"),
              (2048, 4096, 14336, 4, 0, "gate/up prefill")]
    g = torch.Generator(device=dev).manual_seed(7)
    for m, k, n, K, cb, what in cases:
        def make(i, m=m, k=k, n=n, K=K):
            xh = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            w = torch.randint(-2**31, 2**31, (k // 16, K, n // 2), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
            return xh, w
        nb = m * k * 2 + k * n * K // 8 + m * n * 4
        timed = K == 4 and cb == 0
        nxt = rotating(make, nb) if timed else (lambda made=make(0): made)
        xh, w = nxt()
        ref = exl3_gemm_plain(xh, w, K, cb)
        got = exl3_gemm_kernel(xh, w, K, cb)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"exl3_gemm m={m} {what}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= TOL_EXL3:
            raise AssertionError(f"exl3_gemm m={m} {what} ({k}x{n}): rel err {rel} > {TOL_EXL3}")
        launches = _gemm_launches(lambda: exl3_gemm_kernel(xh, w, K, cb))
        if launches != 1:
            raise AssertionError(f"exl3_gemm m={m} {what}: {launches} device kernels a call, "
                                 f"not 1")
        # the host's sizing reckons with the blocks an SM that the card reports
        splits, blocks, _, _ = launch_plan(m, k, n, K, dev)
        per_sm = library().exl3_gemm_blocks_per_sm(m, k, n, K, cb, splits)
        model = _blocks_per_sm(m, K, -(-(k // 128) // splits))
        if per_sm != model:
            raise AssertionError(f"exl3_gemm m={m} {what} K={K}: the card holds {per_sm} blocks "
                                 f"an SM, the sizing reckons with {model}")
        if not timed:
            log(f"exl3_gemm m={m} {what} ({k}x{n}): {splits} splits, {per_sm} blocks an SM; "
                f"max_abs_err={err:.3e} rel={rel:.2e}")
            table.add("exl3_gemm", err, None, None, None, None, "", main=False)
            continue
        calls = 5 if m == 2048 else 20
        ms = time_ms(lambda: exl3_gemm_kernel(*nxt(), K, cb), calls)
        plain = time_ms(lambda: exl3_gemm_plain(*nxt(), K, cb), 2)
        # yardstick: cuBLAS bf16 GEMM on the decoded weight (2 bytes a weight)
        from exllamav3_tpu_torch.ops.exl3_gemm import words_to_trellis
        from exllamav3_tpu_torch.quant.reconstruct import reconstruct_inner
        wd = reconstruct_inner(words_to_trellis(w), K, cb, dtype=torch.bfloat16)
        nxt_lib = rotating(lambda i: (xh, wd.clone()), m * k * 2 + k * n * 2 + m * n * 2)
        lib = time_ms(lambda: torch.matmul(*nxt_lib()), calls)
        bnd = bound_ms(nb, 2.0 * m * k * n)
        # not a bound: the time to dispatch the decode's instructions, once per
        # weight and 128-row block, were nothing else in the way
        t_dec = (None if est is None
                 else k * n * math.ceil(m / 128) * est[0] / est[1] * 1e3)
        log(f"exl3_gemm m={m} {what} ({k}x{n}) K={K}: {splits} splits, {blocks} blocks, "
            f"{per_sm} blocks an SM, 1 device kernel a call; max_abs_err={err:.3e} rel={rel:.2e} "
            f"kernel_ms={ms:.4f} plain_ms(reconstruct + matmul)={plain:.4f} "
            f"library_ms(torch.matmul bf16 on the decoded weight)={lib:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]}) decode_est_ms="
            + ("not measured" if t_dec is None else f"{t_dec:.4f}"))
        table.add("exl3_gemm", err, ms, plain, bnd, lib, f"m={m} k={k} n={n} K={K}",
                  main=(m == 8 and what == "q/o_proj"), decode_est_ms=t_dec)
        del xh, w, ref, got, nxt, nxt_lib, wd
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


PACKED = ("int4_matmul", "int4_matmul_a8", "intb_matmul", "intb_matmul_a8")
SHAPES_8B = [(4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
             (14336, 4096, "down"), (4096, 32768, "lm_head")]
SHAPES_70B = [(8192, 10240, "70B qkv"), (8192, 8192, "70B o_proj"), (8192, 57344, "70B gate_up"),
              (28672, 8192, "70B down")]


def _intb_launches() -> tuple:
    """The int-B library's launches so far: (products, row quantizers,
    split-k reduce kernels), as csrc/intb_matmul.cu counts them."""
    from exllamav3_tpu_torch.ops.build import library

    return tuple(library().exl3_intb_launches(kind) for kind in range(3))


def _int4_launches() -> tuple:
    """The int4 library's launches so far: (packed_matmul.cuh's products, row
    quantizers, split-k reduce kernels, staged products), as
    csrc/int4_matmul.cu counts them."""
    from exllamav3_tpu_torch.ops.build import library

    return tuple(library().exl3_int4_launches(kind) for kind in range(4))


def _packed_took(kernel, args) -> tuple:
    """The kernels one call of kernel(*args) launched, by the library's counts
    of its source (int-B or int4)."""
    counts = _int4_launches if kernel.__name__.startswith("int4") else _intb_launches
    before = counts()
    kernel(*args)
    torch.cuda.synchronize()
    return tuple(b - a for a, b in zip(before, counts()))


def check_packed(table, dev, name: str):
    """One of the four packed-integer kernels against its plain version on the
    card: the 8B shapes at m = 1, 8, 128, 2048 and the 70B shapes at m = 8;
    int-B at B = 3, 4, 5, 6, and qkv at m = 13 (ragged rows on both 8-row
    tiles; both int4 routes too). Timed: the int4 kernels everywhere, the
    int-B kernels at B = 6 (the ladder's rung) and at every B at m = 8 qkv;
    the other widths are held to the tolerance only. Every case is also
    held to the kernels it launched (the library's counts): every route up
    to 16 rows one staged product kernel a call, after the row quantizer on
    the a8 routes, and no split-k reduce kernel; above, packed_matmul.cuh's
    product, the quantizer (a8) and the reduce where k splits. Up to 16 rows
    the card's blocks an SM of a staged body must equal the sizing's. x is
    bf16, as the model's activations are."""
    import exllamav3_tpu_torch.ops.q_matmul as qm
    from exllamav3_tpu_torch.ops.build import library

    a8 = name.endswith("_a8")
    kernel, plain = getattr(qm, name + "_kernel"), getattr(qm, name + "_plain")
    g = torch.Generator(device=dev).manual_seed(11)
    cases = [(m, *shape) for m in (1, 8, 128, 2048) for shape in SHAPES_8B]
    cases += [(8, *shape) for shape in SHAPES_70B]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bits in ((None,) if name.startswith("int4") else (6, 3, 4, 5)):
        extra = () if bits is None else (bits,)
        for m, k, n, what in cases + [(13, *SHAPES_8B[0])]:
            if bits is None:
                prows, srows, dt, lo, hi = k // 2, k // 32, torch.int8, -128, 128
            else:
                W, prows, k_pad = qm.intb_geometry(k, bits)
                srows, dt, lo, hi = k_pad // 32, torch.int32, -2**31, 2**31

            def make(i, m=m, k=k, n=n, prows=prows, srows=srows, dt=dt, lo=lo, hi=hi):
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                w = torch.randint(lo, hi, (prows, n), generator=g, device=dev,
                                  dtype=torch.int64).to(dt)
                s = ((torch.rand((srows, n), generator=g, device=dev) + 0.5) * 0.01).to(torch.bfloat16)
                return x, w, s
            nb = m * k * 2 + prows * n * (1 if bits is None else 4) + srows * n * 2 + m * n * 4
            timed = (bits in (None, 6) and m != 13) or (m == 8 and what == "qkv")
            nxt = rotating(make, nb) if timed else (lambda made=make(0): made)
            x, w, s = nxt()
            ref = plain(x, w, s, *extra)
            got = kernel(x, w, s, *extra)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} m={m} {what}: non-finite output")
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            tag = f"{name}{'' if bits is None else f' B={bits}'} m={m} {what} ({k}x{n})"
            if not rel <= TOL_PACKED:
                raise AssertionError(f"{tag}: rel err {rel} > {TOL_PACKED}")
            # the kernels one call launched, and at decode sizes the blocks an SM
            took = _packed_took(kernel, (x, w, s, *extra))
            if bits is None:
                if m <= qm.INT4_DECODE_ROWS:
                    splits = qm.int4_split_count(m, k, n, sms, a8)
                    want = (0, int(a8), 0, 1)
                    per_sm = library().exl3_int4_blocks_per_sm(m, k, n, int(a8), splits)
                    model = qm._int4_blocks_per_sm(
                        m, -(-(k // 2 // qm.INT4_STEP_ROWS) // splits), a8)
                    if per_sm != model:
                        raise AssertionError(f"{tag}: the card holds {per_sm} blocks an SM, the "
                                             f"sizing reckons with {model}")
                    tag += f" [{splits} splits, {per_sm} blocks an SM]"
                else:
                    splits = qm._packed_splits(m, n, k // 64, True, dev)
                    want = (1, int(a8), int(splits > 1), 0)
                    tag += f" [{splits} splits]"
                if took != want:
                    raise AssertionError(f"{tag}: launched (packed_matmul.cuh products, "
                                         f"quantizers, reduces, staged products) {took}, not {want}")
                tag += f" launches a call {took}"
            else:
                if m <= qm.INTB_DECODE_ROWS:
                    splits = qm.intb_split_count(m, k, n, bits, a8, sms)
                    want = (1, int(a8), 0)
                    per_sm = library().exl3_intb_blocks_per_sm(m, k, n, bits, int(a8), splits)
                    model = qm._intb_blocks_per_sm(m, bits, a8, -(-(prows // 32) // splits))
                    if per_sm != model:
                        raise AssertionError(f"{tag}: the card holds {per_sm} blocks an SM, the "
                                             f"sizing reckons with {model}")
                    tag += f" [{splits} splits, {per_sm} blocks an SM]"
                else:
                    splits = qm._packed_splits(m, n, prows // 32, False, dev)
                    want = (1, int(a8), int(splits > 1))
                    tag += f" [{splits} splits]"
                if took != want:
                    raise AssertionError(f"{tag}: launched (products, quantizers, reduces) {took}, "
                                         f"not {want}")
                tag += f" launches a call {took}"
            if not timed:
                log(f"{tag}: max_abs_err={err:.3e} rel={rel:.2e}")
                table.add(name, err, None, None, None, None, "", main=False)
                del x, w, s, ref, got, nxt
                continue
            calls = 5 if m == 2048 else 20
            ms = time_ms(lambda: kernel(*nxt(), *extra), calls)
            plain_t = time_ms(lambda: plain(*nxt(), *extra), 2)
            # yardstick: cuBLAS bf16 GEMM on the dequantized weight (2 bytes a weight)
            wd = (qm.int4_unpack(w, s) if bits is None
                  else qm.intb_unpack(w, s, bits, k)).to(torch.bfloat16)
            nxt_lib = rotating(lambda i: (x, wd.clone()), m * k * 2 + k * n * 2 + m * n * 2)
            lib = time_ms(lambda: torch.matmul(*nxt_lib()), calls)
            bnd = bound_ms(nb, 2.0 * m * k * n, INT8_OP_PER_S if a8 else BF16_FLOP_PER_S)
            log(f"{tag}: max_abs_err={err:.3e} rel={rel:.2e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_t:.4f} library_ms(torch.matmul bf16 on the decoded weight)="
                f"{lib:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
            table.add(name, err, ms, plain_t, bnd, lib,
                      f"m={m} k={k} n={n}" + ("" if bits is None else f" B={bits}"),
                      main=(m == 8 and what == "qkv" and bits in (None, 6)))
            del x, w, s, ref, got, nxt, nxt_lib, wd
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()


# (name, h, i, E, k, token counts) from the published configs
# (name, h, i, E, k, tokens, activation clamps): DeepSeek-V4's experts at
# DeepSeek-V3's widths and its swiglu_limit of 10, and at a limit of 1 that
# clips this data's activations often
MOE_SHAPES = [("Qwen3-30B-A3B", 2048, 768, 128, 8, (1, 8, 15), (0.0,)),
              ("Qwen3-235B-A22B", 4096, 1536, 128, 8, (8,), (0.0,)),
              ("Mixtral-8x7B", 4096, 14336, 8, 2, (1, 8), (0.0,)),
              ("DeepSeek-V2-Lite", 2048, 1408, 64, 6, (1, 8), (0.0,)),
              ("DeepSeek-V4", 7168, 2048, 256, 8, (1, 8), (10.0, 1.0))]


def _moe_routing(rng, T, E, k, dev):
    """Seeded routing that puts several tokens on the same experts: each
    token draws k distinct experts with weights skewed toward a few, as a
    trained router's load is; routing weights positive, summing to 1."""
    p = rng.pareto(1.0, E) + 0.05
    p /= p.sum()
    topi = np.stack([rng.choice(E, k, replace=False, p=p) for _ in range(T)]).astype(np.int32)
    topv = rng.random((T, k)).astype(np.float32) + 0.1
    topv /= topv.sum(-1, keepdims=True)
    return torch.as_tensor(topi, device=dev), torch.as_tensor(topv, device=dev)


def moe_library(x, groups, topv, wg, wu, wd, clamp: float = 0.0):
    """The same routed function from PyTorch products, as the grouped path
    computes it: for each distinct routed expert, its tokens times its three
    bf16 weights (cuBLAS), the activation rounded to bf16, the weighted rows
    added into the output. `groups` is [(expert, token rows, slot rows)],
    made on the host beforehand."""
    from exllamav3_tpu_torch.ops.moe_gemm import silu_mul

    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    flat_v = topv.reshape(-1)
    for e, rows, slots in groups:
        xe = x[rows]
        a = silu_mul(torch.matmul(xe, wg[e]).float(), torch.matmul(xe, wu[e]).float(),
                     clamp).to(torch.bfloat16)
        out.index_add_(0, rows, torch.matmul(a, wd[e]).float() * flat_v[slots, None])
    return out


def check_moe_gemm(table, dev):
    from exllamav3_tpu_torch.ops.moe_gemm import (selected_expert_mlp_kernel,
                                                  selected_expert_mlp_plain)

    rng = np.random.default_rng(13)
    g = torch.Generator(device=dev).manual_seed(13)
    for name, h, inter, E, k, Ts, clamps in MOE_SHAPES:
        def weights(shape, fan_in):
            w = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
            return w.mul_(1.0 / math.sqrt(fan_in))
        wg = weights((E, h, inter), h)
        wu = weights((E, h, inter), h)
        wd = weights((E, inter, h), inter)
        for T, clamp in ((T, c) for T in Ts for c in clamps):
            # several routings in turn, so that timed calls read other experts
            # than the call before, as consecutive layers do
            sets = []
            for _ in range(8):
                x = torch.randn((T, h), generator=g, device=dev).to(torch.bfloat16)
                topi, topv = _moe_routing(rng, T, E, k, dev)
                ti = topi.cpu().numpy()
                groups = [(int(e), torch.as_tensor(np.nonzero(ti == e)[0], device=dev),
                           torch.as_tensor(np.flatnonzero(ti == e), device=dev))
                          for e in np.unique(ti)]
                sets.append((x, topi, topv, groups, len(groups)))
            x, topi, topv, groups, distinct = sets[0]
            ref = selected_expert_mlp_plain(x, topi, topv, wg, wu, wd, clamp)
            got = selected_expert_mlp_kernel(x, topi, topv, wg, wu, wd, clamp)
            torch.cuda.synchronize()
            name_c = f"{name} clamp {clamp:g}" if clamp else name
            if not torch.isfinite(got).all():
                raise AssertionError(f"moe_gemm {name_c} T={T}: non-finite output")
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            rel_range = err / float(ref.max() - ref.min())
            lib_err = float((moe_library(x, groups, topv, wg, wu, wd, clamp) - ref).abs().max())
            state = {"i": 0}

            def nxt():
                state["i"] += 1
                return sets[state["i"] % len(sets)]
            ms = time_ms(lambda: selected_expert_mlp_kernel(*nxt()[:3], wg, wu, wd, clamp), 20)
            plain = time_ms(lambda: selected_expert_mlp_plain(*nxt()[:3], wg, wu, wd, clamp), 2)

            def lib_call():
                xs, _, tv, grp, _ = nxt()
                return moe_library(xs, grp, tv, wg, wu, wd, clamp)
            lib = time_ms(lib_call, 5)
            # the distinct experts each routing reads, averaged over the timed sets
            n_dist = float(np.mean([s[4] for s in sets]))
            nb = n_dist * 3 * h * inter * 2 + T * h * 2 + T * k * 8 + T * h * 4
            bnd = bound_ms(nb, 6.0 * T * k * h * inter)
            log(f"moe_gemm {name_c} T={T} (h={h} i={inter} E={E} k={k}, {distinct} distinct "
                f"experts in the checked routing, {n_dist:.2f} on average): max_abs_err={err:.3e} "
                f"rel={rel:.2e}, {rel_range:.2e} of the range (library vs plain {lib_err:.3e}) "
                f"kernel_ms={ms:.4f} "
                f"plain_ms={plain:.4f} library_ms(torch.matmul per distinct expert)={lib:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if not rel_range <= TOL_MOE:
                raise AssertionError(f"moe_gemm {name_c} T={T}: err {rel_range} of the range "
                                     f"> {TOL_MOE}")
            table.add("moe_gemm", err, ms, plain, bnd, lib,
                      f"{name_c} T={T} h={h} i={inter} E={E} k={k}, {n_dist:.2f} distinct experts",
                      main=(name == "Qwen3-30B-A3B" and T == 8))
            del sets, x, topi, topv, groups, ref, got
        del wg, wu, wd
        torch.cuda.empty_cache()


def _quant_attn_work(qpos, total, Hq, Hk, D, window, k_bits, v_bits):
    """As _attn_work, with each visible key costing its packed words and its
    two rows of bf16 scales."""
    B, S = qpos.shape
    pairs, keys = _visible(qpos, total, window)
    per_key = Hk * (D * (k_bits + v_bits) // 8 + 2 * (D // 32) * 2)
    return B * S * Hq * D * 8 + keys * per_key, 4.0 * pairs * Hq * D


def _cold_warm(fn, first, make=None, nbytes=None, warm=True) -> tuple[float, float | None]:
    """(ms of fn over input sets that cycle past the 50 MB L2 cache, as the
    main path reads a cache, ms of fn over `first` alone, L2-warm, or None
    when not asked). By default the sets are `first` (a dict of tensors) and
    copies of it."""
    if make is None:
        make = lambda i: first if i == 0 else {n: t.clone() for n, t in first.items()}
        nbytes = sum(t.numel() * t.element_size() for t in first.values())
    nxt = rotating(make, nbytes)
    return time_ms(lambda: fn(nxt()), 10), time_ms(lambda: fn(first), 10) if warm else None


def check_attention_quant(table, dev):
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (paged_attention_quant_kernel,
                                                          paged_attention_quant_plain)
    from exllamav3_tpu_torch.ops.kv_quant import (dequantize_kv_stored, merged_layout,
                                                   quantize_kv_stored)

    rng = np.random.default_rng(8)
    ctx = np.linspace(300, 2048, 8).astype(np.int32)
    decode = (ctx[:, None] - 1, ctx)
    prefill = ((512 + np.arange(2048, dtype=np.int32))[None], np.array([2560], np.int32))
    cases = []
    # GQA groups 5, 6 and 7 (the heads of Qwen2.5-14B, -1.5B and -7B)
    for (hq, hk), bits in (((40, 8), (4, 4)), ((12, 2), (5, 3)), ((28, 4), (4, 4)),
                           ((28, 4), (5, 3))):
        cases.append((f"decode B=8 ctx 300-2048 bits={bits}, group {hq // hk}", *decode, bits,
                      0.0, {"q_heads": hq, "kv_heads": hk}, False))
    for bits in [(4, 4), (8, 8), (2, 2), (5, 3), (6, 6), (3, 7)]:
        for a in (0.0, 0.65):
            cases.append((f"decode B=8 ctx 300-2048 bits={bits} compand_a={a}", *decode, bits, a,
                          {}, a == 0.0 and bits in ((4, 4), (5, 3))))
    # the prefill body: timed at (4, 4) and (5, 3), the main shape of rows 7p
    # and 5p; untimed at the other widths, the compander, the features with a
    # padded tail, groups 5 and 8, 64-wide heads (Llama-3.2-1B) and the verify
    # chunk of 40 rows (S = 5 at group 8)
    for bits in [(4, 4), (5, 3)]:
        cases.append((f"prefill S=2048 on 512 cached bits={bits}", *prefill, bits, 0.0, {}, True))
    short = ((400 + np.arange(100, dtype=np.int32))[None], np.array([500], np.int32))
    for bits in [(2, 2), (8, 8), (3, 7)]:
        cases.append((f"prefill S=100 on 400 cached bits={bits}", *short, bits, 0.0,
                      {"untimed": True}, False))
    cases.append(("prefill S=100 on 400 cached bits=(4, 4) compand_a=0.65", *short, (4, 4), 0.65,
                  {"untimed": True}, False))
    cases.append(("prefill S=256 + window 128 + softcap + sinks, padded tail, bits=(5, 3)",
                  np.concatenate([700 + np.arange(200), np.full(56, 4096)]).astype(np.int32)[None],
                  np.array([900], np.int32), (5, 3), 0.0,
                  {"sliding_window": 128, "logit_softcap": 20.0, "sinks": True, "untimed": True},
                  False))
    for hq, hk in ((40, 8), (32, 4)):
        cases.append((f"prefill S=100 on 400 cached bits=(4, 4), group {hq // hk}", *short,
                      (4, 4), 0.0, {"q_heads": hq, "kv_heads": hk, "untimed": True}, False))
    cases.append(("Llama-3.2-1B heads (D=64) prefill S=300 on 100 cached bits=(5, 3)",
                  (100 + np.arange(300, dtype=np.int32))[None], np.array([400], np.int32), (5, 3),
                  0.0, {"head_dim": 64, "untimed": True}, False))
    cases.append(("verify S=5 B=8, group 8, bits=(4, 4)",
                  ctx[:, None] - 5 + np.arange(5, dtype=np.int32), ctx, (4, 4), 0.0,
                  {"kv_heads": 4, "untimed": True}, False))
    cases.append(("decode + sliding window 512 bits=(4, 4)", *decode, (4, 4), 0.0,
                  {"sliding_window": 512}, False))
    cases.append(("decode + softcap 30 bits=(4, 4)", *decode, (4, 4), 0.0,
                  {"logit_softcap": 30.0}, False))
    cases.append(("decode + sinks bits=(5, 3)", *decode, (5, 3), 0.65, {"sinks": True}, False))
    # the split-key decode kernel: a verify chunk, seven short sequences beside
    # one of 8192 (their splits end early, the long one's spread), and a table
    # four times wider than the longest sequence (whole splits see no key)
    cases.append(("verify S=5 B=8 bits=(5, 3)", ctx[:, None] - 5 + np.arange(5, dtype=np.int32),
                  ctx, (5, 3), 0.0, {}, False))
    imbalance = np.array([300] * 7 + [8192], np.int32)
    cases.append(("decode B=8, seven at ctx 300 and one at 8192, bits=(4, 4)",
                  imbalance[:, None] - 1, imbalance, (4, 4), 0.0, {"timed": True}, False))
    cases.append(("decode B=8 ctx 300-2048, a table of 4x the pages, bits=(4, 4)", *decode,
                  (4, 4), 0.0, {"table_pages": 4 * 8}, False))
    for name, qpos, total, (kb, vb), a, kw, main in cases:
        B, S = qpos.shape
        Hq, Hk = kw.pop("q_heads", 32), kw.pop("kv_heads", 8)
        D = kw.pop("head_dim", 128)
        untimed = kw.pop("untimed", False)
        mp = kw.pop("table_pages", int(math.ceil(total.max() / PAGE_SIZE)) + 1)
        P = B * mp + 1
        perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
        perm[:, -1] = 0  # the scratch column
        g = torch.Generator(device=dev).manual_seed(9)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        merged = merged_layout(kb, vb)
        state = {}
        for nm, bits in (("k", kb), ("v", vb)):
            x = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev)
            state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, bits, merged, a)
            del x
        bt = torch.as_tensor(perm, device=dev)
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        args = dict(scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = paged_attention_quant_plain(q, state, bt, qp, tl, kb, vb, a, **args)
        got = paged_attention_quant_kernel(q, state, bt, qp, tl, kb, vb, a, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention_quant {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        storage = "merged" if merged else "per_head"
        if not rel <= TOL_ATTN_Q:
            raise AssertionError(f"paged_attention_quant {name}: rel err {rel} > {TOL_ATTN_Q}")
        # the library's counts show which body the rows took
        route = _route(S, Hq, Hk)
        n = _check_route(f"paged_attention_quant {name}", S * Hq // Hk, route,
                         lambda: paged_attention_quant_kernel(q, state, bt, qp, tl, kb, vb, a,
                                                              **args))
        prefill_row = route == "prefill body"
        row = f"paged_attention_quant_{'prefill_' if prefill_row else ''}{storage}"
        timed = main or (prefill_row and not untimed) or kw.get("timed")
        if not timed:
            log(f"paged_attention_quant {name} ({storage} storage, D={D}, {route}, {n[0]} "
                f"decode-kernel, {n[1]} prefill-body launch): max_abs_err={err:.3e} rel={rel:.2e}")
            table.add(row, err, None, None, None, None, "", main=False)
            del q, state, ref, got
            continue
        kern = lambda st: paged_attention_quant_kernel(q, st, bt, qp, tl, kb, vb, a, **args)
        ms, warm = _cold_warm(kern, state)
        plain = time_ms(lambda: paged_attention_quant_plain(q, state, bt, qp, tl, kb, vb, a,
                                                            **args), 2)
        # yardstick: SDPA over pre-gathered, pre-dequantized contiguous bf16 K/V
        T = mp * PAGE_SIZE
        kc, vc = (dequantize_kv_stored(state[nm + "_q"][bt.long()], state[nm + "_s"][bt.long()],
                                       bits, Hk, merged, torch.bfloat16, a)
                  .reshape(B, T, Hk, D).transpose(1, 2).contiguous()
                  for nm, bits in (("k", kb), ("v", vb)))
        kpos = torch.arange(T, device=dev)
        mask = (kpos[None, None, :] <= qp[:, :, None]) & (kpos[None, None, :] < tl[:, None, None])
        qt = q.to(torch.bfloat16).transpose(1, 2)
        lib, lib_warm = _cold_warm(lambda kv: torch.nn.functional.scaled_dot_product_attention(
            qt, kv["k"], kv["v"], attn_mask=mask[:, None], scale=D ** -0.5, enable_gqa=True),
            {"k": kc, "v": vc})
        bnd = bound_ms(*_quant_attn_work(qpos, total, Hq, Hk, D, args["sliding_window"], kb, vb))
        log(f"paged_attention_quant {name} ({storage} storage, {route}): max_abs_err={err:.3e} "
            f"rel={rel:.2e} kernel_ms={ms:.4f} (L2-warm {warm:.4f}) plain_ms={plain:.4f} "
            f"library_ms(sdpa on dequantized bf16)={lib:.4f} (L2-warm {lib_warm:.4f}) "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(row, err, ms, plain, bnd, lib,
                  f"{name}: B={B} S={S} Hq={Hq} Hk={Hk} D={D}", main=main, warm_ms=warm,
                  library_warm_ms=lib_warm)
        del q, state, ref, got, kc, vc
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


def _sdpa_linear(q, k, v, qp, tl, rows, D):
    """A callable timing SDPA over the live slice of each sequence's cache row
    (bf16, the same mask), the yardstick of the linear kernels."""
    B = q.shape[0]
    live = int(tl.max())
    idx = torch.arange(B, device=q.device) if rows is None else rows.long()
    kc = k[idx, :live].transpose(1, 2).contiguous()
    vc = v[idx, :live].transpose(1, 2).contiguous()
    kpos = torch.arange(live, device=q.device)
    mask = (kpos[None, None, :] <= qp[:, :, None]) & (kpos[None, None, :] < tl[:, None, None])
    qt = q.to(torch.bfloat16).transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=mask[:, None], scale=D ** -0.5, enable_gqa=True)


# the linear layout's shapes: (name, geometry (Hq, Hk, D), cache rows N, slots T,
# q positions, total lengths, cache rows of the sequences, extras, main)
_CTX = np.linspace(300, 2048, 8).astype(np.int32)
_CTX_T = np.linspace(300, 2056, 8).astype(np.int32)  # the last reaches T = 2056
_PREFILL = ((512 + np.arange(2048, dtype=np.int32))[None], np.array([2560], np.int32))


def check_linear_attention(table, dev):
    from exllamav3_tpu_torch.ops.flash_attention import (linear_attention_kernel,
                                                          linear_attention_plain)

    g1b, g8b = (32, 8, 64), (32, 8, 128)
    rows8 = np.array([5, 0, 7, 2, 9, 4, 1, 6], np.int32)
    cases = [
        ("Llama-3.2-1B draft decode B=8 ctx 300-2048", g1b, 8, 2056, _CTX[:, None] - 1, _CTX,
         None, {}, True),
        ("Llama-3.2-1B draft decode B=8, rows of a 10-row cache, ctx 300-2056 (tail tile)", g1b,
         10, 2056, _CTX_T[:, None] - 1, _CTX_T, rows8, {}, False),
        ("Llama-3.1-8B decode B=1 ctx 2048", g8b, 1, 2056, np.array([[2047]], np.int32),
         np.array([2048], np.int32), None, {}, False),
        ("Llama-3.1-8B decode B=8 ctx 300-2056 (tail tile)", g8b, 8, 2056, _CTX_T[:, None] - 1,
         _CTX_T, None, {}, False),
        ("Llama-3.1-8B prefill S=2048 on 512 cached", g8b, 1, 2560, *_PREFILL, None, {}, True),
        ("Llama-3.2-1B verify-shaped S=5 B=8 ctx 300-2056", g1b, 8, 2056,
         _CTX_T[:, None] - 5 + np.arange(5, dtype=np.int32)[None], _CTX_T, None, {}, False),
        ("Llama-3.1-8B decode + window 512 + softcap 30 + sinks, T=2056", g8b, 8, 2056,
         _CTX_T[:, None] - 1, _CTX_T, None,
         {"sliding_window": 512, "logit_softcap": 30.0, "sinks": True}, False),
        ("Llama-3.1-8B prefill S=256 + window 128 + softcap + sinks, padded tail, T=904", g8b, 1,
         904, np.concatenate([700 + np.arange(200), np.full(56, 4096)]).astype(np.int32)[None],
         np.array([900], np.int32), None,
         {"sliding_window": 128, "logit_softcap": 20.0, "sinks": True}, False),
    ]
    # GQA groups 5, 6 and 7 over a cache of T = 2052 slots (no multiple of 8)
    ctx52 = np.minimum(_CTX_T, 2052)
    cases += [(f"decode B=8 ctx 300-2052, group {hq // hk}, T=2052", (hq, hk, 128), 8, 2052,
               ctx52[:, None] - 1, ctx52, None, {}, False) for hq, hk in ((40, 8), (12, 2), (28, 4))]
    cases.append(("verify S=5 B=8, group 7, rows of a 10-row cache, T=2052", (28, 4, 128), 10, 2052,
                  ctx52[:, None] - 5 + np.arange(5, dtype=np.int32)[None], ctx52, rows8, {}, False))
    # the two-row body: Gemma-3-27B's global-layer heads (group 2) and a group of 1
    cases += [(f"decode B=8 ctx 300-2056 (tail tile), group {32 // hk}", (32, hk, 128), 8, 2056,
               _CTX_T[:, None] - 1, _CTX_T, None, {}, False) for hk in (16, 32)]
    # the prefill body, untimed, over T = 2052 (its last tile 4 keys wide): the
    # 1B draft's 64-wide heads, GQA groups 1, 2, 5 and 7, a chunk of 33 rows at
    # group 1 (one past the decode route), and three sequences of unequal
    # length in named rows whose chunks start mid-page
    tail = (1752 + np.arange(300, dtype=np.int32))[None], np.array([2052], np.int32)
    cases.append(("Llama-3.2-1B draft prefill S=300 on 1752 cached, T=2052", g1b, 1, 2052, *tail,
                  None, {"untimed": True}, False))
    cases += [(f"prefill S=300 on 1752 cached, group {hq // hk}, T=2052", (hq, hk, 128), 1, 2052,
               *tail, None, {"untimed": True}, False)
              for hq, hk in ((32, 32), (32, 16), (40, 8), (28, 4))]
    cases.append(("prefill S=33 from 0, group 1, T=2052", (32, 32, 128), 1, 2052,
                  np.arange(33, dtype=np.int32)[None], np.array([33], np.int32), None,
                  {"untimed": True}, False))
    three = np.array([500, 900, 2052], np.int32)
    cases.append(("prefill B=3 S=200, sequences of 500, 900 and 2052 in rows 4, 0, 2 of 5, "
                  "T=2052", g8b, 5, 2052, three[:, None] - 200 + np.arange(200, dtype=np.int32),
                  three, np.array([4, 0, 2], np.int32), {"untimed": True}, False))
    for name, (Hq, Hk, D), N, T, qpos, total, rows, kw, main in cases:
        B, S = qpos.shape
        untimed = kw.pop("untimed", False)
        g = torch.Generator(device=dev).manual_seed(15)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        k = torch.randn((N, T, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((N, T, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        rw = None if rows is None else torch.as_tensor(rows, device=dev)
        args = dict(rows=rw, scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = linear_attention_plain(q, k, v, qp, tl, **args)
        got = linear_attention_kernel(q, k, v, qp, tl, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"linear_attention {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= TOL_ATTN:
            raise AssertionError(f"linear_attention {name}: rel err {rel} > {TOL_ATTN}")
        route = _route(S, Hq, Hk)
        n = _check_route(f"linear_attention {name}", S * Hq // Hk, route,
                         lambda: linear_attention_kernel(q, k, v, qp, tl, **args))
        row = "linear_attention_prefill" if route == "prefill body" else "linear_attention"
        if untimed:
            log(f"linear_attention {name} (Hq={Hq} Hk={Hk} D={D} N={N} T={T}, {route}: "
                f"{n[1]} prefill-body launch): max_abs_err={err:.3e} rel={rel:.2e}")
            table.add(row, err, None, None, None, None, "", main=False)
            del q, k, v, ref, got
            continue
        # decode and verify (the decode kernel) over caches rotated past L2,
        # the L2-warm time beside, and SDPA alike; prefill warm
        kern = lambda kv: linear_attention_kernel(q, kv["k"], kv["v"], qp, tl, **args)
        if route == "decode kernel":
            ms, warm = _cold_warm(kern, {"k": k, "v": v})
        else:
            ms, warm = time_ms(lambda: kern({"k": k, "v": v}), 10), None
        plain = time_ms(lambda: linear_attention_plain(q, k, v, qp, tl, **args), 2)
        lib = lib_warm = None
        if not kw:
            sdpa = _sdpa_linear(q, k, v, qp, tl, rw, D)
            if route == "decode kernel":
                lib, lib_warm = _cold_warm(
                    lambda f: f(), sdpa,
                    make=lambda i: sdpa if i == 0 else _sdpa_linear(q, k, v, qp, tl, rw, D),
                    nbytes=2 * B * int(tl.max()) * Hk * D * 2)
            else:
                lib = time_ms(sdpa, 10)
            del sdpa
        bnd = bound_ms(*_attn_work(qpos, total, Hq, Hk, D, args["sliding_window"]))
        log(f"linear_attention {name} (Hq={Hq} Hk={Hk} D={D} N={N} T={T}, {route}: {n[0]} "
            f"decode-kernel, {n[1]} prefill-body launch): "
            f"max_abs_err={err:.3e} rel={rel:.2e} kernel_ms={_ms(ms, warm)} "
            f"plain_ms={plain:.4f} library_ms(sdpa on the live slice)={_ms(lib, lib_warm)} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(row, err, ms, plain, bnd, lib,
                  f"{name}: B={B} S={S} Hq={Hq} Hk={Hk} D={D} T={T}", main=main, warm_ms=warm,
                  library_warm_ms=lib_warm)
        del q, k, v, ref, got
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


def check_linear_attention_quant(table, dev):
    from exllamav3_tpu_torch.ops.flash_attention import (linear_attention_quant_kernel,
                                                          linear_attention_quant_plain)
    from exllamav3_tpu_torch.ops.kv_quant import (merged_layout, quant_cache_fetch,
                                                   quantize_kv_stored)

    T = 2056
    decode = (_CTX_T[:, None] - 1, _CTX_T)
    rows8 = np.array([5, 0, 7, 2, 9, 4, 1, 6], np.int32)
    cases = [(f"decode B=8 ctx 300-2056 T={T} bits={bits}", 8, T, *decode, None, bits, 0.0, {},
              True) for bits in ((4, 4), (5, 3))]
    # the split-key decode kernel at batch 1 (splits of one tile fill the
    # card), the widest and narrowest widths, and 64-wide heads
    cases += [(f"decode B=1 ctx {n} T={n + 8} bits=(4, 4)", 1, n + 8,
               np.array([[n - 1]], np.int32), np.array([n], np.int32), None, (4, 4), 0.0,
               {"timed": True}, False) for n in (2048, 8192)]
    cases += [(f"decode B=8 ctx 300-2056 T={T} bits={bits}", 8, T, *decode, None, bits, 0.0, {},
               False) for bits in ((2, 2), (8, 8))]
    cases.append(("Llama-3.2-1B heads (D=64) decode B=8 ctx 300-2056 bits=(5, 3)", 8, T, *decode,
                  None, (5, 3), 0.0, {"head_dim": 64}, False))
    cases += [("decode B=8 ctx 300-2056, rows of a 10-row cache, bits=(4, 4) compand_a=0.65", 10,
               T, *decode, rows8, (4, 4), 0.65, {}, False),
              ("decode B=8 ctx 300-2056, bits=(3, 7) + window 512 + softcap 30 + sinks", 8, T,
               *decode, None, (3, 7), 0.65,
               {"sliding_window": 512, "logit_softcap": 30.0, "sinks": True}, False),
              ("verify-shaped S=5 B=8 bits=(5, 3)", 8, T,
               _CTX_T[:, None] - 5 + np.arange(5, dtype=np.int32)[None], _CTX_T, None, (5, 3),
               0.0, {}, False)]
    cases += [(f"prefill S=2048 on 512 cached bits={bits}", 1, 2560, *_PREFILL, None, bits, 0.0,
               {}, True) for bits in ((4, 4), (5, 3))]
    # the prefill body, untimed, over T = 2052 (its last tile 4 keys wide): the
    # other widths, the compander, the features with a padded tail, groups 5
    # and 8, 64-wide heads
    tail = ((1752 + np.arange(300, dtype=np.int32))[None], np.array([2052], np.int32))
    cases += [(f"prefill S=300 on 1752 cached, T=2052 bits={bits}", 1, 2052, *tail, None, bits,
               0.0, {"untimed": True}, False) for bits in ((2, 2), (8, 8), (3, 7))]
    cases.append(("prefill S=300 on 1752 cached, T=2052 bits=(4, 4) compand_a=0.65", 1, 2052,
                  *tail, None, (4, 4), 0.65, {"untimed": True}, False))
    cases.append(("prefill S=256 + window 128 + softcap + sinks, padded tail, T=2052, "
                  "bits=(5, 3)", 1, 2052,
                  np.concatenate([1800 + np.arange(200), np.full(56, 4096)]).astype(np.int32)[None],
                  np.array([2000], np.int32), None, (5, 3), 0.0,
                  {"sliding_window": 128, "logit_softcap": 20.0, "sinks": True, "untimed": True},
                  False))
    cases += [(f"prefill S=300 on 1752 cached, T=2052 bits=(4, 4), group {hq // hk}", 1, 2052,
               *tail, None, (4, 4), 0.0, {"q_heads": hq, "kv_heads": hk, "untimed": True}, False)
              for hq, hk in ((40, 8), (32, 4))]
    cases.append(("Llama-3.2-1B heads (D=64) prefill S=300 on 1752 cached, T=2052 bits=(5, 3)",
                  1, 2052, *tail, None, (5, 3), 0.0, {"head_dim": 64, "untimed": True}, False))
    # GQA groups 7 and 5 over a cache of T = 2052 slots (no multiple of 8)
    ctx52 = np.minimum(_CTX_T, 2052)
    cases += [(f"decode B=8 ctx 300-2052 T=2052 bits={bits}, group {hq // hk}", 8, 2052,
               ctx52[:, None] - 1, ctx52, None, bits, 0.0, {"q_heads": hq, "kv_heads": hk}, False)
              for (hq, hk), bits in (((28, 4), (4, 4)), ((40, 8), (5, 3)), ((12, 2), (4, 4)))]
    for name, N, T_, qpos, total, rows, (kb, vb), a, kw, main in cases:
        B, S = qpos.shape
        Hq, Hk, D = kw.pop("q_heads", 32), kw.pop("kv_heads", 8), kw.pop("head_dim", 128)
        untimed = kw.pop("untimed", False)
        g = torch.Generator(device=dev).manual_seed(16)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        merged = merged_layout(kb, vb)
        state = {}
        for nm, bits in (("k", kb), ("v", vb)):
            x = torch.randn((N, T_, Hk, D), generator=g, device=dev)
            state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, bits, merged, a)
            del x
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        rw = None if rows is None else torch.as_tensor(rows, device=dev)
        args = dict(rows=rw, scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = linear_attention_quant_plain(q, state, qp, tl, kb, vb, a, **args)
        got = linear_attention_quant_kernel(q, state, qp, tl, kb, vb, a, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"linear_attention_quant {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        storage = "merged" if merged else "per_head"
        if not rel <= TOL_ATTN_Q:
            raise AssertionError(f"linear_attention_quant {name}: rel err {rel} > {TOL_ATTN_Q}")
        # the library's counts show which body the rows took
        route = _route(S, Hq, Hk)
        n = _check_route(f"linear_attention_quant {name}", S * Hq // Hk, route,
                         lambda: linear_attention_quant_kernel(q, state, qp, tl, kb, vb, a,
                                                               **args))
        prefill_row = route == "prefill body"
        row = f"linear_attention_quant_{'prefill_' if prefill_row else ''}{storage}"
        timed = main or (prefill_row and not untimed) or kw.get("timed")
        if not timed:
            log(f"linear_attention_quant {name} ({storage} storage, D={D}, {route}, {n[0]} "
                f"decode-kernel, {n[1]} prefill-body launch): max_abs_err={err:.3e} rel={rel:.2e}")
            table.add(row, err, None, None, None, None, "", main=False)
            del q, state, ref, got
            continue
        ms, warm = _cold_warm(
            lambda st: linear_attention_quant_kernel(q, st, qp, tl, kb, vb, a, **args), state)
        plain = time_ms(lambda: linear_attention_quant_plain(q, state, qp, tl, kb, vb, a, **args),
                        2)
        # yardstick: SDPA over the dequantized bf16 cache's live slice
        kd, vd = quant_cache_fetch(state, kb, vb, torch.bfloat16, a, hk=Hk)
        sdpa = _sdpa_linear(q, kd, vd, qp, tl, rw, D)
        lib, lib_warm = _cold_warm(
            lambda f: f(), sdpa,
            make=lambda i: sdpa if i == 0 else _sdpa_linear(q, kd, vd, qp, tl, rw, D),
            nbytes=2 * q.shape[0] * int(tl.max()) * Hk * D * 2)
        bnd = bound_ms(*_quant_attn_work(qpos, total, Hq, Hk, D, args["sliding_window"], kb, vb))
        log(f"linear_attention_quant {name} ({storage} storage, {route}): max_abs_err={err:.3e} "
            f"rel={rel:.2e} kernel_ms={ms:.4f} (L2-warm {warm:.4f}) plain_ms={plain:.4f} "
            f"library_ms(sdpa on the dequantized bf16 live slice)={lib:.4f} (L2-warm "
            f"{lib_warm:.4f}) bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(row, err, ms, plain, bnd, lib,
                  f"{name}: B={B} S={S} Hq={Hq} Hk={Hk} D={D} T={T_}", main=main, warm_ms=warm,
                  library_warm_ms=lib_warm)
        del q, state, ref, got, kd, vd
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


def _latent_work(qpos, total, Hq, key_bytes):
    """Bytes and operations of latent attention on this data: q (576 bf16 a
    row) and the output (512 f32) once, each distinct visible key's row once
    (`key_bytes` a token, all heads together), and 2 * (576 + 512) operations
    per visible (query head, key) pair."""
    B, S = qpos.shape
    pairs, keys = _visible(qpos, total)
    return B * S * Hq * (576 * 2 + 512 * 4) + keys * key_bytes, 2.0 * pairs * Hq * (576 + 512)


def _latent_cases():
    """(name, q heads, cache rows N (0: paged), slots T, q positions, total
    lengths, named rows, main) at DeepSeek-V2-Lite's shapes and beyond."""
    decode = (_CTX[:, None] - 1, _CTX)
    rows8 = np.array([5, 0, 7, 2, 9, 4, 1, 6], np.int32)
    ctx52 = np.minimum(_CTX_T, 2052)
    tail = ((1752 + np.arange(300, dtype=np.int32))[None], np.array([2052], np.int32))
    wide = ((1792 + np.arange(256, dtype=np.int32))[None], np.array([2048], np.int32))
    return [
        ("decode B=8 ctx 300-2048, DeepSeek-V2-Lite (16 heads)", 16, 0, 0, *decode, None, True),
        ("verify S=5 B=8 ctx 300-2048", 16, 0, 0,
         _CTX[:, None] - 5 + np.arange(5, dtype=np.int32)[None], _CTX, None, False),
        ("prefill S=2048 on 512 cached", 16, 0, 0, *_PREFILL, None, False),
        ("decode B=8 ctx 300-2048, DeepSeek-V2/V3 (128 heads)", 128, 0, 0, *decode, None, False),
        ("linear decode B=8 ctx 300-2056, T=2056 (tail tile)", 16, 8, 2056, _CTX_T[:, None] - 1,
         _CTX_T, None, False),
        ("linear decode B=8 ctx 300-2052, rows of a 10-row cache, T=2052", 16, 10, 2052,
         ctx52[:, None] - 1, ctx52, rows8, False),
        ("linear prefill S=300 on 1752 cached, T=2052 (a last tile of 4 keys)", 16, 1, 2052, *tail,
         None, False),
        ("prefill S=256 on 1792 cached, DeepSeek-V2/V3 (128 heads)", 128, 0, 0, *wide, None, False),
    ]


def _latent_layout(rng, dev, N, T, total, B):
    """(cache leading shape, block tables or None, rows or None) of one case:
    paged with a shuffled block table and a scratch column when N == 0."""
    if N:
        return (N, T), None
    mp = int(math.ceil(total.max() / 256)) + 1
    P = B * mp + 1
    perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    perm[:, -1] = 0
    return (P, 256), torch.as_tensor(perm, device=dev)


def _sdpa_latent(q, k, qp, tl, scale):
    """A callable timing SDPA over gathered latent rows k (B, T, 576) bf16:
    K the whole row, V its leading 512 channels, one kv head for all q heads."""
    T = k.shape[1]
    kpos = torch.arange(T, device=q.device)
    mask = (kpos[None, None, :] <= qp[:, :, None]) & (kpos[None, None, :] < tl[:, None, None])
    kk = k[:, None].contiguous()
    vv = k[:, None, :, :512].contiguous()
    qt = q.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask[:, None], scale=scale, enable_gqa=True)


def _latent_launches(fn) -> tuple:
    """Launches of the latent split-key decode kernel (csrc/latent_decode.cuh)
    and of the prefill pre-pass and body (csrc/latent_prefill.cuh) that one
    call of fn() made, as the kernel library counts them where it launches
    them."""
    from exllamav3_tpu_torch.ops.build import library

    lib = library()
    count = lambda: (lib.exl3_latent_decode_launches(), lib.exl3_latent_tiles_launches(),
                     lib.exl3_latent_prefill_launches())
    n0 = count()
    fn()
    torch.cuda.synchronize()
    return tuple(b - a for a, b in zip(n0, count()))


def _latent_route(kind: str, name: str, S: int, fn) -> None:
    """Decode (S = 1) takes the split-key kernel, longer chunks the pre-pass
    and the body of the prefill (and nothing else), by the library's counts."""
    took = _latent_launches(fn)
    if took != (int(S == 1), int(S > 1), int(S > 1)):
        raise AssertionError(f"{kind} {name}: {took} launches of the latent decode kernel, the "
                             f"prefill pre-pass and the prefill body at S = {S}")


def _latent_gaps(rng, dev, B: int = 8):
    """(q positions, total lengths, block tables, pages) of the latent decode
    case whose splits include splits that see no key in the midst of ones
    that do: sequence 2 holds no key (a row that sees none), and sequence 5's
    pages 1 and 2 are out of range (-1), so the splits over keys 256-767 see
    no key while its later ones do. Its reference is the split arithmetic in
    plain torch (latent_attention_split_plain), which holds a page out of
    range to no visible key, as the kernel does."""
    total = _CTX.copy()
    total[2] = 0
    mp = int(math.ceil(total.max() / 256)) + 1
    P = B * mp + 1
    perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
    perm[:, -1] = 0
    perm[5, 1:3] = -1
    return total[:, None] - 1, total, torch.as_tensor(perm, device=dev), P


def _latent_gap_check(kind: str, dev, q, state: dict, bits: int, a: float, scale: float, tol: float,
                      kernel) -> float:
    """The gap case (_latent_gaps) through `kernel` against
    latent_attention_split_plain at the same split size; its rel err."""
    from exllamav3_tpu_torch.ops.flash_attention import (device_sms, latent_attention_split_plain,
                                                          latent_split_keys)

    qpos, total, bt, _ = state.pop("_gaps")
    qp = torch.as_tensor(qpos, device=dev)
    tl = torch.as_tensor(total, device=dev)
    B, _, Hq, _ = q.shape
    split = latent_split_keys(bt.shape[1] * 256, B, Hq, device_sms(dev))
    ref = latent_attention_split_plain(q, state, qp, tl, 512, bits, a, block_tables=bt,
                                       scale=scale, split_keys=split)
    if "kv" in state:
        run = lambda: kernel(q, state["kv"], qp, tl, block_tables=bt, scale=scale)
    else:
        run = lambda: kernel(q, state, qp, tl, bits, a, block_tables=bt, scale=scale)
    got = run()
    torch.cuda.synchronize()
    name = "decode B=8, a sequence of no keys and splits of no keys among ones that see keys"
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kind} {name}: non-finite output")
    if got[2].abs().max() != 0:
        raise AssertionError(f"{kind} {name}: the sequence of no keys gave no 0")
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not rel <= tol:
        raise AssertionError(f"{kind} {name}: rel err {rel} > {tol}")
    _latent_route(kind, name, 1, run)
    log(f"{kind} {name} (Hq={Hq}, paged, split {split}): rel={rel:.2e} against the split "
        "arithmetic in plain torch; one launch of the split-key kernel")
    return float((got - ref).abs().max())


def check_latent_attention(table, dev):
    from exllamav3_tpu_torch.ops.flash_attention import (latent_attention_kernel,
                                                          latent_attention_plain,
                                                          latent_attention_prefill_plain)

    rng = np.random.default_rng(21)
    scale = 192 ** -0.5
    for name, Hq, N, T, qpos, total, rows, main in _latent_cases():
        B, S = qpos.shape
        lead, bt = _latent_layout(rng, dev, N, T, total, B)
        g = torch.Generator(device=dev).manual_seed(22)
        q = (torch.randn((B, S, Hq, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        kv = torch.randn((*lead, 1, 576), generator=g, device=dev).to(torch.bfloat16)
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        rw = None if rows is None else torch.as_tensor(rows, device=dev)
        args = dict(block_tables=bt, rows=rw, scale=scale)
        plain_fn = latent_attention_plain if S == 1 else latent_attention_prefill_plain
        ref = plain_fn(q, kv, qp, tl, 512, **args)
        got = latent_attention_kernel(q, kv, qp, tl, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"latent_attention {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= TOL_ATTN:
            raise AssertionError(f"latent_attention {name}: rel err {rel} > {TOL_ATTN}")
        _latent_route("latent_attention", name, S,
                      lambda: latent_attention_kernel(q, kv, qp, tl, **args))
        ms = time_ms(lambda: latent_attention_kernel(q, kv, qp, tl, **args), 10)
        plain = time_ms(lambda: plain_fn(q, kv, qp, tl, 512, **args), 2)
        k = kv[bt.long()].reshape(B, -1, 576) if bt is not None else (
            kv[:B, :, 0] if rw is None else kv[rw.long(), :, 0])
        lib = time_ms(_sdpa_latent(q, k.reshape(B, -1, 576), qp, tl, scale), 10)
        bnd = bound_ms(*_latent_work(qpos, total, Hq, 1152))
        row = "latent_attention" if S == 1 else "latent_attention_prefill"
        log(f"{row} {name} (Hq={Hq}, {'paged' if bt is not None else f'linear T={T}'}): "
            f"max_abs_err={err:.3e} rel={rel:.2e} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms(sdpa on the gathered latent)={lib:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(row, err, ms, plain, bnd, lib, f"{name}: B={B} S={S} Hq={Hq}",
                  main=main or name.startswith("prefill S=2048"))
        del q, kv, ref, got, k
    qpos, total, bt, P = _latent_gaps(rng, dev)
    g = torch.Generator(device=dev).manual_seed(25)
    q = (torch.randn((8, 1, 16, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    state = {"kv": torch.randn((P, 256, 1, 576), generator=g, device=dev).to(torch.bfloat16),
             "_gaps": (qpos, total, bt, P)}
    err = _latent_gap_check("latent_attention", dev, q, state, 0, 0.0, scale, TOL_ATTN,
                            latent_attention_kernel)
    table.add("latent_attention", err, None, None, None, None, "", main=False)
    torch.cuda.empty_cache()


def check_latent_attention_quant(table, dev):
    from exllamav3_tpu_torch.ops.flash_attention import (latent_attention_quant_kernel,
                                                          latent_attention_quant_plain,
                                                          latent_attention_quant_prefill_plain)
    from exllamav3_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv

    rng = np.random.default_rng(23)
    scale = 192 ** -0.5
    cases = [(c, 4, 0.0) for c in _latent_cases()]
    decode = _latent_cases()[0]
    cases += [(decode, 3, 0.0), (decode, 4, 0.65)]
    for (name, Hq, N, T, qpos, total, rows, main), bits, a in cases:
        name = f"{name} bits={bits} compand_a={a}"
        main = main and bits == 4 and a == 0.0
        B, S = qpos.shape
        lead, bt = _latent_layout(rng, dev, N, T, total, B)
        g = torch.Generator(device=dev).manual_seed(24)
        q = (torch.randn((B, S, Hq, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        raw = torch.randn((*lead, 1, 576), generator=g, device=dev)
        kq, ks = quantize_kv(raw[..., :512], bits, a)
        state = {"kv_q": kq, "kv_s": ks, "k_pe": raw[..., 512:].to(torch.bfloat16).contiguous()}
        del raw
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        rw = None if rows is None else torch.as_tensor(rows, device=dev)
        args = dict(block_tables=bt, rows=rw, scale=scale)
        plain_fn = latent_attention_quant_plain if S == 1 else latent_attention_quant_prefill_plain
        ref = plain_fn(q, state, qp, tl, bits, a, **args)
        got = latent_attention_quant_kernel(q, state, qp, tl, bits, a, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"latent_attention_quant {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= TOL_ATTN_Q:
            raise AssertionError(f"latent_attention_quant {name}: rel err {rel} > {TOL_ATTN_Q}")
        _latent_route("latent_attention_quant", name, S,
                      lambda: latent_attention_quant_kernel(q, state, qp, tl, bits, a, **args))
        ms = time_ms(lambda: latent_attention_quant_kernel(q, state, qp, tl, bits, a, **args), 10)
        plain = time_ms(lambda: plain_fn(q, state, qp, tl, bits, a, **args), 2)
        # yardstick: SDPA over the gathered latent, dequantized to bf16
        lat = torch.cat([dequantize_kv(state["kv_q"], state["kv_s"], bits, torch.bfloat16, a),
                         state["k_pe"]], dim=-1)[..., 0, :]
        k = lat[bt.long()].reshape(B, -1, 576) if bt is not None else (
            lat[:B] if rw is None else lat[rw.long()])
        lib = time_ms(_sdpa_latent(q, k, qp, tl, scale), 10)
        bnd = bound_ms(*_latent_work(qpos, total, Hq, 64 * bits + 32 + 128))
        row = "latent_attention_quant" if S == 1 else "latent_attention_quant_prefill"
        log(f"{row} {name} (Hq={Hq}, "
            f"{'paged' if bt is not None else f'linear T={T}'}): max_abs_err={err:.3e} "
            f"rel={rel:.2e} kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(sdpa on the "
            f"dequantized bf16 latent)={lib:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(row, err, ms, plain, bnd, lib, f"{name}: B={B} S={S} Hq={Hq}",
                  main=main or (name.startswith("prefill S=2048") and bits == 4 and a == 0.0))
        del q, state, ref, got, lat, k
        torch.cuda.empty_cache()
    qpos, total, bt, P = _latent_gaps(rng, dev)
    g = torch.Generator(device=dev).manual_seed(26)
    q = (torch.randn((8, 1, 16, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    raw = torch.randn((P, 256, 1, 576), generator=g, device=dev)
    kq, ks = quantize_kv(raw[..., :512], 4, 0.0)
    state = {"kv_q": kq, "kv_s": ks, "k_pe": raw[..., 512:].to(torch.bfloat16).contiguous(),
             "_gaps": (qpos, total, bt, P)}
    err = _latent_gap_check("latent_attention_quant", dev, q, state, 4, 0.0, scale, TOL_ATTN_Q,
                            latent_attention_quant_kernel)
    table.add("latent_attention_quant", err, None, None, None, None, "", main=False)
    torch.cuda.empty_cache()


# -- the measurement probes (rows 15-20) ----------------------------------------------------

# the JAX tools' default shapes
PROBE_TRELLIS = dict(m=16, k=4096, n=4096, K=4, bm=16, bn=256, bk=256)
PROBE_KV = dict(ctx=16384, bits=4, Hk=8)
PROBE_INT4 = dict(m=16, k=4096, n=4096)
PROBE_A8 = dict(k=4096, n=4096)
PROBE_DMA = dict(kh=2048, n=4096)
PROBE_DMA_LARGE = 32768  # rows of a 128 MB weight: the rate once launch and ramp are amortized


def _probe(table, name: str, variants, make, nbytes, kernel, plain, flops, exact=(),
           main=None, library=None, shape="", calls=100, peak=BF16_FLOP_PER_S, tol=TOL_PROBE):
    """Each variant's kernel against its plain version on the card (exact for
    integer outputs, else `tol` of the largest magnitude), then both timed
    over inputs that rotate through more than the L2 cache. The row of `name`
    (none where table is None) carries the main variant's numbers and every
    variant's under `variants`."""
    per, worst = {}, 0.0
    for v in variants:
        nxt = rotating(lambda i, v=v: make(v, i), nbytes(v))
        args = nxt()
        with uncounted():
            ref = plain(*args, v)
            got = kernel(*args, v)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {v}: shape {tuple(got.shape)} or non-finite output")
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        if (v in exact and err != 0.0) or rel > tol:
            raise AssertionError(f"{name} {v}: max_abs_err {err} rel {rel} "
                                 f"(tolerance {'exact' if v in exact else tol})")
        with uncounted():
            ms = time_ms(lambda: kernel(*nxt(), v), calls)
            plain_t = time_ms(lambda: plain(*nxt(), v), 2)
        bnd = bound_ms(nbytes(v), flops(v), peak)
        per[v] = dict(ms=ms, plain_ms=plain_t, bound_ms=bnd[0], max_abs_err=err)
        worst = max(worst, err)
        log(f"{name} {v}: max_abs_err={err:.3e} rel={rel:.2e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_t:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}) "
            f"share_of_bound={bnd[0] / ms:.3f}")
        del nxt, args, ref, got
        torch.cuda.empty_cache()
    main = main or variants[0]
    if table is not None:
        m = per[main]
        table.add(name, worst, m["ms"], m["plain_ms"], bound_ms(nbytes(main), flops(main), peak),
                  library, f"{shape} {main}".strip(), main=True, variants=per)
    return per


def check_fused_ablate(table, dev):
    """Row 15 at the JAX tool's defaults (m 16, k = n = 4096, K 4, bn = bk =
    256): every variant, the production exl3_gemm.cu beside them, and
    torch.matmul on the decoded weight as the library yardstick."""
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_gemm_kernel
    import exllamav3_tpu_torch.probes.fused_ablate as P

    s = PROBE_TRELLIS
    m, k, n, K = s["m"], s["k"], s["n"], s["K"]
    geo = (s["bm"], s["bn"], s["bk"])
    nb = m * k * 2 + k * n * K // 8 + m * n * 4
    xh, words = P.make_inputs(m, k, n, K, 0, dev)
    wd = P.probe_weight(words, K, "full", s["bn"], s["bk"])
    nxt_lib = rotating(lambda i: (xh, wd.clone()), m * k * 2 + k * n * 2 + m * n * 4)
    lib = time_ms(lambda: torch.matmul(*nxt_lib()), 100)
    nxt = rotating(lambda i: P.make_inputs(m, k, n, K, i, dev), nb)
    with uncounted():
        prod = time_ms(lambda: exl3_gemm_kernel(*nxt(), K, 0), 100)
    log(f"fused_ablate: exl3_gemm.cu (production) kernel_ms={prod:.4f}; library_ms(torch.matmul "
        f"bf16 on the decoded weight)={lib:.4f}")
    del nxt, nxt_lib, wd
    _probe(table, "fused_ablate", P.VARIANTS,
           lambda v, i: P.make_inputs(m, k, n, K, i, dev), lambda v: nb,
           lambda xh, w, v: P.fused_ablate_kernel(xh, w, K, v, *geo),
           lambda xh, w, v: P.fused_ablate_plain(xh, w, K, v, *geo),
           lambda v: 2.0 * m * k * n, main="full", library=lib,
           shape=f"m={m} k={k} n={n} K={K} bn={s['bn']} bk={s['bk']}")
    table.rows["fused_ablate"]["exl3_gemm_ms"] = prod


def check_dequant_probe(table, dev):
    """Rows 16a-c at the JAX tool's defaults (ctx 16384, 4 bits, Hk 8, G 4,
    D 128): the eight per-head variants, the two merged ones, dense bf16 K."""
    import exllamav3_tpu_torch.probes.dequant_probe as P

    s = PROBE_KV
    ctx, bits, Hk = s["ctx"], s["bits"], s["Hk"]

    def make(v, i):
        return P.make_inputs(v, ctx, bits, Hk, i, dev)

    def flops(v):
        return 2.0 * ctx * (Hk * 4) * (Hk * 128 if v in P.MERGED else 128)

    shape = f"ctx={ctx} bits={bits} Hk={Hk} G=4 D=128"
    for name, variants in (("dequant_probe", P.PER_HEAD), ("dequant_probe_merged", P.MERGED),
                           ("dequant_probe_bf16", ("bf16",))):
        _probe(table, name, variants, make, lambda v: P.input_bytes(v, ctx, bits, Hk),
               lambda q, kq, ks, v: P.dequant_probe_kernel(q, kq, ks, v, bits),
               lambda q, kq, ks, v: P.dequant_probe_plain(q, kq, ks, v, bits), flops,
               shape=shape, calls=20, tol=TOL_PROBE_KV)


def check_int4_sweep(table, dev):
    """Row 17 at the JAX tool's shapes (m 16, k = n = 4096): the four bodies,
    with torch.matmul on the decoded bf16 weight as the library yardstick.
    The tool's four block geometries change only the order of the f32 sums,
    and not the kernel's launch: each variant runs once."""
    import exllamav3_tpu_torch.ops.q_matmul as qm
    import exllamav3_tpu_torch.probes.int4_sweep as P

    s = PROBE_INT4
    m, k, n = s["m"], s["k"], s["n"]
    nb = m * k * 2 + k // 2 * n + k // 32 * n * 2 + m * n * 4
    x, packed, scales = P.make_inputs(m, k, n, 0, dev)
    wd = qm.int4_unpack(packed, scales).to(torch.bfloat16)
    nxt_lib = rotating(lambda i: (x, wd.clone()), m * k * 2 + k * n * 2 + m * n * 4)
    lib = time_ms(lambda: torch.matmul(*nxt_lib()), 100)
    del nxt_lib, wd
    _probe(table, "int4_sweep", P.VARIANTS, lambda v, i: P.make_inputs(m, k, n, i, dev),
           lambda v: nb, lambda x, p, sc, v: P.int4_sweep_kernel(x, p, sc, v, *P.GEOMETRIES[0]),
           lambda x, p, sc, v: P.int4_sweep_plain(x, p, sc, v, *P.GEOMETRIES[0]),
           lambda v: 2.0 * m * k * n, main="bitcast", library=lib, shape=f"m={m} k={k} n={n}")


def check_a8_ablate(table, dev):
    """Row 18 at the JAX tool's shapes (k = n = 4096: packed 2048 x 4096, 16
    rows of int8 x a 512-row block): every stage."""
    import exllamav3_tpu_torch.probes.a8_ablate as P

    k, n = PROBE_A8["k"], PROBE_A8["n"]
    kh = k // 2
    nb = kh * n + kh // 32 * n * 2 + kh * 16 + n * 4
    _probe(table, "a8_ablate", P.STAGES, lambda v, i: P.make_inputs(k, n, i, dev),
           lambda v: nb, P.a8_ablate_kernel, P.a8_ablate_plain,
           lambda v: 2.0 * 16 * kh * n * (2 if v == "dot2" else 1), exact=P.EXACT, main="dot",
           shape=f"kh={kh} n={n}", peak=INT8_OP_PER_S)


def check_a8_diag_proto(table, dev):
    """Row 19 at the JAX tool's shapes (m 1, k = n = 4096): raw_dot off and
    on at bn = bkh = 512 and at the sweep's bkh = 2048 (64 expanded rows)."""
    import exllamav3_tpu_torch.probes.a8_diag_proto as P

    m, k, n = 1, PROBE_A8["k"], PROBE_A8["n"]
    cases = {f"raw={rd} bkh={bkh}": (rd, bkh) for bkh in (512, P.SWEEP[0][1])
             for rd in (False, True)}

    def make(v, i):
        rd, bkh = cases[v]
        xq, packed, scales = P.make_inputs(m, k, n, i, dev)
        return (*P.diag_inputs(xq, packed, bkh, rd), scales)

    def nbytes(v):  # packed, scales, both expanded planes of x, out
        return k // 2 * n + k // 32 * n * 2 + k * (cases[v][1] // 32) * m + m * n * 4

    _probe(table, "a8_diag_proto", tuple(cases), make, nbytes,
           lambda xl, xh, p, s, v: P.a8_diag_kernel(xl, xh, p, s, m, cases[v][0]),
           lambda xl, xh, p, s, v: P.a8_diag_plain(xl, xh, p, s, m, cases[v][0]),
           lambda v: 2.0 * (cases[v][1] // 32) * m * k * n, main="raw=False bkh=512",
           shape=f"m={m} k={k} n={n}", peak=INT8_OP_PER_S)


def check_dma_floor(table, dev):
    """Row 20 at the JAX tool's shape (int8 2048 x 4096) in its three
    geometries, then a 128 MB weight: the device-memory rate reached, as a
    share of 3.35 TB/s."""
    import exllamav3_tpu_torch.probes.dma_floor as P

    geos = {f"bn={bn} bkh={bkh}": (bn, bkh) for bn, bkh in P.GEOMETRIES}
    n = PROBE_DMA["n"]
    for kh, label in ((PROBE_DMA["kh"], ""), (PROBE_DMA_LARGE, " large")):
        nb = kh * n + 16 * n * 4
        per = _probe(None if label else table, "dma_floor" + label, tuple(geos),
                     lambda v, i, kh=kh: (P.make_input(kh, n, i, dev),), lambda v, nb=nb: nb,
                     lambda b, v: P.dma_floor_kernel(b, *geos[v]),
                     lambda b, v: P.dma_floor_plain(b, *geos[v]), lambda v: 0.0,
                     exact=tuple(geos), shape=f"kh={kh} n={n}")
        for v, r in per.items():
            rate = nb / (r["ms"] * 1e-3)
            r["reached_bytes_per_s"] = rate
            log(f"dma_floor{label} {v}: reached {rate / 1e9:.1f} GB/s = "
                f"{100 * rate / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s")
        if label:
            table.rows["dma_floor"]["large"] = {"shape": f"kh={kh} n={n}", "variants": per}


PROBE_CHECKS = {"fused_ablate": check_fused_ablate, "dequant_probe": check_dequant_probe,
                "int4_sweep": check_int4_sweep, "a8_ablate": check_a8_ablate,
                "a8_diag_proto": check_a8_diag_proto, "dma_floor": check_dma_floor}


# -- phase: parity ----------------------------------------------------------------

def _compare(tag, a, b, rel_tol=2e-2):
    a, b = a.float().cpu(), b.float().cpu()
    err = float((a - b).abs().max())
    rel = err / float(b.abs().max())
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    pick = a.argmax(-1)
    agree = pick == b.argmax(-1)
    top1 = float(agree.float().mean())
    # rank of the GPU's choice among the CPU's logits (0 = the CPU's top-1)
    rank = (b > b.gather(-1, pick[:, None])).sum(-1)
    top2 = torch.topk(b, 2).values
    gaps = (top2[:, 0] - top2[:, 1])[~agree]
    finite = bool(torch.isfinite(a).all())
    log(f"parity {tag}: logits max_abs_err={err:.4e} rel={rel:.3e} top1_agree={top1:.4f} "
        f"over {len(agree)} positions, worst rank {int(rank.max())}"
        + (f", CPU top-2 gap where they differ {gaps.max():.4e}" if len(gaps) else ""))
    # bf16 roundings of the activations flip between the two sides, so a
    # near-tie can swap the top two: one position is held to the top 5, and
    # top-1 agreement is asked of 32 or more positions
    if not (finite and rel <= rel_tol and int(rank.max()) < 5 and (len(agree) < 32 or top1 >= 0.9)):
        raise AssertionError(f"parity {tag}: rel {rel}, top-1 agreement {top1}, "
                             f"worst rank {int(rank.max())}, finite {finite}")


def phase_parity():
    """GPU (kernels) against CPU (plain versions) on the first PARITY_LAYERS
    layers of the 2-layer full-width checkpoint: the int8 path over a bf16 cache, then `fused` linears over
    the bf16 cache and over a (4, 4) quantized cache, the capacity path (fewer
    calls: its CPU side decodes every trellis anew in each forward), then the
    packed tiers int4 and int6 through their a8 kernels."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = _layer_view(_checkpoint(2), PARITY_LAYERS, ["model.safetensors"])
    ids = np.random.default_rng(5).integers(0, LLAMA8B["vocab_size"], size=(1, 400))
    # the logits are held to 2% of their range over the bf16 cache
    for mode, spec_kw, simple, steps, rel_tol in (
            ("auto", {}, True, 2, 2e-2), ("fused", {}, False, 0, 2e-2),
            ("fused", dict(k_bits=4, v_bits=4), False, 1, TOL_QUANT_PATH),
            ("int4", {}, True, 2, TOL_A8_PATH), ("int6", {}, True, 2, TOL_A8_PATH)):
        cfg = Config.from_directory(d, infer_params=InferParams(linear_mode=mode))
        gpu = Model.from_config(cfg, device="cuda")
        gpu.load()
        cpu = Model.from_config(cfg, device="cpu")
        cpu.params = params_to(gpu.params, "cpu")
        tag = f"{cfg.infer_params.linear_mode} cache={spec_kw or 'bf16'}"
        log(f"parity: linear_mode={cfg.infer_params.linear_mode}, cache {spec_kw or 'bf16'}")
        if simple:
            got = gpu.forward_simple(ids[:, :96])
            _compare(f"{tag} forward_simple S=96", got, cpu.forward_simple(ids[:, :96]), rel_tol)
            if mode in ("int4", "int6"):
                before = _read_counts()
                with plain_packed_linears():
                    ref = gpu.forward_simple(ids[:, :96])
                if _read_counts() != before:
                    raise AssertionError(f"parity {tag}: the plain reference launched a kernel")
                _compare(f"{tag} forward_simple S=96, kernels against plain versions on the card",
                         got, ref)
        caches = [Cache(m, CacheSpec(num_pages=4, **spec_kw)) for m in (gpu, cpu)]
        bt = np.array([[1, 2, 0]], np.int32)
        S = 300
        outs = [m.forward(ids[:, :S], c, np.arange(S, dtype=np.int32)[None],
                          np.array([0], np.int32), bt) for m, c in zip((gpu, cpu), caches)]
        _compare(f"{tag} paged prefill S={S}", outs[0], outs[1], rel_tol)
        for step in range(steps):
            p = S + step
            outs = [m.forward(ids[:, p: p + 1], c, np.array([[p]], np.int32),
                              np.array([p], np.int32), bt) for m, c in zip((gpu, cpu), caches)]
            _compare(f"{tag} paged decode pos={p}", outs[0], outs[1], rel_tol)
        del gpu, cpu, caches
        gc.collect()
        torch.cuda.empty_cache()
    parity_moe()


@contextlib.contextmanager
def record_routing(forced: list | None = None):
    """Inside, every BlockSparseMLP.route call appends its (T, E) routing
    weights, on the host, to the yielded list. With `forced`, a list of such
    weights from an earlier run, each call then returns the next of them, on
    its own device, in place of its own."""
    from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP

    weights, orig = [], BlockSparseMLP.route
    given = iter(forced or [])

    def route(self, logits, e_bias=None):
        w = orig(self, logits, e_bias)
        weights.append(w.cpu())
        return w if forced is None else next(given).to(w.device)
    BlockSparseMLP.route = route
    try:
        yield weights
    finally:
        BlockSparseMLP.route = orig


def parity_moe():
    """The MoE path on a PARITY_LAYERS-layer Qwen3-MoE checkpoint at Qwen3-30B-A3B width
    (int8 attention and head, bf16 expert stacks): forward_simple (grouped
    experts), a paged prefill (grouped) and decode steps (the selected-expert
    kernel on the GPU, its plain version on the CPU). The router's bf16
    logits can differ in a last bit between the devices and so pick another
    expert for a token, and the logits of such a token differ by far more
    than the compute does: so the CPU runs first, the GPU then takes the
    CPU's routing weights at every layer, and every position is held to the
    limit. The share of (token, layer) expert sets that the GPU's own router
    picks alike is printed, and held for 32 pairs or more."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = _moe_checkpoint(PARITY_LAYERS)
    cfg = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
    gpu = Model.from_config(cfg, device="cuda")
    gpu.load()
    cpu = Model.from_config(cfg, device="cpu")
    cpu.params = params_to(gpu.params, "cpu")
    V = QWEN3_30B["vocab_size"]
    ids = np.random.default_rng(14).integers(0, V, size=(1, 400))
    tag = f"Qwen3-MoE {cfg.infer_params.linear_mode}"
    log(f"parity: {tag}, {PARITY_LAYERS} layer(s) at Qwen3-30B-A3B width, bf16 cache, the GPU "
        f"on the CPU's routing")

    def both(what, fn):
        """fn on the CPU, then on the GPU with the CPU's routing; the GPU's own
        expert sets compared with the CPU's, the logits held at every position"""
        with record_routing() as ref_w:
            ref = fn(cpu)
        with record_routing(forced=ref_w) as own_w:
            got = fn(gpu)
        alike = torch.stack([((a > 0) == (b > 0)).all(dim=-1) for a, b in zip(own_w, ref_w)])
        agree = float(alike.float().mean())
        n = alike.numel()
        log(f"parity {tag} {what}: the GPU's own expert sets agree with the CPU's for "
            f"{agree:.4f} of {n} (token, layer) pairs")
        if n >= 32 and agree < MIN_EXPERT_AGREEMENT:
            raise AssertionError(f"parity {tag} {what}: expert sets agree for only {agree:.4f}")
        _compare(f"{tag} {what}", got, ref, TOL_MOE_PATH)

    both("forward_simple S=96", lambda m: m.forward_simple(ids[:, :96]))
    caches = {m: Cache(m, CacheSpec(num_pages=4)) for m in (gpu, cpu)}
    bt = np.array([[1, 2, 0]], np.int32)
    S = 300
    both(f"paged prefill S={S}", lambda m: m.forward(ids[:, :S], caches[m],
                                                     np.arange(S, dtype=np.int32)[None],
                                                     np.array([0], np.int32), bt))
    before = _read_counts()["moe_gemm"]
    for p in range(S, S + 2):
        both(f"paged decode pos={p}", lambda m: m.forward(ids[:, p: p + 1], caches[m],
                                                          np.array([[p]], np.int32),
                                                          np.array([p], np.int32), bt))
    if _read_counts()["moe_gemm"] - before != 2 * PARITY_LAYERS:
        raise AssertionError(f"parity {tag}: the decode steps did not run the selected-expert "
                             "kernel once a layer")
    del gpu, cpu, caches
    gc.collect()
    torch.cuda.empty_cache()


# -- phase: serve ------------------------------------------------------------------

def profile_decode(step, steps: int, what: str) -> dict | None:
    """Trace `steps` calls of step() (a generator iteration or a model step)
    with torch.profiler and print the device's busy share of the window,
    kernels per step and the kernels that take the most device time. Where
    step() returns a generator iteration's events, also per token (a burst
    iteration yields up to decode_burst tokens a job). Returns the window's
    figures and how often each device kernel ran in it (`names`), None if
    the trace held no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    tokens = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            res = step()
            if isinstance(res, list):
                tokens += sum(1 for r in res if r["stage"] == "streaming")
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA)
    if not dev:
        log("profile: the trace holds no device events; device busy share not measured")
        return
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    by_name: dict = {}
    for s0, e0, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = t1 - t0
    per_token = (f", {tokens} tokens: {window / tokens / 1e3:.4f} ms of window, "
                 f"{busy / tokens / 1e3:.4f} ms busy and {len(dev) / tokens:.1f} device ops "
                 f"a token" if tokens else "")
    log(f"profile: {steps} {what}, window {window / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms ({busy / window:.4f} of the window, idle "
        f"{1 - busy / window:.4f}), {len(dev) / steps:.1f} device ops per step{per_token}")
    total = sum(by_name.values())
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {t / total:.4f} of device time  {t / steps / 1e3:.4f} ms/step  {name[:90]}")
    names: dict = {}
    for _, _, name in dev:
        names[name] = names.get(name, 0) + 1
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3, "idle": 1 - busy / window,
            "ops": len(dev), "tokens": tokens, "names": names}


def _reset_counts():
    """Every kernel's Python-side launch count to 0 (ops/launches.py: a
    replayed decode graph adds what its capture counted). The kernel
    library's C-side counts (exl3_decode_launches and the like) miss
    replays: the kernel checks read them around eager calls only."""
    set_counts({})


def _read_counts() -> dict:
    return read_counts()


@contextlib.contextmanager
def uncounted():
    """Launches inside (a reference's) do not count: every kernel's count is
    put back after."""
    saved = _read_counts()
    try:
        yield
    finally:
        set_counts(saved)


@contextlib.contextmanager
def plain_ops():
    """Inside, the dispatches of the quantized-cache paths (trellis and int8
    linears, the fused MLP, the selected experts, quantized attention over the
    paged and the linear cache, the quantized latent attention) run their
    plain PyTorch versions on the card's tensors, so a forward computes the
    same function through no hand-written kernel."""
    import exllamav3_tpu_torch.modules.attn as attn_mod
    import exllamav3_tpu_torch.modules.block_sparse_mlp as moe_mod
    import exllamav3_tpu_torch.modules.linear as linear_mod
    import exllamav3_tpu_torch.modules.mla_attn as mla_mod
    import exllamav3_tpu_torch.modules.mlp as mlp_mod
    import exllamav3_tpu_torch.modules.multilinear as multi_mod
    from exllamav3_tpu_torch.ops import fused_mlp as fm
    from exllamav3_tpu_torch.ops import q_matmul as qm
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_matmul_plain
    from exllamav3_tpu_torch.ops.flash_attention import (latent_attention_quant_plain,
                                                          linear_attention_quant_plain,
                                                          paged_attention_quant_plain)
    from exllamav3_tpu_torch.ops.moe_gemm import selected_expert_mlp_plain

    def attn_plain(q, layer_state, bt, qp, tl, k_bits=0, v_bits=0, compand_a=0.0, **kw):
        return paged_attention_quant_plain(q, layer_state, bt, qp, tl, k_bits, v_bits,
                                           compand_a, **kw)

    def linear_plain(q, layer_state, qp, tl, k_bits=0, v_bits=0, compand_a=0.0, **kw):
        return linear_attention_quant_plain(q, layer_state, qp, tl, k_bits, v_bits, compand_a,
                                            **kw)

    def latent_plain(q, layer_state, qp, tl, latent, k_bits=0, compand_a=0.0, **kw):
        return latent_attention_quant_plain(q, layer_state, qp, tl, k_bits, compand_a, **kw)

    def int8_plain(x, w_q, scale, bias=None):
        y = qm.int8_matmul_plain(x.reshape(-1, x.shape[-1]), w_q, scale)
        y = y if bias is None else y + bias
        return y.reshape(*x.shape[:-1], w_q.shape[1])

    def fused_mlp_plain(x, gu_q, gu_scale, d_q, d_scale, d_bias=None, activation="silu",
                        act_clamp=0.0):
        y = fm.fused_mlp_int8_plain(x.reshape(-1, x.shape[-1]), gu_q, gu_scale, d_q, activation,
                                    act_clamp)
        y = y * d_scale[None, :]
        return (y if d_bias is None else y + d_bias).reshape(x.shape)

    def experts_plain(x, topi, topv, wu, wd, wg=None, act_clamp=0.0):
        return selected_expert_mlp_plain(x, topi, topv, wg, wu, wd, act_clamp)

    swaps = [(linear_mod, "exl3_matmul", exl3_matmul_plain), (attn_mod, "paged_attention", attn_plain),
             (attn_mod, "linear_attention", linear_plain), (mla_mod, "latent_attention", latent_plain),
             (linear_mod, "int8_matmul", int8_plain), (multi_mod, "int8_matmul", int8_plain),
             (mlp_mod, "fused_mlp_int8", fused_mlp_plain),
             (moe_mod, "selected_expert_mlp", experts_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_packed_linears():
    """Inside, the packed linears' dispatchers run their plain PyTorch
    versions on the card's tensors (the a8 or the bf16 product, as the
    variables say), so a forward goes through none of the four kernels."""
    import exllamav3_tpu_torch.modules.linear as linear_mod
    import exllamav3_tpu_torch.modules.multilinear as multi_mod
    import exllamav3_tpu_torch.ops.q_matmul as qm
    from exllamav3_tpu_torch.util.env import env_bool

    def int4_plain(x, packed, scales, bias=None):
        fn = qm.int4_matmul_a8_plain if env_bool("EXL3TPU_INT4_A8", True) else qm.int4_matmul_plain
        return qm._over_rows(x, packed.shape[1], bias, lambda x2: fn(x2, packed, scales))

    def intb_plain(x, packed, scales, bits=None, bias=None):
        bits = bits or qm.intb_bits_from_shapes(packed.shape[0], scales.shape[0])
        fn = qm.intb_matmul_a8_plain if env_bool("EXL3TPU_INTB_A8", True) else qm.intb_matmul_plain
        return qm._over_rows(x, packed.shape[1], bias, lambda x2: fn(x2, packed, scales, bits))

    saved = [(mod, mod.int4_matmul, mod.intb_matmul) for mod in (linear_mod, multi_mod)]
    for mod in (linear_mod, multi_mod):
        mod.int4_matmul, mod.intb_matmul = int4_plain, intb_plain
    try:
        yield
    finally:
        for mod, f4, fb in saved:
            mod.int4_matmul, mod.intb_matmul = f4, fb


def _shift(a, b) -> tuple[float, float]:
    """max |a - b| over the range of b: at the last position, over all."""
    rng = float(b.max() - b.min())
    return float((a[-1] - b[-1]).abs().max()) / rng, float((a - b).abs().max()) / rng


def _layer_view(src: str, layers: int, files: list) -> str:
    """A checkpoint of the first `layers` layers of the checkpoint in `src`:
    its config.json with num_hidden_layers cut, beside links to `files` of
    src (the shards those layers need). Written once per machine, no tensor
    copied."""
    d = f"{src}_first{layers}"
    if not os.path.exists(os.path.join(d, "config.json")):
        os.makedirs(d, exist_ok=True)
        for f in files:
            if not os.path.lexists(os.path.join(d, f)):
                os.symlink(os.path.join(src, f), os.path.join(d, f))
        with open(os.path.join(src, "config.json")) as f:
            cfg = json.load(f)
        cfg["num_hidden_layers"] = layers
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
    return d


def _checkpoint(layers: int) -> str:
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3

    if layers == SPEC_TARGET_LAYERS:  # the first layers of the 32-layer checkpoint
        return _layer_view(_checkpoint(32), layers, ["model.safetensors"])
    d = os.path.join(WORK, f"llama8b_{layers}layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_llama_exl3(d, tiny_llama_cfg(num_layers=layers, **LLAMA8B), K=4,
                              seed=1 if layers == 2 else 0)
    log(f"checkpoint: {layers} layers at 8B width ready in {time.time() - t0:.1f} s ({d})")
    return d


def _serve_prompts(V: int = LLAMA8B["vocab_size"]):
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, V, 512)
    # the longest request arrives first, so its prefill registers the shared pages
    lengths = np.linspace(1536, 512, 8).astype(int)
    return [np.concatenate([prefix, rng.integers(0, V, n - 512)]) for n in lengths]


def _drive(tag: str, gen, prompts: list, V: int, new_tokens: int = 128):
    """Serve `prompts` through `gen`, `new_tokens` greedy tokens each: the
    first request arrives alone, the rest once it decodes (and find its
    prefix cached). Every kernel's count is set to 0 before and read after.
    Checks that each request finished with its tokens in range and prints
    its TTFT. Returns (jobs, finished events by id, decode-only tokens and
    seconds, wall seconds, launch counts)."""
    from exllamav3_tpu_torch.generator import GreedySampler, Job

    jobs = [Job(p, max_new_tokens=new_tokens, sampler=GreedySampler()) for p in prompts]
    _reset_counts()
    finished = {}
    decode_tokens, decode_s = 0, 0.0
    torch.cuda.synchronize()
    t_start = time.time()
    gen.enqueue(jobs[0])
    while gen.num_remaining_jobs():
        if (len(jobs) > 1 and jobs[0].status == "running" and jobs[1].status == "queued"
                and jobs[1] not in gen.pending):
            gen.enqueue(jobs[1:])
        ti = time.time()
        prefilling = any(j.status == "prefill" for j in gen.active) or bool(gen.pending)
        res = gen.iterate()
        n_tok = sum(1 for r in res if r["stage"] == "streaming")
        if not prefilling:
            decode_tokens += n_tok
            decode_s += time.time() - ti
        for r in res:
            if r["stage"] == "finished":
                finished[r["identifier"]] = r
    torch.cuda.synchronize()
    wall = time.time() - t_start
    counts = _read_counts()
    for j in jobs:
        r = finished.get(j.identifier)
        if (r is None or len(r["new_tokens"]) != new_tokens
                or r["eos_reason"] != "max_new_tokens"):
            raise AssertionError(f"{tag}: request {j.identifier} did not finish with "
                                 f"{new_tokens} tokens")
        if not all(0 <= t < V for t in r["new_tokens"]):
            raise AssertionError(f"{tag}: token id out of range")
        log(f"{tag}: request prompt={r['prompt_tokens']} cached_tokens={r['cached_tokens']} "
            f"ttft_s={r['ttft_s']:.4f} prefill_s={r['prefill_s']:.4f} "
            f"generate_tok_s={r['generate_tok_s']:.2f}")
    return jobs, finished, decode_tokens, decode_s, wall, counts


def _load_model(tag: str, ckpt: str, linear_mode: str, expect_mode: str):
    """The checkpoint `ckpt` loaded on the card in `linear_mode`, its load
    time and memory printed; raises unless the mode resolved to
    `expect_mode`."""
    from exllamav3_tpu_torch.model import Config, InferParams, Model
    from exllamav3_tpu_torch.model.model import estimate_linear_mode_bytes

    cfg = Config.from_directory(ckpt, infer_params=InferParams(linear_mode=linear_mode))
    model = Model.from_config(cfg, device="cuda")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model.load()
    torch.cuda.synchronize()
    log(f"{tag}: {cfg.num_hidden_layers} layers, linear_mode resolved to "
        f"{cfg.infer_params.linear_mode}, load {time.time() - t0:.1f} s, weights' device memory "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB, peak during load "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if expect_mode in ("int8", "int6", "int4", "fused"):
        log(f"{tag}: the ladder's estimate for {expect_mode}: "
            f"{estimate_linear_mode_bytes(cfg, expect_mode) / 2**30:.2f} GiB")
    if cfg.infer_params.linear_mode != expect_mode:
        raise AssertionError(f"{tag}: linear mode did not resolve to {expect_mode}")
    return model


def _serve(tag: str, ckpt: str, linear_mode: str, spec_kw: dict, expect_mode: str,
           prompts: list, trace: bool = True, step_launches: dict | None = None,
           model=None, new_tokens: int = 128, gen_kw: dict | None = None,
           out: dict | None = None, check_accounting: bool = False) -> dict:
    """Load the checkpoint `ckpt` in `linear_mode` (or take `model`, loaded
    from it already), serve `prompts` (`new_tokens` greedy tokens each; the first
    arrives alone, the rest once it decodes) over a paged cache made with
    `spec_kw`, and check the outcome. The generator takes its defaults (decode
    bursts of 8, captured as CUDA graphs where the model declares graph
    decode) unless `gen_kw` says otherwise; its decode route, steps and
    graphs are printed. A cache with SWA rings (spec_kw swa_ring) reuses no
    prefix pages and reports its rings' bytes. `step_launches` names launch
    counts one batch-1 decode step must show; with `check_accounting` the
    run's counts must equal that step's times the decode steps run (eager
    and replayed) plus the prefill chunks' own. `out`, where given, receives
    each request's tokens and TTFT, the decode-only rate and the traced
    window's figures. Returns the kernels' launch counts over the measured
    run."""
    from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    if model is None:
        model = _load_model(tag, ckpt, linear_mode, expect_mode)
    V = model.config.vocab_size
    base = torch.cuda.memory_allocated()
    cache = Cache(model, CacheSpec(num_pages=72, **spec_kw))
    log(f"{tag}: cache {spec_kw or 'bf16'}: "
        f"{(torch.cuda.memory_allocated() - base) / (72 * 256):.0f} bytes per token")
    rings = [layer for layer in cache.state.values() if "pos" in layer]
    if rings and "k" not in rings[0]:  # DeepSeek-V4: rings, buffers and paged pools
        slot_b = sum(t.numel() * t.element_size() for layer in rings
                     for n, t in layer.items() if not n.startswith("pg_"))
        pool_b = sum(t.numel() * t.element_size() for layer in rings
                     for n, t in layer.items() if n.startswith("pg_"))
        n_slots = rings[0]["pos"].shape[0]
        log(f"{tag}: per-slot state (rings and compressor buffers of {len(rings)} layers) "
            f"{slot_b} bytes ({slot_b / 2**30:.3f} GiB) for {n_slots} state slots, "
            f"{slot_b / n_slots:.0f} a slot; the compressed pools {pool_b / (72 * 256):.2f} "
            f"bytes a token")
    elif rings:
        def nbytes(layers):
            return sum(t.numel() * t.element_size() for layer in layers for t in layer.values())
        paged = [layer for layer in cache.state.values() if "pos" not in layer]
        per_token = nbytes(paged) / (72 * 256)
        log(f"{tag}: {len(rings)} SWA rings of {tuple(rings[0]['k'].shape)}: {nbytes(rings)} "
            f"bytes ({nbytes(rings) / 2**30:.2f} GiB) for {rings[0]['pos'].shape[0]} state slots; "
            f"paged cache bytes a token {per_token:.0f} with the rings, "
            f"{per_token * len(cache.state) / len(paged):.0f} without")
    gen = Generator(model, cache, max_batch_size=8, max_chunk_size=2048, seed=0, **(gen_kw or {}))
    prefill_counts: dict = {}
    prefill_job = gen._prefill_job

    def counted_prefill(*a):  # the prefill chunks' launches, apart from the decode steps'
        before = _read_counts()
        n = prefill_job(*a)
        for name, c in counts_since(before).items():
            prefill_counts[name] = prefill_counts.get(name, 0) + c
        return n
    gen._prefill_job = counted_prefill
    jobs, finished, decode_tokens, decode_s, wall, counts = _drive(tag, gen, prompts, V,
                                                                   new_tokens)
    gen._prefill_job = prefill_job
    dec = gen.decoder
    decode_steps = dec.steps
    log(f"{tag}: decode route {'captured CUDA graphs' if dec.capture else 'eager'}, bursts of "
        f"up to {gen.decode_burst} steps ({gen.prefill_burst} while a prompt is prefilled), "
        f"{decode_steps} decode steps for {new_tokens * len(jobs)} tokens; buckets (B, pages) "
        f"{sorted(dec.buckets)}; {dec.graphs_captured} graphs captured in {dec.capture_s:.3f} s, "
        f"their pool {dec.pool_bytes} bytes ({dec.pool_bytes / 2**20:.1f} MiB)")
    total_new = new_tokens * len(jobs)
    reused = sum(finished[j.identifier]["cached_tokens"] for j in jobs)
    # cross-path check: the first generated token of request 0 lies in the
    # top 5 of a reference forward at the end of its prompt. Over the bf16
    # cache that is the cacheless forward (dense attention, no cache). A
    # quantized cache computes another function, so there the reference is
    # the whole prompt as one chunk through a fresh cache of the same widths
    # with every linear and the attention in their plain PyTorch versions:
    # no generator, no prefix reuse, and no kernel of the served path. The
    # distance of that reference from the cacheless forward (what the cache's
    # widths do to the logits) and the kernels' distance from it are printed
    first = finished[jobs[0].identifier]["new_tokens"][0]
    if spec_kw.get("k_bits"):
        n = len(prompts[0])
        pages = -(-n // 256)
        one_chunk = (np.arange(n, dtype=np.int32)[None], np.array([0], np.int32),
                     np.array([list(range(1, pages + 1)) + [0]], np.int32))
        spec = CacheSpec(num_pages=pages + 1, **spec_kw)
        kern = model.forward(prompts[0][None], Cache(model, spec), *one_chunk)[0]
        before = _read_counts()
        with plain_ops():
            ref_all = model.forward(prompts[0][None], Cache(model, spec), *one_chunk)[0]
            simple = model.forward_simple(prompts[0][None])[0]
        if _read_counts() != before:
            raise AssertionError(f"{tag}: the plain reference launched a kernel")
        rank_simple = int((simple[-1] > simple[-1, first]).sum())
        q_last, q_all = _shift(ref_all, simple)
        k_last, k_all = _shift(kern, ref_all)
        agree = float((kern.argmax(-1) == ref_all.argmax(-1)).float().mean())
        log(f"{tag}: plain reference over the {spec_kw} cache against the plain cacheless "
            f"forward, {n} positions: logits differ by {q_last:.4f} of their range at the last "
            f"position and {q_all:.4f} at the worst; request 0's first token has rank "
            f"{rank_simple} in the cacheless forward (not required)")
        log(f"{tag}: kernels against the plain reference, same cache widths: {k_last:.4f} of "
            f"the range at the last position, {k_all:.4f} at the worst, top-1 agreement "
            f"{agree:.4f}")
        ref = ref_all[-1]
        if not (torch.isfinite(kern).all() and k_last <= TOL_QUANT_PATH):
            raise AssertionError(f"{tag}: the kernels' logits at the last position are "
                                 f"{k_last} of the range from the plain reference")
        del kern, ref_all, simple
    else:
        ref = model.forward_simple(prompts[0][None])[0, -1]
    top5 = set(torch.topk(ref, 5).indices.tolist())
    log(f"{tag}: {len(finished)} requests finished, {total_new} tokens in {wall:.3f} s "
        f"({total_new / wall:.2f} tok/s overall), decode-only iterations "
        f"{decode_tokens} tokens in {decode_s:.3f} s "
        f"({decode_tokens / max(decode_s, 1e-9):.2f} tok/s), prefix tokens reused {reused}, "
        f"first token of request 0 in the reference's top-5: {first in top5}")
    log(f"{tag}: kernel launches {json.dumps(counts)}")

    # launches of one batch-1 decode step (a 512-token context, fresh cache)
    c1 = Cache(model, CacheSpec(num_pages=4, **spec_kw))
    model.forward(prompts[-1][None, :511], c1, np.arange(511, dtype=np.int32)[None],
                  np.array([0], np.int32), np.array([[1, 2, 0]], np.int32))
    _reset_counts()
    model.forward(prompts[-1][None, 511:512], c1, np.array([[511]], np.int32),
                  np.array([511], np.int32), np.array([[1, 2, 0]], np.int32))
    step = _read_counts()
    log(f"{tag}: launches per batch-1 decode step " + json.dumps(step))
    if step_launches and any(step[n] != c for n, c in step_launches.items()):
        raise AssertionError(f"{tag}: a decode step launched {step}, expected {step_launches}")
    if check_accounting:
        want = {n: step[n] * decode_steps + prefill_counts.get(n, 0) for n in counts}
        log(f"{tag}: launches by replay accounting: {decode_steps} decode steps x the batch-1 "
            f"step's, plus the prefill chunks' {json.dumps(prefill_counts)}")
        if want != counts:
            raise AssertionError(f"{tag}: the run launched {counts}, the steps account for {want}")
    del c1
    window = None
    if trace:
        # a traced window of decode iterations over the same prompts
        # (prefixes now cached), after and apart from the measured run: 4
        # iterations, each a burst of up to decode_burst steps
        gen.enqueue([Job(p, max_new_tokens=64, sampler=GreedySampler()) for p in prompts])
        while gen.pending or any(j.status == "prefill" for j in gen.active):
            gen.iterate()
        before = _read_counts()
        window = profile_decode(gen.iterate, 4, f"decode steps (batch {len(gen.active)})")
        if check_accounting:
            _traced_launches(tag, counts_since(before), window)
        while gen.num_remaining_jobs():
            gen.iterate()
    if out is not None:
        out.update(tokens=[finished[j.identifier]["new_tokens"] for j in jobs],
                   ids=[j.identifier for j in jobs],
                   ttft=[finished[j.identifier]["ttft_s"] for j in jobs],
                   decode_tok_s=decode_tokens / max(decode_s, 1e-9), steps=decode_steps,
                   capture=dec.capture, window=window)
    if first not in top5:
        raise AssertionError(f"{tag}: generator's first token disagrees with the reference forward")
    if len(jobs) > 1 and (reused <= 0) != bool(rings):
        raise AssertionError(f"{tag}: {reused} prefix tokens reused "
                             f"({'none' if rings else 'some'} expected)")
    del model, cache, gen
    gc.collect()  # a model's modules refer to each other: free its tensors now
    torch.cuda.empty_cache()
    return counts


# the device kernel that each wrapper of the serve path launches once a call
# at decode shapes, as the profiler names it (csrc/int8_staged.cuh: epilogue
# 0 SCALED, 1 GATE_UP; the fused MLP's down projection is the SCALED body
# launched with WAIT true, its gate_up the GATE_UP body)
TRACE_KERNELS = {"int8_matmul": re.compile(r"\bint8_decode_kernel<\d, 0, false>"),
                 "fused_mlp": re.compile(r"\bint8_decode_kernel<\d, 1, false>"),
                 "paged_attention": re.compile(r"::decode_kernel<.*PagedRows")}


def _traced_launches(tag: str, accounted: dict, window: dict | None):
    """The launches that the wrappers' counts (replays add what their
    capture counted) give the traced window, held against the kernels that
    the device trace of the same window shows: a replay must have launched
    what it is credited with."""
    if window is None:
        log(f"{tag}: the trace holds no device kernel: launches in the replays not measured")
        return
    seen = {name: sum(n for k, n in window["names"].items() if pat.search(k))
            for name, pat in TRACE_KERNELS.items()}
    log(f"{tag}: traced window's launches by the wrappers' counts {json.dumps(accounted)}, "
        f"in the device trace {json.dumps(seen)}")
    if set(accounted) - set(TRACE_KERNELS) or any(seen[n] != accounted.get(n, 0) for n in seen):
        raise AssertionError(f"{tag}: the device trace shows {seen} launches, the counts "
                             f"{accounted}")


def _require_launches(tag: str, counts: dict, used: tuple):
    """Every kernel in `used` launched in the run, and no other kernel."""
    if min(counts[n] for n in used) <= 0:
        raise AssertionError(f"{tag}: a kernel of this path never launched: {counts}")
    if any(n for name, n in counts.items() if name not in used):
        raise AssertionError(f"{tag}: a kernel of another path launched: {counts}")


JAX_PAGES_BUCKETS = (4, 16, 64, 256, 1024, 4096)  # the JAX generator's table widths


def _graph_against_eager(model, prompts: list, steps: int = 64):
    """The captured decode step against the eager one at the same bucketed
    shapes (batch 8, the table's power of two of pages), from the same cache
    state and counts: one step (the warm-up before the capture, a replay and
    an eager step) and an 8-step burst must give bit-identical logits and
    tokens. Then the time a step of `steps` eager steps, and of `steps`
    replays at the table's power of two of pages and at the JAX package's
    wider table (whose split-key decode sizes its splits for more keys),
    the two widths in turns."""
    from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
    from exllamav3_tpu_torch.generator import decode_graph as dg
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    gen = Generator(model, Cache(model, CacheSpec(num_pages=72)), max_batch_size=8,
                    max_chunk_size=2048, seed=0)
    jobs = [Job(p, max_new_tokens=4 * steps, sampler=GreedySampler()) for p in prompts]
    gen.enqueue(jobs)
    while any(j.status != "running" for j in jobs):
        gen.iterate()
    if not gen._grow_window(jobs, steps):
        raise AssertionError("serve graph: no pages for the timed steps")
    args = ([j.new_tokens[-1] if j.new_tokens else j.input_ids[-1] for j in jobs],
            [j.seq_len - 1 for j in jobs], [j.pages for j in jobs],
            [gen.job_slots[j] for j in jobs], [j.sampler for j in jobs])
    counts0 = gen.token_counts.clone()

    def make(capture: bool):  # the eager step padded as the captured one
        return dg.DecodeGraph(model, gen.cache, gen.token_counts, gen.rng, 8, steps,
                              capture=capture, keep_logits=True, pad=True)

    def run(step, n):
        gen.token_counts.copy_(counts0)
        toks = step.run(*args, n)
        return toks, step.last.logits.clone()

    graph, eager = make(True), make(False)
    warm = run(graph, 1)  # the eager warm-up, then the capture
    replay = run(graph, 1)
    plain = run(eager, 1)
    burst_g, burst_e = run(graph, 8), run(eager, 8)
    B, MP = graph.last.B, graph.last.MP
    same = all(np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in ((replay, plain), (warm, plain), (burst_g, burst_e)))
    log(f"serve graph: batch {B}, {MP} + 1 table columns: replayed and eager steps from one "
        f"cache state give bit-identical logits and tokens: {same} (one step: the warm-up, a "
        f"replay, an eager step; an 8-step burst each)")
    if not same:
        raise AssertionError("serve graph: a replayed step differs from the eager one")

    def timed(step) -> tuple[float, float]:
        gen.token_counts.copy_(counts0)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        t0.record()
        step.run(*args, steps)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / steps, (time.perf_counter() - h0) * 1e3 / steps

    @contextlib.contextmanager
    def jax_tables():  # the JAX generator's table buckets in place of powers of two
        pow2 = dg.pages_bucket
        dg.pages_bucket = lambda n: next(b for b in JAX_PAGES_BUCKETS if n <= b)
        try:
            yield
        finally:
            dg.pages_bucket = pow2

    wide = make(True)
    with jax_tables():
        run(wide, 1)
    MPj = wide.last.MP
    ms = {"eager": timed(eager)}
    turns: dict = {"replay": [], "replay, JAX table": []}
    for _ in range(2):  # the two table widths in turns, A B B A twice
        for name in ("replay", "replay, JAX table", "replay, JAX table", "replay"):
            if name == "replay":
                turns[name].append(timed(graph))
            else:
                with jax_tables():
                    turns[name].append(timed(wide))
    for name, runs in turns.items():
        ms[name] = tuple(sorted(r[i] for r in runs)[len(runs) // 2] for i in (0, 1))
    log(f"serve graph: ms a step over {steps} steps (device events; host clock), replays the "
        f"upper median of 4 in turns: "
        + ", ".join(f"{k} {a:.4f} ({h:.4f})" for k, (a, h) in ms.items())
        + f"; replays at {MP} + 1 columns " + " ".join(f"{r[0]:.4f}" for r in turns["replay"])
        + f", at {MPj} + 1 " + " ".join(f"{r[0]:.4f}" for r in turns["replay, JAX table"])
        + f"; the capture {graph.capture_s:.3f} s, its pool {graph.pool_bytes} bytes")
    gen.token_counts.copy_(counts0)
    del gen, graph, eager, wide
    _free()
    return ms


def phase_serve() -> dict:
    """The int8 path: linear_mode="auto" on an 80 GB card, bf16 cache,
    through the generator's default route (decode bursts of 8 over captured
    CUDA graphs), its launches held to the decode steps' and the prefill
    chunks'. With the checkpoint loaded once: the captured step against the
    eager one (_graph_against_eager), then the same requests through the
    eager single-step route (decode_burst=1, no graphs), whose greedy tokens
    must equal the graph route's up to a step where its top-2 logit gap is
    under GAP_LIMIT; both routes' decode rate, TTFT and traced figures per
    token are printed."""
    model = _load_model("serve", _checkpoint(32), "auto", "int8")
    prompts = _serve_prompts()
    used = ("int8_matmul", "fused_mlp", "paged_attention", "paged_attention_prefill")
    graph: dict = {}
    counts = _serve("serve", None, "auto", {}, "int8", prompts, model=model, out=graph,
                    check_accounting=True)
    _require_launches("serve", counts, used)
    if not graph["capture"]:
        raise AssertionError("serve: the Llama path did not capture its decode step")
    _graph_against_eager(model, prompts)
    eager: dict = {}
    with record_gaps() as gaps:
        _serve("serve eager", None, "auto", {}, "int8", prompts, model=model, out=eager,
               gen_kw=dict(decode_burst=1, decode_graphs=False))
    for i, (got, ref) in enumerate(zip(graph["tokens"], eager["tokens"])):
        same = next((n for n, (a, b) in enumerate(zip(got, ref)) if a != b), len(got))
        gap = gaps[eager["ids"][i]][same] if same < len(got) else None
        log(f"serve: request {i}: the graph route agrees with the eager route for {same} of "
            f"{len(got)} tokens" + ("" if gap is None else f", then parts where the eager "
                                    f"run's top-2 gap is {gap:.4e} of the logits' range"))
        if gap is not None and not gap < GAP_LIMIT:
            raise AssertionError(f"serve: request {i} parts from the eager route at token "
                                 f"{same}, where the top-2 gap is {gap} of the range")
    for name, r in (("graph route (bursts of 8)", graph), ("eager route (single steps)", eager)):
        w = r["window"] or {}
        per_token = (f"; traced window: {w['busy_ms'] / w['tokens']:.4f} ms busy, idle share "
                     f"{w['idle']:.4f}, {w['ops'] / w['tokens']:.1f} device ops a token"
                     if w.get("tokens") else "; traced window: not measured")
        log(f"serve {name}: decode-only {r['decode_tok_s']:.2f} tok/s over {r['steps']} decode "
            f"steps, TTFT first request {r['ttft'][0]:.4f} s, others "
            f"{min(r['ttft'][1:]):.4f}-{max(r['ttft'][1:]):.4f} s{per_token}")
    del model
    _free()
    return {n: counts[n] for n in used}


def phase_serve_capacity() -> dict:
    """The capacity path: trellis linears and a quantized cache. 32 layers
    with a (4, 4) cache (merged storage), then one request on 4 layers with a
    (5, 3) cache so that the per-head storage runs on a served path too. The
    cache's widths fix its storage, so each run's count of the quantized
    attention kernel (and of its prefill body) belongs to that storage's
    row of the table."""
    from exllamav3_tpu_torch.ops.kv_quant import merged_layout

    used = ("exl3_gemm", "paged_attention_quant", "paged_attention_quant_prefill")
    counts = _serve("serve_capacity", _checkpoint(32), "fused", dict(k_bits=4, v_bits=4), "fused",
                    _serve_prompts())
    _require_launches("serve_capacity", counts, used)
    odd = _serve("serve_capacity (5, 3)", _checkpoint(4), "fused", dict(k_bits=5, v_bits=3),
                 "fused", _serve_prompts()[:1], trace=False)
    _require_launches("serve_capacity (5, 3)", odd, used)
    if not merged_layout(4, 4) or merged_layout(5, 3):
        raise AssertionError("serve_capacity: the two runs did not use the two storages")
    return {"exl3_gemm": counts["exl3_gemm"],
            "paged_attention_quant_merged": counts["paged_attention_quant"],
            "paged_attention_quant_per_head": odd["paged_attention_quant"],
            "paged_attention_quant_prefill_merged": counts["paged_attention_quant_prefill"],
            "paged_attention_quant_prefill_per_head": odd["paged_attention_quant_prefill"]}


@contextlib.contextmanager
def environ(**values):
    """Set environment variables inside, restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_serve_packed() -> dict:
    """The packed-integer tiers. 32 layers in int4 through the a8 kernel over
    the bf16 cache (the bf16 kernel where the caller sets EXL3TPU_INT4_A8=0);
    one request on 4 layers for each of the other three packed kernels; then
    linear_mode="auto" on every rung of the ladder."""
    import exllamav3_tpu_torch.model.model as pmodel
    from exllamav3_tpu_torch.model import Config, InferParams, Model
    from exllamav3_tpu_torch.util.env import env_bool

    launches = {}
    int4 = "int4_matmul_a8" if env_bool("EXL3TPU_INT4_A8", True) else "int4_matmul"
    runs = [("serve_packed int4", 32, "int4", int4, {}, _serve_prompts(), True),
            ("serve_packed int6", 4, "int6", "intb_matmul_a8", {}, _serve_prompts()[:1], False),
            ("serve_packed int4 EXL3TPU_INT4_A8=0", 4, "int4", "int4_matmul",
             {"EXL3TPU_INT4_A8": "0"}, _serve_prompts()[:1], False),
            ("serve_packed int6 EXL3TPU_INTB_A8=0", 4, "int6", "intb_matmul",
             {"EXL3TPU_INTB_A8": "0"}, _serve_prompts()[:1], False)]
    for tag, layers, mode, kernel, env, prompts, trace in runs:
        with environ(**env):
            counts = _serve(tag, _checkpoint(layers), mode, {}, mode, prompts, trace=trace)
        _require_launches(tag, counts, (kernel, "paged_attention", "paged_attention_prefill"))
        launches[kernel] = counts[kernel]

    # the ladder: a device just large enough for each rung, and one too small
    # for int4, which takes `fused`
    d = _checkpoint(2)
    cfg = Config.from_directory(d)
    need = {m: pmodel.estimate_linear_mode_bytes(cfg, m) for m in ("int8", "int6", "int4", "fused")}
    real_hbm = pmodel.device_hbm_bytes
    ids = np.random.default_rng(12).integers(0, LLAMA8B["vocab_size"], size=(1, 8))
    for rung in ("int8", "int6", "int4", "fused"):
        hbm = math.ceil(need[rung] / 0.8) + 1 if rung != "fused" else int(need["int4"] / 0.8) - 1
        picked = pmodel.select_linear_mode(cfg, hbm)
        auto = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
        model = Model.from_config(auto, device="cuda")
        base = torch.cuda.memory_allocated()
        pmodel.device_hbm_bytes = lambda device, hbm=hbm: hbm
        try:
            model.load()
        finally:
            pmodel.device_hbm_bytes = real_hbm
        logits = model.forward_simple(ids)
        torch.cuda.synchronize()
        log(f"serve_packed ladder: device memory {hbm} bytes -> select_linear_mode {picked}, "
            f"auto loaded as {auto.infer_params.linear_mode}; estimate "
            f"{need[rung] / 2**30:.3f} GiB, measured "
            f"{(torch.cuda.memory_allocated() - base) / 2**30:.3f} GiB on 2 layers")
        if not (picked == rung and auto.infer_params.linear_mode == rung
                and torch.isfinite(logits).all()):
            raise AssertionError(f"serve_packed ladder: rung {rung} resolved to {picked} / "
                                 f"{auto.infer_params.linear_mode}")
        del model, logits
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_serve_packed_int6() -> dict:
    """The int6 rung alone, all 8 requests of `serve` on 4 layers of the
    8B-width checkpoint through the a8 int-B kernel, traced: the run that
    tools/torch_attention_ab.py --run serve_packed_int6 compares (not in the
    default phases; serve_packed serves int6 one request)."""
    tag = "serve_packed int6"
    counts = _serve(tag, _checkpoint(4), "int6", {}, "int6", _serve_prompts())
    used = ("intb_matmul_a8", "paged_attention", "paged_attention_prefill")
    _require_launches(tag, counts, used)
    return {n: counts[n] for n in used}


def _moe_checkpoint(layers: int) -> str:
    """A synthetic Qwen3-MoE EXL3 checkpoint at Qwen3-30B-A3B width, K=4,
    one shard a layer, written once per machine."""
    from exllamav3_tpu_torch.conversion.synth import tiny_moe_cfg, write_tiny_moe_exl3

    d = os.path.join(WORK, f"qwen3_30b_a3b_{layers}layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_moe_exl3(d, tiny_moe_cfg(num_layers=layers, **QWEN3_30B), K=4,
                            seed=3 if layers == PARITY_LAYERS else 2)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"checkpoint: {layers} layers at Qwen3-30B-A3B width ready in {time.time() - t0:.1f} s, "
        f"{size / 2**30:.2f} GiB on disk ({d})")
    return d


def phase_serve_moe() -> dict:
    """The MoE path: Qwen3-MoE at Qwen3-30B-A3B width, linear_mode="auto"
    (int8 attention and head, bf16 expert stacks), bf16 cache."""
    used = ("int8_matmul", "paged_attention", "paged_attention_prefill", "moe_gemm")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve_moe: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the load")
    ckpt = _moe_checkpoint(MOE_SERVE_LAYERS)
    model = _load_model("serve_moe", ckpt, "auto", "int8")
    counts = _serve("serve_moe", ckpt, "auto", {}, "int8", _serve_prompts(QWEN3_30B["vocab_size"]),
                    model=model)
    _require_launches("serve_moe", counts, used)
    _wide_moe_step(model)
    del model
    _free()
    shutil.rmtree(ckpt)  # ~7.5 GB that no later phase reads
    return {n: counts[n] for n in used}


def _wide_moe_step(model, rows: int = 12, steps: int = 2):
    """A burst of `rows` rows through the generator's decoder at its
    default max_batch_size, whose bucket (16) lies above the model's
    graph_decode_rows (15): it runs eagerly at its exact rows, and every MoE
    layer launches the selected-expert kernel (moe_gemm) each step, not the
    grouped path."""
    from exllamav3_tpu_torch.generator import Generator, GreedySampler
    from exllamav3_tpu_torch.model import Cache, CacheSpec
    from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP

    gen = Generator(model, Cache(model, CacheSpec(num_pages=rows + 1)), seed=0)
    dec = gen.decoder
    _reset_counts()
    toks = dec.run(list(range(5, 5 + rows)), [0] * rows, [[1 + i] for i in range(rows)],
                   list(range(rows)), [GreedySampler()] * rows, steps)
    got = _read_counts()
    _reset_counts()
    layers = sum(isinstance(m, BlockSparseMLP) for top in model.modules for m in top.walk())
    log(f"serve_moe: {rows} rows, {steps} steps through the decoder (max_batch_size "
        f"{gen.max_batch_size}, graphs up to {dec.max_rows} rows): batch {dec.last.B}, "
        f"{dec.graphs_captured} graphs; moe_gemm {got['moe_gemm']} launches for {layers} layers")
    if not (dec.capture and dec.last.B == rows and dec.graphs_captured == 0
            and got["moe_gemm"] == layers * steps and toks.shape == (steps, rows)
            and ((toks >= 0) & (toks < model.config.vocab_size)).all()):
        raise AssertionError(f"serve_moe: a {rows}-row decode step left the selected-expert "
                             f"route: {got}")
    del gen



def _mla_checkpoint(layers: int) -> str:
    """A synthetic DeepSeek-V2-Lite EXL3 checkpoint at full width (the
    published config.json, cut to `layers` layers), K=4, one shard a layer,
    written once per machine."""
    from exllamav3_tpu_torch.conversion.synth import deepseek_v2_lite_cfg, write_tiny_deepseek_exl3

    d = os.path.join(WORK, f"deepseek_v2_lite_{layers}layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_deepseek_exl3(d, deepseek_v2_lite_cfg(num_hidden_layers=layers), K=4,
                                 seed=5 if layers == 2 else 4)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"checkpoint: {layers} layers at DeepSeek-V2-Lite width ready in {time.time() - t0:.1f} s, "
        f"{size / 2**30:.2f} GiB on disk ({d})")
    return d


def phase_parity_mla():
    """The MLA path on a 2-layer DeepSeek-V2-Lite checkpoint at full width
    (layer 0 dense, layer 1 MoE with shared experts; int8 projections and
    head, bf16 kv_a projection, dense MLP and expert stacks): forward_simple,
    a paged prefill and decode steps over a bf16 latent cache, GPU (kernels)
    against CPU (plain versions), the GPU given the CPU's routing as in
    parity_moe, every position held to TOL_MOE_PATH; then a prefill and a
    decode step over a (4)-bit latent cache, held to TOL_QUANT_PATH. Each
    prefill runs the latent prefill body once a layer, each decode step the
    split-key kernel."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = _mla_checkpoint(2)
    cfg = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
    gpu = Model.from_config(cfg, device="cuda")
    gpu.load()
    cpu = Model.from_config(cfg, device="cpu")
    cpu.params = params_to(gpu.params, "cpu")
    V = V2_LITE["vocab_size"]
    ids = np.random.default_rng(18).integers(0, V, size=(1, 400))
    tag = f"DeepSeek-V2-Lite {cfg.infer_params.linear_mode}"
    log(f"parity: {tag}, 2 layers at DeepSeek-V2-Lite width, the GPU on the CPU's routing")

    def both(what, fn, rel_tol):
        with record_routing() as ref_w:
            ref = fn(cpu)
        with record_routing(forced=ref_w) as own_w:
            got = fn(gpu)
        alike = torch.stack([((a > 0) == (b > 0)).all(dim=-1) for a, b in zip(own_w, ref_w)])
        log(f"parity {tag} {what}: the GPU's own expert sets agree with the CPU's for "
            f"{float(alike.float().mean()):.4f} of {alike.numel()} (token, layer) pairs")
        _compare(f"{tag} {what}", got, ref, rel_tol)

    both("forward_simple S=96", lambda m: m.forward_simple(ids[:, :96]), TOL_MOE_PATH)
    bt = np.array([[1, 2, 0]], np.int32)
    S = 300
    for spec_kw, steps, rel_tol in (({}, 4, TOL_MOE_PATH), (dict(k_bits=4, v_bits=4), 1,
                                                            TOL_QUANT_PATH)):
        caches = {m: Cache(m, CacheSpec(num_pages=4, **spec_kw)) for m in (gpu, cpu)}
        c = f"cache={spec_kw or 'bf16'}"
        prefill = "latent_attention_quant_prefill" if spec_kw else "latent_attention_prefill"
        before = _read_counts()
        both(f"paged prefill S={S} {c}", lambda m: m.forward(
            ids[:, :S], caches[m], np.arange(S, dtype=np.int32)[None], np.array([0], np.int32),
            bt), rel_tol)
        if _read_counts()[prefill] - before[prefill] != 2:
            raise AssertionError(f"parity {tag} {c}: the prefill did not run the latent prefill "
                                 "body once a layer")
        before = _read_counts()
        for p in range(S, S + steps):
            both(f"paged decode pos={p} {c}", lambda m: m.forward(
                ids[:, p: p + 1], caches[m], np.array([[p]], np.int32), np.array([p], np.int32),
                bt), rel_tol)
        after = _read_counts()
        latent = "latent_attention_quant" if spec_kw else "latent_attention"
        if (after["moe_gemm"] - before["moe_gemm"] != steps
                or after[latent] - before[latent] != 2 * steps
                or after["paged_attention"] != before["paged_attention"]):
            raise AssertionError(f"parity {tag} {c}: the decode steps did not run the "
                                 "selected-expert kernel once and the latent kernel twice a step")
        del caches
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_mla() -> dict:
    """The MLA path: DeepSeek-V2-Lite at full width and all 27 layers,
    linear_mode="auto" (int8 projections and head; bf16 kv_a projection,
    dense MLP and expert stacks), over a bf16 paged latent cache; then one
    request of 32 tokens over a (4)-bit latent cache. Prompts take the latent
    prefill body, decode steps the split-key kernel."""
    used = ("int8_matmul", "fused_mlp", "moe_gemm", "latent_attention", "latent_attention_prefill")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = _mla_checkpoint(V2_LITE["num_layers"])
    prompts = _serve_prompts(V2_LITE["vocab_size"])
    # one load serves both caches
    model = _load_model("serve_mla", ckpt, "auto", "int8")
    counts = _serve("serve_mla", ckpt, "auto", {}, "int8", prompts, model=model)
    _require_launches("serve_mla", counts, used)
    # 32 tokens: the quantized latent decode runs at batch 1 (~7 tok/s), so
    # its depth is cut rather than the bf16 run's
    quant = _serve("serve_mla (4)-bit latent", ckpt, "auto", dict(k_bits=4, v_bits=4), "int8",
                   prompts[:1], trace=False, model=model, new_tokens=32)
    quant_used = used[:3] + ("latent_attention_quant", "latent_attention_quant_prefill")
    _require_launches("serve_mla (4)-bit latent", quant, quant_used)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)  # ~8 GB that no later phase reads
    return {**{n: counts[n] for n in used}, **{n: quant[n] for n in quant_used[3:]}}


# -- phases: parity_gemma, serve_gemma ---------------------------------------------

# google/gemma-3-27b-it text_config (conversion/synth.py::gemma3_27b_cfg)
GEMMA27B = dict(vocab_size=262208, num_layers=62)
# cut from 62 to 12 (two global layers, 10 sliding) when the latent prefill
# joined the call and the call neared its 1200 s limit on a slow host: the
# 62-layer checkpoint's write and serve were its largest share
GEMMA_SERVE_LAYERS = 12


def _gemma_checkpoint(layers: int) -> str:
    """A synthetic Gemma-3 EXL3 checkpoint at Gemma-3-27B width, K=4, one
    shard a layer: GEMMA_SERVE_LAYERS of its layers, written once per
    machine, or a view of the first `layers` of them."""
    from exllamav3_tpu_torch.conversion.synth import gemma3_27b_cfg, write_tiny_gemma_exl3

    n = GEMMA_SERVE_LAYERS
    d = os.path.join(WORK, f"gemma3_27b_{n}layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_gemma_exl3(d, gemma3_27b_cfg(num_hidden_layers=n), K=4, seed=8)
    if layers < n:
        d = _layer_view(d, layers, ["model-embed.safetensors", "model-norm.safetensors"]
                        + [f"model-layer{i:03d}.safetensors" for i in range(layers)])
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"checkpoint: {layers} layers at Gemma-3-27B width ready in {time.time() - t0:.1f} s, "
        f"{size / 2**30:.2f} GiB on disk ({d})")
    return d


def _gemma_request(model, ring: bool, prompt, steps: int):
    """A prompt as one prefill chunk, then `steps` greedy decode steps over a
    fresh paged cache, its sliding layers in SWA rings (state slot 1) or in
    the pages. Returns (prefill logits (S, V), decode logits (steps, V), the
    fed tokens (steps,), launch counts of the decode steps)."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    n = prompt.shape[1]
    pages = -(-(n + steps) // 256)
    bt = np.array([list(range(1, pages + 1)) + [0]], np.int32)
    cache = Cache(model, CacheSpec(num_pages=pages + 1, swa_ring=ring, recurrent_slots=2))
    slots = np.array([1], np.int32) if ring else None
    pre = model.forward(prompt, cache, np.arange(n, dtype=np.int32)[None], np.array([0], np.int32),
                        bt, state_slots=slots)[0]
    toks, outs = [], []
    last = pre[-1]
    before = _read_counts()
    for i in range(steps):
        t = int(last.argmax())
        toks.append(t)
        p = n + i
        last = model.forward(np.array([[t]]), cache, np.array([[p]], np.int32),
                             np.array([p], np.int32), bt, state_slots=slots)[0, -1]
        outs.append(last)
    after = _read_counts()
    return pre, torch.stack(outs), toks, {k: after[k] - before[k] for k in after}


def phase_parity_gemma():
    """The Gemma-3 path on the first 6 layers of a Gemma-3-27B-width
    checkpoint (5 sliding, 1 global; int8 projections, gelu_pytorch_tanh
    fused decode MLP, bf16 tied head): one request of 1536 prompt tokens and
    32 greedy decode steps over the SWA ring on the GPU (the ring kernel),
    held to the CPU (plain versions: the prefill, then the 32 fed tokens as
    one chunk through the ring's dense path) at every position within 2e-2 of
    the largest logit; then the same request on the GPU with the sliding
    layers in the paged cache (the paged kernel with the window): logits
    within the same limit and the same greedy tokens."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = _gemma_checkpoint(6)
    cfg = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
    gpu = Model.from_config(cfg, device="cuda")
    gpu.load()
    cpu = Model.from_config(cfg, device="cpu")
    cpu.params = params_to(gpu.params, "cpu")
    n_ring = sum(1 for m in gpu.root.walk() if getattr(m, "sliding_window", 0))
    tag = f"Gemma-3-27B {cfg.infer_params.linear_mode}"
    log(f"parity: {tag}, 6 layers at Gemma-3-27B width ({n_ring} sliding)")
    prompt = np.random.default_rng(23).integers(0, GEMMA27B["vocab_size"], size=(1, 1536))
    steps = 32
    pre, dec, toks, counts = _gemma_request(gpu, True, prompt, steps)
    if (counts["ring_attention"] != n_ring * steps
            or counts["paged_attention"] != (6 - n_ring) * steps
            or counts["fused_mlp"] != 6 * steps):
        raise AssertionError(f"parity {tag}: the decode steps launched {counts}")
    t0 = time.time()
    n = prompt.shape[1]
    bt = np.array([list(range(1, 8)) + [0]], np.int32)
    cache = Cache(cpu, CacheSpec(num_pages=8, swa_ring=True, recurrent_slots=2))
    ring_slot = np.array([1], np.int32)
    ref_pre = cpu.forward(prompt, cache, np.arange(n, dtype=np.int32)[None],
                          np.array([0], np.int32), bt, state_slots=ring_slot)[0]
    _compare(f"{tag} prefill S={n} over the ring", pre, ref_pre)
    ref = cpu.forward(np.array([toks]), cache, (n + np.arange(steps, dtype=np.int32))[None],
                      np.array([n], np.int32), bt, state_slots=ring_slot)[0]
    log(f"parity {tag}: the CPU's side took {time.time() - t0:.1f} s")
    _compare(f"{tag} {steps} decode steps through the ring kernel, against one CPU chunk",
             dec, ref)
    _, dec_paged, toks_paged, counts_paged = _gemma_request(gpu, False, prompt, steps + 1)
    _, dec_ring, toks_ring, _ = _gemma_request(gpu, True, prompt, steps + 1)
    _compare(f"{tag} {steps + 1} decode steps over the ring against the pages", dec_ring,
             dec_paged)
    log(f"parity {tag}: greedy tokens over the ring {toks_ring[:8]}..., over the pages "
        f"{toks_paged[:8]}...; alike {sum(a == b for a, b in zip(toks_ring, toks_paged))} "
        f"of {steps + 1}")
    if toks_paged != toks_ring or toks_ring[:steps] != toks:
        raise AssertionError(f"parity {tag}: greedy tokens differ with and without the ring")
    if counts_paged["ring_attention"] or counts_paged["paged_attention"] != 6 * (steps + 1):
        raise AssertionError(f"parity {tag}: without the ring the steps launched {counts_paged}")
    del gpu, cpu, cache
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_gemma() -> dict:
    """The Gemma-3 path: Gemma-3-27B at full width and GEMMA_SERVE_LAYERS
    layers, linear_mode="auto" (int8 projections; the tied head bf16), a bf16
    paged cache with the sliding layers in SWA rings, 9 state slots (the
    batch of 8 and a scrap row). A decode step launches the ring kernel once
    a sliding layer and the paged kernel once a global layer."""
    from exllamav3_tpu_torch.model import Config

    used = ("int8_matmul", "fused_mlp", "paged_attention", "paged_attention_prefill",
            "ring_attention")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = _gemma_checkpoint(GEMMA_SERVE_LAYERS)
    cfg = Config.from_directory(ckpt)
    n_sliding = sum(cfg.layer_is_sliding(i) for i in range(cfg.num_hidden_layers))
    counts = _serve("serve_gemma", ckpt, "auto", dict(swa_ring=True, recurrent_slots=9), "int8",
                    _serve_prompts(GEMMA27B["vocab_size"]),
                    step_launches={"ring_attention": n_sliding,
                                   "paged_attention": cfg.num_hidden_layers - n_sliding})
    _require_launches("serve_gemma", counts, used)
    shutil.rmtree(os.path.join(WORK, f"gemma3_27b_{GEMMA_SERVE_LAYERS}layers"))  # ~3.5 GB
    return {n: counts[n] for n in used}


# -- phases: parity_dsv4, serve_dsv4 -------------------------------------------------

# the cuts of the DeepSeek-V4 phases: 2 layers (HCA then CSA; every layer also
# attends its sliding ring, so the two run all three row 6b entries) and one
# hash-routed layer, at full width (conversion/synth.py::deepseek_v4_cfg)
DSV4_CUTS = dict(num_hidden_layers=2, compress_ratios=[128, 4], num_hash_layers=1)


def _dsv4_checkpoint() -> str:
    """The 2-layer DeepSeek-V4 EXL3 checkpoint at full width (K=4, ~14 GB),
    written once per machine."""
    from exllamav3_tpu_torch.conversion.synth import deepseek_v4_cfg, write_tiny_deepseek_v4_exl3

    d = os.path.join(WORK, "dsv4_2layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_deepseek_v4_exl3(d, deepseek_v4_cfg(**DSV4_CUTS), K=4, seed=9)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"checkpoint: DeepSeek-V4 at full width, cut to {json.dumps(DSV4_CUTS)}, ready in "
        f"{time.time() - t0:.1f} s, {size / 2**30:.2f} GiB on disk ({d})")
    return d


def phase_parity_dsv4():
    """The DeepSeek-V4 path on the 2-layer full-width checkpoint (int8
    projections and head, bf16 expert stacks): a 2100-token prompt (so that
    the CSA layer selects 512 of up to 533 entries) as one prefill chunk, then
    32 greedy decode steps one token at a time through the row 6b kernels,
    against one dense forward (forward_simple) of the prompt and the same 32
    tokens, every decode position within 2e-2 of the largest logit. The
    router's bf16 logits round apart between a decode step's product and the
    2132-row one, and a last-bit difference picks another of the 256 experts
    (the MoE parity's finding): the dense forward takes the decode run's
    routing weights, and the share of its own expert sets alike is printed
    and held. The same 32 steps through the dense decode route
    (EXL3_TPU_ATTN=dense, the same routing) show how far two dense routes of
    one function lie apart on this model: the floor the kernels are read
    against."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model

    cfg = Config.from_directory(_dsv4_checkpoint(), infer_params=InferParams(linear_mode="auto"))
    model = Model.from_config(cfg, device="cuda")
    model.load()
    tag = f"DeepSeek-V4 {cfg.infer_params.linear_mode}"
    n, steps = 2100, 32
    prompt = np.random.default_rng(24).integers(0, cfg.vocab_size, size=(1, n))
    pages = -(-(n + steps) // 256)
    bt = np.array([list(range(1, pages + 1)) + [0]], np.int32)
    slot = np.array([1], np.int32)

    def decode(toks: list, forced=None):
        """The prompt as one chunk, then `steps` decode steps feeding `toks`
        (greedy when empty). -> (decode logits, fed tokens, routing weights,
        launch counts of the steps)"""
        cache = Cache(model, CacheSpec(num_pages=pages + 1, recurrent_slots=2))
        outs, fed = [], list(toks)
        with record_routing(forced=forced) as weights:
            last = model.forward(prompt, cache, np.arange(n, dtype=np.int32)[None],
                                 np.array([0], np.int32), bt, state_slots=slot)[0, -1]
            _reset_counts()
            for i in range(steps):
                if len(fed) <= i:
                    fed.append(int(last.argmax()))
                last = model.forward(np.array([[fed[i]]]), cache, np.array([[n + i]], np.int32),
                                     np.array([n + i], np.int32), bt, state_slots=slot)[0, -1]
                outs.append(last)
            counts = _read_counts()
        return torch.stack(outs), fed, weights, counts

    kern, toks, dec_w, counts = decode([])
    want = {"ring_attention_stats": 2 * steps, "pool_attention_stats": steps,
            "rows_attention_stats": steps, "moe_gemm": 2 * steps, "fused_mlp": 2 * steps}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"parity {tag}: the decode steps launched {counts}, expected {want}")
    forced = [torch.cat(dec_w)]  # the dense forward's one routing call (one sqrtsp layer)
    with uncounted(), record_routing(forced=forced) as own_w:
        ref = model.forward_simple(np.concatenate([prompt, np.array([toks])], axis=1))[0, n:]
    alike = ((own_w[0] > 0) == (forced[0] > 0)).all(dim=-1)
    agree = float(alike.float().mean())
    log(f"parity {tag}: the dense forward's own expert sets agree with the decode run's for "
        f"{agree:.4f} of {alike.numel()} tokens (layer 1; layer 0 routes by token id)")
    if agree < MIN_EXPERT_AGREEMENT:
        raise AssertionError(f"parity {tag}: expert sets agree for only {agree:.4f}")
    with uncounted(), environ(EXL3_TPU_ATTN="dense"):
        dense, _, _, dense_counts = decode(toks, forced=dec_w)
    if any(dense_counts[k] for k in ("ring_attention_stats", "pool_attention_stats",
                                     "rows_attention_stats")):
        raise AssertionError(f"parity {tag}: the dense decode route launched {dense_counts}")
    floor = float((dense - ref).abs().max()) / float(ref.abs().max())
    apart = float((kern - dense).abs().max()) / float(ref.abs().max())
    log(f"parity {tag}: the dense decode route against the dense forward: rel={floor:.3e}; "
        f"the kernel route against the dense decode route: rel={apart:.3e}")
    _compare(f"{tag} {steps} decode steps through the row 6b kernels (positions {n}-"
             f"{n + steps - 1}), against one dense forward", kern, ref)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_dsv4() -> dict:
    """The DeepSeek-V4 path: the 2-layer full-width checkpoint, linear_mode
    "auto" (int8 attention, shared experts and head; bf16 expert stacks) over
    a bf16 paged cache (the compressed pools) with 9 state slots (the rings
    and compressor buffers of the batch of 8 and a scrap row), the serve
    traffic. A decode step launches the ring kernel once a layer, the pool
    kernel in the HCA layer and the rows kernel in the CSA layer."""
    used = ("int8_matmul", "fused_mlp", "moe_gemm", "ring_attention_stats",
            "pool_attention_stats", "rows_attention_stats")
    gc.collect()
    torch.cuda.empty_cache()
    counts = _serve("serve_dsv4", _dsv4_checkpoint(), "auto", dict(recurrent_slots=9), "int8",
                    _serve_prompts(129280),
                    step_launches={"ring_attention_stats": 2, "pool_attention_stats": 1,
                                   "rows_attention_stats": 1, "moe_gemm": 2, "fused_mlp": 2})
    _require_launches("serve_dsv4", counts, used)
    shutil.rmtree(os.path.join(WORK, "dsv4_2layers"))  # ~14 GB
    return {n: counts[n] for n in used}


# -- phases: linear_decode, serve_spec ---------------------------------------------

# meta-llama/Llama-3.2-1B config.json; the vocabulary cut to the target's 32768,
# since a draft must share its target's vocabulary
LLAMA1B = dict(vocab_size=32768, hidden_size=2048, intermediate_size=8192, num_q_heads=32,
               num_kv_heads=8, head_dim=64, num_layers=16, tie_word_embeddings=True,
               rope_scaling={"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                             "original_max_position_embeddings": 8192, "rope_type": "llama3"},
               extra={"rope_theta": 500000.0, "max_position_embeddings": 131072})
GAP_LIMIT = 2e-2  # a speculative token may part from plain decoding only at a near-tie
# depth of the speculative serve's 8B-geometry target: 16 of its 32 layers,
# so that the whole script stays within 900 s with the Gemma phases
SPEC_TARGET_LAYERS = 16


def _free():
    gc.collect()  # a model's modules refer to each other: free its tensors now
    torch.cuda.empty_cache()


def _linear_decode(tag: str, model, B: int, spec_kw: dict, S: int = 512, steps: int = 32):
    """bench.py's decode measurement through Model.forward over a linear
    cache: a prefill of S random tokens a row, then 4 + `steps` greedy steps
    that feed their argmax back on the device; the host clock over the last
    `steps`, synchronised. The first decode step's logits are held to the
    same prefill and step over a paged cache (the same arithmetic), and to
    the serve phases' references: over a bf16 cache the step's token lies in
    the top 5 of the cacheless forward_simple; over a quantized one the
    logits lie within TOL_QUANT_PATH of the same S + 1 tokens as one chunk
    through a fresh linear cache of the same widths with every dispatch in
    its plain version. Returns tok/s."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    V = model.config.vocab_size
    warm = 4
    T = -(-(S + warm + steps) // 64) * 64
    cache = Cache(model, CacheSpec(layout="linear", batch_size=B, max_len=T, **spec_kw))
    ids = np.random.default_rng(17 + B).integers(0, V, (B, S))
    logits = model.forward(ids, cache, np.tile(np.arange(S, dtype=np.int32), (B, 1)),
                           np.zeros(B, np.int32))
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    t = torch.full((B,), S, dtype=torch.int32, device=model.device)
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.time()
        lg = model.forward(tok, cache, t[:, None], t)
        if i == 0:
            first_tok, first = tok.cpu().numpy(), lg[:, -1].clone()
        tok = lg[:, -1].argmax(dim=-1, keepdim=True)
        t = t + 1
    torch.cuda.synchronize()
    rate = B * steps / (time.time() - t0)
    full = np.concatenate([ids, first_tok], axis=1)
    with uncounted():
        # the same prefill and step over a paged cache of the same widths: the
        # same bodies walk the same keys, so the logits should not move
        pages = -(-(S + 1) // 256)
        pcache = Cache(model, CacheSpec(num_pages=B * pages + 1, **spec_kw))
        bt = np.concatenate([np.arange(1, B * pages + 1, dtype=np.int32).reshape(B, pages),
                             np.zeros((B, 1), np.int32)], axis=1)
        model.forward(ids, pcache, np.tile(np.arange(S, dtype=np.int32), (B, 1)),
                      np.zeros(B, np.int32), bt)
        paged = model.forward(first_tok, pcache, np.full((B, 1), S, np.int32),
                              np.full(B, S, np.int32), bt)[:, -1]
        rel = float((first - paged).abs().max() / paged.abs().max())
        log(f"parity {tag} B={B}: first decode step, linear against paged cache: "
            f"max_abs_err={float((first - paged).abs().max()):.4e} rel={rel:.3e}")
        if not (torch.isfinite(first).all() and rel <= TOL_ATTN):
            raise AssertionError(f"{tag}: linear and paged decode logits differ by {rel}")
        del pcache
        if not spec_kw:
            # the serve phases' cross-path check: the step's token in the top 5
            # of the cacheless forward (bf16 dense attention, three-dot MLP)
            ref = model.forward_simple(full)[:, -1]
            rank = (ref > ref.gather(-1, first.argmax(-1, keepdim=True))).sum(-1)
            log(f"parity {tag} B={B}: against forward_simple: rel "
                f"{float((first - ref).abs().max() / ref.abs().max()):.3e}, worst rank of the "
                f"step's token {int(rank.max())}")
            if int(rank.max()) >= 5:
                raise AssertionError(f"{tag}: the decode step's token is not in the top 5 of "
                                     "forward_simple")
        else:
            with plain_ops():
                ref = model.forward(full, Cache(model, CacheSpec(layout="linear", batch_size=B,
                                                                 max_len=T, **spec_kw)),
                                    np.tile(np.arange(S + 1, dtype=np.int32), (B, 1)),
                                    np.zeros(B, np.int32))[:, -1]
            shift = float(((first - ref).abs().amax(-1) / (ref.amax(-1) - ref.amin(-1))).max())
            log(f"parity {tag} B={B}: first decode step against the plain one-chunk forward "
                f"over the same widths: {shift:.4e} of the logits' range at the worst row")
            if not shift <= TOL_QUANT_PATH:
                raise AssertionError(f"{tag}: decode logits {shift} of the range from the plain "
                                     f"reference > {TOL_QUANT_PATH}")
    log(f"{tag}: decode batch {B} after a {S}-token prefill over a ({B}, {T}) linear "
        f"{spec_kw or 'bf16'} cache: {rate:.2f} tok/s")
    del cache
    return rate


def phase_linear_decode() -> dict:
    """bench.py's measurements through the port's Model.forward over a linear
    cache: the Llama-3.1-8B-geometry checkpoint in int8 over a bf16 cache,
    greedy decode at batch 1 and 8 after a 512-token prefill and one
    2048-token prefill; then the capacity model (`fused`) over a (4, 4)
    linear cache at full depth, and over (5, 3) on 4 layers."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    model = _load_model("linear_decode int8", _checkpoint(32), "auto", "int8")
    _reset_counts()
    for B in (1, 8):
        _linear_decode("linear_decode int8", model, B, {})
    Sp = 2048
    cache = Cache(model, CacheSpec(layout="linear", batch_size=1, max_len=Sp))
    ids = np.random.default_rng(18).integers(0, LLAMA8B["vocab_size"], (1, Sp))
    pos = np.arange(Sp, dtype=np.int32)[None]
    best = float("inf")
    for r in range(4):  # the first call warms up
        torch.cuda.synchronize()
        t0 = time.time()
        model.forward(ids, cache, pos, np.zeros(1, np.int32))
        torch.cuda.synchronize()
        if r:
            best = min(best, time.time() - t0)
    log(f"linear_decode int8: prefill {Sp} tokens in {best * 1e3:.2f} ms (best of 3): "
        f"{Sp / best:.2f} tok/s")
    counts = _read_counts()
    log(f"linear_decode int8: kernel launches {json.dumps(counts)}")
    _require_launches("linear_decode int8", counts, ("int8_matmul", "fused_mlp",
                                                     "linear_attention",
                                                     "linear_attention_prefill"))
    c1 = Cache(model, CacheSpec(layout="linear", batch_size=1, max_len=64))
    model.forward(ids[:, :8], c1, pos[:, :8], np.zeros(1, np.int32))
    _reset_counts()
    one = torch.full((1, 1), 8, dtype=torch.int32, device=model.device)
    profile_decode(lambda: model.forward(ids[:, 8:9], c1, one, one[0]), 1,
                   "linear-cache decode step (batch 1)")
    log("linear_decode int8: launches per batch-1 decode step " + json.dumps(_read_counts()))
    del model, cache, c1
    _free()

    launches = {}
    for layers, bits in ((32, (4, 4)), (4, (5, 3))):
        tag = f"linear_decode fused {bits}"
        spec_kw = dict(k_bits=bits[0], v_bits=bits[1])
        model = _load_model(tag, _checkpoint(layers), "fused", "fused")
        _reset_counts()
        _linear_decode(tag, model, 8, spec_kw)
        counts = _read_counts()
        log(f"{tag}: kernel launches {json.dumps(counts)}")
        _require_launches(tag, counts, ("exl3_gemm", "linear_attention_quant",
                                        "linear_attention_quant_prefill"))
        storage = "merged" if bits == (4, 4) else "per_head"
        launches[f"linear_attention_quant_{storage}"] = counts["linear_attention_quant"]
        launches[f"linear_attention_quant_prefill_{storage}"] = counts[
            "linear_attention_quant_prefill"]
        del model
        _free()
    return launches


def _draft_checkpoint() -> str:
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3

    d = os.path.join(WORK, "llama1b_16layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_llama_exl3(d, tiny_llama_cfg(**LLAMA1B), K=4, seed=4)
    log(f"checkpoint: Llama-3.2-1B geometry, 16 layers, tied head, ready in "
        f"{time.time() - t0:.1f} s ({d})")
    return d


@contextlib.contextmanager
def record_gaps():
    """Inside, each decode step records, for every job it samples a token
    for, the gap between the two largest logits it samples from over their
    range, by job identifier, one entry per token in output order. It reads
    each step's logits on the host, so it serves the eager single-step route
    only (decode_burst=1, decode_graphs=False): a step's rows are its jobs in
    order, then the padded rows, whose gaps are dropped."""
    import exllamav3_tpu_torch.generator.decode_graph as dg_mod
    import exllamav3_tpu_torch.generator.generator as gen_mod

    gaps: dict = {}
    rows: list = []
    sample, receive = dg_mod.batch_sample, gen_mod.Generator._receive_token

    def sample_gaps(logits, *a, **kw):
        top2 = torch.topk(logits, 2, dim=-1).values
        rows[:] = ((top2[:, 0] - top2[:, 1]) / (logits.amax(-1) - logits.amin(-1))).tolist()
        return sample(logits, *a, **kw)

    def receive_gap(self, job, tok, results):
        gaps.setdefault(job.identifier, []).append(rows.pop(0))
        return receive(self, job, tok, results)
    dg_mod.batch_sample, gen_mod.Generator._receive_token = sample_gaps, receive_gap
    try:
        yield gaps
    finally:
        dg_mod.batch_sample, gen_mod.Generator._receive_token = sample, receive


def _spec_run(tag: str, target, draft, prompts: list, plain: list, gaps: list,
              new_tokens: int = 128) -> dict:
    """Serve `prompts` on `target` with `draft` drafting 4 tokens a job, and
    hold each request's tokens to plain decoding's: equal up to the first
    divergence, which must sit at a near-tie of the plain run (top-2 gap under
    GAP_LIMIT of the logits' range). Returns the launch counts and the
    acceptance rate."""
    from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    gen = Generator(target, Cache(target, CacheSpec(num_pages=72)), max_batch_size=8,
                    max_chunk_size=2048, seed=0, draft_model=draft, num_draft_tokens=4)
    jobs, finished, dec_tok, dec_s, wall, counts = _drive(tag, gen, prompts, LLAMA8B["vocab_size"],
                                                          new_tokens)
    rate = gen.num_accepted / max(gen.num_drafted, 1)
    # a traced window of speculative iterations over the same prompts
    # (prefixes cached, draft rows caught up), after and apart from the run
    gen.enqueue([Job(p, max_new_tokens=32, sampler=GreedySampler()) for p in prompts])
    while gen.pending or any(j.status == "prefill" for j in gen.active):
        gen.iterate()
    gen.iterate()
    profile_decode(gen.iterate, 4, f"speculative iterations (batch {len(gen.active)})")
    while gen.num_remaining_jobs():
        gen.iterate()
    ttft = [finished[j.identifier]["ttft_s"] for j in jobs]
    log(f"{tag}: {len(jobs)} requests, {len(jobs) * new_tokens} tokens in {wall:.3f} s "
        f"({len(jobs) * new_tokens / wall:.2f} tok/s overall), decode-only iterations "
        f"{dec_tok} tokens in {dec_s:.3f} s ({dec_tok / max(dec_s, 1e-9):.2f} tok/s); drafted "
        f"{gen.num_drafted}, accepted {gen.num_accepted} (acceptance {rate:.4f}); TTFT first "
        f"request {ttft[0]:.4f} s, others {min(ttft[1:]):.4f}-{max(ttft[1:]):.4f} s")
    log(f"{tag}: kernel launches {json.dumps(counts)}")
    for i, j in enumerate(jobs):
        got = finished[j.identifier]["new_tokens"]
        same = next((n for n, (a, b) in enumerate(zip(got, plain[i])) if a != b), len(got))
        gap = gaps[i][same] if same < len(got) else None
        log(f"{tag}: request {i}: agrees with plain decoding for {same} of {len(got)} tokens"
            + ("" if gap is None else f", then parts where the plain run's top-2 gap is "
               f"{gap:.4e} of the logits' range"))
        if gap is not None and not gap < GAP_LIMIT:
            raise AssertionError(f"{tag}: request {i} parts from plain decoding at token {same}, "
                                 f"where the top-2 gap is {gap} of the range")
    del gen
    _free()
    return counts, rate


def phase_serve_spec() -> dict:
    """Greedy speculative decoding on a 16-layer Llama-3.1-8B-geometry target
    (linear_mode="auto": int8 on an 80 GB card, bf16 paged cache), the
    serve phases' traffic: plain decoding first, then (a) a Llama-3.2-1B-
    geometry draft and (b) the target drafting for itself (the same Model),
    k = 4, the draft over its own linear cache."""
    from exllamav3_tpu_torch.generator import Generator
    from exllamav3_tpu_torch.model import Cache, CacheSpec

    target = _load_model("serve_spec target", _checkpoint(SPEC_TARGET_LAYERS), "auto", "int8")
    draft = _load_model("serve_spec draft", _draft_checkpoint(), "auto", "int8")
    head = draft.params["lm_head"].get("weight")
    embed = draft.params["model.embed_tokens"]["weight"]
    if head is None or not torch.equal(head.t(), embed):
        raise AssertionError("serve_spec: the draft's tied head is not its embedding")
    prompts = _serve_prompts()
    gen = Generator(target, Cache(target, CacheSpec(num_pages=72)), max_batch_size=8,
                    max_chunk_size=2048, seed=0, decode_burst=1, decode_graphs=False)
    with record_gaps() as gaps:
        jobs, finished, dec_tok, dec_s, wall, counts = _drive("serve_spec plain", gen, prompts,
                                                              LLAMA8B["vocab_size"])
    plain = [finished[j.identifier]["new_tokens"] for j in jobs]
    gap_rows = [gaps[j.identifier] for j in jobs]
    log(f"serve_spec plain: {len(jobs) * 128} tokens in {wall:.3f} s "
        f"({len(jobs) * 128 / wall:.2f} tok/s overall), decode-only iterations {dec_tok} tokens "
        f"in {dec_s:.3f} s ({dec_tok / max(dec_s, 1e-9):.2f} tok/s; eager single steps, each "
        f"also takes the top-2 gap of its logits)")
    _require_launches("serve_spec plain", counts, ("int8_matmul", "fused_mlp", "paged_attention",
                                                   "paged_attention_prefill"))
    del gen
    _free()
    used = ("int8_matmul", "fused_mlp", "paged_attention", "paged_attention_prefill",
            "linear_attention", "linear_attention_prefill")
    counts_a, _ = _spec_run("serve_spec (a) 1B draft", target, draft, prompts, plain, gap_rows)
    _require_launches("serve_spec (a) 1B draft", counts_a, used)
    counts_b, rate_b = _spec_run("serve_spec (b) self-draft", target, target, prompts, plain,
                                 gap_rows)
    _require_launches("serve_spec (b) self-draft", counts_b, used)
    if rate_b < 0.8:
        raise AssertionError(f"serve_spec (b): self-draft acceptance {rate_b} < 0.8")
    # launches of one draft step of each draft (batch 1)
    for tag, m in (("1B draft", draft), ("self-draft", target)):
        c = Cache(m, CacheSpec(layout="linear", batch_size=1, max_len=64))
        one = torch.zeros((1, 1), dtype=torch.int32, device=m.device)
        _reset_counts()
        m.forward(one.long(), c, one, one[0])
        log(f"serve_spec: launches per {tag} step " + json.dumps(_read_counts()))
    del target, draft
    _free()
    return {n: counts_a[n] for n in ("linear_attention", "linear_attention_prefill")}


CHECKS = {"int8_matmul": check_int8, "fused_mlp": check_fused_mlp,
          "paged_attention": check_attention, "exl3_gemm": check_exl3_gemm,
          "paged_attention_quant": check_attention_quant,
          **{name: (lambda table, dev, name=name: check_packed(table, dev, name))
             for name in PACKED},
          "moe_gemm": check_moe_gemm, "linear_attention": check_linear_attention,
          "linear_attention_quant": check_linear_attention_quant,
          "latent_attention": check_latent_attention,
          "latent_attention_quant": check_latent_attention_quant,
          "ring_attention": check_ring_attention, "attention_stats": check_attention_stats,
          **PROBE_CHECKS}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="build,kernels,parity,parity_mla,parity_gemma,parity_dsv4,serve,"
                            "serve_capacity,serve_packed,serve_moe,linear_decode,serve_spec,"
                            "serve_mla,serve_gemma,serve_dsv4",
                    help="`kernels` runs every kernel check; a check's name runs that one")
    args = ap.parse_args()
    phases = args.phases.split(",")
    known = {"build", "kernels", "parity", "parity_mla", "parity_gemma", "parity_dsv4", "serve",
             "serve_capacity", "serve_packed", "serve_packed_int6", "serve_moe", "linear_decode",
             "serve_spec", "serve_mla", "serve_gemma", "serve_dsv4", *CHECKS}
    if set(phases) - known:
        ap.error(f"unknown phases {sorted(set(phases) - known)}")

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        sys.exit(1)
    import exllamav3_tpu_torch.ops.build as kbuild  # fails outside a checkout of the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    os.makedirs(WORK, exist_ok=True)
    t_all = time.time()

    t0 = time.time()
    kbuild.library()
    log(f"build: {kbuild.BUILD_LOG.get('seconds', 0.0):.1f} s (cached={kbuild.BUILD_LOG.get('cached')})")
    for name in kbuild.SOURCES:
        for line in (kbuild.BUILD_LOG.get(name) or "").splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "warning" in line.lower()):
                log(f"  {name}: {line.strip()}")
    log(f"phase build: {time.time() - t0:.1f} s")

    table = KernelTable()
    checks = [name for name in CHECKS if "kernels" in phases or name in phases]
    if checks:
        t0 = time.time()
        for name in checks:
            CHECKS[name](table, dev)
        log(f"phase kernels ({', '.join(checks)}): {time.time() - t0:.1f} s")
    if "parity" in phases:
        t0 = time.time()
        phase_parity()
        log(f"phase parity: {time.time() - t0:.1f} s")
    if "parity_mla" in phases:
        t0 = time.time()
        phase_parity_mla()
        log(f"phase parity_mla: {time.time() - t0:.1f} s")
    if "parity_gemma" in phases:
        t0 = time.time()
        phase_parity_gemma()
        log(f"phase parity_gemma: {time.time() - t0:.1f} s")
    if "serve" in phases:
        t0 = time.time()
        table.set_launches(phase_serve())
        log(f"phase serve: {time.time() - t0:.1f} s")
    if "serve_capacity" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_capacity())
        log(f"phase serve_capacity: {time.time() - t0:.1f} s")
    if "serve_packed" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_packed())
        log(f"phase serve_packed: {time.time() - t0:.1f} s")
    if "serve_packed_int6" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_packed_int6())
        log(f"phase serve_packed_int6: {time.time() - t0:.1f} s")
    if "serve_moe" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_moe())
        log(f"phase serve_moe: {time.time() - t0:.1f} s")
    if "linear_decode" in phases:
        t0 = time.time()
        table.set_launches(phase_linear_decode())
        log(f"phase linear_decode: {time.time() - t0:.1f} s")
    if "serve_spec" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_spec())
        log(f"phase serve_spec: {time.time() - t0:.1f} s")
    if "serve_mla" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_mla())
        log(f"phase serve_mla: {time.time() - t0:.1f} s")
    if "serve_gemma" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_gemma())
        log(f"phase serve_gemma: {time.time() - t0:.1f} s")
    # after serve_gemma has removed its checkpoint: the two never share the disk
    if "parity_dsv4" in phases:
        t0 = time.time()
        phase_parity_dsv4()
        log(f"phase parity_dsv4: {time.time() - t0:.1f} s")
    if "serve_dsv4" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_dsv4())
        log(f"phase serve_dsv4: {time.time() - t0:.1f} s")
    if any(p.startswith("serve") or p == "linear_decode" for p in phases):
        # each of those runs held every probe's launch count at 0 (_require_launches)
        for name, (source, _) in KERNELS.items():
            if "/probe_" in source and name in table.rows:
                table.rows[name]["launches"] = 0
    log(f"total: {time.time() - t_all:.1f} s")
    log(smi)  # once more, so that the end of a cut log still names the card
    print(json.dumps({"kernels": list(table.rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
