"""Where a block's time goes in the int-B matmuls
(exllamav3_tpu_torch/csrc/intb_matmul.cu, kernel rows 13 and 14), or with
--int4 in the int4 a8 matmul (csrc/int4_matmul.cu, kernel row 12; with
--bf16 its bf16 route, row 11), or with
--int8 / --mlp in the staged int8 body (csrc/int8_staged.cuh) of the int8
matmul (row 1) / the fused MLP's two phases (row 2), on one card.

    python3 tools/torch_packed_phases.py                       # this tree's kernel
    python3 tools/torch_packed_phases.py --tree build/parent   # another checkout's kernel
    python3 tools/torch_packed_phases.py --splits 4,6,8,13     # and the staged body's time by split count
    python3 tools/torch_packed_phases.py --stages 2 --blocks 4 # 2 stages a warp, launch bounds of 4 blocks an SM
    python3 tools/torch_packed_phases.py --int4 --splits 2,4,8,16   # row 12 alike (--tree, --stages, --blocks too)
    python3 tools/torch_packed_phases.py --int4 --bf16 --splits 4,8,16   # row 11 alike (--tree build/parent: packed_matmul.cuh's body)
    python3 tools/torch_packed_phases.py --int8 --splits 4,8,12,16  # row 1 at m = 8 (--stages, --blocks too)
    python3 tools/torch_packed_phases.py --mlp --splits 2,4,8        # row 2's phases, with and without PDL

Copies the tree's intb_matmul.cu and the headers it includes into
build/packed_phases/<tree name>/, puts clock64() timers around the phases of
a block's life, builds it with nvcc as ops/build.py builds the kernels (and
the unpatched copy beside it), and runs both routes, bf16 (row 13) and a8
(row 14), at m = 8 over the five Llama-3.1-8B shapes at B = 6 (qkv 4096 x
6144, o_proj 4096 x 4096, gate_up 4096 x 28672, down 14336 x 4096, lm_head
4096 x 32768), qkv also at B = 3. With --int4: int4_matmul.cu, the a8 route
(row 12) alone, over the same five shapes (byte pairs; a staged step is 128
packed rows, 4 scale groups of both planes); with --int4 --bf16 its bf16 route
(row 11) alone (`extract` then counts the nibbles made into bf16 weights, two
FMAs a pair, beside the byte transposes). Thread 0 of each block sums its
cycles by phase over the block's k steps:

- `stage`: the next step's copies. In the body of packed_matmul.cuh (the
  tree before the redesign) the issue of the next step's word loads into
  registers; in the staged body the wait for a step's `cp.async` group and
  the issue of a later step's;
- `reads`: the group scales and the A or B fragments of x (and, staged, the
  words and the a8 row sums), each consumed by an instruction before the
  timer reads the clock: from device memory in the old body, from shared
  memory in the staged one;
- `extract`: the codes made into MMA fragments (the staged int4 body: the
  byte transposes, once a group for both planes; a plane's mask is counted
  with its MMAs);
- `mma`: the tensor-core products and, on the a8 route, the group scales'
  FMAs;
- the block's life from its start to its k loop (the prologue), the loop,
  and the epilogue: the partial sums' write and, in the staged body, the
  arrival and, where the block's first warp arrives last for its 32
  columns, its reduction of the splits. The row
  quantizer, and the old body's split-k reduce, are kernels of their own,
  timed alone by CUDA events.

A timer reads the clock where the program reaches it, and the instrumented
build makes each phase wait for its loads before the next begins: compare
phases, and take kernel times from the unpatched build. The staged body is
also built with its programmatic dependent launch off (a patch of the
launch's attribute), and its a8 route timed both ways. Every output is held against the plain version
at chip_smoke.py's TOL_PACKED (1e-4 of the largest output), and the script
fails if one misses.

--int8 times int8_matmul.cu's staged body at m = 8 over the five 8B shapes,
--mlp fused_mlp.cu at m = 8 over Llama-3.1-8B, Gemma-3-27B and DeepSeek-V4's
shared expert, each phase by phase: `stage` and `reads` as above (the
weights' words and x's fragments from shared memory), `convert` (the int8
pairs made into bf16 A fragments), `mma`, and a block's prologue, loop and
epilogue: the partial sums' write and arrival, or where its first warp
arrives last its reduction and epilogue (the column scale; the first phase's
activation). The MLP is also built with its second phase launched in stream
order and as a programmatic dependent at every width (INT8_MLP_PDL_MIN_K past
any i, and 0) and timed all three ways; --splits times each phase at
the given split counts with the other at its sizing. Held to chip_smoke.py's
TOL_INT8 (1e-4) and TOL_MLP (2e-3). Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4  # chip_smoke.py's TOL_PACKED
SLOTS = 9   # stage, reads, extract, mma, steps, prologue, loop, epilogue, last-arriving
SHAPES = [(4096, 6144, "qkv", 6), (4096, 6144, "qkv", 3), (4096, 4096, "o_proj", 6),
          (4096, 28672, "gate_up", 6), (14336, 4096, "down", 6), (4096, 32768, "lm_head", 6)]
M = 8
TIMERS = (f"__device__ unsigned long long g_phase[65536 * {SLOTS}];\n"
          "// an instruction that reads v, ordered with the clock reads: a timer after it\n"
          "// counts the wait for v's load\n"
          "__device__ __forceinline__ void touch(unsigned& sink, unsigned v) {\n"
          "    asm volatile(\"xor.b32 %0, %0, %1;\" : \"+r\"(sink) : \"r\"(v));\n}\n")


def read(symbol: str) -> str:
    """C entries that read and clear the timers' buffer `symbol`."""
    return r'''
extern "C" int phases_read(void* dst, int blocks) {
    return (int)cudaMemcpyFromSymbol(dst, %s, (size_t)blocks * %d * 8);
}
extern "C" int phases_clear() {
    void* p;
    cudaGetSymbolAddress(&p, %s);
    return (int)cudaMemset(p, 0, sizeof(%s));
}
''' % (symbol, SLOTS, symbol, symbol)


def record(last: str) -> str:
    """Thread 0 writes its block's slots; `last`: 1 where its warp reduced."""
    return ("    if (threadIdx.x == 0) {\n"
            "        const size_t bi = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
            " + blockIdx.x;\n"
            "        const unsigned long long rec[%d] = {ph[0], ph[1], ph[2], ph[3], "
            "(unsigned long long)n_timed, (unsigned long long)(t_loop - t_entry), "
            "(unsigned long long)(t_out - t_loop), (unsigned long long)(clock64() - t_out), "
            "(unsigned long long)(%s)};\n"
            "        for (int s = 0; s < %d; ++s) g_phase[bi * %d + s] = rec[s];\n"
            "        if (sink == 0x9E3779B9u) g_phase[0] = sink;  // keeps the touches\n"
            "    }\n") % (SLOTS, last, SLOTS, SLOTS)


ENTRY = ("    const long long t_entry = clock64();\n"
         "    unsigned long long ph[4] = {0, 0, 0, 0};\n    int n_timed = 0;\n"
         "    unsigned sink = 0;\n")

# -- the body of csrc/packed_matmul.cuh (words loaded to registers a step
# ahead, scales and x read from device memory in the plane loop, a second
# kernel for the split-k sum) --
OLD_HEADER = "packed_matmul.cuh"
OLD_PATCHES = [
    ("namespace packed {\nnamespace {  // each source that includes this header gets its own copies\n",
     "namespace packed {\nnamespace {  // each source that includes this header gets its own copies\n"
     + TIMERS),
    ("    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n    const int g = lane >> 2",
     ENTRY + "    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "    const int g = lane >> 2"),
    ("    if (step0 < step1) load_step(step0, w);\n"
     "    for (int step = step0; step < step1; ++step) {\n"
     "        if (step + 1 < step1) load_step(step + 1, wn);  // in flight during the MMAs\n",
     "    if (step0 < step1) load_step(step0, w);\n"
     "    const long long t_loop = clock64();\n"
     "    for (int step = step0; step < step1; ++step) {\n"
     "        const long long t_top = clock64();\n        ++n_timed;\n"
     "        if (step + 1 < step1) load_step(step + 1, wn);  // in flight during the MMAs\n"
     "        ph[0] += clock64() - t_top;\n"),
    ("            const int sh = FIELD * j;\n",
     "            const int sh = FIELD * j;\n            const long long t_pl = clock64();\n"),
    # a8: the scales of the lane's C columns and x, consumed
    ("                load_bf16<2 * NT>(srow + ccol, sc);\n                uint32_t b[NT][2];\n",
     "                load_bf16<2 * NT>(srow + ccol, sc);\n"
     "                for (int q = 0; q < 2 * NT; ++q) touch(sink, __float_as_uint(sc[q]));\n"
     "                for (int q = 0; q < 4; ++q) touch(sink, a[0][0][q]);\n"
     "                const long long t_rd = clock64();\n                ph[1] += t_rd - t_pl;\n"
     "                uint32_t b[NT][2];\n"),
    ("#pragma unroll\n                for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n"
     "                    for (int mt = 0; mt < MT; ++mt) {\n                        int d[4];\n",
     "                for (int nt = 0; nt < NT; ++nt) touch(sink, b[nt][0] ^ b[nt][1]);\n"
     "                const long long t_ex = clock64();\n                ph[2] += t_ex - t_rd;\n"
     "#pragma unroll\n                for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n"
     "                    for (int mt = 0; mt < MT; ++mt) {\n                        int d[4];\n"),
    ("                        acc[mt][nt][3] = fmaf((float)d[3], sc[NT + nt], acc[mt][nt][3]);\n"
     "                    }\n",
     "                        acc[mt][nt][3] = fmaf((float)d[3], sc[NT + nt], acc[mt][nt][3]);\n"
     "                    }\n"
     "                for (int nt = 0; nt < NT; ++nt) touch(sink, __float_as_uint(acc[0][nt][0]));\n"
     "                ph[3] += clock64() - t_ex;\n"),
    # bf16: the scales of the lane's B columns and x, consumed; then per tile
    # the extraction and its two MMAs
    ("                load_bf16<NT>(srow + bcol, sc);\n",
     "                load_bf16<NT>(srow + bcol, sc);\n"
     "                for (int q = 0; q < NT; ++q) touch(sink, __float_as_uint(sc[q]));\n"
     "                for (int q = 0; q < 4; ++q) touch(sink, a[0][0][q] ^ a[0][1][q]);\n"
     "                long long t_c = clock64();\n                ph[1] += t_c - t_pl;\n"),
    ("                    const uint32_t b1[2] = {pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7])};\n",
     "                    const uint32_t b1[2] = {pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7])};\n"
     "                    touch(sink, b0[0] ^ b0[1] ^ b1[0] ^ b1[1]);\n"
     "                    const long long t_e = clock64();\n                    ph[2] += t_e - t_c;\n"),
    ("                        mma_bf16(acc[mt][nt], a[mt][1], b1);\n                    }\n",
     "                        mma_bf16(acc[mt][nt], a[mt][1], b1);\n                    }\n"
     "                    touch(sink, __float_as_uint(acc[0][nt][0]));\n"
     "                    t_c = clock64();\n                    ph[3] += t_c - t_e;\n"),
    ("            for (int r = 0; r < NW; ++r) w[i][r] = wn[i][r];\n    }\n",
     "            for (int r = 0; r < NW; ++r) w[i][r] = wn[i][r];\n    }\n"
     "    const long long t_out = clock64();\n"),
    ("                o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);\n"
     "        }\n}\n",
     "                o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);\n"
     "        }\n" + record("0") + "}\n"),
]
# the old body's two other kernels, launched alone
OLD_EXTRA = r'''
extern "C" int phases_quantize(const void* x, void* xq, void* xs, int m, int k, void* stream) {
    packed::quantize_rows_kernel<<<m, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, k);
    return (int)cudaGetLastError();
}
extern "C" int phases_reduce(const void* ws, const void* xs, void* y, int m, int n, int splits,
                             void* stream) {
    const size_t total4 = (size_t)m * n / 4;
    packed::splitk_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float4*)ws, (const float*)xs, (float4*)y, m, n, splits);
    return (int)cudaGetLastError();
}
'''

# -- the staged body of csrc/intb_matmul.cu (its row quantizer launched alone) --
NEW_EXTRA = r'''
extern "C" int phases_quantize(const void* x, void* xq, void* xs, int m, int k, void* stream) {
    intb_quantize_rows<<<m, QUANT_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, k);
    return (int)cudaGetLastError();
}
'''
NEW_PATCHES = [
    ("namespace {\n\nconstexpr int THREADS", "namespace {\n" + TIMERS + "\nconstexpr int THREADS"),
    ("    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     ENTRY + "    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"),
    ("    for (int i = 0; i < nst; ++i) {\n",
     "    const long long t_loop = clock64();\n    for (int i = 0; i < nst; ++i) {\n"
     "        const long long t_top = clock64();\n        ++n_timed;\n"),
    ("        issue(i + INTB_STAGES - 1);\n",
     "        issue(i + INTB_STAGES - 1);\n        ph[0] += clock64() - t_top;\n"),
    ("        uint32_t w[8][4];  // packed rows",
     "        const long long t_w = clock64();\n        uint32_t w[8][4];  // packed rows"),
    ("            w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;\n        }\n",
     "            w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;\n        }\n"
     "        for (int r = 0; r < 8; ++r) touch(sink, w[r][0]);\n"
     "        ph[1] += clock64() - t_w;\n"),
    ("            const int gi = j * per + i;\n",
     "            const int gi = j * per + i;\n            const long long t_pl = clock64();\n"),
    # a8: scales, x and its row sums, consumed; then a tile's codes; its MMAs and FMAs
    ("                    sx[rt] = *reinterpret_cast<const int2*>(Sx + gi * (INTB_X_SUMS / 4) + 8 * rt + 2 * t);\n"
     "                }\n",
     "                    sx[rt] = *reinterpret_cast<const int2*>(Sx + gi * (INTB_X_SUMS / 4) + 8 * rt + 2 * t);\n"
     "                }\n"
     "                touch(sink, sv.x ^ sv.y ^ xb[0].x ^ xb[0].y ^ (unsigned)(sx[0].x ^ sx[0].y));\n"
     "                ph[1] += clock64() - t_pl;\n"),
    ("                for (int tt = 0; tt < 2; ++tt) {\n                    const uint32_t a[4] = {\n",
     "                for (int tt = 0; tt < 2; ++tt) {\n                    const long long t_x = clock64();\n"
     "                    const uint32_t a[4] = {\n"),
    ("                                     w[7][2 * tt + 1], j)};\n",
     "                                     w[7][2 * tt + 1], j)};\n"
     "                    touch(sink, a[0] ^ a[1] ^ a[2] ^ a[3]);\n"
     "                    const long long t_m = clock64();\n                    ph[2] += t_m - t_x;\n"),
    ("sc[2 * tt + 1], acc[rt][tt][3]);\n                    }\n",
     "sc[2 * tt + 1], acc[rt][tt][3]);\n                    }\n"
     "                    touch(sink, __float_as_uint(acc[0][tt][0]));\n"
     "                    ph[3] += clock64() - t_m;\n"),
    # bf16: scales and x, consumed; then each tile's and half's weights; its MMAs
    ("                    xb[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + gi * 64 + 16 * t);\n",
     "                    xb[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + gi * 64 + 16 * t);\n"
     "                touch(sink, sv.x ^ sv.y ^ xb[0].x ^ xb[0].y ^ xb[0].z ^ xb[0].w);\n"
     "                ph[1] += clock64() - t_pl;\n"),
    ("                    for (int h = 0; h < 2; ++h) {  // packed rows 8t + 4h .. 8t + 4h + 3\n",
     "                    for (int h = 0; h < 2; ++h) {  // packed rows 8t + 4h .. 8t + 4h + 3\n"
     "                        const long long t_x = clock64();\n"),
    ("                            weights2<BITS>(w[4 * h + 2][c1], w[4 * h + 3][c1], j, s2[c1])};\n",
     "                            weights2<BITS>(w[4 * h + 2][c1], w[4 * h + 3][c1], j, s2[c1])};\n"
     "                        touch(sink, a[0] ^ a[1] ^ a[2] ^ a[3]);\n"
     "                        const long long t_m = clock64();\n                        ph[2] += t_m - t_x;\n"),
    ("                            packed::mma_bf16(acc[rt][tt], a, b);\n                        }\n",
     "                            packed::mma_bf16(acc[rt][tt], a, b);\n                        }\n"
     "                        touch(sink, __float_as_uint(acc[0][tt][0]));\n"
     "                        ph[3] += clock64() - t_m;\n"),
    ("    // this lane's outputs: rows 8rt + 2t + h",
     "    const long long t_out = clock64();\n    // this lane's outputs: rows 8rt + 2t + h"),
    ("    if (splits == 1) return;\n\n    // the last split",
     "    if (splits == 1) {\n" + record("0") + "        return;\n    }\n\n    // the last split"),
    ("    if (!last) return;\n", "    if (!last) {\n" + record("0") + "        return;\n    }\n"),
    ("    if (lane == 0) counters[tile] = 0;  // ready for the next launch\n}",
     "    if (lane == 0) counters[tile] = 0;  // ready for the next launch\n" + record("1") + "}"),
]

# -- the staged body of csrc/int4_matmul.cu (the a8 route up to 16 rows) --
INT4_EXTRA = r'''
extern "C" int phases_quantize(const void* x, void* xq, void* xs, int m, int k, void* stream) {
    packed::quantize_rows_dependents<<<m, packed::QUANT_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, k);
    return (int)cudaGetLastError();
}
'''
INT4_PATCHES = NEW_PATCHES[:3] + [
    ("        issue(i + INT4_STAGES - 1);\n",
     "        issue(i + INT4_STAGES - 1);\n        ph[0] += clock64() - t_top;\n"),
    ("            uint32_t w[8];  // packed rows",
     "            const long long t_w = clock64();\n            uint32_t w[8];  // packed rows"),
    ("                w[r] = *reinterpret_cast<const uint32_t*>(wt + stage_row(u * 32 + 8 * t + r) * 32 + 4 * g);\n",
     "                w[r] = *reinterpret_cast<const uint32_t*>(wt + stage_row(u * 32 + 8 * t + r) * 32 + 4 * g);\n"
     "            for (int r = 0; r < 8; ++r) touch(sink, w[r]);\n"
     "            const long long t_x = clock64();\n            ph[1] += t_x - t_w;\n"),
    ("            transpose4(w[4], w[5], w[6], w[7], hi4);\n",
     "            transpose4(w[4], w[5], w[6], w[7], hi4);\n"
     "            touch(sink, lo4[0] ^ lo4[1] ^ lo4[2] ^ lo4[3] ^ hi4[0] ^ hi4[1] ^ hi4[2] ^ hi4[3]);\n"
     "            ph[2] += clock64() - t_x;\n"),
    ("                const int gi = (j * per + i) * 4 + u;\n",
     "                const int gi = (j * per + i) * 4 + u;\n                const long long t_pl = clock64();\n"),
    # a8: scales, x and its row sums, consumed; then the plane's masks, MMAs and FMAs
    ("                        sx[rt] = *reinterpret_cast<const int2*>(Sx + gi * (INT4_X_SUMS / 4) + 8 * rt + 2 * t);\n"
     "                    }\n",
     "                        sx[rt] = *reinterpret_cast<const int2*>(Sx + gi * (INT4_X_SUMS / 4) + 8 * rt + 2 * t);\n"
     "                    }\n"
     "                    touch(sink, sv.x ^ sv.y ^ xb[0].x ^ xb[0].y ^ (unsigned)(sx[0].x ^ sx[0].y));\n"
     "                    const long long t_m = clock64();\n                    ph[1] += t_m - t_pl;\n"),
    ("sc[2 * tt + 1], acc[rt][tt][3]);\n                        }\n                    }\n",
     "sc[2 * tt + 1], acc[rt][tt][3]);\n                        }\n                    }\n"
     "                    touch(sink, __float_as_uint(acc[0][0][0]) ^ __float_as_uint(acc[0][1][0]));\n"
     "                    ph[3] += clock64() - t_m;\n"),
    # bf16: scales and x, consumed; then each half's weights; their MMAs
    ("                        xb[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + gi * 64 + 16 * t);\n",
     "                        xb[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + gi * 64 + 16 * t);\n"
     "                    touch(sink, sv.x ^ sv.y ^ xb[0].x ^ xb[0].y ^ xb[0].z ^ xb[0].w);\n"
     "                    ph[1] += clock64() - t_pl;\n"),
    ("                    for (int h = 0; h < 2; ++h) {  // packed rows 8t + 4h .. 8t + 4h + 3\n",
     "                    for (int h = 0; h < 2; ++h) {  // packed rows 8t + 4h .. 8t + 4h + 3\n"
     "                        long long t_e = clock64();\n"),
    ("                                                   weights2(v[c0], 1, s2[c0]), weights2(v[c1], 1, s2[c1])};\n",
     "                                                   weights2(v[c0], 1, s2[c0]), weights2(v[c1], 1, s2[c1])};\n"
     "                            touch(sink, a[0] ^ a[1] ^ a[2] ^ a[3]);\n"
     "                            const long long t_mm = clock64();\n                            ph[2] += t_mm - t_e;\n"),
    ("                                packed::mma_bf16(acc[rt][tt], a, b);\n                            }\n",
     "                                packed::mma_bf16(acc[rt][tt], a, b);\n                            }\n"
     "                            touch(sink, __float_as_uint(acc[0][tt][0]));\n"
     "                            t_e = clock64();\n                            ph[3] += t_e - t_mm;\n"),
] + NEW_PATCHES[-4:]
# what --int4 times: int4_matmul.cu's a8 (or with --bf16 its bf16) route over
# the 8B shapes (bits None)
INT4_SHAPES = [(k, n, what, None) for k, n, what, bits in SHAPES if bits == 6]


def _version(src: str, int4: bool = False, bf16: bool = False) -> str:
    """The body the tree's entry takes up to 16 rows: the int4 bf16 route's
    staged body since it is launched as launch_staged<false>."""
    staged = ("launch_staged<false>" if bf16 else "int4_decode_kernel") if int4 else "intb_decode_kernel"
    return "staged" if staged in src else "packed_matmul.cuh"


def _patch(text: str, patches) -> str:
    for anchor, new in patches:
        if text.count(anchor) != 1:
            raise SystemExit(f"the kernel changed: anchor not found once:\n{anchor}")
        text = text.replace(anchor, new)
    return text


def build(tree: Path, stages: int | None, blocks: int | None, int4: bool = False,
          bf16: bool = False):
    """(kernel version, the instrumented copy, the unpatched one, the
    unpatched one without programmatic dependent launch or None); `stages`,
    `blocks`: the staged body's INTB_STAGES and INTB_BLOCKS (INT4_STAGES and
    INT4_BLOCKS with `int4`) in every copy, if given; `bf16`: the int4 bf16
    route's body."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    csrc = tree / "exllamav3_tpu_torch" / "csrc"
    name, layout_name, pre = (("int4_matmul.cu", "int4_layout.cuh", "INT4") if int4 else
                              ("intb_matmul.cu", "intb_layout.cuh", "INTB"))
    src = (csrc / name).read_text()
    version = _version(src, int4, bf16)
    out = ROOT / "build" / "packed_phases" / (tree.resolve().name + ("_int4" if int4 else "")
                                              + ("_bf16" if bf16 else ""))
    for sub in ("phases", "plain", "nopdl"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    if version == "staged":
        # the staged body's limits, changed where asked, beside every copy
        layout = (csrc / layout_name).read_text()
        for const, value in ((f"{pre}_STAGES", stages), (f"{pre}_BLOCKS", blocks)):
            if value is not None:
                layout = re.sub(rf"^constexpr int {const} = \d+;",
                                f"constexpr int {const} = {value};", layout, count=1, flags=re.M)
        for sub in ("phases", "plain", "nopdl"):
            (out / sub / layout_name).write_text(layout)
        # the tree's own quantizer: intb_matmul.cu's before it moved to packed_matmul.cuh
        extra = (INT4_EXTRA if int4 or "intb_quantize_rows" not in src
                 else NEW_EXTRA)
        (out / "phases" / name).write_text(_patch(src, INT4_PATCHES if int4 else NEW_PATCHES)
                                           + read("g_phase") + extra)
        (out / "nopdl" / name).write_text(
            _patch(src, [("attr[0].val.programmaticStreamSerializationAllowed = 1;",
                          "attr[0].val.programmaticStreamSerializationAllowed = 0;")]))
    else:
        header = (csrc / OLD_HEADER).read_text()
        (out / "phases" / OLD_HEADER).write_text(_patch(header, OLD_PATCHES))
        (out / "phases" / name).write_text(src + read("packed::g_phase") + OLD_EXTRA)
    (out / "plain" / name).write_text(src)
    # headers not copied beside a source are included from the tree's csrc/
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")] + [f"-I{csrc}"]
    subs = ("phases", "plain", "nopdl") if version == "staged" else ("phases", "plain")
    jobs = [[nvcc_path(), *flags, *(["-Xptxas", "-v"] if s == "plain" else []), "-shared",
             str(out / s / name), "-o", str(out / s / "lib.so")] for s in subs]
    with ThreadPoolExecutor(len(jobs)) as ex:
        runs = list(ex.map(lambda c: subprocess.run(c, capture_output=True, text=True), jobs))
    for r in runs:
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
    kname = None  # the decode-size kernels' registers, shared memory and spills
    for line in (runs[1].stdout + runs[1].stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            kname = fn if ("decode_kernel" in fn or "packed_matmul_kernel" in fn) else None
        elif kname and ("Used" in line or "spill" in line):
            print(f"ptxas: {kname}: {line.strip()}", flush=True)
    dlls = [ctypes.CDLL(str(out / s / "lib.so")) for s in subs]
    return version, dlls[0], dlls[1], dlls[2] if len(dlls) > 2 else None


# -- the staged int8 body of csrc/int8_staged.cuh (--int8, --mlp): each
# phase's records at 32768 * EPI + the block's index, so that the MLP's two
# launches keep theirs apart --
INT8_SHAPES = [(4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
               (14336, 4096, "down"), (4096, 32768, "lm_head")]
MLP_SHAPES = [(4096, 14336, "silu", 0.0, "8B"), (5376, 21504, "gelu_pytorch_tanh", 0.0, "Gemma-3-27B"),
              (7168, 2048, "silu", 10.0, "DeepSeek-V4")]
PHASE_STRIDE = 32768
READ_AT = r"""
extern "C" int phases_read_at(void* dst, int first, int blocks) {
    return (int)cudaMemcpyFromSymbol(dst, int8s::g_phase, (size_t)blocks * %d * 8,
                                     (size_t)first * %d * 8);
}
""" % (SLOTS, SLOTS)


def record8(last: str) -> str:
    """record(), at the phase's own run of slots."""
    return record(last).replace("        const size_t bi = (", "        const size_t bi = (size_t)EPI * %d + ("
                                % PHASE_STRIDE)


INT8_PATCHES = [
    ("namespace int8s {\nnamespace {  // each source that includes this header gets its own copies\n",
     "namespace int8s {\nnamespace {  // each source that includes this header gets its own copies\n"
     + TIMERS),
    ("    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     ENTRY + "    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"),
    ("    for (int i = 0; i < nst; ++i) {\n",
     "    const long long t_loop = clock64();\n    for (int i = 0; i < nst; ++i) {\n"
     "        const long long t_top = clock64();\n        ++n_timed;\n"),
    ("        issue(i + INT8_STAGES - 1);\n",
     "        issue(i + INT8_STAGES - 1);\n        ph[0] += clock64() - t_top;\n"),
    ("        load(0, wr[0], xb[0]);\n",
     "        const long long t_w0 = clock64();\n        load(0, wr[0], xb[0]);\n"
     "        for (int r = 0; r < 8; ++r) touch(sink, wr[0][r]);\n"
     "        touch(sink, xb[0][0].x ^ xb[0][0].y ^ xb[0][0].z ^ xb[0][0].w);\n"
     "        ph[1] += clock64() - t_w0;\n"),
    ("            if (u + 1 < gs) load(u + 1, wr[(u + 1) & 1], xb[(u + 1) & 1]);\n",
     "            if (u + 1 < gs) {\n                const long long t_w = clock64();\n"
     "                load(u + 1, wr[(u + 1) & 1], xb[(u + 1) & 1]);\n"
     "                for (int r = 0; r < 8; ++r) touch(sink, wr[(u + 1) & 1][r]);\n"
     "                touch(sink, xb[(u + 1) & 1][0].x ^ xb[(u + 1) & 1][0].w);\n"
     "                ph[1] += clock64() - t_w;\n            }\n"),
    ("                    const uint32_t a[4] = {\n",
     "                    const long long t_x = clock64();\n                    const uint32_t a[4] = {\n"),
    ("                        bf16_pair(w8[4 * hh + 2], w8[4 * hh + 3], col_sel(2 * tt + 1))};\n",
     "                        bf16_pair(w8[4 * hh + 2], w8[4 * hh + 3], col_sel(2 * tt + 1))};\n"
     "                    touch(sink, a[0] ^ a[1] ^ a[2] ^ a[3]);\n"
     "                    const long long t_m = clock64();\n                    ph[2] += t_m - t_x;\n"),
    ("                        mma_bf16(acc[rt][tt], a, b);\n                    }\n",
     "                        mma_bf16(acc[rt][tt], a, b);\n                    }\n"
     "                    touch(sink, __float_as_uint(acc[0][tt][0]));\n"
     "                    ph[3] += clock64() - t_m;\n"),
    ("    if (!live) return;\n\n    if (splits == 1) {",
     "    const long long t_out = clock64();\n    if (!live) return;\n\n    if (splits == 1) {"),
    ("        return;\n    }\n\n    // this lane's partial sums",
     record8("0") + "        return;\n    }\n\n    // this lane's partial sums"),
    ("    if (!last) return;\n", "    if (!last) {\n" + record8("0") + "        return;\n    }\n"),
    ("    if (lane == 0) counters[tile] = 0;  // ready for the next launch\n}",
     "    if (lane == 0) counters[tile] = 0;  // ready for the next launch\n" + record8("1") + "}"),
]


def build_int8(tree: Path, mlp: bool, stages: int | None, blocks: int | None, warps: int | None):
    """(the instrumented library, the unpatched one, and with --mlp the
    unpatched one with its second phase in stream order and as a
    programmatic dependent at every width) of the tree's int8_matmul.cu or
    fused_mlp.cu, INT8_STAGES, INT8_BLOCKS and INT8_WARPS changed where asked."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    csrc = tree / "exllamav3_tpu_torch" / "csrc"
    name = "fused_mlp.cu" if mlp else "int8_matmul.cu"
    out = ROOT / "build" / "packed_phases" / (tree.resolve().name + ("_mlp" if mlp else "_int8"))
    layout = (csrc / "int8_layout.cuh").read_text()
    for const, value in (("INT8_STAGES", stages), ("INT8_BLOCKS", blocks), ("INT8_WARPS", warps)):
        if value is not None:
            layout = re.sub(rf"^constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                            layout, count=1, flags=re.M)
    pdl_min = {"nopdl": "1 << 30", "pdl": "0"}  # the second phase's PDL from this i up
    body = (csrc / "int8_staged.cuh").read_text()
    src = (csrc / name).read_text()
    subs = ("phases", "plain", "nopdl", "pdl") if mlp else ("phases", "plain")
    for sub in subs:
        (out / sub).mkdir(parents=True, exist_ok=True)
        (out / sub / "int8_layout.cuh").write_text(
            re.sub(r"^constexpr int INT8_MLP_PDL_MIN_K = \d+;",
                   f"constexpr int INT8_MLP_PDL_MIN_K = {pdl_min[sub]};", layout, count=1,
                   flags=re.M) if sub in pdl_min else layout)
        (out / sub / "int8_staged.cuh").write_text(_patch(body, INT8_PATCHES) if sub == "phases"
                                                   else body)
        (out / sub / name).write_text(src + (read("int8s::g_phase") + READ_AT
                                             if sub == "phases" else ""))
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")] + [f"-I{csrc}"]
    jobs = [[nvcc_path(), *flags, *(["-Xptxas", "-v"] if s == "plain" else []), "-shared",
             str(out / s / name), "-o", str(out / s / "lib.so")] for s in subs]
    with ThreadPoolExecutor(len(jobs)) as ex:
        runs = list(ex.map(lambda c: subprocess.run(c, capture_output=True, text=True), jobs))
    for r in runs:
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
    kname = None  # the staged body's registers, shared memory and spills
    for line in (runs[1].stdout + runs[1].stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            kname = fn if "int8_decode_kernel" in fn else None
        elif kname and ("Used" in line or "spill" in line):
            print(f"ptxas: {kname}: {line.strip()}", flush=True)
    return [ctypes.CDLL(str(out / s / "lib.so")) for s in subs] + [None] * (4 - len(subs))


def _phase_line(buf, grid: int, splits: int) -> str:
    """One phase's records (grid blocks) as cycles a step by part and a
    block's prologue, loop and epilogue."""
    n_steps = buf[:, 4].sum()
    per_step = ", ".join(f"{nm} {buf[:, i].sum() / n_steps:.0f}"
                         for i, nm in enumerate(("stage", "reads", "convert", "mma")))
    last = buf[:, 8] > 0
    epi = f"epilogue {buf[~last, 7].mean():.0f}" + (
        " (partial write and arrival)" if splits > 1 else " (in place)")
    if last.any():
        epi += f", last-arriving epilogue with the reduction {buf[last, 7].mean():.0f}"
    return (f"{n_steps / grid:.1f} steps a block; cycles a step: {per_step}; a block: prologue "
            f"{buf[:, 5].mean():.0f}, k loop mean {buf[:, 6].mean():.0f} longest "
            f"{buf[:, 6].max():.0f}, {epi}")


def main_int8(args, tree: Path):
    """--int8 and --mlp."""
    import numpy as np

    from exllamav3_tpu_torch.ops import fused_mlp as fm
    from exllamav3_tpu_torch.ops import q_matmul as qm
    from exllamav3_tpu_torch.ops.build import SIGNATURES
    from exllamav3_tpu_torch.util.device import arrival_counters
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    mlp = args.mlp
    dll, plain, nopdl, pdl = build_int8(tree, mlp, args.stages, args.blocks, args.warps)
    qm._INT8_STAGES = args.stages or qm._INT8_STAGES
    qm._INT8_BLOCKS = args.blocks or qm._INT8_BLOCKS
    qm._INT8_WARPS = args.warps or qm._INT8_WARPS
    qm._INT8_BN = 32 * qm._INT8_WARPS
    bn = qm._INT8_BN
    qm.int8_split_count.cache_clear()
    entry = "exl3_fused_mlp" if mlp else "exl3_int8_matmul"
    for lib in (dll, plain, nopdl, pdl):
        if lib is not None:
            getattr(lib, entry).argtypes = SIGNATURES[entry]
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.phases_read_at.argtypes = [P, I, I]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"{smi}; kernel: staged int8 ({tree})", flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def records(epi: int, grid: int):
        buf = np.zeros(grid * SLOTS, np.uint64)
        if dll.phases_read_at(buf.ctypes.data, epi * PHASE_STRIDE, grid):
            raise RuntimeError("reading the timers failed")
        return buf.reshape(grid, SLOTS).astype(np.float64)

    def rel_err(y, ref):
        return float((y - ref).abs().max() / ref.abs().max())

    if not mlp:
        def caller(k, n, splits):
            y = torch.empty((M, n), dtype=torch.float32, device=dev)
            ws = torch.empty((max(splits, 1), M, n), dtype=torch.float32, device=dev)
            counters = arrival_counters(dev, n // 32)

            def call(lib, x, w, s):
                err = lib.exl3_int8_matmul(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
                                           ws.data_ptr(), counters.data_ptr(), M, k, n, splits,
                                           stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return y
            return call

        def make_of(k, n):
            return (lambda i: (torch.randn((M, k), generator=g, device=dev).to(torch.bfloat16),
                               torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                             dtype=torch.int8),
                               (torch.rand(n, generator=g, device=dev) + 0.5) * 0.01),
                    M * k * 2 + k * n + n * 4 + M * n * 4)

        for k, n, what in INT8_SHAPES:
            make, nb = make_of(k, n)
            x, w, s = make(0)
            ref = qm.int8_matmul_plain(x, w, s)
            splits = qm.int8_split_count(M, k, n, sms)
            call = caller(k, n, splits)
            grid = -(-n // bn) * splits
            dll.phases_clear()
            rel = rel_err(call(dll, x, w, s), ref)
            torch.cuda.synchronize()
            line = _phase_line(records(0, grid), grid, splits)
            nxt = rotating(make, nb)
            inst = time_ms(lambda: call(dll, *nxt()), 20)
            rel = max(rel, rel_err(call(plain, x, w, s), ref))
            ms = time_ms(lambda: call(plain, *nxt()), 20)
            print(f"int8 m={M} {what} ({k}x{n}): {-(-k // 128)} steps, {splits} splits, {grid} "
                  f"blocks, {line}; instrumented {inst:.4f} ms, unpatched {ms:.4f} ms over rotated "
                  f"inputs; rel err {rel:.2e}", flush=True)
            if not rel <= 1e-4:
                raise SystemExit(f"int8 {what}: rel err {rel:.2e} > 1e-4")
            for sp in (int(v) for v in args.splits.split(",")) if args.splits else ():
                steps = -(-k // 128)
                if sp > min(steps, qm.INT8_MAX_SPLITS) or qm._int8_smem(M, -(-steps // sp)) > qm.INT8_MAX_SMEM:
                    continue
                c = caller(k, n, sp)
                rel = rel_err(c(plain, x, w, s), ref)
                ms = time_ms(lambda: c(plain, *nxt()), 20)
                print(f"int8 m={M} {what} at {sp} splits: {ms:.4f} ms over rotated inputs; rel err "
                      f"{rel:.2e}", flush=True)
                if not rel <= 1e-4:
                    raise SystemExit(f"int8 {what} at {sp} splits: rel err {rel:.2e} > 1e-4")
            del nxt, x, w, s
            torch.cuda.empty_cache()
        return

    def caller(h, inter, act, clamp, s1, s2):
        a = torch.empty((M, inter), dtype=torch.bfloat16, device=dev)
        out = torch.empty((M, h), dtype=torch.float32, device=dev)
        ws = torch.empty((M * max(s1 * 2 * inter, s2 * h),), dtype=torch.float32, device=dev)
        counters = arrival_counters(dev, max(2 * inter, h) // 32)

        def call(lib, x, gu, gs, d):
            err = lib.exl3_fused_mlp(x.data_ptr(), gu.data_ptr(), gs.data_ptr(), d.data_ptr(), None,
                                     None, a.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                     counters.data_ptr(), M, h, inter, fm.ACTIVATIONS[act],
                                     float(clamp), s1, s2, stream())
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return out
        return call

    for h, inter, act, clamp, what in MLP_SHAPES:
        def make(i, h=h, inter=inter):
            return (torch.randn((M, h), generator=g, device=dev).to(torch.bfloat16),
                    torch.randint(-127, 128, (h, 2 * inter), generator=g, device=dev, dtype=torch.int8),
                    torch.full((2 * inter,), 1.0 / (73.0 * np.sqrt(h)), device=dev),
                    torch.randint(-127, 128, (inter, h), generator=g, device=dev, dtype=torch.int8))
        nb = M * h * 2 + 3 * h * inter + 2 * inter * 4 + M * h * 4
        args_ = make(0)
        ref = fm.fused_mlp_int8_plain(*args_, act, clamp)
        s1, s2 = fm.fused_mlp_splits(M, h, inter, sms)
        call = caller(h, inter, act, clamp, s1, s2)
        grids = (-(-2 * inter // bn) * s1, -(-h // bn) * s2)
        dll.phases_clear()
        rel = rel_err(call(dll, *args_), ref)
        torch.cuda.synchronize()
        lines = [_phase_line(records(epi, grid), grid, sp)
                 for epi, grid, sp in ((1, grids[0], s1), (0, grids[1], s2))]
        nxt = rotating(make, nb)
        inst = time_ms(lambda: call(dll, *nxt()), 20)
        rel = max(rel, rel_err(call(plain, *args_), ref), rel_err(call(nopdl, *args_), ref),
                  rel_err(call(pdl, *args_), ref))
        ms = time_ms(lambda: call(plain, *nxt()), 20)
        ms_nopdl = time_ms(lambda: call(nopdl, *nxt()), 20)
        ms_pdl = time_ms(lambda: call(pdl, *nxt()), 20)
        print(f"fused_mlp m={M} {what} ({act}{f' clamp {clamp:g}' if clamp else ''}, h {h}, i {inter}):"
              f" first phase {-(-h // 128)} steps, {s1} splits, {grids[0]} blocks, {lines[0]}; second"
              f" phase {-(-inter // 128)} steps, {s2} splits, {grids[1]} blocks, {lines[1]}; "
              f"instrumented {inst:.4f} ms, unpatched {ms:.4f} ms, second phase in stream order "
              f"{ms_nopdl:.4f} ms, as a programmatic dependent {ms_pdl:.4f} ms, over rotated inputs; "
              f"rel err {rel:.2e}", flush=True)
        if not rel <= 2e-3:
            raise SystemExit(f"fused_mlp {what}: rel err {rel:.2e} > 2e-3")
        for sp in (int(v) for v in args.splits.split(",")) if args.splits else ():
            for k, pair in ((h, (sp, s2)), (inter, (s1, sp))):
                steps = -(-k // 128)
                if sp > min(steps, qm.INT8_MAX_SPLITS) or qm._int8_smem(M, -(-steps // sp)) > qm.INT8_MAX_SMEM:
                    continue
                c = caller(h, inter, act, clamp, *pair)
                rel = rel_err(c(plain, *args_), ref)
                ms = time_ms(lambda: c(plain, *nxt()), 20)
                print(f"fused_mlp m={M} {what} at splits {pair[0]} and {pair[1]}: {ms:.4f} ms over "
                      f"rotated inputs; rel err {rel:.2e}", flush=True)
                if not rel <= 2e-3:
                    raise SystemExit(f"fused_mlp {what} at {pair}: rel err {rel:.2e} > 2e-3")
        del nxt, args_
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose kernel to time")
    ap.add_argument("--splits", default="",
                    help="split counts to time the staged body at, both routes, at m = 8 over "
                         "qkv, o_proj and down at B = 6, besides its own sizing")
    ap.add_argument("--stages", type=int, default=None,
                    help="the staged body's INTB_STAGES (its sizing follows), instead of the "
                         "source's")
    ap.add_argument("--blocks", type=int, default=None,
                    help="the staged body's INTB_BLOCKS, its launch bounds' blocks an SM (its "
                         "sizing follows), instead of the source's")
    ap.add_argument("--warps", type=int, default=None,
                    help="--int8 / --mlp: the staged int8 body's INT8_WARPS, 32 columns each (its "
                         "sizing follows), instead of the source's")
    ap.add_argument("--int4", action="store_true",
                    help="the int4 a8 matmul (row 12, int4_matmul.cu) instead of the int-B ones")
    ap.add_argument("--bf16", action="store_true",
                    help="with --int4: the int4 matmul's bf16 route (row 11)")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 matmul's staged body (row 1, int8_matmul.cu)")
    ap.add_argument("--mlp", action="store_true",
                    help="the fused MLP's two phases of the staged int8 body (row 2, fused_mlp.cu)")
    args = ap.parse_args()
    int4, bf16 = args.int4, args.int4 and args.bf16
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))  # that tree's wrapper: its sizing, signatures, plain versions
    if args.int8 or args.mlp:
        return main_int8(args, tree)
    import numpy as np

    from exllamav3_tpu_torch.ops import q_matmul as qm
    from exllamav3_tpu_torch.ops.build import SIGNATURES
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    version, dll, plain, nopdl = build(tree, args.stages, args.blocks, int4, bf16)
    if version == "staged" and int4:
        qm._INT4_STAGES = args.stages or qm._INT4_STAGES
        qm._INT4_BLOCKS = args.blocks or qm._INT4_BLOCKS
        qm.int4_split_count.cache_clear()
    elif version == "staged":
        qm._INTB_STAGES = args.stages or qm._INTB_STAGES
        qm._INTB_BLOCKS = args.blocks or qm._INTB_BLOCKS
        qm.intb_split_count.cache_clear()
    P, I = ctypes.c_void_p, ctypes.c_int
    entries = (("exl3_int4_matmul" if bf16 else "exl3_int4_matmul_a8",) if int4
               else ("exl3_intb_matmul", "exl3_intb_matmul_a8"))
    for lib in (dll, plain, nopdl):
        if lib is not None:
            for fn in entries:
                getattr(lib, fn).argtypes = SIGNATURES[fn]
    dll.phases_read.argtypes = [P, I]
    dll.phases_quantize.argtypes = [P, P, P, I, I, P]
    if version != "staged":
        dll.phases_reduce.argtypes = [P, P, P, I, I, I, P]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"{smi}; kernel: {version} ({tree})", flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(11)

    def inputs(k, n, bits):
        if int4:  # byte pairs: (k/2, n) int8 and (k/32, n) scales
            def make(i):
                x = torch.randn((M, k), generator=g, device=dev).to(torch.bfloat16)
                w = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                                  dtype=torch.int64).to(torch.int8)
                s = ((torch.rand((k // 32, n), generator=g, device=dev) + 0.5) * 0.01).to(
                    torch.bfloat16)
                return x, w, s
            return make, M * k * 2 + k // 2 * n + k // 32 * n * 2 + M * n * 4
        W, kp, k_pad = qm.intb_geometry(k, bits)

        def make(i):
            x = torch.randn((M, k), generator=g, device=dev).to(torch.bfloat16)
            w = torch.randint(-2**31, 2**31, (kp, n), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
            s = ((torch.rand((k_pad // 32, n), generator=g, device=dev) + 0.5) * 0.01).to(
                torch.bfloat16)
            return x, w, s
        return make, M * k * 2 + kp * n * 4 + k_pad // 32 * n * 2 + M * n * 4

    def caller(k, n, bits, a8, splits):
        """call(lib, x, w, s) -> y for one launch of the tree's entry."""
        kp = k // 2 if int4 else qm.intb_geometry(k, bits)[1]
        y = torch.empty((M, n), dtype=torch.float32, device=dev)
        ws = torch.empty((max(splits, 1), M, n), dtype=torch.float32, device=dev)
        xq = torch.empty((M, k), dtype=torch.int8, device=dev)
        xs = torch.empty((M,), dtype=torch.float32, device=dev)
        counters = None
        if version == "staged":
            from exllamav3_tpu_torch.util.device import arrival_counters
            counters = arrival_counters(dev, n // 32)

        def call(lib, x, w, s):
            head = [x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), ws.data_ptr()]
            if counters is not None:
                head.append(counters.data_ptr())
            if int4 and not a8:
                err = lib.exl3_int4_matmul(*head, M, k, n, splits, stream())
            elif int4:
                err = lib.exl3_int4_matmul_a8(*head, xq.data_ptr(), xs.data_ptr(), 1, M, k, n,
                                              splits, stream())
            elif a8:
                err = lib.exl3_intb_matmul_a8(*head, xq.data_ptr(), xs.data_ptr(), 1, M, k, n,
                                              kp, bits, splits, stream())
            else:
                err = lib.exl3_intb_matmul(*head, M, k, n, kp, bits, splits, stream())
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return y
        return call, y, ws, xq, xs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def steps_of(k, bits):  # the k steps a split count divides
        if int4:
            return -(-k // 2 // qm.INT4_STEP_ROWS) if version == "staged" else k // 64
        return qm.intb_geometry(k, bits)[1] // 32

    def fits(k, bits, a8, splits):
        steps = steps_of(k, bits)
        if splits > steps:
            return False
        if int4:
            return qm._int4_smem(M, -(-steps // splits), a8) <= qm.INT4_MAX_SMEM
        return qm._intb_smem(M, bits, a8, -(-steps // splits)) <= qm.INTB_MAX_SMEM

    def plain_of(a8):
        if int4:
            plain4 = qm.int4_matmul_a8_plain if a8 else qm.int4_matmul_plain
            return lambda x, w, s, bits: plain4(x, w, s)
        return qm.intb_matmul_a8_plain if a8 else qm.intb_matmul_plain

    def sizing(k, n, bits, a8):
        if int4 and version == "staged":
            return qm.int4_split_count(M, k, n, sms, a8)
        if int4:
            return qm._packed_splits(M, n, k // 64, True, dev)
        W, kp, _ = qm.intb_geometry(k, bits)
        if version == "staged":
            return qm.intb_split_count(M, k, n, bits, a8, torch.cuda.get_device_properties(dev)
                                       .multi_processor_count)
        return qm._packed_splits(M, n, kp // 32, False, dev)

    for k, n, what, bits in INT4_SHAPES if int4 else SHAPES:
        make, nb = inputs(k, n, bits)
        x, w, s = make(0)
        steps = steps_of(k, bits)
        for a8 in ((not bf16,) if int4 else (False, True)):
            route = ("int4 bf16" if bf16 else "int4 a8") if int4 else "a8" if a8 else "bf16"
            ref = plain_of(a8)(x, w, s, bits)
            splits = sizing(k, n, bits, a8)
            call, y, ws, xq, xs = caller(k, n, bits, a8, splits)
            # the old body's int4 grid is 256 columns a block at m <= 16
            grid = -(-n // (256 if int4 and version != "staged" else 128)) * splits
            said = (f"{route} m={M} {what} ({k}x{n})" + ("" if int4 else f" B={bits}")
                    + f": {steps} steps, {splits} splits, {grid} blocks")
            dll.phases_clear()
            call(dll, x, w, s)
            torch.cuda.synchronize()
            rel = float((y - ref).abs().max() / ref.abs().max())
            buf = np.zeros(grid * SLOTS, np.uint64)
            if dll.phases_read(buf.ctypes.data, grid):
                raise RuntimeError("reading the timers failed")
            buf = buf.reshape(grid, SLOTS).astype(np.float64)
            n_steps = buf[:, 4].sum()
            per_step = ", ".join(f"{nm} {buf[:, i].sum() / n_steps:.0f}"
                                 for i, nm in enumerate(("stage", "reads", "extract", "mma")))
            last = buf[:, 8] > 0
            epi = f"epilogue {buf[~last, 7].mean():.0f}" + (
                " (partial write and arrival)" if version == "staged" and splits > 1 else "")
            if last.any():
                epi += f", last-arriving epilogue with the reduction {buf[last, 7].mean():.0f}"
            nxt = rotating(make, nb)
            inst = time_ms(lambda: call(dll, *nxt()), 20)
            call(plain, x, w, s)
            torch.cuda.synchronize()
            rel = max(rel, float((y - ref).abs().max() / ref.abs().max()))
            ms = time_ms(lambda: call(plain, *nxt()), 20)
            extra = ""
            if nopdl is not None and a8:
                call(nopdl, x, w, s)
                torch.cuda.synchronize()
                rel = max(rel, float((y - ref).abs().max() / ref.abs().max()))
                extra = f"; without PDL {time_ms(lambda: call(nopdl, *nxt()), 20):.4f} ms"
            if a8:
                q_ms = time_ms(lambda: dll.phases_quantize(x.data_ptr(), xq.data_ptr(),
                                                           xs.data_ptr(), M, k, stream()), 20)
                extra += f"; the row quantizer alone {q_ms:.4f} ms"
            if version != "staged":
                if splits > 1:
                    r_ms = time_ms(lambda: dll.phases_reduce(ws.data_ptr(),
                                                             xs.data_ptr() if a8 else None,
                                                             y.data_ptr(), M, n, splits,
                                                             stream()), 20)
                    extra += f"; the split-k reduce alone {r_ms:.4f} ms"
            print(f"{said}, {n_steps / grid:.1f} steps a block; cycles a step: {per_step}; a "
                  f"block: prologue {buf[:, 5].mean():.0f}, k loop mean {buf[:, 6].mean():.0f} "
                  f"longest {buf[:, 6].max():.0f}, {epi}; instrumented {inst:.4f} ms, unpatched "
                  f"{ms:.4f} ms over rotated inputs{extra}; rel err {rel:.2e}", flush=True)
            if not rel <= TOL:
                raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL}")
            del nxt
        del x, w, s
        torch.cuda.empty_cache()

    sweep = [shape for shape in (INT4_SHAPES if int4 else SHAPES)
             if shape[2] in ("qkv", "o_proj", "down") and shape[3] in (6, None)]
    for k, n, what, bits in sweep if args.splits and version == "staged" else []:
        make, nb = inputs(k, n, bits)
        nxt = rotating(make, nb)
        x, w, s = nxt()
        for a8 in ((not bf16,) if int4 else (False, True)):
            ref = plain_of(a8)(x, w, s, bits)
            for splits in (int(v) for v in args.splits.split(",")):
                if not fits(k, bits, a8, splits):
                    continue
                call, y, *_ = caller(k, n, bits, a8, splits)
                call(plain, x, w, s)
                torch.cuda.synchronize()
                rel = float((y - ref).abs().max() / ref.abs().max())
                ms = time_ms(lambda: call(plain, *nxt()), 20)
                tag = ("int4 bf16" if bf16 else "int4 a8") if int4 else f"{'a8' if a8 else 'bf16'}"
                print(f"{tag} m={M} {what} ({k}x{n})" + ("" if int4 else f" B={bits}")
                      + f" at {splits} splits: {ms:.4f} ms over rotated inputs; rel err {rel:.2e}",
                      flush=True)
                if not rel <= TOL:
                    raise SystemExit(f"{splits} splits: rel err {rel:.2e} > {TOL}")


if __name__ == "__main__":
    main()
