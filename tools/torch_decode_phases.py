"""Where a tile's time goes in the decode kernel
(exllamav3_tpu_torch/csrc/attention_decode.cuh), on one card, over the
quantized or the bf16 cache (`--storage`); with --latent in the latent (MLA)
decode kernel (csrc/latent_decode.cuh, kernel row 6a); with --stats in the
same kernel's DeepSeek-V4 stats form (row 6b).

    python3 tools/torch_decode_phases.py                 # (4, 4) and (5, 3), default splits
    python3 tools/torch_decode_phases.py --splits 64,128,256,512,1024,2048
    python3 tools/torch_decode_phases.py --storage bf16 --splits 64,128,256,512  # bf16 geometries
    python3 tools/torch_decode_phases.py --ring --splits 128,256,512   # the Gemma-3-27B ring alone
    python3 tools/torch_decode_phases.py --latent --splits 64,128,256 --geometries 32x2,32x3,64x2
    python3 tools/torch_decode_phases.py --stats --splits 64,128,256 --geometries 32x2,64x2

With --latent: a copy of latent_decode.cuh with clock64() timers around the
phases of its tile loop (the wait for the staged tile, the issue of the next
tile's copies, the quantized storage's unpack, the scores, the softmax, P.V)
and the block's life, run at chip_smoke.py's main latent shape
(DeepSeek-V2-Lite decode, batch 8, 16 heads, contexts 300-2048 over a paged
cache with a shuffled block table) and at 128 heads, over the bf16 latent
and the (4)-bit one: cycles a tile by phase, and at each split size given to
--splits (or latent_split_keys's) the uninstrumented kernel's time over
caches rotated past L2 in each tile geometry given to --geometries (keys a
tile x stages, bf16 and quantized alike; default the header's), each held
to chip_smoke.py's TOL_ATTN (2e-4) or TOL_ATTN_Q (3e-4) of the largest output.

With --stats: the same instrumented copy, launched as attention_stats.cu's
three entries launch it (512-wide rows, the STATS epilogue) at
chip_smoke.py's DeepSeek-V4 shapes (batch 8, q positions 300-2048) at 128 and
16 heads, by source: the sliding ring (W = 144, window 128, stale slots), the
HCA pool (2 entries a page through a shuffled block table) and the CSA rows
(512 gathered, 75-512 visible). Cycles a tile by phase at latent_split_keys's
split (the ring and the pool's `issue` includes nothing of their key table,
which a block fills before its first tile: "start to loop"), then at each
split given to --splits the uninstrumented kernel's time over inputs rotated
past L2 in each geometry of --geometries, each of acc, m and l held to
TOL_ATTN of the plain version's largest magnitude.

Writes a copy of the header into build/decode_phases/ with clock64() timers
around the phases of the tile loop (the wait for the staged tile, the issue
of the next tile's copies, the score pass with the quantized V unpack, the
softmax and P.V), builds it with nvcc as ops/build.py builds the kernels,
and runs it at the Llama-3.1-8B linear decode shape (batch 8, 32 q / 8 kv
heads of 128, contexts 300-2056, T = 2056). Thread 0 of each block sums its
tiles' cycles by phase and times the block's life (start to the tile loop,
to its arrival at the merge counter, and the merge); the script prints the
mean cycles a tile by phase, the tile loop's mean and longest cycles, the
life of blocks that see keys and of those that see none, the merge's cycles
and the instrumented kernel's time (CUDA events over 20 launches, inputs not
rotated). The timers cost
time of their own: compare phases, not the kernel time, with
chip_smoke.py's. At each split size the script also times the
uninstrumented kernel over inputs rotated past L2 (util/timing.py): over
the quantized cache the library's (exl3_linear_attention_quant called with
that split), the sweep that chose decode_split_keys's sizing. Over the bf16
cache it times four tile geometries, 32- and 64-key tiles in two and three
stages, from a build of the unpatched header, at each split given to
--splits (or the one decode_split_keys gives) and at five shapes: the 8B
linear decode above (also instrumented), the 8B paged decode (batch 8,
contexts 300-2048), the Llama-3.2-1B draft's linear decode (batch 8, heads
of 64, T = 2056), the 8B linear decode at batch 1 (context 2048); the
sweep that chose the header's launch_decode_bf16; and the Gemma-3-27B ring
(batch 8, 16 kv heads, W = 1048, instrumented too). It also prints each bf16
kernel's registers and spills. Every output is held against the plain
version at chip_smoke.py's tolerance (3e-4 quantized, 2e-4 bf16, of the
largest output), and the script fails if one misses. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "exllamav3_tpu_torch" / "csrc"
OUT = ROOT / "build" / "decode_phases"
PHASES = ("wait", "issue", "scores (+ V unpack)", "softmax", "P.V")
# per block: the five phases, tiles, the tile loop's cycles, then cycles from
# the block's start to the loop, to its arrival at the counter, and to the
# end of the merge (the merging block only)
SLOTS = 10
TOL = {"quant": 3e-4, "bf16": 2e-4}  # chip_smoke.py's TOL_ATTN_Q and TOL_ATTN
# the bf16 storage's tile geometries (keys a tile, stages), variants 0..3
GEOMETRIES = ((64, 2), (32, 3), (32, 2), (64, 3))

# (anchor in the header, text put in its place); each anchor must occur once
PATCHES = [
    ("namespace {\n\nconstexpr int DECODE_ROWS",
     f"namespace {{\n__device__ unsigned long long g_phase[65536 * {SLOTS}];\n"
     "constexpr int DECODE_ROWS"),
    ("    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;",
     "    const long long t_entry = clock64();\n"
     "    const size_t bi = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x;\n"
     "    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;"),
    ("        for (int i = 0; i < ntiles; ++i) {\n            issue(i + STAGES - 1);",
     "        unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "        const long long t_block = clock64();\n"
     "        for (int i = 0; i < ntiles; ++i) {\n"
     "            const long long t_top = clock64();\n"
     "            issue(i + STAGES - 1);"),
    ("            cp_async_wait<STAGES - 1>();\n            __syncthreads();\n"
     "            const int key0",
     "            const long long t_issued = clock64();\n"
     "            cp_async_wait<STAGES - 1>();\n            __syncthreads();\n"
     "            const long long t_ready = clock64();\n"
     "            ph[0] += t_ready - t_issued;\n            ph[1] += t_issued - t_top;\n"
     "            const int key0"),
    ("                for (int r = 0; r < RT; ++r) Sp[(part * RT + r) * LDP + key] = sacc[r];\n"
     "                __syncthreads();",
     "                for (int r = 0; r < RT; ++r) Sp[(part * RT + r) * LDP + key] = sacc[r];\n"
     "                __syncthreads();\n"
     "                const long long t_scored = clock64();\n"
     "                ph[2] += t_scored - t_ready;"),
    ("                        row_alpha[r] = alpha;\n                    }\n                }\n"
     "                __syncthreads();",
     "                        row_alpha[r] = alpha;\n                    }\n                }\n"
     "                __syncthreads();\n"
     "                const long long t_soft = clock64();\n"
     "                ph[3] += t_soft - t_scored;"),
    ("                }\n            }\n"
     "            __syncthreads();  // the stage, the V tile and the scores are rewritten next\n"
     "        }",
     "                }\n                ph[4] += clock64() - t_soft;\n            }\n"
     "            __syncthreads();  // the stage, the V tile and the scores are rewritten next\n"
     "        }\n"
     "        if (tid == 0) {\n"
     f"            for (int k = 0; k < 5; ++k) g_phase[bi * {SLOTS} + k] = ph[k];\n"
     f"            g_phase[bi * {SLOTS} + 5] = ntiles;\n"
     f"            g_phase[bi * {SLOTS} + 6] = clock64() - t_block;\n"
     f"            g_phase[bi * {SLOTS} + 7] = t_block - t_entry;\n"
     "        }"),
    ("    if (!*flag) return;",
     f"    if (tid == 0) g_phase[bi * {SLOTS} + 8] = clock64() - t_entry;\n"
     "    if (!*flag) return;"),
    ("    if (tid == 0) counters[b * Hk + hk] = 0;  // ready for the next launch",
     f"    if (tid == 0) g_phase[bi * {SLOTS} + 9] = clock64() - t_entry;\n"
     "    if (tid == 0) counters[b * Hk + hk] = 0;  // ready for the next launch"),
]

# the entries both builds hold: the kernel over the linear quantized cache
# (D = 128) and over the bf16 cache, linear or paged, in either geometry
ENTRY = r'''
#include "attention_decode.cuh"
extern "C" int phases_linear(const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* qpos, const void* tl, void* out, void* ws, void* counters,
    int B, int Hq, int Hk, int N, int T, int kb, int vb, float scale, int split_keys,
    void* stream) {
    const LinearRows rows{nullptr, N, T};
    const QuantKV<128> kv{(const uint32_t*)kq, (const __nv_bfloat16*)ks, (const uint32_t*)vq,
                          (const __nv_bfloat16*)vs, Hk, kb, vb, 0.f, 1.f};
    return launch_decode<128>(q, rows, kv, qpos, tl, nullptr, out, ws, counters, B, 1, Hq, Hk,
                              scale, 0, 0.f, split_keys, T, (cudaStream_t)stream);
}
template <int D, class Rows>
int bf16_variant(int variant, const void* q, Rows rows, const void* k, const void* v,
                 const void* qpos, const void* tl, void* out, void* ws, void* counters, int B,
                 int Hq, int Hk, float scale, int split_keys, int key_limit, void* stream,
                 int window = 0) {
    const Bf16KV<D> kv{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v, Hk};
    cudaStream_t st = (cudaStream_t)stream;
    switch (variant) {
        case 1: return launch_decode<D, 32, 3>(q, rows, kv, qpos, tl, nullptr, out, ws, counters,
                                               B, 1, Hq, Hk, scale, window, 0.f, split_keys,
                                               key_limit, st);
        case 2: return launch_decode<D, 32, 2>(q, rows, kv, qpos, tl, nullptr, out, ws, counters,
                                               B, 1, Hq, Hk, scale, window, 0.f, split_keys,
                                               key_limit, st);
        case 3: return launch_decode<D, 64, 3>(q, rows, kv, qpos, tl, nullptr, out, ws, counters,
                                               B, 1, Hq, Hk, scale, window, 0.f, split_keys,
                                               key_limit, st);
        default: return launch_decode<D, 64, 2>(q, rows, kv, qpos, tl, nullptr, out, ws,
                                                counters, B, 1, Hq, Hk, scale, window, 0.f,
                                                split_keys, key_limit, st);
    }
}
// the ring (D = 128): N rows of W slots with their positions, row slots[b]
extern "C" int bf16_ring(int variant, const void* q, const void* k, const void* v,
    const void* pos, const void* slots, const void* qpos, void* out, void* ws, void* counters,
    int B, int Hq, int Hk, int N, int W, float scale, int window, int split_keys, void* stream) {
    const RingRows rows{(const int*)slots, (const int*)pos, N, W};
    return bf16_variant<128>(variant, q, rows, k, v, qpos, nullptr, out, ws, counters, B, Hq, Hk,
                             scale, split_keys, W, stream, window);
}
// bt null: the linear layout (N rows of T slots); else paged (MP pages a table, P pages)
extern "C" int bf16_decode(int variant, const void* q, const void* k, const void* v,
    const void* bt, const void* qpos, const void* tl, void* out, void* ws, void* counters,
    int B, int Hq, int Hk, int D, int N, int T, int MP, int P, float scale, int split_keys,
    void* stream) {
    if (bt != nullptr) {
        const PagedRows rows{(const int*)bt, MP, P};
        return D == 64 ? bf16_variant<64>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B,
                                          Hq, Hk, scale, split_keys, MP * PAGE, stream)
                       : bf16_variant<128>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B,
                                           Hq, Hk, scale, split_keys, MP * PAGE, stream);
    }
    const LinearRows rows{nullptr, N, T};
    return D == 64 ? bf16_variant<64>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B, Hq,
                                      Hk, scale, split_keys, T, stream)
                   : bf16_variant<128>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B, Hq,
                                       Hk, scale, split_keys, T, stream);
}
'''

TIMERS = r'''
extern "C" int phases_read(void* dst, int blocks, int slots) {
    return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)blocks * slots * 8);
}
extern "C" int phases_clear() {
    void* p;
    cudaGetSymbolAddress(&p, g_phase);
    return (int)cudaMemset(p, 0, sizeof(g_phase));
}
'''

# -- --latent: csrc/latent_decode.cuh --------------------------------------------
LATENT_SLOTS = 11
LATENT_PHASES = ("wait", "issue", "unpack", "scores", "softmax", "P.V")
LATENT_PATCHES = [
    ("namespace {\n\nconstexpr int LAT_ROWS",
     f"namespace {{\n__device__ unsigned long long g_phase[65536 * {LATENT_SLOTS}];\n"
     "constexpr int LAT_ROWS"),
    ("    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "    const long long t_entry = clock64();\n"
     "    const size_t bi = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x;\n"
     "    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"),
    ("        for (int i = 0; i < ntiles; ++i) {\n            issue(i + STAGES - 1);",
     "        unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};\n"
     "        const long long t_block = clock64();\n"
     "        for (int i = 0; i < ntiles; ++i) {\n"
     "            const long long t_top = clock64();\n"
     "            issue(i + STAGES - 1);"),
    ("            mbar_wait(bars + i % STAGES, (parity >> (i % STAGES)) & 1u);\n",
     "            const long long t_issued = clock64();\n"
     "            mbar_wait(bars + i % STAGES, (parity >> (i % STAGES)) & 1u);\n"
     "            const long long t_ready = clock64();\n"
     "            ph[0] += t_ready - t_issued;\n            ph[1] += t_issued - t_top;\n"),
    ("            const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(st);\n",
     "            const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(st);\n"
     "            long long t_sc = clock64();\n"),
    ("                Kt = Khi;\n",
     "                Kt = Khi;\n"
     "                const long long t_u = clock64();\n                ph[2] += t_u - t_sc;\n"
     "                t_sc = t_u;\n"),
    ("            __syncthreads();\n\n            // online softmax",
     "            __syncthreads();\n            const long long t_scored = clock64();\n"
     "            ph[3] += t_scored - t_sc;\n\n            // online softmax"),
    ("            __syncthreads();\n\n            // acc = alpha acc + P V",
     "            __syncthreads();\n            const long long t_soft = clock64();\n"
     "            ph[4] += t_soft - t_scored;\n\n            // acc = alpha acc + P V"),
    ("            __syncthreads();  // the stage, the unpacked tile, the scores and P are rewritten next\n"
     "        }\n",
     "            ph[5] += clock64() - t_soft;\n"
     "            __syncthreads();  // the stage, the unpacked tile, the scores and P are rewritten next\n"
     "        }\n"
     "        if (tid == 0) {\n"
     f"            for (int k = 0; k < 6; ++k) g_phase[bi * {LATENT_SLOTS} + k] = ph[k];\n"
     f"            g_phase[bi * {LATENT_SLOTS} + 6] = ntiles;\n"
     f"            g_phase[bi * {LATENT_SLOTS} + 7] = clock64() - t_block;\n"
     f"            g_phase[bi * {LATENT_SLOTS} + 8] = t_block - t_entry;\n"
     "        }\n"),
    ("    if (!*flag) return;",
     f"    if (tid == 0) g_phase[bi * {LATENT_SLOTS} + 9] = clock64() - t_entry;\n"
     "    if (!*flag) return;"),
    ("    if (tid == 0) counters[b * NH + slice] = 0;  // ready for the next launch",
     f"    if (tid == 0) g_phase[bi * {LATENT_SLOTS} + 10] = clock64() - t_entry;\n"
     "    if (tid == 0) counters[b * NH + slice] = 0;  // ready for the next launch"),
]
# the latent decode kernel over a paged cache (bt) or a linear one (bt null)
LATENT_ENTRY = r'''
#include "latent_decode.cuh"
extern "C" int latent_bf16(const void* q, const void* kv, const void* bt, const void* qpos,
    const void* tl, void* out, void* ws, void* counters, int B, int Hq, int MP, int P, int N,
    int T, float scale, int split_keys, void* stream) {
    const LatentBf16Rows<LAT_D> lkv{(const __nv_bfloat16*)kv};
    cudaStream_t st = (cudaStream_t)stream;
    if (bt != nullptr)
        return launch_latent_decode(q, PagedRows{(const int*)bt, MP, P}, lkv, qpos, tl, out, ws,
                                    counters, B, Hq, scale, split_keys, MP * PAGE, st);
    return launch_latent_decode(q, LinearRows{nullptr, N, T}, lkv, qpos, tl, out, ws, counters,
                                B, Hq, scale, split_keys, T, st);
}
extern "C" int latent_quant(const void* q, const void* kq, const void* ks, const void* kpe,
    const void* bt, const void* qpos, const void* tl, void* out, void* ws, void* counters, int B,
    int Hq, int MP, int P, int N, int T, int bits, float scale, int split_keys, void* stream) {
    const LatentQuantRows lkv{(const uint32_t*)kq, (const __nv_bfloat16*)ks,
                              (const __nv_bfloat16*)kpe, bits, 0.f, 1.f};
    cudaStream_t st = (cudaStream_t)stream;
    if (bt != nullptr)
        return launch_latent_decode(q, PagedRows{(const int*)bt, MP, P}, lkv, qpos, tl, out, ws,
                                    counters, B, Hq, scale, split_keys, MP * PAGE, st);
    return launch_latent_decode(q, LinearRows{nullptr, N, T}, lkv, qpos, tl, out, ws, counters,
                                B, Hq, scale, split_keys, T, st);
}
// the stats form at 512 channels, as attention_stats.cu launches it: source 0
// the ring (rows: pos, slots; N, W), 1 the pool (rows: block tables; MP, P,
// epp), 2 the CSA rows (T)
extern "C" int stats_launch(int source, const void* q, const void* kv, const void* rows_a,
    const void* rows_b, const void* qpos, const void* tl, void* out, void* m, void* l, void* ws,
    void* counters, int B, int Hq, int n0, int n1, int n2, float scale, int window, int split_keys,
    void* stream) {
    using R = LatentBf16Rows<KV_ROW>;
    const R rkv{(const __nv_bfloat16*)kv};
    cudaStream_t st = (cudaStream_t)stream;
    if (source == 0)
        return launch_latent_decode<RingRows, R, true>(
            q, RingRows{(const int*)rows_b, (const int*)rows_a, n0, n1}, rkv, qpos, nullptr, out,
            ws, counters, B, Hq, scale, split_keys, n1, st, window, m, l);
    if (source == 1)
        return launch_latent_decode<PoolRows, R, true>(
            q, PoolRows{(const int*)rows_a, n0, n1, n2}, rkv, qpos, tl, out, ws, counters, B, Hq,
            scale, split_keys, n0 * n2, st, 0, m, l);
    return launch_latent_decode<LinearRows, R, true>(
        q, LinearRows{nullptr, B, n0}, rkv, qpos, tl, out, ws, counters, B, Hq, scale, split_keys,
        n0, st, 0, m, l);
}
'''


def latent_quant_fits(tk: int, stages: int) -> bool:
    """Whether the quantized storage's layout at 8 bits (latent_decode.cuh's
    LatentLayout: stages, the hi + lo tile, q, scores, P, rows) fits a block;
    a geometry that does not is timed over bf16 rows alone."""
    stage = -(-tk * (132 * 4 + 32 + 128) // 128) * 128
    return (stages * stage + 2 * tk * 584 * 2 + 16 * 584 * 2 + 4 * 16 * (tk + 4) * 4
            + 2 * 16 * (tk + 8) * 2 + 256) <= 232448


def latent_build(csrc: Path, geometries: list) -> tuple:
    """(the instrumented copy of latent_decode.cuh in the header's geometry,
    [(tk, stages, an unpatched copy in that geometry, for bf16 and quantized
    rows alike)]), built in parallel into build/decode_phases/latent/."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    src = (csrc / "latent_decode.cuh").read_text()
    patched = src
    for anchor, text in LATENT_PATCHES:
        if patched.count(anchor) != 1:
            raise SystemExit(f"the header changed: anchor not found once:\n{anchor}")
        patched = patched.replace(anchor, text)
    out = OUT / "latent"
    dirs = {"phases": patched}
    for tk, stages in geometries:
        geo = src
        for name, value in (("TK", tk), ("STAGES", stages)):
            for storage in (("BF16", "BF16_SLICES", "QUANT") if latent_quant_fits(tk, stages)
                            else ("BF16", "BF16_SLICES")):
                geo = re.sub(rf"^constexpr int LAT_{name}_{storage} = \d+;",
                             f"constexpr int LAT_{name}_{storage} = {value};", geo, count=1,
                             flags=re.M)
        dirs[f"tk{tk}_s{stages}"] = geo
    for sub, text in dirs.items():
        (out / sub).mkdir(parents=True, exist_ok=True)
        (out / sub / "latent_decode.cuh").write_text(text)
        (out / sub / "entry.cu").write_text(LATENT_ENTRY + (TIMERS if sub == "phases" else ""))
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = [[nvcc_path(), *flags, *(["-Xptxas", "-v"] if sub != "phases" else []), f"-I{csrc}",
             "-shared", str(out / sub / "entry.cu"), "-o", str(out / sub / "lib.so")]
            for sub in dirs]
    with ThreadPoolExecutor(len(jobs)) as ex:
        runs = list(ex.map(lambda c: subprocess.run(c, capture_output=True, text=True), jobs))
    for r in runs:
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = []
    for sub, r in zip(dirs, runs):
        lib = ctypes.CDLL(str(out / sub / "lib.so"))
        lib.latent_bf16.argtypes = [P] * 8 + [I] * 6 + [F, I, P]
        lib.latent_quant.argtypes = [P] * 10 + [I] * 7 + [F, I, P]
        lib.stats_launch.argtypes = [I] + [P] * 11 + [I] * 5 + [F, I, I, P]
        libs.append(lib)
        for line in (r.stdout + r.stderr).splitlines():
            if "Used" in line and "registers" in line:
                print(f"ptxas {sub}: {line.split(':', 1)[1].strip()}", flush=True)
    libs[0].phases_read.argtypes = [P, I, I]
    return libs[0], [(tk, st, lib) for (tk, st), lib in zip(geometries, libs[1:])]


def latent_main(csrc: Path, splits: list, geometries: list) -> None:
    """The latent decode kernel at chip_smoke.py's main latent shape and at
    128 heads, bf16 and (4): cycles a tile by phase (the header's geometry,
    latent_split_keys's split), then each split and geometry's time."""
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (LATENT_MAX_SPLITS, device_sms,
                                                          latent_attention_plain,
                                                          latent_attention_quant_plain,
                                                          latent_split_keys)
    from exllamav3_tpu_torch.ops.kv_quant import quantize_kv
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    own = re.findall(r"^constexpr int LAT_(?:TK|STAGES)_BF16 = (\d+);",
                     (csrc / "latent_decode.cuh").read_text(), re.M)
    geometries = geometries or [(int(own[0]), int(own[1]))]
    phases_dll, libs = latent_build(csrc, geometries)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    rng = np.random.default_rng(21)
    B, D, scale = 8, 576, 192 ** -0.5
    ctx = np.linspace(300, 2048, 8).astype(np.int32)
    qp = torch.as_tensor(ctx[:, None] - 1, device=dev)
    tl = torch.as_tensor(ctx, device=dev)
    MP = int(math.ceil(ctx.max() / PAGE_SIZE)) + 1
    P = B * MP + 1
    perm = rng.permutation(np.arange(1, P))[: B * MP].reshape(B, MP).astype(np.int32)
    perm[:, -1] = 0
    bt = torch.as_tensor(perm, device=dev)
    width = MP * PAGE_SIZE
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for Hq in (16, 128):
        q = (torch.randn((B, 1, Hq, D), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        slices = -(-Hq // 16)
        counters = torch.zeros(B * slices, dtype=torch.int32, device=dev)
        out = torch.empty((B, 1, Hq, 512), device=dev)
        for storage in ("bf16", "(4)"):
            raw = torch.randn((P, PAGE_SIZE, 1, D), generator=g, device=dev)
            if storage == "bf16":
                state = {"kv": raw.to(torch.bfloat16)}
                ref = latent_attention_plain(q, state["kv"], qp, tl, 512, block_tables=bt,
                                             scale=scale)
                qk, tol = q, TOL["bf16"]
            else:
                kq, ks = quantize_kv(raw[..., :512], 4, 0.0)
                state = {"kv_q": kq, "kv_s": ks, "k_pe": raw[..., 512:].to(torch.bfloat16).contiguous()}
                ref = latent_attention_quant_plain(q, state, qp, tl, 4, 0.0, block_tables=bt,
                                                   scale=scale)
                qk, tol = q, TOL["quant"]  # the kernel rotates q and the output itself
            del raw
            nbytes = sum(t.numel() * t.element_size() for t in state.values())
            nxt = rotating(lambda i: state if i == 0 else {n: t.clone() for n, t in state.items()},
                           nbytes)

            def call(lib, st, split, ws):
                if storage == "bf16":
                    err = lib.latent_bf16(qk.data_ptr(), st["kv"].data_ptr(), bt.data_ptr(),
                                          qp.data_ptr(), tl.data_ptr(), out.data_ptr(),
                                          ws.data_ptr(), counters.data_ptr(), B, Hq, MP, P, 0, 0,
                                          scale, split, stream())
                else:
                    err = lib.latent_quant(qk.data_ptr(), st["kv_q"].data_ptr(),
                                           st["kv_s"].data_ptr(), st["k_pe"].data_ptr(),
                                           bt.data_ptr(), qp.data_ptr(), tl.data_ptr(),
                                           out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B,
                                           Hq, MP, P, 0, 0, 4, scale, split, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            def rel_err():
                return float((out - ref).abs().max() / ref.abs().max())

            own_split = latent_split_keys(width, B, Hq, device_sms(dev))
            for split in splits or [own_split]:
                ns = -(-width // split)
                if ns > LATENT_MAX_SPLITS:
                    print(f"split {split}: {ns} splits, more than the kernel's {LATENT_MAX_SPLITS}")
                    continue
                ws = torch.empty(B * slices * ns * 16 * 514, device=dev)
                said = f"latent {storage} decode B=8 Hq={Hq} ctx 300-2048 paged, split {split} ({ns} splits)"
                if split == own_split or not splits:
                    phases_dll.phases_clear()
                    call(phases_dll, state, split, ws)
                    torch.cuda.synchronize()
                    rel = rel_err()
                    buf = np.zeros(ns * slices * B * LATENT_SLOTS, np.uint64)
                    if phases_dll.phases_read(buf.ctypes.data, ns * slices * B, LATENT_SLOTS):
                        raise RuntimeError("reading the timers failed")
                    buf = buf.reshape(-1, LATENT_SLOTS).astype(np.float64)
                    live = buf[:, 6] > 0
                    tiles = buf[:, 6].sum()
                    per_tile = ", ".join(f"{nm} {buf[:, k].sum() / tiles:.0f}"
                                         for k, nm in enumerate(LATENT_PHASES))
                    merged = buf[buf[:, 10] > 0]
                    print(f"{said}, the header's geometry: instrumented, rel err {rel:.2e}; "
                          f"{int(tiles)} tiles in {int(live.sum())} blocks that see keys; cycles a "
                          f"tile: {per_tile}; a block's tile loop: mean {buf[live, 7].mean():.0f}, "
                          f"longest {buf[live, 7].max():.0f}; start to loop "
                          f"{buf[live, 8].mean():.0f}, to its arrival {buf[live, 9].mean():.0f}; the "
                          f"merge after the arrival {(merged[:, 10] - merged[:, 9]).mean():.0f} "
                          f"({len(merged)} merges)", flush=True)
                    if not rel <= tol:
                        raise SystemExit(f"{said}: rel err {rel:.2e} > {tol}")
                for tk, stages, lib in libs:
                    if storage != "bf16" and not latent_quant_fits(tk, stages):
                        continue
                    call(lib, state, split, ws)
                    torch.cuda.synchronize()
                    rel = rel_err()
                    ms = time_ms(lambda: call(lib, nxt(), split, ws), 50)
                    warm = time_ms(lambda: call(lib, state, split, ws), 50)
                    print(f"{said}, {tk} keys a tile in {stages} stages: {ms:.4f} ms over rotated "
                          f"caches (L2-warm {warm:.4f}), rel err {rel:.2e}", flush=True)
                    if not rel <= tol:
                        raise SystemExit(f"{said}: rel err {rel:.2e} > {tol}")
            del state, nxt
            torch.cuda.empty_cache()


def stats_main(csrc: Path, splits: list, geometries: list) -> None:
    """The stats form at chip_smoke.py's DeepSeek-V4 decode shapes, by source
    and at 128 and 16 heads: cycles a tile by phase (the header's geometry,
    latent_split_keys's split), then each split and geometry's time."""
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops import flash_attention as fa
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    header = (csrc / "latent_decode.cuh").read_text()
    # the header's two bf16 geometries: one head slice, several
    own = [tuple(int(v) for v in re.findall(rf"^constexpr int LAT_(?:TK|STAGES)_{geo} = (\d+);",
                                            header, re.M)) for geo in ("BF16", "BF16_SLICES")]
    geometries = geometries or sorted(set(own))
    phases_dll, libs = latent_build(csrc, geometries)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    rng = np.random.default_rng(31)
    B, D, W, window, K = 8, fa.KV_ROW, 144, 128, 512
    scale = D ** -0.5
    qpos = np.linspace(300, 2048, 8).astype(np.int32)
    qp = torch.as_tensor(qpos[:, None], device=dev)
    N, slots = 9, np.array([3, 7, 0, 5, 8, 1, 6, 2], np.int32)
    pos = np.full((N, W), -1, np.int32)
    for b, row in enumerate(slots):
        for t in range(max(0, int(qpos[b]) - W + 1), int(qpos[b]) + 1 + int(rng.integers(0, 4))):
            pos[row, t % W] = t
    pos, sl = torch.as_tensor(pos, device=dev), torch.as_tensor(slots, device=dev)
    MP = int(math.ceil((qpos.max() + 1) / PAGE_SIZE)) + 1
    P, epp = B * MP + 1, PAGE_SIZE // 128
    bt = torch.as_tensor(rng.permutation(np.arange(1, P))[: B * MP].reshape(B, MP)
                         .astype(np.int32), device=dev)
    n_pool = (qpos + 1) // 128
    pq = torch.as_tensor((n_pool - 1)[:, None].astype(np.int32), device=dev)
    pt = torch.as_tensor(n_pool.astype(np.int32), device=dev)
    vcount = np.minimum((qpos + 1) // 4, K).astype(np.int32)
    rq = torch.as_tensor((vcount - 1)[:, None], device=dev)
    rt = torch.as_tensor(vcount, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sources = (  # (name, width, make the storage, the launch's rows and lengths, plain)
        ("ring", W, lambda: torch.randn((N, W, D), generator=g, device=dev).to(torch.bfloat16),
         (pos, sl, qp, None, N, W, 0),
         lambda q, kv: fa.ring_attention_stats_plain(q, kv, pos, sl, qp, scale, window)),
        ("pool", MP * epp,
         lambda: torch.randn((P, epp, D), generator=g, device=dev).to(torch.bfloat16),
         (bt, None, pq, pt, MP, P, epp),
         lambda q, kv: fa.pool_attention_stats_plain(q, kv, bt, pq, pt, scale)),
        ("rows", K, lambda: torch.randn((B, K, D), generator=g, device=dev).to(torch.bfloat16),
         (None, None, rq, rt, K, 0, 0),
         lambda q, kv: fa.rows_attention_stats_plain(q, kv, rq, rt, scale)))
    for Hq in (128, 16):
        q = (torch.randn((B, 1, Hq, D), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        slices = -(-Hq // 16)
        counters = torch.zeros(B * slices, dtype=torch.int32, device=dev)
        acc = torch.empty((B, 1, Hq, D), device=dev)
        m, l = torch.empty((B, 1, Hq), device=dev), torch.empty((B, 1, Hq), device=dev)
        for source, (name, width, make, rows, plain) in enumerate(sources):
            kv = make()
            ref = plain(q, kv)
            nxt = rotating(lambda i: kv if i == 0 else make(), kv.numel() * 2)
            ra, rb, qq, tt, n0, n1, n2 = rows

            def call(lib, kvs, split, ws):
                err = lib.stats_launch(source, q.data_ptr(), kvs.data_ptr(),
                                       None if ra is None else ra.data_ptr(),
                                       None if rb is None else rb.data_ptr(), qq.data_ptr(),
                                       None if tt is None else tt.data_ptr(), acc.data_ptr(),
                                       m.data_ptr(), l.data_ptr(), ws.data_ptr(),
                                       counters.data_ptr(), B, Hq, n0, n1, n2, scale, window,
                                       split, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            def rel_err():
                return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip((acc, m, l), ref))

            own_split = fa.latent_split_keys(width, B, Hq, fa.device_sms(dev), name != "rows")
            for split in splits or [own_split]:
                ns = -(-width // split)
                if ns > fa.LATENT_MAX_SPLITS or (name != "rows" and split > fa.LATENT_TABLE_KEYS):
                    continue
                ws = torch.empty(B * slices * ns * 16 * 514, device=dev)
                said = f"stats {name} B=8 Hq={Hq} width {width}, split {split} ({ns} splits)"
                if split == own_split or not splits:
                    phases_dll.phases_clear()
                    call(phases_dll, kv, split, ws)
                    torch.cuda.synchronize()
                    rel = rel_err()
                    buf = np.zeros(ns * slices * B * LATENT_SLOTS, np.uint64)
                    if phases_dll.phases_read(buf.ctypes.data, ns * slices * B, LATENT_SLOTS):
                        raise RuntimeError("reading the timers failed")
                    buf = buf.reshape(-1, LATENT_SLOTS).astype(np.float64)
                    live = buf[:, 6] > 0
                    tiles = max(buf[:, 6].sum(), 1)
                    per_tile = ", ".join(f"{nm} {buf[:, k].sum() / tiles:.0f}"
                                         for k, nm in enumerate(LATENT_PHASES))
                    merged = buf[buf[:, 10] > 0]
                    merge = (f"the merge after the arrival {(merged[:, 10] - merged[:, 9]).mean():.0f}"
                             f" ({len(merged)} merges)" if len(merged) else "one split: no merge")
                    print(f"{said}, the header's geometry: instrumented, rel err {rel:.2e}; "
                          f"{int(buf[:, 6].sum())} tiles in {int(live.sum())} blocks that see keys; "
                          f"cycles a tile: {per_tile}; a block's tile loop: mean "
                          f"{buf[live, 7].mean():.0f}, longest {buf[live, 7].max():.0f}; start to "
                          f"loop {buf[live, 8].mean():.0f}; {merge}", flush=True)
                    if not rel <= TOL["bf16"]:
                        raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")
                for tk, stages, lib in libs:
                    call(lib, kv, split, ws)
                    torch.cuda.synchronize()
                    rel = rel_err()
                    ms = time_ms(lambda: call(lib, nxt(), split, ws), 50)
                    warm = time_ms(lambda: call(lib, kv, split, ws), 50)
                    print(f"{said}, {tk} keys a tile in {stages} stages: {ms:.4f} ms over "
                          f"rotated inputs (L2-warm {warm:.4f}), rel err {rel:.2e}", flush=True)
                    if not rel <= TOL["bf16"]:
                        raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")
            del kv, nxt
            torch.cuda.empty_cache()


def print_registers(ptxas: str) -> None:
    """Each bf16 decode kernel's registers and spills, from ptxas -v."""
    name = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "Used" in line and "registers" in line:
            if "Bf16KV" in name:
                what = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout
                sig = re.search(r"decode_kernel<(\d+), (\d+), (\d+), (\d+), [^,]*::(\w+)",
                                what or "")
                said = (f"D={sig[1]} RT={sig[2]} TK={sig[3]} STAGES={sig[4]} {sig[5]}" if sig
                        else name)
                print(f"ptxas: decode_kernel {said}: {line.split(':', 1)[1].strip()}",
                      flush=True)
            name = None
        elif name and "spill" in line and "Bf16KV" in name:
            print(f"ptxas:   {line.strip()}", flush=True)


def build(csrc: Path = CSRC) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """(the instrumented copy of the kernel, the unpatched one) from the
    headers in `csrc`, built in parallel into build/decode_phases/ (a
    subdirectory named after `csrc` for another directory)."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    out = OUT if csrc == CSRC else OUT / csrc.resolve().parent.name
    src = (csrc / "attention_decode.cuh").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"the header changed: anchor not found once:\n{anchor}")
        src = src.replace(anchor, text)
    out.mkdir(parents=True, exist_ok=True)
    (out / "attention_decode.cuh").write_text(src)
    (out / "attention_tiles.cuh").write_text((csrc / "attention_tiles.cuh").read_text())
    (out / "phases.cu").write_text(ENTRY + TIMERS)
    (out / "plain").mkdir(exist_ok=True)  # apart from the patched copy, which "" would find
    (out / "plain" / "plain.cu").write_text(ENTRY)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    # the copies' includes resolve beside them first, then in `csrc`
    jobs = [[nvcc_path(), *flags, f"-I{csrc}", "-shared", str(out / "phases.cu"), "-o",
             str(out / "phases.so")],
            [nvcc_path(), *flags, "-Xptxas", "-v", f"-I{csrc}", "-shared",
             str(out / "plain" / "plain.cu"), "-o", str(out / "plain.so")]]
    with ThreadPoolExecutor(2) as ex:
        runs = list(ex.map(lambda c: subprocess.run(c, capture_output=True, text=True), jobs))
    for r in runs:
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
    print_registers(runs[1].stdout + runs[1].stderr)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dlls = ctypes.CDLL(str(out / "phases.so")), ctypes.CDLL(str(out / "plain.so"))
    for dll in dlls:
        dll.phases_linear.argtypes = [P] * 10 + [I] * 7 + [F, I, P]
        dll.bf16_decode.argtypes = [I] + [P] * 9 + [I] * 8 + [F, I, P]
        dll.bf16_ring.argtypes = [I] + [P] * 9 + [I] * 5 + [F, I, I, P]
    dlls[0].phases_read.argtypes = [P, I, I]
    return dlls


def read_phases(dll, blocks: int) -> np.ndarray:
    """(blocks, SLOTS) f64: each block's cycles by phase, tiles and cycles."""
    buf = np.zeros(blocks * SLOTS, np.uint64)
    if dll.phases_read(buf.ctypes.data, blocks, SLOTS):
        raise RuntimeError("reading the timers failed")
    return buf.reshape(blocks, SLOTS).astype(np.float64)


def phase_line(buf: np.ndarray) -> str:
    tiles = buf[:, 5].sum()
    if tiles == 0:  # the ring's split by warps (ring_split_warps) carries no timers
        return "no timed tile loop"
    live = buf[:, 5] > 0
    busy = buf[live, 6]
    per_tile = ", ".join(f"{nm} {buf[:, k].sum() / tiles:.0f}"
                         for k, nm in zip((0, 1, 2, 3, 4), PHASES))
    merged = buf[buf[:, 9] > 0]
    return (f"{int(tiles)} tiles in {len(busy)} blocks that see keys; cycles a tile: {per_tile}; "
            f"a block's tile loop: mean {busy.mean():.0f}, longest {busy.max():.0f}; a block "
            f"that sees keys, start to loop {buf[live, 7].mean():.0f}, to its arrival "
            f"{buf[live, 8].mean():.0f}; one that sees none, to its arrival "
            f"{buf[~live, 8].mean() if (~live).any() else 0:.0f}; the merge after the arrival "
            f"{(merged[:, 9] - merged[:, 8]).mean():.0f} ({len(merged)} merges)")


def bf16_main(dll, plain_dll, splits: list) -> None:
    """The bf16 storage: at each shape, each split given (or the one
    decode_split_keys gives) and each geometry, the kernel's time; at the
    first shape also its cycles a tile by phase."""
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (decode_split_keys, device_sms,
                                                          linear_attention_plain,
                                                          paged_attention_plain)
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(3)
    ctx8 = np.linspace(300, 2048, 8).astype(np.int32)
    ctx8t = np.linspace(300, 2056, 8).astype(np.int32)
    # (name, B, Hq, Hk, D, contexts, paged, linear slots T); the first is the phases' shape
    shapes = [("8B linear decode B=8 ctx 300-2056 T=2056", 8, 32, 8, 128, ctx8t, False, 2056),
              ("8B paged decode B=8 ctx 300-2048", 8, 32, 8, 128, ctx8, True, 0),
              ("1B draft linear decode B=8 D=64 ctx 300-2056 T=2056", 8, 32, 8, 64, ctx8t, False,
               2056),
              ("8B linear decode B=1 ctx 2048 T=2056", 1, 32, 8, 128, np.array([2048], np.int32),
               False, 2056)]
    for si, (name, B, Hq, Hk, D, ctx, paged, T) in enumerate(shapes):
        qp = torch.as_tensor(ctx[:, None] - 1, device=dev)
        tl = torch.as_tensor(ctx, device=dev)
        q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
        if paged:
            MP = int(math.ceil(ctx.max() / PAGE_SIZE)) + 1
            P = B * MP + 1
            perm = rng.permutation(np.arange(1, P))[: B * MP].reshape(B, MP).astype(np.int32)
            perm[:, -1] = 0
            bt = torch.as_tensor(perm, device=dev)
            lead, width = (P, PAGE_SIZE), MP * PAGE_SIZE
        else:
            MP = P = 0
            bt = None
            lead, width = (B, T), T

        def make(i):
            return {n: torch.randn((*lead, Hk, D), generator=g, device=dev).to(torch.bfloat16)
                    for n in ("k", "v")}
        kv = make(0)
        ref = (paged_attention_plain(q, kv["k"], kv["v"], bt, qp, tl, scale=D ** -0.5) if paged
               else linear_attention_plain(q, kv["k"], kv["v"], qp, tl, scale=D ** -0.5))
        nxt = rotating(lambda i: kv if i == 0 else make(i), 2 * kv["k"].numel() * 2)
        counters = torch.zeros(B * Hk, dtype=torch.int32, device=dev)
        out = torch.empty((B, 1, Hq, D), device=dev)
        for split in (splits or [decode_split_keys(width, B, Hk, device_sms(dev))]):
            ws = torch.empty(B * Hk * -(-width // split) * (Hq // Hk) * (D + 2), device=dev)
            for variant, (tk, stages) in enumerate(GEOMETRIES):
                def call(lib, st):
                    err = lib.bf16_decode(
                        variant, q.data_ptr(), st["k"].data_ptr(), st["v"].data_ptr(),
                        None if bt is None else bt.data_ptr(), qp.data_ptr(), tl.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Hq, Hk, D, B,
                        T, MP, P, D ** -0.5, split, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                said = f"{name}, {tk} keys a tile in {stages} stages, split {split}"
                if si == 0:
                    dll.phases_clear()
                    call(dll, kv)
                    torch.cuda.synchronize()
                    rel = float((out - ref).abs().max() / ref.abs().max())
                    buf = read_phases(dll, -(-width // split) * Hk * B)
                    print(f"{said}: instrumented, rel err {rel:.2e}; {phase_line(buf)}",
                          flush=True)
                    if not rel <= TOL["bf16"]:
                        raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")
                call(plain_dll, kv)
                torch.cuda.synchronize()
                rel = float((out - ref).abs().max() / ref.abs().max())
                ms = time_ms(lambda: call(plain_dll, nxt()), 50)
                warm = time_ms(lambda: call(plain_dll, kv), 50)
                print(f"{said}: {ms:.4f} ms over rotated inputs (L2-warm {warm:.4f}), rel err "
                      f"{rel:.2e}", flush=True)
                if not rel <= TOL["bf16"]:
                    raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")
        del kv, nxt
        torch.cuda.empty_cache()
    ring_main(dll, plain_dll, splits)


def ring_main(dll, plain_dll, splits: list) -> None:
    """The ring at Gemma-3-27B decode (batch 8, q positions 300-2048, window
    1024 in rings of W = 1048 slots, 9 rows, a permuted slot table, up to 3
    stale slots, 32 q / 16 kv heads of 128), as chip_smoke.py's row 8: at
    each split given (or decode_split_keys's) and each geometry, the
    kernel's cycles a tile by phase and its time over rotated rings."""
    from exllamav3_tpu_torch.ops.flash_attention import (decode_split_keys, device_sms,
                                                          ring_attention_plain)
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(21)
    B, Hq, Hk, D, N, window = 8, 32, 16, 128, 9, 1024
    W = window + 17 + (-(window + 17)) % 8
    qpos = np.linspace(300, 2048, 8).astype(np.int32)
    slots = np.array([3, 7, 0, 5, 8, 1, 6, 2], np.int32)
    pos = np.full((N, W), -1, np.int32)
    for b, row in enumerate(slots):
        p = int(qpos[b])
        for t in range(max(0, p - W + 1), p + 1 + int(rng.integers(0, 4))):
            pos[row, t % W] = t
    pos, sl = torch.as_tensor(pos, device=dev), torch.as_tensor(slots, device=dev)
    qp = torch.as_tensor(qpos[:, None], device=dev)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev)

    def make(i):
        return {n: torch.randn((N, W, Hk, D), generator=g, device=dev).to(torch.bfloat16)
                for n in ("k", "v")}
    kv = make(0)
    ref = ring_attention_plain(q, kv["k"], kv["v"], pos, sl, qp, scale=D ** -0.5,
                               sliding_window=window)
    nxt = rotating(lambda i: kv if i == 0 else make(i), 2 * kv["k"].numel() * 2)
    counters = torch.zeros(B * Hk, dtype=torch.int32, device=dev)
    out = torch.empty((B, 1, Hq, D), device=dev)
    for split in (splits or [decode_split_keys(W, B, Hk, device_sms(dev))]):
        ws = torch.empty(B * Hk * -(-W // split) * (Hq // Hk) * (D + 2), device=dev)
        for variant, (tk, stages) in enumerate(GEOMETRIES):
            def call(lib, st):
                err = lib.bf16_ring(variant, q.data_ptr(), st["k"].data_ptr(), st["v"].data_ptr(),
                                    pos.data_ptr(), sl.data_ptr(), qp.data_ptr(), out.data_ptr(),
                                    ws.data_ptr(), counters.data_ptr(), B, Hq, Hk, N, W,
                                    D ** -0.5, window, split,
                                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            said = (f"ring Gemma-3-27B decode B=8 W={W}, {tk} keys a tile in {stages} stages, "
                    f"split {split}")
            dll.phases_clear()
            call(dll, kv)
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max() / ref.abs().max())
            buf = read_phases(dll, -(-W // split) * Hk * B)
            call(plain_dll, kv)
            torch.cuda.synchronize()
            rel = max(rel, float((out - ref).abs().max() / ref.abs().max()))
            ms = time_ms(lambda: call(plain_dll, nxt()), 50)
            print(f"{said}: {ms:.4f} ms over rotated rings, rel err {rel:.2e}; instrumented: "
                  f"{phase_line(buf)}", flush=True)
            if not rel <= TOL["bf16"]:
                raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="", help="split sizes (keys); default: decode_split_keys")
    ap.add_argument("--storage", choices=("quant", "bf16"), default="quant")
    ap.add_argument("--ring", action="store_true", help="the bf16 ring's shape alone")
    ap.add_argument("--csrc", default=str(CSRC),
                    help="directory of the headers to build (another tree's csrc/)")
    ap.add_argument("--latent", action="store_true",
                    help="the latent (MLA) decode kernel, csrc/latent_decode.cuh")
    ap.add_argument("--stats", action="store_true",
                    help="the same kernel's DeepSeek-V4 stats form (ring, pool, rows)")
    ap.add_argument("--geometries", default="",
                    help="with --latent or --stats: keys a tile x stages to time, e.g. 32x2,64x2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    if args.latent or args.stats:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
        geometries = [tuple(int(v) for v in gs.split("x")) for gs in args.geometries.split(",") if gs]
        return (stats_main if args.stats else latent_main)(
            Path(args.csrc), [int(v) for v in args.splits.split(",")] if args.splits else [],
            geometries)
    from exllamav3_tpu_torch.ops.build import library
    from exllamav3_tpu_torch.ops.flash_attention import (decode_split_keys, device_sms,
                                                          linear_attention_quant_plain)
    from exllamav3_tpu_torch.ops.kv_quant import merged_layout, quantize_kv_stored
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    dll, plain_dll = build(Path(args.csrc))
    dev = torch.device("cuda")
    B, Hq, Hk, D, T = 8, 32, 8, 128, 2056
    ctx = np.linspace(300, 2056, 8).astype(np.int32)
    qp = torch.as_tensor(ctx[:, None] - 1, device=dev)
    tl = torch.as_tensor(ctx, device=dev)
    counters = torch.zeros(B * Hk, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
    given = [int(s) for s in args.splits.split(",")] if args.splits else []
    splits = given or [decode_split_keys(T, B, Hk, device_sms(dev))]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if args.ring:
        return ring_main(dll, plain_dll, given)
    if args.storage == "bf16":
        return bf16_main(dll, plain_dll, given)
    lib = library()
    for kb, vb in ((4, 4), (5, 3)):
        state = {}
        for nm, bits in (("k", kb), ("v", vb)):
            x = torch.randn((B, T, Hk, D), generator=g, device=dev)
            state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, bits, merged_layout(kb, vb))
        ref = linear_attention_quant_plain(q, state, qp, tl, kb, vb, scale=D ** -0.5)
        nbytes = sum(t.numel() * t.element_size() for t in state.values())
        nxt = rotating(lambda i: state if i == 0 else {n: t.clone() for n, t in state.items()},
                       nbytes)
        for split in splits:
            ns = -(-T // split)
            ws = torch.empty(B * Hk * ns * (Hq // Hk) * (D + 2), device=dev)
            out = torch.empty_like(q)
            lib_out = torch.empty_like(q)

            def lib_call(st):
                err = lib.exl3_linear_attention_quant(
                    q.data_ptr(), st["k_q"].data_ptr(), st["k_s"].data_ptr(),
                    st["v_q"].data_ptr(), st["v_s"].data_ptr(), None, qp.data_ptr(),
                    tl.data_ptr(), None, lib_out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                    B, 1, Hq, Hk, D, B, T, kb, vb, 0.0, 1.0, D ** -0.5, 0, 0.0, split,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            def call():
                err = dll.phases_linear(
                    q.data_ptr(), state["k_q"].data_ptr(), state["k_s"].data_ptr(),
                    state["v_q"].data_ptr(), state["v_s"].data_ptr(), qp.data_ptr(),
                    tl.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Hq, Hk,
                    B, T, kb, vb, D ** -0.5, split, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            dll.phases_clear()
            call()
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max() / ref.abs().max())
            blocks = ns * Hk * B
            buf = read_phases(dll, blocks)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                call()
            e1.record()
            torch.cuda.synchronize()
            lib_call(state)
            torch.cuda.synchronize()
            lib_rel = float((lib_out - ref).abs().max() / ref.abs().max())
            lib_ms = time_ms(lambda: lib_call(nxt()), 50)
            print(f"bits ({kb}, {vb}) split {split}: {phase_line(buf)}; instrumented kernel "
                  f"{e0.elapsed_time(e1) / 20:.4f} ms, rel err {rel:.2e}; library kernel "
                  f"{lib_ms:.4f} ms over rotated inputs, rel err {lib_rel:.2e}", flush=True)
            if not max(rel, lib_rel) <= TOL["quant"]:
                raise SystemExit(f"split {split}: rel err {max(rel, lib_rel):.2e} > {TOL['quant']}")


if __name__ == "__main__":
    main()
