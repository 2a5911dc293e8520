// The int4 kernel bodies taken apart: unpack strategies of the bf16 route,
// the a8 route stage by stage, and W4A8 over block-diagonal activations.
//
// Replaces: tools/int4_sweep.py::make_kernel (int4_mm)          -> exl3_probe_int4_sweep
//           tools/a8_ablate.py::make (call)                     -> exl3_probe_a8_ablate
//           tools/a8_diag_proto.py::_diag_kernel (int4_a8_diag) -> exl3_probe_a8_diag
//           the probes of exllamav3_tpu/ops/q_matmul.py's int4 kernels.
// Function: probes/int4_sweep.py, a8_ablate.py and a8_diag_proto.py define
//           each variant; the packed layout is the int4 tier's (k/2, n)
//           int8, byte row r holding weight rows r and r + k/2 in its low and
//           high nibble, both biased by +8; scales (k/32, n) bf16.
// Bound:    bytes: the packed bytes and scales once (decode sizes).
// Design:   csrc/packed_matmul.cuh's layout, so that the variants split the
//           production kernels' time: 4 warps, each owning 8 * NT columns; a
//           lane reads NT neighbouring columns of 8 neighbouring packed rows
//           (rows 8t..8t+7 of a 32-row step for lane quarter t) straight from
//           device memory, the next step's while the MMAs of this one run,
//           and declares them its B fragments (bf16 mma.m16n8k16 for the
//           sweep and dotbf, int8 mma.m16n8k32 otherwise, bytes moved into
//           place by __byte_perm); x is read to match, 8 consecutive k a lane.
//           k splits across blocks as in the production kernels (the caller's
//           `splits`), and the partial rows add in split order. Where a stage
//           keeps only part of what it computes (convonly, extract), each
//           warp XORs all the rest into one word and stores it to `sink`, so
//           that the compiler cannot drop the work the stage exists to time.
#include "packed_matmul.cuh"

namespace {

using packed::THREADS;
using packed::WARPS;

enum { I32, BITCAST, MXUFIX, XORC };                           // int4_sweep variants
enum { DOTPAR, DOT, DOTBF, CONVONLY, DOT2, EXTRACT, FIX };    // a8_ablate stages

__device__ __forceinline__ void mma_s8_acc(int (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 32-bit word (4 neighbouring columns) of each of a lane's 8 packed rows
// -> int8 B fragments: b[j][h] holds rows 4h..4h+3 of column j
__device__ __forceinline__ void transpose(const uint32_t (&c)[8], uint32_t (&b)[4][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t p01 = __byte_perm(c[4 * h], c[4 * h + 1], 0x5140);
        const uint32_t p23 = __byte_perm(c[4 * h + 2], c[4 * h + 3], 0x5140);
        const uint32_t q01 = __byte_perm(c[4 * h], c[4 * h + 1], 0x7362);
        const uint32_t q23 = __byte_perm(c[4 * h + 2], c[4 * h + 3], 0x7362);
        b[0][h] = __byte_perm(p01, p23, 0x5410);
        b[1][h] = __byte_perm(p01, p23, 0x7632);
        b[2][h] = __byte_perm(q01, q23, 0x5410);
        b[3][h] = __byte_perm(q01, q23, 0x7632);
    }
}

// B fragments of all NT columns from a per-word map of the lane's words
template <int NT, class F>
__device__ __forceinline__ void s8_frags(const uint32_t (&w)[8][NT / 4], F f,
                                         uint32_t (&b)[NT][2]) {
#pragma unroll
    for (int r = 0; r < NT / 4; ++r) {
        uint32_t c[8], t[4][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) c[i] = f(w[i][r]);
        transpose(c, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) { b[4 * r + j][0] = t[j][0]; b[4 * r + j][1] = t[j][1]; }
    }
}

__device__ __forceinline__ uint32_t high_nibbles(uint32_t w) {  // ((byte ^ 0x80) >> 4) per byte
    return ((w ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu;
}

template <int NT>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ packed, int step, int t,
                                          int n, int bcol, uint32_t (&dst)[8][NT / 4]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
        packed::load_u32<NT / 4>(packed + (((size_t)(step * 32 + 8 * t + i) * n + bcol) >> 2),
                                 dst[i]);
}

// x int8 rows g and g + 8 (of `rows`), 8 consecutive k at `col`: s8 A fragment
__device__ __forceinline__ void a_s8(const int8_t* __restrict__ x, size_t ld, int g, int rows,
                                     int col, uint32_t (&a)[4]) {
    uint2 va = make_uint2(0u, 0u), vb = make_uint2(0u, 0u);
    if (g < rows) va = __ldg(reinterpret_cast<const uint2*>(x + g * ld + col));
    if (g + 8 < rows) vb = __ldg(reinterpret_cast<const uint2*>(x + (g + 8) * ld + col));
    a[0] = va.x; a[1] = vb.x; a[2] = va.y; a[3] = vb.y;
}

__device__ __forceinline__ uint32_t bf16x2_of_s8(uint32_t v, int half) {  // bytes 2h, 2h+1
    return packed::pack_bf16x2((float)(int8_t)(v >> (16 * half)),
                               (float)(int8_t)(v >> (16 * half + 8)));
}

// C columns of lane (g, t): tile nt's MMA columns 2t, 2t+1 are ccol + nt, ccol + NT + nt
template <int NT>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int ccol, const float (&v)[2 * NT]) {
    float4* o = reinterpret_cast<float4*>(dst + ccol);
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// ---- int4_sweep: bf16 route, m <= 16 ----------------------------------------------------

template <int VAR>
__global__ void __launch_bounds__(THREADS)
probe_int4_sweep_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ packed,
                        const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int m,
                        int k, int n, int steps_per_split, int steps) {
    constexpr int NT = 8, NW = NT / 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = (blockIdx.x * WARPS + warp) * 8 * NT;
    if (col0 >= n) return;
    const int kh = k / 2;
    const int step0 = blockIdx.z * steps_per_split;
    const int step1 = min(step0 + steps_per_split, steps);
    const int bcol = col0 + NT * g, ccol = col0 + 2 * NT * t;

    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

    uint32_t w[8][NW], wn[8][NW];
    if (step0 < step1) load_rows<NT>(packed, step0, t, n, bcol, w);
    for (int step = step0; step < step1; ++step) {
        if (step + 1 < step1) load_rows<NT>(packed, step + 1, t, n, bcol, wn);
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {  // low nibble: rows step*32.., high: kh + step*32..
            const int kr = j * kh + step * 32;
            uint32_t a[2][4];
            {
                const int rb = g + 8;
                uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = make_uint4(0u, 0u, 0u, 0u);
                if (g < m) va = __ldg(reinterpret_cast<const uint4*>(x + (size_t)g * k + kr + 8 * t));
                if (rb < m) vb = __ldg(reinterpret_cast<const uint4*>(x + (size_t)rb * k + kr + 8 * t));
                a[0][0] = va.x; a[0][1] = vb.x; a[0][2] = va.y; a[0][3] = vb.y;
                a[1][0] = va.z; a[1][1] = vb.z; a[1][2] = va.w; a[1][3] = vb.w;
            }
            const __nv_bfloat16* srow = scales + (size_t)(kr >> 5) * n;
            float sc[NT];
            packed::load_bf16<NT>(srow + bcol, sc);
            uint32_t m4[NW][8];  // bitcast family: the plane's four nibbles of a word at once
            if constexpr (VAR != I32) {
#pragma unroll
                for (int r = 0; r < NW; ++r)
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        m4[r][i] = (j == 0 ? w[i][r] : w[i][r] >> 4) & 0x0F0F0F0Fu;
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                float f[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    int c;
                    if constexpr (VAR == I32) {
                        const int b = (int)((w[i][nt / 4] >> (8 * (nt % 4))) & 0xFFu);
                        c = (j == 0 ? b & 15 : b >> 4) - 8;
                    } else {
                        const int u = (int)((m4[nt / 4][i] >> (8 * (nt % 4))) & 0xFFu);
                        c = VAR == BITCAST ? u - 8 : VAR == XORC ? u ^ 8 : u;
                    }
                    f[i] = (float)c * sc[nt];  // exact in f32, rounded once to bf16 below
                }
                const uint32_t b0[2] = {packed::pack_bf16x2(f[0], f[1]), packed::pack_bf16x2(f[2], f[3])};
                const uint32_t b1[2] = {packed::pack_bf16x2(f[4], f[5]), packed::pack_bf16x2(f[6], f[7])};
                packed::mma_bf16(acc[nt], a[0], b0);
                packed::mma_bf16(acc[nt], a[1], b1);
            }
            if constexpr (VAR == MXUFIX) {
                // -8 * (group sum of x) * scale, the sums from the tensor cores
                const uint32_t ones[2] = {0x3F803F80u, 0x3F803F80u};
                float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                packed::mma_bf16(cs, a[0], ones);
                packed::mma_bf16(cs, a[1], ones);
                float scc[2 * NT];
                packed::load_bf16<2 * NT>(srow + ccol, scc);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    acc[nt][0] = fmaf(-8.0f * cs[0], scc[nt], acc[nt][0]);
                    acc[nt][1] = fmaf(-8.0f * cs[1], scc[NT + nt], acc[nt][1]);
                    acc[nt][2] = fmaf(-8.0f * cs[2], scc[nt], acc[nt][2]);
                    acc[nt][3] = fmaf(-8.0f * cs[3], scc[NT + nt], acc[nt][3]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < NW; ++r) w[i][r] = wn[i][r];
    }

    float* dst = out + (size_t)blockIdx.z * m * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
        if (row >= m) continue;
        float v[2 * NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) { v[nt] = acc[nt][2 * h]; v[NT + nt] = acc[nt][2 * h + 1]; }
        store_row<NT>(dst + (size_t)row * n, ccol, v);
    }
}

// ---- a8_ablate: 16 rows of int8 x per 512-row block ---------------------------------------

template <int STAGE>
__global__ void __launch_bounds__(THREADS)
probe_a8_ablate_kernel(const int8_t* __restrict__ xl, const uint32_t* __restrict__ packed,
                       const __nv_bfloat16* __restrict__ scales, float* __restrict__ out,
                       uint32_t* __restrict__ sink, int n, int bkh, int steps_per_split,
                       int steps) {
    constexpr int NT = 8, NW = NT / 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = (blockIdx.x * WARPS + warp) * 8 * NT;
    if (col0 >= n) return;
    const int step0 = blockIdx.z * steps_per_split;
    const int step1 = min(step0 + steps_per_split, steps);
    const int bcol = col0 + NT * g, ccol = col0 + 2 * NT * t;
    constexpr bool FIRST_ROW = STAGE == CONVONLY || STAGE == EXTRACT;

    int d[NT][4];          // int8 products (dot, dotpar, dot2, fix)
    float fa[NT][4];       // f32 sums (dotbf, fix)
    float first[NT];       // first-row sums, B columns bcol.. (convonly, extract)
    uint32_t kept = 0;     // everything else those two stages computed, XORed
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        first[nt] = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) { d[nt][e] = 0; fa[nt][e] = 0.0f; }
    }

    uint32_t w[8][NW], wn[8][NW];
    if (step0 < step1) load_rows<NT>(packed, step0, t, n, bcol, w);
    for (int step = step0; step < step1; ++step) {
        if (step + 1 < step1) load_rows<NT>(packed, step + 1, t, n, bcol, wn);
        const int kk = step * 32 / bkh, pl = step * 32 - kk * bkh;
        const int8_t* xb = xl + (size_t)kk * 16 * bkh;
        if constexpr (FIRST_ROW) {
#pragma unroll
            for (int r = 0; r < NW; ++r)
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const uint32_t v = STAGE == EXTRACT ? high_nibbles(w[i][r]) : w[i][r];
                    if constexpr (STAGE == CONVONLY)  // every byte to bf16, as B fragments
                        kept ^= bf16x2_of_s8(v, 0) ^ bf16x2_of_s8(v, 1);
                    else
                        kept ^= v;
                    if (pl == 0 && t == 0 && i == 0)
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            first[4 * r + c] += STAGE == EXTRACT ? (float)((v >> (8 * c)) & 0xFFu)
                                                                 : (float)(int8_t)(v >> (8 * c));
                }
        } else if constexpr (STAGE == DOTBF) {
            uint32_t a[2][4];
            {
                const uint2 va = __ldg(reinterpret_cast<const uint2*>(xb + (size_t)g * bkh + pl + 8 * t));
                const uint2 vb = __ldg(reinterpret_cast<const uint2*>(xb + (size_t)(g + 8) * bkh + pl + 8 * t));
                a[0][0] = bf16x2_of_s8(va.x, 0); a[0][1] = bf16x2_of_s8(vb.x, 0);
                a[0][2] = bf16x2_of_s8(va.x, 1); a[0][3] = bf16x2_of_s8(vb.x, 1);
                a[1][0] = bf16x2_of_s8(va.y, 0); a[1][1] = bf16x2_of_s8(vb.y, 0);
                a[1][2] = bf16x2_of_s8(va.y, 1); a[1][3] = bf16x2_of_s8(vb.y, 1);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                uint32_t b[2][2];
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        const int sh = 8 * (nt % 4);
                        b[h][p] = packed::pack_bf16x2((float)(int8_t)(w[4 * h + 2 * p][nt / 4] >> sh),
                                                      (float)(int8_t)(w[4 * h + 2 * p + 1][nt / 4] >> sh));
                    }
                packed::mma_bf16(fa[nt], a[0], b[0]);
                packed::mma_bf16(fa[nt], a[1], b[1]);
            }
        } else {
            uint32_t a[4];
            a_s8(xb, bkh, g, 16, pl + 8 * t, a);
            uint32_t b[NT][2];
            s8_frags<NT>(w, [](uint32_t v) { return v; }, b);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_s8_acc(d[nt], a, b[nt]);
            if constexpr (STAGE == DOT2) {
                s8_frags<NT>(w, [](uint32_t v) { return high_nibbles(v); }, b);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) mma_s8_acc(d[nt], a, b[nt]);
            }
            if constexpr (STAGE == FIX) {
                // at the end of a block (or of the split): row r times scale row kk*16 + r
                if (pl + 32 == bkh || step + 1 == step1) {
                    float s0[2 * NT], s1[2 * NT];
                    packed::load_bf16<2 * NT>(scales + (size_t)(kk * 16 + g) * n + ccol, s0);
                    packed::load_bf16<2 * NT>(scales + (size_t)(kk * 16 + g + 8) * n + ccol, s1);
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        fa[nt][0] = fmaf((float)d[nt][0], s0[nt], fa[nt][0]);
                        fa[nt][1] = fmaf((float)d[nt][1], s0[NT + nt], fa[nt][1]);
                        fa[nt][2] = fmaf((float)d[nt][2], s1[nt], fa[nt][2]);
                        fa[nt][3] = fmaf((float)d[nt][3], s1[NT + nt], fa[nt][3]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) d[nt][e] = 0;
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < NW; ++r) w[i][r] = wn[i][r];
    }

    float* dst = out + (size_t)blockIdx.z * n;
    if constexpr (FIRST_ROW) {
        kept = __reduce_xor_sync(0xFFFFFFFFu, kept);
        if (lane == 0) sink[((size_t)blockIdx.z * gridDim.x + blockIdx.x) * WARPS + warp] = kept;
        if (t == 0) {  // lanes of quarter 0 hold row 8t = 0 of every step: B columns bcol..
            float4* o = reinterpret_cast<float4*>(dst + bcol);
            o[0] = make_float4(first[0], first[1], first[2], first[3]);
            o[1] = make_float4(first[4], first[5], first[6], first[7]);
        }
    } else {
        // the sum over the 16 rows of each C column
        float v[2 * NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float s = (STAGE == DOTBF || STAGE == FIX) ? fa[nt][c] + fa[nt][c + 2]
                                                           : (float)d[nt][c] + (float)d[nt][c + 2];
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
                v[c * NT + nt] = s;
            }
        if (g == 0) store_row<NT>(dst, ccol, v);
    }
}

// ---- a8_diag: block-diagonal int8 x, one fix-up per output element ------------------------

template <bool RAW, int MT, int NT>
__global__ void __launch_bounds__(THREADS)
probe_a8_diag_kernel(const int8_t* __restrict__ x_lo, const int8_t* __restrict__ x_hi,
                     const uint32_t* __restrict__ packed, const __nv_bfloat16* __restrict__ scales,
                     float* __restrict__ out, int m, int kh, int n, int bkh, int steps_per_split,
                     int steps) {
    constexpr int NW = NT / 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = (blockIdx.x * WARPS + warp) * 8 * NT;
    if (col0 >= n) return;
    const int step0 = blockIdx.z * steps_per_split;
    const int step1 = min(step0 + steps_per_split, steps);
    const int bcol = col0 + NT * g, ccol = col0 + 2 * NT * t;
    const int ng = bkh / 32, gm = ng * m, nkb = kh / bkh;

    int dl[MT][NT][4], dh[MT][NT][4], dx[MT][NT][4];  // lo (raw) plane, hi plane, raw: lo x . hi
    int xs[2][MT][2];                                 // row sums of x_lo, x_hi: rows g, g + 8
    float o[NT][4];
    auto clear = [&]() {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) dl[mt][nt][e] = dh[mt][nt][e] = dx[mt][nt][e] = 0;
            xs[0][mt][0] = xs[0][mt][1] = xs[1][mt][0] = xs[1][mt][1] = 0;
        }
    };
    clear();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;

    uint32_t w[8][NW], wn[8][NW];
    if (step0 < step1) load_rows<NT>(packed, step0, t, n, bcol, w);
    for (int step = step0; step < step1; ++step) {
        if (step + 1 < step1) load_rows<NT>(packed, step + 1, t, n, bcol, wn);
        const int kk = step * 32 / bkh, pl = step * 32 - kk * bkh;
        uint32_t bl[NT][2], bh[NT][2];
        if constexpr (RAW) {
            s8_frags<NT>(w, [](uint32_t v) { return v; }, bl);
            s8_frags<NT>(w, [](uint32_t v) { return high_nibbles(v); }, bh);
        } else {
            s8_frags<NT>(w, [](uint32_t v) { return v & 0x0F0F0F0Fu; }, bl);
            s8_frags<NT>(w, [](uint32_t v) { return (v >> 4) & 0x0F0F0F0Fu; }, bh);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            uint32_t al[4], ah[4];
            const size_t base = ((size_t)kk * gm + mt * 16) * bkh;
            a_s8(x_lo + base, bkh, g, 16, pl + 8 * t, al);
            a_s8(x_hi + base, bkh, g, 16, pl + 8 * t, ah);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                xs[0][mt][h] = __dp4a((int)al[2 + h], 0x01010101, __dp4a((int)al[h], 0x01010101, xs[0][mt][h]));
                xs[1][mt][h] = __dp4a((int)ah[2 + h], 0x01010101, __dp4a((int)ah[h], 0x01010101, xs[1][mt][h]));
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                mma_s8_acc(dl[mt][nt], al, bl[nt]);
                mma_s8_acc(dh[mt][nt], ah, bh[nt]);
                if constexpr (RAW) mma_s8_acc(dx[mt][nt], al, bh[nt]);
            }
        }
        if (pl + 32 == bkh || step + 1 == step1) {
            // fix-up: row R = (group, mi) of block kk, (d - 8 * rowsum) * scale, over rows
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    int sl = xs[0][mt][h], sh = xs[1][mt][h];
                    sl += __shfl_xor_sync(0xFFFFFFFFu, sl, 1);
                    sl += __shfl_xor_sync(0xFFFFFFFFu, sl, 2);
                    sh += __shfl_xor_sync(0xFFFFFFFFu, sh, 1);
                    sh += __shfl_xor_sync(0xFFFFFFFFu, sh, 2);
                    const int grp = (mt * 16 + g + 8 * h) / m;
                    float s_lo[2 * NT], s_hi[2 * NT];
                    packed::load_bf16<2 * NT>(scales + (size_t)(kk * ng + grp) * n + ccol, s_lo);
                    packed::load_bf16<2 * NT>(scales + (size_t)((nkb + kk) * ng + grp) * n + ccol, s_hi);
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                        for (int c = 0; c < 2; ++c) {
                            const int e = 2 * h + c;
                            const int d_lo = RAW ? dl[mt][nt][e] - 16 * dx[mt][nt][e] + 128 * sl
                                                 : dl[mt][nt][e];
                            const float fl = (float)(d_lo - 8 * sl) * s_lo[c * NT + nt];
                            const float fh = (float)(dh[mt][nt][e] - 8 * sh) * s_hi[c * NT + nt];
                            o[nt][c] += fl + fh;  // output row (g + 8h) % m = g % m: m | 8
                        }
                }
            clear();
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < NW; ++r) w[i][r] = wn[i][r];
    }

    // the rows of one output row are the lanes whose g agrees mod m
    float v[2 * NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float s = o[nt][c];
            for (int x = 4 * m; x < 32; x <<= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, x);
            v[c * NT + nt] = s;
        }
    if (g < m) store_row<NT>(out + (size_t)blockIdx.z * m * n + (size_t)g * n, ccol, v);
}

// ---- launches -----------------------------------------------------------------------------

int reduce(const void* ws, void* y, int m, int n, int splits, cudaStream_t st) {
    int err = (int)cudaGetLastError();
    if (err != 0 || splits == 1) return err;
    const size_t total4 = (size_t)m * n / 4;
    packed::splitk_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float4*>(ws), nullptr, static_cast<float4*>(y), m, n, splits);
    return (int)cudaGetLastError();
}

bool bad_splits(int steps, int splits) {
    if (splits < 1 || splits > steps) return true;
    const int per = (steps + splits - 1) / splits;
    return (splits - 1) * per >= steps;
}

template <int VAR>
int sweep(const void* x, const void* pk, const void* sc, void* y, void* ws, int m, int k, int n,
          int splits, cudaStream_t st) {
    const int steps = k / 64, per = (steps + splits - 1) / splits;
    dim3 grid(n / (WARPS * 64), 1, splits);
    probe_int4_sweep_kernel<VAR><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(pk),
        static_cast<const __nv_bfloat16*>(sc), static_cast<float*>(splits > 1 ? ws : y), m, k, n,
        per, steps);
    return reduce(ws, y, m, n, splits, st);
}

template <int STAGE>
int ablate(const void* xl, const void* pk, const void* sc, void* y, void* ws, void* sink, int kh,
           int n, int bkh, int splits, cudaStream_t st) {
    const int steps = kh / 32, per = (steps + splits - 1) / splits;
    dim3 grid(n / (WARPS * 64), 1, splits);
    probe_a8_ablate_kernel<STAGE><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(xl), static_cast<const uint32_t*>(pk),
        static_cast<const __nv_bfloat16*>(sc), static_cast<float*>(splits > 1 ? ws : y),
        static_cast<uint32_t*>(sink), n, bkh, per, steps);
    return reduce(ws, y, 1, n, splits, st);
}

template <bool RAW, int MT, int NT>
int diag(const void* xl, const void* xh, const void* pk, const void* sc, void* y, void* ws, int m,
         int kh, int n, int bkh, int splits, cudaStream_t st) {
    const int steps = kh / 32, per = (steps + splits - 1) / splits;
    dim3 grid(n / (WARPS * 8 * NT), 1, splits);
    probe_a8_diag_kernel<RAW, MT, NT><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(xl), static_cast<const int8_t*>(xh),
        static_cast<const uint32_t*>(pk), static_cast<const __nv_bfloat16*>(sc),
        static_cast<float*>(splits > 1 ? ws : y), m, kh, n, bkh, per, steps);
    return reduce(ws, y, m, n, splits, st);
}

template <bool RAW>
int diag_rows(int gm, const void* xl, const void* xh, const void* pk, const void* sc, void* y,
              void* ws, int m, int kh, int n, int bkh, int splits, cudaStream_t st) {
    switch (gm) {
        case 16: return diag<RAW, 1, 8>(xl, xh, pk, sc, y, ws, m, kh, n, bkh, splits, st);
        case 32: return diag<RAW, 2, 4>(xl, xh, pk, sc, y, ws, m, kh, n, bkh, splits, st);
        case 64: return diag<RAW, 4, 4>(xl, xh, pk, sc, y, ws, m, kh, n, bkh, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (m, k) bf16, m <= 16; k % 64 == 0; n % 256 == 0; `var` indexes
// probes/int4_sweep.py's VARIANTS.
extern "C" int exl3_probe_int4_sweep(const void* x, const void* packed, const void* scales,
                                     void* y, void* ws, int m, int k, int n, int var, int splits,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || m > 16 || k % 64 || n % 256 || bad_splits(k / 64, splits))
        return (int)cudaErrorInvalidValue;
    switch (var) {
        case I32: return sweep<I32>(x, packed, scales, y, ws, m, k, n, splits, st);
        case BITCAST: return sweep<BITCAST>(x, packed, scales, y, ws, m, k, n, splits, st);
        case MXUFIX: return sweep<MXUFIX>(x, packed, scales, y, ws, m, k, n, splits, st);
        case XORC: return sweep<XORC>(x, packed, scales, y, ws, m, k, n, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}

// xl (kh/bkh, 16, bkh) int8, packed (kh, n) int8, scales (kh/32, n) bf16 (the
// first kh/32 rows: scales3); bkh % 32 == 0, n % 256 == 0; `stage` indexes
// probes/a8_ablate.py's STAGES; sink holds a word a warp, n / 64 * splits.
extern "C" int exl3_probe_a8_ablate(const void* xl, const void* packed, const void* scales,
                                    void* y, void* ws, void* sink, int kh, int n, int bkh,
                                    int stage, int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kh % bkh || bkh % 32 || n % 256 || bad_splits(kh / 32, splits))
        return (int)cudaErrorInvalidValue;
#define EXL3_ABLATE(S) ablate<S>(xl, packed, scales, y, ws, sink, kh, n, bkh, splits, st)
    switch (stage) {
        case DOTPAR: return EXL3_ABLATE(DOTPAR);
        case DOT: return EXL3_ABLATE(DOT);
        case DOTBF: return EXL3_ABLATE(DOTBF);
        case CONVONLY: return EXL3_ABLATE(CONVONLY);
        case DOT2: return EXL3_ABLATE(DOT2);
        case EXTRACT: return EXL3_ABLATE(EXTRACT);
        case FIX: return EXL3_ABLATE(FIX);
    }
#undef EXL3_ABLATE
    return (int)cudaErrorInvalidValue;
}

// x_lo, x_hi (kh/bkh, ng*m, bkh) int8 with ng = bkh/32, ng*m in {16, 32, 64},
// m in {1, 2, 4}; packed (kh, n) int8 (top bits flipped for raw); scales
// (kh/16, n) bf16; n % 256 == 0.
extern "C" int exl3_probe_a8_diag(const void* x_lo, const void* x_hi, const void* packed,
                                  const void* scales, void* y, void* ws, int m, int kh, int n,
                                  int bkh, int raw, int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int gm = bkh / 32 * m;
    if ((m != 1 && m != 2 && m != 4) || bkh % 32 || kh % bkh || n % 256
        || bad_splits(kh / 32, splits))
        return (int)cudaErrorInvalidValue;
    return raw ? diag_rows<true>(gm, x_lo, x_hi, packed, scales, y, ws, m, kh, n, bkh, splits, st)
               : diag_rows<false>(gm, x_lo, x_hi, packed, scales, y, ws, m, kh, n, bkh, splits, st);
}
