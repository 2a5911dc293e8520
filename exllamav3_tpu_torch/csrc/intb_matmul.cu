// Packed int-B matmul for Hopper (B = 3, 4, 5, 6): y (m, n) f32 = x (m, k) @ W,
// where `packed` (kp, n) int32 holds W = 32 / B codes a word, plane-major
// (weight row r is code r / kp of word r % kp, biased by 2^(B-1)), k padded
// with zero rows to W * kp, and `scales` (W * kp / 32, n) bf16 holds one scale
// per 32 rows and column. Serves the int3 / int5 / int6 load-time tiers and
// the conversion-time `.sq` tensors (B = 4 too).
//
// Replaces: exllamav3_tpu/ops/q_matmul.py::_intb_matmul_kernel
//           (intb_matmul_pallas) -> exl3_intb_matmul, weights as
//           bf16(code * scale) into bf16 MMAs;
//           exllamav3_tpu/ops/q_matmul.py::_intb_a8_kernel
//           (intb_matmul_pallas_a8) -> exl3_intb_matmul_a8, int8 rows of x
//           (the row quantizer: max|x| / 127 + 1e-12, IEEE division, round
//           half to even, +-127) times the codes in int8 MMAs, one exact int32
//           dot per 32-row group, times the group's scale in f32, the row's
//           scale applied last.
// Bound:    at decode (4 / W + 1 / 16) bytes a weight over 3.35 TB/s; at
//           prefill the tensor-core rate, 989 TFLOP/s bf16 or 1,979 TOP/s int8.
// Design:   up to INTB_DECODE_ROWS rows (decode), the staged body below; more
//           rows take the 64-row tiling of csrc/packed_matmul.cuh, which the
//           int4 tier shares (x read through L1, a split-k reduce kernel),
//           launched from here after the row quantizer, whose kernel
//           (packed_matmul.cuh's quantize_rows_dependents) the int4 a8 route's
//           staged body shares.
//
//           The staged body. A block of INTB_WARPS warps owns 128 output
//           columns, a warp 32 of them, and a run of k steps (32 packed rows
//           each, every plane of them). Each warp copies its own columns'
//           words and group scales of a step into shared memory with
//           cp.async, INTB_STAGES steps deep, and waits for its own copies
//           alone: no block barrier in the k loop, no read of device memory
//           in the plane loop. The block's x for its steps, every plane, is
//           staged once (int8 rows after the quantizer on the a8 route, with
//           each group's row sums, or bf16). The weights are the MMAs' A
//           operand (16 columns a tile) and x the B operand (8 rows), so at
//           m <= 8 no half of an MMA is padding: lane (g, t) owns columns
//           4g .. 4g + 3 of its warp's 32 and packed rows 8t .. 8t + 7 of a
//           step; MMA row g of tile tt is column 4g + 2tt, row g + 8 column
//           4g + 2tt + 1, and MMA k index i of lane quarter t is packed row
//           8t + i (k order is free where A and B agree). A plane's codes
//           come out of a lane's words by byte permutes (two words' bytes
//           holding the field side by side, one shift, one mask). On the a8
//           route the codes enter the MMA unbiased (0 .. 2^B - 1, valid s8)
//           and the bias comes off the exact int32 result as 2^(B-1) times
//           the group's row sum of x; on the bf16 route a code becomes the
//           bf16 value 128 + code by its bits, and two bf16x2 FMAs (exact,
//           then one rounding) give bf16(code_centered * scale). k is split
//           across blocks in runs of steps whose lengths differ by at most
//           one, sized on the host from the card's SM count
//           (ops/q_matmul.py::intb_split_count); each split writes its
//           partial sums and the last warp of a 32-column tile to arrive
//           adds them in split order and applies the a8 row scale, so one
//           launch does the product. On the a8 route the product is launched as a
//           programmatic dependent of the quantizer: it stages its first
//           words before it waits for the quantizer's rows. The limits and
//           the shared-memory layout are in csrc/intb_layout.cuh.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "intb_layout.cuh"
#include "packed_matmul.cuh"

// int-B kernel launches in this library, counted where they are made, for a
// caller that checks which kernels a product took (read through
// exl3_intb_launches): products, row quantizers, split-k reduce kernels
static int intb_launch_count[3] = {0, 0, 0};

namespace {

constexpr int THREADS = INTB_WARPS * 32;
constexpr int BN = INTB_WARPS * 32;    // output columns a block

// the 16-byte unit of a staged word row that holds columns 4c .. 4c + 3: row
// r's units are permuted so that the four rows 8t + i a lane quarter reads
// at once lie on four different bank groups
__device__ __forceinline__ int word_unit(int r, int c) { return c ^ (((r >> 3) & 3) << 1); }

// PRMT selector that puts bytes p, p + 1 of a beside bytes p, p + 1 of b (the
// 16 bits holding the field that starts in byte p)
__device__ __forceinline__ constexpr uint32_t pair_sel(int p) {
    return p | ((p < 3 ? p + 1 : 3) << 4) | ((4 + p) << 8) | ((p < 3 ? p + 5 : 7) << 12);
}

// a8: field j (bits B*j) of four words (rows r0 .. r3 of one column) as four
// unsigned int8 codes, r0 in the low byte
template <int BITS>
__device__ __forceinline__ uint32_t codes4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           int j) {
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    const int sh = BITS * j, s = sh & 7;
    const uint32_t q02 = __byte_perm(w0, w2, pair_sel(sh >> 3));
    const uint32_t q13 = __byte_perm(w1, w3, pair_sel(sh >> 3));
    return __byte_perm(q02 >> s, q13 << (8 - s), 0x7250) & (0x01010101u * MASK);
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// bf16: field j of two words (rows ra, rb of one column) as the bf16x2 pair
// bf16((code - 2^(B-1)) * scale), ra low; s2 holds the column's scale twice
template <int BITS>
__device__ __forceinline__ uint32_t weights2(uint32_t wa, uint32_t wb, int j, uint32_t s2) {
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    constexpr uint32_t NEG_OFFSET = 0xC300u | (1u << (BITS - 1));  // bf16 -(128 + 2^(B-1))
    const int sh = BITS * j;
    // 0x4300 | code is the bf16 value 128 + code, exactly
    const uint32_t v = ((__byte_perm(wa, wb, pair_sel(sh >> 3)) >> (sh & 7)) & (MASK * 0x00010001u))
                       | 0x43004300u;
    const uint32_t c = fma_bf16x2(v, 0x3F803F80u, NEG_OFFSET * 0x00010001u);  // code - 2^(B-1), exact
    return fma_bf16x2(c, s2, 0x80008000u);  // times the scale, one rounding
}

constexpr int MAGIC_I = 0x4B400000;   // the float 1.5 * 2^23: its bits plus v are 1.5 * 2^23 + v
constexpr float MAGIC_F = 12582912.0f;  // for |v| < 2^22

// Grid (ceil(n / BN), splits). Split s takes the steps [s * steps / splits,
// (s + 1) * steps / splits), at most `per` of them. NR: 8-row tiles of x (1
// for m <= 8, else 2). xs: the a8 row scales (null on the bf16 route).
template <int BITS, bool A8, int NR>
__global__ void __launch_bounds__(THREADS, INTB_BLOCKS)
intb_decode_kernel(const void* __restrict__ xv, const uint32_t* __restrict__ words,
                   const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, float* ws,
                   int* counters, const float* __restrict__ xs, int m, int k, int n, int kp,
                   int per) {
    constexpr int W = 32 / BITS;
    constexpr int BIAS = 1 << (BITS - 1);
    constexpr int ES = A8 ? 1 : 2;  // bytes of an element of x
    constexpr int WST = 32 * 32;    // words of a warp's stage
    constexpr int SST = W * 32;     // scales of a warp's stage
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * BN;
    const int col0 = n0 + warp * 32;
    const bool live = col0 < n;  // n % 32 == 0: a warp's columns are all in or all out
    const int splits = gridDim.y, split = blockIdx.y;
    const int steps = kp / 32;
    const int step0 = (int)((long long)split * steps / splits);
    const int nst = (int)((long long)(split + 1) * steps / splits) - step0;
    const int xld = intb_x_ld(W, per, A8);
    uint32_t* Ws = reinterpret_cast<uint32_t*>(smem) + warp * INTB_STAGES * WST;
    __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(smem + INTB_WARPS * INTB_STAGES * WST * 4) +
                        warp * INTB_STAGES * SST;
    unsigned char* Xs = smem + INTB_WARPS * INTB_STAGES * intb_stage_bytes(W);
    int* Sx = reinterpret_cast<int*>(Xs + NR * 8 * xld);

    // step i of the block into the warp's stage i % INTB_STAGES: its 32 rows
    // of the warp's 32 columns, and the W group scales of those columns; a
    // group is committed in every call, so the waits stay in step
    auto issue = [&](int i) {
        if (live && i < nst) {
            const int step = step0 + i;
            uint32_t* dw = Ws + (i % INTB_STAGES) * WST;
            const uint32_t* sw = words + (size_t)step * 32 * n + col0;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int r = (lane >> 3) + 4 * u, c = lane & 7;
                cp_async<16>(dw + r * 32 + word_unit(r, c) * 4, sw + (size_t)r * n + 4 * c);
            }
            __nv_bfloat16* ds = Ss + (i % INTB_STAGES) * SST;
            for (int e = lane; e < W * 4; e += 32) {
                const int j = e >> 2, q = e & 3;
                cp_async<16>(ds + j * 32 + 8 * q,
                             scales + ((size_t)j * steps + step) * n + col0 + 8 * q);
            }
        }
        cp_async_commit();
    };
    // the first step's words, then x of the block's steps in every plane,
    // once (on the a8 route after the quantizer has written it: the launch
    // may start while it runs); the steps behind them are asked for once
    // they have landed, so that the card's first burst of copies is the
    // first steps alone and the k loop starts as soon as they are in
    issue(0);
    if constexpr (A8) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    {
        // a row's steps of one plane are one run of 16-byte units, in x and
        // in the stage alike
        const unsigned char* xg = static_cast<const unsigned char*>(xv);
        const int run = nst * 2 * ES;  // 16-byte units of a run
        for (int e = tid; e < m * W * run; e += THREADS) {
            const int u = e % run, rj = e / run;
            const int r = rj / W, j = rj % W;
            const int kr = j * kp + step0 * 32 + u / (2 * ES) * 32;
            if (kr < k)  // the pad rows of the last plane are never read
                cp_async<16>(Xs + r * xld + j * per * 32 * ES + u * 16,
                             xg + ((size_t)r * k + j * kp + step0 * 32) * ES + u * 16);
        }
        cp_async_commit();
        // rows past m that the fragments read are zero
        for (int e = tid; e < (NR * 8 - m) * xld / 16; e += THREADS)
            reinterpret_cast<uint4*>(Xs + m * xld)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 1; i < INTB_STAGES - 1; ++i) issue(i);
    if constexpr (A8) {  // each group's sum of x over its 32 k, by row
        for (int e = tid; e < W * per * NR * 8; e += THREADS) {
            const int r = e % (NR * 8), gi = e / (NR * 8);  // group j * per + i
            const uint4* p = reinterpret_cast<const uint4*>(Xs + r * xld + gi * 32);
            const uint4 a = p[0], b = p[1];
            int s = __dp4a((int)a.x, 0x01010101, 0);
            s = __dp4a((int)a.y, 0x01010101, s);
            s = __dp4a((int)a.z, 0x01010101, s);
            s = __dp4a((int)a.w, 0x01010101, s);
            s = __dp4a((int)b.x, 0x01010101, s);
            s = __dp4a((int)b.y, 0x01010101, s);
            s = __dp4a((int)b.z, 0x01010101, s);
            s = __dp4a((int)b.w, 0x01010101, s);
            Sx[gi * (INTB_X_SUMS / 4) + r] = s;
        }
        __syncthreads();
    }

    // acc[rt][tt]: columns 4g + 2tt (e 0, 1) and 4g + 2tt + 1 (e 2, 3), rows
    // 8rt + 2t (e 0, 2) and 8rt + 2t + 1 (e 1, 3)
    float acc[NR][2][4];
#pragma unroll
    for (int rt = 0; rt < NR; ++rt)
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rt][tt][e] = 0.0f;

    for (int i = 0; i < nst; ++i) {
        cp_async_wait<INTB_STAGES - 2>();  // step i has landed, and this warp is
        __syncwarp();                      // done with the stage it overwrites
        issue(i + INTB_STAGES - 1);
        if (!live) continue;
        const uint32_t* wt = Ws + (i % INTB_STAGES) * WST;
        const __nv_bfloat16* st = Ss + (i % INTB_STAGES) * SST;
        uint32_t w[8][4];  // packed rows 8t .. 8t + 7 of columns 4g .. 4g + 3
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const uint4 v = *reinterpret_cast<const uint4*>(wt + (8 * t + r) * 32 +
                                                            word_unit(8 * t + r, g) * 4);
            w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;
        }
        const int step = step0 + i;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            if (j * kp + step * 32 >= k) break;  // pad rows of the last plane
            const int gi = j * per + i;
            const uint2 sv = *reinterpret_cast<const uint2*>(st + j * 32 + 4 * g);
            if constexpr (A8) {
                uint2 xb[NR];
                int2 sx[NR];
#pragma unroll
                for (int rt = 0; rt < NR; ++rt) {
                    xb[rt] = *reinterpret_cast<const uint2*>(Xs + (8 * rt + g) * xld + gi * 32 + 8 * t);
                    sx[rt] = *reinterpret_cast<const int2*>(Sx + gi * (INTB_X_SUMS / 4) + 8 * rt + 2 * t);
                }
                const float sc[4] = {__uint_as_float(sv.x << 16), __uint_as_float(sv.x & 0xFFFF0000u),
                                     __uint_as_float(sv.y << 16), __uint_as_float(sv.y & 0xFFFF0000u)};
#pragma unroll
                for (int tt = 0; tt < 2; ++tt) {
                    const uint32_t a[4] = {
                        codes4<BITS>(w[0][2 * tt], w[1][2 * tt], w[2][2 * tt], w[3][2 * tt], j),
                        codes4<BITS>(w[0][2 * tt + 1], w[1][2 * tt + 1], w[2][2 * tt + 1],
                                     w[3][2 * tt + 1], j),
                        codes4<BITS>(w[4][2 * tt], w[5][2 * tt], w[6][2 * tt], w[7][2 * tt], j),
                        codes4<BITS>(w[4][2 * tt + 1], w[5][2 * tt + 1], w[6][2 * tt + 1],
                                     w[7][2 * tt + 1], j)};
#pragma unroll
                    for (int rt = 0; rt < NR; ++rt) {
                        const uint32_t b[2] = {xb[rt].x, xb[rt].y};
                        int d[4];
                        packed::mma_s8(d, a, b);
                        // the exact dot of the centred codes, as a float
                        const int k0 = MAGIC_I - BIAS * sx[rt].x, k1 = MAGIC_I - BIAS * sx[rt].y;
                        acc[rt][tt][0] = fmaf(__int_as_float(d[0] + k0) - MAGIC_F, sc[2 * tt], acc[rt][tt][0]);
                        acc[rt][tt][1] = fmaf(__int_as_float(d[1] + k1) - MAGIC_F, sc[2 * tt], acc[rt][tt][1]);
                        acc[rt][tt][2] = fmaf(__int_as_float(d[2] + k0) - MAGIC_F, sc[2 * tt + 1], acc[rt][tt][2]);
                        acc[rt][tt][3] = fmaf(__int_as_float(d[3] + k1) - MAGIC_F, sc[2 * tt + 1], acc[rt][tt][3]);
                    }
                }
            } else {
                uint4 xb[NR];
#pragma unroll
                for (int rt = 0; rt < NR; ++rt)
                    xb[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + gi * 64 + 16 * t);
                const uint32_t s2[4] = {__byte_perm(sv.x, 0u, 0x1010), __byte_perm(sv.x, 0u, 0x3232),
                                        __byte_perm(sv.y, 0u, 0x1010), __byte_perm(sv.y, 0u, 0x3232)};
#pragma unroll
                for (int tt = 0; tt < 2; ++tt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {  // packed rows 8t + 4h .. 8t + 4h + 3
                        const int c0 = 2 * tt, c1 = 2 * tt + 1;
                        const uint32_t a[4] = {
                            weights2<BITS>(w[4 * h][c0], w[4 * h + 1][c0], j, s2[c0]),
                            weights2<BITS>(w[4 * h][c1], w[4 * h + 1][c1], j, s2[c1]),
                            weights2<BITS>(w[4 * h + 2][c0], w[4 * h + 3][c0], j, s2[c0]),
                            weights2<BITS>(w[4 * h + 2][c1], w[4 * h + 3][c1], j, s2[c1])};
#pragma unroll
                        for (int rt = 0; rt < NR; ++rt) {
                            const uint32_t b[2] = {h ? xb[rt].z : xb[rt].x, h ? xb[rt].w : xb[rt].y};
                            packed::mma_bf16(acc[rt][tt], a, b);
                        }
                    }
            }
        }
    }

    // this lane's outputs: rows 8rt + 2t + h, columns col0 + 4g .. + 3. With
    // one split the row scale of the a8 route is applied here
    float* dst = splits == 1 ? out : ws + (size_t)split * m * n;
    if (live) {
#pragma unroll
        for (int rt = 0; rt < NR; ++rt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 8 * rt + 2 * t + h;
                if (row >= m) continue;
                const float rs = A8 && splits == 1 ? xs[row] : 1.0f;
                *reinterpret_cast<float4*>(dst + (size_t)row * n + col0 + 4 * g) =
                    make_float4(acc[rt][0][h] * rs, acc[rt][0][2 + h] * rs, acc[rt][1][h] * rs,
                                acc[rt][1][2 + h] * rs);
            }
    }
    if (splits == 1) return;

    // the last split of this warp's 32 columns to arrive adds the partials
    // in split order, times the a8 row scale, and writes them: each warp
    // arrives for itself (its lanes' writes ordered before lane 0's arrival,
    // and lane 0's acquire before its lanes' reads, by warp barriers, as
    // block barriers order them around arrive() elsewhere), so no warp
    // waits for the block's slowest. A lane takes two float4 runs a step of
    // 16 rows, and its loads from eight splits of both are in flight at once
    if (!live) return;
    __syncwarp();
    const int tile = col0 / 32;
    int last = 0;
    if (lane == 0) last = arrive(counters + tile) == splits - 1;
    last = __shfl_sync(0xFFFFFFFFu, last, 0);
    if (!last) return;
    __syncwarp();
    const size_t plane = (size_t)m * n;
    for (int e0 = lane; e0 < m * 8; e0 += 64) {  // run e: row e / 8, columns 4 (e % 8) ..
        size_t at[2];
        float4 s[2];
        float rs[2];  // the a8 row scales, asked for with the partials
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            const int e = min(e0 + 32 * v, m * 8 - 1);  // a spare run repeats the last
            at[v] = (size_t)(e / 8) * n + col0 + (e % 8) * 4;
            s[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            rs[v] = A8 ? xs[e / 8] : 1.0f;
        }
        for (int sp = 0; sp < splits; sp += 8) {
            float4 p[2][8];
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int u = 0; u < 8; ++u)
                    if (sp + u < splits)
                        p[v][u] = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)(sp + u) * plane + at[v]));
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int u = 0; u < 8; ++u)
                    if (sp + u < splits) {
                        s[v].x += p[v][u].x;
                        s[v].y += p[v][u].y;
                        s[v].z += p[v][u].z;
                        s[v].w += p[v][u].w;
                    }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            if (e0 + 32 * v >= m * 8) continue;
            *reinterpret_cast<float4*>(out + at[v]) =
                make_float4(s[v].x * rs[v], s[v].y * rs[v], s[v].z * rs[v], s[v].w * rs[v]);
        }
    }
    if (lane == 0) counters[tile] = 0;  // ready for the next launch
}

template <int BITS, bool A8, int NR>
int prepare() {  // the largest shared memory a launch of this body may ask for
    static int err = -1;
    if (err != 0)
        err = (int)cudaFuncSetAttribute(intb_decode_kernel<BITS, A8, NR>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, INTB_MAX_SMEM);
    return err;
}

// the a8 route's first kernel: x (f32 or bf16) into xq, xs
int quantize(const void* x, void* xq, void* xs, int x_is_bf16, int m, int k, cudaStream_t st) {
    if (x_is_bf16)
        packed::quantize_rows_dependents<<<m, packed::QUANT_THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs),
            k);
    else
        packed::quantize_rows_dependents<<<m, packed::QUANT_THREADS, 0, st>>>(
            static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), k);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++intb_launch_count[1];
    return err;
}

template <int BITS, bool A8, int NR>
int launch_decode(const void* x, const void* packed, const void* scales, void* y, void* ws,
                  void* counters, void* xq, void* xs, int x_is_bf16, int m, int k, int n, int kp,
                  int splits, cudaStream_t st) {
    const int smem = intb_decode_smem(BITS, A8, m, kp, splits);
    if (smem == 0 || (splits > 1 && (ws == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (const int err = prepare<BITS, A8, NR>()) return err;
    const void* xin = x;
    if constexpr (A8) {
        if (const int err = quantize(x, xq, xs, x_is_bf16, m, k, st)) return err;
        xin = xq;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + BN - 1) / BN, splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    if (A8) {  // a programmatic dependent of the quantizer
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    int err = (int)cudaLaunchKernelEx(
        &cfg, intb_decode_kernel<BITS, A8, NR>, xin, static_cast<const uint32_t*>(packed),
        static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(y), static_cast<float*>(ws),
        static_cast<int*>(counters), A8 ? static_cast<const float*>(xs) : nullptr, m, k, n, kp,
        (kp / 32 + splits - 1) / splits);
    if (err == 0) err = (int)cudaGetLastError();
    if (err == 0) ++intb_launch_count[0];
    return err;
}

// more than INTB_DECODE_ROWS rows: packed_matmul.cuh's tiling of 64 rows and
// 128 columns a block, k in `splits` runs of `per` steps, the partial sums
// added by its split-k reduce kernel in split order (the a8 row scale there,
// or in the product for one split)
template <int BITS, bool A8>
int launch_tiled(const void* x, const void* packed, const void* scales, void* y, void* ws,
                 void* xq, void* xs, int x_is_bf16, int m, int k, int n, int kp, int splits,
                 cudaStream_t st) {
    const int steps = kp / 32;
    if (splits < 1 || splits > steps || (splits > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;
    const int per = (steps + splits - 1) / splits;
    if ((splits - 1) * per >= steps) return (int)cudaErrorInvalidValue;
    const void* xin = x;
    if constexpr (A8) {
        if (const int err = quantize(x, xq, xs, x_is_bf16, m, k, st)) return err;
        xin = xq;
    }
    const float* row_scale = A8 ? static_cast<const float*>(xs) : nullptr;
    constexpr int TN = packed::WARPS * 32;  // a block's columns
    const dim3 grid((n + TN - 1) / TN, (m + 63) / 64, splits);
    packed::packed_matmul_kernel<BITS, A8, 4, 4><<<grid, packed::THREADS, 0, st>>>(
        xin, static_cast<const uint32_t*>(packed), static_cast<const __nv_bfloat16*>(scales),
        static_cast<float*>(splits > 1 ? ws : y), splits > 1 ? nullptr : row_scale, m, k, n, kp,
        per, steps);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++intb_launch_count[0];
    if (splits == 1) return 0;
    const size_t total4 = (size_t)m * n / 4;
    packed::splitk_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float4*>(ws), row_scale, static_cast<float4*>(y), m, n, splits);
    err = (int)cudaGetLastError();
    if (err == 0) ++intb_launch_count[2];
    return err;
}

template <int BITS, bool A8>
int launch(const void* x, const void* packed, const void* scales, void* y, void* ws, void* counters,
           void* xq, void* xs, int x_is_bf16, int m, int k, int n, int kp, int splits,
           cudaStream_t st) {
    if (m > INTB_DECODE_ROWS)
        return launch_tiled<BITS, A8>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, kp,
                                      splits, st);
    return m <= 8 ? launch_decode<BITS, A8, 1>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16,
                                               m, k, n, kp, splits, st)
                  : launch_decode<BITS, A8, 2>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16,
                                               m, k, n, kp, splits, st);
}

template <bool A8>
int launch_bits(int bits, const void* x, const void* packed, const void* scales, void* y, void* ws,
                void* counters, void* xq, void* xs, int x_is_bf16, int m, int k, int n, int kp,
                int splits, cudaStream_t st) {
    if (bits < 3 || bits > 6) return (int)cudaErrorInvalidValue;
    const int W = 32 / bits;
    if (m < 1 || k % 32 || n % 32 || kp % 32 || (long long)W * kp < k ||
        (long long)W * (kp - 32) >= k)
        return (int)cudaErrorInvalidValue;
    switch (bits) {
        case 3: return launch<3, A8>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
        case 4: return launch<4, A8>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
        case 5: return launch<5, A8>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
        default: return launch<6, A8>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
    }
}

template <int BITS, bool A8, int NR>
int occupancy(int smem) {
    if (const int err = prepare<BITS, A8, NR>()) return -err;
    int blocks = 0;
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, intb_decode_kernel<BITS, A8, NR>, THREADS, smem);
    return err ? -err : blocks;
}

template <bool A8, int NR>
int occupancy_bits(int bits, int smem) {
    switch (bits) {
        case 3: return occupancy<3, A8, NR>(smem);
        case 4: return occupancy<4, A8, NR>(smem);
        case 5: return occupancy<5, A8, NR>(smem);
        default: return occupancy<6, A8, NR>(smem);
    }
}

}  // namespace

// `splits` must leave no split without a step (splits <= kp / 32); up to
// INTB_DECODE_ROWS rows, counters (one int32 a 32-column tile, 0 before the
// launch, left 0 after it) serve the arrival of the splits, and the split's
// x must fit the block's shared memory. ws (splits, m, n) f32 and counters
// may be null for one split.
extern "C" int exl3_intb_matmul(const void* x, const void* packed, const void* scales, void* y,
                                void* ws, void* counters, int m, int k, int n, int kp, int bits,
                                int splits, void* stream) {
    return launch_bits<false>(bits, x, packed, scales, y, ws, counters, nullptr, nullptr, 1, m, k,
                              n, kp, splits, static_cast<cudaStream_t>(stream));
}

extern "C" int exl3_intb_matmul_a8(const void* x, const void* packed, const void* scales, void* y,
                                   void* ws, void* counters, void* xq, void* xs, int x_is_bf16,
                                   int m, int k, int n, int kp, int bits, int splits,
                                   void* stream) {
    return launch_bits<true>(bits, x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m, k, n,
                             kp, splits, static_cast<cudaStream_t>(stream));
}

// int-B launches so far by kernel: 0 products, 1 row quantizers, 2 split-k
// reduce kernels; -1 for another kind
extern "C" int exl3_intb_launches(int kind) {
    return kind >= 0 && kind < 3 ? intb_launch_count[kind] : -1;
}

// Blocks an SM holds of the staged body a product of these widths launches
// at m <= INTB_DECODE_ROWS (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or a negative CUDA error.
extern "C" int exl3_intb_blocks_per_sm(int m, int k, int n, int bits, int a8, int splits) {
    if (bits < 3 || bits > 6 || m < 1 || m > INTB_DECODE_ROWS || n % 32 || k % 32)
        return -(int)cudaErrorInvalidValue;
    const int W = 32 / bits;
    const int kp = (k + W * 32 - 1) / (W * 32) * 32;
    const int smem = intb_decode_smem(bits, a8 != 0, m, kp, splits);
    if (smem == 0) return -(int)cudaErrorInvalidValue;
    if (a8) return m <= 8 ? occupancy_bits<true, 1>(bits, smem) : occupancy_bits<true, 2>(bits, smem);
    return m <= 8 ? occupancy_bits<false, 1>(bits, smem) : occupancy_bits<false, 2>(bits, smem);
}
