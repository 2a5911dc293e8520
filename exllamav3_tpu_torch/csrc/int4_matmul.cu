// Grouped-int4 matmul for Hopper: y (m, n) f32 = x (m, k) @ W, where byte r
// of column c of `packed` (k/2, n) holds weight row r in its low nibble and
// row r + k/2 in its high nibble, both biased by +8, and `scales` (k/32, n)
// bf16 holds one scale per 32 rows and column.
//
// Replaces: exllamav3_tpu/ops/q_matmul.py::_int4_matmul_kernel
//           (int4_matmul_pallas) -> exl3_int4_matmul, weights as
//           bf16((nibble - 8) * scale) into bf16 MMAs;
//           exllamav3_tpu/ops/q_matmul.py::_int4_a8_kernel
//           (int4_matmul_pallas_a8, int4_matmul_a8) -> exl3_int4_matmul_a8,
//           int8 rows of x (the row quantizer: max|x| / 127 + 1e-12, IEEE
//           division, round half to even, +-127) times the nibbles in int8
//           MMAs, one exact int32 dot per 32-row group, times the group's
//           scale in f32, the row's scale applied last.
// Bound:    at decode 0.5625 bytes a weight over 3.35 TB/s; at prefill the
//           tensor-core rate, 989 TFLOP/s bf16 or 1,979 TOP/s int8.
// Design:   above INT4_DECODE_ROWS rows both routes take
//           csrc/packed_matmul.cuh (its lanes read their codes straight from
//           device memory; a split-k reduce kernel), launched from here after
//           its row quantizer on the a8 route.
//
//           Up to INT4_DECODE_ROWS rows (decode) both routes take the staged
//           body below, intb_matmul.cu's design over byte pairs. A block of
//           INT4_WARPS warps owns 128 output columns, a warp 32 of them, and a
//           run of k steps of INT4_STEP_ROWS packed rows (4 scale groups of
//           each plane). Each warp copies its own columns' bytes of a step (4
//           KB) and their group scales into shared memory with cp.async,
//           INT4_STAGES steps deep, and waits for its own copies alone: no
//           block barrier in the k loop. A staged row of 32 bytes goes to row
//           r ^ ((r >> 3) & 3), so that the four rows 8t + i the lane quarters
//           read at once lie on four different bank groups. The block's x for
//           its steps, both planes, is staged once: on the a8 route as int8
//           rows (after the quantizer, whose dependent the product is
//           launched as) with each group's row sums, on the bf16 route as the
//           bf16 rows handed over. The weights are the MMAs' A operand (16
//           columns a tile) and x the B operand (8 rows), so at m <= 8 no half
//           of an MMA is padding: lane (g, t) reads 4 bytes (columns 4g .. 4g
//           + 3) of packed rows 8t .. 8t + 7 of a group; MMA row g of tile tt
//           is column 4g + 2tt, row g + 8 column 4g + 2tt + 1 (k order is free
//           where A and B agree). Byte permutes turn four rows of four columns
//           into four columns of four rows, once for both planes.
//             a8 (mma.m16n8k32 u8 x s8): MMA k index i of lane quarter t is
//           packed row 8t + i; one mask takes a plane's nibbles, as unsigned
//           int8: the low plane's codes 0 .. 15, the high plane's 16 times its
//           codes, whose dot is scaled by 1/16 exactly. The +8 bias comes off
//           the exact int32 result as 8 times the group's row sum of x.
//             bf16 (mma.m16n8k16, f32 sums): two MMAs a group and plane, the
//           h-th taking packed rows 8t + 4h .. 8t + 4h + 3 as k indices 2t,
//           2t + 1, 2t + 8, 2t + 9. A nibble n OR-ed into 0x4300 is the bf16
//           value 128 + n exactly; a bf16x2 FMA subtracts 136 (exact: n - 8),
//           a second multiplies by the group's scale (one rounding: JAX's
//           bf16((n - 8) * scale); (128 + n) * s - 136 * s would round
//           elsewhere).
//           k is split across blocks in runs of steps whose lengths differ by
//           at most one, sized on the host from the card's SM count and the
//           route (ops/q_matmul.py::int4_split_count); each split writes its
//           partial sums and the last warp of a 32-column tile to arrive adds
//           them in split order and applies the a8 row scale, so that the
//           product is one launch (two on the a8 route, with its quantizer).
//           The limits and the shared-memory layout are in
//           csrc/int4_layout.cuh.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "int4_layout.cuh"
#include "packed_matmul.cuh"

// int4 kernel launches in this library, counted where they are made, for a
// caller that checks which kernels a product took (read through
// exl3_int4_launches): packed_matmul.cuh's products, row quantizers, split-k
// reduce kernels, staged products
static int int4_launch_count[4] = {0, 0, 0, 0};

namespace {

constexpr int THREADS = INT4_WARPS * 32;
constexpr int BN = INT4_WARPS * 32;  // output columns a block

// d = a (16 x 32 uint8) @ b (32 x 8 int8), exact int32
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(0), "r"(0), "r"(0), "r"(0));
}

// four rows (w0 .. w3) of four byte columns as four columns of four rows:
// byte c of each row into o[c], row 0 in the low byte
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t (&o)[4]) {
    const uint32_t p01 = __byte_perm(w0, w1, 0x5140), p23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t q01 = __byte_perm(w0, w1, 0x7362), q23 = __byte_perm(w2, w3, 0x7362);
    o[0] = __byte_perm(p01, p23, 0x5410);
    o[1] = __byte_perm(p01, p23, 0x7632);
    o[2] = __byte_perm(q01, q23, 0x5410);
    o[3] = __byte_perm(q01, q23, 0x7632);
}

// the stage row that holds packed row r of a step
__device__ __forceinline__ int stage_row(int r) { return r ^ ((r >> 3) & 3); }

constexpr int MAGIC_I = 0x4B400000;   // the float 1.5 * 2^23: its bits plus v are 1.5 * 2^23 + v
constexpr float MAGIC_F = 12582912.0f;  // for |v| < 2^22

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// bf16 route: the nibbles (bits 0-3 of bytes p and p + 1 of v, p = 2 * hi2)
// as the bf16x2 pair bf16((n - 8) * s), byte p low; s2 holds the column's
// scale twice
__device__ __forceinline__ uint32_t weights2(uint32_t v, int hi2, uint32_t s2) {
    // 0x4300 | n is the bf16 value 128 + n, exactly
    const uint32_t w = __byte_perm(v, 0x43434343u, hi2 ? 0x4342 : 0x4140);
    const uint32_t c = fma_bf16x2(w, 0x3F803F80u, 0xC308C308u);  // n - 8, exact
    return fma_bf16x2(c, s2, 0x80008000u);                         // times the scale, one rounding
}

// Grid (ceil(n / BN), splits). Split s takes the steps [s * steps / splits,
// (s + 1) * steps / splits), at most `per` of them; the last step of k may
// hold fewer than 4 groups. A8: the a8 route (xv the quantizer's int8 rows,
// xs their scales) or the bf16 route (xv the bf16 rows, xs null). NR: 8-row
// tiles of x (1 for m <= 8, else 2).
template <bool A8, int NR>
__global__ void __launch_bounds__(THREADS, INT4_BLOCKS)
int4_decode_kernel(const void* __restrict__ xv, const unsigned char* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, float* ws,
                   int* counters, const float* __restrict__ xs, int m, int k, int n, int per) {
    constexpr int SST = INT4_SCALE_STAGE / 2;  // scales of a warp's stage
    constexpr int ES = A8 ? 1 : 2;             // bytes of an element of x
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kh = k / 2;                  // packed rows
    const int groups = kh / 32;            // scale groups of a plane
    const int col0 = blockIdx.x * BN + warp * 32;
    const bool live = col0 < n;  // n % 32 == 0: a warp's columns are all in or all out
    const int splits = gridDim.y, split = blockIdx.y;
    const int steps = (kh + INT4_STEP_ROWS - 1) / INT4_STEP_ROWS;
    const int step0 = (int)((long long)split * steps / splits);
    const int nst = (int)((long long)(split + 1) * steps / splits) - step0;
    const int xld = int4_x_ld(per, A8);
    unsigned char* Ws = smem + warp * INT4_STAGES * INT4_BYTE_STAGE;
    __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(smem + INT4_WARPS * INT4_STAGES * INT4_BYTE_STAGE) +
                        warp * INT4_STAGES * SST;
    unsigned char* Xs = smem + INT4_WARPS * INT4_STAGES * int4_stage_bytes();
    int* Sx = reinterpret_cast<int*>(Xs + NR * 8 * xld);  // a8 only

    // step i of the block into the warp's stage i % INT4_STAGES: the packed
    // rows it holds of the warp's 32 columns, and their group scales (row
    // j * 4 + u: plane j, group u); a group is committed in every call, so
    // the waits stay in step
    auto issue = [&](int i) {
        if (live && i < nst) {
            const int step = step0 + i;
            const int rows = min(INT4_STEP_ROWS, kh - step * INT4_STEP_ROWS);  // a multiple of 32
            unsigned char* dw = Ws + (i % INT4_STAGES) * INT4_BYTE_STAGE;
            const unsigned char* sw = packed + (size_t)step * INT4_STEP_ROWS * n + col0;
            for (int e = lane; e < rows * 2; e += 32) {  // 16-byte halves of the rows
                const int r = e >> 1, c = e & 1;
                cp_async<16>(dw + stage_row(r) * 32 + 16 * c, sw + (size_t)r * n + 16 * c);
            }
            const int j = lane >> 4, u = (lane >> 2) & 3, q = lane & 3;  // a lane a copy
            if (u * 32 < rows)
                cp_async<16>(Ss + (i % INT4_STAGES) * SST + (j * 4 + u) * 32 + 8 * q,
                             scales + ((size_t)j * groups + step * 4 + u) * n + col0 + 8 * q);
        }
        cp_async_commit();
    };
    // the first step's bytes, then x of the block's steps in both planes,
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
        const int run = min(nst * INT4_STEP_ROWS, kh - step0 * INT4_STEP_ROWS) * ES / 16;
        for (int e = tid; e < m * 2 * run; e += THREADS) {
            const int u = e % run, rj = e / run;
            const int r = rj >> 1, j = rj & 1;
            cp_async<16>(Xs + r * xld + j * per * INT4_STEP_ROWS * ES + u * 16,
                         xg + ((size_t)r * k + j * kh + step0 * INT4_STEP_ROWS) * ES + u * 16);
        }
        cp_async_commit();
        // rows past m that the fragments read are zero
        for (int e = tid; e < (NR * 8 - m) * xld / 16; e += THREADS)
            reinterpret_cast<uint4*>(Xs + m * xld)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 1; i < INT4_STAGES - 1; ++i) issue(i);
    if constexpr (A8) {
        // each group's sum of x over its 32 k, by row (group j * per * 4 + 4i + u)
        for (int e = tid; e < 2 * per * 4 * NR * 8; e += THREADS) {
            const int r = e % (NR * 8), gi = e / (NR * 8);
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
            Sx[gi * (INT4_X_SUMS / 4) + r] = s;
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
        cp_async_wait<INT4_STAGES - 2>();  // step i has landed, and this warp is
        __syncwarp();                      // done with the stage it overwrites
        issue(i + INT4_STAGES - 1);
        if (!live) continue;
        const unsigned char* wt = Ws + (i % INT4_STAGES) * INT4_BYTE_STAGE;
        const __nv_bfloat16* st = Ss + (i % INT4_STAGES) * SST;
        const int gs = min(4, groups - (step0 + i) * 4);  // groups of this step
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (u >= gs) break;
            uint32_t w[8];  // packed rows 8t .. 8t + 7 of group u, columns 4g .. 4g + 3
#pragma unroll
            for (int r = 0; r < 8; ++r)
                w[r] = *reinterpret_cast<const uint32_t*>(wt + stage_row(u * 32 + 8 * t + r) * 32 + 4 * g);
            uint32_t lo4[4], hi4[4];  // column c's rows 8t .. 8t + 3, and 8t + 4 .. 8t + 7
            transpose4(w[0], w[1], w[2], w[3], lo4);
            transpose4(w[4], w[5], w[6], w[7], hi4);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int gi = (j * per + i) * 4 + u;
                const uint2 sv = *reinterpret_cast<const uint2*>(st + (j * 4 + u) * 32 + 4 * g);
                if constexpr (A8) {
                    const uint32_t mask = j ? 0xF0F0F0F0u : 0x0F0F0F0Fu;
                    const float sc[4] = {__uint_as_float(sv.x << 16), __uint_as_float(sv.x & 0xFFFF0000u),
                                         __uint_as_float(sv.y << 16), __uint_as_float(sv.y & 0xFFFF0000u)};
                    uint2 xb[NR];
                    int2 sx[NR];
#pragma unroll
                    for (int rt = 0; rt < NR; ++rt) {
                        xb[rt] = *reinterpret_cast<const uint2*>(Xs + (8 * rt + g) * xld + gi * 32 + 8 * t);
                        sx[rt] = *reinterpret_cast<const int2*>(Sx + gi * (INT4_X_SUMS / 4) + 8 * rt + 2 * t);
                    }
#pragma unroll
                    for (int tt = 0; tt < 2; ++tt) {
                        const uint32_t a[4] = {lo4[2 * tt] & mask, lo4[2 * tt + 1] & mask,
                                               hi4[2 * tt] & mask, hi4[2 * tt + 1] & mask};
#pragma unroll
                        for (int rt = 0; rt < NR; ++rt) {
                            const uint32_t b[2] = {xb[rt].x, xb[rt].y};
                            int d[4];
                            mma_u8s8(d, a, b);
                            // the exact dot of the centred codes, as a float: the
                            // high plane's is 16 times it until the exact 1/16
                            const int bias = j ? 128 : 8;
                            const int k0 = MAGIC_I - bias * sx[rt].x, k1 = MAGIC_I - bias * sx[rt].y;
                            const float f = j ? 0.0625f : 1.0f, c = -MAGIC_F * f;
                            acc[rt][tt][0] = fmaf(fmaf(__int_as_float(d[0] + k0), f, c), sc[2 * tt], acc[rt][tt][0]);
                            acc[rt][tt][1] = fmaf(fmaf(__int_as_float(d[1] + k1), f, c), sc[2 * tt], acc[rt][tt][1]);
                            acc[rt][tt][2] = fmaf(fmaf(__int_as_float(d[2] + k0), f, c), sc[2 * tt + 1], acc[rt][tt][2]);
                            acc[rt][tt][3] = fmaf(fmaf(__int_as_float(d[3] + k1), f, c), sc[2 * tt + 1], acc[rt][tt][3]);
                        }
                    }
                } else {
                    uint4 xb[NR];  // x k 8t .. 8t + 7 of the group, rows 8rt + g
#pragma unroll
                    for (int rt = 0; rt < NR; ++rt)
                        xb[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + gi * 64 + 16 * t);
                    const uint32_t s2[4] = {__byte_perm(sv.x, 0u, 0x1010), __byte_perm(sv.x, 0u, 0x3232),
                                            __byte_perm(sv.y, 0u, 0x1010), __byte_perm(sv.y, 0u, 0x3232)};
#pragma unroll
                    for (int h = 0; h < 2; ++h) {  // packed rows 8t + 4h .. 8t + 4h + 3
                        uint32_t v[4];  // the plane's nibbles of those rows, column c in v[c]
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            v[c] = ((h ? hi4[c] : lo4[c]) >> (4 * j)) & 0x0F0F0F0Fu;
#pragma unroll
                        for (int tt = 0; tt < 2; ++tt) {
                            const int c0 = 2 * tt, c1 = 2 * tt + 1;
                            const uint32_t a[4] = {weights2(v[c0], 0, s2[c0]), weights2(v[c1], 0, s2[c1]),
                                                   weights2(v[c0], 1, s2[c0]), weights2(v[c1], 1, s2[c1])};
#pragma unroll
                            for (int rt = 0; rt < NR; ++rt) {
                                const uint32_t b[2] = {h ? xb[rt].z : xb[rt].x, h ? xb[rt].w : xb[rt].y};
                                packed::mma_bf16(acc[rt][tt], a, b);
                            }
                        }
                    }
                }
            }
        }
    }

    // this lane's outputs: rows 8rt + 2t + h, columns col0 + 4g .. + 3. With
    // one split the a8 row scale is applied here
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
    // in split order, times the a8 row scale, and writes them
    // (intb_matmul.cu's per-warp arrival: each warp arrives for itself, so no
    // warp waits for the block's slowest). A lane takes two float4 runs a
    // step of 16 rows, and its loads from eight splits of both are in flight
    // at once
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

template <bool A8, int NR>
int prepare() {  // the largest shared memory a launch of this body may ask for
    static int err = -1;
    if (err != 0)
        err = (int)cudaFuncSetAttribute(int4_decode_kernel<A8, NR>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, INT4_MAX_SMEM);
    return err;
}

// up to INT4_DECODE_ROWS rows the staged body: on the a8 route after the
// dependents' row quantizer, whose programmatic dependent it is up to
// INT4_PDL_MAX_K; on the bf16 route alone, over x as it is
template <bool A8, int NR>
int launch_decode(const void* x, const void* packed, const void* scales, void* y, void* ws,
                  void* counters, void* xq, void* xs, int x_is_bf16, int m, int k, int n,
                  int splits, cudaStream_t st) {
    const int smem = int4_decode_smem(m, k / 2, splits, A8);
    if (smem == 0 || (splits > 1 && (ws == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (const int err = prepare<A8, NR>()) return err;
    if constexpr (A8) {
        if (x_is_bf16)
            packed::quantize_rows_dependents<<<m, packed::QUANT_THREADS, 0, st>>>(
                static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
                static_cast<float*>(xs), k);
        else
            packed::quantize_rows_dependents<<<m, packed::QUANT_THREADS, 0, st>>>(
                static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), k);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
        ++int4_launch_count[1];
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + BN - 1) / BN, splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    if (A8 && k <= INT4_PDL_MAX_K) {
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    const int steps = (k / 2 + INT4_STEP_ROWS - 1) / INT4_STEP_ROWS;
    int err = (int)cudaLaunchKernelEx(
        &cfg, int4_decode_kernel<A8, NR>, static_cast<const void*>(A8 ? xq : x),
        static_cast<const unsigned char*>(packed), static_cast<const __nv_bfloat16*>(scales),
        static_cast<float*>(y), static_cast<float*>(ws), static_cast<int*>(counters),
        static_cast<const float*>(A8 ? xs : nullptr), m, k, n, (steps + splits - 1) / splits);
    if (err == 0) err = (int)cudaGetLastError();
    if (err == 0) ++int4_launch_count[3];
    return err;
}

template <bool A8>
int launch_staged(const void* x, const void* packed, const void* scales, void* y, void* ws,
                  void* counters, void* xq, void* xs, int x_is_bf16, int m, int k, int n,
                  int splits, cudaStream_t st) {
    return m <= 8 ? launch_decode<A8, 1>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m,
                                         k, n, splits, st)
                  : launch_decode<A8, 2>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m,
                                         k, n, splits, st);
}

template <bool A8, int NR>
int occupancy(int smem) {
    if (const int err = prepare<A8, NR>()) return -err;
    int blocks = 0;
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, int4_decode_kernel<A8, NR>, THREADS, smem);
    return err ? -err : blocks;
}

}  // namespace

// `splits` must leave no split without a step: up to INT4_DECODE_ROWS rows at
// most ceil(k / 2 / INT4_STEP_ROWS) (the staged body's steps), with counters
// (one int32 a 32-column tile, 0 before the launch, left 0 after it) for the
// arrival of the splits and the split's x within a block's shared memory;
// above, at most k / 64 (packed_matmul.cuh's). ws (splits, m, n) f32 and
// counters may be null for one split. x is bf16 on this route.
extern "C" int exl3_int4_matmul(const void* x, const void* packed, const void* scales, void* y,
                                void* ws, void* counters, int m, int k, int n, int splits,
                                void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || k % 64 || n % 64) return (int)cudaErrorInvalidValue;
    if (m > INT4_DECODE_ROWS)
        return packed::launch<0, false>(x, packed, scales, y, ws, nullptr, nullptr, 1, m, k, n,
                                        k / 2, splits, st, int4_launch_count);
    return launch_staged<false>(x, packed, scales, y, ws, counters, nullptr, nullptr, 1, m, k, n,
                                splits, st);
}

// as exl3_int4_matmul; x f32 or bf16 (x_is_bf16), xq (m, k) int8 and xs (m,)
// f32 the quantizer's rows and scales
extern "C" int exl3_int4_matmul_a8(const void* x, const void* packed, const void* scales, void* y,
                                   void* ws, void* counters, void* xq, void* xs, int x_is_bf16,
                                   int m, int k, int n, int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || k % 64 || n % 64) return (int)cudaErrorInvalidValue;
    if (m > INT4_DECODE_ROWS)
        return packed::launch<0, true>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, k / 2,
                                       splits, st, int4_launch_count);
    return launch_staged<true>(x, packed, scales, y, ws, counters, xq, xs, x_is_bf16, m, k, n,
                               splits, st);
}

// int4 launches so far by kernel: 0 packed_matmul.cuh's products, 1 row
// quantizers, 2 split-k reduce kernels, 3 staged products (both routes); -1
// for another kind
extern "C" int exl3_int4_launches(int kind) {
    return kind >= 0 && kind < 4 ? int4_launch_count[kind] : -1;
}

// Blocks an SM holds of the staged body a product of these widths launches
// at m <= INT4_DECODE_ROWS on the a8 (a8 != 0) or the bf16 route
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
extern "C" int exl3_int4_blocks_per_sm(int m, int k, int n, int a8, int splits) {
    if (m < 1 || m > INT4_DECODE_ROWS || n % 64 || k % 64) return -(int)cudaErrorInvalidValue;
    const int smem = int4_decode_smem(m, k / 2, splits, a8 != 0);
    if (smem == 0) return -(int)cudaErrorInvalidValue;
    if (a8) return m <= 8 ? occupancy<true, 1>(smem) : occupancy<true, 2>(smem);
    return m <= 8 ? occupancy<false, 1>(smem) : occupancy<false, 2>(smem);
}
