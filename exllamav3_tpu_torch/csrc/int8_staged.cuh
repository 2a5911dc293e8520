// The staged int8 body for Hopper, up to INT8_DECODE_ROWS rows:
//   y (m, n) f32 = bf16 x (m, k) @ bf16(W) (k, n), W int8 (every int8 is exact
//   in bf16), f32 sums,
// with one of two epilogues: SCALED, y times a column scale (or none) plus a
// column bias (or none), each one f32 operation (the int8 matmul; the fused
// MLP's down product); GATE_UP, the fused MLP's first phase, where W holds
// [gate | up] (k, 2i) and the epilogue writes a (m, i) bf16 =
// bf16(act(clip(g * sg)) * (u * su)).
//
// Used by: csrc/int8_matmul.cu (kernel row 1) and csrc/fused_mlp.cu (row 2),
// each of which counts its own launches.
// Bound:    1 byte a weight over 3.35 TB/s; the operations (2 m k n) are far
//           below the tensor-core rate at m <= 16.
// Design:   a block of INT8_WARPS warps owns 128 columns, a warp 32 of them,
//           and a run of k steps of INT8_STEP_ROWS rows (4 groups of 32). Each
//           warp copies its own columns' int8 rows of a step (4 KB) into
//           shared memory with cp.async, INT8_STAGES steps deep, and waits
//           for its own copies alone: no block barrier in the k loop. A staged
//           row of 32 bytes goes to row r ^ ((r >> 3) & 3), so that the four
//           rows 8t + i the lane quarters read at once lie on four different
//           bank groups. The block's x for its steps is staged once, as bf16
//           rows. The weights are the A operand of mma.m16n8k16 (16 columns
//           a tile) and x the B operand (8 rows), so at m <= 8 no half of an
//           MMA is padding: lane (g, t) reads 4 bytes (columns 4g .. 4g + 3)
//           of rows 8t .. 8t + 7 of a group; MMA row g of tile tt is column
//           4g + 2tt, row g + 8 column 4g + 2tt + 1, and MMA k indices 2t,
//           2t + 1, 2t + 8, 2t + 9 of half hh are rows 8t + 4hh .. + 3 (k order
//           is free where A and B agree). An int8 s becomes bf16 in registers
//           from two rows' words, 4 instructions a pair of weights: one byte
//           permute puts the column's byte of each row in the low byte of a
//           half, two logic ops make v = 128 + (s & 127) and
//           o = -(128 + (s & 128)), both exact in bf16, and one bf16x2 FMA
//           gives v + o = s exactly.
//           k is split across blocks in runs of steps whose lengths differ by
//           at most one, sized on the host from the card's SM count
//           (ops/q_matmul.py::int8_split_count); each split writes its
//           partial sums and the last warp of a 32-column tile to arrive adds
//           them in split order and applies the epilogue, so that a product
//           is one launch and its result the same from run to run.
//           GATE_UP: a warp's 32 staged columns are gate columns c .. c + 15
//           and up columns i + c .. i + c + 15, so lanes g and g ^ 4 hold the
//           gate and up sums of the same intermediate columns: one exchange of
//           accumulators (or the reduction reading both runs) pairs them.
//           The limits and the shared-memory layout are in
//           csrc/int8_layout.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "int8_layout.cuh"

namespace int8s {
namespace {  // each source that includes this header gets its own copies

constexpr int THREADS = INT8_WARPS * 32;
constexpr int BN = INT8_WARPS * 32;  // columns a block

enum Epilogue { SCALED = 0, GATE_UP = 1 };
enum Activation { SILU = 0, GELU = 1, GELU_TANH = 2, RELU2 = 3 };

// act(g) in f32; `act` is the same for the whole grid, so the branch costs
// the epilogue next to nothing
__device__ __forceinline__ float activate(int act, float g) {
    if (act == SILU) return g * (1.0f / (1.0f + expf(-g)));
    if (act == GELU) return 0.5f * g * erfcf(-g * 0.70710678118654752f);  // jax.nn.gelu's order
    if (act == GELU_TANH) {
        const float c = 0.79788456080286536f;  // sqrt(2 / pi)
        return g * (0.5f * (1.0f + tanhf(c * (g + 0.044715f * (g * g * g)))));
    }
    const float r = fmaxf(g, 0.0f);  // RELU2
    return r * r;
}

// the stage row that holds row r of a step
__device__ __forceinline__ int stage_row(int r) { return r ^ ((r >> 3) & 3); }

// PRMT selector: byte c of the first word in byte 0, of the second in byte 2
__device__ __forceinline__ constexpr uint32_t col_sel(int c) { return 0x4400u + 0x1111u * c; }

// byte c of a and of b (one column's int8 in two rows) as the exact bf16x2
// pair, a's in the low half
__device__ __forceinline__ uint32_t bf16_pair(uint32_t a, uint32_t b, uint32_t sel) {
    const uint32_t p = __byte_perm(a, b, sel);
    const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;  // 128 + (s & 127)
    const uint32_t o = (p & 0x00800080u) | 0xC300C300u;  // -128 or -256
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(o));
    return d;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// R runs of 4 columns, each the sum of every split's partials at ws +
// split * plane + at[r], added in split order from 0; the loads of eight
// splits of every run are in flight at once
template <int R>
__device__ __forceinline__ void split_sums(const float* ws, size_t plane, const size_t (&at)[R],
                                           int splits, float4 (&s)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp = 0; sp < splits; sp += 8) {
        float4 p[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (sp + u < splits)
                    p[r][u] = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)(sp + u) * plane + at[r]));
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int u = 0; u < 8; ++u)
                if (sp + u < splits) s[r] = add4(s[r], p[r][u]);
    }
}

// SCALED: the sums of 4 columns from col times scale, plus bias, each one f32
// operation, as the plain version's separate multiply and add
__device__ __forceinline__ float4 scaled(float4 v, const float* scale, const float* bias, int col) {
    if (scale) {
        const float4 s = *reinterpret_cast<const float4*>(scale + col);
        v = make_float4(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y), __fmul_rn(v.z, s.z),
                        __fmul_rn(v.w, s.w));
    }
    if (bias) {
        const float4 b = *reinterpret_cast<const float4*>(bias + col);
        v = make_float4(__fadd_rn(v.x, b.x), __fadd_rn(v.y, b.y), __fadd_rn(v.z, b.z),
                        __fadd_rn(v.w, b.w));
    }
    return v;
}

// GATE_UP: 4 intermediate columns from ic of one row, from their gate and up
// sums, into a as bf16
__device__ __forceinline__ void gate_up_out(float4 gs, float4 us, const float* sc, int inter, int ic,
                                            int act, float clamp, __nv_bfloat16* a) {
    const float gv[4] = {gs.x, gs.y, gs.z, gs.w}, uv[4] = {us.x, us.y, us.z, us.w};
    uint32_t o[2];
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
        float r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float g = gv[j + e] * sc[ic + j + e];
            if (clamp > 0.0f) g = fminf(fmaxf(g, -clamp), clamp);
            r[e] = activate(act, g) * (uv[j + e] * sc[inter + ic + j + e]);
        }
        const __nv_bfloat162 p = __floats2bfloat162_rn(r[0], r[1]);
        o[j / 2] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint2*>(a + ic) = make_uint2(o[0], o[1]);
}

// Grid (ceil(n / BN), splits). Split s takes the steps [s * steps / splits,
// (s + 1) * steps / splits), at most `per` of them; the last step of k may
// hold fewer than 4 groups. NR: 8-row tiles of x (1 for m <= 8, else 2).
// W: rows of n int8 columns (SCALED: the output's columns; GATE_UP: [gate |
// up], n = 2 * inter). out: y (m, n) f32 (SCALED) or a (m, inter) bf16.
// WAIT: a programmatic dependent, which waits for its primary's writes
// before it reads x (after its first step's weights are asked for).
template <int NR, int EPI, bool WAIT>
__global__ void __launch_bounds__(THREADS, INT8_BLOCKS)
int8_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias, void* out,
                   float* ws, int* counters, int m, int k, int n, int inter, int per, int act,
                   float clamp) {
    extern __shared__ __align__(16) unsigned char smem[];

    if constexpr (EPI == GATE_UP)  // the second phase may launch as soon as every block runs
        asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = blockIdx.x * BN + warp * 32;  // the warp's first (staged) column
    const bool live = col0 < n;  // n % 32 == 0: a warp's columns are all in or all out
    const int splits = gridDim.y, split = blockIdx.y;
    const int steps = (k + INT8_STEP_ROWS - 1) / INT8_STEP_ROWS;
    const int step0 = (int)((long long)split * steps / splits);
    const int nst = (int)((long long)(split + 1) * steps / splits) - step0;
    const int xld = int8_x_ld(per);
    unsigned char* Ws = smem + warp * INT8_STAGES * INT8_BYTE_STAGE;
    unsigned char* Xs = smem + INT8_WARPS * INT8_STAGES * INT8_BYTE_STAGE;
    // the device columns of the warp's two 16-byte halves of a staged row
    const int gcol = col0 >> 1;  // GATE_UP: the warp's first gate column
    const int src0 = EPI == GATE_UP ? gcol : col0;
    const int src1 = EPI == GATE_UP ? inter + gcol : col0 + 16;

    // step i of the block into the warp's stage i % INT8_STAGES: the rows it
    // holds of the warp's 32 columns; a group is committed in every call, so
    // the waits stay in step
    auto issue = [&](int i) {
        if (live && i < nst) {
            const int step = step0 + i;
            const int rows = min(INT8_STEP_ROWS, k - step * INT8_STEP_ROWS);  // a multiple of 32
            unsigned char* dw = Ws + (i % INT8_STAGES) * INT8_BYTE_STAGE;
            const int8_t* sw = w + (size_t)step * INT8_STEP_ROWS * n;
            for (int e = lane; e < rows * 2; e += 32) {  // 16-byte halves of the rows
                const int r = e >> 1, c = e & 1;
                cp_async<16>(dw + stage_row(r) * 32 + 16 * c, sw + (size_t)r * n + (c ? src1 : src0));
            }
        }
        cp_async_commit();
    };
    // the first step's weights, then x of the block's steps, once (on a
    // programmatic dependent after its primary has written it); the steps
    // behind them are asked for once they have landed, so that the card's
    // first burst of copies is the first steps alone
    issue(0);
    if constexpr (WAIT) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    {
        const int run = min(nst * INT8_STEP_ROWS, k - step0 * INT8_STEP_ROWS) / 8;  // 16-byte units
        for (int e = tid; e < m * run; e += THREADS) {
            const int r = e / run, u = e % run;
            cp_async<16>(Xs + r * xld + u * 16, x + (size_t)r * k + step0 * INT8_STEP_ROWS + u * 8);
        }
        cp_async_commit();
        // rows past m that the fragments read are zero
        for (int e = tid; e < (NR * 8 - m) * xld / 16; e += THREADS)
            reinterpret_cast<uint4*>(Xs + m * xld)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 1; i < INT8_STAGES - 1; ++i) issue(i);

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
        cp_async_wait<INT8_STAGES - 2>();  // step i has landed, and this warp is
        __syncwarp();                      // done with the stage it overwrites
        issue(i + INT8_STAGES - 1);
        if (!live) continue;
        const unsigned char* wt = Ws + (i % INT8_STAGES) * INT8_BYTE_STAGE;
        const int gs = min(4, (k - (step0 + i) * INT8_STEP_ROWS) / 32);  // groups of this step
        // group u's rows 8t .. 8t + 7 (columns 4g .. 4g + 3) and x fragments (x
        // row 8rt + g, k 8t .. 8t + 7); the next group's are asked for before
        // this one's conversion and MMAs
        uint32_t wr[2][8];
        uint4 xb[2][NR];
        auto load = [&](int u, uint32_t(&w8)[8], uint4(&xv)[NR]) {
#pragma unroll
            for (int r = 0; r < 8; ++r)
                w8[r] = *reinterpret_cast<const uint32_t*>(wt + stage_row(u * 32 + 8 * t + r) * 32 + 4 * g);
#pragma unroll
            for (int rt = 0; rt < NR; ++rt)
                xv[rt] = *reinterpret_cast<const uint4*>(Xs + (8 * rt + g) * xld + (i * 4 + u) * 64 + 16 * t);
        };
        load(0, wr[0], xb[0]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (u >= gs) break;
            if (u + 1 < gs) load(u + 1, wr[(u + 1) & 1], xb[(u + 1) & 1]);
            const uint32_t(&w8)[8] = wr[u & 1];
#pragma unroll
            for (int tt = 0; tt < 2; ++tt)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {  // rows 8t + 4hh .. 8t + 4hh + 3
                    const uint32_t a[4] = {
                        bf16_pair(w8[4 * hh], w8[4 * hh + 1], col_sel(2 * tt)),
                        bf16_pair(w8[4 * hh], w8[4 * hh + 1], col_sel(2 * tt + 1)),
                        bf16_pair(w8[4 * hh + 2], w8[4 * hh + 3], col_sel(2 * tt)),
                        bf16_pair(w8[4 * hh + 2], w8[4 * hh + 3], col_sel(2 * tt + 1))};
#pragma unroll
                    for (int rt = 0; rt < NR; ++rt) {
                        const uint4& xr = xb[u & 1][rt];
                        const uint32_t b[2] = {hh ? xr.z : xr.x, hh ? xr.w : xr.y};
                        mma_bf16(acc[rt][tt], a, b);
                    }
                }
        }
    }
    if (!live) return;

    if (splits == 1) {  // the epilogue in place
        if constexpr (EPI == SCALED) {
#pragma unroll
            for (int rt = 0; rt < NR; ++rt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = 8 * rt + 2 * t + h;
                    if (row >= m) continue;
                    const float4 v = make_float4(acc[rt][0][h], acc[rt][0][2 + h], acc[rt][1][h],
                                                 acc[rt][1][2 + h]);
                    *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)row * n + col0 + 4 * g) =
                        scaled(v, scale, bias, col0 + 4 * g);
                }
        } else {
            // lanes g < 4 hold the gate sums of intermediate columns gcol +
            // 4 (g & 3) .. + 3, lanes g ^ 4 the up sums of the same columns:
            // after one exchange the first takes rows 8rt + 2t, the second
            // rows 8rt + 2t + 1
            const bool up = g >= 4;
#pragma unroll
            for (int rt = 0; rt < NR; ++rt) {
                float other[2][4];
#pragma unroll
                for (int tt = 0; tt < 2; ++tt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        other[tt][e] = __shfl_xor_sync(0xFFFFFFFFu, acc[rt][tt][e], 16);
                const int row = 8 * rt + 2 * t + (up ? 1 : 0);
                if (row >= m) continue;
                // this lane's row of its own sums and of its partner's
                const float4 mine = up ? make_float4(acc[rt][0][1], acc[rt][0][3], acc[rt][1][1], acc[rt][1][3])
                                       : make_float4(acc[rt][0][0], acc[rt][0][2], acc[rt][1][0], acc[rt][1][2]);
                const float4 theirs = up ? make_float4(other[0][1], other[0][3], other[1][1], other[1][3])
                                         : make_float4(other[0][0], other[0][2], other[1][0], other[1][2]);
                gate_up_out(up ? theirs : mine, up ? mine : theirs, scale, inter,
                            gcol + 4 * (g & 3), act, clamp,
                                 static_cast<__nv_bfloat16*>(out) + (size_t)row * inter);
            }
        }
        return;
    }

    // this lane's partial sums: rows 8rt + 2t + h, staged columns col0 + 4g .. + 3
    float* part = ws + (size_t)split * m * n;
#pragma unroll
    for (int rt = 0; rt < NR; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 8 * rt + 2 * t + h;
            if (row < m)
                *reinterpret_cast<float4*>(part + (size_t)row * n + col0 + 4 * g) =
                    make_float4(acc[rt][0][h], acc[rt][0][2 + h], acc[rt][1][h], acc[rt][1][2 + h]);
        }

    // the last split of this warp's 32 columns to arrive adds the partials
    // in split order and applies the epilogue: each warp arrives for itself
    // (its lanes' writes ordered before lane 0's arrival, and lane 0's
    // acquire before its lanes' reads, by warp barriers), so no warp waits
    // for the block's slowest
    __syncwarp();
    const int tile = col0 / 32;
    int last = 0;
    if (lane == 0) last = arrive(counters + tile) == splits - 1;
    last = __shfl_sync(0xFFFFFFFFu, last, 0);
    if (!last) return;
    __syncwarp();
    const size_t plane = (size_t)m * n;
    if constexpr (EPI == SCALED) {
        // a lane takes two runs of 4 columns a pass: run e is row e / 8,
        // columns 4 (e % 8) ..
        for (int e0 = lane; e0 < m * 8; e0 += 64) {
            size_t at[2];
            float4 s[2];
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                const int e = min(e0 + 32 * v, m * 8 - 1);  // a spare run repeats the last
                at[v] = (size_t)(e / 8) * n + col0 + (e % 8) * 4;
            }
            split_sums<2>(ws, plane, at, splits, s);
#pragma unroll
            for (int v = 0; v < 2; ++v)
                if (e0 + 32 * v < m * 8)
                    *reinterpret_cast<float4*>(static_cast<float*>(out) + at[v]) =
                        scaled(s[v], scale, bias, col0 + (e0 + 32 * v) % 8 * 4);
        }
    } else {
        // run e is row e / 4, intermediate columns gcol + 4 (e % 4) .. : its
        // gate sums at staged columns 4 (e % 4) .., its up sums 16 further
        for (int e = lane; e < m * 4; e += 32) {
            const size_t at[2] = {(size_t)(e / 4) * n + col0 + (e % 4) * 4,
                                  (size_t)(e / 4) * n + col0 + 16 + (e % 4) * 4};
            float4 s[2];
            split_sums<2>(ws, plane, at, splits, s);
            gate_up_out(s[0], s[1], scale, inter, gcol + (e % 4) * 4, act, clamp,
                             static_cast<__nv_bfloat16*>(out) + (size_t)(e / 4) * inter);
        }
    }
    if (lane == 0) counters[tile] = 0;  // ready for the next launch
}

template <int NR, int EPI, bool WAIT>
int prepare() {  // the largest shared memory a launch of this body may ask for
    static int err = -1;
    if (err != 0)
        err = (int)cudaFuncSetAttribute(int8_decode_kernel<NR, EPI, WAIT>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, INT8_MAX_SMEM);
    return err;
}

// One launch of the staged body (m <= INT8_DECODE_ROWS; k and n multiples of
// 32). `splits` must leave no split without a step; ws (splits, m, n) f32 and
// counters (one int32 a 32-column tile, 0 before the launch, left 0 after
// it) may be null for one split. pdl: launched as a programmatic dependent of
// the stream's previous kernel.
template <int EPI, bool WAIT>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out,
           void* ws, void* counters, int m, int k, int n, int inter, int splits, int act,
           float clamp, bool pdl, cudaStream_t st) {
    const int smem = int8_decode_smem(m, k, splits);
    if (m < 1 || m > INT8_DECODE_ROWS || k % 32 || n % 32 || smem == 0 ||
        (splits > 1 && (ws == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + BN - 1) / BN, splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    if (pdl) {
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    const int steps = (k + INT8_STEP_ROWS - 1) / INT8_STEP_ROWS;
    const int per = (steps + splits - 1) / splits;
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const int8_t*>(w);
    auto* wsp = static_cast<float*>(ws);
    auto* cp = static_cast<int*>(counters);
    int err;
    if (m <= 8) {
        if ((err = prepare<1, EPI, WAIT>())) return err;
        err = (int)cudaLaunchKernelEx(&cfg, int8_decode_kernel<1, EPI, WAIT>, xp, wp, scale, bias,
                                      out, wsp, cp, m, k, n, inter, per, act, clamp);
    } else {
        if ((err = prepare<2, EPI, WAIT>())) return err;
        err = (int)cudaLaunchKernelEx(&cfg, int8_decode_kernel<2, EPI, WAIT>, xp, wp, scale, bias,
                                      out, wsp, cp, m, k, n, inter, per, act, clamp);
    }
    return err ? err : (int)cudaGetLastError();
}

// Blocks an SM holds of the SCALED body at these widths
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
inline int blocks_per_sm(int m, int k, int splits) {
    const int smem = int8_decode_smem(m, k, splits);
    if (m < 1 || m > INT8_DECODE_ROWS || smem == 0) return -(int)cudaErrorInvalidValue;
    int blocks = 0, err;
    if (m <= 8) {
        if ((err = prepare<1, SCALED, false>())) return -err;
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, int8_decode_kernel<1, SCALED, false>, THREADS, smem);
    } else {
        if ((err = prepare<2, SCALED, false>())) return -err;
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, int8_decode_kernel<2, SCALED, false>, THREADS, smem);
    }
    return err ? -err : blocks;
}

}  // namespace
}  // namespace int8s
