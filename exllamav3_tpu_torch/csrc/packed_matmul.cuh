// Matmul over sub-byte weight codes for Hopper, shared by int4_matmul.cu
// (two 4-bit codes a byte) and intb_matmul.cu (32 / B codes of B bits in an
// int32 word): y (m, n) f32 = x (m, k) @ W, W[r][c] = code[r][c] * scale[r / 32][c].
//
// Layouts (the JAX package's): a "packed row" p of column c holds PLANES codes,
// the weights of rows p, p + prows, p + 2 * prows, ...: byte pairs have
// prows = k / 2 and 2 planes (low, high nibble), words have prows = kp and
// 32 / B planes (code j at bits B*j). Codes are biased by 2^(B-1). scales
// (rows / 32, n) bf16.
//
// Two routes, a template flag:
//   bf16: x bf16, each weight enters mma.m16n8k16 as bf16(code * scale), one
//         rounding; f32 accumulation in the MMA.
//   a8:   x int8 (quantize_rows_kernel below: scale max|x| / 127 + 1e-12,
//         x / scale rounded half to even, clipped to +-127), codes as signed
//         int8 into mma.m16n8k32.s8: one MMA spans k = 32, exactly one scale
//         group, so its exact int32 result times the group's scale adds into an
//         f32 sum; the row's scale is applied at the end.
//
// Bound:  at decode the packed bytes plus scales over the memory rate; at
//         prefill the tensor-core rate (bf16, or int8 for a8).
// Design: no shared memory. A sum over k does not care in which order k is
//         walked, nor does the product care which MMA column stands for which
//         output column, as long as A, B and C agree. So a lane reads the codes
//         straight from device memory in the shape that is cheap to load, NT
//         neighbouring columns of 8 neighbouring packed rows (rows 8t..8t+7 of
//         a 32-row step for lane quarter t, columns NT*g.. for lane group g),
//         and declares them its B fragments: MMA column g of tile `nt` is
//         output column NT*g + nt, MMA k index i of lane quarter t is row
//         8t + i. x is read to match (8 consecutive k per lane) and each lane
//         ends up owning 2*NT consecutive output columns. Each packed word is
//         loaded once and feeds all its planes. The next step's codes are
//         fetched while the current step multiplies. Rows of a padded last
//         plane (>= k) are skipped, not read as zeros. The k loop is split
//         across blocks to fill the card; partial sums go to a workspace and a
//         second kernel adds them in split order (deterministic).
//         No TMA, wgmma or shared-memory staging of x yet: at prefill every
//         warp re-reads its x rows through L1.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace packed {
namespace {  // each source that includes this header gets its own copies

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a (16 x 32 int8) @ b (32 x 8 int8), exact int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(0), "r"(0), "r"(0), "r"(0));
}

// N consecutive 32-bit values from an address aligned to 4 * N bytes (16 for N >= 4)
template <int N>
__device__ __forceinline__ void load_u32(const uint32_t* p, uint32_t (&r)[N]) {
    if constexpr (N == 1) {
        r[0] = __ldg(p);
    } else if constexpr (N == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        r[0] = v.x; r[1] = v.y;
    } else {
        static_assert(N % 4 == 0, "vector width");
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
            r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
        }
    }
}

// N consecutive bf16 values as f32
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&f)[N]) {
    uint32_t u[N / 2];
    load_u32<N / 2>(reinterpret_cast<const uint32_t*>(p), u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    union { __nv_bfloat162 h; uint32_t u; } cvt;
    cvt.h = __floats2bfloat162_rn(lo, hi);
    return cvt.u;
}

// BITS = 0: byte pairs (int4 tier); BITS = 3, 4, 5, 6: words (int-B tiers).
// NT: 8-column MMA tiles a warp covers (8 * NT columns); MT: 16-row tiles.
template <int BITS, bool A8, int NT, int MT>
__global__ void __launch_bounds__(THREADS)
packed_matmul_kernel(const void* __restrict__ xv, const uint32_t* __restrict__ packed,
                     const __nv_bfloat16* __restrict__ scales, float* __restrict__ out,
                     const float* __restrict__ xs, int m, int k, int n, int prows,
                     int steps_per_split, int steps) {
    constexpr bool NIB = BITS == 0;
    constexpr int FIELD = NIB ? 4 : BITS;
    constexpr int PLANES = NIB ? 2 : 32 / BITS;
    constexpr int NW = NIB ? NT / 4 : NT;  // 32-bit registers per packed row
    constexpr uint32_t MASK = (1u << FIELD) - 1u;
    constexpr int BIAS = 1 << (FIELD - 1);
    constexpr uint32_t BIAS4 = 0x01010101u * (uint32_t)BIAS;
    static_assert(NT % 4 == 0, "a lane loads NT columns as 32-bit registers");

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = (blockIdx.x * WARPS + warp) * 8 * NT;
    if (col0 >= n) return;  // whole warps only; the kernel has no barrier
    const int row0 = blockIdx.y * 16 * MT;
    const int split = blockIdx.z;
    const int step0 = split * steps_per_split;
    const int step1 = min(step0 + steps_per_split, steps);
    const int bcol = col0 + NT * g;      // this lane's B columns: bcol .. bcol + NT
    const int ccol = col0 + 2 * NT * t;  // this lane's C columns: ccol .. ccol + 2 NT

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    uint32_t w[8][NW], wn[8][NW];
    auto load_step = [&](int step, uint32_t (&dst)[8][NW]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const size_t e = (size_t)(step * 32 + 8 * t + i) * n + bcol;
            load_u32<NW>(packed + (NIB ? (e >> 2) : e), dst[i]);
        }
    };

    if (step0 < step1) load_step(step0, w);
    for (int step = step0; step < step1; ++step) {
        if (step + 1 < step1) load_step(step + 1, wn);  // in flight during the MMAs

#pragma unroll 1
        for (int j = 0; j < PLANES; ++j) {
            const int kr = j * prows + step * 32;  // first weight row of this group
            if (kr >= k) break;                    // pad rows of the last plane
            const int sh = FIELD * j;

            // A fragments: 8 consecutive k per lane, rows g and g + 8 of each tile
            uint32_t a[MT][A8 ? 1 : 2][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const int ra = row0 + mt * 16 + g, rb = ra + 8;
                if constexpr (A8) {
                    const int8_t* xq = static_cast<const int8_t*>(xv);
                    uint2 va = make_uint2(0u, 0u), vb = make_uint2(0u, 0u);
                    if (ra < m) va = __ldg(reinterpret_cast<const uint2*>(xq + (size_t)ra * k + kr + 8 * t));
                    if (rb < m) vb = __ldg(reinterpret_cast<const uint2*>(xq + (size_t)rb * k + kr + 8 * t));
                    a[mt][0][0] = va.x; a[mt][0][1] = vb.x; a[mt][0][2] = va.y; a[mt][0][3] = vb.y;
                } else {
                    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(xv);
                    uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = make_uint4(0u, 0u, 0u, 0u);
                    if (ra < m) va = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)ra * k + kr + 8 * t));
                    if (rb < m) vb = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)rb * k + kr + 8 * t));
                    a[mt][0][0] = va.x; a[mt][0][1] = vb.x; a[mt][0][2] = va.y; a[mt][0][3] = vb.y;
                    a[mt][1][0] = va.z; a[mt][1][1] = vb.z; a[mt][1][2] = va.w; a[mt][1][3] = vb.w;
                }
            }

            const __nv_bfloat16* srow = scales + (size_t)(kr >> 5) * n;
            if constexpr (A8) {
                float sc[2 * NT];  // the group's scales of this lane's C columns
                load_bf16<2 * NT>(srow + ccol, sc);
                uint32_t b[NT][2];
                if constexpr (NIB) {
                    // four columns a register: centre all four bytes at once,
                    // then transpose 4 rows x 4 bytes into 4 columns x 4 rows
#pragma unroll
                    for (int r = 0; r < NW; ++r) {
                        uint32_t c[8];
#pragma unroll
                        for (int i = 0; i < 8; ++i)
                            c[i] = __vsub4((w[i][r] >> sh) & 0x0F0F0F0Fu, BIAS4);
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const uint32_t p01 = __byte_perm(c[4 * h], c[4 * h + 1], 0x5140);
                            const uint32_t p23 = __byte_perm(c[4 * h + 2], c[4 * h + 3], 0x5140);
                            const uint32_t q01 = __byte_perm(c[4 * h], c[4 * h + 1], 0x7362);
                            const uint32_t q23 = __byte_perm(c[4 * h + 2], c[4 * h + 3], 0x7362);
                            b[4 * r + 0][h] = __byte_perm(p01, p23, 0x5410);
                            b[4 * r + 1][h] = __byte_perm(p01, p23, 0x7632);
                            b[4 * r + 2][h] = __byte_perm(q01, q23, 0x5410);
                            b[4 * r + 3][h] = __byte_perm(q01, q23, 0x7632);
                        }
                    }
                } else {
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const uint32_t u = ((w[4 * h][nt] >> sh) & MASK)
                                | (((w[4 * h + 1][nt] >> sh) & MASK) << 8)
                                | (((w[4 * h + 2][nt] >> sh) & MASK) << 16)
                                | (((w[4 * h + 3][nt] >> sh) & MASK) << 24);
                            b[nt][h] = __vsub4(u, BIAS4);
                        }
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        int d[4];
                        mma_s8(d, a[mt][0], b[nt]);
                        acc[mt][nt][0] = fmaf((float)d[0], sc[nt], acc[mt][nt][0]);
                        acc[mt][nt][1] = fmaf((float)d[1], sc[NT + nt], acc[mt][nt][1]);
                        acc[mt][nt][2] = fmaf((float)d[2], sc[nt], acc[mt][nt][2]);
                        acc[mt][nt][3] = fmaf((float)d[3], sc[NT + nt], acc[mt][nt][3]);
                    }
            } else {
                float sc[NT];  // the group's scales of this lane's B columns
                load_bf16<NT>(srow + bcol, sc);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    float f[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        uint32_t u;
                        if constexpr (NIB) u = (w[i][nt / 4] >> (8 * (nt % 4) + sh)) & MASK;
                        else u = (w[i][nt] >> sh) & MASK;
                        // code * scale is exact in f32 (6 + 8 bits), so the
                        // weight is rounded once, to bf16
                        f[i] = (float)((int)u - BIAS) * sc[nt];
                    }
                    const uint32_t b0[2] = {pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3])};
                    const uint32_t b1[2] = {pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7])};
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma_bf16(acc[mt][nt], a[mt][0], b0);
                        mma_bf16(acc[mt][nt], a[mt][1], b1);
                    }
                }
            }
        }

#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < NW; ++r) w[i][r] = wn[i][r];
    }

    // C: MMA column 2t (+1) of tile nt is output column ccol + nt (+ NT), so
    // a lane's values are 2 NT consecutive floats of rows g and g + 8. With
    // one split the row scale of the a8 route is applied here, else in the
    // reduce kernel
    float* dst = out + (size_t)split * m * n;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + mt * 16 + g + 8 * h;
            if (row >= m) continue;
            const float rs = xs != nullptr ? xs[row] : 1.0f;
            float v[2 * NT];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                v[nt] = acc[mt][nt][2 * h] * rs;
                v[NT + nt] = acc[mt][nt][2 * h + 1] * rs;
            }
            float4* o = reinterpret_cast<float4*>(dst + (size_t)row * n + ccol);
#pragma unroll
            for (int q = 0; q < NT / 2; ++q)
                o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
}

// y = (sum over splits of ws[split], in split order) * xs[row] (xs may be null)
__global__ void splitk_reduce_kernel(const float4* __restrict__ ws, const float* __restrict__ xs,
                                     float4* __restrict__ y, int m, int n, int splits) {
    const size_t total4 = (size_t)m * n / 4;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total4) return;
    float4 s = ws[idx];
    for (int sp = 1; sp < splits; ++sp) {
        const float4 v = ws[sp * total4 + idx];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (xs != nullptr) {
        const float rs = xs[(idx * 4) / n];
        s.x *= rs; s.y *= rs; s.z *= rs; s.w *= rs;
    }
    y[idx] = s;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One block a row: xs = max|x| / 127 + 1e-12, xq = clip(rint(x / xs), +-127).
// IEEE division and round half to even, as the plain version computes them.
template <typename T>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                     int k) {
    __shared__ float part[8];
    const T* xr = x + (size_t)blockIdx.x * k;
    float amax = 0.0f;
    for (int c = threadIdx.x; c < k; c += 256) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = part[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) amax = fmaxf(amax, part[i]);
    const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-12f);
    int8_t* qr = xq + (size_t)blockIdx.x * k;
    for (int c = threadIdx.x; c < k; c += 256) {
        const float v = rintf(__fdiv_rn(to_f32(xr[c]), s));
        qr[c] = (int8_t)(int)fminf(fmaxf(v, -127.0f), 127.0f);
    }
    if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

// 8 consecutive elements of x as f32 (one or two 16-byte loads)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

constexpr int QUANT_THREADS = 1024;  // a row's threads: few divisions each

// The staged bodies' row quantizer (intb_matmul.cu at every m, int4_matmul.cu
// up to INT4_DECODE_ROWS rows), one block a row: quantize_rows_kernel's
// function, 8-wide loads, and it lets a dependent product start at once (the
// staged bodies wait for it before they read x; a product launched without
// the programmatic attribute starts after it as usual).
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_dependents(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int k) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    __shared__ float part[QUANT_THREADS / 32];
    const T* xr = x + (size_t)blockIdx.x * k;
    float amax = 0.0f;
    for (int c = 8 * threadIdx.x; c < k; c += 8 * QUANT_THREADS) {  // k % 32 == 0
        float f[8];
        load8(xr + c, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = part[threadIdx.x & 31];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
    const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-12f);
    int8_t* qr = xq + (size_t)blockIdx.x * k;
    for (int c = 8 * threadIdx.x; c < k; c += 8 * QUANT_THREADS) {
        float f[8];
        load8(xr + c, f);
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float v = rintf(__fdiv_rn(f[i], s));
            q[i / 4] |= (uint32_t)((int)fminf(fmaxf(v, -127.0f), 127.0f) & 0xFF) << (8 * (i % 4));
        }
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(q[0], q[1]);
    }
    if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

// Launch one product. x is bf16 for the bf16 route; for a8 it is f32 or bf16
// and is quantized into xq / xs first. `steps` = prows / 32 and `splits` must
// leave no split without a step. counts: the caller's launches by kernel,
// each added to where it is made: [0] products, [1] row quantizers, [2]
// split-k reduce kernels.
template <int BITS, bool A8>
int launch(const void* x, const void* packed, const void* scales, void* y, void* ws, void* xq,
           void* xs, int x_is_bf16, int m, int k, int n, int prows, int splits,
           cudaStream_t st, int* counts) {
    constexpr bool NIB = BITS == 0;
    const int steps = prows / 32;
    if (m < 1 || k % 32 || prows % 32 || n % (NIB ? 64 : 32) || splits < 1 || splits > steps)
        return (int)cudaErrorInvalidValue;
    const int per = (steps + splits - 1) / splits;
    if ((splits - 1) * per >= steps) return (int)cudaErrorInvalidValue;
    const void* xin = x;
    if constexpr (A8) {
        if (x_is_bf16)
            quantize_rows_kernel<<<m, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                     static_cast<int8_t*>(xq),
                                                     static_cast<float*>(xs), k);
        else
            quantize_rows_kernel<<<m, 256, 0, st>>>(static_cast<const float*>(x),
                                                     static_cast<int8_t*>(xq),
                                                     static_cast<float*>(xs), k);
        int err = (int)cudaGetLastError();
        if (err != 0) return err;
        ++counts[1];
        xin = xq;
    }
    const float* row_scale = A8 ? static_cast<const float*>(xs) : nullptr;
    float* dst = static_cast<float*>(splits > 1 ? ws : y);
    const auto* pk = static_cast<const uint32_t*>(packed);
    const auto* sc = static_cast<const __nv_bfloat16*>(scales);
    if (m <= 16) {
        constexpr int NT = NIB ? 8 : 4;
        dim3 grid((n + WARPS * 8 * NT - 1) / (WARPS * 8 * NT), 1, splits);
        packed_matmul_kernel<BITS, A8, NT, 1><<<grid, THREADS, 0, st>>>(
            xin, pk, sc, dst, splits > 1 ? nullptr : row_scale, m, k, n, prows, per, steps);
    } else {
        dim3 grid((n + WARPS * 32 - 1) / (WARPS * 32), (m + 63) / 64, splits);
        packed_matmul_kernel<BITS, A8, 4, 4><<<grid, THREADS, 0, st>>>(
            xin, pk, sc, dst, splits > 1 ? nullptr : row_scale, m, k, n, prows, per, steps);
    }
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++counts[0];
    if (splits == 1) return 0;
    const size_t total4 = (size_t)m * n / 4;
    splitk_reduce_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float4*>(ws), row_scale, static_cast<float4*>(y), m, n, splits);
    err = (int)cudaGetLastError();
    if (err == 0) ++counts[2];
    return err;
}

}  // namespace
}  // namespace packed
