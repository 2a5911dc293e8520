// Prefill attention over the paged and the linear KV cache, bf16 or
// quantized, on Hopper's warpgroup MMAs: the body that paged_attention.cu,
// linear_attention.cu, paged_attention_quant.cu and linear_attention_quant.cu
// launch for a chunk whose (sequence, kv head) has more than DECODE_ROWS
// query rows (S * G, G the GQA group): every prompt and every verify chunk
// past 32 rows. Decode and shorter verify chunks take attention_decode.cuh;
// the latent entries take latent_decode.cuh and latent_prefill.cuh, the stats
// entries latent_decode.cuh, the ring's wider groups the tile loop of
// attention_tiles.cuh.
//
// Function: the JAX kernel's _flash_kernel in the paged and the linear
// layout, with unquantized K/V (Bf16KV) or with k_bits / v_bits > 0 in either
// storage (QuantKV: _flash_kernel's per-head words and _flash_kernel_merged's
// merged rows, the same bytes for an even width): scores scale * q.k with q
// in f32, then the softcap, masked by total_len, causality from q_positions
// (key j visible iff j <= p) and the sliding window (j > p - window); softmax
// with the per-head sinks in the denominator; a row that sees no key gives 0.
// Keys at or past the layout's end (T, or the block table's width) are never
// read, and a page out of range holds no visible key. Over the quantized
// storage K and V stay in their stored, rotated basis: the caller hands q
// rotated per 32-channel group and rotates the output back.
//
// Bound: a long chunk is bound by its 4 * D operations per visible (query,
// key) pair at the bf16 tensor-core rate (2048 tokens on 512 cached at the
// 8B geometry: 51.5 GFLOP, 0.052 ms at 989 TFLOP/s). The products keep the
// TPU kernel's f32 operands: q and P each enter as a bf16 pair hi = bf16(x),
// lo = bf16(x - hi), one MMA each (the pair holds x to about 2^-16 relative;
// dropping lo moved the error from 8e-6 to 1.45e-3), so the MMAs issue twice
// the algorithm's operations over bf16 K/V: 0.104 ms at that shape. A
// dequantized K/V value (a grid value times a bf16 scale: at most 16
// significant bits on the midpoint grid) is a hi + lo pair too, exactly, and
// a product then takes three MMAs (hi.hi, lo.hi, hi.lo; lo.lo is left out):
// three times the algorithm's operations, 0.156 ms.
//
// Design: one block per (q block, kv head and head slice, sequence), 256
// threads in two warpgroups of MMAs (the consumers; QuantKV adds 256 of a
// producer). The block holds PF_ROWS = 128 score rows, each a (token,
// head-in-group) pair (HB = min(G, 128) heads of the group and 128 / HB
// tokens), so each K/V tile a block stages serves 128 rows; warpgroup w owns
// rows 64w .. 64w + 63 throughout. (Three warpgroups of rows, 192, do not
// fit: the bf16 body holds 217-226 registers a thread at D = 128, 158-168 at
// D = 64, and 384 threads have 170 each.)
//   * q is read once, split into hi + lo and stored in shared memory in the
//     128-byte-swizzled K-major layout of wgmma's A operand (64-column
//     blocks of 64 rows x 128 bytes, 16-byte chunk c of row j at c ^ (j & 7)).
//   * Bf16KV: K/V tiles of PF_TK = 64 keys are staged by 16-byte cp.async
//     into the same swizzled layout, PF_AHEAD = 2 tiles ahead of the one
//     multiplied, in PF_STAGES = 4 stages (the tile multiplied and the one
//     whose P.V still runs hold theirs).
//   * QuantKV: two more warpgroups, the producer, keep the unpack off the
//     MMAs' warps (whose registers it would spill: the two consumer
//     warpgroups hold 200 a thread by setmaxnreg, the producer 56). A
//     tile's packed words and scale rows are staged by cp.async
//     (attention_decode.cuh's TileStreams, four threads a key row) into
//     packed slots sized from the launch's bits, two for K and two for V, a
//     producer step ahead; the producer unpacks them once a block
//     (dequant_run's values, hi + lo bf16) into the swizzled operand tiles
//     K hi, K lo, V hi, V lo, two sets of each, K of tile t and V of tile
//     t - 1 while the consumers multiply tile t - 1, handed over by a full
//     and an empty named barrier a set. The producer's arithmetic sets the
//     pace (PERF.md).
//   * Either way, a paged tile lies inside one 256-token page (64 rows at a
//     stride of Hk rows; the block reads its own block-table entry as it
//     stages the tile); a linear tile is cut at T, its rows past T zero and
//     masked. A tile out of range (a page id past the pool, a cache row past
//     N) holds zeros and is masked whole.
//   * Scores: wgmma m64n64k16 with q hi then q lo from shared memory (A)
//     against the K tile (B, K-major), and q hi against K lo, into 32 f32
//     registers a thread.
//   * Online softmax in registers, in the accumulator's row layout (a thread
//     holds rows g and g + 8 of its warp's 16, a quad shares a row), in log2
//     units (ex2.approx): the row max by two quad shuffles, the running max m
//     and a per-thread partial of the sum l (added across the quad once, at
//     the end). Only tiles that the diagonal, the window's edge or the
//     layout's end cut carry the mask: the block finds the span of tiles
//     every row sees whole at its start and walks three runs of tiles
//     (masked, whole, masked) with the mask a template argument.
//   * P.V: P hi and P lo go from the score registers straight into wgmma
//     m64nDk16's register A operand (the accumulator layout of a 64 x 16
//     piece is the A fragment's); V is the B operand read MN-major from the
//     same swizzled tile (the transposed-B form), and P hi against V lo. The
//     f32 output stays in registers for the whole loop and is rescaled there.
//   * Overlap: a tile's scores and the previous tile's P.V are issued
//     together, and the softmax of the one runs while the other's MMAs do.
//     No branch lies between a wgmma and the writes of its registers, and
//     every step is inlined (PF_INLINE), so the compiler serializes none.
//   * Tiles walked: only those between the first and the last key any row
//     of the block can see. q blocks are issued longest first (the last q
//     block at blockIdx.x 0), so the causal tail does not end on a few late
//     blocks.
//   * Epilogue: the output divided by l (at least 1e-30: 0 for a row with no
//     key and no sink) and written as f32 (B, S, Hq, D).
//
// The launches are counted where they are made (exl3_prefill_launches), so
// that a caller can check which body an entry chose.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "attention_decode.cuh"  // QuantKV's staging (TileStreams) and values (dequant_run)
#include "attention_tiles.cuh"

// The prefill body's launches in this library, over either storage (one
// definition across the sources that include this header)
inline int prefill_launch_count = 0;
extern "C" __attribute__((weak)) int exl3_prefill_launches() { return prefill_launch_count; }

namespace {

constexpr int PF_ROWS = 128;     // score rows a block: two warpgroups of 64
constexpr int PF_THREADS = 256;
constexpr int PF_TK = 64;        // keys a tile
constexpr int PF_AHEAD = 2;      // tiles staged ahead of the one multiplied
constexpr int PF_STAGES = PF_AHEAD + 2;  // and the one multiplied, and the one whose P.V runs
constexpr int PF_BLOCK_SHARED_MAX = 232448;
constexpr int PF_MISC = 64;      // bytes of the block's key range, span and tile flags
// QuantKV: two more warpgroups, the producer, stage and unpack the tiles; the
// two consumer warpgroups of the MMAs take the producer's registers
// (setmaxnreg). The block holds PF_LAUNCH_REGS a thread at launch (65536 /
// 512, a multiple of 8), and the two counts must fit in that pool, or
// setmaxnreg.inc waits forever. Consumers at 200 spill nothing; the
// producer's 56 let it unpack two runs at a time
constexpr int PF_PRODUCER = 256;
constexpr int PF_LAUNCH_REGS = 65536 / (PF_THREADS + PF_PRODUCER) / 8 * 8;
constexpr int PF_CONSUMER_REGS = 200;
constexpr int PF_PRODUCER_REGS =
    (PF_LAUNCH_REGS * (PF_THREADS + PF_PRODUCER) - PF_THREADS * PF_CONSUMER_REGS) / PF_PRODUCER /
    8 * 8;
// named barriers (0 is __syncthreads): the producer's own, and a full and an
// empty barrier for each of the two operand sets
constexpr int PF_BAR_PRODUCER = 1, PF_BAR_FULL = 2, PF_BAR_EMPTY = 4;

// Shared memory of one block, in bytes from a 1024-aligned base: q hi and q
// lo (two warpgroups x D / 64 blocks of 64 rows x 128 bytes each), then
//   * Bf16KV: PF_STAGES stages of a K tile and a V tile (PF_TK rows x D bf16
//     each). D = 128: 32 KB + 32 KB + 4 x 32 KB = 196,608 bytes (D = 64:
//     98,304).
//   * QuantKV: two buffers of the operand tiles K hi, K lo, V hi and V lo,
//     then two packed slots of K (a tile's words, then its scale rows) and
//     two of V, sized from the launch's bits. D = 128: 64 KB + 128 KB + 4 x
//     4,608 bytes at (4, 4) = 215,040; at (8, 8), the widest, 4 x 8,704:
//     231,424 (D = 64: half).
// A launch asks for that payload and the 1 KB of alignment (1,008 bytes:
// the base of dynamic shared memory is 16-byte aligned, at worst 16 past a
// 1024-byte boundary); the PF_MISC bytes of the block's key range, span of
// whole tiles and tile flags take the alignment's slack where they fit, else
// the bytes past the payload (the slack is then at most 48). So the widest
// quantized block asks for 232,432 bytes of the 232,448 it may have.
template <int D>
struct PrefillLayout {
    static constexpr int QBLK = 64 * D * 2;  // one warpgroup's 64 rows
    static constexpr int OFF_QHI = 0;
    static constexpr int OFF_QLO = OFF_QHI + 2 * QBLK;
    static constexpr int TILE = PF_TK * D * 2;
    static constexpr int OFF_STAGES = OFF_QLO + 2 * QBLK;
    static constexpr int STAGE = 2 * TILE;  // Bf16KV
    static constexpr int BF16_PAYLOAD = OFF_STAGES + PF_STAGES * STAGE;
    static constexpr int QBUF = 4 * TILE;  // QuantKV: K hi, K lo, V hi, V lo
    static constexpr int OFF_PACKED = OFF_STAGES + 2 * QBUF;
    // QuantKV: bytes of a tile's packed words at `bits`, and of its slot
    // (the words, then the scale rows)
    __host__ __device__ static constexpr int words(int bits) { return PF_TK * D * bits / 8; }
    __host__ __device__ static constexpr int slot(int bits) { return words(bits) + PF_TK * D / 16; }
    __host__ __device__ static constexpr int quant_payload(int k_bits, int v_bits) {
        return OFF_PACKED + 2 * slot(k_bits) + 2 * slot(v_bits);
    }
    __host__ __device__ static constexpr int bytes(int payload) { return payload + 1024 - 16; }
};

// byte offset of 16-byte chunk c of row j (a row of D bf16) in a
// 128-byte-swizzled tile of `rows` rows: 64-column blocks of rows x 128 bytes
__device__ __forceinline__ int sw128(int j, int c, int rows) {
    return (c >> 3) * rows * 128 + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (K-major: unused; MN-major: the stride of the
// 64-column blocks), stride byte offset 1024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo) {
    return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}
// keep reads and writes of accumulator registers on their side of a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// generic-proxy writes to shared memory (stores, cp.async) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier `id` of n threads: wait for all n, or arrive without waiting
// (a release of this thread's prior shared-memory writes)
__device__ __forceinline__ void named_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// a warpgroup's registers a thread, raised or lowered
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// on the body's lambdas: inlined whatever their size, since a call between a
// wgmma and its wait serializes the wgmmas (ptxas C7520); without it the
// quantized body's unpack left one step a function of its own
#define PF_INLINE __attribute__((always_inline))

#define PF_ACC8(a, i)                                                                       \
    "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]), "+f"(a[i + 5]), \
        "+f"(a[i + 6]), "+f"(a[i + 7])
#define PF_ACC32(a) PF_ACC8(a, 0), PF_ACC8(a, 8), PF_ACC8(a, 16), PF_ACC8(a, 24)
#define PF_ACC64(a) PF_ACC32(a), PF_ACC8(a, 32), PF_ACC8(a, 40), PF_ACC8(a, 48), PF_ACC8(a, 56)
#define PF_R32                                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PF_R64                                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PF_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : PF_ACC32(d)
        : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x N f32) += A (64 x 16, registers) . B (16 x N, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PF_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : PF_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PF_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : PF_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(full ? 16 : 0));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// QuantKV: this thread's share of a staged tile (its packed words, then its
// scale rows) unpacked into the hi and lo operand tiles (128-byte swizzled,
// K-major rows of D bf16): 8 channels of one key a run, dequant_run's values,
// hi = bf16(x), lo = bf16(x - hi), exact; keys n.. as zeros, so that a key no
// row sees gives P . V a finite 0
template <int D, int BITS>
__device__ __forceinline__ void unpack_operand(const unsigned char* st, int n, float ca, float cb,
                                               unsigned char* hi, unsigned char* lo, int tid) {
    constexpr int CPR = D / 8, W = D * BITS / 32;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(st);
    const __nv_bfloat16* scales =
        reinterpret_cast<const __nv_bfloat16*>(st + PrefillLayout<D>::words(BITS));
#pragma unroll 2
    for (int i = 0; i < PF_TK * CPR / PF_THREADS; ++i) {
        const int e = tid + i * PF_THREADS, j = e / CPR, c = e % CPR;
        uint4 h = make_uint4(0u, 0u, 0u, 0u), l = h;
        if (j < n) {
            float x[8];
            dequant_run<D, BITS>(words + j * W, __bfloat162float(scales[j * (D / 32) + (c >> 2)]),
                                 c * 8, ca, cb, x);
            uint32_t hh[4], ll[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const __nv_bfloat162 b2 = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
                const float2 bf = __bfloat1622float2(b2);
                hh[k] = bf16x2_bits(b2);
                ll[k] = bf16x2_bits(__floats2bfloat162_rn(x[2 * k] - bf.x, x[2 * k + 1] - bf.y));
            }
            h = make_uint4(hh[0], hh[1], hh[2], hh[3]);
            l = make_uint4(ll[0], ll[1], ll[2], ll[3]);
        }
        const int off = sw128(j, c, PF_TK);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
    }
}

template <int D>
__device__ __forceinline__ void unpack_operand_any(int bits, const unsigned char* st, int n,
                                                   float ca, float cb, unsigned char* hi,
                                                   unsigned char* lo, int tid) {
    switch (bits) {  // uniform across the grid
        case 2: unpack_operand<D, 2>(st, n, ca, cb, hi, lo, tid); break;
        case 3: unpack_operand<D, 3>(st, n, ca, cb, hi, lo, tid); break;
        case 4: unpack_operand<D, 4>(st, n, ca, cb, hi, lo, tid); break;
        case 5: unpack_operand<D, 5>(st, n, ca, cb, hi, lo, tid); break;
        case 6: unpack_operand<D, 6>(st, n, ca, cb, hi, lo, tid); break;
        case 7: unpack_operand<D, 7>(st, n, ca, cb, hi, lo, tid); break;
        default: unpack_operand<D, 8>(st, n, ca, cb, hi, lo, tid); break;
    }
}

// threads of a block: the two warpgroups of the MMAs, and for QuantKV the producer
template <class KV>
struct PrefillThreads {
    static constexpr int value = IsBf16KV<KV>::value ? PF_THREADS : PF_THREADS + PF_PRODUCER;
};

template <int D, class Rows, class KV, bool SOFTCAP>
__global__ void __launch_bounds__(PrefillThreads<KV>::value, 1)
prefill_kernel(const float* __restrict__ q, Rows rows, KV kv, const int* __restrict__ qpos,
               const int* __restrict__ total_lens, const float* __restrict__ sinks,
               float* __restrict__ out, int S, int Hq, int Hk, float scale, int window,
               float softcap) {
    using L = PrefillLayout<D>;
    constexpr bool QUANT = !IsBf16KV<KV>::value;
    static_assert(std::is_same<KV, Bf16KV<D>>::value || std::is_same<KV, QuantKV<D>>::value,
                  "storage");
    static_assert(!QUANT || (PF_PRODUCER == DEC_THREADS && PF_PRODUCER == PF_THREADS &&
                             PF_TK == DEC_TK),
                  "the producer stages a tile by TileStreams and unpacks it as the consumers' "
                  "threads would");
    static_assert(PF_THREADS * PF_CONSUMER_REGS + PF_PRODUCER * PF_PRODUCER_REGS <=
                      PF_LAUNCH_REGS * (PF_THREADS + PF_PRODUCER) &&
                  PF_PRODUCER_REGS >= 24, "registers of the three warpgroups");
    constexpr int NT = PrefillThreads<KV>::value;
    constexpr int CPR = D / 8;  // 16-byte chunks a row
    constexpr float LOG2E = 1.4426950408889634f;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    // QuantKV: the packed slots' bytes at this launch's bits
    int kslot = 0, vslot = 0, payload = L::BF16_PAYLOAD;
    if constexpr (QUANT) {
        kslot = L::slot(kv.k_bits);
        vslot = L::slot(kv.v_bits);
        payload = L::quant_payload(kv.k_bits, kv.v_bits);
    }
    // [0] first key any row sees, [1] last; [2, 3] the span of keys every
    // written row sees; [4] a tile of the walk is out of range; [8 + t % 4]
    // tile t is in range. In the alignment's slack where it fits
    int* misc = reinterpret_cast<int*>(smem - smem_raw >= PF_MISC ? smem_raw : smem + payload);

    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int b = blockIdx.z;
    const int G = Hq / Hk;
    const int HB = min(G, PF_ROWS);       // heads of the group in this block
    const int NH = (G + HB - 1) / HB;     // head slices of a group
    const int QT = PF_ROWS / HB;          // tokens in this block
    const int nqb = (S + QT - 1) / QT;
    const int per = Hk * NH;
    const int qb = nqb - 1 - (int)blockIdx.x / per;  // the longest q blocks first
    const int hk = ((int)blockIdx.x % per) / NH, slice = (int)blockIdx.x % NH;
    const int s0 = qb * QT;
    const int limit = rows.key_limit();
    const int total = min(total_lens[b], limit);
    // row r -> token s, q head `head`; false for a padding row
    auto row_of = [&](int r, int& s, int& head) {
        const int t = r / HB, gh = slice * HB + r % HB;
        s = s0 + t;
        head = hk * G + gh;
        return t < QT && s < S && gh < G;
    };

    if (tid == 0) {
        misc[0] = INT32_MAX;
        misc[1] = -1;
        misc[2] = -1;
        misc[3] = INT32_MAX;
        misc[4] = 0;
    }
    __syncthreads();  // misc's start values

    // this thread's two rows (g and g + 8 of its warp's 16): the keys each
    // sees, [rlo, rhi], and the running max and partial sum
    int rlo[2], rhi[2];
    float m[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = wg * 64 + warp * 16 + g + 8 * i;
        int s, head;
        const bool valid = tid < PF_THREADS && row_of(r, s, head);  // not the producer's
        const int p = valid ? qpos[(size_t)b * S + s] : -1;
        rhi[i] = p >= 0 ? min(p, total - 1) : -1;
        rlo[i] = window > 0 ? max(p - window + 1, 0) : 0;
        const bool sink = valid && sinks != nullptr;
        m[i] = sink ? sinks[head] * LOG2E : -INFINITY;  // log2 units, as the scores
        l[i] = sink && qd == 0 ? 1.0f : 0.0f;  // the sink's term, counted once a quad
        if (qd == 0 && valid) {
            if (p >= 0) {  // rows at a position bound the walk
                atomicMin(&misc[0], rlo[i]);
                atomicMax(&misc[1], rhi[i]);
            }
            atomicMax(&misc[2], rlo[i]);  // every written row bounds the full tiles
            atomicMin(&misc[3], rhi[i]);
        }
    }
    __syncthreads();
    const int lo = misc[0], hi = misc[1];
    const int t0 = hi >= 0 && hi >= lo ? lo / PF_TK : 0;
    const int ntiles = hi >= 0 && hi >= lo ? hi / PF_TK - t0 + 1 : 0;
    // a tile out of the layout's range (a page id past the pool, a cache row
    // past N) holds no visible key: such a block masks every tile
    for (int t = tid; t < ntiles; t += NT) {
        size_t tok0;
        int n;
        if (!rows.template tile<PF_TK>(b, (t0 + t) * PF_TK, tok0, n)) misc[4] = 1;
    }
    __syncthreads();
    // tiles [f0, f1) are seen whole by every written row: no mask
    int f0 = ntiles, f1 = ntiles;
    if (ntiles > 0 && !misc[4] && misc[3] >= misc[2]) {
        f0 = max(0, (misc[2] + PF_TK - 1) / PF_TK - t0);
        f1 = min(ntiles, (misc[3] + 1) / PF_TK - t0);
        if (f0 >= f1) f0 = f1 = ntiles;
    }

    // Bf16KV: tile t into stage t % PF_STAGES, a tile out of range as zeros;
    // one commit group a call
    auto issue = [&](int t) PF_INLINE {
        if constexpr (!QUANT) {
            if (t < ntiles) {
                const int st = t % PF_STAGES;
                size_t tok0 = 0;
                int n = 0;
                const bool ok = rows.template tile<PF_TK>(b, (t0 + t) * PF_TK, tok0, n);
                if (tid == 0) misc[8 + t % 4] = ok;
                const uint32_t dk = sbase + L::OFF_STAGES + st * L::STAGE;
#pragma unroll
                for (int i = 0; i < PF_TK * CPR / PF_THREADS; ++i) {
                    const int e = tid + i * PF_THREADS, j = e / CPR, c = e % CPR;
                    const bool in = ok && (Rows::FULL || j < n);
                    const size_t off = in ? ((tok0 + j) * Hk + hk) * D + c * 8 : 0;
                    const int so = sw128(j, c, PF_TK);
                    cp_async16_zfill(dk + so, kv.k + off, in);
                    cp_async16_zfill(dk + L::TILE + so, kv.v + off, in);
                }
            }
            cp_async_commit();
        }
    };
    if constexpr (!QUANT) {
#pragma unroll
        for (int t = 0; t < PF_AHEAD; ++t) issue(t);
    }
    // q rows as hi + lo bf16, swizzled: the loads first, then the stores
    if (tid < PF_THREADS) {
        constexpr int NQ = PF_ROWS * CPR / PF_THREADS;
        float4 x[NQ][2];
#pragma unroll
        for (int u = 0; u < NQ; ++u) {
            const int e = tid + u * PF_THREADS, r = e / CPR, c = e % CPR;
            int s, head;
            x[u][0] = x[u][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (row_of(r, s, head)) {
                const float4* src = reinterpret_cast<const float4*>(
                    q + (((size_t)b * S + s) * Hq + head) * D + c * 8);
                x[u][0] = src[0];
                x[u][1] = src[1];
            }
        }
#pragma unroll
        for (int u = 0; u < NQ; ++u) {
            const int e = tid + u * PF_THREADS, r = e / CPR, c = e % CPR;
            const float v[8] = {x[u][0].x, x[u][0].y, x[u][0].z, x[u][0].w,
                                x[u][1].x, x[u][1].y, x[u][1].z, x[u][1].w};
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
                const float2 hf = __bfloat1622float2(h);
                hi[i] = bf16x2_bits(h);
                lo[i] = bf16x2_bits(__floats2bfloat162_rn(v[2 * i] - hf.x, v[2 * i + 1] - hf.y));
            }
            const int off = (r / 64) * L::QBLK + sw128(r % 64, c, 64);
            *reinterpret_cast<uint4*>(smem + L::OFF_QHI + off) =
                make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(smem + L::OFF_QLO + off) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
    }

    // QuantKV: the producer (threads PF_THREADS..). Its step u (0..ntiles)
    // fills operand set u % 2, K of tile u into K buffer u % 2 and V of tile
    // u - 1 into V buffer (u - 1) % 2 (a set's two buffers were last read by
    // the consumers' step u - 2, which the set's empty barrier waits for),
    // from the packed slots that its step u - 1 had staged (K of tile u in
    // slot u % 2, V of tile u - 1 in slot (u - 1) % 2), then signals the set
    // full
    if constexpr (QUANT) {
        if (tid >= PF_THREADS) {
            setmaxnreg_dec<PF_PRODUCER_REGS>();
            const int ptid = tid - PF_THREADS;
            auto packed_k = [&](int t) { return smem + L::OFF_PACKED + (t & 1) * kslot; };
            auto packed_v = [&](int t) {
                return smem + L::OFF_PACKED + 2 * kslot + (t & 1) * vslot;
            };
            // where tiles u + 1, u and u - 1 lie (their first token row and
            // keys, 0 keys for a tile out of range or past the walk): each
            // tile is looked up once, as its K is staged
            size_t tok[3] = {0, 0, 0};
            int keys[3] = {0, 0, 0};
            auto look_up = [&](int u) PF_INLINE {
                tok[2] = tok[1];
                keys[2] = keys[1];
                tok[1] = tok[0];
                keys[1] = keys[0];
                keys[0] = 0;
                if (u < ntiles) {
                    const bool ok = rows.template tile<PF_TK>(b, (t0 + u) * PF_TK, tok[0], keys[0]);
                    if (ptid == 0) misc[8 + u % 4] = ok;
                    if (!ok) keys[0] = 0;
                }
            };
            // K of tile u (looked up last) and V of tile u - 1, unpadded rows
            // of packed words and their scale rows, into their slots: one
            // commit group. A tile out of range, or keys past a cut tile's
            // end, are not copied: the unpack writes their zeros
            auto stage = [&](int u) PF_INLINE {
                unsigned char* kst = packed_k(u);
                unsigned char* vst = packed_v(u - 1);
                const TileStreams<D, PF_TK, KV> streams(kv, D * kv.k_bits / 32,
                                                        D * kv.v_bits / 32, hk, ptid);
                streams.issue_k(tok[0], keys[0], Hk, kst, kst + L::words(kv.k_bits));
                streams.issue_v(tok[1], keys[1], Hk, vst, vst + L::words(kv.v_bits));
                cp_async_commit();
            };
            // K (value false) or V of tile t, with n keys, from its packed slot
            // into operand buffer t % 2
            auto unpack = [&](int t, int n, bool value) PF_INLINE {
                unsigned char* dst =
                    smem + L::OFF_STAGES + (t & 1) * L::QBUF + (value ? 2 * L::TILE : 0);
                const int bits = value ? kv.v_bits : kv.k_bits;
                const unsigned char* st = value ? packed_v(t) : packed_k(t);
                unpack_operand_any<D>(bits, st, n, kv.ca, kv.cb, dst, dst + L::TILE, ptid);
            };
            if (ntiles > 0) {
                look_up(0);
                stage(0);
                for (int u = 0; u <= ntiles; ++u) {
                    cp_async_wait<0>();
                    named_sync(PF_BAR_PRODUCER, PF_PRODUCER);  // step u - 1's reads are done
                    look_up(u + 1);  // now tiles u + 1, u, u - 1
                    stage(u + 1);
                    if (u >= 2) named_sync(PF_BAR_EMPTY + (u & 1), NT);
                    if (u < ntiles) unpack(u, keys[1], false);
                    if (u >= 1) unpack(u - 1, keys[2], true);
                    fence_proxy_async();
                    named_arrive(PF_BAR_FULL + (u & 1), NT);
                }
                cp_async_wait<0>();
            }
            return;
        }
        setmaxnreg_inc<PF_CONSUMER_REGS>();
    }

    constexpr int NO = D / 2;  // output registers a thread
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    const uint32_t sq = sbase + L::OFF_QHI + wg * L::QBLK;
    const uint64_t dq_hi = sw128_desc(sq, 16), dq_lo = sw128_desc(sq + (L::OFF_QLO - L::OFF_QHI), 16);
    // the K tile of tile t (its V tile TILE past it; QuantKV: K hi, K lo, V
    // hi, V lo in turn)
    auto k_tile = [&](int t) {
        return sbase + L::OFF_STAGES + (QUANT ? (t & 1) * L::QBUF : (t % PF_STAGES) * L::STAGE);
    };
    auto v_tile = [&](int t) { return k_tile(t) + (QUANT ? 2 : 1) * L::TILE; };

    // scores of tile t: q hi . K + q lo . K (+ q hi . K lo), k steps of 16
    // channels
    auto scores = [&](float(&sc)[32], int t) PF_INLINE {
        const uint64_t dk = sw128_desc(k_tile(t), 16);
        const uint64_t dkl = sw128_desc(k_tile(t) + L::TILE, 16);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t off = (uint64_t)(((kk >> 2) * 64 * 128 + (kk & 3) * 32) >> 4);
            wgmma_ss_n64(sc, dq_hi + off, dk + off, kk > 0 ? 1 : 0);
            wgmma_ss_n64(sc, dq_lo + off, dk + off, 1);
            if constexpr (QUANT) wgmma_ss_n64(sc, dq_hi + off, dkl + off, 1);
        }
    };
    // O += P hi . V + P lo . V (+ P hi . V lo) over tile t, k steps of 16 keys
    auto pv = [&](const uint32_t(&ph)[4][4], const uint32_t(&pl)[4][4], int t) PF_INLINE {
        const uint64_t dv = sw128_desc(v_tile(t), PF_TK * 128);
        const uint64_t dvl = sw128_desc(v_tile(t) + L::TILE, PF_TK * 128);
#pragma unroll
        for (int kk = 0; kk < PF_TK / 16; ++kk) {
            const uint64_t off = (uint64_t)((kk * 16 * 128) >> 4);
            wgmma_rs(o, ph[kk], dv + off);
            wgmma_rs(o, pl[kk], dv + off);
            if constexpr (QUANT) wgmma_rs(o, ph[kk], dvl + off);
        }
    };
    // online softmax over the scores of tile t: sc becomes P (f32), alpha the
    // rows' rescale. Element 4j + e is row g + 8 (e >> 1), key 8j + 2qd +
    // (e & 1); scores are kept in log2 units. MASKED: the tile is cut by a
    // row's visible span or lies out of range
    const float scale_log2 = scale * LOG2E;
    auto softmax = [&](float(&sc)[32], int t, float(&alpha)[2], auto masked) PF_INLINE {
        const int key0 = (t0 + t) * PF_TK;
        const bool tile_ok = misc[8 + t % 4];
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float s;
                if constexpr (SOFTCAP)
                    s = tanhf(sc[4 * j + e] * scale / softcap) * softcap * LOG2E;
                else
                    s = sc[4 * j + e] * scale_log2;
                if constexpr (decltype(masked)::value) {
                    const int key = key0 + 8 * j + 2 * qd + (e & 1), i = e >> 1;
                    s = tile_ok && key >= rlo[i] && key <= rhi[i] ? s : -INFINITY;
                }
                sc[4 * j + e] = s;
                mx[e >> 1] = fmaxf(mx[e >> 1], s);
            }
        }
        float mb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m[i], mx[i]);
            alpha[i] = m[i] == -INFINITY ? 0.0f : ex2(m[i] - m_new);
            mb[i] = m_new == -INFINITY ? 0.0f : m_new;
            m[i] = m_new;
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2(sc[4 * j + e] - mb[e >> 1]);
                l[e >> 1] += p;
                sc[4 * j + e] = p;
            }
        }
    };
    // P hi and lo as the A fragments of the P.V product's 4 k steps
    auto pack = [&](const float(&sc)[32], uint32_t(&ph)[4][4], uint32_t(&pl)[4][4]) PF_INLINE {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float p0 = sc[4 * j + 2 * i], p1 = sc[4 * j + 2 * i + 1];
                const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
                const float2 hf = __bfloat1622float2(h);
                ph[j >> 1][2 * (j & 1) + i] = bf16x2_bits(h);
                pl[j >> 1][2 * (j & 1) + i] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
            }
        }
    };
    auto rescale = [&](const float(&alpha)[2]) PF_INLINE {
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
        }
    };
    // tile t's operands are in shared memory for every consumer thread.
    // Bf16KV: its stage has landed, and the stage tile t + PF_AHEAD takes is
    // free (its tile's P.V has completed). QuantKV: the producer has filled
    // set t % 2 (K of tile t, V of tile t - 1)
    auto ready = [&](int t) PF_INLINE {
        if constexpr (QUANT) {
            fence_proxy_async();  // q's stores, before the first tile
            named_sync(PF_BAR_FULL + (t & 1), NT);
        } else {
            cp_async_wait<PF_AHEAD - 1>();
            fence_proxy_async();
            __syncthreads();
        }
    };
    // QuantKV: tile t's products have completed; set t % 2 goes back to the
    // producer if it fills it again
    auto done = [&](int t) PF_INLINE {
        if constexpr (QUANT) {
            if (t + 2 <= ntiles) named_arrive(PF_BAR_EMPTY + (t & 1), NT);
        }
    };

    uint32_t ph[4][4], pl[4][4];
    float sc[32], alpha[2];
    // one tile after the first: the scores of tile t and the P.V of tile t - 1
    // in flight together, the softmax of t running while the P.V does; free
    // of branches that write a wgmma's registers between the wgmma and its
    // wait (masking is by template), so that the compiler serializes no wgmma
    auto step = [&](int t, auto masked) PF_INLINE {
        ready(t);
        wgmma_fence();
        scores(sc, t);
        wgmma_commit();
        pv(ph, pl, t - 1);
        wgmma_commit();
        issue(t + PF_AHEAD);  // Bf16KV: the copies go out while the products run
        wgmma_wait<1>();
        fence_regs(sc);
        softmax(sc, t, alpha, masked);
        wgmma_wait<0>();
        fence_regs(o);
        done(t);
        rescale(alpha);
        pack(sc, ph, pl);
    };
    using Masked = std::true_type;
    using Whole = std::false_type;
    if (ntiles > 0) {
        ready(0);  // the first tile: no P.V before it, none to rescale
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        wgmma_fence();
        scores(sc, 0);
        wgmma_commit();
        issue(PF_AHEAD);
        wgmma_wait<0>();
        fence_regs(sc);
        done(0);
        softmax(sc, 0, alpha, Masked{});
        pack(sc, ph, pl);
        int t = 1;
        for (; t < f0; ++t) step(t, Masked{});
        for (; t < f1; ++t) step(t, Whole{});
        for (; t < ntiles; ++t) step(t, Masked{});
        if constexpr (QUANT) ready(ntiles);  // V of the last tile
        wgmma_fence();  // the last tile's P.V
        pv(ph, pl, ntiles - 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float sum = l[i];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = wg * 64 + warp * 16 + g + 8 * i;
        int s, head;
        if (!row_of(r, s, head)) continue;
        const float den = fmaxf(sum, 1e-30f);
        float* dst = out + (((size_t)b * S + s) * Hq + head) * D + 2 * qd;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
    }
}

#undef PF_ACC8
#undef PF_ACC32
#undef PF_ACC64
#undef PF_R32
#undef PF_R64
#undef PF_INLINE

// The bytes a launch over this storage asks for, and the most any launch of
// the kernel may ask (QuantKV: at (8, 8))
template <int D>
int prefill_bytes(const Bf16KV<D>&) {
    return PrefillLayout<D>::bytes(PrefillLayout<D>::BF16_PAYLOAD);
}
template <int D>
int prefill_bytes(const QuantKV<D>& kv) {
    return PrefillLayout<D>::bytes(PrefillLayout<D>::quant_payload(kv.k_bits, kv.v_bits));
}
template <class KV>
struct PrefillMaxBytes;
template <int D>
struct PrefillMaxBytes<Bf16KV<D>> {
    static constexpr int value = PrefillLayout<D>::bytes(PrefillLayout<D>::BF16_PAYLOAD);
};
template <int D>
struct PrefillMaxBytes<QuantKV<D>> {
    static constexpr int value = PrefillLayout<D>::bytes(PrefillLayout<D>::quant_payload(8, 8));
};

template <int D, class Rows, class KV, bool SOFTCAP>
int launch_prefill_v(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                     const void* sinks, void* out, int B, int S, int Hq, int Hk, float scale,
                     int window, float softcap, cudaStream_t st) {
    constexpr int BYTES = PrefillMaxBytes<KV>::value;  // the most a launch asks
    static_assert(BYTES <= PF_BLOCK_SHARED_MAX, "shared memory of one block");
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(prefill_kernel<D, Rows, KV, SOFTCAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
        attr_set = true;
    }
    const int G = Hq / Hk, HB = G < PF_ROWS ? G : PF_ROWS;
    const int QT = PF_ROWS / HB, NH = (G + HB - 1) / HB;
    dim3 grid((S + QT - 1) / QT * Hk * NH, 1, B);
    constexpr int THREADS = PrefillThreads<KV>::value;
    prefill_kernel<D, Rows, KV, SOFTCAP><<<grid, THREADS, prefill_bytes(kv), st>>>(
        static_cast<const float*>(q), rows, kv, static_cast<const int*>(qpos),
        static_cast<const int*>(total_lens), static_cast<const float*>(sinks),
        static_cast<float*>(out), S, Hq, Hk, scale, window, softcap);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++prefill_launch_count;
    return err;
}

// Launch on `st` over kv (Bf16KV<D>, or QuantKV<D> with q rotated per
// 32-channel group and the output left in V's rotated basis); returns
// cudaGetLastError() as an int.
template <int D, class Rows, class KV>
int launch_prefill(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                   const void* sinks, void* out, int B, int S, int Hq, int Hk, float scale,
                   int window, float softcap, cudaStream_t st) {
    static_assert(D == 64 || D == 128, "head width");
    static_assert(PF_TK * (D / 8) % PF_THREADS == 0 && PAGE % PF_TK == 0, "tile geometry");
    if (Hk <= 0 || Hq % Hk || S <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (softcap > 0.0f)
        return launch_prefill_v<D, Rows, KV, true>(q, rows, kv, qpos, total_lens, sinks, out, B,
                                                   S, Hq, Hk, scale, window, softcap, st);
    return launch_prefill_v<D, Rows, KV, false>(q, rows, kv, qpos, total_lens, sinks, out, B, S,
                                                Hq, Hk, scale, window, softcap, st);
}

}  // namespace
