// Decode and verify attention over the KV cache, bf16 or quantized, for few
// score rows: the kernel that paged_attention.cu, linear_attention.cu,
// paged_attention_quant.cu and linear_attention_quant.cu launch when a
// (sequence, kv head) has S * G <= DECODE_ROWS query rows (G the GQA group).
// Longer chunks take the tile loop of attention_tiles.cuh.
//
// Function: the tile loop's (the JAX kernels _flash_kernel, bf16 or with
// k_bits / v_bits > 0, and _flash_kernel_merged): scores scale * q.k in
// f32, then the softcap, masked by total_len, causality from q_positions
// and the sliding window; softmax with the per-head sinks in the
// denominator; a row that sees no key gives 0. Over the quantized storage q
// enters unrotated and the output leaves in the caller's basis: the
// per-32-channel Hadamard (H32 / sqrt(32), its own inverse) is applied to q
// as the block loads it and to the output in the merge, so K and V stay in
// their stored, rotated basis. The bf16 storage rotates nothing.
//
// Storage, the kernel's KV argument: QuantKV<D> (packed words with one bf16
// scale per 32 channels) or Bf16KV<D> (rows of D bf16). Each tile is staged
// in shared memory and read from there; only the quantized storage unpacks.
//
// Bound: decode reads every visible K/V byte once (for the quantized
// storage bits/16 of the bf16 cache's bytes plus the scales); a K/V value
// serves only the G (4..8) rows of its group, far below the operations a
// byte at which the tensor cores would set the pace. So the design spends
// its effort on filling the card and keeping the loads in flight:
//   * Split keys. The grid is (splits, Hk, B). A split covers split_keys keys
//     (a power of two from one 64-key tile: below a page it divides the
//     page, above it holds whole pages), counted by the host from the
//     layout's width (block table width * 256, or T), the grid size and the
//     card's SM count, never from the lengths on the device. A split that
//     holds no key its rows can see does no work. The host reads
//     DECODE_ROWS, DEC_TK and DEC_MAX_SPLITS from their `constexpr int`
//     lines below (ops/build.py::header_constants).
//   * One block holds all S * G rows of its (sequence, kv head), so each K/V
//     value is read (and unpacked) once. q stays f32; scores and P.V are f32
//     FMAs on the CUDA cores, which compute the f32 product the JAX kernel
//     does with no hi + lo split.
//   * Staging. A tile of TK keys (for one head, a key's row is contiguous at
//     (token * Hk + hk) * row bytes in every storage) is copied into shared
//     memory with cp.async (16 bytes a copy; 8 for the quantized words at
//     D = 64), DEC_THREADS / TK threads a key row so that a warp reads whole
//     rows, in STAGES stages: tile t + STAGES - 1 loads while tile t
//     computes. A staged row is padded to an odd count of 16-byte units, so
//     that 8 threads reading 16 bytes of 8 keys meet 8 bank groups. The
//     quantized unpack then reads shared memory: a thread takes a run of 8
//     channels of one key, one word a plane (fields_run), maps each field to
//     the midpoint grid or through the compander with unpack_tile's
//     arithmetic, and multiplies by the group's scale: the same f32 values
//     the plain version holds. A bf16 value is the top half of its f32, so
//     the bf16 score pass converts 8 channels of K exactly with shifts, and
//     P.V reads V as bf16x2 from the stage itself.
//   * Merge in the same launch. Each split writes its unnormalised (acc, m,
//     l) to a workspace the wrapper allocates, in the return_stats
//     convention (a row that saw no key: (0, -1e30, 0)). The last split of a
//     (sequence, kv head) to finish, found with a __threadfence() and an
//     atomic counter that it then resets to 0 for the next launch, merges the
//     splits that saw keys with the sinks, normalises, rotates (quantized)
//     and writes.
//
// Tile geometry, template arguments of the kernel: the quantized storage
// takes 64-key tiles in two stages (three blocks an SM at 4 rows). The bf16
// storage takes two stages of 32-key tiles at D = 128 for splits of up to
// 256 keys (three blocks an SM, where 64-key tiles fit two) and of 64-key
// tiles otherwise (a tile's softmax and barriers cost the same whatever its
// keys, so a long split walks fewer of them), chosen by measurement against
// 32- and 64-key tiles in two and three stages (tools/torch_decode_phases.py
// --storage bf16: PERF.md §6; launch_decode_bf16). The bf16 blocks an
// SM, and so the launch bounds, are reckoned from the layout's shared memory
// (DecodeBlocks).
//
// Threads (256; a tile's phases are latency-bound at 2-3 blocks an SM, so a
// block spreads each tile over 8 warps): the score pass gives a thread one
// key of the tile and every PARTS-th 8-channel run (PARTS = 256 / TK threads
// a key), whose partial scores meet in the softmax; over the quantized
// storage the same thread unpacks V for its key and runs into a f32 tile.
// The softmax takes one row a warp and writes P key by key. P.V gives a
// thread two output columns of every row over a quarter (D = 128) or an
// eighth (D = 64) of the tile's keys, with its accumulators in registers
// across tiles; the key groups' sums are added in a fixed order once, at the
// end of the split. Rows are templated as RT = 4, 8 or 32 (rows past S * G
// are zero q rows whose results are never written), so no loop branches on
// the row count.
#pragma once

#include <type_traits>

#include "attention_tiles.cuh"

// The decode kernel's launches in this library, counted where they are made,
// for a caller that checks which kernel an entry chose (read through
// exl3_decode_launches; one definition across the sources that include this
// header).
inline int decode_launch_count = 0;
extern "C" __attribute__((weak)) int exl3_decode_launches() { return decode_launch_count; }

namespace {

constexpr int DECODE_ROWS = 32;        // S * G at most (rows a block holds)
constexpr int DEC_TK = 64;             // keys a tile of the quantized storage; the splits' unit
constexpr int DEC_THREADS = 256;       // 8 warps
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_PARTS = DEC_THREADS / DEC_TK;  // threads a key in the quantized score pass
constexpr int DEC_MAX_SPLITS = 64;     // splits of a (sequence, kv head)
constexpr int BF16_BITS = 16;          // a bf16 row in DecodeLayout's terms: D / 2 words
constexpr int SM_SHARED = 233472;      // shared memory of an SM (228 KB on the H100)
constexpr int BLOCK_RESERVED = 1024;   // of it, reserved for each resident block
constexpr int BLOCK_SHARED_MAX = 232448;  // shared memory a block may have
constexpr float STATS_EMPTY_M = -1e30f;  // m of a row that saw no key
constexpr float RSQRT32 = 0.17677669529663687f;

// -- asynchronous copies --------------------------------------------------------

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stream of a tile's staging (K rows, V rows, or a row of scales):
// this thread's share of each key row, TPR threads a row and V bytes a copy,
// found once; each tile then adds only the tile's first row.
template <int V, int TPR>
struct StageStream {
    const unsigned char* src;
    int row_bytes, j, c0, ld;
    __device__ StageStream(const void* base, int row_bytes_, int Hk, int hk, int ld_, int tid)
        : row_bytes(row_bytes_), j(tid / TPR), c0((tid % TPR) * V), ld(ld_) {
        src = static_cast<const unsigned char*>(base) + ((size_t)j * Hk + hk) * row_bytes;
    }
    // rows of the n <= DEC_THREADS / TPR keys from token row tok0 into dst
    __device__ __forceinline__ void issue(size_t tok0, int n, int Hk, unsigned char* dst) const {
        if (j >= n) return;
        const unsigned char* s = src + tok0 * Hk * row_bytes;
        for (int c = c0; c < row_bytes; c += TPR * V) cp_async<V>(dst + j * ld + c, s + c);
    }
};

// -- shared memory ----------------------------------------------------------------

// words of a staged key: a multiple of 4 (16-byte rows) whose count of
// 16-byte units is odd, so that 8 threads reading 16 bytes of 8 keys meet 8
// bank groups
__host__ __device__ constexpr int staged_words(int w) {
    return ((w + 3) / 4) % 2 ? (w + 3) / 4 * 4 : (w + 3) / 4 * 4 + 4;
}

// One block's shared memory, in bytes, for head width D, RT rows, the
// widths of K and V (BF16_BITS: bf16 rows) and the tile geometry (tk keys,
// `stages` stages): the stages of (K rows, V rows, and for the quantized
// storage K scales, V scales), the unpacked V tile (quantized only: tk x
// (D + 4) f32; the merge's weights afterwards), q (RT x D f32; the P.V
// partial sums at the end), the partial scores of the DEC_THREADS / tk
// threads of a key (parts x RT x (tk + 4) f32), P (tk x RT f32, key by key),
// and the rows' state. The bf16 storage's merge keeps its weights in the
// stages.
struct DecodeLayout {
    int wk = 0, wv = 0, ldk = 0, ldv = 0, off_vw = 0, off_ks = 0, off_vs = 0, stage = 0;
    int off_vf = 0, off_q = 0, off_s = 0, off_p = 0, off_rows = 0, bytes = 0;
    __host__ __device__ constexpr DecodeLayout(int D, int RT, int k_bits, int v_bits,
                                               int tk = DEC_TK, int stages = 2) {
        const bool bf16 = k_bits == BF16_BITS;
        const int scales = bf16 ? 0 : tk * (D / 32) * 2;
        wk = D * k_bits / 32;
        wv = D * v_bits / 32;
        ldk = staged_words(wk);
        ldv = staged_words(wv);
        off_vw = tk * ldk * 4;
        off_ks = off_vw + tk * ldv * 4;
        off_vs = off_ks + scales;
        stage = (off_vs + scales + 15) / 16 * 16;
        off_vf = stages * stage;
        off_q = off_vf + (bf16 ? 0 : tk * (D + 4) * 4);
        off_s = off_q + RT * D * 4;
        off_p = off_s + DEC_THREADS / tk * RT * (tk + 4) * 4;
        off_rows = off_p + tk * RT * 4;
        bytes = off_rows + 4 * RT * 4 + 16;
    }
};

template <class KV>
struct IsBf16KV : std::false_type {};
template <int D>
struct IsBf16KV<Bf16KV<D>> : std::true_type {};

template <int D, int RT, int TK, int STAGES>
__host__ __device__ DecodeLayout layout_of(const QuantKV<D>& kv) {
    return DecodeLayout(D, RT, kv.k_bits, kv.v_bits, TK, STAGES);
}
template <int D, int RT, int TK, int STAGES>
__host__ __device__ DecodeLayout layout_of(const Bf16KV<D>&) {
    return DecodeLayout(D, RT, BF16_BITS, BF16_BITS, TK, STAGES);
}

// A block's largest shared memory and the blocks an SM its launch bounds
// promise. Registers allow three blocks at 4 rows (85 a thread), two at 8
// and one at 32 (64 accumulators and 32 scores a thread); the quantized
// storage promises those (its largest widths, (8, 8), fit fewer), the bf16
// storage no more than the SM's shared memory holds of its layout.
template <class KV, int D, int RT, int TK, int STAGES>
struct DecodeBlocks {
    static constexpr bool BF16 = IsBf16KV<KV>::value;
    static constexpr int BYTES = BF16 ? DecodeLayout(D, RT, BF16_BITS, BF16_BITS, TK, STAGES).bytes
                                      : DecodeLayout(D, RT, 8, 8, TK, STAGES).bytes;
    static constexpr int FIT = SM_SHARED / (BYTES + BLOCK_RESERVED);
    static constexpr int REGS = RT == 4 ? 3 : RT == 8 ? 2 : 1;
    static constexpr int MIN = BF16 && FIT < REGS ? FIT : REGS;
    static_assert(BYTES <= BLOCK_SHARED_MAX && MIN >= 1 && (!BF16 || MIN <= FIT),
                  "shared memory of a block");
};

// The streams that stage one tile. Quantized: packed K and V words and
// their rows of scales, four threads a key row.
template <int D, int TK, class KV>
struct TileStreams;
template <int D, int TK>
struct TileStreams<D, TK, QuantKV<D>> {
    static_assert(TK == DEC_TK, "the quantized storage's tiles");
    static constexpr int VW = D == 128 ? 16 : 8;  // bytes a copy of a word row
    StageStream<VW, DEC_PARTS> k, v;
    StageStream<D / 16, DEC_PARTS> ks, vs;
    __device__ TileStreams(const QuantKV<D>& kv, const DecodeLayout& L, int hk, int tid)
        : k(kv.kq, L.wk * 4, kv.Hk, hk, L.ldk * 4, tid),
          v(kv.vq, L.wv * 4, kv.Hk, hk, L.ldv * 4, tid),
          ks(kv.ks, D / 32 * 2, kv.Hk, hk, D / 32 * 2, tid),
          vs(kv.vs, D / 32 * 2, kv.Hk, hk, D / 32 * 2, tid) {}
    __device__ __forceinline__ void issue(size_t tok0, int n, int Hk, unsigned char* st,
                                          const DecodeLayout& L) const {
        k.issue(tok0, n, Hk, st);
        v.issue(tok0, n, Hk, st + L.off_vw);
        ks.issue(tok0, n, Hk, st + L.off_ks);
        vs.issue(tok0, n, Hk, st + L.off_vs);
    }
};
// bf16: K and V rows of 2 * D bytes, 16 bytes a copy, 256 / TK threads a row
template <int D, int TK>
struct TileStreams<D, TK, Bf16KV<D>> {
    StageStream<16, DEC_THREADS / TK> k, v;
    __device__ TileStreams(const Bf16KV<D>& kv, const DecodeLayout& L, int hk, int tid)
        : k(kv.k, D * 2, kv.Hk, hk, L.ldk * 4, tid), v(kv.v, D * 2, kv.Hk, hk, L.ldv * 4, tid) {}
    __device__ __forceinline__ void issue(size_t tok0, int n, int Hk, unsigned char* st,
                                          const DecodeLayout& L) const {
        k.issue(tok0, n, Hk, st);
        v.issue(tok0, n, Hk, st + L.off_vw);
    }
};

// -- unpack from shared memory ------------------------------------------------------

// The fields of channels c0 .. c0 + 7 (c0 a multiple of 8) of one head's
// packed words, as field() reads them. Even widths: one bit stream per group
// of 32 channels, so the run is 8 * BITS consecutive bits. Odd widths: bit
// planes in lane order; channel i0 + j of a group sits at lane p0 + j * G *
// PB0, so in every plane the run lies in one word, field j at shift j * PB0
// past the run's first.
template <int D, int BITS>
__device__ __forceinline__ void fields_run(const uint32_t* w, int c0, uint32_t (&f)[8]) {
    if constexpr (BITS == 2 || BITS == 4 || BITS == 8) {
        constexpr uint32_t MASK = (1u << BITS) - 1u;
        const int off = (c0 & 31) * BITS;
        const uint32_t* p = w + (c0 >> 5) * BITS + (off >> 5);
        if constexpr (BITS == 8) {
            const uint32_t a = p[0], b = p[1];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                f[j] = (a >> (8 * j)) & MASK;
                f[4 + j] = (b >> (8 * j)) & MASK;
            }
        } else {
            const uint32_t a = p[0] >> (off & 31);
#pragma unroll
            for (int j = 0; j < 8; ++j) f[j] = (a >> (j * BITS)) & MASK;
        }
    } else {
        constexpr int G = D / 32;
        constexpr int PB0 = BITS == 3 ? 2 : 4;
        constexpr int PB1 = (BITS == 3 || BITS == 5) ? 1 : 2;
        constexpr int PB2 = BITS == 7 ? 1 : 0;
        constexpr int J = 32 / PB0;
        const int i0 = c0 & 31, group = c0 >> 5;
        const int p0 = (i0 % J) * (G * PB0) + group * PB0 + i0 / J;
        const uint32_t w0 = w[p0 % (G * PB0)] >> ((p0 / (G * PB0)) * PB0);
        const uint32_t w1 = w[G * PB0 + p0 % (G * PB1)] >> ((p0 / (G * PB1)) * PB1);
        uint32_t w2 = 0;
        if constexpr (PB2 > 0) w2 = w[G * (PB0 + PB1) + p0 % (G * PB2)] >> ((p0 / (G * PB2)) * PB2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint32_t v = (w0 >> (j * PB0)) & ((1u << PB0) - 1u);
            v |= ((w1 >> (j * PB0)) & ((1u << PB1) - 1u)) << PB0;
            if constexpr (PB2 > 0) v |= ((w2 >> (j * PB0)) & ((1u << PB2) - 1u)) << (PB0 + PB1);
            f[j] = v;
        }
    }
}

// channels c0 .. c0 + 7 of one head dequantized: unpack_tile's values. The
// grid value (2f + 1 - N) / N comes from the float whose mantissa holds
// 2f + 1 (exact, as unpack_tile's integer conversion is), then the
// compander in the plain version's order, then the group's scale.
template <int D, int BITS>
__device__ __forceinline__ void dequant_run(const uint32_t* w, float sc, int c0, float ca, float cb,
                                            float (&x)[8]) {
    constexpr float N = (float)(1 << BITS);
    uint32_t f[8];
    fields_run<D, BITS>(w, c0, f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
        x[j] = fmaf(__uint_as_float(0x4B000001u | (f[j] << 1)), 1.0f / N, -(8388608.0f / N + 1.0f));
    if (ca > 0.0f) {  // t*(a + (1-a)*t*t), in the plain version's order
#pragma unroll
        for (int j = 0; j < 8; ++j)
            x[j] = __fmul_rn(x[j], __fadd_rn(ca, __fmul_rn(__fmul_rn(cb, x[j]), x[j])));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __fmul_rn(x[j], sc);
}

// this thread's runs (part, part + DEC_PARTS, ...) of key `kw` against the
// block's R q rows
template <int D, int RT, int BITS>
__device__ __forceinline__ void key_scores(const uint32_t* kw, const __nv_bfloat16* ksc,
                                           const float* Qs, int part, float ca, float cb,
                                           float (&sacc)[RT]) {
#pragma unroll 1
    for (int i = 0; i < D / 8 / DEC_PARTS; ++i) {
        const int c0 = (i * DEC_PARTS + part) * 8;
        float x[8];
        dequant_run<D, BITS>(kw, __bfloat162float(ksc[c0 >> 5]), c0, ca, cb, x);
#pragma unroll
        for (int r = 0; r < RT; ++r) {  // rows past R hold zeros
            const float4 a = *reinterpret_cast<const float4*>(Qs + r * D + c0);
            const float4 b = *reinterpret_cast<const float4*>(Qs + r * D + c0 + 4);
            float s = sacc[r];
            s = fmaf(a.x, x[0], s);
            s = fmaf(a.y, x[1], s);
            s = fmaf(a.z, x[2], s);
            s = fmaf(a.w, x[3], s);
            s = fmaf(b.x, x[4], s);
            s = fmaf(b.y, x[5], s);
            s = fmaf(b.z, x[6], s);
            s = fmaf(b.w, x[7], s);
            sacc[r] = s;
        }
    }
}

// this thread's runs of value row `vw` unpacked into vrow (f32)
template <int D, int BITS>
__device__ __forceinline__ void value_row(const uint32_t* vw, const __nv_bfloat16* vsc,
                                          float* vrow, int part, float ca, float cb) {
#pragma unroll 1
    for (int i = 0; i < D / 8 / DEC_PARTS; ++i) {
        const int c0 = (i * DEC_PARTS + part) * 8;
        float x[8];
        dequant_run<D, BITS>(vw, __bfloat162float(vsc[c0 >> 5]), c0, ca, cb, x);
        *reinterpret_cast<float4*>(vrow + c0) = make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(vrow + c0 + 4) = make_float4(x[4], x[5], x[6], x[7]);
    }
}

template <int D, int RT>
__device__ __forceinline__ void key_scores_any(int bits, const uint32_t* kw,
                                               const __nv_bfloat16* ksc, const float* Qs, int part,
                                               float ca, float cb, float (&sacc)[RT]) {
    switch (bits) {  // uniform across the grid
        case 2: key_scores<D, RT, 2>(kw, ksc, Qs, part, ca, cb, sacc); break;
        case 3: key_scores<D, RT, 3>(kw, ksc, Qs, part, ca, cb, sacc); break;
        case 4: key_scores<D, RT, 4>(kw, ksc, Qs, part, ca, cb, sacc); break;
        case 5: key_scores<D, RT, 5>(kw, ksc, Qs, part, ca, cb, sacc); break;
        case 6: key_scores<D, RT, 6>(kw, ksc, Qs, part, ca, cb, sacc); break;
        case 7: key_scores<D, RT, 7>(kw, ksc, Qs, part, ca, cb, sacc); break;
        default: key_scores<D, RT, 8>(kw, ksc, Qs, part, ca, cb, sacc); break;
    }
}

template <int D>
__device__ __forceinline__ void value_row_any(int bits, const uint32_t* vw,
                                              const __nv_bfloat16* vsc, float* vrow, int h,
                                              float ca, float cb) {
    switch (bits) {
        case 2: value_row<D, 2>(vw, vsc, vrow, h, ca, cb); break;
        case 3: value_row<D, 3>(vw, vsc, vrow, h, ca, cb); break;
        case 4: value_row<D, 4>(vw, vsc, vrow, h, ca, cb); break;
        case 5: value_row<D, 5>(vw, vsc, vrow, h, ca, cb); break;
        case 6: value_row<D, 6>(vw, vsc, vrow, h, ca, cb); break;
        case 7: value_row<D, 7>(vw, vsc, vrow, h, ca, cb); break;
        default: value_row<D, 8>(vw, vsc, vrow, h, ca, cb); break;
    }
}

// the 32-point Sylvester Hadamard of the warp's 32 values (lane i holds x_i):
// sum_j (-1)^popcount(i & j) x_j, unscaled
__device__ __forceinline__ float fwht32(float x, int lane) {
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, m);
        x = (lane & m) ? y - x : x + y;
    }
    return x;
}

// this thread's runs (part, part + PARTS, ...) of the staged bf16 key row
// `kr` against the block's RT q rows: each bf16 value is the top half of
// its f32, so K enters the FMAs exactly
template <int D, int RT, int PARTS>
__device__ __forceinline__ void key_scores_bf16(const __nv_bfloat16* kr, const float* Qs,
                                                int part, float (&sacc)[RT]) {
#pragma unroll
    for (int i = 0; i < D / 8 / PARTS; ++i) {
        const int c0 = (i * PARTS + part) * 8;
        const uint4 w = *reinterpret_cast<const uint4*>(kr + c0);
        const float x[8] = {__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                            __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u),
                            __uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
                            __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u)};
#pragma unroll
        for (int r = 0; r < RT; ++r) {  // rows past R hold zeros
            const float4 a = *reinterpret_cast<const float4*>(Qs + r * D + c0);
            const float4 b = *reinterpret_cast<const float4*>(Qs + r * D + c0 + 4);
            float s = sacc[r];
            s = fmaf(a.x, x[0], s);
            s = fmaf(a.y, x[1], s);
            s = fmaf(a.z, x[2], s);
            s = fmaf(a.w, x[3], s);
            s = fmaf(b.x, x[4], s);
            s = fmaf(b.y, x[5], s);
            s = fmaf(b.z, x[6], s);
            s = fmaf(b.w, x[7], s);
            sacc[r] = s;
        }
    }
}

// -- the kernel ----------------------------------------------------------------------

// Grid (splits, Hk, B). ws: per (sequence, kv head, split) R * (D + 2) floats,
// acc (R x D) then m (R) and l (R); counters: B * Hk ints, 0 between launches.
template <int D, int RT, int TK, int STAGES, class Rows, class KV>
__global__ void __launch_bounds__(DEC_THREADS, (DecodeBlocks<KV, D, RT, TK, STAGES>::MIN))
decode_kernel(const float* __restrict__ q, Rows rows, KV kv, const int* __restrict__ qpos,
              const int* __restrict__ total_lens, const float* __restrict__ sinks,
              float* __restrict__ out, float* ws, int* counters, int S, int Hq, float scale,
              int window, float softcap, int split_keys) {
    constexpr bool BF16 = IsBf16KV<KV>::value;
    constexpr int G32 = D / 32, LDV = D + 4, LDP = TK + 4;
    constexpr int PARTS = DEC_THREADS / TK;  // score pass: threads a key
    constexpr int KPL = TK / 32;             // softmax: keys a lane
    constexpr int CP = D / 2;                // P.V: column pairs,
    constexpr int KG = DEC_THREADS / CP;     // groups of keys (4 or 8)
    constexpr int KPG = TK / KG;             // and keys a group
    static_assert(KG * CP == DEC_THREADS && KPG * KG == TK && KPL * 32 == TK && RT % 4 == 0 &&
                  RT <= DECODE_ROWS && D / 8 % PARTS == 0 && PAGE % TK == 0 &&
                  DEC_TK % TK == 0 && STAGES >= 2, "geometry");
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
    const int NS = gridDim.x, Hk = gridDim.y;
    const int G = Hq / Hk, R = S * G;  // row r: token r / G, q head hk * G + r % G
    const DecodeLayout L = layout_of<D, RT, TK, STAGES>(kv);
    extern __shared__ __align__(128) unsigned char smem[];
    float* Vf = reinterpret_cast<float*>(smem + L.off_vf);  // quantized only
    float* Qs = reinterpret_cast<float*>(smem + L.off_q);
    float* Sp = reinterpret_cast<float*>(smem + L.off_s);
    float* Pt = reinterpret_cast<float*>(smem + L.off_p);
    float* row_m = reinterpret_cast<float*>(smem + L.off_rows);
    float* row_l = row_m + RT;
    float* row_alpha = row_l + RT;
    int* row_pos = reinterpret_cast<int*>(row_alpha + RT);
    int* flag = row_pos + RT;

    const int total = min(total_lens[b], rows.key_limit());
    if (tid < RT) {
        row_pos[tid] = tid < R ? qpos[(size_t)b * S + tid / G] : -1;
        row_m[tid] = -INFINITY;
        row_l[tid] = 0.0f;
    }
    __syncthreads();
    int lo = INT32_MAX, hi = -1;  // keys any row of the block can see: [lo, hi]
    for (int r = 0; r < R; ++r) {
        const int p = row_pos[r];
        if (p < 0) continue;
        hi = max(hi, min(p, total - 1));
        lo = min(lo, window > 0 ? max(p - window + 1, 0) : 0);
    }
    const int k_first = max(lo, sp * split_keys);
    const int k_last = min(hi, (sp + 1) * split_keys - 1);
    float* rec = ws + ((size_t)(b * Hk + hk) * NS + sp) * R * (D + 2);

    if (k_first <= k_last) {
        const int t0 = k_first / TK * TK;
        const int ntiles = (k_last - t0) / TK + 1;
        const int key = tid % TK, part = tid / TK;  // score pass: a key, a part of its runs
        const int cp = tid % CP, kg = tid / CP;     // P.V: a column pair, a group of keys
        float acc[RT][2];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.0f;

        const TileStreams<D, TK, KV> streams(kv, L, hk, tid);
        auto issue = [&](int i) {  // tile i's rows into stage i % STAGES (none past the last)
            size_t tok0;
            int n;
            if (i < ntiles && rows.template tile<TK>(b, t0 + i * TK, tok0, n))
                streams.issue(tok0, n, Hk, smem + (i % STAGES) * L.stage, L);
            cp_async_commit();  // an empty group past the last tile: the waits stay in step
        };
        for (int i = 0; i < STAGES - 1; ++i) issue(i);
        // q rows while the first tiles load (rows past R: zeros); over the
        // quantized storage each 32-channel group then rotated by H32 / sqrt(32)
        for (int e = tid; e < RT * (D / 4); e += DEC_THREADS) {
            const int r = e / (D / 4), c = (e % (D / 4)) * 4;
            const size_t src = (((size_t)b * S + r / G) * Hq + hk * G + r % G) * D + c;
            *reinterpret_cast<float4*>(Qs + r * D + c) =
                r < R ? *reinterpret_cast<const float4*>(q + src) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
        if constexpr (!BF16) {
            for (int u = warp; u < R * G32; u += DEC_WARPS) {
                float* x = Qs + (u / G32) * D + (u % G32) * 32 + lane;
                *x = fwht32(*x, lane) * RSQRT32;
            }
        }
        for (int i = 0; i < ntiles; ++i) {
            issue(i + STAGES - 1);
            cp_async_wait<STAGES - 1>();
            __syncthreads();
            const int key0 = t0 + i * TK;
            size_t tok0;
            int n;
            if (rows.template tile<TK>(b, key0, tok0, n)) {  // uniform across the block
                // tile keys [kb, ke) lie in this split and in [lo, hi], so they were written
                const int kb = max(k_first - key0, 0), ke = min(k_last - key0 + 1, n);
                unsigned char* st = smem + (i % STAGES) * L.stage;
                float sacc[RT];
#pragma unroll
                for (int r = 0; r < RT; ++r) sacc[r] = 0.0f;
                float* vrow = Vf + key * LDV;
                if (key >= kb && key < ke) {
                    if constexpr (BF16) {
                        key_scores_bf16<D, RT, PARTS>(
                            reinterpret_cast<const __nv_bfloat16*>(st + key * L.ldk * 4), Qs, part,
                            sacc);
                    } else {
                        key_scores_any<D, RT>(
                            kv.k_bits, reinterpret_cast<const uint32_t*>(st) + key * L.ldk,
                            reinterpret_cast<const __nv_bfloat16*>(st + L.off_ks) + key * G32, Qs,
                            part, kv.ca, kv.cb, sacc);
                        value_row_any<D>(
                            kv.v_bits,
                            reinterpret_cast<const uint32_t*>(st + L.off_vw) + key * L.ldv,
                            reinterpret_cast<const __nv_bfloat16*>(st + L.off_vs) + key * G32, vrow,
                            part, kv.ca, kv.cb);
                    }
                } else if constexpr (BF16) {  // a key no row sees here: P is 0, V must be finite
                    unsigned char* vr = st + L.off_vw + key * L.ldv * 4;
                    for (int c = part * 16; c < D * 2; c += 16 * PARTS)
                        *reinterpret_cast<uint4*>(vr + c) = make_uint4(0u, 0u, 0u, 0u);
                } else {
                    for (int c = part * 8; c < D; c += 8 * DEC_PARTS) {
                        *reinterpret_cast<float4*>(vrow + c) = make_float4(0.f, 0.f, 0.f, 0.f);
                        *reinterpret_cast<float4*>(vrow + c + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
                    }
                }
#pragma unroll
                for (int r = 0; r < RT; ++r) Sp[(part * RT + r) * LDP + key] = sacc[r];
                __syncthreads();

                // online softmax, one row a warp, KPL keys a lane; P key by key into Pt
                for (int r = warp; r < R; r += DEC_WARPS) {
                    const int p = row_pos[r];
                    float s2[KPL], mx = -INFINITY;
#pragma unroll
                    for (int jj = 0; jj < KPL; ++jj) {
                        const int j = lane + 32 * jj, kj = key0 + j;
                        float s = Sp[r * LDP + j];
#pragma unroll
                        for (int pt = 1; pt < PARTS; ++pt) s += Sp[(pt * RT + r) * LDP + j];
                        s *= scale;
                        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
                        const bool ok = j >= kb && j < ke && p >= 0 && kj <= p &&
                                        (window <= 0 || kj > p - window);
                        s2[jj] = ok ? s : -INFINITY;
                        mx = fmaxf(mx, s2[jj]);
                    }
#pragma unroll
                    for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
                    const float m_old = row_m[r], m_new = fmaxf(m_old, mx);
                    float sum = 0.0f;
#pragma unroll
                    for (int jj = 0; jj < KPL; ++jj) {
                        const float pf = s2[jj] == -INFINITY ? 0.0f : expf(s2[jj] - m_new);
                        Pt[(lane + 32 * jj) * RT + r] = pf;
                        sum += pf;
                    }
#pragma unroll
                    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
                    if (lane == 0) {
                        const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
                        row_m[r] = m_new;
                        row_l[r] = row_l[r] * alpha + sum;
                        row_alpha[r] = alpha;
                    }
                }
                __syncthreads();

                // acc = alpha acc + P V over this group's keys (P and V are 0 past
                // the live keys; rows past R carry values that are never written)
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    const float al = row_alpha[r];
                    acc[r][0] *= al;
                    acc[r][1] *= al;
                }
                const unsigned char* stv = st + L.off_vw + 4 * cp;  // bf16: V from the stage
#pragma unroll 4
                for (int jj = 0; jj < KPG; ++jj) {
                    const int j = kg * KPG + jj;
                    float2 v;
                    if constexpr (BF16)
                        v = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(stv + j * L.ldv * 4));
                    else
                        v = *reinterpret_cast<const float2*>(Vf + j * LDV + 2 * cp);
#pragma unroll
                    for (int r4 = 0; r4 < RT; r4 += 4) {
                        const float4 p = *reinterpret_cast<const float4*>(Pt + j * RT + r4);
                        acc[r4][0] = fmaf(p.x, v.x, acc[r4][0]);
                        acc[r4][1] = fmaf(p.x, v.y, acc[r4][1]);
                        acc[r4 + 1][0] = fmaf(p.y, v.x, acc[r4 + 1][0]);
                        acc[r4 + 1][1] = fmaf(p.y, v.y, acc[r4 + 1][1]);
                        acc[r4 + 2][0] = fmaf(p.z, v.x, acc[r4 + 2][0]);
                        acc[r4 + 2][1] = fmaf(p.z, v.y, acc[r4 + 2][1]);
                        acc[r4 + 3][0] = fmaf(p.w, v.x, acc[r4 + 3][0]);
                        acc[r4 + 3][1] = fmaf(p.w, v.y, acc[r4 + 3][1]);
                    }
                }
            }
            __syncthreads();  // the stage, the V tile and the scores are rewritten next
        }

        // this split's unnormalised rows: the key groups' sums, added in
        // order in Qs (q is spent), then written out
        for (int g = 0; g < KG; ++g) {
            if (kg == g) {
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    float2* o = reinterpret_cast<float2*>(Qs + r * D + 2 * cp);
                    const float2 prev = g == 0 ? make_float2(0.f, 0.f) : *o;
                    *o = make_float2(prev.x + acc[r][0], prev.y + acc[r][1]);
                }
            }
            __syncthreads();
        }
        for (int e = tid; e < R * D; e += DEC_THREADS) rec[e] = Qs[e];
        if (tid < R) {
            rec[R * D + tid] = row_m[tid] == -INFINITY ? STATS_EMPTY_M : row_m[tid];
            rec[R * D + R + tid] = row_l[tid];
        }
    }

    // the last split of this (sequence, kv head) to finish merges
    __threadfence();
    __syncthreads();
    if (tid == 0) *flag = atomicAdd(counters + b * Hk + hk, 1) == NS - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    // the splits that saw keys: those that meet [lo, hi]. Their m and l land
    // in shared memory by one load a thread, then each row's weights
    // exp(m - max) take the place of m
    const int s_lo = lo <= hi ? lo / split_keys : 0;
    const int nsp = lo <= hi ? min(hi / split_keys, NS - 1) - s_lo + 1 : 0;
    const size_t rec_stride = (size_t)R * (D + 2);
    const float* rec0 = ws + ((size_t)(b * Hk + hk) * NS + s_lo) * rec_stride;
    // m (weights after) [nsp][R], then l [nsp][R]: in the V tile, or over
    // bf16 in the stages, whose copies have all landed
    float* ml = BF16 ? reinterpret_cast<float*>(smem) : Vf;
    for (int e = tid; e < nsp * R; e += DEC_THREADS) {
        const float* r2 = rec0 + (e / R) * rec_stride + R * D + e % R;
        ml[e] = __ldcg(r2);
        ml[nsp * R + e] = __ldcg(r2 + R);
    }
    __syncthreads();
    if (tid < R) {
        const int r = tid;
        const float sink = sinks != nullptr ? sinks[hk * G + r % G] : -INFINITY;
        float mg = sink;
        for (int s2 = 0; s2 < nsp; ++s2) mg = fmaxf(mg, ml[s2 * R + r]);
        float lg = sinks != nullptr ? expf(sink - mg) : 0.0f;
        for (int s2 = 0; s2 < nsp; ++s2) {
            const float m2 = ml[s2 * R + r];
            const float c = m2 <= STATS_EMPTY_M / 2 ? 0.0f : expf(m2 - mg);
            lg += ml[(nsp + s2) * R + r] * c;
            ml[s2 * R + r] = c;
        }
        row_l[r] = fmaxf(lg, 1e-30f);
    }
    __syncthreads();
    // the weighted sum of the splits' rows into Qs (free now), then
    // normalised and written: quantized, a warp a (row, 32-channel group),
    // rotated back; bf16, element by element
    for (int e = tid; e < R * D; e += DEC_THREADS) {
        const int r = e / D;
        const float* a2 = rec0 + e;
        float o = 0.0f;
#pragma unroll 8
        for (int s2 = 0; s2 < nsp; ++s2) o = fmaf(ml[s2 * R + r], __ldcg(a2 + s2 * rec_stride), o);
        Qs[e] = o;
    }
    __syncthreads();
    if constexpr (BF16) {
        for (int e = tid; e < R * D; e += DEC_THREADS) {
            const int r = e / D, c = e % D;
            out[(((size_t)b * S + r / G) * Hq + hk * G + r % G) * D + c] = Qs[e] / row_l[r];
        }
    } else {
        for (int u = warp; u < R * G32; u += DEC_WARPS) {
            const int r = u / G32, c = (u % G32) * 32 + lane;
            const float o = fwht32(Qs[r * D + c], lane) * RSQRT32;
            out[(((size_t)b * S + r / G) * Hq + hk * G + r % G) * D + c] = o / row_l[r];
        }
    }
    if (tid == 0) counters[b * Hk + hk] = 0;  // ready for the next launch
}

// Launch on `st`; returns cudaGetLastError() as an int.
template <int D, int RT, int TK, int STAGES, class Rows, class KV>
int launch_decode_rt(const float* q, Rows rows, KV kv, const int* qpos, const int* total_lens,
                     const float* sinks, float* out, float* ws, int* counters, int B, int S,
                     int Hq, int Hk, int NS, float scale, int window, float softcap,
                     int split_keys, cudaStream_t st) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(decode_kernel<D, RT, TK, STAGES, Rows, KV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DecodeBlocks<KV, D, RT, TK, STAGES>::BYTES);
        attr_set = true;
    }
    const int bytes = layout_of<D, RT, TK, STAGES>(kv).bytes;
    decode_kernel<D, RT, TK, STAGES, Rows, KV><<<dim3(NS, Hk, B), DEC_THREADS, bytes, st>>>(
        q, rows, kv, qpos, total_lens, sinks, out, ws, counters, S, Hq, scale, window, softcap,
        split_keys);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++decode_launch_count;
    return err;
}

// The decode kernel over storage kv (QuantKV<D> or Bf16KV<D>) in tiles of TK
// keys and STAGES stages. key_limit: the layout's keys a sequence (block
// table width * 256, or T); split_keys a multiple of 64 giving at most
// DEC_MAX_SPLITS splits; ws and counters as decode_kernel takes them.
template <int D, int TK = DEC_TK, int STAGES = 2, class Rows, class KV>
int launch_decode(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                  const void* sinks, void* out, void* ws, void* counters, int B, int S, int Hq,
                  int Hk, float scale, int window, float softcap, int split_keys, int key_limit,
                  cudaStream_t st) {
    if (Hk <= 0 || Hq % Hk || S * (Hq / Hk) > DECODE_ROWS || ws == nullptr || counters == nullptr
        || split_keys < DEC_TK || split_keys % DEC_TK || key_limit <= 0)
        return (int)cudaErrorInvalidValue;
    const int NS = (key_limit + split_keys - 1) / split_keys;
    if (NS > DEC_MAX_SPLITS) return (int)cudaErrorInvalidValue;
    static_assert(!IsBf16KV<KV>::value || STAGES * DecodeLayout(D, 4, BF16_BITS, BF16_BITS, TK,
                                                                STAGES).stage >=
                                              DEC_MAX_SPLITS * DECODE_ROWS * 2 * 4,
                  "the bf16 merge's weights fit in the stages");
    const auto* qf = static_cast<const float*>(q);
    const auto* qp = static_cast<const int*>(qpos);
    const auto* tl = static_cast<const int*>(total_lens);
    const auto* sk = static_cast<const float*>(sinks);
    auto* o = static_cast<float*>(out);
    auto* w = static_cast<float*>(ws);
    auto* c = static_cast<int*>(counters);
    if (S * (Hq / Hk) <= 4)
        return launch_decode_rt<D, 4, TK, STAGES>(qf, rows, kv, qp, tl, sk, o, w, c, B, S, Hq, Hk,
                                                  NS, scale, window, softcap, split_keys, st);
    if (S * (Hq / Hk) <= 8)
        return launch_decode_rt<D, 8, TK, STAGES>(qf, rows, kv, qp, tl, sk, o, w, c, B, S, Hq, Hk,
                                                  NS, scale, window, softcap, split_keys, st);
    return launch_decode_rt<D, DECODE_ROWS, TK, STAGES>(qf, rows, kv, qp, tl, sk, o, w, c, B, S,
                                                        Hq, Hk, NS, scale, window, softcap,
                                                        split_keys, st);
}

// The decode kernel over the bf16 storage, in the tile geometry measured
// fastest for this head width and split size (see the header's comment).
template <int D, class Rows>
int launch_decode_bf16(const void* q, Rows rows, Bf16KV<D> kv, const void* qpos,
                       const void* total_lens, const void* sinks, void* out, void* ws,
                       void* counters, int B, int S, int Hq, int Hk, float scale, int window,
                       float softcap, int split_keys, int key_limit, cudaStream_t st) {
    if constexpr (D == 128) {
        if (split_keys <= 256)
            return launch_decode<D, 32, 2>(q, rows, kv, qpos, total_lens, sinks, out, ws,
                                           counters, B, S, Hq, Hk, scale, window, softcap,
                                           split_keys, key_limit, st);
    }
    return launch_decode<D, 64, 2>(q, rows, kv, qpos, total_lens, sinks, out, ws, counters, B, S,
                                   Hq, Hk, scale, window, softcap, split_keys, key_limit, st);
}

}  // namespace
