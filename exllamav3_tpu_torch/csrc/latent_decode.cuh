// Decode attention (S = 1) over one shared K = V row a key, split by keys:
// the kernel that latent_attention.cu (bf16 rows) and latent_attention_quant.cu
// (packed latent, bf16 rope key) launch for a decode step of DeepSeek's latent
// (MLA) cache, and that attention_stats.cu's three DeepSeek-V4 entries launch
// with the STATS epilogue. Verify and prefill chunks (S > 1) of the latent
// entries take latent_prefill.cuh.
//
// Function: the JAX kernel _flash_kernel with one kv head whose D-channel row
// every q head reads: D = 576 for MLA (`latent`, v_from_k, d_extra: the
// latent (512) and the rope key (64)), D = 512 for DeepSeek-V4 (return_stats
// over the sliding ring, the HCA pool and the CSA rows). Scores scale * q.k;
// V the leading 512 channels of each row. Visibility: key j < total_len, j
// <= the token's position, j in the layout (paged, linear, pool: a page out
// of range hides its keys); over a ring, slot j's stored position pos[j]
// instead, 0 <= pos[j] <= p and, with a window, pos[j] > p - window. A row
// that sees no key gives 0, or under STATS (acc, m, l) = (0, -1e30, 0);
// STATS writes acc = sum exp(s - m) v, m and l = sum exp(s - m) unnormalised.
// Over the quantized storage K and V stay in their stored, rotated basis: q's
// latent is rotated per 32-channel group (H32 / sqrt(32)) and rounded to
// bf16 as the block loads it, as the plain version rotates it, and the
// output rotated back in the merge.
//
// Bound: each visible key's row once for all heads (1152 bytes a key in bf16
// MLA, 1024 at DeepSeek-V4; 64 * bits + 32 + 128 quantized), and the output.
// A row byte serves 16 to 128 heads times ~1088 channels, so the products
// keep the tensor cores.
//
// Design:
//   * Split keys. Grid (splits, head slices, B): a block holds one token's 16
//     heads of a slice, which fill one m16n8k16 A tile, over split_keys keys
//     (a multiple of LAT_TILE, sized by the host from the layout's width, the
//     grid and the card's SM count, never from the lengths on the device:
//     ops/flash_attention.py::latent_split_keys). A split that holds no key
//     the token can see stages nothing and writes the empty record.
//   * Layouts. Paged and linear rows are consecutive tokens a tile. The ring
//     and the pool (TABLE) find each key of the split first, one thread a
//     key: its storage row, or -1 where it is hidden (a slot's stored
//     position, a page out of range), into a table in shared memory; the
//     split then walks only the tiles from its first visible key to its last,
//     copies the visible rows and zeroes the others.
//   * Staging. Each split's tiles of TK keys are copied into shared memory by
//     bulk copies (the tensor memory accelerator), STAGES deep, each stage
//     with a barrier that counts its bytes in: a bf16 key row a copy (into a
//     row of D + 8 columns, an odd count of 16-byte units: ldmatrix meets no
//     bank twice), the quantized storage's words, scales and rope keys of a
//     tile one copy each (a tile's keys are consecutive tokens). Rows of keys
//     the token cannot see are set to zero instead, so that P (0) never meets
//     a NaN of an unwritten cache row. The quantized tile unpacks in shared
//     memory into exact hi + lo bf16 columns (dequant_run: the plain
//     version's f32 values), the rope key beside them (its lo columns 0).
//   * Tensor cores. Scores: q (bf16, as the module hands it over) as the A
//     operand against K, one MMA a 16-channel step (two over the quantized
//     storage: K hi and K lo); warp (kq, kh) of the 8 takes a quarter of the
//     channels, whose q fragments it loads into registers once, against
//     half of the tile's keys, so that each K element is read from shared
//     memory once; the four quarters' partial scores are added in the
//     softmax. P.V: P as hi + lo bf16 (the f32 P to ~2^-16) against V read
//     by ldmatrix.trans from the K tile in shared memory (a third MMA for V
//     lo over the quantized storage); each warp keeps 64 output channels of
//     the 16 rows in registers across the split's tiles.
//   * Merge in the same launch. Each split writes its unnormalised (acc, m,
//     l) to a workspace (a split that saw no key: m = -1e30, l = 0 and no
//     acc); the last split of a (sequence, head slice) to arrive (the
//     release-acquire arrival of async_copy.cuh at a counter it then resets)
//     weighs the splits that saw keys, adds their acc in split order (two
//     splits' loads in flight), and normalises and writes, or under STATS
//     writes (acc, m, l) as they stand: m the largest split's, l the weighted
//     sum. Under STATS a single split writes its own state straight out.
#pragma once

#include "attention_decode.cuh"

// The latent decode kernel's launches in this library, counted where they are
// made (read through exl3_latent_decode_launches; one definition across the
// sources that include this header).
inline int latent_decode_launch_count = 0;
extern "C" __attribute__((weak)) int exl3_latent_decode_launches() {
    return latent_decode_launch_count;
}

namespace {

constexpr int LAT_ROWS = 16;          // heads a block: one m16 tile
constexpr int LAT_THREADS = 256;      // 8 warps
constexpr int LAT_WARPS = LAT_THREADS / 32;
constexpr int LAT_KQ = 4;             // channel parts of the score pass (9 16-channel steps each)
constexpr int LAT_TILE = 64;          // the splits' unit of keys
constexpr int LAT_MAX_SPLITS = 32;    // splits of a (sequence, head slice)
constexpr int LAT_TK_BF16 = 64;       // keys a tile and stages: bf16 rows, one head slice
constexpr int LAT_STAGES_BF16 = 2;
constexpr int LAT_TK_BF16_SLICES = 32;  // bf16 rows, several head slices
constexpr int LAT_STAGES_BF16_SLICES = 2;
constexpr int LAT_TK_QUANT = 32;      // quantized rows
constexpr int LAT_STAGES_QUANT = 2;
constexpr int LAT_TABLE_KEYS = 2048;  // keys a split of a TABLE layout (ring, pool) at most
constexpr int LAT_D = LATENT + ROPE;  // 576 channels a key of the MLA latent cache
constexpr int KV_ROW = 512;           // DeepSeek-V4's shared K = V row (head_dim, the rope inside)
constexpr int LAT_REC = LAT_ROWS * LATENT + 2 * LAT_ROWS;  // floats of a split's record

// cp.async of 16 bytes that fills the destination with zeros instead where
// !keep (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool keep) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(keep ? 16 : 0));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// a stage's barrier: one arrival (with the bytes its copies will bring) a fill
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n .reg .pred done;\n WAIT%=:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        " @!done bra WAIT%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory in one bulk copy
// (the tensor memory accelerator), completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// two floats as a bf16 pair, each rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

// d += a (16 x 16 bf16) @ b (16 x 8 bf16), f32
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 rows of D channels, K and V alike ([c_kv | k_pe] of the MLA latent
// cache at D = 576; DeepSeek-V4's 512-wide rows); the staged tile is the K (and
// V) tile itself
template <int D_>
struct LatentBf16Rows {
    static constexpr bool QUANT = false;
    static constexpr int D = D_, LD = D + 8, UNITS = D / 8;  // staged row: LD columns, UNITS copied
    static_assert(D % 16 == 0 && UNITS % 2 == 0, "an odd count of 16-byte units a staged row");
    const __nv_bfloat16* kv;  // (., D) rows
    __host__ __device__ int stage_bytes(int tk) const { return tk * LD * 2; }
    // the tile's rows into the stage: row j < je from storage row src(j), one
    // bulk copy a row (D * 2 bytes into a row of LD columns), the warps
    // taking turns, completing on `bar`; every other row (j >= je, or src(j)
    // < 0 where GATHER) is set to zero by every thread. GATHER: src may hide
    // rows below je (the TABLE layouts), and warp 0 counts the copies the
    // barrier expects
    template <bool GATHER, class Src>
    __device__ void issue(Src src, int je, int tk, unsigned char* st, uint64_t* bar, int tid) const {
        if constexpr (GATHER) {
            if (tid < 32) {
                int copies = 0;
                for (int j0 = 0; j0 < tk; j0 += 32)
                    copies += __popc(__ballot_sync(0xffffffffu, j0 + tid < je && src(j0 + tid) >= 0));
                if (tid == 0) mbar_expect(bar, copies * D * 2);
            }
        } else if (tid == 0) {
            mbar_expect(bar, je * D * 2);
        }
        // row j from lane j % (tk / LAT_WARPS) of warp j / (tk / LAT_WARPS)
        const int rpw = tk / LAT_WARPS, lane = tid % 32, j = tid / 32 * rpw + lane;
        if (lane < rpw && j < je) {
            const long long r = src(j);
            if (!GATHER || r >= 0) bulk_copy(st + j * LD * 2, kv + r * D, D * 2, bar);
        }
        const int zr = GATHER ? 0 : je;  // the first row that may be zero
        for (int e = tid; e < (tk - zr) * UNITS; e += LAT_THREADS) {
            const int row = zr + e / UNITS;
            if (!GATHER || row >= je || src(row) < 0)
                *reinterpret_cast<uint4*>(st + (row * LD + e % UNITS * 8) * 2) = make_uint4(0u, 0u, 0u, 0u);
        }
        // GATHER zeroes rows inside the split, which a later tile's bulk copy
        // (the async proxy) may refill in this stage: order the stores before
        // it (the block barrier that ends each tile follows)
        if constexpr (GATHER) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
};

// packed latent words (16 * bits a key) with one bf16 scale per 32 channels,
// and the bf16 rope key; a stage holds the words, then the scales (16 a
// key), then the rope keys (64 a key), each stream as it lies in the cache
struct LatentQuantRows {
    static constexpr bool QUANT = true;
    static constexpr int D = LAT_D, LD = D + 8, UNITS = D / 8;
    const uint32_t* kq;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* kpe;
    int bits;
    float ca, cb;  // compander a and 1 - a; ca = 0 selects the midpoint grid
    __host__ __device__ int wld() const { return LATENT * bits / 32; }  // words a key
    __host__ __device__ int stage_bytes(int tk) const { return tk * (wld() * 4 + 32 + ROPE * 2); }
    // the tile's keys j < je from storage rows src(0) + j, each stream in one
    // bulk copy (a tile's keys are consecutive tokens) completing on `bar`;
    // keys je.. are zero
    template <bool GATHER, class Src>
    __device__ void issue(Src src, int je, int tk, unsigned char* st, uint64_t* bar, int tid) const {
        static_assert(!GATHER, "the quantized latent is paged or linear");
        const size_t tok0 = src(0);
        const int wb = wld() * 4;  // bytes of a key's words
        unsigned char* sc = st + tk * wb;
        unsigned char* pe = sc + tk * 32;
        if (tid == 0) {
            mbar_expect(bar, je * (wb + 32 + ROPE * 2));
            bulk_copy(st, kq + tok0 * wld(), je * wb, bar);
            bulk_copy(sc, ks + tok0 * 16, je * 32, bar);
            bulk_copy(pe, kpe + tok0 * ROPE, je * ROPE * 2, bar);
        }
        for (int e = tid; e < (tk - je) * wb / 16; e += LAT_THREADS)
            reinterpret_cast<uint4*>(st + je * wb)[e] = make_uint4(0u, 0u, 0u, 0u);
        for (int e = tid; e < (tk - je) * (32 + ROPE * 2) / 16; e += LAT_THREADS) {
            // the scales' 16-byte units, then the rope keys'
            uint4* z = e < (tk - je) * 2 ? reinterpret_cast<uint4*>(sc + je * 32) + e
                                         : reinterpret_cast<uint4*>(pe + je * ROPE * 2) + e - (tk - je) * 2;
            *z = make_uint4(0u, 0u, 0u, 0u);
        }
    }
    // the staged tile into hi + lo bf16 rows of LD columns: the latent
    // dequantized, the rope key copied into the hi rows (the lo rows' rope
    // columns stay 0)
    template <int BITS>
    __device__ void unpack_bits(const unsigned char* st, int tk, __nv_bfloat16* hi_s,
                                __nv_bfloat16* lo_s, int tid) const {
        const int ldw = wld();
        const uint32_t* w = reinterpret_cast<const uint32_t*>(st);
        const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(st + tk * ldw * 4);
        for (int e = tid; e < tk * (LATENT / 8); e += LAT_THREADS) {
            const int j = e / (LATENT / 8), c0 = (e % (LATENT / 8)) * 8;
            float x[8];
            dequant_run<LATENT, BITS>(w + j * ldw, __bfloat162float(sc[j * 16 + (c0 >> 5)]), c0, ca,
                                      cb, x);
            uint32_t h[4], l[4];  // bf16 pairs: hi = bf16(x), lo = bf16(x - hi), exact
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                h[i] = pack_bf16x2(x[2 * i], x[2 * i + 1]);
                l[i] = pack_bf16x2(x[2 * i] - __uint_as_float(h[i] << 16),
                                   x[2 * i + 1] - __uint_as_float(h[i] & 0xFFFF0000u));
            }
            *reinterpret_cast<uint4*>(hi_s + j * LD + c0) = make_uint4(h[0], h[1], h[2], h[3]);
            *reinterpret_cast<uint4*>(lo_s + j * LD + c0) = make_uint4(l[0], l[1], l[2], l[3]);
        }
        const uint4* pe = reinterpret_cast<const uint4*>(st + tk * (ldw * 4 + 32));
        for (int e = tid; e < tk * (ROPE / 8); e += LAT_THREADS) {
            const int j = e / (ROPE / 8), c = e % (ROPE / 8);
            *reinterpret_cast<uint4*>(hi_s + j * LD + LATENT + c * 8) = pe[e];
        }
    }
    __device__ void unpack(const unsigned char* st, int tk, __nv_bfloat16* hi_s, __nv_bfloat16* lo_s,
                           int tid) const {
        switch (bits) {  // uniform across the grid
            case 2: unpack_bits<2>(st, tk, hi_s, lo_s, tid); break;
            case 3: unpack_bits<3>(st, tk, hi_s, lo_s, tid); break;
            case 4: unpack_bits<4>(st, tk, hi_s, lo_s, tid); break;
            case 5: unpack_bits<5>(st, tk, hi_s, lo_s, tid); break;
            case 6: unpack_bits<6>(st, tk, hi_s, lo_s, tid); break;
            case 7: unpack_bits<7>(st, tk, hi_s, lo_s, tid); break;
            default: unpack_bits<8>(st, tk, hi_s, lo_s, tid); break;
        }
    }
};

// One block's shared memory, in bytes: the stages; the unpacked K tile, hi
// and lo (quantized only); q (16 rows of LD bf16); the partial scores of the
// LAT_KQ channel quarters (f32, TK + 4 a row); P hi and lo (bf16, TK + 8 a
// row); each row's m, l and alpha, and the merge's flags; the split's key
// table (TABLE layouts: LAT_TABLE_KEYS ints); each stage's barrier. The merge
// keeps its weights in the stages.
struct LatentLayout {
    int stage = 0, off_k = 0, off_q = 0, off_s = 0, off_p = 0, off_rows = 0, off_table = 0,
        off_bar = 0, bytes = 0;
    __host__ __device__ constexpr LatentLayout(int stage_bytes, bool quant, int ld, bool table,
                                               int tk, int stages) {
        stage = (stage_bytes + 127) / 128 * 128;
        off_k = stages * stage;
        off_q = off_k + (quant ? 2 * tk * ld * 2 : 0);
        off_s = off_q + LAT_ROWS * ld * 2;
        off_p = off_s + LAT_KQ * LAT_ROWS * (tk + 4) * 4;
        off_rows = off_p + 2 * LAT_ROWS * (tk + 8) * 2;
        off_table = off_rows + 4 * LAT_ROWS * 4;
        off_bar = off_table + (table ? LAT_TABLE_KEYS * 4 : 0);
        bytes = off_bar + stages * 8;
    }
};

template <class Rows, class KV, int TK, int STAGES>
__host__ __device__ LatentLayout latent_layout(const KV& kv) {
    return LatentLayout(kv.stage_bytes(TK), KV::QUANT, KV::LD, Rows::TABLE, TK, STAGES);
}

// the largest layout of a storage (the quantized one at 8 bits) and the blocks
// an SM it allows, which the launch bounds promise (at most 2)
template <class Rows, class KV, int TK, int STAGES>
struct LatentBlocks {
    static constexpr int BYTES =
        LatentLayout(KV::QUANT ? TK * (LATENT * 8 / 8 + 32 + ROPE * 2) : TK * KV::LD * 2,
                     KV::QUANT, KV::LD, Rows::TABLE, TK, STAGES).bytes;
    static constexpr int FIT = SM_SHARED / (BYTES + BLOCK_RESERVED);
    static constexpr int MIN = FIT < 2 ? FIT : 2;
    static_assert(BYTES <= BLOCK_SHARED_MAX && MIN >= 1, "shared memory of a block");
};

// Grid (splits, head slices, B). ws: per (sequence, head slice, split)
// LAT_REC floats, acc (16 x 512) then m (16) and l (16); counters: B * slices
// ints, 0 between launches. out (B, Hq, 512) f32: the normalised output, or
// under STATS acc beside m_out, l_out (B, Hq). total_lens is not read over a
// ring; window is read over a ring alone.
template <class Rows, class KV, int TK, int STAGES, bool STATS>
__global__ void __launch_bounds__(LAT_THREADS, (LatentBlocks<Rows, KV, TK, STAGES>::MIN))
latent_decode_kernel(const __nv_bfloat16* __restrict__ q, Rows rows, KV kv,
                     const int* __restrict__ qpos, const int* __restrict__ total_lens,
                     float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                     float* ws, int* counters, int Hq, float scale, int window, int split_keys) {
    constexpr bool QUANT = KV::QUANT, TABLE = Rows::TABLE;
    constexpr int D = KV::D, LD = KV::LD, UNITS = KV::UNITS;
    // score pass: warp (kq, kh) takes channel quarter kq and key half kh
    constexpr int KSTEPS = D / 16 / LAT_KQ;       // its 16-channel steps
    constexpr int NTW = TK / 16;                  // its 8-key tiles
    constexpr int LDS = TK + 4, LDP = TK + 8;
    constexpr int KPT = TK / 16;                  // softmax: keys a thread, 16 threads a row
    static_assert(LAT_KQ * 2 == LAT_WARPS && KSTEPS * LAT_KQ * 16 == D && NTW % 2 == 0 &&
                      PAGE % TK == 0 && LAT_TILE % TK == 0 && LATENT == LAT_WARPS * 64 &&
                      D >= LATENT && !(QUANT && (TABLE || STATS)),
                  "geometry");
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kq = warp >> 1, kh = warp & 1;  // the score pass's channel quarter and key half
    const int sp = blockIdx.x, slice = blockIdx.y, b = blockIdx.z;
    const int NS = gridDim.x, NH = gridDim.y;
    const int h0 = slice * LAT_ROWS, nh = min(LAT_ROWS, Hq - h0);  // this block's q heads
    const LatentLayout L = latent_layout<Rows, KV, TK, STAGES>(kv);
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Khi = reinterpret_cast<__nv_bfloat16*>(smem + L.off_k);  // quantized only
    __nv_bfloat16* Klo = Khi + TK * LD;
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.off_q);
    float* Sp = reinterpret_cast<float*>(smem + L.off_s);
    __nv_bfloat16* Ph = reinterpret_cast<__nv_bfloat16*>(smem + L.off_p);
    __nv_bfloat16* Pl = Ph + LAT_ROWS * LDP;
    float* row_m = reinterpret_cast<float*>(smem + L.off_rows);
    float* row_l = row_m + LAT_ROWS;
    float* row_a = row_l + LAT_ROWS;
    int* flag = reinterpret_cast<int*>(row_a + LAT_ROWS);  // [0] the merge's, [1..2] TABLE's key range
    int* table = reinterpret_cast<int*>(smem + L.off_table);  // TABLE: the split's keys' rows
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.off_bar);

    // the keys of this split the token can see: [k_first, k_last]
    const int split0 = sp * split_keys, p = qpos[b];
    int k_first = split0;
    int k_last = min(split0 + split_keys, rows.key_limit()) - 1;
    if constexpr (!Rows::POS_FROM_ARRAY) k_last = min(k_last, min(p, total_lens[b] - 1));
    if constexpr (TABLE) {
        // each key's storage row (-1: hidden) into the table, and the range
        // from the first visible key to the last
        if (tid == 0) {
            flag[1] = INT32_MAX;
            flag[2] = -1;
        }
        __syncthreads();
        int lo = INT32_MAX, hi = -1;
        for (int key = k_first + tid; key <= k_last; key += LAT_THREADS) {
            const int r = rows.key_row(b, key, p, window);
            table[key - split0] = r;
            if (r >= 0) {
                lo = min(lo, key);
                hi = max(hi, key);
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (lane == 0 && hi >= 0) {
            atomicMin(flag + 1, lo);
            atomicMax(flag + 2, hi);
        }
        __syncthreads();
        k_first = flag[1];
        k_last = flag[2];
    }
    float* rec = ws + ((size_t)(b * NH + slice) * NS + sp) * LAT_REC;
    // acc[nt]: rows g (e 0, 1) and g + 8 (e 2, 3), channels 64 warp + 8 nt + 2t (+1)
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

    if (k_first <= k_last) {
        const int ntiles = (k_last - k_first) / TK + 1;
        if (tid == 0) {
            for (int st = 0; st < STAGES; ++st) mbar_init(bars + st);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
        // tile i: its keys [0, je) of the split's visible range, and whether
        // it is staged at all (a paged tile's page out of range is skipped,
        // uniform across the block); TABLE: its rows from the table
        auto tile = [&](int i, size_t& tok0, int& je) {
            const int key0 = k_first + i * TK;
            if constexpr (TABLE) {
                tok0 = 0;
                je = min(TK, k_last - key0 + 1);
                return true;
            } else {
                int n;
                if (!rows.template tile<TK>(b, key0, tok0, n)) return false;
                je = min(n, k_last - key0 + 1);
                return true;
            }
        };
        auto issue = [&](int i) {  // tile i's rows into stage i % STAGES (none past the last)
            size_t tok0;
            int je;
            if (i >= ntiles || !tile(i, tok0, je)) return;
            unsigned char* st = smem + (i % STAGES) * L.stage;
            if constexpr (TABLE) {
                const int* tb = table + (k_first + i * TK - split0);
                kv.template issue<true>([&](int j) -> long long { return j < je ? tb[j] : -1; }, je,
                                        TK, st, bars + i % STAGES, tid);
            } else {
                kv.template issue<false>([&](int j) -> long long { return (long long)(tok0 + j); },
                                         je, TK, st, bars + i % STAGES, tid);
            }
        };
        // q's rows of the slice (rows past Hq zero)
        for (int e = tid; e < LAT_ROWS * UNITS; e += LAT_THREADS) {
            const int r = e / UNITS, c = e % UNITS;
            cp_async_zfill(Qs + r * LD + c * 8,
                           q + (r < nh ? ((size_t)b * Hq + h0 + r) * D + c * 8 : 0), r < nh);
        }
        cp_async_commit();
        for (int i = 0; i < STAGES - 1; ++i) issue(i);
        if constexpr (QUANT) {
            for (int e = tid; e < TK * (ROPE / 8); e += LAT_THREADS)
                *reinterpret_cast<uint4*>(Klo + (e / (ROPE / 8)) * LD + LATENT + (e % (ROPE / 8)) * 8) =
                    make_uint4(0u, 0u, 0u, 0u);
        }
        if (tid < LAT_ROWS) {
            row_m[tid] = -INFINITY;
            row_l[tid] = 0.0f;
        }
        uint32_t qa[KSTEPS][4];  // q's A fragments of this warp's channel quarter

        cp_async_wait<0>();  // q, then this warp's fragments of it
        __syncthreads();
        if constexpr (QUANT) {
            // q's latent rotated per 32-channel group (lane i holds channel i
            // of a group), rounded to bf16: a warp's two rows, 8 groups at once
            constexpr int GR = LATENT / 32;  // groups a row
#pragma unroll 1
            for (int u0 = warp * 2 * GR; u0 < (warp + 1) * 2 * GR; u0 += 8) {
                float x[8];
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    x[k] = __bfloat162float(Qs[((u0 + k) / GR) * LD + ((u0 + k) % GR) * 32 + lane]);
#pragma unroll
                for (int m = 1; m < 32; m <<= 1)
#pragma unroll
                    for (int k = 0; k < 8; ++k) {
                        const float y = __shfl_xor_sync(0xffffffffu, x[k], m);
                        x[k] = (lane & m) ? y - x[k] : x[k] + y;
                    }
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    Qs[((u0 + k) / GR) * LD + ((u0 + k) % GR) * 32 + lane] =
                        __float2bfloat16_rn(x[k] * RSQRT32);
            }
            __syncthreads();
        }
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
            ldsm_x4(qa[ks], Qs + (lane & 15) * LD + (kq * KSTEPS + ks) * 16 + (lane >> 4) * 8);
        unsigned parity = 0;  // bit s: the phase of stage s's barrier to wait for
        for (int i = 0; i < ntiles; ++i) {
            issue(i + STAGES - 1);
            size_t tok0;
            int je;  // the tile's keys [0, je) are in the visible range
            if (!tile(i, tok0, je)) continue;  // uniform across the block
            mbar_wait(bars + i % STAGES, (parity >> (i % STAGES)) & 1u);
            parity ^= 1u << (i % STAGES);
            const unsigned char* st = smem + (i % STAGES) * L.stage;
            const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(st);
            if constexpr (QUANT) {
                kv.unpack(st, TK, Khi, Klo, tid);
                __syncthreads();
                Kt = Khi;
            }

            // scores: this warp's quarter of the channels (its q fragments in
            // registers) against its half of the tile's keys, NTW 8-key tiles
            {
                float s[NTW][4];
#pragma unroll
                for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
                const int krow = kh * (TK / 2) + (lane & 7) + ((lane >> 4) << 3);
                const int kcol = kq * KSTEPS * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
                for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
                    for (int np = 0; np < NTW / 2; ++np) {  // 8-key tiles 2np, 2np + 1
                        uint32_t kb[4];
                        ldsm_x4(kb, Kt + (krow + 16 * np) * LD + kcol + ks * 16);
                        mma_16816(s[2 * np], qa[ks], kb[0], kb[1]);
                        mma_16816(s[2 * np + 1], qa[ks], kb[2], kb[3]);
                        if constexpr (QUANT) {
                            ldsm_x4(kb, Klo + (krow + 16 * np) * LD + kcol + ks * 16);
                            mma_16816(s[2 * np], qa[ks], kb[0], kb[1]);
                            mma_16816(s[2 * np + 1], qa[ks], kb[2], kb[3]);
                        }
                    }
                }
                float* sw = Sp + kq * LAT_ROWS * LDS + kh * (TK / 2) + 2 * t;
#pragma unroll
                for (int nt = 0; nt < NTW; ++nt) {
                    *reinterpret_cast<float2*>(sw + g * LDS + 8 * nt) = make_float2(s[nt][0], s[nt][1]);
                    *reinterpret_cast<float2*>(sw + (g + 8) * LDS + 8 * nt) = make_float2(s[nt][2], s[nt][3]);
                }
            }
            __syncthreads();

            // online softmax: 16 threads a row, KPT keys each; P as hi + lo bf16
            {
                const int r = tid >> 4, part = tid & 15;
                const int* tb = table + (k_first + i * TK - split0);  // TABLE only
                float sv[KPT], mx = -INFINITY;
#pragma unroll
                for (int jj = 0; jj < KPT; ++jj) {
                    const int j = part * KPT + jj;
                    float v = 0.0f;
#pragma unroll
                    for (int kp = 0; kp < LAT_KQ; ++kp) v += Sp[(kp * LAT_ROWS + r) * LDS + j];
                    const bool seen = j < je && (!TABLE || tb[j] >= 0);
                    sv[jj] = seen ? v * scale : -INFINITY;
                    mx = fmaxf(mx, sv[jj]);
                }
#pragma unroll
                for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
                const float m_old = row_m[r], m_new = fmaxf(m_old, mx);
                float sum = 0.0f;
#pragma unroll
                for (int jj = 0; jj < KPT; ++jj) {
                    const int j = part * KPT + jj;
                    const float pf = sv[jj] == -INFINITY ? 0.0f : expf(sv[jj] - m_new);
                    const __nv_bfloat16 ph = __float2bfloat16_rn(pf);
                    Ph[r * LDP + j] = ph;
                    Pl[r * LDP + j] = __float2bfloat16_rn(pf - __bfloat162float(ph));
                    sum += pf;
                }
#pragma unroll
                for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
                __syncwarp();
                if (part == 0) {
                    const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
                    row_m[r] = m_new;
                    row_l[r] = row_l[r] * alpha + sum;
                    row_a[r] = alpha;
                }
            }
            __syncthreads();

            // acc = alpha acc + P V over this warp's 64 channels
            {
                const float al0 = row_a[g], al1 = row_a[g + 8];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    acc[nt][0] *= al0;
                    acc[nt][1] *= al0;
                    acc[nt][2] *= al1;
                    acc[nt][3] *= al1;
                }
#pragma unroll
                for (int kk = 0; kk < TK; kk += 16) {
                    uint32_t ph[4], pl[4];
                    ldsm_x4(ph, Ph + (lane & 15) * LDP + kk + (lane >> 4) * 8);
                    ldsm_x4(pl, Pl + (lane & 15) * LDP + kk + (lane >> 4) * 8);
                    const int vr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
                    for (int np = 0; np < 4; ++np) {  // channel tiles 2np, 2np + 1
                        const int c = 64 * warp + 16 * np + (lane >> 4) * 8;
                        uint32_t v[4];
                        ldsm_x4_trans(v, Kt + vr * LD + c);
                        mma_16816(acc[2 * np], ph, v[0], v[1]);
                        mma_16816(acc[2 * np], pl, v[0], v[1]);
                        mma_16816(acc[2 * np + 1], ph, v[2], v[3]);
                        mma_16816(acc[2 * np + 1], pl, v[2], v[3]);
                        if constexpr (QUANT) {
                            ldsm_x4_trans(v, Klo + vr * LD + c);
                            mma_16816(acc[2 * np], ph, v[0], v[1]);
                            mma_16816(acc[2 * np + 1], ph, v[2], v[3]);
                        }
                    }
                }
            }
            __syncthreads();  // the stage, the unpacked tile, the scores and P are rewritten next
        }
    } else if (tid < LAT_ROWS) {  // no key: the empty state
        row_m[tid] = -INFINITY;
        row_l[tid] = 0.0f;
    }

    if constexpr (STATS) {
        if (NS == 1) {  // the split's own state is the result
            const size_t o0 = (size_t)b * Hq + h0;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const int c = 64 * warp + 8 * nt + 2 * t;
                if (g < nh)
                    *reinterpret_cast<float2*>(out + (o0 + g) * LATENT + c) = make_float2(acc[nt][0], acc[nt][1]);
                if (g + 8 < nh)
                    *reinterpret_cast<float2*>(out + (o0 + g + 8) * LATENT + c) =
                        make_float2(acc[nt][2], acc[nt][3]);
            }
            __syncthreads();  // the rows' state, whichever branch set it
            if (tid < nh) {
                m_out[o0 + tid] = row_m[tid] == -INFINITY ? STATS_EMPTY_M : row_m[tid];
                l_out[o0 + tid] = row_l[tid];
            }
            return;
        }
    }
    // this split's unnormalised rows, straight from the registers (none for a
    // split that saw no key)
    if (k_first <= k_last) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int c = 64 * warp + 8 * nt + 2 * t;
            *reinterpret_cast<float2*>(rec + g * LATENT + c) = make_float2(acc[nt][0], acc[nt][1]);
            *reinterpret_cast<float2*>(rec + (g + 8) * LATENT + c) = make_float2(acc[nt][2], acc[nt][3]);
        }
    }
    __syncthreads();  // the rows' state, whichever branch set it
    if (tid < LAT_ROWS) {
        rec[LAT_ROWS * LATENT + tid] = row_m[tid] == -INFINITY ? STATS_EMPTY_M : row_m[tid];
        rec[LAT_ROWS * LATENT + LAT_ROWS + tid] = row_l[tid];
    }

    // the last split of this (sequence, head slice) to finish merges
    __syncthreads();
    if (tid == 0) *flag = arrive(counters + b * NH + slice) == NS - 1;
    __syncthreads();
    if (!*flag) return;
    // every tile this block staged has landed: the stages hold the weights now
    // each split's m and l by one load a thread; then each row's weights
    // exp(m - max) take the place of m, and the splits that saw keys are
    // listed in order (a split's rows all see its keys)
    float* wm = reinterpret_cast<float*>(smem);  // [NS][16] m, then weights
    float* wl = wm + NS * LAT_ROWS;              // [NS][16] l
    int* live = reinterpret_cast<int*>(wl + NS * LAT_ROWS);  // [NS + 1]: the count, then the list
    const float* rec0 = ws + (size_t)(b * NH + slice) * NS * LAT_REC;
    for (int e = tid; e < NS * LAT_ROWS; e += LAT_THREADS) {
        const float* r2 = rec0 + (size_t)(e / LAT_ROWS) * LAT_REC + LAT_ROWS * LATENT + e % LAT_ROWS;
        wm[e] = __ldcg(r2);
        wl[e] = __ldcg(r2 + LAT_ROWS);
    }
    __syncthreads();
    if (tid < LAT_ROWS) {
        const int r = tid;
        float mg = -INFINITY;
        for (int s2 = 0; s2 < NS; ++s2) mg = fmaxf(mg, wm[s2 * LAT_ROWS + r]);
        float lg = 0.0f;
        int n_live = 0;
        for (int s2 = 0; s2 < NS; ++s2) {
            const float m2 = wm[s2 * LAT_ROWS + r];
            const bool saw = m2 > STATS_EMPTY_M / 2;
            const float c = saw ? expf(m2 - mg) : 0.0f;
            lg += wl[s2 * LAT_ROWS + r] * c;
            wm[s2 * LAT_ROWS + r] = c;
            if (r == 0 && saw) live[1 + n_live] = s2;
            n_live += saw;
        }
        if (r == 0) live[0] = n_live;
        if constexpr (STATS) {
            // the largest split's m (STATS_EMPTY_M where no split saw a key)
            if (r < nh) {
                m_out[(size_t)b * Hq + h0 + r] = mg;
                l_out[(size_t)b * Hq + h0 + r] = lg;
            }
        } else {
            row_l[r] = fmaxf(lg, 1e-30f);
        }
    }
    __syncthreads();
    // the weighted sum of those splits, in split order: a thread takes 8
    // float4 runs, rows tid / 128 + 2i, columns 4 (tid % 128) .., and asks for
    // two splits' runs at once
    const int n_live = live[0];
    float4 o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int c4 = tid % (LATENT / 4), r0 = tid / (LATENT / 4);
    auto load = [&](int s2, float4 (&v)[8]) {
        const float* a2 = rec0 + (size_t)s2 * LAT_REC + 4 * c4;
#pragma unroll
        for (int i = 0; i < 8; ++i)
            v[i] = __ldcg(reinterpret_cast<const float4*>(a2 + (r0 + 2 * i) * LATENT));
    };
    auto add = [&](int s2, const float4 (&v)[8]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float w = wm[s2 * LAT_ROWS + r0 + 2 * i];
            o[i].x = fmaf(w, v[i].x, o[i].x);
            o[i].y = fmaf(w, v[i].y, o[i].y);
            o[i].z = fmaf(w, v[i].z, o[i].z);
            o[i].w = fmaf(w, v[i].w, o[i].w);
        }
    };
    int li = 0;
    for (; li + 1 < n_live; li += 2) {
        float4 va[8], vb[8];
        load(live[1 + li], va);
        load(live[2 + li], vb);
        add(live[1 + li], va);
        add(live[2 + li], vb);
    }
    if (li < n_live) {
        float4 va[8];
        load(live[1 + li], va);
        add(live[1 + li], va);
    }
    if constexpr (QUANT) {
        // back from the rotated basis: the 32-point Hadamard of each group,
        // its channels' bits 0-1 within a thread's float4, bits 2-4 across the
        // 8 lanes that hold the group, then the 1 / sqrt(32)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float4 v = o[i];
            const float a0 = v.x + v.y, a1 = v.x - v.y, a2 = v.z + v.w, a3 = v.z - v.w;
            o[i] = make_float4(a0 + a2, a1 + a3, a0 - a2, a1 - a3);
        }
#pragma unroll
        for (int m = 1; m < 8; m <<= 1)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float4& v = o[i];
                const float4 y = make_float4(__shfl_xor_sync(0xffffffffu, v.x, m),
                                             __shfl_xor_sync(0xffffffffu, v.y, m),
                                             __shfl_xor_sync(0xffffffffu, v.z, m),
                                             __shfl_xor_sync(0xffffffffu, v.w, m));
                v = (lane & m) ? make_float4(y.x - v.x, y.y - v.y, y.z - v.z, y.w - v.w)
                               : make_float4(v.x + y.x, v.y + y.y, v.z + y.z, v.w + y.w);
            }
#pragma unroll
        for (int i = 0; i < 8; ++i)
            o[i] = make_float4(o[i].x * RSQRT32, o[i].y * RSQRT32, o[i].z * RSQRT32, o[i].w * RSQRT32);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = r0 + 2 * i;
        if (r >= nh) continue;
        const float inv = STATS ? 1.0f : 1.0f / row_l[r];
        *reinterpret_cast<float4*>(out + ((size_t)b * Hq + h0 + r) * LATENT + 4 * c4) =
            make_float4(o[i].x * inv, o[i].y * inv, o[i].z * inv, o[i].w * inv);
    }
    if (tid == 0) counters[b * NH + slice] = 0;  // ready for the next launch
}

template <class Rows, class KV, int TK, int STAGES, bool STATS>
int launch_latent_geo(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                      void* out, void* m_out, void* l_out, void* ws, void* counters, int B, int Hq,
                      int NS, float scale, int window, int split_keys, cudaStream_t st) {
    static_assert((LAT_MAX_SPLITS * (2 * LAT_ROWS + 1) + 1) * 4 <=
                      (KV::QUANT ? TK * (LATENT * 2 / 8 + 32 + ROPE * 2) : TK * KV::LD * 2),
                  "the merge's weights fit in the stages");
    auto* kernel = latent_decode_kernel<Rows, KV, TK, STAGES, STATS>;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LatentBlocks<Rows, KV, TK, STAGES>::BYTES);
        attr_set = true;
    }
    const int NH = (Hq + LAT_ROWS - 1) / LAT_ROWS;
    kernel<<<dim3(NS, NH, B), LAT_THREADS, latent_layout<Rows, KV, TK, STAGES>(kv).bytes, st>>>(
        static_cast<const __nv_bfloat16*>(q), rows, kv, static_cast<const int*>(qpos),
        static_cast<const int*>(total_lens), static_cast<float*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(ws), static_cast<int*>(counters), Hq, scale,
        window, split_keys);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++latent_decode_launch_count;
    return err;
}

// Launch on `st`; returns cudaGetLastError() as an int. key_limit: the
// layout's keys a sequence (block table width * 256, or T, or a ring's W, or a
// pool's block table width * entries a page); split_keys a multiple of
// LAT_TILE giving at most LAT_MAX_SPLITS splits (at most LAT_TABLE_KEYS keys
// over a TABLE layout); ws and counters as latent_decode_kernel takes them;
// STATS: m_out and l_out beside the unnormalised out. The tile geometry: bf16
// rows in 64-key tiles for one head slice (a block an SM), in 32-key tiles for
// several (two blocks an SM); quantized rows in 32-key tiles (measured:
// tools/torch_decode_phases.py --latent, PERF.md).
template <class Rows, class KV, bool STATS = false>
int launch_latent_decode(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                         void* out, void* ws, void* counters, int B, int Hq, float scale,
                         int split_keys, int key_limit, cudaStream_t st, int window = 0,
                         void* m_out = nullptr, void* l_out = nullptr) {
    if (Hq < 1 || ws == nullptr || counters == nullptr || split_keys < LAT_TILE ||
        split_keys % LAT_TILE || key_limit <= 0 || (Rows::TABLE && split_keys > LAT_TABLE_KEYS) ||
        (STATS && (m_out == nullptr || l_out == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int NS = (key_limit + split_keys - 1) / split_keys;
    if (NS > LAT_MAX_SPLITS) return (int)cudaErrorInvalidValue;
    if constexpr (KV::QUANT) {
        return launch_latent_geo<Rows, KV, LAT_TK_QUANT, LAT_STAGES_QUANT, STATS>(
            q, rows, kv, qpos, total_lens, out, m_out, l_out, ws, counters, B, Hq, NS, scale, window,
            split_keys, st);
    } else {
        if (Hq <= LAT_ROWS)
            return launch_latent_geo<Rows, KV, LAT_TK_BF16, LAT_STAGES_BF16, STATS>(
                q, rows, kv, qpos, total_lens, out, m_out, l_out, ws, counters, B, Hq, NS, scale,
                window, split_keys, st);
        return launch_latent_geo<Rows, KV, LAT_TK_BF16_SLICES, LAT_STAGES_BF16_SLICES, STATS>(
            q, rows, kv, qpos, total_lens, out, m_out, l_out, ws, counters, B, Hq, NS, scale, window,
            split_keys, st);
    }
}

}  // namespace
