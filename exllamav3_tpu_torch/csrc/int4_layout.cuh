// The limits and the shared-memory layout of the staged int4 body, both
// routes (csrc/int4_matmul.cu, up to INT4_DECODE_ROWS rows), in plain C++ so that
// host code reads them from here alone: ops/q_matmul.py reads the constants
// through ops/build.py::header_constants, and tests/test_torch_int4_split.py
// compiles this header with a host compiler to hold the sizing's reckoning
// of a block's shared memory to int4_decode_smem.
#pragma once

#ifdef __CUDACC__
#define INT4_HD __host__ __device__
#else
#define INT4_HD
#endif

constexpr int INT4_WARPS = 4;          // warps a block, 32 columns each
constexpr int INT4_STEP_ROWS = 128;    // packed rows a k step: 4 scale groups of each plane
constexpr int INT4_STAGES = 3;         // steps of bytes and scales each warp stages
constexpr int INT4_BLOCKS = 3;         // blocks an SM the launch bounds promise
constexpr int INT4_DECODE_ROWS = 16;   // rows the staged body takes
constexpr int INT4_MAX_SMEM = 231424;  // dynamic shared memory a block may ask for (the
                                       // card's 232448 less room for static shared memory)
// the product is a programmatic dependent of the row quantizer up to this k
// (measured: it gains 1-2 us at k = 4096 and loses 1.4 us at k = 14336)
constexpr int INT4_PDL_MAX_K = 8192;

// Shared memory of a block: each warp's INT4_STAGES stages, a stage the bytes
// of one step (128 packed rows of the warp's 32 columns, INT4_BYTE_STAGE
// bytes) and its group scales (2 planes x 4 groups x 32 bf16,
// INT4_SCALE_STAGE bytes); then x: 8 or 16 rows of 2 planes x `per` steps x
// 128 k, int8 on the a8 route and bf16 on the bf16 route, each row rounded up
// to INT4_X_ALIGN bytes and padded by INT4_X_PAD (int8) or INT4_X_PAD_BF16
// (bf16) bytes, so that the lanes' fragment reads meet no bank twice; then,
// on the a8 route, the row sums of each (plane, group) of the split,
// INT4_X_SUMS bytes a group (16 ints).
constexpr int INT4_BYTE_STAGE = 4096;
constexpr int INT4_SCALE_STAGE = 512;
constexpr int INT4_X_ALIGN = 128;
constexpr int INT4_X_PAD = 32;
constexpr int INT4_X_PAD_BF16 = 64;
constexpr int INT4_X_SUMS = 64;
static_assert(INT4_BYTE_STAGE == INT4_STEP_ROWS * 32 && INT4_SCALE_STAGE == 2 * 4 * 32 * 2 &&
                  INT4_STEP_ROWS == 4 * 32 && INT4_X_SUMS == 16 * 4,
              "a stage is 128 rows of 32 bytes and 8 rows of 32 scales; 16 row sums a group");

namespace {

INT4_HD constexpr int int4_stage_bytes() { return INT4_BYTE_STAGE + INT4_SCALE_STAGE; }
INT4_HD constexpr int int4_x_ld(int per, bool a8) {
    return (2 * per * INT4_STEP_ROWS * (a8 ? 1 : 2) + INT4_X_ALIGN - 1) / INT4_X_ALIGN * INT4_X_ALIGN +
           (a8 ? INT4_X_PAD : INT4_X_PAD_BF16);
}
INT4_HD constexpr int int4_smem_bytes(int per, int rows, bool a8) {
    return INT4_WARPS * INT4_STAGES * int4_stage_bytes() + rows * int4_x_ld(per, a8) +
           (a8 ? 2 * per * 4 * INT4_X_SUMS : 0);
}

// the staged body's shared memory for these widths (kh = k / 2 packed rows,
// k split `splits` ways) on the a8 or the bf16 route, or 0 for a split count
// that leaves a split without a step or asks for more than INT4_MAX_SMEM
inline int int4_decode_smem(int m, int kh, int splits, bool a8) {
    const int steps = (kh + INT4_STEP_ROWS - 1) / INT4_STEP_ROWS;
    if (splits < 1 || splits > steps) return 0;
    const int smem = int4_smem_bytes((steps + splits - 1) / splits, m <= 8 ? 8 : 16, a8);
    return smem <= INT4_MAX_SMEM ? smem : 0;
}

}  // namespace
