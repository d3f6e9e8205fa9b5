// PTX helpers of the attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_static_int8.cu) and of gemm_mma.cuh: cp.async copies into a
// shared-memory ring, ldmatrix fragment loads (int8 rows read as b16 units),
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and m16n8k32 (int8 in,
// int32 accumulate) and ex2.approx, plus the fragment patterns of head dim
// 32 staged at a pitch of ATT_LDT bf16.
//
// Staged rows are 32 bf16 padded to 40 (80 bytes), so the 8 row addresses
// of an ldmatrix fall on 8 distinct groups of 4 banks: conflict-free.
#pragma once

#include "common.cuh"

namespace vit {

constexpr int ATT_D = 32;             // head dim
constexpr int ATT_LDT = ATT_D + 8;    // bf16 pitch of a staged row

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; zero-fill (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

// ROWS rows of a (row, 32) bf16 matrix (rows row0.. of src, row stride sn)
// into dst at pitch ATT_LDT by a block of THREADS, zero past nrows: thread
// tid copies 16-byte chunk tid % 4 of rows tid / 4 + (THREADS / 4)·i
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long sn, int row0, int nrows,
                                          int tid) {
    const int cv = tid & 3;
#pragma unroll
    for (int i = 0; i < (ROWS * 4 + THREADS - 1) / THREADS; ++i) {
        const int r = (tid >> 2) + (THREADS / 4) * i;
        if (r < ROWS) {
            const bool ok = row0 + r < nrows;
            cp_async16(dst + r * ATT_LDT + cv * 8,
                       ok ? src + (row0 + r) * sn + cv * 8 : src, ok);
        }
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 × 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of the
// i-th, register i receives it (.trans: transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

// c (16 × 8 fp32) += a (16 × 16 bf16, row) · b (16 × 8 bf16, col).
// Lane l, g = l / 4, t = l % 4: a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g), (k 2t+8.., n g)}; c = {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.x4 over int8 rows (read as b16 units)
__device__ __forceinline__ void ldsm_x4_s8(uint32_t (&r)[4],
                                           const signed char* p) {
    ldsm_x4(r, reinterpret_cast<const bf16*>(p));
}

// c (16 × 8 s32) += a (16 × 32 s8, row) · b (32 × 8 s8, col).  Lane l, g =
// l / 4, t = l % 4: a = {(g, 4t..4t+3), (g+8, 4t..), (g, 16+4t..), (g+8,
// 16+4t..)}; b = {(k 4t..4t+3, n g), (k 16+4t.., n g)}; c as mma()'s
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// 2^x on the special-function unit: exp2f minus its denormal path (a
// result below 2^-126 flushes to 0); ex2(-inf) = 0
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// A fragments of a warp's 32 staged rows (two m16 tiles × two k16 steps
// over the head dim)
__device__ __forceinline__ void load_a(uint32_t (&a)[2][2][4], const bf16* s,
                                       int lane) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
            ldsm_x4(a[mt][ks], s + (mt * 16 + (lane & 15)) * ATT_LDT +
                                   ks * 16 + (lane >> 4) * 8);
}

// S (the warp's 32 rows × tile rows r0..r0+7, one n8 tile) = A·tileᵀ over
// the head dim; the B fragment is one plain ldmatrix of the 8 tile rows:
// {b0, b1} of k step 0, then of k step 1
__device__ __forceinline__ void rows_times_rows(float (&s)[2][4],
                                                const uint32_t (&a)[2][2][4],
                                                const bf16* tile, int r0,
                                                int lane) {
    uint32_t b[4];
    ldsm_x4(b, tile + (r0 + (lane & 7)) * ATT_LDT + (lane >> 3) * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
        mma(s[mt], a[mt][0], b[0], b[1]);
        mma(s[mt], a[mt][1], b[2], b[3]);
    }
}

// acc (the warp's 32 rows × 32) += a (32 × 16: its k16 A fragments) ·
// tile rows r0..r0+15 (16 × 32, read transposed by ldmatrix)
__device__ __forceinline__ void acc_times_tile(float (&acc)[2][4][4],
                                               const uint32_t (&a)[2][4],
                                               const bf16* s, int r0,
                                               int lane) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        ldsm_x4_t(b, s + (r0 + (lane & 15)) * ATT_LDT + nb * 16 +
                         (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            mma(acc[mt][2 * nb], a[mt], b[0], b[1]);
            mma(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
    }
}

}  // namespace vit
