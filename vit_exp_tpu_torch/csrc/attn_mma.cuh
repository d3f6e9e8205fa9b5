// PTX helpers of the int8 attention (flash_static_int8.cu, K9/K10), of
// the forwards' earlier design kept for the trial
// (scripts/gemm_wgmma_variants/flash_fwd_mma_sync.cu) and, through
// gemm_wgmma.cuh, of the Hopper kernels (pack_bf16, exp2_approx,
// smem_u32): cp.async copies into a
// shared-memory ring, ldmatrix fragment loads (int8 rows read as b16 units),
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and m16n8k32 (int8 in,
// int32 accumulate) and ex2.approx, plus the fragment patterns of a warp's
// MT m16 tiles over a head dim D of 16, 32 or 64, staged at a pitch of
// att_ldt<D>() bf16.
//
// Staged rows are D bf16 padded by 8 (16 bytes: 48, 80 or 144 bytes a row),
// so the 8 row addresses of an ldmatrix fall on 8 distinct groups of 4
// banks: conflict-free.
#pragma once

#include "common.cuh"

namespace vit {

// bf16 pitch of a staged row of head dim D
template <int D>
__host__ __device__ constexpr int att_ldt() {
    return D + 8;
}
// log2 of the 16-byte chunks of a row of head dim D (2, 4 or 8 chunks)
template <int D>
__host__ __device__ constexpr int att_chunk_shift() {
    return D == 16 ? 1 : D == 32 ? 2 : 3;
}

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

// ROWS rows of a (row, D) bf16 matrix (rows row0.. of src, row stride sn)
// into dst at pitch att_ldt<D>() by a block of THREADS, zero past nrows:
// with CH = D / 8 chunks a row, thread tid copies 16-byte chunk tid % CH of
// rows tid / CH + (THREADS / CH)·i
template <int ROWS, int THREADS, int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long sn, int row0, int nrows,
                                          int tid) {
    constexpr int SHIFT = att_chunk_shift<D>(), CH = 1 << SHIFT;
    constexpr int LDT = att_ldt<D>();
    const int cv = tid & (CH - 1);
#pragma unroll
    for (int i = 0; i < (ROWS * CH + THREADS - 1) / THREADS; ++i) {
        const int r = (tid >> SHIFT) + (THREADS / CH) * i;
        if (r < ROWS) {
            const bool ok = row0 + r < nrows;
            cp_async16(dst + r * LDT + cv * 8,
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

// acc (the warp's MT · 16 rows × D) += a (MT · 16 × 16: its k16 A
// fragments) · tile rows r0..r0+15 (16 × D, read transposed by ldmatrix)
template <int MT, int D>
__device__ __forceinline__ void acc_times_tile(float (&acc)[MT][D / 8][4],
                                               const uint32_t (&a)[MT][4],
                                               const bf16* s, int r0,
                                               int lane) {
    constexpr int LDT = att_ldt<D>();
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
        uint32_t b[4];
        ldsm_x4_t(b, s + (r0 + (lane & 15)) * LDT + nb * 16 +
                         (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][2 * nb], a[mt], b[0], b[1]);
            mma(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
    }
}

}  // namespace vit
