// The mma.sync pieces of the patch embedding (patch_embed.cu), which stages
// its own operand tiles in a loop of its own; every other product runs on
// gemm_wgmma.cuh:
// acc[m, n] += Σ_k A(m, k) · B(k, n) in bf16 with fp32 accumulators
// (mma.sync m16n8k16), the accumulators in registers.
//
// - Operands are row-major bf16 matrices in device memory (Mat), stored
//   index-major, (index, k): A as M × K, B as N × K.  Rows and columns past
//   a Mat's ends, or at or past k_end, are zero-filled by cp.async.  The
//   contiguous extent, the row pitch and every tile origin along it must be
//   multiples of 16 bytes (8 bf16), and the pointer 16-byte aligned.
// - An operand tile of IDX rows × BK of depth is staged as it is stored,
//   each row padded by 16 bytes, so the 8 row addresses of an ldmatrix fall
//   on 8 distinct 16-byte bank groups.
// - WM × WN warps; warp (wm, wn) owns rows wm·WTM .. and columns wn·WTN ..
//   of the block tile: MT m16 × NT n8 accumulator tiles in mma.sync's C
//   layout (lane l, g = l / 4, t = l % 4: rows g and g + 8, columns 2t and
//   2t + 1), which the caller's epilogue reads in place.
#pragma once

#include "attn_mma.cuh"

namespace vit {

// a row-major bf16 matrix: element (r, c) at p[r · ld + c], r < rows, c <
// cols
struct Mat {
    const bf16* p;
    long long ld;
    int rows, cols;
};

// one operand's tile of IDX (output rows or columns) × BK (depth), staged
// as it is stored, [IDX][BK], each row padded by 16 bytes (VEC elements)
template <int IDX, int BK>
struct OperandTile {
    static constexpr int VEC = 8;   // a 16-byte chunk
    static constexpr int LD = BK + VEC;
    static constexpr int ELEMS = IDX * LD;
    static constexpr int CHUNKS = IDX * BK / VEC;

    // the tile at index i0 and depth k0 of m, zero where k ≥ k_end
    template <int THREADS>
    __device__ __forceinline__ static void load(bf16* dst, const Mat& m,
                                                int i0, int k0, int k_end,
                                                int tid) {
        const int c_end = min(m.cols, k_end);
#pragma unroll
        for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
            const int e = tid + i * THREADS;
            if (CHUNKS % THREADS == 0 || e < CHUNKS) {
                const int r = e / (BK / VEC), c = (e % (BK / VEC)) * VEC;
                const bool ok = i0 + r < m.rows && k0 + c < c_end;
                cp_async16(dst + r * LD + c,
                           ok ? m.p + (long long)(i0 + r) * m.ld + k0 + c : m.p,
                           ok);
            }
        }
    }
};

// the A fragment (m16 × 16 b16 of depth) at tile offsets (mi, ki), mma.sync's
// A layout; LD and ki in b16 units
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int mi, int ki, int lane) {
    ldsm_x4(a, s + (mi + (lane & 15)) * LD + ki + ((lane >> 4) << 3));
}

// the B fragments of two n8 tiles (16 b16 of depth × n16 at tile offsets
// ni, ki): {b0, b1} of columns ni .. ni + 7, then of ni + 8 .. ni + 15
template <int LD>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const bf16* s,
                                        int ni, int ki, int lane) {
    ldsm_x4(b, s + (ni + (lane & 7) + ((lane >> 4) << 3)) * LD + ki +
                   (lane & 8));
}

// a block tile of BM × BN on WM × WN warps, k steps of BK, STAGES stages
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct GemmCfg {
    static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
    static constexpr int STAGES = STAGES_;
    static constexpr int THREADS = WM * WN * 32;
    static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
    static constexpr int MT = WTM / 16, NT = WTN / 8;
    using TA = OperandTile<BM, BK>;
    using TB = OperandTile<BN, BK>;
    static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0,
                  "warp tiles of m16 × n16 steps, k16 steps");
};

// the row of accumulator element e of m16 tile mt within the block tile,
// for the warp and lane that hold it
template <class C>
__device__ __forceinline__ int acc_row(int mt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / C::WN) * C::WTM + mt * 16 + (e >> 1) * 8 + (lane >> 2);
}

}  // namespace vit
