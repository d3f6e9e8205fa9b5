// GEMM mainloop of the port's matrix kernels on mma.sync (geglu_ff_int8.cu:
// K11's products; K14 in ln_qkv_int8.cu and patch_embed.cu use its operand
// tiles and fragment loads in loops of their own; K2's, K3's, K8's and
// K12/K13's products run on gemm_wgmma.cuh):
// acc[j][m, n] += Σ_k A(m, k) · B_j(k, n)
// with the accumulators held in registers, for two operand types T:
// bf16 (fp32 accumulators, mma.sync m16n8k16) and int8 (int32
// accumulators, m16n8k32).
//
// - Operands are row-major matrices of T in device memory (MatT), stored
//   index-major, (index, k): A as M × K, B as N × K (a caller transposes a
//   k-major B once; ldmatrix has no .trans for 8-bit elements).  M, N and
//   K are free: rows and columns past a Mat's ends, or at or past k_end,
//   are zero-filled by cp.async.
//   The contiguous extent, the row pitch and every tile origin along it
//   must be multiples of 16 bytes (8 bf16, 16 int8), and the pointer
//   16-byte aligned.
// - Per k step, an A tile of BM × BK and NB B tiles of BN × BK (NB products
//   share one A tile) go through a STAGES-deep cp.async ring in dynamic
//   shared memory: step s + STAGES − 1 loads while step s computes, one
//   barrier per step.  Staged rows are padded by 16 bytes, so the 8 row
//   addresses of an ldmatrix fall on 8 distinct 16-byte bank groups for
//   every pitch used here (rows of 64 bytes: 80; 128 or 256 bytes: 144 or
//   272).
// - The fragments are loaded in b16 units: an int8 row of 32 codes is 16
//   b16, so the ldmatrix.x4 of a bf16 m16 × k16 A fragment is exactly the
//   m16 × k32 int8 one, and that of two n8 × k16 B fragments exactly two
//   n8 × k32 ones (attn_mma.cuh, mma_s8).
// - WM × WN warps; warp (wm, wn) owns rows wm·WTM .. and columns wn·WTN ..
//   of the block tile: MT m16 × NT n8 accumulator tiles per B operand in
//   mma.sync's C layout (lane l, g = l / 4, t = l % 4: rows g and g + 8,
//   columns 2t and 2t + 1; the same for both types), which the caller's
//   epilogue reads in place.
#pragma once

#include "attn_mma.cuh"

namespace vit {

// a row-major matrix: element (r, c) at p[r · ld + c], r < rows, c < cols
template <class T>
struct MatT {
    const T* p;
    long long ld;
    int rows, cols;
};
using Mat = MatT<bf16>;
using Mat8 = MatT<signed char>;

// one operand's tile of IDX (output rows or columns) × BK (depth), staged
// as it is stored, [IDX][BK], each row padded by 16 bytes (VEC elements)
template <int IDX, int BK, class T = bf16>
struct OperandTile {
    static constexpr int VEC = 16 / (int)sizeof(T);   // a 16-byte chunk
    static constexpr int LD = BK + VEC;
    static constexpr int LD16 = LD * (int)sizeof(T) / 2;   // in b16 units
    static constexpr int ELEMS = IDX * LD;
    static constexpr int CHUNKS = IDX * BK / VEC;

    // the tile at index i0 and depth k0 of m, zero where k ≥ k_end
    template <int THREADS>
    __device__ __forceinline__ static void load(T* dst, const MatT<T>& m,
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

// the accumulator type and the mma.sync of an operand type
template <class T> struct MmaOf;
template <> struct MmaOf<bf16> {
    using Acc = float;
    __device__ __forceinline__ static void run(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
        mma(c, a, b0, b1);
    }
};
template <> struct MmaOf<signed char> {
    using Acc = int;
    __device__ __forceinline__ static void run(int (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
        mma_s8(c, a, b0, b1);
    }
};

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_,
          int NB_ = 1, class T_ = bf16>
struct GemmCfg {
    using T = T_;
    using Acc = typename MmaOf<T>::Acc;
    static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
    static constexpr int STAGES = STAGES_, NB = NB_;
    static constexpr int THREADS = WM * WN * 32;
    static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
    static constexpr int MT = WTM / 16, NT = WTN / 8;
    static constexpr int BK16 = BK * (int)sizeof(T) / 2;   // depth in b16
    using TA = OperandTile<BM, BK, T>;
    using TB = OperandTile<BN, BK, T>;
    static constexpr int STAGE_ELEMS = TA::ELEMS + NB * TB::ELEMS;
    static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
    static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK16 % 16 == 0,
                  "warp tiles of m16 × n16 steps, 32-byte k steps");
    static_assert(STAGE_ELEMS * sizeof(T) % 16 == 0,
                  "stages keep 16-byte alignment");
};

// acc[j] += A[m0.., k_begin..k_end) · B_j[k_begin..k_end), n0..] for the
// block's tile; smem holds C::SMEM_BYTES.  Leaves the ring drained and the
// block synchronised, so the caller may run another mainloop on it.
template <class C>
__device__ __forceinline__ void gemm_mainloop(
    typename C::Acc (&acc)[C::NB][C::MT][C::NT][4],
    const MatT<typename C::T>& a, const MatT<typename C::T> (&b)[C::NB],
    int m0, int n0, int k_begin, int k_end, typename C::T* smem) {
    // a stage's A tile and its j-th B tile, in b16 units
    constexpr int B_OFF = C::TA::ELEMS * (int)sizeof(typename C::T) / 2;
    constexpr int B_STRIDE = C::TB::ELEMS * (int)sizeof(typename C::T) / 2;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = (warp / C::WN) * C::WTM, wn = (warp % C::WN) * C::WTN;
    const int n_steps = (k_end - k_begin + C::BK - 1) / C::BK;
    auto issue = [&](int step) {
        if (step < n_steps) {
            typename C::T* st = smem + (step % C::STAGES) * C::STAGE_ELEMS;
            const int k0 = k_begin + step * C::BK;
            C::TA::template load<C::THREADS>(st, a, m0, k0, k_end, tid);
#pragma unroll
            for (int j = 0; j < C::NB; ++j)
                C::TB::template load<C::THREADS>(
                    st + C::TA::ELEMS + j * C::TB::ELEMS, b[j], n0, k0, k_end,
                    tid);
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) issue(s);

    for (int step = 0; step < n_steps; ++step) {
        cp_async_wait<C::STAGES - 2>();   // this thread's copies of the step
        __syncthreads();   // every copy visible; the oldest stage is free
        issue(step + C::STAGES - 1);
        const bf16* sa = reinterpret_cast<const bf16*>(
            smem + (step % C::STAGES) * C::STAGE_ELEMS);
#pragma unroll
        for (int kk = 0; kk < C::BK16; kk += 16) {
            uint32_t af[C::MT][4];
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt)
                frag_a<C::TA::LD16>(af[mt], sa, wm + mt * 16, kk, lane);
#pragma unroll
            for (int j = 0; j < C::NB; ++j) {
                const bf16* sb = sa + B_OFF + j * B_STRIDE;
#pragma unroll
                for (int np = 0; np < C::NT / 2; ++np) {
                    uint32_t bf[4];
                    frag_b2<C::TB::LD16>(bf, sb, wn + np * 16, kk, lane);
#pragma unroll
                    for (int mt = 0; mt < C::MT; ++mt) {
                        MmaOf<typename C::T>::run(acc[j][mt][2 * np], af[mt],
                                                  bf[0], bf[1]);
                        MmaOf<typename C::T>::run(acc[j][mt][2 * np + 1],
                                                  af[mt], bf[2], bf[3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
}

// (row, column) of accumulator element e of tile (mt, nt) within the block
// tile, for the warp and lane that hold it
template <class C>
__device__ __forceinline__ int acc_row(int mt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / C::WN) * C::WTM + mt * 16 + (e >> 1) * 8 + (lane >> 2);
}
template <class C>
__device__ __forceinline__ int acc_col(int nt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp % C::WN) * C::WTN + nt * 8 + 2 * (lane & 3) + (e & 1);
}

}  // namespace vit
