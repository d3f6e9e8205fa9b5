// A design of csrc/flash_bwd.cu that lost (kept for
// scripts/gemm_wgmma_trial.py --variants): the two consumer warpgroups in
// step, each issuing S and dP of a tile, forming p while its dP runs, then
// dS, then the dV/dK (dQ) products, with nothing to stagger the two.  Both
// warpgroups wait on the same stage, so their products run together and
// then their exps do: the tensor cores and the exp unit take turns (on an
// NVIDIA H100 at 700 W, D 32: 4-6% slower than the shipped kernels' turns;
// PERF.md).  Its loaders need STAGES >= LOADERS (see the shipped source).
//
// Static-max attention backward: dk/dv and dq.  Replaces
// vit_exp_tpu/ops/flash_attention.py::_bwd_fused_kernel (exact tiling) and
// ::_dq_kernel / ::_dkv_kernel (ragged kv).
//
// With lse = B + log l from the forward (flash_fwd.cu, K1 or K15),
// for one (batch, head):  p = exp(q·k·scale − lse),  δ = rowsum(dO ⊙ O)
// (from the caller),  dV = bf16(p)ᵀ dO,  dS = bf16(p ⊙ (dO Vᵀ − δ) · scale),
// dK = dSᵀ Q,  dQ = dS K.  Head dim D of 16, 32 or 64 (one template
// instance each; the wrappers zero-pad any other d ≤ 64 to the next one),
// fp32 accumulators, bf16 operands, rounding points as in the TPU kernel.
//
// The TPU kernel sweeps (q block, kv block) pairs in order and keeps
// full-sequence fp32 dk/dv in VMEM.  Blocks here run in no order, so the
// work is split as the TPU's ragged pair is: one kernel parallel over kv
// (each block owns 128 keys and walks every 64-query tile; dK and dV stay in
// registers), one parallel over q (each block owns 128 queries and walks
// every 64-key tile; dQ stays in registers).  No atomics and a fixed tile
// order: the gradients are bit-reproducible.  Each logit is recomputed once
// per kernel, so the pair costs 7 products per (q, kv) pair against the
// TPU sweep's 5 (an fp32 atomic dQ would save two, and the determinism).
//
// What bounds it on an H100.  Per logit and head dim D, dK/dV does 4 · 2D
// tensor-core operations and one exp on the special-function unit (16 per
// clock per SM), dQ 3 · 2D and one exp; at D 32 the two bounds are almost
// equal (dK/dV: products 1.58 ms, exps 1.46 at 13,824² × 32 rows), so a
// kernel nears them only if the tensor cores and the exp unit run at once.
// The design, on the pieces of gemm_wgmma.cuh:
// - A block is three warpgroups (384 threads, one block per SM).  In the
//   producer warpgroup one thread issues the TMA loads (4-D tensor maps over
//   the (b, h, n, d) views, any strides) of the block's own 128 rows once
//   and then of each streamed 64-row tile into a 4-stage mbarrier ring; in
//   dK/dV warps 1-3 take the tiles in turn and write each tile's −lse·log2e
//   and −δ·scale into its stage (st.shared, then an arrival on its full
//   barrier).  The two consumer warpgroups own 64 rows each.
// - All seven products are wgmma.  dK/dV: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with
//   both operands in shared memory (K, V index-major A; the Q, dO tile
//   index-major B), p and dS formed in the accumulator registers, then dV
//   += Pᵀ dO and dK += dSᵀ Q with A in registers (two n8 accumulator tiles
//   packed to bf16 are one k16 A fragment) and B the same Q, dO tile read
//   k-major through the transpose bit.  dQ: S = Q Kᵀ, dP = dO Vᵀ, then dQ
//   += dS K, K read k-major.  S, dP, p and dS never leave registers.
// - Rows are 2D bytes, so tiles lie in the 128-, 64- or 32-byte swizzle
//   (D 64, 32, 16), in the tensor map and the descriptors alike.
// - Overlap: S and dP are committed as two wgmma groups; the exps of p run
//   while dP's products do, and each warpgroup's exps run beside the other
//   warpgroup's products.  A tile's dV/dK (dQ) products are waited for only
//   when the next tile's S is, and then its stage is released.
// - p = ex2.approx(S · scale·log2e − lse·log2e): one FFMA and one MUFU per
//   logit (a p below 2^-126 flushes to 0); dS = p · (dP · scale − δ·scale):
//   one FFMA and one FMUL; a bf16 pack per two values of p and of dS.
// - Masking: TMA zero-fills rows past Nq and Nkv.  A query row past Nq has
//   q = dO = 0 and −lse·log2e = −δ·scale = 0 in its stage, so p = 1, dS = 0
//   and its Pᵀ dO and dSᵀ Q terms are exact zeros: dK/dV has no mask.  dQ
//   zeroes dS past Nkv in the last key tile (a uniform branch), so no
//   exp of an unbounded lse meets a zero key.  Rows past the end are never
//   stored; the gradients leave from the registers (64-bit offsets).
// - Registers: 24 a producer thread, 240 a consumer thread (the launch's
//   168 × 384); at D 64 a dK/dV consumer holds 128 fp32 accumulators (dK,
//   dV, S, dP) and 32 packed registers.  The ptxas log in
//   build/torch_kernels/*.log gives the counts and spills.
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

constexpr int BT = 64;         // rows of a streamed tile and of a consumer
constexpr int STAGES = 4;      // depth of the ring
constexpr int LOADERS = 3;     // dK/dV: producer warps writing lse and δ
constexpr int BWD_PRODUCER_REGS = 24, BWD_CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    long long b, h, n;
};

constexpr int round_kb(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// a 64-row tile of head dim D in shared memory as TMA leaves it: rows of 2D
// bytes in the swizzle of 2D bytes
template <int D>
struct Tile {
    static_assert(D == 16 || D == 32 || D == 64, "head dims 16, 32, 64");
    static constexpr int SW = 2 * D;
    static constexpr int BYTES = BT * SW;
    // index-major (rows × D, k along the row): k16 step kk
    __device__ __forceinline__ static uint64_t rows(uint32_t a, int kk) {
        return smem_desc<false, SW>(a + 32 * kk);
    }
    // k-major (the rows are k, D the index): k16 step i, 16 rows further
    __device__ __forceinline__ static uint64_t kmajor(uint32_t a, int i) {
        return smem_desc<true, SW>(a + 16 * SW * i);
    }
};

// dK/dV: a stage is a q tile, its dO tile, then −lse·log2e and −δ·scale of
// its 64 queries; the block's own K and V halves and a barrier after the
// ring
template <int D>
struct Dkv {
    static constexpr int STATS = 2 * Tile<D>::BYTES;
    static constexpr int OWN = 4 * Tile<D>::BYTES;
    using R = Ring<STAGES, round_kb(STATS + 2 * BT * 4), OWN + 1024, 1,
                   1 + 32>;
};

// dQ: a stage is a k tile and its v tile; the block's own Q and dO halves
// and a barrier after the ring
template <int D>
struct Dq {
    static constexpr int OWN = 4 * Tile<D>::BYTES;
    using R = Ring<STAGES, 2 * Tile<D>::BYTES, OWN + 1024>;
};

template <int J>
__device__ __forceinline__ void zero(float (&a)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// two adjacent n8 tiles of an accumulator, as bf16 pairs: the k16 A
// fragment of step i
template <int J>
__device__ __forceinline__ void pack_a(uint32_t (&a)[J / 2][4],
                                       const float (&x)[J][4]) {
#pragma unroll
    for (int i = 0; i < J / 2; ++i) {
        a[i][0] = pack_bf16(x[2 * i][0], x[2 * i][1]);
        a[i][1] = pack_bf16(x[2 * i][2], x[2 * i][3]);
        a[i][2] = pack_bf16(x[2 * i + 1][0], x[2 * i + 1][1]);
        a[i][3] = pack_bf16(x[2 * i + 1][2], x[2 * i + 1][3]);
    }
}

// the consumer's 64 rows × D of acc as bf16 (the accumulator layout), rows
// row0 + .. at or past nrows skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long sn, int row0,
                                           int nrows,
                                           const float (&acc)[D / 8][4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = row0 + wg_row(2 * half);
        if (row >= nrows) continue;
        bf16* dst = base + row * sn;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + wg_col(j, 0)) =
                pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
}

// S = A·Bᵀ over the head dim (A: the consumer's 64 own rows, B: a 64-row
// tile, both index-major), one wgmma group
template <int D>
__device__ __forceinline__ void rows_product(float (&s)[BT / 8][4],
                                             uint32_t a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BT, 0, 0>::run(s, Tile<D>::rows(a, kk), Tile<D>::rows(b, kk),
                             kk > 0);
    wgmma_commit();
}

// acc += A·tile (A: 64 × 64 in registers, k16 fragments; the tile read
// k-major: its 64 rows are k, D the columns)
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4],
                                            const uint32_t (&a)[BT / 16][4],
                                            uint32_t tile) {
#pragma unroll
    for (int i = 0; i < BT / 16; ++i)
        WgmmaRS<D, 1>::run(acc, a[i], Tile<D>::kmajor(tile, i));
}

// dK, dV: one block per (128 keys, batch·head); consumer c owns keys
// 64c .. of the block.  Per 64-query tile: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, p and
// dS in their registers, dV += Pᵀ dO and dK += dSᵀ Q.
template <int D>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides dks, Strides dvs, int H,
                     int Nq, int Nkv, float scale) {
    using T = Tile<D>;
    using R = typename Dkv<D>::R;
    extern __shared__ unsigned char smem_raw[];
    R ring(smem_raw);
    const uint32_t own = ring.extra(), own_bar = own + Dkv<D>::OWN;
    if (threadIdx.x == 0) mbar_init(own_bar, 1);
    ring.init();
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int k0 = blockIdx.x * 2 * BT;
    const int n_tiles = (Nq + BT - 1) / BT;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs<BWD_PRODUCER_REGS, BWD_CONSUMER_REGS>();
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        if (threadIdx.x == 0) {
            mbar_expect_tx(own_bar, Dkv<D>::OWN);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                tma_load_4d(own + c * T::BYTES, &k_map, 0, k0 + BT * c, h, b,
                            own_bar);
                tma_load_4d(own + (2 + c) * T::BYTES, &v_map, 0, k0 + BT * c,
                            h, b, own_bar);
            }
            for (int t = 0; t < n_tiles; ++t) {
                mbar_wait(ring.empty(), ring.phase ^ 1);
                const uint32_t st = ring.data(), full = ring.full();
                mbar_expect_tx(full, 2 * T::BYTES);
                tma_load_4d(st, &q_map, 0, t * BT, h, b, full);
                tma_load_4d(st + T::BYTES, &o_map, 0, t * BT, h, b, full);
                ring.advance();
            }
        } else if (warp > 0) {
            // warp w writes the statistics of tiles w − 1, w − 1 + LOADERS,
            // ...: lane l those of queries 2l and 2l + 1, 0 past Nq; the
            // loads are issued before the wait for the stage
            const float* ls = lse + (size_t)blockIdx.y * Nq;
            const float* ds = delta + (size_t)blockIdx.y * Nq;
            for (int i = 1; i < warp; ++i) ring.advance();
            for (int t = warp - 1; t < n_tiles; t += LOADERS) {
                const int q = t * BT + 2 * lane;
                const float2 nl = make_float2(
                    q < Nq ? -ls[q] * LOG2E : 0.f,
                    q + 1 < Nq ? -ls[q + 1] * LOG2E : 0.f);
                const float2 nd = make_float2(q < Nq ? -ds[q] * scale : 0.f,
                                              q + 1 < Nq ? -ds[q + 1] * scale
                                                         : 0.f);
                mbar_wait(ring.empty(), ring.phase ^ 1);
                const uint32_t stats = ring.data() + Dkv<D>::STATS;
                sts_f2(stats + 8 * lane, nl);
                sts_f2(stats + 4 * BT + 8 * lane, nd);
                mbar_arrive(ring.full());
#pragma unroll
                for (int i = 0; i < LOADERS; ++i) ring.advance();
            }
        }
        return;
    }
    consumer_regs<BWD_PRODUCER_REGS, BWD_CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const bool signals = threadIdx.x % WG_THREADS == 0;
    const uint32_t kc = own + cw * T::BYTES, vc = own + (2 + cw) * T::BYTES;
    const int col2 = 2 * (threadIdx.x & 3);   // the lane's first column
    const float c2 = scale * LOG2E;
    float dka[D / 8][4], dva[D / 8][4], s[BT / 8][4], dp[BT / 8][4];
    zero(dka);
    zero(dva);
    zero(s);
    zero(dp);
    uint32_t pa[BT / 16][4], dsa[BT / 16][4];
    uint32_t held = 0;   // the empty barrier of the stage read a tile before
    fence_acc(dka);
    fence_acc(dva);
    mbar_wait(own_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(ring.full(), ring.phase);
        const uint32_t qt = ring.data(), ot = qt + T::BYTES;
        const uint32_t stats = qt + Dkv<D>::STATS;
        wgmma_fence();
        rows_product<D>(s, kc, qt);    // Sᵀ = K Qᵀ
        rows_product<D>(dp, vc, ot);   // dPᵀ = V dOᵀ
        wgmma_wait<1>();   // Sᵀ, and the tile before's dV and dK, are done
        fence_acc(s);
        if (held && signals) mbar_arrive(held);
        // p = exp2(S·scale·log2e − lse·log2e) in place, while dP runs
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
            const float2 nl = lds_f2(stats + 4 * (8 * j + col2));
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[j][e] = exp2_approx(fmaf(s[j][e], c2, e & 1 ? nl.y : nl.x));
        }
        pack_a<BT / 8>(pa, s);
        wgmma_wait<0>();
        fence_acc(dp);
        // dS = p · (dP·scale − δ·scale)
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
            const float2 nd = lds_f2(stats + 4 * BT + 4 * (8 * j + col2));
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dp[j][e] = s[j][e] * fmaf(dp[j][e], scale, e & 1 ? nd.y : nd.x);
        }
        pack_a<BT / 8>(dsa, dp);
        wgmma_fence();
        acc_product<D>(dva, pa, ot);    // dV += Pᵀ dO
        acc_product<D>(dka, dsa, qt);   // dK += dSᵀ Q
        wgmma_commit();
        held = ring.empty();
        ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(dka);
    fence_acc(dva);
    if (held && signals) mbar_arrive(held);

    const int kr = k0 + BT * cw;
    store_rows<D>(dk + b * dks.b + h * dks.h, dks.n, kr, Nkv, dka);
    store_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.n, kr, Nkv, dva);
}

// dS = p · (dP·scale − δ·scale) of a 64-key tile in dp's registers, p in
// s's; MASK: the tile holds keys past Nkv (kv_left of its columns are real)
template <bool MASK>
__device__ __forceinline__ void dq_ds(float (&dp)[BT / 8][4],
                                      const float (&s)[BT / 8][4],
                                      const float (&nd)[2], float scale,
                                      int kv_left) {
    const int col2 = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            dp[j][e] = s[j][e] * fmaf(dp[j][e], scale, nd[e >> 1]);
            if (MASK && 8 * j + col2 + (e & 1) >= kv_left) dp[j][e] = 0.f;
        }
}

// dQ: one block per (128 queries, batch·head); consumer c owns queries
// 64c .. of the block, with their −lse·log2e and −δ·scale in registers.
// Per 64-key tile: S = Q Kᵀ and dP = dO Vᵀ, dS in their registers, dQ +=
// dS K.
template <int D>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Strides dqs, int H, int Nq, int Nkv, float scale) {
    using T = Tile<D>;
    using R = typename Dq<D>::R;
    extern __shared__ unsigned char smem_raw[];
    R ring(smem_raw);
    const uint32_t own = ring.extra(), own_bar = own + Dq<D>::OWN;
    if (threadIdx.x == 0) mbar_init(own_bar, 1);
    ring.init();
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * 2 * BT;
    const int n_tiles = (Nkv + BT - 1) / BT;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs<BWD_PRODUCER_REGS, BWD_CONSUMER_REGS>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(own_bar, Dq<D>::OWN);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                tma_load_4d(own + c * T::BYTES, &q_map, 0, q0 + BT * c, h, b,
                            own_bar);
                tma_load_4d(own + (2 + c) * T::BYTES, &o_map, 0, q0 + BT * c,
                            h, b, own_bar);
            }
            for (int t = 0; t < n_tiles; ++t) {
                mbar_wait(ring.empty(), ring.phase ^ 1);
                const uint32_t st = ring.data(), full = ring.full();
                mbar_expect_tx(full, 2 * T::BYTES);
                tma_load_4d(st, &k_map, 0, t * BT, h, b, full);
                tma_load_4d(st + T::BYTES, &v_map, 0, t * BT, h, b, full);
                ring.advance();
            }
        }
        return;
    }
    consumer_regs<BWD_PRODUCER_REGS, BWD_CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const bool signals = threadIdx.x % WG_THREADS == 0;
    const uint32_t qc = own + cw * T::BYTES, oc = own + (2 + cw) * T::BYTES;
    const float c2 = scale * LOG2E;
    // −lse·log2e and −δ·scale of the lane's rows g and g + 8; 0 past Nq
    // (those rows are never stored)
    const int r0 = q0 + BT * cw;
    float nl[2], nd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int qi = r0 + wg_row(2 * half);
        const size_t i = (size_t)blockIdx.y * Nq + qi;
        nl[half] = qi < Nq ? -lse[i] * LOG2E : 0.f;
        nd[half] = qi < Nq ? -delta[i] * scale : 0.f;
    }
    float dqa[D / 8][4], s[BT / 8][4], dp[BT / 8][4];
    zero(dqa);
    zero(s);
    zero(dp);
    uint32_t dsa[BT / 16][4];
    uint32_t held = 0;
    fence_acc(dqa);
    mbar_wait(own_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(ring.full(), ring.phase);
        const uint32_t kt = ring.data(), vt = kt + T::BYTES;
        wgmma_fence();
        rows_product<D>(s, qc, kt);    // S = Q Kᵀ
        rows_product<D>(dp, oc, vt);   // dP = dO Vᵀ
        wgmma_wait<1>();   // S, and the tile before's dQ, are done
        fence_acc(s);
        if (held && signals) mbar_arrive(held);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                s[j][e] = exp2_approx(fmaf(s[j][e], c2, nl[e >> 1]));
        wgmma_wait<0>();
        fence_acc(dp);
        const int kv_left = Nkv - t * BT;
        if (kv_left >= BT)
            dq_ds<false>(dp, s, nd, scale, kv_left);
        else
            dq_ds<true>(dp, s, nd, scale, kv_left);
        pack_a<BT / 8>(dsa, dp);
        wgmma_fence();
        acc_product<D>(dqa, dsa, kt);   // dQ += dS K
        wgmma_commit();
        held = ring.empty();
        ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(dqa);
    if (held && signals) mbar_arrive(held);

    store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.n, r0, Nq, dqa);
}

// q, k, v and dO as 4-D tensor maps in boxes of 64 rows
bool bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
              const void* v, const void* dout, Strides qs, Strides ks,
              Strides vs, Strides os, int B, int H, int Nq, int Nkv, int D) {
    return tma_map_4d(&maps[0], q, B, H, Nq, D, qs.b, qs.h, qs.n, BT) &&
           tma_map_4d(&maps[1], k, B, H, Nkv, D, ks.b, ks.h, ks.n, BT) &&
           tma_map_4d(&maps[2], v, B, H, Nkv, D, vs.b, vs.h, vs.n, BT) &&
           tma_map_4d(&maps[3], dout, B, H, Nq, D, os.b, os.h, os.n, BT);
}

template <int D>
int launch_dkv(const CUtensorMap (&maps)[4], const void* lse,
               const void* delta, void* dk, void* dv, Strides dks,
               Strides dvs, int B, int H, int Nq, int Nkv, float scale,
               void* stream) {
    constexpr int smem = Dkv<D>::R::SMEM_BYTES;
    cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nkv + 2 * BT - 1) / (2 * BT), B * H);
    flash_bwd_dkv_kernel<D><<<grid, GEMM_THREADS, smem, (cudaStream_t)stream>>>(
        maps[0], maps[1], maps[2], maps[3], (const float*)lse,
        (const float*)delta, (bf16*)dk, (bf16*)dv, dks, dvs, H, Nq, Nkv,
        scale);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const CUtensorMap (&maps)[4], const void* lse,
              const void* delta, void* dq, Strides dqs, int B, int H, int Nq,
              int Nkv, float scale, void* stream) {
    constexpr int smem = Dq<D>::R::SMEM_BYTES;
    cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nq + 2 * BT - 1) / (2 * BT), B * H);
    flash_bwd_dq_kernel<D><<<grid, GEMM_THREADS, smem, (cudaStream_t)stream>>>(
        maps[0], maps[1], maps[2], maps[3], (const float*)lse,
        (const float*)delta, (bf16*)dq, dqs, H, Nq, Nkv, scale);
    return (int)cudaGetLastError();
}

}  // namespace

VIT_API int vit_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, long long dksb, long long dksh, long long dksn,
    long long dvsb, long long dvsh, long long dvsn, int B, int H, int Nq,
    int Nkv, int D, float scale, void* stream) {
    const Strides qs{qsb, qsh, qsn}, ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn},
        os{osb, osh, osn}, dks{dksb, dksh, dksn}, dvs{dvsb, dvsh, dvsn};
    CUtensorMap maps[4];
    if (B < 1 || H < 1 || Nq < 1 || Nkv < 1 ||
        !bwd_maps(maps, q, k, v, dout, qs, ks, vs, os, B, H, Nq, Nkv, D))
        return (int)cudaErrorInvalidValue;
    switch (D) {
        case 16:
            return launch_dkv<16>(maps, lse, delta, dk, dv, dks, dvs, B, H,
                                  Nq, Nkv, scale, stream);
        case 32:
            return launch_dkv<32>(maps, lse, delta, dk, dv, dks, dvs, B, H,
                                  Nq, Nkv, scale, stream);
        case 64:
            return launch_dkv<64>(maps, lse, delta, dk, dv, dks, dvs, B, H,
                                  Nq, Nkv, scale, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

VIT_API int vit_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, long long dqsb, long long dqsh, long long dqsn, int B,
    int H, int Nq, int Nkv, int D, float scale, void* stream) {
    const Strides qs{qsb, qsh, qsn}, ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn},
        os{osb, osh, osn}, dqs{dqsb, dqsh, dqsn};
    CUtensorMap maps[4];
    if (B < 1 || H < 1 || Nq < 1 || Nkv < 1 ||
        !bwd_maps(maps, q, k, v, dout, qs, ks, vs, os, B, H, Nq, Nkv, D))
        return (int)cudaErrorInvalidValue;
    switch (D) {
        case 16:
            return launch_dq<16>(maps, lse, delta, dq, dqs, B, H, Nq, Nkv,
                                 scale, stream);
        case 32:
            return launch_dq<32>(maps, lse, delta, dq, dqs, B, H, Nq, Nkv,
                                 scale, stream);
        case 64:
            return launch_dq<64>(maps, lse, delta, dq, dqs, B, H, Nq, Nkv,
                                 scale, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
