// A design of csrc/flash_bwd.cu not shipped (kept for
// scripts/gemm_wgmma_trial.py --variants): dQ with three consumer
// warpgroups taking turns (192 queries a block) at D 16 and 32, where S,
// dP and dQ fit 160 registers a thread (512 threads: the launch's 128, 24
// a producer).  On an NVIDIA H100 at 700 W it ran dQ 5-6% faster at full
// width (PERF.md), but its blocks of 192 queries leave the small grids (a
// tensor-parallel rank's 2 heads: 144 blocks on 132 SMs) a second wave of
// larger blocks, and the gain is ≈ 0.5% of a train step.  Its ring's
// empty barriers count three consumers (RingN) and its register split is
// checked here (split_fits); the rest is the shipped source.
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
// equal (dK/dV: products 1.58 ms, exps 1.46 at 13,824² × 32 rows).  What
// holds it above them (scripts/gemm_wgmma_trial.py --variants, D 32): the
// products alone run at about half the tensor cores' peak (2.8 ms for
// dK/dV: wgmmas of N 32 and 64 with 2-4 k steps a chain), and the exps and
// the fp32 arithmetic of p and dS add about 1 ms beside them; the loads do
// not (the stream alone: 0.9 ms).  The design, on gemm_wgmma.cuh's pieces:
// - A block is three warpgroups (384 threads, one block per SM).  In the
//   producer warpgroup one thread issues the TMA loads (4-D tensor maps over
//   the (b, h, n, d) views, any strides) of the block's own 128 rows once
//   and then of each streamed 64-row tile into a 4-stage mbarrier ring; in
//   dK/dV warps 1-3 take the tiles in turn and write each tile's −lse·log2e
//   and −δ·scale into its stage (st.shared, then an arrival on its full
//   barrier).  The two consumer warpgroups own 64 rows each.
// - All seven products are wgmma with A in registers.  dK/dV: Sᵀ = K Qᵀ and
//   dPᵀ = V dOᵀ, K and V read once into A fragments, the Q and dO tile an
//   index-major B; p and dS are formed in the accumulator registers, then
//   dV += Pᵀ dO and dK += dSᵀ Q take them as A (two n8 accumulator tiles
//   packed to bf16 are one k16 A fragment), with B the same Q and dO tile
//   read k-major through the transpose bit.  dQ: S = Q Kᵀ, dP = dO Vᵀ, then
//   dQ += dS K, K read k-major.  S, dP, p and dS never leave registers.
//   (S and dP with K, V in shared memory read 4 KB a 32-clock wgmma, the
//   SM's shared-memory rate: 7% slower.)
// - Rows are 2D bytes, so tiles lie in the 128-, 64- or 32-byte swizzle
//   (D 64, 32, 16), in the tensor map and the descriptors alike.
// - Overlap: the two consumer warpgroups take turns at the tensor cores
//   (named barriers): in its turn a warpgroup issues the dV/dK (dQ)
//   products of the tile before and S and dP of this tile, then forms p
//   and dS while the other warpgroup's products run; its exps start once
//   S is done, beside its own dP.  In step (both warpgroups' products,
//   then both's exps: scripts/gemm_wgmma_variants/flash_bwd_in_step.cu) it
//   ran 4-6% slower.
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
//   dV, S, dP), 32 registers of K and V and 32 of packed p and dS; S and dP
//   of 128 keys do not fit dQ's at D 32 (ptxas then serialises the wgmmas).
//   The ptxas log in build/torch_kernels/*.log gives the counts and spills.
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

constexpr int BT = 64;         // rows of a streamed tile and of a consumer
constexpr int STAGES = 4;      // depth of the ring
constexpr int LOADERS = 3;     // dK/dV: producer warps writing lse and δ
// a loader takes every LOADERS-th tile, so it may run up to LOADERS tiles
// ahead of the slowest; an mbarrier's parity tells apart only two phases
static_assert(STAGES >= LOADERS, "a loader never waits two phases ahead");
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
// C consumers: registers P a producer thread and R a consumer thread within
// ptxas's cap at launch (65,536 over the block's threads, steps of 8)
template <int P, int R, int C>
__host__ __device__ constexpr bool split_fits() {
    constexpr int threads = (1 + C) * WG_THREADS;
    return P % 8 == 0 && R % 8 == 0 && P >= 24 && R <= 256 &&
           (P + C * R) * WG_THREADS <= 65536 / threads / 8 * 8 * threads;
}
template <int P, int R, int C>
__device__ __forceinline__ void split_producer() {
    static_assert(split_fits<P, R, C>(), "the registers fit the block's");
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P));
}
template <int P, int R, int C>
__device__ __forceinline__ void split_consumer() {
    static_assert(split_fits<P, R, C>(), "the registers fit the block's");
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// a ring whose stages C consumer warpgroups read (one arrival each empties
// a stage)
template <int STAGES_, int STAGE_BYTES_, int EXTRA, int C>
struct RingN : Ring<STAGES_, STAGE_BYTES_, EXTRA> {
    using Ring<STAGES_, STAGE_BYTES_, EXTRA>::Ring;
    __device__ __forceinline__ void init() const {
        if (threadIdx.x == 0) {
            const uint32_t all = this->area + STAGES_ * STAGE_BYTES_ + EXTRA;
            for (int i = 0; i < STAGES_; ++i) {
                mbar_init(all + 8 * i, 1);
                mbar_init(all + 8 * (STAGES_ + i), C);
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }
};

template <int D>
struct Dq {
    static constexpr int C = D == 64 ? 2 : 3;   // consumer warpgroups
    static constexpr int THREADS = (1 + C) * WG_THREADS;
    static constexpr int REGS = C == 2 ? BWD_CONSUMER_REGS : 160;
    static constexpr int OWN = 2 * C * Tile<D>::BYTES;
    using R = RingN<STAGES, 2 * Tile<D>::BYTES, OWN + 1024, C>;
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

// the k16 A fragments of the warpgroup's 64 rows of a tile (rows × D, as
// TMA left it): a[kk] holds columns 16kk .. 16kk + 15, read once
template <int D>
__device__ __forceinline__ void load_rows(uint32_t (&a)[D / 16][4],
                                          uint32_t tile) {
    const int w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
    const int t4 = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int row = 16 * w + g + 8 * (k & 1);
            const int col = 16 * kk + 2 * t4 + 8 * (k >> 1);
            a[kk][k] = lds_u32(tile + swizzled<Tile<D>::SW>(
                                          row * Tile<D>::SW + 2 * col));
        }
}

// S = A·Bᵀ over the head dim (A: the consumer's 64 own rows, in registers;
// B: a 64-row tile, index-major), one wgmma group
template <int D>
__device__ __forceinline__ void rows_product(float (&s)[BT / 8][4],
                                             const uint32_t (&a)[D / 16][4],
                                             uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        WgmmaRS<BT, 0>::run(s, a[kk], Tile<D>::rows(b, kk), kk > 0);
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

// The two consumer warpgroups take turns at the tensor cores (named
// barriers 3 and 4, both warpgroups' 256 threads): warpgroup c waits for
// its turn (bar.sync 3 + c), issues its wgmmas of a tile, and hands the
// turn over (bar.arrive 4 − c); so each one's exps and dS arithmetic run
// while the other's products do.  Consumer 1 hands consumer 0 the first
// turn and skips its last hand-over, so every arrival meets a wait.
template <int C = 2>
__device__ __forceinline__ void my_turn(int cw) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(3 + cw), "n"(2 * WG_THREADS)
                 : "memory");
}
template <int C = 2>
__device__ __forceinline__ void your_turn(int cw) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (cw + 1) % C),
                 "n"(2 * WG_THREADS)
                 : "memory");
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
    uint32_t ka[D / 16][4], va[D / 16][4];   // the consumer's K and V
    uint32_t pa[BT / 16][4], dsa[BT / 16][4];
    uint32_t held = 0;   // the empty barrier of the stage read a tile before
    fence_acc(dka);
    fence_acc(dva);
    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ of the tile at stage qt (two wgmma groups)
    auto logits = [&](uint32_t qt) {
        rows_product<D>(s, ka, qt);
        rows_product<D>(dp, va, qt + T::BYTES);
    };
    // dV += Pᵀ dO and dK += dSᵀ Q of the tile before, at stage qt
    auto grads = [&](uint32_t qt) {
        acc_product<D>(dva, pa, qt + T::BYTES);
        acc_product<D>(dka, dsa, qt);
        wgmma_commit();
    };
    // once Sᵀ (and the products issued before it) is done: the stage before
    // is released, p = exp2(S·scale·log2e − lse·log2e) in place while dPᵀ
    // runs, then dS = p · (dP·scale − δ·scale), both packed as A fragments
    auto math = [&](uint32_t qt) {
        const uint32_t stats = qt + Dkv<D>::STATS;
        wgmma_wait<1>();
        fence_acc(s);
        if (held && signals) mbar_arrive(held);
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
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
            const float2 nd = lds_f2(stats + 4 * BT + 4 * (8 * j + col2));
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dp[j][e] = s[j][e] * fmaf(dp[j][e], scale, e & 1 ? nd.y : nd.x);
        }
        pack_a<BT / 8>(dsa, dp);
    };
    mbar_wait(own_bar, 0);
    load_rows<D>(ka, kc);
    load_rows<D>(va, vc);
    if (cw == 1) your_turn(cw);
    // turn t issues dV, dK of tile t − 1 and Sᵀ, dPᵀ of tile t; the first
    // and the last turn are peeled, so that no wgmma sits under a branch
    // (ptxas serialises them there)
    mbar_wait(ring.full(), ring.phase);
    uint32_t qt = ring.data();
    my_turn(cw);
    wgmma_fence();
    logits(qt);
    your_turn(cw);
    math(qt);
    for (int t = 1; t < n_tiles; ++t) {
        held = ring.empty();
        const uint32_t before = qt;
        ring.advance();
        mbar_wait(ring.full(), ring.phase);
        qt = ring.data();
        my_turn(cw);
        wgmma_fence();
        grads(before);
        logits(qt);
        your_turn(cw);
        math(qt);
    }
    held = ring.empty();
    my_turn(cw);
    wgmma_fence();
    grads(qt);
    if (cw == 0) your_turn(cw);
    wgmma_wait<0>();
    fence_acc(dka);
    fence_acc(dva);
    if (signals) mbar_arrive(held);

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
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Strides dqs, int H, int Nq, int Nkv, float scale) {
    using T = Tile<D>;
    using R = typename Dq<D>::R;
    constexpr int C = Dq<D>::C;
    extern __shared__ unsigned char smem_raw[];
    R ring(smem_raw);
    const uint32_t own = ring.extra(), own_bar = own + Dq<D>::OWN;
    if (threadIdx.x == 0) mbar_init(own_bar, 1);
    ring.init();
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * C * BT;
    const int n_tiles = (Nkv + BT - 1) / BT;
    if (threadIdx.x < WG_THREADS) {   // the producer
        split_producer<BWD_PRODUCER_REGS, Dq<D>::REGS, C>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(own_bar, Dq<D>::OWN);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                tma_load_4d(own + c * T::BYTES, &q_map, 0, q0 + BT * c, h, b,
                            own_bar);
                tma_load_4d(own + (C + c) * T::BYTES, &o_map, 0, q0 + BT * c,
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
    split_consumer<BWD_PRODUCER_REGS, Dq<D>::REGS, C>();
    const int cw = threadIdx.x / WG_THREADS - 1;
    const bool signals = threadIdx.x % WG_THREADS == 0;
    const uint32_t qc = own + cw * T::BYTES, oc = own + (C + cw) * T::BYTES;
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
    uint32_t qa[D / 16][4], oa[D / 16][4];   // the consumer's Q and dO
    uint32_t dsa[BT / 16][4];
    uint32_t held = 0;   // the empty barrier of the stage read a tile before
    fence_acc(dqa);
    // S = Q Kᵀ and dP = dO Vᵀ of the tile at stage kt (two wgmma groups)
    auto logits = [&](uint32_t kt) {
        rows_product<D>(s, qa, kt);
        rows_product<D>(dp, oa, kt + T::BYTES);
    };
    // dQ += dS K of the tile before, at stage kt
    auto grads = [&](uint32_t kt) {
        acc_product<D>(dqa, dsa, kt);
        wgmma_commit();
    };
    // once S (and the products issued before it) is done: the stage before
    // is released, p in place while dP runs, then dS of tile t (columns
    // past Nkv zeroed in the last tile), packed as A fragments
    auto math = [&](int t) {
        wgmma_wait<1>();
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
    };
    mbar_wait(own_bar, 0);
    load_rows<D>(qa, qc);
    load_rows<D>(oa, oc);
    if (cw == C - 1) your_turn<C>(cw);
    // turn t issues dQ of tile t − 1 and S, dP of tile t; the first and the
    // last turn are peeled (no wgmma under a branch)
    mbar_wait(ring.full(), ring.phase);
    uint32_t kt = ring.data();
    my_turn<C>(cw);
    wgmma_fence();
    logits(kt);
    your_turn<C>(cw);
    math(0);
    for (int t = 1; t < n_tiles; ++t) {
        held = ring.empty();
        const uint32_t before = kt;
        ring.advance();
        mbar_wait(ring.full(), ring.phase);
        kt = ring.data();
        my_turn<C>(cw);
        wgmma_fence();
        grads(before);
        logits(kt);
        your_turn<C>(cw);
        math(t);
    }
    held = ring.empty();
    my_turn<C>(cw);
    wgmma_fence();
    grads(kt);
    if (cw != C - 1) your_turn<C>(cw);
    wgmma_wait<0>();
    fence_acc(dqa);
    if (signals) mbar_arrive(held);

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
    dim3 grid((Nq + Dq<D>::C * BT - 1) / (Dq<D>::C * BT), B * H);
    flash_bwd_dq_kernel<D><<<grid, Dq<D>::THREADS, smem,
                             (cudaStream_t)stream>>>(
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
