// K1 and K15: attention forward, one kernel template with two softmax
// policies.  Replaces, in vit_exp_tpu/ops/flash_attention.py:
// - running max (K15): ::_fwd_kernel (``_flash_fwd``, reached through
//   ``_flash_core`` with null_strategy="concat": the null kv are ordinary
//   keys 0 .. n_null-1 of every (batch, head)).  p = exp(q·k·scale − m), m
//   the running row max; l sums the fp32 p, only the P·V operand is p
//   rounded to bf16; lse = m + log l;
// - static bound (K1): ::_fwd_kernel_static (``_flash_fwd_static``).  p =
//   bf16(exp(q·k·scale − B)) with B a traced bound on every logit (no
//   running max); up to 8 nulls per head, shared by the batch, seed O and
//   l; l sums the bf16-rounded p (the TPU kernel's ones column in v);
//   lse = B + log l.
// out = O / l in bf16; lse (natural-log units, fp32, (batch·head, Nq)) only
// when the pointer is not null: the statistic the backward pair
// (flash_bwd.cu) recomputes p from.  q, k and v are read through 4-D tensor
// maps of their (batch, head, row) strides, out is written through its
// strides; the head dim D is 16, 32 or 64, one template instance each (the
// wrapper zero-pads any other d ≤ 64 to the next instance: zero columns
// change neither S nor P·V, and the padded output columns are dropped).
//
// What bounds it on an H100.  Per logit: one exp on the special-function
// unit (16 per clock per SM: 1.46 ms per layer at the production shape, 6.12
// G logits, at clocks.max.sm) and two products of 2·D operations on the
// tensor cores (0.79 ms at D 32 at the bf16 peak).  Around them a handful of
// fp32 operations (scale, max, sum) and a bf16 pack per two p.  The design
// keeps the exp unit fed while the products run beside it, on
// gemm_wgmma.cuh's pieces (those of the backward pair, flash_bwd.cu):
// - A block is four warpgroups (512 threads, one block per SM) and owns
//   192 queries of one (batch, head).  In the producer warpgroup one thread
//   issues the TMA loads: the block's queries (and K1's null K and V) once,
//   then each K tile of BN keys (128; 64 at D 64) and its V tile into a
//   4-stage mbarrier ring; rows past Nq and Nkv arrive as zeros.  The three
//   consumer warpgroups own 64 queries each and 160 registers a thread (24
//   a producer thread: the launch's 128 × 512).  Three consumers, not two:
//   the exps of a tile wait on its S, its row max (K15) and the pack of
//   the tile before, and a third warp on each scheduler keeps the exp unit
//   busy through those waits (two ran 15-63% slower at D 32).
// - Both products are wgmma with A in registers: S = Q Kᵀ with the
//   consumer's Q read once into k16 A fragments and the K tile an
//   index-major B (one m64nBN group of D/16 instructions); O += P V with P
//   the S accumulators packed to bf16 (two adjacent n8 tiles are one k16 A
//   fragment) and the V tile read k-major through the transpose bit.  S, p
//   and O never leave registers.  Tiles lie in the swizzle of a row's 2D
//   bytes (32, 64 or 128), in the tensor maps and the descriptors alike.
// - K1's l comes from the tensor cores, as the TPU kernel's ones column
//   does: beside each P V instruction an m64n8k16 wgmma of the same P
//   against a tile of bf16 ones sums exactly the bf16 p that P V takes (12%
//   faster than unpacking and adding them).  K15's l sums the fp32 p.
// - Overlap: the consumers take turns at the tensor cores (named barriers
//   3-5, as the backward pair does): in its turn a consumer issues S of
//   tile t, then P V of tile t − 1, and hands the turn over; its exps of
//   tile t start once S is done and run beside its own P V and the other
//   consumers' products.  The first turn (S only) and the last (P V only)
//   are peeled, so that no wgmma sits under a branch (ptxas serialises
//   wgmmas there).
// - p = ex2.approx(S · scale·log2e − m·log2e): one FFMA and one MUFU per
//   logit; m is kept in log2 units (K1: the constant B·log2e).  A p below
//   2^-126 flushes to 0: K15's p are relative to the row max; K1's are
//   rounded to bf16, whose denormals stop at 2^-133.  K15 takes the row max
//   of a whole tile (a quad reduction, two shuffles a row) and rescales O
//   and l once per tile, O after its P V of the tile before is done; its l
//   stays per lane and is reduced once at the end.
// - Masking: keys past Nkv (zero rows) get S = −∞ in the last tile only (a
//   uniform branch around register code); query rows past Nq are zeros and
//   are never stored.  K1's nulls are a 16-key tile loaded once beside Q
//   and taken before the first kv tile, masked past n_null (every column
//   when there is none: the phase has no branch).
// - No atomics: two launches on the same inputs give the same bits.
// The ptxas counts and notes are in build/torch_kernels/*.log; the trial's
// ablations and options are scripts/gemm_wgmma_trial.py --variants.
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

constexpr int BQ = 64;           // queries of a consumer warpgroup
constexpr int NULL_ROWS = 16;    // K1's nulls: one k16 tile
constexpr int MAX_NULL = 8;
constexpr int FWD_PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
    long long b, h, n;
};

constexpr int round_kb(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// The tiling of head dim D: C consumer warpgroups of 64 queries, BN keys a
// streamed tile (64 at D 64, whose O and Q take twice the registers),
// STAGES stages.  Tiles of rows as TMA leaves them: rows of 2D bytes in the
// swizzle of 2D bytes; a stage is a K tile and its V tile; the block's own
// area holds the consumers' queries, K1's null K and V, a tile of ones,
// then a barrier.
template <int D>
struct Fwd {
    static_assert(D == 16 || D == 32 || D == 64, "head dims 16, 32, 64");
    static constexpr int C = 3;
    static constexpr int BN = D == 64 ? 64 : 128;
    static constexpr int STAGES = 4;
    static constexpr int THREADS = (1 + C) * WG_THREADS;
    // a consumer thread's registers after setmaxnreg: what the producer's 24
    // leave of the launch's 65,536 / THREADS a thread (steps of 8)
    static constexpr int REGS =
        ((65536 / THREADS / 8 * 8) * (1 + C) - FWD_PRODUCER_REGS) / C / 8 * 8;
    static constexpr int SW = 2 * D;
    static constexpr int KV_BYTES = BN * SW;
    static constexpr int Q_BYTES = BQ * SW;
    static constexpr int NULL_BYTES = round_kb(NULL_ROWS * SW);
    static constexpr int NK_OFF = round_kb(C * Q_BYTES);   // null K, then V
    static constexpr int ONES_OFF = NK_OFF + 2 * NULL_BYTES;
    static constexpr int OWN = ONES_OFF + 1024;
    using R = Ring<STAGES, 2 * KV_BYTES, OWN + 1024, 1, 1, C>;
    static_assert(REGS <= 256 && FWD_PRODUCER_REGS + C * REGS <=
                                     (65536 / THREADS / 8 * 8) * (1 + C),
                  "the warpgroups' registers fit the block's");
    // index-major (rows × D, k along the row): k16 step kk
    __device__ __forceinline__ static uint64_t rows(uint32_t a, int kk) {
        return smem_desc<false, SW>(a + 32 * kk);
    }
    // k-major (the rows are k, D the index): k16 step i, 16 rows further
    __device__ __forceinline__ static uint64_t kmajor(uint32_t a, int i) {
        return smem_desc<true, SW>(a + 16 * SW * i);
    }
};

__device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
}

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
            a[kk][k] = lds_u32(tile + swizzled<Fwd<D>::SW>(
                                          row * Fwd<D>::SW + 2 * col));
        }
}

// S (64 × N) = Q · tileᵀ over the head dim: Q the consumer's A fragments,
// the tile's N rows index-major; one wgmma group
template <int N, int D>
__device__ __forceinline__ void logits(float (&s)[N / 8][4],
                                       const uint32_t (&qa)[D / 16][4],
                                       uint32_t tile) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        WgmmaRS<N, 0>::run(s, qa[kk], Fwd<D>::rows(tile, kk), kk > 0);
    wgmma_commit();
}

// O += P · tile (P: 64 × K in registers, k16 fragments; the tile's K rows
// read k-major), and for K1 (ONES) lacc += P · ones: each of its 8 columns
// sums the bf16 p of a row, as the TPU kernel's ones column in v does; one
// wgmma group
template <int K, int D, bool ONES>
__device__ __forceinline__ void times_v(float (&o)[D / 8][4],
                                        float (&lacc)[1][4],
                                        const uint32_t (&pa)[K / 16][4],
                                        uint32_t tile, uint32_t ones) {
#pragma unroll
    for (int i = 0; i < K / 16; ++i) {
        WgmmaRS<D, 1>::run(o, pa[i], Fwd<D>::kmajor(tile, i));
        if (ONES) WgmmaRS<8, 0>::run(lacc, pa[i], smem_desc<false, 32>(ones));
    }
    wgmma_commit();
}

// The exps of one tile's S in s, in place (s becomes p in fp32).  MASK:
// columns at or past kv_left are not keys.  ONLINE (K15): m is the running
// row max in log2 units; the tile's max moves it, corr = ex2(m_old − m_new)
// rescales l here and O in the caller, and l adds the fp32 p.  Else (K1) m
// holds B·log2e and l is the tensor cores' (times_v).
// Lane (g, t) holds rows g (e 0, 1) and g + 8 (e 2, 3), columns 8j + 2t, +1.
template <int J, bool MASK, bool ONLINE>
__device__ __forceinline__ void exps(float (&s)[J][4], float (&m)[2],
                                     float (&l)[2], float (&corr)[2],
                                     float c2, int kv_left) {
    const int col2 = 2 * (threadIdx.x & 3);
    if (MASK) {
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (8 * j + col2 + (e & 1) >= kv_left) s[j][e] = neg_inf();
    }
    if (ONLINE) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float mx = neg_inf();
#pragma unroll
            for (int j = 0; j < J; ++j)
                mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            // finite: every tile holds a key
            const float m_new = fmaxf(m[half], mx * c2);
            corr[half] = exp2_approx(m[half] - m_new);
            m[half] = m_new;
        }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2_approx(fmaf(s[j][e], c2, -m[e >> 1]));
            if (ONLINE) sum[e >> 1] += s[j][e];
        }
    if (ONLINE) {
        l[0] = fmaf(l[0], corr[0], sum[0]);
        l[1] = fmaf(l[1], corr[1], sum[1]);
    }
}

// The C consumer warpgroups take turns at the tensor cores (named barriers
// 3 .. 2 + C, two warpgroups' 256 threads each): warpgroup c waits for its
// turn (bar.sync 3 + c), issues its wgmmas of a tile, and hands the turn
// to the next (bar.arrive 3 + (c + 1) % C).  The last consumer hands
// consumer 0 the first turn and skips its last hand-over, so every arrival
// meets a wait.
__device__ __forceinline__ void my_turn(int cw) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(3 + cw), "n"(2 * WG_THREADS)
                 : "memory");
}
template <int C>
__device__ __forceinline__ void your_turn(int cw) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (cw + 1) % C),
                 "n"(2 * WG_THREADS)
                 : "memory");
}

// One block per (64·C queries, batch·head); consumer c owns queries 64c ..
// of the block.  Per BN-key tile: S = Q Kᵀ, p in its registers, O += P V.
template <bool ONLINE, int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap nk_map,
                 const __grid_constant__ CUtensorMap nv_map,
                 const float* __restrict__ bound_ptr, bf16* __restrict__ out,
                 float* __restrict__ lse, Strides os, int H, int Nq, int Nkv,
                 int n_null, float scale) {
    using F = Fwd<D>;
    using R = typename F::R;
    constexpr int C = F::C, BN = F::BN;
    constexpr bool ONES = !ONLINE;   // K1's l from the tensor cores
    extern __shared__ unsigned char smem_raw[];
    R ring(smem_raw);
    const uint32_t own = ring.extra(), own_bar = own + F::OWN;
    const uint32_t nkt = own + F::NK_OFF, nvt = nkt + F::NULL_BYTES;
    const uint32_t ones = own + F::ONES_OFF;
    if (threadIdx.x == 0) mbar_init(own_bar, 1);
    ring.init();
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * C * BQ;
    const int n_tiles = (Nkv + BN - 1) / BN;
    if (threadIdx.x < WG_THREADS) {   // the producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
            FWD_PRODUCER_REGS));
        if (threadIdx.x == 0) {
            mbar_expect_tx(own_bar, C * F::Q_BYTES +
                                        (ONLINE ? 0 : 2 * NULL_ROWS * F::SW));
#pragma unroll
            for (int c = 0; c < C; ++c)
                tma_load_4d(own + c * F::Q_BYTES, &q_map, 0, q0 + BQ * c, h,
                            b, own_bar);
            if constexpr (!ONLINE) {
                tma_load_4d(nkt, &nk_map, 0, 0, h, 0, own_bar);
                tma_load_4d(nvt, &nv_map, 0, 0, h, 0, own_bar);
            }
            for (int t = 0; t < n_tiles; ++t) {
                mbar_wait(ring.empty(), ring.phase ^ 1);
                const uint32_t st = ring.data(), full = ring.full();
                mbar_expect_tx(full, 2 * F::KV_BYTES);
                tma_load_4d(st, &k_map, 0, t * BN, h, b, full);
                tma_load_4d(st + F::KV_BYTES, &v_map, 0, t * BN, h, b, full);
                ring.advance();
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F::REGS));
    const int cw = threadIdx.x / WG_THREADS - 1;
    const bool signals = threadIdx.x % WG_THREADS == 0;
    const float c2 = scale * LOG2E;
    const float m0 = ONLINE ? neg_inf() : *bound_ptr * LOG2E;
    float o[D / 8][4], s[BN / 8][4], lacc[1][4];
    float m[2] = {m0, m0}, l[2] = {0.f, 0.f}, corr[2];
    zero(o);
    zero(s);
    zero(lacc);
    uint32_t qa[D / 16][4], pa[BN / 16][4];
    uint32_t held = 0;   // the empty barrier of the stage read a tile before
    if constexpr (ONES) {
        // a 1 KB tile of bf16 ones, written by the consumers' threads (with
        // no branch: ptxas serialises wgmmas behind a divergent path) and
        // made visible to wgmma (the async proxy) before any reads it
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         ones + 4 * ((threadIdx.x - WG_THREADS) % 256)),
                     "r"(0x3f803f80u)
                     : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 2, %0;\n" ::"n"(C * WG_THREADS) : "memory");
    }
    mbar_wait(own_bar, 0);
    load_rows<D>(qa, own + cw * F::Q_BYTES);
    if constexpr (!ONLINE) {
        // K1's nulls before the first kv tile: S, p and P V of one 16-key
        // tile, masked past n_null, done before the turns begin
        float sn[2][4];
        uint32_t pn[1][4];
        zero(sn);
        wgmma_fence();
        logits<NULL_ROWS, D>(sn, qa, nkt);
        wgmma_wait<0>();
        fence_acc(sn);
        exps<2, true, false>(sn, m, l, corr, c2, n_null);
        pack_a<2>(pn, sn);
        wgmma_fence();
        times_v<NULL_ROWS, D, ONES>(o, lacc, pn, nvt, ones);
        wgmma_wait<0>();
        fence_acc(o);
        fence_acc(lacc);
    }
    // once S of tile t (and the groups issued before it) is done: p in
    // place while P V of tile t − 1 runs; then, that done too, the stage
    // before is released, K15's O rescaled, and p packed as A fragments
    auto math = [&](int t) {
        wgmma_wait<1>();
        fence_acc(s);
        const int kv_left = Nkv - t * BN;
        if (kv_left >= BN)
            exps<BN / 8, false, ONLINE>(s, m, l, corr, c2, kv_left);
        else
            exps<BN / 8, true, ONLINE>(s, m, l, corr, c2, kv_left);
        wgmma_wait<0>();
        fence_acc(o);
        fence_acc(lacc);
        fence_acc(s);
        if (held && signals) mbar_arrive(held);
        if (ONLINE) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
        }
        pack_a<BN / 8>(pa, s);
    };
    if (cw == C - 1) your_turn<C>(cw);
    // turn t issues S of tile t and P V of tile t − 1; the first turn's
    // empty group stands for the P V of no tile
    mbar_wait(ring.full(), ring.phase);
    uint32_t kt = ring.data();
    my_turn(cw);
    wgmma_fence();
    logits<BN, D>(s, qa, kt);
    wgmma_commit();
    your_turn<C>(cw);
    math(0);
    for (int t = 1; t < n_tiles; ++t) {
        held = ring.empty();
        const uint32_t before = kt;
        ring.advance();
        mbar_wait(ring.full(), ring.phase);
        kt = ring.data();
        my_turn(cw);
        wgmma_fence();
        logits<BN, D>(s, qa, kt);
        times_v<BN, D, ONES>(o, lacc, pa, before + F::KV_BYTES, ones);
        your_turn<C>(cw);
        math(t);
    }
    held = ring.empty();
    my_turn(cw);
    wgmma_fence();
    times_v<BN, D, ONES>(o, lacc, pa, kt + F::KV_BYTES, ones);
    if (cw != C - 1) your_turn<C>(cw);
    wgmma_wait<0>();
    fence_acc(o);
    fence_acc(lacc);
    if (signals) mbar_arrive(held);

    // out = O / l; lse = m + log l (K1: B + log l)
    bf16* ob = out + b * os.b + h * os.h;
    const int r0 = q0 + BQ * cw;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float lt = l[half];
        if (ONES) {   // every column of lacc holds the row's sum
            lt = lacc[0][2 * half];
        } else {
            lt += __shfl_xor_sync(0xffffffffu, lt, 1);
            lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        }
        const int row = r0 + wg_row(2 * half);
        if (row >= Nq) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(ob + row * os.n + wg_col(j, 0)) =
                pack_bf16(o[j][2 * half] / lt, o[j][2 * half + 1] / lt);
        if (lse != nullptr && (threadIdx.x & 3) == 0)
            lse[(size_t)blockIdx.y * Nq + row] =
                (ONLINE ? m[half] * LN2 : *bound_ptr) + logf(lt);
    }
}

template <int D>
constexpr bool smem_fits() {
    return Fwd<D>::R::SMEM_BYTES <= 232448 && Fwd<D>::Q_BYTES % 1024 == 0 &&
           Fwd<D>::KV_BYTES % 1024 == 0;
}
static_assert(smem_fits<16>() && smem_fits<32>() && smem_fits<64>(),
              "the ring fits, tiles keep the swizzle's 1024-byte alignment");

template <bool ONLINE, int D>
int launch_d(const CUtensorMap (&maps)[5], const void* bound, void* out,
             void* lse, Strides os, int B, int H, int Nq, int Nkv,
             int n_null, float scale, void* stream) {
    using F = Fwd<D>;
    constexpr int smem = F::R::SMEM_BYTES;
    cudaError_t e = allow_smem(flash_fwd_kernel<ONLINE, D>, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nq + F::C * BQ - 1) / (F::C * BQ), B * H);
    flash_fwd_kernel<ONLINE, D>
        <<<grid, F::THREADS, smem, (cudaStream_t)stream>>>(
            maps[0], maps[1], maps[2], maps[3], maps[4], (const float*)bound,
            (bf16*)out, (float*)lse, os, H, Nq, Nkv, n_null, scale);
    return (int)cudaGetLastError();
}

// K1 (ONLINE false) or K15 at head dim D (16, 32 or 64).  q, k and v as 4-D
// tensor maps in boxes of 64 query rows and BN key rows; K1's nulls (h,
// n_null, d), contiguous, in boxes of 16 rows (K15: none, k's and v's maps
// stand in)
template <bool ONLINE, int D>
int launch_maps(const void* q, const void* k, const void* v, const void* nk,
                const void* nv, const void* bound, void* out, void* lse,
                Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
                int Nq, int Nkv, int n_null, float scale, void* stream) {
    CUtensorMap maps[5];
    const int nn = n_null > 0 ? n_null : 1;   // K1 without nulls: a dummy row
    if (!tma_map_4d(&maps[0], q, B, H, Nq, D, qs.b, qs.h, qs.n, BQ) ||
        !tma_map_4d(&maps[1], k, B, H, Nkv, D, ks.b, ks.h, ks.n, Fwd<D>::BN) ||
        !tma_map_4d(&maps[2], v, B, H, Nkv, D, vs.b, vs.h, vs.n, Fwd<D>::BN))
        return (int)cudaErrorInvalidValue;
    if (ONLINE) {
        maps[3] = maps[1];
        maps[4] = maps[2];
    } else if (!tma_map_4d(&maps[3], nk, 1, H, nn, D, 0, (long long)nn * D, D,
                           NULL_ROWS) ||
               !tma_map_4d(&maps[4], nv, 1, H, nn, D, 0, (long long)nn * D, D,
                           NULL_ROWS)) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_d<ONLINE, D>(maps, bound, out, lse, os, B, H, Nq, Nkv,
                               n_null, scale, stream);
}

template <bool ONLINE>
int launch(const void* q, const void* k, const void* v, const void* nk,
           const void* nv, const void* bound, void* out, void* lse,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int Nq, int Nkv, int n_null, int D, float scale, void* stream) {
    if (B < 1 || H < 1 || Nq < 1 || Nkv < 1 || n_null < 0 ||
        n_null > MAX_NULL)
        return (int)cudaErrorInvalidValue;
    switch (D) {
        case 16:
            return launch_maps<ONLINE, 16>(q, k, v, nk, nv, bound, out, lse,
                                           qs, ks, vs, os, B, H, Nq, Nkv,
                                           n_null, scale, stream);
        case 32:
            return launch_maps<ONLINE, 32>(q, k, v, nk, nv, bound, out, lse,
                                           qs, ks, vs, os, B, H, Nq, Nkv,
                                           n_null, scale, stream);
        case 64:
            return launch_maps<ONLINE, 64>(q, k, v, nk, nv, bound, out, lse,
                                           qs, ks, vs, os, B, H, Nq, Nkv,
                                           n_null, scale, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

VIT_API int vit_flash_static_fwd(
    const void* q, const void* k, const void* v, const void* nk,
    const void* nv, const void* bound, void* out, void* lse, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, int B, int H, int Nq, int Nkv, int n_null, int D,
    float scale, void* stream) {
    return launch<false>(q, k, v, nk, nv, bound, out, lse,
                         Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
                         Strides{vsb, vsh, vsn}, Strides{osb, osh, osn}, B, H,
                         Nq, Nkv, n_null, D, scale, stream);
}

VIT_API int vit_flash_online_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long qsb, long long qsh, long long qsn, long long ksb, long long ksh,
    long long ksn, long long vsb, long long vsh, long long vsn, long long osb,
    long long osh, long long osn, int B, int H, int Nq, int Nkv, int D,
    float scale, void* stream) {
    return launch<true>(q, k, v, nullptr, nullptr, nullptr, out, lse,
                        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
                        Strides{vsb, vsh, vsn}, Strides{osb, osh, osn}, B, H,
                        Nq, Nkv, 0, D, scale, stream);
}
