// K11's act stage (geglu_int8_h, the same C entry point as
// vit_exp_tpu_torch/csrc/geglu_ff_int8.cu) in the two designs that
// scripts/gemm_wgmma_trial.py --variants times against the shipped
// cooperative one; DESIGN picks one: 1 ping-pong, 2 overlapped.  Both give
// the shipped kernel's bits.
//   ping-pong: each consumer warpgroup takes whole 128 × (64 | 64) tiles
//     from a ring of its own (two m64 wgmmas a k step), and an ordered pair
//     of named barriers lets one issue its mainloop while the other runs
//     its epilogue.
//   overlapped: both consumers share 128 × (64 | 64) tiles; with two
//     accumulator sets, a tile's epilogue runs in slices between the next
//     tile's k steps.
// Built alone, with -I vit_exp_tpu_torch/csrc, into a library of its own.
#include "gemm_wgmma.cuh"

#define DESIGN 1

using namespace vit;

namespace {

using s8 = signed char;

constexpr int AMAX_TILE = 64;   // inner columns of one partial amax
// act, overlapped: 128 tokens × HV_COLS inner columns a tile, B = [val |
// gate]; a consumer runs a tile's GEGLU epilogue in slices between the next
// tile's k steps (two accumulator sets); act leaves through a staging of 64
// × HV_COLS fp32 a consumer
constexpr int HV_COLS = 64, HV_STAGES = 6;
using HvGemm = WgGemm<HV_COLS, 2, false, false, s8>;
using HvOut = Staging<HV_COLS / 32>;
using HvRing = Ring<HV_STAGES, HvGemm::STAGE_BYTES, 2 * HvOut::BYTES>;
constexpr int HV_G0 = HV_COLS / 8;   // the first n8 tile of the gate columns
// act, ping-pong: each consumer takes whole tiles of 128 tokens × HP_COLS
// inner columns from a ring of its own; act leaves in parts of 32 columns
constexpr int HP_COLS = 64, HP_STAGES = 3;
using HpGemm = WgGemm<HP_COLS, 2, false, false, s8>;
using HpOut = Staging<2>;   // a part: rows 0-63 and 64-127 × 32 fp32
using HpRing = Ring<HP_STAGES, HpGemm::STAGE_BYTES, 2 * HpOut::BYTES, 2>;

// As consume (A from the ring), calling each(s) after the wgmmas of k step
// s are issued: the warpgroup's work beside them (the previous tile's
// epilogue, on other registers), which the tensor cores no longer wait out.
template <class G, class R, class Each>
__device__ __forceinline__ void consume_with(
    R& ring, typename G::Acc (&acc)[G::N / 8][4], int k_begin, int k_end,
    Each&& each) {
    static_assert(!G::A_RES, "A from the ring");
    const int cw = threadIdx.x / WG_THREADS - 1;
    const bool signals = threadIdx.x % WG_THREADS == 0;
    uint32_t held = 0;
    fence_acc(acc);
    int s = 0;
    for (int k0 = k_begin; k0 < k_end; k0 += G::STEP_K, ++s) {
        mbar_wait(ring.full(), ring.phase);
        const uint32_t a = ring.data() + cw * CHUNK_BYTES;
        const uint32_t b = ring.data() + G::B_OFFSET;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < STEP_BYTES / 32; ++kk) {
            const uint64_t da = smem_desc<G::A_KMAJOR>(a + kk * G::A_INSTR);
            const uint64_t db = smem_desc<G::B_KMAJOR>(b + kk * G::B_INSTR);
            if constexpr (G::S8)
                WgmmaS8<G::N>::run(acc, da, db);
            else
                Wgmma<G::N, G::A_KMAJOR, G::B_KMAJOR>::run(acc, da, db);
        }
        wgmma_commit();
        each(s);
        wgmma_wait<1>();
        if (held && signals) mbar_arrive(held);
        held = ring.empty();
        ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held && signals) mbar_arrive(held);
}

// The k steps of one GEMM of a 128-row tile that one consumer warpgroup
// owns (its own ring): acc[h] += A's rows 64h .. 64h + 63 · the N columns
// of B, two m64 wgmmas a k32 step on one B.  Returns with every wgmma done
// and every stage it read released.
template <class G, class R>
__device__ __forceinline__ void consume_rows128(
    R& ring, typename G::Acc (&acc0)[G::N / 8][4],
    typename G::Acc (&acc1)[G::N / 8][4], int k_begin, int k_end) {
    static_assert(!G::A_RES, "A from the ring");
    const bool signals = threadIdx.x % WG_THREADS == 0;
    uint32_t held = 0;
    fence_acc(acc0);
    fence_acc(acc1);
    for (int k0 = k_begin; k0 < k_end; k0 += G::STEP_K) {
        mbar_wait(ring.full(), ring.phase);
        const uint32_t a = ring.data(), b = ring.data() + G::B_OFFSET;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < STEP_BYTES / 32; ++kk) {
            const uint64_t db = smem_desc<G::B_KMAJOR>(b + kk * G::B_INSTR);
            const uint64_t da0 = smem_desc<G::A_KMAJOR>(a + kk * G::A_INSTR);
            const uint64_t da1 =
                smem_desc<G::A_KMAJOR>(a + CHUNK_BYTES + kk * G::A_INSTR);
            if constexpr (G::S8) {
                WgmmaS8<G::N>::run(acc0, da0, db);
                WgmmaS8<G::N>::run(acc1, da1, db);
            } else {
                Wgmma<G::N, G::A_KMAJOR, G::B_KMAJOR>::run(acc0, da0, db);
                Wgmma<G::N, G::A_KMAJOR, G::B_KMAJOR>::run(acc1, da1, db);
            }
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (held && signals) mbar_arrive(held);
        held = ring.empty();
        ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    if (held && signals) mbar_arrive(held);
}

// The order of two ping-pong consumers' mainloops: the block's tiles i =
// 0, 1, ... alternate between consumer 0 (even) and 1 (odd), and tile i's
// mainloop starts once tile i − 1's has ended (named barriers 3 and 4, a
// consumer's 128 threads waiting, the other's 128 arriving).
struct TurnBarrier {
    // before tile i's mainloop (consumer i % 2)
    __device__ __forceinline__ static void wait(int i) {
        if (i > 0)
            asm volatile("bar.sync %0, %1;\n" ::"r"(3 + (i & 1)),
                         "n"(2 * WG_THREADS)
                         : "memory");
    }
    // after it, where tile i + 1 of n exists
    __device__ __forceinline__ static void pass(int i, int n) {
        if (i + 1 < n)
            asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + ((i + 1) & 1)),
                         "n"(2 * WG_THREADS)
                         : "memory");
    }
};

// the staging's chunks stored at a row each
template <class S, int N>
__device__ __forceinline__ void release_rows(const S& out,
                                             const CUtensorMap* const (&map)[N],
                                             const int (&col)[N],
                                             const int (&row)[N]) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();
    if (threadIdx.x % WG_THREADS == 0) {
#pragma unroll
        for (int c = 0; c < N; ++c)
            tma_store(map[c], out.base + c * CHUNK_BYTES, col[c], row[c]);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
}

// The GEGLU of a consumer's m64 tile on its accumulators h (val in the n8
// tiles j < G0, gate in G0 + j, the same lanes), in the twin's order
// without fused multiply-adds; rs: s_y of the lane's two rows.  Columns
// past I have zero sums and read zero scales, so their act is 0.  act[j][e]
// and amax[half][p], the lane's amax over its part of each AMAX_TILE
// columns.
template <int G0>
__device__ __forceinline__ void geglu_tile(const int (&h)[2 * G0][4],
                                           const float (&rs)[2],
                                           const float* __restrict__ s1,
                                           int n0, int inner,
                                           float (&act)[G0][4],
                                           float (&amax)[2][G0 * 8 /
                                                            AMAX_TILE]) {
    constexpr int PT = AMAX_TILE / 8;   // n8 tiles of one partial amax
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < G0 / PT; ++p) amax[half][p] = 0.f;
#pragma unroll
    for (int j = 0; j < G0; ++j) {
        const int col = n0 + wg_col(j, 0);
        float2 sv = make_float2(0.f, 0.f), sg = sv;
        if (col < inner) {   // inner % 16 == 0
            sv = *reinterpret_cast<const float2*>(s1 + col);
            sg = *reinterpret_cast<const float2*>(s1 + inner + col);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float s = rs[e >> 1];
            const float val = __fmul_rn(__fmul_rn((float)h[j][e], s),
                                        e & 1 ? sv.y : sv.x);
            const float g = __fmul_rn(__fmul_rn((float)h[G0 + j][e], s),
                                      e & 1 ? sg.y : sg.x);
            const float gelu = __fmul_rn(
                __fmul_rn(0.5f, g),
                __fadd_rn(1.f, erff(__fmul_rn(g, 0.70710678118654752f))));
            act[j][e] = __fmul_rn(gelu, val);
            amax[e >> 1][j / PT] = fmaxf(amax[e >> 1][j / PT], fabsf(act[j][e]));
        }
    }
}

// The partial amaxes of a consumer's m64 tile at row m0, column n0: a row's
// AMAX_TILE columns lie in the quad of lanes that holds the row
template <int P>
__device__ __forceinline__ void store_partials(const float (&amax)[2][P],
                                               float* __restrict__ amax_part,
                                               int m0, int n0, int M,
                                               int inner) {
    const int parts = (inner + AMAX_TILE - 1) / AMAX_TILE;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < P; ++p) {
            float v = amax[half][p];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const int row = m0 + wg_row(2 * half);
            const int c0 = n0 + p * AMAX_TILE;
            if ((threadIdx.x & 3) == 0 && row < M && c0 < inner)
                amax_part[(size_t)row * parts + c0 / AMAX_TILE] = v;
        }
}

// act and its partial amaxes, ping-pong: consumer c takes the block's
// tiles i ≡ c (mod 2), 128 tokens × HP_COLS inner columns each, column tile
// fastest, from its own ring; its mainloop waits for the other's to end
// (TurnBarrier), so one consumer's epilogue runs under the other's wgmmas
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_int8_hp_kernel(const __grid_constant__ CUtensorMap y8_map,
                     const __grid_constant__ CUtensorMap val_map,
                     const __grid_constant__ CUtensorMap gate_map,
                     const __grid_constant__ CUtensorMap act_map,
                     const float* __restrict__ sy,
                     const float* __restrict__ s1,
                     float* __restrict__ amax_part, int M, int D, int inner) {
    extern __shared__ unsigned char smem_raw[];
    HpRing(smem_raw).init();
    const int col_tiles = (inner + HP_COLS - 1) / HP_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    // the block's tiles t_i = blockIdx.x + i · gridDim.x, i < n
    const int n = ((int)blockIdx.x < tiles)
                      ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                      : 0;
    if (threadIdx.x < WG_THREADS) {   // the producer: tile i into ring i % 2
        producer_regs();
        if (threadIdx.x == 0) {
            HpRing r0(smem_raw, 0), r1(smem_raw, 1);
            const CUtensorMap* const b[2] = {&val_map, &gate_map};
            for (int i = 0; i < n; ++i) {
                const int t = blockIdx.x + i * gridDim.x;
                const int n0 = t % col_tiles * HP_COLS;
                const int b_n0[2] = {n0, n0};
                const int m0 = t / col_tiles * TILE_M;
                if (i & 1)
                    produce<HpGemm>(r1, &y8_map, m0, b, b_n0, 0, D);
                else
                    produce<HpGemm>(r0, &y8_map, m0, b, b_n0, 0, D);
            }
        }
        return;
    }
    consumer_regs();
    constexpr int G0 = HP_COLS / 8;
    const int cw = threadIdx.x / WG_THREADS - 1;
    HpRing ring(smem_raw, cw);
    const HpOut out(ring.extra());
    for (int i = cw; i < n; i += 2) {
        const int t = blockIdx.x + i * gridDim.x;
        const int m0 = t / col_tiles * TILE_M, n0 = t % col_tiles * HP_COLS;
        float rs[2][2];   // s_y of the lane's rows in each m64 tile
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half)
                rs[mt][half] = sy[min(m0 + 64 * mt + wg_row(2 * half), M - 1)];
        int h[2][HpGemm::N / 8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < HpGemm::N / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) h[mt][j][e] = 0;
        TurnBarrier::wait(i);
        consume_rows128<HpGemm>(ring, h[0], h[1], 0, D);
        TurnBarrier::pass(i, n);
        float act[2][G0][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            float amax[2][HP_COLS / AMAX_TILE];
            geglu_tile<G0>(h[mt], rs[mt], s1, n0, inner, act[mt], amax);
            store_partials(amax, amax_part, m0 + 64 * mt, n0, M, inner);
        }
        // act in parts of 32 columns, the two m64 tiles as the staging's
        // two chunks (the stores drop what lies past M and I)
        const CUtensorMap* const maps[2] = {&act_map, &act_map};
        const int rows[2] = {m0, m0 + 64};
#pragma unroll
        for (int part = 0; part < HP_COLS / 32; ++part) {
            out.acquire();
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int jj = part * 4 + j, col = wg_col(j, 0);
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        out.put(mt, wg_row(2 * half), col,
                                make_float2(act[mt][jj][2 * half],
                                            act[mt][jj][2 * half + 1]));
                }
            const int cols[2] = {n0 + 32 * part, n0 + 32 * part};
            release_rows(out, maps, cols, rows);
        }
    }
    out.drain();
}

// a tile of the overlapped act kernel: the consumer's first row, the
// tile's first inner column, and (loaded before its epilogue) s_y of the
// lane's two rows and the scales of its val and gate columns
struct HvTile {
    int m0, n0;
    float rs[2];
    float2 sv[HV_G0], sg[HV_G0];
};

__device__ __forceinline__ void hv_scales(HvTile& T,
                                          const float* __restrict__ sy,
                                          const float* __restrict__ s1,
                                          int M, int inner) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
        T.rs[half] = sy[min(T.m0 + wg_row(2 * half), M - 1)];
#pragma unroll
    for (int j = 0; j < HV_G0; ++j) {
        const int col = T.n0 + wg_col(j, 0);
        T.sv[j] = T.sg[j] = make_float2(0.f, 0.f);
        if (col < inner) {   // inner % 16 == 0
            T.sv[j] = *reinterpret_cast<const float2*>(s1 + col);
            T.sg[j] = *reinterpret_cast<const float2*>(s1 + inner + col);
        }
    }
}

// slice s of ks of tile T's epilogue on its accumulators h: the GEGLU of
// the n8 tiles j with j·ks / HV_G0 = s, in the twin's order without fused
// multiply-adds, into the staging and the lane's amax of each row
__device__ __forceinline__ void hv_slice(const int (&h)[2 * HV_G0][4],
                                         const HvTile& T, int s, int ks,
                                         float (&amax)[2], const HvOut& out) {
#pragma unroll
    for (int j = 0; j < HV_G0; ++j) {
        if (j * ks / HV_G0 != s) continue;
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float rs = T.rs[e >> 1];
            const float val = __fmul_rn(__fmul_rn((float)h[j][e], rs),
                                        e & 1 ? T.sv[j].y : T.sv[j].x);
            const float g = __fmul_rn(__fmul_rn((float)h[HV_G0 + j][e], rs),
                                      e & 1 ? T.sg[j].y : T.sg[j].x);
            const float gelu = __fmul_rn(
                __fmul_rn(0.5f, g),
                __fadd_rn(1.f, erff(__fmul_rn(g, 0.70710678118654752f))));
            a[e] = __fmul_rn(gelu, val);
            amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(a[e]));
        }
        const int col = wg_col(j, 0);
#pragma unroll
        for (int half = 0; half < 2; ++half)
            out.put(col >> 5, wg_row(2 * half), col & 31,
                    make_float2(a[2 * half], a[2 * half + 1]));
    }
}

// the end of tile T's epilogue: its partial amaxes, and act by TMA stores
// (which drop what lies past M and I)
__device__ __forceinline__ void hv_finish(const HvTile& T,
                                          const float (&amax)[2],
                                          float* __restrict__ amax_part,
                                          const CUtensorMap* act_map,
                                          const HvOut& out, int M,
                                          int inner) {
    const float am[2][1] = {{amax[0]}, {amax[1]}};
    store_partials(am, amax_part, T.m0, T.n0, M, inner);
    const CUtensorMap* maps[HV_COLS / 32];
    int cols[HV_COLS / 32];
#pragma unroll
    for (int c = 0; c < HV_COLS / 32; ++c) {
        maps[c] = act_map;
        cols[c] = T.n0 + 32 * c;
    }
    out.release(maps, cols, T.m0);
}

// One turn of the overlapped act kernel: the epilogue of tile cur (its
// products done, in hc) in slices beside the mainloop of the next tile t
// (into hn), or alone where there is none
__device__ __forceinline__ void hv_turn(HvRing& ring, const HvOut& out,
                                        HvTile& cur, int (&hc)[2 * HV_G0][4],
                                        HvTile& next, int (&hn)[2 * HV_G0][4],
                                        int t, int tiles, int col_tiles,
                                        const float* __restrict__ sy,
                                        const float* __restrict__ s1,
                                        float* __restrict__ amax_part,
                                        const CUtensorMap* act_map, int M,
                                        int D, int inner) {
    const int ks = (D + HvGemm::STEP_K - 1) / HvGemm::STEP_K;
    hv_scales(cur, sy, s1, M, inner);
    float amax[2] = {0.f, 0.f};
    out.acquire();
    if (t < tiles) {
        next.m0 = t / col_tiles * TILE_M + consumer_row0();
        next.n0 = t % col_tiles * HV_COLS;
#pragma unroll
        for (int j = 0; j < 2 * HV_G0; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) hn[j][e] = 0;
        consume_with<HvGemm>(ring, hn, 0, D, [&](int s) {
            hv_slice(hc, cur, s, ks, amax, out);
        });
    } else {
        for (int s = 0; s < ks; ++s) hv_slice(hc, cur, s, ks, amax, out);
    }
    hv_finish(cur, amax, amax_part, act_map, out, M, inner);
}

// act and its partial amaxes, overlapped: tiles of 128 tokens × HV_COLS
// inner columns, column tile fastest; each tile's epilogue runs beside the
// next tile's wgmmas
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_int8_hv_kernel(const __grid_constant__ CUtensorMap y8_map,
                     const __grid_constant__ CUtensorMap val_map,
                     const __grid_constant__ CUtensorMap gate_map,
                     const __grid_constant__ CUtensorMap act_map,
                     const float* __restrict__ sy,
                     const float* __restrict__ s1,
                     float* __restrict__ amax_part, int M, int D, int inner) {
    extern __shared__ unsigned char smem_raw[];
    HvRing ring(smem_raw);
    ring.init();
    const int col_tiles = (inner + HV_COLS - 1) / HV_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[2] = {&val_map, &gate_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int n0 = t % col_tiles * HV_COLS;
                const int b_n0[2] = {n0, n0};
                produce<HvGemm>(ring, &y8_map, t / col_tiles * TILE_M, b,
                                b_n0, 0, D);
            }
        }
        return;
    }
    consumer_regs();
    const HvOut out(ring.extra());
    HvTile ta, tb;
    int ha[2 * HV_G0][4], hb[2 * HV_G0][4];
    int t = blockIdx.x;
    // the first tile's products alone
    ta.m0 = t / col_tiles * TILE_M + consumer_row0();
    ta.n0 = t % col_tiles * HV_COLS;
#pragma unroll
    for (int j = 0; j < 2 * HV_G0; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ha[j][e] = 0;
    consume<HvGemm>(ring, ha, 0, D);
    // then turns, the two accumulator sets alternating
    while (true) {
        t += gridDim.x;
        hv_turn(ring, out, ta, ha, tb, hb, t, tiles, col_tiles, sy, s1,
                amax_part, &act_map, M, D, inner);
        if (t >= tiles) break;
        t += gridDim.x;
        hv_turn(ring, out, tb, hb, ta, ha, t, tiles, col_tiles, sy, s1,
                amax_part, &act_map, M, D, inner);
        if (t >= tiles) break;
    }
    out.drain();
}

bool shapes_ok(int M, int D, int I2) {
    return M >= 1 && D >= 16 && D % 16 == 0 && I2 >= 32 && I2 % 32 == 0;
}

}  // namespace

VIT_API int vit_geglu_int8_h(const void* y8, const void* sy, const void* w1t,
                             const void* s1, void* act, void* amax_part, int M,
                             int D, int I2, void* stream) {
    if (!shapes_ok(M, D, I2)) return (int)cudaErrorInvalidValue;
    const int inner = I2 / 2;
    const int cols = DESIGN == 2 ? HV_COLS : HP_COLS;
    CUtensorMap y8_map, val_map, gate_map, act_map;
    if (!tma_map<s8>(&y8_map, y8, M, D, D, TILE_M) ||
        !tma_map<s8>(&val_map, w1t, inner, D, D, cols) ||
        !tma_map<s8>(&gate_map, (const s8*)w1t + (size_t)inner * D, inner, D,
                     D, cols) ||
        !tma_map<float>(&act_map, act, M, inner, inner, 64))
        return (int)cudaErrorInvalidValue;
    const auto kernel =
        DESIGN == 2 ? geglu_int8_hv_kernel : geglu_int8_hp_kernel;
    const int smem = DESIGN == 2 ? HvRing::SMEM_BYTES : HpRing::SMEM_BYTES;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((inner + cols - 1) / cols);
    kernel<<<persistent_blocks(tiles), GEMM_THREADS, smem,
             (cudaStream_t)stream>>>(y8_map, val_map, gate_map, act_map,
                                     (const float*)sy, (const float*)s1,
                                     (float*)amax_part, M, D, inner);
    return (int)cudaGetLastError();
}
