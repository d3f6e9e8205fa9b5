// K12/K13: W8A8 fused LayerNorm + q/k/v projection.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_fwd_int8_kernel (two outputs) and
// ::_fwd_int8_kernel_3out (three outputs): one route with three output
// pointers serves both.  K14: W8A8 projection without bias.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_proj_int8_kernel.
//
// K12/K13 quantizes the CENTRED row x − μ per token (s_x = max|x − μ| /
// 127), multiplies by W = [γ⊙Wq | Wkv] quantized per column, and writes
// q = inv·deq to the first Fq columns and k/v = deq + μ·c (c: column sums
// of the dequantized Wkv) to the next Fk and the rest, where deq =
// acc·s_x·s_W (acc the int32 product).  Two kernels, each a stage with its
// plain twin in ops/fused_proj.py:
//   ln_qkv_int8_x_kernel: x, μ → x8 (M × K) and s_x (M); a row pass, one
//     warp per token, the row read once with 16-byte loads and held in
//     registers (K ≤ 2048), bytes bound.
//   ln_qkv_int8_mm_kernel: x8·W on the int8 form of gemm_wgmma.cuh's
//     Hopper mainloop: a producer warp's TMA loads of x8 (M × K) and Wᵀ
//     (F × K, the wrapper's transpose: 8-bit wgmma reads only index-major
//     operands) into an mbarrier ring, two consumer warpgroups on wgmma
//     m64n128k32 s8 with int32 accumulators in registers, 128-deep k
//     steps, 128 tokens × 128 columns a tile (six stages: a tile's k steps
//     at K 768 load while the one before runs its epilogue), a persistent
//     grid.  The
//     epilogue dequantizes the accumulators in the twin's order (no fused
//     multiply-add: the twin rounds each product and sum) and writes q, k
//     or v per column.  A tile whose 64-column chunks each lie in one
//     output (every tile at the full width, where Fq = Fk = Fv = 256)
//     leaves through a swizzled staging by TMA stores, one map per output,
//     at the chunk's column in it; a tile with a chunk that straddles Fq
//     or Fq + Fk, or whose output's pitch is not whole 16-byte units, is
//     stored from the registers, two adjacent columns of one output as one
//     bf16x2.
// What bounds it at 55,296 tokens, K 768, F 768: 85 MB of x read and 85 MB
// of q, k, v written (0.051 ms at 3.35 TB/s), plus the 42 MB of x8 written
// and read again between the stages.  |x8·W| ≤ K·127² stays below 2²⁴ up to
// K 1,040, so the conversion to fp32 is exact there (above, it rounds once,
// as the twin's does).  Any M; K % 16 == 0, K ≤ 2048 (the row pass), F %
// 16 == 0; any 0 < Fq, 0 < Fk, Fq + Fk < F (TMA zero-fills its loads past
// M, K and F and clips its stores; the register stores mask).
//
// K14's kernel (proj_int8_kernel), one pass: a block owns 64 rows of x
// (bf16, M × K).  It quantizes them per row (s_x = max|x| / 127) with
// 16-byte loads, a warp's rows held in its registers eight at a time
// (their loads in flight together), and writes the codes
// once into shared memory as plain rows for ldmatrix (pitch K + 16 bytes,
// K padded with zero codes to whole 128-deep k steps).  Meanwhile a
// cp.async ring streams Wᵀ (F × K int8, the wrapper's transpose; it stays in
// L2) in tiles of 128 columns × 128 of depth, gemm_mma.cuh's int8 operand
// tiles; the products run on mma.sync m16n8k32 with int32 accumulators in
// registers, and after the last k step of each column tile the epilogue
// dequantizes them in the twin's order, (acc·s_x)·s_W without FMA, into a
// staging tile per warp in shared memory (16 rows at a time), which the
// warp writes out as 16-byte row pieces (bf16x2 stores straight from the accumulators ran
// 1.5× slower as a whole).  The ring runs on across column tiles, so the
// next tile's weights arrive during an epilogue.  Bound at M = 55,296,
// K 256, F 768: 113 MB of x and out (0.034 ms), not its 22 G int8
// operations.  |acc| ≤ K·127² < 2²⁴, so out equals the twin's bits.  Any
// M; K % 16 == 0, K ≤ 1024 (the rows and the ring in 227 KB of shared
// memory), F % 16 == 0 (the last column tile's weights past F are
// zero-filled, its scales read as 0 and its columns past F not stored).
#include "gemm_mma.cuh"
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

using s8 = signed char;

// ---------------------------------------------------------------------------
// K12/K13
// ---------------------------------------------------------------------------

constexpr int ROW_WARPS = 8;      // tokens per block of the row pass
constexpr int ROW_CHUNK = 256;    // columns of one 16-byte load per lane
constexpr int MAX_K = 2048;       // 8 chunks: 32 registers of a held row
// the product: 128 tokens × 128 columns a tile on the int8 form of
// gemm_wgmma.cuh, six 128-deep k steps in the ring (all of K 768); q, k
// and v leave through a staging of MM_PART columns a consumer at a time
constexpr int MM_COLS = 128, MM_STAGES = 6, MM_PART = 128;
using MmGemm = WgGemm<MM_COLS, 1, false, false, s8>;
using MmOut = Staging<MM_PART / 64>;
using MmRing = Ring<MM_STAGES, MmGemm::STAGE_BYTES, 2 * MmOut::BYTES>;

// x8 and s_x; one warp per token, lane l holds columns 8(l + 32i) .. + 7
// for i < CHUNKS
template <int CHUNKS>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_qkv_int8_x_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                     s8* __restrict__ x8, float* __restrict__ sx, int M,
                     int K) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (r >= M) return;
    const bf16* xr = x + (size_t)r * K;
    const float m = mu[r];
    uint4 raw[CHUNKS];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
        const int c = 8 * lane + ROW_CHUNK * i;
        if (c >= K) continue;   // K % 8 == 0
        raw[i] = *reinterpret_cast<const uint4*>(xr + c);
        const bf16* xs = reinterpret_cast<const bf16*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            amax = fmaxf(amax,
                         fabsf(__fsub_rn(__bfloat162float(xs[j]), m)));
    }
    const float s = quant_scale(warp_max(amax));
    if (lane == 0) sx[r] = s;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
        const int c = 8 * lane + ROW_CHUNK * i;
        if (c >= K) continue;
        const bf16* xs = reinterpret_cast<const bf16*>(&raw[i]);
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            y[j] = __fsub_rn(__bfloat162float(xs[j]), m);
        *reinterpret_cast<uint2*>(x8 + (size_t)r * K + c) = quant8x8(y, s);
    }
}

// the output that column col lands in, as the address of its element in
// row 0 and that output's pitch: q, k or v
struct OutCol {
    bf16* p;
    int ld;
};
__device__ __forceinline__ OutCol qkv_col(bf16* q, bf16* k, bf16* v, int col,
                                          int Fq, int Fk, int Fv) {
    if (col < Fq) return {q + col, Fq};
    if (col < Fq + Fk) return {k + (col - Fq), Fk};
    return {v + (col - Fq - Fk), Fv};
}

// the output (0 q, 1 k, 2 v) of column col, and output o's first column
__device__ __forceinline__ int qkv_out(int col, int Fq, int Fk) {
    return col < Fq ? 0 : col < Fq + Fk ? 1 : 2;
}
__device__ __forceinline__ int qkv_start(int o, int Fq, int Fk) {
    return o == 0 ? 0 : o == 1 ? Fq : Fq + Fk;
}

// Whether the tile at column n0 leaves by TMA stores: each of its 64-column
// chunks holds columns of one output only (to F), and that output has a
// map (bit o of maps: its pitch and pointer are whole 16-byte units)
__device__ __forceinline__ bool tile_by_tma(int n0, int F, int Fq, int Fk,
                                            int maps) {
#pragma unroll
    for (int ch = 0; ch < MM_COLS / 64; ++ch) {
        const int c0 = n0 + 64 * ch;
        if (c0 >= F) break;
        const int o = qkv_out(c0, Fq, Fk);
        const int end = o == 2 ? F : qkv_start(o + 1, Fq, Fk);
        if (min(c0 + 64, F) > end || !(maps >> o & 1)) return false;
    }
    return true;
}

// q = inv·deq, k/v = deq + μ·c with deq = (x8·W)·s_x·s_W, for tiles of 128
// tokens × MM_COLS columns, column tile fastest
__global__ void __launch_bounds__(GEMM_THREADS, 1)
ln_qkv_int8_mm_kernel(const __grid_constant__ CUtensorMap x8_map,
                      const __grid_constant__ CUtensorMap wt_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ sx,
                      const float* __restrict__ mu,
                      const float* __restrict__ inv,
                      const float* __restrict__ sc,
                      const float* __restrict__ c, bf16* __restrict__ q,
                      bf16* __restrict__ k, bf16* __restrict__ v, int M,
                      int K, int F, int Fq, int Fk, int maps) {
    extern __shared__ unsigned char smem_raw[];
    MmRing ring(smem_raw);
    ring.init();
    const int col_tiles = (F + MM_COLS - 1) / MM_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[1] = {&wt_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int b_n0[1] = {t % col_tiles * MM_COLS};
                produce<MmGemm>(ring, &x8_map, t / col_tiles * TILE_M, b,
                                b_n0, 0, K);
            }
        }
        return;
    }
    consumer_regs();
    const MmOut out(ring.extra());
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * MM_COLS;
        // s_x, μ and inv of the lane's two rows, loaded while the products
        // run (a row past M is not stored)
        float rs[2], rm[2], ri[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = min(m0 + wg_row(2 * half), M - 1);
            rs[half] = sx[row];
            rm[half] = mu[row];
            ri[half] = inv[row];
        }
        int acc[MmGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < MmGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0;
        consume<MmGemm>(ring, acc, 0, K);

        // y of the accumulator pair a0, a1 of row half at column col (even,
        // < F) with the pair's scales s2 and colsums c2, in the twin's
        // order without fused multiply-adds
        auto pair = [&](int a0, int a1, int half, int col, float2 s2,
                        float2 c2) {
            const float s = half ? rs[1] : rs[0], m = half ? rm[1] : rm[0];
            const float iv = half ? ri[1] : ri[0];
            const float d0 = __fmul_rn(__fmul_rn((float)a0, s), s2.x);
            const float d1 = __fmul_rn(__fmul_rn((float)a1, s), s2.y);
            return make_float2(
                col < Fq ? __fmul_rn(iv, d0) : __fadd_rn(d0, __fmul_rn(m, c2.x)),
                col + 1 < Fq ? __fmul_rn(iv, d1)
                             : __fadd_rn(d1, __fmul_rn(m, c2.y)));
        };
        // the scales and colsums of the pair at column col, once for both
        // rows
        auto cols2 = [&](int col, float2& s2, float2& c2) {
            s2 = *reinterpret_cast<const float2*>(sc + col);
            c2 = *reinterpret_cast<const float2*>(c + col);
        };
        if (tile_by_tma(n0, F, Fq, Fk, maps)) {
            // parts of MM_PART columns through the staging; each chunk to
            // its output's map at its column there (the stores drop what
            // lies past M and past the output's width)
#pragma unroll
            for (int part = 0; part < MmGemm::N / MM_PART; ++part) {
                // the part's outputs first, packed, so that the loads of
                // the column constants are not held behind the staging's
                // stores and the wait for the staging overlaps the math
                uint32_t y[MM_PART / 8][2];
#pragma unroll
                for (int j = 0; j < MM_PART / 8; ++j) {
                    const int jj = part * MM_PART / 8 + j;
                    const int col = n0 + part * MM_PART + wg_col(j, 0);
                    float2 s2 = make_float2(0.f, 0.f), c2 = s2;
                    if (col < F) cols2(col, s2, c2);   // F % 16 == 0
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const float2 v2 = pair(acc[jj][2 * half],
                                               acc[jj][2 * half + 1], half,
                                               col, s2, c2);
                        y[j][half] = pack_bf16(v2.x, v2.y);
                    }
                }
                out.acquire();
#pragma unroll
                for (int j = 0; j < MM_PART / 8; ++j) {
                    const int cl = wg_col(j, 0);
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        out.put(cl >> 6, wg_row(2 * half), cl & 63,
                                y[j][half]);
                }
                const CUtensorMap* maps2[MM_PART / 64];
                int cols[MM_PART / 64];
#pragma unroll
                for (int ch = 0; ch < MM_PART / 64; ++ch) {
                    const int c0 = n0 + part * MM_PART + 64 * ch;
                    const int o = qkv_out(min(c0, F - 1), Fq, Fk);
                    maps2[ch] = o == 0 ? &q_map : o == 1 ? &k_map : &v_map;
                    cols[ch] = c0 - qkv_start(o, Fq, Fk);
                }
                out.release(maps2, cols, m0);
            }
        } else {
            // a chunk straddles Fq or Fq + Fk, or its output has no map:
            // stores from the registers, a column pair as one bf16x2 where
            // both columns lie in one output at an even pitch from a
            // 4-byte aligned start, else as two scalars
#pragma unroll
            for (int j = 0; j < MmGemm::N / 8; ++j) {
                const int col = n0 + wg_col(j, 0);
                if (col >= F) continue;
                const OutCol o0 = qkv_col(q, k, v, col, Fq, Fk, F - Fq - Fk);
                const OutCol o1 =
                    qkv_col(q, k, v, col + 1, Fq, Fk, F - Fq - Fk);
                const bool both = o1.p == o0.p + 1 && o1.ld == o0.ld &&
                                  (o0.ld & 1) == 0 &&
                                  (reinterpret_cast<size_t>(o0.p) & 3) == 0;
                float2 s2, c2;
                cols2(col, s2, c2);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = m0 + wg_row(2 * half);
                    if (row >= M) continue;
                    const float2 y = pair(acc[j][2 * half],
                                          acc[j][2 * half + 1], half, col, s2,
                                          c2);
                    bf16* p0 = o0.p + (size_t)row * o0.ld;
                    if (both) {
                        store_bf16x2(p0, y.x, y.y);
                    } else {
                        *p0 = __float2bfloat16(y.x);
                        o1.p[(size_t)row * o1.ld] = __float2bfloat16(y.y);
                    }
                }
            }
        }
    }
    out.drain();
}

bool qkv_shapes_ok(int M, int K, int F) {
    return M >= 1 && K >= 16 && K % 16 == 0 && K <= MAX_K && F >= 16 &&
           F % 16 == 0;
}

template <int CHUNKS>
int launch_x(const void* x, const void* mu, void* x8, void* sx, int M, int K,
             void* stream) {
    ln_qkv_int8_x_kernel<CHUNKS>
        <<<(unsigned)((M + ROW_WARPS - 1) / ROW_WARPS), ROW_WARPS * 32, 0,
           (cudaStream_t)stream>>>((const bf16*)x, (const float*)mu, (s8*)x8,
                                   (float*)sx, M, K);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

// the tile line (scripts/patch_embed_tile_trial.py rewrites it)
constexpr int PJ_ROWS = 64, PJ_COLS = 128, PJ_BK = 128, PJ_STAGES = 2;
constexpr int PJ_WM = 2, PJ_WN = 4, PJ_BLOCKS = 3;
constexpr int PJ_MAX_K = 1024;
// pitch (bf16) of a warp's staging tile of out: rows of WTN + 8, so the
// bf16x2 writes of a warp's eight rows fall on distinct banks
constexpr int PJ_LDO = PJ_COLS / PJ_WN + 8;
using PjCfg = GemmCfg<PJ_ROWS, PJ_COLS, PJ_BK, PJ_WM, PJ_WN, PJ_STAGES, 1,
                      s8>;

// the depth padded to whole k steps, and the shared memory of a launch
__host__ __device__ inline int pj_depth(int K) {
    return (K + PJ_BK - 1) / PJ_BK * PJ_BK;
}
int pj_smem(int K) {
    return PJ_STAGES * PjCfg::TB::ELEMS + PJ_ROWS * (pj_depth(K) + 16) +
           PJ_ROWS * (int)sizeof(float) +
           PjCfg::THREADS / 32 * 16 * PJ_LDO * (int)sizeof(bf16);
}

// out = (x8·W)·s_x·s_W; one block per PJ_ROWS rows; lane l of a row's warp
// quantizes columns 8(l + 32i) .. + 7 for i < CHUNKS
template <int CHUNKS>
__global__ void __launch_bounds__(PjCfg::THREADS, PJ_BLOCKS)
proj_int8_kernel(const bf16* __restrict__ x, const s8* __restrict__ wt,
                 const float* __restrict__ sc, bf16* __restrict__ out, int M,
                 int K, int F) {
    using C = PjCfg;
    constexpr int NW = C::THREADS / 32;
    // rows a warp loads at once: RB·CHUNKS 16-byte loads in flight a lane
    constexpr int RB = CHUNKS == 1 ? 8 : CHUNKS == 2 ? 4 : 2;
    static_assert(PJ_ROWS % (NW * RB) == 0, "whole batches of rows");
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int kp = pj_depth(K), lda = kp + 16;   // row pitch in bytes
    s8* ring = reinterpret_cast<s8*>(smem_raw);
    s8* sa = ring + C::STAGES * C::TB::ELEMS;
    float* srow = reinterpret_cast<float*>(sa + PJ_ROWS * lda);
    bf16* so = reinterpret_cast<bf16*>(srow + PJ_ROWS) +
               (threadIdx.x >> 5) * 16 * PJ_LDO;   // the warp's out tile
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = (warp / C::WN) * C::WTM, wn = (warp % C::WN) * C::WTN;
    const int m0 = blockIdx.x * PJ_ROWS;
    const int ksteps = kp / PJ_BK;
    const int total = (F + PJ_COLS - 1) / PJ_COLS * ksteps;
    const Mat8 w{wt, K, F, K};

    auto issue = [&](int s) {
        if (s < total) {
            const int nt = s / ksteps;
            C::TB::template load<C::THREADS>(
                ring + (s % C::STAGES) * C::TB::ELEMS, w, nt * PJ_COLS,
                (s - nt * ksteps) * PJ_BK, K, tid);
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) issue(s);

    // the block's rows, quantized once into sa while the first weight
    // tiles arrive: a warp loads RB rows at a time (all their loads in
    // flight together), then reduces and quantizes them; zero codes past K
    // (to kp) and past M
    for (int r0 = warp; r0 < PJ_ROWS; r0 += NW * RB) {
        uint4 raw[RB][CHUNKS];
        float amax[RB];
#pragma unroll
        for (int b = 0; b < RB; ++b) {
            const int gr = m0 + r0 + b * NW;
            const bf16* xr = x + (size_t)min(gr, M - 1) * K;
            amax[b] = 0.f;
#pragma unroll
            for (int i = 0; i < CHUNKS; ++i) {
                const int c = 8 * lane + ROW_CHUNK * i;
                raw[b][i] = make_uint4(0, 0, 0, 0);
                if (gr < M && c < K)   // K % 16 == 0
                    raw[b][i] = *reinterpret_cast<const uint4*>(xr + c);
            }
        }
#pragma unroll
        for (int b = 0; b < RB; ++b) {
#pragma unroll
            for (int i = 0; i < CHUNKS; ++i) {
                const bf16* xs = reinterpret_cast<const bf16*>(&raw[b][i]);
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    amax[b] = fmaxf(amax[b], fabsf(__bfloat162float(xs[j])));
            }
            const int r = r0 + b * NW;
            const float sr = quant_scale(warp_max(amax[b]));
            if (lane == 0) srow[r] = sr;
            s8* dst = sa + r * lda;
#pragma unroll
            for (int i = 0; i < CHUNKS; ++i) {
                const int c = 8 * lane + ROW_CHUNK * i;
                if (c >= K) continue;
                const bf16* xs = reinterpret_cast<const bf16*>(&raw[b][i]);
                float y[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) y[j] = __bfloat162float(xs[j]);
                *reinterpret_cast<uint2*>(dst + c) = quant8x8(y, sr);
            }
            for (int c = K + 8 * lane; c < kp; c += 256)
                *reinterpret_cast<uint2*>(dst + c) = make_uint2(0, 0);
        }
    }

    int acc[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    const bf16* sa16 = reinterpret_cast<const bf16*>(sa);
    const int lda16 = lda / 2;
    for (int s = 0; s < total; ++s) {
        cp_async_wait<C::STAGES - 2>();   // this thread's copies of step s
        __syncthreads();   // copies and codes visible; the oldest stage free
        issue(s + C::STAGES - 1);
        const int tile = s / ksteps, ks = s - tile * ksteps;
        const bf16* sb = reinterpret_cast<const bf16*>(
            ring + (s % C::STAGES) * C::TB::ELEMS);
#pragma unroll
        for (int kk = 0; kk < C::BK16; kk += 16) {
            uint32_t af[C::MT][4];
            const int ka = ks * (PJ_BK / 2) + kk;   // in b16 units
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt)
                ldsm_x4(af[mt], sa16 + (wm + mt * 16 + (lane & 15)) * lda16 +
                                    ka + ((lane >> 4) << 3));
#pragma unroll
            for (int np = 0; np < C::NT / 2; ++np) {
                uint32_t bfr[4];
                frag_b2<C::TB::LD16>(bfr, sb, wn + np * 16, kk, lane);
#pragma unroll
                for (int mt = 0; mt < C::MT; ++mt) {
                    mma_s8(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
                    mma_s8(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
                }
            }
        }
        if (ks != ksteps - 1) continue;
        // the column tile is done: per m16 tile, dequantize in the twin's
        // order into the warp's staging tile, then write its 16 rows as
        // 16-byte pieces
        constexpr int ROW_CHUNKS = C::WTN / 8;   // 16-byte chunks of a row
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < C::NT; ++nt) {
                const int cl = nt * 8 + 2 * (lane & 3);   // in the warp's tile
                const int col = tile * PJ_COLS + wn + cl;   // F % 16 == 0
                const float2 s2 =
                    col < F ? *reinterpret_cast<const float2*>(sc + col)
                            : make_float2(0.f, 0.f);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int rl = half * 8 + (lane >> 2);
                    int* a = acc[mt][nt] + 2 * half;
                    const float sr = srow[wm + mt * 16 + rl];
                    store_bf16x2(
                        so + rl * PJ_LDO + cl,
                        __fmul_rn(__fmul_rn((float)a[0], sr), s2.x),
                        __fmul_rn(__fmul_rn((float)a[1], sr), s2.y));
                    a[0] = a[1] = 0;
                }
            }
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 16 * ROW_CHUNKS / 32; ++i) {
                const int c = lane + 32 * i, rl = c / ROW_CHUNKS;
                const int cc = (c - rl * ROW_CHUNKS) * 8;
                const int gr = m0 + wm + mt * 16 + rl;
                const int col = tile * PJ_COLS + wn + cc;
                if (gr < M && col < F)
                    *reinterpret_cast<uint4*>(out + (size_t)gr * F + col) =
                        *reinterpret_cast<const uint4*>(so + rl * PJ_LDO +
                                                        cc);
            }
            __syncwarp();   // the staging tile is free again
        }
    }
}

template <int CHUNKS>
int launch_proj(const void* x, const void* wt, const void* sc, void* out,
                int M, int K, int F, void* stream) {
    const int smem = pj_smem(K);
    cudaError_t e = allow_smem(proj_int8_kernel<CHUNKS>, smem);
    if (e != cudaSuccess) return (int)e;
    proj_int8_kernel<CHUNKS>
        <<<(unsigned)((M + PJ_ROWS - 1) / PJ_ROWS), PjCfg::THREADS, smem,
           (cudaStream_t)stream>>>((const bf16*)x, (const s8*)wt,
                                   (const float*)sc, (bf16*)out, M, K, F);
    return (int)cudaGetLastError();
}

}  // namespace

VIT_API int vit_ln_qkv_int8_x(const void* x, const void* mu, void* x8,
                              void* sx, int M, int K, void* stream) {
    if (!qkv_shapes_ok(M, K, 16)) return (int)cudaErrorInvalidValue;
    switch ((K + ROW_CHUNK - 1) / ROW_CHUNK) {
        case 1: return launch_x<1>(x, mu, x8, sx, M, K, stream);
        case 2: return launch_x<2>(x, mu, x8, sx, M, K, stream);
        case 3: return launch_x<3>(x, mu, x8, sx, M, K, stream);
        case 4: return launch_x<4>(x, mu, x8, sx, M, K, stream);
        case 5: return launch_x<5>(x, mu, x8, sx, M, K, stream);
        case 6: return launch_x<6>(x, mu, x8, sx, M, K, stream);
        case 7: return launch_x<7>(x, mu, x8, sx, M, K, stream);
        default: return launch_x<8>(x, mu, x8, sx, M, K, stream);
    }
}

VIT_API int vit_ln_qkv_int8_mm(const void* x8, const void* sx, const void* mu,
                               const void* inv, const void* wt, const void* sc,
                               const void* c, void* q, void* k, void* v, int M,
                               int K, int F, int Fq, int Fk, void* stream) {
    if (!qkv_shapes_ok(M, K, F) || Fq < 1 || Fk < 1 || Fq + Fk >= F)
        return (int)cudaErrorInvalidValue;
    // x8 (M × K) and Wᵀ (F × K), both index-major; q, k and v each in boxes
    // of 64 × 64 where its pitch and pointer are whole 16-byte units (bit
    // o of maps), else its tiles are stored from the registers
    CUtensorMap x8_map, wt_map, out_map[3] = {};
    if (!tma_map<s8>(&x8_map, x8, M, K, K, TILE_M) ||
        !tma_map<s8>(&wt_map, wt, F, K, K, MM_COLS))
        return (int)cudaErrorInvalidValue;
    void* const outs[3] = {q, k, v};
    const int widths[3] = {Fq, Fk, F - Fq - Fk};
    int maps = 0;
    for (int o = 0; o < 3; ++o) {
        if (widths[o] % 8 || reinterpret_cast<size_t>(outs[o]) % 16) continue;
        if (!tma_map(&out_map[o], outs[o], M, widths[o], widths[o], 64))
            return (int)cudaErrorInvalidValue;
        maps |= 1 << o;
    }
    cudaError_t e = allow_smem(ln_qkv_int8_mm_kernel, MmRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((F + MM_COLS - 1) / MM_COLS);
    ln_qkv_int8_mm_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                            MmRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        x8_map, wt_map, out_map[0], out_map[1], out_map[2], (const float*)sx,
        (const float*)mu, (const float*)inv, (const float*)sc,
        (const float*)c, (bf16*)q, (bf16*)k, (bf16*)v, M, K, F, Fq, Fk, maps);
    return (int)cudaGetLastError();
}

VIT_API int vit_proj_int8_fwd(const void* x, const void* wt, const void* sc,
                              void* out, int M, int K, int F, void* stream) {
    if (M < 1 || K < 16 || K % 16 || K > PJ_MAX_K || F < 16 || F % 16)
        return (int)cudaErrorInvalidValue;
    switch ((K + ROW_CHUNK - 1) / ROW_CHUNK) {
        case 1: return launch_proj<1>(x, wt, sc, out, M, K, F, stream);
        case 2: return launch_proj<2>(x, wt, sc, out, M, K, F, stream);
        case 3: return launch_proj<3>(x, wt, sc, out, M, K, F, stream);
        default: return launch_proj<4>(x, wt, sc, out, M, K, F, stream);
    }
}
