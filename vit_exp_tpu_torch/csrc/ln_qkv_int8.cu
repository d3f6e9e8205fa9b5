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
// K14's kernel (proj_int8_kernel), one pass on the int8 form of
// gemm_wgmma.cuh with A resident, in tiles of 64 rows of x (bf16, M × K) ×
// all F columns, which a block's two consumer warpgroups take in turns,
// each from a ring of its own (a persistent grid walks the tiles).  Each
// warp of a consumer quantizes 16 rows of its tile (s_x = max|x| / 127,
// up to 16 rows' 16-byte loads in flight) and writes the codes once into
// shared memory in the layout a TMA box would give them (128-byte swizzle,
// a k step's 64 rows × 128 bytes after the other), then fences them into
// the async proxy.  A producer warp per consumer streams Wᵀ (F × K int8,
// the wrapper's transpose: 8-bit wgmma reads index-major operands only; it
// stays in L2) by TMA in tiles of PJ_COLS columns × 128 of depth through
// that consumer's ring.  The consumer walks F's column tiles: wgmma m64nNk32 s8
// with A from its resident codes, then (acc·s_x)·s_W without FMA, the
// twin's order, to bf16 through a swizzled staging and TMA stores.  The
// second consumer starts half a tile late, so that one's quantization runs
// beside the other's products and stores.  Bound at M = 55,296, K 256, F
// 768: 113 MB of x and out (0.034 ms), not its 22 G int8 operations.
// |acc| ≤ K·127² < 2²⁴, so out equals the twin's bits.  Any M; K % 16 ==
// 0, K ≤ 1024 (two consumers' codes, 128 KB, the rings and the staging in
// 227 KB of shared memory), F % 16 == 0 (TMA zero-fills Wᵀ past F and K,
// so codes past K multiply zeros; the scales past F read as 0, and the
// stores drop the columns past F and the rows past M).
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

// Tiles of PJ_ROWS rows × all F columns, which the two consumers take in
// turns (tile i of a block to consumer i % 2), each from a ring of its own
// that producer warp c feeds with Wᵀ's column tiles; each consumer's codes
// of its tile's rows are resident (room for K up to PJ_MAX_K); out leaves
// through a staging of PJ_ROWS × PJ_COLS a consumer
constexpr int PJ_ROWS = 64, PJ_COLS = 128, PJ_STAGES = 2, PJ_MAX_K = 1024;
using PjGemm = WgGemm<PJ_COLS, 1, false, false, s8, true>;
using PjOut = Staging<PJ_COLS / 64>;
constexpr int PJ_CODES = PJ_ROWS * PJ_MAX_K;   // a consumer's codes
using PjRing = Ring<PJ_STAGES, PjGemm::STAGE_BYTES,
                    2 * PjOut::BYTES + 2 * PJ_CODES, 2>;

// out = (x8·W)·s_x·s_W for tiles of PJ_ROWS rows, all F columns each; lane
// l of a row's warp quantizes columns 8(l + 32i) .. + 7 for i < CHUNKS
template <int CHUNKS>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
proj_int8_kernel(const bf16* __restrict__ x,
                 const __grid_constant__ CUtensorMap wt_map,
                 const __grid_constant__ CUtensorMap out_map,
                 const float* __restrict__ sc, int M, int K, int F) {
    extern __shared__ unsigned char smem_raw[];
    PjRing(smem_raw).init();
    const int tiles = (M + PJ_ROWS - 1) / PJ_ROWS;
    const int col_tiles = (F + PJ_COLS - 1) / PJ_COLS;
    // the block's tiles t_i = blockIdx.x + i · gridDim.x, i < n
    const int n = (tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x < WG_THREADS) {   // the producer: Wᵀ's tiles only
        producer_regs();
        if (warp < 2 && lane == 0) {   // warp c feeds consumer c's ring
            PjRing ring(smem_raw, warp);
            const CUtensorMap* const b[1] = {&wt_map};
            for (int i = warp; i < n; i += 2)
                for (int ct = 0; ct < col_tiles; ++ct) {
                    const int b_n0[1] = {ct * PJ_COLS};
                    produce<PjGemm>(ring, nullptr, 0, b, b_n0, 0, K);
                }
        }
        return;
    }
    consumer_regs();
    // rows a warp loads at once: RB·CHUNKS 16-byte loads in flight a lane
    constexpr int RB = CHUNKS == 1 ? 16 : CHUNKS == 2 ? 8 : 4;
    const int cw = threadIdx.x / WG_THREADS - 1, w = warp & 3;
    PjRing ring(smem_raw, cw);
    const PjOut out(ring.extra());
    // the consumer's codes: k step s at codes + s · PJ_ROWS · 128
    const uint32_t codes = ring.extra() + 2 * PjOut::BYTES + cw * PJ_CODES;
    unsigned char* const codes_p = smem_raw + (codes - smem_u32(smem_raw));
    const CUtensorMap* maps[PJ_COLS / 64];
#pragma unroll
    for (int c = 0; c < PJ_COLS / 64; ++c) maps[c] = &out_map;
    // consumer 1 starts its first tile's rows when consumer 0 has its
    // codes (named barrier 3), so that the two run half a tile apart
    if (cw == 1 && cw < n)
        asm volatile("bar.sync 3, %0;\n" ::"n"(2 * WG_THREADS) : "memory");
    for (int i = cw; i < n; i += 2) {
        const int m0 = (blockIdx.x + i * gridDim.x) * PJ_ROWS;
        // warp w quantizes rows 16w .. 16w + 15 of the tile, the rows its
        // lanes hold in the accumulator layout: lane l keeps the scales of
        // rows 16w + l / 4 and + 8.  The codes may be rewritten: consume
        // waited for the previous tile's wgmmas.
        float rs[2];
#pragma unroll
        for (int r0 = 0; r0 < 16; r0 += RB) {
            uint4 raw[RB][CHUNKS];
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                const int gr = m0 + 16 * w + r0 + b;
                const bf16* xr = x + (size_t)min(gr, M - 1) * K;
#pragma unroll
                for (int c8 = 0; c8 < CHUNKS; ++c8) {
                    const int c = 8 * lane + ROW_CHUNK * c8;
                    raw[b][c8] = make_uint4(0, 0, 0, 0);
                    if (gr < M && c < K)   // K % 16 == 0
                        raw[b][c8] = *reinterpret_cast<const uint4*>(xr + c);
                }
            }
            float amax[RB], sr[RB];
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                amax[b] = 0.f;
#pragma unroll
                for (int c8 = 0; c8 < CHUNKS; ++c8) {
                    const bf16* xs = reinterpret_cast<const bf16*>(&raw[b][c8]);
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        amax[b] = fmaxf(amax[b], fabsf(__bfloat162float(xs[j])));
                }
            }
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                sr[b] = quant_scale(warp_max(amax[b]));
                const int rr = r0 + b;   // the row within the warp's 16
                if (lane >> 2 == (rr & 7)) rs[rr >> 3] = sr[b];
            }
            // row r's k step c / 128 at codes_p + (c / 128)·PJ_ROWS·128,
            // its 16-byte unit swizzled (the layout of a TMA box)
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                const int r = 16 * w + r0 + b;
#pragma unroll
                for (int c8 = 0; c8 < CHUNKS; ++c8) {
                    const int c = 8 * lane + ROW_CHUNK * c8;
                    if (c >= K) continue;
                    const bf16* xs = reinterpret_cast<const bf16*>(&raw[b][c8]);
                    float y[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j) y[j] = __bfloat162float(xs[j]);
                    *reinterpret_cast<uint2*>(
                        codes_p + (c >> 7) * (PJ_ROWS * STEP_BYTES) +
                        r * 128 + ((((c & 127) >> 4) ^ (r & 7)) << 4) +
                        (c & 15)) = quant8x8(y, sr[b]);
                }
            }
        }
        // the codes, written by st.shared, reach the async proxy that
        // wgmma reads through
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync();
        if (cw == 0 && i == 0 && n > 1)
            asm volatile("bar.arrive 3, %0;\n" ::"n"(2 * WG_THREADS)
                         : "memory");
        for (int ct = 0; ct < col_tiles; ++ct) {
            const int n0 = ct * PJ_COLS;
            int acc[PjGemm::N / 8][4];
#pragma unroll
            for (int j = 0; j < PjGemm::N / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0;
            consume<PjGemm>(ring, acc, 0, K, codes, PJ_ROWS * STEP_BYTES);
            // the outputs first, packed, then the staging (the stores drop
            // what lies past M and F)
            uint32_t y[PJ_COLS / 8][2];
#pragma unroll
            for (int j = 0; j < PJ_COLS / 8; ++j) {
                const int col = n0 + wg_col(j, 0);
                float2 s = make_float2(0.f, 0.f);
                if (col < F)   // F % 16 == 0
                    s = *reinterpret_cast<const float2*>(sc + col);
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    y[j][half] = pack_bf16(
                        __fmul_rn(__fmul_rn((float)acc[j][2 * half], rs[half]),
                                  s.x),
                        __fmul_rn(
                            __fmul_rn((float)acc[j][2 * half + 1], rs[half]),
                            s.y));
            }
            out.acquire();
#pragma unroll
            for (int j = 0; j < PJ_COLS / 8; ++j) {
                const int col = wg_col(j, 0);
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    out.put(col >> 6, wg_row(2 * half), col & 63, y[j][half]);
            }
            int cols[PJ_COLS / 64];
#pragma unroll
            for (int c = 0; c < PJ_COLS / 64; ++c) cols[c] = n0 + 64 * c;
            out.release(maps, cols, m0);
        }
    }
    out.drain();
}

template <int CHUNKS>
int launch_proj(const void* x, const void* wt, const void* sc, void* out,
                int M, int K, int F, void* stream) {
    // Wᵀ (F × K) index-major; out (M × F) in boxes of 64 × 64
    CUtensorMap wt_map, out_map;
    if (!tma_map<s8>(&wt_map, wt, F, K, K, PJ_COLS) ||
        !tma_map(&out_map, out, M, F, F, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(proj_int8_kernel<CHUNKS>, PjRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    proj_int8_kernel<CHUNKS>
        <<<persistent_blocks((M + PJ_ROWS - 1) / PJ_ROWS), GEMM_THREADS,
           PjRing::SMEM_BYTES, (cudaStream_t)stream>>>(
            (const bf16*)x, wt_map, out_map, (const float*)sc, M, K, F);
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
