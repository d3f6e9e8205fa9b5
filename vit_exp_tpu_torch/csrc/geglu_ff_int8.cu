// K11: W8A8 GEGLU feed-forward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_int8_kernel.
//
// y = (x − μ)·inv·γ + β in fp32, quantized per token (y8, s_y);
// h = (y8·W1 as int32 → fp32)·s_y·s_W1 with W1 = [val | gate] int8 per
// column; act = gelu_erf(gate)·val in fp32, quantized per token over its
// whole I-wide row (a8, s_a); out = bf16((a8·W2 as int32 → fp32)·s_a·s_W2).
// Quantizers round half to even and divide by the scale (common.cuh).
//
// What bounds it: 522 G int8 operations at 55,296 tokens, D 768, 2I 4096
// (0.264 ms at the int8 tensor-core peak).  The TPU kernel keeps a
// 256-token block's act in VMEM; s_a needs the amax over all I columns of
// a token before the second product may start, and a 128-token act tile in
// fp32 (1 MB at I 2048) fits no SM.  So act goes through device memory in
// fp32 (no rounding point moves), and K11 is four kernels, each a stage with
// its plain twin in ops/geglu_ff.py.  The two products run on the int8 form
// of gemm_wgmma.cuh's Hopper mainloop: a producer warp's TMA loads into an
// mbarrier ring, two consumer warpgroups on wgmma m64nNk32 s8 with int32
// accumulators in registers, 128-deep k steps, a persistent grid of one
// block per SM.  8-bit wgmma reads index-major operands only, so the
// wrapper passes W1ᵀ (2I × D) and W2ᵀ (D × I).
//   geglu_int8_y_kernel: y → y8 (M × D) and s_y (M); a row pass, one warp
//     per token, bytes bound.
//   geglu_int8_h_kernel: per tile of 128 tokens × H_COLS inner columns c,
//     one wgmma of N 2·H_COLS reads y8 against the val rows W1ᵀ[c] and the
//     gate rows W1ᵀ[I + c] (two B tiles side by side, from two tensor maps:
//     each map ends at I rows, so TMA zero-fills a val box that runs past I
//     instead of reading gate rows), so val and gate of one (token, column)
//     sit in one lane.  The epilogue converts, scales by s_y then s_W1,
//     takes the GELU and the product, and writes act in fp32 (M × I)
//     through a swizzled staging and TMA stores; each token's amax over
//     each 64 columns (AMAX_TILE) lies in one quad of lanes (two shuffles):
//     one partial per 64-column tile, (M, ⌈I / 64⌉).  A max is order-free:
//     no atomics, the same bits from run to run.
//   geglu_int8_q_kernel: a row pass, one warp per token: s_a from the
//     token's partials, then a8 (M × I) from act, read once.
//   geglu_int8_o_kernel: out = a8·W2 with the epilogue ·s_a·s_W2 → bf16,
//     128 × O_COLS tiles, through a swizzled staging and TMA stores.
// The epilogues do the twins' fp32 operations in the twins' order without
// fused multiply-adds, so the products' bits are those of the mma.sync
// design they replace.  act's epilogue (an erff and seven fp32 operations
// on each of M·I values) is bound by instruction issue and costs about as
// much as its products; consumers that run it beside another tile's
// wgmmas (ping-pong, or slices between the next tile's k steps) measured
// slower than both consumers sharing each tile (PERF.md).  act costs 453 MB written and read, a8 113 MB (≈ 0.2
// ms at 3.35 TB/s together).  Any M; D and 2I multiples of 16, I a multiple
// of 16 (the wrapper zero-pads it: zero val and gate columns give act 0,
// which moves neither the amax nor the product); every row pitch is then
// whole 16-byte units, as TMA needs (|y8·W1| ≤ D·127² stays below 2²⁴ up to
// D 1,040, so the conversion is exact there).
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

using s8 = signed char;

// act: 128 tokens × H_COLS inner columns a tile, B = [val | gate] rows of
// W1ᵀ; act leaves through a staging of 64 × H_PART fp32 a consumer at a
// time
constexpr int AMAX_TILE = 64;   // inner columns of one partial amax
constexpr int H_COLS = 128, H_STAGES = 3, H_PART = 128;
using HGemm = WgGemm<H_COLS, 2, false, false, s8>;
using HOut = Staging<H_PART / 32>;
using HRing = Ring<H_STAGES, HGemm::STAGE_BYTES, 2 * HOut::BYTES>;
static_assert(H_COLS % AMAX_TILE == 0 && H_COLS % H_PART == 0,
              "whole partials and parts a tile");
// out: 128 tokens × 256 output columns, leaving in two halves of 64 × 128
// a consumer
constexpr int O_COLS = 256, O_STAGES = 4, O_PART = 128;
using OGemm = WgGemm<O_COLS, 1, false, false, s8>;
using OOut = Staging<O_PART / 64>;
using ORing = Ring<O_STAGES, OGemm::STAGE_BYTES, 2 * OOut::BYTES>;
constexpr int ROW_WARPS = 8;   // tokens per block of the row passes

// 8 fp32 values from p (32-byte aligned) in two 16-byte loads
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(p + 4);
}

// y = x̂·γ + β for the 8 columns c.. of row xr (no fused multiply-add:
// the twin rounds each product and sum)
__device__ __forceinline__ void y_chunk(float (&y)[8], const bf16* xr,
                                        int c, float m, float iv,
                                        const float* gamma,
                                        const float* beta) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    float g[8], b[8];
    load8(g, gamma + c);
    load8(b, beta + c);
#pragma unroll
    for (int i = 0; i < 8; ++i)
        y[i] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(xs[i]), m), iv),
                      g[i]),
            b[i]);
}

// y8 and s_y; one warp per token, lane l takes columns 8(l + 32i) ..
__global__ void __launch_bounds__(ROW_WARPS * 32)
geglu_int8_y_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ inv,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, s8* __restrict__ y8,
                    float* __restrict__ sy, int M, int D) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (r >= M) return;
    const bf16* xr = x + (size_t)r * D;
    const float m = mu[r], iv = inv[r];
    float y[8], amax = 0.f;
    for (int c = 8 * lane; c < D; c += 256) {
        y_chunk(y, xr, c, m, iv, gamma, beta);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(y[i]));
    }
    const float s = quant_scale(warp_max(amax));
    if (lane == 0) sy[r] = s;
    for (int c = 8 * lane; c < D; c += 256) {   // the row again, from L1
        y_chunk(y, xr, c, m, iv, gamma, beta);
        *reinterpret_cast<uint2*>(y8 + (size_t)r * D + c) = quant8x8(y, s);
    }
}

// act and its partial amaxes for tiles of 128 tokens × H_COLS inner
// columns, column tile fastest (y8 comes from device memory once, W1ᵀ stays
// in L2)
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_int8_h_kernel(const __grid_constant__ CUtensorMap y8_map,
                    const __grid_constant__ CUtensorMap val_map,
                    const __grid_constant__ CUtensorMap gate_map,
                    const __grid_constant__ CUtensorMap act_map,
                    const float* __restrict__ sy, const float* __restrict__ s1,
                    float* __restrict__ amax_part, int M, int D, int inner) {
    extern __shared__ unsigned char smem_raw[];
    HRing ring(smem_raw);
    ring.init();
    const int col_tiles = (inner + H_COLS - 1) / H_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[2] = {&val_map, &gate_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int n0 = t % col_tiles * H_COLS;
                const int b_n0[2] = {n0, n0};
                produce<HGemm>(ring, &y8_map, t / col_tiles * TILE_M, b, b_n0,
                               0, D);
            }
        }
        return;
    }
    consumer_regs();
    constexpr int G0 = H_COLS / 8;   // the first n8 tile of the gate columns
    constexpr int PT = AMAX_TILE / 8;   // n8 tiles of one partial amax
    const int parts = (inner + AMAX_TILE - 1) / AMAX_TILE;
    const HOut out(ring.extra());
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * H_COLS;
        // s_y of the lane's two rows, loaded while the products run (a row
        // past M is not stored)
        float rs[2];
#pragma unroll
        for (int half = 0; half < 2; ++half)
            rs[half] = sy[min(m0 + wg_row(2 * half), M - 1)];
        int h[HGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < HGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) h[j][e] = 0;
        consume<HGemm>(ring, h, 0, D);

        // the GEGLU on the accumulators, in the twin's order without fused
        // multiply-adds: val and gate of a column are lane-local; columns
        // past I have zero sums and read zero scales, so their act is 0
        float act[G0][4], amax[2][H_COLS / AMAX_TILE];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int p = 0; p < H_COLS / AMAX_TILE; ++p) amax[half][p] = 0.f;
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
                amax[e >> 1][j / PT] =
                    fmaxf(amax[e >> 1][j / PT], fabsf(act[j][e]));
            }
        }
        // a row's 64 columns of a partial lie in the quad of lanes that
        // holds the row
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int p = 0; p < H_COLS / AMAX_TILE; ++p) {
                float v = amax[half][p];
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
                const int row = m0 + wg_row(2 * half);
                const int c0 = n0 + p * AMAX_TILE;
                if ((threadIdx.x & 3) == 0 && row < M && c0 < inner)
                    amax_part[(size_t)row * parts + c0 / AMAX_TILE] = v;
            }
        // act in parts of H_PART columns through the staging (the stores
        // drop what lies past M and I)
#pragma unroll
        for (int part = 0; part < H_COLS / H_PART; ++part) {
            out.acquire();
#pragma unroll
            for (int j = 0; j < H_PART / 8; ++j) {
                const int jj = part * H_PART / 8 + j, col = wg_col(j, 0);
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    out.put(col >> 5, wg_row(2 * half), col & 31,
                            make_float2(act[jj][2 * half],
                                        act[jj][2 * half + 1]));
            }
            const CUtensorMap* maps[H_PART / 32];
            int cols[H_PART / 32];
#pragma unroll
            for (int c = 0; c < H_PART / 32; ++c) {
                maps[c] = &act_map;
                cols[c] = n0 + part * H_PART + 32 * c;
            }
            out.release(maps, cols, m0);
        }
    }
    out.drain();
}

// a8 and s_a; one warp per token, lane l takes columns 8(l + 32i) ..
__global__ void __launch_bounds__(ROW_WARPS * 32)
geglu_int8_q_kernel(const float* __restrict__ act,
                    const float* __restrict__ amax_part, s8* __restrict__ a8,
                    float* __restrict__ sa, int M, int inner, int tiles) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (r >= M) return;
    float amax = 0.f;
    for (int t = lane; t < tiles; t += 32)
        amax = fmaxf(amax, amax_part[(size_t)r * tiles + t]);
    const float s = quant_scale(warp_max(amax));
    if (lane == 0) sa[r] = s;
    const float* ar = act + (size_t)r * inner;
#pragma unroll 4
    for (int c = 8 * lane; c < inner; c += 256) {
        float v[8];
        load8(v, ar + c);
        *reinterpret_cast<uint2*>(a8 + (size_t)r * inner + c) = quant8x8(v, s);
    }
}

// out = bf16((a8·W2)·s_a·s_W2) for tiles of 128 tokens × O_COLS columns,
// column tile fastest
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_int8_o_kernel(const __grid_constant__ CUtensorMap a8_map,
                    const __grid_constant__ CUtensorMap w2t_map,
                    const __grid_constant__ CUtensorMap out_map,
                    const float* __restrict__ sa, const float* __restrict__ s2,
                    int M, int D, int inner) {
    extern __shared__ unsigned char smem_raw[];
    ORing ring(smem_raw);
    ring.init();
    const int col_tiles = (D + O_COLS - 1) / O_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[1] = {&w2t_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int b_n0[1] = {t % col_tiles * O_COLS};
                produce<OGemm>(ring, &a8_map, t / col_tiles * TILE_M, b, b_n0,
                               0, inner);
            }
        }
        return;
    }
    consumer_regs();
    const OOut out(ring.extra());
    const CUtensorMap* outs[O_PART / 64];
#pragma unroll
    for (int c = 0; c < O_PART / 64; ++c) outs[c] = &out_map;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * O_COLS;
        float rs[2];   // s_a of the lane's two rows
#pragma unroll
        for (int half = 0; half < 2; ++half)
            rs[half] = sa[min(m0 + wg_row(2 * half), M - 1)];
        int acc[OGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < OGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0;
        consume<OGemm>(ring, acc, 0, inner);
        // parts of O_PART columns: the part's outputs first, packed, so that
        // the loads of the column scales are not held behind the staging's
        // stores (the stores drop what lies past M and D)
#pragma unroll
        for (int part = 0; part < O_COLS / O_PART; ++part) {
            uint32_t y[O_PART / 8][2];
#pragma unroll
            for (int j = 0; j < O_PART / 8; ++j) {
                const int jj = part * O_PART / 8 + j;
                const int col = n0 + part * O_PART + wg_col(j, 0);
                float2 s = make_float2(0.f, 0.f);
                if (col < D)   // D % 16 == 0
                    s = *reinterpret_cast<const float2*>(s2 + col);
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    y[j][half] = pack_bf16(
                        __fmul_rn(__fmul_rn((float)acc[jj][2 * half],
                                            rs[half]), s.x),
                        __fmul_rn(__fmul_rn((float)acc[jj][2 * half + 1],
                                            rs[half]), s.y));
            }
            out.acquire();
#pragma unroll
            for (int j = 0; j < O_PART / 8; ++j) {
                const int col = wg_col(j, 0);
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    out.put(col >> 6, wg_row(2 * half), col & 63, y[j][half]);
            }
            int cols[O_PART / 64];
#pragma unroll
            for (int c = 0; c < O_PART / 64; ++c)
                cols[c] = n0 + part * O_PART + 64 * c;
            out.release(outs, cols, m0);
        }
    }
    out.drain();
}

bool shapes_ok(int M, int D, int I2) {
    return M >= 1 && D >= 16 && D % 16 == 0 && I2 >= 32 && I2 % 32 == 0;
}

unsigned row_blocks(int M) {
    return (unsigned)((M + ROW_WARPS - 1) / ROW_WARPS);
}

}  // namespace

VIT_API int vit_geglu_int8_y(const void* x, const void* mu, const void* inv,
                             const void* gamma, const void* beta, void* y8,
                             void* sy, int M, int D, void* stream) {
    if (!shapes_ok(M, D, 32)) return (int)cudaErrorInvalidValue;
    geglu_int8_y_kernel<<<row_blocks(M), ROW_WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)beta, (s8*)y8, (float*)sy, M, D);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_int8_h(const void* y8, const void* sy, const void* w1t,
                             const void* s1, void* act, void* amax_part, int M,
                             int D, int I2, void* stream) {
    if (!shapes_ok(M, D, I2)) return (int)cudaErrorInvalidValue;
    const int inner = I2 / 2;
    // y8 (M × D) and W1ᵀ's val and gate rows (I × D each) index-major; act
    // (M × I fp32) in boxes of 64 rows × 32 columns
    CUtensorMap y8_map, val_map, gate_map, act_map;
    if (!tma_map<s8>(&y8_map, y8, M, D, D, TILE_M) ||
        !tma_map<s8>(&val_map, w1t, inner, D, D, H_COLS) ||
        !tma_map<s8>(&gate_map, (const s8*)w1t + (size_t)inner * D, inner, D,
                     D, H_COLS) ||
        !tma_map<float>(&act_map, act, M, inner, inner, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_int8_h_kernel, HRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((inner + H_COLS - 1) / H_COLS);
    geglu_int8_h_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                          HRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        y8_map, val_map, gate_map, act_map, (const float*)sy,
        (const float*)s1, (float*)amax_part, M, D, inner);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_int8_q(const void* act, const void* amax_part, void* a8,
                             void* sa, int M, int I2, void* stream) {
    if (!shapes_ok(M, 16, I2)) return (int)cudaErrorInvalidValue;
    const int inner = I2 / 2;
    geglu_int8_q_kernel<<<row_blocks(M), ROW_WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
        (const float*)act, (const float*)amax_part, (s8*)a8, (float*)sa, M,
        inner, (inner + AMAX_TILE - 1) / AMAX_TILE);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_int8_o(const void* a8, const void* sa, const void* w2t,
                             const void* s2, void* out, int M, int D, int I2,
                             void* stream) {
    if (!shapes_ok(M, D, I2)) return (int)cudaErrorInvalidValue;
    const int inner = I2 / 2;
    // a8 (M × I) and W2ᵀ (D × I) index-major; out in boxes of 64 × 64
    CUtensorMap a8_map, w2t_map, out_map;
    if (!tma_map<s8>(&a8_map, a8, M, inner, inner, TILE_M) ||
        !tma_map<s8>(&w2t_map, w2t, D, inner, inner, O_COLS) ||
        !tma_map(&out_map, out, M, D, D, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_int8_o_kernel, ORing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((D + O_COLS - 1) / O_COLS);
    geglu_int8_o_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                          ORing::SMEM_BYTES, (cudaStream_t)stream>>>(
        a8_map, w2t_map, out_map, (const float*)sa, (const float*)s2, M, D,
        inner);
    return (int)cudaGetLastError();
}
