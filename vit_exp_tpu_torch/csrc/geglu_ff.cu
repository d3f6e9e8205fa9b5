// K2: GEGLU feed-forward forward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_kernel.
//
// x̂ = bf16((x − μ)·inv); h = bf16(x̂·W1' + d1) with W1' = γ⊙W1 laid out
// [val | gate]; act = bf16(bf16(gelu_erf(gate))·val); out = bf16(act·W2).
//
// The TPU kernel keeps a 256-token block's (tokens, 2·inner) h and both
// weights (9.4 MB at D 768, 2I 4096) in VMEM and accumulates act·W2 there.
// On Hopper a 128-token output tile in fp32 (384 KB) fits neither the
// register file of an SM nor its 227 KB of shared memory, and a block that
// owns fewer tokens streams every weight tile from L2 for a handful of
// tokens.  So K2 is three kernels, each a stage with its plain twin in
// ops/geglu_ff.py; the two products run on the wgmma mainloop of
// gemm_wgmma.cuh (TMA loads by a producer warp into an mbarrier ring, two
// consumer warpgroups on wgmma, fp32 accumulators in registers, a
// persistent grid of one block per SM):
//   geglu_ff_x_kernel: x̂ in bf16 (M × D), a row pass, bytes bound.
//   geglu_ff_h_kernel: per tile of 128 tokens × 128 inner columns c, one
//     wgmma of N 256 reads x̂ (index-major) against the val columns
//     W1'[:, c] and the gate columns W1'[:, I + c] (two k-major B tiles
//     side by side, from two tensor maps), so val and gate of one (token,
//     column) sit in one lane and the GEGLU runs on the accumulators
//     (started at d1): both rounded to bf16, gelu_erf of gate rounded,
//     times val, rounded.  It writes act in bf16 (M × I); h (453 MB at
//     55,296 tokens) never leaves the chip.  The tiles run column tile
//     fastest, so x̂ comes from device memory once and W1' stays in L2.
//   geglu_ff_o_kernel: out = act·W2 (K = I, N = D; W2 is (I, D): a k-major
//     B) in 128 × 256 tiles, rounded to bf16.
//   Both write through a swizzled staging tile and TMA stores, so the
//   consumers start the next tile while the copies run.
// What bounds it: 522 GFLOP at 55,296 tokens, D 768, 2I 4096 (0.528 ms at
// the bf16 tensor-core peak); act costs 226 MB written and read again
// (≈ 0.135 ms at 3.35 TB/s), the price of a design that fits the card.
// Both products hold 128 accumulators a consumer thread.  No atomics: two
// launches on the same inputs give the same bits.  Any M; D and 2I
// multiples of 16 (rows of 16-byte pieces for TMA, whose loads are
// zero-filled past the matrices' ends and whose stores are clipped there).
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

// act: 128 tokens × 128 inner columns; B = [val | gate] columns of W1';
// act leaves through a staging of 64 × 128 a consumer
constexpr int H_COLS = 128, H_STAGES = 4;
using HGemm = WgGemm<H_COLS, 2, false, true>;
using HOut = Staging<H_COLS / 64>;
using HRing = Ring<H_STAGES, HGemm::STAGE_BYTES, 2 * HOut::BYTES>;
// out: 128 tokens × 256 output columns, leaving in two halves of 64 × 128
// a consumer
constexpr int O_COLS = 256, O_STAGES = 4;
using OGemm = WgGemm<O_COLS, 1, false, true>;
using OOut = Staging<2>;
using ORing = Ring<O_STAGES, OGemm::STAGE_BYTES, 2 * OOut::BYTES>;

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// gelu_erf(g) = g·Φ(g), as the twin computes it
__device__ __forceinline__ float gelu_erf(float g) {
    return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// x̂ = bf16((x − μ)·inv), 8 elements per thread
__global__ void __launch_bounds__(256)
geglu_ff_x_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                  const float* __restrict__ inv, bf16* __restrict__ xn, int M,
                  int D) {
    const int per_row = D / 8;
    const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
    if (e >= (long long)M * per_row) return;
    const int r = (int)(e / per_row), c = (int)(e % per_row) * 8;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + (size_t)r * D + c);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    const float m = mu[r], iv = inv[r];
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        o[i] = pack_bf16((__bfloat162float(xs[2 * i]) - m) * iv,
                         (__bfloat162float(xs[2 * i + 1]) - m) * iv);
    *reinterpret_cast<uint4*>(xn + (size_t)r * D + c) = out;
}

// act for tiles of 128 tokens × 128 inner columns, column tile fastest
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_ff_h_kernel(const __grid_constant__ CUtensorMap xn_map,
                  const __grid_constant__ CUtensorMap val_map,
                  const __grid_constant__ CUtensorMap gate_map,
                  const __grid_constant__ CUtensorMap act_map,
                  const float* __restrict__ d1, int M, int D, int inner) {
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
                produce<HGemm>(ring, &xn_map, t / col_tiles * TILE_M, b, b_n0,
                               0, D);
            }
        }
        return;
    }
    consumer_regs();
    constexpr int G0 = H_COLS / 8;   // the first n8 tile of the gate columns
    const HOut out(ring.extra());
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * H_COLS;
        // h starts at d1 (val column c at d1[c], gate at d1[I + c]), so the
        // epilogue holds no d1 operands
        float h[HGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < G0; ++j) {
            const int col = n0 + wg_col(j, 0);
            float2 dv = make_float2(0.f, 0.f), dg = dv;
            if (col < inner) {   // inner % 8 == 0
                dv = *reinterpret_cast<const float2*>(d1 + col);
                dg = *reinterpret_cast<const float2*>(d1 + inner + col);
            }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                h[j][2 * half] = dv.x;
                h[j][2 * half + 1] = dv.y;
                h[G0 + j][2 * half] = dg.x;
                h[G0 + j][2 * half + 1] = dg.y;
            }
        }
        consume<HGemm>(ring, h, 0, D);

        // the GEGLU: val and gate rounded to bf16 (h's rounding point),
        // lane-local (row, column); rows and columns past M and I are
        // dropped by the stores
        out.acquire();
#pragma unroll
        for (int j = 0; j < G0; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int col = wg_col(j, 0);
                const float2 val = bf16x2_to_float2(
                    pack_bf16(h[j][2 * half], h[j][2 * half + 1]));
                const float2 g = bf16x2_to_float2(
                    pack_bf16(h[G0 + j][2 * half], h[G0 + j][2 * half + 1]));
                out.put(col >> 6, wg_row(2 * half), col & 63,
                        pack_bf16(bf16_round(gelu_erf(g.x)) * val.x,
                                  bf16_round(gelu_erf(g.y)) * val.y));
            }
        const CUtensorMap* maps[H_COLS / 64];
        int cols[H_COLS / 64];
#pragma unroll
        for (int c = 0; c < H_COLS / 64; ++c) {
            maps[c] = &act_map;
            cols[c] = n0 + 64 * c;
        }
        out.release(maps, cols, m0);
    }
    out.drain();
}

// out = act · W2 in bf16 for tiles of 128 tokens × 256 columns
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_ff_o_kernel(const __grid_constant__ CUtensorMap act_map,
                  const __grid_constant__ CUtensorMap w2_map,
                  const __grid_constant__ CUtensorMap out_map, int M, int D,
                  int inner) {
    extern __shared__ unsigned char smem_raw[];
    ORing ring(smem_raw);
    ring.init();
    const int col_tiles = (D + O_COLS - 1) / O_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[1] = {&w2_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int b_n0[1] = {t % col_tiles * O_COLS};
                produce<OGemm>(ring, &act_map, t / col_tiles * TILE_M, b,
                               b_n0, 0, inner);
            }
        }
        return;
    }
    consumer_regs();
    const OOut out(ring.extra());
    const CUtensorMap* const maps[2] = {&out_map, &out_map};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * O_COLS;
        float acc[OGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < OGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        consume<OGemm>(ring, acc, 0, inner);
        // two halves of 128 columns (the stores drop what lies past M, D)
#pragma unroll
        for (int part = 0; part < 2; ++part) {
            out.acquire();
#pragma unroll
            for (int j = 0; j < OGemm::N / 16; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int jj = part * OGemm::N / 16 + j;
                    const int col = wg_col(j, 0);
                    out.put(col >> 6, wg_row(2 * half), col & 63,
                            pack_bf16(acc[jj][2 * half],
                                      acc[jj][2 * half + 1]));
                }
            const int cols[2] = {n0 + part * 128, n0 + part * 128 + 64};
            out.release(maps, cols, m0);
        }
    }
    out.drain();
}

bool shapes_ok(int M, int D, int I2) {
    return M >= 1 && D >= 16 && D % 16 == 0 && I2 >= 16 && I2 % 16 == 0;
}

}  // namespace

VIT_API int vit_geglu_ff_x(const void* x, const void* mu, const void* inv,
                           void* xn, int M, int D, void* stream) {
    if (!shapes_ok(M, D, 64)) return (int)cudaErrorInvalidValue;
    const long long chunks = (long long)M * (D / 8);
    geglu_ff_x_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv, (bf16*)xn, M, D);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_ff_h(const void* xn, const void* w1, const void* d1,
                           void* act, int M, int D, int I2, void* stream) {
    if (!shapes_ok(M, D, I2)) return (int)cudaErrorInvalidValue;
    const int inner = I2 / 2;
    // x̂ index-major; the val and gate columns of W1' (D, 2I) k-major;
    // act in boxes of 64 × 64
    CUtensorMap xn_map, val_map, gate_map, act_map;
    if (!tma_map(&xn_map, xn, M, D, D, TILE_M) ||
        !tma_map(&val_map, w1, D, inner, I2, 64) ||
        !tma_map(&gate_map, (const bf16*)w1 + inner, D, inner, I2, 64) ||
        !tma_map(&act_map, act, M, inner, inner, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_ff_h_kernel, HRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((inner + H_COLS - 1) / H_COLS);
    geglu_ff_h_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                        HRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        xn_map, val_map, gate_map, act_map, (const float*)d1, M, D, inner);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_ff_o(const void* act, const void* w2, void* out, int M,
                           int D, int I2, void* stream) {
    if (!shapes_ok(M, D, I2)) return (int)cudaErrorInvalidValue;
    const int inner = I2 / 2;
    // act index-major; W2 (I, D) k-major; out in boxes of 64 × 64
    CUtensorMap act_map, w2_map, out_map;
    if (!tma_map(&act_map, act, M, inner, inner, TILE_M) ||
        !tma_map(&w2_map, w2, inner, D, D, 64) ||
        !tma_map(&out_map, out, M, D, D, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_ff_o_kernel, ORing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((D + O_COLS - 1) / O_COLS);
    geglu_ff_o_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                        ORing::SMEM_BYTES, (cudaStream_t)stream>>>(
        act_map, w2_map, out_map, M, D, inner);
    return (int)cudaGetLastError();
}
