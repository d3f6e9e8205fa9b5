// K3: fused LayerNorm + q/kv projection.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_fwd_kernel.
//
// t = x @ W with W = [γ⊙Wq | Wkv] (K × F, row-major bf16); the first Fq
// columns become inv·(t − μ·c) (the LayerNorm applied after the product),
// the rest stay t (projections of the pre-LN x).  One kernel on the Hopper
// mainloop of gemm_wgmma.cuh: a producer warp's TMA loads into an mbarrier
// ring, two consumer warpgroups on wgmma m64n256k16 with fp32 accumulators
// in registers, a persistent grid of one block per SM.  A = x index-major
// (M × K), B = W k-major (read through the transpose bit), 128 tokens ×
// 256 columns a tile, column tile fastest (x comes from device memory once,
// W stays in L2).  The epilogue works on the accumulators: μ and inv once
// per lane row, c once per column, the correction on each q column
// (decided per column: Fq may fall inside a column tile), then the bf16
// tile leaves through a swizzled staging in shared memory by TMA stores
// (K2's out stage), so the consumers go on to the next tile while the
// copies run.  The normalised x never reaches device memory.
//
// What bounds it: 65.2 GFLOP at 55,296 tokens, K = F = 768 (0.066 ms at
// the bf16 tensor-core peak; x in and out are 170 MB, 0.051 ms).  K is only
// 12 k steps a tile, so the epilogue of one tile overlaps the loads of the
// next but not the products.  Any M; K % 16 == 0 and F % 16 == 0 (TMA's
// 16-byte pitches; its loads zero-fill past M, K and F, its stores clip).
// No atomics: two launches on the same inputs give the same bits.
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

// 128 tokens × 256 columns; out leaves through a staging of PART columns
// a consumer at a time
constexpr int COLS = 256, STAGES = 4, PART = 128;
using QGemm = WgGemm<COLS, 1, false, true>;
using QOut = Staging<PART / 64>;
using QRing = Ring<STAGES, QGemm::STAGE_BYTES, 2 * QOut::BYTES>;

// out = [inv·(t − μ·c) | t] in bf16 for tiles of 128 tokens × 256 columns
__global__ void __launch_bounds__(GEMM_THREADS, 1)
ln_qkv_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap out_map,
              const float* __restrict__ mu, const float* __restrict__ inv,
              const float* __restrict__ c, int M, int K, int F, int Fq) {
    extern __shared__ unsigned char smem_raw[];
    QRing ring(smem_raw);
    ring.init();
    const int col_tiles = (F + COLS - 1) / COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[1] = {&w_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int b_n0[1] = {t % col_tiles * COLS};
                produce<QGemm>(ring, &x_map, t / col_tiles * TILE_M, b, b_n0,
                               0, K);
            }
        }
        return;
    }
    consumer_regs();
    const QOut out(ring.extra());
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * COLS;
        // μ and inv of the lane's two rows, loaded while the products run
        // (a row past M is not stored)
        float rm[2], ri[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = min(m0 + wg_row(2 * half), M - 1);
            rm[half] = mu[row];
            ri[half] = inv[row];
        }
        float acc[QGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < QGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        consume<QGemm>(ring, acc, 0, K);
        // parts of PART columns (the stores drop what lies past M, F)
#pragma unroll
        for (int part = 0; part < QGemm::N / PART; ++part) {
            // the part's outputs first, packed, so that the loads of c are
            // not held behind the staging's stores and the wait for the
            // staging overlaps the math
            uint32_t y[PART / 8][2];
#pragma unroll
            for (int j = 0; j < PART / 8; ++j) {
                const int jj = part * PART / 8 + j;
                const int col = n0 + part * PART + wg_col(j, 0);
                // c of the pair's q columns (0 on kv columns and past F)
                const float c0 = col < Fq ? c[col] : 0.f;
                const float c1 = col + 1 < Fq ? c[col + 1] : 0.f;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    float t0 = acc[jj][2 * half], t1 = acc[jj][2 * half + 1];
                    const float m = rm[half], iv = ri[half];
                    if (col < Fq)   // no fused multiply-add, as the twin
                        t0 = __fmul_rn(iv, __fsub_rn(t0, __fmul_rn(m, c0)));
                    if (col + 1 < Fq)
                        t1 = __fmul_rn(iv, __fsub_rn(t1, __fmul_rn(m, c1)));
                    y[j][half] = pack_bf16(t0, t1);
                }
            }
            out.acquire();
#pragma unroll
            for (int j = 0; j < PART / 8; ++j) {
                const int cl = wg_col(j, 0);   // within the part
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    out.put(cl >> 6, wg_row(2 * half), cl & 63, y[j][half]);
            }
            const CUtensorMap* maps[PART / 64];
            int cols[PART / 64];
#pragma unroll
            for (int ch = 0; ch < PART / 64; ++ch) {
                maps[ch] = &out_map;
                cols[ch] = n0 + part * PART + 64 * ch;
            }
            out.release(maps, cols, m0);
        }
    }
    out.drain();
}

}  // namespace

VIT_API int vit_ln_qkv_fwd(const void* x, const void* mu, const void* inv,
                           const void* w, const void* c, void* out, int M,
                           int K, int F, int Fq, void* stream) {
    if (M < 1 || K < 16 || K % 16 || F < 16 || F % 16 || Fq < 0 || Fq > F)
        return (int)cudaErrorInvalidValue;
    // x index-major; W (K, F) k-major; out in boxes of 64 × 64
    CUtensorMap x_map, w_map, out_map;
    if (!tma_map(&x_map, x, M, K, K, TILE_M) ||
        !tma_map(&w_map, w, K, F, F, 64) ||
        !tma_map(&out_map, out, M, F, F, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(ln_qkv_kernel, QRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles =
        (long long)((M + TILE_M - 1) / TILE_M) * ((F + COLS - 1) / COLS);
    ln_qkv_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                    QRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        x_map, w_map, out_map, (const float*)mu, (const float*)inv,
        (const float*)c, M, K, F, Fq);
    return (int)cudaGetLastError();
}
