// K3: fused LayerNorm + q/kv projection.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_fwd_kernel.
//
// t = x @ W with W = [γ⊙Wq | Wkv] (K × F, row-major bf16); the first Fq
// columns become inv·(t − μ·c) (the LayerNorm applied after the product),
// the rest stay t (projections of the pre-LN x).  One kernel on the
// mma.sync mainloop of gemm_mma.cuh: A = x index-major, B = W k-major (read
// by ldmatrix.trans), 128 tokens × 128 columns per block, 8 warps of 64 ×
// 32, a 3-stage cp.async ring of 64-deep k steps, fp32 accumulators in
// registers (K2's out-stage configuration).  The epilogue works on the
// accumulators in place: μ and inv once per lane row, c once per column,
// the correction on each q column (decided per column: Fq may fall inside
// a column tile) and two adjacent columns stored as one bf16x2.  So the
// normalised x never reaches device memory.
//
// What bounds it: 65.2 GFLOP at 55,296 tokens, K = F = 768 (0.066 ms at
// the bf16 tensor-core peak).  Any M; K % 16 == 0 and F % 16 == 0 (the
// mainloop itself needs rows of a multiple of 8 elements and masks its
// tiles' tails; the epilogue masks columns past F).  No atomics:
// two launches on the same inputs give the same bits.
#include "gemm_mma.cuh"

using namespace vit;

namespace {

constexpr int TOKENS = 128, COLS = 128, BK = 64, STAGES = 3;
constexpr int WM = 2, WN = 4, BLOCKS = 2;
using Cfg = GemmCfg<TOKENS, COLS, BK, WM, WN, STAGES, false, true, 1>;

// out = [inv·(t − μ·c) | t] in bf16; grid (F / 128, tokens / 128)
__global__ void __launch_bounds__(Cfg::THREADS, BLOCKS)
ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
              const float* __restrict__ inv, const bf16* __restrict__ w,
              const float* __restrict__ c, bf16* __restrict__ out, int M,
              int K, int F, int Fq) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * COLS, m0 = blockIdx.y * TOKENS;
    float acc[1][Cfg::MT][Cfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mt][nt][e] = 0.f;
    const Mat wm[1] = {{w, F, K, F}};
    gemm_mainloop<Cfg>(acc, Mat{x, K, M, K}, wm, m0, n0, 0, K,
                       reinterpret_cast<bf16*>(smem_raw));

    // c of this lane's columns (0 where no q column is)
    float cc[Cfg::NT][2];
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = n0 + acc_col<Cfg>(nt, e);
            cc[nt][e] = col < Fq ? c[col] : 0.f;
        }
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = m0 + acc_row<Cfg>(mt, 2 * half);
            if (row >= M) continue;
            const float m = mu[row], iv = inv[row];
#pragma unroll
            for (int nt = 0; nt < Cfg::NT; ++nt) {
                const int col = n0 + acc_col<Cfg>(nt, 0);
                if (col >= F) continue;   // F % 8 == 0
                float t[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    t[e] = acc[0][mt][nt][2 * half + e];
                    if (col + e < Fq)   // no fused multiply-add, as the twin
                        t[e] = __fmul_rn(
                            iv, __fsub_rn(t[e], __fmul_rn(m, cc[nt][e])));
                }
                store_bf16x2(out + (size_t)row * F + col, t[0], t[1]);
            }
        }
}

}  // namespace

VIT_API int vit_ln_qkv_fwd(const void* x, const void* mu, const void* inv,
                           const void* w, const void* c, void* out, int M,
                           int K, int F, int Fq, void* stream) {
    if (M < 1 || K < 16 || K % 16 || F < 16 || F % 16 || Fq < 0 || Fq > F)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(ln_qkv_kernel, Cfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((F + COLS - 1) / COLS, (M + TOKENS - 1) / TOKENS);
    ln_qkv_kernel<<<grid, Cfg::THREADS, Cfg::SMEM_BYTES,
                    (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv, (const bf16*)w,
        (const float*)c, (bf16*)out, M, K, F, Fq);
    return (int)cudaGetLastError();
}
