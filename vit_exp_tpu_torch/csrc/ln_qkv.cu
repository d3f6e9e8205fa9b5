// K3: fused LayerNorm + q/kv projection.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_fwd_kernel.
//
// t = x @ W with W = [γ⊙Wq | Wkv] (K × F, row-major bf16); the first Fq
// columns become inv·(t − μ·c) (the LayerNorm applied after the product),
// the rest stay t (projections of the pre-LN x).  A tiled tensor-core GEMM:
// 64 × 64 output tile per block, 4 warps of 32 × 32, k-slices of 32 staged
// through shared memory with 16-byte loads, fp32 accumulators, and the
// per-row correction in the epilogue, so the normalised x never reaches
// device memory.  Needs K % 32 == 0 and F % 64 == 0; rows are masked.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;   // bf16, padded against bank conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // fp32

__global__ void __launch_bounds__(128)
ln_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
              const float* __restrict__ inv, const bf16* __restrict__ w,
              const float* __restrict__ c, bf16* __restrict__ out, int M,
              int K, int F, int Fq) {
    __shared__ __align__(128) bf16 As[BM * LDA];
    __shared__ __align__(128) bf16 Bs[BK * LDB];
    __shared__ __align__(128) float Cs[BM * LDC];

    const int tid = threadIdx.x, warp = tid >> 5;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int v = tid; v < BM * BK / 8; v += blockDim.x) {
            int r = v / (BK / 8), cv = v % (BK / 8);
            uint4 val = make_uint4(0, 0, 0, 0);
            if (m0 + r < M)
                val = *reinterpret_cast<const uint4*>(
                    x + (size_t)(m0 + r) * K + k0 + cv * 8);
            *reinterpret_cast<uint4*>(&As[r * LDA + cv * 8]) = val;
        }
        for (int v = tid; v < BK * BN / 8; v += blockDim.x) {
            int r = v / (BN / 8), cv = v % (BN / 8);
            *reinterpret_cast<uint4*>(&Bs[r * LDB + cv * 8]) =
                *reinterpret_cast<const uint4*>(
                    w + (size_t)(k0 + r) * F + n0 + cv * 8);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            FragA a[2];
            FragB b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], &As[(wm + i * 16) * LDA + kk], LDA);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn + j * 16], LDB);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(&Cs[(wm + i * 16) * LDC + wn + j * 16],
                                    acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    for (int e = tid; e < BM * BN; e += blockDim.x) {
        int r = e / BN, cc = e % BN;
        int gr = m0 + r, gc = n0 + cc;
        if (gr >= M) continue;
        float t = Cs[r * LDC + cc];
        if (gc < Fq) t = inv[gr] * (t - mu[gr] * c[gc]);
        out[(size_t)gr * F + gc] = __float2bfloat16(t);
    }
}

}  // namespace

VIT_API int vit_ln_qkv_fwd(const void* x, const void* mu, const void* inv,
                           const void* w, const void* c, void* out, int M,
                           int K, int F, int Fq, void* stream) {
    if (K % BK || F % BN) return (int)cudaErrorInvalidValue;
    dim3 grid(F / BN, (M + BM - 1) / BM);
    ln_qkv_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv, (const bf16*)w,
        (const float*)c, (bf16*)out, M, K, F, Fq);
    return (int)cudaGetLastError();
}
