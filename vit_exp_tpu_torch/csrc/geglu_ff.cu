// K2: fused GEGLU feed-forward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_kernel.
//
// x̂ = bf16((x − μ)·inv); h = bf16(x̂ @ W1' + d1) with W1' = γ⊙W1 laid out
// [val | gate]; act = bf16(bf16(gelu_erf(gate)) · val); out = act @ W2.
// One block of 8 warps owns 32 tokens.  x̂ is built once in shared memory;
// the block walks the inner dimension in chunks of 64: each warp computes
// one 16-column slice of the chunk's [val | gate] columns on tensor cores
// (W1 fragments read through L2, fp32 accumulators), the block applies
// bias, GELU and the product through shared memory, and each warp adds
// act @ W2[chunk] into its 32 × 96 slice of the fp32 output tile, which stays
// in registers for the whole walk.  The (tokens, 2·inner) intermediate
// never reaches device memory.  Needs D = 768 and inner % 64 == 0.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int BM = 32;          // tokens per block
constexpr int CH = 64;          // inner columns per chunk
constexpr int NW = 8;           // warps per block

template <int D>
struct Layout {
    static constexpr int LDX = D + 8;        // bf16 pitch of x̂
    static constexpr int LDH = 2 * CH + 4;   // fp32 pitch of h
    static constexpr int LDA = CH + 8;       // bf16 pitch of act
    static constexpr int WCOLS = D / NW;     // output columns per warp
    static constexpr int NCF = WCOLS / 16;   // output fragments per warp row
    static constexpr int X_BYTES = BM * LDX * 2;
    static constexpr int H_BYTES = BM * LDH * 4;
    static constexpr int A_BYTES = BM * LDA * 2;
    static constexpr int SMEM = X_BYTES + H_BYTES + A_BYTES;
    static_assert(D % (NW * 16) == 0, "D must split into 16-wide warp slices");
    static_assert(X_BYTES % 128 == 0 && H_BYTES % 128 == 0, "alignment");
};

template <int D>
__global__ void __launch_bounds__(NW * 32, 1)
geglu_ff_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                const float* __restrict__ inv, const bf16* __restrict__ w1,
                const float* __restrict__ d1, const bf16* __restrict__ w2,
                bf16* __restrict__ out, int M, int I2) {
    using L = Layout<D>;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Xs = reinterpret_cast<bf16*>(smem);
    float* Hs = reinterpret_cast<float*>(smem + L::X_BYTES);
    bf16* As = reinterpret_cast<bf16*>(smem + L::X_BYTES + L::H_BYTES);

    const int inner = I2 / 2;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.x * BM;

    for (int e = tid; e < BM * D / 2; e += NW * 32) {
        int r = e / (D / 2), c2 = e % (D / 2);
        __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
        if (m0 + r < M) {
            __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                x + (size_t)(m0 + r) * D + 2 * c2);
            float m = mu[m0 + r], iv = inv[m0 + r];
            val = __floats2bfloat162_rn((__low2float(xv) - m) * iv,
                                        (__high2float(xv) - m) * iv);
        }
        *reinterpret_cast<__nv_bfloat162*>(Xs + r * L::LDX + 2 * c2) = val;
    }
    __syncthreads();

    FragC oacc[2][L::NCF];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int cf = 0; cf < L::NCF; ++cf) wmma::fill_fragment(oacc[i][cf], 0.f);

    // this warp's 16 columns of the chunk: warps 0-3 val, 4-7 gate
    const int hcol = (warp < 4) ? warp * 16 : CH + (warp - 4) * 16;

    for (int ch = 0; ch < inner; ch += CH) {
        const int wcol = (warp < 4) ? ch + warp * 16 : inner + ch + (warp - 4) * 16;
        FragC hacc[2];
        wmma::fill_fragment(hacc[0], 0.f);
        wmma::fill_fragment(hacc[1], 0.f);
#pragma unroll 4
        for (int k = 0; k < D; k += 16) {
            FragB bw;
            wmma::load_matrix_sync(bw, w1 + (size_t)k * I2 + wcol, I2);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                FragA a;
                wmma::load_matrix_sync(a, Xs + i * 16 * L::LDX + k, L::LDX);
                wmma::mma_sync(hacc[i], a, bw, hacc[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
            wmma::store_matrix_sync(Hs + i * 16 * L::LDH + hcol, hacc[i], L::LDH,
                                    wmma::mem_row_major);
        __syncthreads();

        for (int e = tid; e < BM * CH; e += NW * 32) {
            int r = e / CH, j = e % CH;
            float val = bf16_round(Hs[r * L::LDH + j] + d1[ch + j]);
            float g = bf16_round(Hs[r * L::LDH + CH + j] + d1[inner + ch + j]);
            float gelu = 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
            As[r * L::LDA + j] = __float2bfloat16(bf16_round(gelu) * val);
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < CH; kk += 16) {
            FragA a[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + i * 16 * L::LDA + kk, L::LDA);
#pragma unroll
            for (int cf = 0; cf < L::NCF; ++cf) {
                FragB bw;
                wmma::load_matrix_sync(
                    bw, w2 + (size_t)(ch + kk) * D + warp * L::WCOLS + cf * 16, D);
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::mma_sync(oacc[i][cf], a[i], bw, oacc[i][cf]);
            }
        }
    }
    __syncthreads();

    // write out one fragment at a time through a per-warp slice of Hs
    float* stage = Hs + warp * 16 * 20;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int cf = 0; cf < L::NCF; ++cf) {
            wmma::store_matrix_sync(stage, oacc[i][cf], 20, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                int rr = e / 16, cc = e % 16;
                int gr = m0 + i * 16 + rr;
                if (gr < M)
                    out[(size_t)gr * D + warp * L::WCOLS + cf * 16 + cc] =
                        __float2bfloat16(stage[rr * 20 + cc]);
            }
            __syncwarp();
        }
    }
}

}  // namespace

VIT_API int vit_geglu_ff_fwd(const void* x, const void* mu, const void* inv,
                             const void* w1, const void* d1, const void* w2,
                             void* out, int M, int D, int I2, void* stream) {
    if (D != 768 || I2 % (2 * CH)) return (int)cudaErrorInvalidValue;
    constexpr int smem = Layout<768>::SMEM;
    cudaError_t e = cudaFuncSetAttribute(
        geglu_ff_kernel<768>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    geglu_ff_kernel<768><<<(M + BM - 1) / BM, NW * 32, smem,
                           (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv, (const bf16*)w1,
        (const float*)d1, (const bf16*)w2, (bf16*)out, M, I2);
    return (int)cudaGetLastError();
}
