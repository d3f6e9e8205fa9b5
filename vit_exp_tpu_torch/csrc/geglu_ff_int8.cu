// K11: W8A8 GEGLU feed-forward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_int8_kernel.
//
// y = (x − μ)·inv·γ + β in fp32, quantized per token (y8, s_y);
// h = (y8 @ W1)·s_y·s_W1 in fp32 with W1 = [val | gate] int8 per column;
// act = gelu_erf(gate)·val in fp32, quantized per token (a8, s_a);
// out = (a8 @ W2)·s_a·s_W2, rounded to bf16 once.
//
// Bound at M = 55,296 by the 522 G int8 operations of the two products.
// The per-token scale of act needs the amax over the whole inner-wide row
// before the second product can start, so K2's design (stream the inner
// dimension, accumulate act @ W2 chunk by chunk) does not carry over.  Two
// designs fit: keep each token tile's act rows in shared memory, or write
// act to device memory and run a second pass.  This kernel keeps them on
// chip: one block of 16 warps owns 16 tokens.  (1) Each warp quantizes one
// token's y into shared memory (k16 layout).  (2) The warps split the inner
// columns in 16-wide slices; for each slice a warp sums the val and the
// gate fragment over K = 768 on the int8 tensor cores (W1 fragments read in
// the k16 layout from L2), applies the dequantizing scales and GELU, and
// writes act (fp32) into the block's 16 x inner tile (128 KB at inner 2048).
// (3) Each warp finds one token's amax over act and writes its codes.
// (4) Each warp sums 48 output columns of a8 @ W2 over the whole inner
// dimension and writes them.  The (tokens, inner) act never reaches device
// memory; the price is one block per SM (212 KB of shared memory) and 4.7
// MB of int8 weights streamed from L2 for every 16 tokens.  Needs D = 768
// and 2·inner a multiple of 32 up to 4096; rows past M are masked.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int BM = 16;      // tokens per block
constexpr int NW = 16;      // warps per block
constexpr int LDH = 20;     // int pitch of a warp's 16 x 16 staging tiles

template <int D>
struct Smem {
    static constexpr int Y8_BYTES = D * BM;
    static constexpr int STAGE_BYTES = NW * 2 * 16 * LDH * 4;
    __host__ __device__ static int a8_bytes(int inner) { return inner * BM; }
    __host__ __device__ static int lda(int inner) { return inner + 4; }
    __host__ __device__ static int bytes(int inner) {
        return Y8_BYTES + a8_bytes(inner) + STAGE_BYTES +
               (BM * lda(inner) + 2 * BM) * 4;
    }
};

template <int D>
__global__ void __launch_bounds__(NW * 32, 1)
geglu_ff_int8_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                     const float* __restrict__ inv,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const signed char* __restrict__ w1,
                     const float* __restrict__ s1,
                     const signed char* __restrict__ w2,
                     const float* __restrict__ s2, bf16* __restrict__ out,
                     int M, int I2) {
    using S = Smem<D>;
    constexpr int PER = D / 32;              // y values per lane
    constexpr int NCF = D / (NW * 16);       // output fragments per warp
    static_assert(D % (NW * 16) == 0, "D must split into 16-wide warp slices");
    const int inner = I2 / 2, lda = S::lda(inner);
    extern __shared__ __align__(128) unsigned char smem[];
    signed char* Y8 = reinterpret_cast<signed char*>(smem);
    signed char* A8 = Y8 + S::Y8_BYTES;
    int* stage = reinterpret_cast<int*>(A8 + S::a8_bytes(inner));
    float* act = reinterpret_cast<float*>(stage + S::STAGE_BYTES / 4);
    float* ys = act + BM * lda;
    float* as = ys + BM;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.x * BM;
    int* sv = stage + warp * 2 * 16 * LDH;   // this warp's staging tiles
    int* sg = sv + 16 * LDH;

    // (1) y = x̂·γ + β, quantized per token
    for (int r = warp; r < BM; r += NW) {
        const int gr = m0 + r;
        float y[PER];
        float amax = 0.f;
        if (gr < M) {
            const float m = mu[gr], iv = inv[gr];
            const bf16* xr = x + (size_t)gr * D;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int k = lane + 32 * i;
                const float xn =
                    __fmul_rn(__fsub_rn(__bfloat162float(xr[k]), m), iv);
                y[i] = __fadd_rn(__fmul_rn(xn, gamma[k]), beta[k]);
                amax = fmaxf(amax, fabsf(y[i]));
            }
        } else {
#pragma unroll
            for (int i = 0; i < PER; ++i) y[i] = 0.f;
        }
        const float s = quant_scale(warp_max(amax));
        if (lane == 0) ys[r] = s;
#pragma unroll
        for (int i = 0; i < PER; ++i)
            Y8[k16_index(r, lane + 32 * i, BM)] = quant8(y[i], s);
    }
    __syncthreads();

    // (2) h = y8 @ W1 per 16-column slice of val and gate; act = gelu·val
    for (int f = warp; f < inner / 16; f += NW) {
        const int c0 = f * 16;
        FragC32 av, ag;
        wmma::fill_fragment(av, 0);
        wmma::fill_fragment(ag, 0);
#pragma unroll 4
        for (int kc = 0; kc < D / 16; ++kc) {
            FragA8 a;
            FragB8 bv, bg;
            wmma::load_matrix_sync(a, Y8 + kc * BM * 16, 16);
            wmma::load_matrix_sync(bv, w1 + ((size_t)kc * I2 + c0) * 16, 16);
            wmma::load_matrix_sync(bg, w1 + ((size_t)kc * I2 + inner + c0) * 16,
                                   16);
            wmma::mma_sync(av, a, bv, av);
            wmma::mma_sync(ag, a, bg, ag);
        }
        wmma::store_matrix_sync(sv, av, LDH, wmma::mem_row_major);
        wmma::store_matrix_sync(sg, ag, LDH, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 16; e += 32) {
            const int rr = e >> 4, cc = e & 15;
            const float sy = ys[rr];
            const float val =
                __fmul_rn(__fmul_rn((float)sv[rr * LDH + cc], sy), s1[c0 + cc]);
            const float g = __fmul_rn(__fmul_rn((float)sg[rr * LDH + cc], sy),
                                      s1[inner + c0 + cc]);
            const float gelu = __fmul_rn(
                __fmul_rn(0.5f, g),
                __fadd_rn(1.f, erff(__fmul_rn(g, 0.70710678118654752f))));
            act[rr * lda + c0 + cc] = __fmul_rn(gelu, val);
        }
        __syncwarp();
    }
    __syncthreads();

    // (3) act quantized per token over its whole row
    for (int r = warp; r < BM; r += NW) {
        const float* ar = act + r * lda;
        float amax = 0.f;
        for (int k = lane; k < inner; k += 32) amax = fmaxf(amax, fabsf(ar[k]));
        const float s = quant_scale(warp_max(amax));
        if (lane == 0) as[r] = s;
        for (int k = lane; k < inner; k += 32)
            A8[k16_index(r, k, BM)] = quant8(ar[k], s);
    }
    __syncthreads();

    // (4) out = a8 @ W2, NCF 16-column fragments per warp
    const int col0 = warp * NCF * 16;
    FragC32 acc[NCF];
#pragma unroll
    for (int cf = 0; cf < NCF; ++cf) wmma::fill_fragment(acc[cf], 0);
#pragma unroll 2
    for (int kc = 0; kc < inner / 16; ++kc) {
        FragA8 a;
        wmma::load_matrix_sync(a, A8 + kc * BM * 16, 16);
#pragma unroll
        for (int cf = 0; cf < NCF; ++cf) {
            FragB8 b;
            wmma::load_matrix_sync(b, w2 + ((size_t)kc * D + col0 + cf * 16) * 16,
                                   16);
            wmma::mma_sync(acc[cf], a, b, acc[cf]);
        }
    }
#pragma unroll
    for (int cf = 0; cf < NCF; ++cf) {
        wmma::store_matrix_sync(sv, acc[cf], LDH, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 16; e += 32) {
            const int rr = e >> 4, cc = e & 15;
            const int gr = m0 + rr, col = col0 + cf * 16 + cc;
            if (gr < M)
                out[(size_t)gr * D + col] = __float2bfloat16(__fmul_rn(
                    __fmul_rn((float)sv[rr * LDH + cc], as[rr]), s2[col]));
        }
        __syncwarp();
    }
}

}  // namespace

VIT_API int vit_geglu_ff_int8_fwd(const void* x, const void* mu,
                                  const void* inv, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* s1, const void* w2,
                                  const void* s2, void* out, int M, int D,
                                  int I2, void* stream) {
    if (D != 768 || I2 % 32 || I2 > 4096) return (int)cudaErrorInvalidValue;
    const int smem = Smem<768>::bytes(I2 / 2);
    cudaError_t e = cudaFuncSetAttribute(
        geglu_ff_int8_kernel<768>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    geglu_ff_int8_kernel<768><<<(M + BM - 1) / BM, NW * 32, smem,
                                (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)beta, (const signed char*)w1,
        (const float*)s1, (const signed char*)w2, (const float*)s2,
        (bf16*)out, M, I2);
    return (int)cudaGetLastError();
}
