// K12/K13: W8A8 fused LayerNorm + q/k/v projection.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_fwd_int8_kernel (two outputs) and
// ::_fwd_int8_kernel_3out (three outputs): one kernel with three output
// pointers serves both.  K14: W8A8 projection without bias.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_proj_int8_kernel.
//
// Both are (M, K) x (K, F) products with a per-row quantizing prologue and
// a dequantizing epilogue.  The qkv kernel quantizes the CENTRED row x − μ
// (s_x = max|x − μ| / 127), then writes q = inv·deq to the first Fq columns
// and k/v = deq + μ·c (c: column sums of the dequantized Wkv) to the next
// Fk and the rest; the projection quantizes x itself and writes deq, where
// deq = acc·s_x·s_W (acc the int32 product, s_W the per-column scales).
//
// Bound at M = 55,296: the bytes of x and of the outputs (171 MB for the
// qkv kernel, 113 MB for the projection), not their 65 / 22 G int8
// operations.  One block of 8 warps owns 64 rows.  Its prologue reads each
// row twice (amax, then codes) and keeps the codes in shared memory in the
// k16 layout, so x is read from device memory once; the block then walks
// the output columns in tiles of 128: each warp sums a 32 x 32 sub-tile on
// the int8 tensor cores (weight fragments read in the k16 layout from L2,
// where the 0.6 MB of weights stay), stages it in shared memory and applies
// the epilogue in fp32, writing bf16 rows.  Needs K % 16 == 0, K <= 2048 and
// F % 128 == 0; rows past M are masked.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int BM = 64;      // rows per block
constexpr int BN = 128;     // output columns per tile
constexpr int NW = 8;       // warps: 2 row halves x 4 column quarters
constexpr int LDST = 36;    // int pitch of a warp's 32 x 32 staging tile

template <bool QKV>
__global__ void __launch_bounds__(NW * 32)
w8a8_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                 const float* __restrict__ inv,
                 const signed char* __restrict__ w,
                 const float* __restrict__ sc, const float* __restrict__ c,
                 bf16* __restrict__ o0, bf16* __restrict__ o1,
                 bf16* __restrict__ o2, int M, int K, int F, int F0,
                 int F1) {
    extern __shared__ __align__(128) unsigned char smem[];
    signed char* A8 = reinterpret_cast<signed char*>(smem);
    int* stage = reinterpret_cast<int*>(smem + BM * K);
    float* srow = reinterpret_cast<float*>(stage + NW * 32 * LDST);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.x * BM;

    // prologue: one warp per row, codes into A8 (zeros past M)
    for (int r = warp; r < BM; r += NW) {
        const int gr = m0 + r;
        const bool live = gr < M;
        const bf16* xr = x + (size_t)(live ? gr : 0) * K;
        const float m = (QKV && live) ? mu[gr] : 0.f;
        float amax = 0.f;
        if (live)
            for (int k = lane; k < K; k += 32)
                amax = fmaxf(amax,
                             fabsf(__fsub_rn(__bfloat162float(xr[k]), m)));
        const float s = quant_scale(warp_max(amax));
        if (lane == 0) srow[r] = s;
        for (int k = lane; k < K; k += 32)
            A8[k16_index(r, k, BM)] =
                live ? quant8(__fsub_rn(__bfloat162float(xr[k]), m), s)
                     : (signed char)0;
    }
    __syncthreads();

    const int wr = warp >> 2, wc = warp & 3;
    int* st = stage + warp * 32 * LDST;
    for (int n0 = 0; n0 < F; n0 += BN) {
        const int col = n0 + wc * 32;
        FragC32 acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
#pragma unroll 4
        for (int kc = 0; kc < K / 16; ++kc) {
            FragA8 a[2];
            FragB8 b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(
                    a[i], A8 + kc * BM * 16 + (wr * 32 + i * 16) * 16, 16);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(
                    b[j], w + ((size_t)kc * F + col + j * 16) * 16, 16);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::store_matrix_sync(st + i * 16 * LDST + j * 16,
                                        acc[i][j], LDST, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 32 * 32; e += 32) {
            const int rr = e >> 5, cc = e & 31;
            const int r = wr * 32 + rr, gr = m0 + r, gc = col + cc;
            if (gr >= M) continue;
            const float deq = __fmul_rn(
                __fmul_rn((float)st[rr * LDST + cc], srow[r]), sc[gc]);
            if (!QKV) {
                o0[(size_t)gr * F + gc] = __float2bfloat16(deq);
            } else if (gc < F0) {
                o0[(size_t)gr * F0 + gc] =
                    __float2bfloat16(__fmul_rn(inv[gr], deq));
            } else {
                const float kv = __fadd_rn(deq, __fmul_rn(mu[gr], c[gc]));
                if (gc < F0 + F1)
                    o1[(size_t)gr * F1 + (gc - F0)] = __float2bfloat16(kv);
                else
                    o2[(size_t)gr * (F - F0 - F1) + (gc - F0 - F1)] =
                        __float2bfloat16(kv);
            }
        }
        __syncwarp();
    }
}

template <bool QKV>
int launch_w8a8(const void* x, const void* mu, const void* inv, const void* w,
                const void* sc, const void* c, void* o0, void* o1, void* o2,
                int M, int K, int F, int F0, int F1, void* stream) {
    if (K % 16 || K > 2048 || F % BN) return (int)cudaErrorInvalidValue;
    const int smem = BM * K + NW * 32 * LDST * 4 + BM * 4;
    cudaError_t e = cudaFuncSetAttribute(
        w8a8_rows_kernel<QKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    w8a8_rows_kernel<QKV><<<(M + BM - 1) / BM, NW * 32, smem,
                            (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const signed char*)w, (const float*)sc, (const float*)c, (bf16*)o0,
        (bf16*)o1, (bf16*)o2, M, K, F, F0, F1);
    return (int)cudaGetLastError();
}

}  // namespace

VIT_API int vit_ln_qkv_int8_fwd(const void* x, const void* mu, const void* inv,
                                const void* w, const void* sc, const void* c,
                                void* q, void* k, void* v, int M, int K,
                                int F, int Fq, int Fk, void* stream) {
    return launch_w8a8<true>(x, mu, inv, w, sc, c, q, k, v, M, K, F, Fq, Fk,
                             stream);
}

VIT_API int vit_proj_int8_fwd(const void* x, const void* w, const void* sc,
                              void* out, int M, int K, int F, void* stream) {
    return launch_w8a8<false>(x, nullptr, nullptr, w, sc, nullptr, out,
                              nullptr, nullptr, M, K, F, F, 0, stream);
}
