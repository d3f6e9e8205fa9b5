// K8: fused GEGLU feed-forward backward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_bwd_kernel.
//
// With x̂ = (x − μ)·inv, y = bf16(x̂·γ + β), h = y@W1 (fp32, [val | gate]):
//   dact = dO@W2ᵀ;  dval = dact·gelu(gate);  dgate = dact·val·gelu'(gate)
//   with gelu'(g) = Φ(g) + g·φ(g);  dh = bf16([dval | dgate]);
//   act = bf16(gelu(gate)·val);  dy = dh@W1ᵀ;
//   dW1 = yᵀ dh,  dW2 = actᵀ dO,  dγ = Σ dy·x̂,  dβ = Σ dy,
//   dx = inv·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)) with dx̂ = dy·γ.
//
// The TPU kernel accumulates dW1 (768 × 4096) and dW2 (2048 × 768) in
// 19 MB of fp32 VMEM over a grid that runs in order.  A Hopper block has
// 227 KB of shared memory and blocks run in no order, so the work is split
// in two phases:
// - Phase A (geglu_bwd_tokens_kernel), one block of 8 warps per 32 tokens:
//   builds y in shared memory, walks the inner dimension in chunks of 64 as
//   K2 does (h and dact for the chunk on tensor cores, the GEGLU derivative
//   on the CUDA cores), writes dh, act and y to device memory for phase B,
//   and accumulates dy = dh@W1ᵀ for the 32 × 768 tile in registers; the
//   LayerNorm backward runs in its epilogue, and per-tile partial sums of
//   dγ and dβ go to device memory.  Per token it does 3·2·768·4096/2 +
//   2·2·768·2048/2 multiply-adds: tensor-core bound, with W1 and W2 read
//   through L2.
// - Phase B (wgrad_kernel + sum_rows_kernel): dW = Aᵀ B over tokens as a
//   tensor-core GEMM whose token (K) dimension is split into S segments;
//   each segment writes an fp32 partial and the partials are summed in a
//   fixed order, so the result is deterministic.  The same sum reduces the
//   dγ/dβ tile partials.
// The intermediates (dh, act, y: 0.8 GB at 55,296 tokens) pass through
// device memory; keeping them on chip is later work.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int BM = 32;          // tokens per phase-A block
constexpr int CH = 64;          // inner columns per chunk
constexpr int NW = 8;           // warps per phase-A block

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

template <int D>
struct Layout {
    static constexpr int LDX = D + 8;        // bf16 pitch of y and dO
    static constexpr int LDY = D + 4;        // fp32 pitch of dy (epilogue)
    static constexpr int LDH = 2 * CH + 4;   // fp32 pitch of h
    static constexpr int LDA = CH + 4;       // fp32 pitch of dact
    static constexpr int LDB = 2 * CH + 8;   // bf16 pitch of dh
    static constexpr int WCOLS = D / NW;     // dy columns per warp
    static constexpr int NCF = WCOLS / 16;   // dy fragments per warp row
    static constexpr int X_BYTES = BM * LDX * 2;
    static constexpr int H_BYTES = BM * LDH * 4;
    static constexpr int A_BYTES = BM * LDA * 4;
    static constexpr int B_BYTES = BM * LDB * 2;
    static constexpr int SMEM = 2 * X_BYTES + H_BYTES + A_BYTES + B_BYTES;
    static_assert(BM * LDY * 4 <= 2 * X_BYTES, "dy staging fits over y and dO");
    static_assert(D % (NW * 16) == 0, "D must split into 16-wide warp slices");
    static_assert(X_BYTES % 128 == 0 && H_BYTES % 128 == 0 && A_BYTES % 128 == 0,
                  "alignment");
};

template <int D>
__global__ void __launch_bounds__(NW * 32, 1)
geglu_bwd_tokens_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                        const float* __restrict__ inv,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                        const bf16* __restrict__ dout, bf16* __restrict__ dx,
                        bf16* __restrict__ dh, bf16* __restrict__ act,
                        bf16* __restrict__ y, float* __restrict__ dgp,
                        float* __restrict__ dbp, int M, int I2) {
    using L = Layout<D>;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Ys = reinterpret_cast<bf16*>(smem);
    bf16* Os = reinterpret_cast<bf16*>(smem + L::X_BYTES);
    float* Hs = reinterpret_cast<float*>(smem + 2 * L::X_BYTES);
    float* As = reinterpret_cast<float*>(smem + 2 * L::X_BYTES + L::H_BYTES);
    bf16* Bs = reinterpret_cast<bf16*>(smem + 2 * L::X_BYTES + L::H_BYTES
                                       + L::A_BYTES);
    float* DYs = reinterpret_cast<float*>(smem);   // epilogue, over Ys and Os

    const int inner = I2 / 2;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.x * BM;

    // y = bf16(x̂·γ + β) to shared and device memory; dO to shared memory
    for (int e = tid; e < BM * D / 2; e += NW * 32) {
        int r = e / (D / 2), c = 2 * (e % (D / 2));
        __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
        if (m0 + r < M) {
            __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                x + (size_t)(m0 + r) * D + c);
            float m = mu[m0 + r], iv = inv[m0 + r];
            val = __floats2bfloat162_rn(
                (__low2float(xv) - m) * iv * gamma[c] + beta[c],
                (__high2float(xv) - m) * iv * gamma[c + 1] + beta[c + 1]);
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * D + c) = val;
        }
        *reinterpret_cast<__nv_bfloat162*>(Ys + r * L::LDX + c) = val;
    }
    for (int e = tid; e < BM * D / 8; e += NW * 32) {
        int r = e / (D / 8), cv = e % (D / 8);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (m0 + r < M)
            val = *reinterpret_cast<const uint4*>(dout + (size_t)(m0 + r) * D + cv * 8);
        *reinterpret_cast<uint4*>(Os + r * L::LDX + cv * 8) = val;
    }
    __syncthreads();

    FragC dyacc[2][L::NCF];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int cf = 0; cf < L::NCF; ++cf) wmma::fill_fragment(dyacc[i][cf], 0.f);

    // h: warps 0-3 the chunk's val columns, 4-7 its gate columns
    const int hcol = (warp < 4) ? warp * 16 : CH + (warp - 4) * 16;
    // dact: warp w owns rows 16·(w / 4), columns 16·(w % 4) of the chunk
    const int ai = warp >> 2, aj = (warp & 3) * 16;

    for (int ch = 0; ch < inner; ch += CH) {
        const int wcol = (warp < 4) ? ch + warp * 16 : inner + ch + (warp - 4) * 16;
        FragC hacc[2];
        wmma::fill_fragment(hacc[0], 0.f);
        wmma::fill_fragment(hacc[1], 0.f);
        FragC aacc;
        wmma::fill_fragment(aacc, 0.f);
#pragma unroll 4
        for (int k = 0; k < D; k += 16) {
            FragB bw;
            wmma::load_matrix_sync(bw, w1 + (size_t)k * I2 + wcol, I2);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                FragA a;
                wmma::load_matrix_sync(a, Ys + i * 16 * L::LDX + k, L::LDX);
                wmma::mma_sync(hacc[i], a, bw, hacc[i]);
            }
            // W2ᵀ[k.., ch + aj..] read as a col-major view of W2's rows
            FragBT bt;
            wmma::load_matrix_sync(bt, w2 + (size_t)(ch + aj) * D + k, D);
            FragA o;
            wmma::load_matrix_sync(o, Os + ai * 16 * L::LDX + k, L::LDX);
            wmma::mma_sync(aacc, o, bt, aacc);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
            wmma::store_matrix_sync(Hs + i * 16 * L::LDH + hcol, hacc[i], L::LDH,
                                    wmma::mem_row_major);
        wmma::store_matrix_sync(As + ai * 16 * L::LDA + aj, aacc, L::LDA,
                                wmma::mem_row_major);
        __syncthreads();

        for (int e = tid; e < BM * CH; e += NW * 32) {
            int r = e / CH, j = e % CH;
            float val = Hs[r * L::LDH + j];
            float g = Hs[r * L::LDH + CH + j];
            float da = As[r * L::LDA + j];
            float cdf = 0.5f * (1.f + erff(g * 0.70710678118654752f));
            float gelu = g * cdf;
            float pdf = expf(-0.5f * g * g) * 0.3989422804014327f;
            bf16 dv = __float2bfloat16(da * gelu);
            bf16 dg = __float2bfloat16(da * val * (cdf + g * pdf));
            Bs[r * L::LDB + j] = dv;
            Bs[r * L::LDB + CH + j] = dg;
            if (m0 + r < M) {
                size_t row = (size_t)(m0 + r);
                dh[row * I2 + ch + j] = dv;
                dh[row * I2 + inner + ch + j] = dg;
                act[row * inner + ch + j] = __float2bfloat16(gelu * val);
            }
        }
        __syncthreads();

        // dy += dh[:, chunk] @ W1[:, chunk]ᵀ
#pragma unroll
        for (int kk = 0; kk < 2 * CH; kk += 16) {
            const int wc = (kk < CH) ? ch + kk : inner + ch + (kk - CH);
            FragA a[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], Bs + i * 16 * L::LDB + kk, L::LDB);
#pragma unroll
            for (int cf = 0; cf < L::NCF; ++cf) {
                FragBT bt;   // col-major view of W1's rows is W1ᵀ
                wmma::load_matrix_sync(
                    bt, w1 + (size_t)(warp * L::WCOLS + cf * 16) * I2 + wc, I2);
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::mma_sync(dyacc[i][cf], a[i], bt, dyacc[i][cf]);
            }
        }
    }
    __syncthreads();   // y and dO are dead: dy is staged over them

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int cf = 0; cf < L::NCF; ++cf)
            wmma::store_matrix_sync(DYs + i * 16 * L::LDY + warp * L::WCOLS + cf * 16,
                                    dyacc[i][cf], L::LDY, wmma::mem_row_major);
    __syncthreads();

    // LayerNorm backward, one warp per row
    for (int r = warp; r < BM; r += NW) {
        if (m0 + r >= M) continue;
        const bf16* xr = x + (size_t)(m0 + r) * D;
        const float m = mu[m0 + r], iv = inv[m0 + r];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < D; c += 32) {
            float xn = (__bfloat162float(xr[c]) - m) * iv;
            float dxn = DYs[r * L::LDY + c] * gamma[c];
            s1 += dxn;
            s2 += dxn * xn;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        s1 /= D;
        s2 /= D;
        bf16* dxr = dx + (size_t)(m0 + r) * D;
        for (int c = lane; c < D; c += 32) {
            float xn = (__bfloat162float(xr[c]) - m) * iv;
            float dxn = DYs[r * L::LDY + c] * gamma[c];
            dxr[c] = __float2bfloat16(iv * (dxn - s1 - xn * s2));
        }
    }

    // per-tile partial sums of dγ = Σ dy·x̂ and dβ = Σ dy
    for (int c = tid; c < D; c += NW * 32) {
        float sg = 0.f, sb = 0.f;
        for (int r = 0; r < BM && m0 + r < M; ++r) {
            float xn = (__bfloat162float(x[(size_t)(m0 + r) * D + c]) - mu[m0 + r])
                       * inv[m0 + r];
            float d = DYs[r * L::LDY + c];
            sg += d * xn;
            sb += d;
        }
        dgp[(size_t)blockIdx.x * D + c] = sg;
        dbp[(size_t)blockIdx.x * D + c] = sb;
    }
}

// Phase B: partial[s] = A[seg s]ᵀ B[seg s] with A (M, P), B (M, Q) bf16
// row-major (row pitches lda, ldb) and partial (S, P, Q) fp32.  One block of
// 4 warps per 64 × 64 output tile and segment; each warp owns 32 × 32.
constexpr int GT = 64;           // output tile edge
constexpr int GK = 32;           // tokens per step
constexpr int LDG = GT + 8;      // bf16 pitch of the staged tiles

__global__ void __launch_bounds__(128)
wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             float* __restrict__ part, int M, int P, int Q, int lda, int ldb,
             int seg) {
    __shared__ __align__(128) bf16 As[GK * LDG];
    __shared__ __align__(128) bf16 Bs[GK * LDG];
    const int tid = threadIdx.x, warp = tid >> 5;
    const int q0 = blockIdx.x * GT, p0 = blockIdx.y * GT, s = blockIdx.z;
    const int t_begin = s * seg, t_end = min(M, t_begin + seg);
    const int wp = (warp >> 1) * 32, wq = (warp & 1) * 32;

    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int t0 = t_begin; t0 < t_end; t0 += GK) {
        __syncthreads();
        for (int v = tid; v < GK * (GT / 8); v += 128) {
            int r = v / (GT / 8), cv = v % (GT / 8);
            uint4 av = make_uint4(0, 0, 0, 0), bv = av;
            if (t0 + r < t_end) {
                av = *reinterpret_cast<const uint4*>(a + (size_t)(t0 + r) * lda + p0 + cv * 8);
                bv = *reinterpret_cast<const uint4*>(b + (size_t)(t0 + r) * ldb + q0 + cv * 8);
            }
            *reinterpret_cast<uint4*>(As + r * LDG + cv * 8) = av;
            *reinterpret_cast<uint4*>(Bs + r * LDG + cv * 8) = bv;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GK; kk += 16) {
            FragAc fa[2];   // col-major view of the A rows is Aᵀ
            FragB fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], As + kk * LDG + wp + i * 16, LDG);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], Bs + kk * LDG + wq + j * 16, LDG);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
    }
    float* out = part + (size_t)s * P * Q;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(
                out + (size_t)(p0 + wp + i * 16) * Q + q0 + wq + j * 16,
                acc[i][j], Q, wmma::mem_row_major);
}

// out[i] = Σ_s part[s·N + i], s in order: a deterministic reduction
__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int S, long long N) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[(size_t)s * N + i];
    out[i] = acc;
}

}  // namespace

VIT_API int vit_geglu_ff_bwd_tokens(
    const void* x, const void* mu, const void* inv, const void* gamma,
    const void* beta, const void* w1, const void* w2, const void* dout,
    void* dx, void* dh, void* act, void* y, void* dgp, void* dbp, int M,
    int D, int I2, void* stream) {
    if (D != 768 || I2 % (2 * CH)) return (int)cudaErrorInvalidValue;
    constexpr int smem = Layout<768>::SMEM;
    cudaError_t e = cudaFuncSetAttribute(
        geglu_bwd_tokens_kernel<768>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    geglu_bwd_tokens_kernel<768><<<(M + BM - 1) / BM, NW * 32, smem,
                                   (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)beta, (const bf16*)w1,
        (const bf16*)w2, (const bf16*)dout, (bf16*)dx, (bf16*)dh, (bf16*)act,
        (bf16*)y, (float*)dgp, (float*)dbp, M, I2);
    return (int)cudaGetLastError();
}

VIT_API int vit_wgrad(const void* a, const void* b, void* part, int M, int P,
                      int Q, int lda, int ldb, int S, int seg, void* stream) {
    if (P % GT || Q % GT || lda % 8 || ldb % 8 || seg % GK)
        return (int)cudaErrorInvalidValue;
    dim3 grid(Q / GT, P / GT, S);
    wgrad_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)a, (const bf16*)b, (float*)part, M, P, Q, lda, ldb, seg);
    return (int)cudaGetLastError();
}

VIT_API int vit_sum_rows(const void* part, void* out, int S, long long N,
                         void* stream) {
    sum_rows_kernel<<<(unsigned)((N + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)out, S, N);
    return (int)cudaGetLastError();
}
