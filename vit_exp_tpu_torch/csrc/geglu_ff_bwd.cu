// K8: fused GEGLU feed-forward backward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_bwd_kernel.
//
// With x̂ = (x − μ)·inv, y = bf16(x̂·γ + β), h = y@W1 (fp32, [val | gate]):
//   dact = dO@W2ᵀ;  dval = dact·gelu(gate);  dgate = dact·val·gelu'(gate)
//   with gelu'(g) = Φ(g) + g·φ(g);  dh = bf16([dval | dgate]);
//   act = bf16(gelu(gate)·val);  dy = dh@W1ᵀ (fp32);
//   dW1 = yᵀ dh,  dW2 = actᵀ dO,  dγ = Σ dy·x̂,  dβ = Σ dy,
//   dx = inv·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)) with dx̂ = dy·γ.
//
// The TPU kernel accumulates dW1 (768 × 4096) and dW2 (2048 × 768) in
// 19 MB of fp32 VMEM over a grid that runs in order.  A Hopper block has
// 227 KB of shared memory, blocks run in no order, and the fp32 sums of
// dy (tokens × 768) and dW do not fit on chip, so the work is a chain of
// tensor-core GEMMs with fused epilogues on the mainloop of gemm_mma.cuh
// (mma.sync m16n8k16, a cp.async ring, accumulators in registers):
// - token phase (per token: 3·768·2048 + 768·4096 multiply-adds, 870 GFLOP
//   at 55,296 tokens, tensor-core bound):
//   geglu_bwd_y_kernel: y = bf16(x̂·γ + β) once (the weight phase needs it
//     too).  Bytes bound.
//   geglu_bwd_dh_kernel: per tile of 128 tokens × 64 inner columns c,
//     dact = dO·W2[c, :]ᵀ, then val = y·W1[:, c] and gate = y·W1[:, I + c]
//     (one A tile, two B tiles per step), all three in the same lanes'
//     registers, so the GEGLU derivative (erf, exp, two products) runs on
//     the accumulators and the epilogue writes dh and act in bf16.  Every
//     staged weight tile serves the block's 128 tokens; the grid runs the
//     column tiles of one token tile together, so y and dO come from
//     device memory once and W1, W2 (9.4 MB) stay in L2.
//   geglu_bwd_dy_kernel: dy = dh·W1ᵀ (K = 2I, N = 768) in 128 × 128 tiles,
//     two blocks per SM, written in fp32.
//   geglu_bwd_dx_kernel: a row pass, one warp per row: the LayerNorm row
//     sums, dx, and per-block partial sums of dγ and dβ over 64 rows.
// - weight phase (522 GFLOP): wgrad_kernel, dW = Aᵀ B over tokens (A and
//   B token-major, read k-major by ldmatrix.trans) in 128 × 128 tiles,
//   split into token segments (the plan is ops/geglu_ff.py::wgrad_plan);
//   each segment writes an fp32 partial and sum_rows_kernel adds the
//   partials in a fixed order, as it does the dγ/dβ partials.
// Tilings, from trials on an H100: steps of 64 ran dh and dy faster than
// steps of 32 (the weight GEMM alike either way), dh with a 4-stage ring
// a little faster than with 3 (dy holds two blocks per SM with 3); 128 × 256 tiles of 64 × 64 per warp (over 220
// registers, one block per SM) were no faster than 128 × 128 at two
// blocks per SM; 192-token dh tiles spilled at the 168-register cap of 12
// warps.
// No atomics: two launches on the same inputs give the same bits.  The
// intermediates (y, dh, act: 0.68 GB at 55,296 tokens, and dy in fp32,
// 0.17 GB) pass through device memory: ≈ 0.5 ms of the 3.35 TB/s.
#include "gemm_mma.cuh"

using namespace vit;

namespace {

constexpr int D = 768;          // model width
constexpr int DX_ROWS = 64;     // rows of a dx block (one dγ/dβ partial)
constexpr int SEG_STEP = 32;    // weight-GEMM segments are multiples of it

// dh: 128 tokens × 64 inner columns; dact = dO · W2ᵀ (W2 is (I, D):
// index-major B), then h = y · W1 (k-major B, two B operands: the val and
// gate columns); 8 warps of 32 × 32 per product: 96 accumulators a lane,
// one block per SM
constexpr int DH_TOKENS = 128, DH_COLS = 64, DH_BK = 64, DH_STAGES = 4;
constexpr int DH_WM = 4, DH_WN = 2, DH_BLOCKS = 1;
using DactCfg = GemmCfg<DH_TOKENS, DH_COLS, DH_BK, DH_WM, DH_WN, DH_STAGES,
                        false, false, 1>;
using HCfg = GemmCfg<DH_TOKENS, DH_COLS, DH_BK, DH_WM, DH_WN, DH_STAGES,
                     false, true, 2>;
constexpr int DH_SMEM = DactCfg::SMEM_BYTES > HCfg::SMEM_BYTES
                            ? DactCfg::SMEM_BYTES : HCfg::SMEM_BYTES;
static_assert(DactCfg::MT == HCfg::MT && DactCfg::NT == HCfg::NT,
              "dact, val and gate share the lanes' accumulator layout");
// dy = dh · W1ᵀ (W1 is (D, 2I): index-major B); 8 warps of 64 × 32
constexpr int DY_TOKENS = 128, DY_COLS = 128, DY_BK = 64, DY_STAGES = 3;
constexpr int DY_WM = 2, DY_WN = 4, DY_BLOCKS = 2;
using DyCfg = GemmCfg<DY_TOKENS, DY_COLS, DY_BK, DY_WM, DY_WN, DY_STAGES,
                      false, false, 1>;
// dW = Aᵀ B over tokens, both token-major: k-major A and B; 8 warps of
// 64 × 32
constexpr int WG_P = 128, WG_Q = 128, WG_BK = 32, WG_STAGES = 4;
constexpr int WG_WM = 2, WG_WN = 4, WG_BLOCKS = 2;
using WgCfg = GemmCfg<WG_P, WG_Q, WG_BK, WG_WM, WG_WN, WG_STAGES, true, true,
                      1>;

// y = bf16((x − μ)·inv·γ + β), 8 elements per thread
__global__ void __launch_bounds__(256)
geglu_bwd_y_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ y,
                   int M) {
    const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
    if (e >= (long long)M * (D / 8)) return;
    const int r = (int)(e / (D / 8)), c = (int)(e % (D / 8)) * 8;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + (size_t)r * D + c);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    const float m = mu[r], iv = inv[r];
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int j = c + 2 * i;
        o[i] = pack_bf16(
            (__bfloat162float(xs[2 * i]) - m) * iv * gamma[j] + beta[j],
            (__bfloat162float(xs[2 * i + 1]) - m) * iv * gamma[j + 1] +
                beta[j + 1]);
    }
    *reinterpret_cast<uint4*>(y + (size_t)r * D + c) = out;
}

// dh and act for 128 tokens × 64 inner columns; grid (I / 64, tokens / 128)
__global__ void __launch_bounds__(DactCfg::THREADS, DH_BLOCKS)
geglu_bwd_dh_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                    const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                    bf16* __restrict__ dh, bf16* __restrict__ act, int M,
                    int inner) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    const int n0 = blockIdx.x * DH_COLS, m0 = blockIdx.y * DH_TOKENS;

    float da[1][DactCfg::MT][DactCfg::NT][4];
    float h[2][HCfg::MT][HCfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < HCfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                da[0][mt][nt][e] = h[0][mt][nt][e] = h[1][mt][nt][e] = 0.f;

    const Mat w2t[1] = {{w2, D, inner, D}};
    gemm_mainloop<DactCfg>(da, Mat{dout, D, M, D}, w2t, m0, n0, 0, D, smem);
    const Mat w1vg[2] = {{w1, 2 * inner, D, inner},
                         {w1 + inner, 2 * inner, D, inner}};
    gemm_mainloop<HCfg>(h, Mat{y, D, M, D}, w1vg, m0, n0, 0, D, smem);

    // the GEGLU derivative on the accumulators: lane-local (row, column)
#pragma unroll
    for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < HCfg::NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + acc_row<HCfg>(mt, 2 * half);
                const int col = n0 + acc_col<HCfg>(nt, 0);
                if (row >= M || col >= inner) continue;   // inner % 8 == 0
                float dv[2], dg[2], ac[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float val = h[0][mt][nt][2 * half + e];
                    const float g = h[1][mt][nt][2 * half + e];
                    const float d = da[0][mt][nt][2 * half + e];
                    const float cdf = 0.5f * (1.f + erff(g * 0.70710678118654752f));
                    const float gelu = g * cdf;
                    const float pdf = expf(-0.5f * g * g) * 0.3989422804014327f;
                    dv[e] = d * gelu;
                    dg[e] = d * val * (cdf + g * pdf);
                    ac[e] = gelu * val;
                }
                bf16* dhr = dh + (size_t)row * (2 * inner);
                store_bf16x2(dhr + col, dv[0], dv[1]);
                store_bf16x2(dhr + inner + col, dg[0], dg[1]);
                store_bf16x2(act + (size_t)row * inner + col, ac[0], ac[1]);
            }
}

// dy = dh · W1ᵀ in fp32; grid (768 / DY_COLS, tokens / DY_TOKENS)
__global__ void __launch_bounds__(DyCfg::THREADS, DY_BLOCKS)
geglu_bwd_dy_kernel(const bf16* __restrict__ dh, const bf16* __restrict__ w1,
                    float* __restrict__ dy, int M, int I2) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * DY_COLS, m0 = blockIdx.y * DY_TOKENS;
    float acc[1][DyCfg::MT][DyCfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < DyCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < DyCfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mt][nt][e] = 0.f;
    const Mat w1m[1] = {{w1, I2, D, I2}};
    gemm_mainloop<DyCfg>(acc, Mat{dh, I2, M, I2}, w1m, m0, n0, 0, I2,
                         reinterpret_cast<bf16*>(smem_raw));
#pragma unroll
    for (int mt = 0; mt < DyCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < DyCfg::NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + acc_row<DyCfg>(mt, 2 * half);
                if (row >= M) continue;
                *reinterpret_cast<float2*>(
                    dy + (size_t)row * D + n0 + acc_col<DyCfg>(nt, 0)) =
                    make_float2(acc[0][mt][nt][2 * half],
                                acc[0][mt][nt][2 * half + 1]);
            }
}

// dx and the dγ/dβ partials of 64 rows; one warp per row, lane l holds
// columns 8(l + 32i) .. + 7, i < 3
__global__ void __launch_bounds__(256)
geglu_bwd_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ inv,
                    const float* __restrict__ gamma,
                    const float* __restrict__ dy, bf16* __restrict__ dx,
                    float* __restrict__ dgp, float* __restrict__ dbp, int M) {
    constexpr int CH = D / 256;   // 8-column chunks per lane
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r0 = blockIdx.x * DX_ROWS, r_end = min(M, r0 + DX_ROWS);
    for (int r = r0 + warp; r < r_end; r += 8) {
        const float m = mu[r], iv = inv[r];
        float xn[CH][8], dxn[CH][8];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            const int c = 8 * (lane + 32 * i);
            const uint4 xv = *reinterpret_cast<const uint4*>(x + (size_t)r * D + c);
            const bf16* xs = reinterpret_cast<const bf16*>(&xv);
            const float4* dyr = reinterpret_cast<const float4*>(dy + (size_t)r * D + c);
            const float4* gr = reinterpret_cast<const float4*>(gamma + c);
            const float4 d4[2] = {dyr[0], dyr[1]}, g4[2] = {gr[0], gr[1]};
            const float* dys = reinterpret_cast<const float*>(d4);
            const float* gs = reinterpret_cast<const float*>(g4);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                xn[i][j] = (__bfloat162float(xs[j]) - m) * iv;
                dxn[i][j] = dys[j] * gs[j];
                s1 += dxn[i][j];
                s2 += dxn[i][j] * xn[i][j];
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        s1 /= D;
        s2 /= D;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            uint4 out;
            uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                o[j] = pack_bf16(
                    iv * (dxn[i][2 * j] - s1 - xn[i][2 * j] * s2),
                    iv * (dxn[i][2 * j + 1] - s1 - xn[i][2 * j + 1] * s2));
            *reinterpret_cast<uint4*>(dx + (size_t)r * D + 8 * (lane + 32 * i)) =
                out;
        }
    }
    // partial sums of dγ = Σ dy·x̂ and dβ = Σ dy over the block's rows
    for (int c = tid; c < D; c += 256) {
        float sg = 0.f, sb = 0.f;
        for (int r = r0; r < r_end; ++r) {
            const float xn = (__bfloat162float(x[(size_t)r * D + c]) - mu[r]) * inv[r];
            const float d = dy[(size_t)r * D + c];
            sg += d * xn;
            sb += d;
        }
        dgp[(size_t)blockIdx.x * D + c] = sg;
        dbp[(size_t)blockIdx.x * D + c] = sb;
    }
}

// part[s] = A[seg s]ᵀ B[seg s] with A (M, P), B (M, Q) bf16 row-major (row
// pitches lda, ldb) and part (S, P, Q) fp32; grid (Q / WG_Q, P / WG_P, S)
__global__ void __launch_bounds__(WgCfg::THREADS, WG_BLOCKS)
wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             float* __restrict__ part, int M, int P, int Q, int lda, int ldb,
             int seg) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int q0 = blockIdx.x * WG_Q, p0 = blockIdx.y * WG_P;
    const int s = blockIdx.z, t0 = s * seg, t1 = min(M, t0 + seg);
    float acc[1][WgCfg::MT][WgCfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < WgCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WgCfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mt][nt][e] = 0.f;
    const Mat bm[1] = {{b, ldb, M, Q}};
    gemm_mainloop<WgCfg>(acc, Mat{a, lda, M, P}, bm, p0, q0, t0, t1,
                         reinterpret_cast<bf16*>(smem_raw));
    float* out = part + (size_t)s * P * Q;
#pragma unroll
    for (int mt = 0; mt < WgCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WgCfg::NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = p0 + acc_row<WgCfg>(mt, 2 * half);
                const int col = q0 + acc_col<WgCfg>(nt, 0);
                if (row >= P || col >= Q) continue;   // Q % 8 == 0
                *reinterpret_cast<float2*>(out + (size_t)row * Q + col) =
                    make_float2(acc[0][mt][nt][2 * half],
                                acc[0][mt][nt][2 * half + 1]);
            }
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

VIT_API int vit_geglu_bwd_y(const void* x, const void* mu, const void* inv,
                            const void* gamma, const void* beta, void* y,
                            int M, int Dm, void* stream) {
    if (Dm != D || M < 1) return (int)cudaErrorInvalidValue;
    const long long chunks = (long long)M * (D / 8);
    geglu_bwd_y_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)beta, (bf16*)y, M);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_bwd_dh(const void* y, const void* dout, const void* w1,
                             const void* w2, void* dh, void* act, int M,
                             int Dm, int I2, void* stream) {
    const int inner = I2 / 2;
    if (Dm != D || M < 1 || inner < 8 || inner % 8 || I2 % 2)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_bwd_dh_kernel, DH_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((inner + DH_COLS - 1) / DH_COLS, (M + DH_TOKENS - 1) / DH_TOKENS);
    geglu_bwd_dh_kernel<<<grid, DactCfg::THREADS, DH_SMEM,
                          (cudaStream_t)stream>>>(
        (const bf16*)y, (const bf16*)dout, (const bf16*)w1, (const bf16*)w2,
        (bf16*)dh, (bf16*)act, M, inner);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_bwd_dy(const void* dh, const void* w1, void* dy, int M,
                             int Dm, int I2, void* stream) {
    if (Dm != D || M < 1 || I2 < 8 || I2 % 8) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_bwd_dy_kernel, DyCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((D + DY_COLS - 1) / DY_COLS, (M + DY_TOKENS - 1) / DY_TOKENS);
    geglu_bwd_dy_kernel<<<grid, DyCfg::THREADS, DyCfg::SMEM_BYTES,
                          (cudaStream_t)stream>>>(
        (const bf16*)dh, (const bf16*)w1, (float*)dy, M, I2);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_bwd_dx(const void* x, const void* mu, const void* inv,
                             const void* gamma, const void* dy, void* dx,
                             void* dgp, void* dbp, int M, int Dm,
                             void* stream) {
    if (Dm != D || M < 1) return (int)cudaErrorInvalidValue;
    geglu_bwd_dx_kernel<<<(M + DX_ROWS - 1) / DX_ROWS, 256, 0,
                          (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)dy, (bf16*)dx, (float*)dgp,
        (float*)dbp, M);
    return (int)cudaGetLastError();
}

VIT_API int vit_wgrad(const void* a, const void* b, void* part, int M, int P,
                      int Q, int lda, int ldb, int S, int seg, void* stream) {
    if (M < 1 || P < 8 || Q < 8 || P % 8 || Q % 8 || lda % 8 || ldb % 8 ||
        seg % SEG_STEP || seg < SEG_STEP || (long long)(S - 1) * seg >= M ||
        (long long)S * seg < M)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(wgrad_kernel, WgCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Q + WG_Q - 1) / WG_Q, (P + WG_P - 1) / WG_P, S);
    wgrad_kernel<<<grid, WgCfg::THREADS, WgCfg::SMEM_BYTES,
                   (cudaStream_t)stream>>>(
        (const bf16*)a, (const bf16*)b, (float*)part, M, P, Q, lda, ldb, seg);
    return (int)cudaGetLastError();
}

VIT_API int vit_sum_rows(const void* part, void* out, int S, long long N,
                         void* stream) {
    sum_rows_kernel<<<(unsigned)((N + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)out, S, N);
    return (int)cudaGetLastError();
}
