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
// its plain twin in ops/geglu_ff.py; the products run on the mainloop of
// gemm_mma.cuh with int8 operands (mma.sync m16n8k32, int32 accumulators in
// registers, a cp.async ring).  ldmatrix has no .trans for 8-bit data, so
// both operands are index-major: the wrapper passes W1ᵀ (2I × D) and W2ᵀ
// (D × I).
//   geglu_int8_y_kernel: y → y8 (M × D) and s_y (M); a row pass, one warp
//     per token, bytes bound.
//   geglu_int8_h_kernel: per tile of 128 tokens × 64 inner columns c, val
//     = y8·W1ᵀ[c]ᵀ and gate = y8·W1ᵀ[I + c]ᵀ (one A tile, two B tiles per
//     step) in the same lanes; the epilogue converts, scales by s_y then
//     s_W1, takes the GELU and the product and writes act in fp32 (M × I),
//     and for each token the amax of its 64 columns: one partial per column
//     tile, (M, I / 64).  A max is order-free: no atomics, the same bits
//     from run to run.
//   geglu_int8_q_kernel: a row pass, one warp per token: s_a from the
//     token's partials, then a8 (M × I) from act, read once.
//   geglu_int8_o_kernel: out = a8·W2 with the epilogue ·s_a·s_W2 → bf16,
//     128 × 128 tiles.
// Both products hold 64 accumulators a lane at two blocks of 8 warps per
// SM.  act costs 453 MB written and read, a8 113 MB (≈ 0.2 ms at 3.35
// TB/s together).  Any M; D and 2I multiples of 64 (|y8·W1| ≤ D·127² stays
// below 2²⁴ up to D 1,040, so the conversion is exact there).
#include "gemm_mma.cuh"

using namespace vit;

namespace {

using s8 = signed char;

// act: 128 tokens × 64 inner columns (AMAX_TILE), two B operands (val and
// gate rows of W1ᵀ); 8 warps of 32 × 32 per product
constexpr int AMAX_TILE = 64;
constexpr int H_TOKENS = 128, H_BK = 128, H_STAGES = 3;
constexpr int H_WM = 4, H_WN = 2, H_BLOCKS = 2;
using HCfg = GemmCfg<H_TOKENS, AMAX_TILE, H_BK, H_WM, H_WN, H_STAGES, false,
                     false, 2, s8>;
// out: 128 tokens × 128 output columns; 8 warps of 64 × 32
constexpr int O_TOKENS = 128, O_COLS = 128, O_BK = 128, O_STAGES = 3;
constexpr int O_WM = 2, O_WN = 4, O_BLOCKS = 2;
using OCfg = GemmCfg<O_TOKENS, O_COLS, O_BK, O_WM, O_WN, O_STAGES, false,
                     false, 1, s8>;
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

// 8 codes of one scale, packed
__device__ __forceinline__ uint2 quant8x8(const float (&v)[8], float s) {
    uint2 out;
    s8* o = reinterpret_cast<s8*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = quant8(v[i], s);
    return out;
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

// act and its partial amax for 128 tokens × 64 inner columns; grid
// (I / 64, tokens / 128)
__global__ void __launch_bounds__(HCfg::THREADS, H_BLOCKS)
geglu_int8_h_kernel(const s8* __restrict__ y8, const float* __restrict__ sy,
                    const s8* __restrict__ w1t, const float* __restrict__ s1,
                    float* __restrict__ act, float* __restrict__ amax_part,
                    int M, int D, int inner) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * AMAX_TILE, m0 = blockIdx.y * H_TOKENS;
    int h[2][HCfg::MT][HCfg::NT][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < HCfg::NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) h[j][mt][nt][e] = 0;
    const Mat8 w1vg[2] = {{w1t, D, inner, D},
                          {w1t + (size_t)inner * D, D, inner, D}};
    gemm_mainloop<HCfg>(h, Mat8{y8, D, M, D}, w1vg, m0, n0, 0, D,
                        reinterpret_cast<s8*>(smem_raw));

    // the GEGLU on the accumulators, and each lane row's amax
    float amax[HCfg::MT][2];
#pragma unroll
    for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            amax[mt][half] = 0.f;
            const int row = m0 + acc_row<HCfg>(mt, 2 * half);
            if (row >= M) continue;
            const float s = sy[row];
#pragma unroll
            for (int nt = 0; nt < HCfg::NT; ++nt) {
                const int col = n0 + acc_col<HCfg>(nt, 0);
                if (col >= inner) continue;   // inner % 8 == 0
                float a[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float val = __fmul_rn(
                        __fmul_rn((float)h[0][mt][nt][2 * half + e], s),
                        s1[col + e]);
                    const float g = __fmul_rn(
                        __fmul_rn((float)h[1][mt][nt][2 * half + e], s),
                        s1[inner + col + e]);
                    const float gelu = __fmul_rn(
                        __fmul_rn(0.5f, g),
                        __fadd_rn(1.f,
                                  erff(__fmul_rn(g, 0.70710678118654752f))));
                    a[e] = __fmul_rn(gelu, val);
                    amax[mt][half] = fmaxf(amax[mt][half], fabsf(a[e]));
                }
                *reinterpret_cast<float2*>(act + (size_t)row * inner + col) =
                    make_float2(a[0], a[1]);
            }
        }
    // a row's amax over the lanes of its quad, then over the WN warps that
    // share it (through the drained ring)
    float* red = reinterpret_cast<float*>(smem_raw);   // [WN][128]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float v = amax[mt][half];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            if ((lane & 3) == 0)
                red[(warp % H_WN) * H_TOKENS + acc_row<HCfg>(mt, 2 * half)] =
                    v;
        }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < H_TOKENS && m0 + r < M) {
        float v = red[r];
#pragma unroll
        for (int w = 1; w < H_WN; ++w) v = fmaxf(v, red[w * H_TOKENS + r]);
        amax_part[(size_t)(m0 + r) * gridDim.x + blockIdx.x] = v;
    }
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

// out = bf16(a8·W2 · s_a · s_W2); grid (D / 128, tokens / 128)
__global__ void __launch_bounds__(OCfg::THREADS, O_BLOCKS)
geglu_int8_o_kernel(const s8* __restrict__ a8, const float* __restrict__ sa,
                    const s8* __restrict__ w2t, const float* __restrict__ s2,
                    bf16* __restrict__ out, int M, int D, int inner) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * O_COLS, m0 = blockIdx.y * O_TOKENS;
    int acc[1][OCfg::MT][OCfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < OCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < OCfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mt][nt][e] = 0;
    const Mat8 w2m[1] = {{w2t, inner, D, inner}};
    gemm_mainloop<OCfg>(acc, Mat8{a8, inner, M, inner}, w2m, m0, n0, 0,
                        inner, reinterpret_cast<s8*>(smem_raw));
#pragma unroll
    for (int mt = 0; mt < OCfg::MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = m0 + acc_row<OCfg>(mt, 2 * half);
            if (row >= M) continue;
            const float s = sa[row];
#pragma unroll
            for (int nt = 0; nt < OCfg::NT; ++nt) {
                const int col = n0 + acc_col<OCfg>(nt, 0);
                if (col >= D) continue;   // D % 8 == 0
                const int* c = acc[0][mt][nt] + 2 * half;
                store_bf16x2(out + (size_t)row * D + col,
                             __fmul_rn(__fmul_rn((float)c[0], s), s2[col]),
                             __fmul_rn(__fmul_rn((float)c[1], s), s2[col + 1]));
            }
        }
}

bool shapes_ok(int M, int D, int I2) {
    return M >= 1 && D >= 64 && D % 64 == 0 && I2 >= 64 && I2 % 64 == 0;
}

unsigned row_blocks(int M) {
    return (unsigned)((M + ROW_WARPS - 1) / ROW_WARPS);
}

}  // namespace

VIT_API int vit_geglu_int8_y(const void* x, const void* mu, const void* inv,
                             const void* gamma, const void* beta, void* y8,
                             void* sy, int M, int D, void* stream) {
    if (!shapes_ok(M, D, 64)) return (int)cudaErrorInvalidValue;
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
    cudaError_t e = allow_smem(geglu_int8_h_kernel, HCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((inner + AMAX_TILE - 1) / AMAX_TILE,
              (M + H_TOKENS - 1) / H_TOKENS);
    geglu_int8_h_kernel<<<grid, HCfg::THREADS, HCfg::SMEM_BYTES,
                          (cudaStream_t)stream>>>(
        (const s8*)y8, (const float*)sy, (const s8*)w1t, (const float*)s1,
        (float*)act, (float*)amax_part, M, D, inner);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_int8_q(const void* act, const void* amax_part, void* a8,
                             void* sa, int M, int I2, void* stream) {
    if (!shapes_ok(M, 64, I2)) return (int)cudaErrorInvalidValue;
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
    cudaError_t e = allow_smem(geglu_int8_o_kernel, OCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((D + O_COLS - 1) / O_COLS, (M + O_TOKENS - 1) / O_TOKENS);
    geglu_int8_o_kernel<<<grid, OCfg::THREADS, OCfg::SMEM_BYTES,
                          (cudaStream_t)stream>>>(
        (const s8*)a8, (const float*)sa, (const s8*)w2t, (const float*)s2,
        (bf16*)out, M, D, I2 / 2);
    return (int)cudaGetLastError();
}
