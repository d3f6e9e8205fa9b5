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
// ops/geglu_ff.py; the two products run on the mma.sync mainloop of
// gemm_mma.cuh (a cp.async ring, ldmatrix/.trans, fp32 accumulators in
// registers):
//   geglu_ff_x_kernel: x̂ in bf16 (M × D), a row pass, bytes bound.
//   geglu_ff_h_kernel: per tile of 128 tokens × 64 inner columns c,
//     val = x̂·W1'[:, c] and gate = x̂·W1'[:, I + c] (one A tile, two
//     k-major B tiles per step), so val and gate of one (token, column)
//     sit in one lane and the GEGLU runs on the accumulators (started at
//     d1): both rounded to bf16, gelu_erf of gate rounded, times val,
//     rounded.  It writes act in bf16 (M × I); h (453 MB at 55,296 tokens)
//     never leaves the chip.  The grid runs the column tiles of one token tile together,
//     so x̂ comes from device memory once and W1' stays in L2.
//   geglu_ff_o_kernel: out = act·W2 (K = I, N = D; W2 is (I, D): a k-major
//     B) in 128 × 128 tiles, rounded to bf16.
// What bounds it: 522 GFLOP at 55,296 tokens, D 768, 2I 4096 (0.528 ms at
// the bf16 tensor-core peak); act costs 226 MB written and read again
// (≈ 0.135 ms at 3.35 TB/s), the price of a design that fits the card.
// Both GEMMs hold 64 accumulators a lane at two blocks of 8 warps per SM.
// No atomics: two launches on the same inputs give the same bits.  Any M;
// D and 2I multiples of 16 (rows of 16-byte pieces; the mainloop masks the
// tails of its tiles, the epilogues their columns).
#include "gemm_mma.cuh"

using namespace vit;

namespace {

// act: 128 tokens × 64 inner columns, two B operands (val, gate columns of
// W1', k-major); 8 warps of 32 × 32 per product
constexpr int H_TOKENS = 128, H_COLS = 64, H_BK = 64, H_STAGES = 3;
constexpr int H_WM = 4, H_WN = 2, H_BLOCKS = 2;
using HCfg = GemmCfg<H_TOKENS, H_COLS, H_BK, H_WM, H_WN, H_STAGES, false,
                     true, 2>;
// out: 128 tokens × 128 output columns; 8 warps of 64 × 32
constexpr int O_TOKENS = 128, O_COLS = 128, O_BK = 64, O_STAGES = 3;
constexpr int O_WM = 2, O_WN = 4, O_BLOCKS = 2;
using OCfg = GemmCfg<O_TOKENS, O_COLS, O_BK, O_WM, O_WN, O_STAGES, false,
                     true, 1>;

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

// act for 128 tokens × 64 inner columns; grid (I / 64, tokens / 128)
__global__ void __launch_bounds__(HCfg::THREADS, H_BLOCKS)
geglu_ff_h_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ w1,
                  const float* __restrict__ d1, bf16* __restrict__ act, int M,
                  int D, int inner) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * H_COLS, m0 = blockIdx.y * H_TOKENS;
    // h starts at d1 (val column c at d1[c], gate at d1[I + c]), so the
    // epilogue holds no d1 operands
    float h[2][HCfg::MT][HCfg::NT][4];
#pragma unroll
    for (int nt = 0; nt < HCfg::NT; ++nt) {
        const int col = n0 + acc_col<HCfg>(nt, 0);
        float2 dv = make_float2(0.f, 0.f), dg = dv;
        if (col < inner) {   // inner % 8 == 0
            dv = *reinterpret_cast<const float2*>(d1 + col);
            dg = *reinterpret_cast<const float2*>(d1 + inner + col);
        }
#pragma unroll
        for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                h[0][mt][nt][2 * half] = dv.x;
                h[0][mt][nt][2 * half + 1] = dv.y;
                h[1][mt][nt][2 * half] = dg.x;
                h[1][mt][nt][2 * half + 1] = dg.y;
            }
    }
    const Mat w1vg[2] = {{w1, 2 * inner, D, inner},
                         {w1 + inner, 2 * inner, D, inner}};
    gemm_mainloop<HCfg>(h, Mat{xn, D, M, D}, w1vg, m0, n0, 0, D,
                        reinterpret_cast<bf16*>(smem_raw));

    // val and gate rounded to bf16 (h's rounding point), each lane's
    // column pair packed in one register: 32 registers, not 64, are live
    // when the GELU's temporaries need theirs
    uint32_t hv[HCfg::MT][HCfg::NT][2], hg[HCfg::MT][HCfg::NT][2];
#pragma unroll
    for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < HCfg::NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                hv[mt][nt][half] = pack_bf16(h[0][mt][nt][2 * half],
                                             h[0][mt][nt][2 * half + 1]);
                hg[mt][nt][half] = pack_bf16(h[1][mt][nt][2 * half],
                                             h[1][mt][nt][2 * half + 1]);
            }
    // the GEGLU: lane-local (row, column)
#pragma unroll
    for (int mt = 0; mt < HCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < HCfg::NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + acc_row<HCfg>(mt, 2 * half);
                const int col = n0 + acc_col<HCfg>(nt, 0);
                if (row >= M || col >= inner) continue;
                const float2 val = bf16x2_to_float2(hv[mt][nt][half]);
                const float2 g = bf16x2_to_float2(hg[mt][nt][half]);
                store_bf16x2(act + (size_t)row * inner + col,
                             bf16_round(gelu_erf(g.x)) * val.x,
                             bf16_round(gelu_erf(g.y)) * val.y);
            }
}

// out = act · W2 in bf16; grid (D / 128, tokens / 128)
__global__ void __launch_bounds__(OCfg::THREADS, O_BLOCKS)
geglu_ff_o_kernel(const bf16* __restrict__ act, const bf16* __restrict__ w2,
                  bf16* __restrict__ out, int M, int D, int inner) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * O_COLS, m0 = blockIdx.y * O_TOKENS;
    float acc[1][OCfg::MT][OCfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < OCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < OCfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mt][nt][e] = 0.f;
    const Mat w2m[1] = {{w2, D, inner, D}};
    gemm_mainloop<OCfg>(acc, Mat{act, inner, M, inner}, w2m, m0, n0, 0, inner,
                        reinterpret_cast<bf16*>(smem_raw));
#pragma unroll
    for (int mt = 0; mt < OCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < OCfg::NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + acc_row<OCfg>(mt, 2 * half);
                const int col = n0 + acc_col<OCfg>(nt, 0);
                if (row >= M || col >= D) continue;   // D % 8 == 0
                store_bf16x2(out + (size_t)row * D + col,
                             acc[0][mt][nt][2 * half],
                             acc[0][mt][nt][2 * half + 1]);
            }
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
    cudaError_t e = allow_smem(geglu_ff_h_kernel, HCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((inner + H_COLS - 1) / H_COLS, (M + H_TOKENS - 1) / H_TOKENS);
    geglu_ff_h_kernel<<<grid, HCfg::THREADS, HCfg::SMEM_BYTES,
                        (cudaStream_t)stream>>>(
        (const bf16*)xn, (const bf16*)w1, (const float*)d1, (bf16*)act, M, D,
        inner);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_ff_o(const void* act, const void* w2, void* out, int M,
                           int D, int I2, void* stream) {
    if (!shapes_ok(M, D, I2)) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_ff_o_kernel, OCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((D + O_COLS - 1) / O_COLS, (M + O_TOKENS - 1) / O_TOKENS);
    geglu_ff_o_kernel<<<grid, OCfg::THREADS, OCfg::SMEM_BYTES,
                        (cudaStream_t)stream>>>(
        (const bf16*)act, (const bf16*)w2, (bf16*)out, M, D, I2 / 2);
    return (int)cudaGetLastError();
}
