// K12/K13: W8A8 fused LayerNorm + q/k/v projection.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_fwd_int8_kernel (two outputs) and
// ::_fwd_int8_kernel_3out (three outputs): one route with three output
// pointers serves both.  K14: W8A8 projection without bias.  Replaces
// vit_exp_tpu/ops/fused_proj.py::_proj_int8_kernel.
//
// K12/K13 quantizes the CENTRED row x − μ per token (s_x = max|x − μ| /
// 127), multiplies by W = [γ⊙Wq | Wkv] quantized per column, and writes
// q = inv·deq to the first Fq columns and k/v = deq + μ·c (c: column sums
// of the dequantized Wkv) to the next Fk and the rest, where deq =
// acc·s_x·s_W (acc the int32 product).  Two kernels, each a stage with its
// plain twin in ops/fused_proj.py:
//   ln_qkv_int8_x_kernel: x, μ → x8 (M × K) and s_x (M); a row pass, one
//     warp per token, the row read once with 16-byte loads and held in
//     registers (K ≤ 2048), bytes bound.
//   ln_qkv_int8_mm_kernel: x8·W on the mainloop of gemm_mma.cuh with int8
//     operands (mma.sync m16n8k32, int32 accumulators in registers, a
//     cp.async ring), 128 tokens × 128 columns per block, 8 warps of 64 ×
//     32, 128-deep k steps; ldmatrix has no .trans for 8-bit data, so the
//     wrapper passes Wᵀ (F × K).  The epilogue dequantizes the accumulators
//     in place and writes q, k or v per column (Fq and Fq + Fk may fall
//     inside a column tile), two adjacent columns of one output as one
//     bf16x2.  No fused multiply-add: the twin rounds each product and sum.
// What bounds it at 55,296 tokens, K 768, F 768: 85 MB of x read and 85 MB
// of q, k, v written (0.051 ms at 3.35 TB/s), plus the 42 MB of x8 written
// and read again between the stages.  |x8·W| ≤ K·127² stays below 2²⁴ up to
// K 1,040, so the conversion to fp32 is exact there (above, it rounds once,
// as the twin's does).  Any M; K % 16 == 0, K ≤ 2048, F % 128 == 0.
//
// K14's kernel (w8a8_rows_kernel): one block of 8 warps owns 64 rows.  Its
// prologue quantizes them (x itself, two reads of each row) into shared
// memory in the k16 layout; the block then walks the output columns in
// tiles of 128: each warp sums a 32 x 32 sub-tile on the int8 tensor cores
// (weight fragments read in the k16 layout from L2, where the weights
// stay), stages it in shared memory and writes deq in bf16.  Bound at M =
// 55,296: 113 MB of x and out, not its 22 G int8 operations.  Needs
// K % 16 == 0, K <= 2048 and F % 128 == 0; rows past M are masked.
#include "gemm_mma.cuh"

using namespace vit;

namespace {

using s8 = signed char;

// ---------------------------------------------------------------------------
// K12/K13
// ---------------------------------------------------------------------------

constexpr int ROW_WARPS = 8;      // tokens per block of the row pass
constexpr int ROW_CHUNK = 256;    // columns of one 16-byte load per lane
constexpr int MAX_K = 2048;       // 8 chunks: 32 registers of a held row
constexpr int MM_TOKENS = 128, MM_COLS = 128, MM_BK = 128, MM_STAGES = 3;
constexpr int MM_WM = 2, MM_WN = 4, MM_BLOCKS = 2;
using MmCfg = GemmCfg<MM_TOKENS, MM_COLS, MM_BK, MM_WM, MM_WN, MM_STAGES,
                      false, false, 1, s8>;

// x8 and s_x; one warp per token, lane l holds columns 8(l + 32i) .. + 7
// for i < CHUNKS
template <int CHUNKS>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_qkv_int8_x_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                     s8* __restrict__ x8, float* __restrict__ sx, int M,
                     int K) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (r >= M) return;
    const bf16* xr = x + (size_t)r * K;
    const float m = mu[r];
    uint4 raw[CHUNKS];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
        const int c = 8 * lane + ROW_CHUNK * i;
        if (c >= K) continue;   // K % 8 == 0
        raw[i] = *reinterpret_cast<const uint4*>(xr + c);
        const bf16* xs = reinterpret_cast<const bf16*>(&raw[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            amax = fmaxf(amax,
                         fabsf(__fsub_rn(__bfloat162float(xs[j]), m)));
    }
    const float s = quant_scale(warp_max(amax));
    if (lane == 0) sx[r] = s;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
        const int c = 8 * lane + ROW_CHUNK * i;
        if (c >= K) continue;
        const bf16* xs = reinterpret_cast<const bf16*>(&raw[i]);
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            y[j] = __fsub_rn(__bfloat162float(xs[j]), m);
        *reinterpret_cast<uint2*>(x8 + (size_t)r * K + c) = quant8x8(y, s);
    }
}

// the output that column col lands in, as the address of its element in
// row 0 and that output's pitch: q, k or v
struct OutCol {
    bf16* p;
    int ld;
};
__device__ __forceinline__ OutCol qkv_col(bf16* q, bf16* k, bf16* v, int col,
                                          int Fq, int Fk, int Fv) {
    if (col < Fq) return {q + col, Fq};
    if (col < Fq + Fk) return {k + (col - Fq), Fk};
    return {v + (col - Fq - Fk), Fv};
}

// q = inv·deq, k/v = deq + μ·c with deq = (x8·W)·s_x·s_W; grid (F / 128,
// tokens / 128)
__global__ void __launch_bounds__(MmCfg::THREADS, MM_BLOCKS)
ln_qkv_int8_mm_kernel(const s8* __restrict__ x8, const float* __restrict__ sx,
                      const float* __restrict__ mu,
                      const float* __restrict__ inv,
                      const s8* __restrict__ wt, const float* __restrict__ sc,
                      const float* __restrict__ c, bf16* __restrict__ q,
                      bf16* __restrict__ k, bf16* __restrict__ v, int M,
                      int K, int F, int Fq, int Fk) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int n0 = blockIdx.x * MM_COLS, m0 = blockIdx.y * MM_TOKENS;
    int acc[1][MmCfg::MT][MmCfg::NT][4];
#pragma unroll
    for (int mt = 0; mt < MmCfg::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < MmCfg::NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mt][nt][e] = 0;
    const Mat8 wm[1] = {{wt, K, F, K}};
    gemm_mainloop<MmCfg>(acc, Mat8{x8, K, M, K}, wm, m0, n0, 0, K,
                         reinterpret_cast<s8*>(smem_raw));

    // s_x, μ and inv of the lane's rows, loaded once
    float rs[MmCfg::MT][2], rm[MmCfg::MT][2], ri[MmCfg::MT][2];
#pragma unroll
    for (int mt = 0; mt < MmCfg::MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = min(m0 + acc_row<MmCfg>(mt, 2 * half), M - 1);
            rs[mt][half] = sx[row];
            rm[mt][half] = mu[row];
            ri[mt][half] = inv[row];
        }
    // per column pair: its scales, colsums and outputs, then its rows
#pragma unroll
    for (int nt = 0; nt < MmCfg::NT; ++nt) {
        const int col = n0 + acc_col<MmCfg>(nt, 0);
        if (col >= F) continue;   // F % 8 == 0
        const float2 s2 = *reinterpret_cast<const float2*>(sc + col);
        const float2 c2 = *reinterpret_cast<const float2*>(c + col);
        const OutCol o0 = qkv_col(q, k, v, col, Fq, Fk, F - Fq - Fk);
        const OutCol o1 = qkv_col(q, k, v, col + 1, Fq, Fk, F - Fq - Fk);
        // one bf16x2 store a row when both columns lie in one output at an
        // even pitch from a 4-byte aligned start
        const bool pair = o1.p == o0.p + 1 && o1.ld == o0.ld &&
                          (o0.ld & 1) == 0 &&
                          (reinterpret_cast<size_t>(o0.p) & 3) == 0;
#pragma unroll
        for (int mt = 0; mt < MmCfg::MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + acc_row<MmCfg>(mt, 2 * half);
                if (row >= M) continue;
                const int* a = acc[0][mt][nt] + 2 * half;
                const float s = rs[mt][half], m = rm[mt][half];
                const float iv = ri[mt][half];
                const float d0 = __fmul_rn(__fmul_rn((float)a[0], s), s2.x);
                const float d1 = __fmul_rn(__fmul_rn((float)a[1], s), s2.y);
                const float y0 = col < Fq ? __fmul_rn(iv, d0)
                                          : __fadd_rn(d0, __fmul_rn(m, c2.x));
                const float y1 = col + 1 < Fq
                                     ? __fmul_rn(iv, d1)
                                     : __fadd_rn(d1, __fmul_rn(m, c2.y));
                bf16* p0 = o0.p + (size_t)row * o0.ld;
                if (pair) {
                    store_bf16x2(p0, y0, y1);
                } else {   // the pair straddles Fq or Fq + Fk, or is odd
                    *p0 = __float2bfloat16(y0);
                    o1.p[(size_t)row * o1.ld] = __float2bfloat16(y1);
                }
            }
    }
}

bool qkv_shapes_ok(int M, int K, int F) {
    return M >= 1 && K >= 16 && K % 16 == 0 && K <= MAX_K && F >= 128 &&
           F % 128 == 0;
}

template <int CHUNKS>
int launch_x(const void* x, const void* mu, void* x8, void* sx, int M, int K,
             void* stream) {
    ln_qkv_int8_x_kernel<CHUNKS>
        <<<(unsigned)((M + ROW_WARPS - 1) / ROW_WARPS), ROW_WARPS * 32, 0,
           (cudaStream_t)stream>>>((const bf16*)x, (const float*)mu, (s8*)x8,
                                   (float*)sx, M, K);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

constexpr int BM = 64;      // rows per block
constexpr int BN = 128;     // output columns per tile
constexpr int NW = 8;       // warps: 2 row halves x 4 column quarters
constexpr int LDST = 36;    // int pitch of a warp's 32 x 32 staging tile

__global__ void __launch_bounds__(NW * 32)
w8a8_rows_kernel(const bf16* __restrict__ x,
                 const signed char* __restrict__ w,
                 const float* __restrict__ sc, bf16* __restrict__ o0, int M,
                 int K, int F) {
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
        float amax = 0.f;
        if (live)
            for (int k = lane; k < K; k += 32)
                amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
        const float s = quant_scale(warp_max(amax));
        if (lane == 0) srow[r] = s;
        for (int k = lane; k < K; k += 32)
            A8[k16_index(r, k, BM)] =
                live ? quant8(__bfloat162float(xr[k]), s) : (signed char)0;
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
            o0[(size_t)gr * F + gc] = __float2bfloat16(deq);
        }
        __syncwarp();
    }
}

}  // namespace

VIT_API int vit_ln_qkv_int8_x(const void* x, const void* mu, void* x8,
                              void* sx, int M, int K, void* stream) {
    if (!qkv_shapes_ok(M, K, 128)) return (int)cudaErrorInvalidValue;
    switch ((K + ROW_CHUNK - 1) / ROW_CHUNK) {
        case 1: return launch_x<1>(x, mu, x8, sx, M, K, stream);
        case 2: return launch_x<2>(x, mu, x8, sx, M, K, stream);
        case 3: return launch_x<3>(x, mu, x8, sx, M, K, stream);
        case 4: return launch_x<4>(x, mu, x8, sx, M, K, stream);
        case 5: return launch_x<5>(x, mu, x8, sx, M, K, stream);
        case 6: return launch_x<6>(x, mu, x8, sx, M, K, stream);
        case 7: return launch_x<7>(x, mu, x8, sx, M, K, stream);
        default: return launch_x<8>(x, mu, x8, sx, M, K, stream);
    }
}

VIT_API int vit_ln_qkv_int8_mm(const void* x8, const void* sx, const void* mu,
                               const void* inv, const void* wt, const void* sc,
                               const void* c, void* q, void* k, void* v, int M,
                               int K, int F, int Fq, int Fk, void* stream) {
    if (!qkv_shapes_ok(M, K, F) || Fq < 1 || Fk < 1 || Fq + Fk >= F)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(ln_qkv_int8_mm_kernel, MmCfg::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((F + MM_COLS - 1) / MM_COLS, (M + MM_TOKENS - 1) / MM_TOKENS);
    ln_qkv_int8_mm_kernel<<<grid, MmCfg::THREADS, MmCfg::SMEM_BYTES,
                            (cudaStream_t)stream>>>(
        (const s8*)x8, (const float*)sx, (const float*)mu, (const float*)inv,
        (const s8*)wt, (const float*)sc, (const float*)c, (bf16*)q, (bf16*)k,
        (bf16*)v, M, K, F, Fq, Fk);
    return (int)cudaGetLastError();
}

VIT_API int vit_proj_int8_fwd(const void* x, const void* w, const void* sc,
                              void* out, int M, int K, int F, void* stream) {
    if (K % 16 || K > 2048 || F % BN) return (int)cudaErrorInvalidValue;
    const int smem = BM * K + NW * 32 * LDST * 4 + BM * 4;
    cudaError_t e = cudaFuncSetAttribute(
        w8a8_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    w8a8_rows_kernel<<<(M + BM - 1) / BM, NW * 32, smem,
                       (cudaStream_t)stream>>>(
        (const bf16*)x, (const signed char*)w, (const float*)sc, (bf16*)out,
        M, K, F);
    return (int)cudaGetLastError();
}
