// K8: fused GEGLU feed-forward backward.  Replaces
// vit_exp_tpu/ops/geglu_ff.py::_ff_bwd_kernel.  The model width D is a
// runtime argument of every stage: a multiple of 16 up to DX_MAX_D (the
// dx row pass holds a row in registers); 2I a multiple of 16.
//
// With x̂ = (x − μ)·inv, y = bf16(x̂·γ + β), h = y@W1 (fp32, [val | gate]):
//   dact = dO@W2ᵀ;  dval = dact·gelu(gate);  dgate = dact·val·gelu'(gate)
//   with gelu'(g) = Φ(g) + g·φ(g);  dh = bf16([dval | dgate]);
//   act = bf16(gelu(gate)·val);  dy = dh@W1ᵀ (fp32);
//   dW1 = yᵀ dh,  dW2 = actᵀ dO,  dγ = Σ dy·x̂,  dβ = Σ dy,
//   dx = inv·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)) with dx̂ = dy·γ.
//
// The TPU kernel accumulates dW1 (D × 2I) and dW2 (I × D) in
// fp32 VMEM (19 MB at D 768, 2I 4096) over a grid that runs in order.  A
// Hopper block has 227 KB of shared memory, blocks run in no order, and
// the fp32 sums of dy (tokens × D) and dW do not fit on chip, so the work
// is a chain of tensor-core GEMMs with fused epilogues on the wgmma
// mainloop of gemm_wgmma.cuh (TMA loads by a producer warp into an
// mbarrier ring, two consumer warpgroups on wgmma, fp32 accumulators in
// registers, a persistent grid of one block per SM):
// - token phase (per token: 3·D·I + D·2I multiply-adds, 870 GFLOP at
//   55,296 tokens, D 768, 2I 4096, tensor-core bound):
//   geglu_bwd_y_kernel: y = bf16(x̂·γ + β) once (the weight phase needs it
//     too).  Bytes bound.
//   geglu_bwd_dh_kernel: per tile of 128 tokens × 64 inner columns c, two
//     mainloops in sequence on one ring: dact = dO·W2[c, :]ᵀ (W2 is (I,
//     D): an index-major B), then val = y·W1[:, c] and gate = y·W1[:, I + c]
//     (two k-major B tiles side by side, one wgmma of N 128), all three in
//     the same lanes' registers, so the GEGLU derivative (erf, exp, two
//     products) runs on the accumulators and the epilogue writes dh and act
//     in bf16 through a swizzled staging tile and TMA stores.  The tiles
//     run column tile fastest, so y and dO come from
//     device memory once and W1, W2 (9.4 MB) stay in L2.
//   geglu_bwd_dy_kernel: dy = dh·W1ᵀ (K = 2I, N = D; W1 is (D, 2I): an
//     index-major B) in 128 × 256 tiles, written in fp32.
//   geglu_bwd_dx_kernel<CH>: a row pass, one warp per row, CH 8-column
//     chunks a lane (CH = ceil(D / 256), one instance each up to
//     DX_MAX_D / 256): the LayerNorm row sums, dx, and per-block partial
//     sums of dγ and dβ over 64 rows.
// - weight phase (522 GFLOP): wgrad_kernel, dW = Aᵀ B over tokens (A and
//   B token-major: both k-major, read through wgmma's transpose bits) in
//   128 × 256 tiles, split into token segments of whole k steps (the plan
//   is ops/geglu_ff.py::wgrad_plan); each segment writes an fp32 partial
//   and sum_rows_kernel adds the partials in a fixed order, as it does the
//   dγ/dβ partials.
// dh holds 96 accumulators a consumer thread, dy and the weight GEMM 128.
// What bounds each product stage: its tensor-core operations (dh 522,
// dy 348, the weight GEMMs 522 GFLOP at D 768, 2I 4096).
// No atomics: two launches on the same inputs give the same bits.  The
// intermediates (y, dh, act: 0.68 GB at 55,296 tokens and D 768, and dy
// in fp32, 0.17 GB) pass through device memory: ≈ 0.5 ms of the 3.35 TB/s.
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

constexpr int DX_ROWS = 64;     // rows of a dx block (one dγ/dβ partial)
constexpr int SEG_STEP = STEP_K;   // weight-GEMM segments are whole k steps
constexpr int D_STEP = 16;      // D is a multiple of it
constexpr int DX_MAX_CH = 8;    // 8-column chunks a lane holds in dx
constexpr int DX_MAX_D = 256 * DX_MAX_CH;

// dh: 128 tokens × 64 inner columns; dact = dO · W2ᵀ (index-major B),
// then h = y · W1 ([val | gate], k-major B tiles): 32 + 64 accumulators;
// dh (its val and gate halves) leaves first through a staging of 64 × 128
// a consumer, then act.  (128 columns ran 10% faster in a trial, but its
// 192 accumulators spill at 232 and 240 registers.)
constexpr int DH_COLS = 64, DH_STAGES = 6;
constexpr int DH_PRODUCER_REGS = 24, DH_CONSUMER_REGS = 240;
using DactGemm = WgGemm<DH_COLS, 1, false, false>;
using HGemm = WgGemm<DH_COLS, 2, false, true>;
using DhOut = Staging<2 * DH_COLS / 64>;
using DhRing = Ring<DH_STAGES, HGemm::STAGE_BYTES, 2 * DhOut::BYTES>;
// dy = dh · W1ᵀ (index-major B): 128 tokens × 256 columns
constexpr int DY_COLS = 256, DY_STAGES = 4;
using DyGemm = WgGemm<DY_COLS, 1, false, false>;
using DyRing = Ring<DY_STAGES, DyGemm::STAGE_BYTES>;
// dW = Aᵀ B over tokens, both token-major (k-major): 128 × 256 tiles
constexpr int WG_P = TILE_M, WG_Q = 256, WG_STAGES = 4;
using WgradGemm = WgGemm<WG_Q, 1, true, true>;
using WgRing = Ring<WG_STAGES, WgradGemm::STAGE_BYTES>;

// y = bf16((x − μ)·inv·γ + β), 8 elements per thread
__global__ void __launch_bounds__(256)
geglu_bwd_y_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ inv,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ y,
                   int M, int D) {
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
    for (int i = 0; i < 4; ++i) {
        const int j = c + 2 * i;
        o[i] = pack_bf16(
            (__bfloat162float(xs[2 * i]) - m) * iv * gamma[j] + beta[j],
            (__bfloat162float(xs[2 * i + 1]) - m) * iv * gamma[j + 1] +
                beta[j + 1]);
    }
    *reinterpret_cast<uint4*>(y + (size_t)r * D + c) = out;
}

// dh and act for tiles of 128 tokens × 64 inner columns, column tile
// fastest
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_bwd_dh_kernel(const __grid_constant__ CUtensorMap y_map,
                    const __grid_constant__ CUtensorMap dout_map,
                    const __grid_constant__ CUtensorMap val_map,
                    const __grid_constant__ CUtensorMap gate_map,
                    const __grid_constant__ CUtensorMap w2_map,
                    const __grid_constant__ CUtensorMap dhv_map,
                    const __grid_constant__ CUtensorMap dhg_map,
                    const __grid_constant__ CUtensorMap act_map, int M, int D,
                    int inner) {
    extern __shared__ unsigned char smem_raw[];
    DhRing ring(smem_raw);
    ring.init();
    const int col_tiles = (inner + DH_COLS - 1) / DH_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs<DH_PRODUCER_REGS, DH_CONSUMER_REGS>();
        if (threadIdx.x == 0) {
            const CUtensorMap* const w2t[1] = {&w2_map};
            const CUtensorMap* const vg[2] = {&val_map, &gate_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int m0 = t / col_tiles * TILE_M;
                const int n0 = t % col_tiles * DH_COLS;
                const int n1[1] = {n0}, n2[2] = {n0, n0};
                produce<DactGemm>(ring, &dout_map, m0, w2t, n1, 0, D);
                produce<HGemm>(ring, &y_map, m0, vg, n2, 0, D);
            }
        }
        return;
    }
    consumer_regs<DH_PRODUCER_REGS, DH_CONSUMER_REGS>();
    constexpr int G0 = DH_COLS / 8;   // the first n8 tile of the gate columns
    const DhOut out(ring.extra());
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * DH_COLS;
        float da[DactGemm::N / 8][4], h[HGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < G0; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                da[j][e] = h[j][e] = h[G0 + j][e] = 0.f;
        consume<DactGemm>(ring, da, 0, D);
        consume<HGemm>(ring, h, 0, D);

        // the GEGLU derivative on the accumulators, lane-local (row,
        // column): dh's val and gate halves go to the staging at once, act
        // waits as bf16 pairs and follows; rows and columns past M and I
        // are dropped by the stores
        constexpr int C = DH_COLS / 64;   // chunks of one output
        uint32_t act_pairs[G0][2];
        out.acquire();
#pragma unroll
        for (int j = 0; j < G0; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                float dv[2], dg[2], ac[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float val = h[j][2 * half + e];
                    const float g = h[G0 + j][2 * half + e];
                    const float d = da[j][2 * half + e];
                    const float cdf = 0.5f * (1.f + erff(g * 0.70710678118654752f));
                    const float gelu = g * cdf;
                    const float pdf = expf(-0.5f * g * g) * 0.3989422804014327f;
                    dv[e] = d * gelu;
                    dg[e] = d * val * (cdf + g * pdf);
                    ac[e] = gelu * val;
                }
                const int col = wg_col(j, 0), row = wg_row(2 * half);
                out.put(col >> 6, row, col & 63, pack_bf16(dv[0], dv[1]));
                out.put(C + (col >> 6), row, col & 63, pack_bf16(dg[0], dg[1]));
                act_pairs[j][half] = pack_bf16(ac[0], ac[1]);
            }
        const CUtensorMap* dh_maps[2 * C];
        int cols[2 * C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            dh_maps[c] = &dhv_map;
            dh_maps[C + c] = &dhg_map;
            cols[c] = cols[C + c] = n0 + 64 * c;
        }
        out.release(dh_maps, cols, m0);
        out.acquire();
#pragma unroll
        for (int j = 0; j < G0; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int col = wg_col(j, 0);
                out.put(col >> 6, wg_row(2 * half), col & 63,
                        act_pairs[j][half]);
            }
        const CUtensorMap* act_maps[C];
        int act_cols[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            act_maps[c] = &act_map;
            act_cols[c] = n0 + 64 * c;
        }
        out.release(act_maps, act_cols, m0);
    }
    out.drain();
}

// dy = dh · W1ᵀ in fp32 for tiles of 128 tokens × 256 columns
__global__ void __launch_bounds__(GEMM_THREADS, 1)
geglu_bwd_dy_kernel(const __grid_constant__ CUtensorMap dh_map,
                    const __grid_constant__ CUtensorMap w1_map,
                    float* __restrict__ dy, int M, int D, int I2) {
    extern __shared__ unsigned char smem_raw[];
    DyRing ring(smem_raw);
    ring.init();
    const int col_tiles = (D + DY_COLS - 1) / DY_COLS;
    const int tiles = (M + TILE_M - 1) / TILE_M * col_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[1] = {&w1_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int b_n0[1] = {t % col_tiles * DY_COLS};
                produce<DyGemm>(ring, &dh_map, t / col_tiles * TILE_M, b,
                                b_n0, 0, I2);
            }
        }
        return;
    }
    consumer_regs();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + consumer_row0();
        const int n0 = t % col_tiles * DY_COLS;
        float acc[DyGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < DyGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        consume<DyGemm>(ring, acc, 0, I2);
#pragma unroll
        for (int j = 0; j < DyGemm::N / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wg_row(2 * half);
                const int col = n0 + wg_col(j, 0);
                if (row >= M || col >= D) continue;   // D % 8 == 0
                *reinterpret_cast<float2*>(dy + (size_t)row * D + col) =
                    make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
            }
    }
}

// dx and the dγ/dβ partials of 64 rows; one warp per row, lane l holds
// columns 8(l + 32i) .. + 7 for i < CH where they lie below D (CH =
// ceil(D / 256); a chunk past D holds zeros and adds nothing to the sums)
template <int CH>
__global__ void __launch_bounds__(256)
geglu_bwd_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ inv,
                    const float* __restrict__ gamma,
                    const float* __restrict__ dy, bf16* __restrict__ dx,
                    float* __restrict__ dgp, float* __restrict__ dbp, int M,
                    int D) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r0 = blockIdx.x * DX_ROWS, r_end = min(M, r0 + DX_ROWS);
    for (int r = r0 + warp; r < r_end; r += 8) {
        const float m = mu[r], iv = inv[r];
        float xn[CH][8], dxn[CH][8];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            const int c = 8 * (lane + 32 * i);
            if (c >= D) {
#pragma unroll
                for (int j = 0; j < 8; ++j) xn[i][j] = dxn[i][j] = 0.f;
                continue;
            }
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
            if (8 * (lane + 32 * i) >= D) continue;
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

// part[s] = A[seg s]ᵀ B[seg s] with A (M, P), B (M, Q) bf16 row-major
// (read through a_map, b_map) and part (S, P, Q) fp32, for tiles of 128 ×
// 256 outputs of one segment, segment slowest, column tile fastest
__global__ void __launch_bounds__(GEMM_THREADS, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap a_map,
             const __grid_constant__ CUtensorMap b_map,
             float* __restrict__ part, int M, int P, int Q, int S, int seg) {
    extern __shared__ unsigned char smem_raw[];
    WgRing ring(smem_raw);
    ring.init();
    const int q_tiles = (Q + WG_Q - 1) / WG_Q;
    const int seg_tiles = (P + WG_P - 1) / WG_P * q_tiles;
    const int tiles = S * seg_tiles;
    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs();
        if (threadIdx.x == 0) {
            const CUtensorMap* const b[1] = {&b_map};
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int s = t / seg_tiles, r = t % seg_tiles;
                const int b_n0[1] = {r % q_tiles * WG_Q};
                produce<WgradGemm>(ring, &a_map, r / q_tiles * WG_P, b, b_n0,
                                   s * seg, min(M, (s + 1) * seg));
            }
        }
        return;
    }
    consumer_regs();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int s = t / seg_tiles, r = t % seg_tiles;
        const int p0 = r / q_tiles * WG_P + consumer_row0();
        const int q0 = r % q_tiles * WG_Q;
        float acc[WgradGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < WgradGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        consume<WgradGemm>(ring, acc, s * seg, min(M, (s + 1) * seg));
        float* out = part + (size_t)s * P * Q;
#pragma unroll
        for (int j = 0; j < WgradGemm::N / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = p0 + wg_row(2 * half);
                const int col = q0 + wg_col(j, 0);
                if (row >= P || col >= Q) continue;   // Q % 8 == 0
                *reinterpret_cast<float2*>(out + (size_t)row * Q + col) =
                    make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
            }
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

namespace {

bool width_ok(int D) { return D >= D_STEP && D % D_STEP == 0; }

template <int CH>
void launch_dx(const void* x, const void* mu, const void* inv,
               const void* gamma, const void* dy, void* dx, void* dgp,
               void* dbp, int M, int D, cudaStream_t stream) {
    geglu_bwd_dx_kernel<CH><<<(M + DX_ROWS - 1) / DX_ROWS, 256, 0, stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)dy, (bf16*)dx, (float*)dgp,
        (float*)dbp, M, D);
}

}  // namespace

VIT_API int vit_geglu_bwd_y(const void* x, const void* mu, const void* inv,
                            const void* gamma, const void* beta, void* y,
                            int M, int D, void* stream) {
    if (!width_ok(D) || M < 1) return (int)cudaErrorInvalidValue;
    const long long chunks = (long long)M * (D / 8);
    geglu_bwd_y_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)mu, (const float*)inv,
        (const float*)gamma, (const float*)beta, (bf16*)y, M, D);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_bwd_dh(const void* y, const void* dout, const void* w1,
                             const void* w2, void* dh, void* act, int M,
                             int D, int I2, void* stream) {
    const int inner = I2 / 2;
    if (!width_ok(D) || M < 1 || inner < 8 || inner % 8 || I2 % 2)
        return (int)cudaErrorInvalidValue;
    // y and dO index-major; W2 (I, D) index-major; the val and gate
    // columns of W1 (D, 2I) k-major; out: dh's val and gate halves (M × I
    // each, pitch 2I) and act in boxes of 64 × 64
    CUtensorMap y_map, dout_map, val_map, gate_map, w2_map, dhv_map, dhg_map,
        act_map;
    if (!tma_map(&y_map, y, M, D, D, TILE_M) ||
        !tma_map(&dout_map, dout, M, D, D, TILE_M) ||
        !tma_map(&val_map, w1, D, inner, I2, 64) ||
        !tma_map(&gate_map, (const bf16*)w1 + inner, D, inner, I2, 64) ||
        !tma_map(&w2_map, w2, inner, D, D, DH_COLS) ||
        !tma_map(&dhv_map, dh, M, inner, I2, 64) ||
        !tma_map(&dhg_map, (const bf16*)dh + inner, M, inner, I2, 64) ||
        !tma_map(&act_map, act, M, inner, inner, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_bwd_dh_kernel, DhRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((inner + DH_COLS - 1) / DH_COLS);
    geglu_bwd_dh_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                          DhRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        y_map, dout_map, val_map, gate_map, w2_map, dhv_map, dhg_map, act_map,
        M, D, inner);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_bwd_dy(const void* dh, const void* w1, void* dy, int M,
                             int D, int I2, void* stream) {
    if (!width_ok(D) || M < 1 || I2 < 8 || I2 % 8)
        return (int)cudaErrorInvalidValue;
    // dh and W1 (D, 2I) index-major
    CUtensorMap dh_map, w1_map;
    if (!tma_map(&dh_map, dh, M, I2, I2, TILE_M) ||
        !tma_map(&w1_map, w1, D, I2, I2, DY_COLS))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(geglu_bwd_dy_kernel, DyRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((M + TILE_M - 1) / TILE_M) *
                            ((D + DY_COLS - 1) / DY_COLS);
    geglu_bwd_dy_kernel<<<persistent_blocks(tiles), GEMM_THREADS,
                          DyRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        dh_map, w1_map, (float*)dy, M, D, I2);
    return (int)cudaGetLastError();
}

VIT_API int vit_geglu_bwd_dx(const void* x, const void* mu, const void* inv,
                             const void* gamma, const void* dy, void* dx,
                             void* dgp, void* dbp, int M, int D,
                             void* stream) {
    if (!width_ok(D) || D > DX_MAX_D || M < 1)
        return (int)cudaErrorInvalidValue;
    auto s = (cudaStream_t)stream;
    switch ((D + 255) / 256) {   // 8-column chunks a lane
        case 1: launch_dx<1>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        case 2: launch_dx<2>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        case 3: launch_dx<3>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        case 4: launch_dx<4>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        case 5: launch_dx<5>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        case 6: launch_dx<6>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        case 7: launch_dx<7>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s); break;
        default: launch_dx<8>(x, mu, inv, gamma, dy, dx, dgp, dbp, M, D, s);
    }
    static_assert(DX_MAX_CH == 8, "one case per instance");
    return (int)cudaGetLastError();
}

VIT_API int vit_wgrad(const void* a, const void* b, void* part, int M, int P,
                      int Q, int lda, int ldb, int S, int seg, void* stream) {
    if (M < 1 || P < 8 || Q < 8 || P % 8 || Q % 8 || lda % 8 || ldb % 8 ||
        seg % SEG_STEP || seg < SEG_STEP || (long long)(S - 1) * seg >= M ||
        (long long)S * seg < M)
        return (int)cudaErrorInvalidValue;
    // A (M, P) and B (M, Q) token-major: k-major operands
    CUtensorMap a_map, b_map;
    if (!tma_map(&a_map, a, M, P, lda, 64) || !tma_map(&b_map, b, M, Q, ldb, 64))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(wgrad_kernel, WgRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)S * ((P + WG_P - 1) / WG_P) *
                            ((Q + WG_Q - 1) / WG_Q);
    wgrad_kernel<<<persistent_blocks(tiles), GEMM_THREADS, WgRing::SMEM_BYTES,
                   (cudaStream_t)stream>>>(a_map, b_map, (float*)part, M, P, Q,
                                           S, seg);
    return (int)cudaGetLastError();
}

VIT_API int vit_sum_rows(const void* part, void* out, int S, long long N,
                         void* stream) {
    sum_rows_kernel<<<(unsigned)((N + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)part, (float*)out, S, N);
    return (int)cudaGetLastError();
}
