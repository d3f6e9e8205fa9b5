// Static-max attention backward: dk/dv and dq.  Replaces
// vit_exp_tpu/ops/flash_attention.py::_bwd_fused_kernel (exact tiling) and
// ::_dq_kernel / ::_dkv_kernel (ragged kv).
//
// With lse = B + log l from the forward (flash_static.cu), for one
// (batch, head):  p = exp(q·k·scale − lse),  δ = rowsum(dO ⊙ O) (from the
// caller),  dV = bf16(p)ᵀ dO,  dS = bf16(p ⊙ (dO Vᵀ − δ) · scale),
// dK = dSᵀ Q,  dQ = dS K.  Head dim 32, fp32 accumulators, bf16 operands on
// tensor cores (wmma 16×16×16), rounding points as in the TPU kernel.
//
// The TPU kernel sweeps (q block, kv block) pairs in order and keeps
// full-sequence fp32 dk/dv in VMEM.  Blocks here run in no order, so the
// work is split as the TPU's ragged pair is: one kernel parallel over kv
// tiles (each block owns 64 keys and walks every q tile, dK and dV stay in
// registers), one parallel over q tiles (each block owns 64 queries and
// walks every kv tile, dQ stays in registers).  No atomics: the gradients
// are deterministic.  Each logit is recomputed once per kernel, so the pair
// costs 7 products per (q, kv) tile pair against the TPU sweep's 5; both
// kernels are bound, as the forward is, by the exp and the per-logit
// shared-memory round trips (S and dP stored, p and dS formed on the CUDA
// cores, read back as fragments).  Ragged q and kv tails are masked; q, k,
// v, dO and the gradients are addressed through (batch, head, row) strides
// with a contiguous head dim.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int D = 32;        // head dim
constexpr int BT = 64;       // rows per tile (queries or keys)
constexpr int LDT = D + 8;   // bf16 pitch of a staged q/k/v/dO tile
constexpr int LDS = BT + 4;  // fp32 pitch of a warp's 16 × 64 logits
constexpr int LDP = BT + 8;  // bf16 pitch of a warp's 16 × 64 p / dS

struct Strides {
    long long b, h, n;
};

constexpr int TILE_BYTES = BT * LDT * 2;          // 5,120
constexpr int S_BYTES = 16 * LDS * 4;             // 4,352
constexpr int P_BYTES = 16 * LDP * 2;             // 2,304

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long sn, int row0, int nrows,
                                          int tid) {
    // BT rows of 32 bf16 = 4 × 16-byte vectors each; zero past nrows
    for (int v = tid; v < BT * (D / 8); v += 128) {
        int r = v / (D / 8), cv = v % (D / 8);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < nrows)
            val = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + cv * 8);
        *reinterpret_cast<uint4*>(dst + r * LDT + cv * 8) = val;
    }
}

// 16 × 64 fp32 product A·Bᵀ of a warp's two A fragments (16 × 32) with the
// 64 rows of a staged tile (64 × 32), stored row-major at out
__device__ __forceinline__ void rows_times_tile_t(float* out, const FragA* a,
                                                  const bf16* tile) {
#pragma unroll
    for (int nb = 0; nb < BT / 16; ++nb) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            FragBT bt;   // col-major view of the tile rows is the tileᵀ
            wmma::load_matrix_sync(bt, tile + nb * 16 * LDT + kk * 16, LDT);
            wmma::mma_sync(acc, a[kk], bt, acc);
        }
        wmma::store_matrix_sync(out + nb * 16, acc, LDS, wmma::mem_row_major);
    }
}

// write a warp's two 16 × 16 fp32 accumulators (16 rows × 32) as bf16 rows
__device__ __forceinline__ void store_rows(bf16* dst, long long sn, int row0,
                                           int nrows, FragC* acc, float* stage,
                                           int lane) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(stage + j * 16, acc[j], LDS, wmma::mem_row_major);
    __syncwarp();
    const int r = lane >> 1, half = lane & 1;
    if (row0 + r < nrows) {
        bf16* row = dst + (row0 + r) * sn + half * 16;
#pragma unroll
        for (int d = 0; d < 16; ++d)
            row[d] = __float2bfloat16(stage[r * LDS + half * 16 + d]);
    }
    __syncwarp();
}

// dK, dV: one block per (64 keys, batch·head); warp w owns keys 16w..16w+15.
// Shared memory: the q and dO tiles, lse and δ of the tile, then per warp
// S and dP (fp32) and p and dS (bf16), all transposed (keys × queries).
__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                     Strides os, Strides dks, Strides dvs, int H, int Nq,
                     int Nkv, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Os = reinterpret_cast<bf16*>(smem + TILE_BYTES);
    float* lse_s = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);
    float* delta_s = lse_s + BT;
    unsigned char* wbase = smem + 2 * TILE_BYTES + 2 * BT * 4
                           + (threadIdx.x >> 5) * (2 * S_BYTES + 2 * P_BYTES);
    float* S = reinterpret_cast<float*>(wbase);
    float* dP = reinterpret_cast<float*>(wbase + S_BYTES);
    bf16* P = reinterpret_cast<bf16*>(wbase + 2 * S_BYTES);
    bf16* dS = reinterpret_cast<bf16*>(wbase + 2 * S_BYTES + P_BYTES);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int k0 = blockIdx.x * BT;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* ob = dout + b * os.b + h * os.h;
    const float* lse_b = lse + (size_t)blockIdx.y * Nq;
    const float* delta_b = delta + (size_t)blockIdx.y * Nq;

    // this warp's 16 keys and values as A fragments (staged through Qs/Os)
    load_tile(Qs, k + b * ks.b + h * ks.h, ks.n, k0, Nkv, tid);
    load_tile(Os, v + b * vs.b + h * vs.h, vs.n, k0, Nkv, tid);
    __syncthreads();
    FragA ka[2], va[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
        wmma::load_matrix_sync(ka[kk], Qs + warp * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(va[kk], Os + warp * 16 * LDT + kk * 16, LDT);
    }
    FragC dka[2], dva[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(dka[j], 0.f);
        wmma::fill_fragment(dva[j], 0.f);
    }
    const int r = lane >> 1, half = lane & 1;

    for (int q0 = 0; q0 < Nq; q0 += BT) {
        __syncthreads();   // every warp is done with the previous tiles
        load_tile(Qs, qb, qs.n, q0, Nq, tid);
        load_tile(Os, ob, os.n, q0, Nq, tid);
        if (tid < BT) {
            lse_s[tid] = q0 + tid < Nq ? lse_b[q0 + tid] : 0.f;
        } else {
            int t = tid - BT;
            delta_s[t] = q0 + t < Nq ? delta_b[q0 + t] : 0.f;
        }
        __syncthreads();

        rows_times_tile_t(S, ka, Qs);    // Sᵀ = K Qᵀ   (16 keys × 64 queries)
        rows_times_tile_t(dP, va, Os);   // dPᵀ = V dOᵀ
        __syncwarp();

#pragma unroll 8
        for (int cc = 0; cc < BT / 2; ++cc) {
            int col = half * (BT / 2) + cc;
            float p = 0.f, ds = 0.f;
            if (q0 + col < Nq) {
                p = expf(S[r * LDS + col] * scale - lse_s[col]);
                ds = p * (dP[r * LDS + col] - delta_s[col]) * scale;
            }
            P[r * LDP + col] = __float2bfloat16(p);
            dS[r * LDP + col] = __float2bfloat16(ds);
        }
        __syncwarp();

        // dV += pᵀ dO,  dK += dSᵀ Q   (16 keys × 32)
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            FragA pa, dsa;
            wmma::load_matrix_sync(pa, P + kk * 16, LDP);
            wmma::load_matrix_sync(dsa, dS + kk * 16, LDP);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                FragB of, qf;
                wmma::load_matrix_sync(of, Os + kk * 16 * LDT + j * 16, LDT);
                wmma::mma_sync(dva[j], pa, of, dva[j]);
                wmma::load_matrix_sync(qf, Qs + kk * 16 * LDT + j * 16, LDT);
                wmma::mma_sync(dka[j], dsa, qf, dka[j]);
            }
        }
    }

    __syncwarp();
    const int kr = k0 + warp * 16;
    store_rows(dk + b * dks.b + h * dks.h, dks.n, kr, Nkv, dka, S, lane);
    store_rows(dv + b * dvs.b + h * dvs.h, dvs.n, kr, Nkv, dva, S, lane);
}

// dQ: one block per (64 queries, batch·head); warp w owns queries
// 16w..16w+15.  Shared memory: the k and v tiles, then per warp S and dP
// (fp32) and dS (bf16).
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dqs, int H, int Nq, int Nkv, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = reinterpret_cast<bf16*>(smem + TILE_BYTES);
    unsigned char* wbase = smem + 2 * TILE_BYTES
                           + (threadIdx.x >> 5) * (2 * S_BYTES + P_BYTES);
    float* S = reinterpret_cast<float*>(wbase);
    float* dP = reinterpret_cast<float*>(wbase + S_BYTES);
    bf16* dS = reinterpret_cast<bf16*>(wbase + 2 * S_BYTES);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BT;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    const int r = lane >> 1, half = lane & 1;
    const int qi = q0 + warp * 16 + r;
    const float lse_r = qi < Nq ? lse[(size_t)blockIdx.y * Nq + qi] : 0.f;
    const float delta_r = qi < Nq ? delta[(size_t)blockIdx.y * Nq + qi] : 0.f;

    // this warp's 16 queries and output gradients as A fragments
    load_tile(Ks, q + b * qs.b + h * qs.h, qs.n, q0, Nq, tid);
    load_tile(Vs, dout + b * os.b + h * os.h, os.n, q0, Nq, tid);
    __syncthreads();
    FragA qa[2], oa[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
        wmma::load_matrix_sync(qa[kk], Ks + warp * 16 * LDT + kk * 16, LDT);
        wmma::load_matrix_sync(oa[kk], Vs + warp * 16 * LDT + kk * 16, LDT);
    }
    FragC dqa[2];
    wmma::fill_fragment(dqa[0], 0.f);
    wmma::fill_fragment(dqa[1], 0.f);

    for (int t0 = 0; t0 < Nkv; t0 += BT) {
        __syncthreads();
        load_tile(Ks, kb, ks.n, t0, Nkv, tid);
        load_tile(Vs, vb, vs.n, t0, Nkv, tid);
        __syncthreads();

        rows_times_tile_t(S, qa, Ks);    // S = Q Kᵀ
        rows_times_tile_t(dP, oa, Vs);   // dP = dO Vᵀ
        __syncwarp();

#pragma unroll 8
        for (int cc = 0; cc < BT / 2; ++cc) {
            int col = half * (BT / 2) + cc;
            float ds = 0.f;
            if (t0 + col < Nkv) {
                float p = expf(S[r * LDS + col] * scale - lse_r);
                ds = p * (dP[r * LDS + col] - delta_r) * scale;
            }
            dS[r * LDP + col] = __float2bfloat16(ds);
        }
        __syncwarp();

        // dQ += dS K   (16 queries × 32)
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            FragA dsa;
            wmma::load_matrix_sync(dsa, dS + kk * 16, LDP);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                FragB kf;
                wmma::load_matrix_sync(kf, Ks + kk * 16 * LDT + j * 16, LDT);
                wmma::mma_sync(dqa[j], dsa, kf, dqa[j]);
            }
        }
    }

    __syncwarp();
    store_rows(dq + b * dqs.b + h * dqs.h, dqs.n, q0 + warp * 16, Nq, dqa, S,
               lane);
}

constexpr int DKV_SMEM = 2 * TILE_BYTES + 2 * BT * 4 + 4 * (2 * S_BYTES + 2 * P_BYTES);
constexpr int DQ_SMEM = 2 * TILE_BYTES + 4 * (2 * S_BYTES + P_BYTES);

}  // namespace

VIT_API int vit_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, long long dksb, long long dksh, long long dksn,
    long long dvsb, long long dvsh, long long dvsn, int B, int H, int Nq,
    int Nkv, float scale, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nkv + BT - 1) / BT, B * H);
    flash_bwd_dkv_kernel<<<grid, 128, DKV_SMEM, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn}, Strides{vsb, vsh, vsn},
        Strides{osb, osh, osn}, Strides{dksb, dksh, dksn},
        Strides{dvsb, dvsh, dvsn}, H, Nq, Nkv, scale);
    return (int)cudaGetLastError();
}

VIT_API int vit_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, long long dqsb, long long dqsh, long long dqsn, int B,
    int H, int Nq, int Nkv, float scale, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nq + BT - 1) / BT, B * H);
    flash_bwd_dq_kernel<<<grid, 128, DQ_SMEM, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dq,
        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn}, Strides{vsb, vsh, vsn},
        Strides{osb, osh, osn}, Strides{dqsb, dqsh, dqsn}, H, Nq, Nkv, scale);
    return (int)cudaGetLastError();
}
