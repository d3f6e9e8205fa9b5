// K15: online-softmax attention forward over a concatenated kv.  Replaces
// vit_exp_tpu/ops/flash_attention.py::_fwd_kernel (``_flash_fwd``, reached
// through ``_flash_core`` with null_strategy="concat": the null kv are
// ordinary keys 0 .. n_null-1 of every (batch, head)).
//
// out = Σ p·v / Σ p with p = exp(q·k·scale − m), m the running row max.
// Head dim 32.  Bound on an H100: the two products are 4·Nq·Nkv·d
// operations per (batch, head), 0.79 ms at the training shape at the bf16
// tensor-core peak; what limits this simple design is the per-logit work
// on the CUDA cores (scale, mask, max, exp, sum) and the shared-memory round
// trips of S and of each tile's P·V.  Built on K1 (flash_static.cu): one
// block per (64 queries, batch·head); four warps own 16 queries each; the
// keys are walked in tiles of 64 staged in shared memory, S = Q·Kᵀ and P·V
// on tensor cores.  What K15 adds:
//  - a running max: per tile m_new = max(m, rowmax(S·scale)),
//    correction = exp(m − m_new), l = correction·l + Σp,
//    O = correction·O + P·V.  P·V goes into fresh accumulators and is
//    folded into O in registers (lanes 2r and 2r+1 own query row r, one
//    half of the head dim each), so the rescale needs no fragment layout;
//  - the rounding of the TPU kernel: l sums the fp32 p; only the P·V
//    operand is p rounded to bf16;
//  - the ragged kv tail: key columns ≥ Nkv are −∞ before the row max;
//  - out = O / l written once, and, when lse is not null, lse = m + log l
//    (fp32, (batch·head, Nq)), the statistic the backward pair
//    (flash_bwd.cu) recomputes p from.
// q, k, v and out are addressed through (batch, head, row) strides with a
// contiguous head dim; the q tail is masked.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int D = 32;      // head dim
constexpr int BQ = 64;     // queries per block
constexpr int BKV = 64;    // keys per tile
constexpr int LDQ = D + 8;       // bf16 row pitch of the Q/K/V tiles
constexpr int LDS = BKV + 4;     // fp32 row pitch of a warp's S tile
constexpr int LDP = BKV + 8;     // bf16 row pitch of a warp's P tile

struct Strides {
    long long b, h, n;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long sn, int row0, int nrows,
                                          int tid) {
    // BQ (= BKV) rows of 32 bf16 = 4 × 16-byte vectors each; zero past nrows
    for (int v = tid; v < BQ * (D / 8); v += 128) {
        int r = v / (D / 8), cv = v % (D / 8);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < nrows)
            val = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + cv * 8);
        *reinterpret_cast<uint4*>(dst + r * LDQ + cv * 8) = val;
    }
}

__global__ void __launch_bounds__(128)
flash_online_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, int H, int Nq, int Nkv,
                    float scale) {
    __shared__ __align__(128) bf16 Qs[BQ * LDQ];
    __shared__ __align__(128) bf16 Ks[BKV * LDQ];
    __shared__ __align__(128) bf16 Vs[BKV * LDQ];
    __shared__ __align__(128) float Sw[4][16 * LDS];
    __shared__ __align__(128) bf16 Pw[4][16 * LDP];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    load_rows(Qs, qb, qs.n, q0, Nq, tid);
    __syncthreads();

    float* S = Sw[warp];
    bf16* P = Pw[warp];
    const int r = lane >> 1, half = lane & 1;
    float* srow = S + r * LDS + half * (BKV / 2);
    bf16* prow = P + r * LDP + half * (BKV / 2);

    FragA qa[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
        wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * LDQ + kk * 16, LDQ);

    // running max m, row sum l and this lane's half of the output row O
    float m = neg_inf(), l = 0.f;
    float o[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) o[d] = 0.f;

    for (int t0 = 0; t0 < Nkv; t0 += BKV) {
        __syncthreads();   // every warp is done with the previous tiles
        load_rows(Ks, kb, ks.n, t0, Nkv, tid);
        load_rows(Vs, vb, vs.n, t0, Nkv, tid);
        __syncthreads();

        // S = Q Kᵀ (16 × 64 per warp)
#pragma unroll
        for (int nb = 0; nb < BKV / 16; ++nb) {
            FragC sacc;
            wmma::fill_fragment(sacc, 0.f);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                FragBT kt;   // col-major view of the K rows is Kᵀ
                wmma::load_matrix_sync(kt, Ks + nb * 16 * LDQ + kk * 16, LDQ);
                wmma::mma_sync(sacc, qa[kk], kt, sacc);
            }
            wmma::store_matrix_sync(S + nb * 16, sacc, LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // logits s·scale, −∞ past Nkv, then the new row max
        float mx = neg_inf();
#pragma unroll 8
        for (int cc = 0; cc < BKV / 2; ++cc) {
            float s = t0 + half * (BKV / 2) + cc < Nkv ? srow[cc] * scale
                                                       : neg_inf();
            srow[cc] = s;
            mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m, mx);   // finite: column t0 is a key
        const float corr = expf(m - m_new);

        // p = exp(s − m_new) in fp32 into l; bf16(p) into P for P·V
        float ls = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < BKV / 2; ++cc) {
            float p = expf(srow[cc] - m_new);
            ls += p;
            prow[cc] = __float2bfloat16(p);
        }
        l = corr * l + ls + __shfl_xor_sync(0xffffffffu, ls, 1);
        m = m_new;
        __syncwarp();

        // P·V into fresh accumulators, through S, then O = corr·O + P·V
        FragC pv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(pv[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            FragA pa;
            wmma::load_matrix_sync(pa, P + kk * 16, LDP);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                FragB vf;
                wmma::load_matrix_sync(vf, Vs + kk * 16 * LDQ + j * 16, LDQ);
                wmma::mma_sync(pv[j], pa, vf, pv[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(S + j * 16, pv[j], LDS, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int d = 0; d < 16; ++d)
            o[d] = corr * o[d] + S[r * LDS + half * 16 + d];
    }

    const int qi = q0 + warp * 16 + r;
    if (qi < Nq) {
        bf16* orow = out + b * os.b + h * os.h + qi * os.n + half * 16;
#pragma unroll
        for (int d = 0; d < 16; ++d) orow[d] = __float2bfloat16(o[d] / l);
        if (lse != nullptr && half == 0)
            lse[(size_t)blockIdx.y * Nq + qi] = m + logf(l);
    }
}

}  // namespace

VIT_API int vit_flash_online_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long qsb, long long qsh, long long qsn, long long ksb, long long ksh,
    long long ksn, long long vsb, long long vsh, long long vsn, long long osb,
    long long osh, long long osn, int B, int H, int Nq, int Nkv, float scale,
    void* stream) {
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    flash_online_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
        (float*)lse, Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
        Strides{vsb, vsh, vsn}, Strides{osb, osh, osn}, H, Nq, Nkv, scale);
    return (int)cudaGetLastError();
}
