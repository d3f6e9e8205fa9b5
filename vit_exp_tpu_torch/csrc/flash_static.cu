// K1: static-max cosine attention forward with null kv.  Replaces
// vit_exp_tpu/ops/flash_attention.py::_fwd_kernel_static.
//
// out = Σ p·v / Σ p over [nulls ++ kv], p = bf16(exp(q·k·scale − B)), where B
// bounds every logit (no running max).  Head dim 32.  One block per
// (64 queries, batch·head); four warps own 16 queries each.  The nulls seed
// the fp32 output accumulator and the row sum l; then the block walks the
// keys in tiles of 64 staged in shared memory: S = Q·Kᵀ and O += P·V on
// tensor cores, p and l in between on the CUDA cores (l stays in
// registers: lanes 2r and 2r+1 own query row r, one half of the columns
// each).  O / l is written once at the end.  q, k, v and out are addressed
// through (batch, head, row) strides with a contiguous head dim; the q and
// kv tails are masked.  B is read from device memory.  When lse is not null
// the block also writes lse = B + log l (fp32, (batch·head, Nq)), the
// softmax statistic the backward (flash_bwd.cu) recomputes p from.
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
flash_static_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ nk,
                    const bf16* __restrict__ nv,
                    const float* __restrict__ bound_ptr, bf16* __restrict__ out,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, int H, int Nq, int Nkv,
                    int n_null, float scale) {
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

    const float bound = *bound_ptr;
    float* S = Sw[warp];
    bf16* P = Pw[warp];
    const int r = lane >> 1, half = lane & 1;
    const bf16* qrow = Qs + (warp * 16 + r) * LDQ;

    // nulls seed O (through S) and l
    float l = 0.f;
    {
        float o[16];
#pragma unroll
        for (int d = 0; d < 16; ++d) o[d] = 0.f;
        for (int j = 0; j < n_null; ++j) {
            const bf16* nkj = nk + ((size_t)h * n_null + j) * D;
            const bf16* nvj = nv + ((size_t)h * n_null + j) * D + half * 16;
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d)
                s += __bfloat162float(qrow[d]) * __bfloat162float(nkj[d]);
            float p = bf16_round(expf(s * scale - bound));
            l += p;
#pragma unroll
            for (int d = 0; d < 16; ++d) o[d] += p * __bfloat162float(nvj[d]);
        }
#pragma unroll
        for (int d = 0; d < 16; ++d) S[r * LDS + half * 16 + d] = o[d];
    }
    __syncwarp();
    FragC oacc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(oacc[j], S + j * 16, LDS, wmma::mem_row_major);
    FragA qa[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
        wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * LDQ + kk * 16, LDQ);

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

        // p = bf16(exp(s·scale − B)), masked past Nkv; l += Σp
        float ls = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < BKV / 2; ++cc) {
            int col = half * (BKV / 2) + cc;
            float p = 0.f;
            if (t0 + col < Nkv) p = expf(S[r * LDS + col] * scale - bound);
            bf16 pb = __float2bfloat16(p);
            P[r * LDP + col] = pb;
            ls += __bfloat162float(pb);
        }
        l += ls + __shfl_xor_sync(0xffffffffu, ls, 1);
        __syncwarp();

        // O += P V
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            FragA pa;
            wmma::load_matrix_sync(pa, P + kk * 16, LDP);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                FragB vf;
                wmma::load_matrix_sync(vf, Vs + kk * 16 * LDQ + j * 16, LDQ);
                wmma::mma_sync(oacc[j], pa, vf, oacc[j]);
            }
        }
    }

    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(S + j * 16, oacc[j], LDS, wmma::mem_row_major);
    __syncwarp();
    const int qi = q0 + warp * 16 + r;
    if (qi < Nq) {
        bf16* orow = out + b * os.b + h * os.h + qi * os.n + half * 16;
#pragma unroll
        for (int d = 0; d < 16; ++d)
            orow[d] = __float2bfloat16(S[r * LDS + half * 16 + d] / l);
        if (lse != nullptr && half == 0)
            lse[(size_t)blockIdx.y * Nq + qi] = bound + logf(l);
    }
}

}  // namespace

VIT_API int vit_flash_static_fwd(
    const void* q, const void* k, const void* v, const void* nk,
    const void* nv, const void* bound, void* out, void* lse, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, int B, int H, int Nq, int Nkv, int n_null, float scale,
    void* stream) {
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    flash_static_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)nk,
        (const bf16*)nv, (const float*)bound, (bf16*)out, (float*)lse,
        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
        Strides{vsb, vsh, vsn}, Strides{osb, osh, osn}, H, Nq, Nkv, n_null,
        scale);
    return (int)cudaGetLastError();
}
