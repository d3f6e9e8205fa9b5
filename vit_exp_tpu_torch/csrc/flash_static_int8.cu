// K9/K10: static-max cosine attention forward with int8 QKᵀ (serving).
// Replaces vit_exp_tpu/ops/flash_attention.py::_fwd_kernel_static_int8 (K9,
// the transpose layout) and ::_fwd_kernel_static_hp (K10, the heads-packed
// layout): q8, k8, v and out are read and written through (batch, head,
// row) strides, so one kernel serves both layouts.
//
// S = q8·k8ᵀ (int8 tensor cores, int32 sums); logits = S·qe[row] − B with
// qe = s_q[row]·s_k·scale; p = bf16(exp(logits)); O += P·V and l += Σp with
// bf16 p and v (fp32 sums), as K10 rounds them.  The nulls seed O and l
// from fp32 logits q8·nk·qn[row] (qn = s_q[row]·scale, nk fp32): O gets
// bf16(p0)·nv, l gets p0 unrounded (K10 sums its null probabilities in
// fp32).  out = O / l in bf16.
//
// K1's first design (wmma, before csrc/flash_fwd.cu) with int8 Q and K
// tiles: one block owns 64 queries of one (batch, head), four warps 16
// queries each; the
// block walks the keys in tiles of 64 staged in shared memory (q8 and k8 in
// the k16 layout, 2 KB each).  Bound like K1's: at 13,824 tokens and 32
// (batch, head) rows, 6.1 G logits per layer, each needing one exp and one
// trip through shared memory; the int8 product halves only the QKᵀ half of
// the tensor-core work.  Head dim 32; q and kv tails are masked.
#include "common.cuh"

using namespace vit;

namespace {

constexpr int D = 32;      // head dim
constexpr int BQ = 64;     // queries per block
constexpr int BKV = 64;    // keys per tile
constexpr int LDV = D + 8;       // bf16 row pitch of the V tile
constexpr int LDS = BKV + 4;     // int / fp32 row pitch of a warp's S tile
constexpr int LDP = BKV + 8;     // bf16 row pitch of a warp's P tile

struct Strides {
    long long b, h, n;
};

__device__ __forceinline__ void load_rows8(signed char* dst,
                                           const signed char* src,
                                           long long sn, int row0, int nrows,
                                           int tid) {
    // 64 rows of 32 codes = 2 × 16-byte vectors each, into the k16 layout
    for (int t = tid; t < BQ * 2; t += 128) {
        int r = t >> 1, c = t & 1;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < nrows)
            val = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + c * 16);
        *reinterpret_cast<uint4*>(dst + c * BQ * 16 + r * 16) = val;
    }
}

__device__ __forceinline__ void load_rows16(bf16* dst, const bf16* src,
                                            long long sn, int row0, int nrows,
                                            int tid) {
    for (int t = tid; t < BKV * (D / 8); t += 128) {
        int r = t / (D / 8), cv = t % (D / 8);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < nrows)
            val = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + cv * 8);
        *reinterpret_cast<uint4*>(dst + r * LDV + cv * 8) = val;
    }
}

__global__ void __launch_bounds__(128)
flash_static_int8_kernel(const signed char* __restrict__ q8,
                         const signed char* __restrict__ k8,
                         const bf16* __restrict__ v,
                         const float* __restrict__ qe,
                         const float* __restrict__ qn,
                         const float* __restrict__ nk,
                         const bf16* __restrict__ nv,
                         const float* __restrict__ bound_ptr,
                         bf16* __restrict__ out, Strides qs, Strides ks,
                         Strides vs, Strides os, Strides es, int H, int Nq,
                         int Nkv, int n_null) {
    __shared__ __align__(128) signed char Qs[2 * BQ * 16];
    __shared__ __align__(128) signed char Ks[2 * BKV * 16];
    __shared__ __align__(128) bf16 Vs[BKV * LDV];
    __shared__ __align__(128) float Sw[4][16 * LDS];
    __shared__ __align__(128) bf16 Pw[4][16 * LDP];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const signed char* kb = k8 + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    load_rows8(Qs, q8 + b * qs.b + h * qs.h, qs.n, q0, Nq, tid);
    __syncthreads();

    const float bound = *bound_ptr;
    float* S = Sw[warp];
    int* Si = reinterpret_cast<int*>(S);
    bf16* P = Pw[warp];
    const int r = lane >> 1, half = lane & 1;
    const int row = warp * 16 + r, qi = q0 + row;
    float qe_r = 0.f, qn_r = 0.f;
    if (qi < Nq) {
        const long long e = b * es.b + h * es.h + qi * es.n;
        qe_r = qe[e];
        qn_r = qn[e];
    }

    // nulls seed O (through S) and l
    float l = 0.f;
    {
        float o[16];
#pragma unroll
        for (int d = 0; d < 16; ++d) o[d] = 0.f;
        for (int j = 0; j < n_null; ++j) {
            const float* nkj = nk + ((size_t)h * n_null + j) * D;
            const bf16* nvj = nv + ((size_t)h * n_null + j) * D + half * 16;
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d)
                s += (float)Qs[k16_index(row, d, BQ)] * nkj[d];
            const float p0 = expf(__fsub_rn(__fmul_rn(s, qn_r), bound));
            l += p0;
            const float pb = bf16_round(p0);
#pragma unroll
            for (int d = 0; d < 16; ++d) o[d] += pb * __bfloat162float(nvj[d]);
        }
#pragma unroll
        for (int d = 0; d < 16; ++d) S[r * LDS + half * 16 + d] = o[d];
    }
    __syncwarp();
    FragC oacc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(oacc[j], S + j * 16, LDS, wmma::mem_row_major);
    FragA8 qa[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
        wmma::load_matrix_sync(qa[kk], Qs + kk * BQ * 16 + warp * 16 * 16, 16);

    for (int t0 = 0; t0 < Nkv; t0 += BKV) {
        __syncthreads();   // every warp is done with the previous tiles
        load_rows8(Ks, kb, ks.n, t0, Nkv, tid);
        load_rows16(Vs, vb, vs.n, t0, Nkv, tid);
        __syncthreads();

        // S = q8 k8ᵀ (16 × 64 per warp, int32)
#pragma unroll
        for (int nb = 0; nb < BKV / 16; ++nb) {
            FragC32 sacc;
            wmma::fill_fragment(sacc, 0);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                FragB8 kt;   // col-major view of the K rows is Kᵀ
                wmma::load_matrix_sync(kt, Ks + kk * BKV * 16 + nb * 16 * 16, 16);
                wmma::mma_sync(sacc, qa[kk], kt, sacc);
            }
            wmma::store_matrix_sync(Si + nb * 16, sacc, LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // p = bf16(exp(S·qe − B)), masked past Nkv; l += Σp
        float ls = 0.f;
#pragma unroll 8
        for (int cc = 0; cc < BKV / 2; ++cc) {
            const int col = half * (BKV / 2) + cc;
            float p = 0.f;
            if (t0 + col < Nkv)
                p = expf(__fsub_rn(__fmul_rn((float)Si[r * LDS + col], qe_r),
                                   bound));
            const bf16 pb = __float2bfloat16(p);
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
                wmma::load_matrix_sync(vf, Vs + kk * 16 * LDV + j * 16, LDV);
                wmma::mma_sync(oacc[j], pa, vf, oacc[j]);
            }
        }
    }

    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(S + j * 16, oacc[j], LDS, wmma::mem_row_major);
    __syncwarp();
    if (qi < Nq) {
        bf16* orow = out + b * os.b + h * os.h + qi * os.n + half * 16;
#pragma unroll
        for (int d = 0; d < 16; ++d)
            orow[d] = __float2bfloat16(S[r * LDS + half * 16 + d] / l);
    }
}

}  // namespace

VIT_API int vit_flash_static_int8_fwd(
    const void* q8, const void* k8, const void* v, const void* qe,
    const void* qn, const void* nk, const void* nv, const void* bound,
    void* out, long long qsb, long long qsh, long long qsn, long long ksb,
    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
    long long osb, long long osh, long long osn, long long esb,
    long long esh, long long esn, int B, int H, int Nq, int Nkv, int n_null,
    void* stream) {
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    flash_static_int8_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const signed char*)q8, (const signed char*)k8, (const bf16*)v,
        (const float*)qe, (const float*)qn, (const float*)nk,
        (const bf16*)nv, (const float*)bound, (bf16*)out,
        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
        Strides{vsb, vsh, vsn}, Strides{osb, osh, osn},
        Strides{esb, esh, esn}, H, Nq, Nkv, n_null);
    return (int)cudaGetLastError();
}
