// K9/K10: static-max cosine attention forward with int8 QKᵀ (serving).
// Replaces vit_exp_tpu/ops/flash_attention.py::_fwd_kernel_static_int8 (K9,
// the transpose layout) and ::_fwd_kernel_static_hp (K10, the heads-packed
// layout): q8, k8, v and out are read and written through (batch, head,
// row) strides, so one kernel serves both layouts.
//
// S = q8·k8ᵀ (int8 tensor cores, exact int32); logits = S·qe[row] − B with
// qe = s_q[row]·s_k·scale; p = bf16(exp(logits)); O += P·V and l += Σp with
// bf16 p and v (fp32 sums), as K10 rounds them.  The nulls seed O and l
// from fp32 logits q8·nk·qn[row] (qn = s_q[row]·scale, nk fp32): O gets
// bf16(p0)·nv, l gets p0 unrounded (K10 sums its null probabilities in
// fp32).  out = O / l in bf16.
//
// What bounds it: one exp per logit on the special-function unit (16 per
// clock per SM: 1.46 ms per layer at 6.12 G logits), ahead of the products
// (the int8 S at the int8 rate, P·V at the bf16 rate: 0.59 ms together).
// The design is K1's (csrc/flash_fwd.cu, PTX helpers in attn_mma.cuh):
// - S, p and O never leave registers.  4 warps of 32 query rows (two m16
//   tiles), 128 queries per block; q8's A fragments are loaded once: an
//   int8 row of 32 codes is 16 b16 units, so one ldmatrix.x4 of the staged
//   rows is exactly the m16n8k32 s8 A fragment, and one ldmatrix.x4 of 16
//   key rows gives the B fragments of two n8 tiles.  S takes one
//   mma.sync.m16n8k32.s8 per n8 tile and m16 tile (K1: two bf16 m16n8k16).
// - S converts to fp32 exactly (|S| ≤ 32·127·127 = 516,128 < 2²⁴), in one
//   I2FP.F32.S32: ptxas for sm_90a does not emit the I2F of the
//   multi-function unit, which would share the exp unit's rate.  An
//   accumulator started at 0x4B400000 (1.5·2²³) and one FADD recover S as
//   exactly, but ran slower in a trial.
// - p = ex2.approx(S·(qe·log2e) − B·log2e): one conversion, one FFMA and
//   one MUFU per logit, the row coefficients held per lane for its four
//   rows; p is packed to bf16 as the P·V A fragment, and l sums the packed
//   bf16 values (as K1 does).  p below 2^-126 flushes to 0.
// - k8 and V stream in 64-key tiles through a 3-stage cp.async ring: tile
//   t + 2 loads while tile t computes, one barrier per tile.  int8 rows sit
//   at a 48-byte pitch and V rows at 80 bytes, so every ldmatrix is
//   conflict-free.
// - The nulls are computed once per row at the start, in fp32, straight into
//   the register layout of O and l (each lane of a row's quad takes 8 of
//   the 32 dims, two shuffles give the logit).
// - Masking: keys ≥ Nkv (zero-filled) get p = 0, only in the last tile (a
//   uniform branch); query rows past Nq are zero-filled and never stored.
// - No atomics; __launch_bounds__ asks for three blocks (12 warps) per SM.
#include "attn_mma.cuh"

using namespace vit;

namespace {

constexpr int D = ATT_D;        // head dim
constexpr int LDV = ATT_LDT;    // bf16 pitch of a staged V row
constexpr int LD8 = 48;         // byte pitch of a staged int8 row
constexpr int BKV = 64;         // keys of a streamed tile
constexpr int WR = 32;          // query rows a warp owns: two m16 tiles
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * WR;  // query rows a block owns: 128
constexpr int STAGES = 3;       // depth of the cp.async ring
constexpr int MIN_BLOCKS = 3;   // per SM, for __launch_bounds__
constexpr int MAX_NULL = 8;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    long long b, h, n;
};

struct Smem {
    signed char q[BQ * LD8];
    signed char k[STAGES][BKV * LD8];
    bf16 v[STAGES][BKV * LDV];
};

// ROWS rows (32 int8 codes each) of src from row0 into dst at pitch LD8,
// zero past nrows: two 16-byte chunks per row
template <int ROWS>
__device__ __forceinline__ void copy_rows8(signed char* dst,
                                           const signed char* src,
                                           long long sn, int row0, int nrows,
                                           int tid) {
#pragma unroll
    for (int i = 0; i < ROWS * 2 / THREADS; ++i) {
        const int e = tid + THREADS * i, r = e >> 1, c = (e & 1) * 16;
        const bool ok = row0 + r < nrows;
        cp_async16(dst + r * LD8 + c, ok ? src + (row0 + r) * sn + c : src, ok);
    }
}

// ldmatrix.x4 over int8 rows (read as b16 units)
__device__ __forceinline__ void ldsm_x4_s8(uint32_t (&r)[4],
                                           const signed char* p) {
    ldsm_x4(r, reinterpret_cast<const bf16*>(p));
}

// c (16 × 8 s32) += a (16 × 32 s8, row) · b (32 × 8 s8, col).  Lane l, g =
// l / 4, t = l % 4: a = {(g, 4t..4t+3), (g+8, 4t..), (g, 16+4t..), (g+8,
// 16+4t..)}; b = {(k 4t..4t+3, n g), (k 16+4t.., n g)}; c as mma()'s
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 64-key tile (ks int8 at pitch LD8, vs bf16 at LDV) against the warp's
// 32 queries (qa).  c2: qe·log2e of the lane's rows [m16 tile][half]; b2:
// B·log2e.  MASK: keys at or past kv_left are not keys (the last tile).
template <bool MASK>
__device__ __forceinline__ void attend_tile(float (&o)[2][4][4],
                                            float (&l)[2][2],
                                            const uint32_t (&qa)[2][4],
                                            const float (&c2)[2][2], float b2,
                                            const signed char* ks,
                                            const bf16* vs, int kv_left,
                                            int lane) {
    constexpr int NT = BKV / 8;
    const int t = lane & 3;
    float s[NT][2][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];   // {b0, b1} of keys 16jp.., then of 16jp + 8..
        ldsm_x4_s8(b, ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD8 +
                          (lane & 8) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
            mma_s8(c0, qa[mt], b[0], b[1]);
            mma_s8(c1, qa[mt], b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {   // exactly S
                s[2 * jp][mt][e] = (float)c0[e];
                s[2 * jp + 1][mt][e] = (float)c1[e];
            }
        }
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t pa[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                float p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    p[e] = exp2_approx(fmaf(s[j][mt][e], c2[mt][e >> 1], -b2));
                    if (MASK && j * 8 + 2 * t + (e & 1) >= kv_left) p[e] = 0.f;
                }
                const uint32_t lo = pack_bf16(p[0], p[1]);
                const uint32_t hi = pack_bf16(p[2], p[3]);
                pa[mt][2 * jj] = lo;
                pa[mt][2 * jj + 1] = hi;
                // l sums the bf16 values the P·V operand holds
                l[mt][0] += __uint_as_float(lo << 16) +
                            __uint_as_float(lo & 0xffff0000u);
                l[mt][1] += __uint_as_float(hi << 16) +
                            __uint_as_float(hi & 0xffff0000u);
            }
        }
        acc_times_tile(o, pa, vs, kk * 16, lane);   // O += P·V
    }
}

// one block per (128 queries, batch·head); warp w owns queries 32w..32w+31
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
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
    __shared__ __align__(128) Smem sm;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const signed char* kb = k8 + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    // the first group: the block's queries
    copy_rows8<BQ>(sm.q, q8 + b * qs.b + h * qs.h, qs.n, q0, Nq, tid);
    cp_async_commit();

    const int n_tiles = (Nkv + BKV - 1) / BKV;
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            const int st = tile % STAGES;
            copy_rows8<BKV>(sm.k[st], kb, ks.n, tile * BKV, Nkv, tid);
            copy_rows<BKV, THREADS>(sm.v[st], vb, vs.n, tile * BKV, Nkv, tid);
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    // the lane's four rows: [m16 tile][half] = tile row warp·32 + 16mt +
    // 8half + g; padded rows (≥ Nq) take qe = qn = 0 and are never stored
    const float bound = *bound_ptr, b2 = bound * LOG2E;
    float c2[2][2], qn_r[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = q0 + warp * WR + mt * 16 + half * 8 + g;
            float e2 = 0.f, n2 = 0.f;
            if (row < Nq) {
                const long long ei = b * es.b + h * es.h + row * es.n;
                e2 = qe[ei];
                n2 = qn[ei];
            }
            c2[mt][half] = e2 * LOG2E;
            qn_r[mt][half] = n2;
        }

    cp_async_wait<STAGES - 1>();   // this thread's queries
    __syncthreads();
    uint32_t qa[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_s8(qa[mt], sm.q + (warp * WR + mt * 16 + (lane & 15)) * LD8 +
                               (lane >> 4) * 16);

    float o[2][4][4], l[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
    }

    // the nulls seed O and l: lane t of a row's quad takes dims 8t..8t+7
    for (int j = 0; j < n_null; ++j) {
        const float* nkj = nk + ((size_t)h * n_null + j) * D + 8 * t;
        const bf16* nvj = nv + ((size_t)h * n_null + j) * D + 2 * t;
        float nkf[8];
#pragma unroll
        for (int d = 0; d < 8; ++d) nkf[d] = nkj[d];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const signed char* qr =
                    sm.q + (warp * WR + mt * 16 + half * 8 + g) * LD8 + 8 * t;
                float sj = 0.f;
#pragma unroll
                for (int d = 0; d < 8; ++d) sj += (float)qr[d] * nkf[d];
                sj += __shfl_xor_sync(0xffffffffu, sj, 1);
                sj += __shfl_xor_sync(0xffffffffu, sj, 2);
                const float p0 =
                    expf(__fsub_rn(__fmul_rn(sj, qn_r[mt][half]), bound));
                if (t == 0) l[mt][half] += p0;
                const float pb = bf16_round(p0);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    o[mt][nt][2 * half] += pb * __bfloat162float(nvj[nt * 8]);
                    o[mt][nt][2 * half + 1] +=
                        pb * __bfloat162float(nvj[nt * 8 + 1]);
                }
            }
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of the tile
        __syncthreads();   // every copy visible; the oldest stage is free
        issue(tile + STAGES - 1);
        const signed char* kt = sm.k[tile % STAGES];
        const bf16* vt = sm.v[tile % STAGES];
        const int kv_left = Nkv - tile * BKV;
        if (kv_left >= BKV)
            attend_tile<false>(o, l, qa, c2, b2, kt, vt, BKV, lane);
        else
            attend_tile<true>(o, l, qa, c2, b2, kt, vt, kv_left, lane);
    }
    cp_async_wait<0>();

    // out = O / l
    bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float lt = l[mt][half];
            lt += __shfl_xor_sync(0xffffffffu, lt, 1);
            lt += __shfl_xor_sync(0xffffffffu, lt, 2);
            const int row = q0 + warp * WR + mt * 16 + half * 8 + g;
            if (row >= Nq) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
                *reinterpret_cast<uint32_t*>(ob + row * os.n + nt * 8 + 2 * t) =
                    pack_bf16(o[mt][nt][2 * half] / lt,
                              o[mt][nt][2 * half + 1] / lt);
        }
}

static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");
static_assert(BKV * LD8 % 16 == 0 && BQ * LD8 % 16 == 0 &&
                  sizeof(bf16) * BKV * LDV % 16 == 0,
              "stages must keep 16-byte alignment");

}  // namespace

VIT_API int vit_flash_static_int8_fwd(
    const void* q8, const void* k8, const void* v, const void* qe,
    const void* qn, const void* nk, const void* nv, const void* bound,
    void* out, long long qsb, long long qsh, long long qsn, long long ksb,
    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
    long long osb, long long osh, long long osn, long long esb,
    long long esh, long long esn, int B, int H, int Nq, int Nkv, int n_null,
    void* stream) {
    if (Nkv < 0 || n_null < 0 || n_null > MAX_NULL || Nkv + n_null < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    flash_static_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const signed char*)q8, (const signed char*)k8, (const bf16*)v,
        (const float*)qe, (const float*)qn, (const float*)nk,
        (const bf16*)nv, (const float*)bound, (bf16*)out,
        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
        Strides{vsb, vsh, vsn}, Strides{osb, osh, osn},
        Strides{esb, esh, esn}, H, Nq, Nkv, n_null);
    return (int)cudaGetLastError();
}
