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
// fp32).  out = O / l in bf16.  Head dim D of 32 or 64, one template
// instance each: an int8 k step is 32 codes, so the wrapper zero-pads any
// other d ≤ 64 to the next instance (zero codes and zero null and v columns
// change neither S, the null logits nor P·V; the padded output columns are
// dropped).  At D 64 a warp owns 16 query rows (one m16 tile), so O and the
// fragments take the registers they take at D 32 with 32 rows.
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

constexpr int BKV = 64;         // keys of a streamed tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;       // depth of the cp.async ring
constexpr int MIN_BLOCKS = 3;   // per SM, for __launch_bounds__
constexpr int MAX_NULL = 8;
constexpr float LOG2E = 1.4426950408889634f;

// the tiling of head dim D (32 or 64: an int8 k step is 32 codes): MT m16
// tiles of query rows a warp (32 rows at D 32, 16 at D 64, where O and the
// fragments of 32 rows would double), int8 rows at a pitch of D + 16 bytes
// (48 or 80: conflict-free ldmatrix), V rows at att_ldt<D>() bf16
template <int D>
struct Int8Cfg {
    static constexpr int LDV = att_ldt<D>();   // bf16 pitch of a staged V row
    static constexpr int LD8 = D + 16;         // byte pitch of an int8 row
    static constexpr int KS = D / 32;          // int8 k32 steps
    static constexpr int MT = D == 64 ? 1 : 2;
    static constexpr int WR = 16 * MT;         // query rows a warp owns
    static constexpr int BQ = WARPS * WR;      // query rows a block owns
};

struct Strides {
    long long b, h, n;
};

template <int D>
struct Smem {
    signed char q[Int8Cfg<D>::BQ * Int8Cfg<D>::LD8];
    signed char k[STAGES][BKV * Int8Cfg<D>::LD8];
    bf16 v[STAGES][BKV * Int8Cfg<D>::LDV];
};

// ROWS rows (D int8 codes each) of src from row0 into dst at pitch LD8,
// zero past nrows: D / 16 chunks of 16 bytes per row
template <int ROWS, int D>
__device__ __forceinline__ void copy_rows8(signed char* dst,
                                           const signed char* src,
                                           long long sn, int row0, int nrows,
                                           int tid) {
    constexpr int SHIFT = D == 32 ? 1 : 2, LD8 = Int8Cfg<D>::LD8;
#pragma unroll
    for (int i = 0; i < (ROWS << SHIFT) / THREADS; ++i) {
        const int e = tid + THREADS * i, r = e >> SHIFT;
        const int c = (e & ((1 << SHIFT) - 1)) * 16;
        const bool ok = row0 + r < nrows;
        cp_async16(dst + r * LD8 + c, ok ? src + (row0 + r) * sn + c : src, ok);
    }
}

// One 64-key tile (ks int8 at pitch LD8, vs bf16 at LDV) against the warp's
// MT·16 queries (qa).  c2: qe·log2e of the lane's rows [m16 tile][half];
// b2: B·log2e.  MASK: keys at or past kv_left are not keys (the last tile).
template <bool MASK, int D, int MT>
__device__ __forceinline__ void attend_tile(
    float (&o)[MT][D / 8][4], float (&l)[MT][2],
    const uint32_t (&qa)[MT][D / 32][4], const float (&c2)[MT][2], float b2,
    const signed char* ks, const bf16* vs, int kv_left, int lane) {
    constexpr int NT = BKV / 8, KS = D / 32, LD8 = Int8Cfg<D>::LD8;
    const int t = lane & 3;
    float s[NT][MT][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[KS][4];   // per k step: {b0, b1} of keys 16jp.., then of
                             // 16jp + 8..
#pragma unroll
        for (int kc = 0; kc < KS; ++kc)
            ldsm_x4_s8(b[kc], ks + (jp * 16 + (lane & 7) +
                                    ((lane >> 4) << 3)) * LD8 +
                                  (lane & 8) * 2 + kc * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
#pragma unroll
            for (int kc = 0; kc < KS; ++kc) {
                mma_s8(c0, qa[mt][kc], b[kc][0], b[kc][1]);
                mma_s8(c1, qa[mt][kc], b[kc][2], b[kc][3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {   // exactly S
                s[2 * jp][mt][e] = (float)c0[e];
                s[2 * jp + 1][mt][e] = (float)c1[e];
            }
        }
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
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
        acc_times_tile<MT, D>(o, pa, vs, kk * 16, lane);   // O += P·V
    }
}

// one block per (BQ queries, batch·head); warp w owns queries WR·w ..
template <int D>
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
    using C = Int8Cfg<D>;
    constexpr int MT = C::MT, WR = C::WR, BQ = C::BQ, LD8 = C::LD8;
    constexpr int KS = C::KS, DL = D / 4;   // DL: null dims a lane takes
    __shared__ __align__(128) Smem<D> sm;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const signed char* kb = k8 + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    // the first group: the block's queries
    copy_rows8<BQ, D>(sm.q, q8 + b * qs.b + h * qs.h, qs.n, q0, Nq, tid);
    cp_async_commit();

    const int n_tiles = (Nkv + BKV - 1) / BKV;
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            const int st = tile % STAGES;
            copy_rows8<BKV, D>(sm.k[st], kb, ks.n, tile * BKV, Nkv, tid);
            copy_rows<BKV, THREADS, D>(sm.v[st], vb, vs.n, tile * BKV, Nkv,
                                       tid);
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    // the lane's rows: [m16 tile][half] = tile row warp·WR + 16mt + 8half
    // + g; padded rows (≥ Nq) take qe = qn = 0 and are never stored
    const float bound = *bound_ptr, b2 = bound * LOG2E;
    float c2[MT][2], qn_r[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
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
    uint32_t qa[MT][KS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kc = 0; kc < KS; ++kc)
            ldsm_x4_s8(qa[mt][kc],
                       sm.q + (warp * WR + mt * 16 + (lane & 15)) * LD8 +
                           (lane >> 4) * 16 + kc * 32);

    float o[MT][D / 8][4], l[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
    }

    // the nulls seed O and l: lane t of a row's quad takes dims DL·t ..
    for (int j = 0; j < n_null; ++j) {
        const float* nkj = nk + ((size_t)h * n_null + j) * D + DL * t;
        const bf16* nvj = nv + ((size_t)h * n_null + j) * D + 2 * t;
        float nkf[DL];
#pragma unroll
        for (int d = 0; d < DL; ++d) nkf[d] = nkj[d];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const signed char* qr =
                    sm.q + (warp * WR + mt * 16 + half * 8 + g) * LD8 + DL * t;
                float sj = 0.f;
#pragma unroll
                for (int d = 0; d < DL; ++d) sj += (float)qr[d] * nkf[d];
                sj += __shfl_xor_sync(0xffffffffu, sj, 1);
                sj += __shfl_xor_sync(0xffffffffu, sj, 2);
                const float p0 =
                    expf(__fsub_rn(__fmul_rn(sj, qn_r[mt][half]), bound));
                if (t == 0) l[mt][half] += p0;
                const float pb = bf16_round(p0);
#pragma unroll
                for (int nt = 0; nt < D / 8; ++nt) {
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
            attend_tile<false, D, MT>(o, l, qa, c2, b2, kt, vt, BKV, lane);
        else
            attend_tile<true, D, MT>(o, l, qa, c2, b2, kt, vt, kv_left, lane);
    }
    cp_async_wait<0>();

    // out = O / l
    bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float lt = l[mt][half];
            lt += __shfl_xor_sync(0xffffffffu, lt, 1);
            lt += __shfl_xor_sync(0xffffffffu, lt, 2);
            const int row = q0 + warp * WR + mt * 16 + half * 8 + g;
            if (row >= Nq) continue;
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt)
                *reinterpret_cast<uint32_t*>(ob + row * os.n + nt * 8 + 2 * t) =
                    pack_bf16(o[mt][nt][2 * half] / lt,
                              o[mt][nt][2 * half + 1] / lt);
        }
}

template <int D>
constexpr bool smem_fits() {
    using C = Int8Cfg<D>;
    return sizeof(Smem<D>) <= 48 * 1024 && BKV * C::LD8 % 16 == 0 &&
           C::BQ * C::LD8 % 16 == 0 && sizeof(bf16) * BKV * C::LDV % 16 == 0;
}
static_assert(smem_fits<32>() && smem_fits<64>(),
              "static shared memory, 16-byte aligned stages");

template <int D>
int launch_d(const void* q8, const void* k8, const void* v, const void* qe,
             const void* qn, const void* nk, const void* nv,
             const void* bound, void* out, Strides qs, Strides ks,
             Strides vs, Strides os, Strides es, int B, int H, int Nq,
             int Nkv, int n_null, void* stream) {
    dim3 grid((Nq + Int8Cfg<D>::BQ - 1) / Int8Cfg<D>::BQ, B * H);
    flash_static_int8_kernel<D><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const signed char*)q8, (const signed char*)k8, (const bf16*)v,
        (const float*)qe, (const float*)qn, (const float*)nk,
        (const bf16*)nv, (const float*)bound, (bf16*)out, qs, ks, vs, os, es,
        H, Nq, Nkv, n_null);
    return (int)cudaGetLastError();
}

}  // namespace

VIT_API int vit_flash_static_int8_fwd(
    const void* q8, const void* k8, const void* v, const void* qe,
    const void* qn, const void* nk, const void* nv, const void* bound,
    void* out, long long qsb, long long qsh, long long qsn, long long ksb,
    long long ksh, long long ksn, long long vsb, long long vsh, long long vsn,
    long long osb, long long osh, long long osn, long long esb,
    long long esh, long long esn, int B, int H, int Nq, int Nkv, int n_null,
    int D, void* stream) {
    if (Nkv < 0 || n_null < 0 || n_null > MAX_NULL || Nkv + n_null < 1)
        return (int)cudaErrorInvalidValue;
    const Strides qs{qsb, qsh, qsn}, ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn},
        os{osb, osh, osn}, es{esb, esh, esn};
    switch (D) {
        case 32:
            return launch_d<32>(q8, k8, v, qe, qn, nk, nv, bound, out, qs, ks,
                                vs, os, es, B, H, Nq, Nkv, n_null, stream);
        case 64:
            return launch_d<64>(q8, k8, v, qe, qn, nk, nv, bound, out, qs, ks,
                                vs, os, es, B, H, Nq, Nkv, n_null, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
