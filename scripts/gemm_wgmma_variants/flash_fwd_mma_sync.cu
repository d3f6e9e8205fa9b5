// The parent design of csrc/flash_fwd.cu, before K1 and K15 moved onto
// TMA and wgmma (kept for scripts/gemm_wgmma_trial.py --variants: the
// parent's time and its ablations, no exps, no products, the stream alone,
// beside the shipped design's): four warps of 32 queries, mma.sync
// m16n8k16 products from ldmatrix fragments, K and V in 64-key tiles
// through a 3-stage cp.async ring, three blocks an SM.  It has the shipped
// source's C entry points.
// K1 and K15: attention forward, one kernel template with two softmax
// policies.  Replaces, in vit_exp_tpu/ops/flash_attention.py:
// - running max (K15): ::_fwd_kernel (``_flash_fwd``, reached through
//   ``_flash_core`` with null_strategy="concat": the null kv are ordinary
//   keys 0 .. n_null-1 of every (batch, head)).  p = exp(q·k·scale − m), m
//   the running row max; l sums the fp32 p, only the P·V operand is p
//   rounded to bf16; lse = m + log l;
// - static bound (K1): ::_fwd_kernel_static (``_flash_fwd_static``).  p =
//   bf16(exp(q·k·scale − B)) with B a traced bound on every logit (no
//   running max); up to 8 nulls per head, shared by the batch, seed O and
//   l; l sums the bf16-rounded p (the TPU kernel's ones column in v);
//   lse = B + log l.
// out = O / l in bf16; lse (natural-log units, fp32, (batch·head, Nq)) only
// when the pointer is not null: the statistic the backward pair
// (flash_bwd.cu) recomputes p from.  q, k, v and out are addressed through
// (batch, head, row) strides with a contiguous head dim D of 16, 32 or 64,
// one template instance each (the wrapper zero-pads any other d ≤ 64 to the
// next instance: zero columns change neither S nor P·V, and the padded
// output columns are dropped).
//
// What bounds it.  Per logit: two products of 2·32 operations on the
// tensor cores (0.79 ms at the production shape, 6.12 G logits per layer,
// at the bf16 peak; mma.sync reaches a part of that) and one exp on the
// special-function unit, 16 per clock per SM: ≈ 1.65 ms per layer at
// 1.755 GHz, the tighter of the two.  Around them a handful of fp32
// operations (scale, max, sum, pack).  The design keeps everything else off
// the critical path (it is the backward pair's, flash_bwd.cu):
// - S, p and O never leave registers.  Products are PTX mma.sync.m16n8k16
//   (bf16 in, fp32 accumulate); two adjacent n8 accumulator tiles of p,
//   packed to bf16, are exactly one k16 A fragment of P·V.  K15 rescales O
//   and l in registers once per tile.  The row max is a quad reduction (two
//   shfl_xor over the 4 lanes of a row); l stays per lane and is reduced
//   once at the end (its partial sums share the row's rescale).
// - 4 warps of 32 query rows (two m16 tiles), 128 queries per block: every
//   K and V fragment read by ldmatrix serves 32 queries.  Q's A fragments
//   are loaded once and stay in registers.
// - K and V stream in 64-key tiles through a 3-stage cp.async ring
//   (16-byte cp.async.cg, zero fill past the end): tile t + 2 loads while
//   tile t computes, one barrier per tile.  Rows padded to 80 bytes, so
//   ldmatrix is conflict-free.
// - p = ex2.approx(S · scale·log2e − m·log2e): one FFMA and one MUFU per
//   logit; m is kept in log2 units (K1: the per-block constant B·log2e).
//   A p below 2^-126 flushes to 0: K15's p are relative to the row max;
//   K1's are rounded to bf16, whose denormals stop at 2^-133.
// - Masking: keys ≥ Nkv (zero-filled) get S = −∞, only in the last tile (a
//   uniform branch); query rows past Nq are zero-filled and never stored.
//   K1's nulls are one extra 16-key tile staged once beside Q and masked
//   past n_null: the same code path as a kv tile, a quarter of one tile's
//   work, against a per-lane fp32 loop over the nulls.
// - No atomics: two launches on the same inputs give the same bits.
// - Registers: __launch_bounds__ asks for three blocks (12 warps) per SM,
//   a cap of 168.  At D 32, O is 32 fp32 per lane, Q's fragments 16, a
//   64-key S 64.  K1 takes a 64-key tile in one pass (156 registers on an
//   H100 build); K15 also keeps its rescale live beside S and spilled at 64
//   keys, so it takes two 32-key passes per tile (168, no spill).  Two
//   blocks per SM with one 64-key pass ran slower in a trial; four blocks
//   (a cap of 128) spill.  D 16 keeps D 32's tiling with half of O and Q.
//   D 64 would double O and Q at 32 rows a warp, so a warp owns 16 query
//   rows (one m16 tile: O 32 fp32, Q 16 registers, as at D 32) and K/V
//   stream in 32-key tiles, which keeps the ring in 48 KB of static shared
//   memory.  The ptxas counts are in build/torch_kernels/*.log.
#include "attn_mma.cuh"

namespace vit {

// the fragment loads and S product that only this design used (they left
// attn_mma.cuh with it)
// two 8 × 8 bf16 matrices; lanes 0-7 and 8-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_u32(p))
        : "memory");
}

// A fragments of a warp's MT m16 tiles of staged rows (MT · 16 rows × D/16
// k16 steps over the head dim)
template <int MT, int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][D / 16][4],
                                       const bf16* s, int lane) {
    constexpr int LDT = att_ldt<D>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
            ldsm_x4(a[mt][ks], s + (mt * 16 + (lane & 15)) * LDT + ks * 16 +
                                   (lane >> 4) * 8);
}

// S (the warp's MT · 16 rows × tile rows r0..r0+7, one n8 tile) = A·tileᵀ
// over the head dim; the B fragments are plain ldmatrix loads of the 8 tile
// rows: {b0, b1} of k step 0, then of k step 1, ... (D 16: one .x2; else
// one .x4 per 32 dims)
template <int MT, int D>
__device__ __forceinline__ void rows_times_rows(
    float (&s)[MT][4], const uint32_t (&a)[MT][D / 16][4], const bf16* tile,
    int r0, int lane) {
    constexpr int LDT = att_ldt<D>();
    if constexpr (D == 16) {
        uint32_t b[2];
        ldsm_x2(b, tile + (r0 + (lane & 7)) * LDT + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
            mma(s[mt], a[mt][0], b[0], b[1]);
        }
    } else {
        uint32_t b[D / 32][4];
#pragma unroll
        for (int kc = 0; kc < D / 32; ++kc)
            ldsm_x4(b[kc], tile + (r0 + (lane & 7)) * LDT + kc * 32 +
                               (lane >> 3) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
#pragma unroll
            for (int kc = 0; kc < D / 32; ++kc) {
                mma(s[mt], a[mt][2 * kc], b[kc][0], b[kc][1]);
                mma(s[mt], a[mt][2 * kc + 1], b[kc][2], b[kc][3]);
            }
        }
    }
}

}  // namespace vit

using namespace vit;

namespace {

constexpr int NULL_ROWS = 16;    // K1's nulls: one k16 tile
constexpr int MAX_NULL = 8;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;        // depth of the cp.async ring
constexpr int MIN_BLOCKS = 3;    // per SM, for __launch_bounds__
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the tiling of head dim D: MT m16 tiles of query rows a warp (32 rows at
// D 16 and 32, 16 at D 64), BKV keys a streamed tile, and the keys a warp
// takes through S → p → P·V at once: a whole tile (K1) or 32 (K15)
template <int D>
struct FwdCfg {
    static constexpr int LDT = att_ldt<D>();
    static constexpr int MT = D == 64 ? 1 : 2;
    static constexpr int WR = 16 * MT;          // query rows a warp owns
    static constexpr int BQ = WARPS * WR;       // query rows a block owns
    static constexpr int BKV = D == 64 ? 32 : 64;
    static constexpr int SUB_STATIC = BKV, SUB_ONLINE = 32;
};

struct Strides {
    long long b, h, n;
};

template <int D>
struct Smem {
    bf16 q[FwdCfg<D>::BQ * FwdCfg<D>::LDT];
    bf16 nk[NULL_ROWS * FwdCfg<D>::LDT];
    bf16 nv[NULL_ROWS * FwdCfg<D>::LDT];
    bf16 k[STAGES][FwdCfg<D>::BKV * FwdCfg<D>::LDT];
    bf16 v[STAGES][FwdCfg<D>::BKV * FwdCfg<D>::LDT];
};

__device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
}

// One tile of KEYS keys staged at pitch LDT (ks, vs) against the warp's
// MT·16 queries (qa).  MASK: keys at or past kv_left are not keys (the last
// kv tile, K1's nulls).  ONLINE (K15): m is the running row max in log2
// units, O and l are rescaled by ex2(m_old − m_new); else (K1) m holds
// B·log2e and never moves, and l sums the bf16-rounded p.  Lane (g, t)
// holds rows g and g + 8 of each m16 tile (index half), keys 2t, 2t + 1 of
// each n8 tile.
template <int KEYS, bool MASK, bool ONLINE, int D, int MT>
__device__ __forceinline__ void attend_tile(float (&o)[MT][D / 8][4],
                                            float (&m)[MT][2],
                                            float (&l)[MT][2],
                                            const uint32_t (&qa)[MT][D / 16][4],
                                            const bf16* ks, const bf16* vs,
                                            int kv_left, float c2, int lane) {
    constexpr int NT = KEYS / 8;
    const int t = lane & 3;
    float s[NT][MT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
        rows_times_rows<MT, D>(s[j], qa, ks, j * 8, lane);
    if (MASK) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (j * 8 + 2 * t + (e & 1) >= kv_left)
                        s[j][mt][e] = neg_inf();
    }
    if (ONLINE) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                float mx = neg_inf();
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    mx = fmaxf(mx, fmaxf(s[j][mt][2 * half],
                                         s[j][mt][2 * half + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                // finite: the pass's first key is a key
                const float m_new = fmaxf(m[mt][half], mx * c2);
                const float corr = exp2_approx(m[mt][half] - m_new);
                m[mt][half] = m_new;
                l[mt][half] *= corr;
#pragma unroll
                for (int nt = 0; nt < D / 8; ++nt) {
                    o[mt][nt][2 * half] *= corr;
                    o[mt][nt][2 * half + 1] *= corr;
                }
            }
    }
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                float p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    p[e] = exp2_approx(fmaf(s[j][mt][e], c2, -m[mt][e >> 1]));
                const uint32_t lo = pack_bf16(p[0], p[1]);
                const uint32_t hi = pack_bf16(p[2], p[3]);
                pa[mt][2 * jj] = lo;
                pa[mt][2 * jj + 1] = hi;
                if (ONLINE) {
                    l[mt][0] += p[0] + p[1];
                    l[mt][1] += p[2] + p[3];
                } else {   // the bf16 values the P·V operand holds
                    l[mt][0] += __uint_as_float(lo << 16) +
                                __uint_as_float(lo & 0xffff0000u);
                    l[mt][1] += __uint_as_float(hi << 16) +
                                __uint_as_float(hi & 0xffff0000u);
                }
            }
        }
        acc_times_tile<MT, D>(o, pa, vs, kk * 16, lane);   // O += P·V
    }
}

// one block per (BQ queries, batch·head); warp w owns queries WR·w ..;
// each staged tile goes through attend_tile in passes of SUB keys
template <bool ONLINE, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ nk,
                 const bf16* __restrict__ nv,
                 const float* __restrict__ bound_ptr, bf16* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 Strides os, int H, int Nq, int Nkv, int n_null, float scale) {
    using C = FwdCfg<D>;
    constexpr int MT = C::MT, WR = C::WR, BQ = C::BQ, BKV = C::BKV;
    constexpr int LDT = C::LDT;
    constexpr int SUB = ONLINE ? C::SUB_ONLINE : C::SUB_STATIC;
    __shared__ __align__(128) Smem<D> sm;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;
    const float c2 = scale * LOG2E;

    // the first group: the block's queries and K1's nulls
    copy_rows<BQ, THREADS, D>(sm.q, q + b * qs.b + h * qs.h, qs.n, q0, Nq,
                              tid);
    if (!ONLINE && n_null > 0) {
        const size_t n0 = (size_t)h * n_null * D;
        copy_rows<NULL_ROWS, THREADS, D>(sm.nk, nk + n0, D, 0, n_null, tid);
        copy_rows<NULL_ROWS, THREADS, D>(sm.nv, nv + n0, D, 0, n_null, tid);
    }
    cp_async_commit();

    const int n_tiles = (Nkv + BKV - 1) / BKV;
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            const int st = tile % STAGES;
            copy_rows<BKV, THREADS, D>(sm.k[st], kb, ks.n, tile * BKV, Nkv,
                                       tid);
            copy_rows<BKV, THREADS, D>(sm.v[st], vb, vs.n, tile * BKV, Nkv,
                                       tid);
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    cp_async_wait<STAGES - 1>();   // this thread's queries and nulls
    __syncthreads();
    uint32_t qa[MT][D / 16][4];
    load_a<MT, D>(qa, sm.q + warp * WR * LDT, lane);

    float o[MT][D / 8][4], m[MT][2], l[MT][2];
    const float m0 = ONLINE ? neg_inf() : *bound_ptr * LOG2E;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            m[mt][half] = m0;
            l[mt][half] = 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
    }
    if (!ONLINE && n_null > 0)
        attend_tile<NULL_ROWS, true, false, D, MT>(o, m, l, qa, sm.nk, sm.nv,
                                                   n_null, c2, lane);

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of the tile
        __syncthreads();   // every copy visible; the oldest stage is free
        issue(tile + STAGES - 1);
        const bf16* kt = sm.k[tile % STAGES];
        const bf16* vt = sm.v[tile % STAGES];
        const int kv_left = Nkv - tile * BKV;
        if (kv_left >= BKV) {
#pragma unroll
            for (int c = 0; c < BKV / SUB; ++c)
                attend_tile<SUB, false, ONLINE, D, MT>(
                    o, m, l, qa, kt + c * SUB * LDT, vt + c * SUB * LDT, SUB,
                    c2, lane);
        } else {   // the last tile: passes holding a key, masked
            for (int c = 0; c * SUB < kv_left; ++c)
                attend_tile<SUB, true, ONLINE, D, MT>(
                    o, m, l, qa, kt + c * SUB * LDT, vt + c * SUB * LDT,
                    kv_left - c * SUB, c2, lane);
        }
    }
    cp_async_wait<0>();

    // out = O / l; lse = m + log l (K1: B + log l)
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
            if (lse != nullptr && t == 0)
                lse[(size_t)blockIdx.y * Nq + row] =
                    (ONLINE ? m[mt][half] * LN2 : *bound_ptr) + logf(lt);
        }
}

template <int D>
constexpr bool smem_fits() {
    using C = FwdCfg<D>;
    return sizeof(Smem<D>) <= 48 * 1024 &&
           sizeof(bf16) * C::BKV * C::LDT % 16 == 0 &&
           sizeof(bf16) * C::BQ * C::LDT % 16 == 0 &&
           sizeof(bf16) * NULL_ROWS * C::LDT % 16 == 0 &&
           C::BKV % C::SUB_STATIC == 0 && C::BKV % C::SUB_ONLINE == 0;
}
static_assert(smem_fits<16>() && smem_fits<32>() && smem_fits<64>(),
              "static shared memory, 16-byte aligned stages, whole passes");

template <bool ONLINE, int D>
int launch_d(const void* q, const void* k, const void* v, const void* nk,
             const void* nv, const void* bound, void* out, void* lse,
             Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
             int Nq, int Nkv, int n_null, float scale, void* stream) {
    dim3 grid((Nq + FwdCfg<D>::BQ - 1) / FwdCfg<D>::BQ, B * H);
    flash_fwd_kernel<ONLINE, D><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)nk,
        (const bf16*)nv, (const float*)bound, (bf16*)out, (float*)lse, qs, ks,
        vs, os, H, Nq, Nkv, n_null, scale);
    return (int)cudaGetLastError();
}

// K1 (ONLINE false) or K15 at head dim D (16, 32 or 64)
template <bool ONLINE>
int launch(const void* q, const void* k, const void* v, const void* nk,
           const void* nv, const void* bound, void* out, void* lse,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int Nq, int Nkv, int n_null, int D, float scale, void* stream) {
    // K15 needs a key in every row; K1 may run on its nulls alone
    if (Nkv < (ONLINE ? 1 : 0) || n_null < 0 || n_null > MAX_NULL)
        return (int)cudaErrorInvalidValue;
    switch (D) {
        case 16:
            return launch_d<ONLINE, 16>(q, k, v, nk, nv, bound, out, lse, qs,
                                        ks, vs, os, B, H, Nq, Nkv, n_null,
                                        scale, stream);
        case 32:
            return launch_d<ONLINE, 32>(q, k, v, nk, nv, bound, out, lse, qs,
                                        ks, vs, os, B, H, Nq, Nkv, n_null,
                                        scale, stream);
        case 64:
            return launch_d<ONLINE, 64>(q, k, v, nk, nv, bound, out, lse, qs,
                                        ks, vs, os, B, H, Nq, Nkv, n_null,
                                        scale, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

VIT_API int vit_flash_static_fwd(
    const void* q, const void* k, const void* v, const void* nk,
    const void* nv, const void* bound, void* out, void* lse, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, int B, int H, int Nq, int Nkv, int n_null, int D,
    float scale, void* stream) {
    return launch<false>(q, k, v, nk, nv, bound, out, lse,
                         Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
                         Strides{vsb, vsh, vsn}, Strides{osb, osh, osn}, B, H,
                         Nq, Nkv, n_null, D, scale, stream);
}

VIT_API int vit_flash_online_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long qsb, long long qsh, long long qsn, long long ksb, long long ksh,
    long long ksn, long long vsb, long long vsh, long long vsn, long long osb,
    long long osh, long long osn, int B, int H, int Nq, int Nkv, int D,
    float scale, void* stream) {
    return launch<true>(q, k, v, nullptr, nullptr, nullptr, out, lse,
                        Strides{qsb, qsh, qsn}, Strides{ksb, ksh, ksn},
                        Strides{vsb, vsh, vsn}, Strides{osb, osh, osn}, B, H,
                        Nq, Nkv, 0, D, scale, stream);
}
