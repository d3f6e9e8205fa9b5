// Static-max attention backward: dk/dv and dq.  Replaces
// vit_exp_tpu/ops/flash_attention.py::_bwd_fused_kernel (exact tiling) and
// ::_dq_kernel / ::_dkv_kernel (ragged kv).
//
// With lse = B + log l from the forward (flash_fwd.cu, K1 or K15),
// for one (batch, head):  p = exp(q·k·scale − lse),  δ = rowsum(dO ⊙ O)
// (from the caller),  dV = bf16(p)ᵀ dO,  dS = bf16(p ⊙ (dO Vᵀ − δ) · scale),
// dK = dSᵀ Q,  dQ = dS K.  Head dim D of 16, 32 or 64 (one template
// instance each; the wrappers zero-pad any other d ≤ 64 to the next one),
// fp32 accumulators, bf16 operands, rounding points as in the TPU kernel.
//
// The TPU kernel sweeps (q block, kv block) pairs in order and keeps
// full-sequence fp32 dk/dv in VMEM.  Blocks here run in no order, so the
// work is split as the TPU's ragged pair is: one kernel parallel over kv
// (each block owns 128 keys and walks every 64-query tile; dK and dV stay in
// registers), one parallel over q (each block owns 128 queries and walks
// every 64-key tile; dQ stays in registers).  No atomics: the gradients are
// bit-reproducible.  Each logit is recomputed once per kernel, so the pair
// costs 7 products per (q, kv) pair against the TPU sweep's 5.
//
// What bounds it.  Per logit the pair does 7 · 2 · 32 tensor-core operations
// on mma.sync (no wgmma here) and, in each kernel, one exp on the
// special-function unit (16 per clock per SM) plus a handful of fp32
// operations for p and dS.  The design keeps everything else off the
// critical path:
// - S, dP, p and dS never leave registers.  Products are PTX
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the accumulator layout of
//   two adjacent n8 tiles, packed to bf16, is exactly one k16 A fragment, so
//   p and dS feed the next product straight from registers.
// - Each warp owns 32 rows (two m16 tiles), so every B fragment read from
//   shared memory by ldmatrix serves 32 keys (or queries): 8 bytes of
//   shared-memory traffic per logit in dK/dV, 6 in dQ.
// - Tiles stream through a 3-stage cp.async ring (16-byte cp.async.cg, zero
//   fill past the end): tile t + 2 loads while tile t computes.  Rows are
//   padded to a pitch of 40 bf16 (80 bytes), so the 8 row addresses of an
//   ldmatrix fall on 8 distinct groups of 4 banks: conflict-free.
// - p = ex2.approx(S · scale·log2e − lse·log2e): one FFMA and one MUFU per
//   logit (exp2f minus its denormal path: a p below 2^-126 flushes to 0).
//   lse·log2e is taken once per query (dK/dV: in the ring, by the thread
//   that copied it; dQ: in registers for the thread's rows).
// - Masking: a query row past Nq gets lse = +inf in the ring, so its p and
//   dS are exactly 0 (its q and dO rows are zero-filled: no inf·0); in dQ,
//   keys past Nkv (only in the last tile, a uniform branch) get dS = 0.
//   Rows past the end are never stored.
// - Registers: 4 warps of 32 rows (16 at D 64, where the A fragments and
//   accumulators of 32 rows would double), and __launch_bounds__ caps a
//   thread at 168 registers so that three blocks (12 warps) share an SM.  Fully
//   unrolled, the chunk loops spill at that cap, so dK/dV unrolls its
//   16-row chunks by 2 and dQ not at all; half the block streams each
//   tensor of a tile, so a thread keeps one source pointer through the
//   loop.  The ptxas log in build/torch_kernels/*.log gives the counts
//   (dK/dV 168, dQ 136, no spills).
// q, k, v, dO and the gradients are addressed through (batch, head, row)
// strides with a contiguous head dim.
#include "attn_mma.cuh"

using namespace vit;

namespace {

constexpr int BT = 64;         // rows of a streamed tile (queries or keys)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;      // depth of the cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

// the tiling of head dim D: MT m16 tiles of rows a warp (32 rows at D 16
// and 32; 16 at D 64, so that the A fragments and the accumulators take
// the registers they take at D 32), BR rows a block
template <int D>
struct BwdCfg {
    static constexpr int LDT = att_ldt<D>();   // bf16 pitch of a staged row
    static constexpr int MT = D == 64 ? 1 : 2;
    static constexpr int WR = 16 * MT;         // rows a warp owns
    static constexpr int BR = WARPS * WR;      // rows a block owns
};

struct Strides {
    long long b, h, n;
};

// one stage of the dK/dV ring: a q tile, its dO tile, lse·log2e and δ
template <int D>
struct DkvStage {
    bf16 q[BT * att_ldt<D>()];
    bf16 o[BT * att_ldt<D>()];
    float lse[BT];
    float delta[BT];
};

// one stage of the dQ ring: a k tile and its v tile
template <int D>
struct DqStage {
    bf16 k[BT * att_ldt<D>()];
    bf16 v[BT * att_ldt<D>()];
};

// ROWS rows of a (row, D) bf16 matrix copied by half the block (rows row0..
// of src, row stride sn, into dst at pitch LDT, zero past nrows): with CH =
// D / 8 chunks a row, thread tid copies chunk tid % CH of rows (tid % 64) /
// CH + (64 / CH)·i.  Each half of the block streams one tensor, so a thread
// keeps one source pointer and one stride; row offsets are 32-bit (the
// wrappers check rows · stride < 2^31), which keeps dK/dV under the
// register cap without a spill.
template <int ROWS, int D>
__device__ __forceinline__ void load_half(bf16* dst, const bf16* src, int sn,
                                          int row0, int nrows, int tid) {
    constexpr int SHIFT = att_chunk_shift<D>(), CH = 1 << SHIFT;
    constexpr int LDT = att_ldt<D>();
    const int cv = tid & (CH - 1);
#pragma unroll
    for (int i = 0; i < ROWS * CH / (THREADS / 2); ++i) {
        const int r = ((tid & (THREADS / 2 - 1)) >> SHIFT) +
                      (THREADS / 2 / CH) * i;
        const bool ok = row0 + r < nrows;
        cp_async16(dst + r * LDT + cv * 8,
                   ok ? src + (row0 + r) * sn + cv * 8 : src, ok);
    }
}

// the warp's MT·16 rows × D of acc as bf16, rows at or past nrows skipped
template <int MT, int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long sn, int row0,
                                           int nrows,
                                           const float (&acc)[MT][D / 8][4],
                                           int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = row0 + mt * 16 + half * 8 + g;
            if (row >= nrows) continue;
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt)
                *reinterpret_cast<uint32_t*>(dst + row * sn + nt * 8 + 2 * t) =
                    pack_bf16(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
}

// dK, dV: one block per (BR keys, batch·head); warp w owns keys WR·w ...
// Per 16-query chunk of a tile: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (WR keys × 16
// queries) in registers, p and dS formed there, then dV += Pᵀ dO and dK +=
// dSᵀ Q.
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                     Strides os, Strides dks, Strides dvs, int H, int Nq,
                     int Nkv, float scale) {
    using C = BwdCfg<D>;
    constexpr int MT = C::MT, WR = C::WR, BR = C::BR, LDT = C::LDT;
    extern __shared__ __align__(128) unsigned char smem[];
    DkvStage<D>* ring = reinterpret_cast<DkvStage<D>*>(smem);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int t = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int k0 = blockIdx.x * BR;
    const float c2 = scale * LOG2E;
    // threads 0-63 stream q and lse, threads 64-127 dO and δ
    const bool lo = tid < BT;
    const bf16* src = lo ? q + b * qs.b + h * qs.h : dout + b * os.b + h * os.h;
    const int sn = lo ? qs.n : os.n;
    const float* stat = (lo ? lse : delta) + (size_t)blockIdx.y * Nq;
    const int r = tid & (BT - 1);

    // the block's keys (threads 0-63) and values (64-127) as A fragments,
    // staged once through the ring's memory
    {
        bf16* Ks = reinterpret_cast<bf16*>(smem);
        load_half<BR, D>(lo ? Ks : Ks + BR * LDT,
                         lo ? k + b * ks.b + h * ks.h : v + b * vs.b + h * vs.h,
                         lo ? ks.n : vs.n, k0, Nkv, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    }
    uint32_t ka[MT][D / 16][4], va[MT][D / 16][4];
    load_a<MT, D>(ka, reinterpret_cast<bf16*>(smem) + warp * WR * LDT, lane);
    load_a<MT, D>(va, reinterpret_cast<bf16*>(smem) + (BR + warp * WR) * LDT,
                  lane);
    __syncthreads();   // the ring takes the memory over

    const int n_tiles = (Nq + BT - 1) / BT;
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            DkvStage<D>& st = ring[tile % STAGES];
            const int q0 = tile * BT;
            load_half<BT, D>(lo ? st.q : st.o, src, sn, q0, Nq, tid);
            float* dst = lo ? st.lse : st.delta;
            if (q0 + r < Nq) cp_async4(dst + r, stat + q0 + r);
            // a padded query: lse = +inf makes its p and dS exactly 0
            else dst[r] = lo ? __int_as_float(0x7f800000) : 0.f;
        }
        cp_async_commit();   // an empty group past the end keeps the count
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    float dka[MT][D / 8][4], dva[MT][D / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[mt][nt][e] = dva[mt][nt][e] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of the tile
        DkvStage<D>& st = ring[tile % STAGES];
        if (lo) st.lse[r] *= LOG2E;   // the element this thread copied
        __syncthreads();   // every copy visible; the oldest stage is free
        issue(tile + STAGES - 1);

#pragma unroll 2   // fully unrolled, ptxas spills at the 168 cap
        for (int kk = 0; kk < BT / 16; ++kk) {
            // per n8 tile j of 8 queries: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, then
            // p and dS in place; two n8 tiles of bf16 pairs = one k16 A
            uint32_t pa[MT][4], dsa[MT][4];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int r0 = kk * 16 + j * 8;
                float s[MT][4], dp[MT][4];
                rows_times_rows<MT, D>(s, ka, st.q, r0, lane);
                rows_times_rows<MT, D>(dp, va, st.o, r0, lane);
                const float2 L =
                    *reinterpret_cast<const float2*>(&st.lse[r0 + 2 * t]);
                const float2 dl =
                    *reinterpret_cast<const float2*>(&st.delta[r0 + 2 * t]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    float p[4], ds[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const bool odd = e & 1;
                        p[e] = exp2_approx(
                            fmaf(s[mt][e], c2, -(odd ? L.y : L.x)));
                        ds[e] = p[e] * (dp[mt][e] - (odd ? dl.y : dl.x))
                                * scale;
                    }
                    pa[mt][2 * j] = pack_bf16(p[0], p[1]);
                    pa[mt][2 * j + 1] = pack_bf16(p[2], p[3]);
                    dsa[mt][2 * j] = pack_bf16(ds[0], ds[1]);
                    dsa[mt][2 * j + 1] = pack_bf16(ds[2], ds[3]);
                }
            }
            acc_times_tile<MT, D>(dva, pa, st.o, kk * 16, lane);   // dV += Pᵀ dO
            acc_times_tile<MT, D>(dka, dsa, st.q, kk * 16, lane);  // dK += dSᵀ Q
        }
    }
    cp_async_wait<0>();

    const int kr = k0 + warp * WR;
    store_rows<MT, D>(dk + b * dks.b + h * dks.h, dks.n, kr, Nkv, dka, lane);
    store_rows<MT, D>(dv + b * dvs.b + h * dvs.h, dvs.n, kr, Nkv, dva, lane);
}

// one 64-key tile of the dQ kernel; MASK: the tile holds keys past Nkv
// (kv_left of its rows are real)
template <bool MASK, int MT, int D>
__device__ __forceinline__ void dq_tile(float (&dqa)[MT][D / 8][4],
                                        const uint32_t (&qa)[MT][D / 16][4],
                                        const uint32_t (&oa)[MT][D / 16][4],
                                        const float (&L)[MT][2],
                                        const float (&dl)[MT][2],
                                        const DqStage<D>& st, int kv_left,
                                        float c2, float scale, int lane) {
    const int t = lane & 3;
#pragma unroll 1   // unrolled, ptxas hoists every chunk's loads and spills
    for (int kk = 0; kk < BT / 16; ++kk) {
        // per n8 tile j of 8 keys: S = Q Kᵀ and dP = dO Vᵀ, then dS in place
        uint32_t dsa[MT][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int r0 = kk * 16 + j * 8;
            float s[MT][4], dp[MT][4];
            rows_times_rows<MT, D>(s, qa, st.k, r0, lane);
            rows_times_rows<MT, D>(dp, oa, st.v, r0, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                float ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int half = e >> 1;
                    const float p =
                        exp2_approx(fmaf(s[mt][e], c2, -L[mt][half]));
                    ds[e] = p * (dp[mt][e] - dl[mt][half]) * scale;
                    if (MASK && r0 + 2 * t + (e & 1) >= kv_left) ds[e] = 0.f;
                }
                dsa[mt][2 * j] = pack_bf16(ds[0], ds[1]);
                dsa[mt][2 * j + 1] = pack_bf16(ds[2], ds[3]);
            }
        }
        acc_times_tile<MT, D>(dqa, dsa, st.k, kk * 16, lane);   // dQ += dS K
    }
}

// dQ: one block per (BR queries, batch·head); warp w owns queries WR·w ..,
// with their lse·log2e and δ in registers.
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dqs, int H, int Nq, int Nkv, float scale) {
    using C = BwdCfg<D>;
    constexpr int MT = C::MT, WR = C::WR, BR = C::BR, LDT = C::LDT;
    extern __shared__ __align__(128) unsigned char smem[];
    DqStage<D>* ring = reinterpret_cast<DqStage<D>*>(smem);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BR;
    const float c2 = scale * LOG2E;
    // threads 0-63 stream k, threads 64-127 v
    const bool lo = tid < BT;
    const bf16* src = lo ? k + b * ks.b + h * ks.h : v + b * vs.b + h * vs.h;
    const int sn = lo ? ks.n : vs.n;

    // the block's queries (threads 0-63) and output gradients (64-127)
    {
        bf16* Qs = reinterpret_cast<bf16*>(smem);
        load_half<BR, D>(lo ? Qs : Qs + BR * LDT,
                         lo ? q + b * qs.b + h * qs.h
                            : dout + b * os.b + h * os.h,
                         lo ? qs.n : os.n, q0, Nq, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    }
    uint32_t qa[MT][D / 16][4], oa[MT][D / 16][4];
    load_a<MT, D>(qa, reinterpret_cast<bf16*>(smem) + warp * WR * LDT, lane);
    load_a<MT, D>(oa, reinterpret_cast<bf16*>(smem) + (BR + warp * WR) * LDT,
                  lane);
    __syncthreads();

    // lse·log2e and δ of the thread's rows g and g + 8 of each m16 tile;
    // 0 past Nq (those rows' q and dO are zero, so p = 1 and dS = 0)
    float L[MT][2], dl[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int qi = q0 + warp * WR + mt * 16 + half * 8 + g;
            const size_t i = (size_t)blockIdx.y * Nq + qi;
            L[mt][half] = qi < Nq ? lse[i] * LOG2E : 0.f;
            dl[mt][half] = qi < Nq ? delta[i] : 0.f;
        }

    const int n_tiles = (Nkv + BT - 1) / BT;
    auto issue = [&](int tile) {
        if (tile < n_tiles) {
            DqStage<D>& st = ring[tile % STAGES];
            load_half<BT, D>(lo ? st.k : st.v, src, sn, tile * BT, Nkv, tid);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    float dqa[MT][D / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dqa[mt][nt][e] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        issue(tile + STAGES - 1);
        const DqStage<D>& st = ring[tile % STAGES];
        const int kv_left = Nkv - tile * BT;
        if (kv_left >= BT)
            dq_tile<false, MT, D>(dqa, qa, oa, L, dl, st, kv_left, c2, scale,
                                  lane);
        else
            dq_tile<true, MT, D>(dqa, qa, oa, L, dl, st, kv_left, c2, scale,
                                 lane);
    }
    cp_async_wait<0>();

    store_rows<MT, D>(dq + b * dqs.b + h * dqs.h, dqs.n, q0 + warp * WR, Nq,
                      dqa, lane);
}

// the rings' dynamic shared memory (D 32: 32,256 and 30,720 bytes); the
// ring first holds the block's own two BR-row tiles
template <int D>
constexpr int dkv_smem() {
    return STAGES * (int)sizeof(DkvStage<D>);
}
template <int D>
constexpr int dq_smem() {
    return STAGES * (int)sizeof(DqStage<D>);
}
template <int D>
constexpr bool rings_fit() {
    constexpr int own = 2 * BwdCfg<D>::BR * att_ldt<D>() * (int)sizeof(bf16);
    return dkv_smem<D>() >= own && dq_smem<D>() >= own &&
           sizeof(DkvStage<D>) % 16 == 0 && sizeof(DqStage<D>) % 16 == 0;
}
static_assert(rings_fit<16>() && rings_fit<32>() && rings_fit<64>(),
              "the ring holds the block's own tiles; 16-byte aligned stages");

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               Strides qs, Strides ks, Strides vs, Strides os, Strides dks,
               Strides dvs, int B, int H, int Nq, int Nkv, float scale,
               void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dkv_smem<D>());
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nkv + BwdCfg<D>::BR - 1) / BwdCfg<D>::BR, B * H);
    flash_bwd_dkv_kernel<D>
        <<<grid, THREADS, dkv_smem<D>(), (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const bf16*)dout, (const float*)lse, (const float*)delta,
            (bf16*)dk, (bf16*)dv, qs, ks, vs, os, dks, dvs, H, Nq, Nkv,
            scale);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, Strides qs,
              Strides ks, Strides vs, Strides os, Strides dqs, int B, int H,
              int Nq, int Nkv, float scale, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dq_smem<D>());
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Nq + BwdCfg<D>::BR - 1) / BwdCfg<D>::BR, B * H);
    flash_bwd_dq_kernel<D>
        <<<grid, THREADS, dq_smem<D>(), (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const bf16*)dout, (const float*)lse, (const float*)delta,
            (bf16*)dq, qs, ks, vs, os, dqs, H, Nq, Nkv, scale);
    return (int)cudaGetLastError();
}

}  // namespace

VIT_API int vit_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, long long dksb, long long dksh, long long dksn,
    long long dvsb, long long dvsh, long long dvsn, int B, int H, int Nq,
    int Nkv, int D, float scale, void* stream) {
    const Strides qs{qsb, qsh, qsn}, ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn},
        os{osb, osh, osn}, dks{dksb, dksh, dksn}, dvs{dvsb, dvsh, dvsn};
    switch (D) {
        case 16:
            return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, qs, ks,
                                  vs, os, dks, dvs, B, H, Nq, Nkv, scale,
                                  stream);
        case 32:
            return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, qs, ks,
                                  vs, os, dks, dvs, B, H, Nq, Nkv, scale,
                                  stream);
        case 64:
            return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, qs, ks,
                                  vs, os, dks, dvs, B, H, Nq, Nkv, scale,
                                  stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

VIT_API int vit_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long qsb,
    long long qsh, long long qsn, long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn, long long osb, long long osh,
    long long osn, long long dqsb, long long dqsh, long long dqsn, int B,
    int H, int Nq, int Nkv, int D, float scale, void* stream) {
    const Strides qs{qsb, qsh, qsn}, ks{ksb, ksh, ksn}, vs{vsb, vsh, vsn},
        os{osb, osh, osn}, dqs{dqsb, dqsh, dqsn};
    switch (D) {
        case 16:
            return launch_dq<16>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                 os, dqs, B, H, Nq, Nkv, scale, stream);
        case 32:
            return launch_dq<32>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                 os, dqs, B, H, Nq, Nkv, scale, stream);
        case 64:
            return launch_dq<64>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                 os, dqs, B, H, Nq, Nkv, scale, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
