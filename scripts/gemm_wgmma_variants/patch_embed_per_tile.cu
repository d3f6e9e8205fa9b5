// Route (a) of csrc/patch_embed.cu's design trial: the video staged in
// every column tile, shared-memory-A wgmma, the statistics summed in the
// lanes from the staged tile (PE_RS false; true gives the shipped
// register-A products without kc multicast), no clusters.  It ran slower
// than the shipped design and is kept for scripts/gemm_wgmma_trial.py
// --variants (stage PE); built alone with -I csrc, it exports the same C
// entry points.
//
// K4 and the patch-embed product: the fused patch embedding.  Replaces
// vit_exp_tpu/ops/patches.py::_stats_kernel (_patch_stats_pallas, K4) and the
// strided product _conv_f32 beside it, with the LayerNorm fix-up of
// fused_patch_embed (patches.py:155-253):
//   token[d] = (Σ_k x_k·kc[d, k] − μ·csum[d])·inv + dvec[d],
//   μ = Σx / n, inv = rsqrt(max(Σbf16(x²) / n − μ², 0) + eps)
// over the patch of n = CPT·p1·p2 voxels of each token, in one pass over
// the video: the patch tensor, an fp32 copy of the video and the fp32
// product never reach device memory.
//
// x: (BT, CPT, H, W) bf16; token (bt, hi, wi) owns the window
// x[bt, :, hi·p1 .., wi·p2 ..].  An implicit GEMM: M = tokens, N = D, K = n
// in the reference feature order k = (ch·p1 + r)·p2 + j.  kc: (D, n) bf16,
// an index-major B operand read by TMA.  Output bf16 (BT, H/p1, W/p2, D),
// and μ and Σbf16(x²), fp32 (BT, H/p1, W/p2), written by the tiles of the
// first 256 columns.
//
// What bounds it at batch 4 (x 442 MB, n 4,000, 55,296 tokens, D 768): the
// 340 GFLOP of the product on the bf16 tensor cores (0.343 ms at 989
// TFLOP/s) more than its 533 MB (0.159 ms at 3.35 TB/s).  The design, on
// gemm_wgmma.cuh's pieces:
// - A persistent grid of one block per SM walks tiles of 128 tokens × 256
//   columns, column tile fastest (the 132 blocks of a wave hold whole token
//   tiles, so a token tile's video is read from device memory about once
//   and from L2 by each of its column tiles).  Two consumer warpgroups of 64
//   tokens issue wgmma m64n256k16 with both operands in shared memory, fp32
//   accumulators in registers (128 a thread); a producer warpgroup fills a
//   ring of PE_STAGES stages of 64 k: kc's 256 × 64 box by TMA (zero past D
//   and n) and the video's A tile by cp.async.
// - No TMA box places a token's patch-row piece: tokens are p2·2 bytes
//   apart in a video row (40 at p2 20), which is no 16-byte stride.  So the
//   producer's 128 threads copy the pieces themselves, 8 bytes at a time (4
//   where p2 % 4 != 0), straight into the 128-byte-swizzled K-major tile
//   that the wgmma descriptor reads (the 16-byte chunk index XOR row % 8).
//   A piece never straddles a chunk or a 64-k step: its offset in k is a
//   multiple of its size.  A half-warp copies one token's 128 bytes of a
//   step, so a warp's copies are two tokens' runs of video rows and its
//   stores fill two whole swizzled rows.  The token tile may straddle patch
//   rows and frames: each token's source offset is computed once a tile
//   into a table in shared memory.  The copies complete on the stage's full
//   barrier (cp.async.mbarrier.arrive.noinc: 128 arrivals beside the TMA
//   thread's), and the consumers fence them into the async proxy
//   (fence.proxy.async) before their wgmmas read them.  Depth past n and
//   tokens past the end are zero-filled (the copy's source size 0).
// - The statistics come from the staged A tile while the stage's wgmmas
//   run: two consumer threads a token row, each half of the step's 128
//   bytes, x and bf16(x²) (one bf16x2 multiply) summed in fp32 in a fixed
//   order, so two launches give the same bits.  Every column tile computes
//   them for its epilogue; the first writes μ and Σx².
// - The epilogue applies the fix-up on the accumulators in the twin's
//   order, without FMA contraction, and the bf16 tile leaves through a
//   swizzled staging by TMA stores, which clip at D and at the last token.
// No atomics: two launches on the same inputs give the same bits.
#include "gemm_wgmma.cuh"

using namespace vit;

namespace {

// 128 tokens × 256 columns, PE_STAGES stages of 64 k; out leaves through a
// staging of PE_PART columns a consumer at a time
constexpr int PE_COLS = 256, PE_STAGES = 4, PE_PART = 64;
// the copies: PE_LPT lanes a token, and a warp's copies at once on
// neighbouring tokens (PE_ADJ) or on tokens 16 apart
constexpr int PE_LPT = 16;
constexpr bool PE_ADJ = true;
// the consumers read A as register fragments (ldmatrix) for register-A
// wgmmas, and sum the statistics on the tensor cores from the same
// fragments (PE_RS); or issue shared-memory wgmmas and sum the statistics
// from the tile in the lanes
constexpr bool PE_RS = false;
// the setmaxnreg split: the producer's copies want more registers than a
// TMA thread
constexpr int PE_PRODUCER_REGS = 40, PE_CONSUMER_REGS = 232;
using PeGemm = WgGemm<PE_COLS, 1, false, false>;
using PeOut = Staging<PE_PART / 64>;
// the token table: a tile's 128 source offsets (elements of x, −1 past the
// last token); then a 1 KB tile of bf16 ones, the statistics' B
constexpr int PE_TABLE_BYTES = TILE_M * 8, PE_ONES_BYTES = 1024;
// a stage fills with the TMA thread's arrival and one cp.async arrival of
// each producer thread, and empties with one arrival of each consumer warp
using PeRing = Ring<PE_STAGES, PeGemm::STAGE_BYTES,
                    2 * PeOut::BYTES + PE_TABLE_BYTES + PE_ONES_BYTES, 1,
                    1 + WG_THREADS, 8>;

struct PeArgs {
    const bf16* x;
    const float* csum;
    const float* dvec;
    float* mu;
    float* sq;
    int CPT, H, W, p1, p2, D, n;
    int ws, tpf, M;   // tpf: tokens of a frame (hs·ws); M: all tokens
    float nf, eps;
};

// CB bytes global → shared (4 or 8: .ca takes both); zero-fill when !valid
template <int CB>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src,
                                               bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(CB), "r"(valid ? CB : 0)
                 : "memory");
}

// arrive on bar once every cp.async this thread issued before is complete
// (the arrival is one the barrier expects: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     bar)
                 : "memory");
}

// x² of two bf16, each product rounded once to bf16 (as bf16_round(x·x))
__device__ __forceinline__ uint32_t sq_bf16x2(uint32_t v) {
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
    b = __hmul2(b, b);
    return *reinterpret_cast<uint32_t*>(&b);
}

// the producer warpgroup's own barrier (id 3)
__device__ __forceinline__ void producer_sync() {
    asm volatile("bar.sync 3, %0;\n" ::"n"(WG_THREADS) : "memory");
}

// the k16 A fragments (wgmma's register A layout) of the consumer's 64 rows
// of a stage's 128-byte-swizzled A tile at `tile`, one ldmatrix.x4 each
__device__ __forceinline__ void load_frags(uint32_t (&a)[4][4],
                                           uint32_t tile) {
    const int lane = threadIdx.x & 31;
    const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const int chunk = 2 * kk + (lane >> 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
            : "r"(tile + row * 128 + ((chunk ^ (row & 7)) << 4))
            : "memory");
    }
}

// keep fragment registers live (unchanged) up to this point: a register-A
// wgmma reads them until a wgmma.wait_group covers it
__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// CB: the bytes of one copy, 8 where p2 % 4 == 0 (a token's patch-row piece
// is 8-byte aligned), else 4
template <int CB>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
patch_embed_kernel(const __grid_constant__ CUtensorMap kc_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const PeArgs a) {
    constexpr int EPC = CB / 2;              // bf16 of one copy
    constexpr int COPIES = STEP_BYTES / CB;  // copies of a token's k step
    extern __shared__ unsigned char smem_raw[];
    PeRing ring(smem_raw);
    ring.init();
    const uint32_t table = ring.extra() + 2 * PeOut::BYTES;
    long long* tok = reinterpret_cast<long long*>(
        smem_raw + (table - smem_u32(smem_raw)));
    const int col_tiles = (a.D + PE_COLS - 1) / PE_COLS;
    const int tiles = (a.M + TILE_M - 1) / TILE_M * col_tiles;

    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs<PE_PRODUCER_REGS, PE_CONSUMER_REGS>();
        // PE_LPT lanes a token: group g of the WG_THREADS / PE_LPT copies
        // tokens g + G·i (PE_ADJ) or g·PE_LPT + i, i < PE_LPT; lane ql of
        // the group copies ql, ql + PE_LPT, .. of a token's step
        constexpr int G = WG_THREADS / PE_LPT;
        static_assert(G % 8 == 0 && PE_LPT % 8 == 0, "a token's row % 8");
        const int pt = threadIdx.x;
        const int g = pt / PE_LPT, ql = pt % PE_LPT;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = t / col_tiles * TILE_M;
            const int n0 = t % col_tiles * PE_COLS;
            producer_sync();   // every thread is done with the last table
            {
                const int T = m0 + pt;
                long long off = -1;
                if (T < a.M) {
                    const int f = T / a.tpf, rem = T - f * a.tpf;
                    const int hi = rem / a.ws, wi = rem - hi * a.ws;
                    off = ((long long)f * a.CPT * a.H + (long long)hi * a.p1) *
                              a.W + (long long)wi * a.p2;
                }
                tok[pt] = off;
            }
            producer_sync();
            for (int k0 = 0; k0 < a.n; k0 += STEP_K) {
                mbar_wait(ring.empty(), ring.phase ^ 1);
                const uint32_t full = ring.full(), st = ring.data();
                if (pt == 0) {
                    mbar_expect_tx(full, PeGemm::B_BYTES);
                    load_tile<false, PE_COLS>(st + PeGemm::A_BYTES, &kc_map,
                                              n0, k0, full);
                }
#pragma unroll 1
                for (int u = 0; u < COPIES / PE_LPT; ++u) {
                    const int q = ql + PE_LPT * u;
                    // depth k = (ch·p1 + r)·p2 + j of the copy
                    const int k = k0 + q * EPC;
                    const int pr = k / a.p2, j = k - pr * a.p2;
                    const int ch = pr / a.p1, r = pr - ch * a.p1;
                    const bool kin = k < a.n;
                    const long long koff =
                        ((long long)ch * a.H + r) * a.W + j;
                    const uint32_t b = q * CB;   // byte of the row
#pragma unroll
                    for (int i = 0; i < PE_LPT; ++i) {
                        const int m = PE_ADJ ? i * G + g : g * PE_LPT + i;
                        const int row7 = PE_ADJ ? g & 7 : i & 7;   // m % 8
                        const long long base = tok[m];
                        const bool ok = kin && base >= 0;
                        cp_async_small<CB>(
                            st + m * 128 + (((b >> 4) ^ row7) << 4) +
                                (b & 15),
                            a.x + (ok ? base + koff : 0), ok);
                    }
                }
                cp_async_arrive(full);
                ring.advance();
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        return;
    }

    consumer_regs<PE_PRODUCER_REGS, PE_CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1;   // consumer 0 or 1
    const int wt = threadIdx.x % WG_THREADS, lane = threadIdx.x & 31;
    // the statistics: token row rr of the consumer's 64, half hb of a step
    const int rr = wt >> 1, hb = wt & 1;
    const PeOut out(ring.extra());
    const uint32_t ones = table + PE_TABLE_BYTES;
    if constexpr (PE_RS) {
        // the ones, written by the consumers' threads and made visible to
        // wgmma (the async proxy) before any reads them
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         ones + 4 * (threadIdx.x - WG_THREADS)),
                     "r"(0x3f803f80u)
                     : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 4, %0;\n" ::"n"(2 * WG_THREADS) : "memory");
    }
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / col_tiles * TILE_M + 64 * cw;
        const int n0 = t % col_tiles * PE_COLS;
        float acc[PeGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < PeGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        // PE_RS: Σx and Σbf16(x²) of each row on the tensor cores (every
        // column of st[0], st[1] holds the row's sum); else in the lanes,
        // low and high halves of the bf16 pairs apart
        float st[2][1][4] = {};
        float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
        uint32_t held = 0;   // the empty barrier of the stage read before
        fence_acc(acc);
        fence_acc(st[0]);
        fence_acc(st[1]);
        if constexpr (PE_RS) {
            for (int k0 = 0; k0 < a.n; k0 += STEP_K) {
                mbar_wait(ring.full(), ring.phase);
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                const uint32_t bt = ring.data() + PeGemm::A_BYTES;
                uint32_t fa[4][4], fq[4][4];
                load_frags(fa, ring.data() + cw * CHUNK_BYTES);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int i = 0; i < 4; ++i) fq[kk][i] = sq_bf16x2(fa[kk][i]);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    WgmmaRS<PE_COLS, 0>::run(acc, fa[kk],
                                             smem_desc<false>(bt + kk * 32));
                    WgmmaRS<8, 0>::run(st[0], fa[kk],
                                       smem_desc<false, 32>(ones));
                    WgmmaRS<8, 0>::run(st[1], fq[kk],
                                       smem_desc<false, 32>(ones));
                }
                wgmma_commit();
                wgmma_wait<0>();
                keep(fa);
                keep(fq);
                __syncwarp();
                if (lane == 0) mbar_arrive(ring.empty());
                ring.advance();
            }
        } else
        for (int k0 = 0; k0 < a.n; k0 += STEP_K) {
            mbar_wait(ring.full(), ring.phase);
            // the producer's cp.async writes reach the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            const uint32_t at = ring.data() + cw * CHUNK_BYTES;
            const uint32_t bt = ring.data() + PeGemm::A_BYTES;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < STEP_BYTES / 32; ++kk)
                Wgmma<PE_COLS, 0, 0>::run(acc, smem_desc<false>(at + kk * 32),
                                          smem_desc<false>(bt + kk * 32));
            wgmma_commit();
            // the row's half step while the products run: 4 chunks of 8
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                uint32_t v[4];
                asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                             : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                             : "r"(at + rr * 128 +
                                   (((hb * 4 + u) ^ (rr & 7)) << 4))
                             : "memory");
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    const uint32_t q = sq_bf16x2(v[w]);
                    s1[0] += __uint_as_float(v[w] << 16);
                    s1[1] += __uint_as_float(v[w] & 0xffff0000u);
                    s2[0] += __uint_as_float(q << 16);
                    s2[1] += __uint_as_float(q & 0xffff0000u);
                }
            }
            wgmma_wait<1>();   // the group before is done: its stage is free
            __syncwarp();
            if (held && lane == 0) mbar_arrive(held);
            held = ring.empty();
            ring.advance();
        }
        wgmma_wait<0>();
        fence_acc(acc);
        fence_acc(st[0]);
        fence_acc(st[1]);
        __syncwarp();
        if (held && lane == 0) mbar_arrive(held);

        // μ and inv of the lane's accumulator rows 16w + g (+ 8)
        auto stats = [&](float sx, float sxx, float& mu, float& inv) {
            mu = __fdiv_rn(sx, a.nf);
            const float var = fmaxf(
                __fsub_rn(__fdiv_rn(sxx, a.nf), __fmul_rn(mu, mu)), 0.f);
            inv = rsqrtf(__fadd_rn(var, a.eps));
        };
        float rm[2], ri[2];
        if constexpr (PE_RS) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                stats(st[0][0][2 * h], st[1][0][2 * h], rm[h], ri[h]);
                const int row = m0 + wg_row(2 * h);
                if (n0 == 0 && (lane & 3) == 0 && row < a.M) {
                    a.mu[row] = rm[h];
                    a.sq[row] = st[1][0][2 * h];
                }
            }
        } else {
            // the row's sums (the pair's in either order agree), then the
            // rows 16w + g (+ 8) held by lanes 2g (+ 16) of the same warp
            float sx = s1[0] + s1[1], sxx = s2[0] + s2[1];
            sx += __shfl_xor_sync(0xffffffffu, sx, 1);
            sxx += __shfl_xor_sync(0xffffffffu, sxx, 1);
            float mu, inv;
            stats(sx, sxx, mu, inv);
            if (n0 == 0 && hb == 0 && m0 + rr < a.M) {
                a.mu[m0 + rr] = mu;
                a.sq[m0 + rr] = sxx;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int src = 2 * (lane >> 2) + 16 * h;
                rm[h] = __shfl_sync(0xffffffffu, mu, src);
                ri[h] = __shfl_sync(0xffffffffu, inv, src);
            }
        }

        // token = (y − μ·csum)·inv + dvec in parts of PE_PART columns (the
        // stores drop what lies past the last token and D)
#pragma unroll
        for (int part = 0; part < PE_COLS / PE_PART; ++part) {
            if (n0 + part * PE_PART >= a.D) break;
            // the part's outputs first, packed, so that the loads of csum
            // and dvec are not held behind the staging's stores
            uint32_t y[PE_PART / 8][2];
#pragma unroll
            for (int j = 0; j < PE_PART / 8; ++j) {
                const int jj = part * PE_PART / 8 + j;
                const int col = n0 + part * PE_PART + wg_col(j, 0);
                const bool in = col < a.D;   // D even: both columns
                const float2 cs =
                    in ? *reinterpret_cast<const float2*>(a.csum + col)
                       : make_float2(0.f, 0.f);
                const float2 dv =
                    in ? *reinterpret_cast<const float2*>(a.dvec + col)
                       : make_float2(0.f, 0.f);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float m = rm[h], iv = ri[h];
                    const float t0 = __fadd_rn(
                        __fmul_rn(__fsub_rn(acc[jj][2 * h], __fmul_rn(m, cs.x)),
                                  iv),
                        dv.x);
                    const float t1 = __fadd_rn(
                        __fmul_rn(
                            __fsub_rn(acc[jj][2 * h + 1], __fmul_rn(m, cs.y)),
                            iv),
                        dv.y);
                    y[j][h] = pack_bf16(t0, t1);
                }
            }
            out.acquire();
#pragma unroll
            for (int j = 0; j < PE_PART / 8; ++j) {
                const int cl = wg_col(j, 0);   // within the part
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    out.put(cl >> 6, wg_row(2 * h), cl & 63, y[j][h]);
            }
            const CUtensorMap* maps[PE_PART / 64];
            int cols[PE_PART / 64];
#pragma unroll
            for (int c = 0; c < PE_PART / 64; ++c) {
                maps[c] = &out_map;
                cols[c] = n0 + part * PE_PART + 64 * c;
            }
            out.release(maps, cols, m0);
        }
    }
    out.drain();
}

template <int CB>
int launch(const CUtensorMap& kc_map, const CUtensorMap& out_map,
           const PeArgs& a, void* stream) {
    cudaError_t e = allow_smem(patch_embed_kernel<CB>, PeRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const long long tiles = (long long)((a.M + TILE_M - 1) / TILE_M) *
                            ((a.D + PE_COLS - 1) / PE_COLS);
    patch_embed_kernel<CB><<<persistent_blocks(tiles), GEMM_THREADS,
                             PeRing::SMEM_BYTES, (cudaStream_t)stream>>>(
        kc_map, out_map, a);
    return (int)cudaGetLastError();
}

}  // namespace

// the dynamic shared memory of a launch on these shapes, or 0 if the kernel
// does not take them: H % p1 == 0, an even p2 with W % p2 == 0 (a token's
// patch-row piece is copied in 4- or 8-byte units), n = CPT·p1·p2 a multiple
// of 8 (kc's pitch is a whole number of 16 bytes, as TMA wants), D a
// multiple of 16, and fewer than 2^31 tokens
VIT_API int vit_patch_embed_check(int BT, int CPT, int H, int W, int p1,
                                  int p2, int D) {
    if (BT < 1 || CPT < 1 || p1 < 1 || H < p1 || H % p1 || p2 < 2 ||
        p2 % 2 || W < p2 || W % p2 || D < 16 || D % 16 ||
        (long long)CPT * p1 * p2 % 8 ||
        (long long)CPT * p1 * p2 > 0x7fffffffLL ||
        (long long)BT * (H / p1) * (W / p2) > 0x7fffffffLL)
        return 0;
    return PeRing::SMEM_BYTES;
}

VIT_API int vit_patch_embed_fwd(const void* x, const void* kc,
                                const void* csum, const void* dvec, void* out,
                                void* mu, void* sq, int BT, int CPT, int H,
                                int W, int p1, int p2, int D, float eps,
                                void* stream) {
    if (vit_patch_embed_check(BT, CPT, H, W, p1, p2, D) == 0)
        return (int)cudaErrorInvalidValue;
    PeArgs a;
    a.x = (const bf16*)x;
    a.csum = (const float*)csum;
    a.dvec = (const float*)dvec;
    a.mu = (float*)mu;
    a.sq = (float*)sq;
    a.CPT = CPT;
    a.H = H;
    a.W = W;
    a.p1 = p1;
    a.p2 = p2;
    a.D = D;
    a.n = CPT * p1 * p2;
    a.ws = W / p2;
    a.tpf = (H / p1) * a.ws;
    a.M = BT * a.tpf;
    a.nf = (float)a.n;
    a.eps = eps;
    // kc (D, n) index-major in boxes of 64 k × 256 rows; out (M, D) in
    // boxes of 64 × 64
    CUtensorMap kc_map, out_map;
    if (!tma_map(&kc_map, kc, D, a.n, a.n, PE_COLS) ||
        !tma_map(&out_map, out, a.M, D, D, 64))
        return (int)cudaErrorInvalidValue;
    return p2 % 4 ? launch<4>(kc_map, out_map, a, stream)
                  : launch<8>(kc_map, out_map, a, stream);
}
