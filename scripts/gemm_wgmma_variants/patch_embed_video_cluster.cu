// A design of csrc/patch_embed.cu that stages the video once per token
// tile: the column tiles of a token tile run as a cluster, and the block
// that copies a step's A tile forwards it to the others by DSMEM bulk
// copies.  It ran slower than the shipped design (the copies of one block
// for three, the forwarder's waits), and is kept for
// scripts/gemm_wgmma_trial.py --variants (stage PE); built alone with
// -I csrc, it exports the same C entry points.
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
// - Tiles of 128 tokens × 256 columns.  The column tiles of one token tile
//   (three at D 768) run at once as a cluster of blocks (CS of them, one
//   block per SM); the clusters walk the token tiles as a persistent grid.
//   Each block has a producer warpgroup and two consumer warpgroups of 64
//   tokens, which issue register-A wgmma m64n256k16 (A as ldmatrix
//   fragments of the staged tile, B = kc from shared memory), fp32
//   accumulators in registers (128 a thread), from a ring of PE_STAGES
//   stages of 64 k.
// - kc's 256 × 64 box of a step comes by TMA (zero past D and n), into each
//   block's own stage.
// - The video side: no TMA box places a token's patch-row piece (tokens are
//   p2·2 bytes apart in a video row, 40 at p2 20: no 16-byte stride), so
//   the producer's copier warps copy the pieces themselves, 8 bytes at a
//   time (4 where p2 % 4 != 0), straight into the 128-byte-swizzled K-major
//   A tile (the 16-byte chunk index XOR row % 8).  A piece never straddles a
//   chunk or a 64-k step: its offset in k is a multiple of its size.  A
//   half-warp copies one token's 128 bytes of a step and a warp two
//   neighbouring tokens (their pieces are neighbours in the video row).  The
//   token tile may straddle patch rows and frames: each token's source
//   offset is computed once a tile into a table in shared memory.  Depth
//   past n and tokens past the end are zero-filled (the copy's source size
//   0).
// - The video is staged once per token tile, not once per column tile: the
//   A tile of step s is copied by block s % CS of the cluster alone; its
//   copies complete on a local barrier (cp.async.mbarrier.arrive.noinc), on
//   which its forwarder thread waits, fences them into the async proxy and
//   sends the tile to the cluster's other blocks with one DSMEM bulk copy
//   each (cp.async.bulk.shared::cluster, completing their full barriers'
//   transactions).  A stage fills with two arrivals (the TMA thread's, with
//   kc's bytes and, where the tile comes from another block, the tile's; and
//   the forwarder's, local or remote), and empties with one arrival of each
//   consumer warp of every block of the cluster, since the tile's copier
//   writes all of them.
// - The statistics come from the same fragments on the tensor cores: beside
//   each product, the fragment and its square rounded to bf16 (one bf16x2
//   multiply) times a tile of bf16 ones (m64n8k16: every column holds the
//   row's sum), fp32 accumulators, so μ and Σx² cost no extra read of the
//   tile; the sums run in k order, so two launches give the same bits.
//   Every block computes them for its epilogue; the first column tile
//   writes μ and Σx².
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
// the setmaxnreg split: the copiers want more registers than a TMA thread
constexpr int PE_PRODUCER_REGS = 40, PE_CONSUMER_REGS = 232;
// the producer warpgroup: warp 0's first thread issues kc's TMA loads, warp
// 1's first thread forwards the A tiles, warps 2 and 3 copy the video
constexpr int PE_COPIERS = 64;
constexpr int PE_LPT = 16;   // copier lanes a token
using PeGemm = WgGemm<PE_COLS, 1, false, false>;
using PeOut = Staging<PE_PART / 64>;
// after the staging: the token table (a tile's 128 source offsets in
// elements of x, −1 past the last token), a 1 KB tile of bf16 ones (the
// statistics' B), and the barriers on which the copies of each stage's A
// tile complete
constexpr int PE_TABLE_BYTES = TILE_M * 8, PE_ONES_BYTES = 1024;
constexpr int PE_ABAR_BYTES = 1024;
using PeRing = Ring<PE_STAGES, PeGemm::STAGE_BYTES,
                    2 * PeOut::BYTES + PE_TABLE_BYTES + PE_ONES_BYTES +
                        PE_ABAR_BYTES>;

struct PeArgs {
    const bf16* x;
    const float* csum;
    const float* dvec;
    float* mu;
    float* sq;
    int CPT, H, W, p1, p2, D, n;
    int ws, tpf, M;   // tpf: tokens of a frame (hs·ws); M: all tokens
    int cs;           // the column tiles of a cluster, one a block
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

// wait until the phase of parity `parity` has completed, acquiring what the
// cluster's other blocks released into the barrier
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// the address of shared address `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t in_block(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(out)
                 : "r"(addr), "r"(rank));
    return out;
}

// arrive on a barrier of the cluster (an in_block address)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// `bytes` of this block's shared memory at src into another block's at dst
// (an in_block address), completing that many transaction bytes of its
// barrier bar (an in_block address)
__device__ __forceinline__ void copy_to_block(uint32_t dst, uint32_t src,
                                              int bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
        "r"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::
            : "memory");
}

// x² of two bf16, each product rounded once to bf16 (as bf16_round(x·x))
__device__ __forceinline__ uint32_t sq_bf16x2(uint32_t v) {
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
    b = __hmul2(b, b);
    return *reinterpret_cast<uint32_t*>(&b);
}

// the copier warps' own barrier (id 3)
__device__ __forceinline__ void copier_sync() {
    asm volatile("bar.sync 3, %0;\n" ::"n"(PE_COPIERS) : "memory");
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
// is 8-byte aligned), else 4.  Launched in clusters of a.cs blocks.
template <int CB>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
patch_embed_kernel(const __grid_constant__ CUtensorMap kc_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const PeArgs a) {
    constexpr int EPC = CB / 2;              // bf16 of one copy
    constexpr int COPIES = STEP_BYTES / CB;  // copies of a token's k step
    extern __shared__ unsigned char smem_raw[];
    PeRing ring(smem_raw);
    const uint32_t table = ring.extra() + 2 * PeOut::BYTES;
    const uint32_t ones = table + PE_TABLE_BYTES;
    const uint32_t abar = ones + PE_ONES_BYTES;   // 8 bytes a stage
    long long* tok = reinterpret_cast<long long*>(
        smem_raw + (table - smem_u32(smem_raw)));
    const int cs = a.cs, rank = blockIdx.x % cs;
    const int col_tiles = (a.D + PE_COLS - 1) / PE_COLS;
    const int groups = col_tiles / cs;   // column groups of a token tile
    const int units = (a.M + TILE_M - 1) / TILE_M * groups;
    const int cluster = blockIdx.x / cs, clusters = gridDim.x / cs;
    const int steps = (a.n + STEP_K - 1) / STEP_K;
    if (threadIdx.x == 0) {
        // full: the TMA thread's arrival and the forwarder's; empty: one
        // arrival of each consumer warp of the cluster; the A tile's: one
        // cp.async arrival of each copier
        for (int s = 0; s < PE_STAGES; ++s) {
            mbar_init(ring.bars + 8 * s, 2);
            mbar_init(ring.bars + 8 * (PE_STAGES + s), 8 * cs);
            mbar_init(abar + 8 * s, PE_COPIERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();   // every block's barriers exist before any is used

    if (threadIdx.x < WG_THREADS) {   // the producer
        producer_regs<PE_PRODUCER_REGS, PE_CONSUMER_REGS>();
        const int warp = threadIdx.x >> 5;
        if (warp == 0) {
            if (threadIdx.x == 0) {   // kc by TMA, into this block's stage
                for (int u = cluster; u < units; u += clusters) {
                    const int n0 = (u % groups * cs + rank) * PE_COLS;
                    for (int s = 0; s < steps; ++s) {
                        mbar_wait_cluster(ring.empty(), ring.phase ^ 1);
                        mbar_expect_tx(ring.full(),
                                       PeGemm::B_BYTES +
                                           (s % cs == rank ? 0
                                                           : PeGemm::A_BYTES));
                        load_tile<false, PE_COLS>(ring.data() + PeGemm::A_BYTES,
                                                  &kc_map, n0, s * STEP_K,
                                                  ring.full());
                        ring.advance();
                    }
                }
            }
        } else if (warp == 1) {
            if (threadIdx.x == 32) {   // the forwarder of this block's tiles
                uint32_t aphase = 0;   // a bit a stage
                for (int u = cluster; u < units; u += clusters)
                    for (int s = 0; s < steps; ++s) {
                        if (s % cs == rank) {
                            const uint32_t bar = abar + 8 * ring.stage;
                            mbar_wait(bar, (aphase >> ring.stage) & 1);
                            aphase ^= 1u << ring.stage;
                            // the copies (generic proxy) reach the bulk
                            // copies (async proxy)
                            asm volatile("fence.proxy.async.shared::cta;\n" ::
                                             : "memory");
                            for (int q = 0; q < cs; ++q) {
                                if (q == rank) continue;
                                const uint32_t full = in_block(ring.full(), q);
                                copy_to_block(in_block(ring.data(), q),
                                              ring.data(), PeGemm::A_BYTES,
                                              full);
                                mbar_arrive_remote(full);
                            }
                            mbar_arrive(ring.full());
                        }
                        ring.advance();
                    }
            }
        } else {   // the copiers
            // PE_LPT lanes a token: group g of the copiers copies tokens
            // g + G·i, i < TILE_M / G (a warp: two neighbouring tokens at a
            // time); lane ql of the group copies ql, ql + PE_LPT, .. of a
            // token's step
            constexpr int G = PE_COPIERS / PE_LPT;
            const int pt = threadIdx.x - (WG_THREADS - PE_COPIERS);
            const int g = pt / PE_LPT, ql = pt % PE_LPT;
            for (int u = cluster; u < units; u += clusters) {
                const int m0 = u / groups * TILE_M;
                copier_sync();   // every copier is done with the last table
                for (int i = pt; i < TILE_M; i += PE_COPIERS) {
                    const int T = m0 + i;
                    long long off = -1;
                    if (T < a.M) {
                        const int f = T / a.tpf, rem = T - f * a.tpf;
                        const int hi = rem / a.ws, wi = rem - hi * a.ws;
                        off = ((long long)f * a.CPT * a.H +
                               (long long)hi * a.p1) * a.W +
                              (long long)wi * a.p2;
                    }
                    tok[i] = off;
                }
                copier_sync();
                for (int s = 0; s < steps; ++s) {
                    if (s % cs == rank) {
                        // the stage is free in every block of the cluster
                        mbar_wait_cluster(ring.empty(), ring.phase ^ 1);
                        const uint32_t st = ring.data();
                        const int k0 = s * STEP_K;
#pragma unroll 1
                        for (int v = 0; v < COPIES / PE_LPT; ++v) {
                            const int q = ql + PE_LPT * v;
                            // depth k = (ch·p1 + r)·p2 + j of the copy
                            const int k = k0 + q * EPC;
                            const int pr = k / a.p2, j = k - pr * a.p2;
                            const int ch = pr / a.p1, r = pr - ch * a.p1;
                            const bool kin = k < a.n;
                            const long long koff =
                                ((long long)ch * a.H + r) * a.W + j;
                            const uint32_t b = q * CB;   // byte of the row
#pragma unroll 8
                            for (int i = 0; i < TILE_M / G; ++i) {
                                const int m = i * G + g;
                                const long long base = tok[m];
                                const bool ok = kin && base >= 0;
                                cp_async_small<CB>(
                                    st + m * 128 +
                                        (((b >> 4) ^ (m & 7)) << 4) + (b & 15),
                                    a.x + (ok ? base + koff : 0), ok);
                            }
                        }
                        cp_async_arrive(abar + 8 * ring.stage);
                    }
                    ring.advance();
                }
            }
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        }
        __syncwarp();
        cluster_sync();   // no block leaves while another may reach it
        return;
    }

    consumer_regs<PE_PRODUCER_REGS, PE_CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1;   // consumer 0 or 1
    const int lane = threadIdx.x & 31;
    const PeOut out(ring.extra());
    // the ones, written by the consumers' threads and made visible to wgmma
    // (the async proxy) before any reads them
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                     ones + 4 * (threadIdx.x - WG_THREADS)),
                 "r"(0x3f803f80u)
                 : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 4, %0;\n" ::"n"(2 * WG_THREADS) : "memory");
    for (int u = cluster; u < units; u += clusters) {
        const int m0 = u / groups * TILE_M + 64 * cw;
        const int n0 = (u % groups * cs + rank) * PE_COLS;
        float acc[PeGemm::N / 8][4];
#pragma unroll
        for (int j = 0; j < PeGemm::N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        // Σx and Σbf16(x²) of each row: every column of st[0], st[1] holds
        // the row's sum
        float st[2][1][4] = {};
        fence_acc(acc);
        fence_acc(st[0]);
        fence_acc(st[1]);
        for (int s = 0; s < steps; ++s) {
            mbar_wait_cluster(ring.full(), ring.phase);
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
                WgmmaRS<8, 0>::run(st[0], fa[kk], smem_desc<false, 32>(ones));
                WgmmaRS<8, 0>::run(st[1], fq[kk], smem_desc<false, 32>(ones));
            }
            wgmma_commit();
            wgmma_wait<0>();
            keep(fa);
            keep(fq);
            // the stage is read: free it in every block of the cluster
            __syncwarp();
            if (lane == 0)
                for (int q = 0; q < cs; ++q) {
                    if (q == rank)
                        mbar_arrive(ring.empty());
                    else
                        mbar_arrive_remote(in_block(ring.empty(), q));
                }
            ring.advance();
        }
        fence_acc(acc);
        fence_acc(st[0]);
        fence_acc(st[1]);

        // μ and inv of the lane's accumulator rows 16w + g (+ 8)
        float rm[2], ri[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float sx = st[0][0][2 * h], sxx = st[1][0][2 * h];
            rm[h] = __fdiv_rn(sx, a.nf);
            const float var = fmaxf(
                __fsub_rn(__fdiv_rn(sxx, a.nf), __fmul_rn(rm[h], rm[h])), 0.f);
            ri[h] = rsqrtf(__fadd_rn(var, a.eps));
            const int row = m0 + wg_row(2 * h);
            if (n0 == 0 && (lane & 3) == 0 && row < a.M) {
                a.mu[row] = rm[h];
                a.sq[row] = sxx;
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
                const float2 cs2 =
                    in ? *reinterpret_cast<const float2*>(a.csum + col)
                       : make_float2(0.f, 0.f);
                const float2 dv =
                    in ? *reinterpret_cast<const float2*>(a.dvec + col)
                       : make_float2(0.f, 0.f);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float m = rm[h], iv = ri[h];
                    const float t0 = __fadd_rn(
                        __fmul_rn(
                            __fsub_rn(acc[jj][2 * h], __fmul_rn(m, cs2.x)), iv),
                        dv.x);
                    const float t1 = __fadd_rn(
                        __fmul_rn(
                            __fsub_rn(acc[jj][2 * h + 1], __fmul_rn(m, cs2.y)),
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
    cluster_sync();
}

// the blocks of a cluster: the column tiles that share a token tile's
// video, up to three (D 768); a count of column tiles that neither 3 nor 2
// divides runs in clusters of one
int cluster_size(int col_tiles) {
    return col_tiles <= 3 ? col_tiles : col_tiles % 3 == 0 ? 3
                                    : col_tiles % 2 == 0 ? 2 : 1;
}

template <int CB>
int launch(const CUtensorMap& kc_map, const CUtensorMap& out_map, PeArgs a,
           void* stream) {
    cudaError_t e = allow_smem(patch_embed_kernel<CB>, PeRing::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const int col_tiles = (a.D + PE_COLS - 1) / PE_COLS;
    a.cs = cluster_size(col_tiles);
    const long long units =
        (long long)((a.M + TILE_M - 1) / TILE_M) * (col_tiles / a.cs);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.cs);
    cfg.blockDim = dim3(GEMM_THREADS);
    cfg.dynamicSmemBytes = PeRing::SMEM_BYTES;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a persistent grid: as many clusters as the card holds at once, asked
    // once per cluster size
    static int resident[4] = {0, 0, 0, 0};
    if (resident[a.cs] == 0) {
        e = cudaOccupancyMaxActiveClusters(
            &resident[a.cs], (const void*)patch_embed_kernel<CB>, &cfg);
        if (e != cudaSuccess) return (int)e;
        if (resident[a.cs] < 1) return (int)cudaErrorInvalidConfiguration;
    }
    const long long clusters = units < resident[a.cs] ? units : resident[a.cs];
    cfg.gridDim = dim3((unsigned)(clusters * a.cs));
    e = cudaLaunchKernelEx(&cfg, patch_embed_kernel<CB>, kc_map, out_map, a);
    if (e != cudaSuccess) return (int)e;
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
    a.cs = 1;
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
