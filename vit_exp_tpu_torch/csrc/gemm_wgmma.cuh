// GEMM mainloop of the port's products on Hopper's tensor cores (geglu_ff.cu:
// K2's act and out; geglu_ff_bwd.cu: K8's dh, dy and the weight GEMM;
// ln_qkv.cu: K3; ln_qkv_int8.cu: K12/K13's product and K14;
// geglu_ff_int8.cu: K11's act and out), and the PTX pieces of the
// attention kernels (flash_bwd.cu, the backward pair; flash_fwd.cu, the
// forwards K1/K15: descriptors in the 64- and 32-byte swizzles, wgmma with
// A in registers, 4-D tensor maps):
// acc[m, n] += Σ_k A(m, k) · B(k, n) over a block tile of TILE_M rows × N
// columns, in two forms: bf16 operands with fp32 accumulators (wgmma
// m64nNk16) and int8 operands with int32 accumulators (m64nNk32, s8 × s8),
// the accumulators in registers.
//
// - A block is three warpgroups (GEMM_THREADS, one block per SM).
//   Warpgroup 0 is the producer: it gives registers away (setmaxnreg.dec
//   to PRODUCER_REGS, or a kernel's own split) and one thread of its first
//   warp issues the TMA loads (cp.async.bulk.tensor.2d) of every k step
//   into a ring of stages in dynamic shared memory.  Warpgroups 1 and 2
//   are the consumers (setmaxnreg.inc to CONSUMER_REGS, or the kernel's
//   split): consumer c owns rows 64c .. 64c + 63
//   of the block tile and issues wgmma.mma_async with both operands in
//   shared memory, four instructions (k16 bf16 or k32 int8) a stage.
// - Each stage has a full and an empty mbarrier.  The producer waits until
//   a stage is empty, arms its full barrier with the stage's bytes
//   (mbarrier.arrive.expect_tx) and issues the loads, which complete the
//   transaction; a consumer waits until the stage is full, issues its
//   group of wgmmas and, once wgmma.wait_group 1 says the group before is
//   done, releases the stage that group read: one group in flight.
// - Operands are row-major matrices in device memory, each read through a
//   TMA tensor map made on the host (tma_map): index-major, stored
//   (index, k) (A as M × K, B as N × K; wgmma's K-major), or, for bf16
//   only, k-major, stored (k, index) (A as K × M, B as K × N; wgmma's
//   MN-major, read through the instruction's transpose bit: the 8-bit
//   forms have none).  TMA zero-fills a box past a matrix's edge, so M, N
//   and K are free (an epilogue masks its stores from the registers; TMA
//   stores clip); the pointer and the pitch must be multiples of 16 bytes.
// - The B tile of a step is NB tiles of BN columns side by side (K2's, K8's
//   and K11's val and gate columns, from two tensor maps or two column
//   origins), read by one wgmma of N = NB · BN columns, so the A tile is
//   read once.
// - A may instead be resident (WgGemm's A_RES: K14): a consumer writes its
//   rows of A once into shared memory, in the layout a TMA box would give
//   them (a k step's rows × 128 bytes, one k step after the other), and the
//   ring carries only B.  Written by st.shared, they need
//   fence.proxy.async.shared::cta and a warpgroup barrier before the first
//   wgmma that reads them (the async proxy).
// - Shared memory, TMA swizzle and wgmma descriptor agree on the 128-byte
//   swizzle: a k step is 128 bytes deep (WgGemm::STEP_K: 64 bf16 or 128
//   int8 codes), and every operand tile is made of 8 KB chunks of 64 rows
//   × 128 bytes, 1024-byte aligned.  An index-major tile of R index rows is
//   one TMA box of 128 bytes of k × R rows: 8-row groups 1024 bytes apart
//   (the descriptor's SBO), and an instruction (32 bytes of k in both
//   forms) moves the descriptor 32 bytes along the rows.  A k-major tile
//   is R / 64 boxes of 64 index × 64 k: rows of 64 index, one a k; 64-index
//   chunks 8 KB apart (LBO), 8-k groups 1024 bytes apart (SBO), and a k16
//   instruction moves the descriptor 2 KB.
// - Persistent grid: one block per SM walks the output tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ...; producer and consumers walk the same
//   sequence, so the producer loads the next tile's first stages while the
//   consumers run this tile's epilogue.  Mainloops may run in sequence on
//   one tile (K8's dh: dO·W2ᵀ, then y·W1): the ring's position carries on.
// - Or each consumer warpgroup has a ring of its own (Ring's RINGS 2, K14),
//   whose stages it alone reads (one arrival empties a stage), fed by a
//   producer thread of its own, and walks tiles of its own: the two
//   consumers then run apart, one's epilogue beside the other's wgmmas.
// - bf16 or fp32 outputs may leave through a staging tile in shared memory
//   and TMA stores (Staging), so that the consumers go on to the next tile
//   while the copies run.
// - The accumulators are wgmma's m64nN layout (fp32 or s32 alike), which
//   per n8 tile j is mma.sync's C layout: in a consumer warpgroup, lane l
//   of warp w, g = l / 4, t = l % 4, holds acc[j][e] at row 16w + g +
//   8·(e / 2), column 8j + 2t + e % 2 of the consumer's 64 × N tile
//   (wg_row, wg_col).
// No atomics: the tile order is fixed, so two launches give the same bits.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled
                    // is reached through the runtime (tma_map), not linked

#include <type_traits>

#include "attn_mma.cuh"

namespace vit {

constexpr int WG_THREADS = 128;                 // a warpgroup
constexpr int GEMM_THREADS = 3 * WG_THREADS;    // producer + two consumers
constexpr int TILE_M = 128;                     // rows of a block tile
constexpr int STEP_BYTES = 128;                 // a k step's bytes of a row
constexpr int STEP_K = 64;                      // depth of a bf16 k step
constexpr int CHUNK_BYTES = 64 * 128;           // 64 rows of 128 bytes
// registers a thread after setmaxnreg: the producer warpgroup gives what
// the consumers take from the block's 168 a thread at launch (ptxas's cap
// for 384 threads)
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 32, CONSUMER_REGS = 232;

template <int P, int C>
__host__ __device__ constexpr bool regs_fit() {
    return P % 8 == 0 && C % 8 == 0 && P >= 24 && C <= 256 &&
           P * WG_THREADS + 2 * C * WG_THREADS <= LAUNCH_REGS * GEMM_THREADS;
}

// One GEMM of a block tile: NB B tiles of BN columns (N = NB · BN for the
// wgmma), A and B index-major (false) or k-major (true), operands of T
// (bf16, or signed char: int8 codes with int32 accumulators); A from the
// ring, or resident in shared memory (A_RES, index-major).
template <int BN_, int NB_, bool A_KMAJOR_, bool B_KMAJOR_, class T_ = bf16,
          bool A_RES_ = false>
struct WgGemm {
    using T = T_;
    static constexpr bool S8 = std::is_same<T, signed char>::value;
    using Acc = typename std::conditional<S8, int, float>::type;
    static constexpr int BN = BN_, NB = NB_, N = BN_ * NB_;
    static constexpr bool A_KMAJOR = A_KMAJOR_, B_KMAJOR = B_KMAJOR_;
    static constexpr bool A_RES = A_RES_;
    static constexpr int STEP_K = STEP_BYTES / (int)sizeof(T);   // k a step
    static constexpr int A_BYTES = TILE_M * STEP_BYTES;   // a k step of A
    static constexpr int B_BYTES = BN * STEP_BYTES;
    // a stage: A's step (unless resident), then the B tiles
    static constexpr int B_OFFSET = A_RES ? 0 : A_BYTES;
    static constexpr int STAGE_BYTES = B_OFFSET + NB * B_BYTES;
    // an instruction's move of each descriptor along k, in bytes: 32 bytes
    // of a row index-major (k16 bf16, k32 int8), 16 rows of 128 bytes
    // k-major
    static constexpr int A_INSTR = A_KMAJOR ? 16 * 128 : 32;
    static constexpr int B_INSTR = B_KMAJOR ? 16 * 128 : 32;
    static_assert(S8 || std::is_same<T, bf16>::value, "bf16 or int8 codes");
    static_assert(!S8 || (!A_KMAJOR && !B_KMAJOR),
                  "8-bit wgmma has no transpose: int8 operands are "
                  "index-major");
    static_assert(!A_RES || !A_KMAJOR, "a resident A is index-major");
    static_assert(BN % 64 == 0 && (N == 64 || N == 128 || N == 256),
                  "B tiles of whole 64-column chunks; wgmma N of 64, 128 "
                  "or 256");
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma, setmaxnreg
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

// arm the barrier's current phase with `bytes` of transactions and arrive
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// the box at coordinates (c0 along the contiguous extent, c1 along the
// rows) of a 2-D tensor map into shared memory at dst; completes `bar`'s
// transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map (tma_map_4d)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
        : "memory");
}

// 32 bits at a shared address
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

// where TMA puts byte `off` of a tile of SW-byte rows in the swizzle of SW
// bytes (the tile on a 1024-byte boundary): its 16-byte unit XOR the row
// bits above 128 bytes
template <int SW>
__host__ __device__ constexpr uint32_t swizzled(uint32_t off) {
    return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// two fp32 at a shared address (8-byte aligned), and back
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y)
                 : "r"(addr));
    return v;
}
__device__ __forceinline__ void sts_f2(uint32_t addr, float2 v) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x),
                 "f"(v.y)
                 : "memory");
}

// the descriptor of an operand tile at shared address addr in the swizzle
// of SW bytes (128: layout type 1; 64: type 2; 32: type 3), rows of SW
// bytes: index-major, SBO = 8 rows (LBO unused, 1); k-major, LBO = 64 rows
// (the 8 KB between 64-index chunks at SW 128), SBO = 8 rows of k.  The
// swizzle is a function of the address, so tiles sit on 1024-byte
// boundaries and an instruction's step moves the address only.
template <bool KMAJOR, int SW = 128>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    static_assert(SW == 128 || SW == 64 || SW == 32, "a TMA swizzle span");
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           (uint64_t)(KMAJOR ? 64 * SW >> 4 : 1) << 16 |
           (uint64_t)(8 * SW >> 4) << 32 |
           (uint64_t)(SW == 128 ? 1 : SW == 64 ? 2 : 3) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas that own them
template <int J>
__device__ __forceinline__ void fence_acc(float (&acc)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
}
template <int J>
__device__ __forceinline__ void fence_acc(int (&acc)[J][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(acc[j][e])::"memory");
}

template <int P = PRODUCER_REGS, int C = CONSUMER_REGS>
__device__ __forceinline__ void producer_regs() {
    static_assert(regs_fit<P, C>(), "the warpgroups' registers fit the block's");
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P));
}
template <int P = PRODUCER_REGS, int C = CONSUMER_REGS>
__device__ __forceinline__ void consumer_regs() {
    static_assert(regs_fit<P, C>(), "the warpgroups' registers fit the block's");
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C));
}

// d (64 × N fp32, the layout above) += A (64 × 16) · B (16 × N), both read
// from shared memory through descriptors; TA, TB: k-major (transposed);
// scale_d 0: d = A · B (d's values are not read)
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
    __device__ __forceinline__ static void run(float (&d)[8][4],
                                               uint64_t da, uint64_t db,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1, %35, %36;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
            : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
    __device__ __forceinline__ static void run(float (&d)[16][4],
                                               uint64_t da, uint64_t db,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, %67, %68;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
              "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
              "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
              "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
              "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
              "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
              "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
              "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
              "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
            : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
    __device__ __forceinline__ static void run(float (&d)[32][4],
                                               uint64_t da, uint64_t db,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, "
            "%104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127}, "
            "%128, %129, p, 1, 1, %131, %132;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
              "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
              "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
              "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
              "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
              "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
              "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
              "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
              "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
              "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
              "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
              "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
              "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
              "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
              "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
              "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
              "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
              "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
              "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
              "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
              "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
              "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
              "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
              "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
              "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
            : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
    }
};

// d (64 × N fp32) += A (64 × 16 bf16, in registers) · B (16 × N, read from
// shared memory through a descriptor; TB: k-major, through the transpose
// bit; scale_d 0: d = A · B).  A is the m16n8k16 A fragment of each warp's
// 16 rows (warp w of the
// warpgroup: rows 16w ..): {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8,
// 2t+8..)}, which is two adjacent n8 tiles of an accumulator (the layout
// above) packed to bf16 pairs: a product's output feeds the next product
// from the registers.  The registers of a and d belong to the wgmma until a
// wgmma.wait_group covers it.
template <int N, int TB>
struct WgmmaRS;

template <int TB>
struct WgmmaRS<8, TB> {
    __device__ __forceinline__ static void run(float (&d)[1][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3"
            "}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(scale_d), "n"(TB));
    }
};

template <int TB>
struct WgmmaRS<16, TB> {
    __device__ __forceinline__ static void run(float (&d)[2][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(scale_d), "n"(TB));
    }
};

template <int TB>
struct WgmmaRS<32, TB> {
    __device__ __forceinline__ static void run(float (&d)[4][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15"
            "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(scale_d), "n"(TB));
    }
};

template <int TB>
struct WgmmaRS<64, TB> {
    __device__ __forceinline__ static void run(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(scale_d), "n"(TB));
    }
};

template <int TB>
struct WgmmaRS<128, TB> {
    __device__ __forceinline__ static void run(float (&d)[16][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
              "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
              "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
              "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
              "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
              "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
              "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
              "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
              "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(scale_d), "n"(TB));
    }
};

template <int TB>
struct WgmmaRS<256, TB> {
    __device__ __forceinline__ static void run(float (&d)[32][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, "
            "%104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127"
            "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
            : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
              "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
              "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
              "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
              "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
              "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
              "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
              "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
              "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
              "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
              "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
              "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
              "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
              "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
              "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
              "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
              "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
              "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
              "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
              "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
              "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
              "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
              "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
              "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
              "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
              "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
              "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
              "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
              "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
              "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
              "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
              "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
              "r"(scale_d), "n"(TB));
    }
};

// d (64 × N s32, the layout above) += A (64 × 32) · B (32 × N), int8 codes
// read from shared memory through descriptors, both index-major (the 8-bit
// forms have no transpose)
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
    __device__ __forceinline__ static void run(int (&d)[8][4],
                                               uint64_t da, uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p;\n}\n"
            : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
              "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
              "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
              "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
              "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
              "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
              "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
              "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
            : "l"(da), "l"(db), "r"(1));
    }
};

template <>
struct WgmmaS8<128> {
    __device__ __forceinline__ static void run(int (&d)[16][4],
                                               uint64_t da, uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p;\n}\n"
            : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
              "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
              "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
              "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
              "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
              "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
              "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
              "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
              "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
              "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
              "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
              "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
              "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
              "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
              "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
              "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
            : "l"(da), "l"(db), "r"(1));
    }
};

template <>
struct WgmmaS8<256> {
    __device__ __forceinline__ static void run(int (&d)[32][4],
                                               uint64_t da, uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, "
            "%104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127}, "
            "%128, %129, p;\n}\n"
            : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
              "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
              "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
              "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
              "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
              "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
              "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
              "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
              "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
              "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
              "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
              "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
              "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
              "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
              "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
              "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
              "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
              "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
              "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
              "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
              "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
              "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
              "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
              "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
              "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
              "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
              "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
              "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
              "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
              "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
              "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
              "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
            : "l"(da), "l"(db), "r"(1));
    }
};

// ---------------------------------------------------------------------------
// The ring, the producer's loads, the consumers' mainloop
// ---------------------------------------------------------------------------

// RINGS rings of STAGES stages of STAGE_BYTES in dynamic shared memory
// (SMEM_BYTES: the stages 1024-aligned, then EXTRA bytes for the
// epilogue's staging, then a full and an empty mbarrier per stage); a Ring
// object is ring `id` of them, and each thread of a role keeps its own
// position (stage, phase) in it.  One ring is read by both consumers, two
// are one a consumer.  A stage fills with FULL arrivals (the producer's, and
// any threads that write part of it with st.shared before they arrive) and
// empties with READERS arrivals, one per consumer warpgroup that reads it
// (0: both consumers of one ring, or the one of a ring of its own).
template <int STAGES_, int STAGE_BYTES_, int EXTRA = 0, int RINGS = 1,
          int FULL = 1, int READERS = 0>
struct Ring {
    static constexpr int STAGES = STAGES_, STAGE_BYTES = STAGE_BYTES_;
    static constexpr int SMEM_BYTES =
        1024 + RINGS * STAGES * STAGE_BYTES + EXTRA + 16 * STAGES * RINGS;
    static_assert(STAGE_BYTES % 1024 == 0 && EXTRA % 1024 == 0,
                  "stages and staging keep the swizzle's 1024-byte alignment");
    static_assert(SMEM_BYTES <= 232448, "a block's shared memory on sm_90");
    static_assert(RINGS == 1 || RINGS == 2, "one shared ring, or one a consumer");
    uint32_t area, base, bars;
    int stage = 0;
    uint32_t phase = 0;

    __device__ __forceinline__ explicit Ring(unsigned char* smem, int id = 0)
        : area((smem_u32(smem) + 1023) & ~1023u),
          base(area + id * STAGES * STAGE_BYTES),
          bars(area + RINGS * STAGES * STAGE_BYTES + EXTRA +
               16 * STAGES * id) {}
    // the epilogue's staging area
    __device__ __forceinline__ uint32_t extra() const {
        return area + RINGS * STAGES * STAGE_BYTES;
    }
    __device__ __forceinline__ uint32_t data() const {
        return base + stage * STAGE_BYTES;
    }
    __device__ __forceinline__ uint32_t full() const { return bars + 8 * stage; }
    __device__ __forceinline__ uint32_t empty() const {
        return bars + 8 * (STAGES + stage);
    }
    __device__ __forceinline__ void advance() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }
    // every ring's barriers: full takes the producer's arrival (and the
    // loads' bytes; FULL arrivals in all), empty one arrival per consumer
    // warpgroup that reads the ring; every thread of the block calls it
    __device__ __forceinline__ void init() const {
        if (threadIdx.x == 0) {
            const uint32_t all = area + RINGS * STAGES * STAGE_BYTES + EXTRA;
            for (int s = 0; s < RINGS * STAGES; ++s) {
                const int r = s / STAGES, i = s % STAGES;
                mbar_init(all + 16 * STAGES * r + 8 * i, FULL);
                mbar_init(all + 16 * STAGES * r + 8 * (STAGES + i),
                          READERS ? READERS : RINGS == 1 ? 2 : 1);
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }
};

// one operand tile of ROWS index rows at index i0, depth k0, into dst
template <bool KMAJOR, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int i0, int k0, uint32_t bar) {
    if (KMAJOR) {   // boxes of 64 index × 64 k
#pragma unroll
        for (int c = 0; c < ROWS / 64; ++c)
            tma_load(dst + c * CHUNK_BYTES, map, i0 + 64 * c, k0, bar);
    } else {        // one box of 64 k × ROWS index
        tma_load(dst, map, k0, i0, bar);
    }
}

// The producer's k steps of one GEMM of a tile: A's rows m0 .. through
// map a (none where A is resident), B tile j's columns b_n0[j] .. through
// map b[j], depth k_begin .. k_end in steps of G::STEP_K.
template <class G, class R>
__device__ __forceinline__ void produce(R& ring, const CUtensorMap* a, int m0,
                                        const CUtensorMap* const (&b)[G::NB],
                                        const int (&b_n0)[G::NB], int k_begin,
                                        int k_end) {
    static_assert(G::STAGE_BYTES <= R::STAGE_BYTES, "a stage holds the step");
    for (int k0 = k_begin; k0 < k_end; k0 += G::STEP_K) {
        mbar_wait(ring.empty(), ring.phase ^ 1);
        const uint32_t full = ring.full(), st = ring.data();
        mbar_expect_tx(full, G::STAGE_BYTES);
        if constexpr (!G::A_RES)
            load_tile<G::A_KMAJOR, TILE_M>(st, a, m0, k0, full);
#pragma unroll
        for (int j = 0; j < G::NB; ++j)
            load_tile<G::B_KMAJOR, G::BN>(st + G::B_OFFSET + j * G::B_BYTES,
                                          b[j], b_n0[j], k0, full);
        ring.advance();
    }
}

// A consumer warpgroup's k steps of one GEMM of a tile (the producer's
// steps): acc += its 64 rows of A · the N columns of B.  A from the ring
// (consumer c's rows 64c ..), or resident: the warpgroup's 64 rows of k
// step s at a_res + s · a_step.  Returns with every wgmma done and every
// stage it read released.
template <class G, class R>
__device__ __forceinline__ void consume(R& ring,
                                        typename G::Acc (&acc)[G::N / 8][4],
                                        int k_begin, int k_end,
                                        uint32_t a_res = 0, int a_step = 0) {
    const int cw = threadIdx.x / WG_THREADS - 1;   // consumer 0 or 1
    const bool signals = threadIdx.x % WG_THREADS == 0;
    uint32_t held = 0;   // the empty barrier of the stage read a step before
    fence_acc(acc);
    for (int k0 = k_begin; k0 < k_end; k0 += G::STEP_K) {
        mbar_wait(ring.full(), ring.phase);
        const uint32_t a = G::A_RES ? a_res + k0 / G::STEP_K * a_step
                                    : ring.data() + cw * CHUNK_BYTES;
        const uint32_t b = ring.data() + G::B_OFFSET;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < STEP_BYTES / 32; ++kk) {
            const uint64_t da = smem_desc<G::A_KMAJOR>(a + kk * G::A_INSTR);
            const uint64_t db = smem_desc<G::B_KMAJOR>(b + kk * G::B_INSTR);
            if constexpr (G::S8)
                WgmmaS8<G::N>::run(acc, da, db);
            else
                Wgmma<G::N, G::A_KMAJOR, G::B_KMAJOR>::run(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the group before is done: its stage is free
        if (held && signals) mbar_arrive(held);
        held = ring.empty();
        ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held && signals) mbar_arrive(held);
}

// row and column, within the consumer's 64 × N tile, of accumulator
// element e of n8 tile j; the consumer's first row within the block tile
__device__ __forceinline__ int wg_row(int e) {
    return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
           8 * (e >> 1);
}
__device__ __forceinline__ int wg_col(int j, int e) {
    return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}
__device__ __forceinline__ int consumer_row0() {
    return 64 * (threadIdx.x / WG_THREADS - 1);
}

// ---------------------------------------------------------------------------
// The epilogue's stores, through shared memory and TMA
// ---------------------------------------------------------------------------

// the consumer warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(threadIdx.x / WG_THREADS),
                 "n"(WG_THREADS)
                 : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1)
        : "memory");
}

// A consumer warpgroup's outputs of a tile leave through its own staging
// area: CHUNKS chunks of 64 rows × 128 bytes (64 bf16 or 32 fp32 columns)
// in the 128-byte swizzle, which the accumulator layout writes without bank
// conflicts (the 8 rows of a store fall on 8 distinct 16-byte units).  One
// thread then stores each chunk with TMA (cp.async.bulk.tensor, which drops
// what falls past the matrix's edges, so the stores need no mask) and the
// warpgroup goes on to its next tile while the copies run; the staging's
// next use waits only until they have read it.  The ring's EXTRA holds 2 ·
// BYTES.
template <int CHUNKS>
struct Staging {
    static constexpr int BYTES = CHUNKS * CHUNK_BYTES;   // a consumer's
    uint32_t base;

    __device__ __forceinline__ explicit Staging(uint32_t both)
        : base(both + (threadIdx.x / WG_THREADS - 1) * BYTES) {}
    // every thread of the warpgroup: wait until the stores issued from
    // this staging have read it
    __device__ __forceinline__ void acquire() const {
        if (threadIdx.x % WG_THREADS == 0)
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        wg_sync();
    }
    // the address of byte b < 128 of row `row` < 64 of chunk c
    __device__ __forceinline__ uint32_t at(int c, int row, int b) const {
        return base + c * CHUNK_BYTES + row * 128 +
               (((b >> 4) ^ (row & 7)) << 4) + (b & 15);
    }
    // a bf16 pair (pack_bf16) at (row, col .. col + 1) of chunk c: col
    // even < 64
    __device__ __forceinline__ void put(int c, int row, int col,
                                        uint32_t pair) const {
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at(c, row, 2 * col)),
                     "r"(pair)
                     : "memory");
    }
    // an fp32 pair at (row, col .. col + 1) of chunk c: col even < 32
    __device__ __forceinline__ void put(int c, int row, int col,
                                        float2 pair) const {
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         at(c, row, 4 * col)),
                     "f"(pair.x), "f"(pair.y)
                     : "memory");
    }
    // every thread of the warpgroup: store chunk c < N at (column col[c],
    // row row0) of map[c]
    template <int N>
    __device__ __forceinline__ void release(const CUtensorMap* const (&map)[N],
                                            const int (&col)[N],
                                            int row0) const {
        static_assert(N <= CHUNKS, "the staging's chunks");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync();
        if (threadIdx.x % WG_THREADS == 0) {
#pragma unroll
            for (int c = 0; c < N; ++c)
                tma_store(map[c], base + c * CHUNK_BYTES, col[c], row0);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
    }
    // before the block ends: every store issued is done
    __device__ __forceinline__ void drain() const {
        if (threadIdx.x % WG_THREADS == 0)
            asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (no -lcuda);
// null where it cannot be reached
inline decltype(&cuTensorMapEncodeTiled) tma_encoder() {
    using Encode = decltype(&cuTensorMapEncodeTiled);
    static const Encode encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                             12000, cudaEnableDefault,
                                             &found) != cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            fn = nullptr;
        return reinterpret_cast<Encode>(fn);
    }();
    return encode;
}

// A TMA map of the row-major matrix p of T (bf16, fp32, or signed char:
// int8 codes, copied bit for bit as UINT8), rows × cols at a pitch of ld
// elements, read or written in boxes of 128 bytes of columns (64 bf16, 32
// fp32, 128 codes) × box_rows rows in the 128-byte swizzle: zero past its
// edges on loads, clipped on stores.  False where the encoder refuses it (a
// pointer or pitch off 16 bytes) or cannot be reached.
template <class T = bf16>
inline bool tma_map(CUtensorMap* map, const void* p, long long rows,
                    long long cols, long long ld, int box_rows) {
    static_assert(std::is_same<T, bf16>::value ||
                      std::is_same<T, float>::value ||
                      std::is_same<T, signed char>::value,
                  "bf16, fp32 or int8 codes");
    const auto encode = tma_encoder();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t pitch[1] = {(cuuint64_t)ld * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)(STEP_BYTES / sizeof(T)),
                               (cuuint32_t)box_rows};
    const cuuint32_t step[2] = {1, 1};
    return encode(map,
                  sizeof(T) == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(p), dims, pitch, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D TMA map of a (b, h, n, d) bf16 view with a contiguous head dim of
// d elements (2d = 32, 64 or 128 bytes, the swizzle span, so that the box
// is the layout smem_desc<..., 2d> reads) and (b, h, n) strides in
// elements, multiples of 16 bytes: dims (d, n, h, b) in any stride order,
// boxes of d × box_rows × 1 × 1, zero past n on loads.  A dim of extent 1
// is never stepped: it takes the span of the dims before it as its stride.
// False where the encoder refuses it or cannot be reached.
inline bool tma_map_4d(CUtensorMap* map, const void* p, int B, int H, int N,
                       int d, long long sb, long long sh, long long sn,
                       int box_rows) {
    const auto encode = tma_encoder();
    if (encode == nullptr || (d != 16 && d != 32 && d != 64)) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)H,
                                (cuuint64_t)B};
    long long pn = N > 1 ? 2 * sn : 2LL * d;
    long long ph = H > 1 ? 2 * sh : pn * N;
    long long pb = B > 1 ? 2 * sb : (pn * N > ph * H ? pn * N : ph * H);
    const cuuint64_t pitch[3] = {(cuuint64_t)pn, (cuuint64_t)ph,
                                 (cuuint64_t)pb};
    const cuuint32_t box[4] = {(cuuint32_t)d, (cuuint32_t)box_rows, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle = d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(p), dims, pitch, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the blocks of a persistent grid over `tiles` output tiles: one per SM
inline int persistent_blocks(long long tiles) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return (int)(tiles < sms ? tiles : sms);
}

}  // namespace vit
