// Cost breakdown of the 2D stencil contraction that the solver runs,
// csrc/stencil2d.cu's implicit GEMM, on Hopper (sm_90a): float32, F = 3,
// C -> C channels.
//
// Replaces the TPU microbenchmark kernel of scripts/stencil_breakdown_tpu.py
// (make_pallas -> kern, :55-105), which split the cost of the Pallas kernel
// that production ran on the TPU. This one splits the cost of the kernel
// production runs on the card. Each mode computes what the TPU kernel's
// mode of the same name computes:
//
//   full  y[b] = sum_{q1, q2} x[b + q - 1] @ W[q1, q2], zero-extended;
//   fill  the staging alone; writes y[:, j] = x[:, j - 1], y[:, 0] = 0;
//   mm    every tap's chunk gathered with shift 0 (no edge tests, no shift
//         arithmetic) and multiplied as in full: y = sum_q x @ W[q], full's
//         FLOP count (W is not pre-summed).
//
// Two families, picked by the precision:
// - highest (IEEE float32 FMA): a copy of stencil2d.cu's tile with a MODE
//   parameter. stencil2d.cu keeps its own code (sharing GEMM code through
//   a header moved stencil3d's device times by a few percent), so the
//   copy is tied to it by a bitwise check on the card instead: full at
//   TR 8 launches stencil2d's instance with stencil2d's plan and gives
//   bitwise the output of stencil.conv_blocked, K split included. A thread
//   block owns a BM x BN tile of y; each K chunk is BK channels of one
//   tap, its A rows gathered by cp.async with zero fill where the shifted
//   position leaves the grid, STAGES chunks in flight, TM x TN FFMA
//   register tiles read as 16-byte shared loads; the K split over
//   blockIdx.z writes partial tiles that reduce_splits adds in split
//   order. fill runs the same gathers and W copies (every tap, chunk and
//   split) with no FFMA and writes the (q1 = Q, q2 = 0) tap's chunk
//   straight from shared memory; it needs no split sum.
// - default (TF32): the same staging, then wgmma.mma_async m64n64k8
//   tf32 on the tensor cores, both operands K-major in shared memory with
//   a 128-byte swizzle, float32 sums in registers. A chunk is BK = 32
//   channels, one 128-byte swizzle row a position. tf32 wgmma takes no
//   transposed operand, and W[q, c0:c0+BK, n0:n0+BN] is N-contiguous, so
//   stencil_breakdown_prepare_w writes W^T (Cout x Cin a tap, padded with
//   zeros to whole chunks and tiles, rounded to TF32) once, outside the
//   timed chain, as an operator's setup would. wgmma truncates float32
//   operands to TF32; cp.async copies raw bits, so after a stage lands
//   each thread rounds the A units it copied to nearest (cvt.rna, as
//   round_tf32 in scripts/stencil_breakdown.py) in place, then fences the
//   generic proxy against the async one before the barrier. Each
//   warpgroup owns WM rows of the tile (one or two m64 tiles) and leaves
//   one chunk's wgmmas in flight while it rounds the next (so STAGES - 2
//   chunks are loaded ahead); all threads issue the copies. BN 128, three
//   stages and no wgmma left in flight were each timed against this tile
//   at 97 x 97 x 128 and 25 x 25 x 128, and none was faster at both. The
//   K split is family 1's (capped at this
//   family's chunk count). fill stages A and W^T and copies the tap's
//   chunk out unrounded (a copy must be exact); mm rounds and multiplies
//   as full does.
//
// TR, the TPU script's tile rows, selects the tile's positions: TR 8 is
// production's tile (BM 128; two m64 tiles for TF32), TR 16 a tile of
// twice the positions. STENCIL_BREAKDOWN_INSTANCES is the table;
// scripts/stencil_breakdown.py INSTANCES holds the same one and picks the
// plan (instance, split, vector path) for each shape.
//
// Bounds on an H100 SXM (700 W) at the script's shape, 97 x 97 blocks of
// 128 channels (x and y 4.8 MB each, W 0.6 MB):
//   full / mm, highest  2.78 GFLOP, 10.2 MB: 0.0414 ms at 67 TFLOP/s
//                       (float32 without tensor cores);
//   full / mm, default  2.78 GFLOP: 0.0056 ms at 495 TFLOP/s dense TF32;
//                       the 10.2 MB alone take 0.0030 ms at 3.35 TB/s;
//   fill                no FLOP, 9.6 MB (x in, y out): 0.0029 ms.
//
// The first design, the halo-tile kernel of csrc/stencil2d_tile.cuh that
// this breakdown took apart before stencil2d.cu was redesigned, stays as
// stencil_breakdown_v1_f32: a yardstick.

#include <cstdint>
#include <cuda_runtime.h>

#include "stencil2d_tile.cuh"

namespace breakdown_gemm {

constexpr int MODE_FULL = 0, MODE_FILL = 1, MODE_MM = 2;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; only the
// first `valid` bytes are read and the rest of the destination is zeroed.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int valid) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Distance of position b from both edges of an axis of length B, each
// clipped to 2 (Q <= 2), packed as lo | hi << 2; a shifted copy of the
// position at s in [-Q, Q] lies in the grid iff -lo <= s <= hi.
__device__ __forceinline__ int edges(int b, int B) {
    return min(b, 2) | (min(B - 1 - b, 2) << 2);
}
__device__ __forceinline__ bool inside(int e, int s) {
    return s >= -(e & 3) && s <= ((e >> 2) & 3);
}

// ---------------------------------------------------------------------
// Family 1: IEEE float32 FMA, stencil2d.cu's tile (float only)

template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_,
          bool VEC_>
struct GemmTile {
    using T = float;
    static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
    static constexpr int STAGES = STAGES_;
    static constexpr bool VEC = VEC_;
    using VT = float4;
    static constexpr int V = 4;                      // floats in 16 bytes
    static constexpr int NTN = BN / TN;              // threads along N
    static constexpr int NTM = BM / TM;              // threads along M
    static constexpr int THREADS = NTM * NTN;
    static constexpr int AP = BK + V;                // padded A row
    static constexpr int A_ELEMS = BM * AP;
    static constexpr int STAGE = A_ELEMS + BK * BN;  // A then B
    static constexpr int CU = VEC ? V : 1;           // elements per copy
    static constexpr int A_UNITS = BM * BK / CU;
    static constexpr int B_UNITS = BK * BN / CU;
    static constexpr int A_PER = (A_UNITS + THREADS - 1) / THREADS;
    static constexpr int B_PER = (B_UNITS + THREADS - 1) / THREADS;
    // at most 170 registers a thread: 3 blocks of 128 threads an SM
    static constexpr int MIN_BLOCKS = THREADS >= 384 ? 1 : 384 / THREADS;
    static_assert(BM % TM == 0 && BN % TN == 0, "threads do not tile");
    static_assert(TN % V == 0 && BK % V == 0, "16-byte fragments");
    static_assert(BN % CU == 0 && BK % CU == 0, "copy units");
    static_assert(BN % BK == 0, "fill: a chunk lies in one channel tile");
    static constexpr int SMEM = int(sizeof(T)) * STAGES * STAGE;  // bytes
    static_assert(SMEM <= 227 * 1024, "shared memory");

    // Copy W[q, c0:c0+BK, n0:n0+BN] into the stage's B, zero past Cin and
    // Cout (the thread's share of it).
    static __device__ __forceinline__ void load_b(T* bs,
                                                  const T* __restrict__ w,
                                                  int q, int c0, int n0,
                                                  int Cin, int Cout,
                                                  int tid) {
#pragma unroll
        for (int j = 0; j < B_PER; ++j) {
            const int u = tid + THREADS * j;
            if (u >= B_UNITS) break;
            const int r = u / (BN / CU), n = (u % (BN / CU)) * CU;
            const bool ok = c0 + r < Cin && n0 + n < Cout;
            const T* src =
                ok ? w + ((size_t)q * Cin + c0 + r) * Cout + n0 + n : w;
            cp_async<int(CU * sizeof(T))>(bs + r * BN + n, src,
                                          ok ? int(CU * sizeof(T)) : 0);
        }
    }

    // acc = the sum over the chunks t0 .. t1 - 1, STAGES - 1 of them in
    // flight: load(stage) copies the next chunk (A, then B through load_b)
    // into that stage of smem and advances to the chunk after it. FILL
    // runs no sweep: fill(as, t) reads chunk t's staged A instead.
    template <int MODE, typename Load, typename Fill>
    static __device__ __forceinline__ void run(const T* smem, int t0, int t1,
                                               Load& load, Fill& fill,
                                               T (&acc)[TM][TN], int tm,
                                               int tn) {
        if constexpr (MODE != MODE_FILL) {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
        }

#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) {
            if (t0 + s < t1) load(s);
            cp_async_commit();
        }
        for (int t = t0; t < t1; ++t) {
            cp_async_wait<STAGES - 2>();
            // chunk t has landed for every thread, and every thread is
            // done with the stage that the load below overwrites (chunk
            // t - 1's)
            __syncthreads();
            if (t + STAGES - 1 < t1)
                load((t - t0 + STAGES - 1) % STAGES);
            cp_async_commit();

            const T* as = smem + ((t - t0) % STAGES) * STAGE;
            const T* bs = as + A_ELEMS;
            if constexpr (MODE == MODE_FILL) {
                fill(as, t);
                continue;
            }
#pragma unroll
            for (int kv = 0; kv < BK; kv += V) {
                VT a[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    a[i] = *reinterpret_cast<const VT*>(
                        as + (tm + NTM * i) * AP + kv);
#pragma unroll
                for (int kk = 0; kk < V; ++kk) {
                    T b[TN];
#pragma unroll
                    for (int g = 0; g < TN / V; ++g) {
                        const VT bv = *reinterpret_cast<const VT*>(
                            bs + (kv + kk) * BN + (g * NTN + tn) * V);
#pragma unroll
                        for (int v = 0; v < V; ++v)
                            b[g * V + v] = reinterpret_cast<const T*>(&bv)[v];
                    }
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const T ai = reinterpret_cast<const T*>(&a[i])[kk];
#pragma unroll
                        for (int j = 0; j < TN; ++j)
                            acc[i][j] = fma_t(ai, b[j], acc[i][j]);
                    }
                }
            }
        }
        cp_async_wait<0>();
    }

    // The thread's sums into rows m0 .. of o (M x Cout, row-major),
    // columns n0 ..; nothing past M or Cout.
    static __device__ __forceinline__ void store(T* __restrict__ o,
                                                 const T (&acc)[TM][TN],
                                                 int m0, int n0, int M,
                                                 int Cout, int tm, int tn) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int p = m0 + tm + NTM * i;
            if (p >= M) continue;
            T* row = o + (size_t)p * Cout;
#pragma unroll
            for (int g = 0; g < TN / V; ++g) {
                const int n = n0 + (g * NTN + tn) * V;
                if (VEC) {
                    if (n < Cout) {
                        VT v;
#pragma unroll
                        for (int e = 0; e < V; ++e)
                            reinterpret_cast<T*>(&v)[e] = acc[i][g * V + e];
                        *reinterpret_cast<VT*>(row + n) = v;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < V; ++e)
                        if (n + e < Cout) row[n + e] = acc[i][g * V + e];
                }
            }
        }
    }
};

// y = sum over the splits s = 0, 1, .., S - 1 of ws[s], in that order.
template <typename T>
__global__ void __launch_bounds__(256)
reduce_splits(const T* __restrict__ ws, T* __restrict__ y, int S,
              size_t n) {
    for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < n;
         i += size_t(256) * gridDim.x) {
        T s = ws[i];
        for (int k = 1; k < S; ++k) s += ws[k * n + i];
        y[i] = s;
    }
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES, bool VEC,
          int MODE>
__global__ void __launch_bounds__(
    (GemmTile<BM, BN, TM, TN, BK, STAGES, VEC>::THREADS),
    (GemmTile<BM, BN, TM, TN, BK, STAGES, VEC>::MIN_BLOCKS))
breakdown_igemm(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int B1, int B2, int Cin, int Cout,
                int F) {
    using L = GemmTile<BM, BN, TM, TN, BK, STAGES, VEC>;
    constexpr int CU = L::CU;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* smem = reinterpret_cast<float*>(smem_raw);

    const int M = B1 * B2;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int Q = (F - 1) / 2;
    const int nck = (Cin + BK - 1) / BK;          // chunks per tap
    const int nchunks = F * F * nck;
    const int t0 = int((long long)nchunks * blockIdx.z / gridDim.z);
    const int t1 = int((long long)nchunks * (blockIdx.z + 1) / gridDim.z);
    const int tid = threadIdx.x;

    // the A rows this thread copies: position (or -1 past M) and edges
    int a_pos[L::A_PER], a_edge[L::A_PER];
#pragma unroll
    for (int j = 0; j < L::A_PER; ++j) {
        const int u = tid + L::THREADS * j;
        const int p = m0 + u / (BK / CU);
        a_pos[j] = -1;
        a_edge[j] = 0;
        if (u < L::A_UNITS && p < M) {
            a_pos[j] = p;
            if constexpr (MODE != MODE_MM)
                a_edge[j] = edges(p / B2, B1) | edges(p % B2, B2) << 4;
        }
    }

    // the next chunk to load: tap (q1, q2) = (s1, s2) + Q and its first
    // channel c0, advanced one chunk per load
    int c0, s1, s2;
    {
        const int q = t0 / nck;
        c0 = (t0 - q * nck) * BK;
        s1 = q / F - Q;
        s2 = q % F - Q;
    }
    auto load = [&](int stage) {
        float* as = smem + stage * L::STAGE;
        const int q = (s1 + Q) * F + s2 + Q;
        const int shift = s1 * B2 + s2;
#pragma unroll
        for (int j = 0; j < L::A_PER; ++j) {
            const int u = tid + L::THREADS * j;
            if (u >= L::A_UNITS) break;
            const int r = u / (BK / CU), k = (u % (BK / CU)) * CU;
            bool ok;
            const float* src;
            if constexpr (MODE == MODE_MM) {
                ok = a_pos[j] >= 0 && c0 + k < Cin;
                src = ok ? x + (size_t)a_pos[j] * Cin + c0 + k : x;
            } else {
                const int e = a_edge[j];
                ok = a_pos[j] >= 0 && inside(e, s1) && inside(e >> 4, s2) &&
                     c0 + k < Cin;
                src = ok ? x + (size_t)(a_pos[j] + shift) * Cin + c0 + k
                         : x;
            }
            cp_async<int(CU * sizeof(float))>(
                as + r * L::AP + k, src, ok ? int(CU * sizeof(float)) : 0);
        }
        L::load_b(as + L::A_ELEMS, w, q, c0, n0, Cin, Cout, tid);
        if ((c0 += BK) >= Cin) {
            c0 = 0;
            if (++s2 > Q) {
                s2 = -Q;
                ++s1;
            }
        }
    };
    // fill: chunk t of the (q1 = Q, q2 = 0) tap, if it lies in this
    // block's channels, from the stage to y (Cin = Cout)
    auto fill = [&](const float* as, int t) {
        const int q = t / nck, cf = (t - q * nck) * BK;
        if (q != Q * F || cf < n0 || cf >= n0 + BN) return;
        for (int u = tid; u < L::A_UNITS; u += L::THREADS) {
            const int r = u / (BK / CU), k = (u % (BK / CU)) * CU;
            if (m0 + r >= M) continue;
            float* row = out + (size_t)(m0 + r) * Cout + cf + k;
            if constexpr (VEC) {
                if (cf + k < Cout)
                    *reinterpret_cast<float4*>(row) =
                        *reinterpret_cast<const float4*>(as + r * L::AP + k);
            } else {
                if (cf + k < Cout) *row = as[r * L::AP + k];
            }
        }
    };

    const int tn = tid % L::NTN, tm = tid / L::NTN;
    float acc[TM][TN];
    L::template run<MODE>(smem, t0, t1, load, fill, acc, tm, tn);
    if constexpr (MODE != MODE_FILL)
        L::store(out + (size_t)blockIdx.z * M * Cout, acc, m0, n0, M, Cout,
                 tm, tn);
}

// y = the sum of the `split` partial sums in ws (n elements each), in
// split order, on stream s; returns the launch's CUDA error.
inline int sum_splits(const float* ws, float* y, int split, size_t n,
                      cudaStream_t s) {
    const int blocks = int(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
    reduce_splits<float><<<blocks, 256, 0, s>>>(ws, y, split, n);
    return int(cudaGetLastError());
}

// Launch one IEEE instance over the ceil(M / BM) x ceil(Cout / BN) output
// tiles and `split` K splits on stream s; full and mm write the splits
// into ws and reduce_splits sums them into y (split 1: straight into y),
// fill writes y itself. Returns the first CUDA error (0 on success).
template <int BM, int BN, int TM, int TN, int BK, int STAGES, bool VEC,
          int MODE>
int launch_igemm(const float* x, const float* w, float* y, float* ws,
                 int B1, int B2, int C, int split, cudaStream_t s) {
    using L = GemmTile<BM, BN, TM, TN, BK, STAGES, VEC>;
    auto kernel = breakdown_igemm<BM, BN, TM, TN, BK, STAGES, VEC, MODE>;
    if (L::SMEM > 48 * 1024) {
        // once per instance, before any launch (and so before a capture)
        static const cudaError_t set = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
        if (set != cudaSuccess) return int(set);
    }
    const int M = B1 * B2;
    const bool sum = MODE != MODE_FILL && split > 1;
    const dim3 grid((M + BM - 1) / BM, (C + BN - 1) / BN, split);
    kernel<<<grid, L::THREADS, L::SMEM, s>>>(x, w, sum ? ws : y, B1, B2, C,
                                            C, 3);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !sum) return int(err);
    return sum_splits(ws, y, split, size_t(M) * C, s);
}

// ---------------------------------------------------------------------
// Family 2: TF32 on the tensor cores through wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element k (0 .. 31) of row r in a K-major tile with the
// 128-byte swizzle: rows of 128 bytes, the 16-byte unit k / 4 of row r
// stored at unit (k / 4) ^ (r % 8). The tile starts 1024-byte aligned.
__device__ __forceinline__ int sw128(int r, int k) {
    return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

// wgmma matrix descriptor of a K-major, 128-byte-swizzled operand whose
// first row starts at shared address addr: 8-row groups 1024 bytes apart
// (SBO); the leading offset is unused by this layout. Moving addr by 32
// bytes moves one k8 step along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
           (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ float round_tf32(float v) {
    uint32_t u;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
    return __uint_as_float(u);
}

// generic-proxy writes of shared memory (cp.async, st.shared) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// keeps the compiler from moving accesses of d across the wgmma fences
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) += A (64 x 8) B (8 x 64), A and B TF32 in shared
// memory (descriptors da, db, both K-major). Thread l of warp w of the
// warpgroup holds d[4 j + 2 h + e] = d(16 w + l / 4 + 8 h, 8 j + 2 (l % 4)
// + e).
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], uint64_t da,
                                               uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

// One TF32 instance: a BM x BN tile of y, warpgroups of WM rows each (WM /
// 64 m64 tiles), K chunks of BK = 32 channels, STAGES chunks in flight.
// VEC: x's copies and y's stores move 16 and 8 bytes (Cin and Cout
// multiples of 4, aligned tensors); otherwise 4. W^T's copies are always
// 16 bytes (it is padded).
template <int BM_, int BN_, int WM_, int BK_, int STAGES_, bool VEC_>
struct WgmmaTile {
    static constexpr int BM = BM_, BN = BN_, WM = WM_, BK = BK_;
    static constexpr int STAGES = STAGES_;
    static constexpr bool VEC = VEC_;
    static constexpr int WGS = BM / WM;              // warpgroups
    static constexpr int THREADS = 128 * WGS;
    static constexpr int MT = WM / 64;               // m64 tiles a warpgroup
    static constexpr int CU = VEC ? 4 : 1;           // floats per A copy
    static constexpr int A_BYTES = BM * 128;
    static constexpr int B_BYTES = BN * 128;
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr int A_UNITS = BM * BK / CU;
    static constexpr int B_UNITS = BN * BK / 4;
    static constexpr int A_PER = (A_UNITS + THREADS - 1) / THREADS;
    static constexpr int B_PER = (B_UNITS + THREADS - 1) / THREADS;
    static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment
    static_assert(BK == 32, "a position's chunk is one 128-byte row");
    // wgmma groups a warpgroup leaves in flight when it moves on to the
    // next chunk, and so the chunks loaded ahead of the one consumed
    static constexpr int LAG = 1;
    static constexpr int AHEAD = STAGES - 1 - LAG;
    static_assert(AHEAD >= 1, "stages");
    static_assert(BN == 64, "one m64n64k8 wgmma per m64 tile and k8 step");
    static_assert(WM % 64 == 0 && BM % WM == 0, "m64 tiles");
    static_assert(STAGE % 1024 == 0, "swizzled tiles 1024-byte aligned");
    static_assert(BN % BK == 0, "fill: a chunk lies in one channel tile");
    static_assert(SMEM <= 227 * 1024, "shared memory");
};

template <int BM, int BN, int WM, int BK, int STAGES, bool VEC, int MODE>
__global__ void __launch_bounds__(
    (WgmmaTile<BM, BN, WM, BK, STAGES, VEC>::THREADS), 1)
breakdown_wgmma(const float* __restrict__ x, const float* __restrict__ wt,
                float* __restrict__ out, int B1, int B2, int Cin, int Cout,
                int F) {
    using L = WgmmaTile<BM, BN, WM, BK, STAGES, VEC>;
    constexpr int CU = L::CU;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

    const int M = B1 * B2;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int Q = (F - 1) / 2;
    const int nck = (Cin + BK - 1) / BK;          // chunks per tap
    const int nchunks = F * F * nck;
    const int Kp = nck * BK, Np = gridDim.y * BN;  // W^T's padded shape
    const int t0 = int((long long)nchunks * blockIdx.z / gridDim.z);
    const int t1 = int((long long)nchunks * (blockIdx.z + 1) / gridDim.z);
    const int tid = threadIdx.x;

    int a_pos[L::A_PER], a_edge[L::A_PER];
#pragma unroll
    for (int j = 0; j < L::A_PER; ++j) {
        const int u = tid + L::THREADS * j;
        const int p = m0 + u / (BK / CU);
        a_pos[j] = -1;
        a_edge[j] = 0;
        if (u < L::A_UNITS && p < M) {
            a_pos[j] = p;
            if constexpr (MODE != MODE_MM)
                a_edge[j] = edges(p / B2, B1) | edges(p % B2, B2) << 4;
        }
    }

    int c0, s1, s2;
    {
        const int q = t0 / nck;
        c0 = (t0 - q * nck) * BK;
        s1 = q / F - Q;
        s2 = q % F - Q;
    }
    auto load = [&](int stage) {
        unsigned char* as = smem + stage * L::STAGE;
        unsigned char* bs = as + L::A_BYTES;
        const int q = (s1 + Q) * F + s2 + Q;
        const int shift = s1 * B2 + s2;
#pragma unroll
        for (int j = 0; j < L::A_PER; ++j) {
            const int u = tid + L::THREADS * j;
            if (u >= L::A_UNITS) break;
            const int r = u / (BK / CU), k = (u % (BK / CU)) * CU;
            bool ok;
            const float* src;
            if constexpr (MODE == MODE_MM) {
                ok = a_pos[j] >= 0 && c0 + k < Cin;
                src = ok ? x + (size_t)a_pos[j] * Cin + c0 + k : x;
            } else {
                const int e = a_edge[j];
                ok = a_pos[j] >= 0 && inside(e, s1) && inside(e >> 4, s2) &&
                     c0 + k < Cin;
                src = ok ? x + (size_t)(a_pos[j] + shift) * Cin + c0 + k
                         : x;
            }
            cp_async<CU * 4>(as + sw128(r, k), src, ok ? CU * 4 : 0);
        }
#pragma unroll
        for (int j = 0; j < L::B_PER; ++j) {
            const int u = tid + L::THREADS * j;
            if (u >= L::B_UNITS) break;
            const int n = u / (BK / 4), k = (u % (BK / 4)) * 4;
            cp_async<16>(bs + sw128(n, k),
                         wt + ((size_t)q * Np + n0 + n) * Kp + c0 + k, 16);
        }
        if ((c0 += BK) >= Cin) {
            c0 = 0;
            if (++s2 > Q) {
                s2 = -Q;
                ++s1;
            }
        }
    };
    // the A units this thread copied into a stage, rounded to TF32 in place
    auto round_a = [&](int stage) {
        unsigned char* as = smem + stage * L::STAGE;
#pragma unroll
        for (int j = 0; j < L::A_PER; ++j) {
            const int u = tid + L::THREADS * j;
            if (u >= L::A_UNITS) break;
            const int r = u / (BK / CU), k = (u % (BK / CU)) * CU;
            float* p = reinterpret_cast<float*>(as + sw128(r, k));
            if constexpr (VEC) {
                float4 v = *reinterpret_cast<float4*>(p);
                v.x = round_tf32(v.x);
                v.y = round_tf32(v.y);
                v.z = round_tf32(v.z);
                v.w = round_tf32(v.w);
                *reinterpret_cast<float4*>(p) = v;
            } else {
                *p = round_tf32(*p);
            }
        }
    };
    auto fill = [&](int stage, int t) {
        const int q = t / nck, cf = (t - q * nck) * BK;
        if (q != Q * F || cf < n0 || cf >= n0 + BN) return;
        const unsigned char* as = smem + stage * L::STAGE;
        for (int u = tid; u < L::A_UNITS; u += L::THREADS) {
            const int r = u / (BK / CU), k = (u % (BK / CU)) * CU;
            if (m0 + r >= M || cf + k >= Cout) continue;
            float* row = out + (size_t)(m0 + r) * Cout + cf + k;
            if constexpr (VEC)
                *reinterpret_cast<float4*>(row) =
                    *reinterpret_cast<const float4*>(as + sw128(r, k));
            else
                *row = *reinterpret_cast<const float*>(as + sw128(r, k));
        }
    };

    const int wg = tid / 128;
    float acc[L::MT][32];
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;

    // AHEAD chunks in flight; a warpgroup's wgmmas on chunk t run on while
    // it rounds chunk t + 1 (LAG 1)
    constexpr int AHEAD = L::AHEAD;
#pragma unroll
    for (int s = 0; s < AHEAD; ++s) {
        if (t0 + s < t1) load(s);
        cp_async_commit();
    }
    for (int t = t0; t < t1; ++t) {
        const int stage = (t - t0) % STAGES;
        cp_async_wait<AHEAD - 1>();
        if constexpr (MODE != MODE_FILL) {
            round_a(stage);
            fence_proxy_async();
        }
        // chunk t has landed and is rounded for every thread, and every
        // warpgroup's wgmmas on the stage that the load below overwrites
        // (chunk t - 1 - LAG's) have completed
        __syncthreads();
        if (t + AHEAD < t1) load((t - t0 + AHEAD) % STAGES);
        cp_async_commit();
        if constexpr (MODE == MODE_FILL) {
            fill(stage, t);
        } else {
            const uint32_t a = smem_u32(smem + stage * L::STAGE) +
                               wg * WM * 128;
            const uint32_t b = smem_u32(smem + stage * L::STAGE + L::A_BYTES);
#pragma unroll
            for (int i = 0; i < L::MT; ++i) fence_acc(acc[i]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
                for (int i = 0; i < L::MT; ++i)
                    wgmma_m64n64k8(acc[i],
                                   sw128_desc(a + i * 64 * 128 + kk * 32),
                                   sw128_desc(b + kk * 32));
            wgmma_commit();
            wgmma_wait<L::LAG>();
#pragma unroll
            for (int i = 0; i < L::MT; ++i) fence_acc(acc[i]);
        }
    }
    cp_async_wait<0>();
    if constexpr (MODE == MODE_FILL) {
        return;
    } else {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < L::MT; ++i) fence_acc(acc[i]);
    }

    float* o = out + (size_t)blockIdx.z * M * Cout;
    const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
    for (int i = 0; i < L::MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int p = m0 + wg * WM + 64 * i + 16 * warp + lane / 4 + 8 * h;
            if (p >= M) continue;
            float* row = o + (size_t)p * Cout;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const int n = n0 + 8 * j + 2 * (lane % 4);
                const float v0 = acc[i][4 * j + 2 * h];
                const float v1 = acc[i][4 * j + 2 * h + 1];
                if constexpr (VEC) {
                    if (n < Cout)
                        *reinterpret_cast<float2*>(row + n) =
                            make_float2(v0, v1);
                } else {
                    if (n < Cout) row[n] = v0;
                    if (n + 1 < Cout) row[n + 1] = v1;
                }
            }
        }
    }
}

template <int BM, int BN, int WM, int BK, int STAGES, bool VEC, int MODE>
int launch_wgmma(const float* x, const float* wt, float* y, float* ws,
                 int B1, int B2, int C, int split, cudaStream_t s) {
    using L = WgmmaTile<BM, BN, WM, BK, STAGES, VEC>;
    auto kernel = breakdown_wgmma<BM, BN, WM, BK, STAGES, VEC, MODE>;
    static const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (set != cudaSuccess) return int(set);
    const int M = B1 * B2;
    const bool sum = MODE != MODE_FILL && split > 1;
    const dim3 grid((M + BM - 1) / BM, (C + BN - 1) / BN, split);
    kernel<<<grid, L::THREADS, L::SMEM, s>>>(x, wt, sum ? ws : y, B1, B2, C,
                                            C, 3);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !sum) return int(err);
    return sum_splits(ws, y, split, size_t(M) * C, s);
}

// W^T of every tap, rounded to TF32: wt[q, n, k] = rna(w[q, k, n]) for
// n < C and k < C, zero up to Np x Kp.
__global__ void __launch_bounds__(256)
prepare_wt(const float* __restrict__ w, float* __restrict__ wt, int C,
           int Kp, int Np, int taps) {
    const size_t total = size_t(taps) * Np * Kp;
    for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < total;
         i += size_t(256) * gridDim.x) {
        const int k = int(i % Kp), n = int(i / Kp % Np);
        const int q = int(i / (size_t(Kp) * Np));
        wt[i] = n < C && k < C
                    ? round_tf32(w[(size_t(q) * C + k) * C + n])
                    : 0.f;
    }
}

// The instances: id, precision (0 IEEE FMA, 1 TF32), TR, BM, BN, TM, TN,
// BK, STAGES. IEEE: TM x TN sums a thread; 0 and 1 are stencil2d.cu's
// float32 instances 0 (9 output channels up) and 1 (up to 8), 2 and 3 the
// same tiles with twice the positions. TF32: TM rows a warpgroup, TN the
// wgmma's N. scripts/stencil_breakdown.py INSTANCES holds the same table.
#define STENCIL_BREAKDOWN_INSTANCES(X)        \
    X(0, 0, 8, 128, 64, 8, 8, 16, 4)          \
    X(1, 0, 8, 256, 8, 8, 4, 8, 3)            \
    X(2, 0, 16, 256, 64, 8, 8, 16, 4)         \
    X(3, 0, 16, 512, 8, 8, 4, 8, 3)           \
    X(4, 1, 8, 128, 64, 64, 64, 32, 4)        \
    X(5, 1, 16, 256, 64, 128, 64, 32, 4)

template <int PREC, int BM, int BN, int TM, int TN, int BK, int ST, bool VEC,
          int MODE>
int launch_instance(const float* x, const float* w, float* y, float* ws,
                    int B1, int B2, int C, int split, cudaStream_t s) {
    if constexpr (PREC == 0)
        return launch_igemm<BM, BN, TM, TN, BK, ST, VEC, MODE>(
            x, w, y, ws, B1, B2, C, split, s);
    else
        return launch_wgmma<BM, BN, TM, BK, ST, VEC, MODE>(
            x, w, y, ws, B1, B2, C, split, s);
}

template <int PREC, int BM, int BN, int TM, int TN, int BK, int ST>
int by_mode(const float* x, const float* w, float* y, float* ws, int B1,
            int B2, int C, int split, int vec, int mode, cudaStream_t s) {
#define BREAKDOWN_MODE(V)                                                  \
    switch (mode) {                                                        \
        case MODE_FULL:                                                    \
            return launch_instance<PREC, BM, BN, TM, TN, BK, ST, V,        \
                                   MODE_FULL>(x, w, y, ws, B1, B2, C,      \
                                              split, s);                   \
        case MODE_FILL:                                                    \
            return launch_instance<PREC, BM, BN, TM, TN, BK, ST, V,        \
                                   MODE_FILL>(x, w, y, ws, B1, B2, C,      \
                                              split, s);                   \
        case MODE_MM:                                                      \
            return launch_instance<PREC, BM, BN, TM, TN, BK, ST, V,        \
                                   MODE_MM>(x, w, y, ws, B1, B2, C, split, \
                                            s);                            \
        default:                                                           \
            return int(cudaErrorInvalidValue);                             \
    }
    if (vec) {
        BREAKDOWN_MODE(true)
    } else {
        BREAKDOWN_MODE(false)
    }
#undef BREAKDOWN_MODE
    return int(cudaErrorInvalidValue);
}

// An instance's threads and shared-memory bytes.
template <int PREC, int BM, int BN, int TM, int TN, int BK, int ST>
void tile_info(int& threads, int& smem) {
    if constexpr (PREC == 0) {
        using L = GemmTile<BM, BN, TM, TN, BK, ST, true>;
        threads = L::THREADS;
        smem = L::SMEM;
    } else {
        using L = WgmmaTile<BM, BN, TM, BK, ST, true>;
        threads = L::THREADS;
        smem = L::SMEM;
    }
}

}  // namespace breakdown_gemm

// Plain C interface for ctypes: each returns cudaGetLastError() after its
// launches (0 on success); nothing here synchronises or allocates.
//
// The breakdown: x and y (B1, B2, C) float32, row-major; w is W (3, 3, C,
// C) for an IEEE instance and stencil_breakdown_prepare_w's W^T for a TF32
// one; mode 0 full, 1 fill, 2 mm; ws holds split (B1 B2, C) partial sums
// when split > 1 and the mode is not fill (else it may be null); vec: the
// 16-byte copy path (C a multiple of 4, aligned tensors).
extern "C" int stencil_breakdown_f32(const float* x, const float* w,
                                     float* y, float* ws, int B1, int B2,
                                     int C, int instance, int split, int vec,
                                     int mode, void* stream) {
    using namespace breakdown_gemm;
    if (B1 <= 0 || B2 <= 0 || C <= 0 || split < 1 || split > 64 ||
        mode < MODE_FULL || mode > MODE_MM ||
        (split > 1 && mode != MODE_FILL && ws == nullptr))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BREAKDOWN_CASE(ID, PREC, TR, BM, BN, TM, TN, BK, ST)              \
    if (instance == ID)                                                    \
        return by_mode<PREC, BM, BN, TM, TN, BK, ST>(x, w, y, ws, B1, B2,  \
                                                     C, split, vec, mode,  \
                                                     s);
    STENCIL_BREAKDOWN_INSTANCES(BREAKDOWN_CASE)
#undef BREAKDOWN_CASE
    return int(cudaErrorInvalidValue);
}

// W (3, 3, C, C) -> W^T for TF32 instance `instance`: wt (9, Np, Kp) with
// Kp = C rounded up to the instance's BK and Np to its BN.
extern "C" int stencil_breakdown_prepare_w(const float* w, float* wt, int C,
                                           int instance, void* stream) {
    using namespace breakdown_gemm;
    if (C <= 0) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BREAKDOWN_PREP(ID, PREC, TR, BM, BN, TM, TN, BK, ST)                \
    if (instance == ID && PREC == 1) {                                       \
        const int Kp = (C + BK - 1) / BK * BK, Np = (C + BN - 1) / BN * BN;  \
        const size_t n = size_t(9) * Np * Kp;                                \
        const int blocks = int(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);     \
        prepare_wt<<<blocks, 256, 0, s>>>(w, wt, C, Kp, Np, 9);              \
        return int(cudaGetLastError());                                      \
    }
    STENCIL_BREAKDOWN_INSTANCES(BREAKDOWN_PREP)
#undef BREAKDOWN_PREP
    return int(cudaErrorInvalidValue);
}

// Instance `id`'s precision, TR, BM, BN, TM, TN, BK, STAGES, threads and
// shared-memory bytes into out[0..9]; returns 0, or cudaErrorInvalidValue
// for an unknown id.
extern "C" int stencil_breakdown_instance(int id, int* out) {
    using namespace breakdown_gemm;
#define BREAKDOWN_INFO(ID, PREC, TR, BM, BN, TM, TN, BK, ST)                \
    if (id == ID) {                                                         \
        int threads, smem;                                                  \
        tile_info<PREC, BM, BN, TM, TN, BK, ST>(threads, smem);             \
        const int v[10] = {PREC, TR, BM, BN, TM, TN, BK, ST, threads, smem}; \
        for (int i = 0; i < 10; ++i) out[i] = v[i];                         \
        return 0;                                                           \
    }
    STENCIL_BREAKDOWN_INSTANCES(BREAKDOWN_INFO)
#undef BREAKDOWN_INFO
    return int(cudaErrorInvalidValue);
}

// The first design, the halo-tile kernel of csrc/stencil2d_tile.cuh, a
// yardstick: x and y (B1, B2, C), W (3, 3, C, C), all float32, row-major;
// mode 0 full, 1 fill, 2 mm; prec 0 highest (FMA), 1 default (TF32
// mma.sync); TR the tile rows, 8 or 16.
namespace {

template <int TH, int MODE, bool TF32>
int run_v1(const float* x, const float* w, float* y, int B1, int B2, int C,
           cudaStream_t s) {
    return launch<float, 3, TH, MODE, TF32>(x, w, y, B1, B2, C, C, s);
}

template <int TH>
int by_mode_v1(const float* x, const float* w, float* y, int B1, int B2,
               int C, int mode, int tf32, cudaStream_t s) {
    switch (mode) {
        case FULL:
            return tf32 ? run_v1<TH, FULL, true>(x, w, y, B1, B2, C, s)
                        : run_v1<TH, FULL, false>(x, w, y, B1, B2, C, s);
        case FILL:
            return run_v1<TH, FILL, false>(x, w, y, B1, B2, C, s);
        case MM:
            return tf32 ? run_v1<TH, MM, true>(x, w, y, B1, B2, C, s)
                        : run_v1<TH, MM, false>(x, w, y, B1, B2, C, s);
        default:
            return int(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int stencil_breakdown_v1_f32(const float* x, const float* w,
                                        float* y, int B1, int B2, int C,
                                        int TR, int mode, int prec,
                                        void* stream) {
    if (B1 <= 0 || B2 <= 0 || C <= 0 || (prec != 0 && prec != 1))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (TR) {
        case 8: return by_mode_v1<8>(x, w, y, B1, B2, C, mode, prec, s);
        case 16: return by_mode_v1<16>(x, w, y, B1, B2, C, mode, prec, s);
        default: return int(cudaErrorInvalidValue);
    }
}
