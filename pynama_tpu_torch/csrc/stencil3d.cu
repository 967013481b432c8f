// Blocked 3D stencil contraction for Hopper (sm_90a), float and double.
//
//   y[b1, b2, b3, co] = sum_{q1, q2, q3 < F} sum_ci
//                       x[b1 + q1 - Q, b2 + q2 - Q, b3 + q3 - Q, ci]
//                       * W[q1, q2, q3, ci, co]
//
// with x zero-extended outside [0, B1) x [0, B2) x [0, B3) and
// Q = (F - 1) / 2, F in {3, 5}. Layouts are row-major: x (B1, B2, B3, Cin),
// W (F, F, F, Cin, Cout), y (B1, B2, B3, Cout). Every 3D operator apply of
// the spectral-element solver (K, Rw, Curl, SrT, DivSrT and the
// vertex-star patch smoother) is this contraction on the parity- or
// super-blocked node grid.
//
// Replaces the TPU kernel pynama_tpu/ops/pallas_stencil.py _kernel3d_xc
// (called from _conv3d_pallas), and so also its "flat" variant _kernel3d,
// which computes the same function. The TPU kernel's row stripes,
// flat-window pitches and axis-3 tap folding answer a sequential grid and
// a 128-wide matrix unit; none of that carries over.
//
// Bound on an H100 SXM (700 W): the channel3d fine-level K apply (41 x 17
// x 17 blocks, 192 -> 192 channels, F = 3) is 23.6 GFLOP and moves about
// 22 MB, so it is bound by arithmetic: about 0.35 ms at the 67 TFLOP/s
// float32 CUDA-core peak against about 7 us for the bytes at 3.35 TB/s.
// The products stay in IEEE FMA (no TF32): lower precision breaks the
// Chebyshev-smoothed multigrid V-cycle.
//
// Design: an implicit GEMM over linearised positions. With M = B1 B2 B3
// positions, N = Cout and K = F^3 Cin, y (M, N) = A (M, K) W (K, N),
// where row p of A holds the Cin channels of x at b(p) + q - Q for every
// tap q. A thread block owns a BM x BN tile of y and walks K in chunks of
// BK channels of one tap:
// - the A chunk is a gather of BM rows of x shifted by the tap, copied
//   with cp.async and zero-filled (source size 0) where the shifted
//   position leaves the grid, so no padded copy of x exists; the B chunk
//   W[q, c0:c0+BK, n0:n0+BN] is contiguous. STAGES chunks are in flight:
//   the next ones load while this one multiplies.
// - A is staged position-major with BK (+ one 16-byte pad against bank
//   conflicts) channels a row; each thread owns TM x TN sums, rows
//   tm + (BM/TM) i and 16-byte column groups interleaved over the
//   threads, and reads its A fragment as one 16-byte load per row for V
//   channels (V = 16 bytes / sizeof(T)) and its B fragment as TN/V
//   16-byte loads per channel: TM + TN loads per V TM TN FMAs, one per 16
//   at 8 x 8 floats, where an SM issues one shared load per four FMAs.
// - Linear positions waste only the last tile's tail (99.5% of the
//   computed positions are real at 41 x 17 x 17 with BM 128).
// - Split K: a shape with fewer tiles than the card has SMs (the coarse
//   multigrid levels) splits the chunk sequence over blockIdx.z; each
//   split writes its partial tile to a workspace and a second kernel adds
//   the splits in their order. No atomics: the same inputs give bitwise
//   the same output on every launch and in every CUDA-graph replay.
// The host (ops/stencil.py plan3d) picks the instance, the split and the
// vector path for each shape; stencil3d_instance() reports each
// instance's tile so that the host's table can be checked against this
// one.

#include <cuda_runtime.h>

#include "stencil3d_v1.cuh"

namespace {

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
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

// One instance: a BM x BN tile of y over THREADS threads of TM x TN sums,
// K chunks of BK channels, STAGES chunks in flight. VEC: every global copy
// and store moves 16 bytes (Cin and Cout multiples of V, 16-byte aligned
// tensors); otherwise one element at a time.
template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES,
          bool VEC>
struct Tile {
    static constexpr int V = 16 / int(sizeof(T));  // elements in 16 bytes
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
    static constexpr int SMEM = int(sizeof(T)) * STAGES * STAGE;  // bytes
    static_assert(SMEM <= 227 * 1024, "shared memory");
};

// Distance of position b from both edges of an axis of length B, each
// clipped to 2 (Q <= 2), packed as lo | hi << 2; a shifted copy of the
// position at s in [-Q, Q] lies in the grid iff -lo <= s <= hi.
__device__ __forceinline__ int edges(int b, int B) {
    return min(b, 2) | (min(B - 1 - b, 2) << 2);
}
__device__ __forceinline__ bool inside(int e, int s) {
    return s >= -(e & 3) && s <= ((e >> 2) & 3);
}

template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES,
          bool VEC>
__global__ void __launch_bounds__(
    (Tile<T, BM, BN, TM, TN, BK, STAGES, VEC>::THREADS),
    (Tile<T, BM, BN, TM, TN, BK, STAGES, VEC>::MIN_BLOCKS))
stencil3d_igemm(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int B1, int B2, int B3, int Cin,
                int Cout, int F) {
    using L = Tile<T, BM, BN, TM, TN, BK, STAGES, VEC>;
    using VT = typename Vec<T>::type;
    constexpr int V = L::V, NTN = L::NTN, NTM = L::NTM, CU = L::CU;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int M = B1 * B2 * B3;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int Q = (F - 1) / 2;
    const int nck = (Cin + BK - 1) / BK;          // chunks per tap
    const int nchunks = F * F * F * nck;
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
            const int b3 = p % B3, b2 = (p / B3) % B2, b1 = p / (B3 * B2);
            a_pos[j] = p;
            a_edge[j] = edges(b1, B1) | edges(b2, B2) << 4 |
                        edges(b3, B3) << 8;
        }
    }

    // the next chunk to load: tap (q1, q2, q3) = (s1, s2, s3) + Q and its
    // first channel c0, advanced one chunk per load
    int c0, s1, s2, s3;
    {
        const int q = t0 / nck;
        c0 = (t0 - q * nck) * BK;
        s1 = q / (F * F) - Q;
        s2 = (q / F) % F - Q;
        s3 = q % F - Q;
    }
    auto load = [&](int stage) {
        T* as = smem + stage * L::STAGE;
        T* bs = as + L::A_ELEMS;
        const int q = ((s1 + Q) * F + s2 + Q) * F + s3 + Q;
        const int shift = (s1 * B2 + s2) * B3 + s3;
#pragma unroll
        for (int j = 0; j < L::A_PER; ++j) {
            const int u = tid + L::THREADS * j;
            if (u >= L::A_UNITS) break;
            const int r = u / (BK / CU), k = (u % (BK / CU)) * CU;
            const int e = a_edge[j];
            const bool ok = a_pos[j] >= 0 && inside(e, s1) &&
                            inside(e >> 4, s2) && inside(e >> 8, s3) &&
                            c0 + k < Cin;
            const T* src =
                ok ? x + (size_t)(a_pos[j] + shift) * Cin + c0 + k : x;
            cp_async<int(CU * sizeof(T))>(as + r * L::AP + k, src,
                                     ok ? int(CU * sizeof(T)) : 0);
        }
#pragma unroll
        for (int j = 0; j < L::B_PER; ++j) {
            const int u = tid + L::THREADS * j;
            if (u >= L::B_UNITS) break;
            const int r = u / (BN / CU), n = (u % (BN / CU)) * CU;
            const bool ok = c0 + r < Cin && n0 + n < Cout;
            const T* src =
                ok ? w + ((size_t)q * Cin + c0 + r) * Cout + n0 + n : w;
            cp_async<int(CU * sizeof(T))>(bs + r * BN + n, src,
                                     ok ? int(CU * sizeof(T)) : 0);
        }
        if ((c0 += BK) >= Cin) {
            c0 = 0;
            if (++s3 > Q) {
                s3 = -Q;
                if (++s2 > Q) {
                    s2 = -Q;
                    ++s1;
                }
            }
        }
    };

    const int tn = tid % NTN, tm = tid / NTN;
    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (t0 + s < t1) load(s);
        cp_async_commit();
    }
    for (int t = t0; t < t1; ++t) {
        cp_async_wait<STAGES - 2>();
        // chunk t has landed for every thread, and every thread is done
        // with the stage that the load below overwrites (chunk t - 1's)
        __syncthreads();
        if (t + STAGES - 1 < t1)
            load((t - t0 + STAGES - 1) % STAGES);
        cp_async_commit();

        const T* as = smem + ((t - t0) % STAGES) * L::STAGE;
        const T* bs = as + L::A_ELEMS;
#pragma unroll
        for (int kv = 0; kv < BK; kv += V) {
            VT a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                a[i] = *reinterpret_cast<const VT*>(
                    as + (tm + NTM * i) * L::AP + kv);
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

    T* o = out + (size_t)blockIdx.z * M * Cout;
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

template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES,
          bool VEC>
int launch_tile(const T* x, const T* w, T* y, T* ws, int B1, int B2, int B3,
                int Cin, int Cout, int F, int split, cudaStream_t s) {
    using L = Tile<T, BM, BN, TM, TN, BK, STAGES, VEC>;
    if (L::SMEM > 48 * 1024) {
        // once per instance, before any launch (and so before a capture)
        static const cudaError_t set = cudaFuncSetAttribute(
            stencil3d_igemm<T, BM, BN, TM, TN, BK, STAGES, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
        if (set != cudaSuccess) return int(set);
    }
    const int M = B1 * B2 * B3;
    const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, split);
    stencil3d_igemm<T, BM, BN, TM, TN, BK, STAGES, VEC>
        <<<grid, L::THREADS, L::SMEM, s>>>(x, w, split > 1 ? ws : y, B1, B2,
                                           B3, Cin, Cout, F);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || split == 1) return int(err);
    const size_t n = size_t(M) * Cout;
    const int blocks = int(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
    reduce_splits<T><<<blocks, 256, 0, s>>>(ws, y, split, n);
    return int(cudaGetLastError());
}

// The instances: id, element type, BM, BN, TM, TN, BK, STAGES.
// ops/stencil.py INSTANCES3D holds the same table. 0 serves float32 from
// 25 output channels up, 1 the 24-channel layouts, 2 float64.
#define STENCIL3D_INSTANCES(X)              \
    X(0, float, 128, 64, 8, 8, 16, 4)       \
    X(1, float, 128, 24, 8, 4, 8, 3)        \
    X(2, double, 64, 64, 4, 8, 8, 3)

template <typename T>
int dispatch(const T* x, const T* w, T* y, T* ws, int B1, int B2, int B3,
             int Cin, int Cout, int F, int instance, int split, int vec,
             void* stream) {
    if (B1 <= 0 || B2 <= 0 || B3 <= 0 || Cin <= 0 || Cout <= 0 ||
        (F != 3 && F != 5) || split < 1 || split > 64 ||
        (split > 1 && ws == nullptr))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STENCIL3D_CASE(ID, TYPE, BM, BN, TM, TN, BK, ST)                   \
    if (instance == ID) {                                                   \
        if constexpr (sizeof(TYPE) == sizeof(T)) {                          \
            auto run = vec ? launch_tile<T, BM, BN, TM, TN, BK, ST, true>   \
                           : launch_tile<T, BM, BN, TM, TN, BK, ST, false>; \
            return run(x, w, y, ws, B1, B2, B3, Cin, Cout, F, split, s);    \
        }                                                                   \
    }
    STENCIL3D_INSTANCES(STENCIL3D_CASE)
#undef STENCIL3D_CASE
    return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes: each returns cudaGetLastError() after its
// launches (0 on success); nothing here synchronises or allocates. ws
// holds split (M, Cout) partial sums when split > 1 (else it may be null).
extern "C" int stencil3d_f32(const float* x, const float* w, float* y,
                             float* ws, int B1, int B2, int B3, int Cin,
                             int Cout, int F, int instance, int split,
                             int vec, void* stream) {
    return dispatch<float>(x, w, y, ws, B1, B2, B3, Cin, Cout, F, instance,
                           split, vec, stream);
}

extern "C" int stencil3d_f64(const double* x, const double* w, double* y,
                             double* ws, int B1, int B2, int B3, int Cin,
                             int Cout, int F, int instance, int split,
                             int vec, void* stream) {
    return dispatch<double>(x, w, y, ws, B1, B2, B3, Cin, Cout, F, instance,
                            split, vec, stream);
}

// Instance `id`'s element size in bytes, BM, BN, TM, TN, BK, STAGES,
// threads and shared-memory bytes into out[0..8]; returns 0, or
// cudaErrorInvalidValue for an unknown id.
extern "C" int stencil3d_instance(int id, int* out) {
#define STENCIL3D_INFO(ID, TYPE, BM, BN, TM, TN, BK, ST)                 \
    if (id == ID) {                                                      \
        using L = Tile<TYPE, BM, BN, TM, TN, BK, ST, true>;              \
        const int v[9] = {int(sizeof(TYPE)), BM, BN, TM, TN, BK, ST,     \
                          L::THREADS, L::SMEM};                          \
        for (int i = 0; i < 9; ++i) out[i] = v[i];                       \
        return 0;                                                        \
    }
    STENCIL3D_INSTANCES(STENCIL3D_INFO)
#undef STENCIL3D_INFO
    return int(cudaErrorInvalidValue);
}

// The first design (stencil3d_v1.cuh), a yardstick only.
extern "C" int stencil3d_v1_f32(const float* x, const float* w, float* y,
                                int B1, int B2, int B3, int Cin, int Cout,
                                int F, void* stream) {
    return stencil3d_v1::dispatch<float>(x, w, y, B1, B2, B3, Cin, Cout, F,
                                         stream);
}

extern "C" int stencil3d_v1_f64(const double* x, const double* w, double* y,
                                int B1, int B2, int B3, int Cin, int Cout,
                                int F, void* stream) {
    return stencil3d_v1::dispatch<double>(x, w, y, B1, B2, B3, Cin, Cout, F,
                                          stream);
}
