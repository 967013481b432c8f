// The first design of the tiled 2D stencil kernel for Hopper (sm_90a), a
// yardstick: csrc/stencil2d.cu launches its MODE FULL, IEEE FMA, TH = 8
// instance as stencil2d_v1, and csrc/stencil_breakdown.cu its instances
// as the breakdown's [v1] rows. Production runs stencil2d.cu's implicit
// GEMM; the comments below speak of the time this kernel was production.
//
//   y[b1, b2, co] = sum_{q1, q2 < F} sum_ci x[b1 + q1 - Q, b2 + q2 - Q, ci]
//                                            * W[q1, q2, ci, co]
//
// with x zero-extended and Q = (F - 1) / 2; x (B1, B2, Cin), W (F, F, Cin,
// Cout) and y (B1, B2, Cout), row-major.
//
// Design (simple and correct first): one thread block computes a tile of
// TH x TW output blocks by TN output channels. For each chunk of CK input
// channels it stages the zero-extended (TH + 2Q) x (TW + 2Q) halo of x and
// the F x F x CK x TN slice of W in shared memory; each thread keeps an
// RM-position x RN-channel tile of sums in registers. Faster variants
// (3xTF32 wgmma, TMA pipelines) are later work.
//
// MODE selects what an instance computes:
//   FULL  the contraction above;
//   FILL  the halo staging alone, for every chunk, writing the q2 = 0
//         window of the centre rows: y[:, j] = x[:, j - 1], y[:, 0] = 0
//         (needs Cin = Cout). No W, no products;
//   MM    no halo: each chunk stages the raw TH x TW tile (only the ragged
//         edge masked) and the slice of W as FULL does, and all F^2 taps
//         run against that same tile: y = sum_q x @ W[q]. Each tap reads
//         the tile through a volatile pointer, so that it issues its own
//         shared loads; without it the compiler loads each value once and
//         holds all of a chunk's across the taps. In the FMA sweep that
//         is FULL's count (FULL's taps read different addresses); in the
//         TF32 sweep it is more, as FULL's taps share fragment rows.
// TF32 sends the products of FULL and MM through the tensor cores
// (mma.sync m16n8k8, float32 sums), the inputs rounded to TF32 with
// cvt.rna when they are staged; float only.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 8;         // output tile columns
constexpr int TN = 64;        // output channels per thread block
constexpr int CK = 8;         // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int RN = 4;         // channels per thread (FMA sweep)
constexpr int NGROUPS = TN / RN;   // 16 channel groups
constexpr int WARPS_M = 2;    // TF32 sweep: 8 warps as 2 (positions) x 4
constexpr int WARPS_N = 4;    //   (channels), each m16 x n8 tiles
static_assert(TW == 8, "an m16 tile of positions is two rows of TW = 8");
static_assert(THREADS == 32 * WARPS_M * WARPS_N, "8 warps");
static_assert(TN % CK == 0, "a chunk lies in one channel tile");

enum Mode { FULL = 0, FILL = 1, MM = 2 };

template <typename T, int F, int TH, int MODE>
struct Tile {
    static constexpr int Q = (F - 1) / 2;
    static constexpr int RM = TH * TW / (THREADS / NGROUPS);  // positions
    static_assert(TH * TW == RM * (THREADS / NGROUPS), "tile does not cover");
    static constexpr int O = MODE == MM ? 0 : Q;      // staged halo width
    static constexpr int XH = TH + 2 * O;             // staged rows
    static constexpr int XW = TW + 2 * O;             // and columns
    static constexpr int X_ELEMS = CK * XH * XW;      // [CK][XH][XW]
    static constexpr int W_ELEMS = MODE == FILL ? 0 : F * F * CK * TN;
    static constexpr int MT = TH * TW / 16 / WARPS_M;  // m16 tiles per warp
    static constexpr int NT = TN / 8 / WARPS_N;        // n8 tiles per warp
    static constexpr size_t smem = sizeof(T) * (X_ELEMS + W_ELEMS);
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
    uint32_t u;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
    return u;
}

template <bool TF32, typename T>
__device__ __forceinline__ T stage_value(T v) {
    if constexpr (TF32) return __uint_as_float(tf32_bits(v));
    return v;
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 inputs, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int F, int TH, int MODE, bool TF32>
__global__ void __launch_bounds__(THREADS)
stencil2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int B1, int B2, int Cin, int Cout) {
    static_assert(!TF32 || std::is_same_v<T, float>, "TF32 takes float");
    using S = Tile<T, F, TH, MODE>;
    constexpr int Q = S::Q, O = S::O, XH = S::XH, XW = S::XW, RM = S::RM;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);   // [CK][XH][XW]
    T* ws = xs + S::X_ELEMS;                  // [F*F][CK][TN]

    const int tiles_w = (B2 + TW - 1) / TW;
    const int b1_0 = (blockIdx.x / tiles_w) * TH;
    const int b2_0 = (blockIdx.x % tiles_w) * TW;
    const int n0 = blockIdx.y * TN;
    const int tid = threadIdx.x;

    // FMA sweep: my channels n0 + tn + NGROUPS * j, my positions
    // tm + 16 * i of the tile
    const int tn = tid % NGROUPS;
    const int tm = tid / NGROUPS;
    int ph[RM], pw[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int p = tm + (THREADS / NGROUPS) * i;
        ph[i] = p / TW;
        pw[i] = p % TW;
    }
    T acc[RM][RN];
    // TF32 sweep: lane (g, t) of warp (wm, wn); m16 tile mt covers the
    // tile rows 2 mt and 2 mt + 1, n8 tile nt the channels 8 nt .. 8 nt + 7
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    float d[S::MT][S::NT][4];
    // the sweeps' reads of the staged x; MM reads through a volatile
    // pointer, so that each tap issues its own loads
    const volatile T* xv = xs;
    auto xload = [&](int e) -> T {
        if constexpr (MODE == MM) return xv[e];
        else return xs[e];
    };
    if constexpr (TF32) {
#pragma unroll
        for (int i = 0; i < S::MT; ++i)
#pragma unroll
            for (int j = 0; j < S::NT; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) d[i][j][r] = 0.f;
    } else {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = T(0);
    }

    for (int c0 = 0; c0 < Cin; c0 += CK) {
        // x, channel fastest so neighbouring threads read neighbouring
        // addresses: the zero-extended halo, or (MM) the raw tile with
        // only its ragged edge masked; zero past Cin
        for (int e = tid; e < S::X_ELEMS; e += THREADS) {
            const int c = e % CK;
            const int r = e / CK;
            const int hh = r / XW, hw = r % XW;
            const int g1 = b1_0 + hh - O, g2 = b2_0 + hw - O, gc = c0 + c;
            T v = T(0);
            if constexpr (MODE == MM) {
                if (g1 < B1 && g2 < B2 && gc < Cin)
                    v = x[(size_t(g1) * B2 + g2) * Cin + gc];
            } else {
                if (g1 >= 0 && g1 < B1 && g2 >= 0 && g2 < B2 && gc < Cin)
                    v = x[(size_t(g1) * B2 + g2) * Cin + gc];
            }
            xs[(c * XH + hh) * XW + hw] = stage_value<TF32>(v);
        }
        // W[:, :, c0:c0+CK, n0:n0+TN], output channel fastest
        if constexpr (MODE != FILL) {
            for (int e = tid; e < S::W_ELEMS; e += THREADS) {
                const int n = e % TN;
                const int r = e / TN;
                const int c = r % CK, q = r / CK;
                const int gc = c0 + c, gn = n0 + n;
                T v = T(0);
                if (gc < Cin && gn < Cout)
                    v = w[(size_t(q) * Cin + gc) * Cout + gn];
                ws[e] = stage_value<TF32>(v);
            }
        }
        __syncthreads();

        if constexpr (MODE == FILL) {
            // the centre rows of the q2 = 0 window of this block's chunks
            if (c0 >= n0 && c0 < n0 + TN) {
                for (int e = tid; e < CK * TH * TW; e += THREADS) {
                    const int c = e % CK;
                    const int r = e / CK;
                    const int th = r / TW, tw = r % TW;
                    const int g1 = b1_0 + th, g2 = b2_0 + tw, gc = c0 + c;
                    if (g1 < B1 && g2 < B2 && gc < Cout)
                        y[(size_t(g1) * B2 + g2) * Cout + gc] =
                            xs[(c * XH + th + Q) * XW + tw];
                }
            }
        } else if constexpr (TF32) {
#pragma unroll
            for (int q1 = 0; q1 < F; ++q1) {
#pragma unroll
                for (int q2 = 0; q2 < F; ++q2) {
                    const int sh = MODE == MM ? 0 : q1;
                    const int sw = MODE == MM ? 0 : q2;
                    const float* wq = ws + (q1 * F + q2) * CK * TN;
                    uint32_t a[S::MT][4], b[S::NT][2];
#pragma unroll
                    for (int i = 0; i < S::MT; ++i) {
                        const int row = 2 * (wm * S::MT + i) + sh;
                        // rows g and g + 8 of the m16 tile are the tile
                        // rows 2 mt and 2 mt + 1 at column g; k = t, t + 4
                        a[i][0] = __float_as_uint(
                            xload((t * XH + row) * XW + g + sw));
                        a[i][1] = __float_as_uint(
                            xload((t * XH + row + 1) * XW + g + sw));
                        a[i][2] = __float_as_uint(
                            xload(((t + 4) * XH + row) * XW + g + sw));
                        a[i][3] = __float_as_uint(
                            xload(((t + 4) * XH + row + 1) * XW + g + sw));
                    }
#pragma unroll
                    for (int j = 0; j < S::NT; ++j) {
                        const int n = 8 * (wn * S::NT + j) + g;
                        b[j][0] = __float_as_uint(wq[t * TN + n]);
                        b[j][1] = __float_as_uint(wq[(t + 4) * TN + n]);
                    }
#pragma unroll
                    for (int i = 0; i < S::MT; ++i)
#pragma unroll
                        for (int j = 0; j < S::NT; ++j)
                            mma_tf32(d[i][j], a[i], b[j]);
                }
            }
        } else {
#pragma unroll
            for (int q1 = 0; q1 < F; ++q1) {
#pragma unroll
                for (int q2 = 0; q2 < F; ++q2) {
                    const T* wq = ws + (q1 * F + q2) * CK * TN;
                    const int sh = MODE == MM ? 0 : q1;
                    const int sw = MODE == MM ? 0 : q2;
#pragma unroll
                    for (int c = 0; c < CK; ++c) {
                        T a[RM], b[RN];
#pragma unroll
                        for (int i = 0; i < RM; ++i)
                            a[i] = xload((c * XH + ph[i] + sh) * XW
                                         + pw[i] + sw);
#pragma unroll
                        for (int j = 0; j < RN; ++j)
                            b[j] = wq[c * TN + tn + NGROUPS * j];
#pragma unroll
                        for (int i = 0; i < RM; ++i)
#pragma unroll
                            for (int j = 0; j < RN; ++j)
                                acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
                    }
                }
            }
        }
        __syncthreads();
    }

    if constexpr (MODE != FILL && TF32) {
#pragma unroll
        for (int i = 0; i < S::MT; ++i) {
#pragma unroll
            for (int j = 0; j < S::NT; ++j) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    // d[r]: row g (r < 2) or g + 8, column 2 t + r % 2
                    const int p = 16 * (wm * S::MT + i) + g + 8 * (r / 2);
                    const int g1 = b1_0 + p / TW, g2 = b2_0 + p % TW;
                    const int gn = n0 + 8 * (wn * S::NT + j) + 2 * t + r % 2;
                    if (g1 < B1 && g2 < B2 && gn < Cout)
                        y[(size_t(g1) * B2 + g2) * Cout + gn] = d[i][j][r];
                }
            }
        }
    } else if constexpr (MODE != FILL) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int g1 = b1_0 + ph[i], g2 = b2_0 + pw[i];
            if (g1 >= B1 || g2 >= B2) continue;
            T* yp = y + (size_t(g1) * B2 + g2) * Cout;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const int gn = n0 + tn + NGROUPS * j;
                if (gn < Cout) yp[gn] = acc[i][j];
            }
        }
    }
}

// Launch one instance on ``stream``; returns cudaGetLastError() (0 on
// success). Nothing here synchronises or allocates.
template <typename T, int F, int TH, int MODE, bool TF32>
int launch(const T* x, const T* w, T* y, int B1, int B2, int Cin, int Cout,
           cudaStream_t stream) {
    constexpr size_t smem = Tile<T, F, TH, MODE>::smem;
    auto kernel = stencil2d_kernel<T, F, TH, MODE, TF32>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (err != cudaSuccess) return int(err);
    }
    const int tiles = ((B1 + TH - 1) / TH) * ((B2 + TW - 1) / TW);
    const dim3 grid(tiles, (Cout + TN - 1) / TN);
    kernel<<<grid, THREADS, smem, stream>>>(x, w, y, B1, B2, Cin, Cout);
    return int(cudaGetLastError());
}

}  // namespace
