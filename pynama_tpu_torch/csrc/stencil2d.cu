// Blocked 2D stencil contraction for Hopper (sm_90a), float and double.
//
//   y[b1, b2, co] = sum_{q1, q2 < F} sum_ci x[b1 + q1 - Q, b2 + q2 - Q, ci]
//                                            * W[q1, q2, ci, co]
//
// with x zero-extended outside [0, B1) x [0, B2) and Q = (F - 1) / 2.
// Layouts are row-major: x (B1, B2, Cin), W (F, F, Cin, Cout),
// y (B1, B2, Cout). Every operator apply of the spectral-element solver
// (K, Rw, Curl, SrT, DivSrT and the vertex-star patch smoother) is this
// contraction on the parity- or super-blocked node grid.
//
// Replaces the TPU kernel pynama_tpu/ops/pallas_stencil.py _kernel_xc
// (called from conv_blocked_pallas), and so also its "flat" variant
// _kernel, which computes the same function.
//
// Bound on an H100 SXM (700 W): at the fine-level K apply (97 x 97
// blocks, 128 -> 128 channels, F = 3) one call is 2.78 GFLOP and moves
// 10.2 MB, so it is bound by arithmetic: about 41 us at the 67 TFLOP/s
// float32 CUDA-core peak against about 3 us for the bytes at 3.35 TB/s.
// The products stay in IEEE float32 FMA (no TF32): lower precision breaks
// the Chebyshev-smoothed multigrid V-cycle.
//
// Design (simple and correct first): one thread block computes a tile of
// TH x TW output blocks by TN output channels. For each chunk of CK input
// channels it stages the zero-extended (TH + 2Q) x (TW + 2Q) halo of x and
// the F x F x CK x TN slice of W in shared memory; each thread keeps a
// 4-position x 4-channel tile of sums in registers. Faster variants
// (3xTF32 wgmma, TMA pipelines) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;        // output tile rows (leading block axis)
constexpr int TW = 8;        // output tile columns
constexpr int TN = 64;       // output channels per thread block
constexpr int CK = 8;        // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int RM = 4;        // positions per thread
constexpr int RN = 4;        // channels per thread
constexpr int NGROUPS = TN / RN;   // 16 channel groups
static_assert(TH * TW == RM * (THREADS / NGROUPS), "tile does not cover");

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

template <typename T, int F>
constexpr size_t smem_bytes() {
    return sizeof(T) * (size_t(CK) * (TH + F - 1) * (TW + F - 1)
                        + size_t(F) * F * CK * TN);
}

template <typename T, int F>
__global__ void __launch_bounds__(THREADS)
stencil2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int B1, int B2, int Cin, int Cout) {
    constexpr int Q = (F - 1) / 2;
    constexpr int HH = TH + 2 * Q;
    constexpr int HW = TW + 2 * Q;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);   // [CK][HH][HW]
    T* ws = xs + CK * HH * HW;                // [F*F][CK][TN]

    const int tiles_w = (B2 + TW - 1) / TW;
    const int b1_0 = (blockIdx.x / tiles_w) * TH;
    const int b2_0 = (blockIdx.x % tiles_w) * TW;
    const int n0 = blockIdx.y * TN;

    const int tid = threadIdx.x;
    const int tn = tid % NGROUPS;   // my channels: n0 + tn + NGROUPS * j
    const int tm = tid / NGROUPS;   // my positions: tm + 16 * i in the tile

    int ph[RM], pw[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int p = tm + (THREADS / NGROUPS) * i;
        ph[i] = p / TW;
        pw[i] = p % TW;
    }
    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = T(0);

    for (int c0 = 0; c0 < Cin; c0 += CK) {
        // halo of x, channel fastest so neighbouring threads read
        // neighbouring addresses; zero outside the grid and past Cin
        for (int e = tid; e < CK * HH * HW; e += THREADS) {
            const int c = e % CK;
            const int r = e / CK;
            const int hh = r / HW, hw = r % HW;
            const int g1 = b1_0 + hh - Q, g2 = b2_0 + hw - Q, gc = c0 + c;
            T v = T(0);
            if (g1 >= 0 && g1 < B1 && g2 >= 0 && g2 < B2 && gc < Cin)
                v = x[(size_t(g1) * B2 + g2) * Cin + gc];
            xs[(c * HH + hh) * HW + hw] = v;
        }
        // W[:, :, c0:c0+CK, n0:n0+TN], output channel fastest
        for (int e = tid; e < F * F * CK * TN; e += THREADS) {
            const int n = e % TN;
            const int r = e / TN;
            const int c = r % CK, q = r / CK;
            const int gc = c0 + c, gn = n0 + n;
            T v = T(0);
            if (gc < Cin && gn < Cout)
                v = w[(size_t(q) * Cin + gc) * Cout + gn];
            ws[e] = v;
        }
        __syncthreads();
#pragma unroll
        for (int q1 = 0; q1 < F; ++q1) {
#pragma unroll
            for (int q2 = 0; q2 < F; ++q2) {
                const T* wq = ws + (q1 * F + q2) * CK * TN;
#pragma unroll
                for (int c = 0; c < CK; ++c) {
                    T a[RM], b[RN];
#pragma unroll
                    for (int i = 0; i < RM; ++i)
                        a[i] = xs[(c * HH + ph[i] + q1) * HW + pw[i] + q2];
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
        __syncthreads();
    }

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

template <typename T, int F>
int launch(const T* x, const T* w, T* y, int B1, int B2, int Cin, int Cout,
           cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T, F>();
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            stencil2d_kernel<T, F>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (err != cudaSuccess) return int(err);
    }
    const int tiles = ((B1 + TH - 1) / TH) * ((B2 + TW - 1) / TW);
    const dim3 grid(tiles, (Cout + TN - 1) / TN);
    stencil2d_kernel<T, F><<<grid, THREADS, smem, stream>>>(
        x, w, y, B1, B2, Cin, Cout);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const T* x, const T* w, T* y, int B1, int B2, int Cin,
             int Cout, int F, void* stream) {
    if (B1 <= 0 || B2 <= 0 || Cin <= 0 || Cout <= 0)
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (F) {
        case 3: return launch<T, 3>(x, w, y, B1, B2, Cin, Cout, s);
        case 5: return launch<T, 5>(x, w, y, B1, B2, Cin, Cout, s);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// Plain C interface for ctypes: returns cudaGetLastError() after the
// launch (0 on success); nothing here synchronises or allocates.
extern "C" int stencil2d_f32(const float* x, const float* w, float* y,
                             int B1, int B2, int Cin, int Cout, int F,
                             void* stream) {
    return dispatch<float>(x, w, y, B1, B2, Cin, Cout, F, stream);
}

extern "C" int stencil2d_f64(const double* x, const double* w, double* y,
                             int B1, int B2, int Cin, int Cout, int F,
                             void* stream) {
    return dispatch<double>(x, w, y, B1, B2, Cin, Cout, F, stream);
}
