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
// The products stay in IEEE float32 FMA (no TF32): lower precision breaks
// the Chebyshev-smoothed multigrid V-cycle.
//
// Design (simple and correct first): one thread block computes a tile of
// T1 x T2 x T3 output blocks by TN output channels. For each chunk of CK
// input channels it stages the zero-extended (T + 2Q)^3 halo of x in
// shared memory (a predicated load: no padded copy of x is written), then
// for each q1 the F x F x CK x TN slab of W (a whole F^3 slice would not
// fit at F = 5 in double); each thread keeps a 4-position x 4-channel tile
// of sums in registers. The coarse multigrid levels give few thread
// blocks; a split over Cin, wgmma and TMA pipelines are later work.

#include <cuda_runtime.h>

namespace {

constexpr int T1 = 4;        // output tile, leading block axis
constexpr int T2 = 4;
constexpr int T3 = 4;        // output tile, innermost block axis
constexpr int TN = 64;       // output channels per thread block
constexpr int CK = 8;        // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int RN = 4;        // channels per thread
constexpr int NGROUPS = TN / RN;            // 16 channel groups
constexpr int PGROUPS = THREADS / NGROUPS;  // 16 position groups
constexpr int TP = T1 * T2 * T3;            // 64 positions per tile
constexpr int RM = TP / PGROUPS;            // 4 positions per thread
static_assert(RM * PGROUPS == TP, "tile does not cover");

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

template <typename T, int F>
constexpr size_t smem_bytes() {
    return sizeof(T) * (size_t(CK) * (T1 + F - 1) * (T2 + F - 1) * (T3 + F - 1)
                        + size_t(F) * F * CK * TN);
}

template <typename T, int F>
__global__ void __launch_bounds__(THREADS)
stencil3d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int B1, int B2, int B3, int Cin,
                 int Cout) {
    constexpr int Q = (F - 1) / 2;
    constexpr int H1 = T1 + 2 * Q;
    constexpr int H2 = T2 + 2 * Q;
    constexpr int H3 = T3 + 2 * Q;
    constexpr int HV = H1 * H2 * H3;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);   // [CK][H1][H2][H3]
    T* ws = xs + CK * HV;                     // [F*F][CK][TN], one q1 slab

    const int nt2 = (B2 + T2 - 1) / T2;
    const int nt3 = (B3 + T3 - 1) / T3;
    int tile = blockIdx.x;
    const int b3_0 = (tile % nt3) * T3;
    tile /= nt3;
    const int b2_0 = (tile % nt2) * T2;
    const int b1_0 = (tile / nt2) * T1;
    const int n0 = blockIdx.y * TN;

    const int tid = threadIdx.x;
    const int tn = tid % NGROUPS;   // my channels: n0 + tn + NGROUPS * j
    const int tm = tid / NGROUPS;   // my positions: tm + PGROUPS * i

    int off[RM];  // halo offset of my position i at tap (0, 0, 0)
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int p = tm + PGROUPS * i;
        const int p1 = p / (T2 * T3), p2 = (p / T3) % T2, p3 = p % T3;
        off[i] = (p1 * H2 + p2) * H3 + p3;
    }
    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = T(0);

    for (int c0 = 0; c0 < Cin; c0 += CK) {
        __syncthreads();  // the last chunk's reads of xs and ws are done
        // halo of x, channel fastest so neighbouring threads read
        // neighbouring addresses; zero outside the grid and past Cin
        for (int e = tid; e < CK * HV; e += THREADS) {
            const int c = e % CK;
            const int r = e / CK;
            const int h3 = r % H3, h2 = (r / H3) % H2, h1 = r / (H3 * H2);
            const int g1 = b1_0 + h1 - Q, g2 = b2_0 + h2 - Q,
                      g3 = b3_0 + h3 - Q, gc = c0 + c;
            T v = T(0);
            if (g1 >= 0 && g1 < B1 && g2 >= 0 && g2 < B2 && g3 >= 0 &&
                g3 < B3 && gc < Cin)
                v = x[((size_t(g1) * B2 + g2) * B3 + g3) * Cin + gc];
            xs[c * HV + r] = v;
        }
        for (int q1 = 0; q1 < F; ++q1) {
            if (q1 > 0) __syncthreads();  // reads of the last slab are done
            // W[q1, :, :, c0:c0+CK, n0:n0+TN], output channel fastest
            for (int e = tid; e < F * F * CK * TN; e += THREADS) {
                const int n = e % TN;
                const int r = e / TN;
                const int c = r % CK, q23 = r / CK;
                const int gc = c0 + c, gn = n0 + n;
                T v = T(0);
                if (gc < Cin && gn < Cout)
                    v = w[(size_t(q1 * F * F + q23) * Cin + gc) * Cout + gn];
                ws[e] = v;
            }
            __syncthreads();
#pragma unroll
            for (int q2 = 0; q2 < F; ++q2) {
#pragma unroll
                for (int q3 = 0; q3 < F; ++q3) {
                    const int toff = (q1 * H2 + q2) * H3 + q3;
                    const T* wt = ws + (q2 * F + q3) * CK * TN;
#pragma unroll
                    for (int c = 0; c < CK; ++c) {
                        T a[RM], b[RN];
#pragma unroll
                        for (int i = 0; i < RM; ++i)
                            a[i] = xs[c * HV + off[i] + toff];
#pragma unroll
                        for (int j = 0; j < RN; ++j)
                            b[j] = wt[c * TN + tn + NGROUPS * j];
#pragma unroll
                        for (int i = 0; i < RM; ++i)
#pragma unroll
                            for (int j = 0; j < RN; ++j)
                                acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int p = tm + PGROUPS * i;
        const int g1 = b1_0 + p / (T2 * T3);
        const int g2 = b2_0 + (p / T3) % T2;
        const int g3 = b3_0 + p % T3;
        if (g1 >= B1 || g2 >= B2 || g3 >= B3) continue;
        T* yp = y + ((size_t(g1) * B2 + g2) * B3 + g3) * Cout;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int gn = n0 + tn + NGROUPS * j;
            if (gn < Cout) yp[gn] = acc[i][j];
        }
    }
}

template <typename T, int F>
int launch(const T* x, const T* w, T* y, int B1, int B2, int B3, int Cin,
           int Cout, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T, F>();
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            stencil3d_kernel<T, F>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (err != cudaSuccess) return int(err);
    }
    const int tiles = ((B1 + T1 - 1) / T1) * ((B2 + T2 - 1) / T2)
                      * ((B3 + T3 - 1) / T3);
    const dim3 grid(tiles, (Cout + TN - 1) / TN);
    stencil3d_kernel<T, F><<<grid, THREADS, smem, stream>>>(
        x, w, y, B1, B2, B3, Cin, Cout);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const T* x, const T* w, T* y, int B1, int B2, int B3, int Cin,
             int Cout, int F, void* stream) {
    if (B1 <= 0 || B2 <= 0 || B3 <= 0 || Cin <= 0 || Cout <= 0)
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (F) {
        case 3: return launch<T, 3>(x, w, y, B1, B2, B3, Cin, Cout, s);
        case 5: return launch<T, 5>(x, w, y, B1, B2, B3, Cin, Cout, s);
        default: return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// Plain C interface for ctypes: returns cudaGetLastError() after the
// launch (0 on success); nothing here synchronises or allocates.
extern "C" int stencil3d_f32(const float* x, const float* w, float* y,
                             int B1, int B2, int B3, int Cin, int Cout,
                             int F, void* stream) {
    return dispatch<float>(x, w, y, B1, B2, B3, Cin, Cout, F, stream);
}

extern "C" int stencil3d_f64(const double* x, const double* w, double* y,
                             int B1, int B2, int B3, int Cin, int Cout,
                             int F, void* stream) {
    return dispatch<double>(x, w, y, B1, B2, B3, Cin, Cout, F, stream);
}
