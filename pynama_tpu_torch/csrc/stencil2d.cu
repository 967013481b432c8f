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
// The kernel is the FULL, IEEE-FMA, TH = 8 instance of the tiled kernel
// in csrc/stencil2d_tile.cuh, whose other instances csrc/stencil_breakdown.cu
// times to split this one's cost.

#include "stencil2d_tile.cuh"

namespace {

constexpr int TH = 8;        // output tile rows (leading block axis)

template <typename T>
int dispatch(const T* x, const T* w, T* y, int B1, int B2, int Cin,
             int Cout, int F, void* stream) {
    if (B1 <= 0 || B2 <= 0 || Cin <= 0 || Cout <= 0)
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (F) {
        case 3: return launch<T, 3, TH, FULL, false>(x, w, y, B1, B2, Cin,
                                                     Cout, s);
        case 5: return launch<T, 5, TH, FULL, false>(x, w, y, B1, B2, Cin,
                                                     Cout, s);
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
