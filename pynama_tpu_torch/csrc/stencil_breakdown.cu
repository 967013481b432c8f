// Cost breakdown of the 2D stencil contraction (csrc/stencil2d.cu) on
// Hopper (sm_90a): float32, F = 3, C -> C channels.
//
// Replaces the TPU microbenchmark kernel of scripts/stencil_breakdown_tpu.py
// (make_pallas -> kern, :55-105), which split the cost of the Pallas kernel
// _kernel_xc. This one splits the cost of the kernel the port runs
// instead: it launches instances of stencil2d's own tiled kernel
// (csrc/stencil2d_tile.cuh) with parts switched off at compile time. Each
// mode computes what the TPU kernel's mode of the same name computes:
//
//   full  y[b] = sum_{q1, q2} x[b + q - 1] @ W[q1, q2], zero-extended: the
//         halo of x and the slice of W staged for every chunk, then the
//         F^2 sweep. At TH = 8 and highest precision this is the very
//         instance stencil2d launches.
//   fill  the halo staging alone; writes y[:, j] = x[:, j - 1], y[:, 0] = 0.
//   mm    no halo: the raw tile and the W slice staged, all F^2 taps run
//         against the same tile with their own loads, y = sum_q x @ W[q].
//         W is not pre-summed, so mm keeps full's FLOP count.
//
// Precisions of full and mm: highest, IEEE float32 FMA as stencil2d; and
// default, the products on the tensor cores in TF32 (mma.sync m16n8k8,
// float32 sums). TF32 is Hopper's counterpart of the TPU's DEFAULT single
// pass. fill has no precision.
//
// Bounds on an H100 SXM (700 W) at the script's shape, 97 x 97 blocks of
// 128 channels (x and y 4.8 MB each, W 0.6 MB):
//   full / mm, highest  2.78 GFLOP, 10.2 MB: 0.0414 ms at 67 TFLOP/s
//                       (float32 without tensor cores);
//   full / mm, default  2.78 GFLOP: 0.0056 ms at 495 TFLOP/s dense TF32;
//                       the 10.2 MB alone take 0.0030 ms at 3.35 TB/s;
//   fill                no FLOP, 9.6 MB (x in, y out): 0.0029 ms.
//
// Tile rows TH = 8 (stencil2d's tile) or 16, TW = 8; any B1, B2 and C.

#include "stencil2d_tile.cuh"

namespace {

template <int TH, int MODE, bool TF32>
int run(const float* x, const float* w, float* y, int B1, int B2, int C,
        cudaStream_t s) {
    return launch<float, 3, TH, MODE, TF32>(x, w, y, B1, B2, C, C, s);
}

template <int TH>
int by_mode(const float* x, const float* w, float* y, int B1, int B2, int C,
            int mode, int tf32, cudaStream_t s) {
    switch (mode) {
        case FULL:
            return tf32 ? run<TH, FULL, true>(x, w, y, B1, B2, C, s)
                        : run<TH, FULL, false>(x, w, y, B1, B2, C, s);
        case FILL:
            return run<TH, FILL, false>(x, w, y, B1, B2, C, s);
        case MM:
            return tf32 ? run<TH, MM, true>(x, w, y, B1, B2, C, s)
                        : run<TH, MM, false>(x, w, y, B1, B2, C, s);
        default:
            return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// Plain C interface for ctypes. x and y (B1, B2, C), W (3, 3, C, C), all
// float32, row-major; mode 0 full, 1 fill, 2 mm; prec 0 highest (FMA),
// 1 default (TF32); TR the tile rows, 8 or 16. Returns cudaGetLastError()
// after the launch (0 on success); nothing here synchronises or allocates.
extern "C" int stencil_breakdown_f32(const float* x, const float* w,
                                     float* y, int B1, int B2, int C, int TR,
                                     int mode, int prec, void* stream) {
    if (B1 <= 0 || B2 <= 0 || C <= 0 || (prec != 0 && prec != 1))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (TR) {
        case 8: return by_mode<8>(x, w, y, B1, B2, C, mode, prec, s);
        case 16: return by_mode<16>(x, w, y, B1, B2, C, mode, prec, s);
        default: return int(cudaErrorInvalidValue);
    }
}
