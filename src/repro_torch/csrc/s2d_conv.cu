// Fused D2S -> 1x1 conv -> S2D layer variant (Terastal, paper Fig. 1) for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/s2d_conv/kernel.py::_s2d_conv_kernel.
//
// What it computes.  For x [B, H, W, C] and variant weights w [C/g^2, K/g^2]
// the D2S and S2D rearrangements cancel: d2s only regroups each pixel's C
// channels as g*g rows of C/g^2 in (gy, gx, c') order, and s2d folds the
// g*g output rows back the same way.  So the variant is one GEMM over the
// contiguous views
//
//     out.reshape(M, Kv) = x.reshape(M, Cv) @ w,   M = B*H*W*g^2,
//
// with f32 accumulation and the result cast to x's dtype.  Like the TPU
// kernel, this keeps the D2S/S2D intermediates out of device memory: the
// kernel reads x once and writes out once, in their own layouts.
//
// What bounds it.  At the main path's shapes (the 1x1 variant layers that
// the multicam_heavy plans select in resnet50@448 and swin_tiny, e.g.
// s3b1.conv3 at B=1: M = 3136, Cv = 64, Kv = 256) the contraction is short
// (Cv <= 512): some 25-45 operations per byte of x + w + out.  In bf16 that
// is far below the tensor cores' ridge, so the kernel is bound by bytes
// (x + out, about 4 MB in f32 for s3b1.conv3 at B=1); in f32 on the CUDA
// cores the byte and operation bounds lie within 2x of each other, and at
// B=1 both are a few microseconds, so launch overhead weighs as much.  The
// design is accordingly a simple tiled shared-memory GEMM: 64x64 output
// tiles, 16-deep slabs of x and w staged in shared memory (bf16 widened to
// f32 on load), a 4x4 register micro-tile per thread, masked ragged edges
// in M, Cv and Kv.  wgmma, TMA and a pipelined ring of tiles are later
// work.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libs2d_conv.so s2d_conv.cu
// C interface: s2d_conv_gemm(...) launches on the given stream and returns
// cudaGetLastError() as an int (0 == launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction slab
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0, "slab loads");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
s2d_conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, long long M, int Cv, int Kv) {
    __shared__ float xs[BK][BM + 1];  // x slab, transposed: xs[k][row]
    __shared__ float ws[BK][BN];      // w slab: ws[k][col]

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);   // 0..15: column group
    const int ty = tid / (BN / TN);   // 0..15: row group
    const long long row0 = (long long)blockIdx.x * BM;
    const int col0 = blockIdx.y * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < Cv; k0 += BK) {
        // x slab [BM, BK]: 16 neighbouring threads read one row's 16
        // contiguous channels; out-of-range rows/channels load 0
#pragma unroll
        for (int n = 0; n < BM * BK / THREADS; ++n) {
            const int e = tid + n * THREADS;
            const int r = e / BK, k = e % BK;
            const long long gr = row0 + r;
            const int gk = k0 + k;
            xs[k][r] = (gr < M && gk < Cv) ? widen(x[gr * Cv + gk]) : 0.0f;
        }
        // w slab [BK, BN]: neighbouring threads read neighbouring columns
#pragma unroll
        for (int n = 0; n < BK * BN / THREADS; ++n) {
            const int e = tid + n * THREADS;
            const int k = e / BN, c = e % BN;
            const int gk = k0 + k, gc = col0 + c;
            ws[k][c] = (gk < Cv && gc < Kv) ? widen(w[(long long)gk * Kv + gc]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * (BM / TM)];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + j * (BN / TN)];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
        }
        __syncthreads();
    }

    // neighbouring threads write neighbouring columns of one row
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long gr = row0 + ty + i * (BM / TM);
        if (gr >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gc = col0 + tx + j * (BN / TN);
            if (gc < Kv) out[gr * Kv + gc] = narrow<T>(acc[i][j]);
        }
    }
}

template <typename T>
void launch(const void* x, const void* w, void* out, long long M, int Cv, int Kv,
            cudaStream_t stream) {
    dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Kv + BN - 1) / BN));
    s2d_conv_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
        M, Cv, Kv);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
extern "C" int s2d_conv_gemm(const void* x, const void* w, void* out, long long M,
                             int Cv, int Kv, int dtype, void* stream) {
    if (M <= 0 || Cv <= 0 || Kv <= 0) return (int)cudaErrorInvalidValue;
    if ((M + BM - 1) / BM > 0x7fffffffLL || (Kv + BN - 1) / BN > 65535)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        launch<float>(x, w, out, M, Cv, Kv, s);
    } else if (dtype == 1) {
        launch<__nv_bfloat16>(x, w, out, M, Cv, Kv, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
