// Mamba2 SSD chunked scan for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssd_scan/kernel.py::_ssd_kernel (ssd_scan_pallas).
//
// What it computes.  x [Bt, L, H, P], log_a and dt [Bt, L, H] (f32), B and C
// [Bt, L, N] (shared by all heads), all contiguous in the JAX layout, give for
// every (b, h) and every chunk of Q positions, in order,
//
//     xdt = x * dt,   cum = cumsum(log_a),   total = cum[Q-1],
//     y   = ((C B^T) o decay) xdt + exp(cum) o (C S),
//           decay[i, j] = exp(cum_i - cum_j) for j <= i, 0 for j > i,
//     S  <- exp(total) S + (B o exp(total - cum))^T xdt,
//
// with the state S [N, P] starting at 0.  Everything is computed in f32 and y
// is cast to x's dtype (f32 or bf16; B and C share it) once.
//
// What bounds it.  Operations.  The function needs the causal half of C B^T
// once per (b, chunk), Q(Q+1)N operations, as B and C are shared by the heads,
// and per (b, h, chunk) the causal scores times xdt and the two products with
// the state, Q(Q+1)P + 4QNP (12.6 MFLOP at Q = 256, N = 128, P = 64), for some
// 33 KB of input: hundreds of operations per byte, far above the card's ridge.
// xdt and the decays are f32, so the bound is the CUDA cores' f32 rate.  This
// kernel computes C B^T per head, about 44% of its work.  The design keeps
// every operand of the products in shared
// memory, computes only the causal half of C B^T (j <= i), and gives each
// thread a 4 x 4 (or 4 x P/16) tile of each product so that every value read
// from shared memory feeds four multiply-adds.  Tensor cores (wgmma, TF32 or
// bf16 operands), TMA and sharing C B^T across the heads of a batch row are
// later work.
//
// Design.  The Pallas grid walks the chunks of one (b, h) in order and keeps S
// in VMEM scratch between grid steps.  Blocks on the card run in parallel and
// in no order, so one block of 256 threads per (h, b) loops over its chunks
// itself with S held in shared memory (32 KB of f32 at N = 128, P = 64; 512
// blocks at the main path's Bt = 8, H = 64, about four per SM).  The Pallas
// kernel keeps the whole Q x Q decay block on chip: at Q = 256 that is 256 KiB
// of f32, more than the 227 KB a block may use.  So each chunk is cut into row
// tiles of TI = 64 positions i; a row tile computes its masked scores against
// one tile of TJ = 64 positions j <= i at a time and multiplies them into xdt
// at once.  Per chunk, in shared memory: xdt [Q, P], cum [Q], one tile of C
// and of B [64, N+1] (padded rows: no bank conflicts), the score tile
// [64, 65] and S (183 KB at the main path's shapes).  Every row tile reads
// the old S before the state update writes the new one: the update runs after
// the last row tile, behind a barrier.
//
// Hazard.  The Pallas kernel takes exp(cum_i - cum_j) over the whole block and
// drops the upper triangle with a where; there exp can overflow to inf.  Here
// the exponential is evaluated only for j <= i (a select, never a multiply by
// a mask).
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
// C interface: ssd_scan(...) launches on the given stream and returns
// cudaGetLastError() as an int (0 == launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TI = 64;      // rows i of a row tile
constexpr int TJ = 64;      // rows j of a B tile
constexpr int RI = TI / 16; // rows per thread (threads form a 16 x 16 grid)
constexpr int CJ = TJ / 16; // score columns per thread
constexpr int SS = TJ + 1;  // row stride of the score tile
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

// rows r0 + warp, r0 + warp + NWARPS, ... of a [rows, N] tile of B or C into
// shared memory with row stride N + 1; rows at or past Q are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int Q, int N,
                                          int warp, int lane) {
    const int NS = N + 1;
    for (int r = warp; r < 64; r += NWARPS) {
        const int i = r0 + r;
        for (int n = lane; n < N; n += 32)
            dst[r * NS + n] = i < Q ? ld(src + (long long)i * N + n) : 0.f;
    }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ log_a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ dt, T* __restrict__ out,
                int L, int H, int N, int Q) {
    constexpr int CP = P >= 16 ? P / 16 : 1;  // columns p per thread
    extern __shared__ float smem[];
    const int NS = N + 1;
    float* S_s = smem;              // [N][P] the carried state
    float* xdt_s = S_s + N * P;     // [Q][P]
    float* C_s = xdt_s + Q * P;     // [TI][NS]
    float* B_s = C_s + TI * NS;     // [TJ][NS]
    float* sc_s = B_s + TJ * NS;    // [TI][SS] masked, decayed scores
    float* cum_s = sc_s + TI * SS;  // [Q]
    float* w_s = cum_s + Q;         // [Q] dt, then exp(total - cum)

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int tx = tid % 16, ty = tid / 16;
    int pc[CP];  // this thread's columns p, clamped for loads (P < 16)
#pragma unroll
    for (int c = 0; c < CP; ++c) pc[c] = min(tx + 16 * c, P - 1);

    for (int e = tid; e < N * P; e += THREADS) S_s[e] = 0.f;

    const int nc = L / Q;
    for (int chunk = 0; chunk < nc; ++chunk) {
        const long long row0 = (long long)b * L + (long long)chunk * Q;  // first position
        __syncthreads();  // the previous chunk is done with xdt_s, cum_s, w_s and S_s
        for (int j = tid; j < Q; j += THREADS) {
            cum_s[j] = log_a[(row0 + j) * H + h];
            w_s[j] = dt[(row0 + j) * H + h];
        }
        __syncthreads();
        for (int j = warp; j < Q; j += NWARPS)
            for (int p = lane; p < P; p += 32)
                xdt_s[j * P + p] = ld(x + ((row0 + j) * H + h) * P + p) * w_s[j];
        if (warp == 0) {  // inclusive cumsum of log_a: segments per lane, then a warp scan
            const int seg = (Q + 31) / 32;
            const int lo = min(lane * seg, Q), hi = min(lo + seg, Q);
            float run = 0.f;
            for (int j = lo; j < hi; ++j) {
                run += cum_s[j];
                cum_s[j] = run;
            }
            float incl = run;
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
                const float v = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += v;
            }
            float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // the lanes before this one
            if (lane == 0) excl = 0.f;
            for (int j = lo; j < hi; ++j) cum_s[j] += excl;
        }
        __syncthreads();
        const float total = cum_s[Q - 1];
        const T* Bc = Bm + row0 * N;
        const T* Cc = Cm + row0 * N;

        // ---- y, one row tile of TI positions i at a time
        for (int i0 = 0; i0 < Q; i0 += TI) {
            load_tile(C_s, Cc, i0, Q, N, warp, lane);
            __syncthreads();
            float acc[RI][CP];
#pragma unroll
            for (int r = 0; r < RI; ++r)
#pragma unroll
                for (int c = 0; c < CP; ++c) acc[r][c] = 0.f;
            // inter-chunk: exp(cum_i) * (C S)[i, p], from the state entering the chunk
            for (int n = 0; n < N; ++n) {
                float cr[RI], sv[CP];
#pragma unroll
                for (int r = 0; r < RI; ++r) cr[r] = C_s[(ty + 16 * r) * NS + n];
#pragma unroll
                for (int c = 0; c < CP; ++c) sv[c] = S_s[n * P + pc[c]];
#pragma unroll
                for (int r = 0; r < RI; ++r)
#pragma unroll
                    for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(cr[r], sv[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < RI; ++r) {
                const int i = i0 + ty + 16 * r;
                const float e = i < Q ? expf(cum_s[i]) : 0.f;
#pragma unroll
                for (int c = 0; c < CP; ++c) acc[r][c] *= e;
            }
            // intra-chunk: the tiles of j <= the row tile's last i (TJ == TI)
            for (int j0 = 0; j0 <= i0; j0 += TJ) {
                __syncthreads();  // the previous B and score tiles are no longer read
                load_tile(B_s, Bc, j0, Q, N, warp, lane);
                __syncthreads();
                float s[RI][CJ];
#pragma unroll
                for (int r = 0; r < RI; ++r)
#pragma unroll
                    for (int q = 0; q < CJ; ++q) s[r][q] = 0.f;
                for (int n = 0; n < N; ++n) {
                    float cr[RI], br[CJ];
#pragma unroll
                    for (int r = 0; r < RI; ++r) cr[r] = C_s[(ty + 16 * r) * NS + n];
#pragma unroll
                    for (int q = 0; q < CJ; ++q) br[q] = B_s[(tx + 16 * q) * NS + n];
#pragma unroll
                    for (int r = 0; r < RI; ++r)
#pragma unroll
                        for (int q = 0; q < CJ; ++q) s[r][q] = fmaf(cr[r], br[q], s[r][q]);
                }
#pragma unroll
                for (int r = 0; r < RI; ++r) {
                    const int i = i0 + ty + 16 * r;
#pragma unroll
                    for (int q = 0; q < CJ; ++q) {
                        const int j = j0 + tx + 16 * q;
                        // select before the exponential: exp runs only where j <= i
                        sc_s[(ty + 16 * r) * SS + tx + 16 * q] =
                            (i < Q && j <= i) ? s[r][q] * expf(cum_s[i] - cum_s[j]) : 0.f;
                    }
                }
                __syncthreads();
                const int jn = min(TJ, Q - j0);
                for (int jj = 0; jj < jn; ++jj) {
                    float a[RI], xv[CP];
#pragma unroll
                    for (int r = 0; r < RI; ++r) a[r] = sc_s[(ty + 16 * r) * SS + jj];
#pragma unroll
                    for (int c = 0; c < CP; ++c) xv[c] = xdt_s[(j0 + jj) * P + pc[c]];
#pragma unroll
                    for (int r = 0; r < RI; ++r)
#pragma unroll
                        for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(a[r], xv[c], acc[r][c]);
                }
            }
#pragma unroll
            for (int r = 0; r < RI; ++r) {
                const int i = i0 + ty + 16 * r;
                if (i >= Q) continue;
                T* o = out + ((row0 + i) * H + h) * P;
#pragma unroll
                for (int c = 0; c < CP; ++c)
                    if (tx + 16 * c < P) o[tx + 16 * c] = narrow<T>(acc[r][c]);
            }
            __syncthreads();  // C_s, B_s and sc_s are free for the next row tile
        }

        // ---- the state update, after every row tile has read the old S
        for (int j = tid; j < Q; j += THREADS) w_s[j] = expf(total - cum_s[j]);
        const float decay = expf(total);
        for (int e = tid; e < N * P; e += THREADS) S_s[e] *= decay;
        for (int j0 = 0; j0 < Q; j0 += TJ) {
            __syncthreads();  // w_s and the scaled S are written; B_s is no longer read
            load_tile(B_s, Bc, j0, Q, N, warp, lane);
            __syncthreads();
            const int jn = min(TJ, Q - j0);
            for (int n0 = 0; n0 < N; n0 += 16 * RI) {
                int nr[RI];  // this thread's rows n, clamped for loads
#pragma unroll
                for (int r = 0; r < RI; ++r) nr[r] = min(n0 + ty + 16 * r, N - 1);
                float acc[RI][CP];
#pragma unroll
                for (int r = 0; r < RI; ++r)
#pragma unroll
                    for (int c = 0; c < CP; ++c) acc[r][c] = S_s[nr[r] * P + pc[c]];
                for (int jj = 0; jj < jn; ++jj) {
                    const float wj = w_s[j0 + jj];
                    float bw[RI], xv[CP];
#pragma unroll
                    for (int r = 0; r < RI; ++r) bw[r] = B_s[jj * NS + nr[r]] * wj;
#pragma unroll
                    for (int c = 0; c < CP; ++c) xv[c] = xdt_s[(j0 + jj) * P + pc[c]];
#pragma unroll
                    for (int r = 0; r < RI; ++r)
#pragma unroll
                        for (int c = 0; c < CP; ++c) acc[r][c] = fmaf(bw[r], xv[c], acc[r][c]);
                }
                // each (n, p) has one owner; a clamped duplicate only reads
#pragma unroll
                for (int r = 0; r < RI; ++r)
#pragma unroll
                    for (int c = 0; c < CP; ++c)
                        if (n0 + ty + 16 * r < N && tx + 16 * c < P)
                            S_s[nr[r] * P + pc[c]] = acc[r][c];
            }
        }
    }
}

template <typename T, int P>
int launch(const void* x, const float* log_a, const void* Bm, const void* Cm,
           const float* dt, void* out, int Bt, int L, int H, int N, int Q, int smem,
           cudaStream_t stream) {
    auto kernel = ssd_scan_kernel<T, P>;
    // allow the most a block may use, once per instance (no call during graph capture)
    static bool smem_allowed = false;
    if (!smem_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        smem_allowed = true;
    }
    kernel<<<dim3(H, Bt), THREADS, smem, stream>>>(
        static_cast<const T*>(x), log_a, static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), dt, static_cast<T*>(out), L, H, N, Q);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* log_a, const void* Bm, const void* Cm,
             const float* dt, void* out, int Bt, int L, int H, int P, int N, int Q,
             int smem, cudaStream_t stream) {
    switch (P) {
        case 8: return launch<T, 8>(x, log_a, Bm, Cm, dt, out, Bt, L, H, N, Q, smem, stream);
        case 16: return launch<T, 16>(x, log_a, Bm, Cm, dt, out, Bt, L, H, N, Q, smem, stream);
        case 32: return launch<T, 32>(x, log_a, Bm, Cm, dt, out, Bt, L, H, N, Q, smem, stream);
        case 64: return launch<T, 64>(x, log_a, Bm, Cm, dt, out, Bt, L, H, N, Q, smem, stream);
        case 128: return launch<T, 128>(x, log_a, Bm, Cm, dt, out, Bt, L, H, N, Q, smem, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Shared memory of one block, in bytes (kernel.py's smem_bytes mirrors it and
// checks it against the 227 KB a block may use before launching).
int smem_bytes(int P, int N, int Q) {
    return (int)sizeof(float) * (N * P + Q * P + (TI + TJ) * (N + 1) + TI * SS + 2 * Q);
}

}  // namespace

// x [Bt, L, H, P], log_a [Bt, L, H] f32, B / C [Bt, L, N], dt [Bt, L, H] f32,
// out [Bt, L, H, P]; L a multiple of Q.  dtype (of x, B, C and out):
// 0 = float32, 1 = bfloat16.
extern "C" int ssd_scan(const void* x, const void* log_a, const void* Bm, const void* Cm,
                        const void* dt, void* out, int Bt, int L, int H, int P, int N,
                        int Q, int dtype, void* stream) {
    if (Bt <= 0 || L <= 0 || H <= 0 || N <= 0 || Q <= 0 || L % Q) return (int)cudaErrorInvalidValue;
    if (Bt > 65535) return (int)cudaErrorInvalidConfiguration;
    const int smem = smem_bytes(P, N, Q);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const float* la = static_cast<const float*>(log_a);
    const float* d = static_cast<const float*>(dt);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(x, la, Bm, Cm, d, out, Bt, L, H, P, N, Q, smem, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(x, la, Bm, Cm, d, out, Bt, L, H, P, N, Q, smem, s);
    return (int)cudaErrorInvalidValue;
}
