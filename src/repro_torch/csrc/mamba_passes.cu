// The Mamba block's elementwise passes for Hopper, on the no-grad route:
// models/mamba2.mamba_block_apply but its two projections and its scan.
//
// Replaces no TPU kernel.  On the TPU, XLA fused these passes into the
// projections and the scan around them; the port ran them op by op, each pass
// writing a full-size tensor (many of them in f32) that the next one read back.
// At mamba2-1.3b's prefill (B=64, L=4096) they took 89.6 ms a block call,
// 65% of the prefill's device time.
//
// What bounds them.  Bytes: a handful of operations per byte, far below the
// card's ridge.  Three kernels move, per token and block (bf16 at
// mamba2-1.3b's widths: d_model 2048, d_inner 4096, N 128, H 64, in_proj
// width 8512; the residual add, a plain bf16 add, moves 12 KB more):
//
//   1. mamba_rmsnorm_kernel: read 4 KB, write 4 KB;
//   2. mamba_conv_silu_kernel: read the xBC columns and dt (8.6 KB), write x,
//      B, C in bf16 and dt, log_a in f32 (9 KB);
//   3. mamba_gate_norm_kernel: read y, x, z, write the out_proj input (32 KB).
//
// About 70 KB a token with the residual add: 18.7 GB a block call at
// T = 64 x 4096, 5.6 ms at 3.35 TB/s.  Each kernel reads its inputs once and
// writes its outputs once, in 16-byte loads and stores, and keeps everything
// between them in registers.
//
//   1. The input norm: one warp a token row of d_model, the row held in
//      registers (CPL 16-byte chunks a lane), its sum of squares in f32
//      reduced by shuffles, x rsqrt(mean + eps) scale in f32, rounded to the
//      model's dtype once.
//   2. The causal depthwise conv of width W, + conv_b, silu; and dt.  Each
//      thread owns one 16-byte chunk of channels (8 in bf16) and walks a run of
//      RUN consecutive tokens of one batch row, the last W - 1 inputs kept in
//      registers, so each input is read once (the W - 1 before the run's first
//      token too; zero before the row's start).  It reads the xBC columns
//      straight from the strided in_proj output and writes x [B, L, d_inner],
//      B [B, L, N] and C [B, L, N] as contiguous tensors (the scan's inputs, so
//      its wrapper copies nothing).  Products and sums in f32 (the plain path
//      rounds each product and partial sum to the model's dtype).  The chunks
//      past the conv channels cover the H dt columns: dt = softplus(dt_raw +
//      dt_bias) and log_a = dt (-exp(A_log)), in f32.
//   3. The D skip, the silu(z) gate and the out norm: one block a token row of
//      d_inner (a warp multiple of threads, CPT 16-byte chunks each), the row
//      held in registers, its sum reduced by shuffles and across warps.  It
//      keeps the plain path's rounding points: y + D x, silu(z) and their
//      product each rounded to the model's dtype (the D skip's product and sum
//      as separate f32 operations, no fused multiply-add, as the plain path
//      computes them), then the row's f32 norm.  Where B and C come in G
//      groups (zamba2), the norm is taken over each group's d_inner / G
//      channels: one block a (token row, group), the same code over a row of
//      d_inner / G.
//
// Groups reach kernel 2 as its channel count: the B and C channels of all G
// groups are contiguous in the input projection, so N there is G times the
// state size, and B and C are written as [B, L, G N], the scan's [B, L, G, N].
//
// T is float or __nv_bfloat16: x, z, y, the conv weights and every output but
// dt and log_a are of it; norm scales, conv_b, D, dt_bias and A_log are f32.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libmamba_passes.so mamba_passes.cu
// C interface: mamba_rmsnorm, mamba_conv_silu and mamba_gate_norm each launch
// one kernel on the given stream and return cudaGetLastError() as an int
// (0 == launched).  The caller checks shapes, dtypes, contiguity and 16-byte
// alignment; each function refuses the widths its kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NORM_ROWS = 4;       // mamba_rmsnorm_kernel: rows (warps) a block
constexpr int CONV_THREADS = 256;  // mamba_conv_silu_kernel: threads a block
constexpr int RUN = 32;            // tokens a conv thread walks
constexpr int AHEAD = 8;           // tokens a conv thread loads ahead
constexpr int GATE_THREADS = 256;  // mamba_gate_norm_kernel: most threads a block (a row)

// 16 bytes of T: the unit of every load and store, unpacked to f32.
template <typename T> struct Pack;

template <> struct Pack<float> {
    static constexpr int N = 4;
    __device__ static void unpack(uint4 r, float (&v)[N]) {
        v[0] = __uint_as_float(r.x);
        v[1] = __uint_as_float(r.y);
        v[2] = __uint_as_float(r.z);
        v[3] = __uint_as_float(r.w);
    }
    __device__ static uint4 pack(const float (&v)[N]) {
        return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                          __float_as_uint(v[3]));
    }
    __device__ static float round(float v) { return v; }
};

template <> struct Pack<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void two(uint32_t w, float& lo, float& hi) {
        lo = __uint_as_float(w << 16);
        hi = __uint_as_float(w & 0xFFFF0000u);
    }
    __device__ static uint32_t two(float lo, float hi) {  // one cvt.rn.bf16x2.f32
        const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&t);
    }
    __device__ static void unpack(uint4 r, float (&v)[N]) {
        two(r.x, v[0], v[1]);
        two(r.y, v[2], v[3]);
        two(r.z, v[4], v[5]);
        two(r.w, v[6], v[7]);
    }
    __device__ static uint4 pack(const float (&v)[N]) {
        return make_uint4(two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]), two(v[6], v[7]));
    }
    __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

__device__ __forceinline__ uint4 ld16(const void* p) { return *static_cast<const uint4*>(p); }
__device__ __forceinline__ void st16(void* p, uint4 v) { *static_cast<uint4*>(p) = v; }

// n consecutive f32 values (n a multiple of 4, p 16-byte aligned)
template <int n>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[n]) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        v[i] = q.x;
        v[i + 1] = q.y;
        v[i + 2] = q.z;
        v[i + 3] = q.w;
    }
}

template <int n>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[n]) {
#pragma unroll
    for (int i = 0; i < n; i += 4)
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// silu as the plain path computes it (expf, an IEEE division)
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// silu with the hardware exponential and division (ex2.approx, rcp.approx: a
// few f32 ulps, far below a bf16 ulp), where the conv's instruction count, not
// its bytes, would bound it
__device__ __forceinline__ float fast_silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// ---------------------------------------------------------------- 1. norm --

template <typename T, int CPL>
__global__ void __launch_bounds__(32 * NORM_ROWS)
mamba_rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     T* __restrict__ out, int rows, int D, float eps) {
    using P = Pack<T>;
    constexpr int V = P::N;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * NORM_ROWS + (threadIdx.x >> 5);
    if (row >= rows) return;  // a whole warp: the shuffles below see all 32 lanes
    const int nch = D / V;
    const T* xr = x + row * D;
    uint4 raw[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        raw[c] = ch < nch ? ld16(xr + ch * V) : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        float v[V];
        P::unpack(raw[c], v);  // zero past the row
#pragma unroll
        for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
    }
    const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
    T* orow = out + row * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        if (ch < nch) {
            float v[V], s[V];
            P::unpack(raw[c], v);
            ld_f32(scale + ch * V, s);
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = v[j] * r * s[j];
            st16(orow + ch * V, P::pack(v));
        }
    }
}

// ------------------------------------------------------- 2. conv, silu, dt --

template <typename T, int W>
__global__ void __launch_bounds__(CONV_THREADS)
mamba_conv_silu_kernel(const T* __restrict__ zx, int ld, const T* __restrict__ conv_w,
                       const float* __restrict__ conv_b, const float* __restrict__ dt_bias,
                       const float* __restrict__ A_log, T* __restrict__ xo, T* __restrict__ bo,
                       T* __restrict__ co, float* __restrict__ dto, float* __restrict__ lao,
                       int Bt, int L, int Din, int N, int H) {
    using P = Pack<T>;
    constexpr int V = P::N;
    const int C = Din + 2 * N;  // conv channels: x, B, C
    const int nconv = C / V, nch = nconv + H / V;
    const int runs = (L + RUN - 1) / RUN;
    const long long task = (long long)blockIdx.x * CONV_THREADS + threadIdx.x;
    if (task >= (long long)Bt * runs * nch) return;
    const int chunk = (int)(task % nch);
    const long long run = task / nch;
    const int t0 = (int)(run % runs) * RUN, t1 = min(t0 + RUN, L);
    const long long row0 = (run / runs) * L;  // token row of (b, 0)

    if (chunk >= nconv) {  // dt of V heads
        const int h0 = (chunk - nconv) * V;
        const T* src = zx + Din + C + h0;
        float bias[V], A[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            bias[j] = dt_bias[h0 + j];
            A[j] = -expf(A_log[h0 + j]);
        }
        for (int t = t0; t < t1; ++t) {
            float v[V], la[V];
            P::unpack(ld16(src + (row0 + t) * ld), v);
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float d = v[j] + bias[j];
                v[j] = d > 20.0f ? d : log1pf(expf(d));  // F.softplus, threshold 20
                la[j] = v[j] * A[j];
            }
            st_f32(dto + (row0 + t) * H + h0, v);
            st_f32(lao + (row0 + t) * H + h0, la);
        }
        return;
    }

    const int c0 = chunk * V;
    const T* src = zx + Din + c0;
    T* dst;
    int dld;
    if (c0 < Din) {
        dst = xo + c0;
        dld = Din;
    } else if (c0 < Din + N) {
        dst = bo + (c0 - Din);
        dld = N;
    } else {
        dst = co + (c0 - Din - N);
        dld = N;
    }
    float w[W][V], bias[V];
#pragma unroll
    for (int k = 0; k < W; ++k) P::unpack(ld16(conv_w + (long long)k * C + c0), w[k]);
    ld_f32(conv_b + c0, bias);
    float hist[W - 1][V];  // hist[k]: the input k + 1 tokens back, zero before the row
#pragma unroll
    for (int k = 0; k < W - 1; ++k) {
        const int t = t0 - 1 - k;
        P::unpack(t >= 0 ? ld16(src + (row0 + t) * ld) : make_uint4(0u, 0u, 0u, 0u), hist[k]);
    }
    for (int t = t0; t < t1; t += AHEAD) {
        uint4 raw[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u)
            if (t + u < t1) raw[u] = ld16(src + (row0 + t + u) * ld);
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
            if (t + u < t1) {
                float v[V], o[V];
                P::unpack(raw[u], v);
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    // the plain path's order: the oldest input first, then + conv_b
                    float acc = 0.0f;
#pragma unroll
                    for (int i = 0; i < W - 1; ++i) acc = fmaf(hist[W - 2 - i][j], w[i][j], acc);
                    acc = fmaf(v[j], w[W - 1][j], acc) + bias[j];
                    o[j] = fast_silu(acc);
                }
#pragma unroll
                for (int k = W - 2; k > 0; --k)
#pragma unroll
                    for (int j = 0; j < V; ++j) hist[k][j] = hist[k - 1][j];
#pragma unroll
                for (int j = 0; j < V; ++j) hist[0][j] = v[j];
                st16(dst + (row0 + t + u) * dld, P::pack(o));
            }
        }
    }
}

// ------------------------------------------------ 3. D skip, gate, norm ----

// A block's row is one group of Dg = d_inner / G channels of one token: y, x
// and out are [rows, G, Dg], z strided by ldz.
template <typename T, int CPT>
__global__ void __launch_bounds__(GATE_THREADS)
mamba_gate_norm_kernel(const T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ z,
                       int ldz, const float* __restrict__ Dskip, const float* __restrict__ scale,
                       T* __restrict__ out, int Dg, int Pd, int G, float eps) {
    using P = Pack<T>;
    constexpr int V = P::N;
    __shared__ float part[32];
    const long long row = blockIdx.x;  // (token, group)
    const int grp = (int)blockIdx.x % G;
    const int nch = Dg / V;
    const T* yr = y + row * Dg;
    const T* xr = x + row * Dg;
    const T* zr = z + (long long)((int)blockIdx.x / G) * ldz + grp * Dg;
    Dskip += grp * (Dg / Pd);
    scale += grp * Dg;
    uint4 ry[CPT], rx[CPT], rz[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) {
            ry[k] = ld16(yr + ch * V);
            rx[k] = ld16(xr + ch * V);
            rz[k] = ld16(zr + ch * V);
        }
    }
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) {
            float yv[V], xv[V], zv[V];
            P::unpack(ry[k], yv);
            P::unpack(rx[k], xv);
            P::unpack(rz[k], zv);
            const float d = Dskip[ch * V / Pd];  // a chunk lies in one head (Pd % V == 0)
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float s = P::round(__fadd_rn(yv[j], __fmul_rn(d, xv[j])));
                yv[j] = P::round(s * P::round(silu(zv[j])));
                ss = fmaf(yv[j], yv[j], ss);
            }
            ry[k] = P::pack(yv);  // exact: yv is already of T
        }
    }
    ss = warp_sum(ss);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    // every warp sums the partials itself: no second barrier
    const float r = rsqrtf(warp_sum(lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f) /
                               (float)Dg + eps);
    T* orow = out + row * Dg;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) {
            float v[V], s[V];
            P::unpack(ry[k], v);
            ld_f32(scale + ch * V, s);
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = v[j] * r * s[j];
            st16(orow + ch * V, P::pack(v));
        }
    }
}

// ------------------------------------------------------------- launchers --

template <typename T>
int rmsnorm(const void* x, const void* scale, void* out, int rows, int D, float eps,
            cudaStream_t s) {
    constexpr int V = Pack<T>::N;
    if (rows <= 0 || D <= 0 || D % V) return (int)cudaErrorInvalidValue;
    const int cpl = (D / V + 31) / 32;
    const dim3 grid((rows + NORM_ROWS - 1) / NORM_ROWS), block(32 * NORM_ROWS);
    const T* xp = static_cast<const T*>(x);
    const float* sp = static_cast<const float*>(scale);
    T* op = static_cast<T*>(out);
    if (cpl <= 2)
        mamba_rmsnorm_kernel<T, 2><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps);
    else if (cpl <= 4)
        mamba_rmsnorm_kernel<T, 4><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps);
    else if (cpl <= 8)
        mamba_rmsnorm_kernel<T, 8><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps);
    else if (cpl <= 16)
        mamba_rmsnorm_kernel<T, 16><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps);
    else if (cpl <= 32)
        mamba_rmsnorm_kernel<T, 32><<<grid, block, 0, s>>>(xp, sp, op, rows, D, eps);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

template <typename T, int W>
void conv_launch(long long blocks, const T* zx, int ld, const T* cw, const float* cb,
                 const float* db, const float* al, T* xo, T* bo, T* co, float* dto, float* lao,
                 int Bt, int L, int Din, int N, int H, cudaStream_t s) {
    mamba_conv_silu_kernel<T, W><<<(unsigned)blocks, CONV_THREADS, 0, s>>>(
        zx, ld, cw, cb, db, al, xo, bo, co, dto, lao, Bt, L, Din, N, H);
}

template <typename T>
int conv_silu(const void* zx, int ld, const void* conv_w, const void* conv_b,
              const void* dt_bias, const void* A_log, void* xo, void* bo, void* co, void* dto,
              void* lao, int Bt, int L, int Din, int N, int H, int W, cudaStream_t s) {
    constexpr int V = Pack<T>::N;
    if (Bt <= 0 || L <= 0 || Din <= 0 || N <= 0 || H <= 0 || Din % V || N % V || H % V ||
        ld < 2 * Din + 2 * N + H)
        return (int)cudaErrorInvalidValue;
    const long long tasks = (long long)Bt * ((L + RUN - 1) / RUN) * ((Din + 2 * N + H) / V);
    const long long blocks = (tasks + CONV_THREADS - 1) / CONV_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    const T* zp = static_cast<const T*>(zx);
    const T* wp = static_cast<const T*>(conv_w);
    const float* cb = static_cast<const float*>(conv_b);
    const float* db = static_cast<const float*>(dt_bias);
    const float* al = static_cast<const float*>(A_log);
    T* x_ = static_cast<T*>(xo);
    T* b_ = static_cast<T*>(bo);
    T* c_ = static_cast<T*>(co);
    float* d_ = static_cast<float*>(dto);
    float* l_ = static_cast<float*>(lao);
    if (W == 2)
        conv_launch<T, 2>(blocks, zp, ld, wp, cb, db, al, x_, b_, c_, d_, l_, Bt, L, Din, N, H, s);
    else if (W == 3)
        conv_launch<T, 3>(blocks, zp, ld, wp, cb, db, al, x_, b_, c_, d_, l_, Bt, L, Din, N, H, s);
    else if (W == 4)
        conv_launch<T, 4>(blocks, zp, ld, wp, cb, db, al, x_, b_, c_, d_, l_, Bt, L, Din, N, H, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

template <typename T>
int gate_norm(const void* y, const void* x, const void* z, int ldz, const void* Dskip,
              const void* scale, void* out, int rows, int Din, int Pd, int G, float eps,
              cudaStream_t s) {
    constexpr int V = Pack<T>::N;
    if (rows <= 0 || Din <= 0 || Pd <= 0 || G <= 0 || Din % V || Pd % V || Din % Pd ||
        (Din / Pd) % G || ldz < Din)
        return (int)cudaErrorInvalidValue;
    const int Dg = Din / G;  // a group's channels, whole heads
    const long long blocks = (long long)rows * G;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    // CPT 16-byte chunks a thread, a warp multiple of threads covering the row
    const int nch = Dg / V;
    const int t4 = (nch + 4 * 32 - 1) / (4 * 32) * 32, t8 = (nch + 8 * 32 - 1) / (8 * 32) * 32;
    const T* yp = static_cast<const T*>(y);
    const T* xp = static_cast<const T*>(x);
    const T* zp = static_cast<const T*>(z);
    const float* dp = static_cast<const float*>(Dskip);
    const float* sp = static_cast<const float*>(scale);
    T* op = static_cast<T*>(out);
    if (t4 <= GATE_THREADS)
        mamba_gate_norm_kernel<T, 4><<<(unsigned)blocks, t4, 0, s>>>(yp, xp, zp, ldz, dp, sp, op,
                                                                      Dg, Pd, G, eps);
    else if (t8 <= GATE_THREADS)
        mamba_gate_norm_kernel<T, 8><<<(unsigned)blocks, t8, 0, s>>>(yp, xp, zp, ldz, dp, sp, op,
                                                                      Dg, Pd, G, eps);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mamba_rmsnorm(const void* x, const void* scale, void* out, int rows, int D,
                             float eps, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return rmsnorm<float>(x, scale, out, rows, D, eps, s);
    if (dtype == 1) return rmsnorm<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int mamba_conv_silu(const void* zx, int ld, const void* conv_w, const void* conv_b,
                               const void* dt_bias, const void* A_log, void* xo, void* bo,
                               void* co, void* dto, void* lao, int Bt, int L, int Din, int N,
                               int H, int W, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return conv_silu<float>(zx, ld, conv_w, conv_b, dt_bias, A_log, xo, bo, co, dto, lao, Bt,
                                L, Din, N, H, W, s);
    if (dtype == 1)
        return conv_silu<__nv_bfloat16>(zx, ld, conv_w, conv_b, dt_bias, A_log, xo, bo, co, dto,
                                        lao, Bt, L, Din, N, H, W, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int mamba_gate_norm(const void* y, const void* x, const void* z, int ldz,
                               const void* Dskip, const void* scale, void* out, int rows, int Din,
                               int Pd, int G, float eps, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return gate_norm<float>(y, x, z, ldz, Dskip, scale, out, rows, Din, Pd, G, eps, s);
    if (dtype == 1)
        return gate_norm<__nv_bfloat16>(y, x, z, ldz, Dskip, scale, out, rows, Din, Pd, G, eps,
                                        s);
    return (int)cudaErrorInvalidValue;
}
