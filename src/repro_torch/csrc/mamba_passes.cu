// The Mamba block's elementwise passes for Hopper, and their gradients:
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
// The backward (training: the block under autograd, remat's recompute running
// the forward kernels again).  Replaces no TPU kernel either: XLA fused the
// passes' gradients as it fused the passes.  Autograd through the plain passes
// wrote a full-size tensor per operation of the forward and of its gradient;
// at mamba2-1.3b's training step (B=8, L=2048) the passes took 40.7% of the
// device time.  Three kernels, each the gradient of one forward kernel, move
// per token and block (bf16 at mamba2-1.3b's widths):
//
//   4. mamba_gate_norm_bwd_kernel: read y, x, z and the out_proj input's
//      gradient, write dy (the scan's output gradient), the D skip's share of
//      dx and dz (the z columns of the input projection's gradient): 56 KB;
//   5. mamba_conv_silu_bwd_kernel: read the xBC and dt columns, dx (the
//      scan's and the D skip's), dB, dC, d dt and d log_a, write the xBC and
//      dt columns of the input projection's gradient: 35 KB;
//   6. mamba_rmsnorm_bwd_kernel: read x and dh, write dx: 12 KB.
//
// About 103 KB a token: 1.69 GB a block at 8 x 2048, 0.50 ms at 3.35 TB/s.
// Each recomputes in registers what it needs of the forward from the forward's
// own inputs (the norms' rms, the gate's rounded products, the conv's f32 sum
// before silu, softplus), so nothing but the inputs is saved.  The arithmetic
// is f32; the forward's rounding points to T count as the identity, as
// autograd takes them; outputs are rounded once.
//
//   4, 6. One block walks BWD_ROWS token rows (of one group, for 4), a row
//      held in registers across the block (CPT 16-byte chunks a thread), the
//      row's two sums (the rms, and the dot of the gradient with the
//      normalised row) reduced by shuffles and across warps with one barrier;
//      the next row's loads are in flight meanwhile.
//      A warp a row, as the forward norm, would hold each parameter
//      gradient's partial sum of a whole row in a lane's registers (128
//      floats at zamba2-7b's d_model); a block spreads it over its threads.
//   5. The forward's layout with half its chunk: a thread owns 4 channels (8
//      bytes in bf16, so that its sums of d conv_w and d conv_b and the
//      window fit its registers) and a run of BWD_RUN tokens, walking it
//      backwards: it recomputes each
//      token's pre-activation from the W inputs before it (kept packed in
//      registers, one new load a token), and the transposed conv takes the
//      W - 1 later tokens' gradients, also in registers (the W - 1 tokens past
//      the run are walked for them alone).  dx of the x channels is the
//      scan's plus the D skip's, added here, so autograd adds neither.  The
//      dt chunks differentiate softplus (threshold 20) and dt (-exp(A_log)).
//
// The input projection's gradient is assembled once: kernel 4 writes its z
// columns and kernel 5 the rest, in place, into one [B, L, in_proj width]
// tensor.  Parameter gradients are reduced deterministically: each block (4,
// 6) or thread (5) writes f32 partial sums of its rows or run, and
// mamba_colsum_kernel sums each column over them in a fixed order, casting to
// the parameter's dtype; no atomics, so two runs give equal bits.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libmamba_passes.so mamba_passes.cu
// C interface: mamba_rmsnorm, mamba_conv_silu, mamba_gate_norm and their
// backward mamba_rmsnorm_bwd, mamba_conv_silu_bwd, mamba_gate_norm_bwd, and
// mamba_colsum, each launch one kernel on the given stream and return
// cudaGetLastError() as an int (0 == launched).  The caller checks shapes,
// dtypes, contiguity and 16-byte alignment, and allocates the partial sums;
// each function refuses the widths its kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NORM_ROWS = 4;       // mamba_rmsnorm_kernel: rows (warps) a block
constexpr int CONV_THREADS = 256;  // mamba_conv_silu_kernel: threads a block
constexpr int RUN = 32;            // tokens a conv thread walks
constexpr int AHEAD = 8;           // tokens a conv thread loads ahead
constexpr int GATE_THREADS = 256;  // mamba_gate_norm_kernel: most threads a block (a row)
constexpr int BWD_THREADS = 512;   // kernels 4 and 6: most threads a block
constexpr int BWD_ROWS = 16;       // token rows a block of kernels 4 and 6 walks
constexpr int BWD_RUN = 64;        // tokens a thread of kernel 5 walks
constexpr int BWD_AHEAD = 4;       // tokens it loads ahead
constexpr int SUM_SLICES = 16;     // mamba_colsum_kernel: row slices a column is cut into

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

// d silu / dv with the hardware exponential and division (a few f32 ulps; 0
// where the exponential overflows, v far below 0)
__device__ __forceinline__ float dsilu(float v) {
    const float s = __fdividef(1.0f, 1.0f + __expf(-v));
    return s * (1.0f + v * (1.0f - s));
}

// element j (a constant once unrolled) of 16 packed bytes of T, as f32
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
template <typename T> __device__ __forceinline__ float elem(const uint4& r, int j);
template <> __device__ __forceinline__ float elem<float>(const uint4& r, int j) {
    return __uint_as_float(word(r, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int j) {
    const uint32_t w = word(r, j >> 1);
    return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
}

// 4 elements of T, kernel 5's unit: 8 bytes of bf16 (half a Pack, so that a
// thread's sums of W + 1 gradients fit its registers) or 16 of f32
template <typename T> struct Quad;

template <> struct Quad<float> {
    using Raw = uint4;
    __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
    __device__ static float elem(const Raw& r, int j) { return __uint_as_float(word(r, j)); }
    __device__ static Raw pack(const float (&v)[4]) {
        return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                          __float_as_uint(v[3]));
    }
};

template <> struct Quad<__nv_bfloat16> {
    using Raw = uint2;
    __device__ static Raw zero() { return make_uint2(0u, 0u); }
    __device__ static float elem(const Raw& r, int j) {
        const uint32_t w = j < 2 ? r.x : r.y;
        return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
    }
    __device__ static Raw pack(const float (&v)[4]) {
        using P = Pack<__nv_bfloat16>;
        return make_uint2(P::two(v[0], v[1]), P::two(v[2], v[3]));
    }
};

template <typename R> __device__ __forceinline__ R ld_raw(const void* p) {
    return *static_cast<const R*>(p);
}
template <typename R> __device__ __forceinline__ void st_raw(void* p, R v) {
    *static_cast<R*>(p) = v;
}

// chunk ch of a row of nch 16-byte chunks (zero past it), CPT chunks a thread
template <typename T, int CPT>
__device__ __forceinline__ void ld_row(uint4 (&v)[CPT], const T* p, int nch) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        v[k] = ch < nch ? ld16(p + ch * V) : make_uint4(0u, 0u, 0u, 0u);
    }
}

// the sums of a and b over the block, on every thread (each warp adds the
// warps' partials in the same order); buf is one of two buffers taken in
// turn by successive calls, so one barrier a call suffices
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* buf) {
    a = warp_sum(a);
    b = warp_sum(b);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) buf[warp] = make_float2(a, b);
    __syncthreads();
    const float2 v = lane < (int)(blockDim.x >> 5) ? buf[lane] : make_float2(0.0f, 0.0f);
    return make_float2(warp_sum(v.x), warp_sum(v.y));
}

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

// ---------------------------------------------------- 4. gate backward ----

// The gradient of kernel 3 over one group of Dg channels of BWD_ROWS token
// rows (blockIdx.x: the rows, blockIdx.y: the group).  With s = R(y + D x),
// a = R(silu(z)), v = R(s a) (R: the forward's rounding to T, the identity
// here), r = rsqrt(mean(v^2) + eps) and out = v r scale:
//   d scale += go v r;  dv = r go scale - r^3 v sum(go scale v) / Dg;
//   dy = dv a;  dx = dy D;  d D += dy x;  dz = dv s silu'(z).
// dy, dx: [rows, G, Dg]; z and dz strided by ldz; part_w [blocks, d_inner],
// part_d [blocks, d_inner / V] (one sum a 16-byte chunk, each in one head).
// The next row's loads are in flight during the current row's sums.
template <typename T, int CPT>
__global__ void __launch_bounds__(BWD_THREADS)
mamba_gate_norm_bwd_kernel(const T* __restrict__ y, const T* __restrict__ x,
                           const T* __restrict__ z, int ldz, const float* __restrict__ Dskip,
                           const float* __restrict__ scale, const T* __restrict__ go,
                           T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dz,
                           float* __restrict__ part_w, float* __restrict__ part_d, int rows,
                           int Dg, int Pd, int G, float eps) {
    using P = Pack<T>;
    constexpr int V = P::N;
    __shared__ float2 red[2][32];
    const int nch = Dg / V, Din = Dg * G, cb = blockIdx.y * Dg;  // the group's first channel
    const int r0 = blockIdx.x * BWD_ROWS, r1 = min(r0 + BWD_ROWS, rows);
    float w[CPT][V], dw[CPT][V], d[CPT], dd[CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) {
            ld_f32(scale + cb + ch * V, w[k]);
            d[k] = Dskip[(cb + ch * V) / Pd];  // a chunk lies in one head (Pd % V == 0)
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j) w[k][j] = 0.0f;
            d[k] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) dw[k][j] = 0.0f;
        dd[k] = 0.0f;
    }
    uint4 ry[CPT], rx[CPT], rz[CPT], rg[CPT];
    {
        const long long off = (long long)r0 * Din + cb, offz = (long long)r0 * ldz + cb;
        ld_row(ry, y + off, nch);
        ld_row(rx, x + off, nch);
        ld_row(rz, z + offz, nch);
        ld_row(rg, go + off, nch);
    }
    for (int r = r0; r < r1; ++r) {
        const long long off = (long long)r * Din + cb, offz = (long long)r * ldz + cb;
        uint4 ny[CPT], nx[CPT], nz[CPT], ng[CPT];
        if (r + 1 < r1) {
            ld_row(ny, y + off + Din, nch);
            ld_row(nx, x + off + Din, nch);
            ld_row(nz, z + offz + ldz, nch);
            ld_row(ng, go + off + Din, nch);
        }
        float ss = 0.0f, c = 0.0f;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
#pragma unroll
            for (int j = 0; j < V; ++j) {  // the forward's rounding points, bit for bit
                const float s = P::round(__fadd_rn(elem<T>(ry[k], j),
                                                   __fmul_rn(d[k], elem<T>(rx[k], j))));
                const float v = P::round(s * P::round(silu(elem<T>(rz[k], j))));
                ss = fmaf(v, v, ss);
                c = fmaf(elem<T>(rg[k], j) * w[k][j], v, c);
            }
        }
        const float2 t = block_sum2(ss, c, red[(r - r0) & 1]);
        const float rr = rsqrtf(t.x / (float)Dg + eps);
        const float k3 = rr * rr * rr * t.y / (float)Dg;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
            const int ch = threadIdx.x + k * blockDim.x;
            if (ch < nch) {
                float oy[V], ox[V], oz[V];
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    const float xv = elem<T>(rx[k], j), zv = elem<T>(rz[k], j);
                    const float g = elem<T>(rg[k], j);
                    const float s = P::round(__fadd_rn(elem<T>(ry[k], j), __fmul_rn(d[k], xv)));
                    const float a = P::round(silu(zv));
                    const float v = P::round(s * a);
                    dw[k][j] = fmaf(g, v * rr, dw[k][j]);
                    const float dv = rr * g * w[k][j] - k3 * v;
                    const float ds = dv * a;
                    dd[k] = fmaf(ds, xv, dd[k]);
                    oy[j] = ds;
                    ox[j] = ds * d[k];
                    oz[j] = dv * s * dsilu(zv);
                }
                st16(dy + off + ch * V, P::pack(oy));
                st16(dx + off + ch * V, P::pack(ox));
                st16(dz + offz + ch * V, P::pack(oz));
            }
        }
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
            ry[k] = ny[k];
            rx[k] = nx[k];
            rz[k] = nz[k];
            rg[k] = ng[k];
        }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) {
            st_f32(part_w + (long long)blockIdx.x * Din + cb + ch * V, dw[k]);
            part_d[(long long)blockIdx.x * (Din / V) + cb / V + ch] = dd[k];
        }
    }
}

// ------------------------------------------ 5. conv, silu, dt backward ----

// The gradient of kernel 2.  A thread owns the V = 4 channels from c0 (Quad:
// 8 bytes in bf16) and the run [t0, t1) of one batch row: with pre_t = sum_i
// w[i] u[t - W + 1 + i] + conv_b (u: the conv input, zero before the row) and
// the output silu(pre_t),
//   e_t = go_t silu'(pre_t);  d conv_b += e_t;  d w[i] += e_t u[t - W + 1 + i];
//   du_t = sum_i e[t + W - 1 - i] w[i],
// so it walks [t0, t1 + W - 1) backwards, the W inputs up to t packed in
// win[] (win[k]: k tokens back) and e of the W - 1 tokens after t in later[]
// (later[k]: k + 1 tokens on); the tokens past the run give e alone.  go is
// gx (+ gx2, the D skip's share, where given) for x, gb for B, gc for C; du
// goes to the xBC columns of dzx (strided by ld, as zx).  The dt threads,
// each V heads, with dt = softplus(raw + dt_bias) (threshold 20) and log_a
// = dt A, A = -exp(A_log):
//   d raw = (gdt + gla A) softplus'(raw + dt_bias) = d dt_bias;
//   d A_log = A sum(gla dt).
// part [Bt * runs, (W + 1) C + 2 H]: a thread's sums of d conv_w [W, C],
// d conv_b [C], d dt_bias [H] and d A_log [H] over its run.
template <typename T, int W>
__global__ void __launch_bounds__(CONV_THREADS)
mamba_conv_silu_bwd_kernel(const T* __restrict__ zx, int ld, const T* __restrict__ conv_w,
                           const float* __restrict__ conv_b, const float* __restrict__ dt_bias,
                           const float* __restrict__ A_log, const T* __restrict__ gx,
                           const T* __restrict__ gx2, const T* __restrict__ gb,
                           const T* __restrict__ gc, const float* __restrict__ gdt,
                           const float* __restrict__ gla, T* __restrict__ dzx,
                           float* __restrict__ part, int Bt, int L, int Din, int N, int H) {
    using Q = Quad<T>;
    using R = typename Q::Raw;
    constexpr int V = 4;
    const int C = Din + 2 * N;
    const int nconv = C / V, nch = nconv + H / V;
    const int runs = (L + BWD_RUN - 1) / BWD_RUN;
    const long long task = (long long)blockIdx.x * CONV_THREADS + threadIdx.x;
    if (task >= (long long)Bt * runs * nch) return;
    const int chunk = (int)(task % nch);
    const long long run = task / nch;  // b * runs + the run: the row of part
    const int t0 = (int)(run % runs) * BWD_RUN, t1 = min(t0 + BWD_RUN, L);
    const long long row0 = (run / runs) * L;  // token row of (b, 0)
    float* pr = part + run * ((long long)(W + 1) * C + 2 * H);

    if (chunk >= nconv) {  // dt of V heads
        const int h0 = (chunk - nconv) * V;
        const T* src = zx + Din + C + h0;
        T* dst = dzx + Din + C + h0;
        float bias[V], A[V], sb[V], sa[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            bias[j] = dt_bias[h0 + j];
            A[j] = -expf(A_log[h0 + j]);
            sb[j] = sa[j] = 0.0f;
        }
        for (int t = t0; t < t1; ++t) {
            float g[V], ga[V], o[V];
            const R raw = ld_raw<R>(src + (row0 + t) * ld);
            ld_f32(gdt + (row0 + t) * H + h0, g);
            ld_f32(gla + (row0 + t) * H + h0, ga);
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float pre = Q::elem(raw, j) + bias[j];
                const float e = expf(pre);
                const bool lin = pre > 20.0f;  // F.softplus's threshold
                const float sp = lin ? pre : log1pf(e);
                o[j] = fmaf(ga[j], A[j], g[j]) * (lin ? 1.0f : e / (e + 1.0f));
                sb[j] += o[j];
                sa[j] = fmaf(ga[j], sp, sa[j]);
            }
            st_raw<R>(dst + (row0 + t) * ld, Q::pack(o));
        }
#pragma unroll
        for (int j = 0; j < V; ++j) sa[j] *= A[j];
        st_f32(pr + (long long)(W + 1) * C + h0, sb);
        st_f32(pr + (long long)(W + 1) * C + H + h0, sa);
        return;
    }

    const int c0 = chunk * V;
    const T* src = zx + Din + c0;
    T* dst = dzx + Din + c0;
    const T* g1;
    const T* g2 = nullptr;
    int gld;
    if (c0 < Din) {
        g1 = gx + c0;
        if (gx2 != nullptr) g2 = gx2 + c0;
        gld = Din;
    } else if (c0 < Din + N) {
        g1 = gb + (c0 - Din);
        gld = N;
    } else {
        g1 = gc + (c0 - Din - N);
        gld = N;
    }
    float w[W][V];
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const R r = ld_raw<R>(conv_w + (long long)k * C + c0);
#pragma unroll
        for (int j = 0; j < V; ++j) w[k][j] = Q::elem(r, j);
    }
    float bias[V], db[V], dw[W][V], later[W - 1][V];
    ld_f32(conv_b + c0, bias);
#pragma unroll
    for (int j = 0; j < V; ++j) {
        db[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < W; ++k) dw[k][j] = 0.0f;
#pragma unroll
        for (int k = 0; k < W - 1; ++k) later[k][j] = 0.0f;
    }
    const int te = min(t1 + W - 1, L);
    float win[W][V];
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const int t = te - 1 - k;
        const R r = t >= 0 ? ld_raw<R>(src + (row0 + t) * ld) : Q::zero();
#pragma unroll
        for (int j = 0; j < V; ++j) win[k][j] = Q::elem(r, j);
    }
    for (int t = te - 1; t >= t0; t -= BWD_AHEAD) {
        R rg[BWD_AHEAD], rg2[BWD_AHEAD], rin[BWD_AHEAD];
#pragma unroll
        for (int u = 0; u < BWD_AHEAD; ++u) {
            const int tt = t - u;
            if (tt >= t0) {
                rg[u] = ld_raw<R>(g1 + (row0 + tt) * gld);
                rg2[u] = g2 != nullptr ? ld_raw<R>(g2 + (row0 + tt) * gld) : Q::zero();
                rin[u] = tt >= W ? ld_raw<R>(src + (row0 + tt - W) * ld) : Q::zero();
            }
        }
#pragma unroll
        for (int u = 0; u < BWD_AHEAD; ++u) {
            const int tt = t - u;
            if (tt >= t0) {
                float e[V];
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    // the forward's pre-activation, bit for bit: the oldest input first
                    float acc = 0.0f;
#pragma unroll
                    for (int i = 0; i < W - 1; ++i) acc = fmaf(win[W - 1 - i][j], w[i][j], acc);
                    acc = fmaf(win[0][j], w[W - 1][j], acc) + bias[j];
                    e[j] = (Q::elem(rg[u], j) + Q::elem(rg2[u], j)) * dsilu(acc);
                }
                if (tt < t1) {
                    float du[V];
#pragma unroll
                    for (int j = 0; j < V; ++j) {
                        db[j] += e[j];
#pragma unroll
                        for (int i = 0; i < W; ++i) dw[i][j] = fmaf(e[j], win[W - 1 - i][j], dw[i][j]);
                        float s = e[j] * w[W - 1][j];
#pragma unroll
                        for (int k = 0; k < W - 1; ++k) s = fmaf(later[k][j], w[W - 2 - k][j], s);
                        du[j] = s;
                    }
                    st_raw<R>(dst + (row0 + tt) * ld, Q::pack(du));
                }
#pragma unroll
                for (int k = W - 2; k > 0; --k)
#pragma unroll
                    for (int j = 0; j < V; ++j) later[k][j] = later[k - 1][j];
#pragma unroll
                for (int j = 0; j < V; ++j) later[0][j] = e[j];
#pragma unroll
                for (int k = 0; k < W - 1; ++k)
#pragma unroll
                    for (int j = 0; j < V; ++j) win[k][j] = win[k + 1][j];
#pragma unroll
                for (int j = 0; j < V; ++j) win[W - 1][j] = Q::elem(rin[u], j);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) st_f32(pr + (long long)i * C + c0, dw[i]);
    st_f32(pr + (long long)W * C + c0, db);
}

// -------------------------------------------------- 6. norm backward ----

// The gradient of kernel 1 over BWD_ROWS token rows: with r = rsqrt(mean(x^2)
// + eps), out = x r scale:  d scale += go x r;
// dx = r go scale - r^3 x sum(go scale x) / D.  part [blocks, D].  The next
// row's loads are in flight during the current row's sums.
template <typename T, int CPT>
__global__ void __launch_bounds__(BWD_THREADS)
mamba_rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ go, T* __restrict__ dx, float* __restrict__ part,
                         int rows, int D, float eps) {
    using P = Pack<T>;
    constexpr int V = P::N;
    __shared__ float2 red[2][32];
    const int nch = D / V;
    const int r0 = blockIdx.x * BWD_ROWS, r1 = min(r0 + BWD_ROWS, rows);
    float w[CPT][V], dw[CPT][V];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) {
            ld_f32(scale + ch * V, w[k]);
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j) w[k][j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) dw[k][j] = 0.0f;
    }
    uint4 rx[CPT], rg[CPT];
    ld_row(rx, x + (long long)r0 * D, nch);
    ld_row(rg, go + (long long)r0 * D, nch);
    for (int r = r0; r < r1; ++r) {
        const long long off = (long long)r * D;
        uint4 nx[CPT], ng[CPT];
        if (r + 1 < r1) {
            ld_row(nx, x + off + D, nch);
            ld_row(ng, go + off + D, nch);
        }
        float ss = 0.0f, c = 0.0f;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float xv = elem<T>(rx[k], j);
                ss = fmaf(xv, xv, ss);
                c = fmaf(elem<T>(rg[k], j) * w[k][j], xv, c);
            }
        }
        const float2 t = block_sum2(ss, c, red[(r - r0) & 1]);
        const float rr = rsqrtf(t.x / (float)D + eps);
        const float k3 = rr * rr * rr * t.y / (float)D;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
            const int ch = threadIdx.x + k * blockDim.x;
            if (ch < nch) {
                float o[V];
#pragma unroll
                for (int j = 0; j < V; ++j) {
                    const float xv = elem<T>(rx[k], j), g = elem<T>(rg[k], j);
                    dw[k][j] = fmaf(g, xv * rr, dw[k][j]);
                    o[j] = rr * g * w[k][j] - k3 * xv;
                }
                st16(dx + off + ch * V, P::pack(o));
            }
        }
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
            rx[k] = nx[k];
            rg[k] = ng[k];
        }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int ch = threadIdx.x + k * blockDim.x;
        if (ch < nch) st_f32(part + (long long)blockIdx.x * D + ch * V, dw[k]);
    }
}

// ------------------------------------------------ 7. the partial sums ----

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// out[c] = the sum over the R rows of part (row stride ld) of the group
// columns c group .. c group + group - 1: each of SUM_SLICES threads of a
// column takes every SUM_SLICES-th row in turn, then one adds the slices in
// order; the order is fixed, so the bits are.
template <typename O>
__global__ void __launch_bounds__(32 * SUM_SLICES)
mamba_colsum_kernel(const float* __restrict__ part, int R, int ld, int ncols, int group,
                    O* __restrict__ out) {
    __shared__ float acc[SUM_SLICES][33];
    const int col = blockIdx.x * 32 + threadIdx.x;
    float s = 0.0f;
    if (col < ncols) {
        const float* p = part + (long long)col * group;
#pragma unroll 4
        for (int r = threadIdx.y; r < R; r += SUM_SLICES)
            for (int j = 0; j < group; ++j) s += p[(long long)r * ld + j];
    }
    acc[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && col < ncols) {
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < SUM_SLICES; ++i) t += acc[i][threadIdx.x];
        store_as(out + col, t);
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

// CPT of kernels 4 and 6: the fewest 16-byte chunks a thread (1, 2 or 4) that
// fit a row of nch chunks in BWD_THREADS threads (0: none do)
inline int bwd_cpt(int nch) {
    for (int c = 1; c <= 4; c *= 2)
        if ((nch + c - 1) / c <= BWD_THREADS) return c;
    return 0;
}

// a warp multiple of threads covering nch chunks, cpt a thread
inline int bwd_threads(int nch, int cpt) { return ((nch + cpt - 1) / cpt + 31) / 32 * 32; }

template <typename T>
int rmsnorm_bwd(const void* x, const void* scale, const void* go, void* dx, void* part, int rows,
                int D, float eps, cudaStream_t s) {
    constexpr int V = Pack<T>::N;
    if (rows <= 0 || D <= 0 || D % V) return (int)cudaErrorInvalidValue;
    const int nch = D / V, cpt = bwd_cpt(nch);
    if (cpt == 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((rows + BWD_ROWS - 1) / BWD_ROWS), block(bwd_threads(nch, cpt));
    const T* xp = static_cast<const T*>(x);
    const float* sp = static_cast<const float*>(scale);
    const T* gp = static_cast<const T*>(go);
    T* dp = static_cast<T*>(dx);
    float* pp = static_cast<float*>(part);
    if (cpt == 1)
        mamba_rmsnorm_bwd_kernel<T, 1><<<grid, block, 0, s>>>(xp, sp, gp, dp, pp, rows, D, eps);
    else if (cpt == 2)
        mamba_rmsnorm_bwd_kernel<T, 2><<<grid, block, 0, s>>>(xp, sp, gp, dp, pp, rows, D, eps);
    else
        mamba_rmsnorm_bwd_kernel<T, 4><<<grid, block, 0, s>>>(xp, sp, gp, dp, pp, rows, D, eps);
    return (int)cudaGetLastError();
}

template <typename T, int W>
void conv_bwd_launch(long long blocks, const T* zx, int ld, const T* cw, const float* cb,
                     const float* db, const float* al, const T* gx, const T* gx2, const T* gb,
                     const T* gc, const float* gdt, const float* gla, T* dzx, float* part, int Bt,
                     int L, int Din, int N, int H, cudaStream_t s) {
    mamba_conv_silu_bwd_kernel<T, W><<<(unsigned)blocks, CONV_THREADS, 0, s>>>(
        zx, ld, cw, cb, db, al, gx, gx2, gb, gc, gdt, gla, dzx, part, Bt, L, Din, N, H);
}

template <typename T>
int conv_silu_bwd(const void* zx, int ld, const void* conv_w, const void* conv_b,
                  const void* dt_bias, const void* A_log, const void* gx, const void* gx2,
                  const void* gb, const void* gc, const void* gdt, const void* gla, void* dzx,
                  void* part, int Bt, int L, int Din, int N, int H, int W, cudaStream_t s) {
    constexpr int V = Pack<T>::N;  // the rows' alignment; the kernel's unit is 4 elements
    if (Bt <= 0 || L <= 0 || Din <= 0 || N <= 0 || H <= 0 || Din % V || N % V || H % V ||
        ld < 2 * Din + 2 * N + H)
        return (int)cudaErrorInvalidValue;
    const long long tasks =
        (long long)Bt * ((L + BWD_RUN - 1) / BWD_RUN) * ((Din + 2 * N + H) / 4);
    const long long blocks = (tasks + CONV_THREADS - 1) / CONV_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    const T* zp = static_cast<const T*>(zx);
    const T* wp = static_cast<const T*>(conv_w);
    const float* cb = static_cast<const float*>(conv_b);
    const float* db = static_cast<const float*>(dt_bias);
    const float* al = static_cast<const float*>(A_log);
    const T* g_x = static_cast<const T*>(gx);
    const T* g_x2 = static_cast<const T*>(gx2);
    const T* g_b = static_cast<const T*>(gb);
    const T* g_c = static_cast<const T*>(gc);
    const float* g_dt = static_cast<const float*>(gdt);
    const float* g_la = static_cast<const float*>(gla);
    T* d_ = static_cast<T*>(dzx);
    float* p_ = static_cast<float*>(part);
    if (W == 2)
        conv_bwd_launch<T, 2>(blocks, zp, ld, wp, cb, db, al, g_x, g_x2, g_b, g_c, g_dt, g_la, d_,
                              p_, Bt, L, Din, N, H, s);
    else if (W == 3)
        conv_bwd_launch<T, 3>(blocks, zp, ld, wp, cb, db, al, g_x, g_x2, g_b, g_c, g_dt, g_la, d_,
                              p_, Bt, L, Din, N, H, s);
    else if (W == 4)
        conv_bwd_launch<T, 4>(blocks, zp, ld, wp, cb, db, al, g_x, g_x2, g_b, g_c, g_dt, g_la, d_,
                              p_, Bt, L, Din, N, H, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

template <typename T>
int gate_norm_bwd(const void* y, const void* x, const void* z, int ldz, const void* Dskip,
                  const void* scale, const void* go, void* dy, void* dx, void* dz, void* part_w,
                  void* part_d, int rows, int Din, int Pd, int G, float eps, cudaStream_t s) {
    constexpr int V = Pack<T>::N;
    if (rows <= 0 || Din <= 0 || Pd <= 0 || G <= 0 || Din % V || Pd % V || Din % Pd ||
        (Din / Pd) % G || ldz < Din)
        return (int)cudaErrorInvalidValue;
    const int Dg = Din / G, nch = Dg / V, cpt = bwd_cpt(nch);
    if (cpt == 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((rows + BWD_ROWS - 1) / BWD_ROWS, G), block(bwd_threads(nch, cpt));
    const T* yp = static_cast<const T*>(y);
    const T* xp = static_cast<const T*>(x);
    const T* zp = static_cast<const T*>(z);
    const float* dp = static_cast<const float*>(Dskip);
    const float* sp = static_cast<const float*>(scale);
    const T* gp = static_cast<const T*>(go);
    T* o_y = static_cast<T*>(dy);
    T* o_x = static_cast<T*>(dx);
    T* o_z = static_cast<T*>(dz);
    float* pw = static_cast<float*>(part_w);
    float* pd = static_cast<float*>(part_d);
    if (cpt == 1)
        mamba_gate_norm_bwd_kernel<T, 1><<<grid, block, 0, s>>>(yp, xp, zp, ldz, dp, sp, gp, o_y,
                                                                o_x, o_z, pw, pd, rows, Dg, Pd, G,
                                                                eps);
    else if (cpt == 2)
        mamba_gate_norm_bwd_kernel<T, 2><<<grid, block, 0, s>>>(yp, xp, zp, ldz, dp, sp, gp, o_y,
                                                                o_x, o_z, pw, pd, rows, Dg, Pd, G,
                                                                eps);
    else
        mamba_gate_norm_bwd_kernel<T, 4><<<grid, block, 0, s>>>(yp, xp, zp, ldz, dp, sp, gp, o_y,
                                                                o_x, o_z, pw, pd, rows, Dg, Pd, G,
                                                                eps);
    return (int)cudaGetLastError();
}

template <typename O>
int colsum(const void* part, int R, int ld, int ncols, int group, void* out, cudaStream_t s) {
    if (R <= 0 || ncols <= 0 || group <= 0 || ld < ncols * group) return (int)cudaErrorInvalidValue;
    const dim3 grid((ncols + 31) / 32), block(32, SUM_SLICES);
    mamba_colsum_kernel<O><<<grid, block, 0, s>>>(static_cast<const float*>(part), R, ld, ncols,
                                                  group, static_cast<O*>(out));
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

extern "C" int mamba_rmsnorm_bwd(const void* x, const void* scale, const void* go, void* dx,
                                 void* part, int rows, int D, float eps, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return rmsnorm_bwd<float>(x, scale, go, dx, part, rows, D, eps, s);
    if (dtype == 1) return rmsnorm_bwd<__nv_bfloat16>(x, scale, go, dx, part, rows, D, eps, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int mamba_conv_silu_bwd(const void* zx, int ld, const void* conv_w,
                                   const void* conv_b, const void* dt_bias, const void* A_log,
                                   const void* gx, const void* gx2, const void* gb,
                                   const void* gc, const void* gdt, const void* gla, void* dzx,
                                   void* part, int Bt, int L, int Din, int N, int H, int W,
                                   int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return conv_silu_bwd<float>(zx, ld, conv_w, conv_b, dt_bias, A_log, gx, gx2, gb, gc, gdt,
                                    gla, dzx, part, Bt, L, Din, N, H, W, s);
    if (dtype == 1)
        return conv_silu_bwd<__nv_bfloat16>(zx, ld, conv_w, conv_b, dt_bias, A_log, gx, gx2, gb,
                                            gc, gdt, gla, dzx, part, Bt, L, Din, N, H, W, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int mamba_gate_norm_bwd(const void* y, const void* x, const void* z, int ldz,
                                   const void* Dskip, const void* scale, const void* go, void* dy,
                                   void* dx, void* dz, void* part_w, void* part_d, int rows,
                                   int Din, int Pd, int G, float eps, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return gate_norm_bwd<float>(y, x, z, ldz, Dskip, scale, go, dy, dx, dz, part_w, part_d,
                                    rows, Din, Pd, G, eps, s);
    if (dtype == 1)
        return gate_norm_bwd<__nv_bfloat16>(y, x, z, ldz, Dskip, scale, go, dy, dx, dz, part_w,
                                            part_d, rows, Din, Pd, G, eps, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int mamba_colsum(const void* part, int R, int ld, int ncols, int group, void* out,
                            int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return colsum<float>(part, R, ld, ncols, group, out, s);
    if (dtype == 1) return colsum<__nv_bfloat16>(part, R, ld, ncols, group, out, s);
    return (int)cudaErrorInvalidValue;
}
