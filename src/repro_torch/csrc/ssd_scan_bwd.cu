// Mamba2 SSD chunked scan, backward, for Hopper.
//
// Replaces no TPU kernel: the JAX package differentiates its plain blocked
// ssd_chunked with autograd and has no backward kernel.  The port's forward
// kernel (ssd_scan.cu) runs inside ops.SSDScan under autograd; this is that
// Function's backward on CUDA tensors, the function kernels/ssd_scan/ref.py
// ::ssd_chunked_grads writes out.
//
// What it computes.  From the forward's inputs x [Bt, L, H, P], log_a and dt
// [Bt, L, H] (f32), B and C [Bt, L, NG, N] (head h reads group h / (H / NG)),
// and dy [Bt, L, H, P] (x's dtype), the five gradients dx, dB, dC (x's dtype),
// dlog_a and ddt (f32).  Per (batch row b, chunk c, head h of group g), with
// positions i, j in the chunk, cum the inclusive cumsum of log_a, T = cum[Q-1],
// xdt = dt x, Gm = C B^T, Lm[i, j] = exp(cum_i - cum_j) for j <= i (else 0), S
// the state entering the chunk and dS' the gradient of the state leaving it:
//
//   S_{c+1} = e^T S_c + Σ_j e^{T-cum_j} B_j xdt_j^T,   dS'_{c-1} = e^T dS'_c + Σ_i e^{cum_i} C_i dy_i^T
//   dxdt_j  = Σ_{i>=j} Gm_ij Lm_ij dy_i + e^{T-cum_j} dS'^T B_j,  dx = dt dxdt,  ddt = x·dxdt
//   dGm     = Σ_{h of g} Lm ∘ (dy xdt^T)
//   dC      = dGm B + Σ_{h of g} e^{cum} dy S^T,   dB = dGm^T C + Σ_{h of g} e^{T-cum} xdt dS'^T
//   dcum_k  = dy_k·y_k - xdt_k·dxdt_k, each without its diagonal term Gm_kk dy_k·xdt_k (equal
//             in both), + dT = e^T <S, dS'> + Σ_j xdt_j·(e^{T-cum_j} dS'^T B_j) at Q-1
//   dlog_a  = the reverse cumsum of dcum in the chunk
//
// with y recomputed in f32.  Summing dGm over a group's heads before it meets B
// and C, and stacking the heads' (h, p) columns in the state products, sums dB
// and dC over the heads inside one product each: no race and no per-head copy.
//
// What bounds it.  Operations: at mamba2-1.3b's training shape (Bt 8, L 2048,
// H 64, P 64, N 128, Q 256, bf16) the products above need 156.4 GFLOP with the
// causal halves counted exactly (51.6 with both operands f32, 104.3 with one
// bf16, 0.54 of C B^T), 0.735 ms at the tensor cores' TF32 rate against 0.170
// ms for its 0.57 GB of inputs and outputs (chip_smoke.ssd_bwd_floor).  Every
// product has an f32 operand (decays, xdt, states, scores), so it needs f32
// accuracy: split TF32 on the tensor cores (as ssd_scan.cu: a = hi + lo,
// lo*hi + hi*lo + hi*hi on mma.sync m16n8k8), with the lo product of an
// operand that is exact in TF32 (bf16 x, B, C, dy) skipped.
//
// Design: nine launches a call, each a grid of independent blocks.
//
//   ssd_bwd_prep_kernel      cum, e^cum and e^{T-cum} of every (b, c, h): a warp each
//   ssd_bwd_gram_kernel      Gm = C B^T per (b, c, g), its causal 64 x 64 tiles
//   ssd_bwd_state_kernel     the chunk-local states Σ e^{T-cum} B xdt^T and Σ e^{cum} C dy^T
//   ssd_bwd_chunk_scan_kernel  the two walks over the chunks, in place: S entering
//                            each chunk, dS' leaving it, and e^T <S, dS'> in parts
//   ssd_bwd_y_kernel         dy·y per position, y recomputed (scores, then C S)
//   ssd_bwd_dxdt_kernel      dxdt (dS' B first, its x-dot kept, then the scores
//                            below the diagonal, then the diagonal), dx, and the
//                            x-dots per position
//   ssd_bwd_dgram_kernel     dGm per (b, c, g) causal tile, over the group's heads
//   ssd_bwd_dbc_kernel       dC (rows i) and dB (rows j), one launch each
//   ssd_bwd_final_kernel     ddt, dcum and its reverse cumsum: a warp each
//
// Every product is one routine (gemm_seg): a 64 x 64 f32 output tile held by 8
// warps, the contraction in slabs of 32, each slab's operands fetched from
// device memory in groups of 4 consecutive elements (one 16- or 8-byte load
// where aligned) by a per-kernel functor, which forms the scaled operand and
// masks the causal half and the edges, into registers while the slab before it
// multiplies; then stored to shared memory in the layout that puts both the
// stores and the fragment loads on distinct banks.  Three blocks an SM.  Row reductions over a tile
// (dy·y, x·dxdt) are summed in a fixed order, so two runs give equal bits.
// The intermediates live in f32 buffers the wrapper allocates
// (kernels/ssd_scan/kernel_bwd.py).
//
// Decays.  exp(cum_i - cum_j) is evaluated only where j <= i (a select, never a
// multiply by a mask), with __expf (expf measured no closer to a float64
// gradient); as log_a <= 0 it is at most 1.  A log_a with positive entries is
// outside the kernel's contract, as in the forward.
//
// dcum's diagonal.  Where the decays are strong (a Mamba block's log_a reaches
// -74 a step), dy_k·y_k and xdt_k·dxdt_k are mostly the same term Gm_kk
// dy_k·xdt_k, and their difference is what dlog_a sums.  Taken from two
// products, their split-TF32 roundings do not cancel: the block's A_log
// gradient read 5.9e-4 of max|ref| apart on two inputs that differ by rounding.
// So both leave that term out (the y recompute below the diagonal, dxdt's x-dot
// taken before the diagonal is added in f32), and it cancels exactly.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libssd_scan_bwd.so ssd_scan_bwd.cu
// C interface: ssd_scan_bwd(...) launches the kernels on the given stream and
// returns cudaGetLastError() as an int (0 == launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

// The products' blocks, measured at mamba2-1.3b's training shape (bf16, H100):
// 6.6 ms a call.  Fetching element by element, 2 x 2 warps of 32 x 32 at one
// block an SM took 20.9 ms and 8 warps at two blocks 12.7; fetching by 4, two
// blocks 7.1 ms, four 6.9 (spills), 16 warps 6.4, slabs of 64 7.3.  Occupancy
// decides it: each slab's fetch waits on device memory.
constexpr int BM = 64;       // rows of an output tile
constexpr int BN = 64;       // columns of an output tile
constexpr int BK = 32;       // contraction slab
constexpr int LOG_BK = 5;
constexpr int WARPS_N = 4;   // warps across an output tile's columns; 2 down its rows
constexpr int NTHR = 64 * WARPS_N;  // a product's block: 8 warps of 32 x 16
constexpr int NT = 8 / WARPS_N;     // mma tiles of 8 columns in a warp's part
constexpr int FE = BM * BK / NTHR;  // elements of each operand slab a thread fetches
constexpr int MIN_BLOCKS = 3;       // blocks an SM (__launch_bounds__: 80 registers)
using Acc = float[2][NT][4];
// floats of one operand slab: [64][BK + 4] or [BK][64 + 8]
constexpr int TS = BM * (BK + 4) > BK * (BM + 8) ? BM * (BK + 4) : BK * (BM + 8);
constexpr int SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Exact { static constexpr bool value = false; };
template <> struct Exact<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// hi = v rounded to TF32, lo = v - hi (ssd_scan.cu's split)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// ------------------------------------------------------------ the product

struct __align__(16) Tiles {
    float a[TS];
    float b[TS];
};

// A slab (m, k): A_MC (consecutive threads fetch along m) as [k][64 + 8], else
// [m][BK + 4]; B slab (k, n): B_KC (fetched along k) as [n][BK + 4], else
// [k][64 + 8].  Either way a warp stores along a row, and the fragment loads
// (rows g, columns t, or the transposes) fall on 32 distinct banks.
template <bool A_MC>
__device__ __forceinline__ float& a_at(float* a, int m, int k) {
    return A_MC ? a[k * (BM + 8) + m] : a[m * (BK + 4) + k];
}
template <bool B_KC>
__device__ __forceinline__ float& b_at(float* b, int k, int n) {
    return B_KC ? b[n * (BK + 4) + k] : b[k * (BN + 8) + n];
}

// v[u] = p[u] for u < n (n <= 4), else 0: one 16-byte (f32) or 8-byte (bf16) load
// where vec (every group of 4 starts aligned) and n == 4
template <typename T>
__device__ __forceinline__ void ld4(const T* p, int n, bool vec, float (&v)[4]) {
    if (vec && n == 4) {
        if constexpr (sizeof(T) == 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p));
            v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        } else {
            const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
            const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
            const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
            v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
        }
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = u < n ? to_f(p[u]) : 0.f;
    }
}

__device__ __forceinline__ void zero4(float (&v)[4]) { v[0] = v[1] = v[2] = v[3] = 0.f; }

// Operand fetches go in groups of 4 elements consecutive in memory: along m
// (A_MC) or k for A, along k (B_KC) or n for B.  la(m, k, n, v) fills v with
// A (m..m+3, k) or A (m, k..k+3), lb(k, n, cnt, v) with B (k..k+3, n) or
// B (k, n..n+3); along k, n (<= 4) is how many are below the contraction's
// end, and each functor masks its own edges.  G4 groups of each operand a thread.
constexpr int G4 = FE / 4;

template <bool A_MC, bool B_KC, class LA, class LB>
__device__ __forceinline__ void fetch(float (&ra)[FE], float (&rb)[FE], const LA& la, const LB& lb,
                                      int k0, int kend) {
#pragma unroll
    for (int q = 0; q < G4; ++q) {
        const int e = threadIdx.x + q * NTHR;
        float* va = ra + 4 * q;
        float* vb = rb + 4 * q;
        if constexpr (A_MC) {
            const int am = (e % (BM / 4)) * 4, ak = k0 + e / (BM / 4);
            if (ak < kend) la(am, ak, 4, *reinterpret_cast<float(*)[4]>(va));
            else zero4(*reinterpret_cast<float(*)[4]>(va));
        } else {
            const int am = e / (BK / 4), ak = k0 + (e % (BK / 4)) * 4;
            if (ak < kend) la(am, ak, min(4, kend - ak), *reinterpret_cast<float(*)[4]>(va));
            else zero4(*reinterpret_cast<float(*)[4]>(va));
        }
        if constexpr (B_KC) {
            const int bn = e / (BK / 4), bk = k0 + (e % (BK / 4)) * 4;
            if (bk < kend) lb(bk, bn, min(4, kend - bk), *reinterpret_cast<float(*)[4]>(vb));
            else zero4(*reinterpret_cast<float(*)[4]>(vb));
        } else {
            const int bn = (e % (BN / 4)) * 4, bk = k0 + e / (BN / 4);
            if (bk < kend) lb(bk, bn, 4, *reinterpret_cast<float(*)[4]>(vb));
            else zero4(*reinterpret_cast<float(*)[4]>(vb));
        }
    }
}

template <bool A_MC, bool B_KC>
__device__ __forceinline__ void stash(Tiles& s, const float (&ra)[FE], const float (&rb)[FE]) {
#pragma unroll
    for (int q = 0; q < G4; ++q) {
        const int e = threadIdx.x + q * NTHR;
        const float4 va = make_float4(ra[4 * q], ra[4 * q + 1], ra[4 * q + 2], ra[4 * q + 3]);
        const float4 vb = make_float4(rb[4 * q], rb[4 * q + 1], rb[4 * q + 2], rb[4 * q + 3]);
        const int am = A_MC ? (e % (BM / 4)) * 4 : e / (BK / 4);
        const int ak = A_MC ? e / (BM / 4) : (e % (BK / 4)) * 4;
        *reinterpret_cast<float4*>(&a_at<A_MC>(s.a, am, ak)) = va;
        const int bn = B_KC ? e / (BK / 4) : (e % (BN / 4)) * 4;
        const int bk = B_KC ? (e % (BK / 4)) * 4 : e / (BN / 4);
        *reinterpret_cast<float4*>(&b_at<B_KC>(s.b, bk, bn)) = vb;
    }
}

// acc += the slab's products of this warp's 32 x 16 part, in split TF32;
// AE / BE: the operand is exact in TF32 (bf16 values), so its lo part is 0
template <bool AE, bool BE, bool A_MC, bool B_KC>
__device__ __forceinline__ void slab_mma(Acc& acc, Tiles& s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[2][4], al[2][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = wm * 32 + i * 16 + g;
            const float v[4] = {a_at<A_MC>(s.a, r, kk + t), a_at<A_MC>(s.a, r + 8, kk + t),
                                a_at<A_MC>(s.a, r, kk + t + 4), a_at<A_MC>(s.a, r + 8, kk + t + 4)};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if constexpr (AE) {
                    ah[i][q] = __float_as_uint(v[q]);
                    al[i][q] = 0u;
                } else {
                    split(v[q], ah[i][q], al[i][q]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = wn * (BN / WARPS_N) + j * 8 + g;
            const float v[2] = {b_at<B_KC>(s.b, kk + t, c), b_at<B_KC>(s.b, kk + t + 4, c)};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if constexpr (BE) {
                    bh[j][q] = __float_as_uint(v[q]);
                    bl[j][q] = 0u;
                } else {
                    split(v[q], bh[j][q], bl[j][q]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {  // small terms first, then the large one
                if constexpr (!AE) mma_tf32(acc[i][j], al[i], bh[j]);
                if constexpr (!BE) mma_tf32(acc[i][j], ah[i], bl[j]);
                mma_tf32(acc[i][j], ah[i], bh[j]);
            }
    }
}

// acc[64 x 64] += A B over k in [kbeg, kend), the operands' groups from la and
// lb (see fetch), m and n counted in the tile (the functors give 0 past the
// edges).  The next slab is fetched into registers while this one multiplies.
// kbeg and kend are uniform in the block.
template <bool AE, bool BE, bool A_MC, bool B_KC, class LA, class LB>
__device__ __forceinline__ void gemm_seg(Acc& acc, Tiles& s, const LA& la,
                                         const LB& lb, int kbeg, int kend) {
    if (kbeg >= kend) return;
    float ra[FE], rb[FE];
    fetch<A_MC, B_KC>(ra, rb, la, lb, kbeg, kend);
    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        __syncthreads();  // the slab before is no longer read
        stash<A_MC, B_KC>(s, ra, rb);
        __syncthreads();
        if (k0 + BK < kend) fetch<A_MC, B_KC>(ra, rb, la, lb, k0 + BK, kend);
        slab_mma<AE, BE, A_MC, B_KC>(acc, s);
    }
}

// the tile row and column of this thread's accumulator acc[i][j][q]
__device__ __forceinline__ int frag_row(int i, int q) {
    return (threadIdx.x / 32 / WARPS_N) * 32 + i * 16 + ((threadIdx.x & 31) >> 2) + (q >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int j, int q) {
    return (threadIdx.x / 32 % WARPS_N) * (BN / WARPS_N) + j * 8 + 2 * (threadIdx.x & 3) + (q & 1);
}

// red_sum(red, r) = Σ over the tile's columns of f(r, col) acc(r, col), for
// each of the tile's 64 rows r, in a fixed order (red: [WARPS_N][64] floats)
template <class F>
__device__ __forceinline__ void row_dot(const Acc& acc, const F& f, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp / WARPS_N, wn = warp % WARPS_N;
    float part[2][2] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                part[i][q >> 1] += f(frag_row(i, q), frag_col(j, q)) * acc[i][j][q];
    __syncthreads();  // red's readers before are done
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float v = part[i][hh];
            v += __shfl_xor_sync(FULL, v, 1);
            v += __shfl_xor_sync(FULL, v, 2);
            if (t == 0) red[wn * 64 + wm * 32 + i * 16 + hh * 8 + g] = v;
        }
    __syncthreads();
}

__device__ __forceinline__ float red_sum(const float* red, int r) {
    float v = red[r];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) v += red[w * BM + r];
    return v;
}

// ------------------------------------------------------------ the kernels

// The problem's sizes.  Positions are rows of [Bt * L]; row0 = b L + c Q is a
// chunk's first.  x, dy [rows, H, P]; log_a, dt, cum, ecum, erev [rows, H];
// B, C [rows, NG, N]; Gm, dGm [Bt, nc, NG, Q, Q]; the states [Bt, nc, H, N, P].
struct Dims {
    int Bt, L, H, P, N, Q, NG, lp;  // lp = log2 P
    bool vec;  // groups of 4 elements are aligned for one load: Q, N, P multiples of 4,
               // every operand 16-byte aligned
    __host__ __device__ int nc() const { return L / Q; }
    __host__ __device__ int hg() const { return H / NG; }
    __host__ __device__ int ldn() const { return NG * N; }
    __host__ __device__ int HP() const { return H * P; }
};

// tile pair (ti, tj), tj <= ti, of a causal grid, in row order
__device__ __forceinline__ void tile_pair(int x, int& ti, int& tj) {
    ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
    tj = x - ti * (ti + 1) / 2;
}

// cum (the inclusive cumsum of log_a in each chunk), e^cum and e^{T - cum}, T
// the chunk's last cum: one warp a (b, c, h), segments per lane then a warp scan
__global__ void __launch_bounds__(256)
ssd_bwd_prep_kernel(const float* __restrict__ log_a, float* __restrict__ cum,
                    float* __restrict__ ecum, float* __restrict__ erev, Dims d) {
    const long long wid = (long long)blockIdx.x * 8 + threadIdx.x / 32;
    if (wid >= (long long)d.Bt * d.nc() * d.H) return;  // whole warps
    const int lane = threadIdx.x & 31, H = d.H, Q = d.Q;
    const int h = (int)(wid % H);
    const long long row0 = wid / H * Q;
    const int seg = (Q + 31) / 32, lo = min(lane * seg, Q), hi = min(lo + seg, Q);
    float run = 0.f;
    for (int j = lo; j < hi; ++j) run += log_a[(row0 + j) * H + h];
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
    }
    float c = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) c = 0.f;
    for (int j = lo; j < hi; ++j) {
        c += log_a[(row0 + j) * H + h];
        cum[(row0 + j) * H + h] = c;
        ecum[(row0 + j) * H + h] = expf(c);
    }
    const float T = __shfl_sync(FULL, c, (Q - 1) / seg);  // the lane that wrote cum[Q - 1]
    for (int j = lo; j < hi; ++j) erev[(row0 + j) * H + h] = expf(T - cum[(row0 + j) * H + h]);
}

// Gm = C B^T of (b, c, g), tile (ti, tj): grid (causal pairs, nc, Bt NG)
template <typename T>
__global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
ssd_bwd_gram_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ Gm,
                    Dims d) {
    __shared__ __align__(16) Tiles s;
    int ti, tj;
    tile_pair(blockIdx.x, ti, tj);
    const int c = blockIdx.y, b = blockIdx.z / d.NG, grp = blockIdx.z % d.NG;
    const int Q = d.Q, ldn = d.ldn(), i0 = ti * BM, j0 = tj * BN;
    const long long row0 = (long long)b * d.L + (long long)c * Q;
    const T* Cc = Cm + row0 * ldn + grp * d.N;
    const T* Bc = Bm + row0 * ldn + grp * d.N;
    const bool vec = d.vec;
    const auto la = [&](int m, int k, int n, float (&v)[4]) {
        const int i = i0 + m;
        ld4(Cc + (long long)i * ldn + k, i < Q ? n : 0, vec, v);
    };
    const auto lb = [&](int k, int n, int cnt, float (&v)[4]) {
        const int j = j0 + n;
        ld4(Bc + (long long)j * ldn + k, j < Q ? cnt : 0, vec, v);
    };
    constexpr bool EX = Exact<T>::value;
    Acc acc = {};
    gemm_seg<EX, EX, false, true>(acc, s, la, lb, 0, d.N);
    float* Gt = Gm + (((long long)b * d.nc() + c) * d.NG + grp) * Q * Q;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = i0 + frag_row(i, q), col = j0 + frag_col(j, q);
                if (r < Q && col < Q) Gt[(long long)r * Q + col] = acc[i][j][q];
            }
}

// The chunk-local states of (b, c, h), tile (n, p): which 0, Σ_j e^{T-cum_j}
// B_j xdt_j^T into Sst; which 1, Σ_i e^{cum_i} C_i dy_i^T into Dst.  The
// chunk's decays and dt staged in shared memory [2][Q].  Grid (N tiles x P
// tiles, 2 nc, Bt H).
template <typename T>
__global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
ssd_bwd_state_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ dt, const T* __restrict__ dy,
                     const float* __restrict__ ecum, const float* __restrict__ erev,
                     float* __restrict__ Sst, float* __restrict__ Dst, Dims d) {
    __shared__ __align__(16) Tiles s;
    extern __shared__ float aux[];
    const int npt = (d.P + BN - 1) / BN, nt = blockIdx.x / npt, pt = blockIdx.x % npt;
    const int c = blockIdx.y >> 1, which = blockIdx.y & 1;
    const int b = blockIdx.z / d.H, h = blockIdx.z % d.H;
    const int H = d.H, P = d.P, N = d.N, Q = d.Q, ldn = d.ldn(), HP = d.HP();
    const int grp = h / d.hg(), n0 = nt * BM, p0 = pt * BN;
    const long long row0 = (long long)b * d.L + (long long)c * Q;
    float* e_s = aux;       // [Q] e^{T - cum} (which 0) or e^cum (which 1)
    float* dt_s = aux + Q;  // [Q]
    for (int q = threadIdx.x; q < Q; q += NTHR) {
        const long long k = (row0 + q) * H + h;
        e_s[q] = which ? ecum[k] : erev[k];
        dt_s[q] = dt[k];
    }
    __syncthreads();
    constexpr bool EX = Exact<T>::value;
    Acc acc = {};
    const bool vec = d.vec;
    // A (n..n+3, position) = B or C, scaled by the position's decay
    const T* BC = (which ? Cm : Bm) + row0 * ldn + grp * N;
    const auto la = [&](int m, int j, int, float (&v)[4]) {
        const int n = n0 + m;
        ld4(BC + (long long)j * ldn + n, min(4, N - n), vec, v);
        for (int u = 0; u < 4; ++u) v[u] *= e_s[j];
    };
    if (which == 0) {
        const auto lb = [&](int j, int nn, int, float (&v)[4]) {
            const int p = p0 + nn;
            ld4(x + (row0 + j) * HP + h * P + p, min(4, P - p), vec, v);
            for (int u = 0; u < 4; ++u) v[u] *= dt_s[j];
        };
        gemm_seg<false, false, true, false>(acc, s, la, lb, 0, Q);
    } else {
        const auto lb = [&](int i, int nn, int, float (&v)[4]) {
            const int p = p0 + nn;
            ld4(dy + (row0 + i) * HP + h * P + p, min(4, P - p), vec, v);
        };
        gemm_seg<false, EX, true, false>(acc, s, la, lb, 0, Q);
    }
    float* out = (which ? Dst : Sst) + (((long long)b * d.nc() + c) * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int n = n0 + frag_row(i, q), p = p0 + frag_col(j, q);
                if (n < N && p < P) out[(long long)n * P + p] = acc[i][j][q];
            }
}

// The walks over the chunks of (b, h), in place, an element (n, p) a thread and
// 256 a block: forward, Sst's chunk-local states become the states entering
// each chunk; reverse, Dst's become dS' leaving each chunk (0 after the last),
// and spart[b, c, h, eb] = e^{T_c} <S_c, dS'_c> over the block's elements, its
// warps' sums added in a fixed order.  Each walk reads a chunk ahead.  Grid
// (N P / 256, Bt H); shared memory e^{T_c} [nc] and the warps' sums [nc][8].
__global__ void __launch_bounds__(256)
ssd_bwd_chunk_scan_kernel(const float* __restrict__ cum, float* __restrict__ Sst,
                          float* __restrict__ Dst, float* __restrict__ spart, Dims d) {
    extern __shared__ float sm[];
    const int nc = d.nc(), H = d.H, NP = d.N * d.P, neb = gridDim.x, eb = blockIdx.x;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* eT = sm;
    float* part = sm + nc;
    for (int c = tid; c < nc; c += 256)
        eT[c] = expf(cum[((long long)b * d.L + (long long)c * d.Q + d.Q - 1) * H + h]);
    __syncthreads();
    const int e = eb * 256 + tid;
    const bool ok = e < NP;
    const long long base = ((long long)b * nc * H + h) * NP + e, cs = (long long)H * NP;
    if (ok) {
        float S = 0.f, next = Sst[base];
        for (int c = 0; c < nc; ++c) {
            const float loc = next;
            if (c + 1 < nc) next = Sst[base + (c + 1) * cs];
            Sst[base + c * cs] = S;
            S = eT[c] * S + loc;
        }
    }
    float dS = 0.f, next = ok ? Dst[base + (nc - 1) * cs] : 0.f;
    for (int c = nc - 1; c >= 0; --c) {
        float prod = 0.f;
        if (ok) {
            const float loc = next;
            if (c > 0) next = Dst[base + (c - 1) * cs];
            Dst[base + c * cs] = dS;
            prod = Sst[base + c * cs] * dS;
            dS = eT[c] * dS + loc;
        }
        prod = warp_sum(prod);
        if (lane == 0) part[c * 8 + warp] = prod;
    }
    __syncthreads();
    for (int c = tid; c < nc; c += 256) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += part[c * 8 + w];
        spart[(((long long)b * nc + c) * H + h) * neb + eb] = eT[c] * sum;
    }
}

// The chunk's cum, dt and e^cum (y) or e^{T - cum} (dxdt) of head h, staged
// in shared memory [3][Q]
__device__ __forceinline__ void stage_head(float* aux, const float* __restrict__ cum,
                                           const float* __restrict__ dt,
                                           const float* __restrict__ e, long long row0, int h,
                                           int H, int Q) {
    for (int q = threadIdx.x; q < Q; q += NTHR) {
        const long long k = (row0 + q) * H + h;
        aux[q] = cum[k];
        aux[Q + q] = dt[k];
        aux[2 * Q + q] = e[k];
    }
    __syncthreads();
}

// rpart[pt, row, h] = Σ_p dy·y over the P tile pt, y recomputed: the scores
// times xdt, then e^cum C S, all but the diagonal term Gm_ii dy_i·xdt_i, which
// xdt·dxdt holds too (upart leaves it out the same way): with strong decays the
// two are most of dy·y and xdt·dxdt, and their split-TF32 roundings would not
// cancel.  Grid (Q tiles x P tiles, nc, Bt H).
template <typename T>
__global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
ssd_bwd_y_kernel(const T* __restrict__ x, const T* __restrict__ Cm, const float* __restrict__ dt,
                 const T* __restrict__ dy, const float* __restrict__ cum,
                 const float* __restrict__ ecum, const float* __restrict__ Gm,
                 const float* __restrict__ Sst, float* __restrict__ rpart, Dims d) {
    __shared__ __align__(16) Tiles s;
    __shared__ float red[WARPS_N * BM];
    extern __shared__ float aux[];
    const int npt = (d.P + BN - 1) / BN, mt = blockIdx.x / npt, pt = blockIdx.x % npt;
    const int c = blockIdx.y, b = blockIdx.z / d.H, h = blockIdx.z % d.H;
    const int H = d.H, P = d.P, N = d.N, Q = d.Q, ldn = d.ldn(), HP = d.HP();
    const int grp = h / d.hg(), i0 = mt * BM, p0 = pt * BN;
    const long long row0 = (long long)b * d.L + (long long)c * Q;
    stage_head(aux, cum, dt, ecum, row0, h, H, Q);
    const float *cum_s = aux, *dt_s = aux + Q, *e_s = aux + 2 * Q;
    const float* Gc = Gm + (((long long)b * d.nc() + c) * d.NG + grp) * Q * Q;
    const T* Cc = Cm + row0 * ldn + grp * N;
    const float* Sc = Sst + (((long long)b * d.nc() + c) * H + h) * N * P;
    Acc acc = {};
    const bool vec = d.vec;
    const auto la = [&](int m, int j, int n, float (&v)[4]) {  // the scores of row i
        const int i = i0 + m, cnt = i < Q ? n : 0;
        ld4(Gc + (long long)i * Q + j, cnt, vec, v);
        for (int u = 0; u < 4; ++u)
            v[u] = (u < cnt && j + u < i) ? v[u] * __expf(cum_s[i] - cum_s[j + u]) : 0.f;
    };
    const auto lb = [&](int j, int n, int, float (&v)[4]) {
        const int p = p0 + n;
        ld4(x + (row0 + j) * HP + h * P + p, min(4, P - p), vec, v);
        for (int u = 0; u < 4; ++u) v[u] *= dt_s[j];
    };
    gemm_seg<false, false, false, false>(acc, s, la, lb, 0, min(Q, i0 + BM));
    const auto la2 = [&](int m, int n, int cnt, float (&v)[4]) {
        const int i = i0 + m;
        ld4(Cc + (long long)i * ldn + n, i < Q ? cnt : 0, vec, v);
        for (int u = 0; u < 4; ++u) v[u] *= i < Q ? e_s[i] : 0.f;
    };
    const auto lb2 = [&](int n, int nn, int, float (&v)[4]) {
        const int p = p0 + nn;
        ld4(Sc + (long long)n * P + p, min(4, P - p), vec, v);
    };
    gemm_seg<false, false, false, false>(acc, s, la2, lb2, 0, N);
    row_dot(acc, [&](int r, int col) {
        const int i = i0 + r, p = p0 + col;
        return (i < Q && p < P) ? to_f(dy[(row0 + i) * HP + h * P + p]) : 0.f;
    }, red);
    const int r = threadIdx.x;
    if (r < BM && i0 + r < Q)
        rpart[((long long)pt * d.Bt * d.L + row0 + i0 + r) * H + h] = red_sum(red, r);
}

// dxdt of (b, c, h), rows j, P tile pt: first e^{T - cum_j} dS'^T B_j, whose
// x-dot goes to vpart; then the scores' transpose times dy below the diagonal
// (x-dot: upart), then the diagonal Gm_jj dy_j in f32.  dx = dt dxdt in x's
// dtype, dpart = the x-dot of the whole.  Grid (Q tiles x P tiles, nc, Bt H).
template <typename T>
__global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
ssd_bwd_dxdt_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                    const float* __restrict__ dt, const T* __restrict__ dy,
                    const float* __restrict__ cum, const float* __restrict__ erev,
                    const float* __restrict__ Gm, const float* __restrict__ Dst,
                    T* __restrict__ dx, float* __restrict__ vpart, float* __restrict__ upart,
                    float* __restrict__ dpart, Dims d) {
    __shared__ __align__(16) Tiles s;
    __shared__ float red[WARPS_N * BM];
    extern __shared__ float aux[];
    const int npt = (d.P + BN - 1) / BN, mt = blockIdx.x / npt, pt = blockIdx.x % npt;
    const int c = blockIdx.y, b = blockIdx.z / d.H, h = blockIdx.z % d.H;
    const int H = d.H, P = d.P, N = d.N, Q = d.Q, ldn = d.ldn(), HP = d.HP();
    const int grp = h / d.hg(), j0 = mt * BM, p0 = pt * BN;
    const long long row0 = (long long)b * d.L + (long long)c * Q;
    stage_head(aux, cum, dt, erev, row0, h, H, Q);
    const float *cum_s = aux, *dt_s = aux + Q, *e_s = aux + 2 * Q;
    const float* Gc = Gm + (((long long)b * d.nc() + c) * d.NG + grp) * Q * Q;
    const T* Bc = Bm + row0 * ldn + grp * N;
    const float* Dc = Dst + (((long long)b * d.nc() + c) * H + h) * N * P;
    constexpr bool EX = Exact<T>::value;
    Acc acc = {};
    const bool vec = d.vec;
    const auto la = [&](int m, int n, int cnt, float (&v)[4]) {
        const int j = j0 + m;
        ld4(Bc + (long long)j * ldn + n, j < Q ? cnt : 0, vec, v);
        for (int u = 0; u < 4; ++u) v[u] *= j < Q ? e_s[j] : 0.f;
    };
    const auto lb = [&](int n, int nn, int, float (&v)[4]) {
        const int p = p0 + nn;
        ld4(Dc + (long long)n * P + p, min(4, P - p), vec, v);
    };
    gemm_seg<false, false, false, false>(acc, s, la, lb, 0, N);
    const auto fx = [&](int r, int col) {
        const int j = j0 + r, p = p0 + col;
        return (j < Q && p < P) ? to_f(x[(row0 + j) * HP + h * P + p]) : 0.f;
    };
    const int r = threadIdx.x;
    const long long out = ((long long)pt * d.Bt * d.L + row0 + j0 + r) * H + h;
    row_dot(acc, fx, red);
    if (r < BM && j0 + r < Q) vpart[out] = red_sum(red, r);
    const auto la2 = [&](int m, int i, int, float (&v)[4]) {  // the scores of column j, i > j
        const int j = j0 + m, n = min(4, Q - j);
        ld4(Gc + (long long)i * Q + j, n, vec, v);
        for (int u = 0; u < 4; ++u)
            v[u] = (u < n && j + u < i) ? v[u] * __expf(cum_s[i] - cum_s[j + u]) : 0.f;
    };
    const auto lb2 = [&](int i, int nn, int, float (&v)[4]) {
        const int p = p0 + nn;
        ld4(dy + (row0 + i) * HP + h * P + p, min(4, P - p), vec, v);
    };
    gemm_seg<false, EX, true, false>(acc, s, la2, lb2, j0 + 1, Q);
    row_dot(acc, fx, red);  // x·dxdt but the diagonal: dy_j·y_j leaves it out too (y kernel)
    if (r < BM && j0 + r < Q) upart[out] = red_sum(red, r);
    // the diagonal, Gm_jj dy_j, in f32
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int jj = j0 + frag_row(i, q), p = p0 + frag_col(j, q);
                if (jj < Q && p < P)
                    acc[i][j][q] += Gc[(long long)jj * Q + jj] * to_f(dy[(row0 + jj) * HP + h * P + p]);
            }
    row_dot(acc, fx, red);
    if (r < BM && j0 + r < Q) dpart[out] = red_sum(red, r);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int jj = j0 + frag_row(i, q), p = p0 + frag_col(j, q);
                if (jj < Q && p < P) put(dx + (row0 + jj) * HP + h * P + p, dt_s[jj] * acc[i][j][q]);
            }
}

// dGm of (b, c, g), tile (ti, tj) = Σ over the group's heads of Lm ∘ (dy xdt^T),
// zero above the diagonal: one contraction over the heads' stacked (head, p)
// columns, in slabs that never straddle a head (a P under BK pads each head's
// slab with zeros), each head's product scaled by its decays into the sum at
// its last slab, the next slab fetched while one multiplies.  Shared memory:
// each head's cum of the tile's rows and columns and dt of its columns
// [3][hg][64].  Grid (causal pairs, nc, Bt NG).
template <typename T>
__global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
ssd_bwd_dgram_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const T* __restrict__ dy, const float* __restrict__ cum,
                     float* __restrict__ dGm, Dims d) {
    __shared__ __align__(16) Tiles s;
    extern __shared__ float hs[];
    int ti, tj;
    tile_pair(blockIdx.x, ti, tj);
    const int c = blockIdx.y, b = blockIdx.z / d.NG, grp = blockIdx.z % d.NG;
    const int H = d.H, P = d.P, Q = d.Q, HP = d.HP(), hg = d.hg();
    const int i0 = ti * BM, j0 = tj * BN, h0 = grp * hg;
    const long long row0 = (long long)b * d.L + (long long)c * Q;
    float* ci_s = hs;             // [hg][64] cum of the tile's rows
    float* cj_s = hs + hg * BM;   // [hg][64] cum of its columns
    float* dtj_s = cj_s + hg * BM;  // [hg][64] dt of its columns
    for (int e = threadIdx.x; e < hg * BM; e += NTHR) {
        const int hh = e / BM, k = e % BM, i = i0 + k, j = j0 + k;
        const long long h = h0 + hh;
        ci_s[e] = i < Q ? cum[(row0 + i) * H + h] : 0.f;
        cj_s[e] = j < Q ? cum[(row0 + j) * H + h] : 0.f;
        dtj_s[e] = j < Q ? dt[(row0 + j) * H + h] : 0.f;
    }
    const int lk = d.lp > LOG_BK ? d.lp : LOG_BK, sph = (1 << lk) / BK;  // a head's columns, slabs
    const int kend = hg << lk;
    const bool vec = d.vec;
    const auto la = [&](int m, int k, int n, float (&v)[4]) {
        const int i = i0 + m, hh = k >> lk, p = k & ((1 << lk) - 1);
        ld4(dy + (row0 + i) * HP + (long long)(h0 + hh) * P + p, (i < Q && p < P) ? min(n, P - p) : 0,
            vec, v);
    };
    const auto lb = [&](int k, int n, int cnt, float (&v)[4]) {
        const int j = j0 + n, hh = k >> lk, p = k & ((1 << lk) - 1);
        ld4(x + (row0 + j) * HP + (long long)(h0 + hh) * P + p,
            (j < Q && p < P) ? min(cnt, P - p) : 0, vec, v);
        for (int u = 0; u < 4; ++u) v[u] *= dtj_s[hh * BM + n];
    };
    constexpr bool EX = Exact<T>::value;
    Acc sum = {}, w = {};
    float ra[FE], rb[FE];
    __syncthreads();
    fetch<false, true>(ra, rb, la, lb, 0, kend);
    for (int k0 = 0, sl = 0; k0 < kend; k0 += BK, ++sl) {
        __syncthreads();  // the slab before is no longer read
        stash<false, true>(s, ra, rb);
        __syncthreads();
        if (k0 + BK < kend) fetch<false, true>(ra, rb, la, lb, k0 + BK, kend);
        slab_mma<EX, false, false, true>(w, s);
        if (sl % sph == sph - 1) {  // the head's last slab: its decays, into the sum
            const float* ci = ci_s + (sl / sph) * BM;
            const float* cj = cj_s + (sl / sph) * BM;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int r = frag_row(i, q), col = frag_col(j, q);
                        if (i0 + r < Q && j0 + col <= i0 + r)
                            sum[i][j][q] += w[i][j][q] * __expf(ci[r] - cj[col]);
                        w[i][j][q] = 0.f;
                    }
        }
    }
    float* Dt = dGm + (((long long)b * d.nc() + c) * d.NG + grp) * Q * Q;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = i0 + frag_row(i, q), col = j0 + frag_col(j, q);
                if (r < Q && col < Q) Dt[(long long)r * Q + col] = sum[i][j][q];
            }
}

// dC (IS_DB false: rows i, dGm B over j <= i, then e^cum dy S^T over the
// group's stacked (head, p)) or dB (rows j: dGm^T C over i >= j, then
// e^{T-cum} xdt dS'^T), tile (rows, n).  Grid (Q tiles x N tiles, nc, Bt NG).
template <typename T, bool IS_DB>
__global__ void __launch_bounds__(NTHR, MIN_BLOCKS)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ dt, const T* __restrict__ dy,
                   const float* __restrict__ ecum, const float* __restrict__ erev,
                   const float* __restrict__ dGm, const float* __restrict__ St,
                   T* __restrict__ out, Dims d) {
    __shared__ __align__(16) Tiles s;
    extern __shared__ float sc_s[];  // [hg][64]: e^cum (dC) or e^{T-cum} dt (dB) of each row
    const int nnt = (d.N + BN - 1) / BN, mt = blockIdx.x / nnt, nt = blockIdx.x % nnt;
    const int c = blockIdx.y, b = blockIdx.z / d.NG, grp = blockIdx.z % d.NG;
    const int H = d.H, P = d.P, N = d.N, Q = d.Q, ldn = d.ldn(), HP = d.HP(), lp = d.lp;
    const int r0 = mt * BM, n0 = nt * BN;
    const long long row0 = (long long)b * d.L + (long long)c * Q;
    const long long h0 = (long long)grp * d.hg();  // the group's first head
    const float* Gc = dGm + (((long long)b * d.nc() + c) * d.NG + grp) * Q * Q;
    const T* other = (IS_DB ? Cm : Bm) + row0 * ldn + grp * N;  // C for dB, B for dC
    // (h0 + hh, n, p) of the chunk's states: k = hh P + p
    const float* Sc = St + (((long long)b * d.nc() + c) * H + h0) * N * P;
    for (int e = threadIdx.x; e < d.hg() * BM; e += NTHR) {
        const int hh = e / BM, r = r0 + e % BM;
        const long long k = (row0 + r) * H + h0 + hh;
        sc_s[e] = r < Q ? (IS_DB ? erev[k] * dt[k] : ecum[k]) : 0.f;
    }
    __syncthreads();
    constexpr bool EX = Exact<T>::value;
    Acc acc = {};
    const bool vec = d.vec;
    const auto lb = [&](int k, int n, int, float (&v)[4]) {
        const int nn = n0 + n;
        ld4(other + (long long)k * ldn + nn, min(4, N - nn), vec, v);
    };
    const auto lb2 = [&](int k, int n, int cnt, float (&v)[4]) {
        const int nn = n0 + n;
        ld4(Sc + ((long long)(k >> lp) * N + nn) * P + (k & (P - 1)), nn < N ? cnt : 0, vec, v);
    };
    // the stacked operand of row r0 + m: (head, p) columns k..k+3 of one head
    const T* src = (IS_DB ? x : dy) + row0 * HP + h0 * P;
    const auto la2 = [&](int m, int k, int n, float (&v)[4]) {
        const int r = r0 + m;
        ld4(src + (long long)r * HP + k, r < Q ? n : 0, vec, v);
        for (int u = 0; u < 4; ++u) v[u] *= sc_s[(k >> lp) * BM + m];
    };
    if constexpr (!IS_DB) {
        const auto la = [&](int m, int j, int n, float (&v)[4]) {
            const int i = r0 + m;
            ld4(Gc + (long long)i * Q + j, i < Q ? n : 0, vec, v);
        };
        gemm_seg<false, EX, false, false>(acc, s, la, lb, 0, min(Q, r0 + BM));
    } else {
        const auto la = [&](int m, int i, int, float (&v)[4]) {
            const int j = r0 + m;
            ld4(Gc + (long long)i * Q + j, min(4, Q - j), vec, v);
        };
        gemm_seg<false, EX, true, false>(acc, s, la, lb, r0, Q);
    }
    gemm_seg<false, false, false, true>(acc, s, la2, lb2, 0, d.hg() * P);
    T* o = out + row0 * ldn + grp * N;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = r0 + frag_row(i, q), n = n0 + frag_col(j, q);
                if (r < Q && n < N) put(o + (long long)r * ldn + n, acc[i][j][q]);
            }
}

// ddt = Σ_pt dpart; with log_a's gradient wanted, dcum = Σ_pt rpart - dt Σ_pt
// upart (both without the diagonal term), plus dT = Σ_eb spart + Σ_j dt_j Σ_pt vpart_j at Q - 1, and dlog_a its
// reverse cumsum: one warp a (b, c, h), segments per lane from the chunk's end.
__global__ void __launch_bounds__(256)
ssd_bwd_final_kernel(const float* __restrict__ dt, const float* __restrict__ rpart,
                     const float* __restrict__ vpart, const float* __restrict__ upart,
                     const float* __restrict__ dpart,
                     const float* __restrict__ spart, float* __restrict__ dlog_a,
                     float* __restrict__ ddt, int with_log_a, Dims d) {
    const long long wid = (long long)blockIdx.x * 8 + threadIdx.x / 32;
    if (wid >= (long long)d.Bt * d.nc() * d.H) return;  // whole warps
    const int lane = threadIdx.x & 31, H = d.H, Q = d.Q;
    const int npt = (d.P + BN - 1) / BN, h = (int)(wid % H);
    const long long row0 = wid / H * Q, plane = (long long)d.Bt * d.L * H;
    float V = 0.f;
    for (int k = lane; k < Q; k += 32) {
        const long long idx = (row0 + k) * H + h;
        float dd = 0.f, v = 0.f;
        for (int pt = 0; pt < npt; ++pt) {
            dd += dpart[pt * plane + idx];
            v += vpart[pt * plane + idx];
        }
        ddt[idx] = dd;
        V += dt[idx] * v;
    }
    if (!with_log_a) return;
    const int neb = (d.N * d.P + 255) / 256;
    float sd = 0.f;
    for (int k = lane; k < neb; k += 32) sd += spart[wid * neb + k];
    const float dT = warp_sum(sd) + warp_sum(V);
    const auto dcum = [&](int k) {
        const long long idx = (row0 + k) * H + h;
        float rr = 0.f, uu = 0.f;
        for (int pt = 0; pt < npt; ++pt) {
            rr += rpart[pt * plane + idx];
            uu += upart[pt * plane + idx];
        }
        const float v = rr - dt[idx] * uu;
        return k == Q - 1 ? v + dT : v;
    };
    const int seg = (Q + 31) / 32, hi = max(Q - lane * seg, 0), lo = max(hi - seg, 0);
    float run = 0.f;
    for (int k = hi - 1; k >= lo; --k) run += dcum(k);
    float incl = run;  // lanes before this one hold later positions
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
    }
    float acc = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) acc = 0.f;
    for (int k = hi - 1; k >= lo; --k) {
        acc += dcum(k);
        dlog_a[(row0 + k) * H + h] = acc;
    }
}

// Shared memory of the launches that stage a head's chunk or walk the chunks
__host__ __device__ constexpr int aux_bytes(int Q) { return 3 * Q * 4; }
__host__ __device__ constexpr int walk_bytes(int nc) { return 9 * nc * 4; }
__host__ __device__ constexpr int heads_bytes(int hg) { return 3 * hg * BM * 4; }

// let kernel k take dynamic shared memory up to the block's limit, once
template <typename K>
cudaError_t allow_smem(K k) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_MAX - (int)a.sharedSizeBytes);
}

#define LAUNCHED()                                  \
    do {                                            \
        const cudaError_t e_ = cudaGetLastError();  \
        if (e_ != cudaSuccess) return (int)e_;      \
    } while (0)

template <typename T>
int launch(void* const* p, Dims d, int needs, cudaStream_t st) {
    const T* x = static_cast<const T*>(p[0]);
    const float* log_a = static_cast<const float*>(p[1]);
    const T* Bm = static_cast<const T*>(p[2]);
    const T* Cm = static_cast<const T*>(p[3]);
    const float* dt = static_cast<const float*>(p[4]);
    const T* dy = static_cast<const T*>(p[5]);
    T* dx = static_cast<T*>(p[6]);
    T* dB = static_cast<T*>(p[7]);
    T* dC = static_cast<T*>(p[8]);
    float* dlog_a = static_cast<float*>(p[9]);
    float* ddt = static_cast<float*>(p[10]);
    float* cum = static_cast<float*>(p[11]);
    float* ecum = static_cast<float*>(p[12]);
    float* erev = static_cast<float*>(p[13]);
    float* Gm = static_cast<float*>(p[14]);
    float* dGm = static_cast<float*>(p[15]);
    float* Sst = static_cast<float*>(p[16]);
    float* Dst = static_cast<float*>(p[17]);
    float* spart = static_cast<float*>(p[18]);
    float* rpart = static_cast<float*>(p[19]);
    float* vpart = static_cast<float*>(p[20]);
    float* upart = static_cast<float*>(p[21]);
    float* dpart = static_cast<float*>(p[22]);
    const bool gx = needs & 1, gla = needs & 2, gB = needs & 4, gC = needs & 8, gdt = needs & 16;
    const bool per_pos = gx || gla || gdt;  // dxdt and what derives from it
    const int nc = d.nc(), nmt = (d.Q + BM - 1) / BM, npt = (d.P + BN - 1) / BN;
    const int nnt = (d.N + BN - 1) / BN, pairs = nmt * (nmt + 1) / 2;
    const int warps = (int)(((long long)d.Bt * nc * d.H + 7) / 8);
    if (aux_bytes(d.Q) + (int)sizeof(Tiles) + WARPS_N * BM * 4 > SMEM_MAX ||
        heads_bytes(d.hg()) + (int)sizeof(Tiles) > SMEM_MAX || walk_bytes(nc) > SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    static bool smem_allowed = false;
    if (!smem_allowed) {
        for (cudaError_t err : {allow_smem(ssd_bwd_y_kernel<T>), allow_smem(ssd_bwd_dxdt_kernel<T>),
                                allow_smem(ssd_bwd_dgram_kernel<T>), allow_smem(ssd_bwd_state_kernel<T>),
                                allow_smem(ssd_bwd_dbc_kernel<T, false>),
                                allow_smem(ssd_bwd_dbc_kernel<T, true>),
                                allow_smem(ssd_bwd_chunk_scan_kernel)})
            if (err != cudaSuccess) return (int)err;
        smem_allowed = true;
    }
    ssd_bwd_prep_kernel<<<warps, 256, 0, st>>>(log_a, cum, ecum, erev, d);
    LAUNCHED();
    if (per_pos) {
        ssd_bwd_gram_kernel<T><<<dim3(pairs, nc, d.Bt * d.NG), NTHR, 0, st>>>(Bm, Cm, Gm, d);
        LAUNCHED();
    }
    ssd_bwd_state_kernel<T><<<dim3(nnt * npt, 2 * nc, d.Bt * d.H), NTHR, aux_bytes(d.Q), st>>>(
        x, Bm, Cm, dt, dy, ecum, erev, Sst, Dst, d);
    LAUNCHED();
    ssd_bwd_chunk_scan_kernel<<<dim3((d.N * d.P + 255) / 256, d.Bt * d.H), 256, walk_bytes(nc),
                                st>>>(cum, Sst, Dst, spart, d);
    LAUNCHED();
    if (gla) {
        ssd_bwd_y_kernel<T><<<dim3(nmt * npt, nc, d.Bt * d.H), NTHR, aux_bytes(d.Q), st>>>(
            x, Cm, dt, dy, cum, ecum, Gm, Sst, rpart, d);
        LAUNCHED();
    }
    if (per_pos) {
        ssd_bwd_dxdt_kernel<T><<<dim3(nmt * npt, nc, d.Bt * d.H), NTHR, aux_bytes(d.Q), st>>>(
            x, Bm, dt, dy, cum, erev, Gm, Dst, dx, vpart, upart, dpart, d);
        LAUNCHED();
    }
    if (gB || gC) {
        ssd_bwd_dgram_kernel<T><<<dim3(pairs, nc, d.Bt * d.NG), NTHR, heads_bytes(d.hg()), st>>>(
            x, dt, dy, cum, dGm, d);
        LAUNCHED();
    }
    if (gC) {
        ssd_bwd_dbc_kernel<T, false><<<dim3(nmt * nnt, nc, d.Bt * d.NG), NTHR, heads_bytes(d.hg()), st>>>(
            x, Bm, Cm, dt, dy, ecum, erev, dGm, Sst, dC, d);
        LAUNCHED();
    }
    if (gB) {
        ssd_bwd_dbc_kernel<T, true><<<dim3(nmt * nnt, nc, d.Bt * d.NG), NTHR, heads_bytes(d.hg()), st>>>(
            x, Bm, Cm, dt, dy, ecum, erev, dGm, Dst, dB, d);
        LAUNCHED();
    }
    if (gla || gdt) {
        ssd_bwd_final_kernel<<<warps, 256, 0, st>>>(dt, rpart, vpart, upart, dpart, spart, dlog_a, ddt,
                                                    gla ? 1 : 0, d);
        LAUNCHED();
    }
    return 0;
}

}  // namespace

// bufs: x, log_a (f32), B, C, dt (f32), dy, then the outputs dx, dB, dC, dlog_a,
// ddt (dx, dB, dC in x's dtype; log_a's and dt's in f32), then the f32
// workspaces cum, ecum, erev [Bt, L, H], Gm, dGm [Bt, L / Q, NG, Q, Q], Sst, Dst
// [Bt, L / Q, H, N, P], spart [Bt, L / Q, H, ceil(N P / 256)], rpart, vpart, upart, dpart [ceil(P / 64),
// Bt, L, H].  x, dy [Bt, L, H, P]; B, C [Bt, L, NG, N]; L a multiple of Q, H of
// NG, P a power of two.  needs: bit 0 x, 1 log_a, 2 B, 3 C, 4 dt (an output not
// asked for is not written and may be null).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int ssd_scan_bwd(void* const* bufs, int Bt, int L, int H, int P, int N, int Q,
                            int NG, int needs, int dtype, void* stream) {
    if (Bt <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || NG <= 0 || L % Q ||
        H % NG || (P & (P - 1)))
        return (int)cudaErrorInvalidValue;
    if ((long long)Bt * H > 65535 || 2LL * (L / Q) > 65535)
        return (int)cudaErrorInvalidConfiguration;
    Dims d{Bt, L, H, P, N, Q, NG, 0, Q % 4 == 0 && N % 4 == 0 && P % 4 == 0};
    while ((1 << d.lp) < P) ++d.lp;
    for (int k : {0, 2, 3, 5, 14, 15, 16, 17})  // x, B, C, dy and the f32 operands read by 4
        d.vec = d.vec && reinterpret_cast<uintptr_t>(bufs[k]) % 16 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(bufs, d, needs, s);
    if (dtype == 1) return launch<__nv_bfloat16>(bufs, d, needs, s);
    return (int)cudaErrorInvalidValue;
}
