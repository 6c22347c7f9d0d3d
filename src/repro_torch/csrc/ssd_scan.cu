// Mamba2 SSD chunked scan for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssd_scan/kernel.py::_ssd_kernel (ssd_scan_pallas).
//
// What it computes.  x [Bt, L, H, P], log_a and dt [Bt, L, H] (f32), B and C
// [Bt, L, NG, N] (NG groups; head h reads group h / (H / NG); NG = 1 is the
// JAX layout's [Bt, L, N], shared by all heads), all contiguous, give for
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
// once per (b, chunk, group), as B and C are shared by a group's heads, and per
// (b, h, chunk) the causal scores times xdt and the two products with the
// state, Q(Q+1)P + 4QNP (12.6 MFLOP at Q = 256, N = 128, P = 64), for some
// 33 KB of input: hundreds of operations per byte, far above the card's
// ridge.  xdt and the decays are f32, so an f32-accurate product is needed:
// on the CUDA cores (67 TFLOP/s) or as split TF32 on the tensor cores (three
// products at 495 TFLOP/s; two for C S where C is bf16, exact in TF32), the
// faster of the two.
//
// Design: two launches a call.
//
//   1. ssd_scan_cb_kernel computes G[b, c, g] = C_c B_c^T, f32 [Q, Q], once per
//      (batch row, chunk, group) into a workspace [Bt, nc, NG, Q, Q] that the
//      wrapper allocates: one block of 4 warps per causal 64 x 64 tile (j tile <=
//      i tile; the others are never written or read), the contraction over N
//      in slabs of 32.  bf16 inputs go on mma.sync m16n8k16 (exact products,
//      f32 sums); f32 inputs on split TF32 (below).
//   2. ssd_scan_kernel: one block of 8 warps per (h, b) walks its chunks in
//      order with S [N, P] f32 in shared memory (the Pallas grid walks the
//      chunks in order and keeps S in VMEM scratch; blocks on the card run in
//      parallel and in no order, so the block loops over its chunks itself).
//      Per chunk it computes xdt and the cumsum, then per row tile of 64
//      positions i: acc = exp(cum_i) (C_tile S); for each tile of j <= i it
//      reads the G tile (the H / NG heads of a group of a batch row read the
//      same G, so it is served from L2) and adds scores xdt_tile to acc, the scores
//      G o exp(cum_i - cum_j) formed as their mma fragments are read (no pass
//      of their own, no barrier); then casts acc once and stores it.  After every
//      row tile has read the old S, the state update
//      S <- exp(total) S + (B o w)^T xdt, w = exp(total - cum), runs over the
//      B tiles.  Each warp owns a 16 x P/2 part of a 64 x P output tile and a
//      32 x P/2 part of a 128-row band of S (warps past the edges sit idle).
//
// Split TF32 (CUTLASS's 3xTF32): each f32 operand a is cut into hi, a rounded
// to TF32, and lo = a - hi, which the tensor cores truncate to TF32; a product
// is lo*hi + hi*lo + hi*hi on mma.sync m16n8k8, summed in f32: about 21 bits
// of each operand, as good as f32 at these shapes, where a single TF32 product
// is off by some 4e-4 of max|y|, past the tolerances
// (tests/test_torch_ssd_plan.py emulates both).  A bf16 C is exact in TF32
// (lo = 0), so C S takes two products in bf16.  Each product keeps its small
// terms in accumulators of their own where registers allow (two dependent
// chains a step, not one).
//
// Decays.  Below the diagonal tile, exp(cum_i - cum_j) is taken as
// exp(cum_i - cum_i0) exp(cum_i0 - cum_j), i0 the row tile's first position:
// 64 + 64 exponentials a tile instead of 64 x 64.  As log_a <= 0 (a decay)
// both factors are at most 1 and neither overflows; a log_a with positive
// entries is outside the kernel's contract.  On the diagonal tile each
// exp(cum_i - cum_j) is taken where j <= i, with __expf (ex2.approx, some 2e-7
// relative where a term matters).
//
// Staging.  Two rings of two buffers: the C tiles, then the B tiles, in x's
// dtype, and the G tiles (f32), each filled with 16-byte cp.async (zero past Q
// and N) one step ahead, so the next tile loads while the current one
// multiplies; one wait and one barrier a step.  The first C and G tiles of a
// chunk load while xdt and the cumsum are computed.  Where two buffers a ring
// do not fit (large N or P, see below), each ring has one (the instance with
// STAGES = 1, chosen from the shape): a tile's next copy starts once every warp
// is done with it, after a second barrier, and no longer overlaps the products.
// STAGES is a template parameter: read at run time it cost the two-buffer path
// some 4% (kernels/ssd_scan/compare.py).
//
// Shared memory: S [NK][XS], xdt [QP][XS], the G ring stages x [64][68] and
// cum, w [QP] in f32, the C / B ring stages x [64][NK + 8] in x's dtype, where
// NK is N rounded up to 16, QP is Q rounded up to 64 (the pads are zero) and
// XS is P + 8 (P + 16 at P = 8).  The strides put the fragment loads of every
// product on distinct banks: a row read along k at a stride of 4 (mod 32)
// words, along n at a stride of 8 (mod 32).  217,088 bytes in f32 and
// 182,272 in bf16 at the main path's shapes (two stages), so one block an SM.
//
// Hazard.  The Pallas kernel takes exp(cum_i - cum_j) over the whole block and
// drops the upper triangle with a where; there exp can overflow to inf.  Here
// the exponential is evaluated only for j <= i (a select, never a multiply by
// a mask).
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
// C interface: ssd_scan(...) launches both kernels on the given stream and
// returns cudaGetLastError() as an int (0 == launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int TILE = 64;         // rows of a row tile, a j tile, a C / B tile
constexpr int THREADS = 256;     // ssd_scan_kernel: 8 warps
constexpr int CB_THREADS = 128;  // ssd_scan_cb_kernel: 4 warps, 2 x 2 over a tile
constexpr int CB_BK = 32;        // contraction slab of ssd_scan_cb_kernel
constexpr int SCS = TILE + 4;    // row stride of a G tile
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// hi = v rounded to TF32 (to nearest, ties away from zero, as cvt.rna), lo =
// v - hi.  The tensor cores read the top 19 bits of a TF32 operand and ignore
// the low 13, so lo goes in as it is (truncated there): three integer and f32
// operations a value, where two cvt.rna would take the slower conversion pipe.
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- launch 1

template <typename T> struct CbSmem;
template <> struct CbSmem<float> { static constexpr int LD = CB_BK + 4; };  // 36 words
template <> struct CbSmem<__nv_bfloat16> { static constexpr int LD = CB_BK + 8; };  // 20 words

// The slab's products of a warp's 32 x 32 quarter of the G tile: rows of
// Cs are i, rows of Bs are j, both along k = n.
__device__ __forceinline__ void cb_products(const float (*Cs)[CbSmem<float>::LD],
                                            const float (*Bs)[CbSmem<float>::LD],
                                            float (&acc)[2][4][4], int wm, int wn) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < CB_BK; kk += 8) {
        uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = wm * 32 + i * 16 + g;
            const float av[4] = {Cs[r][kk + t], Cs[r + 8][kk + t], Cs[r][kk + t + 4],
                                 Cs[r + 8][kk + t + 4]};
#pragma unroll
            for (int q = 0; q < 4; ++q) split(av[q], ahi[i][q], alo[i][q]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = wn * 32 + j * 8 + g;
            split(Bs[c][kk + t], bhi[j][0], blo[j][0]);
            split(Bs[c][kk + t + 4], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {  // small terms first, then the large one
                mma_tf32(acc[i][j], alo[i], bhi[j]);
                mma_tf32(acc[i][j], ahi[i], blo[j]);
                mma_tf32(acc[i][j], ahi[i], bhi[j]);
            }
    }
}

using CbRowBf16 = __nv_bfloat16[CbSmem<__nv_bfloat16>::LD];
__device__ __forceinline__ void cb_products(const CbRowBf16* Cs, const CbRowBf16* Bs,
                                            float (&acc)[2][4][4], int wm, int wn) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < CB_BK; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = wm * 32 + i * 16 + g;
            a[i][0] = *reinterpret_cast<const uint32_t*>(&Cs[r][kk + 2 * t]);
            a[i][1] = *reinterpret_cast<const uint32_t*>(&Cs[r + 8][kk + 2 * t]);
            a[i][2] = *reinterpret_cast<const uint32_t*>(&Cs[r][kk + 2 * t + 8]);
            a[i][3] = *reinterpret_cast<const uint32_t*>(&Cs[r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = wn * 32 + j * 8 + g;
            b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 2 * t]);
            b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
}

// G[b, c, g, i, j] = sum_n C[b, c*Q + i, g, n] B[b, c*Q + j, g, n] for the causal
// tiles: grid (nt (nt + 1) / 2, nc, Bt NG), nt = ceil(Q / 64); block x is tile
// (ti, tj), tj <= ti, in row order; block z is (b, g).
template <typename T>
__global__ void __launch_bounds__(CB_THREADS)
ssd_scan_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ G,
                   int L, int N, int Q, int NG) {
    constexpr int LD = CbSmem<T>::LD;
    __shared__ __align__(16) T Cs[TILE][LD];
    __shared__ __align__(16) T Bs[TILE][LD];
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
    const int tj = blockIdx.x - ti * (ti + 1) / 2;
    const int c = blockIdx.y, b = (int)blockIdx.z / NG, grp = (int)blockIdx.z % NG, nc = L / Q;
    const int ldn = NG * N;  // a position's B (C) row: every group's
    const long long row0 = (long long)b * L + (long long)c * Q;
    const T* Cc = Cm + (row0 + ti * TILE) * ldn + grp * N;
    const T* Bc = Bm + (row0 + tj * TILE) * ldn + grp * N;
    const int ni = min(TILE, Q - ti * TILE), nj = min(TILE, Q - tj * TILE);
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

    float acc[2][4][4] = {};
    for (int k0 = 0; k0 < N; k0 += CB_BK) {
        __syncthreads();  // the previous slab is no longer read
#pragma unroll
        for (int q = 0; q < TILE * CB_BK / CB_THREADS; ++q) {
            const int e = threadIdx.x + q * CB_THREADS;
            const int r = e / CB_BK, k = e % CB_BK, n = k0 + k;
            Cs[r][k] = (r < ni && n < N) ? Cc[(long long)r * ldn + n] : T(0.0f);
            Bs[r][k] = (r < nj && n < N) ? Bc[(long long)r * ldn + n] : T(0.0f);
        }
        __syncthreads();
        cb_products(Cs, Bs, acc, wm, wn);
    }
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float* Gt = G + ((((long long)b * nc + c) * NG + grp) * Q + ti * TILE) * Q + tj * TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = wm * 32 + i * 16 + hh * 8 + g;
            if (r >= ni) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = wn * 32 + j * 8 + 2 * t;
                if (col < nj) Gt[(long long)r * Q + col] = acc[i][j][2 * hh];
                if (col + 1 < nj) Gt[(long long)r * Q + col + 1] = acc[i][j][2 * hh + 1];
            }
        }
}

// ---------------------------------------------------------------- launch 2

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !pred (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 2 consecutive f32 of a row, cast to T (bf16: round to nearest even, as torch's
// .to(bf16)) and stored with one 8- or 4-byte store
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int P> struct Dims {
    static constexpr int XS = P % 32 == 8 ? P + 16 : P + 8;  // row stride of S and xdt
    static constexpr int CG = P >= 16 ? P / 2 : 8;  // columns of a warp's part (2 groups)
    static constexpr int NT = CG / 8;               // its mma tiles of 8 columns
};

// acc[MT][NT] += A B over k_steps steps of 8, in split TF32.  load_a(i, k0, av)
// gives this lane's four values of m tile i's fragment of A at columns
// [k0, k0 + 8): (g, k0 + t), (g + 8, k0 + t), (g, k0 + t + 4), (g + 8, k0 + t + 4)
// with g = lane / 4, t = lane % 4, rows counted from 16 i.  A_EXACT: they are
// exact in TF32 (bf16), so their lo part is 0 and that product is skipped.  B is
// k rows by 8*NT columns n, (k, n) at B[k * ldb + n].  Tiles from mt_live and
// nt_live on are skipped (warp-uniform).
template <int MT, int NT, bool A_EXACT, typename LoadA>
__device__ __forceinline__ void products(float (&acc)[MT][NT][4], LoadA load_a,
                                         const float* B, int ldb, int k_steps, int mt_live,
                                         int nt_live) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    // the small terms in accumulators of their own where registers allow, so
    // the three products of a step are two dependent chains, not one
    constexpr bool SMALL = MT * NT <= 8;
    float small[SMALL ? MT : 1][SMALL ? NT : 1][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < k_steps; ++ks) {
        const int k0 = ks * 8;
        uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            if (i >= mt_live) continue;
            float av[4];
            load_a(i, k0, av);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if constexpr (A_EXACT) {
                    ahi[i][q] = __float_as_uint(av[q]);
                    alo[i][q] = 0u;
                } else {
                    split(av[q], ahi[i][q], alo[i][q]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            if (j >= nt_live) continue;
            split(B[(k0 + t) * ldb + j * 8 + g], bhi[j][0], blo[j][0]);
            split(B[(k0 + t + 4) * ldb + j * 8 + g], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                if (i >= mt_live || j >= nt_live) continue;
                // small terms first, then the large one
                float* lo_acc = acc[i][j];
                if constexpr (SMALL) lo_acc = small[i][j];
                if constexpr (!A_EXACT) mma_tf32(lo_acc, alo[i], bhi[j]);
                mma_tf32(lo_acc, ahi[i], blo[j]);
                mma_tf32(acc[i][j], ahi[i], bhi[j]);
            }
    }
    if constexpr (SMALL) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][j][q] += small[i][j][q];
    }
}

// Shared memory of one block, in bytes (kernel.py's smem_bytes mirrors it): S and
// xdt, `stages` G tiles and cum, w in f32, then `stages` C / B tiles in T.
__host__ __device__ constexpr int scan_smem_bytes(int XS, int N, int Q, int tsize,
                                                  int stages) {
    return 4 * (round_up(N, 16) * XS + round_up(Q, TILE) * XS + stages * TILE * SCS +
                2 * round_up(Q, TILE)) +
           stages * TILE * (round_up(N, 16) + 8) * tsize;
}

// Rows [r0, r0 + 64) of a [Q, N] matrix of B or C (rows ldn apart in src) into a
// tile of T with row stride ld, zero past Q and N: 16-byte cp.async where rows
// are whole 16-byte chunks and aligned (vec), else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int ldn,
                                          int r0, int Q, int N, int NK, bool vec) {
    constexpr int CH = 16 / sizeof(T);
    if (vec) {
        const int cpr = NK / CH;
        for (int c = threadIdx.x; c < TILE * cpr; c += THREADS) {
            const int r = c / cpr, n = (c % cpr) * CH;
            const bool ok = r0 + r < Q && n < N;
            cp_async16(dst + r * ld + n, ok ? src + (long long)(r0 + r) * ldn + n : src, ok);
        }
    } else {
        for (int e = threadIdx.x; e < TILE * NK; e += THREADS) {
            const int r = e / NK, n = e % NK;
            dst[r * ld + n] =
                (r0 + r < Q && n < N) ? src[(long long)(r0 + r) * ldn + n] : T(0.0f);
        }
    }
}

// G tile (ti, tj) of one chunk (f32 [Q, Q]) into a [64][SCS] tile, zero past Q.
__device__ __forceinline__ void load_g(float* dst, const float* __restrict__ Gc, int ti, int tj,
                                       int Q) {
    const int i0 = ti * TILE, j0 = tj * TILE;
    if (Q % 4 == 0) {
#pragma unroll
        for (int q = 0; q < TILE * TILE / 4 / THREADS; ++q) {
            const int c = threadIdx.x + q * THREADS;
            const int r = c / (TILE / 4), cc = (c % (TILE / 4)) * 4;
            const bool ok = i0 + r < Q && j0 + cc < Q;
            cp_async16(dst + r * SCS + cc, ok ? Gc + (long long)(i0 + r) * Q + j0 + cc : Gc, ok);
        }
    } else {
        for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
            const int r = e / TILE, cc = e % TILE;
            dst[r * SCS + cc] =
                (i0 + r < Q && j0 + cc < Q) ? Gc[(long long)(i0 + r) * Q + j0 + cc] : 0.f;
        }
    }
}

template <typename T, int P, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ log_a,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ dt, const float* __restrict__ G, T* __restrict__ out,
                int L, int H, int N, int Q, int NG) {
    using D = Dims<P>;
    constexpr int XS = D::XS, CG = D::CG, NT = D::NT;
    constexpr int CH = 16 / sizeof(T);  // elements of a 16-byte chunk
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int NK = round_up(N, 16), QP = round_up(Q, TILE);
    // tile strides in T: a C tile is read along k = n (stride 4 mod 32 words), a B
    // tile down its columns (stride 8 mod 32 words)
    const int CS = sizeof(T) == 4 ? NK + 4 : NK + 8, BS = NK + 8;
    float* S_s = reinterpret_cast<float*>(smem_raw);  // [NK][XS] the carried state
    float* xdt_s = S_s + NK * XS;                     // [QP][XS]
    float* g_s = xdt_s + QP * XS;                     // STAGES x [64][SCS] G tiles
    float* cum_s = g_s + STAGES * TILE * SCS;         // [QP]
    float* w_s = cum_s + QP;  // [QP] dt, exp(cum_i0 - cum) in a row tile, exp(total - cum)
    T* t_s = reinterpret_cast<T*>(w_s + QP);          // STAGES x [64][BS] a C or a B tile
    // a ring's other buffer (buffer (k ^ 1) at k * stride): itself in a ring of one
    constexpr bool ring = STAGES == 2;
    const int t_stride = ring ? TILE * BS : 0, g_stride = ring ? TILE * SCS : 0;

    const int h = blockIdx.x, b = blockIdx.y;
    const int grp = h / (H / NG), ldn = NG * N;  // this head's group; a position's B row
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = warp % 4, wc = warp / 4;  // a warp's row band and column group
    const int col0 = wc * CG;
    const int nt_live = col0 < P ? min(NT, (P - col0) / 8) : 0;
    const int nc = L / Q, ntiles = QP / TILE;
    const bool vec_bc = N % CH == 0 && ((uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
    const bool vec_x = (uintptr_t)x % 16 == 0;

    for (int e = tid; e < NK * XS; e += THREADS) S_s[e] = 0.f;

    for (int chunk = 0; chunk < nc; ++chunk) {
        const long long row0 = (long long)b * L + (long long)chunk * Q;  // first position
        const T* Bc = Bm + row0 * ldn + grp * N;
        const T* Cc = Cm + row0 * ldn + grp * N;
        const float* Gc = G + (((long long)b * nc + chunk) * NG + grp) * Q * Q;
        __syncthreads();  // the previous chunk is done with every buffer
        // the first C tile and G tile load while xdt and the cumsum are computed
        load_tile(t_s, CS, Cc, ldn, 0, Q, N, NK, vec_bc);
        load_g(g_s, Gc, 0, 0, Q);
        cp_async_commit();
        for (int j = tid; j < QP; j += THREADS) {
            cum_s[j] = j < Q ? log_a[(row0 + j) * H + h] : 0.f;
            w_s[j] = j < Q ? dt[(row0 + j) * H + h] : 0.f;
        }
        __syncthreads();
        if (vec_x) {  // 16-byte loads, XU in flight a thread
            constexpr int XU = 4, VPR = P / CH;  // vectors a row
            for (int base = 0; base < QP * VPR; base += THREADS * XU) {
                uint4 v[XU];
#pragma unroll
                for (int u = 0; u < XU; ++u) {
                    const int c = base + u * THREADS + tid, j = c / VPR;
                    if (c < QP * VPR && j < Q)
                        v[u] = __ldg(reinterpret_cast<const uint4*>(
                                         x + ((row0 + j) * H + h) * P) + c % VPR);
                }
#pragma unroll
                for (int u = 0; u < XU; ++u) {
                    const int c = base + u * THREADS + tid, j = c / VPR;
                    if (c >= QP * VPR) continue;
                    const T* e = reinterpret_cast<const T*>(&v[u]);
                    float* d = xdt_s + j * XS + (c % VPR) * CH;
#pragma unroll
                    for (int q = 0; q < CH; ++q) d[q] = j < Q ? to_f(e[q]) * w_s[j] : 0.f;
                }
            }
        } else {
            for (int e = tid; e < QP * P; e += THREADS) {
                const int j = e / P, p = e % P;
                xdt_s[j * XS + p] = j < Q ? ld(x + ((row0 + j) * H + h) * P + p) * w_s[j] : 0.f;
            }
        }
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

        // Two rings: C then B tiles in t_s, G tiles in g_s.  At each step: wait for
        // the copies in flight, barrier (the tile is visible and the other buffer of
        // its ring is no longer read), start the ring's next copy into the other
        // buffer, compute.  In a ring of one buffer the next copy starts after the
        // products, behind a barrier of its own.
        int tb = 0, gb = 0;
        // ---- y, one row tile of 64 positions i at a time
        for (int ti = 0; ti < ntiles; ++ti) {
            const int i0 = ti * TILE;
            cp_async_wait_all();
            __syncthreads();
            const auto next_t = [&] {
                T* nxt = t_s + (tb ^ 1) * t_stride;
                if (ti + 1 < ntiles) load_tile(nxt, CS, Cc, ldn, i0 + TILE, Q, N, NK, vec_bc);
                else load_tile(nxt, BS, Bc, ldn, 0, Q, N, NK, vec_bc);  // the state update's first
                cp_async_commit();
            };
            if constexpr (ring) next_t();
            // inter-chunk: exp(cum_i) * (C S)[i, p], from the state entering the chunk
            float acc[1][NT][4] = {};
            const T* ct = t_s + tb * t_stride + (wr * 16 + g) * CS + t;
            products<1, NT, sizeof(T) == 2>(
                acc,
                [&](int, int k0, float(&av)[4]) {
                    av[0] = to_f(ct[k0]);
                    av[1] = to_f(ct[8 * CS + k0]);
                    av[2] = to_f(ct[k0 + 4]);
                    av[3] = to_f(ct[8 * CS + k0 + 4]);
                },
                S_s + col0, XS, NK / 8, 1, nt_live);
            // this lane's rows i of the tile, and their cumsums
            const int ia = i0 + wr * 16 + g, ib = ia + 8;
            const float ca = cum_s[ia], cb = cum_s[ib];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int i = hh ? ib : ia;
                const float e = i < Q ? expf(hh ? cb : ca) : 0.f;
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    acc[0][j][2 * hh] *= e;
                    acc[0][j][2 * hh + 1] *= e;
                }
            }
            // intra-chunk: the tiles of j <= the row tile's last i.  Below the
            // diagonal tile every j < i0 <= i, and exp(cum_i - cum_j) is the product
            // of exp(cum_i - cum_i0) (this lane's rows) and exp(cum_i0 - cum_j) (w_s,
            // by j; dt is no longer needed there): both at most 1, as log_a <= 0, so
            // neither overflows, and 64 exponentials a tile row replace 64 x 64.
            const float c0 = cum_s[i0];
            const float ra = ia < Q ? expf(ca - c0) : 0.f, rb = ib < Q ? expf(cb - c0) : 0.f;
            for (int j = tid; j < i0; j += THREADS) w_s[j] = expf(c0 - cum_s[j]);
            for (int tj = 0; tj <= ti; ++tj) {
                const int j0 = tj * TILE;
                cp_async_wait_all();
                __syncthreads();  // also: w_s is written
                // (one buffer: C S above was the C tile's last reader)
                if constexpr (!ring) {
                    if (tj == 0) next_t();
                }
                const auto next_g = [&] {
                    if (tj < ti) load_g(g_s + (gb ^ 1) * g_stride, Gc, ti, tj + 1, Q);
                    else if (ti + 1 < ntiles) load_g(g_s + (gb ^ 1) * g_stride, Gc, ti + 1, 0, Q);
                    cp_async_commit();
                };
                if constexpr (ring) next_g();
                // the scores G o exp(cum_i - cum_j), formed as the fragments are read
                const float* gt = g_s + gb * g_stride + (wr * 16 + g) * SCS + t;
                const float* wj = w_s + j0 + t;
                if (tj < ti) {
                    products<1, NT, false>(
                        acc,
                        [&](int, int k0, float(&av)[4]) {
                            const float da = wj[k0], db = wj[k0 + 4];
                            av[0] = gt[k0] * ra * da;
                            av[1] = gt[8 * SCS + k0] * rb * da;
                            av[2] = gt[k0 + 4] * ra * db;
                            av[3] = gt[8 * SCS + k0 + 4] * rb * db;
                        },
                        xdt_s + j0 * XS + col0, XS, TILE / 8, 1, nt_live);
                } else {
                    // the diagonal tile: select before the exponential, so exp runs
                    // only where j <= i
                    products<1, NT, false>(
                        acc,
                        [&](int, int k0, float(&av)[4]) {
                            const int ja = j0 + k0 + t, jb = ja + 4;
                            const float da = cum_s[ja], db = cum_s[jb];
                            av[0] = (ia < Q && ja <= ia) ? gt[k0] * __expf(ca - da) : 0.f;
                            av[1] = (ib < Q && ja <= ib) ? gt[8 * SCS + k0] * __expf(cb - da)
                                                         : 0.f;
                            av[2] = (ia < Q && jb <= ia) ? gt[k0 + 4] * __expf(ca - db) : 0.f;
                            av[3] = (ib < Q && jb <= ib)
                                        ? gt[8 * SCS + k0 + 4] * __expf(cb - db) : 0.f;
                        },
                        xdt_s + j0 * XS + col0, XS, TILE / 8, 1, nt_live);
                }
                if constexpr (!ring) {
                    __syncthreads();  // every warp is done with the G tile
                    next_g();
                }
                gb ^= 1;
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int i = i0 + wr * 16 + hh * 8 + g;
                if (i >= Q) continue;
                T* o = out + ((row0 + i) * H + h) * P + col0;
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    if (j < nt_live)
                        store2(o + j * 8 + 2 * t, acc[0][j][2 * hh], acc[0][j][2 * hh + 1]);
            }
            tb ^= 1;
        }

        // ---- the state update, after every row tile has read the old S and w_s
        __syncthreads();
        for (int j = tid; j < QP; j += THREADS) w_s[j] = j < Q ? expf(total - cum_s[j]) : 0.f;
        const float decay = expf(total);
        for (int m0 = 0; m0 < NK; m0 += 8 * 16) {  // bands of 128 rows n, a warp 32 of them
            const int r0 = m0 + wr * 32;
            const int mt_live = max(0, min(2, (NK - r0) / 16));
            float acc[2][NT][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int n = r0 + i * 16 + g + (q / 2) * 8;
                        const int p = col0 + j * 8 + 2 * t + q % 2;
                        acc[i][j][q] = (i < mt_live && j < nt_live) ? decay * S_s[n * XS + p] : 0.f;
                    }
            for (int tj = 0; tj < ntiles; ++tj) {
                cp_async_wait_all();
                __syncthreads();
                const auto next_b = [&] {
                    T* nxt = t_s + (tb ^ 1) * t_stride;
                    if (tj + 1 < ntiles)
                        load_tile(nxt, BS, Bc, ldn, (tj + 1) * TILE, Q, N, NK, vec_bc);
                    else if (m0 + 128 < NK) load_tile(nxt, BS, Bc, ldn, 0, Q, N, NK, vec_bc);
                    cp_async_commit();
                };
                if constexpr (ring) next_b();
                // (B o w)^T xdt: A[n][j] is the B tile read down its columns, times w[j]
                const T* bt = t_s + tb * t_stride + t * BS + r0 + g;
                const float* wt = w_s + tj * TILE + t;
                products<2, NT, false>(
                    acc,
                    [&](int i, int k0, float(&av)[4]) {
                        const T* a = bt + k0 * BS + i * 16;
                        const float wa = wt[k0], wb = wt[k0 + 4];
                        av[0] = to_f(a[0]) * wa;
                        av[1] = to_f(a[8]) * wa;
                        av[2] = to_f(a[4 * BS]) * wb;
                        av[3] = to_f(a[4 * BS + 8]) * wb;
                    },
                    xdt_s + tj * TILE * XS + col0, XS, TILE / 8, mt_live, nt_live);
                if constexpr (!ring) {
                    __syncthreads();  // every warp is done with the B tile
                    next_b();
                }
                tb ^= 1;
            }
            // each (n, p) has one owner, which alone read it above
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (i < mt_live && j < nt_live)
                            S_s[(r0 + i * 16 + g + (q / 2) * 8) * XS + col0 + j * 8 + 2 * t +
                                q % 2] = acc[i][j][q];
        }
    }
}

template <typename T, int P>
int launch(const void* x, const float* log_a, const void* Bm, const void* Cm,
           const float* dt, float* G, void* out, int Bt, int L, int H, int N, int Q, int NG,
           cudaStream_t stream) {
    // two buffers a ring where they fit, else one
    const int stages = scan_smem_bytes(Dims<P>::XS, N, Q, (int)sizeof(T), 2) <= SMEM_MAX ? 2 : 1;
    const int smem = scan_smem_bytes(Dims<P>::XS, N, Q, (int)sizeof(T), stages);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    auto kernel = stages == 2 ? ssd_scan_kernel<T, P, 2> : ssd_scan_kernel<T, P, 1>;
    // allow the most a block may use, once per (T, P) for both instances (no call
    // during graph capture)
    static bool smem_allowed = false;
    if (!smem_allowed) {
        for (auto k : {ssd_scan_kernel<T, P, 1>, ssd_scan_kernel<T, P, 2>}) {
            const cudaError_t err =
                cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
            if (err != cudaSuccess) return (int)err;
        }
        smem_allowed = true;
    }
    const T* B = static_cast<const T*>(Bm);
    const T* C = static_cast<const T*>(Cm);
    const int nt = (Q + TILE - 1) / TILE;
    ssd_scan_cb_kernel<T><<<dim3(nt * (nt + 1) / 2, L / Q, Bt * NG), CB_THREADS, 0, stream>>>(
        B, C, G, L, N, Q, NG);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(H, Bt), THREADS, smem, stream>>>(static_cast<const T*>(x), log_a, B, C, dt,
                                                   G, static_cast<T*>(out), L, H, N, Q, NG);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* log_a, const void* Bm, const void* Cm,
             const float* dt, float* G, void* out, int Bt, int L, int H, int P, int N, int Q,
             int NG, cudaStream_t stream) {
    switch (P) {
        case 8: return launch<T, 8>(x, log_a, Bm, Cm, dt, G, out, Bt, L, H, N, Q, NG, stream);
        case 16: return launch<T, 16>(x, log_a, Bm, Cm, dt, G, out, Bt, L, H, N, Q, NG, stream);
        case 32: return launch<T, 32>(x, log_a, Bm, Cm, dt, G, out, Bt, L, H, N, Q, NG, stream);
        case 64: return launch<T, 64>(x, log_a, Bm, Cm, dt, G, out, Bt, L, H, N, Q, NG, stream);
        case 128:
            return launch<T, 128>(x, log_a, Bm, Cm, dt, G, out, Bt, L, H, N, Q, NG, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// x [Bt, L, H, P], log_a [Bt, L, H] f32, B / C [Bt, L, NG, N], dt [Bt, L, H] f32,
// the workspace G [Bt, L / Q, NG, Q, Q] f32, out [Bt, L, H, P]; L a multiple of Q,
// H of NG.  dtype (of x, B, C and out): 0 = float32, 1 = bfloat16.
extern "C" int ssd_scan(const void* x, const void* log_a, const void* Bm, const void* Cm,
                        const void* dt, void* G, void* out, int Bt, int L, int H, int P, int N,
                        int Q, int NG, int dtype, void* stream) {
    if (Bt <= 0 || L <= 0 || H <= 0 || N <= 0 || Q <= 0 || NG <= 0 || L % Q || H % NG)
        return (int)cudaErrorInvalidValue;
    if ((long long)Bt * NG > 65535 || L / Q > 65535) return (int)cudaErrorInvalidConfiguration;
    const float* la = static_cast<const float*>(log_a);
    const float* d = static_cast<const float*>(dt);
    float* g = static_cast<float*>(G);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(x, la, Bm, Cm, d, g, out, Bt, L, H, P, N, Q, NG, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(x, la, Bm, Cm, d, g, out, Bt, L, H, P, N, Q, NG, s);
    return (int)cudaErrorInvalidValue;
}
