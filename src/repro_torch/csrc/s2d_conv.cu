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
// with f32 accumulation and the result cast to x's dtype once.  Like the TPU
// kernel, this keeps the D2S/S2D intermediates out of device memory: the
// kernel reads x once and writes out once, in their own layouts.
//
// What bounds it.  At the main path's shapes (the 1x1 variant layers that
// the multicam_heavy plans select in resnet50@448 and swin_tiny: M = 784 or
// 3136 at B=1, Cv and Kv 64..512) a layer is a few MB and a few hundred
// MFLOP: under 2 us at the card's byte or tensor-core rate.  What held the
// first version back was latency, not either rate: 16-deep slabs walked one
// after another with no load in flight during the products, and as few as 26
// output tiles for 132 SMs.  The design answers each:
//
//   * Tensor cores through mma.sync.  bf16 goes straight on (m16n8k16).  f32
//     goes through split TF32 (CUTLASS's 3xTF32): each operand a is cut into
//     hi = tf32(a) (cvt.rna) and lo = tf32(a - hi), and the product is
//     lo*hi + hi*lo + hi*hi on m16n8k8, accumulated in f32.  That keeps
//     about 21 bits of each operand, within 1e-7 of max|ref| at the main
//     path's shapes; a single TF32 product (hi*hi) is off by some 3e-4, past
//     the f32 tolerance of 1e-4 (tests/test_torch_kernel_plans.py emulates
//     both).
//   * A ring of STAGES = 3 slabs of x [64, BK] and w [BK, 64] in shared
//     memory, filled with 16-byte cp.async (zero-fill past the ragged edges),
//     so that two slabs are in flight while one is multiplied.  BK is 32 in
//     f32 and 64 in bf16 (128 bytes of a row), so a 64..512 contraction takes
//     at most 16 steps.  Rows are padded by 16 bytes, so fragment loads
//     (ldmatrix in bf16, 32-bit loads in f32) hit distinct banks.
//   * A grid for the card.  With 64x64 output tiles, a block walks the whole
//     contraction and writes its tile straight from its registers.  Where
//     the tiles are few and the contraction long (784 x 512 x 128: 26 tiles
//     of 16 f32 slabs), the launch planner in kernels/s2d_conv/kernel.py
//     (plain Python, from (M, Cv, Kv, SM count) and times fitted to the
//     card) splits each tile's contraction over a cluster of 2, 4 or 8
//     blocks, each over its own run of slabs.  The blocks put their f32
//     partial tiles in shared memory and, after a cluster barrier, each block
//     sums a band of the tile's rows over the cluster's blocks in rank order
//     through distributed shared memory, casts once and writes.  No atomics
//     and no workspace: two calls on one input are bit-identical, and a CUDA
//     graph replays the launch as it is.  The merge and its barriers cost
//     about as much as a slab or two, so the planner splits only where the
//     chain it shortens is longer.
//   * Ragged edges: predicated, zero-filled loads in M, Cv and Kv.  Where a
//     row of x, w or out is not a whole number of 16-byte chunks (f32 Cv = 5,
//     bf16 Cv = 4) or a pointer is not 16-byte aligned, the same kernel loads
//     and stores element by element (the VEC = false instance).
//
// 4 warps a block, each a 32x32 quarter of the tile (2 x 4 mma tiles).
// wgmma and TMA are not used: at these shapes a tile takes a few slabs, and
// the tensor cores' rate is not what bounds it.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libs2d_conv.so s2d_conv.cu
// C interface: s2d_conv_gemm(...) launches on the given stream and returns
// the launch's cudaError_t as an int (0 == launched).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;         // output rows per tile (kernel.py TILE_M)
constexpr int BN = 64;         // output columns per tile (kernel.py TILE_N)
constexpr int THREADS = 128;   // 4 warps, 2 x 2 over the tile
constexpr int STAGES = 3;      // slabs in the shared-memory ring
constexpr int MAX_SPLIT = 8;   // blocks of a cluster (portable maximum)
constexpr int LDC = BN + 4;    // f32 row stride of the partial tile

template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int BK = 32; };          // kernel.py TILE_K
template <> struct Cfg<__nv_bfloat16> { static constexpr int BK = 64; };

template <typename T> struct Smem {
    static constexpr int BK = Cfg<T>::BK;
    static constexpr int CH = 16 / sizeof(T);   // elements in a 16-byte chunk
    static constexpr int LDA = BK + CH;         // x slab [BM][LDA], row padded 16 B
    static constexpr int LDB = BN + 8;          // w slab [BK][LDB]
    static constexpr int A_ELEMS = BM * LDA;
    static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
    static constexpr int BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
    static_assert(BYTES >= BM * LDC * 4, "the partial tile reuses the ring");
    static_assert((LDA * sizeof(T)) % 16 == 0 && (LDB * sizeof(T)) % 16 == 0, "16-byte rows");
};

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !pred (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float f) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
    return r;
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

// One slab (contraction rows [k0, k0 + BK)) of x and w into a ring stage.
template <typename T, bool VEC>
__device__ __forceinline__ void load_slab(T* As, T* Bs, const T* __restrict__ x,
                                          const T* __restrict__ w, long long row0, int col0,
                                          int k0, long long M, int Cv, int Kv) {
    using S = Smem<T>;
    constexpr int BK = S::BK, CH = S::CH;
    const int tid = threadIdx.x;
    if constexpr (VEC) {
        // x: BM rows of BK / CH chunks; w: BK rows of BN / CH chunks
        constexpr int A_CPR = BK / CH, B_CPR = BN / CH;
        static_assert(BM * A_CPR % THREADS == 0 && BK * B_CPR % THREADS == 0, "slab chunks");
#pragma unroll
        for (int i = 0; i < BM * A_CPR / THREADS; ++i) {
            const int c = tid + i * THREADS;
            const int r = c / A_CPR, k = k0 + (c % A_CPR) * CH;
            const bool ok = row0 + r < M && k < Cv;
            cp_async16(As + r * S::LDA + (c % A_CPR) * CH, ok ? x + (row0 + r) * Cv + k : x, ok);
        }
#pragma unroll
        for (int i = 0; i < BK * B_CPR / THREADS; ++i) {
            const int c = tid + i * THREADS;
            const int r = c / B_CPR, n = col0 + (c % B_CPR) * CH;
            const bool ok = k0 + r < Cv && n < Kv;
            cp_async16(Bs + r * S::LDB + (c % B_CPR) * CH,
                       ok ? w + (long long)(k0 + r) * Kv + n : w, ok);
        }
    } else {
        // rows that are not whole 16-byte chunks: element by element
        for (int e = tid; e < BM * BK; e += THREADS) {
            const int r = e / BK, k = k0 + e % BK;
            As[r * S::LDA + e % BK] = (row0 + r < M && k < Cv) ? x[(row0 + r) * Cv + k] : T(0.0f);
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
            const int r = e / BN, n = col0 + e % BN;
            Bs[r * S::LDB + e % BN] =
                (k0 + r < Cv && n < Kv) ? w[(long long)(k0 + r) * Kv + n] : T(0.0f);
        }
    }
}

// The products of one slab: this warp's 32x32 quarter, 2 x 4 mma tiles.
__device__ __forceinline__ void slab_products(const float* As, const float* Bs,
                                              float (&acc)[2][4][4], int wm, int wn) {
    using S = Smem<float>;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 8) {
        uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float* a = As + (wm * 32 + i * 16 + g) * S::LDA + kk + t;
            const float av[4] = {a[0], a[8 * S::LDA], a[4], a[8 * S::LDA + 4]};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                ahi[i][q] = tf32(av[q]);
                alo[i][q] = tf32(av[q] - __uint_as_float(ahi[i][q]));
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float* b = Bs + (kk + t) * S::LDB + wn * 32 + j * 8 + g;
            const float bv[2] = {b[0], b[4 * S::LDB]};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                bhi[j][q] = tf32(bv[q]);
                blo[j][q] = tf32(bv[q] - __uint_as_float(bhi[j][q]));
            }
        }
        // small terms first, then the large one
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                mma_tf32(acc[i][j], alo[i], bhi[j]);
                mma_tf32(acc[i][j], ahi[i], blo[j]);
                mma_tf32(acc[i][j], ahi[i], bhi[j]);
            }
    }
}

__device__ __forceinline__ void slab_products(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                              float (&acc)[2][4][4], int wm, int wn) {
    using S = Smem<__nv_bfloat16>;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kk = 0; kk < S::BK; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            // matrices: rows 0-7 / 8-15 at k 0-7, then the same at k 8-15
            const __nv_bfloat16* p =
                As + (wm * 32 + i * 16 + lane % 16) * S::LDA + kk + (lane / 16) * 8;
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(a[i][0]), "=r"(a[i][1]), "=r"(a[i][2]), "=r"(a[i][3])
                         : "r"(smem_addr(p)));
        }
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
            // w is [k][n] in shared memory: transposed 8x8 loads give the
            // k-pairs of a column; matrices k 0-7 / 8-15 of tile j, then j+1
            const __nv_bfloat16* p = Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * S::LDB +
                                     wn * 32 + j * 8 + (lane / 16) * 8;
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]), "=r"(b[j + 1][1])
                         : "r"(smem_addr(p)));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
}

// 4 consecutive f32 of a row, cast to T and stored with one 8- or 16-byte store
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}
// 2 consecutive f32 of a row, cast to T and stored with one 8- or 4-byte store
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The whole contraction is in this block: cast and write its fragments.
template <typename T, bool VEC>
__device__ __forceinline__ void write_fragments(const float (&acc)[2][4][4], T* __restrict__ out,
                                                long long row0, int col0, long long M, int Kv) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long gr = row0 + wm * 32 + i * 16 + h * 8 + g;
            if (gr >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int gc = col0 + wn * 32 + j * 8 + 2 * t;
                const float a = acc[i][j][2 * h], b = acc[i][j][2 * h + 1];
                T* o = out + gr * Kv + gc;
                if constexpr (VEC) {
                    if (gc < Kv) store2(o, a, b);  // Kv is even: both columns exist
                } else {
                    if (gc < Kv) o[0] = narrow<T>(a);
                    if (gc + 1 < Kv) o[1] = narrow<T>(b);
                }
            }
        }
}

// The blocks of a cluster hold partial tiles over runs of the contraction:
// each puts its tile in its shared memory `part`, then block `rank` sums rows
// [r0, r1) of the tile over the cluster's blocks in rank order (every block's
// four values loaded before the sum starts), casts and writes them.
template <typename T, bool VEC>
__device__ __forceinline__ void cluster_sum(const float (&acc)[2][4][4], float* part,
                                            T* __restrict__ out, long long row0, int col0,
                                            long long M, int Kv) {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float* p = part + (wm * 32 + i * 16 + g) * LDC + wn * 32 + j * 8 + 2 * t;
            p[0] = acc[i][j][0];
            p[1] = acc[i][j][1];
            p[8 * LDC] = acc[i][j][2];
            p[8 * LDC + 1] = acc[i][j][3];
        }
    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    cluster.sync();

    const float* peer[MAX_SPLIT];
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) peer[j] = j < split ? cluster.map_shared_rank(part, j) : part;
    const int r0 = rank * BM / split, r1 = (rank + 1) * BM / split;
    for (int e = threadIdx.x; e < (r1 - r0) * (BN / 4); e += THREADS) {
        const int r = r0 + e / (BN / 4), c = (e % (BN / 4)) * 4;
        float4 u[MAX_SPLIT];
#pragma unroll
        for (int j = 0; j < MAX_SPLIT; ++j)
            if (j < split) u[j] = *reinterpret_cast<const float4*>(peer[j] + r * LDC + c);
        float4 v = u[0];
#pragma unroll
        for (int j = 1; j < MAX_SPLIT; ++j)
            if (j < split) {
                v.x += u[j].x;
                v.y += u[j].y;
                v.z += u[j].z;
                v.w += u[j].w;
            }
        const long long gr = row0 + r;
        const int gc = col0 + c;
        if (gr >= M || gc >= Kv) continue;
        T* o = out + gr * Kv + gc;
        if constexpr (VEC) {
            store4(o, v);  // Kv is a whole number of chunks: all 4 columns exist
        } else {
            const float vs[4] = {v.x, v.y, v.z, v.w};
            for (int q = 0; q < 4 && gc + q < Kv; ++q) o[q] = narrow<T>(vs[q]);
        }
    }
    cluster.sync();  // no block leaves while another reads its tile
}

// grid: (m_tiles * split, n_tiles).  SPLIT: launched as clusters of (split, 1,
// 1), one cluster per tile; else split = 1 and each block writes its tile
// straight from its registers.
template <typename T, bool VEC, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
s2d_conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                     long long M, int Cv, int Kv) {
    using S = Smem<T>;
    constexpr int BK = S::BK;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ring = reinterpret_cast<T*>(smem_raw);

    int split = 1, rank = 0;
    if constexpr (SPLIT) {
        split = (int)cg::this_cluster().num_blocks();
        rank = (int)cg::this_cluster().block_rank();
    }
    const long long row0 = (long long)(blockIdx.x / split) * BM;
    const int col0 = blockIdx.y * BN;
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;

    // this block's run of slabs (kernel.py S2dPlan.k_range)
    const int n_slabs = (Cv + BK - 1) / BK;
    const int s_begin = rank * n_slabs / split;
    const int nk = (rank + 1) * n_slabs / split - s_begin;

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

    auto stage_a = [&](int s) { return ring + s * S::STAGE_ELEMS; };
    auto stage_b = [&](int s) { return ring + s * S::STAGE_ELEMS + S::A_ELEMS; };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load_slab<T, VEC>(stage_a(s), stage_b(s), x, w, row0, col0, (s_begin + s) * BK, M,
                              Cv, Kv);
        cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<STAGES - 2>();  // slab i has landed ...
        __syncthreads();              // ... for every thread, and slab i-1 is consumed
        const int nx = i + STAGES - 1;
        if (nx < nk)
            load_slab<T, VEC>(stage_a(nx % STAGES), stage_b(nx % STAGES), x, w, row0, col0,
                              (s_begin + nx) * BK, M, Cv, Kv);
        cp_async_commit();
        slab_products(stage_a(i % STAGES), stage_b(i % STAGES), acc, wm, wn);
    }
    if constexpr (SPLIT) {
        cp_async_wait<0>();  // the partial tile goes over the ring
        __syncthreads();
        cluster_sum<T, VEC>(acc, reinterpret_cast<float*>(smem_raw), out, row0, col0, M, Kv);
    } else {
        write_fragments<T, VEC>(acc, out, row0, col0, M, Kv);
    }
}

template <typename T, bool VEC, bool SPLIT>
int launch(const void* x, const void* w, void* out, long long M, int Cv, int Kv, int split,
           cudaStream_t stream) {
    auto kernel = s2d_conv_gemm_kernel<T, VEC, SPLIT>;
    static bool smem_set = false;  // set once, before any graph capture
    if (!smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(((M + BM - 1) / BM) * split), (unsigned)((Kv + BN - 1) / BN));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Smem<T>::BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = SPLIT ? 1 : 0;  // a block of its own: no cluster to schedule
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                               static_cast<const T*>(w), static_cast<T*>(out),
                                               M, Cv, Kv);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, long long M, int Cv, int Kv, int split,
             cudaStream_t stream) {
    constexpr int CH = Smem<T>::CH;
    const bool vec = Cv % CH == 0 && Kv % CH == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (split == 1)
        return vec ? launch<T, true, false>(x, w, out, M, Cv, Kv, split, stream)
                   : launch<T, false, false>(x, w, out, M, Cv, Kv, split, stream);
    return vec ? launch<T, true, true>(x, w, out, M, Cv, Kv, split, stream)
               : launch<T, false, true>(x, w, out, M, Cv, Kv, split, stream);
}

}  // namespace

// x [M, Cv], w [Cv, Kv], out [M, Kv], contiguous; `split` blocks (1..8) share
// each 64x64 output tile's contraction.  dtype: 0 = float32, 1 = bfloat16
// (x, w and out share it).
extern "C" int s2d_conv_gemm(const void* x, const void* w, void* out, long long M, int Cv,
                             int Kv, int split, int dtype, void* stream) {
    if (M <= 0 || Cv <= 0 || Kv <= 0 || split < 1 || split > MAX_SPLIT)
        return (int)cudaErrorInvalidValue;
    if (((M + BM - 1) / BM) * split > 0x7fffffffLL || (Kv + BN - 1) / BN > 65535)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(x, w, out, M, Cv, Kv, split, s);
    if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, M, Cv, Kv, split, s);
    return (int)cudaErrorInvalidValue;
}
