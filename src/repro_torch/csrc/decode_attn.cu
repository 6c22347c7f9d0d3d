// GQA decode attention (one query token against a KV cache) for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/decode_attn/kernel.py::_decode_attn_kernel.
//
// What it computes.  q [B, H, Dh], cache_k / cache_v [B, L, Hkv, Dh] (the JAX
// layout, contiguous; query head h = kvh * G + g reads KV head kvh, G = H / Hkv)
// and valid_len [B] int32 give, for every (b, h),
//
//     out[b, h] = sum_t softmax_t(q[b, h] . k[b, t, kvh] / sqrt(Dh)) v[b, t, kvh],
//                 t < valid_len[b],
//
// with f32 scores, an f32 online softmax (running max m, sum l, accumulator acc)
// and f32 accumulation; the output is cast to q's dtype once, as acc / max(l, 1e-30).
// The Pallas kernel masks positions >= valid_len to -1e30, which gives them weight
// exactly 0, so this kernel does not read them at all: the same function over
// fewer bytes.  Any L works; valid_len is clamped to [0, L], and a row with no
// valid position gives 0.
//
// What bounds it.  Memory, if the SMs keep up.  At the serving path's shape
// (B = 8, Hkv = 8, G = 4, Dh = 64, bf16) one call reads 2 * B * valid * Hkv * Dh * 2
// bytes of cache: 33.5 MB at valid = 2048, about 10 us at 3.35 TB/s, and it does
// some 4 operations per element read.  On the CUDA cores those operations, with
// the bf16 widening, the shuffles that sum a row's partial dots and the softmax
// around them, come to some 36 warp instructions per cache position on an SM,
// while at its share of 3.35 TB/s a position's 256 bytes reach an SM every 18
// cycles or so: its four schedulers would have to issue on half of their cycles,
// through chains of shuffles, shared-memory loads and exponentials.  So:
//
//   * bf16 goes through the tensor cores (mma.sync m16n8k16, f32 accumulation).
//     Per 16 cache positions a warp computes the scores S = Q K^T with the G
//     query heads as the rows of a 16-row A operand (head h in row h; rows >= G
//     are zero, so at G <= 8 the upper eight rows hold nothing and are skipped at
//     compile time, and at G = 16 each thread carries the state of two heads,
//     g and g + 8), keeps
//     the online softmax on S's f32 fragments (rows are heads, so a row's max
//     and sum take two shuffles), rounds P to bf16 in the registers that already
//     hold it in the A operand's layout, and adds P V to O.  K and V come from
//     shared memory by ldmatrix (V transposed on the way).  That is some 7 warp
//     instructions per position.  P is rounded to bf16 as the plain version
//     rounds its softmax weights; l sums the unrounded f32 weights.
//   * f32 stays on the CUDA cores in f32 (a TF32 product would miss the f32
//     tolerance): a cache row of Dh values is read from shared memory by
//     TPR = Dh / (NV * 4) neighbouring threads with NV 16-byte loads each, NV the
//     fewest that make TPR at most a warp and a divisor of the block (NV = 1;
//     2 at Dh = 256; 5 at Dh = 80, whose 20 vectors no divisor of 128 up to 32
//     splits one a thread);
//     each thread holds its [G, 4 NV] slice of the query tile and its own
//     (m, l, acc) in registers, and the partial dots are summed with warp
//     shuffles.
//
// Common to both (flash-decoding in one launch).  The Pallas grid walks the
// cache in order on one core and carries (m, l, acc) in VMEM from chunk to chunk.
// Blocks on the card run in parallel and in no order, and B * Hkv = 64 blocks would
// leave half of the 132 SMs idle, so each (b, kv head) is a thread-block cluster of
// S <= 8 blocks (grid (S, Hkv, B), cluster (S, 1, 1)):
//
//   * S comes from the host (kernels/decode_attn/kernel.py plan_splits), from L
//     or a caller's upper bound on valid_len, B * Hkv and the SM count, never
//     from reading valid_len, so a CUDA graph can replay the launch.  Block
//     `rank` of the cluster takes its share of [0, valid_len[b]), cut into S
//     equal pieces on the device (kernel.py split_rows), so the kernel is right
//     for any S.
//   * Each block (128 threads) streams its rows through a ring of tiles of K and
//     V in shared memory, filled with 16-byte cp.async, so the next tiles are in
//     flight while one is read.  Rows past the block's end are zero-filled, not
//     read.
//   * Scores are kept in log2 units (scaled by log2(e) / sqrt(Dh)), so every
//     exponential is one exp2f.
//   * At the end the warps' (or thread groups') states are merged through shared
//     memory into one unnormalised (m, l, acc) per block; after a cluster barrier,
//     each block merges a slice of the G * Dh outputs over the cluster's blocks in
//     rank order through distributed shared memory and writes acc / max(l, 1e-30).
//     No workspace, no second launch, no atomics: two calls on one input are
//     bit-identical.
//
// Numbers that differ from the plain version: the sums run in another order
// (f32 agrees to about 1e-6 relative), and in bf16 the weights are rounded before
// they are normalised, where models/common.decode_attention normalises, then
// rounds.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libdecode_attn.so decode_attn.cu
// C interface: decode_attn(...) launches on the given stream and returns the
// launch's cudaError_t as an int (0 == launched).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;           // warps of a block
constexpr int MAX_SPLIT = 8;               // blocks of a cluster (portable maximum)
constexpr int RING_BUDGET = 200 * 1024;    // bytes of shared memory for the ring, at most
constexpr float MASKED = -1e30f;           // the Pallas kernel's mask value

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) {
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// The shared memory of a block: its merged state (m [G], l [G], acc [G][DH],
// read by the cluster), then the ring of K and V tiles, over which the
// parts' states (m, l, weight [NP][G], acc [NP][G][DH]) are merged at the end.
template <int G, int DH, int NP, int RING_BYTES> struct Smem {
    static constexpr int STATE_FLOATS = (2 * G + G * DH + 3) / 4 * 4;
    static constexpr int MERGE_BYTES = NP * G * (3 + DH) * 4;
    static constexpr int BYTES = STATE_FLOATS * 4 + cmax(RING_BYTES, MERGE_BYTES);
};

// This block's cache positions [start, end) (kernel.py split_rows).
__device__ __forceinline__ void block_rows(const int* valid_len, int b, int L, int S, int rank,
                                           int& start, int& end) {
    const int valid = min(max(valid_len[b], 0), L);
    const int per = (valid + S - 1) / S;
    start = min(rank * per, valid);
    end = min(start + per, valid);
}

// Merge NP parts' states in `work` (m, l in log2 units; acc unnormalised):
// common max, then weighted sums, into the block's state `blk`.
template <int G, int DH, int NP>
__device__ __forceinline__ void block_merge(float* work, float* blk) {
    const float* sm_m = work;             // [NP][G]
    const float* sm_l = sm_m + NP * G;    // [NP][G]
    float* sm_w = work + 2 * NP * G;      // [NP][G]
    const float* sm_acc = sm_w + NP * G;  // [NP][G][DH]
    const int tid = threadIdx.x;
    for (int e = tid; e < NP * G; e += THREADS) {
        const int g = e % G;
        float mx = MASKED;
        for (int j = 0; j < NP; ++j) mx = fmaxf(mx, sm_m[j * G + g]);
        sm_w[e] = exp2f(sm_m[e] - mx);
    }
    __syncthreads();
    for (int e = tid; e < G * DH; e += THREADS) {
        const int g = e / DH;
        float a = 0.f;
        for (int r = 0; r < NP; ++r) a = fmaf(sm_acc[r * G * DH + e], sm_w[r * G + g], a);
        blk[2 * G + e] = a;
    }
    for (int g = tid; g < G; g += THREADS) {
        float mx = MASKED, ls = 0.f;
        for (int r = 0; r < NP; ++r) {
            mx = fmaxf(mx, sm_m[r * G + g]);
            ls = fmaf(sm_l[r * G + g], sm_w[r * G + g], ls);
        }
        blk[g] = mx;
        blk[G + g] = ls;
    }
}

// After every block of the cluster has its state in `blk`: block `rank` merges
// outputs [e0, e1) of this (b, kv head) over the cluster, in rank order, with
// every block's (m, l, acc) loaded before the merge starts.  `o` is this
// (b, kv head)'s [G][DH] of out (h = kvh * G + g: the G heads are contiguous).
// A block of its own (launched with no cluster) writes its state as it is.
template <typename T, int G, int DH>
__device__ __forceinline__ void cluster_merge(float* blk, T* __restrict__ o) {
    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    if (S == 1) {
        __syncthreads();
        for (int e = threadIdx.x; e < G * DH; e += THREADS)
            o[e] = narrow<T>(blk[2 * G + e] / fmaxf(blk[G + e / DH], 1e-30f));
        return;
    }
    cluster.sync();
    const float* peer[MAX_SPLIT];
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) peer[j] = j < S ? cluster.map_shared_rank(blk, j) : blk;
    const int e0 = rank * G * DH / S, e1 = (rank + 1) * G * DH / S;
    for (int e = e0 + (int)threadIdx.x; e < e1; e += THREADS) {
        const int g = e / DH;
        float mj[MAX_SPLIT], lj[MAX_SPLIT], aj[MAX_SPLIT];
#pragma unroll
        for (int j = 0; j < MAX_SPLIT; ++j)
            if (j < S) {
                mj[j] = peer[j][g];
                lj[j] = peer[j][G + g];
                aj[j] = peer[j][2 * G + e];
            }
        float mx = MASKED;
#pragma unroll
        for (int j = 0; j < MAX_SPLIT; ++j)
            if (j < S) mx = fmaxf(mx, mj[j]);
        float ls = 0.f, a = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_SPLIT; ++j)
            if (j < S) {
                const float w = exp2f(mj[j] - mx);
                ls = fmaf(lj[j], w, ls);
                a = fmaf(aj[j], w, a);
            }
        o[e] = narrow<T>(a / fmaxf(ls, 1e-30f));
    }
    cluster.sync();  // no block leaves while another reads its state
}

// ---- bf16: tensor cores ---------------------------------------------------

template <int DH, int G> struct MmaLayout {
    static constexpr int TR = 16 * NW;      // positions per tile: 16 per warp
    static constexpr int LD = DH + 8;       // shared row (bf16), padded 16 B for ldmatrix
    static constexpr int TILE = TR * LD;    // elements of a K (or V) tile
    static constexpr int STAGE_BYTES = 2 * TILE * 2;
    static constexpr int STAGES = cmax(2, cmin(4, RING_BUDGET / STAGE_BYTES));
    static constexpr int CPR = DH * 2 / 16; // 16-byte chunks per cache row
    static constexpr bool HI = G > 8;       // heads 8.. fill rows 8..15 of the A operand
    using Sm = Smem<G, DH, NW, STAGES * STAGE_BYTES>;
    static_assert(G <= 16 && DH % 16 == 0, "head h is row h of the 16-row A operand");
};

template <int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ valid_len,
                       bf16* __restrict__ out, int L, int Hkv, float scale_log2) {
    using Lay = MmaLayout<DH, G>;
    constexpr int TR = Lay::TR, LD = Lay::LD, STAGES = Lay::STAGES, CPR = Lay::CPR;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* blk = reinterpret_cast<float*>(smem_raw);
    float* work = blk + Lay::Sm::STATE_FLOATS;
    bf16* ring = reinterpret_cast<bf16*>(work);  // [STAGES][K, V][TR][LD]

    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row (head) and column pair
    int start, end;
    block_rows(valid_len, b, L, S, rank, start, end);
    const int n_tiles = (end - start + TR - 1) / TR;

    // Q as the A operand, one per 16 dims: row r is head r (zero for r >= G);
    // qa[kk][0..1] are row g (dims 2t, 2t + 8), qa[kk][2..3] row g + 8, which
    // is zero, and left out of the registers, where G <= 8
    constexpr bool HI = Lay::HI;
    const bf16* qp = q + ((long long)b * Hkv + kvh) * G * DH;
    const bool lo_ok = g < G, hi_ok = HI && g + 8 < G;
    uint32_t qa[DH / 16][HI ? 4 : 2];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
        const bf16* p = qp + g * DH + kk * 16 + 2 * t;
        qa[kk][0] = lo_ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        qa[kk][1] = lo_ok ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
        if constexpr (HI) {
            qa[kk][2] = hi_ok ? *reinterpret_cast<const uint32_t*>(p + 8 * DH) : 0u;
            qa[kk][3] = hi_ok ? *reinterpret_cast<const uint32_t*>(p + 8 * DH + 8) : 0u;
        }
    }
    // this thread's state for head g (m, l; the O fragments' dims d * 8 + 2t,
    // + 1 in acc[d][0..1]) and, where G > 8, head g + 8 (m_hi, l_hi; acc[d][2..3])
    float m = MASKED, l = 0.f, m_hi = MASKED, l_hi = 0.f;
    float acc[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

    const long long row = (long long)Hkv * DH;  // elements from one position to the next
    const long long base = ((long long)b * L * Hkv + kvh) * DH;
    auto load_tile = [&](int tile, int stage) {
        bf16* ks = ring + stage * 2 * Lay::TILE;
        bf16* vs = ks + Lay::TILE;
        const int t0 = start + tile * TR;
        for (int c = tid; c < TR * CPR; c += THREADS) {
            const int r = c / CPR, e = (c % CPR) * 8;
            const bool ok = t0 + r < end;
            const long long off = base + (ok ? t0 + r : start) * row + e;
            cp_async16(ks + r * LD + e, k + off, ok);
            cp_async16(vs + r * LD + e, v + off, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_tiles) load_tile(s, s);
        cp_async_commit();
    }

    const int p0 = warp * 16;  // this warp's 16 positions of a tile
    for (int i = 0; i < n_tiles; ++i) {
        cp_async_wait<STAGES - 2>();  // tile i has landed ...
        __syncthreads();              // ... for every thread, and tile i-1 is consumed
        if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
        cp_async_commit();
        const bf16* ks = ring + (i % STAGES) * 2 * Lay::TILE;
        const bf16* vs = ks + Lay::TILE;

        // scores of positions p0 + [0, 8) and p0 + [8, 16): s[j][0..1] at
        // positions p0 + 8 j + 2t, + 1 (rows g + 8 in s[j][2..3])
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            // K rows are the B operand's columns: matrices (positions 0-7,
            // dims 0-7), (0-7, 8-15), then the same for positions 8-15
            uint32_t kb[4];
            ldmatrix_x4(kb, ks + (p0 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                                ((lane / 8) % 2) * 8);
            uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
            if constexpr (HI) {
                a[1] = qa[kk][2];
                a[3] = qa[kk][3];
            }
            mma_bf16(s[0], a, kb);
            mma_bf16(s[1], a, kb + 2);
        }
        const int pos = start + i * TR + p0 + 2 * t;
        // the online softmax of one row's scores s[j][h2], s[j][h2 + 1] (row g
        // at h2 = 0, row g + 8 at h2 = 2) -> its weights p[j][0..1]
        auto row_softmax = [&](int h2, float& mr, float& lr, float (&p)[2][2]) {
            float mt = mr;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    s[j][h2 + e] *= scale_log2;
                    if (pos + 8 * j + e < end) mt = fmaxf(mt, s[j][h2 + e]);
                }
            // a head's 16 positions lie in the 4 lanes of its row
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
            const float corr = exp2f(mr - mt);
            mr = mt;
            lr *= corr;
#pragma unroll
            for (int d = 0; d < DH / 8; ++d) {
                acc[d][h2] *= corr;
                acc[d][h2 + 1] *= corr;
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    p[j][e] = pos + 8 * j + e < end ? exp2f(s[j][h2 + e] - mr) : 0.f;
                    lr += p[j][e];
                }
        };
        float p[2][2];
        row_softmax(0, m, l, p);
        // P as the A operand over these 16 positions: the score fragments'
        // layout is the A operand's, rounded to bf16
        uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), 0u, pack_bf16(p[1][0], p[1][1]), 0u};
        if constexpr (HI) {
            float ph[2][2];
            row_softmax(2, m_hi, l_hi, ph);
            pa[1] = pack_bf16(ph[0][0], ph[0][1]);
            pa[3] = pack_bf16(ph[1][0], ph[1][1]);
        }
#pragma unroll
        for (int d = 0; d < DH / 8; d += 2) {
            // V rows (positions) are the B operand's k, transposed by ldmatrix:
            // matrices (positions 0-7, dims d*8..), (8-15, d*8..), then dims + 8
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vs + (p0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d * 8 +
                                      (lane / 16) * 8);
            mma_bf16(acc[d], pa, vb);
            mma_bf16(acc[d + 1], pa, vb + 2);
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the warps' states into `work` (over the ring), then the block's: head h's
    // (m, l) and acc [DH] from the thread row that holds it (h2 = 0: head g,
    // h2 = 2: head g + 8)
    auto put = [&](int h, int h2, float mr, float lr) {
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        if (h < G) {
            if (t == 0) {
                work[warp * G + h] = mr;
                work[NW * G + warp * G + h] = lr;
            }
            float* sm_acc = work + 3 * NW * G + (warp * G + h) * DH;
#pragma unroll
            for (int d = 0; d < DH / 8; ++d) {
                sm_acc[d * 8 + 2 * t] = acc[d][h2];
                sm_acc[d * 8 + 2 * t + 1] = acc[d][h2 + 1];
            }
        }
    };
    put(g, 0, m, l);
    if constexpr (HI) put(g + 8, 2, m_hi, l_hi);
    __syncthreads();
    block_merge<G, DH, NW>(work, blk);
    cluster_merge<bf16, G, DH>(blk, out + ((long long)b * Hkv + kvh) * G * DH);
}

// ---- f32: CUDA cores --------------------------------------------------------

// 16-byte vectors per thread and row: the fewest that split a row of DH floats
// evenly among at most a warp of threads whose count divides the block
constexpr int vectors_per_thread(int dh) {
    int nv = 1;
    while (!(dh / 4 % nv == 0 && dh / 4 / nv <= 32 && THREADS % (dh / 4 / nv) == 0)) ++nv;
    return nv;
}

template <int DH, int G> struct SimtLayout {
    static constexpr int NV = vectors_per_thread(DH);  // 16-byte vectors per thread and row
    static constexpr int TPR = DH / (NV * 4);         // threads per cache row
    static constexpr int NG = THREADS / TPR;          // rows read side by side
    static constexpr int ROW_BYTES = DH * 4;
    static constexpr int CPR = ROW_BYTES / 16;        // 16-byte chunks per row
    static constexpr int TR = cmax(NG, cmin(64, 8192 / ROW_BYTES));  // rows per tile
    static constexpr int STAGES = 4;
    static constexpr int RPG = TR / NG;               // rows per thread group per tile
    static constexpr int UNROLL = cmin(G >= 8 ? 2 : 4, RPG);
    static constexpr int STRIDE = TPR * 4;            // from a thread's vector to its next
    using Sm = Smem<G, DH, NG, STAGES * 2 * TR * ROW_BYTES>;
    static_assert(DH % (NV * 4) == 0 && TPR >= 1 && TPR <= 32 && THREADS % TPR == 0, "rows");
    static_assert(TR % NG == 0 && RPG % UNROLL == 0, "tiles");
};

template <int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ valid_len,
                        float* __restrict__ out, int L, int Hkv, float scale_log2) {
    using Lay = SimtLayout<DH, G>;
    constexpr int NV = Lay::NV, TPR = Lay::TPR, NG = Lay::NG, TR = Lay::TR;
    constexpr int STAGES = Lay::STAGES, UNROLL = Lay::UNROLL, STRIDE = Lay::STRIDE;
    constexpr int CPR = Lay::CPR;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* blk = reinterpret_cast<float*>(smem_raw);
    float* work = blk + Lay::Sm::STATE_FLOATS;
    float* ring = work;  // [STAGES][K, V][TR][DH]

    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int grp = tid / TPR;             // which of the NG rows of a step
    const int d0 = (tid % TPR) * 4;        // this thread's dims: d0 + w * STRIDE + [0, 4)
    int start, end;
    block_rows(valid_len, b, L, S, rank, start, end);
    const int n_tiles = (end - start + TR - 1) / TR;

    float qf[G][NV * 4];
    const float* qp = q + ((long long)b * Hkv + kvh) * G * DH + d0;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int w = 0; w < NV; ++w)
            *reinterpret_cast<float4*>(qf[g] + w * 4) =
                __ldg(reinterpret_cast<const float4*>(qp + g * DH + w * STRIDE));

    float m[G], l[G], acc[G][NV * 4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m[g] = MASKED;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < NV * 4; ++i) acc[g][i] = 0.f;
    }

    const long long row = (long long)Hkv * DH;  // elements from one position to the next
    const long long base = ((long long)b * L * Hkv + kvh) * DH;
    auto load_tile = [&](int tile, int stage) {
        float* ks = ring + stage * 2 * TR * DH;
        float* vs = ks + TR * DH;
        const int t0 = start + tile * TR;
        for (int c = tid; c < TR * CPR; c += THREADS) {
            const int r = c / CPR, e = (c % CPR) * 4;
            const bool ok = t0 + r < end;
            const long long off = base + (ok ? t0 + r : start) * row + e;
            cp_async16(ks + r * DH + e, k + off, ok);
            cp_async16(vs + r * DH + e, v + off, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_tiles) load_tile(s, s);
        cp_async_commit();
    }

    // the trip counts are the block's own, so every lane reaches the shuffles
    for (int i = 0; i < n_tiles; ++i) {
        cp_async_wait<STAGES - 2>();  // tile i has landed ...
        __syncthreads();              // ... for every thread, and tile i-1 is consumed
        if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
        cp_async_commit();
        const float* ks = ring + (i % STAGES) * 2 * TR * DH;
        const float* vs = ks + TR * DH;
        const int t0 = start + i * TR;
#pragma unroll
        for (int u0 = 0; u0 < Lay::RPG; u0 += UNROLL) {
            float s[UNROLL][G];
            bool ok[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int r = (u0 + u) * NG + grp;
                ok[u] = t0 + r < end;
                float kf[NV * 4];
#pragma unroll
                for (int w = 0; w < NV; ++w)
                    *reinterpret_cast<float4*>(kf + w * 4) =
                        *reinterpret_cast<const float4*>(ks + r * DH + d0 + w * STRIDE);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    float d = 0.f;
#pragma unroll
                    for (int e = 0; e < NV * 4; ++e) d = fmaf(qf[g][e], kf[e], d);
                    s[u][g] = d;
                }
            }
            // sum the partial dots of a row's TPR threads (aligned lanes of one warp)
#pragma unroll
            for (int off = TPR / 2; off > 0; off /= 2)
#pragma unroll
                for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                    for (int g = 0; g < G; ++g)
                        s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
            // online softmax over these rows, in log2 units
#pragma unroll
            for (int g = 0; g < G; ++g) {
                float mt = m[g];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    s[u][g] *= scale_log2;
                    if (ok[u]) mt = fmaxf(mt, s[u][g]);
                }
                const float corr = exp2f(m[g] - mt);
                m[g] = mt;
                l[g] *= corr;
#pragma unroll
                for (int e = 0; e < NV * 4; ++e) acc[g][e] *= corr;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int r = (u0 + u) * NG + grp;
                float vf[NV * 4];
#pragma unroll
                for (int w = 0; w < NV; ++w)
                    *reinterpret_cast<float4*>(vf + w * 4) =
                        *reinterpret_cast<const float4*>(vs + r * DH + d0 + w * STRIDE);
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const float p = ok[u] ? exp2f(s[u][g] - m[g]) : 0.f;
                    l[g] += p;
#pragma unroll
                    for (int e = 0; e < NV * 4; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the thread groups' states into `work` (over the ring), then the block's
    if (tid % TPR == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            work[grp * G + g] = m[g];
            work[NG * G + grp * G + g] = l[g];
        }
    }
    float* sm_acc = work + 3 * NG * G;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int w = 0; w < NV; ++w)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                sm_acc[(grp * G + g) * DH + d0 + w * STRIDE + e] = acc[g][w * 4 + e];
    __syncthreads();
    block_merge<G, DH, NG>(work, blk);
    cluster_merge<float, G, DH>(blk, out + ((long long)b * Hkv + kvh) * G * DH);
}

// ---- launch ---------------------------------------------------------------

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const int* valid_len;
    void* out;
    int B, L, Hkv, G, Dh, S;
    float scale_log2;
    cudaStream_t stream;
};

// bf16 on the tensor cores, f32 on the CUDA cores
template <typename T, int DH, int G> struct Kernel;
template <int DH, int G> struct Kernel<bf16, DH, G> {
    static auto fn() { return decode_attn_mma_kernel<DH, G>; }
    static constexpr int SMEM = MmaLayout<DH, G>::Sm::BYTES;
};
template <int DH, int G> struct Kernel<float, DH, G> {
    static auto fn() { return decode_attn_simt_kernel<DH, G>; }
    static constexpr int SMEM = SimtLayout<DH, G>::Sm::BYTES;
};

template <typename T, int DH, int G>
int launch(const Args& a) {
    using K = Kernel<T, DH, G>;
    static bool smem_set = false;  // set once, before any graph capture
    if (!smem_set) {
        const cudaError_t err =
            cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.S, a.Hkv, a.B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = K::SMEM;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = a.S > 1 ? 1 : 0;  // a block of its own: no cluster to schedule
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, K::fn(), static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.valid_len, static_cast<T*>(a.out), a.L, a.Hkv,
        a.scale_log2);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, int DH>
int dispatch_group(const Args& a) {
    switch (a.G) {
        case 1: return launch<T, DH, 1>(a);
        case 2: return launch<T, DH, 2>(a);
        case 4: return launch<T, DH, 4>(a);
        case 8: return launch<T, DH, 8>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

// the catalog's other groups, at Dh 128 only: llama4-maverick 40 heads over 8
// KV heads (5), llava-next-34b 56 over 8 (7), qwen3-moe 64 over 4 (16)
template <typename T>
int dispatch_group_128(const Args& a) {
    switch (a.G) {
        case 5: return launch<T, 128, 5>(a);
        case 7: return launch<T, 128, 7>(a);
        case 16: return launch<T, 128, 16>(a);
        default: return dispatch_group<T, 128>(a);
    }
}

template <typename T>
int dispatch_head_dim(const Args& a) {
    switch (a.Dh) {
        case 16: return dispatch_group<T, 16>(a);
        case 32: return dispatch_group<T, 32>(a);
        case 64: return dispatch_group<T, 64>(a);
        case 128: return dispatch_group_128<T>(a);
        // zamba2-2.7b: 32 heads over 32 KV heads of 80
        case 80: return a.G == 1 ? launch<T, 80, 1>(a) : (int)cudaErrorInvalidValue;
        // gemma-7b: 16 heads over 16 KV heads of 256
        case 256: return a.G == 1 ? launch<T, 256, 1>(a) : (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, Hkv*G, Dh], k / v [B, L, Hkv, Dh], valid_len [B] int32, out [B, Hkv*G, Dh];
// `splits` (1..8) blocks share each (b, kv head)'s cache.  (Dh, G): Dh 16, 32, 64
// or 128 with G 1, 2, 4 or 8; Dh 80 and 256 with G 1; Dh 128 with G 5, 7 or 16.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int decode_attn(const void* q, const void* k, const void* v, const void* valid_len,
                           void* out, int B, int L, int Hkv, int G, int Dh, int splits,
                           int dtype, void* stream) {
    if (B <= 0 || L <= 0 || Hkv <= 0 || splits < 1 || splits > MAX_SPLIT)
        return (int)cudaErrorInvalidValue;
    if (B > 65535 || Hkv > 65535) return (int)cudaErrorInvalidConfiguration;
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.valid_len = static_cast<const int*>(valid_len);
    a.out = out;
    a.B = B;
    a.L = L;
    a.Hkv = Hkv;
    a.G = G;
    a.Dh = Dh;
    a.S = splits;
    a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)Dh));
    a.stream = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_head_dim<float>(a);
    if (dtype == 1) return dispatch_head_dim<bf16>(a);
    return (int)cudaErrorInvalidValue;
}
