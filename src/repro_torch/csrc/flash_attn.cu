// Causal or non-causal GQA flash attention, forward, for Hopper, on the
// no-grad route: models/common.flash_attention on a CUDA tensor with grad off.
//
// Replaces no TPU kernel.  The JAX package's flash_attention is plain lax (a
// lax.map over query chunks and a lax.scan over key chunks) that XLA fused on
// the TPU.  The port ran it op by op: f32 score blocks of 512 x 1024 on the
// CUDA cores, each kept in device memory through some ten elementwise passes,
// and every block above the causal diagonal computed too.  At zamba2-7b's
// prefill (B=8, L=4096, 32 heads of 224) that took 162 ms a site, 53.65% of
// the prefill's device time.
//
// What bounds it.  The tensor cores: a causal site does half of
// 4 B H L^2 Dh, 1.924 TFLOP at zamba2-7b's site, 1.95 ms at 989 TFLOP/s in
// bf16, against 0.94 GB of q, k, v and out (0.28 ms at 3.35 TB/s).  What the
// design does about it:
//
//   * S = Q K^T and O += P V run on wgmma (m64n64k16, f32 accumulation).  A
//     block of 384 threads owns 128 query rows of one (batch, head): two
//     consumer warpgroups of 64 rows each, and one producer warp that keeps
//     TMA loads of K and V tiles (64 keys x Dh) in flight through a ring of
//     STAGES stages, each completing on an mbarrier.  Q, K and V are read
//     straight from their [B, L, H, Dh] layouts through 4-d tensor maps built
//     from their strides (no permute copies); the head dim comes in 128-byte
//     swizzled chunks of 64 columns, the layout wgmma's descriptors read, and
//     a head dim that is not a multiple of 64 reads zeros past its end (the
//     map's out-of-bounds fill), which add nothing to Q K^T.
//   * S (32 f32 registers a thread), the online softmax and O (Dh rounded up
//     to 64 / 2 f32 registers a thread) stay in registers: nothing of the
//     scores reaches device memory.  P is rounded to bf16 in registers and
//     is wgmma's A operand for P V.  The producer gives its registers to the
//     consumers (setmaxnreg).
//   * Causal: a tile of keys wholly above the diagonal is never loaded or
//     computed; only the tiles the diagonal crosses (and the ragged last
//     tile of keys) are masked.  The masked score -1e30 adds exp(-1e30 - m)
//     = 0 to the plain route's sums, so skipping is exact and halves the
//     work.
//   * The grid walks heads in groups of about (SMs / query tiles), each
//     group's query tiles from the last (the longest rows) to the first:
//     the blocks in flight read the K and V of a few heads, which stay in
//     L2, and the longest rows start first.  (Blocks of many heads in flight
//     at once would each read their K and V from device memory: some 15 GB
//     a zamba2-7b site, 4.6 ms at 3.35 TB/s.)
//
// Rounding, against the plain route (models/common._flash_attention): the
// scores in f32 from bf16 Q and K (exact products, f32 sums), the scale
// folded into exp2 (scale log2 e), m and l in f32 with l summed from the f32
// P, P rounded to bf16 only as P V's operand, O in f32, divided by
// max(l, 1e-30) and rounded once to bf16.  One rounding of the plain route
// is dropped: it rounds each 1024-key chunk's P V to bf16 before adding it to
// its f32 sum, where the kernel keeps P V in f32 throughout.
//
// bf16 only.  A float32 call (the float32 checks of the program's own code)
// takes the plain route: no workload runs attention in float32, and a kernel
// of its own would share none of this one's wgmma, TMA or softmax code.
//
// Head dims 32, 64, 80, 128, 224 and 256 (each a multiple of 16, wgmma's
// depth), with V as wide as Q and K; and latent attention's split heads
// (DeepSeek-V3's MLA: Q K^T over DQK = 192, 128 no-position dims and 64 rope
// dims, P V and O over DV = 128).  The kernel is templated on <DQK, DV>: Q and
// K tiles, and Q K^T's k-steps, span DQK; V tiles, P V and O span DV, and the
// output is [B, Lq, H, DV].  Padding V to DQK would do half as much P V again
// on zeros.  A (d, d) instantiation has the constants, and so the code, it had
// when the kernel took one head dim.  Head h reads KV head h / (H / Hkv); Lq
// may differ from Lk (causal: query i sees keys 0..i, as the plain route's
// mask).
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libflash_attn.so flash_attn.cu
// C interface: flash_attn_fwd (Dh the head dim of Q and K, Dv that of V and
// the output) launches one kernel on the given stream and
// returns cudaGetLastError() as an int (0 == launched), or TMAP_ERROR plus
// the CUresult where cuTensorMapEncodeTiled refused a tensor map.  The caller checks
// shapes, the dtype, head dims, strides and alignment.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int BM = 128;        // query rows a block (2 warpgroups of 64)
constexpr int BN = 64;         // keys a K/V tile
constexpr int CW = 64;         // head-dim columns a 128-byte swizzled chunk (bf16)
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int THREADS = 384;   // warpgroups 0, 1: consumers; 2: the producer
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr float NEG = -1e30f;  // a masked score, as the plain route's
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TMAP_ERROR = 1000;

template <int DQK, int DV> struct Tile {
    static constexpr int NCH = (DQK + CW - 1) / CW;   // swizzled chunks of Q's and K's head dim
    static constexpr int NCH_V = (DV + CW - 1) / CW;  // ... of V's and O's
    static constexpr int KSTEPS = DQK / 16;           // wgmma k-steps of Q K^T
    static constexpr int Q_BYTES = NCH * BM * 128;
    static constexpr int K_BYTES = NCH * BN * 128;    // K, one stage
    static constexpr int V_BYTES = NCH_V * BN * 128;  // V, one stage
    static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
    static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
    // 1024 bytes of slack to align the swizzled tiles
    static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
    static_assert(DQK % 16 == 0 && DV % 16 == 0, "wgmma's depth is 16");
    static_assert(SMEM <= 232448, "a block has 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte swizzled operand.  K-major
// (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (sbo), k-steps of
// 32 bytes inside the row.  MN-major (V under trans-b): 8-key groups 1024
// bytes apart (sbo), 64-column chunks `lbo` apart.
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
           (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32(d)                                                                                \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define REGS32                                                                           \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) += A (64 x 16) B (16 x 64): both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC32(d)
        : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A block's (batch x head, query tile) from its place in a 1-d grid of
// BH x tiles blocks.  Heads go in groups of `group` (consecutive heads, so a
// GQA group's query heads share one), and each group's tiles run from the
// last (under a causal mask the longest rows) to the first, the group's
// heads side by side: the blocks in flight at once read the K and V of a
// few heads, which stay in L2, and the longest rows start first.
struct Place {
    int bh, tile;
};

__device__ __forceinline__ Place place(int BH, int tiles, int group) {
    const int id = blockIdx.x, per = tiles * group;
    const int g = id / per, rem = id % per;
    const int width = min(group, BH - g * group);
    return {g * group + rem % width, tiles - 1 - rem / width};
}

// Tiles of keys a block of query rows [q0, min(q0 + rows, Lq)) reads.
__device__ __forceinline__ int kv_tiles(int q0, int rows, int Lq, int Lk, int bn, int causal) {
    const int all = (Lk + bn - 1) / bn;
    const int end = min(q0 + rows, Lq);
    if (end <= q0) return 0;
    return causal ? min(all, (end - 1) / bn + 1) : all;
}

// One consumer warpgroup: 64 query rows from `row0`, over the block's n_kv
// tiles of keys (the ones past its own rows' last key only released).
template <int DQK, int DV>
__device__ __forceinline__ void consume(uint32_t q_s, uint32_t kv_s, uint32_t bars,
                                        __nv_bfloat16* __restrict__ out, int wg, int row0, int b,
                                        int h, int H, int Lq, int Lk, int n_kv, float scale_log2,
                                        int causal) {
    using T = Tile<DQK, DV>;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int ra = row0 + warp * 16 + lane / 4, rb = ra + 8;  // this thread's two rows
    const int mine = kv_tiles(row0, 64, Lq, Lk, BN, causal);
    const uint32_t q_wg = q_s + wg * 64 * 128;

    float o[T::NCH_V][32];
#pragma unroll
    for (int c = 0; c < T::NCH_V; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;

    mbar_wait(bars, 0);  // Q
    for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        const uint32_t full = bars + 8 * (1 + s), empty = bars + 8 * (1 + STAGES + s);
        mbar_wait(full, (j / STAGES) & 1);
        if (j < mine) {
            const uint32_t ks = kv_s + s * T::STAGE_BYTES, vs = ks + T::K_BYTES;
            float sc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = 0.f;
            fence_regs(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < T::KSTEPS; ++kk) {
                const uint32_t c = kk / 4, off = (kk % 4) * 32;  // chunk; 16 columns in it
                wgmma_ss(sc, sw128(q_wg + c * BM * 128 + off, 16, 1024),
                         sw128(ks + c * BN * 128 + off, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(sc);

            // the online softmax, in log2 units: sc = q.k scale log2(e)
            const int key0 = j * BN;
            const bool edge = key0 + BN > Lk || (causal && key0 + BN - 1 > row0);
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                sc[i] *= scale_log2;
                if (edge) {
                    const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
                    const int row = (i % 4) < 2 ? ra : rb;
                    if (key >= Lk || (causal && key > row)) sc[i] = NEG;
                }
            }
            float xa = NEG, xb = NEG;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                if ((i % 4) < 2) xa = fmaxf(xa, sc[i]);
                else xb = fmaxf(xb, sc[i]);
            }
            const float na = fmaxf(ma, quad_max(xa)), nb = fmaxf(mb, quad_max(xb));
            const float ca = ex2(ma - na), cb = ex2(mb - nb);
            ma = na;
            mb = nb;
            float sa = 0.f, sb = 0.f;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                if ((i % 4) < 2) {
                    sc[i] = ex2(sc[i] - na);
                    sa += sc[i];
                } else {
                    sc[i] = ex2(sc[i] - nb);
                    sb += sc[i];
                }
            }
            la = la * ca + sa;
            lb = lb * cb + sb;
            uint32_t pa[4][4];  // P in bf16: wgmma's A fragments, 16 keys each
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    pa[kk][r] = bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
            for (int c = 0; c < T::NCH_V; ++c) {
#pragma unroll
                for (int i = 0; i < 32; ++i) o[c][i] *= (i % 4) < 2 ? ca : cb;
                fence_regs(o[c]);
            }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int c = 0; c < T::NCH_V; ++c)
                    wgmma_rs(o[c], pa[kk],
                             sw128(vs + c * BN * 128 + kk * 16 * 128, BN * 128, 1024));
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int c = 0; c < T::NCH_V; ++c) fence_regs(o[c]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty);
    }

    la = quad_sum(la);
    lb = quad_sum(lb);
    const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
    const size_t row_stride = static_cast<size_t>(H) * DV;
    __nv_bfloat16* oa = out + (static_cast<size_t>(b) * Lq + ra) * row_stride + h * DV;
    __nv_bfloat16* ob = oa + 8 * row_stride;
#pragma unroll
    for (int c = 0; c < T::NCH_V; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const int col = c * CW + jj * 8 + 2 * (lane % 4);
            if (col < DV) {
                if (ra < Lq)
                    *reinterpret_cast<uint32_t*>(oa + col) =
                        bf16x2(o[c][4 * jj] * ia, o[c][4 * jj + 1] * ia);
                if (rb < Lq)
                    *reinterpret_cast<uint32_t*>(ob + col) =
                        bf16x2(o[c][4 * jj + 2] * ib, o[c][4 * jj + 3] * ib);
            }
        }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int H,
                   int Hkv, int Lq, int Lk, int BH, int tiles, int group, float scale_log2,
                   int causal) {
    using T = Tile<DQK, DV>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q: NCH chunks of BM rows
    // stage s: K (NCH chunks of BN rows), then V (NCH_V chunks of BN rows)
    const uint32_t kv_s = q_s + T::Q_BYTES;
    const uint32_t bars = kv_s + STAGES * T::STAGE_BYTES;  // Q, full[STAGES], empty[STAGES]

    const Place at = place(BH, tiles, group);
    const int b = at.bh / H, h = at.bh % H, hk = h / (H / Hkv);
    const int q0 = at.tile * BM;
    const int n_kv = kv_tiles(q0, BM, Lq, Lk, BN, causal);

    if (threadIdx.x == 0) {
        mbar_init(bars, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bars + 8 * (1 + s), 1);
            mbar_init(bars + 8 * (1 + STAGES + s), 8);  // one arrival a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 256) {
            mbar_expect_tx(bars, T::Q_BYTES);
            for (int c = 0; c < T::NCH; ++c)
                tma_load(q_s + c * BM * 128, &tq, c * CW, h, q0, b, bars);
            for (int j = 0; j < n_kv; ++j) {
                const int s = j % STAGES;
                const uint32_t full = bars + 8 * (1 + s);
                if (j >= STAGES) mbar_wait(bars + 8 * (1 + STAGES + s), (j / STAGES - 1) & 1);
                mbar_expect_tx(full, T::STAGE_BYTES);
                const uint32_t ks = kv_s + s * T::STAGE_BYTES, vs = ks + T::K_BYTES;
                for (int c = 0; c < T::NCH || c < T::NCH_V; ++c) {
                    if (c < T::NCH) tma_load(ks + c * BN * 128, &tk, c * CW, hk, j * BN, b, full);
                    if (c < T::NCH_V) tma_load(vs + c * BN * 128, &tv, c * CW, hk, j * BN, b, full);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        consume<DQK, DV>(q_s, kv_s, bars, out, wg, q0 + wg * 64, b, h, H, Lq, Lk, n_kv, scale_log2,
                    causal);
    }
}

// ------------------------------------------------------------- launch ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda that the process has loaded.
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
    }();
    return fn;
}

// A [B, L, heads, Dh] bf16 tensor (element strides sb, sl, sh; the head dim
// contiguous) as a 4-d map, boxes of CW columns x `rows` positions.
int tensor_map(CUtensorMap* map, const void* base, int B, int L, int heads, int Dh,
               long long sb, long long sl, long long sh, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return TMAP_ERROR + CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                   static_cast<cuuint64_t>(sl) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[4] = {CW, 1, static_cast<cuuint32_t>(rows), 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : TMAP_ERROR + static_cast<int>(rc);
}

// Heads a group of the grid (see place): about one block an SM in flight
// for the group's tiles.
int head_group(int BH, int tiles) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return std::max(1, std::min(BH, sms / tiles));
}

struct Args {
    const void *q, *k, *v;
    void* out;
    int B, Lq, Lk, H, Hkv;
    long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
    float scale;
    int causal;
    cudaStream_t stream;
};

template <int DQK, int DV> int launch(const Args& a) {
    CUtensorMap tq, tk, tv;
    int rc = tensor_map(&tq, a.q, a.B, a.Lq, a.H, DQK, a.sqb, a.sql, a.sqh, BM);
    if (!rc) rc = tensor_map(&tk, a.k, a.B, a.Lk, a.Hkv, DQK, a.skb, a.skl, a.skh, BN);
    if (!rc) rc = tensor_map(&tv, a.v, a.B, a.Lk, a.Hkv, DV, a.svb, a.svl, a.svh, BN);
    if (rc) return rc;
    const int smem = Tile<DQK, DV>::SMEM;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int BH = a.B * a.H, tiles = (a.Lq + BM - 1) / BM;
    flash_fwd_bf16<DQK, DV><<<BH * tiles, THREADS, smem, a.stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.H, a.Hkv, a.Lq, a.Lk, BH, tiles,
        head_group(BH, tiles), a.scale * LOG2E, a.causal);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int B,
                              int Lq, int Lk, int H, int Hkv, int Dh, int Dv, long long sqb,
                              long long sql, long long sqh, long long skb, long long skl,
                              long long skh, long long svb, long long svl, long long svh,
                              float scale, int causal, void* stream) {
    const Args a{q, k, v, out, B, Lq, Lk, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
                 scale, causal, static_cast<cudaStream_t>(stream)};
    if (Dh == 192 && Dv == 128) return launch<192, 128>(a);  // latent attention's heads
    if (Dv != Dh) return static_cast<int>(cudaErrorInvalidValue);
    switch (Dh) {
        case 32: return launch<32, 32>(a);
        case 64: return launch<64, 64>(a);
        case 80: return launch<80, 80>(a);
        case 128: return launch<128, 128>(a);
        case 224: return launch<224, 224>(a);
        case 256: return launch<256, 256>(a);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
