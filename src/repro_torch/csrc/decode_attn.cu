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
// fewer bytes.  Any L works; valid_len is clamped to [0, L].
//
// What bounds it.  Memory.  At the serving path's shape (B = 8, Hkv = 8, G = 4,
// Dh = 64, bf16) one call reads 2 * B * valid * Hkv * Dh * 2 bytes of cache:
// 33.5 MB at valid = 2048, about 10 us at 3.35 TB/s, and it does some 4
// operations per element read, far below the ridge of either the CUDA cores or the
// tensor cores.  So the design spends nothing on the tensor cores and everything
// on keeping enough 16-byte loads in flight.
//
// Design (flash-decoding).  The Pallas grid walks the cache in order on one core
// and carries (m, l, acc) in VMEM from chunk to chunk.  Blocks on the card run in
// parallel and in no order, and B * Hkv = 64 blocks would leave half of the 132
// SMs idle, so the work is done in two passes:
//
//   1. split: one block of 128 threads per (split, kv head, b).  Block `split`
//      takes its share of [0, valid_len[b]), cut into gridDim.x equal pieces on
//      the device (no host sync on valid_len).  Each cache row of Dh values is
//      read by TPR = Dh / (NV * VEC) neighbouring threads with NV 16-byte loads
//      each (VEC = 4 f32 or 8 bf16; NV = 1, or 2 where one load per thread would
//      need more than a warp, as f32 at Dh = 256), so a warp reads whole rows at
//      neighbouring addresses; the block reads 128 / TPR rows side by side and
//      keeps UNROLL rows per thread group in flight.  Each thread holds the
//      [G, NV * VEC] slice of the query tile it needs and its own
//      (m, l, acc[G][NV * VEC]) in registers; the partial dot products are summed
//      with warp shuffles.  Scores are kept in log2 units
//      (scaled by log2(e) / sqrt(Dh)) so every exponential is one exp2f.  At the
//      end the thread groups' states are merged through shared memory and the
//      block writes one unnormalised (m, l, acc) per split to a workspace.
//   2. merge: one block per (b, kv head) rescales the splits' partials to their
//      common max and writes acc / max(l, 1e-30).
//
// Numbers that differ from the plain version: the sums run in another order
// (f32 agrees to about 1e-6 relative), and the softmax weights stay in f32
// where models/common.decode_attention rounds them to the cache dtype before
// P @ V (bf16 differs by that rounding).
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//              -Xcompiler -fPIC -o libdecode_attn.so decode_attn.cu
// C interface: decode_attn(...) launches both passes on the given stream and
// returns cudaGetLastError() as an int (0 == launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 128;
constexpr float MASKED = -1e30f;  // the Pallas kernel's mask value

// one 16-byte load of T, widened to f32
template <typename T> struct Vec16;
template <> struct Vec16<float> {
    static constexpr int N = 4;
    using Raw = float4;
    __device__ __forceinline__ static void widen(const Raw& r, float* f) {
        f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
    }
};
template <> struct Vec16<__nv_bfloat16> {
    static constexpr int N = 8;
    using Raw = uint4;
    __device__ __forceinline__ static void widen(const Raw& r, float* f) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 t = __bfloat1622float2(h[i]);
            f[2 * i] = t.x;
            f[2 * i + 1] = t.y;
        }
    }
};

template <typename T>
__device__ __forceinline__ typename Vec16<T>::Raw load16(const T* p) {
    return __ldg(reinterpret_cast<const typename Vec16<T>::Raw*>(p));
}

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ valid_len,
                         float* __restrict__ part_m, float* __restrict__ part_l,
                         float* __restrict__ part_acc, int L, int Hkv, float scale_log2) {
    using V = Vec16<T>;
    constexpr int VEC = V::N;
    constexpr int NV = DH / VEC > 32 ? 2 : 1;  // 16-byte loads per thread and row
    constexpr int TPR = DH / (NV * VEC);       // threads per cache row
    constexpr int NG = THREADS / TPR;          // rows read side by side
    constexpr int UNROLL = G >= 8 ? 2 : 4;     // rows in flight per thread group
    static_assert(DH % (NV * VEC) == 0 && TPR >= 1 && TPR <= 32 && THREADS % TPR == 0,
                  "rows");

    __shared__ float sm_m[NG][G];
    __shared__ float sm_l[NG][G];
    __shared__ float sm_w[NG][G];
    __shared__ float sm_acc[NG][G][DH];

    const int S = gridDim.x, split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int grp = tid / TPR;              // which of the NG rows of a step
    // this thread's dims of a row: d0 + w * TPR * VEC + [0, VEC) for w < NV
    const int d0 = (tid % TPR) * VEC;

    const int valid = min(max(valid_len[b], 0), L);
    const int per = (valid + S - 1) / S;
    const int start = min(split * per, valid);
    const int end = min(start + per, valid);

    constexpr int STRIDE = TPR * VEC;  // from one of a thread's vectors to its next
    float qf[G][NV * VEC];
    const T* qp = q + ((long long)b * Hkv + kvh) * G * DH + d0;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int w = 0; w < NV; ++w) V::widen(load16(qp + g * DH + w * STRIDE), qf[g] + w * VEC);

    float m[G], l[G], acc[G][NV * VEC];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m[g] = MASKED;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < NV * VEC; ++i) acc[g][i] = 0.f;
    }

    const long long row = (long long)Hkv * DH;  // elements from one position to the next
    const long long base = ((long long)b * L * Hkv + kvh) * DH + d0;
    const T* kp = k + base;
    const T* vp = v + base;

    // the trip count is the block's own, so every lane reaches the shuffles
    for (int t0 = start; t0 < end; t0 += NG * UNROLL) {
        typename V::Raw kr[UNROLL][NV], vr[UNROLL][NV];
        bool ok[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int t = t0 + u * NG + grp;
            ok[u] = t < end;
#pragma unroll
            for (int w = 0; w < NV; ++w) {
                kr[u][w] = ok[u] ? load16(kp + t * row + w * STRIDE) : typename V::Raw{};
                vr[u][w] = ok[u] ? load16(vp + t * row + w * STRIDE) : typename V::Raw{};
            }
        }
        float s[UNROLL][G];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            float kf[NV * VEC];
#pragma unroll
            for (int w = 0; w < NV; ++w) V::widen(kr[u][w], kf + w * VEC);
#pragma unroll
            for (int g = 0; g < G; ++g) {
                float d = 0.f;
#pragma unroll
                for (int i = 0; i < NV * VEC; ++i) d = fmaf(qf[g][i], kf[i], d);
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
        // online softmax over this step's rows, in log2 units
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
            for (int i = 0; i < NV * VEC; ++i) acc[g][i] *= corr;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            float vf[NV * VEC];
#pragma unroll
            for (int w = 0; w < NV; ++w) V::widen(vr[u][w], vf + w * VEC);
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const float p = ok[u] ? exp2f(s[u][g] - m[g]) : 0.f;
                l[g] += p;
#pragma unroll
                for (int i = 0; i < NV * VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
            }
        }
    }

    // merge the NG thread groups' states: common max, then weighted sums
    if (tid % TPR == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            sm_m[grp][g] = m[g];
            sm_l[grp][g] = l[g];
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int w = 0; w < NV; ++w)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
                sm_acc[grp][g][d0 + w * STRIDE + i] = acc[g][w * VEC + i];
    __syncthreads();
    for (int e = tid; e < NG * G; e += THREADS) {
        const int r = e / G, g = e % G;
        float mx = MASKED;
        for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][g]);
        sm_w[r][g] = exp2f(sm_m[r][g] - mx);
    }
    __syncthreads();
    const long long slot = ((long long)b * Hkv + kvh) * S + split;
    for (int e = tid; e < G * DH; e += THREADS) {
        const int g = e / DH, d = e % DH;
        float a = 0.f;
        for (int r = 0; r < NG; ++r) a = fmaf(sm_acc[r][g][d], sm_w[r][g], a);
        part_acc[slot * G * DH + e] = a;
    }
    for (int g = tid; g < G; g += THREADS) {
        float mx = MASKED, ls = 0.f;
        for (int r = 0; r < NG; ++r) {
            mx = fmaxf(mx, sm_m[r][g]);
            ls = fmaf(sm_l[r][g], sm_w[r][g], ls);
        }
        part_m[slot * G + g] = mx;
        part_l[slot * G + g] = ls;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                         const float* __restrict__ part_acc, T* __restrict__ out,
                         int S, int G, int DH) {
    const long long bh = blockIdx.x;  // b * Hkv + kvh
    const float* pm = part_m + bh * S * G;
    const float* pl = part_l + bh * S * G;
    const float* pa = part_acc + bh * S * G * DH;
    // out [B, H, Dh] with h = kvh * G + g: this (b, kvh)'s G heads are contiguous
    for (int e = threadIdx.x; e < G * DH; e += blockDim.x) {
        const int g = e / DH;
        float mx = MASKED;
        for (int s = 0; s < S; ++s) mx = fmaxf(mx, pm[s * G + g]);
        float ls = 0.f, a = 0.f;
        for (int s = 0; s < S; ++s) {
            const float w = exp2f(pm[s * G + g] - mx);
            ls = fmaf(pl[s * G + g], w, ls);
            a = fmaf(pa[(long long)s * G * DH + e], w, a);
        }
        out[bh * G * DH + e] = narrow<T>(a / fmaxf(ls, 1e-30f));
    }
}

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const int* valid_len;
    void* out;
    float* part_m;
    float* part_l;
    float* part_acc;
    int B, L, Hkv, G, Dh, S;
    float scale_log2;
    cudaStream_t stream;
};

template <typename T, int DH, int G>
int launch(const Args& a) {
    decode_attn_split_kernel<T, DH, G><<<dim3(a.S, a.Hkv, a.B), THREADS, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.valid_len, a.part_m, a.part_l, a.part_acc, a.L, a.Hkv, a.scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_attn_merge_kernel<T><<<a.B * a.Hkv, THREADS, 0, a.stream>>>(
        a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), a.S, G, DH);
    return (int)cudaGetLastError();
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

template <typename T>
int dispatch_head_dim(const Args& a) {
    switch (a.Dh) {
        case 16: return dispatch_group<T, 16>(a);
        case 32: return dispatch_group<T, 32>(a);
        case 64: return dispatch_group<T, 64>(a);
        case 128: return dispatch_group<T, 128>(a);
        // gemma-7b: 16 heads over 16 KV heads of 256
        case 256: return a.G == 1 ? launch<T, 256, 1>(a) : (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, Hkv*G, Dh], k / v [B, L, Hkv, Dh], valid_len [B] int32, out [B, Hkv*G, Dh];
// workspace: 2 * B*Hkv*splits*G + B*Hkv*splits*G*Dh floats.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int decode_attn(const void* q, const void* k, const void* v, const void* valid_len,
                           void* out, void* workspace, int B, int L, int Hkv, int G, int Dh,
                           int splits, int dtype, void* stream) {
    if (B <= 0 || L <= 0 || Hkv <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
    if (B > 65535 || Hkv > 65535 || (long long)splits * B * Hkv > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.valid_len = static_cast<const int*>(valid_len);
    a.out = out;
    const long long n = (long long)B * Hkv * splits * G;
    a.part_m = static_cast<float*>(workspace);
    a.part_l = a.part_m + n;
    a.part_acc = a.part_l + n;
    a.B = B;
    a.L = L;
    a.Hkv = Hkv;
    a.G = G;
    a.Dh = Dh;
    a.S = splits;
    a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)Dh));
    a.stream = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_head_dim<float>(a);
    if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(a);
    return (int)cudaErrorInvalidValue;
}
