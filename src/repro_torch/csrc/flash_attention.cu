// Flash attention (online softmax, GQA, causal and sliding-window masks).
//
// Replaces the TPU kernel flash_attention_pallas (body _flash_kernel) in
// src/repro/kernels/flash_attention/kernel.py.  The Pallas grid
// (B, H, Lq/bq, Lkv/bkv) carries m, l and the accumulator in VMEM scratch
// across a sequential KV axis, folds GQA into the K/V index map (h // group)
// and skips fully masked blocks with pl.when, though the skipped blocks
// still occupy grid steps.
//
// Bound on an H100: at hymba-1.5b's prefill (d=64, 25 query heads over 5 KV
// heads, L=8192) a query-key pair costs 4*d operations (QK^T and PV) against
// a few bytes of q, k, v and output per pair, so the kernel is bound by
// operations.  This first version runs on the CUDA cores in float32
// (bf16 inputs are widened on load), not on the tensor cores, so its
// ceiling is the FP32 vector rate; chip_smoke.py states the bf16
// tensor-core bound beside its time.
//
// Design (simple first): one block per (query tile, KV head, batch).  The
// block holds the whole query group of that KV head (group heads x bq
// queries, bq = 256 / (lanes x group)), so each K/V tile is read from
// device memory once per group: the reuse the Pallas index map gets from
// h // group.  K and V tiles of 4096 floats each sit in shared memory;
// every thread owns one query row's slice of 32 dims (lanes = d/32
// threads per row, dot products summed with warp shuffles), with q, m, l
// and the accumulator in registers.  The KV loop runs only from the first
// key the window leaves to the last key the causal mask leaves for the
// tile's queries, so a windowed layer does O(L*W) work, not O(L^2); inside
// that range a chunk of 16 keys that no row of a warp may see is skipped
// by the whole warp.  The masks are the Pallas kernel's, from absolute
// positions (query i at q_offset + i): kpos < Lkv, causal kpos <= qpos,
// window qpos - kpos < W.  Key rows past Lkv are loaded as zeros (0*NaN
// cannot reach the accumulator), -inf is handled as the Pallas kernel's
// safe_m / corr do, and a row with l == 0 divides by 1 and gives 0.
//
// Strides: q, k, v and o are (B, heads, L, d) views with any batch, head
// and position strides and a contiguous last dim, so the model's
// (B, L, H, d) -> (B, H, L, d) views need no copy.  Each C entry returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNSUPPORTED = -1;     // no instance takes the arguments
constexpr int MAX_GRID_YZ = 65535;
constexpr int CHUNK = 16;           // keys per online-softmax update
constexpr int TILE_FLOATS = 4096;   // one K (or V) tile: 16 KB
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int bq, int Lq, int Lkv, int causal, int window,
                       int q_offset, float scale, int64_t sqb, int64_t sqh,
                       int64_t sql, int64_t skb, int64_t skh, int64_t skl,
                       int64_t svb, int64_t svh, int64_t svl, int64_t sob,
                       int64_t soh, int64_t sol) {
    constexpr int DPT = D < 32 ? D : 32;   // dims of a row one thread owns
    constexpr int TPR = D / DPT;           // threads per query row
    constexpr int NV = DPT / 4;            // float4 slices per thread
    constexpr int BKV = TILE_FLOATS / D;   // keys per tile (a multiple of 16)
    static_assert(BKV % CHUNK == 0, "tile must hold whole chunks");
    __shared__ __align__(16) float Ks[BKV * D];
    __shared__ __align__(16) float Vs[BKV * D];

    const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
    const int hk = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int tid = threadIdx.x;
    const int row = tid / TPR;
    const int lane = tid % TPR;
    const int g = row / bq;                      // head within the group
    const int q_lo = qt * bq;
    const int qi = q_lo + row % bq;
    const bool live = g < group && qi < Lq;
    const int64_t h = (int64_t)hk * group + g;
    const int qpos = q_offset + qi;

    // this thread's dims: float4 slices lane, lane + TPR, lane + 2*TPR, ...
    // so the lanes of a row read neighbouring 16 B of a shared-memory row
    float qv[DPT], acc[DPT];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int dd = 4 * (lane + TPR * c) + e;
            qv[4 * c + e] =
                live ? to_f32(q[b * sqb + h * sqh + qi * sql + dd]) : 0.f;
            acc[4 * c + e] = 0.f;
        }
    }
    float m = -INFINITY, l = 0.f;

    // the keys any row of this block may see: the causal mask ends them at
    // the tile's last query, the window starts them W-1 before its first
    const int q_hi = min(q_lo + bq, Lq) - 1;
    int kv_lo = 0, kv_hi = Lkv - 1;
    if (causal) kv_hi = min(kv_hi, q_offset + q_hi);
    if (window > 0) kv_lo = max(0, q_offset + q_lo - window + 1);

    const T* kb = k + b * skb + (int64_t)hk * skh;
    const T* vb = v + b * svb + (int64_t)hk * svh;
    for (int kv0 = kv_lo; kv0 <= kv_hi; kv0 += BKV) {
        __syncthreads();                         // previous tile consumed
        for (int e = tid; e < BKV * D; e += THREADS) {
            const int j = e / D, dd = e % D;
            const int kp = kv0 + j;
            float kx = 0.f, vx = 0.f;            // rows past Lkv stay zero
            if (kp < Lkv) {
                kx = to_f32(kb[(int64_t)kp * skl + dd]);
                vx = to_f32(vb[(int64_t)kp * svl + dd]);
            }
            Ks[e] = kx;
            Vs[e] = vx;
        }
        __syncthreads();
        const int n = min(BKV, kv_hi - kv0 + 1);
        for (int j0 = 0; j0 < n; j0 += CHUNK) {
            unsigned ok = 0u;                    // keys this row may see
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                const int kp = kv0 + j0 + j;
                const bool keep = live && kp < Lkv &&
                                  (!causal || kp <= qpos) &&
                                  (window <= 0 || qpos - kp < window);
                ok |= (unsigned)keep << j;
            }
            if (!__any_sync(FULL, ok != 0u)) continue;   // warp-uniform

            float s[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                const float* kr = Ks + (j0 + j) * D;
                float dot = 0.f;
#pragma unroll
                for (int c = 0; c < NV; ++c) {
                    const float4 kk = *reinterpret_cast<const float4*>(
                        kr + 4 * (lane + TPR * c));
                    dot = fmaf(qv[4 * c + 0], kk.x, dot);
                    dot = fmaf(qv[4 * c + 1], kk.y, dot);
                    dot = fmaf(qv[4 * c + 2], kk.z, dot);
                    dot = fmaf(qv[4 * c + 3], kk.w, dot);
                }
                s[j] = dot;
            }
#pragma unroll
            for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
                for (int j = 0; j < CHUNK; ++j)
                    s[j] += __shfl_xor_sync(FULL, s[j], off);
            }
            float mx = m;
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                s[j] = (ok >> j & 1u) ? s[j] * scale : -INFINITY;
                mx = fmaxf(mx, s[j]);
            }
            const float safe = isfinite(mx) ? mx : 0.f;
            const float corr = (m == -INFINITY) ? 0.f : expf(m - safe);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                s[j] = (ok >> j & 1u) ? expf(s[j] - safe) : 0.f;
                psum += s[j];
            }
            l = corr * l + psum;
#pragma unroll
            for (int dd = 0; dd < DPT; ++dd) acc[dd] *= corr;
            if (ok != 0u) {
#pragma unroll
                for (int j = 0; j < CHUNK; ++j) {
                    const float* vr = Vs + (j0 + j) * D;
#pragma unroll
                    for (int c = 0; c < NV; ++c) {
                        const float4 vv = *reinterpret_cast<const float4*>(
                            vr + 4 * (lane + TPR * c));
                        acc[4 * c + 0] = fmaf(s[j], vv.x, acc[4 * c + 0]);
                        acc[4 * c + 1] = fmaf(s[j], vv.y, acc[4 * c + 1]);
                        acc[4 * c + 2] = fmaf(s[j], vv.z, acc[4 * c + 2]);
                        acc[4 * c + 3] = fmaf(s[j], vv.w, acc[4 * c + 3]);
                    }
                }
            }
            m = mx;
        }
    }

    if (live) {
        const float denom = (l == 0.f) ? 1.f : l;
        T* orow = o + b * sob + h * soh + (int64_t)qi * sol;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                store_f32(orow + 4 * (lane + TPR * c) + e,
                          acc[4 * c + e] / denom);
        }
    }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Lq, int Lkv, int causal, int window,
             int q_offset, float scale, const long long* st, void* stream) {
    constexpr int TPR = D < 32 ? 1 : D / 32;
    if (Hkv < 1 || H % Hkv || B > MAX_GRID_YZ || Hkv > MAX_GRID_YZ)
        return UNSUPPORTED;
    const int group = H / Hkv;
    if (group * TPR > THREADS) return UNSUPPORTED;   // a group fills a block
    const int bq = THREADS / (TPR * group);      // queries per block
    dim3 grid((Lq + bq - 1) / bq, Hkv, B);
    flash_attention_kernel<T, D><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), group, bq, Lq, Lkv,
        causal, window, q_offset, scale, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Lq, int Lkv, int D, int causal, int window,
           int q_offset, float scale, const long long* st, void* stream) {
    switch (D) {
        case 16: return launch_d<T, 16>(q, k, v, o, B, H, Hkv, Lq, Lkv,
                                        causal, window, q_offset, scale, st,
                                        stream);
        case 32: return launch_d<T, 32>(q, k, v, o, B, H, Hkv, Lq, Lkv,
                                        causal, window, q_offset, scale, st,
                                        stream);
        case 64: return launch_d<T, 64>(q, k, v, o, B, H, Hkv, Lq, Lkv,
                                        causal, window, q_offset, scale, st,
                                        stream);
        case 128: return launch_d<T, 128>(q, k, v, o, B, H, Hkv, Lq, Lkv,
                                          causal, window, q_offset, scale,
                                          st, stream);
        case 256: return launch_d<T, 256>(q, k, v, o, B, H, Hkv, Lq, Lkv,
                                          causal, window, q_offset, scale,
                                          st, stream);
        default: return UNSUPPORTED;
    }
}

}  // namespace

// q (B, H, Lq, D), k and v (B, Hkv, Lkv, D), o like q; the strides are
// (batch, head, position) of q, k, v and o in turn, in elements.  Returns
// UNSUPPORTED, launching nothing, unless D is 16, 32, 64, 128 or 256, Hkv
// divides H, the query group fits a block (group * max(1, D / 32) <= 256)
// and B and Hkv fit the grid (<= 65535).
#define FLASH_ENTRY(NAME, T)                                                  \
    extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                        int B, int H, int Hkv, int Lq, int Lkv, int D,        \
                        int causal, int window, int q_offset, float scale,    \
                        long long sqb, long long sqh, long long sql,          \
                        long long skb, long long skh, long long skl,          \
                        long long svb, long long svh, long long svl,          \
                        long long sob, long long soh, long long sol,          \
                        void* stream) {                                       \
        const long long st[12] = {sqb, sqh, sql, skb, skh, skl,               \
                                  svb, svh, svl, sob, soh, sol};              \
        return launch<T>(q, k, v, o, B, H, Hkv, Lq, Lkv, D, causal, window,   \
                         q_offset, scale, st, stream);                        \
    }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
