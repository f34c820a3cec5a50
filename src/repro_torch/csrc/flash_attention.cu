// Flash attention (online softmax, GQA, causal and sliding-window masks).
//
// Replaces the TPU kernel flash_attention_pallas (body _flash_kernel) in
// src/repro/kernels/flash_attention/kernel.py.  The Pallas grid
// (B, H, Lq/bq, Lkv/bkv) carries m, l and the accumulator in VMEM scratch
// across a sequential KV axis, folds GQA into the K/V index map (h // group)
// and skips fully masked blocks with pl.when, though the skipped blocks
// still occupy grid steps.
//
// Bound on an H100: a query-key pair costs 4*d operations (QK^T and PV)
// against a few bytes of q, k, v and output per pair, so at every served
// prefill (d = 64 ... 256, L = 8192, hymba's 25 query heads over 5 KV heads
// to qwen2-moe's 16 over 16) the kernel is bound by operations, at the bf16
// tensor-core rate (989 TFLOP/s dense): 1.11 ms at qwen2-moe-a2.7b's
// 4 x 16 x 8192 x 128, causal.
//
// Two kernels, chosen by dtype (an explicit dispatch in the C entries):
//
// bf16 -> flash_fwd_wg_kernel<D>, FlashAttention-3's shape on Hopper's
// warpgroup products, the only way to the tensor cores' full rate; TMA
// computes the tiles' addresses, so no thread spends instructions on
// copies, and a warpgroup of its own keeps them in flight:
// - A block owns BQ = 128 query rows of one query head and runs three
//   warpgroups.  One thread of the producer warpgroup issues every TMA load
//   (cp.async.bulk.tensor.4d): Q once, then K and V tiles of BKV keys (128;
//   64 at d = 256) into two rings of STAGES stages (4 at d <= 64, 3 at 128,
//   2 at 256; 145, 225 and 193 KB of shared memory with Q), each stage with
//   a full mbarrier (expect_tx, completed by the copies' bytes) and an
//   empty one (one arrival from each consumer warp).  The producer keeps 24
//   registers, the consumers take 240 (setmaxnreg).
// - The tensor maps are 4-D, (d, L, heads, batch) at the view's own
//   strides, built on the host by cuTensorMapEncodeTiled (found through the
//   runtime: no -lcuda), so hymba's (B, L, H, d) -> (B, H, L, d) views are
//   read without a copy, and rows past Lq and Lkv arrive as TMA's zero
//   fill.  Each box is one panel of up to 64 columns, swizzled to rows of
//   SW = min(2 d, 128) bytes, which wgmma's descriptors read as they lie.
// - Two consumer warpgroups own 64 rows each.  S = Q K^T is wgmma
//   m64nBKVk16 with both operands K-major in shared memory; P is rounded to
//   bf16 in registers, as SDPA does, and is the register A operand of O +=
//   P V, whose B operand is the V tile as it lies (keys x d: MN-major, read
//   through the transpose-B immediate).  Tile j's S is issued before tile
//   j-1's P V, so its softmax runs while that product does; a K stage is
//   released once its S is done, a V stage once its P V is.  At d <= 128
//   the two warpgroups take turns issuing (FA-3's ping-pong, on named
//   barriers), so that one's softmax runs while the other's products do:
//   at d = 64 the exps of a tile take as long as its products.
// - No barrier wait sits between the fence and a tile's products, and the
//   warpgroup index is made warp-uniform (__shfl_sync), so that every
//   branch around a product is uniform as the compiler sees it: otherwise
//   ptxas serializes every wgmma (its "C7520 ... WG.AR in divergent path"
//   note), which costs 30 % at qwen2-moe's shape.
// - Online softmax in float32 registers in the exp2 domain (scale * log2 e
//   folded in); the row max and sum over the 4 lanes of a quad.  GQA reads
//   K/V of head h / group.  The grid is one block per (batch x head, q
//   tile), ordered as FA-3's L2 swizzle: the heads in chunks of whole query
//   groups whose K and V fit in 32 MB of L2, and in a chunk the longest
//   causal tiles first over the chunk's heads, so a head's q tiles find its
//   K/V tiles in L2.  Per-element masks run
//   only on the tiles that cross the diagonal, the window's first key or
//   Lkv for a warpgroup; a warpgroup waits out and releases, without a
//   product, the tiles none of its rows sees.
// - TMA needs every global base and stride on 16 bytes: the entry returns
//   UNSUPPORTED unless every pointer is 16-byte aligned and every batch,
//   head and position stride is a multiple of 8 elements (the wrapper's
//   tma_aligned, which copies such an operand once).
// - Not done: a persistent grid (a block's set-up and the wait for its
//   first tiles take 3-14 % of a warpgroup's cycles,
//   tools/flash_phase_clocks.py), 3 consumer warpgroups at d = 64, fp8.
//
// float32 -> flash_simt_kernel, the first design, on the CUDA cores: the
// tensor cores would round q, k, v to bf16 or TF32, which the float32
// tolerance of the reference (2e-4) does not admit, and no model path runs
// float32 attention.  One block per (query tile, KV head, batch) holds the
// whole query group of that KV head (group heads x bq queries, bq = 256 /
// (lanes x group)), so each K/V tile is read once per group.  K and V
// tiles of 4096 floats each sit in shared memory; every thread owns one
// query row's slice of 32 dims (lanes = d/32 threads per row, dot products
// summed with warp shuffles), with q, m, l and the accumulator in
// registers; a chunk of 16 keys that no row of a warp may see is skipped
// by the whole warp.
//
// Both: the KV loop runs only from the first key the window leaves to the
// last key the causal mask leaves for the tile's queries, so a windowed
// layer does O(L*W) work, not O(L^2).  The masks are the Pallas kernel's,
// from absolute positions (query i at q_offset + i): kpos < Lkv, causal
// kpos <= qpos, window qpos - kpos < W.  Key rows past Lkv are loaded as
// zeros (0*NaN cannot reach the accumulator), -inf is handled as the
// Pallas kernel's safe_m / corr do, and a row with l == 0 divides by 1 and
// gives 0.  q, k, v and o are (B, heads, L, d) views with any batch, head
// and position strides and a contiguous last dim, so the model's
// (B, L, H, d) -> (B, H, L, d) views need no copy.  Each C entry returns
// cudaGetLastError() of its launch.

#include <cuda.h>           // CUtensorMap and its enums only: the encoder
#include <cuda_bf16.h>      // is found at run time (no -lcuda)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int UNSUPPORTED = -1;     // no instance takes the arguments
constexpr int MAX_GRID_YZ = 65535;
// the K and V bytes a chunk of the bf16 forward's grid may keep in the
// 50 MB L2 (FlashAttention-3's figure)
constexpr long long L2_CHUNK_BYTES = 32LL << 20;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------ float32: CUDA cores

constexpr int SIMT_THREADS = 256;
constexpr int CHUNK = 16;           // keys per online-softmax update
constexpr int TILE_FLOATS = 4096;   // one K (or V) tile: 16 KB

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int group,
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
                live ? q[b * sqb + h * sqh + qi * sql + dd] : 0.f;
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

    const float* kb = k + b * skb + (int64_t)hk * skh;
    const float* vb = v + b * svb + (int64_t)hk * svh;
    for (int kv0 = kv_lo; kv0 <= kv_hi; kv0 += BKV) {
        __syncthreads();                         // previous tile consumed
        for (int e = tid; e < BKV * D; e += SIMT_THREADS) {
            const int j = e / D, dd = e % D;
            const int kp = kv0 + j;
            float kx = 0.f, vx = 0.f;            // rows past Lkv stay zero
            if (kp < Lkv) {
                kx = kb[(int64_t)kp * skl + dd];
                vx = vb[(int64_t)kp * svl + dd];
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
        // the row's log-sum-exp for the backward; 0 (finite) for a row
        // that sees no key, whose probabilities the backward masks anyway
        if (lse != nullptr && lane == 0)
            lse[(b * gridDim.y * group + h) * Lq + qi] =
                l > 0.f ? m + logf(l) : 0.f;
        float* orow = o + b * sob + h * soh + (int64_t)qi * sol;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                orow[4 * (lane + TPR * c) + e] = acc[4 * c + e] / denom;
        }
    }
}


// ------------------------------------------------ bf16: tensor cores

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes == 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, -inf -> 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}


// ------------------------------------------------ backward
//
// FlashAttention-2's backward, deterministic (no float atomics), in three
// launches: the row dots D = rowsum(dO o O); one block per (KV block, KV
// head, batch) that loops over the group's query heads and over the query
// rows the causal mask and the window leave, recomputes P = exp(S - lse)
// from the forward's log-sum-exp, and sums dV = P^T dO and
// dK = dS^T Q * scale (dS = P o (dO V^T - D)) in registers; one block per
// (query block, head, batch) that sums dQ = dS K * scale over the keys it
// needs.  Each gradient is written once.
//
// bf16 -> flash_bwd_wg_{dkdv,dq}_kernel, on Hopper's warpgroup products
// (wgmma; a redesign of the first backward, mma.sync from four warps on
// single-buffered tiles, with d / 64 column slices at d >= 128):
// - A block is three warpgroups.  dK/dV: two consumer warpgroups own 128
//   keys of one KV head, 64 each, K and V in shared memory for the block's
//   life; the producer warpgroup streams the query tiles of BQ rows (64;
//   32 at d >= 128) of each head of the group through a ring of 4 stages
//   (3 at d = 128, 2 at d = 256) -- Q, dO, lse and the row dots, by
//   cp.async, each stage's arrival and release signalled on an mbarrier --
//   so the consumers never wait on issuing a copy.  Query tiles that the causal
//   mask or the window hide from the whole block are never loaded.  The
//   producer keeps 56 registers and the consumers take 224 (setmaxnreg).
// - S^T = K Q^T and dP^T = V dO^T are wgmma products with both operands in
//   shared memory (K-major).  P^T and dS^T are rounded to bf16 in registers
//   and are the register A operand of dV += P^T dO and dK += dS^T Q, whose
//   B operand is the same dO or Q tile read MN-major (the transposed read
//   ldmatrix .trans made).  S^T and dP^T are two groups, so the exps of
//   P^T run while dP^T's products do; dV's runs while dS^T is formed.
// - A block sums every output column at d <= 128 (64 float32 accumulators
//   a thread for dK and dV at d = 64, 128 at d = 128); at d = 256 two
//   column slices of 128, each recomputing S and dP.
// - dQ: the same machinery over key tiles (64 keys; 32 at d >= 128) for
//   128 queries of one head, recomputing S and dP: 7 products a pair where
//   the bound counts 5, for a deterministic dQ without a float32 buffer.
// - Shared-memory tiles take wgmma's no-swizzle layout of 8 x 8 core
//   matrices, so every head dim (16 ... 256) uses one code path.
// - Per-element masks run only on tiles that cross the diagonal, the
//   window's edge, Lq or Lkv (a code path of their own); a warpgroup skips
//   a tile none of whose pairs it may see.  The grids put the heaviest
//   causal blocks first.
// - The row dots take 16 bytes of o and dO a thread (D / 8 threads a row).
// Registers and shared memory: every instance reports 168 registers at
// entry (384 threads a block; setmaxnreg then gives the consumers 224, the
// producer 56) and spills nothing; shared memory 98 KB at d = 64 (dK/dV;
// dQ 96 KB), 113 KB at 128, 193 KB at 256.  Measured on an H100 80GB HBM3
// at 700 W at hymba-1.5b's 8 x 25/5 x 4096 x 64 (chip_smoke.py phase 17):
// 2.25-2.28 ms with the window of 1024 and 4.21-4.29 ms full causal,
// against bounds of 0.475 and 1.086 ms, SDPA's backward about 8.2 / 3.0
// ms and the first design's 3.882 / 8.256.  The exps, the
// masks and the waits for the products do not overlap the tensor-core
// work fully, and the dQ kernel recomputes S and dP.
// float32 -> flash_bwd_simt_{dkdv,dq}_kernel on the CUDA cores (the
// checks' float32 paths): every thread owns a 16-dim slice of one key (or
// query) row, and dot products are summed over the row's threads with warp
// shuffles.
//
// Bound on an H100: 10 * d operations per unmasked (query, key) pair (S
// and dP recomputed, dV, dK, dQ), at the bf16 tensor-core rate.

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// D[row] = sum over d of dO * o, in float32; one warp a row (float32)
template <typename T>
__global__ void flash_bwd_rowdot_kernel(const T* __restrict__ o,
                                        const T* __restrict__ dO,
                                        float* __restrict__ rowdot, int H,
                                        int Lq, int D, int64_t sob,
                                        int64_t soh, int64_t sol, int64_t sdb,
                                        int64_t sdh, int64_t sdl,
                                        int64_t rows) {
    const int64_t row =
        (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;                     // the whole warp
    const int64_t qi = row % Lq, bh = row / Lq, h = bh % H, b = bh / H;
    const T* orow = o + b * sob + h * soh + qi * sol;
    const T* drow = dO + b * sdb + h * sdh + qi * sdl;
    float s = 0.f;
    for (int c = lane; c < D; c += 32)
        s = fmaf(to_f32(orow[c]), to_f32(drow[c]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) rowdot[row] = s;
}

// bf16: D / 8 threads a row, each one 16-byte piece of o and of dO (rows
// start on 16 bytes: the entry checks), summed over the row's threads
template <int D>
__global__ void flash_bwd_rowdot_bf16_kernel(const bf16* __restrict__ o,
                                             const bf16* __restrict__ dO,
                                             float* __restrict__ rowdot,
                                             int H, int Lq, int64_t sob,
                                             int64_t soh, int64_t sol,
                                             int64_t sdb, int64_t sdh,
                                             int64_t sdl, int64_t rows) {
    constexpr int TPR = D / 8;                   // threads a row (<= 32)
    const int64_t row =
        ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPR;
    const int part = threadIdx.x % TPR;
    const bool in = row < rows;
    const int64_t qi = in ? row % Lq : 0, bh = in ? row / Lq : 0;
    const int64_t h = bh % H, b = bh / H;
    float s = 0.f;
    if (in) {
        const int4 ov = *reinterpret_cast<const int4*>(
            o + b * sob + h * soh + qi * sol + part * 8);
        const int4 dv = *reinterpret_cast<const int4*>(
            dO + b * sdb + h * sdh + qi * sdl + part * 8);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 a = __bfloat1622float2(op[i]);
            const float2 c = __bfloat1622float2(dp[i]);
            s = fmaf(a.x, c.x, fmaf(a.y, c.y, s));
        }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
    if (in && part == 0) rowdot[row] = s;
}

// ---- float32 on the CUDA cores

constexpr int SB_THREADS = 128;

template <int D>
struct SimtBwd {
    static constexpr int DPT = 16;               // dims of a row a thread owns
    static constexpr int TPR = D / DPT;          // threads per row
    static constexpr int ROWS = SB_THREADS / TPR;
    static constexpr int BT = 2048 / D;          // rows of a staged tile
    static_assert(D % DPT == 0, "head dim a multiple of 16");
};

// sum over the TPR neighbouring lanes of a row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(FULL, x, off);
    return x;
}

template <int D>
__global__ void __launch_bounds__(SB_THREADS)
flash_bwd_simt_dkdv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dO,
                           const float* __restrict__ lse,
                           const float* __restrict__ rowdot,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int group, int Lq, int Lkv, int causal,
                           int window, int q_offset, float scale, int64_t sqb,
                           int64_t sqh, int64_t sql, int64_t skb, int64_t skh,
                           int64_t skl, int64_t svb, int64_t svh, int64_t svl,
                           int64_t sdb, int64_t sdh, int64_t sdl) {
    using C = SimtBwd<D>;
    constexpr int DPT = C::DPT, TPR = C::TPR, BT = C::BT;
    __shared__ __align__(16) float Qs[BT * D];
    __shared__ __align__(16) float Ds[BT * D];
    __shared__ float lse_s[BT], dot_s[BT];

    const int hk = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int tid = threadIdx.x, row = tid / TPR, lane = tid % TPR;
    const int k_lo = blockIdx.x * C::ROWS;
    const int kj = k_lo + row;
    const bool live = kj < Lkv;
    const int k_hi = min(k_lo + C::ROWS, Lkv) - 1;
    float kv[DPT], vv[DPT], dk_acc[DPT], dv_acc[DPT];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
        const int dd = lane * DPT + e;
        kv[e] = live ? k[b * skb + hk * skh + (int64_t)kj * skl + dd] : 0.f;
        vv[e] = live ? v[b * svb + hk * svh + (int64_t)kj * svl + dd] : 0.f;
        dk_acc[e] = dv_acc[e] = 0.f;
    }
    // the queries that may see any key of this block
    const int qi_lo = causal ? max(0, k_lo - q_offset) : 0;
    int qi_hi = Lq - 1;
    if (window > 0) qi_hi = min(qi_hi, k_hi + window - 1 - q_offset);

    for (int g = 0; g < group; ++g) {
        const int64_t h = (int64_t)hk * group + g;
        const float* qb = q + b * sqb + h * sqh;
        const float* db = dO + b * sdb + h * sdh;
        const float* lh = lse + (b * H + h) * Lq;
        const float* dh = rowdot + (b * H + h) * Lq;
        for (int q0 = qi_lo; q0 <= qi_hi; q0 += BT) {
            __syncthreads();                     // previous tile consumed
            for (int e = tid; e < BT * D; e += SB_THREADS) {
                const int j = e / D, dd = e % D, qi = q0 + j;
                const bool ok = qi <= qi_hi;
                Qs[e] = ok ? qb[(int64_t)qi * sql + dd] : 0.f;
                Ds[e] = ok ? db[(int64_t)qi * sdl + dd] : 0.f;
            }
            for (int j = tid; j < BT; j += SB_THREADS) {
                const bool ok = q0 + j <= qi_hi;
                lse_s[j] = ok ? lh[q0 + j] : 0.f;
                dot_s[j] = ok ? dh[q0 + j] : 0.f;
            }
            __syncthreads();
            const int n = min(BT, qi_hi - q0 + 1);
            for (int j = 0; j < n; ++j) {
                const float* qr = Qs + j * D + lane * DPT;
                const float* dr = Ds + j * D + lane * DPT;
                float s = 0.f, dp = 0.f;
#pragma unroll
                for (int e = 0; e < DPT; ++e) {
                    s = fmaf(kv[e], qr[e], s);
                    dp = fmaf(vv[e], dr[e], dp);
                }
                s = row_sum<TPR>(s);
                dp = row_sum<TPR>(dp);
                const int qpos = q_offset + q0 + j;
                const bool keep = live && (!causal || kj <= qpos) &&
                                  (window <= 0 || qpos - kj < window);
                const float p = keep ? expf(s * scale - lse_s[j]) : 0.f;
                const float ds = p * (dp - dot_s[j]) * scale;
#pragma unroll
                for (int e = 0; e < DPT; ++e) {
                    dv_acc[e] = fmaf(p, dr[e], dv_acc[e]);
                    dk_acc[e] = fmaf(ds, qr[e], dk_acc[e]);
                }
            }
        }
    }
    if (live) {
        const int64_t base = ((b * gridDim.y + hk) * Lkv + kj) * D + lane * DPT;
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
            dk[base + e] = dk_acc[e];
            dv[base + e] = dv_acc[e];
        }
    }
}

template <int D>
__global__ void __launch_bounds__(SB_THREADS)
flash_bwd_simt_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ rowdot,
                         float* __restrict__ dq, int group, int Lq, int Lkv,
                         int causal, int window, int q_offset, float scale,
                         int64_t sqb, int64_t sqh, int64_t sql, int64_t skb,
                         int64_t skh, int64_t skl, int64_t svb, int64_t svh,
                         int64_t svl, int64_t sdb, int64_t sdh, int64_t sdl) {
    using C = SimtBwd<D>;
    constexpr int DPT = C::DPT, TPR = C::TPR, BT = C::BT;
    __shared__ __align__(16) float Ks[BT * D];
    __shared__ __align__(16) float Vs[BT * D];

    const int64_t h = blockIdx.y;
    const int64_t b = blockIdx.z;
    const int64_t hk = h / group;
    const int tid = threadIdx.x, row = tid / TPR, lane = tid % TPR;
    const int q_lo = blockIdx.x * C::ROWS;
    const int qi = q_lo + row;
    const bool live = qi < Lq;
    const int qpos = q_offset + qi;
    float qv[DPT], dov[DPT], acc[DPT];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
        const int dd = lane * DPT + e;
        qv[e] = live ? q[b * sqb + h * sqh + (int64_t)qi * sql + dd] : 0.f;
        dov[e] = live ? dO[b * sdb + h * sdh + (int64_t)qi * sdl + dd] : 0.f;
        acc[e] = 0.f;
    }
    const int64_t r = (b * gridDim.y + h) * Lq + qi;
    const float lse_r = live ? lse[r] : 0.f;
    const float dot_r = live ? rowdot[r] : 0.f;

    const int q_hi = min(q_lo + C::ROWS, Lq) - 1;
    int kv_lo = 0, kv_hi = Lkv - 1;
    if (causal) kv_hi = min(kv_hi, q_offset + q_hi);
    if (window > 0) kv_lo = max(0, q_offset + q_lo - window + 1);
    const float* kb = k + b * skb + hk * skh;
    const float* vb = v + b * svb + hk * svh;
    for (int kv0 = kv_lo; kv0 <= kv_hi; kv0 += BT) {
        __syncthreads();
        for (int e = tid; e < BT * D; e += SB_THREADS) {
            const int j = e / D, dd = e % D, kp = kv0 + j;
            const bool ok = kp <= kv_hi;
            Ks[e] = ok ? kb[(int64_t)kp * skl + dd] : 0.f;
            Vs[e] = ok ? vb[(int64_t)kp * svl + dd] : 0.f;
        }
        __syncthreads();
        const int n = min(BT, kv_hi - kv0 + 1);
        for (int j = 0; j < n; ++j) {
            const float* kr = Ks + j * D + lane * DPT;
            const float* vr = Vs + j * D + lane * DPT;
            float s = 0.f, dp = 0.f;
#pragma unroll
            for (int e = 0; e < DPT; ++e) {
                s = fmaf(qv[e], kr[e], s);
                dp = fmaf(dov[e], vr[e], dp);
            }
            s = row_sum<TPR>(s);
            dp = row_sum<TPR>(dp);
            const int kp = kv0 + j;
            const bool keep = live && (!causal || kp <= qpos) &&
                              (window <= 0 || qpos - kp < window);
            const float p = keep ? expf(s * scale - lse_r) : 0.f;
            const float ds = p * (dp - dot_r) * scale;
#pragma unroll
            for (int e = 0; e < DPT; ++e) acc[e] = fmaf(ds, kr[e], acc[e]);
        }
    }
    if (live) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) dq[r * D + lane * DPT + e] = acc[e];
    }
}

// ---- bf16 on the tensor cores: Hopper's warpgroup products (wgmma)

// Operands in shared memory take wgmma's no-swizzle canonical layout: 8 x 8
// core matrices, each 8 rows of 16 contiguous bytes.  A tile of R rows x D
// columns holds core matrix (row group rg, column group cg) at byte
// (rg * D/8 + cg) * 128.  Read with the contraction along its columns
// (K-major) a tile's descriptor has LBO = 128 bytes (the next 8 columns)
// and SBO = 16 D (the next 8 rows); read with the contraction along its
// rows (MN-major: Q, dO or K as the B operand of the second products)
// LBO = 16 D (the next 8 rows) and SBO = 128 (the next 8 columns).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
    return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
           (uint64_t)(sbo >> 4) << 32;
}
// element offset of the 16-byte chunk (row r, column group cg) of a tile
// with CG column groups
__device__ __forceinline__ int cm_off(int r, int cg, int CG) {
    return ((r >> 3) * CG + cg) * 64 + (r & 7) * 8;
}
__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving registers an in-flight wgmma reads or
// writes
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void hold(uint32_t (&r)[M][N]) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// cp.async's writes, seen by the tensor cores' (async proxy) reads
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 4-byte global -> shared copy of the first `bytes` bytes, zeros after
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
}

// d (64 x N, float32) = (acc ? d : 0) + A (64 x 16) B (16 x N), both
// operands K-major in shared memory
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
// d += A (64 x 16, bf16 fragments in registers) B (16 x N, MN-major in
// shared memory)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// rows [r0, r0 + R) of a row-major matrix (row stride ld, D columns) into
// a core-matrix tile; rows at or past lim are zeros.  A warp's 32 chunks
// fill 4 whole core matrices.  Not unrolled: the producer that runs it
// holds few registers.
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int64_t ld, int r0, int lim,
                                          int tid) {
    constexpr int CG = D / 8;
#pragma unroll 1
    for (int i = 0; i < (R * CG + NT - 1) / NT; ++i) {
        const int e = tid + i * NT;
        if (R * CG % NT != 0 && e >= R * CG) break;
        const int rg = e / (8 * CG), rem = e % (8 * CG);
        const int cg = rem >> 3, r = rg * 8 + (rem & 7);
        const bool ok = r0 + r < lim;
        cp_async16(smem_addr(tile + cm_off(r, cg, CG)),
                   ok ? src + (int64_t)(r0 + r) * ld + cg * 8 : src,
                   ok ? 16 : 0);
    }
}

// P and dS in bf16 as the A fragments of the second products: k-step kk
// takes accumulator columns 16 kk .. 16 kk + 15
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4],
                                         const float (&x)[N / 2]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int D>
struct WgBwd {
    // two consumer warpgroups, then a producer warpgroup that issues every
    // copy into the shared-memory ring and hands its registers to the
    // consumers (setmaxnreg: 2 x 128 x 224 + 128 x 56 <= 65,536)
    static constexpr int CONSUMERS = 256;
    static constexpr int PRODUCERS = 128;
    static constexpr int THREADS = CONSUMERS + PRODUCERS;
    static constexpr int DS = D <= 128 ? D : 128;  // output columns a block
    static constexpr int NS = D / DS;              // column slices
    static constexpr int STAGES = D <= 64 ? 4 : D <= 128 ? 3 : 2;
    // dK/dV: BKV keys a block (64 a warpgroup), query tiles of BQ rows
    static constexpr int BKV = 128;
    static constexpr int BQ = D <= 64 ? 64 : 32;
    static constexpr int KV = BKV * D;             // elements of K (or V)
    static constexpr int QT = BQ * D;              // of a Q (or dO) tile
    static constexpr int STAGE = 4 * QT + 8 * BQ;  // bytes: Q, dO, lse, D
    static constexpr int BARS = 8 * (2 * STAGES + 1);   // mbarriers, bytes
    static constexpr int SMEM = 4 * KV + STAGES * STAGE + BARS;
    // dQ: QB queries a block (64 a warpgroup), key tiles of BK rows
    static constexpr int QB = 128;
    static constexpr int BK = D <= 64 ? 64 : 32;
    static constexpr int KT = BK * D;
    static constexpr int SMEM_DQ = 4 * QB * D + STAGES * 4 * KT + BARS;
};

template <int N>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// mbarriers: the ring's stages are full (the producer's copies landed) or
// empty (every consumer warp is done with them)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
}
// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_addr(bar))
                 : "memory");
}

template <int D>
__global__ void __launch_bounds__(WgBwd<D>::THREADS, 1)
flash_bwd_wg_dkdv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ rowdot,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Hkv, int group, int Lq, int Lkv, int causal,
                         int window, int q_offset, float scale,
                         float scale_log2, int64_t sqb, int64_t sqh,
                         int64_t sql, int64_t skb, int64_t skh, int64_t skl,
                         int64_t svb, int64_t svh, int64_t svl, int64_t sdb,
                         int64_t sdh, int64_t sdl) {
    using C = WgBwd<D>;
    constexpr int BQ = C::BQ, DS = C::DS, STAGES = C::STAGES;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + C::KV;
    unsigned char* ring = smem + 4 * C::KV;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
    uint64_t* empty = full + STAGES;
    uint64_t* kv_full = empty + STAGES;
    auto Qs = [&](int st) {
        return reinterpret_cast<bf16*>(ring + st * C::STAGE);
    };
    auto Os = [&](int st) { return Qs(st) + C::QT; };
    auto Ls = [&](int st) { return reinterpret_cast<float*>(Os(st) + C::QT); };
    auto Rs = [&](int st) { return Ls(st) + BQ; };

    const int hk = blockIdx.x / C::NS;
    const int c0 = (blockIdx.x % C::NS) * DS;      // first output column
    const int64_t b = blockIdx.y;
    const int k_lo = blockIdx.z * C::BKV;          // causal: heaviest first
    const int k_hi = min(k_lo + C::BKV, Lkv) - 1;
    const int tid = threadIdx.x, lane = tid & 31;
    // the query tiles in which some query may see a key of this block: the
    // others are never loaded
    const int qi_lo = causal ? max(0, k_lo - q_offset) : 0;
    int qi_hi = Lq - 1;
    if (window > 0) qi_hi = min(qi_hi, k_hi + window - 1 - q_offset);
    const int qt_lo = qi_lo / BQ;
    const int nqt = qi_hi >= qi_lo ? qi_hi / BQ - qt_lo + 1 : 0;
    const int ntiles = group * nqt;                // over the group's heads

    if (tid == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(&full[st], C::PRODUCERS);    // the producer's threads
            mbar_init(&empty[st], C::CONSUMERS / 32);   // consumer warps
        }
        mbar_init(kv_full, C::PRODUCERS);
    }
    __syncthreads();

    // the role, uniform over each warpgroup as the compiler can see (the
    // register counts of setmaxnreg hold per warpgroup)
    if (__shfl_sync(FULL, tid / 128, 0) == C::CONSUMERS / 128) {
        // the producer warpgroup: K and V, then each tile into its stage
        // once the consumers have left it
        regs_dec<56>();
        const int pt = tid - C::CONSUMERS;
        load_tile<C::BKV, D, C::PRODUCERS>(
            Ks, k + b * skb + (int64_t)hk * skh, skl, k_lo, Lkv, pt);
        load_tile<C::BKV, D, C::PRODUCERS>(
            Vs, v + b * svb + (int64_t)hk * svh, svl, k_lo, Lkv, pt);
        mbar_arrive_copies(kv_full);
        for (int i = 0; i < ntiles; ++i) {
            const int st = i % STAGES, n = i / STAGES;
            if (n > 0) mbar_wait(&empty[st], (n - 1) & 1);
            const int q0 = (qt_lo + i % nqt) * BQ;
            const int64_t h = (int64_t)hk * group + i / nqt;
            load_tile<BQ, D, C::PRODUCERS>(Qs(st), q + b * sqb + h * sqh,
                                           sql, q0, Lq, pt);
            load_tile<BQ, D, C::PRODUCERS>(Os(st), dO + b * sdb + h * sdh,
                                           sdl, q0, Lq, pt);
            const float* lh = lse + (b * H + h) * Lq;
            const float* dh = rowdot + (b * H + h) * Lq;
            for (int r = pt; r < 2 * BQ; r += C::PRODUCERS) {
                const int rr = r % BQ;
                const bool ok = q0 + rr < Lq;
                cp_async4(smem_addr((r < BQ ? Ls(st) : Rs(st)) + rr),
                          (r < BQ ? lh : dh) + (ok ? q0 + rr : 0),
                          ok ? 4 : 0);
            }
            mbar_arrive_copies(&full[st]);
        }
        cp_async_wait<0>();
        return;
    }

    // the consumers: this warpgroup's 64 keys
    regs_inc<224>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int wk_lo = k_lo + wg * 64;
    const bool wg_live = wk_lo < Lkv;
    const uint32_t ka = smem_addr(Ks) + wg * 128 * D;
    const uint32_t va = smem_addr(Vs) + wg * 128 * D;
    float dk_acc[DS / 2], dv_acc[DS / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES, q0 = (qt_lo + i % nqt) * BQ;
        mbar_wait(&full[st], (i / STAGES) & 1);
        fence_async_smem();      // the copies, seen by the tensor cores
        const int qp_lo = q_offset + q0;
        const int qp_hi = q_offset + min(q0 + BQ, Lq) - 1;
        // a tile no query of which sees a key of this warpgroup is skipped
        const bool live = wg_live && !(causal && qp_hi < wk_lo) &&
                          !(window > 0 && qp_lo - (wk_lo + 63) >= window);
        const uint32_t qa = smem_addr(Qs(st)), oa = smem_addr(Os(st));
        if (live) {
            // S^T = K Q^T and dP^T = V dO^T over the full head dim, two
            // groups: the exps of P^T run while dP^T's products do
            wg_fence();
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
                wgmma_ss<BQ>(s, wg_desc(ka + kc * 256, 128, 16 * D),
                             wg_desc(qa + kc * 256, 128, 16 * D), kc);
            wg_commit();
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
                wgmma_ss<BQ>(dp, wg_desc(va + kc * 256, 128, 16 * D),
                             wg_desc(oa + kc * 256, 128, 16 * D), kc);
            wg_commit();
            // every pair of the tile visible: no per-element mask
            const bool open = q0 + BQ <= Lq && wk_lo + 64 <= Lkv &&
                              (!causal || qp_lo >= wk_lo + 63) &&
                              (window <= 0 || qp_hi - wk_lo < window);
            wg_wait<1>();
            hold(s);
            // P^T = exp2(S^T scale log2 e - lse log2 e); the per-element
            // mask only on a tile that needs it (a code path of its own)
            const float* ls = Ls(st);
            const float* rd = Rs(st);
            auto probs = [&](auto masked) {
                constexpr bool MASK = decltype(masked)::value;
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j) {
                    const float2 l2 =
                        *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = 8 * j + 2 * t + (e & 1);
                        const float lv = ((e & 1) ? l2.y : l2.x) * LOG2E;
                        const float p =
                            ex2(fmaf(s[4 * j + e], scale_log2, -lv));
                        if constexpr (MASK) {
                            const int key =
                                wk_lo + warp * 16 + g + (e >> 1) * 8;
                            const int qpos = qp_lo + col;
                            const bool keep =
                                key < Lkv && q0 + col < Lq &&
                                (!causal || key <= qpos) &&
                                (window <= 0 || qpos - key < window);
                            s[4 * j + e] = keep ? p : 0.f;
                        } else {
                            s[4 * j + e] = p;
                        }
                    }
                }
            };
            if (open)
                probs(std::false_type{});
            else
                probs(std::true_type{});
            // dV += P^T dO, while dS^T = P^T (dP^T - D) is formed; the
            // fragments hold P^T, then (dV's product done) dS^T
            uint32_t fr[BQ / 16][4];
            to_frags<BQ>(fr, s);
            hold(dv_acc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                wgmma_rs<DS>(dv_acc, fr[kk],
                             wg_desc(oa + kk * 32 * D + c0 * 16, 16 * D,
                                     128));
            wg_commit();
            wg_wait<1>();            // dP^T's group; dV's still running
            hold(dp);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
                const float2 r2 =
                    *reinterpret_cast<const float2*>(rd + 8 * j + 2 * t);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dp[4 * j + e] = s[4 * j + e] *
                                    (dp[4 * j + e] - ((e & 1) ? r2.y : r2.x));
            }
            wg_wait<0>();
            hold(dv_acc);
            hold(fr);
            to_frags<BQ>(fr, dp);
            hold(dk_acc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)
                wgmma_rs<DS>(dk_acc, fr[kk],
                             wg_desc(qa + kk * 32 * D + c0 * 16, 16 * D,
                                     128));
            wg_commit();
            wg_wait<0>();
            hold(dk_acc);
            hold(fr);
        }
        // this warp is done with the stage: the tensor cores' reads ended
        // at the wait, the threads' before it
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = wk_lo + warp * 16 + g + 8 * r;
        if (key < Lkv) {
            const int64_t base =
                ((b * Hkv + hk) * Lkv + key) * D + c0 + 2 * t;
#pragma unroll
            for (int j = 0; j < DS / 8; ++j) {
                *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
                    __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale,
                                          dk_acc[4 * j + 2 * r + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
                    __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                          dv_acc[4 * j + 2 * r + 1]);
            }
        }
    }
}

template <int D>
__global__ void __launch_bounds__(WgBwd<D>::THREADS, 1)
flash_bwd_wg_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dO,
                       const float* __restrict__ lse,
                       const float* __restrict__ rowdot,
                       bf16* __restrict__ dq, int H, int group, int Lq,
                       int Lkv, int causal, int window, int q_offset,
                       float scale, float scale_log2, int64_t sqb,
                       int64_t sqh, int64_t sql, int64_t skb, int64_t skh,
                       int64_t skl, int64_t svb, int64_t svh, int64_t svl,
                       int64_t sdb, int64_t sdh, int64_t sdl) {
    using C = WgBwd<D>;
    constexpr int BK = C::BK, DS = C::DS, STAGES = C::STAGES;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Os = Qs + C::QB * D;
    bf16* ring = Os + C::QB * D;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * C::KT);
    uint64_t* empty = full + STAGES;
    uint64_t* q_full = empty + STAGES;
    auto Ks = [&](int st) { return ring + st * 2 * C::KT; };
    auto Vs = [&](int st) { return Ks(st) + C::KT; };

    const int64_t h = blockIdx.x / C::NS;
    const int c0 = (blockIdx.x % C::NS) * DS;
    const int64_t b = blockIdx.y;
    const int64_t hk = h / group;
    const int q_lo = (gridDim.z - 1 - blockIdx.z) * C::QB;   // last first
    const int q_hi = min(q_lo + C::QB, Lq) - 1;
    const int tid = threadIdx.x, lane = tid & 31;
    // the key tiles some query of this block may see
    int kv_lo = 0, kv_hi = Lkv - 1;
    if (causal) kv_hi = min(kv_hi, q_offset + q_hi);
    if (window > 0) kv_lo = max(0, q_offset + q_lo - window + 1);
    const int kt_lo = kv_lo / BK;
    const int nkt = kv_hi >= kv_lo ? kv_hi / BK - kt_lo + 1 : 0;

    if (tid == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(&full[st], C::PRODUCERS);
            mbar_init(&empty[st], C::CONSUMERS / 32);
        }
        mbar_init(q_full, C::PRODUCERS);
    }
    __syncthreads();

    // the producer warpgroup, as in the dK/dV kernel
    if (__shfl_sync(FULL, tid / 128, 0) == C::CONSUMERS / 128) {
        regs_dec<56>();
        const int pt = tid - C::CONSUMERS;
        load_tile<C::QB, D, C::PRODUCERS>(Qs, q + b * sqb + h * sqh, sql,
                                          q_lo, Lq, pt);
        load_tile<C::QB, D, C::PRODUCERS>(Os, dO + b * sdb + h * sdh, sdl,
                                          q_lo, Lq, pt);
        mbar_arrive_copies(q_full);
        const bf16* kb = k + b * skb + hk * skh;
        const bf16* vb = v + b * svb + hk * svh;
        for (int i = 0; i < nkt; ++i) {
            const int st = i % STAGES, n = i / STAGES;
            if (n > 0) mbar_wait(&empty[st], (n - 1) & 1);
            const int kv0 = (kt_lo + i) * BK;
            load_tile<BK, D, C::PRODUCERS>(Ks(st), kb, skl, kv0, Lkv, pt);
            load_tile<BK, D, C::PRODUCERS>(Vs(st), vb, svl, kv0, Lkv, pt);
            mbar_arrive_copies(&full[st]);
        }
        cp_async_wait<0>();
        return;
    }

    // the consumers: this warpgroup's 64 queries; this thread's rows g and
    // g + 8
    regs_inc<224>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int wq_lo = q_lo + wg * 64;
    const bool wg_live = wq_lo < Lq;
    const int wp_lo = q_offset + wq_lo;
    const int wp_hi = q_offset + min(wq_lo + 64, Lq) - 1;
    float lse2[2], dot[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = wq_lo + warp * 16 + g + 8 * r;
        const int64_t i = (b * H + h) * Lq + qi;
        lse2[r] = qi < Lq ? lse[i] * LOG2E : 0.f;
        dot[r] = qi < Lq ? rowdot[i] : 0.f;
    }
    const uint32_t qa = smem_addr(Qs) + wg * 128 * D;
    const uint32_t oa = smem_addr(Os) + wg * 128 * D;
    float acc[DS / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int i = 0; i < nkt; ++i) {
        const int st = i % STAGES, kv0 = (kt_lo + i) * BK;
        mbar_wait(&full[st], (i / STAGES) & 1);
        fence_async_smem();
        const bool live = wg_live && !(causal && kv0 > wp_hi) &&
                          !(window > 0 && kv0 + BK - 1 <= wp_lo - window);
        const uint32_t kt = smem_addr(Ks(st)), vt = smem_addr(Vs(st));
        if (live) {
            // S = Q K^T and dP = dO V^T over the full head dim, two groups:
            // the exps of P run while dP's products do
            wg_fence();
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
                wgmma_ss<BK>(s, wg_desc(qa + kc * 256, 128, 16 * D),
                             wg_desc(kt + kc * 256, 128, 16 * D), kc);
            wg_commit();
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc)
                wgmma_ss<BK>(dp, wg_desc(oa + kc * 256, 128, 16 * D),
                             wg_desc(vt + kc * 256, 128, 16 * D), kc);
            wg_commit();
            const bool open = wq_lo + 64 <= Lq && kv0 + BK <= Lkv &&
                              (!causal || kv0 + BK - 1 <= wp_lo) &&
                              (window <= 0 || wp_hi - kv0 < window);
            wg_wait<1>();
            hold(s);
            // P = exp2(S scale log2 e - lse log2 e); the per-element mask
            // only on a tile that needs it
            auto probs = [&](auto masked) {
                constexpr bool MASK = decltype(masked)::value;
#pragma unroll
                for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = e >> 1;
                        float p =
                            ex2(fmaf(s[4 * j + e], scale_log2, -lse2[r]));
                        if constexpr (MASK) {
                            const int qpos = wp_lo + warp * 16 + g + 8 * r;
                            const int kp = kv0 + 8 * j + 2 * t + (e & 1);
                            const bool keep =
                                qpos - q_offset < Lq && kp < Lkv &&
                                (!causal || kp <= qpos) &&
                                (window <= 0 || qpos - kp < window);
                            p = keep ? p : 0.f;
                        }
                        s[4 * j + e] = p;
                    }
            };
            if (open)
                probs(std::false_type{});
            else
                probs(std::true_type{});
            // dS = P (dP - D)
            wg_wait<0>();
            hold(dp);
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[4 * j + e] *= dp[4 * j + e] - dot[e >> 1];
            // dQ += dS K over this block's output columns
            uint32_t da[BK / 16][4];
            to_frags<BK>(da, s);
            hold(acc);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs<DS>(acc, da[kk],
                             wg_desc(kt + kk * 32 * D + c0 * 16, 16 * D,
                                     128));
            wg_commit();
            wg_wait<0>();
            hold(acc);
            hold(da);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = wq_lo + warp * 16 + g + 8 * r;
        if (qi < Lq) {
            const int64_t base = ((b * H + h) * Lq + qi) * D + c0 + 2 * t;
#pragma unroll
            for (int j = 0; j < DS / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(dq + base + 8 * j) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                          acc[4 * j + 2 * r + 1] * scale);
        }
    }
}

// ---- the bf16 forward: wgmma fed by TMA (the design in the note at the
// head of this file)

template <int D>
struct WgFwd {
    // two consumer warpgroups of 64 query rows, then a producer warpgroup
    // one thread of which issues every TMA load (setmaxnreg: 2 x 128 x 240
    // + 128 x 24 = 64,512 registers, what 384 threads of 168 hold)
    static constexpr int CONSUMERS = 256;
    static constexpr int THREADS = CONSUMERS + 128;
    static constexpr int BQ = 128;                      // query rows a block
    static constexpr int BKV = D <= 128 ? 128 : 64;     // keys a tile
    static constexpr int STAGES = D <= 64 ? 4 : D <= 128 ? 3 : 2;
    static constexpr int SW = D < 64 ? 2 * D : 128;     // bytes a tile row
    static constexpr int PCOLS = SW / 2;                // columns a panel
    static constexpr int PANELS = D / PCOLS;
    static constexpr int KSTEPS = SW / 32;              // k16 steps a row
    static constexpr int QBYTES = BQ * D * 2;
    static constexpr int KVBYTES = BKV * D * 2;         // a K (or V) tile
    static constexpr int ALIGN = 1024;                  // swizzle atoms
    static constexpr int BARS = 8 * (1 + 4 * STAGES);
    // the warpgroups take turns issuing their products where the softmax
    // is long beside them (d <= 128); at d = 256 turns only add waits
    static constexpr bool TURNS = D <= 128;
    static constexpr int SMEM = ALIGN + QBYTES + 2 * STAGES * KVBYTES + BARS;
};

// wgmma's descriptor of a tile TMA wrote swizzled to rows of SW bytes (128,
// 64, 32: layout types 1, 2, 3 in bits 62-63); the tiles start on 1 KB,
// so the base offset field stays 0
template <int SW>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
    constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
    return wg_desc(addr, lbo, sbo) | mode << 62;
}
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrives on bar, which then also waits for `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map))
                 : "memory");
}
// named barriers 1 and 2: the two consumer warpgroups' turns (0 is
// __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// box (c0, c1, c2, c3) of a 4-D tensor map into shared memory at dst; the
// copy's bytes complete on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// q, k, v are read through 4-D tensor maps (d, L, heads, batch); o is
// written from registers at its (batch, head, position) strides.
template <int D>
__global__ void __launch_bounds__(WgFwd<D>::THREADS, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    bf16* __restrict__ o, float* __restrict__ lse, int BH,
                    int H, int group, int chunk, int Lq, int Lkv, int causal,
                    int window, int q_offset, float scale_log2, int64_t sob,
                    int64_t soh, int64_t sol) {
    using C = WgFwd<D>;
    constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES, SW = C::SW;
    constexpr int KS = C::KSTEPS;
    extern __shared__ unsigned char smem[];
    // Q, the K ring and the V ring from the next 1 KB boundary on, the
    // barriers after them
    const uint32_t raw = smem_addr(smem);
    const uint32_t qs = (raw + C::ALIGN - 1) & ~(uint32_t)(C::ALIGN - 1);
    const uint32_t ks = qs + C::QBYTES;
    const uint32_t vs = ks + STAGES * C::KVBYTES;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(
        smem + (vs + STAGES * C::KVBYTES - raw));
    uint64_t* k_full = q_full + 1;
    uint64_t* k_empty = k_full + STAGES;
    uint64_t* v_full = k_empty + STAGES;
    uint64_t* v_empty = v_full + STAGES;

    // this block's (batch x head, query tile), FA-3's L2 swizzle: the heads
    // in chunks of `chunk` (whole query groups) whose K and V fit in L2; in
    // a chunk the longest causal tiles first, the chunk's heads neighbours
    const int n_qt = (Lq + BQ - 1) / BQ;
    const int per = chunk * n_qt;
    const int c0 = blockIdx.x / per * chunk, w = blockIdx.x % per;
    const int heads = min(chunk, BH - c0);
    const int bh = c0 + w % heads;
    const int h = bh % H, b = bh / H, hk = h / group;
    const int q_lo = (n_qt - 1 - w / heads) * BQ;
    const int tid = threadIdx.x;

    // the keys any row of this block may see: the causal mask ends them at
    // the tile's last query, the window starts them W-1 before its first
    const int q_hi = min(q_lo + BQ, Lq) - 1;
    int kv_lo = 0, kv_hi = Lkv - 1;
    if (causal) kv_hi = min(kv_hi, q_offset + q_hi);
    if (window > 0) kv_lo = max(0, q_offset + q_lo - window + 1);
    const int n_tiles = kv_hi >= kv_lo ? (kv_hi - kv_lo) / BKV + 1 : 0;

    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(&k_full[st], 1);                   // the producer
            mbar_init(&v_full[st], 1);
            mbar_init(&k_empty[st], C::CONSUMERS / 32);  // consumer warps
            mbar_init(&v_empty[st], C::CONSUMERS / 32);
        }
        mbar_init_fence();
    }
    __syncthreads();

    // the role, uniform over each warpgroup as the compiler can see (the
    // register counts of setmaxnreg hold per warpgroup)
    if (__shfl_sync(FULL, tid / 128, 0) == C::CONSUMERS / 128) {
        regs_dec<24>();
        if (tid == C::CONSUMERS) {
            // Q once, then each K and V tile into its stage once both
            // consumer warpgroups have left it; rows past Lq and Lkv come
            // in as TMA's zero fill
            prefetch_map(&map_q);
            prefetch_map(&map_k);
            prefetch_map(&map_v);
            mbar_expect_tx(q_full, C::QBYTES);
            for (int p = 0; p < C::PANELS; ++p)
                tma_load_4d(qs + p * BQ * SW, &map_q, q_full, p * C::PCOLS,
                            q_lo, h, b);
            for (int it = 0; it < n_tiles; ++it) {
                const int st = it % STAGES, n = it / STAGES;
                const int kv0 = kv_lo + it * BKV;
                const uint32_t kt = ks + st * C::KVBYTES;
                const uint32_t vt = vs + st * C::KVBYTES;
                if (n > 0) mbar_wait(&k_empty[st], (n - 1) & 1);
                mbar_expect_tx(&k_full[st], C::KVBYTES);
                for (int p = 0; p < C::PANELS; ++p)
                    tma_load_4d(kt + p * BKV * SW, &map_k, &k_full[st],
                                p * C::PCOLS, kv0, hk, b);
                if (n > 0) mbar_wait(&v_empty[st], (n - 1) & 1);
                mbar_expect_tx(&v_full[st], C::KVBYTES);
                for (int p = 0; p < C::PANELS; ++p)
                    tma_load_4d(vt + p * BKV * SW, &map_v, &v_full[st],
                                p * C::PCOLS, kv0, hk, b);
            }
        }
        return;
    }

    // the consumers: this warpgroup's 64 query rows; this thread's rows
    // 16 warp + g and + 8
    regs_inc<240>();
    // the warpgroup, uniform as the compiler can see, and with it every
    // bound below: a branch around a product then diverges nowhere
    const int wg = __shfl_sync(FULL, tid >> 7, 0);
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wq_lo = q_lo + wg * 64;
    const int wpos_lo = q_offset + wq_lo;
    const int wpos_hi = q_offset + min(wq_lo + 64, Lq) - 1;
    // the tiles in which this warpgroup's rows see a key: [t_lo, t_hi]
    int t_lo = 0, t_hi = n_tiles - 1;
    if (wq_lo >= Lq) {
        t_lo = n_tiles;
    } else {
        if (causal) t_hi = min(t_hi, (wpos_hi - kv_lo) / BKV);
        if (window > 0) t_lo = max(0, wpos_lo - window + 1 - kv_lo) / BKV;
    }

    float acc[D / 2], s[BKV / 2];
    uint32_t pf[BKV / 16][4];            // P of the last tile, bf16
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t qa = qs + wg * 64 * SW;
    auto release = [&](uint64_t* bar) {  // this warp is done with a stage
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
    };
    // FA-3's ping-pong: every tile is a turn of each warpgroup, and the two
    // take turns issuing their products (warpgroup 0 first), so that one's
    // softmax runs while the other's products do; a turn is waited for on
    // the warpgroup's named barrier and handed on to the other's
    auto turn_wait = [&]() {
        if (C::TURNS) bar_sync(1 + wg, C::CONSUMERS);
    };
    auto turn_end = [&](int it) {        // warpgroup 1's last is not taken
        if (C::TURNS && (wg == 0 || it + 1 < n_tiles))
            bar_arrive(2 - wg, C::CONSUMERS);
    };
    auto pass = [&](int it) {            // a tile no row here sees
        const int st = it % STAGES, par = (it / STAGES) & 1;
        turn_wait();
        turn_end(it);
        mbar_wait(&k_full[st], par);
        release(&k_empty[st]);
        mbar_wait(&v_full[st], par);
        release(&v_empty[st]);
    };
    // O += P V over the V tile in stage st: V as it lies, keys x d, is
    // MN-major for wgmma (LBO the next panel of columns, SBO 8 keys)
    auto pv = [&](int st) {
        const uint32_t vt = vs + st * C::KVBYTES;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
            wgmma_rs<D>(acc, pf[kk],
                        sw_desc<SW>(vt + kk * 16 * SW, BKV * SW, 8 * SW));
        wg_commit();
    };

    // one live tile: S = Q K^T issued, then (PEND) the last tile's P V
    // behind it on the tensor cores, so that this tile's softmax runs while
    // that product does.  Both barrier waits come before the fence, and
    // every branch around a product is uniform as the compiler sees it:
    // ptxas serializes the products of a stage a divergent path crosses.
    auto tile = [&](int it, auto pend) {
        constexpr bool PEND = decltype(pend)::value;
        const int st = it % STAGES, kv0 = kv_lo + it * BKV;
        const int sp = (it + STAGES - 1) % STAGES;   // the last tile's stage
        const uint32_t kt = ks + st * C::KVBYTES;
        mbar_wait(&k_full[st], (it / STAGES) & 1);
        if constexpr (PEND) mbar_wait(&v_full[sp], ((it - 1) / STAGES) & 1);
        turn_wait();
        // both K-major: a k16 step moves 32 bytes along a row, 4 steps a
        // 128-byte panel
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
            wgmma_ss<BKV>(
                s,
                sw_desc<SW>(qa + kc / KS * BQ * SW + kc % KS * 32, 16, 8 * SW),
                sw_desc<SW>(kt + kc / KS * BKV * SW + kc % KS * 32, 16,
                            8 * SW),
                kc);
        wg_commit();
        if constexpr (PEND) pv(sp);
        turn_end(it);
        wg_wait<PEND ? 1 : 0>();         // S is done; P V runs on
        hold(s);
        release(&k_empty[st]);
        // masks, only where the tile crosses an edge for this warpgroup
        const bool edge = kv0 + BKV > Lkv ||
                          (causal && kv0 + BKV - 1 > wpos_lo) ||
                          (window > 0 && kv0 <= wpos_hi - window);
        if (edge) {
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qpos = wpos_lo + warp * 16 + g + (e >> 1) * 8;
                    const int kp = kv0 + 8 * j + 2 * t + (e & 1);
                    const bool keep = kp < Lkv && (!causal || kp <= qpos) &&
                                      (window <= 0 || qpos - kp < window);
                    if (!keep) s[4 * j + e] = -INFINITY;
                }
        }
        // online softmax in the exp2 domain; accumulator element 4 j +
        // 2 r + e is row 16 warp + g + 8 r, column 8 j + 2 t + e
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j)
                mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            const float m_new = fmaxf(m_run[r], mx * scale_log2);
            const float safe = m_new == -INFINITY ? 0.f : m_new;
            corr[r] = ex2(m_run[r] - safe);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
                for (int e = 2 * r; e < 2 * r + 2; ++e) {
                    const float p = ex2(fmaf(s[4 * j + e], scale_log2, -safe));
                    s[4 * j + e] = p;
                    sum += p;
                }
            l_run[r] = corr[r] * l_run[r] + sum;
            m_run[r] = m_new;
        }
        if constexpr (PEND) {
            wg_wait<0>();
            hold(acc);
            hold(pf);
            release(&v_empty[sp]);
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
        to_frags<BKV>(pf, s);            // P rounded to bf16, as SDPA does
    };

    mbar_wait(q_full, 0);                // every TMA load is waited for
    if (C::TURNS && wg == 1 && n_tiles > 0) bar_arrive(1, C::CONSUMERS);
    for (int it = 0; it < min(t_lo, n_tiles); ++it) pass(it);
    if (t_lo <= t_hi) {
        tile(t_lo, std::false_type{});
        for (int it = t_lo + 1; it <= t_hi; ++it) tile(it, std::true_type{});
        // the last tile's P V
        const int sp = t_hi % STAGES;
        mbar_wait(&v_full[sp], (t_hi / STAGES) & 1);
        wg_fence();
        pv(sp);
        wg_wait<0>();
        hold(acc);
        hold(pf);
        release(&v_empty[sp]);
    }
    for (int it = max(t_hi + 1, t_lo); it < n_tiles; ++it) pass(it);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        const float inv = l == 0.f ? 1.f : 1.f / l;
        const int qi = wq_lo + warp * 16 + g + 8 * r;
        if (qi < Lq) {
            // log-sum-exp in natural units (m is in the exp2 domain); 0
            // (finite) for a row that sees no key
            if (lse != nullptr && t == 0)
                lse[((int64_t)b * H + h) * Lq + qi] =
                    l > 0.f ? (m_run[r] + log2f(l)) * LN2 : 0.f;
            bf16* orow = o + b * sob + h * soh + (int64_t)qi * sol + 2 * t;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                          acc[4 * j + 2 * r + 1] * inv);
        }
    }
}

// ------------------------------------------------ launches and entries

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

struct FwdArgs {
    const void *q, *k, *v;
    void* o;
    float* lse;                  // NULL: no log-sum-exp
    int B, H, Hkv, Lq, Lkv, causal, window, q_offset;
    float scale;
    long long st[12];            // (batch, head, position) of q, k, v, o
    void* stream;
};

struct BwdArgs {
    const void *q, *k, *v, *o, *dO;
    const float* lse;
    void *dq, *dk, *dv;
    float* rowdot;               // (B, H, Lq) scratch
    int B, H, Hkv, Lq, Lkv, causal, window, q_offset;
    float scale;
    long long st[15];            // (batch, head, position) of q, k, v, o, dO
    void* stream;
};

template <int D>
int launch_simt(const FwdArgs& a) {
    constexpr int TPR = D < 32 ? 1 : D / 32;
    if (a.B > MAX_GRID_YZ || a.Hkv > MAX_GRID_YZ) return UNSUPPORTED;
    const int group = a.H / a.Hkv;
    if (group * TPR > SIMT_THREADS) return UNSUPPORTED;   // group fills a block
    const int bq = SIMT_THREADS / (TPR * group);          // queries per block
    const long long* st = a.st;
    dim3 grid((a.Lq + bq - 1) / bq, a.Hkv, a.B);
    flash_simt_kernel<D>
        <<<grid, SIMT_THREADS, 0, (cudaStream_t)a.stream>>>(
            static_cast<const float*>(a.q), static_cast<const float*>(a.k),
            static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
            group, bq, a.Lq, a.Lkv, a.causal, a.window, a.q_offset, a.scale,
            st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
            st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

// dynamic shared memory above 48 KB: set once per kernel instance
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
    if (done) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done = e == cudaSuccess;
    return e;
}

// cuTensorMapEncodeTiled, from the driver through the runtime: the library
// links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a bf16 (B, heads, L, D) operand with a contiguous last dim and
// (batch, head, position) strides st, in elements, as a 4-D map (D, L,
// heads, B) of boxes of SW / 2 columns x rows, swizzled to rows of SW
// bytes; rows past L read as zeros.  A dim of extent 1 comes with stride
// 0 (never stepped): the map gets the row's bytes there.
template <int SW>
bool encode_4d(EncodeTiled enc, CUtensorMap* map, const void* base, int D,
               int L, int heads, int B, const long long* st, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L,
                                (cuuint64_t)heads, (cuuint64_t)B};
    auto bytes = [&](int extent, long long s) {
        return (cuuint64_t)(extent > 1 ? s : D) * 2;
    };
    const cuuint64_t strides[3] = {bytes(L, st[2]), bytes(heads, st[1]),
                                   bytes(B, st[0])};
    const cuuint32_t box[4] = {SW / 2, (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle =
        SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA can address, and o's bf16 pairs need: every pointer on 16
// bytes, every (batch, head, position) stride a multiple of 8 elements.
// The wrapper applies the same rule (tma_aligned in
// kernels/flash_attention/ops.py) and copies an operand that fails it.
bool tma_aligned(const FwdArgs& a) {
    const void* ptrs[] = {a.q, a.k, a.v, a.o};
    for (const void* p : ptrs)
        if (!aligned16(p)) return false;
    for (int i = 0; i < 12; ++i)
        if (a.st[i] % 8) return false;
    return true;
}

template <int D>
int launch_wg_fwd(const FwdArgs& a) {
    using C = WgFwd<D>;
    const long long q_tiles = (a.Lq + C::BQ - 1) / C::BQ;
    if ((long long)a.B * a.H * q_tiles > 0x7fffffffLL || !tma_aligned(a))
        return UNSUPPORTED;
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
    static bool smem_set = false;
    const cudaError_t e =
        allow_smem(flash_fwd_wg_kernel<D>, C::SMEM, smem_set);
    if (e != cudaSuccess) return (int)e;
    // with no keys the K and V maps are never read: they are encoded over q
    const bool keys = a.Lkv > 0;
    const long long* kst = keys ? a.st + 3 : a.st;
    const long long* vst = keys ? a.st + 6 : a.st;
    const int Lk = keys ? a.Lkv : a.Lq, Hk = keys ? a.Hkv : a.H;
    CUtensorMap mq, mk, mv;
    if (!encode_4d<C::SW>(enc, &mq, a.q, D, a.Lq, a.H, a.B, a.st, C::BQ) ||
        !encode_4d<C::SW>(enc, &mk, keys ? a.k : a.q, D, Lk, Hk, a.B, kst,
                          C::BKV) ||
        !encode_4d<C::SW>(enc, &mv, keys ? a.v : a.q, D, Lk, Hk, a.B, vst,
                          C::BKV))
        return (int)cudaErrorInvalidValue;
    // the query heads a chunk of the grid takes: whole groups whose K and
    // V (4 Lkv D bytes a KV head) fit in L2_CHUNK_BYTES
    const int group = a.H / a.Hkv;
    const long long BH = (long long)a.B * a.H;
    const long long kv_head = 4LL * (a.Lkv > 0 ? a.Lkv : 1) * D;
    const long long chunk = std::min(
        BH, group * std::max(1LL, L2_CHUNK_BYTES / kv_head));
    const long long* st = a.st;
    flash_fwd_wg_kernel<D><<<(unsigned)(BH * q_tiles), C::THREADS, C::SMEM,
                             (cudaStream_t)a.stream>>>(
        mq, mk, mv, static_cast<bf16*>(a.o), a.lse, (int)BH, a.H, group,
        (int)chunk, a.Lq, a.Lkv, a.causal, a.window, a.q_offset,
        a.scale * LOG2E, st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_rowdot(const BwdArgs& a, int D) {
    const long long rows = (long long)a.B * a.H * a.Lq;
    constexpr int THREADS = 256;
    const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    if (blocks > 0x7fffffffLL) return UNSUPPORTED;
    const long long* st = a.st;
    flash_bwd_rowdot_kernel<T><<<(unsigned)blocks, THREADS, 0,
                                 (cudaStream_t)a.stream>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.rowdot,
        a.H, a.Lq, D, st[9], st[10], st[11], st[12], st[13], st[14], rows);
    return (int)cudaGetLastError();
}

template <int D>
int launch_simt_bwd(const BwdArgs& a) {
    using C = SimtBwd<D>;
    if (a.B > MAX_GRID_YZ || a.H > MAX_GRID_YZ) return UNSUPPORTED;
    int rc = launch_rowdot<float>(a, D);
    if (rc) return rc;
    const long long* st = a.st;
    const int group = a.H / a.Hkv;
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    if (a.Lkv > 0) {
        dim3 grid((a.Lkv + C::ROWS - 1) / C::ROWS, a.Hkv, a.B);
        flash_bwd_simt_dkdv_kernel<D>
            <<<grid, SB_THREADS, 0, (cudaStream_t)a.stream>>>(
                f(a.q), f(a.k), f(a.v), f(a.dO), a.lse, a.rowdot,
                static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H,
                group, a.Lq, a.Lkv, a.causal, a.window, a.q_offset, a.scale,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                st[12], st[13], st[14]);
        rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    if (a.Lq > 0) {
        dim3 grid((a.Lq + C::ROWS - 1) / C::ROWS, a.H, a.B);
        flash_bwd_simt_dq_kernel<D>
            <<<grid, SB_THREADS, 0, (cudaStream_t)a.stream>>>(
                f(a.q), f(a.k), f(a.v), f(a.dO), a.lse, a.rowdot,
                static_cast<float*>(a.dq), group, a.Lq, a.Lkv, a.causal,
                a.window, a.q_offset, a.scale, st[0], st[1], st[2], st[3],
                st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14]);
        rc = (int)cudaGetLastError();
    }
    return rc;
}

template <int D>
int launch_wg_bwd(const BwdArgs& a) {
    using C = WgBwd<D>;
    const long long kblocks = (a.Lkv + C::BKV - 1) / C::BKV;
    const long long qblocks = (a.Lq + C::QB - 1) / C::QB;
    if (a.B > MAX_GRID_YZ || kblocks > MAX_GRID_YZ || qblocks > MAX_GRID_YZ)
        return UNSUPPORTED;
    const void* ptrs[] = {a.q, a.k, a.v, a.o, a.dO, a.dq, a.dk, a.dv};
    for (const void* p : ptrs)
        if (!aligned16(p)) return UNSUPPORTED;
    for (int i = 0; i < 15; ++i)
        if (a.st[i] % 8) return UNSUPPORTED;
    static bool dkdv_set = false, dq_set = false;
    cudaError_t e =
        allow_smem(flash_bwd_wg_dkdv_kernel<D>, C::SMEM, dkdv_set);
    if (e != cudaSuccess) return (int)e;
    e = allow_smem(flash_bwd_wg_dq_kernel<D>, C::SMEM_DQ, dq_set);
    if (e != cudaSuccess) return (int)e;
    int rc;
    {                                   // the row dots, 16 bytes a thread
        const long long rows = (long long)a.B * a.H * a.Lq;
        constexpr int THREADS = 256;
        const long long blocks = (rows * (D / 8) + THREADS - 1) / THREADS;
        if (blocks > 0x7fffffffLL) return UNSUPPORTED;
        const long long* st = a.st;
        flash_bwd_rowdot_bf16_kernel<D><<<(unsigned)blocks, THREADS, 0,
                                          (cudaStream_t)a.stream>>>(
            static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO),
            a.rowdot, a.H, a.Lq, st[9], st[10], st[11], st[12], st[13],
            st[14], rows);
        rc = (int)cudaGetLastError();
    }
    if (rc) return rc;
    const long long* st = a.st;
    const int group = a.H / a.Hkv;
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    if (a.Lkv > 0) {
        dim3 grid(a.Hkv * C::NS, a.B, (unsigned)kblocks);
        flash_bwd_wg_dkdv_kernel<D>
            <<<grid, C::THREADS, C::SMEM, (cudaStream_t)a.stream>>>(
                c(a.q), c(a.k), c(a.v), c(a.dO), a.lse, a.rowdot,
                static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
                a.Hkv, group, a.Lq, a.Lkv, a.causal, a.window, a.q_offset,
                a.scale, a.scale * LOG2E, st[0], st[1], st[2], st[3], st[4],
                st[5], st[6], st[7], st[8], st[12], st[13], st[14]);
        rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    if (a.Lq > 0) {
        dim3 grid(a.H * C::NS, a.B, (unsigned)qblocks);
        flash_bwd_wg_dq_kernel<D>
            <<<grid, C::THREADS, C::SMEM_DQ, (cudaStream_t)a.stream>>>(
                c(a.q), c(a.k), c(a.v), c(a.dO), a.lse, a.rowdot,
                static_cast<bf16*>(a.dq), a.H, group, a.Lq, a.Lkv, a.causal,
                a.window, a.q_offset, a.scale, a.scale * LOG2E, st[0], st[1],
                st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12],
                st[13], st[14]);
        rc = (int)cudaGetLastError();
    }
    return rc;
}

// the head-dim dispatch: one instance of each launcher per supported d
#define FLASH_LAUNCH(NAME, FN, ARGS)                                           \
    template <int D>                                                           \
    struct NAME {                                                              \
        static int run(const ARGS& a) { return FN<D>(a); }                     \
    };
FLASH_LAUNCH(SimtLaunch, launch_simt, FwdArgs)
FLASH_LAUNCH(WgFwdLaunch, launch_wg_fwd, FwdArgs)
FLASH_LAUNCH(SimtBwdLaunch, launch_simt_bwd, BwdArgs)
FLASH_LAUNCH(WgBwdLaunch, launch_wg_bwd, BwdArgs)
#undef FLASH_LAUNCH

// The head dims the kernels are instantiated for, ascending: the one list
// of them, which flash_attention_head_dims reports to the wrapper (it pads
// every other head dim up to the next of these).
#define FLASH_HEAD_DIMS 16, 32, 64, 128, 256

template <template <int> class L, typename Args, int D0, int... Ds>
int by_head_dim(int D, const Args& a) {
    if (a.Hkv < 1 || a.H % a.Hkv) return UNSUPPORTED;
    if (D == D0) return L<D0>::run(a);
    if constexpr (sizeof...(Ds) > 0)
        return by_head_dim<L, Args, Ds...>(D, a);
    return UNSUPPORTED;
}

}  // namespace

// q (B, H, Lq, D), k and v (B, Hkv, Lkv, D), o like q, lse (B, H, Lq)
// float32 contiguous or NULL; the strides are (batch, head, position) of q,
// k, v and o in turn, in elements.  Returns UNSUPPORTED, launching nothing,
// unless D is one of FLASH_HEAD_DIMS and Hkv divides H (the wrapper runs
// any other head dim up to the largest in the next one up, zero-padded,
// with the true dim's scale); float32 also needs the query group to fit a
// block (group * max(1, D / 32) <= 256) and B, Hkv <= 65535; bf16 needs
// ceil(Lq / BQ) <= 65535, 16-byte aligned pointers and strides that are
// multiples of 8 elements.
#define FLASH_ENTRY(NAME, LAUNCH)                                             \
    extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                        float* lse, int B, int H, int Hkv, int Lq, int Lkv,   \
                        int D, int causal, int window, int q_offset,          \
                        float scale, long long sqb, long long sqh,            \
                        long long sql, long long skb, long long skh,          \
                        long long skl, long long svb, long long svh,          \
                        long long svl, long long sob, long long soh,          \
                        long long sol, void* stream) {                        \
        const FwdArgs a{q,     k,      v,        o,     lse,                  \
                        B,     H,      Hkv,      Lq,    Lkv,                  \
                        causal, window, q_offset, scale,                      \
                        {sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob,    \
                         soh, sol},                                           \
                        stream};                                              \
        return by_head_dim<LAUNCH, FwdArgs, FLASH_HEAD_DIMS>(D, a);           \
    }

FLASH_ENTRY(flash_attention_f32, SimtLaunch)
FLASH_ENTRY(flash_attention_bf16, WgFwdLaunch)

// The backward: q, k, v, o, lse and dO as the forward's (dO with strides of
// its own), dq (B, H, Lq, D), dk and dv (B, Hkv, Lkv, D) contiguous outputs,
// rowdot a (B, H, Lq) float32 scratch.  Three launches on the stream: the
// row dots, dK/dV, dQ.  Returns UNSUPPORTED as the forward does (bf16:
// every pointer 16-byte aligned, every stride a multiple of 8 elements,
// H * D / 64 <= 65535; float32: B, H <= 65535).
#define FLASH_BWD_ENTRY(NAME, LAUNCH)                                          \
    extern "C" int NAME(                                                       \
        const void* q, const void* k, const void* v, const void* o,            \
        const float* lse, const void* dO, void* dq, void* dk, void* dv,        \
        float* rowdot, int B, int H, int Hkv, int Lq, int Lkv, int D,          \
        int causal, int window, int q_offset, float scale, long long sqb,       \
        long long sqh, long long sql, long long skb, long long skh,            \
        long long skl, long long svb, long long svh, long long svl,            \
        long long sob, long long soh, long long sol, long long sdb,            \
        long long sdh, long long sdl, void* stream) {                          \
        const BwdArgs a{q,     k,      v,        o,     dO,    lse, dq, dk,    \
                        dv,    rowdot, B,        H,     Hkv,   Lq,  Lkv,       \
                        causal, window, q_offset, scale,                       \
                        {sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob,     \
                         soh, sol, sdb, sdh, sdl},                             \
                        stream};                                               \
        return by_head_dim<LAUNCH, BwdArgs, FLASH_HEAD_DIMS>(D, a);            \
    }

FLASH_BWD_ENTRY(flash_attention_bwd_f32, SimtBwdLaunch)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, WgBwdLaunch)

// Writes up to n of the instantiated head dims, ascending, to dims;
// returns how many there are.
extern "C" int flash_attention_head_dims(int* dims, int n) {
    constexpr int built[] = {FLASH_HEAD_DIMS};
    constexpr int count = sizeof(built) / sizeof(built[0]);
    for (int i = 0; i < count && i < n; ++i) dims[i] = built[i];
    return count;
}


extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
