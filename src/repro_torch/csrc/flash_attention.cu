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
// operations, at the bf16 tensor-core rate.
//
// Two kernels, chosen by dtype (an explicit dispatch in the C entries):
//
// bf16 -> flash_mma_kernel, FlashAttention-2 on the tensor cores.  A block
// of 4 warps owns BQ query rows of one query head; each warp owns 16*MT
// rows (MT = 2 for d <= 64, else 1).  QK^T and PV are
// mma.sync.m16n8k16 bf16 products with float32 accumulators, fed by
// ldmatrix from shared memory (.trans for V, whose rows are keys).  Q is
// copied to shared memory once and, for d <= 128, held in registers as
// mma fragments; at d = 256 it is re-read from shared memory each tile, to
// keep the 128 float32 accumulators of a row slice in registers.  K and V
// tiles of BKV keys (64; 32 at d = 256) arrive by cp.async 16-byte copies
// into a ring of two stages, so the next tile loads while this one is
// multiplied.  Rows are padded by 16 bytes in shared memory so that the 8
// rows of an ldmatrix hit distinct banks.  Scores stay in registers: the
// row max and sum are reduced over the 4 lanes of a quad, P is rescaled in
// the exp2 domain (scale * log2 e folded in) and rounded to bf16 for the PV
// product, as SDPA does; m, l and O stay in float32 registers.  GQA reads
// K/V of head h / group; the heads of a group are neighbouring blocks, so
// their K/V tiles come from L2.  The grid is (B*H, q tiles) with the q
// tile on the slow axis, reversed, so the longest causal tiles launch
// first over all heads.  Per-element masks run only on the tiles of a warp
// that cross the diagonal, the window's first key or Lkv; a tile no row of
// a warp may see is skipped by that warp.  cp.async needs 16-byte aligned
// rows: the entry returns UNSUPPORTED unless every pointer is 16-byte
// aligned and every batch, head and position stride is a multiple of 8
// elements (the wrapper copies such an operand once; hymba's
// (B, L, H, d) -> (B, H, L, d) views, position stride H*d, need no copy).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int UNSUPPORTED = -1;     // no instance takes the arguments
constexpr int MAX_GRID_YZ = 65535;
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
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct MmaTile {
    static constexpr int MT = D <= 64 ? 2 : 1;        // m16 tiles per warp
    static constexpr int BQ = 16 * MT * MMA_WARPS;    // query rows per block
    static constexpr int BKV = D <= 128 ? 64 : 32;    // keys per tile
    static constexpr int LD = D + 8;                  // row pitch (elements)
    static constexpr int STAGES = 2;                  // K/V ring
    static constexpr bool QREG = D <= 128;            // Q fragments in regs
    static constexpr int SMEM = (BQ + 2 * STAGES * BKV) * LD * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes == 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4*g + t.  A (16x16):
// a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (cols +8), a3 (row g+8,
// cols +8).  B (16x8): b0 (k 2t, 2t+1; n g), b1 (k +8).  C (16x8): c0, c1
// (row g, cols 2t, 2t+1), c2, c3 (row g+8).  An ldmatrix.x4 gives matrix
// i's fragment from the 8 row addresses of lanes 8i..8i+7.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int group, int Lq, int Lkv, int causal, int window,
                 int q_offset, float scale_log2, int64_t sqb, int64_t sqh,
                 int64_t sql, int64_t skb, int64_t skh, int64_t skl,
                 int64_t svb, int64_t svh, int64_t svl, int64_t sob,
                 int64_t soh, int64_t sol) {
    using C = MmaTile<D>;
    constexpr int MT = C::MT, BQ = C::BQ, BKV = C::BKV, LD = C::LD;
    constexpr int NT = BKV / 8;          // n8 tiles of scores per m16 tile
    constexpr int DT = D / 8;            // n8 tiles of the output
    constexpr int CH = D / 8;            // 16-byte chunks per row
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);            // [BQ][LD]
    bf16* Ks = Qs + BQ * LD;                             // [STAGES][BKV][LD]
    bf16* Vs = Ks + C::STAGES * BKV * LD;

    const int h = blockIdx.x % H;
    const int64_t b = blockIdx.x / H;
    const int hk = h / group;
    const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;

    const bf16* qb = q + b * sqb + h * sqh;
    const bf16* kb = k + b * skb + hk * skh;
    const bf16* vb = v + b * svb + hk * svh;

    // the keys any row of this block may see: the causal mask ends them at
    // the tile's last query, the window starts them W-1 before its first
    const int q_hi = min(q_lo + BQ, Lq) - 1;
    int kv_lo = 0, kv_hi = Lkv - 1;
    if (causal) kv_hi = min(kv_hi, q_offset + q_hi);
    if (window > 0) kv_lo = max(0, q_offset + q_lo - window + 1);
    const int n_tiles = kv_hi >= kv_lo ? (kv_hi - kv_lo) / BKV + 1 : 0;

    for (int c = tid; c < BQ * CH; c += MMA_THREADS) {   // rows past Lq: 0
        const int r = c / CH, cc = c % CH;
        const bool ok = q_lo + r < Lq;
        cp_async16(smem_addr(Qs + r * LD + cc * 8),
                   ok ? qb + (int64_t)(q_lo + r) * sql + cc * 8 : qb,
                   ok ? 16 : 0);
    }
    auto load_kv = [&](int tile, int stage) {            // rows past Lkv: 0
        const int kv0 = kv_lo + tile * BKV;
        bf16* kd = Ks + stage * BKV * LD;
        bf16* vd = Vs + stage * BKV * LD;
        for (int c = tid; c < BKV * CH; c += MMA_THREADS) {
            const int r = c / CH, cc = c % CH;
            const int kp = kv0 + r;
            const bool ok = kp < Lkv;
            cp_async16(smem_addr(kd + r * LD + cc * 8),
                       ok ? kb + (int64_t)kp * skl + cc * 8 : kb,
                       ok ? 16 : 0);
            cp_async16(smem_addr(vd + r * LD + cc * 8),
                       ok ? vb + (int64_t)kp * svl + cc * 8 : vb,
                       ok ? 16 : 0);
        }
    };
    if (n_tiles > 0) load_kv(0, 0);
    cp_async_commit();

    // this warp's rows, and their absolute positions
    const int w_row = warp * 16 * MT;
    const int wq_lo = q_lo + w_row;
    const bool warp_live = wq_lo < Lq;
    const int wpos_lo = q_offset + wq_lo;
    const int wpos_hi = q_offset + min(wq_lo + 16 * MT, Lq) - 1;

    float acc[MT][DT][4];
    float m_run[MT][2], l_run[MT][2];        // per row g and g+8; l per lane
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            m_run[mt][r] = -INFINITY;
            l_run[mt][r] = 0.f;
        }
    }
    uint32_t qf[C::QREG ? MT : 1][C::QREG ? D / 16 : 1][4];
    // lane's ldmatrix row address within a 16x16 A tile / a B tile pair
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int kb_row = (lane >> 4) * 8 + (lane & 7);
    const int kb_col = ((lane >> 3) & 1) * 8;
    const int vb_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vb_col = (lane >> 4) * 8;
    const bf16* qw = Qs + (w_row + a_row) * LD + a_col;   // this lane's Q row

    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();                  // Q and tile it have landed
        __syncthreads();
        if constexpr (C::QREG) {
            if (it == 0) {
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int kc = 0; kc < D / 16; ++kc)
                        ldmatrix_x4(qf[mt][kc],
                                    smem_addr(qw + mt * 16 * LD + kc * 16));
            }
        }
        const int kv0 = kv_lo + it * BKV;
        const bf16* kt = Ks + (it & 1) * BKV * LD;
        const bf16* vt = Vs + (it & 1) * BKV * LD;
        const bool skip = !warp_live || (causal && kv0 > wpos_hi) ||
                          (window > 0 && kv0 + BKV - 1 <= wpos_lo - window);
        if (!skip) {
            float s[MT][NT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
            // S = Q K^T
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc) {
                uint32_t qa[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    if constexpr (C::QREG) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) qa[mt][e] = qf[mt][kc][e];
                    } else {
                        ldmatrix_x4(qa[mt],
                                    smem_addr(qw + mt * 16 * LD + kc * 16));
                    }
                }
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t kf[4];
                    ldmatrix_x4(kf, smem_addr(kt + (np * 16 + kb_row) * LD +
                                              kc * 16 + kb_col));
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma_bf16(s[mt][2 * np], qa[mt], kf[0], kf[1]);
                        mma_bf16(s[mt][2 * np + 1], qa[mt], kf[2], kf[3]);
                    }
                }
            }
            // masks, only where the tile crosses an edge for this warp
            const bool edge = kv0 + BKV > Lkv ||
                              (causal && kv0 + BKV - 1 > wpos_lo) ||
                              (window > 0 && kv0 <= wpos_hi - window);
            if (edge) {
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int qpos =
                                wpos_lo + mt * 16 + g + (e >> 1) * 8;
                            const int kp = kv0 + nt * 8 + 2 * t + (e & 1);
                            const bool keep =
                                kp < Lkv && (!causal || kp <= qpos) &&
                                (window <= 0 || qpos - kp < window);
                            if (!keep) s[mt][nt][e] = -INFINITY;
                        }
            }
            // online softmax in the exp2 domain
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float mx = -INFINITY;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
                        mx = fmaxf(mx, fmaxf(s[mt][nt][2 * r],
                                             s[mt][nt][2 * r + 1]));
                    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
                    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
                    const float m_new = fmaxf(m_run[mt][r], mx * scale_log2);
                    const float safe = m_new == -INFINITY ? 0.f : m_new;
                    const float corr = ex2(m_run[mt][r] - safe);
                    float sum = 0.f;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                        for (int e = 2 * r; e < 2 * r + 2; ++e) {
                            const float p =
                                ex2(fmaf(s[mt][nt][e], scale_log2, -safe));
                            s[mt][nt][e] = p;
                            sum += p;
                        }
                    }
                    l_run[mt][r] = corr * l_run[mt][r] + sum;
                    m_run[mt][r] = m_new;
#pragma unroll
                    for (int dt = 0; dt < DT; ++dt) {
                        acc[mt][dt][2 * r] *= corr;
                        acc[mt][dt][2 * r + 1] *= corr;
                    }
                }
            }
            // O += P V, P rounded to bf16 in registers
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk) {
                uint32_t pa[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
                    pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
                    pa[mt][2] =
                        pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
                    pa[mt][3] =
                        pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
                }
#pragma unroll
                for (int dp = 0; dp < D / 16; ++dp) {
                    uint32_t vf[4];
                    ldmatrix_x4_trans(vf, smem_addr(vt + (kk * 16 + vb_row) * LD
                                                    + dp * 16 + vb_col));
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma_bf16(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
                        mma_bf16(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
                    }
                }
            }
        }
        __syncthreads();                     // stage it & 1 is free again
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l = l_run[mt][r];
            l += __shfl_xor_sync(FULL, l, 1);
            l += __shfl_xor_sync(FULL, l, 2);
            const float inv = l == 0.f ? 1.f : 1.f / l;
            const int qi = wq_lo + mt * 16 + g + 8 * r;
            if (qi < Lq) {
                // log-sum-exp in natural units (m is in the exp2 domain);
                // 0 (finite) for a row that sees no key
                if (lse != nullptr && t == 0)
                    lse[(b * H + h) * Lq + qi] =
                        l > 0.f ? (m_run[mt][r] + log2f(l)) * LN2 : 0.f;
                bf16* orow = o + b * sob + h * soh + (int64_t)qi * sol + 2 * t;
#pragma unroll
                for (int dt = 0; dt < DT; ++dt)
                    *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
                        __floats2bfloat162_rn(acc[mt][dt][2 * r] * inv,
                                              acc[mt][dt][2 * r + 1] * inv);
            }
        }
    }
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
// bf16 -> flash_bwd_mma_{dkdv,dq}_kernel: 4 warps, each owning 16 rows of
// the block (keys, or queries); S and dP are mma.sync m16n8k16 bf16
// products with float32 accumulators fed by ldmatrix from shared memory,
// as in the forward; P and dS are rounded to bf16 in registers for the
// second products (ldmatrix .trans on the row-major Q, dO or K tile).  A
// block accumulates DS = min(d, 64) output columns (at d = 128 and 256 the
// grid has d / 64 column slices, each recomputing S and dP): 2 x 32
// float32 accumulators a thread in the dK/dV kernel at every d.  The tiles
// are single-buffered cp.async copies.  float32 ->
// flash_bwd_simt_{dkdv,dq}_kernel on the CUDA cores (the checks' float32
// paths): every thread owns a 16-dim slice of one key (or query) row, and
// dot products are summed over the row's threads with warp shuffles.
//
// Bound on an H100: 10 * d operations per unmasked (query, key) pair (S
// and dP recomputed, dV, dK, dQ), at the bf16 tensor-core rate.

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// D[row] = sum over d of dO * o, in float32; one warp a row
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

// ---- bf16 on the tensor cores

template <int D>
struct MmaBwd {
    static constexpr int BR = 16 * MMA_WARPS;     // a block's rows
    static constexpr int BC = 64;                 // columns of an inner tile
    static constexpr int DS = D < 64 ? D : 64;    // output columns a block sums
    static constexpr int NS = D / DS;             // column slices
    static constexpr int LD = D + 8;              // row pitch (elements)
    // two row tiles and two column tiles of bf16, then two float rows
    static constexpr int SMEM = (2 * BR + 2 * BC) * LD * 2 + 2 * BC * 4;
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_mma_dkdv_kernel(const bf16* __restrict__ q,
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
    using C = MmaBwd<D>;
    constexpr int BR = C::BR, BC = C::BC, DS = C::DS, LD = C::LD;
    constexpr int NT = BC / 8;           // n8 tiles of S^T per warp
    constexpr int OT = DS / 8;           // n8 tiles of the output slice
    constexpr int CH = D / 8;            // 16-byte chunks per row
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);          // [BR][LD]
    bf16* Vs = Ks + BR * LD;
    bf16* Qs = Vs + BR * LD;                            // [BC][LD]
    bf16* Os = Qs + BC * LD;                            // dO rows
    float* lse_s = reinterpret_cast<float*>(Os + BC * LD);   // exp2 units
    float* dot_s = lse_s + BC;

    const int hk = blockIdx.y / C::NS;
    const int c0 = (blockIdx.y % C::NS) * DS;          // first output column
    const int64_t b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int k_lo = blockIdx.x * BR;
    const int k_hi = min(k_lo + BR, Lkv) - 1;

    const bf16* kb = k + b * skb + (int64_t)hk * skh;
    const bf16* vb = v + b * svb + (int64_t)hk * svh;
    for (int c = tid; c < BR * CH; c += MMA_THREADS) {   // rows past Lkv: 0
        const int r = c / CH, cc = c % CH;
        const bool ok = k_lo + r < Lkv;
        cp_async16(smem_addr(Ks + r * LD + cc * 8),
                   ok ? kb + (int64_t)(k_lo + r) * skl + cc * 8 : kb,
                   ok ? 16 : 0);
        cp_async16(smem_addr(Vs + r * LD + cc * 8),
                   ok ? vb + (int64_t)(k_lo + r) * svl + cc * 8 : vb,
                   ok ? 16 : 0);
    }
    cp_async_commit();

    // the queries that may see any key of this block
    const int qi_lo = causal ? max(0, k_lo - q_offset) : 0;
    int qi_hi = Lq - 1;
    if (window > 0) qi_hi = min(qi_hi, k_hi + window - 1 - q_offset);

    // this warp's 16 keys
    const int wk_lo = k_lo + warp * 16;
    const int wk_hi = min(wk_lo + 15, Lkv - 1);
    const bool warp_live = wk_lo < Lkv;
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int kb_row = (lane >> 4) * 8 + (lane & 7);
    const int kb_col = ((lane >> 3) & 1) * 8;
    const int vb_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vb_col = (lane >> 4) * 8;
    const bf16* kw = Ks + (warp * 16 + a_row) * LD + a_col;
    const bf16* vw = Vs + (warp * 16 + a_row) * LD + a_col;

    float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[ot][e] = dv_acc[ot][e] = 0.f;

    for (int gi = 0; gi < group; ++gi) {
        const int64_t h = (int64_t)hk * group + gi;
        const bf16* qb = q + b * sqb + h * sqh;
        const bf16* db = dO + b * sdb + h * sdh;
        const float* lh = lse + (b * H + h) * Lq;
        const float* dh = rowdot + (b * H + h) * Lq;
        for (int q0 = qi_lo; q0 <= qi_hi; q0 += BC) {
            __syncthreads();                     // previous tile consumed
            for (int c = tid; c < BC * CH; c += MMA_THREADS) {
                const int r = c / CH, cc = c % CH;
                const bool ok = q0 + r <= qi_hi;
                cp_async16(smem_addr(Qs + r * LD + cc * 8),
                           ok ? qb + (int64_t)(q0 + r) * sql + cc * 8 : qb,
                           ok ? 16 : 0);
                cp_async16(smem_addr(Os + r * LD + cc * 8),
                           ok ? db + (int64_t)(q0 + r) * sdl + cc * 8 : db,
                           ok ? 16 : 0);
            }
            cp_async_commit();
            for (int r = tid; r < BC; r += MMA_THREADS) {
                const bool ok = q0 + r <= qi_hi;
                lse_s[r] = ok ? lh[q0 + r] * LOG2E : 0.f;
                dot_s[r] = ok ? dh[q0 + r] : 0.f;
            }
            cp_async_wait<0>();
            __syncthreads();
            // a tile no query of which sees a key of this warp
            const int qp_lo = q_offset + q0;
            const int qp_hi = q_offset + min(q0 + BC - 1, qi_hi);
            if (!warp_live || (causal && qp_hi < wk_lo) ||
                (window > 0 && qp_lo - wk_hi >= window))
                continue;
            float s[NT][4], dp[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
            // S^T = K Q^T and dP^T = V dO^T over the full head dim
#pragma unroll
            for (int kc = 0; kc < D / 16; ++kc) {
                uint32_t ka[4], va[4];
                ldmatrix_x4(ka, smem_addr(kw + kc * 16));
                ldmatrix_x4(va, smem_addr(vw + kc * 16));
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t qf[4], df[4];
                    const int off = (np * 16 + kb_row) * LD + kc * 16 + kb_col;
                    ldmatrix_x4(qf, smem_addr(Qs + off));
                    ldmatrix_x4(df, smem_addr(Os + off));
                    mma_bf16(s[2 * np], ka, qf[0], qf[1]);
                    mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
                    mma_bf16(dp[2 * np], va, df[0], df[1]);
                    mma_bf16(dp[2 * np + 1], va, df[2], df[3]);
                }
            }
            // P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - D)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = wk_lo + g + (e >> 1) * 8;
                    const int col = nt * 8 + 2 * t + (e & 1);
                    const int qpos = q_offset + q0 + col;
                    const bool keep = key < Lkv && q0 + col <= qi_hi &&
                                      (!causal || key <= qpos) &&
                                      (window <= 0 || qpos - key < window);
                    const float p =
                        keep ? ex2(fmaf(s[nt][e], scale_log2, -lse_s[col]))
                             : 0.f;
                    s[nt][e] = p;
                    dp[nt][e] = p * (dp[nt][e] - dot_s[col]);
                }
            // dV += P^T dO, dK += dS^T Q over this block's output columns
#pragma unroll
            for (int kk = 0; kk < BC / 16; ++kk) {
                uint32_t pa[4], da[4];
                pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
                pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
                pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
                pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
                da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
                da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
                da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
                da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
                for (int dj = 0; dj < DS / 16; ++dj) {
                    uint32_t of[4], qf[4];
                    const int off =
                        (kk * 16 + vb_row) * LD + c0 + dj * 16 + vb_col;
                    ldmatrix_x4_trans(of, smem_addr(Os + off));
                    ldmatrix_x4_trans(qf, smem_addr(Qs + off));
                    mma_bf16(dv_acc[2 * dj], pa, of[0], of[1]);
                    mma_bf16(dv_acc[2 * dj + 1], pa, of[2], of[3]);
                    mma_bf16(dk_acc[2 * dj], da, qf[0], qf[1]);
                    mma_bf16(dk_acc[2 * dj + 1], da, qf[2], qf[3]);
                }
            }
        }
    }
    cp_async_wait<0>();      // the K/V copies, when no query tile ran

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = wk_lo + g + 8 * r;
        if (key < Lkv) {
            const int64_t base =
                ((b * Hkv + hk) * Lkv + key) * D + c0 + 2 * t;
#pragma unroll
            for (int ot = 0; ot < OT; ++ot) {
                *reinterpret_cast<__nv_bfloat162*>(dk + base + ot * 8) =
                    __floats2bfloat162_rn(dk_acc[ot][2 * r] * scale,
                                          dk_acc[ot][2 * r + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dv + base + ot * 8) =
                    __floats2bfloat162_rn(dv_acc[ot][2 * r],
                                          dv_acc[ot][2 * r + 1]);
            }
        }
    }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
    using C = MmaBwd<D>;
    constexpr int BR = C::BR, BC = C::BC, DS = C::DS, LD = C::LD;
    constexpr int NT = BC / 8;           // n8 tiles of S per warp
    constexpr int OT = DS / 8;
    constexpr int CH = D / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);          // [BR][LD]
    bf16* Os = Qs + BR * LD;                            // dO rows
    bf16* Ks = Os + BR * LD;                            // [BC][LD]
    bf16* Vs = Ks + BC * LD;

    const int64_t h = blockIdx.y / C::NS;
    const int c0 = (blockIdx.y % C::NS) * DS;
    const int64_t b = blockIdx.z;
    const int64_t hk = h / group;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q_lo = blockIdx.x * BR;
    const int q_hi = min(q_lo + BR, Lq) - 1;

    const bf16* qb = q + b * sqb + h * sqh;
    const bf16* db = dO + b * sdb + h * sdh;
    for (int c = tid; c < BR * CH; c += MMA_THREADS) {   // rows past Lq: 0
        const int r = c / CH, cc = c % CH;
        const bool ok = q_lo + r < Lq;
        cp_async16(smem_addr(Qs + r * LD + cc * 8),
                   ok ? qb + (int64_t)(q_lo + r) * sql + cc * 8 : qb,
                   ok ? 16 : 0);
        cp_async16(smem_addr(Os + r * LD + cc * 8),
                   ok ? db + (int64_t)(q_lo + r) * sdl + cc * 8 : db,
                   ok ? 16 : 0);
    }
    cp_async_commit();

    // this warp's 16 queries; rows g and g + 8 of this lane
    const int wq_lo = q_lo + warp * 16;
    const bool warp_live = wq_lo < Lq;
    const int wpos_lo = q_offset + wq_lo;
    const int wpos_hi = q_offset + min(wq_lo + 15, Lq - 1);
    float lse2[2], dot[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = wq_lo + g + 8 * r;
        const int64_t i = (b * H + h) * Lq + qi;
        lse2[r] = qi < Lq ? lse[i] * LOG2E : 0.f;
        dot[r] = qi < Lq ? rowdot[i] : 0.f;
    }
    int kv_lo = 0, kv_hi = Lkv - 1;
    if (causal) kv_hi = min(kv_hi, q_offset + q_hi);
    if (window > 0) kv_lo = max(0, q_offset + q_lo - window + 1);

    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int kb_row = (lane >> 4) * 8 + (lane & 7);
    const int kb_col = ((lane >> 3) & 1) * 8;
    const int vb_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vb_col = (lane >> 4) * 8;
    const bf16* qw = Qs + (warp * 16 + a_row) * LD + a_col;
    const bf16* ow = Os + (warp * 16 + a_row) * LD + a_col;
    const bf16* kbh = k + b * skb + hk * skh;
    const bf16* vbh = v + b * svb + hk * svh;

    float acc[OT][4];
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ot][e] = 0.f;

    for (int kv0 = kv_lo; kv0 <= kv_hi; kv0 += BC) {
        __syncthreads();                         // previous tile consumed
        for (int c = tid; c < BC * CH; c += MMA_THREADS) {
            const int r = c / CH, cc = c % CH;
            const bool ok = kv0 + r <= kv_hi;
            cp_async16(smem_addr(Ks + r * LD + cc * 8),
                       ok ? kbh + (int64_t)(kv0 + r) * skl + cc * 8 : kbh,
                       ok ? 16 : 0);
            cp_async16(smem_addr(Vs + r * LD + cc * 8),
                       ok ? vbh + (int64_t)(kv0 + r) * svl + cc * 8 : vbh,
                       ok ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (!warp_live || (causal && kv0 > wpos_hi) ||
            (window > 0 && kv0 + BC - 1 <= wpos_lo - window))
            continue;
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        // S = Q K^T and dP = dO V^T over the full head dim
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
            uint32_t qa[4], oa[4];
            ldmatrix_x4(qa, smem_addr(qw + kc * 16));
            ldmatrix_x4(oa, smem_addr(ow + kc * 16));
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t kf[4], vf[4];
                const int off = (np * 16 + kb_row) * LD + kc * 16 + kb_col;
                ldmatrix_x4(kf, smem_addr(Ks + off));
                ldmatrix_x4(vf, smem_addr(Vs + off));
                mma_bf16(s[2 * np], qa, kf[0], kf[1]);
                mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
                mma_bf16(dp[2 * np], oa, vf[0], vf[1]);
                mma_bf16(dp[2 * np + 1], oa, vf[2], vf[3]);
            }
        }
        // dS = P (dP - D), P = exp2(S scale log2 e - lse log2 e)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qpos = wpos_lo + g + (e >> 1) * 8;
                const int kp = kv0 + nt * 8 + 2 * t + (e & 1);
                const bool keep = qpos - q_offset < Lq && kp <= kv_hi &&
                                  (!causal || kp <= qpos) &&
                                  (window <= 0 || qpos - kp < window);
                const float p =
                    keep ? ex2(fmaf(s[nt][e], scale_log2, -lse2[e >> 1]))
                         : 0.f;
                s[nt][e] = p * (dp[nt][e] - dot[e >> 1]);
            }
        // dQ += dS K over this block's output columns
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) {
            uint32_t da[4];
            da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dj = 0; dj < DS / 16; ++dj) {
                uint32_t kf[4];
                ldmatrix_x4_trans(kf, smem_addr(Ks + (kk * 16 + vb_row) * LD +
                                                c0 + dj * 16 + vb_col));
                mma_bf16(acc[2 * dj], da, kf[0], kf[1]);
                mma_bf16(acc[2 * dj + 1], da, kf[2], kf[3]);
            }
        }
    }
    cp_async_wait<0>();      // the Q/dO copies, when no key tile ran

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = wq_lo + g + 8 * r;
        if (qi < Lq) {
            const int64_t base = ((b * H + h) * Lq + qi) * D + c0 + 2 * t;
#pragma unroll
            for (int ot = 0; ot < OT; ++ot)
                *reinterpret_cast<__nv_bfloat162*>(dq + base + ot * 8) =
                    __floats2bfloat162_rn(acc[ot][2 * r] * scale,
                                          acc[ot][2 * r + 1] * scale);
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

template <int D>
int launch_mma(const FwdArgs& a) {
    using C = MmaTile<D>;
    const int q_tiles = (a.Lq + C::BQ - 1) / C::BQ;
    if (q_tiles > MAX_GRID_YZ || (long long)a.B * a.H > 0x7fffffffLL)
        return UNSUPPORTED;
    // cp.async copies 16-byte rows: 8 bf16 elements
    if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
        !aligned16(a.o))
        return UNSUPPORTED;
    for (int i = 0; i < 12; ++i)
        if (a.st[i] % 8) return UNSUPPORTED;
    static bool smem_set = false;
    const cudaError_t e = allow_smem(flash_mma_kernel<D>, C::SMEM, smem_set);
    if (e != cudaSuccess) return (int)e;
    const long long* st = a.st;
    dim3 grid(a.B * a.H, q_tiles);
    flash_mma_kernel<D><<<grid, MMA_THREADS, C::SMEM,
                          (cudaStream_t)a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.H,
        a.H / a.Hkv, a.Lq, a.Lkv, a.causal, a.window, a.q_offset,
        a.scale * LOG2E, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], st[9], st[10], st[11]);
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
int launch_mma_bwd(const BwdArgs& a) {
    using C = MmaBwd<D>;
    if (a.B > MAX_GRID_YZ || (long long)a.H * C::NS > MAX_GRID_YZ)
        return UNSUPPORTED;
    const void* ptrs[] = {a.q, a.k, a.v, a.o, a.dO, a.dq, a.dk, a.dv};
    for (const void* p : ptrs)
        if (!aligned16(p)) return UNSUPPORTED;
    for (int i = 0; i < 15; ++i)
        if (a.st[i] % 8) return UNSUPPORTED;
    static bool dkdv_set = false, dq_set = false;
    cudaError_t e =
        allow_smem(flash_bwd_mma_dkdv_kernel<D>, C::SMEM, dkdv_set);
    if (e != cudaSuccess) return (int)e;
    e = allow_smem(flash_bwd_mma_dq_kernel<D>, C::SMEM, dq_set);
    if (e != cudaSuccess) return (int)e;
    int rc = launch_rowdot<bf16>(a, D);
    if (rc) return rc;
    const long long* st = a.st;
    const int group = a.H / a.Hkv;
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    if (a.Lkv > 0) {
        dim3 grid((a.Lkv + C::BR - 1) / C::BR, a.Hkv * C::NS, a.B);
        flash_bwd_mma_dkdv_kernel<D>
            <<<grid, MMA_THREADS, C::SMEM, (cudaStream_t)a.stream>>>(
                c(a.q), c(a.k), c(a.v), c(a.dO), a.lse, a.rowdot,
                static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
                a.Hkv, group, a.Lq, a.Lkv, a.causal, a.window, a.q_offset,
                a.scale, a.scale * LOG2E, st[0], st[1], st[2], st[3], st[4],
                st[5], st[6], st[7], st[8], st[12], st[13], st[14]);
        rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    if (a.Lq > 0) {
        dim3 grid((a.Lq + C::BR - 1) / C::BR, a.H * C::NS, a.B);
        flash_bwd_mma_dq_kernel<D>
            <<<grid, MMA_THREADS, C::SMEM, (cudaStream_t)a.stream>>>(
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
FLASH_LAUNCH(MmaLaunch, launch_mma, FwdArgs)
FLASH_LAUNCH(SimtBwdLaunch, launch_simt_bwd, BwdArgs)
FLASH_LAUNCH(MmaBwdLaunch, launch_mma_bwd, BwdArgs)
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
FLASH_ENTRY(flash_attention_bf16, MmaLaunch)

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
FLASH_BWD_ENTRY(flash_attention_bwd_bf16, MmaBwdLaunch)

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
