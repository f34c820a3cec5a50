// Mamba-1 selective scan with its final state:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,
//   y_t = sum_s h_t * C_t + D * x_t,  from h_0 = 0.
//
// Replaces the TPU kernel ssm_scan_pallas (body _ssm_kernel) in
// src/repro/kernels/ssm_scan/kernel.py.  The Pallas grid (B, D/bd, L/bl)
// keeps a (bd, S) state tile in VMEM scratch across a sequential time axis,
// pads time with dt = 0 and cannot return the final state, so the
// reference's prefill falls back to the jnp scan for the decode hand-off.
// This kernel writes the final state as well (h_final, float32).
//
// Bound on an H100: one exp per (t, d, s).  At hymba-1.5b's prefill (Bt=4,
// L=8192, Dm=3200, S=16, bf16) the 1.68e9 exps take 0.401 ms on the
// special-function units (16 per SM per clock, 132 SMs, 1.98 GHz); the
// bytes (x, dt, B, C read once, y written once: 0.63 GB) 0.189 ms.  The
// grid cannot reach that bound: hymba's 12,800 channels x 16 states fill
// 400 warps' worth of (channel, state) lanes on 528 schedulers, so the
// busiest scheduler issues 16 exp warp-instructions of 8 cycles a step:
// 0.53 ms.  Besides its exp, a (state, step) costs an FMUL for the exp's
// argument, an FMUL and an FFMA for h and an FFMA for y: the step loop is
// as much issue-bound as exp-bound.
//
// Design (a redesign of the first port, which gave each (channel, state) a
// thread and summed y_t over a warp by four shuffles every step):
// - SPLIT = 2 lanes own a channel and keep S / 2 states h[s] and
//   A[d, s] * log2(e) each in registers; y_t is a sum in registers plus one
//   shuffle.  Two lanes a channel give hymba's grid 800 warps for 528
//   schedulers at no extra exp.  The exp is ex2.approx on dt * A * log2(e):
//   dt = 0 gives 2^0 = 1 exactly, the Pallas padding rule; a large |dt * A|
//   underflows to 0.
// - The step loop is software-pipelined: the next step's x, dt, B and C
//   are read from shared memory and its exps issued while this step's h
//   and y are computed, so no instruction waits on an exp or a load; a
//   full chunk is unrolled, so the pipeline's registers rotate without
//   moves.
// - A block owns CB = 128 channels of one batch row (256 bytes of a bf16
//   row) and walks time in chunks of TC = 32 steps, with one barrier a
//   chunk.  After it, the block's threads start the next chunk's x and dt
//   (16-byte cp.async, zeros past Dm), load its B and C into registers
//   (B and C are column slices of the x_proj output: at hymba's row of 264
//   bytes they start on 8 bytes, and anywhere in general; they go to
//   shared memory as float32 once the chunk has stepped, and are read as
//   broadcast 16-byte loads), and store the previous chunk's y rows from
//   shared memory as coalesced 16-byte rows.  x, dt and y are
//   double-buffered.
// - The 16-byte copies need x, dt and y 16-byte aligned, their batch and
//   time strides and Dm multiples of 16 bytes; otherwise (VEC = false) x
//   and dt are staged and y stored element by element.
// States past S have A = 0 and B = C = 0, so h stays 0 there.  No time
// padding: a chunk ends at L.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W with 1, 2 and 4
// lanes per channel (each then built as a variant): 1.38 / 0.93 / 1.10 ms
// at hymba's shape above, 1.56 / 1.59 / 2.18 ms at falcon-mamba-7b's
// Dm = 8192 (bound 1.03 ms); 2 lanes were kept.  The first port took
// 3.9 ms at hymba's shape.
//
// Strides: x, dt, B and C take batch and time strides with a contiguous
// last dim (B and C: row stride r + 2S); A is (Dm, S), D (Dm,), y
// (Bt, L, Dm) and h_final (Bt, Dm, S) are contiguous.  Each C entry returns
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int UNSUPPORTED = -1;     // no instance takes the arguments
constexpr int MAX_GRID_Y = 65535;
constexpr int CB = 128;             // channels per block
constexpr int TC = 32;              // time steps per staged chunk
constexpr int SPLIT = 2;            // lanes per channel
constexpr int CK = 256;             // steps between saved states (backward)
static_assert(CK % TC == 0, "a checkpoint starts a staged chunk");
static_assert(SPLIT == 2, "one shuffle sums a channel's two parts");
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float x) {     // 2^x; 2^0 == 1
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy of the first `bytes` bytes, zeros after
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// The step loop's y stores: through asm, so that the compiler does not hold
// the next step's shared-memory loads behind them (they touch other
// buffers; the chunk's barrier orders them against the y rows' reads).
__device__ __forceinline__ void st_shared(uint32_t a, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v));
}
__device__ __forceinline__ void st_shared(uint32_t a, __nv_bfloat16 v) {
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a),
                 "h"(*reinterpret_cast<unsigned short*>(&v)));
}

// N consecutive floats of shared memory, in the widest aligned loads
template <int N>
__device__ __forceinline__ void load_row(float (&r)[N], const float* p) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(p + i);
            r[i] = v.x, r[i + 1] = v.y, r[i + 2] = v.z, r[i + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) r[i] = p[i];
    }
}

template <typename T, int SP>
struct Smem {                       // dynamic shared memory, in bytes
    static constexpr int ROWS = 2 * TC * CB * sizeof(T);  // x, dt or y: 2 bufs
    static constexpr int BC = 2 * TC * 2 * SP * sizeof(float);
    static constexpr int BYTES = 3 * ROWS + BC;
};

// SP: states rounded up (4, 8, 16, 32).
template <typename T, int SP, bool VEC>
__global__ void __launch_bounds__(CB * SPLIT, 1)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                T* __restrict__ y, float* __restrict__ h_final,
                float* __restrict__ ckpt, int L,
                int Dm, int S, int64_t sxb, int64_t sxl, int64_t sdb,
                int64_t sdl, int64_t sBb, int64_t sBl, int64_t sCb,
                int64_t sCl) {
    constexpr int THREADS = CB * SPLIT;
    constexpr int SL = SP / SPLIT;                  // states of a thread
    constexpr int EPV = 16 / sizeof(T);             // elements per 16 bytes
    constexpr int SEGS = CB / EPV;                  // 16-byte pieces a row
    constexpr int BCW = 2 * SP;                     // a B/C row: B, then C
    constexpr int BROWS = THREADS / BCW;            // B/C rows a pass loads
    constexpr int NBC = (TC + BROWS - 1) / BROWS;
    using SM = Smem<T, SP>;
    extern __shared__ __align__(16) unsigned char smem[];
    auto xs = reinterpret_cast<T(*)[TC][CB]>(smem);
    auto ds = reinterpret_cast<T(*)[TC][CB]>(smem + SM::ROWS);
    auto ys = reinterpret_cast<T(*)[TC][CB]>(smem + 2 * SM::ROWS);
    auto bcs = reinterpret_cast<float(*)[TC][BCW]>(smem + 3 * SM::ROWS);

    const int tid = threadIdx.x;
    const int c = tid / SPLIT, part = tid % SPLIT;
    const int64_t b = blockIdx.y;
    const int d0 = blockIdx.x * CB, d = d0 + c;
    const bool live = d < Dm;
    float a2[SL], h[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
        const int s = part * SL + i;
        a2[i] = live && s < S ? A[(int64_t)d * S + s] * LOG2E : 0.f;
        h[i] = 0.f;
    }
    // D x_t joins the channel's first lane's part
    const float dskip = live && part == 0 ? Dv[d] : 0.f;

    const T* xb = x + b * sxb;
    const T* db = dt + b * sdb;
    T* yb = y + b * (int64_t)L * Dm;
    const int chunks = (L + TC - 1) / TC;

    // x and dt of chunk k into buffer buf
    auto stage = [&](int k, int buf) {
        const int t0 = k * TC, rows = min(TC, L - t0);
        if constexpr (VEC) {
            for (int e = tid; e < rows * SEGS; e += THREADS) {
                const int tt = e / SEGS, sg = e % SEGS, ch = d0 + sg * EPV;
                const int bytes = ch < Dm ? 16 : 0;     // Dm % EPV == 0
                const int64_t off = bytes ? ch : 0;
                cp_async16(smem_addr(&xs[buf][tt][sg * EPV]),
                           xb + (t0 + tt) * sxl + off, bytes);
                cp_async16(smem_addr(&ds[buf][tt][sg * EPV]),
                           db + (t0 + tt) * sdl + off, bytes);
            }
        } else {
            for (int e = tid; e < rows * CB; e += THREADS) {
                const int tt = e / CB, cc = e % CB;
                const bool in = d0 + cc < Dm;
                xs[buf][tt][cc] = in ? xb[(t0 + tt) * sxl + d0 + cc]
                                     : from_f32<T>(0.f);
                ds[buf][tt][cc] = in ? db[(t0 + tt) * sdl + d0 + cc]
                                     : from_f32<T>(0.f);
            }
        }
    };
    // y rows of chunk k from buffer buf
    auto emit = [&](int k, int buf) {
        const int t0 = k * TC, rows = min(TC, L - t0);
        if constexpr (VEC) {
            for (int e = tid; e < rows * SEGS; e += THREADS) {
                const int tt = e / SEGS, sg = e % SEGS, ch = d0 + sg * EPV;
                if (ch < Dm)
                    *reinterpret_cast<int4*>(yb + (int64_t)(t0 + tt) * Dm +
                                             ch) =
                        *reinterpret_cast<const int4*>(&ys[buf][tt][sg * EPV]);
            }
        } else {
            for (int e = tid; e < rows * CB; e += THREADS) {
                const int tt = e / CB, cc = e % CB;
                if (d0 + cc < Dm)
                    yb[(int64_t)(t0 + tt) * Dm + d0 + cc] = ys[buf][tt][cc];
            }
        }
    };
    // B and C of chunk k: this thread loads column j of rows brow0,
    // brow0 + BROWS, ... into registers, later written to shared memory as
    // float32
    const int j = tid % BCW, brow0 = tid / BCW, sj = j % SP;
    const bool bok = sj < S;
    const T* bsrc = j < SP ? Bm + b * sBb + sj : Cm + b * sCb + sj;
    const int64_t bst = j < SP ? sBl : sCl;
    T bcr[NBC];
    auto load_bc = [&](int k) {
#pragma unroll
        for (int p = 0; p < NBC; ++p) {
            const int tt = brow0 + p * BROWS, t = k * TC + tt;
            bcr[p] = bok && tt < TC && t < L ? bsrc[t * bst]
                                             : from_f32<T>(0.f);
        }
    };
    auto store_bc = [&](int buf) {
#pragma unroll
        for (int p = 0; p < NBC; ++p) {
            const int tt = brow0 + p * BROWS;
            if (tt < TC) bcs[buf][tt][j] = to_f32(bcr[p]);
        }
    };

    if (chunks > 0) {
        stage(0, 0);
        cp_async_commit();
        load_bc(0);
        store_bc(0);
    }
    for (int k = 0; k < chunks; ++k) {
        const int cur = k & 1, n = min(TC, L - k * TC);
        // the state before every CK-th step, for the backward
        if (ckpt != nullptr && k % (CK / TC) == 0 && live) {
            const int64_t nck = (L + CK - 1) / CK;
            float* cp = ckpt + ((b * nck + k / (CK / TC)) * Dm + d) * S;
#pragma unroll
            for (int i = 0; i < SL; ++i) {
                const int s = part * SL + i;
                if (s < S) cp[s] = h[i];
            }
        }
        cp_async_wait_all();    // this thread's copies of chunk k landed
        // Everyone's, with chunk k's B and C, and chunk k-1's y rows; every
        // thread is done reading chunk k-1's buffers, which chunk k+1 takes.
        __syncthreads();
        if (k + 1 < chunks) {
            stage(k + 1, cur ^ 1);
            cp_async_commit();
            load_bc(k + 1);
        }
        if (k > 0) emit(k - 1, cur ^ 1);

        float xv, dv, bv[SL], cv[SL], dec[SL];
        auto fetch = [&](int tt, float& xo, float& dto, float(&bo)[SL],
                         float(&co)[SL]) {
            xo = to_f32(xs[cur][tt][c]);
            dto = to_f32(ds[cur][tt][c]);
            load_row(bo, &bcs[cur][tt][part * SL]);
            load_row(co, &bcs[cur][tt][SP + part * SL]);
        };
        fetch(0, xv, dv, bv, cv);
#pragma unroll
        for (int i = 0; i < SL; ++i) dec[i] = ex2(dv * a2[i]);
        // step tt with its decays in dec; with `more`, step tt + 1's
        // operands and decays are read and computed alongside
        auto step = [&](int tt, bool more) {
            float xn, dn, bn[SL], cn[SL];
            if (more) fetch(tt + 1, xn, dn, bn, cn);
            const float u = dv * xv;
            float yv = dskip * xv;
#pragma unroll
            for (int i = 0; i < SL; ++i) {
                h[i] = fmaf(dec[i], h[i], u * bv[i]);
                yv = fmaf(h[i], cv[i], yv);
                if (more) dec[i] = ex2(dn * a2[i]);
            }
            yv += __shfl_xor_sync(FULL, yv, 1);     // the other lane's part
            if (part == 0)
                st_shared(smem_addr(&ys[cur][tt][c]), from_f32<T>(yv));
            if (more) {
                xv = xn, dv = dn;
#pragma unroll
                for (int i = 0; i < SL; ++i) bv[i] = bn[i], cv[i] = cn[i];
            }
        };
        if (n == TC) {
#pragma unroll
            for (int tt = 0; tt < TC; ++tt) step(tt, tt + 1 < TC);
        } else {
#pragma unroll 4
            for (int tt = 0; tt + 1 < n; ++tt) step(tt, true);
            step(n - 1, false);
        }
        // B/C of chunk k+1 go to the buffer chunk k-1 read, which every
        // thread left before this chunk's barrier
        if (k + 1 < chunks) store_bc(cur ^ 1);
    }
    if (chunks > 0) {
        __syncthreads();
        emit(chunks - 1, (chunks - 1) & 1);
    }
#pragma unroll
    for (int i = 0; i < SL; ++i) {
        const int s = part * SL + i;
        if (live && s < S) h_final[(b * Dm + d) * S + s] = h[i];
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int SP, bool VEC>
int launch_inst(const void* x, const void* dt, const void* A, const void* B,
                const void* C, const void* D, void* y, void* h, float* ckpt,
                int Bt, int L, int Dm, int S, const long long* st,
                void* stream) {
    auto kern = ssm_scan_kernel<T, SP, VEC>;
    constexpr int smem = Smem<T, SP>::BYTES;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Dm + CB - 1) / CB, Bt);
    kern<<<grid, CB * SPLIT, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<const float*>(D),
        static_cast<T*>(y), static_cast<float*>(h), ckpt, L, Dm, S, st[0],
        st[1],
        st[2], st[3], st[4], st[5], st[6], st[7]);
    return (int)cudaGetLastError();
}

template <typename T, int SP>
int launch_vec(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, void* y, void* h, float* ckpt,
               int Bt, int L, int Dm, int S, const long long* st,
               void* stream) {
    constexpr int EPV = 16 / sizeof(T);
    const bool vec = aligned16(x) && aligned16(dt) && aligned16(y) &&
                     Dm % EPV == 0 && st[0] % EPV == 0 && st[1] % EPV == 0 &&
                     st[2] % EPV == 0 && st[3] % EPV == 0;
    if (vec)
        return launch_inst<T, SP, true>(x, dt, A, B, C, D, y, h, ckpt, Bt,
                                        L, Dm, S, st, stream);
    return launch_inst<T, SP, false>(x, dt, A, B, C, D, y, h, ckpt, Bt, L,
                                     Dm, S, st, stream);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* y, void* h, float* ckpt,
           int Bt, int L, int Dm, int S, const long long* st, void* stream) {
    if (S < 1 || S > 32 || Bt > MAX_GRID_Y) return UNSUPPORTED;
    if (S <= 4)
        return launch_vec<T, 4>(x, dt, A, B, C, D, y, h, ckpt, Bt, L, Dm, S,
                                st, stream);
    if (S <= 8)
        return launch_vec<T, 8>(x, dt, A, B, C, D, y, h, ckpt, Bt, L, Dm, S,
                                st, stream);
    if (S <= 16)
        return launch_vec<T, 16>(x, dt, A, B, C, D, y, h, ckpt, Bt, L, Dm, S,
                                 st, stream);
    return launch_vec<T, 32>(x, dt, A, B, C, D, y, h, ckpt, Bt, L, Dm, S, st,
                             stream);
}


// ------------------------------------------------ backward
//
// No TPU kernel: the reference differentiates its chunked, rematerialized
// lax.scan (kernels/ssm_scan/ref.py) with jax.grad.  With a_t = exp(dt_t A)
// and u_t = dt_t x_t, the adjoint g_t = dL/dh_t runs back in time,
// g_t = a_{t+1} g_{t+1} + C_t dy_t, and
//   dC_t = sum_d h_t dy_t,  dB_t = sum_d g_t u_t,  du_t = sum_s g_t B_t,
//   dx_t = D dy_t + dt_t du_t,  ddt_t = x_t du_t + sum_s g_t h_{t-1} a_t A,
//   dA = sum_{b,t} g_t h_{t-1} a_t dt_t,  dD = sum_{b,t} dy_t x_t.
// No gradient flows through h_final.
//
// The forward's lane layout: a block owns CB = 128 channels of one batch
// row, two lanes a channel, each with S/2 states, g and A in registers.
// For each CK-step chunk, last first: pass A steps forward from the chunk's
// checkpoint and stores the state at every TS-step sub-chunk's start in a
// per-block global scratch (this thread's own words, L2-resident); then for
// each sub-chunk, last first, the TS states before each step are recomputed
// into shared memory and the adjoint walks back over them.  Recomputed
// states are the forward's own (the same ex2 and FMA order).  dx and ddt
// are written per step (sum_s over the channel's two lanes by one
// shuffle).  dB and dC are sums over channels: per step a warp sums its 16
// channels by shuffles, the block sums its 8 warps in order after each
// sub-chunk, and writes per-block partial sums; dA and dD go out per batch
// row; a second kernel sums the partials in a fixed order.  No atomics:
// the gradients are the same bits on every run.
//
// Bound on an H100: at least one exp per (t, channel, state) (a_t), the
// forward's 0.401 ms at hymba-1.5b's 4 x 8192 x 3200 x 16; this kernel
// computes three (two in the recompute), and its per-step channel sums
// take 64 shuffles a thread.

template <int SP>
struct ScanBwd {
    static constexpr int THREADS = CB * SPLIT;
    static constexpr int NW = THREADS / 32;       // warps
    static constexpr int SL = SP / SPLIT;         // states of a thread
    static constexpr int TS = 128 / SP;           // steps of a sub-chunk
    static constexpr int NSUB = CK / TS;          // sub-chunks of a chunk
    static constexpr int HS = TS * SL * THREADS;  // states in shared memory
    static constexpr int WS = 2 * TS * NW * SP;   // warp sums of dB and dC
    static constexpr int BYTES = (HS + WS) * 4;
    static constexpr int64_t HSUB = (int64_t)NSUB * SL * THREADS;  // a block's
    static_assert(CK % TS == 0, "sub-chunks tile a chunk");
};

// one forward step of the states of this thread (the forward kernel's
// arithmetic)
template <int SL>
__device__ __forceinline__ void step_states(float (&h)[SL],
                                            const float (&a2)[SL], float xv,
                                            float dv, const float (&bv)[SL]) {
    const float u = dv * xv;
#pragma unroll
    for (int i = 0; i < SL; ++i) h[i] = fmaf(ex2(dv * a2[i]), h[i], u * bv[i]);
}

// scratch layout, in floats: dB and dC partials [2][Bt][nblk][L][S], dA
// partials [Bt][Dm][S], dD partials [Bt][Dm], sub-chunk states
// [Bt][nblk][HSUB]
struct ScanScratch {
    int64_t bc, a, dd, hsub, total;
};
template <int SP>
ScanScratch scan_scratch(int Bt, int L, int Dm, int S, int nblk) {
    ScanScratch r;
    r.bc = 0;
    r.a = r.bc + 2 * (int64_t)Bt * nblk * L * S;
    r.dd = r.a + (int64_t)Bt * Dm * S;
    r.hsub = r.dd + (int64_t)Bt * Dm;
    r.total = r.hsub + (int64_t)Bt * nblk * ScanBwd<SP>::HSUB;
    return r;
}

template <typename T, int SP>
__global__ void __launch_bounds__(CB * SPLIT, 1)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv,
                    const T* __restrict__ dy, const float* __restrict__ ckpt,
                    T* __restrict__ dx, T* __restrict__ ddt,
                    float* __restrict__ scratch, ScanScratch sc, int L,
                    int Dm, int S, int nblk, int64_t sxb, int64_t sxl,
                    int64_t sdb, int64_t sdl, int64_t sBb, int64_t sBl,
                    int64_t sCb, int64_t sCl) {
    using P = ScanBwd<SP>;
    constexpr int SL = P::SL, TS = P::TS, NW = P::NW, THREADS = P::THREADS;
    extern __shared__ __align__(16) float smf[];
    float* hs = smf;                             // [TS][SL][THREADS]
    float* wsum = smf + P::HS;                   // [2][TS][NW][SP]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c = tid / SPLIT, part = tid % SPLIT;
    const int blk = blockIdx.x;
    const int64_t b = blockIdx.y;
    const int64_t Bt = gridDim.y;
    const int d = blk * CB + c;
    const bool live = d < Dm;
    const int nck = (L + CK - 1) / CK;
    float a2[SL], av[SL], g[SL], dA_acc[SL];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
        const int s = part * SL + i;
        av[i] = live && s < S ? A[(int64_t)d * S + s] : 0.f;
        a2[i] = av[i] * LOG2E;
        g[i] = dA_acc[i] = 0.f;
    }
    const float dskip = live ? Dv[d] : 0.f;
    float dD_acc = 0.f;
    float* hsub = scratch + sc.hsub + (b * nblk + blk) * P::HSUB;
    const T* xb = x + b * sxb;
    const T* db = dt + b * sdb;
    const T* yb = dy + b * (int64_t)L * Dm;
    const T* Bb = Bm + b * sBb;
    const T* Cb = Cm + b * sCb;
    // this thread's step operands
    auto load = [&](int t, float& xv, float& dv, float (&bv)[SL]) {
        xv = live ? to_f32(xb[t * sxl + d]) : 0.f;
        dv = live ? to_f32(db[t * sdl + d]) : 0.f;
#pragma unroll
        for (int i = 0; i < SL; ++i) {
            const int s = part * SL + i;
            bv[i] = s < S ? to_f32(Bb[t * sBl + s]) : 0.f;
        }
    };

    for (int ck = nck - 1; ck >= 0; --ck) {
        const int t0 = ck * CK, n = min(CK, L - t0);
        const int nsub = (n + TS - 1) / TS;
        // pass A: each sub-chunk's first state, from the checkpoint
        float h[SL];
#pragma unroll
        for (int i = 0; i < SL; ++i) {
            const int s = part * SL + i;
            h[i] = live && s < S
                       ? ckpt[((b * nck + ck) * Dm + d) * S + s] : 0.f;
        }
        for (int j = 0; j < nsub; ++j) {
#pragma unroll
            for (int i = 0; i < SL; ++i)
                hsub[(j * SL + i) * THREADS + tid] = h[i];
            if (j + 1 < nsub) {
                for (int t = t0 + j * TS; t < t0 + (j + 1) * TS; ++t) {
                    float xv, dv, bv[SL];
                    load(t, xv, dv, bv);
                    step_states(h, a2, xv, dv, bv);
                }
            }
        }
        for (int j = nsub - 1; j >= 0; --j) {
            const int ts0 = t0 + j * TS, m = min(TS, t0 + n - ts0);
            // pass B: the states before each step of the sub-chunk
#pragma unroll
            for (int i = 0; i < SL; ++i)
                h[i] = hsub[(j * SL + i) * THREADS + tid];
            for (int tt = 0; tt < m; ++tt) {
#pragma unroll
                for (int i = 0; i < SL; ++i)
                    hs[(tt * SL + i) * THREADS + tid] = h[i];
                float xv, dv, bv[SL];
                load(ts0 + tt, xv, dv, bv);
                step_states(h, a2, xv, dv, bv);
            }
            // the adjoint, back over the sub-chunk
            for (int tt = m - 1; tt >= 0; --tt) {
                const int t = ts0 + tt;
                float xv, dv, bv[SL], cv[SL];
                load(t, xv, dv, bv);
#pragma unroll
                for (int i = 0; i < SL; ++i) {
                    const int s = part * SL + i;
                    cv[i] = s < S ? to_f32(Cb[t * sCl + s]) : 0.f;
                }
                const float gy = live ? to_f32(yb[(int64_t)t * Dm + d]) : 0.f;
                const float u = dv * xv;
                float du = 0.f, dap = 0.f, cb[SL], cc[SL];
#pragma unroll
                for (int i = 0; i < SL; ++i) {
                    const float hp = hs[(tt * SL + i) * THREADS + tid];
                    const float a = ex2(dv * a2[i]);
                    const float hc = fmaf(a, hp, u * bv[i]);
                    g[i] = fmaf(cv[i], gy, g[i]);
                    cb[i] = g[i] * u;
                    cc[i] = hc * gy;
                    du = fmaf(g[i], bv[i], du);
                    const float gha = g[i] * hp * a;
                    dap = fmaf(gha, av[i], dap);
                    dA_acc[i] = fmaf(gha, dv, dA_acc[i]);
                    g[i] *= a;
                }
                du += __shfl_xor_sync(FULL, du, 1);      // the other lane's
                dap += __shfl_xor_sync(FULL, dap, 1);
                if (live) {
                    const int64_t o = (b * L + t) * Dm + d;
                    if (part == 0)
                        dx[o] = from_f32<T>(fmaf(dskip, gy, dv * du));
                    else
                        ddt[o] = from_f32<T>(fmaf(xv, du, dap));
                }
                if (part == 0) dD_acc = fmaf(gy, xv, dD_acc);
                // the warp's 16 channels summed; lanes 0 and 1 hold them
#pragma unroll
                for (int off = 2; off < 32; off <<= 1) {
#pragma unroll
                    for (int i = 0; i < SL; ++i) {
                        cb[i] += __shfl_xor_sync(FULL, cb[i], off);
                        cc[i] += __shfl_xor_sync(FULL, cc[i], off);
                    }
                }
                if (lane < SPLIT) {
#pragma unroll
                    for (int i = 0; i < SL; ++i) {
                        const int s = part * SL + i;
                        wsum[((0 * TS + tt) * NW + warp) * SP + s] = cb[i];
                        wsum[((1 * TS + tt) * NW + warp) * SP + s] = cc[i];
                    }
                }
            }
            __syncthreads();
            // the block's sums over its warps, in order: per-block partials
            for (int e = tid; e < 2 * m * SP; e += THREADS) {
                const int which = e / (m * SP), r = e % (m * SP);
                const int tt = r / SP, s = r % SP;
                if (s < S) {
                    float sum = 0.f;
#pragma unroll
                    for (int w = 0; w < NW; ++w)
                        sum += wsum[((which * TS + tt) * NW + w) * SP + s];
                    scratch[sc.bc +
                            (((which * Bt + b) * nblk + blk) * L + ts0 + tt) *
                                S + s] = sum;
                }
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int i = 0; i < SL; ++i) {
        const int s = part * SL + i;
        if (live && s < S) scratch[sc.a + (b * Dm + d) * S + s] = dA_acc[i];
    }
    if (live && part == 0) scratch[sc.dd + b * Dm + d] = dD_acc;
}

// the second pass: dB, dC over channel blocks, dA, dD over batch rows, each
// summed in index order
template <typename T>
__global__ void ssm_scan_bwd_reduce_kernel(const float* __restrict__ scratch,
                                           ScanScratch sc, T* __restrict__ dB,
                                           T* __restrict__ dC,
                                           float* __restrict__ dA,
                                           float* __restrict__ dD, int Bt,
                                           int L, int Dm, int S, int nblk) {
    const int64_t LS = (int64_t)L * S, nBC = (int64_t)Bt * LS;
    const int64_t total = 2 * nBC + (int64_t)Dm * S + Dm;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += (int64_t)gridDim.x * blockDim.x) {
        if (e < 2 * nBC) {
            const int64_t which = e / nBC, r = e % nBC;
            const int64_t b = r / LS, ts = r % LS;
            const float* p =
                scratch + sc.bc + ((which * Bt + b) * nblk) * LS + ts;
            float sum = 0.f;
            for (int k = 0; k < nblk; ++k) sum += p[k * LS];
            (which ? dC : dB)[r] = from_f32<T>(sum);
        } else if (e < 2 * nBC + (int64_t)Dm * S) {
            const int64_t j = e - 2 * nBC;
            float sum = 0.f;
            for (int b = 0; b < Bt; ++b)
                sum += scratch[sc.a + (int64_t)b * Dm * S + j];
            dA[j] = sum;
        } else {
            const int64_t j = e - 2 * nBC - (int64_t)Dm * S;
            float sum = 0.f;
            for (int b = 0; b < Bt; ++b)
                sum += scratch[sc.dd + (int64_t)b * Dm + j];
            dD[j] = sum;
        }
    }
}

template <typename T, int SP>
int launch_bwd(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, const void* dy,
               const float* ckpt, void* dx, void* ddt, float* dA, void* dB,
               void* dC, float* dD, float* scratch, int Bt, int L, int Dm,
               int S, const long long* st, void* stream) {
    using P = ScanBwd<SP>;
    const int nblk = (Dm + CB - 1) / CB;
    const ScanScratch sc = scan_scratch<SP>(Bt, L, Dm, S, nblk);
    auto kern = ssm_scan_bwd_kernel<T, SP>;
    static bool smem_set = false;            // once per instance
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    dim3 grid(nblk, Bt);
    kern<<<grid, P::THREADS, P::BYTES, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<const float*>(D),
        static_cast<const T*>(dy), ckpt, static_cast<T*>(dx),
        static_cast<T*>(ddt), scratch, sc, L, Dm, S, nblk, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7]);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int64_t total = 2 * (int64_t)Bt * L * S + (int64_t)Dm * S + Dm;
    const int64_t blocks = std::min<int64_t>((total + 255) / 256, 1 << 16);
    ssm_scan_bwd_reduce_kernel<T><<<(unsigned)blocks, 256, 0,
                                    (cudaStream_t)stream>>>(
        scratch, sc, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD, Bt, L,
        Dm, S, nblk);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_s(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* D, const void* dy,
                 const float* ckpt, void* dx, void* ddt, float* dA, void* dB,
                 void* dC, float* dD, float* scratch, int Bt, int L, int Dm,
                 int S, const long long* st, void* stream) {
    if (S < 1 || S > 32 || Bt > MAX_GRID_Y || Bt < 1 || L < 1 || Dm < 1)
        return UNSUPPORTED;
#define SCAN_BWD_SP(SP)                                                       \
    return launch_bwd<T, SP>(x, dt, A, B, C, D, dy, ckpt, dx, ddt, dA, dB, dC, \
                             dD, scratch, Bt, L, Dm, S, st, stream)
    if (S <= 4) SCAN_BWD_SP(4);
    if (S <= 8) SCAN_BWD_SP(8);
    if (S <= 16) SCAN_BWD_SP(16);
    SCAN_BWD_SP(32);
#undef SCAN_BWD_SP
}

}  // namespace

// strides, in elements: (batch, time) of x, dt, B and C in turn; ckpt
// (Bt, ceil(L / 256), Dm, S) float32 or NULL.  Returns UNSUPPORTED,
// launching nothing, unless 1 <= S <= 32 and Bt fits the grid (<= 65535).
#define SCAN_ENTRY(NAME, T)                                                   \
    extern "C" int NAME(const void* x, const void* dt, const void* A,         \
                        const void* B, const void* C, const void* D, void* y, \
                        void* h, float* ckpt, int Bt, int L, int Dm, int S,   \
                        long long sxb, long long sxl, long long sdb,          \
                        long long sdl, long long sBb, long long sBl,          \
                        long long sCb, long long sCl, void* stream) {         \
        const long long st[8] = {sxb, sxl, sdb, sdl, sBb, sBl, sCb, sCl};     \
        return launch<T>(x, dt, A, B, C, D, y, h, ckpt, Bt, L, Dm, S, st,     \
                         stream);                                             \
    }

SCAN_ENTRY(ssm_scan_f32, float)
SCAN_ENTRY(ssm_scan_bf16, __nv_bfloat16)

// The backward: x, dt, A, B, C, D as the forward's (same strides), dy
// (Bt, L, Dm) and the forward's checkpoints contiguous; dx, ddt (Bt, L, Dm)
// and dB, dC (Bt, L, S) in x's dtype, dA (Dm, S) and dD (Dm) float32, all
// contiguous outputs; scratch of ssm_scan_bwd_scratch's size.  Two
// launches.  Returns UNSUPPORTED unless 1 <= S <= 32, 1 <= Bt <= 65535 and
// L, Dm >= 1.
#define SCAN_BWD_ENTRY(NAME, T)                                               \
    extern "C" int NAME(const void* x, const void* dt, const void* A,         \
                        const void* B, const void* C, const void* D,          \
                        const void* dy, const float* ckpt, void* dx,          \
                        void* ddt, float* dA, void* dB, void* dC, float* dD,  \
                        float* scratch, int Bt, int L, int Dm, int S,         \
                        long long sxb, long long sxl, long long sdb,          \
                        long long sdl, long long sBb, long long sBl,          \
                        long long sCb, long long sCl, void* stream) {         \
        const long long st[8] = {sxb, sxl, sdb, sdl, sBb, sBl, sCb, sCl};     \
        return launch_bwd_s<T>(x, dt, A, B, C, D, dy, ckpt, dx, ddt, dA, dB,  \
                               dC, dD, scratch, Bt, L, Dm, S, st, stream);    \
    }

SCAN_BWD_ENTRY(ssm_scan_bwd_f32, float)
SCAN_BWD_ENTRY(ssm_scan_bwd_bf16, __nv_bfloat16)

// The backward's scratch: sizes[0] floats; sizes[1] the channel blocks.
extern "C" int ssm_scan_bwd_scratch(int Bt, int L, int Dm, int S,
                                    long long* sizes) {
    if (S < 1 || S > 32) return UNSUPPORTED;
    const int nblk = (Dm + CB - 1) / CB;
    const ScanScratch sc =
        S <= 4    ? scan_scratch<4>(Bt, L, Dm, S, nblk)
        : S <= 8  ? scan_scratch<8>(Bt, L, Dm, S, nblk)
        : S <= 16 ? scan_scratch<16>(Bt, L, Dm, S, nblk)
                  : scan_scratch<32>(Bt, L, Dm, S, nblk);
    sizes[0] = sc.total;
    sizes[1] = nblk;
    return 0;
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
