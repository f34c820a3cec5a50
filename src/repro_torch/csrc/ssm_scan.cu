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

namespace {

constexpr int UNSUPPORTED = -1;     // no instance takes the arguments
constexpr int MAX_GRID_Y = 65535;
constexpr int CB = 128;             // channels per block
constexpr int TC = 32;              // time steps per staged chunk
constexpr int SPLIT = 2;            // lanes per channel
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
                T* __restrict__ y, float* __restrict__ h_final, int L,
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
                const void* C, const void* D, void* y, void* h, int Bt, int L,
                int Dm, int S, const long long* st, void* stream) {
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
        static_cast<T*>(y), static_cast<float*>(h), L, Dm, S, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7]);
    return (int)cudaGetLastError();
}

template <typename T, int SP>
int launch_vec(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, void* y, void* h, int Bt, int L,
               int Dm, int S, const long long* st, void* stream) {
    constexpr int EPV = 16 / sizeof(T);
    const bool vec = aligned16(x) && aligned16(dt) && aligned16(y) &&
                     Dm % EPV == 0 && st[0] % EPV == 0 && st[1] % EPV == 0 &&
                     st[2] % EPV == 0 && st[3] % EPV == 0;
    if (vec)
        return launch_inst<T, SP, true>(x, dt, A, B, C, D, y, h, Bt, L, Dm,
                                        S, st, stream);
    return launch_inst<T, SP, false>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S,
                                     st, stream);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* y, void* h, int Bt, int L,
           int Dm, int S, const long long* st, void* stream) {
    if (S < 1 || S > 32 || Bt > MAX_GRID_Y) return UNSUPPORTED;
    if (S <= 4)
        return launch_vec<T, 4>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                                stream);
    if (S <= 8)
        return launch_vec<T, 8>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                                stream);
    if (S <= 16)
        return launch_vec<T, 16>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                                 stream);
    return launch_vec<T, 32>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                             stream);
}

}  // namespace

// strides, in elements: (batch, time) of x, dt, B and C in turn.  Returns
// UNSUPPORTED, launching nothing, unless 1 <= S <= 32 and Bt fits the grid
// (<= 65535).
#define SCAN_ENTRY(NAME, T)                                                   \
    extern "C" int NAME(const void* x, const void* dt, const void* A,         \
                        const void* B, const void* C, const void* D, void* y, \
                        void* h, int Bt, int L, int Dm, int S, long long sxb, \
                        long long sxl, long long sdb, long long sdl,          \
                        long long sBb, long long sBl, long long sCb,          \
                        long long sCl, void* stream) {                        \
        const long long st[8] = {sxb, sxl, sdb, sdl, sBb, sBl, sCb, sCl};     \
        return launch<T>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st, stream);  \
    }

SCAN_ENTRY(ssm_scan_f32, float)
SCAN_ENTRY(ssm_scan_bf16, __nv_bfloat16)

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
