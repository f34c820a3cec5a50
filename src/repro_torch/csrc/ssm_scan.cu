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
// Bound on an H100: per (t, d, s) it reads a few bytes and does one exp
// and a few FMAs.  At hymba-1.5b's prefill (Bt=4, L=8192, Dm=3200, S=16,
// bf16) the bytes (x, dt, B, C read once, y written once: 0.63 GB) take
// 0.19 ms at 3.35 TB/s, and the 1.68e9 exps 0.4 ms on the special-function
// units (16 per SM per clock); the time loop, though, is a chain of 8192
// dependent steps per state.
//
// Design: work is parallel over (batch, channel, state).  One thread owns
// one state s of one channel d: its h sits in a register for the whole
// sequence, and the SP >= S lanes of a channel sit in one warp, so y_t is
// the sum over s by warp shuffles.  A block owns 256/SP channels of one
// batch row; time runs in chunks of 32 steps whose x, dt (the block's
// channels) and B, C (all states) are staged in shared memory by the whole
// block with coalesced loads, so device-memory latency is paid once per
// chunk and not on the sequential chain; the chunk's y goes back through
// shared memory as coalesced stores.  Lanes past S keep h = 0.  No time
// padding: the loop ends at L.  exp is expf (full precision).
//
// Strides: x, dt, B and C take batch and time strides with a contiguous
// last dim (B and C are column slices of the x_proj output, row stride
// r + 2S); A is (Dm, S), D (Dm,), y (Bt, L, Dm) and h_final (Bt, Dm, S) are
// contiguous.  Each C entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNSUPPORTED = -1;     // no instance takes the arguments
constexpr int MAX_GRID_Y = 65535;
constexpr int TC = 32;              // time steps per staged chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T, int SP>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                T* __restrict__ y, float* __restrict__ h_final, int L,
                int Dm, int S, int64_t sxb, int64_t sxl, int64_t sdb,
                int64_t sdl, int64_t sBb, int64_t sBl, int64_t sCb,
                int64_t sCl) {
    constexpr int CB = THREADS / SP;    // channels per block
    __shared__ float xs[TC][CB], ds[TC][CB], ys[TC][CB];
    __shared__ float Bs[TC][SP], Cs[TC][SP];

    const int tid = threadIdx.x;
    const int64_t b = blockIdx.y;
    const int d0 = blockIdx.x * CB;
    const int c = tid / SP, s = tid % SP;
    const int d = d0 + c;
    const bool live = d < Dm && s < S;
    const float a = live ? A[(int64_t)d * S + s] : 0.f;
    const float dskip = d < Dm ? Dv[d] : 0.f;
    float h = 0.f;

    const T* xb = x + b * sxb;
    const T* db = dt + b * sdb;
    const T* Bb = Bm + b * sBb;
    const T* Cb = Cm + b * sCb;
    T* yb = y + b * (int64_t)L * Dm;
    for (int t0 = 0; t0 < L; t0 += TC) {
        const int n = min(TC, L - t0);
        // stage the chunk (zeros past L, Dm and S: h passes through them)
        for (int e = tid; e < TC * CB; e += THREADS) {
            const int tt = e / CB, cc = e % CB;
            float xv = 0.f, dv = 0.f;
            if (tt < n && d0 + cc < Dm) {
                xv = to_f32(xb[(int64_t)(t0 + tt) * sxl + d0 + cc]);
                dv = to_f32(db[(int64_t)(t0 + tt) * sdl + d0 + cc]);
            }
            xs[tt][cc] = xv;
            ds[tt][cc] = dv;
        }
        for (int e = tid; e < TC * SP; e += THREADS) {
            const int tt = e / SP, ss = e % SP;
            float bv = 0.f, cv = 0.f;
            if (tt < n && ss < S) {
                bv = to_f32(Bb[(int64_t)(t0 + tt) * sBl + ss]);
                cv = to_f32(Cb[(int64_t)(t0 + tt) * sCl + ss]);
            }
            Bs[tt][ss] = bv;
            Cs[tt][ss] = cv;
        }
        __syncthreads();
        for (int tt = 0; tt < n; ++tt) {
            const float xv = xs[tt][c], dv = ds[tt][c];
            h = expf(dv * a) * h + (dv * xv) * Bs[tt][s];
            float part = h * Cs[tt][s];
#pragma unroll
            for (int off = SP / 2; off > 0; off >>= 1)
                part += __shfl_xor_sync(FULL, part, off);
            if (s == 0) ys[tt][c] = part + dskip * xv;
        }
        __syncthreads();
        for (int e = tid; e < TC * CB; e += THREADS) {
            const int tt = e / CB, cc = e % CB;
            if (tt < n && d0 + cc < Dm)
                store_f32(yb + (int64_t)(t0 + tt) * Dm + d0 + cc, ys[tt][cc]);
        }
        // the next chunk's staging writes xs/ds/Bs/Cs, which the loop above
        // finished reading before the barrier, and its time loop writes ys
        // only after the next barrier, once these stores have read it
    }
    if (live) h_final[(b * Dm + d) * S + s] = h;
}

template <typename T, int SP>
int launch_sp(const void* x, const void* dt, const void* A, const void* B,
              const void* C, const void* D, void* y, void* h, int Bt, int L,
              int Dm, int S, const long long* st, void* stream) {
    constexpr int CB = THREADS / SP;
    dim3 grid((Dm + CB - 1) / CB, Bt);
    ssm_scan_kernel<T, SP><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<const float*>(D),
        static_cast<T*>(y), static_cast<float*>(h), L, Dm, S, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7]);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* y, void* h, int Bt, int L,
           int Dm, int S, const long long* st, void* stream) {
    if (S < 1 || Bt > MAX_GRID_Y) return UNSUPPORTED;
    if (S <= 4)
        return launch_sp<T, 4>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                               stream);
    if (S <= 8)
        return launch_sp<T, 8>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                               stream);
    if (S <= 16)
        return launch_sp<T, 16>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                                stream);
    if (S <= 32)
        return launch_sp<T, 32>(x, dt, A, B, C, D, y, h, Bt, L, Dm, S, st,
                                stream);
    return UNSUPPORTED;
}

}  // namespace

// strides, in elements: (batch, time) of x, dt, B and C in turn.  Returns
// UNSUPPORTED, launching nothing, unless 1 <= S <= 32 (the states of a
// channel share one warp) and Bt fits the grid (<= 65535).
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
