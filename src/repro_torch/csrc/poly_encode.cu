// Polynomial encode of the coded matmul: E[w] = sum_k G[w, k] * X[k].
//
// Replaces the TPU kernel poly_encode_pallas (body _encode_kernel) in
// src/repro/kernels/poly_encode/kernel.py.  The Pallas grid (W, R/br, C/bc,
// K) reads every X[k] tile once per output worker w, because X's index map
// ignores w: W*K tile reads for W outputs.
//
// Bound on an H100: about K multiply-adds per element read, so the encode
// is bound by device-memory bytes — X read once plus the W outputs written
// once (at the serving shape the outputs are 3-6x the input bytes).
//
// Design: each thread owns one (r, c) element of one request.  It loads the
// K values of X there once, into registers, and writes all W outputs from
// them, accumulating in float32; neighbouring threads own neighbouring c, so
// both the X loads and the W output stores are coalesced.  G (at most a few
// hundred floats) sits in shared memory and is read as a broadcast.  The
// kernel takes X's four strides (request, k, r, c), so the strided block
// views of split_contraction need no copy, and it takes a request batch
// axis so one launch encodes the whole batch.
//
// A complex generator is encoded in one launch over [G.real; G.imag]
// (parts = 2): generator row g = p*W + w writes output part p, which the
// output layout (parts, batch, W, R, C) keeps contiguous per part, so the
// real and the imaginary worker operands each fold into one worker axis.
// Each C entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(THREADS)
poly_encode_kernel(const float* __restrict__ G, const T* __restrict__ X,
                   T* __restrict__ E, int rows, int W, int K, int R, int C,
                   int Bt, int64_t sXb, int64_t sXk, int64_t sXr,
                   int64_t sXc) {
    extern __shared__ float g_s[];  // rows x K generator coefficients
    for (int i = threadIdx.x; i < rows * K; i += blockDim.x) g_s[i] = G[i];
    __syncthreads();

    const int64_t b = blockIdx.y;
    const int64_t RC = (int64_t)R * C;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < RC;
         e += stride) {
        const int64_t r = e / C, c = e % C;
        const T* xp = X + b * sXb + r * sXr + c * sXc;
        float x[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) x[k] = k < K ? to_f32(xp[k * sXk]) : 0.f;
        for (int g = 0; g < rows; ++g) {
            const float* gk = g_s + g * K;
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
                if (k < K) acc = fmaf(gk[k], x[k], acc);
            const int64_t p = g / W, w = g % W;
            store_f32(E + ((p * Bt + b) * W + w) * RC + e, acc);
        }
    }
}

template <typename T, int KMAX>
int launch_k(const void* G, const void* X, void* E, int rows, int W, int K,
             int R, int C, int Bt, long long sXb, long long sXk,
             long long sXr, long long sXc, void* stream) {
    const int64_t RC = (int64_t)R * C;
    int64_t blocks = (RC + THREADS - 1) / THREADS;
    if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
    dim3 grid((unsigned)blocks, Bt);
    const size_t smem = sizeof(float) * (size_t)rows * K;
    poly_encode_kernel<T, KMAX><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(G), static_cast<const T*>(X),
        static_cast<T*>(E), rows, W, K, R, C, Bt, sXb, sXk, sXr, sXc);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* G, const void* X, void* E, int rows, int W, int K,
           int R, int C, int Bt, long long sXb, long long sXk, long long sXr,
           long long sXc, void* stream) {
    if (K <= 8)
        return launch_k<T, 8>(G, X, E, rows, W, K, R, C, Bt, sXb, sXk, sXr,
                              sXc, stream);
    if (K <= 16)
        return launch_k<T, 16>(G, X, E, rows, W, K, R, C, Bt, sXb, sXk, sXr,
                               sXc, stream);
    if (K <= 32)
        return launch_k<T, 32>(G, X, E, rows, W, K, R, C, Bt, sXb, sXk, sXr,
                               sXc, stream);
    if (K <= 64)
        return launch_k<T, 64>(G, X, E, rows, W, K, R, C, Bt, sXb, sXk, sXr,
                               sXc, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// rows = parts * W generator rows; E has shape (parts, Bt, W, R, C).
extern "C" int poly_encode_f32(const void* G, const void* X, void* E, int rows,
                               int W, int K, int R, int C, int Bt,
                               long long sXb, long long sXk, long long sXr,
                               long long sXc, void* stream) {
    return launch<float>(G, X, E, rows, W, K, R, C, Bt, sXb, sXk, sXr, sXc,
                         stream);
}

extern "C" int poly_encode_bf16(const void* G, const void* X, void* E,
                                int rows, int W, int K, int R, int C, int Bt,
                                long long sXb, long long sXk, long long sXr,
                                long long sXc, void* stream) {
    return launch<__nv_bfloat16>(G, X, E, rows, W, K, R, C, Bt, sXb, sXk, sXr,
                                 sXc, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
