// Batched worker GEMM of the coded matmul: C[w] (=, +=, -=) A[w] @ B[w].
//
// Replaces the TPU kernel coded_matmul_pallas (body _matmul_kernel) in
// src/repro/kernels/coded_matmul/kernel.py: every worker's task in every
// code of the paper is one encoded GEMM P[w] = E_A[w] @ E_B[w], and the
// serving backend folds the request batch and the workers into one W axis.
//
// Bound on an H100: at the serving shape (W=96, 2048x4096 @ 4096x2048) the
// work is 3.3 TFLOP against 8 GB of operands and products, so it is bound
// by operations.  The reference tolerance (2e-4 relative) does not admit
// TF32, so in float32 the ceiling is the FP32 vector rate of the CUDA cores,
// not the tensor cores.  bf16 inputs are widened to float32 on load and take
// the same path.
//
// Design (simple first, fast later): a classic SIMT tiling.  A block owns a
// 128x128 tile of C and walks the contraction in steps of 8.  A and B tiles
// are staged in shared memory as float32 (A transposed, padded so the
// transposing store has no bank conflicts); each of the 256 threads keeps an
// 8x8 register micro-tile and reads its operands as float4 from shared
// memory.  The next contraction step is loaded into registers while the
// current one is multiplied, so global latency overlaps the FMAs.  The M, N
// and Z edges are masked here by loading zeros and guarding stores, so the
// wrapper needs no padded copy of the operands (the Pallas kernel pads Z).
//
// accumulate != 0 turns the store into C = C + sign*A@B, which lets the
// complex worker products run as four launches into two outputs with no
// temporaries.  Each C entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
coded_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, int M, int N, int Z, int64_t sAw,
                    int64_t sBw, int64_t sCw, float sign, int accumulate) {
    __shared__ __align__(16) float As[BK][BM + PAD];
    __shared__ __align__(16) float Bs[BK][BN];

    const int64_t w = blockIdx.z;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    A += w * sAw;
    B += w * sBw;
    C += w * sCw;

    const int tid = threadIdx.x;
    const int tr = tid / 16;  // micro-tile rows tr*4.. and 64+tr*4..
    const int tc = tid % 16;  // micro-tile cols tc*4.. and 64+tc*4..

    float ra[4], rb[4];
    auto load_tile = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / BK, c = idx % BK;
            const int gm = m0 + r, gz = k0 + c;
            ra[i] = (gm < M && gz < Z) ? to_f32(A[(int64_t)gm * Z + gz]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / BN, c = idx % BN;
            const int gz = k0 + r, gn = n0 + c;
            rb[i] = (gz < Z && gn < N) ? to_f32(B[(int64_t)gz * N + gn]) : 0.f;
        }
    };
    auto store_tile = [&]() {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * THREADS;
            As[idx % BK][idx / BK] = ra[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * THREADS;
            Bs[idx / BN][idx % BN] = rb[i];
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load_tile(0);
    for (int k0 = 0; k0 < Z; k0 += BK) {
        store_tile();
        __syncthreads();
        if (k0 + BK < Z) load_tile(k0 + BK);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[k][tr * 4]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&As[k][64 + tr * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tc * 4]);
            const float4 b1 =
                *reinterpret_cast<const float4*>(&Bs[k][64 + tc * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int gm = m0 + (i < 4 ? tr * 4 + i : 64 + tr * 4 + (i - 4));
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int gn = n0 + (j < 4 ? tc * 4 + j : 64 + tc * 4 + (j - 4));
            if (gn >= N) continue;
            T* p = C + (int64_t)gm * N + gn;
            float v = sign * acc[i][j];
            if (accumulate) v = to_f32(*p) + v;
            store_f32(p, v);
        }
    }
}

template <typename T>
int launch(const void* A, const void* B, void* C, int W, int M, int N, int Z,
           long long sAw, long long sBw, long long sCw, int sign,
           int accumulate, void* stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, W);
    coded_matmul_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
        M, N, Z, sAw, sBw, sCw, sign < 0 ? -1.f : 1.f, accumulate);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coded_matmul_f32(const void* A, const void* B, void* C, int W,
                                int M, int N, int Z, long long sAw,
                                long long sBw, long long sCw, int sign,
                                int accumulate, void* stream) {
    return launch<float>(A, B, C, W, M, N, Z, sAw, sBw, sCw, sign, accumulate,
                         stream);
}

extern "C" int coded_matmul_bf16(const void* A, const void* B, void* C, int W,
                                 int M, int N, int Z, long long sAw,
                                 long long sBw, long long sCw, int sign,
                                 int accumulate, void* stream) {
    return launch<__nv_bfloat16>(A, B, C, W, M, N, Z, sAw, sBw, sCw, sign,
                                 accumulate, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
