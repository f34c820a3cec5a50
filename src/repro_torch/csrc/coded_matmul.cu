// Batched worker GEMM of the coded matmul: C[w] (=, +=, -=) A[w] @ B[w].
//
// Replaces the TPU kernel coded_matmul_pallas (body _matmul_kernel) in
// src/repro/kernels/coded_matmul/kernel.py: every worker's task in every
// code of the paper is one encoded GEMM P[w] = E_A[w] @ E_B[w], and the
// serving backend folds the request batch and the workers into one W axis.
//
// Bound on an H100: at the serving shape (W=96, 2048x4096 @ 4096x2048) the
// work is 3.3 TFLOP against 8 GB of operands and products, so it is bound
// by operations.  The float32 kernel runs three TF32 tensor-core products
// per output ("3xTF32"), so its bound counts 3 x 2*M*N*Z operations at the
// dense TF32 rate (495 TFLOP/s): 20.0 ms at the serving shape.
//
// Two kernels, chosen by dtype (an explicit dispatch in the C entries):
//
// float32 -> coded_matmul_tf32x3_kernel, on the tensor cores.  One TF32
// pass rounds each operand to 10 mantissa bits, an error of about 0.02
// per output at Z = 4096 with N(0, 1) operands, against the reference's
// float32 tolerance of 2e-4 * sqrt(Z) = 0.0128 (and it would spoil
// L-SAC's exact decode).  So each operand element is split once, in
// registers, after its fragment is read from shared memory:
//   hi = rna_tf32(x),  lo = rna_tf32(x - hi),
// where rna_tf32 rounds to TF32 as cvt.rna.tf32.f32 does, but in two
// integer instructions: the conversion instruction has a lower throughput,
// and the splits compete with the mma's for the warp schedulers.  Then
// A_lo*B_hi + A_hi*B_lo + A_hi*B_hi accumulate in float32 with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32; the dropped A_lo*B_lo term
// is about 2^-22 of a product, so the result keeps float32 accuracy.  The
// tensor cores' own float32 accumulation truncates (rounds toward zero),
// a bias toward zero that grows with the sum it is added to: accumulating
// all passes into the running sum left the result 2.9e-5 (relative
// Frobenius) from float32 at Z = 4096.  So the passes of one 32-deep
// k-tile go into a second set of accumulators that starts from zero, and
// that is added to the running sum by ordinary (round-to-nearest) FADDs.
// Two accumulator sets leave no room for a 64x64 warp tile: a block of 8
// warps owns a 128x128 tile of C, each warp 64x32 (4 x 4 mma tiles, 2 x 64
// float32 accumulators per thread), one block per SM.  It walks Z in
// steps of 32 through a 4-stage cp.async ring of A (128 x 32) and B
// (32 x 128) tiles.  That mma shape takes only .row.col, and
// ldmatrix.trans has no 32-bit form, so each B fragment element is read on
// its own from the row-major B tile.  The shared rows are padded (A by 4
// floats, B by 8) so that the fragment reads of a warp hit 32 distinct
// banks.  Rows whose byte length is not a multiple of 16
// (Z or N % 4 != 0, or a worker stride or base not 16-byte aligned) take
// the VEC = false instance, which copies 4 bytes at a time.
//
// bf16 -> coded_matmul_simt_kernel, the first design, on the CUDA cores
// (bf16 is on no main path: the serving backends cast to float32).  A block
// owns a 128x128 tile of C and walks the contraction in steps of 8.  A and
// B tiles are staged in shared memory as float32 (A transposed, padded so
// the transposing store has no bank conflicts); each of the 256 threads
// keeps an 8x8 register micro-tile and reads its operands as float4 from
// shared memory.  The next contraction step is loaded into registers while
// the current one is multiplied.
//
// Both mask the M, N and Z edges by loading zeros and guarding stores, so
// the wrapper needs no padded copy of the operands (the Pallas kernel pads
// Z).  accumulate != 0 turns the store into C = C + sign*A@B, which lets
// the complex worker products run as four launches into two outputs with
// no temporaries.  Each C entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------ bf16: CUDA cores

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
coded_matmul_simt_kernel(const T* __restrict__ A, const T* __restrict__ B,
                         T* __restrict__ C, int M, int N, int Z, int64_t sAw,
                         int64_t sBw, int64_t sCw, float sign,
                         int accumulate) {
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


// ------------------------------------------------ float32: 3xTF32

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_STAGES = 4;
constexpr int TC_THREADS = 256;                 // 8 warps, 2 x 4 of 64x32
constexpr int LDA = TC_BK + 4;                  // padded rows (floats)
constexpr int LDB = TC_BN + 8;
constexpr int A_STAGE = TC_BM * LDA, B_STAGE = TC_BK * LDB;
constexpr int TC_SMEM = TC_STAGES * (A_STAGE + B_STAGE) * 4;   // 143,360 B

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared copies; bytes == 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32, on the integer pipe (half a TF32 ulp added to the
// magnitude bits, the 13 dropped bits cleared)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = rna_tf32(x);
    lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate.
// Fragments (PTX ISA, lane = 4*g + t): a0 (row g, col t), a1 (row g+8),
// a2 (col t+4), a3 (row g+8, col t+4); b0 (k t, n g), b1 (k t+4); c0, c1
// (row g, cols 2t, 2t+1), c2, c3 (row g+8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a * b, the accumulator starting from zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
}

template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 1)
coded_matmul_tf32x3_kernel(const float* __restrict__ A,
                           const float* __restrict__ B, float* __restrict__ C,
                           int M, int N, int Z, int64_t sAw, int64_t sBw,
                           int64_t sCw, float sign, int accumulate) {
    extern __shared__ __align__(16) float sm[];
    float* As = sm;                              // [STAGES][BM][LDA]
    float* Bs = sm + TC_STAGES * A_STAGE;        // [STAGES][BK][LDB]

    const int64_t w = blockIdx.z;
    const int m0 = blockIdx.y * TC_BM;
    const int n0 = blockIdx.x * TC_BN;
    A += w * sAw;
    B += w * sBw;
    C += w * sCw;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

    auto load_tile = [&](int kt, int stage) {
        const int k0 = kt * TC_BK;
        float* as = As + stage * A_STAGE;
        float* bs = Bs + stage * B_STAGE;
        if constexpr (VEC) {                     // Z % 4 == N % 4 == 0
#pragma unroll
            for (int i = 0; i < TC_BM * TC_BK / 4 / TC_THREADS; ++i) {
                const int c = tid + i * TC_THREADS;
                const int r = c / (TC_BK / 4), z = (c % (TC_BK / 4)) * 4;
                const bool ok = m0 + r < M && k0 + z < Z;
                cp_async16(smem_addr(as + r * LDA + z),
                           ok ? A + (int64_t)(m0 + r) * Z + k0 + z : A,
                           ok ? 16 : 0);
            }
#pragma unroll
            for (int i = 0; i < TC_BK * TC_BN / 4 / TC_THREADS; ++i) {
                const int c = tid + i * TC_THREADS;
                const int r = c / (TC_BN / 4), n = (c % (TC_BN / 4)) * 4;
                const bool ok = k0 + r < Z && n0 + n < N;
                cp_async16(smem_addr(bs + r * LDB + n),
                           ok ? B + (int64_t)(k0 + r) * N + n0 + n : B,
                           ok ? 16 : 0);
            }
        } else {
#pragma unroll 4
            for (int i = 0; i < TC_BM * TC_BK / TC_THREADS; ++i) {
                const int e = tid + i * TC_THREADS;
                const int r = e / TC_BK, z = e % TC_BK;
                const bool ok = m0 + r < M && k0 + z < Z;
                cp_async4(smem_addr(as + r * LDA + z),
                          ok ? A + (int64_t)(m0 + r) * Z + k0 + z : A,
                          ok ? 4 : 0);
            }
#pragma unroll 4
            for (int i = 0; i < TC_BK * TC_BN / TC_THREADS; ++i) {
                const int e = tid + i * TC_THREADS;
                const int r = e / TC_BN, n = e % TC_BN;
                const bool ok = k0 + r < Z && n0 + n < N;
                cp_async4(smem_addr(bs + r * LDB + n),
                          ok ? B + (int64_t)(k0 + r) * N + n0 + n : B,
                          ok ? 4 : 0);
            }
        }
    };

    // acc: the running sum, added to by FADD only; part: one k-tile's
    // three passes on the tensor cores, from zero
    float acc[4][4][4], part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int KT = (Z + TC_BK - 1) / TC_BK;
#pragma unroll
    for (int s = 0; s < TC_STAGES - 1; ++s) {
        if (s < KT) load_tile(s, s);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<TC_STAGES - 2>();          // tile kt has landed
        __syncthreads();                         // and tile kt-1 is consumed
        if (kt + TC_STAGES - 1 < KT)
            load_tile(kt + TC_STAGES - 1, (kt + TC_STAGES - 1) % TC_STAGES);
        cp_async_commit();
        const float* as = As + (kt % TC_STAGES) * A_STAGE + wm * LDA;
        const float* bs = Bs + (kt % TC_STAGES) * B_STAGE + wn;
#pragma unroll
        for (int kk = 0; kk < TC_BK; kk += 8) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const float* br = bs + (kk + t) * LDB + nt * 8 + g;
                split_tf32(br[0], bh[nt][0], bl[nt][0]);
                split_tf32(br[4 * LDB], bh[nt][1], bl[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const float* ar = as + (mt * 16 + g) * LDA + kk + t;
                uint32_t ah[4], al[4];
                split_tf32(ar[0], ah[0], al[0]);
                split_tf32(ar[8 * LDA], ah[1], al[1]);
                split_tf32(ar[4], ah[2], al[2]);
                split_tf32(ar[8 * LDA + 4], ah[3], al[3]);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {     // small terms first
                    if (kk == 0)
                        mma_tf32_zero(part[mt][nt], al, bh[nt]);
                    else
                        mma_tf32(part[mt][nt], al, bh[nt]);
                    mma_tf32(part[mt][nt], ah, bl[nt]);
                    mma_tf32(part[mt][nt], ah, bh[nt]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int gm = m0 + wm + mt * 16 + g + 8 * r;
            if (gm >= M) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int gn = n0 + wn + nt * 8 + 2 * t + e;
                    if (gn >= N) continue;
                    float* p = C + (int64_t)gm * N + gn;
                    float v = sign * acc[mt][nt][2 * r + e];
                    if (accumulate) v += *p;
                    *p = v;
                }
            }
        }
    }
}

template <bool VEC>
int launch_tf32x3(const float* A, const float* B, float* C, int W, int M,
                  int N, int Z, long long sAw, long long sBw, long long sCw,
                  float sign, int accumulate, cudaStream_t stream) {
    static bool smem_set = false;                // once per instance
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            coded_matmul_tf32x3_kernel<VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, W);
    coded_matmul_tf32x3_kernel<VEC><<<grid, TC_THREADS, TC_SMEM, stream>>>(
        A, B, C, M, N, Z, sAw, sBw, sCw, sign, accumulate);
    return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// A (W, M, Z), B (W, Z, N), C (W, M, N), rows contiguous, any worker
// stride (in elements); C = (accumulate ? C : 0) + sign * A @ B.
extern "C" int coded_matmul_f32(const void* A, const void* B, void* C, int W,
                                int M, int N, int Z, long long sAw,
                                long long sBw, long long sCw, int sign,
                                int accumulate, void* stream) {
    // 16-byte copies need every row of A and B to start 16-byte aligned
    const bool vec = Z % 4 == 0 && N % 4 == 0 && sAw % 4 == 0 &&
                     sBw % 4 == 0 && aligned16(A) && aligned16(B);
    const float s = sign < 0 ? -1.f : 1.f;
    auto a = static_cast<const float*>(A);
    auto b = static_cast<const float*>(B);
    auto c = static_cast<float*>(C);
    return vec ? launch_tf32x3<true>(a, b, c, W, M, N, Z, sAw, sBw, sCw, s,
                                     accumulate, (cudaStream_t)stream)
               : launch_tf32x3<false>(a, b, c, W, M, N, Z, sAw, sBw, sCw, s,
                                      accumulate, (cudaStream_t)stream);
}

extern "C" int coded_matmul_bf16(const void* A, const void* B, void* C, int W,
                                 int M, int N, int Z, long long sAw,
                                 long long sBw, long long sCw, int sign,
                                 int accumulate, void* stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, W);
    coded_matmul_simt_kernel<__nv_bfloat16>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            static_cast<const __nv_bfloat16*>(A),
            static_cast<const __nv_bfloat16*>(B),
            static_cast<__nv_bfloat16*>(C), M, N, Z, sAw, sBw, sCw,
            sign < 0 ? -1.f : 1.f, accumulate);
    return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
