// Batched worker GEMM of the coded matmul: C[w] (=, +=, -=) A[w] @ B[w].
//
// Replaces the TPU kernel coded_matmul_pallas (body _matmul_kernel) in
// src/repro/kernels/coded_matmul/kernel.py: every worker's task in every
// code of the paper is one encoded GEMM P[w] = E_A[w] @ E_B[w], and the
// serving backend folds the request batch and the workers into one W axis.
//
// Bound on an H100: at the serving shape (W=96, 2048x4096 @ 4096x2048) the
// work is 3.3 TFLOP against 8 GB of operands and products (4 GB in bf16),
// so it is bound by operations: bf16 at the dense bf16 rate (989 TFLOP/s),
// 3.3 ms.  The float32 kernel runs three TF32 tensor-core products per
// output ("3xTF32"), so its bound counts 3 x 2*M*N*Z operations at the
// dense TF32 rate (495 TFLOP/s): 20.0 ms at the serving shape.
//
// Three kernels, chosen by dtype and, for bf16, by the operands' alignment
// (explicit dispatches: the float32 C entry picks VEC, the Python wrapper
// picks the bf16 entry):
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
// bf16 -> coded_matmul_wgmma_kernel, on Hopper's warpgroup products, for
// operands TMA can address: Z and N multiples of 8, worker strides
// multiples of 8 elements (or W == 1), A and B 16-byte aligned -- every
// global stride and base on 16 bytes (entry coded_matmul_bf16; it returns
// UNSUPPORTED for anything else).  This is the bf16 serving paths'
// kernel (the device backend, the cluster's workers, the mesh job).  A
// block owns a 128 x 256 tile of C and runs three warpgroups:
// - a producer warpgroup, one thread of which issues the TMA loads
//   (cp.async.bulk.tensor.3d) of each 64-deep k-tile into a 4-stage ring:
//   A as one 128 x 64 box, B as up to four 64 x 64 boxes (panels of 64
//   columns; a panel wholly past N is never loaded, its columns reach
//   only outputs that are not stored).  The tensor maps are 3-D (the
//   contiguous dim, the rows, the worker), built on the host by
//   cuTensorMapEncodeTiled, so a box at the Z edge reads zeros and never
//   the next worker's rows: TMA's out-of-bounds zero fill replaces the
//   masked loads.  Each box lands 128-byte swizzled.  Each stage has a
//   full mbarrier (the producer's expect_tx, completed by the copies'
//   bytes) and an empty one (one arrival from each consumer warp);
// - two consumer warpgroups, rows 0-63 and 64-127 of the tile, each
//   issuing wgmma.mma_async m64n256k16.f32.bf16.bf16 with both operands
//   read from shared memory through 128-byte-swizzle descriptors: A
//   K-major (a k16 step moves the start address by 32 bytes inside the
//   swizzle atom), B as it lies in memory, row-major Z x N, which is
//   MN-major for wgmma: the instruction's transpose-B immediate reads it,
//   with LBO = 8 KB (the next 64-column panel) and SBO = 1 KB (the next
//   8 rows of the contraction); no transposing pass.  One k-tile's group
//   stays in flight while the next is issued; a stage is released once
//   the group that read it has completed.  The accumulator, 64 x 256
//   float32 a warpgroup, is 128 registers a thread; setmaxnreg gives the
//   consumers 232 registers and leaves the producer 40.
// The epilogue multiplies by sign, adds C (read as bf16, in float32) when
// accumulating, rounds once to bf16 and stores pairs of columns, guarded
// at the M and N edges (element by element where C's rows are not 4-byte
// aligned).  One block an SM (193 KB of shared memory).
//
// bf16 operands TMA cannot address (entry coded_matmul_bf16_simt) ->
// coded_matmul_simt_kernel, the first design, on the CUDA cores; no main
// path passes such operands.  A block owns a 128x128 tile of C and walks
// the contraction in steps of 8.  A and B tiles are staged in shared
// memory as float32 (A transposed, padded so the transposing store has no
// bank conflicts); each of the 256 threads keeps an 8x8 register
// micro-tile and reads its operands as float4 from shared memory.  The
// next contraction step is loaded into registers while the current one is
// multiplied.  It masks the M, N and Z edges by loading zeros.
//
// No kernel needs a padded copy of the operands (the Pallas kernel pads
// Z).  accumulate != 0 turns the store into C = C + sign*A@B, which lets
// the complex worker products run as four launches into two outputs with
// no temporaries.  Each C entry returns cudaGetLastError() of its launch,
// or UNSUPPORTED before launching.

#include <cuda.h>           // CUtensorMap and its enums only: the encoder
#include <cuda_bf16.h>      // is found at run time (no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNSUPPORTED = -1;     // no instance takes the arguments

// ------------------------------------------------ bf16, unaligned: CUDA cores

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

// ------------------------------------------------ bf16: wgmma fed by TMA

constexpr int WG_BM = 128, WG_BN = 256, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_CONSUMERS = 256;               // two warpgroups of 64 rows
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // and the producer's
constexpr int WG_PANEL_N = 64;                  // B columns a TMA box (128 B)
constexpr int WG_A = WG_BM * WG_BK * 2;         // bytes: 16 KB
constexpr int WG_PANEL = WG_BK * WG_PANEL_N * 2;  // 8 KB
constexpr int WG_PANELS = WG_BN / WG_PANEL_N;
constexpr int WG_STAGE = WG_A + WG_PANELS * WG_PANEL;   // 48 KB
constexpr int WG_ALIGN = 1024;                  // a 128-byte swizzle atom
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8 + WG_ALIGN;
constexpr unsigned FULL_MASK = 0xffffffffu;

// wgmma's shared-memory operand descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128B swizzle) in bits 62-63.  The tiles start on 1 KB, so the
// base offset field stays 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
           (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
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
// keeps the compiler from moving registers an in-flight wgmma writes
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (64 x 256, float32) += A (64 x 16, K-major) B (16 x 256, MN-major),
// both from shared memory: imm-trans-a 0, imm-trans-b 1
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        : "l"(a), "l"(b), "r"(1));
}

// mbarriers of the ring: full (the producer's expect_tx, completed by the
// TMA copies' bytes), empty (one arrival from each consumer warp)
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
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}
// box (c0, c1, c2) of a 3-D tensor map into shared memory at dst; the
// copy's bytes complete on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1), "r"(c2)
        : "memory");
}

__global__ void __launch_bounds__(WG_THREADS, 1)
coded_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          __nv_bfloat16* __restrict__ C, int M, int N, int Z,
                          int64_t sCw, float sign, int accumulate,
                          int pairs) {
    extern __shared__ unsigned char wg_smem[];
    // the ring starts on the next 1 KB boundary, the barriers after it
    const uint32_t raw = smem_addr(wg_smem);
    const uint32_t ring = (raw + WG_ALIGN - 1) & ~(uint32_t)(WG_ALIGN - 1);
    uint64_t* full = reinterpret_cast<uint64_t*>(
        wg_smem + (ring - raw) + WG_STAGES * WG_STAGE);
    uint64_t* empty = full + WG_STAGES;

    const int w = blockIdx.z;
    const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
    const int tid = threadIdx.x;
    const int KT = (Z + WG_BK - 1) / WG_BK;

    if (tid == 0) {
        for (int st = 0; st < WG_STAGES; ++st) {
            mbar_init(&full[st], 1);                    // the producer
            mbar_init(&empty[st], WG_CONSUMERS / 32);   // consumer warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the role, uniform over each warpgroup as the compiler can see (the
    // register counts of setmaxnreg hold per warpgroup)
    if (__shfl_sync(FULL_MASK, tid / 128, 0) == WG_CONSUMERS / 128) {
        regs_dec<40>();
        if (tid == WG_CONSUMERS) {
            // the B panels holding a column below N
            const int panels = min(WG_PANELS, (N - n0 + WG_PANEL_N - 1) /
                                                  WG_PANEL_N);
            const int bytes = WG_A + panels * WG_PANEL;
            asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                             reinterpret_cast<uint64_t>(&map_a))
                         : "memory");
            asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                             reinterpret_cast<uint64_t>(&map_b))
                         : "memory");
            for (int kt = 0; kt < KT; ++kt) {
                const int st = kt % WG_STAGES, n = kt / WG_STAGES;
                if (n > 0) mbar_wait(&empty[st], (n - 1) & 1);
                const uint32_t a = ring + st * WG_STAGE;
                mbar_expect_tx(&full[st], bytes);
                tma_load_3d(a, &map_a, &full[st], kt * WG_BK, m0, w);
                for (int p = 0; p < panels; ++p)
                    tma_load_3d(a + WG_A + p * WG_PANEL, &map_b, &full[st],
                                n0 + p * WG_PANEL_N, kt * WG_BK, w);
            }
        }
        return;
    }

    // the consumers: rows 64 wg .. 64 wg + 63 of the tile
    regs_inc<232>();
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % WG_STAGES;
        mbar_wait(&full[st], (kt / WG_STAGES) & 1);
        const uint32_t a = ring + st * WG_STAGE + wg * (WG_A / 2);
        const uint32_t b = ring + st * WG_STAGE + WG_A;
        hold(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
            wgmma_256(acc, sw128_desc(a + kk * 32, 16, 8 * 128),
                      sw128_desc(b + kk * 16 * 128, WG_PANEL, 8 * 128));
        wg_commit();
        wg_wait<1>();            // tile kt - 1's group is done: free its stage
        hold(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
    }
    wg_wait<0>();
    hold(acc);

    // accumulator element 4 j + 2 h + e: row 16 warp + lane / 4 + 8 h,
    // column 8 j + 2 (lane % 4) + e
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const int col = n0 + 2 * (lane & 3);
    __nv_bfloat16* Cw = C + (int64_t)w * sCw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int gm = row + 8 * h;
        if (gm >= M) continue;
        __nv_bfloat16* Cr = Cw + (int64_t)gm * N;
#pragma unroll
        for (int j = 0; j < WG_BN / 8; ++j) {
            const int gn = col + 8 * j;
            if (gn >= N) continue;               // N % 8 == 0: gn + 1 < N
            float v0 = sign * acc[4 * j + 2 * h];
            float v1 = sign * acc[4 * j + 2 * h + 1];
            if (pairs) {
                auto* pc = reinterpret_cast<__nv_bfloat162*>(Cr + gn);
                if (accumulate) {
                    const float2 c = __bfloat1622float2(*pc);
                    v0 = c.x + v0;
                    v1 = c.y + v1;
                }
                *pc = __floats2bfloat162_rn(v0, v1);
            } else {
                if (accumulate) {
                    v0 = __bfloat162float(Cr[gn]) + v0;
                    v1 = __bfloat162float(Cr[gn + 1]) + v1;
                }
                Cr[gn] = __float2bfloat16(v0);
                Cr[gn + 1] = __float2bfloat16(v1);
            }
        }
    }
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

// a bf16 (W, rows, cols) tensor with contiguous rows and worker stride sw
// (elements) as a 3-D map of box_cols x box_rows x 1, 128-byte swizzle,
// zeros out of bounds
bool encode_3d(EncodeTiled enc, CUtensorMap* map, const void* base, int W,
               int rows, int cols, long long sw, int box_cols,
               int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                                (cuuint64_t)W};
    const long long worker = W > 1 ? sw : (long long)rows * cols;
    const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                   (cuuint64_t)worker * 2};
    const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows,
                               1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const __nv_bfloat16* A, const __nv_bfloat16* B,
                 __nv_bfloat16* C, int W, int M, int N, int Z, long long sAw,
                 long long sBw, long long sCw, float sign, int accumulate,
                 cudaStream_t stream) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            coded_matmul_wgmma_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    CUtensorMap map_a, map_b;
    if (!encode_3d(enc, &map_a, A, W, M, Z, sAw, WG_BK, WG_BM) ||
        !encode_3d(enc, &map_b, B, W, Z, N, sBw, WG_PANEL_N, WG_BK))
        return (int)cudaErrorInvalidValue;
    // bf16 pairs need 4-byte aligned rows of C (N is even)
    const int pairs = sCw % 2 == 0 &&
                      (reinterpret_cast<uintptr_t>(C) & 3u) == 0;
    dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM, W);
    coded_matmul_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
        map_a, map_b, C, M, N, Z, sCw, sign, accumulate, pairs);
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

// The TMA instance: every global stride and base 16-byte aligned (Z and N
// multiples of 8, worker strides multiples of 8 elements unless W == 1, A
// and B on 16 bytes); UNSUPPORTED otherwise.  The Python wrapper checks
// the same rule (tma_aligned in kernels/coded_matmul/ops.py) and sends
// operands that fail it to coded_matmul_bf16_simt.
extern "C" int coded_matmul_bf16(const void* A, const void* B, void* C, int W,
                                 int M, int N, int Z, long long sAw,
                                 long long sBw, long long sCw, int sign,
                                 int accumulate, void* stream) {
    const bool strides = W == 1 || (sAw > 0 && sAw % 8 == 0 && sBw > 0 &&
                                    sBw % 8 == 0);
    if (Z <= 0 || Z % 8 != 0 || N % 8 != 0 || !strides || !aligned16(A) ||
        !aligned16(B))
        return UNSUPPORTED;
    return launch_wgmma(static_cast<const __nv_bfloat16*>(A),
                        static_cast<const __nv_bfloat16*>(B),
                        static_cast<__nv_bfloat16*>(C), W, M, N, Z, sAw, sBw,
                        sCw, sign < 0 ? -1.f : 1.f, accumulate,
                        (cudaStream_t)stream);
}

// The CUDA-core instance, for bf16 operands of any alignment.
extern "C" int coded_matmul_bf16_simt(const void* A, const void* B, void* C,
                                      int W, int M, int N, int Z,
                                      long long sAw, long long sBw,
                                      long long sCw, int sign,
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
