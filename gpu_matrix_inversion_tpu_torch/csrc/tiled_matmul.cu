// K7: the tiled verification GEMM, C = A @ B with an fp32 accumulator.
//
// Replaces gpu_matrix_inversion_tpu/ops/matmul.py:_matmul_kernel, launched by
// _matmul through pallas_matmul: the reference's C8 verification product
// (matrix_multiply.cpp:17-36, one work-item per output element there), which
// the JAX package keeps as a tiled Pallas kernel for parity and to
// cross-check the library GEMM in tests. No inversion path calls it.
//
// Numerics follow the TPU kernel's. fp32 operands: true FP32, one fmaf per
// product in k order from a zero accumulator (no TF32, which the TPU
// kernel's HIGHEST precision rules out). bf16 operands: the products of
// bf16 values are exact in fp32, summed in fp32 on the tensor cores and
// rounded once to bf16 (__float2bfloat16_rn), as one bf16 MXU pass into an
// fp32 accumulator does. The output has A's type.
//
// Operands are row-major with row strides lda and ldb (elements) that are
// multiples of 16 bytes, on 16-byte aligned bases: the wrapper
// (ops/matmul.py) copies an operand that misses this into a buffer with a
// padded row stride and a zero tail. Loads past the logical m, n, k read
// zeros and stores outside C are skipped, so any m, n >= 1 and k >= 0 works
// (k = 0 writes zeros). The fp32 branch reads A's rows in whole float4, so
// whatever follows a row in its last 16 bytes must be zeros: the wrapper
// also copies a row followed there by another tensor's elements.
//
// bf16, bound by the tensor cores (2mnk operations; 989 TFLOP/s dense on an
// H100 SXM): a warp-specialised wgmma kernel. Each block computes a
// (128, 256) tile of C. One producer warpgroup keeps TMA loads in flight
// through a ring of 4 shared-memory stages of A (128, 64) and B (64, 256),
// 128-byte swizzled, with a "full" and an "empty" mbarrier per stage; two
// consumer warpgroups, 64 rows each, issue wgmma.mma_async m64n256k16 on the
// stages that have arrived, with one group of products in flight, and hold
// their (64, 256) fp32 accumulators in registers (setmaxnreg moves registers
// from the producer to them). B is row-major (k, n), MN-major for wgmma: it
// goes through the descriptor's transpose flag, a k step advancing by rows.
//
// fp32, bound by the FMA rate outside the tensor cores (2mnk operations;
// 67 TFLOP/s): a pipelined SIMT tile loop. Each 256-thread block computes a
// (128, 128) tile of C through (128, 16) and (16, 128) tiles of A and B in
// two shared-memory buffers: while the FMAs run on one buffer, cp.async
// copies the next B tile into the other and float4 loads bring the next A
// tile into registers, stored transposed after the FMAs; one barrier per k
// tile. Each thread accumulates an 8 x 8 sub-tile, its rows and columns two
// 4-wide groups 64 apart, so that it reads its operands as float4 without
// bank conflicts.
#include <cuda.h>  // CUtensorMap and its encoder's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- bf16: TMA + wgmma ---------------------------------------------------

constexpr int kHBM = 128;
constexpr int kHBN = 256;
constexpr int kHBK = 64;  // 128 bytes of bf16: one swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups, 64 rows of the tile each
constexpr int kHThreads = (kConsumers + 1) * 128;
constexpr int kATile = kHBM * kHBK;  // elements of one stage
constexpr int kBTile = kHBK * kHBN;
constexpr int kBChunk = kHBK * 64;   // one TMA box of B: 64 rows x 64 cols
constexpr uint32_t kStageBytes = (kATile + kBTile) * 2;
constexpr size_t kHSmem =
    kStages * (size_t)kStageBytes + 2 * kStages * sizeof(uint64_t) + 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// wait never lasts longer than one tile's load or products; past ~2^26
// tries (seconds) the pipeline is deadlocked, and the kernel traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// D (64, 256) += A (64, 16) B (16, 256); A K-major, B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"  // scale-d: accumulate into D
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
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kHThreads, 1)
matmul_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b,
                   __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kStages * kATile;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBTile);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kHBM;
  const int n0 = blockIdx.x * kHBN;
  const int nk = (k + kHBK - 1) / kHBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread issues the TMA loads of every k tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(sa + s * kATile, &tma_a, &full[s], kt * kHBK, m0);
#pragma unroll
        for (int q = 0; q < kHBN / 64; ++q)
          tma_load(sb + s * kBTile + q * kBChunk, &tma_b, &full[s],
                   n0 + 64 * q, kt * kHBK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      const __nv_bfloat16* a_st = sa + s * kATile + wg * 64 * kHBK;
      const __nv_bfloat16* b_st = sb + s * kBTile;
#pragma unroll
      for (int kk = 0; kk < kHBK / 16; ++kk) {
        // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; a k
        // step of 16 moves 32 bytes along the row. B: MN-major, 64-column
        // chunks 64 rows x 128 bytes apart, 8-row groups 1024 bytes apart;
        // a k step of 16 moves 16 rows down.
        wgmma_m64n256k16(d, smem_desc(a_st + kk * 16, 16, 1024),
                         smem_desc(b_st + kk * 16 * 64, kBChunk * 2, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<1>();
      // The previous tile's products are done: hand its stage back.
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");

    // Accumulator layout of m64nN: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (+ 8); register 4 j + 2 h + e is column
    // 8 j + 2 (lane % 4) + e of row + 8 h.
    const int warp = (threadIdx.x % 128) / 32;
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
    const bool pairs = (n % 2) == 0;
#pragma unroll
    for (int j = 0; j < kHBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= m) continue;
        __nv_bfloat16* out = c + (size_t)r * n + col;
        const float x0 = d[4 * j + 2 * h];
        const float x1 = d[4 * j + 2 * h + 1];
        if (pairs && col + 1 < n) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __halves2bfloat162(__float2bfloat16_rn(x0),
                                 __float2bfloat16_rn(x1));
        } else {
          if (col < n) out[0] = __float2bfloat16_rn(x0);
          if (col + 1 < n) out[1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map of `rows` x `cols` (row stride ld elements), read in
// boxes of box_rows x box_cols, 128-byte swizzled; reads past the extent
// are zero.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows,
            int cols, int ld, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                int lda, int ldb, cudaStream_t stream) {
  CUtensorMap ta = {}, tb = {};
  if (k > 0) {  // at k = 0 the kernel reads nothing and writes zeros
    EncodeTiled fn = encoder();
    if (fn == nullptr) return cudaErrorNotSupported;
    if (!encode(fn, &ta, a, m, k, lda, kHBM, kHBK) ||
        !encode(fn, &tb, b, k, n, ldb, kHBK, 64))
      return cudaErrorInvalidValue;
  }
  // Per launch (about a microsecond): the attribute is the current
  // device's.
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kHSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kHBN - 1) / kHBN, (m + kHBM - 1) / kHBM);
  matmul_bf16_kernel<<<grid, kHThreads, kHSmem, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), m, n, k);
  return cudaGetLastError();
}

// ---- fp32: pipelined SIMT tiles ------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;  // keeps the transposed A stores within two-way

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k, int lda,
                  int ldb) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPad];  // A, transposed
  __shared__ __align__(16) float bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A warp covers 4 x 8 threads; each quarter warp shares its A operands
  // and reads 8 consecutive float4 of B.
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int nt = (k + kBK - 1) / kBK;

  // A tile: 512 float4, thread tid takes e = tid + 256 q: row e / 4, k
  // quad e % 4. B tile: 512 float4, e: k row e / 32, column quad e % 32.
  float4 areg[2];
  auto load_a = [&](int t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + kThreads * q;
      const int r = row0 + (e >> 2);
      const int s = t * kBK + (e & 3) * 4;
      areg[q] = (r < m && s < k)
                    ? *reinterpret_cast<const float4*>(a + (size_t)r * lda + s)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + kThreads * q;
      const int i = e >> 2;
      const int kq = (e & 3) * 4;
      as[buf][kq][i] = areg[q].x;
      as[buf][kq + 1][i] = areg[q].y;
      as[buf][kq + 2][i] = areg[q].z;
      as[buf][kq + 3][i] = areg[q].w;
    }
  };
  auto load_b = [&](int t, int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + kThreads * q;
      const int kk = e >> 5;
      const int jq = (e & 31) * 4;
      const int s = t * kBK + kk;
      const int col = col0 + jq;
      const bool in = s < k && col < n;
      cp_async16(&bs[buf][kk][jq], in ? b + (size_t)s * ldb + col : b,
                 in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nt > 0) {
    load_b(0, 0);
    load_a(0);
    store_a(0);
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nt;
    if (more) {
      load_b(t + 1, cur ^ 1);
      load_a(t + 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 x =
            *reinterpret_cast<const float4*>(&as[cur][kk][h * 64 + ty * 4]);
        const float4 y =
            *reinterpret_cast<const float4*>(&bs[cur][kk][h * 64 + tx * 4]);
        av[4 * h] = x.x; av[4 * h + 1] = x.y; av[4 * h + 2] = x.z;
        av[4 * h + 3] = x.w;
        bv[4 * h] = y.x; bv[4 * h + 1] = y.y; bv[4 * h + 2] = y.z;
        bv[4 * h + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
    __syncthreads();
  }

  // Row i < 8 of the sub-tile is tile row (i / 4) * 64 + ty * 4 + i % 4;
  // column j likewise with tx.
  const bool quads = (n % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + h * 64 + tx * 4;
      float* out = c + (size_t)r * n + col;
      if (quads && col + 3 < n) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < n) out[e] = acc[i][4 * h + e];
      }
    }
  }
}

}  // namespace

// K7. a: (m, k) with row stride lda, b: (k, n) with row stride ldb, c: (m, n)
// contiguous out, all row-major and of one type: float32, or bfloat16 when
// bf16 != 0. Unless k = 0, lda >= k and ldb >= n are multiples of 16 bytes
// and a and b are 16-byte aligned. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an empty output, more row tiles than a grid
// holds, or operands that break those rules).
extern "C" int matinv_tiled_matmul(const void* a, const void* b, void* c,
                                   int m, int n, int k, int lda, int ldb,
                                   int bf16, void* stream) {
  const int per = bf16 ? 8 : 4;  // elements in 16 bytes
  if (m < 1 || n < 1 || k < 0 || (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if (k > 0 && (lda < k || ldb < n || lda % per || ldb % per ||
                reinterpret_cast<uintptr_t>(a) % 16 ||
                reinterpret_cast<uintptr_t>(b) % 16))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_bf16(a, b, c, m, n, k, lda, ldb, s);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_f32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k, lda, ldb);
  return cudaGetLastError();
}
