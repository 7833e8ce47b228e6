// L1 and L4: the step loop on whole (B, n, n) fp64 or fp32 matrices, with
// or without pivoting, in two modes: L1 the Gauss-Jordan inverse, L4 the
// spec getrf (to n = 511; lu_factor.cu past it). The two share the
// geometry, the kernels' bodies and the launch; they differ in run_steps'
// LU flag (gj_loop.cuh) and in what the store writes.
//
// L1, the Gauss-Jordan inverse.
//
// Replaces the device-side loop of gpu_matrix_inversion_tpu/ops/
// gauss_jordan.py:_gauss_jordan_aug (its lax.fori_loop of _gj_step), which
// reaches no Pallas kernel: XLA runs it as one on-device while loop. The
// port's plain twin (ops/gauss_jordan.py gauss_jordan_twin) issues each
// step as ~15 tensor operations from the host. L1 serves the FP64 tier's
// pivot-block inverse (b = 256) and the spec route (auto's FP64 n < 512,
// method="spec", method="fused" past K1's reach).
//
// Same operations as the twin, in its order, so the inverse equals it bit
// for bit up to the sign of a zero: per step r the first maximum of
// |column r| over places >= r (NaN counted as the maximum, as torch.argmax
// does; the diagonal without pivoting), the swap (a position map here:
// gj_loop.cuh), the pivot row divided by the pivot (IEEE division; a zero
// pivot divides by 1 and clears ok), every other row x - f * v with two
// roundings (__dmul_rn, __dsub_rn; __fmul_rn, __fsub_rn in fp32), the
// normalized row deposited. ok = every pivot nonzero and the inverse
// finite. On a non-finite input only ok is held to the twin: the twin's
// unit columns turn NaN under a NaN factor, the in-place layout has none.
//
// What bounds it on an H100: 2 n^3 operations at the FP64 peak take about
// 1 us at n = 256; the n steps are a serial chain, each a reduction across
// the matrix's rows and a broadcast of the pivot row, so the time is the
// chain's latency, not the card's rates. Two branches, chosen by the
// wrapper (ops/gauss_jordan.py loop_geometry):
//   cluster (n <= 511): one thread-block cluster of C CTAs per matrix, the
//     in-place matrix cut by rows over the CTAs' shared memory (2.09 MB at
//     fp64 n = 511 on C = 16 CTAs of ~150 KB), proposals read through the
//     cluster's shared-memory window, one cluster barrier a step. Nothing
//     of the matrix leaves the chip between load and store.
//   grid (n > 511): one matrix at a time on a persistent grid of g CTAs
//     (at most one per SM, a cooperative launch), each CTA's rows in its
//     shared memory where they fit (fp64 to n ~ 1900) and in a device
//     workspace past that, proposals in device memory, one grid barrier a
//     step.
// Measured on an H100 80GB HBM3 at 700 W (probes/loop_phases.py): a step
// at (1, 256^2) fp64 on 8 CTAs takes ~7,800 cycles (~4 us): the update
// ~3,000, bound by shared-memory traffic (24 64-bit accesses a row and
// warp); the header and pivot-row reads across the cluster ~2,700; the
// cluster barrier ~1,000. Rows in registers would remove the first.
//
// L4, the spec getrf: partial-pivoted LU with row swaps.
//
// Replaces the device-side loop of gpu_matrix_inversion_tpu/ops/lu.py:
// _lu_factor_2d (its lax.fori_loop), which reaches no Pallas kernel. The
// port's plain twin (ops/lu.py lu_factor_twin) issues each of its n steps
// as ~12 tensor operations from the host. L4 serves lu_factor, lu_inverse,
// lu_solve_matrix and slogdet below n = 256, the LU route of inverse and
// solve below 256, and lu_inverse_refined at any n.
//
// Same operations as the twin, in its order, so (lu, perm, ok) equal it
// bit for bit: per step r the pivot as L1's, the swap (the position maps:
// rows never move, perm is the row at each place), the multipliers
// f = x_r / pivot (IEEE division; a zero pivot divides by 1 and clears ok)
// of the rows at places > r, x - f * v with two roundings on the columns
// > r of every row (f = 0 above the pivot, so an infinity in the pivot row
// spreads NaN there as in the twin, and a -0 there turns +0 as the twin's
// does), f deposited in column r. ok = every pivot nonzero and the factor
// finite.
//
// What bounds it on an H100 at these orders: the chain's latency.
// Measured on an H100 80GB HBM3 at 700 W (CUDA events; probes/
// loop_phases.py for a step): ~0.63 ms at (64, 128^2) fp32 (~5 us a step;
// torch.linalg.lu_factor 1.6 to 2.5 ms over four runs), ~0.77 ms at
// (1, 200^2) fp64. L4 runs here on the cluster branch only: past n = 511
// it is the blocked getrf of lu_factor.cu (lu_factor_grid_kernel_blocked,
// a name the profiler's readers match as the grid branch's).
#include <cuda_runtime.h>

#include "gj_loop.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace matinv::loop;

// A member owns rows [lo, hi) of one (n, n) matrix; its shared memory holds
// them (the cluster branch, and the grid branch where they fit), the
// pivot row, its proposals (cluster), the three position maps (3 n ints),
// the reduction scratch and a flag.

// Shared memory carved for a member of an L1 or L4 job; see smem_bytes.
template <typename T>
struct Carve {
  T* rows;
  T* nr;
  char* props;
  int* maps;
  Cand* red;
  int* flag;
};

template <typename T>
__device__ Carve<T> carve(char* smem, int rows_per, int n, bool rows_shared,
                          bool props_shared) {
  Carve<T> c;
  size_t off = 0;
  c.rows = reinterpret_cast<T*>(smem);
  if (rows_shared) off += align16((size_t)rows_per * n * sizeof(T));
  c.nr = reinterpret_cast<T*>(smem + off);
  off += align16((size_t)n * sizeof(T));
  c.props = smem + off;
  if (props_shared) off += 2 * prop_bytes(n, sizeof(T));
  c.maps = reinterpret_cast<int*>(smem + off);
  off += align16((size_t)3 * n * sizeof(int));
  c.red = reinterpret_cast<Cand*>(smem + off);
  off += kWarps * sizeof(Cand);
  c.flag = reinterpret_cast<int*>(smem + off);
  return c;
}

// Loads the member's rows of matrix `a` into v and resets the maps.
template <typename T>
__device__ void load_rows(const T* a, T* v, int* maps, int lo, int hi,
                          int n) {
  for (size_t idx = threadIdx.x; idx < (size_t)(hi - lo) * n;
       idx += kThreads)
    v[idx] = a[(size_t)lo * n + idx];
  for (int g = threadIdx.x; g < n; g += kThreads) {
    maps[g] = g;       // pos_of
    maps[n + g] = g;   // phys_at
  }
  __syncthreads();
}

template <typename T>
__device__ Job<T> matrix_job(const Carve<T>& c, T* v, int lo, int hi,
                             int rows_per, int n, int pivot) {
  Job<T> jb;
  jb.v = v;
  jb.lo = lo;
  jb.hi = hi;
  jb.rows_per = rows_per;
  jb.w = n;
  jb.steps = n;
  jb.pivot = pivot;
  jb.nr = c.nr;
  jb.red = c.red;
  jb.pos_of = c.maps;
  jb.phys_at = c.maps + n;
  jb.order = c.maps + 2 * n;
  jb.state = nullptr;
  jb.kb = 0;
  return jb;
}

// The cluster branch: one cluster of `cluster` CTAs a matrix, to n = 511.
constexpr int kMaxCluster = 16;
constexpr int kOnChipMaxN = 511;

// The launch configuration of a cluster-branch kernel for `batch` (n, n)
// matrices; cudaErrorInvalidValue on a geometry it cannot serve.
inline cudaError_t cluster_config(const void* kernel, int batch, int n,
                                  int cluster, int smem, int tsize,
                                  cudaStream_t stream,
                                  cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
  const int rows_per = cluster > 0 ? (n + cluster - 1) / cluster : 0;
  if (batch < 1 || n < 1 || n > kOnChipMaxN || cluster < 1 ||
      cluster > kMaxCluster || smem < 0 || (size_t)smem > kMaxShared ||
      (size_t)smem < smem_bytes(rows_per, n, 3 * n, tsize, true, true))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * batch, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The store of a finished member, in every thread; returns whether every
// stored value is finite. L1 (getInvertedMatrix, FP32.cpp:216-226): slot s
// of row g is the inverse's element (place of g, order[s]). L4: row g goes
// to its place, and perm[place] = g.
template <typename T, bool LU>
__device__ int store(const Job<T>& jb, T* out, long long* perm, int n) {
  int finite = 1;
  for (size_t idx = threadIdx.x; idx < (size_t)(jb.hi - jb.lo) * n;
       idx += kThreads) {
    const int i = (int)(idx / n);
    const int s = (int)(idx - (size_t)i * n);
    const T x = jb.v[idx];
    finite &= isfinite(x) ? 1 : 0;
    out[(size_t)jb.pos_of[jb.lo + i] * n + (LU ? s : jb.order[s])] = x;
  }
  if (LU)
    for (int g = jb.lo + threadIdx.x; g < jb.hi; g += kThreads)
      perm[jb.pos_of[g]] = g;
  return __syncthreads_and(finite);
}

// out: (batch, n, n), the inverse (L1) or the packed factor (L4); perm:
// (batch, n) int64, L4's only.
template <typename T, bool LU>
__device__ void cluster_body(const T* __restrict__ a, T* __restrict__ out,
                             long long* __restrict__ perm,
                             int* __restrict__ ok_out, int n, int pivot) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const size_t item = blockIdx.x / nc;
  const int rows_per = (n + nc - 1) / nc;
  const int lo = min(n, rank * rows_per);
  const int hi = min(n, lo + rows_per);
  const Carve<T> c = carve<T>(smem, rows_per, n, true, true);
  load_rows(a + item * n * n, c.rows, c.maps, lo, hi, n);
  ClusterComm comm{cl, c.props, prop_bytes(n, sizeof(T)), c.flag};
  const Job<T> jb = matrix_job(c, c.rows, lo, hi, rows_per, n, pivot);
  const int ok = run_steps<T, true, LU>(comm, jb, nullptr);
  const int finite =
      store<T, LU>(jb, out + item * n * n, LU ? perm + item * n : nullptr, n);
  const int all = comm.all(ok && finite);
  if (rank == 0 && threadIdx.x == 0) ok_out[item] = all;
}

// work: the (n, n) workspace of the rows when they do not fit in shared
// memory; props: (2, g) proposals; bar: one unsigned, zero; flags: g ints.
template <typename T, bool LU>
__device__ void grid_body(const T* __restrict__ a, T* __restrict__ out,
                          long long* __restrict__ perm,
                          int* __restrict__ ok_out, T* work, char* props,
                          unsigned* bar, int* flags, int batch, int n,
                          int pivot, int rows_shared) {
  extern __shared__ __align__(16) char smem[];
  const int g = (int)gridDim.x;
  const int rank = (int)blockIdx.x;
  const int rows_per = (n + g - 1) / g;
  const int lo = min(n, rank * rows_per);
  const int hi = min(n, lo + rows_per);
  const Carve<T> c = carve<T>(smem, rows_per, n, rows_shared, false);
  T* v = rows_shared ? c.rows : work + (size_t)lo * n;
  GridComm comm{props, prop_bytes(n, sizeof(T)), bar, flags, g, rank};
  const Job<T> jb = matrix_job(c, v, lo, hi, rows_per, n, pivot);
  for (int item = 0; item < batch; ++item) {
    load_rows(a + (size_t)item * n * n, v, c.maps, lo, hi, n);
    const int ok = run_steps<T, true, LU>(comm, jb, nullptr);
    const int finite =
        store<T, LU>(jb, out + (size_t)item * n * n,
                     LU ? perm + (size_t)item * n : nullptr, n);
    // The group barrier inside all() also keeps the next matrix's
    // proposals from overwriting ones a member may still read.
    const int all = comm.all(ok && finite);
    if (rank == 0 && threadIdx.x == 0) ok_out[item] = all;
  }
}

// One kernel a mode and branch, so that a profile tells L1 from L4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gauss_jordan_cluster_kernel(const T* __restrict__ a, T* __restrict__ out,
                            long long* __restrict__ perm,
                            int* __restrict__ ok_out, int n, int pivot) {
  cluster_body<T, false>(a, out, perm, ok_out, n, pivot);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_factor_cluster_kernel(const T* __restrict__ a, T* __restrict__ out,
                         long long* __restrict__ perm,
                         int* __restrict__ ok_out, int n, int pivot) {
  cluster_body<T, true>(a, out, perm, ok_out, n, pivot);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gauss_jordan_grid_kernel(const T* __restrict__ a, T* __restrict__ out,
                         long long* __restrict__ perm,
                         int* __restrict__ ok_out, T* work, char* props,
                         unsigned* bar, int* flags, int batch, int n,
                         int pivot, int rows_shared) {
  grid_body<T, false>(a, out, perm, ok_out, work, props, bar, flags, batch,
                      n, pivot, rows_shared);
}

template <typename T>
const void* cluster_kernel(int lu) {
  return lu ? reinterpret_cast<const void*>(&lu_factor_cluster_kernel<T>)
            : reinterpret_cast<const void*>(&gauss_jordan_cluster_kernel<T>);
}

template <typename T>
int launch(const void* a, void* out, void* perm, int* ok, void* work,
           void* props, void* bar, void* flags, int batch, int n, int lu,
           int pivot, int branch, int ctas, int rows_shared, int smem,
           cudaStream_t stream) {
  const T* in = static_cast<const T*>(a);
  T* dst = static_cast<T*>(out);
  long long* pm = static_cast<long long*>(perm);
  if (lu && pm == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (branch == 0) {
    const void* kernel = cluster_kernel<T>(lu);
    err = cluster_config(kernel, batch, n, ctas, smem, sizeof(T), stream,
                         &cfg, &attr);
    if (err != cudaSuccess) return err;
    void* args[] = {&in, &dst, &pm, &ok, &n, &pivot};
    err = cudaLaunchKernelExC(&cfg, kernel, args);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const int rows_per = ctas > 0 ? (n + ctas - 1) / ctas : 0;
  if (lu || batch < 1 || n < 1 || ctas < 1 || props == nullptr ||
      bar == nullptr || flags == nullptr ||
      (!rows_shared && work == nullptr) || smem < 0 ||
      (size_t)smem > kMaxShared ||
      (size_t)smem <
          smem_bytes(rows_per, n, 3 * n, sizeof(T), rows_shared, false))
    return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(
      &gauss_jordan_grid_kernel<T>);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  T* wk = static_cast<T*>(work);
  char* pr = static_cast<char*>(props);
  unsigned* br = static_cast<unsigned*>(bar);
  int* fl = static_cast<int*>(flags);
  void* args[] = {&in, &dst, &pm, &ok, &wk, &pr, &br, &fl, &batch, &n,
                  &pivot, &rows_shared};
  err = launch_grid(kernel, ctas, smem, stream, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// a: (batch, n, n) input; out: (batch, n, n), the inverse (lu == 0, L1) or
// the packed factor (lu != 0, L4); perm: (batch, n) int64, L4's (unused by
// L1); ok: (batch,) int32; fp64 != 0 means double, else float. branch 0:
// one cluster of `ctas` CTAs per matrix (n <= 511; work, props, bar and
// flags unused); branch 1 (L1 only): a persistent grid of `ctas` CTAs, one
// matrix at a time, with work ((n, n) values, unused when rows_shared), props
// ((2, ctas) proposals), bar (one unsigned, zero) and flags (ctas ints),
// launched cooperatively. smem: the bytes of shared memory a CTA gets (the
// wrapper's geometry, ops/gauss_jordan.py loop_geometry). Returns the
// cudaError_t of the launch.
extern "C" int matinv_gauss_jordan(const void* a, void* out, void* perm,
                                   int* ok, void* work, void* props,
                                   void* bar, void* flags, int batch, int n,
                                   int fp64, int lu, int pivot, int branch,
                                   int ctas, int rows_shared, int smem,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return fp64 ? launch<double>(a, out, perm, ok, work, props, bar, flags,
                               batch, n, lu, pivot, branch, ctas,
                               rows_shared, smem, st)
              : launch<float>(a, out, perm, ok, work, props, bar, flags,
                              batch, n, lu, pivot, branch, ctas, rows_shared,
                              smem, st);
}

// Clusters of the cluster branch of mode `lu` (as above) with the given
// geometry that the card can hold at once (cudaOccupancyMaxActiveClusters;
// 0 means the launch would be refused). Returns the cudaError_t of the
// query.
extern "C" int matinv_gauss_jordan_clusters(int n, int fp64, int lu,
                                            int cluster, int smem,
                                            int* clusters) {
  const void* kernel =
      fp64 ? cluster_kernel<double>(lu) : cluster_kernel<float>(lu);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, 1, n, cluster, smem,
                                   fp64 ? 8 : 4, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  cudaGetLastError();  // a refused size must not fail the next launch check
  return err;
}
