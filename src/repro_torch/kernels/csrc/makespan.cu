// Population makespan: capacity-aware, core-granular list scheduling of a
// population of candidate assignments (the metaheuristics' fitness).
//
// Replaces the TPU kernel population_makespan_pallas (_kernel) in
// src/repro/kernels/makespan.py, with the comparison-rank select of
// src/repro/kernels/select.py.  Its plain PyTorch version is
// population_makespan_ref in src/repro_torch/kernels/makespan.py; the two
// agree bit for bit.
//
// What bounds it on an H100.  The function needs an O(CMAX) selection and
// overwrite per (candidate, task) and one divide-add-max per dependency edge
// and candidate, and reads about a megabyte of the tables: at the Table IX
// shapes (P=64, T=500, N=500, CMAX=64) the roofline bound is under a
// microsecond, by bytes.  What that bound leaves out is the chain: task j
// needs the finish times of its predecessors and the core-free row left by
// every earlier task on its node, so each candidate walks T dependent steps,
// each a gather from device memory, two reductions and block barriers.  The
// kernel is latency-bound on that chain, not bound by bytes or operations.
//
// What the design does about it.  One thread block per (instance,
// candidate): blockIdx.x is the candidate, blockIdx.y the instance, so a
// ga_sweep family runs in one launch and every block walks its own chain
// with no communication between blocks.  The block keeps its assignment
// row and the finish times in shared memory.  Warp 0 folds the predecessor
// terms while the other threads load the node's core-free row, one thread
// per core slot; the row is ranked in shared memory (O(CMAX) compares per
// thread) and only the overwritten slots go back.  The per-candidate state
// core_free [B, P, N, CMAX] lives in device memory (8.2 MB at Table IX, so
// it stays in the 50 MB L2); the wrapper allocates it.
//
// Bit-identity with the reference: the transfer time is a correctly
// rounded division (__fdiv_rn) and the adds are __fadd_rn, so nothing is
// contracted or approximated (never build this with --use_fast_math); the
// transfer rate is the direct gather dtr[pn * N + i], not the reference's
// one-hot product; maxima propagate NaN as jnp.maximum does and are exact in
// any order; the k-th smallest and the update use the same stable ranks as
// the reference, not a sort, so ties resolve identically.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

// jnp.maximum / torch.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void population_makespan_kernel(
    const int* __restrict__ assign,            // [B, P, T]
    const float* __restrict__ durations,       // [B, T, N]
    const int* __restrict__ cores,             // [B, T]
    const float* __restrict__ data,            // [B, T]
    const unsigned char* __restrict__ feasible,  // [B, T, N]
    const float* __restrict__ release,         // [B, T]
    const float* __restrict__ deadline,        // [B, T] or null
    const int* __restrict__ preds,             // [B, T, MAXP], -1 padded
    const float* __restrict__ dtr,             // [B, N, N]
    const float* __restrict__ init_free,       // [B, N, C]
    const int* __restrict__ node_cores,        // [B, N]
    float* __restrict__ makespan,              // [B, P]
    float* __restrict__ violations,            // [B, P]
    float* __restrict__ core_free,             // [B, P, N, C] scratch
    int T, int N, int C, int MAXP) {
  extern __shared__ unsigned char smem[];
  int* s_assign = reinterpret_cast<int*>(smem);      // [T]
  float* s_fin = reinterpret_cast<float*>(s_assign + T);  // [T]
  float* s_row = s_fin + T;                          // [blockDim.x]
  __shared__ float s_ready, s_kth;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const size_t cand = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  const size_t tn = static_cast<size_t>(T) * N;
  const size_t nc = static_cast<size_t>(N) * C;

  const int* a = assign + cand * T;
  const float* dur_b = durations + b * tn;
  const unsigned char* feas_b = feasible + b * tn;
  const int* cores_b = cores + static_cast<size_t>(b) * T;
  const float* data_b = data + static_cast<size_t>(b) * T;
  const float* rel_b = release + static_cast<size_t>(b) * T;
  const float* dl_b = deadline ? deadline + static_cast<size_t>(b) * T : nullptr;
  const int* preds_b = preds + static_cast<size_t>(b) * T * MAXP;
  const float* dtr_b = dtr + static_cast<size_t>(b) * N * N;
  const int* ncores_b = node_cores + static_cast<size_t>(b) * N;
  const float* init_b = init_free + b * nc;
  float* cf = core_free + cand * nc;

  for (size_t k = tid; k < nc; k += blockDim.x) cf[k] = init_b[k];
  for (int k = tid; k < T; k += blockDim.x) {
    s_assign[k] = a[k];
    s_fin[k] = 0.0f;
  }
  __syncthreads();

  const bool slot = tid < C;  // this thread owns core slot `tid`
  int viol = 0;
  float mk = 0.0f;
  for (int j = 0; j < T; ++j) {
    const int i = s_assign[j];
    // ready time (Eq. 12 with the Eq. 5 transfer), folded by warp 0
    if (tid < 32) {
      float r = kNeg;
      for (int q = tid; q < MAXP; q += 32) {
        const int p = preds_b[static_cast<size_t>(j) * MAXP + q];
        if (p >= 0) {
          const int pn = s_assign[p];
          const float tt =
              pn == i ? 0.0f : __fdiv_rn(data_b[p], dtr_b[static_cast<size_t>(pn) * N + i]);
          r = nan_max(r, __fadd_rn(s_fin[p], tt));
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        r = nan_max(r, __shfl_xor_sync(0xffffffffu, r, off));
      if (tid == 0) {
        s_ready = nan_max(rel_b[j], r);
        s_kth = 0.0f;
      }
    }
    const float v = slot ? cf[static_cast<size_t>(i) * C + tid] : 0.0f;
    if (slot) s_row[tid] = v;
    __syncthreads();

    // stable rank of this slot; the slot ranked c-1 holds the c-th smallest
    const int c = max(min(cores_b[j], ncores_b[i]), 1);
    int rank = 0;
    if (slot) {
      for (int m = 0; m < C; ++m) {
        const float u = s_row[m];
        rank += (u < v) | ((u == v) & (m < tid));
      }
      if (rank == c - 1) s_kth = v;
    }
    __syncthreads();

    const float f = __fadd_rn(nan_max(s_ready, s_kth), dur_b[static_cast<size_t>(j) * N + i]);
    if (slot && rank < c) cf[static_cast<size_t>(i) * C + tid] = f;
    if (tid == 0) {
      s_fin[j] = f;
      mk = nan_max(mk, f);
      viol += feas_b[static_cast<size_t>(j) * N + i] == 0;
      if (dl_b != nullptr && f > dl_b[j]) viol += 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    makespan[cand] = mk;
    violations[cand] = static_cast<float>(viol);
  }
}

}  // namespace

// Threads per block for a core window of C slots: whole warps, at least one.
extern "C" int population_makespan_threads(int C) { return ((C > 32 ? C : 32) + 31) / 32 * 32; }

// Dynamic shared memory for T tasks and a block of `threads`.
extern "C" long long population_makespan_smem(int T, int threads) {
  return static_cast<long long>(T) * (sizeof(int) + sizeof(float)) +
         static_cast<long long>(threads) * sizeof(float);
}

// Most dynamic shared memory a block of this kernel may ask for on the
// current device: the opt-in limit less the kernel's static shared memory.
// A CUDA error comes back negated.
extern "C" long long population_makespan_max_smem() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, population_makespan_kernel);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
extern "C" int population_makespan(
    const void* assign, const void* durations, const void* cores, const void* data,
    const void* feasible, const void* release, const void* deadline, const void* preds,
    const void* dtr, const void* init_free, const void* node_cores, void* makespan,
    void* violations, void* core_free, int B, int P, int T, int N, int C, int MAXP,
    void* stream) {
  const int threads = population_makespan_threads(C);
  const long long smem = population_makespan_smem(T, threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        population_makespan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  population_makespan_kernel<<<dim3(P, B), threads, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(assign), static_cast<const float*>(durations),
      static_cast<const int*>(cores), static_cast<const float*>(data),
      static_cast<const unsigned char*>(feasible), static_cast<const float*>(release),
      static_cast<const float*>(deadline), static_cast<const int*>(preds),
      static_cast<const float*>(dtr), static_cast<const float*>(init_free),
      static_cast<const int*>(node_cores), static_cast<float*>(makespan),
      static_cast<float*>(violations), static_cast<float*>(core_free), T, N, C, MAXP);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
