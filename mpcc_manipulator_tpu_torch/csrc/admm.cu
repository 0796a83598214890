// K5: the OSQP ADMM loop on one Ruiz-scaled dense QP per scenario, with
// the unscaled termination test at entry and after every `check_every`
// iterations and an exit per scenario, in one launch.
//
// Replaces the TPU kernel `_admm_kernel` in
// mpcc_manipulator_tpu/ops/pallas_admm.py (entry `fused_admm`, reached
// from `solver/qp_admm.solve_qp(backend="pallas")`).  The plain version is
// `fused_admm_plain` in ops/admm_kernel.py of this package.
//
// Per iteration (x, q in R^n; z, y, rho, l, u in R^m):
//   rhs = sigma x - q + A'(rho z - y);  x = rhs' K^-1;  zt = A x;
//   zr = alpha zt + (1 - alpha) z;  z = clip(zr + y / rho, l, u);
//   y = y + rho (zr - z).
//
// What bounds it on the H100: arithmetic.  One iteration is 2mn (A'w) +
// 2n^2 (rhs' K^-1) + 2mn (A x) = 407 kFLOP at the MPCC size (n = 179,
// m = 479); at the RTI cap of 200 iterations and batch 1024 that is 83
// GFLOP, 1.25 ms at the 67 TFLOP/s of float32 outside the tensor cores,
// while the inputs (613 KB per scenario, 628 MB at batch 1024) take 0.19
// ms to read once at 3.35 TB/s.
//
// Design: one thread block (512 threads) per scenario.  K^-1 (128 KB at
// n = 179) and every iterate vector sit in dynamic shared memory (161 KB
// in all at the MPCC size, so one block per SM); A and P are read from
// global memory at each use.  A'v and v'K^-1 are column sums: the warps
// split the rows, the lanes of a warp take neighbouring columns (coalesced
// global reads, conflict-free shared reads), and the warps' partial sums
// meet in shared memory.  A x is a warp per row with a shuffle reduction.
// A block leaves its loop when its scenario converges: the per-scenario
// exit of the TPU kernel.  This design streams A from L2 / HBM twice per
// iteration (686 KB x 200 x 1024 = 140 GB per RTI tick, >= 42 ms at 3.35
// TB/s where L2 does not hold it), far from the bound above; keeping A
// on chip across iterations (for example split over a thread block
// cluster) is the redesign.  The TPU kernel's 256/512 padding and its
// transposed copy of A were Mosaic layout needs and are not carried over:
// n and m are runtime arguments, and the ragged edges are masked.
//
// NaN: the maxima, the clip and the block reductions propagate a NaN as
// jnp.max / jnp.clip do, so a scenario with a NaN never tests converged:
// it runs to its budget and comes out NaN, and no other scenario sees it.
//
// Layouts (row-major, batch-first): kinv, p (B,n,n); a (B,m,n); q, dscl,
// x0 (B,n); rho, l, u, escl, z0, y0 (B,m); cscl (B)
//   -> x (B,n), z, y (B,m), it (B) int32 (iterations run, whole chunks).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;   // propagates NaN like jnp.maximum
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// Block-wide NaN-propagating max; every thread gets the result.  `red`
// holds NWARPS floats; the leading barrier protects it from its last use.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARPS; ++w) r = nan_max(r, red[w]);
  return r;
}

// part[w * cols + j] = sum over the rows i of warp w of mat[i, j] v[i];
// `mat` is row-major (rows, cols), in global or shared memory.
__device__ void col_partials(const float* mat, int rows, int cols,
                             const float* v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = lane; j < cols; j += 32) {
    float acc = 0.f;
    for (int i = warp; i < rows; i += NWARPS)
      acc = fmaf(mat[(size_t)i * cols + j], v[i], acc);
    part[warp * cols + j] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float part_sum(const float* part, int cols,
                                          int j) {
  float s = part[j];
  for (int w = 1; w < NWARPS; ++w) s += part[w * cols + j];
  return s;
}

// out[i] = mat[i, :] . v for every row: a warp per row.
__device__ void row_dots(const float* mat, int rows, int cols,
                         const float* v, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += NWARPS) {
    const float* r = mat + (size_t)i * cols;
    float acc = 0.f;
    for (int j = lane; j < cols; j += 32) acc = fmaf(r[j], v[j], acc);
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[i] = acc;
  }
  __syncthreads();
}

struct Shared {
  float *kinv, *x, *q, *d, *t1, *z, *y, *rho, *irho, *l, *u, *e, *w, *ax,
      *part, *red;
};

size_t smem_floats(int n, int m) {
  return (size_t)n * n + 4 * (size_t)n + 9 * (size_t)m
         + (size_t)NWARPS * n + NWARPS;
}

__device__ Shared carve(float* base, int n, int m) {
  Shared s;
  float* p = base;
  s.kinv = p; p += (size_t)n * n;
  s.x = p; p += n;
  s.q = p; p += n;
  s.d = p; p += n;
  s.t1 = p; p += n;
  s.z = p; p += m;
  s.y = p; p += m;
  s.rho = p; p += m;
  s.irho = p; p += m;
  s.l = p; p += m;
  s.u = p; p += m;
  s.e = p; p += m;
  s.w = p; p += m;
  s.ax = p; p += m;
  s.part = p; p += (size_t)NWARPS * n;
  s.red = p;
  return s;
}

struct Params {
  int n, m, max_iter, check_every;
  float sigma, alpha, eps_abs, eps_rel;
};

// The unscaled OSQP test on (x, z, y), with s.ax = A x on entry; every
// thread returns the same verdict.
__device__ bool converged(const Shared& s, const float* a,
                          const float* p, const Params& pr, float cscl,
                          float q_abs_d) {
  const int n = pr.n, m = pr.m, tid = threadIdx.x;
  col_partials(p, n, n, s.x, s.part);            // px = x'P
  for (int j = tid; j < n; j += THREADS) s.t1[j] = part_sum(s.part, n, j);
  __syncthreads();
  col_partials(a, m, n, s.y, s.part);            // aty = y'A
  float r_dual = 0.f, s_dual = 0.f;
  for (int j = tid; j < n; j += THREADS) {
    const float aty = part_sum(s.part, n, j), px = s.t1[j], d = s.d[j];
    r_dual = nan_max(r_dual, fabsf(d * (px + s.q[j] + aty) / cscl));
    s_dual = nan_max(s_dual, nan_max(fabsf(d * px), fabsf(d * aty)));
  }
  float r_prim = 0.f, s_prim = 0.f;
  for (int i = tid; i < m; i += THREADS) {
    const float axi = s.ax[i], zi = s.z[i], ei = s.e[i];
    r_prim = nan_max(r_prim, fabsf((axi - zi) / ei));
    s_prim = nan_max(s_prim, nan_max(fabsf(axi / ei), fabsf(zi / ei)));
  }
  r_prim = block_max(r_prim, s.red);
  s_prim = block_max(s_prim, s.red);
  r_dual = block_max(r_dual, s.red);
  s_dual = nan_max(block_max(s_dual, s.red), q_abs_d) / cscl;
  return r_prim <= pr.eps_abs + pr.eps_rel * s_prim
         && r_dual <= pr.eps_abs + pr.eps_rel * s_dual;
}

struct Inputs {
  const float *kinv, *p, *a, *q, *rho, *l, *u, *dscl, *escl, *cscl, *x0,
      *z0, *y0;
};
struct Outputs {
  float *x, *z, *y;
  int* it;
};

__global__ void __launch_bounds__(THREADS)
admm_kernel(Inputs in, Outputs out, Params pr) {
  extern __shared__ float smem[];
  const int n = pr.n, m = pr.m, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const Shared s = carve(smem, n, m);
  const float* a = in.a + b * m * n;
  const float* p = in.p + b * n * n;
  const float* kinv = in.kinv + b * n * n;
  for (int i = tid; i < n * n; i += THREADS) s.kinv[i] = kinv[i];
  for (int j = tid; j < n; j += THREADS) {
    s.x[j] = in.x0[b * n + j];
    s.q[j] = in.q[b * n + j];
    s.d[j] = in.dscl[b * n + j];
  }
  for (int i = tid; i < m; i += THREADS) {
    const float rho = in.rho[b * m + i], zi = in.z0[b * m + i],
                yi = in.y0[b * m + i];
    s.z[i] = zi;
    s.y[i] = yi;
    s.rho[i] = rho;
    s.irho[i] = 1.f / rho;
    s.l[i] = in.l[b * m + i];
    s.u[i] = in.u[b * m + i];
    s.e[i] = in.escl[b * m + i];
    s.w[i] = rho * zi - yi;
  }
  __syncthreads();
  const float cscl = in.cscl[b];
  float qd = 0.f;
  for (int j = tid; j < n; j += THREADS)
    qd = nan_max(qd, fabsf(s.d[j] * s.q[j]));
  const float q_abs_d = block_max(qd, s.red);

  // entry test: a warm start that already passes exits with it = 0
  row_dots(a, m, n, s.x, s.ax);
  bool done = converged(s, a, p, pr, cscl, q_abs_d);
  int it = 0;
  while (!done && it < pr.max_iter) {
    for (int k = 0; k < pr.check_every; ++k) {
      col_partials(a, m, n, s.w, s.part);                // A'(rho z - y)
      for (int j = tid; j < n; j += THREADS)
        s.t1[j] = pr.sigma * s.x[j] - s.q[j] + part_sum(s.part, n, j);
      __syncthreads();
      col_partials(s.kinv, n, n, s.t1, s.part);          // rhs' K^-1
      for (int j = tid; j < n; j += THREADS) s.x[j] = part_sum(s.part, n, j);
      __syncthreads();
      row_dots(a, m, n, s.x, s.ax);                      // zt = A x
      for (int i = tid; i < m; i += THREADS) {
        const float zr = pr.alpha * s.ax[i] + (1.f - pr.alpha) * s.z[i];
        const float zn =
            nan_min(nan_max(zr + s.y[i] * s.irho[i], s.l[i]), s.u[i]);
        const float yn = s.y[i] + s.rho[i] * (zr - zn);
        s.z[i] = zn;
        s.y[i] = yn;
        s.w[i] = s.rho[i] * zn - yn;
      }
      __syncthreads();
    }
    it += pr.check_every;
    done = converged(s, a, p, pr, cscl, q_abs_d);   // s.ax = A x still
  }

  for (int j = tid; j < n; j += THREADS) out.x[b * n + j] = s.x[j];
  for (int i = tid; i < m; i += THREADS) {
    out.z[b * m + i] = s.z[i];
    out.y[b * m + i] = s.y[i];
  }
  if (tid == 0) out.it[b] = it;
}

}  // namespace

extern "C" int mpcc_admm_solve(
    const float* kinv, const float* p, const float* a, const float* q,
    const float* rho, const float* l, const float* u, const float* dscl,
    const float* escl, const float* cscl, const float* x0, const float* z0,
    const float* y0, float* x, float* z, float* y, int* it, int batch, int n,
    int m, int max_iter, int check_every, float sigma, float alpha,
    float eps_abs, float eps_rel, void* stream) {
  if (batch <= 0) return 0;
  const size_t bytes = smem_floats(n, m) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Inputs in{kinv, p, a, q, rho, l, u, dscl, escl, cscl, x0, z0, y0};
  Outputs out{x, z, y, it};
  Params pr{n, m, max_iter, check_every, sigma, alpha, eps_abs, eps_rel};
  admm_kernel<<<batch, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      in, out, pr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpcc_admm_smem_bytes(int n, int m) {
  return static_cast<int>(smem_floats(n, m) * sizeof(float));
}
