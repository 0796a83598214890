// K4: kinematics sweep -- FK, point Jacobian, manipulability and its
// analytic gradient -- for every (scenario, knot) of a tick, for the Panda
// and the Husky+Panda mobile manipulator.
//
// Replaces the TPU kernel `_kin_kernel` in
// mpcc_manipulator_tpu/ops/pallas_kinematics.py (entry `kin_sweep`), both
// of its branches: the fixed base, and the planar base (`base_dof != 0`).
//
// What bounded the kernel this one replaces -- the same per-thread code
// writing its outputs straight to global memory, 128-thread blocks
// (probe_k4 on it; H100 80GB HBM3, 700 W; Panda at batch 1024, Husky+Panda
// at 4096 and 1024, 11 knots a scenario):
//   * Stores.  A thread wrote its 62 (Panda) or 83 floats as scalar stores
//     at a stride of 62 / 83 floats, so every warp store touched 32 lines.
//     The phase that issues p, R, jv and jw took 46 % of a block at
//     Panda/1024 (2.7 warps an SM), 60 % at Husky+Panda/1024 and 76 % at
//     /4096 (10.7 warps an SM): its share grew with the warps sharing an
//     SM's store path, which is why 4x the configurations took 2.7x the
//     time (0.0230 -> 0.0670 ms).
//   * Not code size (5,360 / 5,648 SASS instructions): the gradient loop
//     at `unroll 1` (280 B of stack) was slower, 0.0214 against 0.0179 ms.
//     Not the SM spread alone: 64-thread blocks gave 0.0188 ms.  The IEEE
//     divisions cost 21 % at Panda/1024 (one reciprocal per pivot and per
//     diagonal: 0.0141 ms), but change the outputs' rounding (below).
//
// Design: one thread a configuration, its arithmetic the replaced
// kernel's operation for operation, so all six outputs are bit-identical
// to it at both dims (compare_k23).  The outputs go to shared memory, each
// the block's contiguous share of its tensor, and leave with one pass of
// coalesced 16-byte stores a tensor (the wrapper allocates the six on
// 16-byte boundaries).  64 configurations a 64-thread block: 176 blocks at
// Panda/1024, so every SM gets work; 153 registers, 6 blocks an SM, no
// stack or spills.  Shared memory, static: the 96 constants and 64 x (13 +
// 7 dof) output floats, 16,256 B (Panda) and 21,632 B (Husky+Panda).  The
// constants arrive as one buffer written by
// `models/kinematics.py::kinematics_constants`.  dJ/dq is never formed:
// each term dJ_i[:, j] . (A^-1 J)[:, j] is contracted as it is made, and
// dm_i sums its 7 terms in j order in one thread (the same bits every run).
// Why not a group of lanes a configuration (the layout first tried: 8
// lanes, 4 configurations a warp, FK by rows, the factorizations on two
// lanes, the gradient by columns): with reciprocals and the gradient
// regrouped it ran 0.0079 ms at Panda/1024 but 0.0239 at Husky+Panda/4096,
// and every build of it rounded m and dm differently (up to 4e-7 of their
// scale).  That moved the float32 Mehrotra solves downstream across the
// closed-loop checks (ROADMAP section 3, F1): one build put a K1-h step
// 1.56e-3 off its plain version (limit 1e-3), another the Mehrotra RTI
// loop 8.3e-4 off float64 (limit 7.5e-4).  Bit-identical outputs leave
// every downstream result as it was.  Its per-block phases (probe_k4)
// are now the arithmetic: the gradient 41 %, the determinant and the
// Cholesky 23 %, FK 14 %, the stores 16 %.
//
// The planar base is the compile-time BASE_DOF (0 or 3) of one kernel body.
// With a base, the arm's quantities are composed with R_b = R_z(th) and
// (x_b, y_b, 0): p = R_b p_arm + (x_b, y_b, 0), R = R_b R_arm; jv gains the
// base columns e_x, e_y and (-(R_b p_arm)_y, (R_b p_arm)_x, 0), jw the
// columns 0, 0 and e_z; the arm columns are rotated by R_b.  The
// manipulability is the arm's (rotation-invariant), with a zero gradient
// on the base columns.  A configuration's NaN stays in its thread; m is
// sqrt(max(det, 0)) with fmaxf, so a NaN determinant gives m = 0, as in
// the replaced kernel (the plain version gives NaN).
//
// Layouts (row-major, batch-first): q (n, dof) -> p (n, 3), R (n, 3, 3),
// jv (n, 3, dof), jw (n, 3, dof), m (n), dm (n, dof), n = batch * knots,
// dof = BASE_DOF + 7.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ARM = 7;
constexpr int NCONST = 7 * 9 + 7 * 3 + 9 + 3;   // R_off | p_off | R_post | p_post
constexpr int K4_THREADS = 64;                    // configurations a block

// The block's static shared memory (floats), each part 16-byte aligned:
// the constants, then the six outputs' staging, each the block's
// contiguous share of its tensor (K4_THREADS configurations).
template <int DOF>
struct Smem {
  static constexpr int C = 0;
  static constexpr int P = C + NCONST;
  static constexpr int R = P + K4_THREADS * 3;
  static constexpr int JV = R + K4_THREADS * 9;
  static constexpr int JW = JV + K4_THREADS * 3 * DOF;
  static constexpr int M = JW + K4_THREADS * 3 * DOF;
  static constexpr int DM = M + K4_THREADS;
  static constexpr int FLOATS = DM + K4_THREADS * DOF;
  static_assert(NCONST % 4 == 0 && K4_THREADS % 4 == 0, "16-byte parts");
  static_assert(FLOATS * 4 <= 48 * 1024, "static shared memory");
};

template <typename T>
__device__ __forceinline__ void cross3(const T a[3], const T b[3], T out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// One rounded operation a call: where PyTorch runs each as an op of its
// own, which rounds its result, nvcc would otherwise contract a product
// into the next sum.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// a . b over 3 as cuBLAS's small products round it on this card (the
// port's plain FK, `models/kinematics.py::fk_chain`, measured on an H100):
// one fused chain from k = 0, a0 b0 rounded first.
template <typename T>
__device__ __forceinline__ T dot3_chain(T a0, T a1, T a2, T b0, T b1, T b2) {
  return fma_rn(a2, b2, fma_rn(a1, b1, mul_rn(a0, b0)));
}

// torch.linalg.cross's rounding: a1 b2 - a2 b1 with the first product fused.
template <typename T>
__device__ __forceinline__ void cross3_plain(const T a[3], const T b[3],
                                             T out[3]) {
  out[0] = fma_rn(a[1], b[2], -mul_rn(a[2], b[1]));
  out[1] = fma_rn(a[2], b[0], -mul_rn(a[0], b[2]));
  out[2] = fma_rn(a[0], b[1], -mul_rn(a[1], b[0]));
}

// The arm's FK chain for the 7 joint angles at `qa` with the constants `c`
// (R_off | p_off | R_post | p_post): p += R p_off[i]; R_fixed = R R_off[i];
// R = R_fixed Rz(q_i).  World joint origins and axes, the EE position and
// rotation.  K4 and K6 share it, so the port has one hand-written FK.
// PLAIN rounds as the plain FK does (each product a `dot3_chain`, each sum
// of two rounded on its own), so K6 follows the plain route bit for bit;
// K4 keeps the rounding it always had (its outputs feed K1, ROADMAP F1).
template <bool PLAIN, typename T>
__device__ __forceinline__ void fk_arm(const T* __restrict__ qa, const T* c,
                                       T org[ARM][3], T ax[ARM][3],
                                       T p_ee[3], T r_ee[9]) {
  const T* r_off = c;
  const T* p_off = c + 63;
  const T* r_post = c + 84;
  const T* p_post = c + 93;
  T r[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  T p[3] = {0, 0, 0};
#pragma unroll
  for (int i = 0; i < ARM; ++i) {
    T pv[3], rf[9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T* ra = r + 3 * a;
      const T* po = p_off + 3 * i;
      const T* ro = r_off + 9 * i;
      if constexpr (PLAIN) {
        pv[a] = dot3_chain(ra[0], ra[1], ra[2], po[0], po[1], po[2]);
#pragma unroll
        for (int b = 0; b < 3; ++b)
          rf[3 * a + b] = dot3_chain(ra[0], ra[1], ra[2], ro[b], ro[3 + b],
                                     ro[6 + b]);
      } else {
        pv[a] = ra[0] * po[0] + ra[1] * po[1] + ra[2] * po[2];
#pragma unroll
        for (int b = 0; b < 3; ++b)
          rf[3 * a + b] = ra[0] * ro[b] + ra[1] * ro[3 + b]
                          + ra[2] * ro[6 + b];
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      p[a] = PLAIN ? add_rn(p[a], pv[a]) : p[a] + pv[a];
      org[i][a] = p[a];
      ax[i][a] = rf[3 * a + 2];
    }
    T cq, sq;
    sin_cos(qa[i], &sq, &cq);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if constexpr (PLAIN) {   // R_fixed times [[c, -s, 0], [s, c, 0], e_z]
        r[3 * a] = fma_rn(rf[3 * a + 1], sq, mul_rn(rf[3 * a], cq));
        r[3 * a + 1] = fma_rn(rf[3 * a + 1], cq, mul_rn(rf[3 * a], -sq));
      } else {
        r[3 * a] = rf[3 * a] * cq + rf[3 * a + 1] * sq;
        r[3 * a + 1] = -rf[3 * a] * sq + rf[3 * a + 1] * cq;
      }
      r[3 * a + 2] = rf[3 * a + 2];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T* ra = r + 3 * a;
    if constexpr (PLAIN) {
      p_ee[a] = add_rn(p[a], dot3_chain(ra[0], ra[1], ra[2], p_post[0],
                                        p_post[1], p_post[2]));
#pragma unroll
      for (int b = 0; b < 3; ++b)
        r_ee[3 * a + b] = dot3_chain(ra[0], ra[1], ra[2], r_post[b],
                                     r_post[3 + b], r_post[6 + b]);
    } else {
      p_ee[a] = p[a] + ra[0] * p_post[0] + ra[1] * p_post[1]
                + ra[2] * p_post[2];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        r_ee[3 * a + b] = ra[0] * r_post[b] + ra[1] * r_post[3 + b]
                          + ra[2] * r_post[6 + b];
    }
  }
}

// `len` floats from shared `src` to global `dst`, all threads of the block,
// consecutive threads on consecutive addresses; 16-byte stores where `dst`
// is 16-byte aligned (`src` always is).
__device__ __forceinline__ void store_range(float* __restrict__ dst,
                                            const float* src, int len) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = len >> 2;
    for (int i = threadIdx.x; i < n4; i += K4_THREADS)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += K4_THREADS)
    dst[i] = src[i];
}

template <int BASE_DOF>
__global__ void __launch_bounds__(K4_THREADS)
kin_kernel(const float* __restrict__ q, const float* __restrict__ consts,
           int n, float* __restrict__ pe_out, float* __restrict__ re_out,
           float* __restrict__ jv_out, float* __restrict__ jw_out,
           float* __restrict__ m_out, float* __restrict__ dm_out) {
  constexpr int DOF = BASE_DOF + ARM;
  using S = Smem<DOF>;
  __shared__ __align__(16) float sm[S::FLOATS];
  const float* c = sm + S::C;
  for (int i = threadIdx.x; i < NCONST; i += K4_THREADS)
    sm[S::C + i] = consts[i];
  __syncthreads();
  // ---- 0. one thread a configuration; a thread past n computes the last
  // configuration again and stores nothing
  const int c0 = blockIdx.x * K4_THREADS;
  const int nb = min(K4_THREADS, n - c0);
  const int tl = threadIdx.x;
  const int t = min(c0 + tl, n - 1);

  // ---- 1. FK chain
  float org[ARM][3], ax[ARM][3], p_ee[3], r_ee[9];
  fk_arm<false>(q + (size_t)t * DOF + BASE_DOF, c, org, ax, p_ee, r_ee);

  // ---- 2. arm Jacobian columns J_j = [z_j x (p_e - p_j); z_j], arm frame
  float rel[ARM][3], jvc[ARM][3];
#pragma unroll
  for (int j = 0; j < ARM; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a) rel[j][a] = p_ee[a] - org[j][a];
    cross3(ax[j], rel[j], jvc[j]);
  }

  // ---- outputs: the arm's, or composed with the planar base
  float* pe = sm + S::P + tl * 3;
  float* re = sm + S::R + tl * 9;
  float* jv = sm + S::JV + tl * 3 * DOF;
  float* jw = sm + S::JW + tl * 3 * DOF;
  if constexpr (BASE_DOF == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pe[a] = p_ee[a];
#pragma unroll
      for (int b = 0; b < 3; ++b) re[3 * a + b] = r_ee[3 * a + b];
#pragma unroll
      for (int j = 0; j < ARM; ++j) {
        jv[a * DOF + j] = jvc[j][a];
        jw[a * DOF + j] = ax[j][a];
      }
    }
  } else {
    const float* qb = q + (size_t)t * DOF;
    float cb, sb;
    sincosf(qb[2], &sb, &cb);
    // R_b v for v in the arm's base frame
    auto rot = [cb, sb](const float v[3], float out[3]) {
      out[0] = cb * v[0] - sb * v[1];
      out[1] = sb * v[0] + cb * v[1];
      out[2] = v[2];
    };
    float pr[3];
    rot(p_ee, pr);
    pe[0] = pr[0] + qb[0];
    pe[1] = pr[1] + qb[1];
    pe[2] = pr[2];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float col[3] = {r_ee[b], r_ee[3 + b], r_ee[6 + b]};
      float rc[3];
      rot(col, rc);
#pragma unroll
      for (int a = 0; a < 3; ++a) re[3 * a + b] = rc[a];
    }
    // base columns: prismatic x, prismatic y, revolute z about the base
    // origin, cross(e_z, R_b p) = (-(R_b p)_y, (R_b p)_x, 0)
    const float jvb[3][3] = {{1.f, 0.f, -pr[1]}, {0.f, 1.f, pr[0]},
                             {0.f, 0.f, 0.f}};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int j = 0; j < BASE_DOF; ++j) {
        jv[a * DOF + j] = jvb[a][j];
        jw[a * DOF + j] = (a == 2 && j == 2) ? 1.f : 0.f;
      }
#pragma unroll
    for (int j = 0; j < ARM; ++j) {
      float vr[3], wr[3];
      rot(jvc[j], vr);
      rot(ax[j], wr);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        jv[a * DOF + BASE_DOF + j] = vr[a];
        jw[a * DOF + BASE_DOF + j] = wr[a];
      }
    }
  }

  // ---- 3. A = J J' (6x6)
  float am[6][6];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < ARM; ++j) {
        const float ja = a < 3 ? jvc[j][a] : ax[j][a - 3];
        const float jb = b < 3 ? jvc[j][b] : ax[j][b - 3];
        acc += ja * jb;
      }
      am[a][b] = acc;
    }

  // ---- 4. manipulability sqrt(det A): clamped-pivot elimination
  float mm[6][6];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) mm[a][b] = am[a][b];
  float det = 1.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float piv = mm[k][k];
    det *= piv;
    const float safe = piv > 1e-30f ? piv : 1.f;
#pragma unroll
    for (int a = k + 1; a < 6; ++a)
#pragma unroll
      for (int b = k + 1; b < 6; ++b)
        mm[a][b] -= mm[a][k] * mm[k][b] / safe;
  }
  // a NaN det stays NaN (fmaxf would drop it), as the plain version's
  // clamp and the replaced kernel's jnp.clip keep it: 0 * det is a signed
  // zero for every finite det, which leaves m bit for bit as it was, and
  // NaN for a NaN det.  (A select on isnan(det) gives the same values but
  // makes ptxas lay the kernel out with a 32 B stack frame.)
  const float mani = sqrtf(fmaxf(det, 0.f)) + 0.f * det;
  sm[S::M + tl] = mani;

  // ---- damped Cholesky of A (trace-scaled shift, pivot floor)
  const float eps = FLT_EPSILON;
  const float scale =
      (am[0][0] + am[1][1] + am[2][2] + am[3][3] + am[4][4] + am[5][5]) / 6.f
      + eps;
  const float floor_v = eps * scale;
  float l[6][6];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b)
      mm[a][b] = am[a][b] + (a == b ? 10.f * eps * scale : 0.f);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float dg = sqrtf(fmaxf(mm[k][k], floor_v));
#pragma unroll
    for (int a = 0; a < 6; ++a) l[a][k] = a >= k ? mm[a][k] / dg : 0.f;
#pragma unroll
    for (int a = k + 1; a < 6; ++a)
#pragma unroll
      for (int b = k + 1; b < 6; ++b) mm[a][b] -= l[a][k] * l[b][k];
  }

  // ---- 5. dm_i = m * sum_j dJ_i[:, j] . (A^-1 J)[:, j]
  float dm[ARM];
#pragma unroll
  for (int i = 0; i < ARM; ++i) dm[i] = 0.f;
#pragma unroll
  for (int j = 0; j < ARM; ++j) {
    float y[6], x[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float acc = a < 3 ? jvc[j][a] : ax[j][a - 3];
#pragma unroll
      for (int b = 0; b < a; ++b) acc -= l[a][b] * y[b];
      y[a] = acc / l[a][a];
    }
#pragma unroll
    for (int a = 5; a >= 0; --a) {
      float acc = y[a];
#pragma unroll
      for (int b = a + 1; b < 6; ++b) acc -= l[b][a] * x[b];
      x[a] = acc / l[a][a];
    }
#pragma unroll
    for (int i = 0; i < ARM; ++i) {
      float djv[3], term;
      if (i < j) {
        float zz[3], t1[3], t2[3], t3[3];
        cross3(ax[i], ax[j], zz);
        cross3(zz, rel[j], t1);
        cross3(ax[i], rel[j], t2);
        cross3(ax[j], t2, t3);
#pragma unroll
        for (int a = 0; a < 3; ++a) djv[a] = t1[a] + t3[a];
        term = djv[0] * x[0] + djv[1] * x[1] + djv[2] * x[2]
               + zz[0] * x[3] + zz[1] * x[4] + zz[2] * x[5];
      } else {
        cross3(ax[j], jvc[i], djv);
        term = djv[0] * x[0] + djv[1] * x[1] + djv[2] * x[2];
      }
      dm[i] += term;
    }
  }
  float* dmo = sm + S::DM + tl * DOF;
#pragma unroll
  for (int i = 0; i < BASE_DOF; ++i) dmo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < ARM; ++i) dmo[BASE_DOF + i] = mani * dm[i];
  __syncthreads();

  // ---- 6. The block's share of each output, one contiguous range each.
  const size_t o = static_cast<size_t>(c0);
  store_range(pe_out + 3 * o, sm + S::P, 3 * nb);
  store_range(re_out + 9 * o, sm + S::R, 9 * nb);
  store_range(jv_out + 3 * DOF * o, sm + S::JV, 3 * DOF * nb);
  store_range(jw_out + 3 * DOF * o, sm + S::JW, 3 * DOF * nb);
  store_range(m_out + o, sm + S::M, nb);
  store_range(dm_out + DOF * o, sm + S::DM, DOF * nb);
  // ---- end.
}

template <int BASE_DOF>
int launch_config(int n, int* out) {
  const auto fn = kin_kernel<BASE_DOF>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      K4_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = K4_THREADS;
  out[1] = K4_THREADS;
  out[2] = (n + K4_THREADS - 1) / K4_THREADS;
  out[3] = static_cast<int>(fa.sharedSizeBytes);
  out[4] = blocks;
  out[5] = fa.numRegs;
  out[6] = static_cast<int>(fa.localSizeBytes);
  out[7] = sms;
  return 0;
}

// ---------------------------------------------------------------------------
// K6: the tick's projection (`mpc.py` step 1) in one launch: FK of x0, the
// arc-length projection of the EE onto the track
// (`splines/arc_length.py::project_on_spline`: the waypoint fallback, up to
// 20 Newton steps) and vs = (Jv dq) . t(s_proj).
//
// It replaces no TPU kernel: JAX fuses step 1 with XLA.  Its plain version
// in eager PyTorch is ~4,600 small ops a tick (~220 a Newton iteration),
// each a launch the host makes in ~13 us, so the device idles behind the
// host for ~60 ms a tick at any batch (H100 80GB HBM3, 700 W).  The work is
// small: a lane's 100 waypoints, 3 cubic channels and at most 20 scalar
// Newton steps.  So one thread a lane, the track's tables (12 x nk
// coefficients, the waypoints and knots, ~6.8 KB in float32) staged in
// shared memory once a block, and nothing read or written but the lane's
// x0 / u0 rows and its outputs.  Neither bytes nor operations bound it
// (~0.001 ms of either at 32,768 lanes): a lane's chain of dependent
// operations does, with a block's staging of the tables.
//
// The arithmetic is the plain route's, op for op, so that K6 gives its
// bits: every PyTorch op there rounds its result, so each product and sum
// here is rounded on its own (`mul_rn` / `add_rn` / `sub_rn`, never
// contracted); the FK is K4's code in the rounding of the plain FK's
// cuBLAS products (`fk_arm<true>`, `cross3_plain`); the spline end-point
// rules are `splines/cubic.py`'s; the sums take PyTorch's reduction order
// (`sum3`, `sum_acc4`; each order and the products' were read off PyTorch's
// results on an H100).  Leaving the Newton loop at the first converged
// step is the plain route's result: once a lane has converged, its
// s_result never changes.  The trig functions' slow path (|q| > 1e5) keeps
// a 32 B (float) / 40 B (double) array on the stack; no lane reaches it.

constexpr int K6_THREADS = 128;
constexpr int NCHAN = 3;           // the track's position channels x, y, z
constexpr int NEWTON_STEPS = 20;

// torch.sum over a contiguous last dim of 3: two lanes of a warp split it
// (lane 0 takes elements 0 and 2), then one shuffle: (x0 + x2) + x1.
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  return add_rn(add_rn(add_rn(T(0), x0), x2), add_rn(T(0), x1));
}

// torch.sum over a strided dim of N in one thread: four accumulators,
// element i into i % 4, then ((v0 + v1) + v2) + v3.
template <int N, typename T>
__device__ __forceinline__ T sum_acc4(const T x[N]) {
  T v[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < N; ++i) v[i % 4] = add_rn(v[i % 4], x[i]);
  return add_rn(add_rn(add_rn(v[0], v[1]), v[2]), v[3]);
}

// torch.minimum(torch.clamp(s, min=0), hi): a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_s(T s, T hi) {
  if (s != s || hi != hi) return s != s ? s : hi;
  s = s > T(0) ? s : T(0);
  return s < hi ? s : hi;
}

// torch.argmin's order: a NaN is the least value, ties go to the lower
// index (the caller scans upward).
template <typename T>
__device__ __forceinline__ bool before(T a, T best) {
  if (a != a) return best == best;
  return a < best;
}

// One channel's spline at s (`splines/cubic.py`): the clamped s, the
// segment floor(s / delta) clamped to [0, nk - 2], and value, derivative
// and second derivative, with the end-point rules at s >= length (a[-1],
// 0 and 2 c[-1]).
template <typename T>
__device__ __forceinline__ void spline_eval(const T* a, const T* b, const T* c,
                                            const T* d, T delta, T len,
                                            int nk, T s_in, T* val, T* der,
                                            T* sec) {
  const T s = clamp_s(s_in, len);
  long long idx = static_cast<long long>(floor(s / delta));
  idx = idx < 0 ? 0 : (idx > nk - 2 ? nk - 2 : idx);
  const int i = static_cast<int>(idx);
  const T dx = sub_rn(s, mul_rn(static_cast<T>(idx), delta));
  const bool end = s >= len;
  const T v = add_rn(add_rn(add_rn(a[i], mul_rn(b[i], dx)),
                            mul_rn(mul_rn(c[i], dx), dx)),
                     mul_rn(mul_rn(mul_rn(d[i], dx), dx), dx));
  const T c2 = mul_rn(T(2), c[i]);
  const T e = add_rn(add_rn(b[i], mul_rn(c2, dx)),
                     mul_rn(mul_rn(mul_rn(T(3), d[i]), dx), dx));
  const T f = add_rn(c2, mul_rn(mul_rn(T(6), d[i]), dx));
  *val = end ? a[nk - 1] : v;
  *der = end ? T(0) : e;
  *sec = end ? mul_rn(T(2), c[nk - 1]) : f;
}

// The track's tables and the lane rows: the C entry fills it from the
// caller's pointers.
template <typename T>
struct ProjArgs {
  const T* x0;                   // (n, nx), rows x_stride apart
  const T* u0;                   // (n, nu), rows u_stride apart
  const T* consts;               // NCONST, K4's layout
  const T* coef[4 * NCHAN];      // a, b, c, d of x, then y, then z; (nk,)
  const T* wp;                   // (nk, 3)
  const T* s_knots;              // (nk,)
  const T* scal[2 * NCHAN + 2];  // delta and length a channel, the track's
                                 // length, max_dist_proj (0-d each)
  T* x0_out;                     // (n, nx): x0 with s and vs replaced
  T* s_out;                      // (n,)
  int n;
  int nk;
  int x_stride;
  int u_stride;
};

template <int BASE_DOF, typename T>
__global__ void __launch_bounds__(K6_THREADS)
proj_kernel(const ProjArgs<T> g) {
  constexpr int DOF = BASE_DOF + ARM;
  constexpr int NX = DOF + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nk = g.nk;
  T* cs = reinterpret_cast<T*>(smem);
  T* coef = cs + NCONST;
  T* wp = coef + 4 * NCHAN * nk;
  T* sk = wp + 3 * nk;
  for (int i = threadIdx.x; i < NCONST; i += K6_THREADS) cs[i] = g.consts[i];
#pragma unroll
  for (int k = 0; k < 4 * NCHAN; ++k)
    for (int i = threadIdx.x; i < nk; i += K6_THREADS)
      coef[k * nk + i] = g.coef[k][i];
  for (int i = threadIdx.x; i < 3 * nk; i += K6_THREADS) wp[i] = g.wp[i];
  for (int i = threadIdx.x; i < nk; i += K6_THREADS) sk[i] = g.s_knots[i];
  __syncthreads();
  const int t = blockIdx.x * K6_THREADS + threadIdx.x;
  if (t >= g.n) return;
  T delta[NCHAN], clen[NCHAN];
#pragma unroll
  for (int ch = 0; ch < NCHAN; ++ch) {
    delta[ch] = *g.scal[2 * ch];
    clen[ch] = *g.scal[2 * ch + 1];
  }
  const T length = *g.scal[2 * NCHAN];
  const T max_dist = *g.scal[2 * NCHAN + 1];
  const T* x = g.x0 + static_cast<size_t>(t) * g.x_stride;
  const T* u = g.u0 + static_cast<size_t>(t) * g.u_stride;
  auto eval = [&](int ch, T s, T* val, T* der, T* sec) {
    const T* cf = coef + 4 * ch * nk;
    spline_eval(cf, cf + nk, cf + 2 * nk, cf + 3 * nk, delta[ch], clen[ch],
                nk, s, val, der, sec);
  };

  // ---- 1. FK: the EE position and Jv, column j the EE's velocity a unit
  // of dq_j, rounded as the plain route rounds them: cross(axes, p_ee -
  // origins) for the Panda; `kinematics_mobile.ee_jacobian`'s world-frame
  // columns for the Husky+Panda (the base rotation R_b a `dot3_chain`)
  T org[ARM][3], ax[ARM][3], pa[3], ra[9];
  fk_arm<true>(x + BASE_DOF, cs, org, ax, pa, ra);
  T ee[3], jv[DOF][3];
  if constexpr (BASE_DOF == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) ee[a] = pa[a];
#pragma unroll
    for (int j = 0; j < ARM; ++j) {
      T rel[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) rel[a] = sub_rn(ee[a], org[j][a]);
      cross3_plain(ax[j], rel, jv[j]);
    }
  } else {
    T cb, sb;
    sin_cos(x[2], &sb, &cb);
    // R_b v, R_b = [[c, -s, 0], [s, c, 0], e_z]
    auto rot = [cb, sb](const T v[3], T out[3]) {
      out[0] = fma_rn(v[1], -sb, mul_rn(v[0], cb));
      out[1] = fma_rn(v[1], cb, mul_rn(v[0], sb));
      out[2] = v[2];
    };
    const T pb[3] = {x[0], x[1], T(0)};
    T pr[3];
    rot(pa, pr);
#pragma unroll
    for (int a = 0; a < 3; ++a) ee[a] = add_rn(pb[a], pr[a]);
    // base columns: prismatic x, prismatic y, e_z x (p_ee - p_b)
    const T d0 = sub_rn(ee[0], pb[0]), d1 = sub_rn(ee[1], pb[1]);
    const T jvb[3][3] = {{1, 0, 0}, {0, 1, 0}, {-d1, d0, 0}};
#pragma unroll
    for (int j = 0; j < BASE_DOF; ++j)
#pragma unroll
      for (int a = 0; a < 3; ++a) jv[j][a] = jvb[j][a];
#pragma unroll
    for (int j = 0; j < ARM; ++j) {
      T ow[3], aw[3], rel[3];
      rot(org[j], ow);
      rot(ax[j], aw);
#pragma unroll
      for (int a = 0; a < 3; ++a) rel[a] = sub_rn(ee[a], add_rn(pb[a], ow[a]));
      cross3_plain(aw, rel, jv[BASE_DOF + j]);
    }
  }

  // ---- 2. the distance to p(s_guess); past max_dist_proj, restart from
  // the nearest waypoint within max_dist_proj of s_guess in s (the
  // nearest of all where none is)
  const T s_guess = x[DOF];
  T e[3];
#pragma unroll
  for (int ch = 0; ch < NCHAN; ++ch) {
    T p0, unused0, unused1;
    eval(ch, s_guess, &p0, &unused0, &unused1);
    e[ch] = sub_rn(ee[ch], p0);
  }
  const T dist0 = sqrt(sum3(mul_rn(e[0], e[0]), mul_rn(e[1], e[1]),
                            mul_rn(e[2], e[2])));
  T s_opt0 = s_guess;
  if (dist0 >= max_dist) {
    const T inf = T(1) / T(0);
    int k_all = 0, k_near = 0;
    T d_all = inf, d_near = inf;
    bool any_near = false;
    for (int k = 0; k < nk; ++k) {
      const T w0 = sub_rn(wp[3 * k], ee[0]);
      const T w1 = sub_rn(wp[3 * k + 1], ee[1]);
      const T w2 = sub_rn(wp[3 * k + 2], ee[2]);
      const T d2 = sum3(mul_rn(w0, w0), mul_rn(w1, w1), mul_rn(w2, w2));
      const bool near = fabs(sub_rn(sk[k], s_guess)) <= max_dist;
      const T masked = near ? d2 : inf;
      any_near |= near;
      if (k == 0 || before(d2, d_all)) { d_all = d2; k_all = k; }
      if (k == 0 || before(masked, d_near)) { d_near = masked; k_near = k; }
    }
    s_opt0 = sk[any_near ? k_near : k_all];
  }

  // ---- 3. Newton on ||p(s) - ee||^2 from s_opt0, clamped to [0, length];
  // the first step within 1e-5 is the result, the guess where none is; a
  // restart at the track's end returns the end
  T s_proj = s_guess;
  if (s_opt0 >= length) {
    s_proj = length;
  } else {
    T s_cur = s_opt0;
    for (int it = 0; it < NEWTON_STEPS; ++it) {
      T p[3], dp[3], ddp[3], df[3];
#pragma unroll
      for (int ch = 0; ch < NCHAN; ++ch) {
        eval(ch, s_cur, &p[ch], &dp[ch], &ddp[ch]);
        df[ch] = sub_rn(p[ch], ee[ch]);
      }
      const T jac = mul_rn(T(2), sum3(mul_rn(df[0], dp[0]),
                                      mul_rn(df[1], dp[1]),
                                      mul_rn(df[2], dp[2])));
      const T hess = add_rn(
          mul_rn(T(2), sum3(mul_rn(dp[0], dp[0]), mul_rn(dp[1], dp[1]),
                            mul_rn(dp[2], dp[2]))),
          mul_rn(T(2), sum3(mul_rn(df[0], ddp[0]), mul_rn(df[1], ddp[1]),
                            mul_rn(df[2], ddp[2]))));
      const T s_new = clamp_s(sub_rn(s_cur, jac / hess), length);
      if (fabs(sub_rn(s_cur, s_new)) <= T(1e-5)) {
        s_proj = s_new;
        break;
      }
      s_cur = s_new;
    }
  }

  // ---- 4. vs = ((dq_j Jv_j summed over j) . t(s_proj))
  T w[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T prod[DOF];
#pragma unroll
    for (int j = 0; j < DOF; ++j) prod[j] = mul_rn(u[j], jv[j][a]);
    w[a] = sum_acc4<DOF>(prod);
  }
  T tan[3];
#pragma unroll
  for (int ch = 0; ch < NCHAN; ++ch) {
    T unused0, unused1;
    eval(ch, s_proj, &unused0, &tan[ch], &unused1);
  }
  const T vs = sum3(mul_rn(w[0], tan[0]), mul_rn(w[1], tan[1]),
                    mul_rn(w[2], tan[2]));

  T* xo = g.x0_out + static_cast<size_t>(t) * NX;
#pragma unroll
  for (int k = 0; k < DOF; ++k) xo[k] = x[k];
  xo[DOF] = s_proj;
  xo[DOF + 1] = vs;
  g.s_out[t] = s_proj;
}

template <typename T>
size_t proj_smem_bytes(int nk) {
  return sizeof(T) * (NCONST + 16 * static_cast<size_t>(nk));
}

template <int BASE_DOF, typename T>
int proj_launch(const void* x0, int x_stride, const void* u0, int u_stride,
                const void* consts, const void* const* tables, int n, int nk,
                void* x0_out, void* s_out, cudaStream_t st) {
  ProjArgs<T> g;
  g.x0 = static_cast<const T*>(x0);
  g.u0 = static_cast<const T*>(u0);
  g.consts = static_cast<const T*>(consts);
  for (int k = 0; k < 4 * NCHAN; ++k) g.coef[k] = static_cast<const T*>(tables[k]);
  g.wp = static_cast<const T*>(tables[4 * NCHAN]);
  g.s_knots = static_cast<const T*>(tables[4 * NCHAN + 1]);
  for (int k = 0; k < 2 * NCHAN + 2; ++k)
    g.scal[k] = static_cast<const T*>(tables[4 * NCHAN + 2 + k]);
  g.x0_out = static_cast<T*>(x0_out);
  g.s_out = static_cast<T*>(s_out);
  g.n = n;
  g.nk = nk;
  g.x_stride = x_stride;
  g.u_stride = u_stride;
  const int blocks = (n + K6_THREADS - 1) / K6_THREADS;
  proj_kernel<BASE_DOF, T><<<blocks, K6_THREADS, proj_smem_bytes<T>(nk), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <int BASE_DOF, typename T>
int proj_launch_config(int n, int nk, int* out) {
  const auto fn = proj_kernel<BASE_DOF, T>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, dev = 0, sms = 0;
  const size_t smem = proj_smem_bytes<T>(nk);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      K6_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = K6_THREADS;
  out[1] = (n + K6_THREADS - 1) / K6_THREADS;
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  out[6] = sms;
  return 0;
}

}  // namespace

// system: the base_dof of the system's instantiation (0 Panda, 3
// Husky+Panda).  Returns the cudaError_t of the launch.
extern "C" int mpcc_kin_sweep(const float* q, const float* consts, int n,
                              int system, float* pe, float* re, float* jv,
                              float* jw, float* m, float* dm, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + K4_THREADS - 1) / K4_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0)
    kin_kernel<0><<<blocks, K4_THREADS, 0, st>>>(q, consts, n, pe, re, jv,
                                                 jw, m, dm);
  else if (system == 3)
    kin_kernel<3><<<blocks, K4_THREADS, 0, st>>>(q, consts, n, pe, re, jv,
                                                 jw, m, dm);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// How K4 launches for `system` at n configurations: out[8] = {threads a
// block, configurations a block, blocks, shared bytes a block, blocks an
// SM holds at once, registers a thread, local-memory (stack and spill)
// bytes a thread, SMs on the card}.  Returns a cudaError_t.
extern "C" int mpcc_kin_launch_config(int system, int n, int* out) {
  if (system == 0) return launch_config<0>(n, out);
  if (system == 3) return launch_config<3>(n, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6 for `system` (0 Panda, 3 Husky+Panda) in `dtype` (0 float32, 1
// float64): n lanes of x0 and u0 (rows x_stride / u_stride elements
// apart), nk knots; `tables` the 22 device pointers of ProjArgs's coef, wp,
// s_knots and scal in that order; x0_out (n, nx) contiguous.  Returns the
// cudaError_t of the launch.
extern "C" int mpcc_project_vs(const void* x0, int x_stride, const void* u0,
                               int u_stride, const void* consts,
                               const void* const* tables, int n, int nk,
                               int system, int dtype, void* x0_out,
                               void* s_out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0 && dtype == 0)
    return proj_launch<0, float>(x0, x_stride, u0, u_stride, consts, tables,
                                 n, nk, x0_out, s_out, st);
  if (system == 0 && dtype == 1)
    return proj_launch<0, double>(x0, x_stride, u0, u_stride, consts, tables,
                                  n, nk, x0_out, s_out, st);
  if (system == 3 && dtype == 0)
    return proj_launch<3, float>(x0, x_stride, u0, u_stride, consts, tables,
                                 n, nk, x0_out, s_out, st);
  if (system == 3 && dtype == 1)
    return proj_launch<3, double>(x0, x_stride, u0, u_stride, consts, tables,
                                  n, nk, x0_out, s_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How K6 launches: out[7] = {threads a block, blocks, dynamic shared bytes
// a block, blocks an SM holds at once, registers a thread, local-memory
// bytes a thread, SMs on the card}.  Returns a cudaError_t.
extern "C" int mpcc_proj_launch_config(int system, int dtype, int n, int nk,
                                       int* out) {
  if (system == 0 && dtype == 0) return proj_launch_config<0, float>(n, nk, out);
  if (system == 0 && dtype == 1) return proj_launch_config<0, double>(n, nk, out);
  if (system == 3 && dtype == 0) return proj_launch_config<3, float>(n, nk, out);
  if (system == 3 && dtype == 1) return proj_launch_config<3, double>(n, nk, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mpcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
