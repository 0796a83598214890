// K4: kinematics sweep -- FK, point Jacobian, manipulability and its
// analytic gradient -- for every (scenario, knot) of a tick, for the Panda
// and the Husky+Panda mobile manipulator.
//
// Replaces the TPU kernel `_kin_kernel` in
// mpcc_manipulator_tpu/ops/pallas_kinematics.py (entry `kin_sweep`), both
// of its branches: the fixed base, and the planar base (`base_dof != 0`).
//
// What bounds it on the H100: arithmetic latency per configuration.  Each
// (scenario, knot) reads 7 (10) floats and writes 67 (85), and does ~2k
// flops of tiny 3-vector / 3x3 / 6x6 work with no reuse across
// configurations, so the sweep is neither bandwidth- nor FLOP-bound at 11k
// configurations; what matters is that nothing serialises.
//
// Design: one thread per (scenario, knot) -- 1024 x 11 = 11,264 threads at
// the bench shape -- with the whole chain held in registers (full unroll).
// The TPU kernel's scenarios-in-lanes layout was a Mosaic constraint, not
// part of the algorithm.  The joint offset tables arrive as one 96-float
// buffer written by `models/kinematics.py::kinematics_constants` (so the
// constants exist once, in Python) and are staged into shared memory per
// block.  The dJ/dq tensor is never materialised: each dJ_i column is
// contracted with (A^-1 J) as it is formed, as the TPU kernel does.
//
// The planar base is the compile-time BASE_DOF (0 or 3) of one kernel body.
// With a base, the arm's quantities are composed with R_b = R_z(th) and
// (x_b, y_b, 0): p = R_b p_arm + (x_b, y_b, 0), R = R_b R_arm; jv gains the
// base columns e_x, e_y and (-(R_b p_arm)_y, (R_b p_arm)_x, 0), jw the
// columns 0, 0 and e_z; the arm columns are rotated by R_b.  The
// manipulability is the arm's (rotation-invariant), with a zero gradient
// on the base columns.
//
// Layouts (row-major, batch-first): q (n, dof) -> p (n, 3), R (n, 3, 3),
// jv (n, 3, dof), jw (n, 3, dof), m (n), dm (n, dof), n = batch * knots,
// dof = BASE_DOF + 7.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int ARM = 7;
constexpr int NCONST = 7 * 9 + 7 * 3 + 9 + 3;   // R_off | p_off | R_post | p_post

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <int BASE_DOF>
__global__ void kin_kernel(const float* __restrict__ q,
                           const float* __restrict__ consts, int n,
                           float* __restrict__ pe_out,
                           float* __restrict__ re_out,
                           float* __restrict__ jv_out,
                           float* __restrict__ jw_out,
                           float* __restrict__ m_out,
                           float* __restrict__ dm_out) {
  __shared__ float c[NCONST];
  for (int i = threadIdx.x; i < NCONST; i += blockDim.x) c[i] = consts[i];
  __syncthreads();
  constexpr int DOF = BASE_DOF + ARM;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float* r_off = c;
  const float* p_off = c + 63;
  const float* r_post = c + 84;
  const float* p_post = c + 93;

  // ---- FK chain: p += R p_off[i]; R_fixed = R R_off[i]; R = R_fixed Rz(q_i)
  float r[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float p[3] = {0.f, 0.f, 0.f};
  float org[ARM][3], ax[ARM][3];
#pragma unroll
  for (int i = 0; i < ARM; ++i) {
    float pv[3], rf[9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pv[a] = r[3 * a] * p_off[3 * i] + r[3 * a + 1] * p_off[3 * i + 1]
              + r[3 * a + 2] * p_off[3 * i + 2];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        rf[3 * a + b] = r[3 * a] * r_off[9 * i + b]
                        + r[3 * a + 1] * r_off[9 * i + 3 + b]
                        + r[3 * a + 2] * r_off[9 * i + 6 + b];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      p[a] += pv[a];
      org[i][a] = p[a];
      ax[i][a] = rf[3 * a + 2];
    }
    float cq, sq;
    sincosf(q[(size_t)t * DOF + BASE_DOF + i], &sq, &cq);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r[3 * a] = rf[3 * a] * cq + rf[3 * a + 1] * sq;
      r[3 * a + 1] = -rf[3 * a] * sq + rf[3 * a + 1] * cq;
      r[3 * a + 2] = rf[3 * a + 2];
    }
  }
  float p_ee[3], r_ee[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p_ee[a] = p[a] + r[3 * a] * p_post[0] + r[3 * a + 1] * p_post[1]
              + r[3 * a + 2] * p_post[2];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      r_ee[3 * a + b] = r[3 * a] * r_post[b] + r[3 * a + 1] * r_post[3 + b]
                        + r[3 * a + 2] * r_post[6 + b];
  }

  // ---- arm Jacobian columns J_j = [z_j x (p_e - p_j); z_j], arm frame
  float rel[ARM][3], jvc[ARM][3];
#pragma unroll
  for (int j = 0; j < ARM; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a) rel[j][a] = p_ee[a] - org[j][a];
    cross3(ax[j], rel[j], jvc[j]);
  }

  // ---- outputs: the arm's, or composed with the planar base
  float* pe = pe_out + (size_t)t * 3;
  float* re = re_out + (size_t)t * 9;
  float* jv = jv_out + (size_t)t * 3 * DOF;
  float* jw = jw_out + (size_t)t * 3 * DOF;
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

  // ---- A = J J' (6x6)
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

  // ---- manipulability sqrt(det A): clamped-pivot elimination
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
  const float mani = sqrtf(fmaxf(det, 0.f));
  m_out[t] = mani;

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

  // ---- dm_i = m * sum_j dJ_i[:, j] . (A^-1 J)[:, j]
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
  float* dmo = dm_out + (size_t)t * DOF;
#pragma unroll
  for (int i = 0; i < BASE_DOF; ++i) dmo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < ARM; ++i) dmo[BASE_DOF + i] = mani * dm[i];
}

}  // namespace

// system: the base_dof of the system's instantiation (0 Panda, 3
// Husky+Panda).  Returns the cudaError_t of the launch.
extern "C" int mpcc_kin_sweep(const float* q, const float* consts, int n,
                              int system, float* pe, float* re, float* jv,
                              float* jw, float* m, float* dm, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0)
    kin_kernel<0><<<blocks, threads, 0, st>>>(q, consts, n, pe, re, jv, jw,
                                              m, dm);
  else if (system == 3)
    kin_kernel<3><<<blocks, threads, 0, st>>>(q, consts, n, pe, re, jv, jw,
                                              m, dm);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mpcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
