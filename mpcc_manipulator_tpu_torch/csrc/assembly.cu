// K2: the stage-QP assembly of one SQP iteration -- every StageQPK block
// that depends on the scenario -- and K3: the line-search evaluation, the
// total objective and the l1 violation of every constraint row at an
// iterate.  The two kernels share one set of device helpers (track spline
// and SO(3) reference, Rodrigues exponential, rotation log, right-Jacobian
// inverse, RBF barrier, scheduled weights, dynamics prediction).
//
// Replaces the TPU kernels `_assembly_kernel` and `_eval_kernel` in
// mpcc_manipulator_tpu/ops/pallas_assembly.py (entries
// `build_qp_stages_k_pallas` -> `_build_batched` and `eval_point_pallas` ->
// `_eval_batched`).  Semantics: `build_qp_stages_k` of ocp/qp_stages.py and
// `total_objective` + `constraint_values` + `constraint_norm` of
// ocp/qp_data.py in this package (the plain versions).
//
// Both are instantiated per system from one source: the dims struct
// Dims<BASE_DOF> (the Panda, BASE_DOF = 0: nx 9, nu 8, dof 7; the
// Husky+Panda, BASE_DOF = 3: nx 12, nu 11, dof 10; 9 env links either way)
// derives every size and table offset; the C entries take the system as
// their first int argument.
//
// What bounds them on the H100: bytes for K2.  Each non-terminal Panda knot
// writes 424 floats (hxx 81, huu 64, cpx 99, cpu 88 and the vectors), the
// terminal knot 90 (hxx and gx): ~17.7 MB out at batch 1024 and N = 10,
// against ~7 MB in (~159 floats per knot); a Husky+Panda knot writes 640
// (hxx 144, huu 121, cpx 132, cpu 121 and the vectors).  The arithmetic
// (~3k flops per knot of 3-vector and 3x3 work, one atan2, a few
// sin/cos/log) is small beside that.  K3 writes two floats per candidate and reads ~110 per knot:
// it is latency-bound on its knot loop.
//
// Design: K2 runs one thread per (scenario, knot), over B x (N+1) threads.
// Knots are independent (knot k reads u_{k-1}, or the current input at k=0),
// the thread reads the batch-first z and RobotData directly and writes
// straight into the StageQPK tensors that K1 reads.  The 9x9 Gauss-Newton
// Hessian is never held: the three 3 x nx Jacobian stacks (contouring, lag,
// heading log) stay in registers and each hxx entry is written as it is
// formed.  The writes are strided across threads (81 floats apart for hxx);
// staging them through shared memory is later work.  K3 runs one thread per
// (scenario, candidate), looping over the N+1 knots in the TPU kernel's
// order; the candidates of one scenario read its one RobotData.  The spline
// gather is an indexed load of the segment's row (the TPU kernel's one-hot
// MXU contraction was a Mosaic workaround), the rotation log uses atan2 (the
// TPU kernel's series + Newton arccos stood in for Mosaic's missing inverse
// trig).  Every max / min / clamp propagates NaN as jnp.maximum and
// torch.clamp do, so a NaN iterate reaches the blocks the SQP's NaN guard
// reads and the values its filter compares; where the plain version
// multiplies a structural zero into a NaN (the dense Ad/Bd product, the
// zero vs column of the error Jacobians) the kernel does too.
//
// Layouts (row-major, batch-first, K = N+1 knots, n_var = nx K + nu N; the
// Panda's sizes nx 9, nu 8, dof 7):
//   z (B, n_var) [K2] or (B, A, n_var) [K3], cu (B, nu), ee_pos (B,K,3),
//   ee_rot (B,K,3,3), jv/jw (B,K,3,dof), mani (B,K), dmani (B,K,dof),
//   sel (B,K), dsel (B,K,dof), env (B,K,9), denv (B,K,9,dof), radius (B),
//   tables: see `table_len` (ops/assembly_kernel.py::pack_tables)
//   K2 -> hxx (B,K,nx,nx) huu (B,N,nu,nu) gx (B,K,nx) gu (B,N,nu)
//         gxu (B,N,dof) e (B,N,nx) d_xu/d_xl (B,N,nx) d_uu/d_ul (B,N,nu)
//         d_ru/d_rl (B,N,dof) d_p (B,N,11) cpx (B,N,11,nx) cpu (B,N,11,nu)
//   K3 -> obj, vio (B, A)

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1e-8f;          // so3._EPS
constexpr float RBF_DELTA = -0.5f;
constexpr float PI_F = 3.14159265358979323846f;

// scalar slots, in ops/assembly_kernel.py::SC_KEYS order
enum Sc {
  SC_DELTA, SC_LENGTH, SC_AX_LAST, SC_AY_LAST, SC_AZ_LAST, SC_R_LAST,
  SC_Q_C = SC_R_LAST + 9, SC_Q_C_N_MULT, SC_Q_L, SC_Q_VS, SC_Q_ORI,
  SC_Q_SING, SC_R_DQ, SC_R_DVS, SC_Q_C_RED, SC_Q_L_INC, SC_Q_ORI_RED,
  SC_TOL_SELCOL, SC_TOL_SING, SC_TOL_ENVCOL, SC_V_DES, SC_DEACC, SC_S_TRUST,
  SC_R_DDQ, N_SC
};
constexpr int P_ROW = 12, R_ROW = 14;   // position / rotation table rows

// One system's dims: a planar base of BASE_DOF joints (0 or 3) under the
// 7-joint arm, 9 env-collision links; the table layout after the scalars.
template <int BASE_DOF>
struct Dims {
  static constexpr int DOF = BASE_DOF + 7, NX = DOF + 2, NU = DOF + 1;
  static constexpr int NL = 9, NPC = 2 + NL;
  static constexpr int S_IDX = DOF, VS_IDX = DOF + 1, DVS_IDX = DOF;
  static constexpr int T_TX = N_SC, T_TU = T_TX + NX, T_XL = T_TU + NU,
                       T_XU = T_XL + NX, T_UL = T_XU + NX, T_UU = T_UL + NU,
                       T_DDQL = T_UU + NU, T_DDQU = T_DDQL + DOF,
                       T_AD = T_DDQU + DOF, T_BD = T_AD + NX * NX,
                       T_PTBL = T_BD + NX * NU;
  static constexpr int table_len(int nseg) {
    return T_PTBL + nseg * P_ROW + (nseg - 1) * R_ROW;
  }
};
using Panda = Dims<0>;
using HuskyPanda = Dims<3>;

// NaN-propagating min / max / clamp (jnp.minimum, jnp.maximum, jnp.clip and
// torch.clamp semantics; fminf / fmaxf would drop the NaN)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nclamp(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

__device__ __forceinline__ float rbf(float h) {
  const float above = -logf(nmax(h, RBF_DELTA) + 1.f);
  const float d = h - RBF_DELTA, a1 = RBF_DELTA + 1.f;
  const float below = -logf(a1) - d / a1 + d * d / (2.f * a1 * a1);
  return h >= RBF_DELTA ? above : below;
}

__device__ __forceinline__ float drbf(float h) {
  const float above = -1.f / (nmax(h, RBF_DELTA) + 1.f);
  const float a1 = RBF_DELTA + 1.f;
  const float below = -1.f / a1 + (h - RBF_DELTA) / (a1 * a1);
  return h >= RBF_DELTA ? above : below;
}

// Rodrigues exponential, (3) -> row-major 3x3 (utils/so3.py::exp_rot)
__device__ void exp_rot(const float w[3], float e[9]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(th2);
  const bool small = th < EPS;
  const float st = small ? 1.f : th;
  const float a = small ? 1.f - th2 / 6.f : sinf(st) / st;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(st)) / (st * st);
  // E = I + a K + b K^2, K^2 = w w' - th^2 I
  e[0] = 1.f + b * (w[0] * w[0] - th2);
  e[4] = 1.f + b * (w[1] * w[1] - th2);
  e[8] = 1.f + b * (w[2] * w[2] - th2);
  e[1] = -a * w[2] + b * w[0] * w[1];
  e[2] = a * w[1] + b * w[0] * w[2];
  e[3] = a * w[2] + b * w[1] * w[0];
  e[5] = -a * w[0] + b * w[1] * w[2];
  e[6] = -a * w[1] + b * w[2] * w[0];
  e[7] = a * w[0] + b * w[2] * w[1];
}

// Rotation log as a rotation vector (utils/so3.py::log_rot_vec): identity
// branch (th < 1e-6), generic branch, near-pi branch (pi - th < 1e-4) with
// the axis from the diagonal and the signs from the argmax row.
__device__ void log_rot_vec(const float r[9], float out[3]) {
  const float tr = r[0] + r[4] + r[8];
  const float c = nclamp((tr - 1.f) * 0.5f, -1.f, 1.f);
  const float th = atan2f(sqrtf(nmax(1.f - c * c, 0.f)), c);
  const float sn = sinf(th);
  const float f = 0.5f * th / (fabsf(sn) < EPS ? 1.f : sn);
  const float v[3] = {r[7] - r[5], r[2] - r[6], r[3] - r[1]};
  if (PI_F - th < 1e-4f) {
    float ax[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ax[i] = sqrtf(nmax((r[4 * i] + 1.f) * 0.5f, 0.f));
    const int k = (ax[0] >= ax[1] && ax[0] >= ax[2]) ? 0
                  : (ax[1] >= ax[2] ? 1 : 2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ck = (r[3 * k + i] + r[3 * i + k]) * 0.5f;
      // torch.sign: NaN stays NaN; a zero sign counts as +1
      const float sg = i == k ? 1.f
                       : ck != ck ? ck
                       : ck < 0.f ? -1.f : 1.f;
      ax[i] *= sg;
    }
    const float an = nmax(sqrtf(ax[0] * ax[0] + ax[1] * ax[1]
                                + ax[2] * ax[2]), EPS);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = ax[i] / an * th;
  } else if (th < 1e-6f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = 0.5f * v[i];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = f * v[i];
  }
}

// Right-Jacobian inverse (utils/so3.py::_jr_inv_with_coef); sign -1 is the
// exact formula, +1 the reference's variant.
__device__ void jr_inv(const float p[3], float sign, float j[9]) {
  const float n2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  const float n = sqrtf(n2);
  const bool small = n < EPS;
  const float sn_ = small ? 1.f : n, sn2 = small ? 1.f : n2;
  const float s = sinf(sn_);
  const float ss = fabsf(s) < EPS ? 1.f : s;
  const float coef = 1.f / sn2 + sign * (1.f + cosf(sn_)) / (2.f * sn_ * ss);
  const float kk[9] = {0.f, -p[2], p[1], p[2], 0.f, -p[0], -p[1], p[0], 0.f};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float v = coef * (p[a] * p[b]);
      v += a == b ? 1.f - coef * n2 : 0.5f * kk[3 * a + b];
      j[3 * a + b] = small ? (a == b ? 1.f : 0.f) : v;
    }
}

// Track at arc length s (splines/cubic.py, splines/rotation.py): position,
// tangent, normal, reference rotation and its angular-velocity derivative;
// the segment index floor(clamp(s_c / delta, 0, nseg-2)), s_c = clamp(s, 0,
// L); at s_c >= L the last knot's position and rotation, zero derivatives.
struct TrackPoint {
  float p[3], t[3], n[3], r[9], dr[3];
};

// (ptbl: the system's offset of the position table)
__device__ void track_eval(const float* __restrict__ tb, int ptbl, int nseg,
                           float s, TrackPoint& o) {
  const float delta = tb[SC_DELTA], len = tb[SC_LENGTH];
  const float s_c = nclamp(s, 0.f, len);
  const float segf = floorf(nclamp(s_c / delta, 0.f, (float)(nseg - 2)));
  const int seg = segf == segf ? (int)segf : 0;
  const float dx = s_c - (float)seg * delta;
  const bool at_end = s_c >= len;
  const float* pc = tb + ptbl + seg * P_ROW;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float a = pc[4 * ch], b = pc[4 * ch + 1], c = pc[4 * ch + 2],
                d = pc[4 * ch + 3];
    const float val = a + b * dx + c * dx * dx + d * dx * dx * dx;
    const float der = b + 2.f * c * dx + 3.f * d * dx * dx;
    const float sec = 2.f * c + 6.f * d * dx;
    o.p[ch] = at_end ? tb[SC_AX_LAST + ch] : val;
    o.t[ch] = at_end ? 0.f : der;
    o.n[ch] = at_end ? 0.f : sec;
  }
  const float* rc = tb + ptbl + nseg * P_ROW + seg * R_ROW;
  const float cc = rc[12], dd = rc[13];
  const float blend = cc * dx * dx + dd * dx * dx * dx;
  const float dblend = 2.f * cc * dx + 3.f * dd * dx * dx;
  float w[3], e[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = rc[9 + i] * blend;
  exp_rot(w, e);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b)
      o.r[3 * a + b] = at_end ? tb[SC_R_LAST + 3 * a + b]
                              : rc[3 * a] * e[b] + rc[3 * a + 1] * e[3 + b]
                                    + rc[3 * a + 2] * e[6 + b];
    o.dr[a] = at_end ? 0.f : rc[9 + a] * dblend;
  }
}

// Proximity-triggered weights (ocp/cost.py::scheduled_weights)
__device__ void sched_weights(const float* __restrict__ tb, float sel,
                              float mani, float& qc, float& ql, float& qo) {
  const float ratio = nmin(sel / (tb[SC_TOL_SELCOL] * 2.f),
                           mani / (tb[SC_TOL_SING] * 2.f));
  const float t = (ratio - 0.5f) / 0.5f;
  const float bl = 3.f * t * t - 2.f * t * t * t;
  const bool near = ratio <= 1.f;
  const float rc = tb[SC_Q_C_RED], rl = tb[SC_Q_L_INC], ro = tb[SC_Q_ORI_RED];
  qc = near ? tb[SC_Q_C] * (rc + (1.f - rc) * bl) : tb[SC_Q_C];
  ql = near ? tb[SC_Q_L] * (rl + (1.f - rl) * bl) : tb[SC_Q_L];
  qo = near ? tb[SC_Q_ORI] * (ro + (1.f - ro) * bl) : tb[SC_Q_ORI];
}

// Desired path speed with the terminal taper, on the raw s
__device__ __forceinline__ float desired_velocity(const float* tb, float s) {
  const float len = tb[SC_LENGTH], v0 = tb[SC_V_DES], dr = tb[SC_DEACC];
  const float taper = -v0 / (len * dr) * (s - len);
  return s < len * dr ? v0 : taper;
}

// Ad x + Bd u as the plain version's dense product (a NaN anywhere in x or
// u reaches every row, as it does there)
template <class D>
__device__ void dyn_pred(const float* __restrict__ tb, const float x[D::NX],
                         const float u[D::NU], float pred[D::NX]) {
  constexpr int NX = D::NX, NU = D::NU;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) a += tb[D::T_AD + NX * i + j] * x[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) b += tb[D::T_BD + NU * i + j] * u[j];
    pred[i] = a + b;
  }
}

// The RBF polytopic rows' heights h and (scaled) gradients d at one knot:
// row 0 self-collision, row 1 singularity, rows 2.. env collision.
struct Robot {
  const float *ee_pos, *ee_rot, *jv, *jw, *mani, *dmani, *sel, *dsel, *env,
      *denv, *radius;
};

template <class D>
__device__ __forceinline__ float poly_h(const float* tb, const Robot& rb,
                                        size_t bk, int b, int row) {
  if (row == 0) return 0.01f * rb.sel[bk] - 0.01f * tb[SC_TOL_SELCOL];
  if (row == 1) return rb.mani[bk] - tb[SC_TOL_SING];
  return 0.01f * (rb.env[bk * D::NL + row - 2] - 1.2f * rb.radius[b])
         - 0.01f * tb[SC_TOL_ENVCOL];
}

template <class D>
__device__ __forceinline__ float poly_d(const Robot& rb, size_t bk, int row,
                                        int j) {
  if (row == 0) return 0.01f * rb.dsel[bk * D::DOF + j];
  if (row == 1) return rb.dmani[bk * D::DOF + j];
  return 0.01f * rb.denv[(bk * D::NL + row - 2) * D::DOF + j];
}

struct AsmOut {
  float *hxx, *huu, *gx, *gu, *gxu, *e, *dxu, *dxl, *duu, *dul, *dru, *drl,
      *dp, *cpx, *cpu;
};

template <class D>
__global__ void __launch_bounds__(128)
assembly_kernel(const float* __restrict__ z, const float* __restrict__ cu,
                Robot rb, const float* __restrict__ tb, AsmOut out,
                int batch, int n_h, int nseg, float ts, float jr_sign) {
  constexpr int NX = D::NX, NU = D::NU, DOF = D::DOF, NPC = D::NPC;
  constexpr int S_IDX = D::S_IDX, VS_IDX = D::VS_IDX, DVS_IDX = D::DVS_IDX;
  const int nk = n_h + 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * nk) return;
  const int b = t / nk, k = t - b * nk;
  const bool term = k == n_h;
  const size_t bk = (size_t)b * nk + k;
  const float* zb = z + (size_t)b * (NX * nk + NU * n_h);
  const float* us = zb + NX * nk;
  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = zb[NX * k + i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = term ? 0.f : us[NU * k + i];

  TrackPoint tp;
  track_eval(tb, D::T_PTBL, nseg, x[S_IDX], tp);

  // ---- heading: log(R_ref' R_cur), d_log = Jr^-1 R_cur' [jw | -dr_ref]
  const float* rc = rb.ee_rot + bk * 9;
  float rbar[9], lg[3], jri[9], m1[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rbar[3 * i + j] = tp.r[i] * rc[j] + tp.r[3 + i] * rc[3 + j]
                        + tp.r[6 + i] * rc[6 + j];
  log_rot_vec(rbar, lg);
  jr_inv(lg, jr_sign, jri);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      m1[3 * i + j] = jri[3 * i] * rc[3 * j] + jri[3 * i + 1] * rc[3 * j + 1]
                      + jri[3 * i + 2] * rc[3 * j + 2];

  // ---- contouring / lag errors and the three 3 x nx Jacobian stacks
  const float* pe = rb.ee_pos + bk * 3;
  const float* jv = rb.jv + bk * 3 * DOF;
  const float* jw = rb.jw + bk * 3 * DOF;
  float et[3], lag[3], cont[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) et[i] = pe[i] - tp.p[i];
  const float te = tp.t[0] * et[0] + tp.t[1] * et[1] + tp.t[2] * et[2];
  const float tt = tp.t[0] * tp.t[0] + tp.t[1] * tp.t[1] + tp.t[2] * tp.t[2];
  const float en = et[0] * tp.n[0] + et[1] * tp.n[1] + et[2] * tp.n[2];
  // the plain version forms d_lag as (t t') d_total + (t e' + te I) d_t,
  // so a non-finite t or e reaches every column, the zero ones included
  const float pz = 0.f * (tp.t[0] + tp.t[1] + tp.t[2] + et[0] + et[1]
                          + et[2] + te);
  float dc[3][NX], dl[3][NX], dg[3][NX];
  float tjv[DOF];
#pragma unroll
  for (int j = 0; j < DOF; ++j)
    tjv[j] = tp.t[0] * jv[j] + tp.t[1] * jv[DOF + j]
             + tp.t[2] * jv[2 * DOF + j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lag[i] = tp.t[i] * te;
    cont[i] = et[i] - lag[i];
#pragma unroll
    for (int j = 0; j < DOF; ++j) {
      dl[i][j] = tp.t[i] * tjv[j] + pz;
      dc[i][j] = jv[i * DOF + j] - dl[i][j];
      dg[i][j] = m1[3 * i] * jw[j] + m1[3 * i + 1] * jw[DOF + j]
                 + m1[3 * i + 2] * jw[2 * DOF + j];
    }
    dl[i][S_IDX] = -tp.t[i] * tt + tp.t[i] * en + tp.n[i] * te + pz;
    dc[i][S_IDX] = -tp.t[i] - dl[i][S_IDX];
    dg[i][S_IDX] = -(m1[3 * i] * tp.dr[0] + m1[3 * i + 1] * tp.dr[1]
                     + m1[3 * i + 2] * tp.dr[2]);
    dl[i][VS_IDX] = pz;
    dc[i][VS_IDX] = 0.f - pz;
    dg[i][VS_IDX] = 0.f;
  }

  // ---- scheduled weights, desired velocity
  float qc, ql, qo;
  sched_weights(tb, rb.sel[bk], rb.mani[bk], qc, ql, qo);
  const float qck = term ? tb[SC_Q_C_N_MULT] * qc : qc;
  const float dv = x[VS_IDX] - desired_velocity(tb, x[S_IDX]);
  const float* tx = tb + D::T_TX;
  const float* tu = tb + D::T_TU;

  // ---- gradient f_x (scaled by T_x)
  const float* dm = rb.dmani + bk * DOF;
  float* gx = out.gx + bk * NX;
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    float g = 0.f, gl = 0.f, gg = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g += dc[i][r] * cont[i];
      gl += dl[i][r] * lag[i];
      gg += dg[i][r] * lg[i];
    }
    float f = 2.f * qck * g + 2.f * ql * gl;
    if (r == VS_IDX) f += 2.f * tb[SC_Q_VS] * dv;
    f += 2.f * qo * gg;
    if (r < DOF) f += -tb[SC_Q_SING] * dm[r];
    gx[r] = tx[r] * f;
  }

  // ---- Gauss-Newton f_xx + q_vs + Tikhonov, scaled T_x f_xx T_x
  float* hxx = out.hxx + bk * NX * NX;
#pragma unroll
  for (int r = 0; r < NX; ++r)
#pragma unroll
    for (int c = r; c < NX; ++c) {
      float a = 0.f, l = 0.f, g = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a += dc[i][r] * dc[i][c];
        l += dl[i][r] * dl[i][c];
        g += dg[i][r] * dg[i][c];
      }
      float f = 2.f * qck * a + 2.f * ql * l + 2.f * qo * g;
      if (r == VS_IDX && c == VS_IDX) f += 2.f * tb[SC_Q_VS];
      if (r == c) f += 1e-6f;
      const float h = tx[r] * f * tx[c];
      hxx[NX * r + c] = h;
      hxx[NX * c + r] = h;
    }
  if (term) return;

  // ---- inputs: cost gradient, ddq smoothness (inactive at k = 0)
  const size_t bs = (size_t)b * n_h + k;
  const float* cb = cu + (size_t)b * NU;
  float ddq[DOF];
#pragma unroll
  for (int j = 0; j < DOF; ++j)
    ddq[j] = u[j] - (k == 0 ? cb[j] : us[NU * (k - 1) + j]);
  const float two_r = k == 0 ? 0.f : 2.f * tb[SC_R_DDQ];
  float* gu = out.gu + bs * NU;
  float* gxu = out.gxu + bs * DOF;
  float* huu = out.huu + bs * NU * NU;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const bool q = j < DOF;
    const float fu = 2.f * (q ? tb[SC_R_DQ] : tb[SC_R_DVS]) * u[j];
    const float gsm = q ? two_r * tu[j] * ddq[j] : 0.f;
    gu[j] = fu * tu[j] + gsm;
    if (q) gxu[j] = -gsm;
    const float fuu = 2.f * (q ? tb[SC_R_DQ] : tb[SC_R_DVS]) + 1e-6f;
    const float r2 = q ? two_r * (tu[j] * tu[j]) : 0.f;
#pragma unroll
    for (int c = 0; c < NU; ++c)
      huu[NU * j + c] = c == j ? tu[j] * fuu * tu[j] + r2 : 0.f;
  }

  // ---- dynamics defect, state box of knot k+1 (s trust region), input
  //      box, ddq rate rows
  float xn[NX], pred[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) xn[i] = zb[NX * (k + 1) + i];
  dyn_pred<D>(tb, x, u, pred);
  const float len = tb[SC_LENGTH], trust = tb[SC_S_TRUST];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    out.e[bs * NX + i] = -((xn[i] - pred[i]) * (1.f / tx[i]));
    float hi = tb[D::T_XU + i], lo = tb[D::T_XL + i];
    if (i == S_IDX) {
      hi = nmin(xn[i] + trust, len);
      lo = nmax(xn[i] - trust, 0.f);
    }
    float du_ = hi - xn[i], dl_ = xn[i] - lo;
    if (i == S_IDX) {
      du_ = nmax(du_, 1e-6f);
      dl_ = nmax(dl_, 1e-6f);
    }
    out.dxu[bs * NX + i] = du_;
    out.dxl[bs * NX + i] = dl_;
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    out.duu[bs * NU + j] = tb[D::T_UU + j] - u[j];
    out.dul[bs * NU + j] = u[j] - tb[D::T_UL + j];
  }
#pragma unroll
  for (int j = 0; j < DOF; ++j) {
    const float rate = ddq[j] / ts;
    out.dru[bs * DOF + j] = tb[D::T_DDQU + j] - rate;
    out.drl[bs * DOF + j] = rate - tb[D::T_DDQL + j];
  }

  // ---- RBF polytopic rows: d_p = -c, cpx = drbf(h) d T_x, cpu = -d T_u
  for (int row = 0; row < NPC; ++row) {
    const float h = poly_h<D>(tb, rb, bk, b, row);
    const float dr = drbf(h);
    float lin = 0.f;
    float* cx = out.cpx + (bs * NPC + row) * NX;
    float* cuo = out.cpu + (bs * NPC + row) * NU;
#pragma unroll
    for (int j = 0; j < DOF; ++j) {
      const float d = poly_d<D>(rb, bk, row, j);
      lin += d * u[j];
      cx[j] = dr * d * tx[j];
      cuo[j] = -d * tu[j];
    }
    cx[S_IDX] = 0.f;
    cx[VS_IDX] = 0.f;
    cuo[DVS_IDX] = 0.f;
    out.dp[bs * NPC + row] = -(-lin + rbf(h));
  }
}

template <class D>
__global__ void __launch_bounds__(128)
eval_kernel(const float* __restrict__ z, const float* __restrict__ cu,
            Robot rb, const float* __restrict__ tb, float* __restrict__ obj_out,
            float* __restrict__ vio_out, int batch, int n_cand, int n_h,
            int nseg, float ts) {
  constexpr int NX = D::NX, NU = D::NU, DOF = D::DOF, NPC = D::NPC;
  constexpr int S_IDX = D::S_IDX, VS_IDX = D::VS_IDX, DVS_IDX = D::DVS_IDX;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * n_cand) return;
  const int b = t / n_cand;
  const int nk = n_h + 1;
  const float* zb = z + (size_t)t * (NX * nk + NU * n_h);
  const float* us = zb + NX * nk;
  const float* cb = cu + (size_t)b * NU;
  const float len = tb[SC_LENGTH], trust = tb[SC_S_TRUST];
  float obj = 0.f, vio = 0.f;
  for (int k = 0; k < nk; ++k) {
    const bool term = k == n_h;
    const size_t bk = (size_t)b * nk + k;
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = zb[NX * k + i];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = term ? 0.f : us[NU * k + i];
    TrackPoint tp;
    track_eval(tb, D::T_PTBL, nseg, x[S_IDX], tp);

    // ---- objective
    float qc, ql, qo;
    sched_weights(tb, rb.sel[bk], rb.mani[bk], qc, ql, qo);
    const float qck = term ? tb[SC_Q_C_N_MULT] * qc : qc;
    const float dv = x[VS_IDX] - desired_velocity(tb, x[S_IDX]);
    const float* pe = rb.ee_pos + bk * 3;
    float et[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) et[i] = pe[i] - tp.p[i];
    const float te = tp.t[0] * et[0] + tp.t[1] * et[1] + tp.t[2] * et[2];
    float cont2 = 0.f, lag2 = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float l = tp.t[i] * te, c = et[i] - l;
      cont2 += c * c;
      lag2 += l * l;
    }
    const float* rc = rb.ee_rot + bk * 9;
    float rbar[9], lg[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        rbar[3 * i + j] = tp.r[i] * rc[j] + tp.r[3 + i] * rc[3 + j]
                          + tp.r[6 + i] * rc[6 + j];
    log_rot_vec(rbar, lg);
    const float log2 = lg[0] * lg[0] + lg[1] * lg[1] + lg[2] * lg[2];
    obj += qck * cont2 + ql * lag2 + tb[SC_Q_VS] * dv * dv + qo * log2
           - tb[SC_Q_SING] * rb.mani[bk];
    if (!term) {
      float dq2 = 0.f, dd2 = 0.f;
#pragma unroll
      for (int j = 0; j < DOF; ++j) {
        dq2 += u[j] * u[j];
        const float d = k >= 1 ? u[j] - us[NU * (k - 1) + j] : 0.f;
        dd2 += d * d;
      }
      obj += tb[SC_R_DQ] * dq2 + tb[SC_R_DVS] * u[DVS_IDX] * u[DVS_IDX];
      if (k >= 1) obj += tb[SC_R_DDQ] * dd2;
    }

    // ---- violation: state box (s row: trust region around this knot's s)
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float hi = tb[D::T_XU + i], lo = tb[D::T_XL + i];
      if (i == S_IDX) {
        hi = nmin(x[i] + trust, len);
        lo = nmax(x[i] - trust, 0.f);
      }
      vio += nmax(lo - x[i], 0.f) + nmax(x[i] - hi, 0.f);
    }
    if (term) continue;
    // dynamics defect of k -> k+1 (rows l = u = 0)
    float pred[NX];
    dyn_pred<D>(tb, x, u, pred);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      vio += fabsf((zb[NX * (k + 1) + i] - pred[i]) * (1.f / tb[D::T_TX + i]));
    // input box, ddq rate rows (at k = 0 against the current input)
#pragma unroll
    for (int j = 0; j < NU; ++j)
      vio += nmax(tb[D::T_UL + j] - u[j], 0.f)
             + nmax(u[j] - tb[D::T_UU + j], 0.f);
#pragma unroll
    for (int j = 0; j < DOF; ++j) {
      const float rate = (u[j] - (k == 0 ? cb[j] : us[NU * (k - 1) + j])) / ts;
      vio += nmax(tb[D::T_DDQL + j] - rate, 0.f)
             + nmax(rate - tb[D::T_DDQU + j], 0.f);
    }
    // polytopic rows, one-sided (upper 0, lower -inf)
    for (int row = 0; row < NPC; ++row) {
      float lin = 0.f;
#pragma unroll
      for (int j = 0; j < DOF; ++j) lin += poly_d<D>(rb, bk, row, j) * u[j];
      vio += nmax(-lin + rbf(poly_h<D>(tb, rb, bk, b, row)), 0.f);
    }
  }
  obj_out[t] = obj;
  vio_out[t] = vio;
}

}  // namespace

// system: the base_dof of the system's instantiation (0 Panda, 3
// Husky+Panda); -1 for an unknown system.
extern "C" int mpcc_assembly_table_len(int system, int nseg) {
  if (system == 0) return Panda::table_len(nseg);
  if (system == 3) return HuskyPanda::table_len(nseg);
  return -1;
}

extern "C" int mpcc_assembly(
    const float* z, const float* cu, const float* ee_pos, const float* ee_rot,
    const float* jv, const float* jw, const float* mani, const float* dmani,
    const float* sel, const float* dsel, const float* env, const float* denv,
    const float* radius, const float* tables, float* hxx, float* huu,
    float* gx, float* gu, float* gxu, float* e, float* dxu, float* dxl,
    float* duu, float* dul, float* dru, float* drl, float* dp, float* cpx,
    float* cpu, int system, int batch, int n_h, int nseg, float ts,
    float jr_sign, void* stream) {
  const int n = batch * (n_h + 1);
  if (n <= 0) return 0;
  const Robot rb{ee_pos, ee_rot, jv, jw, mani, dmani, sel, dsel, env, denv,
                 radius};
  const AsmOut out{hxx, huu, gx, gu, gxu, e, dxu, dxl, duu, dul, dru, drl,
                   dp, cpx, cpu};
  const int threads = 128, blocks = (n + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0)
    assembly_kernel<Panda><<<blocks, threads, 0, st>>>(
        z, cu, rb, tables, out, batch, n_h, nseg, ts, jr_sign);
  else if (system == 3)
    assembly_kernel<HuskyPanda><<<blocks, threads, 0, st>>>(
        z, cu, rb, tables, out, batch, n_h, nseg, ts, jr_sign);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpcc_eval_point(
    const float* z, const float* cu, const float* ee_pos, const float* ee_rot,
    const float* mani, const float* dmani, const float* sel,
    const float* dsel, const float* env, const float* denv,
    const float* radius, const float* tables, float* obj, float* vio,
    int system, int batch, int n_cand, int n_h, int nseg, float ts,
    void* stream) {
  const int n = batch * n_cand;
  if (n <= 0) return 0;
  const Robot rb{ee_pos, ee_rot, nullptr, nullptr, mani, dmani, sel, dsel,
                 env, denv, radius};
  const int threads = 128, blocks = (n + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0)
    eval_kernel<Panda><<<blocks, threads, 0, st>>>(
        z, cu, rb, tables, obj, vio, batch, n_cand, n_h, nseg, ts);
  else if (system == 3)
    eval_kernel<HuskyPanda><<<blocks, threads, 0, st>>>(
        z, cu, rb, tables, obj, vio, batch, n_cand, n_h, nseg, ts);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
