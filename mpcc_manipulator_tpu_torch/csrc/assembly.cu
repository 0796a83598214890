// K2: the stage-QP assembly of one SQP iteration -- every StageQPK block
// that depends on the scenario -- and K3: the line-search evaluation, the
// total objective and the l1 violation of every constraint row at an
// iterate.  The two kernels share one set of device helpers (track spline
// and SO(3) reference, Rodrigues exponential, rotation log, right-Jacobian
// inverse, RBF barrier, scheduled weights, dynamics prediction) and the
// staging of a block's inputs into shared memory.
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
// their first int argument.  The horizon N is a run-time argument.
//
// What bounds them on the H100.  K2: bytes.  A Panda scenario writes 4,330
// floats at N = 10 (hxx 891, huu 640, cpx 990, cpu 880 and the vectors;
// ~17.7 MB at batch 1024) against ~1,700 read; a Husky+Panda scenario
// 6,556.  The arithmetic (~3 kFLOP a knot of 3-vector and 3x3 work, one
// atan2, a few sin/cos/log) is small beside that, but each knot's share is
// one long dependent chain.  K3 writes two floats a candidate and reads
// ~110 a knot: latency (each knot's chain of spline, Rodrigues, log and
// barrier terms), then the bytes it reads.
//
// Design.  K2: a block of 256 threads owns S whole scenarios (at most 4, as
// many as 48 KB of shared memory hold at the run's N), so each output
// tensor's share of the block is one contiguous range.
//   0. All threads copy the block's z rows, current inputs, RobotData rows
//      and the table's head (scalars, scalings, bounds, Ad, Bd) into shared
//      memory with cp.async, consecutive threads on consecutive addresses:
//      a thread's copies are all in flight at once, not one load latency
//      after another.
//   A. One thread a knot: track point, heading log, Jr^-1 R', the errors and
//      scheduled weights; the knot's record holds, for each column c, the
//      contouring, lag and heading stacks' entries and gx[c] in 12 floats,
//      then the doubled weights.  The warps past the knot threads' compute
//      rbf(h) and drbf(h), one (stage, polytopic row) at a time.
//   B. The polytopic gradient rows (dsel, dmani, denv) of the block's
//      stages replace phase A's inputs in shared memory (cp.async).  Then
//      each warp takes one knot (hxx, gx) or one stage (the other blocks) at
//      a time; a lane's entry is fixed per pass of 32, so each store writes
//      32 consecutive floats.  An hxx entry reads its two columns as three
//      float4 each, at (min(r, c), max(r, c)), so both halves carry the same
//      bits; cpx / cpu come from drbf and the rows, the vectors from the
//      staged z rows and the table.
//   The 256 threads and the 4-scenario cap were chosen on the card among
//   1, 2 or 4 scenarios and 64, 128 or 256 threads (PERF.md section 6).
// K3: one thread a (scenario, candidate, knot).  A block holds whole
// scenarios with all their candidates (S = 128 / (candidates x knots), at
// most 4; when one scenario's candidates need more than 128 threads, a
// block holds as many candidate rows as fit and stages the at most two
// scenarios they belong to).  The scenarios' RobotData, the candidates' z
// rows and the table's head are staged once in shared memory (cp.async); a
// knot's polytopic gradient rows are read from global memory by the one
// thread that needs them (the scenario's other candidates find them in
// L1).  Each thread forms its knot's objective and violation terms into a
// shared partial, then one thread a row sums the row's partials in knot
// order (the same order every run: no atomics).
// The sums of K3 run per knot and then over the knots, so K3 rounds
// differently from the plain version (a running sum); its contract is the
// JAX test's rtol = atol = 5e-4.  K2 keeps each entry's arithmetic as the
// plain formulas write it; sin and cos are `sincos_angle`'s, which rounds
// otherwise than sinf / cosf (within 2 ulp of float64).
//
// Shared memory (bytes, one block, both kernels under 48 KB at N = 5, 10
// and 20; `mpcc_assembly_launch_config` reports it, ops/assembly_kernel.py's
// `launch_geometry` mirrors it):
//   K2, Panda:        N = 5: 4 scenarios, 22,464; N = 10: 4, 40,624;
//                     N = 20: 2, 39,200
//   K2, Husky+Panda:  N = 5: 4, 28,720; N = 10: 3, 40,016; N = 20: 1, 26,528
//   K3, 1 candidate:  Panda 5,056 / 8,416 / 15,136; Husky+Panda 6,224 /
//                     10,064 / 17,744 (4 scenarios at each N)
//   K3, 5 candidates: Panda 11,840 (4) / 11,144 (2) / 10,796 (1);
//                     Husky+Panda 15,120 (4) / 14,280 (2) / 13,860 (1)
//
// The spline gather is an indexed load of the segment's row (the TPU
// kernel's one-hot MXU contraction was a Mosaic workaround), the rotation log
// uses atan2 (the TPU kernel's series + Newton arccos stood in for Mosaic's
// missing inverse trig).  Every max / min / clamp propagates NaN as
// jnp.maximum and torch.clamp do, so a NaN iterate reaches the blocks the
// SQP's NaN guard reads and the values its filter compares; where the plain
// version multiplies a structural zero into a NaN (the dense Ad/Bd product,
// the zero vs column of the error Jacobians) the kernel does too.
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
constexpr int SMEM_LIMIT = 48 * 1024;   // bytes a block, no opt-in needed
constexpr int K2_THREADS = 256;
constexpr int MAX_SCENARIOS = 4;        // scenarios a block at most
constexpr int K3_ROW_THREADS = 128;     // threads a block aims to fill
constexpr int K3_MAX_THREADS = 256;

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
  // K2's shared record of one knot: column c of the contouring, lag and
  // heading stacks (3 x NX each) and gx[c] in 12 floats (three float4 reads
  // in phase B), then 2 q_c, 2 q_l, 2 q_ori; the stride is 4 times an odd
  // number, so the knot threads of a warp write it 4-way bank-conflicted
  // at most
  static constexpr int REC = 4 * ((3 * NX + 1) | 1), W = 12 * NX;
  // a knot's inputs of K2's phase A: jv, jw (3 x DOF each), R_ee, p_ee,
  // dmani, sel, mani, env
  static constexpr int KNOT_IN = 7 * DOF + 14 + NL;
};
using Panda = Dims<0>;
using HuskyPanda = Dims<3>;

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// K2's shared memory of a block of `ns` scenarios at horizon n_h, in
// floats from the start of the block's dynamic shared memory
template <class D>
struct K2Layout {
  int z, cu, rec, rbf, drbf, in, total;
  __host__ __device__ K2Layout(int n_h, int ns) {
    const int nk = n_h + 1, nvar = D::NX * nk + D::NU * n_h;
    z = align4(D::T_PTBL);                  // the table's head first
    cu = z + ns * nvar;                      // the block's z rows
    rec = align4(cu + ns * D::NU);           // current inputs
    rbf = rec + ns * nk * D::REC;            // knot records
    drbf = rbf + ns * n_h * D::NPC;          // rbf(h) a stage and row
    in = drbf + ns * n_h * D::NPC;           // drbf(h)
    // phase A's inputs (and the radii), then phase B's polytopic rows
    total = in + imax(ns * nk * D::KNOT_IN + ns,
                      ns * n_h * D::NPC * D::DOF);
  }
};

// K3's shared memory of a block of `nr` (scenario, candidate) rows drawn
// from at most `ns` scenarios, in floats
template <class D>
struct K3Layout {
  int z, cu, pos, rot, mani, sel, env, rad, pobj, pvio, total;
  __host__ __device__ K3Layout(int n_h, int nr, int ns) {
    const int nk = n_h + 1, nvar = D::NX * nk + D::NU * n_h;
    z = align4(D::T_PTBL);
    cu = z + nr * nvar;
    pos = cu + ns * D::NU;
    rot = pos + ns * nk * 3;
    mani = rot + ns * nk * 9;
    sel = mani + ns * nk;
    env = sel + ns * nk;
    rad = env + ns * nk * D::NL;
    pobj = rad + ns;
    pvio = pobj + nr * nk;
    total = pvio + nr * nk;
  }
};

// K2's scenarios a block at horizon n_h: at most MAX_SCENARIOS, as many as
// SMEM_LIMIT holds; 0 when not even one does
template <class D>
int k2_scenarios(int n_h) {
  for (int s = MAX_SCENARIOS; s >= 1; --s)
    if (K2Layout<D>(n_h, s).total * (int)sizeof(float) <= SMEM_LIMIT) return s;
  return 0;
}

// K3's launch at horizon n_h with n_cand candidates: rows a block, the
// scenarios they span, threads; false when no block fits
template <class D>
bool k3_geometry(int n_h, int n_cand, int& rows, int& ns, int& threads) {
  const int nk = n_h + 1;
  if (n_cand * nk <= K3_ROW_THREADS) {
    // whole scenarios: every candidate of each in the block
    int s = K3_ROW_THREADS / (n_cand * nk);
    s = s > MAX_SCENARIOS ? MAX_SCENARIOS : s;
    for (; s >= 1; --s)
      if (K3Layout<D>(n_h, s * n_cand, s).total * (int)sizeof(float)
          <= SMEM_LIMIT) break;
    rows = s * n_cand;
    ns = s;
  } else {
    // part of one scenario's candidates: the rows may straddle two
    rows = imax(1, K3_ROW_THREADS / nk);
    ns = 2;
    if (K3Layout<D>(n_h, rows, ns).total * (int)sizeof(float) > SMEM_LIMIT)
      rows = 0;
  }
  threads = (rows * nk + 31) / 32 * 32;
  return rows >= 1 && threads <= K3_MAX_THREADS;
}

// The scenario s of a block-local index kn = s n + k, by compares: a block
// holds at most MAX_SCENARIOS = 4 scenarios, and a division by the run-time
// n costs ~20 instructions an entry
static_assert(MAX_SCENARIOS == 4, "block_scenario compares up to 3 n");
__device__ __forceinline__ int block_scenario(int kn, int n) {
  return (kn >= n) + (kn >= 2 * n) + (kn >= 3 * n);
}

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

// sin and cos of an angle: a three-part Cody-Waite reduction by pi/2 and
// the Cephes minimax polynomials on [-pi/4, pi/4], within 2 ulp of the
// float64 values for |x| < 1e5 (the arguments here are angles of a few pi
// at most, or NaN, which stays NaN).  sinf / cosf carry a slow path for
// huge arguments whose table lives in local memory: 32 bytes of stack in
// every kernel that calls them.
__device__ __forceinline__ void sincos_angle(float x, float& s, float& c) {
  const float j = rintf(x * 0.636619772f);                 // quadrant
  float t = fmaf(j, -1.57079601e+00f, x);                  // x - j pi/2
  t = fmaf(j, -3.13916473e-07f, t);
  t = fmaf(j, -5.32907052e-15f, t);
  const float z = t * t;
  float ps = fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                  -1.6666654611e-1f);
  ps = fmaf(ps * z, t, t);                                 // sin t
  float pc = fmaf(fmaf(2.443315711809948e-5f, z, -1.388731625493765e-3f), z,
                  4.166664568298827e-2f);
  pc = fmaf(pc * z, z, fmaf(-0.5f, z, 1.f));               // cos t
  const int q = static_cast<int>(j) & 3;
  const float sq = (q & 1) ? pc : ps, cq = (q & 1) ? ps : pc;
  s = (q & 2) ? -sq : sq;
  c = ((q + 1) & 2) ? -cq : cq;
}

__device__ __forceinline__ float sin_angle(float x) {
  float s, c;
  sincos_angle(x, s, c);
  return s;
}

// Rodrigues exponential, (3) -> row-major 3x3 (utils/so3.py::exp_rot)
__device__ __forceinline__ void exp_rot(const float w[3], float e[9]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(th2);
  const bool small = th < EPS;
  const float st = small ? 1.f : th;
  float sn, cs;
  sincos_angle(st, sn, cs);
  const float a = small ? 1.f - th2 / 6.f : sn / st;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / (st * st);
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
// the axis from the diagonal and the signs from the argmax row.  The argmax
// row is picked by selects, not by a run-time index (which would put the
// matrix in local memory).
__device__ __forceinline__ void log_rot_vec(const float r[9], float out[3]) {
  const float tr = r[0] + r[4] + r[8];
  const float c = nclamp((tr - 1.f) * 0.5f, -1.f, 1.f);
  const float th = atan2f(sqrtf(nmax(1.f - c * c, 0.f)), c);
  const float sn = sin_angle(th);
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
      // (r[3k + i] + r[3i + k]) / 2
      const float rki = k == 0 ? r[i] : k == 1 ? r[3 + i] : r[6 + i];
      const float rik = k == 0 ? r[3 * i] : k == 1 ? r[3 * i + 1]
                                                   : r[3 * i + 2];
      const float ck = (rki + rik) * 0.5f;
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
__device__ __forceinline__ void jr_inv(const float p[3], float sign,
                                       float j[9]) {
  const float n2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  const float n = sqrtf(n2);
  const bool small = n < EPS;
  const float sn_ = small ? 1.f : n, sn2 = small ? 1.f : n2;
  float s, cs;
  sincos_angle(sn_, s, cs);
  const float ss = fabsf(s) < EPS ? 1.f : s;
  const float coef = 1.f / sn2 + sign * (1.f + cs) / (2.f * sn_ * ss);
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

// (tb: the whole table in global memory; ptbl: the system's offset of the
// position table)
__device__ __forceinline__ void track_eval(const float* __restrict__ tb,
                                           int ptbl, int nseg, float s,
                                           TrackPoint& o) {
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

// Proximity-triggered weights (ocp/cost.py::scheduled_weights); hd: the
// table's head
__device__ __forceinline__ void sched_weights(const float* hd, float sel,
                                              float mani, float& qc,
                                              float& ql, float& qo) {
  const float ratio = nmin(sel / (hd[SC_TOL_SELCOL] * 2.f),
                           mani / (hd[SC_TOL_SING] * 2.f));
  const float t = (ratio - 0.5f) / 0.5f;
  const float bl = 3.f * t * t - 2.f * t * t * t;
  const bool near = ratio <= 1.f;
  const float rc = hd[SC_Q_C_RED], rl = hd[SC_Q_L_INC], ro = hd[SC_Q_ORI_RED];
  qc = near ? hd[SC_Q_C] * (rc + (1.f - rc) * bl) : hd[SC_Q_C];
  ql = near ? hd[SC_Q_L] * (rl + (1.f - rl) * bl) : hd[SC_Q_L];
  qo = near ? hd[SC_Q_ORI] * (ro + (1.f - ro) * bl) : hd[SC_Q_ORI];
}

// Desired path speed with the terminal taper, on the raw s
__device__ __forceinline__ float desired_velocity(const float* hd, float s) {
  const float len = hd[SC_LENGTH], v0 = hd[SC_V_DES], dr = hd[SC_DEACC];
  const float taper = -v0 / (len * dr) * (s - len);
  return s < len * dr ? v0 : taper;
}

// Row i of Ad x + Bd u as the plain version's dense product (a NaN anywhere
// in x or u reaches every row, as it does there)
template <class D>
__device__ __forceinline__ float dyn_pred_row(const float* hd, const float* x,
                                              const float* u, int i) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int j = 0; j < D::NX; ++j) a += hd[D::T_AD + D::NX * i + j] * x[j];
#pragma unroll
  for (int j = 0; j < D::NU; ++j) b += hd[D::T_BD + D::NU * i + j] * u[j];
  return a + b;
}

// The RBF polytopic row's height h at one knot: row 0 self-collision, row 1
// singularity, rows 2.. env collision
__device__ __forceinline__ float poly_h(const float* hd, float sel, float mani,
                                        const float* env, float radius,
                                        int row) {
  if (row == 0) return 0.01f * sel - 0.01f * hd[SC_TOL_SELCOL];
  if (row == 1) return mani - hd[SC_TOL_SING];
  return 0.01f * (env[row - 2] - 1.2f * radius) - 0.01f * hd[SC_TOL_ENVCOL];
}

struct Robot {
  const float *ee_pos, *ee_rot, *jv, *jw, *mani, *dmani, *sel, *dsel, *env,
      *denv, *radius;
};

struct AsmOut {
  float *hxx, *huu, *gx, *gu, *gxu, *e, *dxu, *dxl, *duu, *dul, *dru, *drl,
      *dp, *cpx, *cpu;
};

// 4 bytes global -> shared without a register round trip (cp.async): a
// thread's copies stay in flight together until cp_async_wait_all, and a
// __syncthreads then shows them to the block.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats from global to shared memory, the whole block, consecutive
// threads on consecutive addresses
__device__ __forceinline__ void copy_in(float* dst,
                                        const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

// The polytopic gradient rows of the first n_h knots of scenarios b0 ..
// b0+ns-1 as the inputs hold them (row 0 dsel, row 1 dmani, rows 2..
// denv), into dst[((s n_h + k) NPC + row) DOF + j]; `poly_d` scales them.
template <class D>
__device__ void stage_drows(float* dst, const Robot& rb, int b0, int ns,
                            int n_h) {
  constexpr int DOF = D::DOF, NL = D::NL, NPC = D::NPC;
  const size_t nk = n_h + 1;
  const int nd = ns * n_h * DOF;
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    const int kn = i / DOF, j = i - kn * DOF;
    const int s = block_scenario(kn, n_h), k = kn - s * n_h;
    const size_t src = ((b0 + s) * nk + k) * DOF + j;
    cp_async4(dst + kn * NPC * DOF + j, rb.dsel + src);
    cp_async4(dst + (kn * NPC + 1) * DOF + j, rb.dmani + src);
  }
  const int ne = ns * n_h * NL * DOF;
  for (int i = threadIdx.x; i < ne; i += blockDim.x) {
    const int kn = i / (NL * DOF), rem = i - kn * (NL * DOF);
    const int s = block_scenario(kn, n_h), k = kn - s * n_h;
    cp_async4(dst + (kn * NPC + 2) * DOF + rem,
              rb.denv + ((b0 + s) * nk + k) * (NL * DOF) + rem);
  }
}

// A polytopic row's gradient entry as the plain version scales it: 0.01
// dsel, dmani, 0.01 denv
__device__ __forceinline__ float poly_d(float raw, int row) {
  return row == 1 ? raw : 0.01f * raw;
}

template <class D>
__global__ void __launch_bounds__(K2_THREADS)
assembly_kernel(const float* __restrict__ z, const float* __restrict__ cu,
                Robot rb, const float* __restrict__ tb, AsmOut out,
                int batch, int n_h, int nseg, float ts, float jr_sign,
                int spb) {
  constexpr int NX = D::NX, NU = D::NU, DOF = D::DOF, NPC = D::NPC;
  constexpr int S_IDX = D::S_IDX, VS_IDX = D::VS_IDX;
  constexpr int REC = D::REC, W = D::W;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const K2Layout<D> L(n_h, spb);
  const int nk = n_h + 1, nvar = NX * nk + NU * n_h;
  const int b0 = blockIdx.x * spb;
  const int ns = batch - b0 < spb ? batch - b0 : spb;
  const int nkb = ns * nk, nsb = ns * n_h;   // the block's knots, stages
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nth >> 5;
  float* hd = sm;
  float* zs = sm + L.z;
  float* cus = sm + L.cu;
  float* rec = sm + L.rec;
  float* rbs = sm + L.rbf;
  float* drs = sm + L.drbf;
  float* in = sm + L.in;
  float* jvs = in;                       // phase A's inputs, knot-major
  float* jws = jvs + nkb * 3 * DOF;
  float* rots = jws + nkb * 3 * DOF;
  float* poss = rots + nkb * 9;
  float* dms = poss + nkb * 3;
  float* sels = dms + nkb * DOF;
  float* manis = sels + nkb;
  float* envs = manis + nkb;
  float* rads = envs + nkb * D::NL;

  // ---- 0. stage the block's inputs
  const size_t bk0 = (size_t)b0 * nk;
  copy_in(hd, tb, D::T_PTBL);
  copy_in(zs, z + (size_t)b0 * nvar, ns * nvar);
  copy_in(cus, cu + (size_t)b0 * NU, ns * NU);
  copy_in(jvs, rb.jv + bk0 * 3 * DOF, nkb * 3 * DOF);
  copy_in(jws, rb.jw + bk0 * 3 * DOF, nkb * 3 * DOF);
  copy_in(rots, rb.ee_rot + bk0 * 9, nkb * 9);
  copy_in(poss, rb.ee_pos + bk0 * 3, nkb * 3);
  copy_in(dms, rb.dmani + bk0 * DOF, nkb * DOF);
  copy_in(sels, rb.sel + bk0, nkb);
  copy_in(manis, rb.mani + bk0, nkb);
  copy_in(envs, rb.env + bk0 * D::NL, nkb * D::NL);
  copy_in(rads, rb.radius + b0, ns);
  cp_async_wait_all();
  __syncthreads();

  // ---- A. the RBF rows' barrier values, one (stage, row) a thread: on
  // the warps past the knot threads' when there are any, so that they run
  // beside the knots' longer chains
  const int a2 = (nkb + 31) / 32 * 32 < nth ? (nkb + 31) / 32 * 32 : 0;
  for (int i = tid - a2; tid >= a2 && i < nsb * NPC; i += nth - a2) {
    const int kn = i / NPC, row = i - kn * NPC;
    const int s = block_scenario(kn, n_h), k = kn - s * n_h;
    const int t = s * nk + k;
    const float h = poly_h(hd, sels[t], manis[t], envs + t * D::NL, rads[s],
                           row);
    rbs[i] = rbf(h);
    drs[i] = drbf(h);
  }
  // ---- A. one knot a thread: the knot's record (column c of the
  // contouring, lag and heading stacks and gx[c] at rr[12 c ..]; the
  // doubled weights at rr[W ..])
  for (int t = tid; t < nkb; t += nth) {
    const int s = block_scenario(t, nk), k = t - s * nk;
    const float* xk = zs + s * nvar + NX * k;
    TrackPoint tp;
    track_eval(tb, D::T_PTBL, nseg, xk[S_IDX], tp);
    float* rr = rec + t * REC;

    // heading: log(R_ref' R_cur), d_log = Jr^-1 R_cur' [jw | -dr_ref]
    const float* rc = rots + t * 9;
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

    // contouring / lag errors and the three 3 x nx Jacobian stacks
    const float* pe = poss + t * 3;
    const float* jv = jvs + t * 3 * DOF;
    const float* jw = jws + t * 3 * DOF;
    float et[3], lag[3], cont[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) et[i] = pe[i] - tp.p[i];
    const float te = tp.t[0] * et[0] + tp.t[1] * et[1] + tp.t[2] * et[2];
    const float tt = tp.t[0] * tp.t[0] + tp.t[1] * tp.t[1]
                     + tp.t[2] * tp.t[2];
    const float en = et[0] * tp.n[0] + et[1] * tp.n[1] + et[2] * tp.n[2];
    // the plain version forms d_lag as (t t') d_total + (t e' + te I) d_t,
    // so a non-finite t or e reaches every column, the zero ones included
    const float pz = 0.f * (tp.t[0] + tp.t[1] + tp.t[2] + et[0] + et[1]
                            + et[2] + te);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lag[i] = tp.t[i] * te;
      cont[i] = et[i] - lag[i];
    }
#pragma unroll 1
    for (int j = 0; j < DOF; ++j) {
      const float tjv = tp.t[0] * jv[j] + tp.t[1] * jv[DOF + j]
                        + tp.t[2] * jv[2 * DOF + j];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float l = tp.t[i] * tjv + pz;
        rr[12 * j + 3 + i] = l;
        rr[12 * j + i] = jv[i * DOF + j] - l;
        rr[12 * j + 6 + i] = m1[3 * i] * jw[j] + m1[3 * i + 1] * jw[DOF + j]
                             + m1[3 * i + 2] * jw[2 * DOF + j];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ls = -tp.t[i] * tt + tp.t[i] * en + tp.n[i] * te + pz;
      rr[12 * S_IDX + 3 + i] = ls;
      rr[12 * S_IDX + i] = -tp.t[i] - ls;
      rr[12 * S_IDX + 6 + i] = -(m1[3 * i] * tp.dr[0]
                                 + m1[3 * i + 1] * tp.dr[1]
                                 + m1[3 * i + 2] * tp.dr[2]);
      rr[12 * VS_IDX + 3 + i] = pz;
      rr[12 * VS_IDX + i] = 0.f - pz;
      rr[12 * VS_IDX + 6 + i] = 0.f;
    }

    // scheduled weights, desired velocity
    float qc, ql, qo;
    sched_weights(hd, sels[t], manis[t], qc, ql, qo);
    const float qck = k == n_h ? hd[SC_Q_C_N_MULT] * qc : qc;
    rr[W] = 2.f * qck;
    rr[W + 1] = 2.f * ql;
    rr[W + 2] = 2.f * qo;
    const float dv = xk[VS_IDX] - desired_velocity(hd, xk[S_IDX]);

    // gradient f_x (scaled by T_x)
    const float* dm = dms + t * DOF;
#pragma unroll 1
    for (int r = 0; r < NX; ++r) {
      float g = 0.f, gl = 0.f, gg = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g += rr[12 * r + i] * cont[i];
        gl += rr[12 * r + 3 + i] * lag[i];
        gg += rr[12 * r + 6 + i] * lg[i];
      }
      float f = 2.f * qck * g + 2.f * ql * gl;
      if (r == VS_IDX) f += 2.f * hd[SC_Q_VS] * dv;
      f += 2.f * qo * gg;
      if (r < DOF) f += -hd[SC_Q_SING] * dm[r];
      rr[12 * r + 9] = hd[D::T_TX + r] * f;
    }
  }
  __syncthreads();

  // ---- B. the stages' polytopic gradient rows replace phase A's inputs
  float* drow = in;
  stage_drows<D>(drow, rb, b0, ns, n_h);
  cp_async_wait_all();
  __syncthreads();

  // ---- B. the outputs, one knot (hxx, gx) or one stage (the rest) a warp
  // at a time; a lane's entry of a knot's or stage's block is fixed per
  // pass of 32, so each store writes 32 consecutive floats
  const float* tx = hd + D::T_TX;
  const float* tu = hd + D::T_TU;
  const size_t s0 = (size_t)b0 * n_h;    // the block's first stage
  const float two_q_vs = 2.f * hd[SC_Q_VS];
  for (int kn = warp; kn < nkb; kn += nwarp) {
    // Gauss-Newton f_xx + q_vs + Tikhonov, scaled T_x f_xx T_x, from the
    // record's columns min(r, c) and max(r, c)
    const float* rr = rec + kn * REC;
    const float w0 = rr[W], w1 = rr[W + 1], w2 = rr[W + 2];
    float* o = out.hxx + (bk0 + kn) * (NX * NX);
#pragma unroll
    for (int p = 0; p < (NX * NX + 31) / 32; ++p) {
      const int e = 32 * p + lane;
      if (e < NX * NX) {
        const int r0 = e / NX, c0 = e - r0 * NX;
        const int r = r0 < c0 ? r0 : c0, c = r0 < c0 ? c0 : r0;
        const float4* vr = reinterpret_cast<const float4*>(rr + 12 * r);
        const float4* vc = reinterpret_cast<const float4*>(rr + 12 * c);
        // [dc0 dc1 dc2 dl0] [dl1 dl2 dg0 dg1] [dg2 gx - -]
        const float4 ra = vr[0], rb2 = vr[1], rc2 = vr[2];
        const float4 ca = vc[0], cb = vc[1], cc = vc[2];
        float a = 0.f, l = 0.f, g = 0.f;
        a += ra.x * ca.x;
        a += ra.y * ca.y;
        a += ra.z * ca.z;
        l += ra.w * ca.w;
        l += rb2.x * cb.x;
        l += rb2.y * cb.y;
        g += rb2.z * cb.z;
        g += rb2.w * cb.w;
        g += rc2.x * cc.x;
        float f = w0 * a + w1 * l + w2 * g;
        if (r == VS_IDX && c == VS_IDX) f += two_q_vs;
        if (r == c) f += 1e-6f;
        o[e] = tx[r] * f * tx[c];
      }
    }
    if (lane < NX) out.gx[(bk0 + kn) * NX + lane] = rr[12 * lane + 9];
  }
  const float r_dq = hd[SC_R_DQ], r_dvs = hd[SC_R_DVS];
  const float two_r_ddq = 2.f * hd[SC_R_DDQ];
  const float len = hd[SC_LENGTH], trust = hd[SC_S_TRUST];
  for (int kn = warp; kn < nsb; kn += nwarp) {
    const int s = block_scenario(kn, n_h), k = kn - s * n_h;
    const size_t st = s0 + kn;
    const float* xk = zs + s * nvar + NX * k;
    const float* xn = xk + NX;
    const float* uk = zs + s * nvar + NX * nk + NU * k;
    const float* up = k == 0 ? cus + s * NU : uk - NU;
    const float two_r = k == 0 ? 0.f : two_r_ddq;
    // input Hessian: its diagonal, smoothness included (inactive at k = 0)
    {
      float* o = out.huu + st * (NU * NU);
#pragma unroll
      for (int p = 0; p < (NU * NU + 31) / 32; ++p) {
        const int e = 32 * p + lane;
        if (e < NU * NU) {
          const int j = e / NU, c = e - j * NU;
          const bool q = j < DOF;
          const float fuu = 2.f * (q ? r_dq : r_dvs) + 1e-6f;
          const float r2 = q ? two_r * (tu[j] * tu[j]) : 0.f;
          o[e] = c == j ? tu[j] * fuu * tu[j] + r2 : 0.f;
        }
      }
    }
    // input cost gradient with the smoothness term and its u_prev part,
    // input box, ddq rate rows
    if (lane < NU) {
      const int j = lane;
      const bool q = j < DOF;
      const float u = uk[j], ddq = u - up[j];
      const float fu = 2.f * (q ? r_dq : r_dvs) * u;
      const float gsm = q ? two_r * tu[j] * ddq : 0.f;
      out.gu[st * NU + j] = fu * tu[j] + gsm;
      out.duu[st * NU + j] = hd[D::T_UU + j] - u;
      out.dul[st * NU + j] = u - hd[D::T_UL + j];
      if (q) {
        out.gxu[st * DOF + j] = -gsm;
        const float rate = ddq / ts;
        out.dru[st * DOF + j] = hd[D::T_DDQU + j] - rate;
        out.drl[st * DOF + j] = rate - hd[D::T_DDQL + j];
      }
    }
    // dynamics defect, state box of knot k+1 (s trust region)
    if (lane < NX) {
      const int r = lane;
      const float x = xn[r];
      const float pred = dyn_pred_row<D>(hd, xk, uk, r);
      out.e[st * NX + r] = -((x - pred) * (1.f / tx[r]));
      float hi = hd[D::T_XU + r], lo = hd[D::T_XL + r];
      if (r == S_IDX) {
        hi = nmin(x + trust, len);
        lo = nmax(x - trust, 0.f);
      }
      float du_ = hi - x, dl_ = x - lo;
      if (r == S_IDX) {
        du_ = nmax(du_, 1e-6f);
        dl_ = nmax(dl_, 1e-6f);
      }
      out.dxu[st * NX + r] = du_;
      out.dxl[st * NX + r] = dl_;
    }
    // RBF polytopic rows: d_p = -c, cpx = drbf(h) d T_x, cpu = -d T_u
    const float* dk = drow + kn * (NPC * DOF);
    const float* drk = drs + kn * NPC;
    if (lane < NPC) {
      float lin = 0.f;
#pragma unroll
      for (int j = 0; j < DOF; ++j)
        lin += poly_d(dk[lane * DOF + j], lane) * uk[j];
      out.dp[st * NPC + lane] = -(-lin + rbs[kn * NPC + lane]);
    }
    {
      float* o = out.cpx + st * (NPC * NX);
#pragma unroll
      for (int p = 0; p < (NPC * NX + 31) / 32; ++p) {
        const int e = 32 * p + lane;
        if (e < NPC * NX) {
          const int row = e / NX, j = e - row * NX;
          o[e] = j < DOF
              ? drk[row] * poly_d(dk[row * DOF + j], row) * tx[j] : 0.f;
        }
      }
      o = out.cpu + st * (NPC * NU);
#pragma unroll
      for (int p = 0; p < (NPC * NU + 31) / 32; ++p) {
        const int e = 32 * p + lane;
        if (e < NPC * NU) {
          const int row = e / NU, j = e - row * NU;
          o[e] = j < DOF ? -poly_d(dk[row * DOF + j], row) * tu[j] : 0.f;
        }
      }
    }
  }
}

template <class D>
__global__ void __launch_bounds__(K3_MAX_THREADS)
eval_kernel(const float* __restrict__ z, const float* __restrict__ cu,
            Robot rb, const float* __restrict__ tb, float* __restrict__ obj_out,
            float* __restrict__ vio_out, int batch, int n_cand, int n_h,
            int nseg, float ts, int rpb, int spb) {
  constexpr int NX = D::NX, NU = D::NU, DOF = D::DOF, NPC = D::NPC;
  constexpr int NL = D::NL;
  constexpr int S_IDX = D::S_IDX, VS_IDX = D::VS_IDX, DVS_IDX = D::DVS_IDX;
  extern __shared__ float sm[];
  const K3Layout<D> L(n_h, rpb, spb);
  const int nk = n_h + 1, nvar = NX * nk + NU * n_h;
  const int nrows = batch * n_cand;
  const int r0 = blockIdx.x * rpb;                 // first (b, a) row
  const int nr = nrows - r0 < rpb ? nrows - r0 : rpb;
  const int b0 = r0 / n_cand;                      // first scenario
  const int ns = (r0 + nr - 1) / n_cand - b0 + 1;  // scenarios spanned
  const size_t bk0 = (size_t)b0 * nk;
  float* hd = sm;
  float* zs = sm + L.z;
  float* cus = sm + L.cu;

  // ---- stage the rows' iterates and their scenarios' RobotData
  copy_in(hd, tb, D::T_PTBL);
  copy_in(zs, z + (size_t)r0 * nvar, nr * nvar);
  copy_in(cus, cu + (size_t)b0 * NU, ns * NU);
  copy_in(sm + L.pos, rb.ee_pos + bk0 * 3, ns * nk * 3);
  copy_in(sm + L.rot, rb.ee_rot + bk0 * 9, ns * nk * 9);
  copy_in(sm + L.mani, rb.mani + bk0, ns * nk);
  copy_in(sm + L.sel, rb.sel + bk0, ns * nk);
  copy_in(sm + L.env, rb.env + bk0 * NL, ns * nk * NL);
  copy_in(sm + L.rad, rb.radius + b0, ns);
  cp_async_wait_all();
  __syncthreads();

  // ---- one knot of one row a thread: its objective and violation terms
  const int t = threadIdx.x;
  const int row = t / nk, k = t - row * nk;
  if (row < nr) {
    const int s = (r0 + row) / n_cand - b0;       // the row's scenario
    const int sk = s * nk + k;
    const bool term = k == n_h;
    const float* zr = zs + row * nvar;
    const float* us = zr + NX * nk;
    const float len = hd[SC_LENGTH], trust = hd[SC_S_TRUST];
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = zr[NX * k + i];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = term ? 0.f : us[NU * k + i];
    TrackPoint tp;
    track_eval(tb, D::T_PTBL, nseg, x[S_IDX], tp);

    // objective
    const float mani = sm[L.mani + sk];
    float qc, ql, qo;
    sched_weights(hd, sm[L.sel + sk], mani, qc, ql, qo);
    const float qck = term ? hd[SC_Q_C_N_MULT] * qc : qc;
    const float dv = x[VS_IDX] - desired_velocity(hd, x[S_IDX]);
    const float* pe = sm + L.pos + sk * 3;
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
    const float* rc = sm + L.rot + sk * 9;
    float rbar[9], lg[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        rbar[3 * i + j] = tp.r[i] * rc[j] + tp.r[3 + i] * rc[3 + j]
                          + tp.r[6 + i] * rc[6 + j];
    log_rot_vec(rbar, lg);
    const float log2 = lg[0] * lg[0] + lg[1] * lg[1] + lg[2] * lg[2];
    float obj = qck * cont2 + ql * lag2 + hd[SC_Q_VS] * dv * dv + qo * log2
                - hd[SC_Q_SING] * mani;
    if (!term) {
      float dq2 = 0.f, dd2 = 0.f;
#pragma unroll
      for (int j = 0; j < DOF; ++j) {
        dq2 += u[j] * u[j];
        const float d = k >= 1 ? u[j] - us[NU * (k - 1) + j] : 0.f;
        dd2 += d * d;
      }
      obj += hd[SC_R_DQ] * dq2 + hd[SC_R_DVS] * u[DVS_IDX] * u[DVS_IDX];
      if (k >= 1) obj += hd[SC_R_DDQ] * dd2;
    }

    // violation: state box (s row: trust region around this knot's s)
    float vio = 0.f;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float hi = hd[D::T_XU + i], lo = hd[D::T_XL + i];
      if (i == S_IDX) {
        hi = nmin(x[i] + trust, len);
        lo = nmax(x[i] - trust, 0.f);
      }
      vio += nmax(lo - x[i], 0.f) + nmax(x[i] - hi, 0.f);
    }
    if (!term) {
      // dynamics defect of k -> k+1 (rows l = u = 0)
      const float* xn = zr + NX * (k + 1);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        vio += fabsf((xn[i] - dyn_pred_row<D>(hd, x, u, i))
                     * (1.f / hd[D::T_TX + i]));
      // input box, ddq rate rows (at k = 0 against the current input)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        vio += nmax(hd[D::T_UL + j] - u[j], 0.f)
               + nmax(u[j] - hd[D::T_UU + j], 0.f);
#pragma unroll
      for (int j = 0; j < DOF; ++j) {
        const float prev = k == 0 ? cus[s * NU + j] : us[NU * (k - 1) + j];
        const float rate = (u[j] - prev) / ts;
        vio += nmax(hd[D::T_DDQL + j] - rate, 0.f)
               + nmax(rate - hd[D::T_DDQU + j], 0.f);
      }
      // polytopic rows, one-sided (upper 0, lower -inf); the knot's
      // gradient rows straight from global memory (one thread reads each;
      // the scenario's other candidates find them in L1)
      const size_t bk = bk0 + sk;
      const float* env = sm + L.env + sk * NL;
      const float sel = sm[L.sel + sk], rad = sm[L.rad + s];
#pragma unroll
      for (int p = 0; p < NPC; ++p) {
        const float* d = p == 0 ? rb.dsel + bk * DOF
                         : p == 1 ? rb.dmani + bk * DOF
                                  : rb.denv + (bk * NL + p - 2) * DOF;
        float lin = 0.f;
#pragma unroll
        for (int j = 0; j < DOF; ++j) lin += poly_d(__ldg(d + j), p) * u[j];
        vio += nmax(-lin + rbf(poly_h(hd, sel, mani, env, rad, p)), 0.f);
      }
    }
    sm[L.pobj + t] = obj;
    sm[L.pvio + t] = vio;
  }
  __syncthreads();

  // ---- one thread a row: the row's knot terms summed in knot order
  if (t < nr) {
    const float* po = sm + L.pobj + t * nk;
    const float* pv = sm + L.pvio + t * nk;
    float obj = 0.f, vio = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      obj += po[kk];
      vio += pv[kk];
    }
    obj_out[r0 + t] = obj;
    vio_out[r0 + t] = vio;
  }
}

// The launch of K2 (kernel 2) or K3 (kernel 3) for one system: {scenarios
// a block (K3: the scenarios a block's rows span, at most), rows a block
// (K2: scenarios), threads, shared bytes, blocks}; false when no launch
// fits.
template <class D>
bool geometry(int kernel, int n_h, int n_cand, int batch, int g[5]) {
  if (n_h < 1 || batch < 0) return false;
  if (kernel == 2) {
    const int s = k2_scenarios<D>(n_h);
    if (s == 0) return false;
    g[0] = s;
    g[1] = s;
    g[2] = K2_THREADS;
    g[3] = K2Layout<D>(n_h, s).total * (int)sizeof(float);
    g[4] = (batch + s - 1) / s;
    return true;
  }
  if (kernel == 3 && n_cand >= 1) {
    int rows = 0, ns = 0, threads = 0;
    if (!k3_geometry<D>(n_h, n_cand, rows, ns, threads)) return false;
    g[0] = ns;
    g[1] = rows;
    g[2] = threads;
    g[3] = K3Layout<D>(n_h, rows, ns).total * (int)sizeof(float);
    g[4] = (batch * n_cand + rows - 1) / rows;
    return true;
  }
  return false;
}

template <class D>
int assembly(const float* z, const float* cu, const Robot& rb,
             const float* tables, const AsmOut& out, int batch, int n_h,
             int nseg, float ts, float jr_sign, cudaStream_t st) {
  int g[5];
  if (!geometry<D>(2, n_h, 1, batch, g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  assembly_kernel<D><<<g[4], g[2], g[3], st>>>(
      z, cu, rb, tables, out, batch, n_h, nseg, ts, jr_sign, g[0]);
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int eval_point(const float* z, const float* cu, const Robot& rb,
               const float* tables, float* obj, float* vio, int batch,
               int n_cand, int n_h, int nseg, float ts, cudaStream_t st) {
  int g[5];
  if (!geometry<D>(3, n_h, n_cand, batch, g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  eval_kernel<D><<<g[4], g[2], g[3], st>>>(
      z, cu, rb, tables, obj, vio, batch, n_cand, n_h, nseg, ts, g[1], g[0]);
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch_config(int kernel, int n_h, int n_cand, int batch, int* out) {
  int g[5];
  if (!geometry<D>(kernel, n_h, n_cand, batch, g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  const void* fn = kernel == 2
      ? reinterpret_cast<const void*>(assembly_kernel<D>)
      : reinterpret_cast<const void*>(eval_kernel<D>);
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, g[2],
                                                      g[3]);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 5; ++i) out[i] = g[i];
  out[5] = blocks;
  out[6] = fa.numRegs;
  out[7] = static_cast<int>(fa.localSizeBytes);
  out[8] = sms;
  return 0;
}

}  // namespace

// system: the base_dof of the system's instantiation (0 Panda, 3
// Husky+Panda); -1 for an unknown system.
extern "C" int mpcc_assembly_table_len(int system, int nseg) {
  if (system == 0) return Panda::table_len(nseg);
  if (system == 3) return HuskyPanda::table_len(nseg);
  return -1;
}

// How K2 (kernel 2) or K3 (kernel 3) launches for `system` at horizon n_h,
// n_cand candidates a scenario (K3) and `batch` scenarios: out[9] =
// {scenarios a block, rows a block, threads a block, shared bytes a block,
// blocks, blocks an SM holds at once, registers a thread, local-memory
// (stack and spill) bytes a thread, SMs on the card}.  Returns a
// cudaError_t (cudaErrorInvalidValue where no launch fits).
extern "C" int mpcc_assembly_launch_config(int kernel, int system, int n_h,
                                           int n_cand, int batch, int* out) {
  if (system == 0)
    return launch_config<Panda>(kernel, n_h, n_cand, batch, out);
  if (system == 3)
    return launch_config<HuskyPanda>(kernel, n_h, n_cand, batch, out);
  return static_cast<int>(cudaErrorInvalidValue);
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
  const Robot rb{ee_pos, ee_rot, jv, jw, mani, dmani, sel, dsel, env, denv,
                 radius};
  const AsmOut out{hxx, huu, gx, gu, gxu, e, dxu, dxl, duu, dul, dru, drl,
                   dp, cpx, cpu};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0)
    return assembly<Panda>(z, cu, rb, tables, out, batch, n_h, nseg, ts,
                           jr_sign, st);
  if (system == 3)
    return assembly<HuskyPanda>(z, cu, rb, tables, out, batch, n_h, nseg, ts,
                                jr_sign, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mpcc_eval_point(
    const float* z, const float* cu, const float* ee_pos, const float* ee_rot,
    const float* mani, const float* dmani, const float* sel,
    const float* dsel, const float* env, const float* denv,
    const float* radius, const float* tables, float* obj, float* vio,
    int system, int batch, int n_cand, int n_h, int nseg, float ts,
    void* stream) {
  const Robot rb{ee_pos, ee_rot, nullptr, nullptr, mani, dmani, sel, dsel,
                 env, denv, radius};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (system == 0)
    return eval_point<Panda>(z, cu, rb, tables, obj, vio, batch, n_cand, n_h,
                             nseg, ts, st);
  if (system == 3)
    return eval_point<HuskyPanda>(z, cu, rb, tables, obj, vio, batch, n_cand,
                                  n_h, nseg, ts, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
