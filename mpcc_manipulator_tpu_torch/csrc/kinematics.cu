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

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
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
  const float* r_off = c;
  const float* p_off = c + 63;
  const float* r_post = c + 84;
  const float* p_post = c + 93;

  // ---- 1. FK chain: p += R p_off[i]; R_fixed = R R_off[i];
  // R = R_fixed Rz(q_i)
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
  const float mani = sqrtf(fmaxf(det, 0.f));
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

extern "C" const char* mpcc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
