// K1: the whole structured interior-point QP solve of one SQP iteration --
// Newton loop, backward Riccati sweep, forward rollout, slack/dual targets,
// fraction-to-boundary, adaptive centering, convergence test -- in one
// launch.
//
// Replaces the TPU kernel `_ipm_kernel` in
// mpcc_manipulator_tpu/solver/qp_ipm_pallas.py (entry `solve_qp_ipm_pallas`
// -> `_solve_batched`), adaptive scheme with warm start.  Algorithm:
// `solve_qp_ipm_s` of mpcc_manipulator_tpu/solver/qp_ipm.py on the StageQPK
// blocks (the plain version is solver/qp_ipm.py of this package).
//
// What bounds it on the H100: latency.  One scenario's solve is a chain of
// ~9 Newton iterations x 10 dependent Riccati stages of 17x17 / 8x8 work
// (~0.2 Mflop per iteration); the 1024 scenarios of a tick are independent.
// Nothing is bandwidth-bound: the inputs of one scenario are ~25 KB, read
// from L2 a few times per iteration.
//
// Design: one thread block (128 threads) per scenario.  The iterates
// (s, lambda, w, r rows, gains, dx/du, P) live in shared memory (~28 KB at
// N=10, so several blocks share an SM); the stage loop runs in order inside
// the block and each stage's 17x17 / 8x8 products are spread over the
// threads.  Blocks are independent, so a block leaves its Newton loop when
// its own scenario converges: that is the per-lane freeze of
// vmap(while_loop) without masks.  The TPU kernel's (stage, flat, B) refs
// and one-hot masks were Mosaic constraints and are not carried over.
// The 8x8 Cholesky runs on one thread, the 18 triangular solves on 18
// threads, the forward rollout on one warp.
//
// Layouts (row-major, batch-first; N = stages, nc = 59 rows per stage in
// the group order [xu | xl | uu | ul | ru | rl | p]):
//   hxx (B,N+1,9,9) hux (B,N,8,9) huu (B,N,8,8) r2 (B,N,7) gx (B,N+1,9)
//   gu (B,N,8) gxu (B,N,7) e (B,N,9) bd (B,9,8) a_sv (B) tx (B,9) tu (B,8)
//   tr (B,7) d (B,N,59) cpx (B,N,11,9) cpu (B,N,11,8) s0/lam0 (B,N,59)
//   -> dx (B,N+1,17) du (B,N,8) lam/s (B,N,59) iters/solved (B) int, mu (B)

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int NX = 9, NU = 8, DOF = 7, NPC = 11;
constexpr int NXT = NX + NU;                            // 17
constexpr int NC = 2 * NX + 2 * NU + 2 * DOF + NPC;     // 59
constexpr int S_IDX = NX - 2, VS_IDX = NX - 1;
constexpr int O_XU = 0, O_XL = NX, O_UU = 2 * NX, O_UL = 2 * NX + NU;
constexpr int O_RU = 2 * NX + 2 * NU, O_RL = O_RU + DOF, O_P = O_RL + DOF;
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr float FRAC_TO_BOUNDARY = 0.995f;

struct Inputs {
  const float *hxx, *hux, *huu, *r2, *gx, *gu, *gxu, *e, *bd, *a_sv, *tx,
      *tu, *tr, *d, *cpx, *cpu, *s0, *lam0;
};
struct Outputs {
  float *dx, *du, *lam, *s;
  int *iters, *solved;
  float* mu;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;   // propagates NaN like jnp.min
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ int finitef(float x) {
  return fabsf(x) <= 3.402823466e38f;   // false for NaN and +-inf
}

// Block-wide reductions; every thread gets the result.  `red` holds
// NWARPS floats; the leading barrier protects it from its previous use.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARPS; ++w) r += red[w];
  return r;
}
__device__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARPS; ++w) r = nan_min(r, red[w]);
  return r;
}
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

// C z for every stage row (group order) from the iterate (dx, du).
__device__ void row_products(int n_st, const float* dx, const float* du,
                             const float* tx, const float* tu,
                             const float* tr, const float* cpx,
                             const float* cpu, float* cz) {
  for (int idx = threadIdx.x; idx < n_st * NC; idx += THREADS) {
    const int k = idx / NC, row = idx % NC;
    float v;
    if (row < O_XL) {
      v = tx[row] * dx[(k + 1) * NXT + row];
    } else if (row < O_UU) {
      v = -(tx[row - O_XL] * dx[(k + 1) * NXT + row - O_XL]);
    } else if (row < O_UL) {
      v = tu[row - O_UU] * du[k * NU + row - O_UU];
    } else if (row < O_RU) {
      v = -(tu[row - O_UL] * du[k * NU + row - O_UL]);
    } else if (row < O_RL) {
      const int j = row - O_RU;
      v = tr[j] * (du[k * NU + j] - dx[k * NXT + NX + j]);
    } else if (row < O_P) {
      const int j = row - O_RL;
      v = -(tr[j] * (du[k * NU + j] - dx[k * NXT + NX + j]));
    } else {
      const int r = row - O_P;
      const float* cx = cpx + ((size_t)k * NPC + r) * NX;
      const float* cu = cpu + ((size_t)k * NPC + r) * NU;
      float acc = 0.f;
      for (int j = 0; j < NX; ++j) acc += cx[j] * dx[k * NXT + j];
      float acc_u = 0.f;
      for (int j = 0; j < NU; ++j) acc_u += cu[j] * du[k * NU + j];
      v = acc + acc_u;
    }
    cz[idx] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
ipm_kernel(Inputs in, Outputs out, int n_st, int max_iter, float eps_ipm) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nr = n_st * NC;

  // ---- shared-memory carve-up (floats)
  float* s_s = sm;                    // slacks          (N, NC)
  float* s_lam = s_s + nr;            // duals
  float* s_w = s_lam + nr;            // lam / s
  float* s_r = s_w + nr;              // g rows, later ds
  float* s_d = s_r + nr;              // row offsets
  float* s_cz = s_d + nr;             // C z, later dlam
  float* s_k = s_cz + nr;             // gains           (N, NU, NXT)
  float* s_kff = s_k + n_st * NU * NXT;   // feed-forwards (N, NU)
  float* s_dx = s_kff + n_st * NU;    // iterate dx      (N+1, NXT)
  float* s_du = s_dx + (n_st + 1) * NXT;  // iterate du  (N, NU)
  float* s_dxt = s_du + n_st * NU;    // target dx
  float* s_dut = s_dxt + (n_st + 1) * NXT;
  float* s_p = s_dut + n_st * NU;     // cost-to-go P    (NXT, NXT)
  float* s_pv = s_p + NXT * NXT;      // cost-to-go p    (NXT)
  float* s_q = s_pv + NXT;            // Q -> q_bar      (NXT, NXT)
  float* s_sb = s_q + NXT * NXT;      // S -> s_bar      (NU, NXT)
  float* s_rb = s_sb + NU * NXT;      // R -> r_bar -> L (NU, NU)
  float* s_gq = s_rb + NU * NU;       // gq -> qx_bar    (NXT)
  float* s_gu = s_gq + NXT;           // gu -> ru_bar    (NU)
  float* s_pa = s_gu + NU;            // (P At)[:, :NX]  (NXT, NX)
  float* s_pb = s_pa + NXT * NX;      // P Bt            (NXT, NU)
  float* s_m = s_pb + NXT * NU;       // p + P e         (NXT)
  float* s_bd = s_m + NXT;            // (NX, NU)
  float* s_tx = s_bd + NX * NU;
  float* s_tu = s_tx + NX;
  float* s_tr = s_tu + NU;
  float* s_red = s_tr + DOF;          // reduction scratch (NWARPS)

  // ---- this scenario's inputs
  const float* hxx = in.hxx + (size_t)b * (n_st + 1) * NX * NX;
  const float* hux = in.hux + (size_t)b * n_st * NU * NX;
  const float* huu = in.huu + (size_t)b * n_st * NU * NU;
  const float* r2 = in.r2 + (size_t)b * n_st * DOF;
  const float* gx = in.gx + (size_t)b * (n_st + 1) * NX;
  const float* gu = in.gu + (size_t)b * n_st * NU;
  const float* gxu = in.gxu + (size_t)b * n_st * DOF;
  const float* e = in.e + (size_t)b * n_st * NX;
  const float* cpx = in.cpx + (size_t)b * n_st * NPC * NX;
  const float* cpu = in.cpu + (size_t)b * n_st * NPC * NU;
  const float a_sv = in.a_sv[b];

  for (int i = tid; i < nr; i += THREADS) {
    s_s[i] = in.s0[(size_t)b * nr + i];
    s_lam[i] = in.lam0[(size_t)b * nr + i];
    s_d[i] = in.d[(size_t)b * nr + i];
  }
  for (int i = tid; i < NX * NU; i += THREADS) s_bd[i] = in.bd[(size_t)b * NX * NU + i];
  if (tid < NX) s_tx[tid] = in.tx[(size_t)b * NX + tid];
  if (tid < NU) s_tu[tid] = in.tu[(size_t)b * NU + tid];
  if (tid < DOF) s_tr[tid] = in.tr[(size_t)b * DOF + tid];
  for (int i = tid; i < (n_st + 1) * NXT; i += THREADS) s_dx[i] = 0.f;
  for (int i = tid; i < n_st * NU; i += THREADS) s_du[i] = 0.f;
  __syncthreads();

  const float m_act = (float)nr;
  float part = 0.f;
  for (int i = tid; i < nr; i += THREADS) part += s_s[i] * s_lam[i];
  float mu = block_sum(part, s_red) / m_act;

  int it = 0;
  while (it < max_iter) {
    // ---- A. w = lam / s_safe; g rows r = w (s - d) + mu / s_safe
    for (int i = tid; i < nr; i += THREADS) {
      const float ss = fmaxf(s_s[i], 1e-10f);
      const float w = s_lam[i] / ss;
      s_w[i] = w;
      s_r[i] = w * (s_s[i] - s_d[i]) + mu / ss;
    }
    __syncthreads();

    // ---- B. terminal boundary: knot N cost + its state-box rows
    {
      const float* wl = s_w + (n_st - 1) * NC;
      const float* rl = s_r + (n_st - 1) * NC;
      for (int idx = tid; idx < NXT * NXT; idx += THREADS) {
        const int i = idx / NXT, j = idx % NXT;
        float v = 0.f;
        if (i < NX && j < NX) {
          v = hxx[(size_t)n_st * NX * NX + i * NX + j];
          if (i == j) v += s_tx[i] * s_tx[i] * (wl[O_XU + i] + wl[O_XL + i]);
        }
        s_p[idx] = v;
      }
      if (tid < NXT)
        s_pv[tid] = tid < NX ? gx[n_st * NX + tid]
                                   + s_tx[tid] * (rl[O_XU + tid] - rl[O_XL + tid])
                             : 0.f;
    }
    __syncthreads();

    // ---- C. backward Riccati sweep
    for (int k = n_st - 1; k >= 0; --k) {
      const float* wk = s_w + k * NC;
      const float* rk = s_r + k * NC;
      const bool on_x = k >= 1;
      const float* wp = s_w + (k - 1) * NC;   // state box of knot k
      const float* rp = s_r + (k - 1) * NC;
      const float* cxk = cpx + (size_t)k * NPC * NX;
      const float* cuk = cpu + (size_t)k * NPC * NU;
      const float* ek = e + k * NX;

      // C1. stage blocks H + C' diag(w) C, g + C' r  |  P At, P Bt, p + P e
      for (int idx = tid; idx < NXT * NXT; idx += THREADS) {
        const int i = idx / NXT, j = idx % NXT;
        float v = 0.f;
        if (i < NX && j < NX) {
          v = hxx[(size_t)k * NX * NX + i * NX + j];
          if (i == j && on_x)
            v += s_tx[i] * s_tx[i] * (wp[O_XU + i] + wp[O_XL + i]);
          for (int r = 0; r < NPC; ++r)
            v += cxk[r * NX + i] * wk[O_P + r] * cxk[r * NX + j];
        } else if (i >= NX && j >= NX && i == j && i - NX < DOF) {
          const int u = i - NX;
          v = r2[k * DOF + u]
              + s_tr[u] * s_tr[u] * (wk[O_RU + u] + wk[O_RL + u]);
        }
        s_q[idx] = v;
      }
      for (int idx = tid; idx < NU * NXT; idx += THREADS) {
        const int u = idx / NXT, j = idx % NXT;
        float v = 0.f;
        if (j < NX) {
          v = hux[(size_t)k * NU * NX + u * NX + j];
          for (int r = 0; r < NPC; ++r)
            v += cuk[r * NU + u] * wk[O_P + r] * cxk[r * NX + j];
        } else if (j - NX == u && u < DOF) {
          v = -(r2[k * DOF + u]
                + s_tr[u] * s_tr[u] * (wk[O_RU + u] + wk[O_RL + u]));
        }
        s_sb[idx] = v;
      }
      for (int idx = tid; idx < NU * NU; idx += THREADS) {
        const int u = idx / NU, v2 = idx % NU;
        float v = huu[(size_t)k * NU * NU + idx];
        if (u == v2) {
          v += s_tu[u] * s_tu[u] * (wk[O_UU + u] + wk[O_UL + u]);
          if (u < DOF) v += s_tr[u] * s_tr[u] * (wk[O_RU + u] + wk[O_RL + u]);
        }
        for (int r = 0; r < NPC; ++r)
          v += cuk[r * NU + u] * wk[O_P + r] * cuk[r * NU + v2];
        s_rb[idx] = v;
      }
      if (tid < NXT) {
        float v;
        if (tid < NX) {
          v = gx[k * NX + tid];
          if (on_x) v += s_tx[tid] * (rp[O_XU + tid] - rp[O_XL + tid]);
          for (int r = 0; r < NPC; ++r) v += cxk[r * NX + tid] * rk[O_P + r];
        } else if (tid - NX < DOF) {
          const int u = tid - NX;
          v = gxu[k * DOF + u] - s_tr[u] * (rk[O_RU + u] - rk[O_RL + u]);
        } else {
          v = 0.f;
        }
        s_gq[tid] = v;
      } else if (tid >= 32 && tid < 32 + NU) {
        const int u = tid - 32;
        float v = gu[k * NU + u] + s_tu[u] * (rk[O_UU + u] - rk[O_UL + u]);
        if (u < DOF) v += s_tr[u] * (rk[O_RU + u] - rk[O_RL + u]);
        for (int r = 0; r < NPC; ++r) v += cuk[r * NU + u] * rk[O_P + r];
        s_gu[u] = v;
      }
      for (int idx = tid; idx < NXT * NX; idx += THREADS) {
        const int i = idx / NX, j = idx % NX;
        float v = s_p[i * NXT + j];
        if (j == VS_IDX) v += a_sv * s_p[i * NXT + S_IDX];
        s_pa[idx] = v;
      }
      for (int idx = tid; idx < NXT * NU; idx += THREADS) {
        const int i = idx / NU, u = idx % NU;
        float v = 0.f;
        for (int j = 0; j < NX; ++j) v += s_p[i * NXT + j] * s_bd[j * NU + u];
        s_pb[idx] = v + s_p[i * NXT + NX + u];
      }
      if (tid >= 64 && tid < 64 + NXT) {
        const int i = tid - 64;
        float v = 0.f;
        for (int j = 0; j < NX; ++j) v += s_p[i * NXT + j] * ek[j];
        s_m[i] = s_pv[i] + v;
      }
      __syncthreads();

      // C2. q_bar, s_bar, r_bar, qx_bar, ru_bar (in place)
      for (int idx = tid; idx < NX * NX; idx += THREADS) {
        const int i = idx / NX, j = idx % NX;
        float v = s_pa[i * NX + j];
        if (i == VS_IDX) v += a_sv * s_pa[S_IDX * NX + j];
        s_q[i * NXT + j] += v;
      }
      for (int idx = tid; idx < NU * NX; idx += THREADS) {
        const int u = idx / NX, j = idx % NX;
        float v = 0.f;
        for (int i = 0; i < NX; ++i) v += s_bd[i * NU + u] * s_pa[i * NX + j];
        s_sb[u * NXT + j] += v + s_pa[(NX + u) * NX + j];
      }
      for (int idx = tid; idx < NU * NU; idx += THREADS) {
        const int u = idx / NU, v2 = idx % NU;
        float v = 0.f;
        for (int i = 0; i < NX; ++i) v += s_bd[i * NU + u] * s_pb[i * NU + v2];
        s_rb[idx] += v + s_pb[(NX + u) * NU + v2] + (u == v2 ? 1e-9f : 0.f);
      }
      if (tid >= 96 && tid < 96 + NX) {
        const int i = tid - 96;
        float v = s_m[i];
        if (i == VS_IDX) v += a_sv * s_m[S_IDX];
        s_gq[i] += v;
      } else if (tid >= 112 && tid < 112 + NU) {
        const int u = tid - 112;
        float v = 0.f;
        for (int i = 0; i < NX; ++i) v += s_bd[i * NU + u] * s_m[i];
        s_gu[u] += v + s_m[NX + u];
      }
      __syncthreads();

      // C3. Cholesky of r_bar (NaN on a non-PD pivot, like the reference)
      if (tid == 0) {
        for (int j = 0; j < NU; ++j) {
          const float dg = sqrtf(s_rb[j * NU + j]);
          for (int i = j; i < NU; ++i) s_rb[i * NU + j] /= dg;
          for (int i = j + 1; i < NU; ++i)
            for (int l = j + 1; l <= i; ++l)
              s_rb[i * NU + l] -= s_rb[i * NU + j] * s_rb[l * NU + j];
        }
      }
      __syncthreads();

      // C4. [K | k_ff] = -(L L')^-1 [s_bar | ru_bar], one column per thread
      if (tid <= NXT) {
        float y[NU];
        for (int i = 0; i < NU; ++i) {
          float acc = tid < NXT ? s_sb[i * NXT + tid] : s_gu[i];
          for (int j = 0; j < i; ++j) acc -= s_rb[i * NU + j] * y[j];
          y[i] = acc / s_rb[i * NU + i];
        }
        for (int i = NU - 1; i >= 0; --i) {
          float acc = y[i];
          for (int j = i + 1; j < NU; ++j) acc -= s_rb[j * NU + i] * y[j];
          y[i] = acc / s_rb[i * NU + i];
        }
        for (int i = 0; i < NU; ++i) {
          if (tid < NXT) s_k[(k * NU + i) * NXT + tid] = -y[i];
          else s_kff[k * NU + i] = -y[i];
        }
      }
      __syncthreads();

      // C5. P <- sym(q_bar + s_bar' K),  p <- qx_bar + s_bar' k_ff
      const float* kg = s_k + k * NU * NXT;
      const float* kf = s_kff + k * NU;
      for (int idx = tid; idx < NXT * NXT; idx += THREADS) {
        const int i = idx / NXT, j = idx % NXT;
        float a = s_q[i * NXT + j], c = s_q[j * NXT + i];
        for (int u = 0; u < NU; ++u) {
          a += s_sb[u * NXT + i] * kg[u * NXT + j];
          c += s_sb[u * NXT + j] * kg[u * NXT + i];
        }
        s_p[idx] = 0.5f * (a + c);
      }
      if (tid >= THREADS - NXT) {
        const int i = tid - (THREADS - NXT);
        float v = s_gq[i];
        for (int u = 0; u < NU; ++u) v += s_sb[u * NXT + i] * kf[u];
        s_pv[i] = v;
      }
      __syncthreads();
    }

    // ---- D. forward rollout of the targets (one warp)
    if (tid < 32) {
      if (tid < NXT) s_dxt[tid] = 0.f;
      __syncwarp();
      for (int k = 0; k < n_st; ++k) {
        const float* xk = s_dxt + k * NXT;
        if (tid < NU) {
          float v = 0.f;
          for (int j = 0; j < NXT; ++j) v += s_k[(k * NU + tid) * NXT + j] * xk[j];
          v += s_kff[k * NU + tid];
          s_dut[k * NU + tid] = v;
          s_dxt[(k + 1) * NXT + NX + tid] = v;
        }
        __syncwarp();
        if (tid < NX) {
          float v = xk[tid];
          if (tid == S_IDX) v += a_sv * xk[VS_IDX];
          float bu = 0.f;
          for (int u = 0; u < NU; ++u) bu += s_bd[tid * NU + u] * s_dut[k * NU + u];
          s_dxt[(k + 1) * NXT + tid] = v + bu + e[k * NX + tid];
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- E. slack/dual targets and fraction-to-boundary step lengths
    row_products(n_st, s_dxt, s_dut, s_tx, s_tu, s_tr, cpx, cpu, s_cz);
    __syncthreads();
    float rp_min = INFINITY, rd_min = INFINITY;
    for (int i = tid; i < nr; i += THREADS) {
      const float sv = s_s[i], lv = s_lam[i], dv = s_d[i], cz = s_cz[i];
      const float ss = fmaxf(sv, 1e-10f);
      const float ds = (dv - cz) - sv;
      const float dl = (mu / ss + s_w[i] * (cz + sv - dv)) - lv;
      s_r[i] = ds;
      s_cz[i] = dl;
      if (ds < -1e-12f) rp_min = nan_min(rp_min, -sv / ds);
      if (dl < -1e-12f) rd_min = nan_min(rd_min, -lv / dl);
    }
    const float alpha_p = fminf(1.f, FRAC_TO_BOUNDARY * block_min(rp_min, s_red));
    const float alpha_d = fminf(1.f, FRAC_TO_BOUNDARY * block_min(rd_min, s_red));

    // ---- F. take the step unless any updated value is non-finite
    int ok = 1;
    for (int i = tid; i < (n_st + 1) * NXT; i += THREADS)
      ok &= finitef(s_dx[i] + alpha_p * (s_dxt[i] - s_dx[i]));
    for (int i = tid; i < n_st * NU; i += THREADS)
      ok &= finitef(s_du[i] + alpha_p * (s_dut[i] - s_du[i]));
    for (int i = tid; i < nr; i += THREADS)
      ok &= finitef(s_s[i] + alpha_p * s_r[i])
            & finitef(s_lam[i] + alpha_d * s_cz[i]);
    const bool finite = __syncthreads_and(ok) != 0;
    if (finite) {
      for (int i = tid; i < (n_st + 1) * NXT; i += THREADS)
        s_dx[i] = s_dx[i] + alpha_p * (s_dxt[i] - s_dx[i]);
      for (int i = tid; i < n_st * NU; i += THREADS)
        s_du[i] = s_du[i] + alpha_p * (s_dut[i] - s_du[i]);
      for (int i = tid; i < nr; i += THREADS) {
        s_s[i] = s_s[i] + alpha_p * s_r[i];
        s_lam[i] = s_lam[i] + alpha_d * s_cz[i];
      }
    }
    __syncthreads();

    // ---- G. convergence / divergence bookkeeping on the updated iterate
    row_products(n_st, s_dx, s_du, s_tx, s_tu, s_tr, cpx, cpu, s_cz);
    __syncthreads();
    float rmax = 0.f, sl = 0.f;
    for (int i = tid; i < nr; i += THREADS) {
      rmax = nan_max(rmax, fabsf(s_cz[i] + s_s[i] - s_d[i]));
      sl += s_s[i] * s_lam[i];
    }
    const float r_ineq = block_max(rmax, s_red);
    const float mu_post = block_sum(sl, s_red) / m_act;
    const float alpha_min = fminf(alpha_p, alpha_d);
    const float om = 1.f - alpha_min;
    const float sigma = fminf(fmaxf(om * om, 0.1f), 0.8f);
    mu = fmaxf(sigma * mu_post, 0.01f * eps_ipm);
    ++it;
    const bool conv = (mu_post < eps_ipm) && (r_ineq < 2e-4f);
    const bool diverged = !finite || (mu_post > 1e6f);
    if (conv || diverged) break;
  }

  // ---- final verdict on the returned iterate
  row_products(n_st, s_dx, s_du, s_tx, s_tu, s_tr, cpx, cpu, s_cz);
  __syncthreads();
  float rmax = 0.f, sl = 0.f;
  for (int i = tid; i < nr; i += THREADS) {
    rmax = nan_max(rmax, fabsf(s_cz[i] + s_s[i] - s_d[i]));
    sl += s_s[i] * s_lam[i];
  }
  const float r_fin = block_max(rmax, s_red);
  const float mu_fin = block_sum(sl, s_red) / m_act;

  for (int i = tid; i < (n_st + 1) * NXT; i += THREADS)
    out.dx[(size_t)b * (n_st + 1) * NXT + i] = s_dx[i];
  for (int i = tid; i < n_st * NU; i += THREADS)
    out.du[(size_t)b * n_st * NU + i] = s_du[i];
  for (int i = tid; i < nr; i += THREADS) {
    out.lam[(size_t)b * nr + i] = s_lam[i];
    out.s[(size_t)b * nr + i] = s_s[i];
  }
  if (tid == 0) {
    out.iters[b] = it;
    out.solved[b] = (mu_fin < 10.f * eps_ipm) && (r_fin < 1e-3f);
    out.mu[b] = mu_fin;
  }
}

size_t smem_floats(int n_st) {
  const int nr = n_st * NC;
  return 6 * (size_t)nr + n_st * NU * NXT + n_st * NU
         + 2 * ((n_st + 1) * NXT + n_st * NU)
         + NXT * NXT + NXT + NXT * NXT + NU * NXT + NU * NU + NXT + NU
         + NXT * NX + NXT * NU + NXT + NX * NU + NX + NU + DOF + NWARPS;
}

}  // namespace

extern "C" int mpcc_ipm_solve(
    const float* hxx, const float* hux, const float* huu, const float* r2,
    const float* gx, const float* gu, const float* gxu, const float* e,
    const float* bd, const float* a_sv, const float* tx, const float* tu,
    const float* tr, const float* d, const float* cpx, const float* cpu,
    const float* s0, const float* lam0,
    float* dx, float* du, float* lam, float* s, int* iters, int* solved,
    float* mu, int batch, int n_st, int max_iter, float eps_ipm,
    void* stream) {
  if (batch <= 0) return 0;
  const size_t bytes = smem_floats(n_st) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ipm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Inputs in{hxx, hux, huu, r2, gx, gu, gxu, e, bd, a_sv, tx, tu, tr,
            d, cpx, cpu, s0, lam0};
  Outputs out{dx, du, lam, s, iters, solved, mu};
  ipm_kernel<<<batch, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      in, out, n_st, max_iter, eps_ipm);
  return static_cast<int>(cudaGetLastError());
}
