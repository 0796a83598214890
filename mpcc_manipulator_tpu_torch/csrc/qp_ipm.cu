// K1: the whole structured interior-point QP solve of one SQP iteration --
// Newton loop, backward Riccati sweep(s), forward rollout, slack/dual
// targets, fraction-to-boundary, centering, convergence test -- in one
// launch, for both centering schemes.
//
// Replaces the TPU kernel `_ipm_kernel` in
// mpcc_manipulator_tpu/solver/qp_ipm_pallas.py:64 (entry
// `solve_qp_ipm_pallas` -> `_solve_batched`), both of its schemes, with warm
// start: "adaptive" (one fused matrix + vector sweep per Newton iteration)
// and "mehrotra" (the matrix sweep once per iteration, saving the
// factorization, then the affine probe and the corrector as vector-only
// sweeps against it).  Algorithm: `solve_qp_ipm_s` of
// mpcc_manipulator_tpu/solver/qp_ipm.py on the StageQPK blocks (the plain
// version is solver/qp_ipm.py of this package).
//
// What bounds it on the H100: neither flops nor bytes (~0.2 MFLOP and
// ~30 KB per scenario and Newton iteration) but the dependent chain of
// ~iterations x 10 Riccati stages (x 3 sweeps under Mehrotra), each a
// 17x17 / 8x8 step (23x23 / 11x11 for the Husky+Panda) whose parts wait on
// each other, and the shared-memory
// and shuffle traffic of the 8 chains an SM runs at once.
//
// One source, one instantiation per system: K1<BASE_DOF> derives every size,
// slot offset and scratch offset from the dims (the Panda, BASE_DOF = 0: nx
// 9, nu 8, dof 7, 59 rows a stage; the Husky+Panda, BASE_DOF = 3: nx 12, nu
// 11, dof 10, 77 rows), and the C entries take the system as an argument.
// The numbers below are the Panda's.
//
// Mapping: one warp (one 32-thread block) per scenario, so nothing in the
// solve needs a block barrier (only __syncwarp and shuffles), a scenario
// leaves its Newton loop when it converges, and the warp may hold up to
// 255 registers.  Per Newton iteration:
// * warp-parallel, stage after stage, before the sweep: the stage blocks
//   that do not depend on P -- H + C' diag(w) C as the upper halves of the
//   9x9 x-block and the 8x8 u-block, the 8x9 cross block and the 7 rate
//   diagonals, and (adaptive) the gradient rows g + C' r -- into a slot of
//   184 floats per stage in shared memory.  Each stage's C rows go through
//   a warp tile; the next stage's are loaded into registers meanwhile.
// * on the warp, stage by stage (warp-synchronous): P lives in registers,
//   lane j holding column j; P At and Bt' P are register-local (At is I plus
//   the a_sv coupling, Bt = [bd; I], P symmetric); sums over P's rows cross
//   lanes through shuffles or warp tiles read with 16-byte loads.  r_bar's
//   rows (lanes 0-7) go through a tile, and every lane factors the 8x8
//   Cholesky itself, right-looking, so that every lane holds L.  Lane c
//   solves column c of [s_bar | ru_bar] (c < 18): the forward half gives
//   Y = L^-1 s_bar, and P <- q_bar - Y'Y (= q_bar + s_bar' K, symmetric by
//   construction); the backward half gives K and k_ff.  K_k overwrites the
//   consumed blocks of stage k's slot; k_ff goes to its own array.
// * Mehrotra keeps, per stage, L, 1 / diag(L), s_bar's x-columns and
//   P_{k+1} e_k in a per-scenario global scratch the wrapper allocates (161
//   floats a stage, L2-resident): they do not fit the budget below.  Its
//   vector sweeps read them there.
// * warp-parallel over the 590 rows: w, the row products C z (a loop per
//   row group), the targets, the fraction-to-boundary minima, the step, the
//   convergence test.
//
// One-wave budget: 1024 scenarios on 132 SMs need 8 blocks an SM, so a
// block may use at most 28,160 B of shared memory (233,472 B an SM less
// 1 KB reserved a block) and 256 registers a thread (8,192 a scenario);
// the Panda's layout takes 26,592 B at N = 10.  `mpcc_ipm_launch_config`
// reports what the card gives: on an H100 80GB HBM3 at 700 W, 254
// registers, no local memory, 8 blocks an SM.  The sweep's row tiles and
// bd are kept at a row stride of nu rounded up to 4 floats, so that their
// rows load as 16-byte vectors at either system's dims.
//
// The Husky+Panda (WIDE): the Panda's layout at its dims
// takes 39,360 B at N = 10 (5 blocks an SM) and spills (255 registers).
// The changes below bring it to the budget.  They are selected at compile
// time from the dims, so the Panda's instantiation is the code above,
// unchanged, and both give the same results as before:
// * the stage slots (319 floats a stage, 12,768 B at N = 10) live in a
//   per-scenario global scratch (L2-resident, as Mehrotra's factorization).
//   The sweep reads each stage's slot from a one-slot stage buffer in
//   shared memory, which cp.async fills with stage k-1's slot while stage k
//   factors r_bar and updates P (the buffer is free once r_bar is formed);
//   the rollout loads K_{k+1}'s rows a stage ahead.  27,872 B at N = 10;
// * r_bar is factored across lanes 0-10, a row a lane, pivots and column
//   entries by shuffle (every lane holding L took 66 registers); L, with
//   1 / diag(L) on its diagonal, goes over the consumed P Bt tile, and the
//   triangular solves read its rows there as broadcasts;
// * P Bt and P e come before the x-blocks, so that P's columns die as
//   P At is formed;
// * the lane index is read afresh (fresh_lane) in the sweep and the row
//   loops, so that the compiler forms their lane-dependent addresses where
//   they are used instead of hoisting them out of the Newton loop, where
//   they stayed live across the kernel and spilled.
// The d, w and r rows stay in shared memory: they are read on every row
// loop, and the budget holds without moving them.  On an H100 80GB HBM3 at
// 700 W: 255 registers, no local memory, 8 blocks an SM.
//
// Layouts (row-major, batch-first; N = stages, nc = 2 nx + 2 nu + 2 dof +
// 11 rows per stage in the group order [xu | xl | uu | ul | ru | rl | p]):
//   hxx (B,N+1,nx,nx) hux (B,N,nu,nx) huu (B,N,nu,nu) r2 (B,N,dof)
//   gx (B,N+1,nx) gu (B,N,nu) gxu (B,N,dof) e (B,N,nx) bd (B,nx,nu) a_sv (B)
//   tx (B,nx) tu (B,nu) tr (B,dof) d (B,N,nc) cpx (B,N,11,nx)
//   cpu (B,N,11,nu) s0/lam0 (B,N,nc)
//   -> dx (B,N+1,nx+nu) du (B,N,nu) lam/s (B,N,nc) iters/solved (B) int,
//      mu (B)
//   scratch (B,N,STRIDE): the Panda's is Mehrotra's factorization (FACT =
//   161 floats a stage; none under adaptive centering); the Husky+Panda's
//   is its slot (320) and, under Mehrotra, the factorization (FACT = 287,
//   padded to 288): 320 or 608 floats a stage.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;                             // one warp
constexpr unsigned FULL = 0xffffffffu;
constexpr float FRAC_TO_BOUNDARY = 0.995f;
constexpr int SCHEME_ADAPTIVE = 0, SCHEME_MEHROTRA = 1;
// shared memory a block may take for 8 blocks an SM (the one-wave budget)
constexpr int SMEM_BUDGET = 28160;

// The type Mehrotra's saved factorization is held in: float, or double in
// the float64 builds of `python -m mpcc_manipulator_tpu_torch.probe_mehrotra`
// (-DMPCC_FACT_F64: r_bar factored again in float64 for it, and the vector
// sweeps' triangular solves against it run in float64).  The vector sweeps'
// own recursion runs in vsweep_t: float, or double with -DMPCC_VSWEEP_F64.
#ifdef MPCC_FACT_F64
using fact_t = double;
#else
using fact_t = float;
#endif
#ifdef MPCC_VSWEEP_F64
using vsweep_t = double;
#else
using vsweep_t = float;
#endif

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// 16 bytes global -> shared without registers (cp.async, L2 only), and the
// wait for this thread's copies; a __syncwarp then shows them to the warp.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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
// The lane index read from the hardware: the compiler cannot hoist it out
// of a loop, so addresses derived from it are formed where they are used
// instead of being held in registers across the whole kernel.
__device__ __forceinline__ int fresh_lane() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(l));
  return l;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One scenario's view: its inputs and the shared-memory carve-up.
struct Scn {
  const float *hxx, *hux, *huu, *r2, *gx, *gu, *gxu, *e, *cpx, *cpu;
  fact_t* fact;                // Mehrotra's factorization (N, FACT) or null
  float a_sv;
  int n_st, nr, lane;
  int stride;                  // scratch floats a stage (WIDE)
  float *s, *lam, *w, *r, *d, *cz;   // rows (N, NC)
  float *slot, *tp, *kff;            // stage slots, terminal, k_ff / du_t
  float* stage;                      // the sweep's stage buffer (WIDE)
  float *dx, *du, *dxt;              // iterate and target steps
  float *tile;                       // stage_blocks' tile, or:
  float *pb, *lt, *sbt;              // the sweep's warp tiles
  float *bd, *tx, *tu, *tr, *zero;
  int* code;                         // slot entry -> kind << 8 | a << 4 | b
};

// N floats from / to 16-byte aligned shared memory: float4 accesses, then
// the remainder one float at a time.
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int i = N / 4 * 4; i < N; ++i) v[i] = p[i];
}
template <int N>
__device__ __forceinline__ void stv(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
#pragma unroll
  for (int i = N / 4 * 4; i < N; ++i) p[i] = v[i];
}

// Gradient rows g = w (s - d) + rhs / s_safe into c.cz, for the
// complementarity right-hand side rhs: 0 (the affine probe), the barrier
// parameter mu (adaptive), or the rows of c.r (Mehrotra's corrector).
__device__ void gradient_rows(const Scn& c, int rhs_mode, float mu) {
  for (int i = c.lane; i < c.nr; i += THREADS) {
    const float sv = c.s[i];
    const float ss = fmaxf(sv, 1e-10f);
    const float rhs = rhs_mode == 0 ? 0.f : (rhs_mode == 1 ? mu : c.r[i]);
    c.cz[i] = c.w[i] * (sv - c.d[i]) + rhs / ss;
  }
  __syncwarp();
}

// Slack/dual targets of the Newton system with right-hand side rhs (mode
// as in gradient_rows) from the target row products in c.cz: ds into c.r,
// dlam into c.cz.  Returns the fraction-to-boundary step lengths.
__device__ float2 targets(const Scn& c, int rhs_mode, float mu) {
  float rp_min = INFINITY, rd_min = INFINITY;
  for (int i = c.lane; i < c.nr; i += THREADS) {
    const float sv = c.s[i], lv = c.lam[i], dv = c.d[i], cz = c.cz[i];
    const float ss = fmaxf(sv, 1e-10f);
    const float rhs = rhs_mode == 0 ? 0.f : (rhs_mode == 1 ? mu : c.r[i]);
    const float ds = (dv - cz) - sv;
    const float dl = (rhs / ss + c.w[i] * (cz + sv - dv)) - lv;
    c.r[i] = ds;
    c.cz[i] = dl;
    if (ds < -1e-12f) rp_min = nan_min(rp_min, -sv / ds);
    if (dl < -1e-12f) rd_min = nan_min(rd_min, -lv / dl);
  }
  __syncwarp();
  return make_float2(fminf(1.f, FRAC_TO_BOUNDARY * warp_min(rp_min)),
                     fminf(1.f, FRAC_TO_BOUNDARY * warp_min(rd_min)));
}

// One system's solve: the dims of a planar base of BASE_DOF joints (0 or
// 3) under the 7-joint arm with 11 polytopic rows, everything derived from
// them, and the device functions of the kernel at those dims.
template <int BASE_DOF>
struct K1 {
  static constexpr int DOF = BASE_DOF + 7, NX = DOF + 2, NU = DOF + 1;
  static constexpr int NPC = 11;
  static constexpr int NXT = NX + NU;                   // 17 (Panda)
  static constexpr int NC = 2 * NX + 2 * NU + 2 * DOF + NPC;   // 59
  static constexpr int S_IDX = NX - 2, VS_IDX = NX - 1;
  static constexpr int O_XU = 0, O_XL = NX, O_UU = 2 * NX, O_UL = 2 * NX + NU;
  static constexpr int O_RU = 2 * NX + 2 * NU, O_RL = O_RU + DOF,
                       O_P = O_RL + DOF;
  // row stride of bd and of the sweep's row tiles (16-byte rows)
  static constexpr int NUP = pad4(NU);

  // per-stage slot: upper halves of Q_xx (45) and R (36), S (8x9), the rate
  // diagonals r2 + tr^2 (w_ru + w_rl) (7), the gradient gq (16) and gu (8).
  // After the matrix sweep has consumed stage k, K_k (8x17) sits at offset
  // 0, over Q_xx, S and R only.
  static constexpr int Q_UP = NX * (NX + 1) / 2, R_UP = NU * (NU + 1) / 2;
  static constexpr int Q_OFF = 0, S_OFF = Q_UP, R_OFF = S_OFF + NU * NX;
  static constexpr int SRR_OFF = R_OFF + R_UP, GQ_OFF = SRR_OFF + DOF;
  static constexpr int GU_OFF = GQ_OFF + NX + DOF, SLOT = GU_OFF + NU;
  static constexpr int TP_FLOATS = Q_UP + NX;   // terminal P (upper) and p
  // warp tile: stage_blocks' C rows and C' diag(w) of one stage, or the
  // sweep's P Bt (17x8), r_bar / L (8x8) and Y (17x8)
  static constexpr int TILE = imax(2 * NPC * (NX + NU),
                                   NXT * NUP + NU * NUP + NXT * NUP);
  // Mehrotra's saved factorization, per stage: L (8x8), s_bar[:, :9] by
  // columns (9x8), P_{k+1} e_k (17), 1 / diag(L) (8)
  static constexpr int F_L = 0, F_SB = NU * NU, F_PE = F_SB + NX * NU;
  static constexpr int F_LINV = F_PE + NXT, FACT = F_LINV + NU;
  static_assert(NU * NXT <= SRR_OFF, "K_k must not overwrite the rate "
                "diagonals or the gradient of its slot");
  // WIDE: the Husky+Panda's dims, at which the Panda's layout leaves 5
  // blocks an SM at N = 10 and spills.  It selects the head note's
  // changes: the slots in the global scratch behind a stage buffer, r_bar
  // factored across lanes, and the lane read afresh.
  static constexpr bool WIDE = BASE_DOF != 0;
  // a slot's stride in the scratch (16-byte aligned for cp.async), and the
  // factorization's floats after it under Mehrotra
  static constexpr int SLOT_LD = pad4(SLOT);
  static constexpr int FACT_LD = pad4(FACT * (int)(sizeof(fact_t) / 4));
  static_assert(NU <= NXT, "L (NU rows) fits over the P Bt tile");
  static_assert(NXT < THREADS, "a lane per column of P, and one for k_ff");
  static_assert(NX < 16 && NU < 16, "slot entry codes pack indices in 4 bits");

  static __host__ __device__ constexpr int upx(int i, int j) {   // i <= j
    return i * NX - i * (i - 1) / 2 + (j - i);
  }
  static __host__ __device__ constexpr int upu(int i, int j) {
    return i * NU - i * (i - 1) / 2 + (j - i);
  }
  static __device__ __forceinline__ int symx(int i, int j) {
    return i <= j ? upx(i, j) : upx(j, i);
  }
  static __device__ __forceinline__ int symu(int i, int j) {
    return i <= j ? upu(i, j) : upu(j, i);
  }

  // Stage k's slot, and (Mehrotra) its saved factorization.
  static __device__ __forceinline__ float* slot_at(const Scn& c, int k) {
    if constexpr (WIDE) return c.slot + (size_t)k * c.stride;
    else return c.slot + k * SLOT;
  }
  static __device__ __forceinline__ fact_t* fact_at(const Scn& c, int k) {
    if constexpr (WIDE)
      return reinterpret_cast<fact_t*>(c.slot + (size_t)k * c.stride
                                       + SLOT_LD);
    else return c.fact + (size_t)k * FACT;
  }
  // Stage k's slot from the scratch into the stage buffer, as one cp.async
  // group (WIDE).
  static __device__ __forceinline__ void stage_slot(const Scn& c, int k) {
    const float* src = slot_at(c, k);
    for (int q = c.lane; q < SLOT_LD / 4; q += THREADS)
      cp_async16(c.stage + 4 * q, src + 4 * q);
    cp_async_commit();
  }

  // Slot entry e's kind and indices: Q_xx[a][b] (0), S[a][b] (1), R[a][b]
  // (2), the rate diagonal a (3), gq_x[a] (4), gq on the u_prev slot a (5),
  // gu[a] (6).
  static __device__ __forceinline__ void decode_entry(int e, int& kind, int& a,
                                               int& b) {
    b = 0;
    if (e < S_OFF) {
      int r = e, i = 0;
      while (r >= NX - i) { r -= NX - i; ++i; }
      kind = 0; a = i; b = i + r;
    } else if (e < R_OFF) {
      kind = 1; a = (e - S_OFF) / NX; b = (e - S_OFF) % NX;
    } else if (e < SRR_OFF) {
      int r = e - R_OFF, i = 0;
      while (r >= NU - i) { r -= NU - i; ++i; }
      kind = 2; a = i; b = i + r;
    } else if (e < GQ_OFF) {
      kind = 3; a = e - SRR_OFF;
    } else if (e < GQ_OFF + NX) {
      kind = 4; a = e - GQ_OFF;
    } else if (e < GU_OFF) {
      kind = 5; a = e - GQ_OFF - NX;
    } else {
      kind = 6; a = e - GU_OFF;
    }
  }

  // The stage blocks of every stage that do not depend on P, slot entries
  // [e_lo, e_hi): the matrix entries [0, GQ_OFF) of H + C' diag(w) C and the
  // gradient entries [GQ_OFF, SLOT) of g + C' g_rows (the rows in c.cz), with
  // the terminal P (matrix) and p (gradient).  Warp-parallel: lane l fills
  // the entries e_lo + l, e_lo + l + 32, ... of every stage (decoded once
  // per launch into c.code); each stage's C rows and C' diag(w) go through
  // the warp tile, and the next stage's C rows are loaded into registers
  // while this stage computes.
  static __device__ void stage_blocks(const Scn& c, int e_lo, int e_hi) {
    constexpr int CXL = (NPC * NX + THREADS - 1) / THREADS;
    constexpr int CUL = (NPC * NU + THREADS - 1) / THREADS;
    const bool mat = e_lo < GQ_OFF;
    float* cx = c.tile;
    float* cu = cx + NPC * NX;
    float* cwx = cu + NPC * NU;             // cx * w_p, cu * w_p
    float* cwu = cwx + NPC * NX;
    float rx[CXL], rv[CUL];
    auto fetch = [&](int k) {
  #pragma unroll
      for (int t = 0; t < CXL; ++t) {
        const int i = c.lane + THREADS * t;
        rx[t] = i < NPC * NX ? __ldg(c.cpx + (size_t)k * NPC * NX + i) : 0.f;
      }
  #pragma unroll
      for (int t = 0; t < CUL; ++t) {
        const int i = c.lane + THREADS * t;
        rv[t] = i < NPC * NU ? __ldg(c.cpu + (size_t)k * NPC * NU + i) : 0.f;
      }
    };
    fetch(0);
    for (int k = 0; k < c.n_st; ++k) {
      const float* wk = c.w + k * NC;
      const float* gk = c.cz + k * NC;
  #pragma unroll
      for (int t = 0; t < CXL; ++t) {
        const int i = c.lane + THREADS * t;
        if (i < NPC * NX) {
          cx[i] = rx[t];
          if (mat) cwx[i] = rx[t] * wk[O_P + i / NX];
        }
      }
  #pragma unroll
      for (int t = 0; t < CUL; ++t) {
        const int i = c.lane + THREADS * t;
        if (i < NPC * NU) {
          cu[i] = rv[t];
          if (mat) cwu[i] = rv[t] * wk[O_P + i / NU];
        }
      }
      __syncwarp();
      if (k + 1 < c.n_st) fetch(k + 1);
  #pragma unroll 3  // fully unrolled, the kernel needs over 255 registers
      for (int t = 0; t < (SLOT + THREADS - 1) / THREADS; ++t) {
        const int e = e_lo + c.lane + THREADS * t;
        if (e >= e_hi) continue;
        const int code = c.code[e];
        const int kind = code >> 8, a = (code >> 4) & 15, b = code & 15;
        // every kind is h + dg + sum_r pa[r sa] pb[r sb]; the kinds without
        // C rows take a zero stride on a zero (so the loop never diverges)
        const float* h;
        const float* pa = c.zero;
        const float* pb = c.zero;
        int sa = 0, sb = 0;
        float dg = 0.f;
        if (kind == 0) {          // Q_xx[a][b]
          h = c.hxx + (size_t)k * NX * NX + a * NX + b;
          if (a == b && k >= 1)
            dg = c.tx[a] * c.tx[a] * (wk[O_XU + a - NC] + wk[O_XL + a - NC]);
          pa = cwx + a; sa = NX; pb = cx + b; sb = NX;
        } else if (kind == 1) {   // S[a][b], u = a, x = b
          h = c.hux + (size_t)k * NU * NX + a * NX + b;
          pa = cwu + a; sa = NU; pb = cx + b; sb = NX;
        } else if (kind == 2) {   // R[a][b]
          h = c.huu + (size_t)k * NU * NU + a * NU + b;
          if (a == b) {
            dg = c.tu[a] * c.tu[a] * (wk[O_UU + a] + wk[O_UL + a]);
            if (a < DOF)
              dg += c.tr[a] * c.tr[a] * (wk[O_RU + a] + wk[O_RL + a]);
          }
          pa = cwu + a; sa = NU; pb = cu + b; sb = NU;
        } else if (kind == 3) {   // r2 + tr^2 (w_ru + w_rl)
          h = c.r2 + k * DOF + a;
          dg = c.tr[a] * c.tr[a] * (wk[O_RU + a] + wk[O_RL + a]);
        } else if (kind == 4) {   // gq_x[a]
          h = c.gx + k * NX + a;
          if (k >= 1) dg = c.tx[a] * (gk[O_XU + a - NC] - gk[O_XL + a - NC]);
          pa = cx + a; sa = NX; pb = gk + O_P; sb = 1;
        } else if (kind == 5) {   // gq on the u_prev slots
          h = c.gxu + k * DOF + a;
          dg = -(c.tr[a] * (gk[O_RU + a] - gk[O_RL + a]));
        } else {                  // gu[a]
          h = c.gu + k * NU + a;
          dg = c.tu[a] * (gk[O_UU + a] - gk[O_UL + a]);
          if (a < DOF) dg += c.tr[a] * (gk[O_RU + a] - gk[O_RL + a]);
          pa = cu + a; sa = NU; pb = gk + O_P; sb = 1;
        }
        float v = __ldg(h) + dg;
  #pragma unroll
        for (int r = 0; r < NPC; ++r) v += pa[r * sa] * pb[r * sb];
        slot_at(c, k)[e] = v;
      }
      __syncwarp();
    }
    // terminal boundary: knot N's cost + the state box of knot N
    const float* wl = c.w + (c.n_st - 1) * NC;
    const float* gl = c.cz + (c.n_st - 1) * NC;
    if (mat) {
      for (int e = c.lane; e < Q_UP; e += THREADS) {
        int kind, i, j;
        decode_entry(e, kind, i, j);
        float v = __ldg(c.hxx + (size_t)c.n_st * NX * NX + i * NX + j);
        if (i == j) v += c.tx[i] * c.tx[i] * (wl[O_XU + i] + wl[O_XL + i]);
        c.tp[e] = v;
      }
    }
    if (e_hi > GQ_OFF && c.lane < NX)
      c.tp[Q_UP + c.lane] =
          __ldg(c.gx + c.n_st * NX + c.lane)
          + c.tx[c.lane] * (gl[O_XU + c.lane] - gl[O_XL + c.lane]);
    __syncwarp();
  }

  // The gradient blocks alone (Mehrotra's probe and corrector): gq (nx +
  // dof), gu (nu) of every stage and the terminal p from the rows in c.cz,
  // warp-parallel over (stage, entry) with C read straight from L1/L2 (a
  // tile would put each stage's load latency in series for little work).
  static __device__ void gradient_blocks(const Scn& c) {
    constexpr int N_GRAD = SLOT - GQ_OFF;
    const int total = c.n_st * N_GRAD + NX;
    for (int idx = c.lane; idx < total; idx += THREADS) {
      const int k = idx / N_GRAD, e = idx % N_GRAD;
      if (k == c.n_st) {          // terminal p (knot N's state box)
        const float* gl = c.cz + (c.n_st - 1) * NC;
        c.tp[Q_UP + e] = __ldg(c.gx + c.n_st * NX + e)
                       + c.tx[e] * (gl[O_XU + e] - gl[O_XL + e]);
        continue;
      }
      const float* gk = c.cz + k * NC;
      const float* cx = c.cpx + (size_t)k * NPC * NX;
      const float* cu = c.cpu + (size_t)k * NPC * NU;
      float v;
      if (e < NX) {
        v = __ldg(c.gx + k * NX + e);
        if (k >= 1) v += c.tx[e] * (gk[O_XU + e - NC] - gk[O_XL + e - NC]);
        for (int r = 0; r < NPC; ++r) v += __ldg(cx + r * NX + e) * gk[O_P + r];
      } else if (e < NX + DOF) {
        const int u = e - NX;
        v = __ldg(c.gxu + k * DOF + u)
            - c.tr[u] * (gk[O_RU + u] - gk[O_RL + u]);
      } else {
        const int u = e - NX - DOF;
        v = __ldg(c.gu + k * NU + u) + c.tu[u] * (gk[O_UU + u] - gk[O_UL + u]);
        if (u < DOF) v += c.tr[u] * (gk[O_RU + u] - gk[O_RL + u]);
        for (int r = 0; r < NPC; ++r) v += __ldg(cu + r * NU + u) * gk[O_P + r];
      }
      slot_at(c, k)[GQ_OFF + e] = v;
    }
    __syncwarp();
  }

  // C z for every stage row (group order) from the steps (dx, du), a loop
  // per row group so that the lanes of a loop take one path.
  static __device__ void row_products(const Scn& c, const float* dx,
                                      const float* du, float* cz) {
    const int n = c.n_st;
    const int lane = WIDE ? fresh_lane() : c.lane;   // see the sweep
    for (int idx = lane; idx < n * NX; idx += THREADS) {
      const int k = idx / NX, j = idx % NX;
      const float v = c.tx[j] * dx[(k + 1) * NXT + j];
      cz[k * NC + O_XU + j] = v;
      cz[k * NC + O_XL + j] = -v;
    }
    for (int idx = lane; idx < n * NU; idx += THREADS) {
      const int k = idx / NU, j = idx % NU;
      const float v = c.tu[j] * du[k * NU + j];
      cz[k * NC + O_UU + j] = v;
      cz[k * NC + O_UL + j] = -v;
      if (j < DOF) {
        const float r = c.tr[j] * (du[k * NU + j] - dx[k * NXT + NX + j]);
        cz[k * NC + O_RU + j] = r;
        cz[k * NC + O_RL + j] = -r;
      }
    }
    for (int idx = lane; idx < n * NPC; idx += THREADS) {
      const int k = idx / NPC, r = idx % NPC;
      const float* cx = c.cpx + ((size_t)k * NPC + r) * NX;
      const float* cu = c.cpu + ((size_t)k * NPC + r) * NU;
      float acc = 0.f;
      for (int j = 0; j < NX; ++j) acc += __ldg(cx + j) * dx[k * NXT + j];
      float acc_u = 0.f;
      for (int j = 0; j < NU; ++j) acc_u += __ldg(cu + j) * du[k * NU + j];
      cz[k * NC + O_P + r] = acc + acc_u;
    }
    __syncwarp();
  }

  // ru_bar[u] = gu[u] + (bd' m[:nx])[u] + m[nx + u] for the u of this lane
  // (every lane takes part in the shuffles; lanes 0..nu-1 hold the results).
  template <class V>
  static __device__ __forceinline__ V ru_bar(const Scn& c, const float* sl,
                                             V m, int u) {
    V acc = 0;
  #pragma unroll
    for (int i = 0; i < NX; ++i)
      acc += c.bd[i * NUP + u] * __shfl_sync(FULL, m, i);
    return (sl[GU_OFF + u] + acc) + __shfl_sync(FULL, m, NX + u);
  }

  // The Cholesky of r_bar across the lanes (WIDE), right-looking: lane
  // i < nu holds row i of r_bar in lr and ends with row i of L; pivots and
  // column entries pass by shuffle.  The operations are the per-lane
  // factor's, so L is the same (NaN on a non-PD pivot).  Row i of L, with
  // 1 / L_ii on its diagonal, goes over the consumed P Bt tile; under
  // Mehrotra (!FUSED) L and 1 / diag(L) also go to the saved factorization.
  template <bool FUSED>
  static __device__ __forceinline__ void factor_by_row(const Scn& c, int lane,
                                                       float (&lr)[NU],
                                                       fact_t* fk) {
    float inv_own = 0.f;
  #pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float inv = rsqrtf(__shfl_sync(FULL, lr[j], j));
      if (lane == j) inv_own = inv;
      lr[j] = lr[j] * inv;
  #pragma unroll
      for (int l = j + 1; l < NU; ++l) {
        const float llj = __shfl_sync(FULL, lr[j], l);
        if (l <= lane) lr[l] -= lr[j] * llj;
      }
    }
    if (lane < NU) {
      float row[NU];
  #pragma unroll
      for (int v = 0; v < NU; ++v)
        row[v] = v < lane ? lr[v] : (v == lane ? inv_own : 0.f);
      stv(c.pb + lane * NUP, row);
    }
    if (!FUSED) {
#ifdef MPCC_FACT_F64
      fact_f64(c, fk);
#else
      if (lane < NU) {
  #pragma unroll
        for (int v = 0; v < NU; ++v)
          if (v <= lane) fk[F_L + lane * NU + v] = lr[v];
        fk[F_LINV + lane] = inv_own;
      }
#endif
    }
  }

#ifdef MPCC_FACT_F64
  // Mehrotra's L and 1 / diag(L) factored again from r_bar (in the tile) in
  // float64, on lane 0.
  static __device__ void fact_f64(const Scn& c, fact_t* fk) {
    if (c.lane != 0) return;
    double l[NU][NU];
  #pragma unroll
    for (int i = 0; i < NU; ++i) {
  #pragma unroll
      for (int v = 0; v < NU; ++v) l[i][v] = c.lt[i * NUP + v];
    }
  #pragma unroll
    for (int j = 0; j < NU; ++j) {
      const double d = 1.0 / sqrt(l[j][j]);
      fk[F_LINV + j] = d;
  #pragma unroll
      for (int i = j; i < NU; ++i) l[i][j] *= d;
  #pragma unroll
      for (int i = j + 1; i < NU; ++i) {
  #pragma unroll
        for (int v = j + 1; v <= i; ++v) l[i][v] -= l[i][j] * l[v][j];
      }
    }
  #pragma unroll
    for (int i = 0; i < NU; ++i) {
  #pragma unroll
      for (int v = 0; v <= i; ++v) fk[F_L + i * NU + v] = l[i][v];
    }
  }
#endif

  // The backward Riccati sweep on the warp.  FUSED (adaptive): the matrix and
  // vector recursions together, K_k into the slot and k_ff_k into c.kff.
  // Otherwise (Mehrotra): the matrix recursion only, K_k into the slot and
  // L_k, s_bar_k's x-columns and P_{k+1} e_k into the scratch.
  // Lane j holds column j of P (j < nxt); lanes 0..nu-1 hold r_bar's rows for
  // the Cholesky; lane c < nxt solves for column c of K, lane nxt for k_ff.
  template <bool FUSED>
  static __device__ void riccati_sweep(const Scn& c) {
    float pc[NXT];
    float pv = 0.f;
    {
      const int lane = WIDE ? fresh_lane() : c.lane;
      const int jl = min(lane, NX - 1);
  #pragma unroll
      for (int i = 0; i < NXT; ++i)
        pc[i] = (lane < NX && i < NX) ? c.tp[symx(i, jl)] : 0.f;
      if (FUSED) pv = lane < NX ? c.tp[Q_UP + jl] : 0.f;
    }
    if constexpr (WIDE) {             // the last stage's slot
      stage_slot(c, c.n_st - 1);
      cp_async_wait_all();
      __syncwarp();
    }

    for (int k = c.n_st - 1; k >= 0; --k) {
      // WIDE: the lane's slot and tile offsets formed afresh each stage;
      // hoisted out of the Newton loop, both sweeps' sets spill at its dims
      const int lane = WIDE ? fresh_lane() : c.lane;
      const int jl = min(lane, NX - 1);       // clamped indices for loads
      const int ul = min(lane, NU - 1);
      const int u_l = lane - NX;              // lanes 9-16: the u_prev slots
      float* kout = slot_at(c, k);                     // K_k's place
      const float* sl = WIDE ? c.stage : kout;  // stage k's blocks
      const float* ek = c.e + k * NX;
      fact_t* fk = FUSED ? nullptr : fact_at(c, k);
      const float srr_l = (u_l >= 0 && u_l < DOF) ? sl[SRR_OFF + u_l] : 0.f;

      // the x-blocks: pa = (P At)[:, :nx] (column vs += a_sv * column s),
      // q_bar and the s_bar column
      float qb[NXT];
      float sb[NU];
      auto x_blocks = [&]() {
        float pa[NXT];
  #pragma unroll
        for (int i = 0; i < NXT; ++i) {
          const float ps = __shfl_sync(FULL, pc[i], S_IDX);
          pa[i] = lane == VS_IDX ? pc[i] + c.a_sv * ps : pc[i];
        }
        // q_bar = Q + At' P At (x-block), diag(srr) on the u_prev slots
  #pragma unroll
        for (int i = 0; i < NXT; ++i) {
          float v = 0.f;
          if (i < NX) {
            const float ct = i == VS_IDX ? pa[i] + c.a_sv * pa[S_IDX] : pa[i];
            v = sl[Q_OFF + symx(i, jl)] + ct;
          }
          qb[i] = lane < NX ? v : (lane == i ? srr_l : 0.f);
        }
        // s_bar column: S + bd' pa[:nx] + pa[nx:]; -srr on the u_prev
        // diagonal
        float acc[NU] = {};
  #pragma unroll
        for (int i = 0; i < NX; ++i) {
          float bdr[NU];
          ldv(c.bd + i * NUP, bdr);
  #pragma unroll
          for (int u = 0; u < NU; ++u) acc[u] += bdr[u] * pa[i];
        }
  #pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float vx = sl[S_OFF + u * NX + jl] + (acc[u] + pa[NX + u]);
          const float vu = (u == u_l && u < DOF) ? -srr_l : 0.f;
          sb[u] = lane < NX ? vx : vu;
        }
      };
      // (P Bt)[i][:] from column i of P (P is symmetric) into the tile, and
      // P_{k+1} e_k (row i from column i)
      auto p_bt_pe = [&]() {
        float acc[NU] = {};
  #pragma unroll
        for (int j = 0; j < NX; ++j) {
          float bdr[NU];
          ldv(c.bd + j * NUP, bdr);
  #pragma unroll
          for (int v = 0; v < NU; ++v) acc[v] += bdr[v] * pc[j];
        }
  #pragma unroll
        for (int v = 0; v < NU; ++v) acc[v] += pc[NX + v];
        if (lane < NXT) stv(c.pb + lane * NUP, acc);
        float pe = 0.f;
  #pragma unroll
        for (int j = 0; j < NX; ++j) pe += pc[j] * __ldg(ek + j);
        return pe;
      };
      // WIDE: P Bt and P e first, so that P's columns (pc) die as pa
      // is formed instead of living beside pa and q_bar
      float pe;
      if constexpr (WIDE) {
        pe = p_bt_pe();
        x_blocks();
      } else {
        x_blocks();
        pe = p_bt_pe();
      }
      float qx = 0.f;
      if (FUSED) {
        // vector step: m = p + P e, qx_bar, and ru_bar on lane nxt's rhs
        const float m = pv + pe;
        const float ms = __shfl_sync(FULL, m, S_IDX);
        const float gq = lane < NXT - 1 ? sl[GQ_OFF + min(lane, NXT - 2)] : 0.f;
        qx = gq + (lane < NX ? m : 0.f);
        if (lane == VS_IDX) qx += c.a_sv * ms;
        // ru_bar[u] on lane u, gathered on lane nxt (its right-hand side)
        const float ru = ru_bar(c, sl, m, ul);
  #pragma unroll
        for (int u = 0; u < NU; ++u) {
          const float v = __shfl_sync(FULL, ru, u);
          if (lane == NXT) sb[u] = v;
        }
      } else if (lane < NXT) {
        fk[F_PE + lane] = pe;
      }
      __syncwarp();

      // r_bar = R + Bt' P Bt + 1e-9 I, row ul on lane ul, into the tile
      float rb[NU];
      {
        float acc[NU] = {};
  #pragma unroll
        for (int i = 0; i < NX; ++i) {
          float pbr[NU];
          ldv(c.pb + i * NUP, pbr);
          const float bdi = c.bd[i * NUP + ul];
  #pragma unroll
          for (int v = 0; v < NU; ++v) acc[v] += bdi * pbr[v];
        }
        float pbu[NU];
        ldv(c.pb + (NX + ul) * NUP, pbu);
  #pragma unroll
        for (int v = 0; v < NU; ++v) {
          float t = (sl[R_OFF + symu(ul, v)] + acc[v]) + pbu[v];
          if (v == ul) t += 1e-9f;
          rb[v] = t;
        }
        if (lane < NU) stv(c.lt + lane * NUP, rb);
      }
      __syncwarp();
      if constexpr (WIDE) {
        // the stage buffer is read; stage k-1's slot lands meanwhile
        if (k >= 1) stage_slot(c, k - 1);
      }
      // [K | k_ff] = -(L L')^-1 [s_bar | ru_bar], a column a lane.  Forward:
      // Y = L^-1 [s_bar | ru_bar]; s_bar' K = -Y'Y, so P's update needs only
      // Y and comes out symmetric; then backward (rows of L only).
      float y[NU];
      float lm[NU][NU], linv[NU];   // L and 1 / diag(L) on every lane
      if constexpr (WIDE) {
        // the Cholesky across lanes 0..nu-1 (row i on lane i), L with
        // 1 / diag(L) on its diagonal into the consumed P Bt tile; the
        // forward solve reads it there
        factor_by_row<FUSED>(c, lane, rb, fk);
        __syncwarp();
  #pragma unroll
        for (int i = 0; i < NU; ++i) {
          float lr[NU];
          ldv(c.pb + i * NUP, lr);
          float acc = sb[i];
  #pragma unroll
          for (int j = 0; j < i; ++j) acc -= lr[j] * y[j];
          y[i] = acc * lr[i];
        }
      } else {
        // right-looking Cholesky of r_bar on every lane from the tile (NaN
        // on a non-PD pivot), so that every lane holds L and 1 / diag(L)
        // (rsqrt)
  #pragma unroll
        for (int i = 0; i < NU; ++i) ldv(c.lt + i * NUP, lm[i]);
  #pragma unroll
        for (int j = 0; j < NU; ++j) {
          linv[j] = rsqrtf(lm[j][j]);
  #pragma unroll
          for (int i = j; i < NU; ++i) lm[i][j] = lm[i][j] * linv[j];
  #pragma unroll
          for (int i = j + 1; i < NU; ++i) {
  #pragma unroll
            for (int l = j + 1; l <= i; ++l) lm[i][l] -= lm[i][j] * lm[l][j];
          }
        }
        if (!FUSED) {            // Mehrotra keeps L and 1 / diag(L)
#ifdef MPCC_FACT_F64
          fact_f64(c, fk);
#else
  #pragma unroll
          for (int i = 0; i < NU; ++i) {
            if (lane == i) {
  #pragma unroll
              for (int v = 0; v <= i; ++v) fk[F_L + i * NU + v] = lm[i][v];
              fk[F_LINV + i] = linv[i];
            }
          }
#endif
        }
  #pragma unroll
        for (int i = 0; i < NU; ++i) {
          float acc = sb[i];
  #pragma unroll
          for (int j = 0; j < i; ++j) acc -= lm[i][j] * y[j];
          y[i] = acc * linv[i];
        }
      }
      if (lane < NXT) stv(c.sbt + lane * NUP, y);
      if (!FUSED && lane < NX) {
  #pragma unroll
        for (int u = 0; u < NU; ++u) fk[F_SB + lane * NU + u] = sb[u];
      }
      __syncwarp();

      // P <- q_bar - Y'Y (lane j: column j)
  #pragma unroll
      for (int i = 0; i < NXT; ++i) {
        float yr[NU];
        ldv(c.sbt + i * NUP, yr);
        float acc = 0.f;
  #pragma unroll
        for (int u = 0; u < NU; ++u) acc += yr[u] * y[u];
        pc[i] = lane < NXT ? qb[i] - acc : 0.f;
      }
      if constexpr (WIDE) {
  #pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
          float lr[NU];
          ldv(c.pb + i * NUP, lr);
          y[i] = y[i] * lr[i];
  #pragma unroll
          for (int j = 0; j < i; ++j) y[j] -= lr[j] * y[i];
        }
      } else {
  #pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
          y[i] = y[i] * linv[i];
  #pragma unroll
          for (int j = 0; j < i; ++j) y[j] -= lm[i][j] * y[i];
        }
      }
      if (lane < NXT) {
  #pragma unroll
        for (int u = 0; u < NU; ++u) kout[u * NXT + lane] = -y[u];   // K_k
      }
      if (FUSED) {
        // k_ff on lane nxt; p <- qx_bar + s_bar' k_ff
        if (lane == NXT) {
  #pragma unroll
          for (int u = 0; u < NU; ++u) c.kff[k * NU + u] = -y[u];
        }
        float acc = 0.f;
  #pragma unroll
        for (int u = 0; u < NU; ++u)
          acc += sb[u] * -__shfl_sync(FULL, y[u], NXT);
        pv = lane < NXT ? qx + acc : 0.f;
      }
      if constexpr (WIDE) cp_async_wait_all();
      __syncwarp();
    }
  }

  // The vector-only backward sweep against Mehrotra's saved factorization:
  // k_ff_k into c.kff (the gradient blocks are in the slots, K_k too).
  static __device__ void vector_sweep(const Scn& c) {
    using V = vsweep_t;
    using W = decltype(V() + fact_t());   // the triangular solves' type
    const int lane = c.lane;
    const int u_l = lane - NX;
    V pv = lane < NX ? c.tp[Q_UP + min(lane, NX - 1)] : 0.f;
    for (int k = c.n_st - 1; k >= 0; --k) {
      const float* sl = slot_at(c, k);
      const fact_t* fk = fact_at(c, k);
      const float srr_l = (u_l >= 0 && u_l < DOF) ? sl[SRR_OFF + u_l] : 0.f;
      const V pe = lane < NXT ? fk[F_PE + min(lane, NXT - 1)] : 0.f;
      const V m = pv + pe;
      const V ms = __shfl_sync(FULL, m, S_IDX);
      const float gq = lane < NXT - 1 ? sl[GQ_OFF + min(lane, NXT - 2)] : 0.f;
      V qx = gq + (lane < NX ? m : V(0));
      if (lane == VS_IDX) qx += c.a_sv * ms;
      // ru_bar[u] on lane u, gathered on lane nxt
      const V ru = ru_bar(c, sl, m, min(lane, NU - 1));
      V y[NU];
  #pragma unroll
      for (int u = 0; u < NU; ++u) y[u] = __shfl_sync(FULL, ru, u);
      if (lane == NXT) {
        // k_ff = -(L L')^-1 ru_bar against the saved L (in its type)
        W z[NU];
  #pragma unroll
        for (int i = 0; i < NU; ++i) z[i] = y[i];
  #pragma unroll
        for (int i = 0; i < NU; ++i) {
          W acc = z[i];
  #pragma unroll
          for (int j = 0; j < i; ++j) acc -= fk[F_L + i * NU + j] * z[j];
          z[i] = acc * fk[F_LINV + i];
        }
  #pragma unroll
        for (int i = NU - 1; i >= 0; --i) {
          W acc = z[i];
  #pragma unroll
          for (int j = i + 1; j < NU; ++j) acc -= fk[F_L + j * NU + i] * z[j];
          z[i] = acc * fk[F_LINV + i];
        }
  #pragma unroll
        for (int u = 0; u < NU; ++u) {
          y[u] = static_cast<V>(z[u]);
          c.kff[k * NU + u] = static_cast<float>(-y[u]);
        }
      }
      V acc = 0;
  #pragma unroll
      for (int u = 0; u < NU; ++u) {
        const V kf = -__shfl_sync(FULL, y[u], NXT);
        const float sbu = lane < NX ? fk[F_SB + min(lane, NX - 1) * NU + u]
                                    : ((u == u_l && u < DOF) ? -srr_l : 0.f);
        acc += sbu * kf;
      }
      pv = lane < NXT ? qx + acc : V(0);
    }
    __syncwarp();
  }

  // Forward rollout of the targets from dx'_0 = 0 on the warp: dx_t into
  // c.dxt, du_t over k_ff in c.kff (each entry is read before it is written).
  // WIDE: lane u < nu loads row u of K_{k+1} while stage k computes.
  static __device__ void rollout(const Scn& c) {
    const int lane = c.lane;
    float kr[NXT], kn[NXT];
    auto k_row = [&](int k, float (&r)[NXT]) {
      const float* kg = slot_at(c, k) + min(lane, NU - 1) * NXT;
  #pragma unroll
      for (int j = 0; j < NXT; ++j) r[j] = kg[j];
    };
    if constexpr (WIDE) {
      if (lane < NU) k_row(0, kr);
    }
    if (lane < NXT) c.dxt[lane] = 0.f;
    __syncwarp();
    for (int k = 0; k < c.n_st; ++k) {
      const float* xk = c.dxt + k * NXT;
      if constexpr (WIDE) {
        if (lane < NU && k + 1 < c.n_st) k_row(k + 1, kn);
      }
      if (lane < NU) {
        float v = 0.f;
        if constexpr (WIDE) {
  #pragma unroll
          for (int j = 0; j < NXT; ++j) v += kr[j] * xk[j];
        } else {
          const float* kg = slot_at(c, k);
          for (int j = 0; j < NXT; ++j) v += kg[lane * NXT + j] * xk[j];
        }
        v += c.kff[k * NU + lane];
        c.kff[k * NU + lane] = v;
        c.dxt[(k + 1) * NXT + NX + lane] = v;
      }
      __syncwarp();
      if (lane < NX) {
        float v = xk[lane];
        if (lane == S_IDX) v += c.a_sv * xk[VS_IDX];
        float bu = 0.f;
        for (int u = 0; u < NU; ++u)
          bu += c.bd[lane * NUP + u] * c.kff[k * NU + u];
        c.dxt[(k + 1) * NXT + lane] = v + bu + __ldg(c.e + k * NX + lane);
      }
      if constexpr (WIDE) {
  #pragma unroll
        for (int j = 0; j < NXT; ++j) kr[j] = kn[j];
      }
      __syncwarp();
    }
  }

  // The target steps for the rhs: (Mehrotra) the gradient blocks, a sweep,
  // the rollout and the target row products.  The matrix blocks (adaptive:
  // and the gradient blocks) are in the slots already.
  static __device__ float2 solve_rhs(const Scn& c, bool mehrotra, int rhs_mode,
                              float mu) {
    if (mehrotra) {
      gradient_rows(c, rhs_mode, mu);
      gradient_blocks(c);
    }
    if (mehrotra) {
      vector_sweep(c);
    } else {
      riccati_sweep<true>(c);
    }
    rollout(c);
    row_products(c, c.dxt, c.kff, c.cz);
    return targets(c, rhs_mode, mu);
  }

  // The kernel body: one scenario per block, `sm` its shared memory.
  static __device__ void run(float* sm, const Inputs& in, const Outputs& out,
                             float* scratch, int n_st, int max_iter,
                             float eps_ipm, int scheme) {
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const int nr = n_st * NC;
    const bool mehrotra = scheme == SCHEME_MEHROTRA;

    Scn c;
    c.hxx = in.hxx + (size_t)b * (n_st + 1) * NX * NX;
    c.hux = in.hux + (size_t)b * n_st * NU * NX;
    c.huu = in.huu + (size_t)b * n_st * NU * NU;
    c.r2 = in.r2 + (size_t)b * n_st * DOF;
    c.gx = in.gx + (size_t)b * (n_st + 1) * NX;
    c.gu = in.gu + (size_t)b * n_st * NU;
    c.gxu = in.gxu + (size_t)b * n_st * DOF;
    c.e = in.e + (size_t)b * n_st * NX;
    c.cpx = in.cpx + (size_t)b * n_st * NPC * NX;
    c.cpu = in.cpu + (size_t)b * n_st * NPC * NU;
    if constexpr (WIDE) {     // slot, then (Mehrotra) factorization
      c.stride = SLOT_LD + (mehrotra ? FACT_LD : 0);
      c.slot = scratch + (size_t)b * n_st * c.stride;
      c.fact = nullptr;
    } else {
      c.fact = mehrotra ? reinterpret_cast<fact_t*>(scratch)
                              + (size_t)b * n_st * FACT
                        : nullptr;
    }
    c.a_sv = in.a_sv[b];
    c.n_st = n_st;
    c.nr = nr;
    c.lane = lane;
    // ---- shared-memory carve-up (floats; smem_floats below)
    float* next = sm;
    auto take = [&next](int n) { float* p = next; next += pad4(n); return p; };
    c.s = take(nr);
    c.lam = take(nr);
    c.w = take(nr);
    c.r = take(nr);
    c.d = take(nr);
    c.cz = take(nr);
    if constexpr (WIDE) {
      c.stage = take(SLOT_LD);
    } else {
      c.slot = take(n_st * SLOT);
    }
    c.tp = take(TP_FLOATS);
    c.kff = take(n_st * NU);
    c.dx = take((n_st + 1) * NXT);
    c.du = take(n_st * NU);
    c.dxt = take((n_st + 1) * NXT);
    c.tile = take(TILE);
    c.pb = c.tile;
    c.lt = c.pb + NXT * NUP;
    c.sbt = c.lt + NU * NUP;
    c.bd = take(NX * NUP);
    c.tx = take(NX);
    c.tu = take(NU);
    c.tr = take(DOF);
    c.zero = take(1);
    c.code = reinterpret_cast<int*>(take(SLOT));

    for (int i = lane; i < nr; i += THREADS) {
      c.s[i] = in.s0[(size_t)b * nr + i];
      c.lam[i] = in.lam0[(size_t)b * nr + i];
      c.d[i] = in.d[(size_t)b * nr + i];
    }
    for (int i = lane; i < NX * NU; i += THREADS)
      c.bd[i / NU * NUP + i % NU] = in.bd[(size_t)b * NX * NU + i];
    if (lane < NX) c.tx[lane] = in.tx[(size_t)b * NX + lane];
    if (lane < NU) c.tu[lane] = in.tu[(size_t)b * NU + lane];
    if (lane < DOF) c.tr[lane] = in.tr[(size_t)b * DOF + lane];
    if (lane == 0) c.zero[0] = 0.f;
    for (int e = lane; e < SLOT; e += THREADS) {
      int kind, a, bb;
      decode_entry(e, kind, a, bb);
      c.code[e] = kind << 8 | a << 4 | bb;
    }
    for (int i = lane; i < (n_st + 1) * NXT; i += THREADS) c.dx[i] = 0.f;
    for (int i = lane; i < n_st * NU; i += THREADS) c.du[i] = 0.f;
    __syncwarp();

    const float m_act = (float)nr;
    float part = 0.f;
    for (int i = lane; i < nr; i += THREADS) part += c.s[i] * c.lam[i];
    float mu = warp_sum(part) / m_act;

    int it = 0;
    while (it < max_iter) {
      // WIDE: the row loops' lane formed afresh each iteration (the
      // first pass's row addresses held across the loop spill at its dims)
      const int ln = WIDE ? fresh_lane() : lane;
      // ---- w = lam / s_safe, and (Mehrotra) the measured complementarity
      float sl_part = 0.f;
      for (int i = ln; i < nr; i += THREADS) {
        c.w[i] = c.lam[i] / fmaxf(c.s[i], 1e-10f);
        sl_part += c.s[i] * c.lam[i];
      }
      const float mu_meas = warp_sum(sl_part) / m_act;
      __syncwarp();
      if (mehrotra) {
        stage_blocks(c, 0, GQ_OFF);
      } else {
        gradient_rows(c, 1, mu);
        stage_blocks(c, 0, SLOT);
      }

      float2 alpha;
      if (mehrotra) {
        // factor once; the affine probe, then the centering corrector
        riccati_sweep<false>(c);
        const float2 a_aff = solve_rhs(c, true, 0, 0.f);   // ds_a, dlam_a
        float prod = 0.f;
        for (int i = ln; i < nr; i += THREADS)
          prod += (c.s[i] + a_aff.x * c.r[i]) * (c.lam[i] + a_aff.y * c.cz[i]);
        const float mu_aff = warp_sum(prod) / m_act;
        const float ratio = mu_aff / fmaxf(mu_meas, 1e-12f);
        const float sigma_m = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 1.f);
        for (int i = ln; i < nr; i += THREADS)
          c.r[i] = sigma_m * mu_meas - c.r[i] * c.cz[i];
        __syncwarp();
        alpha = solve_rhs(c, true, 2, 0.f);
      } else {
        alpha = solve_rhs(c, false, 1, mu);
      }
      const float alpha_p = alpha.x, alpha_d = alpha.y;

      // ---- take the step unless any updated value is non-finite
      int ok = 1;
      for (int i = ln; i < (n_st + 1) * NXT; i += THREADS)
        ok &= finitef(c.dx[i] + alpha_p * (c.dxt[i] - c.dx[i]));
      for (int i = ln; i < n_st * NU; i += THREADS)
        ok &= finitef(c.du[i] + alpha_p * (c.kff[i] - c.du[i]));
      for (int i = ln; i < nr; i += THREADS)
        ok &= finitef(c.s[i] + alpha_p * c.r[i])
              & finitef(c.lam[i] + alpha_d * c.cz[i]);
      const bool finite = __all_sync(FULL, ok) != 0;
      if (finite) {
        for (int i = ln; i < (n_st + 1) * NXT; i += THREADS)
          c.dx[i] = c.dx[i] + alpha_p * (c.dxt[i] - c.dx[i]);
        for (int i = ln; i < n_st * NU; i += THREADS)
          c.du[i] = c.du[i] + alpha_p * (c.kff[i] - c.du[i]);
        for (int i = ln; i < nr; i += THREADS) {
          c.s[i] = c.s[i] + alpha_p * c.r[i];
          c.lam[i] = c.lam[i] + alpha_d * c.cz[i];
        }
      }
      __syncwarp();

      // ---- convergence / divergence bookkeeping on the updated iterate
      row_products(c, c.dx, c.du, c.cz);
      float rmax = 0.f, sl = 0.f;
      for (int i = ln; i < nr; i += THREADS) {
        rmax = nan_max(rmax, fabsf(c.cz[i] + c.s[i] - c.d[i]));
        sl += c.s[i] * c.lam[i];
      }
      const float r_ineq = warp_max(rmax);
      const float mu_post = warp_sum(sl) / m_act;
      const float alpha_min = fminf(alpha_p, alpha_d);
      const float om = 1.f - alpha_min;
      const float sigma = fminf(fmaxf(om * om, 0.1f), 0.8f);
      mu = fmaxf(sigma * mu_post, 0.01f * eps_ipm);
      ++it;
      const bool conv = (mu_post < eps_ipm) && (r_ineq < 2e-4f);
      const bool diverged = !finite || (mu_post > 1e6f);
      __syncwarp();
      if (conv || diverged) break;
    }

    // ---- final verdict on the returned iterate
    row_products(c, c.dx, c.du, c.cz);
    float rmax = 0.f, sl = 0.f;
    for (int i = lane; i < nr; i += THREADS) {
      rmax = nan_max(rmax, fabsf(c.cz[i] + c.s[i] - c.d[i]));
      sl += c.s[i] * c.lam[i];
    }
    const float r_fin = warp_max(rmax);
    const float mu_fin = warp_sum(sl) / m_act;

    for (int i = lane; i < (n_st + 1) * NXT; i += THREADS)
      out.dx[(size_t)b * (n_st + 1) * NXT + i] = c.dx[i];
    for (int i = lane; i < n_st * NU; i += THREADS)
      out.du[(size_t)b * n_st * NU + i] = c.du[i];
    for (int i = lane; i < nr; i += THREADS) {
      out.lam[(size_t)b * nr + i] = c.lam[i];
      out.s[(size_t)b * nr + i] = c.s[i];
    }
    if (lane == 0) {
      out.iters[b] = it;
      out.solved[b] = (mu_fin < 10.f * eps_ipm) && (r_fin < 1e-3f);
      out.mu[b] = mu_fin;
    }
  }


  // The carve-up of run, each region rounded to 16 bytes.
  static constexpr size_t smem_floats(int n_st) {
    const int regions[] = {n_st * NC, n_st * NC, n_st * NC, n_st * NC,
                           n_st * NC, n_st * NC,
                           WIDE ? SLOT_LD : n_st * SLOT, TP_FLOATS,
                           n_st * NU, (n_st + 1) * NXT, n_st * NU,
                           (n_st + 1) * NXT, TILE, NX * NUP, NX, NU, DOF, 1,
                           SLOT};
    size_t n = 0;
    for (int r : regions) n += pad4(r);
    return n;
  }
  // scratch floats a (scenario, stage); none: no scratch
  static constexpr int scratch_stride(bool mehrotra) {
    return WIDE ? SLOT_LD + (mehrotra ? FACT_LD : 0)
                       : (mehrotra ? FACT * (int)(sizeof(fact_t) / 4) : 0);
  }
};

// Both systems hold 8 blocks an SM at the bench's N = 10.
static_assert(K1<0>::smem_floats(10) * sizeof(float) <= SMEM_BUDGET,
              "the Panda's layout exceeds the 8-block budget at N = 10");
static_assert(K1<3>::smem_floats(10) * sizeof(float) <= SMEM_BUDGET,
              "the Husky+Panda's layout exceeds the 8-block budget at N = 10");

template <int BASE_DOF>
__global__ void __launch_bounds__(THREADS)
ipm_kernel(Inputs in, Outputs out, float* scratch, int n_st, int max_iter,
           float eps_ipm, int scheme) {
  extern __shared__ __align__(16) float sm[];
  K1<BASE_DOF>::run(sm, in, out, scratch, n_st, max_iter, eps_ipm, scheme);
}

// Opt the instantiation into `bytes` of dynamic shared memory, with the
// largest shared-memory carve-out of the SM (so 8 Panda blocks fit at
// N = 10).
template <int BASE_DOF>
cudaError_t prepare(size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ipm_kernel<BASE_DOF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ipm_kernel<BASE_DOF>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int BASE_DOF>
int solve(const Inputs& in, const Outputs& out, float* scratch, int batch,
          int n_st, int max_iter, float eps_ipm, int scheme,
          cudaStream_t stream) {
  if (K1<BASE_DOF>::scratch_stride(scheme == SCHEME_MEHROTRA) > 0
      && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = K1<BASE_DOF>::smem_floats(n_st) * sizeof(float);
  cudaError_t err = prepare<BASE_DOF>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ipm_kernel<BASE_DOF><<<batch, THREADS, bytes, stream>>>(
      in, out, scratch, n_st, max_iter, eps_ipm, scheme);
  return static_cast<int>(cudaGetLastError());
}

template <int BASE_DOF>
int launch_config(int n_st, int* out) {
  const size_t bytes = K1<BASE_DOF>::smem_floats(n_st) * sizeof(float);
  cudaError_t err = prepare<BASE_DOF>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ipm_kernel<BASE_DOF>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ipm_kernel<BASE_DOF>, THREADS, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(bytes);
  out[1] = THREADS;
  out[2] = blocks;
  out[3] = fa.numRegs;
  out[4] = static_cast<int>(fa.localSizeBytes);
  out[5] = sms;
  return 0;
}

}  // namespace

// system: the base_dof of the system's instantiation (0 Panda, 3
// Husky+Panda).  scheme: 0 adaptive, 1 Mehrotra.  scratch: a (batch, n_st,
// K1::scratch_stride) float scratch (solver/qp_ipm_kernel.py's
// scratch_floats), or null where that is 0.  Returns the cudaError_t of the
// launch.
extern "C" int mpcc_ipm_solve(
    const float* hxx, const float* hux, const float* huu, const float* r2,
    const float* gx, const float* gu, const float* gxu, const float* e,
    const float* bd, const float* a_sv, const float* tx, const float* tu,
    const float* tr, const float* d, const float* cpx, const float* cpu,
    const float* s0, const float* lam0,
    float* dx, float* du, float* lam, float* s, int* iters, int* solved,
    float* mu, float* scratch, int system, int batch, int n_st, int max_iter,
    float eps_ipm, int scheme, void* stream) {
  if (scheme != SCHEME_ADAPTIVE && scheme != SCHEME_MEHROTRA)
    return static_cast<int>(cudaErrorInvalidValue);
  if (system != 0 && system != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  Inputs in{hxx, hux, huu, r2, gx, gu, gxu, e, bd, a_sv, tx, tu, tr,
            d, cpx, cpu, s0, lam0};
  Outputs out{dx, du, lam, s, iters, solved, mu};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return system == 0
             ? solve<0>(in, out, scratch, batch, n_st, max_iter, eps_ipm,
                        scheme, st)
             : solve<3>(in, out, scratch, batch, n_st, max_iter, eps_ipm,
                        scheme, st);
}

// The launch of the system's instantiation at horizon n_st: out = {dynamic
// shared memory bytes per block, threads per block, blocks an SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per
// thread, local-memory (stack and spill) bytes per thread, SMs on the
// card}, the same for both schemes (one kernel).  Returns a cudaError_t.
extern "C" int mpcc_ipm_launch_config(int system, int n_st, int* out) {
  if (system == 0) return launch_config<0>(n_st, out);
  if (system == 3) return launch_config<3>(n_st, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
