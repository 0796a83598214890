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
// m = 479); one launch at the RTI cap of 200 iterations and batch 1024 is
// 83 GFLOP, 1.25 ms at the 67 TFLOP/s of float32 outside the tensor cores.
// Its bytes (A 343 KB, K^-1 and P 128 KB each: 613 KB per scenario, 628 MB
// at batch 1024) take 0.19 ms to read once at 3.35 TB/s.
//
// Design: one thread block cluster of C blocks (512 threads each) per
// scenario, so that A and K^-1 are read from device memory once per launch
// and stay on chip for every iteration, as the TPU kernel kept them in
// VMEM.  Block r of the cluster holds rows [r ceil(m/C), ...) of A and
// columns [r ceil(n/C), ...) of K^-1 in registers (at C = 4: 120 x 179 and
// 179 x 45 floats, 48 + 18 registers a thread): warp w takes RA
// neighbouring rows, lane l the columns l, l + 32, ... (n <= 192).  One
// iteration is then
//   1. the block's partial A'w over its rows (register FMAs, the warps'
//      partials meeting in shared memory), sent into slot r of every
//      block's `parts`;
//   2. once all C partials are in, rhs from them (summed in rank order in
//      every block) and the block's columns of x = rhs' K^-1, sent into
//      every block's next x buffer (x is double-buffered: a block may send
//      x_{k+1} while another still reads x_k);
//   3. once all of x is in, A x on the block's rows and the z / y update,
//      in registers.
// The blocks talk through distributed shared memory: st.async puts each
// float into the receiving block and counts its bytes on the receiver's
// mbarrier, which completes a phase when all the bytes it expects have
// come.  A block waits only for the data it needs, with no cluster
// barrier in the loop: a cluster barrier in each of the two exchanges cost
// 40 % more time (18.0 against 12.9 ms in chip_smoke.py).  The test every
// `check_every` iterations reads P from device memory (x'P by columns,
// split over the blocks), takes y'A from the resident A like step 1, and
// meets the blocks' maxima through one more message; every block reaches
// the same verdict from the same maxima, so the cluster leaves its loop
// together.  C is the smallest of 1, 2, 4 and 8 that holds the problem (a
// block holds at most 128 rows of A and 48 columns of K^-1; n <= 192,
// m <= 1024).  Nothing is padded in memory; the ragged edges are masked,
// and a block may own no rows or no columns.  The TPU kernel's 256/512
// padding and its transposed copy of A were Mosaic layout needs and are
// not carried over.
//
// Measured (chip_smoke.py, batch 1024, 200 iterations, n = 179, m = 479,
// NVIDIA H100 80GB HBM3 at 700 W): 12.3 ms against the 1.29 ms bound, with
// 30 clusters of 4 on the card at once (cudaOccupancyMaxActiveClusters);
// the earlier design, one block per scenario streaming A from L2 / HBM
// twice per iteration, took 68.4 ms.  What holds it is latency, not arithmetic: 34
// rounds of 30 scenarios at ~1.7 us per iteration, where the FMAs of one
// iteration issue in ~0.25 us on an SM; the rest is the two exchanges and
// the block reductions, one after another.  PERF.md has the numbers.
//
// NaN: the maxima, the clip and the reductions propagate a NaN as
// jnp.max / jnp.clip do, so a scenario with a NaN never tests converged:
// it runs to its budget and comes out NaN, and no other scenario sees it.
// No reduction uses atomics: every sum has a fixed order, so a launch
// repeats bit for bit.
//
// Layouts (row-major, batch-first): kinv, p (B,n,n); a (B,m,n); q, dscl,
// x0 (B,n); rho, l, u, escl, z0, y0 (B,m); cscl (B)
//   -> x (B,n), z, y (B,m), it (B) int32 (iterations run, whole chunks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int CPL = 6;            // columns a lane holds: n <= 32 * CPL
constexpr int XW = 32 * CPL;      // the padded width of an n-vector
constexpr int RA = 8;             // rows of A a warp holds
constexpr int RK = 3;             // columns of K^-1 a warp holds
constexpr int ROWS = NWARPS * RA;  // rows of A a block holds at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;   // propagates NaN like jnp.maximum
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__host__ __device__ constexpr int pow2_at_least(int r) {
  return r <= 1 ? 1 : 2 * pow2_at_least((r + 1) / 2);
}

// One halving step of transpose_sum: lanes with bit O set keep the upper
// H rows, the others the lower H, each adding its partner's copy.
template <int H, int O, int R>
__device__ __forceinline__ void transpose_step(float (&v)[R], int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & O;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = up ? v[k] : v[k + H];
      const float keep = up ? v[k + H] : v[k];
      v[k] = keep + __shfl_xor_sync(FULL, send, O);
    }
    transpose_step<H / 2, O / 2>(v, lane);
  }
}

// Sums v[k] over the 32 lanes of a warp for every k < R (a power of two)
// in R - 1 + log2(32 / R) shuffles: lane l returns the sum for row
// k = l / (32 / R), and the 32 / R lanes that share a row get the same bits.
template <int R>
__device__ __forceinline__ float transpose_sum(float (&v)[R], int lane) {
  transpose_step<R / 2, 16>(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = 16 / R; o >= 1; o /= 2) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// tile[k, :] . v for the R rows of a warp's tile (lane l holds columns
// l + 32 c); lane l gets row l / (32 / pow2_at_least(R)).
template <int R>
__device__ __forceinline__ float tile_dot(const float (&tile)[R][CPL],
                                          const float* v, int lane) {
  constexpr int P = pow2_at_least(R);
  float vv[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) vv[c] = v[lane + 32 * c];
  float acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    acc[k] = 0.f;
    if (k < R) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[k] = fmaf(tile[k < R ? k : 0][c],
                                                  vv[c], acc[k]);
    }
  }
  return transpose_sum<P>(acc, lane);
}

// Distributed shared memory messages.  A block sends a float into the same
// place of another block's shared memory with st.async, which counts its
// bytes on that block's mbarrier; the receiver waits for the phase of its
// mbarrier that completes when all the bytes it expects have come.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of `local` (in this block's shared memory) in block `rank`
__device__ __forceinline__ unsigned in_block(const void* local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_u32(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void send(float* local, unsigned long long* mb,
                                     int rank, float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(in_block(local, rank)), "r"(__float_as_uint(v)),
      "r"(in_block(mb, rank)) : "memory");
}

// arms the next phase of `mb` (one arrival) for `bytes` of messages
__device__ __forceinline__ void expect(unsigned long long* mb,
                                       unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
      :: "r"(smem_u32(mb)), "r"(bytes) : "memory");
}

// Waits until the phase of `mb` with this parity completes.  A message
// that never comes traps after ~2^35 cycles instead of hanging the card.
__device__ __forceinline__ void wait_phase(unsigned long long* mb,
                                           unsigned parity) {
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(mb)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// Block-wide NaN-propagating max; every thread gets the result.  `red`
// holds NWARPS floats; the leading barrier protects it from its last use.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARPS; ++w) r = nan_max(r, red[w]);
  return r;
}

// the mbarriers of the messages: the blocks' v'A partials, x (one per
// buffer), the maxima of the test
enum { MB_PARTS, MB_X0, MB_X1, MB_STATS, MB_COUNT };

struct Shared {
  unsigned long long* mbar;   // MB_COUNT mbarriers
  float *x;      // two full x buffers (XW each): x[k XW + j]
  float *q, *d, *rhs;   // full q, D and rhs (XW each)
  float *parts;  // (C, XW): the blocks' partial v'A, sent by each block
  float *part;   // (NWARPS, XW) warp partials; K^-1's staging area at entry
  float *stats;  // (C, 4): the blocks' maxima of the test, sent
  float *red;    // (NWARPS, 4)
  float *rho, *irho, *l, *u, *e;   // the block's rows (ROWS each)
};

size_t smem_floats(int n, int cl) {
  const size_t nck = (n + cl - 1) / cl;
  const size_t part = (size_t)NWARPS * XW > n * nck ? (size_t)NWARPS * XW
                                                    : n * nck;
  return 2 * MB_COUNT + 5 * (size_t)XW + (size_t)cl * XW + part
         + 4 * (size_t)cl + 4 * (size_t)NWARPS + 5 * (size_t)ROWS;
}

__device__ Shared carve(float* base, int n, int cl) {
  const int nck = (n + cl - 1) / cl;
  Shared s;
  s.mbar = reinterpret_cast<unsigned long long*>(base);
  float* p = base + 2 * MB_COUNT;
  s.x = p; p += 2 * XW;
  s.q = p; p += XW;
  s.d = p; p += XW;
  s.rhs = p; p += XW;
  s.parts = p; p += (size_t)cl * XW;
  s.part = p; p += NWARPS * XW > n * nck ? NWARPS * XW : n * nck;
  s.stats = p; p += 4 * cl;
  s.red = p; p += 4 * NWARPS;
  s.rho = p; p += ROWS;
  s.irho = p; p += ROWS;
  s.l = p; p += ROWS;
  s.u = p; p += ROWS;
  s.e = p;
  return s;
}

struct Params {
  int n, m, max_iter, check_every;
  float sigma, alpha, eps_abs, eps_rel;
};

struct Inputs {
  const float *kinv, *p, *a, *q, *rho, *l, *u, *dscl, *escl, *cscl, *x0,
      *z0, *y0;
};
struct Outputs {
  float *x, *z, *y;
  int* it;
};

__global__ void __launch_bounds__(THREADS, 1)
admm_kernel(Inputs in, Outputs out, Params pr) {
  constexpr int GA = 32 / pow2_at_least(RA);   // lanes sharing a row of A
  constexpr int GK = 32 / pow2_at_least(RK);   // lanes sharing a column
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = cluster.num_blocks(), rank = cluster.block_rank();
  const int n = pr.n, m = pr.m, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x / cl;
  // this block's rows [r0, r0 + mr) of A and columns [c0, c0 + nc) of K^-1
  const int mc = (m + cl - 1) / cl, nck = (n + cl - 1) / cl;
  const int r0 = min(rank * mc, m), mr = min(m, r0 + mc) - r0;
  const int c0 = min(rank * nck, n), nc = min(n, c0 + nck) - c0;
  const Shared s = carve(smem, n, cl);

  for (int j = tid; j < XW; j += THREADS) {
    const bool in_n = j < n;
    s.x[j] = in_n ? in.x0[b * n + j] : 0.f;
    s.x[XW + j] = 0.f;
    s.q[j] = in_n ? in.q[b * n + j] : 0.f;
    s.d[j] = in_n ? in.dscl[b * n + j] : 0.f;
    s.rhs[j] = 0.f;
  }
  // K^-1's columns through shared memory (coalesced reads), A's rows
  // straight into registers; neither is read from device memory again
  for (int lr = tid; lr < mr; lr += THREADS) {
    const size_t i = b * m + r0 + lr;
    s.rho[lr] = in.rho[i];
    s.irho[lr] = 1.f / in.rho[i];
    s.l[lr] = in.l[i];
    s.u[lr] = in.u[i];
    s.e[lr] = in.escl[i];
  }
  const float* kinv = in.kinv + b * n * n + c0;
  for (int idx = tid; idx < n * nc; idx += THREADS) {
    const int i = idx / nc;
    s.part[idx] = kinv[(size_t)i * n + idx - i * nc];
  }
  float a[RA][CPL];
  const float* arows = in.a + (b * m + r0) * n;
#pragma unroll
  for (int k = 0; k < RA; ++k) {
    const int lr = warp * RA + k;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane + 32 * c;
      a[k][c] = (lr < mr && j < n) ? arows[(size_t)lr * n + j] : 0.f;
    }
  }
  __syncthreads();
  float kt[RK][CPL];   // kt[k][c] = K^-1[lane + 32 c, c0 + warp RK + k]
#pragma unroll
  for (int k = 0; k < RK; ++k) {
    const int jj = warp * RK + k;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int i = lane + 32 * c;
      kt[k][c] = (jj < nc && i < n) ? s.part[i * nc + jj] : 0.f;
    }
  }

  // the row of A this lane updates (GA lanes hold each row, identically)
  const int lrow = warp * RA + lane / GA;
  const bool own = lane / GA < RA && lrow < mr;
  const size_t gi = b * m + r0 + lrow;
  float z = 0.f, y = 0.f;   // this lane's row of z and y
  if (own) {
    z = in.z0[gi];
    y = in.y0[gi];
  }
  const float cscl = in.cscl[b];
  __syncthreads();   // the staging area is free again
  float qd = 0.f;
  for (int j = tid; j < n; j += THREADS)
    qd = nan_max(qd, fabsf(s.d[j] * s.q[j]));
  const float q_abs_d = block_max(qd, s.red);
  // the bytes each message brings: every block's n partials, the blocks'
  // slices of x, every block's 4 maxima
  const unsigned parts_bytes = 4u * cl * n, x_bytes = 4u * n,
                 stats_bytes = 16u * cl;
  if (tid == 0) {
    for (int k = 0; k < MB_COUNT; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&s.mbar[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    expect(&s.mbar[MB_PARTS], parts_bytes);
    expect(&s.mbar[MB_X0], x_bytes);
    expect(&s.mbar[MB_X1], x_bytes);
    expect(&s.mbar[MB_STATS], stats_bytes);
  }
  // every block of the cluster runs, its mbarriers armed, before any
  // message reaches it
  cluster.sync();
  unsigned phase = 0;   // bit k: the parity of mbarrier k's next phase
  auto wait_and_rearm = [&](int k, unsigned bytes) {
    wait_phase(&s.mbar[k], (phase >> k) & 1u);
    phase ^= 1u << k;
    if (tid == 0) expect(&s.mbar[k], bytes);
  };

  // v'A over this block's rows (v: this lane's row weight), sent into slot
  // `rank` of every block's parts; returns when every block's has come
  auto send_col_sums = [&](float vrow) {
    float vk[RA];
#pragma unroll
    for (int k = 0; k < RA; ++k) vk[k] = __shfl_sync(FULL, vrow, k * GA);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < RA; ++k) acc = fmaf(a[k][c], vk[k], acc);
      s.part[warp * XW + lane + 32 * c] = acc;
    }
    __syncthreads();
    for (int j = tid; j < n; j += THREADS) {
      float acc = s.part[j];
      for (int w = 1; w < NWARPS; ++w) acc += s.part[w * XW + j];
      for (int r = 0; r < cl; ++r)
        send(&s.parts[rank * XW + j], &s.mbar[MB_PARTS], r, acc);
    }
    wait_and_rearm(MB_PARTS, parts_bytes);
  };
  // the blocks' partials of column j, summed in rank order
  auto parts_sum = [&](int j) {
    float acc = s.parts[j];
    for (int r = 1; r < cl; ++r) acc += s.parts[r * XW + j];
    return acc;
  };

  int cur = 0;   // x buffer `cur` holds the current x
  float ax = 0.f;
  {
    const float t = tile_dot(a, s.x, lane);
    if (own) ax = t;
  }
  // The unscaled OSQP test on (x, z, y) with ax = A x; every thread of the
  // cluster returns the same verdict.
  auto converged = [&]() {
    const float* xc = s.x + cur * XW;
    const float* p = in.p + b * n * n + c0;   // x'P on this block's columns
    for (int j = lane; j < nc; j += 32) {
      float acc = 0.f;
      for (int i = warp; i < n; i += NWARPS)
        acc = fmaf(p[(size_t)i * n + j], xc[i], acc);
      s.part[warp * XW + j] = acc;
    }
    __syncthreads();
    float px = 0.f;
    if (tid < nc) {
      px = s.part[tid];
      for (int w = 1; w < NWARPS; ++w) px += s.part[w * XW + tid];
    }
    __syncthreads();
    send_col_sums(own ? y : 0.f);                  // y'A
    float v[4] = {0.f, 0.f, 0.f, 0.f};   // r_prim, s_prim, r_dual, s_dual
    if (own) {
      const float e = s.e[lrow];
      v[0] = fabsf((ax - z) / e);
      v[1] = nan_max(fabsf(ax / e), fabsf(z / e));
    }
    if (tid < nc) {
      const int j = c0 + tid;
      const float aty = parts_sum(j), dj = s.d[j];
      v[2] = fabsf(dj * (px + s.q[j] + aty) / cscl);
      v[3] = nan_max(fabsf(dj * px), fabsf(dj * aty));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (int o = 16; o > 0; o >>= 1)
        v[k] = nan_max(v[k], __shfl_xor_sync(FULL, v[k], o));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s.red[warp * 4 + k] = v[k];
    }
    __syncthreads();
    if (tid < 4) {
      float mx = s.red[tid];
      for (int w = 1; w < NWARPS; ++w) mx = nan_max(mx, s.red[w * 4 + tid]);
      for (int r = 0; r < cl; ++r)
        send(&s.stats[rank * 4 + tid], &s.mbar[MB_STATS], r, mx);
    }
    wait_and_rearm(MB_STATS, stats_bytes);
    float st[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      st[k] = s.stats[k];
      for (int r = 1; r < cl; ++r) st[k] = nan_max(st[k], s.stats[r * 4 + k]);
    }
    const float s_dual = nan_max(st[3], q_abs_d) / cscl;
    return st[0] <= pr.eps_abs + pr.eps_rel * st[1]
           && st[2] <= pr.eps_abs + pr.eps_rel * s_dual;
  };

  // entry test: a warm start that already passes exits with it = 0
  bool done = converged();
  int it = 0;
  while (!done && it < pr.max_iter) {
    for (int k = 0; k < pr.check_every; ++k) {
      send_col_sums(own ? s.rho[lrow] * z - y : 0.f);  // A'(rho z - y)
      const float* xc = s.x + cur * XW;
      for (int j = tid; j < n; j += THREADS)
        s.rhs[j] = pr.sigma * xc[j] - s.q[j] + parts_sum(j);
      __syncthreads();
      // this block's columns of x = rhs' K^-1, into every block's next x
      const float xj = tile_dot(kt, s.rhs, lane);
      const int kk = lane / GK, jj = warp * RK + kk;
      if (lane % GK == 0 && kk < RK && jj < nc)
        for (int r = 0; r < cl; ++r)
          send(&s.x[(cur ^ 1) * XW + c0 + jj], &s.mbar[MB_X0 + (cur ^ 1)],
               r, xj);
      wait_and_rearm(MB_X0 + (cur ^ 1), x_bytes);
      cur ^= 1;
      const float zt = tile_dot(a, s.x + cur * XW, lane);   // zt = A x
      if (own) {
        const float zr = pr.alpha * zt + (1.f - pr.alpha) * z;
        const float zn =
            nan_min(nan_max(zr + y * s.irho[lrow], s.l[lrow]), s.u[lrow]);
        y = y + s.rho[lrow] * (zr - zn);
        z = zn;
        ax = zt;
      }
    }
    it += pr.check_every;
    done = converged();
  }

  const float* xc = s.x + cur * XW;
  for (int j = tid; j < nc; j += THREADS) out.x[b * n + c0 + j] = xc[c0 + j];
  if (own && lane % GA == 0) {
    out.z[gi] = z;
    out.y[gi] = y;
  }
  if (rank == 0 && tid == 0) out.it[b] = it;
  cluster.sync();   // no block leaves while another may address its memory
}

// The cluster size for a problem; false where none holds it.  `want` 0
// picks the smallest cluster that does.
struct Choice {
  int cluster;
  size_t smem;
};

const void* const KERNEL = (const void*)admm_kernel;

bool choose(int n, int m, int want, Choice* ch) {
  if (n < 1 || n > XW || m < 0) return false;
  for (int cl = 1; cl <= 8; cl *= 2) {
    if (want != 0 && want != cl) continue;
    if ((m + cl - 1) / cl > ROWS || (n + cl - 1) / cl > NWARPS * RK)
      continue;
    ch->cluster = cl;
    ch->smem = smem_floats(n, cl) * sizeof(float);
    return true;
  }
  return false;
}

cudaLaunchConfig_t launch_config(const Choice& ch, int batch,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * ch.cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = ch.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ch.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// `cluster` 0 picks the cluster size from (n, m); 1, 2, 4 or 8 asks for
// one.  Returns the cudaError_t of the launch (cudaErrorInvalidValue where
// no cluster of that size holds the problem).
extern "C" int mpcc_admm_solve_cluster(
    const float* kinv, const float* p, const float* a, const float* q,
    const float* rho, const float* l, const float* u, const float* dscl,
    const float* escl, const float* cscl, const float* x0, const float* z0,
    const float* y0, float* x, float* z, float* y, int* it, int batch, int n,
    int m, int max_iter, int check_every, float sigma, float alpha,
    float eps_abs, float eps_rel, int cluster, void* stream) {
  Choice ch;
  if (!choose(n, m, cluster, &ch)) return cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ch.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(ch, batch, static_cast<cudaStream_t>(stream), &attr);
  Inputs in{kinv, p, a, q, rho, l, u, dscl, escl, cscl, x0, z0, y0};
  Outputs out{x, z, y, it};
  Params pr{n, m, max_iter, check_every, sigma, alpha, eps_abs, eps_rel};
  void* args[] = {&in, &out, &pr};
  err = cudaLaunchKernelExC(&cfg, KERNEL, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpcc_admm_solve(
    const float* kinv, const float* p, const float* a, const float* q,
    const float* rho, const float* l, const float* u, const float* dscl,
    const float* escl, const float* cscl, const float* x0, const float* z0,
    const float* y0, float* x, float* z, float* y, int* it, int batch, int n,
    int m, int max_iter, int check_every, float sigma, float alpha,
    float eps_abs, float eps_rel, void* stream) {
  return mpcc_admm_solve_cluster(kinv, p, a, q, rho, l, u, dscl, escl, cscl,
                                 x0, z0, y0, x, z, y, it, batch, n, m,
                                 max_iter, check_every, sigma, alpha,
                                 eps_abs, eps_rel, 0, stream);
}

// The launch a problem gets: out = {cluster size, dynamic shared memory
// bytes per block, threads per block, clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), registers per thread, local-memory
// (stack and spill) bytes per thread}.  Returns a cudaError_t.
extern "C" int mpcc_admm_launch_config(int n, int m, int cluster,
                                       int* out) {
  Choice ch;
  if (!choose(n, m, cluster, &ch)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ch.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, KERNEL);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(ch, 1, nullptr, &attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, KERNEL, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ch.cluster;
  out[1] = static_cast<int>(ch.smem);
  out[2] = THREADS;
  out[3] = active;
  out[4] = fa.numRegs;
  out[5] = static_cast<int>(fa.localSizeBytes);
  return 0;
}
