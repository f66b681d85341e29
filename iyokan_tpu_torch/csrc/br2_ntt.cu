// Lvl2 blind rotation (circuit bootstrapping) over the two-prime NTT for
// Hopper (sm_90a): K7.
//
// Counterpart of the loop of iyokan_tpu/crypto/ops.py:blind_rotate2
// (:464-515), a jax.lax.fori_loop that XLA compiles into one device loop;
// the JAX package has no Pallas kernel for it.  One launch runs every step
// of a blind rotation of G rows; per step i and row g
//   acc += sum_m decompose2(X^{a[i,m,g]} * acc - acc) (x) bk2[i, m]
//                                                                (mod 2^64)
// with acc the TRLWE lvl2 accumulator u64 [G, 2, N2] (the 64-bit torus),
// M = 1 rotation a step on the plain key (n steps) or M = 3 on the
// 2-bit-unrolled key (ceil(n/2) steps: amounts a1, a2, a1 + a2 of a key-bit
// pair), the l2 signed gadget digits of each part (|d| <= Bg2/2 = 128,
// decompose2: offset sum_j 128 2^(64 - 8(j+1)) + 2^(63 - 40)) and the
// CRT64-prepared key (crypto/polymul.prep2: residues mod the two primes of
// ntt.cuh of each row's two 32-bit halves, lo = x & 0xFFFFFFFF, hi =
// (x >> 32) & 0xFFFFFFFF).  The twin is ops/br2.py:blind_rotate2_ref.
//
// Exact: each half's product is an integer of |conv| <= M 2l2 N2 128 2^32 =
// 30 * 2^50 < 2^55 (M = 3, N2 = 2048), below P1*P2/2 = 2^60.7, so the
// centred CRT recovers it and lo + (hi << 32) mod 2^64 is the step's
// update, as in the twin (polymul.extprod2).  All torus arithmetic is in
// uint64_t: it wraps as torch's int64 does, where signed overflow would be
// undefined.
//
// Design: the cluster form of br_cluster.cuh (K4's) at N2 = 2048, on its
// launch plumbing (ClusterPlan) and ntt.cuh's transforms and products, with
// R rows a cluster (R <= BR2_R_MAX; the launcher's R, ops/br2.py:
// rows_per_cluster).  A launch of G rows runs ceil(G / R) clusters of four
// CTAs; CTA rank 2p + u owns prime p and part u of the accumulator of each
// of its cluster's R rows, and keeps those acc[r][u] as uint64 [N2] in its
// shared memory for all S steps (the last cluster's missing rows repeat
// row G - 1 and are never written back).  A step in CTA (p, u), the R rows
// together through every phase:
//   1. for each of the M rotations in turn: part u's l2 digit rows of
//      X^{a_m} acc[r][u] - acc[r][u] of every row r, as residues mod p,
//      inside the first two butterfly stages of their forward transforms,
//      then the rest of the transforms (ntt_fwd at NP = R: one twiddle load
//      a butterfly position for R independent chains); then their products
//      with the key into four sums a row kept in registers, outputs v = 0, 1
//      x halves h = lo, hi (the products are linear, so the M rotations
//      never need their digit rows at once): each key word is loaded once a
//      step and used for all R rows; per sum and m, four products summed in
//      64 bits, one conditional subtract of P 2^32, the fifth product, one
//      mont_reduce (x 2^-32; the key form carries N2^-1 2^32,
//      ops/br2.py:kernel_key2), added mod p;
//   2. the sums to shared memory, over the digit rows (the two never live
//      at once), then after cluster barrier 1, the inverse transforms of
//      output u of every row, both halves (NP = R), each loading its own sum
//      plus CTA (p, 1 - u)'s sum of output u (distributed shared memory);
//   3. after cluster barrier 2, Garner's CRT with CTA (1 - p, u)'s residues,
//      both halves as centred integers, and acc[r][u] += c_lo + (c_hi << 32)
//      (both CTAs of part u keep the same acc[r][u]).
// The region's sums are read by the other CTAs until the other prime's
// Garner is done.  Where two regions fit (R <= 2 at N2 = 2048) a step uses
// the one of its parity, as K4 double-buffers its sums; at R = 3 one
// region, and barrier 3 keeps a step's digit rows off the sums the other
// prime's CTA still reads: each thread arrives after its Garner and waits
// just before its first digit store of the next step, so the wait overlaps
// the digit arithmetic.  A step's serial chain is M times (l2 forward
// transforms + the products), then two inverses, on four SMs, with two
// cluster barriers (three at R = 3) and the same block barriers at every
// R: R rows cost R times the arithmetic behind the same barriers and
// dependent chains.
//
// Shared memory a CTA (br2_smem): this prime's forward and inverse twiddles
// with companions (2N uint2, 32 KiB), acc (R N uint64, 16 KiB a row) and
// one or two regions of l2 R N words (40 KiB a row) that hold a rotation's
// digit rows, then the four sums of every row (32 KiB a row): 128 KiB at
// R = 1, 224 at 2 (two regions), 200 at 3 (one), N2 = 2048; one CTA an
// SM, so the H100 holds 30 clusters at once and memmac's 69 rows run as
// one wave of 23 clusters of 3.  R = 4 would need 256 KiB even with one
// region, over the 227 KiB a CTA may have.
// Threads a CTA: 1024 (BR2_THREADS); the sums of a row take 8 registers a
// thread (two coefficients x four sums).
//
// What bounds it on the H100: 32-bit integer multiplies.  Per row and
// unrolled step, 2 primes x (34 transforms x N/2 log2 N butterflies +
// 2 * 30 * 2N key products + 4N scalings) + 4N Garner products, about
// three multiplies each.  The key (S x 4 x M l2 x 4 x N x 4 bytes: 625 MB
// unrolled, 1.97 MB a step) is larger than the 50 MB L2; each cluster
// reads every step of it once for its R rows, CTA (p, u) its own
// contiguous quarter.
//
// Built by iyokan_tpu_torch/ops/nvcc.py (hash of this file and the headers
// it includes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbr2_ntt-<hash>.so br2_ntt.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "br_cluster.cuh"

namespace {

constexpr int BR2_L = 5;      // l2: gadget digits a part, every parameter set
constexpr int BR2_BGBIT = 8;  // Bgbit2: their base 2^8
constexpr int BR2_THREADS = 1024;  // threads a CTA
// Rows a cluster at most: 3 puts memmac's 69 rows in one wave of 23
// clusters (4 would need 256 KiB a CTA).
constexpr int BR2_R_MAX = 3;
static_assert(BR2_L == 5, "the products below sum 4 + 1 terms a row");
static_assert(BR2_L >= 4, "the digit region also holds a row's four sums");

struct Br2Args {
  uint64_t* acc;           // [G, 2, N] u64 torus, updated in place
  const int32_t* amounts;  // [S, M, G] rotation amounts (taken mod 2N)
  const uint32_t* key;     // kernel form [S, 2 (p), 2 (u), M, l2, 2 (v),
                           //              2 (h), N]
  const uint2* tw;         // [2 primes][forward, inverse][N] (w, w')
  uint64_t offset;         // decompose2's centring + rounding offset
  int S, G, logN;
};

// Digit regions a CTA at R rows: two, by step parity, where they fit at
// N = 2048 (R <= 2), so a step's digit rows never meet the sums that the
// other prime's CTA may still read for Garner; else one, and barrier 3
// (slower where two fit: tools/k7_forms.json).
__host__ __device__ constexpr int br2_regions(int R) {
  return 2 * 2048 * 8 + R * 2048 * 8 + 2 * BR2_L * R * 2048 * 4 <=
                 (int)MAX_SMEM
             ? 2
             : 1;
}

inline size_t br2_smem(int N, int R) {
  return (size_t)2 * N * sizeof(uint2) + (size_t)R * N * sizeof(uint64_t) +
         (size_t)br2_regions(R) * BR2_L * R * N * sizeof(uint32_t);
}

// Barrier 3, split: arrive (release) after this thread's last read of
// another CTA's shared memory in a step, wait (acquire) before its first
// write that another CTA's reads must precede.  Not .aligned: a warp's
// threads may wait at different points.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The l2 gadget digits of coefficient c of X^a x - x (x: one part of the
// accumulator, a in [0, 2N)), as residues mod P.
template <uint32_t P>
__device__ __forceinline__ void digits2_at(const uint64_t* x, int c, int a,
                                           int N, uint64_t offset,
                                           uint32_t* out) {
  int m = c - a;  // coefficient c of X^a x is x[c - a], negated past N
  if (m < 0) m += 2 * N;
  const uint64_t rot = m < N ? x[m] : 0ull - x[m - N];
  const uint64_t xp = rot - x[c] + offset;
#pragma unroll
  for (int j = 0; j < BR2_L; ++j)
    out[j] = residue<P>(
        (int32_t)((xp >> (64 - (j + 1) * BR2_BGBIT)) &
                  ((1u << BR2_BGBIT) - 1)) -
        (1 << (BR2_BGBIT - 1)));
}

// Garner: the integer x = r1 + P1 * ((r2 - r1) * P1^-1 mod P2) in
// [0, P1*P2), centred to (-P1*P2/2, P1*P2/2), as a u64 bit pattern
// (crypto/ntt.py:crt_center).
__device__ __forceinline__ uint64_t crt_center64(uint32_t r1, uint32_t r2) {
  const uint32_t diff = submod<P2>(r2, r1 >= P2 ? r1 - P2 : r1);
  const uint64_t x =
      r1 + (uint64_t)P1 *
               shoup_mul<P2>(diff, INV_P1_MOD_P2, INV_P1_MOD_P2_S);
  return x >= P1P2 / 2 ? x - P1P2 : x;
}

// The torus update c_lo + (c_hi << 32) of residue pair i: lo at r1[i],
// r2[i], hi `half` words further on (r1 mod P1, r2 mod P2).
__device__ __forceinline__ uint64_t crt_pair(const uint32_t* r1,
                                             const uint32_t* r2, int i,
                                             int half) {
  return crt_center64(r1[i], r2[i]) +
         (crt_center64(r1[i + half], r2[i + half]) << 32);
}

// NT threads a CTA, R rows a cluster; LOGN: log2 N fixed at compile time
// (0: A.logN, N at most 2048).
template <uint32_t P, int M, int R, int NT, int LOGN>
__device__ __forceinline__ void br2_body(const Br2Args& A, unsigned rank,
                                         uint32_t* sm) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int L = BR2_L;
  // coefficients a thread in the products (N at most 2048); EVEN: NT
  // divides N, so every thread has all CPT of them
  constexpr int CPT = ((LOGN ? 1 << LOGN : 2048) + NT - 1) / NT;
  constexpr bool EVEN = LOGN && (1 << LOGN) % NT == 0;
  const int logN = LOGN ? LOGN : A.logN, N = 1 << logN, Q = N >> 2;
  const int tid = threadIdx.x, p = rank >> 1, u = rank & 1;
  const int g0 = blockIdx.x / BR_CLUSTER * R, G = A.G;
  uint2* twf = reinterpret_cast<uint2*>(sm);
  uint2* twi = twf + N;
  uint64_t* acc = reinterpret_cast<uint64_t*>(twi + N);  // [R][N]
  // per region: [L][R][N] digit rows, then [2 (v)][2 (h)][R][N] sums
  constexpr bool ONE_REGION = br2_regions(R) == 1;  // then barrier 3
  uint32_t* const dig0 = reinterpret_cast<uint32_t*>(acc + R * N);

  for (int i = tid; i < N; i += NT) {
    twf[i] = A.tw[(2 * p) * N + i];
    twi[i] = A.tw[(2 * p + 1) * N + i];
  }
  for (int i = tid; i < R * N; i += NT) {
    const int g = min(g0 + (i >> logN), G - 1);
    acc[i] = A.acc[((size_t)g * 2 + u) * N + (i & (N - 1))];
  }
  // No cluster barrier here: the first access to another CTA's shared
  // memory follows barrier 1 of the first step.
  __syncthreads();
  const uint32_t* const dig_pu0 = cluster.map_shared_rank(dig0, rank ^ 1);
  const uint32_t* const dig_pp0 = cluster.map_shared_rank(dig0, rank ^ 2);
  const size_t slice = (size_t)M * L * 4 * N;  // int32 of this CTA a step
  const uint32_t* key = A.key + (size_t)(2 * p + u) * slice;

  for (int i = 0; i < A.S; ++i, key += 4 * slice) {
    uint32_t sum[CPT][R][4];  // [coefficient][row][v h] of this thread
    const int region = ONE_REGION ? 0 : (i & 1) * L * R * N;
    uint32_t* const dig = dig0 + region;
    const uint32_t* const dig_pu = dig_pu0 + region;
#pragma unroll  // M = 3: faster than a loop (tools/k7_forms.json)
    for (int m = 0; m < M; ++m) {
      // 1. part u's digit rows of every row inside the first two forward
      // stages (residues c, c + N/4, c + N/2, c + 3N/4), then the rest
      bool wait = ONE_REGION && i > 0 && m == 0;  // barrier 3, step i - 1
      for (int idx = tid; idx < R * Q; idx += NT) {
        const int r = idx >> (logN - 2), c = idx & (Q - 1);
        const int a = A.amounts[((size_t)i * M + m) * G +
                                min(g0 + r, G - 1)] &
                      (2 * N - 1);
        uint32_t x[4][L];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          digits2_at<P>(acc + r * N, c + e * Q, a, N, A.offset, x[e]);
#pragma unroll
        for (int j = 0; j < L; ++j)
          ct4<P>(x[0][j], x[1][j], x[2][j], x[3][j], twf, 1, 0);
        if (wait) {
          cluster_wait();
          wait = false;
        }
#pragma unroll
        for (int j = 0; j < L; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dig[(j * R + r) * N + c + e * Q] = x[e][j];
      }
      if (wait) cluster_wait();  // a thread with no digit item
      __syncthreads();
      ntt_fwd<P, R, NT>(dig, L * R, twf, N, logN, logN - 3);

      // the products with the key of rotation m, into the sums: each key
      // word loaded once for the R rows
      const uint32_t* km = key + (size_t)m * L * 4 * N;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = tid + k * NT;
        if (!EVEN && c >= N) continue;
        uint32_t d[R][L];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < L; ++j) d[r][j] = dig[(j * R + r) * N + c];
#pragma unroll
        for (int vh = 0; vh < 4; ++vh) {
          uint32_t kw[L];
#pragma unroll
          for (int j = 0; j < L; ++j)
            kw[j] = __ldg(km + (size_t)(j * 4 + vh) * N + c);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            uint64_t T = 0;  // four products below P^2: < 2P 2^32
#pragma unroll
            for (int j = 0; j < 4; ++j) T += (uint64_t)d[r][j] * kw[j];
            if (T >= ((uint64_t)P << 32)) T -= (uint64_t)P << 32;
            // below P 2^32, plus the fifth: < 2P 2^32, as mont_reduce needs
            T += (uint64_t)d[r][4] * kw[4];
            const uint32_t t = mont_reduce<P>(T);
            sum[k][r][vh] = m ? addmod<P>(sum[k][r][vh], t) : t;
          }
        }
      }
      __syncthreads();  // the next rotation, or the sums, rewrite dig
    }

    // 2. the sums over the digit rows: [v][h][R][N]
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = tid + k * NT;
      if (!EVEN && c >= N) continue;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int vh = 0; vh < 4; ++vh)
          dig[(vh * R + r) * N + c] = sum[k][r][vh];
    }
    cluster.sync();  // 1: both parts' sums are in place

    // output u of every row, both halves: own sum + the other part's,
    // inverse
    uint32_t* own = dig + u * 2 * R * N;  // [h][R][N]
    ntt_inv<P, R, NT>(own, 2 * R, twi, N, logN, dig_pu + u * 2 * R * N, N,
                      make_uint2(0u, 0u), false);
    cluster.sync();  // 2: both primes' residues of part u are in place

    // 3. Garner with the other prime's CTA, into acc
    const uint32_t* other = dig_pp0 + region + u * 2 * R * N;
    for (int idx = tid; idx < R * N; idx += NT)
      acc[idx] += P == P1 ? crt_pair(own, other, idx, R * N)
                          : crt_pair(other, own, idx, R * N);
    if (ONE_REGION && i + 1 < A.S)
      cluster_arrive();  // 3: this step's remote reads are done
    __syncthreads();  // acc is whole for the next step's digits
  }
  cluster.sync();  // the other CTAs' last reads of this one are done
  if (p == 0)
    for (int idx = tid; idx < R * N; idx += NT)
      if (g0 + (idx >> logN) < G)
        A.acc[((size_t)(g0 + (idx >> logN)) * 2 + u) * N +
              (idx & (N - 1))] = acc[idx];
}

template <int M, int R, int NT, int LOGN>
__global__ void __launch_bounds__(NT, 1) br2_cluster_kernel(const Br2Args A) {
  extern __shared__ __align__(16) uint32_t br2_sm[];
  const unsigned rank = cg::this_cluster().block_rank();
  if (rank >> 1)
    br2_body<P2, M, R, NT, LOGN>(A, rank, br2_sm);
  else
    br2_body<P1, M, R, NT, LOGN>(A, rank, br2_sm);
}

// The instances of one key form (M) at 1..R rows a cluster: N2 fixed at
// 2048 (the 128-bit sets) or read from the launch (at least 256).
template <int M, int R = BR2_R_MAX>
struct Br2Plans {
  Br2Plans<M, R - 1> fewer;
  ClusterPlan<Br2Args> any{br2_cluster_kernel<M, R, BR2_THREADS, 0>,
                           BR2_THREADS};
  ClusterPlan<Br2Args> n2048{br2_cluster_kernel<M, R, BR2_THREADS, 11>,
                             BR2_THREADS};

  ClusterPlan<Br2Args>* pick(int logN, int rows) {
    if (rows < R) return fewer.pick(logN, rows);
    if (rows > R || logN < 8) return nullptr;
    return logN == 11 ? &n2048 : &any;
  }
};

template <int M>
struct Br2Plans<M, 0> {
  ClusterPlan<Br2Args>* pick(int, int) { return nullptr; }
};

Br2Plans<1> plans_plain;     // the plain key, n steps
Br2Plans<3> plans_unrolled;  // the 2-bit-unrolled key, ceil(n/2) steps

// The instance for M, ring size N, l2, Bgbit2 and R rows a cluster, or
// null.
ClusterPlan<Br2Args>* br2_plan(int M, int N, int l, int Bgbit, int R) {
  if (l != BR2_L || Bgbit != BR2_BGBIT) return nullptr;
  const int logN = log2_ring(N);
  return M == 1 ? plans_plain.pick(logN, R)
         : M == 3 ? plans_unrolled.pick(logN, R)
                  : nullptr;
}

int last_rows = 0;  // R of the last launch

}  // namespace

// K7's plan at M and R rows a cluster (R = 0: BR2_R_MAX): out[0] the
// dynamic shared memory a CTA (br2_smem), out[1] the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters), out[2] R, out[3]
// BR2_R_MAX; 0 or a CUDA error (invalid value: M not 1 or 3, l not 5, N
// not a power of two in [256, 2048], R above BR2_R_MAX).
extern "C" int br2_ntt_plan(int N, int l, int M, int R, int device,
                            long long* out) {
  if (R == 0) R = BR2_R_MAX;
  ClusterPlan<Br2Args>* c = br2_plan(M, N, l, BR2_BGBIT, R);
  const size_t smem = br2_smem(N, R);
  int n = 0;
  const int e = c ? c->prepare(device, smem, &n) : (int)cudaErrorInvalidValue;
  out[0] = (long long)smem;
  out[1] = n;
  out[2] = R;
  out[3] = BR2_R_MAX;
  return e;
}

// K7: all S steps of every row in one launch, ceil(G / R) clusters of four
// CTAs of BR2_THREADS threads, R rows each (the last cluster the rest), on
// `stream`.
//   acc int64 [G, 2, N] (u64 bit patterns, updated in place); amounts int32
//   [S, M, G]; kkey int32 [S, 2, 2, M, l, 2, 2, N], the key's kernel form;
//   tw uint32 [2, 2, N, 2] = psirev, psiinvrev of P1, P2 with companions;
//   offset = decompose2's offset mod 2^64; M = 1 or 3; l = 5, Bgbit = 8; N
//   a power of two in [256, 2048]; R in [1, min(G, BR2_R_MAX)] (ops/br2.py:
//   rows_per_cluster).  Returns 0 or the first CUDA error (invalid value
//   for an R out of range); a card that cannot hold one cluster refuses
//   (cudaErrorLaunchOutOfResources).
extern "C" int br2_ntt(void* acc, const void* amounts, const void* kkey,
                       const void* tw, int G, int S, int M, int N, int l,
                       int Bgbit, uint64_t offset, int R, int device,
                       void* stream) {
  if (G <= 0 || S <= 0 || R < 1 || R > BR2_R_MAX || R > G)
    return (int)cudaErrorInvalidValue;
  ClusterPlan<Br2Args>* c = br2_plan(M, N, l, Bgbit, R);
  if (!c) return (int)cudaErrorInvalidValue;
  const Br2Args A{static_cast<uint64_t*>(acc),
                  static_cast<const int32_t*>(amounts),
                  static_cast<const uint32_t*>(kkey),
                  static_cast<const uint2*>(tw),
                  offset,
                  S,
                  G,
                  log2_ring(N)};
  const int e = c->launch(A, (G + R - 1) / R, br2_smem(N, R), device,
                          reinterpret_cast<cudaStream_t>(stream));
  if (!e) last_rows = R;
  return e;
}

// The grid (CTAs), cluster size, threads a CTA and rows a cluster of the
// last launch.
extern "C" void br2_ntt_last_launch(int* out) {
  out[0] = last_launch[0];
  out[1] = last_launch[1];
  out[2] = last_launch[2];
  out[3] = last_rows;
}

extern "C" const char* br2_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
