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
// launch plumbing (ClusterPlan) and ntt.cuh's transforms and products.  One
// cluster of four CTAs a row; CTA rank 2p + u owns prime p and part u of the
// accumulator and keeps acc[u] as uint64 [N2] in its shared memory for all
// S steps.  A step in CTA (p, u):
//   1. for each of the M rotations in turn: part u's l2 digit rows of
//      X^{a_m} acc[u] - acc[u], as residues mod p, inside the first two
//      butterfly stages of their forward transforms, then the rest of the
//      transforms; then their products with the key into four sums, outputs
//      v = 0, 1 x halves h = lo, hi (the products are linear, so the M
//      rotations never need their digit rows at once): per sum and m, four
//      products summed in 64 bits, one conditional subtract of P 2^32, the
//      fifth product, one mont_reduce (x 2^-32; the key form carries
//      N2^-1 2^32, ops/br2.py:kernel_key2), added mod p;
//   2. after cluster barrier 1, the inverse transforms of output u, both
//      halves, each loading its own sum plus CTA (p, 1 - u)'s sum of output
//      u (distributed shared memory);
//   3. after cluster barrier 2, Garner's CRT with CTA (1 - p, u)'s residues,
//      both halves as centred integers, and acc[u] += c_lo + (c_hi << 32)
//      (both CTAs of part u keep the same acc[u]).
// The sums are double-buffered by step parity, as K4's: a step writes the
// buffer of its parity while the other prime's CTA may still read the other.
// A step's serial chain is M times (l2 forward transforms + the products),
// then two inverses, on four SMs, with two cluster barriers.
//
// Shared memory a CTA (br2_smem): this prime's forward and inverse twiddles
// with companions (2N uint2, 32 KiB), acc[u] (N uint64, 16 KiB), one
// rotation's digit rows (l2 N, 40 KiB) and the sums (2 parities x 4 N,
// 64 KiB): 152 KiB at N2 = 2048, one CTA an SM, so the H100 holds 30
// clusters at once and a batch of G rows runs in ceil(G / 30) waves.
// Threads a CTA: 1024 (BR2_THREADS; measured 10-12% faster than 512 at
// every G from 1 to 69 on both key forms, PERF.md).
//
// What bounds it on the H100: 32-bit integer multiplies.  Per row and
// unrolled step, 2 primes x (34 transforms x N/2 log2 N butterflies +
// 2 * 30 * 2N key products + 4N scalings) + 4N Garner products, about
// three multiplies each.  The key (S x 4 x M l2 x 4 x N x 4 bytes: 625 MB
// unrolled, 1.97 MB a step) is larger than the 50 MB L2; each cluster
// reads every step of it once, CTA (p, u) its own contiguous quarter.
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
static_assert(BR2_L == 5, "the products below sum 4 + 1 terms a row");

struct Br2Args {
  uint64_t* acc;           // [G, 2, N] u64 torus, updated in place
  const int32_t* amounts;  // [S, M, G] rotation amounts (taken mod 2N)
  const uint32_t* key;     // kernel form [S, 2 (p), 2 (u), M, l2, 2 (v),
                           //              2 (h), N]
  const uint2* tw;         // [2 primes][forward, inverse][N] (w, w')
  uint64_t offset;         // decompose2's centring + rounding offset
  int S, G, logN;
};

inline size_t br2_smem(int N) {
  return (size_t)2 * N * sizeof(uint2) + (size_t)N * sizeof(uint64_t) +
         (size_t)(BR2_L + 8) * N * sizeof(uint32_t);
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

// NT threads a CTA; LOGN: log2 N fixed at compile time (0: A.logN).
template <uint32_t P, int M, int NT, int LOGN>
__device__ __forceinline__ void br2_body(const Br2Args& A, unsigned rank,
                                         uint32_t* sm) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int L = BR2_L;
  const int logN = LOGN ? LOGN : A.logN, N = 1 << logN, Q = N >> 2;
  const int tid = threadIdx.x, p = rank >> 1, u = rank & 1;
  const int g = blockIdx.x / BR_CLUSTER, G = A.G;
  uint2* twf = reinterpret_cast<uint2*>(sm);
  uint2* twi = twf + N;
  uint64_t* acc = reinterpret_cast<uint64_t*>(twi + N);
  uint32_t* dig = reinterpret_cast<uint32_t*>(acc + N);  // [L][N]
  uint32_t* sum = dig + L * N;  // [2 parities][2 (v)][2 (h)][N]

  for (int i = tid; i < N; i += NT) {
    twf[i] = A.tw[(2 * p) * N + i];
    twi[i] = A.tw[(2 * p + 1) * N + i];
    acc[i] = A.acc[((size_t)g * 2 + u) * N + i];
  }
  // No cluster barrier here: the first access to another CTA's shared
  // memory follows barrier 1 of the first step.
  __syncthreads();
  const uint32_t* sum_pu = cluster.map_shared_rank(sum, rank ^ 1);
  const uint32_t* sum_pp = cluster.map_shared_rank(sum, rank ^ 2);
  const size_t slice = (size_t)M * L * 4 * N;  // int32 of this CTA a step
  const uint32_t* key = A.key + (size_t)(2 * p + u) * slice;

  for (int i = 0; i < A.S; ++i, key += 4 * slice) {
    uint32_t* s = sum + (i & 1) * 4 * N;  // [v][h][N] of this step
#pragma unroll 1
    for (int m = 0; m < M; ++m) {
      const int a = A.amounts[((size_t)i * M + m) * G + g] & (2 * N - 1);
      // 1. part u's digit rows inside the first two forward stages
      // (residues c, c + N/4, c + N/2, c + 3N/4), then the rest
      for (int c = tid; c < Q; c += NT) {
        uint32_t x[4][L];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          digits2_at<P>(acc, c + e * Q, a, N, A.offset, x[e]);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          ct4<P>(x[0][j], x[1][j], x[2][j], x[3][j], twf, 1, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) dig[j * N + c + e * Q] = x[e][j];
        }
      }
      __syncthreads();
      ntt_fwd<P, 1, NT>(dig, L, twf, N, logN, logN - 3);

      // the products with the key of rotation m, into the four sums
      const uint32_t* km = key + (size_t)m * L * 4 * N;
      for (int c = tid; c < N; c += NT) {
        uint32_t d[L];
#pragma unroll
        for (int j = 0; j < L; ++j) d[j] = dig[j * N + c];
#pragma unroll
        for (int vh = 0; vh < 4; ++vh) {
          uint64_t T = 0;  // four products below P^2: < 2P 2^32
#pragma unroll
          for (int j = 0; j < 4; ++j)
            T += (uint64_t)d[j] * __ldg(km + (size_t)(j * 4 + vh) * N + c);
          if (T >= ((uint64_t)P << 32)) T -= (uint64_t)P << 32;
          // below P 2^32, plus the fifth: < 2P 2^32, as mont_reduce needs
          T += (uint64_t)d[4] * __ldg(km + (size_t)(4 * 4 + vh) * N + c);
          const uint32_t t = mont_reduce<P>(T);
          s[vh * N + c] = m ? addmod<P>(s[vh * N + c], t) : t;
        }
      }
      if (m + 1 < M) __syncthreads();  // the next rotation rewrites dig
    }
    cluster.sync();  // 1: both parts' sums are in place

    // 2. output u, both halves: own sum + the other part's, inverse
    uint32_t* own = s + u * 2 * N;
    ntt_inv<P, 1, NT>(own, 2, twi, N, logN,
                      sum_pu + (i & 1) * 4 * N + u * 2 * N, N,
                      make_uint2(0u, 0u), false);
    cluster.sync();  // 2: both primes' residues of part u are in place

    // 3. Garner with the other prime's CTA, into acc[u]
    const uint32_t* other = sum_pp + (i & 1) * 4 * N + u * 2 * N;
    for (int c = tid; c < N; c += NT) {
      const uint64_t lo = P == P1 ? crt_center64(own[c], other[c])
                                  : crt_center64(other[c], own[c]);
      const uint64_t hi = P == P1 ? crt_center64(own[N + c], other[N + c])
                                  : crt_center64(other[N + c], own[N + c]);
      acc[c] += lo + (hi << 32);
    }
    __syncthreads();
  }
  cluster.sync();  // the other CTAs' last reads of this one are done
  if (p == 0)
    for (int c = tid; c < N; c += NT)
      A.acc[((size_t)g * 2 + u) * N + c] = acc[c];
}

template <int M, int NT, int LOGN>
__global__ void __launch_bounds__(NT, 1) br2_cluster_kernel(const Br2Args A) {
  extern __shared__ __align__(16) uint32_t br2_sm[];
  const unsigned rank = cg::this_cluster().block_rank();
  if (rank >> 1)
    br2_body<P2, M, NT, LOGN>(A, rank, br2_sm);
  else
    br2_body<P1, M, NT, LOGN>(A, rank, br2_sm);
}

// The instances of one key form (M): N2 fixed at 2048 (the 128-bit sets)
// or read from the launch (at least 256).
template <int M>
struct Br2Plans {
  ClusterPlan<Br2Args> any{br2_cluster_kernel<M, BR2_THREADS, 0>,
                           BR2_THREADS};
  ClusterPlan<Br2Args> n2048{br2_cluster_kernel<M, BR2_THREADS, 11>,
                             BR2_THREADS};

  ClusterPlan<Br2Args>* pick(int logN) {
    if (logN < 8) return nullptr;
    return logN == 11 ? &n2048 : &any;
  }
};

Br2Plans<1> plans_plain;     // the plain key, n steps
Br2Plans<3> plans_unrolled;  // the 2-bit-unrolled key, ceil(n/2) steps

// The instance for M, ring size N, l2 and Bgbit2, or null.
ClusterPlan<Br2Args>* br2_plan(int M, int N, int l, int Bgbit) {
  if (l != BR2_L || Bgbit != BR2_BGBIT) return nullptr;
  const int logN = log2_ring(N);
  return M == 1 ? plans_plain.pick(logN)
         : M == 3 ? plans_unrolled.pick(logN)
                  : nullptr;
}

}  // namespace

// K7's dynamic shared memory per CTA (br2_smem) and the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters) at M into out[0],
// out[1]; 0 or a CUDA error (invalid value: M not 1 or 3, l not 5, N not
// a power of two in [256, 2048]).
extern "C" int br2_ntt_plan(int N, int l, int M, int device,
                            long long* out) {
  ClusterPlan<Br2Args>* c = br2_plan(M, N, l, BR2_BGBIT);
  const size_t smem = br2_smem(N);
  int n = 0;
  const int e = c ? c->prepare(device, smem, &n) : (int)cudaErrorInvalidValue;
  out[0] = (long long)smem;
  out[1] = n;
  return e;
}

// K7: all S steps of every row in one launch, one cluster of four CTAs of
// BR2_THREADS threads per row, on `stream`.
//   acc int64 [G, 2, N] (u64 bit patterns, updated in place); amounts int32
//   [S, M, G]; kkey int32 [S, 2, 2, M, l, 2, 2, N], the key's kernel form;
//   tw uint32 [2, 2, N, 2] = psirev, psiinvrev of P1, P2 with companions;
//   offset = decompose2's offset mod 2^64; M = 1 or 3; l = 5, Bgbit = 8; N
//   a power of two in [256, 2048].  Returns 0 or the first CUDA error; a
//   card that cannot hold one cluster refuses
//   (cudaErrorLaunchOutOfResources).
extern "C" int br2_ntt(void* acc, const void* amounts, const void* kkey,
                       const void* tw, int G, int S, int M, int N, int l,
                       int Bgbit, uint64_t offset, int device,
                       void* stream) {
  ClusterPlan<Br2Args>* c = br2_plan(M, N, l, Bgbit);
  if (!c || G <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Br2Args A{static_cast<uint64_t*>(acc),
                  static_cast<const int32_t*>(amounts),
                  static_cast<const uint32_t*>(kkey),
                  static_cast<const uint2*>(tw),
                  offset,
                  S,
                  G,
                  log2_ring(N)};
  return c->launch(A, G, br2_smem(N), device,
                   reinterpret_cast<cudaStream_t>(stream));
}

// The grid (CTAs), cluster size and threads a CTA of the last launch.
extern "C" void br2_ntt_last_launch(int* out) {
  out[0] = last_launch[0];
  out[1] = last_launch[1];
  out[2] = last_launch[2];
}

extern "C" const char* br2_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
