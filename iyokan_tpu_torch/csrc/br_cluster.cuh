// The cluster form of the NTT blind rotations K4, K5 (br_ntt.cu) and K3
// (br3_ntt.cu): a cluster of four CTAs per row running S CMUX steps, the
// whole loop in one launch (K3, K4) or one step a launch (K5: S = 1, the
// launches back to back from C, ClusterPlans::steps).  The launch plumbing
// at the end (ClusterPlan) also serves K6 (extprod1_ntt.cu).
//
// CTA rank 2p + u of a cluster owns prime p and part u of the row's
// accumulator, with acc[u] in its shared memory for every step.  Part u's
// gadget digit rows depend on acc[u] alone (the rotated difference
// X^a acc[u] - acc[u] for K4, acc[u] itself for K3's decompose-first form),
// so a step in CTA (p, u) is:
//   1. the l digit rows, as residues mod p, computed inside the first two
//      butterfly stages of their forward transforms (l polynomials
//      together);
//   2. the partial key products of both outputs v = 0, 1 in the NTT domain:
//      sum_j dig[j] * key[u*l + j, v] (K3: sum_m (psi^(a_m(2k+1)) - 1) *
//      sum_j dig[j] * key[m, u*l + j, v]), each sum of l products reduced
//      once (mont_reduce);
//   3. the partial of output 1 - u goes to CTA (p, 1 - u) through
//      distributed shared memory (it reads it, after cluster barrier 1, as
//      its inverse transform loads its own partial);
//   4. the inverse transform of output u;
//   5. after cluster barrier 2, Garner's CRT with the residues of CTA
//      (1 - p, u), and acc[u] += the centred integer mod 2^32 (both CTAs of
//      part u keep the same acc[u]).
// So a step's serial chain is l forward transforms (together) and one
// inverse, not 2 primes x (2l + 2), with two cluster barriers, on four
// times the SMs.  A transform (ntt.cuh) takes one barrier per pair of
// shared-memory stages and none for the six register stages: about seven
// block barriers a step at N = 1024.
//
// Threads a CTA (NT): 512 while the card holds all G clusters at once at
// that size, 256 beyond (ops/br.py:threads_for; each row then gets twice
// the warps on the one wave, where a batch is latency-bound).  Built for
// l = 3, the N = 1024 instances with N fixed at compile time (index
// arithmetic folded).
//
// The key comes in its kernel form (ops/br.py:kernel_key): int32
// [S, 2 (p), 2 (u), M, l, 2 (v), N], residues k N^-1 2^32 mod p, so that
// mont_reduce of a row sum leaves sum_j dig_j k_j N^-1: the inverse has no
// scaling pass.  CTA (p, u) reads its contiguous M*l*2*N slice of a step
// straight from L2 into registers, once a step (on the H100 the key reads
// hold a step back little, and an L2 prefetch of the next step's slice
// slowed it: PERF.md, Findings).
//
// A launch of one step (K5) goes through global memory: the accumulator in
// and out, this prime's twiddles into shared memory.  Launched with
// programmatic dependent launch (ClusterPlans::steps), the next step's
// CTAs may start while this step ends: every CTA lets its dependents launch
// once past the last step's second cluster barrier (earlier, their waiting
// CTAs slowed the running ones: PERF.md, Findings), and a CTA loads its
// twiddles, then waits (griddep_wait) for the previous step to complete
// before it reads the accumulator.  In a launch without the attribute (K3,
// K4, K5's first step) both are no-ops.
//
// Shared memory (br_cluster_smem): this prime's forward and inverse
// twiddles with companions (2N uint2), K3's psi powers minus one with
// companions (2N uint2), acc[u] (N), the digits (l*N; row 0 then holds the
// outgoing partial) and two sum buffers (2N: a step writes the one of its
// parity while the other prime's CTA may still read the other one).

#pragma once

#include <cooperative_groups.h>

#include "ntt.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BR_CLUSTER = 4;  // CTA rank 2p + u: prime p, part u

struct BrArgs {
  int32_t* acc;            // [G, 2, N], updated in place
  const int32_t* amounts;  // [S, M, G] rotation amounts in [0, 2N)
  const uint32_t* key;     // kernel form [S, 2, 2, M, l, 2, N]
  const uint2* pw;         // K3: [2 primes][2N] (psi^e - 1, companion)
  int S, G;
  Ring r;
};

// Programmatic dependent launch (sm_90): let the stream's next kernel
// launch its CTAs, and wait until the previous kernel has completed with
// its writes visible.  No-ops in a launch without the attribute.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

inline size_t br_cluster_smem(int N, int l, bool v3) {
  return (size_t)(v3 ? 4 : 2) * N * sizeof(uint2) +
         (size_t)(3 + l) * N * sizeof(uint32_t);
}

// Gadget digits j < L of coefficient c of part u, as residues mod P: of
// X^a x - x (K4) or of x (K3).
template <uint32_t P, bool V3, int L>
__device__ __forceinline__ void digits_at(const uint32_t* x, int c, int a,
                                          int N, const Ring& r,
                                          uint32_t* out) {
  uint32_t xp;
  if (V3) {
    xp = x[c] + r.offset;
  } else {  // coefficient c of X^a x is x[c - a], negated past N
    int m = c - a;
    if (m < 0) m += 2 * N;
    const uint32_t rot = m < N ? x[m] : 0u - x[m - N];
    xp = rot - x[c] + r.offset;
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    out[j] = residue<P>(gadget_digit(xp, j, r.Bgbit));
}

// NT threads a CTA; LOGN: log2 N fixed at compile time (0: the launch's
// r.logN).
template <uint32_t P, bool V3, int M, int L, int NT, int LOGN>
__device__ void br_cluster_body(const BrArgs& A, unsigned rank,
                                uint32_t* sm) {
  cg::cluster_group cluster = cg::this_cluster();
  const Ring& r = A.r;
  const int logN = LOGN ? LOGN : r.logN, N = 1 << logN, H = N >> 1;
  constexpr int nt = NT;
  const int tid = threadIdx.x, p = rank >> 1, u = rank & 1;
  const int g = blockIdx.x / BR_CLUSTER, G = A.G;
  uint2* twf = reinterpret_cast<uint2*>(sm);
  uint2* twi = twf + N;
  uint2* pw = twi + N;  // K3 only
  uint32_t* acc = reinterpret_cast<uint32_t*>(pw + (V3 ? 2 * N : 0));
  uint32_t* dig = acc + N;      // [L][N]
  uint32_t* sum = dig + L * N;  // [2][N]

  for (int i = tid; i < N; i += nt) {
    twf[i] = r.tw[(2 * p) * N + i];
    twi[i] = r.tw[(2 * p + 1) * N + i];
  }
  if (V3)
    for (int i = tid; i < 2 * N; i += nt) pw[i] = A.pw[p * 2 * N + i];
  griddep_wait();  // the previous step's accumulator (K5)
  for (int i = tid; i < N; i += nt)
    acc[i] = (uint32_t)A.acc[((size_t)g * 2 + u) * N + i];
  // No cluster barrier here: the first access to another CTA's shared
  // memory follows barrier 1 of the first step, which every CTA of the
  // cluster reaches only once running (a barrier at entry cost K5 3.4 ms
  // a rotation at G = 2048: PERF.md, Findings).
  __syncthreads();
  const uint32_t* dig_pu = cluster.map_shared_rank(dig, rank ^ 1);
  const uint32_t* sum_pp = cluster.map_shared_rank(sum, rank ^ 2);
  const int slice = M * L * 2 * N;  // int32 of this CTA's key a step
  const uint32_t* key = A.key + (size_t)(2 * p + u) * slice;

  for (int i = 0; i < A.S; ++i, key += 4 * (size_t)slice) {
    int am[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
      am[m] = A.amounts[((size_t)i * M + m) * G + g];

    // 1. the digit rows inside the first two forward stages (residues c,
    // c + N/4, c + N/2, c + 3N/4; at N = 128 one stage, pairs c, c + N/2;
    // at N = 64 none), then the rest of their forward transforms
    if (logN >= 8) {
      const int Q = N >> 2;
      for (int c = tid; c < Q; c += nt) {
        uint32_t x[4][L];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          digits_at<P, V3, L>(acc, c + e * Q, am[0], N, r, x[e]);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          ct4<P>(x[0][j], x[1][j], x[2][j], x[3][j], twf, 1, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) dig[j * N + c + e * Q] = x[e][j];
        }
      }
    } else {
      for (int c = tid; c < H; c += nt) {
        uint32_t x0[L], x1[L];
        digits_at<P, V3, L>(acc, c, am[0], N, r, x0);
        digits_at<P, V3, L>(acc, c + H, am[0], N, r, x1);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          if (logN == 7) ct<P>(x0[j], x1[j], twf[1]);
          dig[j * N + c] = x0[j];
          dig[j * N + c + H] = x1[j];
        }
      }
    }
    __syncthreads();
    ntt_fwd<P, L, NT>(dig, L, twf, N, logN, logN >= 8 ? logN - 3 : 5);

    // 2. the partial key products of both outputs
    uint32_t* own = sum + (i & 1) * N;
#pragma unroll
    for (int c = tid; c < N; c += nt) {
      uint32_t kv[M][L][2], d[L];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < L; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            kv[m][j][v] = __ldg(key + ((m * L + j) * 2 + v) * N + c);
#pragma unroll
      for (int j = 0; j < L; ++j) d[j] = dig[j * N + c];
      const int odd =
          V3 ? 2 * (int)(__brev((unsigned)c) >> (32 - logN)) + 1 : 0;
      uint32_t s[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        uint32_t sv = 0;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          uint64_t T = 0;  // at most 4 products below P^2: < 2P 2^32
#pragma unroll
          for (int j = 0; j < L; ++j) T += (uint64_t)d[j] * kv[m][j][v];
          const uint32_t t = mont_reduce<P>(T);
          sv = V3 ? addmod<P>(sv, shoup_mul<P>(
                                      t, pw[(am[m] * odd) & (2 * N - 1)]))
                  : t;
        }
        s[v] = sv;
      }
      dig[c] = u ? s[0] : s[1];  // read by CTA (p, 1 - u)
      own[c] = u ? s[1] : s[0];
    }
    cluster.sync();  // 1: both parts' partials are in place

    // 3, 4. output u: own partial + the other part's, inverse transform
    ntt_inv<P, 1, NT>(own, 1, twi, N, logN, dig_pu, 0, make_uint2(0u, 0u),
                      false);
    cluster.sync();  // 2: both primes' residues of part u are in place
    if (i + 1 == A.S) griddep_launch_dependents();

    // 5. Garner with the other prime's CTA, into acc[u]
    const uint32_t* other = sum_pp + (i & 1) * N;
    for (int c = tid; c < N; c += nt) {
      const uint32_t mine = own[c], theirs = other[c];
      acc[c] += P == P1 ? crt_mod32(mine, theirs) : crt_mod32(theirs, mine);
    }
    __syncthreads();
  }
  cluster.sync();  // the other CTAs' last reads of this one are done
  if (p == 0)
    for (int c = tid; c < N; c += nt)
      A.acc[((size_t)g * 2 + u) * N + c] = (int32_t)acc[c];
}

// NT threads a CTA: 256 for wide batches (registers capped so that five
// K4 or four K3 CTAs share an SM), 512 for narrow ones (two a SM).
template <bool V3, int M, int L, int NT, int LOGN>
__global__ void __launch_bounds__(NT, NT == 256 ? (V3 ? 4 : 5) : 2)
    br_cluster_kernel(const BrArgs A) {
  extern __shared__ __align__(16) uint32_t br_sm[];
  const unsigned rank = cg::this_cluster().block_rank();
  if (rank >> 1)
    br_cluster_body<P2, V3, M, L, NT, LOGN>(A, rank, br_sm);
  else
    br_cluster_body<P1, V3, M, L, NT, LOGN>(A, rank, br_sm);
}

// The grid (CTAs), cluster size and threads a CTA of the last cluster
// launch of a library, as launched (br_ntt_last_launch, br3_ntt_last_launch,
// extprod1_ntt_last_launch report them).
int last_launch[3] = {0, 0, 0};

// One cluster kernel instance (Args by value, NT threads a CTA): its
// dynamic shared-memory limit raised once per card, and
// cudaOccupancyMaxActiveClusters read once per card (a card that can hold
// no cluster of it refuses the launch).
template <typename Args>
struct ClusterPlan {
  void (*kernel)(Args);
  int nt;
  SmemLimit limit;
  int clusters[MAX_DEVICES] = {};

  ClusterPlan(void (*k)(Args), int threads) : kernel(k), nt(threads) {}

  // pdl: the launch may start while the stream's previous kernel runs
  // (programmatic dependent launch; the kernel waits in griddep_wait).
  cudaLaunchConfig_t config(int n_clusters, size_t smem, cudaStream_t stream,
                            cudaLaunchAttribute* at, bool pdl) const {
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = BR_CLUSTER;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[1].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(BR_CLUSTER * n_clusters);
    cfg.blockDim = dim3(nt);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = at;
    cfg.numAttrs = pdl ? 2 : 1;
    return cfg;
  }

  // 0 or a CUDA error; *max_clusters: clusters the card holds at once.
  int prepare(int device, size_t smem, int* max_clusters) {
    const int e = limit.prepare(kernel, device, smem);
    if (e) return e;
    if (!clusters[device]) {
      cudaLaunchAttribute at[2];
      const cudaLaunchConfig_t cfg = config(1, smem, nullptr, at, false);
      int n = 0;
      const cudaError_t q = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (q != cudaSuccess) return (int)q;
      if (n < 1) return (int)cudaErrorLaunchOutOfResources;
      clusters[device] = n;
    }
    *max_clusters = clusters[device];
    return 0;
  }

  // Enqueues n_clusters clusters of BR_CLUSTER CTAs on `stream` (after
  // prepare); 0 or a CUDA error.
  int enqueue(const Args& A, int n_clusters, size_t smem, cudaStream_t stream,
              bool pdl) {
    cudaLaunchAttribute at[2];
    const cudaLaunchConfig_t cfg = config(n_clusters, smem, stream, at, pdl);
    const cudaError_t q = cudaLaunchKernelEx(&cfg, kernel, A);
    if (q != cudaSuccess) return (int)q;
    last_launch[0] = (int)cfg.gridDim.x;
    last_launch[1] = (int)at[0].val.clusterDim.x;
    last_launch[2] = (int)cfg.blockDim.x;
    return 0;
  }

  int launch(const Args& A, int n_clusters, size_t smem, int device,
             cudaStream_t stream) {
    int n = 0;
    int e = prepare(device, smem, &n);
    if (!e) e = enqueue(A, n_clusters, smem, stream, false);
    return e ? e : (int)cudaGetLastError();
  }
};

// K5 launches its steps with programmatic dependent launch (faster than
// plain stream order at every batch measured: PERF.md, Findings).
constexpr bool K5_PDL = true;

// The instances of one blind rotation (V3, M): l = 3 (every parameter set
// of the repo), 256 or 512 threads a CTA, N fixed at 1024 (the 128-bit
// sets) or read from the launch; another l is refused (invalid value).
template <bool V3, int M>
struct ClusterPlans {
  ClusterPlan<BrArgs> any256{br_cluster_kernel<V3, M, 3, 256, 0>, 256};
  ClusterPlan<BrArgs> any512{br_cluster_kernel<V3, M, 3, 512, 0>, 512};
  ClusterPlan<BrArgs> n1024_256{br_cluster_kernel<V3, M, 3, 256, 10>, 256};
  ClusterPlan<BrArgs> n1024_512{br_cluster_kernel<V3, M, 3, 512, 10>, 512};

  // The instance for the ring (logN) and nt threads, or null (l != 3 or
  // nt not 256 or 512).
  ClusterPlan<BrArgs>* pick(int logN, int l, int nt) {
    if (logN < 0 || l != 3 || (nt != 256 && nt != 512)) return nullptr;
    if (logN == 10) return nt == 256 ? &n1024_256 : &n1024_512;
    return nt == 256 ? &any256 : &any512;
  }

  // 0 or a CUDA error; *smem: bytes a CTA; *n: clusters the card holds.
  int prepare(int device, int N, int l, int nt, size_t* smem, int* n) {
    *smem = br_cluster_smem(N, l, V3);
    ClusterPlan<BrArgs>* c = pick(log2_ring(N), l, nt);
    return c ? c->prepare(device, *smem, n) : (int)cudaErrorInvalidValue;
  }

  // One launch of A.S steps of every row.
  int launch(const BrArgs& A, int nt, int device, cudaStream_t stream) {
    ClusterPlan<BrArgs>* c = pick(A.r.logN, A.r.l, nt);
    if (!c || A.G <= 0 || A.S <= 0) return (int)cudaErrorInvalidValue;
    return c->launch(A, A.G, br_cluster_smem(A.r.N, A.r.l, V3), device,
                     stream);
  }

  // K5: n launches of one step each (A.S = 1), back to back on `stream`,
  // step i reading amounts row i ([n, M, G]) and key step i ([n, 2, 2, M,
  // l, 2, N]); all but the first with programmatic dependent launch
  // (K5_PDL).  Returns the number of launches made, or minus a CUDA error.
  int steps(BrArgs A, int n, int nt, int device, cudaStream_t stream) {
    ClusterPlan<BrArgs>* c = pick(A.r.logN, A.r.l, nt);
    if (!c || A.G <= 0 || n <= 0 || A.S != 1)
      return -(int)cudaErrorInvalidValue;
    const size_t smem = br_cluster_smem(A.r.N, A.r.l, V3);
    int max_clusters = 0;
    int e = c->prepare(device, smem, &max_clusters);
    const size_t key_step = (size_t)4 * M * A.r.l * 2 * A.r.N;
    for (int i = 0; i < n && !e; ++i) {
      e = c->enqueue(A, A.G, smem, stream, K5_PDL && i > 0);
      A.amounts += (size_t)M * A.G;
      A.key += key_step;
    }
    if (!e) e = (int)cudaGetLastError();
    return e ? -e : n;
  }
};

}  // namespace
