// Lvl1 external product for Hopper (sm_90a): digits (x) prepared TRGSW,
// exact over the integers through a two-prime negacyclic NTT, then mod 2^32.
//
// Replaces iyokan_tpu/ops/pallas_ep.py::_ep_kernel (extprod1_fused, "K6"):
//   out[g, u] = sum_r digits[g, r] * key[idx[g], r, u]   (negacyclic, mod 2^32)
// for digits int32 [G, RR, N] (|d| <= Bg/2 = 32 at cggi128), a stack of K
// prepared TRGSWs int32 [K, RR, 2, P=2, N] and a per-row key index int32 [G]
// (or none: every row takes key 0).  RR = 2l (a TRGSW: the lvl1 CMUX of the
// ROM and RAM trees, the ntt-step blind rotation) or 3*2l (the
// 2-bit-unrolled key's three TRGSWs of a key-bit pair: the ntt-unrolled
// blind rotation), rows m*2l + u*l + j; built for l = 3.  The key layout is
// the port's CRT64 prep1 (crypto/polymul.py): residues mod P1 = 2013265921
// and P2 = 1811939329 in the bit-reversed order of the merged-psi
// Cooley-Tukey transform (crypto/ntt.py), so the plain twin is
// polymul.extprod1.  Exact: |conv| <= RR*N*32*2^32 = 2^51.2 at RR = 18 <
// P1*P2/2 = 2^60.7, so the centred CRT (Garner) recovers the integer, and
// its low 32 bits are the result.
//
// What it does not copy: K6's four 16-bit primes, R x C four-step split and
// int8-limb twiddle matmuls serve the TPU's matrix unit, which has no wide
// integer multiply.  Hopper multiplies 32 x 32 -> 64 bits natively.
//
// Design: the cluster form of br_cluster.cuh, one cluster of four CTAs a
// row.  CTA rank 2p + u owns prime p and part u (rows m*2l + u*l + j, RR/2
// of them) of row g:
//   1. reads its digit rows, as residues mod p (ntt.cuh:residue, one
//      compare and add), inside the first two butterfly stages of their
//      forward transforms, then the rest of the transforms (ntt.cuh's
//      paired shared-memory stages and register stages, l rows together);
//   2. forms the partial products of both outputs v against keys[idx[g]]
//      in the prep1 layout as it is (per-call TRGSWs made by circuit
//      bootstrapping: a kernel form built per call would cost more than it
//      saves): sums of l products, one mont_reduce each (x 2^-32);
//   3. leaves output 1 - u's partial for CTA (p, 1 - u) in its shared
//      memory (distributed shared memory), and after cluster barrier 1
//      runs the inverse transform of output u, its own partial plus the
//      other part's, scaled by N^-1 2^32 in the last stage;
//   4. writes its residues of half 1 - p of the coefficients into CTA
//      (1 - p, u)'s shared memory, and after cluster barrier 2 runs Garner
//      on half p with the other prime's residues and writes out[g, u] there.
// So a row's serial chain is RR/2 forward transforms (l together) and one
// inverse, on four SMs, with two cluster barriers and no remote read after
// the second (a CTA may exit at once).  Threads a CTA: 512 while the card
// holds every row's cluster at once at that size, 256 beyond
// (ops/br.py:threads_for, with this kernel's own cap per RR).
//
// What bounds it on the H100: 32-bit integer multiplies.  Each row costs
// 2 primes x ((RR + 2) * N/2 * log2 N butterflies + 2*RR*N pointwise
// products) + 2N CRT products at cggi128, about three multiplies each in
// the Shoup and Montgomery forms of ntt.cuh; the digits (RR*N*4 bytes a
// row, 48 MB at G = 2048, RR = 6) are read once from device memory, the key
// (RR*2*2*N*4 = 96 KB per TRGSW at RR = 6) from L2 by every row.  Shared
// memory a CTA (ep_cluster_smem): this prime's twiddles (2N uint2), the
// RR/2 digit rows and the output's sum (N), 32 KB at RR = 6, N = 1024, and
// 56 KB at RR = 18.
//
// Built by iyokan_tpu_torch/ops/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libextprod1_ntt-<hash>.so extprod1_ntt.cu
// (the hash covers this file and the headers it includes: br_cluster.cuh,
// the launch plumbing, and ntt.cuh, the NTT itself) and called through
// ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "br_cluster.cuh"

namespace {

constexpr int EP_L = 3;  // gadget rows of a part: l, every parameter set

struct EpArgs {
  const int32_t* digits;  // [G, RR, N], |d| <= Bg/2
  const uint32_t* keys;   // prep1 [K, RR, 2 (v), 2 (p), N]
  const int32_t* idx;     // [G] in [0, K), or null: key 0
  int32_t* out;           // [G, 2, N]
  int G;
  Ring r;                 // twiddles and the inverse's scale
};

// M TRGSWs of 2l rows: RR = 2 M l.
inline size_t ep_cluster_smem(int N, int M) {
  return (size_t)2 * N * sizeof(uint2) +
         (size_t)(M * EP_L + 1) * N * sizeof(uint32_t);
}

// NT threads a CTA; LOGN: log2 N fixed at compile time (0: r.logN).
// Inlined: a call would copy the kernel's arguments to local memory.
template <uint32_t P, int M, int NT, int LOGN>
__device__ __forceinline__ void ep_cluster_body(const EpArgs& A,
                                                unsigned rank, uint32_t* sm) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int L = EP_L, NROW = M * L, RR = 2 * NROW;
  const Ring& r = A.r;
  const int logN = LOGN ? LOGN : r.logN, N = 1 << logN, H = N >> 1;
  const int tid = threadIdx.x, p = rank >> 1, u = rank & 1;
  const int g = blockIdx.x / BR_CLUSTER;
  uint2* twf = reinterpret_cast<uint2*>(sm);
  uint2* twi = twf + N;
  uint32_t* dig = reinterpret_cast<uint32_t*>(twi + N);  // [NROW][N]
  uint32_t* own = dig + NROW * N;                        // [N]

  for (int i = tid; i < N; i += NT) {
    twf[i] = r.tw[(2 * p) * N + i];
    twi[i] = r.tw[(2 * p + 1) * N + i];
  }
  const int32_t* dg = A.digits + (size_t)g * RR * N;
  const uint32_t* key =
      A.keys + (size_t)(A.idx ? A.idx[g] : 0) * RR * 4 * N + (size_t)p * N;
  __syncthreads();

  // 1. row q = m*l + j of this part is digit row m*2l + u*l + j: its
  // residues inside the first two forward stages (c, c + N/4, c + N/2,
  // c + 3N/4; at N = 128 one stage; at N = 64 none), then the rest
  if (logN >= 8) {
    const int Q = N >> 2;
    for (int c = tid; c < Q; c += NT) {
#pragma unroll
      for (int q = 0; q < NROW; ++q) {
        const int32_t* row = dg + ((q / L) * 2 * L + u * L + q % L) * N + c;
        uint32_t x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = residue<P>(row[e * Q]);
        ct4<P>(x[0], x[1], x[2], x[3], twf, 1, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) dig[q * N + c + e * Q] = x[e];
      }
    }
  } else {
    for (int c = tid; c < H; c += NT) {
#pragma unroll
      for (int q = 0; q < NROW; ++q) {
        const int32_t* row = dg + ((q / L) * 2 * L + u * L + q % L) * N + c;
        uint32_t x0 = residue<P>(row[0]), x1 = residue<P>(row[H]);
        if (logN == 7) ct<P>(x0, x1, twf[1]);
        dig[q * N + c] = x0;
        dig[q * N + c + H] = x1;
      }
    }
  }
  __syncthreads();
  ntt_fwd<P, L, NT>(dig, NROW, twf, N, logN, logN >= 8 ? logN - 3 : 5);

  // 2. the partial products of both outputs (x 2^-32)
  for (int c = tid; c < N; c += NT) {
    uint32_t s[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      uint32_t sv = 0;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        uint64_t T = 0;  // l = 3 products below P^2: < 2P 2^32
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const int row = m * 2 * L + u * L + j;
          T += (uint64_t)dig[(m * L + j) * N + c] *
               __ldg(key + (size_t)((row * 2 + v) * 2) * N + c);
        }
        const uint32_t t = mont_reduce<P>(T);
        sv = m ? addmod<P>(sv, t) : t;
      }
      s[v] = sv;
    }
    dig[c] = u ? s[0] : s[1];  // read by CTA (p, 1 - u)
    own[c] = u ? s[1] : s[0];
  }
  cluster.sync();  // 1: both parts' partials are in place

  // 3. output u: own partial + the other part's, inverse, x N^-1 2^32
  ntt_inv<P, 1, NT>(own, 1, twi, N, logN,
                    cluster.map_shared_rank(dig, rank ^ 1), 0, r.scale[p]);

  // 4. half 1 - p of the residues to the other prime's CTA (its digit row
  // 1, unused after barrier 1), then Garner on half p
  uint32_t* recv = dig + N;
  uint32_t* peer = cluster.map_shared_rank(recv, rank ^ 2);
  const int mine = p * H, theirs = (1 - p) * H;
  for (int c = tid; c < H; c += NT) peer[c] = own[theirs + c];
  cluster.sync();  // 2: both primes' residues of part u are in place
  int32_t* o = A.out + ((size_t)g * 2 + u) * N + mine;
  for (int c = tid; c < H; c += NT) {
    const uint32_t a = own[mine + c], b = recv[c];
    o[c] = (int32_t)(P == P1 ? crt_mod32(a, b) : crt_mod32(b, a));
  }
}

// NT threads a CTA: 256 for wide batches (registers capped so that five
// CTAs share an SM at RR = 2l, four at 3*2l, where shared memory allows no
// more), 512 for narrow ones (two a SM).
template <int M, int NT, int LOGN>
__global__ void __launch_bounds__(NT, NT == 256 ? (M == 1 ? 5 : 4) : 2)
    ep_cluster_kernel(const EpArgs A) {
  extern __shared__ __align__(16) uint32_t ep_sm[];
  const unsigned rank = cg::this_cluster().block_rank();
  if (rank >> 1)
    ep_cluster_body<P2, M, NT, LOGN>(A, rank, ep_sm);
  else
    ep_cluster_body<P1, M, NT, LOGN>(A, rank, ep_sm);
}

// The instances at M = 1 (RR = 2l) or 3 (RR = 3*2l): 256 or 512 threads a
// CTA, N fixed at 1024 (the 128-bit sets) or read from the launch.
template <int M>
struct EpPlans {
  ClusterPlan<EpArgs> any256{ep_cluster_kernel<M, 256, 0>, 256};
  ClusterPlan<EpArgs> any512{ep_cluster_kernel<M, 512, 0>, 512};
  ClusterPlan<EpArgs> n1024_256{ep_cluster_kernel<M, 256, 10>, 256};
  ClusterPlan<EpArgs> n1024_512{ep_cluster_kernel<M, 512, 10>, 512};

  ClusterPlan<EpArgs>* pick(int logN, int nt) {
    if (logN < 0 || (nt != 256 && nt != 512)) return nullptr;
    if (logN == 10) return nt == 256 ? &n1024_256 : &n1024_512;
    return nt == 256 ? &any256 : &any512;
  }
};

EpPlans<1> plans_2l;
EpPlans<3> plans_6l;

// The instance for RR rows, ring size N and nt threads, or null.
ClusterPlan<EpArgs>* ep_plan(int RR, int N, int nt) {
  const int logN = log2_ring(N);
  return RR == 2 * EP_L   ? plans_2l.pick(logN, nt)
         : RR == 6 * EP_L ? plans_6l.pick(logN, nt)
                          : nullptr;
}

}  // namespace

// K6's dynamic shared memory per CTA and the clusters the card holds at
// once (cudaOccupancyMaxActiveClusters) at RR rows and nt threads a CTA
// into out[0], out[1]; 0 or a CUDA error (RR not 2l or 3*2l at l = 3:
// invalid value).
extern "C" int extprod1_ntt_plan(int N, int RR, int nt, int device,
                                 long long* out) {
  ClusterPlan<EpArgs>* c = ep_plan(RR, N, nt);
  const size_t smem = ep_cluster_smem(N, RR / (2 * EP_L));
  int n = 0;
  const int e = c ? c->prepare(device, smem, &n) : (int)cudaErrorInvalidValue;
  out[0] = (long long)smem;
  out[1] = n;
  return e;
}

// One external product per row, one cluster of four CTAs of nt (256 or
// 512) threads per row, launched on `stream`.
//   digits int32 [G, RR, N], |d| <= Bg/2; keys int32 [K, RR, 2, 2, N];
//   idx int32 [G] with values in [0, K), or null for key 0; tw uint32
//   [2, 2, N, 2] = psirev, psiinvrev of P1, P2 with companions; scale
//   uint32 [4] = N^-1 2^32 mod P1, companion, the same mod P2; out int32
//   [G, 2, N].  RR = 6 or 18 (l = 3); N a power of two in [64, 2048].
//   Returns 0 or the first CUDA error; a card that cannot hold one cluster
//   refuses (cudaErrorLaunchOutOfResources).
extern "C" int extprod1_ntt(const void* digits, const void* keys,
                            const void* idx, const void* tw,
                            const uint32_t* scale, void* out, int G, int RR,
                            int N, int K, int nt, int device, void* stream) {
  ClusterPlan<EpArgs>* c = ep_plan(RR, N, nt);
  if (!c || G <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const EpArgs A{static_cast<const int32_t*>(digits),
                 static_cast<const uint32_t*>(keys),
                 static_cast<const int32_t*>(idx), static_cast<int32_t*>(out),
                 G, ring(tw, scale, N, 1, 1, 0u)};
  return c->launch(A, G, ep_cluster_smem(N, RR / (2 * EP_L)), device,
                   reinterpret_cast<cudaStream_t>(stream));
}

// The grid (CTAs), cluster size and threads a CTA of the last launch.
extern "C" void extprod1_ntt_last_launch(int* out) {
  out[0] = last_launch[0];
  out[1] = last_launch[1];
  out[2] = last_launch[2];
}

extern "C" const char* extprod1_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
