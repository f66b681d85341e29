// Lvl1 external product for Hopper (sm_90a): digits (x) prepared TRGSW,
// exact over the integers through a two-prime negacyclic NTT, then mod 2^32.
//
// Replaces iyokan_tpu/ops/pallas_ep.py::_ep_kernel (extprod1_fused, "K6"):
//   out[g, u] = sum_r digits[g, r] * key[idx[g], r, u]   (negacyclic, mod 2^32)
// for digits int32 [G, RR, N] (|d| <= Bg/2 = 32 at cggi128), a stack of K
// prepared TRGSWs int32 [K, RR, 2, P=2, N] and a per-row key index int32 [G]
// (or none: every row takes key 0).  The key layout is the port's CRT64
// prep1 (crypto/polymul.py): residues mod P1 = 2013265921 and
// P2 = 1811939329 in the bit-reversed order of the merged-psi Cooley-Tukey
// transform (crypto/ntt.py), so the plain twin is polymul.extprod1.
// Exact: |conv| <= RR*N*32*2^32 = 2^49.6 < P1*P2/2 = 2^60.7, so the centred
// CRT (Garner) recovers the integer, and its low 32 bits are the result.
//
// What it does not copy: K6's four 16-bit primes, R x C four-step split and
// int8-limb twiddle matmuls serve the TPU's matrix unit, which has no wide
// integer multiply.  Hopper multiplies 32 x 32 -> 64 bits natively, so the
// plain design is two 31-bit primes and a radix-2 NTT in shared memory.
//
// Design: one block per row g, N/2 threads.  Per prime: the RR digit
// polynomials are reduced into shared memory and transformed together
// (ntt.cuh: one barrier per shared-memory stage for all RR, the last six
// stages in registers), multiplied pointwise against key[idx[g]] and summed
// over r (each run of four products below 2^62 reduced once by
// mont_reduce, which leaves a factor 2^-32), and the two sums run through
// the Gentleman-Sande inverse, whose last stage scales by N^-1 2^32.  The
// first prime's result waits in shared memory for the second's; then the
// CRT writes the row.  Shared memory (extprod1_ntt_smem): (RR + 4) * N * 4
// bytes = 40 KB at RR = 6, N = 1024, 88 KB at the unrolled key's RR = 18,
// which raises the kernel's limit once per card (ntt.cuh).
//
// What bounds it on the H100: 32-bit integer multiplies.  Each row costs
// 2 primes x ((RR + 2) * N/2 * log2 N butterflies + 2*RR*N pointwise
// products) + 2N CRT products at cggi128, about three multiplies each in
// the Shoup and Montgomery forms of ntt.cuh.  The key (RR*2*2*N*4 = 96 KB
// per TRGSW) is read from L2 by every row.  This kernel keeps one block
// per row and the prep1 key as it is: K3/K4's cluster form
// (br_cluster.cuh) is not applied to it yet.
//
// Built by iyokan_tpu_torch/ops/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libextprod1_ntt-<hash>.so extprod1_ntt.cu
// (the hash covers this file and ntt.cuh, which holds the NTT itself)
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

// One prime's product of a row: acc[u*N + c] = sum_r d_r * key_{r,u} mod P,
// in natural order.
template <uint32_t P>
__device__ void one_prime(const int32_t* __restrict__ dg,
                          const int32_t* __restrict__ key, int pi,
                          uint32_t* dig, uint32_t* acc, const uint2* tw,
                          uint2 scale, int RR, int N, int logN) {
  const int k = threadIdx.x;
  const int H = N >> 1;
  for (int r = 0; r < RR; ++r)
    for (int c = k; c < N; c += H) {
      const int64_t v = (int64_t)dg[r * N + c] % (int64_t)P;  // toward 0
      dig[r * N + c] = (uint32_t)(v < 0 ? v + P : v);
    }
  __syncthreads();
  if (RR % 2)
    ntt_fwd<P, 1>(dig, RR, tw, N, logN);
  else
    ntt_fwd<P, 2>(dig, RR, tw, N, logN);
  for (int u = 0; u < 2; ++u)
    for (int c = k; c < N; c += H) {
      uint32_t s = 0;
      for (int r0 = 0; r0 < RR; r0 += 4) {
        uint64_t T = 0;
        for (int r = r0; r < min(r0 + 4, RR); ++r)
          T += (uint64_t)dig[r * N + c] *
               (uint32_t)key[((r * 2 + u) * 2 + pi) * N + c];
        s = addmod<P>(s, mont_reduce<P>(T));
      }
      acc[u * N + c] = s;
    }
  __syncthreads();
  ntt_inv<P, 2>(acc, 2, tw + N, N, logN, nullptr, 0, scale);
}

__global__ void __launch_bounds__(1024)
extprod1_kernel(const int32_t* __restrict__ digits,  // [G, RR, N]
                const int32_t* __restrict__ keys,    // [K, RR, 2, 2, N]
                const int32_t* __restrict__ idx,     // [G] or null
                int32_t* __restrict__ out,           // [G, 2, N]
                int RR, Ring ring) {
  extern __shared__ uint32_t sm[];
  const int N = ring.N, logN = ring.logN;
  uint32_t* dig = sm;              // [RR, N]
  uint32_t* acc = sm + RR * N;     // [2, N]
  uint32_t* res1 = acc + 2 * N;    // [2, N]: the first prime's result
  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int H = N >> 1;
  const int32_t* dg = digits + (size_t)g * RR * N;
  const int32_t* key = keys + (size_t)(idx ? idx[g] : 0) * RR * 2 * 2 * N;

  one_prime<P1>(dg, key, 0, dig, acc, ring.tw, ring.scale[0], RR, N, logN);
  for (int c = k; c < 2 * N; c += H) res1[c] = acc[c];
  __syncthreads();
  one_prime<P2>(dg, key, 1, dig, acc, ring.tw + 2 * N, ring.scale[1], RR,
                N, logN);

  // Garner (ntt.cuh: crt_mod32): the centred integer, mod 2^32
  int32_t* o = out + (size_t)g * 2 * N;
  for (int c = k; c < 2 * N; c += H)
    o[c] = (int32_t)crt_mod32(res1[c], acc[c]);
}

SmemLimit limit;

}  // namespace

// Dynamic shared memory of a block: the RR digit rows, the sums and the
// first prime's result, (RR + 4) * N * 4 bytes.
extern "C" size_t extprod1_ntt_smem(int N, int RR) {
  return (size_t)(RR + 4) * N * sizeof(uint32_t);
}

// One external product per row, launched on `stream`.
//   digits int32 [G, RR, N]; keys int32 [K, RR, 2, 2, N]; idx int32 [G] with
//   values in [0, K), or null for key 0; tw uint32 [2, 2, N, 2] = psirev,
//   psiinvrev of P1, P2 with companions; scale uint32 [4] = N^-1 2^32 mod
//   P1, companion, the same mod P2; out int32 [G, 2, N].  N a power of two
//   in [64, 2048].  Returns 0 or the first CUDA error.
extern "C" int extprod1_ntt(const void* digits, const void* keys,
                            const void* idx, const void* tw,
                            const uint32_t* scale, void* out, int G, int RR,
                            int N, int K, int device, void* stream) {
  const Ring r = ring(tw, scale, N, 1, 1, 0u);
  const size_t smem = extprod1_ntt_smem(N, RR);
  if (G <= 0 || RR <= 0 || K <= 0 || r.logN < 0)
    return (int)cudaErrorInvalidValue;
  const int e = limit.prepare(extprod1_kernel, device, smem);
  if (e) return e;
  extprod1_kernel<<<G, N / 2, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(digits), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), RR, r);
  return (int)cudaGetLastError();
}

extern "C" const char* extprod1_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
