// Lvl1 blind rotation over the two-prime NTT for Hopper (sm_90a): K5 and K4.
//
// Replaces
//   iyokan_tpu/ops/pallas_br.py::_step_kernel :109 ("K5": one CMUX step per
//     launch, the arithmetic of step_math :77; IYOKAN_BR_IMPL=pallas), and
//   iyokan_tpu/ops/pallas_br2.py::_kernel :35 ("K4": the whole n-step loop in
//     one launch, the accumulator kept on chip; IYOKAN_BR_IMPL=pallas2).
// Both compute, per CMUX step i and row g,
//   acc += decompose1(X^{a[i,g]} * acc - acc) (x) bk[i]            (mod 2^32)
// with acc i32 [G, 2, N] (the TRLWE accumulator), the 2l signed gadget
// digit rows of the rotated difference (|d| <= Bg/2) and the CRT64-prepared
// key step bk[i] (crypto/polymul.prep1: residues mod the two primes of
// ntt.cuh, bit-reversed order).
//
// Exact: |d (x) bk| <= 2l * N * Bg/2 * 2^32 = 2^49.6 at cggi128 (N = 1024,
// l = 3, Bg = 64); the decompose-first form of br3_ntt.cu, with its
// (X^a - 1) factor and M = 3 sums, reaches 3 * 2 * 6 * N * 32 * 2^32 =
// 2^52.2.  Both are below P1*P2/2 = 2^60.7, so the centred CRT recovers the
// integer and its low 32 bits are the step's update.  The TPU kernels
// compute the same integer over four 16-bit primes (PRIMES1, range/2 =
// 2^57.9), so the results are bit-identical.  What this does not copy:
// PRIMES1, the int8-limb twiddle matmuls and the f32 Barretts served the
// TPU's matrix unit; Hopper multiplies 32 x 32 bits natively.
//
// K4 is the cluster form of br_cluster.cuh: four CTAs (prime, part) per
// row, over the key's kernel form (ops/br.py:kernel_key).
// What bounds it on the H100: 32-bit integer multiplies (per row and step
// 2 primes x ((2l + 2) N/2 log2 N butterflies + 2 * 2l * N key products)
// + 2N Garner products at cggi128: about three multiplies each in Shoup or
// Montgomery form), and the L2 bytes of the key: the whole key (n * 96 KB
// = 62.4 MB at cggi128) is larger than the 50 MB L2, and each row needs
// every step of it.  The design answers the first with 32-bit Shoup and
// Montgomery products (ntt.cuh), N^-1 folded into the key, and a serial
// chain per step of l forward and one inverse transform (four CTAs work
// on a row, seven block barriers a step); the second by reading each
// CTA's slice of a step once.  Measured on the H100, the L2 bytes of the
// key do not bind: rows sharing a key step (R rows a CTA) were slower at
// every batch, and so was an L2 prefetch of the next step (PERF.md,
// Findings).
//
// K5 keeps one block of N/2 threads per row and launch, both primes in
// turn, and the prep1 key read as it is; it takes ntt.cuh's transforms and
// products, its sums of key products reduced once per four (mont_reduce)
// and the 2^32 that leaves folded into the inverse's N^-1 scale.  Shared memory (6 + 2l) * N * 4 bytes = 48 KB
// at cggi128 (acc, both primes' sums, the digit rows; br_ntt_smem).
//
// Built by iyokan_tpu_torch/ops/nvcc.py (hash of this file and the headers
// it includes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbr_ntt-<hash>.so br_ntt.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "br_cluster.cuh"

namespace {

// dig[(u*l + j)*N + c] = digit j of part u of X^a * acc - acc, mod P.
template <uint32_t P>
__device__ void rotated_digits(const uint32_t* acc, int a, uint32_t* dig,
                               const Ring& r) {
  const int N = r.N;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    int m = c - a;  // a in [0, 2N): coefficient c of X^a * x is x[c - a]
    if (m < 0) m += 2 * N;
    for (int u = 0; u < 2; ++u) {
      const uint32_t* x = acc + u * N;
      const uint32_t rot = m < N ? x[m] : 0u - x[m - N];
      const uint32_t xp = rot - x[c] + r.offset;
      for (int j = 0; j < r.l; ++j)
        dig[(u * r.l + j) * N + c] =
            residue<P>(gadget_digit(xp, j, r.Bgbit));
    }
  }
}

// out[u*N + c] = sum_q dig[q][c] * key[q, u, pi][c] * 2^-32 mod P (NTT
// domain), each run of four products reduced once.
template <uint32_t P>
__device__ void key_product(const uint32_t* dig,
                            const int32_t* __restrict__ key, int pi,
                            uint32_t* out, const Ring& r) {
  const int N = r.N, RR = 2 * r.l;
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    for (int u = 0; u < 2; ++u) {
      uint32_t s = 0;
      for (int q0 = 0; q0 < RR; q0 += 4) {
        uint64_t T = 0;
        for (int q = q0; q < min(q0 + 4, RR); ++q)
          T += (uint64_t)dig[q * N + c] *
               (uint32_t)key[((q * 2 + u) * 2 + pi) * N + c];
        s = addmod<P>(s, mont_reduce<P>(T));
      }
      out[u * N + c] = s;
    }
}

// One prime's decompose1(X^a acc - acc) (x) key, natural order, in out.
template <uint32_t P>
__device__ void one_prime(const uint32_t* acc, int a,
                          const int32_t* __restrict__ key, int pi,
                          uint32_t* dig, uint32_t* out, const Ring& r) {
  rotated_digits<P>(acc, a, dig, r);
  __syncthreads();
  ntt_fwd<P, 2>(dig, 2 * r.l, r.tw + 2 * pi * r.N, r.N, r.logN);
  key_product<P>(dig, key, pi, out, r);
  __syncthreads();
  ntt_inv<P, 2>(out, 2, r.tw + (2 * pi + 1) * r.N, r.N, r.logN, nullptr, 0,
             r.scale[pi]);
}

// K5: one step for every row; acc_g [G, 2, N] updated in place.
__global__ void __launch_bounds__(1024)
br_step_kernel(int32_t* acc_g, const int32_t* __restrict__ a_row,  // [G]
               const int32_t* __restrict__ key, Ring r) {
  extern __shared__ uint32_t sm[];
  const int N = r.N;
  uint32_t* acc = sm;           // [2, N]
  uint32_t* s1 = acc + 2 * N;   // [2, N]: the first prime's sums
  uint32_t* s2 = s1 + 2 * N;    // [2, N]: the second prime's
  uint32_t* dig = s2 + 2 * N;   // [2l, N]
  uint32_t* row = reinterpret_cast<uint32_t*>(acc_g) +
                  (size_t)blockIdx.x * 2 * N;
  for (int c = threadIdx.x; c < 2 * N; c += blockDim.x) acc[c] = row[c];
  __syncthreads();
  const int a = a_row[blockIdx.x];
  one_prime<P1>(acc, a, key, 0, dig, s1, r);
  one_prime<P2>(acc, a, key, 1, dig, s2, r);
  for (int c = threadIdx.x; c < 2 * N; c += blockDim.x)
    row[c] = acc[c] + crt_mod32(s1[c], s2[c]);
}

SmemLimit step_limit;
ClusterPlans<false, 1> loop_plans;

}  // namespace

// Dynamic shared memory of a K5 block: acc, both primes' sums and the 2l
// digit rows, (6 + 2l) * N * 4 bytes.
extern "C" size_t br_ntt_smem(int N, int l) {
  return (size_t)(6 + 2 * l) * N * sizeof(uint32_t);
}

// K5: one CMUX step of every row, launched on `stream`.
//   acc int32 [G, 2, N] (updated in place); a_row int32 [G], the step's
//   rotation amounts in [0, 2N); key int32 [2l, 2, 2, N], the step's
//   prepared TRGSW; tw uint32 [2, 2, N, 2] = psirev, psiinvrev of P1, P2
//   with companions; scale uint32 [4] = N^-1 2^32 mod P1, companion, the
//   same mod P2; offset = decompose1's offset mod 2^32.  N a power of two
//   in [64, 2048].  Returns 0 or the first CUDA error.
extern "C" int br_ntt_step(void* acc, const void* a_row, const void* key,
                           const void* tw, const uint32_t* scale, int G,
                           int N, int l, int Bgbit, uint32_t offset,
                           int device, void* stream) {
  const Ring r = ring(tw, scale, N, l, Bgbit, offset);
  const size_t smem = br_ntt_smem(N, l);
  if (G <= 0 || r.logN < 0) return (int)cudaErrorInvalidValue;
  const int e = step_limit.prepare(br_step_kernel, device, smem);
  if (e) return e;
  br_step_kernel<<<G, N / 2, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(acc), static_cast<const int32_t*>(a_row),
      static_cast<const int32_t*>(key), r);
  return (int)cudaGetLastError();
}

// K4's dynamic shared memory per CTA (br_cluster_smem) and the clusters the
// card holds at once (cudaOccupancyMaxActiveClusters) at nt threads a CTA
// into out[0], out[1]; 0 or a CUDA error.
extern "C" int br_ntt_loop_plan(int N, int l, int nt, int device,
                                long long* out) {
  size_t smem = 0;
  int n = 0;
  const int e = loop_plans.prepare(device, N, l, nt, &smem, &n);
  out[0] = (long long)smem;
  out[1] = n;
  return e;
}

// K4: all n CMUX steps of every row in one launch, one cluster of four
// CTAs of nt (256 or 512) threads per row.
//   acc int32 [G, 2, N] (updated in place); abar_t int32 [n, G] (row i:
//   step i's amounts); kkey int32 [n, 2, 2, 1, l, 2, N], the key's kernel
//   form; tw, offset as br_ntt_step; l = 3.  Returns 0 or the first CUDA
//   error; a card that cannot hold one cluster refuses
//   (cudaErrorLaunchOutOfResources).
extern "C" int br_ntt_loop(void* acc, const void* abar_t, const void* kkey,
                           const void* tw, int G, int n, int N, int l,
                           int Bgbit, uint32_t offset, int nt, int device,
                           void* stream) {
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  const BrArgs A{static_cast<int32_t*>(acc),
                 static_cast<const int32_t*>(abar_t),
                 static_cast<const uint32_t*>(kkey), nullptr, n, G,
                 ring(tw, none, N, l, Bgbit, offset)};
  return loop_plans.launch(A, nt, device,
                           reinterpret_cast<cudaStream_t>(stream));
}

// The grid (CTAs), cluster size and threads a CTA of this library's last
// cluster launch.
extern "C" void br_ntt_last_launch(int* out) {
  out[0] = last_launch[0];
  out[1] = last_launch[1];
  out[2] = last_launch[2];
}

extern "C" const char* br_ntt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
