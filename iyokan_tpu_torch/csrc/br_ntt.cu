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
// key step bk[i] int32 [2l, 2, P=2, N] (crypto/polymul.prep1: residues mod
// the two primes of ntt.cuh, bit-reversed order).
//
// Exact: |d (x) bk| <= 2l * N * Bg/2 * 2^32 = 2^49.6 at cggi128 (N = 1024,
// l = 3, Bg = 64); the decompose-first form of br3_ntt.cu, with its
// (X^a - 1) factor and M = 3 sums, reaches 3 * 2 * 6 * N * 32 * 2^32 =
// 2^52.2.  Both are below P1*P2/2 = 2^60.7, so the centred CRT recovers the
// integer and its low 32 bits are the step's update.  The TPU kernels
// compute the same integer over four 16-bit primes (PRIMES1, range/2 =
// 2^57.9), so the results are bit-identical.  What this does not copy:
// PRIMES1, the int8-limb twiddle matmuls and the f32 Barretts served the
// TPU's matrix unit; Hopper multiplies 32 x 32 -> 64 bits natively.
//
// Design: one block per row g, N/2 threads (one butterfly each per stage).
// The accumulator lives in shared memory for the step (K5) or for all n
// steps (K4).  A step, fused in one device function: per prime, the digits
// of X^a * acc - acc are written as residues into shared memory, the 2l
// rows are transformed together, multiplied pointwise by the key step and
// summed over the rows (two sums), the two sums run through the inverse
// transform; then the Garner CRT of the two primes is added into acc.  No
// torch glue between steps (PERF.md: the torch rotate/decompose/add around
// each extprod1_ntt launch was most of the per-step route's time).  Shared
// memory (6 + 2l) * N * 4 bytes = 48 KB at cggi128 (acc, both primes' sums,
// the digit rows; br_ntt_smem); a larger size raises the kernel's
// cudaFuncAttributeMaxDynamicSharedMemorySize once per card (ntt.cuh).
//
// What bounds it on the H100: integer multiply-modulo throughput.  Per row
// and step 2 primes x ((2l + 2) * N/2 * log2 N butterflies + 2 * 2l * N
// pointwise products + 2N scalings) + 2N Garner products = 112,640 mulmods
// at cggi128, each a 64-bit product of two residues (two 32-bit
// multiplies) and its reduction by a compile-time prime.  The key step
// (2l * 2 * 2 * N * 4 = 96 KB) is read by every row; the whole key
// (n * 96 KB = 62.4 MB at cggi128) is larger than the 50 MB L2.  Speed
// work (several rows per block sharing each key step, cp.async/TMA double
// buffering of the key step, Shoup products) is later.
//
// Built by iyokan_tpu_torch/ops/nvcc.py (hash of this file and ntt.cuh):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbr_ntt-<hash>.so br_ntt.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

// dig[(u*l + j)*N + c] = digit j of part u of X^a * acc - acc, mod P.
template <uint32_t P>
__device__ void rotated_digits(const uint32_t* acc, int a, uint32_t* dig,
                               const Ring& r) {
  const int N = r.N;
  for (int c = threadIdx.x; c < N; c += N >> 1) {
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

// out[u*N + c] = sum_r dig[r][c] * key[r, u, pi][c] mod P (NTT domain).
template <uint32_t P>
__device__ void key_product(const uint32_t* dig,
                            const int32_t* __restrict__ key, int pi,
                            uint32_t* out, const Ring& r) {
  const int N = r.N, RR = 2 * r.l;
  for (int c = threadIdx.x; c < N; c += N >> 1)
    for (int u = 0; u < 2; ++u) {
      uint64_t s = 0;
      for (int q = 0; q < RR; ++q)
        s += mulmod<P>(dig[q * N + c],
                       (uint32_t)key[((q * 2 + u) * 2 + pi) * N + c]);
      out[u * N + c] = (uint32_t)(s % P);
    }
}

// One prime's decompose1(X^a acc - acc) (x) key, natural order, in out.
template <uint32_t P>
__device__ void one_prime(const uint32_t* acc, int a,
                          const int32_t* __restrict__ key, int pi,
                          uint32_t* dig, uint32_t* out, const Ring& r) {
  rotated_digits<P>(acc, a, dig, r);
  __syncthreads();
  ntt_fwd<P>(dig, 2 * r.l, r.tab + pi * r.N, r.N, r.logN);
  key_product<P>(dig, key, pi, out, r);
  __syncthreads();
  ntt_inv<P>(out, 2, r.tab + (2 + pi) * r.N, pi ? r.ninv2 : r.ninv1, r.N,
             r.logN);
}

// One CMUX step on the accumulator in shared memory (all threads call it).
__device__ void cmux_step(uint32_t* acc, int a,
                          const int32_t* __restrict__ key, uint32_t* dig,
                          uint32_t* s1, uint32_t* s2, const Ring& r) {
  one_prime<P1>(acc, a, key, 0, dig, s1, r);
  one_prime<P2>(acc, a, key, 1, dig, s2, r);
  for (int c = threadIdx.x; c < 2 * r.N; c += r.N >> 1)
    acc[c] += crt_mod32(s1[c], s2[c]);
  __syncthreads();
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
  for (int c = threadIdx.x; c < 2 * N; c += N >> 1) acc[c] = row[c];
  __syncthreads();
  cmux_step(acc, a_row[blockIdx.x], key, dig, s1, s2, r);
  for (int c = threadIdx.x; c < 2 * N; c += N >> 1) row[c] = acc[c];
}

// K4: all n steps for every row in one launch.
__global__ void __launch_bounds__(1024)
br_loop_kernel(int32_t* acc_g, const int32_t* __restrict__ abar_t,  // [n,G]
               const int32_t* __restrict__ bk, int n, int G, Ring r) {
  extern __shared__ uint32_t sm[];
  const int N = r.N;
  uint32_t* acc = sm;
  uint32_t* s1 = acc + 2 * N;
  uint32_t* s2 = s1 + 2 * N;
  uint32_t* dig = s2 + 2 * N;
  const int g = blockIdx.x;
  const size_t step = (size_t)2 * r.l * 2 * 2 * N;  // int32 per key step
  uint32_t* row = reinterpret_cast<uint32_t*>(acc_g) + (size_t)g * 2 * N;
  for (int c = threadIdx.x; c < 2 * N; c += N >> 1) acc[c] = row[c];
  __syncthreads();
  for (int i = 0; i < n; ++i)
    cmux_step(acc, abar_t[(size_t)i * G + g], bk + i * step, dig, s1, s2, r);
  for (int c = threadIdx.x; c < 2 * N; c += N >> 1) row[c] = acc[c];
}

SmemLimit step_limit, loop_limit;

}  // namespace

// Dynamic shared memory of either kernel's block: acc, both primes' sums
// and the 2l digit rows, (6 + 2l) * N * 4 bytes.
extern "C" size_t br_ntt_smem(int N, int l) {
  return (size_t)(6 + 2 * l) * N * sizeof(uint32_t);
}

// K5: one CMUX step of every row, launched on `stream`.
//   acc int32 [G, 2, N] (updated in place); a_row int32 [G], the step's
//   rotation amounts in [0, 2N); key int32 [2l, 2, 2, N], the step's
//   prepared TRGSW; tab uint32 [4, N] = psirev (P1, P2), psiinvrev (P1, P2);
//   offset = decompose1's offset mod 2^32.  N a power of two in [64, 2048].
//   Returns 0 or the first CUDA error.
extern "C" int br_ntt_step(void* acc, const void* a_row, const void* key,
                           const void* tab, int G, int N, int l, int Bgbit,
                           uint32_t offset, uint32_t ninv1, uint32_t ninv2,
                           int device, void* stream) {
  const Ring r = ring(tab, N, l, Bgbit, offset, ninv1, ninv2);
  const size_t smem = br_ntt_smem(N, l);
  if (G <= 0 || r.logN < 0) return (int)cudaErrorInvalidValue;
  const int e = step_limit.prepare(br_step_kernel, device, smem);
  if (e) return e;
  br_step_kernel<<<G, N / 2, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(acc), static_cast<const int32_t*>(a_row),
      static_cast<const int32_t*>(key), r);
  return (int)cudaGetLastError();
}

// K4: all n CMUX steps of every row in one launch.
//   abar_t int32 [n, G] (row i: step i's amounts); bk int32
//   [n, 2l, 2, 2, N]; the rest as br_ntt_step.
extern "C" int br_ntt_loop(void* acc, const void* abar_t, const void* bk,
                           const void* tab, int G, int n, int N, int l,
                           int Bgbit, uint32_t offset, uint32_t ninv1,
                           uint32_t ninv2, int device, void* stream) {
  const Ring r = ring(tab, N, l, Bgbit, offset, ninv1, ninv2);
  const size_t smem = br_ntt_smem(N, l);
  if (G <= 0 || n <= 0 || r.logN < 0) return (int)cudaErrorInvalidValue;
  const int e = loop_limit.prepare(br_loop_kernel, device, smem);
  if (e) return e;
  br_loop_kernel<<<G, N / 2, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(acc), static_cast<const int32_t*>(abar_t),
      static_cast<const int32_t*>(bk), n, G, r);
  return (int)cudaGetLastError();
}

extern "C" const char* br_ntt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
