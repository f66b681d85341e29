// Decompose-first lvl1 blind rotation over the two-prime NTT for Hopper
// (sm_90a): K3.
//
// Replaces iyokan_tpu/ops/pallas_br3.py::_kernel :168 ("K3", the
// IYOKAN_BR_IMPL=v3 route; design notes :1-28): the whole n-step loop in one
// launch, each step in the decompose-first form
//   acc += sum_m (X^{a_m} - 1) * (decompose1(acc) (x) bk[i, 2l*m : 2l*(m+1)])
//                                                               (mod 2^32)
// M = 1: the plain key [n, 2l, 2, P=2, N], one amount a per step.
// M = 3: the 2-bit-unrolled key [ceil(n/2), 3*2l, 2, P, N] (rows grouped
//   [M, 2l] per pair step), amounts a1, a2, a1 + a2 from
//   X^(a1 s1 + a2 s2) = 1 + s1(1-s2)(X^a1-1) + s2(1-s1)(X^a2-1)
//                         + s1 s2 (X^(a1+a2)-1),
//   one decomposition of acc shared by the three products; an odd n pads
//   the last pair step with a2 = 0 (its X^0 - 1 term vanishes).
// The amounts come in as steps int32 [n_steps, M, G] (pallas_br3.py:405-416
// builds the same array).  The key is the port's CRT64 prep1 layout
// (crypto/polymul.prep1: residues mod the two primes of ntt.cuh,
// bit-reversed order).
//
// Exact: |(X^a - 1) * (d (x) bk)| * M <= 3 * 2 * 6 * N * 32 * 2^32 = 2^52.2
// at N = 1024 (l = 3, Bg = 64), below P1*P2/2 = 2^60.7, so the centred CRT
// recovers the integer and its low 32 bits are the update; the TPU kernel
// computes the same integer over PRIMES1 (range/2 = 2^57.9), so the results
// are bit-identical.  (The decompose-first form itself is not the standard
// CMUX: it doubles the per-step decomposition noise variance, as on the
// TPU.)  What this does not copy: the TPU's full-matrix int8 NTTs, one-hot
// twiddle matmuls, f32 Barretts, prime pipelining and IYOKAN_BR3_TW12 (an
// arithmetic variant with the same result) served its matrix unit.
//
// Design: one block per row, N/2 threads, acc in shared memory for all
// steps.  Per step and prime: the 2l digit rows of acc go into shared
// memory as residues and through the forward transform together; slot pos
// then holds the values at psi^(2k+1), k = bit-reverse(pos) (crypto/ntt.py's
// order), where X^a - 1 is the scalar psi^(a(2k+1)) - 1.  So each thread
// forms, for its slots, S_u = sum_m (psi^(a_m(2k+1)) - 1) * sum_j dig_j *
// key[m, j, u] and only the two sums S_0, S_1 run through the inverse
// transform, whatever M.  The Garner CRT of both primes is added into acc.
// The 2N powers of psi per prime stay in shared memory for the launch.
// Shared memory (6 + 2l) * N * 4 + 2 * 2N * 4 bytes = 64 KB at cggi128
// (br3_ntt_smem), above the default 48 KB: the first launch on a card raises
// the kernel's cudaFuncAttributeMaxDynamicSharedMemorySize (ntt.cuh).
//
// What bounds it on the H100: integer multiply-modulo throughput.  Per row
// and step, 2 primes x ((2l + 2) * N/2 * log2 N butterflies + M * 2 * (2l + 1)
// * N pointwise and twiddle products + 2N scalings) + 2N Garner products =
// 116,736 mulmods at M = 1 and 174,080 at M = 3 (cggi128), each a 64-bit
// product of two residues (two 32-bit multiplies) and its reduction by a
// compile-time prime.  Every row streams the key from L2 or device memory:
// n * 96 KB = 62.4 MB plain, 318 * 288 KB = 93.8 MB unrolled, both larger
// than the 50 MB L2.  Speed work (rows per block sharing each key step,
// cp.async/TMA double buffering, Shoup products) is later.
//
// Built by iyokan_tpu_torch/ops/nvcc.py (hash of this file and ntt.cuh):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbr3_ntt-<hash>.so br3_ntt.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

constexpr int MAX_M = 3;

// One prime's sum_m (X^{a_m} - 1) * (decompose1(acc) (x) key_m), natural
// order, in out [2, N].  pw: the 2N powers of this prime's psi.
template <uint32_t P>
__device__ void one_prime(const uint32_t* acc, const int* am, int M,
                          const int32_t* __restrict__ key, int pi,
                          const uint32_t* pw, uint32_t* dig, uint32_t* out,
                          const Ring& r) {
  const int N = r.N, H = N >> 1, RR = 2 * r.l;
  for (int c = threadIdx.x; c < N; c += H)
    for (int u = 0; u < 2; ++u) {
      const uint32_t xp = acc[u * N + c] + r.offset;
      for (int j = 0; j < r.l; ++j)
        dig[(u * r.l + j) * N + c] =
            residue<P>(gadget_digit(xp, j, r.Bgbit));
    }
  __syncthreads();
  ntt_fwd<P>(dig, RR, r.tab + pi * N, N, r.logN);
  for (int c = threadIdx.x; c < N; c += H) {
    const int odd = 2 * (int)(__brev((unsigned)c) >> (32 - r.logN)) + 1;
    uint32_t tw[MAX_M];
    for (int m = 0; m < M; ++m)
      tw[m] = pw[(am[m] * odd) & (2 * N - 1)] - 1;  // psi^e >= 1
    for (int u = 0; u < 2; ++u) {
      uint64_t s = 0;
      for (int m = 0; m < M; ++m) {
        uint64_t t = 0;
        for (int j = 0; j < RR; ++j)
          t += mulmod<P>(
              dig[j * N + c],
              (uint32_t)key[(((m * RR + j) * 2 + u) * 2 + pi) * N + c]);
        s += mulmod<P>((uint32_t)(t % P), tw[m]);
      }
      out[u * N + c] = (uint32_t)(s % P);
    }
  }
  __syncthreads();
  ntt_inv<P>(out, 2, r.tab + (2 + pi) * N, pi ? r.ninv2 : r.ninv1, N,
             r.logN);
}

__global__ void __launch_bounds__(1024)
br3_kernel(int32_t* acc_g, const int32_t* __restrict__ steps,  // [n, M, G]
           const int32_t* __restrict__ bk,       // [n, M*2l, 2, 2, N]
           const uint32_t* __restrict__ psipow,  // [2, 2N]
           int n_steps, int M, int G, Ring r) {
  extern __shared__ uint32_t sm[];
  const int N = r.N, H = N >> 1;
  uint32_t* acc = sm;            // [2, N]
  uint32_t* s1 = acc + 2 * N;    // [2, N]: the first prime's sums
  uint32_t* s2 = s1 + 2 * N;     // [2, N]: the second prime's
  uint32_t* pw = s2 + 2 * N;     // [2, 2N]: psi powers of both primes
  uint32_t* dig = pw + 4 * N;    // [2l, N]
  const int g = blockIdx.x;
  const size_t step = (size_t)M * 2 * r.l * 2 * 2 * N;  // int32 per step
  uint32_t* row = reinterpret_cast<uint32_t*>(acc_g) + (size_t)g * 2 * N;
  for (int c = threadIdx.x; c < 2 * N; c += H) acc[c] = row[c];
  for (int c = threadIdx.x; c < 4 * N; c += H) pw[c] = psipow[c];
  __syncthreads();
  for (int i = 0; i < n_steps; ++i) {
    int am[MAX_M];
    for (int m = 0; m < M; ++m) am[m] = steps[((size_t)i * M + m) * G + g];
    const int32_t* key = bk + i * step;
    one_prime<P1>(acc, am, M, key, 0, pw, dig, s1, r);
    one_prime<P2>(acc, am, M, key, 1, pw + 2 * N, dig, s2, r);
    for (int c = threadIdx.x; c < 2 * N; c += H)
      acc[c] += crt_mod32(s1[c], s2[c]);
    __syncthreads();
  }
  for (int c = threadIdx.x; c < 2 * N; c += H) row[c] = acc[c];
}

SmemLimit limit;

}  // namespace

// Dynamic shared memory of a block: acc, both primes' sums, both primes'
// 2N psi powers and the 2l digit rows, (10 + 2l) * N * 4 bytes.
extern "C" size_t br3_ntt_smem(int N, int l) {
  return (size_t)(10 + 2 * l) * N * sizeof(uint32_t);
}

// K3: all n_steps decompose-first CMUX steps of every row in one launch.
//   acc int32 [G, 2, N] (updated in place); steps int32 [n_steps, M, G],
//   rotation amounts in [0, 2N); bk int32 [n_steps, M*2l, 2, 2, N]; tab
//   uint32 [4, N] = psirev (P1, P2), psiinvrev (P1, P2); psipow uint32
//   [2, 2N] = psi^e mod P1, P2 for e in [0, 2N); offset = decompose1's
//   offset mod 2^32; M in {1, 2, 3}; N a power of two in [64, 2048].
//   Returns 0 or the first CUDA error.
extern "C" int br3_ntt(void* acc, const void* steps, const void* bk,
                       const void* tab, const void* psipow, int G,
                       int n_steps, int M, int N, int l, int Bgbit,
                       uint32_t offset, uint32_t ninv1, uint32_t ninv2,
                       int device, void* stream) {
  const Ring r = ring(tab, N, l, Bgbit, offset, ninv1, ninv2);
  const size_t smem = br3_ntt_smem(N, l);
  if (G <= 0 || n_steps <= 0 || M < 1 || M > MAX_M || r.logN < 0)
    return (int)cudaErrorInvalidValue;
  const int e = limit.prepare(br3_kernel, device, smem);
  if (e) return e;
  br3_kernel<<<G, N / 2, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(acc), static_cast<const int32_t*>(steps),
      static_cast<const int32_t*>(bk), static_cast<const uint32_t*>(psipow),
      n_steps, M, G, r);
  return (int)cudaGetLastError();
}

extern "C" const char* br3_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
