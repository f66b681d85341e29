// Two-prime negacyclic NTT device functions shared by the port's NTT kernels
// (extprod1_ntt.cu, br_ntt.cu, br3_ntt.cu).
//
// The primes, tables and transforms are those of crypto/ntt.py: residues mod
// P1 = 2013265921 and P2 = 1811939329, a merged-psi Cooley-Tukey forward
// transform with bit-reversed output and a Gentleman-Sande inverse consuming
// bit-reversed input.  Slot `pos` of a forward transform holds the
// polynomial's value at psi^(2k+1) with k = bit-reverse(pos).  Every product
// is of two residues below 2^31: one 32 x 32 -> 64-bit multiply and a
// reduction by a compile-time prime.
//
// The transforms are called by all N/2 threads of a block, one butterfly per
// thread per stage, on polynomials in shared memory.  The host side holds
// what every launch of these kernels checks and sets up: the ring's
// arguments (Ring) and the kernel's shared-memory limit (SmemLimit).  A
// library that includes this header is rebuilt when it changes (ops/nvcc.py
// hashes both).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P1 = 2013265921u;            // 15 * 2^27 + 1
constexpr uint32_t P2 = 1811939329u;            // 27 * 2^26 + 1
constexpr uint64_t P1P2 = (uint64_t)P1 * P2;
constexpr uint32_t INV_P1_MOD_P2 = 1811939320u;  // P1^-1 mod P2

template <uint32_t P>
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) % P);
}

template <uint32_t P>
__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // a, b < P < 2^31: no wrap
  return s >= P ? s - P : s;
}

template <uint32_t P>
__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (P - b);
}

// A signed value with |v| < P as its residue in [0, P).
template <uint32_t P>
__device__ __forceinline__ uint32_t residue(int32_t v) {
  return v < 0 ? (uint32_t)(v + (int32_t)P) : (uint32_t)v;
}

// Signed gadget digit j (0-based) of a torus value already offset by the
// decomposition's centring + rounding term (crypto/ops.py:decompose1):
// in [-Bg/2, Bg/2).
__device__ __forceinline__ int32_t gadget_digit(uint32_t xp, int j,
                                                int Bgbit) {
  const uint32_t Bg = 1u << Bgbit;
  return (int32_t)((xp >> (32 - (j + 1) * Bgbit)) & (Bg - 1)) -
         (int32_t)(Bg >> 1);
}

// Forward negacyclic NTT of npoly polynomials x[r*N ..] in shared memory,
// natural order in, bit-reversed out (crypto/ntt.py:ntt_fwd).
template <uint32_t P>
__device__ void ntt_fwd(uint32_t* x, int npoly,
                        const uint32_t* __restrict__ psirev, int N,
                        int logN) {
  const int k = threadIdx.x;
  for (int lm = 0; lm < logN; ++lm) {
    const int lt = logN - 1 - lm;  // t = N / (2m), m = 2^lm
    const int t = 1 << lt;
    const int i0 = ((k >> lt) << (lt + 1)) + (k & (t - 1));
    const uint32_t s = psirev[(1 << lm) + (k >> lt)];
    for (int r = 0; r < npoly; ++r) {
      uint32_t* y = x + r * N;
      const uint32_t u = y[i0];
      const uint32_t v = mulmod<P>(y[i0 + t], s);
      y[i0] = addmod<P>(u, v);
      y[i0 + t] = submod<P>(u, v);
    }
    __syncthreads();
  }
}

// Inverse (Gentleman-Sande), bit-reversed in, natural out, times N^-1
// (crypto/ntt.py:ntt_inv).
template <uint32_t P>
__device__ void ntt_inv(uint32_t* x, int npoly,
                        const uint32_t* __restrict__ psiinvrev, uint32_t ninv,
                        int N, int logN) {
  const int k = threadIdx.x;
  for (int lh = logN - 1; lh >= 0; --lh) {
    const int lt = logN - 1 - lh;  // t = N / m, h = m / 2 = 2^lh
    const int t = 1 << lt;
    const int i0 = ((k >> lt) << (lt + 1)) + (k & (t - 1));
    const uint32_t s = psiinvrev[(1 << lh) + (k >> lt)];
    for (int r = 0; r < npoly; ++r) {
      uint32_t* y = x + r * N;
      const uint32_t u = y[i0];
      const uint32_t v = y[i0 + t];
      y[i0] = addmod<P>(u, v);
      y[i0 + t] = mulmod<P>(submod<P>(u, v), s);
    }
    __syncthreads();
  }
  const int H = N >> 1;
  for (int r = 0; r < npoly; ++r) {
    x[r * N + k] = mulmod<P>(x[r * N + k], ninv);
    x[r * N + k + H] = mulmod<P>(x[r * N + k + H], ninv);
  }
  __syncthreads();
}

// Garner: the integer x = r1 + P1 * ((r2 - r1) * P1^-1 mod P2) in
// [0, P1*P2), centred to (-P1*P2/2, P1*P2/2), mod 2^32
// (crypto/ntt.py:crt_center).
__device__ __forceinline__ uint32_t crt_mod32(uint32_t r1, uint32_t r2) {
  const uint32_t diff = submod<P2>(r2, r1 >= P2 ? r1 - P2 : r1);
  const uint64_t x = r1 + (uint64_t)P1 * mulmod<P2>(diff, INV_P1_MOD_P2);
  return (uint32_t)(x >= P1P2 / 2 ? x - P1P2 : x);
}

// log2 N for N a power of two in [64, 2048], else -1.
inline int log2_ring(int N) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  return (N >= 64 && N <= 2048 && (1 << logN) == N) ? logN : -1;
}

// The lvl1 ring and gadget of a blind-rotation launch (the arguments
// ops/br.py:ring_args passes): tables, N, l, Bgbit, decompose1's offset.
struct Ring {
  const uint32_t* tab;  // [4, N]: psirev P1, psirev P2, psiinvrev P1, P2
  uint32_t ninv1, ninv2;
  int N, logN, l, Bgbit;
  uint32_t offset;      // decompose1's centring + rounding offset
};

// The Ring of the arguments, or one with logN = -1 if they are out of range.
inline Ring ring(const void* tab, int N, int l, int Bgbit, uint32_t offset,
                 uint32_t ninv1, uint32_t ninv2) {
  const bool ok = l >= 1 && l <= 4 && Bgbit >= 1 && l * Bgbit <= 31;
  return Ring{static_cast<const uint32_t*>(tab), ninv1, ninv2, N,
              ok ? log2_ring(N) : -1, l, Bgbit, offset};
}

// A kernel's dynamic shared-memory limit per card, raised with
// cudaFuncSetAttribute the first time a launch needs more than the
// default 48 KB, and not again for that size or less.
constexpr int MAX_DEVICES = 64;
constexpr size_t MAX_SMEM = 227 * 1024;  // per block on sm_90

struct SmemLimit {
  size_t granted[MAX_DEVICES] = {};

  // Makes `device` current and lets `kernel` take smem bytes; returns 0 or
  // a CUDA error.
  template <typename K>
  int prepare(K kernel, int device, size_t smem) {
    if (device < 0 || device >= MAX_DEVICES || smem > MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (smem <= 48 * 1024 || smem <= granted[device]) return 0;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[device] = smem;
    return 0;
  }
};

}  // namespace
