// Two-prime negacyclic NTT device functions shared by the port's NTT kernels
// (extprod1_ntt.cu, br_ntt.cu, br3_ntt.cu through br_cluster.cuh).
//
// The primes, tables and transforms are those of crypto/ntt.py: residues mod
// P1 = 2013265921 and P2 = 1811939329, a merged-psi Cooley-Tukey forward
// transform with bit-reversed output and a Gentleman-Sande inverse consuming
// bit-reversed input.  Slot `pos` of a forward transform holds the
// polynomial's value at psi^(2k+1) with k = bit-reverse(pos).
//
// The products are 32-bit (both primes are below 2^31):
// * a fixed multiplier w (a twiddle, a psi power, a scale, Garner's
//   P1^-1 mod P2) comes with its Shoup companion w' = floor(w 2^32 / P)
//   from the host table (crypto/ntt.py:kernel_tables): q = umulhi(a, w'),
//   a w - q P lies in [0, 2P), one conditional subtract -- three 32-bit
//   multiplies and no division;
// * a sum of at most four products of residues (below 4 P^2 < 2^64) is
//   reduced once, by Montgomery: mont_reduce(T) = T 2^-32 mod P, two 32-bit
//   multiplies.  The kernels fold the 2^32 into what they multiply: the
//   NTT kernels' key form (ops/br.py:kernel_key) or the inverse
//   transform's final scale (K6).
//
// The transforms are called by every thread of a block (any multiple of 32
// threads) on npoly polynomials of N residues in shared memory, NP of them
// through each butterfly position together.  Stages of span 64 and more go
// through shared memory two at a time (four residues an item, one barrier
// a pair); the six of span 32 down to 1 run in registers, a warp on 64
// consecutive residues of each polynomial (two a lane, one butterfly a
// lane a stage, the pairs re-formed between stages by one warp shuffle),
// with no barrier.  The host side holds what every launch
// checks and sets up: the ring's arguments (Ring) and the kernel's
// shared-memory limit (SmemLimit).  A library that includes this header is
// rebuilt when it changes (ops/nvcc.py hashes both).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P1 = 2013265921u;            // 15 * 2^27 + 1
constexpr uint32_t P2 = 1811939329u;            // 27 * 2^26 + 1
constexpr uint64_t P1P2 = (uint64_t)P1 * P2;
constexpr uint32_t INV_P1_MOD_P2 = 1811939320u;  // P1^-1 mod P2

// floor(w 2^32 / P): the Shoup companion of a fixed multiplier w < P.
__host__ __device__ constexpr uint32_t shoup_companion(uint32_t w,
                                                       uint32_t P) {
  return (uint32_t)(((uint64_t)w << 32) / P);
}

// P^-1 mod 2^32 by Newton's iteration (P odd).
__host__ __device__ constexpr uint32_t inv_mod_2_32(uint32_t P) {
  uint32_t x = P;  // correct to 3 bits
  for (int i = 0; i < 5; ++i) x *= 2u - P * x;
  return x;
}

constexpr uint32_t INV_P1_MOD_P2_S = shoup_companion(INV_P1_MOD_P2, P2);

// a + b mod P for a, b < P: the sum is below 2P < 2^32, and s - P wraps
// above s exactly when s < P.
template <uint32_t P>
__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - P);
}

template <uint32_t P>
__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b) {
  const uint32_t d = a - b + P;  // in (0, 2P)
  return min(d, d - P);
}

// a w mod P for a < 2^32 and a fixed w < P with its companion ws.
template <uint32_t P>
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t ws) {
  const uint32_t q = __umulhi(a, ws);
  const uint32_t r = a * w - q * P;  // in [0, 2P), exact mod 2^32
  return min(r, r - P);
}

template <uint32_t P>
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint2 w) {
  return shoup_mul<P>(a, w.x, w.y);
}

// T 2^-32 mod P for T < 2P 2^32 (a sum of up to four products of residues).
// m P has the low word of T, so (T - m P) / 2^32 = T_hi - umulhi(m, P),
// exact, in (-P, 2P).
template <uint32_t P>
__device__ __forceinline__ uint32_t mont_reduce(uint64_t T) {
  constexpr uint32_t PINV = inv_mod_2_32(P);
  const uint32_t hi = (uint32_t)(T >> 32);
  const uint32_t mh = __umulhi((uint32_t)T * PINV, P);
  uint32_t r = hi - mh;
  if (hi < mh) r += P;
  return min(r, r - P);
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

// Between two register stages: lane pairs (a, b) of span bit `bit` become
// the pairs of the next stage.  The lane whose bit is clear keeps a and
// takes the partner's a; the other keeps b and takes the partner's b
// (the same exchange serves the forward and the inverse order).
__device__ __forceinline__ void next_pairs(uint32_t& a, uint32_t& b,
                                           int bit) {
  const int lane = threadIdx.x & 31;
  const bool hi = (lane >> bit) & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? a : b, 1 << bit);
  if (hi) a = got; else b = got;
}

// A Cooley-Tukey butterfly (u, v) -> (u + w v, u - w v) and a
// Gentleman-Sande one (u, v) -> (u + v, (u - v) w).
template <uint32_t P>
__device__ __forceinline__ void ct(uint32_t& u, uint32_t& v, uint2 w) {
  const uint32_t wv = shoup_mul<P>(v, w);
  v = submod<P>(u, wv);
  u = addmod<P>(u, wv);
}

template <uint32_t P>
__device__ __forceinline__ void gs(uint32_t& u, uint32_t& v, uint2 w) {
  const uint32_t d = submod<P>(u, v);
  u = addmod<P>(u, v);
  v = shoup_mul<P>(d, w);
}

// Two forward stages, spans 2^lt and 2^(lt-1), on the residues i0, i0 + h,
// i0 + 2h, i0 + 3h (h = 2^(lt-1)) with j = i0 >> (lt + 1) and
// base = 2^(logN-1-lt): twiddles tw[base + j], then tw[2 base + 2j] and
// tw[2 base + 2j + 1].
template <uint32_t P>
__device__ __forceinline__ void ct4(uint32_t& x0, uint32_t& x1,
                                    uint32_t& x2, uint32_t& x3,
                                    const uint2* tw, int base, int j) {
  const uint2 wa = tw[base + j];
  ct<P>(x0, x2, wa);
  ct<P>(x1, x3, wa);
  ct<P>(x0, x1, tw[2 * base + 2 * j]);
  ct<P>(x2, x3, tw[2 * base + 2 * j + 1]);
}

// Forward negacyclic NTT of npoly polynomials x[r*N ..] in shared memory,
// natural order in, bit-reversed out (crypto/ntt.py:ntt_fwd); tw: this
// prime's psirev with companions.  NP polynomials (npoly a multiple of NP)
// go through each butterfly position together: one twiddle load, NP
// independent chains.  NT: the block's threads if fixed at compile time
// (0: blockDim.x).  Stages of span >= 64 two at a time (four residues
// an item, one barrier a pair), from span 2^first_lt down (a caller that
// ran the first stages itself passes the next one, at least 5); then
// spans 32..1 in registers.  Ends with a barrier.
template <uint32_t P, int NP, int NT = 0>
__device__ void ntt_fwd(uint32_t* x, int npoly, const uint2* tw, int N,
                        int logN, int first_lt = -1) {
  const int nt = NT ? NT : blockDim.x, ng = npoly / NP;
  for (int lt = first_lt < 0 ? logN - 1 : first_lt; lt >= 6;) {
    const int base = 1 << (logN - 1 - lt);
    if (lt >= 7) {  // spans 2^lt and 2^(lt-1)
      const int h = 1 << (lt - 1), Q = N >> 2;
      for (int idx = threadIdx.x; idx < ng * Q; idx += nt) {
        const int kk = idx & (Q - 1), j = kk >> (lt - 1);
        uint32_t* y = x + (idx >> (logN - 2)) * NP * N +
                      (j << (lt + 1)) + (kk & (h - 1));
        uint32_t v[NP][4];
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[q][e] = y[q * N + e * h];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          ct4<P>(v[q][0], v[q][1], v[q][2], v[q][3], tw, base, j);
#pragma unroll
          for (int e = 0; e < 4; ++e) y[q * N + e * h] = v[q][e];
        }
      }
      lt -= 2;
    } else {  // span 64 alone
      const int H = N >> 1;
      for (int idx = threadIdx.x; idx < ng * H; idx += nt) {
        const int k = idx & (H - 1);
        uint32_t* y = x + (idx >> (logN - 1)) * NP * N + ((k >> 6) << 7) +
                      (k & 63);
        const uint2 w = tw[base + (k >> 6)];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          uint32_t u = y[q * N], v = y[q * N + 64];
          ct<P>(u, v, w);
          y[q * N] = u;
          y[q * N + 64] = v;
        }
      }
      lt -= 1;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, nb = N >> 6;
  for (int it = threadIdx.x >> 5; it < ng * nb; it += nt >> 5) {
    const int b = it & (nb - 1);
    const int k = (b << 5) + lane;  // 64 residues of each polynomial
    uint32_t* y = x + (it >> (logN - 6)) * NP * N + b * 64;
    uint32_t a[NP], c[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      a[q] = y[q * N + lane];
      c[q] = y[q * N + lane + 32];
    }
#pragma unroll
    for (int lt = 5; lt >= 0; --lt) {
      const uint2 w = tw[(1 << (logN - 1 - lt)) + (k >> lt)];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (lt < 5) next_pairs(a[q], c[q], lt);
        ct<P>(a[q], c[q], w);
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q)
      reinterpret_cast<uint2*>(y + q * N)[lane] = make_uint2(a[q], c[q]);
  }
  __syncthreads();
}

// Inverse (Gentleman-Sande), bit-reversed in, natural out, unscaled
// (crypto/ntt.py:ntt_inv without its N^-1; the kernels fold that into
// their key or pass it as `scale`), NP polynomials together as ntt_fwd:
// spans 1..32 in registers, then the spans >= 64 two at a time.
// add (or null): polynomial r of the input is x[r*N ..] +
// add[r*add_stride ..] mod P, read as the first stage loads x.  scale
// (.x = 0: none): every output times scale, in the last stage.  Ends with a
// barrier unless sync_end is false (a cluster barrier follows).
template <uint32_t P, int NP, int NT = 0>
__device__ void ntt_inv(uint32_t* x, int npoly, const uint2* tw, int N,
                        int logN, const uint32_t* add = nullptr,
                        int add_stride = 0, uint2 scale = {0u, 0u},
                        bool sync_end = true) {
  const int nt = NT ? NT : blockDim.x, ng = npoly / NP;
  const int lane = threadIdx.x & 31, nb = N >> 6;
  for (int it = threadIdx.x >> 5; it < ng * nb; it += nt >> 5) {
    const int off = (it & (nb - 1)) * 64, q0 = (it >> (logN - 6)) * NP;
    const int k = (off >> 1) + lane;
    uint32_t* y = x + q0 * N + off;
    uint32_t a[NP], c[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      uint2 ab = reinterpret_cast<const uint2*>(y + q * N)[lane];
      if (add) {
        const uint2 e = reinterpret_cast<const uint2*>(
            add + (q0 + q) * add_stride + off)[lane];
        ab.x = addmod<P>(ab.x, e.x);
        ab.y = addmod<P>(ab.y, e.y);
      }
      a[q] = ab.x;
      c[q] = ab.y;
    }
#pragma unroll
    for (int lt = 0; lt <= 5; ++lt) {
      const uint2 w = tw[(1 << (logN - 1 - lt)) + (k >> lt)];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (lt > 0) next_pairs(a[q], c[q], lt - 1);
        gs<P>(a[q], c[q], w);
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (logN == 6 && scale.x) {
        a[q] = shoup_mul<P>(a[q], scale);
        c[q] = shoup_mul<P>(c[q], scale);
      }
      y[q * N + lane] = a[q];
      y[q * N + lane + 32] = c[q];
    }
  }
  for (int lt = 6; lt < logN;) {
    __syncthreads();
    const int base = 1 << (logN - 1 - lt);
    if (lt + 1 < logN) {  // spans 2^lt and 2^(lt+1)
      const int t = 1 << lt, Q = N >> 2;
      const bool last = lt + 2 == logN && scale.x;
      for (int idx = threadIdx.x; idx < ng * Q; idx += nt) {
        const int kk = idx & (Q - 1), j = kk >> lt;
        uint32_t* y = x + (idx >> (logN - 2)) * NP * N + (j << (lt + 2)) +
                      (kk & (t - 1));
        const uint2 wa0 = tw[base + 2 * j], wa1 = tw[base + 2 * j + 1];
        const uint2 wb = tw[(base >> 1) + j];
        uint32_t v[NP][4];
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[q][e] = y[q * N + e * t];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          gs<P>(v[q][0], v[q][1], wa0);
          gs<P>(v[q][2], v[q][3], wa1);
          gs<P>(v[q][0], v[q][2], wb);
          gs<P>(v[q][1], v[q][3], wb);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[q * N + e * t] = last ? shoup_mul<P>(v[q][e], scale) : v[q][e];
        }
      }
      lt += 2;
    } else {  // the last span alone
      const int t = 1 << lt, H = N >> 1;
      const bool last = scale.x;
      for (int idx = threadIdx.x; idx < ng * H; idx += nt) {
        const int k = idx & (H - 1);
        uint32_t* y = x + (idx >> (logN - 1)) * NP * N +
                      ((k >> lt) << (lt + 1)) + (k & (t - 1));
        const uint2 w = tw[base + (k >> lt)];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          uint32_t u = y[q * N], v = y[q * N + t];
          gs<P>(u, v, w);
          y[q * N] = last ? shoup_mul<P>(u, scale) : u;
          y[q * N + t] = last ? shoup_mul<P>(v, scale) : v;
        }
      }
      lt += 1;
    }
  }
  if (sync_end) __syncthreads();
}

// Garner: the integer x = r1 + P1 * ((r2 - r1) * P1^-1 mod P2) in
// [0, P1*P2), centred to (-P1*P2/2, P1*P2/2), mod 2^32
// (crypto/ntt.py:crt_center).
__device__ __forceinline__ uint32_t crt_mod32(uint32_t r1, uint32_t r2) {
  const uint32_t diff = submod<P2>(r2, r1 >= P2 ? r1 - P2 : r1);
  const uint64_t x =
      r1 + (uint64_t)P1 *
               shoup_mul<P2>(diff, INV_P1_MOD_P2, INV_P1_MOD_P2_S);
  return (uint32_t)(x >= P1P2 / 2 ? x - P1P2 : x);
}

// log2 N for N a power of two in [64, 2048], else -1.
inline int log2_ring(int N) {
  int logN = 0;
  while ((1 << logN) < N) ++logN;
  return (N >= 64 && N <= 2048 && (1 << logN) == N) ? logN : -1;
}

// The lvl1 ring and gadget of a launch (the arguments ops/br.py:ring_args
// passes): twiddle tables, the inverse's scale, N, l, Bgbit, decompose1's
// offset.
struct Ring {
  const uint2* tw;  // [2 primes][forward, inverse][N] (w, w')
  uint2 scale[2];   // per prime: N^-1 2^32 mod P and its companion
  int N, logN, l, Bgbit;
  uint32_t offset;  // decompose1's centring + rounding offset
};

// The Ring of the arguments, or one with logN = -1 if they are out of range.
inline Ring ring(const void* tw, const uint32_t* scale, int N, int l,
                 int Bgbit, uint32_t offset) {
  const bool ok = l >= 1 && l <= 4 && Bgbit >= 1 && l * Bgbit <= 31;
  return Ring{static_cast<const uint2*>(tw),
              {make_uint2(scale[0], scale[1]), make_uint2(scale[2], scale[3])},
              N, ok ? log2_ring(N) : -1, l, Bgbit, offset};
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
