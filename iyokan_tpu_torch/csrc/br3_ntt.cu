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
// builds the same array); the key in its kernel form (ops/br.py:kernel_key,
// from the CRT64 prep1 key).
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
// Design: the cluster form of br_cluster.cuh, four CTAs (prime p, part u)
// per row.  Slot pos of a forward transform holds the value at
// psi^(2k+1), k = bit-reverse(pos) (crypto/ntt.py's order), where X^a - 1
// is the scalar psi^(a(2k+1)) - 1: CTA (p, u) reads it, with its Shoup
// companion, from a table of psi^e - 1 mod p for e in [0, 2N)
// (crypto/ntt.py:kernel_tables; the - 1 is folded into the table) and
// applies it to each m's reduced partial sum before summing over m, so only
// one sum a part runs through the inverse transform, whatever M.
//
// What bounds it on the H100: 32-bit integer multiplies (per row and step
// 2 primes x ((2l + 2) N/2 log2 N butterflies + M * 2 * 2l * N key
// products + 2 * M * N twiddle products) + 2N Garner products, at about
// three multiplies each), and the L2 bytes of the key: every row streams
// the whole key (n * 96 KB = 62.4 MB plain, 318 * 288 KB = 93.8 MB
// unrolled, both larger than the 50 MB L2).  The design answers the first
// with 32-bit Shoup and Montgomery products, N^-1 folded into the key and
// the psi power's - 1 into the table, and a serial chain per step of l
// forward and one inverse transform; the second by reading each CTA's
// slice of a step once (measured on the H100, the key's bytes do not bind:
// PERF.md, Findings).
//
// Built by iyokan_tpu_torch/ops/nvcc.py (hash of this file and the headers
// it includes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbr3_ntt-<hash>.so br3_ntt.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "br_cluster.cuh"

namespace {

ClusterPlans<true, 1> m1_plans;
ClusterPlans<true, 3> m3_plans;

}  // namespace

// K3's dynamic shared memory per CTA (br_cluster_smem) and the clusters the
// card holds at once at nt threads a CTA into out[0], out[1]; 0 or a CUDA
// error (M not 1 or 3: invalid value).
extern "C" int br3_ntt_plan(int N, int l, int M, int nt, int device,
                            long long* out) {
  size_t smem = 0;
  int n = 0;
  const int e = M == 1   ? m1_plans.prepare(device, N, l, nt, &smem, &n)
                : M == 3 ? m3_plans.prepare(device, N, l, nt, &smem, &n)
                         : (int)cudaErrorInvalidValue;
  out[0] = (long long)smem;
  out[1] = n;
  return e;
}

// K3: all n_steps decompose-first CMUX steps of every row in one launch,
// one cluster of four CTAs of nt (256 or 512) threads per row.
//   acc int32 [G, 2, N] (updated in place); steps int32 [n_steps, M, G],
//   rotation amounts in [0, 2N); kkey int32 [n_steps, 2, 2, M, l, 2, N],
//   the key's kernel form; tw uint32 [2, 2, N, 2] = psirev, psiinvrev of
//   P1, P2 with companions; pw uint32 [2, 2N, 2] = psi^e - 1 mod P1, P2
//   with companions; offset = decompose1's offset mod 2^32; M in {1, 3};
//   l = 3; N a power of two in [64, 2048].  Returns 0 or the first CUDA error; a
//   card that cannot hold one cluster refuses
//   (cudaErrorLaunchOutOfResources).
extern "C" int br3_ntt(void* acc, const void* steps, const void* kkey,
                       const void* tw, const void* pw, int G, int n_steps,
                       int M, int N, int l, int Bgbit, uint32_t offset,
                       int nt, int device, void* stream) {
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  const BrArgs A{static_cast<int32_t*>(acc),
                 static_cast<const int32_t*>(steps),
                 static_cast<const uint32_t*>(kkey),
                 static_cast<const uint2*>(pw), n_steps, G,
                 ring(tw, none, N, l, Bgbit, offset)};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return M == 1   ? m1_plans.launch(A, nt, device, s)
         : M == 3 ? m3_plans.launch(A, nt, device, s)
                  : (int)cudaErrorInvalidValue;
}

// The grid (CTAs), cluster size and threads a CTA of this library's last
// cluster launch.
extern "C" void br3_ntt_last_launch(int* out) {
  out[0] = last_launch[0];
  out[1] = last_launch[1];
  out[2] = last_launch[2];
}

extern "C" const char* br3_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
