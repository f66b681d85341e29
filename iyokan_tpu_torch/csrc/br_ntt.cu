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
// K4 and K5 are the cluster form of br_cluster.cuh: four CTAs (prime,
// part) per row, over the key's kernel form (ops/br.py:kernel_key).  K5
// runs K4's instantiation with S = 1: one CMUX step a launch, the
// accumulator in global memory between launches, as pallas_br's contract
// has it; its n launches go back to back from one C call (br_ntt_steps,
// the counterpart of the JAX fori_loop), all but the first with
// programmatic dependent launch, so a step's CTAs load their twiddles
// while the previous step drains.
// What bounds both on the H100: 32-bit integer multiplies (per row and step
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
// Findings).  K5 pays per launch what K4's loop pays once: this prime's
// twiddles into shared memory (16 KB a CTA at cggi128), the accumulator in
// and out (32 MB a step at G = 2048), the entry cluster barrier, the
// launch's ramp and drain (PERF.md, Findings, has each part's cost).

// Built by iyokan_tpu_torch/ops/nvcc.py (hash of this file and the headers
// it includes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbr_ntt-<hash>.so br_ntt.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

#include "br_cluster.cuh"

namespace {

ClusterPlans<false, 1> loop_plans;  // K4, and K5 at S = 1

}  // namespace

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
//   form; tw uint32 [2, 2, N, 2] = psirev, psiinvrev of P1, P2 with
//   companions; offset = decompose1's offset mod 2^32; N a power of two in
//   [64, 2048]; l = 3.  Returns 0 or the first CUDA error; a card that
//   cannot hold one cluster refuses (cudaErrorLaunchOutOfResources).
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

// K5: the n CMUX steps of every row as n launches of one step each, back
// to back on `stream`, one cluster of four CTAs of nt (256 or 512) threads
// per row; arguments as br_ntt_loop (abar_t [n, G], kkey [n, 2, 2, 1, l, 2,
// N]).  Returns the number of kernels launched (n), or minus the first
// CUDA error.
extern "C" int br_ntt_steps(void* acc, const void* abar_t, const void* kkey,
                            const void* tw, int G, int n, int N, int l,
                            int Bgbit, uint32_t offset, int nt, int device,
                            void* stream) {
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  const BrArgs A{static_cast<int32_t*>(acc),
                 static_cast<const int32_t*>(abar_t),
                 static_cast<const uint32_t*>(kkey), nullptr, 1, G,
                 ring(tw, none, N, l, Bgbit, offset)};
  return loop_plans.steps(A, n, nt, device,
                          reinterpret_cast<cudaStream_t>(stream));
}

// The grid (CTAs), cluster size and threads a CTA of this library's last
// cluster launch (K4's, or K5's last step).
extern "C" void br_ntt_last_launch(int* out) {
  out[0] = last_launch[0];
  out[1] = last_launch[1];
  out[2] = last_launch[2];
}

extern "C" const char* br_ntt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
