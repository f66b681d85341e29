// K1's small-batch form: the whole lvl1 blind rotation (all n_steps CMUX
// steps of a tkey slab) in one persistent launch.  Included by
// tkey_blind_rotate.cu; the step's math is that file's (digits, the
// K-major Toeplitz product, the limb recombination), with its schedule:
// iyokan_tpu/ops/pallas_tk.py::_kernel_pipe runs every step in one
// pallas_call (a fori_loop over the steps, the slab streamed from HBM by
// DMA slots), and so does this kernel.  It serves the fat and thin slabs
// (one rotation a step); fat2 and the 2-bit-unrolled slab take the
// per-step forms.
//
// Partition.  A contraction "block" b is the slab rows of one 128-
// coefficient block of every digit row: RR*128 rows (b*RR*128 .. on fat,
// rr*N + b*128 on thin).  Output block K takes from block b the digits of
// coefficient block j = (b + K + 1) mod NB, negated where b + K + 1 >= NB,
// i.e. j <= b (the K-major form of the product).  So
//   - a cluster of NB CTAs owns one column tile of the slab: part u, all L
//     limbs, CW = 32 coefficients: 8 clusters (16 clusters of 16
//     coefficients would need 16 clusters of NB resident at once, and the
//     H100 holds 15 clusters of 8 such CTAs);
//   - CTA rank b of it owns contraction block b and reduces output block
//     K = b;
//   - every CTA of the cluster multiplies the same A: the digit blocks of
//     all NB coefficient blocks, stacked (j, gate) in rows, GT = 16 gates
//     a tile.  CTA b computes block j = b itself and writes it, already in
//     A's swizzled layout, to the cluster's slot of an exchange buffer in
//     device memory (two parities); after a cluster barrier each CTA loads
//     the whole A from there, one bulk copy a k-tile.  (Pushing the rows
//     into the other CTAs' shared memory, and pulling the partials from
//     it, was the slower path on the H100: PERF.md section 6.)  The wrap
//     sign is a property of (j, b), so it is applied to the partial sums,
//     and A needs no negated copy;
//   - the product runs on wgmma (m64nNk32, N = L*CW): two warpgroups, one
//     64-row M tile each, cover the NB*GT <= 128 rows of A (at NB < 8 the
//     rows past NB*GT are multiplied and never stored, so no warpgroup
//     branches around its products);
//   - each CTA recombines the limbs of its partials in registers and
//     stores them, uint32 [NB*GT][CW], to the cluster's part of the
//     exchange buffer; after cluster barrier 2 the CTA that owns output
//     block K sums the NB partials of its rows from there (L2) and stores
//     acc_next = acc_cur + the sum with a plain store: no atomics, one
//     owner a word.
// A step: for each gate tile: the digits, cluster barrier 1, the A load,
// the product, the partials, cluster barrier 2, the reduction.  Then one
// grid barrier (acc_next complete) and acc ping-pongs between the caller's
// buffer and a scratch one (the last state is copied back when the step
// count is odd).
//
// The slab runs ahead: a step's k-tiles (L boxes of CW columns x 128
// contraction bytes each, issued from the lanes of a warp) stream through
// a ring of `nslot` slots by TMA; a slot is refilled with the step nslot
// later once the last gate tile has used it, so the next loads overlap
// this step's partials, reduction, grid barrier and digits.
//
// The grid is exactly the clusters of the column tiles, one CTA an SM, and
// the grid barrier needs every CTA resident, so the launch is cooperative
// as well as clustered: CUDA refuses a grid that cannot be resident at
// once (cudaErrorCooperativeLaunchTooLarge), and so does the launcher
// where cudaOccupancyMaxActiveClusters says the card cannot hold the
// clusters.  The barrier's word is the last one of the launch's exchange
// buffer, zeroed on the launch's stream just before it (a memset node
// beside the kernel node in a CUDA graph), so launches on other streams
// share nothing.  A barrier or mbarrier wait of more than ~2^35 cycles
// traps, so a broken schedule fails the launch instead of holding the
// card.
//
// Bound (cggi128, fat, L = 3, lb = 2): 635 steps x a 3.9 MB slab, 0.745 ms
// at 3.35 TB/s; int8 operations 2 x 635 x G x 8 x 5120 x 768, 1.29 ms at
// G = 64.  What a step costs beyond that is latency: the grid barrier, two
// cluster barriers, and the round trips to L2 of the digits, the A load
// and the reduction (PERF.md: the ablation and the per-phase clock
// profile).

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

#include <cstdio>
// 1: thread 0 of CTAs 0 and 13 clocks each phase of a step and prints the
// cycles a step at the end of the launch (tools/k1_loop_profile.json
// builds such a copy; the port's library is built with 0)
#define TKLOOP_PROF 0


// Internal linkage: the function-local statics below (per-card plans) stay
// this library's own, also beside an edited copy of it loaded in the same
// process (tools/br_variants.py).
namespace {
namespace tkloop {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;  // two warpgroups
constexpr int CW = 32;        // coefficients a column tile
constexpr int GT = 16;        // gates a tile
constexpr int CLUSTERS = 2 * 128 / CW;  // column tiles: (part, 128 / CW)
constexpr int MAX_SLOTS = 4;      // slab ring depth, in steps
constexpr int SMEM_MAX = 232448;  // an H100 CTA's dynamic shared memory
constexpr int MAX_DEVICES = 16;
// A's k-tile region in shared memory: the rows (j, gate) of one 128-byte
// k-tile, one 64-row M tile a warpgroup
constexpr int REGION = 2 * 64 * 128;

struct Args {
  const int32_t* rows;  // [n_steps, Gp] rotation amounts
  uint32_t* acc;        // [Gp, 2, N], the caller's buffer (step 0 reads it)
  uint32_t* scratch;    // [Gp, 2, N]
  uint8_t* stage;       // the A exchange, then the partials (stage_bytes)
  unsigned* bar;        // the grid barrier word (zero at the launch)
  int Gp, n_steps, N, l, lb, Bgbit;
  int bstride, rstride;  // contraction coordinate b*bstride + rr*rstride
  int nslot;
  uint32_t off_a, off_b;
};

// Bytes of the exchange buffer at (NB, ktc): the digit rows
// [2][CLUSTERS][ktc][NB*GT][128], the partials [CLUSTERS][NB CTAs][NB*GT]
// [CW] uint32, then 128 bytes whose first word is the grid barrier's
inline size_t stage_bytes(int NB, int ktc) {
  return (size_t)CLUSTERS * NB * GT * (2 * ktc * 128 + NB * CW * 4) + 128;
}

// Dynamic shared memory at (L, ktc), 0 where not even one slab slot fits;
// *nslot: the ring's depth.
inline int smem_bytes(int L, int ktc, int* nslot) {
  const int a = ktc * REGION;
  const int chunk = ktc * L * CW * 128;
  const int fixed = 1024 + a + 8 * (1 + MAX_SLOTS);
  int ns = (SMEM_MAX - fixed) / chunk;
  if (ns > MAX_SLOTS) ns = MAX_SLOTS;
  if (ns < 1) return 0;
  *nslot = ns;
  return fixed + ns * chunk;
}

// a cluster barrier the ablation's edits leave in place (entry and exit)
__device__ __forceinline__ void cluster_fence() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// `bytes` of global memory at src into this CTA's shared memory at dst,
// counted on bar (a bulk copy, no tensor map)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(wgs8::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(wgs8::smem_u32(bar))
      : "memory");
}

// Every CTA of the grid at this point, with the writes before it visible
// after it: generation-counted from a zero word (the high bit flips once
// all have arrived; the word's low bits are 0 again after each barrier).
// The CTA's writes are released by thread 0's add (after the block
// barrier) and acquired by its load.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned nb = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, cur;
    asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(bar), "r"(nb) : "memory");
    const long long t0 = clock64();
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(cur) : "l"(bar) : "memory");
      if (clock64() - t0 > (1ll << 35)) __trap();
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// byte t of A row `row` in a 128-byte-swizzled k-tile region
__device__ __forceinline__ int swz(int row, int t) {
  return row * 128 + ((((t >> 4) ^ (row & 7)) << 4) | (t & 15));
}

// A thread's digit items: (gate, part, 4 coefficients), GT / 4 of them,
// run 4 a pass so their loads stay in registers
struct Items {
  static constexpr int N = GT * 2 * 32 / THREADS;
  static constexpr int PASS = 4;
  __device__ static int q(int k) { return threadIdx.x + k * THREADS; }
  __device__ static int gate(int k) { return q(k) >> 6; }
};

// the rotation amounts of this thread's items at step `step`, tile t
// (loaded ahead: the digits then need one round trip to L2)
__device__ __forceinline__ void load_rot(const Args& A, int step, int t,
                                         int (&rv)[Items::N]) {
  const int32_t* rot = A.rows + (size_t)step * A.Gp + t * GT;
#pragma unroll
  for (int k = 0; k < Items::N; ++k)
    rv[k] = t * GT + Items::gate(k) < A.Gp ? __ldg(rot + Items::gate(k)) : 0;
}

// word e (0-3) of the 4 consecutive words starting `off` words into the
// 8 words lo, hi
__device__ __forceinline__ uint32_t word_at(const uint4& lo, const uint4& hi,
                                            int off, int e) {
  const int k = off + e;
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t v = w[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) v = k == i ? w[i] : v;
  return v;
}

// This CTA's rows of A: the digits (rows (part, j): the step's k-tiles) of
// coefficient block b for gates [GT t, GT t + GT), rotated by rv, into the
// exchange buffer `ex` ([ktc][NB*GT][128], A's regions without padding).
// An item's rotated source is 4 consecutive words of X^r acc, read as the
// two aligned 16-byte groups that hold them (a group never straddles N or
// 2N, so each has one sign); a pass's loads first.
__device__ __forceinline__ void digits(const Args& A, const uint32_t* cur,
                                       uint8_t* ex, int rows_a,
                                       const int (&rv)[Items::N], int t,
                                       int b) {
  constexpr int PASS = Items::PASS;
  const int N = A.N, mask = 2 * N - 1;
  const uint32_t Bg = 1u << A.Bgbit;
#pragma unroll
  for (int k0 = 0; k0 < Items::N; k0 += PASS) {
    uint4 own[PASS], lo[PASS], hi[PASS];
#pragma unroll
    for (int k = 0; k < PASS; ++k) {
      const int q = Items::q(k0 + k);
      const int quad = q & 31, part = (q >> 5) & 1, g = q >> 6;
      if (t * GT + g >= A.Gp) continue;
      const uint32_t* pp = cur + ((size_t)(t * GT + g) * 2 + part) * N;
      const int i0 = b * 128 + quad * 4;
      // X^r * p: coefficient i is p[m] (m = (i - r) mod 2N < N), else
      // -p[m - N]
      const int s0 = (i0 - rv[k0 + k]) & mask & ~3, s1 = (s0 + 4) & mask;
      own[k] = __ldcg(reinterpret_cast<const uint4*>(pp + i0));
      lo[k] = __ldcg(
          reinterpret_cast<const uint4*>(pp + (s0 < N ? s0 : s0 - N)));
      hi[k] = __ldcg(
          reinterpret_cast<const uint4*>(pp + (s1 < N ? s1 : s1 - N)));
    }
#pragma unroll
    for (int k = 0; k < PASS; ++k) {
      const int q = Items::q(k0 + k);
      const int quad = q & 31, part = (q >> 5) & 1, g = q >> 6;
      if (t * GT + g >= A.Gp) continue;
      const int i0 = b * 128 + quad * 4;
      const int m0 = (i0 - rv[k0 + k]) & mask, off = m0 & 3;
      const int s0 = m0 & ~3;
      const uint32_t ow[4] = {own[k].x, own[k].y, own[k].z, own[k].w};
      const uint32_t add = part ? A.off_b : A.off_a;
      uint32_t x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t v = word_at(lo[k], hi[k], off, e);
        // the word's group: lo's (s0) or hi's (s0 + 4), negated at or
        // past N
        const int sg = off + e < 4 ? s0 : ((s0 + 4) & mask);
        x[e] = (sg < N ? v : 0u - v) - ow[e] + add;
      }
      const int nd = part ? A.lb : A.l, kt0 = part ? A.l : 0;
      const int row = b * GT + g;
      for (int j = 0; j < nd; ++j) {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dg = (int)((x[e] >> (32 - (j + 1) * A.Bgbit)) &
                               (Bg - 1)) - (int)(Bg >> 1);
          w |= (uint32_t)(uint8_t)(int8_t)dg << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(ex + (size_t)(kt0 + j) * rows_a * 128 +
                                     swz(row, quad * 4)) = w;
      }
    }
  }
  // the rows are read back by bulk copies (the async proxy)
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The A gather: after the cluster barrier, every CTA's rows of the step
// from the exchange buffer into A, one bulk copy a k-tile (lanes of warp
// 0), waited for on fullA (phase it)
__device__ __forceinline__ void gather(uint8_t* As, const uint8_t* ex,
                                       int rows_a, int ktc, uint64_t* fullA,
                                       int it) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      wgs8::mbar_expect_tx(fullA, (uint32_t)ktc * rows_a * 128);
    __syncwarp();
    if ((int)threadIdx.x < ktc)
      bulk_load(As + threadIdx.x * REGION,
                ex + (size_t)threadIdx.x * rows_a * 128, rows_a * 128, fullA);
  }
  wgs8::mbar_wait(fullA, it & 1);
}

// d[(j, g), (li, c)] = A . B over the step's k-tiles, for the M tile of
// A's rows m0 .. m0 + 63
template <int NN>
__device__ __forceinline__ void product(uint32_t (&d)[NN / 2],
                                        const uint8_t* As, const uint8_t* Bc,
                                        int ktc, int m0) {
  wgs8::wgmma_fence();
  for (int kt = 0; kt < ktc; ++kt) {
    const uint64_t da = wgs8::desc_sw128(As + kt * REGION + m0 * 128);
    const uint64_t db = wgs8::desc_sw128(Bc + kt * NN * 128);
#pragma unroll
    for (int kk = 0; kk < wgs8::BK / 32; ++kk)
      wgs8::Mma<NN>::run(d, da + 2 * kk, db + 2 * kk);
  }
  wgs8::wgmma_commit();
  wgs8::settle(d);
}

// the partials, limbs recombined, as uint32 [rows_a][CW] at P (this CTA's
// part of the exchange buffer), negated where the rows wrap (j <= b):
// register 4 (j0 + li CW/8) + e holds limb li of coefficient
// 8 j0 + 2 (lane % 4) + (e & 1)
template <int L>
__device__ __forceinline__ void partials(const uint32_t (&d)[L * CW / 2],
                                         uint32_t* P, int rows_a, int b) {
#pragma unroll
  for (int j0 = 0; j0 < CW / 8; ++j0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wgs8::acc_row(2 * h);
      if (row >= rows_a) continue;
      uint32_t v0 = 0, v1 = 0;
#pragma unroll
      for (int li = 0; li < L; ++li) {
        const int i = 4 * (j0 + li * (CW / 8)) + 2 * h;
        v0 += d[i] << (8 * (4 - L + li));
        v1 += d[i + 1] << (8 * (4 - L + li));
      }
      const bool neg = row / GT <= b;
      *reinterpret_cast<uint2*>(P + row * CW + wgs8::acc_col(4 * j0)) =
          make_uint2(neg ? 0u - v0 : v0, neg ? 0u - v1 : v1);
    }
}

// Output block K = b of gates [GT t, GT t + GT), coefficients ct*CW.. of
// part u: the cluster's partials summed (rows (j = (r + b + 1) mod NB,
// gate) of CTA r, read from L2: Pc holds the cluster's [NB][rows_a][CW]),
// nxt = cur + the sum.
__device__ __forceinline__ void reduce(const uint32_t* Pc, int rows_a,
                                       const uint32_t* cur, uint32_t* nxt,
                                       int N, int NB, int Gp, int b, int u,
                                       int ct, int t) {
  for (int q = threadIdx.x; q < GT * CW / 4; q += THREADS) {
    const int g = q / (CW / 4), c4 = q % (CW / 4);
    if (t * GT + g >= Gp) continue;
    const size_t at = ((size_t)(t * GT + g) * 2 + u) * N + b * 128 +
                      ct * CW + c4 * 4;
    uint4 a = __ldcg(reinterpret_cast<const uint4*>(cur + at));
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < NB) {
        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
            Pc + (size_t)(r * rows_a + ((r + b + 1) % NB) * GT + g) * CW +
            c4 * 4));
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
    *reinterpret_cast<uint4*>(nxt + at) = a;
  }
}

// L limbs
template <int L>
__global__ void __launch_bounds__(THREADS, 1)
    tkey_loop_kernel(const __grid_constant__ CUtensorMap bk_map,
                     const Args A) {
  constexpr int NN = L * CW;  // slab columns a CTA (limb, coefficient)
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const As =
      smem_raw + ((1024 - (wgs8::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int N = A.N, NB = N >> 7;
  const int b = (int)cluster.block_rank();
  const int cid = blockIdx.x / NB;
  const int u = cid / (128 / CW), ct = cid % (128 / CW);
  const int ktc = A.l + A.lb;  // k-tiles (digit rows) a step
  const int rows_a = NB * GT;
  const int chunk_b = ktc * NN * 128;  // a step's slab, this CTA's part
  uint8_t* const Bs = As + ktc * REGION;
  uint64_t* const fullA = reinterpret_cast<uint64_t*>(Bs + A.nslot * chunk_b);
  uint64_t* const fullB = fullA + 1;
  const int T = (A.Gp + GT - 1) / GT;
  const int C = 2 * L * 128;
  const size_t ex_bytes = (size_t)ktc * rows_a * 128;
  // the cluster's partials [NB][rows_a][CW], after the digit rows
  uint32_t* const Pc = reinterpret_cast<uint32_t*>(
                           A.stage + 2 * (size_t)CLUSTERS * ex_bytes) +
                       (size_t)cid * NB * rows_a * CW;

  // step s's slab into its slot: one box (k-tile, limb) a lane of the
  // calling warp
  auto issue = [&](int s) {
    const int slot = s % A.nslot;
    if ((tid & 31) == 0) wgs8::mbar_expect_tx(fullB + slot, chunk_b);
    __syncwarp();
    for (int q = tid & 31; q < ktc * L; q += 32) {
      const int kt = q / L, li = q % L;
      wgs8::tma_load(Bs + slot * chunk_b + (kt * NN + li * CW) * 128, &bk_map,
                     b * A.bstride + kt * A.rstride,
                     s * C + (u * L + li) * 128 + ct * CW, fullB + slot);
    }
  };

  if (tid == 0) {
    wgs8::mbar_init(fullA, 1);
    for (int s = 0; s < A.nslot; ++s) wgs8::mbar_init(fullB + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32)
    for (int s = 0; s < A.nslot && s < A.n_steps; ++s) issue(s);
  int rv[Items::N];  // the coming tile's rotation amounts (this thread)
  load_rot(A, 0, 0, rv);
  cluster_fence();  // every CTA of the cluster runs

  const int wg = tid >> 7;
  uint32_t d[NN / 2];
  int it = 0;  // tiles run so far: fullA's phase, the exchange's parity
#if TKLOOP_PROF
  long long pf[12] = {}, tq = clock64();
#define PF(i)                    \
  do {                           \
    const long long tn = clock64(); \
    pf[i] += tn - tq;            \
    tq = tn;                     \
  } while (0)
#else
#define PF(i) do {} while (0)
#endif
  for (int step = 0; step < A.n_steps; ++step) {
    const uint32_t* cur = step & 1 ? A.scratch : A.acc;
    uint32_t* nxt = step & 1 ? A.acc : A.scratch;
    const int slot = step % A.nslot;
    for (int t = 0; t < T; ++t) {
      uint8_t* ex = A.stage + ((size_t)(it & 1) * CLUSTERS + cid) * ex_bytes;
      if (t > 0) load_rot(A, step, t, rv);
      PF(0);
      digits(A, cur, ex, rows_a, rv, t, b);
      PF(1);
      // 1: the cluster's rows are in the exchange buffer, and the other
      // CTAs are done with the last ones and with the partials
      cluster.sync();
      PF(2);
      gather(As, ex, rows_a, ktc, fullA, it);
      PF(3);
      wgs8::mbar_wait(fullB + slot, (step / A.nslot) & 1);
      PF(4);
#pragma unroll
      for (int i = 0; i < NN / 2; ++i) d[i] = 0;
      product<NN>(d, As, Bs + slot * chunk_b, ktc, wg * 64);
      PF(5);
      partials<L>(d, Pc + (size_t)b * rows_a * CW, rows_a, b);
      PF(7);
      __syncthreads();  // both warpgroups' products are done
      if (t == T - 1 && tid < 32 && step + A.nslot < A.n_steps)
        issue(step + A.nslot);  // the slot's last use: refill it
      PF(6);
      ++it;
      cluster.sync();  // 2: every CTA's partials are in place
      PF(8);
      reduce(Pc, rows_a, cur, nxt, N, NB, A.Gp, b, u, ct, t);
      PF(9);
    }
    if (step + 1 < A.n_steps) load_rot(A, step + 1, 0, rv);
    grid_sync(A.bar);  // acc_next is complete everywhere
    PF(10);
  }
#if TKLOOP_PROF
  if (tid == 0 && (blockIdx.x == 0 || blockIdx.x == 13))
    printf("tkloop prof CTA %d Gp %d: cycles a step: rot %lld digits %lld "
           "cluster1 %lld gather %lld waitB %lld product %lld sync+issue "
           "%lld partials %lld cluster2 %lld reduce %lld grid %lld\n",
           blockIdx.x, A.Gp, pf[0] / A.n_steps, pf[1] / A.n_steps,
           pf[2] / A.n_steps, pf[3] / A.n_steps, pf[4] / A.n_steps,
           pf[5] / A.n_steps, pf[6] / A.n_steps, pf[7] / A.n_steps,
           pf[8] / A.n_steps, pf[9] / A.n_steps, pf[10] / A.n_steps);
#endif
#undef PF
  cluster_fence();  // no CTA leaves while the others may read its partials
  if (A.n_steps & 1)  // the last state is in scratch: back to the caller's
    for (int t = 0; t < T; ++t)
      for (int q = tid; q < GT * CW / 4; q += THREADS) {
        const int g = q / (CW / 4), c4 = q % (CW / 4);
        if (t * GT + g >= A.Gp) continue;
        const size_t at = ((size_t)(t * GT + g) * 2 + u) * N + b * 128 +
                          ct * CW + c4 * 4;
        *reinterpret_cast<uint4*>(A.acc + at) =
            *reinterpret_cast<const uint4*>(A.scratch + at);
      }
}

// the launch configuration: CLUSTERS clusters of NB CTAs, cooperative
// (CUDA refuses a grid that cannot be resident at once) where
// `coop`; attrs must hold two entries
inline cudaLaunchConfig_t config(int NB, int smem, bool coop,
                                 cudaLaunchAttribute* attrs) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = NB;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NB * CLUSTERS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attrs;
  cfg.numAttrs = coop ? 2 : 1;
  return cfg;
}

// The plan on `device` at L limbs, NB CTAs a cluster and ktc k-tiles a
// step: out = {CW, clusters, CTAs a cluster (NB), threads, smem, nslot,
// clusters of it the card holds at once, GT}.  0 or a CUDA error (invalid
// value where its shared memory does not fit).
template <int L>
int query(int device, int NB, int ktc, int* out) {
  static bool raised[MAX_DEVICES] = {};
  static int held[MAX_DEVICES][9][8] = {};
  if (device < 0 || device >= MAX_DEVICES || NB < 1 || NB > 8 || ktc < 1 ||
      ktc > 7)
    return (int)cudaErrorInvalidValue;
  int nslot = 0;
  const int smem = smem_bytes(L, ktc, &nslot);
  if (!smem) return (int)cudaErrorInvalidValue;
  if (!raised[device]) {  // every (NB, ktc) fits under it
    const cudaError_t e = cudaFuncSetAttribute(
        tkey_loop_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    raised[device] = true;
  }
  if (!held[device][NB][ktc]) {
    cudaLaunchAttribute at[2];
    const cudaLaunchConfig_t cfg = config(NB, smem, false, at);
    int n = 0;
    const cudaError_t q =
        cudaOccupancyMaxActiveClusters(&n, tkey_loop_kernel<L>, &cfg);
    if (q != cudaSuccess) return (int)q;
    held[device][NB][ktc] = n;
  }
  out[0] = CW;
  out[1] = CLUSTERS;
  out[2] = NB;
  out[3] = THREADS;
  out[4] = smem;
  out[5] = nslot;
  out[6] = held[device][NB][ktc];
  out[7] = GT;
  return 0;
}

// The whole rotation at (L, layout: thin or not), on `st`: plan, tensor
// map of the K-contiguous slab [n_steps*C][RT] in boxes of CW columns x 128
// contraction bytes, the barrier word zeroed, one cooperative cluster
// launch.  used: the plan (query's out).
template <int L>
int run(const int32_t* rows, uint32_t* acc, uint32_t* scratch,
        uint8_t* stage, size_t stage_size, const int8_t* bk, int Gp,
        int n_steps, int N, int l, int lb, int Bgbit, bool thin,
        uint32_t off_a, uint32_t off_b, int device, cudaStream_t st,
        int* used) {
  const int NB = N >> 7, ktc = l + lb;
  int e = query<L>(device, NB, ktc, used);
  if (e) return e;
  if (used[6] < CLUSTERS) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t sb = stage_bytes(NB, ktc);
  if (stage_size < sb) return (int)cudaErrorInvalidValue;
  const int RT = ktc * N;
  CUtensorMap map;
  if ((e = wgs8::encode_2d(&map, bk, RT, (uint64_t)n_steps * 2 * L * 128, RT,
                           CW)))
    return e;
  unsigned* bar = reinterpret_cast<unsigned*>(stage + sb - 128);
  cudaError_t c = cudaMemsetAsync(bar, 0, sizeof(unsigned), st);
  if (c != cudaSuccess) return (int)c;
  const Args A{rows, acc, scratch, stage, bar, Gp, n_steps, N, l, lb, Bgbit,
               thin ? 128 : ktc * 128, thin ? N : 128, used[5], off_a,
               off_b};
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = config(NB, used[4], true, at);
  cfg.stream = st;
  c = cudaLaunchKernelEx(&cfg, tkey_loop_kernel<L>, map, A);
  return c != cudaSuccess ? (int)c : (int)cudaGetLastError();
}

}  // namespace tkloop
}  // namespace
