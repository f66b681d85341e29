// Toeplitz-slab blind rotation for Hopper (sm_90a): the lvl1 gate
// bootstrap's CMUX steps as int8 tensor-core products, exact mod 2^32.
//
// Replaces iyokan_tpu/ops/pallas_tk.py::_kernel_pipe (the TPU default) and
// ::_kernel (its one-chain form) on every slab layout of
// crypto/polymul.tkey_kernel_key, with the asymmetric gadget: any L in
// {3, 4} key limbs and lb in [1, l] b-part digits.  The TPU's chain
// interleave, DMA slots and compile-probe ladder are schedule, not math, and
// are not carried over; its K-major form is both kernels'.  Layouts (RR =
// M*(l+lb) digit rows a step, RT = RR*N contraction rows, C = 2*L*128
// columns ordered (u, limb, 128)):
//   fat       [n, RT, C], rows (block, part, j, 128), M = 1;
//   unrolled  [ceil(n/2), RT, C] at M = 3: the fat slab of the 2-bit-unrolled
//             key, rows (block, m, part, j, 128), rotations (a1, a2, a1+a2)
//             of a key-bit pair a step: the fat kernel at RR = 3(l+lb);
//   thin      [n, l+lb, N, C], rows (j, t): the digits are written in (j, t)
//             order and output block K reads digit row j at
//             t + 128(K+1) mod N (seg = N, shift = 128 below);
//   fat2      [n, 2*RT, C]: the negated key's fat slab, then the key's.
//             Its math is one window per block, ext . bk[RT-cut : 2RT-cut]
//             (pallas_tk.py:181-184, 380-381): the wrapped rows come from
//             the first copy with no digit negation.  (With L = 3 the first
//             copy is not the limb-wise negation of the second where a key
//             coefficient's dropped limb is -128, so reading the second copy
//             negated, as _kernel_pipe's K-major branch does at
//             pallas_tk.py:345, gives another result at cggi128.)  Each
//             k-tile therefore brings both copies' rows into shared memory.
//
// Per step i (NB = N/128 output blocks):
//   digits_kernel: x_u = X^{rot_m[g]} acc_u - acc_u + off_u for each of the
//     M rotations, its signed base-Bg digits as int8 ext[g, :] in the
//     slab's row order;
//   the product: s_K[g, :] = sum_r A_K[g, r] * bk[r, :] (one K-major
//     product, see below), recombined as sum_li s_K[u, li] << 8*(4-L+li) in
//     uint32 and added in place to acc[g, u, 128K : 128K+128].
// int32 accumulation is exact: |digit| <= 32, |limb| <= 128, contraction
// at most 15360 (unrolled, cggi128) bound every partial sum by 2^26.
//
// What bounds it on the H100: one gate bootstrap is n*NB*RT*2L*128 =
// 635*8*5120*768 = 2.0e10 int8 MACs (fat, L=3, lb=2; 1.5x that at half the
// steps unrolled), and every step streams a 3.9 MB slab (5120 x 768 int8;
// 11.8 MB unrolled) that all gates of the batch share.  At large batches
// the products bound it; at small batches the slab stream does (and the
// per-step forms' 2n launches, which the persistent form removes).  The
// slab lies on the card contraction-contiguous (ops/tkey.py:k_contiguous:
// physical [n, C, RT], fat2 [n, C, 2RT], thin [n, C, RR, N]), because
// every tensor-core form below takes B K-major.
// A rotation runs in one of three forms, chosen by the caller (ops/tkey.py
// route_form; `form` there forces one):
//   the persistent form (tkey_loop.cuh, tkey_loop_rotate below; it serves
//     fat and thin, and the route gives it padded batches below
//     LOOP_MAX_G there): all n_steps steps in one cooperative launch of
//     clusters of NB CTAs, digits, product (wgmma), reduction and a grid
//     barrier a step; see that file.
//   Per-step forms, two launches a step (digits_kernel, then the product;
//   2n launches a rotation), from tkey_blind_rotate below:
//   conv_wgmma_kernel (batches of at least WGMMA_MIN_G): a
//     step is one GEMM over rows (output block K, gate).  A CTA owns 128
//     gates of one block K x one part u x 64 coefficients of all L limbs
//     (N = L*64: the L limbs of a coefficient land in one thread's
//     registers, so the recombination needs no shuffle).  The shared
//     mainloop of wgmma_s8.cuh (TMA into 128-byte-swizzled tiles, a 4-deep
//     mbarrier ring, two consumer warpgroups on wgmma m64nNk32) runs the
//     k-tile schedule of conv_tile/wrap_order: the rows that do not wrap
//     first, then the wrapped ones, whose minus sign is a negation of the
//     accumulator before and after them (-(-P + W) = P - W, exact mod
//     2^32); fat2 switches B to the first copy instead.  Each output
//     belongs to one CTA: a plain += into acc.
//   conv_kernel (the other batches below WGMMA_MIN_G): mma.sync
//     m16n8k32 s8 -> s32; a tile is 16 gates x all 8 output blocks (one
//     warp each) x (L x 32) slab columns, so each slab tile brought into
//     shared memory serves every output block; a 4-deep cp.async ring of
//     64-row k-tiles; the K-contiguous slab goes straight into the B
//     fragments' layout; the contraction is split across tiles (exact
//     uint32 atomics: addition mod 2^32 is associative) so the grid still
//     covers the SMs.
//
// Built by iyokan_tpu_torch/ops/tkey.py through ops/nvcc.py (nvcc for
// sm_90a, plain C interface below, called through ctypes).

#include <cstdint>
#include <cuda_runtime.h>

#include "tkey_loop.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int GB = 16;     // gates per conv tile (one m16 tile)
constexpr int MAXNB = 8;   // output blocks a tile covers: N <= 1024
constexpr int THREADS = 32 * MAXNB;  // one warp per output block
constexpr int BK = 64;     // contraction rows per shared-memory stage
constexpr int STAGES = 4;  // cp.async ring depth (k-tiles in flight + 1)
constexpr int CT = 32;     // output coefficients per tile (per limb strip)
constexpr int ASTR = 80;   // shared row stride of the digit tile (bytes)
constexpr int BSTR = 80;   // row stride of the slab tile [column][k] (bytes)

// the slab layouts of the C interface (the 2-bit-unrolled slab is FAT at
// M = 3)
enum Layout { FAT = 0, THIN = 1, FAT2 = 2 };

// The digit of coefficient i in digit row rr (rows ordered (m, part, j),
// RR = M*(l+lb) of them) lands at ext[g, (i>>7)*bstride + rr*rstride +
// (i&127)]: bstride = RR*128 and rstride = 128 on the fat layouts (lanes
// (block, m, part, j, 128)), bstride = 128 and rstride = N on thin (rows
// (j, t)).
template <int M, bool THIN>
__global__ void digits_kernel(const int32_t* __restrict__ rot,   // [M, Gp]
                              const uint32_t* __restrict__ acc,  // [Gp,2,N]
                              int8_t* __restrict__ ext,          // [Gp,RT]
                              int Gp, int N, int l, int lb, int Bgbit,
                              uint32_t off_a, uint32_t off_b) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)Gp * N) return;
  const int g = (int)(idx / N), i = (int)(idx % N);
  const int RR = M * (l + lb);
  const int bstride = THIN ? 128 : RR * 128, rstride = THIN ? N : 128;
  const int twoN = 2 * N;
  const uint32_t Bg = 1u << Bgbit;
  int8_t* out = ext + (size_t)g * RR * N + (size_t)(i >> 7) * bstride +
                (i & 127);
  int rr = 0;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    // X^r * p: coefficient i is p[m] for m = (i - r) mod 2N < N, else -p[m-N]
    int m = (i - rot[(size_t)q * Gp + g]) % twoN;
    if (m < 0) m += twoN;
    const int src = m < N ? m : m - N;
    for (int part = 0; part < 2; ++part) {
      const uint32_t* pp = acc + ((size_t)g * 2 + part) * N;
      const uint32_t v = pp[src];
      const uint32_t r = m < N ? v : 0u - v;
      const uint32_t x = r - pp[i] + (part ? off_b : off_a);
      const int nd = part ? lb : l;
      for (int j = 0; j < nd; ++j, ++rr) {
        const int d = (int)((x >> (32 - (j + 1) * Bgbit)) & (Bg - 1)) -
                      (int)(Bg >> 1);
        out[(size_t)rr * rstride] = (int8_t)d;
      }
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING));
}

// The k-tile schedule of both forms.  Output block K reads the digit
// extension negacyclically rotated against the plain slab (the K-major form
// of pallas_tk.py::_kernel_pipe): the contraction splits into segments of
// seg rows (one on the fat layouts, seg = RT; one per digit row on thin,
// seg = N, a power of two), each rotated by (K+1)*shift rows (shift =
// 128*RR on the fat layouts, 128 on thin):
//   s_K[g, :] = sum_r A_K[g, r] * bk[r, :],  r = base + t (t < seg),
//   A_K[g, r] = ext[g, base + (t + (K+1)*shift) mod seg], negated where
//               t + (K+1)*shift >= seg (the row wraps).
// On FAT2 a wrapped row is not negated but read from the first copy:
// A_K[g, r] = ext[g, (r + cut) mod RT] against the first copy's row r where
// r + cut >= RT, against the second copy's elsewhere (slab contraction
// coordinate r or RT + r).  seg and shift are multiples of 128, so a k-tile
// of 64 or 128 rows never straddles a segment or a wrap.
struct ConvTile {
  int acol;   // ext column of the k-tile's first row for block K
  int bk;     // the slab's contraction coordinate of that row
  bool wrap;  // its rows wrap: a minus sign, or (FAT2) the first copy
};

template <int MODE>
__device__ __forceinline__ ConvTile conv_tile(int r0, int K, int seg,
                                              int shift, int RT) {
  const int t0 = MODE == THIN ? (r0 & (seg - 1)) : r0;  // row in its segment
  int o = t0 + (K + 1) * shift;
  const bool wrap = o >= seg;
  if (wrap) o -= seg;
  return {r0 - t0 + o, MODE == FAT2 ? (wrap ? r0 : RT + r0) : r0, wrap};
}

// The wgmma form's order: position q of block K's sequence -> its 128-row
// k-tile.  Every segment's rows that do not wrap come first, then the
// wrapped ones, so the accumulator changes sign at most twice.
__device__ __forceinline__ int wrap_order(int q, int K, int seg, int shift,
                                          int RT) {
  const int TS = seg / wgs8::BK, nseg = RT / seg;
  const int PS = (seg - (K + 1) * shift) / wgs8::BK;  // plain k-tiles a seg
  if (q < nseg * PS) return (q / PS) * TS + q % PS;
  q -= nseg * PS;
  const int WS = TS - PS;
  return (q / WS) * TS + PS + q % WS;
}

// Shared-memory plan of conv_kernel<L, MODE>: a STAGES-deep ring of digit
// tiles A (MAXNB*GB rows x 64 bytes) and slab tiles B [L*32 columns][64
// contraction bytes], NBT of them (fat2 brings both copies).
template <int L, int MODE>
struct ConvSmem {
  static constexpr int BW = L * CT;              // slab columns per tile
  static constexpr int NBT = MODE == FAT2 ? 2 : 1;  // slab tiles per k-tile
  static constexpr int A_BYTES = MAXNB * GB * ASTR;
  static constexpr int BT_BYTES = BW * BSTR;     // one slab tile
  static constexpr int STAGE = A_BYTES + NBT * BT_BYTES;
  static constexpr int BYTES = STAGES * STAGE;
};

// The small-batch form.  One tile: 16 gates x all NB output blocks K (warp
// K computes block K) x part u x coefficients [ct*32, ct*32+32) of each
// block, all L limbs, over the contraction k-tiles [t_lo, t_hi) of the
// split along blockIdx.z.  One slab tile in shared memory serves all NB
// blocks: the 3.9 MB step slab is read once per 16 gates.  bk is this
// step's K-contiguous slab [C][KT] (KT = RT, or 2RT on FAT2).
template <int L, int MODE>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ ext,  // [Gp, RT]
            const int8_t* __restrict__ bk,   // [C, KT] (this step)
            uint32_t* __restrict__ acc,      // [Gp, 2, N]
            int N, int RT, int KT, int seg, int shift, int split) {
  using SM = ConvSmem<L, MODE>;
  constexpr int NT = L * 4;  // n8 tiles: L limb strips x 32 columns
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int NB = N >> 7;
  const int ct = blockIdx.x & 3;
  const int u = blockIdx.x >> 2;
  const int g0 = blockIdx.y * GB;
  const int T = RT / BK;
  const int t_lo = (int)((int64_t)blockIdx.z * T / split);
  const int t_hi = (int)((int64_t)(blockIdx.z + 1) * T / split);
  const int ntiles = t_hi - t_lo;

  // k-tile t -> ring slot: A rows (K, gate) from the rotated digit
  // extension, B rows (the tile's L x 32 slab columns, each 64 contiguous
  // contraction bytes) from the K-contiguous slab
  auto issue = [&](int slot, int t) {
    int8_t* As = smem + slot * SM::STAGE;
    int8_t* Bs = As + SM::A_BYTES;
    const int r0 = t * BK;
    for (int q = tid; q < NB * GB * 4; q += THREADS) {
      const int row = q >> 2;
      const ConvTile c = conv_tile<MODE>(r0, row / GB, seg, shift, RT);
      cp_async16(As + row * ASTR + (q & 3) * 16,
                 ext + (size_t)(g0 + row % GB) * RT + c.acol + (q & 3) * 16);
    }
    constexpr int CHUNKS = SM::BW * 4;  // 16-byte pieces of one slab tile
    for (int q = tid; q < SM::NBT * CHUNKS; q += THREADS) {
      const int c = SM::NBT == 1 ? 0 : q / CHUNKS, qq = q - c * CHUNKS;
      const int col = qq >> 2, piece = qq & 3;
      // c = 1: the first copy (fat2's wrapped rows), else the plain rows
      const int kc = MODE == FAT2 ? (c ? r0 : RT + r0) : r0;
      cp_async16(Bs + c * SM::BT_BYTES + col * BSTR + piece * 16,
                 bk + (size_t)((u * L + col / CT) * 128 + ct * CT + col % CT)
                          * KT + kc + piece * 16);
    }
  };

  int cacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[nt][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) issue(s, t_lo + s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  const bool active = warp < NB;  // warp index = output block K
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();  // k-tile i has landed (this thread's part)
    __syncthreads();              // ... everyone's; slot i-1 is free
    if (i + STAGES - 1 < ntiles)
      issue((i + STAGES - 1) % STAGES, t_lo + i + STAGES - 1);
    cp_async_commit();
    if (active) {
      const int8_t* As = smem + (i % STAGES) * SM::STAGE;
      // wrapped rows enter with a minus sign: negate the digits (|d| <= 32
      // fits int8 either way); fat2 takes them from the first copy's tile
      const ConvTile c =
          conv_tile<MODE>((t_lo + i) * BK, warp, seg, shift, RT);
      const bool neg = MODE != FAT2 && c.wrap;
      const int8_t* Bw = As + SM::A_BYTES +
                         (MODE == FAT2 && c.wrap ? SM::BT_BYTES : 0);
      const int8_t* A = As + warp * GB * ASTR;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[4];
        a[0] = ld32(A + grp * ASTR + kk + tig * 4);
        a[1] = ld32(A + (grp + 8) * ASTR + kk + tig * 4);
        a[2] = ld32(A + grp * ASTR + kk + 16 + tig * 4);
        a[3] = ld32(A + (grp + 8) * ASTR + kk + 16 + tig * 4);
        if (neg) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = __vneg4(a[j]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int8_t* bp = Bw + (nt * 8 + grp) * BSTR + kk + tig * 4;
          mma_s8(cacc[nt], a, ld32(bp), ld32(bp + 16));
        }
      }
    }
  }
  if (!active) return;

  // limb recombination mod 2^32; tile n8 index nt = li*4 + q holds
  // coefficients q*8 + tig*2 + (e & 1) of limb strip li
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t v = 0;
#pragma unroll
      for (int li = 0; li < L; ++li)
        v += (uint32_t)cacc[li * 4 + q][e] << (8 * (4 - L + li));
      const int g = g0 + grp + (e >> 1) * 8;
      const int coef = warp * 128 + ct * CT + q * 8 + tig * 2 + (e & 1);
      uint32_t* dst = acc + ((size_t)g * 2 + u) * N + coef;
      if (split == 1)
        *dst += v;
      else
        atomicAdd(dst, v);
    }
}

// The wgmma form: one CTA = 128 gates [g0, g0+128) of output block K =
// blockIdx.z x part u x coefficients [64 cb, 64 cb + 64) of every limb (u =
// blockIdx.x / 2, cb = blockIdx.x % 2), N = L*64 tile columns ordered (limb,
// coefficient).  Gates from Gp on read as zeros (TMA) and are not written.
//   ext_map: ext [Gp][RT] in 128 x 128-byte boxes;
//   bk_map:  the whole K-contiguous slab [n_steps*C][KT] in 64-row boxes;
//            this step's rows start at crow0.
template <int L, int MODE>
__global__ void __launch_bounds__(wgs8::THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap ext_map,
                  const __grid_constant__ CUtensorMap bk_map,
                  uint32_t* __restrict__ acc, int Gp, int N, int RT, int seg,
                  int shift, int crow0) {
  constexpr int BN = L * 64;
  extern __shared__ uint8_t smem_raw[];
  const wgs8::Ring<BN> ring = wgs8::ring_init<BN>(smem_raw);
  const int K = blockIdx.z, g0 = blockIdx.y * wgs8::BM;
  const int u = blockIdx.x >> 1, cb = blockIdx.x & 1;
  const int T = RT / wgs8::BK;
  auto tile = [&](int q) {
    return conv_tile<MODE>(wrap_order(q, K, seg, shift, RT) * wgs8::BK, K,
                           seg, shift, RT);
  };

  if (threadIdx.x >= wgs8::CONSUMERS) {  // the producer warpgroup
    wgs8::producer_regs();
    if (threadIdx.x == wgs8::CONSUMERS)
      wgs8::produce(ring, T, wgs8::Ring<BN>::STAGE,
                    [&](int q, uint8_t* a, uint8_t* b, uint64_t* bar) {
                      const ConvTile c = tile(q);
                      wgs8::tma_load(a, &ext_map, c.acol, g0, bar);
#pragma unroll
                      for (int li = 0; li < L; ++li)
                        wgs8::tma_load(b + li * 64 * wgs8::BK, &bk_map, c.bk,
                                       crow0 + (u * L + li) * 128 + cb * 64,
                                       bar);
                    });
    return;
  }
  wgs8::consumer_regs();
  uint32_t d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  // the accumulator holds -(the sum so far) while neg: flipped on entering
  // and leaving the wrapped k-tiles
  bool neg = false;
  wgs8::consume<BN>(ring, T, d, [&](int q, uint32_t (&v)[BN / 2]) {
    const bool w = MODE != FAT2 && tile(q).wrap;
    if (w != neg) {
      wgs8::settle(v);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) v[i] = 0u - v[i];
      neg = w;
    }
  });
  if (neg) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0u - d[i];
  }

  // limb recombination: register 4*(li*8 + j) + e holds coefficient
  // 8j + 2*(lane%4) + (e&1) of limb li
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = g0 + wgs8::acc_row(2 * h);
      if (g >= Gp) continue;
      uint32_t v0 = 0, v1 = 0;
#pragma unroll
      for (int li = 0; li < L; ++li) {
        v0 += d[4 * (li * 8 + j) + 2 * h] << (8 * (4 - L + li));
        v1 += d[4 * (li * 8 + j) + 2 * h + 1] << (8 * (4 - L + li));
      }
      const int coef = K * 128 + cb * 64 + wgs8::acc_col(4 * j);
      uint2* dst = reinterpret_cast<uint2*>(acc + ((size_t)g * 2 + u) * N +
                                            coef);
      uint2 cur = *dst;
      cur.x += v0;
      cur.y += v1;
      *dst = cur;
    }
}

// All n_steps steps on `st`, in the given form (wgmma: the conv_wgmma_kernel
// instance of (L, MODE); else conv_kernel's, split `split` ways): the
// kernel's dynamic shared memory (> 48 KB must be opted into) and, for
// wgmma, the tensor maps are set once, then digits_kernel and the product
// alternate.  RR = M*(l+lb).
template <int L, int MODE>
int run_steps(const int32_t* rows, uint32_t* acc, const int8_t* bk,
              int8_t* ext, int Gp, int n_steps, int N, int l, int lb,
              int Bgbit, int M, int split, bool wgmma, uint32_t off_a,
              uint32_t off_b, cudaStream_t st) {
  constexpr int BN = L * 64;
  using SM = ConvSmem<L, MODE>;
  const int smem = wgmma ? wgs8::Ring<BN>::BYTES : SM::BYTES;
  cudaError_t e =
      wgmma ? cudaFuncSetAttribute(conv_wgmma_kernel<L, MODE>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem)
            : cudaFuncSetAttribute(conv_kernel<L, MODE>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
  if (e != cudaSuccess) return (int)e;
  const int RR = M * (l + lb);
  const int RT = RR * N;
  const int C = 2 * L * 128;
  // fat2: a step is 2*RT contraction bytes, the first copy (wrapped rows)
  // then the second (the others)
  const int KT = MODE == FAT2 ? 2 * RT : RT;
  const int seg = MODE == THIN ? N : RT, shift = MODE == THIN ? 128 : RR * 128;
  CUtensorMap ext_map, bk_map;
  if (wgmma) {
    int rc = wgs8::encode_2d(&ext_map, ext, RT, Gp, RT, wgs8::BM);
    if (rc == 0)
      rc = wgs8::encode_2d(&bk_map, bk, KT, (uint64_t)n_steps * C, KT, 64);
    if (rc != 0) return rc;
  }
  const dim3 grid(2 * 4, Gp / GB, split);
  const dim3 wgrid(4, (Gp + wgs8::BM - 1) / wgs8::BM, N / 128);
  const int dblocks = (int)(((int64_t)Gp * N + 255) / 256);
  for (int i = 0; i < n_steps; ++i) {
    const int32_t* rot = rows + (size_t)i * M * Gp;
    if (M == 3)  // the 2-bit-unrolled slab (fat)
      digits_kernel<3, false><<<dblocks, 256, 0, st>>>(
          rot, acc, ext, Gp, N, l, lb, Bgbit, off_a, off_b);
    else
      digits_kernel<1, MODE == THIN><<<dblocks, 256, 0, st>>>(
          rot, acc, ext, Gp, N, l, lb, Bgbit, off_a, off_b);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (wgmma)
      conv_wgmma_kernel<L, MODE><<<wgrid, wgs8::THREADS, smem, st>>>(
          ext_map, bk_map, acc, Gp, N, RT, seg, shift, i * C);
    else
      conv_kernel<L, MODE><<<grid, THREADS, smem, st>>>(
          ext, bk + (size_t)i * C * KT, acc, N, RT, KT, seg, shift, split);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

using RunSteps = int (*)(const int32_t*, uint32_t*, const int8_t*, int8_t*,
                         int, int, int, int, int, int, int, int, bool,
                         uint32_t, uint32_t, cudaStream_t);

}  // namespace

// All n_steps CMUX steps of a blind rotation, launched on `stream`.
//   rows  int32 [n_steps*M, Gp]  rotation amounts in [0, 2N), the M of
//                                step i at rows M*i..
//   acc   uint32 [Gp, 2, N]      accumulator, updated in place
//   bk    int8 slab of `layout`, stored K-contiguous: FAT [n_steps, C, RT]
//         (M = 1, or M = 3 for the 2-bit-unrolled slab), THIN
//         [n_steps, C, l+lb, N] (the same bytes as FAT's), FAT2
//         [n_steps, C, 2*RT]; RT = M*(l+lb)*N, C = 2*L*128
//   ext   int8 [Gp, RT]          scratch
// form 1: the wgmma form (any Gp; the caller takes it from 128 gates on);
// form 0: conv_kernel with the contraction split `split` ways.  Gp must
// be a multiple of 16, N a power of two from 128 to 1024; split in
// [1, RT/64].  Returns 0 or the first CUDA error.
extern "C" int tkey_blind_rotate(const void* rows, void* acc, const void* bk,
                                 void* ext, int Gp, int n_steps, int N, int l,
                                 int lb, int Bgbit, int L, int M, int layout,
                                 int split, int form, uint32_t off_a,
                                 uint32_t off_b, int device, void* stream) {
  static const RunSteps run[2][3] = {
      {run_steps<3, FAT>, run_steps<3, THIN>, run_steps<3, FAT2>},
      {run_steps<4, FAT>, run_steps<4, THIN>, run_steps<4, FAT2>}};
  const int RR = M * (l + lb);  // digit rows a step
  if (Gp <= 0 || Gp % GB || N < 128 || N > 128 * MAXNB || (N & (N - 1)) ||
      (L != 3 && L != 4) || (M != 1 && M != 3) || layout < FAT ||
      layout > FAT2 || (M == 3 && layout != FAT) || split < 1 ||
      split > RR * N / BK || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return run[L - 3][layout](
      static_cast<const int32_t*>(rows), static_cast<uint32_t*>(acc),
      static_cast<const int8_t*>(bk), static_cast<int8_t*>(ext), Gp, n_steps,
      N, l, lb, Bgbit, M, split, form == 1, off_a, off_b,
      reinterpret_cast<cudaStream_t>(stream));
}

// The persistent form's plan on `device` at N, l, lb, L: out[0..7] = CW
// (coefficients a column tile), clusters, CTAs a cluster (NB), threads a
// CTA, dynamic shared memory a CTA, slab ring slots, clusters of it the
// card holds at once, GT (gates a tile).  0 or a CUDA error.
extern "C" int tkey_loop_plan(int device, int N, int l, int lb, int L,
                              int* out) {
  if (N < 128 || N > 128 * MAXNB || (N & (N - 1)) || (L != 3 && L != 4) ||
      lb < 1 || lb > l)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return L == 3 ? tkloop::query<3>(device, N >> 7, l + lb, out)
                : tkloop::query<4>(device, N >> 7, l + lb, out);
}

// All n_steps CMUX steps of a blind rotation in one launch (the persistent
// form, tkey_loop.cuh), on `stream`; arguments as tkey_blind_rotate's, plus
//   scratch uint32 [Gp, 2, N]  the accumulator's other buffer
//   stage   int8, stage_size bytes: the exchange of the digit rows and the
//           partials, then the grid barrier's word (tkey_loop.cuh:
//           stage_bytes)
// and layout FAT or THIN at M = 1; FAT2 and the unrolled slab (M = 3) are
// refused (cudaErrorNotSupported).  acc ends with the final state.
// used[0..7]: the plan launched (tkey_loop_plan's out).  Returns 0 or the
// first CUDA error; a card that cannot hold the grid at once refuses
// (cudaErrorCooperativeLaunchTooLarge).
extern "C" int tkey_loop_rotate(const void* rows, void* acc, void* scratch,
                                void* stage, size_t stage_size,
                                const void* bk, int Gp, int n_steps, int N,
                                int l, int lb, int Bgbit, int L, int M,
                                int layout, uint32_t off_a, uint32_t off_b,
                                int device, void* stream, int* used) {
  if (Gp <= 0 || Gp % GB || n_steps <= 0 || N < 128 ||
      N > 128 * MAXNB || (N & (N - 1)) || (L != 3 && L != 4) ||
      (M != 1 && M != 3) || lb < 1 || lb > l || layout < FAT ||
      layout > FAT2 || (M == 3 && layout != FAT))
    return (int)cudaErrorInvalidValue;
  if (layout == FAT2 || M != 1) return (int)cudaErrorNotSupported;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  uint32_t* a = static_cast<uint32_t*>(acc);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  uint8_t* sg = static_cast<uint8_t*>(stage);
  const int8_t* b = static_cast<const int8_t*>(bk);
  const bool thin = layout == THIN;
  return L == 3 ? tkloop::run<3>(r, a, sc, sg, stage_size, b, Gp, n_steps, N,
                                 l, lb, Bgbit, thin, off_a, off_b, device, st,
                                 used)
                : tkloop::run<4>(r, a, sc, sg, stage_size, b, Gp, n_steps, N,
                                 l, lb, Bgbit, thin, off_a, off_b, device, st,
                                 used);
}

extern "C" const char* tkey_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
