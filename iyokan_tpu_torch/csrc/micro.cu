// Microbenchmark kernels for Hopper (sm_90a): the in-kernel loops of the
// JAX package's tools, which measured the TPU's int8 and vector ceilings at
// the tkey blind rotation's product shapes.
//
// Replaces the Pallas kernels of
//   tools/tk_mm_bench.py     kern_fat, kern_thin, kern_pure, kern_puret
//                            (mm_step_kernel, TILE and ACC modes)
//   tools/tk_width_bench.py  main.make.kern (mm_step_kernel, ACC)
//   tools/microbench.py      mm_int8_pallas_case.kern, pk_mm_case.kern,
//                            pk_bdot_case.kern (mm_step_kernel, MM),
//                            pk_smallk_case.kern (smallk_kernel),
//                            _pallas_loop_case.make.kern with the bodies
//                            pk_vpu, pk_f32, pk_barrett, pk_i16, pk_i32var,
//                            pk_conv, pk_select (alu_kernel) and pk_roll
//                            (roll_kernel).
//
// Three designs:
//
// 1. mm_step_kernel<MODE, BN>: a looped int8 product.  A step reads
//    `nwin` LHS windows against one right-hand side, in `nouter` passes:
//      P_w[r, n] = sum_{o < nouter} sum_{k < seglen}
//                  L[r, doff + w*wstride + o*ostride + k] * B[k, n]
//    (B = rhs [seglen, NO], or rhs^T for BT: rhs stored [NO, seglen]).
//    The epilogue of MODE reads them:
//      TILE  one dot a window (kern_fat: 8 windows 768 apart, one pass;
//            kern_thin: 8 windows 128 apart, a pass per j-row):
//            w_d = (P_d[:, :128] + P_d[:, 128:256]) & 31, and the next
//            L[r, c] = w_{(c / 128) mod nwin}[r, c mod 128] (the tools'
//            ((c mod wrap) / 128) mod nwin for their wraps 12288 and 2048,
//            multiples of 128 nwin);
//      ACC   one dot, the sum of the windows S = sum_w P_w (kern_pure /
//            kern_puret: the 8 windows 768 apart; the width sweep: ndots
//            windows 128 apart): acc[:, :accw] += S[:, :accw] (wrapping
//            int32, in global memory), and at the step's end L[:, :128] =
//            the low byte of acc[:, :128] (accw = 768 pure, 128 width);
//      MM    one window: L' = (P & mask) as int8 (mmp, pk_mm; pk_bdot with
//            a batch per blockIdx.z).
//    Columns the tool never reads (TILE: 256..767, ACC: accw..NO-1) are
//    still computed and summed into a per-row uint32 checksum `chk`, so the
//    compiler cannot drop their products and the rate counts every product
//    the tool counts.
//    What bounds it: the int8 products (2 ops a MAC at 1979 TOP/s) at large
//    batches.  The design: the shared Hopper mainloop of wgmma_s8.cuh (TMA,
//    an mbarrier ring, two consumer warpgroups on wgmma m64nNk32 s8) on
//    128-row x BN-column tiles of each step, so every shape covers the SMs
//    (ops/micro.py:step_plan picks BN and the split):
//      - the steps depend on each other only row by row, so a step
//        boundary is a launch boundary: one launch a step on the stream
//        (a cooperative grid barrier would hold every CTA resident and
//        give the split nothing), the next LHS written to the other of two
//        buffers (TILE, MM) or, after the step, in place by acc_low_bytes
//        (ACC, whose split sums land by atomics first);
//      - TILE's windows are separate outputs: stacked M rows; ACC's all
//        multiply B, so their sum is one longer contraction (windows x
//        passes x seglen) in one accumulator, split across CTAs where the
//        tiles alone are too few (exact int32 atomics);
//      - B must be K-major for wgmma: a BT rhs (puret) is used as it is; a
//        row-major one is transposed once per call into a scratch [NO,
//        seglen] by rhs_kmajor (its time is part of the call), TILE's
//        first 256 columns reordered so a 128-column tile holds columns c
//        and c + 128 in one thread's registers for w_d.
//    pure vs puret now measures only that transpose.
//
// 2. smallk_kernel<GR, TW>: a <- (W @ a & mask) as int8, W [8, 8] (pk_smallk),
//    on the tensor cores.  Each column of a is its own chain, so the rounds
//    stay in registers: a warp holds TW tiles of 16 rows x GR groups of 8
//    bytes, a row packing GR columns of a (k = 8 group + component), as the
//    A fragment of mma.sync m16n8k(8 GR).s8, and B is the block diagonal of
//    GR copies of W^T, so n-tile nt of the product is W times group nt of
//    every row (GR x the real MACs).  The C fragment (rows g, g + 8,
//    columns 8 nt + 2q + e; g = lane / 4, q = lane % 4, from the PTX ISA's
//    tables) and the A fragment (the same rows, k = 16 s + 4q + b) hold the
//    same rows in each thread, 2 GR values a row, so a fixed bijection pi
//    between their columns takes C back to A with no shuffle: value (nt, e)
//    of a row goes to byte b = 2 (nt % 2) + e of register s = nt / 2.  A
//    column k therefore holds group 2 s + b / 2, component 2q + b % 2, and
//    B's rows are permuted to match.  A round is GR mma a tile, then 3 PRMT
//    (the low bytes) and one LOP3 (the mask in every byte) for each 4
//    results: the low byte of z & mask is what .astype(int8) keeps, for
//    every mask.  What bounds it: the packing, one ALU-pipe instruction a
//    result byte (0.188 us a round at pk_smallk's 393,216 columns), and the
//    mma, whose time adds to it rather than hiding under it on the H100
//    (tools/micro_forms.json: GR = 2, m16n8k16, twice the real MACs, beats
//    GR = 4, m16n8k32, by the difference in tensor work; two tiles a warp
//    beat one and four).  ptxas -v (sm_90a), <2, 2>: 37 registers, no
//    spills; 128 threads a CTA, 12 CTAs an SM, so pk_smallk's 6144 warps
//    are all resident at once.
//
// 3. alu_kernel<BODY> and roll_kernel: INNER rounds of a body on operands
//    held in registers (the TPU kept them in VMEM).  The bodies' constants
//    arrive as kernel arguments, so nvcc cannot fold five multiply-adds into
//    one or strength-reduce a multiply; the smoke run prints each loop's
//    SASS opcodes to read the rate against the instructions issued.  f32
//    multiply-adds are __fmaf_rn, one a step in order (the JAX CPU result
//    fuses them); Barrett's float round is round half to even (as
//    jnp.round), by adding 1.5 * 2^23 (exact for |x / p| < 2^22, which
//    micro_alu holds 1/p to).  What bounds them is issue: a thread holds
//    ALU_E = 16 bytes of elements (4 words, or 8 int16 in 32-bit registers:
//    only their low 16 bits are stored), independent chains, loaded and
//    stored 16 bytes at a time, the rounds unrolled by ALU_U with the
//    remainder after, over a grid-stride loop of as many CTAs as the card
//    holds.  select's step is a compare and a predicated add (2
//    instructions, one on the integer ALU pipe, the other free to issue as
//    IMAD), not a compare, an add and a select.  ptxas -v: 16-25 registers
//    (roll_kernel 32), no spills, so 2048 threads an SM.
//    pk_roll's lane rotation (pltpu.roll by 128 of 1024 lanes) is a renaming
//    of registers: a thread holds words t + 128 j (j < 8) of a row, so a
//    round moves nothing: register j holds logical slot (j + k) mod 8 after
//    k rounds, the per-slot constant c = 1 - 2m (r + m (0 - 2r) = r c mod
//    2^32) rotates with it, and a round is one IMAD a word.  The rounds run
//    8 at a time (the renaming's period), the rest through an unrolled
//    guarded block, and the store puts register j at its slot.  No shared
//    memory and no barrier; the shift is fixed at compile time (ROLL_SHIFT).
//
// Built by iyokan_tpu_torch/ops/micro.py through ops/nvcc.py (plain C
// interface, ctypes).

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_s8.cuh"

namespace {

enum Mode { TILE = 0, ACC = 1, MM = 2 };

struct StepArgs {
  int8_t* lnext;        // TILE, MM: the next LHS buffer
  int32_t* acc;         // ACC: [rows][accw]
  uint32_t* chk;        // [batches][rows]
  int rows, lstride, NO, seglen, nwin, wstride, nouter, ostride, doff;
  int accw, mask;
  int m_tiles;          // 128-row tiles of the rows (a window's on TILE)
  int n_tiles, split;   // BN-column tiles; CTAs splitting the contraction
};

// One step, one CTA: rows [r0, r0+128) of window w_m (TILE) or of the
// rows (ACC, MM) of batch blockIdx.z, columns [nt*BN, nt*BN + BN) (TILE:
// of the permuted scratch), k-tiles [q0, q1) of the step's sum.
//   lmap: the current LHS [batches*rows][lstride], 128-row boxes;
//   bmap: B K-major [batches*NO][seglen], BN-row boxes.
template <int MODE, int BN>
__global__ void __launch_bounds__(wgs8::THREADS, 1)
mm_step_kernel(const __grid_constant__ CUtensorMap lmap,
               const __grid_constant__ CUtensorMap bmap, StepArgs g) {
  extern __shared__ uint8_t smem_raw[];
  const wgs8::Ring<BN> ring = wgs8::ring_init<BN>(smem_raw);
  const int nt = blockIdx.x % g.n_tiles, sp = blockIdx.x / g.n_tiles;
  const int b = blockIdx.z;
  const int w_m = MODE == TILE ? blockIdx.y / g.m_tiles : 0;
  const int r0 = (MODE == TILE ? blockIdx.y % g.m_tiles : blockIdx.y) *
                 wgs8::BM;
  const int T = g.seglen / wgs8::BK;
  const int Q = (MODE == ACC ? g.nwin : 1) * g.nouter * T;
  const int q0 = (int)((long long)Q * sp / g.split);
  const int q1 = (int)((long long)Q * (sp + 1) / g.split);

  if (threadIdx.x >= wgs8::CONSUMERS) {  // the producer warpgroup
    wgs8::producer_regs();
    if (threadIdx.x == wgs8::CONSUMERS)
      wgs8::produce(ring, q1 - q0, wgs8::Ring<BN>::STAGE,
                    [&](int q, uint8_t* a, uint8_t* bt, uint64_t* bar) {
                      q += q0;
                      const int kk = (q % T) * wgs8::BK;
                      const int o = (q / T) % g.nouter;
                      const int w = MODE == ACC ? q / (T * g.nouter) : w_m;
                      wgs8::tma_load(a, &lmap,
                                     g.doff + w * g.wstride + o * g.ostride +
                                         kk,
                                     b * g.rows + r0, bar);
                      wgs8::tma_load(bt, &bmap, kk, b * g.NO + nt * BN, bar);
                    });
    return;
  }
  wgs8::consumer_regs();
  uint32_t d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  wgs8::consume<BN>(ring, q1 - q0, d, [](int, uint32_t (&)[BN / 2]) {});

  const int lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * g.rows + r0;   // the tile's first row
  uint32_t dead[2] = {0, 0};   // unread columns of rows acc_row(0), +8
  bool has_dead = false;
  if constexpr (MODE == TILE) {
    if (nt < 2) {
      // w = (P[:, c] + P[:, c + 128]) & 31 for c = 64 nt + (0..63): tile
      // columns 8j.. and 64 + 8j.. (j < 8; the scratch's order), staged in
      // shared memory as [128 rows][64 bytes] (the ring is drained)
      uint8_t* W = ring.a(0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          W[wgs8::acc_row(e) * 64 + wgs8::acc_col(4 * j + e)] =
              (uint8_t)((d[4 * j + e] + d[4 * (j + 8) + e]) & 31);
      wgs8::consumers_sync();
      // block p of 128 columns of the next LHS takes window p mod nwin: the
      // copies of this window's 64 columns, 16 bytes a thread
      const int ncopy = g.lstride / (128 * g.nwin);
      for (int q = threadIdx.x; q < wgs8::BM * ncopy * 4;
           q += wgs8::CONSUMERS) {
        const int row = q / (ncopy * 4), cpy = (q >> 2) % ncopy, ch = q & 3;
        if (r0 + row >= g.rows) continue;
        const int col = (w_m + g.nwin * cpy) * 128 + nt * 64 + ch * 16;
        *reinterpret_cast<uint4*>(g.lnext + (row0 + row) * g.lstride + col) =
            *reinterpret_cast<const uint4*>(W + row * 64 + ch * 16);
      }
    } else {  // columns 256..767: only the checksum
      has_dead = true;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dead[(i >> 1) & 1] += d[i];
    }
  } else if constexpr (MODE == ACC) {
    has_dead = (nt + 1) * BN > g.accw;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = nt * BN + wgs8::acc_col(i);
      const int r = r0 + wgs8::acc_row(i);
      if (col >= g.accw)
        dead[(i >> 1) & 1] += d[i];
      else if (r < g.rows)
        atomicAdd(g.acc + (size_t)r * g.accw + col, (int)d[i]);
    }
  } else {   // MM: the next LHS, two adjacent bytes a register pair
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = r0 + wgs8::acc_row(i);
      if (r >= g.rows) continue;
      const uint32_t m = (uint32_t)g.mask;
      *reinterpret_cast<uint16_t*>(g.lnext + ((size_t)b * g.rows + r) *
                                                 g.lstride +
                                   nt * BN + wgs8::acc_col(i)) =
          (uint16_t)((d[i] & m) | (d[i + 1] & m) << 8);
    }
  }
  if (has_dead) {
    // the four threads of a row group, then one atomic a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dead[h] += __shfl_xor_sync(0xffffffffu, dead[h], 1);
      dead[h] += __shfl_xor_sync(0xffffffffu, dead[h], 2);
      const int r = r0 + wgs8::acc_row(2 * h);
      if ((lane & 3) == 0 && r < g.rows)
        atomicAdd(g.chk + (size_t)b * g.rows + r, dead[h]);
    }
  }
}

// rhs [batches][seglen][NO] -> bt [batches][NO][seglen] (K-major), 64 x 64
// byte tiles through shared memory.  tile_pairs (TILE): column c < 256
// goes to row 128 ((c mod 128) / 64) + 64 (c / 128) + c mod 64, so scratch
// rows [128t, 128t + 128) hold columns 64t.. and 128 + 64t.. (t = 0, 1).
__global__ void __launch_bounds__(256)
rhs_kmajor(const int8_t* __restrict__ rhs, int8_t* __restrict__ bt,
           int seglen, int NO, int tile_pairs) {
  __shared__ uint8_t t[64][65];
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int8_t* src = rhs + (size_t)blockIdx.z * seglen * NO;
  int8_t* dst = bt + (size_t)blockIdx.z * NO * seglen;
  const int r = threadIdx.x >> 2, p = (threadIdx.x & 3) * 16;
  const uint4 v =
      *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * NO + n0 + p);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 16; ++j) t[r][p + j] = vb[j];
  __syncthreads();
  uint4 o;
  uint8_t* ob = reinterpret_cast<uint8_t*>(&o);
#pragma unroll
  for (int j = 0; j < 16; ++j) ob[j] = t[p + j][r];   // column n0 + r
  const int c = n0 + r;
  const int row = tile_pairs && c < 256
                      ? ((c & 127) >> 6) * 128 + (c >> 7) * 64 + (c & 63)
                      : c;
  *reinterpret_cast<uint4*>(dst + (size_t)row * seglen + k0 + p) = o;
}

// ACC, after a step: L[r, :128] = the low byte of acc[r, :128]
__global__ void acc_low_bytes(const int32_t* __restrict__ acc,
                              int8_t* __restrict__ lhs, int rows, int accw,
                              int lstride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * 128) return;
  lhs[(size_t)(i >> 7) * lstride + (i & 127)] =
      (int8_t)acc[(size_t)(i >> 7) * accw + (i & 127)];
}

template <int MODE, int BN>
int launch_steps(const StepArgs& a, const CUtensorMap (&lmaps)[2],
                 const CUtensorMap& bmap, int8_t* (&bufs)[2], int batches,
                 int steps, cudaStream_t st) {
  constexpr int smem = wgs8::Ring<BN>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      mm_step_kernel<MODE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.n_tiles * a.split,
                  a.m_tiles * (MODE == TILE ? a.nwin : 1), batches);
  for (int s = 0; s < steps; ++s) {
    StepArgs g = a;
    const int cur = MODE == ACC ? 0 : s & 1;
    g.lnext = bufs[cur ^ 1];
    mm_step_kernel<MODE, BN><<<grid, wgs8::THREADS, smem, st>>>(
        lmaps[cur], bmap, g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (MODE == ACC) {
      acc_low_bytes<<<(a.rows * 128 + 255) / 256, 256, 0, st>>>(
          a.acc, bufs[0], a.rows, a.accw, a.lstride);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// small-K product on mma.sync: a <- (W @ a & mask), W [8, 8], a [8, Y]
// ---------------------------------------------------------------------------

constexpr int SK_GR = 2;        // groups (columns of a) a fragment row
constexpr int SK_TW = 2;        // 16-row tiles a warp
constexpr int SK_THREADS = 128;

// d = A B over one n-tile: A the GR registers of a 16 x 8GR s8 fragment,
// B the GR/2 registers of an 8GR x 8 one
template <int GR>
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[GR],
                                       const uint32_t* b) {
  if constexpr (GR == 4)
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(0));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%7, %7, %7, %7};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(0));
}

// the low bytes of four int32 sums, in order, as one register
__device__ __forceinline__ uint32_t low_bytes(int c0, int c1, int c2,
                                              int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

// the column of a in byte b of A register r of the warp's tile t, in lane
// group g (its component: 2q + b % 2)
template <int GR, int TW>
__device__ __forceinline__ long long smallk_col(long long warp, int t, int r,
                                                int b, int g) {
  return (warp * TW + t) * 16 * GR + 16 * (2 * (r >> 1) + (b >> 1)) + g +
         8 * (r & 1);
}

// Warp w owns tiles TW w .. TW w + TW - 1; tile t holds columns y = 16 GR t
// + 16 group + row.  Byte b of A register r of lane (g, q) is row g + 8 (r %
// 2), group 2 (r / 2) + b / 2, component 2q + b % 2; B register s of n-tile
// nt holds W[g][2q + b % 2] where group 2s + b / 2 is nt, else 0.
template <int GR, int TW>
__global__ void __launch_bounds__(SK_THREADS)
smallk_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ a,
              int8_t* __restrict__ out, int Y, int inner, uint32_t mask4) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const long long warp =
      ((long long)blockIdx.x * SK_THREADS + threadIdx.x) >> 5;
  uint32_t bf[GR][GR / 2];
#pragma unroll
  for (int nt = 0; nt < GR; ++nt)
#pragma unroll
    for (int s = 0; s < GR / 2; ++s) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (2 * s + b / 2 == nt)
          v |= (uint32_t)(uint8_t)w[8 * g + 2 * q + (b & 1)] << (8 * b);
      bf[nt][s] = v;
    }
  uint32_t af[TW][GR];
#pragma unroll
  for (int t = 0; t < TW; ++t)
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long y = smallk_col<GR, TW>(warp, t, r, b, g);
        if (y < Y)
          v |= (uint32_t)(uint8_t)a[(size_t)(2 * q + (b & 1)) * Y + y]
               << (8 * b);
      }
      af[t][r] = v;
    }
#pragma unroll 2
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int t = 0; t < TW; ++t) {
      int c[GR][4];
#pragma unroll
      for (int nt = 0; nt < GR; ++nt) mma_s8<GR>(c[nt], af[t], bf[nt]);
#pragma unroll
      for (int s = 0; s < GR / 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          af[t][2 * s + h] = low_bytes(c[2 * s][2 * h], c[2 * s][2 * h + 1],
                                       c[2 * s + 1][2 * h],
                                       c[2 * s + 1][2 * h + 1]) &
                             mask4;
    }
  }
#pragma unroll
  for (int t = 0; t < TW; ++t)
#pragma unroll
    for (int r = 0; r < GR; ++r)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long y = smallk_col<GR, TW>(warp, t, r, b, g);
        if (y < Y)
          out[(size_t)(2 * q + (b & 1)) * Y + y] =
              (int8_t)(af[t][r] >> (8 * b));
      }
}

// ---------------------------------------------------------------------------
// elementwise loops
// ---------------------------------------------------------------------------

// the bodies' constants, passed at run time (see the header)
struct AluConsts {
  int i_mul, i_add, i_mask, i_p, i_off;   // integer bodies
  float f_mul, f_add, f_max, f_inv_p;     // f32 and the float round
};

enum Body { VPU = 0, F32 = 1, BARRETT = 2, I16 = 3, I32VAR = 4, CONV = 5,
            SELECT = 6 };

constexpr int ALU_U = 4;          // rounds an unrolled iteration
constexpr int ALU_THREADS = 256;

// T: the stored element; R: its register (integer bodies compute in 32-bit
// words: i16 keeps the low 16 bits, which its products mod 2^16 depend on)
template <int BODY>
struct Elem { using T = int32_t; using R = uint32_t; };
template <> struct Elem<F32> { using T = float; using R = float; };
template <> struct Elem<I16> { using T = int16_t; using R = uint32_t; };

template <int BODY>
constexpr int ALU_E = 16 / (int)sizeof(typename Elem<BODY>::T);

// x = x > c ? x + a : x as a compare and a predicated add
__device__ __forceinline__ uint32_t add_if_above(uint32_t x, uint32_t c,
                                                 uint32_t a) {
  asm("{\n\t.reg .pred p;\n\tsetp.gt.u32 p, %0, %1;\n\t"
      "@p add.u32 %0, %0, %2;\n\t}"
      : "+r"(x) : "r"(c), "r"(a));
  return x;
}

// round half to even of |f| < 2^22, as jnp.round: the float sum f + 1.5 *
// 2^23 has a unit last place, so its rounding is the round, and its low
// mantissa bits are the integer (an FADD and an integer add, where F2I
// runs on the 16-lane conversion unit)
__device__ __forceinline__ int round_f32(float f) {
  return (int)(__float_as_uint(__fadd_rn(f, 12582912.0f)) - 0x4B400000u);
}

// one round of a body
template <int BODY>
__device__ __forceinline__ typename Elem<BODY>::R body(
    typename Elem<BODY>::R x, uint32_t y, const AluConsts& k) {
  const uint32_t mul = k.i_mul, add = k.i_add, msk = k.i_mask;
  if constexpr (BODY == VPU) {          // 5 x (x * 3 + 1), & 0xFFFFF
#pragma unroll
    for (int i = 0; i < 5; ++i) x = x * mul + add;
    return x & msk;
  } else if constexpr (BODY == F32) {   // 5 x fma(x, 1.0001, 0.5), min 1e6
#pragma unroll
    for (int i = 0; i < 5; ++i) x = __fmaf_rn(x, k.f_mul, k.f_add);
    return fminf(x, k.f_max);
  } else if constexpr (BODY == BARRETT) {  // x - round(x/p)*p + 2^21
    const int q = round_f32(__fmul_rn(__int2float_rn((int32_t)x), k.f_inv_p));
    return x - (uint32_t)q * (uint32_t)k.i_p + (uint32_t)k.i_off;
  } else if constexpr (BODY == I16) {   // 5 x (x * 12289 + 1) mod 2^16
#pragma unroll
    for (int i = 0; i < 5; ++i) x = x * mul + add;
    return x;
  } else if constexpr (BODY == I32VAR) {  // 5 x ((x * y + 1) & 0xFFFFF)
#pragma unroll
    for (int i = 0; i < 5; ++i) x = (x * y + add) & msk;
    return x;
  } else if constexpr (BODY == CONV) {  // x - round(x/p) + 7
    const int q = round_f32(__fmul_rn(__int2float_rn((int32_t)x), k.f_inv_p));
    return x - (uint32_t)q + (uint32_t)k.i_off;
  } else {                              // 5 x (x > 5 ? x + 1 : x), unsigned
#pragma unroll
    for (int i = 0; i < 5; ++i) x = add_if_above(x, msk, add);
    return x;
  }
}

// 16 bytes of elements <-> ALU_E registers
template <int BODY>
__device__ __forceinline__ void unpack16(uint4 u,
                                         typename Elem<BODY>::R* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (BODY == I16) {
      v[2 * j] = w[j] & 0xFFFFu;
      v[2 * j + 1] = w[j] >> 16;
    } else if constexpr (BODY == F32) {
      v[j] = __uint_as_float(w[j]);
    } else {
      v[j] = w[j];
    }
  }
}

template <int BODY>
__device__ __forceinline__ uint4 pack16(const typename Elem<BODY>::R* v) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (BODY == I16)
      w[j] = __byte_perm(v[2 * j], v[2 * j + 1], 0x5410);
    else if constexpr (BODY == F32)
      w[j] = __float_as_uint(v[j]);
    else
      w[j] = v[j];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// nvec vectors of ALU_E elements (16 bytes); y (I32VAR) likewise, as words
template <int BODY>
__global__ void __launch_bounds__(ALU_THREADS)
alu_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
           uint4* __restrict__ out, long long nvec, int inner, AluConsts k) {
  constexpr int E = ALU_E<BODY>;
  using R = typename Elem<BODY>::R;
  for (long long i = (long long)blockIdx.x * ALU_THREADS + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * ALU_THREADS) {
    R v[E];
    uint32_t yv[E];
    unpack16<BODY>(x[i], v);
    if constexpr (BODY == I32VAR) {
      const uint4 u = y[i];
      yv[0] = u.x; yv[1] = u.y; yv[2] = u.z; yv[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) yv[e] = 0;
    }
    int it = 0;
#pragma unroll 1
    for (; it + ALU_U <= inner; it += ALU_U)
#pragma unroll
      for (int u = 0; u < ALU_U; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = body<BODY>(v[e], yv[e], k);
#pragma unroll 1
    for (; it < inner; ++it)
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = body<BODY>(v[e], yv[e], k);
    out[i] = pack16<BODY>(v);
  }
}

// pk_roll: rows of 1024 u32 words; per round r = roll(x, 128) (r[i] =
// x[(i - 128) mod 1024]), r += m * (0 - 2r) (mod 2^32), r += 1.  Thread t
// of a row holds words t + ROLL_SHIFT j in register j (header).
constexpr int ROLL_N = 1024;
constexpr int ROLL_SHIFT = 128;
constexpr int ROLL_SLOTS = ROLL_N / ROLL_SHIFT;   // the renaming's period
constexpr int ROLL_THREADS = 256;

__global__ void __launch_bounds__(ROLL_THREADS)
roll_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ m,
            uint32_t* __restrict__ out, int rows, int inner, uint32_t add) {
  constexpr int S = ROLL_SLOTS;
  const long long gt = (long long)blockIdx.x * ROLL_THREADS + threadIdx.x;
  const long long row = gt / ROLL_SHIFT;
  const int t = (int)(gt % ROLL_SHIFT);
  if (row >= rows) return;
  const uint32_t* xr = x + row * ROLL_N + t;
  uint32_t v[S], c[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    v[j] = xr[ROLL_SHIFT * j];
    c[j] = 1u - 2u * m[t + ROLL_SHIFT * j];
  }
  // before round k, register j holds slot (j + k) mod S; the round makes it
  // the word of slot (j + k + 1) mod S, whose constant it takes
  int it = 0;
#pragma unroll 1
  for (; it + S <= inner; it += S)
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = v[j] * c[(j + r + 1) % S] + add;
  const int rem = inner - it;
#pragma unroll
  for (int r = 0; r < S - 1; ++r)
    if (r < rem)
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = v[j] * c[(j + r + 1) % S] + add;
  uint32_t* o = out + row * ROLL_N + t;
#pragma unroll
  for (int j = 0; j < S; ++j) o[ROLL_SHIFT * ((j + inner) % S)] = v[j];
}

template <int BODY>
int launch_alu(const void* x, const void* y, void* out, long long n,
               int inner, const AluConsts& k, cudaStream_t st) {
  static int resident = 0;   // CTAs the card holds at once
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, alu_kernel<BODY>, ALU_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm;
  }
  const long long nvec = n / ALU_E<BODY>;
  const long long need = (nvec + ALU_THREADS - 1) / ALU_THREADS;
  const int blocks = (int)(need < resident ? need : resident);
  alu_kernel<BODY><<<blocks, ALU_THREADS, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(y),
      static_cast<uint4*>(out), nvec, inner, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The looped product (module header): `steps` launches of mm_step_kernel
// (ACC: each followed by acc_low_bytes), after one rhs_kmajor unless bt.
// mode: 0 TILE, 1 ACC, 2 MM; bt: rhs stored [NO, seglen] (ACC only).
//   lhs      [batches][rows][lstride]; ACC: updated in place; TILE, MM:
//            with lhs2 the two LHS buffers, the result in lhs2 after an
//            odd number of steps
//   rhs_t    scratch [batches][NO][seglen] (unless bt)
//   acc      ACC: int32 [rows][accw], zeroed by the caller
//   chk      uint32 [batches][rows], zeroed by the caller
// bn (32, 64, 128 or 256; TILE and ACC 128) and split (ACC only)
// from ops/micro.py:step_plan.  Shapes: NO % bn == 0, NO % 64 == 0,
// seglen % 128 == 0, lstride % 16 == 0, lhs_bstride == rows * lstride,
// rhs_bstride == seglen * NO; TILE: NO >= 256, lstride % (128 nwin) == 0;
// ACC: batches == 1, 128 <= accw <= NO; MM: nwin == 1, NO == lstride.
// Returns 0 or the first CUDA error.
extern "C" int micro_mm_loop(int mode, int bt, void* lhs, void* lhs2,
                             const void* rhs, void* rhs_t, void* acc,
                             void* chk, int batches, int rows, int lstride,
                             long long lhs_bstride, long long rhs_bstride,
                             int NO, int seglen, int nwin, int wstride,
                             int nouter, int ostride, int doff, int steps,
                             int accw, int mask, int bn, int split,
                             void* stream) {
  const bool ok =
      mode >= TILE && mode <= MM && batches >= 1 && rows > 0 && NO > 0 &&
      (bn == 32 || bn == 64 || bn == 128 || bn == 256) && NO % bn == 0 &&
      NO % 64 == 0 && seglen > 0 && seglen % wgs8::BK == 0 && nwin >= 1 &&
      nouter >= 1 && steps >= 0 && split >= 1 && lstride % 16 == 0 &&
      lhs_bstride == (long long)rows * lstride &&
      (batches == 1 || rhs_bstride == (long long)seglen * NO) &&
      (!bt || mode == ACC) && (mode == ACC || split == 1) &&
      (mode != TILE || (bn == 128 && NO >= 256 &&
                        lstride % (128 * nwin) == 0)) &&
      (mode != ACC || (batches == 1 && bn == 128 && accw >= 128 &&
                       accw <= NO)) &&
      (mode != MM || (nwin == 1 && NO == lstride));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* bsrc = rhs;
  if (!bt) {
    rhs_kmajor<<<dim3(NO / 64, seglen / 64, batches), 256, 0, st>>>(
        static_cast<const int8_t*>(rhs), static_cast<int8_t*>(rhs_t), seglen,
        NO, mode == TILE);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bsrc = rhs_t;
  }
  int8_t* bufs[2] = {static_cast<int8_t*>(lhs),
                     static_cast<int8_t*>(mode == ACC ? lhs : lhs2)};
  CUtensorMap lmaps[2], bmap;
  int rc = wgs8::encode_2d(&bmap, bsrc, seglen, (uint64_t)batches * NO,
                           seglen, bn);
  for (int i = 0; i < 2 && rc == 0; ++i)
    rc = wgs8::encode_2d(&lmaps[i], bufs[i], lstride,
                         (uint64_t)batches * rows, lstride, wgs8::BM);
  if (rc != 0) return rc;
  const StepArgs a{nullptr, static_cast<int32_t*>(acc),
                   static_cast<uint32_t*>(chk), rows, lstride, NO, seglen,
                   nwin, wstride, nouter, ostride, doff, accw, mask,
                   (rows + wgs8::BM - 1) / wgs8::BM, NO / bn, split};
  if (mode == TILE)
    return launch_steps<TILE, 128>(a, lmaps, bmap, bufs, batches, steps, st);
  if (mode == ACC)
    return launch_steps<ACC, 128>(a, lmaps, bmap, bufs, batches, steps, st);
  switch (bn) {
    case 32: return launch_steps<MM, 32>(a, lmaps, bmap, bufs, batches, steps, st);
    case 64: return launch_steps<MM, 64>(a, lmaps, bmap, bufs, batches, steps, st);
    case 128: return launch_steps<MM, 128>(a, lmaps, bmap, bufs, batches, steps, st);
    default: return launch_steps<MM, 256>(a, lmaps, bmap, bufs, batches, steps, st);
  }
}

// w int8 [8, 8], a int8 [8, Y] -> out [8, Y] after `inner` rounds.
extern "C" int micro_smallk(const void* w, const void* a, void* out, int Y,
                            int inner, int mask, void* stream) {
  if (Y <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
  constexpr int cols = 16 * SK_GR * SK_TW;   // columns a warp
  const long long warps = ((long long)Y + cols - 1) / cols;
  const int blocks = (int)((warps * 32 + SK_THREADS - 1) / SK_THREADS);
  smallk_kernel<SK_GR, SK_TW><<<blocks, SK_THREADS, 0,
                                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const int8_t*>(a),
      static_cast<int8_t*>(out), Y, inner,
      (uint32_t)(mask & 0xFF) * 0x01010101u);
  return (int)cudaGetLastError();
}

// body: 0 vpu, 1 f32, 2 barrett, 3 i16, 4 i32var (y [n] int32), 5 conv,
// 6 select; x and out [n] of the body's element type, n a multiple of 16
// bytes' elements, every pointer 16-byte aligned.
extern "C" int micro_alu(int body_id, const void* x, const void* y,
                         void* out, long long n, int inner, int i_mul,
                         int i_add, int i_mask, int i_p, int i_off,
                         float f_mul, float f_add, float f_max,
                         float f_inv_p, void* stream) {
  const int bytes = body_id == I16 ? 2 : 4;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  // the float round's range: |x / p| <= 2^31 |1/p| < 2^22
  const bool rounds = body_id == BARRETT || body_id == CONV;
  if (n <= 0 || inner < 0 || n * bytes % 16 != 0 || misaligned(x) ||
      misaligned(out) || (body_id == I32VAR && misaligned(y)) ||
      (rounds && !(f_inv_p >= -0x1p-10f && f_inv_p <= 0x1p-10f)))
    return (int)cudaErrorInvalidValue;
  const AluConsts k{i_mul, i_add, i_mask, i_p, i_off,
                    f_mul, f_add, f_max, f_inv_p};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (body_id) {
    case VPU: return launch_alu<VPU>(x, y, out, n, inner, k, st);
    case F32: return launch_alu<F32>(x, y, out, n, inner, k, st);
    case BARRETT: return launch_alu<BARRETT>(x, y, out, n, inner, k, st);
    case I16: return launch_alu<I16>(x, y, out, n, inner, k, st);
    case I32VAR: return launch_alu<I32VAR>(x, y, out, n, inner, k, st);
    case CONV: return launch_alu<CONV>(x, y, out, n, inner, k, st);
    case SELECT: return launch_alu<SELECT>(x, y, out, n, inner, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out uint32 [rows, 1024], m uint32 [1024]; shift must be ROLL_SHIFT
// (the kernel's renaming is fixed at compile time).
extern "C" int micro_roll(const void* x, const void* m, void* out, int rows,
                          int inner, int shift, unsigned add, void* stream) {
  if (rows <= 0 || inner < 0 || shift != ROLL_SHIFT)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)rows * ROLL_SHIFT;
  roll_kernel<<<(int)((threads + ROLL_THREADS - 1) / ROLL_THREADS),
                ROLL_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(m),
      static_cast<uint32_t*>(out), rows, inner, add);
  return (int)cudaGetLastError();
}

extern "C" const char* micro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
