// Microbenchmark kernels for Hopper (sm_90a): the in-kernel loops of the
// JAX package's tools, which measured the TPU's int8 and vector ceilings at
// the tkey blind rotation's product shapes.
//
// Replaces the Pallas kernels of
//   tools/tk_mm_bench.py     kern_fat, kern_thin, kern_pure, kern_puret
//   tools/tk_width_bench.py  main.make.kern
//   tools/microbench.py      mm_int8_pallas_case.kern, pk_mm_case.kern,
//                            pk_bdot_case.kern (mm_loop_kernel, MM mode),
//                            pk_smallk_case.kern (smallk_kernel),
//                            _pallas_loop_case.make.kern with the bodies
//                            pk_vpu, pk_f32, pk_barrett, pk_i16, pk_i32var,
//                            pk_conv, pk_select (alu_kernel) and pk_roll
//                            (roll_kernel).
//
// Three designs:
//
// 1. mm_loop_kernel<MODE, BT>: a looped int8 tensor-core product.  Every
//    step's LHS row depends only on that row's previous step, so a block
//    owns BM = 16 LHS rows across all steps and no block waits for another.
//    A step reads `nwin` LHS windows that share every rhs k-tile, in
//    `nouter` passes over rhs:
//      P_w[r, n] = sum_{o < nouter} sum_{k < seglen}
//                  L[r, doff + w*wstride + o*ostride + k] * B[k, n]
//    (B = rhs [seglen, NO], or rhs^T for BT: rhs stored [NO, seglen]).
//    The epilogue of MODE reads them:
//      TILE  one dot a window (kern_fat: 8 windows 768 apart, one pass;
//            kern_thin: 8 windows 128 apart, a pass per j-row):
//            w_d = (P_d[:, :128] + P_d[:, 128:256]) & 31, and at the step's
//            end L[r, c] = w_{((c mod wrap) / 128) mod nwin}[r, c mod 128]
//            (wrap = 12288 fat, 2048 thin: every j-row);
//      ACC   one dot, the sum of the windows S = sum_w P_w (kern_pure /
//            kern_puret: the 8 windows 768 apart; the width sweep: ndots
//            windows 128 apart): acc[:, :accw] += S[:, :accw] (wrapping
//            int32, in global memory), and at the step's end L[:, :128] =
//            the low byte of acc[:, :128] (accw = 768 pure, 128 width);
//      MM    one window: L' = (P & mask) as int8, into the other of two LHS
//            buffers (mmp, pk_mm; pk_bdot with a batch per blockIdx.y).
//    Columns the tool never reads (TILE: 256..767, ACC: accw..NO-1) are
//    still computed and summed into a per-row uint32 checksum `chk`, so the
//    compiler cannot drop their mma.sync and the rate counts every product
//    the tool counts.
//    What bounds it: the int8 products (2 ops a MAC at 1979 TOP/s) at large
//    batches, but the right-hand sides (4.5 MB for T1, up to 36 MB for the
//    width sweep, 1 MB for pk_mm) do not fit in shared memory, so every
//    block streams rhs from L2 every step: nouter * seglen * NO bytes, plus
//    its LHS windows once per 256-column chunk (ops/micro.py
//    l2_bytes_per_step, which the smoke run prints).  The design: mma.sync
//    m16n8k32 s8 -> s32 with ldmatrix fragments; 8 warps x 32 columns make
//    a 256-column chunk; each rhs k-tile brought into shared memory serves
//    all nwin windows (its B fragments are loaded once for them), so rhs is
//    read once a pass, not once a dot; a 4-deep cp.async ring of 64-deep
//    k-tiles streams without a break across the passes and chunks of a
//    step (it drains only where the next step's LHS is written); each block
//    starts its k-tiles at its own offset, so blocks in flight read
//    different rhs lines instead of all hitting the same L2 lines at once
//    (integer sums are exact in any order).  A row-major rhs (pure, fat,
//    thin, width, MM) is transposed in shared memory per k-tile by byte
//    permutes, because the B operand wants the contraction contiguous and
//    ldmatrix cannot transpose 8-bit elements; a BT rhs ([NO, K], puret)
//    goes straight from the ring to ldmatrix.  pure vs puret measures that
//    transpose, which the tkey kernel's conv_kernel pays too.
//
// 2. smallk_kernel: a <- (W @ a & mask) as int8 with W [8, 8] (pk_smallk).
//    mma.sync int8 needs K = 32 and M = 16, so a K = 8, M = 8 product would
//    waste 7/8 of every tensor-core operation and need shuffles to bring
//    each result back into the B layout; dp4a on the integer units has no
//    waste: a thread owns one column of a in two registers, W lives in 16
//    registers, and an iteration is 16 dp4a, 8 ANDs and the byte packing.
//    Bound: the integer units, not memory (a stays in registers).
//
// 3. alu_kernel<BODY> and roll_kernel: INNER rounds of a body on operands
//    held in registers (the TPU kept them in VMEM).  The bodies' constants
//    arrive as kernel arguments, so nvcc cannot fold five multiply-adds into
//    one or strength-reduce a multiply; the smoke run prints each loop's
//    SASS opcodes to read the rate against the instructions issued.  f32
//    multiply-adds are __fmaf_rn (the JAX CPU result fuses them); Barrett's
//    float round is __float2int_rn (round half to even, as jnp.round).
//    pk_roll's lane rotation (pltpu.roll by 128 of 1024 lanes) has no
//    register form on a GPU that is not a rename the compiler would remove:
//    a block keeps one 1024-word row in shared memory and each round reads
//    the rotated word, so it measures a shared-memory permute and a barrier.
//    Bound: the integer or FP32 lanes.
//
// Built by iyokan_tpu_torch/ops/micro.py through ops/nvcc.py (plain C
// interface, ctypes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;            // LHS rows a block owns (one m16 tile)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WN = 32;            // output columns a warp owns in a chunk
constexpr int CN = WARPS * WN;    // columns a chunk covers
constexpr int BK = 64;            // contraction rows per k-tile
constexpr int STAGES = 4;         // cp.async ring depth
constexpr int ASTR = 80;          // A tile row stride (64 bytes + pad)
constexpr int TSTR = 80;          // [n][k] B tile row stride (64 + pad)
constexpr int RSTR = CN + 16;     // raw row-major B tile row stride
constexpr int MAXDOT = 8;         // TILE: windows (dots) a step at most
constexpr int MAXWIN = 16;        // ACC: windows a step at most

enum Mode { TILE = 0, ACC = 1, MM = 2 };

struct LoopArgs {
  int8_t* lhs;          // [batches][rows][lstride]; TILE: the output
  int8_t* lhs2;         // MM: the second buffer
  const int8_t* rhs;    // [batches][seglen][NO], or BT [batches][NO][seglen]
  int32_t* acc;         // ACC: [rows][accw], zeroed by the caller
  uint32_t* chk;        // [batches][rows]
  long long lhs_bstride, rhs_bstride;
  int rows, lstride, NO, seglen, nwin, wstride, nouter, ostride, doff;
  int steps, accw, wrap, mask;
};

template <int MODE, bool BT>
struct LoopSmem {
  static constexpr int NW = MODE == TILE ? MAXDOT : (MODE == ACC ? MAXWIN : 1);
  static constexpr int A_BYTES = NW * BM * ASTR;            // nwin A tiles
  static constexpr int B_BYTES = BT ? CN * TSTR : BK * RSTR;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BT_OFF = STAGES * STAGE;             // transposed B
  static constexpr int BT_BYTES = BT ? 0 : CN * TSTR;
  static constexpr int EPI_OFF = BT_OFF + BT_BYTES;
  // TILE: w sums [MAXDOT][BM][128] int32; ACC: acc[:, :128] [BM][128]
  static constexpr int EPI_BYTES =
      MODE == TILE ? MAXDOT * BM * 128 * 4 : (MODE == ACC ? BM * 128 * 4 : 0);
  static constexpr int CHK_OFF = EPI_OFF + EPI_BYTES;
  static constexpr int BYTES = CHK_OFF + BM * 4;
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

template <int MODE, bool BT>
__global__ void __launch_bounds__(THREADS)
mm_loop_kernel(LoopArgs g) {
  using SM = LoopSmem<MODE, BT>;
  constexpr int NACC = MODE == TILE ? MAXDOT : 1;  // accumulators a thread
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bt = smem + SM::BT_OFF;
  int32_t* epi = reinterpret_cast<int32_t*>(smem + SM::EPI_OFF);
  uint32_t* chk_s = reinterpret_cast<uint32_t*>(smem + SM::CHK_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * BM;
  const int b = blockIdx.y;
  int8_t* cur = g.lhs + b * g.lhs_bstride + (size_t)r0 * g.lstride;
  int8_t* nxt = MODE == MM ? g.lhs2 + b * g.lhs_bstride +
                                 (size_t)r0 * g.lstride
                           : nullptr;
  const int8_t* rhs = g.rhs + b * g.rhs_bstride;
  const int nchunk = (g.NO + CN - 1) / CN;
  const int T = g.seglen / BK;            // k-tiles a pass
  const int TO = T * g.nouter;            // k-tiles a chunk
  const int Q = nchunk * TO;              // k-tiles a step
  const int t_off = (int)((blockIdx.x + (size_t)blockIdx.y * gridDim.x) % T);

  // k-tile q of the step -> ring slot: the nwin A windows' rows and the
  // chunk's rhs rows (or BT columns) of k-tile (t + t_off) mod T
  auto issue = [&](int slot, int q) {
    int8_t* As = smem + slot * SM::STAGE;
    int8_t* Bs = As + SM::A_BYTES;
    const int t = (q % T + t_off) % T, o = (q / T) % g.nouter;
    const int kk = t * BK, c0 = (q / TO) * CN;
    const int8_t* a0 = cur + g.doff + o * g.ostride + kk;
    for (int u = tid; u < g.nwin * BM * 4; u += THREADS) {
      const int w = u / (BM * 4), row = (u >> 2) % BM, part = u & 3;
      cp_async16(As + (w * BM + row) * ASTR + part * 16,
                 a0 + (size_t)row * g.lstride + w * g.wstride + part * 16);
    }
    for (int u = tid; u < BK * CN / 16; u += THREADS) {
      if (BT) {  // u -> (column n, 16-byte piece of its 64 k)
        const int n = u >> 2, part = u & 3;
        if (c0 + n < g.NO)
          cp_async16(Bs + n * TSTR + part * 16,
                     rhs + (size_t)(c0 + n) * g.seglen + kk + part * 16);
      } else {   // u -> (k row, 16-column piece)
        const int k = u / (CN / 16), piece = u % (CN / 16);
        if (c0 + piece * 16 < g.NO)
          cp_async16(Bs + k * RSTR + piece * 16,
                     rhs + (size_t)(kk + k) * g.NO + c0 + piece * 16);
      }
    }
  };

  uint32_t chk0 = 0, chk1 = 0;   // rows grp and grp + 8
  if (tid < BM) chk_s[tid] = 0;
  int c[NACC][4][4];

  for (int step = 0; step < g.steps; ++step) {
    if (MODE == TILE)
      for (int i = tid; i < g.nwin * BM * 128; i += THREADS) epi[i] = 0;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < Q) issue(s, s);
      cp_async_commit();
    }
#pragma unroll
    for (int w = 0; w < NACC; ++w)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[w][nt][e] = 0;

    for (int q = 0; q < Q; ++q) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int8_t* As = smem + (q % STAGES) * SM::STAGE;
      const int8_t* Bs = As + SM::A_BYTES;
      if (!BT) {
        // transpose the raw tile [64 k][CN n] -> Bt[n][k] in 4x4-byte
        // blocks: w[i] byte j = (k 4kq+i, n 4nq+j) -> Bt[4nq+j][4kq+i];
        // a warp takes 8 n-blocks x 4 k-blocks, so its raw reads are 2-way
        // and its transposed writes 4-way bank conflicts (n-blocks alone
        // made the writes 16-way)
        static_assert(BK / 4 == 16 && CN / 4 == 64, "the lane split below");
        for (int u = tid; u < (BK / 4) * (CN / 4); u += THREADS) {
          const int nq = (u & 7) | ((u >> 5) & 7) << 3;
          const int kq = ((u >> 3) & 3) | (u >> 8) << 2;
          const int8_t* src = Bs + kq * 4 * RSTR + nq * 4;
          const uint32_t w0 = ld32(src), w1 = ld32(src + RSTR);
          const uint32_t w2 = ld32(src + 2 * RSTR);
          const uint32_t w3 = ld32(src + 3 * RSTR);
          const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
          const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
          const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
          const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
          uint32_t* dst =
              reinterpret_cast<uint32_t*>(Bt + nq * 4 * TSTR + kq * 4);
          dst[0] = __byte_perm(t0, t2, 0x5410);
          dst[TSTR / 4] = __byte_perm(t0, t2, 0x7632);
          dst[2 * TSTR / 4] = __byte_perm(t1, t3, 0x5410);
          dst[3 * TSTR / 4] = __byte_perm(t1, t3, 0x7632);
        }
      }
      if (q + STAGES - 1 < Q) issue((q + STAGES - 1) % STAGES, q + STAGES - 1);
      cp_async_commit();
      if (!BT) __syncthreads();  // Bt complete
      const int8_t* Bn = BT ? Bs : Bt;   // [n][k], row stride TSTR
      const int cw = (q / TO) * CN + warp * WN;  // this warp's first column
      if (cw < g.NO) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
          uint32_t bf[2][4];   // n8 tiles (2np, 2np+1) of this k32 slice
#pragma unroll
          for (int np = 0; np < 2; ++np)
            ldmatrix_x4(bf[np], Bn + (warp * WN + np * 16 + (lane >> 4) * 8 +
                                      (lane & 7)) * TSTR +
                                    kk + ((lane >> 3) & 1) * 16);
          const int8_t* Ar = As + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                      ASTR + kk + (lane >> 4) * 16;
          // a group of windows' A fragments first, then their products,
          // so the loads' latency overlaps instead of stalling each
          // window's mmas (TILE: one group of its 8 windows, one
          // accumulator each; ACC: groups of 8 into one accumulator)
          constexpr int GRP = SM::NW < 8 ? SM::NW : 8;
          for (int w0 = 0; w0 < g.nwin; w0 += GRP) {
            uint32_t a[GRP][4];
#pragma unroll
            for (int w = 0; w < GRP; ++w)
              if (w0 + w < g.nwin)
                ldmatrix_x4(a[w], Ar + (w0 + w) * BM * ASTR);
#pragma unroll
            for (int w = 0; w < GRP; ++w) {
              if (w0 + w >= g.nwin) continue;
              int (&cc)[4][4] = c[MODE == TILE ? w : 0];
#pragma unroll
              for (int np = 0; np < 2; ++np) {
                mma_s8(cc[2 * np], a[w], bf[np][0], bf[np][1]);
                mma_s8(cc[2 * np + 1], a[w], bf[np][2], bf[np][3]);
              }
            }
          }
        }
      }
      if (q % TO == TO - 1 && cw < g.NO) {  // the chunk is complete
#pragma unroll
        for (int w = 0; w < NACC; ++w)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = grp + (e >> 1) * 8;
              const int col = cw + nt * 8 + tig * 2 + (e & 1);
              const int v = c[w][nt][e];
              c[w][nt][e] = 0;
              bool dead = false;
              if (MODE == TILE) {
                if (w >= g.nwin) continue;
                if (col < 256)
                  atomicAdd(&epi[(w * BM + row) * 128 + (col & 127)], v);
                else
                  dead = true;
              } else if (MODE == ACC) {
                if (col < g.accw) {
                  int32_t* ap = g.acc + (size_t)(r0 + row) * g.accw + col;
                  const int nv = (int)((uint32_t)*ap + (uint32_t)v);
                  *ap = nv;
                  if (col < 128) epi[row * 128 + col] = nv;
                } else {
                  dead = true;
                }
              } else {
                nxt[(size_t)row * g.lstride + col] = (int8_t)(v & g.mask);
              }
              if (dead) {
                if (e >> 1) chk1 += (uint32_t)v;
                else chk0 += (uint32_t)v;
              }
            }
      }
    }
    // step end: every read of this step's LHS is done; write the next one
    cp_async_wait<0>();
    __syncthreads();
    if (MODE == TILE) {
      for (int u = tid; u < BM * g.lstride / 16; u += THREADS) {
        const int row = u / (g.lstride / 16);
        const int col = (u % (g.lstride / 16)) * 16;
        const int cc = col % g.wrap;
        const int32_t* w =
            epi + (((cc >> 7) % g.nwin) * BM + row) * 128 + (cc & 127);
        uint32_t out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          out[i] = (uint32_t)(w[4 * i] & 31) |
                   (uint32_t)(w[4 * i + 1] & 31) << 8 |
                   (uint32_t)(w[4 * i + 2] & 31) << 16 |
                   (uint32_t)(w[4 * i + 3] & 31) << 24;
        *reinterpret_cast<uint4*>(cur + (size_t)row * g.lstride + col) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    } else if (MODE == ACC) {
      for (int u = tid; u < BM * 128; u += THREADS)
        cur[(size_t)(u >> 7) * g.lstride + (u & 127)] = (int8_t)epi[u];
    } else {
      int8_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();
  }

  // checksum of the unread columns: the four threads of a row group, then
  // the eight warps
  chk0 += __shfl_xor_sync(0xffffffffu, chk0, 1);
  chk0 += __shfl_xor_sync(0xffffffffu, chk0, 2);
  chk1 += __shfl_xor_sync(0xffffffffu, chk1, 1);
  chk1 += __shfl_xor_sync(0xffffffffu, chk1, 2);
  __syncthreads();
  if (tig == 0) {
    atomicAdd(&chk_s[grp], chk0);
    atomicAdd(&chk_s[grp + 8], chk1);
  }
  __syncthreads();
  if (tid < BM) g.chk[(size_t)b * g.rows + r0 + tid] = chk_s[tid];
}

template <int MODE, bool BT>
int launch_loop(const LoopArgs& g, int batches, cudaStream_t st) {
  using SM = LoopSmem<MODE, BT>;
  cudaError_t e = cudaFuncSetAttribute(
      mm_loop_kernel<MODE, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM::BYTES);
  if (e != cudaSuccess) return (int)e;
  mm_loop_kernel<MODE, BT><<<dim3(g.rows / BM, batches), THREADS, SM::BYTES,
                             st>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// small-K product: a <- (W @ a & mask), W [8, 8], a [8, Y]
// ---------------------------------------------------------------------------

__global__ void smallk_kernel(const int8_t* __restrict__ w,
                              const int8_t* __restrict__ a,
                              int8_t* __restrict__ out, int Y, int inner,
                              int mask) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= Y) return;
  int wlo[8], whi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    wlo[i] = (int)ld32(w + 8 * i);
    whi[i] = (int)ld32(w + 8 * i + 4);
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo |= (uint32_t)(uint8_t)a[(size_t)k * Y + y] << (8 * k);
    hi |= (uint32_t)(uint8_t)a[(size_t)(k + 4) * Y + y] << (8 * k);
  }
#pragma unroll 1
  for (int it = 0; it < inner; ++it) {
    uint32_t nl = 0, nh = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int z0 = __dp4a(whi[i], (int)hi, __dp4a(wlo[i], (int)lo, 0));
      const int z1 =
          __dp4a(whi[i + 4], (int)hi, __dp4a(wlo[i + 4], (int)lo, 0));
      nl |= (uint32_t)(z0 & mask) << (8 * i);
      nh |= (uint32_t)(z1 & mask) << (8 * i);
    }
    lo = nl;
    hi = nh;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[(size_t)k * Y + y] = (int8_t)(lo >> (8 * k));
    out[(size_t)(k + 4) * Y + y] = (int8_t)(hi >> (8 * k));
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

template <int BODY>
struct Elem { using T = int32_t; };
template <> struct Elem<F32> { using T = float; };
template <> struct Elem<I16> { using T = int16_t; };
template <> struct Elem<SELECT> { using T = uint32_t; };

template <int BODY>
__device__ __forceinline__ typename Elem<BODY>::T body(
    typename Elem<BODY>::T x, int32_t y, const AluConsts& k) {
  if constexpr (BODY == VPU) {          // 5 x (x * 3 + 1), & 0xFFFFF
#pragma unroll
    for (int i = 0; i < 5; ++i)
      x = (int32_t)((uint32_t)x * (uint32_t)k.i_mul + (uint32_t)k.i_add);
    return x & k.i_mask;
  } else if constexpr (BODY == F32) {   // 5 x fma(x, 1.0001, 0.5), min 1e6
#pragma unroll
    for (int i = 0; i < 5; ++i) x = __fmaf_rn(x, k.f_mul, k.f_add);
    return fminf(x, k.f_max);
  } else if constexpr (BODY == BARRETT) {  // x - round(x/p)*p + 2^21
    const int q = __float2int_rn(__fmul_rn(__int2float_rn(x), k.f_inv_p));
    return (int32_t)((uint32_t)x - (uint32_t)q * (uint32_t)k.i_p +
                     (uint32_t)k.i_off);
  } else if constexpr (BODY == I16) {   // 5 x (x * 12289 + 1) mod 2^16
#pragma unroll
    for (int i = 0; i < 5; ++i)
      x = (int16_t)(uint16_t)((uint32_t)(uint16_t)x * (uint32_t)k.i_mul +
                              (uint32_t)k.i_add);
    return x;
  } else if constexpr (BODY == I32VAR) {  // 5 x ((x * y + 1) & 0xFFFFF)
#pragma unroll
    for (int i = 0; i < 5; ++i)
      x = (int32_t)((uint32_t)x * (uint32_t)y + (uint32_t)k.i_add) &
          k.i_mask;
    return x;
  } else if constexpr (BODY == CONV) {  // x - round(x/p) + 7
    const int q = __float2int_rn(__fmul_rn(__int2float_rn(x), k.f_inv_p));
    return (int32_t)((uint32_t)x - (uint32_t)q + (uint32_t)k.i_off);
  } else {                              // 5 x (x > 5 ? x + 1 : x), unsigned
#pragma unroll
    for (int i = 0; i < 5; ++i)
      x = x > (uint32_t)k.i_mask ? x + (uint32_t)k.i_add : x;
    return x;
  }
}

template <int BODY>
__global__ void alu_kernel(const typename Elem<BODY>::T* __restrict__ x,
                           const int32_t* __restrict__ y,
                           typename Elem<BODY>::T* __restrict__ out,
                           long long n, int inner, AluConsts k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  typename Elem<BODY>::T v = x[i];
  const int32_t yv = BODY == I32VAR ? y[i] : 0;
#pragma unroll 1
  for (int it = 0; it < inner; ++it) v = body<BODY>(v, yv, k);
  out[i] = v;
}

// pk_roll: rows of 1024 u32 words; per round r = roll(x, 128) (r[i] =
// x[(i - 128) mod 1024]), r += m * (0 - 2r) (mod 2^32), r += 1
constexpr int ROLL_N = 1024;
constexpr int ROLL_THREADS = 256;

__global__ void __launch_bounds__(ROLL_THREADS)
roll_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ m,
            uint32_t* __restrict__ out, int inner, int shift, uint32_t add) {
  __shared__ uint32_t buf[2][ROLL_N];
  const uint32_t* xr = x + (size_t)blockIdx.x * ROLL_N;
  constexpr int PER = ROLL_N / ROLL_THREADS;
  uint32_t mk[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * ROLL_THREADS;
    buf[0][i] = xr[i];
    mk[j] = m[i];
  }
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < inner; ++it) {
    const uint32_t* src = buf[it & 1];
    uint32_t* dst = buf[(it & 1) ^ 1];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * ROLL_THREADS;
      const uint32_t r = src[(i - shift) & (ROLL_N - 1)];
      dst[i] = r + mk[j] * (0u - 2u * r) + add;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * ROLL_THREADS;
    out[(size_t)blockIdx.x * ROLL_N + i] = buf[inner & 1][i];
  }
}

template <int BODY>
int launch_alu(const void* x, const void* y, void* out, long long n,
               int inner, const AluConsts& k, cudaStream_t st) {
  using T = typename Elem<BODY>::T;
  const int blocks = (int)((n + 255) / 256);
  alu_kernel<BODY><<<blocks, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(y),
      static_cast<T*>(out), n, inner, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The looped product (module header).  mode: 0 TILE, 1 ACC, 2 MM; bt: rhs
// stored [NO, seglen].  Shapes: rows % 16 == 0, NO % 32 == 0, seglen % 64
// == 0, every LHS offset and stride a multiple of 16 bytes; TILE: nwin <=
// 8, wrap % 128 == 0, NO >= 256; ACC: nwin <= 16, 128 <= accw <= NO; MM:
// nwin == 1, NO == lstride.  Returns 0 or the first CUDA error.
extern "C" int micro_mm_loop(int mode, int bt, void* lhs, void* lhs2,
                             const void* rhs, void* acc, void* chk,
                             int batches, int rows, int lstride,
                             long long lhs_bstride, long long rhs_bstride,
                             int NO, int seglen, int nwin, int wstride,
                             int nouter, int ostride, int doff, int steps,
                             int accw, int wrap, int mask, void* stream) {
  const bool ok =
      mode >= TILE && mode <= MM && batches >= 1 && rows > 0 &&
      rows % BM == 0 && NO > 0 && NO % WN == 0 && seglen > 0 &&
      seglen % BK == 0 && nwin >= 1 && nouter >= 1 && steps >= 0 &&
      lstride % 16 == 0 && wstride % 16 == 0 && ostride % 16 == 0 &&
      doff % 16 == 0 && (!bt || mode == ACC) &&
      (mode != TILE || (nwin <= MAXDOT && wrap % 128 == 0 && NO >= 256 &&
                        lstride % wrap == 0)) &&
      (mode != ACC || (nwin <= MAXWIN && accw >= 128 && accw <= NO)) &&
      (mode != MM || (nwin == 1 && NO == lstride));
  if (!ok) return (int)cudaErrorInvalidValue;
  LoopArgs g{static_cast<int8_t*>(lhs), static_cast<int8_t*>(lhs2),
             static_cast<const int8_t*>(rhs), static_cast<int32_t*>(acc),
             static_cast<uint32_t*>(chk), lhs_bstride, rhs_bstride, rows,
             lstride, NO, seglen, nwin, wstride, nouter, ostride, doff,
             steps, accw, wrap, mask};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (mode == TILE) return launch_loop<TILE, false>(g, batches, st);
  if (mode == MM) return launch_loop<MM, false>(g, batches, st);
  return bt ? launch_loop<ACC, true>(g, batches, st)
            : launch_loop<ACC, false>(g, batches, st);
}

// w int8 [8, 8], a int8 [8, Y] -> out [8, Y] after `inner` rounds.
extern "C" int micro_smallk(const void* w, const void* a, void* out, int Y,
                            int inner, int mask, void* stream) {
  if (Y <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
  smallk_kernel<<<(Y + 255) / 256, 256, 0,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const int8_t*>(a),
      static_cast<int8_t*>(out), Y, inner, mask);
  return (int)cudaGetLastError();
}

// body: 0 vpu, 1 f32, 2 barrett, 3 i16, 4 i32var (y [n] int32), 5 conv,
// 6 select; x and out [n] of the body's element type.
extern "C" int micro_alu(int body_id, const void* x, const void* y,
                         void* out, long long n, int inner, int i_mul,
                         int i_add, int i_mask, int i_p, int i_off,
                         float f_mul, float f_add, float f_max,
                         float f_inv_p, void* stream) {
  if (n <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
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

// x, out uint32 [rows, 1024], m uint32 [1024]
extern "C" int micro_roll(const void* x, const void* m, void* out, int rows,
                          int inner, int shift, unsigned add, void* stream) {
  if (rows <= 0 || inner < 0) return (int)cudaErrorInvalidValue;
  roll_kernel<<<rows, ROLL_THREADS, 0,
                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(m),
      static_cast<uint32_t*>(out), inner, shift, add);
  return (int)cudaGetLastError();
}

extern "C" const char* micro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
