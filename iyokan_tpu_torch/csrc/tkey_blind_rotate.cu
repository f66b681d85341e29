// Toeplitz-slab blind rotation for Hopper (sm_90a): the lvl1 gate
// bootstrap's CMUX steps as int8 tensor-core products, exact mod 2^32.
//
// Replaces iyokan_tpu/ops/pallas_tk.py::_kernel_pipe (the TPU default) and
// ::_kernel (its one-chain form) on every slab layout of
// crypto/polymul.tkey_kernel_key, with the asymmetric gadget: any L in
// {3, 4} key limbs and lb in [1, l] b-part digits.  The TPU's chain
// interleave, DMA slots and compile-probe ladder are schedule, not math, and
// are not carried over; its K-major form is (conv_kernel).  Layouts (RR =
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
//   conv_kernel: s_K[g, :] = sum_r A_K[g, r] * bk[r, :] (one K-major
//     product, see below), recombined as sum_li s_K[u, li] << 8*(4-L+li) in
//     uint32 and added in place to acc[g, u, 128K : 128K+128].
// int32 accumulation is exact: |digit| <= 32, |limb| <= 128, contraction
// at most 15360 (unrolled, cggi128) bound every partial sum by 2^26.
//
// What bounds it on the H100: one gate bootstrap is n*NB*RT*2L*128 =
// 635*8*5120*768 = 2.0e10 int8 MACs (fat, L=3, lb=2; 1.5x that at half the
// steps unrolled), and every step streams a 3.9 MB slab (5120 x 768 int8;
// 11.8 MB unrolled) that all gates of the batch share.  At large batches
// the products bound it; at small batches the slab stream and the 2n
// launches do.  The design: the products run on the tensor cores
// (mma.sync m16n8k32 s8 -> s32); a tile is 16 gates x all 8 output blocks
// (one warp each) x (L x 32) slab columns, so each slab tile brought into
// shared memory serves every output block and the step slab is read once
// per 16 gates; a 4-deep cp.async ring keeps three 64-row k-tiles in
// flight behind the products, so a tile's few iterations do not each wait
// a full memory latency; the slab tile is transposed in shared memory
// (byte permutes), because the tensor-core B operand wants the contraction
// contiguous and the slab keeps columns contiguous; small batches split the
// contraction across tiles
// (exact uint32 atomics: addition mod 2^32 is associative) so the grid
// still covers the SMs.  wgmma/TMA and a persistent step loop are later
// work.
//
// Built by iyokan_tpu_torch/ops/tkey.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtkey-<hash>.so tkey_blind_rotate.cu
// and called through ctypes (plain C interface below).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GB = 16;     // gates per conv tile (one m16 tile)
constexpr int MAXNB = 8;   // output blocks a tile covers: N <= 1024
constexpr int THREADS = 32 * MAXNB;  // one warp per output block
constexpr int BK = 64;     // contraction rows per shared-memory stage
constexpr int STAGES = 4;  // cp.async ring depth (k-tiles in flight + 1)
constexpr int CT = 32;     // output coefficients per tile (per limb strip)
constexpr int ASTR = 80;   // shared row stride of the digit tile (bytes)
constexpr int BSTR = 68;   // row stride of the transposed slab tile (bytes)

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

// Shared-memory plan of conv_kernel<L, MODE>: a STAGES-deep ring of raw
// tiles (digits A: 128 rows x 64 bytes; slab B: 64 rows x L*32 columns, as
// in global memory, NBT of them: fat2 brings both copies) and NBT
// transposed slab tiles Bt [L*32 columns][64 rows].
template <int L, int MODE>
struct ConvSmem {
  static constexpr int BW = L * CT;              // slab columns per tile
  static constexpr int NBT = MODE == FAT2 ? 2 : 1;  // slab tiles per k-tile
  static constexpr int A_BYTES = MAXNB * GB * ASTR;
  static constexpr int BRSTR = BW + 16;          // raw slab row stride
  static constexpr int B_BYTES = BK * BRSTR;     // one raw slab tile
  static constexpr int BT_BYTES = BW * BSTR;     // one transposed slab tile
  static constexpr int STAGE = A_BYTES + NBT * B_BYTES;
  static constexpr int BYTES = STAGES * STAGE + NBT * BT_BYTES;
};

// One tile: 16 gates x all NB output blocks K (warp K computes block K) x
// part u x coefficients [ct*32, ct*32+32) of each block, all L limbs, over
// the contraction k-tiles [t_lo, t_hi) of the split along blockIdx.z.
// K-major form (pallas_tk.py::_kernel_pipe kmaj): output block K is the
// digit extension negacyclically rotated against the plain slab.  The
// contraction splits into segments of seg rows (one on the fat layouts,
// seg = RT; one per digit row on thin, seg = N, a power of two), each
// rotated by (K+1)*shift rows (shift = 128*RR on the fat layouts, 128 on
// thin):
//   s_K[g, :] = sum_r A_K[g, r] * bk[r, :],  r = base + t (t < seg),
//   A_K[g, r] = ext[g, base + (t + (K+1)*shift) mod seg], negated where
//               t + (K+1)*shift >= seg,
// so one slab tile in shared memory serves all NB blocks: the 3.9 MB step
// slab is read once per 16 gates instead of once per block.  On FAT2 a
// wrapped row is not negated but read from bkw, the first copy:
// A_K[g, r] = ext[g, (r + cut) mod RT] against bkw[r] where r + cut >= RT,
// against bk[r] (the second copy) elsewhere.  seg and shift are multiples
// of 128, so a 64-row k-tile never straddles a segment or a wrap.  Tiles
// arrive by cp.async STAGES-1 k-tiles ahead of the products.
template <int L, int MODE>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ ext,  // [Gp, RT]
            const int8_t* __restrict__ bk,   // [RT, 2*L*128] (this step)
            const int8_t* __restrict__ bkw,  // FAT2: wrapped rows' slab
            uint32_t* __restrict__ acc,      // [Gp, 2, N]
            int N, int RT, int seg, int shift, int split) {
  using SM = ConvSmem<L, MODE>;
  // row r's place in its segment: r itself on the fat layouts (r < RT)
  auto in_seg = [seg](int r) { return MODE == THIN ? r & (seg - 1) : r; };
  constexpr int NT = L * 4;  // n8 tiles: L limb strips x 32 columns
  constexpr int C = 2 * L * 128;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bt = smem + STAGES * SM::STAGE;       // NBT transposed tiles

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
  // extension, B rows from the slab's L column strips of this tile
  auto issue = [&](int slot, int t) {
    int8_t* As = smem + slot * SM::STAGE;
    int8_t* Bs = As + SM::A_BYTES;
    const int r0 = t * BK;
    const int t0 = in_seg(r0);    // the tile's first row in its segment
    for (int q = tid; q < NB * GB * 4; q += THREADS) {
      const int row = q >> 2;
      int o = t0 + (row / GB + 1) * shift;
      if (o >= seg) o -= seg;
      cp_async16(As + row * ASTR + (q & 3) * 16,
                 ext + (size_t)(g0 + row % GB) * RT + (r0 - t0) + o +
                     (q & 3) * 16);
    }
    constexpr int CHUNKS = BK * L * 2;  // 16-byte pieces of one slab tile
    for (int q = tid; q < SM::NBT * CHUNKS; q += THREADS) {
      const int c = SM::NBT == 1 ? 0 : q / CHUNKS, qq = q - c * CHUNKS;
      const int row = qq / (2 * L), li = (qq >> 1) % L, half = qq & 1;
      cp_async16(Bs + c * SM::B_BYTES + row * SM::BRSTR + li * CT + half * 16,
                 (c ? bkw : bk) + (size_t)(r0 + row) * C +
                     (u * L + li) * 128 + ct * CT + half * 16);
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
    const int8_t* As = smem + (i % STAGES) * SM::STAGE;
    const int8_t* Bs = As + SM::A_BYTES;
    // transpose the slab tile: 4x4-byte blocks, w[q] byte p = (row 4kq+q,
    // col 4cq+p) -> Bt[col][row]
    constexpr int UNITS = BK / 4 * SM::BW / 4;  // per slab tile
    for (int unit = tid; unit < SM::NBT * UNITS; unit += THREADS) {
      const int c = SM::NBT == 1 ? 0 : unit / UNITS;
      const int kq = (unit - c * UNITS) / (SM::BW / 4);
      const int cq = unit % (SM::BW / 4);
      const int8_t* src = Bs + c * SM::B_BYTES + kq * 4 * SM::BRSTR + cq * 4;
      const uint32_t w0 = ld32(src), w1 = ld32(src + SM::BRSTR);
      const uint32_t w2 = ld32(src + 2 * SM::BRSTR);
      const uint32_t w3 = ld32(src + 3 * SM::BRSTR);
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          Bt + c * SM::BT_BYTES + cq * 4 * BSTR + kq * 4);
      dst[0] = __byte_perm(t0, t2, 0x5410);
      dst[BSTR / 4] = __byte_perm(t0, t2, 0x7632);
      dst[2 * BSTR / 4] = __byte_perm(t1, t3, 0x5410);
      dst[3 * BSTR / 4] = __byte_perm(t1, t3, 0x7632);
    }
    if (i + STAGES - 1 < ntiles)
      issue((i + STAGES - 1) % STAGES, t_lo + i + STAGES - 1);
    cp_async_commit();
    __syncthreads();  // Bt complete
    if (active) {
      // wrapped rows (t + (K+1)*shift >= seg) enter with a minus sign:
      // negate the digits (|d| <= 32 fits int8 either way); fat2 takes
      // them from the first copy's tile instead
      const bool wrap = in_seg((t_lo + i) * BK) + (warp + 1) * shift >= seg;
      const bool neg = MODE != FAT2 && wrap;
      const int8_t* Bw = Bt + (MODE == FAT2 && wrap ? SM::BT_BYTES : 0);
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

// All n_steps steps on `st` with the conv_kernel instance of (L, MODE):
// its dynamic shared memory (> 48 KB must be opted into, per kernel) is set
// once, then digits_kernel and conv_kernel alternate.  RR = M*(l+lb).
template <int L, int MODE>
int run_steps(const int32_t* rows, uint32_t* acc, const int8_t* bk,
              int8_t* ext, int Gp, int n_steps, int N, int l, int lb,
              int Bgbit, int M, int split, uint32_t off_a, uint32_t off_b,
              cudaStream_t st) {
  using SM = ConvSmem<L, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      conv_kernel<L, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int RR = M * (l + lb);
  const int RT = RR * N;
  const size_t C = 2 * (size_t)L * 128;
  // fat2: a step is 2*RT rows, the first copy (wrapped rows) then the
  // second (the others)
  const size_t step_rows = MODE == FAT2 ? 2 * (size_t)RT : RT;
  const int seg = MODE == THIN ? N : RT, shift = MODE == THIN ? 128 : RR * 128;
  const dim3 grid(2 * 4, Gp / GB, split);
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
    const int8_t* bkw = bk + i * step_rows * C;
    const int8_t* bki = bkw + (MODE == FAT2 ? (size_t)RT * C : 0);
    conv_kernel<L, MODE><<<grid, THREADS, SM::BYTES, st>>>(
        ext, bki, bkw, acc, N, RT, seg, shift, split);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

using RunSteps = int (*)(const int32_t*, uint32_t*, const int8_t*, int8_t*,
                         int, int, int, int, int, int, int, int, uint32_t,
                         uint32_t, cudaStream_t);

}  // namespace

// All n_steps CMUX steps of a blind rotation, launched on `stream`.
//   rows  int32 [n_steps*M, Gp]  rotation amounts in [0, 2N), the M of
//                                step i at rows M*i..
//   acc   uint32 [Gp, 2, N]      accumulator, updated in place
//   bk    int8 slab of `layout`: FAT [n_steps, RT, C] (M = 1, or M = 3 for
//         the 2-bit-unrolled slab), THIN [n_steps, l+lb, N, C], FAT2
//         [n_steps, 2*RT, C]; RT = M*(l+lb)*N, C = 2*L*128
//   ext   int8 [Gp, RT]          scratch
// Gp must be a multiple of 16, N a power of two from 128 to 1024; split in
// [1, RT/64].  Returns 0 or the first CUDA error.
extern "C" int tkey_blind_rotate(const void* rows, void* acc, const void* bk,
                                 void* ext, int Gp, int n_steps, int N, int l,
                                 int lb, int Bgbit, int L, int M, int layout,
                                 int split, uint32_t off_a, uint32_t off_b,
                                 int device, void* stream) {
  static const RunSteps run[2][3] = {
      {run_steps<3, FAT>, run_steps<3, THIN>, run_steps<3, FAT2>},
      {run_steps<4, FAT>, run_steps<4, THIN>, run_steps<4, FAT2>}};
  const int RR = M * (l + lb);  // digit rows a step
  if (Gp <= 0 || Gp % GB || N < 128 || N > 128 * MAXNB || (N & (N - 1)) ||
      (L != 3 && L != 4) || (M != 1 && M != 3) || layout < FAT ||
      layout > FAT2 || (M == 3 && layout != FAT) || split < 1 ||
      split > RR * N / BK)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return run[L - 3][layout](
      static_cast<const int32_t*>(rows), static_cast<uint32_t*>(acc),
      static_cast<const int8_t*>(bk), static_cast<int8_t*>(ext), Gp, n_steps,
      N, l, lb, Bgbit, M, split, off_a, off_b,
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* tkey_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
