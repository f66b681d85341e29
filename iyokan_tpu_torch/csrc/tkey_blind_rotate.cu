// Toeplitz-slab blind rotation for Hopper (sm_90a): the lvl1 gate
// bootstrap's n CMUX steps as int8 tensor-core products, exact mod 2^32.
//
// Replaces iyokan_tpu/ops/pallas_tk.py::_kernel_pipe (the TPU default) and
// ::_kernel (its one-chain fallback) on their fat layout with the asymmetric
// gadget: any L in {3, 4} key limbs and lb in [1, l] b-part digits.  The
// TPU's chain interleave, DMA slots and compile-probe ladder are schedule,
// not math, and are not carried over; its K-major form is (conv_kernel).
//
// Per step i (RR = l + lb digit rows, RT = RR*N contraction rows, NB = N/128
// output blocks, columns of the slab ordered (u, limb, 128)):
//   digits_kernel: x_u = X^{rot[g]} acc_u - acc_u + off_u, its signed
//     base-Bg digits as int8 ext[g, (block, part, j, 128)];
//   conv_kernel: s_K = -ext[:, :cut].bk[RT-cut:] + ext[:, cut:].bk[:RT-cut]
//     (cut = 128*RR*(K+1), computed as one K-major product, see below),
//     recombined as sum_li s_K[u, li] << 8*(4-L+li) in uint32 and added in
//     place to acc[g, u, 128K : 128K+128].
// int32 accumulation is exact: |digit| <= 32, |limb| <= 128, contraction
// 5120 at cggi128 bound every partial sum by 2^25.
//
// What bounds it on the H100: one gate bootstrap is n*NB*RT*2L*128 =
// 635*8*5120*768 = 2.0e10 int8 MACs, and every step streams a 3.9 MB slab
// (5120 x 768 int8) that all gates of the batch share.  At large batches
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

__global__ void digits_kernel(const int32_t* __restrict__ rot,   // [Gp]
                              const uint32_t* __restrict__ acc,  // [Gp,2,N]
                              int8_t* __restrict__ ext,          // [Gp,RT]
                              int Gp, int N, int l, int lb, int Bgbit,
                              uint32_t off_a, uint32_t off_b) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)Gp * N) return;
  const int g = (int)(idx / N), i = (int)(idx % N);
  const int RR = l + lb;
  const int twoN = 2 * N;
  // X^r * p: coefficient i is p[m] for m = (i - r) mod 2N < N, else -p[m-N]
  int m = (i - rot[g]) % twoN;
  if (m < 0) m += twoN;
  const int src = m < N ? m : m - N;
  const uint32_t Bg = 1u << Bgbit;
  int8_t* out = ext + (size_t)g * RR * N + (size_t)(i >> 7) * RR * 128 +
                (i & 127);
  int rr = 0;
  for (int part = 0; part < 2; ++part) {
    const uint32_t* pp = acc + ((size_t)g * 2 + part) * N;
    const uint32_t v = pp[src];
    const uint32_t r = m < N ? v : 0u - v;
    const uint32_t x = r - pp[i] + (part ? off_b : off_a);
    const int nd = part ? lb : l;
    for (int j = 0; j < nd; ++j, ++rr) {
      const int d = (int)((x >> (32 - (j + 1) * Bgbit)) & (Bg - 1)) -
                    (int)(Bg >> 1);
      out[rr * 128] = (int8_t)d;
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

// Shared-memory plan of conv_kernel<L>: a STAGES-deep ring of raw tiles
// (digits A: 128 rows x 64 bytes; slab B: 64 rows x L*32 columns, as in
// global memory) and one transposed slab tile Bt [L*32 columns][64 rows].
template <int L>
struct ConvSmem {
  static constexpr int BW = L * CT;              // slab columns per tile
  static constexpr int A_BYTES = MAXNB * GB * ASTR;
  static constexpr int BRSTR = BW + 16;          // raw slab row stride
  static constexpr int STAGE = A_BYTES + BK * BRSTR;
  static constexpr int BYTES = STAGES * STAGE + BW * BSTR;
};

// One tile: 16 gates x all NB output blocks K (warp K computes block K) x
// part u x coefficients [ct*32, ct*32+32) of each block, all L limbs, over
// the contraction k-tiles [t_lo, t_hi) of the split along blockIdx.z.
// K-major form (pallas_tk.py::_kernel_pipe kmaj): output block K is the
// digit extension negacyclically rotated by cut = 128*RR*(K+1) against the
// plain slab,
//   s_K[g, :] = sum_r A_K[g, r] * bk[r, :],
//   A_K[g, r] = ext[g, (r + cut) mod RT], negated where r + cut >= RT,
// so one slab tile in shared memory serves all NB blocks: the 3.9 MB step
// slab is read once per 16 gates instead of once per block.  Tiles arrive
// by cp.async STAGES-1 k-tiles ahead of the products.
template <int L>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ ext,  // [Gp, RT]
            const int8_t* __restrict__ bk,   // [RT, 2*L*128] (this step)
            uint32_t* __restrict__ acc,      // [Gp, 2, N]
            int N, int RR, int split) {
  using SM = ConvSmem<L>;
  constexpr int NT = L * 4;  // n8 tiles: L limb strips x 32 columns
  constexpr int C = 2 * L * 128;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bt = smem + STAGES * SM::STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int NB = N >> 7;
  const int blk = RR * 128;  // contraction rows per 128-coefficient block
  const int RT = blk * NB;
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
    for (int q = tid; q < NB * GB * 4; q += THREADS) {
      const int row = q >> 2;
      int src = r0 + (row / GB + 1) * blk;
      if (src >= RT) src -= RT;
      cp_async16(As + row * ASTR + (q & 3) * 16,
                 ext + (size_t)(g0 + row % GB) * RT + src + (q & 3) * 16);
    }
    for (int q = tid; q < BK * L * 2; q += THREADS) {
      const int row = q / (2 * L), li = (q >> 1) % L, half = q & 1;
      cp_async16(Bs + row * SM::BRSTR + li * CT + half * 16,
                 bk + (size_t)(r0 + row) * C + (u * L + li) * 128 +
                     ct * CT + half * 16);
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
    for (int unit = tid; unit < BK / 4 * SM::BW / 4; unit += THREADS) {
      const int kq = unit / (SM::BW / 4), cq = unit % (SM::BW / 4);
      const int8_t* src = Bs + kq * 4 * SM::BRSTR + cq * 4;
      const uint32_t w0 = ld32(src), w1 = ld32(src + SM::BRSTR);
      const uint32_t w2 = ld32(src + 2 * SM::BRSTR);
      const uint32_t w3 = ld32(src + 3 * SM::BRSTR);
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      uint32_t* dst = reinterpret_cast<uint32_t*>(Bt + cq * 4 * BSTR + kq * 4);
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
      // wrapped rows (r + cut >= RT) enter with a minus sign: negate the
      // digits (|d| <= 32 fits int8 either way)
      const bool neg = (t_lo + i) * BK + (warp + 1) * blk >= RT;
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
          const int8_t* bp = Bt + (nt * 8 + grp) * BSTR + kk + tig * 4;
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

template <int L>
int launch_conv(dim3 grid, cudaStream_t st, const int8_t* ext,
                const int8_t* bk, uint32_t* acc, int N, int RR, int split) {
  conv_kernel<L><<<grid, THREADS, ConvSmem<L>::BYTES, st>>>(ext, bk, acc, N,
                                                            RR, split);
  return (int)cudaGetLastError();
}

}  // namespace

// All n_steps CMUX steps of a blind rotation, launched on `stream`.
//   rows  int32 [n_steps, Gp]   rotation amounts in [0, 2N)
//   acc   uint32 [Gp, 2, N]     accumulator, updated in place
//   bk    int8 [n_steps, (l+lb)*N, 2*L*128]   fat Toeplitz slab
//   ext   int8 [Gp, (l+lb)*N]   scratch
// Gp must be a multiple of 16, N a multiple of 128 up to 1024; split in
// [1, (l+lb)*N/64].  Returns 0 or the first CUDA error.
extern "C" int tkey_blind_rotate(const void* rows, void* acc, const void* bk,
                                 void* ext, int Gp, int n_steps, int N, int l,
                                 int lb, int Bgbit, int L, int split,
                                 uint32_t off_a, uint32_t off_b, int device,
                                 void* stream) {
  const int RR = l + lb;
  if (Gp <= 0 || Gp % GB || N % 128 || N / 128 > MAXNB ||
      (L != 3 && L != 4) || split < 1 || split > RR * N / BK)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  // > 48 KB of dynamic shared memory must be opted into, per kernel
  e = cudaFuncSetAttribute(conv_kernel<3>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ConvSmem<3>::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv_kernel<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ConvSmem<4>::BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t RT = (size_t)RR * N;
  const size_t C = 2 * (size_t)L * 128;
  const dim3 grid(2 * 4, Gp / GB, split);
  const int64_t nthr = (int64_t)Gp * N;
  const int dblocks = (int)((nthr + 255) / 256);
  int rc;
  for (int i = 0; i < n_steps; ++i) {
    digits_kernel<<<dblocks, 256, 0, st>>>(
        static_cast<const int32_t*>(rows) + (size_t)i * Gp,
        static_cast<const uint32_t*>(acc), static_cast<int8_t*>(ext), Gp, N,
        l, lb, Bgbit, off_a, off_b);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int8_t* bki = static_cast<const int8_t*>(bk) + (size_t)i * RT * C;
    rc = (L == 3 ? launch_conv<3> : launch_conv<4>)(
        grid, st, static_cast<const int8_t*>(ext), bki,
        static_cast<uint32_t*>(acc), N, RR, split);
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" const char* tkey_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
