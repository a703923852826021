// C1: the fp32 3x3 convolution of detection, y = conv3x3(x, w) + b with an
// optional ReLU, on the tensor cores in error-compensated TF32 ("3xTF32"),
// for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to
// XLA (smallhardface_tpu/models/layers.py:17 conv2d), and the port ran
// those of at least layers.TAPS_MIN_FLOP as nine cuBLAS products in plain
// fp32 on the CUDA cores (models/layers.conv3x3_taps, which stays as this
// kernel's plain version). It was added because those products took most
// of fp32 detection's device time (PERF.md section 5). Built by
// smallhardface_tpu_torch/ops/conv_fp32.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -ftz=false
// and called through ctypes; shf_conv3x3_fp32 below is the whole
// interface. Nothing links libcuda: the tensor maps are encoded by
// libcuda's cuTensorMapEncodeTiled, which the CUDA runtime hands out by
// name at run time (cudaGetDriverEntryPoint).
//
// Semantics. out[b, i, x, o] for a zero-padded 3x3 correlation at
// dilation d of an input with H rows, `row0` of them a halo above the
// output's rows (layers.conv3x3's halo: Ho = H - halo rows, output row i
// reads input rows i + row0 + (ky - 1) d, zero outside [0, H)):
//   out = b[o] + sum over (ky, kx, c) of x[b, i + row0 + (ky-1)d,
//                                           x + (kx-1)d, c] * w[o, ky, kx, c]
//   out = max(out, 0)                                        (RELU only)
//
// Rounding. wgmma reads 19 bits of an fp32 operand, so each operand a is
// cut into hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi) (the
// subtraction is exact) and each product takes a_lo*b_hi, a_hi*b_lo and
// a_hi*b_hi into the fp32 accumulator (lo*lo is dropped), about 22 bits of
// each operand, as K1 does (csrc/stem.cu). A small kernel first cuts w
// into a scratch of hi and lo halves (once per call: kept, they would hold
// twice the weights of every layer on the card); x is cut in registers.
// The tensor cores may round a sum toward zero, so an accumulator runs for
// one K step only (32 channels of one tap: the 4 x 8 channels' small terms
// first, then their large ones, 12 wgmma) and is then added, in fp32
// rounded to nearest, to a second sum that starts at the bias. That chain
// length was measured: against float64, at the 16 layers of the 1408 x
// 1872 level, the root-mean-square error over the nine cuBLAS fp32
// products' was 0.84-1.24 with chains of 32 channels, 1.08-1.24 with 16,
// 1.47-1.53 with 8, and up to 3.0, 5.2 and 12.0 with 64, 128 and a whole
// tap (the rounding toward zero grows with the chain, the rounded
// additions with their number; PERF.md section 6). Every sum is in a
// fixed order and no atomics are used, so the result is the same from run
// to run. Small integers (|a| < 2^11) are their own hi, so on the integer
// recipe of the tests every product and every sum below 2^24 is exact and
// the output equals the plain version's to the bit.
//
// Layouts. x (B, H, W, C) fp32 with channels contiguous and the other
// strides (in elements, multiples of 4) given; w (O, C, 3, 3) fp32 at any
// strides; wsplit, scratch of (2 O, 9 C) words: rows 0 .. O-1 the hi
// halves of w as (O, 3, 3, C), rows O .. 2O-1 the lo halves; bias (O,)
// fp32; out (B, Ho, W, O) fp32, contiguous. C and O are multiples of 64
// (the wrapper raises otherwise); x, wsplit, bias and out 16-byte
// aligned.
//
// What bounds it. An implicit GEMM of M = B*Ho*W pixels, N = O, K = 9*C:
// 2*M*N*K operations, taken three times as TF32 products (495 TFLOP/s on
// an H100 SXM, so 165 TFLOP/s of fp32 work), against B*(H*C + Ho*O)*4
// bytes: from 64 to 512 channels that is 288 to 2,304 fp32 operations a
// byte, above the card's 49 (165 TFLOP/s over 3.35 TB/s). The tensor
// cores bound it: operations.
//
// Design: Q1's (csrc/conv_int8.cu) on the TF32 tensor cores.
// - Tiles. An output tile is 128 pixels, a TH x TW rectangle of one image
//   (chosen per layer by the wrapper), by BN = 128 output channels (64
//   where O is not a multiple of 128).
// - Operands by TMA. x is a 4-D tensor map over (C, W, H, B). For tap
//   (ky, kx) a K step's A tile is one box of 32 channels x TW x TH x 1 at
//   (c0, x0 + (kx-1)d, y0 + row0 + (ky-1)d, b). TMA zero-fills
//   coordinates outside the tensor, negative ones included: that is the
//   zero padding at every dilation, with no padded copy of x and no
//   predicate. The weights are a 2-D map over (9 C, 2 O): the hi box at
//   row n0, the lo box at row O + n0. All boxes are 128 bytes wide, in the
//   128-byte swizzle, K-major, the one order wgmma takes tf32 in.
// - The product. Two MMA warpgroups take 64 rows of the tile each. For
//   each 8 channels a warp loads its A fragment with one ldmatrix (a
//   16 x 8 tf32 block is four 8 x 4-word matrices; the swizzle is the
//   address's XOR), splits it into hi and lo in registers and runs
//   wgmma.mma_async m64nBNk8 .f32.tf32.tf32 with A from registers and the
//   split weights from shared memory. One producer warp keeps a ring of
//   stages full (mbarrier arrive.expect_tx); a stage is released once the
//   wgmma that read it has retired. A block is three warpgroups (384
//   threads, 168 registers each at launch); setmaxnreg gives 128 of the
//   producer warpgroup's to each MMA thread (232).
// - A persistent grid: one block per SM walks the tiles, pixel tiles
//   outer and channel tiles inner, so the blocks that read one A tile run
//   together and share it in L2; the producer loads the next tile while
//   the MMA warpgroups store this one.
// - The epilogue stays in the MMA warpgroups: the sums already hold the
//   bias, so a thread takes the ReLU and stores its two adjacent channels
//   of a pixel as one 8-byte store (a warp writes eight whole 32-byte
//   sectors), skipping the pixels of a ragged tile beyond Ho or W.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;                 // output pixels per tile
constexpr int BK = 32;                  // channels a K step: 128 bytes
constexpr int A_BYTES = BM * BK * 4;
constexpr int MMA_WARPS = 8;            // two warpgroups that run wgmma
constexpr int NT = 384;                 // and one whose first thread runs TMA
constexpr int MAX_STAGES = 8;
constexpr int SMEM_BYTES = 232448 - 1024;   // dynamic shared memory, a block
constexpr int MMA_REGS = 232, PRODUCER_REGS = 40;
constexpr int ENCODE_FAILED = 100000;       // + the CUresult

struct Params {
  int H, W, C, O, d, row0, Ho;
  int th, tw, tw_shift;       // tile rows and columns, log2(tw)
  int tiles_x, tiles_y, n_tiles, total;
  int kc, nk;                 // K steps a tap, a tile
  int stages, stage_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major shared-memory matrix descriptor: rows of 128 bytes in the
// 128-byte swizzle TMA wrote, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused (1) as for every swizzled K-major layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving an operand's access across a wgmma
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Four 8 x 4-word matrices from shared memory, thread l's start address
// for row l % 8 of matrix l / 8; thread l gets word l % 4 of row l / 4 of
// each: with the matrices (rows 0-7, words 0-3), (8-15, 0-3), (0-7, 4-7),
// (8-15, 4-7) of a 16 x 8 tf32 block that is wgmma's A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// a = hi + lo + (what lo's own rounding drops); a - hi is exact. cvt.rna
// rounds to nearest, ties away from zero, to a TF32 pattern (the low 13
// bits 0), as ops/conv_fp32.tf32_rna does.
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(a);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(f));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(__fsub_rn(f, __uint_as_float(hi))));
}

// D (64 x BN, fp32) += A (64 x 8 tf32, registers) * B (BN x 8 tf32)^T;
// acc == 0 overwrites D instead.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b,
                                           int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// wsplit[o][(3 ky + kx) C + c] = hi, wsplit[O + o][...] = lo of
// w[o][c][ky][kx] (strides so, sc, sy, sx in elements)
__global__ void split_weights_kernel(const float* __restrict__ w, long long so, long long sc,
                                     long long sy, long long sx, int O, int C,
                                     uint32_t* __restrict__ wsplit) {
  const long long n = static_cast<long long>(O) * 9 * C;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(i / (9 * C)), k = static_cast<int>(i - o * 9LL * C);
    const int tap = k / C, c = k - tap * C, ky = tap / 3, kx = tap - 3 * ky;
    uint32_t hi, lo;
    split_tf32(__float_as_uint(w[o * so + c * sc + ky * sy + kx * sx]), hi, lo);
    wsplit[i] = hi;
    wsplit[n + i] = lo;
  }
}

struct Tile {
  int b, y0, x0, n0;
};

__device__ __forceinline__ Tile decode(const Params& p, int t, int bn) {
  Tile r;
  const int nt = t % p.n_tiles;
  int q = t / p.n_tiles;
  const int tx = q % p.tiles_x;
  q /= p.tiles_x;
  const int ty = q % p.tiles_y;
  r.b = q / p.tiles_y;
  r.y0 = ty * p.th;
  r.x0 = tx * p.tw;
  r.n0 = nt * bn;
  return r;
}

template <int BN, bool RELU>
__global__ void __launch_bounds__(NT, 1)
conv3x3_fp32_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                    float* __restrict__ out, const Params p) {
  constexpr int B_BYTES = BN * BK * 4;    // one of the two weight boxes
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  // stage s: the A box (BM rows of 128 bytes), the hi and the lo weight
  // boxes (BN rows each), each on a 1024-byte boundary (the swizzle's period)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), MMA_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= MMA_WARPS) {
    // ---- the producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == MMA_WARPS * 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
        const Tile tile = decode(p, t, BN);
        for (int k = 0; k < p.nk; ++k) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          mbar_expect_tx(bar, p.stage_bytes);
          const int tap = k / p.kc, c0 = (k - tap * p.kc) * BK;
          const int ky = tap / 3, kx = tap - ky * 3;
          const uint32_t a = base + stage * p.stage_bytes;
          tma_load_4d(a, &xmap, bar, c0, tile.x0 + (kx - 1) * p.d,
                      tile.y0 + p.row0 + (ky - 1) * p.d, tile.b);
          tma_load_2d(a + A_BYTES, &wmap, bar, tap * p.C + c0, tile.n0);
          tma_load_2d(a + A_BYTES + B_BYTES, &wmap, bar, tap * p.C + c0, p.O + tile.n0);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two MMA warpgroups: rows 64 * wg .. 64 * wg + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    const int wg = warp >> 2, g = lane >> 2, q4 = lane & 3;
    // this thread's ldmatrix row: row l % 8 of matrix l / 8, whose rows
    // are 8 (matrices 1, 3) below and whose words 4 (matrices 2, 3) right
    // of the warp's 16 x 8 block; in the swizzle the 16-byte chunk c of
    // row r lies at chunk c ^ (r % 8)
    const int mrow = lane & 7, mat = lane >> 3;
    const uint32_t a_row = (wg * 64 + (warp & 3) * 16 + mrow + 8 * (mat & 1)) * 128;
    float acc[BN / 2], sum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
      const Tile tile = decode(p, t, BN);
      // the second sum starts at the bias: lane l holds channels
      // 8j + 2(l%4) + {0, 1} of rows l/4 and l/4 + 8
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 b2 = *reinterpret_cast<const float2*>(bias + tile.n0 + 8 * j + 2 * q4);
        sum[4 * j] = sum[4 * j + 2] = b2.x;
        sum[4 * j + 1] = sum[4 * j + 3] = b2.y;
      }
      for (int k = 0; k < p.nk; ++k) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t a = base + stage * p.stage_bytes;
        const uint32_t bh = a + A_BYTES, bl = bh + B_BYTES;
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t r[4];
          ldmatrix_x4(r, a + a_row + (((2 * kk + (mat >> 1)) ^ mrow) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(r[i], hi[kk][i], lo[kk][i]);
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
        // one chain a K step, overwritten at its first wgmma: the small
        // terms first, then the large (a_lo b_hi, a_hi b_lo, a_hi b_hi), 8
        // channels (32 bytes of a swizzled row) a wgmma
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32<BN>(acc, lo[kk], smem_desc(bh + 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32<BN>(acc, hi[kk], smem_desc(bl + 32 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32<BN>(acc, hi[kk], smem_desc(bh + 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        // the A halves stay in their registers until the products that
        // read them have retired
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fence_operand(hi[kk][i]);
            fence_operand(lo[kk][i]);
          }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // rows 16w + l/4 (+8) of this warpgroup's 64, two channels a store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + (warp & 3) * 16 + g + 8 * h;
        const int y = tile.y0 + (r >> p.tw_shift), x = tile.x0 + (r & (p.tw - 1));
        if (y >= p.Ho || x >= p.W) continue;
        float* o = out + ((static_cast<size_t>(tile.b) * p.Ho + y) * p.W + x) * p.O + tile.n0 +
                   2 * q4;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float v0 = sum[4 * j + 2 * h], v1 = sum[4 * j + 2 * h + 1];
          if (RELU) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          *reinterpret_cast<float2*>(o + 8 * j) = make_float2(v0, v1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                : nullptr;
  }();
  return fn;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int BN, bool RELU>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* bias, float* out,
           const Params& p, int smem, cudaStream_t s) {
  auto kernel = conv3x3_fp32_kernel<BN, RELU>;
  // once per instance, before any capture: the dynamic shared memory
  // limit, and a check that the block starts with the registers that
  // setmaxnreg moves (a smaller start would leave the MMA warpgroups
  // waiting for registers that never come)
  static const cudaError_t ready = [kernel] {
    cudaFuncAttributes f;
    cudaError_t e = cudaFuncGetAttributes(&f, kernel);
    if (e == cudaSuccess && f.numRegs * NT < PRODUCER_REGS * 128 + MMA_REGS * 256)
      e = cudaErrorLaunchOutOfResources;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    return e;
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int grid = p.total < sm_count() ? p.total : sm_count();
  kernel<<<grid, NT, smem, s>>>(xmap, wmap, bias, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the weight split into wsplit, then C1, on `stream` (a
// cudaStream_t). x's strides (in elements) are those of its W, H and B
// dimensions; its channels are contiguous. w's are its four. H is
// x's row count, of which row0 lie above the output's Ho rows (a shard's
// halo). The tile: tile_h x tile_w pixels (tile_h * tile_w = 128, tile_w a
// power of two from 8 to 128), block_n output channels (64 or 128,
// dividing O); ops/conv_fp32.py:plan chooses them. Returns a cudaError_t
// (0 on a successful launch), or ENCODE_FAILED + the CUresult where
// libcuda refused a tensor map. Does not synchronise.
extern "C" int shf_conv3x3_fp32(const float* x, long long stride_w, long long stride_h,
                                long long stride_b, const float* w, long long w_so,
                                long long w_sc, long long w_sy, long long w_sx, uint32_t* wsplit,
                                const float* bias, float* out, int B, int H, int W, int C, int O,
                                int dilation, int row0, int Ho, int relu, int tile_h, int tile_w,
                                int block_n, void* stream) {
  int tw_shift = 0;
  while (tw_shift < 8 && (1 << tw_shift) < tile_w) ++tw_shift;
  if (B < 0 || H < 0 || W < 0 || C <= 0 || O <= 0 || C % 64 || dilation < 1 || row0 < 0 ||
      Ho < 0 || row0 + Ho > H || tile_h * tile_w != BM || (1 << tw_shift) != tile_w ||
      tile_w < 8 || (block_n != 64 && block_n != 128) || O % block_n ||
      (stride_w | stride_h | stride_b) % 4 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wsplit) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * Ho * W;
  if (M == 0) return static_cast<int>(cudaSuccess);
  EncodeTiled encode = encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);

  Params p;
  p.H = H, p.W = W, p.C = C, p.O = O, p.d = dilation, p.row0 = row0, p.Ho = Ho;
  p.th = tile_h, p.tw = tile_w, p.tw_shift = tw_shift;
  p.tiles_x = (W + tile_w - 1) / tile_w;
  p.tiles_y = (Ho + tile_h - 1) / tile_h;
  p.n_tiles = O / block_n;
  const long long total = static_cast<long long>(B) * p.tiles_y * p.tiles_x * p.n_tiles;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.total = static_cast<int>(total);
  p.kc = C / BK, p.nk = 9 * p.kc;
  p.stage_bytes = A_BYTES + 2 * block_n * BK * 4;
  p.stages = (SMEM_BYTES - 1024) / p.stage_bytes;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  const int smem = p.stages * p.stage_bytes + 1024;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(stride_w) * 4,
                                 static_cast<cuuint64_t>(stride_h) * 4,
                                 static_cast<cuuint64_t>(stride_b) * 4};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(tile_w),
                              static_cast<cuuint32_t>(tile_h), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(9) * C, static_cast<cuuint64_t>(2) * O};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(9) * C * 4};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(block_n)};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<uint32_t*>(wsplit), wdim,
             wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_split = static_cast<long long>(O) * 9 * C;
  const long long split_blocks = (n_split + 255) / 256;
  const int cap = 4 * (sm_count() > 0 ? sm_count() : 1);
  split_weights_kernel<<<split_blocks < cap ? static_cast<int>(split_blocks) : cap, 256, 0, s>>>(
      w, w_so, w_sc, w_sy, w_sx, O, C, wsplit);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (block_n == 64)
    return relu ? launch<64, true>(xmap, wmap, bias, out, p, smem, s)
                : launch<64, false>(xmap, wmap, bias, out, p, smem, s);
  return relu ? launch<128, true>(xmap, wmap, bias, out, p, smem, s)
              : launch<128, false>(xmap, wmap, bias, out, p, smem, s);
}

extern "C" const char* shf_cuda_error_string(int e) {
  if (e >= ENCODE_FAILED) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
