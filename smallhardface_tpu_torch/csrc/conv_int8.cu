// A 3x3 convolution of int8 activations with int8 weights, int32 sums and a
// fused fp32 epilogue, for NVIDIA Hopper (sm_90a): the int8 serving mode's
// convolutions (TPU.PRECISION = "int8").
//
// Replaces the XLA int8 convolutions of the JAX package's int8 mode,
// smallhardface_tpu/models/layers.py:63 conv2d_int8 (the dynamic mode) and
// :117 conv2d_int8_chain (one link of the calibrated chain), which the JAX
// forward runs outside any Pallas kernel for stages 2-5, the fusion convs
// and the shared dilated head (models/detector.py:456-519). PyTorch has no
// int8 convolution on CUDA: its one int8 product, torch._int_mm, is a bare
// GEMM whose int32 output would go to device memory before a separate
// epilogue pass; here the requantization is fused into the product. Built
// by smallhardface_tpu_torch/ops/conv_int8.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -prec-div=true -ftz=false
// and called through ctypes; shf_conv3x3_int8 below is the whole interface.
// Nothing links libcuda: the tensor maps are encoded by libcuda's
// cuTensorMapEncodeTiled, which the CUDA runtime hands out by name at run
// time (cudaGetDriverEntryPoint).
//
// Semantics. out[b, y, x, o] for a zero-padded 3x3 correlation at dilation
// d (padding d):
//   acc = sum over (ky, kx, c) of x[b, y + (ky-1)d, x + (kx-1)d, c]
//         * w[o, ky, kx, c]                                (exact in int32)
//   t = float(acc) * scale[b * scale_stride + o]      (scale = s_in * s_w)
//   t = t + bias[o]
//   t = max(t, 0)                                            (RELU only)
//   fp32 out: t;  int8 out: clamp(rint(t / s_out), -127, 127)
// in the order the JAX functions write it. The three epilogues of the int8
// mode are template instances: a chain link (ReLU, int8 out), the chain's
// end (ReLU, fp32 out) and the dynamic mode (no ReLU, fp32 out; the caller
// applies the ReLU, as the JAX forward does). scale_stride is 0 for one
// scale vector (the calibrated mode) or O for one per image (the dynamic
// mode's per-image activation scale).
//
// Why it equals the plain version (ops/conv_int8.conv3x3_int8_reference:
// F.conv2d in float64, cast to int32, then the same fp32 ops) to the bit:
// |acc| <= 9 * C * 127 * 128 < 2^31, so the int32 sums are exact in any
// order (the tensor cores' int32 accumulation, the K steps in any order),
// as the float64 ones are (< 2^53); every epilogue operation is one IEEE
// fp32 operation: __int2float_rn for the cast, no fused multiply-add
// (-fmad=false, and __fmul_rn / __fadd_rn), a correctly rounded division
// (__fdiv_rn) and rintf, which rounds half to even like torch.round. Only
// the place of an accumulator in the registers depends on the design.
//
// Layouts. x (B, H, W, C) int8 (the port's channels_last int8 carrier),
// w (O, 3, 3, C) int8 (K contiguous per output channel, prebaked once per
// qstate), scale fp32, bias (O,) fp32, out (B, H, W, O) int8 or fp32; all
// contiguous and 16-byte aligned. C % 32 == 0 and O % 64 == 0 (the wrapper
// raises otherwise).
//
// What bounds it. An implicit GEMM of M = B*H*W pixels, N = O, K = 9*C:
// 2*M*N*K int8 operations against B*H*W*(C + O, or C + 4*O for fp32 out)
// bytes. At the int8 layers of the flagship model that is 768 (conv2_1)
// to 4608 (conv5) operations per byte, above the card's 590 int8
// operations per byte of device memory (1,979 dense int8 TOPS over
// 3.35 TB/s on an H100 SXM): the tensor cores bound it. Only the head's
// passes, which end in fp32 (128 -> 128 channels, 461 per byte), are
// bound by their bytes.
//
// Design: Hopper's path to the int8 tensor cores, wgmma on shared-memory
// tiles that TMA brings in.
// - Tiles. An output tile is 128 pixels, a TH x TW rectangle of ONE image
//   (1x128 .. 16x8, chosen per layer by the wrapper so that narrow levels
//   waste few pixels), by BN = 128 output channels (64 where O is not a
//   multiple of 128).
// - The A operand by TMA. x is a 4-D tensor map over (C, W, H, B). For tap
//   (ky, kx) the A tile is one box of BK channels x TW x TH x 1 at
//   (c0, x0 + (kx-1)d, y0 + (ky-1)d, b). TMA zero-fills coordinates
//   outside the tensor, negative ones included: that is the convolution's
//   zero padding at every dilation, so no thread computes an address or a
//   predicate. A K step is one chunk of BK = 32, 64 or 128 channels of one
//   tap, loaded with the matching 32/64/128-byte swizzle; the weight tile
//   comes from a 2-D map over (9*C, O) with the same swizzle. Both are
//   K-major, the one order wgmma takes s8 in.
// - The product. wgmma.mma_async m64nBNk32 .s32.s8.s8 from shared memory,
//   int32 accumulators in registers: two MMA warpgroups take 64 rows of
//   the tile each. One producer warp keeps a ring of up to 8 stages full
//   (mbarrier arrive.expect_tx; the MMA warpgroups release a stage when
//   the wgmma that read it has retired). A block is five warpgroups (640
//   threads, 96 registers each at launch); setmaxnreg gives 56 of the
//   producer warpgroup's to the MMA warpgroups (120 each).
// - A persistent grid: one block per SM walks the tiles, pixel tiles
//   outer and channel tiles inner, so the blocks that read one A tile run
//   together and share it in L2; the producer loads the next tile while
//   this one's sums are still in the epilogue.
// - The epilogue runs in two warpgroups of its own, beside the next
//   tile's products: the MMA warpgroups write their sums (wgmma's
//   accumulator layout: warp w of a warpgroup holds rows 16w .. 16w+15,
//   lane l rows l/4 and l/4 + 8, channels 8j + 2(l%4) + {0, 1}) into a
//   tile in shared memory (acc_full / acc_empty barriers) and go on; the
//   eight epilogue warps read it a row at a time, four channels a lane,
//   skip the pixels of a ragged tile beyond H or W, take one scale row per
//   tile (the tile lies in one image) and store each row as one coalesced
//   run. Left in the MMA warpgroups, the epilogue (about 20 instructions
//   an output) kept the tensor cores idle for much of each tile at 64
//   input channels (PERF.md section 6).
// - The requantize divides only where it must: t * fl(1 / s_out) rounds
//   to the same integer as t / s_out except within 2^-13 of a half-integer
//   (link_byte), and there exact sign tests in double decide
//   (requantize_near). The instance that divides every output instead
//   (LINK_DIV, on the same tiles) took 1.87x the device time over the
//   twelve chain links of the 1408x1872 level at batch 2 (5.94 against
//   3.17 ms; 2.8x at conv2_1) on an NVIDIA H100 80GB HBM3 at 700 W
//   (scripts/q1_vs_parent.py --requantize): the epilogue warpgroups, not
//   the tensor cores, set the pace of a tile.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;               // output pixels per tile
constexpr int MMA_WARPS = 8;          // two warpgroups that run wgmma
constexpr int EPI_WARPS = 8;          // two that run the epilogue
constexpr int NT = 640;               // and one whose first thread runs TMA
constexpr int MAX_STAGES = 8;
constexpr int SMEM_BYTES = 232448 - 1024;   // dynamic shared memory, a block
constexpr int ENCODE_FAILED = 100000;       // + the CUresult

struct Params {
  int H, W, C, O, d;
  int th, tw, tw_shift;       // tile rows and columns, log2(tw)
  int tiles_x, tiles_y, n_tiles, total;
  int bk, kc, nk;             // K step bytes, steps a tap, steps a tile
  int stages, stage_bytes;
  int scale_stride;
  float s_out, r_out;         // the output step and fl(1 / s_out)
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

// A K-major shared-memory matrix descriptor: rows of bk bytes in the
// bk-byte swizzle TMA wrote, 8-row groups 8 * bk bytes apart (SBO), the
// leading offset unused (1) as for every swizzled K-major layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int bk) {
  const uint64_t layout = bk == 128 ? 1 : bk == 64 ? 2 : 3;   // 128B, 64B, 32B swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * bk) >> 4) << 32) | (layout << 62);
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
// keeps the compiler from reading an accumulator before the wait above it
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// D (64 x BN, int32) += A (64 x 32 bytes) * B (BN x 32 bytes)^T; acc == 0
// overwrites D instead.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <bool RELU>
__device__ __forceinline__ float epilogue(int acc, float scale, float bias) {
  float t = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  if (RELU) t = fmaxf(t, 0.0f);
  return t;
}

__device__ __forceinline__ signed char requantize(float t, float s_out) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(t, s_out)), -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(q));
}

// requantize(t, s_out) for an element link_byte was unsure of, with
// s_out positive and normal in [2^-60, 2^60] (the launcher sends any other
// step to the division instance), without a division or a call. q is
// within 2^-12 of a half-integer m, and so is fl(t / s_out): its rint is
// m + 1/2 if fl(t / s_out) > m, m - 1/2 if it is < m, and rint(m) (the even
// neighbour) if it is m. fl(t / s_out) > m exactly where t / s_out lies
// above the midpoint hi of m and the next float up (it never lies on it:
// hi's odd part has 25 bits, so hi * s_out is no float t), and < m where
// it lies below the midpoint lo under m. The sign of t / s_out - hi is
// that of t - hi * s_out, which double arithmetic gives exactly: hi has 25
// significant bits, so hi * s_out is exact, and the rounded difference
// keeps its sign. A NaN q (t NaN) clamps to -127, as in requantize.
__device__ __forceinline__ signed char requantize_near(float t, float s_out, float r_out) {
  const float q = __fmul_rn(t, r_out);
  float v = q;
  if (q == q) {
    const float n = rintf(q);
    const float m = q > n ? __fadd_rn(n, 0.5f) : __fsub_rn(n, 0.5f);
    const unsigned bits = __float_as_uint(m);
    const double up = __uint_as_float(m > 0.0f ? bits + 1 : bits - 1);
    const double down = __uint_as_float(m > 0.0f ? bits - 1 : bits + 1);
    const double hi = 0.5 * (static_cast<double>(m) + up);
    const double lo = 0.5 * (static_cast<double>(m) + down);
    if (__dsub_rn(t, __dmul_rn(hi, s_out)) > 0.0)
      v = __fadd_rn(m, 0.5f);
    else if (__dsub_rn(t, __dmul_rn(lo, s_out)) < 0.0)
      v = __fsub_rn(m, 0.5f);
    else
      v = rintf(m);
  }
  return static_cast<signed char>(__float2int_rn(fminf(fmaxf(v, -127.0f), 127.0f)));
}

// The epilogue instances: a chain link (ReLU, int8 out), the chain's end
// (ReLU, fp32 out), the dynamic mode (fp32 out, no ReLU), and a chain link
// that divides every element (for a step outside requantize_near's range).
enum Epilogue { LINK = 0, END = 1, DYNAMIC = 2, LINK_DIV = 3 };

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

// requantize(t, s_out) as the byte of a chain link's output, without the
// division where that is provably the same, for r_out = fl(1 / s_out)
// (both normal): q = fl(t * r_out) is within |t / s_out| * (1.5 * 2^-23 +
// 2^-48) < |q| * 2^-22 of the correctly rounded quotient fl(t / s_out) (two
// roundings against one, while q is a normal number). Where q lies further
// than |q| * 2^-20 + 2^-24 from every half-integer (the 2^-24 covers the
// rounding of 0.5 - |q - rint(q)|; |q - rint(q)| itself is exact),
// fl(t / s_out) lies strictly between the same two half-integers, so rint
// of either is the same integer; where |q| >= 128 both clamp to the same
// end of the grid. Elsewhere (within 2^-13 of a half-integer, or q NaN)
// `unsure` is set and the caller redoes the element with requantize_near.
// All on the FP32 pipe: rint(q) as (q + 1.5 * 2^23) - 1.5 * 2^23 (exact for
// |q| < 2^22, and beyond +-127 wherever |q| is larger, which the clamp then
// takes), the clamped integer as the low byte of its sum with 1.5 * 2^23.
__device__ __forceinline__ uint32_t link_byte(float t, float r_out, bool& unsure) {
  constexpr float ROUND = 12582912.0f;
  const float q = __fmul_rn(t, r_out);
  const float n = __fsub_rn(__fadd_rn(q, ROUND), ROUND);
  const float edge = __fsub_rn(0.5f, fabsf(__fsub_rn(q, n)));
  unsure = !(edge > __fadd_rn(__fmul_rn(fabsf(q), 0x1p-20f), 0x1p-24f) || fabsf(q) >= 128.0f);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(n, -127.0f), 127.0f), ROUND)) & 0xffu;
}

// The bytes of `word` that link_byte was unsure of (bit e of `unsure` for
// byte e, the output of v[e]), redone by requantize_near. Out of line: it
// runs for about one output in 10^4.
__device__ __noinline__ uint32_t link_near(uint32_t word, float4 v, uint32_t unsure, float s_out,
                                           float r_out) {
  const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (unsure >> e & 1u)
      word = (word & ~(0xffu << (8 * e))) |
             (static_cast<uint32_t>(static_cast<uint8_t>(requantize_near(vs[e], s_out, r_out)))
              << (8 * e));
  return word;
}

template <int BN, int BK, int EPI>
__global__ void __launch_bounds__(NT, 1)
conv3x3_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                    const float* __restrict__ bias, void* __restrict__ out, const Params p) {
  constexpr bool RELU = EPI != DYNAMIC;
  // the accumulator tile: BM rows of BN int32, BN + 8 words apart, so that
  // the MMA warps' 8-byte stores (4 rows a half warp) fall in distinct banks
  constexpr int ACC_LD = BN + 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES], acc_full, acc_empty;
  // stage s: the A box (BM rows of BK bytes) then the weight box (BN rows),
  // each on a 1024-byte boundary (the 128-byte swizzle's period); then the
  // accumulator tile
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  int* const acc_tile = reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) +
                                               p.stages * p.stage_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), MMA_WARPS);
    }
    mbar_init(smem_u32(&acc_full), MMA_WARPS * 32);
    mbar_init(smem_u32(&acc_empty), EPI_WARPS * 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= MMA_WARPS + EPI_WARPS) {
    // ---- the producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == (MMA_WARPS + EPI_WARPS) * 32) {
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
          tma_load_4d(a, &xmap, bar, c0, tile.x0 + (kx - 1) * p.d, tile.y0 + (ky - 1) * p.d,
                      tile.b);
          tma_load_2d(a + BM * BK, &wmap, bar, tap * p.C + c0, tile.n0);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (warp < MMA_WARPS) {
    // ---- two MMA warpgroups: rows 64 * wg .. 64 * wg + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 120;\n");
    const int wg = warp >> 2;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0, acc_phase = 0;
    for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
      int last = 0;
      for (int k = 0; k < p.nk; ++k) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t a = base + stage * p.stage_bytes + wg * 64 * BK;
        const uint32_t b = base + stage * p.stage_bytes + BM * BK;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, smem_desc(a + 32 * kk, BK), smem_desc(b + 32 * kk, BK),
                       (k | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();            // the step before this one has retired
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        if (k > 0 && lane == 0) mbar_arrive(smem_u32(&empty[last]));
        last = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(smem_u32(&empty[last]));
      // hand the sums to the epilogue warpgroup once it has read the last
      // tile's: lane l of warp w holds rows 16w + l/4 (+8) of this
      // warpgroup's 64, channels 8j + 2(l%4) + {0, 1}
      mbar_wait(smem_u32(&acc_empty), acc_phase ^ 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2) + h * 8;
          *reinterpret_cast<int2*>(acc_tile + r * ACC_LD + j * 8 + 2 * (lane & 3)) =
              make_int2(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1]);
        }
      mbar_arrive(smem_u32(&acc_full));
      acc_phase ^= 1;
    }
  } else {
    // ---- two epilogue warpgroups: while the MMA warpgroups run the next
    // tile, each of their warps takes rows of this one, BN / 4 lanes a row
    // and four channels a lane, so that a row leaves in one coalesced run
    // of BN bytes (int8) or 4 * BN bytes (fp32) ----
    constexpr int LANES = BN / 4, ROWS = 32 / LANES;
    const int e = warp - MMA_WARPS, c = (lane % LANES) * 4;
    uint32_t acc_phase = 0;
    for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
      const Tile tile = decode(p, t, BN);
      const float4 s4 = *reinterpret_cast<const float4*>(
          scale + static_cast<size_t>(tile.b) * p.scale_stride + tile.n0 + c);
      const float4 b4 = *reinterpret_cast<const float4*>(bias + tile.n0 + c);
      mbar_wait(smem_u32(&acc_full), acc_phase);
#pragma unroll 2
      for (int r0 = e * ROWS; r0 < BM; r0 += EPI_WARPS * ROWS) {
        const int r = r0 + lane / LANES;
        const int4 a4 = *reinterpret_cast<const int4*>(acc_tile + r * ACC_LD + c);
        const int y = tile.y0 + (r >> p.tw_shift), x = tile.x0 + (r & (p.tw - 1));
        if (y >= p.H || x >= p.W) continue;
        const size_t o = ((static_cast<size_t>(tile.b) * p.H + y) * p.W + x) * p.O + tile.n0 + c;
        const float v0 = epilogue<RELU>(a4.x, s4.x, b4.x), v1 = epilogue<RELU>(a4.y, s4.y, b4.y);
        const float v2 = epilogue<RELU>(a4.z, s4.z, b4.z), v3 = epilogue<RELU>(a4.w, s4.w, b4.w);
        if (EPI == LINK) {
          bool u0, u1, u2, u3;
          uint32_t word = link_byte(v0, p.r_out, u0) | link_byte(v1, p.r_out, u1) << 8 |
                          link_byte(v2, p.r_out, u2) << 16 | link_byte(v3, p.r_out, u3) << 24;
          const uint32_t unsure = u0 | u1 << 1 | u2 << 2 | u3 << 3;
          if (unsure)
            word = link_near(word, make_float4(v0, v1, v2, v3), unsure, p.s_out, p.r_out);
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) = word;
        } else if (EPI == LINK_DIV) {
          *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + o) =
              make_char4(requantize(v0, p.s_out), requantize(v1, p.s_out),
                         requantize(v2, p.s_out), requantize(v3, p.s_out));
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = make_float4(v0, v1, v2, v3);
        }
      }
      mbar_arrive(smem_u32(&acc_empty));
      acc_phase ^= 1;
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

CUtensorMapSwizzle swizzle(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int BN, int BK, int EPI>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* scale,
           const float* bias, void* out, const Params& p, int smem, cudaStream_t s) {
  auto kernel = conv3x3_int8_kernel<BN, BK, EPI>;
  // once per instance, before any capture: the dynamic shared memory
  // limit, and a check that the block starts with the registers that
  // setmaxnreg moves (a smaller start would leave the MMA warpgroups
  // waiting for registers that never come)
  static const cudaError_t ready = [kernel] {
    cudaFuncAttributes f;
    cudaError_t e = cudaFuncGetAttributes(&f, kernel);
    if (e == cudaSuccess && f.numRegs * NT < 40 * 128 + 120 * 256 + f.numRegs * EPI_WARPS * 32)
      e = cudaErrorLaunchOutOfResources;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    return e;
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int grid = p.total < sm_count() ? p.total : sm_count();
  kernel<<<grid, NT, smem, s>>>(xmap, wmap, scale, bias, out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int BK>
int dispatch(int epi, const CUtensorMap& xmap, const CUtensorMap& wmap, const float* scale,
             const float* bias, void* out, const Params& p, int smem, cudaStream_t s) {
  switch (epi) {
    case LINK: return launch<BN, BK, LINK>(xmap, wmap, scale, bias, out, p, smem, s);
    case END: return launch<BN, BK, END>(xmap, wmap, scale, bias, out, p, smem, s);
    case DYNAMIC: return launch<BN, BK, DYNAMIC>(xmap, wmap, scale, bias, out, p, smem, s);
    case LINK_DIV: return launch<BN, BK, LINK_DIV>(xmap, wmap, scale, bias, out, p, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BN>
int dispatch(int epi, const CUtensorMap& xmap, const CUtensorMap& wmap, const float* scale,
             const float* bias, void* out, const Params& p, int smem, cudaStream_t s) {
  switch (p.bk) {
    case 32: return dispatch<BN, 32>(epi, xmap, wmap, scale, bias, out, p, smem, s);
    case 64: return dispatch<BN, 64>(epi, xmap, wmap, scale, bias, out, p, smem, s);
    default: return dispatch<BN, 128>(epi, xmap, wmap, scale, bias, out, p, smem, s);
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t). `epilogue` selects the
// instance: 0 = ReLU and int8 out (a chain link, onto s_out's grid),
// 1 = ReLU and fp32 out (the chain's end), 2 = fp32 out without ReLU (the
// dynamic mode), 3 = a chain link that divides every element (which a
// chain link whose s_out lies outside [2^-60, 2^60] runs too). The tile:
// tile_h x tile_w pixels (tile_h * tile_w = 128, tile_w a power of two
// from 8 to 128), block_n output channels (64 or 128, dividing O),
// k_chunk channels a K step (32, 64 or 128, dividing C);
// ops/conv_int8.py:plan chooses them. Returns a cudaError_t (0 on a
// successful launch), or ENCODE_FAILED + the CUresult where libcuda
// refused a tensor map. Does not synchronise.
extern "C" int shf_conv3x3_int8(const int8_t* x, const int8_t* w, const float* scale,
                                int scale_stride, const float* bias, int B, int H, int W,
                                int C, int O, int dilation, int epilogue, float s_out,
                                void* out, int tile_h, int tile_w, int block_n, int k_chunk,
                                void* stream) {
  int tw_shift = 0;
  while (tw_shift < 8 && (1 << tw_shift) < tile_w) ++tw_shift;
  if (B < 0 || H < 0 || W < 0 || C <= 0 || O <= 0 || dilation < 1 || epilogue < LINK ||
      epilogue > LINK_DIV || tile_h * tile_w != BM ||
      (1 << tw_shift) != tile_w || tile_w < 8 ||
      (k_chunk != 32 && k_chunk != 64 && k_chunk != 128) || C % k_chunk ||
      (block_n != 64 && block_n != 128) || O % block_n ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * H * W;
  if (M == 0) return static_cast<int>(cudaSuccess);
  EncodeTiled encode = encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);

  Params p;
  p.H = H, p.W = W, p.C = C, p.O = O, p.d = dilation;
  p.th = tile_h, p.tw = tile_w, p.tw_shift = tw_shift;
  p.tiles_x = (W + tile_w - 1) / tile_w;
  p.tiles_y = (H + tile_h - 1) / tile_h;
  p.n_tiles = O / block_n;
  const long long total = static_cast<long long>(B) * p.tiles_y * p.tiles_x * p.n_tiles;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.total = static_cast<int>(total);
  p.scale_stride = scale_stride;
  p.s_out = s_out;
  p.r_out = 1.0f / s_out;
  // link_byte and requantize_near hold for a positive normal step in
  // [2^-60, 2^60]; any other goes to the instance that divides
  if (epilogue == LINK && !(s_out >= 0x1p-60f && s_out <= 0x1p60f)) epilogue = LINK_DIV;
  // the ring takes what the accumulator tile leaves, up to MAX_STAGES
  p.bk = k_chunk, p.kc = C / k_chunk, p.nk = 9 * p.kc;
  p.stage_bytes = (BM + block_n) * k_chunk;
  const int acc_bytes = BM * (block_n + 8) * 4;
  p.stages = (SMEM_BYTES - 1024 - acc_bytes) / p.stage_bytes;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  const int smem = p.stages * p.stage_bytes + acc_bytes + 1024;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W) * C,
                                 static_cast<cuuint64_t>(H) * W * C};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(k_chunk), static_cast<cuuint32_t>(tile_w),
                              static_cast<cuuint32_t>(tile_h), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(k_chunk),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(9) * C, static_cast<cuuint64_t>(O)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(9) * C};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(k_chunk),
                              static_cast<cuuint32_t>(block_n)};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(k_chunk),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(r);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return block_n == 64 ? dispatch<64>(epilogue, xmap, wmap, scale, bias, out, p, smem, s)
                       : dispatch<128>(epilogue, xmap, wmap, scale, bias, out, p, smem, s);
}

extern "C" const char* shf_cuda_error_string(int e) {
  if (e >= ENCODE_FAILED) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
