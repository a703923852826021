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
// order, as the float64 ones are (< 2^53); every epilogue operation is one
// IEEE fp32 operation: __int2float_rn for the cast, no fused multiply-add
// (-fmad=false, and __fmul_rn / __fadd_rn), a correctly rounded division
// (__fdiv_rn) and rintf, which rounds half to even like torch.round.
//
// Layouts. x (B, H, W, C) int8 (the port's channels_last int8 carrier),
// w (O, 3, 3, C) int8 (K contiguous per output channel, prebaked once per
// qstate), scale fp32, bias (O,) fp32, out (B, H, W, O) int8 or fp32; all
// contiguous. C % 32 == 0 and O % 64 == 0 (the wrapper raises otherwise).
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
// Design (a simple kernel that is right, not yet a fast one). A block of
// 128 threads computes 128 pixels x 64 output channels; four warps as
// 2 x 2, each 64 x 32 as 4 x 4 mma.sync.m16n8k32 s8 tiles with int32
// accumulators in registers. K runs over the nine taps and, within a tap,
// 32 channels at a time: the 128 x 32-byte pixel tile (one 16-byte
// cp.async pair per thread; a tap outside the image or a pixel beyond M is
// zero-filled with a source size of 0) and the 64 x 32-byte weight tile
// stream into shared memory in a three-stage cp.async ring. Rows are 48
// bytes apart, so the ldmatrix fragment loads hit 32 distinct banks. The
// epilogue reads the accumulators and writes two channels per store. The
// blocks walk the output channel tiles fastest, so the O/64 blocks that
// read one pixel tile run together and share it in L2. A fast kernel
// (wgmma with TMA, a persistent grid, the mask and the 2x2 pool fused into
// the epilogue) is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;     // output pixels per block
constexpr int BN = 64;      // output channels per block
constexpr int BK = 32;      // bytes of K (channels of one tap) per stage
constexpr int LDS = 48;     // shared-memory row stride, bytes
constexpr int STAGES = 3;
constexpr int NT = 128;     // threads per block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

template <bool OUT_INT8, bool RELU>
__global__ void __launch_bounds__(NT)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, int scale_stride,
                    const float* __restrict__ bias, int B, int H, int W, int C, int O,
                    int d, float s_out, void* __restrict__ out) {
  __shared__ __align__(16) int8_t sa[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t sb[STAGES][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n_tiles = O / BN;
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;

  // the pixel tile row this thread copies: pixel m0 + tid, 32 bytes
  const long long am = m0 + tid;
  const bool a_in = am < M;
  int ab = 0, ay = 0, ax = 0;
  if (a_in) {
    const long long hw = static_cast<long long>(H) * W;
    ab = static_cast<int>(am / hw);
    const int r = static_cast<int>(am - ab * hw);
    ay = r / W;
    ax = r - ay * W;
  }
  // the weight tile row this thread copies: channel n0 + tid / 2, half tid % 2
  const int8_t* w_row = w + static_cast<size_t>(n0 + (tid >> 1)) * 9 * C + (tid & 1) * 16;
  int8_t* const a_dst = &sa[0][tid * LDS];
  int8_t* const b_dst = &sb[0][(tid >> 1) * LDS + (tid & 1) * 16];

  const int kc = C / BK;   // channel chunks per tap
  const int nk = 9 * kc;

  auto load = [&](int stage, int k) {
    const int tap = k / kc, c0 = (k - tap * kc) * BK;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int iy = ay + (ky - 1) * d, ix = ax + (kx - 1) * d;
    const bool ok = a_in && iy >= 0 && iy < H && ix >= 0 && ix < W;
    const int8_t* src =
        ok ? x + ((static_cast<size_t>(ab) * H + iy) * W + ix) * C + c0 : x;
    int8_t* dst = a_dst + stage * (BM * LDS);
    cp_async16(dst, src, ok ? 16 : 0);
    cp_async16(dst + 16, ok ? src + 16 : x, ok ? 16 : 0);
    cp_async16(b_dst + stage * (BN * LDS), w_row + tap * C + c0, 16);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  // ldmatrix addresses: lane l gives row l % 8 of matrix l / 8
  const int mat = lane >> 3, mrow = lane & 7;
  // A (16 x 32 bytes per m tile): matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31)
  const int a_off = (wm * 64 + mrow + (mat & 1) * 8) * LDS + (mat >> 1) * 16;
  // B (two n tiles of 8 x 32 bytes): matrices (tile j, bytes 0-15 | 16-31)
  const int b_off = (wn * 32 + (mat >> 1) * 8 + mrow) * LDS + (mat & 1) * 16;

  for (int k = 0; k < nk; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage read in iteration k - 1 is free now: refill it
    const int next = k + STAGES - 1;
    if (next < nk) load(next % STAGES, next);
    cp_async_commit();

    const int8_t* as = sa[k % STAGES];
    const int8_t* bs = sb[k % STAGES];
    unsigned bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      unsigned r[4];
      ldmatrix_x4(r, bs + b_off + j * 8 * LDS);
      bf[j][0] = r[0];
      bf[j][1] = r[1];
      bf[j + 1][0] = r[2];
      bf[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned af[4];
      ldmatrix_x4(af, as + a_off + i * 16 * LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: lane (g, t) holds rows g and g + 8, channels 2t and 2t + 1
  const int g = lane >> 2, t = lane & 3;
  const long long hw = static_cast<long long>(H) * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float* sc = scale + static_cast<size_t>(m / hw) * scale_stride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        const float v0 = epilogue<RELU>(acc[i][j][half * 2], sc[n], bias[n]);
        const float v1 = epilogue<RELU>(acc[i][j][half * 2 + 1], sc[n + 1], bias[n + 1]);
        const size_t o = static_cast<size_t>(m) * O + n;
        if (OUT_INT8) {
          char2 q;
          q.x = requantize(v0, s_out);
          q.y = requantize(v1, s_out);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = q;
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t). `epilogue` selects the
// instance: 0 = ReLU and int8 out (a chain link, onto s_out's grid),
// 1 = ReLU and fp32 out (the chain's end), 2 = fp32 out without ReLU (the
// dynamic mode). Returns a cudaError_t: 0 on a successful launch. Does not
// synchronise.
extern "C" int shf_conv3x3_int8(const int8_t* x, const int8_t* w, const float* scale,
                                int scale_stride, const float* bias, int B, int H, int W,
                                int C, int O, int dilation, int epilogue, float s_out,
                                void* out, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C <= 0 || O <= 0 || C % BK || O % BN || dilation < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * H * W;
  if (M == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (M + BM - 1) / BM * (O / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0:
      conv3x3_int8_kernel<true, true><<<grid, NT, 0, s>>>(x, w, scale, scale_stride, bias, B,
                                                          H, W, C, O, dilation, s_out, out);
      break;
    case 1:
      conv3x3_int8_kernel<false, true><<<grid, NT, 0, s>>>(x, w, scale, scale_stride, bias, B,
                                                           H, W, C, O, dilation, s_out, out);
      break;
    case 2:
      conv3x3_int8_kernel<false, false><<<grid, NT, 0, s>>>(x, w, scale, scale_stride, bias,
                                                            B, H, W, C, O, dilation, s_out, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
