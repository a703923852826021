// Fused VGG stem for NVIDIA Hopper (sm_90a):
//   out = maxpool2x2(relu(conv3x3(mask(relu(conv3x3(mask(x), w1) + b1)), w2) + b2))
// and, where the caller asks, the pool's routing for the backward (K2).
//
// Replaces the TPU kernel smallhardface_tpu/ops/pallas_stem.py:_kernel
// (forward only). Built by smallhardface_tpu_torch/ops/stem.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the plain C entry point below is the whole
// interface.
//
// Layouts. x: NHWC (B, H, W, 3) fp32, contiguous. w1: HWIO (3, 3, 3, 64),
// i.e. a (27, 64) matrix with rows ordered (dy, dx, ci). w2: HWIO
// (3, 3, 64, 64), i.e. 9 taps of a (64 ci, 64 co) matrix. wsplit: scratch
// of W2_SPLIT 32-bit words, w2 cut into TF32 halves in mma fragment order.
// out: NHWC (B, H/2, W/2, 64) fp32. route: null, or NHWC (B, H/2, W/2, 64)
// uint8. H and W must be even (the launcher refuses odd sizes); any even
// size works, ragged tiles are masked.
//
// Masking. Positions outside [0, min(H, vh)) x [0, min(W, vw)) read as exact
// zeros, both in the input and in the conv1_1 activations that conv1_2
// reads: the reference network's implicit zero padding, so the conv1_2 halo
// holds 0 and not relu(b1). Output positions beyond the valid extent are
// computed from those zeros and are not meaningful. Where extents is not
// null, image b takes its own (vh, vw) from extents[2b], extents[2b + 1]
// (an int32 (B, 2) array on the device) and the scalar vh, vw are not
// read: one launch serves a bucketed detection batch whose images have
// different extents, with the same arithmetic as one launch per image.
//
// Routing (the contract with K2, csrc/stem_grad.cu). Where route is not
// null, route[b][q][p][co] says where the pool's gradient goes in window
// (2q .. 2q+1) x (2p .. 2p+1): 0..3 is the row-major index of the FIRST
// maximal element of relu(conv1_2), if that element's pre-activation is
// > 0; 4 means no element takes a gradient (all four are <= 0). These are
// the semantics of autograd through max_pool2d and ReLU, and of
// ops/stem.py:fused_stem_route_reference. K2 scatters dy by it and never
// recomputes conv1_2, so the two kernels share no conv1_2 arithmetic. They
// do share conv1_1: K2 recomputes it for its c1 > 0 mask and its dw2, with
// conv1_1_tile below, a copy of the one in stem_grad.cu that must stay the
// same fmaf by fmaf.
//
// Rounding. conv1_1 is fp32 on the CUDA cores (fmaf) and kept in fp32.
// conv1_2 runs on the tensor cores in error-compensated TF32 ("3xTF32"):
// mma reads 19 bits of an fp32 operand, so each operand a is cut into
// hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi) (the subtraction is
// exact), and each product takes a_lo*b_hi, a_hi*b_lo and a_hi*b_hi into
// the fp32 accumulator (lo*lo is dropped), keeping about 22 bits of each
// operand. The tensor cores may round a sum toward zero, so each
// accumulator runs for one tap (K = 64) and is then added in fp32, rounded
// to nearest, to a second sum. Small integers (|a| < 2^11) are their own
// hi, so on the integer recipe of the tests every product and every sum
// below 2^24 is exact and the output and the routing equal the plain
// version's to the bit; on floats the output agrees with an fp32 PyTorch
// reference to about 1e-6 of its peak. The TPU kernel fed its dots bf16;
// that was a matrix-unit artefact.
//
// What bounds it. Written as three passes the stem is bound by device
// memory (conv1_1 and conv1_2 each a (B, H, W, 64) fp32 tensor); fused, it
// reads the 3-channel input once and writes the pooled output (0.12 ms at
// 2x1408x1872), and what is left is arithmetic: 3,456 FLOP a pixel of
// conv1_1 on the CUDA cores (67 TFLOP/s) and 73,728 of conv1_2, taken three
// times as TF32 products (495 TFLOP/s). At 2x1408x1872 that is
// 0.27 + 2.36 = 2.63 ms; all in fp32 on the CUDA cores it would be 6.07 ms.
//
// Design. One block of 256 threads per (image, 8-row strip, 32-column
// tile), one block per SM (about 170 KB of shared memory). The block
//   0. starts copying tap 0 of the split w2 (32 KB, cp.async) into the
//      first of two tap buffers;
//   1. loads its haloed input tile (12 x 36 pixels, 4 floats each), w1 and
//      the biases into shared memory, the input masked;
//   2. computes the 10 x 34 x 64 conv1_1 tile into shared memory, zeroed
//      outside the tensor and the valid extent (pixel stride 68 floats, so
//      that A-fragment loads hit 32 distinct banks);
//   3. runs conv1_2 as an implicit GEMM on the tensor cores: M = the tile's
//      256 pixels, N = 64 output channels, K = 9 taps x 64 input channels,
//      mma.sync.m16n8k8 in 3xTF32. Tap t+1's split weights load with
//      cp.async into the other buffer while tap t multiplies. Warp w owns
//      the row pair 2(w%4), 2(w%4)+1 and 16 columns from 16(w/4), as two
//      m-tiles of 2 rows x 8 columns (fragment row r*8 + c), times eight
//      8-channel n-tiles;
//   4. adds b2, applies ReLU and pools from the C fragments: a pool
//      window's two rows are one thread's c0/c2 (c1/c3), its two columns
//      lanes 4 apart (__shfl_xor_sync), so the pool and its routing need no
//      shared-memory round trip. The left lane of a window writes channel
//      tiles 0-3, the right lane 4-7.
// A small kernel first cuts w2 into TF32 hi/lo fragments, once per call.
// Blocks are independent: no order between them is assumed.
//
// Next step: wgmma with the A operand from shared memory and TMA for the
// tap buffers, in warp-specialised producer/consumer form; mma.sync keeps
// the tensor cores well below their peak, and the fragment loads from
// shared memory are a large share of the issue slots.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;                   // output rows per block
constexpr int TW = 32;                  // output columns per block
constexpr int C = 64;                   // stem channels
constexpr int NT = 256;                 // threads: 8 warps
constexpr int XR = TH + 4, XC = TW + 4; // haloed input tile
constexpr int CR = TH + 2, CC = TW + 2; // haloed conv1_1 tile
constexpr int CS = C + 4;               // conv1_1 pixel stride: A fragments conflict-free
constexpr int C1_FLOATS = CR * CC * CS;
constexpr int XS_FLOATS = XR * XC * 4;  // 4 floats a pixel: one 16-byte load
constexpr int W1_FLOATS = 27 * C;
constexpr int TAP_WORDS = C * C * 2;    // one tap of w2 as hi and lo
constexpr int W2_SPLIT = 9 * TAP_WORDS;
constexpr size_t SMEM_BYTES =
    (C1_FLOATS + 2 * TAP_WORDS + XS_FLOATS + W1_FLOATS + 2 * C) * sizeof(float);

static_assert(NT == 32 * 8 && TH == 8 && TW == 32,
              "warp w owns rows 2(w%4)..+1 and columns 16(w/4)..+15");
static_assert((C1_FLOATS * sizeof(float)) % 16 == 0 && CS % 32 == 4,
              "16-byte aligned tap buffers, pixel stride 4 mod 32 banks");
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on Hopper");
static_assert(NT % C == 0, "conv1_1: a thread owns one channel");

// ---- TF32 on the tensor cores (as in stem_grad.cu) ----

// round to nearest, ties away from zero, to TF32 (an fp32 pattern whose
// low 13 bits are 0)
__device__ __forceinline__ unsigned tf32_rna(float a) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo + (what lo's own rounding drops); a - hi is exact
__device__ __forceinline__ void split_tf32(float a, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += A (16x8, row) * B (8x8, col). With g = lane / 4, t = lane % 4:
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b0 = B[t][g],
// b1 = B[t+4][g], d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory to shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- conv1_1, the arithmetic K1 and K2 share (keep equal to stem_grad.cu) ----

// The haloed input tile (rows r0-2 .. r0+TH+1, cols c0-2 .. c0+TW+1, zero
// outside [0, rl) x [0, cl)), 4 floats a pixel (the fourth 0), w1 and b1
// into shared memory.
__device__ __forceinline__ void load_stem_inputs(const float* __restrict__ xb,
                                                 const float* __restrict__ w1,
                                                 const float* __restrict__ b1, float* xs,
                                                 float* w1s, float* b1s, int W, int r0,
                                                 int c0, int rl, int cl, int tid) {
  for (int i = tid; i < XS_FLOATS; i += NT) {
    const int ci = i % 4, p = i / 4;
    const int gr = r0 - 2 + p / XC, gc = c0 - 2 + p % XC;
    float v = 0.f;
    if (ci < 3 && gr >= 0 && gr < rl && gc >= 0 && gc < cl)
      v = xb[((size_t)gr * W + gc) * 3 + ci];
    xs[i] = v;
  }
  for (int i = tid; i < W1_FLOATS; i += NT) w1s[i] = w1[i];
  if (tid < C) b1s[tid] = b1[tid];
}

// conv1_1 + ReLU at rows r0-1 .. r0+TH, cols c0-1 .. c0+TW: tile position
// p = r * CC + c, channel co goes to dst[p * STRIDE + co], zero outside
// [0, rl) x [0, cl). Each value is b1 then 27 fmaf in (ky, kx, ci) order.
// Thread tid owns channel tid % 64 (its 27 weights in registers) and every
// fourth position from tid / 64; a warp's lanes share the position, so
// each input pixel is one broadcast 16-byte load.
template <int STRIDE>
__device__ __forceinline__ void conv1_1_tile(const float* xs, const float* w1s,
                                             const float* b1s, float* dst, int r0, int c0,
                                             int rl, int cl, int tid) {
  const int co = tid % C;
  float w[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) w[k] = w1s[k * C + co];
  const float bias = b1s[co];
  for (int p = tid / C; p < CR * CC; p += NT / C) {
    const int r = p / CC, c = p % CC;
    const int gr = r0 - 1 + r, gc = c0 - 1 + c;
    float v = 0.f;
    if (gr >= 0 && gr < rl && gc >= 0 && gc < cl) {
      float acc = bias;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 a = *reinterpret_cast<const float4*>(xs + ((r + ky) * XC + c + kx) * 4);
          const float* wk = w + (ky * 3 + kx) * 3;
          acc = fmaf(a.x, wk[0], acc);
          acc = fmaf(a.y, wk[1], acc);
          acc = fmaf(a.z, wk[2], acc);
        }
      v = fmaxf(acc, 0.f);
    }
    dst[p * STRIDE + co] = v;
  }
}

// ---- conv1_2 on the tensor cores ----

// wsplit[tap][ks][nt][lane] = (b0 hi, b1 hi, b0 lo, b1 lo) of the B
// fragment of k-step ks (ci 8ks..8ks+7) and n-tile nt (co 8nt..8nt+7):
// b0 = w2[tap][8ks + t][8nt + g], b1 = w2[tap][8ks + t + 4][8nt + g].
__global__ void split_w2_kernel(const float* __restrict__ w2, uint4* __restrict__ wsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W2_SPLIT / 4) return;
  const int lane = i & 31, nt = (i >> 5) & 7, ks = (i >> 8) & 7, tap = i >> 11;
  const int g = lane >> 2, t = lane & 3;
  const float* w = w2 + (size_t)tap * C * C + (ks * 8 + t) * C + nt * 8 + g;
  unsigned h0, l0, h1, l1;
  split_tf32(w[0], h0, l0);
  split_tf32(w[4 * C], h1, l1);
  wsplit[i] = make_uint4(h0, h1, l0, l1);
}

__device__ __forceinline__ void stage_tap(unsigned* dst, const unsigned* __restrict__ wsplit,
                                          int tap, int tid) {
  const unsigned* src = wsplit + (size_t)tap * TAP_WORDS;
  for (int i = tid; i < TAP_WORDS / 4; i += NT) cp_async16(dst + 4 * i, src + 4 * i);
}

__global__ void __launch_bounds__(NT, 1)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const unsigned* __restrict__ wsplit,
            const float* __restrict__ b2, float* __restrict__ out,
            unsigned char* __restrict__ route, int H, int W, int vh, int vw,
            const int* __restrict__ extents) {
  extern __shared__ __align__(16) float smem[];
  float* c1s = smem;                                              // [CR * CC][CS]
  unsigned* wbuf = reinterpret_cast<unsigned*>(smem + C1_FLOATS); // 2 taps
  float* xs = smem + C1_FLOATS + 2 * TAP_WORDS;                   // [XR][XC][4]
  float* w1s = xs + XS_FLOATS;                                    // [27][64]
  float* b1s = w1s + W1_FLOATS;
  float* b2s = b1s + C;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int rl = min(H, extents ? extents[2 * b] : vh);
  const int cl = min(W, extents ? extents[2 * b + 1] : vw);

  // 0-2. tap 0's weights load while the input tile and conv1_1 are made
  stage_tap(wbuf, wsplit, 0, tid);
  cp_async_commit();
  load_stem_inputs(x + (size_t)b * H * W * 3, w1, b1, xs, w1s, b1s, W, r0, c0, rl, cl, tid);
  if (tid < C) b2s[tid] = b2[tid];
  __syncthreads();
  conv1_1_tile<CS>(xs, w1s, b1s, c1s, r0, c0, rl, cl, tid);

  // 3. conv1_2: A[pixel][ci] = conv1_1 at the pixel shifted by the tap
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int pr = 2 * (warp & 3);          // the warp's row pair in the tile
  const int pc = 16 * (warp >> 2);        // its first column
  float sum[2][8][4], acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[m][n][i] = acc[m][n][i] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) {
      stage_tap(wbuf + ((tap + 1) & 1) * TAP_WORDS, wsplit, tap + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tap's weights (and at tap 0 the conv1_1 tile) are in
    const uint4* bs = reinterpret_cast<const uint4*>(wbuf + (tap & 1) * TAP_WORDS);
    // m-tile m, fragment row r*8 + g: tile pixel (pr + r, pc + 8m + g)
    const float* ap = c1s + ((pr + tap / 3) * CC + pc + tap % 3 + g) * CS + t4;
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* q = ap + m * 8 * CS + ks * 8;
        split_tf32(q[0], ahi[m][0], alo[m][0]);
        split_tf32(q[CC * CS], ahi[m][1], alo[m][1]);
        split_tf32(q[4], ahi[m][2], alo[m][2]);
        split_tf32(q[CC * CS + 4], ahi[m][3], alo[m][3]);
      }
      // 3xTF32: a_lo b_hi, then a_hi b_lo, then a_hi b_hi into each
      // accumulator, each term a pass over 8 of them, so that an mma never
      // waits on the one before it
#pragma unroll
      for (int n0 = 0; n0 < 8; n0 += 4) {
        uint4 bf[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) bf[n] = bs[(ks * 8 + n0 + n) * 32 + lane];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_tf32(acc[m][n0 + n], alo[m], bf[n].x, bf[n].y);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_tf32(acc[m][n0 + n], ahi[m], bf[n].z, bf[n].w);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_tf32(acc[m][n0 + n], ahi[m], bf[n].x, bf[n].y);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum[m][n][i] += acc[m][n][i];
          acc[m][n][i] = 0.f;
        }
    __syncthreads();  // every warp is done with this tap's buffer
  }

  // 4. bias, ReLU, 2x2 pool and its routing. This thread holds rows pr and
  // pr+1 of column pc + 8m + g (sum[m][n][0|1] and [2|3], channels
  // 8n + 2t4 + 0|1); lane ^ 4 holds the other column of the window. Window
  // order is (top, left), (top, right), (bottom, left), (bottom, right).
  const int Hp = H / 2, Wp = W / 2;
  const int gr = r0 + pr;
  const bool left = (g & 1) == 0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int gc = c0 + pc + 8 * m + g;
    // H, W, gr and the window's left column are even: a window is in or out whole
    const bool in = gr < H && gc < W;
    const size_t o = (((size_t)b * Hp + gr / 2) * Wp + gc / 2) * C + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pooled[2];
      unsigned char code[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = b2s[8 * n + 2 * t4 + j];
        const float top = fmaxf(sum[m][n][j] + bias, 0.f);
        const float bot = fmaxf(sum[m][n][2 + j] + bias, 0.f);
        const float otop = __shfl_xor_sync(0xffffffffu, top, 4);
        const float obot = __shfl_xor_sync(0xffffffffu, bot, 4);
        const float v00 = left ? top : otop, v01 = left ? otop : top;
        const float v10 = left ? bot : obot, v11 = left ? obot : bot;
        const float mx = fmaxf(fmaxf(v00, v01), fmaxf(v10, v11));
        pooled[j] = mx;
        code[j] = !(mx > 0.f) ? 4 : v00 == mx ? 0 : v01 == mx ? 1 : v10 == mx ? 2 : 3;
      }
      if (in && (n < 4) == left) {
        *reinterpret_cast<float2*>(out + o + 8 * n) = make_float2(pooled[0], pooled[1]);
        if (route)
          *reinterpret_cast<uchar2*>(route + o + 8 * n) = make_uchar2(code[0], code[1]);
      }
    }
  }
}

}  // namespace

// Launches K1 on `stream` (a cudaStream_t): the w2 split into wsplit
// (W2_SPLIT = 9 * 8192 32-bit words), then the stem; route may be null;
// extents may be null (one extent vh, vw for the batch) or an int32 (B, 2)
// device array of per-image extents. Returns a cudaError_t: 0 when both
// launches succeeded. Does not synchronise.
extern "C" int shf_stem_forward(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, unsigned* wsplit,
                                float* out, unsigned char* route, int B, int H, int W,
                                int vh, int vw, const int* extents, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1) ||
      (H + TH - 1) / TH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The shared-memory limit belongs to the current device and outlasts the
  // call; it is set on every call outside a CUDA-graph capture, where
  // cudaFuncSetAttribute may not run (a capture follows an uncaptured call).
  cudaStreamCaptureStatus capturing;
  cudaError_t e = cudaStreamIsCapturing(s, &capturing);
  if (e != cudaSuccess) return (int)e;
  if (capturing == cudaStreamCaptureStatusNone) {
    e = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  split_w2_kernel<<<(W2_SPLIT / 4 + NT - 1) / NT, NT, 0, s>>>(
      w2, reinterpret_cast<uint4*>(wsplit));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  stem_kernel<<<grid, NT, SMEM_BYTES, s>>>(x, w1, b1, wsplit, b2, out, route, H, W, vh, vw,
                                           extents);
  return (int)cudaGetLastError();
}

extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
