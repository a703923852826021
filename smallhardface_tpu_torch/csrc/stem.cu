// Fused VGG stem for NVIDIA Hopper (sm_90a):
//   out = maxpool2x2(relu(conv3x3(mask(relu(conv3x3(mask(x), w1) + b1)), w2) + b2))
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
// (3, 3, 64, 64), i.e. 9 taps of a (64 ci, 64 co) matrix. out: NHWC
// (B, H/2, W/2, 64) fp32. H and W must be even (the launcher refuses odd
// sizes); any even size works, ragged tiles are masked.
//
// Masking. Positions outside [0, min(H, vh)) x [0, min(W, vw)) read as exact
// zeros, both in the input and in the conv1_1 activations that conv1_2
// reads: the reference network's implicit zero padding, so the conv1_2 halo
// holds 0 and not relu(b1). Output positions beyond the valid extent are
// computed from those zeros and are not meaningful.
//
// Rounding. Every product and sum is fp32 on the CUDA cores (fmaf), and
// the conv1_1 activations are kept in fp32. The TPU kernel instead fed its
// dots bf16 and stored conv1_1 as bf16; that was a matrix-unit artefact,
// and this kernel agrees with an fp32 PyTorch reference to fp32 rounding.
//
// What bounds it. The stem is bound by device-memory traffic when written
// as three passes: conv1_1 and conv1_2 each write a (B, H, W, 64) fp32
// tensor (1.35 GB at 2x1408x1872) and read it back, while the pooled
// output is 4x smaller. This kernel reads the 3-channel input once and
// writes only the pooled output; conv1_1 lives in shared memory and
// conv1_2 in registers. What is left is arithmetic: conv1_2 is 64x64x9
// fp32 FMAs per pixel, run here on the CUDA cores (tensor cores via
// wgmma/bf16 are later work).
//
// Design. One block of 256 threads per (image, 8-row strip, 32-column
// tile). The block
//   1. loads its haloed input tile (12 x 36 x 3) into shared memory, masked;
//   2. computes the 10 x 34 x 64 conv1_1 tile into shared memory, zeroed
//      outside the tensor and the valid extent;
//   3. stages w2 one 64x64 tap at a time (in the space steps 1-2 used) and
//      accumulates conv1_2 for 8 x 32 x 64 outputs: warp g owns channels
//      [8g, 8g+8), lane l owns tile column l and all 8 rows, so a thread
//      keeps 64 accumulators, reads 8 conv1_1 values per (tap, ci) from
//      conflict-free addresses (position stride 65 floats) and 8 weights
//      as two broadcast float4 loads;
//   4. applies ReLU, pools row pairs in registers and column pairs across
//      neighbouring lanes (__shfl_xor_sync), and writes only the pooled
//      tile: the even lane of a pair writes pooled rows 0-1, the odd lane
//      rows 2-3.
// Blocks are independent: no order between them is assumed.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;                   // output rows per block
constexpr int TW = 32;                  // output columns per block (one lane each)
constexpr int C = 64;                   // stem channels
constexpr int NT = 256;                 // threads: 8 warps x 8 channels
constexpr int XR = TH + 4, XC = TW + 4; // haloed input tile
constexpr int CR = TH + 2, CC = TW + 2; // conv1_1 tile
constexpr int CS = C + 1;               // conv1_1 position stride (bank-conflict free)
constexpr int C1_FLOATS = CR * CC * CS;
constexpr int W2_FLOATS = C * C;        // one tap of w2
constexpr int XS_FLOATS = XR * XC * 3;
constexpr int W1_FLOATS = 27 * C;
constexpr size_t SMEM_BYTES = (C1_FLOATS + W2_FLOATS + 2 * C) * sizeof(float);

static_assert(XS_FLOATS + W1_FLOATS <= W2_FLOATS,
              "the input tile and w1 share the w2 tap buffer");
static_assert((C1_FLOATS * sizeof(float)) % 16 == 0,
              "the w2 tap buffer must be 16-byte aligned for float4 loads");
static_assert(NT == 32 * (C / 8) && TW == 32, "warp g owns channels 8g..8g+7");

__global__ void __launch_bounds__(NT, 2)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out,
            int H, int W, int vh, int vw) {
  extern __shared__ __align__(16) float smem[];
  float* c1s = smem;                    // [CR * CC][CS]
  float* w2s = smem + C1_FLOATS;        // [64 ci][64 co], steps 3-4
  float* xs = w2s;                      // [XR][XC][3], steps 1-2
  float* w1s = w2s + XS_FLOATS;         // [27][64], steps 1-2
  float* b1s = w2s + W2_FLOATS;
  float* b2s = b1s + C;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int rl = min(H, vh);
  const int cl = min(W, vw);
  const float* xb = x + (size_t)b * H * W * 3;

  // 1. input tile, rows r0-2 .. r0+TH+1, cols c0-2 .. c0+TW+1
  for (int i = tid; i < XS_FLOATS; i += NT) {
    const int ci = i % 3, p = i / 3;
    const int gr = r0 - 2 + p / XC, gc = c0 - 2 + p % XC;
    float v = 0.f;
    if (gr >= 0 && gr < rl && gc >= 0 && gc < cl)
      v = xb[((size_t)gr * W + gc) * 3 + ci];
    xs[i] = v;
  }
  for (int i = tid; i < W1_FLOATS; i += NT) w1s[i] = w1[i];
  if (tid < C) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  __syncthreads();

  // 2. conv1_1 + ReLU at rows r0-1 .. r0+TH, cols c0-1 .. c0+TW
  for (int i = tid; i < CR * CC * C; i += NT) {
    const int co = i % C, p = i / C;
    const int r = p / CC, c = p % CC;
    const int gr = r0 - 1 + r, gc = c0 - 1 + c;
    float v = 0.f;
    if (gr >= 0 && gr < rl && gc >= 0 && gc < cl) {
      float acc = b1s[co];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            acc = fmaf(xs[((r + dy) * XC + c + dx) * 3 + ci],
                       w1s[((dy * 3 + dx) * 3 + ci) * C + co], acc);
      v = fmaxf(acc, 0.f);
    }
    c1s[p * CS + co] = v;
  }

  // 3. conv1_2: thread (warp g, lane l) -> channels 8g..8g+7, column l, rows 0..7
  const int lane = tid & 31;
  const int cg = tid >> 5;
  float acc[TH][8];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = b2s[cg * 8 + j];

  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // previous readers of the tap buffer are done
    const float4* src = reinterpret_cast<const float4*>(w2 + (size_t)t * W2_FLOATS);
    float4* dst = reinterpret_cast<float4*>(w2s);
    for (int i = tid; i < W2_FLOATS / 4; i += NT) dst[i] = src[i];
    __syncthreads();
    const int dy = t / 3, dx = t % 3;
    const float* cp = c1s + (dy * CC + lane + dx) * CS;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float4 wa = *reinterpret_cast<const float4*>(w2s + ci * C + cg * 8);
      const float4 wb = *reinterpret_cast<const float4*>(w2s + ci * C + cg * 8 + 4);
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const float a = cp[r * CC * CS + ci];
        acc[r][0] = fmaf(a, wa.x, acc[r][0]);
        acc[r][1] = fmaf(a, wa.y, acc[r][1]);
        acc[r][2] = fmaf(a, wa.z, acc[r][2]);
        acc[r][3] = fmaf(a, wa.w, acc[r][3]);
        acc[r][4] = fmaf(a, wb.x, acc[r][4]);
        acc[r][5] = fmaf(a, wb.y, acc[r][5]);
        acc[r][6] = fmaf(a, wb.z, acc[r][6]);
        acc[r][7] = fmaf(a, wb.w, acc[r][7]);
      }
    }
  }

  // 4. ReLU + 2x2 max pool: rows in registers, columns across lane pairs
  float pooled[TH / 2][8];
#pragma unroll
  for (int pr = 0; pr < TH / 2; ++pr)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float m = fmaxf(fmaxf(acc[2 * pr][j], acc[2 * pr + 1][j]), 0.f);
      pooled[pr][j] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    }

  // W is even and c0 is even, so both lanes of a pair are in or out together
  const int gc = c0 + lane;
  if (gc >= W) return;
  const int half = lane & 1;
  const int Hp = H / 2, Wp = W / 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int gr = r0 + 2 * (2 * half + k);
    if (gr >= H) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = half ? pooled[2 + k][j] : pooled[k][j];
    float* o = out + (((size_t)b * Hp + gr / 2) * Wp + gc / 2) * C + cg * 8;
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace

// Launches the stem on `stream` (a cudaStream_t). Returns a cudaError_t:
// 0 on a successful launch. Does not synchronise.
extern "C" int shf_stem_forward(const float* x, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* out, int B, int H,
                                int W, int vh, int vw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1) ||
      (H + TH - 1) / TH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  stem_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, out, H, W, vh, vw);
  return (int)cudaGetLastError();
}

extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
