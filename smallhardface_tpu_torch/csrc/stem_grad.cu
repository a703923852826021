// Backward of the fused VGG stem for NVIDIA Hopper (sm_90a): the gradients
// of out = maxpool2x2(relu(conv3x3(mask(relu(conv3x3(mask(x), w1) + b1)), w2) + b2))
// with respect to w1, b1, w2 and b2, given dy = dL/dout. The image gets no
// gradient.
//
// Replaces the TPU kernel smallhardface_tpu/ops/pallas_stem.py:_grad_kernel
// (reached through _stem_grad_call and _stem_op_bwd). Built by
// smallhardface_tpu_torch/ops/stem.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; shf_stem_grad below is the whole interface.
//
// Layouts (the forward kernel's, csrc/stem.cu). x: NHWC (B, H, W, 3).
// dy: NHWC (B, H/2, W/2, 64). route: NHWC (B, H/2, W/2, 64) uint8, the
// forward kernel's pool routing. w1: HWIO (3, 3, 3, 64). w2f: w2 flipped
// in both spatial axes with ci and co swapped, (3, 3, 64 co, 64 ci), the
// weights of the data gradient as a correlation. Scratch c1, dpre2, dpre1:
// NHWC (B, H, W, 64) each; wsplit: W2F_SPLIT words, w2f cut into TF32
// halves in mma fragment order. partial: (10, n_chunk, 64, 64). out:
// (10, 64, 64), laid out as
//   out[t]       t < 9: dw2 tap t = (ky, kx), a (64 ci, 64 co) matrix;
//   out[9][i]    i < 27: dw1 row (ky, kx, ci); out[9][27] = db1;
//                out[9][28] = db2.
// All fp32 but route, contiguous. H and W even.
//
// Semantics (those of the TPU kernel and of autograd through the plain
// stem): x and conv1_1 read exact zeros outside [0, min(H, vh)) x
// [0, min(W, vw)); the pool sends dy to the FIRST maximal element of each
// 2x2 window in row-major order; the ReLU backward passes where the
// activation is > 0; dy is zero at pooled positions (q, p) with 2q >= vh
// or 2p >= vw. Then
//   dpre1 = (sum over taps of w2^T dpre2) * (c1 > 0),
//   dw2 = sum c1 (x) dpre2, db2 = sum dpre2, dw1 = sum x (x) dpre1,
//   db1 = sum dpre1.
// The pool and ReLU routing comes from the forward kernel: route[b][q][p]
// [co] is 0..3, the window element that takes dy, or 4, none (see
// stem.cu). So conv1_2 is not recomputed here and shares no arithmetic
// with the forward. conv1_1 is recomputed, with conv1_1_tile below, a
// copy of the one in stem.cu that must stay the same fmaf by fmaf: the
// c1 > 0 mask and dw2 then read the very values the forward's conv1_2 read.
//
// What bounds it. Two 64x64x9 products per pixel, the data gradient into
// conv1_1 and the weight gradient of conv1_2, on the tensor cores in
// error-compensated TF32: three TF32 products each, 8.49e11 FLOP at
// 1x1200x1600, 1.72 ms at 495 TFLOP/s; conv1_1 and the dw1 job, 1.33e10
// fp32 FLOP on the CUDA cores, 0.20 ms at 67 TFLOP/s. The bound of this
// design is their sum, 1.91 ms (4.42 ms all in fp32 on the CUDA cores).
// The three 64-channel intermediates (c1, dpre2, dpre1) go through device
// memory once each (about 3 GB of traffic at that size, under 1 ms at
// 3.35 TB/s), so the first stage, which writes c1 and dpre2, is bound by
// memory.
//
// Error-compensated TF32 ("3xTF32"). mma reads 19 bits of each fp32
// operand. Each operand a is cut into hi = cvt.rna.tf32(a) and
// lo = cvt.rna.tf32(a - hi) (the subtraction is exact), and each product
// takes a_lo*b_hi, then a_hi*b_lo, then a_hi*b_hi into the fp32
// accumulator; lo*lo is dropped. That keeps about 22 bits of each operand.
// Small integers (|a| < 2^11) are their own hi, so on the integer recipe of
// the tests every product and every sum below 2^24 stays exact. The tensor
// cores may round a sum toward zero, and that error would grow with the
// length of the chain (a 7,500-pixel chunk would lose about 6e-5 of the
// peak); so each accumulator runs for one tap (dc1) or one 32-pixel step
// (dw2) and is then added in fp32 to a second, rounded to nearest. The
// three terms go out as three passes over a warp's accumulators, so that
// no mma waits on the one before it.
//
// Design, five launches on one stream:
//   1. c1_route_kernel, one block per (image, 8-row strip, 32-column tile),
//      the forward kernel's tiling: the input tile and the conv1_1 tile in
//      shared memory (fp32, CUDA cores). It writes the tile's own conv1_1
//      positions to c1, then scatters dy by route into dpre2 (each window's
//      routed element gets dy, the other three 0).
//   2. split_w2f_kernel cuts w2f into TF32 hi/lo halves, once per call,
//      in the order the B fragments of mma.m16n8k8 read them.
//   3. dc1_kernel, same tiling, as an implicit GEMM on the tensor cores:
//      M = the tile's 256 pixels, N = 64 ci, K = 9 taps x 64 co. The
//      haloed dpre2 tile (10 x 34 positions, stride 68 floats so that the
//      A fragments hit 32 banks) is in shared memory; each tap's split w2f
//      (32 KB) comes with cp.async into a double buffer, tap t+1 loading
//      while tap t multiplies. Warp w owns tile row w: two 16-pixel m-tiles
//      x eight 8-channel n-tiles. Masked by c1 > 0 into dpre1. It holds
//      158 KB of shared memory and about 200 registers a thread: one block
//      per SM.
//   4. wgrad_kernel, grid (4, n_chunk): block (x, chunk k) walks the
//      pixels of chunk k in order, 32 at a time; the four blocks of a chunk
//      run side by side, so each pixel's c1 and dpre2 come from device
//      memory about once and from L2 after that. Blocks x < 3 compute the
//      three dw2 taps of kernel row ky = x (c1 shifted by the tap against
//      dpre2) on the tensor cores: the three share dpre2, and read one run
//      of 34 c1 positions at three offsets, masked per pixel where the
//      shift leaves the image. Each 32-pixel step is split into hi/lo
//      halves in shared memory, and warp w owns 16 ci x 32 co of each
//      tap's 64x64 product (about 200 registers a thread: one block per
//      SM). Block x = 3, job 9,
//      stays on the CUDA cores in fp32 (a twentieth of dw2's work: K = 27
//      rows of shifted input plus two rows of ones): the 27 input values
//      and a row of ones against dpre1 (dw1, db1) and a row of ones against
//      dpre2 (db2), a 32 x 64 product with 2x4 outputs a thread. Each block
//      writes its partials.
//   5. reduce_kernel sums the partials of each output in chunk order.
// Blocks assume no order between them, and no atomics are used: the
// cross-block sum is a fixed-order second pass, so the result is the same
// to the bit from run to run (resume reproducibility rests on it).

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;                   // rows per tile
constexpr int TW = 32;                  // columns per tile
constexpr int C = 64;                   // stem channels
constexpr int NT = 256;                 // threads: 8 warps
constexpr int XR = TH + 4, XC = TW + 4; // haloed input tile
constexpr int CR = TH + 2, CC = TW + 2; // haloed 64-channel tile
constexpr int T_FLOATS = CR * CC * C;   // stage 1's conv1_1 tile
constexpr int XS_FLOATS = XR * XC * 4;  // 4 floats a pixel: one 16-byte load
constexpr int W1_FLOATS = 27 * C;
constexpr size_t SMEM_BYTES = (T_FLOATS + XS_FLOATS + W1_FLOATS + C) * sizeof(float);
constexpr int KT = 32;                  // pixels per step of the weight gradient
constexpr int JOBS = 10;                // 9 taps of dw2, then dw1/db1/db2
// data gradient on the tensor cores
constexpr int DS = C + 4;               // dpre2 tile stride: A fragments conflict-free
constexpr int D_FLOATS = CR * CC * DS;
constexpr int TAP_WORDS = C * C * 2;    // one tap of w2f as hi and lo
constexpr int W2F_SPLIT = 9 * TAP_WORDS;
constexpr size_t DC1_SMEM_BYTES = (D_FLOATS + 2 * TAP_WORDS) * sizeof(float);
// weight gradient on the tensor cores
constexpr int GS = C + 8;               // row stride: A and B fragments conflict-free

static_assert(NT % C == 0 && (T_FLOATS * sizeof(float)) % 16 == 0,
              "stage 1: a thread owns one channel; 16-byte aligned input tile");
static_assert(NT == 32 * TH, "dc1: warp w owns tile row w");
static_assert((D_FLOATS * sizeof(float)) % 16 == 0 && DS % 32 == 4,
              "dc1: 16-byte aligned tap buffers, pixel stride 4 mod 32 banks");
static_assert(GS % 32 == 8, "wgrad: row stride 8 mod 32 banks");
static_assert((4 * KT + 4) * GS >= 3 * KT * C, "job 9 fits the tensor jobs' tiles");

// ---- TF32 on the tensor cores ----

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

// 16 bytes from device memory to shared memory, or 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool copy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(copy ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- conv1_1, the arithmetic K1 and K2 share (keep equal to stem.cu) ----

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

// ---- stage 1: conv1_1 and the routed gradient (fp32, CUDA cores) ----

__global__ void __launch_bounds__(NT, 2)
c1_route_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ dy,
                const unsigned char* __restrict__ route, float* __restrict__ c1,
                float* __restrict__ dpre2, int H, int W, int vh, int vw) {
  extern __shared__ __align__(16) float smem[];
  float* c1s = smem;                    // [CR * CC][C]
  float* xs = smem + T_FLOATS;          // [XR][XC][4]
  float* w1s = xs + XS_FLOATS;          // [27][64]
  float* b1s = w1s + W1_FLOATS;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int rl = min(H, vh);
  const int cl = min(W, vw);
  load_stem_inputs(x + (size_t)b * H * W * 3, w1, b1, xs, w1s, b1s, W, r0, c0, rl, cl, tid);
  __syncthreads();
  conv1_1_tile<C>(xs, w1s, b1s, c1s, r0, c0, rl, cl, tid);
  __syncthreads();

  // the tile's own conv1_1 positions go to device memory for stages 3-4
  const float* c1b = c1s + (CC + 1) * C;           // tile position (1, 1)
  for (int i = tid; i < TH * TW * (C / 4); i += NT) {
    const int f = (i % (C / 4)) * 4, p = i / (C / 4);
    const int gr = r0 + p / TW, gc = c0 + p % TW;
    if (gr < H && gc < W)
      *reinterpret_cast<float4*>(c1 + (((size_t)b * H + gr) * W + gc) * C + f) =
          *reinterpret_cast<const float4*>(c1b + ((p / TW) * CC + p % TW) * C + f);
  }

  // dy of pooled position (q, p) goes to window element route (0..3,
  // row-major) of channel co, nowhere where route is 4; dy is zero where
  // 2q >= vh or 2p >= vw. Four channels a thread.
  const int Hp = H / 2, Wp = W / 2;
  for (int i = tid; i < (TH / 2) * (TW / 2) * (C / 4); i += NT) {
    const int f = (i % (C / 4)) * 4, pp = i / (C / 4);
    const int q = r0 / 2 + pp / (TW / 2), p = c0 / 2 + pp % (TW / 2);
    if (q >= Hp || p >= Wp) continue;
    const size_t o = (((size_t)b * Hp + q) * Wp + p) * C + f;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (2 * q < vh && 2 * p < vw) d = *reinterpret_cast<const float4*>(dy + o);
    const uchar4 k = *reinterpret_cast<const uchar4*>(route + o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(
          dpre2 + (((size_t)b * H + 2 * q + e / 2) * W + 2 * p + e % 2) * C + f) =
          make_float4(k.x == e ? d.x : 0.f, k.y == e ? d.y : 0.f, k.z == e ? d.z : 0.f,
                      k.w == e ? d.w : 0.f);
  }
}

// ---- stages 2-3: the data gradient (3xTF32, tensor cores) ----

// wsplit[tap][ks][nt][lane] = (b0 hi, b1 hi, b0 lo, b1 lo) of the B
// fragment of k-step ks (co 8ks..8ks+7) and n-tile nt (ci 8nt..8nt+7):
// b0 = w2f[tap][8ks + t][8nt + g], b1 = w2f[tap][8ks + t + 4][8nt + g].
__global__ void split_w2f_kernel(const float* __restrict__ w2f, uint4* __restrict__ wsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W2F_SPLIT / 4) return;
  const int lane = i & 31, nt = (i >> 5) & 7, ks = (i >> 8) & 7, tap = i >> 11;
  const int g = lane >> 2, t = lane & 3;
  const float* w = w2f + (size_t)tap * C * C + (ks * 8 + t) * C + nt * 8 + g;
  unsigned h0, l0, h1, l1;
  split_tf32(w[0], h0, l0);
  split_tf32(w[4 * C], h1, l1);
  wsplit[i] = make_uint4(h0, h1, l0, l1);
}

__device__ __forceinline__ void stage_tap(unsigned* dst, const unsigned* __restrict__ wsplit,
                                          int tap, int tid) {
  const unsigned* src = wsplit + (size_t)tap * TAP_WORDS;
  for (int i = tid; i < TAP_WORDS / 4; i += NT) cp_async16(dst + 4 * i, src + 4 * i, true);
}

__global__ void __launch_bounds__(NT, 1)
dc1_kernel(const float* __restrict__ dpre2, const unsigned* __restrict__ wsplit,
           const float* __restrict__ c1, float* __restrict__ dpre1, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;                                         // dpre2 tile [CR * CC][DS]
  unsigned* wbuf = reinterpret_cast<unsigned*>(smem + D_FLOATS);   // 2 taps

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  // dpre2 at rows r0-1 .. r0+TH, cols c0-1 .. c0+TW, zeros outside; it and
  // tap 0 make the first group of copies
  for (int i = tid; i < CR * CC * (C / 4); i += NT) {
    const int p = i / (C / 4), f = (i % (C / 4)) * 4;
    const int gr = r0 - 1 + p / CC, gc = c0 - 1 + p % CC;
    const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
    cp_async16(ts + p * DS + f,
               in ? dpre2 + (((size_t)b * H + gr) * W + gc) * C + f : dpre2, in);
  }
  stage_tap(wbuf, wsplit, 0, tid);
  cp_async_commit();

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
    __syncthreads();  // tap's weights (and at tap 0 the tile) are in
    const uint4* bs = reinterpret_cast<const uint4*>(wbuf + (tap & 1) * TAP_WORDS);
    // A[pixel (warp, col)][co] = tile[(warp + ky) * CC + col + kx][co]
    const float* ap = ts + ((warp + tap / 3) * CC + tap % 3 + g) * DS + t4;
#pragma unroll 2
    for (int ks = 0; ks < 8; ++ks) {
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* q = ap + m * 16 * DS + ks * 8;
        split_tf32(q[0], ahi[m][0], alo[m][0]);
        split_tf32(q[8 * DS], ahi[m][1], alo[m][1]);
        split_tf32(q[4], ahi[m][2], alo[m][2]);
        split_tf32(q[8 * DS + 4], ahi[m][3], alo[m][3]);
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

  const int gr = r0 + warp;
  if (gr >= H) return;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = c0 + m * 16 + h * 8 + g;
      if (gc >= W) continue;
      const size_t off = (((size_t)b * H + gr) * W + gc) * C + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 c = *reinterpret_cast<const float2*>(c1 + off + n * 8);
        *reinterpret_cast<float2*>(dpre1 + off + n * 8) =
            make_float2(c.x > 0.f ? sum[m][n][2 * h] : 0.f,
                        c.y > 0.f ? sum[m][n][2 * h + 1] : 0.f);
      }
    }
}

// ---- stage 4: the weight gradients ----

// A pixel that one thread reads in each 32-pixel step of a chunk: its flat
// index and its row and column in the image, moved on by 32 pixels a step
// without a division (a 64-bit division per load would leave this stage
// bound by integer arithmetic).
struct PixelWalk {
  long long pix;
  int y, x;
  __device__ __forceinline__ void start(long long p, int H, int W) {
    pix = p;
    const long long row = p / W;
    x = (int)(p - row * W);
    y = (int)(row % H);
  }
  __device__ __forceinline__ void advance(int H, int W) {
    pix += KT;
    x += KT;
    while (x >= W) {
      x -= W;
      if (++y == H) y = 0;
    }
  }
};

// Job 9 on the CUDA cores, a 32 x 64 product: rows 0..26 of A are the
// shifted input values and row 27 ones, against dpre1 (dw1, db1); row 28
// is ones against dpre2 (db2); rows 29..31 are zero, and rows 32..63 of
// the partial are written as zeros. Each step is read into registers one
// step ahead; a thread owns 2 rows x 4 columns.
__device__ __forceinline__ void wgrad_bias(unsigned* sm, const float* __restrict__ x,
                                           const float* __restrict__ dpre2,
                                           const float* __restrict__ dpre1, float* out,
                                           int H, int W, int vh, int vw,
                                           long long p_begin, long long p_end) {
  float(*as)[C] = reinterpret_cast<float(*)[C]>(sm);    // columns 0..31
  float(*bs)[C] = as + KT;
  float(*b2s)[C] = bs + KT;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // rows 2ty, 2ty+1, columns 4tx..
  const int ka = tid >> 3, fa = (tid & 7) * 4;   // A: pixel ka, rows fa..fa+3
  const int fb = (tid & 15) * 4;                 // B: channels fb..fb+3
  const int rl = min(H, vh), cl = min(W, vw);
  const float(*bsel)[C] = ty == 14 ? b2s : bs;
  PixelWalk walk;
  walk.start(p_begin + ka, H, W);

  float4 ra, rb[2], rb2[2];
  long long p_next = p_begin;
  auto fetch = [&]() {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (walk.pix < p_end) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = fa + u;
        if (row < 27) {
          const int t = row / 3, ci = row % 3;
          const int dy = t / 3 - 1, dx = t % 3 - 1;
          if (walk.y + dy >= 0 && walk.y + dy < rl && walk.x + dx >= 0 &&
              walk.x + dx < cl)
            a[u] = x[(walk.pix + (long long)dy * W + dx) * 3 + ci];
        } else if (row == 27 || row == 28) {
          a[u] = 1.f;
        }
      }
    }
    ra = make_float4(a[0], a[1], a[2], a[3]);
    walk.advance(H, W);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long pix = p_next + (tid >> 4) + 16 * u;
      rb[u] = rb2[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix < p_end) {
        rb[u] = *reinterpret_cast<const float4*>(dpre1 + pix * C + fb);
        rb2[u] = *reinterpret_cast<const float4*>(dpre2 + pix * C + fb);
      }
    }
    p_next += KT;
  };

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch();
  for (long long p0 = p_begin; p0 < p_end; p0 += KT) {
    __syncthreads();  // previous readers of the tiles are done
    *reinterpret_cast<float4*>(&as[ka][fa]) = ra;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      *reinterpret_cast<float4*>(&bs[(tid >> 4) + 16 * u][fb]) = rb[u];
      *reinterpret_cast<float4*>(&b2s[(tid >> 4) + 16 * u][fb]) = rb2[u];
    }
    __syncthreads();
    if (p0 + KT < p_end) fetch();
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(&as[k][2 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bsel[k][4 * tx]);
      const float av[2] = {a.x, a.y};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    *reinterpret_cast<float4*>(out + (2 * ty + i) * C + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + (32 + 2 * ty + i) * C + 4 * tx) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Jobs 3ky .. 3ky+2 (dw2 taps (ky, 0..2)) on the tensor cores:
// out[3ky + kx][ci][co] = sum over the chunk's pixels p of
// c1[p shifted by (ky - 1, kx - 1)][ci] * dpre2[p][co]; A = c1 (ci x
// pixels), B = dpre2 (pixels x co). The three taps of a kernel row share
// B, and their A are one run of c1 in flat pixel order, 34 positions for a
// 32-pixel step (from p0 - 1 + (ky - 1) W), read at offsets 0, 1, 2. A
// shifted position that leaves the image (the row above or below, or the
// column left or right of the image's edge, which in flat order is the
// neighbouring row's end) is masked per pixel and tap at fragment load.
// Each step is read into registers one step ahead, split into hi/lo halves
// in shared memory ([position][channel], stride GS), and multiplied into
// accumulators that are added to the block's sums once per step. Warp w
// owns ci 16(w/2)..+16 x co 32(w%2)..+32 of each of the three taps.
__device__ __forceinline__ void wgrad_row(unsigned* sm, const float* __restrict__ c1,
                                          const float* __restrict__ dpre2, float* out,
                                          size_t tap_stride, int ky, int H, int W,
                                          long long n_pix, long long p_begin,
                                          long long p_end) {
  constexpr int AR = KT + 2;                  // c1 positions a step
  unsigned(*chi)[GS] = reinterpret_cast<unsigned(*)[GS]>(sm);
  unsigned(*clo)[GS] = chi + AR;
  unsigned(*dhi)[GS] = clo + AR;
  unsigned(*dlo)[GS] = dhi + KT;
  unsigned* msk = sm + (2 * AR + 2 * KT) * GS;  // 3 words: tap kx's valid pixels
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  const int dy = ky - 1;
  const int f = (tid % (C / 4)) * 4;          // channels f..f+3
  constexpr int A_SLOTS = AR * (C / 4);       // float4s of c1 a step
  PixelWalk walk;                             // warp 0: pixel p0 + lane
  if (warp == 0) walk.start(p_begin + lane, H, W);

  // the next step into registers: c1 positions tid/16, +16, +32 (the last
  // for tid < 32 only) and dpre2 pixels tid/16, +16
  float4 ra[3], rb[2];
  long long p_next = p_begin;
  auto fetch = [&]() {
    const long long q0 = p_next - 1 + (long long)dy * W;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const long long q = q0 + (tid >> 4) + 16 * u;
      ra[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid + u * NT < A_SLOTS && q >= 0 && q < n_pix)
        ra[u] = *reinterpret_cast<const float4*>(c1 + q * C + f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long pix = p_next + (tid >> 4) + 16 * u;
      rb[u] = pix < p_end ? *reinterpret_cast<const float4*>(dpre2 + pix * C + f)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    p_next += KT;
  };
  auto put = [&](unsigned(*hi)[GS], unsigned(*lo)[GS], int k, float4 v) {
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(&hi[k][f]) = h;
    *reinterpret_cast<uint4*>(&lo[k][f]) = l;
  };

  float sum[3][4][4], acc[3][4][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[d][j][i] = acc[d][j][i] = 0.f;

  fetch();
  for (long long p0 = p_begin; p0 < p_end; p0 += KT) {
    __syncthreads();  // previous readers of the tiles are done
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (tid + u * NT < A_SLOTS) put(chi, clo, (tid >> 4) + 16 * u, ra[u]);
#pragma unroll
    for (int u = 0; u < 2; ++u) put(dhi, dlo, (tid >> 4) + 16 * u, rb[u]);
    if (warp == 0) {
      const bool row_in = walk.pix < p_end && walk.y + dy >= 0 && walk.y + dy < H;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const unsigned m = __ballot_sync(
            0xffffffffu, row_in && walk.x + kx - 1 >= 0 && walk.x + kx - 1 < W);
        if (lane == 0) msk[kx] = m;
      }
      walk.advance(H, W);
    }
    __syncthreads();
    if (p0 + KT < p_end) fetch();
    const unsigned m[3] = {msk[0], msk[1], msk[2]};
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {
      const int k0 = ks * 8 + t4, k1 = k0 + 4;
      unsigned bh0[4], bh1[4], bl0[4], bl1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + g;
        bh0[j] = dhi[k0][n];
        bh1[j] = dhi[k1][n];
        bl0[j] = dlo[k0][n];
        bl1[j] = dlo[k1][n];
      }
      unsigned ah[3][4], al[3][4];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const bool v0 = (m[kx] >> k0) & 1u, v1 = (m[kx] >> k1) & 1u;
        ah[kx][0] = v0 ? chi[k0 + kx][m0 + g] : 0u;
        ah[kx][1] = v0 ? chi[k0 + kx][m0 + g + 8] : 0u;
        ah[kx][2] = v1 ? chi[k1 + kx][m0 + g] : 0u;
        ah[kx][3] = v1 ? chi[k1 + kx][m0 + g + 8] : 0u;
        al[kx][0] = v0 ? clo[k0 + kx][m0 + g] : 0u;
        al[kx][1] = v0 ? clo[k0 + kx][m0 + g + 8] : 0u;
        al[kx][2] = v1 ? clo[k1 + kx][m0 + g] : 0u;
        al[kx][3] = v1 ? clo[k1 + kx][m0 + g + 8] : 0u;
      }
      // 3xTF32 as three passes over the 12 accumulators (see dc1_kernel)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[kx][j], al[kx], bh0[j], bh1[j]);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[kx][j], ah[kx], bl0[j], bl1[j]);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[kx][j], ah[kx], bh0[j], bh1[j]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum[d][j][i] += acc[d][j][i];
          acc[d][j][i] = 0.f;
        }
  }

#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* o = out + kx * tap_stride + (m0 + g) * C + n0 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(o) = make_float2(sum[kx][j][0], sum[kx][j][1]);
      *reinterpret_cast<float2*>(o + 8 * C) = make_float2(sum[kx][j][2], sum[kx][j][3]);
    }
}

// Block (x, chunk k): x < 3 is kernel row ky = x of dw2 (jobs 3x .. 3x+2)
// on the tensor cores, x = 3 is job 9 on the CUDA cores. The four blocks
// of a chunk are neighbours in launch order, so they read its pixels from
// device memory about once and from L2 after that.
__global__ void __launch_bounds__(NT, 1)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ c1,
             const float* __restrict__ dpre2, const float* __restrict__ dpre1,
             float* __restrict__ partial, int H, int W, int vh, int vw,
             long long n_pix, long long chunk_len) {
  __shared__ __align__(16) unsigned sm[(4 * KT + 4) * GS + 4];
  const int chunk = blockIdx.y;
  const int n_chunk = gridDim.y;
  const long long p_begin = chunk * chunk_len;
  const long long p_end = min(p_begin + chunk_len, n_pix);
  const size_t tap_stride = (size_t)n_chunk * C * C;
  if (blockIdx.x < 3)
    wgrad_row(sm, c1, dpre2, partial + (3 * blockIdx.x * n_chunk + chunk) * (size_t)C * C,
              tap_stride, blockIdx.x, H, W, n_pix, p_begin, p_end);
  else
    wgrad_bias(sm, x, dpre2, dpre1, partial + (9 * (size_t)n_chunk + chunk) * C * C, H, W,
               vh, vw, p_begin, p_end);
}

// ---- stage 5: the fixed-order sum of the chunks ----

__global__ void reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                              int n_chunk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // (job, 64, 64) flat
  if (e >= JOBS * C * C) return;
  const int job = e / (C * C), i = e % (C * C);
  const float* src = partial + (size_t)job * n_chunk * C * C + i;
  float s = 0.f;
  for (int k = 0; k < n_chunk; ++k) s += src[(size_t)k * C * C];
  out[e] = s;
}

}  // namespace

// Launches K2 on `stream` (a cudaStream_t). n_chunk and chunk_len split
// the B*H*W pixels for the weight gradient (chunk_len a multiple of 32,
// n_chunk * chunk_len >= B*H*W); partial holds 10 * n_chunk * 64 * 64
// floats, wsplit W2F_SPLIT (9 * 8192) 32-bit words. Returns a cudaError_t:
// 0 when every launch succeeded. Does not synchronise.
extern "C" int shf_stem_grad(const float* x, const float* dy, const unsigned char* route,
                             const float* w1, const float* b1, const float* w2f,
                             unsigned* wsplit, float* c1, float* dpre2,
                             float* dpre1, float* partial, float* out, int B, int H, int W,
                             int vh, int vw, int n_chunk, int chunk_len, void* stream) {
  const long long n_pix = (long long)B * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1) ||
      (H + TH - 1) / TH > 65535 || B > 65535 || n_chunk <= 0 || n_chunk > 65535 ||
      chunk_len <= 0 || chunk_len % KT || (long long)n_chunk * chunk_len < n_pix)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The shared-memory limits belong to the current device and outlast the
  // call; they are set on every call outside a CUDA-graph capture, where
  // cudaFuncSetAttribute may not run (a capture follows an uncaptured call).
  cudaStreamCaptureStatus capturing;
  cudaError_t e = cudaStreamIsCapturing(s, &capturing);
  if (e != cudaSuccess) return (int)e;
  if (capturing == cudaStreamCaptureStatusNone) {
    e = cudaFuncSetAttribute(c1_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(dc1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DC1_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  c1_route_kernel<<<grid, NT, SMEM_BYTES, s>>>(x, w1, b1, dy, route, c1, dpre2, H, W, vh, vw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  split_w2f_kernel<<<(W2F_SPLIT / 4 + NT - 1) / NT, NT, 0, s>>>(
      w2f, reinterpret_cast<uint4*>(wsplit));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dc1_kernel<<<grid, NT, DC1_SMEM_BYTES, s>>>(dpre2, wsplit, c1, dpre1, H, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wgrad_kernel<<<dim3(4, n_chunk), NT, 0, s>>>(x, c1, dpre2, dpre1, partial, H, W, vh, vw,
                                               n_pix, chunk_len);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_kernel<<<(JOBS * C * C + NT - 1) / NT, NT, 0, s>>>(partial, out, n_chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
