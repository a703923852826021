// The final vote of a detection for NVIDIA Hopper (sm_90a): greedy
// score-weighted box voting (BBOX_VOTE) and greedy NMS over the top
// candidates of each image of a batch, one thread block per image.
//
// Replaces smallhardface_tpu/ops/nms_jax.py:bbox_vote_device (:70) and
// nms_device (:27), which the JAX package runs as XLA loops with one step
// per cluster. Built by smallhardface_tpu_torch/ops/nms_device.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -prec-div=true -ftz=false
// and called through ctypes; shf_bbox_vote and shf_nms below are the whole
// interface.
//
// Semantics (nms_jax.py, and the plain versions in ops/nms_device.py).
// dets (B, V, 5) fp32 [x1, y1, x2, y2, score], each image's rows sorted by
// descending score; the first n_valid[b] rows of image b are candidates
// (n_valid, (B,) int32, read on the device). Block b runs the steps below
// on image b's rows alone, exactly as a launch for that image alone would
// (the counterpart of jax.vmap over the JAX functions). Each step
// takes the lowest remaining row as its head and computes every remaining
// row's IoU with it as inter / (area[head] + area - inter), +1 pixel
// convention. Vote: the cluster is the rows with IoU >= thresh; two or more
// emit (sum score*box / sum score, max score), one row is emitted only when
// nothing remains after it. NMS: the head is emitted and the rows with
// IoU > thresh are dropped. The head always belongs to its own cluster (its
// IoU with itself is 1 for any box of positive area; taking it outright
// makes every step remove a row). Every operation of an IoU is one IEEE fp32
// operation in the plain version's order: no fused multiply-add
// (-fmad=false) and a correctly rounded division, so a cluster's members,
// the count of rows emitted and the max score equal the plain version's to
// the bit; the sums of a merged box are taken in another order (within
// rounding; exact where every product and sum is, as on small integer boxes
// with dyadic scores).
//
// Outputs. out (B, V, 5) fp32: each image's emitted rows in order, zeros
// after them; n_out (B,) int32, written on the device, so that the caller
// reads back only the rows it needs, after one synchronisation.
//
// What bounds it. The work is a chain of dependent steps, one per cluster:
// a step needs the previous one's head. Each step reads the remaining rows
// (at most V = 2048 by default, 24 bytes each, from shared memory) and does
// about 25 fp32 operations on each, a correctly rounded division among them:
// at most 2048 x 2048 x 25 = 1e8 operations, 1.6 us at the card's fp32 rate,
// and 2048 x 20 bytes to read once, 0.01 us. So the bound is far below what
// one block can reach: the time is the latency of a step (the IoU of a
// thread's rows, then a reduction over the block, then one thread's
// emission) times the number of clusters.
//
// Design. One block of 512 threads per image (gridDim.x = B; the blocks
// share nothing); thread t owns rows t, t + 512, ... (at
// most 16, V <= 8192) and keeps which of them remain as a bitmask in a
// register. The rows and their areas sit in dynamic shared memory (24 V
// bytes; 48 KB at V = 2048), loaded once. A step: every thread tests its
// remaining rows against the head (from shared memory), removes its cluster
// members and sums, for the vote, their count, scores, score-weighted
// coordinates and max score, and notes its lowest row that still remains;
// a warp reduces these with shuffles, warp 0 reduces the warps' partials,
// and its lane 0 emits the row and publishes the next head, which is the
// lowest remaining row. Two block barriers a step.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER_THREAD = 16;
constexpr int MAX_ROWS = THREADS * MAX_PER_THREAD;

struct Partial {
  float s, sx1, sy1, sx2, sy2, smax;
  int count, next;
};

__device__ __forceinline__ Partial warp_reduce(Partial p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p.s += __shfl_down_sync(0xffffffffu, p.s, off);
    p.sx1 += __shfl_down_sync(0xffffffffu, p.sx1, off);
    p.sy1 += __shfl_down_sync(0xffffffffu, p.sy1, off);
    p.sx2 += __shfl_down_sync(0xffffffffu, p.sx2, off);
    p.sy2 += __shfl_down_sync(0xffffffffu, p.sy2, off);
    p.smax = fmaxf(p.smax, __shfl_down_sync(0xffffffffu, p.smax, off));
    p.count += __shfl_down_sync(0xffffffffu, p.count, off);
    p.next = min(p.next, __shfl_down_sync(0xffffffffu, p.next, off));
  }
  return p;
}

template <bool VOTE>
__global__ void __launch_bounds__(THREADS)
    vote_kernel(const float* __restrict__ dets, const int* __restrict__ n_valid_p, int V,
                float thresh, float* __restrict__ out, int* __restrict__ n_out) {
  extern __shared__ float rows[];  // x1, y1, x2, y2, score, area: V each
  float* X1 = rows;
  float* Y1 = rows + V;
  float* X2 = rows + 2 * V;
  float* Y2 = rows + 3 * V;
  float* S = rows + 4 * V;
  float* A = rows + 5 * V;
  __shared__ Partial partials[WARPS];
  __shared__ int head_sh, count_sh;

  // this block's image
  dets += (size_t)blockIdx.x * V * 5;
  out += (size_t)blockIdx.x * V * 5;
  n_valid_p += blockIdx.x;
  n_out += blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_valid = min(max(*n_valid_p, 0), V);
  for (int j = tid; j < V; j += THREADS) {
    const float x1 = dets[5 * j], y1 = dets[5 * j + 1], x2 = dets[5 * j + 2],
                y2 = dets[5 * j + 3];
    X1[j] = x1;
    Y1[j] = y1;
    X2[j] = x2;
    Y2[j] = y2;
    S[j] = dets[5 * j + 4];
    A[j] = (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
  }
  unsigned remain = 0;
#pragma unroll
  for (int k = 0; k < MAX_PER_THREAD; ++k)
    if (tid + k * THREADS < n_valid) remain |= 1u << k;
  if (tid == 0) {
    head_sh = n_valid > 0 ? 0 : INT_MAX;
    count_sh = 0;
  }
  __syncthreads();

  int head = head_sh;
  while (head != INT_MAX) {
    const float hx1 = X1[head], hy1 = Y1[head], hx2 = X2[head], hy2 = Y2[head],
                ha = A[head];
    Partial p = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -INFINITY, 0, INT_MAX};
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) {
      if (!((remain >> k) & 1u)) continue;
      const int j = tid + k * THREADS;
      const float w = fmaxf(0.0f, fminf(hx2, X2[j]) - fmaxf(hx1, X1[j]) + 1.0f);
      const float h = fmaxf(0.0f, fminf(hy2, Y2[j]) - fmaxf(hy1, Y1[j]) + 1.0f);
      const float inter = w * h;
      const float iou = inter / (ha + A[j] - inter);
      const bool member = j == head || (VOTE ? iou >= thresh : iou > thresh);
      if (!member) {
        p.next = min(p.next, j);
        continue;
      }
      remain &= ~(1u << k);
      if (VOTE) {
        const float s = S[j];
        p.s += s;
        p.sx1 += X1[j] * s;
        p.sy1 += Y1[j] * s;
        p.sx2 += X2[j] * s;
        p.sy2 += Y2[j] * s;
        p.smax = fmaxf(p.smax, s);
        p.count += 1;
      }
    }
    p = warp_reduce(p);
    if (lane == 0) partials[warp] = p;
    __syncthreads();
    if (warp == 0) {
      Partial q = lane < WARPS
                      ? partials[lane]
                      : Partial{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -INFINITY, 0, INT_MAX};
      q = warp_reduce(q);
      if (lane == 0) {
        const int c = count_sh;
        float* o = out + 5 * c;
        if (!VOTE || (q.count == 1 && q.next == INT_MAX)) {
          o[0] = hx1;
          o[1] = hy1;
          o[2] = hx2;
          o[3] = hy2;
          o[4] = S[head];
          count_sh = c + 1;
        } else if (q.count > 1) {
          o[0] = q.sx1 / q.s;
          o[1] = q.sy1 / q.s;
          o[2] = q.sx2 / q.s;
          o[3] = q.sy2 / q.s;
          o[4] = q.smax;
          count_sh = c + 1;
        }
        head_sh = q.next;
      }
    }
    __syncthreads();
    head = head_sh;
  }

  const int c = count_sh;
  for (int j = 5 * c + tid; j < 5 * V; j += THREADS) out[j] = 0.0f;
  if (tid == 0) *n_out = c;
}

template <bool VOTE>
int launch(const float* dets, const int* n_valid, int B, int V, float thresh, float* out,
           int* n_out, void* stream) {
  if (B <= 0 || B > 65535 || V < 0 || V > MAX_ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 6 * (size_t)V;
  // The shared-memory limit belongs to the current device and outlasts the
  // call; it is set on every call outside a CUDA-graph capture, where
  // cudaFuncSetAttribute may not run (a capture follows an uncaptured call).
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus capturing;
  cudaError_t e = cudaStreamIsCapturing(s, &capturing);
  if (e != cudaSuccess) return (int)e;
  if (capturing == cudaStreamCaptureStatusNone) {
    e = cudaFuncSetAttribute(vote_kernel<VOTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * 6 * MAX_ROWS));
    if (e != cudaSuccess) return (int)e;
  }
  vote_kernel<VOTE><<<B, THREADS, smem, s>>>(dets, n_valid, V, thresh, out, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

// B images of V rows each in one launch (B = 1 for one image).
extern "C" int shf_bbox_vote(const float* dets, const int* n_valid, int B, int V,
                             float thresh, float* out, int* n_out, void* stream) {
  return launch<true>(dets, n_valid, B, V, thresh, out, n_out, stream);
}

extern "C" int shf_nms(const float* dets, const int* n_valid, int B, int V, float thresh,
                       float* out, int* n_out, void* stream) {
  return launch<false>(dets, n_valid, B, V, thresh, out, n_out, stream);
}

extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
