// Per-anchor max IoU and its first argmax over a padded set of gt boxes,
// for NVIDIA Hopper (sm_90a), skipping the anchor-gt pairs whose IoU is
// provably 0.
//
// Replaces the TPU kernel smallhardface_tpu/ops/pallas_iou.py:_kernel
// (reached through pallas_max_iou), which train/targets.py calls for every
// dense anchor of a training image. Built by
// smallhardface_tpu_torch/ops/iou.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -prec-div=true -ftz=false
// and called through ctypes; shf_max_iou below is the whole interface.
//
// Semantics (bbox_overlaps, lib/utils/bbox.pyx:16-70, and the plain version
// ops/bbox.py:max_iou_chunked): the +1 pixel convention for widths and
// areas; IoU 0 where the union is not > 0; IoU -1 for a masked gt row; the
// first maximum wins (strict > in gt order, from -1); the result is
// clamped at 0 and a row with no unmasked gt gets (0, 0). Every operation
// of an IoU is one IEEE fp32 operation in the plain version's order: no
// fused multiply-add (-fmad=false; the one fmaf below only decides whether
// to divide) and a correctly rounded division, so the kernel equals the
// plain version to the bit. That matters because the label thresholds at
// 0.3 and 0.5 flip on a one-ulp difference.
//
// Layouts. anchors (N, 4) and gt (G, 4) fp32 [x1, y1, x2, y2], mask (G,)
// uint8, out_iou (N,) fp32, out_idx (N,) int32; contiguous.
//
// What bounds it. Densely, N x G IoUs of about 15 fp32 operations each,
// one of them a correctly rounded division (a multi-instruction sequence):
// 2.8e9 operations at N = 90k and G = 2048, 0.041 ms at the card's fp32
// rate, against N * 24 bytes of anchors and results (0.6 us). But the
// anchors are 16, 32 and 64 px squares at stride 8, so a gt overlaps only
// the anchors near it and almost every pair gives exactly 0. The design
// proves those pairs 0 in bulk and never computes them, so it can run
// under the dense bound; what is left is bound by the serial work of the
// warps that sit in a crowd and by the latency of one block's passes.
//
// Design. One thread per anchor, 256 per block. Each warp reduces the
// union box U = (min x1, min y1, max x2, max y2) of its 32 consecutive
// anchors (in the (h, w, A) order of the anchor grid about 11 positions of
// one row, some 150 x 64 px) with shuffles, and the block the union UB of
// its warps' boxes; lanes beyond N take no part. Two culls follow, both
// with the pair test's own fp32 expressions, U or UB in place of the
// anchor: gt q may overlap a box inside U when
//   fminf(U.z, q.z) - fmaxf(U.x, q.x) + 1 > 0  and
//   fminf(U.w, q.w) - fmaxf(U.y, q.y) + 1 > 0.
// 1. The block's cull. The gt stream through the block 256 at a time, one
//    per thread (each thread loads its next gt while it places this one);
//    those that are unmasked and may overlap UB are appended to the block's
//    list in shared memory (up to 1024), in gt order: __ballot_sync, then
//    a prefix over the warps' counts. The mask ballots also give the first
//    unmasked gt.
// 2. The warp's cull. When the gt are all streamed, or the list would
//    overflow, each warp walks the list 32 entries at a time and appends
//    those that may overlap its own U to its own list (__ballot_sync and
//    __popc of the lower lanes), still in gt order. A walk before the end
//    leaves each lane's best as it stands for the next; the band cases of
//    ops/iou_cases.py, on the card and in chip_smoke.py, fill a block's
//    list past CAP with identical gt on both sides of such a walk.
// 3. The exact loop. All 32 lanes take the warp's list, each against its
//    own anchor, with the plain version's arithmetic, four gt at a time so
//    that their divisions are independent. A lane divides only where the
//    quotient can beat its best: not when inter or the union is not > 0,
//    nor when fmaf(best, union, -inter) > 0, best as it stood before the
//    four. Each lane starts from best = 0 and no index and updates with a
//    strict > in list order; an anchor that beat no gt takes the first
//    unmasked gt, or 0 when every gt is masked.
//
// Why the result equals the plain version's to the bit. fminf, fmaxf and
// round-to-nearest subtraction and addition are monotone in each argument,
// and UB contains U, which contains every anchor a of the warp, so the
// pre-clamp widths obey iw(a, q) <= iw(U, q) <= iw(UB, q), and the same
// for the heights. A gt that either cull drops has iw(U, q) <= 0 or
// ih(U, q) <= 0, so iw(a, q) or ih(a, q) clamps to +0, inter = +0 and the
// plain version's IoU for the pair is +0. A division skipped by the filter
// cannot win either: inter = +0 or union <= 0 gives the plain version's
// IoU 0; fmaf rounds best * union - inter once, so a result > 0 means the
// exact inter / union is below best, and its rounding is at most best,
// which a strict > does not take (best only grows within the four). An
// unmasked gt always gives an IoU >= 0 and a masked one -1, so the plain
// version's strict > from -1, then the clamp at 0, yields: (0, first
// unmasked gt) when the maximum is 0; (0, 0) when every gt is masked; else
// (m, the first gt reaching m > 0). That gt has iw, ih > 0 against its
// anchor, hence against U and UB, so both culls keep it, and the filter
// does not skip it before best reaches m; the lists keep gt order, and a
// strict > from 0 takes the first of them reaching m. The kernel gives the
// same (value, index) in all three cases. (For finite inputs whose areas
// do not overflow: a NaN IoU breaks the plain version's chunked max too.)

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;              // anchors per block, one per thread
constexpr int NW = NT / 32;          // warps per block
constexpr int CAP = 1024;            // the block's list of kept gt
constexpr int ILP = 4;               // kept gt taken together by each lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 union4(float4 u, float4 v) {
  return make_float4(fminf(u.x, v.x), fminf(u.y, v.y), fmaxf(u.z, v.z), fmaxf(u.w, v.w));
}

__device__ __forceinline__ float4 warp_union(float4 u) {
  for (int off = 16; off > 0; off >>= 1) {
    u = union4(u, make_float4(__shfl_xor_sync(FULL, u.x, off), __shfl_xor_sync(FULL, u.y, off),
                              __shfl_xor_sync(FULL, u.z, off), __shfl_xor_sync(FULL, u.w, off)));
  }
  return u;
}

// Whether gt q can overlap a box inside u: the pair test's own fp32
// expressions for the width and the height, with u in place of the anchor.
__device__ __forceinline__ bool may_overlap(float4 u, float4 q) {
  return fminf(u.z, q.z) - fmaxf(u.x, q.x) + 1.f > 0.f &&
         fminf(u.w, q.w) - fmaxf(u.y, q.y) + 1.f > 0.f;
}

struct Best {
  float iou = 0.f;
  int idx = -1;          // no gt with IoU > 0 yet
};

// One warp's pass over the block's list gs[0, total): keep the entries that
// may overlap the warp's union box u, in list order, then take them against
// the lane's anchor a (area `area`).
__device__ __forceinline__ void walk_list(const float4* gs, const int* gs_idx, int total,
                                          unsigned short* kept, int lane, float4 u, float4 a,
                                          float area, Best& best) {
  const unsigned lower = (1u << lane) - 1u;
  int nk = 0;
  for (int b = 0; b < total; b += 32) {
    const bool k = b + lane < total && may_overlap(u, gs[b + lane]);
    const unsigned bits = __ballot_sync(FULL, k);
    if (k) kept[nk + __popc(bits & lower)] = b + lane;
    nk += __popc(bits);
  }
  __syncwarp();
  // ILP gt at a time: their terms and divisions are independent of each
  // other, and the updates go in list order. Past the end the last kept gt
  // repeats, and a repeat never wins a strict >.
  for (int k = 0; k < nk; k += ILP) {
    int g[ILP];
    float inter[ILP], uni[ILP];
    bool need[ILP];
    bool any = false;
#pragma unroll
    for (int t = 0; t < ILP; ++t) {
      g[t] = kept[min(k + t, nk - 1)];
      const float4 q = gs[g[t]];
      // the plain version's terms, operation by operation (iou_matrix)
      const float q_area = (q.z - q.x + 1.f) * (q.w - q.y + 1.f);
      const float iw = fmaxf(fminf(a.z, q.z) - fmaxf(a.x, q.x) + 1.f, 0.f);
      const float ih = fmaxf(fminf(a.w, q.w) - fmaxf(a.y, q.y) + 1.f, 0.f);
      inter[t] = iw * ih;
      uni[t] = area + q_area - inter[t];
      // whether the quotient can beat best (see the header)
      need[t] = inter[t] > 0.f && uni[t] > 0.f && !(fmaf(best.iou, uni[t], -inter[t]) > 0.f);
      any |= need[t];
    }
    if (!__any_sync(FULL, any)) continue;
    float iou[ILP];
#pragma unroll
    for (int t = 0; t < ILP; ++t) iou[t] = need[t] ? inter[t] / uni[t] : 0.f;
#pragma unroll
    for (int t = 0; t < ILP; ++t) {
      if (iou[t] > best.iou) {
        best.iou = iou[t];
        best.idx = gs_idx[g[t]];
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
max_iou_kernel(const float4* __restrict__ anchors, const float4* __restrict__ gt,
               const unsigned char* __restrict__ mask, int N, int G,
               float* __restrict__ out_iou, int* __restrict__ out_idx) {
  __shared__ float4 gs[CAP];           // the gt that the block's union box keeps
  __shared__ int gs_idx[CAP];          // and their indices, in gt order
  __shared__ int warp_kept[2][NW], warp_first[2][NW];
  __shared__ float4 warp_u[NW];
  __shared__ unsigned short kept_s[NW][CAP];   // each warp's list
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * NT + threadIdx.x;
  const bool real = n < N;
  const float4 a = real ? anchors[n] : make_float4(0.f, 0.f, 0.f, 0.f);
  // padding lanes give the identity of the union, not the origin
  const float4 u = warp_union(real ? a : make_float4(CUDART_INF_F, CUDART_INF_F,
                                                     -CUDART_INF_F, -CUDART_INF_F));
  if (lane == 0) warp_u[warp] = u;
  __syncthreads();
  float4 ub = warp_u[0];               // the block's union box
  for (int w = 1; w < NW; ++w) ub = union4(ub, warp_u[w]);
  const float area = (a.z - a.x + 1.f) * (a.w - a.y + 1.f);
  Best best;
  int first = -1;        // the first unmasked gt; the same in every thread
  int total = 0;         // entries in the block's list
  // The block's cull: the gt stream through NT at a time, one per thread,
  // and those that are unmasked and may overlap ub go to the end of the
  // list in gt order (a prefix over the warps' counts). Each thread loads
  // its next gt while it places this one.
  float4 q_next = make_float4(0.f, 0.f, 0.f, 0.f);
  bool m_next = static_cast<int>(threadIdx.x) < G && mask[threadIdx.x] != 0;
  if (static_cast<int>(threadIdx.x) < G) q_next = gt[threadIdx.x];
  for (int g0 = 0, step = 0; g0 < G; g0 += NT, step ^= 1) {
    const int i = g0 + threadIdx.x;
    const float4 q = q_next;
    const bool live = m_next;
    const bool more = i + NT < G;
    m_next = more && mask[i + NT] != 0;
    if (more) q_next = gt[i + NT];
    const bool keep = live && may_overlap(ub, q);
    const unsigned live_bits = __ballot_sync(FULL, live);
    const unsigned keep_bits = __ballot_sync(FULL, keep);
    if (lane == 0) {
      warp_kept[step][warp] = __popc(keep_bits);
      warp_first[step][warp] = live_bits ? g0 + warp * 32 + __ffs(live_bits) - 1 : -1;
    }
    __syncthreads();  // also: the last step's entries are in the list
    int offset = 0, step_total = 0;
    for (int w = 0; w < NW; ++w) {
      if (w == warp) offset = step_total;
      step_total += warp_kept[step][w];
      if (first < 0) first = warp_first[step][w];
    }
    if (total + step_total > CAP) {    // the list is full: walk it first
      walk_list(gs, gs_idx, total, kept_s[warp], lane, u, a, area, best);
      total = 0;
      __syncthreads();
    }
    if (keep) {
      const int k = total + offset + __popc(keep_bits & ((1u << lane) - 1u));
      gs[k] = q;
      gs_idx[k] = i;
    }
    total += step_total;
  }
  __syncthreads();
  walk_list(gs, gs_idx, total, kept_s[warp], lane, u, a, area, best);
  if (real) {
    out_iou[n] = best.iou;
    out_idx[n] = best.idx >= 0 ? best.idx : max(first, 0);
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t). Returns a cudaError_t:
// 0 on a successful launch. Does not synchronise.
extern "C" int shf_max_iou(const float* anchors, const float* gt, const unsigned char* mask,
                           float* out_iou, int* out_idx, int N, int G, void* stream) {
  if (N < 0 || G < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  max_iou_kernel<<<(N + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(anchors), reinterpret_cast<const float4*>(gt), mask,
      N, G, out_iou, out_idx);
  return (int)cudaGetLastError();
}

extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
