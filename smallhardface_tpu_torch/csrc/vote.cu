// The final vote of a detection for NVIDIA Hopper (sm_90a): greedy
// score-weighted box voting (BBOX_VOTE) and greedy NMS over the top
// candidates of each image of a batch.
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
// (n_valid, (B,) int32, read on the device). Each image is voted on its
// own, exactly as a call for that image alone would vote it (the
// counterpart of jax.vmap over the JAX functions). Each step takes the
// lowest remaining row as its head and computes every remaining row's IoU
// with it as inter / (area[head] + area - inter), +1 pixel convention.
// Vote: the cluster is the rows with IoU >= thresh; two or more emit
// (sum score*box / sum score, max score), one row is emitted only when
// nothing remains after it. NMS: the head is emitted and the rows with
// IoU > thresh are dropped. The head always belongs to its own cluster (its
// IoU with itself is 1 for any box of positive area; taking it outright
// makes every step remove a row). Every operation of an IoU is one IEEE fp32
// operation in the plain version's order: no fused multiply-add
// (-fmad=false) and a correctly rounded division, so a cluster's members,
// the count of rows emitted and the max score equal the plain version's to
// the bit; the sums of a merged box are taken in another, fixed order
// (within rounding; exact where every product and sum is, as on small
// integer boxes with dyadic scores): the order of the one-block kernel
// (512 threads, two block barriers a step) that this design replaced,
// whose output it equals to the bit. No atomics: two calls give the same
// bits, and a batch gives each image the bits of its own call.
//
// Outputs. out (B, V, 5) fp32: each image's emitted rows in order, zeros
// after them; n_out (B,) int32, written on the device, so that the caller
// reads back only the rows it needs, after one synchronisation. The
// caller's out buffer continues past those B*V*5 floats with the scratch
// of the three phases below, B * scratch_words(V) 32-bit words
// (nms_device.py allocates both in one torch.empty): for each image, the
// V x words_of(V) membership mask, then V emission records.
//
// What bounds it. The work is a chain of dependent steps, one per cluster:
// a step needs the previous one's head. Over all steps the IoUs number at
// most V(V-1)/2 pairs, about 25 fp32 operations each, a correctly rounded
// division among them (5e7 at V = 2048, under 1 us at the card's fp32
// rate), and the rows are 20 V bytes to read once. So the bound is far
// below one step's latency: the time is the chain's, and the design keeps
// on it only bit operations on registers, with one L2 round trip for each
// 32 rows rather than one for each head.
//
// Design: three launches on the caller's stream, one C call; the second
// and third are programmatic dependent launches (they start while the one
// before runs and wait for it with griddepcontrol.wait before reading what
// it wrote).
// A. vote_mask_kernel (parallel; a block per 16 rows x 256 columns of an
//    image's upper triangle): bit j of mask row i (i < j < n_valid) is set
//    when j would join i's cluster, by the chain's own IoU expression with
//    i as the head. The head of a step is always the lowest remaining row,
//    so the upper triangle is every test the chain can ask for. Two
//    neighbouring lanes make one word of a row (16 columns each, read from
//    shared memory with a pad of one slot in 33: no bank conflict). A zero
//    intersection is decided without the division (0 / union is +-0 or
//    NaN), which a zero numerator would send down its slow path.
// B. vote_walk_kernel (one warp per image, no block barrier): the
//    remaining rows are a bitmask in the lanes' registers (word
//    k * 32 + lane in register k: 2 words a lane at V = 2048), taken 32
//    rows (one word) at a time. The heads among a word's rows follow from
//    each row's diagonal word alone (its bits for the same 32 rows,
//    prefetched a word ahead): the lowest remaining row, then remaining &=
//    ~row, by __ffs and one shuffle a head. Then the heads' full rows are
//    loaded together (HEAD_CHUNK at once, one L2 round trip) and applied
//    in order: cluster = remaining & row, remaining &= ~row. One
//    __reduce_or_sync gives each head whether its cluster merges; the
//    lane of each head writes its record (the merged heads in order, and
//    the last head when it is a single row) and, for the vote, the
//    cluster's words over the head's mask row (that row is never read
//    again), for phase C. Words whose rows are all gone are skipped with a
//    ballot. No score or box is read on the chain.
// C. vote_emit_kernel (parallel; a block of 512 threads per emitted row):
//    copies a head's row, or sums a merged cluster's members as one step of
//    the earlier one-block kernel did (thread t takes its members
//    t + 512 k in ascending k, eight rows' loads in flight, then a shuffle
//    tree in each warp and one over the 16 warps' partials), so that its
//    rows equal that kernel's to the bit; one thread divides and writes
//    the row. The grid also writes the zero tail.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>

namespace {

constexpr int MAX_ROWS = 8192;
constexpr unsigned FULL = 0xffffffffu;
// phase A: a block of MASK_THREADS covers MASK_WORDS words (TILE_COLS
// columns) of MASK_ROWS rows, two threads a word
constexpr int MASK_THREADS = 256;
constexpr int MASK_WORDS = 8;
constexpr int MASK_ROWS = MASK_THREADS / 2 / MASK_WORDS;
constexpr int TILE_COLS = 32 * MASK_WORDS;
constexpr int TILE_SLOTS = TILE_COLS + TILE_COLS / 32;
// phase C: at most EMIT_BLOCKS blocks of EMIT_THREADS per image; thread t
// owns rows t + EMIT_THREADS k, as each step of the earlier one-block
// kernel did, so that a merged box is summed in that kernel's order
constexpr int EMIT_THREADS = 512;
constexpr int EMIT_WARPS = EMIT_THREADS / 32;
constexpr int ROWS_PER_THREAD = MAX_ROWS / EMIT_THREADS;
constexpr int EMIT_BLOCKS = 128;
constexpr int EMIT_BATCH = 8;   // member rows loaded before they are summed

__host__ __device__ inline int words_of(int V) { return (V + 31) / 32; }

// scratch of one image in 32-bit words: the mask, then the records
__host__ __device__ inline size_t scratch_words(int V) {
  return (size_t)V * words_of(V) + V;
}

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// waits until the kernel before on the stream has finished and its writes
// are visible
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <bool VOTE>
__global__ void __launch_bounds__(MASK_THREADS)
    vote_mask_kernel(const float* __restrict__ dets, const int* __restrict__ n_valid_p,
                     int V, float thresh, unsigned* __restrict__ scratch) {
  __shared__ float cx1[TILE_SLOTS], cy1[TILE_SLOTS], cx2[TILE_SLOTS], cy2[TILE_SLOTS],
      ca[TILE_SLOTS];
  launch_dependents();
  const int b = blockIdx.z;
  const int n_valid = min(max(n_valid_p[b], 0), V);
  const int row0 = blockIdx.y * MASK_ROWS, col0 = blockIdx.x * TILE_COLS;
  // nothing above the diagonal, or no candidate, in this tile
  if (row0 >= n_valid || col0 >= n_valid || col0 + TILE_COLS - 1 <= row0) return;
  const int W = words_of(V);
  dets += (size_t)b * V * 5;
  unsigned* mask = scratch + (size_t)b * scratch_words(V);
  const int half = threadIdx.x & 1, q = threadIdx.x >> 1;
  const int wl = q % MASK_WORDS, i = row0 + q / MASK_WORDS;
  const int w = blockIdx.x * MASK_WORDS + wl;   // this thread's word of row i
  const int j0 = w * 32 + 16 * half;            // its 16 columns
  const bool live = i < n_valid && w < W;
  const bool any = live && j0 + 15 > i && j0 < n_valid;
  // row i's box, loaded beside the tile's columns
  float hx1 = 0.0f, hy1 = 0.0f, hx2 = 0.0f, hy2 = 0.0f;
  if (any) {
    const float* d = dets + 5 * (size_t)i;
    hx1 = d[0];
    hy1 = d[1];
    hx2 = d[2];
    hy2 = d[3];
  }
  const int ncols = min(TILE_COLS, n_valid - col0);
  for (int t = threadIdx.x; t < ncols; t += MASK_THREADS) {
    const float* d = dets + 5 * (size_t)(col0 + t);
    const float x1 = d[0], y1 = d[1], x2 = d[2], y2 = d[3];
    const int s = t + (t >> 5);
    cx1[s] = x1;
    cy1[s] = y1;
    cx2[s] = x2;
    cy2[s] = y2;
    ca[s] = area_of(x1, y1, x2, y2);
  }
  __syncthreads();
  unsigned bits = 0;
  if (any) {
    const float ha = area_of(hx1, hy1, hx2, hy2);
    const bool zero_member = VOTE ? 0.0f >= thresh : 0.0f > thresh;
#pragma unroll 8
    for (int t = 0; t < 16; ++t) {
      const int j = j0 + t;
      const int s = wl * 33 + 16 * half + t;   // column j's slot
      const float iw = fmaxf(0.0f, fminf(hx2, cx2[s]) - fmaxf(hx1, cx1[s]) + 1.0f);
      const float ih = fmaxf(0.0f, fminf(hy2, cy2[s]) - fmaxf(hy1, cy1[s]) + 1.0f);
      const float inter = iw * ih;
      const float uni = ha + ca[s] - inter;
      const float iou = (inter == 0.0f ? 1.0f : inter) / uni;
      const bool member = inter == 0.0f ? zero_member && uni == uni && uni != 0.0f
                          : VOTE        ? iou >= thresh
                                        : iou > thresh;
      if (member && j > i && j < n_valid) bits |= 1u << (16 * half + t);
    }
  }
  bits |= __shfl_xor_sync(FULL, bits, 1);
  if (live && !half) mask[(size_t)i * W + w] = bits;
}

// register k of a lane's words, for a k known only at run time
template <int WPL>
__device__ __forceinline__ unsigned pick(const unsigned (&r)[WPL], int k) {
  unsigned v = 0u;
#pragma unroll
  for (int i = 0; i < WPL; ++i)
    if (i == k) v = r[i];
  return v;
}

// The lowest word index >= w0 whose remaining rows are not all gone; -1
// when none is left. Warp-uniform.
template <int WPL>
__device__ __forceinline__ int next_block(const unsigned (&rem)[WPL], int w0, int lane) {
  int blk = -1;
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    if (blk < 0 && k >= (w0 >> 5)) {
      const unsigned ballot = __ballot_sync(FULL, rem[k] != 0u && k * 32 + lane >= w0);
      if (ballot) blk = k * 32 + __ffs(ballot) - 1;
    }
  }
  return blk;
}

template <bool VOTE, int WPL>
__global__ void __launch_bounds__(32)
    vote_walk_kernel(const int* __restrict__ n_valid_p, int V, unsigned* __restrict__ scratch,
                     int* __restrict__ n_out) {
  // heads whose full rows are loaded together: HEAD_CHUNK x WPL registers
  constexpr int HEAD_CHUNK = WPL <= 2 ? 16 : 32 / WPL;
  const int b = blockIdx.x, lane = threadIdx.x;
  const int W = words_of(V);
  const int n_valid = min(max(n_valid_p[b], 0), V);
  unsigned* mask = scratch + (size_t)b * scratch_words(V);
  int* rec = reinterpret_cast<int*>(mask + (size_t)V * W);
  unsigned rem[WPL];
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    const int lo = (k * 32 + lane) * 32;
    rem[k] = lo >= n_valid ? 0u : n_valid - lo >= 32 ? FULL : (1u << (n_valid - lo)) - 1u;
  }
  launch_dependents();
  wait_for_previous();
  // lane t: the diagonal word (word blk) of row 32 blk + t
  auto diag_of = [&](int blk) {
    const int row = 32 * blk + lane;
    return row < n_valid ? __ldcg(mask + (size_t)row * W + blk) : 0u;
  };
  int count = 0, last = -1;
  bool last_merged = false;
  int blk = next_block(rem, 0, lane);
  unsigned diag = blk >= 0 ? diag_of(blk) : 0u;
  while (blk >= 0) {
    const int kb = blk >> 5, lb = blk & 31;   // the register and lane of word blk
    const unsigned next_diag = diag_of(blk + 1);   // the likely next block's
    unsigned cur = __shfl_sync(FULL, pick(rem, kb), lb);
    // the block's heads in order, from the diagonal words alone: lane u
    // keeps the u-th head's offset and its members in this word
    int nh = 0;
    unsigned my_head = 0u, my_intra = 0u;
    while (cur) {
      const int t = __ffs(cur) - 1;
      const unsigned row_w = __shfl_sync(FULL, diag, t);
      if (lane == nh) {
        my_head = t;
        my_intra = cur & row_w;
      }
      cur &= ~row_w & ~(1u << t);
      ++nh;
    }
#pragma unroll
    for (int k = 0; k < WPL; ++k)
      if (k == kb && lane == lb) rem[k] = 0u;
    const int my_row = 32 * blk + my_head;
    // the words after blk: the heads' full rows, in chunks, taken in order
    for (int c0 = 0; c0 < nh; c0 += HEAD_CHUNK) {
      const int n = min(HEAD_CHUNK, nh - c0);
      int head[HEAD_CHUNK];
      unsigned r[HEAD_CHUNK][WPL];
#pragma unroll
      for (int u = 0; u < HEAD_CHUNK; ++u) {
        head[u] = __shfl_sync(FULL, my_row, (c0 + u) & 31);
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          const int w = k * 32 + lane;
          r[u][k] = u < n && w > blk && w < W ? __ldcg(mask + (size_t)head[u] * W + w) : 0u;
        }
      }
      unsigned others = 0u;   // bit u: this lane saw a later member of head u
#pragma unroll
      for (int u = 0; u < HEAD_CHUNK; ++u) {
        if (u >= n) break;
        unsigned* row = mask + (size_t)head[u] * W;
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          const unsigned c = rem[k] & r[u][k];
          rem[k] &= ~r[u][k];
          if (c) others |= 1u << u;
          const int w = k * 32 + lane;
          if (VOTE && w > blk && w < W) __stcg(row + w, c);
        }
      }
      // lane c0 + u: head u's merge flag, record and word blk
      const bool mine = lane >= c0 && lane < c0 + n;
      const unsigned later = VOTE ? __reduce_or_sync(FULL, others) : 0u;
      const bool merged = VOTE && mine && (my_intra != 0u || ((later >> (lane - c0)) & 1u));
      const unsigned emit = VOTE ? __ballot_sync(FULL, merged) : __ballot_sync(FULL, mine);
      if (VOTE && mine) __stcg(mask + (size_t)my_row * W + blk, my_intra | (1u << my_head));
      if (emit & (1u << lane))
        rec[count + __popc(emit & ((1u << lane) - 1u))] = 2 * my_row + (merged ? 1 : 0);
      count += __popc(emit);
      if (c0 + n == nh) {
        last = __shfl_sync(FULL, my_row, nh - 1);
        last_merged = (emit >> (nh - 1)) & 1u;
      }
    }
    const int nb = next_block(rem, blk + 1, lane);
    diag = nb == blk + 1 ? next_diag : nb >= 0 ? diag_of(nb) : 0u;
    blk = nb;
  }
  // a single row is emitted when nothing remains after it: the last head
  if (VOTE && last >= 0 && !last_merged) {
    if (lane == 0) rec[count] = 2 * last;
    ++count;
  }
  if (lane == 0) n_out[b] = count;
}

struct Partial {
  float s, sx1, sy1, sx2, sy2, smax;
};

__device__ __forceinline__ Partial warp_reduce(Partial p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    p.s += __shfl_down_sync(FULL, p.s, off);
    p.sx1 += __shfl_down_sync(FULL, p.sx1, off);
    p.sy1 += __shfl_down_sync(FULL, p.sy1, off);
    p.sx2 += __shfl_down_sync(FULL, p.sx2, off);
    p.sy2 += __shfl_down_sync(FULL, p.sy2, off);
    p.smax = fmaxf(p.smax, __shfl_down_sync(FULL, p.smax, off));
  }
  return p;
}

template <bool VOTE>
__global__ void __launch_bounds__(EMIT_THREADS)
    vote_emit_kernel(const float* __restrict__ dets, int V, const unsigned* __restrict__ scratch,
                     const int* __restrict__ n_out_p, float* __restrict__ out) {
  __shared__ Partial partials[EMIT_WARPS];
  const int b = blockIdx.y;
  const int W = words_of(V);
  dets += (size_t)b * V * 5;
  out += (size_t)b * V * 5;
  const unsigned* mask = scratch + (size_t)b * scratch_words(V);
  const int* rec = reinterpret_cast<const int*>(mask + (size_t)V * W);
  wait_for_previous();
  // this block's first record is read beside the count (past n_out it is
  // not used)
  const int n = __ldcg(n_out_p + b);
  int code = blockIdx.x < V ? __ldcg(rec + blockIdx.x) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int slot = blockIdx.x; slot < n; slot += gridDim.x) {   // block-uniform
    if (slot != blockIdx.x) code = __ldcg(rec + slot);
    const int head = code >> 1;
    float* o = out + 5 * (size_t)slot;
    if (!VOTE || !(code & 1)) {
      if (tid < 5) o[tid] = dets[5 * (size_t)head + tid];
      continue;
    }
    // thread t sums its members t + EMIT_THREADS k in ascending k: bit
    // `lane` of word warp + EMIT_WARPS k (the words below the head's hold
    // no member and may be unwritten)
    const unsigned* words = mask + (size_t)head * W;
    const int hw = head >> 5;
    bool m[ROWS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int w = warp + EMIT_WARPS * k;
      m[k] = w >= hw && w < W && ((__ldcg(words + w) >> lane) & 1u);
    }
    Partial p = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -INFINITY};
#pragma unroll
    for (int k0 = 0; k0 < ROWS_PER_THREAD; k0 += EMIT_BATCH) {
      float v[EMIT_BATCH][5];
#pragma unroll
      for (int u = 0; u < EMIT_BATCH; ++u) {
        const float* d = dets + 5 * ((size_t)tid + EMIT_THREADS * (k0 + u));
#pragma unroll
        for (int f = 0; f < 5; ++f) v[u][f] = m[k0 + u] ? d[f] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < EMIT_BATCH; ++u) {
        if (!m[k0 + u]) continue;
        const float sc = v[u][4];
        p.s += sc;
        p.sx1 += v[u][0] * sc;
        p.sy1 += v[u][1] * sc;
        p.sx2 += v[u][2] * sc;
        p.sy2 += v[u][3] * sc;
        p.smax = fmaxf(p.smax, sc);
      }
    }
    p = warp_reduce(p);
    if (lane == 0) partials[warp] = p;
    __syncthreads();
    if (warp == 0) {
      Partial q = lane < EMIT_WARPS ? partials[lane]
                                    : Partial{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -INFINITY};
      q = warp_reduce(q);
      if (lane == 0) {
        o[0] = q.sx1 / q.s;
        o[1] = q.sy1 / q.s;
        o[2] = q.sx2 / q.s;
        o[3] = q.sy2 / q.s;
        o[4] = q.smax;
      }
    }
    __syncthreads();   // partials are reused by the next slot
  }
  for (size_t f = 5 * (size_t)n + blockIdx.x * EMIT_THREADS + tid; f < 5 * (size_t)V;
       f += (size_t)gridDim.x * EMIT_THREADS)
    out[f] = 0.0f;
}

// A launch that may start while the kernel before it on the stream runs
// (programmatic dependent launch): the kernel calls wait_for_previous()
// before it reads what that kernel wrote.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = 0;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

template <bool VOTE, int WPL>
cudaError_t walk(const int* n_valid, int B, int V, unsigned* scratch, int* n_out,
                 cudaStream_t s) {
  return launch_dependent(vote_walk_kernel<VOTE, WPL>, dim3(B), dim3(32), s, n_valid, V,
                          scratch, n_out);
}

template <bool VOTE>
int launch(const float* dets, const int* n_valid, int B, int V, float thresh, float* out,
           int* n_out, void* stream) {
  if (B <= 0 || B > 65535 || V < 0 || V > MAX_ROWS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* scratch = reinterpret_cast<unsigned*>(out + (size_t)B * V * 5);
  const int W = words_of(V);
  cudaError_t e;
  if (V > 0) {
    const dim3 grid((W + MASK_WORDS - 1) / MASK_WORDS, (V + MASK_ROWS - 1) / MASK_ROWS, B);
    vote_mask_kernel<VOTE><<<grid, MASK_THREADS, 0, s>>>(dets, n_valid, V, thresh, scratch);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  // the registers a lane needs for the remaining rows: W / 32, rounded up
  // to a power of two
  e = W <= 32    ? walk<VOTE, 1>(n_valid, B, V, scratch, n_out, s)
      : W <= 64  ? walk<VOTE, 2>(n_valid, B, V, scratch, n_out, s)
      : W <= 128 ? walk<VOTE, 4>(n_valid, B, V, scratch, n_out, s)
                 : walk<VOTE, 8>(n_valid, B, V, scratch, n_out, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(std::min(EMIT_BLOCKS, std::max(1, V)), B);
  return (int)launch_dependent(vote_emit_kernel<VOTE>, grid, dim3(EMIT_THREADS), s, dets, V,
                               scratch, n_out, out);
}

}  // namespace

// B images of V rows each in one call (B = 1 for one image); out holds
// B * V * 5 floats, then B * (V * ceil(V / 32) + V) words of scratch.
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
