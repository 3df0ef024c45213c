// multibox_nms.cu — the greedy non-maximum suppression of SSD's
// MultiBoxDetection over rows already ordered by descending score.
//
// Rows are [batch, anchors, 6] float32: (class_id, score, xmin, ymin,
// xmax, ymax).  For each row i in turn, if row i is still alive (class id
// >= 0), every later live row j of the same class (any class with
// force_suppress) whose IoU with row i is at least the threshold gets
// class id -1; scores and coordinates are kept.  The result goes to a
// second tensor; the input rows are only read.
//
// Replaces: no pl.pallas_call.  The JAX package computes this step as
// fori_loop(0, num_anchors, nms_step, rows) (mxnet_tpu/ops/multibox.py:
// 260-279), which XLA keeps on the device as one loop.  In PyTorch that
// loop would be about twelve launches per anchor (7308 anchors at SSD's
// 300x300: ~90k launches a forward, or a CUDA graph of as many nodes).
//
// Bound: the rows are read once and written once (48 bytes a row); the
// operations are the IoU tests the greedy scan needs on these rows (each
// row alive at its turn against every later live row), ~16 float32
// operations each.  At SSD's 8 x 7308 rows that is ~0.007 ms; the scan's
// order is what makes it slow, not its arithmetic: phase A tests ~7x the
// pairs the greedy scan needs, in parallel, and phase B is serial in row
// blocks, not rows.
//
// Design: walking the rows in order in one block per image, a barrier
// per kept row, leaves most SMs idle and waits on a dependent round per
// row; this kernel splits the scan into a phase over the whole card and a
// short serial one over row blocks, with the greedy result exactly.  Row
// j ends suppressed iff some earlier row i is kept (alive at its turn),
// both rows are valid at the start (class id >= 0), the classes match at
// the start (any class under force_suppress) and IoU(i, j) >= threshold:
// a class id only ever changes to -1, so the classes at the start are all
// the scan needs.
//
// - Phase A (nms_masks), on every SM: a grid over (upper-triangle 64 x 64
//   tile, image).  A block stages its 64 column rows in shared memory;
//   each of its 64 threads owns one row i and writes one 64-bit word
//   mask[i][cb] whose bit k says that row i would suppress row
//   j = 64 cb + k (j > i, the conditions above).  The diagonal tile also
//   copies its rows to the output, writes the block's word of rows valid
//   at the start, and its 64 words again side by side for the scan.  A
//   row block with no valid row writes no mask word, and phase B never
//   reads one of its words, so the workspace needs no memset.  A pair is
//   tested by its clamped width and height first (most pairs do not
//   overlap), then against a bound that never drops a hit (the
//   intersection against the threshold times the larger area), and only
//   then divided.
// - Phase B (nms_scan), one block of 8 warps per image: a bitmap of
//   removed rows, a word per row block, in shared memory.  For each row
//   block in order, warp 0 resolves its candidates (valid, not removed)
//   from their diagonal words, loaded two blocks ahead, a lane two rows:
//   a candidate that no other undecided candidate can remove is kept and
//   removes the rows its word covers, so a block without conflicts inside
//   takes one round of two warp reductions.  After a barrier the kept
//   rows go to the 8 warps in turn, and each ORs its rows' later words
//   (contiguous in a row: a lane a column) into the bitmap, nonzero words
//   only, and all meet at a second barrier; a block with no kept row
//   needs neither.  At the end each removed row valid at the start gets
//   class id -1 in the output.
//
// The IoU uses the plain version's expression and operation order, each
// operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn; no FMA contraction), so the rows it keeps match the plain
// version in mxnet_tpu_torch/ops/multibox.py bit for bit (finite boxes).
//
// Workspace: (anchors + 1 + 64) x words 64-bit words per image (words =
// ceil(anchors / 64)): the mask rows, the valid words, the diagonal words
// (about anchors^2 / 8 bytes an image: 6.78 MB at 7308 anchors, 422.6 MB
// at the limit of 58,112).  The caller allocates it.  Images go in phase
// A's grid y dimension: at most 65,535 a call.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; returns the cudaError_t of the launches.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;          // rows a row block = bits a word
constexpr int kMaxWords = 908;      // 58,112 anchors: the scan's bitmaps,
                                    // 2 x 7.3 KB of shared memory
constexpr int kScanWarps = 8;       // a kept row a warp, in turn
constexpr int kScanThreads = kScanWarps * 32;

// the value two rows must share for one to suppress the other: the class
// id, or 0 for every valid row under force_suppress.  An invalid row's key
// (a negative class id or NaN, or -1 under force_suppress) equals no
// valid row's.
__device__ __forceinline__ float class_key(float c, int force) {
  return force ? (c >= 0.0f ? 0.0f : -1.0f) : c;
}

__device__ __forceinline__ long long tri_offset(long long r, long long n) {
  return r * n - r * (r - 1) / 2;   // tiles in rows 0..r-1 of the triangle
}

__global__ void __launch_bounds__(kBlock)
    nms_masks(const float* __restrict__ rows, float* __restrict__ out,
              u64* __restrict__ ws, int anchors, int words, float threshold,
              int force) {
  // the column rows: a box, +inf/-inf where it has no positive width or
  // height (it overlaps nothing); its area and class key
  __shared__ float4 cbox[kBlock];
  __shared__ float2 ckey[kBlock];
  __shared__ unsigned vbits[2];
  // the tile (rb, cb), cb >= rb, from the block's place in the triangle
  const long long t = blockIdx.x;
  const double n2 = 2.0 * words + 1.0;
  int rb = (int)((n2 - sqrt(n2 * n2 - 8.0 * (double)t)) * 0.5);
  while (rb > 0 && tri_offset(rb, words) > t) --rb;
  while (tri_offset(rb + 1, words) <= t) ++rb;
  const int cb = rb + (int)(t - tri_offset(rb, words));
  const int b = blockIdx.y, k = threadIdx.x;
  const float* r = rows + (size_t)b * anchors * 6;
  u64* masks = ws + (size_t)b * (anchors + 1 + kBlock) * words;

  const int i = rb * kBlock + k;
  float row[6] = {-1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < anchors)
    for (int e = 0; e < 6; ++e) row[e] = r[(size_t)i * 6 + e];
  const bool valid = row[0] >= 0.0f;
  if (rb == cb) {
    if (i < anchors)
      for (int e = 0; e < 6; ++e) out[((size_t)b * anchors + i) * 6 + e] =
          row[e];
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if ((k & 31) == 0) vbits[k >> 5] = ballot;
  }
  const int any = __syncthreads_or(valid);
  if (rb == cb && k == 0)
    masks[(size_t)anchors * words + rb] = ((u64)vbits[1] << 32) | vbits[0];
  if (!any) return;   // uniform: no row of this block can suppress

  const int j = cb * kBlock + k;
  float jc = -1.0f;
  float4 jb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j < anchors) {
    const float* q = r + (size_t)j * 6;
    jc = q[0];
    jb = make_float4(q[2], q[3], q[4], q[5]);
  }
  cbox[k] = jb.z > jb.x && jb.w > jb.y
                ? jb : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  ckey[k] = make_float2(
      __fmul_rn(__fsub_rn(jb.z, jb.x), __fsub_rn(jb.w, jb.y)),
      class_key(jc, force));
  __syncthreads();

  u64 bits = 0;
  const float ikey = class_key(row[0], force);
  const float ix0 = row[2], iy0 = row[3], ix1 = row[4], iy1 = row[5];
  if (valid && threshold <= 0.0f) {
    // every IoU the plain version computes is >= 0 (0 where the union is
    // not positive): every later row of the same key
    for (int c = 0; c < kBlock; ++c)
      if (ckey[c].y == ikey) bits |= 1ull << c;
  } else if (valid && threshold > 0.0f && ix1 > ix0 && iy1 > iy0) {
    const float area_i =
        __fmul_rn(__fsub_rn(ix1, ix0), __fsub_rn(iy1, iy0));
    // a filter that never drops a hit: the union is at least the larger
    // area less 2^-22 of it, so IoU >= threshold needs the intersection
    // >= thr_lo x that area (2^-16 of slack)
    const float thr_lo = __fmul_rd(threshold, 0.9999847412109375f);
#pragma unroll 16
    for (int c = 0; c < kBlock; ++c) {
      const float4 q = cbox[c];
      // the plain version's clamped width and height, where both are
      // positive (a box with no extent is +inf/-inf: never)
      const float w = __fsub_rn(fminf(q.z, ix1), fmaxf(q.x, ix0));
      const float h = __fsub_rn(fminf(q.w, iy1), fmaxf(q.y, iy0));
      if ((w > 0.0f) & (h > 0.0f)) {
        const float2 ak = ckey[c];
        const float inter = __fmul_rn(w, h);
        if ((ak.y == ikey) &
            (inter >= __fmul_rn(thr_lo, fmaxf(ak.x, area_i)))) {
          const float uni = __fsub_rn(__fadd_rn(ak.x, area_i), inter);
          if ((uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) >= threshold)
            bits |= 1ull << c;
        }
      }
    }
  }
  if (rb == cb) bits &= (~0ull << k) << 1;   // only later rows: j > i
  if (i < anchors) masks[(size_t)i * words + cb] = bits;
  // the diagonal words again, a row block's 64 side by side, for the scan
  if (rb == cb) masks[((size_t)anchors + 1) * words + rb * kBlock + k] = bits;
}

// the OR of a 64-bit word over the warp
__device__ __forceinline__ u64 warp_or(u64 x) {
  return ((u64)__reduce_or_sync(0xffffffffu, (unsigned)(x >> 32)) << 32) |
         __reduce_or_sync(0xffffffffu, (unsigned)x);
}

// the words of the rows of ``rows`` among the two this lane holds
__device__ __forceinline__ u64 words_of(u64 rows, u64 lo, u64 hi,
                                        int lane) {
  return (rows >> lane & 1 ? lo : 0) | (rows >> (lane + 32) & 1 ? hi : 0);
}

// the candidates of a row block in greedy order (warp 0; lane l holds
// the diagonal words of rows l and l + 32): returns the kept rows.  A
// candidate no other undecided candidate can remove is kept, and the
// rows its word covers go; the lowest undecided row is always kept, and
// without conflicts inside the block one round decides every row.
__device__ __forceinline__ u64 resolve(u64 cand, u64 lo, u64 hi, int lane) {
  u64 kept = 0;
  while (cand) {
    const u64 sure = cand & ~warp_or(words_of(cand, lo, hi, lane));
    kept |= sure;
    if (sure == cand) break;
    cand &= ~sure & ~warp_or(words_of(sure, lo, hi, lane));
  }
  return kept;
}

__device__ __forceinline__ void or_word(u64* p, u64 v) {
  unsigned* q = reinterpret_cast<unsigned*>(p);
  if ((unsigned)v) atomicOr(q, (unsigned)v);
  if ((unsigned)(v >> 32)) atomicOr(q + 1, (unsigned)(v >> 32));
}

__global__ void __launch_bounds__(kScanThreads, 1)
    nms_scan(float* __restrict__ out, const u64* __restrict__ ws,
             int anchors, int words) {
  __shared__ u64 removed[kMaxWords];
  __shared__ u64 gone[kMaxWords];
  __shared__ u64 kept_at[2];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const u64* masks = ws + (size_t)b * (anchors + 1 + kBlock) * words;
  for (int w = tid; w < words; w += kScanThreads) removed[w] = gone[w] = 0;
  __syncthreads();
  // warp 0's diagonal and valid words, loaded two row blocks ahead
  u64 lo[2] = {0, 0}, hi[2] = {0, 0}, v[2] = {0, 0};
  const u64* diag = masks + (size_t)(anchors + 1) * words;
  auto load = [&](int rb, int slot) {
    const bool live = rb < words;
    lo[slot] = live ? diag[rb * kBlock + lane] : 0;
    hi[slot] = live ? diag[rb * kBlock + 32 + lane] : 0;
    v[slot] = live ? masks[(size_t)anchors * words + rb] : 0;
  };
  if (warp == 0) {
    load(0, 0);
    load(1, 1);
  }
  for (int rb = 0; rb < words; ++rb) {
    const int slot = rb & 1;
    // 1. warp 0 resolves the block's rows
    if (warp == 0) {
      const u64 valid = slot ? v[1] : v[0];
      const u64 kept = resolve(valid & ~removed[rb], slot ? lo[1] : lo[0],
                               slot ? hi[1] : hi[0], lane);
      if (lane == 0) {
        kept_at[slot] = kept;
        gone[rb] = valid & ~kept;
      }
      if (slot)
        load(rb + 2, 1);
      else
        load(rb + 2, 0);
    }
    __syncthreads();
    // kept_at alternates: warp 0 writes this slot again two blocks on,
    // after every thread has passed the next block's barrier
    const u64 kept = kept_at[slot];
    if (!kept) continue;   // uniform: nothing to OR, no second barrier
    // 2. the kept rows' words into the removed bitmap of the later row
    //    blocks: kept row number n goes to warp n % 8, a lane a column
    const int rank_lo = __popcll(kept & ((1ull << lane) - 1));
    const int rank_hi = __popcll(kept & ((1ull << (lane + 32)) - 1));
    u64 mine =
        (u64)__ballot_sync(0xffffffffu, (kept >> (lane + 32) & 1) &&
                                            rank_hi % kScanWarps == warp)
            << 32 |
        __ballot_sync(0xffffffffu,
                      (kept >> lane & 1) && rank_lo % kScanWarps == warp);
    const u64* block = masks + (size_t)rb * kBlock * words;
    while (mine) {
      // up to four of this warp's rows at once, four columns a lane
      int row[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        row[u] = mine ? __ffsll((long long)mine) - 1 : -1;
        mine &= mine - 1;
      }
      for (int c0 = rb + 1; c0 < words; c0 += 128) {
        u64 x[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 32 * e + lane;
            x[u][e] = row[u] >= 0 && c < words
                          ? block[(size_t)row[u] * words + c] : 0;
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const u64 acc = x[0][e] | x[1][e] | x[2][e] | x[3][e];
          if (acc) or_word(&removed[c0 + 32 * e + lane], acc);
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();
  // each removed row valid at the start: class id -1
  float* o = out + (size_t)b * anchors * 6;
  for (int i = tid; i < anchors; i += kScanThreads)
    if (gone[i / kBlock] >> (i % kBlock) & 1) o[(size_t)i * 6] = -1.0f;
}

}  // namespace

// rows: [batch, anchors, 6] float32, contiguous, read only; out: the same
// shape, written; ws: batch x (anchors + 65) x ceil(anchors / 64) 64-bit
// words of workspace, phase A's words (phase B only reads them).  Runs
// phase A then phase B.  Returns the cudaError_t of the launches
// (0 = cudaSuccess).
extern "C" int mxtpu_multibox_nms(const void* rows, void* out, void* ws,
                                  long long batch, long long anchors,
                                  float threshold, int force_suppress,
                                  void* stream) {
  if (batch <= 0 || anchors <= 0 || batch > 65535 ||
      anchors > (long long)kMaxWords * kBlock)
    return (int)cudaErrorInvalidValue;
  const int words = (int)((anchors + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (long long)words * (words + 1) / 2;
  nms_masks<<<dim3((unsigned)tiles, (unsigned)batch), kBlock, 0, s>>>(
      static_cast<const float*>(rows), static_cast<float*>(out),
      static_cast<u64*>(ws), (int)anchors, words, threshold, force_suppress);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_scan<<<(unsigned)batch, kScanThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const u64*>(ws), (int)anchors,
      words);
  return (int)cudaGetLastError();
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
