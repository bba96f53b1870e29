// Gossip merge kernels for Hopper (sm_90a), bound to Python with ctypes
// (dpwa_tpu_torch/ops/merge.py).  Both compute, per element,
//
//     x' = (1 - a) * x + a * y,   y = the partner's value as it arrived
//
// in float32 with one fused multiply-add, in the form XLA's CPU backend
// emits for the reference's `(1 - a) * x + a * y`
// (dpwa_tpu/parallel/stacked.py) on each wire, so the results are the
// reference's bit for bit:
//
//   f32 wire   fmaf(a, y, __fmul_rn(1 - a, x))   the own product rounded
//   bf16 wire  fmaf(1 - a, x, __fmul_rn(a, y))   y rounded to bf16 first;
//                                                here XLA fuses the other
//                                                product
//   int8 wire  fmaf(1 - a, x, __fmul_rn(a, y))   y the partner's row as
//                                                dequantized, read from w
//
// The intrinsics pin each form: left to nvcc's --fmad=true, the
// contraction could fuse either product and change the last bit.
//
// The partner's value comes from x itself, or, in the wire forms, from a
// second float32 buffer w of the same row layout: the int8 wire's
// dequantized rows (dpwa_tpu_torch/ops/quantize.py), what each peer would
// have shipped.  w never aliases x.
//
// B1  dpwa_pair_merge_f32 replaces dpwa_tpu/ops/merge.py::_pair_merge_impl
//     (entry pallas_pair_merge).  In place over explicit pair lists: for pair
//     k with rows L = left[k], R = right[k],
//         x[L] <- lerp(alpha[L], x[L], y[R]),  x[R] <- lerp(alpha[R], x[R], y[L])
//     both from the pre-merge values, y = x, or w in the wire form.  A pair
//     with L == R is either a pad, skipped so the row stays bit-identical
//     (merge_self = 0), or a row that sits the round out, merged with itself
//     (with its own wire row) at its alpha of 0 as the reference's stacked
//     exchange merges it: 1*x + 0*y, which turns an inf or a NaN in y into
//     a NaN (merge_self = 1).  Both lanes of a self-pair write the same
//     value to the same address.
// B2  dpwa_gather_merge_f32 replaces dpwa_tpu/ops/merge.py::pallas_pairwise_merge.
//     Out of place: out[i] <- lerp(alpha[i], x[i], y[partner[i]]).  Its w may
//     also hold bf16 values: the TCP transport's landed bf16 frame, merged
//     over one row [1, d] as read off the wire (upcast in registers, as the
//     reference's device engine bitcasts and upcasts in-graph), so no f32
//     copy of the frame is ever written.
//
// B2 has more forms for the TCP transport's codec frames, each one row
// and the int8 arithmetic fma(1 - a, x, a * y) with a the host's alpha:
//   dpwa_int8_frame_merge   y = q[j] * s[j / 256], the landed int8-chunked
//       frame's codes and scales (dpwa_tpu/device/kernels.py::build_int8),
//       the dequantisation rounded on its own as the reference's decode
//       rounds it, so the dense float32 frame is never written;
//   dpwa_topk_merge         a top-k frame's whole merge in one pass
//       (dpwa_tpu/device/kernels.py::build_topk and ::build_shard_topk):
//       out[i] = x[i] outside the slice [lo, hi) (the other shards of a
//       shard frame, bit-identical), lerp(a, x[i], x[i]) inside it (B2's
//       self-lerp: the densified frame equals x off the support), and
//       lerp(a, x[i], v[j]) at i = lo + idx[j] over the k sorted, unique
//       slice positions idx.  It rounds as the reference's host merge of the
//       densified frame (native.merge_out) rounds, the path the transport
//       follows.
//   dpwa_support_merge      out[idx[j]] = lerp(a, x[idx[j]], v[j]) alone,
//       after B2's self-lerp of the row has written the rest: the two-launch
//       route dpwa_topk_merge replaced, kept to be timed against it.
//   dpwa_fold_merge         out = x, then out <- lerp(t_i, out, r_i) for the k
//       landed float32 rows r_0 ... r_{k-1} in arrival order (the fan-in
//       round's and the async drain's runs of dense frames,
//       dpwa_tpu/device/kernels.py::build_fold), bit-equal to k launches of
//       B2 one after the other: each product t_i * r_i rounded on its own,
//       1 - t_i in float32.  One pass: x and every row read once, out
//       written once, (k + 2) * 4 bytes an element; the k row pointers and
//       alphas are device arrays, so one compiled kernel serves every k.  It
//       moves float4 words where every row shares x's and out's phase within
//       16 bytes (the card's allocations all do), else scalars.
// The int8-frame and support forms are grid-stride loops of scalar loads and stores: the int8 form moves
// 9 bytes an element (x, q and out; the scales are 1/64 of a byte), the
// support form 16 bytes a support element (its index, value, x and out, 4
// bytes each).  Each of the support form's scattered 4-byte reads and writes
// touches a whole 32-byte sector, so it moves several times its bound.
//
// The top-k form moves 8 bytes an element of the row (x read, out written)
// and 8 a support element (idx and v read once), its floor.  A CTA owns a
// tile of kTile floats: it loads the tile's x as float4 words, and while
// those loads are in flight two warps find the tile's run [j0, j1) of the
// sorted support by a 32-ary search each (one probe a lane, a ballot keeps
// the stretch that holds the bound; log32(k) rounds, in L2).  x and its
// self-lerp (or copy, outside the slice) are staged in shared memory, the
// run's idx and v are read coalesced and each entry overwrites its slot
// from the staged x, and the tile leaves as float4 words.  So every
// scattered write lands in shared memory, not in a 32-byte sector of device
// memory.  The scalar head and tail of a row that does not start on a
// 16-byte boundary sit in the first and last tiles; out is allocated at x's
// phase within 16 bytes, so the tiles always move float4 words.
//
// What bounds them on the card: device-memory bytes.  B1 moves 2*rows*d*4
// bytes (each touched row read once and written once, the floor for any
// merge), 3*rows*d*4 in the wire form (w's rows read too); B2 moves
// 3*n*d*4 (own row, partner row, output row), 10*n*d with a bf16 w.  Both
// do 3 flops per
// element, about 0.4 flop per byte, far under the H100's float32 ridge of
// some 20 flops per byte, so the arithmetic is free and only the bytes
// count.
//
// What the design does about it: every thread moves 16-byte float4 words,
// neighbouring threads on neighbouring addresses, in a grid-stride loop over
// the row, so each warp issues fully coalesced 512-byte transactions.
// Nothing is reused, so there is no shared memory and no staging: a value
// is loaded into a register, merged and stored.  The pair (B1) or peer (B2)
// index comes from blockIdx.y and each block loads its own row indices and
// alphas from device arrays, which stand in for the TPU kernels' scalar
// prefetch: one compiled kernel serves every pairing of a schedule pool, and
// a step only passes another row of the pool already resident on the card.
// Rows of different pairs are disjoint, so the in-place update of B1 has no
// aliasing hazard.  A row whose start is not 16-byte aligned takes up to
// three scalar head elements first; the ragged tail (d not a multiple of 4)
// is masked the same way.  Where rows do not share one alignment (a row
// stride that is not a multiple of 4 floats, or buffers whose rows start at
// different offsets within 16 bytes) the scalar form runs instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks along a row at most; a longer row is covered by the grid-stride
// loop.  With 8 pairs this still puts ~16k blocks in flight.
constexpr int64_t kMaxBlocksPerRow = 2048;

// The merge's arithmetic on each wire (see the top of the file).
enum Form : int { kF32 = 0, kBf16 = 1, kInt8 = 2 };

// (1 - a) * x + a * y with y the partner's value as it came over the wire.
template <int kForm>
__device__ __forceinline__ float lerp(float a, float x, float y) {
  if (kForm == kBf16) {
    const float yw = __bfloat162float(__float2bfloat16_rn(y));
    return fmaf(__fsub_rn(1.f, a), x, __fmul_rn(a, yw));
  }
  if (kForm == kInt8) return fmaf(__fsub_rn(1.f, a), x, __fmul_rn(a, y));
  return fmaf(a, y, __fmul_rn(__fsub_rn(1.f, a), x));
}

// Merges a pair's element in place: l, r the rows' own values, yl, yr
// what each row ships (the same values, or the wire rows').
template <int kForm>
__device__ __forceinline__ void merge_pair(float al, float ar, float& l, float& r,
                                           float yl, float yr) {
  const float nl = lerp<kForm>(al, l, yr);
  const float nr = lerp<kForm>(ar, r, yl);
  l = nl;
  r = nr;
}

// Elements of a row that the scalar edges cover: [0, head) and [tail0, d).
__device__ __forceinline__ bool edge_index(int64_t t, int64_t head, int64_t tail0,
                                           int64_t d, int64_t* j) {
  if (t < head) {
    *j = t;
    return true;
  }
  const int64_t k = tail0 + (t - head);
  *j = k;
  return k < d;
}

// kWire: the partner's value comes from w (ld_w apart), not from x.
template <int kForm, bool kVec, bool kWire>
__global__ void __launch_bounds__(kThreads)
pair_merge_kernel(float* x, int64_t ld, const float* __restrict__ w, int64_t ld_w,
                  int64_t d, int64_t head, const int* __restrict__ left,
                  const int* __restrict__ right, const float* __restrict__ alpha,
                  int merge_self) {
  const int k = blockIdx.y;
  const int l = __ldg(left + k);
  const int r = __ldg(right + k);
  if (l == r && !merge_self) return;  // pad self-pair: exact no-op
  const float al = __ldg(alpha + l);
  const float ar = __ldg(alpha + r);
  float* xl = x + static_cast<int64_t>(l) * ld;
  float* xr = x + static_cast<int64_t>(r) * ld;
  const float* wl = kWire ? w + static_cast<int64_t>(l) * ld_w : xl;
  const float* wr = kWire ? w + static_cast<int64_t>(r) * ld_w : xr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const int64_t n4 = (d - head) >> 2;
    float4* vl = reinterpret_cast<float4*>(xl + head);
    float4* vr = reinterpret_cast<float4*>(xr + head);
    const float4* ul = reinterpret_cast<const float4*>(wl + head);
    const float4* ur = reinterpret_cast<const float4*>(wr + head);
    for (int64_t i = t0; i < n4; i += stride) {
      float4 a = vl[i];
      float4 b = vr[i];
      const float4 ya = kWire ? __ldg(ul + i) : a;
      const float4 yb = kWire ? __ldg(ur + i) : b;
      merge_pair<kForm>(al, ar, a.x, b.x, ya.x, yb.x);
      merge_pair<kForm>(al, ar, a.y, b.y, ya.y, yb.y);
      merge_pair<kForm>(al, ar, a.z, b.z, ya.z, yb.z);
      merge_pair<kForm>(al, ar, a.w, b.w, ya.w, yb.w);
      vl[i] = a;
      vr[i] = b;
    }
    int64_t j;
    if (edge_index(t0, head, head + (n4 << 2), d, &j)) {
      const float ya = kWire ? wl[j] : xl[j];
      const float yb = kWire ? wr[j] : xr[j];
      merge_pair<kForm>(al, ar, xl[j], xr[j], ya, yb);
    }
  } else {
    for (int64_t j = t0; j < d; j += stride) {
      const float ya = kWire ? wl[j] : xl[j];
      const float yb = kWire ? wr[j] : xr[j];
      merge_pair<kForm>(al, ar, xl[j], xr[j], ya, yb);
    }
  }
}

// The partner's rows as float32 or bf16 values: one element, and four
// consecutive ones (a float4, or 8 bytes of bf16 widened exactly).
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// y: the rows the partner's value is read from (x itself, or w), ld_y apart,
// of element type Y (float, or bf16 for a w that holds a bf16 frame).
template <int kForm, bool kVec, typename Y>
__global__ void __launch_bounds__(kThreads)
gather_merge_kernel(const float* x, int64_t ld_x, const Y* y, int64_t ld_y,
                    float* __restrict__ out, int64_t ld_out, int64_t d,
                    int64_t head, const int* __restrict__ partner,
                    const float* __restrict__ alpha) {
  const int i = blockIdx.y;
  const int p = __ldg(partner + i);
  const float a = __ldg(alpha + i);
  const float* xs = x + static_cast<int64_t>(i) * ld_x;
  const Y* yp = y + static_cast<int64_t>(p) * ld_y;
  float* o = out + static_cast<int64_t>(i) * ld_out;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const int64_t n4 = (d - head) >> 2;
    const float4* vs = reinterpret_cast<const float4*>(xs + head);
    float4* vo = reinterpret_cast<float4*>(o + head);
    for (int64_t q = t0; q < n4; q += stride) {
      const float4 s = __ldg(vs + q);
      const float4 v = load4(yp + head + 4 * q);
      float4 m;
      m.x = lerp<kForm>(a, s.x, v.x);
      m.y = lerp<kForm>(a, s.y, v.y);
      m.z = lerp<kForm>(a, s.z, v.z);
      m.w = lerp<kForm>(a, s.w, v.w);
      vo[q] = m;
    }
    int64_t j;
    if (edge_index(t0, head, head + (n4 << 2), d, &j)) {
      o[j] = lerp<kForm>(a, xs[j], load1(yp + j));
    }
  } else {
    for (int64_t j = t0; j < d; j += stride) {
      o[j] = lerp<kForm>(a, xs[j], load1(yp + j));
    }
  }
}

// Scalar elements before the first 16-byte boundary of a row starting at p.
int64_t head_of(const void* p, int64_t d) {
  const int64_t h = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  return h < d ? h : d;
}

dim3 grid_for(int64_t work, int rows) {
  int64_t bx = (work + kThreads - 1) / kThreads;
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(rows));
}

// Launch the instantiation for a form and a row layout.
template <int kForm>
void launch_pair(bool vec, bool wire, dim3 grid, cudaStream_t s, float* x, int64_t ld,
                 const float* w, int64_t ld_w, int64_t d, int64_t head, const int* left,
                 const int* right, const float* alpha, int merge_self) {
  auto kernel = vec ? (wire ? pair_merge_kernel<kForm, true, true> : pair_merge_kernel<kForm, true, false>)
                    : (wire ? pair_merge_kernel<kForm, false, true> : pair_merge_kernel<kForm, false, false>);
  kernel<<<grid, kThreads, 0, s>>>(x, ld, w, ld_w, d, head, left, right, alpha, merge_self);
}

template <int kForm, typename Y>
void launch_gather(bool vec, dim3 grid, cudaStream_t s, const float* x, int64_t ld_x,
                   const Y* y, int64_t ld_y, float* out, int64_t ld_out, int64_t d,
                   int64_t head, const int* partner, const float* alpha) {
  auto kernel = vec ? gather_merge_kernel<kForm, true, Y> : gather_merge_kernel<kForm, false, Y>;
  kernel<<<grid, kThreads, 0, s>>>(x, ld_x, y, ld_y, out, ld_out, d, head, partner, alpha);
}

template <typename Y>
void launch_gather_form(int form, bool vec, dim3 grid, cudaStream_t s, const float* x,
                        int64_t ld_x, const Y* y, int64_t ld_y, float* out, int64_t ld_out,
                        int64_t d, int64_t head, const int* partner, const float* alpha) {
  if (form == kF32) launch_gather<kF32>(vec, grid, s, x, ld_x, y, ld_y, out, ld_out, d, head, partner, alpha);
  else if (form == kBf16) launch_gather<kBf16>(vec, grid, s, x, ld_x, y, ld_y, out, ld_out, d, head, partner, alpha);
  else launch_gather<kInt8>(vec, grid, s, x, ld_x, y, ld_y, out, ld_out, d, head, partner, alpha);
}

__global__ void __launch_bounds__(kThreads)
int8_frame_merge_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ scales, float* __restrict__ out, int64_t d,
                        float a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < d; j += stride) {
    const float y = __fmul_rn(static_cast<float>(q[j]), __ldg(scales + (j >> 8)));
    out[j] = lerp<kInt8>(a, __ldg(x + j), y);
  }
}

__global__ void __launch_bounds__(kThreads)
support_merge_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                     const float* __restrict__ v, float* __restrict__ out, int64_t k, float a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < k; j += stride) {
    const int64_t i = __ldg(idx + j);
    out[i] = lerp<kInt8>(a, __ldg(x + i), __ldg(v + j));
  }
}

// B2's top-k form (see the top of the file).  Tile t holds the row's
// elements from base = head + t * kTile on at shared slots kPad + (i - base),
// so its float4 words sit on 16-byte slots; tile 0 also holds the head's
// scalars (slots below kPad) and the last tile the tail's.
constexpr int kTile = 4096;
constexpr int kTileWords = kTile / 4;
constexpr int kWordsPerThread = kTileWords / kThreads;
constexpr int kPad = 4;

// First j in [0, k) with idx[j] >= key, or k; by a whole warp.  Each round
// lane l probes position lo + n * l / 32 of the n left; the first lane whose
// probe is >= key (a ballot) bounds the answer from above, the lane before
// it from below.
__device__ int64_t warp_lower_bound(const int* __restrict__ idx, int64_t k, int64_t key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = k;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t p = lo + ((hi - lo) * lane) / 32;
    const unsigned ge = __ballot_sync(0xffffffffu, __ldg(idx + p) >= key);
    const int f = ge ? __ffs(ge) - 1 : 32;
    const long long below = __shfl_sync(0xffffffffu, static_cast<long long>(p), f > 0 ? f - 1 : 0);
    const long long at = __shfl_sync(0xffffffffu, static_cast<long long>(p), f < 32 ? f : 31);
    if (f == 0) {
      hi = lo;
    } else {
      lo = below + 1;
      if (f < 32) hi = at;
    }
  }
  return lo;
}

// x's value at row position i in the top-k form: its self-lerp inside the
// slice, itself outside.
__device__ __forceinline__ float slice_lerp(float a, float xi, int64_t i, int64_t lo, int64_t hi) {
  return i >= lo && i < hi ? lerp<kInt8>(a, xi, xi) : xi;
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ v, int64_t k, float* __restrict__ out, int64_t d,
                  int64_t head, int64_t lo, int64_t hi, float a) {
  __shared__ float4 staged4[kTileWords + 2];  // x
  __shared__ float4 merged4[kTileWords + 2];  // out
  __shared__ int64_t run[2];
  float* staged = reinterpret_cast<float*>(staged4);
  float* merged = reinterpret_cast<float*>(merged4);
  const int tid = threadIdx.x;
  const int64_t base = head + static_cast<int64_t>(blockIdx.x) * kTile;
  const bool first = blockIdx.x == 0;
  const bool last = blockIdx.x == gridDim.x - 1;
  const int64_t body = (d - head) >> 2;  // float4 words of the row
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTileWords;
  const int nw = static_cast<int>(body - w0 < kTileWords ? body - w0 : kTileWords);
  // The head's scalars (tile 0, threads 0-2) and the tail's (the last
  // tile, threads 4-6): element ei.
  const int64_t ei = tid < 4 ? tid : head + 4 * body + tid - 4;
  const bool edge = tid < 4 ? first && tid < head : last && tid < 8 && ei < d;
  // The tile's words, loaded before the search.
  const float4* vx = reinterpret_cast<const float4*>(x + head) + w0;
  float4 r[kWordsPerThread];
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int w = tid + u * kThreads;
    if (w < nw) r[u] = __ldg(vx + w);
  }
  // The tile's run of the support: its slice positions [s0, s1).
  if (tid < 64) {
    const int64_t begin = first ? 0 : base;
    const int64_t end = last ? d : base + kTile;
    const int64_t s0 = (begin > lo ? begin : lo) - lo;
    const int64_t s1 = (end < hi ? end : hi) - lo;
    const int64_t j = s0 < s1 ? warp_lower_bound(idx, k, tid < 32 ? s0 : s1) : 0;
    if ((tid & 31) == 0) run[tid >> 5] = j;
  }
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int w = tid + u * kThreads;
    if (w < nw) {
      const int64_t i = head + 4 * (w0 + w);
      staged4[1 + w] = r[u];
      merged4[1 + w] = make_float4(slice_lerp(a, r[u].x, i, lo, hi), slice_lerp(a, r[u].y, i + 1, lo, hi),
                                   slice_lerp(a, r[u].z, i + 2, lo, hi), slice_lerp(a, r[u].w, i + 3, lo, hi));
    }
  }
  if (edge) {
    const int slot = static_cast<int>(kPad + ei - base);
    staged[slot] = x[ei];
    merged[slot] = slice_lerp(a, staged[slot], ei, lo, hi);
  }
  __syncthreads();
  // Each support entry of the tile overwrites its slot from the staged x.
  const int64_t j1 = run[1];
  for (int64_t j = run[0] + tid; j < j1; j += kThreads) {
    const int slot = static_cast<int>(lo + __ldg(idx + j) - base) + kPad;
    merged[slot] = lerp<kInt8>(a, staged[slot], __ldg(v + j));
  }
  __syncthreads();
  float4* vo = reinterpret_cast<float4*>(out + head) + w0;
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int w = tid + u * kThreads;
    if (w < nw) vo[w] = merged4[1 + w];
  }
  if (edge) out[ei] = merged[kPad + ei - base];
}

// B2's fold form (see the top of the file): rows[i] and alphas[i] are read
// from device arrays; head scalars, then float4 words, then the tail.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fold_merge_kernel(const float* __restrict__ x, const float* const* __restrict__ rows,
                  const float* __restrict__ alphas, int k, float* __restrict__ out, int64_t d,
                  int64_t head) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const int64_t n4 = (d - head) >> 2;
    const float4* vx = reinterpret_cast<const float4*>(x + head);
    float4* vo = reinterpret_cast<float4*>(out + head);
    for (int64_t q = t0; q < n4; q += stride) {
      float4 acc = __ldg(vx + q);
      for (int i = 0; i < k; ++i) {
        const float a = __ldg(alphas + i);
        const float4 v = __ldg(reinterpret_cast<const float4*>(rows[i] + head) + q);
        acc.x = lerp<kInt8>(a, acc.x, v.x);
        acc.y = lerp<kInt8>(a, acc.y, v.y);
        acc.z = lerp<kInt8>(a, acc.z, v.z);
        acc.w = lerp<kInt8>(a, acc.w, v.w);
      }
      vo[q] = acc;
    }
    int64_t j;
    if (edge_index(t0, head, head + (n4 << 2), d, &j)) {
      float acc = x[j];
      for (int i = 0; i < k; ++i) acc = lerp<kInt8>(__ldg(alphas + i), acc, rows[i][j]);
      out[j] = acc;
    }
  } else {
    for (int64_t j = t0; j < d; j += stride) {
      float acc = x[j];
      for (int i = 0; i < k; ++i) acc = lerp<kInt8>(__ldg(alphas + i), acc, rows[i][j]);
      out[j] = acc;
    }
  }
}

bool same_phase(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == (reinterpret_cast<uintptr_t>(b) & 15);
}

// A bf16 row whose element j sits on an 8-byte boundary exactly where the
// float32 row's element j sits on a 16-byte one.
bool same_phase_bf16(const float* x, const void* w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x), b = reinterpret_cast<uintptr_t>(w);
  return (b & 1) == 0 && ((a & 15) >> 2) == ((b & 7) >> 1);
}

}  // namespace

extern "C" {

// B1.  x: [n, ld] float32 rows (the first d columns merge); w: null (the
// partner's value from x) or [n, ld_w] float32 rows not overlapping x (the
// wire form); left/right: int32[n_pairs]; alpha: float32[n]; form: 0 f32,
// 1 bf16, 2 int8 arithmetic; merge_self: whether an L == R pair is merged
// (1) or skipped as a pad (0).  Returns the cudaError_t of the launch.
int dpwa_pair_merge_f32(float* x, int64_t ld, int64_t d, const float* w, int64_t ld_w,
                        const int* left, const int* right, int n_pairs,
                        const float* alpha, int form, int merge_self, void* stream) {
  if (n_pairs <= 0 || d <= 0) return 0;
  if (form < kF32 || form > kInt8) return static_cast<int>(cudaErrorInvalidValue);
  const bool wire = w != nullptr;
  const bool vec = ld % 4 == 0 && (!wire || (ld_w % 4 == 0 && same_phase(x, w)));
  const int64_t head = vec ? head_of(x, d) : 0;
  const dim3 grid = grid_for(vec ? (d - head) / 4 + 1 : d, n_pairs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kF32) launch_pair<kF32>(vec, wire, grid, s, x, ld, w, ld_w, d, head, left, right, alpha, merge_self);
  else if (form == kBf16) launch_pair<kBf16>(vec, wire, grid, s, x, ld, w, ld_w, d, head, left, right, alpha, merge_self);
  else launch_pair<kInt8>(vec, wire, grid, s, x, ld, w, ld_w, d, head, left, right, alpha, merge_self);
  return static_cast<int>(cudaGetLastError());
}

// B2.  x: [n, ld_x] float32; w: null (the partner's value from x) or
// [n, ld_w] rows (the wire form) of float32 (w_bf16 = 0) or bf16 values
// (w_bf16 = 1); out: [n, ld_out] float32 (overlapping neither); partner:
// int32[n]; alpha: float32[n]; form as for B1.  Returns the launch's
// cudaError_t.
int dpwa_gather_merge_f32(const float* x, int64_t ld_x, const void* w, int64_t ld_w,
                          int w_bf16, float* out, int64_t ld_out, int64_t d, int n,
                          const int* partner, const float* alpha, int form,
                          void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (form < kF32 || form > kInt8 || (w_bf16 && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* y = w != nullptr ? w : x;
  const int64_t ld_y = w != nullptr ? ld_w : ld_x;
  const bool vec = ld_x % 4 == 0 && ld_out % 4 == 0 && ld_y % 4 == 0 && same_phase(x, out) &&
                   (w_bf16 ? same_phase_bf16(x, y) : same_phase(x, y));
  const int64_t head = vec ? head_of(x, d) : 0;
  const dim3 grid = grid_for(vec ? (d - head) / 4 + 1 : d, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    launch_gather_form(form, vec, grid, s, x, ld_x, static_cast<const __nv_bfloat16*>(y), ld_y,
                       out, ld_out, d, head, partner, alpha);
  else
    launch_gather_form(form, vec, grid, s, x, ld_x, static_cast<const float*>(y), ld_y,
                       out, ld_out, d, head, partner, alpha);
  return static_cast<int>(cudaGetLastError());
}

// B2's int8-frame form.  x: float32[d]; q: int8[d]; scales: float32[ceil(d /
// 256)]; out: float32[d], overlapping none of them.  Returns the launch's
// cudaError_t.
int dpwa_int8_frame_merge(const float* x, const int8_t* q, const float* scales, float* out,
                          int64_t d, float alpha, void* stream) {
  if (d <= 0) return 0;
  const dim3 grid = grid_for(d, 1);
  int8_frame_merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, q, scales, out, d, alpha);
  return static_cast<int>(cudaGetLastError());
}

// B2's support form.  x, out: float32 rows of the same length (out may be
// x's own output buffer, never x); idx: int32[k] unique indices into them;
// v: float32[k].  Returns the launch's cudaError_t.
int dpwa_support_merge(const float* x, const int* idx, const float* v, float* out, int64_t k,
                       float alpha, void* stream) {
  if (k <= 0) return 0;
  const dim3 grid = grid_for(k, 1);
  support_merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, v, out, k, alpha);
  return static_cast<int>(cudaGetLastError());
}

// B2's top-k form.  x, out: float32[d], not overlapping, at one phase within
// 16 bytes (the wrapper allocates out so); [lo, hi): the slice of the row the
// frame covers ([0, d) for a whole-row frame); idx: int32[k], sorted, unique
// positions in [0, hi - lo) (not checked here: the frame's decoder checks
// them); v: float32[k].  Returns the launch's cudaError_t.
int dpwa_topk_merge(const float* x, const int* idx, const float* v, int64_t k, float* out,
                    int64_t d, int64_t lo, int64_t hi, float alpha, void* stream) {
  if (d <= 0) return 0;
  if (lo < 0 || hi < lo || hi > d || k < 0 || k > hi - lo || !same_phase(x, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t head = head_of(x, d);
  const int64_t words = (d - head) / 4;
  const int64_t tiles = words > kTileWords ? (words + kTileWords - 1) / kTileWords : 1;
  topk_merge_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, v, k, out, d, head, lo, hi, alpha);
  return static_cast<int>(cudaGetLastError());
}

// B2's fold form.  x, out: float32[d], not overlapping; rows: a device array
// of k pointers to float32[d] rows; alphas: float32[k] on the device; vec:
// whether x, out and every row share one phase within 16 bytes (the caller
// knows the rows' addresses, this side does not read them).  Returns the
// launch's cudaError_t.
int dpwa_fold_merge(const float* x, const float* const* rows, const float* alphas, int k,
                    float* out, int64_t d, int vec, void* stream) {
  if (d <= 0 || k <= 0) return 0;
  const int64_t head = vec ? head_of(x, d) : 0;
  const dim3 grid = grid_for(vec ? (d - head) / 4 + 1 : d, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    fold_merge_kernel<true><<<grid, kThreads, 0, s>>>(x, rows, alphas, k, out, d, head);
  else
    fold_merge_kernel<false><<<grid, kThreads, 0, s>>>(x, rows, alphas, k, out, d, head);
  return static_cast<int>(cudaGetLastError());
}

const char* dpwa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
