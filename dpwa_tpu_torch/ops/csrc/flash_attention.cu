// Flash attention in float32 for Hopper (sm_90a), forward and backward,
// bound to Python with ctypes: B5 (dpwa_tpu_torch/ops/flash_attention.py)
// and the ring-attention hops B3 and B4 (dpwa_tpu_torch/ops/flash_ring.py).
//
// B5 replaces the flash branch of dpwa_tpu/ops/ulysses.py::
// single_device_attention (:108-126), which calls JAX's library TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention (:119), forward and
// backward.  It computes, per batch b and query head h,
//
//     O = softmax(scale * Q K^T [+ causal mask]) V,   scale = 1/sqrt(D),
//     lse = m + log(l)   (the row's log-sum-exp, saved for the backward)
//
// on q [B, T, H, D], k and v [B, T, KV, D] (contiguous, float32), with query
// head h reading key/value head h / (H / KV): grouped-query attention is
// read in place, not expanded.  D is 128, the Llama path's head dim (the
// kernels are written for any multiple of 64, but only 128 is built); T a
// multiple of 64 (the Python wrapper holds T to a multiple of 128, as the
// reference does).
//
// What bounds it on this card: operations.  On the Llama path the tensors
// are float32 (the reference promotes its "bf16" model to f32 before
// attention), and float32 products run outside the tensor cores at 67 TF/s.
// The causal forward does 2*B*H*T^2*D flops (QK^T and PV over half the
// square), the backward about 2.5 times that; at B = 4, H = 32, T = 2048,
// D = 128 that is 137 GFLOP, a bound of 2.05 ms, while its bytes (0.34 GB)
// take 0.1 ms.  A float32 kernel cannot be bound by bytes here.
//
// What the design does about it: every product is a register-blocked FMA
// loop over tiles staged in shared memory.  A block of 256 threads (16 x 16)
// owns a 64-row query tile (forward, dQ) or key tile (dK/dV); each thread
// keeps a 4 x 4 block of the 64 x 64 score tile and a 4 x (D/16) block of
// the 64 x D accumulator in registers, so every shared-memory float4 read
// feeds four or more FMAs.  Tiles are stored with a row stride of D + 4
// floats, which makes the float4 reads of 16 different rows conflict-free.
// The score tile never touches device memory (online softmax in the
// forward, recomputation from the saved lse in the backward).  Causal
// blocks skip the tiles above the diagonal, mask the diagonal tile, and are
// launched heaviest first.  No tensor cores (wgmma takes tf32, not f32),
// no TMA: that is work for a later pass.
//
// B3 and B4 replace dpwa_tpu/ops/flash_ring.py::_hop_fwd_pallas (:71) and
// _hop_bwd_pallas (:156), which call the same library's
// _flash_attention_impl (:75) and _flash_attention_bwd_dkv / _dq (:163,
// :169) for one hop of ring attention: the query block of sequence-parallel
// rank `me` against the key/value block of rank src = (me - hop) mod sp.
// On one card the sp ranks are a virtual axis: q, k and v hold the whole
// sequence, sp blocks of t_local rows, and ONE launch runs a hop for every
// rank, each reading its source block in place (the ring moves no bytes).
// A rank's case in a hop (2 bits of `cases`): skip (a future block: o = 0
// and lse = -1e30, the reference's _NEG_INF, and no work), diag (causal
// within the block) or full.  A launch may also cover a panel of the
// blocks, `rows` rows from q_off in each query block against `rows` rows
// from k_off in each key block: the zigzag layout's half stripes
// (dpwa_tpu/ops/zigzag_ring.py:157-306).
//   B3: one hop's o [B, sp * rows, H, D] and lse [B, H, sp * rows], rank
//       after rank, as the reference's kernel returns them (o normalised,
//       lse = m + log l).
//   B4: given the GLOBAL lse and delta = rowsum(O * dO) ([B, H, T]), one
//       hop's exact global gradients, ADDED into dq at the query rows and
//       into dk, dv at the source block's rows: p = exp(s - lse) is the
//       global softmax restricted to the block held.  In one launch every
//       key block has one writer (src and me are one to one), so the sums
//       need no atomics; hops follow each other on the stream.
// B5 is the same kernels over one rank (sp = 1, rows = T), storing instead
// of adding.  A ring over T does the flops of causal attention over T.
//
// The kernels (four):
//   fwd_kernel    one block per (query tile, b*h, rank): O and lse.
//   delta_kernel  one warp per (b, t, h) row: delta = rowsum(dO * O) (B5).
//   dkdv_kernel   one block per (key tile, b*kv, source block): dK and dV,
//                 looping over the group's query heads and the query tiles,
//                 P recomputed.
//   dq_kernel     one block per (query tile, b*h, rank): dQ.
// Softmax uses expf and logf, not the fast intrinsics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLdP = kTile + 4; // row stride of a 64 x 64 tile in shared memory
constexpr int kSkip = 0, kDiag = 1, kFull = 2;  // a rank's case in a hop
constexpr float kNegInf = -1e30f;  // a skipped block's lse (the reference's _NEG_INF)

// The rows a launch reads.  q, k and v hold sp blocks of t_local rows
// (T = sp * t_local rows in all); rank `me` takes the query rows
// [q_off, q_off + rows) of block me and the key rows [k_off, k_off + rows)
// of block src = (me - hop) mod sp, in case (cases >> 2 me) & 3.  B5 is
// {1, T, T, 0, 0, 0, diag or full}.
struct Panel {
  int sp, t_local, rows, q_off, k_off, hop;
  unsigned long long cases;

  __device__ int case_of(int me) const { return static_cast<int>((cases >> (2 * me)) & 3ull); }
  __device__ int src_of(int me) const { return (me - hop + sp) % sp; }
  __device__ int me_of(int src) const { return (src + hop) % sp; }
  __device__ int64_t q_row(int me) const { return static_cast<int64_t>(me) * t_local + q_off; }
  __device__ int64_t k_row(int src) const { return static_cast<int64_t>(src) * t_local + k_off; }
  __device__ int64_t total() const { return static_cast<int64_t>(sp) * t_local; }
};

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }  // row stride of a 64 x D tile

__device__ __forceinline__ int ty() { return threadIdx.x >> 4; }
__device__ __forceinline__ int tx() { return threadIdx.x & 15; }

// Copy 64 rows of D floats, `stride` floats apart in device memory, into a
// shared tile with row stride D + 4.
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* g, int64_t stride) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + r * stride + c));
    *reinterpret_cast<float4*>(s + r * ld<D>() + c) = v;
  }
}

// Load 64 consecutive floats (a tile's lse or delta) into shared memory.
__device__ __forceinline__ void load_row(float* s, const float* g) {
  if (threadIdx.x < kTile) s[threadIdx.x] = g[threadIdx.x];
}

// acc[i][j] += A[ty + 16 i] . B[tx + 16 j] over D: a 64 x 64 block of A B^T
// with A and B 64 x D tiles in shared memory.
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* B, float acc[4][4]) {
  const float* a0 = A + ty() * ld<D>();
  const float* b0 = B + tx() * ld<D>();
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(a0 + 16 * i * ld<D>() + d);
      b[i] = *reinterpret_cast<const float4*>(b0 + 16 * i * ld<D>() + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][4 m + c] += sum_k P[ty + 16 i][k] * B[k][tx * 4 + 64 m + c]: a
// 64 x D block of P B with P a 64 x 64 tile (row stride kLdP) and B a
// 64 x D tile in shared memory.
template <int D>
__device__ __forceinline__ void mm_ab(const float* P, const float* B, float acc[4][D / 16]) {
  constexpr int kM = D / 64;
  const float* p0 = P + ty() * kLdP;
  const float* b0 = B + tx() * 4;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(p0 + 16 * i * kLdP + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 b[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        b[m] = *reinterpret_cast<const float4*>(b0 + (k + kk) * ld<D>() + 64 * m);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          acc[i][4 * m + 0] = fmaf(pk, b[m].x, acc[i][4 * m + 0]);
          acc[i][4 * m + 1] = fmaf(pk, b[m].y, acc[i][4 * m + 1]);
          acc[i][4 * m + 2] = fmaf(pk, b[m].z, acc[i][4 * m + 2]);
          acc[i][4 * m + 3] = fmaf(pk, b[m].w, acc[i][4 * m + 3]);
        }
      }
    }
  }
}

// Reductions over the 16 threads that share a row (one half of a warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Store (kAdd: add) a thread's 4 x (D/16) accumulator block, times `mul`,
// into rows ty + 16 i of a contiguous [.., D] tensor whose rows are
// `stride` floats apart.
template <int D, bool kAdd>
__device__ __forceinline__ void store_acc(float* g, int64_t stride, const float acc[4][D / 16],
                                          const float mul[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = g + (ty() + 16 * i) * stride + tx() * 4;
#pragma unroll
    for (int m = 0; m < D / 64; ++m) {
      float4 v;
      v.x = acc[i][4 * m + 0] * mul[i];
      v.y = acc[i][4 * m + 1] * mul[i];
      v.z = acc[i][4 * m + 2] * mul[i];
      v.w = acc[i][4 * m + 3] * mul[i];
      float4* dst = reinterpret_cast<float4*>(row + 64 * m);
      if (kAdd) {
        const float4 old = *dst;
        v.x += old.x;
        v.y += old.y;
        v.z += old.z;
        v.w += old.w;
      }
      *dst = v;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int H, int KV, float scale, Panel pan) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kTile * ld<D>();   // K, then V, of the current key tile
  float* sP = sKV + kTile * ld<D>();
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int me = blockIdx.z, rank_case = pan.case_of(me);
  const int64_t T = pan.total(), To = static_cast<int64_t>(pan.sp) * pan.rows;  // rows in, rows out
  const int64_t qs = static_cast<int64_t>(H) * D, ks = static_cast<int64_t>(KV) * D;
  const int64_t orow = static_cast<int64_t>(me) * pan.rows + qt * kTile;
  float* obase = o + (b * To + orow) * qs + h * D;
  float* lbase = lse + bh * To + orow;
  if (rank_case == kSkip) {  // a future block: nothing to attend to
    constexpr int kVec = D / 4;
    for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
      *reinterpret_cast<float4*>(obase + (i / kVec) * qs + (i % kVec) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (threadIdx.x < kTile) lbase[threadIdx.x] = kNegInf;
    return;
  }
  const bool diag = rank_case == kDiag;
  const int64_t k0 = (b * T + pan.k_row(pan.src_of(me))) * ks + kvh * D;
  const float* kbase = k + k0;
  const float* vbase = v + k0;
  load_tile<D>(sQ, q + (b * T + pan.q_row(me) + qt * kTile) * qs + h * D, qs);

  float acc[4][D / 16];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = diag ? qt + 1 : pan.rows / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile<D>(sKV, kbase + kt * kTile * ks, ks);
    __syncthreads();
    float s[4][4] = {};
    mm_abt<D>(sQ, sKV, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (diag && kt == qt && tx() + 16 * j > ty() + 16 * i) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty() + 16 * i) * kLdP + tx() + 16 * j] = p;
      }
      l_i[i] = l_i[i] * alpha + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K is no longer read; P is complete
    load_tile<D>(sKV, vbase + kt * kTile * ks, ks);
    __syncthreads();
    mm_ab<D>(sP, sKV, acc);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l_i[i];
  store_acc<D, false>(obase, qs, acc, inv);
  if (tx() == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) lbase[ty() + 16 * i] = m_i[i] + logf(l_i[i]);
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]; one warp per row.
template <int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int T, int H) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together
  float s = 0.f;
  for (int d = lane * 4; d < D; d += 128) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(o + r * D + d));
    const float4 g = __ldg(reinterpret_cast<const float4*>(dout + r * D + d));
    s = fmaf(a.x, g.x, fmaf(a.y, g.y, fmaf(a.z, g.z, fmaf(a.w, g.w, s))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int64_t h = r % H, t = (r / H) % T, b = r / (static_cast<int64_t>(H) * T);
    delta[(b * H + h) * T + t] = s;
  }
}

template <int D, bool kAdd>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
            float scale, Panel pan) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * ld<D>();
  float* sQ = sV + kTile * ld<D>();
  float* sdO = sQ + kTile * ld<D>();
  float* sP = sdO + kTile * ld<D>();
  float* sL = sP + kTile * kLdP;
  float* sD = sL + kTile;
  const int kt = blockIdx.x;  // the most query tiles first, when causal
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int src = blockIdx.z, me = pan.me_of(src), rank_case = pan.case_of(me);
  if (rank_case == kSkip) return;  // rank me's queries do not see this block
  const bool diag = rank_case == kDiag;
  const int64_t T = pan.total();
  const int64_t qs = static_cast<int64_t>(H) * D, ks = static_cast<int64_t>(KV) * D;
  const int64_t k0 = (b * T + pan.k_row(src) + kt * kTile) * ks + kvh * D;
  load_tile<D>(sK, k + k0, ks);
  load_tile<D>(sV, v + k0, ks);

  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }
  const int n_qt = pan.rows / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const float* lrow = lse + (static_cast<int64_t>(b) * H + h) * T + pan.q_row(me);
    const float* drow = delta + (static_cast<int64_t>(b) * H + h) * T + pan.q_row(me);
    for (int qt = diag ? kt : 0; qt < n_qt; ++qt) {
      __syncthreads();  // the previous query tile is no longer read
      const int64_t q0 = (b * T + pan.q_row(me) + qt * kTile) * qs + h * D;
      load_tile<D>(sQ, q + q0, qs);
      load_tile<D>(sdO, dout + q0, qs);
      load_row(sL, lrow + qt * kTile);
      load_row(sD, drow + qt * kTile);
      __syncthreads();
      // Transposed scores: rows are keys (ty + 16 i), columns queries.
      float p[4][4] = {}, dp[4][4] = {};
      mm_abt<D>(sK, sQ, p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = ty() + 16 * i, query = tx() + 16 * j;
          float e = expf(p[i][j] * scale - sL[query]);
          if (diag && qt == kt && query < key) e = 0.f;
          p[i][j] = e;
          sP[key * kLdP + query] = e;
        }
      }
      mm_abt<D>(sV, sdO, dp);  // dP^T[key][query] = V[key] . dO[query]
      __syncthreads();          // P^T is complete
      mm_ab<D>(sP, sdO, acc_v);  // dV += P^T dO
      __syncthreads();          // P^T is no longer read
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = ty() + 16 * i, query = tx() + 16 * j;
          sP[key * kLdP + query] = p[i][j] * (dp[i][j] - sD[query]);
        }
      }
      __syncthreads();
      mm_ab<D>(sP, sQ, acc_k);  // dK += dS^T Q (times scale, below)
    }
  }
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  const float scales[4] = {scale, scale, scale, scale};
  store_acc<D, kAdd>(dk + k0, ks, acc_k, scales);
  store_acc<D, kAdd>(dv + k0, ks, acc_v, ones);
}

template <int D, bool kAdd>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int H, int KV, float scale, Panel pan) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kTile * ld<D>();
  float* sK = sdO + kTile * ld<D>();
  float* sV = sK + kTile * ld<D>();
  float* sP = sV + kTile * ld<D>();
  float* sL = sP + kTile * kLdP;
  float* sD = sL + kTile;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int me = blockIdx.z, rank_case = pan.case_of(me);
  if (rank_case == kSkip) return;  // no key of this hop's block is visible
  const bool diag = rank_case == kDiag;
  const int64_t T = pan.total();
  const int64_t qs = static_cast<int64_t>(H) * D, ks = static_cast<int64_t>(KV) * D;
  const int64_t row0 = pan.q_row(me) + qt * kTile;
  const int64_t q0 = (b * T + row0) * qs + h * D;
  const int64_t k0 = (b * T + pan.k_row(pan.src_of(me))) * ks + kvh * D;
  const float* kbase = k + k0;
  const float* vbase = v + k0;
  load_tile<D>(sQ, q + q0, qs);
  load_tile<D>(sdO, dout + q0, qs);
  load_row(sL, lse + bh * T + row0);
  load_row(sD, delta + bh * T + row0);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = diag ? qt + 1 : pan.rows / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous key tile and dS are no longer read
    load_tile<D>(sK, kbase + kt * kTile * ks, ks);
    load_tile<D>(sV, vbase + kt * kTile * ks, ks);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_abt<D>(sQ, sK, s);
    mm_abt<D>(sdO, sV, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int query = ty() + 16 * i, key = tx() + 16 * j;
        float e = expf(s[i][j] * scale - sL[query]);
        if (diag && kt == qt && key > query) e = 0.f;
        sP[query * kLdP + key] = e * (dp[i][j] - sD[query]);
      }
    }
    __syncthreads();
    mm_ab<D>(sP, sK, acc);  // dQ += dS K (times scale, below)
  }
  const float scales[4] = {scale, scale, scale, scale};
  store_acc<D, kAdd>(dq + q0, qs, acc, scales);
}

template <int D>
constexpr size_t fwd_smem() { return (2 * kTile * ld<D>() + kTile * kLdP) * sizeof(float); }

template <int D>
constexpr size_t bwd_smem() {
  return (4 * kTile * ld<D>() + kTile * kLdP + 2 * kTile) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B, int H,
        int KV, float scale, Panel pan, cudaStream_t s) {
  auto kernel = fwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(pan.rows / kTile, B * H, pan.sp);
  kernel<<<grid, kThreads, fwd_smem<D>(), s>>>(q, k, v, o, lse, H, KV, scale, pan);
  return static_cast<int>(cudaGetLastError());
}

// dK/dV, then dQ: two launches.
template <int D, bool kAdd>
int bwd(const float* q, const float* k, const float* v, const float* dout, const float* lse,
        const float* delta, float* dq, float* dk, float* dv, int B, int H, int KV, float scale,
        Panel pan, cudaStream_t s) {
  auto dkdv = dkdv_kernel<D, kAdd>;
  auto dqk = dq_kernel<D, kAdd>;
  cudaError_t err;
  if ((err = allow_smem(dkdv, bwd_smem<D>())) != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(dqk, bwd_smem<D>())) != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(pan.rows / kTile, B * KV, pan.sp), kThreads, bwd_smem<D>(), s>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, scale, pan);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(pan.rows / kTile, B * H, pan.sp), kThreads, bwd_smem<D>(), s>>>(
      q, k, v, dout, lse, delta, dq, H, KV, scale, pan);
  return static_cast<int>(cudaGetLastError());
}

// B5's panel: one rank holding the whole sequence.
Panel whole(int T, int causal) {
  return Panel{1, T, T, 0, 0, 0, static_cast<unsigned long long>(causal ? kDiag : kFull)};
}

}  // namespace

extern "C" {

// Forward.  q: [B, T, H, D]; k, v: [B, T, KV, D]; o: [B, T, H, D];
// lse: [B, H, T]; all contiguous float32 on the device, H a multiple of KV,
// T a multiple of 64, D 128 (the wrapper checks).  Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for any other D.
int dpwa_flash_attn_fwd_f32(const float* q, const float* k, const float* v, float* o,
                            float* lse, int B, int T, int H, int KV, int D, float scale,
                            int causal, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return fwd<128>(q, k, v, o, lse, B, H, KV, scale, whole(T, causal),
                  static_cast<cudaStream_t>(stream));
}

// Backward.  Shapes as the forward, dout like o, dq like q, dk and dv like
// k and v; delta is [B, H, T] scratch.  Three launches: delta, dK/dV, dQ.
int dpwa_flash_attn_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                            const float* dout, const float* lse, float* delta, float* dq,
                            float* dk, float* dv, int B, int T, int H, int KV, int D,
                            float scale, int causal, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * T * H;
  const unsigned delta_blocks = static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
  delta_kernel<128><<<delta_blocks, kThreads, 0, s>>>(o, dout, delta, rows, T, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return bwd<128, false>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, scale,
                         whole(T, causal), s);
}

// B3, one ring hop for every rank.  q: [B, sp * t_local, H, D]; k, v:
// [B, sp * t_local, KV, D]; o: [B, sp * rows, H, D]; lse: [B, H, sp * rows];
// contiguous float32 on the device.  Rank r's panel and case as in Panel
// (case of rank r in bits 2r, 2r + 1 of `cases`); the wrapper checks rows,
// offsets and hop.  D 128 only.
int dpwa_ring_hop_fwd_f32(const float* q, const float* k, const float* v, float* o,
                          float* lse, int B, int sp, int t_local, int H, int KV, int D,
                          float scale, int hop, int rows, int q_off, int k_off,
                          unsigned long long cases, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const Panel pan{sp, t_local, rows, q_off, k_off, hop, cases};
  return fwd<128>(q, k, v, o, lse, B, H, KV, scale, pan, static_cast<cudaStream_t>(stream));
}

// B4, one ring hop's gradients for every rank, added into dq (like q), dk
// and dv (like k and v).  dout like q; lse and delta [B, H, sp * t_local],
// the ring's global ones.  Two launches: dK/dV, dQ.
int dpwa_ring_hop_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                          const float* lse, const float* delta, float* dq, float* dk,
                          float* dv, int B, int sp, int t_local, int H, int KV, int D,
                          float scale, int hop, int rows, int q_off, int k_off,
                          unsigned long long cases, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const Panel pan{sp, t_local, rows, q_off, k_off, hop, cases};
  return bwd<128, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, scale, pan,
                        static_cast<cudaStream_t>(stream));
}

const char* dpwa_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
