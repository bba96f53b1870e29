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
// attention).  The causal forward does 2*B*H*T^2*D flops (QK^T and PV over
// half the square), the backward about 2.5 times that; at B = 4, H = 32,
// T = 2048, D = 128 that is 137 GFLOP forward and 344 GFLOP backward,
// while the bytes (0.34 GB) take 0.1 ms.  A float32 kernel cannot be bound
// by bytes here.  Outside the tensor cores float32 runs at 67 TF/s (a
// bound of 2.05 ms for that forward).  Both directions run on the tensor
// cores in 3xTF32, three TF32 products for each float32 one at 495 TF/s:
// bounds of 3 * 137 GFLOP / 495 TF/s = 0.83 ms forward and 3 * 344 GFLOP /
// 495 TF/s = 2.08 ms backward.
//
// The forward (fwd_kernel): a block of 4 warps owns a 64-row query tile,
// each warp 16 of its rows, and walks the key tiles with an online softmax;
// the score tile never touches device memory.  Both products of a key tile
// (S = Q K^T over D, then O += P V over the tile's 64 keys) go through
// mma.sync in 3xTF32, as the backward's do (see the note above tc_abt
// below).  A warp holds whole rows of S, so the softmax's row max and sum
// are reductions over the 4 lanes of a quad, and P stays in registers: with
// the k slots permuted as the backward permutes them (slot t and t + 4 take
// keys 2t and 2t + 1), the C fragment of S is the A fragment of P.  P V
// then reads V at rows 2 tig and 2 tig + 1, column gid, so V's tile has its
// own row stride, D + 4 (banks 8 tig + gid; D + 8 would collide); Q and K,
// read as float2 along rows, keep the backward's D + 8.  Fresh fragments
// against the truncating accumulation: S sums over D in chunks of 32
// columns, each added with float32 adds (one fragment over all 128 columns
// missed FWD_TOL on an H100, 1.02e-5 with q scaled by 8: scores in the
// hundreds), and each 64-key tile's P V sums into fresh fragments for all
// D / 8 output column blocks at once (64 registers; their 16 dependent
// chains of 24 products run side by side), added to the float32
// accumulator after its online rescale.  Q stays in shared memory and is
// split for each key tile: split once, its big and small parts would need
// 128 more registers a thread or a second 34 KB tile, and either leaves
// one block an SM.  K
// and V have a buffer each, loaded by cp.async while the other is read:
// the next K tile during the softmax and P V, the next V tile during the
// next S.  About 101 KB of shared memory a block, so two blocks (8 warps)
// share an SM.  Causal blocks skip the tiles above the diagonal, mask the
// diagonal tile, and are launched heaviest first.  What holds it back from
// its bound: at 254 registers two warps a scheduler hide the latency of
// the mma chains and of the four barriers a key tile (running P V's chains
// side by side instead of one at a time made it 1.2x faster on an H100
// 80GB HBM3 at 700 W), and each warp splits the whole K and V tile for its
// own 16 rows.
//
// The backward (dkdv_kernel, dq_kernel): the tensor cores through mma.sync
// in 3xTF32, double-buffered cp.async tile loads, the score tile recomputed
// from the saved lse and never in device memory; see the note above
// tc_abt below.
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
//                 P recomputed (4 tile products a pair, tensor cores).
//   dq_kernel     one block per (query tile, b*h, rank): dQ, P recomputed
//                 again (3 tile products a pair, tensor cores).  dQ is not
//                 fused into the dK/dV pass: that would need atomics, and
//                 with one writer per row B4's sums and reruns stay
//                 deterministic.
// Softmax uses expf and logf, not the fast intrinsics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kThreads = 256;   // 8 warps (backward, delta)
constexpr int kFwdThreads = 128;  // 4 warps (forward)
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

// ---------------------------------------------------------------------------
// The backward (B4, B5's backward) on the tensor cores in 3xTF32.
//
// Every tile product goes through mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32
// (HMMA.1688.F32.TF32).  A float32 operand x is split into two TF32 values,
// big = x rounded to TF32 (to nearest, ties away) and small = x - big
// truncated to TF32, and a product is taken as small*big + big*small, then
// big*big, into float32 fragments: CUTLASS's OpMultiplyAddFastF32 (its
// round_half_ulp_truncate / round_toward_zero pair), which PyTorch's
// efficient attention runs for float32.  The rounding is done on the bits
// (an add and a mask, see split): cvt.rna.tf32.f32 compiles to about five
// instructions, with checks for inf and NaN that finite scores do not
// need.  Only small*small and small's truncation (about 2^-21 of a term,
// of either sign) are dropped, so the result keeps float32's accuracy; one
// TF32 product alone (dropping both small terms) is good to about 1e-3.
// The tensor cores truncate as they accumulate, so a long sum in one
// fragment drifts toward zero (7e-5 of dK, dV after the 3 x 1024 products
// of a long-context key tile).  Each 64-row tile product therefore sums
// into fresh fragments, and those are added to the block's accumulators
// with float32 adds, which round to nearest.
// mma.sync, not wgmma: wgmma's tf32 takes A and B only K-major, so P^T dO
// and dS^T Q would need transposed copies of dO and Q, and mma.sync reads
// its fragments from any layout the threads choose.
//
// Each block holds 64 keys (dK/dV) or 64 queries (dQ) against a 64-row tile
// of the other side, 8 warps.  A 64 x 64 score tile is 2 x 4 warp tiles of
// 32 x 16 (tc_abt), a 64 x D accumulator 2 x 4 warp tiles of 32 x D/4 (tc_ab).
// Shared-memory strides, chosen so that every fragment read is free of bank
// conflicts:
//   - q, k, v, dO tiles: D + 8 floats (8 mod 32).  For the products over D
//     (S = Q K^T, dP = dO V^T and their transposes) both operands are read
//     along rows; the k index is permuted within each step of 8 (slot t and
//     t + 4 read columns 2t and 2t + 1, the same for A and B, which leaves
//     the sum unchanged), so a thread reads one float2, and a half warp's
//     float2s cover the 32 banks once.  For the products over the 64 rows
//     (P^T dO, dS^T Q, dS K) the tile is the [k][n] operand: lanes read
//     rows tig, columns gid, banks 8 tig + gid, all different.  (D + 4, the
//     forward's stride, collides there: 4 tig + gid.)
//   - the P^T / dS tile: 64 + 4 floats, read as the A operand along rows
//     (banks 4 gid + tig).
// Tile loads are cp.async, double-buffered: the next query tile's Q, dO,
// lse and delta rows (dK/dV) or the next key tile's K and V (dQ) are in
// flight while the current one computes.  Six 64 x D tiles and the P tile
// take 227 KB of shared memory, so one block (8 warps) runs on an SM.
// What holds it back from its bound: those 8 warps (two a scheduler, the
// dK/dV kernel at about 250 registers a thread) move from phase to phase
// together at the barriers, so the tensor cores wait while the score
// epilogue, the operand splits and the loads of fragments run.  Giving the
// score product to warps 0-3 and dP to warps 4-7 as 32 x 32 warp tiles (a
// third fewer operand splits) was slower: each half waits for the other.
// Fusing dQ into the dK/dV pass (5 products a tile pair instead of 7, with
// atomics) and wgmma are the next steps.
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int ldm() { return D + 8; }  // row stride of a 64 x D tile (mma)

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most the newest group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying 64 rows of D floats, `stride` floats apart in device
// memory, into a shared tile with row stride kLd (D + 8 unless given), by a
// block of kN threads.
template <int D, int kLd = ldm<D>(), int kN = kThreads>
__device__ __forceinline__ void load_tile_async(float* s, const float* g, int64_t stride) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kN) {
    const int r = i / kVec, c = (i % kVec) * 4;
    cp_async16(s + r * kLd + c, g + r * stride + c);
  }
}

// Start copying 64 consecutive floats (a tile's lse or delta).
__device__ __forceinline__ void load_row_async(float* s, const float* g) {
  if (threadIdx.x < kTile) cp_async4(s + threadIdx.x, g + threadIdx.x);
}

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent and 10 mantissa bits

// x ~ big + small, each a TF32 operand: big x rounded to nearest (ties away
// from zero, for finite x), small the remainder truncated.  The tensor
// cores ignore the low 13 bits of a TF32 operand (CUTLASS's conversions
// rely on it too), so big's rounding is the add alone and small's
// truncation is free; only the subtraction needs big with those bits
// cleared.  Three instructions; clearing both parts as well gave bit-equal
// results and a forward about 1 % slower (H100 80GB HBM3, 700 W).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & kTf32Mask));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t a_big[4],
                                           const uint32_t a_small[4], const uint32_t b_big[2],
                                           const uint32_t b_small[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_m() { return threadIdx.x >> 7; }        // 0..1
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) & 3; }  // 0..3

// acc += this warp's 32 x 16 block of A B^T, A and B 64 x D tiles (row
// stride D + 8).  acc[mi][ni] is the C fragment of rows 32 wm + 16 mi +
// {gid, gid + 8} and columns 16 wn + 8 ni + 2 tig + {0, 1}.
template <int D>
__device__ __forceinline__ void tc_abt(const float* A, const float* B, float acc[2][2][4]) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const float* a0 = A + (32 * warp_m() + gid) * ldm<D>() + 2 * tig;
  const float* b0 = B + (16 * warp_n() + gid) * ldm<D>() + 2 * tig;
#pragma unroll
  for (int k = 0; k < D; k += 8) {
    uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // k slot tig reads column k + 2 tig, slot tig + 4 column k + 2 tig + 1
      const float2 top = *reinterpret_cast<const float2*>(a0 + 16 * mi * ldm<D>() + k);
      const float2 bot = *reinterpret_cast<const float2*>(a0 + (16 * mi + 8) * ldm<D>() + k);
      split(top.x, ab[mi][0], as[mi][0]);
      split(bot.x, ab[mi][1], as[mi][1]);
      split(top.y, ab[mi][2], as[mi][2]);
      split(bot.y, ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const float2 col = *reinterpret_cast<const float2*>(b0 + 8 * ni * ldm<D>() + k);
      split(col.x, bb[ni][0], bs[ni][0]);
      split(col.y, bb[ni][1], bs[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma_3xtf32(acc[mi][ni], ab[mi], as[mi], bb[ni], bs[ni]);
    }
  }
}

// acc += this warp's 32 x D/4 block of P B, P a 64 x 64 tile (row stride
// 64 + 4) and B a 64 x D tile (row stride D + 8).  acc[mi][ni] is the C
// fragment of rows 32 wm + 16 mi + {gid, gid + 8} and columns D/4 wn +
// 8 ni + 2 tig + {0, 1}.  The product sums into fresh fragments, added to
// acc at the end (round to nearest).
template <int D>
__device__ __forceinline__ void tc_ab(const float* P, const float* B, float acc[2][D / 32][4]) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  float part[2][D / 32][4] = {};
  const float* p0 = P + (32 * warp_m() + gid) * kLdP + tig;
  const float* b0 = B + tig * ldm<D>() + (D / 4) * warp_n() + gid;
#pragma unroll
  for (int k = 0; k < kTile; k += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = p0 + 16 * mi * kLdP + k;
      split(p[0], ab[mi][0], as[mi][0]);
      split(p[8 * kLdP], ab[mi][1], as[mi][1]);
      split(p[4], ab[mi][2], as[mi][2]);
      split(p[8 * kLdP + 4], ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < D / 32; ++ni) {
      uint32_t bb[2], bs[2];
      const float* b = b0 + k * ldm<D>() + 8 * ni;
      split(b[0], bb[0], bs[0]);
      split(b[4 * ldm<D>()], bb[1], bs[1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_3xtf32(part[mi][ni], ab[mi], as[mi], bb, bs);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < D / 32; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[mi][ni][c];
    }
  }
}

// Store (kAdd: add) a warp's 32 x D/4 accumulator fragments, times `mul`,
// into the rows of a contiguous [.., D] tensor whose rows are `stride`
// floats apart.
template <int D, bool kAdd>
__device__ __forceinline__ void store_frag(float* g, int64_t stride, const float acc[2][D / 32][4],
                                           float mul) {
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* row = g + (32 * warp_m() + 16 * mi + gid + 8 * half) * stride +
                   (D / 4) * warp_n() + 2 * tig;
#pragma unroll
      for (int ni = 0; ni < D / 32; ++ni) {
        float2 v = make_float2(acc[mi][ni][2 * half] * mul, acc[mi][ni][2 * half + 1] * mul);
        float2* dst = reinterpret_cast<float2*>(row + 8 * ni);
        if (kAdd) {
          const float2 old = *dst;
          v.x += old.x;
          v.y += old.y;
        }
        *dst = v;
      }
    }
  }
}

// The forward on the tensor cores (B3, B5's forward); see the header.
template <int D>
__host__ __device__ constexpr int ldv() { return D + 4; }  // row stride of the forward's V tile

constexpr int kChunk = 32;  // columns of D summed in one fresh fragment of S

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int H, int KV, float scale, Panel pan) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * ldm<D>();
  float* sV = sK + kTile * ldm<D>();
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
    for (int i = threadIdx.x; i < kTile * kVec; i += kFwdThreads) {
      *reinterpret_cast<float4*>(obase + (i / kVec) * qs + (i % kVec) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (threadIdx.x < kTile) lbase[threadIdx.x] = kNegInf;
    return;
  }
  const bool diag = rank_case == kDiag;
  const float* kbase = k + (b * T + pan.k_row(pan.src_of(me))) * ks + kvh * D;
  const float* vbase = v + (kbase - k);
  load_tile_async<D, ldm<D>(), kFwdThreads>(
      sQ, q + (b * T + pan.q_row(me) + qt * kTile) * qs + h * D, qs);
  load_tile_async<D, ldm<D>(), kFwdThreads>(sK, kbase, ks);
  cp_async_commit();
  load_tile_async<D, ldv<D>(), kFwdThreads>(sV, vbase, ks);
  cp_async_commit();

  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + gid;  // this lane's rows r0 and r0 + 8 of the tile
  const float* qa = sQ + r0 * ldm<D>() + 2 * tig;
  const float* kb = sK + gid * ldm<D>() + 2 * tig;
  const float* vb = sV + 2 * tig * ldv<D>() + gid;
  float acc[D / 8][4] = {};  // O's rows r0, r0 + 8: the C fragments of its D / 8 column blocks
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  const int n_kt = diag ? qt + 1 : pan.rows / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all_but_newest();
    __syncthreads();  // Q and this key tile's K have landed
    // S = Q K^T: s[j] is the C fragment of keys 8 j .. 8 j + 7, summed over
    // D in fresh fragments of kChunk columns each (the tensor cores truncate
    // as they accumulate, and q scaled up makes scores in the hundreds).
    float s[8][4] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < D; k0 += kChunk) {
      float part[8][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + kChunk; kk += 8) {
        uint32_t ab[4], as[4];
        // k slot tig reads column kk + 2 tig, slot tig + 4 column kk + 2 tig + 1
        const float2 top = *reinterpret_cast<const float2*>(qa + kk);
        const float2 bot = *reinterpret_cast<const float2*>(qa + 8 * ldm<D>() + kk);
        split(top.x, ab[0], as[0]);
        split(bot.x, ab[1], as[1]);
        split(top.y, ab[2], as[2]);
        split(bot.y, ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 col = *reinterpret_cast<const float2*>(kb + 8 * j * ldm<D>() + kk);
          uint32_t bb[2], bs[2];
          split(col.x, bb[0], bs[0]);
          split(col.y, bb[1], bs[1]);
          mma_3xtf32(part[j], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] += part[j][c];
      }
    }
    __syncthreads();  // every warp is done with this K tile
    if (kt + 1 < n_kt) {
      load_tile_async<D, ldm<D>(), kFwdThreads>(sK, kbase + (kt + 1) * kTile * ks, ks);
    }
    cp_async_commit();

    // Online softmax over rows r0 (fragment slots 0, 1) and r0 + 8 (2, 3);
    // a row's 64 scores lie in the 4 lanes of a quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float& e = s[j][c];
        e *= scale;
        if (diag && kt == qt && 8 * j + 2 * tig + (c & 1) > r0 + 8 * (c >> 1)) e = -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], e);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);
      alpha[i] = expf(m_i[i] - m_new);
      m_i[i] = m_new;
    }
    // P, split for the tensor cores: under the k permutation the C slots
    // (row gid: 0, 1; row gid + 8: 2, 3) are the A slots 0, 2, 1, 3.
    uint32_t pb[8][4], ps[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[j][c] - m_i[c >> 1]);
        sum[c >> 1] += p;
        const int a = (c >> 1) | ((c & 1) << 1);
        split(p, pb[j][a], ps[j][a]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_i[i] = l_i[i] * alpha[i] + sum[i];
    }

    cp_async_wait_all_but_newest();
    __syncthreads();  // this key tile's V has landed
    // O = alpha O + P V: the tile's product sums into fresh fragments, every
    // output column block side by side (a block's 24 products form one
    // dependent chain; one block at a time was 1.2x slower on an H100),
    // added to the accumulator after its rescale.
    float part[D / 8][4] = {};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* vp = vb + 8 * j * ldv<D>() + 8 * n;
        uint32_t bb[2], bs[2];
        split(vp[0], bb[0], bs[0]);
        split(vp[ldv<D>()], bb[1], bs[1]);
        mma_3xtf32(part[n], pb[j], ps[j], bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = acc[n][c] * alpha[c >> 1] + part[n][c];
    }
    __syncthreads();  // every warp is done with this V tile
    if (kt + 1 < n_kt) {
      load_tile_async<D, ldv<D>(), kFwdThreads>(sV, vbase + (kt + 1) * kTile * ks, ks);
    }
    cp_async_commit();
  }
  const float inv[2] = {1.f / l_i[0], 1.f / l_i[1]};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* row = obase + (r0 + 8 * half) * qs + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * half] * inv[half], acc[n][2 * half + 1] * inv[half]);
    }
  }
  if (tig == 0) {
    lbase[r0] = m_i[0] + logf(l_i[0]);
    lbase[r0 + 8] = m_i[1] + logf(l_i[1]);
  }
}

template <int D, bool kAdd>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
            float scale, Panel pan) {
  extern __shared__ float4 smem4[];
  constexpr int kT = kTile * ldm<D>();
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kT;
  float* sQ = sV + kT;     // two buffers
  float* sdO = sQ + 2 * kT;  // two buffers
  float* sP = sdO + 2 * kT;
  float* sL = sP + kTile * kLdP;  // two buffers of 64
  float* sD = sL + 2 * kTile;     // two buffers of 64
  const int kt = blockIdx.x;  // the most query tiles first, when causal
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int src = blockIdx.z, me = pan.me_of(src), rank_case = pan.case_of(me);
  if (rank_case == kSkip) return;  // rank me's queries do not see this block
  const bool diag = rank_case == kDiag;
  const int64_t T = pan.total();
  const int64_t qs = static_cast<int64_t>(H) * D, ks = static_cast<int64_t>(KV) * D;
  const int64_t k0 = (b * T + pan.k_row(src) + kt * kTile) * ks + kvh * D;
  // The block walks (query head g of the group, query tile qt) pairs.
  const int qt0 = diag ? kt : 0, n_q = pan.rows / kTile - qt0, n_it = group * n_q;
  auto load_pair = [&](int it, int buf) {
    const int h = kvh * group + it / n_q, qt = qt0 + it % n_q;
    const int64_t row = pan.q_row(me) + qt * kTile;
    const int64_t q0 = (b * T + row) * qs + h * D;
    load_tile_async<D>(sQ + buf * kT, q + q0, qs);
    load_tile_async<D>(sdO + buf * kT, dout + q0, qs);
    const int64_t l0 = (static_cast<int64_t>(b) * H + h) * T + row;
    load_row_async(sL + buf * kTile, lse + l0);
    load_row_async(sD + buf * kTile, delta + l0);
  };
  load_tile_async<D>(sK, k + k0, ks);
  load_tile_async<D>(sV, v + k0, ks);
  load_pair(0, 0);
  cp_async_commit();

  float acc_k[2][D / 32][4] = {}, acc_v[2][D / 32][4] = {};
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1, qt = qt0 + it % n_q;
    if (it + 1 < n_it) load_pair(it + 1, buf ^ 1);  // its buffer was freed at the end of it - 1
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();  // this pair's tiles have landed
    const float* cQ = sQ + buf * kT;
    const float* cdO = sdO + buf * kT;
    const float* cL = sL + buf * kTile;
    const float* cD = sD + buf * kTile;
    // Transposed scores: rows are keys, columns queries.
    float p[2][2][4] = {};
    tc_abt<D>(sK, cQ, p);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = 32 * warp_m() + 16 * mi + gid + 8 * half;
          const int query = 16 * warp_n() + 8 * ni + 2 * tig;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& e = p[mi][ni][2 * half + j];
            e = expf(e * scale - cL[query + j]);
            if (diag && qt == kt && query + j < key) e = 0.f;
          }
          *reinterpret_cast<float2*>(sP + key * kLdP + query) =
              make_float2(p[mi][ni][2 * half], p[mi][ni][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // P^T is complete
    tc_ab<D>(sP, cdO, acc_v);  // dV += P^T dO
    float ds[2][2][4] = {};
    tc_abt<D>(sV, cdO, ds);  // dP^T[key][query] = V[key] . dO[query]
    __syncthreads();         // P^T is no longer read
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = 32 * warp_m() + 16 * mi + gid + 8 * half;
          const int query = 16 * warp_n() + 8 * ni + 2 * tig;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& d = ds[mi][ni][2 * half + j];
            d = p[mi][ni][2 * half + j] * (d - cD[query + j]);
          }
          *reinterpret_cast<float2*>(sP + key * kLdP + query) =
              make_float2(ds[mi][ni][2 * half], ds[mi][ni][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // dS^T is complete
    tc_ab<D>(sP, cQ, acc_k);  // dK += dS^T Q (times scale, below)
    __syncthreads();          // this pair's buffers and dS^T are no longer read
  }
  store_frag<D, kAdd>(dk + k0, ks, acc_k, scale);
  store_frag<D, kAdd>(dv + k0, ks, acc_v, 1.f);
}

template <int D, bool kAdd>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int H, int KV, float scale, Panel pan) {
  extern __shared__ float4 smem4[];
  constexpr int kT = kTile * ldm<D>();
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kT;
  float* sK = sdO + kT;     // two buffers
  float* sV = sK + 2 * kT;  // two buffers
  float* sP = sV + 2 * kT;
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
  const float* kbase = k + (b * T + pan.k_row(pan.src_of(me))) * ks + kvh * D;
  const float* vbase = v + (kbase - k);
  load_tile_async<D>(sQ, q + q0, qs);
  load_tile_async<D>(sdO, dout + q0, qs);
  load_row_async(sL, lse + bh * T + row0);
  load_row_async(sD, delta + bh * T + row0);
  load_tile_async<D>(sK, kbase, ks);
  load_tile_async<D>(sV, vbase, ks);
  cp_async_commit();

  float acc[2][D / 32][4] = {};
  const int gid = lane_id() >> 2, tig = lane_id() & 3;
  const int n_kt = diag ? qt + 1 : pan.rows / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {  // its buffers were freed at the end of kt - 1
      load_tile_async<D>(sK + (buf ^ 1) * kT, kbase + (kt + 1) * kTile * ks, ks);
      load_tile_async<D>(sV + (buf ^ 1) * kT, vbase + (kt + 1) * kTile * ks, ks);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();  // this key tile has landed
    const float* cK = sK + buf * kT;
    float s[2][2][4] = {}, ds[2][2][4] = {};
    tc_abt<D>(sQ, cK, s);
    tc_abt<D>(sdO, sV + buf * kT, ds);  // dP = dO V^T
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int query = 32 * warp_m() + 16 * mi + gid + 8 * half;
          const int key = 16 * warp_n() + 8 * ni + 2 * tig;
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * half + j;
            float e = expf(s[mi][ni][c] * scale - sL[query]);
            if (diag && kt == qt && key + j > query) e = 0.f;
            d[j] = e * (ds[mi][ni][c] - sD[query]);
          }
          *reinterpret_cast<float2*>(sP + query * kLdP + key) = make_float2(d[0], d[1]);
        }
      }
    }
    __syncthreads();  // dS is complete
    tc_ab<D>(sP, cK, acc);  // dQ += dS K (times scale, below)
    __syncthreads();        // this key tile and dS are no longer read
  }
  store_frag<D, kAdd>(dq + q0, qs, acc, scale);
}

// Q and K tiles at stride D + 8, the V tile at D + 4.
template <int D>
constexpr size_t fwd_smem() { return (2 * kTile * ldm<D>() + kTile * ldv<D>()) * sizeof(float); }

// Six 64 x D tiles (two of them double-buffered pairs), the P tile, and
// two buffers each of lse and delta rows (dK/dV; dQ uses one of each).
template <int D>
constexpr size_t bwd_smem() {
  return (6 * kTile * ldm<D>() + kTile * kLdP + 4 * kTile) * sizeof(float);
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
  kernel<<<grid, kFwdThreads, fwd_smem<D>(), s>>>(q, k, v, o, lse, H, KV, scale, pan);
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
