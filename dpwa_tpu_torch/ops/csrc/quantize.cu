// The TCP wire's int8 stochastic-rounding encoder for Hopper (sm_90a),
// bound to Python with ctypes (dpwa_tpu_torch/ops/quantize.py::quantize_sr).
// It replaces the reference's native host loop dpwa_quantize_sr
// (dpwa_tpu/native/dpwa_native.cpp) and writes the whole code-4 body into
// one device buffer, so one readback publishes the frame:
//
//     u64 n | f32 scales[ceil(n / 256)] | int8 q[n]
//
// Per 256-element chunk: m = max |x| over the chunk (a NaN never wins, as
// `a > m` skips it in the reference; m starts at +0), s = m / 127 and
// inv = 1 / s as IEEE divisions, and for each element
//
//     q = clamp(floor(fma(b, 2^-24, x * inv)), -127, 127)
//
// with b the dither's 24 bits and x * inv rounded on its own: the
// reference's g++ contracts `x * inv + b * 2^-24` into a multiply of x * inv
// and a fused multiply-add of the dither's product (4 vfmadd132ss in its
// dpwa_quantize_sr), which is round(round(x * inv) + u) since b * 2^-24 is
// exact.  A fused multiply-add of x * inv would floor some elements
// differently; the intrinsics pin the reference's form, never fast math.  A
// chunk whose s is 0 gets codes 0.  The dither u of element i is 24 bits
// of r = mix64(key + (i >> 1)): bits 0-23 for an even i and 24-47 for an
// odd one, which is the reference's pair-unrolled loop element for element
// (key = mix64(k0) ^ (k1 * 0xD1B54A32D192ED03), made on the host).
//
// What bounds it on the card: bytes.  It reads 4 bytes an element and
// writes 1 (plus a scale per chunk), and does some 30 integer operations a
// pair of elements for the hash, below the card's integer rate.  The design:
// 64 threads a chunk, four consecutive elements a thread (one float4 load
// where the source is 16-byte aligned, one 4-byte store of the codes, two
// hashes: the reference's pairs), four chunks a block of 256 threads.  The
// chunk's maximum is a warp shuffle reduction and one step through shared
// memory; a grid-stride loop over the chunks covers any length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;
constexpr int kPer = 4;                       // elements a thread
constexpr int kLanes = kChunk / kPer;         // threads a chunk
constexpr int kBlock = 256;                   // threads a block
constexpr int kChunksPerBlock = kBlock / kLanes;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The larger of two magnitudes as `a > m` picks it (both NaN-free here).
__device__ __forceinline__ float pick(float m, float a) { return a > m ? a : m; }

// |x| as the reference's `a > m` scan sees it: a NaN or -0 counts as +0.
__device__ __forceinline__ float magnitude(float x) {
  const float ax = x < 0.0f ? -x : x;
  return ax > 0.0f ? ax : 0.0f;
}

__device__ __forceinline__ int8_t code(float x, float inv, uint64_t bits) {
  float t = floorf(__fmaf_rn(static_cast<float>(bits), 1.0f / 16777216.0f, __fmul_rn(x, inv)));
  if (t > 127.0f) t = 127.0f;
  if (t < -127.0f) t = -127.0f;
  return static_cast<int8_t>(t);
}

template <bool kVec>
__global__ void __launch_bounds__(kBlock)
quantize_sr_kernel(const float* __restrict__ src, int64_t n, int64_t chunks,
                   uint8_t* __restrict__ out, uint64_t key) {
  __shared__ float partial[kBlock / 32];
  float* scales = reinterpret_cast<float*>(out + 8);
  int8_t* q = reinterpret_cast<int8_t*>(out + 8 + 4 * chunks);
  if (blockIdx.x == 0 && threadIdx.x == 0) *reinterpret_cast<uint64_t*>(out) = n;
  const int sub = threadIdx.x / kLanes, t = threadIdx.x % kLanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChunksPerBlock; c0 < chunks;
       c0 += static_cast<int64_t>(gridDim.x) * kChunksPerBlock) {
    const int64_t c = c0 + sub;
    const int64_t i0 = c * kChunk + kPer * t;
    float x[kPer];
    if (kVec && i0 + kPer <= n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + i0));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      for (int j = 0; j < kPer; ++j) x[j] = i0 + j < n ? src[i0 + j] : 0.0f;
    }
    float m = 0.0f;
    for (int j = 0; j < kPer; ++j) m = pick(m, magnitude(x[j]));
    for (int off = 16; off > 0; off >>= 1) m = pick(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) partial[warp] = m;
    __syncthreads();
    m = pick(partial[2 * sub], partial[2 * sub + 1]);  // a chunk is two warps
    __syncthreads();  // partial is rewritten by the next chunks
    if (c >= chunks || i0 >= n) continue;
    const float s = __fdiv_rn(m, 127.0f);
    if (t == 0) scales[c] = s;
    char4 codes = make_char4(0, 0, 0, 0);
    if (s != 0.0f) {
      const float inv = __fdiv_rn(1.0f, s);
      const uint64_t r0 = mix64(key + static_cast<uint64_t>(i0 >> 1));
      const uint64_t r1 = mix64(key + static_cast<uint64_t>(i0 >> 1) + 1);
      codes.x = code(x[0], inv, r0 & 0xFFFFFFull);
      codes.y = code(x[1], inv, (r0 >> 24) & 0xFFFFFFull);
      codes.z = code(x[2], inv, r1 & 0xFFFFFFull);
      codes.w = code(x[3], inv, (r1 >> 24) & 0xFFFFFFull);
    }
    if (i0 + kPer <= n) {
      *reinterpret_cast<char4*>(q + i0) = codes;
    } else {
      const int8_t tail[kPer] = {codes.x, codes.y, codes.z, codes.w};
      for (int j = 0; i0 + j < n; ++j) q[i0 + j] = tail[j];
    }
  }
}

}  // namespace

extern "C" {

// src: float32[n] on the card (n >= 1); out: the body, 8 + 4 * ceil(n / 256)
// + n bytes on the card, 8-byte aligned (so the codes start 4-byte
// aligned); key: the dither's stream key.  Returns the launch's
// cudaError_t.
int dpwa_quantize_sr(const float* src, int64_t n, uint8_t* out, uint64_t key, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  int64_t blocks = (chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0)
    quantize_sr_kernel<true><<<grid, kBlock, 0, s>>>(src, n, chunks, out, key);
  else
    quantize_sr_kernel<false><<<grid, kBlock, 0, s>>>(src, n, chunks, out, key);
  return static_cast<int>(cudaGetLastError());
}

const char* dpwa_quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
