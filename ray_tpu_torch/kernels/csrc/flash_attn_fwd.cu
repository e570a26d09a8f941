// Causal flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces: ray_tpu/ops/attention.py:flash_attention_tpu, which runs the
// Pallas TPU MHA kernel shipped with JAX; this is its forward kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_kernel).
// It computes softmax(Q K^T D^-1/2) V under the top-left causal mask
// (key <= query) with an online softmax, so the [S, S] score matrix never
// reaches device memory. Scores, the running max/sum and the output
// accumulator are float32; the probabilities are rounded to V's type before
// P.V, where K1 casts p to v.dtype. Optionally it writes the row logsumexp
// [B, H, S] float32, the counterpart of K1's saved residuals (l, m), which the
// backward kernels will read.
//
// Layout: q, k, v are [B, S, H, D] read through their strides (the last
// dimension contiguous), so the q/k/v views of a fused QKV projection go in
// without transpose copies; o is a contiguous [B, S, H, D].
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch).
// Each block loops over the 64-row k/v tiles up to and including the
// diagonal tile. Tiles are staged in shared memory as float32; thread
// (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4) for both
// products: the score columns tx + 16 j (j < 4) and the output columns
// tx*4 + 64 jj .. +3, so the softmax rescale of its output rows needs no
// exchange, and a row's max and sum are reduced across the 16 lanes that
// share ty with warp shuffles. P reuses the K tile's shared memory.
// Blocks are issued heaviest (last) q tile first to even out the causal
// triangle.
//
// What bounds it on an H100: about 2 B H S^2 D floating-point operations
// (causal halves the 4 B H S^2 D of the full product) against q, k, v read
// once and o written once (4 B S H D elements). At S = 1024, D = 128 that is
// some 250 operations per byte for float32 and 500 for bf16, so the bound is
// the arithmetic rate: 67 TFLOP/s for float32 on the CUDA cores (no TF32:
// the engine's math is exact float32) and 989 TFLOP/s for bf16 on the
// tensor cores.
//
// What this simple design leaves on the table: both products run as scalar
// float32 FMAs on the CUDA cores, so bf16 inputs are held to the float32 rate
// (the tensor cores, via mma.sync or wgmma, are the way to the bf16 bound);
// tiles are loaded with plain loads and no copy/compute overlap (cp.async or
// TMA with a ring of stages would hide the loads); and shared-memory
// bandwidth, not the FMA pipes, limits the inner loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 x) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Copy 64 rows of D elements (row stride `rs` elements) into shared memory
// as float32 rows of stride LD.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t rs, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        Vec4<T>::load(src + r * rs + c);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H,
                 int64_t qsb, int64_t qss, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  // Row strides in shared memory: +4 floats keeps the 16 rows that a warp
  // reads at one column on distinct banks while rows stay 16-byte aligned.
  constexpr int LDQ = D + 4;
  constexpr int LDK = D + 4;
  constexpr int LDV = D;
  constexpr int LDP = kBlockK + 4;
  constexpr int NC = D / 16;  // output columns per thread
  static_assert(kBlockQ * LDP <= kBlockK * LDK, "P must fit in the K tile");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * LDQ;
  float* Vs = Ks + kBlockK * LDK;
  float* Ps = Ks;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = qt * kBlockQ;

  load_tile<T, D, LDQ>(Qs, q + b * qsb + h * qsh + q0 * qss, qss, tid);
  const T* kbase = k + b * ksb + h * ksh;
  const T* vbase = v + b * vsb + h * vsh;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // kBlockQ == kBlockK, so k tile qt is the diagonal one.
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous P.V is done with Ps (= Ks) and Vs
    const int k0 = kt * kBlockK;
    load_tile<T, D, LDK>(Ks, kbase + k0 * kss, kss, tid);
    load_tile<T, D, LDV>(Vs, vbase + k0 * vss, vss, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    const bool diag = (kt == qt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (diag && tx + 16 * j > row) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Column 0 of tile 0 is never masked, so m_new is finite.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        s[i][j] = Vec4<T>::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading Ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < D / 64; ++jj) {
          const float4 vb = *reinterpret_cast<const float4*>(
              Vs + (c + cc) * LDV + jj * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x
                          : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][jj * 4 + 0] = fmaf(p, vb.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(p, vb.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(p, vb.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(p, vb.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    // K1's guard: a row with no unmasked key divides by 1, not 0.
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    T* orow = o + ((int64_t(b) * S + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      Vec4<T>::store(orow + jj * 64 + tx * 4,
                     make_float4(acc[i][jj * 4 + 0] * inv,
                                 acc[i][jj * 4 + 1] * inv,
                                 acc[i][jj * 4 + 2] * inv,
                                 acc[i][jj * 4 + 3] * inv));
    }
    if (lse != nullptr && tx == 0)
      lse[(int64_t(b) * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   float scale, cudaStream_t stream) {
  constexpr int kSmem =
      (kBlockQ * (D + 4) + kBlockK * (D + 4) + kBlockK * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qs/ks/vs: the (batch, seq, head) strides
// in elements. lse may be null. Returns the cudaError_t of the launch; the
// caller has checked shapes, strides, alignment and S % 64 == 0.
int flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int S, int H, int D,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, S, H, qs, ks, vs,
                                     scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, S, H, qs, ks, vs,
                                      scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
