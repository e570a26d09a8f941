// Causal flash-attention backward for Hopper (sm_90a), f32 and bf16 inputs:
// two kernels, dK/dV and dQ.
//
// Replaces: the backward of ray_tpu/ops/attention.py:flash_attention_tpu,
// which is the Pallas TPU MHA kernel shipped with JAX
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//   flash_bwd_dkv_kernel <- _flash_attention_bwd_dkv (_flash_attention_dkv_kernel)
//   flash_bwd_dq_kernel  <- _flash_attention_bwd_dq  (_flash_attention_dq_kernel)
// Both recompute, tile by tile, what the forward never wrote to memory:
//   p  = exp(q.k * scale - lse)              (key <= query, else 0)
//   dp = dO.v
//   ds = p * (dp - di) * scale               di = sum(o * dO), per query row
// and then
//   dV = sum over queries of round(p) dO      dK = sum of round(ds) q
//   dQ = sum over keys of round(ds) k
// where round() is the cast to the input type that the TPU kernel applies
// before each of those products (p to dO's dtype, ds to the input dtype).
// Every sum is accumulated in float32. lse is the forward's row logsumexp
// ([B, H, S] float32, written by flash_attn_fwd.cu), which stands in for the
// TPU kernel's (l, m) residuals: p = exp(s - m) / l = exp(s - (m + log l)).
//
// Layout: q, k, v are [B, S, H, D] read through their strides (the last
// dimension contiguous), so views of a fused QKV projection go in without
// copies; dO is a contiguous [B, S, H, D]; lse and di are contiguous
// [B, H, S] float32; dq, dk, dv are written contiguous [B, S, H, D] in the
// input type.
//
// Design: blocks of 256 threads over 64-row tiles, one block owning the rows
// it writes, so nothing is reduced across blocks and no atomics are needed.
// - dK/dV: one block per (k tile, head, batch). It keeps its K and V tiles
//   in shared memory and dK, dV in registers, and loops over the q tiles at
//   and below the diagonal (query >= key). Blocks with the most q tiles
//   (k tile 0) are issued first.
// - dQ: one block per (q tile, head, batch). It keeps Q, dO, lse and di and
//   dQ in registers, and loops over the k tiles up to the diagonal; ds
//   reuses the V tile's shared memory once dO.v is done. The last q tile
//   (the most work) is issued first.
// Thread (ty, tx) of a 16 x 16 grid computes the score and dp elements
// (rows ty + 16 i, columns tx + 16 j; i, j < 4) of each 64 x 64 tile, and
// owns output rows ty + 16 i, columns tx*4 + 64 jj .. +3, as in
// flash_attn_fwd.cu. Tiles are staged in shared memory as float32.
//
// What bounds it on an H100: dK/dV does four products of the causal
// triangle (q.k, dO.v, p^T dO, ds^T q), about 4 B H S (S+1) D operations,
// against q, k, v, dO read and dk, dv written (6 B S H D elements); dQ does
// three (q.k, dO.v, ds k), 3 B H S (S+1) D, against 5 B S H D elements. At
// S = 1024, D = 128 that is several hundred operations per byte, so the bound
// is the arithmetic rate: 67 TFLOP/s in float32 on the CUDA cores, 989
// TFLOP/s in bf16 on the tensor cores.
//
// What this simple design leaves on the table: every product runs as scalar
// float32 FMAs on the CUDA cores (bf16 included, so bf16 is held to the
// float32 rate; mma.sync or wgmma on the tensor cores is the way to its
// bound); plain loads with no copy/compute overlap (cp.async or TMA); the
// dK/dV block needs 170 KB of shared memory at D 128, so one block (8 warps)
// runs per SM; q.k and dO.v are computed twice, once by each kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kLdT = kBlock + 4;  // row stride of a 64 x 64 tile in shared

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
  for (int i = tid; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        Vec4<T>::load(src + r * rs + c);
  }
}

// out[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two 64-row tiles
// of row stride LD.
template <int D, int LD>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          int ty, int tx, float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = out[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        out[i][j] = s;
      }
  }
}

// acc[i][jj*4 + e] += sum_r P[ty + 16 i][r] * X[r][jj*64 + tx*4 + e], with
// P a 64 x 64 tile (row stride kLdT) and X a 64-row tile of row stride LD.
template <int D, int LD>
__device__ __forceinline__ void tile_accumulate(const float* P, const float* X,
                                                int ty, int tx,
                                                float acc[4][D / 16]) {
#pragma unroll 2
  for (int r = 0; r < kBlock; r += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kLdT + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 xb = *reinterpret_cast<const float4*>(
            X + (r + rr) * LD + jj * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = rr == 0 ? pa[i].x
                        : rr == 1 ? pa[i].y
                        : rr == 2 ? pa[i].z : pa[i].w;
          acc[i][jj * 4 + 0] = fmaf(p, xb.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(p, xb.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(p, xb.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(p, xb.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }
}

// Rows ty + 16 i of a tile starting at row `r0` of a contiguous [B, S, H, D]
// output, columns tx*4 + 64 jj .. +3.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, int b, int h, int S, int H,
                                           int r0, int ty, int tx,
                                           const float acc[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = out + ((int64_t(b) * S + r0 + ty + 16 * i) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      Vec4<T>::store(row + jj * 64 + tx * 4,
                     make_float4(acc[i][jj * 4 + 0], acc[i][jj * 4 + 1],
                                 acc[i][jj * 4 + 2], acc[i][jj * 4 + 3]));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* di;
  void* out0;  // dk (dkv kernel) or dq (dq kernel)
  void* out1;  // dv (dkv kernel)
  int S, H;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + kBlock * LD;
  float* Pt = dOs + kBlock * LD;   // round(p) transposed: [key][query]
  float* dSt = Pt + kBlock * kLdT; // round(ds) transposed
  float* rowv = dSt + kBlock * kLdT;  // lse, then di, of the q tile's rows

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int S = a.S, H = a.H;
  const int kt = blockIdx.x;
  const int nt = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = kt * kBlock;

  load_tile<T, D, LD>(Ks, k + b * a.ksb + h * a.ksh + k0 * a.kss, a.kss, tid);
  load_tile<T, D, LD>(Vs, v + b * a.vsb + h * a.vsh + k0 * a.vss, a.vss, tid);
  const T* qbase = q + b * a.qsb + h * a.qsh;
  const int64_t dos = int64_t(H) * D;
  const T* dobase = dout + (int64_t(b) * S * H + h) * D;
  const float* lse = a.lse + (int64_t(b) * H + h) * S;
  const float* di = a.di + (int64_t(b) * H + h) * S;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // kBlock rows per tile on both sides, so q tile kt is the diagonal one.
  for (int qt = kt; qt < nt; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile's products are done with the tiles
    load_tile<T, D, LD>(Qs, qbase + q0 * a.qss, a.qss, tid);
    load_tile<T, D, LD>(dOs, dobase + q0 * dos, dos, tid);
    if (tid < kBlock) {
      rowv[tid] = lse[q0 + tid];
      rowv[kBlock + tid] = di[q0 + tid];
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<D, LD>(Qs, Ks, ty, tx, s);    // [query ty+16i][key tx+16j]
    tile_dots<D, LD>(dOs, Vs, ty, tx, dp);
    const bool diag = (qt == kt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const float l = rowv[row];
      const float d = rowv[kBlock + row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p =
            (diag && col > row) ? 0.f : expf(s[i][j] * a.scale - l);
        const float ds = p * (dp[i][j] - d) * a.scale;
        Pt[col * kLdT + row] = Vec4<T>::round(p);
        dSt[col * kLdT + row] = Vec4<T>::round(ds);
      }
    }
    __syncthreads();
    tile_accumulate<D, LD>(Pt, dOs, ty, tx, dv);   // rows: keys
    tile_accumulate<D, LD>(dSt, Qs, ty, tx, dk);
  }

  store_rows<T, D>(static_cast<T*>(a.out0), b, h, S, H, k0, ty, tx, dk);
  store_rows<T, D>(static_cast<T*>(a.out1), b, h, S, H, k0, ty, tx, dv);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 16;
  static_assert(kLdT <= LD, "ds must fit in the V tile");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBlock * LD;
  float* Ks = dOs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* dSs = Vs;  // round(ds) [query][key], once dO.v is done with Vs

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int S = a.S, H = a.H;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = qt * kBlock;

  load_tile<T, D, LD>(Qs, q + b * a.qsb + h * a.qsh + q0 * a.qss, a.qss, tid);
  const int64_t dos = int64_t(H) * D;
  load_tile<T, D, LD>(dOs, dout + (int64_t(b) * S * H + h) * D + q0 * dos,
                      dos, tid);
  const float* lse = a.lse + (int64_t(b) * H + h) * S + q0;
  const float* di = a.di + (int64_t(b) * H + h) * S + q0;
  float l[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = lse[ty + 16 * i];
    dr[i] = di[ty + 16 * i];
  }
  const T* kbase = k + b * a.ksb + h * a.ksh;
  const T* vbase = v + b * a.vsb + h * a.vsh;

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous ds.k is done with Ks and dSs (= Vs)
    load_tile<T, D, LD>(Ks, kbase + k0 * a.kss, a.kss, tid);
    load_tile<T, D, LD>(Vs, vbase + k0 * a.vss, a.vss, tid);
    __syncthreads();

    float s[4][4], ds[4][4];
    tile_dots<D, LD>(Qs, Ks, ty, tx, s);
    tile_dots<D, LD>(dOs, Vs, ty, tx, ds);   // dp, turned into ds below
    const bool diag = (kt == qt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p =
            (diag && col > row) ? 0.f : expf(s[i][j] * a.scale - l[i]);
        ds[i][j] = Vec4<T>::round(p * (ds[i][j] - dr[i]) * a.scale);
      }
    }
    __syncthreads();  // every thread is done reading Vs
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * kLdT + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_accumulate<D, LD>(dSs, Ks, ty, tx, dq);
  }

  store_rows<T, D>(static_cast<T*>(a.out0), b, h, S, H, q0, ty, tx, dq);
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem =
      (4 * kBlock * (D + 4) + 2 * kBlock * kLdT + 2 * kBlock) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D>
      <<<dim3(a.S / kBlock, a.H, B), kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem = 4 * kBlock * (D + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D>
      <<<dim3(a.S / kBlock, a.H, B), kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* out0, void* out1,
               int S, int H, const int64_t* qs, const int64_t* ks,
               const int64_t* vs, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.out0 = out0;
  a.out1 = out1;
  a.S = S;
  a.H = H;
  a.qsb = qs[0]; a.qss = qs[1]; a.qsh = qs[2];
  a.ksb = ks[0]; a.kss = ks[1]; a.ksh = ks[2];
  a.vsb = vs[0]; a.vss = vs[1]; a.vsh = vs[2];
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qs/ks/vs: the (batch, seq, head) strides
// of q, k, v in elements; dout is contiguous, lse and di are contiguous
// [B, H, S] float32. Outputs are contiguous [B, S, H, D] in the input type.
// Each returns the cudaError_t of its launch; the caller has checked shapes,
// strides, alignment and S % 64 == 0.
int flash_attn_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int S, int H, int D,
                       const int64_t* qs, const int64_t* ks,
                       const int64_t* vs, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, dk, dv, S, H, qs, ks, vs,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>(a, B, st);
  if (dtype == 0 && D == 128) return launch_dkv<float, 128>(a, B, st);
  if (dtype == 1 && D == 64) return launch_dkv<__nv_bfloat16, 64>(a, B, st);
  if (dtype == 1 && D == 128) return launch_dkv<__nv_bfloat16, 128>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_attn_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int S, int H, int D,
                      const int64_t* qs, const int64_t* ks, const int64_t* vs,
                      float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, dq, nullptr, S, H, qs, ks,
                           vs, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(a, B, st);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(a, B, st);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(a, B, st);
  if (dtype == 1 && D == 128) return launch_dq<__nv_bfloat16, 128>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
