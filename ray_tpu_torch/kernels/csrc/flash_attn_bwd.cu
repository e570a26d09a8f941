// Causal flash-attention backward for Hopper (sm_90a): two kernels, dK/dV
// and dQ, each in two designs, one per input type.
//
// Replaces: the backward of ray_tpu/ops/attention.py:flash_attention_tpu,
// which is the Pallas TPU MHA kernel shipped with JAX
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//   dK/dV (flash_bwd_dkv_tc, flash_bwd_dkv_f32) <- _flash_attention_bwd_dkv
//                                                  (_flash_attention_dkv_kernel)
//   dQ    (flash_bwd_dq_tc,  flash_bwd_dq_f32)  <- _flash_attention_bwd_dq
//                                                  (_flash_attention_dq_kernel)
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
// input type. One block owns the rows it writes, so nothing is reduced
// across blocks, there are no atomics and the result is bitwise the same
// from launch to launch; q.k and dO.v are computed in both kernels, as on
// the TPU.
//
// What bounds them on an H100: dK/dV does four products of the causal
// triangle (q.k, dO.v, p^T dO, ds^T q), about 4 B H S (S+1) D operations,
// against q, k, v, dO read and dk, dv written (6 B S H D elements); dQ does
// three (q.k, dO.v, ds k), 3 B H S (S+1) D, against 5 B S H D elements. At
// S = 1024, D = 128 that is several hundred operations per byte, so both are
// bound by the arithmetic rate: 989 TFLOP/s in bf16 on the tensor cores, 67
// TFLOP/s in float32 on the CUDA cores.
//
// bf16: flash_bwd_dkv_tc and flash_bwd_dq_tc, on the tensor cores.
// - Every product is a warpgroup MMA (wgmma m64n64k16, bf16 in, float32
//   sums). Two warpgroups (256 threads) a block, each owning 64 rows of the
//   block's 128; 255 registers a thread are allowed, so the float32 sums
//   (dK and dV, or dQ) stay in registers for the whole loop.
// - Tiles come into shared memory by TMA (cp.async.bulk.tensor) in 64-column
//   slabs of 128-byte rows with the 128-byte swizzle, which is the layout the
//   wgmma shared-memory descriptors read. The tensor maps are built on the
//   host for each launch over (D, H, S, B) with the tensor's own strides,
//   so the fused-QKV views need no copy (strides must be multiples of 16
//   bytes; the wrapper checks). The streamed tiles go through a ring of two
//   stages under mbarriers: thread 0 refills a stage as soon as both
//   warpgroups have released it, so the next tile's copy overlaps this
//   tile's products.
// - dK/dV: a block per (head, batch, 128-key tile), k tile 0 (the most work)
//   issued first. K and V stay resident; the 64-row q tiles from the
//   diagonal down stream in with their lse and di. Each warpgroup computes
//   S^T = K Q^T and dP^T = V dO^T directly (A = K or V, B = Q or dO, both
//   from shared memory), forms p^T and ds^T in registers (the causal mask
//   falls on the accumulator's own (row, column)), and rounds them to bf16
//   in place as the register A operand of dV += P^T dO and dK += dS^T Q (B =
//   dO or Q from shared memory, read transposed by the descriptor). So no
//   tile is ever transposed through shared memory.
// - dQ: a block per (head, batch, 128-query tile), the last q tile issued
//   first. Q and dO stay resident, lse and di in registers; 64-key K and V
//   tiles stream in. S = Q K^T and dP = dO V^T from shared memory, ds in
//   registers, then dQ += dS K with dS as the register A operand and K read
//   transposed. dP is summed as two chains of k-steps added in float32,
//   which keeps its error at float32 FMA's (see the loop).
// - dQ computes p while dP's products run (committed as a group of their
//   own); the same overlap in dK/dV measured no faster, so it waits once.
// - A warpgroup skips a tile whose every (key, query) is masked.
// float32: flash_bwd_dkv_f32 and flash_bwd_dq_f32, on the CUDA cores (the
// tensor cores take float32 only as TF32, which keeps 10 mantissa bits: too
// few for the float32 path's 1e-4 tolerance). Blocks of 256 threads over
// 64-row tiles staged in shared memory; thread (ty, tx) of a 16 x 16 grid
// computes the score and dp elements (rows ty + 16 i, columns tx + 16 j;
// i, j < 4) of each 64 x 64 tile with scalar FMAs, and owns output rows
// ty + 16 i, columns tx*4 + 64 jj .. +3. The dK/dV block keeps K, V and the
// transposed p and ds tiles in 170 KB of shared memory at D 128, so one
// block runs per SM; loads are synchronous.

#include <math.h>

#include "hopper.cuh"  // TMA, mbarriers, wgmma, tensor maps

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels.

constexpr int kBlock = 64;     // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kLdT = kBlock + 4;  // row stride of a 64 x 64 tile in shared

// Copy 64 rows of D floats (row stride `rs` elements) into shared memory as
// rows of stride LD.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t rs, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int i = tid; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        *reinterpret_cast<const float4*>(src + r * rs + c);
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
template <int D>
__device__ __forceinline__ void store_rows(float* out, int b, int h, int S,
                                           int H, int r0, int ty, int tx,
                                           const float acc[4][D / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = out + ((int64_t(b) * S + r0 + ty + 16 * i) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      *reinterpret_cast<float4*>(row + jj * 64 + tx * 4) =
          make_float4(acc[i][jj * 4 + 0], acc[i][jj * 4 + 1],
                      acc[i][jj * 4 + 2], acc[i][jj * 4 + 3]);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + kBlock * LD;
  float* Pt = dOs + kBlock * LD;   // p transposed: [key][query]
  float* dSt = Pt + kBlock * kLdT; // ds transposed
  float* rowv = dSt + kBlock * kLdT;  // lse, then di, of the q tile's rows

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int S = a.S, H = a.H;
  const int kt = blockIdx.x;
  const int nt = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = kt * kBlock;

  load_tile<D, LD>(Ks, k + b * a.ksb + h * a.ksh + k0 * a.kss, a.kss, tid);
  load_tile<D, LD>(Vs, v + b * a.vsb + h * a.vsh + k0 * a.vss, a.vss, tid);
  const float* qbase = q + b * a.qsb + h * a.qsh;
  const int64_t dos = int64_t(H) * D;
  const float* dobase = dout + (int64_t(b) * S * H + h) * D;
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
    load_tile<D, LD>(Qs, qbase + q0 * a.qss, a.qss, tid);
    load_tile<D, LD>(dOs, dobase + q0 * dos, dos, tid);
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
        Pt[col * kLdT + row] = p;
        dSt[col * kLdT + row] = p * (dp[i][j] - d) * a.scale;
      }
    }
    __syncthreads();
    tile_accumulate<D, LD>(Pt, dOs, ty, tx, dv);   // rows: keys
    tile_accumulate<D, LD>(dSt, Qs, ty, tx, dk);
  }

  store_rows<D>(static_cast<float*>(a.out0), b, h, S, H, k0, ty, tx, dk);
  store_rows<D>(static_cast<float*>(a.out1), b, h, S, H, k0, ty, tx, dv);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32(const Args a) {
  constexpr int LD = D + 4;
  constexpr int NC = D / 16;
  static_assert(kLdT <= LD, "ds must fit in the V tile");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBlock * LD;
  float* Ks = dOs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* dSs = Vs;  // ds [query][key], once dO.v is done with Vs

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int S = a.S, H = a.H;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = qt * kBlock;

  load_tile<D, LD>(Qs, q + b * a.qsb + h * a.qsh + q0 * a.qss, a.qss, tid);
  const int64_t dos = int64_t(H) * D;
  load_tile<D, LD>(dOs, dout + (int64_t(b) * S * H + h) * D + q0 * dos,
                   dos, tid);
  const float* lse = a.lse + (int64_t(b) * H + h) * S + q0;
  const float* di = a.di + (int64_t(b) * H + h) * S + q0;
  float l[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = lse[ty + 16 * i];
    dr[i] = di[ty + 16 * i];
  }
  const float* kbase = k + b * a.ksb + h * a.ksh;
  const float* vbase = v + b * a.vsb + h * a.vsh;

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous ds.k is done with Ks and dSs (= Vs)
    load_tile<D, LD>(Ks, kbase + k0 * a.kss, a.kss, tid);
    load_tile<D, LD>(Vs, vbase + k0 * a.vss, a.vss, tid);
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
        ds[i][j] = p * (ds[i][j] - dr[i]) * a.scale;
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

  store_rows<D>(static_cast<float*>(a.out0), b, h, S, H, q0, ty, tx, dq);
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem =
      (4 * kBlock * (D + 4) + 2 * kBlock * kLdT + 2 * kBlock) * sizeof(float);
  static SmemLimit limit{reinterpret_cast<const void*>(&flash_bwd_dkv_f32<D>),
                        kSmem};
  const cudaError_t err = limit.apply();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32<D>
      <<<dim3(a.S / kBlock, a.H, B), kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem = 4 * kBlock * (D + 4) * sizeof(float);
  static SmemLimit limit{reinterpret_cast<const void*>(&flash_bwd_dq_f32<D>),
                        kSmem};
  const cudaError_t err = limit.apply();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32<D>
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (TMA, mbarriers, wgmma).

constexpr int kTcThreads = 256;   // two warpgroups

// s (= scale^-1 q.k) -> p = exp(scale s - lse) in place, 0 where key >
// query on the diagonal tile. Rows are keys and columns queries when
// kKeysAreRows (the dK/dV kernel's transposed tiles), the other way round
// otherwise; lse2(i) is element i's log2(e) lse.
template <bool kKeysAreRows, typename Lse2>
__device__ __forceinline__ void tile_p(float (&s)[32], bool diag, int row0,
                                       int lane, Lse2 lse2,
                                       float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = acc_row(i, row0), col = acc_col(i, lane);
    const bool masked = diag && (kKeysAreRows ? row > col : col > row);
    s[i] = masked ? 0.f : exp2f(fmaf(s[i], scale_log2, -lse2(i)));
  }
}

// dp (= dO.v) -> ds = p (dp - di) scale in place; di(i) is element i's di.
template <typename Di>
__device__ __forceinline__ void tile_ds(const float (&p)[32],
                                        float (&dp)[32], Di di,
                                        float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - di(i)) * scale;
}

struct TcArgs {
  const float* lse;
  const float* di;
  bf16* out0;  // dk (dkv kernel) or dq (dq kernel)
  bf16* out1;  // dv (dkv kernel)
  int S, H;
  float scale;
};

// Shared memory of both bf16 kernels: a resident pair of 128-row tiles (K
// and V, or Q and dO), then two stages, each a pair of 64-row tiles (Q and
// dO, or K and V) and 64 floats each of lse and di (read by the dK/dV
// kernel only; the stage is padded to a multiple of 1024 bytes), then
// the mbarriers. A tile is D / 64 slabs of [rows][64]
// bf16 (128-byte rows), each 1024-byte aligned for the swizzle.
template <int D>
struct TcSmem {
  static constexpr int kBig = 128 * D * 2;       // a 128-row tile
  static constexpr int kSmall = 64 * D * 2;      // a 64-row tile
  static constexpr int kStage = 2 * kSmall + 1024;  // lse, di, padding
  static constexpr int kStageTx = 2 * kSmall;    // bytes TMA brings a stage
  static constexpr int kBars = 2 * kBig + 2 * kStage;
  static constexpr int kBytes = 1024 + kBars + 5 * 8;  // + alignment slack
  static_assert(kStage % 1024 == 0, "stage tiles stay 1024-byte aligned");
};


// dK/dV. Block (head, batch, 128-key tile kt), the most q tiles first;
// warpgroup wg owns keys k0 + 64 wg ... + 63.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const TcArgs a) {
  using L = TcSmem<D>;
  constexpr int NS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Ks = sm;
  uint8_t* Vs = Ks + L::kBig;
  uint8_t* stages = Vs + L::kBig;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = kv_full + 3;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int k0 = 128 * blockIdx.z;
  const int nq = (S - k0) / 64;   // q tiles q0 = k0 + 64 i
  const float* lse = a.lse + (int64_t(b) * H + h) * S;
  const float* di = a.di + (int64_t(b) * H + h) * S;

  auto issue = [&](int i) {   // q tile i into stage i % 2 (thread 0)
    uint8_t* st = stages + (i % 2) * L::kStage;
    uint64_t* bar = full + i % 2;
    const int q0 = k0 + 64 * i;
    mbar_expect(bar, L::kStageTx + 2 * 64 * 4);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(st + s * 64 * 128, &tq, bar, s * kSlab, h, q0, b);
      tma_load(st + L::kSmall + s * 64 * 128, &tdo, bar, s * kSlab, h, q0, b);
    }
    bulk_load(st + 2 * L::kSmall, lse + q0, 64 * 4, bar);
    bulk_load(st + 2 * L::kSmall + 64 * 4, di + q0, 64 * 4, bar);
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init(empty, kTcThreads / 32);
    mbar_init(empty + 1, kTcThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(kv_full, 2 * L::kBig);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(Ks + s * 128 * 128, &tk, kv_full, s * kSlab, h, k0, b);
      tma_load(Vs + s * 128 * 128, &tv, kv_full, s * kSlab, h, k0, b);
    }
    issue(0);
    issue(1);   // nq >= 2: S - k0 >= 128
  }
  __syncwarp();

  float dk[NS][32], dv[NS][32], s_t[32], dp_t[32];
  zero<D>(dk);
  zero<D>(dv);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_t[i] = dp_t[i] = 0.f;
  const int kw0 = k0 + 64 * wg;                 // this warpgroup's keys
  const int row0 = 16 * warp + lane / 4;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < nq; ++i) {
    const int q0 = k0 + 64 * i;
    const int parity = (i / 2) % 2;
    const uint8_t* st = stages + (i % 2) * L::kStage;
    // Every warp waits for every phase of `full`, also for a tile it skips:
    // a parity wait only compares with the barrier's current phase, so a
    // warp that skipped phase n would take phase n + 2's wait as met while
    // phase n is still pending, and read the stage before its tile lands.
    // It also keeps each warp's `empty` arrivals in order of the tiles.
    mbar_wait(full + i % 2, parity);
    if (q0 >= kw0) {   // else key > query everywhere in the tile
      const float* lse_t = reinterpret_cast<const float*>(st + 2 * L::kSmall);
      const float* di_t = lse_t + 64;
      uint32_t pa[4][4], dsa[4][4];
      wgmma_fence();
      gemm_abt<D>(s_t, Ks, 128, 64 * wg, st, 64, 0);              // K Q^T
      gemm_abt<D>(dp_t, Vs, 128, 64 * wg, st + L::kSmall, 64, 0);  // V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_t);
      reg_fence(dp_t);
      tile_p<true>(s_t, q0 == kw0, row0, lane,
                   [&](int e) { return lse_t[acc_col(e, lane)] * kLog2e; },
                   scale_log2);
      tile_ds(s_t, dp_t, [&](int e) { return di_t[acc_col(e, lane)]; },
              scale);
      to_frags(s_t, pa);
      to_frags(dp_t, dsa);
      wgmma_fence();
      gemm_ax<D>(dv, pa, st + L::kSmall, 64, 0);    // dV += P^T dO
      gemm_ax<D>(dk, dsa, st, 64, 0);               // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        reg_fence(dv[s]);
        reg_fence(dk[s]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % 2);
    if (tid == 0 && i + 2 < nq) {
      mbar_wait(empty + i % 2, parity);
      issue(i + 2);
    }
    __syncwarp();
  }

  const int64_t rs = int64_t(H) * D;
  const int64_t base = ((int64_t(b) * S + kw0) * H + h) * D;
  store_tile<D>(a.out0 + base, rs, dk, row0, lane);
  store_tile<D>(a.out1 + base, rs, dv, row0, lane);
}

// dQ. Block (head, batch, 128-query tile), the last q tile (the most k
// tiles) first; warpgroup wg owns queries q0 + 64 wg ... + 63.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, const TcArgs a) {
  using L = TcSmem<D>;
  constexpr int NS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm;
  uint8_t* dOs = Qs + L::kBig;
  uint8_t* stages = dOs + L::kBig;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = qd_full + 3;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int q0 = 128 * (gridDim.z - 1 - blockIdx.z);
  const int nk = q0 / 64 + 2;   // k tiles k0 = 64 j up to the diagonal

  auto issue = [&](int j) {   // k tile j into stage j % 2 (thread 0)
    uint8_t* st = stages + (j % 2) * L::kStage;
    uint64_t* bar = full + j % 2;
    mbar_expect(bar, L::kStageTx);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(st + s * 64 * 128, &tk, bar, s * kSlab, h, 64 * j, b);
      tma_load(st + L::kSmall + s * 64 * 128, &tv, bar, s * kSlab, h,
               64 * j, b);
    }
  };

  if (tid == 0) {
    mbar_init(qd_full, 1);
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init(empty, kTcThreads / 32);
    mbar_init(empty + 1, kTcThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(qd_full, 2 * L::kBig);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(Qs + s * 128 * 128, &tq, qd_full, s * kSlab, h, q0, b);
      tma_load(dOs + s * 128 * 128, &tdo, qd_full, s * kSlab, h, q0, b);
    }
    issue(0);
    issue(1);   // nk >= 2
  }
  __syncwarp();

  const int qw0 = q0 + 64 * wg;                 // this warpgroup's queries
  const int row0 = 16 * warp + lane / 4;
  const float* lse = a.lse + (int64_t(b) * H + h) * S + qw0;
  const float* di = a.di + (int64_t(b) * H + h) * S + qw0;
  const float lse2[2] = {lse[row0] * kLog2e, lse[row0 + 8] * kLog2e};
  const float dir[2] = {di[row0], di[row0 + 8]};
  float dq[NS][32], s_[32], dp[32], dp2[32];
  zero<D>(dq);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_[i] = dp[i] = dp2[i] = 0.f;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  mbar_wait(qd_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int k0 = 64 * j;
    const int parity = (j / 2) % 2;
    const uint8_t* st = stages + (j % 2) * L::kStage;
    mbar_wait(full + j % 2, parity);   // even when skipping: see dK/dV
    if (k0 <= qw0) {   // else key > query everywhere in the tile
      uint32_t dsa[4][4];
      wgmma_fence();
      gemm_abt<D>(s_, Qs, 128, 64 * wg, st, 64, 0);               // Q K^T
      wgmma_commit();
      // dO V^T as two chains of D / 32 k-steps added in float32: a single
      // chain of D / 16 wgmma steps sums less accurately than float32 FMAs
      // (biased toward zero), two chains match them. dQ needs it where a
      // peaked softmax makes dp - di cancel: ds and so dQ are then float32
      // noise, and the gate against the plain version reads that noise.
      gemm_abt<D, 0, D / 32>(dp, dOs, 128, 64 * wg, st + L::kSmall, 64, 0);
      gemm_abt<D, D / 32, D / 16>(dp2, dOs, 128, 64 * wg, st + L::kSmall,
                                  64, 0);
      wgmma_commit();
      wgmma_wait<1>();   // Q K^T is done; dO V^T runs on under p
      reg_fence(s_);
      tile_p<false>(s_, k0 == qw0, row0, lane,
                    [&](int e) { return lse2[(e / 2) % 2]; }, scale_log2);
      wgmma_wait<0>();
      reg_fence(dp);
      reg_fence(dp2);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] += dp2[i];
      tile_ds(s_, dp, [&](int e) { return dir[(e / 2) % 2]; }, scale);
      to_frags(dp, dsa);
      wgmma_fence();
      gemm_ax<D>(dq, dsa, st, 64, 0);               // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < NS; ++s) reg_fence(dq[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % 2);
    if (tid == 0 && j + 2 < nk) {
      mbar_wait(empty + j % 2, parity);
      issue(j + 2);
    }
    __syncwarp();
  }

  const int64_t rs = int64_t(H) * D;
  store_tile<D>(a.out0 + ((int64_t(b) * S + qw0) * H + h) * D, rs, dq, row0,
                lane);
}


// `dkv`: the dK/dV kernel (K, V resident in 128-row boxes, Q, dO streamed
// in 64-row boxes); else the dQ kernel (the other way round).
template <int D>
cudaError_t launch_tc(bool dkv, const Args& a, int B, cudaStream_t stream) {
  const int S = a.S, H = a.H;
  const int qrows = dkv ? 64 : 128, krows = dkv ? 128 : 64;
  const int64_t qs[3] = {a.qsb, a.qss, a.qsh}, ks[3] = {a.ksb, a.kss, a.ksh},
                vs[3] = {a.vsb, a.vss, a.vsh},
                ds[3] = {int64_t(S) * H * D, int64_t(H) * D, D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map(&tq, a.q, B, S, H, D, qs, qrows)) != cudaSuccess ||
      (err = make_map(&tk, a.k, B, S, H, D, ks, krows)) != cudaSuccess ||
      (err = make_map(&tv, a.v, B, S, H, D, vs, krows)) != cudaSuccess ||
      (err = make_map(&tdo, a.dout, B, S, H, D, ds, qrows)) != cudaSuccess)
    return err;
  TcArgs t;
  t.lse = a.lse;
  t.di = a.di;
  t.out0 = static_cast<bf16*>(a.out0);
  t.out1 = static_cast<bf16*>(a.out1);
  t.S = S;
  t.H = H;
  t.scale = a.scale;
  const auto kernel = dkv ? flash_bwd_dkv_tc<D> : flash_bwd_dq_tc<D>;
  constexpr int kSmem = TcSmem<D>::kBytes;
  static SmemLimit dkv_limit{
      reinterpret_cast<const void*>(&flash_bwd_dkv_tc<D>), kSmem};
  static SmemLimit dq_limit{
      reinterpret_cast<const void*>(&flash_bwd_dq_tc<D>), kSmem};
  if ((err = (dkv ? dkv_limit : dq_limit).apply()) != cudaSuccess) return err;
  kernel<<<dim3(H, B, S / 128), kTcThreads, kSmem, stream>>>(tq, tk, tv, tdo,
                                                              t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qs/ks/vs: the (batch, seq, head) strides
// of q, k, v in elements; dout is contiguous, lse and di are contiguous
// [B, H, S] float32. Outputs are contiguous [B, S, H, D] in the input type.
// Each returns the cudaError_t of its launch; the caller has checked shapes,
// strides, alignment and S % 128 == 0.
int flash_attn_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int S, int H, int D,
                       const int64_t* qs, const int64_t* ks,
                       const int64_t* vs, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, dk, dv, S, H, qs, ks, vs,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dkv_f32<64>(a, B, st);
  if (dtype == 0 && D == 128) return launch_dkv_f32<128>(a, B, st);
  if (dtype == 1 && D == 64) return launch_tc<64>(true, a, B, st);
  if (dtype == 1 && D == 128) return launch_tc<128>(true, a, B, st);
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
  if (dtype == 0 && D == 64) return launch_dq_f32<64>(a, B, st);
  if (dtype == 0 && D == 128) return launch_dq_f32<128>(a, B, st);
  if (dtype == 1 && D == 64) return launch_tc<64>(false, a, B, st);
  if (dtype == 1 && D == 128) return launch_tc<128>(false, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
