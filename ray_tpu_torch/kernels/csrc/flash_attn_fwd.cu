// Causal flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces: ray_tpu/ops/attention.py:flash_attention_tpu, which runs the
// Pallas TPU MHA kernel shipped with JAX; this is its forward kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py, _flash_attention_kernel).
// It computes softmax(Q K^T D^-1/2) V under the top-left causal mask
// (key <= query) with an online softmax over 64-key tiles, so the [S, S]
// score matrix never reaches device memory. Scores, the running max and sum
// and the output sums are float32; p = exp(score - running max up to its
// tile) is rounded to V's type before P.V, where K1 casts p to v.dtype,
// while the row sum l takes p unrounded. Optionally it writes the row
// logsumexp [B, H, S] float32 (natural log), the counterpart of K1's saved
// residuals (l, m), which the backward kernels read.
//
// Layout: q, k, v are [B, S, H, D] read through their strides (the last
// dimension contiguous, the others multiples of 16 bytes), so the q/k/v
// views of a fused QKV projection go in without copies; o is a contiguous
// [B, S, H, D] in the input type.
//
// What bounds it on an H100: about 2 B H S^2 D floating-point operations
// (causal halves the 4 B H S^2 D of the full products) against q, k, v read
// once and o written once (4 B S H D elements). At S = 1024, D = 128 that is
// some 250 operations per byte in float32 and 500 in bf16: the arithmetic
// rate bounds float32 (67 TFLOP/s on the CUDA cores), and bf16 sits near the
// balance point of 989 TFLOP/s and 3.35 TB/s.
//
// bf16: flash_fwd_tc, on the tensor cores (built like flash_attn_bwd.cu's
// dQ kernel, with hopper.cuh's helpers).
// - A block of two warpgroups (256 threads) per (batch, head, 128-query
//   tile); warpgroup wg owns queries q0 + 64 wg .. + 63. Blocks are issued
//   in groups of (batch, head) pairs whose K and V fit about 32 MB of L2,
//   the last q tiles (the most key tiles) of a group first. At 97 KB of
//   shared memory and at most 128 registers a thread, two blocks share an
//   SM, so four warpgroups interleave their products and softmax.
// - Q (128 rows) comes in once by TMA with the 128-byte swizzle; 64-key K
//   and V tiles stream through a two-stage ring under mbarriers, refilled
//   by thread 0 as soon as all eight warps have released a stage. The
//   tensor maps are built per launch over the tensors' own strides.
// - Per key tile: S = Q K^T (wgmma m64n64k16, both operands from shared
//   memory) into 32 float32 registers; the causal mask on the diagonal
//   tile at the accumulator's own (row, column); the tile's row max over
//   the four lanes that share a row (two shuffles); alpha = exp(m_old -
//   m_new) and p = exp(s - m_new), with exp2f on scores pre-scaled by
//   log2(e) D^-1/2; l += this lane's part of the unrounded p (the four
//   lanes' parts are added once, at the end); O *= alpha; p rounded to
//   bf16 in place as the register A operand of O += P V, V read transposed
//   from its swizzled slabs (at D 128 and 256 one m64n128k16 per k-step
//   and pair of slabs).
// - At the end O / l is stored as bf16 and lse = ln 2 (m2 + log2 l).
// - D 256 (heads of 256, e.g. Gemma's and PaLM's): the same design. Shared
//   memory fits (Q 64 KB, two stages of K and V 128 KB: 193 KB), but the
//   output sums alone are 64 x 256 floats a warpgroup, 128 registers a
//   thread, the whole of what two blocks an SM leave each thread. So one
//   block an SM (255 registers a thread): two warpgroups, where D 64 and
//   128 interleave four. The key tile stays 64, so p is rounded where the
//   plain version rounds it.
// - Every warp waits for every phase of every stage's `full` barrier, also
//   for a tile it skips as fully masked (see flash_attn_bwd.cu). Each block
//   owns the rows it writes, so the result is bitwise the same from launch
//   to launch.
// - What bounds it: like the backward's, the S product reads both operands
//   from shared memory at n64, at about the shared memory's rate; PERF.md
//   lists what was tried against that and measured no faster.
//
// float32: flash_fwd_f32, on the CUDA cores (exact float32: the tensor
// cores take float32 only as TF32, which keeps 10 mantissa bits, too few for
// the engine's float32 math and its 1e-4 tolerance).
// - A block of 128 threads per (head, batch, 32-query tile), the last q
//   tiles of every head first, so the light blocks fill in behind the
//   heavy ones. 32-row blocks give twice the blocks of 64-row ones, so the
//   engine's short prefills spread over more of the 132 SMs and the
//   heaviest block (the critical path of a causal grid) does half the work.
//   The same kernel at D 256: 170 KB of shared memory, one block an SM,
//   64 output sums a thread.
// - Thread (ty, tx) of an 8 x 16 grid owns query rows ty + 8 i (i < 4) for
//   both products: score columns tx + 16 j (j < 4) of the 64-key tile, and
//   output columns tx*4 + 64 g .. +3, so the rescale of its output rows
//   needs no exchange; a row's max and sum are reduced across the 16 lanes
//   that share ty with shuffles. P goes through shared memory for P.V.
// - K and V each have one shared-memory buffer, filled by cp.async so that
//   every copy runs under a product: V of tile j under S_j = Q K_j^T, and
//   K of tile j + 1 under P_j V_j. About 91 KB a block at D 128, so two
//   blocks share an SM.
//
// Heads wider than 256 (D 384, 512, 1024: any multiple of 128 that JAX's
// rule sends to its kernel): flash_fwd_tc_dslice and flash_fwd_f32_dslice.
// The designs above hold a whole row of Q, K or V in shared memory and a
// whole row of O in registers, which at D 384 and 512 outgrow both (TcSmem
// 295,976 and 394,280 B, F32Smem 256,000 and 337,920 B against 232,448;
// O's sums 192 and 256 registers a thread), and D has to be a template
// constant. So a block owns one 128-column slice of O (grid: slices x
// q tiles x pairs, D / 128 slices, one per chunk) and D is a runtime count
// of 128-column chunks. Per key tile, S = Q K^T is streamed over D chunk
// by chunk (two stages: chunk t + 1's copies run under chunk t's
// products); after the last chunk come the online softmax of the kernels
// above, unchanged (so p is rounded to bf16 where it is there), and
// O_slice += P V_slice. Every slice's block computes the same S, row max
// and sum bit for bit; slice 0 writes the logsumexp. The cost: each block
// computes the whole of S, D / 128 times the S work in all (4x at D
// 512).
// - bf16: two warpgroups of 64 queries a block; a stage holds a chunk of
//   Q (128 rows) and of K (64 rows) as two 64-column TMA boxes each (a
//   box is at most 256 elements wide), the V slice a buffer of its own
//   loaded with a tile's last chunk. S is one chain of wgmma k-steps over
//   the whole of D, as in flash_fwd_tc. 115,744 B of shared memory, 167
//   registers a thread, no spills (ptxas -v, sm_90a): one block an SM.
// - float32: flash_fwd_f32's 8 x 16 thread grid and 32-query blocks; q.k
//   by sequential FMAs over d = 0 .. D - 1 in order, chunk after chunk
//   into the same sum. 142,848 B of shared memory, 168 registers, no
//   spills: one block an SM.

#include <math.h>

#include <algorithm>

#include "hopper.cuh"  // TMA, mbarriers, wgmma, tensor maps, cp.async

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel.

constexpr int kF32Rows = 32;         // query rows of a block
constexpr int kF32Keys = 64;         // keys of a tile
constexpr int kRT = 4;               // query rows of a thread
constexpr int kCT = 4;               // score columns of a thread
constexpr int kTy = kF32Rows / kRT;  // the threads: a kTy x kTx grid
constexpr int kTx = kF32Keys / kCT;
constexpr int kF32Threads = kTy * kTx;
static_assert(32 % kTx == 0, "a row's lanes sit in one warp");

// Start copying `rows` rows of D floats (row stride `rs` elements) into
// shared memory as rows of stride LD.
template <int D, int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int64_t rs, int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    cp_async16(dst + r * LD + c, src + r * rs + c);
  }
}

// s[i][j] += sum over d < D in order of Q[ty + kTy i][d] K[tx + kTx j][d]
// by sequential FMAs (rows of Q and K LDQ and LDK floats apart).
template <int D, int LDQ, int LDK>
__device__ __forceinline__ void f32_tile_dots(const float* Qs,
                                              const float* Ks,
                                              float (&s)[kRT][kCT], int ty,
                                              int tx) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qa[kRT], kb[kCT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + kTy * i) * LDQ + d);
#pragma unroll
    for (int j = 0; j < kCT; ++j)
      kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + kTx * j) * LDK + d);
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        float a = s[i][j];
        a = fmaf(qa[i].x, kb[j].x, a);
        a = fmaf(qa[i].y, kb[j].y, a);
        a = fmaf(qa[i].z, kb[j].z, a);
        a = fmaf(qa[i].w, kb[j].w, a);
        s[i][j] = a;
      }
  }
}

// The online softmax of one 64-key tile for this thread's rows ty + kTy i:
// s (q.k) becomes p = exp(s scale - m_new) in place, -inf (so 0) where key
// > query on a tile that reaches past the block's first query q0; the
// running max m and sum l move, and the output sums acc are rescaled.
template <int NACC>
__device__ __forceinline__ void f32_tile_softmax(float (&s)[kRT][kCT],
                                                 float (&m)[kRT],
                                                 float (&l)[kRT],
                                                 float (&acc)[kRT][NACC],
                                                 int q0, int k0, int ty,
                                                 int tx, float scale) {
  // Only tiles reaching past the block's first query hold masked keys.
  const bool masked = k0 + kF32Keys - 1 > q0;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int row = q0 + ty + kTy * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      float x = s[i][j] * scale;
      if (masked && k0 + tx + kTx * j > row) x = -INFINITY;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = kTx / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // Tile 0 holds key 0 <= row, so m_new is finite from the first tile
    // on (a later tile whose keys are all masked leaves it, and alpha
    // is 1).
    const float m_new = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      const float p = expf(s[i][j] - m_new);
      sum += p;
      s[i][j] = p;
    }
#pragma unroll
    for (int off = kTx / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[i][c] *= alpha;
  }
}

// acc[i][4 g + e] += sum over the tile's 64 keys in order of P[ty + kTy i]
// [key] V[key][4 kTx g + 4 tx + e]: P of row stride kF32Keys + 4, V of
// row stride LDV.
template <int NG, int LDV>
__device__ __forceinline__ void f32_tile_pv(const float* Ps, const float* Vs,
                                            float (&acc)[kRT][4 * NG], int ty,
                                            int tx) {
  constexpr int kLdP = kF32Keys + 4;
#pragma unroll 2
  for (int c = 0; c < kF32Keys; c += 4) {
    float4 pa[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + kTy * i) * kLdP +
                                               c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vb = *reinterpret_cast<const float4*>(
            Vs + (c + cc) * LDV + 4 * kTx * g + tx * 4);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          const float p = cc == 0 ? pa[i].x
                        : cc == 1 ? pa[i].y
                        : cc == 2 ? pa[i].z : pa[i].w;
          acc[i][g * 4 + 0] = fmaf(p, vb.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(p, vb.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(p, vb.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(p, vb.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
}

// Shared memory of the float32 kernel, in floats: Q [rows][D], K [keys][D],
// V [keys][D], P [rows][keys]. Row strides of +4 floats put the rows that a
// warp reads at one column on distinct banks, and keep rows 16-byte
// aligned.
template <int D>
struct F32Smem {
  static constexpr int kLdQ = D + 4;
  static constexpr int kLdK = D + 4;
  static constexpr int kLdV = D;
  static constexpr int kLdP = kF32Keys + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kF32Rows * kLdQ;
  static constexpr int kV = kK + kF32Keys * kLdK;
  static constexpr int kP = kV + kF32Keys * kLdV;
  static constexpr int kBytes = (kP + kF32Rows * kLdP) * 4;
};

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int H,
              int64_t qsb, int64_t qss, int64_t qsh,
              int64_t ksb, int64_t kss, int64_t ksh,
              int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  using L = F32Smem<D>;
  constexpr int NG = D / (4 * kTx);   // output float4 groups per thread
  static_assert(NG * 4 * kTx == D, "the threads of a row split D evenly");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qs = sm + L::kQ;
  float* Ks = sm + L::kK;
  float* Vs = sm + L::kV;
  float* Ps = sm + L::kP;

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int q0 = qt * kF32Rows;
  // Key tiles up to the one holding the block's last query.
  const int nk = (q0 + kF32Rows - 1) / kF32Keys + 1;
  const float* kbase = k + b * ksb + h * ksh;
  const float* vbase = v + b * vsb + h * vsh;

  copy_rows<D, L::kLdQ>(Qs, q + b * qsb + h * qsh + q0 * qss, kF32Rows, qss,
                        tid);
  copy_rows<D, L::kLdK>(Ks, kbase, kF32Keys, kss, tid);
  cp_async_commit();

  float m[kRT], l[kRT], acc[kRT][4 * NG];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kF32Keys;
    __syncthreads();  // the previous P.V is done with Vs and Ps
    copy_rows<D, L::kLdV>(Vs, vbase + k0 * vss, kF32Keys, vss, tid);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of K (and Q) have landed
    __syncthreads();     // everyone's have

    float s[kRT][kCT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) s[i][j] = 0.f;
    f32_tile_dots<D, L::kLdQ, L::kLdK>(Qs, Ks, s, ty, tx);

    f32_tile_softmax(s, m, l, acc, q0, k0, ty, tx, scale);

    __syncthreads();  // every thread is done reading Ks
    if (kt + 1 < nk) {
      copy_rows<D, L::kLdK>(Ks, kbase + (k0 + kF32Keys) * kss, kF32Keys, kss,
                            tid);
    }
    cp_async_commit();   // (empty on the last tile)
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j)
        Ps[(ty + kTy * i) * L::kLdP + tx + kTx * j] = s[i][j];
    cp_async_wait<1>();  // this thread's copies of V have landed
    __syncthreads();     // everyone's, and all of P
    f32_tile_pv<NG, L::kLdV>(Ps, Vs, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int row = q0 + ty + kTy * i;
    // K1's guard: a row with no unmasked key divides by 1, not 0.
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    float* orow = o + ((int64_t(b) * S + row) * H + h) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      *reinterpret_cast<float4*>(orow + 4 * kTx * g + tx * 4) =
          make_float4(acc[i][g * 4 + 0] * inv, acc[i][g * 4 + 1] * inv,
                      acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
    }
    if (lse != nullptr && tx == 0)
      lse[(int64_t(b) * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, const int64_t* qs,
                       const int64_t* ks, const int64_t* vs, float scale,
                       cudaStream_t stream) {
  constexpr int kSmem = F32Smem<D>::kBytes;
  static SmemLimit limit{reinterpret_cast<const void*>(&flash_fwd_f32<D>),
                         kSmem};
  const cudaError_t err = limit.apply();
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, S / kF32Rows);
  flash_fwd_f32<D><<<grid, kF32Threads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (TMA, mbarriers, wgmma).

constexpr int kTcThreads = 256;   // two warpgroups
// K/V ring depth. Two stages keep a block of D 128 at 97 KB of shared
// memory, so two blocks (four warpgroups) share an SM.
constexpr int kStages = 2;

// Blocks of the tensor-core kernel an SM: two where a thread's output sums
// (D / 2 floats) leave room in 128 registers, else one (D 256).
template <int D>
constexpr int tc_blocks_per_sm() {
  return D <= 128 ? 2 : 1;
}

// Shared memory: the resident 128-row Q tile, then kStages stages, each a
// 64-row K tile and a 64-row V tile, then the mbarriers (Q's, then `full`
// and `empty` per stage). A tile is D / 64 slabs of [rows][64] bf16
// (128-byte rows), each 1024-byte aligned for the swizzle.
template <int D>
struct TcSmem {
  static constexpr int kQ = 128 * D * 2;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages) * 8;
};

// The online softmax of one 64-key tile for one warpgroup's 64 queries
// (this thread's rows row0 and row0 + 8), on its scores s (Q K^T, in the
// accumulator layout): masks keys > query when `diag`, moves the running
// max m2 (of log2(e) D^-1/2-scaled scores), returns alpha = exp(m_old -
// m_new) per row, scales this lane's part of the row sum l by it and adds
// the unrounded p = exp(s - m_new), and rounds p to bf16 as the register A
// fragments of P V.
__device__ __forceinline__ void tile_softmax(float (&s)[32], bool diag,
                                             int row0, int lane,
                                             float scale_log2,
                                             float (&m2)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             uint32_t (&pa)[4][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (diag && acc_col(i, lane) > acc_row(i, row0)) s[i] = -INFINITY;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  }
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // A row's 64 columns sit on the four lanes that share lane / 4.
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // A tile's first key is <= every query it is computed for, so mn is
    // finite; alpha is 0 on the first tile, where m2 is still -inf.
    mn[r] = fmaxf(m2[r], mx[r] * scale_log2);
    alpha[r] = exp2f(m2[r] - mn[r]);
    m2[r] = mn[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) % 2;
    const float p = exp2f(fmaf(s[i], scale_log2, -mn[r]));  // 0 if -inf
    l[r] += p;
    s[i] = p;
  }
  to_frags(s, pa);
}

template <int D>
__device__ __forceinline__ void scale_rows(float (&acc)[D / 64][32],
                                           const float (&f)[2]) {
#pragma unroll
  for (int t = 0; t < D / 64; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] *= f[(i / 2) % 2];
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, tc_blocks_per_sm<D>())
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
             float* __restrict__ lse, int S, int H, int group,
             float scale_log2) {
  using L = TcSmem<D>;
  constexpr int NS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm;
  uint8_t* stages = Qs + L::kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;
  // Block order: the (batch, head) pairs in groups of `group`, and within
  // a group the last q tiles (the most key tiles) of every pair first.
  const int n_q = S / 128;
  const int n_bh = gridDim.x / n_q;
  const int g0 = blockIdx.x / (group * n_q) * group;   // its first pair
  const int g_size = min(group, n_bh - g0);
  const int r = blockIdx.x - g0 * n_q;
  const int bh = g0 + r % g_size;
  const int h = bh % H, b = bh / H;
  const int q0 = 128 * (n_q - 1 - r / g_size);
  const int nk = q0 / 64 + 2;   // k tiles k0 = 64 j up to the diagonal

  auto issue = [&](int j) {   // k tile j into stage j % kStages (thread 0)
    uint8_t* st = stages + (j % kStages) * L::kStage;
    uint64_t* bar = full + j % kStages;
    mbar_expect(bar, L::kStage);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(st + s * 64 * 128, &tk, bar, s * kSlab, h, 64 * j, b);
      tma_load(st + L::kTile + s * 64 * 128, &tv, bar, s * kSlab, h, 64 * j,
               b);
    }
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kTcThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_full, L::kQ);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      tma_load(Qs + s * 128 * 128, &tq, q_full, s * kSlab, h, q0, b);
    for (int j = 0; j < kStages && j < nk; ++j) issue(j);
  }
  __syncwarp();

  const int qw0 = q0 + 64 * wg;                 // this warpgroup's queries
  const int row0 = 16 * warp + lane / 4;
  const int n_own = qw0 / 64 + 1;   // tiles with a key <= some query of ours
  // Row r of this thread's two (row0 + 8 r): the running max of the
  // log2(e)-scaled scores, and this lane's part of the row sum.
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NS][32], s_[32];
  zero<D>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int parity = (j / kStages) % 2;
    const uint8_t* st = stages + (j % kStages) * L::kStage;
    // Every warp waits for every phase of `full`, also for a tile it skips
    // (see flash_attn_bwd.cu).
    mbar_wait(full + j % kStages, parity);
    if (j < n_own) {   // else key > query everywhere in the tile
      float alpha[2];
      uint32_t pa[4][4];
      wgmma_fence();
      gemm_abt<D>(s_, Qs, 128, 64 * wg, st, 64, 0);                // Q K^T
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_);
      tile_softmax(s_, 64 * j == qw0, row0, lane, scale_log2, m2, l, alpha,
                   pa);
      scale_rows<D>(acc, alpha);
      wgmma_fence();
      if constexpr (D % 128 == 0) {   // m64n128k16 products
        gemm_ax_wide<D>(acc, pa, st + L::kTile, 64, 0);            // O += P V
      } else {
        gemm_ax<D>(acc, pa, st + L::kTile, 64, 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < NS; ++t) reg_fence(acc[t]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % kStages);
    if (tid == 0 && j + kStages < nk) {
      mbar_wait(empty + j % kStages, parity);
      issue(j + kStages);
    }
    __syncwarp();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];   // K1's guard
  }
  scale_rows<D>(acc, inv);
  const int64_t rs = int64_t(H) * D;
  store_tile<D>(o + ((int64_t(b) * S + qw0) * H + h) * D, rs, acc, row0,
                lane);
  if (lse != nullptr && lane % 4 == 0) {
    float* out = lse + (int64_t(b) * H + h) * S + qw0 + row0;
    out[0] = kLn2 * m2[0] + logf(l[0]);
    out[8] = kLn2 * m2[1] + logf(l[1]);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int H, const int64_t* qs,
                      const int64_t* ks, const int64_t* vs, float scale,
                      cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, S, H, D, qs, 128)) != cudaSuccess ||
      (err = make_map(&tk, k, B, S, H, D, ks, 64)) != cudaSuccess ||
      (err = make_map(&tv, v, B, S, H, D, vs, 64)) != cudaSuccess)
    return err;
  constexpr int kSmem = TcSmem<D>::kBytes;
  static SmemLimit limit{reinterpret_cast<const void*>(&flash_fwd_tc<D>),
                         kSmem};
  if ((err = limit.apply()) != cudaSuccess) return err;
  // Heaviest blocks first balances the causal grid, but so many pairs at
  // once that their K and V outgrow L2 make every q tile fetch them from
  // device memory again. Groups of pairs whose K and V fill about 32 MB of
  // the 50 MB L2 keep both (PERF.md has the measurements).
  const int64_t kv_bytes = int64_t(4) * S * D;   // K and V of one pair
  const int group = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(B * H, (int64_t(32) << 20) /
                                                         kv_bytes)));
  flash_fwd_tc<D><<<dim3(B * H * (S / 128)), kTcThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, S, H, group, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims above 256 (any multiple of 128: 384, 512, 1024): the D-slice
// kernels, one per type (see the header). D is a runtime count of C-column
// chunks, nc = D / C >= 3; a block owns output columns C sl .. C sl + C - 1.

constexpr int kChunk = 128;   // columns of a chunk of D and of a slice

// Shared memory of the float32 D-slice kernel, in floats: two stages, each
// a chunk of Q (32 rows) and of K (64 rows), rows C + 4 floats apart as in
// F32Smem; the V slice [64][C]; P [32][64 + 4].
template <int C>
struct F32SliceSmem {
  static constexpr int kLd = C + 4;
  static constexpr int kK = kF32Rows * kLd;
  static constexpr int kStage = (kF32Rows + kF32Keys) * kLd;
  static constexpr int kV = 2 * kStage;
  static constexpr int kP = kV + kF32Keys * C;
  static constexpr int kLdP = kF32Keys + 4;
  static constexpr int kBytes = (kP + kF32Rows * kLdP) * 4;
};

// Block (head and slice, batch, 32-query tile), the last q tiles first.
// Steps t = nc j + c run over key tiles j and chunks c: S += Q_c K_c^T by
// sequential FMAs over the chunk's columns, so q.k is summed over d = 0 ..
// D - 1 in order, as flash_fwd_f32 sums it; after the last chunk the online
// softmax (flash_fwd_f32's, bitwise the same in every slice's block) and
// O += P V_slice. Chunk t + 1 (and with a tile's last chunk its V slice)
// is copied in by cp.async under step t's products.
template <int C>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_f32_dslice(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int nc,
                     int64_t qsb, int64_t qss, int64_t qsh,
                     int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  using L = F32SliceSmem<C>;
  constexpr int NG = C / (4 * kTx);   // output float4 groups per thread
  static_assert(NG * 4 * kTx == C, "the threads of a row split C evenly");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Vs = sm + L::kV;
  float* Ps = sm + L::kP;

  const int sl = blockIdx.x % nc, h = blockIdx.x / nc;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int q0 = qt * kF32Rows;
  const int nk = (q0 + kF32Rows - 1) / kF32Keys + 1;
  const int n_steps = nk * nc;
  const float* qbase = q + b * qsb + h * qsh + q0 * qss;
  const float* kbase = k + b * ksb + h * ksh;
  const float* vbase = v + b * vsb + h * vsh + sl * C;

  // Step t's chunks into stage t % 2; V's slice with a tile's last chunk
  // (a single buffer: step t + 1 is issued under step t, so the slice of
  // tile j + 1 lands after tile j's P V has read it while nc >= 2).
  auto issue = [&](int t) {
    const int j = t / nc, c = t % nc;
    float* st = sm + (t % 2) * L::kStage;
    copy_rows<C, L::kLd>(st, qbase + c * C, kF32Rows, qss, tid);
    copy_rows<C, L::kLd>(st + L::kK, kbase + j * kF32Keys * kss + c * C,
                         kF32Keys, kss, tid);
    if (c == nc - 1)
      copy_rows<C, C>(Vs, vbase + j * kF32Keys * vss, kF32Keys, vss, tid);
    cp_async_commit();
  };
  issue(0);

  float m[kRT], l[kRT], acc[kRT][4 * NG], s[kRT][kCT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_steps; ++t) {
    const int j = t / nc, c = t % nc;
    const int k0 = j * kF32Keys;
    cp_async_wait<0>();
    __syncthreads();   // step t's copies have landed; step t - 1 is done
    if (t + 1 < n_steps) issue(t + 1);
    const float* Qs = sm + (t % 2) * L::kStage;
    const float* Ks = Qs + L::kK;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int jj = 0; jj < kCT; ++jj) s[i][jj] = 0.f;
    }
    f32_tile_dots<C, L::kLd, L::kLd>(Qs, Ks, s, ty, tx);
    if (c < nc - 1) continue;

    // The tile's scores are complete: flash_fwd_f32's online softmax and
    // P V_slice.
    f32_tile_softmax(s, m, l, acc, q0, k0, ty, tx, scale);
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int jj = 0; jj < kCT; ++jj)
        Ps[(ty + kTy * i) * L::kLdP + tx + kTx * jj] = s[i][jj];
    __syncthreads();   // all of P
    f32_tile_pv<NG, C>(Ps, Vs, acc, ty, tx);
  }

  const int64_t D = int64_t(nc) * C;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int row = q0 + ty + kTy * i;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];   // K1's guard
    float* orow = o + ((int64_t(b) * S + row) * H + h) * D + sl * C;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      *reinterpret_cast<float4*>(orow + 4 * kTx * g + tx * 4) =
          make_float4(acc[i][g * 4 + 0] * inv, acc[i][g * 4 + 1] * inv,
                      acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
    }
    if (lse != nullptr && sl == 0 && tx == 0)
      lse[(int64_t(b) * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

cudaError_t launch_f32_dslice(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int S, int H,
                              int D, const int64_t* qs, const int64_t* ks,
                              const int64_t* vs, float scale,
                              cudaStream_t stream) {
  constexpr int C = kChunk;
  constexpr int kSmem = F32SliceSmem<C>::kBytes;
  static SmemLimit limit{
      reinterpret_cast<const void*>(&flash_fwd_f32_dslice<C>), kSmem};
  const cudaError_t err = limit.apply();
  if (err != cudaSuccess) return err;
  const int nc = D / C;
  const dim3 grid(H * nc, B, S / kF32Rows);
  flash_fwd_f32_dslice<C><<<grid, kF32Threads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, nc,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return cudaGetLastError();
}

// Shared memory of the bf16 D-slice kernel: two stages, each a chunk of Q
// (128 rows) and of K (64 rows), then the V slice (64 rows), then the
// mbarriers (`full` and `empty` per stage). A chunk or slice is C / 64
// slabs of [rows][64] bf16 (128-byte rows), 1024-byte aligned.
template <int C>
struct TcSliceSmem {
  static constexpr int kQ = 128 * C * 2;
  static constexpr int kKV = 64 * C * 2;
  static constexpr int kStage = kQ + kKV;
  static constexpr int kV = 2 * kStage;
  static constexpr int kBars = kV + kKV;
  static constexpr int kBytes = 1024 + kBars + 4 * 8;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Block (slice, 128-query tile, (batch, head) pair) in flash_fwd_tc's
// order, the slices of one tile adjacent; warpgroup wg owns queries q0 +
// 64 wg .. + 63. Steps t = nc j + c over 64-key tiles j and chunks c: S +=
// Q_c K_c^T (wgmma m64n64k16 from shared memory, one chain over the whole
// of D as flash_fwd_tc's), after the last chunk tile_softmax and O_slice +=
// P V_slice (m64n128k16). Thread 0 keeps two steps in flight by TMA.
template <int C>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_dslice(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, float* __restrict__ lse, int S,
                    int H, int nc, int group, float scale_log2) {
  using L = TcSliceSmem<C>;
  constexpr int NS = C / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Vs = sm + L::kV;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int sl = blockIdx.x % nc, blk = blockIdx.x / nc;
  const int n_q = S / 128;
  const int n_bh = gridDim.x / nc / n_q;
  const int g0 = blk / (group * n_q) * group;
  const int g_size = min(group, n_bh - g0);
  const int r = blk - g0 * n_q;
  const int bh = g0 + r % g_size;
  const int h = bh % H, b = bh / H;
  const int q0 = 128 * (n_q - 1 - r / g_size);
  const int nk = q0 / 64 + 2;
  const int n_steps = nk * nc;

  // Step t's chunks into stage t % 2, and V's slice with a tile's last
  // chunk (thread 0). The V buffer is single: step t + 2 is issued once
  // every warp is done with step t, so the slice of tile j + 1 (issued at
  // its step nc - 3) lands after tile j's P V while nc >= 3.
  auto issue = [&](int t) {
    const int j = t / nc, c = t % nc;
    const bool last = c == nc - 1;
    uint8_t* st = sm + (t % 2) * L::kStage;
    uint64_t* bar = full + t % 2;
    mbar_expect(bar, L::kStage + (last ? L::kKV : 0));
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(st + s * 128 * 128, &tq, bar, (NS * c + s) * kSlab, h, q0, b);
      tma_load(st + L::kQ + s * 64 * 128, &tk, bar, (NS * c + s) * kSlab, h,
               64 * j, b);
      if (last)
        tma_load(Vs + s * 64 * 128, &tv, bar, (NS * sl + s) * kSlab, h,
                 64 * j, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kTcThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    issue(0);
    issue(1);   // n_steps >= 2 nc
  }
  __syncwarp();

  const int qw0 = q0 + 64 * wg;
  const int row0 = 16 * warp + lane / 4;
  const int n_own = qw0 / 64 + 1;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NS][32], s_[32];
  zero<C>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int j = t / nc, c = t % nc;
    const int parity = (t / 2) % 2;
    const uint8_t* st = sm + (t % 2) * L::kStage;
    mbar_wait(full + t % 2, parity);   // every warp, every phase
    if (j < n_own) {
      wgmma_fence();
      gemm_abt<C>(s_, st, 128, 64 * wg, st + L::kQ, 64, 0, c > 0);  // Q K^T
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_);
      if (c == nc - 1) {
        float alpha[2];
        uint32_t pa[4][4];
        tile_softmax(s_, 64 * j == qw0, row0, lane, scale_log2, m2, l,
                     alpha, pa);
        scale_rows<C>(acc, alpha);
        wgmma_fence();
        gemm_ax_wide<C>(acc, pa, Vs, 64, 0);                       // O += P V
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int u = 0; u < NS; ++u) reg_fence(acc[u]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % 2);
    if (tid == 0 && t + 2 < n_steps) {
      mbar_wait(empty + t % 2, parity);
      issue(t + 2);
    }
    __syncwarp();
  }

  float inv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    inv[u] = l[u] == 0.f ? 1.f : 1.f / l[u];   // K1's guard
  }
  scale_rows<C>(acc, inv);
  const int64_t D = int64_t(nc) * C, rs = int64_t(H) * D;
  store_tile<C>(o + ((int64_t(b) * S + qw0) * H + h) * D + sl * C, rs, acc,
                row0, lane);
  if (lse != nullptr && sl == 0 && lane % 4 == 0) {
    float* out = lse + (int64_t(b) * H + h) * S + qw0 + row0;
    out[0] = kLn2 * m2[0] + logf(l[0]);
    out[8] = kLn2 * m2[1] + logf(l[1]);
  }
}

cudaError_t launch_tc_dslice(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int S, int H, int D,
                             const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, float scale,
                             cudaStream_t stream) {
  constexpr int C = kChunk;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, S, H, D, qs, 128)) != cudaSuccess ||
      (err = make_map(&tk, k, B, S, H, D, ks, 64)) != cudaSuccess ||
      (err = make_map(&tv, v, B, S, H, D, vs, 64)) != cudaSuccess)
    return err;
  constexpr int kSmem = TcSliceSmem<C>::kBytes;
  static SmemLimit limit{
      reinterpret_cast<const void*>(&flash_fwd_tc_dslice<C>), kSmem};
  if ((err = limit.apply()) != cudaSuccess) return err;
  // launch_tc's groups of (batch, head) pairs whose K and V fit about 32
  // MB of L2.
  const int64_t kv_bytes = int64_t(4) * S * D;
  const int group = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(B * H, (int64_t(32) << 20) /
                                                         kv_bytes)));
  const int nc = D / C;
  flash_fwd_tc_dslice<C>
      <<<dim3(B * H * (S / 128) * nc), kTcThreads, kSmem, stream>>>(
          tq, tk, tv, static_cast<bf16*>(o), lse, S, H, nc, group,
          scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qs/ks/vs: the (batch, seq, head) strides
// in elements. lse may be null. Returns the cudaError_t of the launch; the
// caller has checked shapes, strides, alignment and S % 128 == 0.
int flash_attn_fwd(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int S, int H, int D,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 1 && D == 64)
    return launch_tc<64>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 1 && D == 128)
    return launch_tc<128>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 256)
    return launch_f32<256>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (dtype == 1 && D == 256)
    return launch_tc<256>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, st);
  if (D > 256 && D % kChunk == 0 && dtype == 0)
    return launch_f32_dslice(q, k, v, o, lse, B, S, H, D, qs, ks, vs, scale,
                             st);
  if (D > 256 && D % kChunk == 0 && dtype == 1)
    return launch_tc_dslice(q, k, v, o, lse, B, S, H, D, qs, ks, vs, scale,
                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
