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
// constant. So D is a runtime count of nc = D / 128 chunks, and a row block
// (128 queries in bf16, 64 in float32) is worked by a thread-block cluster
// of nc blocks, launched with cudaLaunchKernelEx (the cluster size is a
// runtime count too). Rank r keeps chunk r of the row block's Q in shared
// memory from start to end, streams only chunk r of each K tile and slice r
// of each V tile, and owns the 128 output columns of slice r.
// - S is formed once per key tile, in the order one block over all of D
//   forms it: rank r's share of tile t starts from rank r - 1's partial
//   sums, which r - 1 stores into r's shared memory with st.async (16-byte
//   stores counted on r's mbarrier as they land), and continues them over
//   its chunk: the wgmma accumulator loaded from them and the chain of
//   k-steps carrying on with scale-d 1 (bf16), the sequential FMAs carrying
//   on over d (float32). The last rank runs the online softmax of the
//   kernels above on the finished tile, writes p (bf16: the rounded register
//   fragments of P V) and alpha to a slot of its own and bulk-copies the
//   slot to every other rank (the copy engine moves it while the last rank
//   goes on); each rank rescales its output sums by alpha and adds
//   P V_slice. So every output and logsumexp is bitwise what a single block
//   over all of D computes (and what the backward kernels recompute), and
//   each rank does one chunk's S products and one slice's P V products a
//   tile, where a block of the earlier design did nc chunks' S products and
//   streamed all of Q and K for them.
// - The chain is pipelined over key tiles: rank r forms its share of tile t
//   at iteration r + t and adds P_t V_slice at iteration nc + t (the last
//   rank right after its softmax), so each partial sum and each p has a
//   whole iteration to land. Slots are double-buffered, and a reader frees
//   a slot by arriving on the writer's mbarrier with release at CTA scope,
//   as CUTLASS's pipelines free a stage a peer fills: a release at cluster
//   scope also waits for the reader's own stores into peers to land, which
//   doubles a small hand-off's round trip (tools/dsmem_bench.py). The ranks
//   walk the same key tiles up to the diagonal, so they leave the loop
//   together, and a cluster barrier at the end keeps every block until no
//   peer can still reach its shared memory.
// - What bounds it: distributed shared memory moves 10-20 bytes a clock
//   out of an SM and a hand-off's round trip takes about 1,100 cycles on an
//   H100 (tools/dsmem_bench.py), so the hand-offs of a tile (bf16: 16 KB of
//   partial sums in and out of each warpgroup and 9 KB of p; float32: 8 KB
//   and 10 KB a 32-row group) cost about what its products do; the last
//   rank's softmax and staging, which every other rank waits for; and the
//   pipeline's fill, nc - 1 iterations in which later ranks wait for the
//   first tile's partial sums, on top of the nk tiles of a row block. The
//   bound that chip_smoke.py prints is the whole function's (operations or
//   bytes, whichever is larger), as for the kernels above.
// - Above D 2048 (nc > 16, more than a cluster holds): a rank forms m =
//   ceil(nc / 16) chunks of S, a cluster holds n = ceil(nc / m) ranks, and
//   ceil(nc / n) clusters work each row block, cluster j's rank r owning
//   slice n j + r; each cluster forms S once, and its ranks stream their Q
//   chunks with their K chunks (m of them no longer fit in shared memory).
// - bf16: two warpgroups of 64 queries a block, each with its own hand-off
//   mbarriers, and a producer warp that keeps two K and two V stages in
//   flight by TMA (128-byte swizzle, 64-column boxes), so the consumers
//   never wait to refill a stage. S is wgmma m64n64k16 from shared memory,
//   P V m64n128k16 with p in registers.
// - float32: two groups of flash_fwd_f32's 8 x 16 thread grid, 32 queries
//   each, share the K and V tiles (eight warps an SM where one 128-thread
//   block would leave four); K and V rows come in by bulk copies (one a
//   row, rows C + 4 floats apart) on mbarriers, one stage each, refilled by
//   warp 0 as soon as every warp is done with it; p goes through shared
//   memory for P V as in flash_fwd_f32.

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
// running max m and sum l move, and alpha = exp(m_old - m_new) is the
// factor of the rows' output sums.
__device__ __forceinline__ void f32_tile_softmax(float (&s)[kRT][kCT],
                                                 float (&m)[kRT],
                                                 float (&l)[kRT],
                                                 float (&alpha)[kRT],
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
    alpha[i] = expf(m[i] - m_new);
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
    l[i] = l[i] * alpha[i] + sum;
  }
}

// acc[i][c] *= f[i]: the rescale of this thread's output rows.
template <int NACC>
__device__ __forceinline__ void f32_scale_rows(float (&acc)[kRT][NACC],
                                               const float (&f)[kRT]) {
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[i][c] *= f[i];
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

    float alpha[kRT];
    f32_tile_softmax(s, m, l, alpha, q0, k0, ty, tx, scale);
    f32_scale_rows(acc, alpha);

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
// Head dims above 256 (any multiple of 128: 384, 512, 1024, ...): the
// D-slice kernels, one per type (see the header). D is a runtime count of
// C-column chunks, nc = D / C >= 3, and a row block is worked by clusters
// of blocks (SliceGeom): rank r forms its chunks' share of S = Q K^T and
// owns one C-column slice of the output.

constexpr int kChunk = 128;       // columns of a chunk of D and of a slice
constexpr int kMaxCluster = 16;   // blocks a cluster may hold (8 portably)

// The clusters of a row block for nc chunks: m chunks of the S chain a
// block, n blocks a cluster (n m >= nc, n <= kMaxCluster), g clusters a
// row block; rank r of cluster j owns output slice n j + r where that is
// below nc. Up to D 2048 that is one cluster of nc blocks, a chunk each.
struct SliceGeom {
  int nc, m, n, g;
  __host__ __device__ explicit SliceGeom(int chunks)
      : nc(chunks),
        m((chunks + kMaxCluster - 1) / kMaxCluster),
        n((chunks + m - 1) / m),
        g((chunks + n - 1) / n) {}
};

// The work of rank r of a cluster over a row block's nk key tiles. It forms
// its share of tile t's S at iteration r + t; the last rank then runs the
// online softmax and sends p to every rank that owns a slice, which adds
// P_t V_slice at iteration n + t (the last rank at once), a whole iteration
// after p was sent, as each partial S lands an iteration before its
// reader needs it.
struct SliceRank {
  int r, grp, last, c0, mr, sl, n_o, n_iter;
  __device__ SliceRank(const SliceGeom& geo, int rank, int group, int nk)
      : r(rank), grp(group), last(geo.n - 1), c0(rank * geo.m),
        mr(min(geo.m, geo.nc - rank * geo.m)), sl(group * geo.n + rank),
        n_o(min(geo.n, geo.nc - group * geo.n)),
        n_iter(rank == geo.n - 1 ? rank + nk
               : rank < n_o ? geo.n + nk : rank + nk) {}
  __device__ bool has_o() const { return r < n_o; }
  // Ranks that receive p from the last rank: the slice owners but itself.
  __device__ int n_recv() const { return n_o - (last < n_o ? 1 : 0); }
  // The tile whose P V_slice comes at iteration i (may be out of range).
  __device__ int pv_tile(int i) const {
    return r == last ? i - r : i - (last + 1);
  }
};

// The float32 D-slice kernel's block: two groups of flash_fwd_f32's 8 x 16
// thread grid, each with 32 query rows, sharing the K and V tiles (eight
// warps an SM where one 128-thread block would leave four).
constexpr int kF32SliceGroups = 2;
constexpr int kF32SliceThreads = kF32SliceGroups * kF32Threads;
constexpr int kF32SliceRows = kF32SliceGroups * kF32Rows;

// Shared memory of the float32 D-slice kernel, in bytes: the block's Q
// chunk (64 rows; when m is 1), one stage of K (64 rows; with its Q chunk
// when m > 1) and one of V (64 rows), each refilled as soon as every warp
// is done with it, which is a whole product before it is needed again; P
// [64][64 + 4] for P V; then per group two slots of the partial S the
// previous rank hands on, two slots of p and alpha from the last rank, and
// the final 1 / l; then the mbarriers. Rows of Q and K are C + 4 floats
// apart as in F32Smem. A slot holds each thread's values at
// [vector][thread], so a peer's 16-byte stores and the owner's reads are
// one vector a thread.
struct F32SliceSmem {
  static constexpr int kLd = kChunk + 4;
  static constexpr int kQ = kF32SliceRows * kLd * 4;
  static constexpr int kK = kF32Keys * kLd * 4;
  static constexpr int kV = kF32Keys * kChunk * 4;
  static constexpr int kLdP = kF32Keys + 4;
  static constexpr int kP = kF32SliceRows * kLdP * 4;
  static constexpr int kPart = kF32Threads * kRT * 16;         // s
  static constexpr int kPSlot = kF32Threads * (kRT + 1) * 16;  // p, alpha
  static constexpr int kFin = kF32Threads * 16;                // 1 / l
  static constexpr int kNumBars = 5 + 8 * kF32SliceGroups + kF32SliceGroups;
  // Bytes that land: rows of C floats (the padding is never written).
  static constexpr int kQIn = kF32SliceRows * kChunk * 4;
  static constexpr int kKIn = kF32Keys * kChunk * 4;
  int k, v, ps, part, p, fin, bars, bytes;
  __host__ __device__ explicit F32SliceSmem(int m) {
    k = m == 1 ? kQ : 0;
    v = k + kK + (m == 1 ? 0 : kQ);
    ps = v + kV;
    part = ps + kP;
    p = part + 2 * kF32SliceGroups * kPart;
    fin = p + 2 * kF32SliceGroups * kPSlot;
    bars = fin + kF32SliceGroups * kFin;
    bytes = bars + kNumBars * 8;
  }
};
static_assert(F32SliceSmem::kQ % 16 == 0 && F32SliceSmem::kK % 16 == 0,
              "bulk copies land on 16-byte boundaries");

// Cluster (rank, cluster of the row block, head), batch, 64-query tile, the
// last q tiles first. Group g of the block owns queries q0 + 32 g .. + 31
// on flash_fwd_f32's 8 x 16 thread grid, with hand-off mbarriers of its
// own. Rank r's share of tile t's S continues rank r - 1's partial sums
// (read from its own slot) by sequential FMAs over its chunks' columns, so
// q.k is summed over d = 0 .. D - 1 in order, as flash_fwd_f32 sums it;
// rank r + 1 gets them by st.async. The last rank runs flash_fwd_f32's
// online softmax, puts p and alpha in its own slot and bulk-copies the slot
// to every other slice owner; each rescales its sums by alpha and adds
// P V_slice, so its outputs are bitwise those of one block over all of D.
// K chunks and V slices come in by bulk copies (one a row) on mbarriers,
// refilled by warp 0.
template <int C>
__global__ void __launch_bounds__(kF32SliceThreads, 1)
flash_fwd_f32_dslice(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int nc,
                     int64_t qsb, int64_t qss, int64_t qsh,
                     int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh, float scale) {
  static_assert(C == kChunk, "the layout is kChunk's");
  using L = F32SliceSmem;
  constexpr int NG = C / (4 * kTx);   // output float4 groups per thread
  static_assert(NG * 4 * kTx == C, "the threads of a row split C evenly");
  constexpr int kWarps = kF32SliceThreads / 32;
  const SliceGeom geo(nc);
  const L lay(geo.m);
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;
  uint64_t* part_full = q_full + 5;    // [slot][group]
  uint64_t* part_empty = q_full + 9;
  uint64_t* p_full = q_full + 13;      // [slot][group]
  uint64_t* p_empty = q_full + 17;
  uint64_t* fin_full = q_full + 21;    // [group]

  const int n = geo.n;
  const int cl = blockIdx.x / n;
  const int h = cl / geo.g, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = tid / kF32Threads, gt = tid % kF32Threads;
  const int tx = gt % kTx, ty = gt / kTx;
  const int q0 = qt * kF32SliceRows;
  const int qg0 = q0 + grp * kF32Rows;   // this group's first query
  const int nk = q0 / kF32Keys + 1;      // both groups' key tiles
  const SliceRank rk(geo, static_cast<int>(cluster_rank()), cl % geo.g, nk);
  const bool q_res = geo.m == 1;
  const int n_kitems = nk * rk.mr;
  const float* qbase = q + b * qsb + h * qsh + q0 * qss;
  const float* kbase = k + b * ksb + h * ksh;
  const float* vbase = v + b * vsb + h * vsh + rk.sl * C;
  float* Ps = reinterpret_cast<float*>(sm + lay.ps) + grp * kF32Rows * L::kLdP;

  // Warp 0 copies `rows` rows of C floats (row stride rs) to rows `ld`
  // floats apart at dst, on `bar`.
  auto rows_in = [&](uint8_t* dst, const float* src, int rows, int64_t rs,
                     int ld, uint64_t* bar) {
    for (int i = lane; i < rows; i += 32)
      bulk_load(dst + i * ld * 4, src + i * rs, C * 4, bar);
  };
  // K item u (tile u / mr, chunk c0 + u % mr), with its Q chunk when m > 1
  // (warp 0).
  auto issue_k = [&](int u) {
    const int t = u / rk.mr, c = rk.c0 + u % rk.mr;
    uint8_t* st = sm + lay.k;
    if (lane == 0) mbar_expect(k_full, L::kKIn + (q_res ? 0 : L::kQIn));
    __syncwarp();
    if (!q_res) rows_in(st + L::kK, qbase + c * C, kF32SliceRows, qss,
                        L::kLd, k_full);
    rows_in(st, kbase + int64_t(t) * kF32Keys * kss + c * C, kF32Keys, kss,
            L::kLd, k_full);
  };
  auto issue_v = [&](int t) {
    if (lane == 0) mbar_expect(v_full, L::kV);
    __syncwarp();
    rows_in(sm + lay.v, vbase + int64_t(t) * kF32Keys * vss, kF32Keys, vss,
            C, v_full);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(k_empty, kWarps);
    mbar_init(v_full, 1);
    mbar_init(v_empty, kWarps);
    for (int i = 0; i < 2 * kF32SliceGroups; ++i) {
      mbar_init(part_full + i, 1);
      mbar_init(part_empty + i, kF32Threads / 32);
      mbar_init(p_full + i, 1);
      mbar_init(p_empty + i, rk.n_recv() * kF32Threads / 32);
    }
    for (int i = 0; i < kF32SliceGroups; ++i) mbar_init(fin_full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every peer's barriers are set before any hand-off
  if (warp == 0) {
    if (q_res) {
      if (lane == 0) mbar_expect(q_full, L::kQIn);
      __syncwarp();
      rows_in(sm, qbase + rk.c0 * C, kF32SliceRows, qss, L::kLd, q_full);
    }
    issue_k(0);
    if (rk.has_o()) issue_v(0);
  }

  float m[kRT], l[kRT], acc[kRT][4 * NG], s[kRT][kCT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }
  if (q_res) mbar_wait(q_full, 0);

  int u = 0;   // the next K item
  for (int i = rk.r; i < rk.n_iter; ++i) {
    const int ts = i - rk.r;
    if (ts < nk) {
      for (int kk = 0; kk < rk.mr; ++kk, ++u) {
        const uint8_t* st = sm + lay.k;
        const float* Qs = reinterpret_cast<const float*>(
                              q_res ? sm : st + L::kK) +
                          grp * kF32Rows * L::kLd;
        mbar_wait(k_full, u % 2);
        if (kk == 0 && rk.r > 0) {   // rank r - 1's partial sums
          const int slot = 2 * (ts % 2) + grp;
          if (gt == 0) mbar_expect(part_full + slot, L::kPart);
          mbar_wait_cluster(part_full + slot, (ts / 2) % 2);
          const float4* src = reinterpret_cast<const float4*>(
              sm + lay.part + slot * L::kPart) + gt;
#pragma unroll
          for (int a = 0; a < kRT; ++a) {
            const float4 x = src[a * kF32Threads];
            s[a][0] = x.x;
            s[a][1] = x.y;
            s[a][2] = x.z;
            s[a][3] = x.w;
          }
          __syncwarp();
          if (lane == 0)
            mbar_arrive_peer(peer_addr(part_empty + slot, rk.r - 1));
        } else if (kk == 0) {
#pragma unroll
          for (int a = 0; a < kRT; ++a)
#pragma unroll
            for (int jj = 0; jj < kCT; ++jj) s[a][jj] = 0.f;
        }
        f32_tile_dots<C, L::kLd, L::kLd>(
            Qs, reinterpret_cast<const float*>(st), s, ty, tx);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty);
        if (warp == 0 && u + 1 < n_kitems) {   // the stage refills
          mbar_wait(k_empty, u % 2);
          issue_k(u + 1);
        }
      }
      if (rk.r < rk.last) {   // hand the partial sums on
        const int slot = 2 * (ts % 2) + grp;
        if (ts >= 2) mbar_wait(part_empty + slot, (ts / 2 - 1) % 2);
        const uint32_t dst = peer_addr(
            sm + lay.part + slot * L::kPart + gt * 16, rk.r + 1);
        const uint32_t bar = peer_addr(part_full + slot, rk.r + 1);
#pragma unroll
        for (int a = 0; a < kRT; ++a)
          st_async16(dst + a * kF32Threads * 16, bar,
                     make_float4(s[a][0], s[a][1], s[a][2], s[a][3]));
      } else {   // the tile's S is whole: softmax, p to the slice owners
        // p and alpha into this block's slot, then bulk copies of the slot
        // to the receivers' (the copy engine moves them while this block
        // goes on to its own P V).
        float alpha[kRT];
        f32_tile_softmax(s, m, l, alpha, qg0, ts * kF32Keys, ty, tx, scale);
        const int slot = 2 * (ts % 2) + grp;
        if (ts >= 2 && rk.n_recv() > 0)   // the copies of tile ts - 2 landed
          mbar_wait(p_empty + slot, (ts / 2 - 1) % 2);
        uint8_t* mine = sm + lay.p + slot * L::kPSlot;
#pragma unroll
        for (int a = 0; a < kRT; ++a)
          reinterpret_cast<float4*>(mine)[a * kF32Threads + gt] =
              make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
        reinterpret_cast<float4*>(mine)[kRT * kF32Threads + gt] =
            make_float4(alpha[0], alpha[1], alpha[2], alpha[3]);
        fence_proxy_async();
        bar_sync(1 + grp, kF32Threads);
        if (gt == 0)
          for (int dstr = 0; dstr < rk.n_o; ++dstr)
            if (dstr != rk.last)
              bulk_to_peer(peer_addr(mine, dstr), mine, L::kPSlot,
                           peer_addr(p_full + slot, dstr));
      }
    }

    const int tp = rk.pv_tile(i);
    if (rk.has_o() && tp >= 0 && tp < nk) {
      const int slot = 2 * (tp % 2) + grp;
      if (rk.r != rk.last) {   // the last rank's copy of p and alpha
        if (gt == 0) mbar_expect(p_full + slot, L::kPSlot);
        mbar_wait_cluster(p_full + slot, (tp / 2) % 2);
      }
      const float4* src = reinterpret_cast<const float4*>(
          sm + lay.p + slot * L::kPSlot) + gt;
      float4 pr[kRT];
#pragma unroll
      for (int a = 0; a < kRT; ++a) pr[a] = src[a * kF32Threads];
      const float4 al = src[kRT * kF32Threads];
      __syncwarp();
      if (lane == 0 && rk.r != rk.last)
        mbar_arrive_peer(peer_addr(p_empty + slot, rk.last));
      const float alpha[kRT] = {al.x, al.y, al.z, al.w};
      f32_scale_rows(acc, alpha);
      bar_sync(1 + grp, kF32Threads);   // the group's previous P V is done
#pragma unroll
      for (int a = 0; a < kRT; ++a) {
        float* row = Ps + (ty + kTy * a) * L::kLdP + tx;
        row[0] = pr[a].x;
        row[kTx] = pr[a].y;
        row[2 * kTx] = pr[a].z;
        row[3 * kTx] = pr[a].w;
      }
      mbar_wait(v_full, tp % 2);
      bar_sync(1 + grp, kF32Threads);   // all of the group's P
      f32_tile_pv<NG, C>(Ps, reinterpret_cast<const float*>(sm + lay.v),
                         acc, ty, tx);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty);
      if (warp == 0 && tp + 1 < nk) {   // the stage refills
        mbar_wait(v_empty, tp % 2);
        issue_v(tp + 1);
      }
    }
  }

  const int64_t D = int64_t(nc) * C;
  if (rk.r == rk.last) {   // 1 / l to the slice owners; the logsumexp
    float inv[kRT];
#pragma unroll
    for (int a = 0; a < kRT; ++a)
      inv[a] = l[a] == 0.f ? 1.f : 1.f / l[a];   // K1's guard
    for (int dstr = 0; dstr < rk.n_o; ++dstr)
      st_async16(peer_addr(sm + lay.fin + grp * L::kFin + gt * 16, dstr),
                 peer_addr(fin_full + grp, dstr),
                 make_float4(inv[0], inv[1], inv[2], inv[3]));
    if (lse != nullptr && rk.grp == 0 && tx == 0)
#pragma unroll
      for (int a = 0; a < kRT; ++a)
        lse[(int64_t(b) * H + h) * S + qg0 + ty + kTy * a] =
            m[a] + logf(l[a]);
  }
  if (rk.has_o()) {
    if (gt == 0) mbar_expect(fin_full + grp, L::kFin);
    mbar_wait_cluster(fin_full + grp, 0);
    const float4 f = reinterpret_cast<const float4*>(
        sm + lay.fin + grp * L::kFin)[gt];
    const float inv[kRT] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int a = 0; a < kRT; ++a) {
      const int row = qg0 + ty + kTy * a;
      float* orow = o + ((int64_t(b) * S + row) * H + h) * D + rk.sl * C;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        *reinterpret_cast<float4*>(orow + 4 * kTx * gg + tx * 4) =
            make_float4(acc[a][gg * 4 + 0] * inv[a],
                        acc[a][gg * 4 + 1] * inv[a],
                        acc[a][gg * 4 + 2] * inv[a],
                        acc[a][gg * 4 + 3] * inv[a]);
      }
    }
  }
  cluster_sync();   // no block leaves while a peer may still reach it
}

// The launch configuration of clusters of `cluster` blocks; `attr` holds
// the cluster attribute it points to.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int cluster,
                                  dim3 grid, int threads, int smem,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A launch of `kernel` in clusters of `cluster` blocks.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int cluster,
                            dim3 grid, int threads, int smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, cluster, grid, threads, smem, stream);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The largest dynamic shared memory of a D-slice kernel over every m, and
// its function attributes (set once a card).
template <typename Smem>
int max_slice_smem() {
  return std::max(Smem(1).bytes, Smem(2).bytes);
}

SmemLimit& f32_dslice_limit() {
  static SmemLimit limit{
      reinterpret_cast<const void*>(&flash_fwd_f32_dslice<kChunk>),
      max_slice_smem<F32SliceSmem>(), true};
  return limit;
}

cudaError_t launch_f32_dslice(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int S, int H,
                              int D, const int64_t* qs, const int64_t* ks,
                              const int64_t* vs, float scale,
                              cudaStream_t stream) {
  const cudaError_t err = f32_dslice_limit().apply();
  if (err != cudaSuccess) return err;
  const SliceGeom geo(D / kChunk);
  const dim3 grid(H * geo.g * geo.n, B, S / kF32SliceRows);
  const cudaError_t launch = launch_clusters(
      flash_fwd_f32_dslice<kChunk>, geo.n, grid, kF32SliceThreads,
      F32SliceSmem(geo.m).bytes, stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, H, geo.nc, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], scale);
  return launch != cudaSuccess ? launch : cudaGetLastError();
}

// Shared memory of the bf16 D-slice kernel, in bytes from the 1024-aligned
// base: the block's Q chunk (128 rows; when m is 1), a two-stage ring of K
// chunks (64 rows; each stage also holds its Q chunk first when m > 1), a
// two-stage ring of V slices (64 rows), the slots of the partial S the
// previous rank hands on (two when m is 1, one else), two slots of p and
// alpha, the final 1 / l, then the mbarriers. A chunk or slice is C / 64
// slabs of [rows][64] bf16 (128-byte rows), 1024-byte aligned. A slot holds
// each warpgroup's values at [vector][thread], one 16-byte vector a thread
// (alpha: 8 bytes a thread after p's four vectors).
struct TcSliceSmem {
  static constexpr int kQ = 128 * kChunk * 2;
  static constexpr int kKV = 64 * kChunk * 2;
  static constexpr int kPartWg = 128 * 8 * 16;   // s, 32 floats
  static constexpr int kPWg = 128 * (4 * 16 + 8);   // p fragments, alpha
  static constexpr int kFinWg = 128 * 16;        // 1 / l
  static constexpr int kNumBars = 27;
  int k, k_stage, v, n_part, part, p, fin, bars, bytes;
  __host__ __device__ explicit TcSliceSmem(int m) {
    k = m == 1 ? kQ : 0;
    k_stage = kKV + (m == 1 ? 0 : kQ);
    v = k + 2 * k_stage;
    n_part = m == 1 ? 2 : 1;
    part = v + 2 * kKV;
    p = part + n_part * 2 * kPartWg;
    fin = p + 2 * 2 * kPWg;
    bars = fin + 2 * kFinWg;
    bytes = 1024 + bars + kNumBars * 8;
  }
};

// Cluster (rank, cluster of the row block, 128-query tile, (batch, head)
// pair) in flash_fwd_tc's order of row blocks; warpgroup wg owns queries
// q0 + 64 wg .. + 63, and each warpgroup's hand-offs have mbarriers of
// their own. Rank r's share of tile t's S continues rank r - 1's
// accumulator (loaded into the wgmma registers, the chain of k-steps
// carrying on with scale-d 1), so S is flash_fwd_tc's one chain of
// k-steps over the whole of D; the last rank runs tile_softmax and sends
// the bf16 fragments of p and alpha to every slice owner, which adds
// P V_slice (m64n128k16). A producer warp keeps two K and two V stages in
// flight by TMA, so the consumer warps never wait to refill a stage.
constexpr int kTcSliceThreads = kTcThreads + 32;   // + the producer warp

template <int C>
__global__ void __launch_bounds__(kTcSliceThreads, 1)
flash_fwd_tc_dslice(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, float* __restrict__ lse, int S,
                    int H, int nc, int group, float scale_log2) {
  static_assert(C == kChunk, "the layout is kChunk's");
  using L = TcSliceSmem;
  constexpr int NS = C / 64;
  const SliceGeom geo(nc);
  const L lay(geo.m);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* k_full = q_full + 1;       // [stage]
  uint64_t* k_empty = q_full + 3;
  uint64_t* v_full = q_full + 5;
  uint64_t* v_empty = q_full + 7;
  uint64_t* part_full = q_full + 9;    // [slot][wg]
  uint64_t* part_empty = q_full + 13;
  uint64_t* p_full = q_full + 17;      // [slot][wg]
  uint64_t* p_empty = q_full + 21;
  uint64_t* fin_full = q_full + 25;    // [wg]

  const int tid = threadIdx.x, lane = tid % 32, wt = tid % 128;
  const int wg = tid / 128, warp = wt / 32;
  const int n = geo.n;
  const int cl = blockIdx.x / n;
  const int blk = cl / geo.g;
  const int n_q = S / 128;
  const int n_bh = gridDim.x / n / geo.g / n_q;
  const int g0 = blk / (group * n_q) * group;
  const int g_size = min(group, n_bh - g0);
  const int rb = blk - g0 * n_q;
  const int bh = g0 + rb % g_size;
  const int h = bh % H, b = bh / H;
  const int q0 = 128 * (n_q - 1 - rb / g_size);
  const int nk = q0 / 64 + 2;
  const SliceRank rk(geo, static_cast<int>(cluster_rank()), cl % geo.g, nk);
  const bool q_res = geo.m == 1;
  const int n_kitems = nk * rk.mr;

  auto issue_k = [&](int u) {   // K item u into stage u % 2
    const int t = u / rk.mr, c = rk.c0 + u % rk.mr;
    uint8_t* st = sm + lay.k + (u % 2) * lay.k_stage;
    uint64_t* bar = k_full + u % 2;
    mbar_expect(bar, lay.k_stage);
    uint8_t* kst = q_res ? st : st + L::kQ;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!q_res)
        tma_load(st + s * 128 * 128, &tq, bar, (NS * c + s) * kSlab, h, q0,
                 b);
      tma_load(kst + s * 64 * 128, &tk, bar, (NS * c + s) * kSlab, h,
               64 * t, b);
    }
  };
  auto issue_v = [&](int t) {   // V slice of tile t
    uint64_t* bar = v_full + t % 2;
    mbar_expect(bar, L::kKV);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      tma_load(sm + lay.v + (t % 2) * L::kKV + s * 64 * 128, &tv, bar,
               (NS * rk.sl + s) * kSlab, h, 64 * t, b);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(k_empty + i, kTcThreads / 32);
      mbar_init(v_full + i, 1);
      mbar_init(v_empty + i, kTcThreads / 32);
      mbar_init(fin_full + i, 1);
      for (int w = 0; w < 2; ++w) {
        mbar_init(part_full + 2 * i + w, 1);
        mbar_init(part_empty + 2 * i + w, 4);
        mbar_init(p_full + 2 * i + w, 1);
        mbar_init(p_empty + 2 * i + w, 4 * rk.n_recv());
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every peer's barriers are set before any hand-off
  if (tid >= kTcThreads) {
    // The producer warp: lane 0 keeps two K stages in flight (and brings
    // in the resident Q chunk), lane 1 two V stages, each refilling a
    // stage as soon as all eight consumer warps have released it.
    if (lane == 0) {
      if (q_res) {
        mbar_expect(q_full, L::kQ);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          tma_load(sm + s * 128 * 128, &tq, q_full,
                   (NS * rk.c0 + s) * kSlab, h, q0, b);
      }
      for (int u = 0; u < n_kitems; ++u) {
        if (u >= 2) mbar_wait(k_empty + u % 2, (u / 2 - 1) % 2);
        issue_k(u);
      }
    } else if (lane == 1 && rk.has_o()) {
      for (int t = 0; t < nk; ++t) {
        if (t >= 2) mbar_wait(v_empty + t % 2, (t / 2 - 1) % 2);
        issue_v(t);
      }
    }
    __syncwarp();
    cluster_sync();   // no block leaves while a peer may still reach it
    return;
  }

  const int qw0 = q0 + 64 * wg;
  const int row0 = 16 * warp + lane / 4;
  const int n_own = qw0 / 64 + 1;   // tiles with a key <= some query of ours
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NS][32], s_[32];
  zero<C>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_[i] = 0.f;
  if (q_res) mbar_wait(q_full, 0);

  int u = 0;   // the next K item
  for (int i = rk.r; i < rk.n_iter; ++i) {
    const int ts = i - rk.r;
    uint32_t pa[4][4];   // p's fragments and alpha of the tile P V takes
    float alpha[2];
    if (ts < nk) {
      const bool act = ts < n_own;   // else key > query all over the tile
      for (int kk = 0; kk < rk.mr; ++kk, ++u) {
        const uint8_t* st = sm + lay.k + (u % 2) * lay.k_stage;
        mbar_wait(k_full + u % 2, (u / 2) % 2);   // every warp, every phase
        if (act) {
          if (kk == 0 && rk.r > 0) {   // rank r - 1's accumulator
            const int slot = ts % lay.n_part;
            uint64_t* bar = part_full + 2 * slot + wg;
            if (wt == 0) mbar_expect(bar, L::kPartWg);
            mbar_wait_cluster(bar, (ts / lay.n_part) % 2);
            const float4* src = reinterpret_cast<const float4*>(
                sm + lay.part + (2 * slot + wg) * L::kPartWg) + wt;
#pragma unroll
            for (int a = 0; a < 8; ++a) {
              const float4 x = src[a * 128];
              s_[4 * a] = x.x;
              s_[4 * a + 1] = x.y;
              s_[4 * a + 2] = x.z;
              s_[4 * a + 3] = x.w;
            }
            __syncwarp();
            if (lane == 0)
              mbar_arrive_peer(peer_addr(part_empty + 2 * slot + wg,
                                         rk.r - 1));
          }
          wgmma_fence();
          gemm_abt<C>(s_, q_res ? sm : st, 128, 64 * wg,
                      q_res ? st : st + L::kQ, 64, 0, kk > 0 || rk.r > 0);
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(s_);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty + u % 2);
      }
      if (act && rk.r < rk.last) {   // hand the accumulator on
        const int slot = ts % lay.n_part, use = ts / lay.n_part;
        if (use > 0)
          mbar_wait(part_empty + 2 * slot + wg, (use - 1) % 2);
        const uint32_t dst = peer_addr(
            sm + lay.part + (2 * slot + wg) * L::kPartWg + wt * 16,
            rk.r + 1);
        const uint32_t bar = peer_addr(part_full + 2 * slot + wg, rk.r + 1);
#pragma unroll
        for (int a = 0; a < 8; ++a)
          st_async16(dst + a * 128 * 16, bar,
                     make_float4(s_[4 * a], s_[4 * a + 1], s_[4 * a + 2],
                                 s_[4 * a + 3]));
      } else if (act) {   // S is whole: softmax, p to the slice owners
        tile_softmax(s_, 64 * ts == qw0, row0, lane, scale_log2, m2, l,
                     alpha, pa);
        // p and alpha into this block's slot, then bulk copies of the
        // slot to the receivers' (the copy engine moves them while this
        // block goes on to its own P V from its registers).
        const int slot = ts % 2;
        if (ts >= 2 && rk.n_recv() > 0)   // the copies of tile ts - 2 landed
          mbar_wait(p_empty + 2 * slot + wg, (ts / 2 - 1) % 2);
        uint8_t* mine = sm + lay.p + (2 * slot + wg) * L::kPWg;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          reinterpret_cast<uint4*>(mine)[a * 128 + wt] =
              make_uint4(pa[a][0], pa[a][1], pa[a][2], pa[a][3]);
        reinterpret_cast<float2*>(mine + 4 * 128 * 16)[wt] =
            make_float2(alpha[0], alpha[1]);
        fence_proxy_async();
        bar_sync(1 + wg, 128);
        if (wt == 0)
          for (int dstr = 0; dstr < rk.n_o; ++dstr)
            if (dstr != rk.last)
              bulk_to_peer(peer_addr(mine, dstr), mine, L::kPWg,
                           peer_addr(p_full + 2 * slot + wg, dstr));
      }
    }

    const int tp = rk.pv_tile(i);
    if (rk.has_o() && tp >= 0 && tp < nk) {
      const int slot = tp % 2;
      mbar_wait(v_full + slot, (tp / 2) % 2);   // every warp, every phase
      if (tp < n_own) {
        if (rk.r != rk.last) {   // p and alpha from the last rank's copy
          uint64_t* bar = p_full + 2 * slot + wg;
          if (wt == 0) mbar_expect(bar, L::kPWg);
          mbar_wait_cluster(bar, (tp / 2) % 2);
          const uint8_t* src = sm + lay.p + (2 * slot + wg) * L::kPWg;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const uint4 x = reinterpret_cast<const uint4*>(src)[a * 128 + wt];
            pa[a][0] = x.x;
            pa[a][1] = x.y;
            pa[a][2] = x.z;
            pa[a][3] = x.w;
          }
          const float2 al =
              reinterpret_cast<const float2*>(src + 4 * 128 * 16)[wt];
          alpha[0] = al.x;
          alpha[1] = al.y;
          __syncwarp();
          if (lane == 0)
            mbar_arrive_peer(peer_addr(p_empty + 2 * slot + wg, rk.last));
        }
        scale_rows<C>(acc, alpha);
        wgmma_fence();
        gemm_ax_wide<C>(acc, pa, sm + lay.v + slot * L::kKV, 64, 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < NS; ++a) reg_fence(acc[a]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + slot);
    }
  }

  if (rk.r == rk.last) {   // 1 / l to the slice owners; the logsumexp
    float inv[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
      l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
      inv[a] = l[a] == 0.f ? 1.f : 1.f / l[a];   // K1's guard
    }
    for (int dstr = 0; dstr < rk.n_o; ++dstr)
      st_async16(peer_addr(sm + lay.fin + wg * L::kFinWg + wt * 16, dstr),
                 peer_addr(fin_full + wg, dstr),
                 make_float4(inv[0], inv[1], 0.f, 0.f));
    if (lse != nullptr && rk.grp == 0 && lane % 4 == 0) {
      float* out = lse + (int64_t(b) * H + h) * S + qw0 + row0;
      out[0] = kLn2 * m2[0] + logf(l[0]);
      out[8] = kLn2 * m2[1] + logf(l[1]);
    }
  }
  if (rk.has_o()) {
    if (wt == 0) mbar_expect(fin_full + wg, L::kFinWg);
    mbar_wait_cluster(fin_full + wg, 0);
    const float4 f = reinterpret_cast<const float4*>(
        sm + lay.fin + wg * L::kFinWg)[wt];
    const float inv[2] = {f.x, f.y};
    scale_rows<C>(acc, inv);
    const int64_t D = int64_t(nc) * C, rs = int64_t(H) * D;
    store_tile<C>(o + ((int64_t(b) * S + qw0) * H + h) * D + rk.sl * C, rs,
                  acc, row0, lane);
  }
  cluster_sync();   // no block leaves while a peer may still reach it
}

SmemLimit& tc_dslice_limit() {
  static SmemLimit limit{
      reinterpret_cast<const void*>(&flash_fwd_tc_dslice<kChunk>),
      max_slice_smem<TcSliceSmem>(), true};
  return limit;
}

cudaError_t launch_tc_dslice(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int S, int H, int D,
                             const int64_t* qs, const int64_t* ks,
                             const int64_t* vs, float scale,
                             cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, S, H, D, qs, 128)) != cudaSuccess ||
      (err = make_map(&tk, k, B, S, H, D, ks, 64)) != cudaSuccess ||
      (err = make_map(&tv, v, B, S, H, D, vs, 64)) != cudaSuccess)
    return err;
  if ((err = tc_dslice_limit().apply()) != cudaSuccess) return err;
  // launch_tc's groups of (batch, head) pairs whose K and V fit about 32
  // MB of L2.
  const int64_t kv_bytes = int64_t(4) * S * D;
  const int group = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(B * H, (int64_t(32) << 20) /
                                                         kv_bytes)));
  const SliceGeom geo(D / kChunk);
  const dim3 grid(B * H * (S / 128) * geo.g * geo.n);
  err = launch_clusters(flash_fwd_tc_dslice<kChunk>, geo.n, grid,
                        kTcSliceThreads, TcSliceSmem(geo.m).bytes, stream, tq,
                        tk, tv, static_cast<bf16*>(o), lse, S, H, geo.nc, group,
                        scale * kLog2e);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The cluster shape of a D-slice launch and how many such clusters the
// card holds at once (cudaOccupancyMaxActiveClusters).
cudaError_t dslice_info(int dtype, int D, int* out) {
  const SliceGeom geo(D / kChunk);
  const bool f32 = dtype == 0;
  SmemLimit& limit = f32 ? f32_dslice_limit() : tc_dslice_limit();
  cudaError_t err = limit.apply();
  if (err != cudaSuccess) return err;
  const int smem = f32 ? F32SliceSmem(geo.m).bytes
                       : TcSliceSmem(geo.m).bytes;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, geo.n, dim3(geo.n * 132),
                     f32 ? kF32SliceThreads : kTcSliceThreads, smem, nullptr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, limit.kernel, &cfg);
  out[0] = geo.n;
  out[1] = geo.g;
  out[2] = geo.m;
  out[3] = smem;
  out[4] = active;
  return err;
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

// The cluster shape of the D-slice kernel of `dtype` at head dim D (> 256,
// a multiple of 128) and how many of its clusters the card runs at once:
// out[0..4] = blocks a cluster, clusters a row block, chunks of D a block,
// dynamic shared memory a block in bytes, cudaOccupancyMaxActiveClusters.
// Returns the cudaError_t of the query.
int flash_attn_fwd_dslice_info(int dtype, int D, int* out) {
  if (D <= 256 || D % kChunk != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dslice_info(dtype, D, out));
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
