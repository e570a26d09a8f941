// Causal flash-attention backward for Hopper (sm_90a): two kernels, dK/dV
// and dQ, each in two designs, one per input type, and in D-slice designs
// for heads wider than 256.
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
// - D 256 (flash_bwd_dkv_tc_wide, flash_bwd_dq_tc_wide): the design above
//   does not fit. Its shared memory would be 258 KB (two 128-row resident
//   tiles of 64 KB, two stages of 65 KB), over the 227 KB a block may
//   have, and dK and dV of 64 keys at D 256 are 2 x 64 x 256 floats a
//   warpgroup, 256 registers a thread. So a block owns 64 rows (keys or
//   queries), all tiles are 64 rows (resident pair 64 KB, two stages of
//   64 KB, 217 KB in all), and the two warpgroups split the work:
//   dK/dV: warpgroup 0 computes S^T = K Q^T and p^T, hands p^T (float32,
//   in the accumulator layout) to warpgroup 1 through shared memory and
//   accumulates dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, ds^T
//   from p^T, and accumulates dK += dS^T Q. Each holds one 64 x 256 sum
//   (128 registers a thread). dQ: warpgroup 0 computes S and p and hands
//   p over; warpgroup 1 computes dP (two chains, as above), ds, and hands
//   ds's bf16 A fragments back; each accumulates half of dQ's columns
//   (dQ[:, 128 wg ..] += dS K[:, 128 wg ..]); the sums run as m64n128k16
//   products over pairs of slabs. Named barriers (bar.arrive
//   by the writer, bar.sync by the reader) order each hand-over and the
//   buffer's reuse. Rounding points and sum orders are those of D 64/128:
//   p and ds rounded to bf16 before their products, every sum over keys
//   (queries) in tile order; dP (and dP^T in dK/dV) is summed as chains of
//   four k-steps added in float32, the length of D 128's two chains in dQ
//   (a longer chain errs more than float32 FMA; see gemm_abt_chained).
// float32: flash_bwd_dkv_f32 and flash_bwd_dq_f32, on the CUDA cores.
// - Why not the tensor cores: they take float32 only as TF32 (10 mantissa
//   bits); 3xTF32 (hi/lo splits, three mma.sync passes) keeps products
//   within 1.6-3.0x of float32 FMA's error, but the float32 gate (1e-4,
//   1e-4 against the plain version) sits at float32's own noise where q
//   and k are scaled by 4: |q.k| reaches hundreds, exp() turns its
//   rounding into p's, and only a kernel that sums q.k and dO.v in the
//   plain version's order (sequential FMAs over d, as cuBLAS's float32
//   GEMM does) passes there. tools/tf32x3_products.py and PERF.md have
//   the numbers.
// - So every sum runs in that order: S and dP by sequential FMAs over d,
//   dV, dK and dQ by sequential FMAs over the queries (keys) in order,
//   tile after tile. Any block shape that keeps it gives the same bits;
//   the design below is about the structure around the sums.
// - A block of 128 threads per (head, batch, 32-row tile): 32 keys (dK/dV)
//   or 32 queries (dQ) resident, the other side's 32-row tiles streamed
//   through a two-stage cp.async ring (with lse and di in dK/dV), so tile
//   i + 1 lands while tile i's products run. About 111 KB of shared memory
//   at D 128: two blocks share an SM. At D 256, 205 KB: one block an SM,
//   and dK/dV's sums are 128 floats a thread. 32-row blocks halve the heaviest
//   block's work (the causal grid's critical path) against 64-row ones.
// - Blocks are issued heaviest first (the first k tile in dK/dV, the last
//   q tile in dQ) across every (batch, head) pair, in groups of pairs whose
//   streamed pair of tensors fits about 32 MB of L2.
// - Per tile, two warps compute S (S^T in dK/dV) and two dP (dP^T), each
//   thread a 4 x 4 register tile of one product (2 FMAs per shared-memory
//   word, the K or Q rows broadcast within a warp), and write the exponent
//   s scale - lse (-inf where masked) or dp to shared memory; then all
//   four warps turn 8 elements each into p and ds in place, so neither
//   half waits on the other's exp or ds work; then the first two warps
//   accumulate dV (8 keys x D / 16 columns a thread: 4 FMAs per word at D
//   128) and the other two dK, or all four dQ (4 queries x D / 16 columns
//   a thread). The products are bound by shared memory (a 128-bit load
//   costs four wavefronts): designs with more loads per FMA (256-thread
//   blocks; S and dP in the same thread) measured slower.
// - Each block owns the rows it writes: no atomics, bitwise-equal launches.
//
// Heads wider than 256 (D 384, 512, 1024: any multiple of 128):
// flash_bwd_{dkv,dq}_{tc,f32}_dslice. Neither design above fits: the wide
// bf16 kernels need 322,600 and 420,904 B of shared memory at D 384 and
// 512, the float32 ones (F32Smem) 307,840 and 406,144 B, against 232,448,
// and their dK/dV sums 192 and 256 floats a thread; D also has to be a
// template constant. So a block owns one 128-column slice of its rows'
// outputs (D / 128 blocks a row tile) and D is a runtime count of
// 128-column chunks: per streamed tile, S (S^T) and dP (dP^T) are formed
// chunk by chunk from all four tensors' chunks (two stages, chunk t + 1's
// copies under chunk t's products); after the last chunk p and ds as
// above, and only the sums use the slice: dV_slice += P^T dO_slice, dK_slice
// += dS^T Q_slice, dQ_slice += dS K_slice. Every slice's block recomputes
// S and dP whole: D / 128 times their work (4x at D 512).
// - bf16: 64-row blocks of two warpgroups that split the work as the D-256
//   kernels do (warpgroup 0 S and p, warpgroup 1 dP and ds, handed over by
//   named barriers); every tile is 64 rows in 64-column TMA boxes. S is
//   one chain over D; dP is summed as chains of four k-steps (64 columns)
//   added in float32 in order, as gemm_abt_chained does. dK/dV: 189,984 B
//   of shared memory, 215 registers; dQ: the same layout, 190 registers
//   (each warpgroup 64 of the slice's columns); no spills (ptxas -v,
//   sm_90a).
// - float32: the 32-row blocks of 128 threads above, S and dP by
//   sequential FMAs over d = 0 .. D - 1 in order, chunk after chunk into
//   the same sums; dV, dK and dQ over the queries (keys) in order. 178,432
//   B of shared memory; dK/dV 238 registers, dQ 168; no spills.

#include <math.h>

#include <algorithm>

#include "hopper.cuh"  // TMA, mbarriers, wgmma, tensor maps, cp.async

namespace {

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

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels.

constexpr int kF32Rows = 32;         // rows of a block and of a streamed tile
constexpr int kF32Threads = 128;     // four warps, two per product
constexpr int kLdP = kF32Rows + 4;   // row stride of a 32 x 32 p or ds tile
// A 32 x 32 product over the kF32Threads / 2 threads of one half: thread
// (ty, tx) of a kPy x 8 grid owns rows ty + kPy i (i < kPi) and columns
// tx + 8 j (j < 4).
constexpr int kPy = kF32Threads / 2 / 8;
constexpr int kPi = kF32Rows / kPy;
// Sums over a 32 x D output: 16 threads share a row's D / 16-column groups.
constexpr int kSumRows = kF32Rows * 16 / (kF32Threads / 2);   // one half
constexpr int kSumRowsAll = kF32Rows * 16 / kF32Threads;      // all threads

// Shared memory, in floats: the two resident tiles (K, V or Q, dO), two
// stages of the two streamed tiles (Q, dO or K, V) with 32 floats each of
// lse and di (read by dK/dV only), the 32 x 32 p and ds tiles, and dQ's
// 32 di. Rows are D + 4 floats apart (16-byte aligned, and the eight rows
// a quarter warp reads at one column start on distinct banks). About 111
// KB at D 128, so two blocks share an SM.
template <int D>
struct F32Smem {
  static constexpr int kLd = D + 4;
  static constexpr int kTile = kF32Rows * kLd;
  static constexpr int kStage = 2 * kTile + 2 * kF32Rows;
  static constexpr int kStages = 2 * kTile;            // stage 0
  static constexpr int kP = kStages + 2 * kStage;      // p, then ds
  static constexpr int kBytes = (kP + 2 * kF32Rows * kLdP + kF32Rows) * 4;
};

// Start copying 32 rows of D floats (row stride `rs` elements) into a tile.
template <int D>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t rs, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = tid; i < kF32Rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    cp_async16(dst + r * F32Smem<D>::kLd + c, src + r * rs + c);
  }
}

// Block order: the (batch, head) pairs in groups of `group`, and within a
// group the heaviest tile of every pair first. Block `blk` of `n_blk`: its
// pair, and its tile's rank (0 = heaviest) among a pair's n_t.
__device__ __forceinline__ void f32_block(int blk, int n_blk, int n_t,
                                          int group, int& bh, int& rank) {
  const int n_bh = n_blk / n_t;
  const int g0 = blk / (group * n_t) * group;   // its first pair
  const int g_size = min(group, n_bh - g0);
  const int r = blk - g0 * n_t;
  bh = g0 + r % g_size;
  rank = r / g_size;
}

// out[i][j] = sum over d in order of A[ty + kPy i][d] B[tx + 8 j][d], two
// 32-row tiles of row stride D + 4 (out += that sum unless `zero`).
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          int ty, int tx, float out[kPi][4],
                                          bool zero = true) {
  constexpr int kLd = F32Smem<D>::kLd;
  if (zero) {
#pragma unroll
    for (int i = 0; i < kPi; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[kPi], b[4];
#pragma unroll
    for (int i = 0; i < kPi; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + kPy * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kPi; ++i)
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

// acc[i][jj*4 + e] += sum over r < 32 in order of P[row0 + step i][r]
// X[r][jj*64 + cx*4 + e]: P a 32 x 32 tile (row stride kLdP), X a 32-row
// tile of row stride D + 4; RT rows, D / 16 columns a thread.
template <int D, int RT>
__device__ __forceinline__ void tile_accumulate(const float* P,
                                                const float* X, int row0,
                                                int step, int cx,
                                                float acc[RT][D / 16]) {
  constexpr int kLd = F32Smem<D>::kLd;
#pragma unroll 2
  for (int r = 0; r < kF32Rows; r += 4) {
    float4 pa[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      pa[i] = *reinterpret_cast<const float4*>(P + (row0 + step * i) * kLdP +
                                               r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 xb = *reinterpret_cast<const float4*>(
            X + (r + rr) * kLd + jj * 64 + cx * 4);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
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

// p = exp(x) and ds = p (dp - di) scale in place over a 32 x 32 tile: x
// in P (-inf where masked, so p is 0), dp in dS; di by column (dK/dV's
// transposed tiles) or, when kDiByRow, by row. Thread t takes row t / 4,
// columns 8 (t % 4) .. + 7, as two float4 (a quarter warp's eight cover
// all 32 banks).
template <bool kDiByRow>
__device__ __forceinline__ void p_and_ds(float* P, float* dS,
                                         const float* di, float scale,
                                         int tid) {
  const int row = tid / 4, col0 = 8 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4* pp = reinterpret_cast<float4*>(P + row * kLdP + col0 + 4 * h);
    float4* dd = reinterpret_cast<float4*>(dS + row * kLdP + col0 + 4 * h);
    const float4 x = *pp, dp = *dd;
    const float4 d = kDiByRow
        ? make_float4(di[row], di[row], di[row], di[row])
        : *reinterpret_cast<const float4*>(di + col0 + 4 * h);
    float4 p, ds;
    p.x = expf(x.x);
    p.y = expf(x.y);
    p.z = expf(x.z);
    p.w = expf(x.w);
    ds.x = p.x * (dp.x - d.x) * scale;
    ds.y = p.y * (dp.y - d.y) * scale;
    ds.z = p.z * (dp.z - d.z) * scale;
    ds.w = p.w * (dp.w - d.w) * scale;
    *pp = p;
    *dd = ds;
  }
}

// Rows row0 + step i of a contiguous [B, S, H, ld] float32 output, columns
// jj*64 + cx*4 .. +3.
template <int D, int RT>
__device__ __forceinline__ void store_rows(float* out, int b, int h, int S,
                                           int H, int row0, int step, int cx,
                                           const float acc[RT][D / 16],
                                           int64_t ld = D) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float* row = out + ((int64_t(b) * S + row0 + step * i) * H + h) * ld;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      *reinterpret_cast<float4*>(row + jj * 64 + cx * 4) =
          make_float4(acc[i][jj * 4 + 0], acc[i][jj * 4 + 1],
                      acc[i][jj * 4 + 2], acc[i][jj * 4 + 3]);
  }
}

// dK/dV. Block: 32 keys k0.. of one (batch, head), the first k tile (the
// most q tiles) first; the 32-query tiles from the diagonal down stream
// in. Warps 0-1 compute S^T and then dV, warps 2-3 dP^T and then dK.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_bwd_dkv_f32(const Args a, int group) {
  using L = F32Smem<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Ks = sm;
  float* Vs = sm + L::kTile;
  float* Pt = sm + L::kP;             // the exponents, then p^T: [key][query]
  float* dSt = Pt + kF32Rows * kLdP;  // dP^T, then ds^T

  const int S = a.S, H = a.H;
  int bh, rank;
  f32_block(blockIdx.x, gridDim.x, S / kF32Rows, group, bh, rank);
  const int h = bh % H, b = bh / H;
  const int k0 = kF32Rows * rank;
  const int nq = S / kF32Rows - rank;   // q tiles q0 = k0 + 32 i
  const int tid = threadIdx.x;
  const bool first = tid < kF32Threads / 2;   // S^T and dV; else dP^T, dK
  const int th = tid % (kF32Threads / 2);
  const int ty = th / 8, tx = th % 8;     // products: keys ty + kPy i
  const int ky = th / 16, cx = th % 16;   // sums: keys ky + kSumStep i
  constexpr int kSumStep = kF32Rows / kSumRows;

  const float* q = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const int64_t dos = int64_t(H) * D;
  const float* dout = static_cast<const float*>(a.dout) +
                      (int64_t(b) * S * H + h) * D;
  const float* lse = a.lse + (int64_t(b) * H + h) * S;
  const float* di = a.di + (int64_t(b) * H + h) * S;
  auto issue = [&](int i) {   // q tile i into stage i % 2
    float* st = sm + L::kStages + (i % 2) * L::kStage;
    const int q0 = k0 + kF32Rows * i;
    copy_tile<D>(st, q + q0 * a.qss, a.qss, tid);
    copy_tile<D>(st + L::kTile, dout + q0 * dos, dos, tid);
    if (tid < 16) {   // lse (chunks 0..7), then di
      const float* src = tid < 8 ? lse + q0 + 4 * tid : di + q0 + 4 * (tid - 8);
      cp_async16(st + 2 * L::kTile + 4 * tid, src);
    }
  };
  copy_tile<D>(Ks, static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh +
                       k0 * a.kss, a.kss, tid);
  copy_tile<D>(Vs, static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh +
                       k0 * a.vss, a.vss, tid);
  issue(0);
  cp_async_commit();

  float acc[kSumRows][D / 16];   // dV (first warps) or dK
#pragma unroll
  for (int i = 0; i < kSumRows; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  const float scale = a.scale;

  // 32 rows on both sides, so q tile 0 is the diagonal one.
  for (int i = 0; i < nq; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // tile i has landed; every warp is done with i - 1
    if (i + 1 < nq) issue(i + 1);
    cp_async_commit();
    const float* Qs = sm + L::kStages + (i % 2) * L::kStage;
    const float* dOs = Qs + L::kTile;
    const float* lse_t = Qs + 2 * L::kTile;
    const float* di_t = lse_t + kF32Rows;

    // S^T (first warps: the exponent s scale - lse, -inf where masked,
    // into Pt) or dP^T (into dSt), [key][query]; then every thread turns
    // 8 of them into p and ds in place.
    float s[kPi][4];
    tile_dots<D>(first ? Ks : Vs, first ? Qs : dOs, ty, tx, s);
#pragma unroll
    for (int ii = 0; ii < kPi; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = ty + kPy * ii, qry = tx + 8 * j;
        if (first) {
          Pt[key * kLdP + qry] = (i == 0 && key > qry)
                                     ? -INFINITY
                                     : s[ii][j] * scale - lse_t[qry];
        } else {
          dSt[key * kLdP + qry] = s[ii][j];
        }
      }
    __syncthreads();   // the exponents and dP^T are complete
    p_and_ds<false>(Pt, dSt, di_t, scale, tid);
    __syncthreads();   // p^T and ds^T are complete
    // dV += P^T dO (first warps), dK += dS^T Q
    tile_accumulate<D, kSumRows>(first ? Pt : dSt, first ? dOs : Qs, ky,
                                 kSumStep, cx, acc);
  }

  store_rows<D, kSumRows>(static_cast<float*>(first ? a.out1 : a.out0), b, h,
                          S, H, k0 + ky, kSumStep, cx, acc);
}

// dQ. Block: 32 queries q0.. of one (batch, head), the last q tile (the
// most k tiles) first; the 32-key tiles up to the diagonal stream in.
// Warps 0-1 compute S, warps 2-3 dP, then all four dQ.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_bwd_dq_f32(const Args a, int group) {
  using L = F32Smem<D>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qs = sm;
  float* dOs = sm + L::kTile;
  float* Ps = sm + L::kP;             // the exponents, then p: [query][key]
  float* dSs = Ps + kF32Rows * kLdP;  // dP, then ds
  float* di_s = dSs + kF32Rows * kLdP;   // di of the block's queries

  const int S = a.S, H = a.H, n_t = S / kF32Rows;
  int bh, rank;
  f32_block(blockIdx.x, gridDim.x, n_t, group, bh, rank);
  const int h = bh % H, b = bh / H;
  const int qt = n_t - 1 - rank;
  const int q0 = kF32Rows * qt;
  const int tid = threadIdx.x;
  const bool first = tid < kF32Threads / 2;   // S; else dP
  const int th = tid % (kF32Threads / 2);
  const int ty = th / 8, tx = th % 8;       // products: queries ty + kPy i
  const int qy = tid / 16, cx = tid % 16;   // sums: queries qy + kSumStep i
  constexpr int kSumStep = kF32Rows / kSumRowsAll;

  const float* k = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* v = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  auto issue = [&](int j) {   // k tile j into stage j % 2
    float* st = sm + L::kStages + (j % 2) * L::kStage;
    copy_tile<D>(st, k + kF32Rows * j * a.kss, a.kss, tid);
    copy_tile<D>(st + L::kTile, v + kF32Rows * j * a.vss, a.vss, tid);
  };
  const int64_t dos = int64_t(H) * D;
  copy_tile<D>(Qs, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh +
                       q0 * a.qss, a.qss, tid);
  copy_tile<D>(dOs, static_cast<const float*>(a.dout) +
                        (int64_t(b) * S * H + h) * D + q0 * dos, dos, tid);
  issue(0);
  cp_async_commit();

  // lse of this thread's product rows (first warps); di of the block's.
  const float* lse = a.lse + (int64_t(b) * H + h) * S + q0;
  float rv[kPi];
#pragma unroll
  for (int ii = 0; ii < kPi; ++ii) rv[ii] = lse[ty + kPy * ii];
  if (tid < kF32Rows) di_s[tid] = a.di[(int64_t(b) * H + h) * S + q0 + tid];
  float acc[kSumRowsAll][D / 16];   // dQ
#pragma unroll
  for (int i = 0; i < kSumRowsAll; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  const float scale = a.scale;

  for (int j = 0; j <= qt; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // tile j has landed; every warp is done with j - 1
    if (j < qt) issue(j + 1);
    cp_async_commit();
    const float* Ks = sm + L::kStages + (j % 2) * L::kStage;
    const float* Vs = Ks + L::kTile;

    // S (first warps: the exponent, as in dK/dV, into Ps) or dP (into
    // dSs), [query][key]; then every thread turns 8 of them into p and
    // ds.
    float s[kPi][4];
    tile_dots<D>(first ? Qs : dOs, first ? Ks : Vs, ty, tx, s);
#pragma unroll
    for (int ii = 0; ii < kPi; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qry = ty + kPy * ii, key = tx + 8 * jj;
        if (first) {
          Ps[qry * kLdP + key] = (j == qt && key > qry)
                                     ? -INFINITY
                                     : s[ii][jj] * scale - rv[ii];
        } else {
          dSs[qry * kLdP + key] = s[ii][jj];
        }
      }
    __syncthreads();   // the exponents and dP are complete
    p_and_ds<true>(Ps, dSs, di_s, scale, tid);
    __syncthreads();   // ds is complete
    tile_accumulate<D, kSumRowsAll>(dSs, Ks, qy, kSumStep, cx, acc);  // dS K
  }

  store_rows<D, kSumRowsAll>(static_cast<float*>(a.out0), b, h, S, H, q0 + qy,
                             kSumStep, cx, acc);
}

// `dkv`: the dK/dV kernel; else the dQ kernel.
template <int D>
cudaError_t launch_f32(bool dkv, const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem = F32Smem<D>::kBytes;
  static SmemLimit dkv_limit{
      reinterpret_cast<const void*>(&flash_bwd_dkv_f32<D>), kSmem};
  static SmemLimit dq_limit{
      reinterpret_cast<const void*>(&flash_bwd_dq_f32<D>), kSmem};
  const cudaError_t err = (dkv ? dkv_limit : dq_limit).apply();
  if (err != cudaSuccess) return err;
  // Heaviest first across all pairs balances the causal grid; groups of
  // pairs whose streamed tensors (Q and dO, or K and V) fill about 32 MB
  // of the 50 MB L2 keep them there while the group's blocks read them.
  const int64_t pair_bytes = int64_t(2) * a.S * D * 4;
  const int group = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(int64_t(B) * a.H,
                           (int64_t(32) << 20) / pair_bytes)));
  const dim3 grid(B * a.H * (a.S / kF32Rows));
  if (dkv) {
    flash_bwd_dkv_f32<D><<<grid, kF32Threads, kSmem, stream>>>(a, group);
  } else {
    flash_bwd_dq_f32<D><<<grid, kF32Threads, kSmem, stream>>>(a, group);
  }
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
  int nc;      // D / kChunk (the D-slice kernels)
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


// ---------------------------------------------------------------------------
// bf16 at D 256: the wide-head kernels (see the header).

// Shared memory of both wide kernels: a resident pair of 64-row tiles (K
// and V, or Q and dO), two stages of a pair of 64-row tiles (Q and dO, or K
// and V), the hand-over buffers (p: 64 x 64 float32; dS's A fragments:
// 64 x 64 bf16, dQ only), each stage's 64 floats of lse and di (dK/dV
// only), then the mbarriers. A tile is D / 64 slabs of [64][64] bf16,
// 1024-byte aligned for the swizzle.
template <int D>
struct WideSmem {
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kP = 2 * kTile + 2 * kStage;
  static constexpr int kDs = kP + 64 * 64 * 4;
  static constexpr int kLse = kDs + 64 * 64 * 2;   // stage s at + 512 s
  static constexpr int kBars = kLse + 2 * 2 * 64 * 4;
  static constexpr int kBytes = 1024 + kBars + 5 * 8;   // + alignment slack
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Named barriers between the two warpgroups (0 is __syncthreads): p handed
// over, p's buffer free again (dK/dV), dS handed over (dQ).
constexpr int kBarPReady = 1, kBarPFree = 2, kBarDsReady = 3;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(kTcThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(kTcThreads)
               : "memory");
}

// Chains C.. of acc = A B^T (two 64-row K-major tiles, C >= 2), one at a
// time in `part`, each added to acc in order.
template <int D, int C>
__device__ __forceinline__ void chains_from(float (&acc)[32],
                                            float (&part)[32],
                                            const uint8_t* a,
                                            const uint8_t* bt) {
  wgmma_fence();
  gemm_abt<D, 4 * C, 4 * C + 4>(part, a, 64, 0, bt, 64, 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
  if constexpr (4 * C + 4 < D / 16) chains_from<D, C + 1>(acc, part, a, bt);
}

// acc = A B^T over D (two 64-row K-major tiles: dP = dO V^T or dP^T = V
// dO^T) as chains of four k-steps (64 columns of D) added in float32 in
// order, ((c0 + c1) + c2) + c3 at D 256. Four k-steps is the chain of D
// 128's two: its sum errs as little as float32 FMA's, where a chain of 8
// or 16 errs more (tools/wgmma_products.py), and the peaked softmax's dQ
// and dK, where dp - di cancels, read that error against the plain
// version. `part` holds one chain.
template <int D>
__device__ __forceinline__ void gemm_abt_chained(float (&acc)[32],
                                                 float (&part)[32],
                                                 const uint8_t* a,
                                                 const uint8_t* bt) {
  static_assert(D % 128 == 0, "at least two chains of 64 columns");
  wgmma_fence();
  gemm_abt<D, 0, 4>(acc, a, 64, 0, bt, 64, 0);
  gemm_abt<D, 4, 8>(part, a, 64, 0, bt, 64, 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
  if constexpr (D > 128) chains_from<D, 2>(acc, part, a, bt);
}

// dK/dV at D 256. Block (head, batch, 64-key tile), the most q tiles
// first; both warpgroups own keys k0 .. k0 + 63. Warpgroup 0: S^T, p^T,
// dV; warpgroup 1: dP^T, ds^T, dK.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_wide(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const TcArgs a) {
  using L = WideSmem<D>;
  constexpr int NS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Ks = sm;
  uint8_t* Vs = Ks + L::kTile;
  uint8_t* stages = Vs + L::kTile;
  float* px = reinterpret_cast<float*>(sm + L::kP);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = kv_full + 3;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, t = tid % 128, warp = t / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int k0 = 64 * blockIdx.z;
  const int nq = (S - k0) / 64;   // q tiles q0 = k0 + 64 i; 0 is diagonal
  const float* lse = a.lse + (int64_t(b) * H + h) * S;
  const float* di = a.di + (int64_t(b) * H + h) * S;

  auto issue = [&](int i) {   // q tile i into stage i % 2 (thread 0)
    uint8_t* st = stages + (i % 2) * L::kStage;
    uint8_t* ld = sm + L::kLse + (i % 2) * 512;
    uint64_t* bar = full + i % 2;
    const int q0 = k0 + 64 * i;
    mbar_expect(bar, L::kStage + 2 * 64 * 4);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(st + s * 64 * 128, &tq, bar, s * kSlab, h, q0, b);
      tma_load(st + L::kTile + s * 64 * 128, &tdo, bar, s * kSlab, h, q0,
               b);
    }
    bulk_load(ld, lse + q0, 64 * 4, bar);
    bulk_load(ld + 64 * 4, di + q0, 64 * 4, bar);
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
    mbar_expect(kv_full, 2 * L::kTile);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(Ks + s * 64 * 128, &tk, kv_full, s * kSlab, h, k0, b);
      tma_load(Vs + s * 64 * 128, &tv, kv_full, s * kSlab, h, k0, b);
    }
    issue(0);
    if (nq > 1) issue(1);
  }
  __syncwarp();

  // acc: dV (warpgroup 0) or dK; x: S^T or dP^T; x2: a chain of dP^T
  float acc[NS][32], x[32], x2[32];
  zero<D>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = x2[i] = 0.f;
  const int row0 = 16 * warp + lane / 4;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  // Warpgroup 0 accumulates dV += P^T dO, warpgroup 1 dK += dS^T Q.
  const int sum_off = wg == 0 ? L::kTile : 0;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < nq; ++i) {
    const int parity = (i / 2) % 2;
    const uint8_t* st = stages + (i % 2) * L::kStage;
    const float* lse_t =
        reinterpret_cast<const float*>(sm + L::kLse + (i % 2) * 512);
    const float* di_t = lse_t + 64;
    mbar_wait(full + i % 2, parity);
    uint32_t frag[4][4];
    if (wg == 0) {
      wgmma_fence();
      gemm_abt<D>(x, Ks, 64, 0, st, 64, 0);                      // K Q^T
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(x);
      tile_p<true>(x, i == 0, row0, lane,
                   [&](int e) { return lse_t[acc_col(e, lane)] * kLog2e; },
                   scale_log2);
      if (i > 0) bar_sync(kBarPFree);   // warpgroup 1 has read p of i - 1
#pragma unroll
      for (int e = 0; e < 32; ++e) px[e * 128 + t] = x[e];
      bar_arrive(kBarPReady);
    } else {
      gemm_abt_chained<D>(x, x2, Vs, st + L::kTile);             // V dO^T
      bar_sync(kBarPReady);
      // ds^T = p^T (dP^T - di) scale, p^T as warpgroup 0's thread t made it
#pragma unroll
      for (int e = 0; e < 32; ++e)
        x[e] = px[e * 128 + t] * (x[e] - di_t[acc_col(e, lane)]) * scale;
      if (i + 1 < nq) bar_arrive(kBarPFree);
    }
    to_frags(x, frag);
    wgmma_fence();
    gemm_ax_wide<D>(acc, frag, st + sum_off, 64, 0);   // dV or dK
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NS; ++s) reg_fence(acc[s]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % 2);
    if (tid == 0 && i + 2 < nq) {
      mbar_wait(empty + i % 2, parity);
      issue(i + 2);
    }
    __syncwarp();
  }

  const int64_t rs = int64_t(H) * D;
  const int64_t base = ((int64_t(b) * S + k0) * H + h) * D;
  store_tile<D>((wg == 0 ? a.out1 : a.out0) + base, rs, acc, row0, lane);
}

// dQ at D 256. Block (head, batch, 64-query tile), the last q tile (the
// most k tiles) first; both warpgroups own queries q0 .. q0 + 63.
// Warpgroup 0: S and p; warpgroup 1: dP and ds; each then half of dQ's
// columns.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_wide(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const TcArgs a) {
  using L = WideSmem<D>;
  constexpr int NS = D / 64, HALF = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qs = sm;
  uint8_t* dOs = Qs + L::kTile;
  uint8_t* stages = dOs + L::kTile;
  float* px = reinterpret_cast<float*>(sm + L::kP);
  uint32_t* dsx = reinterpret_cast<uint32_t*>(sm + L::kDs);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = qd_full + 3;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, t = tid % 128, warp = t / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int q0 = 64 * (gridDim.z - 1 - blockIdx.z);
  const int nk = q0 / 64 + 1;   // k tiles k0 = 64 j up to the diagonal

  auto issue = [&](int j) {   // k tile j into stage j % 2 (thread 0)
    uint8_t* st = stages + (j % 2) * L::kStage;
    uint64_t* bar = full + j % 2;
    mbar_expect(bar, L::kStage);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(st + s * 64 * 128, &tk, bar, s * kSlab, h, 64 * j, b);
      tma_load(st + L::kTile + s * 64 * 128, &tv, bar, s * kSlab, h,
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
    mbar_expect(qd_full, 2 * L::kTile);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tma_load(Qs + s * 64 * 128, &tq, qd_full, s * kSlab, h, q0, b);
      tma_load(dOs + s * 64 * 128, &tdo, qd_full, s * kSlab, h, q0, b);
    }
    issue(0);
    if (nk > 1) issue(1);
  }
  __syncwarp();

  const int row0 = 16 * warp + lane / 4;
  const float* lse = a.lse + (int64_t(b) * H + h) * S + q0;
  const float* di = a.di + (int64_t(b) * H + h) * S + q0;
  const float lse2[2] = {lse[row0] * kLog2e, lse[row0 + 8] * kLog2e};
  const float dir[2] = {di[row0], di[row0 + 8]};
  float acc[HALF / 64][32], x[32], x2[32];   // acc: dQ[:, HALF wg ..]
  zero<HALF>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = x2[i] = 0.f;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  mbar_wait(qd_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int k0 = 64 * j;
    const int parity = (j / 2) % 2;
    const uint8_t* st = stages + (j % 2) * L::kStage;
    mbar_wait(full + j % 2, parity);
    uint32_t frag[4][4];
    if (wg == 0) {
      wgmma_fence();
      gemm_abt<D>(x, Qs, 64, 0, st, 64, 0);                       // Q K^T
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(x);
      tile_p<false>(x, k0 == q0, row0, lane,
                    [&](int e) { return lse2[(e / 2) % 2]; }, scale_log2);
#pragma unroll
      for (int e = 0; e < 32; ++e) px[e * 128 + t] = x[e];
      bar_arrive(kBarPReady);
      bar_sync(kBarDsReady);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) frag[jj][r] = dsx[(4 * jj + r) * 128 + t];
    } else {
      gemm_abt_chained<D>(x, x2, dOs, st + L::kTile);            // dO V^T
      bar_sync(kBarPReady);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        x[e] = px[e * 128 + t] * (x[e] - dir[(e / 2) % 2]) * scale;
      to_frags(x, frag);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsx[(4 * jj + r) * 128 + t] = frag[jj][r];
      bar_arrive(kBarDsReady);
    }
    wgmma_fence();
    gemm_ax_wide<HALF>(acc, frag, st + wg * (HALF / 64) * 64 * 128, 64,
                       0);                                         // dS K
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < HALF / 64; ++s) reg_fence(acc[s]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % 2);
    if (tid == 0 && j + 2 < nk) {
      mbar_wait(empty + j % 2, parity);
      issue(j + 2);
    }
    __syncwarp();
  }

  const int64_t rs = int64_t(H) * D;
  store_tile<HALF>(a.out0 + ((int64_t(b) * S + q0) * H + h) * D + HALF * wg,
                   rs, acc, row0, lane);
}

// `dkv`: the dK/dV kernel (K, V resident in 128-row boxes, Q, dO streamed
// in 64-row boxes); else the dQ kernel (the other way round). At D 256 the
// wide kernels, all boxes 64 rows.
template <int D>
cudaError_t launch_tc(bool dkv, const Args& a, int B, cudaStream_t stream) {
  constexpr bool kWide = D > 128;
  const int S = a.S, H = a.H;
  const int qrows = dkv || kWide ? 64 : 128;
  const int krows = dkv && !kWide ? 128 : 64;
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
  if constexpr (kWide) {
    const auto kernel =
        dkv ? flash_bwd_dkv_tc_wide<D> : flash_bwd_dq_tc_wide<D>;
    constexpr int kSmem = WideSmem<D>::kBytes;
    static SmemLimit dkv_limit{
        reinterpret_cast<const void*>(&flash_bwd_dkv_tc_wide<D>), kSmem};
    static SmemLimit dq_limit{
        reinterpret_cast<const void*>(&flash_bwd_dq_tc_wide<D>), kSmem};
    if ((err = (dkv ? dkv_limit : dq_limit).apply()) != cudaSuccess)
      return err;
    kernel<<<dim3(H, B, S / 64), kTcThreads, kSmem, stream>>>(tq, tk, tv,
                                                               tdo, t);
  } else {
    const auto kernel = dkv ? flash_bwd_dkv_tc<D> : flash_bwd_dq_tc<D>;
    constexpr int kSmem = TcSmem<D>::kBytes;
    static SmemLimit dkv_limit{
        reinterpret_cast<const void*>(&flash_bwd_dkv_tc<D>), kSmem};
    static SmemLimit dq_limit{
        reinterpret_cast<const void*>(&flash_bwd_dq_tc<D>), kSmem};
    if ((err = (dkv ? dkv_limit : dq_limit).apply()) != cudaSuccess)
      return err;
    kernel<<<dim3(H, B, S / 128), kTcThreads, kSmem, stream>>>(tq, tk, tv,
                                                                tdo, t);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims above 256 (any multiple of 128: 384, 512, 1024): the D-slice
// kernels (see the header). D is a runtime count of C-column chunks, nc =
// D / C >= 3; a block owns output columns C sl .. C sl + C - 1 of its rows.

constexpr int kChunk = 128;   // columns of a chunk of D and of a slice

// Shared memory of the float32 D-slice kernels, in floats: two stages of
// four 32-row chunks (dK/dV: K, V, Q, dO; dQ: Q, dO, K, V), rows C + 4
// floats apart as in F32Smem<C>; the slice tiles (dK/dV: Q and dO; dQ: K);
// 32 floats each of lse and di (dK/dV: per q tile) or the block's di (dQ);
// the 32 x 32 p and ds tiles.
template <int C>
struct F32SliceSmem {
  static constexpr int kTile = F32Smem<C>::kTile;
  static constexpr int kStage = 4 * kTile;
  static constexpr int kSl = 2 * kStage;
  static constexpr int kLse = kSl + 2 * kTile;
  static constexpr int kP = kLse + 2 * kF32Rows;
  static constexpr int kBytes = (kP + 2 * kF32Rows * kLdP) * 4;
};

// dK/dV. Block (slice, 32-key tile, pair) in flash_bwd_dkv_f32's order, the
// slices of one tile adjacent. Steps t = nc i + c over q tiles i (from the
// diagonal down) and chunks c: warps 0-1 add the chunk's K_c Q_c^T to S^T,
// warps 2-3 V_c dO_c^T to dP^T, by sequential FMAs, so q.k and dO.v run
// over d = 0 .. D - 1 in order as in flash_bwd_dkv_f32. After the last
// chunk, p^T and ds^T as there, then dV_slice += P^T dO_slice (warps 0-1)
// and dK_slice += dS^T Q_slice (warps 2-3). Step t + 1's copies (with a
// tile's last chunk also its Q and dO slices, lse and di: single buffers,
// written under step t + 1 - 1 >= that tile's first step, after the last
// tile's sums while nc >= 2) run under step t.
template <int C>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkv_f32_dslice(const Args a, int nc, int group) {
  using L = F32SliceSmem<C>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qsl = sm + L::kSl;
  float* dOsl = Qsl + L::kTile;
  float* lse_t = sm + L::kLse;
  float* di_t = lse_t + kF32Rows;
  float* Pt = sm + L::kP;             // the exponents, then p^T: [key][query]
  float* dSt = Pt + kF32Rows * kLdP;  // dP^T, then ds^T

  const int S = a.S, H = a.H;
  const int64_t D = int64_t(nc) * C;
  const int sl = blockIdx.x % nc;
  int bh, rank;
  f32_block(blockIdx.x / nc, gridDim.x / nc, S / kF32Rows, group, bh, rank);
  const int h = bh % H, b = bh / H;
  const int k0 = kF32Rows * rank;
  const int nq = S / kF32Rows - rank;
  const int n_steps = nq * nc;
  const int tid = threadIdx.x;
  const bool first = tid < kF32Threads / 2;   // S^T and dV; else dP^T, dK
  const int th = tid % (kF32Threads / 2);
  const int ty = th / 8, tx = th % 8;
  const int ky = th / 16, cx = th % 16;
  constexpr int kRows = kF32Rows * 16 / (kF32Threads / 2);
  constexpr int kStep = kF32Rows / kRows;

  const float* q = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb +
                    h * a.ksh + k0 * a.kss;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb +
                    h * a.vsh + k0 * a.vss;
  const int64_t dos = int64_t(H) * D;
  const float* dout = static_cast<const float*>(a.dout) +
                      (int64_t(b) * S * H + h) * D;
  const float* lse = a.lse + (int64_t(b) * H + h) * S;
  const float* di = a.di + (int64_t(b) * H + h) * S;
  auto issue = [&](int t) {
    const int i = t / nc, c = t % nc;
    const int q0 = k0 + kF32Rows * i;
    float* st = sm + (t % 2) * L::kStage;
    copy_tile<C>(st, kp + c * C, a.kss, tid);
    copy_tile<C>(st + L::kTile, vp + c * C, a.vss, tid);
    copy_tile<C>(st + 2 * L::kTile, q + q0 * a.qss + c * C, a.qss, tid);
    copy_tile<C>(st + 3 * L::kTile, dout + q0 * dos + c * C, dos, tid);
    if (c == nc - 1) {
      copy_tile<C>(Qsl, q + q0 * a.qss + sl * C, a.qss, tid);
      copy_tile<C>(dOsl, dout + q0 * dos + sl * C, dos, tid);
      if (tid < 16) {   // lse (chunks 0..7), then di
        const float* src =
            tid < 8 ? lse + q0 + 4 * tid : di + q0 + 4 * (tid - 8);
        cp_async16(lse_t + 4 * tid, src);
      }
    }
    cp_async_commit();
  };
  issue(0);

  float acc[kRows][C / 16];   // dV (first warps) or dK, of the slice
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C / 16; ++c) acc[i][c] = 0.f;
  float s[kPi][4];
  const float scale = a.scale;

  for (int t = 0; t < n_steps; ++t) {
    const int i = t / nc, c = t % nc;
    cp_async_wait<0>();
    __syncthreads();   // step t's copies have landed; step t - 1 is done
    if (t + 1 < n_steps) issue(t + 1);
    const float* st = sm + (t % 2) * L::kStage;
    tile_dots<C>(first ? st : st + L::kTile,
                 first ? st + 2 * L::kTile : st + 3 * L::kTile, ty, tx, s,
                 c == 0);
    if (c < nc - 1) continue;
#pragma unroll
    for (int ii = 0; ii < kPi; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = ty + kPy * ii, qry = tx + 8 * j;
        if (first) {
          Pt[key * kLdP + qry] = (i == 0 && key > qry)
                                     ? -INFINITY
                                     : s[ii][j] * scale - lse_t[qry];
        } else {
          dSt[key * kLdP + qry] = s[ii][j];
        }
      }
    __syncthreads();   // the exponents and dP^T are complete
    p_and_ds<false>(Pt, dSt, di_t, scale, tid);
    __syncthreads();   // p^T and ds^T are complete
    tile_accumulate<C, kRows>(first ? Pt : dSt, first ? dOsl : Qsl, ky,
                              kStep, cx, acc);
  }

  store_rows<C, kRows>(static_cast<float*>(first ? a.out1 : a.out0) + sl * C,
                       b, h, S, H, k0 + ky, kStep, cx, acc, D);
}

// dQ. Block (slice, 32-query tile, pair) in flash_bwd_dq_f32's order.
// Steps t = nc j + c over k tiles j (up to the diagonal) and chunks c:
// warps 0-1 add Q_c K_c^T to S, warps 2-3 dO_c V_c^T to dP, in order over
// d as in flash_bwd_dq_f32; after the last chunk p and ds, then all four
// warps dQ_slice += dS K_slice.
template <int C>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32_dslice(const Args a, int nc, int group) {
  using L = F32SliceSmem<C>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Ksl = sm + L::kSl;
  float* di_s = sm + L::kLse;
  float* Ps = sm + L::kP;             // the exponents, then p: [query][key]
  float* dSs = Ps + kF32Rows * kLdP;  // dP, then ds

  const int S = a.S, H = a.H, n_t = S / kF32Rows;
  const int64_t D = int64_t(nc) * C;
  const int sl = blockIdx.x % nc;
  int bh, rank;
  f32_block(blockIdx.x / nc, gridDim.x / nc, n_t, group, bh, rank);
  const int h = bh % H, b = bh / H;
  const int qt = n_t - 1 - rank;
  const int q0 = kF32Rows * qt;
  const int n_steps = (qt + 1) * nc;
  const int tid = threadIdx.x;
  const bool first = tid < kF32Threads / 2;   // S; else dP
  const int th = tid % (kF32Threads / 2);
  const int ty = th / 8, tx = th % 8;
  const int qy = tid / 16, cx = tid % 16;
  constexpr int kRows = kF32Rows * 16 / kF32Threads;
  constexpr int kStep = kF32Rows / kRows;

  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh +
                    q0 * a.qss;
  const int64_t dos = int64_t(H) * D;
  const float* dop = static_cast<const float*>(a.dout) +
                     (int64_t(b) * S * H + h) * D + q0 * dos;
  const float* k = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* v = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  auto issue = [&](int t) {
    const int j = t / nc, c = t % nc;
    const float* kj = k + kF32Rows * j * a.kss;
    float* st = sm + (t % 2) * L::kStage;
    copy_tile<C>(st, qp + c * C, a.qss, tid);
    copy_tile<C>(st + L::kTile, dop + c * C, dos, tid);
    copy_tile<C>(st + 2 * L::kTile, kj + c * C, a.kss, tid);
    copy_tile<C>(st + 3 * L::kTile, v + kF32Rows * j * a.vss + c * C, a.vss,
                 tid);
    if (c == nc - 1) copy_tile<C>(Ksl, kj + sl * C, a.kss, tid);
    cp_async_commit();
  };
  issue(0);

  const float* lse = a.lse + (int64_t(b) * H + h) * S + q0;
  float rv[kPi];
#pragma unroll
  for (int ii = 0; ii < kPi; ++ii) rv[ii] = lse[ty + kPy * ii];
  if (tid < kF32Rows) di_s[tid] = a.di[(int64_t(b) * H + h) * S + q0 + tid];
  float acc[kRows][C / 16];   // dQ of the slice
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < C / 16; ++c) acc[i][c] = 0.f;
  float s[kPi][4];
  const float scale = a.scale;

  for (int t = 0; t < n_steps; ++t) {
    const int j = t / nc, c = t % nc;
    cp_async_wait<0>();
    __syncthreads();   // step t's copies have landed; step t - 1 is done
    if (t + 1 < n_steps) issue(t + 1);
    const float* st = sm + (t % 2) * L::kStage;
    tile_dots<C>(first ? st : st + L::kTile,
                 first ? st + 2 * L::kTile : st + 3 * L::kTile, ty, tx, s,
                 c == 0);
    if (c < nc - 1) continue;
#pragma unroll
    for (int ii = 0; ii < kPi; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qry = ty + kPy * ii, key = tx + 8 * jj;
        if (first) {
          Ps[qry * kLdP + key] = (j == qt && key > qry)
                                     ? -INFINITY
                                     : s[ii][jj] * scale - rv[ii];
        } else {
          dSs[qry * kLdP + key] = s[ii][jj];
        }
      }
    __syncthreads();   // the exponents and dP are complete
    p_and_ds<true>(Ps, dSs, di_s, scale, tid);
    __syncthreads();   // ds is complete
    tile_accumulate<C, kRows>(dSs, Ksl, qy, kStep, cx, acc);   // dS K
  }

  store_rows<C, kRows>(static_cast<float*>(a.out0) + sl * C, b, h, S, H,
                       q0 + qy, kStep, cx, acc, D);
}

cudaError_t launch_f32_dslice(bool dkv, const Args& a, int B, int D,
                              cudaStream_t stream) {
  constexpr int C = kChunk;
  constexpr int kSmem = F32SliceSmem<C>::kBytes;
  static SmemLimit dkv_limit{
      reinterpret_cast<const void*>(&flash_bwd_dkv_f32_dslice<C>), kSmem};
  static SmemLimit dq_limit{
      reinterpret_cast<const void*>(&flash_bwd_dq_f32_dslice<C>), kSmem};
  const cudaError_t err = (dkv ? dkv_limit : dq_limit).apply();
  if (err != cudaSuccess) return err;
  // launch_f32's groups of pairs whose streamed pair of tensors fits about
  // 32 MB of L2.
  const int64_t pair_bytes = int64_t(2) * a.S * D * 4;
  const int group = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(int64_t(B) * a.H,
                           (int64_t(32) << 20) / pair_bytes)));
  const int nc = D / C;
  const dim3 grid(B * a.H * (a.S / kF32Rows) * nc);
  if (dkv) {
    flash_bwd_dkv_f32_dslice<C><<<grid, kF32Threads, kSmem, stream>>>(
        a, nc, group);
  } else {
    flash_bwd_dq_f32_dslice<C><<<grid, kF32Threads, kSmem, stream>>>(
        a, nc, group);
  }
  return cudaGetLastError();
}

// Shared memory of both bf16 D-slice kernels: two stages of four 64-row
// chunks (dK/dV: K, V, Q, dO; dQ: Q, dO, K, V), the slice tiles (dK/dV: Q
// and dO; dQ: K), the hand-over buffers (p: 64 x 64 float32; dS's A
// fragments: 64 x 64 bf16, dQ only), 64 floats each of lse and di (dK/dV),
// then the mbarriers. A chunk or slice is C / 64 slabs of [64][64] bf16,
// 1024-byte aligned for the swizzle.
template <int C>
struct TcSliceSmem {
  static constexpr int kTile = 64 * C * 2;
  static constexpr int kStage = 4 * kTile;
  static constexpr int kSl = 2 * kStage;
  static constexpr int kP = kSl + 2 * kTile;
  static constexpr int kDs = kP + 64 * 64 * 4;
  static constexpr int kLse = kDs + 64 * 64 * 2;
  static constexpr int kBars = kLse + 2 * 64 * 4;
  static constexpr int kBytes = 1024 + kBars + 4 * 8;   // + alignment slack
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// Step t's four chunks into stage t % 2 (thread 0): chunk c of A0 and A1
// (rows a_row) and of B0 and B1 (rows b_row), each C / 64 boxes of 64
// columns, completing on `bar` with `extra` more bytes expected.
template <int C>
__device__ __forceinline__ void issue_chunks(
    uint8_t* st, uint64_t* bar, uint32_t extra, const CUtensorMap* a0,
    const CUtensorMap* a1, int a_row, const CUtensorMap* b0,
    const CUtensorMap* b1, int b_row, int c, int h, int b) {
  constexpr int NS = C / 64, kTile = TcSliceSmem<C>::kTile;
  mbar_expect(bar, 4 * kTile + extra);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int col = (NS * c + s) * kSlab;
    tma_load(st + s * 64 * 128, a0, bar, col, h, a_row, b);
    tma_load(st + kTile + s * 64 * 128, a1, bar, col, h, a_row, b);
    tma_load(st + 2 * kTile + s * 64 * 128, b0, bar, col, h, b_row, b);
    tma_load(st + 3 * kTile + s * 64 * 128, b1, bar, col, h, b_row, b);
  }
}

// One step's products of both warpgroups: warpgroup 0 adds A0_c B0_c^T to
// x (S or S^T: one chain over the whole of D, as the kernels above);
// warpgroup 1 adds A1_c B1_c^T to x (dP or dP^T) as two chains of four
// k-steps (64 columns), each added to x in float32 in order, x zeroed at
// chunk 0: the chains of gemm_abt_chained.
template <int C>
__device__ __forceinline__ void step_products(float (&x)[32], float (&x2)[32],
                                              float (&x3)[32],
                                              const uint8_t* st, int wg,
                                              int c) {
  constexpr int kTile = TcSliceSmem<C>::kTile;
  static_assert(C == 128, "two chains of four k-steps a chunk");
  wgmma_fence();
  if (wg == 0) {
    gemm_abt<C>(x, st, 64, 0, st + 2 * kTile, 64, 0, c > 0);
  } else {
    gemm_abt<C, 0, 4>(x2, st + kTile, 64, 0, st + 3 * kTile, 64, 0);
    gemm_abt<C, 4, 8>(x3, st + kTile, 64, 0, st + 3 * kTile, 64, 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(x);
  reg_fence(x2);
  reg_fence(x3);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = (c == 0 ? 0.f : x[i]) + x2[i];
      x[i] += x3[i];
    }
  }
}

// dK/dV. Block (head and slice, batch, 64-key tile), the most q tiles
// first; both warpgroups own keys k0 .. k0 + 63. Steps t = nc i + c over q
// tiles i (0 is diagonal) and chunks c: warpgroup 0 forms S^T = K Q^T,
// warpgroup 1 dP^T = V dO^T (step_products). After a tile's last chunk
// warpgroup 0 makes p^T and hands it over, warpgroup 1 makes ds^T, and
// they accumulate dV_slice += P^T dO_slice and dK_slice += dS^T Q_slice
// (m64n128k16), as flash_bwd_dkv_tc_wide does at D 256.
template <int C>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_dslice(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const TcArgs a) {
  using L = TcSliceSmem<C>;
  constexpr int NS = C / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Qsl = sm + L::kSl;
  uint8_t* dOsl = Qsl + L::kTile;
  float* px = reinterpret_cast<float*>(sm + L::kP);
  const float* lse_t = reinterpret_cast<const float*>(sm + L::kLse);
  const float* di_t = lse_t + 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, t_ = tid % 128, warp = t_ / 32;
  const int nc = a.nc, sl = blockIdx.x % nc, h = blockIdx.x / nc;
  const int b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int k0 = 64 * blockIdx.z;
  const int nq = (S - k0) / 64;
  const int n_steps = nq * nc;
  const float* lse = a.lse + (int64_t(b) * H + h) * S;
  const float* di = a.di + (int64_t(b) * H + h) * S;

  // With a tile's last chunk also its Q and dO slices, lse and di: single
  // buffers, as the forward's V slice (step t + 2 is issued once every
  // warp is done with step t; nc >= 3).
  auto issue = [&](int t) {
    const int i = t / nc, c = t % nc, q0 = k0 + 64 * i;
    const bool last = c == nc - 1;
    uint64_t* bar = full + t % 2;
    issue_chunks<C>(sm + (t % 2) * L::kStage, bar,
                    last ? 2 * L::kTile + 2 * 64 * 4 : 0, &tk, &tv, k0,
                    &tq, &tdo, q0, c, h, b);
    if (last) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        tma_load(Qsl + s * 64 * 128, &tq, bar, (NS * sl + s) * kSlab, h, q0,
                 b);
        tma_load(dOsl + s * 64 * 128, &tdo, bar, (NS * sl + s) * kSlab, h,
                 q0, b);
      }
      bulk_load(sm + L::kLse, lse + q0, 64 * 4, bar);
      bulk_load(sm + L::kLse + 64 * 4, di + q0, 64 * 4, bar);
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
    issue(1);   // n_steps >= nc >= 3
  }
  __syncwarp();

  // acc: dV (warpgroup 0) or dK of the slice; x: S^T or dP^T
  float acc[NS][32], x[32], x2[32], x3[32];
  zero<C>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = x2[i] = x3[i] = 0.f;
  const int row0 = 16 * warp + lane / 4;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;

  for (int t = 0; t < n_steps; ++t) {
    const int i = t / nc, c = t % nc;
    const int parity = (t / 2) % 2;
    const uint8_t* st = sm + (t % 2) * L::kStage;
    mbar_wait(full + t % 2, parity);
    step_products<C>(x, x2, x3, st, wg, c);
    if (c == nc - 1) {
      uint32_t frag[4][4];
      if (wg == 0) {
        tile_p<true>(x, i == 0, row0, lane,
                     [&](int e) { return lse_t[acc_col(e, lane)] * kLog2e; },
                     scale_log2);
        if (i > 0) bar_sync(kBarPFree);   // warpgroup 1 has read p of i - 1
#pragma unroll
        for (int e = 0; e < 32; ++e) px[e * 128 + t_] = x[e];
        bar_arrive(kBarPReady);
      } else {
        bar_sync(kBarPReady);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          x[e] = px[e * 128 + t_] * (x[e] - di_t[acc_col(e, lane)]) * scale;
        if (i + 1 < nq) bar_arrive(kBarPFree);
      }
      to_frags(x, frag);
      wgmma_fence();
      gemm_ax_wide<C>(acc, frag, wg == 0 ? dOsl : Qsl, 64, 0);   // dV or dK
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < NS; ++s) reg_fence(acc[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % 2);
    if (tid == 0 && t + 2 < n_steps) {
      mbar_wait(empty + t % 2, parity);
      issue(t + 2);
    }
    __syncwarp();
  }

  const int64_t D = int64_t(nc) * C, rs = int64_t(H) * D;
  const int64_t base = ((int64_t(b) * S + k0) * H + h) * D + sl * C;
  store_tile<C>((wg == 0 ? a.out1 : a.out0) + base, rs, acc, row0, lane);
}

// dQ. Block (head and slice, batch, 64-query tile), the last q tile first;
// both warpgroups own queries q0 .. q0 + 63. Steps t = nc j + c over k
// tiles j (up to the diagonal) and chunks c: warpgroup 0 forms S = Q K^T,
// warpgroup 1 dP = dO V^T (step_products). After a tile's last chunk
// warpgroup 0 makes p and hands it over, warpgroup 1 makes ds and hands
// its bf16 A fragments back, and each accumulates half of the slice:
// dQ[:, C sl + C/2 wg ..] += dS K[:, C sl + C/2 wg ..] (m64n64k16), as
// flash_bwd_dq_tc_wide does at D 256.
template <int C>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_dslice(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const TcArgs a) {
  using L = TcSliceSmem<C>;
  constexpr int NS = C / 64, HALF = C / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* Ksl = sm + L::kSl;
  float* px = reinterpret_cast<float*>(sm + L::kP);
  uint32_t* dsx = reinterpret_cast<uint32_t*>(sm + L::kDs);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, t_ = tid % 128, warp = t_ / 32;
  const int nc = a.nc, sl = blockIdx.x % nc, h = blockIdx.x / nc;
  const int b = blockIdx.y;
  const int S = a.S, H = a.H;
  const int q0 = 64 * (gridDim.z - 1 - blockIdx.z);
  const int nk = q0 / 64 + 1;
  const int n_steps = nk * nc;

  // With a tile's last chunk also its K slice (a single buffer, as in the
  // dK/dV kernel).
  auto issue = [&](int t) {
    const int j = t / nc, c = t % nc;
    const bool last = c == nc - 1;
    uint64_t* bar = full + t % 2;
    issue_chunks<C>(sm + (t % 2) * L::kStage, bar, last ? L::kTile : 0, &tq,
                    &tdo, q0, &tk, &tv, 64 * j, c, h, b);
    if (last) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        tma_load(Ksl + s * 64 * 128, &tk, bar, (NS * sl + s) * kSlab, h,
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
    issue(1);   // n_steps >= nc >= 3
  }
  __syncwarp();

  const int row0 = 16 * warp + lane / 4;
  const float* lse = a.lse + (int64_t(b) * H + h) * S + q0;
  const float* di = a.di + (int64_t(b) * H + h) * S + q0;
  const float lse2[2] = {lse[row0] * kLog2e, lse[row0 + 8] * kLog2e};
  const float dir[2] = {di[row0], di[row0 + 8]};
  float acc[HALF / 64][32], x[32], x2[32], x3[32];   // acc: dQ[:, HALF wg ..]
  zero<HALF>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = x2[i] = x3[i] = 0.f;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;

  for (int t = 0; t < n_steps; ++t) {
    const int j = t / nc, c = t % nc;
    const int parity = (t / 2) % 2;
    const uint8_t* st = sm + (t % 2) * L::kStage;
    mbar_wait(full + t % 2, parity);
    step_products<C>(x, x2, x3, st, wg, c);
    if (c == nc - 1) {
      uint32_t frag[4][4];
      if (wg == 0) {
        tile_p<false>(x, j == nk - 1, row0, lane,
                      [&](int e) { return lse2[(e / 2) % 2]; }, scale_log2);
#pragma unroll
        for (int e = 0; e < 32; ++e) px[e * 128 + t_] = x[e];
        bar_arrive(kBarPReady);
        bar_sync(kBarDsReady);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            frag[jj][r] = dsx[(4 * jj + r) * 128 + t_];
      } else {
        bar_sync(kBarPReady);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          x[e] = px[e * 128 + t_] * (x[e] - dir[(e / 2) % 2]) * scale;
        to_frags(x, frag);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dsx[(4 * jj + r) * 128 + t_] = frag[jj][r];
        bar_arrive(kBarDsReady);
      }
      wgmma_fence();
      gemm_ax<HALF>(acc, frag, Ksl + wg * (HALF / 64) * 64 * 128, 64,
                    0);                                            // dS K
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < HALF / 64; ++s) reg_fence(acc[s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % 2);
    if (tid == 0 && t + 2 < n_steps) {
      mbar_wait(empty + t % 2, parity);
      issue(t + 2);
    }
    __syncwarp();
  }

  const int64_t D = int64_t(nc) * C, rs = int64_t(H) * D;
  store_tile<HALF>(a.out0 + ((int64_t(b) * S + q0) * H + h) * D + sl * C +
                       HALF * wg,
                   rs, acc, row0, lane);
}

// The bf16 D-slice kernels: every tensor map in 64-row boxes of 64
// columns.
cudaError_t launch_tc_dslice(bool dkv, const Args& a, int B, int D,
                             cudaStream_t stream) {
  constexpr int C = kChunk;
  const int S = a.S, H = a.H;
  const int64_t qs[3] = {a.qsb, a.qss, a.qsh}, ks[3] = {a.ksb, a.kss, a.ksh},
                vs[3] = {a.vsb, a.vss, a.vsh},
                ds[3] = {int64_t(S) * H * D, int64_t(H) * D, D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map(&tq, a.q, B, S, H, D, qs, 64)) != cudaSuccess ||
      (err = make_map(&tk, a.k, B, S, H, D, ks, 64)) != cudaSuccess ||
      (err = make_map(&tv, a.v, B, S, H, D, vs, 64)) != cudaSuccess ||
      (err = make_map(&tdo, a.dout, B, S, H, D, ds, 64)) != cudaSuccess)
    return err;
  TcArgs t;
  t.lse = a.lse;
  t.di = a.di;
  t.out0 = static_cast<bf16*>(a.out0);
  t.out1 = static_cast<bf16*>(a.out1);
  t.S = S;
  t.H = H;
  t.nc = D / C;
  t.scale = a.scale;
  constexpr int kSmem = TcSliceSmem<C>::kBytes;
  static SmemLimit dkv_limit{
      reinterpret_cast<const void*>(&flash_bwd_dkv_tc_dslice<C>), kSmem};
  static SmemLimit dq_limit{
      reinterpret_cast<const void*>(&flash_bwd_dq_tc_dslice<C>), kSmem};
  if ((err = (dkv ? dkv_limit : dq_limit).apply()) != cudaSuccess)
    return err;
  const auto kernel =
      dkv ? flash_bwd_dkv_tc_dslice<C> : flash_bwd_dq_tc_dslice<C>;
  kernel<<<dim3(H * t.nc, B, S / 64), kTcThreads, kSmem, stream>>>(
      tq, tk, tv, tdo, t);
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
  if (dtype == 0 && D == 64) return launch_f32<64>(true, a, B, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(true, a, B, st);
  if (dtype == 1 && D == 64) return launch_tc<64>(true, a, B, st);
  if (dtype == 1 && D == 128) return launch_tc<128>(true, a, B, st);
  if (dtype == 0 && D == 256) return launch_f32<256>(true, a, B, st);
  if (dtype == 1 && D == 256) return launch_tc<256>(true, a, B, st);
  if (D > 256 && D % kChunk == 0 && dtype == 0)
    return launch_f32_dslice(true, a, B, D, st);
  if (D > 256 && D % kChunk == 0 && dtype == 1)
    return launch_tc_dslice(true, a, B, D, st);
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
  if (dtype == 0 && D == 64) return launch_f32<64>(false, a, B, st);
  if (dtype == 0 && D == 128) return launch_f32<128>(false, a, B, st);
  if (dtype == 1 && D == 64) return launch_tc<64>(false, a, B, st);
  if (dtype == 1 && D == 128) return launch_tc<128>(false, a, B, st);
  if (dtype == 0 && D == 256) return launch_f32<256>(false, a, B, st);
  if (dtype == 1 && D == 256) return launch_tc<256>(false, a, B, st);
  if (D > 256 && D % kChunk == 0 && dtype == 0)
    return launch_f32_dslice(false, a, B, D, st);
  if (D > 256 && D % kChunk == 0 && dtype == 1)
    return launch_tc_dslice(false, a, B, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
