// Fused Conv1d(k5, 'same') + optional FiLM pre-bias + GroupNorm + Mish as ONE CUDA kernel for
// Hopper (sm_90a), its conv on the tensor cores in fp32-accurate 3xTF32.
//
// Replaces the TPU kernel mpc_via_diffusion_model_tpu/ops/fused_conv.py::fused_conv1d_gn_mish
// (pallas_call at fused_conv.py:154): x (B, H, Cin) plus pre_bias (B, Cin) where given, the
// 'same' convolution with w (5, Cin, Cout) in flax's layout and bias b, GroupNorm over
// (H, Cout / groups) per batch element and group with gamma and beta, then Mish.
//
// What bounds it on this card. At the largest of the six shapes that
// scripts/bench_kernels.py times, (B, H, Cin, Cout) = (64, 8, 64, 128), the block is
// 2 * B * H * 5 * Cin * Cout = 41.9 MFLOP, 0.63 us at 67 TFLOP/s fp32, and it reads and writes
// about 0.56 MB, 0.17 us at 3.35 TB/s: bound by operations (the bound counts fp32 FLOPs; the
// 3xTF32 route's own ceiling is 495 / 3 = 165 TFLOP/s, 0.25 us), and both far below a launch.
//
// What the design does about it. One CTA of 8 warps per (GroupNorm group, chunk of batch
// elements), grid (groups, ceil(B / chunk)), chunk = max(1, 16 / H) elements so that one m16
// tile holds whole elements at H = 8. A CTA's statistics are its own: no cluster, no
// synchronisation between CTAs. ops/fused_conv.py::conv_plan computes the same plan, and the
// launcher refuses a launch whose shared memory differs from it.
// - Loads: the group's weight slice w[:, :, g * cpg:(g + 1) * cpg] into rows of w_stride floats
//   with the group's bias, gamma and beta, and the chunk's x rows into the interior rows
//   (x_stride floats each) of the halo layout (HALO zero rows above and below each element),
//   by 16-byte cp.async where the rows allow it (4-byte otherwise), committed as two groups;
//   the zero fill of the halo rows and the K-padding rows, the table of each K column's offset
//   in a row and each warp's row offsets overlap them; the pre-bias is added in place to the
//   interior rows once x has arrived. TMA is not needed at these tile sizes (a CTA's operands
//   are 1-39 KB at the bench's shapes).
// - Bank conflicts: x_stride = 4 (mod 8) and w_stride = 8 (mod 16), so the 32 lanes of an A
//   fragment load (rows g, columns t) and of a B fragment load (rows t, columns g) read 32
//   different banks (with x_stride = Cin, a multiple of 32 at the bench's widths, an A load was
//   8-way conflicted).
// - Conv: a (chunk * H) x cpg x 5 * Cin product on mma.sync.aligned.m16n8k8 with tf32
//   operands. A row m is element m / H, row m % H, and its column kk = k * Cin + ci is read at
//   the table's offset k * x_stride + ci from the row's first tap (an implicit im2col; the
//   table's -1 marks the K padding, read as 0); rows past the chunk's valid ones read row 0.
//   Every operand is split into hi = tf32(v) and lo = tf32(v - hi), rounded as cvt.rna does
//   (tf32_rna, an integer add and mask), and the products a_lo b_hi, a_hi b_lo and a_hi b_hi go
//   to three fp32 accumulators, three independent MMA chains in place of one chain of three
//   MMAs per k8 step, added at the end, the two small ones first (3xTF32): plain TF32's ~1e-3
//   relative error survives the GroupNorm and
//   would miss the 1e-4 tolerance. The warps form tile groups (each owning tiles r,
//   r + groups, ... in registers, at most CONV_MAX_TPW) of K splits (each taking every
//   k_splits-th k8 step); splits 1.. store their sums over the operands and split 0 adds them.
//   wgmma needs 64-row tiles, which these shapes cannot fill (M <= 32 rows per CTA at the
//   bench's shapes).
// - Epilogue from split 0's registers (warps 0 .. tile_groups - 1, the others have left): the
//   bias; each element's mean, then the sum of (y - mean)^2, each by lane sums, an xor-shuffle
//   tree, one sum per warp in shared memory, one named barrier of these warps and every thread
//   adding the warps' sums for its own rows (two passes from registers cost nothing here and
//   match the plain version's formula; the Pallas kernel's E[y^2] - mean^2 agrees within
//   tolerance too); the normalisation with gamma, beta and eps, Mish, and the C fragments'
//   pairs stored as float2.
// - Launch: the dynamic shared-memory attribute is set only for a plan over 48 KB, once per
//   size (reserve_smem); the bench's six plans take 1-39 KB.

#include <algorithm>

#include "unet_body.cuh"

#define CONV_KS 5        // taps
#define CONV_WARPS 8     // warps per CTA
#define CONV_MAX_TPW 4   // m16n8 tiles a warp holds in registers, three accumulators each

// ops/fused_conv.py::ConvPlan
struct ConvPlan {
  int chunk, n_chunks, cpg, cpg_pad, k_pad, k_steps, w_stride, x_stride, m_tiles, n_tiles, tiles,
      tile_groups, k_splits, tpw, operand_floats, partial_floats, epilogue_floats, smem_bytes;
};

static __host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

static ConvPlan make_plan(int batch, int H, int cin, int cout, int groups) {
  ConvPlan p;
  p.cpg = cout / groups;
  p.chunk = std::min(batch, std::max(1, 16 / H));
  p.n_chunks = ceil_div(batch, p.chunk);
  p.cpg_pad = 8 * ceil_div(p.cpg, 8);
  p.k_pad = 8 * ceil_div(CONV_KS * cin, 8);
  p.k_steps = p.k_pad / 8;
  p.w_stride = p.cpg_pad + (p.cpg_pad % 16 == 0 ? 8 : 0);  // b0's lanes in 32 banks
  p.x_stride = cin + ((4 - cin) % 8 + 8) % 8;              // a0's lanes in 32 banks
  p.m_tiles = ceil_div(p.chunk * H, 16);
  p.n_tiles = p.cpg_pad / 8;
  p.tiles = p.m_tiles * p.n_tiles;
  p.tile_groups = 1;
  while (2 * p.tile_groups <= std::min(p.tiles, CONV_WARPS)) p.tile_groups *= 2;
  p.k_splits = std::min(CONV_WARPS / p.tile_groups, p.k_steps);
  p.tpw = ceil_div(p.tiles, p.tile_groups);
  p.operand_floats = p.k_pad * p.w_stride + p.chunk * (H + 2 * HALO) * p.x_stride + p.k_pad;
  p.partial_floats = (p.k_splits - 1) * p.tiles * 128;
  p.epilogue_floats = 3 * p.cpg + 2 * CONV_WARPS * p.chunk;
  p.smem_bytes = 4 * (std::max(p.operand_floats, p.partial_floats) + p.epilogue_floats);
  return p;
}

static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tf32 as cvt.rna.tf32.f32 rounds a finite v (to nearest, ties away from zero, 10 mantissa
// bits): half of the 13 dropped bits added to the magnitude, then cleared. The PTX conversion
// also checks for Inf and NaN, which the finite operands do not need.
static __device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// (row, column) of the flat indices i0, i0 + step, ... over rows of `cols` columns: the
// divisions once, at the start, and not at every step
struct Walk {
  int row, col, drow, dcol, cols;
  __device__ __forceinline__ Walk(int i0, int step, int cols_)
      : row(i0 / cols_), col(i0 % cols_), drow(step / cols_), dcol(step % cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

// c += a b on one m16n8k8 tile with tf32 operands and fp32 accumulators
static __device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one k8 step of a b in 3xTF32: a_lo b_hi into c[0], a_hi b_lo into c[1], a_hi b_hi into c[2]
static __device__ __forceinline__ void mma_3xtf32(float (*c)[4], const float* a, const float* b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_rna(a[i]);
    al[i] = tf32_rna(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bh[i] = tf32_rna(b[i]);
    bl[i] = tf32_rna(b[i] - __uint_as_float(bh[i]));
  }
  mma_tf32(c[0], al, bh);
  mma_tf32(c[1], ah, bl);
  mma_tf32(c[2], ah, bh);
}

template <int TPW>
__global__ void __launch_bounds__(CONV_WARPS * 32)
fused_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ pre_bias,
                  float* __restrict__ out, int batch, int H, int cin, int cout, float eps,
                  ConvPlan p) {
  constexpr int NTH = CONV_WARPS * 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* wsm = smem;                            // (k_pad, w_stride)
  float* xs = wsm + p.k_pad * p.w_stride;       // (chunk, H + 2 HALO, x_stride)
  const int img = (H + 2 * HALO) * p.x_stride;  // floats per element
  int* col = reinterpret_cast<int*>(xs + p.chunk * img);  // (k_pad): K column -> row offset
  float* par = smem + max(p.operand_floats, p.partial_floats);  // bias, gamma, beta (cpg each)
  float* red = par + 3 * p.cpg;  // the two passes' sums, (CONV_WARPS, chunk) each
  const int tid = threadIdx.x, grp = blockIdx.x, b0 = blockIdx.y * p.chunk;
  const int n_valid = min(p.chunk, batch - b0), n_rows = n_valid * H;
  const int kc = CONV_KS * cin, xst = p.x_stride;

  // 1. the operands: the weight slice with the group's bias, gamma and beta (group 0) and the
  // chunk's x rows (group 1) by cp.async; the zero fill and the column table meanwhile; then
  // the pre-bias. The weight rows' padding columns stay unwritten: they feed only output
  // columns past cpg, which nothing reads.
  const float* wg = w + (size_t)grp * p.cpg;
  if (p.cpg % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
#pragma unroll 1
    for (Walk it(tid, NTH, p.cpg / 4); it.row < kc; it.next())
      cp_async16(wsm + it.row * p.w_stride + 4 * it.col, wg + (size_t)it.row * cout + 4 * it.col);
  } else {
#pragma unroll 1
    for (Walk it(tid, NTH, p.cpg); it.row < kc; it.next())
      cp_async4(wsm + it.row * p.w_stride + it.col, wg + (size_t)it.row * cout + it.col);
  }
#pragma unroll 1
  for (Walk it(tid, NTH, p.cpg); it.row < 3; it.next())
    cp_async4(par + it.row * p.cpg + it.col,
              (it.row == 0 ? bias : it.row == 1 ? gamma : beta) + (size_t)grp * p.cpg + it.col);
  cp_async_commit();
  // element e's x rows into its interior rows
  const bool x16 = cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#pragma unroll 1
  for (int e = 0; e < n_valid; ++e) {
    float* dst = xs + e * img + HALO * xst;
    const float* src = x + (size_t)(b0 + e) * H * cin;
    if (x16) {
#pragma unroll 1
      for (Walk it(tid, NTH, cin / 4); it.row < H; it.next())
        cp_async16(dst + it.row * xst + 4 * it.col, src + (size_t)it.row * cin + 4 * it.col);
    } else {
#pragma unroll 1
      for (Walk it(tid, NTH, cin); it.row < H; it.next())
        cp_async4(dst + it.row * xst + it.col, src + (size_t)it.row * cin + it.col);
    }
  }
  cp_async_commit();
#pragma unroll 1
  for (Walk it(tid, NTH, p.cpg_pad); it.row < p.k_pad - kc; it.next())  // K-padding rows
    wsm[(kc + it.row) * p.w_stride + it.col] = 0.f;
#pragma unroll 1
  for (Walk it(tid, NTH, cin); it.row < 2 * HALO * n_valid; it.next()) {  // rows -2, -1, H, H + 1
    const int e = it.row / (2 * HALO), hr = it.row - e * 2 * HALO;
    xs[e * img + (hr < HALO ? hr : H + hr) * xst + it.col] = 0.f;
  }
#pragma unroll 1
  for (Walk it(tid, NTH, cin); it.row * cin + it.col < p.k_pad; it.next())  // tap, channel
    col[it.row * cin + it.col] = it.row < CONV_KS ? it.row * xst + it.col : -1;
  // the warp's cut and its rows, while the copies land
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r = warp % p.tile_groups, s = warp / p.tile_groups;
  const bool active = s < p.k_splits;
  const int n_own = active ? ceil_div(p.tiles - r, p.tile_groups) : 0;
  int arow[TPW][2];  // image offsets of the A rows g and g + 8 of each own tile
  int erow[TPW][2];  // their batch element in the chunk, -1 past the valid rows
  int ncol[TPW];     // the tile's first column
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int tile = r + j * p.tile_groups;
    const int mt = tile / p.n_tiles;
    ncol[j] = (tile - mt * p.n_tiles) * 8;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = mt * 16 + g + 8 * hh, e = m / H;
      erow[j][hh] = m < n_rows ? e : -1;
      arow[j][hh] = m < n_rows ? e * img + (m - e * H) * xst : 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (pre_bias != nullptr) {
#pragma unroll 1
    for (int e = 0; e < n_valid; ++e) {
      float* row0 = xs + e * img + HALO * xst;
      const float* pb = pre_bias + (size_t)(b0 + e) * cin;
#pragma unroll 1
      for (Walk it(tid, NTH, cin); it.row < H; it.next()) row0[it.row * xst + it.col] += __ldg(pb + it.col);
    }
    __syncthreads();
  }

  // 2. the conv: warp (tile group r, split s) sums its k-steps of its own tiles into three
  // accumulators per tile, a_lo b_hi, a_hi b_lo and a_hi b_hi: three independent MMA chains
  float acc[TPW][3][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][q][i] = 0.f;
#pragma unroll 2
  for (int ks = active ? s : p.k_steps; ks < p.k_steps; ks += p.k_splits) {
    const int k0 = ks * 8;
    const int oa = col[k0 + t4], ob = col[k0 + t4 + 4];  // A columns t and t + 4
    const float* wk = wsm + (k0 + t4) * p.w_stride + g;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      if (j < n_own) {
        const float a[4] = {oa >= 0 ? xs[arow[j][0] + oa] : 0.f, oa >= 0 ? xs[arow[j][1] + oa] : 0.f,
                            ob >= 0 ? xs[arow[j][0] + ob] : 0.f, ob >= 0 ? xs[arow[j][1] + ob] : 0.f};
        const float b[2] = {wk[ncol[j]], wk[4 * p.w_stride + ncol[j]]};
        mma_3xtf32(acc[j], a, b);
      }
    }
  }
  float y[TPW][4];  // the product: the two small accumulators first
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[j][i] = (acc[j][0][i] + acc[j][1][i]) + acc[j][2][i];

  // 3. the split-K reduction, the partials over the operands
  __syncthreads();
  float4* part = smem4;
  if (active && s > 0) {
#pragma unroll
    for (int j = 0; j < TPW; ++j)
      if (j < n_own)
        part[((s - 1) * p.tiles + r + j * p.tile_groups) * 32 + lane] =
            make_float4(y[j][0], y[j][1], y[j][2], y[j][3]);
  }
  __syncthreads();
  if (!(active && s == 0)) return;  // split 0 of each tile group (warps 0 .. tile_groups - 1)
#pragma unroll 1
  for (int s2 = 1; s2 < p.k_splits; ++s2) {
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      if (j < n_own) {
        const float4 v = part[((s2 - 1) * p.tiles + r + j * p.tile_groups) * 32 + lane];
        y[j][0] += v.x;
        y[j][1] += v.y;
        y[j][2] += v.z;
        y[j][3] += v.w;
      }
    }
  }

  // 4. the epilogue: register i of tile j is row g + 8 (i >> 1), column ncol + 2 t4 + (i & 1).
  // Each pass: a lane's sum per element, an xor-shuffle tree, one sum per warp into shared
  // memory, one barrier of the epilogue's warps (named barrier 1), and every thread adding the
  // warps' sums for its rows.
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ncol[j] + 2 * t4 + (i & 1);
      if (j < n_own && erow[j][i >> 1] >= 0 && c < p.cpg) y[j][i] += par[c];
    }
  const float n_elems = (float)(H * p.cpg);
  float mu[TPW][2] = {}, rs[TPW][2];  // each own row's mean and 1/std
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    float* sums = red + pass * CONV_WARPS * p.chunk;
#pragma unroll 1
    for (int e = 0; e < n_valid; ++e) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TPW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ncol[j] + 2 * t4 + (i & 1);
          if (j < n_own && erow[j][i >> 1] == e && c < p.cpg) {
            const float d = y[j][i] - mu[j][i >> 1];
            sum += pass ? d * d : y[j][i];
          }
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) sums[r * p.chunk + e] = sum;
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(32 * p.tile_groups) : "memory");
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = max(erow[j][hh], 0);
        float tot = sums[e];
#pragma unroll 1
        for (int q = 1; q < p.tile_groups; ++q) tot += sums[q * p.chunk + e];
        if (pass)
          rs[j][hh] = 1.0f / sqrtf(tot / n_elems + eps);
        else
          mu[j][hh] = tot / n_elems;
      }
  }
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    if (j >= n_own) continue;
    const int mt = (r + j * p.tile_groups) / p.n_tiles;
    const int c = ncol[j] + 2 * t4;
    if (c >= p.cpg) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = erow[j][hh];
      if (e < 0) continue;
      const int t = mt * 16 + g + 8 * hh - e * H;
      float* o = out + ((size_t)(b0 + e) * H + t) * cout + (size_t)grp * p.cpg + c;
      const float v0 =
          mish_f((y[j][2 * hh] - mu[j][hh]) * rs[j][hh] * par[p.cpg + c] + par[2 * p.cpg + c]);
      if (c + 1 < p.cpg) {
        const float v1 = mish_f((y[j][2 * hh + 1] - mu[j][hh]) * rs[j][hh] * par[p.cpg + c + 1] +
                                par[2 * p.cpg + c + 1]);
        if (p.cpg % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          o[1] = v1;
        }
      } else {
        o[0] = v0;
      }
    }
  }
}

template <int TPW>
static int launch_tpw(const float* x, const float* w, const float* bias, const float* gamma,
                      const float* beta, const float* pre_bias, float* out, int batch, int H,
                      int cin, int cout, int groups, float eps, const ConvPlan& p,
                      cudaStream_t stream) {
  static int smem_set[MAX_DEVICES];
  cudaError_t e = reserve_smem(fused_conv_kernel<TPW>, p.smem_bytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  fused_conv_kernel<TPW><<<dim3(groups, p.n_chunks), CONV_WARPS * 32, p.smem_bytes, stream>>>(
      x, w, bias, gamma, beta, pre_bias, out, batch, H, cin, cout, eps, p);
  return (int)cudaGetLastError();
}

extern "C" {

// Launches the block on `stream` for `batch` elements; pre_bias may be null. smem_bytes is
// ops/fused_conv.py::conv_plan's, which must equal this file's plan. Returns the CUDA error
// code (0 = launched).
int fused_conv_launch(const float* x, const float* w, const float* bias, const float* gamma,
                      const float* beta, const float* pre_bias, float* out, int batch, int H,
                      int cin, int cout, int groups, float eps, int smem_bytes, void* stream) {
  if (batch < 1 || H < 1 || cin < 1 || groups < 1 || cout % groups) return (int)cudaErrorInvalidValue;
  const ConvPlan p = make_plan(batch, H, cin, cout, groups);
  if (p.smem_bytes != smem_bytes || p.tpw > CONV_MAX_TPW) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.tpw <= 1)
    return launch_tpw<1>(x, w, bias, gamma, beta, pre_bias, out, batch, H, cin, cout, groups, eps, p, st);
  if (p.tpw <= 2)
    return launch_tpw<2>(x, w, bias, gamma, beta, pre_bias, out, batch, H, cin, cout, groups, eps, p, st);
  return launch_tpw<4>(x, w, bias, gamma, beta, pre_bias, out, batch, H, cin, cout, groups, eps, p, st);
}

const char* fused_conv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The meta layout of unet_body.cuh, which this library includes; the binder checks every
// library's against ops/unet_pack.py.
int fused_conv_meta_len(void) { return M_LEN; }

}  // extern "C"
