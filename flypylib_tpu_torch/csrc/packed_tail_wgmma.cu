// The packed engines' valid 2x2x2 conv + bias + ReLU on Hopper: one stage of
// K2 / K3 as an implicit GEMM on wgmma, fed by TMA through an mbarrier ring,
// with the hi/lo logits in the last stage's epilogue (sm_90a).  The same
// kernel runs every conv + bias + ReLU of the packed engines' inference
// (ops/packed_conv.py::packed_conv_relu), with Co past 192 in output-channel
// slices.
//
// Replaces, for bf16, the stage of the TPU kernels
// flypylib_tpu/ops/pallas_tail.py:221 (packed_tail, K2) and :470
// (packed_tail2, K3).  For xa (B,D,H,W,Ca), an optional xb (B,D,H,W,Cb)
// (K3's first stage), weights wa (2,2,2,Ca,Co), wb (2,2,2,Cb,Co) and a bf16
// bias b (Co,), with Ca, Cb and Co multiples of 8 and 16-byte aligned
// operands, it computes what stage_wmma_kernel of packed_tail.cu computes,
// with the TPU kernel's rounding points:
//
//   s[n,z,y,x,o] = relu(bf16(bf16(sum_{taps,c} f32(xa[..]) * f32(wa[..])
//                                 + sum_{taps,c} f32(xb[..]) * f32(wb[..]))
//                            + b[o]))
//
// the 8 taps x (Ca + Cb) products summed in f32, one rounding to bf16, the
// bf16 bias added with the sum rounded to bf16, ReLU.  Without logits it
// stores s, (B, D-1, H-1, W-1, Co) bf16.  With logits (wl (Co, 2L) bf16, the
// hi and lo halves of the weight; bl (L,) f32; L <= 8) it stores
//
//   out[n,z,y,x,j] = (sum_c f32(s[..,c]) * f32(wl[c,j])
//                     + sum_c f32(s[..,c]) * f32(wl[c,L+j])) + bl[j]
//
// (B, D-1, H-1, W-1, L) f32, and s never reaches device memory.
//
// The GEMM: M = output voxels, N = Co, K = 8 taps x (Ca + Cb).
// - A tile is an output box (bz, by, bx) of up to 192 voxels (three consumer
//   warpgroups, one m64 row block each) and one slice of N.  Co <= 192 is
//   one slice: the N tile NT is Co rounded up to one of 32/64/96/128/192, so
//   each A tile is loaded once whatever Co is, and one m64nNTk16 accumulator
//   is NT/2 f32 registers a thread (96 at Co = 192).  A wider Co (no logits)
//   is cut into n = ceil(Co / 192) slices of Cs channels (Co / n rounded up
//   to a multiple of 8; the last may be narrower), each on the smallest NT
//   that holds Cs: 256 -> 2 x 128, 384 -> 2 x 192, 768 -> 4 x 192.  The
//   weight images carry a slice axis; a tile's bias, weights and store are
//   offset by its slice, and the store keeps the row stride Co.
// - Blocks are persistent: the grid is one block per SM, rounded down to a
//   multiple of n, and each walks over tiles blockIdx.x, + gridDim.x, ...,
//   so the ring keeps loading the next tile while the epilogue of this one
//   runs.  Tile t is box t / n, slice t % n: the slice is fastest, so a
//   block keeps one slice (its bias is loaded once) and the n blocks that
//   share an A box run side by side and read it from L2 together.
// - K runs over (tap, channel slice) steps, xa's slices then xb's into the
//   same accumulators, so the concat of the two operands never exists.  A
//   step is one TMA load of a 5-D box (32, bx, by, bz, 1) at (c0, x0+tx,
//   y0+ty, z0+tz, n) over the NDHWC operand (64-byte swizzle; TMA zero-fills
//   past the volume and past C), or, for a rest of 1-16 channels, a
//   (16, ...) box ending at channel C with the 32-byte swizzle; and one TMA
//   load of the step's (NT x 32 or 16) slice of the weight images the
//   wrapper lays out ([wa; wb] stacked, K-major, zero-padded bf16).
// - A ring of (A, B) stages in dynamic shared memory with full and empty
//   mbarriers; warp 12 is the producer (one thread issues the loads), the
//   three warpgroups before it are consumers: per step two k16 wgmma (one for
//   a 16-channel slice), wait_group 1, release of the step before.
// - Epilogue from registers.  Without logits: round, bias, round, ReLU;
//   the bf16 pairs a lane holds go through a 1.25-KB staging tile of its
//   warp in shared memory, 32 channels at a time, and leave as 16-byte runs
//   of 8 channels, so a warp's store fills whole 32-byte sectors where pair
//   stores filled half ones.  With logits: the same values, packed as bf16
//   pairs, are already laid out as the A fragments of mma.sync.m16n8k16 (a
//   warp's 16 rows x 16 channels per k step), so each warp multiplies its
//   rows by the (NT x 16) hi/lo weight held in shared memory on the tensor
//   cores, with f32 sums, and adds (hi + lo) + bl in f32.
//
// What bounds it on an H100.  At the decoder tail's shapes (132^3 cells,
// 240 -> 192 -> 192 channels, 1.66 and 1.30 TFLOP) device memory moves
// ~4.5 GB (1.35 ms) against 3.0 ms of tensor-core work, so the stages are
// bound by operations, and so are the packed engines' convs with Ci >= 192
// (the U-Net's 193^3 x 192 -> 192: 4.2 TFLOP, 4.2 ms at peak).  Every block
// re-reads the whole weight image (0.74 MB at stage 0) and every input
// value 8 times through L2: per K step an SM takes in 12 KB of A and 12 KB
// of B for 192 x 192 x 32 x 2 FLOP, 1/N + 1/M bytes per FLOP, which at the
// tensor cores' peak would be ~10 TB/s into the SMs; the kernel runs where
// that stream reads 5.0-6.4 TB/s.  With n slices every A box is read n
// times from L2, at the same 1/N + 1/M bytes per FLOP into each SM as one
// slice at NT = 192; the n blocks that share a box run side by side, so
// device memory still gives it about once, and 384 and 768 channels are 2
// and 4 slices of 192, so no slice wastes columns.  At Ci = 8 (each model's
// first conv: one 16-channel K step a tap, half of it zero-filled) a tile
// does 8 K steps and stores 192 x 192 bf16, so the store bounds it (the
// U-Net's 193^3 x 192 output is 2.9 GB, 0.86 ms at 3.35 TB/s); the staged
// 16-byte stores took it from 4.0-4.3 to 2.3-2.4 ms there (PERF.md).  What
// the design does about it all: every byte goes by TMA, N covers Co (or a
// slice of it) so A is loaded once a slice, the block is as many rows as
// the registers hold, and the persistent ring overlaps the epilogue with
// the next tile's loads.  Three consumer warpgroups (192 rows, 128
// registers a thread, no spills) were measured faster than two (128 rows,
// 164 registers) by 3-12% of the whole tail; four warpgroups of m64n192
// accumulators do not fit beside a producer warp (122 registers needed
// where 17 warps, allocated as 20, leave 96).  Two blocks of a cluster
// sharing each weight slice by TMA multicast (half the L2 reads, the same
// bytes into each SM) were measured at 128 rows and were no faster
// (PERF.md has the times).
//
// C entry: fpl_tail_stage_wgmma(...) encodes the tensor maps, launches on
// the given stream and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take); it allocates nothing and does not
// synchronise.

#include "hopper.cuh"

namespace {

constexpr int kTaps = 8;
constexpr int kLogitCols = 16;  // hi columns 0-7, lo columns 8-15
constexpr int kMaxL = kLogitCols / 2;
constexpr int kRingBytes = 200 * 1024;
// 32-bit words a row of a warp's store staging tile takes: 16 for 32 bf16
// channels, + 4 so that a warp's pair writes (8 rows x 4 lanes) hit 32 banks
constexpr int kOutPitch = 20;

struct TailMaps {
  CUtensorMap xa, xa16, xb, xb16, w, w16;
};

struct TailArgs {
  const __nv_bfloat16* bias;  // (Co,)
  const __nv_bfloat16* wl;    // (Co, 2L), or null: store the stage output
  const float* bl;            // (L,)
  void* out;                  // bf16 (.., Co), or f32 (.., L) with logits
  int Do, Ho, Wo, Co, L;
  int Cs, n_slices;  // channels of a slice (the last may hold fewer), slices
  // per operand: 32-channel slices, whether a 16-channel slice follows, and
  // that slice's first channel
  int a_full, a_half, a_last, b_full, b_half, b_last;
  int bz, by, bx, tiles_z, tiles_y, tiles_x, n_tiles;
};

template <int NT>
struct Tile {
  static constexpr int kWarpgroups = 3;  // consumers, one m64 row block each
  static constexpr int kRows = 64 * kWarpgroups;
  static constexpr int kABytes = kRows * kRowBytes;
  static constexpr int kBBytes = ((NT * kRowBytes + 1023) / 1024) * 1024;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      kRingBytes / kStageBytes < 8 ? kRingBytes / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 32;  // + one producer warp
};

// one stage output value: round the f32 sum, add the bias (rounded), ReLU
__device__ __forceinline__ __nv_bfloat16 stage_value(float sum, float bias) {
  const float v = __bfloat162float(__float2bfloat16_rn(sum));
  const float y = __bfloat162float(__float2bfloat16_rn(v + bias));
  return __float2bfloat16_rn(fmaxf(y, 0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 p = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major fragments) * b (16 x 8)
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Box {
  int n, z0, y0, x0;
};

__device__ __forceinline__ Box tile_box(int t, const TailArgs& a) {
  Box b;
  b.x0 = (t % a.tiles_x) * a.bx;
  t /= a.tiles_x;
  b.y0 = (t % a.tiles_y) * a.by;
  t /= a.tiles_y;
  b.z0 = (t % a.tiles_z) * a.bz;
  b.n = t / a.tiles_z;
  return b;
}

template <int NT>
__global__ void __launch_bounds__(Tile<NT>::kThreads)
tail_wgmma_kernel(const __grid_constant__ TailMaps tm,
                  const __grid_constant__ TailArgs a) {
  using T = Tile<NT>;
  constexpr int kStages = T::kStages;
  constexpr int kWlPitch = NT + 8;  // bf16: the B fragment reads hit 32 banks
  static_assert(NT % 32 == 0 && NT <= 192, "N tile");
  static_assert(kStages >= 2, "ring depth");

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ float bias_s[NT];
  __shared__ __align__(16) __nv_bfloat16 wl_s[kLogitCols * kWlPitch];
  // each consumer warp's staging tile of the store: 16 rows x 32 channels
  __shared__ __align__(16) uint32_t out_s[T::kConsumers / 32][16 * kOutPitch];
  // the swizzle pattern repeats every 512 bytes: align every tile to 1024
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int warp_id = uniform_warp_index();
  const int per_tap = a.a_full + a.a_half + a.b_full + a.b_half;
  const int steps = kTaps * per_tap;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), T::kConsumers / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the grid is a multiple of n_slices: every tile of a block is in its slice
  const int slice = blockIdx.x % a.n_slices;
  const int c_base = slice * a.Cs;
  const int c_live = min(a.Cs, a.Co - c_base);  // this slice's channels
  for (int i = tid; i < NT; i += T::kThreads)
    bias_s[i] = i < c_live ? __bfloat162float(a.bias[c_base + i]) : 0.f;
  if (a.wl != nullptr) {
    // wl_s[col][c]: column j < 8 is hi[j], column 8 + j is lo[j]; zero past
    // L and past Co
    for (int i = tid; i < kLogitCols * NT; i += T::kThreads) {
      const int col = i / NT, c = i % NT, j = col % kMaxL;
      const bool live = c < a.Co && j < a.L;
      wl_s[col * kWlPitch + c] =
          live ? a.wl[c * 2 * a.L + (col < kMaxL ? 0 : a.L) + j]
               : __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  if (warp_id >= T::kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (tid == T::kConsumers) {
      if (a.a_full) prefetch_map(&tm.xa);
      if (a.a_half) prefetch_map(&tm.xa16);
      if (a.b_full) prefetch_map(&tm.xb);
      if (a.b_half) prefetch_map(&tm.xb16);
      if (a.a_full + a.b_full) prefetch_map(&tm.w);
      if (a.a_half + a.b_half) prefetch_map(&tm.w16);
      const int rows = a.bz * a.by * a.bx;
      const int n32 = a.a_full + a.b_full, n16 = a.a_half + a.b_half;
      // the slice's weight images: rows of slice s start at s * 8 * n
      const int w32_base = slice * kTaps * n32, w16_base = slice * kTaps * n16;
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const Box box = tile_box(tile / a.n_slices, a);
        for (int tap = 0; tap < kTaps; ++tap) {
          const int tz = tap >> 2, ty = (tap >> 1) & 1, tx = tap & 1;
          for (int sl = 0; sl < per_tap; ++sl, ++it) {
            const uint32_t s = it % kStages;
            if (it >= kStages)
              mbar_wait(smem_u32(&empty_bar[s]), ((it / kStages) + 1) & 1);
            // the step's slice: xa's 32-channel slices, xa's 16-channel
            // slice, then the same of xb
            const CUtensorMap* xm;
            int c0, wrow, i = sl;
            bool full;
            if (i < a.a_full) {
              xm = &tm.xa, c0 = i * kKC, full = true;
              wrow = w32_base + tap * n32 + i;
            } else if ((i -= a.a_full) < a.a_half) {
              xm = &tm.xa16, c0 = a.a_last, full = false;
              wrow = w16_base + tap * n16;
            } else if ((i -= a.a_half) < a.b_full) {
              xm = &tm.xb, c0 = i * kKC, full = true;
              wrow = w32_base + tap * n32 + a.a_full + i;
            } else {
              xm = &tm.xb16, c0 = a.b_last, full = false;
              wrow = w16_base + tap * n16 + a.a_half;
            }
            const uint32_t fb = smem_u32(&full_bar[s]);
            const uint32_t sa = base + s * T::kStageBytes;
            const int row = full ? kRowBytes : kRowBytes / 2;
            mbar_expect_tx(fb, (uint32_t)((rows + NT) * row));
            tma_load_5d(sa, xm, fb, c0, box.x0 + tx, box.y0 + ty, box.z0 + tz,
                        box.n);
            tma_load_2d(sa + T::kABytes, full ? &tm.w : &tm.w16, fb, 0,
                        wrow * NT);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = warp_id / 4, warp = warp_id % 4, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int box_rows = a.bz * a.by * a.bx;
  // no zero fill: a tile's first step overwrites (scale_d = 0).  A move
  // into the accumulators between wgmma issue and wait would serialise them.
  float acc[NT / 2];
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    int sl = 0;
    for (int k = 0; k < steps; ++k, ++it) {
      const uint32_t s = it % kStages;
      mbar_wait(smem_u32(&full_bar[s]), (it / kStages) & 1);
      const uint32_t sa = base + s * T::kStageBytes;
      const bool half = (sl >= a.a_full && sl < a.a_full + a.a_half) ||
                        sl >= per_tap - a.b_half;
      fence_acc(acc);
      wgmma_fence();
      if (!half) {  // 32 channels: two k16 steps, +32 bytes of K each
        const uint64_t da = desc_k<64>(sa + wg * 64 * kRowBytes);
        const uint64_t db = desc_k<64>(sa + T::kABytes);
        wgmma_bf16<NT>(acc, da, db, k > 0);
        wgmma_bf16<NT>(acc, da + 2, db + 2, 1);
      } else {  // the 16-channel slice: 32-byte rows, one k16 step
        wgmma_bf16<NT>(acc, desc_k<32>(sa + wg * 64 * (kRowBytes / 2)),
                       desc_k<32>(sa + T::kABytes), k > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the step before has been read: release its stage
      fence_acc(acc);
      if (k > 0 && lane == 0)
        mbar_arrive(smem_u32(&empty_bar[(it - 1) % kStages]));
      if (++sl == per_tap) sl = 0;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[(it - 1) % kStages]));

    // ----------------------------------------------------------- epilogue
    // the thread holds, of rows r0 and r0 + 8 of the block, channels
    // 8 j + 2 q and 8 j + 2 q + 1 for every j: acc[4 j + 2 h + e]
    const Box box = tile_box(tile / a.n_slices, a);
    long long voxel[2];  // output voxel index of the two rows, or -1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + h * 8 + g;
      const int xx = box.x0 + r % a.bx, yy = box.y0 + (r / a.bx) % a.by,
                zz = box.z0 + r / (a.bx * a.by);
      const bool live = r < box_rows && xx < a.Wo && yy < a.Ho && zz < a.Do;
      voxel[h] = live ? (((long long)box.n * a.Do + zz) * a.Ho + yy) * a.Wo + xx
                      : -1;
    }
    if (a.wl == nullptr) {
      // 32 channels at a time through the warp's staging tile: the lane
      // writes its bf16 pairs (rows g and g + 8, channels 8 k + 2 q) and
      // reads back, of the same two rows, channel group q whole, so that a
      // warp's store writes 8 rows x 64 contiguous bytes (whole 32-byte
      // sectors) where pairs wrote 8 rows x 16 bytes
      auto* out = static_cast<__nv_bfloat16*>(a.out);
      uint32_t* ws = out_s[warp_id];
#pragma unroll
      for (int jj = 0; jj < NT / 32; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * jj + k, col = j * 8 + q * 2;
            ws[(h * 8 + g) * kOutPitch + k * 4 + q] = pack_bf16(
                stage_value(acc[4 * j + 2 * h], bias_s[col]),
                stage_value(acc[4 * j + 2 * h + 1], bias_s[col + 1]));
          }
        }
        __syncwarp();
        const int col = (4 * jj + q) * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              ws + (h * 8 + g) * kOutPitch + q * 4);
          if (voxel[h] >= 0 && col < c_live)
            *reinterpret_cast<uint4*>(out + voxel[h] * a.Co + c_base + col) = v;
        }
        __syncwarp();  // the tile is read before the next chunk overwrites it
      }
    } else {
      // the warp's 16 rows x NT channels times wl_s (NT x 16) on mma.sync:
      // k step ks covers channels 16 ks .. 16 ks + 15, i.e. j = 2 ks, 2 ks + 1
      float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < NT / 16; ++ks) {
        uint32_t af[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * ks + jj, col = j * 8 + q * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            af[2 * jj + h] =
                pack_bf16(stage_value(acc[4 * j + 2 * h], bias_s[col]),
                          stage_value(acc[4 * j + 2 * h + 1], bias_s[col + 1]));
        }
        const __nv_bfloat16* wk = wl_s + 16 * ks + q * 2;
        const __nv_bfloat16* wh = wk + g * kWlPitch;
        const __nv_bfloat16* wo = wk + (kMaxL + g) * kWlPitch;
        mma_m16n8k16(hi, af[0], af[1], af[2], af[3],
                     *reinterpret_cast<const uint32_t*>(wh),
                     *reinterpret_cast<const uint32_t*>(wh + 8));
        mma_m16n8k16(lo, af[0], af[1], af[2], af[3],
                     *reinterpret_cast<const uint32_t*>(wo),
                     *reinterpret_cast<const uint32_t*>(wo + 8));
      }
      // the thread holds logits 2 q and 2 q + 1 of rows r0 (c[0], c[1]) and
      // r0 + 8 (c[2], c[3])
      auto* out = static_cast<float*>(a.out);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (voxel[h] < 0) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = q * 2 + e;
          if (j < a.L)
            out[voxel[h] * a.L + j] = (hi[2 * h + e] + lo[2 * h + e]) + a.bl[j];
        }
      }
    }
  }
}

// (32-channel slices, whether a 16-channel slice follows, its first
// channel) of an operand of C channels: C / 32 slices of 32; a rest of 1-16
// channels in one 16-channel slice ending at channel C; a rest of 17-31 in
// one more 32-channel slice (ops/conv.py::wgmma_slices)
void slices(int C, int* full, int* half, int* last) {
  const int rest = C % kKC;
  *half = rest > 0 && rest <= kKC / 2;
  *full = C / kKC + (rest > kKC / 2);
  *last = C > kKC / 2 ? C - kKC / 2 : 0;
}

template <int NT>
int launch(const TailMaps& m, TailArgs a, int B, cudaStream_t stream) {
  using T = Tile<NT>;
  if (a.bz * a.by * a.bx > T::kRows) return (int)cudaErrorInvalidValue;
  auto kernel = tail_wgmma_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  a.tiles_z = (a.Do + a.bz - 1) / a.bz;
  a.tiles_y = (a.Ho + a.by - 1) / a.by;
  a.tiles_x = (a.Wo + a.bx - 1) / a.bx;
  const long long tiles =
      (long long)B * a.tiles_z * a.tiles_y * a.tiles_x * a.n_slices;
  // shared memory allows one block per SM: one persistent block each, as
  // many as are a multiple of n_slices (so that a block keeps one slice)
  const int blocks = sms / a.n_slices * a.n_slices;
  if (tiles > 0x7fffffffLL || blocks < 1) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(m, a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// one launch of the kernel over n_slices output-channel slices of Cs
// channels (see the C entries below)
int stage(const void* xa, const void* xb, const void* w32, const void* w16,
          const void* b, const void* wl, const void* bl, void* out, int B,
          int D, int H, int W, int Ca, int Cb, int Co, int Cs, int n_slices,
          int L, int n_tile, int bz, int by, int bx, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  TailArgs a = {};
  slices(Ca, &a.a_full, &a.a_half, &a.a_last);
  if (Cb > 0) slices(Cb, &a.b_full, &a.b_half, &a.b_last);
  const int n32 = a.a_full + a.b_full, n16 = a.a_half + a.b_half;
  if (B < 1 || D < 2 || H < 2 || W < 2 || Ca < 8 || Ca % 8 || Cb < 0 ||
      Cb % 8 || Co < 8 || Co % 8 || Cs < 8 || Cs % 8 || Cs > n_tile ||
      !aligned16(out) ||
      n_slices < 1 || (long long)Cs * (n_slices - 1) >= Co ||
      (long long)Cs * n_slices < Co || bz < 1 || by < 1 || bx < 1 ||
      bz > 256 || by > 256 || bx > 256 || !aligned16(xa) ||
      (Cb > 0 && (xb == nullptr || !aligned16(xb))) ||
      (n32 > 0 && (w32 == nullptr || !aligned16(w32))) ||
      (n16 > 0 && (w16 == nullptr || !aligned16(w16))) ||
      (wl == nullptr) != (bl == nullptr) ||
      (wl != nullptr && (L < 1 || L > kMaxL || n_slices != 1)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  TailMaps m = {};  // a map the call does not use stays zero and is never read
  bool ok = true;
  if (a.a_full)
    ok = ok && encode_x(encode, &m.xa, xa, B, D, H, W, Ca, kKC, bz, by, bx);
  if (a.a_half)
    ok = ok && encode_x(encode, &m.xa16, xa, B, D, H, W, Ca, kKC / 2, bz, by, bx);
  if (a.b_full)
    ok = ok && encode_x(encode, &m.xb, xb, B, D, H, W, Cb, kKC, bz, by, bx);
  if (a.b_half)
    ok = ok && encode_x(encode, &m.xb16, xb, B, D, H, W, Cb, kKC / 2, bz, by, bx);
  const int rows = n_slices * kTaps * n_tile;  // weight rows per K slice
  if (n32) ok = ok && encode_w(encode, &m.w, w32, rows * n32, kKC, n_tile);
  if (n16)
    ok = ok && encode_w(encode, &m.w16, w16, rows * n16, kKC / 2, n_tile);
  if (!ok) return (int)cudaErrorInvalidValue;

  a.bias = static_cast<const __nv_bfloat16*>(b);
  a.wl = static_cast<const __nv_bfloat16*>(wl);
  a.bl = static_cast<const float*>(bl);
  a.out = out;
  a.Do = D - 1, a.Ho = H - 1, a.Wo = W - 1, a.Co = Co, a.L = L;
  a.Cs = Cs, a.n_slices = n_slices;
  a.bz = bz, a.by = by, a.bx = bx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 32: return launch<32>(m, a, B, s);
    case 64: return launch<64>(m, a, B, s);
    case 96: return launch<96>(m, a, B, s);
    case 128: return launch<128>(m, a, B, s);
    case 192: return launch<192>(m, a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xa (B,D,H,W,Ca) and xb (B,D,H,W,Cb; null when Cb = 0) bf16, 16-byte
// aligned.  The weights as the wrapper lays them out (ops/tail.py::
// tail_weights): w32 (8, n32, n_tile, 32) for the 32-channel slices of xa,
// then xb (null if none), w16 (8, n16, n_tile, 16) for their 16-channel
// slices (null if none); bf16, zero past C and Co and where a 32-channel
// slice holds the channel.  b (Co,) bf16.  wl (Co, 2L) bf16 and bl (L,) f32,
// or both null.  out (B, D-1, H-1, W-1, Co) bf16, or (.., L) f32 with
// logits.  n_tile is one of 32/64/96/128/192 (>= Co); the output box
// bz*by*bx is at most 192 voxels.
// All contiguous; shapes are checked by the Python wrapper.
extern "C" int fpl_tail_stage_wgmma(const void* xa, const void* xb,
                                    const void* w32, const void* w16,
                                    const void* b, const void* wl,
                                    const void* bl, void* out, int B, int D,
                                    int H, int W, int Ca, int Cb, int Co,
                                    int L, int n_tile, int bz, int by,
                                    int bx, void* stream) {
  return stage(xa, xb, w32, w16, b, wl, bl, out, B, D, H, W, Ca, Cb, Co, Co,
               1, L, n_tile, bz, by, bx, stream);
}

// The packed engines' conv + bias + ReLU (ops/tail.py::stage_bias_relu): x
// (B,D,H,W,Ci) bf16, 16-byte aligned; the weight images of n_slices slices
// of Cs output channels (ops/tail.py::stage_weights): w32 (n_slices, 8, n32,
// n_tile, 32) and w16 (n_slices, 8, n16, n_tile, 16), each null if the
// input has no such K slice; b (Co,) bf16; out (B, D-1, H-1, W-1, Co) bf16.
// n_tile is one of 32/64/96/128/192 (>= Cs), Cs (n_slices - 1) < Co <= Cs
// n_slices; the output box bz*by*bx is at most 192 voxels.  All contiguous.
extern "C" int fpl_stage_bias_relu_wgmma(const void* x, const void* w32,
                                         const void* w16, const void* b,
                                         void* out, int B, int D, int H,
                                         int W, int Ci, int Co, int Cs,
                                         int n_slices, int n_tile, int bz,
                                         int by, int bx, void* stream) {
  return stage(x, nullptr, w32, w16, b, nullptr, nullptr, out, B, D, H, W, Ci,
               0, Co, Cs, n_slices, 0, n_tile, bz, by, bx, stream);
}
