// K4's bf16 route on Hopper: the Winograd F(2x2x2, 3x3x3) valid conv + bias
// + optional ReLU with its 64 transform-domain products on wgmma, fed by
// TMA, the input transform built in shared memory by the block's own CUDA
// cores and the inverse transform kept in registers (sm_90a).
//
// Replaces, for bf16 x (N,D,H,W,Ci) with D, H, W even, Ci % 8 == 0,
// Co % 8 == 0 and a 16-byte-aligned x, the TPU kernel
// flypylib_tpu/ops/wino_conv.py:240 (wino_conv3d_bias_relu);
// csrc/wino_conv.cu keeps f32 and every other bf16 call.  It computes what
// wino_wmma_kernel there computes, with the reference's rounding points:
//
//   - the input transform B^T x B per axis, z then y then x, each stage one
//     signed sum of two bf16 values rounded to bf16 (__hadd2 on channel
//     pairs, the subtrahend's sign bit flipped: one rounding, as the f32
//     sum rounded once);
//   - the 64 products V_t @ U_t of bf16 values summed in f32, and the +-1
//     inverse transform in f32; then the f32 bias, ReLU and one rounding.
//
// The f32 sums run in another order than the reference's tap order.  For a
// pair (A, B) of z and y transform rows, the x axis of the inverse
// transform is folded into wgmma's own accumulation: the two x phases are
//
//   p0 = V_0 U_0 + V_1 U_1 + V_2 U_2       p1 = V_1 U_1 - V_2 U_2 - V_3 U_3
//
// (taps (A, B, C), C = 0..3; the minus is wgmma's negated A operand), each
// summed over the K steps of one 32-channel slice; p0 and p1 are then added
// to or subtracted from the phase sums acc[gz][gy][0] and acc[gz][gy][1]
// for every (gz, gy) where A^T's coefficients of A and B are not zero, over
// slices, then A, then B.  That is 6 products for 4 taps, and a third of
// the CUDA-core additions of folding tap by tap: with K = Ci as small as 32
// a product value costs the tensor cores less than one f32 addition costs
// the CUDA cores.
//
// The GEMM per tap: M = 2^3 output blocks, N = Co, K = Ci.
// - A block owns tiles of up to 64 output blocks (mz, my, mx; the wrapper
//   picks the tile that covers the block grid in the fewest tiles whose
//   halo fits) and up to 64 output channels (N tile 2 NT = 48 or 64).  Its
//   two warpgroups share the 64 rows and split N: each holds the 8 phase
//   sums of its half, 8 x NT/2 f32 registers a thread, plus p0 and p1.
//   128 rows would need four such warpgroups, 10 x NT/2 registers each, and
//   do not fit the register file; more rows per block is what the
//   registers, not shared memory, refuse.
// - Blocks are persistent, one per SM (shared memory allows one), each
//   walking tiles blockIdx.x, + gridDim.x, ...; per tile the K loop runs
//   over 32-channel slices of Ci (a rest of 1-16 channels as one 16-channel
//   slice ending at channel Ci, ops/conv.py::wgmma_slices), so any Ci runs,
//   the phase sums carried across slices.
// - Per (tile, slice) one TMA load brings the (2mz+2, 2my+2, 2mx+2) voxel
//   halo of the slice's channels into one of two halo buffers (64-byte
//   swizzle; zeros past the volume and past Ci), issued two (tile, slice)
//   pairs ahead.  Per step (A, B) one TMA load brings the four taps' (2 NT x
//   32) slices of U from the K-major images the wrapper lays out
//   (ops/wino_conv.py::wino_images), three steps ahead.  Thread 0
//   issues the loads after the block barrier that frees their buffer.
// - V is built by all 256 threads, one (row, 8-channel vector) each: 16
//   16-byte loads from the halo (4 x positions x the two z and two y
//   positions of rows A and B), 8 + 4 + 4 bf16x2 vector sums, and 4 16-byte
//   stores, one per tap C, in the swizzled K-major layout the wgmma
//   descriptor reads.  V is double-buffered: step s + 1 is built while the
//   tensor cores run step s.
// - Epilogue from registers: the f32 bias, ReLU, one rounding; the quad of
//   lanes that holds a row transposes its bf16 pairs by shuffles so that
//   each lane owns 8 contiguous channels, and the 8 phases go interleaved
//   into NDHWC as 16-byte stores; blocks past the grid and channels past Co
//   are masked.
//
// What bounds it on an H100: at the packed baseline's stage-B shapes the
// bytes (0.15 ms) and the tensor cores (0.10-0.15 ms) are far away; the
// nearer limit is shared-memory traffic: per step the transform's 16 loads
// a thread (the voxel stride of 2 leaves them 2-way bank conflicted) and
// the wgmma operand reads (A and B of an m64n32k16 are each as many bytes
// as its products are clocks).
//
// C entry: fpl_wino_conv_wgmma(...) encodes the tensor maps, launches on the
// given stream and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take); it allocates nothing and does not
// synchronise.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // 2^3 output blocks per tile, at most
constexpr int kThreads = 256;      // two warpgroups
constexpr int kUStages = 3;        // ring of U steps
constexpr int kHaloVoxels = 1100;  // most voxels of a tile's halo
constexpr int kHaloBytes = (kHaloVoxels * kRowBytes + 1023) / 1024 * 1024;
constexpr int kVBytes = 4 * kRows * kRowBytes;  // the four taps of a step

struct WinoMaps {
  CUtensorMap x, x16, u, u16;
};

struct WinoArgs {
  const bf16* bias;  // (Co,)
  bf16* out;         // (N, 2 MD, 2 MH, 2 MW, ldo)
  int MD, MH, MW;    // 2^3 output blocks per axis
  int Co, ldo, relu;
  int n_full, half, c_last;  // 32-channel slices, a 16-channel slice, its start
  int mz, my, mx, tiles_z, tiles_y, tiles_x, n_tiles;
};

// A^T = [[1,1,1,0], [0,1,-1,-1]]: coefficient of transform row r in phase p
__device__ __forceinline__ int at_coef(int p, int r) {
  return p == 0 ? (r < 3 ? 1 : 0) : (r == 0 ? 0 : (r == 1 ? 1 : -1));
}

// D (64 x N, f32) = SA * A (64 x 16) * B (16 x N) + (scale_d ? D : 0), SA
// = 1 or -1, A and B K-major bf16 in shared memory
template <int N, int SA>
__device__ __forceinline__ void wgmma_signed(float (&d)[N / 2], uint64_t da,
                                             uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_signed<24, 1>(float (&d)[12], uint64_t da,
                                                    uint64_t db, int scale_d) {
  wgmma_bf16<24>(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_signed<32, 1>(float (&d)[16], uint64_t da,
                                                    uint64_t db, int scale_d) {
  wgmma_bf16<32>(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_signed<24, -1>(float (&d)[12],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, -1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_signed<32, -1>(float (&d)[16],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, -1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// a + b or a - b on four bf16 pairs, each sum rounded to bf16 once
__device__ __forceinline__ uint4 vsum(uint4 a, uint4 b, uint32_t flip) {
  auto one = [flip](uint32_t p, uint32_t q) {
    q ^= flip;  // the sign bits of both halves: -q, exactly
    const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                     *reinterpret_cast<const __nv_bfloat162*>(&q));
    return *reinterpret_cast<const uint32_t*>(&r);
  };
  return make_uint4(one(a.x, b.x), one(a.y, b.y), one(a.z, b.z), one(a.w, b.w));
}

// Row r of B^T = [[1,0,-1,0], [0,1,1,0], [0,-1,1,0], [0,1,0,-1]] is
// v[first] +- v[second], spelled as the reference's _bt_combine spells it:
// v0 - v2, v1 + v2, v2 - v1, v1 - v3
__device__ __forceinline__ int bt_first(int r) { return r == 0 ? 0 : (r == 2 ? 2 : 1); }
__device__ __forceinline__ int bt_second(int r) { return r == 2 ? 1 : (r == 3 ? 3 : 2); }
__device__ __forceinline__ uint32_t bt_flip(int r) { return r == 1 ? 0u : 0x80008000u; }

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// byte offset of 16-byte chunk j of row `row` in a K-major tile of ROW-byte
// rows with the swizzle of that width (tile on a 1024-byte boundary)
template <int ROW>
__device__ __forceinline__ uint32_t swz(int row, int j) {
  return ROW == 64 ? row * 64 + ((j ^ ((row >> 1) & 3)) << 4)
                   : row * 32 + ((j ^ ((row >> 2) & 1)) << 4);
}

// V of step (A, B) for one slice of ROW / 2 channels: the calling thread's
// (row, vector) item, its halo corner at voxel v0.  Rows two voxels apart
// lie a multiple of 128 bytes apart, so the lanes of a quarter-warp would
// meet in half of the banks: every other row (`odd`) reads its four x
// positions in the order 1, 0, 3, 2 and swaps them back in registers.
template <int ROW>
__device__ __forceinline__ void build_v(uint32_t halo, uint32_t vbuf, int A,
                                        int B, int row, int j, int v0,
                                        bool odd, int hx, int hxy) {
  const int za = bt_first(A) * hxy, zb = bt_second(A) * hxy;
  const int ya = bt_first(B) * hx, yb = bt_second(B) * hx;
  const uint32_t fa = bt_flip(A), fb = bt_flip(B);
  uint4 t2[4];
#pragma unroll
  for (int px = 0; px < 4; ++px) {
    const int v = v0 + (px ^ (int)odd);
    const uint4 t1a = vsum(lds128(halo + swz<ROW>(v + za + ya, j)),
                           lds128(halo + swz<ROW>(v + zb + ya, j)), fa);
    const uint4 t1b = vsum(lds128(halo + swz<ROW>(v + za + yb, j)),
                           lds128(halo + swz<ROW>(v + zb + yb, j)), fa);
    t2[px] = vsum(t1a, t1b, fb);
  }
  if (odd) {
    uint4 t = t2[0];
    t2[0] = t2[1], t2[1] = t;
    t = t2[2];
    t2[2] = t2[3], t2[3] = t;
  }
  constexpr int kTap = kRows * ROW;
  sts128(vbuf + 0 * kTap + swz<ROW>(row, j), vsum(t2[0], t2[2], 0x80008000u));
  sts128(vbuf + 1 * kTap + swz<ROW>(row, j), vsum(t2[1], t2[2], 0u));
  sts128(vbuf + 2 * kTap + swz<ROW>(row, j), vsum(t2[2], t2[1], 0x80008000u));
  sts128(vbuf + 3 * kTap + swz<ROW>(row, j), vsum(t2[1], t2[3], 0x80008000u));
}

// the six products of a step for one warpgroup's NT columns
template <int NT, int ROW>
__device__ __forceinline__ void products(float (&p0)[NT / 2], float (&p1)[NT / 2],
                                         uint32_t vbuf, uint32_t ubuf,
                                         int u_tap) {
  constexpr int kTap = kRows * ROW;
#pragma unroll
  for (int ks = 0; ks < ROW / 32; ++ks) {
    uint64_t da[4], db[4];
#pragma unroll
    for (int C = 0; C < 4; ++C) {
      da[C] = desc_k<ROW>(vbuf + C * kTap) + 2 * ks;
      db[C] = desc_k<ROW>(ubuf + C * u_tap) + 2 * ks;
    }
    wgmma_signed<NT, 1>(p0, da[0], db[0], ks > 0);
    wgmma_signed<NT, 1>(p1, da[1], db[1], ks > 0);
    wgmma_signed<NT, 1>(p0, da[1], db[1], 1);
    wgmma_signed<NT, -1>(p1, da[2], db[2], 1);
    wgmma_signed<NT, 1>(p0, da[2], db[2], 1);
    wgmma_signed<NT, -1>(p1, da[3], db[3], 1);
  }
}

struct Tile {
  int n, iz0, iy0, ix0;
};

__device__ __forceinline__ Tile tile_of(int t, const WinoArgs& a) {
  Tile b;
  b.ix0 = (t % a.tiles_x) * a.mx;
  t /= a.tiles_x;
  b.iy0 = (t % a.tiles_y) * a.my;
  t /= a.tiles_y;
  b.iz0 = (t % a.tiles_z) * a.mz;
  b.n = t / a.tiles_z;
  return b;
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
wino_wgmma_kernel(const __grid_constant__ WinoMaps tm,
                  const __grid_constant__ WinoArgs a) {
  constexpr int kUTap = 2 * NT * kRowBytes;  // one tap's U slice (64-byte rows)
  constexpr int kUBytes = 4 * kUTap;
  static_assert(kUTap % 1024 == 0, "tap slices on 1024-byte boundaries");

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t u_full[kUStages];
  __shared__ __align__(8) uint64_t h_full[2];
  __shared__ float bias_s[2 * NT];
  // the swizzle patterns repeat every 512 bytes: align every buffer to 1024
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t halo0 = base;
  const uint32_t v0buf = base + 2 * kHaloBytes;
  const uint32_t u0buf = v0buf + 2 * kVBytes;

  const int tid = threadIdx.x;
  const int warp_id = uniform_warp_index();
  const int wg = warp_id / 4, lane = tid & 31;
  const int n_sl = a.n_full + a.half;
  const int my_tiles = (a.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int hx = 2 * a.mx + 2, hy = 2 * a.my + 2, hz = 2 * a.mz + 2;
  const int hxy = hx * hy, hvox = hxy * hz;
  const int rows = a.mz * a.my * a.mx;

  if (tid == 0) {
    for (int s = 0; s < kUStages; ++s) mbar_init(smem_u32(&u_full[s]), 1);
    mbar_init(smem_u32(&h_full[0]), 1);
    mbar_init(smem_u32(&h_full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (a.n_full) prefetch_map(&tm.x), prefetch_map(&tm.u);
    if (a.half) prefetch_map(&tm.x16), prefetch_map(&tm.u16);
  }
  for (int i = tid; i < 2 * NT; i += kThreads)
    bias_s[i] = i < a.Co ? __bfloat162float(a.bias[i]) : 0.f;
  __syncthreads();

  // the loads, all issued by thread 0: the halo of slice sl of the block's
  // tile number ti into halo buffer hb, and the four U slices of step ab
  // (= 4 A + B) of slice sl into U stage us
  auto issue_halo = [&](int ti, int sl, int hb) {
    const Tile t = tile_of((int)blockIdx.x + ti * (int)gridDim.x, a);
    const bool full = sl < a.n_full;
    const uint32_t bar = smem_u32(&h_full[hb]);
    mbar_expect_tx(bar, (uint32_t)(hvox * (full ? kRowBytes : kRowBytes / 2)));
    tma_load_5d(halo0 + hb * kHaloBytes, full ? &tm.x : &tm.x16, bar,
                full ? sl * kKC : a.c_last, 2 * t.ix0, 2 * t.iy0, 2 * t.iz0,
                t.n);
  };
  auto issue_u = [&](int sl, int ab, int us) {
    const bool full = sl < a.n_full;
    const uint32_t bar = smem_u32(&u_full[us]);
    const uint32_t dst = u0buf + us * kUBytes;
    mbar_expect_tx(bar, (uint32_t)(4 * 2 * NT *
                                   (full ? kRowBytes : kRowBytes / 2)));
    // one box of 4 x 2 NT rows: the images keep a step's four taps together
    tma_load_2d(dst, full ? &tm.u : &tm.u16, bar, 0,
                (full ? ab * a.n_full + sl : ab) * 4 * 2 * NT);
  };
  if (tid == 0) {
    issue_halo(0, 0, 0);
    if (n_sl > 1) issue_halo(0, 1, 1);
    else if (my_tiles > 1) issue_halo(1, 0, 1);
    for (int ab = 0; ab < kUStages; ++ab) issue_u(0, ab, ab);
  }

  // the thread's item of V, for 32-channel slices (row tid / 4, vector
  // tid % 4) and for the 16-channel slice (row tid / 2, vector tid % 2;
  // threads 128-255 idle): the row and the halo voxel of its corner.  A row
  // past the tile reads the first row's halo; nothing of it is stored.
  auto corner = [&](int row) {
    if (row >= rows) row = 0;
    const int ix = row % a.mx, iy = (row / a.mx) % a.my, iz = row / (a.mx * a.my);
    return (2 * iz * hy + 2 * iy) * hx + 2 * ix;
  };
  const int row32 = tid >> 2, row16 = (tid >> 1) & 63;
  const int c32 = corner(row32), c16 = corner(row16);
  auto build = [&](bool full, int hb, int vb, int A, int B) {
    const uint32_t halo = halo0 + hb * kHaloBytes;
    const uint32_t vbuf = v0buf + vb * kVBytes;
    if (full) {
      build_v<64>(halo, vbuf, A, B, row32, tid & 3, c32, row32 & 1, hx, hxy);
    } else if (wg == 0) {
      build_v<32>(halo, vbuf, A, B, row16, tid & 1, c16, (row16 >> 1) & 1, hx,
                  hxy);
    }
    // the writes above, made through the generic proxy, before the wgmma
    // that reads them through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  // the thread's fragment rows (h = 0, 1) and their 2^3 blocks in the tile
  const int g4 = lane >> 2, q4 = lane & 3;
  int rz[2], ry[2], rx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (warp_id % 4) * 16 + h * 8 + g4;
    rx[h] = r % a.mx, ry[h] = (r / a.mx) % a.my, rz[h] = r / (a.mx * a.my);
  }

  float acc[8][NT / 2];
  float p0[NT / 2], p1[NT / 2];

  mbar_wait(smem_u32(&h_full[0]), 0);
  build(a.n_full > 0, 0, 0, 0, 0);
  asm volatile("bar.sync 1, 256;" ::: "memory");

  int q = 0;             // (tile, slice) pairs done: halo buffer q & 1
  int us = 0, vb = 0;    // the step's U stage and V buffer
  uint32_t u_phase = 0;  // parity of the U stage's barrier
  for (int ti = 0; ti < my_tiles; ++ti) {
    for (int sl = 0; sl < n_sl; ++sl, ++q) {
      const bool full = sl < a.n_full;
      const bool last_q = ti == my_tiles - 1 && sl == n_sl - 1;
      const int sl1 = sl + 1 < n_sl ? sl + 1 : 0;  // the slice after this one
      if (sl == 0) {
#pragma unroll
        for (int ph = 0; ph < 8; ++ph)
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) acc[ph][i] = 0.f;
      }
      for (int ab = 0; ab < 16; ++ab) {
        {
          const int A = ab >> 2, B = ab & 3;
          mbar_wait(smem_u32(&u_full[us]), u_phase);
          const uint32_t vbuf = v0buf + vb * kVBytes;
          const uint32_t ubuf = u0buf + us * kUBytes;
          fence_acc(p0);
          fence_acc(p1);
          wgmma_fence();
          if (full)
            products<NT, 64>(p0, p1, vbuf, ubuf + wg * NT * kRowBytes, kUTap);
          else
            products<NT, 32>(p0, p1, vbuf, ubuf + wg * NT * (kRowBytes / 2),
                             kUTap / 2);
          wgmma_commit();

          // the next step's V, under this step's products
          if (B < 3) {
            build(full, q & 1, vb ^ 1, A, B + 1);
          } else if (A < 3) {
            build(full, q & 1, vb ^ 1, A + 1, 0);
          } else if (!last_q) {
            mbar_wait(smem_u32(&h_full[(q + 1) & 1]), ((q + 1) >> 1) & 1);
            build(sl1 < a.n_full, (q + 1) & 1, vb ^ 1, 0, 0);
          }

          wgmma_wait<0>();
          fence_acc(p0);
          fence_acc(p1);

          // the z and y axes of the inverse transform, in registers
#pragma unroll
          for (int gz = 0; gz < 2; ++gz) {
            const int cz = at_coef(gz, A);
            if (cz == 0) continue;
#pragma unroll
            for (int gy = 0; gy < 2; ++gy) {
              const int cy = at_coef(gy, B);
              if (cy == 0) continue;
              const float coef = (float)(cz * cy);
#pragma unroll
              for (int i = 0; i < NT / 2; ++i) {
                acc[(gz * 2 + gy) * 2][i] =
                    fmaf(coef, p0[i], acc[(gz * 2 + gy) * 2][i]);
                acc[(gz * 2 + gy) * 2 + 1][i] =
                    fmaf(coef, p1[i], acc[(gz * 2 + gy) * 2 + 1][i]);
              }
            }
          }

          if (A == 3 && B == 3 && sl == n_sl - 1) {
            // ----------------------------------------------------- epilogue
            // the thread holds, of rows r0 and r0 + 8, channels 8 j + 2 q4
            // and + 1 of its warpgroup's half for every j:
            // acc[ph][4 j + 2 h + e]
            const Tile t = tile_of((int)blockIdx.x + ti * (int)gridDim.x, a);
            const int Do = 2 * a.MD, Ho = 2 * a.MH, Wo = 2 * a.MW;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int bz = t.iz0 + rz[h], by = t.iy0 + ry[h],
                        bx = t.ix0 + rx[h];
              const bool live = rz[h] < a.mz && bz < a.MD && by < a.MH &&
                                bx < a.MW && wg * NT + 8 * q4 < a.Co &&
                                8 * q4 < NT;
#pragma unroll
              for (int ph = 0; ph < 8; ++ph) {
                // the row's values as bf16 pairs, then a 4 x 4 transpose
                // across the quad of lanes that holds the row, after which
                // lane q4 holds channels 8 q4 .. 8 q4 + 7: one 16-byte store
                uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int j = 0; j < NT / 8; ++j) {
                  const int col = wg * NT + j * 8 + q4 * 2;
                  float y0 = acc[ph][4 * j + 2 * h] + bias_s[col];
                  float y1 = acc[ph][4 * j + 2 * h + 1] + bias_s[col + 1];
                  if (a.relu) y0 = fmaxf(y0, 0.f), y1 = fmaxf(y1, 0.f);
                  const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
                  w[j] = *reinterpret_cast<const uint32_t*>(&y);
                }
#pragma unroll
                for (int bit = 1; bit <= 2; bit <<= 1) {
                  const bool hi = q4 & bit;
#pragma unroll
                  for (int k = 0; k < 2; ++k) {
                    // bit 1 swaps words (0, 1) and (2, 3), bit 2 (0, 2) and (1, 3)
                    const int lo_w = bit == 1 ? 2 * k : k, hi_w = lo_w + bit;
                    const uint32_t got = __shfl_xor_sync(
                        0xffffffffu, hi ? w[lo_w] : w[hi_w], bit);
                    if (hi) w[lo_w] = got;
                    else w[hi_w] = got;
                  }
                }
                if (live) {
                  bf16* o = a.out +
                            ((((long long)t.n * Do + 2 * bz + (ph >> 2)) * Ho +
                              2 * by + ((ph >> 1) & 1)) * Wo + 2 * bx +
                             (ph & 1)) * a.ldo + wg * NT + 8 * q4;
                  *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
                }
              }
            }
          }

          // every thread has built the next step's V and is done with this
          // step's V and U stage and, after (A, B) = (3, 2), with the halo
          asm volatile("bar.sync 1, 256;" ::: "memory");
          if (tid == 0) {
            // U of the step three ahead, into the stage just freed
            const int ab3 = 4 * A + B + kUStages;
            if (ab3 < 16) issue_u(sl, ab3, us);
            else if (!last_q) issue_u(sl1, ab3 - 16, us);
            if (A == 3 && B == 2) {  // the halo two (tile, slice) pairs ahead
              int ti2 = ti, sl2 = sl + 2;
              while (sl2 >= n_sl) sl2 -= n_sl, ++ti2;
              if (ti2 < my_tiles) issue_halo(ti2, sl2, q & 1);
            }
          }
          vb ^= 1;
          if (++us == kUStages) us = 0, u_phase ^= 1;
        }
      }
    }
  }
}

template <int NT>
int launch(const WinoMaps& m, WinoArgs a, int N, cudaStream_t stream) {
  constexpr int kSmem =
      2 * kHaloBytes + 2 * kVBytes + kUStages * 4 * 2 * NT * kRowBytes + 1024;
  auto kernel = wino_wgmma_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  a.tiles_z = (a.MD + a.mz - 1) / a.mz;
  a.tiles_y = (a.MH + a.my - 1) / a.my;
  a.tiles_x = (a.MW + a.mx - 1) / a.mx;
  const long long tiles = (long long)N * a.tiles_z * a.tiles_y * a.tiles_x;
  // the kernel counts its (tile, slice) pairs in an int
  if (tiles * (a.n_full + a.half) > 0x7fffffffLL || sms < 1)
    return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)tiles;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmem, stream>>>(m, a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x (N,D,H,W,Ci) bf16, 16-byte aligned, D, H, W even.  The transform-domain
// weights as the wrapper lays them out (ops/wino_conv.py::wino_images of the
// (64, Ci, Co) block of U): u32 (16, n_full, 4, n_tile, 32), step (A, B),
// slice, tap C, for the 32-channel slices (null if none), u16 (64, n_tile,
// 16), tap 16 A + 4 B + C, for the 16-channel slice that
// holds a rest of 1-16 channels (null if none); bf16, zero past Ci and Co
// and where a 32-channel slice holds the channel.  b (Co,) bf16; out
// (N, D-2, H-2, W-2, ldo) bf16, of which the call writes Co channels
// starting at `out` (ldo >= Co, a multiple of 8: a layer wider than 64
// channels runs as one call per block of output channels).  n_tile is 48 or
// 64 (>= Co); a tile is (mz, my, mx) 2^3 output blocks, at most 64, its halo
// (2mz+2)(2my+2)(2mx+2) at most 1100 voxels.  All contiguous; shapes are
// checked by the Python wrapper (flypylib_tpu_torch/ops/wino_conv.py).
extern "C" int fpl_wino_conv_wgmma(const void* x, const void* u32,
                                   const void* u16, const void* b, void* out,
                                   int N, int D, int H, int W, int Ci, int Co,
                                   int ldo, int relu, int n_tile, int mz,
                                   int my, int mx, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  WinoArgs a = {};
  const int rest = Ci % kKC;
  a.half = rest > 0 && rest <= kKC / 2;
  a.n_full = Ci / kKC + (rest > kKC / 2);
  a.c_last = Ci > kKC / 2 ? Ci - kKC / 2 : 0;
  const int hz = 2 * mz + 2, hy = 2 * my + 2, hx = 2 * mx + 2;
  if (N < 1 || D < 4 || H < 4 || W < 4 || D % 2 || H % 2 || W % 2 || Ci < 8 ||
      Ci % 8 || Co < 8 || Co % 8 || Co > n_tile || ldo < Co || ldo % 8 ||
      mz < 1 || my < 1 || mx < 1 || (long long)mz * my * mx > kRows ||
      (long long)hz * hy * hx > kHaloVoxels || !aligned16(x) ||
      !aligned16(out) ||
      (a.n_full > 0 && (u32 == nullptr || !aligned16(u32))) ||
      (a.half && (u16 == nullptr || !aligned16(u16))))
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  WinoMaps m = {};  // a map the call does not use stays zero and is never read
  bool ok = true;
  if (a.n_full)
    ok = encode_x(encode, &m.x, x, N, D, H, W, Ci, kKC, hz, hy, hx) &&
         encode_w(encode, &m.u, u32, 64 * a.n_full * n_tile, kKC, 4 * n_tile);
  if (a.half)
    ok = ok && encode_x(encode, &m.x16, x, N, D, H, W, Ci, kKC / 2, hz, hy, hx) &&
         encode_w(encode, &m.u16, u16, 64 * n_tile, kKC / 2, 4 * n_tile);
  if (!ok) return (int)cudaErrorInvalidValue;

  a.bias = static_cast<const bf16*>(b);
  a.out = static_cast<bf16*>(out);
  a.MD = (D - 2) / 2, a.MH = (H - 2) / 2, a.MW = (W - 2) / 2;
  a.Co = Co, a.ldo = ldo, a.relu = relu ? 1 : 0;
  a.mz = mz, a.my = my, a.mx = mx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 48: return launch<24>(m, a, N, s);
    case 64: return launch<32>(m, a, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
