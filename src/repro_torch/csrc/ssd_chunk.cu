// Mamba-2 SSD chunk scan: y and the final (N, P) state of every (batch, head).
//
// Replaces: repro/kernels/ssd/kernel.py::ssd_pallas (the TPU kernel, :66,
// grid (B*H, chunks) with the (N, P) state carried in VMEM scratch across the
// sequential chunk axis), computing what repro/kernels/ssd/ref.py
// ::ssd_chunked_ref returns, the final state included.  Per chunk of Q
// positions, all in f32:
//   la     = cumsum(dt) * a                        (inclusive, within the chunk)
//   scores = (C Bᵀ) ⊙ exp(la_i − la_j) [i ≥ j]
//   y      = scores (dt ⊙ x) + (C ⊙ exp(la)) h + D x
//   h      = exp(la_Q) h + (B ⊙ exp(la_Q − la) dt)ᵀ x
//
// Bound on this card: bytes.  At the zamba2 path's shape (B 4, S 1024, H 64,
// P 64, N 64, chunk 128, bf16 x, B and C) the function reads x, B and C in
// bf16 and dt in f32, and writes y and the final state in f32: 107 MB, 0.032
// ms at 3.35 TB/s, against 13 GFLOP of tensor-core products (0.013 ms at 989
// TFLOP/s; C·Bᵀ once per (b, chunk, group), three products split in two)
// and 17 M exps (0.004 ms).  The three passes below move ~270 MB (the chunk
// states go out and back twice), so ~0.08 ms is this design's floor.
//
// Design: the Mamba-2 paper's chunked decomposition for GPUs (arXiv:2405.21060
// §6: chunk states, state passing, chunk scan), three kernels on one stream.
// One call of the wrapper launches all three and counts once.
//   1. ssd_chunk_state_kernel, one block per (b, chunk, tile of HT heads of
//      one group).  la per head is a warp scan, one warp a head, all heads of
//      the tile at once.  The chunk's own state s_c = Bᵀ diag(w) X with
//      w = exp(la_Q − la) dt, (N, P) per head, goes to the f32 scratch
//      (B, chunks, H, N, P); la_Q to (B, chunks, H).
//   2. ssd_chunk_pass_kernel, one thread per four elements of (b, h, N·P)
//      (float4), walks the chunks in order, h ← exp(la_Q,c) h + s_c, and
//      writes the state entering each chunk in place of s_c (eight chunks'
//      loads in flight at once), and the final state (B, H, N, P) for the
//      decode cache.  For bf16 it writes each entering state row as bf16
//      hi = bf16(h) then lo = bf16(h − hi), in the row's own 4P bytes (one
//      barrier a batch of chunks orders the row's reads before its writes).
//   3. ssd_chunk_scan_kernel, one block per (b, chunk, tile of HT heads).
//      G = C·Bᵀ once for the tile, the lower triangle only, in 16 x 16 tiles
//      stored in mma accumulator order.  Per head: y = exp(la_i) (C·h_in)
//      + S' X + D x with S' = G ⊙ exp(la_i − la_j) [i ≥ j] ⊙ dt_j built in
//      registers from G; y written once, in f32.  A warp owns a pair of
//      16-row tiles (r, RT−1−r), so the causal triangle's work is even, by
//      32 columns of y; the pair shares its h_in and X fragments.
// Loads are cp.async into shared memory (zero fill past Q, N and P), B, C
// and dt first, then the per-head tiles (X, and h_in in pass 3) in a ring of
// stages, so the next head's tiles arrive while this one computes.  Pass 1
// takes two stages; pass 3 two, or one where that lets two blocks share an
// SM (bf16 at N 64) or two do not fit, and its B tile sits behind the ring
// until G is built (kernels/ssd/kernel.py::smem_plan holds the same
// arithmetic).  x, B and C may be strided views with the last dimension
// contiguous (the model's slices of xBC, read in place).
//
// chip_smoke.py prints each pass's device time at the path's shape; PERF.md
// keeps them.
//
// bf16 operands (every model path) run their products on the tensor cores,
// mma.sync m16n8k16 with f32 accumulators, and keep the reference's f32
// numerics: a product of exact bf16 values is one product (C·Bᵀ); an f32
// factor v is split as hi = bf16(v), lo = bf16(v − hi) (v to ~2^-17) and
// costs two: S'·X, C·h_in (h_in split by pass 2), Bᵀ·(w ⊙ X).  Fragments come
// from shared memory by ldmatrix (.trans where the operand is stored
// K-major), and S' goes from the G accumulator layout to the A operand in
// registers.  f32 operands run the same three passes with every product an
// f32 FMA on the CUDA cores (no TF32: the repo's rule), each thread owning the
// elements the mma fragment would give it; S' passes through a per-warp 16 x
// 16 scratch tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 256, NW = NT / 32;   // 8 warps a block in passes 1 and 3
constexpr int SCR = 20;                 // row stride of the f32 S' scratch tile
constexpr int PASS_BATCH = 8;           // chunks whose loads pass 2 keeps in flight

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* dv;
  float* y;
  float* hout;
  float* st;    // (B, chunks, H, N, P) f32: s_c, then the state entering chunk c
  float* laq;   // (B, chunks, H): la at the chunk's last position
  int64_t s, heads, groups, nc;
  int64_t xsb, xss, xsh, bsb, bss, bsg, csb, css, csg;   // element strides
  int p, n, q, ht, stages;
};

// Shared memory of passes 1 and 3, in bytes (kernels/ssd/kernel.py::smem_plan
// computes the same).  Tiles are padded to 16 rows and columns; a row is
// 8 bf16 (or 4 f32) longer, so ldmatrix rows and the f32 loads of 8 rows hit
// distinct banks.
struct Layout {
  int e, q16, n16, p16, sn, sp, rt, ntile;
  __host__ __device__ Layout(int eb, int q, int p, int n) : e(eb) {
    q16 = (q + 15) / 16 * 16;
    n16 = (n + 15) / 16 * 16;
    p16 = (p + 15) / 16 * 16;
    const int pad = eb == 2 ? 8 : 4;
    sn = n16 + pad;
    sp = p16 + pad;
    rt = q16 / 16;
    ntile = rt * (rt + 1) / 2;
  }
  __host__ __device__ int tile_n() const { return q16 * sn * e; }   // B or C (Q, N)
  __host__ __device__ int tile_x() const { return q16 * sp * e; }   // X (Q, P)
  __host__ __device__ int tile_h() const { return (e == 2 ? 2 : 1) * n16 * sp * e; }
  __host__ __device__ int ladt(int ht) const { return 2 * ht * q16 * 4; }
  __host__ __device__ int gbytes() const { return ntile * 256 * 4; }
  __host__ __device__ int scratch() const { return e == 4 ? NW * 16 * SCR * 4 : 0; }
  __host__ __device__ int pass1(int ht, int stages) const {
    return tile_n() + ladt(ht) + stages * tile_x();
  }
  __host__ __device__ int region3(int stages) const {
    const int r = stages * (tile_x() + tile_h());
    return r > tile_n() ? r : tile_n();
  }
  __host__ __device__ int pass3(int ht, int stages) const {
    return tile_n() + gbytes() + ladt(ht) + scratch() + region3(stages);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most ``pending`` (0..3) of this thread's newest groups are in
// flight, then make every thread's copies visible to the block.
__device__ __forceinline__ void wait_groups(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
  __syncthreads();
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// acc (16 x 8, f32) += A (16 x 16, bf16) · B (16 x 8, bf16).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) -> hi = bf16(u, v), lo = bf16(u - hi, v - hi); u in the low half.
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// A bf16 pair scaled by two f32 weights, split as above.
__device__ __forceinline__ void split_scaled(uint32_t pair, float2 w, uint32_t& hi,
                                             uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pair));
  split2(f.x * w.x, f.y * w.y, hi, lo);
}

// Rows [0, rows16) x columns [0, cols16) of a shared tile from a global
// (rows, cols) block with row stride ``sstride``, by 16-byte cp.async; rows
// past ``rows`` and columns past ``cols`` (a multiple of 16 bytes) are zero.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dstride, const T* src, int64_t sstride,
                                          int rows, int rows16, int cols, int cols16) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = cols16 / V;
  for (int idx = threadIdx.x; idx < rows16 * cpr; idx += NT) {
    const int r = idx / cpr, c = (idx - r * cpr) * V;
    T* d = dst + r * dstride + c;
    if (r < rows && c < cols)
      cp_async16(d, src + r * sstride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// dt of the tile's heads at the chunk's positions, (HT, Q16), 0 past Q, by
// 4-byte cp.async.
__device__ __forceinline__ void load_dt(float* dts, const Params& P, int64_t b, int64_t s0,
                                        int64_t h0, int q16) {
  for (int idx = threadIdx.x; idx < P.ht * q16; idx += NT) {
    const int k = idx / q16, i = idx - k * q16;
    if (i < P.q)
      cp_async4(dts + idx, P.dt + (b * P.s + s0 + i) * P.heads + h0 + k);
    else
      dts[idx] = 0.f;
  }
}

// la[i] = a (dt[0] + ... + dt[i]) for i < q16, by one warp: each lane sums a
// run of up to four positions, then a shuffle scan over the lanes.  Positions
// past Q add dt = 0, so they repeat la[Q - 1].
__device__ __forceinline__ void warp_cumsum(const float* dts, float* la, float av, int q16,
                                            int lane) {
  const int per = (q16 + 31) / 32;
  float v[4], run = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = lane * per + t;
    if (t < per && i < q16) run += dts[i];
    v[t] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += u;
  }
  float before = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = lane * per + t;
    if (t < per && i < q16) la[i] = (v[t] + before) * av;
  }
}

struct Tile {   // the (b, chunk, head tile) of a block of passes 1 and 3
  int64_t b, c, h0, g, s0;
  __device__ Tile(const Params& P) {
    const int64_t ntile_h = P.heads / P.ht, blk = blockIdx.x;
    h0 = (blk % ntile_h) * P.ht;
    c = (blk / ntile_h) % P.nc;
    b = blk / ntile_h / P.nc;
    g = h0 / (P.heads / P.groups);
    s0 = c * P.q;
  }
};

// S' = G ⊙ exp(la_i − la_j) [i ≥ j] ⊙ dt_j of row tile r at key tile kb, in
// G's accumulator layout: (i0, j0), (i0, j0+1), (i1, j0), (i1, j0+1), then the
// same at j0 + 8, with i0 = 16r + lane/4, i1 = i0 + 8, j0 = 16kb + 2 (lane%4).
// ``lr`` holds la at i0 and i1.  Entries above the diagonal are exactly 0.
__device__ __forceinline__ void sprime(float sv[8], const float* gs, const float* la,
                                       const float* dtk, int r, int kb, const float lr[2],
                                       int lane) {
  const int gq = lane >> 2, jl = 2 * (lane & 3), j0 = kb * 16 + jl;
  const float* gt = gs + (r * (r + 1) / 2 + kb) * 256 + lane * 4;
  const float4 g0 = *reinterpret_cast<const float4*>(gt);
  const float4 g1 = *reinterpret_cast<const float4*>(gt + 128);
  const float2 lj0 = *reinterpret_cast<const float2*>(la + j0);
  const float2 lj8 = *reinterpret_cast<const float2*>(la + j0 + 8);
  const float2 dj0 = *reinterpret_cast<const float2*>(dtk + j0);
  const float2 dj8 = *reinterpret_cast<const float2*>(dtk + j0 + 8);
  sv[0] = g0.x * __expf(lr[0] - lj0.x) * dj0.x;
  sv[1] = g0.y * __expf(lr[0] - lj0.y) * dj0.y;
  sv[2] = g0.z * __expf(lr[1] - lj0.x) * dj0.x;
  sv[3] = g0.w * __expf(lr[1] - lj0.y) * dj0.y;
  sv[4] = g1.x * __expf(lr[0] - lj8.x) * dj8.x;
  sv[5] = g1.y * __expf(lr[0] - lj8.y) * dj8.y;
  sv[6] = g1.z * __expf(lr[1] - lj8.x) * dj8.x;
  sv[7] = g1.w * __expf(lr[1] - lj8.y) * dj8.y;
  if (kb == r) {   // the diagonal tile: j <= i only
    if (jl > gq) sv[0] = 0.f;
    if (jl + 1 > gq) sv[1] = 0.f;
    if (jl > gq + 8) sv[2] = 0.f;
    if (jl + 1 > gq + 8) sv[3] = 0.f;
    if (jl + 8 > gq) sv[4] = 0.f;
    if (jl + 9 > gq) sv[5] = 0.f;
    if (jl + 8 > gq + 8) sv[6] = 0.f;
    if (jl + 9 > gq + 8) sv[7] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// Pass 1: the chunk's own state s_c = Bᵀ diag(w) X, w = exp(la_Q − la) dt.
// A warp owns 32 state rows (two 16-row tiles of N) by 16 columns of P.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_state_kernel(Params P) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(sizeof(T), P.q, P.p, P.n);
  T* bs = reinterpret_cast<T*>(smem);
  float* dts = reinterpret_cast<float*>(smem + L.tile_n());
  float* ws = dts + P.ht * L.q16;   // la, then w, of each head
  unsigned char* ring = smem + L.tile_n() + L.ladt(P.ht);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const Tile tl(P);
  const T* xg = static_cast<const T*>(P.x) + tl.b * P.xsb + tl.s0 * P.xss;

  // Groups in order: B and dt, then one per head, ``queued`` of them.
  load_tile(bs, L.sn, static_cast<const T*>(P.bm) + tl.b * P.bsb + tl.s0 * P.bss + tl.g * P.bsg,
            P.bss, P.q, L.q16, P.n, L.n16);
  load_dt(dts, P, tl.b, tl.s0, tl.h0, L.q16);
  cp_async_commit();
  auto load_head = [&](int k) {
    load_tile(reinterpret_cast<T*>(ring + (k % P.stages) * L.tile_x()), L.sp,
              xg + (tl.h0 + k) * P.xsh, P.xss, P.q, L.q16, P.p, L.p16);
    cp_async_commit();
  };
  int queued = 0;
  for (; queued < P.stages && queued < P.ht; ++queued) load_head(queued);
  wait_groups(queued);
  for (int k = warp; k < P.ht; k += NW) {
    float* la = ws + k * L.q16;
    const float* dk = dts + k * L.q16;
    warp_cumsum(dk, la, P.a[tl.h0 + k], L.q16, lane);
    __syncwarp();
    const float la_q = la[P.q - 1];
    __syncwarp();
    for (int i = lane; i < L.q16; i += 32) la[i] = i < P.q ? __expf(la_q - la[i]) * dk[i] : 0.f;
    if (lane == 0) P.laq[(tl.b * P.nc + tl.c) * P.heads + tl.h0 + k] = la_q;
  }

  const int ps_n = L.p16 / 16, mt = L.n16 / 16, units = ps_n * ((mt + 1) / 2);
  for (int k = 0; k < P.ht; ++k) {
    wait_groups(queued - k - 1);
    const T* xs = reinterpret_cast<const T*>(ring + (k % P.stages) * L.tile_x());
    const float* w = ws + k * L.q16;
    float* out = P.st + ((tl.b * P.nc + tl.c) * P.heads + tl.h0 + k) * (int64_t)P.n * P.p;
    for (int u = warp; u < units; u += NW) {
      const int ps = u % ps_n, mg = u / ps_n, pc = ps * 16;
      float acc[2][2][4] = {};
      for (int kb = 0; kb < L.rt; ++kb) {
        const int j0 = kb * 16;
        if constexpr (BF) {
          uint32_t bx[4], bh[4], bl[4];
          ldsm_x4_t(bx, xs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.sp + pc +
                            (lane >> 4) * 8);
          const float2 wa = *reinterpret_cast<const float2*>(w + j0 + 2 * tg);
          const float2 wb = *reinterpret_cast<const float2*>(w + j0 + 8 + 2 * tg);
          split_scaled(bx[0], wa, bh[0], bl[0]);
          split_scaled(bx[1], wb, bh[1], bl[1]);
          split_scaled(bx[2], wa, bh[2], bl[2]);
          split_scaled(bx[3], wb, bh[3], bl[3]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int m = mg * 2 + mi;
            if (m >= mt) continue;
            uint32_t af[4];
            ldsm_x4_t(af, bs + (j0 + (lane & 7) + (lane >> 4) * 8) * L.sn + m * 16 +
                              ((lane >> 3) & 1) * 8);
            mma(acc[mi][0], af, bh[0], bh[1]);
            mma(acc[mi][0], af, bl[0], bl[1]);
            mma(acc[mi][1], af, bh[2], bh[3]);
            mma(acc[mi][1], af, bl[2], bl[3]);
          }
        } else {
          const int kend = min(16, P.q - j0);
          for (int kk = 0; kk < kend; ++kk) {
            const int j = j0 + kk;
            const float wj = w[j];
            float2 xv[2];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              xv[t] = *reinterpret_cast<const float2*>(xs + j * L.sp + pc + t * 8 + 2 * tg);
              xv[t].x *= wj;
              xv[t].y *= wj;
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const int m = mg * 2 + mi;
              if (m >= mt) continue;
              const float a0 = bs[j * L.sn + m * 16 + gq], a1 = bs[j * L.sn + m * 16 + gq + 8];
#pragma unroll
              for (int t = 0; t < 2; ++t) {
                acc[mi][t][0] = fmaf(a0, xv[t].x, acc[mi][t][0]);
                acc[mi][t][1] = fmaf(a0, xv[t].y, acc[mi][t][1]);
                acc[mi][t][2] = fmaf(a1, xv[t].x, acc[mi][t][2]);
                acc[mi][t][3] = fmaf(a1, xv[t].y, acc[mi][t][3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int n0 = (mg * 2 + mi) * 16 + gq, p = pc + t * 8 + 2 * tg;
          if (p >= P.p) continue;
          if (n0 < P.n)
            *reinterpret_cast<float2*>(out + (int64_t)n0 * P.p + p) =
                make_float2(acc[mi][t][0], acc[mi][t][1]);
          if (n0 + 8 < P.n)
            *reinterpret_cast<float2*>(out + (int64_t)(n0 + 8) * P.p + p) =
                make_float2(acc[mi][t][2], acc[mi][t][3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (queued < P.ht) load_head(queued++);
  }
}

// ---------------------------------------------------------------------------
// Pass 2: state passing.  One thread per four elements (n, p..p+3) of each
// (b, h); a block holds whole rows of N, so the bf16 split can overwrite a
// row's f32 values in place once the block has read them.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 fma4(float e, float4 h, float4 s) {
  return make_float4(fmaf(e, h.x, s.x), fmaf(e, h.y, s.y), fmaf(e, h.z, s.z), fmaf(e, h.w, s.w));
}

template <bool SPLIT>
__global__ void ssd_chunk_pass_kernel(Params P) {
  const int pq = P.p / 4, rows = blockDim.x / pq;
  const int64_t nrb = (P.n + rows - 1) / rows;
  const int64_t bh = blockIdx.x / nrb;
  const int64_t b = bh / P.heads, h = bh % P.heads;
  const int n = (int)(blockIdx.x % nrb) * rows + threadIdx.x / pq, p4 = threadIdx.x % pq * 4;
  const bool live = n < P.n;
  const int64_t blk = (int64_t)P.n * P.p, cstride = P.heads * blk;
  float* base = P.st + (b * P.nc * P.heads + h) * blk + (int64_t)n * P.p;   // row n, chunk 0
  const float* laq = P.laq + b * P.nc * P.heads + h;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t c0 = 0; c0 < P.nc; c0 += PASS_BATCH) {
    float4 sv[PASS_BATCH];
    float lv[PASS_BATCH];
#pragma unroll
    for (int t = 0; t < PASS_BATCH; ++t) {
      const bool in = c0 + t < P.nc;
      sv[t] = live && in ? *reinterpret_cast<const float4*>(base + (c0 + t) * cstride + p4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      lv[t] = in ? laq[(c0 + t) * P.heads] : 0.f;
    }
    if (SPLIT) __syncthreads();   // the block's reads of these chunks precede its writes
#pragma unroll
    for (int t = 0; t < PASS_BATCH; ++t) {
      if (c0 + t >= P.nc) break;
      float* row = base + (c0 + t) * cstride;
      if (live) {
        if (SPLIT) {   // the row's 4P bytes become [hi (P) | lo (P)] bf16
          const __nv_bfloat162 h01 = __floats2bfloat162_rn(hv.x, hv.y);
          const __nv_bfloat162 h23 = __floats2bfloat162_rn(hv.z, hv.w);
          const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
          __nv_bfloat16* r16 = reinterpret_cast<__nv_bfloat16*>(row);
          *reinterpret_cast<uint2*>(r16 + p4) = make_uint2(bits(h01), bits(h23));
          *reinterpret_cast<uint2*>(r16 + P.p + p4) =
              make_uint2(bits(__floats2bfloat162_rn(hv.x - f01.x, hv.y - f01.y)),
                         bits(__floats2bfloat162_rn(hv.z - f23.x, hv.w - f23.y)));
        } else {
          *reinterpret_cast<float4*>(row + p4) = hv;
        }
      }
      hv = fma4(expf(lv[t]), hv, sv[t]);
    }
  }
  if (live && P.hout != nullptr)
    *reinterpret_cast<float4*>(P.hout + ((b * P.heads + h) * P.n + n) * (int64_t)P.p + p4) = hv;
}

// ---------------------------------------------------------------------------
// Pass 3: y = exp(la_i) (C h_in) + S' X + D x per head of the tile.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_scan_kernel(Params P) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(sizeof(T), P.q, P.p, P.n);
  T* cs = reinterpret_cast<T*>(smem);
  float* gs = reinterpret_cast<float*>(smem + L.tile_n());
  float* dts = reinterpret_cast<float*>(smem + L.tile_n() + L.gbytes());
  float* las = dts + P.ht * L.q16;
  float* scr = reinterpret_cast<float*>(smem + L.tile_n() + L.gbytes() + L.ladt(P.ht));
  unsigned char* ring = smem + L.tile_n() + L.gbytes() + L.ladt(P.ht) + L.scratch();
  const int stage = L.tile_x() + L.tile_h();
  // B, until G is built, at the end of the region; the stages that lie
  // before it are loaded while G is built, the others after.
  const int region = L.region3(P.stages);
  T* bs = reinterpret_cast<T*>(ring + region - L.tile_n());
  const int early = (region - L.tile_n()) / stage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const Tile tl(P);
  const T* xg = static_cast<const T*>(P.x) + tl.b * P.xsb + tl.s0 * P.xss;

  load_tile(cs, L.sn, static_cast<const T*>(P.cm) + tl.b * P.csb + tl.s0 * P.css + tl.g * P.csg,
            P.css, P.q, L.q16, P.n, L.n16);
  load_tile(bs, L.sn, static_cast<const T*>(P.bm) + tl.b * P.bsb + tl.s0 * P.bss + tl.g * P.bsg,
            P.bss, P.q, L.q16, P.n, L.n16);
  load_dt(dts, P, tl.b, tl.s0, tl.h0, L.q16);
  cp_async_commit();
  auto load_head = [&](int k) {
    unsigned char* sb = ring + (k % P.stages) * stage;
    load_tile(reinterpret_cast<T*>(sb), L.sp, xg + (tl.h0 + k) * P.xsh, P.xss, P.q, L.q16, P.p,
              L.p16);
    const float* hin =
        P.st + ((tl.b * P.nc + tl.c) * P.heads + tl.h0 + k) * (int64_t)P.n * P.p;
    T* hs = reinterpret_cast<T*>(sb + L.tile_x());
    if constexpr (BF) {   // pass 2 left each row as [hi (P) | lo (P)] bf16
      const T* h16 = reinterpret_cast<const T*>(hin);
      load_tile(hs, L.sp, h16, 2 * P.p, P.n, L.n16, P.p, L.p16);
      load_tile(hs + L.n16 * L.sp, L.sp, h16 + P.p, 2 * P.p, P.n, L.n16, P.p, L.p16);
    } else {
      load_tile(hs, L.sp, reinterpret_cast<const T*>(hin), P.p, P.n, L.n16, P.p, L.p16);
    }
    cp_async_commit();
  };
  // Groups in order: C, B and dt, then one per head, ``queued`` of them.
  int queued = 0;
  for (; queued < early && queued < P.ht; ++queued) load_head(queued);
  wait_groups(queued);
  for (int k = warp; k < P.ht; k += NW)
    warp_cumsum(dts + k * L.q16, las + k * L.q16, P.a[tl.h0 + k], L.q16, lane);

  // G = C Bᵀ on the lower-triangular 16 x 16 tiles (r, kb), kb <= r.
  for (int t = warp; t < L.ntile; t += NW) {
    int r = 0;
    while ((r + 1) * (r + 2) / 2 <= t) ++r;
    const int kb = t - r * (r + 1) / 2;
    float acc[2][4] = {};
    if constexpr (BF) {
      for (int kn = 0; kn < L.n16; kn += 16) {
        uint32_t af[4], bq[4];
        ldsm_x4(af, cs + (r * 16 + (lane & 15)) * L.sn + kn + (lane >> 4) * 8);
        ldsm_x4(bq, bs + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * L.sn + kn +
                        ((lane >> 3) & 1) * 8);
        mma(acc[0], af, bq[0], bq[1]);
        mma(acc[1], af, bq[2], bq[3]);
      }
    } else {
      const T* c0 = cs + (r * 16 + gq) * L.sn;
      for (int nn = 0; nn < P.n; ++nn) {
        const float a0 = c0[nn], a1 = c0[8 * L.sn + nn];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = kb * 16 + u * 8 + 2 * tg;
          const float b0 = bs[j * L.sn + nn], b1 = bs[(j + 1) * L.sn + nn];
          acc[u][0] = fmaf(a0, b0, acc[u][0]);
          acc[u][1] = fmaf(a0, b1, acc[u][1]);
          acc[u][2] = fmaf(a1, b0, acc[u][2]);
          acc[u][3] = fmaf(a1, b1, acc[u][3]);
        }
      }
    }
    float* gt = gs + t * 256 + lane * 4;   // the two n8 fragments, 128 floats apart
    *reinterpret_cast<float4*>(gt) = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    *reinterpret_cast<float4*>(gt + 128) =
        make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
  __syncthreads();   // G is built: the ring may take B's place
  for (; queued < P.stages && queued < P.ht; ++queued) load_head(queued);

  // A unit is a pair of 16-row tiles (ra, rb = RT-1-ra), so the causal
  // triangle's work is even, by 32 columns of P; its two row tiles share the
  // h_in and X fragments and give the warp two independent chains.
  const int cgs = (L.p16 + 31) / 32, pairs = (L.rt + 1) / 2, units = pairs * cgs;
  for (int k = 0; k < P.ht; ++k) {
    wait_groups(queued - k - 1);
    const unsigned char* sb = ring + (k % P.stages) * stage;
    const T* xs = reinterpret_cast<const T*>(sb);
    const T* hs = reinterpret_cast<const T*>(sb + L.tile_x());
    const float* la = las + k * L.q16;
    const float* dtk = dts + k * L.q16;
    const int64_t h = tl.h0 + k;
    const float dsk = P.dv[h];
    for (int u = warp; u < units; u += NW) {
      const int cg = u / pairs, ra = u - cg * pairs, rb = L.rt - 1 - ra;
      const int t0 = ra == rb ? 1 : 0;                  // tile 1 is rb; tile 0 is ra if distinct
      const int rr[2] = {ra, rb};
      const int p0 = cg * 32;
      const bool two = p0 + 16 < L.p16;                 // the second 16 columns exist
      float acc[2][4][4] = {};

      // C h_in
      if constexpr (BF) {
        for (int kn = 0; kn < L.n16; kn += 16) {
          uint32_t af[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
            if (t >= t0) ldsm_x4(af[t], cs + (rr[t] * 16 + (lane & 15)) * L.sn + kn + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (np == 1 && !two) break;
            const int off = (kn + (lane & 7) + ((lane >> 3) & 1) * 8) * L.sp + p0 + np * 16 +
                            (lane >> 4) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4_t(bh, hs + off);
            ldsm_x4_t(bl, hs + L.n16 * L.sp + off);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              if (t < t0) continue;
              mma(acc[t][2 * np], af[t], bh[0], bh[1]);
              mma(acc[t][2 * np], af[t], bl[0], bl[1]);
              mma(acc[t][2 * np + 1], af[t], bh[2], bh[3]);
              mma(acc[t][2 * np + 1], af[t], bl[2], bl[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t < t0) continue;
          const T* c0 = cs + (rr[t] * 16 + gq) * L.sn;
          for (int nn = 0; nn < P.n; ++nn) {
            const float a0 = c0[nn], a1 = c0[8 * L.sn + nn];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c >= 2 && !two) break;
              const float2 hv =
                  *reinterpret_cast<const float2*>(hs + nn * L.sp + p0 + c * 8 + 2 * tg);
              acc[t][c][0] = fmaf(a0, hv.x, acc[t][c][0]);
              acc[t][c][1] = fmaf(a0, hv.y, acc[t][c][1]);
              acc[t][c][2] = fmaf(a1, hv.x, acc[t][c][2]);
              acc[t][c][3] = fmaf(a1, hv.y, acc[t][c][3]);
            }
          }
        }
      }
      float lr[2][2];   // la of the thread's two rows in each tile
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        lr[t][0] = la[rr[t] * 16 + gq];
        lr[t][1] = la[rr[t] * 16 + gq + 8];
        const float e0 = __expf(lr[t][0]), e1 = __expf(lr[t][1]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[t][c][0] *= e0;
          acc[t][c][1] *= e0;
          acc[t][c][2] *= e1;
          acc[t][c][3] *= e1;
        }
      }

      // S' X over the key tiles kb <= r: both tiles up to ra, then rb alone
      auto step = [&](int kb, auto both) {
        constexpr int tf = decltype(both)::value ? 0 : 1;
        float sv[2][8];
#pragma unroll
        for (int t = tf; t < 2; ++t) sprime(sv[t], gs, la, dtk, rr[t], kb, lr[t], lane);
        if constexpr (BF) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int t = tf; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) split2(sv[t][2 * e], sv[t][2 * e + 1], ah[t][e], al[t][e]);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (np == 1 && !two) break;
            uint32_t bx[4];
            ldsm_x4_t(bx, xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.sp + p0 +
                              np * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int t = tf; t < 2; ++t) {
              mma(acc[t][2 * np], ah[t], bx[0], bx[1]);
              mma(acc[t][2 * np], al[t], bx[0], bx[1]);
              mma(acc[t][2 * np + 1], ah[t], bx[2], bx[3]);
              mma(acc[t][2 * np + 1], al[t], bx[2], bx[3]);
            }
          }
        } else {
          float* sw = scr + warp * 16 * SCR;
          const int jl = 2 * tg, kend = min(16, P.q - kb * 16);
          for (int t = tf; t < 2; ++t) {
            sw[gq * SCR + jl] = sv[t][0];
            sw[gq * SCR + jl + 1] = sv[t][1];
            sw[(gq + 8) * SCR + jl] = sv[t][2];
            sw[(gq + 8) * SCR + jl + 1] = sv[t][3];
            sw[gq * SCR + jl + 8] = sv[t][4];
            sw[gq * SCR + jl + 9] = sv[t][5];
            sw[(gq + 8) * SCR + jl + 8] = sv[t][6];
            sw[(gq + 8) * SCR + jl + 9] = sv[t][7];
            __syncwarp();
            for (int kk = 0; kk < kend; ++kk) {
              const float a0 = sw[gq * SCR + kk], a1 = sw[(gq + 8) * SCR + kk];
              const T* xr = xs + (kb * 16 + kk) * L.sp + p0 + 2 * tg;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (c >= 2 && !two) break;
                const float2 xv = *reinterpret_cast<const float2*>(xr + c * 8);
                acc[t][c][0] = fmaf(a0, xv.x, acc[t][c][0]);
                acc[t][c][1] = fmaf(a0, xv.y, acc[t][c][1]);
                acc[t][c][2] = fmaf(a1, xv.x, acc[t][c][2]);
                acc[t][c][3] = fmaf(a1, xv.y, acc[t][c][3]);
              }
            }
            __syncwarp();
          }
        }
      };
      int kb = 0;
      if (t0 == 0)
        for (; kb <= ra; ++kb) step(kb, std::true_type{});
      for (; kb <= rb; ++kb) step(kb, std::false_type{});

      // y = acc + D x, in f32
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t < t0) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= 2 && !two) break;
          const int p = p0 + c * 8 + 2 * tg;
          if (p >= P.p) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = rr[t] * 16 + gq + 8 * hf;
            if (i >= P.q) continue;
            float2 xv;
            if constexpr (BF)
              xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(xs + i * L.sp + p));
            else
              xv = *reinterpret_cast<const float2*>(xs + i * L.sp + p);
            *reinterpret_cast<float2*>(P.y + ((tl.b * P.s + tl.s0 + i) * P.heads + h) * P.p +
                                       p) =
                make_float2(fmaf(dsk, xv.x, acc[t][c][2 * hf]),
                            fmaf(dsk, xv.y, acc[t][c][2 * hf + 1]));
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (queued < P.ht) load_head(queued++);
  }
}

template <typename T>
int run(Params P, int64_t batch, int stages1, int stages3, cudaStream_t stream) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const Layout L(sizeof(T), P.q, P.p, P.n);
  const int s1 = L.pass1(P.ht, stages1), s3 = L.pass3(P.ht, stages3);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(batch * P.nc * (P.heads / P.ht));
  P.stages = stages1;
  ssd_chunk_state_kernel<T><<<blocks, NT, s1, stream>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int pq = P.p / 4, rows = NT / pq;
  const unsigned pass_blocks = (unsigned)(batch * P.heads * ((P.n + rows - 1) / rows));
  ssd_chunk_pass_kernel<BF><<<pass_blocks, rows * pq, 0, stream>>>(P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  P.stages = stages3;
  ssd_chunk_scan_kernel<T><<<blocks, NT, s3, stream>>>(P);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
          const void* dv, void* y, void* hout, void* st, void* laq, int64_t batch, int64_t s,
          int64_t heads, int64_t groups, int64_t p, int64_t n, int64_t q, int64_t ht,
          int64_t stages1, int64_t stages3, int64_t xsb, int64_t xss, int64_t xsh, int64_t bsb,
          int64_t bss, int64_t bsg, int64_t csb, int64_t css, int64_t csg, void* stream) {
  Params P{x, (const float*)dt, (const float*)a, bm, cm, (const float*)dv,
           (float*)y, (float*)hout, (float*)st, (float*)laq,
           s, heads, groups, s / q,
           xsb, xss, xsh, bsb, bss, bsg, csb, css, csg,
           (int)p, (int)n, (int)q, (int)ht, 1};
  return run<T>(P, batch, (int)stages1, (int)stages3, (cudaStream_t)stream);
}

}  // namespace

// x (B, S, H, P), b and c (B, S, G, N): f32 (ssd_chunk_f32) or bf16
// (ssd_chunk_bf16) views with the last dimension contiguous, 16-byte aligned
// rows, strides in elements.  dt (B, S, H) contiguous f32; a and d (H,) f32.
// y (B, S, H, P) f32; hout (B, H, N, P) f32 or null; st (B, S/q, H, N, P)
// and laq (B, S/q, H) f32 scratch.  ht divides H/G (at most 8); S is a
// multiple of q <= 128; P and N are multiples of 8 (bf16) or 4 (f32).
#define SSD_ARGS                                                                              \
  const void *x, const void *dt, const void *a, const void *bm, const void *cm,              \
      const void *dv, void *y, void *hout, void *st, void *laq, int64_t batch, int64_t s,    \
      int64_t heads, int64_t groups, int64_t p, int64_t n, int64_t q, int64_t ht,            \
      int64_t stages1, int64_t stages3, int64_t xsb, int64_t xss, int64_t xsh, int64_t bsb,  \
      int64_t bss, int64_t bsg, int64_t csb, int64_t css, int64_t csg, void *stream
#define SSD_PASS                                                                             \
  x, dt, a, bm, cm, dv, y, hout, st, laq, batch, s, heads, groups, p, n, q, ht, stages1,     \
      stages3, xsb, xss, xsh, bsb, bss, bsg, csb, css, csg, stream

extern "C" int ssd_chunk_f32(SSD_ARGS) { return entry<float>(SSD_PASS); }
extern "C" int ssd_chunk_bf16(SSD_ARGS) { return entry<__nv_bfloat16>(SSD_PASS); }

// The shared memory of passes 1 and 3 as the launcher computes it, for the
// card tests to hold against kernels/ssd/kernel.py::smem_plan.
extern "C" int ssd_chunk_smem(int64_t elem_bytes, int64_t q, int64_t p, int64_t n, int64_t ht,
                              int64_t stages1, int64_t stages3, int64_t* out) {
  const Layout L((int)elem_bytes, (int)q, (int)p, (int)n);
  out[0] = L.pass1((int)ht, (int)stages1);
  out[1] = L.pass3((int)ht, (int)stages3);
  return 0;
}
