// Flash attention forward: out = softmax(mask(cap(q kᵀ / sqrt(D)))) v per head.
//
// Replaces: repro/kernels/attention/kernel.py::flash_attention_pallas (the
// TPU kernel, grid (B*H, q-blocks, kv-blocks) with its running max, sum and
// accumulator carried in VMEM scratch across the sequential kv axis), with
// the semantics of the model path repro/models/layers.py::chunked_attention:
// causal masking, a sliding window ((q - k) < window; 0 is global), prefix
// keys that every query sees (prefix_len), the tanh softcap cap*tanh(s/cap),
// GQA by head group (kv head = h / (H / KV), nothing repeated in memory),
// masked logits at -1e30, the running (max, sum, accumulator) in f32, the
// output acc / max(sum, 1e-30) cast once to the input type.  A KV tile is
// skipped only when every row of the block masks it and it holds no prefix
// key; a row's exp(0) terms from a tile it sees none of are rescaled by 0 at
// its first visible key, as the reference's online softmax does; keys past
// a ragged S get p = 0 exactly and rows past S are not stored.  Inputs are
// (B, heads, S, D) views with any strides and the last dimension contiguous
// (the model's transposed (B, S, heads, D) projections, read in place); the
// output is written as a (B, S, H, D) tensor.
//
// Bound on this card: operations.  At the zamba2 path's shape (B 4, H 32,
// S 1024, D 64, causal) the function moves 64 MB (0.02 ms at 3.35 TB/s)
// against 8.6 GFLOP of QKᵀ and, with P kept in f32 as the reference keeps
// it, 17.2 GFLOP of P·V as two bf16 products (below): 0.026 ms at the
// 989 TFLOP/s dense bf16 rate, the 67 M exps 0.016 ms beside it.
//
// bf16 (every model path: _cast_tree makes the compute type bf16) runs on
// the tensor cores, flash_fwd_tc:
//   * one block per (b*h, 64-row query tile): one consumer warpgroup owns
//     the 64 rows, one producer warp feeds it.  Query tiles run in reverse
//     order, so the longest causal rows start first.
//   * the producer's one lane loads Q once, then every K and V tile the
//     block does not skip, by TMA (4-D tensor maps over the strided views,
//     128-byte swizzle) into a ring of 2 stages under full/empty mbarriers.
//     TMA fills rows past S with zeros; the masks give those keys p = 0.
//   * S = Q Kᵀ: wgmma m64nBKk16 with both operands in shared memory, K-major
//     (K tiles as TMA wrote them).  Products of bf16 are exact in f32, as the
//     reference's einsum(..., preferred_element_type=f32) has them.
//   * scale, softcap, masks, the running max and sum are applied to the f32
//     accumulator fragments in registers; P never goes through shared memory.
//     A tile every row of the block sees whole skips the masks.  exp(x) is
//     computed as exp2(x log2 e) (within ~1e-6 of expf over the softmax's
//     range; exactly 1 at 0, so a row's terms from before its first visible
//     key are still rescaled by exp(-1e30 - m) = 0).
//   * P·V keeps the reference's f32 P: P = P_hi + P_lo with P_hi = bf16(P),
//     P_lo = bf16(P - P_hi) (P to ~2^-16 relative), and two wgmma m64nDPk16
//     with the P fragments as the register A operand and V as the shared B
//     operand, read through the transpose bit (MN-major): acc += P_hi V +
//     P_lo V.  The row sum is taken from the unsplit f32 P.
//   * shared tiles are 64 columns (128 bytes) wide: D = 16 and 32 pad to 64
//     and D = 80 to 128 through TMA's zero fill (zeros add nothing to QKᵀ;
//     QKᵀ stops at the last 16 columns holding data, and the padded output
//     columns are dropped).  D <= 128 takes 64-key tiles (40 KB of shared
//     memory at D = 64, 80 KB at D = 128); D = 256 takes 32-key tiles
//     (97 KB): its 128 accumulator registers a thread leave room for a
//     16-register logit tile, not a 32-register one.  Every D of
//     HEAD_DIMS = (16, 32, 64, 80, 128, 256) takes this kernel.
// f32 keeps the CUDA-core kernel, flash_fwd_kernel: the repo's rule forbids
// TF32 for f32 operands, so every product is an f32 FMA.  One block of 16 x
// 16 threads per (b*h, 64-row query tile); Q, the K and V tiles and the
// probability tile sit in shared memory as f32 (Q and K rows padded by one
// word), each thread owning 4 query rows x (BK / 16) keys of the logit tile
// and 4 rows x (D / 16) accumulator columns in registers; D = 256 takes
// 32-key tiles (140 KB), D <= 128 64-key tiles.
#include <cuda.h>             // CUtensorMap and its enums (the header only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int TX = 16, TY = 16, NT = TX * TY;
constexpr int BQ = 64;              // query rows per block
constexpr int RPT = BQ / TY;        // query rows per thread
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------- //
// f32: the CUDA-core kernel                                               //
// ---------------------------------------------------------------------- //
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
struct Args {
  const void* q; const void* k; const void* v; void* o;
  int64_t heads, kv_heads, s;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale, softcap;
  int64_t window, prefix_len;
  int causal;
};

template <int D, int BK>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, TX));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, TX);
  return v;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;         // padded row of Q and K
  constexpr int KPT = BK / TX;      // keys per thread in a logit tile
  constexpr int CPT = D / TX;       // accumulator columns per thread
  constexpr int PP = BK + 1;        // padded row of the probability tile
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ps = vs + BK * D;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int64_t nq = (a.s + BQ - 1) / BQ;
  const int64_t q0 = (nq - 1 - (int64_t)blockIdx.x) * BQ;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.heads, h = bh % a.heads;
  const int64_t kvh = h / (a.heads / a.kv_heads);
  const T* qp = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kp = (const T*)a.k + b * a.ksb + kvh * a.ksh;
  const T* vp = (const T*)a.v + b * a.vsb + kvh * a.vsh;
  T* op = (T*)a.o + b * a.osb + h * a.osh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int64_t gr = q0 + r;
    qs[r * DP + c] = gr < a.s ? to_f32(qp[gr * a.qss + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int64_t q_last = q0 + BQ - 1;
  const int64_t nk = (a.s + BK - 1) / BK;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k0 = kt * BK;
    // Tiles that every row of the block masks (the test is uniform over
    // the block, so the barriers below stay uniform too).
    if (k0 >= a.prefix_len) {
      if (a.causal && k0 > q_last) continue;
      if (a.window > 0 && q0 - (k0 + BK - 1) >= a.window) continue;
    }
    __syncthreads();                 // the last tile's reads are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int64_t gr = k0 + r;
      const bool in = gr < a.s;
      ks[r * DP + c] = in ? to_f32(kp[gr * a.kss + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vp[gr * a.vss + c]) : 0.f;
    }
    __syncthreads();

    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + TY * i) * DP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = ks[(tx + TX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int64_t row = q0 + ty + TY * i;
      float mc = NEG;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int64_t col = k0 + tx + TX * j;
        float x = sc[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool vis = true;
        if (a.causal) vis = row >= col || col < a.prefix_len;
        if (a.window > 0) vis = vis && (row - col < a.window || col < a.prefix_len);
        sc[i][j] = vis ? x : NEG;
        mc = fmaxf(mc, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mc));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int64_t col = k0 + tx + TX * j;
        const float p = col < a.s ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + TY * i) * PP + tx + TX * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + TY * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[kk * D + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = q0 + ty + TY * i;
    if (row >= a.s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(op + row * a.oss + tx + TX * c, acc[i][c] / den);
  }
}

template <typename T, int D, int BK>
int launch(const Args& a, int64_t batch, void* stream) {
  constexpr int bytes = smem_floats<D, BK>() * (int)sizeof(float);
  auto kern = flash_fwd_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.s + BQ - 1) / BQ), (unsigned)(batch * a.heads));
  kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int64_t batch, int64_t d, void* stream) {
  switch (d) {
    case 16: return launch<T, 16, 64>(a, batch, stream);
    case 32: return launch<T, 32, 64>(a, batch, stream);
    case 64: return launch<T, 64, 64>(a, batch, stream);
    case 80: return launch<T, 80, 64>(a, batch, stream);
    case 128: return launch<T, 128, 64>(a, batch, stream);
    case 256: return launch<T, 256, 32>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------- //
// bf16: wgmma on the tensor cores, K and V by TMA                         //
// ---------------------------------------------------------------------- //
constexpr int TC_CONSUMERS = 128;                 // one warpgroup: 64 query rows
constexpr int TC_THREADS = TC_CONSUMERS + 32;     // + one producer warp
constexpr int STAGES = 2;                         // K/V ring depth
constexpr int kNoEncoder = -4;                    // cuTensorMapEncodeTiled not found
constexpr int kBadTensorMap = -5;                 // a view TMA cannot describe
// exp(x) = 2^(x log2 e) on the SFU: within ~1e-6 relative of expf over the
// softmax's range, and exactly 1 at x = 0 (a row that sees no key yet).
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int DP = D <= 64 ? 64 : (D <= 128 ? 128 : 256);  // D padded in smem
  static constexpr int NCH = DP / 64;             // 64-column (128-byte) chunks of a row
  static constexpr int KSTEPS = (D + 15) / 16;    // QKᵀ k-steps that hold data
  static constexpr int BK = D > 128 ? 32 : 64;    // keys per tile
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;    // one K or V tile
  static constexpr int SMEM = 1024 /* alignment slack */ + Q_BYTES + 2 * STAGES * KV_BYTES
                              + 8 * (2 * STAGES + 1);
};

struct TcArgs {
  __nv_bfloat16* o;
  int64_t heads, kv_heads, s, osb, osh, oss;
  float scale, softcap;
  int64_t window, prefix_len;
  int causal;
  int q_order, k_order, v_order;   // tensor-map position of (seq, head, batch), 2 bits each
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA box of 64 columns from column `col` of (seq row, head, batch),
// the three placed in the map's order.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int order, int col, int row, int head, int batch) {
  const int pr = order & 3, ph = (order >> 2) & 3;
  const int c1 = pr == 0 ? row : (ph == 0 ? head : batch);
  const int c2 = pr == 1 ? row : (ph == 1 ? head : batch);
  const int c3 = pr == 2 ? row : (ph == 2 ? head : batch);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous instruction's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (64 x N, f32) += A (64 x 16) B (16 x N), bf16 operands.  ss: A and B
// K-major in shared memory; rs: A in registers (the m16n8k16 A fragment of
// each warp's 16 rows), B in shared memory read transposed (MN-major).
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %16, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %17, %18, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(1), "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %32, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %33, %34, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(1), "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %32, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%33, %34, %35, %36}, %37, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(1), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %64, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%65, %66, %67, %68}, %69, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(1), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %128, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%129, %130, %131, %132}, %133, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(1), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db);
  else wgmma_ss_n64(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Every row of the query tile at q0 masks the key tile at k0, and it holds
// no prefix key: the tile is skipped (the same test on producer and consumers).
__device__ __forceinline__ bool tile_masked(int64_t k0, int bk, int64_t q0, const TcArgs& a) {
  if (k0 < a.prefix_len) return false;
  if (a.causal && k0 > q0 + BQ - 1) return true;
  return a.window > 0 && q0 - (k0 + bk - 1) >= a.window;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  using T = Tile<D>;
  constexpr int DP = T::DP, NCH = T::NCH, BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to that.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                                 // [NCH][64 rows][64]
  const uint32_t k_s = q_s + T::Q_BYTES;                     // [stage][NCH][BK rows][64]
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;
  const uint32_t bars = v_s + STAGES * T::KV_BYTES;          // full[], empty[], q
  const uint32_t q_bar = bars + 16u * STAGES;

  const int tid = threadIdx.x;
  const int64_t nq = (a.s + BQ - 1) / BQ;
  const int64_t q0 = (nq - 1 - (int64_t)blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / (int)a.heads, h = bh % (int)a.heads;
  const int kvh = h / (int)(a.heads / a.kv_heads);
  const int64_t nk = (a.s + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8u * st, 1);                          // full: the producer's arrive
      mbar_init(bars + 8u * (STAGES + st), TC_CONSUMERS);   // empty: every consumer
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // Producer: one lane issues every copy.
    if (tid == TC_CONSUMERS) {
      mbar_expect_tx(q_bar, T::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load(q_s + c * BQ * 128, &tq, q_bar, a.q_order, c * 64, (int)q0, h, b);
      int st = 0;
      uint32_t ph = 0;
      for (int64_t kt = 0; kt < nk; ++kt) {
        const int64_t k0 = kt * BK;
        if (tile_masked(k0, BK, q0, a)) continue;
        mbar_wait(bars + 8u * (STAGES + st), ph ^ 1);        // the consumers freed it
        const uint32_t full = bars + 8u * st;
        mbar_expect_tx(full, 2 * T::KV_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(k_s + st * T::KV_BYTES + c * BK * 128, &tk, full, a.k_order, c * 64,
                   (int)k0, kvh, b);
          tma_load(v_s + st * T::KV_BYTES + c * BK * 128, &tv, full, a.v_order, c * 64,
                   (int)k0, kvh, b);
        }
        if (++st == STAGES) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  // Consumers.  Accumulator fragment of m64nN: element j of this thread is
  // row r_lo + 8 * ((j >> 1) & 1), column 8 * (j >> 2) + cq + (j & 1).
  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int64_t rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k0 = kt * BK;
    if (tile_masked(k0, BK, q0, a)) continue;
    mbar_wait(bars + 8u * st, ph);
    const uint32_t ks = k_s + st * T::KV_BYTES, vs = v_s + st * T::KV_BYTES;

    // S = Q Kᵀ, K-major operands; k-step kk is 32 bytes into chunk kk / 4.
    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    fence_regs<BK / 2>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      const uint32_t off = (kk & 3) * 32u;
      wgmma_ss<BK>(sc, sw128_desc(q_s + (kk >> 2) * BQ * 128 + off, 16, 1024),
                   sw128_desc(ks + (kk >> 2) * BK * 128 + off, 16, 1024));
    }
    wg_commit();
    wg_wait0();
    fence_regs<BK / 2>(sc);

    // Scale, softcap and masks on the fragments; the running max and sum.
    // A tile that every row of the block sees whole (no mask applies, no
    // key past S) skips the masks.
    const bool whole =
        k0 + BK <= a.s
        && (!a.causal || k0 + BK - 1 <= q0 || k0 + BK <= a.prefix_len)
        && (a.window <= 0 || q0 + BQ - 1 - k0 < a.window || k0 + BK <= a.prefix_len);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int hf = (j >> 1) & 1;
      float x = sc[j] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      if (!whole) {
        const int64_t col = k0 + (j >> 2) * 8 + cq + (j & 1);
        bool vis = true;
        if (a.causal) vis = rows[hf] >= col || col < a.prefix_len;
        if (a.window > 0) vis = vis && (rows[hf] - col < a.window || col < a.prefix_len);
        x = vis ? x : NEG;
      }
      sc[j] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_run[hf], mx[hf]);
      alpha[hf] = exp2f((m_run[hf] - m_new) * LOG2E);
      m_run[hf] = m_new;
    }
    // P in f32, split into the bf16 A fragments P_hi and P_lo: fragment
    // register (j % 8) / 2 of k-step j / 8 holds elements j and j + 1.
    float rs[2] = {0.f, 0.f};
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 2; j += 2) {
      const int hf = (j >> 1) & 1;
      const int64_t col = k0 + (j >> 2) * 8 + cq;
      const float p0 = whole || col < a.s ? exp2f((sc[j] - m_run[hf]) * LOG2E) : 0.f;
      const float p1 = whole || col + 1 < a.s ? exp2f((sc[j + 1] - m_run[hf]) * LOG2E) : 0.f;
      rs[hf] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hi_f = __bfloat1622float2(hi);
      p_hi[j / 8][(j % 8) / 2] = bf16x2_bits(hi);
      p_lo[j / 8][(j % 8) / 2] = bf16x2_bits(__floats2bfloat162_rn(p0 - hi_f.x, p1 - hi_f.y));
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
      rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
      l_run[hf] = l_run[hf] * alpha[hf] + rs[hf];
    }
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

    // acc += P_hi V + P_lo V: V's 16 keys of k-step kk start 2048 bytes
    // apart; its 64-column chunks lie BK * 128 bytes apart (the LBO).
    fence_regs<DP / 2>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs<DP>(acc, p_hi[kk], dv);
      wgmma_rs<DP>(acc, p_lo[kk], dv);
    }
    wg_commit();
    wg_wait0();
    fence_regs<DP / 2>(acc);
    mbar_arrive(bars + 8u * (STAGES + st));
    if (++st == STAGES) { st = 0; ph ^= 1; }
  }

  const float den[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
  __nv_bfloat16* op = a.o + (int64_t)b * a.osb + (int64_t)h * a.osh;
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int hf = (j >> 1) & 1;
    const int col = (j >> 2) * 8 + cq;
    if (col < D && rows[hf] < a.s)
      *reinterpret_cast<__nv_bfloat162*>(op + rows[hf] * a.oss + col) =
          __floats2bfloat162_rn(acc[j] / den[hf], acc[j + 1] / den[hf]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime: no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (B, heads, S, D) bf16 view as a 4-D tensor map: D innermost, then the
// three others by increasing stride (a dimension of size 1 last, its stride
// unused), boxes of 64 columns x `rows` sequence rows, 128-byte swizzle,
// zeros past every edge.  *order gets each of (seq, head, batch)'s position.
int encode(CUtensorMap* map, const void* ptr, int64_t d, int64_t s, int64_t heads,
           int64_t batch, int64_t ss, int64_t sh, int64_t sb, int rows, int* order) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  int64_t size[3] = {s, heads, batch}, stride[3] = {ss, sh, sb};
  int idx[3] = {0, 1, 2};
  auto key = [&](int i) { return size[i] == 1 ? INT64_MAX : stride[i]; };
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(idx[j]) < key(idx[i])) { const int t = idx[i]; idx[i] = idx[j]; idx[j] = t; }
  cuuint64_t dims[4] = {(cuuint64_t)d, 1, 1, 1}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  int64_t prev = d;                        // extent in elements of the dimensions so far
  *order = 0;
  for (int p = 0; p < 3; ++p) {
    const int i = idx[p];
    const int64_t st = size[i] == 1 ? prev : stride[i];
    if ((st * 2) % 16 != 0) return kBadTensorMap;
    dims[p + 1] = (cuuint64_t)size[i];
    strides[p] = (cuuint64_t)(st * 2);
    if (i == 0) box[p + 1] = (cuuint32_t)rows;
    *order |= p << (2 * i);
    prev = st * size[i];
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return kBadTensorMap;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadTensorMap;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int64_t batch,
              int64_t heads, int64_t kv_heads, int64_t s, int64_t qsb, int64_t qsh, int64_t qss,
              int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
              int64_t osb, int64_t osh, int64_t oss, float scale, float softcap,
              int64_t window, int64_t prefix_len, int causal, void* stream) {
  using T = Tile<D>;
  TcArgs a{(__nv_bfloat16*)o, heads, kv_heads, s, osb, osh, oss, scale, softcap, window,
           prefix_len, causal, 0, 0, 0};
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, D, s, heads, batch, qss, qsh, qsb, BQ, &a.q_order);
  if (err == 0) err = encode(&tk, k, D, s, kv_heads, batch, kss, ksh, ksb, T::BK, &a.k_order);
  if (err == 0) err = encode(&tv, v, D, s, kv_heads, batch, vss, vsh, vsb, T::BK, &a.v_order);
  if (err != 0) return err;
  auto kern = flash_fwd_tc<D>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((s + BQ - 1) / BQ), (unsigned)(batch * heads));
  kern<<<grid, TC_THREADS, T::SMEM, (cudaStream_t)stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides in elements of (B, heads, S, D) views whose last dimension is
// contiguous; scale = f32(1 / sqrt(D)); window <= 0 is global.
extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int64_t batch, int64_t heads,
    int64_t kv_heads, int64_t s, int64_t d, int64_t qsb, int64_t qsh, int64_t qss,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss, float scale, float softcap, int64_t window,
    int64_t prefix_len, int causal, void* stream) {
  const Args a{q, k, v, o, heads, kv_heads, s, qsb, qsh, qss, ksb, ksh, kss,
               vsb, vsh, vss, osb, osh, oss, scale, softcap, window, prefix_len, causal};
  return dispatch<float>(a, batch, d, stream);
}

// The same arguments; the views also need 16-byte aligned base pointers and
// strides (kBadTensorMap otherwise), which every contiguous view has.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int64_t batch, int64_t heads,
    int64_t kv_heads, int64_t s, int64_t d, int64_t qsb, int64_t qsh, int64_t qss,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss, float scale, float softcap, int64_t window,
    int64_t prefix_len, int causal, void* stream) {
#define FA_TC_ARGS q, k, v, o, batch, heads, kv_heads, s, qsb, qsh, qss, ksb, ksh, kss, vsb, \
    vsh, vss, osb, osh, oss, scale, softcap, window, prefix_len, causal, stream
  switch (d) {
    case 16: return launch_tc<16>(FA_TC_ARGS);
    case 32: return launch_tc<32>(FA_TC_ARGS);
    case 64: return launch_tc<64>(FA_TC_ARGS);
    case 80: return launch_tc<80>(FA_TC_ARGS);
    case 128: return launch_tc<128>(FA_TC_ARGS);
    case 256: return launch_tc<256>(FA_TC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_TC_ARGS
}
