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
// output acc / max(sum, 1e-30) cast once to the input type.
//
// Bound on this card: operations.  At the zamba2 path's shape (B 4, H 32,
// S 1024, D 64, causal) the function reads and writes 64 MB (0.02 ms at
// 3.35 TB/s) against 17 GFLOP of QKᵀ and PV products.  This first kernel
// keeps every product in f32 on the CUDA cores (no tensor cores, so no TF32
// for f32 inputs, and bf16 inputs widen exactly to f32): it is meant to be
// right first; wgmma and TMA are a later kernel's work.
//
// Design: one block of 16 x 16 threads per (b*h, 64-row query tile); the
// loop over KV tiles runs inside the block and takes the place of the TPU's
// sequential kv grid axis.  Q, the K and V tiles and the tile of
// probabilities sit in shared memory as f32 (Q and K rows padded by one
// word, so the 16 threads of a row group read 16 banks); each thread owns 4
// query rows x (BK / 16) keys of the logit tile and 4 rows x (D / 16)
// columns of the accumulator, in registers.  Row maxima and sums reduce over
// the 16 threads of a row with shuffles.  KV tiles wholly above the diagonal
// (causal) or wholly before the window are skipped, unless they hold prefix
// keys.  Residency: D = 256 with 64-key tiles would need 213 KB of f32
// tiles, so D = 256 takes 32-key tiles (140 KB); D <= 128 takes 64-key
// tiles (66 KB at D = 64: three blocks per SM).  Query tiles run in reverse
// order, so the longest causal rows start first.  The ragged edge of S is
// masked: keys past S get probability 0, rows past S are not stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TX = 16, TY = 16, NT = TX * TY;
constexpr int BQ = 64;              // query rows per block
constexpr int RPT = BQ / TY;        // query rows per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int64_t batch,
        int64_t heads, int64_t kv_heads, int64_t s, int64_t d, int64_t qsb, int64_t qsh,
        int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
        int64_t vss, int64_t osb, int64_t osh, int64_t oss, float scale, float softcap,
        int64_t window, int64_t prefix_len, int causal, void* stream) {
  const Args a{q, k, v, o, heads, kv_heads, s, qsb, qsh, qss, ksb, ksh, kss,
               vsb, vsh, vss, osb, osh, oss, scale, softcap, window, prefix_len, causal};
  return dispatch<T>(a, batch, d, stream);
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
  return run<float>(q, k, v, o, batch, heads, kv_heads, s, d, qsb, qsh, qss, ksb, ksh, kss,
                    vsb, vsh, vss, osb, osh, oss, scale, softcap, window, prefix_len,
                    causal, stream);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int64_t batch, int64_t heads,
    int64_t kv_heads, int64_t s, int64_t d, int64_t qsb, int64_t qsh, int64_t qss,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t osb, int64_t osh, int64_t oss, float scale, float softcap, int64_t window,
    int64_t prefix_len, int causal, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, s, d, qsb, qsh, qss, ksb,
                            ksh, kss, vsb, vsh, vss, osb, osh, oss, scale, softcap, window,
                            prefix_len, causal, stream);
}
