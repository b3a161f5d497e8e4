// Batched laplacian kernel block: out[b] = exp(-|xa_i - xb_j|_1 / h).
//
// Replaces: repro/kernels/compress/laplacian.py::laplacian_block_pallas (the
// TPU tile kernel), with its numerics: the L1 distance is summed in f32
// whatever the input type (the reference's XLA twin sums bf16 inputs in
// bf16), the exponent is d1 * f32(1/h), and the block is stored in the input
// type (f32 or bf16).
//
// Each output costs 2F f32 adds (a subtract, then an add whose |.| is an
// operand modifier) and one exp against 4 bytes stored, so the bytes bound:
// the 2048 x 2^20 scoring block's 16 adds per entry need about 1.0 ms at
// the non-FMA f32 rate (half of 67 TFLOP/s) against its 2.6 ms of writes.
// The kernels and their launch plans (skinny, packed, wide) are those of
// pairwise_block.cuh, shared with the Gaussian block (K1); every plan sums
// the L1 distance over the features in order from 0.f, the order of the
// plain version, so the two agree to the bit.
#include "pairwise_block.cuh"

// neg_inv_h = -f32(1/h), computed by the caller as the reference does;
// family, gx, gy, gz, smem, param, flags: the plan (kernels/pairwise.py).
extern "C" int laplacian_block_f32(const void* xa, const void* xb, void* out,
                                   int64_t batch, int64_t ma, int64_t mb, int64_t f,
                                   float neg_inv_h, int family, int gx, int gy, int gz, int smem,
                                   int param, int flags, void* stream) {
  return launch_pairwise<kLaplacian, float>(xa, xb, out, batch, ma, mb, f, neg_inv_h,
                                            family, gx, gy, gz, smem, param, flags, stream);
}

extern "C" int laplacian_block_bf16(const void* xa, const void* xb, void* out,
                                    int64_t batch, int64_t ma, int64_t mb, int64_t f,
                                    float neg_inv_h, int family, int gx, int gy, int gz, int smem,
                                    int param, int flags, void* stream) {
  return launch_pairwise<kLaplacian, __nv_bfloat16>(xa, xb, out, batch, ma, mb, f,
                                                    neg_inv_h, family, gx, gy, gz, smem,
                                                    param, flags, stream);
}

// The kernels' own count of a plan's dynamic shared memory (-1: no family).
extern "C" long long laplacian_block_smem_bytes(int elem_bytes, int family, int64_t ma,
                                                int64_t mb, int64_t f, int param) {
  return elem_bytes == 2 ? smem_bytes<__nv_bfloat16>(family, ma, mb, f, param)
                         : smem_bytes<float>(family, ma, mb, f, param);
}
