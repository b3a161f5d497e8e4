// Seeded violations of precision-accumulate's CUDA scan.
__device__ void products(float* d, unsigned* a, unsigned long long da, unsigned long long db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f16.f16.f16 {}, %0, %1;" :: "l"(da), "l"(db));  // VIOLATION
  asm volatile("mma.sync.aligned.m16n8k16.row.col.bf16.bf16.bf16.bf16 {};" ::);  // VIOLATION
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {};" ::);  // VIOLATION
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {}, %0, %1;" :: "l"(da), "l"(db));
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {};" ::);
  // a comment that names tf32 or mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 is no code
}
