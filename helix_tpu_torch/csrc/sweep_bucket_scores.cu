// Kernel 4: the one-pass bucket-reduction experiment of the fused exact
// kernel, on kernel 1's bf16 pipeline.
//
// Replaces the Pallas kernels of benchmarks/onepass_sweep.py,
// _make_kernel_onepass (:34) and _make_kernel_lastmask (:70), which the
// sweep swaps in for helix_tpu/ops/fused_topk.py:_make_kernel (:151) and
// launches through _bucket_scores' pallas_call (:200), at each of its
// tile sizes.  All three compute kernel 1's function
// (bucket_scores.cu): for every row r of the bf16 xs [N, D] and query j
// of qs [B, D], the f32 sum s, NEG_SENTINEL for r >= n_valid, its low 6
// mantissa bits replaced by r & 63, the float max over each 64-row
// bucket, denormals flushed.  They differ in where the row mask goes:
//
// - shipped: kernel 1's epilogue itself, the mask folded into the pack
//   (no instruction per value);
// - onepass: an explicit select before the pack, the reference's order;
// - lastmask: that select only in buckets that hold a row >= n_valid.
//
// So each equals kernel 1's packed winners bit for bit on the same
// operands.  The sweep's tile size is the TPU's VMEM tile, which does not
// bind Hopper; its counterpart here is the ring depth (stages per
// consumer), which the caller sets.
//
// What bounds it on an H100: kernel 1's bound, 82 us at N = 1,007,616,
// D = 128, B = 256 (258 MB of bf16 rows and 16 MB of winners at 3.35
// TB/s; 66 GFLOP take 67 us at 989 TFLOP/s).  The design is kernel 1's
// (sweep.cuh: Dot::Bf16, resident queries); the variants change only the
// epilogue's per-value instructions.

#include "hopper.cuh"
#include "sweep.cuh"

using hx::Dot;
using hx::Mask;
using hx::Reduce;
using hx::Scale;
using hx::Variant;

HX_SWEEP_ENTRY(hx_sweep_shipped,
               Variant<Dot::Bf16, Scale::None, Mask::Fold, Reduce::Packed>)
HX_SWEEP_ENTRY(hx_sweep_onepass,
               Variant<Dot::Bf16, Scale::None, Mask::Select, Reduce::Packed>)
HX_SWEEP_ENTRY(hx_sweep_lastmask,
               Variant<Dot::Bf16, Scale::None, Mask::Tail, Reduce::Packed>)

// The plan a sweep kernel of `dot` (0: Bf16, 1: S8, 2: S8AsBf16) runs for
// d, b at `depth` (0: the most that fit): {queries resident (1), stages
// per consumer, stage bytes, dynamic shared memory}; -3 when not taken.
extern "C" int hx_sweep_plan(int dot, int d, int b, int depth, int* plan) {
  if (dot < 0 || dot > 2 || d <= 0 || (b != 128 && b != 256)) return -3;
  const Dot kind = static_cast<Dot>(dot);
  if (d % (hx::SWIZZLE_BYTES / hx::row_elem(kind))) return -3;
  hx::Plan p;
  if (!hx::sweep_plan(kind, d, b, depth, &p)) return -3;
  plan[0] = p.resident;
  plan[1] = p.depth;
  plan[2] = p.stage_bytes;
  plan[3] = p.smem_bytes;
  return 0;
}
