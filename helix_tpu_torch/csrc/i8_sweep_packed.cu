// Kernel 5, its packed int8 forms: the int8 coarse-kernel experiment's
// variants that end in a packed bucket max.
//
// Replaces benchmarks/i8_sweep.py's k_i32pack (:208), k_scale2d (:246),
// k_gscale (:266), k_epilogue(True, False, False, True) (:304 via
// make_ep :525; ep_pack), k_epilogue(True, True, True, True) (ep_full_amk),
// k_full_t (:488; full_noT, through call_t's pallas_call at :467) and
// k_dotf32 (:507), launched through `call` (pallas_call at :359).  On
// exact int32 sums of int8 rows and int8 queries (kernel 2's products):
//
// - i32pack: per-bucket scales ([N / 64] f32); the reduction in the int
//   domain ((sum << 6) | row, INT32_MIN for a row >= n_valid in a bucket
//   that holds one), then the winner's sum times its bucket's scale,
//   re-packed and flushed (hopper.cuh: Reduce::I32Pack);
// - scale2d: the f32 sums times the row scales ([N] f32), the select of
//   rows >= n_valid, the packed bucket max.  The reference's ep_full_amk
//   computes the same, and so does its dotf32: Hopper has no s8 x s8 ->
//   f32 product, and the s32 sums converted after are the f32 sums of a
//   float accumulation (|sum| < 2^24).  Its [N / 128, 128] lane-dense
//   scale layout is a TPU layout; here all three read the same [N] scales
//   and run this one instantiation;
// - gscale: no scale operand (global-scale codes), the select, the
//   packed max: kernel 2's function with the mask unfolded;
// - ep_pack: the packed max of the f32 sums, no mask; the row scales are
//   loaded and not applied (the probe's operand);
// - full_t: scale2d written [B, buckets] (each winner to its query's
//   row, n_buckets floats apart).
//
// What bounds it on an H100: at N = 1,007,616, D = 128, B = 256 the bytes
// (129 MB of codes, 16 MB of winners, 4 MB of row scales where read:
// 43-45 us at 3.35 TB/s) above the 66 G int8 operations (33 us at 1,979
// TOP/s).  The design is kernel 2's (sweep.cuh: Dot::S8, resident
// queries); the epilogue is hopper.cuh's sweep_epilogue.

#include "hopper.cuh"
#include "sweep.cuh"

using hx::Dot;
using hx::Mask;
using hx::Reduce;
using hx::Scale;
using hx::Variant;

HX_SWEEP_ENTRY(hx_i8_sweep_i32pack,
               Variant<Dot::S8, Scale::Bucket, Mask::Tail, Reduce::I32Pack>)
HX_SWEEP_ENTRY(hx_i8_sweep_scale2d,
               Variant<Dot::S8, Scale::Row, Mask::Select, Reduce::Packed>)
HX_SWEEP_ENTRY(hx_i8_sweep_gscale,
               Variant<Dot::S8, Scale::None, Mask::Select, Reduce::Packed>)
HX_SWEEP_ENTRY(hx_i8_sweep_ep_pack,
               Variant<Dot::S8, Scale::RowUnused, Mask::None, Reduce::Packed>)
HX_SWEEP_ENTRY(
    hx_i8_sweep_full_t,
    Variant<Dot::S8, Scale::Row, Mask::Select, Reduce::Packed, true>)
