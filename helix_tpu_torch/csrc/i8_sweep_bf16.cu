// Kernel 5, its bf16 forms: the int8 coarse-kernel experiment's variants
// that multiply on the bf16 tensor cores.
//
// Replaces benchmarks/i8_sweep.py's k_bf16dot (:176; bf16dot and
// bf16dot_tail) and k_dot(as_bf16=True) (:284; dot_bf16), launched
// through its `call` (pallas_call at :359).  The int8 row tile is
// converted to bf16 in the kernel and multiplied against the int8 queries
// converted to bf16 (the caller converts them, as the reference does),
// with f32 sums; every |v| <= 127 is a bf16 and every sum is an integer
// below 2^24 at D = 128, so the dots equal the int8 forms' bit for bit.
//
// - bf16dot: the dots times the row scales ([N] f32), the select of rows
//   >= n_valid in every bucket, the packed bucket max;
// - bf16dot_tail: the same with the select only in buckets holding a row
//   >= n_valid;
// - dot_bf16: the dots' plain bucket max, no mask, no scale, no pack.
//
// What bounds it on an H100: at N = 1,007,616, D = 128, B = 256 the bf16
// products (66 GFLOP, 67 us at 989 TFLOP/s: half the int8 rate on this
// card, unlike the TPU the sweep was written for) above the bytes (129
// MB of codes, 4 MB of row scales, 16 MB of winners: 45 us).  The design:
// kernel 2's int8 ring, then each consumer warpgroup converts its stage
// into a 16 KB bf16 staging tile in the 128-byte swizzle (sweep.cuh:
// converted_products) and issues kernel 1's products on it; the
// conversion does not overlap that warpgroup's products, only the other
// warpgroup's.

#include "hopper.cuh"
#include "sweep.cuh"

using hx::Dot;
using hx::Mask;
using hx::Reduce;
using hx::Scale;
using hx::Variant;

HX_SWEEP_ENTRY(
    hx_i8_sweep_bf16dot,
    Variant<Dot::S8AsBf16, Scale::Row, Mask::Select, Reduce::Packed>)
HX_SWEEP_ENTRY(hx_i8_sweep_bf16dot_tail,
               Variant<Dot::S8AsBf16, Scale::Row, Mask::Tail, Reduce::Packed>)
HX_SWEEP_ENTRY(hx_i8_sweep_dot_bf16,
               Variant<Dot::S8AsBf16, Scale::None, Mask::None, Reduce::Max>)
