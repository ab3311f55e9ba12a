// Kernel 5, its probes: the int8 coarse-kernel experiment's variants
// that end in a plain (unpacked) bucket max.
//
// Replaces benchmarks/i8_sweep.py's k_dot(as_bf16=False) (:284; dot_i8,
// and xT's kernel) and k_epilogue (:304 via make_ep :525) at the flag
// sets of ep_astype, ep_scale, ep_mask and amk, launched through `call`
// (pallas_call at :359).  On exact int32 sums of int8 rows and int8
// queries (kernel 2's products):
//
// - dot_i8: the f32 sums' bucket max, nothing else;
// - ep_astype: the same with the row scales ([N] f32) loaded and not
//   applied (the reference brings the operand in);
// - ep_scale: the f32 sums times the row scales, the bucket max;
// - ep_mask: the select of rows >= n_valid, the bucket max (scales
//   loaded, not applied);
// - amk: the int max of the raw sums, converted to f32 after the
//   reduction (scales loaded, not applied).
//
// What bounds it on an H100: the bytes, as for the packed forms
// (i8_sweep_packed.cu), 43-45 us at N = 1,007,616, D = 128, B = 256.

#include "hopper.cuh"
#include "sweep.cuh"

using hx::Dot;
using hx::Mask;
using hx::Reduce;
using hx::Scale;
using hx::Variant;

HX_SWEEP_ENTRY(hx_i8_sweep_dot_i8,
               Variant<Dot::S8, Scale::None, Mask::None, Reduce::Max>)
HX_SWEEP_ENTRY(hx_i8_sweep_ep_astype,
               Variant<Dot::S8, Scale::RowUnused, Mask::None, Reduce::Max>)
HX_SWEEP_ENTRY(hx_i8_sweep_ep_scale,
               Variant<Dot::S8, Scale::Row, Mask::None, Reduce::Max>)
HX_SWEEP_ENTRY(hx_i8_sweep_ep_mask,
               Variant<Dot::S8, Scale::RowUnused, Mask::Select, Reduce::Max>)
HX_SWEEP_ENTRY(hx_i8_sweep_amk,
               Variant<Dot::S8, Scale::RowUnused, Mask::None, Reduce::IntMax>)
