// Fast decimal -> binary64 conversion (Eisel-Lemire + SWAR digit
// parsing) for the JSON hot path.  Float parsing dominates
// vector-ingest JSON bodies (128 floats/doc; measured 8.8 of 9.0
// us/doc parse time under from_chars); this path measures ~37 ns per
// 17-significant-digit repr() token vs ~40 ns for libstdc++ 12's
// from_chars on this (noisy, 1-vCPU) box — the bigger wins are that
// it parses straight out of the buffer with no token pre-scan (the
// codec's number grammar walk merges into the conversion, worth ~2
// us/doc end-to-end: 9.0 -> 6.96 us/doc measured) and that overflow/
// underflow keep their sign+direction (from_chars result_out_of_range
// loses the direction; stdlib-json semantics need 1e-999 -> 0.0, and
// the previous from_chars wiring returned inf for it).
//
// Algorithm: Daniel Lemire, "Number Parsing at a Gigabyte per Second"
// (the Eisel-Lemire algorithm; public domain reference implementations
// in fast_float / simdjson).  Implemented from the paper:
//   - parse the decimal significand into a u64 (<= 19 digits) and the
//     decimal exponent q
//   - Clinger fast path when both are small enough for exact double
//     arithmetic
//   - otherwise two 64x64->128 multiplies against a normalized
//     128-bit 5^q table (the second word is always merged, so the
//     residual error is <= 2 units of the product's low word:
//     <= 1 from the dropped low x low cross term, <= 1 from the
//     table entry's truncation |e - T| < 1 scaled by w/2^64 < 1)
//   - ANY ambiguity falls back to std::from_chars, so results are
//     bit-exact with the standard library on every input.  The
//     fallback triggers are symmetric in the error direction (carry
//     AND borrow across the mantissa boundary, with margin 4 >> 2),
//     so correctness does not depend on which side of the true value
//     each table entry sits — see gen_pow5.py.
//
// The 651-entry table is generated exactly (Python big ints) by
// gen_pow5.py into fastdouble_pow5.h.
#pragma once

#include <charconv>
#include <cstdint>

#include "fastdouble_pow5.h"

namespace hxfloat {

static constexpr int POW5_MIN_Q = -342;
static constexpr int POW5_MAX_Q = 308;

#if defined(__SIZEOF_INT128__)
inline void mul128(uint64_t a, uint64_t b, uint64_t* hi, uint64_t* lo) {
    unsigned __int128 r = (unsigned __int128)a * b;
    *hi = (uint64_t)(r >> 64);
    *lo = (uint64_t)r;
}
#else
#error "128-bit integer support required"
#endif

// Compute the correctly-rounded double for w * 10^q (w != 0).
// Returns false when the truncated table cannot decide the rounding
// (caller falls back to from_chars).
inline bool eisel_lemire(uint64_t w, int64_t q, bool neg, double* out) {
    if (q < POW5_MIN_Q || q > POW5_MAX_Q) return false;  // 0 or inf
    int lz = __builtin_clzll(w);
    w <<= lz;
    const uint64_t* p5 = POW5_128[q - POW5_MIN_Q];
    uint64_t hi, lo, hi2, lo2;
    mul128(w, p5[0], &hi, &lo);
    mul128(w, p5[1], &hi2, &lo2);
    lo += hi2;
    if (lo < hi2) ++hi;
    // (hi:lo) is now within 2 low-word units of the true product
    // w * 5^q (normalized).  The 53-bit mantissa comes from hi's bits
    // [9+upper, 63]; the result is ambiguous only when that +-2 could
    // carry into (low 9 bits of hi all ones, lo nearly wrapping) or
    // borrow out of (all zeros, lo nearly zero) the mantissa bits —
    // including every exact round-to-even halfway pattern, which
    // lands in the borrow guard.  Margin 4 on both sides.
    if ((hi & 0x1FF) == 0x1FF && lo >= (uint64_t)0 - 4) return false;
    if ((hi & 0x1FF) == 0 && lo < 4) return false;
    uint64_t upper = hi >> 63;
    uint64_t mant = hi >> (upper + 9);  // 54 bits incl. the round bit
    // binary exponent: floor(q * log2(10)) via the fixed-point constant
    int64_t pow2 =
        (((152170 + 65536) * q) >> 16) + 1023 + 63 - lz + (int64_t)upper;
    if (pow2 <= 0) return false;  // subnormal: rare, delegate
    mant += mant & 1;  // round half up (exact halves delegated above)
    mant >>= 1;
    if (mant >= (1ULL << 53)) {
        mant >>= 1;
        ++pow2;
    }
    if (pow2 >= 2047) return false;  // overflow: delegate (inf)
    uint64_t bits = ((uint64_t)pow2 << 52) | (mant & ((1ULL << 52) - 1));
    if (neg) bits |= 1ULL << 63;
    double d;
    __builtin_memcpy(&d, &bits, 8);
    *out = d;
    return true;
}

// SWAR 8-digit parse (the standard public-domain trick from the same
// paper, little-endian): one 8-byte load replaces eight dependent
// w = w*10 + d steps — the digit loop, not the binary conversion, is
// what dominates 17-significant-digit tokens.
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
inline bool eight_digits(const char* q, uint64_t* out) {
    uint64_t chunk;
    __builtin_memcpy(&chunk, q, 8);
    if (((chunk & 0xF0F0F0F0F0F0F0F0ULL) |
         (((chunk + 0x0606060606060606ULL) & 0xF0F0F0F0F0F0F0F0ULL) >> 4)) !=
        0x3333333333333333ULL)
        return false;
    chunk = (chunk & 0x0F0F0F0F0F0F0F0FULL) * 2561 >> 8;
    chunk = (chunk & 0x00FF00FF00FF00FFULL) * 6553601 >> 16;
    *out = (chunk & 0x0000FFFF0000FFFFULL) * 42949672960001ULL >> 32;
    return true;
}
#else
inline bool eight_digits(const char*, uint64_t*) { return false; }
#endif

// Correctly-rounded slow path over the exact token [start, tok_end).
// ec==result_out_of_range leaves *out unmodified in libstdc++, so map
// it by the decimal exponent's sign (overflow -> +-inf as the
// existing codec did via HUGE_VAL; underflow -> +-0).
inline void slow_parse(const char* start, const char* tok_end, bool neg,
                       int64_t q, double* out) {
    auto res = std::from_chars(start, tok_end, *out);
    if (res.ec == std::errc::result_out_of_range)
        *out = q > 0 ? (neg ? -__builtin_huge_val() : __builtin_huge_val())
                     : (neg ? -0.0 : 0.0);
}

// Parse a JSON number token at [p, end).  On success returns the
// pointer past the token and stores the value; returns nullptr only
// for a malformed token (leading junk).  Bit-exact with from_chars.
// ``saw_float`` (optional) is set when the token had a '.' or
// exponent — callers that distinguish int-valued from float-valued
// literals get it free instead of re-scanning the token.
inline const char* parse_double(const char* p, const char* end, double* out,
                                bool* saw_float = nullptr) {
    const char* start = p;
    bool neg = false;
    if (p < end && *p == '-') {
        neg = true;
        ++p;
    }
    uint64_t w = 0;
    int n_digits = 0;
    uint64_t v8;
    while (end - p >= 8 && eight_digits(p, &v8)) {
        w = w * 100000000 + v8;  // wrap past 19 digits is fine: the
        p += 8;                  // >19 delegate below re-parses
        n_digits += 8;
    }
    while (p < end && (unsigned char)(*p - '0') <= 9) {
        w = w * 10 + (uint64_t)(*p - '0');
        ++p;
        ++n_digits;
    }
    int64_t q = 0;
    if (p < end && *p == '.') {
        if (saw_float) *saw_float = true;
        ++p;
        const char* frac_start = p;
        while (end - p >= 8 && eight_digits(p, &v8)) {
            w = w * 100000000 + v8;
            p += 8;
            n_digits += 8;
        }
        while (p < end && (unsigned char)(*p - '0') <= 9) {
            w = w * 10 + (uint64_t)(*p - '0');
            ++p;
            ++n_digits;
        }
        q = -(int64_t)(p - frac_start);
        if (p == frac_start) return nullptr;  // "1." is not JSON
    }
    if (n_digits == 0) return nullptr;
    if (p < end && (*p == 'e' || *p == 'E')) {
        if (saw_float) *saw_float = true;
        ++p;
        bool eneg = false;
        if (p < end && (*p == '+' || *p == '-')) {
            eneg = *p == '-';
            ++p;
        }
        const char* exp_start = p;
        int64_t e = 0;
        while (p < end && (unsigned char)(*p - '0') <= 9) {
            if (e < 100000000) e = e * 10 + (*p - '0');
            ++p;
        }
        if (p == exp_start) return nullptr;
        q += eneg ? -e : e;
    }
    if (n_digits > 19) {
        // possible u64 overflow of the significand: delegate (rare;
        // repr() emits <= 17 significant digits)
        slow_parse(start, p, neg, q + n_digits, out);
        return p;
    }
    if (w == 0) {
        *out = neg ? -0.0 : 0.0;
        return p;
    }
    // Clinger exact path: double(w) exact and 10^|q| exactly
    // representable -> one exact multiply/divide
    if (-22 <= q && q <= 22 && w < (1ULL << 53)) {
        static const double P10[] = {
            1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10,
            1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19,
            1e20, 1e21, 1e22,
        };
        double d = (double)w;
        d = q >= 0 ? d * P10[q] : d / P10[-q];
        *out = neg ? -d : d;
        return p;
    }
    if (eisel_lemire(w, q, neg, out)) return p;
    slow_parse(start, p, neg, q, out);
    return p;
}

}  // namespace hxfloat
