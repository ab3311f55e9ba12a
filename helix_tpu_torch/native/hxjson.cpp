// hxjson — fast JSON codec as a CPython extension.
//
// The serving hot path (gateway request decode + response encode) and the
// bulk-ingest path are JSON-bound in stdlib `json`; this module provides
// drop-in `loads`/`dumps` with stdlib-compatible semantics:
//
//   loads(bytes|str) -> obj     objects→dict, arrays→list, last-dup-key wins,
//                               ints of any magnitude, NaN/Infinity accepted
//                               (stdlib default), full \uXXXX + surrogate pairs.
//   dumps(obj, compact=False) -> str
//                               ensure_ascii=False; float formatting matches
//                               repr() (shortest round-trip, Python notation);
//                               compact=True uses (",", ":") separators,
//                               default matches stdlib (", ", ": ").
//
// Reference analog: the engine gateway parses/serializes its wire JSON in
// native code (sonic-rs in the Rust SDK, sdks/rust/src/lib.rs:407-409);
// this is the rebuild's native codec.  Fallback: helix_tpu.fastjson wraps
// stdlib json when the extension is unavailable.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <charconv>
#include <string>
#include <vector>

#include "fastdouble.h"

// ---------------------------------------------------------------- parser

namespace {

// array.array type, resolved once at module init (fast_arrays mode).
PyObject* g_array_type = nullptr;

struct Parser {
    const char* p;
    const char* end;
    const char* begin;
    int depth = 0;
    bool fast_arrays = false;
    // fast_arrays: JSON arrays of >= this many numbers, at least one
    // non-integer, parse straight into an array.array('d') — no
    // per-element PyFloat boxing (the bulk-ingest hot path).
    static constexpr size_t FAST_ARRAY_MIN = 32;

    // Object-key intern cache: wire bodies repeat the same few keys
    // tens of thousands of times ("title"/"emb" twice per ingest doc),
    // and decoding each occurrence to a fresh PyUnicode is measurable
    // (~1 us/doc at 128-d).  Open-addressed, keyed on FNV-1a of the
    // raw escape-free bytes; entries own one reference, dropped in the
    // destructor.  Collisions just overwrite (newest wins).
    static constexpr size_t KEY_CACHE = 64;   // power of two
    static constexpr uint32_t KEY_MAX = 40;
    struct KeyEnt {
        uint64_t h = 0;
        uint32_t len = 0;
        char bytes[KEY_MAX];
        PyObject* obj = nullptr;
    };
    KeyEnt key_cache[KEY_CACHE];

    explicit Parser(const char* data, Py_ssize_t len)
        : p(data), end(data + len), begin(data) {}

    ~Parser() {
        for (auto& e : key_cache) Py_XDECREF(e.obj);
    }

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
            ++p;
    }

    PyObject* fail(const char* msg) {
        PyErr_Format(PyExc_ValueError, "%s: char %zd", msg,
                     (Py_ssize_t)(p - begin));
        return nullptr;
    }

    bool lit(const char* s, size_t n) {
        if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
        p += n;
        return true;
    }

    PyObject* parse_value() {
        if (depth > 800) return fail("too deeply nested");
        skip_ws();
        if (p >= end) return fail("unexpected end of input");
        switch (*p) {
            case '{': return parse_object();
            case '[': return parse_array();
            case '"': return parse_string();
            case 't':
                if (lit("true", 4)) Py_RETURN_TRUE;
                return fail("invalid literal");
            case 'f':
                if (lit("false", 5)) Py_RETURN_FALSE;
                return fail("invalid literal");
            case 'n':
                if (lit("null", 4)) Py_RETURN_NONE;
                return fail("invalid literal");
            case 'N':
                if (lit("NaN", 3)) return PyFloat_FromDouble(NAN);
                return fail("invalid literal");
            case 'I':
                if (lit("Infinity", 8)) return PyFloat_FromDouble(INFINITY);
                return fail("invalid literal");
            default: return parse_number();
        }
    }

    PyObject* parse_object() {
        ++p;  // '{'
        ++depth;
        PyObject* d = PyDict_New();
        if (!d) return nullptr;
        skip_ws();
        if (p < end && *p == '}') { ++p; --depth; return d; }
        for (;;) {
            skip_ws();
            if (p >= end || *p != '"') { Py_DECREF(d); return fail("expected object key"); }
            PyObject* key = parse_key();
            if (!key) { Py_DECREF(d); return nullptr; }
            skip_ws();
            if (p >= end || *p != ':') {
                Py_DECREF(key); Py_DECREF(d);
                return fail("expected ':'");
            }
            ++p;
            PyObject* val = parse_value();
            if (!val) { Py_DECREF(key); Py_DECREF(d); return nullptr; }
            int rc = PyDict_SetItem(d, key, val);
            Py_DECREF(key);
            Py_DECREF(val);
            if (rc < 0) { Py_DECREF(d); return nullptr; }
            skip_ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == '}') { ++p; --depth; return d; }
            Py_DECREF(d);
            return fail("expected ',' or '}'");
        }
    }

    // Attempt the numeric fast path from just after '['.  Returns:
    //  1 -> success, *out is an array.array('d'), p advanced past ']'
    //  0 -> not applicable (rewound; caller parses generically)
    // -1 -> hard parse error (PyErr set)
    std::vector<double> num_scratch;  // reused across arrays

    int try_numeric_array(PyObject** out) {
        const char* save = p;
        std::vector<double>& buf = num_scratch;
        buf.clear();
        bool any_float = false;
        const char* q = p;
        q = skip_ws_at(q);
        if (q < end && *q == ']') { p = save; return 0; }
        for (;;) {
            q = skip_ws_at(q);
            if (q >= end) { p = save; return 0; }
            char c = *q;
            if (!((c >= '0' && c <= '9') || c == '-')) { p = save; return 0; }
            double d;
            // Eisel-Lemire fast path (fastdouble.h): float parsing
            // dominates vector-ingest bodies (measured 8.8 of 9.0
            // us/doc at 128-d under from_chars); saw_float replaces a
            // second token scan for '.'/'e'
            const char* np = hxfloat::parse_double(q, end, &d, &any_float);
            if (!np) { p = save; return 0; }
            buf.push_back(d);
            q = skip_ws_at(np);
            if (q < end && *q == ',') { ++q; continue; }
            if (q < end && *q == ']') { ++q; break; }
            p = save;
            return 0;
        }
        if (buf.size() < FAST_ARRAY_MIN || !any_float) { p = save; return 0; }
        PyObject* bytes = PyBytes_FromStringAndSize(
            (const char*)buf.data(), (Py_ssize_t)(buf.size() * sizeof(double)));
        if (!bytes) return -1;
        PyObject* arr = PyObject_CallFunction(g_array_type, "sO", "d", bytes);
        Py_DECREF(bytes);
        if (!arr) return -1;
        p = q;
        *out = arr;
        return 1;
    }

    const char* skip_ws_at(const char* q) const {
        while (q < end && (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r'))
            ++q;
        return q;
    }

    PyObject* parse_array() {
        ++p;  // '['
        ++depth;
        if (fast_arrays && g_array_type) {
            PyObject* arr = nullptr;
            int rc = try_numeric_array(&arr);
            if (rc != 0) {
                --depth;
                return rc == 1 ? arr : nullptr;
            }
        }
        PyObject* lst = PyList_New(0);
        if (!lst) return nullptr;
        skip_ws();
        if (p < end && *p == ']') { ++p; --depth; return lst; }
        for (;;) {
            PyObject* val = parse_value();
            if (!val) { Py_DECREF(lst); return nullptr; }
            int rc = PyList_Append(lst, val);
            Py_DECREF(val);
            if (rc < 0) { Py_DECREF(lst); return nullptr; }
            skip_ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == ']') { ++p; --depth; return lst; }
            Py_DECREF(lst);
            return fail("expected ',' or ']'");
        }
    }

    // Object keys only: short escape-free keys hit the intern cache
    // (one FNV-1a pass doubles as the scan); anything else falls back
    // to parse_string with p still at the opening quote.
    PyObject* parse_key() {
        const char* start = p + 1;
        const char* q = start;
        uint64_t h = 1469598103934665603ULL;
        while (q < end) {
            unsigned char c = (unsigned char)*q;
            if (c == '"') break;
            if (c == '\\' || c < 0x20) return parse_string();
            h = (h ^ c) * 1099511628211ULL;
            ++q;
        }
        if (q >= end) return parse_string();  // unterminated: error path
        uint32_t len = (uint32_t)(q - start);
        if (len > KEY_MAX) {
            PyObject* s = PyUnicode_DecodeUTF8(start, len, "strict");
            if (s) p = q + 1;
            return s;
        }
        KeyEnt& e = key_cache[h & (KEY_CACHE - 1)];
        if (e.obj && e.h == h && e.len == len &&
            memcmp(e.bytes, start, len) == 0) {
            p = q + 1;
            Py_INCREF(e.obj);
            return e.obj;
        }
        PyObject* s = PyUnicode_DecodeUTF8(start, len, "strict");
        if (!s) return nullptr;
        p = q + 1;
        Py_XDECREF(e.obj);
        e.h = h;
        e.len = len;
        memcpy(e.bytes, start, len);
        e.obj = s;
        Py_INCREF(s);
        return s;
    }

    static int hex4(const char* s) {
        int v = 0;
        for (int i = 0; i < 4; ++i) {
            char c = s[i];
            v <<= 4;
            if (c >= '0' && c <= '9') v |= c - '0';
            else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
            else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
            else return -1;
        }
        return v;
    }

    static void append_utf8(std::string& out, uint32_t cp) {
        if (cp < 0x80) {
            out.push_back((char)cp);
        } else if (cp < 0x800) {
            out.push_back((char)(0xC0 | (cp >> 6)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
            out.push_back((char)(0xE0 | (cp >> 12)));
            out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        } else {
            out.push_back((char)(0xF0 | (cp >> 18)));
            out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
            out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        }
    }

    PyObject* parse_string() {
        ++p;  // '"'
        const char* start = p;
        // fast scan: no escapes
        while (p < end && *p != '"' && *p != '\\' &&
               (unsigned char)*p >= 0x20)
            ++p;
        if (p < end && *p == '"') {
            PyObject* s = PyUnicode_DecodeUTF8(start, p - start, "strict");
            ++p;
            return s;
        }
        // slow path with escapes
        std::string buf(start, p - start);
        // stdlib json accepts lone \uD800-\uDFFF escapes and returns
        // the unpaired surrogate in the Python string; our UTF-8 buffer
        // then holds a surrogate encoding that "strict" rejects, so
        // those strings decode with "surrogatepass" — and the decoded
        // result is then checked to contain EXACTLY as many surrogate
        // chars as validated escapes produced, so raw CESU-8 surrogate
        // bytes elsewhere in the same string still fail like stdlib
        int lone_surrogates = 0;
        while (p < end) {
            unsigned char c = (unsigned char)*p;
            if (c == '"') {
                ++p;
                if (lone_surrogates == 0)
                    return PyUnicode_DecodeUTF8(buf.data(), buf.size(),
                                                "strict");
                PyObject* s = PyUnicode_DecodeUTF8(
                    buf.data(), buf.size(), "surrogatepass");
                if (!s) return nullptr;
                Py_ssize_t n = PyUnicode_GET_LENGTH(s);
                int kind = PyUnicode_KIND(s);
                const void* data = PyUnicode_DATA(s);
                int found = 0;
                for (Py_ssize_t i = 0; i < n; ++i) {
                    Py_UCS4 cp = PyUnicode_READ(kind, data, i);
                    if (cp >= 0xD800 && cp <= 0xDFFF) ++found;
                }
                if (found != lone_surrogates) {
                    Py_DECREF(s);
                    return fail("invalid UTF-8 in string");
                }
                return s;
            }
            if (c == '\\') {
                if (p + 1 >= end) return fail("bad escape");
                char e = p[1];
                p += 2;
                switch (e) {
                    case '"': buf.push_back('"'); break;
                    case '\\': buf.push_back('\\'); break;
                    case '/': buf.push_back('/'); break;
                    case 'b': buf.push_back('\b'); break;
                    case 'f': buf.push_back('\f'); break;
                    case 'n': buf.push_back('\n'); break;
                    case 'r': buf.push_back('\r'); break;
                    case 't': buf.push_back('\t'); break;
                    case 'u': {
                        if (end - p < 4) return fail("bad \\u escape");
                        int v = hex4(p);
                        if (v < 0) return fail("bad \\u escape");
                        p += 4;
                        uint32_t cp = (uint32_t)v;
                        if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
                            p[0] == '\\' && p[1] == 'u') {
                            int lo = hex4(p + 2);
                            if (lo >= 0xDC00 && lo <= 0xDFFF) {
                                cp = 0x10000 + ((cp - 0xD800) << 10) +
                                     ((uint32_t)lo - 0xDC00);
                                p += 6;
                            }
                        }
                        if (cp >= 0xD800 && cp <= 0xDFFF)
                            ++lone_surrogates;  // unpaired escape
                        append_utf8(buf, cp);
                        break;
                    }
                    default: return fail("bad escape");
                }
                continue;
            }
            if (c < 0x20) return fail("control character in string");
            buf.push_back((char)c);
            ++p;
        }
        return fail("unterminated string");
    }

    PyObject* parse_number() {
        const char* start = p;
        if (p < end && *p == '-') {
            ++p;
            if (p < end && *p == 'I') {
                if (lit("Infinity", 8)) return PyFloat_FromDouble(-INFINITY);
                return fail("invalid literal");
            }
        }
        bool is_float = false;
        while (p < end) {
            char c = *p;
            if (c >= '0' && c <= '9') { ++p; continue; }
            if (c == '.' || c == 'e' || c == 'E' || c == '+' || c == '-') {
                if (c == '.' || c == 'e' || c == 'E') is_float = true;
                ++p;
                continue;
            }
            break;
        }
        if (p == start) return fail("invalid number");
        if (is_float) {
            double d;
            // parse_double maps overflow to +-inf and underflow to
            // +-0 like stdlib json (from_chars result_out_of_range
            // loses the direction).
            const char* np = hxfloat::parse_double(start, p, &d);
            if (np != p) return fail("invalid number");
            return PyFloat_FromDouble(d);
        }
        // integer: long long fast path, PyLong fallback for big ints
        long long ll;
        auto res = std::from_chars(start, p, ll);
        if (res.ec == std::errc() && res.ptr == p)
            return PyLong_FromLongLong(ll);
        unsigned long long ull;
        res = std::from_chars(start, p, ull);
        if (res.ec == std::errc() && res.ptr == p)
            return PyLong_FromUnsignedLongLong(ull);
        std::string tmp(start, p - start);
        return PyLong_FromString(tmp.c_str(), nullptr, 10);
    }
};

// ---------------------------------------------------------------- encoder

struct Encoder {
    std::string out;
    bool compact;
    // Strict-JSON mode for wire responses: non-finite floats encode as
    // null (bare NaN/Infinity tokens are not JSON and break strict
    // clients; the reference's serde/sonic-rs never emit them —
    // sdks/rust/src/lib.rs:407-409).  Internal persistence (WAL,
    // snapshots) keeps the stdlib-compatible literals for lossless
    // round-trips.
    bool nan_null = false;
    const char* item_sep;
    size_t item_sep_len;
    const char* kv_sep;
    size_t kv_sep_len;

    explicit Encoder(bool compact_) : compact(compact_) {
        if (compact) {
            item_sep = ","; item_sep_len = 1;
            kv_sep = ":"; kv_sep_len = 1;
        } else {
            item_sep = ", "; item_sep_len = 2;
            kv_sep = ": "; kv_sep_len = 2;
        }
        out.reserve(256);
    }

    bool fail_type(PyObject* obj) {
        PyErr_Format(PyExc_TypeError,
                     "Object of type %.100s is not JSON serializable",
                     Py_TYPE(obj)->tp_name);
        return false;
    }

    void put(const char* s, size_t n) { out.append(s, n); }

    bool encode_string(PyObject* s) {
        Py_ssize_t len;
        const char* data = PyUnicode_AsUTF8AndSize(s, &len);
        if (!data) return false;
        out.push_back('"');
        const char* cur = data;
        const char* stop = data + len;
        const char* run = cur;
        while (cur < stop) {
            unsigned char c = (unsigned char)*cur;
            if (c == '"' || c == '\\' || c < 0x20) {
                out.append(run, cur - run);
                switch (c) {
                    case '"': out += "\\\""; break;
                    case '\\': out += "\\\\"; break;
                    case '\b': out += "\\b"; break;
                    case '\f': out += "\\f"; break;
                    case '\n': out += "\\n"; break;
                    case '\r': out += "\\r"; break;
                    case '\t': out += "\\t"; break;
                    default: {
                        char buf[8];
                        snprintf(buf, sizeof buf, "\\u%04x", c);
                        out += buf;
                    }
                }
                ++cur;
                run = cur;
            } else {
                ++cur;
            }
        }
        out.append(run, cur - run);
        out.push_back('"');
        return true;
    }

    // Python repr() float formatting: shortest round-trip digits;
    // fixed notation for exponent in [-4, 16), otherwise e-notation
    // with sign and at least two exponent digits.
    void encode_double(double v) {
        if (std::isnan(v)) { out += nan_null ? "null" : "NaN"; return; }
        if (std::isinf(v)) {
            if (nan_null) { out += "null"; return; }
            out += v > 0 ? "Infinity" : "-Infinity";
            return;
        }
        char buf[64];
        // shortest round-trip digits in scientific form: d.ddddde±xx
        auto res = std::to_chars(buf, buf + sizeof buf, v,
                                 std::chars_format::scientific);
        *res.ptr = '\0';
        // split: [-]D[.DDDD]e±EE
        char* e = strchr(buf, 'e');
        int exp10 = atoi(e + 1);
        std::string digits;
        bool neg = buf[0] == '-';
        for (char* c = buf + (neg ? 1 : 0); c < e; ++c)
            if (*c != '.') digits.push_back(*c);
        // strip trailing zeros (to_chars shortest shouldn't have any, but safe)
        while (digits.size() > 1 && digits.back() == '0') digits.pop_back();
        if (neg) out.push_back('-');
        if (exp10 >= -4 && exp10 < 16) {
            if (exp10 >= 0) {
                if ((size_t)exp10 + 1 >= digits.size()) {
                    out += digits;
                    out.append((size_t)exp10 + 1 - digits.size(), '0');
                    out += ".0";
                } else {
                    out.append(digits, 0, (size_t)exp10 + 1);
                    out.push_back('.');
                    out.append(digits, (size_t)exp10 + 1, std::string::npos);
                }
            } else {
                out += "0.";
                out.append((size_t)(-exp10 - 1), '0');
                out += digits;
            }
        } else {
            out += digits.substr(0, 1);
            if (digits.size() > 1) {
                out.push_back('.');
                out.append(digits, 1, std::string::npos);
            }
            char ebuf[16];
            snprintf(ebuf, sizeof ebuf, "e%+03d", exp10);
            out += ebuf;
        }
    }

    bool encode_long(PyObject* v) {
        int overflow = 0;
        long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (!overflow) {
            if (ll == -1 && PyErr_Occurred()) return false;
            char buf[24];
            auto res = std::to_chars(buf, buf + sizeof buf, ll);
            put(buf, res.ptr - buf);
            return true;
        }
        if (overflow > 0) {
            unsigned long long ull = PyLong_AsUnsignedLongLong(v);
            if (ull != (unsigned long long)-1 || !PyErr_Occurred()) {
                char buf[24];
                auto res = std::to_chars(buf, buf + sizeof buf, ull);
                put(buf, res.ptr - buf);
                return true;
            }
            PyErr_Clear();
        }
        PyObject* s = PyObject_Str(v);
        if (!s) return false;
        Py_ssize_t len;
        const char* data = PyUnicode_AsUTF8AndSize(s, &len);
        if (!data) { Py_DECREF(s); return false; }
        put(data, len);
        Py_DECREF(s);
        return true;
    }

    // stdlib skipkeys=False key coercion: str as-is; int/float/bool/None
    // become their JSON-literal spelled string.
    bool encode_key(PyObject* key) {
        if (PyUnicode_Check(key)) return encode_string(key);
        out.push_back('"');
        if (key == Py_True) out += "true";
        else if (key == Py_False) out += "false";
        else if (key == Py_None) out += "null";
        else if (PyLong_Check(key)) { if (!encode_long(key)) return false; }
        else if (PyFloat_Check(key)) encode_double(PyFloat_AS_DOUBLE(key));
        else {
            PyErr_SetString(PyExc_TypeError,
                            "keys must be str, int, float, bool or None");
            return false;
        }
        out.push_back('"');
        return true;
    }

    bool encode(PyObject* obj, int depth) {
        if (depth > 800) {
            PyErr_SetString(PyExc_ValueError, "circular or too deep");
            return false;
        }
        if (obj == Py_None) { out += "null"; return true; }
        if (obj == Py_True) { out += "true"; return true; }
        if (obj == Py_False) { out += "false"; return true; }
        if (PyUnicode_Check(obj)) return encode_string(obj);
        if (PyLong_Check(obj)) return encode_long(obj);
        if (PyFloat_Check(obj)) { encode_double(PyFloat_AS_DOUBLE(obj)); return true; }
        if (PyDict_Check(obj)) {
            out.push_back('{');
            PyObject *key, *value;
            Py_ssize_t pos = 0;
            bool first = true;
            while (PyDict_Next(obj, &pos, &key, &value)) {
                if (!first) put(item_sep, item_sep_len);
                first = false;
                if (!encode_key(key)) return false;
                put(kv_sep, kv_sep_len);
                if (!encode(value, depth + 1)) return false;
            }
            out.push_back('}');
            return true;
        }
        if (PyList_Check(obj) || PyTuple_Check(obj)) {
            out.push_back('[');
            Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
            PyObject** items = PySequence_Fast_ITEMS(obj);
            for (Py_ssize_t i = 0; i < n; ++i) {
                if (i) put(item_sep, item_sep_len);
                if (!encode(items[i], depth + 1)) return false;
            }
            out.push_back(']');
            return true;
        }
        // 1-D numeric buffers (array.array('d'/'q'/'l'), float64/int64
        // ndarrays): emit numbers straight from the buffer — the WAL and
        // replication payloads carry fast-parsed vectors this way.
        if (PyObject_CheckBuffer(obj)) {
            Py_buffer view;
            if (PyObject_GetBuffer(obj, &view,
                                   PyBUF_ND | PyBUF_FORMAT | PyBUF_C_CONTIGUOUS) == 0) {
                const char* fmt = view.format ? view.format : "B";
                bool is_d = strcmp(fmt, "d") == 0;
                bool is_q = strcmp(fmt, "q") == 0 || strcmp(fmt, "l") == 0;
                if (view.ndim == 1 && (is_d || is_q)) {
                    out.push_back('[');
                    Py_ssize_t n = view.shape[0];
                    for (Py_ssize_t i = 0; i < n; ++i) {
                        if (i) put(item_sep, item_sep_len);
                        if (is_d) {
                            // NaN/Infinity literals, matching the scalar
                            // float path (stdlib default behavior)
                            encode_double(((const double*)view.buf)[i]);
                        } else {
                            char buf[24];
                            auto res = std::to_chars(
                                buf, buf + sizeof buf,
                                ((const long long*)view.buf)[i]);
                            put(buf, res.ptr - buf);
                        }
                    }
                    out.push_back(']');
                    PyBuffer_Release(&view);
                    return true;
                }
                PyBuffer_Release(&view);
            } else {
                PyErr_Clear();
            }
        }
        // bool/int/float subclasses (e.g. numpy scalars via __index__ won't
        // appear here; engine encodes to plain types first)
        return fail_type(obj);
    }
};

// ---------------------------------------------------------------- module

PyObject* hx_loads(PyObject*, PyObject* args, PyObject* kwargs) {
    PyObject* arg;
    int fast_arrays = 0;
    static const char* kwlist[] = {"data", "fast_arrays", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|p",
                                     const_cast<char**>(kwlist), &arg,
                                     &fast_arrays))
        return nullptr;
    const char* data;
    Py_ssize_t len;
    Py_buffer view = {};
    if (PyUnicode_Check(arg)) {
        data = PyUnicode_AsUTF8AndSize(arg, &len);
        if (!data) return nullptr;
    } else if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) == 0) {
        data = (const char*)view.buf;
        len = view.len;
    } else {
        return nullptr;
    }
    Parser parser(data, len);
    parser.fast_arrays = fast_arrays != 0;
    PyObject* result = parser.parse_value();
    if (result) {
        parser.skip_ws();
        if (parser.p != parser.end) {
            Py_DECREF(result);
            result = parser.fail("extra data");
        }
    }
    if (view.obj) PyBuffer_Release(&view);
    return result;
}

PyObject* hx_dumps(PyObject*, PyObject* args, PyObject* kwargs) {
    PyObject* obj;
    int compact = 0;
    int nan_null = 0;
    static const char* kwlist[] = {"obj", "compact", "nan_null", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|pp",
                                     const_cast<char**>(kwlist), &obj,
                                     &compact, &nan_null))
        return nullptr;
    Encoder enc(compact != 0);
    enc.nan_null = nan_null != 0;
    if (!enc.encode(obj, 0)) return nullptr;
    return PyUnicode_DecodeUTF8(enc.out.data(), enc.out.size(), "strict");
}

PyObject* hx_dumpb(PyObject*, PyObject* args, PyObject* kwargs) {
    PyObject* obj;
    int compact = 0;
    int nan_null = 0;
    static const char* kwlist[] = {"obj", "compact", "nan_null", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|pp",
                                     const_cast<char**>(kwlist), &obj,
                                     &compact, &nan_null))
        return nullptr;
    Encoder enc(compact != 0);
    enc.nan_null = nan_null != 0;
    if (!enc.encode(obj, 0)) return nullptr;
    return PyBytes_FromStringAndSize(enc.out.data(), enc.out.size());
}

PyMethodDef methods[] = {
    {"loads", (PyCFunction)(void*)hx_loads, METH_VARARGS | METH_KEYWORDS,
     "Parse JSON from str/bytes; fast_arrays=True parses numeric arrays "
     "into array.array('d')."},
    {"dumps", (PyCFunction)(void*)hx_dumps, METH_VARARGS | METH_KEYWORDS,
     "Serialize to a JSON str (ensure_ascii=False semantics)."},
    {"dumpb", (PyCFunction)(void*)hx_dumpb, METH_VARARGS | METH_KEYWORDS,
     "Serialize to UTF-8 JSON bytes."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "hxjson", "fast JSON codec", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_hxjson(void) {
    PyObject* mod = PyModule_Create(&moduledef);
    if (!mod) return nullptr;
    PyObject* array_mod = PyImport_ImportModule("array");
    if (array_mod) {
        g_array_type = PyObject_GetAttrString(array_mod, "array");
        Py_DECREF(array_mod);
    }
    if (!g_array_type) PyErr_Clear();  // fast_arrays simply disabled
    return mod;
}
