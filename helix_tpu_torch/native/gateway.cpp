// hxgw — native HTTP gateway for the helix-tpu engine.
//
// The reference serves its wire protocol from compiled Rust behind
// `POST /v1/query` / `/v1/query/<name>` (sdks/rust/src/lib.rs:377-423);
// round 1 served it from Python's ThreadingHTTPServer + stdlib json and
// measured ~50x below the device rate.  This gateway moves the serving
// runtime to native code:
//
//   - epoll IO thread: HTTP/1.1 framing, keep-alive, pipelining,
//     auth check, header flag extraction.
//   - FAST ROUTES: stored vector-search queries registered by the host.
//     Request bodies ({"<vec>":[...], "<k>":N}) are parsed to float32
//     in C++, pulled by Python in BATCHES (one GIL crossing per batch,
//     one MXU dispatch per batch), and responses ({"name":[{"$id":..,
//     "$distance":..},..]}) are formatted back in C++ with Python-repr
//     float formatting so fast- and slow-path payloads are identical.
//   - GENERAL ROUTES: body bytes handed to Python workers; responses
//     (and SSE-style streaming) written back through the IO thread.
//
// Per-connection responses are sequenced so pipelined requests always
// complete in order.  All entry points are C ABI for ctypes.
#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdio.h>
#include <string.h>
#include <strings.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <charconv>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "fastdouble.h"

namespace {

// ---------------------------------------------------------------- utils

// Python repr() float formatting (shared semantics with hxjson.cpp):
// shortest round-trip digits; fixed for exponent in [-4,16), else
// e-notation with signed two-digit exponent.
void format_double(std::string& out, double v) {
    // Responses are strict JSON: bare NaN/Infinity tokens are not JSON
    // and break strict clients (reference serde/sonic-rs never emit
    // them, sdks/rust/src/lib.rs:407-409) — encode non-finite as null.
    if (!std::isfinite(v)) { out += "null"; return; }
    char buf[64];
    auto res = std::to_chars(buf, buf + sizeof buf, v,
                             std::chars_format::scientific);
    *res.ptr = '\0';
    char* e = strchr(buf, 'e');
    int exp10 = atoi(e + 1);
    bool neg = buf[0] == '-';
    std::string digits;
    for (char* c = buf + (neg ? 1 : 0); c < e; ++c)
        if (*c != '.') digits.push_back(*c);
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

bool iequal(const char* a, size_t alen, const char* b) {
    size_t blen = strlen(b);
    if (alen != blen) return false;
    for (size_t i = 0; i < alen; ++i)
        if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i]))
            return false;
    return true;
}

// request header flags
enum {
    F_WARM = 1,
    F_REQUIRE_WRITER = 2,
    F_NO_DURABLE = 4,   // x-helix-await-durable: false
    F_TRACE = 8,
};

// ---------------------------------------------------------------- types

struct FastRoute {
    std::string path;      // "/v1/query/<name>"
    std::string vec_key;
    std::string k_key;     // empty => k fixed
    std::string tenant_key;  // empty => untenanted route
    int k_default;
    int k_max;
    int dim;
    int route_id;
    std::string resp_prefix;   // '{"hits":['
    std::string resp_suffix;   // ']}'
    std::string id_key;        // "$id"
    std::string dist_key;      // "$distance"
};

// longest tenant value the fast path carries (incl. NUL); longer ones
// fall back to the interpreter
static const int TENANT_CAP = 128;

// Dynamic fast routes (round 4): general `POST /v1/query` reads whose
// *plan* (everything outside the "parameters" member) was seen before.
// The host interprets the first occurrence, checks eligibility, and
// registers the plan's SKELETON (body bytes with the parameters value
// replaced by {}); identical-plan requests afterwards are parsed and
// served natively — vector searches through the vbatch queue, point
// lookups straight from the blob cache without touching Python at all.
struct DynRoute {
    int kind;            // 1 = vector search (vbatch), 2 = point lookup
    FastRoute fr;        // vector kind: parse/format template (path unused)
    std::string ids_key;   // lookup kind: parameters member holding ids
    std::string prefix, suffix;  // lookup kind response framing
};

// bounds: skeletons over this size or tables past these caps stay on
// the interpreter (unbounded learned state would be a memory leak)
static const size_t SKELETON_CAP = 65536;
static const size_t DYN_ROUTES_CAP = 512;
static const size_t LOOKUP_IDS_CAP = 1024;
static const size_t BLOB_BYTES_CAP = (size_t)1 << 30;

struct VRequest {
    uint64_t reqid;
    int route_id;
    int k;
    std::string tenant;        // empty when the route is untenanted
    std::vector<float> query;  // dim floats
};

struct GRequest {
    uint64_t reqid;
    std::string method;
    std::string path;
    std::string body;
    int flags;
};

struct Conn;

struct ReqState {
    int fd;
    uint64_t conn_gen;
    uint64_t seq;          // per-connection sequence
    bool streaming = false;
    bool want_close = false;  // client sent Connection: close
};

struct Conn {
    int fd;
    uint64_t gen;
    std::string rbuf;
    size_t roff = 0;       // parse offset into rbuf
    std::string wbuf;
    size_t woff = 0;
    uint64_t next_issue_seq = 0;   // next request seq to assign
    uint64_t next_send_seq = 0;    // next response seq to transmit
    std::map<uint64_t, std::string> ready;  // out-of-order finished responses
    bool streaming_active = false;  // SSE-style open response owns the conn
    bool close_after_flush = false;
    // incremental header parse state
    bool have_header = false;
    size_t body_need = 0;
    bool body_bad = false;  // malformed Content-Length: reject, never reparse
    std::string method, path;
    int flags = 0;
    bool authorized = true;
    bool keep_alive = true;
};

struct Gateway {
    int listen_fd = -1;
    int epoll_fd = -1;
    int event_fd = -1;
    int port = 0;
    std::string api_key;   // empty => no auth
    std::atomic<bool> running{false};
    std::thread io_thread;

    std::mutex conn_mu;    // guards conns + reqs + generation
    std::unordered_map<int, Conn*> conns;
    // fds closed during the current epoll batch (IO thread only)
    std::unordered_set<int> dead_batch;
    std::unordered_map<uint64_t, ReqState> reqs;
    uint64_t next_reqid = 1;
    uint64_t next_gen = 1;

    // worker-facing queues
    std::mutex q_mu;
    std::condition_variable q_cv;
    std::deque<VRequest> vqueue;
    std::deque<GRequest> gqueue;

    // responses from workers -> IO thread
    std::mutex resp_mu;
    std::deque<std::pair<uint64_t, std::string>> resp_queue;  // reqid, wire bytes
    std::deque<std::pair<uint64_t, std::string>> stream_queue;  // raw chunks
    std::deque<uint64_t> stream_end_queue;

    std::mutex fr_mu;
    std::vector<FastRoute> fast_routes;
    // templates of cleared routes: in-flight requests dispatched before
    // a bundle reload must still be able to format their responses (a
    // missing template would silently drop the response and hang the
    // client).  Bounded; oldest evicted first.
    std::deque<FastRoute> retired_routes;
    int next_route_id = 1;

    // zero-copy handoff: bodies parked until the worker releases them
    std::mutex parked_mu;
    std::unordered_map<uint64_t, std::string> parked;

    // dynamic routes: skeleton -> route (guarded by fr_mu)
    std::unordered_map<std::string, DynRoute> dyn_routes;

    // node blob cache for native point lookups: id -> pre-encoded
    // value_map JSON, valid for one store epoch (any write bumps the
    // epoch and clears)
    std::mutex blob_mu;
    std::unordered_map<uint64_t, std::string> blobs;
    uint64_t blob_epoch = 0;
    size_t blob_bytes = 0;

    // stats
    std::atomic<uint64_t> n_fast{0}, n_general{0}, n_conns{0};
    std::atomic<uint64_t> n_lookup{0};

    size_t max_body = (size_t)1 << 31;  // 2 GiB
};

// ---------------------------------------------------------------- fast body parser

const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
    return p;
}

// parse a JSON string without escapes into out; returns next ptr or null
const char* parse_plain_string(const char* p, const char* end, std::string& out) {
    if (p >= end || *p != '"') return nullptr;
    ++p;
    const char* start = p;
    while (p < end && *p != '"') {
        if (*p == '\\') return nullptr;  // escapes: fall back to slow path
        ++p;
    }
    if (p >= end) return nullptr;
    out.assign(start, p - start);
    return p + 1;
}

// Attempt to parse a fast-route body:
//   {"<vec_key>": [n0, n1, ...], "<k_key>": int}
// optionally wrapped as {"parameters": {...}}.  Unknown keys, escapes,
// wrong arity or nesting -> return false (request goes to the general
// queue so semantics/errors match the interpreter exactly).
bool parse_fast_body(const FastRoute& fr, const std::string& body,
                     std::vector<float>& query, int& k,
                     std::string& tenant) {
    const char* p = body.data();
    const char* end = p + body.size();
    k = fr.k_default;
    bool have_vec = false;
    int wrapper_depth = 0;
    // strict member framing: a comma REQUIRES another member, a member
    // not followed by a comma REQUIRES '}' — the interpreter's parser
    // rejects trailing/missing commas, and a 200-vs-400 that depends
    // on which internal path served the request breaks the "semantics
    // match the interpreter exactly" contract
    bool prev_comma = false;
    int members_here = 0;

    p = skip_ws(p, end);
    if (p >= end || *p != '{') return false;
    ++p;
    for (;;) {
        p = skip_ws(p, end);
        if (p < end && *p == '}') {
            if (prev_comma) return false;  // trailing comma
            ++p;
            if (wrapper_depth > 0) {
                --wrapper_depth;
                p = skip_ws(p, end);
                if (p >= end || *p != '}') return false;
                ++p;
            }
            break;
        }
        if (members_here > 0 && !prev_comma) return false;  // missing comma
        prev_comma = false;
        std::string key;
        p = parse_plain_string(p, end, key);
        if (!p) return false;
        p = skip_ws(p, end);
        if (p >= end || *p != ':') return false;
        p = skip_ws(p + 1, end);
        if (key == "parameters" && wrapper_depth == 0 && !have_vec &&
            p < end && *p == '{') {
            ++wrapper_depth;
            ++p;
            members_here = 0;  // fresh object: its own member framing
            continue;
        }
        ++members_here;
        if (key == fr.vec_key) {
            if (p >= end || *p != '[') return false;
            ++p;
            query.clear();
            query.reserve(fr.dim);
            p = skip_ws(p, end);
            if (p < end && *p == ']') {
                ++p;
            } else {
                for (;;) {
                    double d;
                    // Eisel-Lemire (fastdouble.h): ~2.7x from_chars on
                    // the 17-digit doubles repr() emits, and a search
                    // request parses dim of them
                    const char* np = hxfloat::parse_double(p, end, &d);
                    if (!np) return false;
                    query.push_back((float)d);
                    p = skip_ws(np, end);
                    if (p < end && *p == ',') { p = skip_ws(p + 1, end); continue; }
                    if (p < end && *p == ']') { ++p; break; }
                    return false;
                }
            }
            if ((int)query.size() != fr.dim) return false;
            have_vec = true;
        } else if (!fr.k_key.empty() && key == fr.k_key) {
            long long v;
            auto res = std::from_chars(p, end, v);
            if (res.ec != std::errc() || v <= 0) return false;
            // k beyond the fast-path buffer cap falls back to the
            // interpreter (clamping here would silently diverge from
            // the slow path, which honors the full k)
            if (v > fr.k_max) return false;
            p = res.ptr;
            k = (int)v;
        } else if (!fr.tenant_key.empty() && key == fr.tenant_key) {
            p = parse_plain_string(p, end, tenant);
            if (!p) return false;  // escapes/non-string -> slow path
            if (tenant.empty() || (int)tenant.size() >= TENANT_CAP)
                return false;
            // printable-ASCII only: raw control bytes are invalid JSON
            // (the interpreter rejects them) and NULs would truncate
            // the fixed-width slot into ANOTHER tenant's key; non-ASCII
            // stays on the interpreter so both paths derive the tenant
            // key from identical decoding
            for (unsigned char c : tenant)
                if (c < 0x20 || c >= 0x7F) return false;
        } else {
            return false;  // unknown key -> slow path
        }
        p = skip_ws(p, end);
        if (p < end && *p == ',') { ++p; prev_comma = true; continue; }
        // loop top handles '}' (and rejects a missing comma)
    }
    p = skip_ws(p, end);
    if (p != end) return false;
    if (!fr.tenant_key.empty() && tenant.empty())
        return false;  // missing tenant: interpreter raises the error
    if (k <= 0)
        return false;  // k required (k_default < 0) and absent: the
                       // interpreter raises the missing-parameter error
    return have_vec;
}

// ---------------------------------------------------------------- skeletons

// Skip one JSON value (any type) starting at p; returns the pointer
// just past it, or nullptr on malformed input.  Tracks strings (with
// escapes) so braces inside them don't count.
const char* skip_json_value(const char* p, const char* end) {
    p = skip_ws(p, end);
    if (p >= end) return nullptr;
    if (*p == '"') {
        ++p;
        while (p < end) {
            if (*p == '\\') { p += 2; continue; }
            if (*p == '"') return p + 1;
            ++p;
        }
        return nullptr;
    }
    if (*p == '{' || *p == '[') {
        int depth = 0;
        bool in_str = false;
        while (p < end) {
            char ch = *p;
            if (in_str) {
                if (ch == '\\') { p += 2; continue; }
                if (ch == '"') in_str = false;
                ++p;
                continue;
            }
            if (ch == '"') in_str = true;
            else if (ch == '{' || ch == '[') ++depth;
            else if (ch == '}' || ch == ']') {
                --depth;
                if (depth == 0) return p + 1;
            }
            ++p;
        }
        return nullptr;
    }
    // number / literal: scan to a delimiter
    while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
           *p != '\t' && *p != '\n' && *p != '\r')
        ++p;
    return p;
}

// Locate the TOP-LEVEL "parameters" member's value span [vs, ve).
// Returns false when absent or the body is malformed.
bool find_parameters_span(const char* p, const char* end,
                          size_t& vs, size_t& ve) {
    const char* base = p;
    p = skip_ws(p, end);
    if (p >= end || *p != '{') return false;
    ++p;
    for (;;) {
        p = skip_ws(p, end);
        if (p >= end) return false;
        if (*p == '}') return false;  // parameters member never found
        std::string key;
        p = parse_plain_string(p, end, key);
        if (!p) return false;
        p = skip_ws(p, end);
        if (p >= end || *p != ':') return false;
        p = skip_ws(p + 1, end);
        const char* val_start = p;
        const char* val_end = skip_json_value(p, end);
        if (!val_end) return false;
        if (key == "parameters") {
            vs = (size_t)(val_start - base);
            ve = (size_t)(val_end - base);
            return true;
        }
        p = skip_ws(val_end, end);
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == '}') return false;  // no parameters member
        return false;
    }
}

// skeleton = body with the parameters value replaced by {}
bool compute_skeleton(const std::string& body, std::string& skeleton,
                      size_t& vs, size_t& ve) {
    if (body.size() > SKELETON_CAP) return false;
    if (!find_parameters_span(body.data(), body.data() + body.size(), vs, ve))
        return false;
    skeleton.reserve(body.size() - (ve - vs) + 2);
    skeleton.assign(body, 0, vs);
    skeleton += "{}";
    skeleton.append(body, ve, std::string::npos);
    return true;
}

// Parse a lookup parameters object: {"<ids_key>": [u64, u64, ...]}
// Strict single-member framing; anything else -> interpreter.
bool parse_lookup_params(const std::string& ids_key, const char* p,
                         const char* end, std::vector<uint64_t>& ids) {
    p = skip_ws(p, end);
    if (p >= end || *p != '{') return false;
    std::string key;
    p = parse_plain_string(skip_ws(p + 1, end), end, key);
    if (!p || key != ids_key) return false;
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return false;
    p = skip_ws(p + 1, end);
    if (p >= end || *p != '[') return false;
    p = skip_ws(p + 1, end);
    if (p < end && *p == ']') {
        ++p;
    } else {
        for (;;) {
            uint64_t v;
            auto res = std::from_chars(p, end, v);
            if (res.ec != std::errc()) return false;
            ids.push_back(v);
            if (ids.size() > LOOKUP_IDS_CAP) return false;
            p = skip_ws(res.ptr, end);
            if (p < end && *p == ',') { p = skip_ws(p + 1, end); continue; }
            if (p < end && *p == ']') { ++p; break; }
            return false;
        }
    }
    p = skip_ws(p, end);
    if (p >= end || *p != '}') return false;
    p = skip_ws(p + 1, end);
    return p == end;
}

// ---------------------------------------------------------------- responses

void build_response(std::string& out, int status, const char* ctype,
                    const char* body, size_t body_len, bool keep_alive) {
    const char* reason = "OK";
    switch (status) {
        case 200: reason = "OK"; break;
        case 202: reason = "Accepted"; break;
        case 400: reason = "Bad Request"; break;
        case 401: reason = "Unauthorized"; break;
        case 404: reason = "Not Found"; break;
        case 413: reason = "Payload Too Large"; break;
        case 500: reason = "Internal Server Error"; break;
        case 501: reason = "Not Implemented"; break;
        default: reason = "Status"; break;
    }
    char head[256];
    int n = snprintf(head, sizeof head,
                     "HTTP/1.1 %d %s\r\n"
                     "Content-Type: %s\r\n"
                     "Content-Length: %zu\r\n"
                     "Connection: %s\r\n"
                     "\r\n",
                     status, reason, ctype, body_len,
                     keep_alive ? "keep-alive" : "close");
    // snprintf returns the WOULD-BE length on truncation; appending
    // that many bytes would read past the stack buffer (a long caller
    // content-type is enough to get here).
    if (n < 0) n = 0;
    if ((size_t)n > sizeof head - 1) n = sizeof head - 1;
    out.append(head, n);
    out.append(body, body_len);
}

// ---------------------------------------------------------------- gateway impl

void set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void close_conn(Gateway* gw, Conn* c) {
    epoll_ctl(gw->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    {
        std::lock_guard<std::mutex> lk(gw->conn_mu);
        gw->conns.erase(c->fd);
    }
    // Stale-event guard (same scheme as haproxy.cpp): a later event in
    // the SAME epoll batch may still carry this fd, and accept() can
    // already have reused it for a brand-new connection — without this
    // the stale EPOLLHUP/EPOLLIN would be applied to the new conn.
    gw->dead_batch.insert(c->fd);
    delete c;
}

void arm_writable(Gateway* gw, Conn* c, bool on) {
    epoll_event ev{};
    ev.events = EPOLLIN | (on ? EPOLLOUT : 0);
    ev.data.fd = c->fd;
    epoll_ctl(gw->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
}

// flush as much of wbuf as possible; returns false if conn died
bool flush_conn(Gateway* gw, Conn* c) {
    while (c->woff < c->wbuf.size()) {
        ssize_t n = ::send(c->fd, c->wbuf.data() + c->woff,
                           c->wbuf.size() - c->woff, MSG_NOSIGNAL);
        if (n > 0) {
            c->woff += (size_t)n;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            arm_writable(gw, c, true);
            return true;
        }
        close_conn(gw, c);
        return false;
    }
    if (c->woff == c->wbuf.size()) {
        c->wbuf.clear();
        c->woff = 0;
        arm_writable(gw, c, false);
        if (c->close_after_flush && !c->streaming_active &&
            c->ready.empty()) {  // parked responses must drain first
            close_conn(gw, c);
            return false;
        }
    }
    return true;
}

// deliver a completed response body (wire bytes) for (conn, seq)
// caller holds no locks; IO thread only
// Returns false when the conn was closed (and freed) during the flush;
// callers must not touch c afterwards.
bool deliver_response(Gateway* gw, Conn* c, uint64_t seq, std::string&& wire) {
    if (seq != c->next_send_seq) {
        auto it = c->ready.find(seq);
        if (it == c->ready.end()) {
            c->ready.emplace(seq, std::move(wire));
        } else {
            // a stream chunk for this seq was parked first: the header
            // goes in FRONT of it (emplace would silently drop it)
            it->second.insert(0, wire);
        }
        return true;
    }
    c->wbuf += wire;
    ++c->next_send_seq;
    auto it = c->ready.begin();
    while (it != c->ready.end() && it->first == c->next_send_seq) {
        c->wbuf += it->second;
        ++c->next_send_seq;
        it = c->ready.erase(it);
    }
    return flush_conn(gw, c);
}

bool enqueue_error(Gateway* gw, Conn* c, uint64_t seq, int status,
                   const char* json_body, bool keep_alive) {
    std::string wire;
    build_response(wire, status, "application/json", json_body,
                   strlen(json_body), keep_alive);
    return deliver_response(gw, c, seq, std::move(wire));
}

void poke(Gateway* gw);

// Parse whatever complete requests sit in the conn's read buffer.
// Returns false if the conn was closed.
bool drain_requests(Gateway* gw, Conn* c) {
    for (;;) {
        if (!c->have_header) {
            size_t hdr_end = c->rbuf.find("\r\n\r\n", c->roff);
            if (hdr_end == std::string::npos) {
                // compact buffer when fully consumed
                if (c->roff > 0 && c->roff == c->rbuf.size()) {
                    c->rbuf.clear();
                    c->roff = 0;
                }
                return true;
            }
            // request line
            const char* base = c->rbuf.data();
            size_t line_end = c->rbuf.find("\r\n", c->roff);
            {
                const char* l = base + c->roff;
                const char* le = base + line_end;
                const char* sp1 = (const char*)memchr(l, ' ', le - l);
                if (!sp1) { close_conn(gw, c); return false; }
                const char* sp2 = (const char*)memchr(sp1 + 1, ' ', le - sp1 - 1);
                if (!sp2) { close_conn(gw, c); return false; }
                c->method.assign(l, sp1 - l);
                c->path.assign(sp1 + 1, sp2 - sp1 - 1);
            }
            // headers
            c->flags = 0;
            c->body_need = 0;
            c->keep_alive = true;
            c->authorized = gw->api_key.empty();
            bool chunked = false;
            bool cl_seen = false;
            size_t pos = line_end + 2;
            while (pos < hdr_end) {
                size_t eol = c->rbuf.find("\r\n", pos);
                if (eol == std::string::npos || eol > hdr_end) eol = hdr_end;
                const char* h = base + pos;
                const char* he = base + eol;
                const char* colon = (const char*)memchr(h, ':', he - h);
                if (colon) {
                    size_t nlen = colon - h;
                    const char* v = colon + 1;
                    while (v < he && (*v == ' ' || *v == '\t')) ++v;
                    size_t vlen = he - v;
                    if (iequal(h, nlen, "content-length")) {
                        unsigned long long cl = 0;
                        auto [ptr, ec] = std::from_chars(v, he, cl);
                        const char* q = ptr;
                        while (q < he && (*q == ' ' || *q == '\t')) ++q;
                        if (ec != std::errc() || ptr == v || q != he) {
                            // malformed value: treating it as 0 would
                            // re-parse the body bytes as the next
                            // pipelined request (request smuggling)
                            c->body_bad = true;
                        }
                        if (cl_seen) {
                            // duplicate Content-Length: a front hop
                            // honoring the FIRST value while we honor
                            // the last desynchronizes the connection
                            // (classic smuggling vector) — reject
                            c->body_bad = true;
                        }
                        cl_seen = true;
                        c->body_need = (size_t)cl;
                    } else if (iequal(h, nlen, "transfer-encoding")) {
                        if (vlen >= 7) chunked = true;
                    } else if (iequal(h, nlen, "connection")) {
                        if (vlen == 5 && strncasecmp(v, "close", 5) == 0)
                            c->keep_alive = false;
                    } else if (iequal(h, nlen, "authorization")) {
                        if (!gw->api_key.empty()) {
                            std::string want = "Bearer " + gw->api_key;
                            c->authorized =
                                vlen == want.size() &&
                                memcmp(v, want.data(), vlen) == 0;
                        }
                    } else if (iequal(h, nlen, "x-helix-warm")) {
                        if (vlen == 4 && strncasecmp(v, "true", 4) == 0)
                            c->flags |= F_WARM;
                    } else if (iequal(h, nlen, "x-helix-require-writer")) {
                        if (vlen == 4 && strncasecmp(v, "true", 4) == 0)
                            c->flags |= F_REQUIRE_WRITER;
                    } else if (iequal(h, nlen, "x-helix-await-durable")) {
                        if (vlen == 5 && strncasecmp(v, "false", 5) == 0)
                            c->flags |= F_NO_DURABLE;
                    } else if (iequal(h, nlen, "x-helix-trace")) {
                        if (vlen == 4 && strncasecmp(v, "true", 4) == 0)
                            c->flags |= F_TRACE;
                    }
                }
                pos = eol + 2;
            }
            c->roff = hdr_end + 4;
            c->have_header = true;
            if (chunked) {
                c->close_after_flush = true;  // BEFORE the flush
                uint64_t seq = c->next_issue_seq++;
                return enqueue_error(
                    gw, c, seq, 501,
                    "{\"error\": {\"kind\": \"NotImplemented\", "
                    "\"message\": \"chunked bodies unsupported\"}}",
                    false);
            }
            if (c->body_bad) {
                c->close_after_flush = true;
                uint64_t seq = c->next_issue_seq++;
                return enqueue_error(
                    gw, c, seq, 400,
                    "{\"error\": {\"kind\": \"BadRequest\", "
                    "\"message\": \"malformed Content-Length\"}}",
                    false);
            }
            if (c->body_need > gw->max_body) {
                c->close_after_flush = true;
                uint64_t seq = c->next_issue_seq++;
                return enqueue_error(
                    gw, c, seq, 413,
                    "{\"error\": {\"kind\": \"PayloadTooLarge\", "
                    "\"message\": \"request body too large\"}}",
                    false);
            }
        }
        // body
        if (c->rbuf.size() - c->roff < c->body_need) {
            // compact when the remaining prefix is large and consumed
            if (c->roff > (1u << 20)) {
                c->rbuf.erase(0, c->roff);
                c->roff = 0;
            }
            return true;
        }
        std::string body = c->rbuf.substr(c->roff, c->body_need);
        c->roff += c->body_need;
        c->have_header = false;

        uint64_t seq = c->next_issue_seq++;
        bool ka = c->keep_alive;

        if (!c->authorized) {
            if (!enqueue_error(gw, c, seq, 401,
                               "{\"error\": {\"kind\": \"Unauthorized\", "
                               "\"message\": \"invalid api key\"}}", ka))
                return false;  // conn died mid-flush
            continue;
        }

        // register request state
        uint64_t reqid;
        {
            std::lock_guard<std::mutex> lk(gw->conn_mu);
            reqid = gw->next_reqid++;
            ReqState st;
            st.fd = c->fd;
            st.conn_gen = c->gen;
            st.seq = seq;
            st.want_close = !ka;
            gw->reqs.emplace(reqid, st);
        }

        // fast route?
        bool fast_done = false;
        if (c->method == "POST" && (c->flags & F_TRACE) == 0) {
            std::lock_guard<std::mutex> lk(gw->fr_mu);
            for (const auto& fr : gw->fast_routes) {
                if (fr.path != c->path) continue;
                VRequest vr;
                vr.reqid = reqid;
                vr.route_id = fr.route_id;
                if (parse_fast_body(fr, body, vr.query, vr.k, vr.tenant)) {
                    std::lock_guard<std::mutex> qlk(gw->q_mu);
                    gw->vqueue.push_back(std::move(vr));
                    gw->n_fast.fetch_add(1, std::memory_order_relaxed);
                    fast_done = true;
                }
                break;  // path matched: fast or general, never both routes
            }
        }
        // dynamic fast routes: a learned /v1/query plan skeleton
        if (!fast_done && c->method == "POST" && (c->flags & F_TRACE) == 0 &&
            c->path == "/v1/query" && body.size() <= SKELETON_CAP) {
            std::string skeleton;
            size_t vs = 0, ve = 0;
            bool have_dyn;
            {
                std::lock_guard<std::mutex> lk(gw->fr_mu);
                have_dyn = !gw->dyn_routes.empty();
            }
            if (have_dyn && compute_skeleton(body, skeleton, vs, ve)) {
                std::lock_guard<std::mutex> lk(gw->fr_mu);
                auto it = gw->dyn_routes.find(skeleton);
                if (it != gw->dyn_routes.end()) {
                    const DynRoute& dr = it->second;
                    const std::string params(body, vs, ve - vs);
                    if (dr.kind == 1) {
                        VRequest vr;
                        vr.reqid = reqid;
                        vr.route_id = dr.fr.route_id;
                        if (parse_fast_body(dr.fr, params, vr.query, vr.k,
                                            vr.tenant)) {
                            std::lock_guard<std::mutex> qlk(gw->q_mu);
                            gw->vqueue.push_back(std::move(vr));
                            gw->n_fast.fetch_add(1, std::memory_order_relaxed);
                            fast_done = true;
                        }
                    } else {
                        std::vector<uint64_t> lids;
                        if (parse_lookup_params(
                                dr.ids_key, params.data(),
                                params.data() + params.size(), lids)) {
                            std::string rbody = dr.prefix;
                            bool all = true;
                            {
                                std::lock_guard<std::mutex> blk(gw->blob_mu);
                                for (size_t bi = 0; bi < lids.size(); ++bi) {
                                    auto bit = gw->blobs.find(lids[bi]);
                                    if (bit == gw->blobs.end()) {
                                        all = false;
                                        break;
                                    }
                                    if (bi) rbody += ", ";
                                    rbody += bit->second;
                                }
                            }
                            if (all) {
                                rbody += dr.suffix;
                                std::string wire;
                                build_response(wire, 200, "application/json",
                                               rbody.data(), rbody.size(), ka);
                                {
                                    std::lock_guard<std::mutex> rlk(gw->resp_mu);
                                    gw->resp_queue.emplace_back(
                                        reqid, std::move(wire));
                                }
                                gw->n_lookup.fetch_add(
                                    1, std::memory_order_relaxed);
                                poke(gw);
                                fast_done = true;
                            }
                        }
                    }
                }
            }
        }
        if (!fast_done) {
            GRequest gr;
            gr.reqid = reqid;
            gr.method = c->method;
            gr.path = c->path;
            gr.body = std::move(body);
            gr.flags = c->flags;
            std::lock_guard<std::mutex> qlk(gw->q_mu);
            gw->gqueue.push_back(std::move(gr));
            gw->n_general.fetch_add(1, std::memory_order_relaxed);
        }
        gw->q_cv.notify_all();
    }
}

void io_loop(Gateway* gw) {
    epoll_event events[256];
    while (gw->running.load(std::memory_order_acquire)) {
        int n = epoll_wait(gw->epoll_fd, events, 256, 100);
        gw->dead_batch.clear();
        for (int i = 0; i < n; ++i) {
            int fd = events[i].data.fd;
            if (gw->dead_batch.count(fd)) continue;  // closed this batch
            if (fd == gw->listen_fd) {
                for (;;) {
                    int cfd = accept4(gw->listen_fd, nullptr, nullptr,
                                      SOCK_NONBLOCK);
                    if (cfd < 0) break;
                    int one = 1;
                    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
                    Conn* c = new Conn();
                    c->fd = cfd;
                    {
                        std::lock_guard<std::mutex> lk(gw->conn_mu);
                        c->gen = gw->next_gen++;
                        gw->conns[cfd] = c;
                    }
                    gw->n_conns.fetch_add(1, std::memory_order_relaxed);
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.fd = cfd;
                    epoll_ctl(gw->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
                }
                continue;
            }
            if (fd == gw->event_fd) {
                uint64_t junk;
                while (read(gw->event_fd, &junk, 8) == 8) {}
                // drain worker responses
                std::deque<std::pair<uint64_t, std::string>> resp, chunks;
                std::deque<uint64_t> ends;
                {
                    std::lock_guard<std::mutex> lk(gw->resp_mu);
                    resp.swap(gw->resp_queue);
                    chunks.swap(gw->stream_queue);
                    ends.swap(gw->stream_end_queue);
                }
                for (auto& [reqid, wire] : resp) {
                    ReqState st;
                    bool streaming;
                    {
                        std::lock_guard<std::mutex> lk(gw->conn_mu);
                        auto it = gw->reqs.find(reqid);
                        if (it == gw->reqs.end()) continue;
                        st = it->second;
                        streaming = it->second.streaming;
                        if (!streaming) gw->reqs.erase(it);
                    }
                    Conn* c;
                    {
                        std::lock_guard<std::mutex> lk(gw->conn_mu);
                        auto it = gw->conns.find(st.fd);
                        c = (it != gw->conns.end() &&
                             it->second->gen == st.conn_gen)
                                ? it->second : nullptr;
                    }
                    if (!c) {
                        if (streaming) {
                            std::lock_guard<std::mutex> lk(gw->conn_mu);
                            gw->reqs.erase(reqid);
                        }
                        continue;
                    }
                    if (streaming) c->streaming_active = true;
                    if (st.want_close || streaming) c->close_after_flush = true;
                    deliver_response(gw, c, st.seq, std::move(wire));
                }
                for (auto& [reqid, data] : chunks) {
                    ReqState st;
                    Conn* c = nullptr;
                    {
                        std::lock_guard<std::mutex> lk(gw->conn_mu);
                        auto it = gw->reqs.find(reqid);
                        if (it == gw->reqs.end()) continue;
                        st = it->second;
                        auto cit = gw->conns.find(st.fd);
                        if (cit != gw->conns.end() &&
                            cit->second->gen == st.conn_gen)
                            c = cit->second;
                    }
                    if (!c) continue;
                    if (c->next_send_seq > st.seq) {
                        // stream header already on the wire: append live
                        c->wbuf += data;
                        flush_conn(gw, c);
                    } else {
                        // stream response still parked behind earlier
                        // pipelined responses: chunks join the parked
                        // header so the byte stream stays in sequence
                        // order (the file-header ordering promise)
                        c->ready[st.seq] += data;
                    }
                }
                for (uint64_t reqid : ends) {
                    ReqState st;
                    {
                        std::lock_guard<std::mutex> lk(gw->conn_mu);
                        auto it = gw->reqs.find(reqid);
                        if (it == gw->reqs.end()) continue;
                        st = it->second;
                        gw->reqs.erase(it);
                    }
                    Conn* c = nullptr;
                    {
                        std::lock_guard<std::mutex> lk(gw->conn_mu);
                        auto it = gw->conns.find(st.fd);
                        if (it != gw->conns.end() &&
                            it->second->gen == st.conn_gen)
                            c = it->second;
                    }
                    if (c) {
                        c->streaming_active = false;
                        c->close_after_flush = true;
                        // parked responses (incl. the stream's own
                        // header+chunks) must still drain before close
                        if (c->wbuf.empty() && c->ready.empty())
                            close_conn(gw, c);
                        else
                            flush_conn(gw, c);
                    }
                }
                continue;
            }
            // client socket
            Conn* c;
            {
                std::lock_guard<std::mutex> lk(gw->conn_mu);
                auto it = gw->conns.find(fd);
                if (it == gw->conns.end()) continue;
                c = it->second;
            }
            if (events[i].events & (EPOLLHUP | EPOLLERR)) {
                close_conn(gw, c);
                continue;
            }
            if (events[i].events & EPOLLOUT) {
                if (!flush_conn(gw, c)) continue;
            }
            if (events[i].events & EPOLLIN) {
                static thread_local std::vector<char> rbuf_chunk(1 << 20);
                char* buf = rbuf_chunk.data();
                const size_t bufsz = rbuf_chunk.size();
                bool closed = false;
                for (;;) {
                    ssize_t r = recv(fd, buf, bufsz, 0);
                    if (r > 0) {
                        c->rbuf.append(buf, (size_t)r);
                        if ((size_t)r < bufsz) break;
                        continue;
                    }
                    if (r == 0) { closed = true; break; }
                    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
                    closed = true;
                    break;
                }
                if (!drain_requests(gw, c)) continue;  // conn deleted
                if (closed) close_conn(gw, c);
            }
        }
    }
}

void poke(Gateway* gw) {
    uint64_t one = 1;
    ssize_t rc = write(gw->event_fd, &one, 8);
    (void)rc;
}

}  // namespace

// ---------------------------------------------------------------- C ABI

extern "C" {

void* hxgw_create(const char* host, int port, const char* api_key) {
    Gateway* gw = new Gateway();
    if (api_key && api_key[0]) gw->api_key = api_key;
    gw->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (gw->listen_fd < 0) { delete gw; return nullptr; }
    int one = 1;
    setsockopt(gw->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = host && host[0] ? inet_addr(host) : INADDR_ANY;
    if (bind(gw->listen_fd, (sockaddr*)&addr, sizeof addr) < 0 ||
        listen(gw->listen_fd, 1024) < 0) {
        close(gw->listen_fd);
        delete gw;
        return nullptr;
    }
    socklen_t alen = sizeof addr;
    getsockname(gw->listen_fd, (sockaddr*)&addr, &alen);
    gw->port = ntohs(addr.sin_port);
    gw->epoll_fd = epoll_create1(0);
    gw->event_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = gw->listen_fd;
    epoll_ctl(gw->epoll_fd, EPOLL_CTL_ADD, gw->listen_fd, &ev);
    ev.data.fd = gw->event_fd;
    epoll_ctl(gw->epoll_fd, EPOLL_CTL_ADD, gw->event_fd, &ev);
    return gw;
}

int hxgw_port(void* h) { return ((Gateway*)h)->port; }

int hxgw_start(void* h) {
    Gateway* gw = (Gateway*)h;
    gw->running.store(true, std::memory_order_release);
    gw->io_thread = std::thread(io_loop, gw);
    return 0;
}

void hxgw_stop(void* h) {
    Gateway* gw = (Gateway*)h;
    gw->running.store(false, std::memory_order_release);
    poke(gw);
    if (gw->io_thread.joinable()) gw->io_thread.join();
    gw->q_cv.notify_all();
}

void hxgw_destroy(void* h) {
    Gateway* gw = (Gateway*)h;
    if (gw->running.load()) hxgw_stop(h);
    for (auto& [fd, c] : gw->conns) {
        close(fd);
        delete c;
    }
    gw->conns.clear();
    if (gw->listen_fd >= 0) close(gw->listen_fd);
    if (gw->epoll_fd >= 0) close(gw->epoll_fd);
    if (gw->event_fd >= 0) close(gw->event_fd);
    delete gw;
}

int hxgw_fast_route(void* h, const char* path, const char* vec_key,
                    const char* k_key, const char* tenant_key,
                    int k_default, int k_max, int dim,
                    const char* resp_prefix, const char* resp_suffix,
                    const char* id_key, const char* dist_key) {
    Gateway* gw = (Gateway*)h;
    FastRoute fr;
    fr.path = path;
    fr.vec_key = vec_key;
    fr.k_key = k_key ? k_key : "";
    fr.tenant_key = tenant_key ? tenant_key : "";
    fr.k_default = k_default;
    fr.k_max = k_max;
    fr.dim = dim;
    fr.resp_prefix = resp_prefix;
    fr.resp_suffix = resp_suffix;
    fr.id_key = id_key;
    fr.dist_key = dist_key;
    std::lock_guard<std::mutex> lk(gw->fr_mu);
    fr.route_id = gw->next_route_id++;
    gw->fast_routes.push_back(std::move(fr));
    return gw->fast_routes.back().route_id;
}

void hxgw_clear_fast_routes(void* h) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> lk(gw->fr_mu);
    for (auto& fr : gw->fast_routes)
        gw->retired_routes.push_back(std::move(fr));
    while (gw->retired_routes.size() > 4096) gw->retired_routes.pop_front();
    gw->fast_routes.clear();
}

// Pull up to `cap` fast requests.  Blocks up to timeout_ms for the first
// request; after the first arrives, drains whatever else is queued (the
// device dispatch itself is the batching window).  Returns n, 0 on
// timeout, -1 when the gateway is stopped.
int hxgw_next_vbatch(void* h, int cap, int max_dim, int timeout_ms,
                     unsigned long long* reqids, float* queries, int* ks,
                     int* route_ids, char* tenants) {
    Gateway* gw = (Gateway*)h;
    std::unique_lock<std::mutex> lk(gw->q_mu);
    if (gw->vqueue.empty()) {
        gw->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
            return !gw->vqueue.empty() ||
                   !gw->running.load(std::memory_order_acquire);
        });
    }
    if (gw->vqueue.empty())
        return gw->running.load(std::memory_order_acquire) ? 0 : -1;
    int n = 0;
    while (n < cap && !gw->vqueue.empty()) {
        VRequest& vr = gw->vqueue.front();
        reqids[n] = vr.reqid;
        ks[n] = vr.k;
        route_ids[n] = vr.route_id;
        if (tenants) {
            size_t len = vr.tenant.size();  // < TENANT_CAP by parse
            memcpy(tenants + (size_t)n * TENANT_CAP, vr.tenant.data(), len);
            tenants[(size_t)n * TENANT_CAP + len] = '\0';
        }
        size_t d = vr.query.size();
        if ((int)d > max_dim) d = (size_t)max_dim;
        memcpy(queries + (size_t)n * max_dim, vr.query.data(),
               d * sizeof(float));
        if ((int)d < max_dim)
            memset(queries + (size_t)n * max_dim + d, 0,
                   ((size_t)max_dim - d) * sizeof(float));
        gw->vqueue.pop_front();
        ++n;
    }
    return n;
}

// Format + enqueue responses for a fast batch.  ids/dists are [n, kmax];
// counts[i] gives the number of valid hits in row i.  route_ids selects
// the response template per row.
int hxgw_respond_vbatch(void* h, const unsigned long long* reqids,
                        const int* route_ids, int n, int kmax,
                        const unsigned long long* ids, const double* dists,
                        const int* counts) {
    Gateway* gw = (Gateway*)h;
    // snapshot ONLY the templates this batch references (incl. retired:
    // requests dispatched before a bundle reload still need their
    // response format).  A batch touches a handful of routes; copying
    // every retired FastRoute (up to 4096 x ~10 strings) under fr_mu on
    // the hot response path measurably stalled concurrent parses.
    std::unordered_map<int, FastRoute> frs;
    {
        std::unordered_set<int> want;
        for (int i = 0; i < n; ++i) want.insert(route_ids[i]);
        std::lock_guard<std::mutex> lk(gw->fr_mu);
        for (const auto& fr : gw->retired_routes)
            if (want.count(fr.route_id)) frs[fr.route_id] = fr;
        for (const auto& fr : gw->fast_routes)
            if (want.count(fr.route_id)) frs[fr.route_id] = fr;
        for (const auto& [sk, dr] : gw->dyn_routes)
            if (dr.kind == 1 && want.count(dr.fr.route_id))
                frs[dr.fr.route_id] = dr.fr;
    }
    std::deque<std::pair<uint64_t, std::string>> out;
    for (int i = 0; i < n; ++i) {
        auto frit = frs.find(route_ids[i]);
        if (frit == frs.end()) continue;
        const FastRoute& fr = frit->second;
        std::string body;
        body.reserve(64 + (size_t)counts[i] * 48);
        body += fr.resp_prefix;
        for (int j = 0; j < counts[i]; ++j) {
            if (j) body += ", ";
            body += "{\"";
            body += fr.id_key;
            body += "\": ";
            char buf[24];
            auto res = std::to_chars(buf, buf + sizeof buf,
                                     ids[(size_t)i * kmax + j]);
            body.append(buf, res.ptr - buf);
            body += ", \"";
            body += fr.dist_key;
            body += "\": ";
            format_double(body, dists[(size_t)i * kmax + j]);
            body += "}";
        }
        body += fr.resp_suffix;
        std::string wire;
        bool ka;
        {
            std::lock_guard<std::mutex> lk(gw->conn_mu);
            auto it = gw->reqs.find(reqids[i]);
            ka = (it == gw->reqs.end()) ? true : !it->second.want_close;
        }
        build_response(wire, 200, "application/json", body.data(),
                       body.size(), ka);
        out.emplace_back(reqids[i], std::move(wire));
    }
    {
        std::lock_guard<std::mutex> lk(gw->resp_mu);
        for (auto& item : out) gw->resp_queue.push_back(std::move(item));
    }
    poke(gw);
    return 0;
}

// Pull one general request.  Body bytes are copied into caller-provided
// buffer when body_cap suffices; otherwise body_len reports the needed
// size and the request stays queued (caller retries with a bigger
// buffer).  Returns reqid, 0 on timeout, -1 when stopped.
long long hxgw_next_general(void* h, int timeout_ms, char* method,
                            int method_cap, char* path, int path_cap,
                            char* body, long long body_cap,
                            long long* body_len, int* flags) {
    Gateway* gw = (Gateway*)h;
    std::unique_lock<std::mutex> lk(gw->q_mu);
    if (gw->gqueue.empty()) {
        gw->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
            return !gw->gqueue.empty() ||
                   !gw->running.load(std::memory_order_acquire);
        });
    }
    if (gw->gqueue.empty())
        return gw->running.load(std::memory_order_acquire) ? 0 : -1;
    GRequest& gr = gw->gqueue.front();
    *body_len = (long long)gr.body.size();
    if ((long long)gr.body.size() > body_cap) {
        return -2;  // caller re-calls with a buffer of *body_len
    }
    snprintf(method, method_cap, "%s", gr.method.c_str());
    snprintf(path, path_cap, "%s", gr.path.c_str());
    memcpy(body, gr.body.data(), gr.body.size());
    *flags = gr.flags;
    long long reqid = (long long)gr.reqid;
    gw->gqueue.pop_front();
    return reqid;
}

// Zero-copy variant: the request is parked (owned by C++) and its body
// pointer handed out directly; the caller MUST call hxgw_release_body
// after it is done with the pointer (typically right after parsing).
long long hxgw_next_general_zc(void* h, int timeout_ms, char* method,
                               int method_cap, char* path, int path_cap,
                               const char** body, long long* body_len,
                               int* flags) {
    Gateway* gw = (Gateway*)h;
    std::unique_lock<std::mutex> lk(gw->q_mu);
    if (gw->gqueue.empty()) {
        gw->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
            return !gw->gqueue.empty() ||
                   !gw->running.load(std::memory_order_acquire);
        });
    }
    if (gw->gqueue.empty())
        return gw->running.load(std::memory_order_acquire) ? 0 : -1;
    GRequest gr = std::move(gw->gqueue.front());
    gw->gqueue.pop_front();
    lk.unlock();
    snprintf(method, method_cap, "%s", gr.method.c_str());
    snprintf(path, path_cap, "%s", gr.path.c_str());
    *flags = gr.flags;
    long long reqid = (long long)gr.reqid;
    {
        std::lock_guard<std::mutex> plk(gw->parked_mu);
        auto& slot = gw->parked[gr.reqid];
        slot = std::move(gr.body);
        *body = slot.data();
        *body_len = (long long)slot.size();
    }
    return reqid;
}

void hxgw_release_body(void* h, unsigned long long reqid) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> plk(gw->parked_mu);
    gw->parked.erase(reqid);
}

int hxgw_respond(void* h, unsigned long long reqid, int status,
                 const char* ctype, const char* body, long long body_len) {
    Gateway* gw = (Gateway*)h;
    bool ka;
    {
        std::lock_guard<std::mutex> lk(gw->conn_mu);
        auto it = gw->reqs.find(reqid);
        ka = (it == gw->reqs.end()) ? true : !it->second.want_close;
    }
    std::string wire;
    build_response(wire, status, ctype ? ctype : "application/json", body,
                   (size_t)body_len, ka);
    {
        std::lock_guard<std::mutex> lk(gw->resp_mu);
        gw->resp_queue.emplace_back(reqid, std::move(wire));
    }
    poke(gw);
    return 0;
}

// Streaming (SSE): open a close-delimited response, then write chunks.
int hxgw_respond_stream_start(void* h, unsigned long long reqid, int status,
                              const char* ctype) {
    Gateway* gw = (Gateway*)h;
    {
        std::lock_guard<std::mutex> lk(gw->conn_mu);
        auto it = gw->reqs.find(reqid);
        if (it == gw->reqs.end()) return -1;
        it->second.streaming = true;
    }
    char head[256];
    int n = snprintf(head, sizeof head,
                     "HTTP/1.1 %d OK\r\n"
                     "Content-Type: %s\r\n"
                     "Cache-Control: no-cache\r\n"
                     "Connection: close\r\n"
                     "\r\n",
                     status, ctype);
    if (n < 0) n = 0;
    if ((size_t)n > sizeof head - 1) n = sizeof head - 1;  // truncated
    {
        std::lock_guard<std::mutex> lk(gw->resp_mu);
        gw->resp_queue.emplace_back(reqid, std::string(head, n));
    }
    poke(gw);
    return 0;
}

int hxgw_stream_write(void* h, unsigned long long reqid, const char* data,
                      long long len) {
    Gateway* gw = (Gateway*)h;
    {
        std::lock_guard<std::mutex> lk(gw->conn_mu);
        auto it = gw->reqs.find(reqid);
        if (it == gw->reqs.end() || !it->second.streaming) return -1;
    }
    {
        std::lock_guard<std::mutex> lk(gw->resp_mu);
        gw->stream_queue.emplace_back(reqid, std::string(data, (size_t)len));
    }
    poke(gw);
    return 0;
}

int hxgw_stream_end(void* h, unsigned long long reqid) {
    Gateway* gw = (Gateway*)h;
    {
        std::lock_guard<std::mutex> lk(gw->resp_mu);
        gw->stream_end_queue.push_back(reqid);
    }
    poke(gw);
    return 0;
}

// alive check for streaming writers: 1 while the request's connection is
// open, 0 once the client went away (lets SSE loops exit promptly).
int hxgw_request_alive(void* h, unsigned long long reqid) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> lk(gw->conn_mu);
    auto it = gw->reqs.find(reqid);
    if (it == gw->reqs.end()) return 0;
    auto cit = gw->conns.find(it->second.fd);
    return cit != gw->conns.end() &&
           cit->second->gen == it->second.conn_gen;
}

void hxgw_stats(void* h, unsigned long long* n_fast,
                unsigned long long* n_general, unsigned long long* n_conns) {
    Gateway* gw = (Gateway*)h;
    *n_fast = gw->n_fast.load(std::memory_order_relaxed);
    *n_general = gw->n_general.load(std::memory_order_relaxed);
    *n_conns = gw->n_conns.load(std::memory_order_relaxed);
}

// Parked-body map size (leak probe: every request parks an entry the
// worker must release, including empty-body GETs).
long long hxgw_parked_count(void* h) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> lk(gw->parked_mu);
    return (long long)gw->parked.size();
}

// ------------------------------------------------ dynamic fast routes

// Compute the plan skeleton of a /v1/query body (parameters value
// replaced by {}).  Returns the skeleton length, -1 when the body has
// no top-level parameters member / is malformed / exceeds the cap, or
// the needed size when `cap` is too small (caller retries).
long long hxgw_skeleton(const char* body, long long len, char* out,
                        long long cap) {
    std::string b(body, (size_t)len);
    std::string skeleton;
    size_t vs, ve;
    if (!compute_skeleton(b, skeleton, vs, ve)) return -1;
    if ((long long)skeleton.size() > cap) return (long long)skeleton.size();
    memcpy(out, skeleton.data(), skeleton.size());
    return (long long)skeleton.size();
}

// Register a learned dynamic VECTOR route.  Returns the new route_id,
// 0 when the skeleton is already registered or the table is full.
long long hxgw_dyn_vec_route(void* h, const char* skeleton, long long sk_len,
                             const char* vec_key, const char* k_key,
                             const char* tenant_key, int k_default, int k_max,
                             int dim, const char* resp_prefix,
                             const char* resp_suffix) {
    Gateway* gw = (Gateway*)h;
    std::string sk(skeleton, (size_t)sk_len);
    std::lock_guard<std::mutex> lk(gw->fr_mu);
    if (gw->dyn_routes.size() >= DYN_ROUTES_CAP) return 0;
    if (gw->dyn_routes.count(sk)) return 0;
    DynRoute dr;
    dr.kind = 1;
    dr.fr.vec_key = vec_key;
    dr.fr.k_key = k_key ? k_key : "";
    dr.fr.tenant_key = tenant_key ? tenant_key : "";
    dr.fr.k_default = k_default;
    dr.fr.k_max = k_max;
    dr.fr.dim = dim;
    dr.fr.resp_prefix = resp_prefix;
    dr.fr.resp_suffix = resp_suffix;
    dr.fr.id_key = "$id";
    dr.fr.dist_key = "$distance";
    dr.fr.route_id = gw->next_route_id++;
    int rid = dr.fr.route_id;
    gw->dyn_routes.emplace(std::move(sk), std::move(dr));
    return rid;
}

// Register a learned dynamic POINT-LOOKUP route (served from the blob
// cache entirely natively).  Returns 1, or 0 when already registered /
// table full.
long long hxgw_dyn_lookup_route(void* h, const char* skeleton,
                                long long sk_len, const char* ids_key,
                                const char* resp_prefix,
                                const char* resp_suffix) {
    Gateway* gw = (Gateway*)h;
    std::string sk(skeleton, (size_t)sk_len);
    std::lock_guard<std::mutex> lk(gw->fr_mu);
    if (gw->dyn_routes.size() >= DYN_ROUTES_CAP) return 0;
    if (gw->dyn_routes.count(sk)) return 0;
    DynRoute dr;
    dr.kind = 2;
    dr.ids_key = ids_key;
    dr.prefix = resp_prefix;
    dr.suffix = resp_suffix;
    gw->dyn_routes.emplace(std::move(sk), std::move(dr));
    return 1;
}

void hxgw_clear_dyn_routes(void* h) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> lk(gw->fr_mu);
    for (auto& [sk, dr] : gw->dyn_routes)
        if (dr.kind == 1) {
            gw->retired_routes.push_back(std::move(dr.fr));
            if (gw->retired_routes.size() > 4096)
                gw->retired_routes.pop_front();
        }
    gw->dyn_routes.clear();
}

// ------------------------------------------------ blob cache

// Set the current store epoch.  A different epoch clears the cache
// (any write invalidates all cached value_maps).
void hxgw_blob_epoch(void* h, unsigned long long epoch) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> lk(gw->blob_mu);
    if (gw->blob_epoch != epoch) {
        gw->blob_epoch = epoch;
        gw->blobs.clear();
        gw->blob_bytes = 0;
    }
}

// Insert one node blob, accepted only when `epoch` matches the current
// one (a put raced by a write must lose).  Returns 1 on insert, 0 when
// rejected (stale epoch or byte budget exhausted).
int hxgw_blob_put(void* h, unsigned long long epoch, unsigned long long id,
                  const char* data, long long len) {
    Gateway* gw = (Gateway*)h;
    std::lock_guard<std::mutex> lk(gw->blob_mu);
    if (gw->blob_epoch != epoch) return 0;
    if (gw->blob_bytes + (size_t)len > BLOB_BYTES_CAP) return 0;
    auto [it, inserted] = gw->blobs.emplace(
        id, std::string(data, (size_t)len));
    if (!inserted) {
        gw->blob_bytes -= it->second.size();
        it->second.assign(data, (size_t)len);
    }
    gw->blob_bytes += (size_t)len;
    return 1;
}

// (lookup_served, blobs_cached, dyn_routes)
void hxgw_dyn_stats(void* h, unsigned long long* lookups,
                    unsigned long long* blob_count,
                    unsigned long long* routes) {
    Gateway* gw = (Gateway*)h;
    *lookups = gw->n_lookup.load(std::memory_order_relaxed);
    {
        std::lock_guard<std::mutex> lk(gw->blob_mu);
        *blob_count = (unsigned long long)gw->blobs.size();
    }
    {
        std::lock_guard<std::mutex> lk(gw->fr_mu);
        *routes = (unsigned long long)gw->dyn_routes.size();
    }
}

}  // extern "C"
