// hxha — native HA front proxy for the helix-tpu serving fleet.
//
// The reference's cloud topology is "single writer + autoscaled readers
// behind 3+ redundant gateways" (reference README.md:248).  Round 2's
// HA front proxied on Python's ThreadingHTTPServer, which caps the data
// path at a few hundred req/s per core; this moves the proxy loop to
// native code with the same epoll machinery as gateway.cpp:
//
//   - one IO thread: client HTTP/1.1 framing (keep-alive, pipelining),
//     per-request routing, nonblocking upstream connects, pooled
//     keep-alive upstream connections, ordered response delivery;
//   - routing mirrors server/ha_front.py exactly: writes (body sniff
//     `"request_type": "write"`, the x-helix-require-writer header,
//     learned write-kind stored routes, /v1/source, /mcp) go to the
//     primary and fail fast with 503 when it is down; reads round-robin
//     healthy replicas with the primary as fallback tail and unhealthy
//     backends as a last resort (probe lag); a replica's
//     "read-only replica" 400 on a stored route teaches the proxy the
//     route is write-kind (re-sent to the primary, remembered); other
//     replica 4xx on stored routes fail over to the next backend and
//     only surface when every backend agrees;
//   - stale pooled connections (backend restarted) retry once on a
//     fresh socket before counting as a backend failure — the same
//     two-attempt contract as ha_front._forward;
//   - control paths (/v1/ha topology, /v1/bundle broadcast) are handed
//     to a Python worker through the same queue+eventfd pattern the
//     gateway uses for general routes (broadcast fan-out and topology
//     reporting stay in Python where the health prober lives).
//
// Health probing remains in Python (GET /v1/health every probe_s); the
// prober pushes the resulting up/down flags here via hxha_set_backends.
// The proxy ALSO marks a backend down the moment a forward fails, so
// in-flight traffic fails over immediately instead of waiting out a
// probe interval.  All entry points are C ABI for ctypes.
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
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace hxha {

bool iequal(const char* a, size_t alen, const char* b) {
    size_t blen = strlen(b);
    if (alen != blen) return false;
    for (size_t i = 0; i < alen; ++i)
        if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i]))
            return false;
    return true;
}

double now_s() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

// `"request_type"` `:` `"write"` with JSON whitespace between — the
// same predicate as ha_front._WRITE_RE.
bool body_requests_write(const std::string& body) {
    static const char key[] = "\"request_type\"";
    const char* p = body.data();
    const char* end = p + body.size();
    for (;;) {
        const char* hit = (const char*)memmem(p, end - p, key, sizeof key - 1);
        if (!hit) return false;
        const char* q = hit + sizeof key - 1;
        while (q < end && (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r'))
            ++q;
        if (q < end && *q == ':') {
            ++q;
            while (q < end &&
                   (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r'))
                ++q;
            if (end - q >= 7 && memcmp(q, "\"write\"", 7) == 0) return true;
        }
        p = hit + 1;
    }
}

void build_response(std::string& out, int status, const char* ctype,
                    const char* body, size_t body_len, bool keep_alive) {
    const char* reason = "OK";
    switch (status) {
        case 200: reason = "OK"; break;
        case 400: reason = "Bad Request"; break;
        case 404: reason = "Not Found"; break;
        case 502: reason = "Bad Gateway"; break;
        case 503: reason = "Service Unavailable"; break;
        default: reason = "Status"; break;
    }
    // string concatenation, not a fixed buffer: ctype arrives from the
    // upstream response and may be arbitrarily long (a truncating
    // snprintf whose return value exceeds the buffer would read past it)
    char num[32];
    out += "HTTP/1.1 ";
    snprintf(num, sizeof num, "%d", status);
    out += num;
    out.push_back(' ');
    out += reason;
    out += "\r\nContent-Type: ";
    out += ctype;
    out += "\r\nContent-Length: ";
    snprintf(num, sizeof num, "%zu", body_len);
    out += num;
    out += "\r\nConnection: ";
    out += keep_alive ? "keep-alive" : "close";
    out += "\r\n\r\n";
    out.append(body, body_len);
}

// headers never forwarded upstream (the proxy writes its own)
bool hop_header(const char* h, size_t nlen) {
    return iequal(h, nlen, "connection") || iequal(h, nlen, "keep-alive") ||
           iequal(h, nlen, "transfer-encoding") || iequal(h, nlen, "host") ||
           iequal(h, nlen, "content-length");
}

struct Backend {
    std::string host;
    int port = 0;
    bool primary = false;
    std::atomic<bool> healthy{true};
    bool retired = false;           // removed by set_backends; kept for
                                    // in-flight pointer stability
    std::vector<int> idle;          // pooled upstream fds (guarded by b_mu)
    // IO-thread-only: bounded connection discipline.  A cold-pool burst
    // of simultaneous fresh connects overflows small listen backlogs
    // (Python's ThreadingHTTPServer defaults to 5) and every dropped
    // SYN costs a 1 s retransmit stall — so at most MAX_CONNECTING
    // connects may be in flight per backend (established connections
    // then grow the pool at the rate the backend actually accepts),
    // and at most MAX_CONNS total; requests beyond the caps queue here
    // and dispatch as connections free up.
    int active = 0;
    int connecting_now = 0;
    std::deque<uint64_t> waiting;   // reqids queued for this backend
};

static const int MAX_CONNS_PER_BACKEND = 64;
static const int MAX_CONNECTING_PER_BACKEND = 4;

struct ClientConn {
    int fd;
    uint64_t gen;
    std::string rbuf;
    size_t roff = 0;
    std::string wbuf;
    size_t woff = 0;
    uint64_t next_issue_seq = 0;
    uint64_t next_send_seq = 0;
    std::map<uint64_t, std::string> ready;
    bool close_after_flush = false;
    // incremental parse state
    bool have_header = false;
    size_t body_need = 0;
    std::string method, path, fwd_headers;  // filtered raw header lines
    bool keep_alive = true;
    bool require_writer = false;
};

struct Request {
    uint64_t reqid;
    int cfd;
    uint64_t cgen;
    uint64_t seq;
    bool client_ka;
    std::string method, path, fwd_headers, body;
    bool is_write = false;
    std::vector<Backend*> order;
    size_t order_pos = 0;
    bool retried_same = false;      // fresh-socket retry after stale pool hit
    bool have_last = false;         // saved replica 4xx (stored routes)
    std::string last_wire;
};

struct Upstream {
    int fd;
    Backend* backend;
    uint64_t reqid;
    bool pooled;                    // came from the idle pool
    bool connecting;
    std::string out;
    size_t ooff = 0;
    std::string in;
    bool have_header = false;
    size_t hdr_end = 0;
    long long body_need = -1;       // -1: close-delimited
    int status = 0;
    bool resp_ka = true;
    std::string ctype;
    double deadline;
    // chunked transfer decoding (Transfer-Encoding: chunked responses
    // from non-native backends; ours always send Content-Length)
    enum { CH_SIZE, CH_DATA, CH_DATA_CRLF, CH_TRAILER } ch_state = CH_SIZE;
    bool chunked = false;
    size_t c_off = 0;
    long long chunk_left = 0;
    std::string decoded;
};

// incremental chunked-body decode: 0 = need more bytes, 1 = complete,
// -1 = malformed framing
int decode_chunks(Upstream* u) {
    const std::string& in = u->in;
    for (;;) {
        switch (u->ch_state) {
            case Upstream::CH_SIZE: {
                size_t eol = in.find("\r\n", u->c_off);
                if (eol == std::string::npos) return 0;
                char* endp = nullptr;
                long long sz =
                    strtoll(in.c_str() + u->c_off, &endp, 16);
                if (endp == in.c_str() + u->c_off || sz < 0) return -1;
                u->c_off = eol + 2;
                if (sz == 0) {
                    u->ch_state = Upstream::CH_TRAILER;
                    break;
                }
                u->chunk_left = sz;
                u->ch_state = Upstream::CH_DATA;
                break;
            }
            case Upstream::CH_DATA: {
                size_t avail = in.size() - u->c_off;
                size_t take = avail < (size_t)u->chunk_left
                                  ? avail
                                  : (size_t)u->chunk_left;
                u->decoded.append(in, u->c_off, take);
                u->c_off += take;
                u->chunk_left -= (long long)take;
                if (u->chunk_left > 0) return 0;
                u->ch_state = Upstream::CH_DATA_CRLF;
                break;
            }
            case Upstream::CH_DATA_CRLF:
                if (in.size() - u->c_off < 2) return 0;
                u->c_off += 2;
                u->ch_state = Upstream::CH_SIZE;
                break;
            case Upstream::CH_TRAILER: {
                size_t eol = in.find("\r\n", u->c_off);
                if (eol == std::string::npos) return 0;
                if (eol == u->c_off) return 1;  // empty line: done
                u->c_off = eol + 2;             // skip a trailer line
                break;
            }
        }
    }
}

struct ControlReq {
    uint64_t reqid;
    std::string method, path, body;
    std::string headers;  // raw filtered header lines ("K: v\r\n"...)
};

struct Proxy {
    int listen_fd = -1;
    int epoll_fd = -1;
    int event_fd = -1;
    int port = 0;
    std::atomic<bool> running{false};
    std::thread io_thread;
    double upstream_timeout_s = 120.0;

    // IO-thread state
    std::unordered_map<int, ClientConn*> conns;
    std::unordered_map<int, Upstream*> ups;
    std::unordered_map<int, Backend*> idle_owner;  // pooled fd -> backend
    std::unordered_map<uint64_t, Request*> reqs;
    uint64_t next_reqid = 1;
    uint64_t next_gen = 1;

    std::mutex b_mu;
    std::vector<Backend*> backends;   // stable pointers, retired kept
    std::atomic<uint64_t> rr{0};

    std::mutex wr_mu;
    std::set<std::string> write_routes;

    // control queue (Python worker)
    std::mutex q_mu;
    std::condition_variable q_cv;
    std::deque<ControlReq> cqueue;
    std::mutex resp_mu;
    std::deque<std::pair<uint64_t, std::string>> resp_queue;  // reqid, wire

    std::atomic<uint64_t> n_proxied{0}, n_retries{0}, n_control{0};

    // fds closed while processing the CURRENT epoll batch: later events
    // in the same batch may reference them, and a new socket created in
    // the meantime can reuse the number — skipping avoids tearing down
    // the wrong connection (level-triggered epoll re-delivers anything
    // real next cycle)
    std::unordered_map<int, bool> dead_this_batch;

    size_t max_body = (size_t)1 << 31;
};

void set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void poke(Proxy* px) {
    uint64_t one = 1;
    ssize_t rc = write(px->event_fd, &one, 8);
    (void)rc;
}

void close_client(Proxy* px, ClientConn* c) {
    epoll_ctl(px->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    px->conns.erase(c->fd);
    px->dead_this_batch[c->fd] = true;
    delete c;
}

void arm_client(Proxy* px, ClientConn* c, bool want_write) {
    epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
    ev.data.fd = c->fd;
    epoll_ctl(px->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
}

bool flush_client(Proxy* px, ClientConn* c) {
    while (c->woff < c->wbuf.size()) {
        ssize_t n = ::send(c->fd, c->wbuf.data() + c->woff,
                           c->wbuf.size() - c->woff, MSG_NOSIGNAL);
        if (n > 0) {
            c->woff += (size_t)n;
            continue;
        }
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            arm_client(px, c, true);
            return true;
        }
        close_client(px, c);
        return false;
    }
    c->wbuf.clear();
    c->woff = 0;
    arm_client(px, c, false);
    if (c->close_after_flush) {
        close_client(px, c);
        return false;
    }
    return true;
}

// ordered (per-connection) response delivery; IO thread only
void deliver(Proxy* px, uint64_t reqid, std::string&& wire) {
    auto rit = px->reqs.find(reqid);
    if (rit == px->reqs.end()) return;
    Request* rq = rit->second;
    px->reqs.erase(rit);
    auto cit = px->conns.find(rq->cfd);
    if (cit != px->conns.end() && cit->second->gen == rq->cgen) {
        ClientConn* c = cit->second;
        if (!rq->client_ka) c->close_after_flush = true;
        if (rq->seq != c->next_send_seq) {
            c->ready.emplace(rq->seq, std::move(wire));
        } else {
            c->wbuf += wire;
            ++c->next_send_seq;
            auto it = c->ready.begin();
            while (it != c->ready.end() && it->first == c->next_send_seq) {
                c->wbuf += it->second;
                ++c->next_send_seq;
                it = c->ready.erase(it);
            }
            flush_client(px, c);
        }
    }
    delete rq;
}

void deliver_error(Proxy* px, uint64_t reqid, int status, const char* body) {
    std::string wire;
    build_response(wire, status, "application/json", body, strlen(body), true);
    deliver(px, reqid, std::move(wire));
}

// read order mirrors ha_front._read_order: healthy replicas rotated by a
// shared round-robin counter, the primary as healthy-fallback tail, then
// unhealthy backends as a last resort (probe lag)
void build_read_order(Proxy* px, Request* rq) {
    std::lock_guard<std::mutex> lk(px->b_mu);
    Backend* primary = nullptr;
    std::vector<Backend*> healthy, unhealthy;
    for (Backend* b : px->backends) {
        if (b->retired) continue;
        if (b->primary) {
            primary = b;
        } else if (b->healthy.load(std::memory_order_relaxed)) {
            healthy.push_back(b);
        } else {
            unhealthy.push_back(b);
        }
    }
    uint64_t off = px->rr.fetch_add(1, std::memory_order_relaxed) + 1;
    rq->order.clear();
    if (!healthy.empty()) {
        size_t o = (size_t)(off % healthy.size());
        // idle-connection-first within the rotation: a backend with a
        // pooled connection ready serves without a fresh connect, which
        // both balances load away from saturated backends and avoids
        // connecting to a zombie listener (accepting but not serving)
        for (int pass = 0; pass < 2; ++pass)
            for (size_t i = 0; i < healthy.size(); ++i) {
                Backend* b = healthy[(o + i) % healthy.size()];
                if ((pass == 0) == !b->idle.empty()) rq->order.push_back(b);
            }
    }
    bool ptail = primary && primary->healthy.load(std::memory_order_relaxed);
    if (ptail) rq->order.push_back(primary);
    for (Backend* b : unhealthy) rq->order.push_back(b);
    if (!ptail && primary) rq->order.push_back(primary);
}

Backend* find_primary(Proxy* px) {
    std::lock_guard<std::mutex> lk(px->b_mu);
    for (Backend* b : px->backends)
        if (b->primary && !b->retired) return b;
    return nullptr;
}

void dispatch(Proxy* px, Request* rq);

void fail_request(Proxy* px, Request* rq) {
    if (rq->is_write) {
        deliver_error(px, rq->reqid, 503,
                      "{\"error\": {\"kind\": \"Unavailable\", \"message\": "
                      "\"writer is unreachable; writes are unavailable until "
                      "the primary returns\"}}");
        return;
    }
    ++rq->order_pos;
    if (rq->order_pos < rq->order.size()) {
        px->n_retries.fetch_add(1, std::memory_order_relaxed);
        dispatch(px, rq);
        return;
    }
    if (rq->have_last) {
        deliver(px, rq->reqid, std::move(rq->last_wire));
        return;
    }
    deliver_error(px, rq->reqid, 503,
                  "{\"error\": {\"kind\": \"Unavailable\", \"message\": "
                  "\"no healthy backend\"}}");
}

// a connection slot on `b` freed: dispatch the next queued request
void wake_waiter(Proxy* px, Backend* b) {
    while (!b->waiting.empty()) {
        uint64_t reqid = b->waiting.front();
        b->waiting.pop_front();
        auto it = px->reqs.find(reqid);
        if (it == px->reqs.end()) continue;  // client went away
        dispatch(px, it->second);
        break;
    }
}

void close_upstream(Proxy* px, Upstream* u) {
    Backend* b = u->backend;
    --b->active;
    if (u->connecting) --b->connecting_now;
    epoll_ctl(px->epoll_fd, EPOLL_CTL_DEL, u->fd, nullptr);
    close(u->fd);
    px->ups.erase(u->fd);
    px->dead_this_batch[u->fd] = true;
    delete u;
    wake_waiter(px, b);
}

void upstream_fail(Proxy* px, Upstream* u) {
    Backend* b = u->backend;
    uint64_t reqid = u->reqid;
    bool pooled = u->pooled;
    close_upstream(px, u);
    auto rit = px->reqs.find(reqid);
    if (rit == px->reqs.end()) return;
    Request* rq = rit->second;
    if (pooled && !rq->retried_same) {
        // stale keep-alive (backend restarted): one fresh-socket retry
        // against the SAME backend before it counts as a failure
        rq->retried_same = true;
        dispatch(px, rq);
        return;
    }
    b->healthy.store(false, std::memory_order_relaxed);
    rq->retried_same = false;
    fail_request(px, rq);
}

void start_upstream_io(Proxy* px, Upstream* u) {
    epoll_event ev{};
    ev.events = EPOLLIN | (u->ooff < u->out.size() || u->connecting
                               ? EPOLLOUT
                               : 0);
    ev.data.fd = u->fd;
    epoll_ctl(px->epoll_fd, EPOLL_CTL_ADD, u->fd, &ev);
}

void dispatch(Proxy* px, Request* rq) {
    Backend* b = rq->is_write
                     ? find_primary(px)
                     : (rq->order_pos < rq->order.size()
                            ? rq->order[rq->order_pos]
                            : nullptr);
    if (!b) {
        fail_request(px, rq);
        return;
    }
    if (b->active >= MAX_CONNS_PER_BACKEND) {
        b->waiting.push_back(rq->reqid);
        return;
    }
    Upstream* u = new Upstream();
    u->backend = b;
    u->reqid = rq->reqid;
    u->deadline = now_s() + px->upstream_timeout_s;
    // upstream request: proxy-owned framing headers + the client's
    // non-hop headers verbatim (auth, content-type, x-helix-*).  Built
    // by string concatenation — the path is client-controlled and may
    // exceed any fixed buffer.
    char num[32];
    u->out = rq->method;
    u->out.push_back(' ');
    u->out += rq->path;
    u->out += " HTTP/1.1\r\nHost: ";
    u->out += b->host;
    snprintf(num, sizeof num, ":%d", b->port);
    u->out += num;
    u->out += "\r\n";
    u->out += rq->fwd_headers;
    u->out += "Content-Length: ";
    snprintf(num, sizeof num, "%zu", rq->body.size());
    u->out += num;
    u->out += "\r\nConnection: keep-alive\r\n\r\n";
    u->out += rq->body;

    // Pooled connection first — but never for a backend the prober has
    // marked down: a gracefully draining backend keeps answering on
    // established sockets after it stops accepting, and riding the pool
    // would hide the outage (writes must fail fast when the primary is
    // down, not succeed while a stale socket lingers).  A stale-pool
    // retry must also skip the pool: after a restart every pooled
    // socket is stale, and popping a second one would burn the
    // two-attempt budget without ever reaching the live backend.
    int fd = -1;
    if (!rq->retried_same && b->healthy.load(std::memory_order_relaxed)) {
        std::lock_guard<std::mutex> lk(px->b_mu);
        while (!b->idle.empty()) {
            fd = b->idle.back();
            b->idle.pop_back();
            px->idle_owner.erase(fd);
            break;
        }
    }
    if (fd >= 0) {
        // the idle fd was registered for EOF detection; re-register as
        // an active upstream below
        epoll_ctl(px->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
        u->fd = fd;
        u->pooled = true;
        u->connecting = false;
    } else if (b->connecting_now >= MAX_CONNECTING_PER_BACKEND) {
        // no pooled conn and the connect budget is spent: wait for an
        // in-flight connect to establish rather than storming the
        // backend's listen backlog
        delete u;
        b->waiting.push_back(rq->reqid);
        return;
    } else {
        fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
        if (fd < 0) {
            delete u;
            b->healthy.store(false, std::memory_order_relaxed);
            fail_request(px, rq);
            return;
        }
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_port = htons((uint16_t)b->port);
        addr.sin_addr.s_addr = inet_addr(b->host.c_str());
        int rc = connect(fd, (sockaddr*)&addr, sizeof addr);
        if (rc < 0 && errno != EINPROGRESS) {
            close(fd);
            delete u;
            b->healthy.store(false, std::memory_order_relaxed);
            // a synchronous connect failure is a plain backend failure
            // (there is no stale-pool ambiguity on a fresh socket)
            if (!rq->is_write) {
                ++rq->order_pos;
                if (rq->order_pos < rq->order.size()) {
                    px->n_retries.fetch_add(1, std::memory_order_relaxed);
                    dispatch(px, rq);
                    return;
                }
            }
            fail_request(px, rq);
            return;
        }
        u->fd = fd;
        u->pooled = false;
        u->connecting = rc < 0;
    }
    px->ups[u->fd] = u;
    ++b->active;
    if (u->connecting) ++b->connecting_now;
    start_upstream_io(px, u);
    if (!u->connecting) {
        // try an immediate write (common case: loopback, buffer space)
        while (u->ooff < u->out.size()) {
            ssize_t w = ::send(u->fd, u->out.data() + u->ooff,
                               u->out.size() - u->ooff, MSG_NOSIGNAL);
            if (w > 0) {
                u->ooff += (size_t)w;
                continue;
            }
            if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
            upstream_fail(px, u);
            return;
        }
        if (u->ooff == u->out.size()) {
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.fd = u->fd;
            epoll_ctl(px->epoll_fd, EPOLL_CTL_MOD, u->fd, &ev);
        }
    }
}

// a complete upstream response is buffered in u->in; relay it
void upstream_complete(Proxy* px, Upstream* u) {
    Backend* b = u->backend;
    uint64_t reqid = u->reqid;
    int status = u->status;
    std::string ctype = u->ctype.empty() ? "application/json" : u->ctype;
    size_t body_off = u->hdr_end;
    std::string body =
        u->chunked ? std::move(u->decoded)
                   : u->in.substr(body_off,
                                  u->body_need >= 0 ? (size_t)u->body_need
                                                    : std::string::npos);
    // reusable only when the response framing was explicit (length or a
    // completed chunk stream) — close-delimited conns are spent
    bool reusable = u->resp_ka && (u->body_need >= 0 || u->chunked);
    int fd = u->fd;
    --b->active;
    epoll_ctl(px->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
    px->ups.erase(fd);
    delete u;
    if (reusable) {
        std::lock_guard<std::mutex> lk(px->b_mu);
        if (!b->retired && b->idle.size() < 32) {
            b->idle.push_back(fd);
            px->idle_owner[fd] = b;
            // watch for EOF while idle so a backend restart is noticed
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.fd = fd;
            epoll_ctl(px->epoll_fd, EPOLL_CTL_ADD, fd, &ev);
            fd = -1;
        }
    }
    if (fd >= 0) {
        close(fd);
        px->dead_this_batch[fd] = true;
    }
    wake_waiter(px, b);

    auto rit = px->reqs.find(reqid);
    if (rit == px->reqs.end()) return;
    Request* rq = rit->second;
    rq->retried_same = false;

    bool stored = rq->path.rfind("/v1/query/", 0) == 0;
    if (!b->primary && status == 400 &&
        body.find("read-only replica") != std::string::npos) {
        // a write the byte-sniff missed (dynamic /v1/query with a
        // JSON-escaped "request_type") or an undiscovered write-kind
        // stored route: learn stored routes, re-send to the primary
        // (mirrors ha_front.handle's learn-and-retry)
        if (stored) {
            std::lock_guard<std::mutex> lk(px->wr_mu);
            px->write_routes.insert(rq->path.substr(strlen("/v1/query/")));
        }
        rq->is_write = true;
        dispatch(px, rq);
        return;
    }
    if (!b->primary && stored && status >= 400) {
        // e.g. replica missed a bundle deploy: another backend may have
        // the route; surface the error only if every backend agrees
        rq->last_wire.clear();
        build_response(rq->last_wire, status, ctype.c_str(), body.data(),
                       body.size(), rq->client_ka);
        rq->have_last = true;
        ++rq->order_pos;
        if (rq->order_pos < rq->order.size()) {
            dispatch(px, rq);
            return;
        }
        deliver(px, reqid, std::move(rq->last_wire));
        return;
    }
    std::string wire;
    build_response(wire, status, ctype.c_str(), body.data(), body.size(),
                   rq->client_ka);
    px->n_proxied.fetch_add(1, std::memory_order_relaxed);
    deliver(px, reqid, std::move(wire));
}

void upstream_readable(Proxy* px, Upstream* u) {
    char buf[1 << 16];
    for (;;) {
        ssize_t r = recv(u->fd, buf, sizeof buf, 0);
        if (r > 0) {
            u->in.append(buf, (size_t)r);
            if ((size_t)r < sizeof buf) break;
            continue;
        }
        if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
        // EOF: valid end for close-delimited responses only (a chunked
        // stream cut before its 0-chunk is a broken exchange)
        if (u->have_header && !u->chunked && u->body_need < 0) {
            upstream_complete(px, u);
            return;
        }
        upstream_fail(px, u);
        return;
    }
    if (!u->have_header) {
        size_t hdr_end = u->in.find("\r\n\r\n");
        if (hdr_end == std::string::npos) return;
        u->hdr_end = hdr_end + 4;
        u->have_header = true;
        // status line: HTTP/1.1 NNN ...
        const char* p = u->in.data();
        const char* sp = (const char*)memchr(p, ' ', hdr_end);
        u->status = sp ? atoi(sp + 1) : 502;
        u->body_need = -1;
        u->resp_ka = true;
        size_t pos = u->in.find("\r\n") + 2;
        while (pos < hdr_end) {
            size_t eol = u->in.find("\r\n", pos);
            if (eol == std::string::npos || eol > hdr_end) eol = hdr_end;
            const char* h = u->in.data() + pos;
            const char* he = u->in.data() + eol;
            const char* colon = (const char*)memchr(h, ':', he - h);
            if (colon) {
                size_t nlen = colon - h;
                const char* v = colon + 1;
                while (v < he && (*v == ' ' || *v == '\t')) ++v;
                if (iequal(h, nlen, "content-length")) {
                    u->body_need = atoll(v);
                } else if (iequal(h, nlen, "transfer-encoding")) {
                    if (he - v >= 7) u->chunked = true;
                } else if (iequal(h, nlen, "connection")) {
                    if (he - v >= 5 && strncasecmp(v, "close", 5) == 0)
                        u->resp_ka = false;
                } else if (iequal(h, nlen, "content-type")) {
                    u->ctype.assign(v, he - v);
                }
            }
            pos = eol + 2;
        }
    }
    if (!u->have_header) return;
    if (u->chunked) {
        if (u->c_off < u->hdr_end) u->c_off = u->hdr_end;
        int rc = decode_chunks(u);
        if (rc == 1) upstream_complete(px, u);
        else if (rc == -1) upstream_fail(px, u);
        return;
    }
    if (u->body_need >= 0 &&
        (long long)(u->in.size() - u->hdr_end) >= u->body_need) {
        upstream_complete(px, u);
    }
}

// parse complete client requests out of c->rbuf; false if conn closed
bool drain_client(Proxy* px, ClientConn* c) {
    // dispatch() below can synchronously fail a request, deliver the
    // error, flush, and — when the client asked Connection: close —
    // delete this very connection.  Re-validate by (fd, gen) after
    // every dispatch before touching `c` again.
    const int cfd = c->fd;
    const uint64_t cgen = c->gen;
    for (;;) {
        if (!c->have_header) {
            size_t hdr_end = c->rbuf.find("\r\n\r\n", c->roff);
            if (hdr_end == std::string::npos) {
                if (c->roff > 0 && c->roff == c->rbuf.size()) {
                    c->rbuf.clear();
                    c->roff = 0;
                }
                return true;
            }
            const char* base = c->rbuf.data();
            size_t line_end = c->rbuf.find("\r\n", c->roff);
            {
                const char* l = base + c->roff;
                const char* le = base + line_end;
                const char* sp1 = (const char*)memchr(l, ' ', le - l);
                if (!sp1) { close_client(px, c); return false; }
                const char* sp2 =
                    (const char*)memchr(sp1 + 1, ' ', le - sp1 - 1);
                if (!sp2) { close_client(px, c); return false; }
                c->method.assign(l, sp1 - l);
                c->path.assign(sp1 + 1, sp2 - sp1 - 1);
            }
            c->body_need = 0;
            c->keep_alive = true;
            c->require_writer = false;
            c->fwd_headers.clear();
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
                    if (iequal(h, nlen, "content-length")) {
                        // reject a malformed value rather than treating
                        // it as 0 and reparsing the body bytes as the
                        // next request (smuggling primitive); reject a
                        // DUPLICATE header for the same reason — a
                        // front hop honoring the first value while we
                        // honor the last desynchronizes the stream
                        char* endp = nullptr;
                        unsigned long long cl = strtoull(v, &endp, 10);
                        const char* q = endp;
                        while (q < he && (*q == ' ' || *q == '\t')) ++q;
                        if (endp == v || q != he || cl_seen) {
                            close_client(px, c);
                            return false;
                        }
                        cl_seen = true;
                        c->body_need = (size_t)cl;
                    } else if (iequal(h, nlen, "transfer-encoding")) {
                        // chunked request bodies are not deframed here;
                        // forwarding with body_need=0 would silently
                        // drop the body and parse the chunk framing as
                        // the next request (the gateway 501s this too)
                        close_client(px, c);
                        return false;
                    } else if (iequal(h, nlen, "connection")) {
                        if (he - v >= 5 && strncasecmp(v, "close", 5) == 0)
                            c->keep_alive = false;
                    } else if (iequal(h, nlen, "x-helix-require-writer")) {
                        if (he - v >= 4 && strncasecmp(v, "true", 4) == 0)
                            c->require_writer = true;
                        c->fwd_headers.append(h, eol + 2 - pos);
                    } else if (!hop_header(h, nlen)) {
                        c->fwd_headers.append(h, eol + 2 - pos);
                    }
                }
                pos = eol + 2;
            }
            c->roff = hdr_end + 4;
            c->have_header = true;
            if (c->body_need > px->max_body) {
                close_client(px, c);
                return false;
            }
        }
        if (c->rbuf.size() - c->roff < c->body_need) {
            if (c->roff > (1u << 20)) {
                c->rbuf.erase(0, c->roff);
                c->roff = 0;
            }
            return true;
        }
        std::string body = c->rbuf.substr(c->roff, c->body_need);
        c->roff += c->body_need;
        c->have_header = false;

        Request* rq = new Request();
        rq->reqid = px->next_reqid++;
        rq->cfd = c->fd;
        rq->cgen = c->gen;
        rq->seq = c->next_issue_seq++;
        rq->client_ka = c->keep_alive;
        rq->method = c->method;
        rq->path = c->path;
        rq->fwd_headers = c->fwd_headers;
        rq->body = std::move(body);
        px->reqs.emplace(rq->reqid, rq);

        if (rq->path == "/v1/ha" || rq->path == "/v1/bundle") {
            ControlReq cr;
            cr.reqid = rq->reqid;
            cr.method = rq->method;
            cr.path = rq->path;
            cr.body = rq->body;
            cr.headers = rq->fwd_headers;
            {
                std::lock_guard<std::mutex> lk(px->q_mu);
                px->cqueue.push_back(std::move(cr));
            }
            px->n_control.fetch_add(1, std::memory_order_relaxed);
            px->q_cv.notify_all();
            continue;
        }

        bool is_write = c->require_writer ||
                        rq->path == "/v1/source" || rq->path == "/mcp";
        if (!is_write && rq->path == "/v1/query")
            is_write = body_requests_write(rq->body);
        if (!is_write && rq->path.rfind("/v1/query/", 0) == 0) {
            std::lock_guard<std::mutex> lk(px->wr_mu);
            is_write = px->write_routes.count(
                           rq->path.substr(strlen("/v1/query/"))) > 0;
        }
        rq->is_write = is_write;
        if (!is_write) build_read_order(px, rq);
        dispatch(px, rq);
        auto self = px->conns.find(cfd);
        if (self == px->conns.end() || self->second->gen != cgen)
            return false;  // conn died during a synchronous failure path
    }
}

void io_loop(Proxy* px) {
    epoll_event events[256];
    double last_sweep = now_s();
    while (px->running.load(std::memory_order_acquire)) {
        int n = epoll_wait(px->epoll_fd, events, 256, 100);
        px->dead_this_batch.clear();
        for (int i = 0; i < n; ++i) {
            int fd = events[i].data.fd;
            if (px->dead_this_batch.count(fd)) continue;
            if (fd == px->listen_fd) {
                for (;;) {
                    int cfd = accept4(px->listen_fd, nullptr, nullptr,
                                      SOCK_NONBLOCK);
                    if (cfd < 0) break;
                    int one = 1;
                    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one,
                               sizeof one);
                    ClientConn* c = new ClientConn();
                    c->fd = cfd;
                    c->gen = px->next_gen++;
                    px->conns[cfd] = c;
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.fd = cfd;
                    epoll_ctl(px->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
                }
                continue;
            }
            if (fd == px->event_fd) {
                uint64_t junk;
                while (read(px->event_fd, &junk, 8) == 8) {}
                std::deque<std::pair<uint64_t, std::string>> resp;
                {
                    std::lock_guard<std::mutex> lk(px->resp_mu);
                    resp.swap(px->resp_queue);
                }
                for (auto& [reqid, wire] : resp)
                    deliver(px, reqid, std::move(wire));
                continue;
            }
            // upstream socket?
            auto uit = px->ups.find(fd);
            if (uit != px->ups.end()) {
                Upstream* u = uit->second;
                if (events[i].events & (EPOLLHUP | EPOLLERR)) {
                    // a half-closed upstream may still have the response
                    // buffered; try to read it out first
                    upstream_readable(px, u);
                    continue;
                }
                if (events[i].events & EPOLLOUT) {
                    if (u->connecting) {
                        int err = 0;
                        socklen_t elen = sizeof err;
                        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
                        if (err != 0) {
                            upstream_fail(px, u);
                            continue;
                        }
                        u->connecting = false;
                        // connect budget freed: let the next queued
                        // request start its own connect
                        --u->backend->connecting_now;
                        hxha::wake_waiter(px, u->backend);
                    }
                    bool died = false;
                    while (u->ooff < u->out.size()) {
                        ssize_t w = ::send(fd, u->out.data() + u->ooff,
                                           u->out.size() - u->ooff,
                                           MSG_NOSIGNAL);
                        if (w > 0) {
                            u->ooff += (size_t)w;
                            continue;
                        }
                        if (w < 0 &&
                            (errno == EAGAIN || errno == EWOULDBLOCK))
                            break;
                        upstream_fail(px, u);
                        died = true;
                        break;
                    }
                    if (died) continue;
                    if (u->ooff == u->out.size()) {
                        epoll_event ev{};
                        ev.events = EPOLLIN;
                        ev.data.fd = fd;
                        epoll_ctl(px->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
                    }
                }
                if (events[i].events & EPOLLIN) upstream_readable(px, u);
                continue;
            }
            // idle pooled upstream: EOF means the backend dropped it
            auto iit = px->idle_owner.find(fd);
            if (iit != px->idle_owner.end()) {
                Backend* b = iit->second;
                {
                    std::lock_guard<std::mutex> lk(px->b_mu);
                    auto& pool = b->idle;
                    for (size_t j = 0; j < pool.size(); ++j)
                        if (pool[j] == fd) {
                            pool.erase(pool.begin() + j);
                            break;
                        }
                }
                px->idle_owner.erase(iit);
                epoll_ctl(px->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
                close(fd);
                px->dead_this_batch[fd] = true;
                continue;
            }
            // client socket
            auto cit = px->conns.find(fd);
            if (cit == px->conns.end()) continue;
            ClientConn* c = cit->second;
            if (events[i].events & (EPOLLHUP | EPOLLERR)) {
                close_client(px, c);
                continue;
            }
            if (events[i].events & EPOLLOUT) {
                if (!flush_client(px, c)) continue;
            }
            if (events[i].events & EPOLLIN) {
                char buf[1 << 16];
                bool closed = false;
                for (;;) {
                    ssize_t r = recv(fd, buf, sizeof buf, 0);
                    if (r > 0) {
                        c->rbuf.append(buf, (size_t)r);
                        if ((size_t)r < sizeof buf) break;
                        continue;
                    }
                    if (r == 0) { closed = true; break; }
                    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
                    closed = true;
                    break;
                }
                if (!drain_client(px, c)) continue;
                if (closed) close_client(px, c);
            }
        }
        // timeout sweep (~1 Hz is plenty at a 120 s upstream budget)
        double t = now_s();
        if (t - last_sweep > 1.0) {
            last_sweep = t;
            std::vector<Upstream*> expired;
            for (auto& [ufd, u] : px->ups)
                if (t > u->deadline) expired.push_back(u);
            for (Upstream* u : expired) upstream_fail(px, u);
            // drain idle pools of backends marked down (their sockets
            // may still look alive while the backend drains)
            std::vector<int> drop;
            {
                std::lock_guard<std::mutex> lk(px->b_mu);
                for (Backend* b : px->backends) {
                    if (b->healthy.load(std::memory_order_relaxed) &&
                        !b->retired)
                        continue;
                    for (int ifd : b->idle) drop.push_back(ifd);
                    b->idle.clear();
                }
            }
            for (int ifd : drop) {
                px->idle_owner.erase(ifd);
                epoll_ctl(px->epoll_fd, EPOLL_CTL_DEL, ifd, nullptr);
                close(ifd);
                px->dead_this_batch[ifd] = true;
            }
            // fail over reads stuck on an unhealthy backend before the
            // 120 s budget: a zombie listener (bound socket, dead
            // server) accepts connects and then never answers.  Only
            // exchanges with ZERO response bytes are retried — reads
            // are idempotent; writes keep the full budget since the
            // request may already be executing.
            std::vector<Upstream*> cut;
            for (auto& [ufd, u] : px->ups) {
                if (u->backend->healthy.load(std::memory_order_relaxed))
                    continue;
                if (!u->in.empty()) continue;
                auto rit = px->reqs.find(u->reqid);
                if (rit == px->reqs.end() || rit->second->is_write)
                    continue;
                cut.push_back(u);
            }
            for (Upstream* u : cut) upstream_fail(px, u);
            // waiters with no connection activity left to wake them
            // (e.g. the backend was retired mid-queue) get kicked here;
            // pointers are collected under b_mu (backends may grow
            // concurrently) but dispatch must run unlocked
            std::vector<Backend*> kick;
            {
                std::lock_guard<std::mutex> lk(px->b_mu);
                for (Backend* b : px->backends)
                    if (!b->waiting.empty() && b->active == 0 &&
                        b->connecting_now == 0)
                        kick.push_back(b);
            }
            for (Backend* b : kick) wake_waiter(px, b);
        }
    }
}

}  // namespace hxha

// ---------------------------------------------------------------- C ABI

using hxha::Proxy;
using hxha::Backend;

extern "C" {

void* hxha_create(const char* host, int port) {
    Proxy* px = new Proxy();
    px->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (px->listen_fd < 0) { delete px; return nullptr; }
    int one = 1;
    setsockopt(px->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = host && host[0] ? inet_addr(host) : INADDR_ANY;
    if (bind(px->listen_fd, (sockaddr*)&addr, sizeof addr) < 0 ||
        listen(px->listen_fd, 1024) < 0) {
        close(px->listen_fd);
        delete px;
        return nullptr;
    }
    socklen_t alen = sizeof addr;
    getsockname(px->listen_fd, (sockaddr*)&addr, &alen);
    px->port = ntohs(addr.sin_port);
    px->epoll_fd = epoll_create1(0);
    px->event_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = px->listen_fd;
    epoll_ctl(px->epoll_fd, EPOLL_CTL_ADD, px->listen_fd, &ev);
    ev.data.fd = px->event_fd;
    epoll_ctl(px->epoll_fd, EPOLL_CTL_ADD, px->event_fd, &ev);
    return px;
}

int hxha_port(void* h) { return ((Proxy*)h)->port; }

// spec: one backend per line, "role host port healthy" with role
// p(rimary)/r(eplica) and healthy 0/1.  Replaces the topology; health
// flags always refresh; a backend missing from the new spec is retired
// (in-flight requests against it finish; its pool is drained lazily).
void hxha_set_backends(void* h, const char* spec) {
    Proxy* px = (Proxy*)h;
    std::lock_guard<std::mutex> lk(px->b_mu);
    for (Backend* b : px->backends) b->retired = true;
    const char* p = spec;
    while (*p) {
        char role;
        char host[256];
        int port = 0, healthy = 1;
        int consumed = 0;
        if (sscanf(p, " %c %255s %d %d%n", &role, host, &port, &healthy,
                   &consumed) == 4) {
            Backend* match = nullptr;
            for (Backend* b : px->backends)
                if (b->retired && b->host == host && b->port == port &&
                    b->primary == (role == 'p')) {
                    match = b;
                    break;
                }
            if (match) {
                match->retired = false;
                match->healthy.store(healthy != 0,
                                     std::memory_order_relaxed);
            } else {
                Backend* b = new Backend();
                b->host = host;
                b->port = port;
                b->primary = role == 'p';
                b->healthy.store(healthy != 0, std::memory_order_relaxed);
                px->backends.push_back(b);
            }
            p += consumed;
        } else {
            break;
        }
        while (*p == '\n' || *p == '\r' || *p == ' ') ++p;
    }
}

int hxha_start(void* h) {
    Proxy* px = (Proxy*)h;
    px->running.store(true, std::memory_order_release);
    px->io_thread = std::thread(hxha::io_loop, px);
    return 0;
}

void hxha_stop(void* h) {
    Proxy* px = (Proxy*)h;
    px->running.store(false, std::memory_order_release);
    hxha::poke(px);
    if (px->io_thread.joinable()) px->io_thread.join();
    px->q_cv.notify_all();
}

void hxha_destroy(void* h) {
    Proxy* px = (Proxy*)h;
    if (px->running.load()) hxha_stop(h);
    for (auto& [fd, c] : px->conns) {
        close(fd);
        delete c;
    }
    for (auto& [fd, u] : px->ups) {
        close(fd);
        delete u;
    }
    for (auto& [fd, b] : px->idle_owner) close(fd);
    for (auto& [reqid, rq] : px->reqs) delete rq;
    for (Backend* b : px->backends) delete b;
    if (px->listen_fd >= 0) close(px->listen_fd);
    if (px->epoll_fd >= 0) close(px->epoll_fd);
    if (px->event_fd >= 0) close(px->event_fd);
    delete px;
}

// control requests (/v1/ha, /v1/bundle) for the Python worker; same
// grow-and-retry contract as hxgw_next_general
long long hxha_next_control(void* h, int timeout_ms, char* method,
                            int method_cap, char* path, int path_cap,
                            char* body, long long body_cap,
                            long long* body_len,
                            char* headers, long long headers_cap,
                            long long* headers_len) {
    Proxy* px = (Proxy*)h;
    std::unique_lock<std::mutex> lk(px->q_mu);
    if (px->cqueue.empty()) {
        px->q_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
            return !px->cqueue.empty() ||
                   !px->running.load(std::memory_order_acquire);
        });
    }
    if (px->cqueue.empty())
        return px->running.load(std::memory_order_acquire) ? 0 : -1;
    hxha::ControlReq& cr = px->cqueue.front();
    *body_len = (long long)cr.body.size();
    *headers_len = (long long)cr.headers.size();
    if ((long long)cr.body.size() > body_cap ||
        (long long)cr.headers.size() > headers_cap)
        return -2;  // caller re-calls with buffers of the reported sizes
    snprintf(method, method_cap, "%s", cr.method.c_str());
    snprintf(path, path_cap, "%s", cr.path.c_str());
    memcpy(body, cr.body.data(), cr.body.size());
    memcpy(headers, cr.headers.data(), cr.headers.size());
    long long reqid = (long long)cr.reqid;
    px->cqueue.pop_front();
    return reqid;
}

int hxha_respond(void* h, unsigned long long reqid, int status,
                 const char* ctype, const char* body, long long body_len) {
    Proxy* px = (Proxy*)h;
    std::string wire;
    hxha::build_response(wire, status, ctype ? ctype : "application/json",
                         body, (size_t)body_len, true);
    {
        std::lock_guard<std::mutex> lk(px->resp_mu);
        px->resp_queue.emplace_back(reqid, std::move(wire));
    }
    hxha::poke(px);
    return 0;
}

// learned write-kind stored routes, newline-joined; returns byte count
// (or required size if cap is too small)
long long hxha_write_routes(void* h, char* buf, long long cap) {
    Proxy* px = (Proxy*)h;
    std::string out;
    {
        std::lock_guard<std::mutex> lk(px->wr_mu);
        for (const auto& r : px->write_routes) {
            if (!out.empty()) out += "\n";
            out += r;
        }
    }
    if ((long long)out.size() > cap) return (long long)out.size();
    memcpy(buf, out.data(), out.size());
    return (long long)out.size();
}

void hxha_add_write_route(void* h, const char* name) {
    Proxy* px = (Proxy*)h;
    std::lock_guard<std::mutex> lk(px->wr_mu);
    px->write_routes.insert(name);
}

void hxha_stats(void* h, unsigned long long* n_proxied,
                unsigned long long* n_retries,
                unsigned long long* n_control) {
    Proxy* px = (Proxy*)h;
    *n_proxied = px->n_proxied.load(std::memory_order_relaxed);
    *n_retries = px->n_retries.load(std::memory_order_relaxed);
    *n_control = px->n_control.load(std::memory_order_relaxed);
}

}  // extern "C"
