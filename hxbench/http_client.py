"""One client process of the ``http`` mix, standard library only (it runs
under ``python -S``).

Reads from standard input one JSON header line (``port``, ``dim``, ``k``,
``path``, ``n``, ``connections``, ``sample``, ``grace_s``), then ``n``
float64 due times (seconds from the start) and ``n * dim`` float32 query
components; builds every request, connects, prints ``ready``, and waits
for a line ``go <start>`` (a ``time.monotonic`` reading).  It sends
request i at ``start + due[i]`` on connection ``i % connections``
(keep-alive, pipelined: responses return in order on each connection),
and ends when every request is answered, or ``grace_s`` past its last
due time.  It prints one JSON line: per request its latency from the due
time (-1 where unanswered), its lateness in sending and its HTTP status,
and the bodies of the ``sample`` requests."""

import json
import selectors
import socket
import sys
import time
from array import array
from collections import deque


def build(header, due, vecs):
    dim, k = header["dim"], header["k"]
    head = ("POST %s HTTP/1.1\r\nHost: bench\r\n"
            "Content-Type: application/json\r\nContent-Length: "
            % header["path"]).encode()
    reqs = []
    for i in range(len(due)):
        row = vecs[i * dim:(i + 1) * dim]
        body = ('{"q":[%s],"k":%d}'
                % (",".join(["%.9g" % v for v in row]), k)).encode()
        reqs.append(head + b"%d\r\n\r\n" % len(body) + body)
    return reqs


def parse(buf):
    """Complete responses at the front of ``buf``: ``[(status, body)]``,
    and the bytes they took."""
    out = []
    at = 0
    while True:
        end = buf.find(b"\r\n\r\n", at)
        if end < 0:
            return out, at
        head = bytes(buf[at:end])
        length = 0
        for line in head.split(b"\r\n")[1:]:
            name, _, value = line.partition(b":")
            if name.strip().lower() == b"content-length":
                length = int(value)
        if len(buf) < end + 4 + length:
            return out, at
        status = int(head[9:12])
        out.append((status, bytes(buf[end + 4:end + 4 + length])))
        at = end + 4 + length


def main():
    inp = sys.stdin.buffer
    header = json.loads(inp.readline())
    n, dim = header["n"], header["dim"]
    due = array("d")
    due.frombytes(inp.read(8 * n))
    vecs = array("f")
    vecs.frombytes(inp.read(4 * n * dim))
    reqs = build(header, due, vecs)
    sample = set(header["sample"])
    n_conn = header["connections"]
    conns = []
    sel = selectors.DefaultSelector()
    for j in range(n_conn):
        s = socket.create_connection(("127.0.0.1", header["port"]))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conns.append(s)
        sel.register(s, selectors.EVENT_READ, j)
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    start = float(inp.readline().split()[1])

    lat = [-1.0] * n
    late = [0.0] * n
    status = [0] * n
    bodies = {}
    fifo = [deque() for _ in range(n_conn)]
    bufs = [bytearray() for _ in range(n_conn)]
    nxt = 0
    outstanding = 0
    deadline = start + (due[-1] if n else 0.0) + header["grace_s"]
    while nxt < n or outstanding:
        now = time.monotonic()
        if now > deadline:
            break
        while nxt < n and start + due[nxt] <= now:
            j = nxt % n_conn
            conns[j].sendall(reqs[nxt])
            late[nxt] = time.monotonic() - (start + due[nxt])
            fifo[j].append(nxt)
            nxt += 1
            outstanding += 1
        wait = (start + due[nxt] - time.monotonic()) if nxt < n else 0.1
        for key, _ in sel.select(max(wait, 0.0)):
            j = key.data
            data = conns[j].recv(1 << 18)
            t = time.monotonic()
            if not data:
                sel.unregister(conns[j])
                outstanding -= len(fifo[j])
                fifo[j].clear()
                continue
            bufs[j] += data
            got, used = parse(bufs[j])
            del bufs[j][:used]
            for code, body in got:
                i = fifo[j].popleft()
                outstanding -= 1
                lat[i] = t - (start + due[i])
                status[i] = code
                if i in sample:
                    bodies[i] = body.decode()
    for s in conns:
        s.close()
    sys.stdout.write(json.dumps({"lat": lat, "late": late, "status": status,
                                 "bodies": bodies}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
