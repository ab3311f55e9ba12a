// Write-ahead log: framed, checksummed, fsync-controlled append log.
//
// The durability backbone of disk mode (the rebuild's analog of the
// reference engine's S3/LMDB-backed persistence; env contract
// helix-cli/src/local_runtime.rs:773-786, durability acknowledgment
// header sdks/rust/src/lib.rs:292-298).  Records are logical: the engine
// appends the serialized write request (plus its evaluation clock) and
// replays surviving records over the latest snapshot on startup.
//
// File layout:
//   [8-byte header: "HXWAL\0" + u16 version]
//   repeated records: u32 payload_len | u32 crc32(payload) | payload
//
// A torn tail (partial record or CRC mismatch) terminates replay cleanly:
// everything before it is intact, matching fsync semantics.
//
// C ABI only (loaded via ctypes).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr char kMagic[6] = {'H', 'X', 'W', 'A', 'L', '\0'};
constexpr uint16_t kVersion = 1;
constexpr size_t kHeaderSize = 8;

uint32_t crc_table[256];
bool crc_ready = false;

void init_crc() {
  if (crc_ready) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) {
      c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
    }
    crc_table[i] = c;
  }
  crc_ready = true;
}

uint32_t crc32(const uint8_t* data, size_t len) {
  init_crc();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) {
    c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  int fd = -1;
};

struct Reader {
  FILE* fp = nullptr;
  uint8_t* buf = nullptr;
  size_t cap = 0;
};

bool write_all(int fd, const void* data, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  while (len > 0) {
    ssize_t n = ::write(fd, p, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

}  // namespace

extern "C" {

// Open (or create) a WAL for appending. Returns nullptr on failure —
// including a file whose header is torn or not a WAL: appending past a
// bad header would fsync-acknowledge records that replay can never
// read (the reader rejects the file wholesale on a magic mismatch).
void* hxwal_open(const char* path) {
  int fd = ::open(path, O_CREAT | O_RDWR | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  off_t size = ::lseek(fd, 0, SEEK_END);
  if (size == 0) {
    uint8_t header[kHeaderSize];
    memcpy(header, kMagic, sizeof(kMagic));
    memcpy(header + sizeof(kMagic), &kVersion, sizeof(kVersion));
    if (!write_all(fd, header, sizeof(header))) {
      ::close(fd);
      return nullptr;
    }
  } else {
    uint8_t header[kHeaderSize];
    bool ok = size >= static_cast<off_t>(kHeaderSize) &&
              ::pread(fd, header, sizeof(header), 0) ==
                  static_cast<ssize_t>(sizeof(header)) &&
              memcmp(header, kMagic, sizeof(kMagic)) == 0;
    if (!ok) {
      ::close(fd);
      return nullptr;
    }
  }
  Writer* w = new Writer();
  w->fd = fd;
  return w;
}

// Largest record either side of the log accepts.  Append and replay
// MUST agree: a record the writer fsync-acknowledges but the reader
// rejects as corrupt would silently truncate replay at that point.
constexpr uint32_t kMaxRecord = 1u << 30;

// Append one record; sync!=0 fsyncs before returning. Returns 0 on success.
int hxwal_append(void* handle, const void* data, uint32_t len, int sync) {
  Writer* w = static_cast<Writer*>(handle);
  if (len > kMaxRecord) return -1;  // reader would reject it on replay
  uint32_t crc = crc32(static_cast<const uint8_t*>(data), len);
  uint8_t frame[8];
  memcpy(frame, &len, 4);
  memcpy(frame + 4, &crc, 4);
  if (!write_all(w->fd, frame, sizeof(frame))) return -1;
  if (!write_all(w->fd, data, len)) return -1;
  if (sync && ::fdatasync(w->fd) != 0) return -1;
  return 0;
}

// Flush pending appends to stable storage.
int hxwal_flush(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  return ::fdatasync(w->fd) == 0 ? 0 : -1;
}

// Truncate the log back to an empty header (after a snapshot).
int hxwal_reset(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (::ftruncate(w->fd, static_cast<off_t>(kHeaderSize)) != 0) return -1;
  if (::lseek(w->fd, 0, SEEK_END) < 0) return -1;
  return ::fdatasync(w->fd) == 0 ? 0 : -1;
}

void hxwal_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (w->fd >= 0) ::close(w->fd);
  delete w;
}

// ---- replay ----

void* hxwal_reader_open(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  uint8_t header[kHeaderSize];
  if (fread(header, 1, sizeof(header), fp) != sizeof(header) ||
      memcmp(header, kMagic, sizeof(kMagic)) != 0) {
    fclose(fp);
    return nullptr;
  }
  Reader* r = new Reader();
  r->fp = fp;
  return r;
}

// Read the next intact record. Returns its length (0 is a valid empty
// record), or -1 at end-of-log / torn tail / corruption; fills *data_out
// with a pointer valid until the next call or close.
long hxwal_reader_next(void* handle, const void** data_out) {
  Reader* r = static_cast<Reader*>(handle);
  uint8_t frame[8];
  if (fread(frame, 1, sizeof(frame), r->fp) != sizeof(frame)) return -1;
  uint32_t len, crc;
  memcpy(&len, frame, 4);
  memcpy(&crc, frame + 4, 4);
  if (len > kMaxRecord) return -1;  // corrupt length
  if (len > r->cap) {
    size_t cap = len ? len : 1;
    uint8_t* grown = static_cast<uint8_t*>(realloc(r->buf, cap));
    if (!grown) return -1;  // keep buf/cap consistent on OOM
    r->buf = grown;
    r->cap = cap;
  }
  if (len && fread(r->buf, 1, len, r->fp) != len) return -1;  // torn tail
  if (crc32(r->buf, len) != crc) return -1;                   // corrupt
  *data_out = r->buf;
  return static_cast<long>(len);
}

void hxwal_reader_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r->fp) fclose(r->fp);
  free(r->buf);
  delete r;
}

}  // extern "C"
