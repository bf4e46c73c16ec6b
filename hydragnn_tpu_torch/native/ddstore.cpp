// Shared-memory sample store — the TPU-host analog of ORNL's DDStore
// (reference: pyddstore used by hydragnn/utils/datasets/distdataset.py:1-183;
// a C++/MPI one-sided remote-memory object store holding datasets larger
// than a single process can). On TPU pods every host feeds only its own
// devices and datasets are sharded per host (data/columnar.py), so the
// cross-node MPI RMA plane collapses to an intra-host concern: many loader
// processes sharing one pinned copy of the samples. This store provides
// that: a POSIX shared-memory arena with a slot table indexed directly by
// sample id (ids are dense dataset indices, so lookup is O(1)), atomic
// space reservation with no partial-failure leaks, and epoch_begin/end
// fences kept API-compatible with DDStore's windowed access
// (train loop brackets: train_validate_test.py:480-563).
//
// Build: g++ -O3 -shared -fPIC -o _ddstore.so ddstore.cpp -lrt
// (driven by hydragnn_tpu_torch/native/build.py; loaded via ctypes).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x44445354'2d545055ULL;  // "DDST-TPU"

struct Header {
  // Cross-process readiness flag: written last by the creator with release
  // ordering, checked by attachers with acquire — guarantees capacity /
  // max_items / slot states are visible once magic reads valid, even on
  // weakly-ordered CPUs.
  std::atomic<uint64_t> magic;
  int64_t capacity;    // payload bytes
  int64_t max_items;   // slot-table size; valid ids are [0, max_items)
  std::atomic<int64_t> bump;       // next free payload offset
  std::atomic<int64_t> num_items;  // successfully published items
  std::atomic<int64_t> epoch;      // epoch_begin/end counter
};

struct Slot {
  std::atomic<int64_t> state;  // 0 = empty, 1 = published (set last)
  int64_t offset;
  int64_t length;
};

struct Store {
  Header* hdr;
  Slot* slots;
  char* payload;
  size_t mapped;
  int fd;
  char name[256];
};

size_t total_bytes(int64_t capacity, int64_t max_items) {
  return sizeof(Header) + sizeof(Slot) * (size_t)max_items + (size_t)capacity;
}

}  // namespace

extern "C" {

// Remove a named store (explicit cleanup of stale segments from crashed
// runs). Returns 0 on success.
int dds_unlink(const char* name) { return shm_unlink(name); }

// Create (create=1, fails with nullptr when the name already exists — the
// caller decides whether to dds_unlink a stale segment first) or attach
// (create=0) a named store. Returns nullptr on failure.
void* dds_open(const char* name, int64_t capacity, int64_t max_items,
               int create) {
  int fd;
  size_t bytes = 0;
  if (create) {
    fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return nullptr;  // EEXIST: never clobber silently
    bytes = total_bytes(capacity, max_items);
    if (ftruncate(fd, (off_t)bytes) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return nullptr;
    }
    bytes = (size_t)st.st_size;
  }
  void* base = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store;
  s->hdr = (Header*)base;
  s->mapped = bytes;
  s->fd = fd;
  strncpy(s->name, name, sizeof(s->name) - 1);
  s->name[sizeof(s->name) - 1] = 0;
  if (create) {
    s->hdr->capacity = capacity;
    s->hdr->max_items = max_items;
    s->hdr->bump.store(0);
    s->hdr->num_items.store(0);
    s->hdr->epoch.store(0);
  } else if (s->hdr->magic.load(std::memory_order_acquire) != kMagic) {
    munmap(base, bytes);
    close(fd);
    delete s;
    return nullptr;
  }
  s->slots = (Slot*)((char*)base + sizeof(Header));
  s->payload =
      (char*)base + sizeof(Header) + sizeof(Slot) * (size_t)s->hdr->max_items;
  if (create) {
    for (int64_t i = 0; i < max_items; ++i) s->slots[i].state.store(0);
    // publish header last: attachers acquire-check magic
    s->hdr->magic.store(kMagic, std::memory_order_release);
  }
  return s;
}

// Store a blob under id in [0, max_items). Returns 0 on success, -1 when the
// payload arena is full, -2 when id is out of range, -3 when id is already
// published. Space is reserved with a CAS loop so failed puts leak nothing.
int dds_put(void* h, int64_t id, const void* buf, int64_t nbytes) {
  Store* s = (Store*)h;
  if (id < 0 || id >= s->hdr->max_items) return -2;
  if (s->slots[id].state.load()) return -3;
  int64_t off = s->hdr->bump.load();
  do {
    if (off + nbytes > s->hdr->capacity) return -1;
  } while (!s->hdr->bump.compare_exchange_weak(off, off + nbytes));
  memcpy(s->payload + off, buf, (size_t)nbytes);
  s->slots[id].offset = off;
  s->slots[id].length = nbytes;
  s->slots[id].state.store(1);  // publish last
  s->hdr->num_items.fetch_add(1);
  return 0;
}

// Size of blob id, or -1 when absent.
int64_t dds_get_size(void* h, int64_t id) {
  Store* s = (Store*)h;
  if (id < 0 || id >= s->hdr->max_items || !s->slots[id].state.load())
    return -1;
  return s->slots[id].length;
}

// One-sided fetch (the DDStore get analog, distdataset.py:159-183).
// Copies at most nbytes into out; returns bytes copied or -1 when absent.
int64_t dds_get(void* h, int64_t id, void* out, int64_t nbytes) {
  Store* s = (Store*)h;
  if (id < 0 || id >= s->hdr->max_items || !s->slots[id].state.load())
    return -1;
  int64_t len = s->slots[id].length < nbytes ? s->slots[id].length : nbytes;
  memcpy(out, s->payload + s->slots[id].offset, (size_t)len);
  return len;
}

int64_t dds_count(void* h) { return ((Store*)h)->hdr->num_items.load(); }

int64_t dds_max_items(void* h) { return ((Store*)h)->hdr->max_items; }

int64_t dds_used_bytes(void* h) { return ((Store*)h)->hdr->bump.load(); }

// Epoch window fences (DDStore epoch_begin/end semantics; here the store is
// always resident so these only bump a counter readers can observe).
void dds_epoch_begin(void* h) { ((Store*)h)->hdr->epoch.fetch_add(1); }
void dds_epoch_end(void* h) {}

int64_t dds_epoch(void* h) { return ((Store*)h)->hdr->epoch.load(); }

void dds_close(void* h, int unlink_shm) {
  Store* s = (Store*)h;
  char name[256];
  strncpy(name, s->name, sizeof(name));
  munmap((void*)s->hdr, s->mapped);
  close(s->fd);
  if (unlink_shm) shm_unlink(name);
  delete s;
}

// ---------------------------------------------------------------------------
// Cross-host fetch plane (DCN). The reference DDStore serves datasets across
// nodes with MPI one-sided gets (distdataset.py:159-183); TPU pods have no
// MPI plane, so the remote path here is a tiny length-prefixed TCP protocol:
//   request  : int64 global_id
//   response : int64 nbytes (-1 when absent), then payload
// Each host serves its shm arena read-only (published slots only, acquire
// loads) and fetches other hosts' samples through persistent connections.
// ---------------------------------------------------------------------------

namespace {

bool read_full(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t r = write(fd, p, n);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

struct Server {
  Store* store;
  int64_t id_offset;  // global id of local slot 0
  int listen_fd;
  std::atomic<bool> stop;
  std::thread accept_thread;
  // live connection bookkeeping: dds_serve_stop shuts these sockets down
  // and waits for every connection thread to exit BEFORE the caller can
  // munmap the arena — no use-after-free on shutdown with in-flight peers
  std::mutex mu;
  std::vector<int> conns;
  std::atomic<int> live{0};
};

void serve_conn(Server* sv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int64_t gid;
  while (!sv->stop.load() && read_full(fd, &gid, sizeof(gid))) {
    Store* s = sv->store;
    int64_t id = gid - sv->id_offset;
    int64_t len = -1;
    const char* src = nullptr;
    if (id >= 0 && id < s->hdr->max_items &&
        s->slots[id].state.load(std::memory_order_acquire)) {
      len = s->slots[id].length;
      src = s->payload + s->slots[id].offset;
    }
    if (!write_full(fd, &len, sizeof(len))) break;
    if (len > 0 && !write_full(fd, src, (size_t)len)) break;
  }
  // deregister BEFORE close: once the fd number is released the kernel can
  // recycle it, and the stop sweep must never shutdown() a stranger's fd
  {
    std::lock_guard<std::mutex> lock(sv->mu);
    for (auto it = sv->conns.begin(); it != sv->conns.end(); ++it) {
      if (*it == fd) {
        sv->conns.erase(it);
        break;
      }
    }
  }
  close(fd);
  sv->live.fetch_sub(1);
}

struct Conn {
  int fd;
  std::vector<char> buf;
};

}  // namespace

// Serve this store's published slots on 0.0.0.0:port; ids received on the
// wire are global (local slot = id - id_offset). Returns an opaque server
// handle, or nullptr on bind failure.
void* dds_serve_start(void* h, int port, int64_t id_offset) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 64) != 0) {
    close(fd);
    return nullptr;
  }
  Server* sv = new Server;
  sv->store = (Store*)h;
  sv->id_offset = id_offset;
  sv->listen_fd = fd;
  sv->stop.store(false);
  sv->accept_thread = std::thread([sv]() {
    while (!sv->stop.load()) {
      int c = accept(sv->listen_fd, nullptr, nullptr);
      if (c < 0) {
        if (errno == EINTR) continue;
        break;  // listen socket closed by dds_serve_stop
      }
      if (sv->stop.load()) {
        close(c);
        break;
      }
      {
        std::lock_guard<std::mutex> lock(sv->mu);
        sv->conns.push_back(c);
      }
      sv->live.fetch_add(1);
      std::thread(serve_conn, sv, c).detach();
    }
  });
  return sv;
}

// Blocks until every connection thread has exited, so the caller may
// safely dds_close (munmap) the store afterwards.
void dds_serve_stop(void* server) {
  Server* sv = (Server*)server;
  sv->stop.store(true);
  // shutdown unblocks accept(); close only after the accept thread exits,
  // so it can never accept() on a recycled fd number
  shutdown(sv->listen_fd, SHUT_RDWR);
  if (sv->accept_thread.joinable()) sv->accept_thread.join();
  close(sv->listen_fd);
  while (sv->live.load() > 0) {
    {
      std::lock_guard<std::mutex> lock(sv->mu);
      for (int fd : sv->conns) shutdown(fd, SHUT_RDWR);
    }
    usleep(1000);
  }
  delete sv;
}

namespace {

void set_fd_timeout(int fd, int timeout_ms) {
  // SO_RCVTIMEO/SO_SNDTIMEO make a blocked read/write (and, on Linux, a
  // blocked connect via SNDTIMEO) fail with EAGAIN after the deadline;
  // read_full/write_full then report a broken stream and the Python client
  // reconnects — a server that accepts but never responds can no longer
  // wedge the loader forever. 0 disables (historical blocking behavior).
  if (timeout_ms <= 0) return;
  timeval tv{};
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

}  // namespace

// Apply send/receive timeouts (milliseconds; <= 0 leaves the socket
// blocking) to an existing client connection.
void dds_set_timeout(void* conn, int timeout_ms) {
  set_fd_timeout(((Conn*)conn)->fd, timeout_ms);
}

// Persistent client connection to a serving host, with an optional
// connect/IO timeout applied to the socket AT CREATION (timeout_ms <= 0 =
// blocking, the historical behavior). Returns nullptr on connect failure.
void* dds_connect_t(const char* host, int port, int timeout_ms) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) return nullptr;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    freeaddrinfo(res);
    return nullptr;
  }
  set_fd_timeout(fd, timeout_ms);  // bounds connect() too (SO_SNDTIMEO)
  if (connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    close(fd);
    freeaddrinfo(res);
    return nullptr;
  }
  freeaddrinfo(res);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  Conn* c = new Conn;
  c->fd = fd;
  return c;
}

void* dds_connect(const char* host, int port) {
  return dds_connect_t(host, port, 0);
}

// Fetch global id into the connection's scratch buffer. Returns the blob
// length, -1 when the server does not hold the id, -2 on a broken
// connection.
int64_t dds_fetch(void* conn, int64_t gid) {
  // sanity cap on the wire length: a desynced/corrupt stream must surface
  // as a recoverable broken-connection error, not a std::bad_alloc
  // terminating the process through the ctypes boundary
  constexpr int64_t kMaxFetchBytes = int64_t(1) << 33;  // 8 GiB
  Conn* c = (Conn*)conn;
  if (!write_full(c->fd, &gid, sizeof(gid))) return -2;
  int64_t len;
  if (!read_full(c->fd, &len, sizeof(len))) return -2;
  if (len == -1) return -1;
  if (len < 0 || len > kMaxFetchBytes) return -2;
  c->buf.resize((size_t)len);
  if (len > 0 && !read_full(c->fd, c->buf.data(), (size_t)len)) return -2;
  return len;
}

// Copy the last fetched payload out (up to nbytes); returns bytes copied.
int64_t dds_fetch_read(void* conn, void* out, int64_t nbytes) {
  Conn* c = (Conn*)conn;
  int64_t len =
      (int64_t)c->buf.size() < nbytes ? (int64_t)c->buf.size() : nbytes;
  memcpy(out, c->buf.data(), (size_t)len);
  return len;
}

void dds_disconnect(void* conn) {
  Conn* c = (Conn*)conn;
  close(c->fd);
  delete c;
}

}  // extern "C"
