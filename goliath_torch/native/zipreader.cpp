// Native zip reading core for the data loader.
//
// The reference loader (reference ca_code/utils/dataloader.py:252-298) opens
// a zipfile.ZipFile per asset read: the central directory is re-parsed for
// every image and the inflate runs under the Python GIL. Capture zips hold
// tens of thousands of entries and several GB, so that costs both CPU and
// loader-thread parallelism. This core parses the central directory ONCE per
// zip (ZIP64 aware), then serves entry reads with pread + raw zlib inflate —
// fully GIL-free through ctypes — plus a std::thread batch read for
// prefetching a whole training batch of assets at once.
//
// C API (ctypes-friendly):
//   int64  gz_open(const char* path)              -> handle (<0 on error)
//   void   gz_close(int64 h)
//   int64  gz_num_entries(int64 h)
//   const char* gz_entry_name(int64 h, int64 i)   -> NULL if out of range
//   int64  gz_entry_size(int64 h, const char* n)  -> uncompressed size, -1
//   int64  gz_read(int64 h, const char* n, uint8_t* out, int64 cap)
//          -> bytes written, -1 missing, -2 corrupt/unsupported
//   int64  gz_read_many(const int64* hs, const char** names, uint8_t** outs,
//                       const int64* caps, int64* sizes, int64 count,
//                       int64 nthreads)           -> 0 ok, -1 any failed
//
// Build: g++ -O3 -shared -fPIC -std=c++17 zipreader.cpp -o libzipio.so -lz
// (goliath_torch/native/zipio.py runs it at first use, into build/zipio/)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>
#include <zlib.h>

namespace {

struct Entry {
  uint64_t header_off;   // local file header offset
  uint64_t comp_size;
  uint64_t uncomp_size;
  uint16_t method;       // 0 = stored, 8 = deflate
  // resolved lazily on first read (local header has variable extra field)
  std::atomic<uint64_t> data_off{UINT64_MAX};
  Entry() = default;
  Entry(const Entry& o)
      : header_off(o.header_off), comp_size(o.comp_size),
        uncomp_size(o.uncomp_size), method(o.method),
        data_off(o.data_off.load()) {}
};

struct ZipFile {
  int fd = -1;
  std::vector<std::string> names;
  std::unordered_map<std::string, Entry> entries;
};

std::mutex g_mu;
std::unordered_map<int64_t, ZipFile*> g_files;
int64_t g_next = 1;

uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

bool pread_all(int fd, void* buf, size_t n, uint64_t off) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = pread(fd, p, n, static_cast<off_t>(off));
    if (r <= 0) return false;
    p += r; off += static_cast<uint64_t>(r); n -= static_cast<size_t>(r);
  }
  return true;
}

constexpr uint32_t kEOCD = 0x06054b50;
constexpr uint32_t kEOCD64Loc = 0x07064b50;
constexpr uint32_t kEOCD64 = 0x06064b50;
constexpr uint32_t kCDirEntry = 0x02014b50;
constexpr uint32_t kLocalHdr = 0x04034b50;

bool parse_central_dir(ZipFile* z, uint64_t file_size) {
  // scan the tail for the EOCD record (comment can pad up to 64 KiB)
  const uint64_t tail = std::min<uint64_t>(file_size, 65536 + 22);
  std::vector<uint8_t> buf(tail);
  if (!pread_all(z->fd, buf.data(), tail, file_size - tail)) return false;
  int64_t eocd = -1;
  for (int64_t i = static_cast<int64_t>(tail) - 22; i >= 0; --i) {
    if (rd32(&buf[i]) == kEOCD) { eocd = i; break; }
  }
  if (eocd < 0) return false;
  uint64_t n_entries = rd16(&buf[eocd + 10]);
  uint64_t cdir_size = rd32(&buf[eocd + 12]);
  uint64_t cdir_off = rd32(&buf[eocd + 16]);

  // ZIP64: locator sits directly before the EOCD
  const uint64_t eocd_abs = file_size - tail + static_cast<uint64_t>(eocd);
  if ((n_entries == 0xFFFF || cdir_off == 0xFFFFFFFFu ||
       cdir_size == 0xFFFFFFFFu) && eocd_abs >= 20) {
    uint8_t loc[20];
    if (!pread_all(z->fd, loc, 20, eocd_abs - 20)) return false;
    if (rd32(loc) == kEOCD64Loc) {
      uint64_t e64 = rd64(loc + 8);
      uint8_t h[56];
      if (!pread_all(z->fd, h, 56, e64) || rd32(h) != kEOCD64) return false;
      n_entries = rd64(h + 32);
      cdir_size = rd64(h + 40);
      cdir_off = rd64(h + 48);
    }
  }

  std::vector<uint8_t> cd(cdir_size);
  if (!pread_all(z->fd, cd.data(), cdir_size, cdir_off)) return false;
  z->names.reserve(n_entries);
  z->entries.reserve(n_entries);
  uint64_t p = 0;
  for (uint64_t i = 0; i < n_entries; ++i) {
    if (p + 46 > cdir_size || rd32(&cd[p]) != kCDirEntry) return false;
    Entry e;
    e.method = rd16(&cd[p + 10]);
    e.comp_size = rd32(&cd[p + 20]);
    e.uncomp_size = rd32(&cd[p + 24]);
    const uint16_t name_len = rd16(&cd[p + 28]);
    const uint16_t extra_len = rd16(&cd[p + 30]);
    const uint16_t comment_len = rd16(&cd[p + 32]);
    e.header_off = rd32(&cd[p + 42]);
    if (p + 46 + name_len + extra_len > cdir_size) return false;
    std::string name(reinterpret_cast<const char*>(&cd[p + 46]), name_len);
    // ZIP64 extended info overrides any 0xFFFFFFFF field, in order
    uint64_t q = p + 46 + name_len;
    const uint64_t q_end = q + extra_len;
    while (q + 4 <= q_end) {
      const uint16_t id = rd16(&cd[q]);
      const uint16_t sz = rd16(&cd[q + 2]);
      if (id == 0x0001) {
        uint64_t r = q + 4;
        if (e.uncomp_size == 0xFFFFFFFFu && r + 8 <= q + 4 + sz) {
          e.uncomp_size = rd64(&cd[r]); r += 8;
        }
        if (e.comp_size == 0xFFFFFFFFu && r + 8 <= q + 4 + sz) {
          e.comp_size = rd64(&cd[r]); r += 8;
        }
        if (e.header_off == 0xFFFFFFFFu && r + 8 <= q + 4 + sz) {
          e.header_off = rd64(&cd[r]); r += 8;
        }
      }
      q += 4 + sz;
    }
    z->names.push_back(name);
    z->entries.emplace(std::move(name), e);
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

int64_t read_entry(ZipFile* z, const char* name, uint8_t* out, int64_t cap) {
  auto it = z->entries.find(name);
  if (it == z->entries.end()) return -1;
  Entry& e = it->second;
  if (static_cast<uint64_t>(cap) < e.uncomp_size) return -2;

  uint64_t data_off = e.data_off.load(std::memory_order_acquire);
  if (data_off == UINT64_MAX) {
    uint8_t h[30];
    if (!pread_all(z->fd, h, 30, e.header_off) || rd32(h) != kLocalHdr)
      return -2;
    data_off = e.header_off + 30 + rd16(h + 26) + rd16(h + 28);
    e.data_off.store(data_off, std::memory_order_release);
  }

  if (e.method == 0) {  // stored
    if (!pread_all(z->fd, out, e.uncomp_size, data_off)) return -2;
    return static_cast<int64_t>(e.uncomp_size);
  }
  if (e.method != 8) return -2;  // only deflate supported

  std::vector<uint8_t> comp(e.comp_size);
  if (!pread_all(z->fd, comp.data(), e.comp_size, data_off)) return -2;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return -2;  // raw deflate
  zs.next_in = comp.data();
  zs.avail_in = static_cast<uInt>(e.comp_size);
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(e.uncomp_size);
  const int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return -2;
  return static_cast<int64_t>(e.uncomp_size);
}

ZipFile* lookup(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_files.find(h);
  return it == g_files.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t gz_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  off_t size = lseek(fd, 0, SEEK_END);
  if (size <= 0) { close(fd); return -1; }
  auto* z = new ZipFile();
  z->fd = fd;
  if (!parse_central_dir(z, static_cast<uint64_t>(size))) {
    close(fd);
    delete z;
    return -2;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  const int64_t h = g_next++;
  g_files[h] = z;
  return h;
}

void gz_close(int64_t h) {
  ZipFile* z = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_files.find(h);
    if (it == g_files.end()) return;
    z = it->second;
    g_files.erase(it);
  }
  close(z->fd);
  delete z;
}

int64_t gz_num_entries(int64_t h) {
  ZipFile* z = lookup(h);
  return z ? static_cast<int64_t>(z->names.size()) : -1;
}

const char* gz_entry_name(int64_t h, int64_t i) {
  ZipFile* z = lookup(h);
  if (!z || i < 0 || static_cast<size_t>(i) >= z->names.size())
    return nullptr;
  return z->names[static_cast<size_t>(i)].c_str();
}

int64_t gz_entry_size(int64_t h, const char* name) {
  ZipFile* z = lookup(h);
  if (!z) return -1;
  auto it = z->entries.find(name);
  return it == z->entries.end() ? -1
                                : static_cast<int64_t>(it->second.uncomp_size);
}

int64_t gz_read(int64_t h, const char* name, uint8_t* out, int64_t cap) {
  ZipFile* z = lookup(h);
  if (!z) return -1;
  return read_entry(z, name, out, cap);
}

int64_t gz_read_many(const int64_t* hs, const char** names, uint8_t** outs,
                     const int64_t* caps, int64_t* sizes, int64_t count,
                     int64_t nthreads) {
  if (count <= 0) return 0;
  if (nthreads <= 0) nthreads = 1;
  nthreads = std::min<int64_t>(nthreads, count);
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= count) return;
      ZipFile* z = lookup(hs[i]);
      const int64_t r = z ? read_entry(z, names[i], outs[i], caps[i]) : -1;
      sizes[i] = r;
      if (r < 0) failed.store(true);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(nthreads));
  for (int64_t t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load() ? -1 : 0;
}

}  // extern "C"
