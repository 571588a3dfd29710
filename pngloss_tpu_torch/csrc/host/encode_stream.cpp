// encode_stream.cpp — the PNG of the optimizer's working plane (bpp 1 gray,
// 2 gray+alpha, 3 RGB, 4 RGBA), encoded band by band as its rows arrive:
// each band is filtered and fed to stream_deflate.cpp's incremental clone
// while the card is still making the rows after it, so that only the last
// band's work is left once the last row lands.
//
// The bytes are native/pngloss_host.cpp's pl_encode's for the plane
// restored to RGBA. The helpers below (chunk blob parsing, filters,
// libpng's MSAD choice for row 0, chunk writing, optimize_cmf) are copies
// of that file's, which the one-shot encode of both packages runs.
// pl_encode re-detects the colour type from the RGBA; the stream takes it
// to be the plane's, which re-detection finds unless the optimizer's
// output collapsed (every pixel gray, or every pixel opaque). The rows
// confirm it as they arrive, and where they do not, pl_encode_stream_end
// returns PL_RETYPED and the caller encodes one-shot. Under that type the
// packed rows are the plane's rows.
//
// Where the clone is not to be used (PNGLOSS_NO_FAST_DEFLATE, or the clone
// differs from the system libz on the canary buffer, as pl_encode checks
// its own), pl_encode_stream_begin returns PL_NO_CLONE and the caller
// encodes one-shot: pl_encode then deflates through the system libz.
//
// Exposed as a C ABI for ctypes.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <new>
#include <string>
#include <vector>

// stream_deflate.cpp: the zlib-9/Z_FILTERED clone over an input that
// arrives in order
extern "C" void* fd_stream_begin(size_t n, size_t seg_min);
extern "C" uint8_t* fd_stream_input(void* s);
extern "C" int fd_stream_feed(void* s, size_t fed);
extern "C" int fd_stream_end(void* s, uint8_t** out_data, size_t* out_len);
extern "C" void fd_stream_free(void* s);

namespace {

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

thread_local std::string g_error;

enum Status {
  PL_OK = 0,
  PL_RETYPED = 3,     // the output takes another colour type than the plane's
  PL_BAD_ARGS = 4,
  PL_NO_CLONE = 5,    // the clone is not to be used: encode one-shot
  PL_PNG_OOM = 24,    // == PNG_OUT_OF_MEMORY_ERROR
  PL_TOO_LARGE = 98,  // == TOO_LARGE_FILE
};

int fail_oom(const std::string& msg) {
  g_error = msg;
  return PL_PNG_OOM;
}

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

// Chunk blob interchange with Python, as pl_encode's:
//   repeated records of [u32le data_len][4 bytes name][u8 location][data]
struct KeptChunk {
  char name[4];
  uint8_t location;  // 1 = before PLTE, 2 = after PLTE, 8 = after IDAT
  std::vector<uint8_t> data;
};

bool parse_chunks(const uint8_t* blob, size_t len, std::vector<KeptChunk>* out) {
  size_t pos = 0;
  while (pos < len) {
    if (pos + 9 > len) return false;
    uint32_t n = uint32_t(blob[pos]) | (uint32_t(blob[pos + 1]) << 8) |
                 (uint32_t(blob[pos + 2]) << 16) | (uint32_t(blob[pos + 3]) << 24);
    if (pos + 9 + n > len) return false;
    KeptChunk c;
    std::memcpy(c.name, blob + pos + 4, 4);
    c.location = blob[pos + 8];
    c.data.assign(blob + pos + 9, blob + pos + 9 + n);
    out->push_back(std::move(c));
    pos += 9 + n;
  }
  return true;
}

void apply_filter_row(const uint8_t* prev, const uint8_t* row, int f, int bpp,
                      size_t rowbytes, uint8_t* out) {
  switch (f) {
    case 0:
      std::memcpy(out, row, rowbytes);
      break;
    case 1:
      for (size_t x = 0; x < rowbytes; x++) {
        int left = x >= size_t(bpp) ? row[x - bpp] : 0;
        out[x] = uint8_t(row[x] - left);
      }
      break;
    case 2:
      for (size_t x = 0; x < rowbytes; x++) {
        int up = prev ? prev[x] : 0;
        out[x] = uint8_t(row[x] - up);
      }
      break;
    case 3:
      for (size_t x = 0; x < rowbytes; x++) {
        int left = x >= size_t(bpp) ? row[x - bpp] : 0;
        int up = prev ? prev[x] : 0;
        out[x] = uint8_t(row[x] - ((left + up) >> 1));
      }
      break;
    default:
      for (size_t x = 0; x < rowbytes; x++) {
        int left = x >= size_t(bpp) ? row[x - bpp] : 0;
        int up = prev ? prev[x] : 0;
        int diag = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
        int p = left + up - diag;
        int pa = std::abs(p - left), pb = std::abs(p - up), pc = std::abs(p - diag);
        int pred = (pa <= pb && pa <= pc) ? left : (pb <= pc ? up : diag);
        out[x] = uint8_t(row[x] - pred);
      }
      break;
  }
}

int msad_choice(const uint8_t* prev, const uint8_t* row, int bpp,
                size_t rowbytes, uint8_t* scratch, bool single_row_image) {
  // libpng candidate restrictions (verified empirically): SINGLE-ROW
  // images try only NONE and SUB (AVG is excluded even when its sum
  // wins); row 0 of taller images uses all five with a zeroed previous
  // row; single-pixel rows never produce SUB/AVG/PAETH
  const int all[5] = {0, 1, 2, 3, 4};
  const int h1_row[2] = {0, 1};
  const int h1_single[1] = {0};
  const int single_pixel[2] = {0, 2};
  bool single = rowbytes <= size_t(bpp);
  const int* cand = all;
  int ncand = 5;
  if (single_row_image) {
    cand = single ? h1_single : h1_row;
    ncand = single ? 1 : 2;
  } else if (single) {
    cand = single_pixel;
    ncand = 2;
  }
  int best = 0;
  uint64_t best_sum = ~0ULL;
  for (int i = 0; i < ncand; i++) {
    int f = cand[i];
    apply_filter_row(prev, row, f, bpp, rowbytes, scratch);
    uint64_t s = 0;
    for (size_t x = 0; x < rowbytes; x++) {
      uint8_t v = scratch[x];
      s += v < 128 ? v : 256 - v;
    }
    if (s < best_sum) {
      best = f;
      best_sum = s;
    }
  }
  return best;
}

// A row's filter byte and filtered bytes into line: libpng's MSAD choice
// for row 0, else the forced filter f (rwpng.c:488-495). prev is the row
// above, nullptr for row 0.
void filter_line(const uint8_t* prev, const uint8_t* row, int f,
                 bool single_row_image, int bpp, size_t rowbytes,
                 uint8_t* scratch, uint8_t* line) {
  if (prev == nullptr) {
    f = msad_choice(prev, row, bpp, rowbytes, scratch, single_row_image);
  } else if (rowbytes <= size_t(bpp) && (f == 1 || f == 3 || f == 4)) {
    f = 0;  // libpng ignores forced SUB/AVG/PAETH on single-pixel rows
  }
  line[0] = uint8_t(f);
  apply_filter_row(prev, row, f, bpp, rowbytes, line + 1);
}

void put_chunk(std::vector<uint8_t>& out, const char* name,
               const uint8_t* body, size_t n) {
  put_be32(out, uint32_t(n));
  size_t name_pos = out.size();
  out.insert(out.end(), name, name + 4);
  out.insert(out.end(), body, body + n);
  uint32_t crc = crc32(0, out.data() + name_pos, uInt(4 + n));
  put_be32(out, crc);
}

// The signature and every chunk before the image data.
void write_head(std::vector<uint8_t>& out, uint32_t w, uint32_t h,
                int color_type, double gamma, int transform,
                const std::vector<KeptChunk>& chunks) {
  out.insert(out.end(), kSig, kSig + 8);
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8); ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8); ihdr[7] = uint8_t(h);
  ihdr[8] = 8;
  ihdr[9] = uint8_t(color_type);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  // gamma/sRGB chunks (rwpng_set_gamma, rwpng.c:505-513): only non-default
  // transforms emit gAMA; sRGB additionally emits the sRGB chunk
  if (transform != 0 && transform != 2) {
    uint32_t g = uint32_t(gamma * 100000.0 + 0.5);
    uint8_t body[4] = {uint8_t(g >> 24), uint8_t(g >> 16), uint8_t(g >> 8), uint8_t(g)};
    put_chunk(out, "gAMA", body, 4);
  }
  if (transform == 1) {
    uint8_t z = 0;
    put_chunk(out, "sRGB", &z, 1);
  }
  for (const auto& c : chunks)
    if (c.location != 2 && c.location != 8)
      put_chunk(out, c.name, c.data.data(), c.data.size());
  // location-2 chunks at png_write_info's later write point — after the
  // whole location-1 group, reversed read order preserved within groups
  for (const auto& c : chunks)
    if (c.location == 2) put_chunk(out, c.name, c.data.data(), c.data.size());
}

// The zlib stream of data_size filtered bytes as IDAT chunks, then the
// chunks after IDAT and IEND.
void write_tail(std::vector<uint8_t>& out, std::vector<uint8_t>& stream,
                size_t data_size, const std::vector<KeptChunk>& chunks) {
  // libpng's optimize_cmf: claim the smallest deflate window covering the
  // scanline data (pngwutil.c); deflate bytes are unaffected.
  if (data_size <= 16384 && !stream.empty() && (stream[0] & 0x0F) == 8 &&
      (stream[0] & 0xF0) <= 0x70) {
    unsigned z_cinfo = stream[0] >> 4;
    unsigned half = 1u << (z_cinfo + 7);
    if (data_size <= half) {
      do {
        half >>= 1;
        z_cinfo--;
      } while (z_cinfo > 0 && data_size <= half);
      uint8_t cmf = uint8_t((stream[0] & 0x0F) | (z_cinfo << 4));
      stream[0] = cmf;
      unsigned tmp = stream[1] & 0xE0;
      tmp += 0x1F - ((unsigned(cmf) << 8) + tmp) % 0x1F;
      stream[1] = uint8_t(tmp);
    }
  }

  for (size_t i = 0; i < stream.size(); i += 8192) {
    size_t n = stream.size() - i < 8192 ? stream.size() - i : 8192;
    put_chunk(out, "IDAT", stream.data() + i, n);
  }
  for (const auto& c : chunks)
    if (c.location == 8) put_chunk(out, c.name, c.data.data(), c.data.size());
  put_chunk(out, "IEND", nullptr, 0);
}

// Whether the system libz deflates the canary buffer as the clone does,
// fed in three segments whose walks cross into older ones (the canary is
// pl_encode's own: filtered-residual-like noise, zero runs and repeated
// motifs). PNGLOSS_FD_CANARY_FORCE_FAIL makes it fail, as pl_encode's.
bool canary_run() {
  const char* force = std::getenv("PNGLOSS_FD_CANARY_FORCE_FAIL");
  if (force != nullptr && *force != '\0' && std::strcmp(force, "0") != 0)
    return false;
  std::vector<uint8_t> canary;
  canary.reserve(8192);
  uint32_t lcg = 0x12345678u;
  for (int i = 0; i < 2048; i++) {
    lcg = lcg * 1664525u + 1013904223u;
    canary.push_back(uint8_t((lcg >> 13) & 0x1F) - 16);
  }
  canary.insert(canary.end(), 1024, 0);
  for (int rep = 0; rep < 16; rep++)
    canary.insert(canary.end(), canary.begin() + rep * 37,
                  canary.begin() + rep * 37 + 200);
  for (int i = 0; i < 1024; i++) canary.push_back(uint8_t(i * 7));

  z_stream zs{};
  if (deflateInit2(&zs, 9, Z_DEFLATED, 15, 9, Z_FILTERED) != Z_OK)
    return false;
  std::vector<uint8_t> viaz(deflateBound(&zs, uLong(canary.size())));
  zs.next_in = canary.data();
  zs.avail_in = uInt(canary.size());
  zs.next_out = viaz.data();
  zs.avail_out = uInt(viaz.size());
  int ret = deflate(&zs, Z_FINISH);
  viaz.resize(viaz.size() - zs.avail_out);
  deflateEnd(&zs);
  if (ret != Z_STREAM_END) return false;

  void* s = fd_stream_begin(canary.size(), 1);
  if (!s) return false;
  const size_t cuts[3] = {1500, 3100, canary.size()};
  size_t at = 0;
  for (size_t to : cuts) {
    std::memcpy(fd_stream_input(s) + at, canary.data() + at, to - at);
    if (fd_stream_feed(s, to) != 0) {
      fd_stream_free(s);
      return false;
    }
    at = to;
  }
  uint8_t* fd_data = nullptr;
  size_t fd_len = 0;
  if (fd_stream_end(s, &fd_data, &fd_len) != 0) return false;
  bool match = fd_len == viaz.size() &&
               std::memcmp(fd_data, viaz.data(), fd_len) == 0;
  std::free(fd_data);
  return match;
}

// Whether a stream may deflate through the clone: not where
// PNGLOSS_NO_FAST_DEFLATE asks for the system libz, nor where the clone
// fails the canary (run once).
bool clone_active() {
  const char* no_fast = std::getenv("PNGLOSS_NO_FAST_DEFLATE");
  if (no_fast != nullptr && *no_fast != '\0' && std::strcmp(no_fast, "0"))
    return false;
  static const bool ok = canary_run();
  return ok;
}

// A stream's hash buckets wait for this many new positions (one window):
// a band of the plane is longer, so each feed sorts at once.
constexpr size_t kSegment = 32768;

struct EncodeStream {
  uint32_t w = 0, h = 0;
  int bpp = 0;
  double gamma = 0;
  int transform = 0;
  std::vector<KeptChunk> chunks;
  size_t rowbytes = 0;
  uint32_t y = 0;                 // rows taken
  std::vector<uint8_t> prev;      // the last row taken
  std::vector<uint8_t> scratch;   // msad_choice's
  bool color = false;             // a pixel whose channels differ
  bool alpha = false;             // a pixel that is not opaque
  void* fd = nullptr;             // the clone's stream

  ~EncodeStream() {
    if (fd) fd_stream_free(fd);
  }

  // notes what the rows tell of the colour type
  void confirm(const uint8_t* rows, size_t n) {
    const size_t npix = n * w;
    if (bpp == 2) {
      for (size_t i = 0; i < npix && !alpha; i++) alpha = rows[i * 2 + 1] != 255;
    } else if (bpp >= 3) {
      for (size_t i = 0; i < npix && !(color && (alpha || bpp == 3)); i++) {
        const uint8_t* p = rows + i * bpp;
        color = color || p[0] != p[1] || p[1] != p[2];
        if (bpp == 4) alpha = alpha || p[3] != 255;
      }
    }
  }

  bool confirmed() const {
    return bpp == 1 || (bpp == 2 && alpha) || (bpp == 3 && color) ||
           (bpp == 4 && color && alpha);
  }
};

int stream_begin(uint32_t w, uint32_t h, int bpp, double gamma,
                 int transform, const uint8_t* chunks_blob,
                 size_t chunks_len, void** handle) {
  if (w == 0 || h == 0 || bpp < 1 || bpp > 4) {
    g_error = "bad arguments";
    return PL_BAD_ARGS;
  }
  if (!clone_active()) {
    g_error = "the deflate clone is off";
    return PL_NO_CLONE;
  }
  auto st = std::make_unique<EncodeStream>();
  if (chunks_blob && !parse_chunks(chunks_blob, chunks_len, &st->chunks)) {
    g_error = "bad chunk blob";
    return PL_BAD_ARGS;
  }
  st->w = w;
  st->h = h;
  st->bpp = bpp;
  st->gamma = gamma;
  st->transform = transform;
  st->rowbytes = size_t(w) * bpp;
  st->prev.resize(st->rowbytes);
  st->scratch.resize(st->rowbytes);
  st->fd = fd_stream_begin(size_t(h) * (st->rowbytes + 1), kSegment);
  if (!st->fd) return fail_oom("insufficient memory");
  *handle = st.release();
  return PL_OK;
}

int stream_rows(EncodeStream* st, const uint8_t* rows,
                const int8_t* filters, uint32_t n) {
  if (!rows || !filters || n > st->h - st->y) {
    g_error = "bad arguments";
    return PL_BAD_ARGS;
  }
  if (n == 0) return PL_OK;
  const size_t line = st->rowbytes + 1;
  uint8_t* dst = fd_stream_input(st->fd) + size_t(st->y) * line;
  st->confirm(rows, n);
  for (uint32_t i = 0; i < n; i++) {
    const uint32_t y = st->y + i;
    const uint8_t* row = rows + size_t(i) * st->rowbytes;
    const uint8_t* prev = y == 0   ? nullptr
                          : i == 0 ? st->prev.data()
                                   : row - st->rowbytes;
    filter_line(prev, row, filters[i], st->h == 1, st->bpp, st->rowbytes,
                st->scratch.data(), dst + size_t(i) * line);
  }
  std::memcpy(st->prev.data(), rows + size_t(n - 1) * st->rowbytes,
              st->rowbytes);
  st->y += n;
  if (fd_stream_feed(st->fd, size_t(st->y) * line) != 0)
    return fail_oom("insufficient memory");
  return PL_OK;
}

int stream_end(EncodeStream* st, size_t maximum_file_size,
               uint8_t** out_data, size_t* out_len) {
  if (st->y != st->h) {
    g_error = "stream ended before its last row";
    return PL_BAD_ARGS;
  }
  if (!st->confirmed()) {
    g_error = "the output takes another colour type than the plane's";
    return PL_RETYPED;
  }
  uint8_t* zdata = nullptr;
  size_t zlen = 0;
  int rc = fd_stream_end(st->fd, &zdata, &zlen);
  st->fd = nullptr;
  if (rc != 0) return fail_oom("insufficient memory");
  std::vector<uint8_t> stream(zdata, zdata + zlen);
  std::free(zdata);
  static const int kColorType[5] = {0, 0, 4, 2, 6};
  std::vector<uint8_t> out;
  out.reserve(stream.size() + 1024);
  write_head(out, st->w, st->h, kColorType[st->bpp], st->gamma,
             st->transform, st->chunks);
  write_tail(out, stream, size_t(st->h) * (st->rowbytes + 1), st->chunks);
  // the caller's malloc'd copy: PL_OK, or PL_TOO_LARGE past
  // maximum_file_size (the copy is made in both cases, rwpng.c:631-633)
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
  if (!buf) return fail_oom("insufficient memory");
  std::memcpy(buf, out.data(), out.size());
  *out_data = buf;
  *out_len = out.size();
  if (maximum_file_size && out.size() > maximum_file_size) {
    g_error = "output exceeds maximum_file_size";
    return PL_TOO_LARGE;
  }
  return PL_OK;
}

// f() at the C ABI: nothing may escape into ctypes
template <typename F>
int guarded(F f) {
  try {
    return f();
  } catch (const std::bad_alloc&) {
    return fail_oom("insufficient memory");
  } catch (const std::exception& e) {
    g_error = std::string("internal encode error: ") + e.what();
    return PL_BAD_ARGS;
  } catch (...) {
    g_error = "internal encode error";
    return PL_BAD_ARGS;
  }
}

}  // namespace

extern "C" {

const char* pl_stream_last_error() { return g_error.c_str(); }

void pl_stream_free(void* p) { std::free(p); }

// Starts a stream of an h-row image of width w from a working plane of bpp
// bytes a pixel; gamma, transform (0 none, 1 srgb, 2 gama_only) and the
// chunk blob as for pl_encode. *handle goes to pl_encode_stream_rows and to
// pl_encode_stream_end, or to pl_encode_stream_free. PL_NO_CLONE: encode
// one-shot instead.
int pl_encode_stream_begin(uint32_t w, uint32_t h, int bpp, double gamma,
                           int transform, const uint8_t* chunks_blob,
                           size_t chunks_len, void** handle) {
  return guarded([&] {
    return stream_begin(w, h, bpp, gamma, transform, chunks_blob, chunks_len,
                        handle);
  });
}

// The next n rows of the plane, n * w * bpp bytes, and their forced
// filters (row 0's is not read: it takes the MSAD choice).
int pl_encode_stream_rows(void* handle, const uint8_t* rows,
                          const int8_t* filters, uint32_t n) {
  return guarded([&] {
    return stream_rows(static_cast<EncodeStream*>(handle), rows, filters, n);
  });
}

// Ends the stream once every row is in and frees it: as pl_encode, PL_OK or
// PL_TOO_LARGE with the PNG in *out_data (for pl_stream_free), or
// PL_RETYPED where the output takes another colour type than the plane's
// (nothing in *out_data).
int pl_encode_stream_end(void* handle, size_t maximum_file_size,
                         uint8_t** out_data, size_t* out_len) {
  std::unique_ptr<EncodeStream> st(static_cast<EncodeStream*>(handle));
  return guarded([&] {
    return stream_end(st.get(), maximum_file_size, out_data, out_len);
  });
}

// Frees a stream that will not be ended.
void pl_encode_stream_free(void* handle) {
  delete static_cast<EncodeStream*>(handle);
}

}  // extern "C"
