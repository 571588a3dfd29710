// stream_test.cpp — differential test: stream_deflate.cpp's clone fed in
// random segments (fd_stream_*) vs the system zlib at the exact parameters
// the PNG encoder uses (deflateInit2(9, Z_DEFLATED, 15, 9, Z_FILTERED);
// rwpng.c:471-472), on the generators of native/fd_test.cpp. The
// segments' ends fall anywhere, inside byte runs, and closer together than
// MIN_LOOKAHEAD; the stream sorts its hash buckets per feed (so walks
// cross many segments) or in stretches of 32 KiB.
// Exit 0 iff every case produces byte-identical output.
//
// Usage: stream_test [seed] [file...]
//   With file args, also checks each file's raw bytes.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <string>
#include <zlib.h>

extern "C" void* fd_stream_begin(size_t n, size_t seg_min);
extern "C" uint8_t* fd_stream_input(void* s);
extern "C" int fd_stream_feed(void* s, size_t fed);
extern "C" int fd_stream_end(void* s, uint8_t** out_data, size_t* out_len);

static std::vector<uint8_t> zlib_ref(const uint8_t* in, size_t n,
                                     size_t chunk) {
  z_stream zs{};
  if (deflateInit2(&zs, 9, Z_DEFLATED, 15, 9, Z_FILTERED) != Z_OK) abort();
  std::vector<uint8_t> out;
  std::vector<uint8_t> buf(1 << 16);
  size_t pos = 0;
  do {
    size_t k = n - pos < chunk ? n - pos : chunk;
    zs.next_in = const_cast<uint8_t*>(in + pos);
    zs.avail_in = (uInt)k;
    pos += k;
    int flush = pos == n ? Z_FINISH : Z_NO_FLUSH;
    do {
      zs.next_out = buf.data();
      zs.avail_out = (uInt)buf.size();
      deflate(&zs, flush);
      out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
    } while (zs.avail_out == 0);
  } while (pos < n);
  deflateEnd(&zs);
  return out;
}

static uint64_t rng_state;
static uint32_t rnd() {
  rng_state = rng_state * 6364136223846793005ULL + 1442695040888963407ULL;
  return (uint32_t)(rng_state >> 33);
}

// generators spanning the regimes that exercise distinct deflate machinery
static const int N_KINDS = 9;
static std::vector<uint8_t> gen(int kind, size_t n) {
  std::vector<uint8_t> v(n);
  switch (kind % N_KINDS) {
    case 8: {  // matches planted at distances straddling MAX_DIST (32506):
               // exercises the unconditional first candidate + limit cutoff
      for (auto& b : v) b = (uint8_t)(rnd() % 4 ? 0 : rnd());
      for (size_t i = 33000; i + 8 < n; i += 1 + rnd() % 700) {
        size_t back = 32498 + rnd() % 20;
        size_t len = 3 + rnd() % 12;
        if (len > n - i) len = n - i;
        for (size_t k = 0; k < len; k++) v[i + k] = v[i - back + k];
        i += len;
      }
      break;
    }
    case 0:  // pure random: incompressible, stored-block decision
      for (auto& b : v) b = (uint8_t)rnd();
      break;
    case 1:  // all one byte: max-length matches, window slides
      memset(v.data(), (int)(rnd() & 255), n);
      break;
    case 2: {  // short periodic: small distances, lazy matching
      size_t period = 1 + rnd() % 17;
      for (size_t i = 0; i < n; i++)
        v[i] = (uint8_t)((i % period) * 37 + (rnd() % 4 == 0 ? rnd() % 3 : 0));
      break;
    }
    case 3: {  // lossy-scanline-like: long runs + small residual noise
      uint8_t cur = (uint8_t)rnd();
      for (size_t i = 0; i < n; i++) {
        if (rnd() % 23 == 0) cur = (uint8_t)(cur + (int)(rnd() % 7) - 3);
        v[i] = cur;
      }
      break;
    }
    case 4: {  // text-like: small alphabet, variable-length words
      static const char* words[] = {"the", "quick", "brown", "fox", " ",
                                    "jumps", "over", "lazy", "dog", "\n"};
      size_t i = 0;
      while (i < n) {
        const char* w = words[rnd() % 10];
        size_t l = strlen(w);
        if (l > n - i) l = n - i;
        memcpy(v.data() + i, w, l);
        i += l;
      }
      break;
    }
    case 5: {  // long-distance repeats: blocks re-pasted at >256 distances
      size_t i = 0;
      while (i < n) {
        if (i > 4096 && rnd() % 3) {
          size_t back = 257 + rnd() % 30000;
          if (back > i) back = i;
          size_t len = 4 + rnd() % 300;
          if (len > n - i) len = n - i;
          for (size_t k = 0; k < len; k++) v[i + k] = v[i - back + k];
          i += len;
        } else {
          v[i++] = (uint8_t)rnd();
        }
      }
      break;
    }
    case 6: {  // mixed compressible / incompressible segments (per-block
               // stored-vs-huffman decisions)
      size_t i = 0;
      while (i < n) {
        size_t len = 1000 + rnd() % 60000;
        if (len > n - i) len = n - i;
        if (rnd() & 1)
          for (size_t k = 0; k < len; k++) v[i + k] = (uint8_t)rnd();
        else
          memset(v.data() + i, (int)(rnd() & 255), len);
        i += len;
      }
      break;
    }
    default: {  // match-length boundary stress: runs of ~258
      size_t i = 0;
      while (i < n) {
        size_t len = 250 + rnd() % 20;
        if (len > n - i) len = n - i;
        memset(v.data() + i, (int)(rnd() & 255), len);
        i += len;
      }
      break;
    }
  }
  return v;
}

// the next end of a segment past `at`: anywhere up to 64 KiB on, within
// MIN_LOOKAHEAD (262), or at the next byte that repeats the one before it
// (inside a run), in turn
static size_t next_cut(const std::vector<uint8_t>& data, size_t at) {
  size_t n = data.size();
  size_t step;
  switch (rnd() % 3) {
    case 0: step = 1 + rnd() % 65536; break;
    case 1: step = 1 + rnd() % 300; break;
    default: {
      size_t p = at + 1 + rnd() % 4096;
      while (p < n && data[p] != data[p - 1]) p++;
      step = p - at;
    }
  }
  return step > n - at ? n : at + step;
}

// the clone as a stream over random segments; 0 with its output in *out
static int stream_deflate(const std::vector<uint8_t>& data,
                          std::vector<uint8_t>* out, size_t* segs) {
  size_t seg_min = rnd() % 2 ? 1 : 32768;
  void* s = fd_stream_begin(data.size(), seg_min);
  if (!s) return -1;
  uint8_t* input = fd_stream_input(s);
  size_t at = 0;
  *segs = 0;
  while (at < data.size()) {
    size_t to = next_cut(data, at);
    memcpy(input + at, data.data() + at, to - at);
    if (fd_stream_feed(s, to) != 0) return -1;
    at = to;
    ++*segs;
  }
  uint8_t* buf = nullptr;
  size_t len = 0;
  if (fd_stream_end(s, &buf, &len) != 0) return -1;
  out->assign(buf, buf + len);
  free(buf);
  return 0;
}

static int differs(const uint8_t* got, size_t got_len,
                   const std::vector<uint8_t>& ref, const char* what,
                   const char* how) {
  if (got_len != ref.size()) {
    printf("FAIL %s (%s): size %zu vs zlib %zu\n", what, how, got_len,
           ref.size());
    return 1;
  }
  if (memcmp(got, ref.data(), got_len) != 0) {
    size_t i = 0;
    while (i < got_len && got[i] == ref[i]) i++;
    printf("FAIL %s (%s): first byte diff at %zu/%zu (%02x vs %02x)\n", what,
           how, i, got_len, got[i], ref[i]);
    return 1;
  }
  return 0;
}

static int check(const std::vector<uint8_t>& data, const char* what) {
  size_t chunk = data.size() + 1;
  if (rnd() % 3 == 0) chunk = 1 + rnd() % 5000;  // exercise streamed feeding
  std::vector<uint8_t> ref = zlib_ref(data.data(), data.size(), chunk);
  std::vector<uint8_t> streamed;
  size_t segs = 0;
  if (stream_deflate(data, &streamed, &segs) != 0) {
    printf("FAIL %s: the stream returned an error\n", what);
    return 1;
  }
  char how[48];
  snprintf(how, sizeof how, "stream of %zu segments", segs);
  return differs(streamed.data(), streamed.size(), ref, what, how);
}

int main(int argc, char** argv) {
  rng_state = argc > 1 ? strtoull(argv[1], nullptr, 10) : 12345;
  int fails = 0, cases = 0;

  static const size_t sizes[] = {0, 1, 2, 3, 4, 5, 17, 100, 261, 262,
                                 1000, 16384, 32768, 32769, 65536,
                                 98301 - 5, 98301 + 5, 200000, 1 << 20};
  char label[64];
  for (size_t s : sizes) {
    for (int kind = 0; kind < N_KINDS; kind++) {
      snprintf(label, sizeof label, "size=%zu kind=%d", s, kind);
      fails += check(gen(kind, s), label);
      cases++;
    }
  }
  // randomized sizes, incl. >2*W_SIZE to cross window slides repeatedly
  for (int i = 0; i < 40; i++) {
    size_t s = rnd() % (1u << (10 + rnd() % 11));
    int kind = (int)(rnd() % N_KINDS);
    snprintf(label, sizeof label, "rand size=%zu kind=%d", s, kind);
    fails += check(gen(kind, s), label);
    cases++;
  }
  for (int a = 2; a < argc; a++) {
    FILE* f = fopen(argv[a], "rb");
    if (!f) continue;
    fseek(f, 0, SEEK_END);
    long fl = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> data((size_t)fl);
    if (fread(data.data(), 1, data.size(), f) != data.size()) {
      fclose(f);
      continue;
    }
    fclose(f);
    fails += check(data, argv[a]);
    cases++;
  }
  printf("%s: %d/%d cases byte-identical\n", fails ? "FAIL" : "OK",
         cases - fails, cases);
  return fails ? 1 : 0;
}
