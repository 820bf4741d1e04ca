// The port's native CSV reader: its own copy of the JAX package's
// fraud_detection_tpu/native/csvloader.cpp, with the same C ABI and the
// same parse, so both packages read a file to the same float32 bits.
//
// mmap the file once, index its rows once, then parse rows to float32 in
// parallel threads straight into a caller-provided (numpy) buffer.
//
// C ABI (bound through ctypes by fraud_detection_tpu_torch/data/native.py):
//   csv_open(path) -> handle (NULL on error)
//   csv_dims_h(h, &rows, &cols)        -> 0 ok; rows exclude header + blanks
//   csv_header_h(h, buf, buflen)       -> header line copied into buf
//   csv_read_h(h, out, rows, cols, nt) -> 0 ok; out is row-major float32
//   csv_close(h)
//
// Error codes: -1 io/open, -2 shape mismatch, -3 parse error.
//
// Built by data/native.py at first use:
//   g++ -O3 -std=c++17 -fPIC -pthread -shared

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
  const char *data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char *path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) return false;
    size = static_cast<size_t>(st.st_size);
    void *p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    data = static_cast<const char *>(p);
    // The scan is strictly sequential per thread chunk.
    madvise(p, size, MADV_SEQUENTIAL);
    return true;
  }

  ~Mapped() {
    if (data) munmap(const_cast<char *>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// One mapped file + its row index, built once at csv_open.
struct Handle {
  Mapped m;
  std::vector<size_t> starts;  // row start offsets
  std::vector<size_t> ends;    // row end offsets (exclusive; '\r' stripped)
  size_t hdr_end = 0;          // one past the header line
  size_t cols = 0;
};

// End offset (one past) of the header line.
size_t header_end(const Mapped &m) {
  const char *nl = static_cast<const char *>(memchr(m.data, '\n', m.size));
  return nl ? static_cast<size_t>(nl - m.data) + 1 : m.size;
}

size_t count_cols(const Mapped &m, size_t hdr_end) {
  size_t cols = 1;
  for (size_t i = 0; i < hdr_end; ++i)
    if (m.data[i] == ',') ++cols;
  return cols;
}

// Index data rows after the header: [start, end) per row with trailing '\r'
// stripped; blank lines (empty or CR-only — e.g. a trailing "\n\n" at EOF)
// are skipped rather than surfaced as unparseable rows. A missing final
// newline counts the last partial line as a row.
void index_rows(const Mapped &m, size_t hdr_end, std::vector<size_t> &starts,
                std::vector<size_t> &ends) {
  size_t pos = hdr_end;
  while (pos < m.size) {
    const char *nl = static_cast<const char *>(
        memchr(m.data + pos, '\n', m.size - pos));
    size_t end = nl ? static_cast<size_t>(nl - m.data) : m.size;
    size_t next = nl ? end + 1 : m.size;
    if (end > pos && m.data[end - 1] == '\r') --end;
    if (end > pos) {
      starts.push_back(pos);
      ends.push_back(end);
    }
    pos = next;
  }
}

Handle *open_handle(const char *path) {
  Handle *h = new Handle();
  if (!h->m.open_file(path)) {
    delete h;
    return nullptr;
  }
  h->hdr_end = header_end(h->m);
  h->cols = count_cols(h->m, h->hdr_end);
  index_rows(h->m, h->hdr_end, h->starts, h->ends);
  return h;
}

// Powers of ten for the fast float path (double keeps f32 round-trips exact).
const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Fast decimal float parse: sign, up-to-18-digit mantissa accumulated as
// int64, optional fraction and e±dd exponent. Bails to the slow path
// (locale-safe strtof; handles inf/nan/hex/overlong) by returning false with
// *end untouched — ~4× faster than strtof on typical CSV numerics.
inline bool fast_float(const char *p, const char *limit, float *out,
                       const char **end) {
  const char *s = p;
  bool neg = false;
  if (s < limit && (*s == '-' || *s == '+')) neg = (*s++ == '-');
  long long mant = 0;
  int digits = 0, frac_digits = 0;
  while (s < limit && *s >= '0' && *s <= '9') {
    if (digits >= 18) return false;  // reject BEFORE the accumulate: 19
    ++digits;                        // digits would overflow int64 (UB)
    mant = mant * 10 + (*s++ - '0');
  }
  if (s < limit && *s == '.') {
    ++s;
    while (s < limit && *s >= '0' && *s <= '9') {
      if (digits >= 18) return false;
      ++digits;
      mant = mant * 10 + (*s++ - '0');
      ++frac_digits;
    }
  }
  if (digits == 0) return false;  // "", ".", "nan", "inf" → slow path
  int exp10 = -frac_digits;
  if (s < limit && (*s == 'e' || *s == 'E')) {
    const char *es = s + 1;
    bool eneg = false;
    if (es < limit && (*es == '-' || *es == '+')) eneg = (*es++ == '-');
    int ev = 0, ed = 0;
    while (es < limit && *es >= '0' && *es <= '9') {
      ev = ev * 10 + (*es++ - '0');
      if (++ed > 3) return false;
    }
    if (ed == 0) return false;
    exp10 += eneg ? -ev : ev;
    s = es;
  }
  if (exp10 < -22 || exp10 > 22) return false;  // outside exact pow10 table
  double v = static_cast<double>(mant);
  v = exp10 >= 0 ? v * kPow10[exp10] : v / kPow10[-exp10];
  *out = static_cast<float>(neg ? -v : v);
  *end = s;
  return true;
}

// Slow-path parse of one field via strtof. The mmap'd buffer is neither
// NUL-terminated nor row-scoped, so the field (bounded by the next comma or
// the row end) is copied into a NUL-terminated stack buffer first — strtof
// can never read past the row, let alone past the mapping.
inline bool slow_field(const char *p, const char *row_end, float *out,
                       const char **end) {
  size_t len = static_cast<size_t>(row_end - p);
  const char *comma = static_cast<const char *>(memchr(p, ',', len));
  size_t flen = comma ? static_cast<size_t>(comma - p) : len;
  char buf[96];
  if (flen == 0 || flen >= sizeof(buf)) return false;
  memcpy(buf, p, flen);
  buf[flen] = '\0';
  char *send = nullptr;
  float v = strtof(buf, &send);
  if (send == buf) return false;  // empty/garbage field
  if (*send != '\0') return false;  // trailing junk within the field
  *out = v;
  *end = p + flen;
  return true;
}

// Parse one data row (cols comma-separated floats) spanning [p, row_end).
// Returns false on malformed input, including ragged rows with missing or
// extra trailing fields (the row must end exactly at row_end).
bool parse_row(const char *p, const char *row_end, long cols, float *out) {
  for (long c = 0; c < cols; ++c) {
    const char *end = nullptr;
    if (!fast_float(p, row_end, &out[c], &end) &&
        !slow_field(p, row_end, &out[c], &end))
      return false;
    p = end;
    if (c + 1 < cols) {
      if (p >= row_end || *p != ',') return false;
      ++p;
    }
  }
  return p == row_end;
}

int read_rows(const Handle *h, float *out, long rows, long cols,
              int n_threads) {
  if (static_cast<long>(h->starts.size()) != rows ||
      static_cast<long>(h->cols) != cols)
    return -2;
  if (rows == 0) return 0;  // header-only file: nothing to parse

  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (static_cast<long>(n_threads) > rows) n_threads = static_cast<int>(rows);

  std::vector<int> status(static_cast<size_t>(n_threads), 0);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(n_threads));
  long chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long lo = static_cast<long>(t) * chunk;
    long hi = lo + chunk < rows ? lo + chunk : rows;
    pool.emplace_back([&, t, lo, hi]() {
      for (long r = lo; r < hi; ++r) {
        size_t i = static_cast<size_t>(r);
        if (!parse_row(h->m.data + h->starts[i], h->m.data + h->ends[i], cols,
                       out + r * cols)) {
          status[static_cast<size_t>(t)] = -3;
          return;
        }
      }
    });
  }
  for (auto &th : pool) th.join();
  for (int s : status)
    if (s != 0) return s;
  return 0;
}

int copy_header(const Handle *h, char *buf, long buflen) {
  size_t n = h->hdr_end;
  while (n > 0 &&
         (h->m.data[n - 1] == '\n' || h->m.data[n - 1] == '\r'))
    --n;
  if (static_cast<long>(n) + 1 > buflen) return -2;
  memcpy(buf, h->m.data, n);
  buf[n] = '\0';
  return 0;
}

}  // namespace

extern "C" {

void *csv_open(const char *path) { return open_handle(path); }

void csv_close(void *h) { delete static_cast<Handle *>(h); }

int csv_dims_h(void *vh, long *rows, long *cols) {
  const Handle *h = static_cast<const Handle *>(vh);
  *rows = static_cast<long>(h->starts.size());
  *cols = static_cast<long>(h->cols);
  return 0;
}

int csv_header_h(void *vh, char *buf, long buflen) {
  return copy_header(static_cast<const Handle *>(vh), buf, buflen);
}

int csv_read_h(void *vh, float *out, long rows, long cols, int n_threads) {
  return read_rows(static_cast<const Handle *>(vh), out, rows, cols,
                   n_threads);
}

}  // extern "C"
