// Native hot-path parsers for dmlc_core_tpu.
//
// The reference keeps its byte-level machinery in C++ (src/data/*.h,
// src/data/strtonum.h); this library is the TPU-native rebuild's equivalent:
// multi-threaded chunk -> CSR parsing for libsvm/libfm and chunk -> dense for
// csv, exposed through a plain C ABI consumed via ctypes (no pybind11 in the
// image). Number parsing uses a fast-path u64-mantissa decimal scan with a
// std::from_chars (C++17) fallback for exotic tokens; the combination beats
// the reference's hand-rolled strtof (src/data/strtonum.h:37-101).
//
// Threading model mirrors the reference's OpenMP chunk split
// (src/data/text_parser.h:89-118): the chunk is cut into nthread sub-ranges
// realigned at newlines; each worker parses into private vectors; the results
// are stitched in order.

#include <atomic>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if !(defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L)
#include <clocale>   // newlocale/locale_t for the strtof fallback
#if defined(__APPLE__)
#include <xlocale.h>  // strtof_l lives here on Darwin
#endif
#endif

namespace {

struct Shard {
  std::vector<int64_t> row_nnz;
  std::vector<float> label;
  std::vector<float> weight;      // empty unless any weight seen
  std::vector<uint32_t> index;
  std::vector<uint32_t> field;    // libfm only
  std::vector<float> value;       // may stay empty for implicit 1.0 (libsvm)
  bool any_weight = false;
  bool any_value = false;
  bool error = false;
  std::string error_msg;
};

struct CsvShard;  // fwd

// Parse results stay in the per-thread shards; fill() gathers straight
// from them into the caller's numpy buffers.  (They were previously
// merged into one set of vectors first — a full extra pass over
// data-sized arrays that bought nothing, since fill() copies again.)
struct Result {
  std::vector<Shard> shards;
  std::vector<CsvShard> csv_shards;
  int64_t total_rows = 0;
  int64_t total_nnz = 0;
  int64_t n_cols = 0;  // csv
  bool is_dense = false;
  bool has_weight = false;
  bool has_value = false;
  bool has_field = false;
  std::string error_msg;
};

inline bool is_ws(char c) { return c == ' ' || c == '\t' || c == '\r'; }

inline const char* skip_ws(const char* p, const char* end) {
  while (p != end && is_ws(*p)) ++p;
  return p;
}

// between-rows variant: newlines (and blank lines) are inter-row space
inline const char* skip_ws_nl(const char* p, const char* end) {
  while (p != end && (is_ws(*p) || *p == '\n')) ++p;
  return p;
}

#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
inline bool parse_float_slow(const char*& p, const char* end, float* out) {
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc()) return false;
  p = res.ptr;
  return true;
}
#else
// libstdc++ < 11 ships integer-only from_chars: emulate the float overload
// with strtof over a NUL-terminated copy of the token.  Semantics kept
// from_chars-shaped: no leading whitespace or '+', no hex floats (the
// copy stops at 'x'/'X', so "0x1p3" parses as 0 with p left on the 'x' —
// exactly what from_chars does), overflow fails (subnormals pass — glibc
// flags them ERANGE but they are representable).  The copy is unbounded
// via a heap fallback, so an over-long token can never be silently
// parsed as a truncated prefix.  strtof runs under a pinned "C" numeric
// locale: an embedder's setlocale(LC_NUMERIC, ...) must not fork parsing
// (a de_DE radix would stop "1.5" at the '.').
inline bool parse_float_slow(const char*& p, const char* end, float* out) {
  if (p == end || *p == '+' || is_ws(*p) || *p == '\n') return false;
  char buf[256];
  std::string big;                 // only touched for tokens >= 255 chars
  size_t n = 0;
  const char* q = p;
  for (; q != end; ++q) {
    char c = *q;
    bool tokenish = (c >= '0' && c <= '9') || c == '.' || c == '-' ||
                    c == '+' || (c >= 'a' && c <= 'z') ||
                    (c >= 'A' && c <= 'Z');
    if (!tokenish || c == 'x' || c == 'X') break;
    if (n < sizeof(buf) - 1) {
      buf[n++] = c;
    } else {
      if (big.empty()) big.assign(buf, n);
      big.push_back(c);
    }
  }
  buf[n] = '\0';
  const char* tok = big.empty() ? buf : big.c_str();
  char* stop = nullptr;
  errno = 0;
#if defined(__GLIBC__) || defined(__APPLE__) || defined(__FreeBSD__)
  static const locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  float v = strtof_l(tok, &stop, c_loc);
#else
  float v = std::strtof(tok, &stop);
#endif
  if (stop == tok) return false;
  // ERANGE: overflow (±HUGE_VALF) and total underflow (rounded to 0) are
  // from_chars out_of_range; a nonzero subnormal is representable and passes
  if (errno == ERANGE && (v == HUGE_VALF || v == -HUGE_VALF || v == 0.0f)) {
    return false;
  }
  *out = v;
  p += (stop - tok);
  return true;
}
#endif

// Powers of ten as one branchless table indexed by e10 + 22.  Positive
// powers up to 1e22 are exactly representable, so (double)mant * 10^e is a
// single correctly-rounded op there; negative powers as multiplies are ~1
// double ulp off the exact division but ~15 cycles faster, and the final
// double->float truncation swallows the difference (worst case stays 1
// float ulp vs from_chars).
constexpr double kPow10Signed[] = {
    1e-22, 1e-21, 1e-20, 1e-19, 1e-18, 1e-17, 1e-16, 1e-15, 1e-14,
    1e-13, 1e-12, 1e-11, 1e-10, 1e-9,  1e-8,  1e-7,  1e-6,  1e-5,
    1e-4,  1e-3,  1e-2,  1e-1,  1e0,   1e1,   1e2,   1e3,   1e4,
    1e5,   1e6,   1e7,   1e8,   1e9,   1e10,  1e11,  1e12,  1e13,
    1e14,  1e15,  1e16,  1e17,  1e18,  1e19,  1e20,  1e21,  1e22};

// SWAR digit-run helpers (the reference compiles -msse2 and hand-rolls its
// strtof; this is the same idea one word at a time): 8 (or 4) ASCII digits
// are validated and converted with three multiply-mask steps instead of a
// per-byte loop.
inline bool all8_digits(uint64_t x) {
  return ((x & 0xF0F0F0F0F0F0F0F0ull) |
          (((x + 0x0606060606060606ull) & 0xF0F0F0F0F0F0F0F0ull) >> 4)) ==
         0x3333333333333333ull;
}

inline uint32_t swar8_to_u32(uint64_t x) {
  x = (x & 0x0F0F0F0F0F0F0F0Full) * 2561 >> 8;
  x = (x & 0x00FF00FF00FF00FFull) * 6553601 >> 16;
  return static_cast<uint32_t>(
      (x & 0x0000FFFF0000FFFFull) * 42949672960001ull >> 32);
}

inline bool all4_digits(uint32_t x) {
  return ((x & 0xF0F0F0F0u) |
          (((x + 0x06060606u) & 0xF0F0F0F0u) >> 4)) == 0x33333333u;
}

inline uint32_t swar4_to_u32(uint32_t x) {
  x = (x & 0x0F0F0F0Fu) * 2561 >> 8;
  return (x & 0x00FF00FFu) * 6553601 >> 16;
}

// Append a digit run to *mant; returns one past the last digit consumed.
// Tuned for fraction runs, which are typically >= 4 digits ("%.4f"-ish
// writers): one 4-gulp attempt first (cheapest win), 8-gulps only while
// the run keeps going, single bytes for the tail.
inline const char* scan_digits(const char* q, const char* end,
                               uint64_t* mant) {
  if (end - q >= 4) {
    uint32_t x;
    std::memcpy(&x, q, 4);
    if (all4_digits(x)) {
      *mant = *mant * 10000u + swar4_to_u32(x);
      q += 4;
      // runs longer than 4 are rare; one cheap byte test gates the wide
      // gulps so the common "%.4f" case pays nothing extra
      if (q != end && static_cast<unsigned char>(*q - '0') < 10u) {
        while (end - q >= 8) {
          uint64_t y;
          std::memcpy(&y, q, 8);
          if (!all8_digits(y)) break;
          *mant = *mant * 100000000ull + swar8_to_u32(y);
          q += 8;
        }
      }
    }
  }
  while (q != end && static_cast<unsigned char>(*q - '0') < 10u)
    *mant = *mant * 10u + static_cast<unsigned>(*q++ - '0');
  return q;
}

// Plain per-byte run for positions where short runs dominate (integer
// parts and labels are usually 1-2 digits; a SWAR attempt there is pure
// overhead).
inline const char* scan_digits_short(const char* q, const char* end,
                                     uint64_t* mant) {
  while (q != end && static_cast<unsigned char>(*q - '0') < 10u)
    *mant = *mant * 10u + static_cast<unsigned>(*q++ - '0');
  return q;
}

// Fast decimal float: the overwhelmingly common token shape in ML text
// formats is a short fixed-point decimal ("%.4f"-ish), for which the
// general-purpose std::from_chars pays for machinery it never uses.  This
// accumulates the digits into a u64 mantissa (SWAR, 8 at a time) and
// applies one power-of-ten double multiply — within ~1 double ulp of the
// exactly-rounded value for <= 15 digits and |e10| <= 22, then one
// double->float conversion (worst case 1 float ulp from from_chars; the
// reference's own strtof, src/data/strtonum.h:37-101, carries a larger
// error of the same class).  Anything
// else (inf/nan, long mantissas, big exponents) falls back to from_chars,
// preserving its accept/reject semantics exactly.
inline bool parse_float(const char*& p, const char* end, float* out) {
  const char* q = p;
  // ~half the values in real ML data are negative, so a sign *branch* is a
  // guaranteed-mispredict tax; do it with arithmetic only
  const bool neg = (q != end && *q == '-');
  q += neg;
  uint64_t mant = 0;
  const char* d0 = q;
  q = scan_digits_short(q, end, &mant);
  int ndig = static_cast<int>(q - d0);
  int e10 = 0;
  if (q != end && *q == '.') {
    const char* f0 = ++q;
    q = scan_digits(q, end, &mant);
    e10 = -static_cast<int>(q - f0);
    ndig += static_cast<int>(q - f0);
  }
  if (ndig == 0 || ndig > 18) return parse_float_slow(p, end, out);
  if (q != end && (*q == 'e' || *q == 'E')) {
    const char* esave = q++;
    bool eneg = false;
    if (q != end && (*q == '+' || *q == '-')) eneg = *q++ == '-';
    const char* e0 = q;
    int ev = 0;
    while (q != end && static_cast<unsigned char>(*q - '0') < 10u && ev < 10000)
      ev = ev * 10 + (*q++ - '0');
    if (q == e0) {
      q = esave;  // "1e"/"1e+": from_chars ends the token before the 'e'
    } else {
      if (q != end && static_cast<unsigned char>(*q - '0') < 10u)
        return parse_float_slow(p, end, out);  // absurd exponent length
      e10 += eneg ? -ev : ev;
    }
  }
  if (static_cast<unsigned>(e10 + 22) > 44u)
    return parse_float_slow(p, end, out);
  double d = static_cast<double>(mant) * kPow10Signed[e10 + 22];
  if (d > 3.402823466e+38) return parse_float_slow(p, end, out);
  // (overflow beyond FLT_MAX defers to from_chars, which rejects it as
  // out_of_range exactly like the pre-rewrite parser; also avoids the UB
  // of an out-of-range double->float conversion)
  float fv = static_cast<float>(d);
  uint32_t fb;
  std::memcpy(&fb, &fv, 4);
  fb |= static_cast<uint32_t>(neg) << 31;  // branchless negate (fv >= 0)
  std::memcpy(&fv, &fb, 4);
  *out = fv;
  p = q;
  return true;
}

inline bool parse_u32(const char*& p, const char* end, uint32_t* out) {
  const char* q = p;
  uint64_t v = 0;
  while (q != end && static_cast<unsigned char>(*q - '0') < 10u) {
    v = v * 10u + static_cast<unsigned>(*q++ - '0');
    // value check, not digit count: zero-padded in-range indices must
    // still parse (from_chars semantics); v < 2^32 entering the step
    // keeps the u64 accumulator overflow-free
    if (v > 0xffffffffull) return false;  // like from_chars out_of_range
  }
  if (q == p) return false;
  *out = static_cast<uint32_t>(v);
  p = q;
  return true;
}

// Split [begin, end) into n ranges ending at newlines (reference
// text_parser.h FillData realignment).
std::vector<std::pair<const char*, const char*>> split_ranges(
    const char* begin, const char* end, int n) {
  std::vector<std::pair<const char*, const char*>> out;
  int64_t total = end - begin;
  if (total <= 0) return out;
  int64_t step = (total + n - 1) / n;
  const char* cur = begin;
  while (cur < end) {
    const char* stop = cur + step < end ? cur + step : end;
    if (stop < end) {
      const char* nl = static_cast<const char*>(
          memchr(stop, '\n', end - stop));
      stop = nl ? nl + 1 : end;
    }
    out.emplace_back(cur, stop);
    cur = stop;
  }
  return out;
}

// ---------------------------------------------------------------- libsvm ----
// Grammar per line: label[:weight] (idx[:val])*   (reference
// src/data/libsvm_parser.h:35-90). Empty lines skipped.
void parse_libsvm_range(const char* begin, const char* end, Shard* s) {
  const char* p = begin;
  const size_t len = static_cast<size_t>(end - begin);
  // capacity up front so the hot loop's push_backs never reallocate: the
  // densest legal token is ~4 bytes ("1:2 "), typical is ~10
  s->index.reserve(len / 6);
  s->value.reserve(len / 6);
  s->label.reserve(len / 64);
  s->weight.reserve(len / 64);
  s->row_nnz.reserve(len / 64);
  bool any_value = false, any_weight = false;
  // single pass, no per-line memchr: '\n' is just another terminator the
  // number scanners already stop at, so every byte is touched once
  while (p < end) {
    p = skip_ws_nl(p, end);  // blank lines too
    if (p >= end) break;
    float label;
    if (!parse_float(p, end, &label)) {
      s->error = true;
      s->error_msg = "invalid label in libsvm input";
      return;
    }
    float w = 1.0f;
    if (p < end && *p == ':') {
      ++p;
      if (!parse_float(p, end, &w)) {
        s->error = true;
        s->error_msg = "invalid weight in libsvm input";
        return;
      }
      any_weight = true;
    }
    int64_t nnz = 0;
    while (true) {
      if (p < end && *p == ' ') ++p;      // the common single separator
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') break;
      uint32_t idx;
      if (!parse_u32(p, end, &idx)) {
        s->error = true;
        s->error_msg = "invalid feature index in libsvm input";
        return;
      }
      float v = 1.0f;
      if (p < end && *p == ':') {
        ++p;
        if (!parse_float(p, end, &v)) {
          s->error = true;
          s->error_msg = "invalid feature value in libsvm input";
          return;
        }
        any_value = true;
      }
      s->index.push_back(idx);
      s->value.push_back(v);
      ++nnz;
    }
    s->label.push_back(label);
    s->weight.push_back(w);
    s->row_nnz.push_back(nnz);
  }
  s->any_value |= any_value;
  s->any_weight |= any_weight;
}

// ---------------------------------------------------------------- libfm -----
// Grammar per line: label[:weight] (field:idx:val)*  (reference
// src/data/libfm_parser.h).
void parse_libfm_range(const char* begin, const char* end, Shard* s) {
  const char* p = begin;
  const size_t len = static_cast<size_t>(end - begin);
  s->field.reserve(len / 8);
  s->index.reserve(len / 8);
  s->value.reserve(len / 8);
  bool any_weight = false;
  // one pass, no per-line memchr (same restructure as the libsvm loop)
  while (p < end) {
    p = skip_ws_nl(p, end);  // blank lines too
    if (p >= end) break;
    float label;
    if (!parse_float(p, end, &label)) {
      s->error = true;
      s->error_msg = "invalid label in libfm input";
      return;
    }
    float w = 1.0f;
    if (p < end && *p == ':') {
      ++p;
      if (!parse_float(p, end, &w)) {
        s->error = true;
        s->error_msg = "invalid weight in libfm input";
        return;
      }
      any_weight = true;
    }
    int64_t nnz = 0;
    while (true) {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') break;
      uint32_t fld, idx;
      float v;
      if (!parse_u32(p, end, &fld) || p >= end || *p != ':') {
        s->error = true;
        s->error_msg = "libfm features must be field:index:value triples";
        return;
      }
      ++p;
      if (!parse_u32(p, end, &idx) || p >= end || *p != ':') {
        s->error = true;
        s->error_msg = "libfm features must be field:index:value triples";
        return;
      }
      ++p;
      if (!parse_float(p, end, &v)) {
        s->error = true;
        s->error_msg = "invalid feature value in libfm input";
        return;
      }
      s->field.push_back(fld);
      s->index.push_back(idx);
      s->value.push_back(v);
      ++nnz;
    }
    s->label.push_back(label);
    s->weight.push_back(w);
    s->row_nnz.push_back(nnz);
  }
  s->any_weight |= any_weight;
}

// ------------------------------------------------------------------- csv ----
// Dense comma-separated floats (reference src/data/csv_parser.h:64-99); the
// label column is extracted on the Python side (cheap numpy slice).
struct CsvShard {
  std::vector<float> dense;
  int64_t n_rows = 0;
  int64_t n_cols = -1;
  bool error = false;
  std::string error_msg;
};

void parse_csv_range(const char* begin, const char* end, CsvShard* s,
                     float missing) {
  const char* p = begin;
  s->dense.reserve(static_cast<size_t>(end - begin) / 6);
  // one pass, no per-line memchr: '\n' is just another cell terminator
  // (same restructure as the libsvm loop; every byte touched once)
  while (p < end) {
    p = skip_ws_nl(p, end);  // blank lines too
    if (p >= end) break;
    int64_t cols = 0;
    while (true) {
      p = skip_ws(p, end);
      float v;
      if (p == end || *p == ',' || *p == '\n') {
        // empty cell: the reference's strtof parses it as 0.0 silently
        // (src/data/csv_parser.h:83); we take the configured missing
        // value (0.0 default = reference parity, NaN for sparsity-aware
        // training).  A trailing comma counts as a trailing empty cell.
        v = missing;
      } else if (!parse_float(p, end, &v)) {
        s->error = true;
        s->error_msg = "invalid CSV number";
        return;
      }
      s->dense.push_back(v);
      ++cols;
      p = skip_ws(p, end);
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      break;
    }
    // anything after the last cell is discarded to end-of-line (the old
    // lend-bounded loop's behavior for trailing junk); for normal rows p
    // already sits on the '\n' and this is a no-op
    while (p < end && *p != '\n') ++p;
    if (s->n_cols < 0) s->n_cols = cols;
    if (cols != s->n_cols) {
      s->error = true;
      s->error_msg = "CSV rows have inconsistent column counts";
      return;
    }
    ++s->n_rows;
  }
}

template <typename Fn>
Result* run_parse(const char* data, int64_t len, int nthread, Fn parse_fn,
                  bool has_field_format) {
  auto* result = new Result();
  if (nthread < 1) nthread = 1;
  auto ranges = split_ranges(data, data + len, nthread);
  std::vector<Shard> shards(ranges.size());
  {
    std::vector<std::thread> workers;
    for (size_t i = 1; i < ranges.size(); ++i) {
      workers.emplace_back(parse_fn, ranges[i].first, ranges[i].second,
                           &shards[i]);
    }
    if (!ranges.empty()) {
      parse_fn(ranges[0].first, ranges[0].second, &shards[0]);
    }
    for (auto& w : workers) w.join();
  }
  bool any_weight = false, any_value = false;
  for (auto& s : shards) {
    if (s.error) {
      result->error_msg = s.error_msg;
      return result;
    }
    any_weight |= s.any_weight;
    any_value |= s.any_value || has_field_format;  // libfm always has values
    result->total_rows += static_cast<int64_t>(s.row_nnz.size());
    result->total_nnz += static_cast<int64_t>(s.index.size());
  }
  result->has_weight = any_weight;
  result->has_value = any_value;
  result->has_field = has_field_format;
  result->shards = std::move(shards);  // fill() gathers from these directly
  return result;
}

}  // namespace

extern "C" {

// All handles are Result*. On error, dims() reports n_rows = -1 and
// dmlc_tpu_error_msg returns the message.

void* dmlc_tpu_parse_libsvm(const char* data, int64_t len, int nthread) {
  return run_parse(data, len, nthread, parse_libsvm_range, false);
}

void* dmlc_tpu_parse_libfm(const char* data, int64_t len, int nthread) {
  return run_parse(data, len, nthread, parse_libfm_range, true);
}

// ABI version handshake: the ctypes bridge refuses (and rebuilds) a stale
// library whose entry points don't match what it expects.  Bump on any
// signature change.
// 5: lsplit_open2 grew the ring-depth arg; batched lsplit_next_chunks
int dmlc_tpu_abi_version() { return 5; }

void* dmlc_tpu_parse_csv(const char* data, int64_t len, int nthread,
                         float missing) {
  auto* result = new Result();
  result->is_dense = true;
  if (nthread < 1) nthread = 1;
  auto ranges = split_ranges(data, data + len, nthread);
  std::vector<CsvShard> shards(ranges.size());
  {
    std::vector<std::thread> workers;
    for (size_t i = 1; i < ranges.size(); ++i) {
      workers.emplace_back(parse_csv_range, ranges[i].first, ranges[i].second,
                           &shards[i], missing);
    }
    if (!ranges.empty()) {
      parse_csv_range(ranges[0].first, ranges[0].second, &shards[0], missing);
    }
    for (auto& w : workers) w.join();
  }
  int64_t ncols = -1;
  for (auto& s : shards) {
    if (s.error) {
      result->error_msg = s.error_msg;
      return result;
    }
    if (s.n_cols >= 0) {
      if (ncols < 0) ncols = s.n_cols;
      if (s.n_cols != ncols) {
        result->error_msg = "CSV rows have inconsistent column counts";
        return result;
      }
    }
  }
  result->n_cols = ncols < 0 ? 0 : ncols;
  for (auto& s : shards) {
    result->total_rows += s.n_rows;
    result->total_nnz += static_cast<int64_t>(s.dense.size());
  }
  result->csv_shards = std::move(shards);  // fill() gathers directly
  return result;
}

void dmlc_tpu_result_dims(void* handle, int64_t* n_rows, int64_t* nnz,
                          int64_t* n_cols, int32_t* flags) {
  auto* r = static_cast<Result*>(handle);
  if (!r->error_msg.empty()) {
    *n_rows = -1;
    *nnz = 0;
    *n_cols = 0;
    *flags = 0;
    return;
  }
  if (r->is_dense) {
    *n_rows = r->total_rows;
    *nnz = r->total_nnz;
    *n_cols = r->n_cols;
    *flags = 8;  // dense
    return;
  }
  *n_rows = r->total_rows;
  *nnz = r->total_nnz;
  *n_cols = 0;
  *flags = (r->has_weight ? 1 : 0) | (r->has_value ? 2 : 0) |
           (r->has_field ? 4 : 0);
}

const char* dmlc_tpu_error_msg(void* handle) {
  return static_cast<Result*>(handle)->error_msg.c_str();
}

void dmlc_tpu_result_fill(void* handle, int64_t* offset, float* label,
                          float* weight, uint32_t* index, uint32_t* field,
                          float* value, float* dense) {
  auto* r = static_cast<Result*>(handle);
  if (dense) {
    float* out = dense;
    for (auto& s : r->csv_shards) {
      if (s.dense.empty()) continue;  // memcpy from nullptr is UB even at 0
      memcpy(out, s.dense.data(), s.dense.size() * sizeof(float));
      out += s.dense.size();
    }
    return;
  }
  int64_t row = 0, nnz_base = 0;
  if (offset) offset[0] = 0;
  for (auto& s : r->shards) {
    const int64_t rows = static_cast<int64_t>(s.row_nnz.size());
    const int64_t nnz = static_cast<int64_t>(s.index.size());
    if (offset) {
      int64_t run = nnz_base;
      for (int64_t i = 0; i < rows; ++i) {
        run += s.row_nnz[i];
        offset[row + i + 1] = run;
      }
    }
    if (label && rows) {
      memcpy(label + row, s.label.data(), rows * sizeof(float));
    }
    if (weight && !s.weight.empty()) {
      memcpy(weight + row, s.weight.data(), rows * sizeof(float));
    }
    if (index && nnz) {
      memcpy(index + nnz_base, s.index.data(), nnz * sizeof(uint32_t));
    }
    if (field && !s.field.empty()) {
      memcpy(field + nnz_base, s.field.data(), nnz * sizeof(uint32_t));
    }
    if (value && !s.value.empty()) {
      memcpy(value + nnz_base, s.value.data(), nnz * sizeof(float));
    }
    row += rows;
    nnz_base += nnz;
  }
}

// One-pass label-column split of a dense CSV result: labels[i] takes
// column label_col, feats gets the remaining n_cols-1 columns row-major.
// Replaces a full extra numpy copy (np.delete) per chunk on the Python
// side.  Caller guarantees 0 <= label_col < n_cols and buffers sized
// n_rows and n_rows*(n_cols-1).
void dmlc_tpu_result_fill_csv(void* handle, int64_t label_col, float* labels,
                              float* feats) {
  auto* r = static_cast<Result*>(handle);
  const int64_t ncols = r->n_cols;
  if (ncols <= 0 || label_col < 0 || label_col >= ncols) return;
  const int64_t left = label_col;               // cols before the label
  const int64_t right = ncols - label_col - 1;  // cols after it
  int64_t base = 0;
  for (auto& s : r->csv_shards) {
    const float* src = s.dense.data();
    for (int64_t i = 0; i < s.n_rows; ++i) {
      const float* row = src + i * ncols;
      labels[base + i] = row[label_col];
      float* out = feats + (base + i) * (ncols - 1);
      if (left) memcpy(out, row, left * sizeof(float));
      if (right) {
        memcpy(out + left, row + label_col + 1, right * sizeof(float));
      }
    }
    base += s.n_rows;
  }
}

void dmlc_tpu_result_free(void* handle) {
  delete static_cast<Result*>(handle);
}

// ------------------------------------------------------------- recordio -----
// 4-byte-aligned magic-cell scan used by the RecordIO writer's escape path
// (reference src/recordio.cc:22-38): writes found positions (byte offsets)
// into out (capacity out_cap); returns the count found.
int64_t dmlc_tpu_find_magic(const char* data, int64_t len, uint32_t magic,
                            int64_t* out, int64_t out_cap) {
  int64_t found = 0;
  const int64_t nwords = len / 4;
  for (int64_t i = 0; i < nwords; ++i) {
    uint32_t w;
    memcpy(&w, data + i * 4, 4);
    if (w == magic) {
      if (found < out_cap) out[found] = i * 4;
      ++found;
    }
  }
  return found;
}

}  // extern "C"
