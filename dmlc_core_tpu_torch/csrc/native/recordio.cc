// Native RecordIO hot paths for dmlc_core_tpu.
//
// The reference implements the RecordIO framing/scan machinery in C++
// (src/recordio.cc:11-156); this file is the TPU rebuild's equivalent for the
// two per-record loops that dominate .rec throughput:
//
//  - scan: one pass over an in-memory chunk producing per-record
//    (head offset, logical payload length, escaped?) arrays, with the same
//    resync rule as the reference's FindNextRecordIOHead
//    (src/recordio.cc:85-100): a record head is a 4-aligned magic word whose
//    following lrec has cflag 0 or 1.
//  - frame: batch-encode N payloads into the magic-framed wire format with
//    the in-band-magic escape protocol (src/recordio.cc:22-45): payloads are
//    split at each aligned magic cell into cflag 1/2/3 parts.
//
// Exposed through the same plain-C ABI / ctypes convention as parsers.cc.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xCED7230Au;

inline uint32_t load_u32(const char* p) {
  uint32_t w;
  memcpy(&w, p, 4);
  return w;
}

inline uint32_t dec_flag(uint32_t lrec) { return (lrec >> 29u) & 7u; }
inline uint32_t dec_len(uint32_t lrec) { return lrec & ((1u << 29) - 1); }
inline uint32_t enc_lrec(uint32_t cflag, uint32_t len) {
  return (cflag << 29u) | len;
}
inline int64_t upper_align4(int64_t n) { return (n + 3) & ~int64_t(3); }

// First 4-aligned offset in [start, limit) holding a record head; limit when
// none (reference FindNextRecordIOHead).
int64_t find_head(const char* data, int64_t start, int64_t limit) {
  for (int64_t p = start; p + 8 <= limit; p += 4) {
    if (load_u32(data + p) == kMagic) {
      uint32_t cflag = dec_flag(load_u32(data + p + 4));
      if (cflag == 0 || cflag == 1) return p;
    }
  }
  return limit;
}

struct ScanResult {
  std::vector<int64_t> head;    // byte offset of each record's first part
  std::vector<int64_t> plen;    // logical payload length after unescape
  std::vector<uint8_t> escaped; // 1 when the record is multi-part
  int64_t pbegin = 0;
  int64_t pend = 0;
  std::string error_msg;
};

struct FrameResult {
  std::string out;               // framed bytes for the whole batch
  std::vector<int64_t> offsets;  // start of each record within `out`
  int64_t except_count = 0;      // number of in-band magic escapes
  std::string error_msg;
};

}  // namespace

extern "C" {

// Scan [begin, end) of a chunk after head-resync at both edges. The caller's
// partition rule matches the reference RecordIOChunkReader (recordio.cc:
// 102-117): pbegin = resync(begin), pend = resync(end), both against len.
void* dmlc_tpu_recordio_scan(const char* data, int64_t len, int64_t begin,
                             int64_t end) {
  auto* r = new ScanResult();
  if (begin < 0 || end > len || (begin & 3) || (end & 3)) {
    r->error_msg = "invalid scan bounds";
    return r;
  }
  r->pbegin = find_head(data, begin, len);
  r->pend = (end == len) ? len : find_head(data, end, len);
  int64_t p = r->pbegin;
  while (p < r->pend) {
    if (p + 8 > r->pend) {
      r->error_msg = "invalid RecordIO format: truncated header";
      return r;
    }
    if (load_u32(data + p) != kMagic) {
      r->error_msg = "invalid RecordIO format: bad magic";
      return r;
    }
    uint32_t lrec = load_u32(data + p + 4);
    uint32_t cflag = dec_flag(lrec);
    int64_t head = p;
    if (cflag == 0) {
      int64_t clen = dec_len(lrec);
      p += 8 + upper_align4(clen);
      if (p > r->pend) {
        r->error_msg = "invalid RecordIO format: truncated record";
        return r;
      }
      r->head.push_back(head);
      r->plen.push_back(clen);
      r->escaped.push_back(0);
      continue;
    }
    if (cflag != 1) {
      r->error_msg = "invalid RecordIO format: unexpected cflag";
      return r;
    }
    // multi-part record: walk cflag 1 -> 2* -> 3, logical length is the sum
    // of part lengths plus one restored magic cell between parts.
    int64_t total = 0;
    bool first = true;
    while (true) {
      if (p + 8 > r->pend) {
        r->error_msg = "invalid RecordIO format: truncated escaped record";
        return r;
      }
      if (load_u32(data + p) != kMagic) {
        r->error_msg = "invalid RecordIO format: bad magic in escaped record";
        return r;
      }
      lrec = load_u32(data + p + 4);
      cflag = dec_flag(lrec);
      if (!first && cflag != 2 && cflag != 3) {
        r->error_msg = "invalid RecordIO format: bad continuation cflag";
        return r;
      }
      int64_t clen = dec_len(lrec);
      p += 8 + upper_align4(clen);
      if (p > r->pend) {
        r->error_msg = "invalid RecordIO format: truncated escaped record";
        return r;
      }
      total += clen;
      if (cflag == 3) break;
      total += 4;  // the escaped magic cell between this part and the next
      first = false;
    }
    r->head.push_back(head);
    r->plen.push_back(total);
    r->escaped.push_back(1);
  }
  return r;
}

void dmlc_tpu_recordio_scan_dims(void* handle, int64_t* n, int64_t* pbegin,
                                 int64_t* pend) {
  auto* r = static_cast<ScanResult*>(handle);
  *n = r->error_msg.empty() ? static_cast<int64_t>(r->head.size()) : -1;
  *pbegin = r->pbegin;
  *pend = r->pend;
}

const char* dmlc_tpu_recordio_scan_error(void* handle) {
  return static_cast<ScanResult*>(handle)->error_msg.c_str();
}

void dmlc_tpu_recordio_scan_fill(void* handle, int64_t* head, int64_t* plen,
                                 uint8_t* escaped) {
  auto* r = static_cast<ScanResult*>(handle);
  if (!r->head.empty()) {
    memcpy(head, r->head.data(), r->head.size() * sizeof(int64_t));
    memcpy(plen, r->plen.data(), r->plen.size() * sizeof(int64_t));
    memcpy(escaped, r->escaped.data(), r->escaped.size());
  }
}

void dmlc_tpu_recordio_scan_free(void* handle) {
  delete static_cast<ScanResult*>(handle);
}

// Reassemble the record whose head is at byte offset `head` into `out`
// (capacity out_cap), restoring escaped in-band magic cells. Returns the
// logical length, or -1 on malformed input / overflow. Bounds are
// re-validated so this is safe to call with offsets from any source.
int64_t dmlc_tpu_recordio_extract(const char* data, int64_t len, int64_t head,
                                  char* out, int64_t out_cap) {
  int64_t p = head;
  char* dst = out;
  while (true) {
    if (p < 0 || p + 8 > len || load_u32(data + p) != kMagic) return -1;
    uint32_t lrec = load_u32(data + p + 4);
    uint32_t cflag = dec_flag(lrec);
    int64_t clen = dec_len(lrec);
    if (p + 8 + clen > len || (dst - out) + clen > out_cap) return -1;
    memcpy(dst, data + p + 8, clen);
    dst += clen;
    p += 8 + upper_align4(clen);
    if (cflag == 0 || cflag == 3) break;
    if ((dst - out) + 4 > out_cap) return -1;
    memcpy(dst, &kMagic, 4);  // restore the escaped in-band magic cell
    dst += 4;
  }
  return dst - out;
}

// Batch-frame n payloads (concatenated in `payloads`, lengths in `lens`).
void* dmlc_tpu_recordio_frame(const char* payloads, const int64_t* lens,
                              int64_t n) {
  auto* r = new FrameResult();
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += lens[i];
  r->out.reserve(total + 16 * n);
  r->offsets.reserve(n);
  const char* rec = payloads;
  char hdr[8];
  memcpy(hdr, &kMagic, 4);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = lens[i];
    if (len >= (int64_t(1) << 29)) {
      r->error_msg = "RecordIO only accepts records below 2^29 bytes";
      return r;
    }
    r->offsets.push_back(static_cast<int64_t>(r->out.size()));
    // scan aligned cells for in-band magic (reference recordio.cc:22-38)
    const int64_t lower_align = (len >> 2) << 2;
    int64_t dptr = 0;
    for (int64_t pos = 0; pos + 4 <= lower_align; pos += 4) {
      if (load_u32(rec + pos) == kMagic) {
        uint32_t lrec = enc_lrec(dptr == 0 ? 1 : 2,
                                 static_cast<uint32_t>(pos - dptr));
        memcpy(hdr + 4, &lrec, 4);
        r->out.append(hdr, 8);
        r->out.append(rec + dptr, pos - dptr);
        dptr = pos + 4;
        ++r->except_count;
      }
    }
    uint32_t lrec = enc_lrec(dptr == 0 ? 0 : 3,
                             static_cast<uint32_t>(len - dptr));
    memcpy(hdr + 4, &lrec, 4);
    r->out.append(hdr, 8);
    r->out.append(rec + dptr, len - dptr);
    const int64_t pad = (-(len - dptr)) & 3;
    r->out.append(pad, '\0');
    rec += len;
  }
  return r;
}

void dmlc_tpu_frame_dims(void* handle, int64_t* out_size, int64_t* n_offsets,
                         int64_t* except_count) {
  auto* r = static_cast<FrameResult*>(handle);
  *out_size = r->error_msg.empty()
                  ? static_cast<int64_t>(r->out.size()) : -1;
  *n_offsets = static_cast<int64_t>(r->offsets.size());
  *except_count = r->except_count;
}

const char* dmlc_tpu_frame_error(void* handle) {
  return static_cast<FrameResult*>(handle)->error_msg.c_str();
}

void dmlc_tpu_frame_fill(void* handle, char* out, int64_t* offsets) {
  auto* r = static_cast<FrameResult*>(handle);
  if (out && !r->out.empty()) memcpy(out, r->out.data(), r->out.size());
  if (offsets && !r->offsets.empty()) {
    memcpy(offsets, r->offsets.data(), r->offsets.size() * sizeof(int64_t));
  }
}

void dmlc_tpu_frame_free(void* handle) {
  delete static_cast<FrameResult*>(handle);
}

}  // extern "C"
