// Native input split: byte-range sharding with record realignment at shard
// edges and a double-buffered prefetch thread.
//
// C++ counterpart of dmlc_core_tpu/io/input_split.py (LineSplitter,
// RecordIOSplitter, IndexedRecordIOSplitter byte paths + ThreadedInputSplit
// + CachedInputSplit) and of the reference engines they mirror
// (src/io/input_split_base.cc ResetPartition/ReadChunk, src/io/line_split.cc,
// src/io/recordio_split.cc magic-resync, src/io/indexed_recordio_split.cc
// batch reads, src/io/threaded_input_split.h, src/io/cached_input_split.h).
//
// Bytes arrive through a ByteSource: local files read FILE* directly; remote
// URIs read through a caller-provided read-at callback (Python supplies one
// backed by the remote SeekStream), so the chunking/realignment/prefetch hot
// path is native for EVERY filesystem.  The epoch-1 producer can tee chunks
// into a (u64-length-framed) cache file and CacheReplayEngine replays it on
// later epochs.  Semantics are kept bit-identical to the Python engine — the
// all-parts coverage tests diff the two implementations record by record.

#ifndef _FILE_OFFSET_BITS
#define _FILE_OFFSET_BITS 64  // make off_t/fseeko 64-bit on 32-bit targets
#endif

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

// read up to `size` bytes of file `file_idx` at `offset`; returns bytes read
// (0 = EOF), or <0 on error.  Implemented by Python (ctypes CFUNCTYPE over a
// remote SeekStream) for non-local filesystems; called from the prefetch
// thread (ctypes acquires the GIL per call).
extern "C" typedef int64_t (*dmlc_tpu_read_at_fn)(void *ctx, int64_t file_idx,
                                                  int64_t offset, char *buf,
                                                  int64_t size);

namespace {

struct FileEnt {
  std::string path;
  int64_t size;
};

// 64-bit-safe absolute seek: std::fseek takes a long, which is 32 bits on
// Windows and ILP32 builds — truncating offsets >= 2 GiB in large shards.
inline int Seek64(std::FILE *fp, int64_t off) {
#if defined(_WIN32)
  return _fseeki64(fp, off, SEEK_SET);
#else
  return fseeko(fp, static_cast<off_t>(off), SEEK_SET);
#endif
}

inline int64_t FileSize64(std::FILE *fp) {
  // 64-bit-safe size probe (std::ftell returns a 32-bit long on Windows
  // and ILP32 — a >2 GiB cache would read as negative/truncated)
#if defined(_WIN32)
  _fseeki64(fp, 0, SEEK_END);
  int64_t n = _ftelli64(fp);
  _fseeki64(fp, 0, SEEK_SET);
#else
  fseeko(fp, 0, SEEK_END);
  int64_t n = static_cast<int64_t>(ftello(fp));
  fseeko(fp, 0, SEEK_SET);
#endif
  return n;
}

bool IsEol(unsigned char c) { return c == '\n' || c == '\r'; }

// RecordIO framing constants (dmlc_core_tpu/io/recordio.py, reference
// include/dmlc/recordio.h:45)
constexpr uint32_t kRecordIOMagic = 0xced7230a;
inline uint32_t CFlag(uint32_t len_word) { return (len_word >> 29) & 7u; }

enum Format { kLine = 0, kRecordIO = 1 };

// ---- byte sources ----------------------------------------------------------
// Random-access reads over the job's file list; the engines are written
// against this interface so local FILE* and remote-callback inputs share
// one chunking/realignment implementation.
class ByteSource {
 public:
  virtual ~ByteSource() = default;
  // bytes read (0 = EOF of that file), <0 on error
  virtual int64_t ReadAt(size_t file_idx, int64_t offset, char *buf,
                         int64_t size) = 0;
  virtual std::string LastError() const = 0;
  // drop cached handles so the next read reopens (a reset must observe
  // renamed/replaced files, like the reopen-per-reset Python engines)
  virtual void Invalidate() {}
};

class LocalSource : public ByteSource {
 public:
  explicit LocalSource(std::vector<std::string> paths)
      : paths_(std::move(paths)) {}
  ~LocalSource() override {
    if (fp_) std::fclose(fp_);
  }

  int64_t ReadAt(size_t idx, int64_t offset, char *buf,
                 int64_t size) override {
    if (!fp_ || idx_ != idx) {
      if (fp_) std::fclose(fp_);
      fp_ = std::fopen(paths_[idx].c_str(), "rb");
      if (!fp_) {
        err_ = "cannot open " + paths_[idx];
        return -1;
      }
      idx_ = idx;
      pos_ = 0;
    }
    if (pos_ != offset) {  // sequential reads skip the syscall
      if (Seek64(fp_, offset) != 0) {
        err_ = "seek failed in " + paths_[idx];
        return -1;
      }
      pos_ = offset;
    }
    size_t got = std::fread(buf, 1, static_cast<size_t>(size), fp_);
    pos_ += static_cast<int64_t>(got);
    if (got == 0 && std::ferror(fp_)) {
      err_ = "read error in " + paths_[idx];
      return -1;
    }
    return static_cast<int64_t>(got);
  }

  std::string LastError() const override { return err_; }

  void Invalidate() override {
    if (fp_) {
      std::fclose(fp_);
      fp_ = nullptr;
    }
  }

 private:
  std::vector<std::string> paths_;
  std::FILE *fp_ = nullptr;
  size_t idx_ = 0;
  int64_t pos_ = 0;
  std::string err_;
};

class CallbackSource : public ByteSource {
 public:
  CallbackSource(dmlc_tpu_read_at_fn fn, void *ctx) : fn_(fn), ctx_(ctx) {}

  int64_t ReadAt(size_t idx, int64_t offset, char *buf,
                 int64_t size) override {
    return fn_(ctx_, static_cast<int64_t>(idx), offset, buf, size);
  }

  // the Python side records the real exception next to the callback; this
  // is only the native-visible fallback text
  std::string LastError() const override { return "reader callback failed"; }

  // Reopen sentinel: engines only call this between queue_.Stop() (which
  // joins the producer) and the new epoch's queue_.Start(), so the Python
  // side can drop cached streams AND forget a parked stale error with no
  // in-flight read to race against (the pre-r5 consumer-side flag flip
  // could clear an error an old in-flight read was about to park).
  void Invalidate() override { fn_(ctx_, -1, 0, nullptr, 0); }

 private:
  dmlc_tpu_read_at_fn fn_;
  void *ctx_;
};

std::unique_ptr<ByteSource> MakeSource(const std::vector<FileEnt> &files,
                                       dmlc_tpu_read_at_fn read_cb,
                                       void *ctx) {
  if (read_cb != nullptr) {
    return std::unique_ptr<ByteSource>(new CallbackSource(read_cb, ctx));
  }
  std::vector<std::string> paths;
  paths.reserve(files.size());
  for (auto &f : files) paths.push_back(f.path);
  return std::unique_ptr<ByteSource>(new LocalSource(std::move(paths)));
}

// little-endian u64 cache-frame header — must match the Python cache format
// (io/input_split.py CachedInputSplit: struct.pack("<Q", len))
inline void EncodeU64LE(uint64_t v, unsigned char *out) {
  for (int i = 0; i < 8; ++i) out[i] = static_cast<unsigned char>(v >> (8 * i));
}
inline uint64_t DecodeU64LE(const unsigned char *in) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | in[i];
  return v;
}

// Shared prefetch ring: one producer thread, queue capacity 2 by default
// (reference threaded_input_split.h:23-101 / ThreadedIter cap-2) or a
// deeper pre-posted ring for the batched-pop remote path, (ok, chunk)
// items with an end sentinel that stays queued for repeated pops.
// Used by both split engines so the protocol can't drift between them.
class PrefetchQueue {
 public:
  ~PrefetchQueue() { Stop(); }

  // only before Start(): the ring depth the producer fills ahead
  void SetCapacity(int64_t capacity) {
    capacity_ = capacity < 1 ? 1 : static_cast<size_t>(capacity);
  }

  // next(chunk) -> true while chunks remain; false terminates the producer
  void Start(std::function<bool(std::vector<char> *)> next) {
    stop_ = false;
    producer_ = std::thread([this, next = std::move(next)] {
      while (true) {
        std::vector<char> chunk;
        bool ok = next(&chunk);
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk,
                       [this] { return queue_.size() < capacity_ || stop_; });
        if (stop_) return;
        queue_.emplace_back(ok, std::move(chunk));
        cv_data_.notify_one();
        if (!ok) return;  // end-of-data sentinel queued
      }
    });
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
      cv_space_.notify_all();
    }
    if (producer_.joinable()) producer_.join();
    producer_ = std::thread();
    queue_.clear();
  }

  // end sentinel without a producer (empty partition/plan): Pop never blocks
  void PushEnd() {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.emplace_back(false, std::vector<char>());
    cv_data_.notify_all();
  }

  bool Pop(std::vector<char> *out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_data_.wait(lk, [this] { return !queue_.empty(); });
    auto item = std::move(queue_.front());
    queue_.pop_front();
    cv_space_.notify_one();
    if (!item.first) {
      // leave the sentinel for repeated calls
      queue_.emplace_front(false, std::vector<char>());
      return false;
    }
    *out = std::move(item.second);
    return true;
  }

  // batched pop: block for the first chunk, then drain whatever else is
  // already buffered (never waiting on the producer) up to `cap` — one
  // consumer crossing amortizes over everything the ring had ready.
  // Returns the number popped; 0 = end of data (sentinel stays queued).
  int64_t PopMany(std::vector<std::vector<char>> *out, int64_t cap) {
    out->clear();
    std::unique_lock<std::mutex> lk(mu_);
    cv_data_.wait(lk, [this] { return !queue_.empty(); });
    while (!queue_.empty() && static_cast<int64_t>(out->size()) < cap) {
      auto &item = queue_.front();
      if (!item.first) break;  // sentinel: stays queued for the next call
      out->push_back(std::move(item.second));
      queue_.pop_front();
      cv_space_.notify_one();
    }
    return static_cast<int64_t>(out->size());
  }

 private:
  std::thread producer_;
  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::deque<std::pair<bool, std::vector<char>>> queue_;
  size_t capacity_ = 2;
  bool stop_ = false;
};

class LineSplitEngine {
 public:
  LineSplitEngine(std::vector<FileEnt> files, int64_t buffer_size,
                  Format format = kLine,
                  dmlc_tpu_read_at_fn read_cb = nullptr, void *ctx = nullptr,
                  const char *cache_path = nullptr, int64_t ring = 2)
      : files_(std::move(files)), buffer_size_(buffer_size), format_(format) {
    queue_.SetCapacity(ring);
    offsets_.push_back(0);
    for (auto &f : files_) offsets_.push_back(offsets_.back() + f.size);
    src_ = MakeSource(files_, read_cb, ctx);
    if (cache_path != nullptr && cache_path[0] != '\0') {
      cache_fo_ = std::fopen(cache_path, "wb");
      if (!cache_fo_) {
        // sticky: ClearError() on reset must not swallow it — an unusable
        // cache invalidates the whole cached-split construction
        sticky_error_ = std::string("cannot create cache ") + cache_path;
        Fail(sticky_error_);
      }
    }
  }

  ~LineSplitEngine() {
    queue_.Stop();
    if (cache_fo_) std::fclose(cache_fo_);
  }

  int64_t TotalSize() const { return offsets_.back(); }
  std::string Error() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return error_;
  }

  void ResetPartition(int64_t part, int64_t nparts) {
    queue_.Stop();
    ClearError();  // a past transient failure must not poison future resets
    src_->Invalidate();
    if (!DoResetPartition(part, nparts)) {
      // empty partition or failure: queue the end sentinel so PopChunk
      // never blocks waiting on a producer that was never started
      queue_.PushEnd();
      return;
    }
    queue_.Start([this](std::vector<char> *c) {
      bool ok = NextChunk(c);
      if (ok && cache_fo_) WriteCacheFrame(*c);
      return ok;
    });
  }

  bool DoResetPartition(int64_t part, int64_t nparts) {
    int64_t ntotal = offsets_.back();
    int64_t nstep = (ntotal + nparts - 1) / nparts;
    int64_t align = format_ == kRecordIO ? 4 : 1;
    nstep = (nstep + align - 1) / align * align;
    begin_ = std::min(nstep * part, ntotal);
    end_ = std::min(nstep * (part + 1), ntotal);
    overflow_.clear();
    if (begin_ >= end_) { curr_ = begin_; return false; }
    // realign the end edge to the next record head inside its file
    size_t fend = UpperBound(end_);
    if (end_ != offsets_[fend]) {
      end_ += SeekRecordBegin(fend, end_ - offsets_[fend]);
      if (failed()) return false;
    }
    // realign the begin edge likewise
    size_t fbegin = UpperBound(begin_);
    if (begin_ != offsets_[fbegin]) {
      begin_ += SeekRecordBegin(fbegin, begin_ - offsets_[fbegin]);
      if (failed()) return false;
    }
    BeforeFirst();
    return !failed();
  }

  void BeforeFirst() {
    curr_ = begin_;
    overflow_.clear();
  }

  // drain the remaining chunks (tee keeps writing them to the cache), then
  // flush+close the cache file — the native half of the reference's
  // cached-split preproc finish (cached_input_split.h:63-86)
  bool FinishCache() {
    std::vector<char> sink;
    while (queue_.Pop(&sink)) {
    }
    if (cache_fo_) {
      if (std::fclose(cache_fo_) != 0) Fail("cache flush failed");
      cache_fo_ = nullptr;
    }
    return !failed();
  }

  // next chunk of whole records into out; false at partition end
  bool NextChunk(std::vector<char> *out) {
    int64_t size = buffer_size_.load(std::memory_order_relaxed);
    while (true) {
      if (!ReadChunk(size, out)) return false;
      if (!out->empty()) return true;
      size *= 2;  // record larger than the buffer: grow and retry
    }
  }

  // grow the typical chunk size without disturbing the read position
  // (consumed by the prefetch thread at its next NextChunk)
  void HintChunkSize(int64_t size) {
    int64_t cur = buffer_size_.load(std::memory_order_relaxed);
    while (size > cur &&
           !buffer_size_.compare_exchange_weak(cur, size)) {
    }
  }

  // pops the next prefetched chunk; false at end
  bool PopChunk(std::vector<char> *out) { return queue_.Pop(out); }

  // pops up to `cap` buffered chunks in one call (see PrefetchQueue::PopMany)
  int64_t PopChunks(std::vector<std::vector<char>> *out, int64_t cap) {
    return queue_.PopMany(out, cap);
  }

  // error_ is written by the prefetch thread (Fail in Read/OpenFile) and
  // read by the consumer thread — guard it with its own mutex so a torn
  // string read can't happen
  bool failed() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return !error_.empty();
  }

  void ClearError() {
    std::lock_guard<std::mutex> lk(err_mu_);
    error_ = sticky_error_;  // construction-time failures survive resets
  }

 private:
  void Fail(const std::string &msg) {
    std::lock_guard<std::mutex> lk(err_mu_);
    if (error_.empty()) error_ = msg;
  }

  size_t UpperBound(int64_t offset) const {
    // index of the file containing byte `offset` of the concatenation
    auto it = std::upper_bound(offsets_.begin(), offsets_.end(), offset);
    return static_cast<size_t>(it - offsets_.begin()) - 1;
  }

  // fill `size` bytes of file idx at `offset` (looping over short reads);
  // returns bytes filled — short only at file EOF, <0 already Fail()ed
  int64_t FillAt(size_t idx, int64_t offset, char *buf, int64_t size) {
    int64_t got = 0;
    while (got < size) {
      int64_t n = src_->ReadAt(idx, offset + got, buf + got, size - got);
      if (n < 0) { Fail(src_->LastError()); return -1; }
      if (n == 0) break;
      got += n;
    }
    return got;
  }

  void WriteCacheFrame(const std::vector<char> &chunk) {
    unsigned char hdr[8];
    EncodeU64LE(static_cast<uint64_t>(chunk.size()), hdr);
    if (std::fwrite(hdr, 1, 8, cache_fo_) != 8 ||
        std::fwrite(chunk.data(), 1, chunk.size(), cache_fo_) !=
            chunk.size()) {
      Fail("cache write failed");
    }
  }

  // bytes to skip from (idx, local offset) to the next record head; the
  // scan stays within file idx (reference realigns per file)
  int64_t SeekRecordBegin(size_t idx, int64_t local) {
    return format_ == kRecordIO ? SeekRecordBeginRecordIO(idx, local)
                                : SeekRecordBeginLine(idx, local);
  }

  // (reference line_split.cc:9-26: to first EOL, then past the EOL run)
  int64_t SeekRecordBeginLine(size_t idx, int64_t local) {
    int64_t consumed = 0;  // bytes pulled from the source so far
    int64_t nstep = 0;
    bool seen_eol = false;
    char block[4096];
    while (true) {
      int64_t n = FillAt(idx, local + consumed, block, sizeof(block));
      if (n <= 0) return nstep;
      consumed += n;
      for (int64_t i = 0; i < n; ++i) {
        unsigned char c = static_cast<unsigned char>(block[i]);
        if (!seen_eol) {
          ++nstep;
          if (IsEol(c)) seen_eol = true;
        } else if (IsEol(c)) {
          ++nstep;
        } else {
          return nstep;
        }
      }
    }
  }

  // word-scan for magic followed by cflag 0/1 (reference
  // recordio_split.cc:9-26; mirrors RecordIOSplitter.seek_record_begin in
  // io/input_split.py — incl. consuming the word after a failed flag test)
  int64_t SeekRecordBeginRecordIO(size_t idx, int64_t local) {
    int64_t consumed = 0;  // bytes pulled from the source so far
    int64_t nstep = 0;
    bool saw_magic = false;
    char block[4096];
    while (true) {
      int64_t n = FillAt(idx, local + consumed, block, sizeof(block));
      if (n < 4) return nstep;
      consumed += n;
      int64_t nwords = n / 4;
      for (int64_t i = 0; i < nwords; ++i) {
        uint32_t w;
        std::memcpy(&w, block + i * 4, 4);
        nstep += 4;
        if (saw_magic) {
          saw_magic = false;
          uint32_t flag = CFlag(w);
          if (flag == 0 || flag == 1) return nstep - 8;
        } else if (w == kRecordIOMagic) {
          saw_magic = true;
        }
      }
      if (n != nwords * 4) return nstep;  // sub-word tail: end of data
    }
  }

  // offset of the last record head in [data, data+n) (0 if none beyond start)
  int64_t FindLastRecordBegin(const char *data, int64_t n) const {
    if (format_ == kRecordIO) {
      int64_t nwords = n / 4;
      for (int64_t i = nwords - 2; i > 0; --i) {
        uint32_t w, next;
        std::memcpy(&w, data + i * 4, 4);
        if (w != kRecordIOMagic) continue;
        std::memcpy(&next, data + (i + 1) * 4, 4);
        uint32_t flag = CFlag(next);
        if (flag == 0 || flag == 1) return i * 4;
      }
      return 0;
    }
    for (int64_t i = n - 1; i > 0; --i) {
      if (IsEol(static_cast<unsigned char>(data[i]))) return i + 1;
    }
    return 0;
  }

  // read up to `size` partition bytes, crossing file boundaries
  int64_t Read(char *buf, int64_t size) {
    if (begin_ >= end_ || curr_ >= end_) return 0;
    size = std::min(size, end_ - curr_);
    int64_t got_total = 0;
    while (got_total < size) {
      size_t idx = UpperBound(curr_);
      if (idx >= files_.size()) break;
      int64_t local = curr_ - offsets_[idx];
      int64_t avail = std::min(size - got_total, files_[idx].size - local);
      int64_t got = FillAt(idx, local, buf + got_total, avail);
      if (got < 0) return got_total;
      if (got < avail) {
        Fail("file shorter than its size table entry: " + files_[idx].path);
        return got_total + got;
      }
      got_total += got;
      curr_ += got;
    }
    return got_total;
  }

  // one chunk ending at a record boundary; false at partition end,
  // empty chunk when max_size cannot hold one record (caller grows)
  bool ReadChunk(int64_t max_size, std::vector<char> *out) {
    out->clear();
    if (max_size <= static_cast<int64_t>(overflow_.size())) return true;
    out->swap(overflow_);
    overflow_.clear();
    int64_t head = static_cast<int64_t>(out->size());
    out->resize(static_cast<size_t>(max_size));
    int64_t got = Read(out->data() + head, max_size - head);
    int64_t total = head + got;
    if (total == 0) { out->clear(); return false; }
    out->resize(static_cast<size_t>(total));
    if (total != max_size) return true;  // partition tail at realigned edge
    int64_t cut = FindLastRecordBegin(out->data(), total);
    overflow_.assign(out->begin() + cut, out->end());
    out->resize(static_cast<size_t>(cut));
    return true;
  }

  std::vector<FileEnt> files_;
  std::vector<int64_t> offsets_;
  std::atomic<int64_t> buffer_size_;
  Format format_;
  std::unique_ptr<ByteSource> src_;
  std::FILE *cache_fo_ = nullptr;
  int64_t begin_ = 0, end_ = 0, curr_ = 0;
  std::vector<char> overflow_;
  mutable std::mutex err_mu_;
  std::string error_;
  std::string sticky_error_;  // set at construction only (cache open)
  PrefetchQueue queue_;
};

// Replays a (u64-LE length, bytes)-framed cache file with read-ahead — the
// epoch-N half of the reference's CachedInputSplit (cached_input_split.h:
// 166-189); frame format shared with the Python cache writer.
class CacheReplayEngine {
 public:
  explicit CacheReplayEngine(std::string path) : path_(std::move(path)) {
    Reset();
  }

  ~CacheReplayEngine() {
    queue_.Stop();
    if (fp_) std::fclose(fp_);
  }

  void Reset() {
    queue_.Stop();
    {
      std::lock_guard<std::mutex> lk(err_mu_);
      error_.clear();
    }
    if (fp_) {
      std::fclose(fp_);
      fp_ = nullptr;
    }
    fp_ = std::fopen(path_.c_str(), "rb");
    if (!fp_) {
      Fail("cannot open cache " + path_);
      queue_.PushEnd();
      return;
    }
    // remaining-bytes bound for frame-length validation: a corrupt header
    // must fail cleanly, not feed a garbage u64 into vector::resize
    remaining_ = FileSize64(fp_);
    queue_.Start([this](std::vector<char> *c) { return NextFrame(c); });
  }

  bool PopChunk(std::vector<char> *out) { return queue_.Pop(out); }

  std::string Error() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return error_;
  }
  bool failed() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return !error_.empty();
  }

 private:
  bool NextFrame(std::vector<char> *out) {
    unsigned char hdr[8];
    size_t n = std::fread(hdr, 1, 8, fp_);
    if (n < 8) {
      // n == 0 is clean end-of-cache ONLY if it is a real EOF: an I/O
      // error landing exactly on a frame boundary must fail loudly, not
      // silently truncate the epoch (ADVICE r4)
      if (n != 0) Fail("truncated cache frame header");
      else if (std::ferror(fp_)) Fail("cache read error in " + path_);
      return false;
    }
    remaining_ -= 8;
    uint64_t len = DecodeU64LE(hdr);
    if (len > static_cast<uint64_t>(remaining_)) {
      Fail("corrupt cache file (frame length exceeds file size)");
      return false;
    }
    out->resize(static_cast<size_t>(len));
    if (std::fread(out->data(), 1, out->size(), fp_) != out->size()) {
      Fail("corrupt cache file (truncated frame)");
      return false;
    }
    remaining_ -= static_cast<int64_t>(len);
    return !out->empty();  // writers never emit empty frames
  }

  void Fail(const std::string &msg) {
    std::lock_guard<std::mutex> lk(err_mu_);
    if (error_.empty()) error_ = msg;
  }

  std::string path_;
  std::FILE *fp_ = nullptr;
  int64_t remaining_ = 0;  // bytes left in the file (producer thread only)
  mutable std::mutex err_mu_;
  std::string error_;
  PrefetchQueue queue_;
};

// Index-driven batch reads with prefetch (reference
// src/io/indexed_recordio_split.cc:43-227 byte path).  Policy — index
// partitioning, batch grouping, the seeded shuffle permutation — stays in
// Python (io/input_split.py IndexedRecordIOSplitter); this engine executes a
// per-epoch *plan*: a flat list of (offset, size) spans in the concatenated
// file space plus per-batch span counts, each batch concatenated into one
// chunk and read ahead by a producer thread.
class SpanReadEngine {
 public:
  explicit SpanReadEngine(std::vector<FileEnt> files,
                          dmlc_tpu_read_at_fn read_cb = nullptr,
                          void *ctx = nullptr)
      : files_(std::move(files)) {
    offsets_.push_back(0);
    for (auto &f : files_) offsets_.push_back(offsets_.back() + f.size);
    src_ = MakeSource(files_, read_cb, ctx);
  }

  ~SpanReadEngine() { queue_.Stop(); }

  std::string Error() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return error_;
  }
  bool failed() const {
    std::lock_guard<std::mutex> lk(err_mu_);
    return !error_.empty();
  }

  void SetPlan(const int64_t *offs, const int64_t *sizes,
               const int64_t *counts, int64_t nspans, int64_t nbatches) {
    queue_.Stop();
    src_->Invalidate();  // a new epoch must observe replaced files
    {
      std::lock_guard<std::mutex> lk(err_mu_);
      error_.clear();
    }
    spans_.assign(nspans, {});
    for (int64_t i = 0; i < nspans; ++i) spans_[i] = {offs[i], sizes[i]};
    counts_.assign(counts, counts + nbatches);
    next_batch_ = 0;
    next_span_ = 0;
    if (nbatches == 0) {
      queue_.PushEnd();   // empty plan: Pop never blocks on a producer
      return;
    }
    queue_.Start([this](std::vector<char> *c) { return NextBatch(c); });
  }

  bool PopChunk(std::vector<char> *out) { return queue_.Pop(out); }

 private:
  bool NextBatch(std::vector<char> *out) {
    out->clear();
    if (next_batch_ >= static_cast<int64_t>(counts_.size())) return false;
    int64_t nspan = counts_[next_batch_++];
    for (int64_t k = 0; k < nspan; ++k) {
      if (next_span_ >= static_cast<int64_t>(spans_.size())) {
        Fail("span plan shorter than batch counts");
        return false;
      }
      auto span = spans_[next_span_++];
      if (!ReadSpan(span.first, span.second, out)) return false;
    }
    // real plans have >=1 record of >=8 bytes per batch; an empty batch is
    // treated as end-of-plan, matching the Python path's `data or None`
    return !out->empty();
  }

  // read [offset, offset+size) of the concatenation, crossing file bounds
  bool ReadSpan(int64_t offset, int64_t size, std::vector<char> *out) {
    size_t head = out->size();
    out->resize(head + static_cast<size_t>(size));
    char *dst = out->data() + head;
    while (size > 0) {
      size_t idx = UpperBound(offset);
      if (idx >= files_.size()) { Fail("span beyond input"); return false; }
      int64_t local = offset - offsets_[idx];
      int64_t avail = std::min(size, files_[idx].size - local);
      int64_t got = 0;
      while (got < avail) {
        int64_t n = src_->ReadAt(idx, local + got, dst + got, avail - got);
        if (n < 0) { Fail(src_->LastError()); return false; }
        if (n == 0) { Fail("short read in " + files_[idx].path); return false; }
        got += n;
      }
      dst += got;
      offset += got;
      size -= got;
    }
    return true;
  }

  size_t UpperBound(int64_t offset) const {
    auto it = std::upper_bound(offsets_.begin(), offsets_.end(), offset);
    return static_cast<size_t>(it - offsets_.begin()) - 1;
  }

  void Fail(const std::string &msg) {
    std::lock_guard<std::mutex> lk(err_mu_);
    if (error_.empty()) error_ = msg;
  }

  std::vector<FileEnt> files_;
  std::vector<int64_t> offsets_;
  std::vector<std::pair<int64_t, int64_t>> spans_;
  std::vector<int64_t> counts_;
  int64_t next_batch_ = 0, next_span_ = 0;
  std::unique_ptr<ByteSource> src_;
  mutable std::mutex err_mu_;
  std::string error_;
  PrefetchQueue queue_;
};

struct SplitHandle {
  LineSplitEngine *engine = nullptr;
  std::vector<char> current;  // chunk handed to Python, valid until next call
  // batched-pop storage: every chunk of the last next_chunks stays valid
  // until the NEXT next_chunk/next_chunks call, so the Python side can
  // hand out views one at a time without re-crossing
  std::vector<std::vector<char>> batch;
  std::string error;
};

struct SpanHandle {
  SpanReadEngine *engine = nullptr;
  std::vector<char> current;
  std::string error;
};

struct ReplayHandle {
  CacheReplayEngine *engine = nullptr;
  std::vector<char> current;
  std::string error;
};

std::vector<FileEnt> DecodeFiles(const char *paths, const int64_t *path_lens,
                                 const int64_t *sizes, int64_t nfiles) {
  std::vector<FileEnt> files;
  const char *p = paths;
  for (int64_t i = 0; i < nfiles; ++i) {
    files.push_back({std::string(p, static_cast<size_t>(path_lens[i])),
                     sizes[i]});
    p += path_lens[i];
  }
  return files;
}

}  // namespace

extern "C" {

// paths: concatenated path bytes with per-path byte lengths in path_lens
// (length-delimited, so any legal filename byte — incl. '\n' — is safe);
// sizes: per-file byte sizes.  format: 0 = line, 1 = recordio.
// ring: prefetch-queue depth (2 = the classic double buffer; deeper rings
// feed the batched next_chunks pop on the remote callback path).
// read_cb/ctx: non-null routes ALL byte reads through the callback (remote
// filesystems); cache_path: non-empty tees epoch-1 chunks into a cache file
// (finish with dmlc_tpu_lsplit_finish_cache, replay with creplay_*).
void *dmlc_tpu_lsplit_open2(const char *paths, const int64_t *path_lens,
                            const int64_t *sizes, int64_t nfiles,
                            int64_t part, int64_t nparts,
                            int64_t buffer_size, int64_t format,
                            int64_t ring, const char *cache_path,
                            dmlc_tpu_read_at_fn read_cb, void *ctx) {
  auto *h = new SplitHandle();
  h->engine = new LineSplitEngine(
      DecodeFiles(paths, path_lens, sizes, nfiles), buffer_size,
      format == 1 ? kRecordIO : kLine, read_cb, ctx, cache_path, ring);
  h->engine->ResetPartition(part, nparts);
  if (h->engine->failed()) h->error = h->engine->Error();
  return h;
}

void *dmlc_tpu_lsplit_open(const char *paths, const int64_t *path_lens,
                           const int64_t *sizes, int64_t nfiles,
                           int64_t part, int64_t nparts,
                           int64_t buffer_size) {
  return dmlc_tpu_lsplit_open2(paths, path_lens, sizes, nfiles, part, nparts,
                               buffer_size, 0, 2, nullptr, nullptr, nullptr);
}

// RecordIO variant: same handle/call surface as lsplit_* (hint/total/reset/
// next_chunk/error/close all apply), only the record format differs
void *dmlc_tpu_rsplit_open(const char *paths, const int64_t *path_lens,
                           const int64_t *sizes, int64_t nfiles,
                           int64_t part, int64_t nparts,
                           int64_t buffer_size) {
  return dmlc_tpu_lsplit_open2(paths, path_lens, sizes, nfiles, part, nparts,
                               buffer_size, 1, 2, nullptr, nullptr, nullptr);
}

// drain the remaining partition through the cache tee and close the cache
// file; 0 on success, -1 on error (then lsplit_error has the message)
int64_t dmlc_tpu_lsplit_finish_cache(void *handle) {
  auto *h = static_cast<SplitHandle *>(handle);
  if (!h->engine->FinishCache()) {
    h->error = h->engine->Error();
    return -1;
  }
  return 0;
}

// ---- cache replay (epoch N of the cached split) ----------------------------

void *dmlc_tpu_creplay_open(const char *path) {
  auto *h = new ReplayHandle();
  h->engine = new CacheReplayEngine(path);
  if (h->engine->failed()) h->error = h->engine->Error();
  return h;
}

void dmlc_tpu_creplay_reset(void *handle) {
  auto *h = static_cast<ReplayHandle *>(handle);
  h->error.clear();
  h->engine->Reset();
  if (h->engine->failed()) h->error = h->engine->Error();
}

// returns chunk length (>0), 0 at cache end, -1 on error
int64_t dmlc_tpu_creplay_next_chunk(void *handle, const char **ptr) {
  auto *h = static_cast<ReplayHandle *>(handle);
  if (!h->error.empty()) return -1;
  if (!h->engine->PopChunk(&h->current)) {
    if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
    return 0;
  }
  if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
  *ptr = h->current.data();
  return static_cast<int64_t>(h->current.size());
}

const char *dmlc_tpu_creplay_error(void *handle) {
  return static_cast<ReplayHandle *>(handle)->error.c_str();
}

void dmlc_tpu_creplay_close(void *handle) {
  auto *h = static_cast<ReplayHandle *>(handle);
  delete h->engine;
  delete h;
}

// ---- index-driven span reader (indexed recordio batches) -------------------

void *dmlc_tpu_span_open2(const char *paths, const int64_t *path_lens,
                          const int64_t *sizes, int64_t nfiles,
                          dmlc_tpu_read_at_fn read_cb, void *ctx) {
  auto *h = new SpanHandle();
  h->engine = new SpanReadEngine(DecodeFiles(paths, path_lens, sizes, nfiles),
                                 read_cb, ctx);
  return h;
}

void *dmlc_tpu_span_open(const char *paths, const int64_t *path_lens,
                         const int64_t *sizes, int64_t nfiles) {
  return dmlc_tpu_span_open2(paths, path_lens, sizes, nfiles, nullptr,
                             nullptr);
}

void dmlc_tpu_span_set_plan(void *handle, const int64_t *offs,
                            const int64_t *sizes, const int64_t *counts,
                            int64_t nspans, int64_t nbatches) {
  auto *h = static_cast<SpanHandle *>(handle);
  h->error.clear();
  h->engine->SetPlan(offs, sizes, counts, nspans, nbatches);
}

// returns chunk length (>0), 0 at plan end, -1 on error
int64_t dmlc_tpu_span_next_chunk(void *handle, const char **ptr) {
  auto *h = static_cast<SpanHandle *>(handle);
  if (!h->error.empty()) return -1;
  if (!h->engine->PopChunk(&h->current)) {
    if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
    return 0;
  }
  if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
  *ptr = h->current.data();
  return static_cast<int64_t>(h->current.size());
}

const char *dmlc_tpu_span_error(void *handle) {
  return static_cast<SpanHandle *>(handle)->error.c_str();
}

void dmlc_tpu_span_close(void *handle) {
  auto *h = static_cast<SpanHandle *>(handle);
  delete h->engine;
  delete h;
}

void dmlc_tpu_lsplit_hint(void *handle, int64_t chunk_size) {
  static_cast<SplitHandle *>(handle)->engine->HintChunkSize(chunk_size);
}

int64_t dmlc_tpu_lsplit_total(void *handle) {
  return static_cast<SplitHandle *>(handle)->engine->TotalSize();
}

void dmlc_tpu_lsplit_reset(void *handle, int64_t part, int64_t nparts) {
  auto *h = static_cast<SplitHandle *>(handle);
  h->error.clear();  // a reset retries cleanly after a transient failure
  h->engine->ResetPartition(part, nparts);
  if (h->engine->failed()) h->error = h->engine->Error();
}

// returns chunk length (>0), 0 at partition end, -1 on error;
// *ptr stays valid until the next call on this handle
int64_t dmlc_tpu_lsplit_next_chunk(void *handle, const char **ptr) {
  auto *h = static_cast<SplitHandle *>(handle);
  if (!h->error.empty()) return -1;
  if (!h->engine->PopChunk(&h->current)) {
    if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
    return 0;
  }
  if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
  *ptr = h->current.data();
  return static_cast<int64_t>(h->current.size());
}

// batched pop: up to `cap` chunks in ONE Python->C crossing — blocks for
// the first chunk, then drains whatever the prefetch ring already buffered.
// Fills ptrs[i]/lens[i]; every view stays valid until the next
// next_chunk/next_chunks call on this handle.  Returns the count popped,
// 0 at partition end, -1 on error.
int64_t dmlc_tpu_lsplit_next_chunks(void *handle, const char **ptrs,
                                    int64_t *lens, int64_t cap) {
  auto *h = static_cast<SplitHandle *>(handle);
  if (!h->error.empty()) return -1;
  int64_t n = h->engine->PopChunks(&h->batch, cap);
  if (h->engine->failed()) { h->error = h->engine->Error(); return -1; }
  for (int64_t i = 0; i < n; ++i) {
    ptrs[i] = h->batch[static_cast<size_t>(i)].data();
    lens[i] = static_cast<int64_t>(h->batch[static_cast<size_t>(i)].size());
  }
  return n;
}

const char *dmlc_tpu_lsplit_error(void *handle) {
  return static_cast<SplitHandle *>(handle)->error.c_str();
}

void dmlc_tpu_lsplit_close(void *handle) {
  auto *h = static_cast<SplitHandle *>(handle);
  delete h->engine;
  delete h;
}

}  // extern "C"
