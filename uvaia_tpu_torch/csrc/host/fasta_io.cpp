// Streaming FASTA reader over xz / gzip / raw files, the sparse-delta
// encoder of the scan's uploads and the store-block digest of `ingest`:
// the port's copy of uvaia_tpu/native/fasta_io.cpp.
//
// Native replacement for the host-side input path (the reference uses
// biomcmc-lib's file_compress_t + readfasta_next, fastaseq.c:410-486):
// decompresses with liblzma/zlib, splits records, strips spaces and
// uppercases in one pass.  Exposed as a tiny C API consumed from
// Python via ctypes (uvaia_tpu_torch/io/native.py); bz2 inputs fall back
// to the Python reader.
//
// Each codec compiles in only where its header is present and it is not
// turned off (-DUFA_NO_LZMA, -DUFA_NO_ZLIB): without lzma.h, ufa_open
// refuses xz files; without zlib.h, gzip files (raw files are then read
// with stdio).  ufa_codecs() says which codecs were compiled in, so the
// caller reads the refused files in Python.
//
// Build: g++ -O3 -shared -fPIC -pthread fasta_io.cpp -o libuvaia_tpu_torch_io.so
//        [-llzma] [-lz]   (io/native.py links what it found)
//
// API contract:
//   handle = ufa_open(path)          NULL on failure or a missing codec
//   r = ufa_next(handle, &name, &name_len, &seq, &seq_len)
//       1 = record produced, 0 = EOF, -1 = read/decode error
//       buffers owned by the handle, valid until the next call
//   ufa_close(handle)
//   ufa_codecs()                     bit 1: xz, bit 2: gzip
//
// Uncompressed files also read as ranges of whole records parsed on
// several threads (ufa_map_open / ufa_map_find / ufa_map_parse, below).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>

#if defined(__x86_64__)
#include <immintrin.h>
#endif
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if !defined(UFA_NO_LZMA) && __has_include(<lzma.h>)
#define UFA_HAVE_LZMA 1
#include <lzma.h>
#else
#define UFA_HAVE_LZMA 0
#endif
#if !defined(UFA_NO_ZLIB) && __has_include(<zlib.h>)
#define UFA_HAVE_ZLIB 1
#include <zlib.h>
#else
#define UFA_HAVE_ZLIB 0
#endif

namespace {

constexpr size_t kChunk = 1 << 20;

struct Upper {
  unsigned char tab[256];
  Upper() {
    for (int i = 0; i < 256; i++) tab[i] = static_cast<unsigned char>(i);
    for (int c = 'a'; c <= 'z'; c++) tab[c] = static_cast<unsigned char>(c - 32);
  }
};
const Upper kUpper;

struct Source {
  virtual ~Source() = default;
  // returns bytes read, 0 on EOF, <0 on error
  virtual long read(uint8_t* buf, size_t n) = 0;
};

// uncompressed files when zlib (whose gzread also reads raw files) is
// not compiled in
struct RawSource : Source {
  FILE* f;
  explicit RawSource(FILE* f) : f(f) {}
  ~RawSource() override { fclose(f); }
  long read(uint8_t* buf, size_t n) override {
    size_t got = fread(buf, 1, n, f);
    if (got == 0 && ferror(f)) return -1;
    return static_cast<long>(got);
  }
};

#if UFA_HAVE_ZLIB
struct GzSource : Source {
  gzFile f;
  explicit GzSource(gzFile f) : f(f) {}
  ~GzSource() override { gzclose(f); }
  long read(uint8_t* buf, size_t n) override {
    int r = gzread(f, buf, static_cast<unsigned>(n));
    if (r < 0) return -1;
    if (r == 0) {
      // distinguish clean EOF from a truncated/corrupt gzip stream:
      // premature end reports Z_BUF_ERROR (or another error) here
      int errnum = Z_OK;
      gzerror(f, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) return -1;
    }
    return r;
  }
};
#endif  // UFA_HAVE_ZLIB

#if UFA_HAVE_LZMA
struct XzSource : Source {
  FILE* f;
  lzma_stream strm;
  std::vector<uint8_t> in;
  bool eof_in = false;
  bool ended = false;

  explicit XzSource(FILE* f) : f(f), in(kChunk) {
    strm = LZMA_STREAM_INIT;
    lzma_stream_decoder(&strm, UINT64_MAX, LZMA_CONCATENATED);
    strm.avail_in = 0;
  }
  ~XzSource() override {
    lzma_end(&strm);
    fclose(f);
  }
  long read(uint8_t* buf, size_t n) override {
    if (ended) return 0;
    strm.next_out = buf;
    strm.avail_out = n;
    while (strm.avail_out > 0) {
      if (strm.avail_in == 0 && !eof_in) {
        size_t got = fread(in.data(), 1, in.size(), f);
        if (got == 0) {
          if (ferror(f)) return -1;
          eof_in = true;
        }
        strm.next_in = in.data();
        strm.avail_in = got;
      }
      size_t out_before = strm.avail_out;
      lzma_ret ret = lzma_code(&strm, eof_in ? LZMA_FINISH : LZMA_RUN);
      if (ret == LZMA_STREAM_END) {
        ended = true;
        break;
      }
      if (ret != LZMA_OK) return -1;
      if (eof_in && strm.avail_in == 0 && strm.avail_out == out_before) {
        // Input exhausted and LZMA_FINISH made no progress without
        // reporting LZMA_STREAM_END: the file is truncated/corrupt.
        // (liblzma only returns LZMA_BUF_ERROR after a SECOND
        // no-progress call, so waiting for it would mislabel this as
        // clean EOF and silently drop genomes from scan results.)
        return -1;
      }
    }
    return static_cast<long>(n - strm.avail_out);
  }
};

// ---------------------------------------------------------------------
// Parallel multi-stream xz decode.
//
// Every xz writer in this framework (io/fasta.ParallelXzFastaWriter,
// the checkpoint-append path, the store's dump frames) emits files
// that are concatenations of INDEPENDENT xz streams — decodable in
// parallel, unlike the reference's single-stream reads (fastaseq.c:414
// decodes serially whatever the file is).  Each stream's span is
// recovered by walking stream footers/indexes backwards from EOF (the
// same trick `xz --list` uses), then a small thread pool decodes
// spans ahead of the consumer within a bounded window.  liblzma's own
// lzma_stream_decoder_mt only parallelises when block headers carry
// sizes (files from `xz -T`), which these files don't — hence the
// explicit span walk.  Single-stream files and 1-thread configs keep
// the serial XzSource path.

static bool xz_stream_spans(FILE* f, std::vector<std::pair<long, long>>* spans) {
  if (fseek(f, 0, SEEK_END) != 0) return false;
  long pos = ftell(f);
  if (pos < 32) return false;
  uint8_t buf[12];
  while (pos > 0) {
    // skip stream padding (4-byte zero words)
    for (;;) {
      if (pos < 12) return false;
      if (fseek(f, pos - 4, SEEK_SET) != 0) return false;
      if (fread(buf, 1, 4, f) != 4) return false;
      if (memcmp(buf, "\0\0\0\0", 4) == 0) {
        pos -= 4;
        continue;
      }
      break;
    }
    if (fseek(f, pos - 12, SEEK_SET) != 0) return false;
    if (fread(buf, 1, 12, f) != 12) return false;
    lzma_stream_flags flags;
    if (lzma_stream_footer_decode(&flags, buf) != LZMA_OK) return false;
    long index_size = static_cast<long>(flags.backward_size);
    long index_off = pos - 12 - index_size;
    if (index_off < 12) return false;
    std::vector<uint8_t> ibuf(index_size);
    if (fseek(f, index_off, SEEK_SET) != 0) return false;
    if (fread(ibuf.data(), 1, index_size, f) !=
        static_cast<size_t>(index_size)) return false;
    lzma_index* idx = nullptr;
    uint64_t memlimit = UINT64_MAX;
    size_t in_pos = 0;
    if (lzma_index_buffer_decode(&idx, &memlimit, nullptr, ibuf.data(),
                                 &in_pos, index_size) != LZMA_OK)
      return false;
    long total = static_cast<long>(lzma_index_stream_size(idx));
    lzma_index_end(idx, nullptr);
    if (total <= 0 || total > pos) return false;
    spans->push_back({pos - total, total});
    pos -= total;
  }
  std::reverse(spans->begin(), spans->end());
  return true;
}

struct MtXzSource : Source {
  FILE* f;
  int fd;
  std::vector<std::pair<long, long>> spans;
  unsigned nthreads;
  size_t window;

  std::mutex mu;
  std::condition_variable cv_worker, cv_reader;
  std::vector<std::thread> workers;
  std::vector<std::vector<uint8_t>> out;   // decoded, slot per span
  std::vector<uint8_t> ready;
  size_t next_claim = 0;   // next span a worker may take
  size_t next_emit = 0;    // next span the consumer reads
  size_t emit_pos = 0;     // offset into out[next_emit]
  bool stop = false, failed = false;

  MtXzSource(FILE* f, std::vector<std::pair<long, long>> s, unsigned t)
      : f(f), fd(fileno(f)), spans(std::move(s)), nthreads(t) {
    window = 4 * nthreads;
    out.resize(spans.size());
    ready.assign(spans.size(), 0);
    for (unsigned i = 0; i < nthreads; i++)
      workers.emplace_back(&MtXzSource::work, this);
  }

  ~MtXzSource() override {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_worker.notify_all();
    for (auto& w : workers) w.join();
    fclose(f);
  }

  bool decode_span(size_t i) {
    std::vector<uint8_t> comp(spans[i].second);
    long off = spans[i].first, len = spans[i].second;
    for (long got = 0; got < len;) {
      ssize_t r = pread(fd, comp.data() + got, len - got, off + got);
      if (r <= 0) return false;
      got += r;
    }
    std::vector<uint8_t> dec;
    dec.reserve(comp.size() * 4);
    lzma_stream strm = LZMA_STREAM_INIT;
    if (lzma_stream_decoder(&strm, UINT64_MAX, LZMA_CONCATENATED)
        != LZMA_OK) return false;
    strm.next_in = comp.data();
    strm.avail_in = comp.size();
    std::vector<uint8_t> chunk(kChunk);
    lzma_ret ret = LZMA_OK;
    do {
      strm.next_out = chunk.data();
      strm.avail_out = chunk.size();
      ret = lzma_code(&strm, LZMA_FINISH);
      if (ret != LZMA_OK && ret != LZMA_STREAM_END) {
        lzma_end(&strm);
        return false;
      }
      dec.insert(dec.end(), chunk.data(),
                 chunk.data() + (chunk.size() - strm.avail_out));
    } while (ret != LZMA_STREAM_END);
    lzma_end(&strm);
    std::lock_guard<std::mutex> lk(mu);
    out[i] = std::move(dec);
    ready[i] = 1;
    return true;
  }

  void work() {
    for (;;) {
      size_t i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return stop || failed ||
                 (next_claim < spans.size() &&
                  next_claim < next_emit + window);
        });
        if (stop || failed || next_claim >= spans.size()) return;
        i = next_claim++;
      }
      bool ok = decode_span(i);
      if (!ok) {
        std::lock_guard<std::mutex> lk(mu);
        failed = true;
      }
      cv_reader.notify_all();
    }
  }

  long read(uint8_t* buf, size_t n) override {
    size_t got = 0;
    while (got < n) {
      std::unique_lock<std::mutex> lk(mu);
      if (next_emit >= spans.size()) break;
      cv_reader.wait(lk, [&] { return failed || ready[next_emit]; });
      if (failed) return -1;
      std::vector<uint8_t>& cur = out[next_emit];
      size_t take = cur.size() - emit_pos;
      if (take > n - got) take = n - got;
      memcpy(buf + got, cur.data() + emit_pos, take);
      emit_pos += take;
      got += take;
      if (emit_pos >= cur.size()) {
        cur.clear();
        cur.shrink_to_fit();
        next_emit++;
        emit_pos = 0;
        lk.unlock();
        cv_worker.notify_all();
      }
    }
    return static_cast<long>(got);
  }
};

static unsigned xz_threads_config() {
  const char* env = getenv("UVAIA_TPU_XZ_THREADS");
  if (env != nullptr) {
    long v = atol(env);
    return v < 1 ? 1 : (v > 32 ? 32 : static_cast<unsigned>(v));
  }
  unsigned hw = std::thread::hardware_concurrency();
  unsigned t = hw > 1 ? hw - 1 : 1;
  return t > 8 ? 8 : t;
}
#endif  // UFA_HAVE_LZMA

struct Reader {
  Source* src = nullptr;
  std::vector<uint8_t> buf;
  size_t pos = 0, len = 0;
  bool eof = false, error = false;

  std::string name;       // current record header
  std::string next_name;  // header of the record being started
  std::vector<uint8_t> seq;
  bool have_pending = false;

  // record parked by ufa_next_batch when the name buffer filled
  std::string stash_name;
  std::vector<uint8_t> stash_seq;
  bool have_stash = false;

  ~Reader() { delete src; }

  bool fill() {
    if (eof) return false;
    long r = src->read(buf.data(), buf.size());
    if (r < 0) {
      error = true;
      eof = true;
      return false;
    }
    if (r == 0) {
      eof = true;
      return false;
    }
    pos = 0;
    len = static_cast<size_t>(r);
    return true;
  }

  // returns 1 record, 0 EOF, -1 error
  int next() {
    seq.clear();
    if (have_pending) {
      name = next_name;
      have_pending = false;
    } else {
      // scan forward to the first '>' header
      if (!scan_header()) return error ? -1 : 0;
      name = next_name;
    }
    // accumulate sequence lines until next header or EOF
    for (;;) {
      if (pos >= len && !fill()) break;
      uint8_t c = buf[pos];
      if (c == '>') {
        if (!scan_header()) break;  // EOF mid-header: emit what we have
        have_pending = true;
        break;
      }
      // one line (may span fills): bulk-copy spans up to '\n'
      for (;;) {
        const uint8_t* base = buf.data();
        const uint8_t* nl = static_cast<const uint8_t*>(
            memchr(base + pos, '\n', len - pos));
        size_t end = nl ? static_cast<size_t>(nl - base) : len;
        append_span(base + pos, end - pos);
        pos = end;
        if (nl) {
          pos++;
          break;
        }
        if (!fill()) goto done;
      }
    }
  done:
    if (error) return -1;
    return 1;
  }

  // uppercase + drop spaces/tabs/CR; spaces are rare so the skip
  // branch predicts perfectly and the copy loop vectorises
  void append_span(const uint8_t* p, size_t n) {
    size_t base = seq.size();
    seq.resize(base + n);
    uint8_t* out = seq.data() + base;
    size_t o = 0;
    for (size_t i = 0; i < n; i++) {
      uint8_t c = p[i];
      if (c == ' ' || c == '\t' || c == '\r') continue;
      out[o++] = kUpper.tab[c];
    }
    seq.resize(base + o);
  }

  // positions after a full header line; fills next_name
  bool scan_header() {
    // find '>'
    for (;;) {
      if (pos >= len && !fill()) return false;
      if (buf[pos] == '>') {
        pos++;
        break;
      }
      pos++;
    }
    next_name.clear();
    for (;;) {
      if (pos >= len && !fill()) return !next_name.empty();
      uint8_t ch = buf[pos++];
      if (ch == '\n') return true;
      if (ch != '\r') next_name.push_back(static_cast<char>(ch));
    }
  }
};

}  // namespace

extern "C" {

void* ufa_open(const char* path) {
  FILE* probe = fopen(path, "rb");
  if (!probe) return nullptr;
  uint8_t magic[6] = {0};
  size_t got = fread(magic, 1, 6, probe);

  bool is_xz = got >= 6 && memcmp(magic, "\xfd""7zXZ\x00", 6) == 0;
  bool is_gz = got >= 2 && magic[0] == 0x1f && magic[1] == 0x8b;
  if ((is_xz && !UFA_HAVE_LZMA) || (is_gz && !UFA_HAVE_ZLIB)) {
    fclose(probe);  // codec not compiled in: the caller reads the file
    return nullptr;
  }

  Reader* r = new Reader();
  r->buf.resize(kChunk);
  if (is_xz) {
#if UFA_HAVE_LZMA
    unsigned threads = xz_threads_config();
    std::vector<std::pair<long, long>> spans;
    bool mt = false;
    if (threads >= 2 && xz_stream_spans(probe, &spans)
        && spans.size() >= 2) {
      long biggest = 0;
      for (auto& s : spans)
        if (s.second > biggest) biggest = s.second;
      // bound in-flight memory: each span decodes whole into RAM
      mt = biggest <= (64L << 20);
    }
    if (mt) {
      if (threads > spans.size())
        threads = static_cast<unsigned>(spans.size());
      r->src = new MtXzSource(probe, std::move(spans), threads);
    } else {
      rewind(probe);
      r->src = new XzSource(probe);
    }
#endif
  } else {
#if UFA_HAVE_ZLIB
    fclose(probe);
    gzFile gf = gzopen(path, "rb");  // transparently handles gz and raw
    if (!gf) {
      delete r;
      return nullptr;
    }
    gzbuffer(gf, kChunk);
    r->src = new GzSource(gf);
#else
    rewind(probe);
    r->src = new RawSource(probe);
#endif
  }
  return r;
}

int ufa_codecs() { return (UFA_HAVE_LZMA ? 1 : 0) | (UFA_HAVE_ZLIB ? 2 : 0); }

int ufa_next(void* handle, const char** name, size_t* name_len,
             const uint8_t** seq, size_t* seq_len) {
  Reader* r = static_cast<Reader*>(handle);
  int rc = r->next();
  if (rc != 1) return rc;
  *name = r->name.c_str();
  *name_len = r->name.size();
  *seq = r->seq.data();
  *seq_len = r->seq.size();
  return 1;
}

void ufa_close(void* handle) { delete static_cast<Reader*>(handle); }

// Batched variant for fixed-length (aligned) databases: fills caller
// buffers, avoiding per-record FFI + allocation overhead.
//   seqbuf   — nmax * stride bytes; record i copied (clipped to stride)
//   codebuf  — optional (may be NULL): nmax * stride bytes receiving
//              lut[char] per position (the 4-bit IUPAC encoding)
//   lut      — 256-entry char->code table (used when codebuf != NULL)
//   seq_lens — true length per record (caller validates == stride)
//   namebuf  — concatenated names; name_ends[i] = end offset of name i
//   valid    — optional (may be NULL): per-record count of nonzero
//              codes (the QC "valid sites" number), computed inside
//              the encode loop so the host never re-reads the batch
// Returns #records (may be < nmax at EOF / when namebuf fills),
// 0 at EOF, -1 on read error.
long ufa_next_batch(void* handle, uint8_t* seqbuf, uint8_t* codebuf,
                    const uint8_t* lut, long stride, long nmax,
                    char* namebuf, long namecap, long* name_ends,
                    long* seq_lens, long* valid) {
  Reader* r = static_cast<Reader*>(handle);
  long k = 0;
  long name_pos = 0;
  while (k < nmax) {
    const std::string* nm;
    const std::vector<uint8_t>* sq;
    if (r->have_stash) {
      nm = &r->stash_name;
      sq = &r->stash_seq;
    } else {
      int rc = r->next();
      if (rc < 0) return -1;
      if (rc == 0) break;
      nm = &r->name;
      sq = &r->seq;
    }
    long nl = static_cast<long>(nm->size());
    if (name_pos + nl > namecap) {
      if (k == 0) return -1;  // one name larger than the whole buffer
      if (!r->have_stash) {   // park this record for the next call
        r->stash_name = r->name;
        r->stash_seq = r->seq;
        r->have_stash = true;
      }
      return k;
    }
    memcpy(namebuf + name_pos, nm->data(), nl);
    name_pos += nl;
    name_ends[k] = name_pos;
    long sl = static_cast<long>(sq->size());
    seq_lens[k] = sl;
    size_t ncopy = static_cast<size_t>(sl < stride ? sl : stride);
    memcpy(seqbuf + k * stride, sq->data(), ncopy);
    if (codebuf != nullptr) {
      const uint8_t* src = sq->data();
      uint8_t* dst = codebuf + k * stride;
      long v = 0;
      for (size_t i = 0; i < ncopy; i++) {
        dst[i] = lut[src[i]];
        v += (dst[i] != 0);
      }
      if (valid != nullptr) valid[k] = v;
    } else if (valid != nullptr) {
      valid[k] = 0;
    }
    r->have_stash = false;
    k++;
  }
  return k;
}

}  // extern "C"

// Ranged reading of an uncompressed file, for the pool of range parsers
// of engine/stream.RefStreamer.  The file is mapped read-only.  One
// thread finds the next records' bounds and names (ufa_map_find); the
// records are then parsed in ranges on several threads, each straight
// into its rows of the caller's arrays (ufa_map_parse).  Together they
// give what ufa_next_batch gives on the same file:
//   * the first record starts at the file's first '>', wherever it is;
//   * a header runs to its '\n', less its '\r's; a header cut by the
//     file's end is a record with no sequence, unless its name is empty;
//   * a record ends where a line that starts with '>' begins;
//   * its sequence is its other bytes but ' ', '\t', '\r' and '\n',
//     uppercased.

struct MappedFile {
  const uint8_t* base = nullptr;
  long size = 0;
};

// The end of the record whose sequence starts at `a`: the first line
// start at or after `a` that holds '>', else the file's end.
static long record_end(const uint8_t* b, long size, long a) {
  for (long q = a; q < size;) {
    if (b[q] == '>') return q;
    const void* nl = memchr(b + q, '\n', static_cast<size_t>(size - q));
    if (nl == nullptr) break;
    q = static_cast<const uint8_t*>(nl) - b + 1;
  }
  return size;
}

// One line of n bytes into raw (uppercased) and cd (code[] of it), with
// the count of nonzero codes; false when the line holds a byte below '!'
// (a blank, a tab, a '\r', a '\n' or a control byte), which the caller
// then walks byte by byte.
static bool clean_line(const uint8_t* p, long n, const uint8_t* code,
                       uint8_t* raw, uint8_t* cd, long* valid) {
  bool low = false;
  long v = 0;
  for (long j = 0; j < n; j++) {
    const uint8_t ch = p[j];
    low |= ch < '!';
    raw[j] = kUpper.tab[ch];
    cd[j] = code[ch];
    v += code[ch] != 0;
  }
  *valid = v;
  return !low;
}

#if defined(__x86_64__)
// clean_line, 32 bytes a step.  code[] is looked up as its 16-entry rows:
// each row that holds a nonzero entry shuffles the bytes' low nibbles,
// and the result is kept in the bytes whose high nibble picks that row.
__attribute__((target("avx2,popcnt")))
static bool clean_line_avx2(const uint8_t* p, long n, const uint8_t* code,
                            uint8_t* raw, uint8_t* cd, long* valid) {
  __m256i rows[16], nibs[16];
  int nrows = 0;
  for (int h = 0; h < 16; h++) {
    bool any = false;
    for (int l = 0; l < 16; l++) any |= code[16 * h + l] != 0;
    if (!any) continue;
    rows[nrows] = _mm256_broadcastsi128_si256(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(code + 16 * h)));
    nibs[nrows++] = _mm256_set1_epi8(static_cast<char>(h));
  }
  const __m256i f = _mm256_set1_epi8(0x0f), zero = _mm256_setzero_si256();
  __m256i low = zero;
  long v = 0, j = 0;
  for (; j + 32 <= n; j += 32) {
    const __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p + j));
    low = _mm256_or_si256(
        low, _mm256_and_si256(_mm256_cmpgt_epi8(x, _mm256_set1_epi8(-1)),
                              _mm256_cmpgt_epi8(_mm256_set1_epi8('!'), x)));
    const __m256i lower = _mm256_and_si256(
        _mm256_cmpgt_epi8(x, _mm256_set1_epi8('a' - 1)),
        _mm256_cmpgt_epi8(_mm256_set1_epi8('z' + 1), x));
    _mm256_storeu_si256(
        reinterpret_cast<__m256i*>(raw + j),
        _mm256_sub_epi8(x, _mm256_and_si256(lower, _mm256_set1_epi8(0x20))));
    const __m256i hi = _mm256_and_si256(_mm256_srli_epi16(x, 4), f);
    const __m256i lo = _mm256_and_si256(x, f);
    __m256i c = zero;
    for (int k = 0; k < nrows; k++)
      c = _mm256_or_si256(
          c, _mm256_and_si256(_mm256_cmpeq_epi8(hi, nibs[k]),
                              _mm256_shuffle_epi8(rows[k], lo)));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(cd + j), c);
    v += 32 - __builtin_popcount(static_cast<unsigned>(
                  _mm256_movemask_epi8(_mm256_cmpeq_epi8(c, zero))));
  }
  long rest = 0;
  const bool clean = clean_line(p + j, n - j, code, raw + j, cd + j, &rest);
  *valid = v + rest;
  return clean && _mm256_testz_si256(low, low);
}

static bool have_avx2() {
  __builtin_cpu_init();  // this may run before libgcc's own constructor
  return __builtin_cpu_supports("avx2") && __builtin_cpu_supports("popcnt");
}
static const bool kAvx2 = have_avx2();
#endif

extern "C" {

// NULL when the file cannot be opened or mapped, or is not a regular file.
void* ufa_map_open(const char* path) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode)) {
    close(fd);
    return nullptr;
  }
  MappedFile* m = new MappedFile();
  m->size = static_cast<long>(st.st_size);
  if (m->size > 0) {
    void* p = mmap(nullptr, static_cast<size_t>(m->size), PROT_READ,
                   MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      close(fd);
      delete m;
      return nullptr;
    }
    m->base = static_cast<const uint8_t*>(p);
  }
  close(fd);  // the mapping holds the file
  return m;
}

void ufa_map_close(void* handle) {
  MappedFile* m = static_cast<MappedFile*>(handle);
  if (m->base != nullptr)
    munmap(const_cast<uint8_t*>(m->base), static_cast<size_t>(m->size));
  delete m;
}

// The next at most nmax records from byte *pos on (0 for a new file),
// which is then moved past them.  Names as ufa_next_batch gives them;
// record i's sequence bytes are [seq_off[i], seq_end[i]).  Returns the
// number of records (fewer than nmax at the file's end or when namebuf
// fills), 0 at the end, -1 when one name is larger than namebuf.
long ufa_map_find(void* handle, long* pos, long nmax, char* namebuf,
                  long namecap, long* name_ends, long* seq_off,
                  long* seq_end) {
  const MappedFile* m = static_cast<const MappedFile*>(handle);
  const uint8_t* b = m->base;
  const long size = m->size;
  long p = *pos, k = 0, name_pos = 0;
  while (k < nmax && p < size) {
    const void* gt = memchr(b + p, '>', static_cast<size_t>(size - p));
    if (gt == nullptr) {
      p = size;
      break;
    }
    const long s = static_cast<const uint8_t*>(gt) - b;
    const void* nl = memchr(b + s + 1, '\n',
                            static_cast<size_t>(size - s - 1));
    const long h = nl ? static_cast<const uint8_t*>(nl) - b : size;
    long nlen = 0;
    for (long i = s + 1; i < h; i++) nlen += b[i] != '\r';
    if (nl == nullptr && nlen == 0) {  // a bare '>' ends the file
      p = size;
      break;
    }
    if (name_pos + nlen > namecap) {
      if (k == 0) return -1;
      break;  // this record starts the next call
    }
    for (long i = s + 1; i < h; i++)
      if (b[i] != '\r') namebuf[name_pos++] = static_cast<char>(b[i]);
    name_ends[k] = name_pos;
    const long a = nl ? h + 1 : size;
    const long e = a >= size ? size : record_end(b, size, a);
    seq_off[k] = a;
    seq_end[k] = e;
    k++;
    p = e;
  }
  *pos = p;
  return k;
}

// Parse n found records into rows of seqbuf (the uppercased bytes) and
// codebuf (lut of them), each `stride` bytes, with their true lengths
// and valid-site counts, as ufa_next_batch fills them.
void ufa_map_parse(void* handle, const long* seq_off, const long* seq_end,
                   long n, const uint8_t* lut, long stride,
                   uint8_t* seqbuf, uint8_t* codebuf, long* seq_lens,
                   long* valid) {
  const uint8_t* b = static_cast<const MappedFile*>(handle)->base;
  uint8_t code[256], skip[256];
  for (int c = 0; c < 256; c++) {
    code[c] = lut[kUpper.tab[c]];
    skip[c] = c == ' ' || c == '\t' || c == '\r' || c == '\n';
  }
  for (long r = 0; r < n; r++) {
    const long a = seq_off[r], e = seq_end[r];
    uint8_t* raw = seqbuf + r * stride;
    uint8_t* cd = codebuf + r * stride;
    // the usual record: one line of `stride` bytes, then its line end
    // or the file's end
    const long tail = e - a - stride;
    const uint8_t* p = b + a;
    if (tail >= 0 && tail <= 2 &&
        (tail == 0 || (tail == 1 && p[stride] == '\n') ||
         (tail == 2 && p[stride] == '\r' && p[stride + 1] == '\n'))) {
#if defined(__x86_64__)
      const bool clean =
          kAvx2 ? clean_line_avx2(p, stride, code, raw, cd, &valid[r])
                : clean_line(p, stride, code, raw, cd, &valid[r]);
#else
      const bool clean = clean_line(p, stride, code, raw, cd, &valid[r]);
#endif
      if (clean) {
        seq_lens[r] = stride;
        continue;
      }
    }
    // any other layout, line by line
    long o = 0, v = 0;
    for (long i = a; i < e; i++) {
      const uint8_t c = b[i];
      if (skip[c]) continue;
      if (o < stride) {
        raw[o] = kUpper.tab[c];
        cd[o] = code[c];
        v += code[c] != 0;
      }
      o++;
    }
    seq_lens[r] = o;
    valid[r] = v;
  }
}

// Sparse-delta encoder for the device upload path (ops/host.delta_encode).
// Extraction: ONE scan of the batch; diffs land in a stride-`ecap`
// scratch (no sentinel fill here — that happens in the repack once the
// per-batch bucket width is known).  The ctz walk over the XOR word
// touches only differing bytes, so the scan runs at memcmp-like speed
// over the (dominant) all-equal stretches.
//
// Zero-run markers: real genomes carry long masked runs (leading and
// trailing N/'-' stretches encode to 0) that differ from the majority
// base at thousands of sites each — as plain diffs they overflow every
// bucket and force the 4-bit packed fallback.  A maximal run of row
// zeros whose plain encoding would take >2 entries is emitted instead
// as a start marker (s, 16) + end marker (e, 32 + row[e]), with the
// device rebuild zeroing [s, e) via a cumsum unmask
// (ops/recon.delta_rebuild); a run reaching the row end emits only the
// start marker.  The rewrite is in place: markers are used only when
// strictly shorter, so the write cursor never passes the read cursor
// and counts can only shrink.  Returns the max per-row entry count, or
// -1 when a row overflows ecap.
long ufa_delta_extract(const uint8_t* codes, long nrows, long stride,
                       const uint8_t* base, const uint8_t* ok, long ecap,
                       uint16_t* pos, uint8_t* val, long* counts) {
  long maxc = 0;
  long words = stride / 8;
  // raw diffs can reach `stride` per row (fully masked genomes) even
  // though the rewritten form fits ecap — collect into a row-sized
  // temp, rewrite there, and only then enforce ecap
  uint16_t* tpos = static_cast<uint16_t*>(
      malloc(static_cast<size_t>(stride) * sizeof(uint16_t)));
  uint8_t* tval = static_cast<uint8_t*>(
      malloc(static_cast<size_t>(stride)));
  if (!tpos || !tval) {
    free(tpos);
    free(tval);
    return -1;
  }
  for (long r = 0; r < nrows; r++) {
    const uint8_t* row = codes + r * stride;
    long c = 0;
    if (ok == nullptr || ok[r]) {
      for (long w = 0; w < words; w++) {
        uint64_t a, b;
        memcpy(&a, row + w * 8, 8);
        memcpy(&b, base + w * 8, 8);
        uint64_t x = a ^ b;
        long i0 = w * 8;
        while (x) {  // little-endian: ctz finds the lowest-index byte
          long bidx = __builtin_ctzll(x) >> 3;
          tpos[c] = static_cast<uint16_t>(i0 + bidx);
          tval[c] = row[i0 + bidx];
          c++;
          x &= ~(0xFFULL << (bidx * 8));
        }
      }
      for (long i = words * 8; i < stride; i++) {
        if (row[i] != base[i]) {
          tpos[c] = static_cast<uint16_t>(i);
          tval[c] = row[i];
          c++;
        }
      }
      // in-place zero-run rewrite (see block comment)
      long o = 0, i = 0;
      while (i < c) {
        if (tval[i] != 0) {
          tpos[o] = tpos[i];
          tval[o] = tval[i];
          o++; i++;
          continue;
        }
        long p = tpos[i];
        long s = p, e = p + 1;
        while (s > 0 && row[s - 1] == 0) s--;
        while (e < stride && row[e] == 0) e++;
        long j = i;                       // diffs inside [s, e)
        while (j < c && tpos[j] < e) j++;
        long j2 = j;                      // + a diff at e, if any
        if (e < stride && j2 < c && tpos[j2] == e) j2++;
        long mcost = (e < stride) ? 2 : 1;
        if (j2 - i > mcost) {
          tpos[o] = static_cast<uint16_t>(s);
          tval[o] = 16;                   // run start
          o++;
          if (e < stride) {
            tpos[o] = static_cast<uint16_t>(e);
            tval[o] = static_cast<uint8_t>(32 + row[e]);  // run end
            o++;
          }
          i = j2;
        } else {
          for (long k = i; k < j; k++) {  // short run: plain zeros
            tpos[o] = tpos[k];
            tval[o] = 0;
            o++;
          }
          i = j;
        }
      }
      c = o;
      if (c > ecap) {
        free(tpos);
        free(tval);
        return -1;
      }
      memcpy(pos + r * ecap, tpos, static_cast<size_t>(c) * 2);
      memcpy(val + r * ecap, tval, static_cast<size_t>(c));
    }
    counts[r] = c;
    if (c > maxc) maxc = c;
  }
  free(tpos);
  free(tval);
  return maxc;
}

// Repack the stride-`ecap` scratch into tight (nrows, e_out) outputs,
// sentinel-filling slots past each row's count with pos = sent_base +
// slot (unique ascending, dropped by the device rebuild) and val = 0.
void ufa_delta_repack(const uint16_t* pos_in, const uint8_t* val_in,
                      long nrows, long ecap, const long* counts,
                      long e_out, long sent_base,
                      uint16_t* pos_out, uint8_t* val_out) {
  for (long r = 0; r < nrows; r++) {
    long c = counts[r];
    memcpy(pos_out + r * e_out, pos_in + r * ecap,
           static_cast<size_t>(c) * sizeof(uint16_t));
    memcpy(val_out + r * e_out, val_in + r * ecap,
           static_cast<size_t>(c));
    uint16_t* prow = pos_out + r * e_out;
    uint8_t* vrow = val_out + r * e_out;
    for (long s = c; s < e_out; s++) {
      prow[s] = static_cast<uint16_t>(sent_base + s);
      vrow[s] = 0;
    }
  }
}

// One-pass store-block digest for the persistent index (io/store.py
// ingest): packs codes two-per-byte, counts valid sites, extracts '-'
// runs and residual decode exceptions — all in a single scan of the
// (n, stride) block, where the numpy pipeline (io/store.py, without the
// library) makes ~8 passes.
//   packed    — n * ((stride+1)/2) bytes out
//   valid     — n counts out
//   runs      — (start, len) uint32 pairs, runs_cap PAIRS capacity
//   run_counts— per-row run counts out
//   exc_*     — positions/chars where decode_lut[code] != raw (and the
//               char is not '-'), exc_cap entries capacity
// Returns 0, or -1 when a capacity would overflow (caller retries with
// bigger buffers).
long ufa_store_block(const uint8_t* raw, const uint8_t* codes,
                     long n, long stride, const uint8_t* decode_lut,
                     uint8_t* packed, long* valid,
                     uint32_t* runs, long runs_cap, long* run_counts,
                     uint32_t* exc_pos, uint8_t* exc_chr, long exc_cap,
                     long* exc_counts) {
  long w2 = (stride + 1) / 2;
  long nrun = 0, nexc = 0;
  for (long r = 0; r < n; r++) {
    const uint8_t* rw = raw + r * stride;
    const uint8_t* cd = codes + r * stride;
    uint8_t* pk = packed + r * w2;
    long v = 0;
    long run_start = -1;
    long runs0 = nrun, exc0 = nexc;
    for (long i = 0; i < stride; i++) {
      uint8_t c = cd[i];
      v += (c != 0);
      if (i & 1) {
        pk[i >> 1] |= c;
      } else {
        pk[i >> 1] = static_cast<uint8_t>(c << 4);
      }
      uint8_t ch = rw[i];
      if (ch == '-') {
        if (run_start < 0) run_start = i;
      } else {
        if (run_start >= 0) {
          if (nrun >= runs_cap) return -1;
          runs[2 * nrun] = static_cast<uint32_t>(run_start);
          runs[2 * nrun + 1] = static_cast<uint32_t>(i - run_start);
          nrun++;
          run_start = -1;
        }
        if (decode_lut[c] != ch) {
          if (nexc >= exc_cap) return -1;
          exc_pos[nexc] = static_cast<uint32_t>(i);
          exc_chr[nexc] = ch;
          nexc++;
        }
      }
    }
    if (run_start >= 0) {
      if (nrun >= runs_cap) return -1;
      runs[2 * nrun] = static_cast<uint32_t>(run_start);
      runs[2 * nrun + 1] = static_cast<uint32_t>(stride - run_start);
      nrun++;
    }
    valid[r] = v;
    run_counts[r] = nrun - runs0;
    exc_counts[r] = nexc - exc0;
  }
  return 0;
}

// Exact decode of store rows (io/store.py Store.seq_rows), the inverse of
// ufa_store_block and the native twin of Store.seq_row: per row, the
// packed codes through a two-character table, then the '-' runs (cut at
// n_sites, as a numpy slice is), then the residual exceptions.
//   packed    — (n_rows, w2) packed codes, high nibble first
//   rows      — n store row indices, any order, repeats allowed
//   pair_lut  — 256 x 2 chars: decode_lut[b >> 4], decode_lut[b & 15]
//   runs      — (start, len) uint32 pairs; run_off (n_rows + 1) ends
//   exc_*     — exception positions and chars; exc_off (n_rows + 1) ends
//   out       — n * n_sites bytes
// Returns 0, or -1 when a row or an exception position is out of range
// (out is then partly written).
long ufa_store_decode(const uint8_t* packed, long w2, long n_rows,
                      const int64_t* rows, long n, long n_sites,
                      const uint8_t* pair_lut,
                      const uint32_t* runs, const int64_t* run_off,
                      const uint32_t* exc_pos, const uint8_t* exc_chr,
                      const int64_t* exc_off, uint8_t* out) {
  static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
                "four table entries are stored as one 64-bit word");
  uint16_t pair[256];
  memcpy(pair, pair_lut, sizeof pair);
  const long half = n_sites / 2;
  for (long k = 0; k < n; k++) {
    const int64_t r = rows[k];
    if (r < 0 || r >= n_rows) return -1;
    const uint8_t* pk = packed + r * w2;
    uint8_t* o = out + k * n_sites;
    long j = 0;
    for (; j + 4 <= half; j += 4) {
      const uint64_t v = uint64_t(pair[pk[j]]) |
                         uint64_t(pair[pk[j + 1]]) << 16 |
                         uint64_t(pair[pk[j + 2]]) << 32 |
                         uint64_t(pair[pk[j + 3]]) << 48;
      memcpy(o + 2 * j, &v, 8);
    }
    for (; j < half; j++) memcpy(o + 2 * j, &pair[pk[j]], 2);
    if (n_sites & 1) o[n_sites - 1] = pair_lut[2 * pk[half]];
    for (int64_t g = run_off[r]; g < run_off[r + 1]; g++) {
      const int64_t s = runs[2 * g];
      const int64_t e = std::min<int64_t>(s + runs[2 * g + 1], n_sites);
      if (s < e) memset(o + s, '-', static_cast<size_t>(e - s));
    }
    for (int64_t x = exc_off[r]; x < exc_off[r + 1]; x++) {
      if (exc_pos[x] >= static_cast<uint64_t>(n_sites)) return -1;
      o[exc_pos[x]] = exc_chr[x];
    }
  }
  return 0;
}

}  // extern "C"
