// Native FASTA/FASTQ/PAF/MHAP/SAM ingest (bioparser-equivalent role); the
// port's copy of racon_tpu/native/parsers.cpp, parsing exactly as it does.
//
// The reference streams its inputs through the vendored C++ bioparser
// (zlib-backed, 1 GiB chunks — src/polisher.cpp:26,83-133). This parser
// streams the (possibly gzipped) file through a bounded rolling buffer —
// chunked inflate + parse, 1 MiB reads, the consumed prefix compacted
// away — so peak RSS is the output records plus O(longest line + chunk),
// never the decompressed input. On well-formed input its records equal
// those of the Python loops in racon_tpu_torch/io/parsers.py (the
// _parse_*_py oracle) field for field:
//   - names truncate at the first whitespace;
//   - records may span multiple lines (FASTQ quality runs until its
//     length matches the sequence);
//   - lines are right-stripped of whitespace;
//   - malformed FASTQ produces an error message, not a crash.
//
// Exposed as a C ABI consumed via ctypes (racon_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <sys/stat.h>
#include <zlib.h>

namespace {

constexpr size_t kChunk = 1 << 20;  // 1 MiB inflate/read quantum

inline bool is_space(char ch) {
    return ch == ' ' || ch == '\t' || ch == '\r' || ch == '\n' ||
           ch == '\v' || ch == '\f';
}

// Streaming line source over a plain or gzipped file: a rolling buffer
// holds only unconsumed bytes (compacted before every refill), so memory
// stays bounded by the longest line plus one chunk. Returned line views
// are right-stripped and valid until the next next_line() call.
class LineReader {
 public:
    explicit LineReader(const char* path) : path_(path) {
        // plain REGULAR files skip zlib entirely (gzread still funnels
        // plain bytes through its own buffering at a measurable cost);
        // gzip is detected by magic bytes like the Python oracle, not
        // extension. Pipes/FIFOs/other non-regular inputs go straight
        // to the gz path WITHOUT any probing read (consumed probe bytes
        // cannot be given back to a pipe) — zlib's transparent mode
        // streams any readable fd.
        struct stat st;
        if (stat(path, &st) == 0 && S_ISREG(st.st_mode)) {
            raw_ = fopen(path, "rb");
            if (!raw_) {
                fail("cannot open %s", path);
                return;
            }
            // regular files are seekable, so probe the 2 magic bytes
            // and rewind — plain inputs then stream through stdio and
            // gzipped ones through zlib, each from offset 0
            unsigned char magic[2] = {0, 0};
            size_t mg = fread(magic, 1, 2, raw_);
            bool is_gz = mg == 2 && magic[0] == 0x1f && magic[1] == 0x8b;
            if (is_gz || fseek(raw_, 0, SEEK_SET) != 0) {
                fclose(raw_);
                raw_ = nullptr;
            } else {
                buf_.resize(kChunk);
                return;
            }
        }
        gz_ = gzopen(path, "rb");
        if (!gz_) {
            fail("cannot open %s", path);
            return;
        }
        gzbuffer(gz_, kChunk);
        buf_.resize(kChunk);
    }

    ~LineReader() {
        if (gz_) gzclose(gz_);
        if (raw_) fclose(raw_);
    }

    bool ok() const { return ok_; }
    const char* error() const { return err_; }

    // [*b, *e) of the next right-stripped line; false at EOF or error
    // (distinguish via ok()).
    bool next_line(const char** b, const char** e) {
        for (;;) {
            const char* nl = pos_ < len_
                ? (const char*)memchr(buf_.data() + pos_, '\n',
                                      len_ - pos_)
                : nullptr;
            if (nl || (eof_ && pos_ < len_)) {
                size_t begin = pos_;
                size_t stop = nl ? (size_t)(nl - buf_.data()) : len_;
                pos_ = nl ? stop + 1 : len_;
                while (stop > begin && is_space(buf_[stop - 1])) --stop;
                *b = buf_.data() + begin;
                *e = buf_.data() + stop;
                return true;
            }
            if (eof_ || !ok_) return false;
            if (!fill()) return false;
        }
    }

 private:
    void fail(const char* fmt, const char* path) {
        snprintf(err_, sizeof(err_), fmt, path);
        ok_ = false;
        eof_ = true;
    }

    bool fill() {
        // compact the consumed prefix, then inflate/read one chunk;
        // a line longer than the buffer grows it (memory stays bounded
        // by the longest line, not the file)
        if (pos_ > 0) {
            memmove(&buf_[0], buf_.data() + pos_, len_ - pos_);
            len_ -= pos_;
            pos_ = 0;
        }
        if (len_ + kChunk > buf_.size()) buf_.resize(len_ + kChunk);
        long got;
        if (gz_) {
            got = gzread(gz_, &buf_[len_], kChunk);
            if (got < 0) {
                fail("read error in %s", path_hint());
                return false;
            }
        } else {
            got = (long)fread(&buf_[len_], 1, kChunk, raw_);
            if (got == 0 && ferror(raw_)) {
                fail("read error in %s", path_hint());
                return false;
            }
        }
        len_ += (size_t)got;
        if (got == 0) eof_ = true;  // short nonzero reads keep going —
                                    // only a zero read is EOF for zlib
        return true;
    }

    const char* path_hint() const { return path_.c_str(); }

    std::string path_;
    gzFile gz_ = nullptr;
    FILE* raw_ = nullptr;
    std::string buf_;
    size_t pos_ = 0;   // consumed prefix
    size_t len_ = 0;   // valid bytes
    bool eof_ = false;
    bool ok_ = true;
    char err_[256] = {0};
};

// first whitespace-delimited token in [b, e): skips leading whitespace
// first (Python's split(None, 1) semantics)
void first_token(const char* b, const char* e, const char** tb,
                 const char** te) {
    while (b < e && is_space(*b)) ++b;
    const char* stop = b;
    while (stop < e && !is_space(*stop)) ++stop;
    *tb = b;
    *te = stop;
}

struct Out {
    std::string blob;
    std::vector<int64_t> offs;  // name_off,name_len,seq_off,seq_len,
                                // qual_off(-1 none),qual_len per record
    void push(const std::string& name, const std::string& seq,
              const std::string* qual) {
        offs.push_back((int64_t)blob.size());
        offs.push_back((int64_t)name.size());
        blob += name;
        offs.push_back((int64_t)blob.size());
        offs.push_back((int64_t)seq.size());
        blob += seq;
        if (qual) {
            offs.push_back((int64_t)blob.size());
            offs.push_back((int64_t)qual->size());
            blob += *qual;
        } else {
            offs.push_back(-1);
            offs.push_back(0);
        }
    }
};

}  // namespace

extern "C" {

void rt_free(void* p);  // nw.cpp

// Parse a (possibly gzipped) FASTA (is_fastq=0) or FASTQ (=1) file.
// Returns the record count, or -1 with a message in err[256]. The caller
// owns *blob_out / *offs_out (rt_free); offsets are 6 per record:
// (name_off, name_len, seq_off, seq_len, qual_off | -1, qual_len).
int64_t rt_parse_seqfile(const char* path, int32_t is_fastq,
                         char** blob_out, int64_t** offs_out, char* err) {
    LineReader lr(path);
    if (!lr.ok()) {
        snprintf(err, 256, "%s", lr.error());
        return -1;
    }

    Out out;
    const char *b, *e, *tb, *te;
    std::string name, seq, qual;

    if (!is_fastq) {
        bool have = false;
        while (lr.next_line(&b, &e)) {
            if (b == e) continue;
            if (*b == '>') {
                if (have) out.push(name, seq, nullptr);
                first_token(b + 1, e, &tb, &te);
                name.assign(tb, te - tb);
                seq.clear();
                have = true;
            } else if (have) {
                seq.append(b, e - b);
            }
        }
        if (!lr.ok()) {
            snprintf(err, 256, "%s", lr.error());
            return -1;
        }
        if (have) out.push(name, seq, nullptr);
    } else {
        while (lr.next_line(&b, &e)) {
            if (b == e) continue;
            if (*b != '@') {
                snprintf(err, 256, "malformed FASTQ header in %s", path);
                return -1;
            }
            first_token(b + 1, e, &tb, &te);
            name.assign(tb, te - tb);
            seq.clear();
            while (lr.next_line(&b, &e)) {
                if (b < e && *b == '+') break;
                seq.append(b, e - b);
            }
            qual.clear();
            while (qual.size() < seq.size()) {
                if (!lr.next_line(&b, &e)) {
                    if (!lr.ok()) {
                        snprintf(err, 256, "%s", lr.error());
                    } else {
                        snprintf(err, 256, "truncated FASTQ record for %s",
                                 name.c_str());
                    }
                    return -1;
                }
                qual.append(b, e - b);
            }
            if (qual.size() != seq.size()) {
                snprintf(err, 256,
                         "FASTQ quality/sequence length mismatch for %s",
                         name.c_str());
                return -1;
            }
            out.push(name, seq, &qual);
        }
        if (!lr.ok()) {
            snprintf(err, 256, "%s", lr.error());
            return -1;
        }
    }

    char* blob = (char*)std::malloc(out.blob.size() + 1);
    int64_t* offs = (int64_t*)std::malloc(
        out.offs.size() * sizeof(int64_t) + 8);
    if (!blob || !offs) {
        std::free(blob);
        std::free(offs);
        snprintf(err, 256, "out of memory parsing %s", path);
        return -1;
    }
    std::memcpy(blob, out.blob.data(), out.blob.size());
    blob[out.blob.size()] = '\0';
    std::memcpy(offs, out.offs.data(), out.offs.size() * sizeof(int64_t));
    *blob_out = blob;
    *offs_out = offs;
    return (int64_t)(out.offs.size() / 6);
}

// Parse a (possibly gzipped) overlap file: fmt 0=PAF, 1=MHAP, 2=SAM.
// Line-oriented streaming scan, the overlap-side analog of
// rt_parse_seqfile (reference routes all five formats through native
// bioparser, src/polisher.cpp:83-133). Per record the outputs hold:
//   PAF:  strings [qname, tname];        nums [qlen, qstart, qend,
//         strand_byte, tlen, tstart, tend]                      (2, 7)
//   MHAP: strings [];                    nums [aid, bid, jaccard,
//         shared, arc, astart, aend, alen, brc, bstart, bend, blen]
//                                                               (0, 12)
//   SAM:  strings [qname, rname, cigar]; nums [flag, pos]       (3, 2)
// nums travel as double (every integer field is < 2^53, so exact); the
// jaccard double equals Python float() on the same token (both
// correctly rounded). Strings land in *blob_out with (off, len) pairs
// in *soffs_out. Header (@) and empty lines are skipped for SAM, empty
// lines for all. Returns the record count or -1 with err[256] set.
int64_t rt_parse_ovlfile(const char* path, int32_t fmt, char** blob_out,
                         int64_t** soffs_out, double** nums_out,
                         char* err) {
    LineReader lr(path);
    if (!lr.ok()) {
        snprintf(err, 256, "%s", lr.error());
        return -1;
    }

    std::string blob;
    std::vector<int64_t> soffs;
    std::vector<double> nums;
    const char *lb, *le;
    std::vector<std::pair<const char*, const char*>> tok;
    int64_t count = 0;

    while (lr.next_line(&lb, &le)) {
        if (lb == le) continue;
        if (fmt == 2 && *lb == '@') continue;
        tok.clear();
        if (fmt == 1) {  // whitespace split
            const char* i = lb;
            while (i < le) {
                while (i < le && is_space(*i)) ++i;
                const char* s = i;
                while (i < le && !is_space(*i)) ++i;
                if (i > s) tok.emplace_back(s, i);
            }
        } else {  // tab split (Python line.split(b"\t"))
            const char* s = lb;
            for (const char* i = lb; i <= le; ++i) {
                if (i == le || *i == '\t') {
                    tok.emplace_back(s, i);
                    s = i + 1;
                }
            }
        }
        const size_t need = fmt == 0 ? 9 : (fmt == 1 ? 12 : 6);
        if (tok.size() < need) {
            snprintf(err, 256, "malformed line %lld in %s",
                     (long long)(count + 1), path);
            return -1;
        }
        bool bad = false;
        auto num = [&](size_t k) -> double {
            // integer fields only (every PAF/SAM numeric field, 11 of
            // MHAP's 12): inline decimal parse — strtod costs ~50
            // ns/field and dominated the scan; int64 -> double is exact
            // below 2^53. Python-int semantics: surrounding whitespace
            // and one leading sign allowed, anything else (empty,
            // non-digit) marks the line malformed like the oracle's
            // int() raising.
            const char* p = tok[k].first;
            const char* e2 = tok[k].second;
            while (p < e2 && is_space(*p)) ++p;
            while (e2 > p && is_space(e2[-1])) --e2;
            bool neg = p < e2 && *p == '-';
            if (p < e2 && (*p == '-' || *p == '+')) ++p;
            int64_t v = 0;
            const char* d = p;
            while (d < e2 && *d >= '0' && *d <= '9') v = v * 10 + (*d++ - '0');
            if (d == e2 && d > p) return neg ? -(double)v : (double)v;
            bad = true;
            return 0.0;
        };
        auto fnum = [&](size_t k) -> double {
            // float field (MHAP jaccard): bounded strtod on a
            // null-terminated copy of the token
            size_t len = tok[k].second - tok[k].first;
            char tmp[64];
            if (len == 0 || len >= sizeof(tmp)) {
                bad = true;
                return 0.0;
            }
            std::memcpy(tmp, tok[k].first, len);
            tmp[len] = '\0';
            char* endp = nullptr;
            double v = strtod(tmp, &endp);
            if (endp != tmp + len) bad = true;
            return v;
        };
        auto str = [&](size_t k) {
            soffs.push_back((int64_t)blob.size());
            soffs.push_back((int64_t)(tok[k].second - tok[k].first));
            blob.append(tok[k].first, tok[k].second - tok[k].first);
        };
        if (fmt == 0) {
            str(0); str(5);
            nums.push_back(num(1)); nums.push_back(num(2));
            nums.push_back(num(3));
            // first byte of the strand token (0 when empty — Python's
            // t[4][:1] is b"" there)
            nums.push_back(tok[4].second > tok[4].first
                           ? (double)(unsigned char)*tok[4].first
                           : 0.0);
            nums.push_back(num(6)); nums.push_back(num(7));
            nums.push_back(num(8));
        } else if (fmt == 1) {
            for (size_t k = 0; k < 12; ++k) {
                nums.push_back(k == 2 ? fnum(k) : num(k));
            }
        } else {
            str(0); str(2); str(5);
            nums.push_back(num(1)); nums.push_back(num(3));
        }
        if (bad) {
            snprintf(err, 256, "malformed line %lld in %s",
                     (long long)(count + 1), path);
            return -1;
        }
        ++count;
    }
    if (!lr.ok()) {
        snprintf(err, 256, "%s", lr.error());
        return -1;
    }

    char* bl = (char*)std::malloc(blob.size() + 1);
    int64_t* so = (int64_t*)std::malloc(soffs.size() * sizeof(int64_t) + 8);
    double* nu = (double*)std::malloc(nums.size() * sizeof(double) + 8);
    if (!bl || !so || !nu) {
        std::free(bl); std::free(so); std::free(nu);
        snprintf(err, 256, "out of memory parsing %s", path);
        return -1;
    }
    std::memcpy(bl, blob.data(), blob.size());
    bl[blob.size()] = '\0';
    std::memcpy(so, soffs.data(), soffs.size() * sizeof(int64_t));
    std::memcpy(nu, nums.data(), nums.size() * sizeof(double));
    *blob_out = bl;
    *soffs_out = so;
    *nums_out = nu;
    return count;
}

}  // extern "C"
