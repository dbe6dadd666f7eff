// Host-native pairwise global aligner (edlib-equivalent role).
//
// Primary path: Myers/Hyyro bit-parallel global alignment (64 DP cells per
// machine word) with per-column {Pv, Mv, block-bottom-score} storage and an
// O(1) popcount cell lookup for the value-based traceback.  The traceback
// tie-break rule (M on diagonal ties, then I, then D) reproduces the
// direction choices of the banded scalar DP it replaced, so CIGARs are
// bit-identical to round-1 outputs and all pipeline goldens are unchanged.
// Pairs whose traceback storage would exceed kMyersMemLimit fall back to
// the banded scalar DP with band doubling.  A score-only Myers pass serves
// as the consensus-quality metric.  Reference call sites this replaces:
// edlibAlign at src/overlap.cpp:205-224 and the test metric at
// test/racon_test.cpp:16-25 of the reference tree.
//
// Exposed as a C ABI consumed via ctypes (racon_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kBig = 1 << 28;
constexpr int64_t kMyersMemLimit = 256ll * 1024 * 1024;  // traceback storage

struct Cigar {
    std::string s;
    int64_t last_count = 0;
    char last_op = 0;
    void push(char op, int64_t count = 1) {
        if (op == last_op) {
            last_count += count;
        } else {
            flush();
            last_op = op;
            last_count = count;
        }
    }
    void flush() {
        if (last_op) {
            s += std::to_string(last_count);
            s += last_op;
            last_op = 0;
            last_count = 0;
        }
    }
};

// ------------------------------------------------------------------ Myers

// One 64-row block step of the Myers/Hyyro bit-parallel edit-distance
// automaton.  Pv/Mv hold the +1/-1 vertical deltas of this block's rows;
// hin/hout are the horizontal deltas entering/leaving the block.  When
// `ph_out`/`mh_out` are non-null the pre-shift horizontal-delta words are
// exported (bit k = delta at row base+k+1).
static inline int adv_block(uint64_t& Pv, uint64_t& Mv, uint64_t Eq, int hin,
                            uint64_t* ph_out = nullptr,
                            uint64_t* mh_out = nullptr) {
    uint64_t Xv = Eq | Mv;
    if (hin < 0) Eq |= 1ull;
    uint64_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
    uint64_t Ph = Mv | ~(Xh | Pv);
    uint64_t Mh = Pv & Xh;
    int hout = (int)(Ph >> 63) - (int)(Mh >> 63);
    if (ph_out) *ph_out = Ph;
    if (mh_out) *mh_out = Mh;
    Ph <<= 1;
    Mh <<= 1;
    if (hin > 0) Ph |= 1ull;
    else if (hin < 0) Mh |= 1ull;
    Pv = Mh | ~(Xv | Ph);
    Mv = Ph & Xv;
    return hout;
}

static void build_peq(const char* q, int64_t n, int64_t W,
                      std::vector<uint64_t>& peq) {
    peq.assign(256 * W, 0);
    for (int64_t i = 0; i < n; ++i) {
        peq[(uint8_t)q[i] * W + i / 64] |= 1ull << (i % 64);
    }
}

// Score-only global edit distance; exact, O(m * n/64).
int64_t myers_distance(const char* q, int64_t n, const char* t, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    int64_t W = (n + 63) / 64;
    std::vector<uint64_t> peq;
    build_peq(q, n, W, peq);
    std::vector<uint64_t> Pv(W, ~0ull), Mv(W, 0);
    int64_t score = n;  // cell (n, 0)
    int nbit = (n - 1) % 64;
    for (int64_t j = 0; j < m; ++j) {
        const uint64_t* eq = &peq[(uint8_t)t[j] * W];
        int hin = 1;  // row-0 boundary grows by 1 per column
        for (int64_t b = 0; b < W - 1; ++b) {
            hin = adv_block(Pv[b], Mv[b], eq[b], hin);
        }
        uint64_t ph, mh;
        adv_block(Pv[W - 1], Mv[W - 1], eq[W - 1], hin, &ph, &mh);
        score += (int64_t)((ph >> nbit) & 1) - (int64_t)((mh >> nbit) & 1);
    }
    return score;
}

// Full fill with per-column traceback storage.  ps/ms[(j-1)*W + b] hold the
// block's vertical-delta words after column j; ss holds the score at the
// block's bottom row ((b+1)*64, which may lie in the padding below row n —
// padding rows never match, and carries only propagate downward, so rows
// <= n are unaffected).  Returns the exact distance.
int64_t myers_fill(const char* q, int64_t n, const char* t, int64_t m,
                   std::vector<uint64_t>& ps, std::vector<uint64_t>& ms,
                   std::vector<int32_t>& ss) {
    int64_t W = (n + 63) / 64;
    std::vector<uint64_t> peq;
    build_peq(q, n, W, peq);
    ps.resize(W * m);
    ms.resize(W * m);
    ss.resize(W * m);
    std::vector<uint64_t> Pv(W, ~0ull), Mv(W, 0);
    std::vector<int32_t> bs(W);
    for (int64_t b = 0; b < W; ++b) bs[b] = (int32_t)((b + 1) * 64);
    int64_t score = n;
    int nbit = (n - 1) % 64;
    for (int64_t j = 0; j < m; ++j) {
        const uint64_t* eq = &peq[(uint8_t)t[j] * W];
        uint64_t* prow = &ps[j * W];
        uint64_t* mrow = &ms[j * W];
        int32_t* srow = &ss[j * W];
        int hin = 1;
        for (int64_t b = 0; b < W; ++b) {
            uint64_t ph, mh;
            int hout = adv_block(Pv[b], Mv[b], eq[b], hin, &ph, &mh);
            if (b == W - 1) {
                score += (int64_t)((ph >> nbit) & 1) -
                         (int64_t)((mh >> nbit) & 1);
            }
            bs[b] += hout;
            prow[b] = Pv[b];
            mrow[b] = Mv[b];
            srow[b] = bs[b];
            hin = hout;
        }
    }
    return score;
}

struct MyersCells {
    const std::vector<uint64_t>& ps;
    const std::vector<uint64_t>& ms;
    const std::vector<int32_t>& ss;
    int64_t W;
    // Value of DP cell (i, j), 0 <= i <= n, 0 <= j <= m.
    int64_t operator()(int64_t i, int64_t j) const {
        if (j == 0) return i;
        if (i == 0) return j;
        int64_t b = (i - 1) / 64;
        int64_t ib = i - b * 64;  // 1..64: rows > i within the block
        uint64_t mask = (ib >= 64) ? 0ull : (~0ull << ib);
        int64_t idx = (j - 1) * W + b;
        return ss[idx] - __builtin_popcountll(ps[idx] & mask) +
               __builtin_popcountll(ms[idx] & mask);
    }
};

// --------------------------------------------------- banded scalar (fallback)

// One banded DP attempt. Returns score or -1 if the end cell fell outside
// the band. When `dirs` is non-null it is filled for traceback.
int64_t banded_pass(const char* q, int64_t n, const char* t, int64_t m,
                    int64_t band, uint8_t* dirs, int64_t width) {
    int64_t row_width = 2 * band + 2;
    std::vector<int32_t> prev(row_width, kBig), cur(row_width, kBig);
    auto lo_of = [&](int64_t i) {
        return std::max<int64_t>(0, (i * m) / std::max<int64_t>(n, 1) - band);
    };
    auto hi_of = [&](int64_t i) {
        return std::min<int64_t>(m, (i * m) / std::max<int64_t>(n, 1) + band);
    };

    int64_t prev_lo = lo_of(0), prev_hi = hi_of(0);
    for (int64_t j = prev_lo; j <= prev_hi; ++j) prev[j - prev_lo] = (int32_t)j;

    for (int64_t i = 1; i <= n; ++i) {
        int64_t cur_lo = lo_of(i), cur_hi = hi_of(i);
        char qc = q[i - 1];
        uint8_t* drow = dirs ? dirs + i * width : nullptr;
        int32_t left = kBig;  // running value of cur[j-1]
        for (int64_t j = cur_lo; j <= cur_hi; ++j) {
            int32_t best;
            uint8_t d;
            if (j == 0) {
                best = (int32_t)i;
                d = 1;
            } else {
                int32_t diag = (j - 1 >= prev_lo && j - 1 <= prev_hi)
                                   ? prev[j - 1 - prev_lo] : kBig;
                int32_t up = (j >= prev_lo && j <= prev_hi)
                                 ? prev[j - prev_lo] : kBig;
                int32_t cd = diag + (t[j - 1] != qc);
                int32_t cu = up + 1;
                if (cd <= cu) { best = cd; d = 0; } else { best = cu; d = 1; }
                if (left + 1 < best) { best = left + 1; d = 2; }
            }
            cur[j - cur_lo] = best;
            left = best;
            if (drow) drow[j - cur_lo] = d;
        }
        std::swap(prev, cur);
        prev_lo = cur_lo;
        prev_hi = cur_hi;
        std::fill(cur.begin(), cur.end(), kBig);
    }

    if (m < prev_lo || m > prev_hi) return -1;
    int64_t score = prev[m - prev_lo];
    return score >= kBig ? -1 : score;
}

std::string banded_cigar_impl(const char* q, int64_t n, const char* t,
                              int64_t m) {
    int64_t diff = std::llabs(n - m);
    int64_t band = std::max<int64_t>(32, diff + 8);
    int64_t maxlen = std::max(n, m);

    while (true) {
        int64_t width = 2 * band + 2;
        std::vector<uint8_t> dirs;
        dirs.assign((size_t)(n + 1) * width, 1);
        int64_t score = banded_pass(q, n, t, m, band, dirs.data(), width);
        if (score >= 0 && (score <= band - diff || band >= maxlen)) {
            // traceback
            int64_t i = n, j = m;
            std::string ops;
            ops.reserve(n + m);
            while (i > 0 || j > 0) {
                uint8_t d;
                if (i == 0) {
                    ops.append(j, 'D');
                    break;
                }
                int64_t lo = std::max<int64_t>(
                    0, (i * m) / std::max<int64_t>(n, 1) - band);
                int64_t k = j - lo;
                d = (k >= 0 && k < width) ? dirs[(size_t)i * width + k] : 1;
                if (j == 0) d = 1;
                if (d == 0) { ops += 'M'; --i; --j; }
                else if (d == 1) { ops += 'I'; --i; }
                else { ops += 'D'; --j; }
            }
            std::reverse(ops.begin(), ops.end());
            Cigar c;
            for (char op : ops) c.push(op);
            c.flush();
            return c.s;
        }
        band *= 2;
        if (band > 2 * maxlen) band = maxlen;
    }
}

// ------------------------------------------------------------------ dispatch

std::string nw_cigar_impl(const char* q, int64_t n, const char* t, int64_t m) {
    if (n == 0) return m ? std::to_string(m) + "D" : "";
    if (m == 0) return std::to_string(n) + "I";

    int64_t W = (n + 63) / 64;
    if (W * m * (int64_t)(2 * sizeof(uint64_t) + sizeof(int32_t)) >
        kMyersMemLimit) {
        return banded_cigar_impl(q, n, t, m);
    }

    thread_local std::vector<uint64_t> ps, ms;
    thread_local std::vector<int32_t> ss;
    int64_t score = myers_fill(q, n, t, m, ps, ms, ss);
    MyersCells cell{ps, ms, ss, W};

    // Value-based traceback; tie-breaks (M over I over D) replicate the
    // banded scalar fill's direction preferences exactly.
    std::string ops;
    ops.reserve(n + m);
    int64_t i = n, j = m, v = score;
    while (i > 0 && j > 0) {
        int64_t diag = cell(i - 1, j - 1);
        if (diag + (q[i - 1] != t[j - 1]) == v) {
            ops += 'M';
            --i; --j;
            v = diag;
            continue;
        }
        int64_t up = cell(i - 1, j);
        if (up + 1 == v) {
            ops += 'I';
            --i;
            v = up;
            continue;
        }
        ops += 'D';
        --j;
        v = cell(i, j);
    }
    if (i > 0) ops.append(i, 'I');
    if (j > 0) ops.append(j, 'D');
    std::reverse(ops.begin(), ops.end());

    // The thread_local fill buffers live for the thread's lifetime; after a
    // large alignment on a long-lived caller thread they would pin up to
    // kMyersMemLimit indefinitely, so release outsized capacity here.
    constexpr size_t kRetainBytes = 32u << 20;
    if (ps.capacity() * sizeof(uint64_t) * 2 + ss.capacity() * sizeof(int32_t)
        > kRetainBytes) {
        std::vector<uint64_t>().swap(ps);
        std::vector<uint64_t>().swap(ms);
        std::vector<int32_t>().swap(ss);
    }

    Cigar c;
    for (char op : ops) c.push(op);
    c.flush();
    return c.s;
}

int64_t distance_impl(const char* a, int64_t m, const char* b, int64_t n) {
    return myers_distance(a, m, b, n);
}

}  // namespace

extern "C" {

char* rt_nw_cigar(const char* q, int64_t qn, const char* t, int64_t tn) {
    std::string c = nw_cigar_impl(q, qn, t, tn);
    char* out = (char*)std::malloc(c.size() + 1);
    std::memcpy(out, c.c_str(), c.size() + 1);
    return out;
}

int64_t rt_edit_distance(const char* a, int64_t an, const char* b, int64_t bn) {
    return distance_impl(a, an, b, bn);
}

void rt_nw_cigar_batch(int64_t count, const char** qs, const int64_t* qns,
                       const char** ts, const int64_t* tns,
                       int64_t num_threads, char** cigars_out) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        while (true) {
            int64_t i = next.fetch_add(1);
            if (i >= count) break;
            cigars_out[i] = rt_nw_cigar(qs[i], qns[i], ts[i], tns[i]);
        }
    };
    int64_t nt = std::max<int64_t>(1, std::min(num_threads, count));
    std::vector<std::thread> threads;
    for (int64_t i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

void rt_free(void* p) { std::free(p); }

}  // extern "C"
