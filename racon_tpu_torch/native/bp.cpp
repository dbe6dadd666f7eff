// Batched CIGAR -> per-window breaking-points decode on the C++ thread
// pool. Port of the run-based walker in core/overlap.py
// (breaking_points_from_cigar — itself a run-based re-derivation of the
// reference's per-base loop at src/overlap.cpp:226-292), emitting rows of
// (t_first, q_first, t_end_excl, q_end_excl) int32 straight into a
// caller-provided columnar buffer. This takes the host decode off the
// polisher's critical path: the GIL-free workers chew the whole overlap
// set while Python only allocates one flat array.

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Decode one CIGAR. `out` has room for `cap` rows of 4 int32; returns the
// number of rows written (<= cap == number of window boundaries).
int64_t decode_one(const char* cigar, int64_t q_off, int64_t t_begin,
                   int64_t t_end, int64_t w, int32_t* out, int64_t cap) {
    // window boundaries: target positions i-1 for every multiple i of w
    // in (t_begin, t_end), plus t_end-1
    std::vector<int64_t> ends;
    ends.reserve(static_cast<size_t>(cap > 0 ? cap : 1));
    for (int64_t i = 0; i < t_end; i += w)
        if (i > t_begin) ends.push_back(i - 1);
    ends.push_back(t_end - 1);

    size_t wi = 0;
    bool found_first = false;
    int64_t first_t = 0, first_q = 0, last_t = 0, last_q = 0;
    int64_t q_ptr = q_off - 1;
    int64_t t_ptr = t_begin - 1;
    int64_t rows = 0;

    int64_t n = 0;
    for (const char* p = cigar; p && *p; ++p) {
        const char c = *p;
        if (c >= '0' && c <= '9') {
            n = n * 10 + (c - '0');
            continue;
        }
        if (c == 'M' || c == '=' || c == 'X') {
            // match run covering t positions t_ptr+1 .. t_ptr+n
            const int64_t run_q = q_ptr, run_t = t_ptr;
            int64_t start_k = 1;
            while (wi < ends.size() && ends[wi] <= run_t + n) {
                const int64_t e = ends[wi];
                const int64_t k = e - run_t;
                if (!found_first) {
                    first_t = run_t + start_k;
                    first_q = run_q + start_k;
                }
                if (rows < cap) {
                    out[rows * 4 + 0] = static_cast<int32_t>(first_t);
                    out[rows * 4 + 1] = static_cast<int32_t>(first_q);
                    out[rows * 4 + 2] = static_cast<int32_t>(e + 1);
                    out[rows * 4 + 3] = static_cast<int32_t>(run_q + k + 1);
                    ++rows;
                }
                found_first = false;
                start_k = k + 1;
                ++wi;
            }
            if (start_k <= n) {
                if (!found_first) {
                    found_first = true;
                    first_t = run_t + start_k;
                    first_q = run_q + start_k;
                }
                last_t = run_t + n + 1;
                last_q = run_q + n + 1;
            }
            q_ptr += n;
            t_ptr += n;
        } else if (c == 'I') {
            q_ptr += n;
        } else if (c == 'D' || c == 'N') {
            while (wi < ends.size() && ends[wi] <= t_ptr + n) {
                if (found_first && rows < cap) {
                    out[rows * 4 + 0] = static_cast<int32_t>(first_t);
                    out[rows * 4 + 1] = static_cast<int32_t>(first_q);
                    out[rows * 4 + 2] = static_cast<int32_t>(last_t);
                    out[rows * 4 + 3] = static_cast<int32_t>(last_q);
                    ++rows;
                }
                found_first = false;
                ++wi;
            }
            t_ptr += n;
        }
        // S/H/P consume nothing here (clips already folded into q_begin)
        n = 0;
    }
    return rows;
}

}  // namespace

extern "C" {

// Decode `count` CIGARs in parallel. `out_offsets[i]` is the row offset
// (rows of 4 int32) of overlap i's slice in `out`; the caller sizes each
// slice at its window-boundary count, which upper-bounds the emitted
// rows. `out_counts[i]` receives the rows actually written.
void rt_bp_from_cigar_batch(int64_t count, const char** cigars,
                            const int64_t* q_offs, const int64_t* t_begins,
                            const int64_t* t_ends, int64_t window_length,
                            int64_t num_threads, const int64_t* out_offsets,
                            int32_t* out, int64_t* out_counts) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        while (true) {
            const int64_t i = next.fetch_add(1);
            if (i >= count) break;
            const int64_t cap = out_offsets[i + 1] - out_offsets[i];
            out_counts[i] = decode_one(cigars[i], q_offs[i], t_begins[i],
                                       t_ends[i], window_length,
                                       out + out_offsets[i] * 4, cap);
        }
    };
    const int64_t nt = std::max<int64_t>(
        1, std::min<int64_t>(num_threads, count));
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nt));
    for (int64_t i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

}  // extern "C"
