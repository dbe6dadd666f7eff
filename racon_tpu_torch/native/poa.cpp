// Host-native POA consensus engine (spoa-equivalent role).
//
// C++ re-implementation of the partial-order-alignment graph + linear-gap
// NW sequence-to-graph aligner in racon_tpu/models/poa.py, with identical
// tie-breaking everywhere (toposort visit order, traceback preferences,
// heaviest-bundle rules), so window consensuses are byte-identical to the
// Python engine and the recorded pipeline goldens are unchanged.  Windows
// are processed by a fixed thread pool over an atomic work index — the
// host analog of the reference's per-window futures
// (src/polisher.cpp:490-503); spoa call-site semantics documented at
// src/window.cpp:65-142 of the reference tree.
//
// Exposed as a C ABI consumed via ctypes (racon_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

// row[j] = max(row[j], row[j-1] + gap) for j in [1, n] — the serial
// dependence that blocks autovectorization of the NW row update (spoa
// solves the same recurrence with its SIMD lazy-F loop). Equivalent
// closed form: row[j] = max_{0 <= k <= j} row[k] + (j-k)*gap, an
// inclusive max-plus prefix scan — computed per 16-lane block with
// log2(16) shifted maxes plus one cross-block carry, so results are
// bit-identical to the scalar loop (max is order-independent and the
// added offsets are exact).
inline void row_gap_scan(int32_t* row, int64_t n, int32_t gap) {
#if defined(__AVX512F__)
    if (n >= 32) {
        const int32_t kNeg = INT32_MIN / 2;
        const __m512i vneg = _mm512_set1_epi32(kNeg);
        const __m512i g1 = _mm512_set1_epi32(gap);
        const __m512i g2 = _mm512_set1_epi32(2 * gap);
        const __m512i g4 = _mm512_set1_epi32(4 * gap);
        const __m512i g8 = _mm512_set1_epi32(8 * gap);
        alignas(64) int32_t ramp_arr[16];
        for (int k = 0; k < 16; ++k) ramp_arr[k] = (k + 1) * gap;
        const __m512i ramp = _mm512_load_si512(ramp_arr);
        int32_t carry = row[0];
        int64_t j = 1;
        for (; j + 16 <= n + 1; j += 16) {
            __m512i v = _mm512_loadu_si512(row + j);
            // in-block inclusive scan: lane l takes max over lanes <= l
            // with the matching gap multiples (alignr pulls lane l-s,
            // shifting in -inf at the left edge)
            __m512i s;
            s = _mm512_alignr_epi32(v, vneg, 15);
            v = _mm512_max_epi32(v, _mm512_add_epi32(s, g1));
            s = _mm512_alignr_epi32(v, vneg, 14);
            v = _mm512_max_epi32(v, _mm512_add_epi32(s, g2));
            s = _mm512_alignr_epi32(v, vneg, 12);
            v = _mm512_max_epi32(v, _mm512_add_epi32(s, g4));
            s = _mm512_alignr_epi32(v, vneg, 8);
            v = _mm512_max_epi32(v, _mm512_add_epi32(s, g8));
            // fold in the carry from everything before this block
            v = _mm512_max_epi32(
                v, _mm512_add_epi32(_mm512_set1_epi32(carry), ramp));
            _mm512_storeu_si512(row + j, v);
            carry = row[j + 15];
        }
        for (; j <= n; ++j) {
            int32_t c = row[j - 1] + gap;
            if (c > row[j]) row[j] = c;
        }
        return;
    }
#endif
    for (int64_t j = 1; j <= n; ++j) {
        int32_t c = row[j - 1] + gap;
        if (c > row[j]) row[j] = c;
    }
}

// One predecessor's contribution to an NW row:
//   row[j] (=|max=) max(pr[j-1] + prof[j-1], pr[j] + gap),  j in [1, n]
// (diagonal + consume-query candidates; the in-row gap recurrence is
// handled afterwards by row_gap_scan). FIRST overwrites, else folds max.
template <bool FIRST>
inline void row_update_pred(int32_t* row, const int32_t* pr,
                            const int32_t* prof, int64_t n, int32_t gap) {
    int64_t j = 1;
#if defined(__AVX512F__)
    const __m512i vg = _mm512_set1_epi32(gap);
    for (; j + 16 <= n + 1; j += 16) {
        __m512i diag = _mm512_add_epi32(
            _mm512_loadu_si512(pr + j - 1),
            _mm512_loadu_si512(prof + j - 1));
        __m512i up = _mm512_add_epi32(_mm512_loadu_si512(pr + j), vg);
        __m512i v = _mm512_max_epi32(diag, up);
        if (!FIRST) v = _mm512_max_epi32(v, _mm512_loadu_si512(row + j));
        _mm512_storeu_si512(row + j, v);
    }
#endif
    for (; j <= n; ++j) {
        int32_t a = pr[j - 1] + prof[j - 1];
        int32_t b = pr[j] + gap;
        int32_t c = a > b ? a : b;
        if (FIRST || c > row[j]) row[j] = c;
    }
}

}  // namespace

namespace {

constexpr int64_t kNegInf = -(1ll << 60);

struct Edge {
    int32_t src;
    int32_t dst;
    int64_t weight;
    std::vector<int32_t> labels;
};

struct PoaGraph {
    std::vector<uint8_t> letters;
    // per-node edge indices, insertion-ordered (edges owned by `edges`)
    std::vector<std::vector<int32_t>> in_edges;
    std::vector<std::vector<int32_t>> out_edges;
    std::vector<std::vector<int32_t>> aligned;
    std::vector<Edge> edges;
    int32_t num_sequences = 0;
    std::vector<int32_t> rank_to_node;
    std::vector<int32_t> node_to_rank;

    int32_t add_node(uint8_t letter) {
        letters.push_back(letter);
        in_edges.emplace_back();
        out_edges.emplace_back();
        aligned.emplace_back();
        return (int32_t)letters.size() - 1;
    }

    void add_edge(int32_t src, int32_t dst, int64_t weight) {
        for (int32_t ei : out_edges[src]) {
            if (edges[ei].dst == dst) {
                edges[ei].weight += weight;
                edges[ei].labels.push_back(num_sequences);
                return;
            }
        }
        int32_t ei = (int32_t)edges.size();
        edges.push_back(Edge{src, dst, weight, {num_sequences}});
        out_edges[src].push_back(ei);
        in_edges[dst].push_back(ei);
    }

    // Add seq[begin:end) as a fresh chain; returns {first, last} or {-1,-1}.
    std::pair<int32_t, int32_t> add_sequence_chain(
            const uint8_t* seq, const int64_t* weights, int64_t begin,
            int64_t end) {
        if (begin == end) return {-1, -1};
        int32_t first = add_node(seq[begin]);
        int32_t prev = first;
        for (int64_t i = begin + 1; i < end; ++i) {
            int32_t node = add_node(seq[i]);
            add_edge(prev, node, weights[i - 1] + weights[i]);
            prev = node;
        }
        return {first, prev};
    }

    // alignment: pairs (node_id or -1, pos or -1)
    void add_alignment(const std::vector<std::pair<int32_t, int32_t>>& aln,
                       const uint8_t* seq, int64_t len,
                       const int64_t* weights) {
        if (len == 0) return;

        int32_t first_valid = -1, last_valid = -1;
        for (const auto& p : aln) {
            if (p.second != -1) {
                if (first_valid == -1) first_valid = p.second;
                last_valid = p.second;
            }
        }
        if (first_valid == -1) {
            add_sequence_chain(seq, weights, 0, len);
            num_sequences += 1;
            topological_sort();
            return;
        }

        int32_t head = add_sequence_chain(seq, weights, 0, first_valid).second;
        int32_t tail_first =
            add_sequence_chain(seq, weights, last_valid + 1, len).first;

        int64_t prev_weight = head == -1 ? 0 : weights[first_valid - 1];
        for (const auto& [node_id, pos] : aln) {
            if (pos == -1) continue;
            uint8_t letter = seq[pos];
            int32_t curr;
            if (node_id == -1) {
                curr = add_node(letter);
            } else if (letters[node_id] == letter) {
                curr = node_id;
            } else {
                curr = -1;
                for (int32_t aid : aligned[node_id]) {
                    if (letters[aid] == letter) {
                        curr = aid;
                        break;
                    }
                }
                if (curr == -1) {
                    curr = add_node(letter);
                    for (int32_t aid : aligned[node_id]) {
                        aligned[curr].push_back(aid);
                        aligned[aid].push_back(curr);
                    }
                    aligned[curr].push_back(node_id);
                    aligned[node_id].push_back(curr);
                }
            }
            if (head != -1) add_edge(head, curr, prev_weight + weights[pos]);
            head = curr;
            prev_weight = weights[pos];
        }

        if (tail_first != -1) {
            add_edge(head, tail_first, prev_weight + weights[last_valid + 1]);
        }

        num_sequences += 1;
        topological_sort();
    }

    // DFS toposort keeping aligned-node groups consecutive in rank;
    // faithful port of PoaGraph._topological_sort (same visit order).
    void topological_sort() {
        int64_t n = (int64_t)letters.size();
        std::vector<uint8_t> marks(n, 0);
        std::vector<uint8_t> check_aligned(n, 1);
        rank_to_node.clear();
        std::vector<int32_t> stack;
        for (int32_t root = 0; root < n; ++root) {
            if (marks[root]) continue;
            stack.push_back(root);
            while (!stack.empty()) {
                int32_t node = stack.back();
                bool valid = true;
                if (marks[node] != 2) {
                    for (int32_t ei : in_edges[node]) {
                        if (marks[edges[ei].src] != 2) {
                            stack.push_back(edges[ei].src);
                            valid = false;
                        }
                    }
                    if (check_aligned[node]) {
                        for (int32_t aid : aligned[node]) {
                            if (marks[aid] != 2) {
                                stack.push_back(aid);
                                check_aligned[aid] = 0;
                                valid = false;
                            }
                        }
                    }
                    if (valid) {
                        marks[node] = 2;
                        if (check_aligned[node]) {
                            rank_to_node.push_back(node);
                            for (int32_t aid : aligned[node]) {
                                rank_to_node.push_back(aid);
                            }
                        }
                    }
                }
                if (valid) stack.pop_back();
            }
        }
        node_to_rank.assign(n, 0);
        for (int32_t r = 0; r < (int32_t)rank_to_node.size(); ++r) {
            node_to_rank[rank_to_node[r]] = r;
        }
    }

    // Backward DFS from end_node via in-edges + aligned, ids >= begin_node.
    void subgraph(int32_t begin_node, int32_t end_node, PoaGraph& sub,
                  std::vector<int32_t>& mapping) const {
        std::vector<uint8_t> marked(letters.size(), 0);
        std::vector<int32_t> stack{end_node};
        while (!stack.empty()) {
            int32_t node = stack.back();
            stack.pop_back();
            if (!marked[node] && node >= begin_node) {
                for (int32_t ei : in_edges[node]) {
                    stack.push_back(edges[ei].src);
                }
                for (int32_t aid : aligned[node]) stack.push_back(aid);
                marked[node] = 1;
            }
        }

        mapping.clear();
        std::vector<int32_t> orig_to_sub(letters.size(), -1);
        for (int32_t i = 0; i < (int32_t)letters.size(); ++i) {
            if (marked[i]) {
                orig_to_sub[i] = (int32_t)mapping.size();
                mapping.push_back(i);
            }
        }

        for (int32_t orig : mapping) sub.add_node(letters[orig]);
        for (int32_t orig : mapping) {
            int32_t s_dst = orig_to_sub[orig];
            for (int32_t ei : in_edges[orig]) {
                const Edge& e = edges[ei];
                if (marked[e.src]) {
                    int32_t si = (int32_t)sub.edges.size();
                    sub.edges.push_back(
                        Edge{orig_to_sub[e.src], s_dst, e.weight, e.labels});
                    sub.out_edges[orig_to_sub[e.src]].push_back(si);
                    sub.in_edges[s_dst].push_back(si);
                }
            }
            for (int32_t a : aligned[orig]) {
                if (marked[a]) sub.aligned[s_dst].push_back(orig_to_sub[a]);
            }
        }
        sub.num_sequences = num_sequences;
        sub.topological_sort();
    }

    int64_t node_coverage(int32_t node,
                          std::vector<int32_t>& scratch) const {
        scratch.clear();
        for (int32_t ei : in_edges[node]) {
            for (int32_t l : edges[ei].labels) scratch.push_back(l);
        }
        for (int32_t ei : out_edges[node]) {
            for (int32_t l : edges[ei].labels) scratch.push_back(l);
        }
        std::sort(scratch.begin(), scratch.end());
        return std::unique(scratch.begin(), scratch.end()) - scratch.begin();
    }

    int32_t branch_completion(std::vector<int64_t>& scores,
                              std::vector<int32_t>& predecessors,
                              int32_t rank) const {
        int32_t node = rank_to_node[rank];
        for (int32_t ei : out_edges[node]) {
            for (int32_t oe : in_edges[edges[ei].dst]) {
                if (edges[oe].src != node) scores[edges[oe].src] = -1;
            }
        }
        int64_t max_score = 0;
        int32_t max_score_id = 0;
        for (int32_t i = rank + 1; i < (int32_t)rank_to_node.size(); ++i) {
            int32_t nid = rank_to_node[i];
            scores[nid] = -1;
            predecessors[nid] = -1;
            for (int32_t ei : in_edges[nid]) {
                const Edge& e = edges[ei];
                if (scores[e.src] == -1) continue;
                if (scores[nid] < e.weight ||
                    (scores[nid] == e.weight && predecessors[nid] != -1 &&
                     scores[predecessors[nid]] <= scores[e.src])) {
                    scores[nid] = e.weight;
                    predecessors[nid] = e.src;
                }
            }
            if (predecessors[nid] != -1) scores[nid] += scores[predecessors[nid]];
            if (max_score < scores[nid]) {
                max_score = scores[nid];
                max_score_id = nid;
            }
        }
        return max_score_id;
    }

    // Heaviest-bundle consensus; returns node ids in order.
    bool traverse_heaviest_bundle(std::vector<int32_t>& consensus) const {
        int64_t n = (int64_t)letters.size();
        std::vector<int32_t> predecessors(n, -1);
        std::vector<int64_t> scores(n, -1);
        int32_t max_score_id = 0;

        for (int32_t node : rank_to_node) {
            for (int32_t ei : in_edges[node]) {
                const Edge& e = edges[ei];
                if (scores[node] < e.weight ||
                    (scores[node] == e.weight && predecessors[node] != -1 &&
                     scores[predecessors[node]] <= scores[e.src])) {
                    scores[node] = e.weight;
                    predecessors[node] = e.src;
                }
            }
            if (predecessors[node] != -1) scores[node] += scores[predecessors[node]];
            if (scores[max_score_id] < scores[node]) max_score_id = node;
        }

        int64_t guard = 0;
        while (!out_edges[max_score_id].empty()) {
            max_score_id =
                branch_completion(scores, predecessors, node_to_rank[max_score_id]);
            if (++guard > n) return false;
        }

        consensus.clear();
        while (predecessors[max_score_id] != -1) {
            consensus.push_back(max_score_id);
            max_score_id = predecessors[max_score_id];
        }
        consensus.push_back(max_score_id);
        std::reverse(consensus.begin(), consensus.end());
        return true;
    }
};

// Linear-gap NW sequence-to-graph aligner; faithful port of
// PoaAlignmentEngine.align (same traceback preferences: diagonal with
// predecessors in edge order, then deletion, then insertion). Scores are
// int32 (window-scale weights can't overflow) and the row update uses
// per-letter match/mismatch profiles so -O3 can vectorize it.
struct PoaAligner {
    int32_t match, mismatch, gap;
    std::vector<int32_t> H;  // (n_rows) x (n+1), reused across calls
    std::vector<int32_t> profiles;  // per distinct letter, [n] each
    int32_t prof_letter[256];

    const int32_t* profile(const uint8_t* seq, int64_t n, uint8_t letter) {
        if (prof_letter[letter] < 0) {
            prof_letter[letter] = (int32_t)(profiles.size() / n);
            size_t base = profiles.size();
            profiles.resize(base + n);
            for (int64_t j = 0; j < n; ++j) {
                profiles[base + j] = seq[j] == letter ? match : mismatch;
            }
        }
        return &profiles[(size_t)prof_letter[letter] * n];
    }

    bool align(const uint8_t* seq, int64_t n, const PoaGraph& g,
               std::vector<std::pair<int32_t, int32_t>>& out) {
        out.clear();
        if (g.letters.empty() || n == 0) return true;

        const auto& ranks = g.rank_to_node;
        int64_t n_rows = (int64_t)ranks.size() + 1;
        int64_t stride = n + 1;
        H.resize(n_rows * stride);
        for (int64_t j = 0; j <= n; ++j) H[j] = (int32_t)(j * gap);
        profiles.clear();
        std::fill(std::begin(prof_letter), std::end(prof_letter), -1);

        std::vector<int32_t> pred_rows;
        for (int64_t r = 1; r < n_rows; ++r) {
            int32_t node = ranks[r - 1];
            const int32_t* prof = profile(seq, n, g.letters[node]);
            int32_t* row = &H[r * stride];

            pred_rows.clear();
            if (g.in_edges[node].empty()) {
                pred_rows.push_back(0);
            } else {
                for (int32_t ei : g.in_edges[node]) {
                    pred_rows.push_back(g.node_to_rank[g.edges[ei].src] + 1);
                }
            }

            const int32_t* pr = &H[(int64_t)pred_rows[0] * stride];
            row[0] = pr[0] + gap;
            row_update_pred<true>(row, pr, prof, n, gap);
            for (size_t pi = 1; pi < pred_rows.size(); ++pi) {
                pr = &H[(int64_t)pred_rows[pi] * stride];
                if (pr[0] + gap > row[0]) row[0] = pr[0] + gap;
                row_update_pred<false>(row, pr, prof, n, gap);
            }
            row_gap_scan(row, n, gap);
        }

        // Best end node (no out-edges) at the last column; first rank wins.
        int64_t max_i = -1;
        int64_t max_score = kNegInf;
        for (int64_t r = 1; r < n_rows; ++r) {
            if (g.out_edges[ranks[r - 1]].empty() &&
                H[r * stride + n] > max_score) {
                max_score = H[r * stride + n];
                max_i = r;
            }
        }
        if (max_i == -1) max_i = n_rows - 1;

        int64_t i = max_i, j = n;
        while (!(i == 0 && j == 0)) {
            int32_t h_ij = H[i * stride + j];
            int64_t prev_i = -1, prev_j = -1;
            bool found = false;
            if (i != 0 && j != 0) {
                int32_t node = ranks[i - 1];
                int32_t cost =
                    (g.letters[node] == seq[j - 1]) ? match : mismatch;
                pred_rows.clear();
                if (g.in_edges[node].empty()) {
                    pred_rows.push_back(0);
                } else {
                    for (int32_t ei : g.in_edges[node]) {
                        pred_rows.push_back(g.node_to_rank[g.edges[ei].src] + 1);
                    }
                }
                for (int32_t pi : pred_rows) {
                    if (h_ij == H[(int64_t)pi * stride + j - 1] + cost) {
                        prev_i = pi;
                        prev_j = j - 1;
                        found = true;
                        break;
                    }
                }
            }
            if (!found && i != 0) {
                int32_t node = ranks[i - 1];
                pred_rows.clear();
                if (g.in_edges[node].empty()) {
                    pred_rows.push_back(0);
                } else {
                    for (int32_t ei : g.in_edges[node]) {
                        pred_rows.push_back(g.node_to_rank[g.edges[ei].src] + 1);
                    }
                }
                for (int32_t pi : pred_rows) {
                    if (h_ij == H[(int64_t)pi * stride + j] + gap) {
                        prev_i = pi;
                        prev_j = j;
                        found = true;
                        break;
                    }
                }
            }
            if (!found && j != 0 && h_ij == H[i * stride + j - 1] + gap) {
                prev_i = i;
                prev_j = j - 1;
                found = true;
            }
            if (!found) return false;  // inconsistent matrix
            out.emplace_back(i == prev_i ? -1 : ranks[i - 1],
                             j == prev_j ? -1 : (int32_t)(j - 1));
            i = prev_i;
            j = prev_j;
        }
        std::reverse(out.begin(), out.end());
        return true;
    }
};

struct WindowTask {
    const uint8_t* const* seqs;
    const int64_t* lens;
    const uint8_t* const* quals;  // nullptr entries = no quality
    const int64_t* begins;
    const int64_t* ends;
    int64_t n_seqs;
    int64_t win_id, win_rank;
    bool is_tgs;
};

void weights_of(const uint8_t* qual, int64_t len, std::vector<int64_t>& w) {
    w.resize(len);
    if (qual == nullptr) {
        std::fill(w.begin(), w.end(), 1);
    } else {
        for (int64_t i = 0; i < len; ++i) w[i] = (int64_t)qual[i] - 33;
    }
}

// Faithful port of Window.generate_consensus (window.cpp:65-142 semantics).
bool window_consensus(const WindowTask& t, int64_t match, int64_t mismatch,
                      int64_t gap, bool trim, std::string& out) {
    if (t.n_seqs < 3) {
        out.assign((const char*)t.seqs[0], t.lens[0]);
        return false;
    }

    PoaGraph graph;
    PoaAligner aligner{(int32_t)match, (int32_t)mismatch, (int32_t)gap,
                       {}, {}, {}};
    std::vector<int64_t> weights;
    std::vector<std::pair<int32_t, int32_t>> aln;

    weights_of(t.quals[0], t.lens[0], weights);
    graph.add_alignment({}, t.seqs[0], t.lens[0], weights.data());

    std::vector<int64_t> order(t.n_seqs - 1);
    for (int64_t i = 0; i < t.n_seqs - 1; ++i) order[i] = i + 1;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return t.begins[a] < t.begins[b];
    });

    int64_t backbone_len = t.lens[0];
    int64_t offset = (int64_t)(0.01 * (double)backbone_len);
    for (int64_t i : order) {
        weights_of(t.quals[i], t.lens[i], weights);
        if (t.begins[i] < offset && t.ends[i] > backbone_len - offset) {
            if (!aligner.align(t.seqs[i], t.lens[i], graph, aln)) return false;
        } else {
            PoaGraph sub;
            std::vector<int32_t> mapping;
            graph.subgraph((int32_t)t.begins[i], (int32_t)t.ends[i], sub,
                           mapping);
            if (!aligner.align(t.seqs[i], t.lens[i], sub, aln)) return false;
            for (auto& p : aln) {
                if (p.first != -1) p.first = mapping[p.first];
            }
        }
        graph.add_alignment(aln, t.seqs[i], t.lens[i], weights.data());
    }

    std::vector<int32_t> consensus_nodes;
    if (!graph.traverse_heaviest_bundle(consensus_nodes)) return false;

    std::string consensus;
    consensus.reserve(consensus_nodes.size());
    std::vector<int64_t> coverages;
    coverages.reserve(consensus_nodes.size());
    std::vector<int32_t> scratch;
    for (int32_t nid : consensus_nodes) {
        consensus += (char)graph.letters[nid];
        int64_t cov = graph.node_coverage(nid, scratch);
        for (int32_t aid : graph.aligned[nid]) {
            cov += graph.node_coverage(aid, scratch);
        }
        coverages.push_back(cov);
    }

    if (t.is_tgs && trim) {
        int64_t average_coverage = (t.n_seqs - 1) / 2;
        int64_t begin = 0, end = (int64_t)consensus.size() - 1;
        while (begin < (int64_t)consensus.size() &&
               coverages[begin] < average_coverage) {
            ++begin;
        }
        while (end >= 0 && coverages[end] < average_coverage) --end;
        if (begin >= end) {
            std::fprintf(stderr,
                         "[racon_tpu::Window::generate_consensus] warning: "
                         "contig %lld might be chimeric in window %lld!\n",
                         (long long)t.win_id, (long long)t.win_rank);
        } else {
            consensus = consensus.substr(begin, end - begin + 1);
        }
    }

    out = std::move(consensus);
    return true;
}

}  // namespace

extern "C" {

// Batched window consensus over a thread pool.  Sequences are flat arrays
// window-major (backbone first, then layers in insertion order);
// has_qual[i]==0 makes quals[i] treated as absent.  Returns per-window
// malloc'd consensus strings (caller frees via rt_free) and polished
// flags.  status_out[w]=1 on internal inconsistency (caller should fall
// back to the Python engine for that window).
void rt_poa_consensus_batch(
        int64_t n_windows, const int64_t* win_first_seq,
        const uint8_t* const* seqs, const int64_t* lens,
        const uint8_t* const* quals, const uint8_t* has_qual,
        const int64_t* begins, const int64_t* ends,
        const int64_t* win_ids, const int64_t* win_ranks,
        const uint8_t* win_is_tgs, int32_t trim, int64_t match,
        int64_t mismatch, int64_t gap, int64_t num_threads,
        char** consensus_out, int64_t* consensus_len_out,
        uint8_t* polished_out, uint8_t* status_out) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<const uint8_t*> wq;
        while (true) {
            int64_t w = next.fetch_add(1);
            if (w >= n_windows) break;
            int64_t first = win_first_seq[w];
            int64_t count = win_first_seq[w + 1] - first;
            wq.assign(count, nullptr);
            for (int64_t i = 0; i < count; ++i) {
                wq[i] = has_qual[first + i] ? quals[first + i] : nullptr;
            }
            WindowTask t{seqs + first, lens + first, wq.data(),
                         begins + first, ends + first, count,
                         win_ids[w], win_ranks[w], win_is_tgs[w] != 0};
            std::string consensus;
            bool ok = true;
            bool polished = false;
            polished = window_consensus(t, match, mismatch, gap, trim != 0,
                                        consensus);
            if (!polished && count >= 3 && consensus.empty()) ok = false;
            status_out[w] = ok ? 0 : 1;
            polished_out[w] = polished ? 1 : 0;
            char* buf = (char*)std::malloc(consensus.size() + 1);
            if (buf == nullptr) {  // OOM: flag the window for Python fallback
                status_out[w] = 1;
                polished_out[w] = 0;
                consensus_out[w] = nullptr;
                consensus_len_out[w] = 0;
                continue;
            }
            std::memcpy(buf, consensus.data(), consensus.size());
            buf[consensus.size()] = '\0';
            consensus_out[w] = buf;
            consensus_len_out[w] = (int64_t)consensus.size();
        }
    };
    int64_t nt = std::max<int64_t>(1, std::min(num_threads, n_windows));
    std::vector<std::thread> threads;
    for (int64_t i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

}  // extern "C"
