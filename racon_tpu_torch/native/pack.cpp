// The device aligner's upload blocks, written in one pass from a chunk's
// sequences (racon_tpu_torch/ops/nw.py pack_chunk). The JAX package builds
// the same bytes with numpy in four passes over the padded chunk: a dense
// byte block of B * max_len, a histogram, a lookup table and the pack
// (racon_tpu/ops/nw.py, the chunk launcher; racon_tpu/ops/swar.py
// pack_bases_2bit). Here a read-only scan of the sequences finds the
// chunk's alphabet, and one pass over them writes every byte of the block,
// padding included, so the caller may hand in uninitialised (pinned)
// memory.
//
// Block layout: pair k's codes start at code k * max_len; `bits` is 2
// (four codes a byte, the first in the low bits), 4 (two a byte, low
// nibble first) or 8 (one a byte). Every code past a pair's length, and
// every code of the slots past the C sequences, is 0.

#include <cstdint>
#include <cstring>

extern "C" {

// seen[v] = 1 for every byte value v of p[0..n)
void rt_byte_presence(const uint8_t* p, int64_t n, uint8_t* seen) {
    for (int64_t i = 0; i < n; ++i) seen[p[i]] = 1;
}

// C sequences concatenated in `flat` (lengths `lens`) into B slots of
// max_len codes: code = lut[byte] (bits 2 and 4; bits 8 copies the bytes).
// `out` holds B * max_len * bits / 8 bytes. Returns 0, or -1 when the
// arguments cannot describe such a block (a length above max_len, a
// max_len not a whole number of bytes, C > B).
int rt_pack_block(const uint8_t* flat, const int32_t* lens, int64_t C,
                  int64_t B, int64_t max_len, const uint8_t* lut, int bits,
                  uint8_t* out) {
    if ((bits != 2 && bits != 4 && bits != 8) || C > B || C < 0
        || (max_len * bits) % 8 != 0)
        return -1;
    const int64_t slot = max_len * bits / 8;
    const uint8_t* src = flat;
    for (int64_t k = 0; k < C; ++k) {
        const int64_t len = lens[k];
        if (len < 0 || len > max_len) return -1;
        uint8_t* dst = out + k * slot;
        int64_t w = 0;   // bytes of the slot written
        if (bits == 8) {
            std::memcpy(dst, src, static_cast<size_t>(len));
            w = len;
        } else if (bits == 4) {
            int64_t j = 0;
            for (; j + 2 <= len; j += 2)
                dst[w++] = static_cast<uint8_t>(lut[src[j]]
                                                | (lut[src[j + 1]] << 4));
            if (j < len) dst[w++] = lut[src[j]];
        } else {
            int64_t j = 0;
            for (; j + 4 <= len; j += 4)
                dst[w++] = static_cast<uint8_t>(
                    lut[src[j]] | (lut[src[j + 1]] << 2)
                    | (lut[src[j + 2]] << 4) | (lut[src[j + 3]] << 6));
            if (j < len) {
                uint8_t b = 0;
                for (int s = 0; j < len; ++j, s += 2)
                    b = static_cast<uint8_t>(b | (lut[src[j]] << s));
                dst[w++] = b;
            }
        }
        std::memset(dst + w, 0, static_cast<size_t>(slot - w));
        src += len;
    }
    std::memset(out + C * slot, 0, static_cast<size_t>((B - C) * slot));
    return 0;
}

}  // extern "C"
