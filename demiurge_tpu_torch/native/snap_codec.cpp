// Native fixed-accuracy snapshot codec for undo diffs and checkpoints.
//
// Plays the role of the reference's zfp compression of texture snapshots
// (TextureData, src/Texture.cpp:123-181: zfp stream at accuracy 1e-6 run
// on a detached thread).  The format here is simpler and tuned for the
// data we actually store — *diffs* of terrain edits, which are zero
// almost everywhere and spatially smooth where non-zero:
//
//   value -> quantize q = llround(v / accuracy)       (uniform, like zfp's
//                                                      fixed-accuracy mode)
//         -> delta against previous quantized value   (spatial predictor)
//         -> zigzag                                    (sign fold)
//         -> LEB128 varint                             (tiny for small deltas)
//
// A zero-region becomes a run of 0x00 bytes, which the caller's zlib pass
// (native/snapc.py) collapses to nothing.  Round-trip error
// is bounded by accuracy/2 per element, matching zfp's contract.
//
// The port's own copy of demiurge_tpu/native/snap_codec.cpp (the same
// format, so a blob from either package decodes in the other), compiled
// by demiurge_tpu_torch/native/build.py.  C ABI for ctypes; no external
// dependencies.

#include <cstdint>
#include <cmath>

namespace {

inline int64_t quantize(float v, float accuracy) {
    return (int64_t)llroundf(v / accuracy);
}

inline uint64_t zigzag(int64_t v) {
    return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}

inline int64_t unzigzag(uint64_t u) {
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
}

}  // namespace

extern "C" {

// Worst-case encoded size for n floats (10 varint bytes each).
int64_t dmg_snap_bound(int64_t n) { return 10 * n + 8; }

// Encode n floats into out (capacity cap). Returns bytes written, or -1 if
// the buffer is too small.
int64_t dmg_snap_encode(const float* data, int64_t n, float accuracy,
                        uint8_t* out, int64_t cap) {
    int64_t pos = 0;
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t q = quantize(data[i], accuracy);
        uint64_t u = zigzag(q - prev);
        prev = q;
        do {
            if (pos >= cap) return -1;
            uint8_t byte = (uint8_t)(u & 0x7f);
            u >>= 7;
            out[pos++] = (uint8_t)(byte | (u ? 0x80 : 0));
        } while (u);
    }
    return pos;
}

// Decode exactly n floats from in (nbytes long). Returns n on success,
// -1 on truncated/overlong input.
int64_t dmg_snap_decode(const uint8_t* in, int64_t nbytes, float accuracy,
                        float* out, int64_t n) {
    int64_t pos = 0;
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t u = 0;
        int shift = 0;
        for (;;) {
            if (pos >= nbytes || shift > 63) return -1;
            uint8_t byte = in[pos++];
            u |= (uint64_t)(byte & 0x7f) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
        }
        prev += unzigzag(u);
        out[i] = (float)prev * accuracy;
    }
    return (pos == nbytes) ? n : -1;
}

}  // extern "C"
