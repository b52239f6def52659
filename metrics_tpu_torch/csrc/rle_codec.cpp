// COCO RLE codec hot loops, C ABI for ctypes (built and loaded by metrics_tpu_torch/ops/_native.py).
//
// A host library, not a CUDA kernel: the run lengths are found on the masks'
// device (metrics_tpu_torch/detection/rle.py), and only the byte-level loops
// are native: the LEB128-style compressed-counts string codec and the
// run-expansion behind rle_to_mask. The plain Python versions of all three,
// in detection/rle.py, are the tests' oracle.

#include <cstdint>
#include <cstddef>

extern "C" {

// Encode run lengths into the COCO compressed string form.
// counts[n] -> out bytes; returns number of bytes written (out must hold 13*n:
// an int64 value spans at most 13 five-bit groups).
long long rle_compress_counts(const long long* counts, long long n, unsigned char* out) {
    long long pos = 0;
    for (long long i = 0; i < n; ++i) {
        long long x = counts[i];
        if (i > 2) x -= counts[i - 2];  // delta against two back, from the third on
        bool more = true;
        while (more) {
            long long bits = x & 0x1f;
            x >>= 5;
            more = !((x == 0 && !(bits & 0x10)) || (x == -1 && (bits & 0x10)));
            if (more) bits |= 0x20;
            out[pos++] = (unsigned char)(bits + 48);
        }
    }
    return pos;
}

// Decode the compressed string form back into run lengths.
// data[len] -> counts_out; returns number of counts (counts_out must hold len),
// or -1 for a malformed value wider than 13 5-bit groups (the int64 maximum —
// anything the matching compressor can emit decodes back; shifts run in
// unsigned arithmetic so even the 13th group's overflow past bit 63 is
// well-defined wraparound, mirroring the Python fallback's masked bigints).
long long rle_decompress_counts(const unsigned char* data, long long len, long long* counts_out) {
    long long n = 0;
    long long pos = 0;
    while (pos < len) {
        unsigned long long x = 0;
        int k = 0;
        bool more = true;
        while (more && pos < len) {
            if (k >= 13) return -1;
            unsigned long long byte = (unsigned long long)data[pos] - 48;
            if (5 * k < 64) x |= (byte & 0x1f) << (5 * k);
            more = (byte & 0x20) != 0;
            ++pos;
            ++k;
            if (!more && (byte & 0x10) && 5 * k < 64) x |= ~0ULL << (5 * k);
        }
        long long v = (long long)x;
        if (n > 2) v += counts_out[n - 2];
        counts_out[n++] = v;
    }
    return n;
}

// Expand run lengths into a column-major binary plane (one mask).
// Returns 0 on success, -1 if runs do not sum to h*w.
int rle_expand(const long long* counts, long long n, long long hw, unsigned char* plane) {
    long long idx = 0;
    unsigned char val = 0;
    for (long long i = 0; i < n; ++i) {
        long long run = counts[i];
        if (idx + run > hw) return -1;
        for (long long j = 0; j < run; ++j) plane[idx++] = val;
        val = 1 - val;
    }
    return idx == hw ? 0 : -1;
}

}  // extern "C"
