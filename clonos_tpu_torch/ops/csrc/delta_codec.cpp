// Host-side hot path of the determinant-delta wire codec
// (clonos_tpu_torch/causal/serde.py): CRC-32 over packed int32 row blocks
// and bulk FLAT frame assembly. This is host C++, not a device kernel: the
// frames leave the process over TCP, so their bytes are made on the host.
// The port's own copy of the reference's native/delta_codec.cpp, with the
// same C interface and the same output bytes.
//
// Build: c++ -O3 -shared -fPIC -o libdelta_codec.so delta_codec.cpp
// (clonos_tpu_torch/ops/native.py builds it at first use into
// build/clonos_tpu_torch/ and falls back to a bit-identical zlib path
// when no compiler is available).

#include <cstdint>
#include <cstring>

extern "C" {

// CRC-32 (IEEE 802.3, zlib-compatible) with a table built once.
static uint32_t table[256];
static bool table_ready = false;

static void build_table() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        table[i] = c;
    }
    table_ready = true;
}

uint32_t dc_crc32(const uint8_t* data, uint64_t n) {
    if (!table_ready) build_table();
    uint32_t c = 0xFFFFFFFFu;
    for (uint64_t i = 0; i < n; i++)
        c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// Assemble a FLAT delta entry stream in one pass: for each entry i, write
// `log_ids[i] (i32) | starts[i] (i32) | n_rows[i] (u32) | rows | crc`.
// `rows_concat` holds the row blocks back to back (int32, `lanes` per
// row). Returns the bytes written, or -1 if `out_cap` is too small.
int64_t dc_encode_flat(const int32_t* log_ids, const int32_t* starts,
                       const uint32_t* n_rows, int32_t count,
                       const int32_t* rows_concat, int32_t lanes,
                       uint8_t* out, int64_t out_cap) {
    int64_t pos = 0;
    const int32_t* rp = rows_concat;
    for (int32_t i = 0; i < count; i++) {
        uint64_t nb = (uint64_t)n_rows[i] * lanes * 4;
        if (pos + 12 + (int64_t)nb + 4 > out_cap) return -1;
        std::memcpy(out + pos, &log_ids[i], 4);
        std::memcpy(out + pos + 4, &starts[i], 4);
        std::memcpy(out + pos + 8, &n_rows[i], 4);
        pos += 12;
        std::memcpy(out + pos, rp, nb);
        uint32_t crc = dc_crc32(out + pos, nb);
        pos += (int64_t)nb;
        std::memcpy(out + pos, &crc, 4);
        pos += 4;
        rp += (uint64_t)n_rows[i] * lanes;
    }
    return pos;
}

}  // extern "C"
