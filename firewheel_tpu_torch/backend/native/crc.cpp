// FLAC frame CRCs at C speed (flac spec: CRC-8 poly 0x07, CRC-16 poly
// 0x8005, both init 0, no reflection).  The pure-Python table loop in
// core/flac.py measured ~5 ms per 8 kB frame during encode — a quarter
// of the whole FLAC encode budget; here it is table-driven
// bytes at memory speed.  Loaded through the same native library as the
// ring buffer / LPC kernels (backend/ring_buffer.py::_load_native).
#include <cstddef>
#include <cstdint>

namespace {

struct Tables {
    uint8_t crc8[256];
    uint16_t crc16[256];
    Tables() {
        for (int i = 0; i < 256; ++i) {
            uint32_t c8 = static_cast<uint32_t>(i);
            uint32_t c16 = static_cast<uint32_t>(i) << 8;
            for (int b = 0; b < 8; ++b) {
                c8 = (c8 & 0x80u) ? ((c8 << 1) ^ 0x07u) : (c8 << 1);
                c16 = (c16 & 0x8000u) ? ((c16 << 1) ^ 0x8005u) : (c16 << 1);
            }
            crc8[i] = static_cast<uint8_t>(c8 & 0xFFu);
            crc16[i] = static_cast<uint16_t>(c16 & 0xFFFFu);
        }
    }
};

const Tables &tables() {
    static const Tables t;
    return t;
}

}  // namespace

extern "C" {

uint32_t flac_crc8(const uint8_t *data, size_t n, uint32_t init) {
    const Tables &t = tables();
    uint8_t c = static_cast<uint8_t>(init);
    for (size_t i = 0; i < n; ++i) c = t.crc8[c ^ data[i]];
    return c;
}

uint32_t flac_crc16(const uint8_t *data, size_t n, uint32_t init) {
    const Tables &t = tables();
    uint16_t c = static_cast<uint16_t>(init);
    for (size_t i = 0; i < n; ++i)
        c = static_cast<uint16_t>(t.crc16[((c >> 8) ^ data[i]) & 0xFFu] ^
                                  (c << 8));
    return c;
}

}  // extern "C"
