/* CRC-framed history-log codec: the native hot path behind the port's
 * store/format.py (a copy of jepsen_tpu/native/jlog.c).
 *
 * Capability reference: the reference's store layer pairs Clojure with
 * native-code codecs (jepsen/src/jepsen/store/FressianReader.java,
 * FileOffsetOutputStream.java) for exactly this job: fast, offset-
 * tracked scanning and writing of the block-structured history file
 * (store/format.clj:36-200). Here the format is simpler — magic +
 * [u32 len][u32 crc32(payload)][payload] records — and this codec
 * provides C-speed record scanning (offset table + torn-tail
 * detection) and batch framing for writers.
 *
 * Build: gcc/g++ -O2 -shared -fPIC jlog.c -o jlog.so -lz
 */

#include <stdint.h>
#include <string.h>
#include <zlib.h>

#ifdef __cplusplus
extern "C" {
#endif


#define HDR 8 /* u32 len + u32 crc */

/* Scans framed records in buf[0..len). Writes up to max_records pairs
 * (payload_start, payload_end) into offsets (2*max_records int64s).
 * Returns the number of intact records found; *valid_end gets the byte
 * offset just past the last intact record. Scanning starts at `start`
 * (the caller skips the magic). A torn or corrupt tail stops the scan:
 * exactly the Python reader's crash-recovery rule. */
int64_t jlog_scan(const uint8_t *buf, int64_t len, int64_t start,
                  int64_t *offsets, int64_t max_records,
                  int64_t *valid_end) {
    int64_t pos = start;
    int64_t n = 0;
    *valid_end = start;
    while (pos + HDR <= len) {
        uint32_t plen, crc;
        memcpy(&plen, buf + pos, 4);
        memcpy(&crc, buf + pos + 4, 4);
        if (pos + HDR + (int64_t)plen > len)
            break; /* torn payload */
        uint32_t got = (uint32_t)crc32(0L, buf + pos + HDR, plen);
        if (got != crc)
            break; /* corrupt record */
        if (n < max_records) {
            offsets[2 * n] = pos + HDR;
            offsets[2 * n + 1] = pos + HDR + plen;
        }
        n++;
        pos += HDR + plen;
        *valid_end = pos;
    }
    return n;
}

/* Frames `count` payloads (concatenated in payloads, lengths in lens)
 * into out, which must hold sum(lens) + count*HDR bytes. Returns bytes
 * written. */
int64_t jlog_frame(const uint8_t *payloads, const int64_t *lens,
                   int64_t count, uint8_t *out) {
    int64_t in_pos = 0, out_pos = 0;
    for (int64_t i = 0; i < count; i++) {
        uint32_t plen = (uint32_t)lens[i];
        uint32_t crc = (uint32_t)crc32(0L, payloads + in_pos, plen);
        memcpy(out + out_pos, &plen, 4);
        memcpy(out + out_pos + 4, &crc, 4);
        memcpy(out + out_pos + HDR, payloads + in_pos, plen);
        in_pos += plen;
        out_pos += HDR + plen;
    }
    return out_pos;
}

#ifdef __cplusplus
}  /* extern "C" */
#endif
