/* SHA-512 message padding for the verify launches, in C (reference:
 * tendermint_tpu/native/pack.c, the same function).
 *
 * One pass over the flattened messages: a memcpy a lane, the 0x80
 * terminator and the 128-bit big-endian bit length at the end of the
 * lane's final block, with `prefix_len` fixed bytes (R||A = 64)
 * assumed prepended on the device. It replaces the numpy scatter of
 * crypto/cuda/sha512.py pad_messages for batches of 256 messages or
 * more; host packing runs ahead of every K4 launch and every
 * bytes-form K3 launch.
 *
 * Caller contract (tendermint_tpu_torch/native/__init__.py):
 *   - out is zero-initialized, n rows of `width` bytes
 *   - width >= max(nblocks)*128 - prefix_len
 *   - bit lengths fit 64 bits (messages far below 2^61 bytes)
 */

#include <stdint.h>
#include <string.h>

void tm_pack_pad(const uint8_t *flat, const int64_t *starts,
                 const int64_t *lens, int64_t n, int64_t width,
                 int64_t prefix_len, uint8_t *out, int64_t *nblocks)
{
    for (int64_t i = 0; i < n; i++) {
        int64_t len = lens[i];
        uint8_t *row = out + i * width;
        memcpy(row, flat + starts[i], (size_t)len);
        row[len] = 0x80;
        int64_t total = len + prefix_len;
        int64_t nb = (total + 1 + 16 + 127) / 128;
        nblocks[i] = nb;
        uint64_t bitlen = (uint64_t)total * 8u;
        int64_t end = nb * 128 - prefix_len;
        for (int k = 0; k < 8; k++)
            row[end - 1 - k] = (uint8_t)(bitlen >> (8 * k));
    }
}
