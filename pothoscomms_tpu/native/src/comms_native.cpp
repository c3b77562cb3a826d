// Native runtime kernels for pothoscomms_tpu.
//
// The device compute path is JAX/XLA; these C++ kernels cover the genuinely
// bit-serial host-side paths that neither XLA nor numpy vectorize:
// the Galois LFSR keystream and the self-synchronizing (multiplicative)
// scrambler/descrambler recursions (reference: digital/lfsr.h:64-100,
// digital/Scrambler.cpp:137-152, digital/Descrambler.cpp:137-151), the
// CRC8 used by the MAC (mac/MacHelper.hpp:18-32), and the rotate-add
// checksum8 (digital/FrameHelper.hpp:18-27).
//
// Built as a plain C ABI shared library (ctypes-loaded); no Python.h
// dependency.

#include <cstdint>
#include <cstddef>

extern "C" {

struct GLfsrState {
    uint64_t data;
    uint64_t polynomial;  // with the implicit +1 term OR'd in
    uint64_t mask;        // highest set bit of the polynomial
};

// reference: digital/lfsr.h GLFSR_init
void glfsr_init(GLfsrState *s, uint64_t polynomial, uint64_t seed) {
    s->polynomial = polynomial | 1ull;
    s->data = seed;
    s->mask = 0;
    for (int shift = 63; shift >= 0; --shift) {
        if (polynomial & (1ull << shift)) {
            s->mask = 1ull << shift;
            break;
        }
    }
}

// Additive keystream: out[i] = GLFSR_next(), state updated in place.
void glfsr_keystream(GLfsrState *s, uint8_t *out, size_t n) {
    uint64_t data = s->data;
    const uint64_t mask = s->mask, poly = s->polynomial;
    for (size_t i = 0; i < n; ++i) {
        data <<= 1;
        if (data & mask) {
            data ^= poly;
            out[i] = 1;
        } else {
            out[i] = 0;
        }
    }
    s->data = data;
}

// Multiplicative scrambler: out = in ^ ks; OUTPUT bit becomes lfsr bit0
// (reference: Scrambler.cpp multiplicative_bit_work).
void scramble_mult(GLfsrState *s, const uint8_t *in, uint8_t *out, size_t n) {
    uint64_t data = s->data;
    const uint64_t mask = s->mask, poly = s->polynomial;
    for (size_t i = 0; i < n; ++i) {
        data <<= 1;
        uint8_t ks = 0;
        if (data & mask) {
            data ^= poly;
            ks = 1;
        }
        const uint8_t o = (in[i] & 1u) ^ ks;
        data = (data & ~1ull) | o;
        out[i] = o;
    }
    s->data = data;
}

// Multiplicative descrambler: INPUT bit becomes lfsr bit0
// (reference: Descrambler.cpp multiplicative_bit_work).
void descramble_mult(GLfsrState *s, const uint8_t *in, uint8_t *out, size_t n) {
    uint64_t data = s->data;
    const uint64_t mask = s->mask, poly = s->polynomial;
    for (size_t i = 0; i < n; ++i) {
        data <<= 1;
        uint8_t ks = 0;
        if (data & mask) {
            data ^= poly;
            ks = 1;
        }
        const uint8_t bit = in[i] & 1u;
        out[i] = bit ^ ks;
        data = (data & ~1ull) | bit;
    }
    s->data = data;
}

// CRC-8, x^8 + x^2 + x + 1 (reference: mac/MacHelper.hpp:18-32)
uint8_t crc8(const uint8_t *data, size_t len) {
    unsigned crc = 0;
    for (size_t j = 0; j < len; ++j) {
        crc ^= (unsigned)data[j] << 8;
        for (int i = 8; i; --i) {
            if (crc & 0x8000u) crc ^= (0x1070u << 3);
            crc <<= 1;
        }
    }
    return (uint8_t)(crc >> 8);
}

// rotate-add checksum8 (reference: digital/FrameHelper.hpp:18-27)
uint8_t checksum8(const uint8_t *p, size_t len) {
    uint8_t acc = 0;
    for (size_t i = 0; i < len; ++i) {
        acc = (uint8_t)((acc >> 1) + ((acc & 0x1u) << 7));
        acc = (uint8_t)(acc + p[i]);
    }
    return acc;
}

// Envelope follower (reference: filter/EnvelopeDetector.cpp:131-143) —
// strictly sequential one-pole with per-sample attack/release branch;
// the host fallback when the block runs outside a fused device chain.
void envelope_follow(const float *xabs, float *out, size_t n,
                     float *envelope, float attack_gain, float release_gain) {
    float env = *envelope;
    for (size_t i = 0; i < n; ++i) {
        const float xn = xabs[i];
        const float g = (xn > env) ? attack_gain : release_gain;
        env = g * env + (1.0f - g) * xn;
        out[i] = env;
    }
    *envelope = env;
}

}  // extern "C"
