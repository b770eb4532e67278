// Native IO tier: TFRecord codec + threaded deterministic fill.
//
// The reference's native tier is vendored comms/kernels (Horovod/NCCL/MPI,
// SURVEY.md §2a); on TPU the collectives belong to XLA, so the native
// layer that actually earns its keep is the HOST side of the data path —
// the part that must outrun the accelerator (SURVEY.md §7 hard part (a)):
//
//   * crc32c (Castagnoli, slicing-by-8) + the TFRecord masking rule
//   * TFRecord framing: batched record append, and a full-file
//     index/verify scan (offset+length per payload) that lets a reader
//     mmap/seek instead of streaming through a framework graph — also
//     gives an O(file) record *count* with no protobuf parsing
//     (imagenet.py's length counting otherwise iterates tf.data)
//   * ddl_fill_uniform_f32: splitmix64 counter-mode fill — each element
//     is hash(seed + index), so the result is bit-identical for any
//     thread count, and identical to the pure-Python/numpy fallback
//     (distributeddeeplearning_tpu_torch/native/__init__.py)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Build: ops/_build.build("ddl_native") (the host C++ compiler, HOST_FLAGS).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32c
// Castagnoli polynomial 0x1EDC6F41 (reflected 0x82F63B78), slicing-by-8.
uint32_t kCrcTable[8][256];
bool kCrcInit = []() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = kCrcTable[0][i];
    for (int t = 1; t < 8; t++) {
      c = kCrcTable[0][c & 0xff] ^ (c >> 8);
      kCrcTable[t][i] = c;
    }
  }
  return true;
}();

uint32_t Crc32c(const uint8_t* p, size_t n, uint32_t crc = 0) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    crc ^= static_cast<uint32_t>(v);
    uint32_t hi = static_cast<uint32_t>(v >> 32);
    crc = kCrcTable[7][crc & 0xff] ^ kCrcTable[6][(crc >> 8) & 0xff] ^
          kCrcTable[5][(crc >> 16) & 0xff] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][hi & 0xff] ^ kCrcTable[2][(hi >> 8) & 0xff] ^
          kCrcTable[1][(hi >> 16) & 0xff] ^ kCrcTable[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = kCrcTable[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

// TFRecord's CRC mask (tensorflow/core/lib/hash/crc32c.h semantics).
inline uint32_t MaskCrc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ------------------------------------------------------------- splitmix64
inline uint64_t SplitMix64(uint64_t x) {
  uint64_t z = x + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

uint32_t ddl_crc32c(const uint8_t* data, uint64_t n) { return Crc32c(data, n); }

uint32_t ddl_masked_crc32c(const uint8_t* data, uint64_t n) {
  return MaskCrc(Crc32c(data, n));
}

// Append `n_records` framed records to `path` (create/truncate unless
// `append`). `buf` holds the concatenated payloads; `lens[i]` their sizes.
// Returns 0, or -2 on IO error.
int ddl_tfrecord_write(const char* path, const uint8_t* buf,
                       const uint64_t* lens, uint64_t n_records, int append) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -2;
  uint64_t off = 0;
  for (uint64_t i = 0; i < n_records; i++) {
    uint8_t header[12];
    uint64_t len = lens[i];
    std::memcpy(header, &len, 8);  // little-endian (TPU/x86 hosts)
    uint32_t len_crc = MaskCrc(Crc32c(header, 8));
    std::memcpy(header + 8, &len_crc, 4);
    uint32_t data_crc = MaskCrc(Crc32c(buf + off, len));
    if (std::fwrite(header, 1, 12, f) != 12 ||
        std::fwrite(buf + off, 1, len, f) != len ||
        std::fwrite(&data_crc, 1, 4, f) != 4) {
      std::fclose(f);
      return -2;
    }
    off += len;
  }
  if (std::fclose(f) != 0) return -2;
  return 0;
}

// Scan a TFRecord file. Fills payload `offsets`/`lengths` (up to
// `capacity` entries; pass 0/NULL to only count). `verify` checks both
// CRCs per record. Returns the record count, -1 on framing/CRC error,
// -2 on IO error.
int64_t ddl_tfrecord_index(const char* path, uint64_t* offsets,
                           uint64_t* lengths, uint64_t capacity, int verify) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -2;
  // File size bounds every record length: a corrupt/garbage length field
  // must fail cleanly, not hang (negative fseek loop) or throw from
  // vector::resize across the C ABI.
  if (std::fseek(f, 0, SEEK_END) != 0) {
    std::fclose(f);
    return -2;
  }
  const uint64_t file_size = static_cast<uint64_t>(std::ftell(f));
  std::rewind(f);
  int64_t count = 0;
  uint64_t pos = 0;
  std::vector<uint8_t> payload;
  for (;;) {
    uint8_t header[12];
    size_t got = std::fread(header, 1, 12, f);
    if (got == 0) break;  // clean EOF
    if (got != 12) {
      std::fclose(f);
      return -1;
    }
    uint64_t len;
    std::memcpy(&len, header, 8);
    if (len > file_size - (pos + 12) || len + 4 > file_size - (pos + 12)) {
      std::fclose(f);
      return -1;  // length field runs past EOF: corrupt framing
    }
    if (verify) {
      uint32_t stored;
      std::memcpy(&stored, header + 8, 4);
      if (MaskCrc(Crc32c(header, 8)) != stored) {
        std::fclose(f);
        return -1;
      }
    }
    uint64_t payload_off = pos + 12;
    uint8_t footer[4];
    if (verify) {
      payload.resize(len);
      if (std::fread(payload.data(), 1, len, f) != len ||
          std::fread(footer, 1, 4, f) != 4) {
        std::fclose(f);
        return -1;
      }
      uint32_t stored;
      std::memcpy(&stored, footer, 4);
      if (MaskCrc(Crc32c(payload.data(), len)) != stored) {
        std::fclose(f);
        return -1;
      }
    } else {
      if (std::fseek(f, static_cast<long>(len + 4), SEEK_CUR) != 0) {
        std::fclose(f);
        return -1;
      }
    }
    if (offsets && static_cast<uint64_t>(count) < capacity) {
      offsets[count] = payload_off;
      lengths[count] = len;
    }
    pos = payload_off + len + 4;
    count++;
  }
  std::fclose(f);
  return count;
}

// out[i] = float32 in [0, 1) derived from SplitMix64(seed + i) — counter
// mode, so any thread count produces identical bits.
void ddl_fill_uniform_f32(float* out, uint64_t n, uint64_t seed,
                          int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [out, seed](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++) {
      uint32_t bits = static_cast<uint32_t>(SplitMix64(seed + i) >> 32);
      out[i] = static_cast<float>(bits) * (1.0f / 4294967296.0f);
    }
  };
  if (n_threads == 1 || n < 1u << 16) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  uint64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    uint64_t lo = static_cast<uint64_t>(t) * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
