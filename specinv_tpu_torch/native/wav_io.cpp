// Native WAV codec of specinv_tpu_torch.io.
//
// A minimal RIFF/WAVE reader and writer: PCM16 / PCM24 / PCM32 / IEEE
// float32 decode to interleaved float32, and float32 / PCM16 encode.
// specinv_tpu_torch.io compiles it with g++ into a shared object under
// build/specinv_tpu_torch/ at first use and drives it through ctypes; the
// same module holds a numpy codec with identical semantics for hosts
// without a compiler.
//
// Little-endian hosts only (x86-64 / aarch64).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Reader {
  FILE* f;
  explicit Reader(const char* path) : f(std::fopen(path, "rb")) {}
  ~Reader() {
    if (f) std::fclose(f);
  }
  bool read(void* dst, size_t n) { return f && std::fread(dst, 1, n, f) == n; }
  bool skip(long n) { return f && std::fseek(f, n, SEEK_CUR) == 0; }
};

struct FmtChunk {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
};

// Walk the RIFF chunks to the fmt and data chunks.  Returns 0 on success and
// leaves the stream positioned at the start of the data payload.
int locate(Reader& r, FmtChunk* fmt, uint32_t* data_bytes) {
  char id[4];
  uint32_t sz;
  if (!r.read(id, 4) || std::memcmp(id, "RIFF", 4) != 0) return -2;
  if (!r.read(&sz, 4)) return -2;
  if (!r.read(id, 4) || std::memcmp(id, "WAVE", 4) != 0) return -2;
  bool have_fmt = false;
  while (r.read(id, 4) && r.read(&sz, 4)) {
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (sz < 16 || !r.read(buf, 16)) return -3;
      std::memcpy(&fmt->format, buf + 0, 2);
      std::memcpy(&fmt->channels, buf + 2, 2);
      std::memcpy(&fmt->sample_rate, buf + 4, 4);
      std::memcpy(&fmt->bits, buf + 14, 2);
      if (fmt->format == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
        if (sz < 40) return -3;
        uint8_t ext[24];
        if (!r.read(ext, 24)) return -3;
        std::memcpy(&fmt->format, ext + 8, 2);  // first 2 bytes of SubFormat
        sz -= 24;
      }
      if (!r.skip(static_cast<long>(sz) - 16 + (sz & 1))) return -3;
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      if (!have_fmt) return -4;
      *data_bytes = sz;
      return 0;
    } else {
      if (!r.skip(static_cast<long>(sz) + (sz & 1))) return -5;
    }
  }
  return -6;
}

}  // namespace

extern "C" {

// Probe: fills frames / channels / sample_rate / bits / format.
// Returns 0 on success, negative error codes otherwise.
int wav_info(const char* path, int64_t* frames, int32_t* channels,
             int32_t* sample_rate, int32_t* bits, int32_t* format) {
  Reader r(path);
  if (!r.f) return -1;
  FmtChunk fmt;
  uint32_t data_bytes = 0;
  int rc = locate(r, &fmt, &data_bytes);
  if (rc) return rc;
  if (fmt.channels == 0 || fmt.bits == 0 || fmt.bits % 8 != 0) return -7;
  *channels = fmt.channels;
  *sample_rate = static_cast<int32_t>(fmt.sample_rate);
  *bits = fmt.bits;
  *format = fmt.format;
  *frames = static_cast<int64_t>(data_bytes) / (fmt.channels * (fmt.bits / 8));
  return 0;
}

// Decode the whole data chunk into interleaved float32 in [-1, 1).
// `out` must hold frames * channels floats (use wav_info first).
int wav_read_f32(const char* path, float* out, int64_t max_samples) {
  Reader r(path);
  if (!r.f) return -1;
  FmtChunk fmt;
  uint32_t data_bytes = 0;
  int rc = locate(r, &fmt, &data_bytes);
  if (rc) return rc;
  const int bytes = fmt.bits / 8;
  if (bytes < 1 || bytes > 4) return -7;
  int64_t n = static_cast<int64_t>(data_bytes) / bytes;
  if (n > max_samples) n = max_samples;

  const size_t kBlock = 4096;
  uint8_t buf[4 * kBlock];
  int64_t done = 0;
  while (done < n) {
    size_t take = static_cast<size_t>(n - done) < kBlock
                      ? static_cast<size_t>(n - done)
                      : kBlock;
    if (!r.read(buf, take * bytes)) return -8;
    if (fmt.format == 3 && fmt.bits == 32) {  // IEEE float
      std::memcpy(out + done, buf, take * 4);
    } else if (fmt.format == 1 && fmt.bits == 16) {
      const int16_t* p = reinterpret_cast<const int16_t*>(buf);
      for (size_t i = 0; i < take; ++i)
        out[done + i] = static_cast<float>(p[i]) * (1.0f / 32768.0f);
    } else if (fmt.format == 1 && fmt.bits == 24) {
      for (size_t i = 0; i < take; ++i) {
        const uint8_t* b = buf + 3 * i;
        int32_t v = (b[0] << 8) | (b[1] << 16) |
                    (static_cast<int32_t>(static_cast<int8_t>(b[2])) << 24);
        out[done + i] = static_cast<float>(v) * (1.0f / 2147483648.0f);
      }
    } else if (fmt.format == 1 && fmt.bits == 32) {
      const int32_t* p = reinterpret_cast<const int32_t*>(buf);
      for (size_t i = 0; i < take; ++i)
        out[done + i] = static_cast<float>(p[i]) * (1.0f / 2147483648.0f);
    } else {
      return -9;  // unsupported (PCM8, ALaw, ...)
    }
    done += take;
  }
  return 0;
}

// Encode interleaved float32.  pcm16=1 clips to [-1, 1] and quantizes;
// pcm16=0 writes IEEE float32 verbatim.
int wav_write_f32(const char* path, const float* data, int64_t frames,
                  int32_t channels, int32_t sample_rate, int32_t pcm16) {
  const int bytes = pcm16 ? 2 : 4;
  // RIFF sizes are uint32: audio past 4 GiB would silently wrap and write a
  // corrupt header — reject it instead (wrappers raise ValueError).
  const int64_t total = frames * static_cast<int64_t>(channels) * bytes;
  if (total < 0 || total > static_cast<int64_t>(UINT32_MAX) - 36) return -10;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_bytes = static_cast<uint32_t>(total);
  const uint16_t fmt_tag = pcm16 ? 1 : 3;
  const uint16_t bits = pcm16 ? 16 : 32;
  const uint32_t byte_rate = sample_rate * channels * bytes;
  const uint16_t block_align = static_cast<uint16_t>(channels * bytes);
  const uint32_t riff_size = 36 + data_bytes;

  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  std::memcpy(hdr + 4, &riff_size, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  std::memcpy(hdr + 16, &fmt_size, 4);
  std::memcpy(hdr + 20, &fmt_tag, 2);
  uint16_t ch16 = static_cast<uint16_t>(channels);
  std::memcpy(hdr + 22, &ch16, 2);
  std::memcpy(hdr + 24, &sample_rate, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block_align, 2);
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_bytes, 4);
  if (std::fwrite(hdr, 1, 44, f) != 44) {
    std::fclose(f);
    return -2;
  }

  int64_t n = frames * channels;
  int rc = 0;
  if (pcm16) {
    const size_t kBlock = 4096;
    int16_t buf[kBlock];
    int64_t done = 0;
    while (done < n) {
      size_t take = static_cast<size_t>(n - done) < kBlock
                        ? static_cast<size_t>(n - done)
                        : kBlock;
      for (size_t i = 0; i < take; ++i) {
        float v = data[done + i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        float scaled = v * 32767.0f;
        buf[i] = static_cast<int16_t>(scaled >= 0 ? scaled + 0.5f
                                                  : scaled - 0.5f);
      }
      if (std::fwrite(buf, 2, take, f) != take) {
        rc = -2;
        break;
      }
      done += take;
    }
  } else {
    if (std::fwrite(data, 4, static_cast<size_t>(n), f) !=
        static_cast<size_t>(n))
      rc = -2;
  }
  if (std::fclose(f) != 0 && rc == 0) rc = -3;
  return rc;
}

}  // extern "C"
