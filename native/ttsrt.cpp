// ttsrt — native host-side streaming runtime for qwen3_tts_tpu.
//
// Counterpart of the reference's host runtime machinery: the
// decoder-thread + mpsc channel pipeline (reference src/tts/engine.rs:487-543),
// its 64-code chunk batching with remainder carry and [0,2047] clamping
// (engine.rs:510-537), f32->s16 WAV emission (src/utils/audio.rs:26-41), and
// — new surface — a continuous-batching slot manager for multi-stream
// serving. The device compute path stays in XLA; this library is the
// lock-minimal data path between device outputs and audio sinks so the
// Python dispatch thread never blocks on audio I/O.
//
// C ABI only (loaded via ctypes); no exceptions across the boundary.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ring buffer
// SPSC float PCM ring buffer: producer = generation thread pushing vocoder
// output, consumer = audio sink / network writer.
struct TtsrtRing {
  std::vector<float> buf;
  std::atomic<uint64_t> head{0};  // write index (producer)
  std::atomic<uint64_t> tail{0};  // read index (consumer)
};

TtsrtRing* ttsrt_ring_new(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  auto* r = new TtsrtRing();
  r->buf.resize(static_cast<size_t>(capacity));
  return r;
}

void ttsrt_ring_free(TtsrtRing* r) { delete r; }

int64_t ttsrt_ring_capacity(TtsrtRing* r) {
  return static_cast<int64_t>(r->buf.size());
}

int64_t ttsrt_ring_available(TtsrtRing* r) {
  return static_cast<int64_t>(r->head.load(std::memory_order_acquire) -
                              r->tail.load(std::memory_order_acquire));
}

// Returns samples actually pushed (may be < n when full).
int64_t ttsrt_ring_push(TtsrtRing* r, const float* samples, int64_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t cap = r->buf.size();
  const uint64_t free_n = cap - (head - tail);
  const uint64_t todo = n < 0 ? 0 : std::min<uint64_t>(n, free_n);
  for (uint64_t i = 0; i < todo; ++i) {
    r->buf[(head + i) % cap] = samples[i];
  }
  r->head.store(head + todo, std::memory_order_release);
  return static_cast<int64_t>(todo);
}

// Pop up to max_n samples as f32. Returns count popped.
int64_t ttsrt_ring_pop(TtsrtRing* r, float* out, int64_t max_n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t cap = r->buf.size();
  const uint64_t avail = head - tail;
  const uint64_t todo = max_n < 0 ? 0 : std::min<uint64_t>(max_n, avail);
  for (uint64_t i = 0; i < todo; ++i) {
    out[i] = r->buf[(tail + i) % cap];
  }
  r->tail.store(tail + todo, std::memory_order_release);
  return static_cast<int64_t>(todo);
}

// Pop with f32 -> s16 conversion using the reference clamp
// (src/utils/audio.rs:37: clamp(sample*32767, -32768, 32767)).
int64_t ttsrt_ring_pop_s16(TtsrtRing* r, int16_t* out, int64_t max_n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t cap = r->buf.size();
  const uint64_t avail = head - tail;
  const uint64_t todo = max_n < 0 ? 0 : std::min<uint64_t>(max_n, avail);
  for (uint64_t i = 0; i < todo; ++i) {
    float v = r->buf[(tail + i) % cap] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = static_cast<int16_t>(v);
  }
  r->tail.store(tail + todo, std::memory_order_release);
  return static_cast<int64_t>(todo);
}

// --------------------------------------------------------------- code chunker
// Accumulates generated codes and releases them in >=chunk_codes batches
// truncated to whole frames, clamped to [0, 2047], carrying the remainder —
// the exact batching policy of the reference decoder thread
// (src/tts/engine.rs:510-537).
struct TtsrtChunker {
  std::vector<int64_t> pending;
  int chunk_codes;   // 64
  int frame_codes;   // 16
};

TtsrtChunker* ttsrt_chunker_new(int chunk_codes, int frame_codes) {
  if (chunk_codes <= 0 || frame_codes <= 0) return nullptr;
  auto* c = new TtsrtChunker();
  c->chunk_codes = chunk_codes;
  c->frame_codes = frame_codes;
  return c;
}

void ttsrt_chunker_free(TtsrtChunker* c) { delete c; }

int64_t ttsrt_chunker_pending(TtsrtChunker* c) {
  return static_cast<int64_t>(c->pending.size());
}

// Push n codes; if a batch is ready (>= chunk_codes accumulated, or is_final),
// writes up to out_cap clamped codes into out and returns the count (a
// multiple of frame_codes). Returns 0 when nothing is ready yet.
int64_t ttsrt_chunker_push(TtsrtChunker* c, const int64_t* codes, int64_t n,
                           int is_final, int64_t* out, int64_t out_cap) {
  c->pending.insert(c->pending.end(), codes, codes + (n > 0 ? n : 0));
  const int64_t have = static_cast<int64_t>(c->pending.size());
  if (have < c->chunk_codes && !is_final) return 0;
  int64_t valid = (have / c->frame_codes) * c->frame_codes;
  if (valid > out_cap) valid = (out_cap / c->frame_codes) * c->frame_codes;
  if (valid <= 0) {
    if (is_final) c->pending.clear();
    return 0;
  }
  for (int64_t i = 0; i < valid; ++i) {
    int64_t v = c->pending[i];
    if (v < 0) v = 0;
    if (v > 2047) v = 2047;
    out[i] = v;
  }
  if (is_final) {
    c->pending.clear();
  } else {
    c->pending.erase(c->pending.begin(), c->pending.begin() + valid);
  }
  return valid;
}

// ----------------------------------------------------------------- wav writer
// Streaming-capable WAV writer: header patched on close.
int64_t ttsrt_wav_write(const char* path, const float* samples, int64_t n,
                        int sample_rate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_bytes = static_cast<uint32_t>(n * 2);
  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + data_bytes;
  std::memcpy(hdr + 4, &riff, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  std::memcpy(hdr + 16, &fmt_size, 4);
  uint16_t fmt_tag = 1, channels = 1, block = 2, bits = 16;
  uint32_t rate = sample_rate, byte_rate = rate * 2;
  std::memcpy(hdr + 20, &fmt_tag, 2);
  std::memcpy(hdr + 22, &channels, 2);
  std::memcpy(hdr + 24, &rate, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block, 2);
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_bytes, 4);
  if (std::fwrite(hdr, 1, 44, f) != 44) { std::fclose(f); return -1; }
  std::vector<int16_t> buf(4096);
  int64_t written = 0;
  while (written < n) {
    int64_t todo = std::min<int64_t>(n - written, buf.size());
    for (int64_t i = 0; i < todo; ++i) {
      float v = samples[written + i] * 32767.0f;
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32768.0f) v = -32768.0f;
      buf[i] = static_cast<int16_t>(v);
    }
    if (std::fwrite(buf.data(), 2, todo, f) != static_cast<size_t>(todo)) {
      std::fclose(f);
      return -1;
    }
    written += todo;
  }
  std::fclose(f);
  return written;
}

// ---------------------------------------------------------------- slot manager
// Continuous-batching bookkeeping for multi-stream serving: fixed device
// batch slots; streams acquire a slot, mark EOS, release. Thread-safe.
struct TtsrtSlots {
  std::mutex mu;
  std::vector<int8_t> state;     // 0=free, 1=active, 2=draining(eos)
  std::vector<int64_t> stream_id;
  std::vector<int64_t> frames;
  int64_t next_stream = 1;
};

TtsrtSlots* ttsrt_slots_new(int n_slots) {
  if (n_slots <= 0) return nullptr;
  auto* s = new TtsrtSlots();
  s->state.assign(n_slots, 0);
  s->stream_id.assign(n_slots, 0);
  s->frames.assign(n_slots, 0);
  return s;
}

void ttsrt_slots_free(TtsrtSlots* s) { delete s; }

// Returns slot index, or -1 when the batch is full. Assigns a stream id via
// out_stream_id.
int ttsrt_slots_acquire(TtsrtSlots* s, int64_t* out_stream_id) {
  std::lock_guard<std::mutex> lk(s->mu);
  for (size_t i = 0; i < s->state.size(); ++i) {
    if (s->state[i] == 0) {
      s->state[i] = 1;
      s->stream_id[i] = s->next_stream++;
      s->frames[i] = 0;
      if (out_stream_id) *out_stream_id = s->stream_id[i];
      return static_cast<int>(i);
    }
  }
  return -1;
}

int ttsrt_slots_mark_frames(TtsrtSlots* s, int slot, int64_t n_frames) {
  std::lock_guard<std::mutex> lk(s->mu);
  if (slot < 0 || slot >= static_cast<int>(s->state.size())) return -1;
  s->frames[slot] += n_frames;
  return 0;
}

int ttsrt_slots_mark_eos(TtsrtSlots* s, int slot) {
  std::lock_guard<std::mutex> lk(s->mu);
  if (slot < 0 || slot >= static_cast<int>(s->state.size())) return -1;
  if (s->state[slot] == 1) s->state[slot] = 2;
  return 0;
}

int ttsrt_slots_release(TtsrtSlots* s, int slot) {
  std::lock_guard<std::mutex> lk(s->mu);
  if (slot < 0 || slot >= static_cast<int>(s->state.size())) return -1;
  s->state[slot] = 0;
  s->stream_id[slot] = 0;
  return 0;
}

int ttsrt_slots_active(TtsrtSlots* s) {
  std::lock_guard<std::mutex> lk(s->mu);
  int n = 0;
  for (int8_t st : s->state) n += (st != 0);
  return n;
}

int64_t ttsrt_slots_frames(TtsrtSlots* s, int slot) {
  std::lock_guard<std::mutex> lk(s->mu);
  if (slot < 0 || slot >= static_cast<int>(s->state.size())) return -1;
  return s->frames[slot];
}

const char* ttsrt_version() { return "ttsrt 0.1.0"; }

}  // extern "C"
