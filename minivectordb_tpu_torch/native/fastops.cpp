// Native fast ops for the rerank and WAL paths (host side): the port's own
// copy of the JAX package's native/fastops.cpp, with the same entry points.
#include <unistd.h>
//
// Replaces the C layers the reference pulls in via pip:
//   - sklearn's murmurhash/HashingVectorizer (reference vector_database.py:9)
//     -> mvdb_hash_ngrams: signed murmur3 char-ngram feature hashing
//   - python-Levenshtein / thefuzz partial_ratio (vector_database.py:411)
//     -> mvdb_partial_ratio: best-window Indel similarity, bit-parallel LCS
//
// Both operate on UTF-8 input decoded to Unicode codepoints so results match
// the pure-Python paths in rerank/hashing.py and rerank/fuzzy.py exactly.
//
// Built at first use by native/build.py (g++ -O3 -shared -fPIC
// -ffp-contract=off), or ahead with python -m minivectordb_tpu_torch.native.build

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// murmur3 x86_32 (Austin Appleby, public domain)
// ---------------------------------------------------------------------------
static uint32_t rotl32(uint32_t x, int8_t r) { return (x << r) | (x >> (32 - r)); }

static uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  const int nblocks = (int)(len / 4);
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + i * 4, 4);
    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2;
    h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5 + 0xe6546b64;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8;  [[fallthrough]];
    case 1: k1 ^= tail[0];
            k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint32_t)len;
  h1 ^= h1 >> 16; h1 *= 0x85ebca6b; h1 ^= h1 >> 13; h1 *= 0xc2b2ae35; h1 ^= h1 >> 16;
  return h1;
}

// UTF-8 -> codepoint byte offsets (so ngrams slice original bytes cleanly)
static void utf8_offsets(const uint8_t* s, int64_t len, std::vector<int64_t>& off) {
  off.clear();
  int64_t i = 0;
  while (i < len) {
    off.push_back(i);
    uint8_t c = s[i];
    if (c < 0x80) i += 1;
    else if ((c >> 5) == 0x6) i += 2;
    else if ((c >> 4) == 0xe) i += 3;
    else if ((c >> 3) == 0x1e) i += 4;
    else i += 1;  // invalid byte: advance
  }
  off.push_back(len);
}

// Signed char-ngram feature hashing (caller lowercases + normalizes).
void mvdb_hash_ngrams(const char* text, int64_t len, int n_features,
                      int nmin, int nmax, double* out) {
  const uint8_t* s = (const uint8_t*)text;
  std::vector<int64_t> off;
  utf8_offsets(s, len, off);
  int64_t n = (int64_t)off.size() - 1;  // number of codepoints
  for (int size = nmin; size <= nmax && size <= n; size++) {
    for (int64_t i = 0; i + size <= n; i++) {
      const uint8_t* start = s + off[i];
      size_t blen = (size_t)(off[i + size] - off[i]);
      uint32_t h = murmur3_32(start, blen, 0);
      int32_t signed_h = (int32_t)h;
      int64_t idx = (signed_h < 0 ? -(int64_t)signed_h : (int64_t)signed_h) % n_features;
      out[idx] += (signed_h >= 0) ? 1.0 : -1.0;
    }
  }
}

// ---------------------------------------------------------------------------
// Indel distance via Hyyro's bit-parallel LCS; partial_ratio window slide
// ---------------------------------------------------------------------------
static void utf8_codepoints(const uint8_t* s, int64_t len, std::vector<uint32_t>& cps) {
  cps.clear();
  int64_t i = 0;
  while (i < len) {
    uint8_t c = s[i];
    uint32_t cp; int step;
    if (c < 0x80) { cp = c; step = 1; }
    else if ((c >> 5) == 0x6 && i + 1 < len) { cp = ((c & 0x1f) << 6) | (s[i+1] & 0x3f); step = 2; }
    else if ((c >> 4) == 0xe && i + 2 < len) { cp = ((c & 0x0f) << 12) | ((s[i+1] & 0x3f) << 6) | (s[i+2] & 0x3f); step = 3; }
    else if ((c >> 3) == 0x1e && i + 3 < len) { cp = ((c & 0x07) << 18) | ((s[i+1] & 0x3f) << 12) | ((s[i+2] & 0x3f) << 6) | (s[i+3] & 0x3f); step = 4; }
    else { cp = c; step = 1; }
    cps.push_back(cp);
    i += step;
  }
}

// LCS length of a (any length) vs b (len <= 64), bit-parallel.
static int lcs_bp64(const std::vector<uint32_t>& a, const uint32_t* b, int blen,
                    std::unordered_map<uint32_t, uint64_t>& peq) {
  peq.clear();
  for (int i = 0; i < blen; i++) peq[b[i]] |= (1ULL << i);
  uint64_t full = (blen == 64) ? ~0ULL : ((1ULL << blen) - 1);
  uint64_t v = full;
  for (uint32_t ch : a) {
    auto it = peq.find(ch);
    uint64_t m = (it == peq.end()) ? 0 : it->second;
    uint64_t u = v & m;
    v = ((v + u) | (v - u)) & full;
  }
  return blen - __builtin_popcountll(v);
}

// DP LCS for long needles
static int lcs_dp(const std::vector<uint32_t>& a, const uint32_t* b, int blen) {
  std::vector<int> prev(blen + 1, 0), cur(blen + 1, 0);
  for (size_t i = 0; i < a.size(); i++) {
    for (int j = 0; j < blen; j++)
      cur[j + 1] = (a[i] == b[j]) ? prev[j] + 1 : std::max(prev[j + 1], cur[j]);
    std::swap(prev, cur);
  }
  return prev[blen];
}

static double indel_ratio(const std::vector<uint32_t>& a, const uint32_t* b, int blen,
                          std::unordered_map<uint32_t, uint64_t>& peq) {
  int64_t lensum = (int64_t)a.size() + blen;
  if (lensum == 0) return 1.0;
  int lcs = (blen <= 64) ? lcs_bp64(a, b, blen, peq) : lcs_dp(a, b, blen);
  int64_t dist = (int64_t)a.size() + blen - 2 * lcs;
  return (double)(lensum - dist) / (double)lensum;
}

int mvdb_partial_ratio(const char* s1, int64_t l1, const char* s2, int64_t l2) {
  std::vector<uint32_t> a, b;
  utf8_codepoints((const uint8_t*)s1, l1, a);
  utf8_codepoints((const uint8_t*)s2, l2, b);
  if (a == b) return 100;
  if (a.empty() || b.empty()) return 0;
  const std::vector<uint32_t>& shorter = (a.size() <= b.size()) ? a : b;
  const std::vector<uint32_t>& longer = (a.size() <= b.size()) ? b : a;
  int m = (int)shorter.size();
  int n = (int)longer.size();
  std::unordered_map<uint32_t, uint64_t> peq;
  double best = 0.0;
  // Slide every window (exhaustive, as rerank/fuzzy.py does: cheap at
  // rerank sizes and strictly better than a matching-blocks heuristic).
  for (int start = 0; start + m <= n; start++) {
    double r = indel_ratio(shorter, longer.data() + start, m, peq);
    if (r > best) best = r;
    if (best > 0.995) return 100;
  }
  // also consider truncated edge windows when shorter ~ longer length
  if (m > n) {
    double r = indel_ratio(shorter, longer.data(), n, peq);
    if (r > best) best = r;
  }
  int v = (int)(best * 100.0 + 0.5);
  return v > 100 ? 100 : v;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Write-ahead log support: CRC32-framed append (storage fast path).
// Record layout: [magic 'MVDW' u32][payload_len u64 LE][crc32 u32 LE][payload]
// ---------------------------------------------------------------------------
#include <cstdio>

extern "C" {

struct Crc32Table {
  uint32_t v[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      v[i] = c;
    }
  }
};

uint32_t mvdb_crc32(const uint8_t* data, int64_t len) {
  // a function-local static is built once, safely, by whichever thread
  // comes first (the sharded database appends from several threads)
  static const Crc32Table table;
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < len; i++)
    c = table.v[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Append one framed record; returns 0 on success, negative errno-style code.
int mvdb_wal_append(const char* path, const uint8_t* data, int64_t len,
                    int do_fsync) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  const uint32_t magic = 0x5744564Du;  // 'MVDW' little-endian
  uint64_t ulen = (uint64_t)len;
  uint32_t crc = mvdb_crc32(data, len);
  int ok = 1;
  ok &= std::fwrite(&magic, 4, 1, f) == 1;
  ok &= std::fwrite(&ulen, 8, 1, f) == 1;
  ok &= std::fwrite(&crc, 4, 1, f) == 1;
  ok &= len == 0 || std::fwrite(data, 1, (size_t)len, f) == (size_t)len;
  if (ok) std::fflush(f);
#ifndef _WIN32
  if (ok && do_fsync) {
    // fileno + fsync for durability
    ok &= fsync(fileno(f)) == 0;
  }
#endif
  std::fclose(f);
  return ok ? 0 : -2;
}

}  // extern "C"
