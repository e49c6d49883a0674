// Fast BERT WordPiece tokenizer (C++), byte-identical to the Python
// implementation in nans_clip_tpu_torch/tokenizer.py (and the reference's
// cn_clip/clip/bert_tokenizer.py). Unicode behavior (categories, lowercase,
// NFD) comes from tables generated out of CPython's unicodedata
// (gen_unicode_tables.py), so there is no approximation.
//
// Used by the data loader for the hot text path: batch-encodes straight
// into a padded [N, context_length] int32 matrix ([CLS] ids... [SEP] pad).
//
// Built by data/fast_tokenizer.py on first use, into the git-ignored
// nans_clip_tpu_torch/build/ beside the generated unicode_tables.inc:
//   g++ -O2 -shared -fPIC -I build tokenizer.cpp -o build/libnanstok-<key>.so

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.inc"

namespace {

bool in_ranges(uint32_t cp, const uint32_t ranges[][2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < ranges[mid][0]) hi = mid;
    else if (cp > ranges[mid][1]) lo = mid + 1;
    else return true;
  }
  return false;
}

const uint32_t* map_lookup(uint32_t cp, const uint32_t* keys,
                           const uint32_t offsets[][2], const uint32_t* pool,
                           size_t n, size_t* out_len) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (keys[mid] < cp) lo = mid + 1;
    else hi = mid;
  }
  if (lo < n && keys[lo] == cp) {
    *out_len = offsets[lo][1];
    return pool + offsets[lo][0];
  }
  return nullptr;
}

bool is_whitespace(uint32_t cp) { return in_ranges(cp, kWhitespaceRanges, kWhitespaceCount); }
bool is_control(uint32_t cp) { return in_ranges(cp, kControlRanges, kControlCount); }
bool is_punct(uint32_t cp) { return in_ranges(cp, kPunctRanges, kPunctCount); }
bool is_mn(uint32_t cp) { return in_ranges(cp, kMnRanges, kMnCount); }
bool is_cased(uint32_t cp) { return in_ranges(cp, kCasedRanges, kCasedCount); }
bool is_case_ign(uint32_t cp) { return in_ranges(cp, kCaseignRanges, kCaseignCount); }
bool is_pyspace(uint32_t cp) { return in_ranges(cp, kPyspaceRanges, kPyspaceCount); }

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// UTF-8 decode: returns codepoints (invalid bytes dropped, like Python's
// errors="ignore").
std::vector<uint32_t> utf8_decode(const char* s, size_t len) {
  std::vector<uint32_t> out;
  out.reserve(len);
  size_t i = 0;
  while (i < len) {
    uint8_t b = s[i];
    uint32_t cp;
    size_t n;
    if (b < 0x80) { cp = b; n = 1; }
    else if ((b >> 5) == 0x6) { cp = b & 0x1F; n = 2; }
    else if ((b >> 4) == 0xE) { cp = b & 0x0F; n = 3; }
    else if ((b >> 3) == 0x1E) { cp = b & 0x07; n = 4; }
    else { i++; continue; }
    if (i + n > len) break;
    bool ok = true;
    for (size_t j = 1; j < n; ++j) {
      uint8_t c = s[i + j];
      if ((c >> 6) != 0x2) { ok = false; break; }
      cp = (cp << 6) | (c & 0x3F);
    }
    if (ok) out.push_back(cp);
    i += ok ? n : 1;
  }
  return out;
}

void utf8_encode(uint32_t cp, std::string* out) {
  if (cp < 0x80) out->push_back((char)cp);
  else if (cp < 0x800) {
    out->push_back((char)(0xC0 | (cp >> 6)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back((char)(0xE0 | (cp >> 12)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out->push_back((char)(0xF0 | (cp >> 18)));
    out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

struct Tok {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk = 100, cls = 101, sep = 102;
  int max_chars_per_word = 200;
};

// basic tokenization over codepoints -> list of words (each a cp vector)
std::vector<std::vector<uint32_t>> basic_tokenize(const std::vector<uint32_t>& cps) {
  // clean + CJK isolate + whitespace split (single pass)
  std::vector<std::vector<uint32_t>> words;
  std::vector<uint32_t> cur;
  auto flush = [&]() {
    if (!cur.empty()) { words.push_back(cur); cur.clear(); }
  };
  for (uint32_t cp : cps) {
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    // the Python tokenizer splits its cleaned text with str.split(), which
    // also breaks at U+2028 / U+2029 (isspace, but neither Zs nor C*)
    if (is_whitespace(cp) || is_pyspace(cp)) { flush(); continue; }
    if (is_cjk(cp)) { flush(); words.push_back({cp}); continue; }
    cur.push_back(cp);
  }
  flush();

  // lowercase + NFD-strip-Mn + punct split per word
  std::vector<std::vector<uint32_t>> out;
  for (auto& w : words) {
    std::vector<uint32_t> lowered;
    for (size_t i = 0; i < w.size(); ++i) {
      uint32_t cp = w[i];
      if (cp == 0x3A3) {
        // CPython str.lower applies the Unicode Final_Sigma rule: capital
        // sigma lowers to U+03C2 when preceded by a cased character (after
        // case-ignorables) and not followed by one; the per-codepoint
        // table alone would always produce U+03C3.
        bool before = false;
        for (size_t j = i; j-- > 0;) {
          if (is_case_ign(w[j])) continue;
          before = is_cased(w[j]);
          break;
        }
        bool after = false;
        for (size_t j = i + 1; j < w.size(); ++j) {
          if (is_case_ign(w[j])) continue;
          after = is_cased(w[j]);
          break;
        }
        lowered.push_back(before && !after ? 0x3C2 : 0x3C3);
        continue;
      }
      size_t n;
      const uint32_t* seq = map_lookup(cp, kLowerKeys, kLowerOffsets, kLowerPool,
                                       kLowerCount, &n);
      if (seq) lowered.insert(lowered.end(), seq, seq + n);
      else lowered.push_back(cp);
    }
    std::vector<uint32_t> stripped;
    for (uint32_t cp : lowered) {
      size_t n;
      const uint32_t* seq = map_lookup(cp, kNfdKeys, kNfdOffsets, kNfdPool,
                                       kNfdCount, &n);
      if (seq) {
        for (size_t j = 0; j < n; ++j)
          if (!is_mn(seq[j])) stripped.push_back(seq[j]);
      } else if (!is_mn(cp)) {
        stripped.push_back(cp);
      }
    }
    // split on punctuation
    std::vector<uint32_t> piece;
    for (uint32_t cp : stripped) {
      if (is_punct(cp)) {
        if (!piece.empty()) { out.push_back(piece); piece.clear(); }
        out.push_back({cp});
      } else {
        piece.push_back(cp);
      }
    }
    if (!piece.empty()) out.push_back(piece);
  }
  return out;
}

void wordpiece(const Tok& tok, const std::vector<uint32_t>& word,
               std::vector<int32_t>* ids) {
  if ((int)word.size() > tok.max_chars_per_word) {
    ids->push_back(tok.unk);
    return;
  }
  std::vector<int32_t> subs;
  size_t start = 0;
  const size_t n = word.size();
  while (start < n) {
    size_t end = n;
    int32_t piece = -1;
    while (start < end) {
      std::string cand;
      if (start > 0) cand = "##";
      for (size_t j = start; j < end; ++j) utf8_encode(word[j], &cand);
      auto it = tok.vocab.find(cand);
      if (it != tok.vocab.end()) { piece = it->second; break; }
      end--;
    }
    if (piece < 0) { ids->push_back(tok.unk); return; }
    subs.push_back(piece);
    start = end;
  }
  ids->insert(ids->end(), subs.begin(), subs.end());
}

}  // namespace

extern "C" {

Tok* tok_create(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* tok = new Tok();
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    // full python .strip(): trim str.isspace codepoints from both ends
    // (CRLF files, padded tokens, and the google vocab's U+2028 entry all
    // behave exactly like the python loader); duplicates resolve LAST-
    // wins like a python dict
    auto cps = utf8_decode(line.data(), line.size());
    size_t a = 0, b = cps.size();
    while (a < b && is_pyspace(cps[a])) ++a;
    while (b > a && is_pyspace(cps[b - 1])) --b;
    std::string tok_s;
    for (size_t i = a; i < b; ++i) utf8_encode(cps[i], &tok_s);
    tok->vocab[tok_s] = idx;
    idx++;
  }
  auto get = [&](const char* s, int32_t dflt) {
    auto it = tok->vocab.find(s);
    return it == tok->vocab.end() ? dflt : it->second;
  };
  tok->unk = get("[UNK]", 100);
  tok->cls = get("[CLS]", 101);
  tok->sep = get("[SEP]", 102);
  return tok;
}

void tok_destroy(Tok* tok) { delete tok; }

// Encode one text to raw wordpiece ids (no CLS/SEP). Returns count written
// (capped at max_out).
int32_t tok_encode(const Tok* tok, const char* text, int64_t text_len,
                   int32_t* out, int32_t max_out) {
  std::vector<int32_t> ids;
  auto words = basic_tokenize(utf8_decode(text, (size_t)text_len));
  for (auto& w : words) wordpiece(*tok, w, &ids);
  int32_t n = (int32_t)ids.size();
  if (n > max_out) n = max_out;
  memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// Batch encode into a padded [n, context_length] matrix with CLS/SEP framing
// (reference clip/utils.py:158-172 semantics).
void tok_encode_batch(const Tok* tok, const char** texts, const int64_t* lens,
                      int32_t n, int32_t context_length, int32_t* out) {
  for (int32_t i = 0; i < n; ++i) {
    int32_t* row = out + (int64_t)i * context_length;
    memset(row, 0, context_length * sizeof(int32_t));
    row[0] = tok->cls;
    int32_t m = tok_encode(tok, texts[i], lens[i], row + 1, context_length - 2);
    row[1 + m] = tok->sep;
  }
}

}  // extern "C"
