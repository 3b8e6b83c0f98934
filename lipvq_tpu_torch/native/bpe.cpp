// Native BPE trainer/encoder/decoder for the PRISE/FAST action-token paths
// of lipvq_tpu_torch: lipvq_tpu/native/bpe.cpp's rules, so both packages
// fit the same merges and read each other's serialized vocabularies. The
// trainer keeps its pair counts current as it merges instead of recounting
// every word at every merge; the merges it picks are the same.
//
// Equivalent of the HF `tokenizers` Rust BPE used by the
// reference (reference: robomimic/models/prise/backbone.py:8-53;
// SURVEY.md §2.4 calls for a C++ BPE with identical merges). Semantics
// mirror tokenizers' BpeTrainer over whitespace-pre-tokenized words:
//  - word (frequency) counting over the corpus
//  - initial vocab: special tokens, then the sorted character alphabet
//  - iterative best-pair merging: highest pair count wins, ties broken by
//    (earlier-created left symbol, then earlier-created right symbol) —
//    matching tokenizers' ordering so merge tables line up
//  - min_frequency and max_token_length constraints
// Encoding applies merges by rank (lowest rank first).
//
// C API (extern "C") consumed via ctypes from
// lipvq_tpu_torch/models/tokenizers/prise.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <queue>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// UTF-8 iteration: split a string into codepoint-level chunks.
std::vector<std::string> utf8_chars(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t len = 1;
    if ((c & 0x80) == 0x00) len = 1;
    else if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    out.push_back(s.substr(i, len));
    i += len;
  }
  return out;
}

size_t utf8_len(const std::string& s) { return utf8_chars(s).size(); }

struct Word {
  std::vector<int32_t> syms;  // token ids into vocab
  int64_t count = 0;
};

struct BPE {
  std::vector<std::string> vocab;              // id -> token string
  std::unordered_map<std::string, int32_t> vocab_index;
  // merge rank: (left id, right id) -> (rank, new id)
  std::map<std::pair<int32_t, int32_t>, std::pair<int32_t, int32_t>> merges;
  int32_t unk_id = -1;

  int32_t intern(const std::string& tok) {
    auto it = vocab_index.find(tok);
    if (it != vocab_index.end()) return it->second;
    int32_t id = (int32_t)vocab.size();
    vocab.push_back(tok);
    vocab_index.emplace(tok, id);
    return id;
  }

  void train(const std::vector<std::string>& words_in,
             const std::vector<int64_t>& counts_in, int32_t vocab_size,
             int64_t min_frequency, int32_t max_token_length) {
    vocab.clear();
    vocab_index.clear();
    merges.clear();
    unk_id = intern("[UNK]");

    // alphabet: sorted unique characters across the corpus
    std::map<std::string, int64_t> alpha;
    for (size_t w = 0; w < words_in.size(); ++w)
      for (auto& ch : utf8_chars(words_in[w])) alpha[ch] += counts_in[w];
    for (auto& kv : alpha) intern(kv.first);

    std::vector<Word> words(words_in.size());
    for (size_t w = 0; w < words_in.size(); ++w) {
      words[w].count = counts_in[w];
      for (auto& ch : utf8_chars(words_in[w]))
        words[w].syms.push_back(vocab_index[ch]);
    }

    // Adjacent-pair counts, kept current as merges rewrite words: each merge
    // visits only the words that hold its pair. `holders` lists, per pair,
    // the words that held it when it was counted (a word may be listed twice
    // or after it lost the pair). `queue` orders (count, pair) entries by
    // count, then by the smaller pair, the rule of a full rescan (highest
    // count; tie -> smaller left id, then smaller right id); an entry whose
    // count is no longer the pair's is skipped.
    using Pair = std::pair<int32_t, int32_t>;
    using Entry = std::pair<int64_t, Pair>;
    std::map<Pair, int64_t> pair_counts;
    std::map<Pair, std::vector<int32_t>> holders;
    auto lower = [](const Entry& a, const Entry& b) {
      return a.first != b.first ? a.first < b.first : a.second > b.second;
    };
    std::priority_queue<Entry, std::vector<Entry>, decltype(lower)> queue(lower);
    auto eligible = [&](const Pair& p) {
      return max_token_length <= 0 ||
             (int32_t)(utf8_len(vocab[p.first]) + utf8_len(vocab[p.second])) <=
                 max_token_length;
    };
    for (size_t w = 0; w < words.size(); ++w) {
      auto& s = words[w].syms;
      for (size_t i = 0; i + 1 < s.size(); ++i) {
        pair_counts[{s[i], s[i + 1]}] += words[w].count;
        holders[{s[i], s[i + 1]}].push_back((int32_t)w);
      }
    }
    for (auto& kv : pair_counts)
      if (kv.second > 0 && eligible(kv.first)) queue.push({kv.second, kv.first});

    std::vector<int32_t> recounted(words.size(), -1);  // rank of the last visit
    int32_t rank = 0;
    while ((int32_t)vocab.size() < vocab_size) {
      Pair best{-1, -1};
      int64_t best_count = 0;
      while (!queue.empty()) {
        Entry top = queue.top();
        queue.pop();
        auto it = pair_counts.find(top.second);
        if (it != pair_counts.end() && it->second == top.first) {
          best = top.second;
          best_count = top.first;
          break;
        }
      }
      if (best.first < 0 || best_count < min_frequency) break;

      std::string merged = vocab[best.first] + vocab[best.second];
      int32_t new_id = intern(merged);
      merges[best] = {rank, new_id};

      // apply the merge to every word that holds the pair; the counts change
      // only around each merged occurrence (prev a b next -> prev n next,
      // prev being the rewritten symbol before it)
      std::vector<int32_t> words_of_best;
      words_of_best.swap(holders[best]);
      std::map<Pair, int64_t> changed;
      auto add = [&](const Pair& p, int64_t delta, int32_t w) {
        changed[p] += delta;
        if (delta > 0) holders[p].push_back(w);
      };
      std::vector<int32_t> out;
      for (int32_t w : words_of_best) {
        if (recounted[w] == rank) continue;
        recounted[w] = rank;
        auto& s = words[w].syms;
        const int64_t c = words[w].count;
        out.clear();
        for (size_t i = 0; i < s.size();) {
          if (i + 1 < s.size() && s[i] == best.first && s[i + 1] == best.second) {
            if (!out.empty()) {
              add({out.back(), best.first}, -c, w);
              add({out.back(), new_id}, c, w);
            }
            add(best, -c, w);
            if (i + 2 < s.size()) {
              add({best.second, s[i + 2]}, -c, w);
              add({new_id, s[i + 2]}, c, w);
            }
            out.push_back(new_id);
            i += 2;
          } else {
            out.push_back(s[i++]);
          }
        }
        s.assign(out.begin(), out.end());
      }
      for (auto& kv : changed) {
        if (kv.second == 0) continue;
        int64_t& count = pair_counts[kv.first];
        count += kv.second;
        if (count > 0 && eligible(kv.first)) queue.push({count, kv.first});
      }
      ++rank;
    }
  }

  std::vector<int32_t> encode_word(const std::string& word) const {
    std::vector<int32_t> syms;
    for (auto& ch : utf8_chars(word)) {
      auto it = vocab_index.find(ch);
      syms.push_back(it == vocab_index.end() ? unk_id : it->second);
    }
    // iteratively apply the lowest-rank applicable merge
    while (syms.size() >= 2) {
      int32_t best_rank = INT32_MAX;
      size_t best_i = 0;
      int32_t best_new = -1;
      for (size_t i = 0; i + 1 < syms.size(); ++i) {
        auto it = merges.find({syms[i], syms[i + 1]});
        if (it != merges.end() && it->second.first < best_rank) {
          best_rank = it->second.first;
          best_i = i;
          best_new = it->second.second;
        }
      }
      if (best_new < 0) break;
      syms[best_i] = best_new;
      syms.erase(syms.begin() + best_i + 1);
    }
    return syms;
  }

  std::string decode(const std::vector<int32_t>& ids) const {
    std::string out;
    for (size_t k = 0; k < ids.size(); ++k) {
      if (ids[k] < 0 || ids[k] >= (int32_t)vocab.size()) continue;
      out += vocab[ids[k]];
    }
    return out;
  }

  std::string serialize() const {
    std::ostringstream os;
    os << vocab.size() << "\n";
    for (auto& v : vocab) os << v << "\n";
    os << merges.size() << "\n";
    for (auto& kv : merges)
      os << kv.first.first << " " << kv.first.second << " "
         << kv.second.first << " " << kv.second.second << "\n";
    return os.str();
  }

  void deserialize(const std::string& blob) {
    vocab.clear();
    vocab_index.clear();
    merges.clear();
    std::istringstream is(blob);
    size_t n;
    is >> n;
    is.ignore();
    for (size_t i = 0; i < n; ++i) {
      std::string line;
      std::getline(is, line);
      int32_t id = intern(line);
      (void)id;
    }
    is >> n;
    for (size_t i = 0; i < n; ++i) {
      int32_t a, b, r, nid;
      is >> a >> b >> r >> nid;
      merges[{a, b}] = {r, nid};
    }
    unk_id = vocab_index.count("[UNK]") ? vocab_index["[UNK]"] : -1;
  }
};

std::vector<std::string> split_ws(const std::string& text) {
  std::vector<std::string> out;
  std::istringstream is(text);
  std::string w;
  while (is >> w) out.push_back(w);
  return out;
}

}  // namespace

extern "C" {

void* bpe_new() { return new BPE(); }
void bpe_free(void* h) { delete (BPE*)h; }

// corpus: whitespace-separated words in one buffer
void bpe_train(void* h, const char* corpus, int32_t vocab_size,
               int64_t min_frequency, int32_t max_token_length) {
  auto words = split_ws(corpus);
  std::map<std::string, int64_t> counts;
  for (auto& w : words) counts[w] += 1;
  std::vector<std::string> uw;
  std::vector<int64_t> uc;
  for (auto& kv : counts) {
    uw.push_back(kv.first);
    uc.push_back(kv.second);
  }
  ((BPE*)h)->train(uw, uc, vocab_size, min_frequency, max_token_length);
}

int32_t bpe_vocab_size(void* h) { return (int32_t)((BPE*)h)->vocab.size(); }

// encode text -> out_ids (caller-allocated, capacity cap); returns count
int32_t bpe_encode(void* h, const char* text, int32_t* out_ids, int32_t cap) {
  auto words = split_ws(text);
  int32_t n = 0;
  for (auto& w : words) {
    for (int32_t id : ((BPE*)h)->encode_word(w)) {
      if (n < cap) out_ids[n] = id;
      ++n;
    }
  }
  return n;
}

// decode ids -> out buffer; returns byte length
int32_t bpe_decode(void* h, const int32_t* ids, int32_t n, char* out,
                   int32_t cap) {
  std::vector<int32_t> v(ids, ids + n);
  std::string s = ((BPE*)h)->decode(v);
  int32_t len = (int32_t)s.size();
  if (len < cap) {
    std::memcpy(out, s.data(), len);
    out[len] = 0;
  }
  return len;
}

// token string for id -> out buffer; returns byte length (or -1)
int32_t bpe_token(void* h, int32_t id, char* out, int32_t cap) {
  BPE* b = (BPE*)h;
  if (id < 0 || id >= (int32_t)b->vocab.size()) return -1;
  const std::string& s = b->vocab[id];
  int32_t len = (int32_t)s.size();
  if (len < cap) {
    std::memcpy(out, s.data(), len);
    out[len] = 0;
  }
  return len;
}

int32_t bpe_serialize(void* h, char* out, int32_t cap) {
  std::string s = ((BPE*)h)->serialize();
  int32_t len = (int32_t)s.size();
  if (len < cap) {
    std::memcpy(out, s.data(), len);
    out[len] = 0;
  }
  return len;
}

void bpe_deserialize(void* h, const char* blob) {
  ((BPE*)h)->deserialize(blob);
}

}  // extern "C"
