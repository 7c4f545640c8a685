// Native byte-level BPE tokenizer core.
//
// Drop-in accelerated implementation of qwen3_tpu/tokenizer/bpe.py with the
// same semantics as the reference C tokenizer (src/tokenizer.c:177-287):
// special-token "<...>" scan with byte fallback, then greedy highest-score
// adjacent merges to fixpoint, leftmost pair winning ties (the reference's
// strict '>' rescan). Where the reference does an O(V) linear token lookup
// per probe and a full O(T^2) rescan per merge, this uses a hash-map vocab
// and a lazy max-heap: O(T log T) per encode.
//
// C ABI consumed via ctypes (see qwen3_tpu/tokenizer/native.py).

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
    std::vector<std::string> tokens;   // id -> raw bytes
    std::vector<float> scores;
    std::unordered_map<std::string, int32_t> vocab;  // bytes -> first id
    int32_t max_len = 0;
};

struct HeapEntry {
    float score;
    int32_t left;      // left node index (monotone in sequence order)
    int32_t merged;    // merged token id
    int32_t right;     // right node index
    uint32_t lver, rver;
};

struct HeapCmp {
    // max score first; ties -> smallest left index (leftmost pair)
    bool operator()(const HeapEntry& a, const HeapEntry& b) const {
        if (a.score != b.score) return a.score < b.score;
        return a.left > b.left;
    }
};

}  // namespace

extern "C" {

void* qtok_create(const uint8_t* blob, int64_t blob_len) {
    // blob: the raw .tokenizer v2 file contents (parsed here so the library
    // has no filesystem dependency; Python hands us the mapped bytes)
    if (blob_len < 56) return nullptr;
    uint32_t magic;
    int32_t version, vocab_size, max_len;
    std::memcpy(&magic, blob, 4);
    std::memcpy(&version, blob + 4, 4);
    std::memcpy(&vocab_size, blob + 8, 4);
    std::memcpy(&max_len, blob + 12, 4);
    if (magic != 0x71746B6Eu || version != 2 || vocab_size <= 0)
        return nullptr;

    auto* t = new Tokenizer();
    t->max_len = max_len;
    t->tokens.reserve(vocab_size);
    t->scores.reserve(vocab_size);
    t->vocab.reserve(vocab_size * 2);

    int64_t off = 56;  // header: 16 + 10 special ids * 4
    for (int32_t i = 0; i < vocab_size; ++i) {
        if (off + 8 > blob_len) { delete t; return nullptr; }
        float score;
        int32_t len;
        std::memcpy(&score, blob + off, 4);
        std::memcpy(&len, blob + off + 4, 4);
        off += 8;
        if (len < 0 || off + len > blob_len) { delete t; return nullptr; }
        t->tokens.emplace_back(reinterpret_cast<const char*>(blob + off), len);
        t->scores.push_back(score);
        t->vocab.emplace(t->tokens.back(), i);  // first id wins
        off += len;
    }
    return t;
}

void qtok_free(void* h) { delete static_cast<Tokenizer*>(h); }

int32_t qtok_vocab_size(void* h) {
    return static_cast<int32_t>(static_cast<Tokenizer*>(h)->tokens.size());
}

// Encode `len` bytes of text into `out` (capacity `cap`). Returns the number
// of tokens, or -1 if the output buffer is too small.
int32_t qtok_encode(void* h, const uint8_t* text, int64_t len, int32_t* out,
                    int32_t cap) {
    auto* t = static_cast<Tokenizer*>(h);

    // 1. pre-tokenize: special "<...>" scan (bounded by max_len), byte fallback
    std::vector<int32_t> ids;
    ids.reserve(len);
    for (int64_t i = 0; i < len;) {
        int32_t id = -1;
        if (text[i] == '<') {
            int64_t end = std::min(len, i + (int64_t)t->max_len);
            for (int64_t j = i; j < end; ++j) {
                if (text[j] == '>') {
                    auto it = t->vocab.find(std::string(
                        reinterpret_cast<const char*>(text + i), j - i + 1));
                    if (it != t->vocab.end()) {
                        id = it->second;
                        i = j + 1;
                    }
                    break;
                }
            }
        }
        if (id == -1) {
            auto it = t->vocab.find(
                std::string(reinterpret_cast<const char*>(text + i), 1));
            ++i;
            if (it == t->vocab.end()) continue;  // unknown byte dropped
            id = it->second;
        }
        ids.push_back(id);
    }

    // 2. greedy merges via doubly-linked list + lazy heap
    const int32_t n = static_cast<int32_t>(ids.size());
    if (n >= 2) {
        std::vector<int32_t> tok(ids.begin(), ids.end());
        std::vector<int32_t> nxt(n), prv(n);
        std::vector<uint32_t> ver(n, 0);
        for (int32_t i = 0; i < n; ++i) { nxt[i] = i + 1; prv[i] = i - 1; }
        nxt[n - 1] = -1;

        std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
        std::string buf;
        auto push = [&](int32_t a, int32_t b) {
            if (a < 0 || b < 0) return;
            buf.assign(t->tokens[tok[a]]);
            buf += t->tokens[tok[b]];
            auto it = t->vocab.find(buf);
            if (it != t->vocab.end())
                heap.push({t->scores[it->second], a, it->second, b,
                           ver[a], ver[b]});
        };
        for (int32_t a = 0; a + 1 < n; ++a) push(a, a + 1);

        while (!heap.empty()) {
            HeapEntry e = heap.top();
            heap.pop();
            int32_t a = e.left, b = e.right;
            if (tok[a] < 0 || tok[b] < 0) continue;
            if (ver[a] != e.lver || ver[b] != e.rver || nxt[a] != b) continue;
            tok[a] = e.merged;
            ++ver[a];
            tok[b] = -1;
            nxt[a] = nxt[b];
            if (nxt[b] != -1) prv[nxt[b]] = a;
            push(prv[a], a);
            push(a, nxt[a]);
        }

        ids.clear();
        for (int32_t node = 0; node != -1; node = nxt[node])
            if (tok[node] >= 0) ids.push_back(tok[node]);
    }

    if (static_cast<int32_t>(ids.size()) > cap) return -1;
    std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
    return static_cast<int32_t>(ids.size());
}

}  // extern "C"
