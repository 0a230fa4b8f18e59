// Native N-Triples parser: streaming (gzip or plain), interning terms into
// flat tables consumable as numpy arrays via ctypes.
//
// The reference delegates parsing to rdflib (pure Python; the dominant ETL
// cost for large graphs — reference: mrgcn/data/io/knowledge_graph.py:45-56).
// This parser deduplicates terms with a hash map and emits:
//   * a UTF-8 string pool + per-term offsets,
//   * per-term kind (0=IRI, 1=BNode, 2=Literal),
//   * per-literal language / datatype term ids (-1 when absent),
//   * an (n, 3) uint32 triple index array.
// The Python wrapper (mrgcn_tpu_torch/data/native.py) builds this file at
// first use into mrgcn_tpu_torch/_build/ and reconstructs term objects:
//   g++ -O3 -shared -fPIC -std=c++17 ntparse.cpp -lz -o _ntparse.so
//
// C ABI only — no pybind11 dependency.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Result {
    std::string pool;                 // NUL-terminated term texts
    std::vector<uint64_t> offsets;    // n_terms + 1 (offsets[i+1]
                                      // includes term i's trailing NUL)
    std::vector<uint8_t> kinds;       // n_terms
    std::vector<int64_t> lang_ids;    // n_terms (-1 if none)
    std::vector<int64_t> dtype_ids;   // n_terms (-1 if none)
    std::vector<uint32_t> triples;    // 3 * n_triples
    uint64_t skipped = 0;
    uint64_t has_nul = 0;             // a term text contains '\0' itself
                                      // (escaped u0000) — split unsafe
    std::string error;
};

struct TermKey {
    std::string text;
    uint8_t kind;
    int64_t lang;
    int64_t dtype;
    bool operator==(const TermKey& o) const {
        return kind == o.kind && lang == o.lang && dtype == o.dtype &&
               text == o.text;
    }
};

struct TermKeyHash {
    size_t operator()(const TermKey& k) const {
        size_t h = std::hash<std::string>()(k.text);
        h ^= (size_t)k.kind * 0x9e3779b97f4a7c15ULL;
        h ^= (size_t)(k.lang + 2) * 0xff51afd7ed558ccdULL;
        h ^= (size_t)(k.dtype + 2) * 0xc4ceb9fe1a85ec53ULL;
        return h;
    }
};

class Interner {
   public:
    explicit Interner(Result* result) : result_(result) {
        result_->offsets.push_back(0);
    }

    int64_t intern(std::string&& text, uint8_t kind, int64_t lang = -1,
                   int64_t dtype = -1) {
        TermKey key{std::move(text), kind, lang, dtype};
        auto it = map_.find(key);
        if (it != map_.end()) return it->second;
        int64_t id = (int64_t)result_->kinds.size();
        if (key.text.find('\0') != std::string::npos) result_->has_nul = 1;
        result_->pool.append(key.text);
        result_->pool.push_back('\0');
        result_->offsets.push_back(result_->pool.size());
        result_->kinds.push_back(kind);
        result_->lang_ids.push_back(lang);
        result_->dtype_ids.push_back(dtype);
        map_.emplace(std::move(key), id);
        return id;
    }

   private:
    Result* result_;
    std::unordered_map<TermKey, int64_t, TermKeyHash> map_;
};

void append_utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
        out.push_back((char)cp);
    } else if (cp < 0x800) {
        out.push_back((char)(0xC0 | (cp >> 6)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back((char)(0xE0 | (cp >> 12)));
        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
        out.push_back((char)(0xF0 | (cp >> 18)));
        out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    }
}

int hexval(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

// unescape \t \b \n \r \f \" \' \\ \uXXXX \UXXXXXXXX in [begin, end)
bool unescape(const char* begin, const char* end, std::string& out) {
    out.clear();
    out.reserve(end - begin);
    for (const char* p = begin; p < end; ++p) {
        if (*p != '\\') {
            out.push_back(*p);
            continue;
        }
        if (++p >= end) return false;
        switch (*p) {
            case 't': out.push_back('\t'); break;
            case 'b': out.push_back('\b'); break;
            case 'n': out.push_back('\n'); break;
            case 'r': out.push_back('\r'); break;
            case 'f': out.push_back('\f'); break;
            case '"': out.push_back('"'); break;
            case '\'': out.push_back('\''); break;
            case '\\': out.push_back('\\'); break;
            case 'u':
            case 'U': {
                int n = (*p == 'u') ? 4 : 8;
                if (p + n >= end) return false;
                uint32_t cp = 0;
                for (int i = 1; i <= n; ++i) {
                    int v = hexval(p[i]);
                    if (v < 0) return false;
                    cp = (cp << 4) | (uint32_t)v;
                }
                p += n;
                append_utf8(out, cp);
                break;
            }
            default:
                return false;
        }
    }
    return true;
}

const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    return p;
}

// parse one term starting at p; returns id via interner or -1 on error
int64_t parse_term(const char*& p, const char* end, Interner& interner,
                   bool allow_literal, std::string& scratch) {
    p = skip_ws(p, end);
    if (p >= end) return -1;

    if (*p == '<') {  // IRI
        const char* close = (const char*)memchr(p + 1, '>', end - p - 1);
        if (!close) return -1;
        if (!unescape(p + 1, close, scratch)) return -1;
        p = close + 1;
        return interner.intern(std::move(scratch), 0);
    }
    if (*p == '_' && p + 1 < end && p[1] == ':') {  // blank node
        const char* q = p + 2;
        while (q < end && *q != ' ' && *q != '\t') ++q;
        scratch.assign(p + 2, q);
        p = q;
        return interner.intern(std::move(scratch), 1);
    }
    if (*p == '"' && allow_literal) {  // literal
        const char* q = p + 1;
        while (q < end) {
            if (*q == '\\') { q += 2; continue; }
            if (*q == '"') break;
            ++q;
        }
        if (q >= end) return -1;
        if (!unescape(p + 1, q, scratch)) return -1;
        std::string lexical = std::move(scratch);
        p = q + 1;

        int64_t lang = -1, dtype = -1;
        if (p < end && *p == '@') {  // language tag
            const char* t = p + 1;
            while (t < end && (isalnum((unsigned char)*t) || *t == '-')) ++t;
            std::string tag(p + 1, t);
            p = t;
            lang = interner.intern(std::move(tag), 3);  // kind 3: aux string
        } else if (p + 1 < end && p[0] == '^' && p[1] == '^') {
            p += 2;
            if (p >= end || *p != '<') return -1;
            const char* close =
                (const char*)memchr(p + 1, '>', end - p - 1);
            if (!close) return -1;
            std::string dt;
            if (!unescape(p + 1, close, dt)) return -1;
            p = close + 1;
            dtype = interner.intern(std::move(dt), 0);
        }
        return interner.intern(std::move(lexical), 2, lang, dtype);
    }
    return -1;
}

void parse_line(const char* begin, const char* end, Interner& interner,
                Result& result, std::string& scratch) {
    const char* p = skip_ws(begin, end);
    if (p >= end || *p == '#') return;  // blank / comment

    int64_t s = parse_term(p, end, interner, false, scratch);
    if (s < 0) { result.skipped++; return; }
    int64_t pr = parse_term(p, end, interner, false, scratch);
    if (pr < 0) { result.skipped++; return; }
    int64_t o = parse_term(p, end, interner, true, scratch);
    if (o < 0) { result.skipped++; return; }

    p = skip_ws(p, end);
    if (p >= end || *p != '.') { result.skipped++; return; }

    result.triples.push_back((uint32_t)s);
    result.triples.push_back((uint32_t)pr);
    result.triples.push_back((uint32_t)o);
}

}  // namespace

extern "C" {

void* nt_parse(const char* path) {
    auto* result = new Result();
    Interner interner(result);

    gzFile f = gzopen(path, "rb");  // handles plain files transparently
    if (!f) {
        result->error = "cannot open file";
        return result;
    }

    std::string carry;
    std::string scratch;
    std::vector<char> buf(1 << 20);
    int n;
    while ((n = gzread(f, buf.data(), (unsigned)buf.size())) > 0) {
        const char* data = buf.data();
        const char* end = data + n;
        const char* line_start = data;
        for (const char* p = data; p < end; ++p) {
            if (*p != '\n') continue;
            if (!carry.empty()) {
                carry.append(line_start, p);
                parse_line(carry.data(), carry.data() + carry.size(),
                           interner, *result, scratch);
                carry.clear();
            } else {
                parse_line(line_start, p, interner, *result, scratch);
            }
            line_start = p + 1;
        }
        carry.append(line_start, end);
    }
    if (!carry.empty())
        parse_line(carry.data(), carry.data() + carry.size(), interner,
                   *result, scratch);

    // gzread returns -1 on a corrupt stream, and 0 with Z_BUF_ERROR set at
    // the end of a truncated one: both are errors, so that callers never
    // take a partial graph for the whole
    int errnum = Z_OK;
    const char* msg = gzerror(f, &errnum);
    if (n < 0 || (errnum != Z_OK && errnum != Z_STREAM_END)) {
        result->error = msg != nullptr && *msg ? msg : "gzread failed";
    }
    gzclose(f);
    return result;
}

uint64_t nt_num_terms(void* r) { return ((Result*)r)->kinds.size(); }
uint64_t nt_num_triples(void* r) { return ((Result*)r)->triples.size() / 3; }
uint64_t nt_pool_size(void* r) { return ((Result*)r)->pool.size(); }
uint64_t nt_skipped(void* r) { return ((Result*)r)->skipped; }
uint64_t nt_has_nul(void* r) { return ((Result*)r)->has_nul; }
const char* nt_error(void* r) { return ((Result*)r)->error.c_str(); }

const char* nt_pool(void* r) { return ((Result*)r)->pool.data(); }
const uint64_t* nt_offsets(void* r) { return ((Result*)r)->offsets.data(); }
const uint8_t* nt_kinds(void* r) { return ((Result*)r)->kinds.data(); }
const int64_t* nt_lang_ids(void* r) { return ((Result*)r)->lang_ids.data(); }
const int64_t* nt_dtype_ids(void* r) {
    return ((Result*)r)->dtype_ids.data();
}
const uint32_t* nt_triples(void* r) { return ((Result*)r)->triples.data(); }

void nt_free(void* r) { delete (Result*)r; }

}  // extern "C"
