// PAF ingest for the assembler: read a whole PAF (plain or gzip'd) in one
// native pass, hand back its integer columns, and decode the CIGARs of a
// chosen set of records into flat op and length arrays.
//
// The Python reader (core/io.py read_paf + core/cigar.py parse) spends one
// regex match and two list appends per CIGAR operation, millions a file;
// like the FASTA reader and the PAF writer, this is byte handling and
// belongs here.  The contract is that of the Python path, exactly:
//
//   - blank lines (only Python whitespace) are skipped; every other line
//     is a record of at least 12 tab-separated columns;
//   - the query and target names are integer ids, the other integer
//     columns are integers; the strand is 1 iff its column is "-";
//   - the CIGAR is the value of the last tag column "cg:?:<value>"
//     (len > 5, ':' at 2 and 4), "" where there is none;
//   - a CIGAR decodes as re.findall(r"(\d+)([MID])"): each maximal run of
//     digits followed by M, I or D gives one op (M=0, I=1, D=2); any other
//     character, and digits not followed by M/I/D, are skipped.
//
// A file outside what this scan can hold to that contract is refused
// (null / -1) and the caller takes the Python path, which parses it or
// raises as it always has: a byte >= 0x80 or a '\r' anywhere (text mode
// decodes and translates those), fewer than 12 columns, a name that is not
// a plain decimal id ("0" or no leading zero, at most 15 digits, so that
// names compare equal exactly when their ids do), an integer column that
// is not [-]digits of at most 15 digits (exact in a double, so n_match /
// n_block divides as Python's does), a CIGAR length of more than 18
// significant digits, or a read error.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kCols = 14;  // 12 PAF columns + the CIGAR's offset, length
constexpr int kMaxDigits = 15;

struct Paf {
    std::string text;            // the whole file, decompressed
    std::vector<int64_t> cols;   // n x kCols
    uint64_t n = 0;
};

bool read_all(const char* path, std::string& out) {
    gzFile fp = gzopen(path, "rb");
    if (!fp) return false;
    gzbuffer(fp, 1 << 20);
    std::vector<char> buf(1 << 20);
    int got;
    while ((got = gzread(fp, buf.data(), buf.size())) > 0)
        out.append(buf.data(), got);
    int err = Z_OK;
    gzerror(fp, &err);
    gzclose(fp);
    return got == 0 && (err == Z_OK || err == Z_STREAM_END);
}

// Python's str.isspace over ASCII
bool is_space(unsigned char c) {
    return (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x20);
}

bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }

bool parse_int(const char* p, const char* e, int64_t& v) {
    bool neg = p < e && *p == '-';
    if (neg) p++;
    if (p == e || e - p > kMaxDigits) return false;
    int64_t x = 0;
    for (; p < e; p++) {
        if (!is_digit(*p)) return false;
        x = x * 10 + (*p - '0');
    }
    v = neg ? -x : x;
    return true;
}

bool parse_id(const char* p, const char* e, int64_t& v) {
    if (p == e || (*p == '0' && e - p > 1)) return false;
    return *p != '-' && parse_int(p, e, v);
}

// A byte text mode would decode or translate: >= 0x80 or '\r'.
bool plain_ascii(const std::string& t) {
    bool bad = false;
    for (unsigned char c : t) bad |= (c >= 0x80) | (c == '\r');
    return !bad;
}

// One line [p, e) of plain ASCII: appends its columns, or returns false.
bool scan_line(const char* base, const char* p, const char* e, Paf& a) {
    const char* f[12];
    const char* fe[12];
    int nf = 0;
    const char* cg = nullptr;
    const char* cge = nullptr;
    for (const char* s = p;; nf++) {
        const char* q = static_cast<const char*>(memchr(s, '\t', e - s));
        if (!q) q = e;
        if (nf < 12) {
            f[nf] = s;
            fe[nf] = q;
        } else if (q - s > 5 && s[0] == 'c' && s[1] == 'g' && s[2] == ':' &&
                   s[4] == ':') {
            cg = s + 5;
            cge = q;
        }
        if (q == e) {
            nf++;
            break;
        }
        s = q + 1;
    }
    if (nf < 12) return false;
    int64_t v[kCols];
    static const int kInt[9] = {1, 2, 3, 6, 7, 8, 9, 10, 11};
    if (!parse_id(f[0], fe[0], v[0]) || !parse_id(f[5], fe[5], v[5]))
        return false;
    for (int c : kInt)
        if (!parse_int(f[c], fe[c], v[c])) return false;
    v[4] = (fe[4] - f[4] == 1 && *f[4] == '-') ? 1 : 0;
    v[12] = cg ? cg - base : 0;
    v[13] = cg ? cge - cg : 0;
    a.cols.insert(a.cols.end(), v, v + kCols);
    a.n++;
    return true;
}

// Calls emit(op, len) for each op of the CIGAR [p, e); false on a length
// of more than 18 significant digits.
template <class Emit>
bool decode(const unsigned char* p, const unsigned char* e, Emit emit) {
    uint64_t x = 0;
    int ndig = 0, nsig = 0;
    for (; p < e; p++) {
        unsigned c = *p, d = c - '0';
        if (d < 10) {
            x = x * 10 + d;
            ndig++;
            nsig += x != 0;
            continue;
        }
        if (ndig && (c == 'M' || c == 'I' || c == 'D')) {
            if (nsig > 18) return false;
            emit(c == 'M' ? 0 : c == 'I' ? 1 : 2, static_cast<int64_t>(x));
        }
        x = 0;
        ndig = nsig = 0;
    }
    return true;
}

}  // namespace

extern "C" {

// Read path; an opaque handle, or 0 where the file cannot be taken.
void* hx_paf_scan(const char* path) {
    auto* a = new Paf();
    if (!read_all(path, a->text) || !plain_ascii(a->text)) {
        delete a;
        return nullptr;
    }
    const char* base = a->text.data();
    const char* end = base + a->text.size();
    for (const char* p = base; p < end;) {
        const char* e = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!e) e = end;
        const char* q = p;
        while (q < e && is_space(*q)) q++;
        if (q < e && !scan_line(base, p, e, *a)) {
            delete a;
            return nullptr;
        }
        p = e + 1;
    }
    return a;
}

uint64_t hx_paf_n(void* h) { return static_cast<Paf*>(h)->n; }

// n x 14 int64 rows: q id, q len, q start, q end, strand (1 = '-'), t id,
// t len, t start, t end, n_match, n_block, mapq, the CIGAR's byte offset
// in the file's text and its length (0 without a cg tag).
const int64_t* hx_paf_cols(void* h) {
    return static_cast<Paf*>(h)->cols.data();
}

// Decodes the CIGARs of rows[0..m) in order into ops/lens, which hold
// `capacity` ops (each op takes two bytes of text at least, so the sum of
// the CIGARs' lengths over 2 is enough); rows[i]'s ops are
// [offsets[i], offsets[i+1]).  Returns the number of ops, or -1 on a
// length too long for int64 or ops past `capacity`.
int64_t hx_paf_cigar_decode(void* h, const int64_t* rows, uint64_t m,
                            uint64_t capacity, uint8_t* ops, int64_t* lens,
                            uint64_t* offsets) {
    auto* a = static_cast<Paf*>(h);
    auto* base = reinterpret_cast<const unsigned char*>(a->text.data());
    uint64_t k = 0;
    bool room = true;
    offsets[0] = 0;
    for (uint64_t i = 0; i < m; i++) {
        const int64_t* c = &a->cols[rows[i] * kCols];
        bool ok = decode(base + c[12], base + c[12] + c[13],
                         [&](int op, int64_t x) {
                             if (k == capacity) {
                                 room = false;
                                 return;
                             }
                             ops[k] = static_cast<uint8_t>(op);
                             lens[k] = x;
                             k++;
                         });
        if (!ok || !room) return -1;
        offsets[i + 1] = k;
    }
    return static_cast<int64_t>(k);
}

void hx_paf_free(void* h) { delete static_cast<Paf*>(h); }

}  // extern "C"
