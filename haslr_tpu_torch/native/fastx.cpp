// Native runtime: streaming FASTA/FASTQ reader with on-the-fly 2-bit
// encoding.  The C++ analog of the reference's kseq.h/zlib input layer
// (Contig.cpp:43-117, Longread.cpp:109-162), exposed to Python via ctypes:
// one call parses a whole (optionally gzip'd) file into a contiguous code
// arena plus per-record offsets — the exact layout haslr_tpu's
// SeqStore/device buffers want, with no per-record Python overhead.
//
// Build: see build.py (g++ -O3 -shared -fPIC fastx.cpp -lz).

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Arena {
    std::vector<uint8_t> codes;       // 2-bit codes, concatenated
    std::vector<uint64_t> offsets;    // n+1 offsets into codes
    std::string names;                // '\0'-joined names
    std::string comments;             // '\0'-joined comments
    uint64_t n = 0;
};

// ASCII -> 2-bit code (A=0 C=1 G=2 T=3, everything else A), mirroring the
// reference's _dna_tableVal semantics (Compressed_sequence.cpp:10-19).
uint8_t code_of(int ch) {
    switch (ch) {
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 0;
    }
}

class Reader {
  public:
    explicit Reader(const char* path) { fp_ = gzopen(path, "rb"); }
    ~Reader() { if (fp_) gzclose(fp_); }
    bool ok() const { return fp_ != nullptr; }
    int getc() {
        if (pos_ >= len_) {
            len_ = gzread(fp_, buf_, sizeof buf_);
            pos_ = 0;
            if (len_ <= 0) return -1;
        }
        return buf_[pos_++];
    }

  private:
    gzFile fp_ = nullptr;
    unsigned char buf_[1 << 16];
    int len_ = 0, pos_ = 0;
};

bool read_line(Reader& r, std::string& out) {
    out.clear();
    int c = r.getc();
    if (c < 0) return false;
    while (c >= 0 && c != '\n') {
        out.push_back(static_cast<char>(c));
        c = r.getc();
    }
    if (!out.empty() && out.back() == '\r') out.pop_back();
    return true;
}

void split_header(const std::string& line, size_t start, Arena& a) {
    size_t sp = line.find_first_of(" \t", start);
    if (sp == std::string::npos) {
        a.names.append(line, start, line.size() - start);
        a.names.push_back('\0');
        a.comments.push_back('\0');
    } else {
        a.names.append(line, start, sp - start);
        a.names.push_back('\0');
        size_t cs = line.find_first_not_of(" \t", sp);
        if (cs != std::string::npos)
            a.comments.append(line, cs, line.size() - cs);
        a.comments.push_back('\0');
    }
}

void append_codes(const std::string& seq, Arena& a) {
    for (char ch : seq) a.codes.push_back(code_of(ch));
}

}  // namespace

extern "C" {

// Parse path into a heap Arena; returns an opaque handle (0 on failure).
void* hx_read_fastx(const char* path) {
    Reader r(path);
    if (!r.ok()) return nullptr;
    auto* a = new Arena();
    a->offsets.push_back(0);
    std::string line, seq;
    int first = r.getc();
    if (first == '>') {
        bool have = read_line(r, line);
        while (have) {
            split_header(line, 0, *a);
            seq.clear();
            while ((have = read_line(r, line))) {
                if (!line.empty() && line[0] == '>') {
                    line.erase(0, 1);
                    break;
                }
                seq += line;
            }
            append_codes(seq, *a);
            a->offsets.push_back(a->codes.size());
            a->n++;
            if (!have) break;
        }
    } else if (first == '@') {
        while (true) {
            if (!read_line(r, line)) break;
            split_header(line, 0, *a);
            read_line(r, seq);
            append_codes(seq, *a);
            a->offsets.push_back(a->codes.size());
            a->n++;
            read_line(r, line);   // '+'
            read_line(r, line);   // quals
            int c = r.getc();
            if (c != '@') break;
        }
    } else if (first < 0) {
        return a;  // empty file: zero records
    } else {
        delete a;
        return nullptr;
    }
    return a;
}

uint64_t hx_n(void* h) { return static_cast<Arena*>(h)->n; }
uint64_t hx_codes_size(void* h) {
    return static_cast<Arena*>(h)->codes.size();
}
uint64_t hx_names_size(void* h) {
    return static_cast<Arena*>(h)->names.size();
}
uint64_t hx_comments_size(void* h) {
    return static_cast<Arena*>(h)->comments.size();
}
const uint8_t* hx_codes(void* h) {
    return static_cast<Arena*>(h)->codes.data();
}
const uint64_t* hx_offsets(void* h) {
    return static_cast<Arena*>(h)->offsets.data();
}
const char* hx_names(void* h) { return static_cast<Arena*>(h)->names.data(); }
const char* hx_comments(void* h) {
    return static_cast<Arena*>(h)->comments.data();
}
void hx_free(void* h) { delete static_cast<Arena*>(h); }

}  // extern "C"
