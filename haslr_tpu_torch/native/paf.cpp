// Bulk PAF emission: format + write every record of a mapping run in
// one native call.
//
// The aligner's emit phase was ~17 s of per-record Python string
// assembly at the 4.6 Mb e2e scale (minimap2's role, bin/haslr.py:99);
// formatting is pure byte twiddling, so it belongs here.  Output is
// byte-identical to haslr_tpu.core.io.PafRecord.to_line with the
// aligner's tag set ("tp:A:P" then "cg:Z:<cigar>"); op codes follow
// haslr_tpu.core.cigar (M=0, I=1, D=2).

#include <cstdint>
#include <cstdio>
#include <string>

extern "C" {

// fields: n x 11 int64 rows
//   [q_len, q_start, q_end, rel(0/1), t_idx, t_len, t_start, t_end,
//    n_match, n_block, mapq]
// names/tnames: concatenated UTF-8 with (n+1)/(n_t+1) byte offsets
// ops/lens + cig_off: concatenated normalized CIGAR runs per record
int64_t hx_paf_write(const char* path, const char* names,
                     const uint64_t* name_off, const char* tnames,
                     const uint64_t* tname_off, const int64_t* fields,
                     const uint8_t* ops, const int64_t* lens,
                     const uint64_t* cig_off, uint64_t n) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    std::string buf;
    buf.reserve(1 << 20);
    char tmp[32];
    static const char opch[3] = {'M', 'I', 'D'};
    auto put_int = [&](int64_t v) {
        int m = snprintf(tmp, sizeof tmp, "%lld", (long long)v);
        buf.append(tmp, m);
    };
    for (uint64_t r = 0; r < n; r++) {
        const int64_t* fld = fields + r * 11;
        buf.append(names + name_off[r], name_off[r + 1] - name_off[r]);
        buf.push_back('\t');
        put_int(fld[0]);
        buf.push_back('\t');
        put_int(fld[1]);
        buf.push_back('\t');
        put_int(fld[2]);
        buf.push_back('\t');
        buf.push_back(fld[3] ? '-' : '+');
        buf.push_back('\t');
        uint64_t t = (uint64_t)fld[4];
        buf.append(tnames + tname_off[t], tname_off[t + 1] - tname_off[t]);
        for (int c = 5; c <= 10; c++) {
            buf.push_back('\t');
            put_int(fld[c]);
        }
        buf.append("\ttp:A:P\tcg:Z:");
        for (uint64_t x = cig_off[r]; x < cig_off[r + 1]; x++) {
            put_int(lens[x]);
            buf.push_back(opch[ops[x] % 3]);
        }
        buf.push_back('\n');
        if (buf.size() > (1 << 20) - 4096) {
            fwrite(buf.data(), 1, buf.size(), f);
            buf.clear();
        }
    }
    fwrite(buf.data(), 1, buf.size(), f);
    fclose(f);
    return (int64_t)n;
}

}  // extern "C"
