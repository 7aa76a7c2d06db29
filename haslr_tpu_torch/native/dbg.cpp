// Native de Bruijn compaction: solid canonical k-mers -> unitigs + links.
//
// The C++ runtime twin of haslr_tpu/sr/dbg.py (same algorithm, same
// deterministic iteration order, so outputs are byte-identical): k-mers
// arrive as sorted (hi, lo, count) arrays from the device counter; this
// module builds an open-addressing hash table, walks maximal
// non-branching paths in the bidirected graph, and emits unitig
// sequences, KC/k-mer counts and minia-style end links.  Python binds via
// ctypes (see native/__init__.py); k <= 64.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

typedef unsigned __int128 u128;

struct Kmer {
    uint64_t hi, lo;
    bool operator==(const Kmer& o) const { return hi == o.hi && lo == o.lo; }
    bool operator<(const Kmer& o) const {
        return hi < o.hi || (hi == o.hi && lo < o.lo);
    }
};

inline uint64_t mix64(uint64_t x) {
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBULL;
    x ^= x >> 31;
    return x;
}

inline uint64_t hash_kmer(const Kmer& k) {
    return mix64(k.hi ^ mix64(k.lo));
}

// complement + reverse all 32 2-bit groups of a 64-bit word
inline uint64_t rc64(uint64_t x) {
    x = ~x;
    x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    return __builtin_bswap64(x);
}

struct Graph {
    int k;
    int hi_bits;          // 2k - 64 when k > 32, else 0
    uint64_t hi_mask;
    uint64_t lo_mask;
    // open addressing table
    std::vector<Kmer> keys;
    std::vector<uint32_t> counts;
    std::vector<uint8_t> occ;
    uint64_t tmask;

    Kmer rc(const Kmer& v) const {
        // reverse the full 128 bits, then shift down by (128 - 2k)
        uint64_t rhi = rc64(v.lo);
        uint64_t rlo = rc64(v.hi);
        int sh = 128 - 2 * k;
        Kmer r;
        if (sh >= 64) {
            r.lo = rhi >> (sh - 64);
            r.hi = 0;
        } else if (sh > 0) {
            r.lo = (rlo >> sh) | (rhi << (64 - sh));
            r.hi = rhi >> sh;
        } else {
            r.lo = rlo;
            r.hi = rhi;
        }
        r.hi &= hi_mask;
        r.lo &= lo_mask;
        return r;
    }

    Kmer canon(const Kmer& v) const {
        Kmer r = rc(v);
        return r < v ? r : v;
    }

    Kmer append(const Kmer& v, int b) const {
        Kmer w;
        w.lo = (v.lo << 2) | (uint64_t)b;
        w.hi = ((v.hi << 2) | (v.lo >> 62)) & hi_mask;
        w.lo &= lo_mask;
        return w;
    }

    int64_t find(const Kmer& c) const {
        uint64_t i = hash_kmer(c) & tmask;
        while (occ[i]) {
            if (keys[i] == c) return (int64_t)i;
            i = (i + 1) & tmask;
        }
        return -1;
    }

    void insert(const Kmer& c, uint32_t cnt) {
        uint64_t i = hash_kmer(c) & tmask;
        while (occ[i]) i = (i + 1) & tmask;
        occ[i] = 1;
        keys[i] = c;
        counts[i] = cnt;
    }

    bool has(const Kmer& v) const { return find(canon(v)) >= 0; }

    int succs(const Kmer& v, Kmer* out) const {
        int n = 0;
        for (int b = 0; b < 4; b++) {
            Kmer w = append(v, b);
            if (has(w)) out[n++] = w;
        }
        return n;
    }

    int preds(const Kmer& v, Kmer* out) const {
        Kmer tmp[4];
        int n = succs(rc(v), tmp);
        for (int i = 0; i < n; i++) out[i] = rc(tmp[i]);
        return n;
    }

    bool is_start(const Kmer& v) const {
        Kmer p[4];
        int np = preds(v, p);
        if (np != 1) return true;
        Kmer s[4];
        return succs(p[0], s) != 1;
    }
};

struct Arena {
    std::string seqs;
    std::vector<uint64_t> seq_offsets{0};
    std::vector<uint64_t> kc;
    std::vector<uint64_t> nk;
    std::vector<int32_t> links;  // quads: from_uid, from_sign, to_uid, to_sign
    std::vector<Kmer> firsts, lasts;
};

const char* BASES = "ACGT";

void kmer_str(const Graph& g, const Kmer& v, std::string& out) {
    for (int i = g.k - 1; i >= 0; i--) {
        int bit = 2 * i;
        int b;
        if (bit >= 64)
            b = (int)((v.hi >> (bit - 64)) & 3);
        else
            b = (int)((v.lo >> bit) & 3);
        out.push_back(BASES[b]);
    }
}

struct K128Hash {
    size_t operator()(const u128& x) const {
        return (size_t)mix64((uint64_t)x ^ mix64((uint64_t)(x >> 64)));
    }
};

inline u128 pack(const Kmer& v) {
    return ((u128)v.hi << 64) | v.lo;
}

struct Entry {
    Kmer km;
    uint32_t cnt;
};

void init_graph(Graph& g, int k, uint64_t n) {
    g.k = k;
    g.hi_bits = k > 32 ? 2 * k - 64 : 0;
    g.hi_mask = g.hi_bits ? ((~0ULL) >> (64 - g.hi_bits)) : 0ULL;
    g.lo_mask = k >= 32 ? ~0ULL : ((~0ULL) >> (64 - 2 * k));
    uint64_t tsize = 16;
    while (tsize < 2 * n + 4) tsize <<= 1;
    g.tmask = tsize - 1;
    g.keys.assign(tsize, Kmer{0, 0});
    g.counts.assign(tsize, 0);
    g.occ.assign(tsize, 0);
}

// walk maximal non-branching paths (pass-1 order = `live` order, matching
// the python builder's iteration over its count table) and attach links
Arena* build_arena(const Graph& g, const std::vector<Entry>& live) {
    uint64_t n = live.size();
    auto* a = new Arena();
    std::unordered_map<u128, uint8_t, K128Hash> visited;
    visited.reserve(2 * n);

    auto walk = [&](Kmer v0) {
        std::string seq;
        kmer_str(g, v0, seq);
        Kmer cv = g.canon(v0);
        uint64_t kc = g.counts[g.find(cv)];
        uint64_t nk = 1;
        visited[pack(cv)] = 1;
        Kmer v = v0;
        Kmer s[4], p[4];
        while (true) {
            if (g.succs(v, s) != 1) break;
            Kmer w = s[0];
            if (g.preds(w, p) != 1) break;
            Kmer cw = g.canon(w);
            if (visited.count(pack(cw))) break;  // cycle closure
            visited[pack(cw)] = 1;
            seq.push_back(BASES[w.lo & 3]);
            kc += g.counts[g.find(cw)];
            nk++;
            v = w;
        }
        a->seqs += seq;
        a->seq_offsets.push_back(a->seqs.size());
        a->kc.push_back(kc);
        a->nk.push_back(nk);
        a->firsts.push_back(v0);
        a->lasts.push_back(v);
    };

    // pass 1: start k-mers, both orientations (input order = python order)
    for (uint64_t i = 0; i < n; i++) {
        Kmer cv = live[i].km;
        Kmer variants[2] = {cv, g.rc(cv)};
        for (int o = 0; o < 2; o++) {
            if (visited.count(pack(g.canon(variants[o])))) break;
            if (g.is_start(variants[o])) {
                walk(variants[o]);
                break;
            }
        }
    }
    // pass 2: leftovers are perfect cycles
    for (uint64_t i = 0; i < n; i++) {
        Kmer cv = live[i].km;
        if (!visited.count(pack(cv))) walk(cv);
    }

    // links: map canonical end k-mers -> unitig ids
    std::unordered_map<u128, std::vector<uint32_t>, K128Hash> ends;
    uint32_t nu = (uint32_t)a->kc.size();
    for (uint32_t u = 0; u < nu; u++) {
        auto add = [&](const Kmer& e) {
            auto& v = ends[pack(g.canon(e))];
            for (uint32_t x : v)
                if (x == u) return;
            v.push_back(u);
        };
        add(a->firsts[u]);
        add(a->lasts[u]);
    }
    auto resolve = [&](const Kmer& w, uint32_t* uid, int32_t* sign) -> bool {
        auto it = ends.find(pack(g.canon(w)));
        if (it == ends.end()) return false;
        for (uint32_t u2 : it->second) {
            if (w == a->firsts[u2]) {
                *uid = u2;
                *sign = 0;  // '+'
                return true;
            }
            if (w == g.rc(a->lasts[u2])) {
                *uid = u2;
                *sign = 1;  // '-'
                return true;
            }
        }
        return false;
    };
    Kmer s[4];
    for (uint32_t u = 0; u < nu; u++) {
        int ns = g.succs(a->lasts[u], s);
        for (int i = 0; i < ns; i++) {
            uint32_t uid;
            int32_t sign;
            if (resolve(s[i], &uid, &sign)) {
                a->links.push_back((int32_t)u);
                a->links.push_back(0);  // from '+'
                a->links.push_back((int32_t)uid);
                a->links.push_back(sign);
            }
        }
        ns = g.succs(g.rc(a->firsts[u]), s);
        for (int i = 0; i < ns; i++) {
            uint32_t uid;
            int32_t sign;
            if (resolve(s[i], &uid, &sign)) {
                a->links.push_back((int32_t)u);
                a->links.push_back(1);  // from '-'
                a->links.push_back((int32_t)uid);
                a->links.push_back(sign);
            }
        }
    }
    return a;
}

// simple-bubble detection on the unitig graph (transcribes
// sr/dbg.py:find_simple_bubbles — same iteration order and the same
// (km, -uid) weaker-branch tie-break, so the doomed set is identical)
std::vector<uint32_t> find_bubbles(const Arena& a, int k) {
    uint32_t nu = (uint32_t)a.kc.size();
    int64_t max_branch_len = 3 * (int64_t)k;
    // per-unitig links in arena order: (from_sign, to, to_sign)
    std::vector<std::vector<std::array<int32_t, 3>>> links(nu);
    for (size_t i = 0; i + 3 < a.links.size() + 1; i += 4)
        links[a.links[i]].push_back(
            {a.links[i + 1], a.links[i + 2], a.links[i + 3]});
    std::vector<uint8_t> dropped(nu, 0);
    std::vector<uint32_t> doomed;
    auto km = [&](uint32_t u) {
        return (double)a.kc[u] / (double)(a.nk[u] > 0 ? a.nk[u] : 1);
    };
    auto seq_len = [&](uint32_t u) {
        return (int64_t)(a.seq_offsets[u + 1] - a.seq_offsets[u]);
    };
    // interior check: entered with orientation ts, one in-link on the
    // entry side and one out-link on the exit side -> the oriented exit
    auto interior_exit = [&](int32_t t, int32_t ts, int32_t* eu,
                             int32_t* es) -> bool {
        int32_t entry_side = ts == 0 ? 1 : 0;
        int32_t exit_side = ts;
        int n_in = 0, n_out = 0;
        int32_t ou = -1, os = -1;
        for (auto& L : links[t]) {
            if (L[0] == entry_side) n_in++;
            if (L[0] == exit_side) {
                n_out++;
                ou = L[1];
                os = L[2];
            }
        }
        if (n_in != 1 || n_out != 1) return false;
        *eu = ou;
        *es = os;
        return true;
    };
    for (uint32_t x = 0; x < nu; x++) {
        for (int32_t side = 0; side < 2; side++) {
            int32_t t1 = -1, s1 = -1, t2 = -1, s2 = -1;
            int n_out = 0;
            for (auto& L : links[x]) {
                if (L[0] != side) continue;
                if (n_out == 0) {
                    t1 = L[1];
                    s1 = L[2];
                } else if (n_out == 1) {
                    t2 = L[1];
                    s2 = L[2];
                }
                n_out++;
            }
            if (n_out != 2) continue;
            if (t1 == t2 || (int32_t)x == t1 || (int32_t)x == t2) continue;
            if (dropped[t1] || dropped[t2]) continue;
            if (seq_len(t1) > max_branch_len || seq_len(t2) > max_branch_len)
                continue;
            int32_t e1u, e1s, e2u, e2s;
            if (!interior_exit(t1, s1, &e1u, &e1s)) continue;
            if (!interior_exit(t2, s2, &e2u, &e2s)) continue;
            if (e1u != e2u || e1s != e2s) continue;
            if (e1u == t1 || e1u == t2 || e1u == (int32_t)x) continue;
            // drop the weaker branch; tie -> higher uid (deterministic)
            double km1 = km(t1), km2 = km(t2);
            uint32_t victim =
                (km1 < km2 || (km1 == km2 && t1 > t2)) ? t1 : t2;
            if (!dropped[victim]) {
                dropped[victim] = 1;
                doomed.push_back(victim);
            }
        }
    }
    return doomed;
}

}  // namespace

extern "C" {

void* hx_dbg_run(const uint64_t* hi, const uint64_t* lo,
                 const uint32_t* cnt, uint64_t n, int k) {
    if (k < 2 || k > 64) return nullptr;
    Graph g;
    init_graph(g, k, n);
    std::vector<Entry> live(n);
    for (uint64_t i = 0; i < n; i++) {
        live[i] = {Kmer{hi[i], lo[i]}, cnt[i]};
        g.insert(live[i].km, live[i].cnt);
    }
    return build_arena(g, live);
}

// iterative simple-bubble popping entirely in native code (the python
// pop_bubbles loop, sr/dbg.py:270-297, rebuilt a dict of ALL solid
// k-mers every round — ~100 GB of host RAM at CHM1 scale; here the
// k-mer set lives in flat arrays + an open-addressing table, bounded at
// ~42 bytes/k-mer): compact -> find bubbles -> delete branch k-mers ->
// re-compact, until bubble-free or max_rounds.
void* hx_dbg_pop_run(const uint64_t* hi, const uint64_t* lo,
                     const uint32_t* cnt, uint64_t n, int k,
                     int max_rounds) {
    if (k < 2 || k > 64) return nullptr;
    std::vector<Entry> live(n);
    for (uint64_t i = 0; i < n; i++) live[i] = {Kmer{hi[i], lo[i]}, cnt[i]};
    // python's rebuild() iterates its count table in sorted key order
    std::sort(live.begin(), live.end(), [](const Entry& a, const Entry& b) {
        return a.km < b.km;
    });
    Graph g;
    Arena* a = nullptr;
    auto rebuild = [&]() {
        init_graph(g, k, live.size());
        for (auto& e : live) g.insert(e.km, e.cnt);
        delete a;
        a = build_arena(g, live);
    };
    rebuild();
    for (int round = 0; round < max_rounds; round++) {
        std::vector<uint32_t> doomed = find_bubbles(*a, k);
        if (doomed.empty()) break;
        // collect the doomed unitigs' canonical k-mers, then filter
        std::unordered_map<u128, uint8_t, K128Hash> dead;
        for (uint32_t uid : doomed) {
            const char* s = a->seqs.data() + a->seq_offsets[uid];
            int64_t len =
                (int64_t)(a->seq_offsets[uid + 1] - a->seq_offsets[uid]);
            Kmer v{0, 0};
            for (int64_t i = 0; i < len; i++) {
                int b = s[i] == 'A' ? 0 : s[i] == 'C' ? 1
                        : s[i] == 'G' ? 2 : 3;
                v = g.append(v, b);
                if (i >= k - 1) dead[pack(g.canon(v))] = 1;
            }
        }
        std::vector<Entry> next;
        next.reserve(live.size());
        for (auto& e : live)
            if (!dead.count(pack(e.km))) next.push_back(e);
        live.swap(next);
        rebuild();
    }
    return a;
}

uint64_t hx_dbg_n_unitigs(void* h) {
    return static_cast<Arena*>(h)->kc.size();
}
uint64_t hx_dbg_seqs_size(void* h) {
    return static_cast<Arena*>(h)->seqs.size();
}
const char* hx_dbg_seqs(void* h) {
    return static_cast<Arena*>(h)->seqs.data();
}
const uint64_t* hx_dbg_seq_offsets(void* h) {
    return static_cast<Arena*>(h)->seq_offsets.data();
}
const uint64_t* hx_dbg_kc(void* h) {
    return static_cast<Arena*>(h)->kc.data();
}
const uint64_t* hx_dbg_nk(void* h) {
    return static_cast<Arena*>(h)->nk.data();
}
uint64_t hx_dbg_n_links(void* h) {
    return static_cast<Arena*>(h)->links.size() / 4;
}
const int32_t* hx_dbg_links(void* h) {
    return static_cast<Arena*>(h)->links.data();
}
void hx_dbg_free(void* h) { delete static_cast<Arena*>(h); }

}  // extern "C"
