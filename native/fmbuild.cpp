// fmbuild — native multi-string BWT builder (SA-IS).
//
// Native replacement for the reference's index construction path
// (SuffixTools/BWTCARopebwt.cpp + Thirdparty/ropebwt2): builds the BWT of a
// read collection under the SGA sentinel convention (each read terminated by
// its own '$', sentinels ordered by read index, '$' < A < C < G < T) using
// linear-time SA-IS over an integer alphabet where each sentinel gets a
// distinct value encoding its read index.
//
//   fmbuild reads.fa out_prefix
//     -> out_prefix.bwtraw / out_prefix.rbwtraw  (raw symbol streams)
//     -> out_prefix.lex    / out_prefix.rlex     (lexicographic read index)
//     -> out_prefix.ssa    / out_prefix.rssa     (sampled suffix array)
//
// Raw format: magic u32 'LRSB', u64 num_strings, u64 num_symbols, then
// num_symbols bytes of rank symbols ($=0 A=1 C=2 G=3 T=4).
//
// .lex ('LRSL'): u64 num_strings, then u32 read-id per lexicographic rank —
// the reference's .sai (SuffixTools/SampledSuffixArray::buildLexicoIndex,
// SampledSuffixArray.h:44): the k-th '$' in BWT row order terminates the
// read whose full string has lexicographic rank k.
//
// .ssa ('LRSS'): u32 sample_rate, u64 num_strings, u64 num_symbols, then
// (u32 read_id, u32 offset) for every BWT row r with r % rate == 0 — the
// reference's row-sampled SA (SampledSuffixArray.cpp:126: idx % rate == 0);
// lookup LF-walks to the next sampled row or the read's sentinel.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// SA-IS for integer sequences. s has values in [0, K); s must end with the
// unique smallest suffix-wise element arrangement (we guarantee distinct
// sentinel values, so no equal-tail ambiguity survives recursion).
// ---------------------------------------------------------------------------
static void sais_int(const int64_t* s, int64_t* sa, int64_t n, int64_t K) {
    if (n == 0) return;
    if (n == 1) { sa[0] = 0; return; }

    std::vector<uint8_t> ls(n);  // 1 = S-type, 0 = L-type
    ls[n - 1] = 1;
    for (int64_t i = n - 2; i >= 0; --i)
        ls[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && ls[i + 1])) ? 1 : 0;

    std::vector<int64_t> bkt(K + 1);
    auto bucket_ends = [&](bool end) {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (int64_t i = 0; i < n; ++i) bkt[s[i]]++;
        int64_t sum = 0;
        for (int64_t c = 0; c <= K; ++c) {
            sum += (c < K) ? bkt[c] : 0;
            int64_t cnt = (c < K) ? bkt[c] : 0;
            bkt[c] = end ? sum : sum - cnt;
        }
    };
    auto is_lms = [&](int64_t i) {
        return i > 0 && ls[i] && !ls[i - 1];
    };

    auto induce = [&](const std::vector<int64_t>& lms) {
        std::fill(sa, sa + n, -1);
        bucket_ends(true);
        for (int64_t i = (int64_t)lms.size() - 1; i >= 0; --i)
            sa[--bkt[s[lms[i]]]] = lms[i];
        bucket_ends(false);
        for (int64_t i = 0; i < n; ++i) {
            int64_t j = sa[i] - 1;
            if (sa[i] > 0 && !ls[j]) sa[bkt[s[j]]++] = j;
        }
        bucket_ends(true);
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t j = sa[i] - 1;
            if (sa[i] > 0 && ls[j]) sa[--bkt[s[j]]] = j;
        }
    };

    std::vector<int64_t> lms;
    for (int64_t i = 1; i < n; ++i)
        if (is_lms(i)) lms.push_back(i);

    induce(lms);

    // name LMS substrings in SA order
    std::vector<int64_t> name(n, -1);
    int64_t nnames = 0, prev = -1;
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = sa[i];
        if (p <= 0 || !is_lms(p)) continue;
        if (prev >= 0) {
            // compare LMS substrings at prev and p
            int64_t a = prev, b = p;
            bool same = true;
            for (int64_t d = 0;; ++d) {
                bool la = is_lms(a + d), lb = is_lms(b + d);
                if (d > 0 && la && lb) break;
                if (d > 0 && (la != lb)) { same = false; break; }
                if (s[a + d] != s[b + d] || ls[a + d] != ls[b + d]) { same = false; break; }
            }
            if (!same) nnames++;
        } else {
            nnames++;
        }
        name[p] = nnames - 1;
        prev = p;
    }

    std::vector<int64_t> s1(lms.size());
    for (size_t i = 0; i < lms.size(); ++i) s1[i] = name[lms[i]];

    std::vector<int64_t> sa1(lms.size());
    if ((int64_t)lms.size() == nnames) {
        for (size_t i = 0; i < s1.size(); ++i) sa1[s1[i]] = (int64_t)i;
    } else {
        sais_int(s1.data(), sa1.data(), (int64_t)s1.size(), nnames);
    }

    std::vector<int64_t> ordered(lms.size());
    for (size_t i = 0; i < lms.size(); ++i) ordered[i] = lms[sa1[i]];
    induce(ordered);
}

// ---------------------------------------------------------------------------

struct ReadSet {
    std::vector<std::string> seqs;
};

static bool load_fastx(const char* path, ReadSet& rs) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    std::string line, seq;
    char buf[1 << 16];
    int mode = 0;  // 0 unknown, 1 fasta, 2 fastq
    int fq_line = 0;
    auto flush_seq = [&]() {
        if (!seq.empty()) { rs.seqs.push_back(seq); seq.clear(); }
    };
    while (fgets(buf, sizeof buf, f)) {
        size_t len = strlen(buf);
        while (len && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) buf[--len] = 0;
        if (!len) continue;
        if (buf[0] == '>') { mode = 1; flush_seq(); continue; }
        if (buf[0] == '@' && mode != 1) { mode = 2; flush_seq(); fq_line = 1; continue; }
        if (mode == 2) {
            if (fq_line == 1) { seq.assign(buf); rs.seqs.push_back(seq); seq.clear(); }
            fq_line = (fq_line + 1) % 4;  // seq, +, qual, next @ handled above
            if (fq_line == 3) fq_line = 0;
            continue;
        }
        seq.append(buf);
    }
    flush_seq();
    fclose(f);
    return true;
}

static int64_t g_non_acgt = 0;  // counted per process; reported at exit

static int8_t rank_of(char c) {
    switch (c) {
        case 'A': case 'a': return 1;
        case 'C': case 'c': return 2;
        case 'G': case 'g': return 3;
        case 'T': case 't': return 4;
        default:
            // Non-ACGT degrades to A in the index (wrong k-mer intervals for
            // the affected positions); the reference pipeline expects reads
            // to have been run through `preprocess` first, which rewrites
            // ambiguity codes. Count and loudly warn instead of silently
            // corrupting (StriDe/preprocess.cpp is the upstream fix).
            __atomic_add_fetch(&g_non_acgt, 1, __ATOMIC_RELAXED);
            return 1;
    }
}

static const uint32_t SSA_SAMPLE_RATE = 64;  // DEFAULT_SA_SAMPLE_RATE (SampledSuffixArray.h:71)

// build BWT of the read set (optionally per-read reversed) and write raw
// symbol stream + lexico index + sampled SA
static bool build_and_write(const ReadSet& rs, bool reversed, const std::string& path,
                            const std::string& lex_path, const std::string& ssa_path) {
    const int64_t nreads = (int64_t)rs.seqs.size();
    int64_t total = 0;
    for (auto& r : rs.seqs) total += (int64_t)r.size() + 1;

    // text: read i's bases -> (nreads+1) + (rank-1), its sentinel -> i+1,
    // plus a single global terminator 0 (SA-IS requires the text to end with
    // the unique smallest symbol; its suffix is skipped during extraction)
    std::vector<int64_t> text(total + 1);
    std::vector<int64_t> starts(nreads);
    int64_t pos = 0;
    for (int64_t i = 0; i < nreads; ++i) {
        const std::string& r = rs.seqs[i];
        starts[i] = pos;
        if (!reversed) {
            for (char c : r) text[pos++] = nreads + 1 + rank_of(c) - 1;
        } else {
            for (auto it = r.rbegin(); it != r.rend(); ++it)
                text[pos++] = nreads + 1 + rank_of(*it) - 1;
        }
        text[pos++] = i + 1;
    }
    text[pos] = 0;

    std::vector<int64_t> sa(total + 1);
    sais_int(text.data(), sa.data(), total + 1, nreads + 5);

    std::vector<uint8_t> is_start(total + 1, 0);
    for (int64_t i = 0; i < nreads; ++i) is_start[starts[i]] = 1;

    FILE* f = fopen(path.c_str(), "wb");
    if (!f) return false;
    uint32_t magic = 0x4253524c;  // 'LRSB'
    uint64_t ns = (uint64_t)nreads, nsym = (uint64_t)total;
    fwrite(&magic, 4, 1, f);
    fwrite(&ns, 8, 1, f);
    fwrite(&nsym, 8, 1, f);
    std::vector<int8_t> out(total);
    std::vector<uint32_t> lex;          // read id per '$' in BWT row order
    lex.reserve(nreads);
    const int64_t n_samples = total / SSA_SAMPLE_RATE + 1;
    std::vector<uint32_t> ssa(2 * n_samples, 0xFFFFFFFFu);
    int64_t w = 0;
    for (int64_t i = 0; i <= total; ++i) {
        int64_t p = sa[i];
        if (p == total) continue;  // the lone global-terminator suffix
        // read owning text position p: starts[] is sorted; binary search
        if (w % SSA_SAMPLE_RATE == 0) {
            int64_t lo = 0, hi = nreads - 1;
            while (lo < hi) {
                int64_t mid = (lo + hi + 1) / 2;
                if (starts[mid] <= p) lo = mid; else hi = mid - 1;
            }
            ssa[2 * (w / SSA_SAMPLE_RATE)] = (uint32_t)lo;
            ssa[2 * (w / SSA_SAMPLE_RATE) + 1] = (uint32_t)(p - starts[lo]);
        }
        if (is_start[p]) {
            out[w++] = 0;  // whole-read suffix preceded by its own '$'
            int64_t lo = 0, hi = nreads - 1;
            while (lo < hi) {
                int64_t mid = (lo + hi + 1) / 2;
                if (starts[mid] <= p) lo = mid; else hi = mid - 1;
            }
            lex.push_back((uint32_t)lo);
        } else {
            int64_t v = text[p - 1];
            out[w++] = (v <= nreads) ? 0 : (int8_t)(v - nreads - 1 + 1);
        }
    }
    fwrite(out.data(), 1, total, f);
    fclose(f);

    FILE* lf = fopen(lex_path.c_str(), "wb");
    if (!lf) return false;
    uint32_t lmagic = 0x4c53524c;  // 'LRSL'
    fwrite(&lmagic, 4, 1, lf);
    fwrite(&ns, 8, 1, lf);
    fwrite(lex.data(), 4, lex.size(), lf);
    fclose(lf);

    FILE* sf = fopen(ssa_path.c_str(), "wb");
    if (!sf) return false;
    uint32_t smagic = 0x5353524c;  // 'LRSS'
    uint32_t rate = SSA_SAMPLE_RATE;
    fwrite(&smagic, 4, 1, sf);
    fwrite(&rate, 4, 1, sf);
    fwrite(&ns, 8, 1, sf);
    fwrite(&nsym, 8, 1, sf);
    fwrite(ssa.data(), 4, ssa.size(), sf);
    fclose(sf);
    return true;
}

int main(int argc, char** argv) {
    if (argc != 3) {
        fprintf(stderr, "usage: fmbuild reads.fa out_prefix\n");
        return 2;
    }
    ReadSet rs;
    if (!load_fastx(argv[1], rs)) {
        fprintf(stderr, "fmbuild: cannot read %s\n", argv[1]);
        return 1;
    }
    fprintf(stderr, "fmbuild: %zu reads\n", rs.seqs.size());
    std::string prefix = argv[2];
    bool ok_f = false, ok_r = false;
    std::thread tf([&] {
        ok_f = build_and_write(rs, false, prefix + ".bwtraw", prefix + ".lex",
                               prefix + ".ssa");
    });
    std::thread tr([&] {
        ok_r = build_and_write(rs, true, prefix + ".rbwtraw", prefix + ".rlex",
                               prefix + ".rssa");
    });
    tf.join();
    tr.join();
    if (!ok_f || !ok_r) return 1;
    if (g_non_acgt > 0)
        fprintf(stderr,
                "fmbuild: WARNING: %lld non-ACGT bases mapped to A — run "
                "`preprocess` first for a faithful index\n",
                (long long)(g_non_acgt / 2));  // counted once per strand build
    fprintf(stderr, "fmbuild: wrote %s.{bwtraw,rbwtraw,lex,rlex,ssa,rssa}\n",
            prefix.c_str());
    return 0;
}
