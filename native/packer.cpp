// slacken native IO: FASTA/FASTQ parsing + 2-bit code packing.
//
// The reference framework runs entirely on the JVM with Spark executors
// doing string work; here the host-side hot path (feeding packed base codes
// to the device) is native C++ behind a C ABI consumed via ctypes
// (slacken/native.py). Parsing + encoding run at memory bandwidth,
// leaving Python to orchestrate device batches only.
//
// Encoding matches ops/encode.py: A=0 C=1 G=2 T=U=3, INVALID=4
// (BitRepresentation.scala:31-44 semantics).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr uint8_t INVALID = 4;

struct Lut {
    uint8_t v[256];
    constexpr Lut() : v{} {
        for (int i = 0; i < 256; i++) v[i] = INVALID;
        v['A'] = v['a'] = 0;
        v['C'] = v['c'] = 1;
        v['G'] = v['g'] = 2;
        v['T'] = v['t'] = 3;
        v['U'] = v['u'] = 3;
    }
};
constexpr Lut LUT;

inline const char* find_nl(const char* p, const char* end) {
    const void* r = memchr(p, '\n', static_cast<size_t>(end - p));
    return r ? static_cast<const char*>(r) : end;
}

}  // namespace

extern "C" {

// Encode a raw byte string into 2-bit codes (INVALID for non-ACGTU).
void stpu_encode(const char* src, int64_t n, uint8_t* dst) {
    for (int64_t i = 0; i < n; i++) dst[i] = LUT.v[static_cast<uint8_t>(src[i])];
}

// First pass over a FASTQ chunk: count complete records and the maximum
// sequence length. The chunk must start at a record boundary ('@').
// Returns the byte offset of the first incomplete record (chunk remainder),
// or -1 on format error.
int64_t stpu_fastq_scan(const char* buf, int64_t n, int64_t* n_records, int64_t* max_len) {
    const char* p = buf;
    const char* end = buf + n;
    int64_t count = 0, maxl = 0;
    const char* last_complete = buf;
    while (p < end) {
        if (*p != '@') return -1;
        const char* h_end = find_nl(p, end);
        if (h_end == end) break;
        const char* s = h_end + 1;
        const char* s_end = find_nl(s, end);
        if (s_end == end) break;
        const char* plus = s_end + 1;
        const char* plus_end = find_nl(plus, end);
        if (plus_end == end) break;
        if (plus >= end || *plus != '+') return -1;
        const char* q = plus_end + 1;
        const char* q_end = find_nl(q, end);
        if (q_end == end && (end - q) < (s_end - s)) break;  // truncated quals
        int64_t slen = s_end - s;
        if (slen > maxl) maxl = slen;
        count++;
        p = (q_end == end) ? end : q_end + 1;
        last_complete = p;
    }
    *n_records = count;
    *max_len = maxl;
    return last_complete - buf;
}

// Second pass: fill codes [n_records, row_len] (pre-filled by caller or not;
// we pad with INVALID), lengths, and title spans (offset+length into buf).
// Sequences longer than row_len are truncated.
int64_t stpu_fastq_fill(const char* buf, int64_t n, int64_t n_records, int64_t row_len,
                        uint8_t* codes, int32_t* lengths,
                        int64_t* title_off, int32_t* title_len) {
    const char* p = buf;
    const char* end = buf + n;
    for (int64_t r = 0; r < n_records; r++) {
        const char* h_end = find_nl(p, end);
        title_off[r] = (p + 1) - buf;
        title_len[r] = static_cast<int32_t>(h_end - (p + 1));
        const char* s = h_end + 1;
        const char* s_end = find_nl(s, end);
        int64_t slen = s_end - s;
        int64_t keep = slen < row_len ? slen : row_len;
        uint8_t* out = codes + r * row_len;
        for (int64_t i = 0; i < keep; i++) out[i] = LUT.v[static_cast<uint8_t>(s[i])];
        if (keep < row_len) memset(out + keep, INVALID, static_cast<size_t>(row_len - keep));
        lengths[r] = static_cast<int32_t>(slen);
        const char* plus_end = find_nl(s_end + 1, end);
        const char* q_end = find_nl(plus_end + 1, end);
        p = (q_end == end) ? end : q_end + 1;
    }
    return 0;
}

// FASTA: count records and total/max sequence lengths (whitespace excluded).
// Chunks must start at '>' (or contain zero records).
int64_t stpu_fasta_scan(const char* buf, int64_t n, int64_t* n_records, int64_t* max_len) {
    const char* p = buf;
    const char* end = buf + n;
    int64_t count = 0, maxl = 0, cur = 0;
    bool in_seq = false;
    while (p < end) {
        const char* line_end = find_nl(p, end);
        if (p < line_end && *p == '>') {
            if (in_seq && cur > maxl) maxl = cur;
            cur = 0;
            count++;
            in_seq = true;
        } else {
            cur += line_end - p;
            // trailing \r
            if (line_end > p && line_end[-1] == '\r') cur--;
        }
        p = line_end + 1;
    }
    if (in_seq && cur > maxl) maxl = cur;
    *n_records = count;
    *max_len = maxl;
    return n;
}

// FASTA fill: encode each record's sequence into rows of codes.
int64_t stpu_fasta_fill(const char* buf, int64_t n, int64_t n_records, int64_t row_len,
                        uint8_t* codes, int32_t* lengths,
                        int64_t* title_off, int32_t* title_len) {
    const char* p = buf;
    const char* end = buf + n;
    int64_t r = -1;
    int64_t written = 0;
    uint8_t* out = nullptr;
    while (p < end) {
        const char* line_end = find_nl(p, end);
        int64_t llen = line_end - p;
        if (llen > 0 && line_end[-1] == '\r') llen--;
        if (llen > 0 && *p == '>') {
            if (r >= 0) {
                lengths[r] = static_cast<int32_t>(written);
                int64_t w = written < row_len ? written : row_len;
                if (w < row_len)
                    memset(out + w, INVALID, static_cast<size_t>(row_len - w));
            }
            r++;
            if (r >= n_records) return -1;
            title_off[r] = (p + 1) - buf;
            title_len[r] = static_cast<int32_t>(llen - 1);
            out = codes + r * row_len;
            written = 0;
        } else if (r >= 0) {
            int64_t keep = llen;
            if (written + keep > row_len) keep = row_len - written;
            for (int64_t i = 0; i < keep; i++)
                out[written + i] = LUT.v[static_cast<uint8_t>(p[i])];
            written += llen;  // true length keeps counting past row_len
        }
        p = line_end + 1;
    }
    if (r >= 0) {
        int64_t w = written < row_len ? written : row_len;
        lengths[r] = static_cast<int32_t>(written);
        if (w < row_len) memset(out + w, INVALID, static_cast<size_t>(row_len - w));
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-read Kraken output strings (classify detailed mode).
// Replicates classify.mate_hits + hits_to_strings: ordered (taxon, count)
// runs with adjacent-equal merging, 'A' pseudo-hits for ambiguous char runs
// >= k, the |:| mate border, and the "len" / "len1|len2" length string.
// ---------------------------------------------------------------------------

namespace {

struct HitWriter {
    char* p;
    char* start;
    explicit HitWriter(char* dst) : p(dst), start(dst) {}
    void put_ch(char c) { *p++ = c; }
    void put_str(const char* s) { while (*s) *p++ = *s++; }
    void put_int(int64_t v) {
        if (v < 0) { *p++ = '-'; v = -v; }
        char tmp[24];
        int n = 0;
        do { tmp[n++] = static_cast<char>('0' + v % 10); v /= 10; } while (v);
        while (n) *p++ = tmp[--n];
    }
};

// Emit hits for one mate slice [a, b); returns k-mer count of the mate.
// `last_taxon`/`last_count` carry the pending run (for adjacent merging).
int64_t emit_mate(const uint8_t* codes, const int32_t* wt, int64_t a, int64_t b,
                  int64_t k, HitWriter& w, int64_t& last_taxon, int64_t& last_count,
                  bool& have_last) {
    int64_t mate_kmers = 0;
    auto flush = [&]() {
        if (have_last) {
            if (w.p != w.start && w.p[-1] != '\t') w.put_ch(' ');
            if (last_taxon == -1) w.put_ch('A');
            else w.put_int(last_taxon);
            w.put_ch(':');
            w.put_int(last_count);
            have_last = false;
        }
    };
    auto add = [&](int64_t taxon, int64_t count) {
        if (have_last && last_taxon == taxon) {
            last_count += count;
        } else {
            flush();
            last_taxon = taxon;
            last_count = count;
            have_last = true;
        }
    };
    int64_t i = a;
    while (i < b) {
        bool valid = codes[i] < 4;
        int64_t j = i;
        while (j < b && (codes[j] < 4) == valid) j++;
        int64_t run = j - i;
        if (run >= k) {
            if (valid) {
                for (int64_t wpos = i; wpos <= j - k; wpos++) {
                    add(wt[wpos], 1);
                    mate_kmers++;
                }
            } else {
                add(-1, run - k + 1);
                mate_kmers += run - k + 1;
            }
        }
        i = j;
    }
    flush();
    return mate_kmers;
}

}  // namespace

extern "C" {

// For each row: write "<hit_details>\t<length_string>\n" into the row's
// private slot out + r * cap_row (cap_row = row_stride * 14 + 64, matching
// the Python-side allocation), so rows are independent and the loop is
// OpenMP-parallel. splits[r] = -1 for single reads, else the R1 length
// (separator column at that index). offsets[r] = END of row r's bytes
// (absolute); the caller derives each start as r * cap_row.
int64_t stpu_hit_lines(const uint8_t* codes, const int32_t* wt, int64_t n_rows,
                       int64_t row_stride, const int64_t* splits,
                       const int64_t* row_lens, int64_t k,
                       char* out, int64_t* offsets) {
    const int64_t cap_row = row_stride * 14 + 64;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; r++) {
        HitWriter w(out + r * cap_row);
        const uint8_t* c = codes + r * row_stride;
        const int32_t* t = wt + r * row_stride;
        int64_t last_taxon = 0, last_count = 0;
        bool have_last = false;
        int64_t len1, len2 = -1;
        if (splits[r] < 0) {
            len1 = emit_mate(c, t, 0, row_lens[r], k, w, last_taxon, last_count, have_last);
        } else {
            len1 = emit_mate(c, t, 0, splits[r], k, w, last_taxon, last_count, have_last);
            // emit_mate flushed its pending run (runs never merge across
            // the mate border); emit |:|
            if (w.p != w.start) w.put_ch(' ');
            w.put_str("|:|");
            len2 = emit_mate(c, t, splits[r] + 1, row_lens[r], k, w, last_taxon, last_count, have_last);
        }
        // prepend-style: we must place length string BEFORE details; emit into
        // a temp zone instead: simpler to append details first then lengths
        // would break format. So: we wrote details already — relocate.
        // To avoid memmove we write "<details>" first and store lengths at end
        // separated by \x01; Python reorders. Simpler: write lengths after a
        // \t marker; the Python wrapper splits on the LAST \t.
        w.put_ch('\t');
        w.put_int(len1 + (k - 1));
        if (splits[r] >= 0) {
            w.put_ch('|');
            w.put_int(len2 + (k - 1));
        }
        w.put_ch('\n');
        offsets[r] = w.p - out;
    }
    offsets[n_rows] = n_rows ? offsets[n_rows - 1] : 0;
    return n_rows ? offsets[n_rows - 1] : 0;
}

// Runs-based variant: the device already reduced each read to its ordered
// hit runs (slacken/ops/hitruns.py), so each row is O(runs) instead of
// O(row_stride). values[r*cap+j] = (taxon+2)<<1 | mate (taxon -1 = 'A');
// counts parallel; totals[r*2+m] = per-mate k-mer sums. Same private-slot
// output contract as stpu_hit_lines with cap_row supplied by the caller.
int64_t stpu_hit_lines_runs(const int32_t* values, const int32_t* counts,
                            const int64_t* nruns, const int64_t* totals,
                            const int64_t* splits, int64_t n_rows,
                            int64_t cap, int64_t k, int64_t cap_row,
                            char* out, int64_t* offsets) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; r++) {
        HitWriter w(out + r * cap_row);
        const bool paired = splits[r] >= 0;
        const int32_t* v = values + r * cap;
        const int32_t* c = counts + r * cap;
        const int64_t n = nruns[r];
        bool wrote = false;
        auto emit_run = [&](int64_t pv, int64_t cnt) {
            if (wrote) w.put_ch(' ');
            int64_t taxon = (pv >> 1) - 2;
            if (taxon == -1) w.put_ch('A');
            else w.put_int(taxon);
            w.put_ch(':');
            w.put_int(cnt);
            wrote = true;
        };
        int64_t j = 0;
        for (; j < n && (v[j] & 1) == 0; j++) emit_run(v[j], c[j]);
        if (paired) {
            if (wrote) w.put_ch(' ');
            w.put_str("|:|");
            wrote = true;
            for (; j < n; j++) emit_run(v[j], c[j]);
        }
        w.put_ch('\t');
        w.put_int(totals[r * 2] + (k - 1));
        if (paired) {
            w.put_ch('|');
            w.put_int(totals[r * 2 + 1] + (k - 1));
        }
        w.put_ch('\n');
        offsets[r] = w.p - out;
    }
    offsets[n_rows] = n_rows ? offsets[n_rows - 1] : 0;
    return n_rows ? offsets[n_rows - 1] : 0;
}

// Full Kraken output lines from device hit runs:
//   "C|U\t<title>\t<taxon>\t<len[|len2]>\t<details>\n"
// per row, into private slots of cap_row bytes; ends[r] = absolute END of
// row r's bytes. titles arrive as one concatenated blob with offsets
// (title r = titles[toffs[r], toffs[r+1])). This removes the per-read
// Python f-string from the streaming detailed writer.
int64_t stpu_output_lines_runs(
    const int32_t* values, const int32_t* counts, const int64_t* nruns,
    const int64_t* totals, const int64_t* splits, const char* titles,
    const int64_t* toffs, const int64_t* rtax, const uint8_t* classified,
    int64_t n_rows, int64_t cap, int64_t k, int64_t cap_row, char* out,
    int64_t* ends) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; r++) {
        HitWriter w(out + r * cap_row);
        w.put_ch(classified[r] ? 'C' : 'U');
        w.put_ch('\t');
        for (int64_t t = toffs[r]; t < toffs[r + 1]; t++) w.put_ch(titles[t]);
        w.put_ch('\t');
        w.put_int(rtax[r]);
        w.put_ch('\t');
        const bool paired = splits[r] >= 0;
        w.put_int(totals[r * 2] + (k - 1));
        if (paired) {
            w.put_ch('|');
            w.put_int(totals[r * 2 + 1] + (k - 1));
        }
        w.put_ch('\t');
        const int32_t* v = values + r * cap;
        const int32_t* c = counts + r * cap;
        const int64_t n = nruns[r];
        bool wrote = false;
        auto emit_run = [&](int64_t pv, int64_t cnt) {
            if (wrote) w.put_ch(' ');
            int64_t taxon = (pv >> 1) - 2;
            if (taxon == -1) w.put_ch('A');
            else w.put_int(taxon);
            w.put_ch(':');
            w.put_int(cnt);
            wrote = true;
        };
        int64_t j = 0;
        for (; j < n && (v[j] & 1) == 0; j++) emit_run(v[j], c[j]);
        if (paired) {
            if (wrote) w.put_ch(' ');
            w.put_str("|:|");
            wrote = true;
            for (; j < n; j++) emit_run(v[j], c[j]);
        }
        w.put_ch('\n');
        ends[r] = w.p - out;
    }
    return 0;
}

// Full Kraken output lines from DENSE window taxa ([B, L] i32 + codes),
// the detailed-mode default (the hit-runs device reduction is the opt-in
// alternative — see classify.py).
// Line format per Classifier.scala:184-251 / TaxonCounts output strings.
// Same private-slot + ends[] contract as stpu_output_lines_runs. Two
// passes per row: a cheap k-mer count pass for the length column (which
// precedes the details in the Kraken line), then the emit_mate detail walk.
int64_t stpu_output_lines_dense(
    const uint8_t* codes, const int32_t* wt, const int64_t* splits,
    const int64_t* row_lens, const char* titles, const int64_t* toffs,
    const int64_t* rtax, const uint8_t* classified, int64_t n_rows,
    int64_t row_stride, int64_t k, int64_t cap_row, char* out,
    int64_t* ends) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_rows; r++) {
        HitWriter w(out + r * cap_row);
        const uint8_t* c = codes + r * row_stride;
        const int32_t* t = wt + r * row_stride;
        const bool paired = splits[r] >= 0;
        w.put_ch(classified[r] ? 'C' : 'U');
        w.put_ch('\t');
        for (int64_t i = toffs[r]; i < toffs[r + 1]; i++) w.put_ch(titles[i]);
        w.put_ch('\t');
        w.put_int(rtax[r]);
        w.put_ch('\t');
        auto count_kmers = [&](int64_t a, int64_t b) {
            int64_t total = 0, i = a;
            while (i < b) {
                bool valid = c[i] < 4;
                int64_t j = i;
                while (j < b && (c[j] < 4) == valid) j++;
                if (j - i >= k) total += j - i - k + 1;
                i = j;
            }
            return total;
        };
        const int64_t end1 = paired ? splits[r] : row_lens[r];
        w.put_int(count_kmers(0, end1) + (k - 1));
        if (paired) {
            w.put_ch('|');
            w.put_int(count_kmers(splits[r] + 1, row_lens[r]) + (k - 1));
        }
        w.put_ch('\t');
        int64_t last_taxon = 0, last_count = 0;
        bool have_last = false;
        if (!paired) {
            emit_mate(c, t, 0, row_lens[r], k, w, last_taxon, last_count, have_last);
        } else {
            // emit_mate flushes its pending run before returning, so the
            // first mate's hits are complete here; runs never merge
            // across the |:| border
            emit_mate(c, t, 0, splits[r], k, w, last_taxon, last_count, have_last);
            if (w.p[-1] != '\t') w.put_ch(' ');
            w.put_str("|:|");
            emit_mate(c, t, splits[r] + 1, row_lens[r], k, w, last_taxon,
                      last_count, have_last);
        }
        w.put_ch('\n');
        ends[r] = w.p - out;
    }
    return 0;
}

// Gather selected rows' private slots into one contiguous buffer (the
// streaming writer's final assembly — replaces a per-row Python slice
// join). Returns total bytes written to dst.
int64_t stpu_gather_rows(const char* src, const int64_t* starts,
                         const int64_t* ends, const int64_t* idx,
                         int64_t n_idx, char* dst) {
    int64_t off = 0;
    for (int64_t i = 0; i < n_idx; i++) {
        const int64_t r = idx[i];
        const int64_t len = ends[r] - starts[r];
        memcpy(dst + off, src + starts[r], static_cast<size_t>(len));
        off += len;
    }
    return off;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LSD radix sort of (uint64 key, int32 value) pairs, 8-bit digits.
// Replaces numpy lexsort/argsort in the host build path (the reference leans
// on fastutil LongArrays.radixSort for the same job — KmerTable.scala:175-187).
// Stable; optional value pre-passes give (key, value) lexicographic order for
// non-negative values. Uniform-byte passes are skipped (common for high key
// bytes when keys are < 2^62 and for small taxon ids). Passes are
// OpenMP-parallel when compiled with -fopenmp: per-thread histograms over
// contiguous slices, exclusive scan over (digit, thread) in thread order so
// stability is preserved, then independent scatters.

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct KV { uint64_t* k; int32_t* v; };

// one stable counting pass on 8-bit digit `shift` of key (or value when
// on_val). Returns false if the digit was uniform (pass skipped, no copy).
template <bool ON_VAL>
bool radix_pass(const KV src, KV dst, int64_t n, int shift) {
#ifdef _OPENMP
    int nt = omp_get_max_threads();
#else
    int nt = 1;
#endif
    if (nt > 64) nt = 64;
    if (n < (int64_t)1 << 16) nt = 1;
    std::vector<int64_t> hist((size_t)nt * 256, 0);
    int64_t chunk = (n + nt - 1) / nt;

#ifdef _OPENMP
#pragma omp parallel for num_threads(nt) schedule(static, 1)
#endif
    for (int t = 0; t < nt; t++) {
        int64_t a = t * chunk, b = a + chunk < n ? a + chunk : n;
        int64_t* h = &hist[(size_t)t * 256];
        if (ON_VAL)
            for (int64_t i = a; i < b; i++) h[((uint32_t)src.v[i] >> shift) & 0xFF]++;
        else
            for (int64_t i = a; i < b; i++) h[(src.k[i] >> shift) & 0xFF]++;
    }
    // uniform-digit check on the combined histogram
    {
        int d0 = ON_VAL ? (((uint32_t)src.v[0] >> shift) & 0xFF)
                        : ((src.k[0] >> shift) & 0xFF);
        int64_t c = 0;
        for (int t = 0; t < nt; t++) c += hist[(size_t)t * 256 + d0];
        if (c == n) return false;
    }
    // exclusive scan in (digit, thread) order => stability across slices
    int64_t sum = 0;
    for (int d = 0; d < 256; d++)
        for (int t = 0; t < nt; t++) {
            int64_t c = hist[(size_t)t * 256 + d];
            hist[(size_t)t * 256 + d] = sum;
            sum += c;
        }

#ifdef _OPENMP
#pragma omp parallel for num_threads(nt) schedule(static, 1)
#endif
    for (int t = 0; t < nt; t++) {
        int64_t a = t * chunk, b = a + chunk < n ? a + chunk : n;
        int64_t* h = &hist[(size_t)t * 256];
        for (int64_t i = a; i < b; i++) {
            int d = ON_VAL ? (((uint32_t)src.v[i] >> shift) & 0xFF)
                           : ((src.k[i] >> shift) & 0xFF);
            int64_t o = h[d]++;
            dst.k[o] = src.k[i];
            dst.v[o] = src.v[i];
        }
    }
    return true;
}

}  // namespace

extern "C" {

void stpu_radix_sort_kv(const uint64_t* keys, const int32_t* vals, int64_t n,
                        uint64_t* out_k, int32_t* out_v, int with_vals) {
    if (n <= 0) return;
    uint64_t* tmp_k = (uint64_t*)malloc((size_t)n * sizeof(uint64_t));
    int32_t* tmp_v = (int32_t*)malloc((size_t)n * sizeof(int32_t));
    for (int64_t i = 0; i < n; i++) { out_k[i] = keys[i]; out_v[i] = vals[i]; }
    if (!tmp_k || !tmp_v) {  // OOM: leave input copied; caller gets unsorted
        if (tmp_k) free(tmp_k);
        if (tmp_v) free(tmp_v);
        return;
    }
    KV cur{out_k, out_v}, oth{tmp_k, tmp_v};
    if (with_vals)
        for (int p = 0; p < 4; p++)
            if (radix_pass<true>(cur, oth, n, 8 * p)) { KV s = cur; cur = oth; oth = s; }
    for (int p = 0; p < 8; p++)
        if (radix_pass<false>(cur, oth, n, 8 * p)) { KV s = cur; cur = oth; oth = s; }
    if (cur.k != out_k) {
        memcpy(out_k, cur.k, (size_t)n * sizeof(uint64_t));
        memcpy(out_v, cur.v, (size_t)n * sizeof(int32_t));
    }
    free(tmp_k); free(tmp_v);
}

}  // extern "C"
