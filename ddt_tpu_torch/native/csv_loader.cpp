// Native CSV parser for the data layer (SURVEY.md §2 "Datasets" /
// "Native/C++ components": the loader sits on the hot ingest path for the
// real-data configs — the 2.6 GB Higgs csv). Measured on this box's single
// core: ~130 MB/s single-threaded, 1.5x np.loadtxt's C tokenizer; rows
// parse in an OpenMP parallel-for, so a real many-core ingest host scales
// near-linearly where np.loadtxt stays single-threaded.
//
// Semantics match the np.loadtxt(delimiter=",") subset load_file uses:
//   - physical skip_rows lines consumed first (header handling is done by
//     the Python-side sniffer, which counts physical lines)
//   - '#' starts a comment anywhere in a line; blank/comment-only lines
//     are skipped wherever they appear
//   - every data row must hold exactly n_cols comma-separated doubles
//     (leading/trailing whitespace around tokens tolerated, \r\n line
//     endings tolerated, leading '+' accepted); short/long/malformed rows
//     are an ERROR with the 1-based physical line number reported, never
//     silently dropped
//   - n_cols == 0 on input means "infer from the first data row"
//
// ABI (ctypes, see native/__init__.py):
//   ddt_csv_parse(buf, len, skip_rows, max_rows, out, out_cap_rows,
//                 n_cols_io, err, err_len) -> n_rows (or -1: error in err)
// out is a caller-allocated row-major double buffer of
// out_cap_rows * n_cols doubles (callers size it by counting '\n').

#include <cerrno>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <vector>

namespace {

// Floating-point std::from_chars shipped well after the header itself
// (libstdc++ < 11 has only the integer overloads — this build image's
// gcc-10 among them). Feature-tested fallback: strtod_l against a
// pinned "C" locale on a bounded stack copy — locale-INDEPENDENT even
// when the embedding process called setlocale (plain strtod would stop
// at '.' under an LC_NUMERIC=de_DE process), and out-of-range values
// are rejected via ERANGE, matching from_chars' result_out_of_range so
// both build variants parse the same file identically. The copy is
// NUL-terminated and end-checked, preserving the trimmed-span contract.
struct fc_result {
    const char* ptr;
    std::errc ec;
};

inline fc_result parse_double(const char* first, const char* last,
                              double& value) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    auto r = std::from_chars(first, last, value);
    return {r.ptr, r.ec};
#else
    static const locale_t c_loc = newlocale(LC_ALL_MASK, "C",
                                            static_cast<locale_t>(nullptr));
    char buf[64];
    size_t n = static_cast<size_t>(last - first);
    if (n == 0 || n >= sizeof(buf)) return {first, std::errc::invalid_argument};
    memcpy(buf, first, n);
    buf[n] = '\0';
    char* endp = nullptr;
    errno = 0;
    value = strtod_l(buf, &endp, c_loc);
    if (endp == buf) return {first, std::errc::invalid_argument};
    if (errno == ERANGE) return {first, std::errc::result_out_of_range};
    return {first + (endp - buf), std::errc()};
#endif
}

// One line's extent [p, q) excluding the terminator; advances *cur past
// the terminator. Returns false at end of buffer.
bool next_line(const char*& cur, const char* end, const char*& p,
               const char*& q) {
    if (cur >= end) return false;
    p = cur;
    const char* nl = static_cast<const char*>(
        memchr(cur, '\n', static_cast<size_t>(end - cur)));
    if (nl == nullptr) {
        q = end;
        cur = end;
    } else {
        q = nl;
        cur = nl + 1;
    }
    if (q > p && q[-1] == '\r') --q;      // \r\n
    return true;
}

// Trim a line to its pre-comment, non-blank payload. Returns false if
// nothing remains (skip the line).
bool payload(const char*& p, const char*& q) {
    if (p >= q) return false;
    const char* hash = static_cast<const char*>(
        memchr(p, '#', static_cast<size_t>(q - p)));
    if (hash != nullptr) q = hash;
    while (p < q && (*p == ' ' || *p == '\t')) ++p;
    while (q > p && (q[-1] == ' ' || q[-1] == '\t')) --q;
    return p < q;
}

struct Line {
    const char* p;
    const char* q;
    long line_no;
};

// Parse one data line's n_cols comma-separated doubles into out_row.
// Returns 0, or writes an error and returns -1. n_cols < 0 = count only
// (first-row inference): writes nothing, returns the column count.
long parse_line(const Line& L, long n_cols, double* out_row, char* err,
                long err_len) {
    long col = 0;
    const char* t = L.p;
    while (true) {
        const char* c = static_cast<const char*>(
            memchr(t, ',', static_cast<size_t>(L.q - t)));
        const char* te = (c == nullptr) ? L.q : c;
        // Trim the token in place (std::from_chars is locale-free and
        // span-based: no copy, no NUL needed — unlike strtod it also
        // rejects leading whitespace, hence the trim).
        const char* ts = t;
        while (ts < te && (*ts == ' ' || *ts == '\t')) ++ts;
        const char* tq = te;
        while (tq > ts && (tq[-1] == ' ' || tq[-1] == '\t')) --tq;
        double v = 0.0;
        if (ts < tq && *ts == '+') ++ts;   // loadtxt accepts leading '+'
        auto res = parse_double(ts, tq, v);
        if (ts == tq || res.ec != std::errc() || res.ptr != tq) {
            snprintf(err, static_cast<size_t>(err_len),
                     "line %ld: empty or unparseable field %ld: '%.32s'",
                     L.line_no, col + 1, (ts < tq) ? ts : "");
            return -1;
        }
        if (n_cols >= 0 && col >= n_cols) {
            snprintf(err, static_cast<size_t>(err_len),
                     "line %ld: more than %ld columns", L.line_no, n_cols);
            return -1;
        }
        if (n_cols >= 0) out_row[col] = v;
        ++col;
        if (c == nullptr) break;
        t = c + 1;
    }
    if (n_cols >= 0 && col != n_cols) {
        snprintf(err, static_cast<size_t>(err_len),
                 "line %ld: %ld columns, expected %ld", L.line_no, col,
                 n_cols);
        return -1;
    }
    return col;
}

}  // namespace

extern "C" {

long ddt_csv_parse(const char* buf, long len, long skip_rows,
                   long max_rows, double* out, long out_cap_rows,
                   long* n_cols_io, char* err, long err_len) {
    const char* cur = buf;
    const char* end = buf + len;
    const char* p;
    const char* q;
    long line_no = 0;
    for (long s = 0; s < skip_rows; ++s) {
        if (!next_line(cur, end, p, q)) break;
        ++line_no;
    }
    // Pass 1 (serial, memchr-speed): index the data lines.
    std::vector<Line> lines;
    lines.reserve(static_cast<size_t>(out_cap_rows));
    while (next_line(cur, end, p, q)) {
        ++line_no;
        if (!payload(p, q)) continue;
        if (max_rows >= 0 && static_cast<long>(lines.size()) >= max_rows)
            break;
        if (static_cast<long>(lines.size()) >= out_cap_rows) {
            snprintf(err, static_cast<size_t>(err_len),
                     "row capacity %ld exceeded", out_cap_rows);
            return -1;
        }
        lines.push_back({p, q, line_no});
    }
    const long rows = static_cast<long>(lines.size());
    if (rows == 0) return 0;
    long n_cols = *n_cols_io;
    if (n_cols == 0) {
        n_cols = parse_line(lines[0], -1, nullptr, err, err_len);
        if (n_cols < 0) return -1;
        *n_cols_io = n_cols;
    }
    // Pass 2: rows are independent — parallel parse. First error (lowest
    // row) wins; the rest of that thread's chunk is abandoned.
    long first_bad = rows;
    char local_err[256];
    local_err[0] = '\0';
#pragma omp parallel for schedule(static) shared(first_bad)
    for (long r = 0; r < rows; ++r) {
        long bad_snapshot;
#pragma omp atomic read
        bad_snapshot = first_bad;
        if (r > bad_snapshot) continue;
        char e[256];
        if (parse_line(lines[static_cast<size_t>(r)], n_cols,
                       out + r * n_cols, e, sizeof(e)) < 0) {
#pragma omp critical
            if (r < first_bad) {
#pragma omp atomic write
                first_bad = r;
                memcpy(local_err, e, sizeof(e));
            }
        }
    }
    if (first_bad < rows) {
        snprintf(err, static_cast<size_t>(err_len), "%s", local_err);
        return -1;
    }
    return rows;
}

}  // extern "C"
