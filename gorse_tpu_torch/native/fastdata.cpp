// Fast host-side dataset parsing (a copy of gorse_tpu/native/fastdata.cpp):
// libFM and NCF text formats and CSR index arrays, parsed at memory
// bandwidth instead of Python-interpreter speed.
//
// Exposed as extern "C" for ctypes binding (no pybind11 dependency).
// Two-pass contract per format: *_count sizes the output buffers, *_parse
// fills caller-allocated arrays.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- libFM
// Format per line: <target> <idx>:<val> <idx>:<val> ...

void libfm_count(const char* buf, int64_t n, int64_t* out_rows, int64_t* out_nnz) {
    // nnz upper bound = feature TOKENS per line (tokens - 1, the first token
    // is the target) — counting ':' undersized the buffers for bare-index
    // tokens ("1 3 4"), which libfm_parse accepts with value=1.0 like the
    // Python fallback, and oversizes harmlessly for malformed tokens that
    // libfm_parse skips.
    int64_t rows = 0, nnz = 0, tokens = 0;
    bool in_tok = false;
    for (int64_t i = 0; i < n; i++) {
        char c = buf[i];
        if (c == '\n') {
            if (tokens > 0) { rows++; nnz += tokens - 1; }
            tokens = 0;
            in_tok = false;
        } else if (c == ' ' || c == '\t' || c == '\r') {
            in_tok = false;
        } else {
            if (!in_tok) { in_tok = true; tokens++; }
        }
    }
    if (tokens > 0) { rows++; nnz += tokens - 1; }
    *out_rows = rows;
    *out_nnz = nnz;
}

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static inline const char* parse_double(const char* p, const char* end, double* out) {
    char tmp[64];
    int k = 0;
    while (p < end && k < 63 &&
           ((*p >= '0' && *p <= '9') || *p == '-' || *p == '+' || *p == '.' ||
            *p == 'e' || *p == 'E')) {
        tmp[k++] = *p++;
    }
    tmp[k] = 0;
    *out = strtod(tmp, nullptr);
    return p;
}

// Returns number of rows parsed; targets<0 are clamped to 0 (the -1/1 libFM
// convention normalized to {0,1}, matching data/ctr.py).
int64_t libfm_parse(const char* buf, int64_t n, float* targets, int64_t* indptr,
                    int32_t* indices, float* values, int32_t* out_max_label) {
    const char* p = buf;
    const char* end = buf + n;
    int64_t row = 0, k = 0;
    int32_t max_label = 0;
    indptr[0] = 0;
    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { p++; continue; }
        double target;
        p = parse_double(p, end, &target);
        targets[row] = target > 0 ? (float)target : 0.0f;
        while (p < end && *p != '\n') {
            p = skip_ws(p, end);
            if (p >= end || *p == '\n') break;
            const char* tok_start = p;
            double idx;
            p = parse_double(p, end, &idx);
            bool valid = p > tok_start;  // the index must actually parse
            double val = 1.0;
            if (p < end && *p == ':') {
                p++;
                p = parse_double(p, end, &val);
            }
            // always advance past the rest of the token — a non-numeric
            // char must never stall the loop (it used to spin forever
            // writing past the end of the arrays); junk suffixes also
            // invalidate the token instead of half-parsing it
            while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') {
                p++;
                valid = false;
            }
            if (valid && idx >= 0) {
                indices[k] = (int32_t)idx;
                values[k] = (float)val;
                if (indices[k] > max_label) max_label = indices[k];
                k++;
            }
        }
        row++;
        indptr[row] = k;
        if (p < end) p++;  // consume newline
    }
    *out_max_label = max_label;
    return row;
}

// ------------------------------------------------------------------ NCF
// Train format per line: <user>\t<item>[\t...]; test format:
// (<user>,<item>)\t... — both reduce to two leading integers.

void ncf_count(const char* buf, int64_t n, int64_t* out_rows) {
    int64_t rows = 0;
    bool has = false;
    for (int64_t i = 0; i < n; i++) {
        if (buf[i] == '\n') {
            if (has) rows++;
            has = false;
        } else if (buf[i] != ' ' && buf[i] != '\r') {
            has = true;
        }
    }
    if (has) rows++;
    *out_rows = rows;
}

static inline const char* parse_int(const char* p, const char* end, int64_t* out) {
    int64_t v = 0;
    bool neg = false;
    if (p < end && *p == '-') { neg = true; p++; }
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = neg ? -v : v;
    return p;
}

int64_t ncf_parse(const char* buf, int64_t n, int32_t* users, int32_t* items) {
    const char* p = buf;
    const char* end = buf + n;
    int64_t row = 0;
    while (p < end) {
        // skip to first digit or '(' on the line
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '(')) p++;
        if (p >= end) break;
        if (*p == '\n') { p++; continue; }
        int64_t u, i;
        p = parse_int(p, end, &u);
        while (p < end && (*p == '\t' || *p == ',' || *p == ' ')) p++;
        p = parse_int(p, end, &i);
        users[row] = (int32_t)u;
        items[row] = (int32_t)i;
        row++;
        while (p < end && *p != '\n') p++;  // rest of line ignored
        if (p < end) p++;
    }
    return row;
}

// ------------------------------------------------------------------ CSR
// Build user-major CSR (indptr + column indices) from edge arrays — the
// device-view builder behind Dataset.from_edges.

void build_csr(const int32_t* rows, const int32_t* cols, int64_t nnz, int32_t n_rows,
               int64_t* indptr, int32_t* out_cols) {
    memset(indptr, 0, sizeof(int64_t) * (n_rows + 1));
    for (int64_t e = 0; e < nnz; e++) indptr[rows[e] + 1]++;
    for (int32_t r = 0; r < n_rows; r++) indptr[r + 1] += indptr[r];
    int64_t* cursor = (int64_t*)malloc(sizeof(int64_t) * n_rows);
    memcpy(cursor, indptr, sizeof(int64_t) * n_rows);
    for (int64_t e = 0; e < nnz; e++) {
        out_cols[cursor[rows[e]]++] = cols[e];
    }
    free(cursor);
}

}  // extern "C"
