// chain_loader.cpp — native option-chain CSV loader for mcos_tpu.
//
// Role: the market-data ingestion runtime. Calibration consumes option
// chains (strike, expiry, type, bid/ask, open interest); production chains
// for a full index complex run to millions of rows per day, and Python CSV
// parsing becomes the bottleneck long before the device does. This loader
// parses NSE-style chain CSVs at memory bandwidth and applies the liquidity
// screen (min open interest, max relative bid-ask spread — the reference's
// CalibrationConfig contract, engine/config.py:106-129) in the same pass.
//
// Interface: plain C ABI for ctypes (no pybind11 in this image).
//   chain_count_rows(path)                      → data row count (≤0: error)
//   chain_parse(path, n, *out...)               → rows written (≤0: error)
//
// CSV layout (header required, comma-separated):
//   expiry_years,strike,is_call,bid,ask,open_interest
// Unparseable rows are skipped, not fatal (market data is dirty).
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

const double kPow10[] = {
    1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12,
    1e13, 1e14, 1e15, 1e16, 1e17, 1e18};

// Fast forward-only decimal parse (hand-rolled: strtod is ~5× slower and
// locale-dependent). Handles [-+]ddd[.ddd][eE[-+]dd]; market-data precision
// (≤ 15 significant digits) is exact. Returns false on garbage.
bool parse_double(const char*& p, const char* end, double* out) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= end) return false;
    bool neg = false;
    if (*p == '-' || *p == '+') { neg = (*p == '-'); ++p; }
    uint64_t mant = 0;
    int digits = 0, frac_digits = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        if (digits < 18) { mant = mant * 10 + (*p - '0'); ++digits; }
        any = true; ++p;
    }
    if (p < end && *p == '.') {
        ++p;
        while (p < end && *p >= '0' && *p <= '9') {
            if (digits < 18) {
                mant = mant * 10 + (*p - '0'); ++digits; ++frac_digits;
            }
            any = true; ++p;
        }
    }
    if (!any) return false;
    int exp10 = -frac_digits;
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
        int e = 0;
        while (p < end && *p >= '0' && *p <= '9') { e = e * 10 + (*p - '0'); ++p; }
        exp10 += eneg ? -e : e;
    }
    double v = static_cast<double>(mant);
    if (exp10 > 0) v *= (exp10 < 19 ? kPow10[exp10] : __builtin_pow(10.0, exp10));
    else if (exp10 < 0) v /= (-exp10 < 19 ? kPow10[-exp10]
                                          : __builtin_pow(10.0, -exp10));
    *out = neg ? -v : v;
    return true;
}

bool parse_flag(const char*& p, const char* end, double* out) {
    // Accept 1/0, true/false, CE/PE, C/P (case-insensitive).
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= end) return false;
    char c = static_cast<char>(tolower(*p));
    if (c == '1' || c == 't' || c == 'c') { *out = 1.0; }
    else if (c == '0' || c == 'f' || c == 'p') { *out = 0.0; }
    else return false;
    while (p < end && *p != ',' && *p != '\n') ++p;
    return true;
}

struct FileBuf {
    char* data = nullptr;
    long size = 0;
    ~FileBuf() { free(data); }
    bool load(const char* path) {
        FILE* f = fopen(path, "rb");
        if (!f) return false;
        // Non-seekable inputs (pipes, device files) make ftell return -1;
        // bail out rather than malloc(0)+fread(SIZE_MAX).
        if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return false; }
        size = ftell(f);
        if (size < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return false; }
        data = static_cast<char*>(malloc(size + 1));
        if (!data) { fclose(f); return false; }
        long got = static_cast<long>(fread(data, 1, size, f));
        fclose(f);
        if (got != size) return false;
        data[size] = '\0';
        return true;
    }
};

// Parse one data line into 6 doubles; returns false to skip the row.
bool parse_row(const char* line, const char* end, double out[6]) {
    const char* p = line;
    for (int col = 0; col < 6; ++col) {
        bool ok = (col == 2) ? parse_flag(p, end, &out[col])
                             : parse_double(p, end, &out[col]);
        if (!ok) return false;
        while (p < end && *p != ',' && *p != '\n') ++p;
        if (col < 5) {
            if (p >= end || *p != ',') return false;
            ++p;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Number of parseable data rows (excludes header + bad rows). ≤0 on error.
long chain_count_rows(const char* path) {
    FileBuf buf;
    if (!buf.load(path)) return -1;
    const char* p = buf.data;
    const char* end = buf.data + buf.size;
    // Skip header line.
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    long rows = 0;
    double tmp[6];
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (line_end > p && parse_row(p, line_end, tmp)) ++rows;
        p = line_end + 1;
    }
    return rows;
}

// Parse up to `capacity` rows into the caller's arrays, applying the
// liquidity screen: open_interest ≥ min_oi AND (ask−bid)/mid ≤ max_spread
// (mid = (bid+ask)/2; rows with mid ≤ 0 are kept but flagged illiquid).
// Returns rows written, or ≤0 on error.
long chain_parse(const char* path, long capacity,
                 double* expiry, double* strike, double* is_call,
                 double* bid, double* ask, double* open_interest,
                 double* liquid_flag,
                 double min_oi, double max_spread_pct) {
    FileBuf buf;
    if (!buf.load(path)) return -1;
    const char* p = buf.data;
    const char* end = buf.data + buf.size;
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;

    long n = 0;
    double row[6];
    while (p < end && n < capacity) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (line_end > p && parse_row(p, line_end, row)) {
            expiry[n] = row[0];
            strike[n] = row[1];
            is_call[n] = row[2];
            bid[n] = row[3];
            ask[n] = row[4];
            open_interest[n] = row[5];
            double mid = 0.5 * (row[3] + row[4]);
            bool liq = row[5] >= min_oi && mid > 0.0 &&
                       (row[4] - row[3]) <= max_spread_pct * mid;
            liquid_flag[n] = liq ? 1.0 : 0.0;
            ++n;
        }
        p = line_end + 1;
    }
    return n;
}

}  // extern "C"
