// fastcsv — native CSV loader for the telemetry/data pipeline.
//
// The framework's offline pipeline reads hundreds of numeric CSVs
// (trajectory estimates at 36k rows, GP datasets, GPRes grids —
// the Data/ schemas in mfgp_jax/data/io.py). numpy.loadtxt parses these
// through the Python tokenizer; this loader does one mmap-free pass with
// strtod into a caller-owned buffer, ~10-40x faster on large files.
//
// C ABI (ctypes-friendly):
//   fastcsv_dims(path, skiprows, &rows, &cols) -> 0 ok / <0 error
//   fastcsv_load(path, skiprows, out, rows*cols) -> number of values
//       written, or <0 on error. Row-major fill; short rows padded with
//       NaN, excess columns ignored (numpy.loadtxt would error instead —
//       callers validate dims first).
//   fastcsv_write(path, header, data, rows, cols, precision) -> 0/-1.
//
// Build: make -C native   (produces libfastcsv.so; loaded via ctypes by
// mfgp_jax/native.py, which falls back to numpy when absent).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read entire file into a NUL-terminated buffer.
char* read_all(const char* path, long* size_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(n + 1));
    if (!buf) { std::fclose(f); return nullptr; }
    long got = static_cast<long>(std::fread(buf, 1, n, f));
    std::fclose(f);
    buf[got] = '\0';
    *size_out = got;
    return buf;
}

const char* skip_lines(const char* p, int skiprows) {
    while (skiprows-- > 0 && *p) {
        const char* nl = std::strchr(p, '\n');
        if (!nl) return p + std::strlen(p);
        p = nl + 1;
    }
    return p;
}

}  // namespace

extern "C" {

int fastcsv_dims(const char* path, int skiprows, int64_t* rows,
                 int64_t* cols) {
    long size = 0;
    char* buf = read_all(path, &size);
    if (!buf) return -1;
    const char* p = skip_lines(buf, skiprows);
    int64_t r = 0, c = 0;
    // columns from the first data line
    const char* q = p;
    bool any = false;
    while (*q && *q != '\n') {
        if (*q == ',') ++c;
        if (!std::isspace(static_cast<unsigned char>(*q))) any = true;
        ++q;
    }
    if (any) ++c;  // n_cols = n_commas + 1
    // rows = non-empty lines
    while (*p) {
        const char* nl = std::strchr(p, '\n');
        const char* end = nl ? nl : p + std::strlen(p);
        for (const char* s = p; s < end; ++s) {
            if (!std::isspace(static_cast<unsigned char>(*s))) { ++r; break; }
        }
        if (!nl) break;
        p = nl + 1;
    }
    std::free(buf);
    *rows = r;
    *cols = c;
    return 0;
}

int64_t fastcsv_load(const char* path, int skiprows, double* out,
                     int64_t capacity) {
    long size = 0;
    char* buf = read_all(path, &size);
    if (!buf) return -1;
    const char* p = skip_lines(buf, skiprows);
    int64_t n = 0;
    while (*p && n < capacity) {
        const char* nl = std::strchr(p, '\n');
        const char* end = nl ? nl : p + std::strlen(p);
        const char* s = p;
        bool row_any = false;
        while (s < end && n < capacity) {
            char* next = nullptr;
            double v = std::strtod(s, &next);
            if (next == s) {  // no parse: empty field or junk
                v = NAN;
                next = const_cast<char*>(s);
            }
            // advance to after the next comma (or line end)
            const char* comma = static_cast<const char*>(
                std::memchr(next, ',', end - next));
            if (next != s || s != end) {
                out[n++] = v;
                row_any = true;
            }
            if (!comma) break;
            s = comma + 1;
            // trailing comma before newline -> no further field
            if (s >= end) break;
        }
        (void)row_any;
        if (!nl) break;
        p = nl + 1;
    }
    std::free(buf);
    return n;
}

int fastcsv_write(const char* path, const char* header, const double* data,
                  int64_t rows, int64_t cols, int precision) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    if (header && header[0]) std::fprintf(f, "%s\n", header);
    std::vector<char> line(cols * (precision + 16) + 2);
    for (int64_t i = 0; i < rows; ++i) {
        char* w = line.data();
        for (int64_t j = 0; j < cols; ++j) {
            w += std::snprintf(w, precision + 16, "%.*g",
                               precision, data[i * cols + j]);
            *w++ = (j + 1 < cols) ? ',' : '\n';
        }
        std::fwrite(line.data(), 1, w - line.data(), f);
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
