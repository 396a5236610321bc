// Native host-side runtime: fast sequence scanning/encoding, k-mer
// counting, and a formatted random-access sequence database.
//
// This is the framework's equivalent of the reference suite's native
// I/O / DB layer (reference: src/dbs.{h,cc} formatted DB, src/makdbs.cc
// builder, src/bitpat.cc word streams) — the compute path is JAX,
// but bulk host work (parsing gigabyte FASTA, word counting for the
// sl-forest filter, DB spill files) stays in C++.
//
// Plain C ABI for ctypes binding (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// FASTA scanning: find record boundaries in a memory buffer.
// Returns the number of records; fills starts/ends (of sequence payload)
// and name offsets, up to max_records.
int fasta_scan(const char* buf, int64_t len,
               int64_t* rec_start, int64_t* seq_start, int64_t* seq_end,
               int max_records)
{
    int n = 0;
    int64_t i = 0;
    while (i < len && n < max_records) {
        if (buf[i] == '>') {
            rec_start[n] = i;
            while (i < len && buf[i] != '\n') ++i;
            if (i < len) ++i;
            seq_start[n] = i;
            while (i < len && buf[i] != '>') {
                // skip comment lines (';' prefixed)
                ++i;
            }
            seq_end[n] = i;
            ++n;
        } else {
            ++i;
        }
    }
    return n;
}

// ---------------------------------------------------------------------
// Residue encoding with a 256-entry table; skips whitespace/digits.
// Returns encoded length.
int64_t encode_seq(const char* buf, int64_t len, const int8_t* table,
                   int8_t* out)
{
    int64_t k = 0;
    for (int64_t i = 0; i < len; ++i) {
        unsigned char c = (unsigned char) buf[i];
        if (c == ';') {                 // comment line
            while (i < len && buf[i] != '\n') ++i;
            continue;
        }
        if (c <= ' ' || (c >= '0' && c <= '9')) continue;
        out[k++] = table[c];
    }
    return k;
}

// ---------------------------------------------------------------------
// Spaced-seed k-mer counting over reduced classes.
//   red:   length L array of reduced classes (-1 = breaks the window)
//   seed:  0/1 mask of length width, 'ones' of them set
//   nalpha: class count; counts: preallocated nalpha^ones array
// Returns total counted words.
int64_t kmer_count(const int8_t* red, int64_t L,
                   const int8_t* seed, int width, int nalpha,
                   int32_t* counts, int64_t table_size)
{
    int64_t total = 0;
    for (int64_t s = 0; s + width <= L; ++s) {
        int64_t w = 0;
        bool ok = true;
        for (int j = 0; j < width; ++j) {
            if (!seed[j]) continue;
            int c = red[s + j];
            if (c < 0) { ok = false; break; }
            w = w * nalpha + c;
        }
        if (!ok) continue;
        if (w >= 0 && w < table_size) {
            ++counts[w];
            ++total;
        }
    }
    return total;
}

// Sparse intersection similarity of two count arrays:
//   sum over w of min(ca[w]*mb, cb[w]*ma)
int64_t kmer_min_overlap(const int32_t* ca, const int32_t* cb,
                         int64_t table_size, int ma, int mb)
{
    int64_t s = 0;
    for (int64_t w = 0; w < table_size; ++w) {
        if (ca[w] && cb[w]) {
            int64_t x = (int64_t) ca[w] * mb;
            int64_t y = (int64_t) cb[w] * ma;
            s += x < y ? x : y;
        }
    }
    return s;
}

// ---------------------------------------------------------------------
// Formatted sequence DB (reference makdbs/DbsDt equivalent):
//   <name>.psq : concatenated int8 codes
//   <name>.pix : int64 offsets (n+1 entries)
//   <name>.pnm : '\n'-separated names
// Build from preprocessed arrays; reading is trivial (numpy memmap on
// the Python side), so only the writer lives here.
int seqdb_write(const char* path_base,
                const int8_t* codes, const int64_t* offsets, int nrec,
                const char* names, int64_t names_len)
{
    char path[4096];
    snprintf(path, sizeof(path), "%s.psq", path_base);
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    fwrite(codes, 1, (size_t) offsets[nrec], f);
    fclose(f);
    snprintf(path, sizeof(path), "%s.pix", path_base);
    f = fopen(path, "wb");
    if (!f) return -2;
    fwrite(offsets, sizeof(int64_t), (size_t) nrec + 1, f);
    fclose(f);
    snprintf(path, sizeof(path), "%s.pnm", path_base);
    f = fopen(path, "wb");
    if (!f) return -3;
    fwrite(names, 1, (size_t) names_len, f);
    fclose(f);
    return 0;
}

}  // extern "C"
